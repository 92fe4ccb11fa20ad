"""Rank side of ``test_torch_dist_lanes.py``: the adaptive runtime's cache
lane, tier lane and ``migrate_aux`` driven on a 1 x 4 grid of gloo ranks.
Only torch, numpy and the port are imported here, so a spawned rank
starts without JAX. ``drive(inp, dist)`` is the one sequence of calls:
the test also runs it with ``dist=None`` on the whole table, so the
single-device runtime and the ranks see the same batches in the same
order. Every output name is ``<case>.<array>``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import embedding as TE
from repro_torch.core.embedding import BankedTable
from repro_torch.core.partitioning import PartitionPlan
from repro_torch.quant import QuantSpec
from repro_torch.workload.replanner import ReplanConfig
from repro_torch.workload.runtime import (AdaptiveEmbeddingRuntime,
                                          cache_lane_runtime)

N_BANKS = 4
CACHE_ENTRIES = 32


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _plan(bank, slot, n_banks: int = N_BANKS) -> PartitionPlan:
    bank = np.asarray(bank, np.int32)
    return PartitionPlan(
        n_banks=n_banks, bank_of_row=bank,
        slot_of_row=np.asarray(slot, np.int32),
        rows_per_bank=np.bincount(bank, minlength=n_banks).astype(np.int32),
        load_per_bank=np.zeros(n_banks))


def _piece(x: torch.Tensor, dist, cap: int) -> torch.Tensor:
    """This rank's bank rows of a global packed-row-aligned tensor."""
    if dist is None:
        return x.clone()
    m = dist.bank_rank
    return x[m * cap:(m + 1) * cap].clone()


def _table(inp, key: str, dist) -> BankedTable:
    cap = int(inp["cap"])
    return BankedTable(packed=_piece(_t(inp[key]), dist, cap),
                       remap_bank=_t(inp["a_bank"]),
                       remap_slot=_t(inp["a_slot"]), n_banks=N_BANKS,
                       rows_per_bank=cap)


def _bags(batch: np.ndarray) -> list[np.ndarray]:
    return [b[b >= 0] for b in batch.reshape(-1, batch.shape[-1])]


def _observe(rt, batch: np.ndarray) -> None:
    rt.observe_batch(batch.reshape(-1))
    rt.observe_bags(_bags(batch))


def _tiered(tt, prefix: str) -> dict:
    return {f"{prefix}.{f}": getattr(tt, f)
            for f in ("payload", "scale", "tier")}


def _cache_lane(inp, dist) -> dict:
    """One cache-aware swap, the batch in flight across it served against
    the table it was rewritten for, a refresh after the rows moved, a
    rebuild, and ``migrate_aux`` of the Adagrad accumulator."""
    cap = int(inp["cap"])
    t = _table(inp, "a_packed", dist)
    plan = _plan(inp["a_bank"], inp["a_slot"])
    rt = cache_lane_runtime(t, plan, multi_hot=int(inp["L"]),
                            replan_every=2, cache_entries=CACHE_ENTRIES,
                            dist=dist)
    out = {"cache.v0": rt.cache_table.packed}
    batches = inp["batches"]
    for b in batches[:-1]:
        _observe(rt, b)
        rt.rewrite(b.reshape(-1, b.shape[-1]))
    flight = rt.rewrite(batches[-1].reshape(-1, batches.shape[-1]))
    update = rt.replanner.force_replan()
    out["cache.aux"] = rt.migrate_aux(_piece(_t(inp["acc"]), dist, cap),
                                      update)
    event = rt.apply(update)
    out["cache.emt"] = rt.table.packed
    out["cache.table"] = rt.cache_table.packed
    out["cache.c_bank"] = rt.cache_table.remap_bank
    out["cache.c_slot"] = rt.cache_table.remap_slot
    out["cache.event"] = torch.tensor([event.cache_version,
                                       event.cache_entries,
                                       event.cache_dropped])
    after = rt.rewrite(batches[-1].reshape(-1, batches.shape[-1]))
    for name, rb in (("flight", flight), ("after", after)):
        out[f"cache.{name}"] = TE.banked_cache_residual_bag(
            rt.table, rt.cache_table_for(rb.version), _t(rb.cache_idx),
            _t(rb.residual_idx), dist)
        out[f"cache.{name}_ci"] = _t(rb.cache_idx)
        out[f"cache.{name}_ri"] = _t(rb.residual_idx)
    # the rows drift (a train step's update) and the refresh re-sums them
    rt.table = dataclasses.replace(
        rt.table, packed=rt.table.packed
        + _piece(_t(inp["delta"]), dist, cap))
    out["cache.refresh_version"] = torch.tensor([rt.refresh_cache()])
    out["cache.refreshed"] = rt.cache_table.packed
    rebuilt = rt.rebuild_cache_table(update)
    out["cache.rebuilt"] = rebuilt.packed
    out["cache.rebuilt_bank"] = rebuilt.remap_bank
    out["cache.rebuilt_slot"] = rebuilt.remap_slot
    return out


def _tier_lane(inp, dist) -> dict:
    """Version 0 of the int4 tier lane, one swap, and the batch in flight
    across it served against the version it was drawn for."""
    cap, dim = int(inp["cap"]), int(inp["dim"])
    t = _table(inp, "a_packed", dist)
    plan = _plan(inp["a_bank"], inp["a_slot"])
    vocab = plan.vocab
    cfg = ReplanConfig.for_vocab(
        vocab, N_BANKS, capacity_rows=cap, check_every=2,
        min_observations=200,
        quant=QuantSpec(byte_budget=0.75 * dim, min_hot_rows=4),
        quant_dim=dim)
    rt = AdaptiveEmbeddingRuntime(t, plan, cfg, dist=dist,
                                  init_freq=np.ones(vocab))
    out = _tiered(rt.tiered, "tier.v0")
    for b in inp["batches"][:-1]:
        _observe(rt, b)
    idx = _t(inp["batches"][-1].reshape(-1, inp["batches"].shape[-1]))
    fp_before, v0 = rt.table.packed, rt.tier_version
    event = rt.apply(rt.replanner.force_replan())
    out.update(_tiered(rt.tiered, "tier.v1"))
    out["tier.emt"] = rt.table.packed
    out["tier.stats"] = torch.tensor([event.tier_version,
                                      event.tier_promoted,
                                      event.tier_demoted,
                                      event.tier_requantized])
    out["tier.flight"] = TE.tiered_embedding_bag(
        fp_before, rt.tiered_for(v0), idx, dist)
    out["tier.after"] = TE.tiered_embedding_bag(rt.table.packed, rt.tiered,
                                                idx, dist)
    return out


def drive(inp, dist) -> dict:
    """Every case's outputs: the whole tables with ``dist=None``, this
    rank's shards under a ``DistCtx``."""
    out = _cache_lane(inp, dist)
    out.update(_tier_lane(inp, dist))
    return out


def _refusals(inp, dist) -> dict:
    """A rank that observed another batch: the swap raises on every rank
    before any row moves. The replica lane refuses ``dist``."""
    cap = int(inp["cap"])
    t = _table(inp, "a_packed", dist)
    plan = _plan(inp["a_bank"], inp["a_slot"])
    rt = AdaptiveEmbeddingRuntime(
        t, plan, ReplanConfig.for_vocab(plan.vocab, N_BANKS,
                                        capacity_rows=cap), dist=dist,
        init_freq=np.ones(plan.vocab))
    for b in inp["batches"]:
        # rank 0 sees every id shifted by 7 rows: another frequency vector
        seen = np.where(b >= 0, (b + 7) % plan.vocab, b) \
            if dist.rank == 0 else b
        rt.observe_batch(seen.reshape(-1))
    try:
        rt.apply(rt.replanner.force_replan())
        mismatch = False
    except RuntimeError as e:
        mismatch = "different plans" in str(e)
    try:
        AdaptiveEmbeddingRuntime(
            t, plan, ReplanConfig(n_banks=N_BANKS, capacity_rows=cap,
                                  replicate_k_max=4), dist=dist)
        replica = False
    except ValueError as e:
        replica = "replica lane" in str(e)
    return {"refused.mismatch": torch.tensor([mismatch]),
            "refused.replica": torch.tensor([replica]),
            "refused.table_kept": torch.tensor(
                [bool(torch.equal(rt.table.packed, t.packed))])}


def lanes(rank: int, world: int, inp) -> dict:
    dist = TE.DistCtx.create(1, world, device="cpu")
    out = drive(inp, dist)
    out.update(_refusals(inp, dist))
    return out
