"""The adaptive runtime's cache lane, tier lane and ``migrate_aux`` under
the bank axis, on the CPU: four gloo ranks of the port as a 1 x 4 grid
(``tests/torch_dist_lanes_ranks.py``) against the port's single-device
runtime, and that runtime against the JAX reference's.

One world is spawned once per file (a module-scoped fixture) at the
reduced ``updlrm-paper`` size (8 fields x 500 rows, D = 8, bags of 16),
with a 4-bank plan at the launchers' capacity. Every rank observes the
same (global) batches, as the runtime requires under ``dist``, and the
single-device runtime runs the very same calls (``R.drive`` with
``dist=None``). Held bit for bit (``assert_array_equal``):

  * each rank's migrated EMT, cache table (after the swap, after a
    refresh of drifted rows, and ``rebuild_cache_table``), TieredTable
    (version 0 and after the swap) and ``migrate_aux`` of the Adagrad
    accumulator equal its bank's slice of the single-device runtime's;
  * the single-device runtime's equal the reference's runtime's on the
    same calls, with the same swap events and tier stats.

The batch in flight across each swap, served through the sharded fused
cache and tiered lookups against the version it was rewritten (or drawn)
for, is within ``atol=1e-5`` of the single-device lookup (the bank sum
reorders fp32 adds). A rank that observed another batch makes the swap
raise on every rank, and the replica lane refuses ``dist``.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.quant import QuantSpec as JQuantSpec
from repro.workload import migrate as JMIG
from repro.workload import replanner as JRP
from repro.workload import runtime as JRT
from repro_torch.dist.launch import run_ranks

import torch_dist_lanes_ranks as R

NB, F, ROWS, D, L = R.N_BANKS, 8, 500, 8, 16
SUM_TOL = dict(rtol=0, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def _inputs():
    rng = np.random.default_rng(27)
    V = F * ROWS
    cap = int(np.ceil(V / NB) * 1.25)
    plan = JP.non_uniform_partition(np.ones(V), NB, capacity_rows=cap)
    table = (rng.standard_normal((V, D)) * 0.01).astype(np.float32)
    jt = JMIG.migrate_table(JE.pack_table(table, plan), plan,
                            rows_per_bank=cap)
    # drifting Zipf bags: the hot head moves between batches, ids -1 padded
    ranks = np.arange(1, V + 1, dtype=np.float64)
    p = ranks ** -1.2
    p /= p.sum()
    batches = []
    for k in range(6):
        ids = (rng.choice(V, size=(32, L), p=p) + 300 * (k // 3)) % V
        ids[rng.random(ids.shape) < 0.1] = -1
        batches.append(ids.astype(np.int32))
    return dict(
        cap=np.asarray(cap), dim=np.asarray(D), L=np.asarray(L),
        a_bank=plan.bank_of_row.astype(np.int32),
        a_slot=plan.slot_of_row.astype(np.int32),
        a_packed=np.asarray(jt.packed), batches=np.stack(batches),
        acc=rng.random(NB * cap).astype(np.float32),
        delta=(rng.standard_normal((NB * cap, D)) * 1e-3)
        .astype(np.float32)), plan, jt


def _reference(inp, plan, jt) -> dict:
    """The reference's runtime through the same calls as ``R.drive``."""
    V, cap = plan.vocab, int(inp["cap"])
    out = {}
    batches = inp["batches"]
    jr = JRT.AdaptiveEmbeddingRuntime(
        jt, plan, JRP.ReplanConfig.for_vocab(
            V, NB, capacity_rows=cap, check_every=2,
            partitioner="cache_aware",
            cache_rows_per_bank=-(-R.CACHE_ENTRIES // NB),
            mine_min_support=2, hysteresis=0.0, telemetry_decay=0.8,
            telemetry_decay_every=4096),
        init_freq=np.ones(V), max_cache_per_bag=max(2, L // 4),
        max_residual_per_bag=L)
    out["cache.v0"] = jr.cache_table.packed
    for b in batches[:-1]:
        jr.observe_batch(b.reshape(-1))
        jr.observe_bags(R._bags(b))
        jr.rewrite(b.reshape(-1, L))
    update = jr.replanner.force_replan()
    out["cache.aux"] = jr.migrate_aux(jnp.asarray(inp["acc"]), update)
    event = jr.apply(update)
    out["cache.emt"] = jr.table.packed
    out["cache.table"] = jr.cache_table.packed
    out["cache.c_bank"] = jr.cache_table.remap_bank
    out["cache.c_slot"] = jr.cache_table.remap_slot
    out["cache.event"] = [event.cache_version, event.cache_entries,
                          event.cache_dropped]
    jr.table = dataclasses.replace(
        jr.table, packed=jr.table.packed + jnp.asarray(inp["delta"]))
    out["cache.refresh_version"] = [jr.refresh_cache()]
    out["cache.refreshed"] = jr.cache_table.packed
    rebuilt = jr.rebuild_cache_table(update)
    out["cache.rebuilt"] = rebuilt.packed
    out["cache.rebuilt_bank"] = rebuilt.remap_bank
    out["cache.rebuilt_slot"] = rebuilt.remap_slot

    jq = JRT.AdaptiveEmbeddingRuntime(
        jt, plan, JRP.ReplanConfig.for_vocab(
            V, NB, capacity_rows=cap, check_every=2, min_observations=200,
            quant=JQuantSpec(byte_budget=0.75 * D, min_hot_rows=4),
            quant_dim=D), init_freq=np.ones(V))
    for f in ("payload", "scale", "tier"):
        out[f"tier.v0.{f}"] = getattr(jq.tiered, f)
    for b in batches[:-1]:
        jq.observe_batch(b.reshape(-1))
        jq.observe_bags(R._bags(b))
    event = jq.apply(jq.replanner.force_replan())
    for f in ("payload", "scale", "tier"):
        out[f"tier.v1.{f}"] = getattr(jq.tiered, f)
    out["tier.emt"] = jq.table.packed
    out["tier.stats"] = [event.tier_version, event.tier_promoted,
                         event.tier_demoted, event.tier_requantized]
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def lanes(tmp_path_factory):
    inp, plan, jt = _inputs()
    ref = _reference(inp, plan, jt)
    single = {k: _np(v) for k, v in R.drive(inp, None).items()}
    outs = run_ranks(R.lanes, NB, tmp_path_factory.mktemp("lanes"),
                     inputs=inp, backend="gloo", timeout=300)
    return inp, ref, single, outs


# keys held shard against single-device slice: (key, rows a bank holds)
SHARDED = {
    "cache_swap": ("cache.emt", "cache.table", "cache.v0"),
    "cache_refresh": ("cache.refreshed",),
    "cache_rebuild": ("cache.rebuilt",),
    "migrate_aux": ("cache.aux",),
    "tier_v0": ("tier.v0.payload", "tier.v0.scale", "tier.v0.tier"),
    "tier_swap": ("tier.emt", "tier.v1.payload", "tier.v1.scale",
                  "tier.v1.tier"),
}
# keys every rank and the single device hold whole
WHOLE = {
    "cache_swap": ("cache.c_bank", "cache.c_slot", "cache.event"),
    "cache_refresh": ("cache.refresh_version",),
    "cache_rebuild": ("cache.rebuilt_bank", "cache.rebuilt_slot"),
    "migrate_aux": (),
    "tier_v0": (),
    "tier_swap": ("tier.stats",),
}


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_shards_equal_single_device(lanes, case):
    _, _, single, outs = lanes
    for key in SHARDED[case]:
        whole = single[key]
        k = whole.shape[0] // NB
        for m, o in enumerate(outs):
            np.testing.assert_array_equal(o[key], whole[m * k:(m + 1) * k],
                                          err_msg=f"{key}, rank {m}")
    for key in WHOLE[case]:
        for m, o in enumerate(outs):
            np.testing.assert_array_equal(o[key], single[key],
                                          err_msg=f"{key}, rank {m}")


@pytest.mark.parametrize("case", sorted(SHARDED))
def test_single_device_equals_reference(lanes, case):
    _, ref, single, _ = lanes
    for key in SHARDED[case] + WHOLE[case]:
        np.testing.assert_array_equal(single[key], ref[key], err_msg=key)


def test_swaps_moved_rows_and_found_entries(lanes):
    """The swaps under test do real work: rows change bank, the mined
    cache holds entries, the re-tier changes tiers, the refresh moves the
    sums."""
    inp, _, single, _ = lanes
    assert not np.array_equal(single["cache.emt"], inp["a_packed"])
    assert single["cache.event"][1] > 0
    assert not np.array_equal(single["cache.refreshed"],
                              single["cache.table"])
    assert single["tier.stats"][3] > 0


@pytest.mark.parametrize("lane,names", [
    ("cache", ("flight", "after")), ("tier", ("flight", "after"))])
def test_inflight_batch_served_sharded(lanes, lane, names):
    """The batch in flight across the swap and the next one, through the
    sharded fused lookup, against the single-device lookup; the cache
    lane's rewrites are the same ids on every rank."""
    _, _, single, outs = lanes
    for name in names:
        key = f"{lane}.{name}"
        for m, o in enumerate(outs):
            np.testing.assert_allclose(o[key], single[key], **SUM_TOL,
                                       err_msg=f"{key}, rank {m}")
            if lane == "cache":
                for ids in ("ci", "ri"):
                    np.testing.assert_array_equal(o[f"{key}_{ids}"],
                                                  single[f"{key}_{ids}"])
    if lane == "cache":
        assert (single["cache.flight_ci"] >= 0).sum() == 0   # version 0
        assert (single["cache.after_ci"] >= 0).sum() > 0


@pytest.mark.parametrize("what", ["mismatch", "replica"])
def test_refusals(lanes, what):
    _, _, _, outs = lanes
    for m, o in enumerate(outs):
        assert bool(o[f"refused.{what}"][0]), f"rank {m}"
        assert bool(o["refused.table_kept"][0]), f"rank {m}"
