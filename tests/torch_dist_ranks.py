"""Rank side of ``test_torch_dist.py``: what each gloo rank of a CPU
grid runs, on inputs the test wrote (``run_ranks`` hands them over as
``.npy`` files). Only torch, numpy and the port are imported here, so a
spawned rank starts without JAX; the test holds the outputs against the
reference in its own process. Every output name is ``<check>.<array>``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import embedding as TE
from repro_torch.core.partitioning import PartitionPlan

CPU = "cpu"


def _t(x) -> torch.Tensor:
    """An input array as a CPU tensor (bf16 travels as its int16 bits)."""
    a = np.ascontiguousarray(x)
    return torch.from_numpy(a.copy())


def _bf16(x) -> torch.Tensor:
    return _t(x).view(torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy()


def _plan(bank, slot, n_banks: int) -> PartitionPlan:
    bank = np.asarray(bank, np.int32)
    return PartitionPlan(
        n_banks=n_banks, bank_of_row=bank,
        slot_of_row=np.asarray(slot, np.int32),
        rows_per_bank=np.bincount(bank, minlength=n_banks).astype(np.int32),
        load_per_bank=np.zeros(n_banks))


def _local(packed: torch.Tensor, bank, slot, n_banks: int, rpb: int,
           dist) -> TE.BankedTable:
    """This rank's shard of a global packed table."""
    m = dist.bank_rank
    return TE.BankedTable(packed=packed[m * rpb:(m + 1) * rpb].clone(),
                          remap_bank=_t(bank), remap_slot=_t(slot),
                          n_banks=n_banks, rows_per_bank=rpb)


def _params(inp, prefix: str) -> dict:
    """DLRM params written as ``<prefix>packed`` and the MLP lists."""
    mlp = {part: {k: [_t(inp[f"{prefix}{part}.{k}{i}"])
                      for i in range(int(inp[f"{prefix}n_{part}"]))]
                  for k in ("w", "b")} for part in ("bot", "top")}
    return {"emb_packed": _t(inp[f"{prefix}packed"]), **mlp}


def _grad(fn, x: torch.Tensor):
    x = x.detach().requires_grad_(True)
    out = fn(x)
    (g,) = torch.autograd.grad((out.float() ** 2).sum(), [x])
    return out.detach(), g


# ---------------------------------------------------------------------------
# the 4 x 2 grid
# ---------------------------------------------------------------------------

def _bag(inp, dist) -> dict:
    """The multi-field bag lookup: output, one bank's partial, traffic, the
    shard's gradient of sum(out ** 2) and the cotangent it scattered."""
    nb, rpb = 2, int(inp["rpb"])
    t = _local(_t(inp["packed"]), inp["bank"], inp["slot"], nb, rpb, dist)
    d = dist.for_batch(inp["sparse"].shape[0])
    idx = _t(inp["sparse"])[d.dp_slice()]
    off = _t(inp["off"])
    out, g = _grad(lambda p: TE.banked_embedding_bag(
        TE.BankedTable(p, t.remap_bank, t.remap_slot, nb, rpb), idx, d,
        field_offsets=off), t.packed)
    part = TE._bag_partial_scan(t.packed, idx, remap=t.remap_slot,
                                bank=t.remap_bank, my_bank=dist.bank_rank,
                                off=off)
    _, traffic = TE.banked_embedding_bag(t, idx, d, field_offsets=off,
                                         with_traffic=True)
    dr = dist.for_batch(inp["rows"].shape[0])
    rows = _t(inp["rows"])[dr.dp_slice()]
    return {"out": out, "part": part, "grad": g, "ct": 2 * out,
            "reads": traffic.reads, "nbytes": traffic.nbytes,
            "gather": TE.banked_gather(t, rows, dr),
            "gather_part": TE._local_gather_partial(
                t.packed, t.remap_bank, t.remap_slot, rows, dist.bank_rank)}


def _refused(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _uneven(inp, dist) -> dict:
    """A batch of 6 on 4 dp ranks: held whole on every rank, under the
    context ``recsys_batch_shardings`` returns; the grid's own context
    (no batch) and one for a batch of 8 refuse it."""
    from repro_torch.dist.sharding import recsys_batch_shardings
    nb, rpb = 2, int(inp["rpb"])
    t = _local(_t(inp["packed"]), inp["bank"], inp["slot"], nb, rpb, dist)
    off = _t(inp["off"])
    batch, d6 = recsys_batch_shardings(dist, {"sparse": _t(inp["sparse"][:6])})
    out, traffic = TE.banked_embedding_bag(t, batch["sparse"], d6,
                                           field_offsets=off,
                                           with_traffic=True)
    refused = [_refused(lambda d=d: TE.banked_embedding_bag(
        t, batch["sparse"], d, field_offsets=off, with_traffic=True))
        for d in (dist, dist.for_batch(8))]
    return {"out": out, "reads": traffic.reads,
            "replicated": torch.tensor([d6.dp_replicated]),
            "refused": torch.tensor(refused)}


def _csr(inp, dist) -> dict:
    nb, rpb = 2, int(inp["rpb"])
    packed = _t(inp["packed"])
    t = _local(packed, inp["bank"], inp["slot"], nb, rpb, dist)
    whole = TE.BankedTable(packed, _t(inp["bank"]), _t(inp["slot"]), nb, rpb)
    indices, offsets = inp["csr_idx"], inp["csr_off"]     # offsets + total
    n = offsets.shape[0] - 1
    starts = _t(offsets[:n].astype(np.int32))
    out, g = _grad(lambda p: TE.csr_embedding_bag(
        TE.BankedTable(p, t.remap_bank, t.remap_slot, nb, rpb),
        _t(indices), starts, n, dist), t.packed)
    sharded, gs = _grad(lambda p: TE.csr_embedding_bag_sharded(
        TE.BankedTable(p, t.remap_bank, t.remap_slot, nb, rpb), indices,
        offsets, n, dist), t.packed)
    return {"out": out, "grad": g, "sharded": sharded, "sharded_grad": gs,
            "fallback_total": TE.csr_embedding_bag_sharded(
                whole, indices, offsets, n, None),
            "fallback_starts": TE.csr_embedding_bag_sharded(
                whole, indices, offsets[:n], n, None)}


def _migrate(inp, dist) -> dict:
    from repro_torch.workload.migrate import migrate_table
    from repro_torch.workload.replanner import PlanUpdate, ReplanConfig
    from repro_torch.workload.runtime import AdaptiveEmbeddingRuntime
    from repro_torch.workload.telemetry import DriftReport
    nb, cap = 2, int(inp["cap"])
    plan_a = _plan(inp["a_bank"], inp["a_slot"], nb)
    plan_b = _plan(inp["b_bank"], inp["b_slot"], nb)
    out = {}
    for name, packed in (("f32", _t(inp["a_packed"])),
                         ("bf16", _bf16(inp["a_packed_bf16"]))):
        t = _local(packed, inp["a_bank"], inp["a_slot"], nb, cap, dist)
        for ex in ("compact", "full"):
            out[f"{name}_{ex}"] = migrate_table(
                t, plan_b, dist, rows_per_bank=cap, exchange=ex).packed
        out[f"{name}_nomove"] = migrate_table(t, plan_a, dist,
                                              rows_per_bank=cap).packed
    t = _local(_t(inp["a_packed"]), inp["a_bank"], inp["a_slot"], nb, cap,
               dist)
    rt = AdaptiveEmbeddingRuntime(t, plan_a, ReplanConfig(
        n_banks=nb, capacity_rows=cap), dist=dist)
    rt.apply(PlanUpdate(plan=plan_b, freq=np.ones(plan_b.vocab),
                        report=DriftReport(0.0, 0.0, True, 0)))
    out["runtime"] = rt.table.packed
    # rank 0 alone migrates to plan_a (no row moves for it): every rank
    # raises before any exchange
    try:
        migrate_table(t, plan_a if dist.rank == 0 else plan_b, dist,
                      rows_per_bank=cap)
        out["mismatch_raised"] = torch.tensor([False])
    except RuntimeError as e:
        out["mismatch_raised"] = torch.tensor(["different plans" in str(e)])
    return out


def _runtime_dp(inp, dist) -> dict:
    """The runtime's replan and swap on the 4 x 2 grid (dp 4): each rank
    observes the global batches' rows, replans and migrates; then each
    observes only its dp slice, and the swap raises on every rank."""
    from repro_torch.workload.replanner import ReplanConfig
    from repro_torch.workload.runtime import AdaptiveEmbeddingRuntime
    nb, cap = 2, int(inp["cap"])
    plan_a = _plan(inp["a_bank"], inp["a_slot"], nb)
    out = {}
    for how in ("global", "local"):
        t = _local(_t(inp["a_packed"]), inp["a_bank"], inp["a_slot"], nb,
                   cap, dist)
        rt = AdaptiveEmbeddingRuntime(t, plan_a, ReplanConfig(
            n_banks=nb, capacity_rows=cap), dist=dist)
        for rows in inp["rt_rows"]:
            d = dist.for_batch(rows.shape[0])
            rt.observe_batch(rows if how == "global" else rows[d.dp_slice()])
        try:
            rt.apply(rt.replanner.force_replan())
            out[f"{how}_raised"] = torch.tensor([False])
        except RuntimeError as e:
            out[f"{how}_raised"] = torch.tensor(["different plans" in str(e)])
        out[f"{how}_packed"] = rt.table.packed
        out[f"{how}_bank"] = rt.table.remap_bank
    return out


def _cache_swap(inp, dist) -> dict:
    """The live cache-path swap on the grid: the EMT migrated shard by
    shard, the cache table re-summed from the migrated rows (gathered over
    the bank group) and cut by bank, served through the sharded fused
    lookup; and the same lookup over the shards of a fresh build."""
    from repro_torch.core.cache_runtime import (build_cache_table_fixed,
                                                cap_cache_plan, entry_banks)
    from repro_torch.core.grace import mine_cooccurrence
    from repro_torch.workload.migrate import migrate_table
    from repro_torch.workload.runtime import unpacked_rows
    nb, cap, crpb = 2, int(inp["cap"]), int(inp["crpb"])
    plan_b = _plan(inp["b_bank"], inp["b_slot"], nb)
    t = _local(_t(inp["a_packed"]), inp["a_bank"], inp["a_slot"], nb, cap,
               dist)
    t_mig = migrate_table(t, plan_b, dist, rows_per_bank=cap)
    whole = TE.BankedTable(dist.gather(t_mig.packed, "bank"),
                           t_mig.remap_bank, t_mig.remap_slot, nb, cap)
    vals, offs = inp["bags"], inp["bag_off"]
    bags = [vals[offs[i]:offs[i + 1]] for i in range(offs.shape[0] - 1)]
    cp = mine_cooccurrence(bags, top_items=48, max_groups=16, min_support=2)
    fcp = cap_cache_plan(cp, entry_banks(cp, plan_b.bank_of_row, None), nb,
                         crpb)
    ct = build_cache_table_fixed(unpacked_rows(whole), fcp,
                                 dtype=torch.float32, device=CPU)
    m = dist.bank_rank
    c_loc = TE.BankedTable(ct.packed[m * crpb:(m + 1) * crpb].clone(),
                           ct.remap_bank, ct.remap_slot, nb, crpb)
    d = dist.for_batch(inp["ci"].shape[0])
    ci, ri = _t(inp["ci"])[d.dp_slice()], _t(inp["ri"])[d.dp_slice()]
    fresh = _local(_t(inp["fresh_packed"]), inp["b_bank"], inp["b_slot"], nb,
                   cap, dist)
    c_fresh = _local(_t(inp["fresh_cache"]), inp["c_bank"], inp["c_slot"],
                     nb, crpb, dist)
    return {"emt": t_mig.packed, "cache": c_loc.packed,
            "c_bank": ct.remap_bank, "c_slot": ct.remap_slot,
            "out": TE.banked_cache_residual_bag(t_mig, c_loc, ci, ri, d),
            "out_fresh": TE.banked_cache_residual_bag(fresh, c_fresh, ci, ri,
                                                      d)}


def _cache_bwd(inp, dist) -> dict:
    """Both tables' gradients through the sharded fused lookup."""
    nb, rpb, crpb = 2, int(inp["rpb"]), int(inp["cb_rpb"])
    t = _local(_t(inp["packed"]), inp["bank"], inp["slot"], nb, rpb, dist)
    c = _local(_t(inp["cb_packed"]), inp["cb_bank"], inp["cb_slot"], nb,
               crpb, dist)
    d = dist.for_batch(inp["cb_ci"].shape[0])
    ci, ri = _t(inp["cb_ci"])[d.dp_slice()], _t(inp["cb_ri"])[d.dp_slice()]
    e = t.packed.clone().requires_grad_(True)
    k = c.packed.clone().requires_grad_(True)
    out = TE.banked_cache_residual_bag(
        TE.BankedTable(e, t.remap_bank, t.remap_slot, nb, rpb),
        TE.BankedTable(k, c.remap_bank, c.remap_slot, nb, crpb), ci, ri, d)
    ge, gc = torch.autograd.grad((out ** 2).sum(), [e, k])
    _, traffic = TE.banked_cache_residual_bag(t, c, ci, ri, d,
                                              with_traffic=True)
    return {"out": out, "grad_emt": ge, "grad_cache": gc,
            "reads": traffic.reads}


def _tiered(inp, dist) -> dict:
    from repro_torch.quant.tiered import TieredTable
    nb, rpb = 2, int(inp["rpb"])
    m = dist.bank_rank
    rows = slice(m * rpb, (m + 1) * rpb)
    tt = TieredTable(payload=_t(inp["tt_payload"][rows]),
                     scale=_t(inp["tt_scale"][rows]),
                     tier=_t(inp["tt_tier"][rows]),
                     remap_bank=_t(inp["bank"]), remap_slot=_t(inp["slot"]),
                     n_banks=nb, rows_per_bank=rpb, dim=int(inp["tt_dim"]),
                     hot_dtype="bf16")
    fp = _t(inp["packed"])[rows]
    d = dist.for_batch(inp["sparse"].shape[0])
    idx = _t(inp["sparse"])[d.dp_slice()]
    off = _t(inp["off"])
    out, g = _grad(lambda p: TE.tiered_embedding_bag(
        p, tt, idx, d, field_offsets=off), fp)
    _, traffic = TE.tiered_embedding_bag(fp, tt, idx, d,
                                         field_offsets=off,
                                         with_traffic=True)
    return {"out": out, "grad": g, "reads": traffic.reads,
            "nbytes": traffic.nbytes}


def _col_split(inp, dist) -> dict:
    table = _t(inp["table"])
    dc = table.shape[1] // dist.n_banks
    cols = table[:, dist.bank_rank * dc:(dist.bank_rank + 1) * dc].clone()
    idx = _t(inp["col_idx"])[dist.for_batch(inp["col_idx"].shape[0])
                             .dp_slice()]
    part = TE.col_split_embedding_bag(cols, idx, dist)
    return {"part": part, "out": TE.gather_cols(dist, part)}


def _model(inp, dist) -> dict:
    """The reduced updlrm-paper DLRM on the grid: served scores, and three
    DP train steps from a global TrainState cut by
    ``train_state_shardings``."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (recsys_batch_shardings,
                                           recsys_param_shardings,
                                           train_state_shardings)
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    cfg = get_arch("updlrm-paper").reduced
    params = _params(inp, "")
    bank, slot = _t(inp["bank"]), _t(inp["slot"])
    rpb = int(inp["rpb"])
    statics = {"remap_bank": bank, "remap_slot": slot,
               "remap_flat": TE.flat_remap(bank, slot, rpb), "n_banks": 2,
               "rows_per_bank": rpb, "field_offsets": _t(inp["off"])}
    local = recsys_param_shardings(dist, params)
    batch, d = recsys_batch_shardings(dist, {
        "dense": _t(inp["dense"]), "sparse": _t(inp["sparse"]),
        "label": _t(inp["label"])})
    scores = build_recsys_serve(dlrm, cfg, statics, d)(local, batch)
    opt = default_optimizer()
    state = train_state_shardings(dist, TrainState.create(params, opt))
    step = build_train_step(
        lambda p, b, **k: dlrm.loss_fn(cfg, p, statics, b, **k), opt,
        dist=d)
    losses, norms = [], []
    for _ in range(3):
        state, met = step(state, batch)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return {"scores": scores, "losses": torch.tensor(losses),
            "grad_norms": torch.tensor(norms),
            "adagrad_acc": state.opt_state["true"][0],
            "emb": state.params["emb_packed"],
            "top_w0": state.params["top"]["w"][0],
            "bot_b0": state.params["bot"]["b"][0]}


def _builders(inp, dist) -> dict:
    """Every serve-step builder that takes ``dist``, on the reduced model:
    plain adaptive, degraded (bank 1 dead), cached, cached adaptive and
    tiered adaptive, with their per-bank counts."""
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (recsys_batch_shardings,
                                           recsys_param_shardings)
    from repro_torch.models import dlrm
    from repro_torch.quant.tiered import TieredTable
    from repro_torch.serve import serve_step as S
    cfg = get_arch("updlrm-paper").reduced
    bank, slot = _t(inp["bank"]), _t(inp["slot"])
    rpb, m = int(inp["rpb"]), dist.bank_rank
    statics = {"remap_bank": bank, "remap_slot": slot,
               "remap_flat": TE.flat_remap(bank, slot, rpb), "n_banks": 2,
               "rows_per_bank": rpb, "field_offsets": _t(inp["off"])}
    local = recsys_param_shardings(dist, _params(inp, ""))
    batch, d = recsys_batch_shardings(dist, {
        "dense": _t(inp["dense"]), "sparse": _t(inp["sparse"])})
    cbatch, dc = recsys_batch_shardings(dist, {
        "dense": _t(inp["dense"]), "cache_idx": _t(inp["cb_ci"]),
        "residual_idx": _t(inp["cb_ri"])})
    cache = _local(_t(inp["cb_packed"]), inp["cb_bank"], inp["cb_slot"], 2,
                   int(inp["cb_rpb"]), dist)
    rows = slice(m * rpb, (m + 1) * rpb)
    tt = TieredTable(payload=_t(inp["tt_payload"][rows]),
                     scale=_t(inp["tt_scale"][rows]),
                     tier=_t(inp["tt_tier"][rows]), remap_bank=bank,
                     remap_slot=slot, n_banks=2, rows_per_bank=rpb,
                     dim=int(inp["tt_dim"]), hot_dtype="bf16")
    live = torch.tensor([True, False])
    out = {"cached": S.build_recsys_serve_cached(
        dlrm, cfg, statics, cache, dc)(local, cbatch)}
    out["adaptive"], out["adaptive_reads"] = S.build_recsys_serve_adaptive(
        dlrm, cfg, statics, d, with_traffic=True)(local, bank, slot, batch)
    out["degraded"], out["degraded_counts"], out["degraded_reads"] = \
        S.build_recsys_serve_degraded_adaptive(
            dlrm, cfg, statics, d, with_traffic=True)(
                local, bank, slot, live, batch)
    out["cached_ad"], out["cached_ad_reads"] = \
        S.build_recsys_serve_cached_adaptive(
            dlrm, cfg, statics, dc, with_traffic=True)(
                local, bank, slot, cache, cbatch)
    out["tiered"], out["tiered_reads"], out["tiered_nbytes"] = \
        S.build_recsys_serve_tiered_adaptive(
            dlrm, cfg, statics, d, with_traffic=True)(local, tt, batch)
    return out


def _psum_int8(inp, dist) -> dict:
    from repro_torch.train.compress import psum_int8
    x, e = _t(inp["q_x"][dist.rank]), _t(inp["q_e"][dist.rank])
    s_all, e_all = psum_int8(x, dist, e, ("dp", "bank"))
    s_dp, e_dp = psum_int8(x, dist, e, "dp")
    return {"sum_all": s_all, "err_all": e_all, "sum_dp": s_dp,
            "err_dp": e_dp}


def _dp_step(inp, dist) -> dict:
    """The compressed DP step on the reduced dlrm-rm2, dp over every rank
    of the grid (the reference's ``("data", "model")``), 15 steps of one
    batch."""
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm
    from repro_torch.train import optim as O
    from repro_torch.train.dp_step import build_dp_compressed_step
    from repro_torch.train.train_step import TrainState
    cfg = get_arch("dlrm-rm2").reduced
    params = _params(inp, "rm2.")
    bank, slot = _t(inp["rm2.bank"]), _t(inp["rm2.slot"])
    rpb = int(inp["rm2.rpb"])
    statics = {"remap_bank": bank, "remap_slot": slot,
               "remap_flat": TE.flat_remap(bank, slot, rpb), "n_banks": 1,
               "rows_per_bank": rpb, "field_offsets": _t(inp["rm2.off"])}
    b = {k: _t(inp[f"rm2.{k}"]) for k in ("dense", "sparse", "label")}
    # dp over every rank: cut the batch by world rank
    world = dist.size(("dp", "bank"))
    n = b["dense"].shape[0] // world
    local = {k: v[dist.rank * n:(dist.rank + 1) * n] for k, v in b.items()}
    opt = O.adam(1e-2)
    step = build_dp_compressed_step(
        lambda p, bb: dlrm.loss_fn(cfg, p, statics, bb), opt, dist,
        ("dp", "bank"))
    state = TrainState.create(params, opt, compress=True)
    losses = []
    for _ in range(15):
        state, met = step(state, local)
        losses.append(float(met["loss"]))
    return {"losses": torch.tensor(losses)}


GRID42 = {"bag": _bag, "uneven": _uneven, "csr": _csr, "migrate": _migrate,
          "runtime_dp": _runtime_dp, "cache_swap": _cache_swap,
          "cache_bwd": _cache_bwd,
          "tiered": _tiered, "col_split": _col_split, "model": _model,
          "builders": _builders,
          "psum_int8": _psum_int8, "dp_step": _dp_step}


def grid42(rank: int, world: int, inp) -> dict:
    """Every 4 x 2 check, in turn, on one rank."""
    import torch.distributed as tdist
    dist = TE.DistCtx.create(4, 2, device=CPU)
    assert world == 8 and dist.rank == rank == tdist.get_rank()
    out = {}
    for name, fn in GRID42.items():
        for k, v in fn(inp, dist).items():
            out[f"{name}.{k}"] = _np(v) if isinstance(v, torch.Tensor) else v
    return out


# ---------------------------------------------------------------------------
# the 1 x 4 grid: bounded-degraded serving through a bank failure
# ---------------------------------------------------------------------------

def grid14(rank: int, world: int, inp) -> dict:
    from repro_torch.workload.migrate import migrate_table
    dist = TE.DistCtx.create(1, 4, device=CPU)
    nb, cap = 4, int(inp["cap"])
    t = _local(_t(inp["packed"]), inp["bank"], inp["slot"], nb, cap, dist)
    idx, off = _t(inp["sparse"]), _t(inp["off"])
    live, masked = _t(inp["live"]), _t(inp["masked"])
    all_live = torch.ones(nb, dtype=torch.bool)
    healthy = TE.banked_embedding_bag(t, idx, dist, field_offsets=off)
    got, traffic = TE.banked_embedding_bag(
        t, idx, dist, field_offsets=off, bank_live=live, with_traffic=True)
    rows = TE._traffic_rows(idx, off).reshape(idx.shape)
    per_bag = TE.degraded_row_counts(t.remap_bank, live, rows, per_bag=True)
    plan2 = _plan(inp["bank2"], inp["slot2"], nb)
    t2 = migrate_table(t, plan2, dist, rows_per_bank=cap)
    return {
        "healthy": healthy,
        "with_mask": TE.banked_embedding_bag(t, idx, dist, field_offsets=off,
                                             bank_live=all_live),
        "got": got, "reads": traffic.reads,
        "want": TE.banked_embedding_bag(t, masked, dist, field_offsets=off),
        "part": TE._bag_partial_scan(
            t.packed, idx, remap=t.remap_slot,
            bank=TE._effective_bank_map(t.remap_bank, live, nb),
            my_bank=dist.bank_rank, off=off),
        "counts": TE.degraded_row_counts(t.remap_bank, live, rows),
        "filled": TE.degraded_mean_fill(got, per_bag, _t(inp["mean_row"])),
        "migrated": t2.packed, "remap2": t2.remap_bank,
        "recovered": TE.banked_embedding_bag(t2, idx, dist, field_offsets=off,
                                             bank_live=live),
        "counts2": TE.degraded_row_counts(t2.remap_bank, live, rows)}
