"""The multi-GPU bank axis on the CPU: gloo ranks of the port
(``tests/torch_dist_ranks.py``) against the JAX reference, as
``tests/dist_checks.py`` holds the reference's mesh against its
single-device path.

Each grid is spawned ONCE per file (a module-scoped fixture: 8 ranks as a
4 x 2 data x model grid, 4 ranks as a 1 x 4 grid), at the reduced
``updlrm-paper`` size (8 fields x 500 rows, L = 16, D = 8; the compressed
DP step on the reduced ``dlrm-rm2``, as ``dist_checks``); every check is
one case. The reference cannot run its own ``shard_map`` path under this
JAX, so the ranks are held against

  * its per-bank functions, called directly on bank b's rows with
    ``my_bank = b`` (``_bag_partial_scan``, ``_local_gather_partial``,
    ``_scatter_bag_ct``), bit for bit: a bank's partial adds its own
    entries in entry order;
  * its single-device results, bit for bit where the path is exact
    (migration, the tables of a cache swap, counts), within ``atol=1e-5``
    for sums over banks and dp (a reordering of fp32 adds), and scores
    within rtol 1e-5 / atol 1e-6;
  * ``psum_int8``'s formula under ``jax.jit`` (``jax.vmap`` over the
    ranks' inputs with an axis name), bit for bit.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.core import cache_runtime as JC
from repro.core import embedding as JE
from repro.core import grace as JG
from repro.core import partitioning as JP
from repro.data import synthetic as JSYN
from repro.models import dlrm as JD
from repro.quant import QuantSpec, assign_tiers, build_tiered_table
from repro.train import compress as JCOMP
from repro.train import optim as JO
from repro.train import train_step as JTS
from repro.workload import migrate as JMIG
from repro.workload import replanner as JRP
from repro_torch.core import embedding as TE
from repro_torch.dist.launch import run_ranks

import torch_dist_ranks as R

SUM_TOL = dict(rtol=0, atol=1e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)
DP, NB = 4, 2                       # the 4 x 2 grid: rank = d * NB + m


def _np(x):
    return np.asarray(x)


def _bits(x):
    """bf16 arrays as their int16 bits (how they travel to the ranks)."""
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _rank(d, m):
    return d * NB + m


def _dp_rows(x, d, n=DP):
    k = x.shape[0] // n
    return x[d * k:(d + 1) * k]


def _cat_dp(outs, key, m=0):
    return np.concatenate([outs[_rank(d, m)][key] for d in range(DP)])


def _sum_dp(outs, key, m):
    return sum(outs[_rank(d, m)][key].astype(np.float64) for d in range(DP))


def _packed_at(table, plan, cap):
    """The reference's table under ``plan`` at capacity ``cap``, as
    ``dist_checks`` builds it."""
    t = JE.pack_table(table, plan)
    V = table.shape[0]
    return dataclasses.replace(t, packed=JMIG.permute_packed_rows(
        jnp.asarray(table), np.arange(V, dtype=np.int32),
        (plan.bank_of_row.astype(np.int64) * cap
         + plan.slot_of_row).astype(np.int32), plan.n_banks * cap),
        rows_per_bank=cap)


def _mlp_inputs(prefix, params):
    out = {}
    for part in ("bot", "top"):
        n = len(params[part]["w"])
        out[f"{prefix}n_{part}"] = np.asarray(n)
        for i in range(n):
            out[f"{prefix}{part}.w{i}"] = _np(params[part]["w"][i])
            out[f"{prefix}{part}.b{i}"] = _np(params[part]["b"][i])
    return out


# ---------------------------------------------------------------------------
# the 4 x 2 grid
# ---------------------------------------------------------------------------

def _grid42_inputs():
    jcfg = jax_get_arch("updlrm-paper").reduced
    V, D = jcfg.total_vocab, jcfg.embed_dim
    rng = np.random.default_rng(0)
    freq = rng.random(V) + 0.05
    plan = JP.non_uniform_partition(freq, NB)
    params, statics = JD.init_params(jcfg, jax.random.key(0), plan=plan)
    b = JSYN.dlrm_batch(jcfg.vocab_sizes, jcfg.n_dense, 8, seed=3, step=0,
                        multi_hot=jcfg.multi_hot)
    b["sparse"][rng.random(b["sparse"].shape) < 0.15] = -1
    b["sparse"][0, :, :4] = 5                 # in-bag and cross-field repeats
    off = jcfg.field_offsets().astype(np.int32)
    rows = np.where(b["sparse"][..., 0] >= 0, b["sparse"][..., 0] + off, -1)
    inp = {"packed": _np(params["emb_packed"]),
           "bank": plan.bank_of_row.astype(np.int32),
           "slot": plan.slot_of_row.astype(np.int32),
           "rpb": np.asarray(int(statics["rows_per_bank"])), "off": off,
           "sparse": b["sparse"].astype(np.int32), "dense": b["dense"],
           "label": b["label"], "rows": rows.astype(np.int32)}
    inp.update(_mlp_inputs("", params))
    # ragged CSR bags (13, one empty, holes)
    lens = rng.integers(0, 40, 13)
    inp["csr_off"] = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    inp["csr_idx"] = rng.integers(-1, V, int(lens.sum())).astype(np.int32)
    # migration: two capped plans of a drifted popularity
    cap = V // NB + 160
    plan_a = JP.non_uniform_partition(freq, NB, capacity_rows=cap)
    plan_b = JP.non_uniform_partition(np.roll(freq, 1031), NB,
                                      capacity_rows=cap)
    table = (rng.standard_normal((V, D)) * 0.01).astype(np.float32)
    table7 = rng.standard_normal((V, 7)).astype(jnp.bfloat16)
    inp.update(cap=np.asarray(cap), a_packed=_np(_packed_at(table, plan_a,
                                                            cap).packed),
               a_packed_bf16=_bits(_packed_at(table7, plan_a, cap).packed),
               a_bank=plan_a.bank_of_row, a_slot=plan_a.slot_of_row,
               b_bank=plan_b.bank_of_row, b_slot=plan_b.slot_of_row)
    # the runtime's telemetry (its own generator, so the draws below stay
    # as they were): 4 global batches of 256 rows, a Zipf head away from
    # plan_a's, with padding
    rt_rng = np.random.default_rng(7)
    rt_rows = (rt_rng.zipf(1.3, (4, 256)) - 1 + 1500) % V
    rt_rows[rt_rng.random(rt_rows.shape) < 0.1] = -1
    inp["rt_rows"] = rt_rows.astype(np.int32)
    # the cache swap: bags mined into a capped GRACE plan under plan_b
    crpb = 8
    bags = [rng.choice(24, rng.integers(2, 7)) for _ in range(300)]
    cp = JG.mine_cooccurrence(bags, top_items=48, max_groups=16,
                              min_support=2)
    fcp = JC.cap_cache_plan(cp, JC.entry_banks(cp, plan_b.bank_of_row, None),
                            NB, crpb)
    fresh = _packed_at(table, plan_b, cap)
    ct = JC.build_cache_table_fixed(table, fcp, dtype=np.float32)
    inp.update(crpb=np.asarray(crpb),
               bags=np.concatenate(bags).astype(np.int64),
               bag_off=np.concatenate(
                   [[0], np.cumsum([len(x) for x in bags])]).astype(np.int64),
               ci=rng.integers(-1, fcp.n_entries or 1, (8, 3)).astype(
                   np.int32),
               ri=rng.integers(-1, V, (8, 6)).astype(np.int32),
               fresh_packed=_np(fresh.packed), fresh_cache=_np(ct.packed),
               c_bank=_np(ct.remap_bank), c_slot=_np(ct.remap_slot))
    # the fused lookup's backward: a small cache table banked uniformly
    nc = 24
    cbt = JE.pack_table(rng.standard_normal((nc, D)).astype(np.float32),
                        JP.uniform_partition(nc, NB))
    inp.update(cb_packed=_np(cbt.packed), cb_bank=_np(cbt.remap_bank),
               cb_slot=_np(cbt.remap_slot), cb_rpb=np.asarray(
                   cbt.rows_per_bank),
               cb_ci=rng.integers(-1, nc, (8, 8, 4)).astype(np.int32),
               cb_ri=rng.integers(-1, V, (8, 8, 6)).astype(np.int32))
    # a tiered table of the main one
    jt = JE.BankedTable(params["emb_packed"], statics["remap_bank"],
                        statics["remap_slot"], NB,
                        int(statics["rows_per_bank"]))
    tiers = assign_tiers(freq, QuantSpec(byte_budget=12.0, min_hot_rows=64),
                         D).tier_of_row
    tt = build_tiered_table(jt, tiers)
    inp.update(tt_payload=_np(tt.payload), tt_scale=_np(tt.scale),
               tt_tier=_np(tt.tier), tt_dim=np.asarray(tt.dim))
    # the column split: the table in vocab order, one field's bags
    inp.update(table=table, col_idx=np.where(
        b["sparse"][:, 0] >= 0, b["sparse"][:, 0], -1).astype(np.int32))
    # psum_int8: one input and error per rank
    inp.update(q_x=rng.standard_normal((DP * NB, 50)).astype(np.float32),
               q_e=(rng.standard_normal((DP * NB, 50)) * 1e-3).astype(
                   np.float32))
    # the compressed DP step: the reduced dlrm-rm2, as dist_checks
    rcfg = jax_get_arch("dlrm-rm2").reduced
    rparams, rstatics = JD.init_params(rcfg, jax.random.key(0))
    rb = JSYN.dlrm_batch(rcfg.vocab_sizes, rcfg.n_dense, 64, seed=0, step=0)
    inp.update({"rm2.packed": _np(rparams["emb_packed"]),
                "rm2.bank": _np(rstatics["remap_bank"]),
                "rm2.slot": _np(rstatics["remap_slot"]),
                "rm2.rpb": np.asarray(int(rstatics["rows_per_bank"])),
                "rm2.off": _np(rstatics["field_offsets"]),
                **{f"rm2.{k}": v for k, v in rb.items()}})
    inp.update(_mlp_inputs("rm2.", rparams))
    ref = dict(jcfg=jcfg, params=params, statics=statics, jt=jt, plan=plan,
               batch=b, table=table, table7=table7, plan_a=plan_a,
               plan_b=plan_b, tt=tt, fresh=fresh, ct=ct, cbt=cbt, rcfg=rcfg,
               rparams=rparams, rstatics=rstatics, rbatch=rb)
    return inp, ref


@pytest.fixture(scope="module")
def grid42(tmp_path_factory):
    inp, ref = _grid42_inputs()
    outs = run_ranks(R.grid42, DP * NB, tmp_path_factory.mktemp("grid42"),
                     inputs=inp, timeout=600, init_timeout=180)
    return inp, ref, outs


def _check_bag_partials(inp, ref, outs):
    """Each rank's partial = the reference's ``_bag_partial_scan`` on its
    bank's rows and dp slice, bit for bit."""
    rpb = int(inp["rpb"])
    for d in range(DP):
        for m in range(NB):
            want = JE._bag_partial_scan(
                jnp.asarray(inp["packed"][m * rpb:(m + 1) * rpb]),
                jnp.asarray(_dp_rows(inp["sparse"], d)),
                remap=jnp.asarray(inp["slot"]), bank=jnp.asarray(inp["bank"]),
                my_bank=m, off=jnp.asarray(inp["off"]))
            np.testing.assert_array_equal(outs[_rank(d, m)]["bag.part"],
                                          np.asarray(want))


def _check_bag_forward(inp, ref, outs):
    """The bank sum: the two partials added (exact for two terms), the same
    on both bank ranks, and within atol 1e-5 of the single-device lookup."""
    for d in range(DP):
        o0, o1 = outs[_rank(d, 0)], outs[_rank(d, 1)]
        np.testing.assert_array_equal(o0["bag.out"], o1["bag.out"])
        np.testing.assert_array_equal(o0["bag.out"],
                                      o0["bag.part"] + o1["bag.part"])
    want = JE.banked_embedding_bag(ref["jt"], jnp.asarray(inp["sparse"]),
                                   None, backend="jnp",
                                   field_offsets=jnp.asarray(inp["off"]))
    np.testing.assert_allclose(_cat_dp(outs, "bag.out"), np.asarray(want),
                               **SUM_TOL)


def _check_bag_traffic(inp, ref, outs):
    """with_traffic: every rank's counts are the global batch's."""
    _, want = JE.banked_embedding_bag(
        ref["jt"], jnp.asarray(inp["sparse"]), None, backend="jnp",
        field_offsets=jnp.asarray(inp["off"]), with_traffic=True)
    for o in outs:
        np.testing.assert_array_equal(o["bag.reads"], np.asarray(want.reads))
        np.testing.assert_array_equal(o["bag.nbytes"],
                                      np.asarray(want.nbytes))


def _check_bag_scatter(inp, ref, outs):
    """Each rank's shard gradient = the reference's ``_scatter_bag_ct`` of
    the cotangent it saw onto its bank's rows, bit for bit."""
    rpb = int(inp["rpb"])
    for d in range(DP):
        for m in range(NB):
            o = outs[_rank(d, m)]
            want = JE._scatter_bag_ct(
                (rpb, inp["packed"].shape[1]), jnp.float32,
                jnp.asarray(inp["bank"]), jnp.asarray(inp["slot"]),
                jnp.int32(m), jnp.asarray(_dp_rows(inp["sparse"], d)),
                jnp.asarray(o["bag.ct"]), off=jnp.asarray(inp["off"]))
            np.testing.assert_array_equal(o["bag.grad"], np.asarray(want))


def _check_bag_grads(inp, ref, outs):
    """d sum(out^2) / d packed: the shards' gradients summed over dp = the
    single-device gradient's rows of each bank."""
    rpb = int(inp["rpb"])
    jt = ref["jt"]

    def loss(p):
        return (JE.banked_embedding_bag(
            dataclasses.replace(jt, packed=p), jnp.asarray(inp["sparse"]),
            None, backend="jnp", field_offsets=jnp.asarray(inp["off"]))
            ** 2).sum()
    g = np.asarray(jax.grad(loss)(jt.packed))
    for m in range(NB):
        np.testing.assert_allclose(_sum_dp(outs, "bag.grad", m),
                                   g[m * rpb:(m + 1) * rpb], **SUM_TOL)


def _check_gather(inp, ref, outs):
    """The dense gather: each bank's partial = the reference's
    ``_local_gather_partial`` bit for bit; the sum = the single-device
    gather."""
    rpb = int(inp["rpb"])
    for d in range(DP):
        for m in range(NB):
            want = JE._local_gather_partial(
                jnp.asarray(inp["packed"][m * rpb:(m + 1) * rpb]),
                jnp.asarray(inp["bank"]), jnp.asarray(inp["slot"]),
                jnp.asarray(_dp_rows(inp["rows"], d)), m)
            np.testing.assert_array_equal(
                outs[_rank(d, m)]["bag.gather_part"], np.asarray(want))
    want = JE.lookup_unsharded(ref["jt"], jnp.asarray(inp["rows"]),
                               reduce_bag=False)
    np.testing.assert_allclose(_cat_dp(outs, "bag.gather"), np.asarray(want),
                               **SUM_TOL)


def _check_uneven_batch(inp, ref, outs):
    """A batch of 6 on 4 dp ranks (the reference's ``dp_ok`` false): every
    rank holds it whole, its output is the whole batch's and its counts
    are not summed over dp."""
    sp = jnp.asarray(inp["sparse"][:6])
    want, traffic = JE.banked_embedding_bag(
        ref["jt"], sp, None, backend="jnp",
        field_offsets=jnp.asarray(inp["off"]), with_traffic=True)
    for o in outs:
        assert o["uneven.replicated"].item()
        assert o["uneven.refused"].all(), "a context without the batch, or " \
            "for another batch, took it"
        np.testing.assert_allclose(o["uneven.out"], np.asarray(want),
                                   **SUM_TOL)
        np.testing.assert_array_equal(o["uneven.reads"],
                                      np.asarray(traffic.reads))


def _csr_ref(inp, ref):
    offsets = inp["csr_off"]
    n = offsets.shape[0] - 1
    jt = ref["jt"]

    def f(p):
        return JE.csr_embedding_bag(
            dataclasses.replace(jt, packed=p), jnp.asarray(inp["csr_idx"]),
            jnp.asarray(offsets[:n].astype(np.int32)), n, None,
            backend="jnp")
    return np.asarray(f(jt.packed)), np.asarray(
        jax.grad(lambda p: (f(p) ** 2).sum())(jt.packed))


def _check_csr_split(inp, ref, outs):
    """``balanced_csr_shards`` as the reference's, and balanced to a bag."""
    offsets = inp["csr_off"]
    got = TE.balanced_csr_shards(offsets, DP)
    np.testing.assert_array_equal(got, JE.balanced_csr_shards(offsets, DP))
    totals = offsets[got[1:]] - offsets[got[:-1]]
    assert totals.max() - totals.min() <= np.diff(offsets).max()
    sh, jsh = TE.shard_csr_batch(inp["csr_idx"], offsets, DP), \
        JE.shard_csr_batch(inp["csr_idx"], offsets, DP)
    for k in ("idx", "seg", "bounds"):
        np.testing.assert_array_equal(sh[k], jsh[k])


def _check_csr_lookup(inp, ref, outs):
    """The replicated-stream CSR lookup on every rank, forward and its
    shard gradient (each rank's is its bank's whole gradient)."""
    want, g = _csr_ref(inp, ref)
    rpb = int(inp["rpb"])
    for r, o in enumerate(outs):
        m = r % NB
        np.testing.assert_allclose(o["csr.out"], want, **SUM_TOL)
        np.testing.assert_allclose(o["csr.grad"], g[m * rpb:(m + 1) * rpb],
                                   **SUM_TOL)


def _check_csr_sharded(inp, ref, outs):
    """The dp-split CSR lookup: every bag on every rank; the shard
    gradients summed over dp = the single-device gradient's rows."""
    want, g = _csr_ref(inp, ref)
    rpb = int(inp["rpb"])
    for o in outs:
        np.testing.assert_allclose(o["csr.sharded"], want, **SUM_TOL)
    for m in range(NB):
        np.testing.assert_allclose(_sum_dp(outs, "csr.sharded_grad", m),
                                   g[m * rpb:(m + 1) * rpb], **SUM_TOL)


def _check_csr_fallback(inp, ref, outs):
    """Without dist, both offset forms: the single-device lookup."""
    want, _ = _csr_ref(inp, ref)
    for k in ("csr.fallback_total", "csr.fallback_starts"):
        np.testing.assert_allclose(outs[0][k], want, **SUM_TOL)


def _migration_ref(ref, table, plan):
    cap = ref["fresh"].rows_per_bank
    t = _packed_at(table, ref["plan_a"], cap)
    return _bits(JMIG.migrate_table(t, plan, rows_per_bank=cap).packed)


def _check_shards(outs, key, want, cap):
    for r, o in enumerate(outs):
        m = r % NB
        np.testing.assert_array_equal(o[key], want[m * cap:(m + 1) * cap])


def _check_migration_compact(inp, ref, outs):
    want = _migration_ref(ref, ref["table"], ref["plan_b"])
    _check_shards(outs, "migrate.f32_compact", want, int(inp["cap"]))


def _check_migration_full(inp, ref, outs):
    want = _migration_ref(ref, ref["table"], ref["plan_b"])
    _check_shards(outs, "migrate.f32_full", want, int(inp["cap"]))


def _check_migration_nomove(inp, ref, outs):
    _check_shards(outs, "migrate.f32_nomove", inp["a_packed"],
                  int(inp["cap"]))
    _check_shards(outs, "migrate.bf16_nomove", inp["a_packed_bf16"],
                  int(inp["cap"]))


def _check_migration_bf16(inp, ref, outs):
    """A bf16 table of D = 7 (14-byte rows: the byte-wise exchange)."""
    want = _migration_ref(ref, ref["table7"], ref["plan_b"])
    for ex in ("compact", "full"):
        _check_shards(outs, f"migrate.bf16_{ex}", want, int(inp["cap"]))


def _check_runtime_migration(inp, ref, outs):
    """The runtime's swap under dist migrates through the exchange."""
    want = _migration_ref(ref, ref["table"], ref["plan_b"])
    _check_shards(outs, "migrate.runtime", want, int(inp["cap"]))


def _check_migration_plan_mismatch(inp, ref, outs):
    """One rank migrating under another plan (one that moves no row for
    it): every rank raises before any exchange."""
    for o in outs:
        assert o["migrate.mismatch_raised"].item()


def _runtime_ref_plan(inp, ref):
    cap = int(inp["cap"])
    jr = JRP.Replanner(JRP.ReplanConfig(n_banks=NB, capacity_rows=cap),
                       ref["table"].shape[0], init_plan=ref["plan_a"])
    for rows in inp["rt_rows"]:
        jr.observe_rows(rows)
    return jr.force_replan().plan


def _check_runtime_global_batch(inp, ref, outs):
    """With dp > 1, every rank's runtime observing the global batches
    replans as the reference's replanner fed the same rows, and its swap
    migrates the shards to that plan's single-device table, bit for
    bit."""
    plan = _runtime_ref_plan(inp, ref)
    assert (plan.bank_of_row != ref["plan_a"].bank_of_row).any()
    for o in outs:
        assert not o["runtime_dp.global_raised"].item()
        np.testing.assert_array_equal(o["runtime_dp.global_bank"],
                                      plan.bank_of_row)
    _check_shards(outs, "runtime_dp.global_packed",
                  _migration_ref(ref, ref["table"], plan), int(inp["cap"]))


def _check_runtime_dp_slices_refused(inp, ref, outs):
    """Each rank observing only its dp slice builds another plan: the swap
    raises on every rank and every shard stays as it was."""
    cap = int(inp["cap"])
    for o in outs:
        assert o["runtime_dp.local_raised"].item()
    _check_shards(outs, "runtime_dp.local_packed", inp["a_packed"], cap)


def _check_cache_swap_tables(inp, ref, outs):
    """The migrated EMT shards and the re-summed cache table's shards equal
    a fresh single-device build's rows, bit for bit."""
    cap, crpb = int(inp["cap"]), int(inp["crpb"])
    _check_shards(outs, "cache_swap.emt", inp["fresh_packed"], cap)
    _check_shards(outs, "cache_swap.cache", inp["fresh_cache"], crpb)
    for o in outs:
        np.testing.assert_array_equal(o["cache_swap.c_bank"], inp["c_bank"])
        np.testing.assert_array_equal(o["cache_swap.c_slot"], inp["c_slot"])


def _check_cache_swap_serve(inp, ref, outs):
    """Swapped and fresh tables through the same sharded fused lookup: bit
    for bit; against the single-device lookup: within atol 1e-5."""
    for o in outs:
        np.testing.assert_array_equal(o["cache_swap.out"],
                                      o["cache_swap.out_fresh"])
    want = JE.banked_cache_residual_bag(
        ref["fresh"], ref["ct"], jnp.asarray(inp["ci"]),
        jnp.asarray(inp["ri"]), None, backend="jnp")
    np.testing.assert_allclose(_cat_dp(outs, "cache_swap.out"),
                               np.asarray(want), **SUM_TOL)


def _cache_bwd_ref(inp, ref):
    jt, cbt = ref["jt"], ref["cbt"]
    ci, ri = jnp.asarray(inp["cb_ci"]), jnp.asarray(inp["cb_ri"])

    def f(e, c):
        return JE.banked_cache_residual_bag(
            dataclasses.replace(jt, packed=e),
            dataclasses.replace(cbt, packed=c), ci, ri, None, backend="jnp")
    out = f(jt.packed, cbt.packed)
    ge, gc = jax.grad(lambda e, c: (f(e, c) ** 2).sum(), argnums=(0, 1))(
        jt.packed, cbt.packed)
    _, traffic = JE.banked_cache_residual_bag(jt, cbt, ci, ri, None,
                                              backend="jnp",
                                              with_traffic=True)
    return np.asarray(out), np.asarray(ge), np.asarray(gc), traffic


def _check_cache_bwd(inp, ref, outs):
    """The fused lookup's dual scatter on the shards: both tables'
    gradients summed over dp = the single-device gradients' rows."""
    out, ge, gc, _ = _cache_bwd_ref(inp, ref)
    rpb, crpb = int(inp["rpb"]), int(inp["cb_rpb"])
    np.testing.assert_allclose(_cat_dp(outs, "cache_bwd.out"), out,
                               **SUM_TOL)
    for m in range(NB):
        np.testing.assert_allclose(_sum_dp(outs, "cache_bwd.grad_emt", m),
                                   ge[m * rpb:(m + 1) * rpb], **SUM_TOL)
        np.testing.assert_allclose(_sum_dp(outs, "cache_bwd.grad_cache", m),
                                   gc[m * crpb:(m + 1) * crpb], **SUM_TOL)


def _check_cache_traffic(inp, ref, outs):
    *_, traffic = _cache_bwd_ref(inp, ref)
    for o in outs:
        np.testing.assert_array_equal(o["cache_bwd.reads"],
                                      np.asarray(traffic.reads))


def _tiered_ref(inp, ref):
    jt, tt = ref["jt"], ref["tt"]
    sp, off = jnp.asarray(inp["sparse"]), jnp.asarray(inp["off"])

    def f(p):
        return JE.tiered_embedding_bag(p, tt, sp, None, backend="jnp",
                                       field_offsets=off)
    _, traffic = JE.tiered_embedding_bag(jt.packed, tt, sp, None,
                                         backend="jnp", field_offsets=off,
                                         with_traffic=True)
    return (np.asarray(f(jt.packed)),
            np.asarray(jax.grad(lambda p: (f(p) ** 2).sum())(jt.packed)),
            traffic)


def _check_tiered_lookup(inp, ref, outs):
    want, _, _ = _tiered_ref(inp, ref)
    np.testing.assert_allclose(_cat_dp(outs, "tiered.out"), want, **SUM_TOL)


def _check_tiered_grads(inp, ref, outs):
    """The straight-through gradient onto the fp shards."""
    _, g, _ = _tiered_ref(inp, ref)
    rpb = int(inp["rpb"])
    for m in range(NB):
        np.testing.assert_allclose(_sum_dp(outs, "tiered.grad", m),
                                   g[m * rpb:(m + 1) * rpb], **SUM_TOL)


def _check_tiered_traffic(inp, ref, outs):
    *_, traffic = _tiered_ref(inp, ref)
    for o in outs:
        np.testing.assert_array_equal(o["tiered.reads"],
                                      np.asarray(traffic.reads))
        np.testing.assert_array_equal(o["tiered.nbytes"],
                                      np.asarray(traffic.nbytes))


def _check_col_split(inp, ref, outs):
    """Column slices per bank, joined over the bank group."""
    want = np.asarray(JE.col_split_embedding_bag(
        jnp.asarray(inp["table"]), jnp.asarray(inp["col_idx"]), None))
    np.testing.assert_allclose(_cat_dp(outs, "col_split.out"), want,
                               **SUM_TOL)
    dc = want.shape[1] // NB
    for m in range(NB):
        np.testing.assert_allclose(_cat_dp(outs, "col_split.part", m),
                                   want[:, m * dc:(m + 1) * dc], **SUM_TOL)


def _check_serve_scores(inp, ref, outs):
    """``build_recsys_serve(..., dist)``: each rank's dp slice of the
    reference's scores."""
    b = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    want = np.asarray(jax.nn.sigmoid(JD.forward(
        ref["jcfg"], ref["params"], ref["statics"], b, None)))
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["model.scores"],
                                   _dp_rows(want, r // NB), **SCORE_TOL)


def _check_serve_builders(inp, ref, outs):
    """The remap-lane, degraded, cached, cached adaptive and tiered
    adaptive serve steps under ``dist``: each rank's dp slice of the reference's
    single-device scores, per-request degraded counts, and the global
    batch's per-bank counts."""
    from repro.serve import serve_step as JSS
    cfg, params, statics = ref["jcfg"], ref["params"], ref["statics"]
    bank, slot = statics["remap_bank"], statics["remap_slot"]
    b = {k: jnp.asarray(ref["batch"][k]) for k in ("dense", "sparse")}
    cb = {"dense": b["dense"], "cache_idx": jnp.asarray(inp["cb_ci"]),
          "residual_idx": jnp.asarray(inp["cb_ri"])}
    live = jnp.asarray([True, False])
    want = {"cached": JSS.build_recsys_serve_cached(
        JD, cfg, statics, ref["cbt"])(params, cb)}
    # the remap lane's step (the reference builds it inside its launcher):
    # the plain scores and the lookup's reads
    want["adaptive"] = JSS.build_recsys_serve(JD, cfg, statics)(params, b)
    want["adaptive_reads"] = JE.banked_embedding_bag(
        ref["jt"], b["sparse"], None, backend="jnp",
        field_offsets=jnp.asarray(inp["off"]), with_traffic=True)[1].reads
    want["degraded"], want["degraded_counts"], want["degraded_reads"] = \
        JSS.build_recsys_serve_degraded_adaptive(
            JD, cfg, statics, with_traffic=True)(params, bank, slot, live, b)
    want["cached_ad"], want["cached_ad_reads"] = \
        JSS.build_recsys_serve_cached_adaptive(
            JD, cfg, statics, with_traffic=True)(
                params, bank, slot, ref["cbt"], cb)
    want["tiered"], want["tiered_reads"], want["tiered_nbytes"] = \
        JSS.build_recsys_serve_tiered_adaptive(
            JD, cfg, statics, with_traffic=True)(params, ref["tt"], b)
    for r, o in enumerate(outs):
        for k, w in want.items():
            got, w = o[f"builders.{k}"], np.asarray(w)
            if k.endswith(("reads", "nbytes")):
                np.testing.assert_array_equal(got, w, err_msg=k)
            elif k.endswith("counts"):
                np.testing.assert_array_equal(got, _dp_rows(w, r // NB),
                                              err_msg=k)
            else:
                np.testing.assert_allclose(got, _dp_rows(w, r // NB),
                                           err_msg=k, **SCORE_TOL)


def _check_train_dp(inp, ref, outs):
    """Three DP train steps (dp-mean of the gradients before clipping,
    row-wise Adagrad on the shards) against the reference's jitted
    single-device step: losses, the table shards and dense params, and
    two numbers that scale with the gradient (Adam and Adagrad updates do
    not): the clipped dense gradients' global norm each step, and the
    Adagrad accumulator's shard (the mean of g^2 per row)."""
    cfg, statics = ref["jcfg"], ref["statics"]
    opt = JTS.default_optimizer()
    step = jax.jit(JTS.build_train_step(
        lambda p, b: JD.loss_fn(cfg, p, statics, b), opt))
    state = JTS.TrainState.create(ref["params"], opt)
    b = {k: jnp.asarray(v) for k, v in ref["batch"].items()}
    losses, norms = [], []
    for _ in range(3):
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    rpb = int(inp["rpb"])
    emb = np.asarray(state.params["emb_packed"])
    acc = np.asarray(state.opt_state["true"][0])
    assert acc.shape == emb.shape[:1] and acc.any()
    for r, o in enumerate(outs):
        m = r % NB
        np.testing.assert_allclose(o["model.losses"], losses, rtol=1e-4)
        np.testing.assert_allclose(o["model.grad_norms"], norms,
                                   **TRAIN_TOL)
        np.testing.assert_allclose(o["model.adagrad_acc"],
                                   acc[m * rpb:(m + 1) * rpb], **TRAIN_TOL)
        np.testing.assert_allclose(o["model.emb"], emb[m * rpb:(m + 1) * rpb],
                                   **TRAIN_TOL)
        np.testing.assert_allclose(o["model.top_w0"],
                                   np.asarray(state.params["top"]["w"][0]),
                                   **TRAIN_TOL)
        np.testing.assert_allclose(o["model.bot_b0"],
                                   np.asarray(state.params["bot"]["b"][0]),
                                   **TRAIN_TOL)


def _vmapped_psum_int8(x, e):
    return jax.jit(jax.vmap(lambda a, b: JCOMP.psum_int8(a, "i", b),
                            axis_name="i"))(jnp.asarray(x), jnp.asarray(e))


def _check_psum_int8(inp, ref, outs):
    """The int8 psum over every rank and over each dp group = the
    reference's formula, jitted and vmapped over the ranks' inputs, bit
    for bit."""
    x, e = inp["q_x"], inp["q_e"]
    s, err = _vmapped_psum_int8(x, e)
    for r, o in enumerate(outs):
        np.testing.assert_array_equal(o["psum_int8.sum_all"],
                                      np.asarray(s[r]))
        np.testing.assert_array_equal(o["psum_int8.err_all"],
                                      np.asarray(err[r]))
    for m in range(NB):
        ranks = [_rank(d, m) for d in range(DP)]
        s, err = _vmapped_psum_int8(x[ranks], e[ranks])
        for i, r in enumerate(ranks):
            np.testing.assert_array_equal(outs[r]["psum_int8.sum_dp"],
                                          np.asarray(s[i]))
            np.testing.assert_array_equal(outs[r]["psum_int8.err_dp"],
                                          np.asarray(err[i]))


def _check_dp_compressed_step(inp, ref, outs):
    """``dist_checks``' criterion: the compressed DP step converges like
    the reference's uncompressed step (15 steps of one batch of 64, dp over
    all 8 ranks), from the same first loss."""
    cfg, statics = ref["rcfg"], ref["rstatics"]
    opt = JO.adam(1e-2)
    step = jax.jit(JTS.build_train_step(
        lambda p, b: JD.loss_fn(cfg, p, statics, b), opt, clip_norm=None))
    state = JTS.TrainState.create(ref["rparams"], opt)
    b = {k: jnp.asarray(v) for k, v in ref["rbatch"].items()}
    losses_r = []
    for _ in range(15):
        state, met = step(state, b)
        losses_r.append(float(met["loss"]))
    for o in outs:
        lc = o["dp_step.losses"]
        np.testing.assert_allclose(lc[0], losses_r[0], **SUM_TOL)
        assert lc[-1] < lc[0] and abs(lc[-1] - losses_r[-1]) < 0.15, \
            (lc, losses_r)


GRID42_CHECKS = [f for n, f in sorted(globals().items())
                 if n.startswith("_check_") and n != "_check_shards"]


@pytest.mark.parametrize("check", GRID42_CHECKS,
                         ids=[f.__name__[len("_check_"):]
                              for f in GRID42_CHECKS])
def test_grid_4x2(grid42, check):
    inp, ref, outs = grid42
    check(inp, ref, outs)


# ---------------------------------------------------------------------------
# the 1 x 4 grid: serving through a bank failure, recovery migration
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def grid14(tmp_path_factory):
    jcfg = jax_get_arch("updlrm-paper").reduced
    V, D, nb = jcfg.total_vocab, jcfg.embed_dim, 4
    cap = 1400                        # 3 live banks still hold the vocab
    rng = np.random.default_rng(31)
    table = rng.standard_normal((V, D)).astype(np.float32)
    freq = rng.random(V) + 0.1
    plan = JP.non_uniform_partition(freq, nb, capacity_rows=cap)
    jt = _packed_at(table, plan, cap)
    b = JSYN.dlrm_batch(jcfg.vocab_sizes, jcfg.n_dense, 8, seed=5, step=0,
                        multi_hot=jcfg.multi_hot)
    sparse = b["sparse"].astype(np.int32)
    sparse[rng.random(sparse.shape) < 0.1] = -1
    off = jcfg.field_offsets().astype(np.int32)
    dead = int(np.argmax(plan.load_per_bank))
    live = np.ones(nb, dtype=bool)
    live[dead] = False
    union = np.where(sparse >= 0, sparse + off[None, :, None], -1)
    on_dead = (union >= 0) & (plan.bank_of_row[np.maximum(union, 0)] == dead)
    plan2 = JP.non_uniform_partition(freq, nb, capacity_rows=cap,
                                     bank_capacity_rows=np.where(live, cap,
                                                                 0))
    mean_row = table.mean(axis=0)
    inp = {"packed": _np(jt.packed), "bank": plan.bank_of_row,
           "slot": plan.slot_of_row, "cap": np.asarray(cap), "off": off,
           "sparse": sparse, "live": live,
           "masked": np.where(on_dead, -1, sparse).astype(np.int32),
           "bank2": plan2.bank_of_row, "slot2": plan2.slot_of_row,
           "mean_row": mean_row}
    outs = run_ranks(R.grid14, nb, tmp_path_factory.mktemp("grid14"),
                     inputs=inp, timeout=600, init_timeout=180)
    fresh2 = np.zeros((nb * cap, D), np.float32)
    fresh2[plan2.bank_of_row.astype(np.int64) * cap + plan2.slot_of_row] = \
        table
    ref = dict(jt=jt, dead=dead, on_dead=on_dead, fresh2=fresh2, cap=cap,
               mean_row=mean_row)
    return inp, ref, outs


def _degraded_healthy_mask_noop(inp, ref, outs):
    for o in outs:
        np.testing.assert_array_equal(o["healthy"], o["with_mask"])


def _degraded_bounded(inp, ref, outs):
    """Degraded = healthy with the dead bank's ids masked, bit for bit, and
    within atol 1e-5 of the reference's single-device degraded lookup."""
    assert ref["on_dead"].any()
    want = JE.banked_embedding_bag(
        ref["jt"], jnp.asarray(inp["sparse"]), None, backend="jnp",
        field_offsets=jnp.asarray(inp["off"]),
        bank_live=jnp.asarray(inp["live"]))
    for o in outs:
        np.testing.assert_array_equal(o["got"], o["want"])
        np.testing.assert_allclose(o["got"], np.asarray(want), **SUM_TOL)


def _degraded_dead_bank_reads_zero(inp, ref, outs):
    """Under the effective map the dead bank's rank adds nothing."""
    assert not outs[ref["dead"]]["part"].any()
    assert all(outs[r]["part"].any() for r in range(4) if r != ref["dead"])


def _degraded_counts_confined(inp, ref, outs):
    _, traffic = JE.banked_embedding_bag(
        ref["jt"], jnp.asarray(inp["sparse"]), None, backend="jnp",
        field_offsets=jnp.asarray(inp["off"]),
        bank_live=jnp.asarray(inp["live"]), with_traffic=True)
    for o in outs:
        np.testing.assert_array_equal(o["counts"],
                                      ref["on_dead"].sum(axis=(1, 2)))
        np.testing.assert_array_equal(o["reads"], np.asarray(traffic.reads))


def _degraded_mean_fill(inp, ref, outs):
    """The mean fill goes on once, after the bank sum."""
    sp, off, live = (jnp.asarray(inp["sparse"]), jnp.asarray(inp["off"]),
                     jnp.asarray(inp["live"]))
    got = JE.banked_embedding_bag(ref["jt"], sp, None, backend="jnp",
                                  field_offsets=off, bank_live=live)
    union = jnp.asarray(np.where(inp["sparse"] >= 0,
                                 inp["sparse"] + inp["off"][None, :, None],
                                 -1))
    per_bag = JE.degraded_row_counts(ref["jt"].remap_bank, live, union,
                                     per_bag=True)
    want = JE.degraded_mean_fill(got, per_bag, jnp.asarray(ref["mean_row"]))
    for o in outs:
        np.testing.assert_allclose(o["filled"], np.asarray(want), **SUM_TOL)


def _degraded_recovery_migration(inp, ref, outs):
    cap = ref["cap"]
    for m, o in enumerate(outs):
        np.testing.assert_array_equal(o["migrated"],
                                      ref["fresh2"][m * cap:(m + 1) * cap])
        assert (o["remap2"] != ref["dead"]).all()


def _degraded_recovery_serves_clean(inp, ref, outs):
    for o in outs:
        assert (o["counts2"] == 0).all()
        np.testing.assert_allclose(o["recovered"], o["healthy"], **SUM_TOL)


GRID14_CHECKS = [f for n, f in sorted(globals().items())
                 if n.startswith("_degraded_")]


@pytest.mark.parametrize("check", GRID14_CHECKS,
                         ids=[f.__name__[len("_degraded_"):]
                              for f in GRID14_CHECKS])
def test_grid_1x4_degraded(grid14, check):
    inp, ref, outs = grid14
    check(inp, ref, outs)
