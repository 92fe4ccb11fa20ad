"""The port's cache-aware path (§3.3, Fig. 7) against the JAX package's, on
the CPU: the numpy pre-processing (traces, GRACE mining, the cache-aware
plan, capping, rewriting, the cache table), the fused lookup in both of its
summation orders, the dual-scatter gradients, the cached DLRM forward and
the cached serve run.

Inputs come from numpy seeds; the reference's tables and weights are
carried across with ``repro_torch.convert``. Each test states its
tolerance. The pre-processing is numpy on both sides and must give equal
arrays. The bag sums come in two fp32 orders: the fused kernel's (one
accumulator, cache stream then residual stream), which the port's plain
version repeats, and the reference's jnp order (the two streams summed
apart, then added), which the port's ``backend='torch'`` repeats; each is
held bit for bit to its reference counterpart, and the two to each other
within atol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import cache_runtime as JC
from repro.core import embedding as JE
from repro.core import grace as JG
from repro.core import partitioning as JP
from repro.kernels import embedding_bag as JK
from repro.kernels import ref as JREF
from repro.models import dlrm as JD
from repro.workload import trace as JT
from repro_torch.configs import get_arch
from repro_torch.convert import (banked_table_from_jax, params_from_jax,
                                 statics_from_jax, to_tensor)
from repro_torch.core import cache_runtime as TC
from repro_torch.core import embedding as TE
from repro_torch.core import grace as TG
from repro_torch.core import partitioning as TP
from repro_torch.kernels import embedding_bag as TK
from repro_torch.kernels import ref as TREF
from repro_torch.launch import serve as TSERVE
from repro_torch.models import dlrm as TD
from repro_torch.workload import trace as TT

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# pre-processing: equal arrays
# ---------------------------------------------------------------------------

DRIFTS = [dict(n_items=500, zipf_a=1.2, avg_bag=16.0),
          dict(n_items=300, zipf_a=1.05, avg_bag=8.0, rotate_every=5,
               rotate_frac=0.25, diurnal_period=32, burst_prob=0.2,
               burst_len=4, burst_items=8),
          # a large catalogue with the diurnal blend on: the cached cdf is
          # rebuilt at every window boundary (every 2 bags)
          dict(n_items=150_000, zipf_a=1.05, avg_bag=64.0,
               diurnal_period=32)]


@pytest.mark.parametrize("drift", DRIFTS)
def test_trace_matches_jax(drift):
    """Bags, rectangles and DLRM batches of the drifting trace: equal."""
    jt = [JT.DriftingZipfTrace(JT.DriftConfig(**drift), seed=3 + f)
          for f in range(3)]
    tt = [TT.DriftingZipfTrace(TT.DriftConfig(**drift), seed=3 + f)
          for f in range(3)]
    for a, b in zip(jt[0].bags(12), tt[0].bags(12)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(jt[1].rect(5, 10), tt[1].rect(5, 10))
    np.testing.assert_array_equal(jt[2].popularity(40), tt[2].popularity(40))
    for mh in (1, 16):
        np.testing.assert_array_equal(JT.dlrm_drifting_batch(jt, 4, mh),
                                      TT.dlrm_drifting_batch(tt, 4, mh))


def test_criteo_tsv_matches_jax(tmp_path):
    """The Criteo TSV writer writes the same file; the reader and the row
    stream read it alike."""
    drift = JT.DriftConfig(n_items=50, zipf_a=1.1, avg_bag=1.0,
                           rotate_every=7)
    JT.write_criteo_tsv(str(tmp_path / "j.tsv"), 20, n_fields=4,
                        vocab_per_field=50, drift=drift, seed=2)
    TT.write_criteo_tsv(str(tmp_path / "t.tsv"), 20, n_fields=4,
                        vocab_per_field=50,
                        drift=TT.DriftConfig(**dataclasses.asdict(drift)),
                        seed=2)
    assert (tmp_path / "j.tsv").read_text() == (tmp_path / "t.tsv").read_text()
    want = JT.read_criteo_tsv(str(tmp_path / "j.tsv"), hash_vocab=40)
    got = TT.read_criteo_tsv(str(tmp_path / "j.tsv"), hash_vocab=40)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    offs = np.arange(26) * 40
    for a, b in zip(JT.criteo_row_stream(want, offs),
                    TT.criteo_row_stream(got, offs)):
        np.testing.assert_array_equal(a, b)


def _window(n_items=500, n_bags=128, seed=0, avg=16.0):
    tr = JT.DriftingZipfTrace(JT.DriftConfig(n_items=n_items, zipf_a=1.2,
                                             avg_bag=avg), seed=seed)
    return tr.bags(n_bags)


def _assert_cache_plans_equal(a, b):
    assert len(a.groups) == len(b.groups)
    for x, y in zip(a.groups, b.groups):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype
    np.testing.assert_array_equal(a.benefits, b.benefits)
    assert [(e.members, e.hits) for e in a.entries] == \
        [(e.members, e.hits) for e in b.entries]
    assert a.entry_of_subset == b.entry_of_subset


@pytest.mark.parametrize("kw", [dict(top_items=64, max_groups=16),
                                dict(top_items=2048, max_groups=256,
                                     min_support=2),
                                dict(top_items=32, max_groups=8,
                                     max_group_size=2, min_support=3)])
def test_mine_cooccurrence_matches_jax(kw):
    """Groups, benefits, entries and the subset index: equal."""
    bags = _window()
    want = JG.mine_cooccurrence(bags, **kw)
    got = TG.mine_cooccurrence(bags, **kw)
    assert got.n_entries == want.n_entries > 0
    _assert_cache_plans_equal(got, want)
    assert TG._subsets([4, 7, 9]) == JG._subsets([4, 7, 9])


def _plans(emt_cap, cache_cap, n_banks=8):
    bags = _window(n_items=4000, n_bags=256, avg=24.0)
    cp = JG.mine_cooccurrence(bags, top_items=256, max_groups=40)
    freq = np.bincount(np.concatenate(bags), minlength=4000).astype(
        np.float64)
    want = JP.cache_aware_partition(freq, cp.groups, cp.benefits, n_banks,
                                    emt_capacity_rows=emt_cap,
                                    cache_capacity_entries=cache_cap)
    got = TP.cache_aware_partition(freq, cp.groups, cp.benefits, n_banks,
                                   emt_capacity_rows=emt_cap,
                                   cache_capacity_entries=cache_cap)
    return cp, want, got


@pytest.mark.parametrize("emt_cap,cache_cap", [(None, None), (625, None),
                                               (520, 3)])
def test_cache_aware_partition_matches_jax(emt_cap, cache_cap):
    """Algorithm 1's plan arrays, cache side included: equal (with the
    capacities the serve path uses and a cache too small for every
    group)."""
    _, want, got = _plans(emt_cap, cache_cap)
    for f in ("bank_of_row", "slot_of_row", "rows_per_bank", "load_per_bank",
              "cache_bank_of_entry", "cache_slot_of_entry",
              "cache_rows_per_bank"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert got.imbalance() == want.imbalance()
    if cache_cap is not None:
        assert (got.cache_bank_of_entry < 0).any()     # some groups unplaced


@pytest.mark.parametrize("crpb", [1, 4, 64])
def test_entry_banks_and_cap_match_jax(crpb):
    """``entry_banks``, ``cap_cache_plan`` (drops when a bank is full, pads
    the remaps) and ``entry_member_union``: equal."""
    cp, plan, _ = _plans(625, None)
    for cbank in (plan.cache_bank_of_entry, None):
        want_b = JC.entry_banks(cp, plan.bank_of_row, cbank)
        got_b = TC.entry_banks(cp, plan.bank_of_row, cbank)
        np.testing.assert_array_equal(got_b, want_b)
        assert got_b.dtype == want_b.dtype
    want = JC.cap_cache_plan(cp, want_b, 8, crpb)
    got = TC.cap_cache_plan(cp, got_b, 8, crpb)
    np.testing.assert_array_equal(got.entry_bank, want.entry_bank)
    np.testing.assert_array_equal(got.entry_slot, want.entry_slot)
    assert (got.n_dropped, got.capacity, got.n_entries) == \
        (want.n_dropped, want.capacity, want.n_entries)
    _assert_cache_plans_equal(got.plan, want.plan)
    np.testing.assert_array_equal(TC.entry_member_union(got),
                                  JC.entry_member_union(want))
    if crpb == 1:
        assert got.n_dropped > 0
    empty = TC.cap_cache_plan(TC.empty_cache_plan(), np.zeros(0, np.int32),
                              8, crpb)
    jempty = JC.cap_cache_plan(JC.empty_cache_plan(), np.zeros(0, np.int32),
                               8, crpb)
    np.testing.assert_array_equal(empty.entry_bank, jempty.entry_bank)
    assert TC.entry_member_union(empty).shape == (0,)


def test_rewrite_matches_jax():
    """``rewrite_bag(s)``, ``measure_hit_rate`` and the versioned
    rewriter's ``rewrite_rect``: equal arrays, the same refusal of bags
    longer than the residual budget."""
    bags = _window(n_items=300, n_bags=64)
    cp = JG.mine_cooccurrence(bags, top_items=64, max_groups=16)
    for bag in bags[:16]:
        assert TC.rewrite_bag(bag, cp) == JC.rewrite_bag(bag, cp)
    for kw in (dict(max_cache_per_bag=1, max_residual_per_bag=6),
               dict(max_cache_per_bag=4, max_residual_per_bag=32)):
        for g, w in zip(TC.rewrite_bags(bags, cp, **kw),
                        JC.rewrite_bags(bags, cp, **kw)):
            np.testing.assert_array_equal(g, w)
    assert TC.measure_hit_rate(bags, cp) == JC.measure_hit_rate(bags, cp) > 0
    fcp = JC.cap_cache_plan(cp, np.zeros(cp.n_entries, np.int32), 2, 8)
    rect = np.full((3, 4, 20), -1, np.int32)
    for i, bag in enumerate(bags[:12]):
        rect.reshape(12, 20)[i, :min(20, len(bag))] = bag[:20]
    got_r = TC.VersionedCacheRewriter(max_cache_per_bag=4,
                                      max_residual_per_bag=20)
    want_r = JC.VersionedCacheRewriter(max_cache_per_bag=4,
                                       max_residual_per_bag=20)
    assert got_r.install(fcp, "t0") == want_r.install(fcp, "t0") == 0
    got, want = got_r.rewrite_rect(rect), want_r.rewrite_rect(rect)
    np.testing.assert_array_equal(got.cache_idx, want.cache_idx)
    np.testing.assert_array_equal(got.residual_idx, want.residual_idx)
    assert got.version == want.version == 0
    assert (got.cache_idx >= 0).any()
    got_r.install(fcp, "t1")
    got_r.install(fcp, "t2")
    assert got_r.table_for(2) == "t2" and got_r.plan_for(1) is fcp
    with pytest.raises(KeyError, match="retired"):
        got_r.table_for(0)
    with pytest.raises(ValueError, match="residual overflow"):
        TC.VersionedCacheRewriter(max_cache_per_bag=2,
                                  max_residual_per_bag=8).rewrite_rect(rect)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_build_cache_table_matches_jax(dtype):
    """The partial-sum tables — full-table, fixed from the full rows, and
    fixed from the entry-member rows alone — equal the reference's bit for
    bit in fp32 and in bf16: each entry adds its member rows left to right,
    each add rounded to the rows' dtype, on both sides."""
    bags = _window(n_items=300, n_bags=64)
    cp = JG.mine_cooccurrence(bags, top_items=64, max_groups=16)
    rows = np.random.default_rng(1).standard_normal((300, 12)).astype(
        np.float32)
    if dtype == "float32":
        np.testing.assert_array_equal(TC.build_cache_table(rows, cp),
                                      JC.build_cache_table(rows, cp))
    jrows = np.asarray(jnp.asarray(rows, getattr(jnp, dtype)))
    trows = to_tensor(jrows, "cpu")
    fcp = JC.cap_cache_plan(
        cp, JC.entry_banks(cp, np.arange(300) % 4, None), 4, 12)
    members = JC.entry_member_union(fcp)
    want = JC.build_cache_table_fixed(jrows, fcp, dtype=jrows.dtype)
    want_m = JC.build_cache_table_fixed(jrows[members], fcp,
                                        dtype=jrows.dtype, row_ids=members)
    got = TC.build_cache_table_fixed(trows, fcp, device="cpu")
    got_m = TC.build_cache_table_fixed(trows[torch.from_numpy(members)], fcp,
                                       row_ids=members, device="cpu")
    for g in (got, got_m):
        assert g.packed.dtype == getattr(torch, dtype)
        for w in (want, want_m):
            np.testing.assert_array_equal(_np(g.packed), _np(w.packed))
        np.testing.assert_array_equal(g.remap_bank.numpy(),
                                      np.asarray(want.remap_bank))
        np.testing.assert_array_equal(g.remap_flat.numpy(),
                                      np.asarray(want.flat_remap()))
    assert float(got.packed.float().abs().sum()) > 0


def test_effective_lengths_matches_jax():
    """Count through the last valid entry, interior holes kept, 0 for an
    all-pad bag: equal."""
    rng = np.random.default_rng(2)
    idx = rng.integers(-1, 9, (40, 11)).astype(np.int32)
    idx[3] = -1
    idx[5, 4:] = -1
    idx[6, :10] = -1
    got = TK.effective_lengths(torch.from_numpy(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JK.effective_lengths(jnp.asarray(idx))))
    assert got[3] == 0 and got[5] <= 4 and got[6] == 11


# ---------------------------------------------------------------------------
# the fused lookup: both orders, bit for bit against their references
# ---------------------------------------------------------------------------

def _tables(d, dtype, seed, v=80, nc=24, cache_dtype=None):
    """A 4-bank EMT (a §3.2 plan) and a 2-bank cache table, packed by the
    reference and carried across."""
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    jt = JE.pack_table(table, JP.non_uniform_partition(rng.random(v) + 0.1,
                                                       4),
                       dtype=getattr(jnp, dtype))
    ctab = rng.standard_normal((nc, d)).astype(np.float32)
    jc = JE.pack_table(ctab, JP.uniform_partition(nc, 2),
                       dtype=getattr(jnp, cache_dtype or dtype))
    carry = [banked_table_from_jax(np.asarray(x.packed),
                                   np.asarray(x.remap_bank),
                                   np.asarray(x.remap_slot), x.n_banks,
                                   x.rows_per_bank, "cpu") for x in (jt, jc)]
    return (jt, jc), carry, table, ctab


def _streams(seed, b=16, lc=5, lr=9, v=80, nc=24):
    """-1 padded cache and residual ids: interior holes, short bags,
    all-pad bags, and a row hit by every bag."""
    rng = np.random.default_rng(seed)
    ci = rng.integers(-1, nc, (b, lc)).astype(np.int32)
    ri = rng.integers(-1, v, (b, lr)).astype(np.int32)
    ci[:, 0], ri[:, 1] = 1, 7
    ri[rng.random(ri.shape) < 0.2] = -1
    ci[2], ri[2] = -1, -1                          # an all-pad bag
    ri[4, 3:] = -1                                 # a short one
    ci[5] = -1                                     # residual only
    return ci, ri


def _maps(jt, jc, t, c, my, dead):
    """(bank maps, my) for the reference and the port: the real bank maps,
    or with a dead bank the binary live maps with my = 0."""
    if dead is None:
        return (jt.remap_bank, jc.remap_bank, my), (t.remap_bank,
                                                    c.remap_bank, my)
    live = np.ones(4, bool)
    live[dead] = False
    j = [JE._binary_live_map(x.remap_bank, jnp.asarray(live[:x.n_banks]))
         for x in (jt, jc)]
    p = [TE._binary_live_map(x.remap_bank, torch.from_numpy(live[:x.n_banks]))
         for x in (t, c)]
    return (*j, 0), (*p, 0)


CASES = [(-1, None), (0, None), (2, None), (-1, 1)]    # (my, dead bank)


FUSED_CASES = ([(8, "float32", my, dead) for my, dead in CASES]
               + [(33, "float32", -1, None), (8, "bfloat16", 2, None),
                  (8, "bfloat16", -1, 1)])


@pytest.mark.parametrize("d,dtype,my,dead", FUSED_CASES)
def test_fused_plain_matches_pallas_interpret(d, dtype, my, dead):
    """The kernel's plain version equals the reference's Pallas kernel in
    interpret mode bit for bit, fp32 and bf16: both cast the cache to the
    EMT's dtype, add cache entries then residual rows into one fp32
    accumulator per bag, and cast once. The wrapper takes the plain version
    for CPU tensors and counts no launch."""
    (jt, jc), (t, c), _, _ = _tables(d, dtype, seed=d + my + 10)
    ci, ri = _streams(seed=d + 1, b=8)
    (jeb, jcb, jmy), (teb, tcb, tmy) = _maps(jt, jc, t, c, my, dead)
    want = JK.fused_cache_bag_pallas(
        jt.packed, jc.packed, jeb, jt.flat_remap(), jcb, jc.flat_remap(),
        jnp.asarray([jmy], jnp.int32), jnp.asarray(ci), jnp.asarray(ri),
        tile_b=8, interpret=True)
    args = (t.packed, c.packed, teb, t.remap_flat, tcb, c.remap_flat, tmy,
            torch.from_numpy(ci), torch.from_numpy(ri))
    got = TK.cache_residual_bag_plain(*args)
    assert got.dtype == getattr(torch, dtype) and got.shape == (8, d)
    np.testing.assert_array_equal(_np(got), _np(want))
    n = TK.cache_residual_bag.launches
    np.testing.assert_array_equal(_np(TK.cache_residual_bag(*args)), _np(got))
    assert TK.cache_residual_bag.launches == n
    assert np.abs(_np(got)[2]).sum() == 0          # the all-pad bag


def test_fused_plain_casts_the_cache_to_the_emt_dtype():
    """A bf16 cache beside an fp32 EMT, and the reverse: the cache rows
    are cast to the EMT's dtype before the fp32 walk, as the reference's
    wrapper does; bit for bit against Pallas interpret."""
    for dt, cdt in (("float32", "bfloat16"), ("bfloat16", "float32")):
        (jt, jc), (t, c), _, _ = _tables(8, dt, seed=4, cache_dtype=cdt)
        ci, ri = _streams(seed=5, b=8)
        want = JK.fused_cache_bag_pallas(
            jt.packed, jc.packed, jt.remap_bank, jt.flat_remap(),
            jc.remap_bank, jc.flat_remap(), jnp.asarray([-1], jnp.int32),
            jnp.asarray(ci), jnp.asarray(ri), tile_b=8, interpret=True)
        got = TK.cache_residual_bag_plain(
            t.packed, c.packed, t.remap_bank, t.remap_flat, c.remap_bank,
            c.remap_flat, -1, torch.from_numpy(ci), torch.from_numpy(ri))
        assert got.dtype == getattr(torch, dt)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dead", [None, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_backend_matches_jnp_and_the_fused_order(dtype, dead):
    """``banked_cache_residual_bag(backend='torch')`` equals the
    reference's ``backend='jnp'`` bit for bit (the streams summed apart,
    each cast to its table's dtype, the cache's cast to the EMT's and
    added), with and without a dead bank. The fused order (the kernel's
    plain version, ``'pallas'`` in the reference) differs from it by an fp32
    reordering: within atol 1e-5 in fp32. Also against ``cache_bag_ref``
    (a ``sum`` over each stream, in the reduction order of each framework:
    within atol 1e-5 of the reference's and of the lookup)."""
    (jt, jc), (t, c), table, ctab = _tables(8, dtype, seed=6)
    ci, ri = _streams(seed=7, b=24)
    ci3, ri3 = ci.reshape(4, 6, -1), ri.reshape(4, 6, -1)
    live = None if dead is None else np.array([True, False, True, True])
    jlive = None if live is None else jnp.asarray(live)
    tlive = None if live is None else torch.from_numpy(live)
    want = JE.banked_cache_residual_bag(jt, jc, jnp.asarray(ci3),
                                        jnp.asarray(ri3), None, backend="jnp",
                                        bank_live=jlive)
    got = TE.banked_cache_residual_bag(t, c, torch.from_numpy(ci3),
                                       torch.from_numpy(ri3), backend="torch",
                                       bank_live=tlive)
    assert tuple(got.shape) == (4, 6, 8) and got.dtype == getattr(torch,
                                                                  dtype)
    np.testing.assert_array_equal(_np(got), _np(want))
    auto = TE.banked_cache_residual_bag(t, c, torch.from_numpy(ci3),
                                        torch.from_numpy(ri3),
                                        bank_live=tlive)
    np.testing.assert_array_equal(_np(auto), _np(got))
    if dtype == "float32":
        fused = JE.banked_cache_residual_bag(
            jt, jc, jnp.asarray(ci3), jnp.asarray(ri3), None,
            backend="pallas", bank_live=jlive)
        np.testing.assert_allclose(_np(got), _np(fused), atol=1e-5, rtol=0)
    if dead is None and dtype == "float32":
        ref = TREF.cache_bag_ref(torch.from_numpy(table),
                                 torch.from_numpy(ctab),
                                 torch.from_numpy(ci), torch.from_numpy(ri))
        jref = JREF.cache_bag_ref(jnp.asarray(table), jnp.asarray(ctab),
                                  jnp.asarray(ci), jnp.asarray(ri))
        np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(_np(got).reshape(24, 8), ref.numpy(),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("d,dead", [(8, None), (8, 1), (33, None)])
def test_dual_scatter_grads_match_jax(d, dead):
    """``d_emt`` and ``d_cache`` of a loss ``(out * w).sum()`` equal
    ``jax.grad`` of the reference's ``backend='pallas', bwd_backend=
    'pallas'`` bit for bit (fp32): the same cotangent ``w`` scattered onto
    each table in entry order, j-major then by bag, summed in fp32. (The
    loss is linear so that the cotangent does not depend on the forward's
    summation order: the port's CPU forward is the jnp order.)"""
    (jt, jc), (t, c), _, _ = _tables(d, "float32", seed=d + 20)
    ci, ri = _streams(seed=d + 21, b=8)
    ci3, ri3 = ci.reshape(2, 4, -1), ri.reshape(2, 4, -1)
    live = None if dead is None else np.array([True, False, True, True])
    w = np.random.default_rng(d + 22).standard_normal((2, 4, d)).astype(
        np.float32)

    def jloss(ep, cp):
        out = JE.banked_cache_residual_bag(
            dataclasses.replace(jt, packed=ep),
            dataclasses.replace(jc, packed=cp), jnp.asarray(ci3),
            jnp.asarray(ri3), None, backend="pallas", bwd_backend="pallas",
            bank_live=None if live is None else jnp.asarray(live))
        return (out * jnp.asarray(w)).sum()

    want_e, want_c = jax.grad(jloss, argnums=(0, 1))(jt.packed, jc.packed)
    for bwd in ("auto", "torch"):
        ep = t.packed.clone().requires_grad_(True)
        cp = c.packed.clone().requires_grad_(True)
        out = TE.banked_cache_residual_bag(
            dataclasses.replace(t, packed=ep),
            dataclasses.replace(c, packed=cp), torch.from_numpy(ci3),
            torch.from_numpy(ri3), bwd_backend=bwd,
            bank_live=None if live is None else torch.from_numpy(live))
        assert out.grad_fn is not None
        got_e, got_c = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                           [ep, cp])
        np.testing.assert_array_equal(got_e.numpy(), np.asarray(want_e))
        np.testing.assert_array_equal(got_c.numpy(), np.asarray(want_c))
    assert np.abs(np.asarray(want_c)).sum() > 0


def test_dual_scatter_keeps_each_tables_dtype():
    """A bf16 EMT beside an fp32 cache table: the bf16 cotangent is summed
    in fp32 as it is and cast once to each table's dtype — ``d_cache`` is
    fp32 and equals the reference's ``jax.vjp`` (Pallas forward and
    scatter) bit for bit, as does ``d_emt``. With only the EMT requiring a
    gradient, the cache table gets none."""
    (jt, jc), (t, c), _, _ = _tables(8, "bfloat16", seed=30,
                                     cache_dtype="float32")
    ci, ri = _streams(seed=31, b=8)
    ct = np.random.default_rng(32).standard_normal((8, 8)).astype(
        np.float32)

    def jbag(ep, cp):
        return JE.banked_cache_residual_bag(
            dataclasses.replace(jt, packed=ep),
            dataclasses.replace(jc, packed=cp), jnp.asarray(ci),
            jnp.asarray(ri), None, backend="pallas", bwd_backend="pallas")

    _, vjp = jax.vjp(jbag, jt.packed, jc.packed)
    want_e, want_c = vjp(jnp.asarray(ct, jnp.bfloat16))
    ep = t.packed.clone().requires_grad_(True)
    cp = c.packed.clone().requires_grad_(True)
    out = TE.banked_cache_residual_bag(
        dataclasses.replace(t, packed=ep), dataclasses.replace(c, packed=cp),
        torch.from_numpy(ci), torch.from_numpy(ri))
    got_e, got_c = torch.autograd.grad(
        out, [ep, cp], torch.from_numpy(ct).to(torch.bfloat16))
    assert got_e.dtype == torch.bfloat16 and got_c.dtype == torch.float32
    np.testing.assert_array_equal(_np(got_e), _np(want_e))
    np.testing.assert_array_equal(_np(got_c), _np(want_c))
    out = TE.banked_cache_residual_bag(
        dataclasses.replace(t, packed=ep), c, torch.from_numpy(ci),
        torch.from_numpy(ri))
    (only_e,) = torch.autograd.grad(out.float().sum(), [ep])
    assert only_e.dtype == torch.bfloat16


def test_unported_options_raise():
    (jt, jc), (t, c), _, _ = _tables(8, "float32", seed=1)
    ci_np, ri_np = _streams(seed=2)
    ci, ri = torch.from_numpy(ci_np), torch.from_numpy(ri_np)
    with pytest.raises(NotImplementedError, match="#15"):
        TE.banked_cache_residual_bag(t, c, ci, ri, backend="tuned")
    # with_traffic is ported: the plain call's sums, and the reference's
    # reads and bytes (a cache hit one read on its entry's bank)
    out, traffic = TE.banked_cache_residual_bag(t, c, ci, ri,
                                                with_traffic=True)
    assert torch.equal(out, TE.banked_cache_residual_bag(t, c, ci, ri))
    _, want = JE.banked_cache_residual_bag(
        jt, jc, jnp.asarray(ci_np), jnp.asarray(ri_np), None, backend="jnp",
        with_traffic=True)
    np.testing.assert_array_equal(_np(traffic.reads), np.asarray(want.reads))
    np.testing.assert_array_equal(_np(traffic.nbytes),
                                  np.asarray(want.nbytes))
    with pytest.raises(NotImplementedError, match="#16"):
        TE.banked_cache_residual_bag(t, c, ci, ri, object())
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TE.banked_cache_residual_bag(t, c, ci, ri, backend="cuda")


# ---------------------------------------------------------------------------
# the cached model and serve path
# ---------------------------------------------------------------------------

def _reduced_cached(seed=0, n_req=24):
    """The reduced updlrm-paper config (8 x 500 rows, L = 16, D = 8) under
    a cache-aware plan of a drifting-Zipf window, the reference's weights
    carried across, the cache table built on both sides, and one rewritten
    batch of 6 requests."""
    jcfg, tcfg = jax_get_arch("updlrm-paper").reduced, \
        get_arch("updlrm-paper").reduced
    offs = jcfg.field_offsets()
    traces = [JT.DriftingZipfTrace(JT.DriftConfig(n_items=v, zipf_a=1.2,
                                                  avg_bag=16.0), seed=seed + f)
              for f, v in enumerate(jcfg.vocab_sizes)]
    sp = JT.dlrm_drifting_batch(traces, n_req, jcfg.multi_hot)
    u = np.where(sp >= 0, sp + offs[None, :, None], -1)
    window = [r[r >= 0] for r in u[:-6].reshape(-1, jcfg.multi_hot)]
    cp = JG.mine_cooccurrence(window, top_items=2048, max_groups=256,
                              min_support=2)
    freq = np.bincount(np.concatenate(window),
                       minlength=jcfg.total_vocab).astype(np.float64)
    cap = int(np.ceil(jcfg.total_vocab / 8) * 1.25)
    plan = JP.cache_aware_partition(freq, cp.groups, cp.benefits, 8,
                                    emt_capacity_rows=cap)
    fcp = JC.cap_cache_plan(cp, JC.entry_banks(cp, plan.bank_of_row,
                                               plan.cache_bank_of_entry),
                            8, 16)
    params, statics = JD.init_params(jcfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    jtab = JE.BankedTable(packed=params["emb_packed"],
                          remap_bank=statics["remap_bank"],
                          remap_slot=statics["remap_slot"], n_banks=8,
                          rows_per_bank=cap)
    from repro.workload import unpacked_rows
    jcache = JC.build_cache_table_fixed(np.asarray(unpacked_rows(jtab)), fcp)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    members = JC.entry_member_union(fcp)
    flat = plan.bank_of_row.astype(np.int64)[members] * cap \
        + plan.slot_of_row[members]
    tcache = TC.build_cache_table_fixed(tp["emb_packed"][flat], fcp,
                                        row_ids=members, device="cpu")
    rw = JC.VersionedCacheRewriter(max_cache_per_bag=4,
                                   max_residual_per_bag=16)
    rw.install(fcp, jcache)
    rb = rw.rewrite_rect(u[-6:])
    dense = np.random.default_rng(seed).standard_normal(
        (6, jcfg.n_dense)).astype(np.float32)
    return (jcfg, tcfg, params, statics, tp, ts, jcache, tcache, rb, dense,
            fcp)


def test_forward_cached_matches_jax():
    """Logits of one rewritten batch: within rtol 1e-5 / atol 1e-6 of the
    reference's (its jnp backend; the embedding stage is bit-exact, the
    MLPs and the interaction are fp32 products summed in another order).
    The port's cache table, summed from the entry-member rows alone, equals
    the reference's, summed from the unpacked table. The remap overrides
    give the same logits."""
    (jcfg, tcfg, params, statics, tp, ts, jcache, tcache, rb, dense,
     fcp) = _reduced_cached()
    np.testing.assert_array_equal(tcache.packed.numpy(),
                                  np.asarray(jcache.packed))
    assert fcp.n_entries > 0 and (rb.cache_idx >= 0).any()
    jb = {"dense": jnp.asarray(dense), "cache_idx": jnp.asarray(rb.cache_idx),
          "residual_idx": jnp.asarray(rb.residual_idx)}
    tb = {"dense": torch.from_numpy(dense),
          "cache_idx": torch.from_numpy(rb.cache_idx),
          "residual_idx": torch.from_numpy(rb.residual_idx)}
    want = JD.forward_cached(jcfg, params, statics, jcache, jb,
                             backend="jnp")
    got = TD.forward_cached(tcfg, tp, ts, tcache, tb)
    assert tuple(got.shape) == (6,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCORE_TOL)
    over = TD.forward_cached(tcfg, tp, {**ts, "remap_flat": None}, tcache, tb,
                             remap_bank=ts["remap_bank"],
                             remap_slot=ts["remap_slot"])
    np.testing.assert_array_equal(over.numpy(), got.numpy())
    from repro_torch.serve.serve_step import build_recsys_serve_cached
    scores = build_recsys_serve_cached(TD, tcfg, ts, tcache)(tp, tb)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jax.nn.sigmoid(
        want)), **SCORE_TOL)


def test_run_cached_matches_the_jax_pipeline():
    """``run_cached(device='cpu')`` on the reduced config: its profiling
    window, mined plan, cache-aware plan, capped plan and rewritten last
    batch are equal to what the reference's modules give on the same
    draws (the prototype request first, then 8 profiling requests, then
    the served ones); its scores are finite CTRs."""
    jcfg = jax_get_arch("updlrm-paper").reduced
    spec = get_arch("updlrm-paper")
    res = TSERVE.run_cached(spec, spec.reduced, requests=6, batch=4,
                            device="cpu", profile_requests=8, seed=1)
    offs = jcfg.field_offsets()
    traces = [JT.DriftingZipfTrace(JT.DriftConfig(
        n_items=v, zipf_a=1.2, avg_bag=16.0, rotate_every=0), seed=1 + f)
        for f, v in enumerate(jcfg.vocab_sizes)]
    sp = JT.dlrm_drifting_batch(traces, 1 + 8 + 6, 16)
    u = np.where(sp >= 0, sp + offs[None, :, None], -1)
    window = [r[r >= 0] for r in u[1:9].reshape(-1, 16)]
    cp = JG.mine_cooccurrence(window, top_items=2048, max_groups=256,
                              min_support=2)
    freq = np.bincount(np.concatenate(window),
                       minlength=jcfg.total_vocab).astype(np.float64)
    cap = int(np.ceil(jcfg.total_vocab / 8) * 1.25)
    plan = JP.cache_aware_partition(freq, cp.groups, cp.benefits, 8,
                                    emt_capacity_rows=cap)
    fcp = JC.cap_cache_plan(cp, JC.entry_banks(cp, plan.bank_of_row,
                                               plan.cache_bank_of_entry),
                            8, 16)
    np.testing.assert_array_equal(res.plan.bank_of_row, plan.bank_of_row)
    np.testing.assert_array_equal(res.plan.slot_of_row, plan.slot_of_row)
    np.testing.assert_array_equal(res.fcp.entry_bank, fcp.entry_bank)
    np.testing.assert_array_equal(res.fcp.entry_slot, fcp.entry_slot)
    _assert_cache_plans_equal(res.fcp.plan, fcp.plan)
    # the last batch: requests 4 and 5, padded with the prototype
    np.testing.assert_array_equal(res.last_union,
                                  np.concatenate([u[13:15], u[[0, 0]]]))
    rw = JC.VersionedCacheRewriter(max_cache_per_bag=4,
                                   max_residual_per_bag=16)
    rw.install(fcp, None)
    rb = rw.rewrite_rect(res.last_union)
    np.testing.assert_array_equal(res.last_batch["cache_idx"].numpy(),
                                  rb.cache_idx)
    np.testing.assert_array_equal(res.last_batch["residual_idx"].numpy(),
                                  rb.residual_idx)
    assert tuple(res.scores.shape) == (6,)
    assert bool(((res.scores > 0) & (res.scores < 1)).all())
    st = res.stats
    assert st["mined_groups"] == len(cp.groups)
    assert st["kept_entries"] + st["dropped_entries"] == cp.n_entries
    assert st["hit_rate"] == JC.measure_hit_rate(
        [r[r >= 0] for r in u[9:15].reshape(-1, 16)], fcp.plan)
    assert len(res.host_ms["rewrite"]) == 2 and len(res.latencies) == 6
