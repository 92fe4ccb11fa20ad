"""The port's hot-row replica lane against the JAX package's, on the CPU:
the replication-aware plans, the packed replicated table, the replica
column hash, the replicated lookup and its gradient, the failover maps and
degraded counts, the traffic counters, the replicated migration, the
replanner's and runtime's replica lane, and the whole slice —
``launch.serve.run_replicated`` against the reference's
``_main_adaptive_replicated`` loop driven from its own modules.

Inputs come from numpy seeds; tables are the reference's, carried across
with ``repro_torch.convert``. Plans are numpy on both sides and must be
equal; bag sums and gradients are summed in fp32 in the same order on every
path and must agree bit for bit (``assert_array_equal``) with the
reference's jnp path and its Pallas kernels in interpret mode; scores
within rtol 1e-5 / atol 1e-6 (the MLPs' fp32 order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.kernels.embedding_bag import ct_scatter_bag_pallas
from repro.kernels.embedding_bag import replica_of_bag as jax_replica_of_bag
from repro.kernels.embedding_bag import wang_hash as jax_wang_hash
from repro.models import dlrm as JD
from repro.obs import traffic as JTF
from repro.serve import serve_step as JS
from repro.workload import migrate as JMIG
from repro.workload import replanner as JRP
from repro.workload import runtime as JRT
from repro_torch.configs import get_arch
from repro_torch.convert import (banked_table_from_jax, params_from_jax,
                                 replicated_table_from_jax)
from repro_torch.core import embedding as TE
from repro_torch.core import partitioning as TP
from repro_torch.kernels import embedding_bag as TK
from repro_torch.launch import serve as TSERVE
from repro_torch.obs import traffic as TTF
from repro_torch.workload import migrate as TMIG
from repro_torch.workload import replanner as TRP
from repro_torch.workload import runtime as TRT

F, PER_FIELD, D, BANKS = 3, 32, 16, 4
V = F * PER_FIELD
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x)


def _assert_plan_equal(a, b):
    assert (a.n_banks, a.k_max) == (b.n_banks, b.k_max)
    for f in ("copies", "bank_of_copy", "slot_of_copy", "rows_per_bank",
              "load_per_bank"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def _setup(k_max, n_hot=2, seed=0):
    """A multi-field table whose first ``n_hot`` rows of every field are
    hot, its single-copy plan and its ``k_max``-copy plan (the hot rows
    replicated), packed by the reference at one pinned capacity."""
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((V, D)) * 0.1).astype(np.float32)
    freq = rng.random(V) + 0.1
    hot = (np.arange(F)[:, None] * PER_FIELD + np.arange(n_hot)).ravel()
    freq[hot] += 50.0
    cap = int(np.ceil((V + hot.size * (k_max - 1)) / BANKS) * 1.3)
    plan = JP.non_uniform_partition(freq, BANKS, capacity_rows=cap)
    copies = np.ones(V, np.int32)
    copies[hot] = k_max
    rplan = JP.replicated_partition(freq, BANKS, copies=copies,
                                    capacity_rows=cap, k_max=k_max)
    jbt = JE.pack_table(table, plan)
    jrt = JE.pack_replicated(table, rplan, rows_per_bank=cap)
    return table, plan, rplan, jbt, jrt, cap


def _ids(b, l, seed=1, n_hot=2):
    """(b, F, l) per-field ids biased to the hot head, with interior -1
    holes, short bags and one all-pad bag."""
    rng = np.random.default_rng(seed)
    idx = np.where(rng.random((b, F, l)) < 0.5,
                   rng.integers(0, n_hot, (b, F, l)),
                   rng.integers(0, PER_FIELD, (b, F, l))).astype(np.int32)
    idx[rng.random(idx.shape) < 0.15] = -1
    lens = rng.integers(0, l + 1, (b, F))
    idx[np.arange(l)[None, None, :] >= lens[..., None]] = -1
    idx[0, 1] = -1
    return idx


def _offsets():
    return np.arange(F, dtype=np.int32) * PER_FIELD


# ---------------------------------------------------------------------------
# plans and the packed table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_max", [2, 3, 4])
@pytest.mark.parametrize("dead", [False, True])
def test_replicated_plans_match_jax(k_max, dead):
    """``choose_replication`` and ``replicated_partition`` give the
    reference's arrays, with a dead (zero-capacity) bank and without."""
    rng = np.random.default_rng(k_max)
    freq = rng.random(V) + 0.1
    freq[[0, 5, 40, 77]] += 30.0
    kw = dict(k_max=k_max, max_r=3)
    copies = TP.choose_replication(freq, BANKS, **kw)
    np.testing.assert_array_equal(copies,
                                  JP.choose_replication(freq, BANKS, **kw))
    gate = np.array([5, 77, 9])
    np.testing.assert_array_equal(
        TP.choose_replication(freq, BANKS, hot_rows=gate, **kw),
        JP.choose_replication(freq, BANKS, hot_rows=gate, **kw))
    caps = np.array([0, 60, 60, 60]) if dead else None
    if dead and k_max > 3:
        copies = np.minimum(copies, 3)
    args = dict(copies=copies, capacity_rows=60, k_max=k_max,
                bank_capacity_rows=caps)
    got = TP.replicated_partition(freq, BANKS, **args)
    _assert_plan_equal(got, JP.replicated_partition(freq, BANKS, **args))
    got.validate()
    assert got.n_replicated == int((copies > 1).sum()) >= 1
    assert got.max_share() == pytest.approx(
        JP.replicated_partition(freq, BANKS, **args).max_share(), abs=0)
    if dead:
        vv, rr = np.nonzero(np.arange(k_max)[None, :] < copies[:, None])
        assert (got.bank_of_copy[vv, rr] != 0).all()


def test_single_copy_plan_is_the_non_uniform_plan():
    rng = np.random.default_rng(1)
    freq = rng.random(200) + 0.1
    rplan = TP.replicated_partition(freq, 4, copies=np.ones(200, np.int32),
                                    k_max=3)
    plan = TP.non_uniform_partition(freq, 4)
    assert rplan.n_replicated == 0
    for r in range(3):
        np.testing.assert_array_equal(rplan.bank_of_copy[:, r],
                                      plan.bank_of_row)
        np.testing.assert_array_equal(rplan.slot_of_copy[:, r],
                                      plan.slot_of_row)
    with pytest.raises(ValueError, match="distinct banks"):
        TP.replicated_partition(freq, 2, copies=np.full(200, 3, np.int32))
    with pytest.raises(ValueError, match="capacity exhausted"):
        TP.replicated_partition(freq, 4, copies=np.ones(200, np.int32),
                                capacity_rows=10)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 3), min_size=1, max_size=60),
       st.integers(1, 5), st.integers(1, 4), st.integers(0, 8),
       st.booleans())
def test_replicated_partition_ties_match_jax(freq, n_banks, k_max, max_r,
                                             capped):
    """Integer frequencies (many ties) and tight capacities: the same plan
    as the reference, or the same refusal."""
    freq = np.asarray(freq, np.float64)
    k = min(k_max, n_banks)
    copies = JP.choose_replication(freq, n_banks, k_max=k, max_r=max_r)
    np.testing.assert_array_equal(
        TP.choose_replication(freq, n_banks, k_max=k, max_r=max_r), copies)
    cap = int(np.ceil(copies.sum() / n_banks)) + (0 if capped else 3)
    try:
        want = JP.replicated_partition(freq, n_banks, copies=copies,
                                       capacity_rows=cap, k_max=k_max)
    except ValueError:
        with pytest.raises(ValueError):
            TP.replicated_partition(freq, n_banks, copies=copies,
                                    capacity_rows=cap, k_max=k_max)
        return
    _assert_plan_equal(TP.replicated_partition(
        freq, n_banks, copies=copies, capacity_rows=cap, k_max=k_max), want)


def test_pack_replicated_matches_jax():
    table, _, rplan, _, jrt, cap = _setup(k_max=4)
    trt = TE.pack_replicated(table, rplan, rows_per_bank=cap, device="cpu")
    for f in ("packed", "remap_bank", "remap_slot"):
        np.testing.assert_array_equal(_np(getattr(trt, f)),
                                      np.asarray(getattr(jrt, f)))
    np.testing.assert_array_equal(_np(trt.remap_flat),
                                  np.asarray(jrt.flat_remap()))
    np.testing.assert_array_equal(_np(trt.bank_flat),
                                  np.asarray(jrt.flat_bank()))
    assert (trt.k_max, trt.n_banks, trt.rows_per_bank, trt.vocab, trt.dim) \
        == (4, BANKS, cap, V, D)
    bf = TE.pack_replicated(table, rplan, rows_per_bank=cap,
                            dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(
        _np(bf.packed), np.asarray(JE.pack_replicated(
            table, rplan, rows_per_bank=cap,
            dtype=jnp.bfloat16).packed.astype(jnp.float32)))
    back = replicated_table_from_jax(jrt, "cpu")
    for f in ("packed", "remap_bank", "remap_slot", "remap_flat"):
        assert torch.equal(getattr(back, f), getattr(trt, f))


# ---------------------------------------------------------------------------
# the replica column
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_max", [1, 2, 3, 4, 7])
def test_replica_columns_match_jax_and_host_twin(k_max):
    ids = np.concatenate([np.arange(4096),
                          2**31 - 1 - np.arange(64),
                          np.random.default_rng(0).integers(0, 2**31, 512)])
    got = TK.replica_of_bag(torch.from_numpy(ids), k_max)
    want = np.asarray(jax_replica_of_bag(jnp.asarray(ids, jnp.int32), k_max))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(
        _np(TK.wang_hash(torch.from_numpy(ids))),
        np.asarray(jax_wang_hash(jnp.asarray(ids, jnp.int32))).astype(
            np.int64))
    np.testing.assert_array_equal(_np(TK.wang_hash(torch.from_numpy(ids))),
                                  TTF._wang_hash_np(ids).astype(np.int64))
    np.testing.assert_array_equal(TTF.host_replica_cols(4096, k_max),
                                  want[:4096])
    np.testing.assert_array_equal(TTF.host_replica_cols(4096, k_max),
                                  JTF.host_replica_cols(4096, k_max))


# ---------------------------------------------------------------------------
# the lookup, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k_max", [1, 3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lookup_matches_jax_jnp_and_pallas(k_max, dtype):
    """The replicated bag sums equal the reference's jnp scan and its
    Pallas kernel (interpret mode) bit for bit, and the single-copy lookup
    (a copy holds its row's values; same per-bag order)."""
    table, plan, rplan, jbt, _, cap = _setup(k_max=max(k_max, 2))
    if k_max == 1:
        rplan = JP.replicated_partition(
            np.ones(V), BANKS, copies=np.ones(V, np.int32), k_max=1)
        plan = JP.non_uniform_partition(np.ones(V), BANKS)
        jbt = JE.pack_table(table, plan, dtype=getattr(jnp, dtype))
    jdt = getattr(jnp, dtype)
    jrt = JE.pack_replicated(table, rplan, rows_per_bank=cap, dtype=jdt)
    trt = replicated_table_from_jax(jrt, "cpu")
    idx = _ids(4, 6)
    fo = _offsets()
    kw = dict(field_offsets=jnp.asarray(fo))
    want = JE.replicated_embedding_bag(jrt, jnp.asarray(idx), None,
                                       backend="jnp", **kw)
    want_p = JE.replicated_embedding_bag(jrt, jnp.asarray(idx), None,
                                         backend="pallas", **kw)
    single = JE.banked_embedding_bag(
        dataclasses.replace(jbt, packed=jbt.packed.astype(jdt)),
        jnp.asarray(idx), None, backend="jnp", **kw)
    got = TE.replicated_embedding_bag(trt, torch.from_numpy(idx),
                                      field_offsets=torch.from_numpy(fo))
    got_t = TE.replicated_embedding_bag(trt, torch.from_numpy(idx),
                                        backend="torch",
                                        field_offsets=torch.from_numpy(fo))
    assert got.shape == (4, F, D) and got.dtype == getattr(torch, dtype)
    for w in (want, want_p, single):
        np.testing.assert_array_equal(_np(got), np.asarray(
            w.astype(jnp.float32)))
    assert torch.equal(got, got_t)
    # the kernel's plain version directly: the (NB, L) stream
    flat = torch.from_numpy(idx.reshape(-1, idx.shape[-1]))
    plain = TK.banked_bag(trt.packed, trt.bank_flat, trt.remap_flat,
                          torch.from_numpy(fo), -1, flat, k_max)
    np.testing.assert_array_equal(_np(plain), _np(got).reshape(-1, D))
    if k_max > 1:
        with pytest.raises(ValueError, match="k_max"):
            TK.banked_bag(trt.packed, trt.bank_flat[:-1], trt.remap_flat,
                          torch.from_numpy(fo), -1, flat, k_max)


def test_lookup_owned_bank_and_refusals():
    """``my >= 0`` through the flattened bank map equals the reference's
    replicated scan; ``dist`` refuses, and the tuned backend on a miss is
    'auto'."""
    _, _, _, _, jrt, _ = _setup(k_max=4)
    trt = replicated_table_from_jax(jrt, "cpu")
    idx = _ids(5, 7, seed=3)
    fo = _offsets()
    flat = idx.reshape(-1, 7)
    for my in (0, 2):
        want = JE._replicated_bag_scan(
            jrt.packed, jnp.asarray(flat), bank_flat=jrt.flat_bank(),
            slot_flat=jrt.flat_remap(), my_bank=jnp.int32(my),
            off=jnp.asarray(fo), k_max=4)
        got = TK.banked_bag_plain(trt.packed, trt.bank_flat, trt.remap_flat,
                                  torch.from_numpy(fo), my,
                                  torch.from_numpy(flat), 4)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
    with pytest.raises(ValueError, match="unsharded-only"):
        TE.replicated_embedding_bag(trt, torch.from_numpy(idx), object())
    from repro_torch.tune.dispatch import DispatchCache, set_cache
    cache = DispatchCache()
    set_cache(cache)
    try:
        assert torch.equal(
            TE.replicated_embedding_bag(trt, torch.from_numpy(idx),
                                        backend="tuned"),
            TE.replicated_embedding_bag(trt, torch.from_numpy(idx)))
    finally:
        set_cache(None)
    assert cache.misses == 1 and cache.hits == 0
    with pytest.raises(ValueError, match="CUDA"):
        TE.replicated_embedding_bag(trt, torch.from_numpy(idx),
                                    backend="cuda")


# ---------------------------------------------------------------------------
# failover maps and degraded counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [(), (1,), (0, 2)])
def test_failover_maps_and_degraded_counts_match_jax(dead):
    table, _, rplan, _, jrt, _ = _setup(k_max=4)
    trt = replicated_table_from_jax(jrt, "cpu")
    live = np.ones(BANKS, bool)
    live[list(dead)] = False
    jb, js = JE._replica_failover_maps(jrt, jnp.asarray(live))
    tb, ts = TE._replica_failover_maps(trt, torch.from_numpy(live))
    np.testing.assert_array_equal(_np(tb), np.asarray(jb))
    np.testing.assert_array_equal(_np(ts), np.asarray(js))
    idx = _ids(6, 5, seed=4)
    fo = _offsets()
    rows = np.where(idx >= 0, idx + fo[None, :, None], -1)
    for per_bag in (False, True):
        want = JE.degraded_row_counts(jrt.remap_bank, jnp.asarray(live),
                                      jnp.asarray(rows), per_bag=per_bag)
        got = TE.degraded_row_counts(trt.remap_bank, torch.from_numpy(live),
                                     torch.from_numpy(rows), per_bag=per_bag)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        # the single-copy (1-D) map counts the same way as the reference
        got1 = TE.degraded_row_counts(trt.remap_bank[:, 0].contiguous(),
                                      torch.from_numpy(live),
                                      torch.from_numpy(rows), per_bag=per_bag)
        want1 = JE.degraded_row_counts(jrt.remap_bank[:, 0],
                                       jnp.asarray(live), jnp.asarray(rows),
                                       per_bag=per_bag)
        np.testing.assert_array_equal(_np(got1), np.asarray(want1))
    j_live = jnp.asarray(live)
    kw = dict(field_offsets=jnp.asarray(fo), bank_live=j_live)
    want = JE.replicated_embedding_bag(jrt, jnp.asarray(idx), None,
                                       backend="jnp", **kw)
    want_p = JE.replicated_embedding_bag(jrt, jnp.asarray(idx), None,
                                         backend="pallas", **kw)
    got = TE.replicated_embedding_bag(trt, torch.from_numpy(idx),
                                      field_offsets=torch.from_numpy(fo),
                                      bank_live=torch.from_numpy(live))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), np.asarray(want_p))
    if not dead:
        plain = TE.replicated_embedding_bag(
            trt, torch.from_numpy(idx), field_offsets=torch.from_numpy(fo))
        assert torch.equal(got, plain)
    # replicated rows always survive one dead bank: only single-copy rows
    # of a dead bank degrade
    homes = [rplan.bank_of_copy[r, :rplan.copies[r]] for r in range(V)]
    no_live = np.array([not live[h].any() for h in homes])
    assert not no_live[rplan.copies > 1].any() or len(dead) > 1
    want_counts = (no_live[np.maximum(rows, 0)] & (rows >= 0)).reshape(
        rows.shape[0], -1).sum(-1)
    np.testing.assert_array_equal(
        _np(TE.degraded_row_counts(trt.remap_bank, torch.from_numpy(live),
                                   torch.from_numpy(rows))), want_counts)


# ---------------------------------------------------------------------------
# the gradient: the copy each bag read gets its cotangent
# ---------------------------------------------------------------------------

def _fold(g, rplan, cap):
    """(banks * cap, D) packed gradient -> (V, D), each row's copies summed
    in copy order (exact for integer cotangents)."""
    out = np.zeros((rplan.vocab, g.shape[-1]), np.float32)
    for v in range(rplan.vocab):
        for r in range(int(rplan.copies[v])):
            out[v] += g[int(rplan.bank_of_copy[v, r]) * cap
                        + int(rplan.slot_of_copy[v, r])]
    return out


@pytest.mark.parametrize("k_max", [3, 4])
def test_gradient_matches_jax_scatter_and_pallas(k_max):
    """A random cotangent: the port's gradient (autograd through the
    lookup, and the scatter directly) equals the reference's
    ``_replicated_scatter_ct`` and its Pallas scatter (interpret mode) bit
    for bit; with bank 1 dead the failover maps route it the same way."""
    _, _, _, _, jrt, _ = _setup(k_max=k_max, seed=k_max)
    trt = replicated_table_from_jax(jrt, "cpu")
    idx = _ids(4, 6, seed=5)
    fo = _offsets()
    rng = np.random.default_rng(6)
    ct = rng.standard_normal((4, F, D)).astype(np.float32)
    flat = idx.reshape(-1, 6)
    for live in (None, np.array([True, False, True, True])):
        if live is None:
            jb, js, my = jrt.flat_bank(), jrt.flat_remap(), -1
        else:
            jb, js = JE._replica_failover_maps(jrt, jnp.asarray(live))
            my = 0
        want = JE._replicated_scatter_ct(
            jrt.packed.shape, jrt.packed.dtype, jb, js, jnp.int32(my),
            jnp.asarray(flat), jnp.asarray(ct.reshape(-1, D)),
            off=jnp.asarray(fo), k_max=k_max)
        want_p = ct_scatter_bag_pallas(
            jnp.asarray(ct.reshape(-1, D)), jnp.asarray(flat), jb, js,
            jnp.asarray(fo), jnp.full((1,), my, jnp.int32),
            jrt.packed.shape[0], jnp.float32, interpret=True, k_max=k_max)
        packed = trt.packed.clone().requires_grad_(True)
        out = TE.replicated_embedding_bag(
            dataclasses.replace(trt, packed=packed), torch.from_numpy(idx),
            field_offsets=torch.from_numpy(fo),
            bank_live=None if live is None else torch.from_numpy(live))
        (g,) = torch.autograd.grad(out, [packed], torch.from_numpy(ct))
        direct = TK.ct_scatter_bag(
            torch.from_numpy(ct.reshape(-1, D)), torch.from_numpy(flat),
            torch.from_numpy(np.array(jb)), torch.from_numpy(
                np.array(js)), torch.from_numpy(fo), my,
            trt.packed.shape[0], k_max=k_max)
        for w in (want, want_p):
            np.testing.assert_array_equal(_np(g), np.asarray(w))
        assert torch.equal(g, direct)


def test_copy_sum_equals_single_copy_gradient():
    """A cotangent of ones: each row's copies sum to the single-copy
    gradient bit for bit, and the hash spread a hot row's gradient over
    more than one copy."""
    table, plan, rplan, jbt, jrt, cap = _setup(k_max=4, seed=7)
    trt = replicated_table_from_jax(jrt, "cpu")
    tbt = banked_table_from_jax(np.asarray(jbt.packed),
                                np.asarray(jbt.remap_bank),
                                np.asarray(jbt.remap_slot), jbt.n_banks,
                                jbt.rows_per_bank, "cpu")
    idx = torch.from_numpy(_ids(8, 6, seed=8))
    fo = torch.from_numpy(_offsets())
    p_r = trt.packed.clone().requires_grad_(True)
    p_s = tbt.packed.clone().requires_grad_(True)
    out_r = TE.replicated_embedding_bag(dataclasses.replace(trt, packed=p_r),
                                        idx, field_offsets=fo)
    out_s = TE.banked_embedding_bag(dataclasses.replace(tbt, packed=p_s),
                                    idx, field_offsets=fo)
    assert torch.equal(out_r, out_s)
    (g_r,) = torch.autograd.grad(out_r.sum(), [p_r])
    (g_s,) = torch.autograd.grad(out_s.sum(), [p_s])
    flat_s = plan.bank_of_row.astype(np.int64) * jbt.rows_per_bank \
        + plan.slot_of_row
    np.testing.assert_array_equal(_fold(_np(g_r), rplan, cap),
                                  _np(g_s)[flat_s])
    touched = max(int((np.abs(_np(g_r)[
        rplan.bank_of_copy[r, :4].astype(np.int64) * cap
        + rplan.slot_of_copy[r, :4]]).sum(-1) > 0).sum())
        for r in np.flatnonzero(rplan.copies > 1))
    assert touched > 1


# ---------------------------------------------------------------------------
# traffic counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [(), (2,)])
def test_traffic_counters_match_jax_and_host_twin(dead):
    _, _, rplan, _, jrt, _ = _setup(k_max=4)
    trt = replicated_table_from_jax(jrt, "cpu")
    idx = _ids(6, 8, seed=9)
    fo = _offsets()
    rows = np.where(idx >= 0, idx + fo[None, :, None], -1)
    live = np.ones(BANKS, bool)
    live[list(dead)] = False
    j_live = jnp.asarray(live) if dead else None
    t_live = torch.from_numpy(live) if dead else None
    want = JTF.replicated_bank_read_counts(jrt.remap_bank, jnp.asarray(rows),
                                           BANKS, k_max=4, bank_live=j_live)
    got = TTF.replicated_bank_read_counts(trt.remap_bank,
                                          torch.from_numpy(rows), BANKS,
                                          k_max=4, bank_live=t_live)
    host = TTF.host_replicated_bank_read_counts(
        rplan.bank_of_copy, rows, BANKS, k_max=4,
        bank_live=live if dead else None)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    np.testing.assert_array_equal(_np(got), host)
    np.testing.assert_array_equal(host, JTF.host_replicated_bank_read_counts(
        rplan.bank_of_copy, rows, BANKS, k_max=4,
        bank_live=live if dead else None))
    assert got.dtype == torch.int32
    _, traffic = TE.replicated_embedding_bag(
        trt, torch.from_numpy(idx), field_offsets=torch.from_numpy(fo),
        bank_live=t_live, with_traffic=True)
    _, j_traffic = JE.replicated_embedding_bag(
        jrt, jnp.asarray(idx), None, backend="jnp",
        field_offsets=jnp.asarray(fo), bank_live=j_live, with_traffic=True)
    np.testing.assert_array_equal(_np(traffic.reads),
                                  np.asarray(j_traffic.reads))
    np.testing.assert_array_equal(_np(traffic.nbytes),
                                  np.asarray(j_traffic.nbytes))


# ---------------------------------------------------------------------------
# migration, the replanner's and the runtime's replica lane
# ---------------------------------------------------------------------------

def test_migrate_replicated_matches_pack_and_jax():
    table, plan, rplan, jbt, _, cap = _setup(k_max=3, seed=11)
    jbase = JMIG.migrate_table(jbt, plan, rows_per_bank=cap)
    tbase = banked_table_from_jax(np.asarray(jbase.packed),
                                  np.asarray(jbase.remap_bank),
                                  np.asarray(jbase.remap_slot), BANKS, cap,
                                  "cpu")
    got = TMIG.migrate_replicated(tbase, rplan, rows_per_bank=cap)
    want = JMIG.migrate_replicated(jbase, rplan, rows_per_bank=cap)
    fresh = TE.pack_replicated(table, rplan, rows_per_bank=cap, device="cpu")
    for f in ("packed", "remap_bank", "remap_slot"):
        np.testing.assert_array_equal(_np(getattr(got, f)),
                                      np.asarray(getattr(want, f)))
        assert torch.equal(getattr(got, f), getattr(fresh, f))
    assert got.k_max == 3 and got.rows_per_bank == cap
    with pytest.raises(ValueError, match="rows_per_bank"):
        TMIG.migrate_replicated(tbase, rplan, rows_per_bank=1)


def test_replanner_builds_the_reference_replica_plans():
    """``build_replica_plan`` as the reference: k_eff clamped to the live
    banks, max_r clamped by headroom, the tier gate, k_max pinned."""
    rng = np.random.default_rng(12)
    freq = rng.random(V) + 0.1
    freq[[1, 33, 70]] += 40.0
    for kw in (dict(replicate_k_max=3, replicate_max_r=8),
               dict(replicate_k_max=4, replicate_max_r=2),
               dict(replicate_k_max=4, replicate_max_r=64,
                    capacity_rows=V // BANKS + 1)):
        kw = {"capacity_rows": 40, **kw}
        jr = JRP.Replanner(JRP.ReplanConfig(n_banks=BANKS, **kw), V)
        tr = TRP.Replanner(TRP.ReplanConfig(n_banks=BANKS, **kw), V)
        _assert_plan_equal(tr.build_replica_plan(freq),
                           jr.build_replica_plan(freq))
        tiers = (np.arange(V) % 3).astype(np.int32)
        _assert_plan_equal(tr.build_replica_plan(freq, tiers),
                           jr.build_replica_plan(freq, tiers))
    # dead banks: no capacity there, and k_eff clamps to the live banks
    for live in ([True, False, True, True], [True, False, True, False]):
        kw = dict(n_banks=BANKS, capacity_rows=60, replicate_k_max=4)
        jr = JRP.Replanner(JRP.ReplanConfig(**kw), V)
        tr = TRP.Replanner(TRP.ReplanConfig(**kw), V)
        jr.set_bank_health(np.array(live))
        tr.set_bank_health(np.array(live))
        got = tr.build_replica_plan(freq)
        _assert_plan_equal(got, jr.build_replica_plan(freq))
        assert got.k_max == 4 and got.copies.max() == min(4, sum(live))
        assert got.rows_per_bank[1] == 0
    assert TRP.Replanner(TRP.ReplanConfig(n_banks=BANKS), V
                         ).build_replica_plan(freq) is None


def _runtimes(rng, k_max=3, v=400, d=16, banks=4):
    cap = int(np.ceil(v / banks) * 1.5)
    table = (rng.standard_normal((v, d)) * 0.01).astype(np.float32)
    f0 = rng.random(v) + 0.1
    f0[:4] += 400.0                      # a head hot enough to replicate
    plan = JP.non_uniform_partition(f0, banks, capacity_rows=cap)
    jt = JMIG.migrate_table(JE.pack_table(table, plan), plan,
                            rows_per_bank=cap)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), banks, cap, "cpu")
    kw = dict(capacity_rows=cap, check_every=2, replicate_k_max=k_max,
              replicate_max_r=8)
    jr = JRT.AdaptiveEmbeddingRuntime(
        jt, plan, JRP.ReplanConfig.for_vocab(v, banks, **kw), init_freq=f0)
    tr = TRT.AdaptiveEmbeddingRuntime(
        tt, plan, TRP.ReplanConfig.for_vocab(v, banks, **kw), init_freq=f0)
    return jr, tr


def _assert_replicated_equal(t_pair, j_pair):
    _assert_plan_equal(t_pair[0], j_pair[0])
    for f in ("packed", "remap_bank", "remap_slot"):
        np.testing.assert_array_equal(_np(getattr(t_pair[1], f)),
                                      np.asarray(getattr(j_pair[1], f)))


def _assert_event_equal(a, b):
    assert (a.batch, a.old_imbalance, a.new_imbalance, a.reason,
            a.replica_version, a.replica_hot_rows, a.replica_copy_churn) == \
        (b.batch, b.old_imbalance, b.new_imbalance, b.reason,
         b.replica_version, b.replica_hot_rows, b.replica_copy_churn)


def test_runtime_replica_lane_matches_jax():
    """Version 0 from the initial frequencies, drift-driven swaps, the
    bank-failure and straggler lanes: equal SwapEvents, base tables and
    replicated (plan, table) pairs; retired versions raise KeyError; the
    swapped table equals a fresh pack of the migrated rows; the metrics
    follow the lane."""
    rng = np.random.default_rng(13)
    jr, tr = _runtimes(rng)
    assert tr.replica_version == jr.replica_version == 0
    _assert_replicated_equal(tr.replicated, jr.replicated)
    assert tr.replicated[0].n_replicated >= 1
    rtable0 = tr.replicated[1]
    events = 0
    for t in range(20):
        rows = rng.integers(200, 400, size=(256,)) if t < 10 else \
            np.minimum(rng.zipf(1.5, size=(256,)) + 100, 399)
        jr.observe_batch(rows)
        tr.observe_batch(rows)
        a, b = jr.end_batch(), tr.end_batch()
        assert (a is None) == (b is None)
        if a is not None:
            events += 1
            _assert_event_equal(a, b)
            np.testing.assert_array_equal(_np(tr.table.packed),
                                          np.asarray(jr.table.packed))
            _assert_replicated_equal(tr.replicated, jr.replicated)
    assert events >= 2 and tr.replica_version == events
    assert tr.replicated_for(tr.replica_version) is tr.replicated
    with pytest.raises(KeyError, match="retired"):
        tr.replicated_for(0)
    _assert_replicated_equal(tr.replicated_for(events - 1),
                             jr.replicated_for(events - 1))
    rplan, rtable = tr.replicated
    fresh = TE.pack_replicated(TRT.unpacked_rows(tr.table), rplan,
                               rows_per_bank=rtable.rows_per_bank,
                               device="cpu")
    for f in ("packed", "remap_bank", "remap_slot", "remap_flat",
              "bank_flat"):
        assert torch.equal(getattr(rtable, f), getattr(fresh, f))
        assert getattr(rtable, f).shape == getattr(rtable0, f).shape
    live = np.array([True, True, False, True])
    a, b = jr.on_bank_failure(live), tr.on_bank_failure(live)
    _assert_event_equal(a, b)
    _assert_replicated_equal(tr.replicated, jr.replicated)
    pen = np.array([1.0, 2.5, 1.0, 1.0])
    _assert_event_equal(jr.on_straggler(pen), tr.on_straggler(pen))
    _assert_replicated_equal(tr.replicated, jr.replicated)
    snap, jsnap = tr.metrics.snapshot(), jr.metrics.snapshot()
    for k in ("runtime.replica_version", "runtime.replica_hot_rows",
              "runtime.replica_copy_churn_total", "runtime.swaps_total"):
        assert snap[k] == jsnap[k]


def test_replica_lane_off_and_guards():
    rng = np.random.default_rng(14)
    plan = TP.non_uniform_partition(np.ones(100), 2)
    bt = TE.pack_table((rng.standard_normal((100, 8)) * 0.01)
                       .astype(np.float32), plan, device="cpu")
    rt = TRT.AdaptiveEmbeddingRuntime(bt, plan,
                                      TRP.ReplanConfig.for_vocab(100, 2))
    assert rt.replica_version is None
    with pytest.raises(ValueError, match="replica lane disabled"):
        rt.replicated
    with pytest.raises(ValueError, match="non_uniform"):
        TRP.Replanner(TRP.ReplanConfig(n_banks=4, partitioner="cache_aware",
                                       replicate_k_max=2), 100)
    with pytest.raises(ValueError, match="replicate_k_max"):
        TRP.Replanner(TRP.ReplanConfig(n_banks=2, replicate_k_max=4), 100)


# ---------------------------------------------------------------------------
# the serve step and the whole slice
# ---------------------------------------------------------------------------

def _jax_replicated(cfg, *, k_max, requests, batch, replan_every,
                    drift_rotate_every, seed, banks=8, capacity_slack=0.25):
    """The reference's ``_main_adaptive_replicated`` loop driven from its
    own modules (jnp backend): the initial params and, per batch and per
    swap, what the test compares."""
    from repro.workload import (AdaptiveEmbeddingRuntime, DriftConfig,
                                DriftingZipfTrace, ReplanConfig,
                                dlrm_drifting_batch, rows_from_sparse)
    V_ = cfg.total_vocab
    cap = int(np.ceil(V_ / banks) * (1.0 + capacity_slack))
    plan = JP.non_uniform_partition(np.ones(V_), banks, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    offs = np.asarray(statics["field_offsets"])
    table = JE.BankedTable(packed=params["emb_packed"],
                           remap_bank=statics["remap_bank"],
                           remap_slot=statics["remap_slot"], n_banks=banks,
                           rows_per_bank=cap)
    rcfg = ReplanConfig.for_vocab(V_, banks, capacity_rows=cap,
                                  check_every=replan_every,
                                  replicate_k_max=k_max, replicate_max_r=64)
    runtime = AdaptiveEmbeddingRuntime(table, plan, rcfg,
                                       init_freq=np.ones(V_))
    serve = jax.jit(JS.build_recsys_serve_replicated_adaptive(
        JD, cfg, statics, backend="jnp", with_traffic=True))
    all_live = jnp.ones(banks, dtype=bool)

    def observe(feats, n_real):
        sp = np.asarray(feats["sparse"])[:n_real]
        runtime.observe_batch(rows_from_sparse(sp, offs))

    traces = [DriftingZipfTrace(
        DriftConfig(n_items=v, zipf_a=2.0, avg_bag=float(cfg.multi_hot),
                    rotate_every=drift_rotate_every, rotate_frac=0.25),
        seed=seed + f) for f, v in enumerate(cfg.vocab_sizes)]
    rng = np.random.default_rng(seed)

    def one_request():
        sparse = dlrm_drifting_batch(traces, 1, cfg.multi_hot)[0]
        return {"dense": rng.standard_normal(cfg.n_dense).astype(np.float32),
                "sparse": sparse}

    mb = JS.MicroBatcher(batch, one_request(), observer=observe)
    out = {"scores": [], "reads": [], "counts": [], "swaps": []}

    def run_batch():
        reqs, feats = mb.next_batch()
        p = {**params, "emb_packed": runtime.table.packed}
        scores, counts, reads = serve(p, runtime.replicated[1], all_live,
                                      feats)
        mb.complete(reqs)
        out["scores"].append(np.asarray(scores)[:len(reqs)])
        out["reads"].append(np.asarray(reads))
        out["counts"].append(np.asarray(counts))
        event = runtime.end_batch()
        if event is not None:
            rplan, rtable = runtime.replicated
            out["swaps"].append((event, np.asarray(runtime.table.packed),
                                 (rplan, jax.tree.map(np.asarray, rtable))))

    for rid in range(requests):
        mb.submit(JS.Request(rid=rid, features=one_request()))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    return params, out


def test_replicated_serve_step_matches_jax():
    """The serve step over a replicated table with a dead bank: scores
    within rtol 1e-5 / atol 1e-6, degraded counts and reads equal."""
    jcfg = jax_get_arch("updlrm-paper").reduced
    spec = get_arch("updlrm-paper")
    V_ = jcfg.total_vocab
    cap = int(np.ceil(V_ / 8) * 1.25)
    freq = np.random.default_rng(15).random(V_) + 0.1
    freq[::500] += 400.0
    plan = JP.non_uniform_partition(freq, 8, capacity_rows=cap)
    jp, js = JD.init_params(jcfg, jax.random.key(2), plan=plan,
                            rows_per_bank=cap)
    copies = JP.choose_replication(freq, 8, k_max=4)
    rplan = JP.replicated_partition(freq, 8, copies=copies,
                                    capacity_rows=cap, k_max=4)
    rows = np.asarray(jp["emb_packed"])[
        plan.bank_of_row.astype(np.int64) * cap + plan.slot_of_row]
    jrt = JE.pack_replicated(rows, rplan, rows_per_bank=cap)
    rng = np.random.default_rng(16)
    sparse = rng.integers(0, 500, (4, 8, 16)).astype(np.int32)
    sparse[rng.random(sparse.shape) < 0.3] = -1
    sparse[:, :, :3] = 0                            # the replicated rows
    dense = rng.standard_normal((4, 13)).astype(np.float32)
    live = np.ones(8, bool)
    live[3] = False
    want = JS.build_recsys_serve_replicated_adaptive(
        JD, jcfg, js, backend="jnp", with_traffic=True)(
        jp, jrt, jnp.asarray(live), {"dense": jnp.asarray(dense),
                                     "sparse": jnp.asarray(sparse)})
    from repro_torch.convert import statics_from_jax
    from repro_torch.models import dlrm as TD
    from repro_torch.serve import serve_step as TS
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    ts = statics_from_jax(jax.tree.map(np.asarray, js), "cpu")
    got = TS.build_recsys_serve_replicated_adaptive(
        TD, spec.reduced, ts, with_traffic=True)(
        tp, replicated_table_from_jax(jrt, "cpu"), torch.from_numpy(live),
        {"dense": torch.from_numpy(dense), "sparse": torch.from_numpy(sparse)})
    np.testing.assert_allclose(_np(got[0]), np.asarray(want[0]), **SCORE_TOL)
    np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(_np(got[2]), np.asarray(want[2]))
    assert int(got[1].sum()) > 0


def test_run_replicated_matches_jax_loop(monkeypatch):
    """The whole slice on ``updlrm-paper`` reduced, ``k_max=4``,
    ``replan_every=2``: the same SwapEvents (batch, imbalances, replica
    version, replicated rows, churn), the same base and replicated tables
    after each swap, the same per-batch reads, no degraded read, scores
    within rtol 1e-5 / atol 1e-6; at least one swap, shapes stable, the
    re-pack parity held."""
    kw = dict(k_max=4, requests=96, batch=8, replan_every=2,
              drift_rotate_every=24, seed=1)
    jcfg = jax_get_arch("updlrm-paper").reduced
    jparams, want = _jax_replicated(jcfg, **kw)
    snaps = []

    class Recording(TRT.AdaptiveEmbeddingRuntime):
        def __init__(self, *a, **k):
            k["on_swap"] = lambda e: snaps.append(
                (e, self.table.packed.clone(), self.replicated))
            super().__init__(*a, **k)

    monkeypatch.setattr(TSERVE, "AdaptiveEmbeddingRuntime", Recording)
    spec = get_arch("updlrm-paper")
    res = TSERVE.run_replicated(
        spec, spec.reduced, device="cpu", backend="torch", min_swaps=1,
        params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        **kw)
    assert len(want["swaps"]) >= 1 and len(snaps) == len(want["swaps"])
    assert res.checks == {"shapes_stable": True, "repack_ok": True}
    for (a, jpacked, jpair), (b, tpacked, tpair) in zip(want["swaps"], snaps):
        _assert_event_equal(a, b)
        assert dataclasses.asdict(a.update.report) == \
            dataclasses.asdict(b.update.report)
        np.testing.assert_array_equal(_np(tpacked), jpacked)
        _assert_replicated_equal(tpair, jpair)
    assert snaps[0][0].replica_hot_rows >= 1
    assert all((c == 0).all() for c in want["counts"])
    assert len(res.reads) == len(want["reads"])
    for g, e in zip(res.reads, want["reads"]):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_allclose(_np(res.scores),
                               np.concatenate(want["scores"]), **SCORE_TOL)
    st_ = res.stats
    assert st_["swaps"] == len(snaps) and st_["k_max"] == 4
    assert st_["replicated_rows"] == res.runtime.replicated[0].n_replicated
    assert st_["modeled_max_share"] == res.runtime.replicated[0].max_share()
    assert len(res.host_ms["replica_plan"]) == len(snaps)
