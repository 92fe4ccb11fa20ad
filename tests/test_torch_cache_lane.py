"""The port's adaptive cache lane (``--adaptive --partition cache_aware``)
against the JAX package's, on the CPU: Algorithm 1's residual greedy, the
host rewrite, the cached traffic counters, the runtime's versioned GRACE
cache swaps, the cached adaptive serve step, and the whole slice —
``launch.serve.run_cached_adaptive`` against the reference's
``_main_adaptive_cached`` loop driven from its own modules.

Inputs come from numpy seeds; weights are the reference's, carried across
with ``repro_torch.convert``. Planning, mining and rewriting are numpy on
both sides and must give equal arrays; the cache tables and the packed EMT
are held bit for bit, the reads exactly, the scores within rtol 1e-5 /
atol 1e-6 (the MLPs' fp32 order differs; the port's plain bag sums repeat
the reference's jnp order).
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

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
from repro.models import dlrm as JD
from repro.obs import traffic as JTF
from repro.serve import serve_step as JS
from repro.workload import migrate as JMIG
from repro.workload import replanner as JRP
from repro.workload import runtime as JRT
from repro_torch.configs import get_arch
from repro_torch.convert import (banked_table_from_jax, params_from_jax,
                                 statics_from_jax)
from repro_torch.core import cache_runtime as TC
from repro_torch.core import partitioning as TP
from repro_torch.launch import serve as TSERVE
from repro_torch.models import dlrm as TD
from repro_torch.obs import traffic as TTF
from repro_torch.serve import serve_step as TS
from repro_torch.workload import replanner as TRP
from repro_torch.workload import runtime as TRT

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = Path(__file__).resolve().parent.parent


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _zipf_bags(rng, vocab, n, length, a=1.2):
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    p /= p.sum()
    perm = rng.permutation(vocab)
    return [np.unique(perm[rng.choice(vocab, size=length, p=p)])
            for _ in range(n)]


def _assert_cache_plans_equal(a, b):
    assert len(a.groups) == len(b.groups)
    for x, y in zip(a.groups, b.groups):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a.benefits, b.benefits)
    assert [(e.members, e.hits) for e in a.entries] == \
        [(e.members, e.hits) for e in b.entries]
    assert a.entry_of_subset == b.entry_of_subset


def _assert_tables_equal(t, j):
    for f in ("packed", "remap_bank", "remap_slot"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)), err_msg=f)


# ---------------------------------------------------------------------------
# Algorithm 1's residual greedy: the same plans, bit for bit
# ---------------------------------------------------------------------------

def _groups(rng, vocab, n, overlap):
    if overlap:
        # rows shared between groups: later groups re-use placed members
        pool = rng.choice(vocab, size=max(3, n), replace=False)
        return [np.sort(rng.choice(pool, size=rng.integers(2, 4),
                                   replace=False)).astype(np.int64)
                for _ in range(n)]
    rows = rng.choice(vocab, size=3 * n, replace=False)
    return [np.sort(rows[3 * g:3 * g + rng.integers(2, 4)]).astype(np.int64)
            for g in range(n)]


def _case_freq(kind, vocab, rng):
    if kind == "ties":
        # long runs of tied frequencies, the ties broken by row id
        return np.repeat([7.0, 3.0, 1.0, 0.5], -(-vocab // 4))[:vocab]
    if kind == "floor":
        # the sparse telemetry's shape: a head over a count-min floor
        f = np.full(vocab, 2.3125)
        f[rng.choice(vocab, 40, replace=False)] += rng.zipf(1.5, 40)
        return f
    if kind == "zeros":
        return np.zeros(vocab)
    if kind == "float32":
        return (rng.random(vocab) * 100).astype(np.float32)
    return rng.zipf(1.3, vocab).astype(np.float64)


CASES = [
    dict(freq="ties", n_banks=4),
    dict(freq="floor", n_banks=8, emt_cap=80),
    dict(freq="zeros", n_banks=4),
    dict(freq="zipf", n_banks=8, emt_cap=63),       # banks fill mid-run
    dict(freq="zipf", n_banks=5, emt_cap=100, cache_cap=2),
    dict(freq="ties", n_banks=6, emt_cap=84, overlap=True),
    dict(freq="float32", n_banks=3, overlap=True),
    dict(freq="zipf", n_banks=8, emt_cap=500, cache_cap=1, overlap=True),
]


@pytest.mark.parametrize("case", CASES)
def test_cache_aware_partition_matches_jax(case):
    """``bank_of_row``, ``slot_of_row``, ``load_per_bank`` (the accounted
    load, benefits subtracted) and the cache placements equal the
    reference's bit for bit: tied runs, a count-min-floor shape, all
    zeros, capacities that fill banks mid-run, overlapping groups."""
    rng = np.random.default_rng(len(str(case)))
    vocab = 500
    freq = _case_freq(case["freq"], vocab, rng)
    groups = _groups(rng, vocab, 24, case.get("overlap", False))
    benefits = rng.integers(0, 6, len(groups)).astype(np.float64)
    kw = dict(emt_capacity_rows=case.get("emt_cap"),
              cache_capacity_entries=case.get("cache_cap"))
    want = JP.cache_aware_partition(freq, groups, benefits, case["n_banks"],
                                    **kw)
    got = TP.cache_aware_partition(freq, groups, benefits, case["n_banks"],
                                   **kw)
    for f in ("bank_of_row", "slot_of_row", "rows_per_bank", "load_per_bank",
              "cache_bank_of_entry", "cache_slot_of_entry",
              "cache_rows_per_bank"):
        x, y = getattr(got, f), getattr(want, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert got.imbalance() == want.imbalance()
    if case.get("emt_cap"):
        assert got.rows_per_bank.max() <= case["emt_cap"]


def test_cache_aware_partition_refuses_like_jax():
    """A vocab the banks cannot hold raises as the reference does."""
    rng = np.random.default_rng(3)
    freq = rng.random(100)
    groups = _groups(rng, 100, 4, False)
    for mod in (JP, TP):
        with pytest.raises(ValueError, match="EMT capacity exhausted"):
            mod.cache_aware_partition(freq, groups, np.ones(4), 4,
                                      emt_capacity_rows=24)


# ---------------------------------------------------------------------------
# the host rewrite: the same arrays
# ---------------------------------------------------------------------------

def _overlapping_plan(rng, vocab, n):
    """A CachePlan whose groups share rows (the miner never emits one; the
    rewrite must still walk them as ``rewrite_bag`` does)."""
    groups = _groups(rng, vocab, n, True)
    entries, eos = [], {}
    for g in groups:
        for s in JG._subsets([int(x) for x in g]):
            if s not in eos:
                eos[s] = len(entries)
                entries.append(JG.CacheEntry(members=s, hits=1.0))
    return JG.CachePlan(groups=groups, benefits=np.ones(n), entries=entries,
                        entry_of_subset=eos)


@pytest.mark.parametrize("plan_kind", ["mined", "capped", "overlap"])
def test_rewrite_rows_matches_jax(plan_kind):
    """``rewrite_bags`` (through ``rewrite_rows``), ``rewrite_rect`` and
    ``measure_hit_rate`` against the reference's loop on random plans:
    a mined plan, the same capped to a few entries a bank (most groups
    keep no subset), and overlapping groups; cache budgets small enough
    that hits overflow into residual reads, and residual budgets that
    truncate."""
    rng = np.random.default_rng(7)
    vocab = 60 if plan_kind == "overlap" else 400
    bags = _zipf_bags(rng, vocab, 300, 24)
    if plan_kind == "overlap":
        cp = _overlapping_plan(rng, vocab, 12)
    else:
        cp = JG.mine_cooccurrence(bags, top_items=128, max_groups=48,
                                  min_support=2)
    if plan_kind == "capped":
        fcp = JC.cap_cache_plan(cp, rng.integers(0, 4, cp.n_entries), 4, 3)
        assert fcp.n_dropped > 0
        cp = fcp.plan
    assert cp.n_entries > 0
    hits = 0
    for kw in (dict(max_cache_per_bag=1, max_residual_per_bag=8),
               dict(max_cache_per_bag=2, max_residual_per_bag=24),
               dict(max_cache_per_bag=8, max_residual_per_bag=40)):
        got = TC.rewrite_bags(bags, cp, **kw)
        want = JC.rewrite_bags(bags, cp, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        hits += int((got[0] >= 0).sum())
    assert hits > 0
    assert TC.measure_hit_rate(bags, cp) == JC.measure_hit_rate(bags, cp)
    rect = np.full((5, 6, 24), -1, np.int64)
    for i, bag in enumerate(bags[:30]):
        rect.reshape(30, 24)[i, :len(bag)] = bag
    rect[0, 0] = rect[0, 1]                    # duplicate ids in a bag
    rect[0, 0, 3] = rect[0, 0, 1]
    fcp = JC.cap_cache_plan(cp, np.zeros(cp.n_entries, np.int32), 1,
                            cp.n_entries)
    tr = TC.VersionedCacheRewriter(max_cache_per_bag=2,
                                   max_residual_per_bag=24)
    jr = JC.VersionedCacheRewriter(max_cache_per_bag=2,
                                   max_residual_per_bag=24)
    tr.install(fcp, None)
    jr.install(fcp, None)
    g, w = tr.rewrite_rect(rect), jr.rewrite_rect(rect)
    np.testing.assert_array_equal(g.cache_idx, w.cache_idx)
    np.testing.assert_array_equal(g.residual_idx, w.residual_idx)
    assert g.cache_idx.shape == (5, 6, 2)


def test_rewrite_of_empty_plans_and_bags():
    """No groups, no entries, empty bags: all-residual, as the reference."""
    empty = TC.empty_cache_plan()
    bags = [np.array([], np.int64), np.array([3, 1, 3]), np.array([9])]
    for plan in (empty, JC.empty_cache_plan()):
        g = TC.rewrite_bags(bags, plan, max_cache_per_bag=2,
                            max_residual_per_bag=4)
        w = JC.rewrite_bags(bags, plan, max_cache_per_bag=2,
                            max_residual_per_bag=4)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert TC.measure_hit_rate([], empty) == JC.measure_hit_rate([], empty)


def _plan_of_kind(rng, kind, bags, vocab):
    if kind == "overlap":
        return _overlapping_plan(rng, vocab, 12)
    cp = JG.mine_cooccurrence(bags, top_items=128, max_groups=48,
                              min_support=2)
    if kind == "capped":
        cp = JC.cap_cache_plan(cp, rng.integers(0, 4, cp.n_entries), 4,
                               3).plan
    return cp


@pytest.mark.parametrize("plan_kind", ["mined", "capped", "overlap"])
def test_rewrite_bag_matches_jax(plan_kind):
    """``rewrite_bag`` (one bag, through ``SubsetMatcher``) against the
    reference's per-bag loop: bags with repeated ids, with -1 ids (kept in
    the residual, as the reference's set keeps them), empty bags; a
    matcher built once and re-used gives the same lists."""
    rng = np.random.default_rng(17)
    vocab = 60 if plan_kind == "overlap" else 400
    bags = _zipf_bags(rng, vocab, 200, 24)
    cp = _plan_of_kind(rng, plan_kind, bags, vocab)
    odd = [np.concatenate([b, b[:3]]) for b in bags[:20]]
    odd += [np.concatenate([[-1], b, [-1]]) for b in bags[20:40]]
    odd += [np.zeros(0, np.int64), np.array([5, 5, 5])]
    matcher = TC.SubsetMatcher(cp)
    hit = 0
    for bag in bags + odd:
        want = JC.rewrite_bag(bag, cp)
        assert TC.rewrite_bag(bag, cp) == want
        assert matcher.rewrite(bag) == want
        hit += len(want[0]) > 0
    assert hit > 0


@pytest.mark.parametrize("plan_kind", ["mined", "overlap"])
def test_replanner_cached_projection_matches_jax(plan_kind):
    """The replanner's two rewrites of its bag window — the cache-aware
    hysteresis currency ``projected_max_share_cached`` and the hit
    prediction a commit makes — against the reference's on random
    plans."""
    rng = np.random.default_rng(23)
    vocab = 60 if plan_kind == "overlap" else 400
    B = 4
    bags = _zipf_bags(rng, vocab, 160, 24)
    cp = _plan_of_kind(rng, plan_kind, bags, vocab)
    freq = rng.zipf(1.3, vocab).astype(np.float64)
    plan = JP.non_uniform_partition(freq, B)
    fcp = JC.cap_cache_plan(cp, JC.entry_banks(cp, plan.bank_of_row, None),
                            B, 6)
    window = bags + [np.concatenate([[-1], b]) for b in bags[:10]]
    got = TRP.Replanner.projected_max_share_cached(plan, fcp, window)
    assert got == JRP.Replanner.projected_max_share_cached(plan, fcp,
                                                           window)
    kw = dict(capacity_rows=int(np.ceil(vocab / B) * 1.5),
              partitioner="cache_aware", cache_rows_per_bank=6,
              mine_min_support=2)
    jr = JRP.Replanner(JRP.ReplanConfig.for_vocab(vocab, B, **kw), vocab)
    tr = TRP.Replanner(TRP.ReplanConfig.for_vocab(vocab, B, **kw), vocab)
    for r in (jr, tr):
        r.observe_bags(bags)
    a, b = jr.force_replan(), tr.force_replan()
    assert b.cache_fixed.n_entries == a.cache_fixed.n_entries > 0
    assert tr._pred_saved_per_bag == jr._pred_saved_per_bag > 0


def test_cache_lane_runtime_settings_match_the_reference_launchers():
    """``cache_lane_runtime`` and ``bank_capacity``: the replanner config
    and per-bag budgets the reference's ``_main_adaptive_cached`` and
    ``_main_train_cached`` build; one-hot bags refuse."""
    rng = np.random.default_rng(29)
    V, B, slack, entries = 400, 4, 0.25, 30
    cap = TRT.bank_capacity(V, B, slack)
    assert cap == int(np.ceil(V / B) * (1.0 + slack)) == 125
    plan = JP.non_uniform_partition(np.ones(V), B, capacity_rows=cap)
    table = (rng.standard_normal((V, 8)) * 0.01).astype(np.float32)
    jt = JMIG.migrate_table(JE.pack_table(table, plan), plan,
                            rows_per_bank=cap)
    tt = banked_table_from_jax(np.asarray(jt.packed),
                               np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), B, cap, "cpu")
    rt = TRT.cache_lane_runtime(tt, plan, multi_hot=12, replan_every=3,
                                cache_entries=entries, hysteresis=0.05)
    want = JRP.ReplanConfig.for_vocab(
        V, B, capacity_rows=cap, check_every=3, partitioner="cache_aware",
        cache_rows_per_bank=-(-entries // B), mine_min_support=2,
        hysteresis=0.05, telemetry_decay=0.8, telemetry_decay_every=4096)
    got = dataclasses.asdict(rt.replanner.cfg)
    assert {k: got[k] for k in dataclasses.asdict(want)} == \
        dataclasses.asdict(want)
    assert (rt.rewriter.max_cache_per_bag, rt.rewriter.max_residual_per_bag,
            rt.rewriter.keep) == (3, 12, 2)
    assert rt.cache_plan.capacity == B * 8 and rt.cache_plan.n_entries == 0
    with pytest.raises(ValueError, match="multi-hot"):
        TRT.cache_lane_runtime(tt, plan, multi_hot=1, replan_every=3,
                               cache_entries=entries)


# ---------------------------------------------------------------------------
# the cached traffic counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dead", [None, 2])
def test_cached_bank_read_counts_match_jax(dead):
    """A cache hit is one read on its entry's bank, a residual row one on
    its own; both streams honour ``bank_live``. The device counter, its
    host twin and the reference's two agree exactly."""
    rng = np.random.default_rng(11)
    n_banks, V, cap = 4, 300, 32
    entry_bank = rng.integers(0, n_banks, cap).astype(np.int32)
    remap_bank = rng.integers(0, n_banks, V).astype(np.int32)
    ci = rng.integers(-1, cap, (6, 8, 4)).astype(np.int32)
    ri = rng.integers(-1, V, (6, 8, 16)).astype(np.int32)
    live = None
    if dead is not None:
        live = np.ones(n_banks, bool)
        live[dead] = False
    want = JTF.cached_bank_read_counts(
        jnp.asarray(entry_bank), jnp.asarray(ci), jnp.asarray(remap_bank),
        jnp.asarray(ri), n_banks,
        bank_live=None if live is None else jnp.asarray(live))
    got = TTF.cached_bank_read_counts(
        torch.from_numpy(entry_bank), torch.from_numpy(ci),
        torch.from_numpy(remap_bank), torch.from_numpy(ri), n_banks,
        bank_live=None if live is None else torch.from_numpy(live))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    host = TTF.host_cached_bank_read_counts(entry_bank, ci, remap_bank, ri,
                                            n_banks, bank_live=live)
    np.testing.assert_array_equal(host, JTF.host_cached_bank_read_counts(
        entry_bank, ci, remap_bank, ri, n_banks, bank_live=live))
    np.testing.assert_array_equal(host, np.asarray(want))
    if dead is not None:
        assert host[dead] == 0


# ---------------------------------------------------------------------------
# the runtime's cache lane
# ---------------------------------------------------------------------------

def _cache_runtimes(rng, *, partitioner="cache_aware", V=400, D=8, B=4):
    cap = int(np.ceil(V / B) * 1.5)
    plan = JP.non_uniform_partition(np.ones(V), B, capacity_rows=cap)
    table = (rng.standard_normal((V, D)) * 0.01).astype(np.float32)
    jt = JMIG.migrate_table(JE.pack_table(table, plan), plan,
                            rows_per_bank=cap)
    tt = banked_table_from_jax(np.asarray(jt.packed),
                               np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), B, cap, "cpu")
    kw = dict(capacity_rows=cap, check_every=2, min_observations=200,
              partitioner=partitioner, cache_rows_per_bank=4,
              mine_min_support=2)
    lane = dict(max_cache_per_bag=3, max_residual_per_bag=24, cache_keep=2)
    jr = JRT.AdaptiveEmbeddingRuntime(
        jt, plan, JRP.ReplanConfig.for_vocab(V, B, **kw),
        init_freq=np.ones(V), **lane)
    tr = TRT.AdaptiveEmbeddingRuntime(
        tt, plan, TRP.ReplanConfig.for_vocab(V, B, **kw),
        init_freq=np.ones(V), **lane)
    return jr, tr


def _assert_cache_events_equal(a, b):
    assert (a.batch, a.old_imbalance, a.new_imbalance, a.reason,
            a.cache_version, a.cache_entries, a.cache_dropped) == \
        (b.batch, b.old_imbalance, b.new_imbalance, b.reason,
         b.cache_version, b.cache_entries, b.cache_dropped)


def test_runtime_cache_lane_matches_jax():
    """Both runtimes driven by the same ``observe_bags``, ``rewrite`` and
    ``end_batch`` calls: equal SwapEvents (cache fields included), equal
    packed EMTs and cache tables (packed and both remaps) after every swap,
    equal rewrites and versions (a batch rewritten before a swap keeps its
    version and its table), the same realized-hit ratio; version 0 is the
    empty plan; a retired version raises ``KeyError``; the metrics."""
    rng = np.random.default_rng(21)
    jr, tr = _cache_runtimes(rng)
    assert tr.rewriter.version == jr.rewriter.version == 0
    assert tr.cache_plan.n_entries == 0
    _assert_tables_equal(tr.cache_table, jr.cache_table)
    assert tr.cache_table.packed.shape == (16, 8)
    events = hits = 0
    for step in range(16):
        bags = _zipf_bags(rng, 400, 32, 24, a=1.1 + 0.1 * (step // 6))
        jr.observe_bags(bags)
        tr.observe_bags(bags)
        rect = np.full((8, 4, 24), -1, np.int64)
        for i, bag in enumerate(bags):
            rect.reshape(32, 24)[i, :len(bag)] = bag
        g, w = tr.rewrite(rect), jr.rewrite(rect)
        np.testing.assert_array_equal(g.cache_idx, w.cache_idx)
        np.testing.assert_array_equal(g.residual_idx, w.residual_idx)
        assert g.version == w.version
        hits += int((g.cache_idx >= 0).sum())
        a, b = jr.end_batch(), tr.end_batch()
        assert (a is None) == (b is None)
        assert tr.replanner.realized_hit_rate() == \
            jr.replanner.realized_hit_rate()
        if a is None:
            continue
        events += 1
        _assert_cache_events_equal(a, b)
        np.testing.assert_array_equal(_np(tr.table.packed),
                                      np.asarray(jr.table.packed))
        _assert_tables_equal(tr.cache_table, jr.cache_table)
        _assert_cache_plans_equal(tr.cache_plan.plan, jr.cache_plan.plan)
        # the batch rewritten before the swap resolves to its own version
        _assert_tables_equal(tr.cache_table_for(g.version),
                             jr.cache_table_for(w.version))
    assert events >= 2 and tr.rewriter.version == events
    assert tr.cache_plan.n_entries > 0
    assert hits > 0
    with pytest.raises(KeyError, match="retired"):
        tr.cache_table_for(events - 2)
    snap, jsnap = tr.metrics.snapshot(), jr.metrics.snapshot()
    for k in ("runtime.cache_version", "runtime.cache_entries",
              "runtime.cache_dropped_total", "runtime.swaps_total"):
        assert snap[k] == jsnap[k], k

    # the staleness refresh: trained rows re-summed into a new version
    new = np.asarray(jr.table.packed) * 1.5
    jr.table = dataclasses.replace(jr.table, packed=jnp.asarray(new))
    tr.table = dataclasses.replace(tr.table, packed=torch.from_numpy(new))
    assert tr.refresh_cache() == jr.refresh_cache() == events + 1
    _assert_tables_equal(tr.cache_table, jr.cache_table)
    fresh = TC.build_cache_table_fixed(TRT.unpacked_rows(tr.table),
                                       tr.cache_plan, device="cpu")
    _assert_tables_equal(tr.cache_table, fresh)


def test_runtime_rebuild_and_cache_side_plan_match_jax():
    """``rebuild_cache_table`` (Algorithm 1's entry placement), its
    ``_cache_side_plan`` and ``_group_of``: equal to the reference's, on a
    forced cache-aware replan; also with overlapping groups."""
    rng = np.random.default_rng(22)
    jr, tr = _cache_runtimes(rng)
    for _ in range(4):
        bags = _zipf_bags(rng, 400, 48, 24)
        jr.observe_bags(bags)
        tr.observe_bags(bags)
    uj, ut = jr.replanner.force_replan(), tr.replanner.force_replan()
    assert uj.cache_plan.n_entries > 0
    _assert_cache_plans_equal(ut.cache_plan, uj.cache_plan)
    _assert_tables_equal(tr.rebuild_cache_table(ut),
                         jr.rebuild_cache_table(uj))
    for cp in (uj.cache_plan, _overlapping_plan(rng, 400, 10)):
        want = JRT._cache_side_plan(uj.plan, cp, 4)
        got = TRT._cache_side_plan(uj.plan, cp, 4)
        for f in ("bank_of_row", "slot_of_row", "rows_per_bank",
                  "load_per_bank"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        assert [TRT._group_of(cp, e) for e in range(cp.n_entries)] == \
            [JRT._group_of(cp, e) for e in range(cp.n_entries)]
    _assert_cache_events_equal(jr.apply(uj), tr.apply(ut))
    _assert_tables_equal(tr.cache_table, jr.cache_table)


def test_runtime_non_cache_aware_replan_installs_the_empty_plan():
    """With the cache lane on and the §3.2 partitioner, a replan carries no
    cache plan: the swap installs the empty plan as a new version; the
    cache accessors refuse without the lane."""
    rng = np.random.default_rng(23)
    jr, tr = _cache_runtimes(rng, partitioner="non_uniform")
    for _ in range(3):
        rows = np.concatenate(_zipf_bags(rng, 400, 32, 24))
        jr.observe_batch(rows)
        tr.observe_batch(rows)
    a = jr.apply(jr.replanner.force_replan())
    b = tr.apply(tr.replanner.force_replan())
    _assert_cache_events_equal(a, b)
    assert b.cache_version == 1 and b.cache_entries == 0
    _assert_tables_equal(tr.cache_table, jr.cache_table)
    assert not tr.cache_table.packed.any()
    plain = TRT.AdaptiveEmbeddingRuntime(
        tr.table, tr.plan, TRP.ReplanConfig.for_vocab(400, 4,
                                                      capacity_rows=150))
    for call in (lambda: plain.cache_table, plain.refresh_cache,
                 lambda: plain.rewrite(np.zeros((1, 4), np.int64))):
        with pytest.raises(ValueError, match="cache side disabled"):
            call()


# ---------------------------------------------------------------------------
# the cached adaptive serve step
# ---------------------------------------------------------------------------

def test_serve_cached_adaptive_matches_jax():
    """One rewritten batch through ``build_recsys_serve_cached_adaptive``
    with traffic: scores within rtol 1e-5 / atol 1e-6 of the reference's,
    reads equal; the remaps and the cache table are arguments, and the
    cached ``remap_flat`` gives the same scores."""
    rng = np.random.default_rng(31)
    jcfg = jax_get_arch("updlrm-paper").reduced
    tcfg = get_arch("updlrm-paper").reduced
    V, B = jcfg.total_vocab, 8
    cap = int(np.ceil(V / B) * 1.25)
    plan = JP.non_uniform_partition(rng.random(V), B, capacity_rows=cap)
    params, statics = JD.init_params(jcfg, jax.random.key(2), plan=plan,
                                     rows_per_bank=cap)
    offs = jcfg.field_offsets()
    sp = np.stack([np.stack([
        np.sort(rng.choice(40, 16, replace=False)) for _ in range(8)])
        for _ in range(6)]).astype(np.int32)
    sp[rng.random(sp.shape) < 0.1] = -1
    u = np.where(sp >= 0, sp + offs[None, :, None], -1)
    cp = JG.mine_cooccurrence([r[r >= 0] for r in u.reshape(-1, 16)],
                              top_items=256, max_groups=32, min_support=2)
    fcp = JC.cap_cache_plan(cp, JC.entry_banks(cp, plan.bank_of_row, None),
                            B, 8)
    jtab = JE.BankedTable(params["emb_packed"], statics["remap_bank"],
                          statics["remap_slot"], B, cap)
    jcache = JC.build_cache_table_fixed(np.asarray(JRT.unpacked_rows(jtab)),
                                        fcp)
    tcache = banked_table_from_jax(np.asarray(jcache.packed),
                                   np.asarray(jcache.remap_bank),
                                   np.asarray(jcache.remap_slot), B, 8, "cpu")
    rw = JC.VersionedCacheRewriter(max_cache_per_bag=4,
                                   max_residual_per_bag=16)
    rw.install(fcp, jcache)
    rb = rw.rewrite_rect(u)
    assert (rb.cache_idx >= 0).any()
    dense = rng.standard_normal((6, jcfg.n_dense)).astype(np.float32)
    jb = {"dense": jnp.asarray(dense), "cache_idx": jnp.asarray(rb.cache_idx),
          "residual_idx": jnp.asarray(rb.residual_idx)}
    js, jreads = JS.build_recsys_serve_cached_adaptive(
        JD, jcfg, statics, backend="jnp", with_traffic=True)(
        params, statics["remap_bank"], statics["remap_slot"], jcache, jb)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    tb = {"dense": torch.from_numpy(dense),
          "cache_idx": torch.from_numpy(rb.cache_idx),
          "residual_idx": torch.from_numpy(rb.residual_idx)}
    serve = TS.build_recsys_serve_cached_adaptive(TD, tcfg, ts,
                                                  with_traffic=True)
    got, reads = serve(tp, ts["remap_bank"], ts["remap_slot"], tcache, tb)
    np.testing.assert_allclose(_np(got), np.asarray(js), **SCORE_TOL)
    np.testing.assert_array_equal(_np(reads), np.asarray(jreads))
    flat, _ = serve(tp, ts["remap_bank"], ts["remap_slot"], tcache, tb,
                    remap_flat=ts["remap_flat"])
    assert torch.equal(flat, got)
    plain = TS.build_recsys_serve_cached_adaptive(TD, tcfg, ts)(
        tp, ts["remap_bank"], ts["remap_slot"], tcache, tb)
    assert torch.equal(plain, got)


# ---------------------------------------------------------------------------
# the whole slice: run_cached_adaptive against the reference's loop
# ---------------------------------------------------------------------------

def _jax_cached_adaptive(cfg, *, requests, batch, replan_every,
                         drift_rotate_every, seed, banks=8,
                         capacity_slack=0.25, cache_entries=128):
    """The reference's ``launch/serve.py _main_adaptive_cached`` loop, driven
    from the JAX package's modules (jnp backend, no SLO watchdog): returns
    the initial params and, per batch and per swap, what the test
    compares."""
    from repro.workload import (AdaptiveEmbeddingRuntime, DriftConfig,
                                DriftingZipfTrace, ReplanConfig,
                                dlrm_drifting_batch, unpacked_rows)
    mh = cfg.multi_hot
    V = cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    crpb = max(1, -(-cache_entries // banks))
    plan = JP.non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    offs = np.asarray(statics["field_offsets"])
    table = JE.BankedTable(packed=params["emb_packed"],
                           remap_bank=statics["remap_bank"],
                           remap_slot=statics["remap_slot"], n_banks=banks,
                           rows_per_bank=cap)
    rcfg = ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                  check_every=replan_every,
                                  partitioner="cache_aware",
                                  cache_rows_per_bank=crpb,
                                  mine_min_support=2, hysteresis=0.0,
                                  telemetry_decay=0.8,
                                  telemetry_decay_every=4096)
    out = {"scores": [], "reads": [], "rewritten": [], "swaps": []}
    runtime = AdaptiveEmbeddingRuntime(
        table, plan, rcfg, init_freq=np.ones(V),
        max_cache_per_bag=max(2, mh // 4), max_residual_per_bag=mh,
        on_swap=lambda e: out["swaps"].append(
            (e, {"packed": np.asarray(runtime.table.packed),
                 "cache": jax.tree_util.tree_map(np.asarray,
                                                 runtime.cache_table)})))
    serve = jax.jit(JS.build_recsys_serve_cached_adaptive(
        JD, cfg, statics, backend="jnp", with_traffic=True))

    def union_rect(feats):
        sp = np.asarray(feats["sparse"])
        return np.where(sp >= 0, sp + offs[None, :, None], -1)

    def observe(feats, n_real):
        u = union_rect({"sparse": np.asarray(feats["sparse"])[:n_real]})
        runtime.observe_bags([bag[bag >= 0]
                              for bag in u.reshape(-1, u.shape[-1])])

    traces = [DriftingZipfTrace(
        DriftConfig(n_items=v, zipf_a=1.2, avg_bag=float(mh),
                    rotate_every=drift_rotate_every, rotate_frac=0.25),
        seed=seed + f) for f, v in enumerate(cfg.vocab_sizes)]
    rng = np.random.default_rng(seed)

    def one_request(rid):
        sparse = dlrm_drifting_batch(traces, 1, mh)[0]
        return {"dense": rng.standard_normal(cfg.n_dense).astype(np.float32),
                "sparse": sparse}

    mb = JS.MicroBatcher(batch, one_request(-1), observer=observe)
    verify = {}

    def run_batch():
        reqs, feats = mb.next_batch()
        rb = runtime.rewrite(union_rect(feats))
        event = runtime.end_batch()
        if event is not None and "arrays_ok" not in verify:
            rows = unpacked_rows(runtime.table)
            p = runtime.plan
            fresh = np.zeros_like(np.asarray(runtime.table.packed))
            fresh[p.bank_of_row.astype(np.int64) * cap + p.slot_of_row] = rows
            fresh_cache = JC.build_cache_table_fixed(rows, runtime.cache_plan,
                                                     dtype=fresh.dtype)
            ct = runtime.cache_table
            verify.update(
                arrays_ok=bool((np.asarray(runtime.table.packed)
                                == fresh).all()
                               and all((np.asarray(getattr(ct, f))
                                        == np.asarray(getattr(fresh_cache,
                                                              f))).all()
                                       for f in ("packed", "remap_bank",
                                                 "remap_slot"))),
                fresh_cache=fresh_cache, feats=feats,
                rb=runtime.rewrite(union_rect(feats)), table=ct)
        batch_c = {"dense": feats["dense"],
                   "cache_idx": jnp.asarray(rb.cache_idx),
                   "residual_idx": jnp.asarray(rb.residual_idx)}
        p = {**params, "emb_packed": runtime.table.packed}
        scores, reads = serve(p, runtime.table.remap_bank,
                              runtime.table.remap_slot,
                              runtime.cache_table_for(rb.version), batch_c)
        mb.complete(reqs)
        out["scores"].append(np.asarray(scores)[:len(reqs)])
        out["reads"].append(np.asarray(reads))
        out["rewritten"].append((rb.cache_idx, rb.residual_idx, rb.version))

    for rid in range(requests):
        mb.submit(JS.Request(rid=rid, features=one_request(rid)))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    rb = verify["rb"]
    batch_c = {"dense": verify["feats"]["dense"],
               "cache_idx": jnp.asarray(rb.cache_idx),
               "residual_idx": jnp.asarray(rb.residual_idx)}
    p = {**params, "emb_packed": runtime.table.packed}
    t = runtime.table
    swapped, _ = serve(p, t.remap_bank, t.remap_slot, verify["table"],
                       batch_c)
    fresh, _ = serve(p, t.remap_bank, t.remap_slot, verify["fresh_cache"],
                     batch_c)
    out["arrays_ok"] = verify["arrays_ok"]
    out["outputs_ok"] = bool((np.asarray(swapped) == np.asarray(fresh)).all())
    return params, out


def test_run_cached_adaptive_matches_jax_loop(monkeypatch):
    """The whole slice on ``updlrm-paper`` reduced (96 requests at batch 8,
    ``replan_every=2``, the hot set rotating every 24 requests): the same
    swaps at the same batches (cache version, entries, drops), the same
    packed EMT and cache table (packed, ``remap_bank``, ``remap_slot``)
    after each swap, the same rewritten ids and versions per batch —
    including the batch in flight across a swap, served against the
    retired version — the same reads, scores within rtol 1e-5 / atol 1e-6,
    and the first-swap parity checks holding on both sides."""
    kw = dict(requests=96, batch=8, replan_every=2, drift_rotate_every=24,
              seed=1)
    jcfg = jax_get_arch("updlrm-paper").reduced
    jparams, want = _jax_cached_adaptive(jcfg, **kw)
    snaps = []

    class Recording(TRT.AdaptiveEmbeddingRuntime):
        def __init__(self, *a, **k):
            k["on_swap"] = lambda e: snaps.append(
                (e, self.table.packed.clone(), self.cache_table))
            super().__init__(*a, **k)

    monkeypatch.setattr(TRT, "AdaptiveEmbeddingRuntime", Recording)
    spec = get_arch("updlrm-paper")
    res = TSERVE.run_cached_adaptive(
        spec, spec.reduced, device="cpu", backend="torch", min_swaps=1,
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"), **kw)

    assert len(want["swaps"]) >= 2 and len(snaps) == len(want["swaps"])
    assert want["arrays_ok"] and want["outputs_ok"]
    assert res.checks == {"shapes_stable": True, "arrays_ok": True,
                          "outputs_ok": True}
    for (a, ja), (b, packed, cache) in zip(want["swaps"], snaps):
        _assert_cache_events_equal(a, b)
        assert dataclasses.asdict(a.update.report) == \
            dataclasses.asdict(b.update.report)
        np.testing.assert_array_equal(_np(packed), ja["packed"])
        _assert_tables_equal(cache, ja["cache"])
    assert len(res.rewritten) == len(want["rewritten"]) == 12
    in_flight = 0
    for (ci, ri, v), (jci, jri, jv) in zip(res.rewritten, want["rewritten"]):
        np.testing.assert_array_equal(ci, jci)
        np.testing.assert_array_equal(ri, jri)
        assert v == jv
    for e in res.swaps:
        # the batch that triggered the swap was rewritten under the old
        # version and served against it
        assert res.rewritten[e.batch - 1][2] == e.cache_version - 1
        in_flight += int((res.rewritten[e.batch - 1][0] >= 0).any())
    assert in_flight >= 1
    for g, e in zip(res.reads, want["reads"]):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_allclose(_np(res.scores),
                               np.concatenate(want["scores"]), **SCORE_TOL)
    assert res.stats["swaps"] == len(snaps)
    # the served bags' hit rate: reads saved over distinct ids, counted as
    # the reference's runtime counts them (np.unique per bag)
    saved = distinct = 0
    for u, (jci, jri, _) in zip(res.unions, want["rewritten"]):
        n = sum(len(np.unique(row[row >= 0]))
                for row in u.reshape(-1, u.shape[-1]))
        saved += n - int((jci >= 0).sum() + (jri >= 0).sum())
        distinct += n
    assert res.stats["hit_rate"] == saved / distinct
    assert 0 < res.stats["hit_rate"] < 1
    assert len(res.host_ms["cache_install"]) == len(snaps)


def test_run_cached_adaptive_min_swaps_contract():
    """``min_swaps`` unmet raises ``SystemExit``; a lane on one-hot fields
    refuses."""
    spec = get_arch("updlrm-paper")
    with pytest.raises(SystemExit, match="swaps=0"):
        TSERVE.run_cached_adaptive(spec, spec.reduced, requests=16, batch=8,
                                   replan_every=100, min_swaps=1,
                                   device="cpu")
    one_hot = dataclasses.replace(spec.reduced, multi_hot=1)
    with pytest.raises(ValueError, match="multi-hot"):
        TSERVE.run_cached_adaptive(spec, one_hot, requests=8, batch=8,
                                   device="cpu")


def test_serve_cli_runs_the_cache_lane_on_the_cpu():
    """``python -m repro_torch.launch.serve --adaptive --partition
    cache_aware --min-swaps 1 --device cpu`` exits 0 with a swap and the
    parity checks holding."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "updlrm-paper", "--adaptive", "--partition", "cache_aware",
         "--requests", "48", "--batch", "8", "--replan-every", "2",
         "--min-swaps", "1", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[swap @batch" in r.stdout
    assert "swap parity: arrays OK, outputs OK" in r.stdout
