"""The port's adaptive loop against the JAX package's, on the CPU: the
metrics registry and tracer, telemetry and drift reports, the replanner's
plans, tier maps and hysteresis skips, the live migration, the runtime's
tier lane, the adaptive serve steps, and the whole slice —
``launch.serve.run_adaptive`` against the reference's ``_main_adaptive``
loop driven from its own modules.

Inputs come from numpy seeds; weights are the reference's, carried across
with ``repro_torch.convert``. Telemetry, planning and tiering are numpy on
both sides and must give equal values; the lookups are held bit for bit
(the port's plain versions repeat the reference's jnp order), the scores
within rtol 1e-5 / atol 1e-6 (the MLPs' fp32 order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.models import dlrm as JD
from repro.obs import metrics as JM
from repro.obs import tracing as JTR
from repro.obs import traffic as JTF
from repro.quant import QuantSpec as JQuantSpec
from repro.serve import serve_step as JS
from repro.workload import migrate as JMIG
from repro.workload import replanner as JRP
from repro.workload import runtime as JRT
from repro.workload import telemetry as JTEL
from repro_torch.configs import get_arch
from repro_torch.convert import (banked_table_from_jax, params_from_jax,
                                 tiered_table_from_jax)
from repro_torch.core import embedding as TE
from repro_torch.core import partitioning as TP
from repro_torch.launch import serve as TSERVE
from repro_torch.models import dlrm as TD
from repro_torch.obs import metrics as TM
from repro_torch.obs import tracing as TTR
from repro_torch.obs import traffic as TTF
from repro_torch.quant import QuantSpec as TQuantSpec
from repro_torch.serve import serve_step as TS
from repro_torch.workload import migrate as TMIG
from repro_torch.workload import replanner as TRP
from repro_torch.workload import runtime as TRT
from repro_torch.workload import telemetry as TTEL

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _zipf_rows(rng, vocab, n, a=1.1):
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    return rng.choice(vocab, size=n, p=p / p.sum())


# ---------------------------------------------------------------------------
# metrics registry and tracer: the same documents
# ---------------------------------------------------------------------------

def _drive_metrics(mod):
    reg = mod.MetricRegistry()
    c = reg.counter("a.total", "help")
    c.inc()
    c.inc(2.5)
    reg.gauge("b.gauge").set(0.75)
    h = reg.histogram("c.ms")
    for v in (0.01, 0.5, 3.0, 3.0, 77.0, 1e4):
        h.observe(v)
    h2 = mod.Histogram("other")
    h2.observe(2.0)
    h.merge(h2)
    reg.vector_counter("d.reads", size=4).inc([1, 0, 2, 5])
    reg.vector_gauge("e.depth", size=3).set([3, 1, 2])
    with pytest.raises(TypeError):
        reg.gauge("a.total")
    with pytest.raises(ValueError):
        c.inc(-1)
    return reg, h


def test_metrics_registry_matches_jax():
    """Same operations -> the same snapshot document and quantiles."""
    jreg, jh = _drive_metrics(JM)
    treg, th = _drive_metrics(TM)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.to_json() == jreg.to_json()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert th.quantile(q) == jh.quantile(q)
    xs = [5.0, 1.0, 3.0, 9.0, 7.0]
    for q in (0.5, 0.99):
        assert TM.empirical_percentile(xs, q) == JM.empirical_percentile(xs, q)


def test_tracer_records_like_jax():
    """Spans nest with depth, instants and counters are recorded; a
    disabled tracer records nothing."""
    for mod in (JTR, TTR):
        tr = mod.Tracer()
        with tr.span("outer", batch=1):
            with tr.span("inner"):
                pass
        tr.instant("swap_live", batch=3)
        tr.counter("bank_reads", bank0=2, bank1=5)
        assert [(r.name, r.depth) for r in tr.records] == [("inner", 1),
                                                           ("outer", 0)]
        assert tr.records[1].args == {"batch": 1}
        assert tr.instants[0].args == {"batch": 3}
        assert tr.counters[0].values == {"bank0": 2.0, "bank1": 5.0}
        assert tr.span_names() == {"inner", "outer"}
        with mod.NULL_TRACER.span("x"):
            mod.NULL_TRACER.instant("y")
        assert not mod.NULL_TRACER.records and not mod.NULL_TRACER.instants


# ---------------------------------------------------------------------------
# telemetry and drift: equal state and reports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("budget", [64, 4096])
def test_telemetry_state_matches_jax(budget):
    """CountMinSketch table, space-saving head (with and without
    evictions), decayed counters, freq vector and freq_on: equal."""
    rng = np.random.default_rng(budget)
    vocab = 3000
    kw = dict(topk_budget=budget, sketch_width=256, decay=0.8,
              decay_every=700, seed=5)
    jt, tt = JTEL.TableTelemetry(vocab, **kw), TTEL.TableTelemetry(vocab, **kw)
    for _ in range(6):
        rows = _zipf_rows(rng, vocab, 400)
        rows[rng.random(400) < 0.05] = -1
        jt.observe(rows)
        tt.observe(rows)
    np.testing.assert_array_equal(tt.sketch.table, jt.sketch.table)
    assert tt.sketch.total == jt.sketch.total
    assert tt.head.counts == jt.head.counts
    assert tt.head.evictions == jt.head.evictions
    assert tt.n_observed == jt.n_observed
    np.testing.assert_array_equal(tt.topk(50), jt.topk(50))
    np.testing.assert_array_equal(tt.freq_vector(), jt.freq_vector())
    ids = rng.integers(0, vocab, 40)
    np.testing.assert_array_equal(tt.freq_on(ids), jt.freq_on(ids))
    bags = [rng.integers(0, vocab, 9) for _ in range(5)]
    jt.observe_bags(bags)
    tt.observe_bags(bags)
    np.testing.assert_array_equal(tt.freq_vector(), jt.freq_vector())


@pytest.mark.parametrize("sparse_above", [10_000_000, 100])
def test_drift_reports_match_jax(sparse_above):
    """DriftReports of the dense check and of the top-K-union check (the
    path a vocab past ``sparse_above`` takes): equal, drifted or not."""
    rng = np.random.default_rng(7)
    vocab = 2000
    ref = np.ones(vocab)
    jd = JTEL.DriftDetector(ref, k=64, min_observations=500,
                            sparse_above=sparse_above)
    td = TTEL.DriftDetector(ref, k=64, min_observations=500,
                            sparse_above=sparse_above)
    jt, tt = JTEL.TableTelemetry(vocab), TTEL.TableTelemetry(vocab)
    reports = []
    for step in range(4):
        rows = _zipf_rows(rng, vocab, 300)
        jt.observe(rows)
        tt.observe(rows)
        a, b = jd.check(jt), td.check(tt)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert str(a) == str(b)
        reports.append(b.drifted)
        if step == 2:
            jd.rebase(jt.freq_vector())
            td.rebase(tt.freq_vector())
    assert not reports[0] and reports[2]
    np.testing.assert_array_equal(
        TTEL.rows_from_sparse(np.array([[[1, -1], [0, 2]]]), np.array([0, 9])),
        JTEL.rows_from_sparse(np.array([[[1, -1], [0, 2]]]), np.array([0, 9])))


# ---------------------------------------------------------------------------
# the replanner: equal plans, tier maps and skips
# ---------------------------------------------------------------------------

def _plan_arrays(plan):
    return (plan.bank_of_row, plan.slot_of_row, plan.rows_per_bank,
            plan.load_per_bank)


def _assert_update_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    for x, y in zip(_plan_arrays(a.plan), _plan_arrays(b.plan)):
        np.testing.assert_array_equal(y, x)
    np.testing.assert_array_equal(b.freq, a.freq)
    assert dataclasses.asdict(a.report) == dataclasses.asdict(b.report)
    if a.tier_of_row is None:
        assert b.tier_of_row is None
    else:
        np.testing.assert_array_equal(b.tier_of_row, a.tier_of_row)


@pytest.mark.parametrize("lane", ["rows", "quant", "hysteresis"])
def test_replanner_matches_jax(lane):
    """A drifting stream through both replanners: every end_batch emits
    the same PlanUpdate (bank_of_row, slot_of_row, tier_of_row, freq,
    report) or none, the same skips; force_replan and the fault and
    straggler inputs give the same plans."""
    rng = np.random.default_rng(3)
    V, B = 600, 4
    cap = int(np.ceil(V / B) * 1.5)     # 3 banks hold the vocab
    kw = dict(capacity_rows=cap, check_every=2, min_observations=200)
    jkw, tkw = dict(kw), dict(kw)
    if lane == "quant":
        jkw.update(quant=JQuantSpec(byte_budget=10.0, min_hot_rows=4),
                   quant_dim=16)
        tkw.update(quant=TQuantSpec(byte_budget=10.0, min_hot_rows=4),
                   quant_dim=16)
    if lane == "hysteresis":
        jkw.update(hysteresis=0.2)         # some candidates win, some skip
        tkw.update(hysteresis=0.2)
    jcfg = JRP.ReplanConfig.for_vocab(V, B, **jkw)
    tcfg = TRP.ReplanConfig.for_vocab(V, B, **tkw)
    init = JP.non_uniform_partition(np.ones(V), B, capacity_rows=cap)
    jr = JRP.Replanner(jcfg, V, init_plan=init)
    tr = TRP.Replanner(tcfg, V, init_plan=TP.non_uniform_partition(
        np.ones(V), B, capacity_rows=cap))
    n_updates = 0
    for t in range(12):
        shift = (t // 4) * 150
        rows = (_zipf_rows(rng, V, 250, a=1.3) + shift) % V
        jr.observe_rows(rows)
        tr.observe_rows(rows)
        a, b = jr.end_batch(), tr.end_batch()
        _assert_update_equal(a, b)
        n_updates += a is not None
        assert (jr.n_replans, jr.n_skipped_replans) == \
            (tr.n_replans, tr.n_skipped_replans)
    assert n_updates >= 1
    if lane == "hysteresis":
        assert tr.n_skipped_replans >= 1
    jr.set_bank_health(np.array([True, False, True, True]))
    tr.set_bank_health(np.array([True, False, True, True]))
    _assert_update_equal(jr.force_replan(), tr.force_replan())
    jr.set_bank_penalty(np.array([1.0, 1.0, 3.0, 1.0]))
    tr.set_bank_penalty(np.array([1.0, 1.0, 3.0, 1.0]))
    a, b = jr.force_replan(), tr.force_replan()
    _assert_update_equal(a, b)
    assert a.plan.rows_per_bank[1] == 0
    assert TRP.Replanner.projected_max_share(b.plan, b.freq) == \
        JRP.Replanner.projected_max_share(a.plan, a.freq)


def test_replanner_replica_lane_raises():
    cfg = TRP.ReplanConfig(n_banks=4, replicate_k_max=2)
    r = TRP.Replanner(cfg, 100)
    with pytest.raises(NotImplementedError, match="#12"):
        r.build_replica_plan(np.ones(100))
    assert TRP.Replanner(TRP.ReplanConfig(n_banks=4), 100
                         ).build_replica_plan(np.ones(100)) is None


# ---------------------------------------------------------------------------
# live migration: equal tables, on the table's device
# ---------------------------------------------------------------------------

def _tables(rng, V=300, D=8, B=4, dtype=np.float32):
    cap = int(np.ceil(V / B) * 1.25)
    table = (rng.standard_normal((V, D)) * 0.01).astype(dtype)
    p0 = JP.non_uniform_partition(rng.random(V) + 0.1, B, capacity_rows=cap)
    p1 = JP.non_uniform_partition(rng.random(V) + 0.1, B, capacity_rows=cap)
    jt = JMIG.migrate_table(JE.pack_table(table, p0), p0, rows_per_bank=cap)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), B, cap, "cpu")
    return table, p0, p1, cap, jt, tt


def test_migrate_table_matches_jax_and_pack():
    """Packed rows after a migration equal the reference's, and equal a
    fresh pack of the same rows under the new plan (pad rows zero)."""
    rng = np.random.default_rng(0)
    table, _, p1, cap, jt, tt = _tables(rng)
    jm = JMIG.migrate_table(jt, p1, rows_per_bank=cap)
    tm = TMIG.migrate_table(tt, p1, rows_per_bank=cap)
    np.testing.assert_array_equal(_np(tm.packed), np.asarray(jm.packed))
    np.testing.assert_array_equal(_np(tm.remap_bank), np.asarray(jm.remap_bank))
    np.testing.assert_array_equal(_np(tm.remap_slot), np.asarray(jm.remap_slot))
    np.testing.assert_array_equal(_np(tm.remap_flat), np.asarray(
        jm.flat_remap()))
    assert (tm.n_banks, tm.rows_per_bank) == (jm.n_banks, jm.rows_per_bank)
    fresh = JMIG.migrate_table(JE.pack_table(table, p1), p1,
                               rows_per_bank=cap)
    np.testing.assert_array_equal(_np(tm.packed), np.asarray(fresh.packed))
    np.testing.assert_array_equal(TRT.unpacked_rows(tm), table)
    with pytest.raises(ValueError, match="rows_per_bank"):
        TMIG.migrate_table(tt, p1, rows_per_bank=cap // 2)
    with pytest.raises(NotImplementedError, match="#16"):
        TMIG.migrate_table(tt, p1, object())


def test_migrate_rowwise_state_and_leaves_match_jax():
    """Row-wise optimizer state (R,) and (R, D), and a params/optimizer
    tree migrated leaf by leaf: equal to the reference's; other leaves
    pass through."""
    rng = np.random.default_rng(1)
    _, _, p1, cap, jt, tt = _tables(rng)
    R = jt.packed.shape[0]
    acc = rng.random(R).astype(np.float32)
    mom = rng.random((R, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        _np(TMIG.migrate_rowwise_state(torch.from_numpy(acc), tt, p1,
                                       rows_per_bank=cap)),
        np.asarray(JMIG.migrate_rowwise_state(jnp.asarray(acc), jt, p1,
                                              rows_per_bank=cap)))
    dense = rng.random((5, 3)).astype(np.float32)
    jtree = JMIG.migrate_packed_leaves(
        {"acc": jnp.asarray(acc), "m": [jnp.asarray(mom)],
         "w": jnp.asarray(dense)}, jt, p1, rows_per_bank=cap)
    ttree = TMIG.migrate_packed_leaves(
        {"acc": torch.from_numpy(acc), "m": [torch.from_numpy(mom)],
         "w": torch.from_numpy(dense)}, tt, p1, rows_per_bank=cap)
    np.testing.assert_array_equal(_np(ttree["acc"]), np.asarray(jtree["acc"]))
    np.testing.assert_array_equal(_np(ttree["m"][0]),
                                  np.asarray(jtree["m"][0]))
    np.testing.assert_array_equal(_np(ttree["w"]), dense)


# ---------------------------------------------------------------------------
# the runtime: tier lane, fault and straggler lanes
# ---------------------------------------------------------------------------

def _runtimes(rng, quant, V=400, D=16, B=4):
    cap = int(np.ceil(V / B) * 1.5)     # 3 banks hold the vocab
    plan = JP.non_uniform_partition(np.ones(V), B, capacity_rows=cap)
    table = (rng.standard_normal((V, D)) * 0.01).astype(np.float32)
    jt = JMIG.migrate_table(JE.pack_table(table, plan), plan,
                            rows_per_bank=cap)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), B, cap, "cpu")
    kw = dict(capacity_rows=cap, check_every=2, min_observations=200)
    jq = tq = None
    if quant:
        jq = JQuantSpec(byte_budget=0.75 * D, min_hot_rows=4)
        tq = TQuantSpec(byte_budget=0.75 * D, min_hot_rows=4)
    jr = JRT.AdaptiveEmbeddingRuntime(
        jt, plan, JRP.ReplanConfig.for_vocab(V, B, quant=jq,
                                             quant_dim=D if quant else None,
                                             **kw), init_freq=np.ones(V))
    tr = TRT.AdaptiveEmbeddingRuntime(
        tt, plan, TRP.ReplanConfig.for_vocab(V, B, quant=tq,
                                             quant_dim=D if quant else None,
                                             **kw), init_freq=np.ones(V))
    return jr, tr


def _assert_tiered_equal(t, j):
    for f in ("payload", "scale", "tier", "remap_bank", "remap_slot"):
        np.testing.assert_array_equal(_np(getattr(t, f)),
                                      np.asarray(getattr(j, f)))
    np.testing.assert_array_equal(_np(t.remap_flat), np.asarray(j.flat_remap()))
    np.testing.assert_array_equal(t.tier_of_row(), j.tier_of_row())


def _assert_event_equal(a, b):
    assert (a.batch, a.old_imbalance, a.new_imbalance, a.reason,
            a.tier_version, a.tier_promoted, a.tier_demoted,
            a.tier_requantized) == \
        (b.batch, b.old_imbalance, b.new_imbalance, b.reason,
         b.tier_version, b.tier_promoted, b.tier_demoted, b.tier_requantized)


def test_runtime_tier_lane_matches_jax():
    """Drift-driven swaps through both runtimes: equal SwapEvents, packed
    tables and TieredTables; retired versions raise KeyError; the
    bank-failure and straggler lanes give equal tables."""
    rng = np.random.default_rng(4)
    jr, tr = _runtimes(rng, quant=True)
    _assert_tiered_equal(tr.tiered, jr.tiered)
    events = 0
    for t in range(14):
        rows = (_zipf_rows(rng, 400, 300, a=1.3) + (t // 5) * 120) % 400
        jr.observe_batch(rows)
        tr.observe_batch(rows)
        a, b = jr.end_batch(), tr.end_batch()
        assert (a is None) == (b is None)
        if a is not None:
            events += 1
            _assert_event_equal(a, b)
            np.testing.assert_array_equal(_np(tr.table.packed),
                                          np.asarray(jr.table.packed))
            _assert_tiered_equal(tr.tiered, jr.tiered)
    assert events >= 2 and tr.tier_version == events
    with pytest.raises(KeyError, match="retired"):
        tr.tiered_for(0)
    _assert_tiered_equal(tr.tiered_for(events - 1), jr.tiered_for(events - 1))
    live = np.array([True, True, False, True])
    a, b = jr.on_bank_failure(live), tr.on_bank_failure(live)
    _assert_event_equal(a, b)
    assert b.reason == "bank_failure" and b.recovery_s >= 0
    _assert_tiered_equal(tr.tiered, jr.tiered)
    pen = np.array([1.0, 2.5, 1.0, 1.0])
    _assert_event_equal(jr.on_straggler(pen), tr.on_straggler(pen))
    np.testing.assert_array_equal(_np(tr.table.packed),
                                  np.asarray(jr.table.packed))
    snap = tr.metrics.snapshot()
    assert snap["runtime.swaps_total"]["value"] == len(tr.swaps)
    assert snap["runtime.swaps_bank_failure_total"]["value"] == 1
    tr.on_slo_breach(np.array([1.0, 1.0, 1.0, 2.0]))
    assert tr.replanner._early_check


def test_runtime_migrate_aux_and_unported_lanes():
    rng = np.random.default_rng(5)
    jr, tr = _runtimes(rng, quant=False)
    for t in range(6):
        rows = _zipf_rows(rng, 400, 300, a=1.3)
        jr.observe_batch(rows)
        tr.observe_batch(rows)
    up_j, up_t = jr.replanner.force_replan(), tr.replanner.force_replan()
    acc = rng.random(tr.table.packed.shape[0]).astype(np.float32)
    np.testing.assert_array_equal(
        _np(tr.migrate_aux(torch.from_numpy(acc), up_t)),
        np.asarray(jr.migrate_aux(jnp.asarray(acc), up_j)))
    _assert_event_equal(jr.apply(up_j), tr.apply(up_t))
    with pytest.raises(ValueError, match="tiered lane disabled"):
        tr.tiered
    t0 = tr.table
    for kw, item in ((dict(cache_rows_per_bank=4), "#10"),
                     (dict(replicate_k_max=2), "#12")):
        cfg = TRP.ReplanConfig(n_banks=4, capacity_rows=t0.rows_per_bank,
                               **kw)
        with pytest.raises(NotImplementedError, match=item):
            TRT.AdaptiveEmbeddingRuntime(t0, tr.plan, cfg)


# ---------------------------------------------------------------------------
# the adaptive serve steps and the batcher's telemetry tap
# ---------------------------------------------------------------------------

def test_micro_batcher_observer_sees_host_features():
    seen = []
    pad = {"dense": np.zeros(3, np.float32),
           "sparse": np.full((2, 4), -1, np.int32)}
    mb = TS.MicroBatcher(4, pad, device="cpu",
                         observer=lambda f, n: seen.append((f, n)))
    for rid in range(3):
        mb.submit(TS.Request(rid, {"dense": np.ones(3, np.float32) * rid,
                                   "sparse": np.full((2, 4), rid, np.int32)}))
    reqs, feats = mb.next_batch()
    (host, n_real), = seen
    assert n_real == 3 and isinstance(host["sparse"], np.ndarray)
    np.testing.assert_array_equal(host["sparse"], feats["sparse"].numpy())
    assert host["sparse"].shape == (4, 2, 4) and (host["sparse"][3] == -1).all()
    mb.complete(reqs)
    assert len(mb.latencies) == 3


def test_traffic_counters_match_jax_and_host_twins():
    """Per-bank reads and tier-weighted bytes: the port's torch counters
    equal the reference's device counters and both host twins."""
    rng = np.random.default_rng(6)
    V, B, rpb = 200, 4, 60
    bank = rng.integers(0, B, V).astype(np.int32)
    slot = rng.integers(0, rpb, V).astype(np.int32)
    tier = rng.integers(0, 3, B * rpb).astype(np.int32)
    rows = rng.integers(-1, V, (5, 3, 7)).astype(np.int32)
    lut = np.array([64, 32, 16])
    tr = TTF.tiered_bank_traffic(torch.from_numpy(bank), torch.from_numpy(slot),
                                 rpb, torch.from_numpy(tier), lut,
                                 torch.from_numpy(rows), B)
    jr = JTF.tiered_bank_traffic(jnp.asarray(bank), jnp.asarray(slot), rpb,
                                 jnp.asarray(tier), lut, jnp.asarray(rows), B)
    hr, hb = TTF.host_tiered_bank_traffic(bank, slot, rpb, tier, lut, rows, B)
    for got, want, host in ((tr.reads, jr.reads, hr),
                            (tr.nbytes, jr.nbytes, hb)):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        np.testing.assert_array_equal(_np(got), host)
    live = np.array([True, False, True, True])
    got = TTF.bank_read_counts(torch.from_numpy(bank), torch.from_numpy(rows),
                               B, bank_live=torch.from_numpy(live))
    np.testing.assert_array_equal(
        _np(got), np.asarray(JTF.bank_read_counts(
            jnp.asarray(bank), jnp.asarray(rows), B,
            bank_live=jnp.asarray(live))))
    np.testing.assert_array_equal(
        _np(got), TTF.host_bank_read_counts(bank, rows, B, bank_live=live))
    np.testing.assert_array_equal(
        _np(TTF.traffic_from_reads(got, 32).nbytes), _np(got) * 32)


@pytest.mark.parametrize("quant", ["off", "int4"])
def test_adaptive_serve_steps_match_jax(quant):
    """One batch through ``build_recsys_serve_(tiered_)adaptive`` with
    traffic: scores within rtol 1e-5 / atol 1e-6, reads and bytes equal."""
    spec = jax_get_arch("updlrm-paper")
    cfg, tcfg = spec.reduced, get_arch("updlrm-paper").reduced
    V, B = cfg.total_vocab, 4
    cap = int(np.ceil(V / B) * 1.25)
    plan = JP.non_uniform_partition(np.ones(V), B, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(2), plan=plan,
                                     rows_per_bank=cap)
    tparams = params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    tstatics = TD.plan_statics(tcfg, plan, cap, device="cpu")
    rng = np.random.default_rng(8)
    sparse = rng.integers(-1, 500, (6, 8, 16)).astype(np.int32)
    dense = rng.standard_normal((6, 13)).astype(np.float32)
    jb = {"dense": jnp.asarray(dense), "sparse": jnp.asarray(sparse)}
    tb = {"dense": torch.from_numpy(dense), "sparse": torch.from_numpy(sparse)}
    if quant == "off":
        from repro.obs.traffic import bank_read_counts
        rows = jnp.where(jb["sparse"] >= 0, jb["sparse"]
                         + statics["field_offsets"][None, :, None], -1)
        js = jax.nn.sigmoid(JD.forward(cfg, params, statics, jb,
                                       backend="jnp"))
        jr = [bank_read_counts(statics["remap_bank"], rows, B)]
        got = TS.build_recsys_serve_adaptive(TD, tcfg, tstatics,
                                             backend="torch",
                                             with_traffic=True)(
            tparams, tstatics["remap_bank"], tstatics["remap_slot"], tb)
        plain = TS.build_recsys_serve_adaptive(TD, tcfg, tstatics)(
            tparams, tstatics["remap_bank"], tstatics["remap_slot"], tb,
            remap_flat=tstatics["remap_flat"])
        assert torch.equal(plain, got[0])
    else:
        from repro.quant import assign_tiers, build_tiered_table
        jtab = JE.BankedTable(params["emb_packed"], statics["remap_bank"],
                              statics["remap_slot"], B, cap)
        jq = JQuantSpec(byte_budget=6.0, min_hot_rows=8)
        jtt = build_tiered_table(jtab, assign_tiers(
            rng.random(V), jq, cfg.embed_dim).tier_of_row)
        out = JS.build_recsys_serve_tiered_adaptive(
            JD, cfg, statics, backend="jnp", with_traffic=True)(
            params, jtt, jb)
        js, jr = out[0], out[1:]
        got = TS.build_recsys_serve_tiered_adaptive(
            TD, tcfg, tstatics, backend="torch", with_traffic=True)(
            tparams, tiered_table_from_jax(jtt, "cpu"), tb)
    np.testing.assert_allclose(_np(got[0]), np.asarray(js), **SCORE_TOL)
    for a, b in zip(got[1:], jr):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


# ---------------------------------------------------------------------------
# the whole slice: run_adaptive against the reference's loop
# ---------------------------------------------------------------------------

def _jax_adaptive(cfg, *, quant, requests, batch, replan_every,
                  drift_rotate_every, seed, banks=8, capacity_slack=0.25):
    """The reference's ``launch/serve.py _main_adaptive`` loop, driven from
    the JAX package's modules (jnp backend, no SLO watchdog): returns the
    initial params and, per batch and per swap, what the test compares."""
    from repro.quant import QuantSpec
    from repro.workload import (AdaptiveEmbeddingRuntime, DriftConfig,
                                DriftingZipfTrace, ReplanConfig,
                                dlrm_drifting_batch, rows_from_sparse)
    V = cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    plan = JP.non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    offs = np.asarray(statics["field_offsets"])
    quant_on = quant != "off"
    qspec = None
    if quant_on:
        budget = cfg.embed_dim // 2 + 2.0 if quant == "int4" else None
        qspec = QuantSpec(enable_int4=quant == "int4", byte_budget=budget,
                          min_hot_rows=8)
    table = JE.BankedTable(packed=params["emb_packed"],
                           remap_bank=statics["remap_bank"],
                           remap_slot=statics["remap_slot"], n_banks=banks,
                           rows_per_bank=cap)
    rcfg = ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                  check_every=replan_every, quant=qspec,
                                  quant_dim=cfg.embed_dim if quant_on
                                  else None)
    runtime = AdaptiveEmbeddingRuntime(table, plan, rcfg,
                                       init_freq=np.ones(V))
    offs_j = jnp.asarray(offs)
    if quant_on:
        serve = jax.jit(JS.build_recsys_serve_tiered_adaptive(
            JD, cfg, statics, backend="jnp", with_traffic=True))
    else:
        @jax.jit
        def serve(params, remap_bank, remap_slot, batch):
            st = {**statics, "remap_bank": remap_bank,
                  "remap_slot": remap_slot}
            logits = JD.forward(cfg, params, st, batch, backend="jnp")
            rows = jnp.where(batch["sparse"] >= 0,
                             batch["sparse"] + offs_j[None, :, None], -1)
            return jax.nn.sigmoid(logits), JTF.bank_read_counts(
                remap_bank, rows, banks)

    def observe(feats, n_real):
        sp = np.asarray(feats["sparse"])[:n_real]
        runtime.observe_batch(rows_from_sparse(sp, offs))

    traces = [DriftingZipfTrace(
        DriftConfig(n_items=v, zipf_a=1.05, avg_bag=float(cfg.multi_hot),
                    rotate_every=drift_rotate_every, rotate_frac=0.25),
        seed=seed + f) for f, v in enumerate(cfg.vocab_sizes)]
    rng = np.random.default_rng(seed)

    def one_request(rid):
        sparse = dlrm_drifting_batch(traces, 1, cfg.multi_hot)[0]
        return {"dense": rng.standard_normal(cfg.n_dense).astype(np.float32),
                "sparse": sparse}

    pad = one_request(-1)
    mb = JS.MicroBatcher(batch, pad, observer=observe)
    out = {"scores": [], "reads": [], "nbytes": [], "swaps": []}
    row_nbytes = cfg.embed_dim * 4

    def run_batch():
        reqs, feats = mb.next_batch()
        p = {**params, "emb_packed": runtime.table.packed}
        if quant_on:
            scores, reads, nbytes = serve(p, runtime.tiered, feats)
        else:
            scores, reads = serve(p, runtime.table.remap_bank,
                                  runtime.table.remap_slot, feats)
            nbytes = reads * row_nbytes
        mb.complete(reqs)
        out["scores"].append(np.asarray(scores)[:len(reqs)])
        out["reads"].append(np.asarray(reads))
        out["nbytes"].append(np.asarray(nbytes))
        event = runtime.end_batch()
        if event is not None:
            snap = {"packed": np.asarray(runtime.table.packed)}
            if quant_on:
                snap["tiered"] = jax.tree.map(np.asarray, runtime.tiered)
            out["swaps"].append((event, snap))

    for rid in range(requests):
        mb.submit(JS.Request(rid=rid, features=one_request(rid)))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    return params, out


@pytest.mark.parametrize("quant", ["off", "int4"])
def test_run_adaptive_matches_jax_loop(quant, monkeypatch):
    """The whole slice on ``updlrm-paper`` reduced, ``replan_every=2``: the
    same SwapEvents (batch, imbalances, promoted/demoted/requantized), the
    same packed table and (int4) payload, scales and tiers after each swap,
    the same per-batch reads and bytes, and scores within rtol 1e-5 / atol
    1e-6; at least one swap, shapes stable, re-tier parity."""
    kw = dict(quant=quant, requests=96, batch=8, replan_every=2,
              drift_rotate_every=24, seed=1)
    jcfg = jax_get_arch("updlrm-paper").reduced
    jparams, want = _jax_adaptive(jcfg, **kw)

    snaps = []

    class Recording(TRT.AdaptiveEmbeddingRuntime):
        def __init__(self, *a, **k):
            k["on_swap"] = lambda e: snaps.append(
                (e, {"packed": self.table.packed.clone(),
                     "tiered": self.tiered if quant != "off" else None}))
            super().__init__(*a, **k)

    monkeypatch.setattr(TSERVE, "AdaptiveEmbeddingRuntime", Recording)
    spec = get_arch("updlrm-paper")
    res = TSERVE.run_adaptive(
        spec, spec.reduced, device="cpu", backend="torch", min_swaps=1,
        params=params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        **kw)

    assert len(want["swaps"]) >= 1 and len(snaps) == len(want["swaps"])
    assert res.checks["shapes_stable"]
    assert res.checks["retier_ok"] is (True if quant == "int4" else None)
    for (a, ja), (b, tb) in zip(want["swaps"], snaps):
        _assert_event_equal(a, b)
        assert dataclasses.asdict(a.update.report) == \
            dataclasses.asdict(b.update.report)
        np.testing.assert_array_equal(_np(tb["packed"]), ja["packed"])
        if quant == "int4":
            _assert_tiered_equal(tb["tiered"], ja["tiered"])
            assert b.tier_requantized > 0
    assert len(res.reads) == len(want["reads"])
    for got, exp in ((res.reads, want["reads"]), (res.nbytes, want["nbytes"])):
        for g, e in zip(got, exp):
            np.testing.assert_array_equal(g, e)
    np.testing.assert_allclose(_np(res.scores), np.concatenate(
        want["scores"]), **SCORE_TOL)
    assert res.stats["swaps"] == len(snaps)


def test_migrate_packed_leaves_frees_the_old_table():
    """The old packed table goes as soon as the caller drops it: no
    reference cycle holds it for the garbage collector."""
    import gc
    import weakref
    p0 = TP.non_uniform_partition(np.ones(40), 4)
    p1 = TP.non_uniform_partition(np.arange(40.0), 4)
    gc.disable()
    try:
        t = TE.pack_table(np.ones((40, 3), np.float32), p0, device="cpu")
        ref = weakref.ref(t.packed)
        tree = {"emb": t.packed, "acc": torch.zeros(t.packed.shape[0]),
                "mlp": [torch.ones(2)]}
        new = TMIG.migrate_packed_leaves(tree, t, p1)
        np.testing.assert_array_equal(
            _np(new["emb"]), _np(TMIG.migrate_table(t, p1).packed))
        del tree, t
        assert ref() is None
    finally:
        gc.enable()
