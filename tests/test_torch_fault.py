"""The port's fault lane (``--adaptive --inject-bank-failure``) against the
JAX package's, on the CPU: the per-bank fault model (``dist.bank_fault``),
the failure injector, straggler watchdog and restart loop
(``dist.fault``), ``degraded_mean_fill``, ``with_traffic`` on the banked
and fused lookups, the degraded serve step, and the whole slice —
``launch.serve.run_fault`` against the reference's ``_main_adaptive_fault``
loop driven from its own modules — plus the reference's CI fault command
through the port's CLI.

Inputs come from numpy seeds; weights are the reference's, carried across
with ``repro_torch.convert``. The fault model, the watchdog and planning are
numpy or stdlib on both sides and must agree exactly; bag sums and reads
are held bit for bit, scores within rtol 1e-5 / atol 1e-6 (the MLPs' fp32
order differs), and the port's clean requests and recovered batch bit for
bit against its own never-failed run.
"""
import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.dist import bank_fault as JBF
from repro.dist import fault as JF
from repro.models import dlrm as JD
from repro.obs import MetricRegistry as JRegistry
from repro.obs import Tracer as JTracer
from repro.serve import serve_step as JS
from repro_torch.configs import get_arch
from repro_torch.convert import (banked_table_from_jax, params_from_jax,
                                 statics_from_jax)
from repro_torch.core import embedding as TE
from repro_torch.dist import bank_fault as TBF
from repro_torch.dist import fault as TF
from repro_torch.launch import serve as TSERVE
from repro_torch.models import dlrm as TD
from repro_torch.obs import MetricRegistry as TRegistry
from repro_torch.serve import serve_step as TS

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
ROOT = Path(__file__).resolve().parent.parent
# the fault lane's reduced run: bank 3 dies at batch 2 (recovery), bank 5
# slows 8x at batch 8 (the straggler replan: 7 clean batches of history by
# then), bank 3 revives at batch 10 (a recovery through the same call)
SCHEDULE = ("2:3", "8:5:degraded:8.0", "10:3:healthy")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# dist.bank_fault and dist.fault
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", ["12:3", "0:0:dead", "12:3:degraded:4.0",
                                  "20:3:healthy", "5:7:degraded"])
def test_parse_fault_spec_matches_jax(spec):
    t, j = TBF.parse_fault_spec(spec), JBF.parse_fault_spec(spec)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert str(t) == str(j)


@pytest.mark.parametrize("spec", ["12", "1:2:3:4:5", "1:2:sick", "x:1"])
def test_parse_fault_spec_refuses_like_jax(spec):
    with pytest.raises(ValueError) as want:
        JBF.parse_fault_spec(spec)
    with pytest.raises(ValueError) as got:
        TBF.parse_fault_spec(spec)
    assert str(got.value) == str(want.value)


def _replay(mod, state, n):
    out = []
    for b in range(n):
        fired = [str(e) for e in state.advance(b)]
        out.append((fired, state.live_mask().tolist(),
                    state.slow_factor().tolist(), state.dead_banks(),
                    state.degraded_banks(), state.any_fault()))
    return out


def test_bank_fault_state_matches_jax():
    specs = ["6:2", "1:3:degraded:2.5", "1:0", "9:2:healthy", "9:3:healthy",
             "4:7:dead"]
    t = TBF.BankFaultState.from_specs(8, specs)
    j = JBF.BankFaultState.from_specs(8, specs)
    assert _replay(TBF, t, 12) == _replay(JBF, j, 12)
    assert [str(e) for e in t.fired] == [str(e) for e in j.fired]
    with pytest.raises(ValueError, match="out of range"):
        TBF.BankFaultState.from_specs(4, ["1:4"])


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("knobs", [dict(n_failures=1),
                                   dict(n_failures=9, p_degraded=0.5),
                                   dict(n_failures=3, p_degraded=1.0,
                                        degraded_factor=2.0, min_batch=5)])
def test_random_schedule_matches_jax(seed, knobs):
    t = TBF.BankFaultState.random_schedule(8, 40, seed=seed, **knobs)
    j = JBF.BankFaultState.random_schedule(8, 40, seed=seed, **knobs)
    assert [dataclasses.asdict(e) for e in t.schedule] == \
        [dataclasses.asdict(e) for e in j.schedule]
    assert len(t.schedule) <= 7            # one survivor at least
    assert _replay(TBF, t, 40) == _replay(JBF, j, 40)


def test_straggler_watchdog_matches_jax():
    rng = np.random.default_rng(3)
    times = rng.uniform(1.0, 1.2, 60)
    times[[7, 20, 21, 44]] = [5.0, 4.0, 9.0, 3.5]
    times[2] = 9.0                         # inside min_history: not flagged
    t_hits, j_hits = [], []
    treg, jreg = TRegistry(), JRegistry()
    t = TF.StragglerWatchdog(factor=3.0, window=16, min_history=5,
                             on_straggler=lambda *a: t_hits.append(a),
                             metrics=treg)
    j = JF.StragglerWatchdog(factor=3.0, window=16, min_history=5,
                             on_straggler=lambda *a: j_hits.append(a),
                             metrics=jreg)
    flags = [(t.observe(i, x), j.observe(i, x)) for i, x in enumerate(times)]
    assert all(a == b for a, b in flags)
    assert t.events == j.events and len(t.events) >= 3 and 2 not in t.events
    assert t_hits == j_hits
    assert list(t.history) == list(j.history)
    assert treg.snapshot() == jreg.snapshot()
    assert TF.StragglerWatchdog().factor == 3.0   # its own registry


def test_injector_backoff_and_restarts_match_jax():
    for mod in (TF, JF):
        inj = mod.FailureInjector(3)
        inj.check(2)
        with pytest.raises(mod.InjectedFailure, match="step 3"):
            inj.check(3)
        inj.check(3)                       # fires once
    for kw in (dict(), dict(base=0.5, factor=3.0, cap=2.0)):
        assert TF.backoff_schedule(6, **kw) == JF.backoff_schedule(6, **kw)

    def drive(mod, crash_at, max_restarts, retryable=(Exception,)):
        sleeps, starts = [], []
        ckpt = {"step": 0}

        def loop(start):
            starts.append(start)
            for step in range(start, 10):
                if crash_at and step == crash_at.pop(0):
                    raise RuntimeError(f"crash at {step}")
                ckpt["step"] = step - step % 3
            return 10
        try:
            out = mod.run_with_restarts(
                loop, restore_step=lambda: ckpt["step"],
                max_restarts=max_restarts, retryable=retryable,
                sleep=sleeps.append)
        except RuntimeError as e:
            out = str(e)
        return out, sleeps, starts

    for args in (([4, 7, 9], 8), ([1, 2, 3, 4], 2), ([5], 3, (KeyError,))):
        t = drive(TF, list(args[0]), *args[1:])
        j = drive(JF, list(args[0]), *args[1:])
        assert t == j


# ---------------------------------------------------------------------------
# the lookups: degraded_mean_fill and with_traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_degraded_mean_fill_matches_jax(dtype):
    rng = np.random.default_rng(5)
    emb = rng.standard_normal((6, 4, 8)).astype(np.float32)
    counts = rng.integers(0, 5, (6, 4)).astype(np.int32)
    fallback = rng.standard_normal(8).astype(np.float32)
    want = JE.degraded_mean_fill(jnp.asarray(emb, dtype), jnp.asarray(counts),
                                 jnp.asarray(fallback, dtype))
    got = TE.degraded_mean_fill(
        torch.from_numpy(emb).to(getattr(torch, dtype)),
        torch.from_numpy(counts),
        torch.from_numpy(fallback).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(_np(got.float()),
                                  np.asarray(want.astype(jnp.float32)))


def _banked(seed, v=120, d=8, banks=4):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    jt = JE.pack_table(table, JP.non_uniform_partition(rng.random(v) + 0.1,
                                                       banks))
    t = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                              np.asarray(jt.remap_slot), jt.n_banks,
                              jt.rows_per_bank, "cpu")
    return rng, jt, t


@pytest.mark.parametrize("dead", [None, 1])
@pytest.mark.parametrize("kind", ["fields", "rows", "dense"])
def test_banked_with_traffic_matches_jax(kind, dead):
    """``with_traffic=True``: the same sums as the plain call, the
    reference's reads and bytes exactly (a dead bank's reads not
    counted)."""
    rng, jt, t = _banked(11)
    if kind == "fields":               # (B, F, L) per-field ids + offsets
        idx = rng.integers(-1, 30, (5, 4, 7)).astype(np.int32)
        kw = dict(field_offsets=np.array([0, 30, 60, 90], np.int32))
    elif kind == "rows":
        idx = rng.integers(-1, 120, (9, 6)).astype(np.int32)
        kw = {}
    else:                              # the dense per-position gather
        idx = rng.integers(-1, 120, (5, 6)).astype(np.int32)
        kw = dict(reduce_bag=False)
    live = None
    if dead is not None:
        live = np.ones(4, bool)
        live[dead] = False
    jout, jtr = JE.banked_embedding_bag(
        jt, jnp.asarray(idx), None, backend="jnp", with_traffic=True,
        bank_live=None if live is None else jnp.asarray(live),
        **{k: jnp.asarray(v) if k == "field_offsets" else v
           for k, v in kw.items()})
    tkw = {k: torch.from_numpy(v) if k == "field_offsets" else v
           for k, v in kw.items()}
    tlive = None if live is None else torch.from_numpy(live)
    out, tr = TE.banked_embedding_bag(t, torch.from_numpy(idx),
                                      with_traffic=True, bank_live=tlive,
                                      **tkw)
    assert torch.equal(out, TE.banked_embedding_bag(
        t, torch.from_numpy(idx), bank_live=tlive, **tkw))
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    np.testing.assert_array_equal(_np(tr.reads), np.asarray(jtr.reads))
    np.testing.assert_array_equal(_np(tr.nbytes), np.asarray(jtr.nbytes))
    if dead is not None:
        rows = idx if kind != "fields" else np.where(
            idx >= 0, idx + kw["field_offsets"][None, :, None], -1)
        n_dead = int(TE.degraded_row_counts(
            t.remap_bank, tlive, torch.from_numpy(rows)).sum())
        assert n_dead > 0
        assert int(tr.reads.sum()) + n_dead == int((idx >= 0).sum())


def test_cached_with_traffic_honours_bank_live():
    """The fused lookup's ``with_traffic`` under a dead bank: the
    reference's reads (a dead bank's hits and residual rows not counted)."""
    rng, jt, t = _banked(12)
    cache = rng.standard_normal((24, 8)).astype(np.float32)
    jc = JE.pack_table(cache, JP.uniform_partition(24, 4))
    c = banked_table_from_jax(np.asarray(jc.packed), np.asarray(jc.remap_bank),
                              np.asarray(jc.remap_slot), 4, jc.rows_per_bank,
                              "cpu")
    ci = rng.integers(-1, 24, (10, 3)).astype(np.int32)
    ri = rng.integers(-1, 120, (10, 9)).astype(np.int32)
    live = np.array([True, True, False, True])
    jout, jtr = JE.banked_cache_residual_bag(
        jt, jc, jnp.asarray(ci), jnp.asarray(ri), None, backend="jnp",
        bank_live=jnp.asarray(live), with_traffic=True)
    out, tr = TE.banked_cache_residual_bag(
        t, c, torch.from_numpy(ci), torch.from_numpy(ri),
        bank_live=torch.from_numpy(live), with_traffic=True)
    np.testing.assert_array_equal(_np(out), np.asarray(jout))
    np.testing.assert_array_equal(_np(tr.reads), np.asarray(jtr.reads))
    np.testing.assert_array_equal(_np(tr.nbytes), np.asarray(jtr.nbytes))


# ---------------------------------------------------------------------------
# the degraded serve step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_serve_degraded_adaptive_matches_jax(arch):
    """One batch through ``build_recsys_serve_degraded_adaptive`` with a
    dead bank: the reference's degraded counts and reads exactly, scores
    within rtol 1e-5 / atol 1e-6; served reads plus degraded reads equal
    the valid lookups. With every bank live the step scores bit for bit as
    the plain adaptive step."""
    rng = np.random.default_rng(21)
    jcfg, tcfg = jax_get_arch(arch).reduced, get_arch(arch).reduced
    V, B = jcfg.total_vocab, 8
    cap = int(np.ceil(V / B) * 1.25)
    plan = JP.non_uniform_partition(rng.random(V), B, capacity_rows=cap)
    params, statics = JD.init_params(jcfg, jax.random.key(4), plan=plan,
                                     rows_per_bank=cap)
    from repro.data import synthetic as JSYN
    bt = JSYN.dlrm_batch(jcfg.vocab_sizes, jcfg.n_dense, 6, seed=2, step=0,
                         multi_hot=jcfg.multi_hot)
    bt.pop("label")
    live = np.ones(B, bool)
    live[3] = False
    jserve = JS.build_recsys_serve_degraded_adaptive(
        JD, jcfg, statics, backend="jnp", with_traffic=True)
    js, jc, jr = jserve(params, statics["remap_bank"], statics["remap_slot"],
                        jnp.asarray(live),
                        {k: jnp.asarray(v) for k, v in bt.items()})
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in bt.items()}
    serve = TS.build_recsys_serve_degraded_adaptive(TD, tcfg, ts,
                                                    with_traffic=True)
    s, c, r = serve(tp, ts["remap_bank"], ts["remap_slot"],
                    torch.from_numpy(live), tb)
    np.testing.assert_allclose(_np(s), np.asarray(js), **SCORE_TOL)
    np.testing.assert_array_equal(_np(c), np.asarray(jc))
    np.testing.assert_array_equal(_np(r), np.asarray(jr))
    assert int(c.sum()) > 0
    assert int(r.sum()) + int(c.sum()) == int((bt["sparse"] >= 0).sum())
    s2, c2 = TS.build_recsys_serve_degraded_adaptive(TD, tcfg, ts)(
        tp, ts["remap_bank"], ts["remap_slot"], torch.from_numpy(live), tb,
        remap_flat=ts["remap_flat"])
    assert torch.equal(s2, s) and torch.equal(c2, c)
    all_live = torch.ones(B, dtype=torch.bool)
    s3, c3 = serve(tp, ts["remap_bank"], ts["remap_slot"], all_live, tb)[:2]
    plain = TS.build_recsys_serve_adaptive(TD, tcfg, ts)(
        tp, ts["remap_bank"], ts["remap_slot"], tb)
    assert torch.equal(s3, plain) and int(c3.sum()) == 0


# ---------------------------------------------------------------------------
# the whole slice: run_fault against the reference's loop
# ---------------------------------------------------------------------------

def _jax_fault(cfg, *, requests, batch, replan_every, faults, seed,
               slo_args, banks=8, capacity_slack=0.25, straggler_factor=3.0,
               drift_rotate_every=512):
    """The reference's ``launch/serve.py _main_adaptive_fault`` loop, driven
    from the JAX package's modules (jnp backend, its own SLO lane): returns
    the initial params and, per batch and per swap, what the test
    compares."""
    from repro.dist.bank_fault import BankFaultState
    from repro.dist.fault import StragglerWatchdog
    from repro.launch.serve import _TrafficSLO
    from repro.workload import (AdaptiveEmbeddingRuntime, DriftConfig,
                                DriftingZipfTrace, ReplanConfig,
                                dlrm_drifting_batch, rows_from_sparse)
    V = cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    plan = JP.non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    offs = np.asarray(statics["field_offsets"])
    fault = BankFaultState.from_specs(banks, list(faults))
    tracer, metrics = JTracer(), JRegistry()
    m_deg_reads = metrics.counter("serve.degraded_reads_total")
    m_deg_batches = metrics.counter("serve.degraded_batches_total")
    m_faults = metrics.counter("fault.injected_total")
    out = {"scores": [], "counts": [], "reads": [], "fired": [],
           "swaps": [], "confine": [], "recover_parity": None}
    table = JE.BankedTable(packed=params["emb_packed"],
                           remap_bank=statics["remap_bank"],
                           remap_slot=statics["remap_slot"], n_banks=banks,
                           rows_per_bank=cap)
    rcfg = ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                  check_every=replan_every)
    runtime = AdaptiveEmbeddingRuntime(
        table, plan, rcfg, init_freq=np.ones(V), tracer=tracer,
        metrics=metrics,
        on_swap=lambda e: out["swaps"].append(
            (e, np.asarray(runtime.table.packed))))
    watchdog = StragglerWatchdog(factor=straggler_factor, metrics=metrics)
    serve = jax.jit(JS.build_recsys_serve_degraded_adaptive(
        JD, cfg, statics, backend="jnp", with_traffic=True))
    all_live = jnp.ones(banks, dtype=bool)
    row_nbytes = params["emb_packed"].shape[-1] * 4
    slo = _TrafficSLO(slo_args, metrics, tracer, banks=banks,
                      dim=cfg.embed_dim, row_nbytes=row_nbytes,
                      runtime=runtime)
    orig = (params["emb_packed"], statics["remap_bank"],
            statics["remap_slot"])

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

    mb = JS.MicroBatcher(batch, one_request(-1), observer=observe,
                         metrics=metrics)
    st = {"batch": 0, "handled_dead": frozenset(), "penalized": False,
          "fail": None, "recovered": None}

    def never_failed(feats):
        p0 = {**params, "emb_packed": orig[0]}
        return np.asarray(serve(p0, orig[1], orig[2], all_live, feats)[0])

    def run_batch():
        b = st["batch"]
        st["batch"] += 1
        for e in fault.advance(b):
            m_faults.inc()
            out["fired"].append((b, str(e)))
            if st["fail"] is None and fault.dead_banks():
                st["fail"] = b
        live = fault.live_mask()
        reqs, feats = mb.next_batch()
        p = {**params, "emb_packed": runtime.table.packed}
        scores, counts, reads = serve(p, runtime.table.remap_bank,
                                      runtime.table.remap_slot,
                                      jnp.asarray(live), feats)
        slo.after_step(b, reads, 0.0, batch)
        counts = np.asarray(counts)
        m_deg_reads.inc(int(counts.sum()))
        if counts.sum() > 0:
            m_deg_batches.inc()
        out["scores"].append(np.asarray(scores)[:len(reqs)])
        out["counts"].append(counts)
        out["reads"].append(np.asarray(reads))
        if counts.sum() > 0:
            if len(out["confine"]) < 2:
                ref = never_failed(feats)
                out["confine"].append(bool(
                    (np.asarray(scores)[counts == 0]
                     == ref[counts == 0]).all()))
        elif st["recovered"] is None and st["fail"] is not None \
                and st["handled_dead"]:
            st["recovered"] = b
            out["recover_parity"] = bool(
                (np.asarray(scores) == never_failed(feats)).all())
        mb.complete(reqs)
        dead = frozenset(fault.dead_banks())
        if dead != st["handled_dead"]:
            runtime.on_bank_failure(live)
            slo.on_swap(runtime)
            st["handled_dead"] = dead
            return
        sf = fault.slow_factor()
        rows = rows_from_sparse(np.asarray(feats["sparse"]), offs)
        rows = rows[rows >= 0]
        r = np.bincount(np.asarray(runtime.plan.bank_of_row)[rows],
                        minlength=banks)
        t_bank = r.astype(np.float64) * sf
        if watchdog.observe(b, float(t_bank.max())) and not st["penalized"]:
            slow = int(np.argmax(t_bank))
            pen = np.ones(banks)
            pen[slow] = float(max(sf[slow], 1.0))
            runtime.on_straggler(pen)
            slo.on_swap(runtime)
            st["penalized"] = True
            return
        if runtime.end_batch() is not None:
            slo.on_swap(runtime)

    for rid in range(requests):
        mb.submit(JS.Request(rid=rid, features=one_request(rid)))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    out["stragglers"] = list(watchdog.events)
    out["breaches"] = slo.breaches
    out["metrics"] = metrics
    return params, out


def _slo_args(**kw):
    return types.SimpleNamespace(**{**dict(slo_p99_us=0.0, slo_max_share=0.0,
                                           slo_divergence=0.0, slo_window=4),
                                    **kw})


def test_run_fault_matches_jax_loop(monkeypatch):
    """The whole slice on ``updlrm-paper`` reduced (96 requests at batch 8,
    drift checks every 16 batches so none interleaves; ``SCHEDULE``: a
    death, a slow bank, a revival; the SLO lane's count-driven
    ``max_share`` check armed): the same fired events, per-request degraded
    counts and served reads per batch; the same recovery, straggler and
    revival swaps with equal plans (``bank_of_row``, ``slot_of_row``,
    ``load_per_bank``) and equal packed tables after each; the same
    straggler steps and SLO breaches; scores within rtol 1e-5 / atol 1e-6;
    confinement and recovery parity holding on both sides."""
    kw = dict(requests=96, batch=8, replan_every=16, faults=SCHEDULE, seed=1)
    jcfg = jax_get_arch("updlrm-paper").reduced
    jparams, want = _jax_fault(jcfg, slo_args=_slo_args(slo_max_share=0.17),
                               **kw)
    snaps = []

    class Recording(TSERVE.AdaptiveEmbeddingRuntime):
        def __init__(self, *a, **k):
            k["on_swap"] = lambda e: snaps.append((e, self.table.packed))
            super().__init__(*a, **k)

    monkeypatch.setattr(TSERVE, "AdaptiveEmbeddingRuntime", Recording)
    spec = get_arch("updlrm-paper")
    reg = TRegistry()
    res = TSERVE.run_fault(
        spec, spec.reduced, device="cpu", backend="torch", min_recoveries=2,
        slo=TSERVE.SLOConfig(max_share=0.17, window=4), metrics=reg,
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"), **kw)

    assert [(b, str(e)) for b, e in res.fired] == want["fired"]
    assert len(want["fired"]) == 3
    assert len(res.degraded) == len(want["counts"]) == 12
    for g, e in zip(res.degraded, want["counts"]):
        np.testing.assert_array_equal(g, e)
    for g, e in zip(res.reads, want["reads"]):
        np.testing.assert_array_equal(g, e)
    for r, c, n in zip(res.reads, res.degraded, res.lookups):
        assert int(r.sum()) + int(c.sum()) == n
    reasons = [e.reason for e, _ in want["swaps"]]
    assert reasons == ["bank_failure", "straggler", "bank_failure"]
    assert len(snaps) == len(want["swaps"])
    for (a, ja), (b, packed) in zip(want["swaps"], snaps):
        assert (a.batch, a.reason) == (b.batch, b.reason)
        assert a.old_imbalance == b.old_imbalance
        assert a.new_imbalance == b.new_imbalance
        for f in ("bank_of_row", "slot_of_row", "load_per_bank"):
            np.testing.assert_array_equal(getattr(b.update.plan, f),
                                          getattr(a.update.plan, f))
        np.testing.assert_array_equal(_np(packed), ja)
    assert res.stragglers == want["stragglers"] == [8, 11]
    assert len(res.slo_events) == want["breaches"] >= 1
    assert all(e["kind"] == "hot_bank" for e in res.slo_events)
    np.testing.assert_allclose(_np(res.scores),
                               np.concatenate(want["scores"]), **SCORE_TOL)
    assert want["confine"] == [True] and want["recover_parity"] is True
    assert res.checks == {"shapes_stable": True, "confine_ok": True,
                          "recover_parity": True}
    assert len(res.probes) == 1 and res.stats["recoveries"] == 2
    # every request of a degraded batch reads 128 rows, so all touch the
    # dead bank: confinement holds per bag — bags with no dead read sum bit
    # for bit as on the never-failed table with every bank live
    p = res.probes[0]
    assert p["batch"] == 2 and (p["counts"] > 0).all()
    t, t0 = p["table"], res.never_failed
    sp, offs = p["feats"]["sparse"], res.statics["field_offsets"]
    live = torch.from_numpy(p["live"])
    got = TE.banked_embedding_bag(t, sp, field_offsets=offs, bank_live=live)
    ref = TE.banked_embedding_bag(t0, sp, field_offsets=offs)
    rows = torch.where(sp >= 0, sp + offs[None, :, None], -1)
    clean = TE.degraded_row_counts(t.remap_bank, live, rows,
                                   per_bag=True) == 0
    assert 0 < int(clean.sum()) < clean.numel()
    assert torch.equal(got[clean], ref[clean])
    # the registries: the same names, and the same counts where the run
    # decides them (wall-clock series aside)
    jsnap, tsnap = want["metrics"].snapshot(), reg.snapshot()
    assert set(tsnap) == set(jsnap)
    for name, m in jsnap.items():
        if m["type"] in ("counter", "vector_counter") \
                or name.startswith("obs.slo_projected"):
            assert tsnap[name] == m, name


def test_run_fault_confines_degradation_to_dead_bank_requests():
    """On one-hot ``dlrm-rm2`` a request may miss the dead bank: its score
    through the degraded batch equals the never-failed run's bit for bit,
    and the first batch after the recovery equals it in full."""
    spec = get_arch("dlrm-rm2")
    res = TSERVE.run_fault(spec, spec.reduced, requests=320, batch=32,
                           faults=["8:3"], min_recoveries=1, device="cpu")
    p = res.probes[0]
    clean = torch.from_numpy(p["counts"] == 0)
    assert p["batch"] == 8 and 0 < int(clean.sum()) < len(clean)
    t0 = res.never_failed
    ref, counts = TS.build_recsys_serve_degraded_adaptive(
        TD, spec.reduced, res.statics)(
        {**res.params, "emb_packed": t0.packed}, t0.remap_bank,
        t0.remap_slot, torch.ones(8, dtype=torch.bool), p["feats"])
    assert int(counts.sum()) == 0
    assert torch.equal(p["scores"][clean], ref[clean])
    assert not torch.equal(p["scores"], ref)
    assert res.checks["recover_parity"] is True
    assert res.stats["recover_batch"] == 9 and res.degraded[9].sum() == 0


def test_run_fault_contracts_and_guards(monkeypatch):
    """``min_recoveries`` unmet raises ``SystemExit``, as does an unmet
    ``min_slo_breaches``; without CUDA ``run_fault`` raises unless the CPU
    is asked for."""
    spec = get_arch("updlrm-paper")
    with pytest.raises(SystemExit, match="recoveries=0"):
        TSERVE.run_fault(spec, spec.reduced, requests=16, batch=8,
                         min_recoveries=1, device="cpu")
    with pytest.raises(SystemExit, match="slo contract violated"):
        TSERVE.run_fault(spec, spec.reduced, requests=24, batch=8,
                         faults=["1:2"], min_recoveries=1,
                         min_slo_breaches=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TSERVE.run_fault(spec, spec.reduced, requests=8, batch=8,
                         faults=["1:2"])


def test_ci_fault_command_runs_through_the_port(tmp_path):
    """The reference's CI fault contract (``.github/workflows/ci.yml``) on
    ``dlrm-rm2`` through ``python -m repro_torch.launch.serve --device
    cpu``: exit 0, one ``OBS_SUMMARY`` line, the metric names of
    ``METRICS_serve_smoke.json`` but its two ``jax.*`` ones, and a Chrome
    trace with the recovery span and the fault instant."""
    trace, snap = tmp_path / "T.json", tmp_path / "M.json"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "dlrm-rm2", "--adaptive", "--requests", "1024", "--batch", "32",
         "--replan-every", "8", "--inject-bank-failure", "8:3",
         "--min-recoveries", "1", "--slo-p99-us", "1000", "--slo-window",
         "8", "--min-slo-breaches", "1", "--trace-out", str(trace),
         "--metrics-out", str(snap), "--metrics-every", "8", "--device",
         "cpu"], capture_output=True, text=True, timeout=300, env=env,
        cwd=tmp_path)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    lines = [x for x in r.stdout.splitlines() if x.startswith("OBS_SUMMARY ")]
    assert len(lines) == 1
    summary = json.loads(lines[0][len("OBS_SUMMARY "):])
    assert summary["fault.injected_total"] == 1.0
    assert summary["runtime.swaps_bank_failure_total"] >= 1.0
    assert summary["obs.slo_breaches_p99_total"] >= 1.0
    want = set(json.loads((ROOT / "METRICS_serve_smoke.json").read_text())
               ["metrics"]) - {"jax.compiles_total", "jax.serve_executables"}
    doc = json.loads(snap.read_text())
    assert set(doc["metrics"]) == want == set(summary)
    assert doc["meta"] == {"label": "serve-fault:dlrm-rm2", "schema": 2}
    events = json.loads(trace.read_text())["traceEvents"]
    assert {("X", "recovery"), ("i", "fault_injected"),
            ("i", "slo_breach")} <= {(e["ph"], e["name"]) for e in events}

