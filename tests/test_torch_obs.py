"""The port's observability (``core.hwmodel``, ``obs.slo``,
``obs.traffic.TrafficAccumulator``, ``obs.metrics_export``,
``obs.trace_export``, ``obs.cli``) against the JAX package's, on the CPU,
and the SLO lane in the adaptive loops: ``launch.serve.run_adaptive`` with
the count-driven ``max_share`` check armed against the reference's
``_main_adaptive`` loop driven from its own modules, breach for breach and
swap for swap.

All of these are numpy or stdlib on both sides, so they must agree exactly:
the same floats, the same documents, the same text.
"""
import argparse
import dataclasses
import io
import json
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding as JE
from repro.core import hwmodel as JH
from repro.core import partitioning as JP
from repro.models import dlrm as JD
from repro.obs import cli as JCLI
from repro.obs import metrics_export as JX
from repro.obs import slo as JSLO
from repro.obs import trace_export as JTX
from repro.obs import traffic as JTF
from repro.obs.metrics import MetricRegistry as JRegistry
from repro.obs.tracing import Tracer as JTracer
from repro.serve import serve_step as JS
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.core import hwmodel as TH
from repro_torch.launch import serve as TSERVE
from repro_torch.obs import cli as TCLI
from repro_torch.obs import metrics_export as TX
from repro_torch.obs import slo as TSLO
from repro_torch.obs import trace_export as TTX
from repro_torch.obs import traffic as TTF
from repro_torch.obs.metrics import MetricRegistry as TRegistry
from repro_torch.obs.tracing import Tracer as TTracer

SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
# the program's stage and set-up spans (``repro_torch.obs.tracing.stage``,
# ``setup_span``), which the reference has not
PORT_STAGES = {"serve.step", "dlrm.lookup", "dlrm.bot_mlp",
               "dlrm.interaction", "dlrm.top_mlp", "train.step",
               "train.forward", "train.backward", "train.clip",
               "train.optimizer", "lookup.backward", "setup.plan",
               "setup.statics", "setup.kernels"}


# ---------------------------------------------------------------------------
# core.hwmodel
# ---------------------------------------------------------------------------

def test_hwmodel_profiles_and_latencies_match_jax():
    for name in ("UPMEM", "TPUV5E", "CPU_HOST"):
        assert dataclasses.asdict(getattr(TH, name)) == \
            dataclasses.asdict(getattr(JH, name))
    for n in (1, 8, 31, 32, 33, 64, 500, 2048, 4096):
        assert TH.UPMEM.mram_read_latency(n) == \
            JH.UPMEM.mram_read_latency(n)
    assert TH.cpu_lookup_time(1e6, 128.0) == JH.cpu_lookup_time(1e6, 128.0)
    share = np.array([0.4, 0.3, 0.2, 0.1])
    for kw in (dict(n_banks=8), dict(per_bank_lookup_share=share),
               dict(n_banks=4, cache_hit_rate=0.3, cache_avg_group=3.0)):
        for n_c in (2, 8, 32):
            t = TH.embedding_stage_latency(batch_size=64, avg_reduction=80.0,
                                           n_c=n_c, **kw)
            j = JH.embedding_stage_latency(batch_size=64, avg_reduction=80.0,
                                           n_c=n_c, **kw)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.total == j.total
    for system in ("cpu", "hybrid", "fae", "updlrm"):
        kw = dict(batch_size=64, avg_reduction=100.0, n_tables=8, dim=32,
                  mlp_flops=2e6, cache_hit_rate=0.2, n_c=4)
        assert TH.system_inference_time(system, **kw) == \
            JH.system_inference_time(system, **kw)
    with pytest.raises(ValueError):
        TH.system_inference_time("gpu", batch_size=1, avg_reduction=1.0,
                                 n_tables=1, dim=8, mlp_flops=1.0)
    for args in ((256, 32, 8), (256, 32, 2), (16, 8, 8), (8, 64, 4)):
        assert TH.updlrm_layout(*args) == JH.updlrm_layout(*args)
    for kw in (dict(rows=1_000_000, cols=32, n_banks=256),
               dict(rows=20_000, cols=8, n_banks=64)):
        kw.update(batch_size=64, avg_reduction=80.0)
        assert TH.solve_uniform_tile(**kw) == JH.solve_uniform_tile(**kw)
    with pytest.raises(ValueError, match="needs more than"):
        TH.solve_uniform_tile(rows=10**9, cols=64, n_banks=2, batch_size=1,
                              avg_reduction=1.0)


# ---------------------------------------------------------------------------
# obs.slo
# ---------------------------------------------------------------------------

def test_slo_config_and_penalty_match_jax():
    for kw in (dict(), dict(p99_us=5.0), dict(max_share=0.2, window=3),
               dict(divergence=0.1)):
        assert TSLO.SLOConfig(**kw).enabled == JSLO.SLOConfig(**kw).enabled
    with pytest.raises(ValueError, match="window"):
        TSLO.SLOConfig(window=0)
    assert TSLO.CHECKS == JSLO.CHECKS
    for reads in ([0, 0, 0, 0], [5, 1, 1, 1], [1, 1, 1, 1], [0, 9, 3, 0]):
        np.testing.assert_array_equal(TSLO.hot_bank_penalty(reads, 4),
                                      JSLO.hot_bank_penalty(reads, 4))


def _scripted(mod, registry, tracer, cfg, script):
    breaches = []
    wd = mod.SLOWatchdog(cfg, n_banks=4, dim=8, metrics=registry,
                         tracer=tracer,
                         on_breach=lambda kind, info: breaches.append(
                             (kind, info["batch"], info["bank"],
                              info["value"], info["share"],
                              info["window_reads"].tolist())))
    fired = []
    for b, (wall, reads, proj) in enumerate(script):
        if proj is not None:
            wd.set_projection(proj)
        fired.append(wd.observe(b, wall_us=wall, reads=reads, batch_size=16))
    return fired, breaches, wd.breaches


@pytest.mark.parametrize("cfg", [dict(p99_us=900.0, window=3),
                                 dict(max_share=0.4, window=4),
                                 dict(divergence=0.05, window=2),
                                 dict(p99_us=500.0, max_share=0.3,
                                      divergence=0.01, window=3)])
def test_slo_watchdog_scripted_windows_match_jax(cfg):
    """Scripted windows: wall times over budget, a bank going hot, a
    projection that the measured shares betray; the same breaches at the
    same batches (each check cooling down for one window), the same
    registry series and the same trace instants."""
    rng = np.random.default_rng(9)
    script = []
    for b in range(30):
        reads = rng.integers(10, 20, 4)
        if 8 <= b < 20:
            reads[2] += 40                     # bank 2 runs hot
        wall = 1000.0 if b in (5, 6, 17, 25) else 100.0
        proj = 0.25 if b in (0, 12) else (0.5 if b == 22 else None)
        script.append((wall, reads, proj))
    script[3] = (100.0, np.zeros(4, np.int64), None)     # an empty batch
    tr, jr = TRegistry(), JRegistry()
    tt, jt = TTracer(), JTracer()
    t = _scripted(TSLO, tr, tt, TSLO.SLOConfig(**cfg), script)
    j = _scripted(JSLO, jr, jt, JSLO.SLOConfig(**cfg), script)
    assert t == j and t[2] >= 1
    assert tr.snapshot() == jr.snapshot()
    assert [(i.name, i.args) for i in tt.instants] == \
        [(i.name, i.args) for i in jt.instants]
    # cooldown: a check re-arms exactly one window after it fired
    batches = {}
    for kind, b, *_ in t[1]:
        if kind in batches:
            assert b - batches[kind] >= cfg["window"]
        batches[kind] = b


def test_traffic_accumulator_matches_jax():
    tr, jr = TRegistry(), JRegistry()
    t = TTF.TrafficAccumulator(tr, 4, row_nbytes=32)
    j = JTF.TrafficAccumulator(jr, 4, row_nbytes=32)
    rng = np.random.default_rng(2)
    for b in range(9):
        reads = rng.integers(0, 50, 4)
        nbytes = None if b % 2 else reads * 7
        if b == 4:
            reads = np.zeros(4, np.int64)
        assert t.update(reads, nbytes) == j.update(reads, nbytes)
    assert t.batches == j.batches == 9
    assert tr.snapshot() == jr.snapshot()


# ---------------------------------------------------------------------------
# the exporters and the CLI wiring
# ---------------------------------------------------------------------------

def _populate(reg):
    reg.counter("serve.requests_total", "completed requests").inc(37)
    reg.gauge("runtime.plan_imbalance", "max/mean").set(1.25)
    h = reg.histogram("serve.request_latency_ms", "latency")
    for v in (0.5, 1.0, 1.5, 40.0, 1e-3):
        h.observe(v)
    reg.vector_counter("obs.bank_reads", "reads", size=3).inc([4, 0, 9])
    reg.vector_gauge("obs.bank_depth", size=2).set([1.5, 2.0])
    reg.counter("fault.injected_total")
    return reg


def test_metrics_exporters_match_jax(tmp_path):
    t, j = _populate(TRegistry()), _populate(JRegistry())
    assert TX.snapshot_doc(t, label="x") == JX.snapshot_doc(j, label="x")
    assert TX.prometheus_text(t) == JX.prometheus_text(j)
    assert TX.summary_dict(t) == JX.summary_dict(j)
    assert TX.summary_line(t) == JX.summary_line(j)
    assert TX.summary_line(t, tag="X").startswith("X {")
    assert TX.SNAPSHOT_SCHEMA_VERSION == JX.SNAPSHOT_SCHEMA_VERSION == 2
    assert TX.write_metrics_json(t, str(tmp_path / "t.json"), label="l") == \
        JX.write_metrics_json(j, str(tmp_path / "j.json"), label="l")
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()
    w = TX.PeriodicMetricsWriter(t, str(tmp_path / "p.json"), every=3,
                                 label="p")
    wrote = [w.maybe_write(b) for b in range(8)]
    assert wrote == [False, False, False, True, False, False, True, False]
    assert w.n_writes == 2 and not (tmp_path / "p.json.tmp").exists()
    t.counter("serve.requests_total").inc()
    w.flush()
    doc = json.loads((tmp_path / "p.json").read_text())
    assert doc["meta"] == {"label": "p", "schema": 2}
    assert doc["metrics"]["serve.requests_total"]["value"] == 38
    assert TX.PeriodicMetricsWriter(t, str(tmp_path / "q.json")).maybe_write(
        5) is False


def _same_records(tracer_t, tracer_j):
    """Drive both tracers and then give both the same clock readings."""
    for tr in (tracer_t, tracer_j):
        with tr.span("device_step", batch=0):
            with tr.span("rewrite"):
                pass
        tr.instant("fault_injected", batch=2, event="bank 3 -> dead")
        tr.counter("bank_reads", bank0=3, bank1=4)
        with tr.span("recovery", dead=1):
            pass
    for recs in ("records", "instants", "counters"):
        for i, (a, b) in enumerate(zip(getattr(tracer_t, recs),
                                       getattr(tracer_j, recs))):
            for rec in (a, b):
                rec.ts_us = 10.0 * i + {"records": 0, "instants": 1,
                                        "counters": 2}[recs]
                rec.tid = 7
                if hasattr(rec, "dur_us"):
                    rec.dur_us = 5.0 - i


def test_chrome_trace_export_matches_jax(tmp_path):
    t, j = TTracer(), JTracer()
    _same_records(t, j)
    kw = dict(pid=1, process_name="p")
    assert TTX.chrome_trace_events(t, **kw) == JTX.chrome_trace_events(j, **kw)
    n = TTX.write_chrome_trace(t, str(tmp_path / "t.json"))
    doc = json.loads((tmp_path / "t.json").read_text())
    assert n == len(doc["traceEvents"]) == 7 and doc["displayTimeUnit"] == "ms"
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X", "i", "C"}
    assert doc["traceEvents"][0]["args"]["name"] == "repro_torch"


def test_obs_cli_matches_jax(tmp_path):
    """``add_obs_args`` parses the reference's flags; ``setup_obs`` gives no
    tracing without ``--trace-out`` and a writer with ``--metrics-out``;
    ``finalize_obs`` writes the same snapshot and prints the same summary
    line as the reference's on the same registry."""
    for mod in (TCLI, JCLI):
        ap = argparse.ArgumentParser()
        mod.add_obs_args(ap)
        a = ap.parse_args([])
        assert (a.trace_out, a.metrics_out, a.metrics_every) == (None, None, 0)
        tracer, reg, writer = mod.setup_obs(a, label="x")
        assert not tracer.enabled and writer is None
    outs, docs = [], []
    for mod, reg_cls in ((TCLI, TRegistry), (JCLI, JRegistry)):
        ap = argparse.ArgumentParser()
        mod.add_obs_args(ap)
        stem = "t" if mod is TCLI else "j"
        a = ap.parse_args(["--metrics-out", str(tmp_path / f"{stem}.json"),
                           "--metrics-every", "2"])
        tracer, reg, writer = mod.setup_obs(a, label="serve:x")
        assert writer is not None and writer.every == 2
        _populate(reg)
        buf = io.StringIO()
        with redirect_stdout(buf):
            mod.finalize_obs(a, tracer, reg, writer,
                             latencies=[0.001, 0.002, 0.004], prefix="serve")
        outs.append(buf.getvalue().replace(stem + ".json", "X.json"))
        docs.append(json.loads((tmp_path / f"{stem}.json").read_text()))
    assert outs[0] == outs[1] and "OBS_SUMMARY {" in outs[0]
    assert docs[0] == docs[1]
    assert docs[0]["metrics"]["serve.p99_ms"]["value"] == 4.0


# ---------------------------------------------------------------------------
# the SLO lane in the adaptive loops
# ---------------------------------------------------------------------------

def _jax_adaptive_slo(cfg, *, requests, batch, replan_every, seed, slo_args,
                      banks=8, capacity_slack=0.25, drift_rotate_every=512):
    """The reference's ``launch/serve.py _main_adaptive`` loop (the remap
    lane, jnp backend) with its ``_TrafficSLO``, driven from its own
    modules: the initial params, and per batch and per swap what the test
    compares."""
    from repro.launch.serve import _TrafficSLO
    from repro.obs.traffic import bank_read_counts
    from repro.workload import (AdaptiveEmbeddingRuntime, DriftConfig,
                                DriftingZipfTrace, ReplanConfig,
                                dlrm_drifting_batch, rows_from_sparse)
    V = cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    plan = JP.non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    offs = np.asarray(statics["field_offsets"])
    offs_j = jnp.asarray(offs)
    tracer, metrics = JTracer(), JRegistry()
    table = JE.BankedTable(packed=params["emb_packed"],
                           remap_bank=statics["remap_bank"],
                           remap_slot=statics["remap_slot"], n_banks=banks,
                           rows_per_bank=cap)
    runtime = AdaptiveEmbeddingRuntime(
        table, plan, ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                            check_every=replan_every),
        init_freq=np.ones(V), tracer=tracer, metrics=metrics)
    slo = _TrafficSLO(slo_args, metrics, tracer, banks=banks,
                      dim=cfg.embed_dim,
                      row_nbytes=params["emb_packed"].shape[-1] * 4,
                      runtime=runtime)

    @jax.jit
    def serve(params, remap_bank, remap_slot, batch):
        st = {**statics, "remap_bank": remap_bank, "remap_slot": remap_slot}
        logits = JD.forward(cfg, params, st, batch, backend="jnp")
        sparse = batch["sparse"]
        rows = jnp.where(sparse >= 0, sparse + offs_j[None, :, None], -1)
        return jax.nn.sigmoid(logits), bank_read_counts(remap_bank, rows,
                                                        banks)

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
    out = {"scores": [], "reads": [], "swaps": [], "breaches": []}
    n = [0]

    def run_batch():
        reqs, feats = mb.next_batch()
        p = {**params, "emb_packed": runtime.table.packed}
        scores, reads = serve(p, runtime.table.remap_bank,
                              runtime.table.remap_slot, feats)
        mb.complete(reqs)
        slo.after_step(n[0], reads, 0.0, batch)
        out["scores"].append(np.asarray(scores)[:len(reqs)])
        out["reads"].append(np.asarray(reads))
        n[0] += 1
        event = runtime.end_batch()
        if event is not None:
            slo.on_swap(runtime)
            out["swaps"].append(event)

    for rid in range(requests):
        mb.submit(JS.Request(rid=rid, features=one_request(rid)))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    out["metrics"] = metrics
    out["breaches"] = [(i.args["batch"], i.args["kind"])
                       for i in tracer.instants if i.name == "slo_breach"]
    return params, out


def test_run_adaptive_slo_lane_matches_jax_loop():
    """``run_adaptive`` on ``updlrm-paper`` reduced (96 requests at batch 8,
    drift checks every 5 batches) with ``max_share`` and ``divergence``
    armed on windows of 3: the reference's breaches at the same batches,
    each penalty arming the replanner's early drift check, so the same
    swaps at the same batches with the same imbalances; the same reads,
    ``obs.*`` and ``replanner.*`` series, scores within rtol 1e-5 /
    atol 1e-6."""
    kw = dict(requests=96, batch=8, replan_every=5, seed=2)
    jcfg = jax_get_arch("updlrm-paper").reduced
    args = types.SimpleNamespace(slo_p99_us=0.0, slo_max_share=0.16,
                                 slo_divergence=0.02, slo_window=3)
    jparams, want = _jax_adaptive_slo(jcfg, slo_args=args, **kw)
    spec = get_arch("updlrm-paper")
    reg = TRegistry()
    res = TSERVE.run_adaptive(
        spec, spec.reduced, device="cpu", backend="torch", metrics=reg,
        slo=TSERVE.SLOConfig(max_share=0.16, divergence=0.02, window=3),
        min_slo_breaches=1,
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"), **kw)
    assert [(e["batch"], e["kind"]) for e in res.slo_events] == \
        want["breaches"]
    assert {k for _, k in want["breaches"]} == {"hot_bank", "divergence"}
    assert [(e.batch, e.old_imbalance, e.new_imbalance, e.reason)
            for e in res.swaps] == \
        [(e.batch, e.old_imbalance, e.new_imbalance, e.reason)
         for e in want["swaps"]]
    # a breach's penalty arms an early drift check: some swap lands off the
    # every-5-batches cadence
    assert any(e.batch % 5 for e in res.swaps)
    for g, e in zip(res.reads, want["reads"]):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_allclose(res.scores.numpy(),
                               np.concatenate(want["scores"]), **SCORE_TOL)
    jsnap, tsnap = want["metrics"].snapshot(), reg.snapshot()
    for name, m in jsnap.items():
        if name.startswith(("obs.", "replanner.", "runtime.swaps")) \
                and not name.startswith("obs.slo_realized"):
            assert tsnap[name] == m, name
    assert set(tsnap) >= {n for n in jsnap if n.startswith("obs.")}


@pytest.mark.parametrize("lane", ["replicated", "cache_lane"])
def test_other_lanes_carry_the_slo_lane(lane):
    """The replica and cache lanes build the SLO lane too: the ``obs.*``
    family in their registry, a ``max_share`` breach reaching the
    replanner (``replanner.slo_penalties_total``), spans for the export."""
    spec = get_arch("updlrm-paper")
    reg, tracer = TRegistry(), TTracer()
    kw = dict(requests=48, batch=8, replan_every=100, device="cpu",
              slo=TSERVE.SLOConfig(max_share=0.13, window=2),
              min_slo_breaches=1, metrics=reg, tracer=tracer)
    if lane == "replicated":
        res = TSERVE.run_replicated(spec, spec.reduced, k_max=2, **kw)
    else:
        res = TSERVE.run_cached_adaptive(spec, spec.reduced, **kw)
    names = set(reg.names())
    assert {"obs.bank_reads", "obs.bank_bytes", "obs.bank_share",
            "obs.slo_breaches_total", "obs.slo_projected_share"} <= names
    assert reg.get("obs.bank_share").count == 6
    assert reg.get("replanner.slo_penalties_total").value == \
        len(res.slo_events) >= 1
    assert {"rewrite", "device_step"} <= {r.name for r in tracer.records}
    np.testing.assert_array_equal(
        np.asarray(reg.get("obs.bank_reads").values),
        np.sum(res.reads, axis=0))


@pytest.mark.parametrize("mode", [[], ["--adaptive"],
                                  ["--adaptive", "--partition",
                                   "cache_aware"]])
def test_train_metrics_snapshot_names_match_jax(mode, tmp_path, monkeypatch):
    """``launch.train --metrics-out`` on ``updlrm-paper`` reduced: the
    port's snapshot carries the reference's metric names (but its
    ``jax.*`` ones) for the plain loop and both adaptive partitions, with
    one ``train.step_ms`` sample a step, and the trace the reference's
    spans."""
    import sys

    from repro.launch import train as JTRAIN
    from repro_torch.launch import train as TTRAIN
    argv = ["--arch", "updlrm-paper", "--steps", "4", "--batch", "4",
            "--replan-every", "2", "--cache-refresh-every", "3", *mode]
    snaps = {}
    for side in ("t", "j"):
        out = [*argv, "--metrics-out", str(tmp_path / f"{side}.json"),
               "--trace-out", str(tmp_path / f"{side}_trace.json")]
        if side == "t":
            TTRAIN.main([*out, "--device", "cpu"])
        else:
            monkeypatch.setattr(sys, "argv", ["train", *out, "--backend",
                                              "jnp"])
            JTRAIN.main()
        snaps[side] = json.loads((tmp_path / f"{side}.json").read_text())
    t, j = snaps["t"]["metrics"], snaps["j"]["metrics"]
    assert set(t) == {n for n in j if not n.startswith("jax.")}
    assert snaps["t"]["meta"] == snaps["j"]["meta"]
    assert t["train.step_ms"]["count"] == 4
    for name in ("train.migrations_total", "train.cache_refreshes_total"):
        if name in j:
            assert t[name] == j[name], name
    names = {e["name"] for e in json.loads(
        (tmp_path / "t_trace.json").read_text())["traceEvents"]}
    want = {e["name"] for e in json.loads(
        (tmp_path / "j_trace.json").read_text())["traceEvents"]}
    # the port's runtime adds a ``cache_install`` span (its host breakdown),
    # and the installed tracer the program's stage and set-up spans
    assert want <= names <= want | {"cache_install"} | PORT_STAGES
    assert {"train.step", "train.forward", "train.backward",
            "train.optimizer"} <= names
