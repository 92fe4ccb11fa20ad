"""The port's stage spans (``repro_torch.obs.tracing``): off they are one
shared null context and record nothing; on (a tracer installed, or the
torch profiler recording) they carry parent and step ids, nest across
autograd's thread, land in the profiler's trace as ``repro_torch.*``
ranges, and time the device with CUDA events resolved only when read.
``dlrm.forward`` and ``build_train_step`` give their stages in order;
partitioning, ``plan_statics`` and the kernel build are set-up spans."""
import json
import threading
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.core.partitioning import (non_uniform_partition,
                                           uniform_partition)
from repro_torch.kernels import _build as B
from repro_torch.launch import train as TTRAIN
from repro_torch.models import dlrm as TD
from repro_torch.obs import tracing as T
from repro_torch.obs.trace_export import chrome_trace_events
from repro_torch.serve.serve_step import build_recsys_serve
from repro_torch.train import train_step as TT

FORWARD = ["dlrm.lookup", "dlrm.bot_mlp", "dlrm.interaction",
           "dlrm.top_mlp"]
TRAIN = ["train.forward", "train.backward", "train.clip",
         "train.optimizer"]


@pytest.fixture
def installed():
    tr = T.Tracer()
    before = T.install(tr)
    try:
        yield tr
    finally:
        T.install(before)


def _model(arch="updlrm-paper", n_banks=4):
    cfg = get_arch(arch).reduced
    plan = non_uniform_partition(
        np.random.default_rng(1).random(cfg.total_vocab) + 0.05, n_banks)
    params, statics = TD.init_params(cfg, torch.Generator().manual_seed(0),
                                     plan=plan, device="cpu")
    return cfg, params, statics


def _batch(cfg, b=6, seed=2):
    g = torch.Generator().manual_seed(seed)
    shape = (b, cfg.n_sparse) + ((cfg.multi_hot,) if cfg.multi_hot > 1
                                 else ())
    hi = torch.tensor(cfg.vocab_sizes)
    hi = hi.view(1, -1, *([1] * (len(shape) - 2)))
    sparse = (torch.rand(shape, generator=g) * hi).long().to(torch.int32)
    sparse[0, 0] = -1                                  # a padded entry
    return {"dense": torch.rand((b, cfg.n_dense), generator=g),
            "sparse": sparse,
            "label": (torch.rand(b, generator=g) < 0.5).float()}


def _kids(tr, rec):
    return [r.name for r in sorted(tr.children(rec), key=lambda r: r.ts_us)]


def test_off_is_one_null_context_and_records_nothing():
    assert T._installed is None and not torch.autograd.profiler \
        ._is_profiler_enabled
    tr = T.process_tracer()
    n = len(tr.records)
    cfg, params, statics = _model()
    a = T.stage("dlrm.lookup", like=torch.zeros(1))
    assert a is T.stage("train.step") is T.NULL_TRACER.span("x")
    with a as got:
        assert got is None
    build_recsys_serve(TD, cfg, statics)(params, _batch(cfg))
    assert all(r.name.startswith("setup.") for r in tr.records[n:])
    assert not any(r.name in FORWARD for r in tr.records[n:])


def test_ids_parents_steps_and_another_thread(installed):
    tr = installed
    ran = []

    def other():
        with T.stage("d"):
            ran.append(threading.get_ident())
    with T.stage("a"):
        with T.stage("b"):
            with T.stage("c2"):
                pass
            t = threading.Thread(target=other)
            t.start()
            t.join(timeout=30)
            assert not t.is_alive() and ran
    with T.stage("e"):
        pass
    by = {r.name: r for r in tr.records}
    a, b, c2, d, e = (by[k] for k in "a b c2 d e".split())
    assert a.parent is None and a.step == a.span_id and a.depth == 0
    assert b.parent == a.span_id and b.step == a.step and b.depth == 1
    assert c2.parent == b.span_id and c2.depth == 2
    # a thread with no open span of its own: the innermost open span of any
    assert d.parent == b.span_id and d.step == a.step and d.tid != a.tid
    assert e.parent is None and e.step == e.span_id != a.step
    assert len({r.span_id for r in tr.records}) == len(tr.records)
    assert not tr._open


def test_self_time_is_duration_less_the_childrens_union():
    tr = T.Tracer()
    R = T.SpanRecord
    tr.records = [R("p", 0.0, 100.0, 1, 0, {}, span_id=1),
                  R("c", 10.0, 20.0, 1, 1, {}, span_id=2, parent=1),
                  R("c", 20.0, 30.0, 1, 1, {}, span_id=3, parent=1),
                  R("c", 80.0, 40.0, 1, 1, {}, span_id=4, parent=1),
                  R("g", 12.0, 5.0, 1, 2, {}, span_id=5, parent=2)]
    p, c = tr.records[0], tr.records[1]
    # children cover [10, 50) and [80, 100): 60 of 100
    assert tr.self_us(p) == pytest.approx(40.0)
    assert tr.self_us(c) == pytest.approx(15.0)
    assert tr.self_us(tr.records[4]) == pytest.approx(5.0)
    assert [r.span_id for r in tr.children(p)] == [2, 3, 4]


class _FakeEvent:
    clock = [0.0]

    def __init__(self):
        self.t, self.waited = None, False

    def record(self):
        _FakeEvent.clock[0] += 1.5
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, other):
        return other.t - self.t


def test_cuda_events_are_recorded_and_resolved_when_read(installed,
                                                         monkeypatch):
    monkeypatch.setattr(T, "_event", _FakeEvent)
    monkeypatch.setattr(T, "_on_cuda", lambda like: like is not None)
    tr = installed
    with T.stage("outer", like=torch.zeros(1)):
        with T.stage("inner", like={"x": torch.zeros(1)}):
            pass
        with T.stage("host"):
            pass
    inner, host, outer = tr.records
    assert inner.events is not None and inner.device_ms is None
    assert host.events is None and tr.device_ms(host) is None
    e1 = inner.events[1]
    assert tr.device_ms(inner) == pytest.approx(1.5)
    assert e1.waited and inner.events is None
    assert tr.device_ms(inner) == pytest.approx(1.5)      # cached
    assert tr.device_ms(outer) == pytest.approx(4.5)
    ev = {e["name"]: e for e in chrome_trace_events(tr, pid=1)
          if e["ph"] == "X"}
    assert ev["inner"]["args"] == {"device_ms": pytest.approx(1.5)}
    assert ev["host"]["args"] == {}
    monkeypatch.undo()
    assert not T._on_cuda(torch.zeros(1)) and not T._on_cuda({})


def test_profiler_trace_holds_the_ranges_nested_as_the_records_say(
        tmp_path):
    cfg, params, statics = _model()
    serve = build_recsys_serve(TD, cfg, statics)
    opt = TT.default_optimizer()
    step = TT.build_train_step(
        lambda p, b: TD.loss_fn(cfg, p, statics, b), opt)
    state, batch = TT.TrainState.create(params, opt), _batch(cfg)
    tr = T.process_tracer()
    n = len(tr.records)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        serve(params, batch)
        step(state, batch)
    assert T.stage("x") is T._OFF                     # off again after it
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X"
              and e.get("name", "").startswith(T.PREFIX)]
    recs = tr.records[n:]
    assert {r.name for r in recs} == {"serve.step", "train.step",
                                      "lookup.backward", *FORWARD, *TRAIN}
    names = {e["name"][len(T.PREFIX):] for e in events}
    assert names == {r.name for r in recs}
    ids = {r.span_id: r for r in recs}

    def within(child, parent):
        return any(p["ts"] <= c["ts"] and c["ts"] + c["dur"]
                   <= p["ts"] + p["dur"] + 1e-3
                   for c in events if c["name"] == T.PREFIX + child
                   for p in events if p["name"] == T.PREFIX + parent)
    for r in recs:
        if r.parent is not None:
            assert within(r.name, ids[r.parent].name), r.name
    assert within("lookup.backward", "train.backward")
    del tr.records[n:]


def test_forward_and_train_step_give_their_stages_in_order(installed):
    tr = installed
    for arch in ("updlrm-paper", "dlrm-rm2"):
        cfg, params, statics = _model(arch)
        build_recsys_serve(TD, cfg, statics)(params, _batch(cfg))
        top = tr.spans("serve.step")[-1]
        assert _kids(tr, top) == FORWARD
        assert all(tr.device_ms(r) is None for r in tr.records)   # the CPU
    cfg, params, statics = _model()
    opt = TT.default_optimizer()
    step = TT.build_train_step(
        lambda p, b: TD.loss_fn(cfg, p, statics, b), opt)
    state = TT.TrainState.create(params, opt)
    for k in range(2):
        state, _ = step(state, _batch(cfg, seed=k))
    steps = tr.spans("train.step")
    assert len(steps) == 2 and steps[0].step != steps[1].step
    for s in steps:
        assert _kids(tr, s) == TRAIN
        fwd, bwd = (next(r for r in tr.children(s) if r.name == n)
                    for n in ("train.forward", "train.backward"))
        assert _kids(tr, fwd) == FORWARD
        assert _kids(tr, bwd) == ["lookup.backward"]
        assert all(r.step == s.span_id for r in tr.records
                   if r.parent in (s.span_id, fwd.span_id, bwd.span_id))
        assert tr.self_us(s) <= s.dur_us
    # no clip, no clip span
    step = TT.build_train_step(
        lambda p, b: TD.loss_fn(cfg, p, statics, b), opt, clip_norm=None)
    step(state, _batch(cfg))
    assert "train.clip" not in _kids(tr, tr.spans("train.step")[-1])


def test_setup_spans_always_record(monkeypatch):
    tr = T.process_tracer()
    assert T._installed is None
    n = len(tr.records)
    cfg = get_arch("updlrm-paper").reduced
    plan = uniform_partition(cfg.total_vocab, 4)
    non_uniform_partition(np.ones(cfg.total_vocab), 4)
    TD.plan_statics(cfg, plan, int(plan.max_rows_per_bank), device="cpu")

    def fake_build(names):
        for name in names:
            B._notify("build", name)
        return {}
    monkeypatch.setattr(B, "_build", fake_build)
    B.build(("banked_bag", "ct_scatter"))
    got = [(r.name, r.args) for r in tr.records[n:]]
    assert got == [("setup.plan", {}), ("setup.plan", {}),
                   ("setup.statics", {}),
                   ("setup.kernels", {"built": 2, "loaded": 0})]
    assert all(r.dur_us > 0 and r.events is None for r in tr.records[n:])
    assert not B._listeners
    del tr.records[n:]


def test_the_train_cli_installs_its_tracer_for_the_run(tmp_path):
    trace = tmp_path / "t.json"
    TTRAIN.main(["--arch", "updlrm-paper", "--device", "cpu", "--steps", "2",
                 "--batch", "3", "--trace-out", str(trace)])
    assert T._installed is None
    ev = [e for e in json.loads(trace.read_text())["traceEvents"]
          if e["ph"] == "X"]
    names = [e["name"] for e in ev]
    assert names.count("device_step") == names.count("train.step") == 2
    assert {"setup.plan", "setup.statics", "lookup.backward", *FORWARD,
            *TRAIN} - {"train.clip"} <= set(names)
    ds = [e for e in ev if e["name"] == "device_step"]
    for e in ev:
        if e["name"] == "train.step":
            assert any(d["ts"] <= e["ts"] and e["ts"] + e["dur"]
                       <= d["ts"] + d["dur"] for d in ds)


def test_no_helper_is_left_that_nothing_reads():
    assert not hasattr(T.Tracer, "total_us")
    assert not hasattr(T.Tracer, "span_names")
    assert isinstance(T.process_tracer(), T.Tracer)
    ns = types.SimpleNamespace(enabled=False)
    assert T.install(ns) is None and T._installed is None
