"""The readers of the port's stage spans (``portbench/program_spans.py``
and the metrics that use it), on hand-made records: ms a step, host
seconds of set-up; None where the records are absent, the mode differs,
a span has no device time, the port has no process tracer, or the
configuration's model adapter gives no tracer."""
from types import SimpleNamespace

import pytest

from portbench import drive, program_spans
from repro_torch.obs import tracing

STAGES = {"lookup_ms.bulk": ("bulk", "dlrm.lookup"),
          "interact_ms.bulk": ("bulk", "dlrm.interaction"),
          "bot_mlp_ms.bulk": ("bulk", "dlrm.bot_mlp"),
          "top_mlp_ms.bulk": ("bulk", "dlrm.top_mlp"),
          "fwd_ms.train": ("train", "train.forward"),
          "bwd_ms.train": ("train", "train.backward"),
          "lookup_bwd_ms.train": ("train", "lookup.backward"),
          "optim_ms.train": ("train", "train.optimizer")}


def _tracer(steps: int, step_name: str, name: str, ms):
    tr = tracing.Tracer()
    R = tracing.SpanRecord
    for i in range(steps):
        tr.records.append(R(step_name, 100.0 * i, 90.0, 1, 0, {},
                            span_id=10 * i + 1, step=10 * i + 1))
    for i, m in enumerate(ms):
        tr.records.append(R(name, 100.0 * i + 1, 20.0, 1, 1, {},
                            span_id=10 * i + 2, parent=10 * i + 1,
                            step=10 * i + 1, device_ms=m))
    tr.records.append(R("setup.plan", 0.0, 2.5e6, 1, 0, {}, span_id=999))
    return tr


def _ctx(mode):
    return SimpleNamespace(run=SimpleNamespace(mode=mode),
                           cfg={"model": "dlrm"})


@pytest.mark.parametrize("metric", sorted(STAGES))
def test_stage_reader_gives_ms_a_step(monkeypatch, metric):
    mode, name = STAGES[metric]
    other = "train" if mode == "bulk" else "bulk"
    read = drive.load("metrics", metric).read
    tr = _tracer(4, program_spans.STEP[mode], name, [1.0, 2.0, 3.0, 4.5])
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: tr)
    assert read(_ctx(mode)) == pytest.approx(10.5 / 4)
    assert read(_ctx(other)) is None
    # a stage spanned twice in some steps still counts by the step spans
    tr.records.append(tracing.SpanRecord(name, 5.0, 1.0, 1, 1, {},
                                         span_id=77, parent=1, step=1,
                                         device_ms=1.5))
    assert read(_ctx(mode)) == pytest.approx(12.0 / 4)
    # a span without device time (the CPU): no reading
    tr.records[-1].device_ms = None
    assert read(_ctx(mode)) is None
    # no step spans, or no stage spans
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: _tracer(
        0, program_spans.STEP[mode], name, [1.0]))
    assert read(_ctx(mode)) is None
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: _tracer(
        3, program_spans.STEP[mode], "other.stage", [1.0]))
    assert read(_ctx(mode)) is None


def test_plan_s_sums_the_set_up_spans(monkeypatch):
    read = drive.load("metrics", "plan_s").read
    tr = _tracer(1, "serve.step", "dlrm.lookup", [1.0])
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: tr)
    assert read(_ctx("bulk")) == pytest.approx(2.5)
    assert read(_ctx("train")) == pytest.approx(2.5)
    tr.records.append(tracing.SpanRecord("setup.plan", 0.0, 5e5, 1, 0, {}))
    assert read(_ctx("bulk")) == pytest.approx(3.0)
    monkeypatch.setattr(program_spans, "tracer",
                        lambda ctx: tracing.Tracer())
    assert read(_ctx("bulk")) is None


def test_a_port_without_a_process_tracer_reads_none(monkeypatch):
    monkeypatch.delattr(tracing, "process_tracer")
    assert program_spans.tracer(_ctx("bulk")) is None
    for metric, (mode, _) in STAGES.items():
        assert drive.load("metrics", metric).read(_ctx(mode)) is None
    assert drive.load("metrics", "plan_s").read(_ctx("bulk")) is None


def test_the_process_tracer_is_read():
    assert program_spans.tracer(_ctx("bulk")) is tracing.process_tracer()


def test_an_adapter_without_a_tracer_reads_none(monkeypatch, tmp_path):
    (tmp_path / "models").mkdir()
    (tmp_path / "models" / "quiet.py").write_text("X = 1\n")
    monkeypatch.setattr(drive, "HERE", tmp_path)
    ctx = SimpleNamespace(run=SimpleNamespace(mode="bulk"),
                          cfg={"model": "quiet"})
    assert program_spans.tracer(ctx) is None
    assert program_spans.stage_ms(ctx, "dlrm.lookup", "bulk") is None
    assert program_spans.host_s(ctx, "setup.plan") is None
