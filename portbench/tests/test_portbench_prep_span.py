"""The reader of the backward scatter's prep span (``lookup_prep_ms.train``)
on hand-made records: ms a train step; None in a bulk run, without device
time, or where the port records no ``lookup.prep`` span (a port older
than the span)."""
from types import SimpleNamespace

import pytest

from portbench import drive, program_spans
from repro_torch.obs import tracing


def _tracer(names_ms):
    tr = tracing.Tracer()
    R = tracing.SpanRecord
    for i, (name, m) in enumerate(names_ms):
        tr.records.append(R("train.step", 100.0 * i, 90.0, 1, 0, {},
                            span_id=10 * i + 1, step=10 * i + 1))
        tr.records.append(R(name, 100.0 * i + 1, 20.0, 1, 1, {},
                            span_id=10 * i + 2, parent=10 * i + 1,
                            step=10 * i + 1, device_ms=m))
    return tr


def _ctx(mode):
    return SimpleNamespace(run=SimpleNamespace(mode=mode),
                           cfg={"model": "dlrm"})


def test_prep_reader_gives_ms_a_train_step(monkeypatch):
    read = drive.load("metrics", "lookup_prep_ms.train").read
    tr = _tracer([("lookup.prep", 5.0), ("lookup.prep", 6.0)])
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: tr)
    assert read(_ctx("train")) == pytest.approx(5.5)
    assert read(_ctx("bulk")) is None
    tr.records[-1].device_ms = None
    assert read(_ctx("train")) is None
    old = _tracer([("lookup.backward", 70.0)])
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: old)
    assert read(_ctx("train")) is None
