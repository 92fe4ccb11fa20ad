"""The check that decides ``correct``, on the CPU at small sizes: the
reference equals the port's plain path; a sound run is correct; the
control (the reference in TF32 in the program's place) and each fault the
cell can have, planted under the timed path, come out not correct."""
import pytest
import torch

from portbench import drive
from portbench import run as RUN
from portbench.reference import dlrm as R
from portbench.tests.small import CELLS, small_parts

SEED = 3_000_000_019


@pytest.mark.parametrize("cell", ["paper-bulk", "rm2-bulk"])
def test_reference_equals_the_port_plain_path(cell):
    p = small_parts(cell)
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    b = st.traffic.batch(SEED, 0, 256)
    got = st.prog.serve(st.prog.params, b)
    ref = R.scores(p.cfg, R.make_weights(p.cfg, SEED, "cpu"), b)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_reference_train_equals_the_port():
    p = small_parts("paper-train")
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    mode = drive.load("modes", "train")
    run = mode.run(st, 0.2, False, lambda: None)
    got = mode.check(st, run)
    assert max(got.values()) < 1e-5, got


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    out, lines = RUN.run_cell(cell, SEED, 0.3, False, device="cpu",
                              parts=small_parts(cell))
    assert out["correct"], lines
    assert list(out)[-1] == "checks"
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    p = small_parts(cell)
    mode = drive.load("modes", p.mix["mode"])
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    run = mode.run(st, 0.3, False, lambda: None)
    ctl = mode.check(st, run, **mode.CONTROLS["control"])
    assert any(v > p.limits[k] for k, v in ctl.items()), (ctl, p.limits)


def _broken(monkeypatch, fault):
    """Plant ``fault`` under the timed path of every program built."""
    build = drive.build

    def broken_build(*a, **k):
        st = build(*a, **k)
        prog = st.prog
        if fault == "answer":
            serve = prog.serve

            def altered(params, batch):
                out = serve(params, batch).clone()
                out[0] += 1e-3
                return out
            prog.serve = altered
        else:
            make = prog.train_step

            def train_step(opt):
                step, state = make(opt)
                calls = [0]

                def bad(s, batch):
                    calls[0] += 1
                    if fault == "half_batch":
                        h = batch["dense"].shape[0] // 2
                        return step(s, {k: v[:h] for k, v in batch.items()})
                    if fault == "unchanged_late" and calls[0] <= 3:
                        return step(s, batch)      # sound through set-up
                    _, m = step(s, batch)          # the state unchanged
                    return s, m
                return bad, state
            prog.train_step = train_step
        return st
    monkeypatch.setattr(drive, "build", broken_build)


@pytest.mark.parametrize("cell,fault", [
    ("paper-bulk", "answer"), ("rm2-bulk", "answer"),
    ("paper-train", "unchanged"),
    ("paper-train", "unchanged_late"), ("paper-train", "half_batch")])
def test_fault_is_not_correct(monkeypatch, cell, fault):
    _broken(monkeypatch, fault)
    out, lines = RUN.run_cell(cell, SEED, 0.3, False, device="cpu",
                              parts=small_parts(cell))
    assert not out["correct"], lines


def test_trace_summary():
    from portbench.trace import summarize
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window",
           "ts": 0, "dur": 100},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.feed",
           "ts": 10, "dur": 20},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 20},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 90,
           "dur": 30}]
    s = summarize({"traceEvents": ev})
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx(50e-6)      # [20, 60) and [90, 100)
    assert s.device_s("k") == pytest.approx(50e-6)
    assert s.gaps["feed"] == pytest.approx(20e-6)
    assert s.gaps["other"] == pytest.approx(30e-6)
    assert s.breakdown()["device_ops"][0] == ["k1", pytest.approx(30e-6)]
