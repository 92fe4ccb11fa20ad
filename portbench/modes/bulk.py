"""Bulk scoring: a pool of ``pool_batches`` batches of ``batch`` samples
made on the device at set-up, each scored once as warm-up, then scored in
turn, back to back, dispatched ahead, until ``seconds`` have passed; the
window closes when the card has finished. Checked: the last scores of
every pool batch, whole."""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

from portbench import drive
from portbench.trace import Spans, profiled

# the controls whose readings set the limits' upper ends
CONTROLS = {"control": {"precision": "tf32"}}


def run(st, seconds: float, trace: bool, on_setup) -> SimpleNamespace:
    B = st.mix["batch"]
    batches = drive.pool(st, B)
    serve, params = st.prog.serve, st.prog.params
    outs = [serve(params, b) for b in batches]
    drive.sync(st.device)
    gc.collect()
    gc.freeze()
    on_setup()
    spans, clock, P = Spans(trace), drive.Clock(st.device), len(batches)
    with profiled(trace) as tr:
        with spans.span("window"):
            e0, t0, n = clock.mark(), time.perf_counter(), 0
            while True:
                with spans.span("serve_call"):
                    outs[n % P] = serve(params, batches[n % P])
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            e1 = clock.mark()
            with spans.span("sync"):
                drive.sync(st.device)
            t1 = time.perf_counter()
    gc.unfreeze()
    return SimpleNamespace(
        mode="bulk", steps=n, samples=n * B, window_s=t1 - t0,
        device_s=clock.seconds(e0, e1), summary=tr.summary, batch=B,
        used=[len(range(i, n, P)) for i in range(P)], batches=batches,
        outs=outs, attempted=n * B, failed=0)


def check(st, run, precision: str = "fp32") -> dict:
    """The widest gap between a served score and the reference's over
    every pool batch's last scores. Frees the program first.
    ``precision='tf32'`` is the control: the reference in TF32 put in the
    program's place."""
    drive.free(st)
    R = drive.load("reference", st.cfg["reference"])
    w = R.make_weights(st.cfg, st.seed, st.device)
    gap = 0.0
    for b, o in zip(run.batches, run.outs):
        ref = R.scores(st.cfg, w, b)
        got = (o.float() if precision == "fp32"
               else R.scores(st.cfg, w, b, precision))
        gap = max(gap, float((got - ref).abs().max()))
    return {"score_gap": gap}
