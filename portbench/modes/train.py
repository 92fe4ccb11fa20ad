"""Training: the train step and its state built once. Its first steps
(``check_steps``, each on another pool batch) are set-up and are what the
reference follows from the seed; the window continues the same state on
the pool in turn, back to back, until ``seconds`` have passed.

Checked, against the plain reference:

- the first steps: step 1's loss, each leaf's gradient as the optimizer
  got it (from its state after step 1), each leaf's change after the
  first steps;
- the window's end: once the window has closed, the same step takes one
  more step from the window's last state on the next pool batch, and the
  reference takes that step from the same state (the program's state,
  copied into the reference's terms: it cannot follow the window's
  hundred-odd steps itself in the time a check has). Compared: that step's
  loss, each MLP leaf's gradient and each leaf's change.
"""
from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import torch

from portbench import drive
from portbench.trace import Spans, profiled

# the controls whose readings set the limits' upper ends: the reference in
# TF32 in the program's place, and the reference that leaves out half of
# each batch
CONTROLS = {"control": {"precision": "tf32"},
            "half_batch": {"half_batch": True}}


def run(st, seconds: float, trace: bool, on_setup) -> SimpleNamespace:
    B, opt = st.mix["batch"], st.cfg["optimizer"]
    batches = drive.pool(st, B)
    step, state = st.prog.train_step(opt)
    k0 = st.mix["check_steps"]
    if k0 >= len(batches):
        raise ValueError("check_steps must be below pool_batches: the "
                         "checked steps take batches that all differ")
    model = st.model
    p0 = {k: t.clone() for k, t in model.param_leaves(state.params).items()}
    losses, probe = [], None
    for k in range(k0):
        state, m = step(state, batches[k])
        losses.append(float(m["loss"]))
        if k == 0:
            probe = model.train_probe(state, st.cfg, opt)
    p1 = model.param_leaves(state.params)
    change = {n: norm(p1[n] - p0[n]) for n in p0}
    del p0, p1
    drive.sync(st.device)
    gc.collect()
    gc.freeze()
    on_setup()
    spans, clock, P = Spans(trace), drive.Clock(st.device), len(batches)
    with profiled(trace) as tr:
        with spans.span("window"):
            e0, t0, n = clock.mark(), time.perf_counter(), 0
            while True:
                with spans.span("train_call"):
                    state, _ = step(state, batches[(k0 + n) % P])
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            e1 = clock.mark()
            with spans.span("sync"):
                drive.sync(st.device)
            t1 = time.perf_counter()
    gc.unfreeze()
    used = [0] * P
    for j in range(n):
        used[(k0 + j) % P] += 1
    return SimpleNamespace(
        mode="train", steps=n, samples=n * B, window_s=t1 - t0,
        device_s=clock.seconds(e0, e1), summary=tr.summary, batch=B,
        used=used, batches=batches, next_batch=(k0 + n) % P,
        first={"losses": losses, "grad": probe, "change": change},
        step=step, state=state, end=None, ref=None, attempted=n * B,
        failed=0)


def end_step(st, run) -> dict:
    """One more program step from the window's last state: the state it
    started from (in the reference's terms), its loss, each MLP leaf's
    gradient norm as the optimizer got it and each leaf's change."""
    b1 = st.cfg["optimizer"]["dense"]["b1"]
    pre = st.model.reference_state(run.state, st.prog)
    state, m = run.step(run.state, run.batches[run.next_batch])
    post = st.model.reference_state(state, st.prog)
    run.state = state = None
    # Adam's leaves' gradients only: the table's cannot be read back from
    # Adagrad's fp32 accumulator here, whose increment after the first
    # steps' large gradients lies under its rounding for the hot rows
    grad = {n: norm((post["m"][n] - b1 * pre["m"][n]) / (1 - b1))
            for n in pre["m"]}
    R = drive.load("reference", st.cfg["reference"])
    before, after = dict(R.leaves(pre["w"])), dict(R.leaves(post["w"]))
    change = {n: norm(after[n] - before[n]) for n in before}
    return {"pre": pre, "losses": [float(m["loss"])], "grad": grad,
            "change": change}


def _half(b: dict) -> dict:
    h = b["dense"].shape[0] // 2
    return {k: v[:h] for k, v in b.items()}


def norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def median(xs) -> float:
    s = sorted(xs)
    return s[len(s) // 2] if len(s) % 2 else 0.5 * (s[len(s) // 2 - 1]
                                                    + s[len(s) // 2])


def _steps(R, tr, batches, half_batch: bool) -> dict:
    """The reference ``R``'s steps on ``batches`` by its trainer ``tr``:
    losses, the first step's gradient norms, each leaf's change over
    them."""
    w0 = {n: t.clone() for n, t in R.leaves(tr.w)}
    losses, grad = [], None
    for k, b in enumerate(batches):
        losses.append(tr.step(_half(b) if half_batch else b))
        if k == 0:
            grad = {n: norm(g) for n, g in tr.grads.items()}
    w1 = dict(R.leaves(tr.w))
    return {"losses": losses, "grad": grad,
            "change": {n: norm(w1[n] - w0[n]) for n in w0}}


def reference(st, run, precision: str = "fp32", half_batch: bool = False
              ) -> tuple[dict, dict]:
    """The reference's first steps from the seed's weights, and its step
    from the program's state at the window's end."""
    k0 = st.mix["check_steps"]
    R = drive.load("reference", st.cfg["reference"])
    w = R.make_weights(st.cfg, st.seed, st.device)
    first = _steps(R, R.Trainer(st.cfg, w, precision), run.batches[:k0],
                   half_batch)
    del w
    end = _steps(R, R.Trainer.resume(st.cfg, run.end["pre"], precision),
                 [run.batches[run.next_batch]], half_batch)
    return first, end


def compare(got: dict, ref: dict, names: tuple[str, str, str],
            graded) -> dict:
    """The numbers compared (``names`` gives theirs), each a worst case:

    - the loss gap: |loss - ref| / |ref| of the first step taken (the later
      of the first steps follow an update that throws the loss from ~0.7
      to ~20, and their losses swing with rounding);
    - the gradient gap: per leaf of ``graded``, | |g| - |g_ref| | over the
      larger of |g_ref| and the median leaf's |g_ref|;
    - the change gap: the same of each leaf's change, over the leaves whose
      reference gradient is at least a thousandth of the median leaf's."""
    rg, pg = ref["grad"], got["grad"]
    gmed = median(rg.values())
    leaves = [n for n in rg if n in graded]
    moved = [n for n in rg if rg[n] >= 1e-3 * gmed]
    cmed = median(ref["change"][n] for n in moved)
    loss, grad, change = names
    return {
        loss: rel(got["losses"][0], ref["losses"][0]),
        grad: max(abs(pg[n] - rg[n]) / max(rg[n], gmed) for n in leaves),
        change: max(abs(got["change"][n] - ref["change"][n])
                    / max(ref["change"][n], cmed) for n in moved)}


def check(st, run, precision: str = "fp32", half_batch: bool = False
          ) -> dict:
    """The program's first steps and its step from the window's end
    against the reference's. With ``precision='tf32'`` (the control) or
    ``half_batch`` (a fault) the reference so computed stands in the
    program's place."""
    if run.end is None:
        run.end = end_step(st, run)
    drive.free(st)
    if run.ref is None:
        run.ref = reference(st, run)
    if precision == "fp32" and not half_batch:
        got = (run.first, run.end)
    else:
        got = reference(st, run, precision, half_batch)
    mlp = set(run.end["grad"])
    return {**compare(got[0], run.ref[0],
                      ("loss1_gap", "grad_gap", "change_gap"), set(
                          run.ref[0]["grad"])),
            **compare(got[1], run.ref[1],
                      ("end_loss_gap", "end_grad_gap", "end_change_gap"),
                      mlp)}
