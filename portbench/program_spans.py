"""The port's own stage spans, read through its process tracer, which the
configuration's model adapter gives (``tracer()`` in
``portbench/models/<model>.py``).

The port records a stage span (``serve.step``, ``dlrm.lookup``,
``train.optimizer``, ...) while the torch profiler records, which in a
run is the traced window alone: warm-up, the checked steps and the end
check are left out. On the card each span carries its device time (CUDA
events on the stream, read here after the window's sync). A stage's ms a
step is its device ms summed over the window's spans, over the number of
the window's step spans (``serve.step`` in the bulk mode, ``train.step``
in the train mode). Set-up spans (``setup.plan``, ...) are always
recorded and read the host clock.

Each reader returns None where the records are absent: a run in another
mode, a stage with no span, a span with no device time (the CPU), an
adapter with no tracer, or a port whose tracer has no process tracer
(older than its stage spans).
"""
from __future__ import annotations

from portbench import drive

STEP = {"bulk": "serve.step", "train": "train.step"}


def tracer(ctx):
    """The process tracer of the program that ``ctx``'s configuration
    names, or None."""
    get = getattr(drive.load("models", ctx.cfg["model"]), "tracer", None)
    return None if get is None else get()


def stage_ms(ctx, name: str, mode: str) -> float | None:
    """Device ms a step of the stage span ``name`` in a ``mode`` run."""
    if ctx.run.mode != mode:
        return None
    tr = tracer(ctx)
    if tr is None:
        return None
    steps, spans = tr.spans(STEP[mode]), tr.spans(name)
    if not steps or not spans:
        return None
    ms = [tr.device_ms(r) for r in spans]
    if any(m is None for m in ms):
        return None
    return sum(ms) / len(steps)


def host_s(ctx, name: str) -> float | None:
    """Host seconds of every span ``name`` (a set-up stage), summed."""
    tr = tracer(ctx)
    spans = [] if tr is None else tr.spans(name)
    if not spans:
        return None
    return sum(r.dur_us for r in spans) * 1e-6
