"""Host-side structured tracing: named spans, instants and counters (a copy
of the reference's ``repro/obs/tracing.py``), and the program's stage
spans.

The serve/train loops are host-driven: every micro-batch is a sequence of
host stages (assemble/rewrite, jitted device step, telemetry, maybe a
replan+migrate+swap) and the p99 question is always "which stage did the
spike live in". ``Tracer.span`` times those stages with plain
``perf_counter`` reads; the records are Chrome trace events ('X' spans,
'i' instants, 'C' counters).

Contracts:

* **No device-sync side effects.** A span reads the host clock, and a
  stage span on CUDA tensors also records two CUDA events on the current
  stream; nothing here synchronises. The caller decides where device work
  is forced (the serve loops synchronize the card at the device-step
  boundary); a span around an UN-synced launch measures launch cost, which
  is sometimes exactly what you want.
* **Near-zero when disabled.** ``Tracer(enabled=False)`` (or the shared
  ``NULL_TRACER``) short-circuits ``span`` to a shared null context, so
  instrumented code paths keep one shape whether or not a trace is wanted.
* **Nesting.** Every span carries its id, its parent's and a step id that
  all spans under one top-level span share. The open-span stack is
  thread-local and records carry the thread id; a span opened on a thread
  with no open span of its own is a child of the innermost span open on
  any thread (autograd runs the backward on its own thread while the
  caller waits inside ``train.backward``).
* **On the profiler's clock.** While the torch profiler records, every
  span also opens ``torch.profiler.record_function("repro_torch.<name>")``,
  so the spans sit in the profiler's trace beside the kernels they
  launched.

Stage spans. ``stage(name, like)`` marks a stage of the program's own
work (``serve.step``, ``dlrm.lookup``, ``train.backward``, ...) and
``setup_span(name)`` a set-up stage (``setup.plan``, ``setup.statics``,
``setup.kernels``). Both go to the process's tracer (``process_tracer``):
the one a CLI installed (``install``; ``obs.cli.setup_obs`` installs its
``--trace-out`` tracer), else a module-level one. A stage span is on only
while the profiler records or a tracer is installed: otherwise ``stage``
returns a shared null context. When ``like`` is a CUDA tensor (or a dict
whose first value is one), the span records a CUDA event at its start and
one at its end; ``Tracer.device_ms`` resolves them when read, after the
caller's own sync: on one in-order stream, the device time of the stage's
kernels. Set-up spans run a few times a process, read only the host clock
and are always on.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import threading
import time

import torch
from torch.autograd import profiler as _profiler

PREFIX = "repro_torch."


@dataclasses.dataclass
class SpanRecord:
    """One completed span (Chrome trace 'X' event)."""

    name: str
    ts_us: float               # start, microseconds since the tracer epoch
    dur_us: float
    tid: int
    depth: int                 # nesting depth at start (0 = top level)
    args: dict
    span_id: int = 0
    parent: int | None = None  # the enclosing span's ``span_id``
    step: int | None = None    # the top-level enclosing span's ``span_id``
    device_ms: float | None = None   # resolved by ``Tracer.device_ms``
    events: tuple | None = dataclasses.field(default=None, repr=False,
                                             compare=False)


@dataclasses.dataclass
class InstantRecord:
    """A point event (Chrome trace 'i' event) — swap landed, fault fired."""

    name: str
    ts_us: float
    tid: int
    args: dict


@dataclasses.dataclass
class CounterRecord:
    """A gauge sample (Chrome trace 'C' event) — per-bank traffic, rolling
    p99. Perfetto renders each ``values`` key as one series in a counter
    track named ``name``, so a time-series of these becomes a load lane."""

    name: str
    ts_us: float
    tid: int
    values: dict


def _event():
    return torch.cuda.Event(enable_timing=True)


def _on_cuda(like) -> bool:
    if isinstance(like, dict):
        like = next(iter(like.values()), None)
    return isinstance(like, torch.Tensor) and like.is_cuda


class _Span:
    """One open span of ``tracer``: the context manager that
    ``Tracer.span``, ``stage`` and ``setup_span`` return. Entering it gives
    its ``args`` dict, which the body may add to before it closes."""

    __slots__ = ("tracer", "name", "args", "like", "rf", "ev", "t0", "id",
                 "parent", "step", "depth")

    def __init__(self, tracer: "Tracer", name: str, args: dict, like=None):
        self.tracer, self.name, self.args, self.like = tracer, name, args, like

    def __enter__(self) -> dict:
        tr = self.tracer
        self.rf = None
        if _profiler._is_profiler_enabled:
            self.rf = torch.profiler.record_function(PREFIX + self.name)
            self.rf.__enter__()
        stack = tr._stack()
        with tr._lock:
            outer = stack[-1] if stack else (tr._open[-1] if tr._open
                                             else None)
            self.id = next(tr._ids)
            tr._open.append(self)
        self.parent = outer
        self.depth = 0 if outer is None else outer.depth + 1
        self.step = self.id if outer is None else outer.step
        stack.append(self)
        self.ev = None
        if self.like is not None and _on_cuda(self.like):
            self.ev = (_event(), _event())
            self.ev[0].record()
        self.t0 = time.perf_counter()
        return self.args

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        if self.ev is not None:
            self.ev[1].record()
        tr = self.tracer
        tr._stack().pop()
        rec = SpanRecord(
            name=self.name, ts_us=(self.t0 - tr._epoch) * 1e6,
            dur_us=(t1 - self.t0) * 1e6, tid=threading.get_ident(),
            depth=self.depth, args=dict(self.args), span_id=self.id,
            parent=None if self.parent is None else self.parent.id,
            step=self.step, events=self.ev)
        with tr._lock:
            tr._open.remove(self)
            tr.records.append(rec)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: list[SpanRecord] = []
        self.instants: list[InstantRecord] = []
        self.counters: list[CounterRecord] = []
        self._epoch = time.perf_counter()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._open: list[_Span] = []    # open spans of every thread

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def span(self, name: str, **args):
        """Time a host stage. Nestable; ``args`` land in the trace event's
        ``args`` payload (keep them small and JSON-serializable)."""
        if not self.enabled:
            return _OFF
        return _Span(self, name, args)

    def instant(self, name: str, **args) -> None:
        """Mark a point in time (a swap landing, a fault firing)."""
        if not self.enabled:
            return
        rec = InstantRecord(name=name,
                            ts_us=(time.perf_counter() - self._epoch) * 1e6,
                            tid=threading.get_ident(), args=dict(args))
        with self._lock:
            self.instants.append(rec)

    def counter(self, name: str, **values) -> None:
        """Sample a gauge time-series (Chrome 'C' event): one call per
        batch per track; each keyword becomes a series in the track."""
        if not self.enabled:
            return
        rec = CounterRecord(name=name,
                            ts_us=(time.perf_counter() - self._epoch) * 1e6,
                            tid=threading.get_ident(),
                            values={k: float(v) for k, v in values.items()})
        with self._lock:
            self.counters.append(rec)

    # -- reading the records -------------------------------------------------

    def spans(self, name: str) -> list[SpanRecord]:
        return [r for r in self.records if r.name == name]

    def children(self, rec: SpanRecord) -> list[SpanRecord]:
        return [r for r in self.records if r.parent == rec.span_id]

    def self_us(self, rec: SpanRecord) -> float:
        """``rec``'s duration less the part of it that its children cover
        (their union, clipped to ``rec``)."""
        a, b = rec.ts_us, rec.ts_us + rec.dur_us
        covered, end = 0.0, a
        for s, e in sorted((max(c.ts_us, a), min(c.ts_us + c.dur_us, b))
                           for c in self.children(rec)):
            s = max(s, end)
            if e > s:
                covered, end = covered + (e - s), e
        return rec.dur_us - covered

    def device_ms(self, rec: SpanRecord) -> float | None:
        """The device ms between the span's two CUDA events (None for a
        span that recorded none). Read it after the caller's sync: a pair
        still in flight is waited for here."""
        if rec.events is not None:
            e0, e1 = rec.events
            e1.synchronize()
            rec.device_ms, rec.events = e0.elapsed_time(e1), None
        return rec.device_ms


NULL_TRACER = Tracer(enabled=False)

_process = Tracer()
_installed: Tracer | None = None


def install(tracer: Tracer | None) -> Tracer | None:
    """Make ``tracer`` the process's tracer: stage spans go to it and are
    on. None (or a disabled tracer) uninstalls. Returns the tracer
    installed before."""
    global _installed
    before = _installed
    _installed = tracer if tracer is not None and tracer.enabled else None
    return before


def process_tracer() -> Tracer:
    """The installed tracer, else the module's own: where the stage and
    set-up spans are."""
    return _installed or _process


def stage(name: str, like=None, **args):
    """A stage span (see the module's docstring): a null context unless the
    profiler records or a tracer is installed. ``like``: a tensor (or a
    dict of them) of the stage's device; on CUDA the span times the stage
    on the device too."""
    if _installed is None and not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(_installed or _process, name, args, like)


def setup_span(name: str, **args):
    """A set-up span, always on, host clock only."""
    return _Span(_installed or _process, name, args)


def setup_stage(name: str):
    """Decorator: every call of the function is a ``setup_span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def traced(*a, **k):
            with setup_span(name):
                return fn(*a, **k)
        return traced
    return wrap
