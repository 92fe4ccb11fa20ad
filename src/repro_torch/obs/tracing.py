"""Host-side structured tracing: named spans (a copy of the reference's
``repro/obs/tracing.py``; its Chrome-trace exporter comes with a later
slice).

The serve/train loops are host-driven: every micro-batch is a sequence of
host stages (assemble/rewrite, jitted device step, telemetry, maybe a
replan+migrate+swap) and the p99 question is always "which stage did the
spike live in". ``Tracer.span`` times those stages with plain
``perf_counter`` reads; the records are Chrome trace events ('X' spans,
'i' instants, 'C' counters).

Contracts:

* **No device-sync side effects.** A span only reads the host clock. The
  caller decides where device work is forced (the serve loops synchronize
  the card at the device-step boundary); a span around an UN-synced launch
  measures launch cost, which is sometimes exactly what you want. Nothing
  here touches the device.
* **Near-zero when disabled.** ``Tracer(enabled=False)`` (or the shared
  ``NULL_TRACER``) short-circuits ``span`` to a no-yield-cost context
  manager, so instrumented code paths keep one shape whether or not a
  trace is wanted.
* **Thread-correct nesting.** The open-span stack is thread-local; records
  carry the thread id so a future background-planner thread shows up as its
  own Perfetto track.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time


@dataclasses.dataclass
class SpanRecord:
    """One completed span (Chrome trace 'X' event)."""

    name: str
    ts_us: float               # start, microseconds since the tracer epoch
    dur_us: float
    tid: int
    depth: int                 # nesting depth at start (0 = top level)
    args: dict


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


class Tracer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.records: list[SpanRecord] = []
        self.instants: list[InstantRecord] = []
        self.counters: list[CounterRecord] = []
        self._epoch = time.perf_counter()
        self._local = threading.local()
        self._lock = threading.Lock()

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    @contextlib.contextmanager
    def span(self, name: str, **args):
        """Time a host stage. Nestable; ``args`` land in the trace event's
        ``args`` payload (keep them small and JSON-serializable)."""
        if not self.enabled:
            yield
            return
        stack = self._stack()
        depth = len(stack)
        stack.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            stack.pop()
            rec = SpanRecord(name=name, ts_us=(t0 - self._epoch) * 1e6,
                             dur_us=(t1 - t0) * 1e6,
                             tid=threading.get_ident(), depth=depth,
                             args=dict(args))
            with self._lock:
                self.records.append(rec)

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

    # -- inspection helpers (tests, summaries) -------------------------------

    def span_names(self) -> set[str]:
        return {r.name for r in self.records}

    def spans(self, name: str) -> list[SpanRecord]:
        return [r for r in self.records if r.name == name]

    def total_us(self, name: str) -> float:
        """Summed duration of TOP-LEVEL-of-their-name spans. (Nested
        same-name spans would double-count; the serve loops don't nest
        same-name spans.)"""
        return sum(r.dur_us for r in self.records if r.name == name)


NULL_TRACER = Tracer(enabled=False)
