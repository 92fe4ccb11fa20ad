"""Host spans of the benchmark's own, and the reduction of a profiler trace
to what the per-layer readers take.

With ``--trace 0`` a span costs nothing (``Spans.span`` is a null
context). With ``--trace 1`` the window runs under ``torch.profiler``
(CPU and CUDA activity), each span is a ``record_function`` named
``portbench.<name>``, and the window itself is the span
``portbench.window``. The trace is exported as Chrome JSON to a temporary
file (``TMPDIR``), read back and deleted:

- device intervals: events of the categories ``kernel``, ``gpu_memcpy``
  and ``gpu_memset``, clipped to the window;
- ``busy_s``: the length of their union; ``window_s``: the window span's;
- ``idle_gaps``: the gaps between busy intervals inside the window, each
  put under the innermost ``portbench.*`` span that held the host at the
  gap's middle (``other`` where none did), summed by span;
- ``device_ops``: device time by name.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PREFIX = "portbench."


class Spans:
    """The benchmark's host spans: ``span(name)`` marks a stretch of host
    work in the trace (with tracing on) and nothing otherwise."""

    def __init__(self, on: bool):
        self.on = on

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(PREFIX + name)


@contextlib.contextmanager
def profiled(on: bool):
    """Runs the body under the profiler when ``on``; yields a holder whose
    ``summary`` is the reduced trace (None with tracing off)."""
    holder = type("Traced", (), {"summary": None})()
    if not on:
        yield holder
        return
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench-trace-")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.summary = summarize(json.load(f))
    finally:
        os.unlink(path)


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class TraceSummary:
    """Device time by name, busy and window seconds, idle gaps by span."""

    def __init__(self, ops: dict, busy_s: float, window_s: float,
                 gaps: dict):
        self.ops, self.busy_s, self.window_s = ops, busy_s, window_s
        self.gaps = gaps

    def device_s(self, pattern: str, exclude: str | None = None) -> float:
        """Device seconds of the events whose name matches ``pattern`` (a
        regular expression, searched) and not ``exclude``."""
        rx, ex = re.compile(pattern), exclude and re.compile(exclude)
        return sum(t for n, t in self.ops.items()
                   if rx.search(n) and not (ex and ex.search(n)))

    def breakdown(self) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in gaps]}


def summarize(trace: dict) -> TraceSummary:
    events = [e for e in trace.get("traceEvents", []) if e.get("ph") == "X"]
    windows = [e for e in events if e.get("name") == PREFIX + "window"
               and e.get("cat") in ("user_annotation", "cpu_op")]
    if not windows:
        raise RuntimeError("the trace holds no portbench.window span")
    w0 = min(e["ts"] for e in windows)
    w1 = max(e["ts"] + e["dur"] for e in windows)
    dev, ops = [], defaultdict(float)
    for e in events:
        if e.get("cat") not in _DEVICE_CATS:
            continue
        s, t = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if t <= s:
            continue
        dev.append((s, t))
        ops[e["name"]] += (t - s) * 1e-6
    busy = _union(dev)
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):])
                    for e in events
                    if e.get("cat") in ("user_annotation", "cpu_op")
                    and e.get("name", "").startswith(PREFIX)
                    and e["name"] != PREFIX + "window"))
    starts = [a for a, _, _ in spans]
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, t in zip(edges[0::2], edges[1::2]):
        if t <= s:
            continue
        mid, label = 0.5 * (s + t), "other"
        # the spans are flat: the latest one to start before the middle,
        # if it has not ended, is the one that held the host
        for i in range(bisect.bisect_right(starts, mid) - 1,
                       max(-1, bisect.bisect_right(starts, mid) - 9), -1):
            if spans[i][1] >= mid:
                label = spans[i][2]
                break
        gaps[label] += (t - s) * 1e-6
    return TraceSummary(dict(ops), sum(t - s for s, t in busy) * 1e-6,
                        (w1 - w0) * 1e-6, dict(gaps))
