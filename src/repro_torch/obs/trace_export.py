"""Chrome-trace / Perfetto JSON export for ``obs.tracing.Tracer`` (a copy of
the reference's ``repro/obs/trace_export.py``).

The output is the Trace Event Format's JSON-object form
(``{"traceEvents": [...], ...}``): complete ('X') events for spans, instant
('i') events for point marks, counter ('C') events for gauge time-series
(per-bank traffic lanes, rolling p99 — Perfetto draws each ``args`` key as
one series in a counter track), plus 'M' metadata events naming the process
and threads. Load it in Perfetto (ui.perfetto.dev -> Open trace file) or
``chrome://tracing`` as-is.
"""
from __future__ import annotations

import json

from repro_torch.obs.tracing import Tracer


def chrome_trace_events(tracer: Tracer, *, pid: int | None = None,
                        process_name: str = "repro_torch") -> list[dict]:
    """Tracer records -> trace-event dicts (metadata first, then spans in
    start-time order — deterministic for a deterministic run). A stage
    span timed on the card carries its ``device_ms`` among its args."""
    if pid is None:
        import os
        pid = os.getpid()
    tids = sorted({r.tid for r in tracer.records}
                  | {r.tid for r in tracer.instants}
                  | {r.tid for r in tracer.counters})
    events: list[dict] = [{
        "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
        "args": {"name": process_name},
    }]
    for i, tid in enumerate(tids):
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid,
                       "args": {"name": f"host-{i}" if i else "serve-loop"}})
    for r in sorted(tracer.records, key=lambda r: (r.ts_us, -r.dur_us)):
        ms = tracer.device_ms(r)
        events.append({"name": r.name, "cat": "host", "ph": "X",
                       "ts": r.ts_us, "dur": r.dur_us,
                       "pid": pid, "tid": r.tid,
                       "args": r.args if ms is None
                       else {**r.args, "device_ms": ms}})
    for r in sorted(tracer.instants, key=lambda r: r.ts_us):
        events.append({"name": r.name, "cat": "host", "ph": "i",
                       "ts": r.ts_us, "s": "t",
                       "pid": pid, "tid": r.tid, "args": r.args})
    for r in sorted(tracer.counters, key=lambda r: r.ts_us):
        events.append({"name": r.name, "cat": "counter", "ph": "C",
                       "ts": r.ts_us,
                       "pid": pid, "tid": r.tid, "args": r.values})
    return events


def write_chrome_trace(tracer: Tracer, path: str, *,
                       process_name: str = "repro_torch") -> int:
    """Write the Perfetto-loadable JSON object; returns the event count."""
    events = chrome_trace_events(tracer, process_name=process_name)
    doc = {"traceEvents": events, "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(doc, fh)
    return len(events)
