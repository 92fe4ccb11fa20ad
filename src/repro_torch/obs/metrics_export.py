"""Registry export: JSON snapshots, Prometheus text exposition, periodic
writes, and the one-line machine-readable summary the CLIs print.

A copy of the reference's ``repro/obs/metrics_export.py``. Snapshot
document shape (its key-path set is the schema two runs share):

    {"meta": {"label": ..., "schema": 2},
     "metrics": {"<name>": {"type": "counter", "value": ...}, ...}}

Metric names are dotted; the Prometheus exposition sanitizes them to
``[a-zA-Z0-9_]`` (dots -> underscores) per the text-format rules. Vector
metrics (per-bank series) export as LABELED Prometheus series
(``obs_bank_reads{bank="3"} 17.0``) rather than name-mangled flat gauges.

Schema history: 1 = counters/gauges/histograms only; 2 = added the
``vector_counter``/``vector_gauge`` snapshot shape (``{type, label,
values: [[index, value], ...]}``).
"""
from __future__ import annotations

import json
import re

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricRegistry,
                               VectorCounter, VectorGauge)

SNAPSHOT_SCHEMA_VERSION = 2
_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")


def snapshot_doc(registry: MetricRegistry, *, label: str = "") -> dict:
    """The full snapshot document. ``meta`` keys are FIXED (no timestamps,
    no argv) so the key-path schema is stable run to run."""
    return {"meta": {"label": label, "schema": SNAPSHOT_SCHEMA_VERSION},
            "metrics": registry.snapshot()}


def write_metrics_json(registry: MetricRegistry, path: str, *,
                       label: str = "") -> dict:
    doc = snapshot_doc(registry, label=label)
    with open(path, "w") as fh:
        json.dump(doc, fh, indent=2, sort_keys=True)
    return doc


def prometheus_text(registry: MetricRegistry) -> str:
    """Prometheus text exposition (the /metrics page body). Histograms emit
    the standard cumulative ``_bucket{le=...}`` series + ``_sum``/``_count``."""
    lines: list[str] = []
    for name in registry.names():
        m = registry.get(name)
        pname = _NAME_RE.sub("_", name)
        if m.help:
            lines.append(f"# HELP {pname} {m.help}")
        if isinstance(m, (VectorCounter, VectorGauge)):
            # labeled series, not name-mangled flat gauges: Prometheus has
            # no vector type, so the TYPE line reports the element kind
            kind = "counter" if isinstance(m, VectorCounter) else "gauge"
            lines.append(f"# TYPE {pname} {kind}")
            for i, v in enumerate(m.values):
                lines.append(f'{pname}{{{m.label}="{i}"}} {v!r}')
            continue
        lines.append(f"# TYPE {pname} {m.kind}")
        if isinstance(m, (Counter, Gauge)):
            lines.append(f"{pname} {m.value!r}")
        elif isinstance(m, Histogram):
            cum = 0
            for i, b in enumerate(m.bounds):
                cum += m.counts[i]
                lines.append(f'{pname}_bucket{{le="{b!r}"}} {cum}')
            lines.append(f'{pname}_bucket{{le="+Inf"}} {m.count}')
            lines.append(f"{pname}_sum {m.sum!r}")
            lines.append(f"{pname}_count {m.count}")
    return "\n".join(lines) + "\n"


def summary_dict(registry: MetricRegistry) -> dict:
    """Flat {name: value} view — counters/gauges report their value,
    histograms report {count, mean, p50, p99}. This is what the serve/train
    CLIs print as ONE machine-readable JSON line so CI contracts parse a
    dict instead of grepping free-form prints."""
    out: dict = {}
    for name in registry.names():
        m = registry.get(name)
        if isinstance(m, Histogram):
            out[name] = {"count": m.count, "mean": m.mean,
                         "p50": m.quantile(0.50), "p99": m.quantile(0.99)}
        elif isinstance(m, (VectorCounter, VectorGauge)):
            vals = m.values
            out[name] = {"sum": sum(vals), "max": max(vals),
                         "argmax": int(max(range(len(vals)),
                                           key=vals.__getitem__))}
        else:
            out[name] = m.value
    return out


def summary_line(registry: MetricRegistry, *, tag: str = "OBS_SUMMARY") -> str:
    """``OBS_SUMMARY {...}`` — grep the tag, json-parse the rest."""
    return f"{tag} {json.dumps(summary_dict(registry), sort_keys=True)}"


class PeriodicMetricsWriter:
    """Write the JSON snapshot every ``every`` batches (and once at the end
    via ``flush``). ``every=0`` disables the cadence — only ``flush`` writes.
    Writes are atomic-ish (tmp + rename) so a scraper never reads a torn
    file."""

    def __init__(self, registry: MetricRegistry, path: str, *,
                 every: int = 0, label: str = ""):
        self.registry = registry
        self.path = path
        self.every = int(every)
        self.label = label
        self.n_writes = 0

    def _write(self) -> None:
        import os
        tmp = f"{self.path}.tmp"
        write_metrics_json(self.registry, tmp, label=self.label)
        os.replace(tmp, self.path)
        self.n_writes += 1

    def maybe_write(self, batch: int) -> bool:
        """Call once per batch with the batch index; writes on cadence."""
        if self.every > 0 and batch > 0 and batch % self.every == 0:
            self._write()
            return True
        return False

    def flush(self) -> None:
        self._write()
