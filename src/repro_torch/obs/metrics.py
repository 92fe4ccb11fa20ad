"""Typed metrics: Counter / Gauge / Histogram behind a process-local registry
(a copy of the reference's ``repro/obs/metrics.py``, stdlib only).

Design constraints (why this is not "just a dict of floats"):

* **Dependency-free.** Producers live everywhere — the replanner and the
  runtime are numpy-only, the serve loop is latency-sensitive — so this
  module imports only the stdlib and an update is a couple of float adds
  under a lock.
* **Mergeable percentiles.** ``Histogram`` buckets observations into FIXED
  log-spaced bounds (the same bounds for every histogram by default), so
  p50/p99 come from bucket merges — two histograms from two processes
  combine exactly (``merge``), which stored-sample quantiles cannot do
  without shipping the samples.
* **Deterministic snapshots.** ``MetricRegistry.snapshot()`` is a plain dict
  with a FIXED key structure per metric type (no data-dependent keys),
  sorted by metric name, so two runs of the same configuration produce
  structurally identical documents. Producers create their metrics up
  front (get-or-create in ``__init__``), not lazily at event time, so a run
  where an event never fires still exports the counter at 0 instead of
  dropping the key.

``empirical_percentile`` is the ONE home of the sorted-index percentile
convention every latency report uses (``s[min(len-1, int(q*len))]``, the
reference's MicroBatcher convention).
"""
from __future__ import annotations

import json
import math
import threading


def log_bucket_bounds(lo_exp: int = -6, hi_exp: int = 9,
                      per_decade: int = 8) -> tuple[float, ...]:
    """Fixed log-spaced bucket upper bounds: ``10**(k/per_decade)`` covering
    [10**lo_exp, 10**hi_exp]. 8/decade => adjacent bounds 1.33x apart, so a
    bucket-derived percentile is within ~33% of the exact one — plenty for
    latency triage, and the bounds never depend on the data (mergeable)."""
    return tuple(10.0 ** (k / per_decade)
                 for k in range(lo_exp * per_decade, hi_exp * per_decade + 1))


DEFAULT_BUCKETS = log_bucket_bounds()


def empirical_percentile(xs, q: float) -> float:
    """Exact sample percentile, index convention ``s[min(len-1, int(q*len))]``
    — the convention MicroBatcher.p99 and every bench scenario gate on.
    Returns 0.0 for an empty sequence."""
    s = sorted(xs)
    if not s:
        return 0.0
    return float(s[min(len(s) - 1, int(q * len(s)))])


def empirical_p99(xs) -> float:
    return empirical_percentile(xs, 0.99)


def empirical_p50(xs) -> float:
    return empirical_percentile(xs, 0.50)


class Counter:
    """Monotone event count. ``inc`` rejects negative deltas — a counter that
    can go down is a gauge, and downstream rate math silently breaks on it."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name}: negative increment {n}")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self._value}


class Gauge:
    """Last-written value (queue depth, hit rate, live-bank count...)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        self._value += n

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": self.kind, "value": self._value}


class _VectorMetric:
    """Shared machinery for fixed-size per-index metrics (per-bank series).

    One metric, ``size`` elements; the snapshot rides the element detail as
    a list of ``[index, value]`` pairs — list elements collapse in the
    key-path schema (the Histogram ``buckets`` precedent), so the schema is
    stable for any ``size``. ``label`` names the index dimension for the
    Prometheus exposition (``name{bank="3"}``).
    """

    kind = "vector"

    def __init__(self, name: str, help: str = "", *, size: int,
                 label: str = "bank"):
        if size < 1:
            raise ValueError(f"vector metric {name}: size must be >= 1")
        self.name = name
        self.help = help
        self.size = int(size)
        self.label = label
        self._values = [0.0] * self.size
        self._lock = threading.Lock()

    def _coerce(self, values) -> list[float]:
        values = [float(v) for v in values]
        if len(values) != self.size:
            raise ValueError(f"vector metric {self.name}: got {len(values)} "
                             f"values for size {self.size}")
        return values

    @property
    def values(self) -> list[float]:
        return list(self._values)

    @property
    def total(self) -> float:
        return sum(self._values)

    def snapshot(self) -> dict:
        return {"type": self.kind, "label": self.label,
                "values": [[i, v] for i, v in enumerate(self._values)]}


class VectorCounter(_VectorMetric):
    """Monotone counts over a fixed index space (per-bank reads/bytes);
    ``inc`` takes a full-length vector of non-negative deltas."""

    kind = "vector_counter"

    def inc(self, deltas) -> None:
        deltas = self._coerce(deltas)
        if any(d < 0 for d in deltas):
            raise ValueError(f"counter {self.name}: negative increment")
        with self._lock:
            for i, d in enumerate(deltas):
                self._values[i] += d


class VectorGauge(_VectorMetric):
    """Last-written vector (per-bank queue depth, live-copy counts...)."""

    kind = "vector_gauge"

    def set(self, values) -> None:
        values = self._coerce(values)
        with self._lock:
            self._values = values

    def inc(self, deltas) -> None:
        deltas = self._coerce(deltas)
        with self._lock:                 # gauges may go down
            for i, d in enumerate(deltas):
                self._values[i] += d


class Histogram:
    """Fixed-bound log-bucket histogram.

    ``counts[i]`` holds observations in ``(bounds[i-1], bounds[i]]``
    (``(-inf, bounds[0]]`` for i=0) plus one overflow bucket past the last
    bound. Quantiles walk the cumulative counts and answer the bucket's
    UPPER bound clamped into [min, max] observed — conservative (never
    under-reports a latency) and exact at the extremes.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = "",
                 bounds: tuple[float, ...] = DEFAULT_BUCKETS):
        if list(bounds) != sorted(bounds) or len(bounds) < 1:
            raise ValueError(f"histogram {name}: bounds must be sorted")
        self.name = name
        self.help = help
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)     # +1 overflow
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self._lock = threading.Lock()

    def _bucket_of(self, v: float) -> int:
        import bisect
        return bisect.bisect_left(self.bounds, v)

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.counts[self._bucket_of(v)] += 1
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)

    def merge(self, other: "Histogram") -> None:
        """Fold ``other`` into self. Requires identical bounds — the whole
        point of fixed buckets is that merges are exact."""
        if other.bounds != self.bounds:
            raise ValueError(f"histogram {self.name}: cannot merge differing "
                             f"bucket bounds")
        with self._lock:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.count += other.count
            self.sum += other.sum
            self.min = min(self.min, other.min)
            self.max = max(self.max, other.max)

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile (upper bound of the covering bucket,
        clamped to the observed [min, max])."""
        if self.count == 0:
            return 0.0
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= rank and c > 0:
                ub = self.bounds[i] if i < len(self.bounds) else self.max
                return float(min(max(ub, self.min), self.max))
        return float(self.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self) -> dict:
        # fixed key structure (schema-stable); the per-bucket detail rides as
        # a list of [upper_bound, count] pairs — list elements collapse in
        # the key-path schema, so a different set of populated buckets never
        # reads as schema drift
        return {
            "type": self.kind, "count": self.count, "sum": self.sum,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "mean": self.mean,
            "p50": self.quantile(0.50), "p99": self.quantile(0.99),
            "buckets": [[self.bounds[i] if i < len(self.bounds) else math.inf,
                         c]
                        for i, c in enumerate(self.counts) if c > 0],
        }


class MetricRegistry:
    """Process-local, get-or-create home for named metrics.

    Names are dotted strings (``serve.degraded_reads_total``); the registry
    enforces one TYPE per name (a counter re-registered as a gauge is a bug,
    not a merge). ``snapshot()`` sorts by name so the exported document is
    deterministic for a deterministic run.
    """

    def __init__(self):
        self._metrics: dict[str, object] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name: str, help: str, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  bounds: tuple[float, ...] = DEFAULT_BUCKETS) -> Histogram:
        return self._get_or_create(Histogram, name, help, bounds=bounds)

    def vector_counter(self, name: str, help: str = "", *, size: int,
                       label: str = "bank") -> VectorCounter:
        return self._get_or_create(VectorCounter, name, help, size=size,
                                   label=label)

    def vector_gauge(self, name: str, help: str = "", *, size: int,
                     label: str = "bank") -> VectorGauge:
        return self._get_or_create(VectorGauge, name, help, size=size,
                                   label=label)

    def get(self, name: str):
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    def snapshot(self) -> dict:
        """{name: metric.snapshot()} sorted by name — the document the JSON
        exporter writes and the CI schema gate checks."""
        return {name: self._metrics[name].snapshot()
                for name in sorted(self._metrics)}

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True)
