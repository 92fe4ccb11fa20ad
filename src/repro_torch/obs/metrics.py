"""Latency percentiles (copied from the reference's ``repro/obs/metrics.py``;
the rest of that module, the metrics registry, is a later slice)."""
from __future__ import annotations


def empirical_percentile(xs, q: float) -> float:
    """Exact sample percentile, index convention ``s[min(len-1, int(q*len))]``
    — the convention MicroBatcher.p99 reports. Returns 0.0 for an empty
    sequence."""
    s = sorted(xs)
    if not s:
        return 0.0
    return float(s[min(len(s) - 1, int(q * len(s)))])


def empirical_p99(xs) -> float:
    return empirical_percentile(xs, 0.99)


def empirical_p50(xs) -> float:
    return empirical_percentile(xs, 0.50)
