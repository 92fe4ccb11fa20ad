"""Observability: latency percentiles, the typed metrics registry and
host-side tracing (framework-free copies of the reference's ``repro/obs``),
and the per-bank traffic counters of the tiered lookup (``obs.traffic``,
torch). The exporters and the SLO watchdog are ROADMAP queue 1 #14."""
from repro_torch.obs.metrics import (Counter, Gauge, Histogram,
                                     MetricRegistry, VectorCounter,
                                     VectorGauge, empirical_p50,
                                     empirical_p99, empirical_percentile)
from repro_torch.obs.tracing import NULL_TRACER, Tracer

__all__ = ["Counter", "Gauge", "Histogram", "MetricRegistry", "NULL_TRACER",
           "Tracer", "VectorCounter", "VectorGauge", "empirical_p50",
           "empirical_p99", "empirical_percentile"]
