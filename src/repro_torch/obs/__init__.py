"""Observability (framework-free copies of the reference's ``repro/obs``):
latency percentiles and the typed metrics registry (``metrics``), host-side
tracing (``tracing``) with its Chrome-trace export (``trace_export``), JSON
snapshots, Prometheus text and the one-line summary (``metrics_export``),
and the CLIs' ``--trace-out`` / ``--metrics-out`` wiring (``cli``).

Two submodules are not re-exported here, as in the reference — import them
directly: ``obs.traffic`` (the per-bank traffic counters, torch, and the
``TrafficAccumulator`` registry bridge) and ``obs.slo`` (the rolling-window
SLO watchdog, numpy + ``core.hwmodel``).
"""
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricRegistry,
                                     VectorCounter, VectorGauge,
                                     empirical_p50, empirical_p99,
                                     empirical_percentile, log_bucket_bounds)
from repro_torch.obs.metrics_export import (PeriodicMetricsWriter,
                                            prometheus_text, snapshot_doc,
                                            summary_dict, summary_line,
                                            write_metrics_json)
from repro_torch.obs.trace_export import (chrome_trace_events,
                                          write_chrome_trace)
from repro_torch.obs.tracing import NULL_TRACER, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricRegistry", "DEFAULT_BUCKETS",
    "VectorCounter", "VectorGauge",
    "empirical_p50", "empirical_p99", "empirical_percentile",
    "log_bucket_bounds",
    "PeriodicMetricsWriter", "prometheus_text", "snapshot_doc",
    "summary_dict", "summary_line", "write_metrics_json",
    "chrome_trace_events", "write_chrome_trace",
    "NULL_TRACER", "Tracer",
]
