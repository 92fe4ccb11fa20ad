"""Shared CLI wiring for the obs layer: the ``--trace-out`` /
``--metrics-out`` / ``--metrics-every`` flags and their setup/teardown, used
identically by ``repro_torch.launch.serve`` and ``repro_torch.launch.train``
(a copy of the reference's ``repro/obs/cli.py``).
"""
from __future__ import annotations

import argparse

from repro_torch.obs import tracing
from repro_torch.obs.metrics import (MetricRegistry, empirical_p50,
                                     empirical_p99)
from repro_torch.obs.metrics_export import (PeriodicMetricsWriter,
                                            summary_line, write_metrics_json)
from repro_torch.obs.trace_export import write_chrome_trace
from repro_torch.obs.tracing import NULL_TRACER, Tracer


def add_obs_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--trace-out", default=None, metavar="FILE.json",
                    help="write a Chrome-trace/Perfetto JSON of the host "
                         "pipeline stages (rewrite / device_step / migrate / "
                         "swap / recovery spans, and the program's serve.*, "
                         "train.*, dlrm.* and setup.* stages) to FILE")
    ap.add_argument("--metrics-out", default=None, metavar="FILE.json",
                    help="write the metrics-registry snapshot (counters, "
                         "gauges, latency histograms) to FILE at exit")
    ap.add_argument("--metrics-every", type=int, default=0, metavar="N",
                    help="with --metrics-out: also rewrite the snapshot "
                         "every N micro-batches/steps (0 = only at exit)")


def setup_obs(args, label: str):
    """(tracer, metrics, periodic_writer|None) from the obs CLI flags.
    Tracing is off (NULL_TRACER: spans are no-ops) unless --trace-out was
    given; then the tracer is installed as the process's
    (``tracing.install``), so the program's stage and set-up spans land in
    it too, until ``finalize_obs``. The registry always exists so
    producers need no guards."""
    tracer = Tracer() if args.trace_out else NULL_TRACER
    tracing.install(tracer)
    metrics = MetricRegistry()
    writer = None
    if args.metrics_out:
        writer = PeriodicMetricsWriter(metrics, args.metrics_out,
                                       every=args.metrics_every, label=label)
    return tracer, metrics, writer


def finalize_obs(args, tracer, metrics: MetricRegistry, writer,
                 latencies=None, prefix: str = "serve") -> None:
    """End-of-run: fold the latency percentiles into the registry, write the
    trace + final snapshot, and print the ONE machine-readable summary line
    (grep ``OBS_SUMMARY``, json-parse the rest)."""
    if latencies is not None:
        metrics.gauge(f"{prefix}.p50_ms").set(empirical_p50(latencies) * 1e3)
        metrics.gauge(f"{prefix}.p99_ms").set(empirical_p99(latencies) * 1e3)
    tracing.install(None)
    if args.trace_out:
        n = write_chrome_trace(tracer, args.trace_out)
        print(f"trace: {n} events -> {args.trace_out}")
    if writer is not None:
        writer.flush()
        print(f"metrics: {len(metrics.names())} series -> {args.metrics_out}")
    print(summary_line(metrics))


__all__ = ["add_obs_args", "setup_obs", "finalize_obs",
           "write_metrics_json"]
