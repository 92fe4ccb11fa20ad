"""Observability: for now only the latency percentiles the serve loop
reports (the metrics registry and tracing are ROADMAP queue 1 #14)."""
