"""Synthetic workloads (numpy, deterministic in (seed, step))."""
