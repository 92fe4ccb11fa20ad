"""Workloads for the port: drifting request traces (numpy)."""
