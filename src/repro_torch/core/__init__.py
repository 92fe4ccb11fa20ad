"""Partitioning, GRACE mining and the cache runtime (numpy); the banked
embedding lookup (torch)."""
