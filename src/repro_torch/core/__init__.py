"""Partitioning (numpy) and the banked embedding lookup (torch)."""
