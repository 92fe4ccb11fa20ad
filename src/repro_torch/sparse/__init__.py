"""Embedding bags and segment reductions over ragged (CSR) bags."""
