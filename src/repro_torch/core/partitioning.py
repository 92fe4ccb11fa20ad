"""Embedding-table partitioning — the paper's §3 contribution (numpy only).

A copy of the reference's ``repro/core/partitioning.py`` for the plans this
slice serves, kept here so the port imports nothing of the JAX package:

  * ``uniform_partition``      §3.1 — equal row blocks per bank.
  * ``non_uniform_partition``  §3.2 — greedy frequency-aware bin-packing:
                               sort rows by access frequency descending,
                               assign each to the bank with the lowest
                               aggregate load that still has capacity.

The cache-aware (§3.3) and replicated plans come with later slices. For the
same inputs the plan arrays equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class PartitionPlan:
    """Row -> (bank, slot) assignment for one table."""

    n_banks: int
    bank_of_row: np.ndarray          # (vocab,) int32
    slot_of_row: np.ndarray          # (vocab,) int32  — row index inside its bank
    rows_per_bank: np.ndarray        # (n_banks,) int32
    load_per_bank: np.ndarray        # (n_banks,) float64 — aggregate access freq

    @property
    def vocab(self) -> int:
        return int(self.bank_of_row.shape[0])

    @property
    def max_rows_per_bank(self) -> int:
        return int(self.rows_per_bank.max())

    def imbalance(self) -> float:
        """max/mean aggregate load across banks (1.0 == perfectly balanced)."""
        mean = self.load_per_bank.mean()
        return float(self.load_per_bank.max() / mean) if mean > 0 else 1.0

    def validate(self) -> None:
        if self.bank_of_row.min() < 0 or self.bank_of_row.max() >= self.n_banks:
            raise ValueError("bank id out of range")
        for b in range(self.n_banks):
            slots = self.slot_of_row[self.bank_of_row == b]
            if slots.shape[0] != self.rows_per_bank[b]:
                raise ValueError(f"bank {b}: row count mismatch")
            if slots.shape[0] and (
                    slots.min() != 0 or slots.max() != slots.shape[0] - 1
                    or np.unique(slots).shape[0] != slots.shape[0]):
                raise ValueError(f"bank {b}: slots are not 0..n-1")


def _plan_from_banks(n_banks: int, bank_of_row: np.ndarray,
                     freq: np.ndarray) -> PartitionPlan:
    vocab = bank_of_row.shape[0]
    slot = np.zeros(vocab, dtype=np.int32)
    rows_per_bank = np.zeros(n_banks, dtype=np.int32)
    load = np.zeros(n_banks, dtype=np.float64)
    # stable slot assignment: row order within a bank follows global row id
    for b in range(n_banks):
        members = np.flatnonzero(bank_of_row == b)
        slot[members] = np.arange(members.shape[0], dtype=np.int32)
        rows_per_bank[b] = members.shape[0]
        load[b] = freq[members].sum()
    return PartitionPlan(
        n_banks=n_banks,
        bank_of_row=bank_of_row.astype(np.int32),
        slot_of_row=slot,
        rows_per_bank=rows_per_bank,
        load_per_bank=load,
    )


def uniform_partition(vocab: int, n_banks: int,
                      freq: np.ndarray | None = None) -> PartitionPlan:
    """§3.1: contiguous equal row blocks (block b gets rows [b*Nr, (b+1)*Nr))."""
    if freq is None:
        freq = np.ones(vocab, dtype=np.float64)
    n_r = -(-vocab // n_banks)  # ceil
    bank_of_row = np.minimum(np.arange(vocab) // n_r, n_banks - 1)
    return _plan_from_banks(n_banks, bank_of_row.astype(np.int32), freq)


def non_uniform_partition(
    freq: np.ndarray,
    n_banks: int,
    *,
    capacity_rows: int | None = None,
    batch: int = 1,
    row_weights: np.ndarray | None = None,
    bank_capacity_rows: np.ndarray | None = None,
    bank_cost: np.ndarray | None = None,
) -> PartitionPlan:
    """§3.2: greedy frequency bin-packing with a fixed number of bins.

    capacity_rows: per-bank row budget. batch>1 assigns rows in groups of
    `batch` (the paper's complexity note); batch=1 is the exact greedy.
    row_weights: optional per-row cost multiplier (the balanced load becomes
    ``freq * row_weights``). bank_capacity_rows: optional (n_banks,) per-bank
    row budgets overriding ``capacity_rows`` (0 excludes a dead bank).
    bank_cost: optional (n_banks,) load multiplier per bank (a slow bank
    accounts each accepted row at k x its frequency); ``load_per_bank``
    still reports the uncosted traffic.
    """
    vocab = freq.shape[0]
    if row_weights is not None:
        if row_weights.shape[0] != vocab:
            raise ValueError(f"row_weights {row_weights.shape} != vocab "
                             f"{vocab}")
        freq = np.asarray(freq, np.float64) * np.asarray(row_weights,
                                                         np.float64)
    if capacity_rows is None:
        capacity_rows = vocab  # uncapped
    if bank_capacity_rows is None:
        cap_of = np.full(n_banks, capacity_rows, dtype=np.int64)
    else:
        cap_of = np.asarray(bank_capacity_rows, np.int64)
        if cap_of.shape != (n_banks,):
            raise ValueError(f"bank_capacity_rows {cap_of.shape} != "
                             f"({n_banks},)")
        cap_of = np.minimum(cap_of, capacity_rows)
    if cap_of.sum() < vocab:
        n_live = int((cap_of > 0).sum())
        raise ValueError(
            f"capacity exhausted: {n_live}/{n_banks} banks with "
            f"{int(cap_of.sum())} total rows < vocab {vocab} — increase "
            f"banks or capacity")
    cost_of = np.ones(n_banks, dtype=np.float64) if bank_cost is None \
        else np.asarray(bank_cost, np.float64)
    if cost_of.shape != (n_banks,):
        raise ValueError(f"bank_cost {cost_of.shape} != ({n_banks},)")
    order = np.argsort(-freq, kind="stable")
    bank_of_row = np.full(vocab, -1, dtype=np.int32)
    # heap of (costed load, rows_used, bank); zero-capacity (dead) banks
    # never enter it
    heap: list[tuple[float, int, int]] = [(0.0, 0, b) for b in range(n_banks)
                                          if cap_of[b] > 0]
    heapq.heapify(heap)
    parked: list[tuple[float, int, int]] = []
    i = 0
    while i < vocab:
        j = min(i + batch, vocab)
        group = order[i:j]
        gload = float(freq[group].sum())
        # pop until a bank with capacity for the whole group appears
        while heap and heap[0][1] + (j - i) > cap_of[heap[0][2]]:
            parked.append(heapq.heappop(heap))
        if not heap:
            raise ValueError("capacity exhausted — increase banks or capacity")
        load, used, b = heapq.heappop(heap)
        bank_of_row[group] = b
        heapq.heappush(heap, (load + gload * cost_of[b], used + (j - i), b))
        # full banks stay parked (they can never take more rows)
        keep = [p for p in parked if p[1] < cap_of[p[2]]]
        for p in keep:
            heapq.heappush(heap, p)
        parked = [p for p in parked if p[1] >= cap_of[p[2]]]
        i = j
    return _plan_from_banks(n_banks, bank_of_row, freq)
