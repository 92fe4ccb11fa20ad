"""Embedding-table partitioning — the paper's §3 contribution (numpy only).

A copy of the reference's ``repro/core/partitioning.py`` for the plans this
slice serves, kept here so the port imports nothing of the JAX package:

  * ``uniform_partition``      §3.1 — equal row blocks per bank.
  * ``non_uniform_partition``  §3.2 — greedy frequency-aware bin-packing:
                               sort rows by access frequency descending,
                               assign each to the bank with the lowest
                               aggregate load that still has capacity.
  * ``cache_aware_partition``  §3.3 Algorithm 1 — co-locate each cached
                               group's rows with its partial-sum entries,
                               credit the bank the group's benefit, then
                               place the residual rows by the plain greedy.

The replicated plans come with a later slice. For the same inputs the plan
arrays equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np


@dataclasses.dataclass
class PartitionPlan:
    """Row -> (bank, slot) assignment for one table (+ optional cache side)."""

    n_banks: int
    bank_of_row: np.ndarray          # (vocab,) int32
    slot_of_row: np.ndarray          # (vocab,) int32  — row index inside its bank
    rows_per_bank: np.ndarray        # (n_banks,) int32
    load_per_bank: np.ndarray        # (n_banks,) float64 — aggregate access freq
    # cache side (cache-aware only): cache group -> (bank, slot)
    cache_bank_of_entry: np.ndarray | None = None
    cache_slot_of_entry: np.ndarray | None = None
    cache_rows_per_bank: np.ndarray | None = None

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
    if batch == 1:
        bank_of_row[order] = _greedy_rows(np.asarray(freq, np.float64)[order],
                                          heap, cap_of.tolist(),
                                          cost_of.tolist())
        return _plan_from_banks(n_banks, bank_of_row, freq)
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


def _greedy_rows(freq_sorted: np.ndarray, heap: list, cap: list,
                 cost: list) -> np.ndarray:
    """The exact greedy (groups of one row) over rows already sorted by
    frequency: each row goes to the least-loaded bank with room. The same
    choices as the general loop in ``non_uniform_partition``, which walks
    the same heap (a bank is parked only once it is full, and a full bank
    never takes a row again), with the per-row work in plain Python floats
    and lists: several times faster at tens of millions of rows."""
    out = []
    append, replace, pop = out.append, heapq.heapreplace, heapq.heappop
    for f in freq_sorted.tolist():
        while heap and heap[0][1] >= cap[heap[0][2]]:
            pop(heap)
        if not heap:
            raise ValueError("capacity exhausted — increase banks or capacity")
        load, used, b = heap[0]
        append(b)
        replace(heap, (load + f * cost[b], used + 1, b))
    return np.asarray(out, dtype=np.int32)


def cache_aware_partition(
    freq: np.ndarray,
    cache_lists: list[np.ndarray],
    benefits: np.ndarray,
    n_banks: int,
    *,
    emt_capacity_rows: int | None = None,
    cache_capacity_entries: int | None = None,
) -> PartitionPlan:
    """§3.3 Algorithm 1: cache-aware non-uniform partitioning.

    cache_lists[g] = row ids of co-occurring group g (GRACE output);
    benefits[g]   = estimated reduction in memory accesses from caching group
                    g's partial sums (Alg. 1 line 5: `benefit = list[-1]`).

    Each cached group's member rows are co-located on one bank together with
    the group's partial-sum cache entries; the bank's accounted load is the
    members' frequency sum MINUS the benefit (lines 9–10).  Residual rows
    follow the plain greedy (lines 11–15).  The returned plan also carries the
    cache-entry placement (entry g lives on the bank of its members).
    """
    vocab = freq.shape[0]
    n_groups = len(cache_lists)
    if emt_capacity_rows is None:
        emt_capacity_rows = vocab
    if cache_capacity_entries is None:
        cache_capacity_entries = max(1, n_groups)

    bank_of_row = np.full(vocab, -1, dtype=np.int32)
    cache_bank = np.full(n_groups, -1, dtype=np.int32)
    load = np.zeros(n_banks, dtype=np.float64)
    rows_used = np.zeros(n_banks, dtype=np.int64)
    cache_used = np.zeros(n_banks, dtype=np.int64)
    in_cache = np.zeros(vocab, dtype=bool)

    # --- lines 4-10: place cache groups first (sorted by member frequency) ---
    group_load = np.array([freq[g].sum() for g in cache_lists])
    for g in np.argsort(-group_load, kind="stable"):
        members = cache_lists[g]
        # bank with lowest current load and enough cache + EMT capacity
        cand = sorted(range(n_banks), key=lambda b: load[b])
        placed = False
        for b in cand:
            if (cache_used[b] + 1 <= cache_capacity_entries
                    and rows_used[b] + members.shape[0] <= emt_capacity_rows):
                new = members[bank_of_row[members] < 0]
                bank_of_row[new] = b
                in_cache[members] = True
                rows_used[b] += new.shape[0]
                cache_used[b] += 1
                cache_bank[g] = b
                load[b] += float(freq[members].sum()) - float(benefits[g])
                placed = True
                break
        if not placed:  # cache full everywhere -> group degrades to plain rows
            continue

    # --- lines 11-15: residual rows by plain greedy ---
    residual = np.flatnonzero(bank_of_row < 0)
    order = residual[np.argsort(-freq[residual], kind="stable")]
    heap = [(load[b], b) for b in range(n_banks)]
    heapq.heapify(heap)
    for r in order:
        parked = []
        while heap and rows_used[heap[0][1]] + 1 > emt_capacity_rows:
            parked.append(heapq.heappop(heap))
        if not heap:
            raise ValueError("EMT capacity exhausted")
        l, b = heapq.heappop(heap)
        bank_of_row[r] = b
        rows_used[b] += 1
        heapq.heappush(heap, (l + float(freq[r]), b))
        for p in parked:
            heapq.heappush(heap, p)

    plan = _plan_from_banks(n_banks, bank_of_row, freq)
    # recompute accounted load including cache benefit (for imbalance reporting)
    acc = np.zeros(n_banks, dtype=np.float64)
    for b in range(n_banks):
        acc[b] = freq[bank_of_row == b].sum()
    for g in range(n_groups):
        if cache_bank[g] >= 0:
            acc[cache_bank[g]] -= float(benefits[g])
    plan.load_per_bank = np.maximum(acc, 0.0)
    # cache entry slots: sequential per bank
    cache_slot = np.full(n_groups, -1, dtype=np.int32)
    cache_rows = np.zeros(n_banks, dtype=np.int32)
    for g in range(n_groups):
        b = cache_bank[g]
        if b >= 0:
            cache_slot[g] = cache_rows[b]
            cache_rows[b] += 1
    plan.cache_bank_of_entry = cache_bank
    plan.cache_slot_of_entry = cache_slot
    plan.cache_rows_per_bank = cache_rows
    return plan
