"""Embedding-table partitioning — the paper's §3 contribution (numpy; the
two plain plans are timed as the set-up span ``setup.plan``).

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
  * ``replicated_partition``   §3.2 with hot-row replication — each row's
                               ``copies[v]`` copies go to that many
                               least-loaded DISTINCT banks
                               (``ReplicatedPlan``); ``choose_replication``
                               picks the copy counts from live head mass.

For the same inputs the plan arrays equal the reference's exactly.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

from repro_torch.obs.tracing import setup_stage


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


@dataclasses.dataclass
class ReplicatedPlan:
    """Replication-aware row -> (bank, slot) assignment (§3.2 + hot-row
    replication).

    Row ``v`` owns ``copies[v]`` physical copies, each on a DISTINCT bank.
    The per-row maps are ``(vocab, k_max)``: column ``r`` holds copy
    ``r % copies[v]`` (cyclic padding), so a reader that picks any column in
    ``[0, k_max)`` — the lookup's ``wang_hash(bag) % k_max`` — always lands
    on a valid copy. Single-copy rows repeat the same (bank, slot) in every
    column, which makes a plan with no replicated rows the plain
    ``PartitionPlan`` layout.
    """

    n_banks: int
    k_max: int
    copies: np.ndarray               # (vocab,) int32 in {1, k_max}
    bank_of_copy: np.ndarray         # (vocab, k_max) int32
    slot_of_copy: np.ndarray         # (vocab, k_max) int32
    rows_per_bank: np.ndarray        # (n_banks,) int32 — physical rows stored
    load_per_bank: np.ndarray        # (n_banks,) float64 — freq split k ways

    @property
    def vocab(self) -> int:
        return int(self.copies.shape[0])

    @property
    def max_rows_per_bank(self) -> int:
        return int(self.rows_per_bank.max())

    @property
    def n_replicated(self) -> int:
        return int((self.copies > 1).sum())

    def imbalance(self) -> float:
        mean = self.load_per_bank.mean()
        return float(self.load_per_bank.max() / mean) if mean > 0 else 1.0

    def max_share(self) -> float:
        """Hottest bank's share of total modeled traffic (ideal: 1/n_banks)."""
        total = self.load_per_bank.sum()
        return float(self.load_per_bank.max() / total) if total > 0 else 0.0

    def validate(self) -> None:
        V, k = self.bank_of_copy.shape
        if k != self.k_max or self.slot_of_copy.shape != (V, k):
            raise ValueError("map shapes do not match k_max")
        if self.bank_of_copy.min() < 0 or \
                self.bank_of_copy.max() >= self.n_banks:
            raise ValueError("bank id out of range")
        cols = np.arange(k)[None, :] % self.copies[:, None]
        if (self.bank_of_copy[np.arange(V)[:, None], cols]
                != self.bank_of_copy).any():
            raise ValueError("columns are not a cyclic padding of the copies")
        for v in np.flatnonzero(self.copies > 1):
            c = int(self.copies[v])
            if np.unique(self.bank_of_copy[v, :c]).shape[0] != c:
                raise ValueError(f"row {v}: copies share a bank")
        vv, rr = np.nonzero(np.arange(k)[None, :] < self.copies[:, None])
        bb, ss = self.bank_of_copy[vv, rr], self.slot_of_copy[vv, rr]
        for b in range(self.n_banks):
            slots = ss[bb == b]
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


@setup_stage("setup.plan")
def uniform_partition(vocab: int, n_banks: int,
                      freq: np.ndarray | None = None) -> PartitionPlan:
    """§3.1: contiguous equal row blocks (block b gets rows [b*Nr, (b+1)*Nr))."""
    if freq is None:
        freq = np.ones(vocab, dtype=np.float64)
    n_r = -(-vocab // n_banks)  # ceil
    bank_of_row = np.minimum(np.arange(vocab) // n_r, n_banks - 1)
    return _plan_from_banks(n_banks, bank_of_row.astype(np.int32), freq)


@setup_stage("setup.plan")
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


# runs of at least this many rows of one frequency are placed at once
# (``_merge_run``); shorter runs take the per-row loop
_RUN_MIN = 256


def _runs(freq_sorted: np.ndarray):
    """(start, stop) of each run of equal values of a sorted vector. The
    telemetry's frequency estimates repeat a few hundred values (sketch
    floors, zeros) over millions of rows."""
    cut = np.flatnonzero(freq_sorted[1:] != freq_sorted[:-1]) + 1
    edges = np.concatenate([[0], cut, [freq_sorted.shape[0]]]).tolist()
    return zip(edges[:-1], edges[1:])


def _merge_run(k: int, banks: list, step: list, room: list,
               ties: list | None, ids: list, what: str
               ) -> tuple[np.ndarray, list]:
    """The exact greedy over a run of ``k`` rows of one frequency, at once.
    Entry i (``banks[i]`` its key's leading load, ``step[i]`` what each row
    adds to it, ``room[i]`` the rows it can still take, ``ids[i]`` its
    bank) would take its j-th row of the run at load ``banks[i] + step[i]
    + ... + step[i]`` (j adds, in order, as the loop adds them), keyed by
    that load, then ``ties[i] + j`` where the loop's key has rows used
    (``ties`` None: it has not), then the bank, then j. Each entry's keys increase with j, so
    the loop's k picks are the k least keys over all entries. Returns the
    picks (entry positions) and each entry's new load (its leading key),
    or raises like the loop when the banks run out of room."""
    loads, seconds, bank, pos, jj = [], [], [], [], []
    for i, (load, d, r) in enumerate(zip(banks, step, room)):
        m = min(k, r)
        if m <= 0:
            continue
        seq = np.full(m, d)
        seq[0] = load
        loads.append(np.cumsum(seq))    # sequential: the loop's sums
        j = np.arange(m)
        seconds.append(np.zeros(m, np.int64) if ties is None
                       else ties[i] + j)
        bank.append(np.full(m, ids[i]))
        pos.append(np.full(m, i))
        jj.append(j)
    if sum(x.shape[0] for x in pos) < k:
        raise ValueError(what)
    L, S, B, P, J = (np.concatenate(x)
                     for x in (loads, seconds, bank, pos, jj))
    pick = P[np.lexsort((J, B, S, L))[:k]]
    counts = np.bincount(pick, minlength=len(banks))
    new, at = [], 0
    for i, (load, d, r) in enumerate(zip(banks, step, room)):
        n = int(counts[i])
        if n:
            new.append(float(loads[at][n - 1]) + d)
        else:
            new.append(load)
        at += int(min(k, r) > 0)
    return pick, new


def _greedy_rows(freq_sorted: np.ndarray, heap: list, cap: list,
                 cost: list) -> np.ndarray:
    """The exact greedy (groups of one row) over rows already sorted by
    frequency: each row goes to the least-loaded bank with room. The same
    choices as the general loop in ``non_uniform_partition``, which walks
    the same heap (a bank is parked only once it is full, and a full bank
    never takes a row again), with the per-row work in plain Python floats
    and lists, and each long run of one frequency placed at once
    (``_merge_run``): several times faster at tens of millions of rows.
    ``heap`` is left holding the banks' keys after the last row."""
    out: list = []
    append, replace, pop = out.append, heapq.heapreplace, heapq.heappop
    for a, b in _runs(freq_sorted):
        if b - a < _RUN_MIN:
            for f in freq_sorted[a:b].tolist():
                while heap and heap[0][1] >= cap[heap[0][2]]:
                    pop(heap)
                if not heap:
                    raise ValueError("capacity exhausted — increase banks "
                                     "or capacity")
                load, used, bk = heap[0]
                append(bk)
                replace(heap, (load + f * cost[bk], used + 1, bk))
            continue
        f = float(freq_sorted[a])
        live = [e for e in heap if e[1] < cap[e[2]]]
        pick, new = _merge_run(
            b - a, [e[0] for e in live], [f * cost[e[2]] for e in live],
            [cap[e[2]] - e[1] for e in live], [e[1] for e in live],
            [e[2] for e in live],
            "capacity exhausted — increase banks or capacity")
        out.extend(np.asarray([e[2] for e in live])[pick].tolist())
        counts = np.bincount(pick, minlength=len(live))
        heap[:] = [(load, used + int(n), bk) for (_, used, bk), load, n
                   in zip(live, new, counts)]
        heapq.heapify(heap)
    return np.asarray(out, dtype=np.int32)


def _greedy_residual(freq_sorted: np.ndarray, heap: list, used: list,
                     cap: int) -> np.ndarray:
    """Algorithm 1's residual greedy (lines 11-15) over rows already sorted
    by frequency: each row goes to the bank of least accounted load with
    room, the heap keyed on ``(load, bank)``. The reference parks full
    banks and pushes them back with the same key; since a bank's row count
    never falls, a full bank stays full, so dropping it for good makes the
    same choices. The per-row work is plain Python floats and lists, as in
    ``_greedy_rows``, and so is the placing of long runs at once."""
    out: list = []
    append, replace, pop = out.append, heapq.heapreplace, heapq.heappop
    for a, b in _runs(freq_sorted):
        if b - a < _RUN_MIN:
            for f in freq_sorted[a:b].tolist():
                while heap and used[heap[0][1]] >= cap:
                    pop(heap)
                if not heap:
                    raise ValueError("EMT capacity exhausted")
                load, bk = heap[0]
                append(bk)
                used[bk] += 1
                replace(heap, (load + f, bk))
            continue
        f = float(freq_sorted[a])
        live = [e for e in heap if used[e[1]] < cap]
        pick, new = _merge_run(
            b - a, [e[0] for e in live], [f] * len(live),
            [cap - used[e[1]] for e in live], None,
            [e[1] for e in live], "EMT capacity exhausted")
        out.extend(np.asarray([e[1] for e in live])[pick].tolist())
        counts = np.bincount(pick, minlength=len(live))
        for (_, bk), n in zip(live, counts):
            used[bk] += int(n)
        heap[:] = [(load, bk) for (_, bk), load in zip(live, new)]
        heapq.heapify(heap)
    return np.asarray(out, dtype=np.int32)


def choose_replication(freq: np.ndarray, n_banks: int, *, k_max: int,
                       max_r: int = 256,
                       hot_rows: np.ndarray | None = None) -> np.ndarray:
    """Copy count per row from live head mass: a row whose frequency
    exceeds the balanced per-copy load ``total / (n_banks * k_max)`` gets
    ``k_max`` copies, every other row one. ``max_r`` bounds the number of
    replicated rows (the hottest are kept); ``hot_rows`` restricts the
    candidates (the tier lane's full-precision head)."""
    vocab = freq.shape[0]
    copies = np.ones(vocab, dtype=np.int32)
    if k_max <= 1 or vocab == 0:
        return copies
    freq = np.asarray(freq, np.float64)
    total = float(freq.sum())
    if total <= 0:
        return copies
    hot = freq > total / (n_banks * k_max)
    if hot_rows is not None:
        mask = np.zeros(vocab, dtype=bool)
        mask[np.asarray(hot_rows, np.int64)] = True
        hot &= mask
    cand = np.flatnonzero(hot)
    if cand.shape[0] > max_r:
        cand = cand[np.argsort(-freq[cand], kind="stable")[:max_r]]
    copies[cand] = k_max
    return copies


def replicated_partition(
    freq: np.ndarray,
    n_banks: int,
    *,
    copies: np.ndarray,
    capacity_rows: int | None = None,
    k_max: int | None = None,
    bank_capacity_rows: np.ndarray | None = None,
) -> ReplicatedPlan:
    """§3.2 greedy, replication-aware: in descending frequency, each row's
    ``copies[v]`` copies go to the ``copies[v]`` least-loaded DISTINCT banks
    with room, each copy accounted at ``freq[v] / copies[v]``.

    With ``copies`` all ones this is the ``non_uniform_partition`` greedy
    (same heap tie-breaking, same stable slot order). ``k_max`` pins the
    map width independently of ``copies.max()``, so a serve loop swaps
    between replicated and unreplicated plans without a shape change.
    ``bank_capacity_rows`` ((n_banks,), overriding ``capacity_rows``) gives
    a dead bank 0 rows.

    Runs of single-copy rows take ``_greedy_rows`` (the batch-1 loop over
    Python floats) on the same heap; a replicated row pops its ``c`` banks
    at once and pushes them back, as the reference does. A full bank is
    dropped for good on both. The plans equal the reference's exactly.
    """
    vocab = freq.shape[0]
    freq = np.asarray(freq, np.float64)
    copies = np.asarray(copies, np.int32)
    if copies.shape != (vocab,):
        raise ValueError(f"copies {copies.shape} != ({vocab},)")
    if vocab and copies.min() < 1:
        raise ValueError("copies must be >= 1")
    k_need = int(copies.max()) if vocab else 1
    k_max = k_need if k_max is None else int(k_max)
    if k_need > k_max:
        raise ValueError(f"copies.max() {k_need} > k_max {k_max}")
    if k_need > n_banks:
        raise ValueError(f"copies.max() {k_need} > n_banks {n_banks}: "
                         f"replica copies must land on distinct banks")
    total_rows = int(copies.sum())
    if capacity_rows is None:
        capacity_rows = total_rows
    if bank_capacity_rows is None:
        cap_of = np.full(n_banks, int(capacity_rows), dtype=np.int64)
    else:
        cap_of = np.asarray(bank_capacity_rows, np.int64)
        if cap_of.shape != (n_banks,):
            raise ValueError(f"bank_capacity_rows {cap_of.shape} != "
                             f"({n_banks},)")
    if int(cap_of.sum()) < total_rows:
        raise ValueError(
            f"capacity exhausted: {int(cap_of.sum())} total rows across "
            f"{n_banks} banks < {total_rows} physical rows (vocab {vocab} + "
            f"{total_rows - vocab} replica copies) — raise capacity_rows or "
            f"lower replication")
    order = np.argsort(-freq, kind="stable")
    f_sorted = freq[order]
    c_sorted = copies[order]
    bank_cols = np.full((vocab, k_max), -1, dtype=np.int32)
    # heap of (load, rows_used, bank); capacity never grows, so a full bank
    # is dropped for good
    heap: list[tuple[float, int, int]] = [(0.0, 0, b) for b in range(n_banks)]
    heapq.heapify(heap)
    cap, unit = cap_of.tolist(), [1.0] * n_banks
    start = 0
    for i in [*np.flatnonzero(c_sorted > 1).tolist(), vocab]:
        if i > start:                    # a run of single-copy rows
            bank_cols[order[start:i], 0] = _greedy_rows(
                f_sorted[start:i], heap, cap, unit)
        if i == vocab:
            break
        v, c = int(order[i]), int(c_sorted[i])
        share = float(freq[v]) / c
        chosen: list[tuple[float, int, int]] = []
        for _ in range(c):
            while heap and heap[0][1] >= cap[heap[0][2]]:
                heapq.heappop(heap)
            if not heap:
                raise ValueError("capacity exhausted — raise capacity_rows "
                                 "or lower replication")
            chosen.append(heapq.heappop(heap))
        for r, (load, used, b) in enumerate(chosen):
            bank_cols[v, r] = b
            heapq.heappush(heap, (load + share, used + 1, b))
        start = i + 1
    # stable slot assignment: within a bank, physical rows follow
    # (global row id, copy index) order
    vv, rr = np.nonzero(np.arange(k_max)[None, :] < copies[:, None])
    bb = bank_cols[vv, rr]
    slot_flat = np.zeros(vv.shape[0], dtype=np.int32)
    for b in range(n_banks):
        m = bb == b
        slot_flat[m] = np.arange(int(m.sum()), dtype=np.int32)
    slot_cols = np.full((vocab, k_max), -1, dtype=np.int32)
    slot_cols[vv, rr] = slot_flat
    cols = np.arange(k_max)[None, :] % copies[:, None]
    rows_idx = np.arange(vocab)[:, None]
    return ReplicatedPlan(
        n_banks=n_banks,
        k_max=k_max,
        copies=copies,
        bank_of_copy=bank_cols[rows_idx, cols].astype(np.int32),
        slot_of_copy=slot_cols[rows_idx, cols].astype(np.int32),
        rows_per_bank=np.bincount(bb, minlength=n_banks).astype(np.int32),
        load_per_bank=np.bincount(bb, weights=(freq / copies)[vv],
                                  minlength=n_banks),
    )


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
    heap = [(float(load[b]), b) for b in range(n_banks)]
    heapq.heapify(heap)
    bank_of_row[order] = _greedy_residual(
        np.asarray(freq[order], np.float64), heap, rows_used.tolist(),
        int(emt_capacity_rows))

    plan = _plan_from_banks(n_banks, bank_of_row, freq)
    # accounted load including the cache benefit (for imbalance reporting):
    # each bank's ``freq[bank_of_row == b].sum()``, which is the sum
    # _plan_from_banks took over the same rows in the same order
    acc = plan.load_per_bank.copy()
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


def expert_placement(expert_load: np.ndarray, n_banks: int) -> np.ndarray:
    """The §3.2 greedy reused for MoE expert -> bank placement: the bank
    of each expert, balanced by routed token counts, at most ``ceil(E /
    n_banks)`` experts a bank (the reference's ``expert_placement``)."""
    cap = -(-expert_load.shape[0] // n_banks)
    plan = non_uniform_partition(expert_load.astype(np.float64), n_banks,
                                 capacity_rows=cap)
    return plan.bank_of_row
