"""Cache runtime: request rewriting + the partial-sum cache table (the port
of ``repro/core/cache_runtime.py``; numpy on the host, with the table built
as the port's ``BankedTable``).

The paper's Fig. 7 flow: before dispatch, the host checks each request's
index set against the cache index; matched subsets are replaced by a single
cached partial-sum read, the rest go to the EMT:

  host (data pipeline):  rewrite_bags() — bag indices -> (cache ids,
                         residual ids), padded to static shapes.
  device:                the cache partial-sum table is another (small)
                         bank-partitioned table; the fused lookup adds
                         Σ cache_table[cache_ids] + Σ emt[residual_ids].

Fixed capacity: ``cap_cache_plan`` pins the cache side to
``n_banks * rows_per_bank`` entry positions regardless of what was mined
(overflow entries fall back to residual reads, unused positions pad the
remap vectors), so the cache table's shapes never depend on the mining.
Versioning: ``VersionedCacheRewriter`` tags every rewritten batch with the
cache-plan version it was rewritten under, so a batch in flight across a
swap reads the table it was rewritten for. The port serves one installed
version (the swap lane comes with the adaptive loop).

For the same inputs every array here equals the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import BankedTable
from repro_torch.core.grace import CacheEntry, CachePlan, _subsets


def build_cache_table(table: np.ndarray, plan: CachePlan) -> np.ndarray:
    """(n_entries, dim) partial sums — entry e stores sum(table[members_e])."""
    dim = table.shape[1]
    out = np.zeros((max(plan.n_entries, 1), dim), dtype=table.dtype)
    for e, entry in enumerate(plan.entries):
        out[e] = table[list(entry.members)].sum(axis=0)
    return out


def rewrite_bag(bag: np.ndarray, plan: CachePlan) -> tuple[list[int], list[int]]:
    """One bag -> (cache entry ids, residual row ids).  Greedy largest-subset
    match per group (Fig. 7: {1,4,5} -> cache hit (4+5), residual {1})."""
    present = set(int(i) for i in bag)
    cache_ids: list[int] = []
    for group in plan.groups:
        inter = tuple(sorted(present & set(int(i) for i in group)))
        if len(inter) >= 2:
            eid = plan.entry_of_subset.get(inter)
            if eid is not None:
                cache_ids.append(eid)
                present -= set(inter)
    return cache_ids, sorted(present)


def rewrite_bags(
    bags: list[np.ndarray],
    plan: CachePlan,
    *,
    max_cache_per_bag: int,
    max_residual_per_bag: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Batch rewrite to padded static shapes (-1 padding).

    Returns (cache_idx (B, max_cache), residual_idx (B, max_residual)).
    Overflow beyond the static budgets falls back to residual reads (never
    drops lookups; only loses cache benefit), then truncates with a warning
    count — matching static-shape jit semantics.
    """
    B = len(bags)
    cache_idx = np.full((B, max_cache_per_bag), -1, dtype=np.int32)
    resid_idx = np.full((B, max_residual_per_bag), -1, dtype=np.int32)
    for i, bag in enumerate(bags):
        c, r = rewrite_bag(bag, plan)
        # cache hits beyond the static budget DEGRADE to residual row reads
        # (losing only the benefit, never the lookup)
        for eid in c[max_cache_per_bag:]:
            r.extend(plan.entries[eid].members)
        c = c[:max_cache_per_bag]
        r = sorted(set(r))[:max_residual_per_bag]
        cache_idx[i, :len(c)] = c
        resid_idx[i, :len(r)] = r
    return cache_idx, resid_idx


def measure_hit_rate(bags: list[np.ndarray], plan: CachePlan) -> float:
    """Fraction of row reads eliminated by the cache (Fig. 6's ~40% metric)."""
    saved = 0
    total = 0
    for bag in bags:
        c, r = rewrite_bag(bag, plan)
        total += len(set(int(i) for i in bag))
        saved += len(set(int(i) for i in bag)) - (len(c) + len(r))
    return saved / max(total, 1)


# ---------------------------------------------------------------------------
# fixed-capacity cache side (the adaptive-serving shape contract)
# ---------------------------------------------------------------------------

def empty_cache_plan() -> CachePlan:
    """A CachePlan with no groups: every bag rewrites to pure residual."""
    return CachePlan(groups=[], benefits=np.zeros(0), entries=[],
                     entry_of_subset={})


def entry_banks(plan: CachePlan, bank_of_row: np.ndarray,
                cache_bank_of_group: np.ndarray | None) -> np.ndarray:
    """Entry -> bank under Algorithm 1's co-location invariant: every subset
    entry lives on its mined group's bank; groups the partitioner could not
    place (or plans with no cache side) fall back to the bank of member 0."""
    bank = np.zeros(max(plan.n_entries, 1), dtype=np.int32)
    group_of = {}
    if cache_bank_of_group is not None:
        for g, grp in enumerate(plan.groups):
            # grace._subsets is the SAME enumeration entry_of_subset was
            # built from — entry.members tuples match it exactly
            for sub in _subsets([int(x) for x in grp]):
                group_of.setdefault(sub, g)
    for e, entry in enumerate(plan.entries):
        g = group_of.get(entry.members)
        b = int(cache_bank_of_group[g]) if g is not None else -1
        bank[e] = b if b >= 0 else int(bank_of_row[entry.members[0]])
    return bank[:plan.n_entries] if plan.n_entries else bank[:0]


@dataclasses.dataclass
class FixedCachePlan:
    """A re-mined CachePlan pinned to the serving capacity.

    ``plan`` keeps only the entries that fit (renumbered 0..n_entries-1;
    subsets that overflowed their bank's ``rows_per_bank`` budget are removed
    from ``entry_of_subset`` so ``rewrite_bag`` degrades them to residual row
    reads — losing only the benefit, never the lookup). ``entry_bank`` /
    ``entry_slot`` are PADDED to the full ``n_banks * rows_per_bank``
    capacity: pad ids point at the unused positions, so the remap vectors —
    like the packed cache table — have one shape for the life of the server.
    """

    plan: CachePlan
    entry_bank: np.ndarray      # (capacity,) int32
    entry_slot: np.ndarray      # (capacity,) int32
    n_banks: int
    rows_per_bank: int
    n_dropped: int = 0          # mined entries truncated back to residual

    @property
    def capacity(self) -> int:
        return self.n_banks * self.rows_per_bank

    @property
    def n_entries(self) -> int:
        return self.plan.n_entries


def cap_cache_plan(plan: CachePlan, bank_of_entry: np.ndarray, n_banks: int,
                   rows_per_bank: int) -> FixedCachePlan:
    """Pad/truncate a mined cache plan to the fixed serving capacity.

    Entries keep their mined order; each takes the next free slot on its
    assigned bank, and entries arriving after their bank is full are DROPPED
    (their subsets leave ``entry_of_subset``, so the rewriter falls back to
    residual reads for them). Remaining capacity is distributed to the
    emptiest banks so the padded remap vectors stay in-range.
    """
    capacity = n_banks * rows_per_bank
    kept: list[int] = []
    bank = np.zeros(capacity, dtype=np.int32)
    slot = np.zeros(capacity, dtype=np.int32)
    used = np.zeros(n_banks, dtype=np.int64)
    for e in range(plan.n_entries):
        b = int(bank_of_entry[e])
        if used[b] >= rows_per_bank:
            continue
        bank[len(kept)] = b
        slot[len(kept)] = used[b]
        used[b] += 1
        kept.append(e)
    # pad ids -> remaining (bank, slot) positions, emptiest bank first
    pos = len(kept)
    while pos < capacity:
        b = int(np.argmin(used))
        bank[pos] = b
        slot[pos] = used[b]
        used[b] += 1
        pos += 1
    new_id = {e: i for i, e in enumerate(kept)}
    entries = [CacheEntry(members=plan.entries[e].members,
                          hits=plan.entries[e].hits) for e in kept]
    entry_of_subset = {s: new_id[e] for s, e in plan.entry_of_subset.items()
                       if e in new_id}
    capped = CachePlan(groups=list(plan.groups),
                       benefits=np.asarray(plan.benefits),
                       entries=entries, entry_of_subset=entry_of_subset)
    return FixedCachePlan(plan=capped, entry_bank=bank, entry_slot=slot,
                          n_banks=n_banks, rows_per_bank=rows_per_bank,
                          n_dropped=plan.n_entries - len(kept))


def entry_member_union(fcp: FixedCachePlan) -> np.ndarray:
    """Sorted union of every kept entry's member rows — all a rebuild needs
    to read from the EMT (a few hundred rows, never the vocab)."""
    if not fcp.plan.entries:
        return np.zeros(0, dtype=np.int64)
    return np.unique(np.fromiter(
        (m for e in fcp.plan.entries for m in e.members), np.int64))


def _entry_sums(rows: torch.Tensor, members: list[list[int]]) -> torch.Tensor:
    """(n_entries, dim) partial sums in ``rows``' dtype: entry e adds its
    member rows left to right, each add rounded to the dtype — the order
    and rounding of the reference's numpy ``rows[members].sum(axis=0)``
    (which adds rows one after another along axis 0)."""
    out = torch.empty((len(members), rows.shape[1]), dtype=rows.dtype)
    for e, m in enumerate(members):
        acc = rows[m[0]]
        for i in m[1:]:
            acc = acc + rows[i]
        out[e] = acc
    return out


def build_cache_table_fixed(rows, fcp: FixedCachePlan, dtype=None,
                            row_ids: np.ndarray | None = None, *,
                            device: str | torch.device | None = "cuda"
                            ) -> BankedTable:
    """Fixed-shape banked GRACE table: entry e (summed from the CURRENT
    ``rows`` values) at packed position ``entry_bank[e] * rows_per_bank +
    entry_slot[e]``; pad positions stay zero. Its shapes depend only on
    (capacity, dim), never on what was mined.

    ``rows`` (a tensor or a numpy array, fp32 or bf16) is indexed by
    union-vocab row id: either the full (vocab, dim) array, or, with
    ``row_ids``, just those rows (``entry_member_union(fcp)``, so a build
    never materializes the vocab; both forms give the same bits). ``dtype``
    is the packed table's torch dtype (default: the rows'). The table and
    its remaps (``remap_flat`` included) land on ``device``."""
    dev = resolve_device(device)
    rows = torch.as_tensor(rows).cpu()
    dt = rows.dtype if dtype is None else dtype
    packed = torch.zeros((fcp.capacity, rows.shape[1]), dtype=dt)
    n = fcp.n_entries
    flat = (fcp.entry_bank.astype(np.int64) * fcp.rows_per_bank
            + fcp.entry_slot)
    if n:
        if row_ids is not None:
            pos = {int(i): j for j, i in enumerate(np.asarray(row_ids))}
            members = [[pos[int(m)] for m in e.members]
                       for e in fcp.plan.entries]
        else:
            members = [list(e.members) for e in fcp.plan.entries]
        packed[torch.from_numpy(flat[:n])] = _entry_sums(rows, members).to(dt)
    return BankedTable(
        packed=packed.to(dev),
        remap_bank=torch.from_numpy(fcp.entry_bank.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(fcp.entry_slot.astype(np.int32)).to(dev),
        n_banks=fcp.n_banks,
        rows_per_bank=fcp.rows_per_bank,
    )


# ---------------------------------------------------------------------------
# versioned rewriting (in-flight batches survive a swap)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RewrittenBatch:
    """One micro-batch after cache rewriting, tagged with the cache-plan
    version its entry ids are numbered under."""

    cache_idx: np.ndarray       # (..., Lc) int32, -1 padded
    residual_idx: np.ndarray    # (..., Lr) int32, -1 padded
    version: int


class VersionedCacheRewriter:
    """The host/data-pipeline stage of Fig. 7, made swap-safe.

    Owns the CURRENT (FixedCachePlan, cache BankedTable) pair plus the last
    ``keep - 1`` retired pairs. ``rewrite_rect`` always rewrites against the
    current plan and stamps the batch with its version; ``table_for`` hands
    back the table matching any still-retained version, so a batch rewritten
    just before a swap is served against the entry numbering it was rewritten
    for. ``keep=2`` covers the serve loop's one-batch in-flight window;
    deeper pipelines raise it.
    """

    def __init__(self, *, max_cache_per_bag: int, max_residual_per_bag: int,
                 keep: int = 2):
        assert keep >= 1
        self.max_cache_per_bag = int(max_cache_per_bag)
        self.max_residual_per_bag = int(max_residual_per_bag)
        self.keep = int(keep)
        self.version = -1
        self._states: dict[int, tuple[FixedCachePlan, object]] = {}

    def install(self, fcp: FixedCachePlan, table) -> int:
        """Atomically publish a new (plan, table) pair; returns its version.
        Called on the host between micro-batches — the next ``rewrite_rect``
        uses the new plan, already-rewritten batches keep resolving."""
        self.version += 1
        self._states[self.version] = (fcp, table)
        for v in [v for v in self._states if v <= self.version - self.keep]:
            del self._states[v]
        return self.version

    @property
    def current(self) -> tuple[FixedCachePlan, object]:
        return self._states[self.version]

    def plan_for(self, version: int) -> FixedCachePlan:
        return self._state_for(version)[0]

    def table_for(self, version: int):
        return self._state_for(version)[1]

    def _state_for(self, version: int):
        try:
            return self._states[version]
        except KeyError:
            raise KeyError(
                f"cache version {version} retired (retained: "
                f"{sorted(self._states)}); raise keep= for deeper pipelines"
            ) from None

    def rewrite_rect(self, union_idx: np.ndarray) -> RewrittenBatch:
        """(..., L) union-vocab ids (-1 padded) -> version-tagged
        (cache_idx, residual_idx) at the static per-bag budgets."""
        if union_idx.shape[-1] > self.max_residual_per_bag:
            # a bag of L unique rows with no cache hit needs L residual
            # slots; past the budget rewrite_bags would silently DROP
            # lookups (wrong scores), so refuse loudly instead — size
            # max_residual_per_bag to the serve batch's bag length
            raise ValueError(
                f"bag length {union_idx.shape[-1]} > max_residual_per_bag "
                f"{self.max_residual_per_bag}: residual overflow would drop "
                f"lookups")
        fcp, _ = self.current
        lead = union_idx.shape[:-1]
        flat = union_idx.reshape(-1, union_idx.shape[-1])
        bags = [row[row >= 0] for row in flat]
        ci, ri = rewrite_bags(bags, fcp.plan,
                              max_cache_per_bag=self.max_cache_per_bag,
                              max_residual_per_bag=self.max_residual_per_bag)
        return RewrittenBatch(
            cache_idx=ci.reshape(*lead, self.max_cache_per_bag),
            residual_idx=ri.reshape(*lead, self.max_residual_per_bag),
            version=self.version)
