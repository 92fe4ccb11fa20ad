"""GRACE-lite: co-occurrence mining -> partial-sum cache lists (a numpy
copy of ``repro/core/grace.py``; for the same trace the groups, benefits
and entries equal the reference's).

The paper adopts GRACE (Ye et al., ASPLOS'23) as an off-the-shelf component:
a miner that finds frequently co-occurring item groups whose partial sums
are cached ("a cache list of {a,b,c} means partial sums a+b, a+c, b+c and
a+b+c are cached"). UpDLRM "does not rely on GRACE and can work with any
other caching technique" (§5), so this is a self-contained greedy
co-occurrence miner with the same interface: it consumes an access trace
and emits (groups, benefits).

Host-side numpy; runs in the pre-processing stage (Fig. 4).
"""
from __future__ import annotations

import dataclasses
from collections import Counter

import numpy as np


@dataclasses.dataclass
class CacheEntry:
    """One cached partial sum: the row ids whose sum is stored."""

    members: tuple[int, ...]
    hits: float  # times this exact subset co-occurred in the trace


@dataclasses.dataclass
class CachePlan:
    groups: list[np.ndarray]       # mined co-occurrence groups (cache lists)
    benefits: np.ndarray           # est. reduced memory accesses per group
    entries: list[CacheEntry]      # explicit cached subsets (incl. pairwise)
    entry_of_subset: dict[tuple[int, ...], int]  # subset -> entry id

    @property
    def n_entries(self) -> int:
        return len(self.entries)


def mine_cooccurrence(
    trace: list[np.ndarray],
    *,
    top_items: int = 4096,
    max_groups: int = 512,
    max_group_size: int = 3,
    min_support: int = 2,
) -> CachePlan:
    """Greedy frequent-group miner over a bag trace.

    1. restrict to the `top_items` hottest items (power-law: these dominate),
    2. count pair co-occurrences among them,
    3. greedily grow groups (pair -> triple) by shared-neighbor support,
    4. benefit(group) = co-occurrence count * (|group| - 1)   — each full-group
       hit turns |group| row reads into one partial-sum read.
    """
    freq = Counter()
    for bag in trace:
        freq.update(int(i) for i in np.unique(bag))
    hot = {i for i, _ in freq.most_common(top_items)}

    pair_count: Counter = Counter()
    for bag in trace:
        items = sorted(set(int(i) for i in bag) & hot)
        for a_i in range(len(items)):
            for b_i in range(a_i + 1, len(items)):
                pair_count[(items[a_i], items[b_i])] += 1

    groups: list[np.ndarray] = []
    benefits: list[float] = []
    used: set[int] = set()
    for (a, b), cnt in pair_count.most_common():
        if cnt < min_support or len(groups) >= max_groups:
            break
        if a in used or b in used:
            continue
        group = [a, b]
        if max_group_size >= 3:
            # best third member co-occurring with both
            best_c, best_cnt = None, min_support - 1
            for c in hot:
                if c in used or c == a or c == b:
                    continue
                cc = min(pair_count.get(tuple(sorted((a, c))), 0),
                         pair_count.get(tuple(sorted((b, c))), 0))
                if cc > best_cnt:
                    best_c, best_cnt = c, cc
            if best_c is not None:
                group.append(best_c)
        used.update(group)
        groups.append(np.array(sorted(group), dtype=np.int64))
        benefits.append(float(cnt) * (len(group) - 1))

    # explicit cached subsets: all 2..n subsets of each group (paper §3.3)
    entries: list[CacheEntry] = []
    entry_of_subset: dict[tuple[int, ...], int] = {}
    for g, cnt in zip(groups, benefits):
        members = [int(x) for x in g]
        subsets = _subsets(members)
        for s in subsets:
            if s not in entry_of_subset:
                entry_of_subset[s] = len(entries)
                entries.append(CacheEntry(members=s, hits=cnt))
    return CachePlan(groups=groups, benefits=np.array(benefits),
                     entries=entries, entry_of_subset=entry_of_subset)


def _subsets(members: list[int]) -> list[tuple[int, ...]]:
    out: list[tuple[int, ...]] = []
    n = len(members)
    for mask in range(3, 2 ** n):
        if bin(mask).count("1") >= 2:
            out.append(tuple(members[i] for i in range(n) if mask >> i & 1))
    return out
