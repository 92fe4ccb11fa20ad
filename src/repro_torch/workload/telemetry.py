"""Streaming access-frequency telemetry for embedding tables (a numpy copy
of the reference's ``repro/workload/telemetry.py``; the same inputs give
the same counts, estimates and drift reports).

The §3 partitioners take a per-row access-frequency vector as input; in
production that vector is not known ahead of time and drifts. This module is
the measurement half of the adaptive loop:

  ``TopKCounter``    — space-saving heavy-hitter counter. With a budget at
                       least the number of distinct ids seen it is EXACT; under
                       eviction every stored count overestimates the true count
                       by at most the smallest stored count (Metwally et al.).
                       The hot head is what the non-uniform partitioner cares
                       about, so it gets the precise counts.
  ``CountMinSketch`` — d x w conservative estimate for the full-vocab tail:
                       ``query(i) >= true(i)`` always, and
                       ``query(i) <= true(i) + (e / w) * total`` with
                       probability ``>= 1 - exp(-d)`` (Cormode & Muthukrishnan).
                       8 B/cell; w=4096, d=4 tracks a 33M-row vocab in 128 KB.
  ``TableTelemetry`` — the two stitched together behind ``observe(ids)`` /
                       ``freq_vector()``, with optional exponential decay so
                       old traffic ages out instead of anchoring the plan.
  ``DriftDetector``  — compares the live estimate against the frequencies the
                       ACTIVE plan was built from: top-K Jaccard (did the hot
                       set rotate?) + weighted L1 on normalized frequencies
                       (did the mass move?). Either tripping flags drift.

Host-side numpy throughout — telemetry runs in the pre-processing stage
(paper Fig. 4), next to the cache rewriting, never on device.
"""
from __future__ import annotations

import dataclasses
import heapq

import numpy as np

_MERSENNE = (1 << 61) - 1


def rows_from_sparse(sparse: np.ndarray,
                     field_offsets: np.ndarray) -> np.ndarray:
    """DLRM sparse batch -> union-vocab row ids for the telemetry feed.

    ``sparse`` is (B, F) one-hot or (B, F, L) multi-hot per-field ids;
    padding (< 0) stays -1. The serve observer tap and the train loop both
    go through here so their telemetry can never diverge.
    """
    sp = np.asarray(sparse)
    offs = np.asarray(field_offsets, np.int64)
    per_field = sp if sp.ndim == 3 else sp[..., None]
    return np.where(per_field >= 0, per_field + offs[None, :, None], -1)


class CountMinSketch:
    """Conservative frequency sketch over non-negative int ids."""

    def __init__(self, width: int = 4096, depth: int = 4, *, seed: int = 0):
        assert width > 0 and depth > 0
        self.width = int(width)
        self.depth = int(depth)
        rng = np.random.default_rng(seed)
        # pairwise-independent row hashes: h_i(x) = ((a_i x + b_i) mod p) mod w.
        # a, b < 2^31 keeps a*x + b inside int64 for any int32 row id.
        self._a = rng.integers(1, 1 << 31, depth, dtype=np.int64)
        self._b = rng.integers(0, 1 << 31, depth, dtype=np.int64)
        self.table = np.zeros((depth, width), dtype=np.float64)
        self.total = 0.0

    @property
    def epsilon(self) -> float:
        """Overestimate bound as a fraction of total mass: e / width."""
        return float(np.e / self.width)

    def _buckets(self, ids: np.ndarray) -> np.ndarray:
        x = np.asarray(ids, dtype=np.int64)[None, :]
        h = (self._a[:, None] * x + self._b[:, None]) % _MERSENNE
        return (h % self.width).astype(np.int64)       # (depth, n)

    def update(self, ids: np.ndarray, counts: np.ndarray | float = 1.0) -> None:
        ids = np.asarray(ids)
        if ids.size == 0:
            return
        c = np.broadcast_to(np.asarray(counts, np.float64), ids.shape)
        rows = self._buckets(ids)
        for d in range(self.depth):
            np.add.at(self.table[d], rows[d], c)
        self.total += float(c.sum())

    def query(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        if ids.size == 0:
            return np.zeros(0)
        rows = self._buckets(ids.reshape(-1))
        est = self.table[np.arange(self.depth)[:, None], rows].min(axis=0)
        return est.reshape(ids.shape)

    def scale(self, gamma: float) -> None:
        self.table *= gamma
        self.total *= gamma


class TopKCounter:
    """Space-saving heavy hitters: exact while under budget, bounded error
    after (a new id inherits ``min_count + c`` when it evicts the coldest).

    Eviction uses a LAZY min-heap over (count, id): every count change pushes
    a fresh entry; pops discard entries whose count is stale. Amortized
    O(log budget) per novel id — this runs synchronously inside the
    MicroBatcher's observer tap, so a per-eviction O(budget) dict scan would
    bill the telemetry straight onto the serve p99 it exists to protect.
    """

    def __init__(self, budget: int = 4096):
        assert budget > 0
        self.budget = int(budget)
        self.counts: dict[int, float] = {}
        self.evictions = 0
        self._heap: list[tuple[float, int]] = []   # (count-at-push, id)

    def _pop_min(self) -> tuple[int, float]:
        """Current coldest (id, count), discarding stale heap entries."""
        while True:
            cnt, i = heapq.heappop(self._heap)
            if self.counts.get(i) == cnt:
                return i, cnt

    def update(self, ids: np.ndarray, counts: np.ndarray | float = 1.0) -> None:
        ids = np.asarray(ids).reshape(-1)
        if ids.size == 0:
            return
        uniq, inv = np.unique(ids, return_inverse=True)
        c = np.broadcast_to(np.asarray(counts, np.float64),
                            ids.shape).reshape(-1)
        agg = np.zeros(uniq.shape[0])
        np.add.at(agg, inv, c)
        for i, cnt in zip(uniq.tolist(), agg.tolist()):
            cur = self.counts.get(i)
            if cur is not None:
                new = cur + cnt
            elif len(self.counts) < self.budget:
                new = cnt
            else:
                victim, floor = self._pop_min()
                del self.counts[victim]
                new = floor + cnt
                self.evictions += 1
            self.counts[i] = new
            heapq.heappush(self._heap, (new, i))
        # stale entries are normally shed by evictions; when the live set
        # fits the budget (no evictions) they would pile up forever in a
        # long-lived serve process — compact once they dominate
        if len(self._heap) > 2 * len(self.counts) + 64:
            self._compact()

    def _compact(self) -> None:
        self._heap = [(c, i) for i, c in self.counts.items()]
        heapq.heapify(self._heap)

    def topk(self, k: int) -> np.ndarray:
        """Hottest ids, count-descending (ties by id for determinism)."""
        items = sorted(self.counts.items(), key=lambda kv: (-kv[1], kv[0]))
        return np.array([i for i, _ in items[:k]], dtype=np.int64)

    def scale(self, gamma: float) -> None:
        for i in self.counts:
            self.counts[i] *= gamma
        # uniform scaling preserves order but invalidates every pushed count;
        # rebuild the heap from the live dict (also sheds stale duplicates)
        self._compact()


@dataclasses.dataclass
class TableTelemetry:
    """Per-table streaming frequency tracker: exact-ish head + sketched tail.

    ``decay`` < 1.0 turns the counters into an exponential moving window:
    every ``decay_every`` observed ids, all counts are multiplied by
    ``decay`` — the replanner then follows the recent distribution instead of
    the all-time one.
    """

    vocab: int
    topk_budget: int = 4096
    sketch_width: int = 4096
    sketch_depth: int = 4
    decay: float = 1.0
    decay_every: int = 100_000
    seed: int = 0

    def __post_init__(self):
        self.sketch = CountMinSketch(self.sketch_width, self.sketch_depth,
                                     seed=self.seed)
        self.head = TopKCounter(self.topk_budget)
        self.n_observed = 0
        self._since_decay = 0

    def observe(self, ids: np.ndarray) -> None:
        """Record one batch of raw row ids (any shape; negatives = padding)."""
        ids = np.asarray(ids).reshape(-1)
        ids = ids[ids >= 0]
        if ids.size == 0:
            return
        self.sketch.update(ids)
        self.head.update(ids)
        self.n_observed += int(ids.size)
        self._since_decay += int(ids.size)
        if self.decay < 1.0 and self._since_decay >= self.decay_every:
            self.sketch.scale(self.decay)
            self.head.scale(self.decay)
            self._since_decay = 0

    def observe_bags(self, bags: list[np.ndarray]) -> None:
        for bag in bags:
            self.observe(bag)

    def topk(self, k: int) -> np.ndarray:
        return self.head.topk(k)

    def freq_on(self, ids: np.ndarray) -> np.ndarray:
        """Estimated frequencies for just ``ids`` — the sparse counterpart of
        ``freq_vector`` (same estimator: exact head counts override the
        sketch), costing O(len(ids)) instead of O(vocab)."""
        ids = np.asarray(ids, np.int64)
        est = self.sketch.query(ids)
        if self.head.counts:
            flat = est.reshape(-1)
            for j, i in enumerate(ids.reshape(-1).tolist()):
                cnt = self.head.counts.get(int(i))
                if cnt is not None:
                    flat[j] = cnt
        return est

    def freq_vector(self) -> np.ndarray:
        """(vocab,) estimated access frequencies: exact head counts override
        the sketch's (over-)estimate; never-seen rows keep the sketch floor
        (an overestimate, which only pads the partitioner conservatively)."""
        est = self.sketch.query(np.arange(self.vocab, dtype=np.int64))
        if self.head.counts:
            ids = np.fromiter(self.head.counts.keys(), np.int64,
                              len(self.head.counts))
            vals = np.fromiter(self.head.counts.values(), np.float64,
                               len(self.head.counts))
            keep = ids < self.vocab
            est[ids[keep]] = vals[keep]
        return est


@dataclasses.dataclass
class DriftReport:
    topk_jaccard: float
    weighted_l1: float
    drifted: bool
    n_observed: int

    def __str__(self) -> str:  # one-line log form for the launch CLIs
        return (f"drift(jaccard={self.topk_jaccard:.3f} "
                f"wl1={self.weighted_l1:.3f} drifted={self.drifted})")


def topk_jaccard(a: np.ndarray, b: np.ndarray) -> float:
    sa, sb = set(a.tolist()), set(b.tolist())
    if not sa and not sb:
        return 1.0
    return len(sa & sb) / max(len(sa | sb), 1)


def weighted_l1(ref: np.ndarray, cur: np.ndarray) -> float:
    """L1 between the two NORMALIZED frequency vectors, in [0, 2]."""
    rs, cs = ref.sum(), cur.sum()
    if rs <= 0 or cs <= 0:
        return 0.0
    return float(np.abs(ref / rs - cur / cs).sum())


@dataclasses.dataclass
class DriftDetector:
    """Trips when live traffic no longer matches the plan-time frequencies.

    ``reference`` is the freq vector the ACTIVE PartitionPlan was built from
    (not last check's snapshot — slow cumulative drift must still trip).

    Past ``sparse_above`` rows the dense path's per-check cost becomes the
    problem it is meant to prevent (a (vocab,) sketch materialization + an
    O(vocab log vocab) argsort on the serve host, every ``check_every``
    batches): the check switches to the TOP-K-UNION form — the live hot set
    comes straight from the space-saving head (no argsort over the vocab),
    and the weighted L1 runs on the union of the reference and live top-K,
    both renormalized over that union. On a fully-observed vocab with
    ``k >= vocab`` the two paths are numerically identical
    (the reference's tests pin it); on a power-law trace the union carries
    almost all the mass, so the thresholds keep their meaning. Replans
    themselves still materialize (vocab,) — they are drift-gated and rare,
    the checks are the steady-state cost.
    """

    reference: np.ndarray
    k: int = 256
    min_jaccard: float = 0.5
    max_weighted_l1: float = 0.5
    min_observations: int = 1000
    sparse_above: int = 10_000_000

    def __post_init__(self):
        self.reference = np.asarray(self.reference, np.float64)
        self._ref_topk = self._topk_of(self.reference)

    def _topk_of(self, freq: np.ndarray) -> np.ndarray:
        k = min(self.k, freq.shape[0])
        return np.argsort(-freq, kind="stable")[:k]

    def rebase(self, reference: np.ndarray) -> None:
        """Point at the frequencies of a freshly-installed plan."""
        self.reference = np.asarray(reference, np.float64)
        self._ref_topk = self._topk_of(self.reference)

    def check(self, telemetry: TableTelemetry) -> DriftReport:
        if telemetry.vocab > self.sparse_above:
            jac, wl1 = self._check_sparse(telemetry)
        else:
            cur = telemetry.freq_vector()
            jac = topk_jaccard(self._ref_topk, self._topk_of(cur))
            wl1 = weighted_l1(self.reference, cur)
        enough = telemetry.n_observed >= self.min_observations
        drifted = enough and (jac < self.min_jaccard
                              or wl1 > self.max_weighted_l1)
        return DriftReport(topk_jaccard=jac, weighted_l1=wl1,
                           drifted=bool(drifted),
                           n_observed=telemetry.n_observed)

    def _check_sparse(self, telemetry: TableTelemetry) -> tuple[float, float]:
        # the head counter can hold out-of-range ids (observe() filters only
        # negatives) — drop them like freq_vector's keep-guard does, or one
        # corrupt log row would crash every later check via reference[union]
        vocab = self.reference.shape[0]
        cur_topk = telemetry.topk(self.k)
        cur_topk = cur_topk[cur_topk < vocab]
        jac = topk_jaccard(self._ref_topk, cur_topk)
        union = np.union1d(self._ref_topk, cur_topk)
        wl1 = weighted_l1(self.reference[union], telemetry.freq_on(union))
        return jac, wl1
