"""Reproducible drifting workloads: generation + replay (a numpy copy of
``repro/workload/trace.py``, kept here so the port imports nothing of the
JAX package; for the same seed every bag equals the reference's).

``DriftingZipfTrace`` draws bags from a Zipf(a) popularity whose hot set
may move: rotation (every ``rotate_every`` bags the rank->item permutation
advances by ``rotate_frac * n_items``), diurnal (popularity blends between
two fixed permutations with a sin^2 weight of period ``diurnal_period``
bags) and bursts (with prob ``burst_prob`` per bag a window of
``burst_len`` bags draws half its items from a small random hot set).
Every bag is a pure function of (seed, bag index). The cache-aware serve
path (``launch/serve.run_cached``) draws its requests from it with the
drift off.

``read_criteo_tsv`` ingests real traces in Criteo TSV format
(label \\t 13 dense \\t 26 hex-categorical); ``write_criteo_tsv``
synthesizes one from drifting traces.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    n_items: int
    zipf_a: float = 1.05
    avg_bag: float = 8.0           # |bag| ~ max(1, Poisson(avg_bag))
    rotate_every: int = 0          # bags between hot-set rotations (0 = off)
    rotate_frac: float = 0.2       # fraction of id space per rotation step
    diurnal_period: int = 0        # bags per "day" (0 = off)
    burst_prob: float = 0.0        # per-bag prob of STARTING a burst window
    burst_len: int = 32            # bags per burst window
    burst_items: int = 16          # size of the burst hot set
    burst_share: float = 0.5       # fraction of a burst bag from the hot set


class DriftingZipfTrace:
    """Deterministic drifting bag stream. ``bag(t)`` is pure in (seed, t)."""

    def __init__(self, cfg: DriftConfig, *, seed: int = 0):
        self.cfg = cfg
        self.seed = seed
        self.t = 0                              # replay clock (next bag index)
        rng = np.random.default_rng((seed, 0xD21F))
        ranks = np.arange(1, cfg.n_items + 1, dtype=np.float64)
        self._base_p = ranks ** (-cfg.zipf_a)
        self._base_p /= self._base_p.sum()
        self._perm_a = rng.permutation(cfg.n_items)
        self._perm_b = rng.permutation(cfg.n_items)

    # -- popularity schedule ------------------------------------------------

    def _schedule(self, t: int) -> tuple[int, float]:
        """(rotation shift, diurnal weight) at bag index t. The diurnal phase
        is quantized to 16 steps per period so the pmf is piecewise-constant
        (cacheable) while still sweeping the full day cycle."""
        cfg = self.cfg
        shift = 0
        if cfg.rotate_every > 0:
            shift = (t // cfg.rotate_every) * max(
                1, int(cfg.rotate_frac * cfg.n_items))
        w = 0.0
        if cfg.diurnal_period > 0:
            step = max(1, cfg.diurnal_period // 16)
            w = float(np.sin(np.pi * ((t // step) * step)
                             / cfg.diurnal_period) ** 2)
        return shift, w

    def popularity(self, t: int) -> np.ndarray:
        """(n_items,) item-sampling pmf at bag index t — pure in (seed, t)."""
        shift, w = self._schedule(t)
        p = np.empty(self.cfg.n_items)
        p[np.roll(self._perm_a, shift)] = self._base_p
        if w > 0.0:
            pb = np.empty(self.cfg.n_items)
            pb[np.roll(self._perm_b, shift)] = self._base_p
            p = (1.0 - w) * p + w * pb
        return p / p.sum()

    def _burst_set(self, t: int) -> np.ndarray | None:
        """Burst hot set active at t, or None. Burst windows are anchored at
        their start bag so every bag in a window shares one hot set."""
        cfg = self.cfg
        if cfg.burst_prob <= 0.0:
            return None
        for start in range(max(0, t - cfg.burst_len + 1), t + 1):
            r = np.random.default_rng((self.seed, 0xB5A7, start))
            if r.random() < cfg.burst_prob:
                return r.choice(cfg.n_items, cfg.burst_items, replace=False)
        return None

    # -- bag generation -----------------------------------------------------

    def bag(self, t: int) -> np.ndarray:
        cfg = self.cfg
        rng = np.random.default_rng((self.seed, 0xBA6, t))
        size = max(1, rng.poisson(cfg.avg_bag))
        # popularity varies per WINDOW, not per bag: reuse the cached cdf.
        # Generator.choice(n, size, p=p) draws exactly this, but rebuilds
        # the O(n_items) cdf on every call.
        out = self._cdf_at(t).searchsorted(rng.random(size), side="right")
        hot = self._burst_set(t)
        if hot is not None:
            n_hot = int(np.ceil(size * cfg.burst_share))
            out[:n_hot] = rng.choice(hot, n_hot)
        return out.astype(np.int64)

    def _cdf_at(self, t: int) -> np.ndarray:
        # the pmf is a pure function of the (shift, weight) schedule point;
        # cache its cdf on that key so the O(n_items) build runs once per
        # boundary
        key = self._schedule(t)
        if getattr(self, "_cdf_key", None) != key:
            cdf = self.popularity(t).cumsum()
            cdf /= cdf[-1]
            self._cdf, self._cdf_key = cdf, key
        return self._cdf

    def bags(self, n: int) -> list[np.ndarray]:
        """Next n bags from the replay clock (advances it)."""
        out = [self.bag(self.t + i) for i in range(n)]
        self.t += n
        return out

    def rect(self, batch: int, bag_len: int) -> np.ndarray:
        """Next ``batch`` bags as a (batch, bag_len) int32 array, -1 padded
        (truncating oversize bags) — the rectangular serve-batch form."""
        out = np.full((batch, bag_len), -1, dtype=np.int32)
        for i, bag in enumerate(self.bags(batch)):
            b = bag[:bag_len]
            out[i, :len(b)] = b
        return out

    def reset(self, t: int = 0) -> None:
        self.t = t


def dlrm_drifting_batch(traces: list[DriftingZipfTrace], batch: int,
                        multi_hot: int) -> np.ndarray:
    """(B, F) one-hot or (B, F, L) multi-hot sparse ids, field f drawn from
    traces[f] — the drifting replacement for data/synthetic.dlrm_batch."""
    cols = [tr.rect(batch, max(multi_hot, 1)) for tr in traces]
    sparse = np.stack(cols, axis=1)                    # (B, F, L)
    if multi_hot == 1:
        return np.maximum(sparse[:, :, 0], 0).astype(np.int32)
    return sparse.astype(np.int32)


# ---------------------------------------------------------------------------
# Criteo-format TSV replay
# ---------------------------------------------------------------------------

def read_criteo_tsv(path: str, *, n_dense: int = 13, n_sparse: int = 26,
                    hash_vocab: int | None = None,
                    max_rows: int | None = None) -> dict:
    """Parse a Criteo-format TSV: label \\t dense*13 \\t hex-categorical*26.

    Missing fields -> -1 (the pipeline's padding id). Hex categoricals are
    parsed as base-16; ``hash_vocab`` folds them into [0, hash_vocab) (the
    standard hashing trick — required before feeding a fixed-vocab table).
    Returns {"label": (N,), "dense": (N, n_dense), "sparse": (N, n_sparse)}.
    """
    labels, dense, sparse = [], [], []
    with open(path) as fh:
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 1 + n_dense + n_sparse:
                parts = parts + [""] * (1 + n_dense + n_sparse - len(parts))
            labels.append(float(parts[0] or 0))
            dense.append([float(x) if x else 0.0
                          for x in parts[1:1 + n_dense]])
            row = []
            for x in parts[1 + n_dense:1 + n_dense + n_sparse]:
                if not x:
                    row.append(-1)
                    continue
                try:
                    v = int(x, 16)
                except ValueError:
                    v = zlib.crc32(x.encode())   # deterministic across runs
                row.append(v % hash_vocab if hash_vocab else v)
            sparse.append(row)
            if max_rows is not None and len(labels) >= max_rows:
                break
    return {
        "label": np.asarray(labels, np.float32),
        "dense": np.asarray(dense, np.float32),
        "sparse": np.asarray(sparse, np.int64),
    }


def write_criteo_tsv(path: str, n_rows: int, *, n_fields: int = 26,
                     vocab_per_field: int = 1000, n_dense: int = 13,
                     drift: DriftConfig | None = None, seed: int = 0) -> None:
    """Synthesize a DRIFTING trace in Criteo TSV format (label \\t dense*13 \\t
    hex-categorical*26) — the fixture that lets the real-trace replay path
    (``read_criteo_tsv`` -> ``criteo_row_stream``) run in CI without shipping
    production logs. Field f draws from its own ``DriftingZipfTrace`` (shared
    drift schedule, per-field seed), so the replayed stream exhibits the same
    hot-set rotation the synthetic benchmarks use. ``n_fields`` < 26 leaves
    the remaining categorical columns empty (-1 after parsing), matching real
    Criteo's missing fields.
    """
    if drift is None:
        drift = DriftConfig(n_items=vocab_per_field, zipf_a=1.1, avg_bag=1.0)
    drift = dataclasses.replace(drift, n_items=vocab_per_field, avg_bag=1.0)
    traces = [DriftingZipfTrace(drift, seed=seed + f) for f in range(n_fields)]
    rng = np.random.default_rng((seed, 0xC21E0))
    with open(path, "w") as fh:
        for i in range(n_rows):
            label = int(rng.random() < 0.25)
            dense = [f"{x:.3f}" for x in rng.standard_normal(n_dense)]
            cats = [f"{int(tr.bag(i)[0]):x}" for tr in traces]
            cats += [""] * (26 - n_fields)
            fh.write("\t".join([str(label), *dense, *cats]) + "\n")


def criteo_row_stream(table: dict, field_offsets: np.ndarray):
    """Yield per-example union-vocab row-id bags from a read_criteo_tsv dict —
    the telemetry/replanner feed for real-trace replay."""
    sparse = table["sparse"]
    offs = np.asarray(field_offsets, np.int64)
    for i in range(sparse.shape[0]):
        row = sparse[i]
        valid = row >= 0
        yield (row + offs)[valid]
