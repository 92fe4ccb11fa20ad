"""Synthetic workload generators (numpy copy of ``repro/data/synthetic.py``
for the DLRM paths and the examples' multi-hot traces).

``WORKLOADS`` mirrors the paper's Table 1: six datasets in three hotness
tiers with the published average reduction (multi-hot bag size) and item
counts. Popularity is Zipf-distributed with the tier controlling the
exponent. Every generator is deterministic in (seed, step), and for the
same arguments returns arrays equal to the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadProfile:
    name: str
    avg_reduction: float
    n_items: int
    zipf_a: float          # popularity exponent (higher => hotter)
    tier: str


# paper Table 1 (avg reduction + #items verbatim; zipf_a per tier)
WORKLOADS = {
    "clo":   WorkloadProfile("AmazonClothes", 52.91, 2_685_059, 0.60, "low"),
    "home":  WorkloadProfile("AmazonHome", 67.56, 1_301_225, 0.65, "low"),
    "meta1": WorkloadProfile("MetaFBGEMM1", 107.2, 5_783_210, 0.90, "medium"),
    "meta2": WorkloadProfile("MetaFBGEMM2", 188.6, 5_999_981, 0.95, "medium"),
    "read":  WorkloadProfile("GoodReads", 245.8, 2_360_650, 1.18, "high"),
    "read2": WorkloadProfile("GoodReads2", 374.08, 2_360_650, 1.22, "high"),
}


def zipf_popularity(n_items: int, a: float, rng: np.random.Generator
                    ) -> np.ndarray:
    """Normalized Zipf pmf over a random permutation of item ids (hot items
    are scattered across the id space, like real catalogs)."""
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    p = ranks ** (-a)
    p /= p.sum()
    perm = rng.permutation(n_items)
    out = np.empty(n_items)
    out[perm] = p
    return out


def multihot_trace(profile: WorkloadProfile, n_samples: int, *, seed: int = 0,
                   n_items: int | None = None) -> list[np.ndarray]:
    """Bags of item ids: |bag| ~ max(1, Poisson(avg_reduction)), items ~
    Zipf. Each bag is drawn from the pmf's cdf, built once:
    ``cdf.searchsorted(rng.random(size), side='right')`` is what
    ``Generator.choice(n, size, p=p)`` does inside, less the cdf it rebuilds
    on every call, so the bags equal the reference's."""
    rng = np.random.default_rng(seed)
    n = n_items or profile.n_items
    p = zipf_popularity(n, profile.zipf_a, rng)
    cdf = p.cumsum()
    cdf /= cdf[-1]
    sizes = np.maximum(1, rng.poisson(profile.avg_reduction, n_samples))
    return [cdf.searchsorted(rng.random(s), side="right") for s in sizes]


def padded_bags(trace: list[np.ndarray], pad_to: int) -> np.ndarray:
    """Bags as a (len(trace), pad_to) int32 array, -1 padded, longer bags
    cut to ``pad_to``."""
    out = np.full((len(trace), pad_to), -1, dtype=np.int32)
    for i, bag in enumerate(trace):
        b = bag[:pad_to]
        out[i, :len(b)] = b
    return out


def dlrm_batch(vocab_sizes, n_dense: int, batch: int, *, seed: int, step: int,
               multi_hot: int = 1, zipf_a: float = 0.9) -> dict:
    """One DLRM batch: dense (B, n_dense) f32, sparse (B, F) int32 one-hot
    or (B, F, multi_hot) multi-hot per-field ids, label (B,) f32."""
    rng = np.random.default_rng((seed, step))
    if multi_hot == 1:
        sparse = np.stack([rng.integers(0, v, batch) for v in vocab_sizes],
                          axis=1).astype(np.int32)
    else:
        sparse = np.stack(
            [rng.integers(0, v, (batch, multi_hot)) for v in vocab_sizes],
            axis=1).astype(np.int32)
    return {
        "dense": rng.standard_normal((batch, n_dense)).astype(np.float32),
        "sparse": sparse,
        "label": rng.integers(0, 2, batch).astype(np.float32),
    }
