"""Synthetic workload generators (numpy copy of ``repro/data/synthetic.py``
for the recommendation families — DLRM, DIN, BERT4Rec, xDeepFM —, the
LMs' token batches, GAT's graphs and molecule batches, and the examples'
multi-hot traces).

``WORKLOADS`` mirrors the paper's Table 1: six datasets in three hotness
tiers with the published average reduction (multi-hot bag size) and item
counts. Popularity is Zipf-distributed with the tier controlling the
exponent. Every generator is deterministic in (seed, step), and for the
same arguments returns arrays equal to the reference's.
"""
from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

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


def lm_batch(batch: int, seq: int, vocab: int, *, seed: int,
             step: int) -> dict:
    """``tokens`` (batch, seq) uniform over the vocab and ``labels`` the
    tokens shifted left by one (the last wraps to the first)."""
    rng = np.random.default_rng((seed, step))
    toks = rng.integers(0, vocab, (batch, seq), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


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


def din_batch(n_items: int, n_cates: int, seq_len: int, batch: int, *,
              seed: int, step: int) -> dict:
    """One DIN batch: hist_items / hist_cates (B, L) int32, -1 past each
    history's length (uniform in [L // 4, L]); target_item / target_cate
    (B,) int32; label (B,) f32."""
    rng = np.random.default_rng((seed, step))
    hist = rng.integers(0, n_items, (batch, seq_len)).astype(np.int32)
    lens = rng.integers(seq_len // 4, seq_len + 1, batch)
    mask = np.arange(seq_len)[None, :] < lens[:, None]
    hist = np.where(mask, hist, -1).astype(np.int32)
    cates = np.where(mask, rng.integers(0, n_cates, (batch, seq_len)), -1)
    return {
        "hist_items": hist,
        "hist_cates": cates.astype(np.int32),
        "target_item": rng.integers(0, n_items, batch).astype(np.int32),
        "target_cate": rng.integers(0, n_cates, batch).astype(np.int32),
        "label": rng.integers(0, 2, batch).astype(np.float32),
    }


def bert4rec_batch(n_items: int, seq_len: int, batch: int, *, seed: int,
                   step: int, mask_rate: float = 0.15,
                   n_negatives: int = 0) -> dict:
    """One BERT4Rec cloze batch: items (B, S) int32 with a ``mask_rate``
    share (and always the last position) replaced by the mask token
    ``n_items``, labels (B, S) the original ids there and -100 elsewhere;
    with ``n_negatives``, negatives (N,) int32 shared by the batch."""
    rng = np.random.default_rng((seed, step))
    items = rng.integers(0, n_items, (batch, seq_len)).astype(np.int32)
    sel = rng.random((batch, seq_len)) < mask_rate
    sel[:, -1] = True  # always at least one target
    labels = np.where(sel, items, -100).astype(np.int32)
    masked = np.where(sel, n_items, items).astype(np.int32)  # mask token id
    out = {"items": masked, "labels": labels}
    if n_negatives:
        out["negatives"] = rng.integers(0, n_items,
                                        n_negatives).astype(np.int32)
    return out


def xdeepfm_batch(vocab_sizes, batch: int, *, seed: int, step: int) -> dict:
    """One xDeepFM batch: sparse (B, m) int32 per-field ids, label (B,)
    f32."""
    rng = np.random.default_rng((seed, step))
    sparse = np.stack([rng.integers(0, v, batch) for v in vocab_sizes],
                      axis=1).astype(np.int32)
    return {"sparse": sparse,
            "label": rng.integers(0, 2, batch).astype(np.float32)}


# the families whose batches ``family_batch`` draws: GAT's are graphs,
# drawn by ``random_graph``, ``molecule_batch`` or the sampler
BATCH_FAMILIES = ("lm", "dlrm", "din", "bert4rec", "xdeepfm")


def family_batch(family: str, cfg, batch: int, *, seed: int,
                 step: int) -> dict:
    """A batch of ``batch`` synthetic examples of ``cfg``, a config of the
    model ``family`` (one of ``BATCH_FAMILIES``), from
    that family's generator; the LMs' sequences are 64 tokens long, as the
    reference's train CLI draws them. BERT4Rec's carries ``cfg.n_negatives`` shared
    negatives when its loss is 'sampled' (the reference's train CLI draws
    none, and its sampled loss then fails on the missing key; the items
    and labels are the same draws either way)."""
    if family == "lm":
        return lm_batch(batch, 64, cfg.vocab, seed=seed, step=step)
    if family == "dlrm":
        return dlrm_batch(cfg.vocab_sizes, cfg.n_dense, batch, seed=seed,
                          step=step, multi_hot=cfg.multi_hot)
    if family == "din":
        return din_batch(cfg.n_items, cfg.n_cates, cfg.seq_len, batch,
                         seed=seed, step=step)
    if family == "bert4rec":
        return bert4rec_batch(
            cfg.n_items, cfg.seq_len, batch, seed=seed, step=step,
            n_negatives=cfg.n_negatives if cfg.loss == "sampled" else 0)
    if family == "xdeepfm":
        return xdeepfm_batch(cfg.vocab_sizes, batch, seed=seed, step=step)
    # the reference's train CLI's refusal (GAT runs from its cells instead)
    raise ValueError(f"use examples/ for family {family}")


# ---------------------------------------------------------------------------
# graphs
# ---------------------------------------------------------------------------

_DRAW_CHUNK = 1 << 22


def _choice_p(rng: np.random.Generator, n: int, size: int,
              p: np.ndarray) -> np.ndarray:
    """``rng.choice(n, size, p=p)``, the same integers: what ``choice``
    does inside (the cdf of ``p`` normalized by its last entry, ``size``
    uniforms, a right-sided search of each), with the search of a large
    draw split over threads (``searchsorted`` releases the GIL), since at
    the ``minibatch_lg`` cell's 114.6 M edges one thread spends tens of
    seconds on it."""
    cdf = p.cumsum()
    cdf /= cdf[-1]
    u = rng.random(size)
    if size <= _DRAW_CHUNK:
        return cdf.searchsorted(u, side="right")
    out = np.empty(size, dtype=np.int64)

    def part(lo: int) -> None:
        hi = min(lo + _DRAW_CHUNK, size)
        out[lo:hi] = cdf.searchsorted(u[lo:hi], side="right")

    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for f in [pool.submit(part, lo) for lo in range(0, size,
                                                        _DRAW_CHUNK)]:
            f.result()
    return out


def random_graph(n_nodes: int, n_edges: int, d_feat: int, n_classes: int, *,
                 seed: int = 0, power_law: bool = True) -> dict:
    """Cora/products-like: endpoints drawn from a Zipf(0.9) popularity over
    the nodes (``power_law``; else uniform), standard-normal features,
    uniform labels, half the nodes labelled (``label_mask``)."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = zipf_popularity(n_nodes, 0.9, rng)
        src = _choice_p(rng, n_nodes, n_edges, w)
        dst = _choice_p(rng, n_nodes, n_edges, w)
    else:
        src = rng.integers(0, n_nodes, n_edges)
        dst = rng.integers(0, n_nodes, n_edges)
    return {
        "features": rng.standard_normal((n_nodes, d_feat)).astype(np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "labels": rng.integers(0, n_classes, n_nodes).astype(np.int32),
        "label_mask": (rng.random(n_nodes) < 0.5),
    }


def molecule_batch(n_graphs: int, nodes_per: int, edges_per: int,
                   d_feat: int, n_classes: int, *, seed: int = 0,
                   step: int = 0) -> dict:
    """``n_graphs`` small graphs of ``nodes_per`` nodes and ``edges_per``
    uniform edges each, as one block-diagonal edge list; ``graph_ids``
    names each node's graph, ``labels`` one class a graph."""
    rng = np.random.default_rng((seed, step))
    N = n_graphs * nodes_per
    src = (rng.integers(0, nodes_per, (n_graphs, edges_per))
           + np.arange(n_graphs)[:, None] * nodes_per).reshape(-1)
    dst = (rng.integers(0, nodes_per, (n_graphs, edges_per))
           + np.arange(n_graphs)[:, None] * nodes_per).reshape(-1)
    return {
        "features": rng.standard_normal((N, d_feat)).astype(np.float32),
        "edge_src": src.astype(np.int32),
        "edge_dst": dst.astype(np.int32),
        "graph_ids": np.repeat(np.arange(n_graphs), nodes_per)
        .astype(np.int32),
        "labels": rng.integers(0, n_classes, n_graphs).astype(np.int32),
    }
