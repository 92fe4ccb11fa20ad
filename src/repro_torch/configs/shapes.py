"""Each family's input-shape cells — the four assigned shapes of every arch
— with builders of (a) their batches at full dims on ``meta`` tensors
(``batch_struct``, the dry pass's; no memory) and (b) the concrete reduced
batches of the smoke tests (the port of ``repro/configs/shapes.py``).

Step kinds: "train" (train step), "serve" (forward / score), "decode"
(one-token serve step with a KV cache), "prefill", "retrieval". The GNN
cells are GAT's only definition in the reference: its train CLI refuses
the family, and ``cells.py`` builds its step from ``GNN_CELLS``.
Concrete batches are numpy, as the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.registry import get_arch

i32, f32 = torch.int32, torch.float32


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    shape_id: str
    step_kind: str
    dims: dict[str, int]          # concrete global dims
    note: str = ""


# ---------------------------------------------------------------------------
# the assigned shape tables
# ---------------------------------------------------------------------------

LM_CELLS = {
    "train_4k": ShapeCell("train_4k", "train",
                          dict(seq=4096, batch=256)),
    "prefill_32k": ShapeCell("prefill_32k", "prefill",
                             dict(seq=32768, batch=32)),
    "decode_32k": ShapeCell("decode_32k", "decode",
                            dict(seq=32768, batch=128)),
    # long-context decode: one token against a 524k KV cache, O(S)
    "long_500k": ShapeCell("long_500k", "decode",
                           dict(seq=524288, batch=1)),
}

RECSYS_CELLS = {
    "train_batch": ShapeCell("train_batch", "train", dict(batch=65536)),
    "serve_p99": ShapeCell("serve_p99", "serve", dict(batch=512)),
    "serve_bulk": ShapeCell("serve_bulk", "serve", dict(batch=262144)),
    "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                dict(batch=1, n_candidates=1_000_000)),
}

GNN_CELLS = {
    "full_graph_sm": ShapeCell(
        "full_graph_sm", "train",
        dict(n_nodes=2708, n_edges=10556, d_feat=1433, n_classes=7),
        "Cora full-batch"),
    "minibatch_lg": ShapeCell(
        "minibatch_lg", "train",
        dict(n_nodes=232_965, n_edges=114_615_892, batch_nodes=1024,
             fanout0=15, fanout1=10, d_feat=602, n_classes=41),
        "Reddit-scale sampled (d_feat/classes per Reddit)"),
    "ogb_products": ShapeCell(
        "ogb_products", "train",
        dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
             n_classes=47),
        "ogbn-products full-batch"),
    "molecule": ShapeCell(
        "molecule", "train",
        dict(n_graphs=128, nodes_per=30, edges_per=64, d_feat=16,
             n_classes=2),
        "batched small graphs (d_feat=16 atom features — open choice)"),
}

# reduced dims for smoke tests (same structure, tiny)
LM_CELLS_RED = {
    "train_4k": dict(seq=64, batch=4),
    "prefill_32k": dict(seq=64, batch=2),
    "decode_32k": dict(seq=64, batch=2),
    "long_500k": dict(seq=128, batch=1),
}
RECSYS_CELLS_RED = {
    "train_batch": dict(batch=32),
    "serve_p99": dict(batch=8),
    "serve_bulk": dict(batch=64),
    "retrieval_cand": dict(batch=1, n_candidates=64),
}
GNN_CELLS_RED = {
    "full_graph_sm": dict(n_nodes=40, n_edges=120, d_feat=16, n_classes=3),
    "minibatch_lg": dict(batch_nodes=8, fanout0=3, fanout1=2, d_feat=16,
                         n_classes=3),
    "ogb_products": dict(n_nodes=100, n_edges=400, d_feat=16, n_classes=3),
    "molecule": dict(n_graphs=4, nodes_per=6, edges_per=10, d_feat=16,
                     n_classes=3),
}

SLATE = 500  # per-user candidate slate for bert4rec ranking serve


def get_cell(arch_id: str, shape_id: str) -> ShapeCell:
    spec = get_arch(arch_id)
    table = {"lm": LM_CELLS, "gat": GNN_CELLS}.get(spec.family,
                                                   RECSYS_CELLS)
    return table[shape_id]


def gat_config_for_shape(base, dims: dict):
    """``base`` (a ``GATConfig``) with the cell's features and classes."""
    return dataclasses.replace(base, d_feat=dims["d_feat"],
                               n_classes=dims["n_classes"])


def sampled_block_dims(batch_nodes: int, f0: int, f1: int) -> dict:
    """Worst-case padded sizes for 2-layer fanout sampling: n0 nodes of
    the outer block, its e0 edges; n1 src nodes and e1 edges of the inner
    one."""
    e1 = batch_nodes * f0                  # innermost block edges
    n1 = batch_nodes + e1                  # its src set
    e0 = n1 * f1                           # outer block edges
    n0 = n1 + e0
    return dict(n0=n0, e0=e0, n1=n1, e1=e1)


# ---------------------------------------------------------------------------
# meta batches at full dims (the dry pass)
# ---------------------------------------------------------------------------

def _sds(shape, dtype) -> torch.Tensor:
    """A shape and a dtype: a tensor on ``meta``, which holds no memory
    (the reference's ``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_struct(arch_id: str, shape_id: str) -> tuple[str, dict]:
    """(step_kind, {name: meta tensor}) of the cell's batch at its FULL
    config: the reference's shapes, int32 ids, float32 dense features and
    labels, bool masks. A decode cell's KV cache is carried state, not
    batch, and is built apart (``launch/cells``)."""
    spec = get_arch(arch_id)
    cell = get_cell(arch_id, shape_id)
    d = cell.dims
    fam = spec.family
    cfg = spec.config

    if fam == "lm":
        B, S = d["batch"], d["seq"]
        if cell.step_kind == "train":
            return "train", {"tokens": _sds((B, S), i32),
                             "labels": _sds((B, S), i32)}
        if cell.step_kind == "prefill":
            return "prefill", {"tokens": _sds((B, S), i32)}
        return "decode", {"token": _sds((B,), i32)}

    if fam == "dlrm":
        B = d["batch"]
        F = cfg.n_sparse
        sp = (B, F) if cfg.multi_hot == 1 else (B, F, cfg.multi_hot)
        base = {"dense": _sds((B, cfg.n_dense), f32), "sparse": _sds(sp, i32)}
        if cell.step_kind == "train":
            return "train", base | {"label": _sds((B,), f32)}
        if cell.step_kind == "retrieval":
            return "retrieval", base | {
                "candidates": _sds((d["n_candidates"],), i32)}
        return "serve", base

    if fam == "din":
        B = d["batch"]
        base = {"hist_items": _sds((B, cfg.seq_len), i32),
                "hist_cates": _sds((B, cfg.seq_len), i32)}
        if cell.step_kind == "retrieval":
            N = d["n_candidates"]
            return "retrieval", base | {"candidates": _sds((N,), i32),
                                        "candidate_cates": _sds((N,), i32)}
        base |= {"target_item": _sds((B,), i32),
                 "target_cate": _sds((B,), i32)}
        if cell.step_kind == "train":
            return "train", base | {"label": _sds((B,), f32)}
        return "serve", base

    if fam == "bert4rec":
        B = d["batch"]
        base = {"items": _sds((B, cfg.seq_len), i32)}
        if cell.step_kind == "train":
            extra = {"labels": _sds((B, cfg.seq_len), i32)}
            if cfg.loss == "sampled":
                extra["negatives"] = _sds((cfg.n_negatives,), i32)
            return "train", base | extra
        if cell.step_kind == "retrieval":
            return "retrieval", base | {
                "candidates": _sds((d["n_candidates"],), i32)}
        return "serve", base | {"candidates": _sds((B, SLATE), i32)}

    if fam == "xdeepfm":
        B = d["batch"]
        base = {"sparse": _sds((B, cfg.n_fields), i32)}
        if cell.step_kind == "train":
            return "train", base | {"label": _sds((B,), f32)}
        if cell.step_kind == "retrieval":
            return "retrieval", {"sparse": _sds((1, cfg.n_fields), i32),
                                 "candidates": _sds((d["n_candidates"],), i32)}
        return "serve", base

    if fam == "gat":
        if shape_id == "minibatch_lg":
            bd = sampled_block_dims(d["batch_nodes"], d["fanout0"],
                                    d["fanout1"])
            return "train", {
                "block0_feats": _sds((bd["n0"], d["d_feat"]), f32),
                "block0_src": _sds((bd["e0"],), i32),
                "block0_dst": _sds((bd["e0"],), i32),
                "block0_mask": _sds((bd["e0"],), torch.bool),
                "block1_src": _sds((bd["e1"],), i32),
                "block1_dst": _sds((bd["e1"],), i32),
                "block1_mask": _sds((bd["e1"],), torch.bool),
                "labels": _sds((d["batch_nodes"],), i32),
                "label_mask": _sds((d["batch_nodes"],), torch.bool),
            }
        if shape_id == "molecule":
            N = d["n_graphs"] * d["nodes_per"]
            E = d["n_graphs"] * d["edges_per"]
            return "train", {
                "features": _sds((N, d["d_feat"]), f32),
                "edge_src": _sds((E,), i32),
                "edge_dst": _sds((E,), i32),
                "graph_ids": _sds((N,), i32),
                "labels": _sds((d["n_graphs"],), i32),
            }
        return "train", {
            "features": _sds((d["n_nodes"], d["d_feat"]), f32),
            "edge_src": _sds((d["n_edges"],), i32),
            "edge_dst": _sds((d["n_edges"],), i32),
            "labels": _sds((d["n_nodes"],), i32),
            "label_mask": _sds((d["n_nodes"],), torch.bool),
        }

    raise ValueError(fam)


# ---------------------------------------------------------------------------
# concrete reduced batches (smoke tests)
# ---------------------------------------------------------------------------

def smoke_batch(arch_id: str, shape_id: str, seed: int = 0
                ) -> tuple[str, Any, dict]:
    """(step_kind, reduced cfg, concrete numpy batch) at REDUCED config."""
    from repro_torch.data import synthetic as syn
    spec = get_arch(arch_id)
    cfg = spec.reduced
    fam = spec.family
    cell = get_cell(arch_id, shape_id)
    rng = np.random.default_rng(seed)

    if fam == "lm":
        rd = LM_CELLS_RED[shape_id]
        B, S = rd["batch"], rd["seq"]
        if cell.step_kind == "train":
            return "train", cfg, syn.lm_batch(B, S, cfg.vocab, seed=seed,
                                              step=0)
        if cell.step_kind == "prefill":
            return "prefill", cfg, {"tokens": rng.integers(
                0, cfg.vocab, (B, S)).astype(np.int32)}
        return "decode", cfg, {
            "token": rng.integers(0, cfg.vocab, (B,)).astype(np.int32),
            "s_max": S}

    if fam == "dlrm":
        rd = RECSYS_CELLS_RED[shape_id]
        b = syn.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, rd["batch"],
                           seed=seed, step=0, multi_hot=cfg.multi_hot)
        if cell.step_kind == "retrieval":
            b = {k: v[:1] for k, v in b.items() if k != "label"}
            b["candidates"] = rng.integers(
                0, cfg.vocab_sizes[0], rd["n_candidates"]).astype(np.int32)
            return "retrieval", cfg, b
        if cell.step_kind == "serve":
            b.pop("label")
            return "serve", cfg, b
        return "train", cfg, b

    if fam == "din":
        rd = RECSYS_CELLS_RED[shape_id]
        b = syn.din_batch(cfg.n_items, cfg.n_cates, cfg.seq_len, rd["batch"],
                          seed=seed, step=0)
        if cell.step_kind == "retrieval":
            N = rd["n_candidates"]
            b = {"hist_items": b["hist_items"][:1],
                 "hist_cates": b["hist_cates"][:1],
                 "candidates": rng.integers(0, cfg.n_items, N)
                 .astype(np.int32),
                 "candidate_cates": rng.integers(0, cfg.n_cates, N)
                 .astype(np.int32)}
            return "retrieval", cfg, b
        if cell.step_kind == "serve":
            b.pop("label")
            return "serve", cfg, b
        return "train", cfg, b

    if fam == "bert4rec":
        rd = RECSYS_CELLS_RED[shape_id]
        B = rd["batch"]
        b = syn.bert4rec_batch(
            cfg.n_items, cfg.seq_len, B, seed=seed, step=0,
            n_negatives=cfg.n_negatives if cfg.loss == "sampled" else 0)
        if cell.step_kind == "train":
            return "train", cfg, b
        items = rng.integers(0, cfg.n_items, (B, cfg.seq_len)) \
            .astype(np.int32)
        if cell.step_kind == "retrieval":
            return "retrieval", cfg, {
                "items": items[:1],
                "candidates": rng.integers(0, cfg.n_items,
                                           rd["n_candidates"])
                .astype(np.int32)}
        return "serve", cfg, {
            "items": items,
            "candidates": rng.integers(0, cfg.n_items, (B, 16))
            .astype(np.int32)}

    if fam == "xdeepfm":
        rd = RECSYS_CELLS_RED[shape_id]
        b = syn.xdeepfm_batch(cfg.vocab_sizes, rd["batch"], seed=seed,
                              step=0)
        if cell.step_kind == "retrieval":
            return "retrieval", cfg, {
                "sparse": b["sparse"][:1],
                "candidates": rng.integers(0, cfg.vocab_sizes[0],
                                           rd["n_candidates"])
                .astype(np.int32)}
        if cell.step_kind == "serve":
            b.pop("label")
            return "serve", cfg, b
        return "train", cfg, b

    if fam == "gat":
        rd = GNN_CELLS_RED[shape_id]
        gcfg = gat_config_for_shape(cfg, rd)
        if shape_id == "molecule":
            return "train", gcfg, syn.molecule_batch(
                rd["n_graphs"], rd["nodes_per"], rd["edges_per"],
                rd["d_feat"], rd["n_classes"], seed=seed)
        if shape_id == "minibatch_lg":
            return "train", gcfg, _smoke_sampled_blocks(rd, seed)
        return "train", gcfg, syn.random_graph(
            rd["n_nodes"], rd["n_edges"], rd["d_feat"], rd["n_classes"],
            seed=seed)

    raise ValueError(fam)


def sampled_blocks(g: dict, csr, seeds: np.ndarray, d: dict,
                   seed: int) -> dict:
    """The padded batch of ``forward_blocks`` from the real sampler:
    ``NeighborSampler(csr, (fanout0, fanout1), seed)`` over ``seeds``,
    each block's edges padded to ``sampled_block_dims`` (masked off), the
    outer block's src features gathered from ``g["features"]`` into
    (n0, d_feat), the seeds' labels. ``d`` holds ``batch_nodes``,
    ``fanout0``, ``fanout1`` and ``d_feat``."""
    from repro_torch.sparse.sampler import NeighborSampler
    blocks = NeighborSampler(csr, (d["fanout0"], d["fanout1"]),
                             seed=seed).sample(seeds)
    bd = sampled_block_dims(d["batch_nodes"], d["fanout0"], d["fanout1"])

    def pad(a, n, fill=0):
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:a.shape[0]] = a
        return out

    b0, b1 = blocks[0], blocks[1]
    feats = np.zeros((bd["n0"], d["d_feat"]), np.float32)
    feats[:len(b0.src_ids)] = g["features"][b0.src_ids]
    return {
        "block0_feats": feats,
        "block0_src": pad(b0.edge_src, bd["e0"]),
        "block0_dst": pad(b0.edge_dst, bd["e0"]),
        "block0_mask": pad(b0.edge_mask, bd["e0"], False),
        "block1_src": pad(b1.edge_src, bd["e1"]),
        "block1_dst": pad(b1.edge_dst, bd["e1"]),
        "block1_mask": pad(b1.edge_mask, bd["e1"], False),
        "labels": g["labels"][seeds].astype(np.int32),
        "label_mask": np.ones(d["batch_nodes"], bool),
    }


def _smoke_sampled_blocks(rd: dict, seed: int) -> dict:
    """The real neighbor sampler on a small random graph (200 nodes, 2,000
    edges) -> padded blocks."""
    from repro_torch.data import synthetic as syn
    from repro_torch.sparse.sampler import build_csr
    rng = np.random.default_rng(seed)
    g = syn.random_graph(200, 2000, rd["d_feat"], rd["n_classes"], seed=seed)
    csr = build_csr(g["edge_src"].astype(np.int64),
                    g["edge_dst"].astype(np.int64), 200)
    seeds = rng.choice(200, rd["batch_nodes"], replace=False)
    return sampled_blocks(g, csr, seeds, rd, seed)
