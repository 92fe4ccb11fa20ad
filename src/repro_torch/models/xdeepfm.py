"""xDeepFM (Lian et al., arXiv:1803.05170): CIN + deep MLP + linear; the
port of ``repro/models/xdeepfm.py``.

CIN layer k: ``X^{k+1}_h = sum_{i,j} W^{k,h}_{ij} (X^k_i * X^0_j)``, an
outer product along the fields shared over the embedding dim, compressed
to H_k feature maps, each sum-pooled over D after its layer. The field
embeddings (dim D) and the linear weights (dim 1) are two banked
super-tables of one-hot fields, ``emb_packed`` and ``lin_packed``, over one
plan, read by ``banked_gather`` (no kernel).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import banked_gather
from repro_torch.core.partitioning import uniform_partition
from repro_torch.dist.collectives import spread_gather
from repro_torch.models.common import (banked, dense_init, embed_init,
                                       table_statics)
from repro_torch.models.dlrm import _mlp_params, bce_loss, mlp_apply


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    vocab_sizes: tuple[int, ...]   # 39 fields
    embed_dim: int                 # 10
    cin_layers: tuple[int, ...]    # (200, 200, 200)
    mlp: tuple[int, ...]           # (400, 400)
    dtype: Any = torch.float32

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    def param_count(self) -> int:
        m, D = self.n_fields, self.embed_dim
        n = self.total_vocab * (D + 1)     # embeddings + linear (dim-1) weights
        h_prev = m
        for h in self.cin_layers:
            n += h * h_prev * m
            h_prev = h
        n += sum(self.cin_layers)          # sum-pool -> logit weights
        dims = [m * D, *self.mlp, 1]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


def init_params(cfg: XDeepFMConfig, generator: torch.Generator, plan=None,
                *, device: str | torch.device | None = "cuda"
                ) -> tuple[dict, dict]:
    """(params, statics) from ``generator`` (on ``device``): the
    reference's shapes and distributions; ``plan`` a PartitionPlan of the
    union vocab shared by both tables (default: one bank)."""
    dev = resolve_device(device)
    if plan is None:
        plan = uniform_partition(cfg.total_vocab, 1)
    rows = int(plan.max_rows_per_bank)
    m, D = cfg.n_fields, cfg.embed_dim
    params = {
        "emb_packed": embed_init(generator, (plan.n_banks * rows, D),
                                 dtype=cfg.dtype, device=dev),
        "lin_packed": embed_init(generator, (plan.n_banks * rows, 1),
                                 dtype=cfg.dtype, device=dev),
    }
    cin_w, h_prev = [], m
    for h in cfg.cin_layers:
        cin_w.append(dense_init(generator, (h, h_prev, m),
                                scale=1.0 / math.sqrt(h_prev * m),
                                dtype=cfg.dtype, device=dev))
        h_prev = h
    params["cin_w"] = cin_w
    params["cin_out"] = dense_init(generator, (int(sum(cfg.cin_layers)), 1),
                                   dtype=cfg.dtype, device=dev)
    params["mlp"] = _mlp_params(generator, [m * D, *cfg.mlp, 1], cfg.dtype,
                                dev)
    statics = table_statics(plan, device=dev)
    statics["field_offsets"] = torch.from_numpy(
        cfg.field_offsets().astype(np.int32)).to(dev)
    return params, statics


def cin(x0: torch.Tensor, cin_w: list[torch.Tensor]) -> torch.Tensor:
    """x0 (B, m, D) -> the sum-pooled CIN feature maps, (B, sum(H_k))."""
    xk, pooled = x0, []
    for w in cin_w:
        z = torch.einsum("bhd,bmd->bhmd", xk, x0)     # (B, H_prev, m, D)
        xk = torch.einsum("bhmd,ohm->bod", z, w)      # (B, H_k, D)
        pooled.append(xk.sum(-1))                     # (B, H_k)
    return torch.cat(pooled, dim=-1)


def _rows(sparse: torch.Tensor, statics: dict) -> torch.Tensor:
    rows = sparse + statics["field_offsets"][None, :]
    return torch.where(sparse >= 0, rows, -1)


def _logits(params: dict, emb: torch.Tensor,
            lin: torch.Tensor) -> torch.Tensor:
    """emb (B, m, D), lin (B, m, 1) -> linear + CIN + DNN logits (B,)."""
    logit_lin = lin[..., 0].sum(-1)
    logit_cin = (cin(emb, params["cin_w"]) @ params["cin_out"])[:, 0]
    logit_dnn = mlp_apply(params["mlp"], emb.reshape(emb.shape[0], -1))[:, 0]
    return logit_lin + logit_cin + logit_dnn


def forward(cfg: XDeepFMConfig, params: dict, statics: dict, batch: dict,
            dist=None) -> torch.Tensor:
    """batch: sparse (B, m) int32 field values (-1 reads zeros). Returns
    logits (B,). ``dist``: the rank's dp slice of the batch and its bank
    shards of both tables."""
    rows = _rows(batch["sparse"], statics)
    emb = banked_gather(banked(params, statics), rows, dist)
    lin = banked_gather(banked(params, statics, "lin_packed"), rows, dist)
    return _logits(params, emb.to(cfg.dtype), lin.to(cfg.dtype))


def loss_fn(cfg, params, statics, batch, dist=None):
    return bce_loss(forward(cfg, params, statics, batch, dist),
                    batch["label"])


def retrieval_scores(cfg: XDeepFMConfig, params: dict, statics: dict,
                     batch: dict, dist=None) -> torch.Tensor:
    """One query ``sparse`` (1, m), N candidate values of field 0
    ``candidates`` (N,) -> (N,) logits: the query with field 0 replaced by
    each candidate, scored as a batch by ``forward``'s arithmetic.
    ``dist``: the batch is the same on every rank; the N rows are spread
    over the grid and a rank returns the scores of its piece
    (``dist.collectives.spread_slice``)."""
    sparse, cand = batch["sparse"], batch["candidates"]
    sp = sparse.expand(cand.shape[0], -1).clone()
    sp[:, 0] = cand
    if dist is None:
        return forward(cfg, params, statics, {"sparse": sp})
    rows = _rows(sp, statics)
    emb = spread_gather(banked(params, statics), rows, dist)
    lin = spread_gather(banked(params, statics, "lin_packed"), rows, dist)
    return _logits(params, emb.to(cfg.dtype), lin.to(cfg.dtype))
