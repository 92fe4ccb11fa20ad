"""DIN — Deep Interest Network (Zhou et al., arXiv:1706.06978); the port
of ``repro/models/din.py``.

Target attention over the user's behaviour sequence: the weights come from
an MLP over ``[hist, target, hist - target, hist * target]`` (the paper's
activation unit, attn_mlp 80-40, sigmoid on its hidden layers, the output
left raw: NOT softmax-normalised, masked to 0 on padding), then the
weighted history sum is concatenated with the target and its product with
it and fed to the 200-80 MLP.

Item and category embeddings live in one banked super-table (categories at
rows ``n_items + c``), read by ``banked_gather``: a dense per-position
lookup with no kernel, a ``-1`` id reading a zero row. Under ``dist`` the
table is the rank's bank shard and the lookups sum the banks' partials.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import BankedTable, banked_gather
from repro_torch.core.partitioning import uniform_partition
from repro_torch.dist.collectives import query_ctx, spread_gather
from repro_torch.models.common import banked, embed_init, table_statics
from repro_torch.models.dlrm import _mlp_params, bce_loss, mlp_apply


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str
    n_items: int
    n_cates: int
    embed_dim: int            # 18
    seq_len: int              # 100
    attn_mlp: tuple[int, ...]  # (80, 40)
    mlp: tuple[int, ...]       # (200, 80)
    dtype: Any = torch.float32

    @property
    def total_vocab(self) -> int:
        return self.n_items + self.n_cates

    def param_count(self) -> int:
        d = self.embed_dim * 2  # item ++ cate
        n = self.total_vocab * self.embed_dim
        dims = [4 * d, *self.attn_mlp, 1]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        dims = [3 * d, *self.mlp, 1]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


def init_params(cfg: DINConfig, generator: torch.Generator, plan=None, *,
                device: str | torch.device | None = "cuda"
                ) -> tuple[dict, dict]:
    """(params, statics) from ``generator`` (on ``device``): the
    reference's shapes and distributions; ``plan`` a PartitionPlan of the
    item + category vocab (default: one bank)."""
    dev = resolve_device(device)
    if plan is None:
        plan = uniform_partition(cfg.total_vocab, 1)
    rows = int(plan.max_rows_per_bank)
    d = cfg.embed_dim * 2
    params = {
        "emb_packed": embed_init(generator, (plan.n_banks * rows,
                                             cfg.embed_dim),
                                 dtype=cfg.dtype, device=dev),
        "attn": _mlp_params(generator, [4 * d, *cfg.attn_mlp, 1], cfg.dtype,
                            dev),
        "mlp": _mlp_params(generator, [3 * d, *cfg.mlp, 1], cfg.dtype, dev),
    }
    statics = table_statics(plan, device=dev)
    statics["cate_offset"] = cfg.n_items
    return params, statics


def _cate_rows(statics: dict, cates: torch.Tensor) -> torch.Tensor:
    return torch.where(cates >= 0, cates + statics["cate_offset"], -1)


def _pair_embed(t: BankedTable, statics: dict, items: torch.Tensor,
                cates: torch.Tensor, dist=None) -> torch.Tensor:
    """(item ++ category) embedding: (..., 2 * D)."""
    e_i = banked_gather(t, items, dist)
    e_c = banked_gather(t, _cate_rows(statics, cates), dist)
    return torch.cat([e_i, e_c], dim=-1)


def target_attention(p_attn: dict, hist: torch.Tensor, target: torch.Tensor,
                     mask: torch.Tensor) -> torch.Tensor:
    """hist (B, L, d), target (B, d), mask (B, L) -> the weighted history
    sum (B, d). w = MLP([h, t, h - t, h * t]) with sigmoid hidden layers,
    raw output, 0 where masked."""
    t = target[:, None].expand(hist.shape)
    feat = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    w = mlp_apply(p_attn, feat, act=torch.sigmoid)[..., 0]       # (B, L)
    w = torch.where(mask, w, torch.zeros_like(w))
    return torch.einsum("bl,bld->bd", w, hist)


def _head(params: dict, hist: torch.Tensor, target: torch.Tensor,
          mask: torch.Tensor) -> torch.Tensor:
    interest = target_attention(params["attn"], hist, target, mask)
    feat = torch.cat([interest, target, interest * target], dim=-1)
    return mlp_apply(params["mlp"], feat)[:, 0]


def forward(cfg: DINConfig, params: dict, statics: dict, batch: dict,
            dist=None) -> torch.Tensor:
    """batch: hist_items / hist_cates (B, L) int32 (-1 pad), target_item /
    target_cate (B,) int32. Returns logits (B,). ``dist``: the rank's dp
    slice of the batch and its bank shard of the table."""
    t = banked(params, statics)
    hist = _pair_embed(t, statics, batch["hist_items"], batch["hist_cates"],
                       dist)                                     # (B, L, 2D)
    target = _pair_embed(t, statics, batch["target_item"][:, None],
                         batch["target_cate"][:, None], dist)[:, 0]
    return _head(params, hist.to(cfg.dtype), target.to(cfg.dtype),
                 batch["hist_items"] >= 0)


def loss_fn(cfg: DINConfig, params: dict, statics: dict, batch: dict,
            dist=None) -> torch.Tensor:
    return bce_loss(forward(cfg, params, statics, batch, dist),
                    batch["label"])


def retrieval_scores(cfg: DINConfig, params: dict, statics: dict,
                     batch: dict, dist=None) -> torch.Tensor:
    """One user history x N candidate items -> (N,) logits: the history
    broadcast to every candidate, batched target attention (no loop).
    ``batch``: hist_items / hist_cates (1, L), candidates /
    candidate_cates (N,). ``dist``: the batch is the same on every rank,
    the candidates are spread over the grid and a rank returns the scores
    of its piece (``dist.collectives.spread_slice``)."""
    t = banked(params, statics)
    hist = _pair_embed(t, statics, batch["hist_items"], batch["hist_cates"],
                       query_ctx(dist, batch["hist_items"].shape[0]))
    mask = batch["hist_items"] >= 0                              # (1, L)
    targ = torch.cat([spread_gather(t, batch["candidates"], dist),
                      spread_gather(t, _cate_rows(
                          statics, batch["candidate_cates"]), dist)],
                     dim=-1)                                     # (n, 2D)
    N = targ.shape[0]
    return _head(params, hist.to(cfg.dtype).expand(N, -1, -1),
                 targ.to(cfg.dtype), mask.expand(N, -1))
