"""BERT4Rec (Sun et al., arXiv:1904.06690): a bidirectional transformer
over the user's item sequence, trained with masked-item (cloze)
prediction; the port of ``repro/models/bert4rec.py``.

The item embedding is a dense per-position lookup of one banked table
(``banked_gather``, no kernel; the last row is the mask token), and the
output head ties it. ``loss='sampled'`` scores the at most ``max_masked``
masked positions of a sequence against their label and ``n_negatives``
shared negatives (``batch['negatives']``); ``'full'`` is the softmax over
the whole catalog.

Under ``dist`` the table is the rank's bank shard and the batch the rank's
dp slice. The sampled loss spreads the negatives over the grid, as the
reference's ``all_mesh_axes`` does: each rank scores the whole batch's
masked positions against its piece of the negatives, and their
log-sum-exp is the cross-rank one (``dist.collectives``). Under a dp cut
a rank's loss is its share of the global mean, scaled by the dp size, so
the train step's dp mean is the global batch's loss and gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import BankedTable, banked_gather
from repro_torch.core.partitioning import uniform_partition
from repro_torch.dist import collectives as coll
from repro_torch.models import layers as L
from repro_torch.models.common import (banked, dense_init, embed_init,
                                       table_statics)

_COLLIDE = -1e30


@dataclasses.dataclass(frozen=True)
class Bert4RecConfig:
    name: str
    n_items: int               # catalog size; +1 mask token appended
    embed_dim: int             # 64
    n_blocks: int              # 2
    n_heads: int               # 2
    seq_len: int               # 200
    d_ff: int = 256            # 4x embed_dim (paper)
    dtype: Any = torch.float32
    loss: str = "sampled"      # "sampled" | "full"
    n_negatives: int = 2048
    max_masked: int = 40       # static cap: ceil(0.15 * seq_len) + slack

    @property
    def vocab(self) -> int:
        return self.n_items + 1   # last row = [mask]

    @property
    def mask_token(self) -> int:
        return self.n_items

    def param_count(self) -> int:
        d = self.embed_dim
        per_block = 4 * d * d + 2 * d * self.d_ff + self.d_ff + d + 4 * d
        return self.vocab * d + self.seq_len * d + self.n_blocks * per_block


def init_params(cfg: Bert4RecConfig, generator: torch.Generator, plan=None,
                *, device: str | torch.device | None = "cuda"
                ) -> tuple[dict, dict]:
    """(params, statics) from ``generator`` (on ``device``): the
    reference's shapes and distributions, the blocks' weights stacked on a
    leading ``n_blocks`` dim; ``plan`` a PartitionPlan of the vocab
    (default: one bank)."""
    dev = resolve_device(device)
    if plan is None:
        plan = uniform_partition(cfg.vocab, 1)
    rows = int(plan.max_rows_per_bank)
    d, ff, nb = cfg.embed_dim, cfg.d_ff, cfg.n_blocks

    def stk(*shape):
        return torch.stack([dense_init(generator, shape, dtype=cfg.dtype,
                                       device=dev) for _ in range(nb)])

    def const(v, *shape):
        return torch.full((nb, *shape), v, dtype=cfg.dtype, device=dev)

    params = {
        "emb_packed": embed_init(generator, (plan.n_banks * rows, d),
                                 dtype=cfg.dtype, device=dev),
        "pos": embed_init(generator, (cfg.seq_len, d), dtype=cfg.dtype,
                          device=dev),
        "blocks": {
            "wq": stk(d, d), "wk": stk(d, d), "wv": stk(d, d),
            "wo": stk(d, d), "w_in": stk(d, ff), "b_in": const(0.0, ff),
            "w_out": stk(ff, d), "b_out": const(0.0, d),
            "ln1_s": const(1.0, d), "ln1_b": const(0.0, d),
            "ln2_s": const(1.0, d), "ln2_b": const(0.0, d),
        },
        "out_bias": torch.zeros((cfg.vocab,), dtype=cfg.dtype, device=dev),
    }
    return params, table_statics(plan, device=dev)


def encode(cfg: Bert4RecConfig, params: dict, statics: dict,
           items: torch.Tensor, dist=None) -> torch.Tensor:
    """items (B, S) int32 (-1 pad) -> hidden (B, S, d). Bidirectional:
    each block is pre-norm attention and a pre-norm GELU MLP, both
    residual."""
    B, S = items.shape
    h = banked_gather(banked(params, statics), items, dist) \
        + params["pos"][None, :S]
    h = h.to(cfg.dtype)
    blocks = params["blocks"]
    for i in range(cfg.n_blocks):
        bw = {k: v[i].to(cfg.dtype) for k, v in blocks.items()}
        x = L.layer_norm(h, bw["ln1_s"], bw["ln1_b"])
        q = (x @ bw["wq"]).reshape(B, S, cfg.n_heads, -1)
        k = (x @ bw["wk"]).reshape(B, S, cfg.n_heads, -1)
        v = (x @ bw["wv"]).reshape(B, S, cfg.n_heads, -1)
        attn = L.blockwise_attention(q, k, v, causal=False,
                                     q_chunk=min(1024, S),
                                     kv_chunk=min(1024, S))
        h = h + attn.reshape(B, S, -1) @ bw["wo"]
        x = L.layer_norm(h, bw["ln2_s"], bw["ln2_b"])
        h = h + L.gelu_mlp(x, bw["w_in"], bw["b_in"], bw["w_out"],
                           bw["b_out"])
    return h


def _batch_mean(total: torch.Tensor, count: torch.Tensor, dist):
    """``total / max(count, 1)``; under a dp cut the rank's share of the
    global mean, ``n_dp * total / max(global count, 1)``, whose dp mean
    (the train step's) is the global batch's mean."""
    if dist is None or not coll._dp_cut(dist):
        return total / torch.clamp(count, min=1)
    glob = dist.psum(count.detach(), "dp")
    return total * dist.dp_size() / torch.clamp(glob, min=1)


def _negatives_lse(cfg, params, t, h_m, lab, negs, dist):
    """log-sum-exp over the shared negatives of every masked position's
    logits (B, m): ``h_m . e_n + out_bias[n]``, -1e30 where a negative is
    the position's own label. Under ``dist`` with the negatives spread,
    each rank scores the global batch's positions (``gather_dp``) against
    its piece, the cross-rank log-sum-exp joins the pieces and the rank
    keeps its dp rows."""
    n = negs.shape[0]
    if not coll.is_spread(dist, n):
        e_neg = banked_gather(t, negs, coll.query_ctx(dist, n))  # (N, d)
        l_neg = torch.einsum("bmd,nd->bmn", h_m.float(), e_neg.float())
        l_neg = l_neg + params["out_bias"][negs.long()][None, None, :]
        l_neg = torch.where(lab[..., None] == negs[None, None, :],
                            torch.full_like(l_neg, _COLLIDE), l_neg)
        return torch.logsumexp(l_neg, dim=-1)
    H = coll.gather_dp(h_m, dist)                           # (B, m, d)
    lab_all = coll.gather_dp(lab, dist)
    e_neg = coll.spread_gather(t, negs, dist)               # (n, d)
    bias = coll.spread(params["out_bias"][negs.long()], dist)
    mine = negs[coll.spread_slice(dist, n)]
    l_neg = torch.einsum("bmd,nd->bmn", H.float(), e_neg.float())
    l_neg = l_neg + bias[None, None, :]
    l_neg = torch.where(lab_all[..., None] == mine[None, None, :],
                        torch.full_like(l_neg, _COLLIDE), l_neg)
    lse = coll.cross_rank_logsumexp(l_neg, dist, -1)
    return coll.dp_rows(lse, dist, h_m.shape[0])


def mlm_loss(cfg: Bert4RecConfig, params: dict, statics: dict, batch: dict,
             dist=None) -> torch.Tensor:
    """Cloze objective: ``items`` with mask tokens, ``labels`` the original
    ids at masked positions (-100 elsewhere), ``negatives`` (N,) the shared
    negatives (``loss='sampled'``; under ``dist`` the same on every rank).

    ``'sampled'``: the first ``max_masked`` masked positions of a sequence
    (``jax.lax.top_k`` over ``2 * sel - 1``, ties toward the lower
    position: a stable sort here), each scored against its label and the
    negatives; the loss is ``logaddexp(logsumexp(l_neg), l_pos) - l_pos``
    averaged over the valid positions. ``'full'``: the softmax over the
    whole catalog."""
    items, labels = batch["items"], batch["labels"]
    h = encode(cfg, params, statics, items, dist)
    sel = labels >= 0
    t = banked(params, statics)
    if cfg.loss == "sampled":
        m = cfg.max_masked
        key = sel.to(torch.int32) * 2 - 1
        score, pos = torch.sort(key, dim=1, descending=True, stable=True)
        score, pos = score[:, :m], pos[:, :m]
        valid = score > 0                                        # (B, m)
        h_m = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
        lab = torch.gather(torch.where(sel, labels, 0), 1, pos)
        e_pos = banked_gather(t, torch.where(valid, lab, -1), dist)
        l_pos = torch.einsum("bmd,bmd->bm", h_m.float(), e_pos.float())
        l_pos = l_pos + params["out_bias"][
            torch.where(valid, lab, 0).long()]
        lse_neg = _negatives_lse(cfg, params, t, h_m, lab,
                                 batch["negatives"], dist)
        lse = torch.logaddexp(lse_neg, l_pos)
        per_tok = torch.where(valid, lse - l_pos, torch.zeros_like(l_pos))
        return _batch_mean(per_tok.sum(), valid.sum(), dist)
    if cfg.loss != "full":
        raise ValueError(f"loss must be 'sampled' or 'full', got {cfg.loss!r}")
    table = _catalog(cfg, t, dist)                               # (V, d)
    logits = torch.einsum("bsd,vd->bsv", h.float(), table.float())
    logits = logits + params["out_bias"]
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.where(sel, labels, 0).long()
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    per_tok = torch.where(sel, lse - ll, torch.zeros_like(ll))
    return _batch_mean(per_tok.sum(), sel.sum(), dist)


def _catalog(cfg: Bert4RecConfig, t: BankedTable, dist) -> torch.Tensor:
    """Every item row (and the mask token's), (vocab, d), on every rank."""
    ids = torch.arange(cfg.vocab, dtype=torch.int32, device=t.packed.device)
    return banked_gather(t, ids, coll.query_ctx(dist, cfg.vocab))


def loss_fn(cfg, params, statics, batch, dist=None):
    return mlm_loss(cfg, params, statics, batch, dist)


def next_item_scores(cfg: Bert4RecConfig, params: dict, statics: dict,
                     batch: dict, dist=None) -> torch.Tensor:
    """Serving: the hidden state at the last position of ``items`` (B, S)
    scored against ``candidates``: (N,) shared (B, N), without
    ``out_bias``; (B, N) a slate per user, without ``out_bias``; absent,
    the full catalog (B, vocab), with ``out_bias`` (the reference's three
    forms). ``dist``: ``items`` (and a slate) are the rank's dp slice; a
    shared list is the same on every rank and spread, and a rank returns
    its piece's scores (``dist.collectives.spread_slice``)."""
    h = encode(cfg, params, statics, batch["items"], dist)[:, -1]  # (B, d)
    t = banked(params, statics)
    cand = batch.get("candidates")
    if cand is not None and cand.dim() == 2:
        emb = banked_gather(t, cand, dist)                       # (B, N, d)
        return torch.einsum("bd,bnd->bn", h.float(), emb.float())
    if cand is not None:
        emb = coll.spread_gather(t, cand, dist)                  # (n, d)
        return torch.einsum("bd,nd->bn", h.float(), emb.float())
    table = _catalog(cfg, t, dist)
    return torch.einsum("bd,vd->bv", h.float(), table.float()) \
        + params["out_bias"]


def retrieval_scores(cfg: Bert4RecConfig, params: dict, statics: dict,
                     batch: dict, dist=None) -> torch.Tensor:
    """The retrieval_cand entry point (the other families' signature):
    ``next_item_scores`` with the query held whole on every rank under
    ``dist``, as every family's retrieval batch is."""
    return next_item_scores(cfg, params, statics, batch,
                            coll.query_ctx(dist, batch["items"].shape[0]))
