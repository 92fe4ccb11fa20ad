"""DLRM (Naumov et al., arXiv:1906.00091) with UpDLRM banked embeddings.

The port of ``repro/models/dlrm.py``. All sparse fields share ONE banked
super-table (per-field row offsets), so the paper's partitioners operate on
the union vocabulary. Two lookup flavours:

  * one-hot fields (Criteo-style ``dlrm-rm2``): dense gather (B, F) -> (B, F, D)
  * multi-hot bags (the paper's Table-1 datasets): (B, F, L) -> bag sums
    (B, F, D) in one fused stage-2 pass (the banked-bag kernel on CUDA).

The pairwise-dot interaction runs the dot-interaction kernel on CUDA and
its plain version on the CPU. MLP weights keep the reference's (in, out)
layout and are applied as ``x @ w + b``. Both kernels sit inside
``torch.autograd.Function``s, so ``loss_fn`` differentiates through them:
the bag sums' backward is the sorted-run scatter (core/embedding.py), the
interaction's is plain torch (the reference leaves it to XLA too).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import (BankedTable,
                                        banked_cache_residual_bag,
                                        banked_embedding_bag, banked_gather,
                                        flat_remap, tiered_embedding_bag)
from repro_torch.core.partitioning import uniform_partition
from repro_torch.kernels import dot_interaction as _dot
from repro_torch.models.common import dense_init, embed_init


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    vocab_sizes: tuple[int, ...]       # per sparse field
    embed_dim: int
    n_dense: int
    bot_mlp: tuple[int, ...]           # hidden dims incl. final (== embed_dim)
    top_mlp: tuple[int, ...]           # hidden dims, final 1 appended
    multi_hot: int = 1                 # bag length per field (1 => one-hot)
    interaction: str = "dot"
    dtype: Any = torch.float32
    # table STORAGE dtype — bf16 halves every table-sized buffer; dense
    # compute stays cfg.dtype
    emb_dtype: Any = torch.float32

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    def param_count(self) -> int:
        n = self.total_vocab * self.embed_dim
        dims = [self.n_dense, *self.bot_mlp]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        n_inter = self.n_sparse + 1
        top_in = n_inter * (n_inter - 1) // 2 + self.embed_dim
        dims = [top_in, *self.top_mlp, 1]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n


def _mlp_params(generator: torch.Generator, dims: Sequence[int], dtype,
                device) -> dict:
    return {
        "w": [dense_init(generator, (a, b), dtype=dtype, device=device)
              for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.zeros((b,), dtype=dtype, device=device) for b in dims[1:]],
    }


def mlp_apply(p: dict, x: torch.Tensor, act=torch.relu,
              final_act=None) -> torch.Tensor:
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def init_params(cfg: DLRMConfig, generator: torch.Generator, plan=None,
                rows_per_bank: int | None = None, *,
                device: str | torch.device | None = "cuda"
                ) -> tuple[dict, dict]:
    """Returns (params, statics). ``plan`` is a PartitionPlan over the union
    vocab (default: one bank, identity layout); statics carries the row
    remap. ``generator`` lives on ``device``. ``rows_per_bank``
    over-allocates each bank to a fixed capacity (>= the plan's max)."""
    dev = resolve_device(device)
    if plan is None:
        plan = uniform_partition(cfg.total_vocab, 1)
    rows_per_bank = int(plan.max_rows_per_bank if rows_per_bank is None
                        else rows_per_bank)
    if rows_per_bank < plan.max_rows_per_bank:
        raise ValueError(f"rows_per_bank {rows_per_bank} < the plan's "
                         f"{plan.max_rows_per_bank}")
    packed = embed_init(generator, (plan.n_banks * rows_per_bank,
                                    cfg.embed_dim),
                        dtype=cfg.emb_dtype, device=dev)
    params = {
        "emb_packed": packed,
        "bot": _mlp_params(generator, [cfg.n_dense, *cfg.bot_mlp], cfg.dtype,
                           dev),
        "top": _mlp_params(
            generator,
            [cfg.n_sparse * (cfg.n_sparse + 1) // 2 + cfg.embed_dim,
             *cfg.top_mlp, 1],
            cfg.dtype, dev),
    }
    return params, plan_statics(cfg, plan, rows_per_bank, device=dev)


def plan_statics(cfg: DLRMConfig, plan, rows_per_bank: int, *,
                 device: str | torch.device | None = "cuda") -> dict:
    """The statics ``init_params`` returns for ``plan`` at a per-bank
    capacity of ``rows_per_bank``: the row remaps (bank, slot and the flat
    remap computed once), the bank count and capacity, the field offsets."""
    dev = resolve_device(device)
    remap_bank = torch.from_numpy(plan.bank_of_row.astype(np.int32)).to(dev)
    remap_slot = torch.from_numpy(plan.slot_of_row.astype(np.int32)).to(dev)
    return {
        "remap_bank": remap_bank,
        "remap_slot": remap_slot,
        "remap_flat": flat_remap(remap_bank, remap_slot, rows_per_bank),
        "n_banks": plan.n_banks,
        "rows_per_bank": rows_per_bank,
        "field_offsets": torch.from_numpy(
            cfg.field_offsets().astype(np.int32)).to(dev),
    }


def _banked(params: dict, statics: dict) -> BankedTable:
    return BankedTable(
        packed=params["emb_packed"],
        remap_bank=statics["remap_bank"],
        remap_slot=statics["remap_slot"],
        n_banks=statics["n_banks"],
        rows_per_bank=statics["rows_per_bank"],
        remap_flat=statics["remap_flat"],
    )


class _DotInteraction(torch.autograd.Function):
    """The interaction kernel's wrapper (``plain``: its plain version) with
    a plain-torch backward: the (B, P) cotangent scattered into the upper
    triangle of G (B, F, F), then ``dz = (G + Gᵀ) z``."""

    @staticmethod
    def forward(ctx, z, plain: bool):
        ctx.save_for_backward(z)
        return (_dot.dot_interaction_plain if plain
                else _dot.dot_interaction)(z)

    @staticmethod
    def backward(ctx, ct):
        (z,) = ctx.saved_tensors
        B, F, _ = z.shape
        iu, ju = torch.triu_indices(F, F, offset=1, device=z.device)
        g = torch.zeros((B, F, F), dtype=torch.float32, device=z.device)
        g[:, iu, ju] = ct.float()
        return torch.bmm(g + g.mT, z.float()).to(z.dtype), None


def dot_interaction(z: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """z: (B, F, D) -> (B, F*(F-1)/2) upper-triangular pairwise dots.

    'auto' runs the kernel on CUDA tensors and the plain version on CPU
    tensors; 'torch' the plain version anywhere; 'cuda' the kernel only.
    All three share one backward."""
    if backend == "cuda" and z.device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {z.device}")
    return _DotInteraction.apply(z.contiguous(), backend == "torch")


def forward(cfg: DLRMConfig, params: dict, statics: dict, batch: dict,
            dist=None, *, backend: str = "auto", bwd_backend: str = "auto",
            tiered=None, replicated=None,
            bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """batch: dense (B, n_dense) fp; sparse (B, F) int32 (one-hot fields) or
    (B, F, L) multi-hot. Returns logits (B,).

    ``backend`` selects the kernels or their plain versions for the bag
    sums and the interaction ('auto' | 'torch' | 'cuda'; see
    core/embedding.py); ``bwd_backend`` the bag sums' gradient scatter
    ('auto' follows ``backend``). The multi-hot path hands the RAW (B, F, L)
    per-field ids plus ``field_offsets`` to ONE fused banked_embedding_bag
    call. ``bank_live`` ((n_banks,) bool) serves through a bank failure:
    reads homed on dead banks resolve to the zero row.

    ``tiered`` (a ``quant.TieredTable`` in the packed layout of
    ``params['emb_packed']``) serves the tiered-precision lookup instead:
    the bag sums dequantize each row by its tier (the tiered kernel on CUDA
    tensors), and gradients flow straight through onto
    ``params['emb_packed']``; one-hot fields fold into length-1 bags. It
    does not combine with ``bank_live`` or ``replicated`` (ValueError, as
    in the reference).
    """
    dense, sparse = batch["dense"], batch["sparse"]
    t = _banked(params, statics)
    if replicated is not None:
        if tiered is not None:
            raise ValueError("tiered x replicated serving is not wired — "
                             "replicas are the full-precision head")
        raise NotImplementedError("replicated-table lookup is not ported "
                                  "yet: ROADMAP queue 1 #12")
    if tiered is not None:
        if bank_live is not None:
            raise ValueError("bank_live degraded serving is not wired into "
                             "the tiered lookup path")
        bags = sparse if sparse.dim() == 3 else sparse[..., None]
        emb = tiered_embedding_bag(                              # (B, F, D)
            params["emb_packed"], tiered, bags, dist, backend=backend,
            bwd_backend=bwd_backend, field_offsets=statics["field_offsets"])
    elif sparse.dim() == 2:
        # one-hot fields: dense gather; per-field ids -> union-vocab rows
        rows = sparse + statics["field_offsets"][None, :]
        rows = torch.where(sparse >= 0, rows, -1)
        emb = banked_gather(t, rows, dist, bank_live=bank_live)  # (B, F, D)
    else:
        emb = banked_embedding_bag(                              # (B, F, D)
            t, sparse, dist, backend=backend, bwd_backend=bwd_backend,
            field_offsets=statics["field_offsets"], bank_live=bank_live)
    emb = emb.to(cfg.dtype)

    x = mlp_apply(params["bot"], dense.to(cfg.dtype))            # (B, D)
    z = torch.cat([x[:, None], emb], dim=1)                      # (B, F+1, D)
    inter = dot_interaction(z, backend)                          # (B, P)
    feat = torch.cat([inter, x], dim=-1)
    return mlp_apply(params["top"], feat)[:, 0]


def forward_cached(cfg: DLRMConfig, params: dict, statics: dict,
                   cache_table: BankedTable, batch: dict, dist=None, *,
                   backend: str = "auto", bwd_backend: str = "auto",
                   remap_bank: torch.Tensor | None = None,
                   remap_slot: torch.Tensor | None = None,
                   bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """Cache-aware path (Fig. 7): the batch carries rewritten multi-hot
    bags, ``cache_idx`` (B, F, Lc) entries into the partial-sum cache table
    and ``residual_idx`` (B, F, Lr) union-vocab rows, beside ``dense``.
    Bag sum = cache partials + residual rows in ONE fused stage-2 pass
    (``banked_cache_residual_bag``: the fused kernel on CUDA tensors), then
    the same CTR compute as ``forward``. Returns logits (B,).

    ``remap_bank`` / ``remap_slot`` override the EMT remaps in ``statics``
    (the flat remap is then computed anew)."""
    if remap_bank is not None:
        statics = {**statics, "remap_bank": remap_bank,
                   "remap_slot": remap_slot,
                   "remap_flat": flat_remap(remap_bank, remap_slot,
                                            statics["rows_per_bank"])}
    t = _banked(params, statics)
    emb = banked_cache_residual_bag(t, cache_table, batch["cache_idx"],
                                    batch["residual_idx"], dist,
                                    backend=backend, bwd_backend=bwd_backend,
                                    bank_live=bank_live)             # (B, F, D)
    x = mlp_apply(params["bot"], batch["dense"].to(cfg.dtype))       # (B, D)
    z = torch.cat([x[:, None], emb], dim=1)                          # (B, F+1, D)
    inter = dot_interaction(z, backend)                              # (B, P)
    feat = torch.cat([inter, x], dim=-1)
    return mlp_apply(params["top"], feat)[:, 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(cfg: DLRMConfig, params: dict, statics: dict, batch: dict,
            dist=None, *, backend: str = "auto", bwd_backend: str = "auto",
            tiered=None) -> torch.Tensor:
    return bce_loss(forward(cfg, params, statics, batch, dist,
                            backend=backend, bwd_backend=bwd_backend,
                            tiered=tiered),
                    batch["label"])
