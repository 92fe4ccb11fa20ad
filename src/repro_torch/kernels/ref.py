"""Plain PyTorch oracles (the port of ``repro/kernels/ref.py``).

These define the semantics the kernels must match:
  * embedding_bag_ref    — padded-bag gather+sum:  (B, L) idx -> (B, D)
  * banked_bag_ref       — the PIM stage-2 semantics: remapped, bank-masked
  * cache_bag_ref        — the fused Fig.-7 lookup: cached partials + residual
  * dot_interaction_ref  — DLRM pairwise-dot upper triangle
"""
from __future__ import annotations

import torch


def embedding_bag_ref(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (V, D); idx (B, L) with -1 padding -> (B, D) bag sums."""
    valid = idx >= 0
    rows = table[torch.where(valid, idx, 0).long()]
    return torch.where(valid[..., None], rows, 0).sum(dim=1)


def banked_bag_ref(table_local: torch.Tensor, bank: torch.Tensor,
                   slot: torch.Tensor, idx: torch.Tensor,
                   my_bank: int) -> torch.Tensor:
    """One bank's partial bag sums (stage 2): only rows owned by my_bank."""
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).long()
    mine = valid & (bank[safe] == my_bank)
    rows = table_local[torch.where(mine, slot[safe], 0).long()]
    return torch.where(mine[..., None], rows, 0).sum(dim=1)


def cache_bag_ref(emt: torch.Tensor, cache: torch.Tensor,
                  cache_idx: torch.Tensor,
                  residual_idx: torch.Tensor) -> torch.Tensor:
    """Fused Fig.-7 lookup: cached partial sums + residual EMT rows."""
    return embedding_bag_ref(cache, cache_idx) \
        + embedding_bag_ref(emt, residual_idx)


def dot_interaction_ref(z: torch.Tensor) -> torch.Tensor:
    """z (B, F, D) -> (B, F*(F-1)/2) upper-triangle pairwise dots."""
    F = z.shape[1]
    zf = z.float()
    zz = torch.einsum("bfd,bgd->bfg", zf, zf)
    iu, ju = torch.triu_indices(F, F, offset=1, device=z.device)
    return zz[:, iu, ju].to(z.dtype)
