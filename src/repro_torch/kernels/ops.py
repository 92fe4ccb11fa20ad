"""Drop-in wrappers around the identity-layout kernels (the port of
``repro/kernels/ops.py``):

    embedding_bag(table, idx)            ~ ref.embedding_bag_ref
    embedding_bag_trainable(table, idx)  the same, differentiable in table
    cache_bag(emt, cache, c_idx, r_idx)  ~ ref.cache_bag_ref
    dot_interaction(z)                   ~ ref.dot_interaction_ref

The tables are unbanked: ids are table rows, -1 is padding. The
reference's TPU layout rules (D padded to 128 lanes, the batch to the
tile) and its ``interpret`` switch have no counterpart: CPU tensors take
the plain versions, CUDA tensors launch the kernels or raise.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dot_interaction import \
    dot_interaction as _dot_interaction
from repro_torch.kernels.embedding_bag import (ct_scatter_identity,
                                               plain_bag, plain_cache_bag)


def embedding_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(V, D) x (B, L) int32, -1 padded -> (B, D): the identity instance of
    the bag kernel (``kernels/embedding_bag.plain_bag``)."""
    return plain_bag(table, idx.to(torch.int32).contiguous())


class _PlainBag(torch.autograd.Function):
    """Bag sums differentiable in ``table``: the identity bag kernel
    forward; backward the sorted-run scatter on the identity prep
    (``ct_scatter_identity``), each row's cotangents added in fp32,
    bag-major as the reference's ``.at[safe].add(updates)`` adds them, and
    cast once to the table's dtype."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.dtype = table.shape[0], table.dtype
        return plain_bag(table, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return ct_scatter_identity(ct.contiguous(), idx, ctx.n_rows,
                                   ctx.dtype), None


def embedding_bag_trainable(table: torch.Tensor,
                            idx: torch.Tensor) -> torch.Tensor:
    """``embedding_bag`` with a gradient for ``table`` (dense, (V, D), zero
    where no entry landed)."""
    return _PlainBag.apply(table, idx.to(torch.int32).contiguous())


def cache_bag(emt: torch.Tensor, cache: torch.Tensor, cache_idx: torch.Tensor,
              residual_idx: torch.Tensor) -> torch.Tensor:
    """Fused Fig.-7 lookup over unbanked tables: one kernel pass over both
    -1 padded streams (``kernels/embedding_bag.plain_cache_bag``) -> (B, D)
    in the EMT's dtype."""
    return plain_cache_bag(emt, cache,
                           cache_idx.to(torch.int32).contiguous(),
                           residual_idx.to(torch.int32).contiguous())


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """(B, F, D) -> (B, F(F-1)/2): the interaction kernel."""
    return _dot_interaction(z.contiguous())
