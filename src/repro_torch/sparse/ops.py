"""Segment reductions and embedding bags over ragged (CSR) and padded bags,
in plain PyTorch (the port of ``repro/sparse/ops.py``: ``segment_sum``,
``segment_max``, ``segment_mean``, ``segment_softmax``,
``offsets_to_segment_ids``, ``embedding_bag``, ``embedding_bag_fixed`` and
``embedding_bag_onehot``).

The segment ops take the reference's ``jax.ops.segment_*`` semantics:
``data`` (n, ...) and ``segment_ids`` (n,) -> (num_segments, ...); an
empty segment sums to 0 and its max is ``-inf``. They are GAT's message
passing (``models/gat.py``): the reference builds it on ``jax.ops``
outside any Pallas call, so these scatters are its port.

Ragged bags are carried in CSR form like ``torch.nn.EmbeddingBag``:
``indices`` is the flat int32 stream and ``offsets[i]`` the start of bag
``i`` (``offsets`` has length ``num_bags``; bag i is
``indices[offsets[i]:offsets[i+1]]``, the last bag runs to the end).
Entries < 0 are padding and add zero. These are the portable oracles; the
bank-partitioned CSR lookup with its kernel is
``core/embedding.csr_embedding_bag``.

The segment sums (and the bags') add in the data's dtype with
``index_add_``: in stream order on the CPU, where they equal the
reference's ``segment_sum``; on a card ``index_add_`` adds in no fixed
order (float atomics), so sums there agree with the CPU's to rounding, not
bit for bit.
"""
from __future__ import annotations

import torch


def offsets_to_segment_ids(offsets: torch.Tensor, total: int) -> torch.Tensor:
    """CSR bag starts (``offsets[0] == 0``) -> the bag of each of ``total``
    entries, int32. A mark at each later bag's start, then a running sum,
    as the reference does: an empty bag repeats an offset and its mark
    adds twice, so the ids skip it; a start at or past ``total`` (a
    trailing empty bag) marks nothing, where the reference's scatter drops
    the out-of-range update. Such a start marks a spare last slot, which is
    dropped, so the host never waits for the device (a boolean mask
    would)."""
    starts = offsets[1:].long().clamp(max=total)
    marks = torch.zeros(total + 1, dtype=torch.int32, device=offsets.device)
    marks.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    return torch.cumsum(marks[:total], 0, dtype=torch.int32)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The sum of ``data``'s rows by segment, (num_segments, ...); ids
    must lie in ``[0, num_segments)``. Differentiable."""
    out = torch.zeros((num_segments, *data.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """The max of ``data``'s rows by segment, (num_segments, ...); an empty
    segment's is ``-inf``, as the reference's. A ``-inf`` init reduced with
    ``include_self=False``: a zero init would give 0 for a segment whose
    values are all negative."""
    ids = segment_ids.long().reshape(-1, *([1] * (data.dim() - 1)))
    out = torch.full((num_segments, *data.shape[1:]), float("-inf"),
                     dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, ids.expand_as(data), data, "amax",
                              include_self=False)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """The mean of ``data``'s rows by segment: the sum over the count,
    clamped at 1 (an empty segment's mean is 0). 1-D data divides by the
    counts, N-D data by the counts with one trailing axis added, as the
    reference broadcasts them."""
    tot = segment_sum(data, segment_ids, num_segments)
    cnt = segment_sum(torch.ones(segment_ids.shape, dtype=data.dtype,
                                 device=data.device),
                      segment_ids, num_segments).clamp(min=1.0)
    return tot / cnt[..., None] if data.dim() > 1 else tot / cnt


def segment_softmax(scores: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int) -> torch.Tensor:
    """Softmax of ``scores`` (n, ...) over each segment's rows: GAT's
    edge softmax over a node's in-edges. The segment max (``-inf`` for an
    empty segment, replaced by 0 to keep ``exp`` finite) is a constant
    shift, which the softmax does not see, so it is taken without a
    gradient (its gradient is 0); the denominator is clamped at 1e-20.
    The gathers are ``index_select``, whose backward adds with
    ``index_add_`` (a subscript's sorts the ids first)."""
    ids = segment_ids.long()
    smax = segment_max(scores.detach(), ids, num_segments)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    ex = torch.exp(scores - smax.index_select(0, ids))
    denom = segment_sum(ex, ids, num_segments)
    return ex / torch.clamp(denom.index_select(0, ids), min=1e-20)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  offsets: torch.Tensor, *, num_bags: int,
                  combiner: str = "sum") -> torch.Tensor:
    """Ragged multi-hot lookup-and-reduce (the DLRM SparseLengthsSum op):
    table (V, D); indices (T,) with -1 padding; offsets (num_bags,) bag
    starts -> (num_bags, D) in the table's dtype. ``combiner='mean'``
    divides by each bag's valid count (at least 1)."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got {combiner!r}")
    seg = offsets_to_segment_ids(offsets, indices.shape[0])
    valid = indices >= 0
    rows = table[torch.where(valid, indices, 0).long()]
    rows = torch.where(valid[:, None], rows, 0)
    out = segment_sum(rows, seg, num_bags)
    if combiner == "mean":
        cnt = segment_sum(valid.to(table.dtype), seg, num_bags)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out


def embedding_bag_fixed(table: torch.Tensor, idx: torch.Tensor, *,
                        combiner: str = "sum") -> torch.Tensor:
    """Rectangular bags: idx (B, L), -1 padded -> (B, D); the padded-bag
    serve path of the recsys models."""
    valid = idx >= 0
    rows = table[torch.where(valid, idx, 0).long()]          # (B, L, D)
    out = torch.where(valid[..., None], rows, 0).sum(dim=1)
    if combiner == "mean":
        out = out / torch.clamp(valid.sum(dim=1, keepdim=True),
                                min=1).to(out.dtype)
    return out


def embedding_bag_onehot(table: torch.Tensor, idx: torch.Tensor
                         ) -> torch.Tensor:
    """Bag sums as multi-hot counts x table (small vocabs only): the same
    function as ``embedding_bag_fixed(..., 'sum')`` by a matrix product, an
    independent oracle."""
    V = table.shape[0]
    onehot = torch.nn.functional.one_hot(
        torch.where(idx >= 0, idx, V).long(), V + 1).to(table.dtype)
    counts = onehot[..., :V].sum(dim=1)                      # (B, V)
    return counts @ table
