"""Communication patterns over a ``DistCtx`` grid shared by the model zoo
(the port of the recsys part of ``repro/dist/collectives.py``).

The reference shards a big leading dim — retrieval candidates, sampled
negatives — over every mesh axis (``all_mesh_axes``) and lets GSPMD carry
the rest. Here every tensor is rank-local, so the same placement is three
explicit steps:

  * ``spread_slice``: rank ``r`` of the ``data x model`` grid takes the
    ``r``-th contiguous piece of a leading dim of ``n`` (rank order, the
    mesh's row-major order), and a dim that does not divide by the world
    stays whole on every rank, as the reference's ``_spread_spec`` falls
    back to replication;
  * ``spread_gather``: the embeddings of this rank's piece of a list of
    rows that every rank holds alike: the bank group gathers its data
    row's block of the list through the bank-sharded lookup (each bank its
    own rows, summed over the bank group), and each bank rank keeps its
    piece of the block; ``spread`` cuts any tensor that every rank holds
    alike the same way. Both are differentiable: a piece's cotangent goes
    back to every rank that holds its block (under a dp cut the bank
    group, whose blocks the train step's dp mean then adds up; else the
    world);
  * ``global_top_k`` merges the ranks' top k into the top k of the whole
    list, and ``cross_rank_logsumexp`` is the log-sum-exp over a dim whose
    pieces sit on different ranks.

``pbroadcast`` and ``psum_replicated`` are the two halves of a value
that every rank holds alike meeting rank-local work, as ``shard_map``
transposes them (GAT's edge-sharded layer, ``models/gat.py``): a
replicated value entering a rank's piece of the work keeps its value and
sums its cotangent over the grid; a sum of the ranks' pieces taken by
work every rank repeats alike keeps the one cotangent every rank holds.

``seqsharded_decode_attention`` is one decode step of GQA attention over
a KV cache cut on its sequence dim: each rank holds its piece, the rank
that owns the new position writes its K/V row, every rank takes a masked
partial softmax over its piece and the pieces combine with the
flash-decode (m, l, o) identity (a max and two sums over the sequence
axes): the same attention as over the whole cache, O(S / n) memory a
rank, O(Hq * Dh) bytes on the wire.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.embedding import (BankedTable, DistCtx, _Psum,
                                        banked_gather)

WORLD = ("dp", "bank")


def _world(dist: DistCtx) -> int:
    return dist.data * dist.model


def is_spread(dist: DistCtx | None, n: int) -> bool:
    """Whether a leading dim of ``n`` is cut over the grid (else whole on
    every rank)."""
    return dist is not None and _world(dist) > 1 and n % _world(dist) == 0


def spread_slice(dist: DistCtx | None, n: int) -> slice:
    """This rank's piece of a leading dim of ``n``: the ``rank``-th of
    ``world`` equal pieces, or all of it when ``n`` does not divide (or
    there is no grid)."""
    if not is_spread(dist, n):
        return slice(0, n)
    k = n // _world(dist)
    return slice(dist.rank * k, (dist.rank + 1) * k)


def _dp_cut(dist: DistCtx) -> bool:
    """Whether the batch is cut over dp (so the train step's dp mean sums
    the dp rows' gradients): a context for a batch that divides, on more
    than one dp rank."""
    return dist.data > 1 and dist.batch is not None \
        and not dist.dp_replicated


class _Split(torch.autograd.Function):
    """Forward: piece ``index`` of ``parts`` of a block that the ranks of
    ``axes`` hold alike. Backward: the pieces' cotangents put back in
    place and summed over ``axes``, the transpose of a piece taken by each
    rank: every rank then holds the block's whole cotangent."""

    @staticmethod
    def forward(ctx, x, dist, index, parts, axes):
        ctx.dist, ctx.axes, ctx.n, ctx.index = dist, axes, x.shape[0], index
        k = x.shape[0] // parts
        return x[index * k:(index + 1) * k].clone()

    @staticmethod
    def backward(ctx, ct):
        full = ct.new_zeros((ctx.n,) + tuple(ct.shape[1:]))
        k = ct.shape[0]
        full[ctx.index * k:(ctx.index + 1) * k] = ct.contiguous()
        return ctx.dist.psum(full, ctx.axes), None, None, None, None


def _split(x: torch.Tensor, dist: DistCtx) -> torch.Tensor:
    """This rank's piece of a block: under a dp cut the block is the data
    row's and the bank ranks split it (the train step's dp mean then sums
    the blocks), else the block is all of it and the world splits it."""
    if _dp_cut(dist):
        return _Split.apply(x, dist, dist.bank_rank, dist.model, "bank")
    return _Split.apply(x, dist, dist.rank, _world(dist), WORLD)


def _block(dist: DistCtx, n: int) -> slice:
    """The rows this rank's piece is cut from: its data row's block under
    a dp cut, else all ``n``."""
    if not _dp_cut(dist):
        return slice(0, n)
    k = n // dist.data
    return slice(dist.dp_rank * k, (dist.dp_rank + 1) * k)


def spread(x: torch.Tensor, dist: DistCtx | None) -> torch.Tensor:
    """This rank's piece (``spread_slice``) of ``x``, which every rank
    holds alike; differentiable (a piece's cotangent reaches every rank
    that holds the block it was cut from)."""
    if not is_spread(dist, x.shape[0]):
        return x
    return _split(x[_block(dist, x.shape[0])], dist)


def spread_gather(t: BankedTable, rows: torch.Tensor,
                  dist: DistCtx | None) -> torch.Tensor:
    """rows (N, ...) union-vocab rows, the same on every rank -> the
    embeddings of this rank's piece, (n, ..., dim) with ``n`` =
    ``spread_slice(dist, N)``'s length. The bank group gathers the block
    the piece is cut from (``banked_gather`` under a context for ids held
    whole: each bank its own rows, summed over the group), and each rank
    keeps its piece. ``dist`` None: ``banked_gather`` of all of them."""
    if dist is None:
        return banked_gather(t, rows)
    n = rows.shape[0]
    if not is_spread(dist, n):
        return banked_gather(t, rows, dist.for_batch(n, whole=True))
    blk = rows[_block(dist, n)]
    emb = banked_gather(t, blk, dist.for_batch(blk.shape[0], whole=True))
    return _split(emb, dist)


def query_ctx(dist: DistCtx | None, n: int) -> DistCtx | None:
    """The context of ``n`` query rows every rank holds alike."""
    return None if dist is None else dist.for_batch(n, whole=True)


def global_top_k(scores: torch.Tensor, k: int, dist: DistCtx | None,
                 n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the ``k`` largest of the whole list of
    ``n`` scores along the last dim, ties lowest index first (the
    single-device ``top_k_lowest_first``), from this rank's piece
    ``scores`` (``spread_slice(dist, n)`` of the last dim). Each rank's own
    top k with global indices, gathered over the grid in rank order, then
    a stable descending sort: equal values keep rank order, which is index
    order."""
    from repro_torch.serve.serve_step import top_k_lowest_first
    if not 0 <= k <= n:
        raise ValueError(f"top_k {k} outside [0, {n}]")
    if not is_spread(dist, n):
        if scores.shape[-1] != n:
            raise ValueError(f"global_top_k: {scores.shape[-1]} scores of a "
                             f"list of {n} held whole")
        return top_k_lowest_first(scores, k)
    sl = spread_slice(dist, n)
    if scores.shape[-1] != sl.stop - sl.start:
        raise ValueError(f"global_top_k: {scores.shape[-1]} scores, this "
                         f"rank's piece of {n} is {sl.stop - sl.start}")
    vals, idx = top_k_lowest_first(scores, min(k, scores.shape[-1]))
    lead = scores.dim() - 1
    vals = dist.gather(vals.contiguous(), WORLD, dim=lead)
    idx = dist.gather((idx.long() + sl.start).contiguous(), WORLD, dim=lead)
    order = torch.sort(vals, dim=-1, descending=True, stable=True).indices
    return (torch.gather(vals, -1, order[..., :k]),
            torch.gather(idx, -1, order[..., :k]).to(torch.int32))


class _CrossRankLSE(torch.autograd.Function):
    """log(sum(exp(x))) over ``dim`` whose pieces sit on the ranks of
    ``axes``: a ``pmax`` of the local max, then a ``psum`` of ``exp(x -
    max)``. Backward: ``ct * exp(x - out)`` on this rank's piece, for a
    cotangent every rank of ``axes`` holds alike."""

    @staticmethod
    def forward(ctx, x, dist, dim, axes):
        m = dist.pmax(torch.amax(x, dim=dim, keepdim=True).detach(), axes)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        s = dist.psum(torch.sum(torch.exp(x - m), dim=dim, keepdim=True),
                      axes)
        out = torch.log(s) + m
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out.squeeze(dim)

    @staticmethod
    def backward(ctx, ct):
        x, out = ctx.saved_tensors
        return ct.unsqueeze(ctx.dim) * torch.exp(x - out), None, None, None


def cross_rank_logsumexp(x: torch.Tensor, dist: DistCtx | None,
                         dim: int = -1, axes=WORLD) -> torch.Tensor:
    """``torch.logsumexp(x, dim)`` of the whole dim, whose pieces the ranks
    of ``axes`` hold (``dist`` None: the local one)."""
    if dist is None:
        return torch.logsumexp(x, dim=dim)
    return _CrossRankLSE.apply(x, dist, dim % x.dim(), axes)


class _PBroadcast(torch.autograd.Function):
    """Forward: ``x`` as it is. Backward: the cotangent summed over
    ``axes``: every rank's piece of the work took ``x`` and adds its
    share of ``x``'s cotangent."""

    @staticmethod
    def forward(ctx, x, dist, axes):
        ctx.dist, ctx.axes = dist, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.dist.psum(ct, ctx.axes), None, None


def pbroadcast(x: torch.Tensor, dist: DistCtx, axes=WORLD) -> torch.Tensor:
    """``x``, which every rank of ``axes`` holds alike, entering this
    rank's piece of a job cut over ``axes``: the same values, and the
    cotangent summed over ``axes`` on the way back (the transpose of
    ``shard_map``'s implicit broadcast of a closed-over value), so every
    rank then holds ``x``'s whole cotangent."""
    return _PBroadcast.apply(x, dist, axes)


def psum_replicated(x: torch.Tensor, dist: DistCtx,
                    axes=WORLD) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``axes``, feeding work that every
    rank repeats alike (the replicated output of a job cut over
    ``axes``): its backward hands each rank's ``x`` the cotangent as it
    is, which every rank holds alike (``core.embedding._Psum``)."""
    return _Psum.apply(x, dist, axes)


class _GatherDp(torch.autograd.Function):
    """Forward: the dp ranks' rows concatenated (every rank then holds the
    global batch; under no dp cut, the rows as they are). Backward: each
    rank's cotangent of the global batch is the part its own piece of a
    spread dim gave, so they are summed over the grid and this rank keeps
    its dp rows."""

    @staticmethod
    def forward(ctx, x, dist, cut):
        ctx.dist, ctx.n, ctx.cut = dist, x.shape[0], cut
        return dist.gather(x, "dp") if cut else x.clone()

    @staticmethod
    def backward(ctx, ct):
        dist, n = ctx.dist, ctx.n
        full = dist.psum(ct.contiguous(), WORLD)
        if ctx.cut:
            full = full[dist.dp_rank * n:(dist.dp_rank + 1) * n]
        return full, None, None


class _DpRows(torch.autograd.Function):
    """Forward: this rank's dp rows of a global batch every rank holds
    alike. Backward: the dp ranks' row cotangents put together (a sum over
    dp of each put in place), so every rank holds the global batch's."""

    @staticmethod
    def forward(ctx, x, dist, n):
        ctx.dist, ctx.n, ctx.b = dist, n, x.shape[0]
        return x[dist.dp_rank * n:(dist.dp_rank + 1) * n].clone()

    @staticmethod
    def backward(ctx, ct):
        dist, n = ctx.dist, ctx.n
        full = ct.new_zeros((ctx.b,) + tuple(ct.shape[1:]))
        full[dist.dp_rank * n:(dist.dp_rank + 1) * n] = ct
        return dist.psum(full, "dp"), None, None


def gather_dp(x: torch.Tensor, dist: DistCtx) -> torch.Tensor:
    """This rank's dp rows of a batch -> the global batch on every rank,
    for a computation each rank then does against its own piece of a
    spread dim (differentiable: ``_GatherDp`` sums the pieces' parts)."""
    return _GatherDp.apply(x.contiguous(), dist, _dp_cut(dist))


def dp_rows(x: torch.Tensor, dist: DistCtx, n: int) -> torch.Tensor:
    """The inverse of ``gather_dp``: this rank's ``n`` dp rows of a global
    batch every rank holds alike (differentiable: ``_DpRows``)."""
    if not _dp_cut(dist):
        return x
    return _DpRows.apply(x, dist, n)


# ---------------------------------------------------------------------------
# decode attention over a sequence-sharded KV cache
# ---------------------------------------------------------------------------

_NEG = -1e30


def _decode_attention_local(q: torch.Tensor, k_new: torch.Tensor,
                            v_new: torch.Tensor, k_cache: torch.Tensor,
                            v_cache: torch.Tensor, pos: int):
    """The reference semantics on one device: q (B, Hq, Dh), k/v_new (B,
    Hkv, Dh), caches (B, S, Hkv, Dh), ``pos`` the new token's slot ->
    (attn (B, Hq, Dh) in q's dtype, k_cache', v_cache')."""
    B, Hq, Dh = q.shape
    Hkv, S = k_new.shape[1], k_cache.shape[1]
    kc, vc = k_cache.clone(), v_cache.clone()
    kc[:, pos] = k_new.to(kc.dtype)
    vc[:, pos] = v_new.to(vc.dtype)
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc.float()) / math.sqrt(Dh)
    mask = torch.arange(S, device=q.device) <= pos
    s = torch.where(mask[None, None, None, :], s, torch.full_like(s, _NEG))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgs,bshd->bhgd", p, vc.float())
    return o.reshape(B, Hq, Dh).to(q.dtype), kc, vc


def seq_shard_index(dist: DistCtx, seq_axes: tuple[str, ...]) -> int:
    """This rank's index along the (possibly two-axis) sequence cut, the
    axes in the order given (the reference's row-major ``axis_index``)."""
    idx = 0
    for a in seq_axes:
        idx = idx * dist.size(a) + (dist.bank_rank if a == "bank"
                                    else dist.dp_rank)
    return idx


def seqsharded_decode_attention(q: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, pos: int, *,
                                dist: DistCtx | None = None,
                                seq_axes: tuple[str, ...] = ("bank",)):
    """One decode step of GQA attention with a sequence-sharded KV cache.

    q (B, Hq, Dh), k/v_new (B, Hkv, Dh), ``pos`` the new token's global
    position. Without ``dist`` (or with empty ``seq_axes``) the caches are
    whole and this is the reference's local path. Under ``dist`` the
    caches are this rank's piece of the sequence over ``seq_axes`` (a
    tuple of ``"dp"`` / ``"bank"``; ``dist.sharding.kv_cache_shardings``
    cuts them and says which axes it cut over), piece ``i`` holding
    positions ``[i * s_loc, (i + 1) * s_loc)``; q and the new K/V are the
    rank's batch rows. Returns (attn, the rank's k piece, its v piece).
    The max and the sums run over the whole sequence group, so the
    result is the same attention as one device's, up to fp32 rounding.
    """
    seq_axes = tuple(seq_axes)
    if dist is None or not seq_axes or dist.size(seq_axes) == 1:
        return _decode_attention_local(q, k_new, v_new, k_cache, v_cache,
                                       pos)
    B, Hq, Dh = q.shape
    Hkv, s_loc = k_new.shape[1], k_cache.shape[1]
    off = seq_shard_index(dist, seq_axes) * s_loc
    kc, vc = k_cache.clone(), v_cache.clone()
    if off <= pos < off + s_loc:           # this rank owns the new row
        kc[:, pos - off] = k_new.to(kc.dtype)
        vc[:, pos - off] = v_new.to(vc.dtype)
    qg = q.reshape(B, Hkv, Hq // Hkv, Dh).float()
    s = torch.einsum("bhgd,bshd->bhgs", qg, kc.float()) / math.sqrt(Dh)
    mask = off + torch.arange(s_loc, device=q.device) <= pos
    s = torch.where(mask[None, None, None, :], s, torch.full_like(s, _NEG))
    m_g = dist.pmax(s.amax(-1), seq_axes)
    p = torch.exp(s - m_g[..., None])            # 0 on a masked piece
    l_g = dist.psum(p.sum(-1), seq_axes)
    o_g = dist.psum(torch.einsum("bhgs,bshd->bhgd", p, vc.float()),
                    seq_axes)
    out = o_g / torch.clamp(l_g, min=1e-30)[..., None]
    return out.reshape(B, Hq, Dh).to(q.dtype), kc, vc
