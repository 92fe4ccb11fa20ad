"""Transformer building blocks (the port of ``repro/models/layers.py``):
norms, RoPE, blockwise (flash-style) attention, decode attention and its
flash-decode partials, the GELU and GLU MLPs, and the sort-based capacity
MoE layer with its expert-parallel form.

Each keeps the reference's semantics rather than PyTorch's defaults:
``layer_norm`` takes fp32 statistics with eps 1e-6 (``nn.LayerNorm``
defaults to 1e-5), ``gelu_mlp`` is ``jax.nn.gelu``'s tanh approximation,
and ``blockwise_attention`` walks the KV chunks with the reference's
online-softmax recurrence in fp32, in the same operation order, so no
(S, S) score matrix is built. ``moe_layer`` ranks each expert's slots by
a stable sort (no (T, E, C) one-hot), keeps ``int(T * k * cf / E)`` of
them and sends the rest to a scratch row; ``moe_layer_sharded`` runs the
same dispatch on a rank's own experts and merges the ranks' outputs with
one sum over the bank group. Both add a token's routed slots from zero in
ascending buffer position, forward and backward (``_TokenRows``,
``_SlotSum``), so their bits do not depend on threads or atomics.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Normalise over the last dim with fp32 mean and (biased) variance,
    then ``y * scale + bias``, cast back to ``x``'s dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """``x / rms(x)`` with the mean square in fp32, cast back to ``x``'s
    dtype, then times ``scale``."""
    var = x.float().square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x (..., S, H, Dh), positions (..., S) int: the two halves of each
    head rotated by ``positions * freqs`` in fp32, cast back."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs              # (..., S, Dh/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_mlp(x: torch.Tensor, w_in: torch.Tensor, b_in: torch.Tensor,
             w_out: torch.Tensor, b_out: torch.Tensor) -> torch.Tensor:
    """``gelu(x @ w_in + b_in) @ w_out + b_out`` with the tanh GELU."""
    return F.gelu(x @ w_in + b_in, approximate="tanh") @ w_out + b_out


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, q_chunk: int = 1024,
                        kv_chunk: int = 1024,
                        q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hq, Dh), k / v (B, Skv, Hkv, Dh) with ``Hq % Hkv == 0``
    (grouped heads) -> (B, Sq, Hq, Dh) in q's dtype.

    Queries go in chunks of ``q_chunk``; each chunk scans the KV chunks of
    ``kv_chunk`` keeping a running max, sum and weighted values in fp32.
    ``causal``: query ``i`` (absolute position ``i + q_offset``) sees keys
    ``<= i + q_offset``; masked scores are ``NEG_INF`` (-1e30), as in the
    reference. Both sequence lengths must divide by their chunks."""
    B, Sq, Hq, Dh = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    groups = Hq // Hkv
    scale = 1.0 / math.sqrt(Dh)
    q_chunk, kv_chunk = min(q_chunk, Sq), min(kv_chunk, Skv)
    if Sq % q_chunk or Skv % kv_chunk:
        raise ValueError(f"blockwise_attention: Sq {Sq} / q_chunk {q_chunk}"
                         f" and Skv {Skv} / kv_chunk {kv_chunk} must divide")
    qg = q.reshape(B, Sq, Hkv, groups, Dh)
    outs = []
    for q0 in range(0, Sq, q_chunk):
        qc = qg[:, q0:q0 + q_chunk]
        Cq = qc.shape[1]
        m = torch.full((B, Cq, Hkv, groups), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, Cq, Hkv, groups), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, Cq, Hkv, groups, Dh), dtype=torch.float32,
                          device=q.device)
        for k0 in range(0, Skv, kv_chunk):
            kc, vc = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qc.float(),
                             kc.float()) * scale
            if causal:
                qpos = q0 + torch.arange(Cq, device=q.device) + q_offset
                kpos = k0 + torch.arange(kc.shape[1], device=q.device)
                mask = qpos[:, None] >= kpos[None, :]
                s = torch.where(mask[None, :, None, None, :], s,
                                torch.full_like(s, NEG_INF))
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vc.dtype).float(), vc.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
    out = torch.cat(outs, dim=1).reshape(B, Sq, Hq, Dh)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# decode attention: one new token against a KV cache
# ---------------------------------------------------------------------------

def _grouped_scores(q: torch.Tensor, k_cache: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, Dh), k (B, S, Hkv, Dh) -> (B, Hkv, G, S) fp32 scores."""
    B, _, Hkv, Dh = k_cache.shape
    qg = q.reshape(B, Hkv, q.shape[1] // Hkv, Dh)
    return torch.einsum("bhgd,bshd->bhgs", qg.float(),
                        k_cache.float()) / math.sqrt(Dh)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: torch.Tensor) -> torch.Tensor:
    """q (B, Hq, Dh); caches (B, S, Hkv, Dh); cache_len (B,) valid length
    -> (B, Hq, Dh) in q's dtype. The probabilities are cast to the cache's
    dtype before the weighted sum, as the reference's."""
    B, S = k_cache.shape[:2]
    s = _grouped_scores(q, k_cache)
    mask = torch.arange(S, device=q.device)[None, :] < cache_len[:, None]
    s = torch.where(mask[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(q.shape).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_shard: torch.Tensor,
                             v_shard: torch.Tensor, valid: torch.Tensor
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The flash-decode partial over one KV sequence shard: (o (B, Hq, Dh)
    fp32, m (B, Hq), l (B, Hq)), combined over shards by
    ``combine_decode_partials``. ``valid`` (B, S_shard) bool."""
    B, Hq = q.shape[:2]
    s = _grouped_scores(q, k_shard)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(-1)
    o = torch.einsum("bhgs,bshd->bhgd", p.to(v_shard.dtype).float(),
                     v_shard.float())
    return o.reshape(B, Hq, -1), m.reshape(B, Hq), l.reshape(B, Hq)


def combine_decode_partials(o: torch.Tensor, m: torch.Tensor,
                            l: torch.Tensor, dist, axes) -> torch.Tensor:
    """The cross-shard softmax combine (log-sum-exp rescaling) over the
    ``axes`` of a ``DistCtx``."""
    m_glob = dist.pmax(m, axes)
    corr = torch.exp(m - m_glob)
    l_glob = dist.psum(l * corr, axes)
    o_glob = dist.psum(o * corr[..., None], axes)
    return o_glob / torch.clamp(l_glob, min=1e-20)[..., None]


# ---------------------------------------------------------------------------
# GLU MLP and the MoE layer
# ---------------------------------------------------------------------------

def glu_mlp(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
            w_down: torch.Tensor) -> torch.Tensor:
    """SwiGLU (the llama family): ``(silu(x @ w_gate) * (x @ w_up)) @
    w_down``."""
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


class MoEStats(NamedTuple):
    load: torch.Tensor       # (E,) routed slot counts (before drops)
    dropped: torch.Tensor    # () share of slots dropped by capacity


def _route(x: torch.Tensor, w_router: torch.Tensor, top_k: int):
    """Softmax over the experts in fp32, the top k, gates renormalised."""
    probs = torch.softmax(x.float() @ w_router.float(), dim=-1)
    gates, eidx = torch.topk(probs, top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return gates, eidx


def _rank_in_expert(key: torch.Tensor, n: int):
    """Stable sort of the slots by ``key`` (expert ids, ``n`` for a foreign
    slot) and each sorted slot's rank within its expert."""
    order = torch.argsort(key, stable=True)
    sorted_e = key[order]
    starts = torch.searchsorted(sorted_e, torch.arange(n, device=key.device))
    starts = torch.cat([starts, starts.new_full((1,), key.numel())])
    rank = torch.arange(key.numel(), device=key.device) - starts[sorted_e]
    return order, sorted_e, rank


def _experts(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, w_gate)) \
        * torch.einsum("ecd,edf->ecf", buf, w_up)
    return torch.einsum("ecf,efd->ecd", h, w_down)


def _with_zero_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros((1, x.shape[1]))])


def _slot_sum(y: torch.Tensor, slots: torch.Tensor) -> torch.Tensor:
    """out[t] = y[slots[t, 0]] + y[slots[t, 1]] + ..., added from zero in
    column order; a slot of ``len(y)`` adds nothing."""
    y = _with_zero_row(y)
    out = y.new_zeros((slots.shape[0], y.shape[1]))
    for j in range(slots.shape[1]):
        out = out + y[slots[:, j]]
    return out


def _token_slots(pos: torch.Tensor, top_k: int) -> torch.Tensor:
    """(T, k): each token's row positions ascending, from ``pos`` (T * k,),
    the position of each flat slot ``t * k + j``."""
    return pos.view(-1, top_k).sort(dim=1).values


class _TokenRows(torch.autograd.Function):
    """rows[p] = x[tok[p]] (``tok[p] == len(x)``: a zero row). Backward:
    ``_slot_sum`` over ``slots`` (T, k), each token's row positions
    ascending (``_token_slots``), so a token's rows add in the order of
    their positions, the reference's scatter order, on every run.
    ``x[tok]``'s own backward adds the repeated rows of a token in an
    order that CPU threads or CUDA atomics pick."""

    @staticmethod
    def forward(ctx, x, tok, slots):
        ctx.save_for_backward(slots)
        return _with_zero_row(x)[tok]

    @staticmethod
    def backward(ctx, g):
        slots, = ctx.saved_tensors
        return _slot_sum(g, slots), None, None


class _SlotSum(torch.autograd.Function):
    """``_slot_sum(y, slots)``, whose backward is ``_TokenRows``' gather of
    the cotangent by ``tok``: the combine that adds a token's rows in a
    fixed order where ``index_add`` would add them in any."""

    @staticmethod
    def forward(ctx, y, slots, tok):
        ctx.save_for_backward(tok)
        return _slot_sum(y, slots)

    @staticmethod
    def backward(ctx, g):
        tok, = ctx.saved_tensors
        return _with_zero_row(g)[tok], None, None


def moe_layer(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25
              ) -> tuple[torch.Tensor, MoEStats]:
    """x (T, d); experts w_gate / w_up (E, d, ff), w_down (E, ff, d).

    Top-k routing, then the sort-based dispatch: the T * k slots sorted by
    expert (stable), each expert keeps its first ``C = max(1, int(T * k *
    cf / E))``, the rest go to a scratch row and add nothing. The (E, C, d)
    buffer is the only expanded tensor. No index repeats outside the
    scratch row, whose cotangent is dropped, so the backward gives the
    same bits on every run."""
    T, d = x.shape
    E = w_gate.shape[0]
    gates, eidx = _route(x, w_router, top_k)
    flat_e = eidx.reshape(-1)
    order, sorted_e, rank = _rank_in_expert(flat_e, E)
    C = max(1, int(T * top_k * capacity_factor / E))
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E * C))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * top_k, device=x.device)
    xs = _TokenRows.apply(x, order // top_k, _token_slots(inv, top_k))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.index_add(0, dest, torch.where(keep[:, None], xs,
                                             torch.zeros_like(xs)))
    y = _experts(buf[:-1].reshape(E, C, d), w_gate, w_up, w_down)
    y_sorted = _with_zero_row(y.reshape(E * C, d))[dest]
    y_flat = torch.zeros((T * top_k, d), dtype=x.dtype, device=x.device)
    y_flat = y_flat.index_copy(0, order, y_sorted)
    out = (y_flat.reshape(T, top_k, d)
           * gates[..., None].to(x.dtype)).sum(dim=1)
    load = torch.bincount(flat_e, minlength=E).float()
    dropped = 1.0 - keep.sum().float() / (T * top_k)
    return out, MoEStats(load=load, dropped=dropped)


class _BankReplicated(torch.autograd.Function):
    """A tensor every rank of the bank group holds alike and uses for its
    own part of a sum over the group: forward unchanged; backward, the sum
    of the ranks' cotangents over the group (the transpose of a
    replicated input of the reference's ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, dist):
        ctx.dist = dist
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return ctx.dist.psum(ct.contiguous(), "bank"), None


def moe_layer_sharded(x: torch.Tensor, w_router: torch.Tensor,
                      w_gate: torch.Tensor, w_up: torch.Tensor,
                      w_down: torch.Tensor, *, top_k: int,
                      capacity_factor: float = 1.25,
                      dist=None) -> torch.Tensor:
    """Expert-parallel MoE over the bank axis of a ``DistCtx``: x (B, S, d)
    is this rank's dp slice, the expert stacks its bank's ``E / n_banks``
    experts (``dist.sharding.lm_param_shardings``' cut), the router whole.

    Every rank routes its tokens over ALL experts (the router is
    replicated, so the decisions agree across the bank group), keeps the
    slots routed to its own experts (foreign slots sort to the tail), with
    the capacity of the whole expert set on its local tokens, ``C =
    max(1, int(T * k * cf / E))``, scatters token ids (not activations)
    into the local buffer, runs its experts, adds each token's
    gate-weighted kept slots in buffer order (``_SlotSum``: the same bits
    on every run, where ``index_add`` adds them in any order on the card),
    and one sum over the bank group merges the partial outputs (the
    paper's stage-3 partial-sum combine). Backward: the tokens' and the
    router's cotangents are summed over the bank group, each rank having
    differentiated only its own experts."""
    from repro_torch.core.embedding import _bank_sum
    B, S, d = x.shape
    E_loc = w_gate.shape[0]
    E = E_loc * dist.n_banks
    T = B * S
    if torch.is_grad_enabled():
        x = _BankReplicated.apply(x, dist)
        w_router = _BankReplicated.apply(w_router, dist)
    xf = x.reshape(T, d)
    my = dist.bank_rank
    gates, eidx = _route(xf, w_router, top_k)
    flat_e = eidx.reshape(-1)
    e_loc = flat_e - my * E_loc
    key = torch.where((e_loc >= 0) & (e_loc < E_loc), e_loc,
                      torch.full_like(e_loc, E_loc))
    order, sorted_e, rank = _rank_in_expert(key, E_loc)
    C = max(1, int(T * top_k * capacity_factor / E))
    keep = (sorted_e < E_loc) & (rank < C)
    dest = torch.where(keep, sorted_e * C + rank,
                       torch.full_like(rank, E_loc * C))
    tok_sorted = order // top_k
    buf_tok = torch.full((E_loc * C + 1,), T, dtype=torch.long,
                         device=x.device)
    buf_tok[dest] = torch.where(keep, tok_sorted,
                                torch.full_like(tok_sorted, T))
    buf_tok = buf_tok[:-1]
    pos = torch.empty_like(dest)
    pos[order] = dest
    slots = _token_slots(pos, top_k)
    gate_sorted = gates.reshape(-1)[order]
    buf_gate = torch.zeros(E_loc * C + 1, dtype=torch.float32,
                           device=x.device)
    buf_gate[dest] = torch.where(keep, gate_sorted,
                                 torch.zeros_like(gate_sorted))
    buf_gate = buf_gate[:-1]
    buf = _TokenRows.apply(xf, buf_tok, slots).reshape(E_loc, C, d)
    y = _experts(buf, w_gate, w_up, w_down).reshape(E_loc * C, d)
    y = y * buf_gate[:, None].to(y.dtype)
    out = _SlotSum.apply(y, slots, buf_tok)
    return _bank_sum(out, dist).reshape(B, S, d)
