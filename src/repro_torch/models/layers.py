"""Transformer building blocks the BERT4Rec family needs (the port of part
of ``repro/models/layers.py``): layer norm, the GELU MLP and blockwise
(flash-style) attention.

Each keeps the reference's semantics rather than PyTorch's defaults:
``layer_norm`` takes fp32 statistics with eps 1e-6 (``nn.LayerNorm``
defaults to 1e-5), ``gelu_mlp`` is ``jax.nn.gelu``'s tanh approximation,
and ``blockwise_attention`` walks the KV chunks with the reference's
online-softmax recurrence in fp32, in the same operation order, so no
(S, S) score matrix is built. RMS norm, RoPE, decode attention, the GLU
MLP and the MoE layer come with the LM families (ROADMAP queue 1 #18,
part 3).
"""
from __future__ import annotations

import math

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
