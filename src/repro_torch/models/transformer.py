"""The LM transformer family, llama-style, dense GQA and MoE (the port of
``repro/models/transformer.py``): smollm-135m/360m, granite-20b (MQA,
GELU MLP), qwen3-moe-30b-a3b and granite-moe-1b-a400m.

Params are a dict of tensors with the layer weights stacked on a leading
``n_layers`` dim, as the reference's, so ``convert.lm_params_from_jax``
carries them across leaf for leaf. The forward loops over the layers
(the reference's ``lax.scan``); compute runs in ``cfg.dtype`` (bf16 in
every registry config) over fp32 params, with the reference's casts: the
RMS norm's mean square, RoPE's angles, attention scores and softmax, the
router and the loss in fp32.

GQA: the KV projections have ``n_kv_heads`` heads, repeated to the query
heads at the attention site (prefill, training) or grouped (decode). The
loss runs over sequence chunks of ``loss_chunk`` with the padded vocab
masked to -1e30, so the (B, S, V) logits never exist at once. ``prefill``
returns the last position's logits and, given ``s_max``, the KV cache of
the prompt, so ``decode_step`` continues from it; ``decode_step`` runs
its MoE layers at ``capacity_factor=2.0``, as the reference's.

Under a ``DistCtx`` (``dist``) the params are this rank's pieces as
``dist.sharding.lm_param_shardings`` cuts them and the tokens its dp
slice: a layer gathers a cut weight over the bank group where it uses it
(the reference leaves that to GSPMD), except the MoE expert stacks, which
``layers.moe_layer_sharded`` runs in place (``moe_impl='shardmap'``, the
reference's default); decode keeps the reference's unsharded MoE and
attends over a sequence-sharded cache (``dist.collectives``). The loss is
this rank's mean, so the train step's dp mean is the global loss.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models.common import dense_init, embed_init


@dataclasses.dataclass(frozen=True)
class MoESpec:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int                      # dense ff, or per-expert ff when moe set
    vocab: int
    moe: MoESpec | None = None
    mlp_type: str = "swiglu"       # "swiglu" (llama) | "gelu" (gpt-bigcode)
    tied_embeddings: bool = False  # unembed = embed.T (smollm/granite)
    rope_theta: float = 10000.0
    q_chunk: int = 1024
    kv_chunk: int = 1024
    loss_chunk: int = 512
    dtype: Any = torch.bfloat16    # compute dtype
    param_dtype: Any = torch.float32
    unroll: bool = False           # the reference's dry-run switch (unused)
    moe_impl: str = "shardmap"     # under dist: expert-parallel MoE

    @property
    def qkv_dim(self) -> int:
        return self.n_heads * self.d_head

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.d_head

    @property
    def n_mlp_mats(self) -> int:
        return 3 if self.mlp_type == "swiglu" else 2

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256; pad logits are masked."""
        return -(-self.vocab // 256) * 256

    def param_count(self) -> int:
        d, ff, V = self.d_model, self.d_ff, self.vocab
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        if self.moe:
            mlp = (self.moe.n_experts * self.n_mlp_mats * d * ff
                   + d * self.moe.n_experts)
        else:
            mlp = self.n_mlp_mats * d * ff
        per_layer = attn + mlp + 2 * d
        emb = V * d if self.tied_embeddings else 2 * V * d
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        attn = d * self.qkv_dim + 2 * d * self.kv_dim + self.qkv_dim * d
        mlp = self.moe.top_k * self.n_mlp_mats * d * ff + d * self.moe.n_experts
        emb = self.vocab * d if self.tied_embeddings else 2 * self.vocab * d
        return self.n_layers * (attn + mlp + 2 * d) + emb + d


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_params(cfg: LMConfig, gen: torch.Generator, *,
                device: str | torch.device | None = "cuda") -> dict:
    """Random params of the reference's shapes and scales (truncated-normal
    fan-in dense weights, N(0, 0.02) embeddings, unit norms), drawn from
    ``gen`` on ``device``. The draws are torch's, not ``jax.random``'s:
    parity tests carry the reference's params across instead."""
    from repro_torch import resolve_device
    dev = resolve_device(device)
    d, pd, n = cfg.d_model, cfg.param_dtype, cfg.n_layers

    def stack(*shape, scale=None):
        # each layer's weight has its own fan-in, shape[0], as the
        # reference's vmapped init
        return dense_init(gen, (n,) + shape,
                          scale=1.0 / np.sqrt(shape[0]) if scale is None
                          else scale, dtype=pd, device=dev)

    layer = {
        "ln1": torch.ones((n, d), dtype=pd, device=dev),
        "ln2": torch.ones((n, d), dtype=pd, device=dev),
        "wq": stack(d, cfg.qkv_dim), "wk": stack(d, cfg.kv_dim),
        "wv": stack(d, cfg.kv_dim), "wo": stack(cfg.qkv_dim, d),
    }
    ff = cfg.d_ff
    if cfg.moe:
        E = cfg.moe.n_experts
        layer |= {
            "w_router": stack(d, E),
            "w_gate": stack(E, d, ff, scale=1.0 / np.sqrt(d)),
            "w_up": stack(E, d, ff, scale=1.0 / np.sqrt(d)),
            "w_down": stack(E, ff, d, scale=1.0 / np.sqrt(ff)),
        }
    else:
        layer |= {"w_up": stack(d, ff), "w_down": stack(ff, d)}
        if cfg.mlp_type == "swiglu":
            layer["w_gate"] = stack(d, ff)
    params = {
        "embed": embed_init(gen, (cfg.padded_vocab, d), dtype=pd, device=dev),
        "layers": layer,
        "final_norm": torch.ones((d,), dtype=pd, device=dev),
    }
    if not cfg.tied_embeddings:
        params["unembed"] = dense_init(gen, (d, cfg.padded_vocab), dtype=pd,
                                       device=dev)
    return params


def unembed_matrix(cfg: LMConfig, params: dict) -> torch.Tensor:
    """(d, V) output projection — embed.T when tied."""
    if cfg.tied_embeddings:
        return params["embed"].T
    return params["unembed"]


# ---------------------------------------------------------------------------
# weights under dist: a cut leaf gathered over the bank group where used
# ---------------------------------------------------------------------------

class _GatherBank(torch.autograd.Function):
    """A weight cut over the bank group, whole again. Backward: this rank's
    piece of the cotangent (every rank of the bank group computes the same
    cotangent: it holds the same dp slice and the same whole weights)."""

    @staticmethod
    def forward(ctx, x, dist, dim):
        ctx.dist, ctx.dim, ctx.n = dist, dim, x.shape[dim]
        return dist.gather(x, "bank", dim)

    @staticmethod
    def backward(ctx, ct):
        m = ctx.dist.bank_rank
        return ct.narrow(ctx.dim, m * ctx.n, ctx.n), None, None


def _whole(x: torch.Tensor, shape: tuple, dist) -> torch.Tensor:
    """``x`` at its whole ``shape``: as it is, or gathered over the bank
    group along the one dim ``lm_param_shardings`` cut."""
    if tuple(x.shape) == tuple(shape):
        return x
    dims = [i for i, (a, b) in enumerate(zip(x.shape, shape)) if a != b]
    if dist is None or len(dims) != 1 \
            or x.shape[dims[0]] * dist.n_banks != shape[dims[0]]:
        raise ValueError(f"a param piece {tuple(x.shape)} of a whole "
                         f"{tuple(shape)}: cut it with lm_param_shardings")
    return _GatherBank.apply(x, dist, dims[0])


def _layer_shapes(cfg: LMConfig) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    out = {"ln1": (d,), "ln2": (d,), "wq": (d, cfg.qkv_dim),
           "wk": (d, cfg.kv_dim), "wv": (d, cfg.kv_dim),
           "wo": (cfg.qkv_dim, d)}
    if cfg.moe:
        E = cfg.moe.n_experts
        out |= {"w_router": (d, E), "w_gate": (E, d, ff),
                "w_up": (E, d, ff), "w_down": (E, ff, d)}
    else:
        out |= {"w_up": (d, ff), "w_down": (ff, d)}
        if cfg.mlp_type == "swiglu":
            out["w_gate"] = (d, ff)
    return out


def _sharded_moe(cfg: LMConfig, dist) -> bool:
    """Whether the forward runs the expert-parallel MoE (on the rank's
    expert pieces) rather than ``moe_layer`` on whole experts."""
    return dist is not None and cfg.moe is not None \
        and cfg.moe_impl == "shardmap"


def _layer(cfg: LMConfig, params: dict, i: int, dist, *,
           keep_experts: bool = False) -> dict:
    """Layer ``i``'s weights cast to the compute dtype, whole (the expert
    stacks left as this rank's pieces with ``keep_experts``)."""
    out = {}
    for k, shape in _layer_shapes(cfg).items():
        w = params["layers"][k][i]
        if not (keep_experts and cfg.moe and k in ("w_gate", "w_up",
                                                   "w_down")):
            w = _whole(w, shape, dist)
        out[k] = w.to(cfg.dtype)
    return out


def _embed(cfg: LMConfig, params: dict, dist) -> torch.Tensor:
    """The token table. Rows are read with ``F.embedding``, whose backward
    adds a token's repeated rows in token order on every run (the CPU's
    ``x[idx]`` backward adds them with parallel atomics above 32 k
    elements)."""
    return _whole(params["embed"], (cfg.padded_vocab, cfg.d_model), dist)


def _unembed(cfg: LMConfig, params: dict, dist) -> torch.Tensor:
    if cfg.tied_embeddings:
        return _embed(cfg, params, dist).T
    return _whole(params["unembed"], (cfg.d_model, cfg.padded_vocab), dist)


def _final_norm(cfg: LMConfig, params: dict) -> torch.Tensor:
    return params["final_norm"].to(cfg.dtype)


def _mlp(cfg: LMConfig, x: torch.Tensor, lw: dict, *, moe_dist=None,
         capacity_factor: float | None = None) -> torch.Tensor:
    """The block's feed-forward on x (B, S, d) or (B, d); ``moe_dist``: the
    expert-parallel MoE over its bank group (``lw``'s experts are the
    rank's pieces)."""
    if cfg.moe:
        cf = cfg.moe.capacity_factor if capacity_factor is None \
            else capacity_factor
        if moe_dist is not None:
            if cfg.moe.n_experts % moe_dist.n_banks:
                raise ValueError(f"moe_layer_sharded: {cfg.moe.n_experts} "
                                 f"experts over {moe_dist.n_banks} banks")
            return L.moe_layer_sharded(
                x, lw["w_router"], lw["w_gate"], lw["w_up"], lw["w_down"],
                top_k=cfg.moe.top_k, capacity_factor=cf, dist=moe_dist)
        y, _ = L.moe_layer(x.reshape(-1, x.shape[-1]), lw["w_router"],
                           lw["w_gate"], lw["w_up"], lw["w_down"],
                           top_k=cfg.moe.top_k, capacity_factor=cf)
        return y.reshape(x.shape)
    if cfg.mlp_type == "swiglu":
        return L.glu_mlp(x, lw["w_gate"], lw["w_up"], lw["w_down"])
    return F.gelu(x @ lw["w_up"], approximate="tanh") @ lw["w_down"]


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _qkv(cfg: LMConfig, x: torch.Tensor, lw: dict, positions: torch.Tensor):
    """Projections of x (B, S, d) with RoPE on q and k: (B, S, H, Dh)."""
    B, S, _ = x.shape
    q = (x @ lw["wq"]).reshape(B, S, cfg.n_heads, cfg.d_head)
    k = (x @ lw["wk"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    v = (x @ lw["wv"]).reshape(B, S, cfg.n_kv_heads, cfg.d_head)
    return (L.apply_rope(q, positions, cfg.rope_theta),
            L.apply_rope(k, positions, cfg.rope_theta), v)


def _layer_fwd(cfg: LMConfig, dist, h: torch.Tensor, lw: dict,
               positions: torch.Tensor, causal: bool = True,
               kv_out: list | None = None) -> torch.Tensor:
    """One block. h (B, S, d). ``kv_out``: the block's (k, v) after RoPE,
    before the GQA repeat, are appended (the prefill's KV cache)."""
    B, S, _ = h.shape
    G = cfg.n_heads // cfg.n_kv_heads
    x = L.rms_norm(h, lw["ln1"])
    q, k, v = _qkv(cfg, x, lw, positions)
    if kv_out is not None:
        kv_out.append((k, v))
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    attn = L.blockwise_attention(q, k, v, causal=causal,
                                 q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk)
    h = h + attn.reshape(B, S, cfg.qkv_dim) @ lw["wo"]
    x = L.rms_norm(h, lw["ln2"])
    return h + _mlp(cfg, x, lw,
                    moe_dist=dist if _sharded_moe(cfg, dist) else None)


def forward_hidden(cfg: LMConfig, params: dict, tokens: torch.Tensor,
                   dist=None, causal: bool = True,
                   kv_out: list | None = None) -> torch.Tensor:
    """tokens (B, S) -> the final hidden states (B, S, d)."""
    B, S = tokens.shape
    h = F.embedding(tokens.long(), _embed(cfg, params, dist)).to(cfg.dtype)
    positions = torch.arange(S, device=tokens.device)[None, :].expand(B, S)
    for i in range(cfg.n_layers):
        lw = _layer(cfg, params, i, dist,
                    keep_experts=_sharded_moe(cfg, dist))
        h = _layer_fwd(cfg, dist, h, lw, positions, causal, kv_out)
    return L.rms_norm(h, _final_norm(cfg, params))


def _mask_pad(cfg: LMConfig, logits: torch.Tensor) -> torch.Tensor:
    keep = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return torch.where(keep, logits, torch.full_like(logits, -1e30))


def chunked_ce_loss(cfg: LMConfig, h: torch.Tensor, unembed: torch.Tensor,
                    labels: torch.Tensor, dist=None) -> torch.Tensor:
    """The mean cross-entropy over (B, S) from the hidden states, one
    ``loss_chunk`` of positions at a time: fp32 logits of bf16 products,
    the padded vocab masked, ``logsumexp`` minus the label's logit."""
    B, S, _ = h.shape
    c = min(cfg.loss_chunk, S)
    if S % c:
        raise ValueError(f"chunked_ce_loss: S {S} % loss_chunk {c} != 0")
    # products of compute-dtype values accumulated in fp32, as the
    # reference's preferred_element_type=float32
    w = unembed.to(cfg.dtype).float()
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, S, c):
        logits = _mask_pad(cfg, torch.einsum(
            "bsd,dv->bsv", h[:, i:i + c].float(), w))
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[:, i:i + c, None].long())[..., 0]
        tot = tot + (lse - ll).sum()
    return tot / (B * S)


def lm_loss(cfg: LMConfig, params: dict, tokens: torch.Tensor,
            labels: torch.Tensor, dist=None) -> torch.Tensor:
    h = forward_hidden(cfg, params, tokens, dist)
    return chunked_ce_loss(cfg, h, _unembed(cfg, params, dist), labels, dist)


def loss_fn(cfg: LMConfig, params: dict, statics, batch: dict,
            dist=None) -> torch.Tensor:
    """The train step's loss over a ``{"tokens", "labels"}`` batch (the
    recsys families' signature; ``statics`` is unused)."""
    return lm_loss(cfg, params, batch["tokens"], batch["labels"], dist)


# ---------------------------------------------------------------------------
# serving: prefill + decode with a KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    k: torch.Tensor        # (L, B, S_max, Hkv, Dh)
    v: torch.Tensor
    length: int            # tokens already in the cache

    @classmethod
    def empty(cls, cfg: LMConfig, batch: int, s_max: int, *,
              device: str | torch.device | None = "cuda") -> "KVCache":
        from repro_torch import resolve_device
        shp = (cfg.n_layers, batch, s_max, cfg.n_kv_heads, cfg.d_head)
        dev = resolve_device(device)
        return cls(k=torch.zeros(shp, dtype=cfg.dtype, device=dev),
                   v=torch.zeros(shp, dtype=cfg.dtype, device=dev),
                   length=0)


def _logits(cfg: LMConfig, params: dict, h: torch.Tensor,
            dist) -> torch.Tensor:
    w = _unembed(cfg, params, dist).to(cfg.dtype).float()
    return _mask_pad(cfg, torch.einsum("bd,dv->bv", h.float(), w))


def decode_step(cfg: LMConfig, params: dict, cache: KVCache,
                token: torch.Tensor, dist=None,
                seq_axes: tuple[str, ...] = ("bank",)
                ) -> tuple[torch.Tensor, KVCache]:
    """One decode step: token (B,) -> logits (B, padded_vocab) fp32 (pad
    masked) and the cache with the token's K/V at position
    ``cache.length``. Under ``dist`` the cache's k / v are this rank's
    sequence pieces over ``seq_axes`` (``dist.sharding.kv_cache_shardings``
    returns them with the axes to pass); the new row lands on the rank
    that owns its position."""
    from repro_torch.dist.collectives import seqsharded_decode_attention
    B = token.shape[0]
    h = F.embedding(token.long(), _embed(cfg, params, dist)).to(cfg.dtype)
    pos = int(cache.length)
    posb = torch.full((B, 1), pos, device=token.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lw = _layer(cfg, params, i, dist)
        x = L.rms_norm(h, lw["ln1"])
        q, k, v = _qkv(cfg, x[:, None], lw, posb)
        attn, kc, vc = seqsharded_decode_attention(
            q[:, 0], k[:, 0], v[:, 0], cache.k[i], cache.v[i], pos,
            dist=dist, seq_axes=seq_axes)
        ks.append(kc)
        vs.append(vc)
        h = h + attn.reshape(B, cfg.qkv_dim) @ lw["wo"]
        x = L.rms_norm(h, lw["ln2"])
        h = h + _mlp(cfg, x, lw, capacity_factor=2.0)
    h = L.rms_norm(h, _final_norm(cfg, params))
    return _logits(cfg, params, h, dist), KVCache(
        k=torch.stack(ks), v=torch.stack(vs), length=pos + 1)


def prefill(cfg: LMConfig, params: dict, tokens: torch.Tensor, dist=None,
            s_max: int | None = None):
    """Prefill: tokens (B, S) -> the last position's logits (B,
    padded_vocab) fp32, pad masked. With ``s_max``: ``(logits, cache)``,
    the prompt's K/V (after RoPE) in a ``KVCache`` of ``s_max`` positions
    and length S, from which ``decode_step`` continues."""
    kv = [] if s_max is not None else None
    h = forward_hidden(cfg, params, tokens, dist, kv_out=kv)
    logits = _logits(cfg, params, h[:, -1], dist)
    if s_max is None:
        return logits
    B, S = tokens.shape
    if s_max < S:
        raise ValueError(f"prefill: s_max {s_max} < prompt length {S}")
    cache = KVCache.empty(cfg, B, s_max, device=tokens.device)
    for i, (k, v) in enumerate(kv):
        cache.k[i, :, :S] = k
        cache.v[i, :, :S] = v
    cache.length = S
    return logits, cache
