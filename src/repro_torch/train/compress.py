"""Int8 gradient compression with error feedback (the port of
``repro/train/compress.py``).

``compress_roundtrip`` quantizes and dequantizes every gradient leaf with a
persistent error-feedback buffer kept in the train state: the numerics the
wire-level compression produces, on one device. Every operation is an
exactly rounded IEEE one (an add, an abs, a max, a multiply, a division,
a round-half-to-even, a clip, a multiply-subtract), so the result is the
reference's jitted step's bit for bit (the error is its fused
multiply-subtract, rounded once). The divisor of ``x / scale`` is a
tensor on ``x``'s device: CUDA turns a division by a host scalar into a
multiplication by its reciprocal, which is not the same rounding.

``psum_int8`` is the wire-level compressed all-reduce over a
``DistCtx``'s axes (train/dp_step.py): int8 values at one shared scale,
summed as int32, with the same error feedback.
"""
from __future__ import annotations

import torch

from repro_torch.train import optim as O


def quantize_int8(x: torch.Tensor, dist=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8. Returns (q, scale): ``scale = max(amax,
    1e-12) / 127`` in fp32, ``q = clip(round(x / scale), -127, 127)``.

    The division by 127 is a multiplication by fp32(1/127), as the
    reference's compiled step has it: XLA folds a division by a constant
    into a multiplication by its reciprocal, and the reference always runs
    the compression inside its jitted train step. ``dist``: ``x`` is one
    bank's shard of the tensor, and ``amax`` is the MAX of the shards'
    over the bank group, the whole tensor's exactly."""
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    if dist is not None:
        amax = dist.pmax(amax, "bank")
    scale = torch.clamp(amax, min=1e-12) * torch.full(
        (), 1 / 127, dtype=torch.float32, device=xf.device)
    q = torch.clamp(torch.round(torch.div(xf, scale)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _one(g: torch.Tensor, e: torch.Tensor, dist=None
         ) -> tuple[torch.Tensor, torch.Tensor]:
    x = g.float() + e
    q, scale = quantize_int8(x, dist)
    deq = dequantize_int8(q, scale)
    # e' = x - q * scale rounded once, as the fused multiply-subtract of the
    # reference's compiled step: in fp64 the product (8 x 24 bits) and the
    # difference (|x| within 2^8 of q * scale when q != 0) are exact
    err = (x.double() - q.double() * scale.double()).float()
    return deq.to(g.dtype), err


def is_bank_shard(path: str, leaf, dist) -> bool:
    """Whether a gradient (or param) leaf is a bank shard under ``dist``: a
    2-D leaf whose path names ``packed`` or ``embed`` (the tables that
    ``dist.sharding.recsys_param_shardings`` cuts by rows, and that every
    lookup under ``dist`` takes cut) on a grid of more than one bank."""
    return (dist is not None and dist.n_banks > 1 and leaf.dim() == 2
            and ("packed" in path or "embed" in path))


def compress_roundtrip(grads, err_state, dist=None):
    """Error-feedback quantization, leaf for leaf: ``g' = Q(g + e)``, ``e' =
    (g + e) - g'``. Returns (new grads in their own dtypes, new fp32 error
    state), both of ``grads``' structure.

    ``dist`` (a ``DistCtx``): ``grads`` and ``err_state`` are this rank's
    pieces. A bank-shard leaf (``is_bank_shard``) is quantized at the MAX
    of its shards' scales over the bank group, which is the whole table's
    scale exactly (a max is exact), so the shards' results put together
    equal the whole tree's bit for bit; every other leaf is replicated
    and keeps its own."""
    out = [_one(g, e, dist if is_bank_shard(p, g, dist) else None)
           for (p, g), e in zip(O.tree_flatten_with_path(grads),
                                O.tree_leaves(err_state))]
    return (O.tree_unflatten(grads, [g for g, _ in out]),
            O.tree_unflatten(grads, [e for _, e in out]))


def init_error_state(params):
    """fp32 zeros shaped like every param leaf."""
    return O.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params)


def psum_int8(x: torch.Tensor, dist, err: torch.Tensor | None = None,
              axes=("dp",)) -> tuple[torch.Tensor, torch.Tensor]:
    """The compressed SUM of ``x`` over ``dist``'s ``axes`` (a
    ``DistCtx``): each rank quantizes ``x + err`` at the MAX of the ranks'
    scales (so all dequantize alike), the int8 values are summed as int32
    (exact; no overflow below 2^24 ranks), and the sum is scaled back.
    Returns (the fp32 sum, this rank's new error ``x + err - q * scale``),
    the reference's formula as its compiled step rounds it."""
    from repro_torch.core.embedding import DistCtx
    if not isinstance(dist, DistCtx):
        raise TypeError(f"psum_int8 sums over a DistCtx's axes, got "
                        f"{type(dist).__name__}")
    xf = x.float() + (err if err is not None else 0.0)
    _, scale = quantize_int8(xf)
    scale = dist.pmax(scale, axes)                  # shared scale
    q = torch.clamp(torch.round(torch.div(xf, scale)), -127, 127)
    new_err = (xf.double() - q.double() * scale.double()).float()
    total = dist.psum(q.to(torch.int32), axes)
    return total.float() * scale, new_err
