"""DLRM pairwise-dot interaction: the CUDA kernel's wrappers and their
plain versions (the port of ``repro/kernels/dot_interaction.py``'s
``dot_interaction_pallas`` / ``_dot_kernel``, and of the two
concatenations around ``dot_interaction`` in ``repro/models/dlrm.py``).

``dot_interaction``: z (B, F, D) -> (B, F(F-1)/2), the upper triangle of
z·zᵀ per row, pairs in ``triu_indices(F, 1)`` order, fp32 dots cast to z's
dtype. ``dot_features``: x (B, D) and emb (B, F-1, D) -> the top MLP's input
``[dot_interaction([x | emb]) | x]`` (B, P + D) in one launch of the same
kernel. Unlike the TPU kernel the output is not padded to 128 columns.
The kernel (``csrc/dot_interaction.cu``) sums each dot in another order
than the plain version, so the two agree to fp32 rounding (atol = rtol =
1e-5), not bit for bit; the x columns of ``dot_features`` are copied bit
for bit. On ``meta`` tensors both wrappers return the output's shape and
report the kernel's cost (``kernels/cost.py``), as the bag wrappers do.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.embedding_bag import _on_meta, copy_width
from repro_torch.kernels.ref import dot_interaction_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_THREADS = 128                  # kThreads in the kernel
_SMEM = 48 * 1024               # shared memory a block gets without opt-in


def dot_interaction_plain(z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the einsum Gram matrix and its triangle, as
    the reference model computes it (``repro/models/dlrm.py``)."""
    return dot_interaction_ref(z)


def dot_features_plain(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused entry, as the reference model
    computes it: ``z = cat([x[:, None], emb])``, the interaction, then
    ``cat([inter, x])``."""
    z = torch.cat([x[:, None], emb], dim=1)
    return torch.cat([dot_interaction_ref(z), x], dim=-1)


def rows_per_block(batch: int, n_fields: int, dim: int,
                   itemsize: int) -> int:
    """Batch rows a block of the kernel takes: about one pair a thread,
    within the 48 KB of shared memory (each row's F x D values rounded up to
    16 bytes). Raises when one row does not fit."""
    row_bytes = -(-n_fields * dim * itemsize // 16) * 16
    if row_bytes > _SMEM:
        raise ValueError(f"dot_interaction: one row of z needs {row_bytes} B "
                         f"of shared memory, more than {_SMEM}")
    n_pairs = n_fields * (n_fields - 1) // 2
    return max(1, min(_THREADS // max(n_pairs, 1),
                      _SMEM // max(row_bytes, 1), max(batch, 1)))


def _check(what: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{what}: unsupported device {t.device}")
        if t.dtype not in _DTYPES or t.dtype != ts[0].dtype:
            raise TypeError(f"{what}: dtype {t.dtype} (float32 or bfloat16, "
                            f"one for all inputs)")
        if t.device != ts[0].device or not t.is_contiguous():
            raise ValueError(f"{what}: every input must be contiguous on "
                             f"{ts[0].device}")


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z (B, F, D) f32/bf16 -> (B, F(F-1)/2).

    CPU tensors take ``dot_interaction_plain``. CUDA tensors launch the
    kernel on the current stream, or raise: there is no fallback. Meta
    tensors: the output's shape and the kernel's cost.
    """
    if z.device.type == "cpu":
        return dot_interaction_plain(z)
    _check("dot_interaction", z)
    if z.dim() != 3:
        raise ValueError(f"dot_interaction: z must be (B, F, D), got "
                         f"{tuple(z.shape)}")
    B, F, D = z.shape
    isz = z.element_size()
    if z.device.type == "meta":
        return _on_meta("dot_interaction", (B, F * (F - 1) // 2), z.dtype,
                        z.device, _cost.dot_cost(B, F, D, isz))
    rpb = rows_per_block(B, F, D, isz)
    out = torch.empty((B, F * (F - 1) // 2), dtype=z.dtype, device=z.device)
    fn = _build.function("dot_interaction", "dot_interaction_forward",
                         [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I])
    err = fn(z.data_ptr(), _DTYPES[z.dtype], out.data_ptr(), B, F, D, rpb,
             z.device.index, torch.cuda.current_stream(z.device).cuda_stream,
             copy_width(D * isz, z.data_ptr()))
    _build.check("dot_interaction", err, "dot_interaction")
    dot_interaction.launches += 1
    return out


dot_interaction.launches = 0    # kernel launches (counted only where launched)


def dot_features(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """x (B, D) and emb (B, F-1, D) f32/bf16 -> (B, P + D) =
    ``[dot_interaction([x | emb]) | x]``, P = F(F-1)/2.

    CPU tensors take ``dot_features_plain``. CUDA tensors launch the
    kernel's fused entry on the current stream, or raise: there is no
    fallback. A launch counts on ``dot_features.launches``. Meta tensors:
    the output's shape and the kernel's cost.
    """
    if x.device.type == "cpu" and emb.device.type == "cpu":
        return dot_features_plain(x, emb)
    _check("dot_features", x, emb)
    if x.dim() != 2 or emb.dim() != 3 or emb.shape[0] != x.shape[0] \
            or emb.shape[2] != x.shape[1]:
        raise ValueError(f"dot_features: x {tuple(x.shape)} must be (B, D) "
                         f"and emb {tuple(emb.shape)} (B, F-1, D)")
    B, D = x.shape
    F = emb.shape[1] + 1
    isz = x.element_size()
    P = F * (F - 1) // 2
    if x.device.type == "meta":
        return _on_meta("dot_features", (B, P + D), x.dtype, x.device,
                        _cost.dot_features_cost(B, F, D, isz))
    rpb = rows_per_block(B, F, D, isz)
    out = torch.empty((B, P + D), dtype=x.dtype, device=x.device)
    fn = _build.function("dot_interaction", "dot_features_forward",
                         [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _I])
    err = fn(x.data_ptr(), emb.data_ptr(), _DTYPES[x.dtype], out.data_ptr(),
             B, F, D, rpb, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream,
             copy_width(D * isz, x.data_ptr(), emb.data_ptr()))
    _build.check("dot_interaction", err, "dot_features")
    dot_features.launches += 1
    return out


dot_features.launches = 0       # kernel launches (counted only where launched)
