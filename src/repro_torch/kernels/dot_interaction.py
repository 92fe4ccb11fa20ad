"""DLRM pairwise-dot interaction: the CUDA kernel's wrapper and its plain
version (the port of ``repro/kernels/dot_interaction.py``'s
``dot_interaction_pallas`` / ``_dot_kernel``).

z (B, F, D) -> (B, F(F-1)/2): the upper triangle of z·zᵀ per row, pairs in
``triu_indices(F, 1)`` order, fp32 dots cast to z's dtype. Unlike the TPU
kernel the output is not padded to 128 columns. The kernel
(``csrc/dot_interaction.cu``) sums each dot in another order than the plain
version, so the two agree to fp32 rounding (atol = rtol = 1e-5), not bit
for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import dot_interaction_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_THREADS = 128                  # kThreads in the kernel
_SMEM = 48 * 1024               # shared memory a block gets without opt-in


def dot_interaction_plain(z: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the einsum Gram matrix and its triangle, as
    the reference model computes it (``repro/models/dlrm.py``)."""
    return dot_interaction_ref(z)


def dot_interaction(z: torch.Tensor) -> torch.Tensor:
    """z (B, F, D) f32/bf16 -> (B, F(F-1)/2).

    CPU tensors take ``dot_interaction_plain``. CUDA tensors launch the
    kernel on the current stream, or raise: there is no fallback.
    """
    if z.device.type == "cpu":
        return dot_interaction_plain(z)
    if z.device.type != "cuda":
        raise ValueError(f"dot_interaction: unsupported device {z.device}")
    if z.dtype not in _DTYPES:
        raise TypeError(f"dot_interaction: dtype {z.dtype} "
                        f"(float32 or bfloat16)")
    if z.dim() != 3:
        raise ValueError(f"dot_interaction: z must be (B, F, D), got "
                         f"{tuple(z.shape)}")
    if not z.is_contiguous():
        raise ValueError("dot_interaction: z is not contiguous")
    B, F, D = z.shape
    row_bytes = F * (D + 1) * 4
    if row_bytes > _SMEM:
        raise ValueError(f"dot_interaction: one row of z needs {row_bytes} B "
                         f"of shared memory, more than {_SMEM}")
    n_pairs = F * (F - 1) // 2
    rows_per_block = max(1, min(_THREADS // max(n_pairs, 1),
                                _SMEM // row_bytes, max(B, 1)))
    out = torch.empty((B, n_pairs), dtype=z.dtype, device=z.device)
    fn = _build.function("dot_interaction", "dot_interaction_forward",
                         [_P, _I, _P, _I, _I, _I, _I, _I, _P])
    err = fn(z.data_ptr(), _DTYPES[z.dtype], out.data_ptr(), B, F, D,
             rows_per_block, z.device.index,
             torch.cuda.current_stream(z.device).cuda_stream)
    _build.check("dot_interaction", err, "dot_interaction")
    dot_interaction.launches += 1
    return out


dot_interaction.launches = 0    # kernel launches (counted only where launched)
