"""DLRM pairwise-dot interaction: the CUDA kernel's wrappers and their
plain versions (the port of ``repro/kernels/dot_interaction.py``'s
``dot_interaction_pallas`` / ``_dot_kernel``, of the two concatenations
around ``dot_interaction`` in ``repro/models/dlrm.py``, and of the query
side's broadcast in its ``retrieval_scores``).

``dot_interaction``: z (B, F, D) -> (B, F(F-1)/2), the upper triangle of
z·zᵀ per row, pairs in ``triu_indices(F, 1)`` order, fp32 dots cast to z's
dtype. ``dot_features``: x (B, D) and emb (B, F-1, D) -> the top MLP's input
``[dot_interaction([x | emb]) | x]`` (B, P + D) in one launch of the same
kernel. ``dot_features_query``: one query, x (D,) and user (U, D), against
cand (N, D) -> ``dot_features`` of x and ``[user | cand[n]]`` broadcast to
N, without the broadcast: the (U+1)U/2 dots among x and the user rows are
taken once and every row holds the same bits of them; only the U + 1 dots
against a candidate are taken a row. Unlike the TPU kernel the output is
not padded to 128 columns.

``dot_geometry`` picks the batch entries' launch: for P <= 128 (the serve
and train paths' F = 9) ``rows_per_block`` rows a block, as before; above,
tiles of rows in a double-buffered shared ring with a 4 x 4 register
block of the triangle a thread (``csrc/dot_interaction.cu`` says why).
``query_geometry`` picks the query entry's tile of candidate rows.

The kernel sums each dot in another order than the plain versions, so the
two agree to fp32 rounding (atol = rtol = 1e-5), not bit for bit; the x
columns are copied bit for bit. On ``meta`` tensors the wrappers return
the output's shape and report the kernel's cost (``kernels/cost.py``), as
the bag wrappers do.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.kernels.embedding_bag import _on_meta, copy_width
from repro_torch.kernels.ref import dot_interaction_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int
_THREADS = 128                  # kThreads in the kernel
_SMEM = 48 * 1024               # shared memory a block gets without opt-in
_TILE_THREADS = 256             # kTileThreads: the tiled and query blocks
_TILE_ROWS = 8                  # rows of a batch tile, at most
_QUERY_ROWS = 32                # candidate rows of a query tile, at most
# the dynamic shared memory an H100 block may opt in to (227 KB); the
# launch checks the card's own figure
SMEM_OPTIN = 232_448


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


def dot_features_query_plain(x: torch.Tensor, user: torch.Tensor,
                             cand: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the query entry, as the model computed it
    before: x and the user rows broadcast to N, concatenated with the
    candidate rows, then ``dot_features_plain``."""
    N = cand.shape[0]
    emb = torch.cat([user.expand(N, -1, -1), cand[:, None]], dim=1)
    return dot_features_plain(x.expand(N, -1), emb)


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


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _staged_row_bytes(nbytes: int) -> int:
    """A staged row's stride in the tiled and query geometries: its bytes
    rounded up to an odd number of 16-byte units, so that 8 lanes loading
    16 bytes each from 8 rows hit 8 different bank groups."""
    b = _round16(nbytes)
    return b if (b // 16) % 2 else b + 16


class DotGeometry(NamedTuple):
    """A launch of the interaction kernel: ``tiled`` (tiles of rows in a
    double-buffered ring, or the one-row geometry), the rows a block
    stages at once, its threads and its dynamic shared memory in bytes."""
    tiled: bool
    rows: int
    threads: int
    smem: int


def dot_geometry(batch: int, n_fields: int, dim: int,
                 itemsize: int) -> DotGeometry:
    """The batch entries' geometry. P <= 128: ``rows_per_block`` rows a
    block of 128 threads, as before. P > 128, where D's bytes are a
    multiple of 16 and the 4 x 4 field blocks of the triangle number at
    most 256: tiles of up to 8 rows, a thread per row and field block, two
    buffers each holding a tile's staged rows or its output rows, within
    the shared memory a block may opt in to. Otherwise the one-row
    geometry. Raises when one row cannot fit."""
    n_pairs = n_fields * (n_fields - 1) // 2
    nb = -(-n_fields // 4)
    n_tiles = nb * (nb + 1) // 2
    if n_pairs > _THREADS and dim * itemsize % 16 == 0 \
            and n_tiles <= _TILE_THREADS:
        rs = _staged_row_bytes(n_fields * dim * itemsize)
        for rows in range(min(_TILE_ROWS, _TILE_THREADS // n_tiles), 0, -1):
            buf = max(rows * rs, _round16(rows * (n_pairs + dim) * itemsize))
            if 2 * buf <= SMEM_OPTIN:
                return DotGeometry(True, rows, rows * n_tiles, 2 * buf)
        raise ValueError(f"dot_interaction: one row of z needs {2 * rs} B "
                         f"of shared memory in two buffers, more than "
                         f"{SMEM_OPTIN}")
    rpb = rows_per_block(batch, n_fields, dim, itemsize)
    return DotGeometry(False, rpb, _THREADS,
                       rpb * _round16(n_fields * dim * itemsize))


def query_geometry(n_user: int, dim: int, itemsize: int) -> DotGeometry:
    """The query entry's geometry: tiles of up to 32 candidate rows, a
    thread per row and group of 4 query rows (x and the U user rows), the
    query rows, two candidate buffers and a tile's output rows in shared
    memory. Raises where that cannot fit."""
    n_q = n_user + 1
    groups = -(-n_q // 4)
    n_pairs = (n_user + 2) * (n_user + 1) // 2
    rs = _staged_row_bytes(dim * itemsize)
    q = _round16(n_q * dim * itemsize)
    for rows in range(min(_QUERY_ROWS, _TILE_THREADS // groups), 0, -1):
        smem = q + 2 * rows * rs + _round16(rows * (n_pairs + dim) * itemsize)
        if smem <= SMEM_OPTIN:
            return DotGeometry(True, rows, rows * groups, smem)
    raise ValueError(f"dot_features_query: {n_user} user rows of {dim} "
                     f"columns do not fit a block's {SMEM_OPTIN} B of shared "
                     f"memory and {_TILE_THREADS} threads")


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
    geo = dot_geometry(B, F, D, isz)
    out = torch.empty((B, F * (F - 1) // 2), dtype=z.dtype, device=z.device)
    fn = _build.function("dot_interaction", "dot_interaction_forward",
                         [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I])
    err = fn(z.data_ptr(), _DTYPES[z.dtype], out.data_ptr(), B, F, D, geo.rows,
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
    geo = dot_geometry(B, F, D, isz)
    out = torch.empty((B, P + D), dtype=x.dtype, device=x.device)
    fn = _build.function("dot_interaction", "dot_features_forward",
                         [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _I])
    err = fn(x.data_ptr(), emb.data_ptr(), _DTYPES[x.dtype], out.data_ptr(),
             B, F, D, geo.rows, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream,
             copy_width(D * isz, x.data_ptr(), emb.data_ptr()))
    _build.check("dot_interaction", err, "dot_features")
    dot_features.launches += 1
    return out


dot_features.launches = 0       # kernel launches (counted only where launched)


def dot_features_query(x: torch.Tensor, user: torch.Tensor,
                       cand: torch.Tensor) -> torch.Tensor:
    """x (D,), user (U, D) and cand (N, D), f32/bf16, contiguous -> (N, P +
    D), P = F(F-1)/2 with F = U + 2: row n is ``dot_features``' row for x
    and emb = [user | cand[n]], without x and the user rows broadcast.

    CPU tensors take ``dot_features_query_plain``. CUDA tensors launch the
    kernel's query entry on the current stream, or raise: there is no
    fallback. A launch counts on ``dot_features_query.launches``. Meta
    tensors: the output's shape and the kernel's cost.
    """
    if x.dim() != 1 or user.dim() != 2 or cand.dim() != 2 \
            or user.shape[1] != x.shape[0] or cand.shape[1] != x.shape[0]:
        raise ValueError(f"dot_features_query: x {tuple(x.shape)} must be "
                         f"(D,), user {tuple(user.shape)} (U, D) and cand "
                         f"{tuple(cand.shape)} (N, D)")
    if all(t.device.type == "cpu" for t in (x, user, cand)):
        return dot_features_query_plain(x, user, cand)
    _check("dot_features_query", x, user, cand)
    (N, D), U = cand.shape, user.shape[0]
    isz = x.element_size()
    P = (U + 2) * (U + 1) // 2
    if x.device.type == "meta":
        return _on_meta("dot_features_query", (N, P + D), x.dtype, x.device,
                        _cost.dot_features_query_cost(N, U, D, isz))
    geo = query_geometry(U, D, isz)
    out = torch.empty((N, P + D), dtype=x.dtype, device=x.device)
    if N == 0:
        return out
    fn = _build.function("dot_interaction", "dot_features_query_forward",
                         [_P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _I])
    err = fn(x.data_ptr(), user.data_ptr(), cand.data_ptr(), _DTYPES[x.dtype],
             out.data_ptr(), U, N, D, geo.rows, x.device.index,
             torch.cuda.current_stream(x.device).cuda_stream,
             copy_width(D * isz, cand.data_ptr()))
    _build.check("dot_interaction", err, "dot_features_query")
    dot_features_query.launches += 1
    return out


dot_features_query.launches = 0  # kernel launches (counted only where launched)
