"""Row-wise quantization primitives for tiered embedding storage (the port
of the reference's ``repro/quant/quantize.py``).

UpDLRM's lookup hot path is bound by bytes moved per row; this module
shrinks the bytes. Three storage tiers, coded in a per-row ``tier`` map:

  ``TIER_HOT``   — the hot head keeps full precision (bf16 by default, fp32
                   selectable): bytes are the dtype's little-endian bit
                   pattern, dequant is an exact bitcast.
  ``TIER_INT8``  — row-wise symmetric int8: ``scale = amax / 127``,
                   ``q = clip(rint(x / scale), -127, 127)``. Per-element
                   error is bounded by ``scale / 2``.
  ``TIER_INT4``  — two's-complement 4-bit pairs packed one byte per two
                   values (value 2j in the LOW nibble of byte j, 2j+1 in the
                   HIGH nibble); ``scale = amax / 7``.

Every tier's bytes live in ONE ``(rows, row_bytes)`` int8 payload array
(``row_bytes`` = the hot tier's width, so the array shape never depends on
the tier mix). A quantized row uses a prefix of its byte slot; the bytes
actually *moved* per read are the tier's width.

``quantize_rows`` is host-side numpy, as in the reference (it runs on the
replan/swap path, between micro-batches), and gives the reference's bytes:
the bf16 hot tier is rounded by torch's round-to-nearest-even cast, which
is the rounding of the reference's ``ml_dtypes.bfloat16``. ``dequant_rows_f32``
is torch: the fp32 dequant of the lookup's plain version
(``kernels.embedding_bag.tiered_bag_plain``), which the CUDA kernel repeats
value for value: a quantized value is ``float(q) * scale``, one rounded
multiply, added to the bag sum as a separate rounded add.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

TIER_HOT = 0
TIER_INT8 = 1
TIER_INT4 = 2

HOT_DTYPES = ("bf16", "fp32")


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Tiered-precision policy for one banked table.

    ``byte_budget`` is the target AVERAGE stored bytes per row; the tier
    assigner (quant/tiers.py) keeps ``min_hot_rows`` of the hottest rows in
    the hot dtype, fills the rest with int8, and demotes the coldest rows to
    packed int4 until the budget is met (int8-only when ``enable_int4`` is
    off — then a budget below the int8 width is best-effort). ``None``
    means "int8 tail, no int4 pressure": hot head + everything else int8.
    """

    hot_dtype: str = "bf16"            # 'bf16' | 'fp32'
    enable_int4: bool = True
    byte_budget: float | None = None   # target avg stored bytes/row
    min_hot_rows: int = 8              # hot head always kept full-precision

    def __post_init__(self):
        if self.hot_dtype not in HOT_DTYPES:
            raise ValueError(f"hot_dtype must be one of {HOT_DTYPES}, "
                             f"got {self.hot_dtype!r}")


def tier_nbytes(dim: int, hot_dtype: str = "bf16") -> np.ndarray:
    """(3,) stored/moved bytes per row for [TIER_HOT, TIER_INT8, TIER_INT4]."""
    hot = dim * (2 if hot_dtype == "bf16" else 4)
    return np.array([hot, dim, (dim + 1) // 2], dtype=np.int64)


def row_bytes(dim: int, hot_dtype: str = "bf16") -> int:
    """Payload slot width: the hot tier's row size (every tier fits in it)."""
    return int(tier_nbytes(dim, hot_dtype)[TIER_HOT])


def bytes_of_tier(tier: np.ndarray, dim: int,
                  hot_dtype: str = "bf16") -> np.ndarray:
    """Per-row moved-bytes vector for a tier map — the partitioners' byte-load
    currency (``freq * bytes_of_tier`` is the bank byte-load the §3.2 greedy
    balances under mixed precision)."""
    return tier_nbytes(dim, hot_dtype)[np.asarray(tier)]


def _hot_bytes(rows: np.ndarray, hot_dtype: str) -> np.ndarray:
    """(n, D) fp32 rows -> (n, row_bytes) uint8: the hot dtype's
    little-endian bit patterns (bf16 by round-to-nearest-even)."""
    if hot_dtype == "fp32":
        return np.ascontiguousarray(rows, np.float32).view(np.uint8)
    bits = torch.from_numpy(np.ascontiguousarray(rows, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy()
    return np.ascontiguousarray(bits).view(np.uint8)


def _pack_int4(q: np.ndarray) -> np.ndarray:
    """(n, D) int8 in [-7, 7] -> (n, ceil(D/2)) packed nibbles."""
    n, d = q.shape
    if d % 2:
        q = np.concatenate([q, np.zeros((n, 1), q.dtype)], axis=1)
    lo = q[:, 0::2].astype(np.int16) & 0xF
    hi = q[:, 1::2].astype(np.int16) & 0xF
    return ((lo | (hi << 4)) & 0xFF).astype(np.uint8).view(np.int8)


def quantize_rows(rows: np.ndarray, tier: np.ndarray, *,
                  hot_dtype: str = "bf16") -> tuple[np.ndarray, np.ndarray]:
    """Quantize (n, D) fp rows into the fixed-width byte payload.

    Returns ``(payload (n, row_bytes) int8, scale (n,) fp32)``. Hot rows
    store their bit pattern with scale 1; quantized rows store the symmetric
    code with ``scale = amax / qmax`` (scale 1 for all-zero rows, so pad
    rows quantize deterministically). Unused trailing bytes stay zero.
    """
    rows = np.asarray(rows, np.float32)
    tier = np.asarray(tier)
    n, d = rows.shape
    payload = np.zeros((n, row_bytes(d, hot_dtype)), np.int8)
    scale = np.ones(n, np.float32)

    hot = tier == TIER_HOT
    if hot.any():
        hb = _hot_bytes(rows[hot], hot_dtype)
        payload[hot, :hb.shape[1]] = hb.view(np.int8)

    for t, qmax, pack in ((TIER_INT8, 127, None), (TIER_INT4, 7, _pack_int4)):
        m = tier == t
        if not m.any():
            continue
        amax = np.abs(rows[m]).max(axis=1)
        s = np.where(amax > 0, amax / qmax, 1.0).astype(np.float32)
        q = np.clip(np.rint(rows[m] / s[:, None]), -qmax, qmax).astype(np.int8)
        pb = q if pack is None else pack(q)
        payload[np.nonzero(m)[0][:, None],
                np.arange(pb.shape[1])[None, :]] = pb
        scale[m] = s
    return payload, scale


def dequant_rows_f32(payload: torch.Tensor, scale: torch.Tensor,
                     tier: torch.Tensor, dim: int,
                     hot_dtype: str = "bf16") -> torch.Tensor:
    """Shared fp32 dequant: payload (..., row_bytes) int8, scale (...,)
    fp32, tier (...,) int -> (..., dim) fp32, on the tensors' device.

    All three tier interpretations are computed and selected by ``tier``
    (a tier code other than HOT and INT8 reads as INT4, as the reference's
    selection does). The hot tier is an exact bitcast of the stored bf16 or
    fp32 bits; the quantized tiers are ``float(q) * scale``, one rounded
    fp32 multiply per value.
    """
    lead = payload.shape[:-1]
    hot_t = torch.bfloat16 if hot_dtype == "bf16" else torch.float32
    width = dim * (2 if hot_dtype == "bf16" else 4)
    hotv = payload[..., :width].contiguous().view(hot_t).float()

    s = scale.float()[..., None]
    q8 = payload[..., :dim].float() * s

    nh = (dim + 1) // 2
    h = payload[..., :nh].int()                    # sign-extended bytes
    lo4 = ((h & 0xF) ^ 8) - 8                      # low nibble, 4-bit signed
    hi4 = (((h >> 4) & 0xF) ^ 8) - 8
    q4 = torch.stack([lo4, hi4], dim=-1).reshape(
        *lead, 2 * nh)[..., :dim].float() * s

    t = tier[..., None]
    return torch.where(t == TIER_HOT, hotv,
                       torch.where(t == TIER_INT8, q8, q4))
