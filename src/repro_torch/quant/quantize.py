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

``quantize_rows_t`` quantizes rows where they are (torch: on the card on
the swap path, between micro-batches) and ``quantize_rows`` is its numpy
face; both give the reference's bytes: every step is exactly rounded
(``amax / qmax`` and ``x / scale`` are IEEE fp32 divisions, ``rint``
rounds half to even, the bf16 hot tier is the round-to-nearest-even
cast, which is the rounding of the reference's ``ml_dtypes.bfloat16``),
so the result does not depend on the device. ``dequant_rows_f32``
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


def _hot_bytes(rows: torch.Tensor, hot_dtype: str) -> torch.Tensor:
    """(n, D) fp32 rows -> (n, row_bytes) int8: the hot dtype's
    little-endian bit patterns (bf16 by round-to-nearest-even)."""
    x = rows if hot_dtype == "fp32" else rows.to(torch.bfloat16)
    return x.contiguous().view(torch.int8)


def _pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(n, D) int8 in [-7, 7] -> (n, ceil(D/2)) packed nibbles."""
    if q.shape[1] % 2:
        q = torch.cat([q, q.new_zeros((q.shape[0], 1))], dim=1)
    lo = q[:, 0::2].to(torch.int16) & 0xF
    hi = q[:, 1::2].to(torch.int16) & 0xF
    return ((lo | (hi << 4)) & 0xFF).to(torch.uint8).view(torch.int8)


def quantize_rows_t(rows: torch.Tensor, tier: torch.Tensor, *,
                    hot_dtype: str = "bf16", chunk: int = 1 << 22
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize (n, D) fp rows into the fixed-width byte payload, on the
    rows' device.

    Returns ``(payload (n, row_bytes) int8, scale (n,) fp32)``. Hot rows
    store their bit pattern with scale 1; quantized rows store the symmetric
    code with ``scale = amax / qmax`` (scale 1 for all-zero rows, so pad
    rows quantize deterministically). Unused trailing bytes stay zero. The
    quantized tiers go ``chunk`` rows at a time (bounded scratch memory).
    """
    rows = rows.detach().float()
    dev = rows.device
    tier = tier.to(dev)
    n, d = rows.shape
    payload = torch.zeros((n, row_bytes(d, hot_dtype)), dtype=torch.int8,
                          device=dev)
    scale = torch.ones(n, dtype=torch.float32, device=dev)
    hot = torch.nonzero(tier == TIER_HOT).squeeze(1)
    if hot.numel():
        hb = _hot_bytes(rows[hot], hot_dtype)
        payload[hot, :hb.shape[1]] = hb
    for t, qmax, pack in ((TIER_INT8, 127, None), (TIER_INT4, 7, _pack_int4)):
        ids = torch.nonzero(tier == t).squeeze(1)
        for c in range(0, ids.numel(), chunk):
            idx = ids[c:c + chunk]
            r = rows[idx]                  # a gather: the ops below in place
            amax = r.abs().amax(dim=1)
            # a tensor divisor: a Python-scalar divisor on CUDA becomes a
            # multiply by its reciprocal, which rounds differently
            sc = torch.where(amax > 0, amax / torch.full_like(amax, qmax),
                             torch.ones_like(amax))
            r.div_(sc[:, None]).round_().clamp_(-qmax, qmax)
            q = r.to(torch.int8)
            pb = q if pack is None else pack(q)
            payload[idx, :pb.shape[1]] = pb
            scale[idx] = sc
    return payload, scale


def quantize_rows(rows: np.ndarray, tier: np.ndarray, *,
                  hot_dtype: str = "bf16") -> tuple[np.ndarray, np.ndarray]:
    """``quantize_rows_t`` on host arrays: (n, D) fp rows and their (n,)
    tiers -> ``(payload (n, row_bytes) int8, scale (n,) fp32)``."""
    payload, scale = quantize_rows_t(
        torch.from_numpy(np.ascontiguousarray(rows, np.float32)),
        torch.from_numpy(np.ascontiguousarray(tier)), hot_dtype=hot_dtype)
    return payload.numpy(), scale.numpy()


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
