"""Telemetry-driven tier assignment: frequency estimates -> per-row tiers
(a numpy copy of the reference's ``repro/quant/tiers.py``).

The policy is the byte-bandwidth counterpart of the §3.2 greedy: the
partitioners spread row *reads* across banks; the tier assigner shrinks the
*bytes per read*, spending a byte budget where the telemetry says it buys
the most accuracy — the hot head (which dominates both traffic and gradient
signal) keeps full precision, the cold tail (rarely read, so its
quantization error rarely surfaces) drops to int8/int4.

Deterministic in (freq, spec): ranking uses a stable argsort, so the
replanner's re-tier decisions replay exactly from a seed, and equal the
reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.quant.quantize import (QuantSpec, TIER_HOT, TIER_INT4, TIER_INT8,
                                  tier_nbytes)


@dataclasses.dataclass(frozen=True)
class TierAssignment:
    """Per-vocab-row tier map + the byte accounting it implies."""

    tier_of_row: np.ndarray            # (vocab,) int32
    n_hot: int
    n_int8: int
    n_int4: int
    avg_bytes_per_row: float

    @property
    def counts(self) -> tuple[int, int, int]:
        return self.n_hot, self.n_int8, self.n_int4


def assign_tiers(freq: np.ndarray, spec: QuantSpec, dim: int
                 ) -> TierAssignment:
    """Rank rows by estimated frequency; fit tiers to the byte budget.

    1. the ``spec.min_hot_rows`` hottest rows are pinned to the hot tier,
    2. everything else starts int8,
    3. if the budget is still exceeded and int4 is enabled, the COLDEST rows
       are demoted to int4, exactly as many as the budget arithmetic needs,
    4. if the budget has slack beyond all-int8, extra hottest rows are
       PROMOTED to the hot tier instead.

    A ``byte_budget`` of None skips steps 3-4 (hot head + int8 tail). An
    infeasible budget (below the int4 floor, or below int8 with int4
    disabled) degrades to the closest representable mix — tiering must never
    fail a replan.
    """
    freq = np.asarray(freq, np.float64)
    vocab = freq.shape[0]
    bh, b8, b4 = (int(x) for x in tier_nbytes(dim, spec.hot_dtype))
    order = np.argsort(-freq, kind="stable")

    tier = np.full(vocab, TIER_INT8, np.int32)
    n_hot = min(int(spec.min_hot_rows), vocab)
    tier[order[:n_hot]] = TIER_HOT
    rest = vocab - n_hot
    n4 = 0
    if spec.byte_budget is not None and rest > 0:
        remaining = spec.byte_budget * vocab - n_hot * bh
        if remaining < b8 * rest:
            # b8 == b4 at dim 1 (packing buys nothing): int4 demotion is a
            # no-op there, so the all-int8 tail is already the floor
            if spec.enable_int4 and b8 > b4:
                n4 = int(np.ceil((b8 * rest - remaining) / (b8 - b4)))
                n4 = min(max(n4, 0), rest)
                tier[order[vocab - n4:]] = TIER_INT4
            # int4 off: all-int8 tail is the floor — best effort
        else:
            extra = int((remaining - b8 * rest) // (bh - b8))
            extra = min(max(extra, 0), rest)
            tier[order[n_hot:n_hot + extra]] = TIER_HOT
            n_hot += extra
            rest -= extra
    lut = tier_nbytes(dim, spec.hot_dtype).astype(np.float64)
    avg = float(lut[tier].mean()) if vocab else float(bh)
    return TierAssignment(tier_of_row=tier, n_hot=n_hot,
                          n_int8=vocab - n_hot - n4, n_int4=n4,
                          avg_bytes_per_row=avg)
