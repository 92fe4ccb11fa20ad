"""Tiered-precision embedding storage (the port of the reference's
``repro/quant``): telemetry decides which rows keep full precision (the hot
head) and which shrink to int8 / packed int4 (the cold tail);
``TieredTable`` stores the mix in fixed-shape banked tensors, and the
tiered lookup kernel (``kernels/csrc/tiered_bag.cu``) dequantizes each row
it reads."""
from repro_torch.quant.quantize import (HOT_DTYPES, QuantSpec, TIER_HOT,
                                        TIER_INT4, TIER_INT8, bytes_of_tier,
                                        dequant_rows_f32, quantize_rows,
                                        quantize_rows_t, row_bytes,
                                        tier_nbytes)
from repro_torch.quant.tiers import TierAssignment, assign_tiers
from repro_torch.quant.tiered import (PAD_TIER, TieredTable,
                                      build_tiered_table,
                                      modeled_bank_byte_load,
                                      packed_tier_map, retier_tiered,
                                      same_layout)

__all__ = [
    "HOT_DTYPES", "PAD_TIER", "QuantSpec", "TIER_HOT", "TIER_INT4",
    "TIER_INT8", "TierAssignment", "TieredTable", "assign_tiers",
    "build_tiered_table", "bytes_of_tier", "dequant_rows_f32",
    "modeled_bank_byte_load", "packed_tier_map", "quantize_rows",
    "quantize_rows_t", "retier_tiered", "row_bytes", "same_layout",
    "tier_nbytes",
]
