"""Shared model plumbing: initializers, and a banked table's statics.

The initializers draw from an explicit ``torch.Generator`` on the target
device. They follow the reference's distributions, not its numbers
(``jax.random`` cannot be reproduced in torch): parity tests carry the
reference's weights across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import BankedTable, flat_remap


def dense_init(generator: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut at ±2, times
    ``1/sqrt(fan_in)`` (``shape[0]``, since weights are (in, out))."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, shape, scale: float = 0.02,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def table_statics(plan, rows_per_bank: int | None = None, *,
                  device) -> dict:
    """The statics of a banked table under ``plan``: the remaps (and the
    flat remap, computed once), the bank count and the per-bank capacity
    (the plan's largest bank unless ``rows_per_bank`` is given)."""
    dev = resolve_device(device)
    bank = torch.from_numpy(plan.bank_of_row.astype(np.int32)).to(dev)
    slot = torch.from_numpy(plan.slot_of_row.astype(np.int32)).to(dev)
    rows = int(plan.max_rows_per_bank if rows_per_bank is None
               else rows_per_bank)
    return {"remap_bank": bank, "remap_slot": slot,
            "remap_flat": flat_remap(bank, slot, rows),
            "n_banks": plan.n_banks, "rows_per_bank": rows}


def banked(params: dict, statics: dict, leaf: str = "emb_packed"
           ) -> BankedTable:
    """The ``BankedTable`` of ``params[leaf]`` under ``statics``."""
    return BankedTable(packed=params[leaf],
                       remap_bank=statics["remap_bank"],
                       remap_slot=statics["remap_slot"],
                       n_banks=statics["n_banks"],
                       rows_per_bank=statics["rows_per_bank"],
                       remap_flat=statics["remap_flat"])
