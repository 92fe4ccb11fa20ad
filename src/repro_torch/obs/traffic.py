"""Measured per-bank traffic: exact read/byte counters of a batch (the port
of the reference's ``repro/obs/traffic.py``, the plain-banked and tiered
counters).

The device counters are torch on the batch's own tensors: every valid
(row >= 0) entry is one read on its row's bank, duplicates count
separately, and ``nbytes`` weights each read by its row's stored width
(uniform ``dim * itemsize`` on the plain path; on the tiered path the
row's tier code indexes a 3-entry byte table). ``index_add_`` on int32 is
exact on any device, whatever order the card adds in. Each counter has a
numpy twin (``host_*``) that the tests and the chip smoke hold it against.

The replicated and cached counters come with their lanes (ROADMAP queue 1
#12 and the cache lane of #10).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class BankTraffic(NamedTuple):
    """Per-bank measured traffic for one batch: ``(n_banks,)`` int32 each."""

    reads: torch.Tensor
    nbytes: torch.Tensor


def traffic_from_reads(reads: torch.Tensor, row_nbytes: int) -> BankTraffic:
    """Uniform-width paths: every read moves the same ``row_nbytes``."""
    return BankTraffic(reads=reads, nbytes=reads * int(row_nbytes))


def _banks_of(remap_bank: torch.Tensor, rows: torch.Tensor):
    flat = rows.reshape(-1)
    valid = flat >= 0
    safe = torch.where(valid, flat, 0).long()
    return remap_bank[safe].long(), safe, valid


def bank_read_counts(remap_bank: torch.Tensor, rows: torch.Tensor,
                     n_banks: int, *,
                     bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """Per-bank read counts for a batch of row ids (any shape, -1 padded):
    each valid entry is one read on ``remap_bank[row]``. Under
    ``bank_live`` a dead bank's reads are excluded — they zero-fill
    instead of moving bytes."""
    bank, _, valid = _banks_of(remap_bank, rows)
    if bank_live is not None:
        valid = valid & bank_live[bank]
    return torch.zeros(n_banks, dtype=torch.int32,
                       device=rows.device).index_add_(
        0, bank, valid.to(torch.int32))


def tiered_bank_traffic(remap_bank: torch.Tensor, remap_slot: torch.Tensor,
                        rows_per_bank: int, tier: torch.Tensor, byte_lut,
                        rows: torch.Tensor, n_banks: int) -> BankTraffic:
    """Tiered path: reads as the plain counter, bytes weighted by the row's
    tier width. ``tier`` is the packed-position tier code vector the
    TieredTable carries; ``byte_lut`` the 3-entry bytes-per-tier table
    (``quant.tier_nbytes``)."""
    bank, safe, valid = _banks_of(remap_bank, rows)
    pos = bank * rows_per_bank + remap_slot[safe].long()
    lut = torch.as_tensor(np.asarray(byte_lut), dtype=torch.int32,
                          device=rows.device)
    width = lut[tier[pos].long()]
    zeros = torch.zeros(n_banks, dtype=torch.int32, device=rows.device)
    reads = zeros.clone().index_add_(0, bank, valid.to(torch.int32))
    nbytes = zeros.index_add_(0, bank, torch.where(valid, width, 0))
    return BankTraffic(reads=reads, nbytes=nbytes)


# ---------------------------------------------------------------------------
# host-side twins (numpy) — the recount the device counters must equal
# ---------------------------------------------------------------------------

def host_bank_read_counts(bank_of_row, rows, n_banks: int,
                          *, bank_live=None) -> np.ndarray:
    rows = np.asarray(rows).reshape(-1)
    rows = rows[rows >= 0]
    bank = np.asarray(bank_of_row)[rows]
    if bank_live is not None:
        bank = bank[np.asarray(bank_live)[bank]]
    return np.bincount(bank, minlength=n_banks).astype(np.int64)


def host_tiered_bank_traffic(bank_of_row, slot_of_row, rows_per_bank: int,
                             tier, byte_lut, rows,
                             n_banks: int) -> tuple[np.ndarray, np.ndarray]:
    rows = np.asarray(rows).reshape(-1)
    rows = rows[rows >= 0]
    bank = np.asarray(bank_of_row)[rows]
    pos = bank.astype(np.int64) * rows_per_bank \
        + np.asarray(slot_of_row)[rows]
    width = np.asarray(byte_lut, np.int64)[np.asarray(tier)[pos]]
    reads = np.bincount(bank, minlength=n_banks).astype(np.int64)
    nbytes = np.bincount(bank, weights=width,
                         minlength=n_banks).astype(np.int64)
    return reads, nbytes
