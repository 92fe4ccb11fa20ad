"""Measured per-bank traffic: exact read/byte counters of a batch (the port
of the reference's ``repro/obs/traffic.py``: the plain-banked, cached,
tiered and replicated counters).

The device counters are torch on the batch's own tensors: every valid
(row >= 0) entry is one read on its row's bank, duplicates count
separately, and ``nbytes`` weights each read by its row's stored width
(uniform ``dim * itemsize`` on the plain path; on the tiered path the
row's tier code indexes a 3-entry byte table). ``index_add_`` on int32 is
exact on any device, whatever order the card adds in. Each counter has a
numpy twin (``host_*``) that the tests and the chip smoke hold it against.
The replicated twin carries its own uint32 wang hash, so its copy pick is
the kernel's bit for bit, and it reproduces the failover maps' accounting
(a dead chosen copy reads the row's FIRST live column; a row with no live
copy reads no bank). On the fused cache + residual path a cache hit is
one read on its entry's bank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.embedding_bag import replica_of_bag


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


def cached_bank_read_counts(entry_bank: torch.Tensor,
                            cache_idx: torch.Tensor,
                            remap_bank: torch.Tensor,
                            residual_idx: torch.Tensor, n_banks: int, *,
                            bank_live: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Fused cache + residual path: a cache hit is ONE read on the entry's
    bank (``entry_bank[cache_idx]``), residual rows read their own banks.
    Both streams honour ``bank_live``."""
    hits = bank_read_counts(entry_bank, cache_idx, n_banks,
                            bank_live=bank_live)
    return hits + bank_read_counts(remap_bank, residual_idx, n_banks,
                                   bank_live=bank_live)


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


def replicated_bank_read_counts(remap_bank: torch.Tensor, rows: torch.Tensor,
                                n_banks: int, *, k_max: int,
                                bank_live: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """Replicated path: bag ``n`` of the flattened batch reads copy
    ``wang_hash(n) % k_max``, the kernel's pick. Under ``bank_live`` a dead
    chosen copy reads the row's FIRST live column instead, and a row with
    no live copy reads no bank (it zero-fills).

    ``rows``: ``(..., L)`` row ids, -1 padded; the leading dims flatten to
    the lookup's per-call bag id. ``remap_bank``: the ``(V, k_max)``
    copy -> bank map."""
    flat = rows.reshape(-1, rows.shape[-1])
    n_bags, bag_len = flat.shape
    cols = replica_of_bag(torch.arange(n_bags, device=rows.device),
                          k_max).long()
    valid = flat >= 0
    banks_rc = remap_bank[torch.where(valid, flat, 0).long()].long()
    col_idx = cols[:, None, None].expand(n_bags, bag_len, 1)
    bank = banks_rc.gather(2, col_idx)[..., 0]
    if bank_live is not None:
        live_rc = bank_live[banks_rc]                        # (B, L, k)
        first_live = torch.argmax(live_rc.to(torch.uint8), dim=-1)
        chosen_live = live_rc.gather(2, col_idx)[..., 0]
        eff_col = torch.where(chosen_live, cols[:, None], first_live)
        bank = banks_rc.gather(2, eff_col[..., None])[..., 0]
        valid = valid & live_rc.any(dim=-1)
    return torch.zeros(n_banks, dtype=torch.int32,
                       device=rows.device).index_add_(
        0, bank.reshape(-1), valid.reshape(-1).to(torch.int32))


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


def host_cached_bank_read_counts(entry_bank, cache_idx, bank_of_row,
                                 residual_idx, n_banks: int,
                                 *, bank_live=None) -> np.ndarray:
    return (host_bank_read_counts(entry_bank, cache_idx, n_banks,
                                  bank_live=bank_live)
            + host_bank_read_counts(bank_of_row, residual_idx, n_banks,
                                    bank_live=bank_live))


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


def _wang_hash_np(x: np.ndarray) -> np.ndarray:
    """uint32 wang hash, bit for bit the kernel's ``wang_hash``."""
    x = np.asarray(x).astype(np.uint32)
    x = (x ^ np.uint32(61)) ^ (x >> np.uint32(16))
    x = (x * np.uint32(9)).astype(np.uint32)
    x = x ^ (x >> np.uint32(4))
    x = (x * np.uint32(0x27D4EB2D)).astype(np.uint32)
    return x ^ (x >> np.uint32(15))


def host_replica_cols(n_bags: int, k_max: int) -> np.ndarray:
    """numpy twin of ``replica_of_bag(arange(n_bags), k_max)``."""
    return (_wang_hash_np(np.arange(n_bags))
            % np.uint32(k_max)).astype(np.int32)


def host_replicated_bank_read_counts(bank_of_copy, rows, n_banks: int, *,
                                     k_max: int,
                                     bank_live=None) -> np.ndarray:
    rows = np.asarray(rows)
    flat = rows.reshape(-1, rows.shape[-1])
    cols = host_replica_cols(flat.shape[0], k_max)
    bank_of_copy = np.asarray(bank_of_copy)
    counts = np.zeros(n_banks, np.int64)
    live = None if bank_live is None else np.asarray(bank_live)
    for n, bag in enumerate(flat):
        bag = bag[bag >= 0]
        if bag.size == 0:
            continue
        banks_rc = bank_of_copy[bag]                         # (L, k)
        if live is None:
            np.add.at(counts, banks_rc[:, cols[n]], 1)
            continue
        live_rc = live[banks_rc]
        eff = np.where(live_rc[:, cols[n]], cols[n],
                       np.argmax(live_rc, axis=1))
        bank = banks_rc[np.arange(len(bag)), eff]
        np.add.at(counts, bank[live_rc.any(axis=1)], 1)
    return counts
