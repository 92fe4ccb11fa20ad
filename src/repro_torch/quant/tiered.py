"""TieredTable: a mixed-precision banked embedding table (the port of the
reference's ``repro/quant/tiered.py``).

Same layout contract as ``core.embedding.BankedTable`` — packed rows at
``bank * rows_per_bank + slot``, row -> (bank, slot) remap vectors, fixed
per-bank capacity — but the row storage is the tiered byte payload of
``quant/quantize.py`` plus per-row ``scale`` and ``tier`` vectors. Every
tensor shape depends only on (capacity, dim, hot dtype), NEVER on the tier
mix, so a live re-tier swap hands the serve step tensors of the shapes,
dtypes and device of version 0 (``same_layout`` checks it).

Two builders:

  ``build_tiered_table``  — from scratch: quantize every packed row of an fp
      BankedTable by its assigned tier, on the table's device
      (``quantize_rows_t``: the reference's bytes on any device).
  ``retier_tiered``       — the swap-path incremental: permute the previous
      payload and scales through the migration's row permutation on the
      table's device (stay rows keep their bytes — the fp values they were
      quantized from migrated bit-exactly), then re-quantize ONLY the rows
      whose tier changed, from the CURRENT fp values, plus newly-padded
      positions. Bit-identical to a from-scratch build at the
      same (table, tiers), because row-wise quantization is deterministic
      per (fp row, tier).

The fp source table is duck-typed on the BankedTable fields it reads
(``packed``, ``remap_bank``, ``remap_slot``, ``remap_flat``, ``n_banks``,
``rows_per_bank``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.quant.quantize import TIER_INT8, quantize_rows_t, tier_nbytes

PAD_TIER = TIER_INT8      # unpopulated slots: int8 zeros, scale 1


@dataclasses.dataclass
class TieredTable:
    """Tiered byte payload + per-row scale/tier + remap vectors, as tensors
    on one device; ``n_banks``, ``rows_per_bank``, ``dim`` and ``hot_dtype``
    are the reference's static fields. ``remap_flat`` is the flat remap
    (``bank * rows_per_bank + slot``), computed once where the remaps are
    set (here when not given) and carried to every lookup."""

    payload: torch.Tensor     # (n_banks * rows_per_bank, row_bytes) int8
    scale: torch.Tensor       # (n_banks * rows_per_bank,) float32
    tier: torch.Tensor        # (n_banks * rows_per_bank,) int32
    remap_bank: torch.Tensor  # (vocab,) int32
    remap_slot: torch.Tensor  # (vocab,) int32
    n_banks: int
    rows_per_bank: int
    dim: int
    hot_dtype: str = "bf16"
    remap_flat: torch.Tensor | None = None   # (vocab,) int32

    def __post_init__(self):
        if self.remap_flat is None:
            self.remap_flat = self.flat_remap()

    @property
    def vocab(self) -> int:
        return self.remap_bank.shape[0]

    @property
    def row_bytes(self) -> int:
        return self.payload.shape[-1]

    def flat_remap(self) -> torch.Tensor:
        return (self.remap_bank * self.rows_per_bank
                + self.remap_slot).to(torch.int32)

    def tier_of_row(self) -> np.ndarray:
        """(vocab,) tier per union-vocab row (the packed map pulled back
        through the remap) — what a from-scratch rebuild needs."""
        return self.tier[self.remap_flat.long()].cpu().numpy()

    def tensors(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in (
            "payload", "scale", "tier", "remap_bank", "remap_slot",
            "remap_flat")}


def same_layout(a: TieredTable, b: TieredTable) -> bool:
    """True when every tensor of ``b`` has the shape, dtype and device of
    ``a``'s and the static fields agree — the swap contract: the serve step
    sees one layout for the life of the server."""
    if (a.n_banks, a.rows_per_bank, a.dim, a.hot_dtype) != \
            (b.n_banks, b.rows_per_bank, b.dim, b.hot_dtype):
        return False
    ta, tb = a.tensors(), b.tensors()
    return all(ta[k].shape == tb[k].shape and ta[k].dtype == tb[k].dtype
               and ta[k].device == tb[k].device for k in ta)


def _flat_np(table) -> np.ndarray:
    return (table.remap_bank.cpu().numpy().astype(np.int64)
            * table.rows_per_bank + table.remap_slot.cpu().numpy())


def packed_tier_map(table, tier_of_row: np.ndarray) -> np.ndarray:
    """(capacity,) tier per packed position; pad slots get ``PAD_TIER``."""
    R = table.n_banks * table.rows_per_bank
    tier = np.full(R, PAD_TIER, np.int32)
    tier[_flat_np(table)] = np.asarray(tier_of_row, np.int32)
    return tier


def build_tiered_table(table, tier_of_row: np.ndarray, *,
                       hot_dtype: str = "bf16",
                       bank: int | None = None) -> TieredTable:
    """Quantize an fp BankedTable's packed rows into a TieredTable on the
    table's device.

    Pad slots (all-zero rows) quantize to zero payload with scale 1 under
    ``PAD_TIER`` — deterministic, so the incremental retier can reproduce
    them bit-for-bit.

    ``bank``: ``table`` is that bank's shard (``rows_per_bank`` rows, the
    global remaps) and so is the result: quantization is per row, so the
    shard's bytes equal that bank's slice of the whole table's.
    """
    dev = table.packed.device
    tier = packed_tier_map(table, tier_of_row)
    if bank is not None:
        rpb = table.rows_per_bank
        tier = tier[bank * rpb:(bank + 1) * rpb]
    payload, scale = quantize_rows_t(table.packed, torch.from_numpy(tier),
                                     hot_dtype=hot_dtype)
    return TieredTable(
        payload=payload, scale=scale, tier=torch.from_numpy(tier).to(dev),
        remap_bank=table.remap_bank,
        remap_slot=table.remap_slot,
        n_banks=table.n_banks,
        rows_per_bank=table.rows_per_bank,
        dim=int(table.packed.shape[-1]),
        hot_dtype=hot_dtype,
        remap_flat=table.remap_flat)


def retier_tiered(prev: TieredTable, table, tier_of_row: np.ndarray,
                  dist=None, old_tier_of_row: np.ndarray | None = None
                  ) -> tuple[TieredTable, dict]:
    """Incremental rebuild for the swap path: ``table`` is the MIGRATED fp
    BankedTable (same row values, new layout), ``tier_of_row`` the fresh
    assignment. Stay-tier rows carry their bytes through the row
    permutation (on the device); only rows whose tier changed — promotions,
    demotions — are re-quantized (a device gather of just those rows), and
    newly-padded slots get zero bytes and scale 1.

    Returns ``(tiered, stats)`` with promoted/demoted/requantized counts.
    Bit-identical to ``build_tiered_table(table, tier_of_row)``.

    ``dist`` (a ``DistCtx``): ``prev`` and ``table`` are this rank's bank
    shards and so is the result; ``old_tier_of_row`` (required) is the
    (vocab,) assignment ``prev`` was built from, which no rank holds
    whole. The payload and scales of rows that change bank ride the
    migration's exact exchange (``workload.migrate.migrate_rows_sharded``);
    the rank re-quantizes its own tier-changed rows. The shard equals that
    bank's slice of the single-device result byte for byte, and the stats
    are the whole table's.
    """
    if dist is not None:
        return _retier_sharded(prev, table, tier_of_row, dist,
                               old_tier_of_row)
    dev = prev.payload.device
    old_flat = prev.remap_flat.to(dev).long()
    new_flat = table.remap_flat.to(dev).long()
    R = table.n_banks * table.rows_per_bank
    # pad slots: deterministic zero/scale-1/PAD_TIER, matching quantize_rows
    # on an all-zero row (the from-scratch build's pad handling)
    payload = torch.zeros((R, prev.row_bytes), dtype=prev.payload.dtype,
                          device=dev)
    payload[new_flat] = prev.payload[old_flat]
    scale = torch.ones((R,), dtype=prev.scale.dtype, device=dev)
    scale[new_flat] = prev.scale[old_flat]
    old_tier_of_row = prev.tier[old_flat].cpu().numpy()

    new_tier = packed_tier_map(table, tier_of_row)
    new_row_tier = np.asarray(tier_of_row, np.int32)
    changed_rows = np.nonzero(new_row_tier != old_tier_of_row)[0]
    if changed_rows.size:
        flat = new_flat[torch.from_numpy(changed_rows).to(dev)]
        pb, sc = quantize_rows_t(
            table.packed[flat], torch.from_numpy(new_row_tier[changed_rows]),
            hot_dtype=prev.hot_dtype)
        payload[flat] = pb
        scale[flat] = sc
    stats = {
        "n_requantized": int(changed_rows.size),
        "n_promoted": int((new_row_tier < old_tier_of_row).sum()),
        "n_demoted": int((new_row_tier > old_tier_of_row).sum()),
    }
    tiered = TieredTable(
        payload=payload,
        scale=scale,
        tier=torch.from_numpy(new_tier).to(dev),
        remap_bank=table.remap_bank,
        remap_slot=table.remap_slot,
        n_banks=table.n_banks,
        rows_per_bank=table.rows_per_bank,
        dim=prev.dim,
        hot_dtype=prev.hot_dtype,
        remap_flat=table.remap_flat)
    return tiered, stats


def _retier_sharded(prev: TieredTable, table, tier_of_row: np.ndarray,
                    dist, old_tier_of_row: np.ndarray | None
                    ) -> tuple[TieredTable, dict]:
    from repro_torch.workload.migrate import migrate_rows_sharded
    if old_tier_of_row is None:
        raise ValueError("retier_tiered under dist needs old_tier_of_row: "
                         "a rank holds only its bank's tiers")
    dev, my, rpb = prev.payload.device, dist.bank_rank, table.rows_per_bank
    remaps = (prev.remap_bank.cpu().numpy(), prev.remap_slot.cpu().numpy(),
              table.remap_bank.cpu().numpy(), table.remap_slot.cpu().numpy())
    payload = migrate_rows_sharded(prev.payload, *remaps, rpb, dist)
    scale = migrate_rows_sharded(prev.scale, *remaps, rpb, dist)
    new_bank, new_slot = remaps[2], remaps[3]
    mine = new_bank == my
    pad = torch.ones(rpb, dtype=torch.bool, device=dev)
    pad[torch.from_numpy(new_slot[mine].astype(np.int64)).to(dev)] = False
    scale[pad] = 1.0                  # pad slots: scale 1, as quantize_rows
    new_row_tier = np.asarray(tier_of_row, np.int32)
    old_row_tier = np.asarray(old_tier_of_row, np.int32)
    changed = new_row_tier != old_row_tier
    here = np.nonzero(changed & mine)[0]
    if here.size:
        slots = torch.from_numpy(new_slot[here].astype(np.int64)).to(dev)
        pb, sc = quantize_rows_t(table.packed[slots],
                                 torch.from_numpy(new_row_tier[here]),
                                 hot_dtype=prev.hot_dtype)
        payload[slots] = pb
        scale[slots] = sc
    stats = {
        "n_requantized": int(changed.sum()),
        "n_promoted": int((new_row_tier < old_row_tier).sum()),
        "n_demoted": int((new_row_tier > old_row_tier).sum()),
    }
    tier = packed_tier_map(table, tier_of_row)[my * rpb:(my + 1) * rpb]
    return TieredTable(
        payload=payload, scale=scale, tier=torch.from_numpy(tier).to(dev),
        remap_bank=table.remap_bank, remap_slot=table.remap_slot,
        n_banks=table.n_banks, rows_per_bank=rpb, dim=prev.dim,
        hot_dtype=prev.hot_dtype, remap_flat=table.remap_flat), stats


def modeled_bank_byte_load(tiered_tier_of_row: np.ndarray,
                           bank_of_row: np.ndarray, rows: np.ndarray,
                           dim: int, hot_dtype: str = "bf16",
                           n_banks: int | None = None) -> np.ndarray:
    """(n_banks,) bytes moved per bank for one batch's row reads — the
    byte-bandwidth analogue of row-read counts."""
    nb = int(bank_of_row.max()) + 1 if n_banks is None else n_banks
    lut = tier_nbytes(dim, hot_dtype).astype(np.float64)
    loads = np.zeros(nb)
    rows = np.asarray(rows)
    np.add.at(loads, bank_of_row[rows], lut[tiered_tier_of_row[rows]])
    return loads
