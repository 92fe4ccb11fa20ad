"""Live migration: apply a new PartitionPlan to a packed table on its
device (the port of the reference's ``repro/workload/migrate.py``).

Rebuilding a table from scratch on every replan would stream the full vocab
through host memory; migration reuses what is already resident: every row
is one gather from its old packed position and one scatter to its new one,
on the table's device, with no host round trip of the table. The swap to
the new (packed, remap_bank, remap_slot) triple happens between
micro-batches on the host, so the serve step never sees a half-migrated
table. Keeping ``rows_per_bank`` at a fixed capacity across plans keeps
every tensor shape fixed (runtime.py relies on this).

``migrate_table`` is exact: the result equals ``pack_table`` of the same
row values under the new plan, bit for bit; so does ``migrate_replicated``
(the replica lane's side table, built from the live base table) against
``pack_replicated``.

Under a ``DistCtx`` each rank holds one bank's shard and migrates it in
place: rows that stay on their bank are a gather and a scatter inside the
shard (no traffic), and rows that change bank ride ONE sum over the bank
group, ``compact`` (an (n_moved, dim) buffer where each moved row has one
position, enumerated on the host) or ``full`` (a buffer of the whole new
packed size). ``migrate_rows_sharded`` is that exchange for any
packed-row-aligned tensor: the runtime moves the row-wise Adagrad
accumulator and the tier lane's payload and scales through it. Each buffer position is written by exactly one bank, and
the sum runs on the row bytes viewed as integers, so it is exact for any
table dtype on any backend: the shards equal the single-device migration's
rows bit for bit. Every rank of the grid must migrate under the same plan
(the exchange is sized and addressed by it): before anything moves, the
ranks compare a CRC-32 of the old remaps, the new plan and the capacity
over the whole grid, one 16-byte max, and all raise if any differs. A
replan that moves no row needs no other collective.
"""
from __future__ import annotations

import zlib

import numpy as np
import torch

from repro_torch.core.embedding import (BankedTable, ReplicatedTable,
                                        _check_dist)
from repro_torch.core.partitioning import PartitionPlan, ReplicatedPlan


def _flat_positions(plan: PartitionPlan, rows_per_bank: int) -> np.ndarray:
    return (plan.bank_of_row.astype(np.int64) * rows_per_bank
            + plan.slot_of_row).astype(np.int32)


def resolve_rows_per_bank(plan: PartitionPlan,
                          rows_per_bank: int | None) -> int:
    rpb = int(plan.max_rows_per_bank if rows_per_bank is None
              else rows_per_bank)
    if rpb < plan.max_rows_per_bank:
        raise ValueError(f"rows_per_bank {rpb} < plan max "
                         f"{plan.max_rows_per_bank}")
    return rpb


def _index(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def permute_packed_rows(arr: torch.Tensor, old_flat, new_flat,
                        new_len: int) -> torch.Tensor:
    """Reindex the leading (packed-row) dim of ``arr`` from the old flat
    layout to the new one, on ``arr``'s device; unpopulated pad rows become
    zeros (pack_table semantics). Works for (R, D) tables and (R,) row-wise
    optimizer state. ``old_flat`` / ``new_flat`` are (vocab,) positions,
    numpy or tensors."""
    out = torch.zeros((new_len,) + tuple(arr.shape[1:]), dtype=arr.dtype,
                      device=arr.device)
    out[_index(new_flat, arr.device)] = arr[_index(old_flat, arr.device)]
    return out


def migrate_table(t: BankedTable, new_plan: PartitionPlan, dist=None, *,
                  rows_per_bank: int | None = None,
                  exchange: str = "compact") -> BankedTable:
    """Re-layout ``t`` under ``new_plan`` without re-initializing, on the
    table's device.

    ``rows_per_bank`` pins the per-bank capacity (pass the table's current
    value to keep shapes stable across swaps). ``dist`` (a ``DistCtx``):
    ``t`` is this rank's bank shard and so is the result; ``exchange``
    ('compact' or 'full') shapes the moved rows' sum over the bank group.
    """
    _check_dist(dist)
    if new_plan.vocab != t.vocab:
        raise ValueError(f"plan vocab {new_plan.vocab} != table {t.vocab}")
    if exchange not in ("compact", "full"):
        raise ValueError(f"exchange must be 'compact' or 'full', "
                         f"got {exchange!r}")
    new_rpb = resolve_rows_per_bank(new_plan, rows_per_bank)
    dev = t.packed.device
    if dist is None:
        packed = permute_packed_rows(t.packed.detach(), t.remap_flat,
                                     _flat_positions(new_plan, new_rpb),
                                     new_plan.n_banks * new_rpb)
    else:
        packed = _migrate_packed_sharded(t, new_plan, new_rpb, dist,
                                         exchange=exchange)
    return BankedTable(
        packed=packed,
        remap_bank=torch.from_numpy(
            new_plan.bank_of_row.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(
            new_plan.slot_of_row.astype(np.int32)).to(dev),
        n_banks=new_plan.n_banks,
        rows_per_bank=new_rpb)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """``x``'s bytes as integers (int32 words where they divide, else
    bytes), one row of words per leading index of ``x``: an exact carrier
    for a sum in which every position is written by one rank."""
    b = x.contiguous().view(torch.uint8).reshape(x.shape[0], -1)
    return b.view(torch.int32) if b.shape[1] % 4 == 0 else b


def _from_bits(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.view(torch.uint8).view(like.dtype).reshape(like.shape)


def _exact_bank_sum(dist, buf: torch.Tensor) -> torch.Tensor:
    """The sum of ``buf`` over the bank group, bit for bit: each position
    holds one bank's row and zeros elsewhere, summed as integers."""
    return _from_bits(dist.psum(_bits(buf), "bank"), buf)


def _check_same_plan(dist, arrays, params, device) -> None:
    """Raise on every rank unless every rank of the grid holds the same
    ``arrays`` (the old remaps and the new plan) and ``params``: their
    CRC-32, and its negation, maxed over the grid, agree only if the least
    checksum equals the greatest."""
    c = zlib.crc32(repr(params).encode())
    for a in arrays:
        c = zlib.crc32(np.ascontiguousarray(a, np.int32).view(np.uint8), c)
    hi, neg_lo = dist.pmax(torch.tensor([c, -c], dtype=torch.int64,
                                        device=device),
                           ("dp", "bank")).tolist()
    if hi != -neg_lo:
        raise RuntimeError(
            "sharded migration: the ranks of the grid hold different plans "
            "(or old remaps, or capacities); every rank must replan from the "
            "same telemetry, e.g. observe the global batch")


def _migrate_packed_sharded(t: BankedTable, new_plan: PartitionPlan,
                            new_rpb: int, dist, *,
                            exchange: str) -> torch.Tensor:
    """This bank's shard of the table under ``new_plan`` (the reference's
    ``_migrate_packed_sharded``). The bank count is the grid's and cannot
    change."""
    if new_plan.n_banks != t.n_banks or t.n_banks != dist.n_banks:
        raise ValueError("sharded migration keeps the bank count (the grid's "
                         f"bank axis is fixed): {t.n_banks} -> "
                         f"{new_plan.n_banks} on {dist.n_banks} banks")
    if t.packed.shape[0] != t.rows_per_bank:
        raise ValueError(f"sharded migration: a shard of "
                         f"{t.packed.shape[0]} rows, rows_per_bank "
                         f"{t.rows_per_bank}")
    return migrate_rows_sharded(
        t.packed.detach(), t.remap_bank.cpu().numpy(),
        t.remap_slot.cpu().numpy(), new_plan.bank_of_row,
        new_plan.slot_of_row, new_rpb, dist, exchange=exchange)


def migrate_rows_sharded(local: torch.Tensor, old_bank: np.ndarray,
                         old_slot: np.ndarray, new_bank: np.ndarray,
                         new_slot: np.ndarray, new_rpb: int, dist, *,
                         exchange: str = "compact") -> torch.Tensor:
    """This bank's shard of any packed-row-aligned tensor (table rows, the
    row-wise Adagrad accumulator, a tiered payload or its scales) moved
    from the old remaps to the new ones: the rows staying on the bank
    moved inside the shard, the rows arriving from other banks taken from
    one exact sum over the bank group. ``local`` is this rank's
    ``(old rows_per_bank, ...)`` piece; the remaps are (vocab,) arrays,
    the same on every rank (checked first); unpopulated positions are
    zeros. The result is ``(new_rpb, ...)``."""
    dev, my = local.device, dist.bank_rank
    _check_same_plan(dist, (old_bank, old_slot, new_bank, new_slot),
                     (new_rpb, exchange, tuple(local.shape[1:]),
                      str(local.dtype)), dev)
    # rows that stay on this bank: a permutation inside the shard
    stay = np.nonzero((old_bank == my) & (new_bank == my))[0]
    out = torch.zeros((new_rpb,) + tuple(local.shape[1:]), dtype=local.dtype,
                      device=dev)
    out[_index(new_slot[stay], dev)] = local[_index(old_slot[stay], dev)]
    moved = np.nonzero(old_bank != new_bank)[0]
    if moved.size == 0:
        return out                        # no row changes bank: no exchange
    out_mine = moved[old_bank[moved] == my]          # rows this bank sends
    if exchange == "compact":
        pos = np.arange(moved.size)
        buf = torch.zeros((moved.size,) + tuple(local.shape[1:]),
                          dtype=local.dtype, device=dev)
        buf[_index(pos[old_bank[moved] == my], dev)] = \
            local[_index(old_slot[out_mine], dev)]
        buf = _exact_bank_sum(dist, buf)
        arrive = new_bank[moved] == my
        out[_index(new_slot[moved[arrive]], dev)] = \
            buf[_index(pos[arrive], dev)]
        return out
    n_banks = dist.n_banks
    buf = torch.zeros((n_banks * new_rpb,) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=dev)
    buf[_index(new_bank[out_mine].astype(np.int64) * new_rpb
               + new_slot[out_mine], dev)] = \
        local[_index(old_slot[out_mine], dev)]
    incoming = _exact_bank_sum(dist, buf)[my * new_rpb:(my + 1) * new_rpb]
    # stay rows and arrivals never share a slot: join them as integers
    return _from_bits(_bits(out) + _bits(incoming), out)


def migrate_replicated(base: BankedTable, rplan: ReplicatedPlan, *,
                       rows_per_bank: int | None = None) -> ReplicatedTable:
    """The replicated side table of ``rplan`` built from a live base table,
    on its device with no host round trip: every copy the plan calls for
    gathers its row's values once through the base remap and is scattered
    to its (bank, slot). Equal to ``pack_replicated`` of the unpacked rows
    bit for bit. ``rows_per_bank`` pins the shape across swaps."""
    rpb = int(rplan.max_rows_per_bank if rows_per_bank is None
              else rows_per_bank)
    if rpb < rplan.max_rows_per_bank:
        raise ValueError(f"rows_per_bank {rpb} < replica plan max "
                         f"{rplan.max_rows_per_bank}")
    if rplan.vocab != base.vocab:
        raise ValueError(f"replica plan vocab {rplan.vocab} != table "
                         f"{base.vocab}")
    dev = base.packed.device
    bank = torch.from_numpy(rplan.bank_of_copy.astype(np.int32)).to(dev)
    slot = torch.from_numpy(rplan.slot_of_copy.astype(np.int32)).to(dev)
    copies = torch.from_numpy(rplan.copies.astype(np.int32)).to(dev)
    vv, rr = torch.nonzero(torch.arange(rplan.k_max, device=dev)[None, :]
                           < copies[:, None], as_tuple=True)
    pos = bank[vv, rr].long() * rpb + slot[vv, rr].long()
    packed = torch.zeros((rplan.n_banks * rpb, base.dim),
                         dtype=base.packed.dtype, device=dev)
    packed[pos] = base.packed.detach()[base.remap_flat[vv].long()]
    return ReplicatedTable(packed=packed, remap_bank=bank, remap_slot=slot,
                           n_banks=rplan.n_banks, rows_per_bank=rpb,
                           k_max=rplan.k_max)


def migrate_rowwise_state(arr: torch.Tensor, old_table: BankedTable,
                          new_plan: PartitionPlan, dist=None, *,
                          rows_per_bank: int | None = None,
                          exchange: str = "compact") -> torch.Tensor:
    """Migrate a packed-row-aligned auxiliary tensor (e.g. the row-wise
    Adagrad accumulator, shape (n_banks*rows_per_bank,) or (..., D)) with
    the same permutation as the table rows. ``dist``: ``arr`` and
    ``old_table`` are this rank's bank shards, and so is the result
    (``migrate_rows_sharded``)."""
    new_rpb = resolve_rows_per_bank(new_plan, rows_per_bank)
    if dist is not None:
        return migrate_rows_sharded(
            arr, old_table.remap_bank.cpu().numpy(),
            old_table.remap_slot.cpu().numpy(), new_plan.bank_of_row,
            new_plan.slot_of_row, new_rpb, dist, exchange=exchange)
    return permute_packed_rows(arr, old_table.remap_flat,
                               _flat_positions(new_plan, new_rpb),
                               new_plan.n_banks * new_rpb)


def migrate_packed_leaves(tree, old_table: BankedTable,
                          new_plan: PartitionPlan, *,
                          rows_per_bank: int | None = None):
    """Migrate every packed-row-aligned leaf of a nested dict / list / tuple
    of tensors — params AND optimizer state in one pass (the row-wise
    Adagrad accumulator must follow its row or hot rows restart cold).

    A leaf participates iff its leading dim equals the packed row count
    (``n_banks * rows_per_bank`` — vocab-scale, so dense layers never
    collide with it in practice).
    """
    # module-level recursion (_map_tree), not a self-referencing closure:
    # that would be a reference cycle keeping the old table (GBs) alive
    # until the garbage collector happens to run
    plen = old_table.n_banks * old_table.rows_per_bank

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.dim() >= 1 \
                and x.shape[0] == plen:
            return migrate_rowwise_state(x, old_table, new_plan,
                                         rows_per_bank=rows_per_bank)
        return x

    return _map_tree(leaf, tree)


def _map_tree(fn, tree):
    """``fn`` applied to every non-container leaf of nested dicts, lists and
    tuples, the structure kept."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v) for v in tree)
    return fn(tree)
