"""Live migration: apply a new PartitionPlan to a packed table on its
device (the port of the reference's ``repro/workload/migrate.py``, the
single-device path).

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
``pack_replicated``. The sharded migration (a row exchange across cards) is
ROADMAP queue 1 #16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.embedding import BankedTable, ReplicatedTable
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
                  rows_per_bank: int | None = None) -> BankedTable:
    """Re-layout ``t`` under ``new_plan`` without re-initializing, on the
    table's device.

    ``rows_per_bank`` pins the per-bank capacity (pass the table's current
    value to keep shapes stable across swaps).
    """
    if dist is not None:
        raise NotImplementedError(
            "sharded migration (the multi-GPU bank axis) is not ported yet: "
            "ROADMAP queue 1 #16")
    if new_plan.vocab != t.vocab:
        raise ValueError(f"plan vocab {new_plan.vocab} != table {t.vocab}")
    new_rpb = resolve_rows_per_bank(new_plan, rows_per_bank)
    dev = t.packed.device
    packed = permute_packed_rows(t.packed.detach(), t.remap_flat,
                                 _flat_positions(new_plan, new_rpb),
                                 new_plan.n_banks * new_rpb)
    return BankedTable(
        packed=packed,
        remap_bank=torch.from_numpy(
            new_plan.bank_of_row.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(
            new_plan.slot_of_row.astype(np.int32)).to(dev),
        n_banks=new_plan.n_banks,
        rows_per_bank=new_rpb)


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
                          new_plan: PartitionPlan, *,
                          rows_per_bank: int | None = None) -> torch.Tensor:
    """Migrate a packed-row-aligned auxiliary tensor (e.g. the row-wise
    Adagrad accumulator, shape (n_banks*rows_per_bank,) or (..., D)) with
    the same permutation as the table rows."""
    new_rpb = resolve_rows_per_bank(new_plan, rows_per_bank)
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
