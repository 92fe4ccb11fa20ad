"""Bank-partitioned embedding lookup (the paper's runtime), single device.

The port of ``repro/core/embedding.py``'s ``dist=None`` path. A table is
*packed* by a PartitionPlan (core/partitioning.py): rows are reordered so
bank b's rows are contiguous in one ``(n_banks * rows_per_bank, dim)``
tensor, and two ``int32[vocab]`` remap vectors map a row to its (bank,
slot). On one GPU the banks are logical partitions of its memory: the
lookup reads through the flat remap with ``my = -1`` (own every row), or,
when a bank is down, against a binary live map with ``my = 0``.

Stage 2 (the bag sums) has two implementations behind ``backend``:

  * ``'torch'`` — ``_bag_partial_scan``, the plain scan over the bag length
    (one (N, D) gather at a time, fp32 accumulator), on any device;
  * ``'cuda'``  — the hand-written kernel (kernels/embedding_bag.py), which
    raises on CPU tensors;
  * ``'auto'``  — the kernel for CUDA tensors, the plain version for CPU.

All three give the same bits. The bag sums are differentiable in
``packed`` through ``_BankedBag`` (the reference's ``_pallas_bag``
``custom_vjp``): its backward is the sorted-run scatter, the kernel or its
plain version by ``bwd_backend`` (``'auto'`` follows the forward). The
gradient is a dense (n_rows, dim) tensor, zero where no entry landed, and
equals the reference's ``_scatter_bag_ct`` bit for bit. The mesh path
(``DistCtx``), the tuned dispatch and the measured-traffic counters are
later slices and raise.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.partitioning import PartitionPlan
from repro_torch.kernels.embedding_bag import (banked_bag, banked_bag_plain,
                                               ct_scatter_bag,
                                               ct_scatter_bag_plain)

BACKENDS = ("auto", "torch", "cuda")


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend == "tuned":
        raise NotImplementedError(
            "backend='tuned' (the autotuned dispatch cache) is not ported "
            "yet: ROADMAP queue 1 #15")
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    return backend


def _resolve_bwd(bwd_backend: str, fwd_backend: str,
                 device: torch.device) -> str:
    """The backward scatter's backend: 'auto' follows the (resolved)
    forward; 'torch' is the plain version anywhere; 'cuda' the kernel."""
    if bwd_backend not in BACKENDS:
        raise ValueError(f"bwd_backend must be one of {BACKENDS}, got "
                         f"{bwd_backend!r}")
    if bwd_backend == "cuda" and device.type != "cuda":
        raise ValueError(f"bwd_backend='cuda' needs CUDA tensors, got "
                         f"{device}")
    return fwd_backend if bwd_backend == "auto" else bwd_backend


def flat_remap(remap_bank: torch.Tensor, remap_slot: torch.Tensor,
               rows_per_bank: int) -> torch.Tensor:
    """row -> position in the unsharded packed array."""
    return (remap_bank * rows_per_bank + remap_slot).to(torch.int32)


@dataclasses.dataclass
class BankedTable:
    """Packed rows + remap. ``remap_flat`` is ``flat_remap()``, computed
    once where the remaps are set (here when not given) and carried to every
    lookup, so no lookup rebuilds it."""

    packed: torch.Tensor       # (n_banks * rows_per_bank, dim)
    remap_bank: torch.Tensor   # (vocab,) int32
    remap_slot: torch.Tensor   # (vocab,) int32
    n_banks: int
    rows_per_bank: int
    remap_flat: torch.Tensor | None = None   # (vocab,) int32

    def __post_init__(self):
        if self.remap_flat is None:
            self.remap_flat = self.flat_remap()

    @property
    def vocab(self) -> int:
        return self.remap_bank.shape[0]

    @property
    def dim(self) -> int:
        return self.packed.shape[-1]

    def flat_remap(self) -> torch.Tensor:
        """row -> position in the unsharded packed array, computed anew."""
        return flat_remap(self.remap_bank, self.remap_slot,
                          self.rows_per_bank)


def pack_table(table: np.ndarray, plan: PartitionPlan, dtype=None, *,
               device: str | torch.device | None = "cuda") -> BankedTable:
    """Physically reorder rows by the plan; pad banks to a common row count.
    ``dtype`` is a torch dtype for the packed rows (default: the table's)."""
    dev = resolve_device(device)
    vocab, dim = table.shape
    rows_per_bank = int(plan.max_rows_per_bank)
    packed = np.zeros((plan.n_banks * rows_per_bank, dim), dtype=table.dtype)
    flat_pos = plan.bank_of_row.astype(np.int64) * rows_per_bank + plan.slot_of_row
    packed[flat_pos] = table
    packed_t = torch.from_numpy(packed).to(dev)
    if dtype is not None:
        packed_t = packed_t.to(dtype)
    return BankedTable(
        packed=packed_t,
        remap_bank=torch.from_numpy(plan.bank_of_row.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(plan.slot_of_row.astype(np.int32)).to(dev),
        n_banks=plan.n_banks,
        rows_per_bank=rows_per_bank,
    )


def init_banked(plan: PartitionPlan, dim: int, *, generator: torch.Generator,
                scale: float = 0.01, dtype=torch.float32,
                device: str | torch.device | None = "cuda") -> BankedTable:
    """Random-init a banked table without materializing the unpacked layout.
    ``generator`` lives on ``device``."""
    dev = resolve_device(device)
    rows_per_bank = int(plan.max_rows_per_bank)
    packed = torch.randn((plan.n_banks * rows_per_bank, dim),
                         generator=generator, device=dev,
                         dtype=torch.float32) * scale
    return BankedTable(
        packed=packed.to(dtype),
        remap_bank=torch.from_numpy(plan.bank_of_row.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(plan.slot_of_row.astype(np.int32)).to(dev),
        n_banks=plan.n_banks,
        rows_per_bank=rows_per_bank,
    )


# ---------------------------------------------------------------------------
# stage 2, plain version: scan over the bag length
# ---------------------------------------------------------------------------

def _bag_partial_scan(table: torch.Tensor, idx: torch.Tensor, *,
                      remap: torch.Tensor, bank: torch.Tensor | None,
                      my_bank: int | None, off: torch.Tensor) -> torch.Tensor:
    """Bag sums over the trailing L without a (..., L, D) intermediate.

    ``remap`` maps global rows to table positions; ``bank``/``my_bank``
    apply the ownership mask (skipped when bank is None); ``off`` is the
    per-field offset vector ((1,) zeros when fields are pre-offset), applied
    to bag n of the flattened batch as ``off[n % F]``. The loop itself is
    the kernel's plain version, ``banked_bag_plain``.
    """
    lead, L = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(-1, L)
    if bank is None:
        out = banked_bag_plain(table, remap, remap, off, -1, flat)
    else:
        out = banked_bag_plain(table, bank, remap, off, int(my_bank), flat)
    return out.reshape(*lead, table.shape[-1])


# ---------------------------------------------------------------------------
# single-device semantics
# ---------------------------------------------------------------------------

def _offsets(field_offsets, device) -> torch.Tensor:
    if field_offsets is None:
        return torch.zeros((1,), dtype=torch.int32, device=device)
    return torch.as_tensor(field_offsets, device=device).to(torch.int32)


def lookup_unsharded(t: BankedTable, idx: torch.Tensor, *, reduce_bag: bool,
                     field_offsets=None) -> torch.Tensor:
    """Single-device semantics (the plain path and oracle), scan form."""
    off = _offsets(field_offsets, idx.device)
    if reduce_bag:
        return _bag_partial_scan(t.packed, idx, remap=t.remap_flat,
                                 bank=None, my_bank=None, off=off)
    if field_offsets is not None:
        raise ValueError("dense gather expects pre-offset rows")
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).long()
    rows = t.packed[t.remap_flat[safe].long()]
    return torch.where(valid[..., None], rows, 0)


def _binary_live_map(remap_bank: torch.Tensor,
                     bank_live: torch.Tensor) -> torch.Tensor:
    """The single-device path owns everything via ``my_bank < 0``, which
    would bypass a bank-map mask — so degraded lookups pass ``my_bank = 0``
    against a binary map (0 = row's bank alive, 1 = dead)."""
    return torch.where(bank_live[remap_bank.long()], 0, 1).to(torch.int32)


class _BankedBag(torch.autograd.Function):
    """Bag sums differentiable in ``packed`` (the reference's
    ``_pallas_bag`` with its ``custom_vjp``). Forward: ``banked_bag`` or its
    plain version by ``fwd``; backward: ``ct_scatter_bag`` or its plain
    version by ``bwd``, onto the forward's own remap, ownership and
    offsets. Only ``packed`` gets a gradient."""

    @staticmethod
    def forward(ctx, packed, bank, slot, off, idx, my: int, fwd: str,
                bwd: str):
        ctx.save_for_backward(bank, slot, off, idx)
        ctx.my, ctx.bwd = my, bwd
        ctx.n_rows, ctx.dtype = packed.shape[0], packed.dtype
        bag = banked_bag if fwd == "cuda" else banked_bag_plain
        return bag(packed, bank, slot, off, my, idx)

    @staticmethod
    def backward(ctx, ct):
        bank, slot, off, idx = ctx.saved_tensors
        scatter = ct_scatter_bag if ctx.bwd == "cuda" else ct_scatter_bag_plain
        d_packed = scatter(ct.contiguous(), idx, bank, slot, off, ctx.my,
                           ctx.n_rows, ctx.dtype)
        return d_packed, None, None, None, None, None, None, None


def banked_embedding_bag(t: BankedTable, idx: torch.Tensor, dist=None, *,
                         reduce_bag: bool = True, backend: str = "auto",
                         bwd_backend: str = "auto", field_offsets=None,
                         bank_live: torch.Tensor | None = None,
                         with_traffic: bool = False) -> torch.Tensor:
    """The paper's stage 2 on one device. idx (..., L) int32, -1 padded ->
    (..., dim) [reduce] or (..., L, dim).

    ``field_offsets`` fuses all F fields of a (B, F, L) multi-hot batch into
    one stage-2 pass: bag (b, f) looks up ``idx + field_offsets[f]``
    (applied in-kernel / in-scan, only to valid entries).

    ``bank_live`` ((n_banks,) bool, optional) is the degraded-serving mask:
    reads homed on a False bank resolve to the zero row.

    ``bwd_backend`` ('auto' | 'torch' | 'cuda') picks the gradient scatter
    of the bag sums; 'auto' follows ``backend``.
    """
    if dist is not None:
        raise NotImplementedError(
            "the multi-GPU bank axis (DistCtx) is not ported yet: ROADMAP "
            "queue 1 #16")
    if with_traffic:
        raise NotImplementedError(
            "with_traffic (measured per-bank counters) is not ported yet: "
            "ROADMAP queue 1 #14")
    backend = _resolve_backend(backend, t.packed.device)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    if not reduce_bag and field_offsets is not None:
        raise ValueError("field_offsets requires reduce_bag=True — the dense "
                         "gather path expects pre-offset union-vocab rows")
    if not reduce_bag:
        out = lookup_unsharded(t, idx, reduce_bag=False)
        if bank_live is not None:
            safe = torch.where(idx >= 0, idx, 0).long()
            out = torch.where(bank_live[t.remap_bank[safe].long()][..., None],
                              out, 0)
        return out
    off = _offsets(field_offsets, idx.device)
    if bank_live is None:
        bank_map, my = t.remap_bank, -1
    else:
        bank_map, my = _binary_live_map(t.remap_bank, bank_live), 0
    lead, L = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(-1, L).to(torch.int32).contiguous()
    out = _BankedBag.apply(t.packed, bank_map, t.remap_flat, off, flat, my,
                           backend, bwd)
    return out.reshape(*lead, t.dim)


def banked_gather(t: BankedTable, idx: torch.Tensor, dist=None, *,
                  bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """Dense per-position lookup: (...,) union-vocab rows -> (..., dim)."""
    return banked_embedding_bag(t, idx, dist, reduce_bag=False,
                                bank_live=bank_live)
