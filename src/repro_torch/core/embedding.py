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
equals the reference's ``_scatter_bag_ct`` bit for bit.

``tiered_embedding_bag`` is the same stage 2 over a tiered-precision table
(quant/tiered.py): the tiered kernel dequantizes each row it reads, and the
gradient flows straight through onto the fp master table (``_TieredBag``).

``replicated_embedding_bag`` serves a hot-row REPLICATED table
(``ReplicatedTable``, packed from a ``ReplicatedPlan``): its remaps are
``(vocab, k_max)``, and each bag reads copy ``wang_hash(bag) % k_max`` of
every row it touches, through the same kernel with ``k_max`` folded into
its entry resolution; the backward routes each cotangent to the copy its
bag read, so a row's copies sum to the single-copy gradient. Under
``bank_live`` a dead copy fails over to the row's first live copy
(``_replica_failover_maps``).

``csr_embedding_bag`` is stage 2 over ragged CSR bags (a flat id stream of
super-table rows and its bag starts), through the CSR kernel and, for its
gradient, the sorted-run scatter on a CSR prep (``_CsrBag``, the
reference's ``_pallas_csr_bag``); ``balanced_csr_shards`` and
``shard_csr_batch`` are the host-side split of a CSR batch over shards.

The mesh path (``DistCtx``) and the tuned dispatch are later slices and
raise; every lookup takes ``with_traffic=True`` for its measured per-bank
counters, and ``degraded_mean_fill`` is the optional mean-row substitute
for the reads a dead bank loses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.partitioning import PartitionPlan
from repro_torch.kernels.embedding_bag import (banked_bag, banked_bag_plain,
                                               cache_residual_bag, csr_bag,
                                               csr_bag_plain, ct_scatter_bag,
                                               ct_scatter_bag_plain,
                                               ct_scatter_csr,
                                               ct_scatter_csr_plain,
                                               tiered_bag, tiered_bag_plain)
from repro_torch.sparse.ops import offsets_to_segment_ids

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


@dataclasses.dataclass
class ReplicatedTable:
    """Packed rows + replica-axis remap (a ``ReplicatedPlan`` applied).
    ``remap_bank``/``remap_slot`` are ``(vocab, k_max)`` with cyclic-padded
    columns, so any column of row v is a valid copy; the lookup picks column
    ``wang_hash(bag) % k_max`` per bag. ``remap_flat`` (the flattened
    ``(vocab * k_max,)`` positions in the packed array) and ``bank_flat``
    are computed once where the maps are set and carried to every lookup.
    A plan with no replicated rows has the ``BankedTable`` layout."""

    packed: torch.Tensor       # (n_banks * rows_per_bank, dim)
    remap_bank: torch.Tensor   # (vocab, k_max) int32
    remap_slot: torch.Tensor   # (vocab, k_max) int32
    n_banks: int
    rows_per_bank: int
    k_max: int = 1
    remap_flat: torch.Tensor | None = None   # (vocab * k_max,) int32
    bank_flat: torch.Tensor | None = None    # (vocab * k_max,) int32

    def __post_init__(self):
        if self.remap_flat is None:
            self.remap_flat = self.flat_remap()
        if self.bank_flat is None:
            self.bank_flat = self.remap_bank.reshape(-1)

    @property
    def vocab(self) -> int:
        return self.remap_bank.shape[0]

    @property
    def dim(self) -> int:
        return self.packed.shape[-1]

    def flat_remap(self) -> torch.Tensor:
        """(vocab * k_max,) copy -> position in the packed array, computed
        anew (kernel-stream order ``row * k_max + r``)."""
        return flat_remap(self.remap_bank, self.remap_slot,
                          self.rows_per_bank).reshape(-1)


def pack_replicated(table: np.ndarray, rplan, *,
                    rows_per_bank: int | None = None, dtype=None,
                    device: str | torch.device | None = "cuda"
                    ) -> ReplicatedTable:
    """Write row v to all ``copies[v]`` of its (bank, slot) homes, on the
    host, then move the table to ``device``. ``dtype`` is a torch dtype for
    the packed rows (default: the table's)."""
    dev = resolve_device(device)
    vocab, dim = table.shape
    if rows_per_bank is None:
        rows_per_bank = int(rplan.max_rows_per_bank)
    packed = np.zeros((rplan.n_banks * rows_per_bank, dim), dtype=table.dtype)
    vv, rr = np.nonzero(np.arange(rplan.k_max)[None, :]
                        < rplan.copies[:, None])
    pos = (rplan.bank_of_copy[vv, rr].astype(np.int64) * rows_per_bank
           + rplan.slot_of_copy[vv, rr])
    packed[pos] = table[vv]
    packed_t = torch.from_numpy(packed).to(dev)
    if dtype is not None:
        packed_t = packed_t.to(dtype)
    return ReplicatedTable(
        packed=packed_t,
        remap_bank=torch.from_numpy(
            rplan.bank_of_copy.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(
            rplan.slot_of_copy.astype(np.int32)).to(dev),
        n_banks=rplan.n_banks, rows_per_bank=rows_per_bank,
        k_max=rplan.k_max)


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


def degraded_row_counts(remap_bank: torch.Tensor, bank_live: torch.Tensor,
                        rows: torch.Tensor, *,
                        per_bag: bool = False) -> torch.Tensor:
    """Count of reads that resolved to a dead bank.

    ``rows``: union-vocab row ids of any shape ``(B, ...)`` (negatives =
    padding). Returns ``(B,)`` int32 by default — a request with count 0 is
    exact, a request with count k misses exactly k row contributions.
    ``per_bag=True`` sums only the trailing (bag) axis: shape
    ``rows.shape[:-1]``.

    ``remap_bank`` may also be a replicated ``(vocab, k_max)`` map: a read
    then counts as degraded only when EVERY copy of its row is dead — any
    surviving copy serves it (``_replica_failover_maps``).
    """
    valid = rows >= 0
    safe = torch.where(valid, rows, 0).long()
    live = bank_live[remap_bank[safe].long()]
    if remap_bank.dim() == 2:
        live = live.any(dim=-1)
    dead = valid & ~live
    if per_bag:
        return dead.sum(dim=-1).to(torch.int32)
    return dead.reshape(rows.shape[0], -1).sum(dim=-1).to(torch.int32)


def degraded_mean_fill(emb: torch.Tensor, per_bag_counts: torch.Tensor,
                       fallback_row: torch.Tensor) -> torch.Tensor:
    """Optional mean-fill substitute: add ``fallback_row`` (e.g. the table's
    mean row) once per dead read instead of the implicit zero row.
    ``per_bag_counts`` has ``emb``'s leading shape (``degraded_row_counts``
    with ``per_bag=True``). Applied to the combined bag sums, outside any
    collective: inside a bank-sharded reduction every bank would add it and
    the sum would count it n_banks times."""
    return emb + per_bag_counts[..., None].to(emb.dtype) * fallback_row


class _BankedBag(torch.autograd.Function):
    """Bag sums differentiable in ``packed`` (the reference's
    ``_pallas_bag``, and with ``k_max > 1`` its ``_replicated_bag``, each
    with its ``custom_vjp``). Forward: ``banked_bag`` or its plain version
    by ``fwd``; backward: ``ct_scatter_bag`` or its plain version by
    ``bwd``, onto the forward's own remap, ownership, offsets and replica
    columns. Only ``packed`` gets a gradient."""

    @staticmethod
    def forward(ctx, packed, bank, slot, off, idx, my: int, fwd: str,
                bwd: str, k_max: int = 1):
        ctx.save_for_backward(bank, slot, off, idx)
        ctx.my, ctx.bwd, ctx.k_max = my, bwd, k_max
        ctx.n_rows, ctx.dtype = packed.shape[0], packed.dtype
        bag = banked_bag if fwd == "cuda" else banked_bag_plain
        return bag(packed, bank, slot, off, my, idx, k_max)

    @staticmethod
    def backward(ctx, ct):
        bank, slot, off, idx = ctx.saved_tensors
        scatter = ct_scatter_bag if ctx.bwd == "cuda" else ct_scatter_bag_plain
        d_packed = scatter(ct.contiguous(), idx, bank, slot, off, ctx.my,
                           ctx.n_rows, ctx.dtype, ctx.k_max)
        return (d_packed,) + (None,) * 8


def _no_dist(dist) -> None:
    if dist is not None:
        raise NotImplementedError(
            "the multi-GPU bank axis (DistCtx) is not ported yet: ROADMAP "
            "queue 1 #16")


def _row_nbytes(t: BankedTable) -> int:
    return t.packed.shape[-1] * t.packed.element_size()


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

    ``with_traffic=True`` returns ``(out, BankTraffic)``: the batch's exact
    per-bank reads (each valid entry one read on its row's bank, a dead
    bank's reads not counted) and bytes (``reads * row_nbytes``).
    """
    _no_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import (bank_read_counts,
                                             traffic_from_reads)
        out = banked_embedding_bag(
            t, idx, reduce_bag=reduce_bag, backend=backend,
            bwd_backend=bwd_backend, field_offsets=field_offsets,
            bank_live=bank_live)
        reads = bank_read_counts(t.remap_bank,
                                 _traffic_rows(idx, field_offsets),
                                 t.n_banks, bank_live=bank_live)
        return out, traffic_from_reads(reads, _row_nbytes(t))
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


class _CacheResidualBag(torch.autograd.Function):
    """Fused cache + residual bag sums, differentiable in both tables (the
    reference's ``_pallas_cache_bag`` with its ``custom_vjp``). Forward by
    ``fwd``: ``'cuda'`` the fused kernel (``cache_residual_bag``), ``'torch'``
    the reference's jnp order (each stream through ``_bag_partial_scan``,
    the cache's sums cast to the EMT's dtype and added). Backward by
    ``bwd``: the dual scatter — the same cotangent onto the EMT through the
    residual ids and onto the cache table through the cache ids, each with
    its own remap, zero offsets and the forward's ``my`` — through
    ``ct_scatter_bag`` or its plain version; a table that needs no gradient
    costs no scatter."""

    @staticmethod
    def forward(ctx, emt, cache, e_bank, e_slot, c_bank, c_slot, cache_idx,
                resid_idx, my: int, fwd: str, bwd: str):
        ctx.save_for_backward(e_bank, e_slot, c_bank, c_slot, cache_idx,
                              resid_idx)
        ctx.my, ctx.bwd = my, bwd
        ctx.shapes = (emt.shape[0], emt.dtype, cache.shape[0], cache.dtype)
        if fwd == "cuda":
            return cache_residual_bag(emt, cache, e_bank, e_slot, c_bank,
                                      c_slot, my, cache_idx, resid_idx)
        zero = torch.zeros((1,), dtype=torch.int32, device=emt.device)
        part = banked_bag_plain(emt, e_bank, e_slot, zero, my, resid_idx)
        return part + banked_bag_plain(cache, c_bank, c_slot, zero, my,
                                       cache_idx).to(part.dtype)

    @staticmethod
    def backward(ctx, ct):
        e_bank, e_slot, c_bank, c_slot, cache_idx, resid_idx = \
            ctx.saved_tensors
        n_emt, emt_dtype, n_cache, cache_dtype = ctx.shapes
        scatter = ct_scatter_bag if ctx.bwd == "cuda" else ct_scatter_bag_plain
        ct = ct.contiguous()
        zero = torch.zeros((1,), dtype=torch.int32, device=ct.device)
        d_emt = d_cache = None
        if ctx.needs_input_grad[0]:
            d_emt = scatter(ct, resid_idx, e_bank, e_slot, zero, ctx.my,
                            n_emt, emt_dtype)
        if ctx.needs_input_grad[1]:
            d_cache = scatter(ct, cache_idx, c_bank, c_slot, zero, ctx.my,
                              n_cache, cache_dtype)
        return (d_emt, d_cache) + (None,) * 9


def banked_cache_residual_bag(t: BankedTable, cache: BankedTable,
                              cache_idx: torch.Tensor,
                              residual_idx: torch.Tensor, dist=None, *,
                              backend: str = "auto",
                              bwd_backend: str = "auto",
                              bank_live: torch.Tensor | None = None,
                              with_traffic: bool = False) -> torch.Tensor:
    """Cache-aware fused lookup (paper Fig. 7): Σ cache partials + Σ
    residual rows per bag, in one pass.

    cache_idx (..., Lc) ids into the partial-sum cache table ``cache``;
    residual_idx (..., Lr) union-vocab rows into the EMT ``t``; both -1
    padded -> (..., dim) in the EMT's dtype.

    ``backend``: ``'cuda'`` the fused kernel, whose fp32 order is one
    accumulator over the cache stream and then the residual stream;
    ``'torch'`` the plain scans in the reference's jnp order (the streams
    summed apart, the cache's cast to the EMT's dtype and added), equal to
    the reference's ``backend='jnp'`` bit for bit; ``'auto'`` the kernel for
    CUDA tensors and the plain scans for CPU tensors, so card and CPU differ
    by an fp32 reordering. ``bwd_backend`` picks the dual gradient scatter
    ('auto' follows ``backend``).

    ``bank_live`` ((n_banks,) bool) masks BOTH tables: a dead bank loses
    its EMT rows and its cache entries alike (binary live maps, ``my = 0``).

    ``with_traffic=True`` returns ``(out, BankTraffic)``: a cache hit is one
    read on its entry's bank, a residual row one on its own (both honouring
    ``bank_live``); bytes are ``reads * row_nbytes`` of the EMT.
    """
    _no_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import (cached_bank_read_counts,
                                             traffic_from_reads)
        out = banked_cache_residual_bag(
            t, cache, cache_idx, residual_idx, backend=backend,
            bwd_backend=bwd_backend, bank_live=bank_live)
        reads = cached_bank_read_counts(cache.remap_bank, cache_idx,
                                        t.remap_bank, residual_idx,
                                        t.n_banks, bank_live=bank_live)
        return out, traffic_from_reads(reads, _row_nbytes(t))
    backend = _resolve_backend(backend, t.packed.device)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    if bank_live is None:
        e_bank, c_bank, my = t.remap_bank, cache.remap_bank, -1
    else:
        e_bank = _binary_live_map(t.remap_bank, bank_live)
        c_bank = _binary_live_map(cache.remap_bank, bank_live)
        my = 0
    lead = cache_idx.shape[:-1]
    ci = cache_idx.reshape(-1, cache_idx.shape[-1]).to(torch.int32)
    ri = residual_idx.reshape(-1, residual_idx.shape[-1]).to(torch.int32)
    out = _CacheResidualBag.apply(t.packed, cache.packed, e_bank,
                                  t.remap_flat, c_bank, cache.remap_flat,
                                  ci.contiguous(), ri.contiguous(), my,
                                  backend, bwd)
    return out.reshape(*lead, t.dim)


def banked_gather(t: BankedTable, idx: torch.Tensor, dist=None, *,
                  bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """Dense per-position lookup: (...,) union-vocab rows -> (..., dim)."""
    return banked_embedding_bag(t, idx, dist, reduce_bag=False,
                                bank_live=bank_live)


# ---------------------------------------------------------------------------
# replicated stage 2: a hash-picked copy per bag, the k-way gradient scatter
# ---------------------------------------------------------------------------

def _replica_failover_maps(t: ReplicatedTable, bank_live: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """(bank_flat, slot_flat) with dead copies rerouted to a live sibling.

    For every (row, column) whose bank is dead, substitute the row's FIRST
    live column, so a surviving copy serves a dead bank's reads at once.
    Rows with NO live copy keep a binary dead marker (1 against ``my = 0``)
    and resolve to the zero row, like the single-copy ``_binary_live_map``.
    Computed anew on every call from the argument ``bank_live``, as the
    reference does: a pass over the whole ``(vocab, k_max)`` map."""
    live_rc = bank_live[t.remap_bank.long()]                  # (V, k) bool
    any_live = live_rc.any(dim=1)
    first_live = torch.argmax(live_rc.to(torch.uint8), dim=1)  # first max
    col = torch.arange(t.k_max, device=live_rc.device)[None, :]
    eff = torch.where(live_rc, col, first_live[:, None])
    eff_bank = t.remap_bank.gather(1, eff)
    eff_slot = t.remap_slot.gather(1, eff)
    bank_flat = torch.where(any_live, 0, 1).to(torch.int32)[:, None] \
        .expand(-1, t.k_max)
    slot_flat = flat_remap(eff_bank, eff_slot, t.rows_per_bank)
    return bank_flat.reshape(-1), slot_flat.reshape(-1)


def replicated_embedding_bag(t: ReplicatedTable, idx: torch.Tensor,
                             dist=None, *, backend: str = "auto",
                             bwd_backend: str = "auto", field_offsets=None,
                             bank_live: torch.Tensor | None = None,
                             with_traffic: bool = False):
    """Stage 2 over a REPLICATED table on one device: idx (..., L) int32,
    -1 padded -> (..., dim) bag sums, each bag reading copy
    ``wang_hash(bag) % k_max`` of every row it touches (bag = its index in
    the flattened (N, L) stream). A copy holds its row's values, so the
    sums equal the single-copy lookup's bit for bit.

    ``backend`` / ``bwd_backend`` as in ``banked_embedding_bag``: the bag
    kernel (its replica select) or its plain version (the reference's
    ``_replicated_bag_scan`` step for step); the backward scatters each
    bag's cotangent onto the copy it read, so a row's copies sum to the
    single-copy gradient.

    ``bank_live`` ((n_banks,) bool): a dead copy's reads fail over to the
    row's first live copy; only rows with NO live copy read the zero row
    (count them with ``degraded_row_counts`` on ``t.remap_bank``).

    ``with_traffic=True`` returns ``(out, BankTraffic)``: the reads routed
    to the copy each bag reads (and, under ``bank_live``, its failover).
    """
    if dist is not None:
        raise ValueError("replicated_embedding_bag is unsharded-only for "
                         "now — see the multi-host serving mesh item in "
                         "ROADMAP.md")
    if with_traffic:
        from repro_torch.obs.traffic import (replicated_bank_read_counts,
                                             traffic_from_reads)
        out = replicated_embedding_bag(
            t, idx, backend=backend, bwd_backend=bwd_backend,
            field_offsets=field_offsets, bank_live=bank_live)
        reads = replicated_bank_read_counts(
            t.remap_bank, _traffic_rows(idx, field_offsets), t.n_banks,
            k_max=t.k_max, bank_live=bank_live)
        return out, traffic_from_reads(reads, t.dim * t.packed.element_size())
    backend = _resolve_backend(backend, t.packed.device)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    off = _offsets(field_offsets, idx.device)
    if bank_live is None:
        bank_flat, slot_flat, my = t.bank_flat, t.remap_flat, -1
    else:
        bank_flat, slot_flat = _replica_failover_maps(t, bank_live)
        my = 0
    lead, L = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(-1, L).to(torch.int32).contiguous()
    out = _BankedBag.apply(t.packed, bank_flat, slot_flat, off, flat, my,
                           backend, bwd, t.k_max)
    return out.reshape(*lead, t.dim)


# ---------------------------------------------------------------------------
# tiered stage 2: dequantizing forward, straight-through backward
# ---------------------------------------------------------------------------

class _TieredBag(torch.autograd.Function):
    """Tiered bag sums (fp32), differentiable in the fp master table (the
    reference's ``_tiered_bag`` ``custom_vjp``). The forward reads ONLY the
    quantized payload (``tiered_bag`` or its plain version by ``fwd``);
    ``fp_packed`` — the table the payload was quantized from — is the
    straight-through gradient carrier: the backward scatters the bag
    cotangents onto it exactly like the full-precision lookup's backward
    (``ct_scatter_bag`` or its plain version by ``bwd``), quantized rows
    included."""

    @staticmethod
    def forward(ctx, fp_packed, payload, scale, tier, bank, slot, off, idx,
                my: int, dim: int, hot_dtype: str, fwd: str, bwd: str):
        ctx.save_for_backward(bank, slot, off, idx)
        ctx.my, ctx.bwd = my, bwd
        ctx.n_rows, ctx.dtype = fp_packed.shape[0], fp_packed.dtype
        bag = tiered_bag if fwd == "cuda" else tiered_bag_plain
        return bag(payload, scale, tier, bank, slot, off, my, idx, dim=dim,
                   hot_dtype=hot_dtype)

    @staticmethod
    def backward(ctx, ct):
        bank, slot, off, idx = ctx.saved_tensors
        scatter = ct_scatter_bag if ctx.bwd == "cuda" else ct_scatter_bag_plain
        d_fp = scatter(ct.contiguous(), idx, bank, slot, off, ctx.my,
                       ctx.n_rows, ctx.dtype)
        return (d_fp,) + (None,) * 12


def tiered_embedding_bag(fp_packed: torch.Tensor, tt, idx: torch.Tensor,
                         dist=None, *, backend: str = "auto",
                         bwd_backend: str = "auto", field_offsets=None,
                         with_traffic: bool = False):
    """Stage 2 over a TIERED table (``quant.TieredTable``) on one device:
    idx (..., L) int32, -1 padded -> (..., dim) fp32 bag sums, each row
    dequantized by its tier as it is read.

    ``backend``: ``'cuda'`` the tiered kernel, ``'torch'`` its plain version
    (the reference's jnp scan step for step), ``'auto'`` the kernel for CUDA
    tensors and the plain version for CPU tensors; all give the same bits.
    ``fp_packed`` is the fp master table the payload was quantized from
    (same packed layout as ``tt``): the forward never reads its values, but
    gradients flow straight through onto it (``bwd_backend`` picks the
    scatter as on the full-precision path). Serving passes the live
    ``params['emb_packed']``. One-hot fields fold in as length-1 bags.

    ``with_traffic=True`` returns ``(out, BankTraffic)``: the batch's
    per-bank reads and bytes, each read weighted by its row's tier width
    (obs/traffic.py).
    """
    _no_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import tiered_bank_traffic
        from repro_torch.quant import tier_nbytes
        out = tiered_embedding_bag(fp_packed, tt, idx, backend=backend,
                                   bwd_backend=bwd_backend,
                                   field_offsets=field_offsets)
        return out, tiered_bank_traffic(
            tt.remap_bank, tt.remap_slot, tt.rows_per_bank, tt.tier,
            tier_nbytes(tt.dim, tt.hot_dtype),
            _traffic_rows(idx, field_offsets), tt.n_banks)
    backend = _resolve_backend(backend, tt.payload.device)
    bwd = _resolve_bwd(bwd_backend, backend, tt.payload.device)
    if fp_packed.shape[0] != tt.payload.shape[0]:
        raise ValueError(
            f"fp table rows {fp_packed.shape[0]} != tiered payload rows "
            f"{tt.payload.shape[0]}: the straight-through gradient needs "
            f"the layout the payload was quantized from")
    off = _offsets(field_offsets, idx.device)
    lead, L = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(-1, L).to(torch.int32).contiguous()
    out = _TieredBag.apply(fp_packed, tt.payload, tt.scale, tt.tier,
                           tt.remap_bank, tt.remap_flat, off, flat, -1,
                           tt.dim, tt.hot_dtype, backend, bwd)
    return out.reshape(*lead, tt.dim)


def _traffic_rows(idx: torch.Tensor, field_offsets) -> torch.Tensor:
    """The union-vocab row ids a batch actually reads: ``field_offsets``
    applied per flattened bag (bag n -> field n % F, the lookup's rule),
    padding kept as -1. This is what the ``with_traffic`` counters count."""
    if field_offsets is None:
        return idx
    off = _offsets(field_offsets, idx.device).long()
    flat = idx.reshape(-1, idx.shape[-1]).long()
    offs = off[torch.arange(flat.shape[0], device=idx.device) % off.shape[0]]
    return torch.where(flat >= 0, flat + offs[:, None], -1)


# ---------------------------------------------------------------------------
# CSR-ragged stage 2
# ---------------------------------------------------------------------------

class _CsrBag(torch.autograd.Function):
    """CSR bag sums differentiable in ``packed`` (the reference's
    ``_pallas_csr_bag`` with its ``custom_vjp``). Forward: ``csr_bag`` or
    its plain version by ``fwd``; backward: the sorted-run scatter on the
    CSR prep (``ct_scatter_csr`` or its plain version by ``bwd``), each
    stream entry's cotangent ``ct[seg[e]]`` onto ``slot[raw]`` in stream
    order. Only ``packed`` gets a gradient: a dense (n_rows, D) tensor in
    the table's dtype, zero where no entry landed."""

    @staticmethod
    def forward(ctx, packed, bank, slot, indices, seg, offs_ext, my: int,
                fwd: str, bwd: str):
        ctx.save_for_backward(bank, slot, indices, seg)
        ctx.my, ctx.bwd = my, bwd
        ctx.n_rows, ctx.dtype = packed.shape[0], packed.dtype
        bag = csr_bag if fwd == "cuda" else csr_bag_plain
        return bag(packed, bank, slot, my, indices, offs_ext)

    @staticmethod
    def backward(ctx, ct):
        bank, slot, indices, seg = ctx.saved_tensors
        scatter = ct_scatter_csr if ctx.bwd == "cuda" else ct_scatter_csr_plain
        d_packed = scatter(ct.contiguous(), indices, seg, bank, slot, ctx.my,
                           ctx.n_rows, ctx.dtype)
        return (d_packed,) + (None,) * 8


def csr_embedding_bag(t: BankedTable, indices: torch.Tensor,
                      offsets: torch.Tensor, num_bags: int, dist=None, *,
                      backend: str = "auto", bwd_backend: str = "auto",
                      with_traffic: bool = False):
    """Stage 2 over CSR-ragged bags on one device: ``indices`` (T,) int32
    super-table rows (no field offsets), -1 for a hole; ``offsets``
    (num_bags,) the bag starts (bag i = ``indices[offsets[i]:offsets[i+1]]``,
    the last bag to T) -> (num_bags, dim) bag sums, without padding the bags
    to a rectangle. The reference calls it the paper-faithful serving path
    at modest batch.

    ``backend``: ``'cuda'`` the CSR kernel, ``'torch'`` its plain version
    (stream order per bag, fp32, cast once: the reference's Pallas kernel's
    order, not its jnp ``segment_sum``), ``'auto'`` the kernel for CUDA
    tensors and the plain version for CPU tensors; all give the same bits.
    ``bwd_backend`` picks the gradient scatter ('auto' follows
    ``backend``).

    ``with_traffic=True`` returns ``(out, BankTraffic)``: each valid entry
    one read on its row's bank.
    """
    _no_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import bank_read_counts, traffic_from_reads
        out = csr_embedding_bag(t, indices, offsets, num_bags,
                                backend=backend, bwd_backend=bwd_backend)
        reads = bank_read_counts(t.remap_bank, indices, t.n_banks)
        return out, traffic_from_reads(reads, t.dim * t.packed.element_size())
    backend = _resolve_backend(backend, t.packed.device)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    if offsets.shape[0] != num_bags:
        raise ValueError(f"offsets holds {offsets.shape[0]} bag starts for "
                         f"num_bags {num_bags}")
    indices = indices.to(torch.int32).contiguous()
    total = indices.shape[0]
    seg = offsets_to_segment_ids(offsets, total)
    offs_ext = torch.cat([offsets.to(torch.int32),
                          torch.full((1,), total, dtype=torch.int32,
                                     device=offsets.device)])
    return _CsrBag.apply(t.packed, t.remap_bank, t.remap_flat, indices, seg,
                         offs_ext, -1, backend, bwd)


def balanced_csr_shards(offsets: np.ndarray, n_shards: int) -> np.ndarray:
    """(n_shards + 1,) bag-aligned cut points with near-equal per-shard
    INDEX totals (not bag counts: ragged bags make those very different).
    ``offsets`` (num_bags + 1,) includes the total.

    Cut k lands on the bag boundary closest to total * k / n_shards; with
    any bag smaller than total / n_shards the per-shard imbalance is at most
    one bag's length.
    """
    offsets = np.asarray(offsets, np.int64)
    num_bags = offsets.shape[0] - 1
    total = int(offsets[-1])
    targets = total * np.arange(1, n_shards) / n_shards
    cuts = np.searchsorted(offsets, targets, side="left")
    # snap to the nearer of the two surrounding boundaries
    left = np.clip(cuts - 1, 0, num_bags)
    cuts = np.where(targets - offsets[left] < offsets[np.clip(cuts, 0,
                                                              num_bags)]
                    - targets, left, cuts)
    cuts = np.clip(cuts, 0, num_bags)
    bounds = np.concatenate([[0], np.maximum.accumulate(cuts), [num_bags]])
    return bounds.astype(np.int64)


def shard_csr_batch(indices: np.ndarray, offsets: np.ndarray,
                    n_shards: int) -> dict:
    """Host-side split of a CSR batch (``offsets`` with the total) into
    ``n_shards`` equal-total slices, padded to one shape:

      idx (S, cap)   flat row ids, -1 padded
      seg (S, cap)   GLOBAL bag id per entry (num_bags on padding)
      bounds (S+1,)  the bag cut points
    """
    indices = np.asarray(indices)
    offsets = np.asarray(offsets, np.int64)
    num_bags = offsets.shape[0] - 1
    seg = np.repeat(np.arange(num_bags), np.diff(offsets))
    bounds = balanced_csr_shards(offsets, n_shards)
    caps = offsets[bounds[1:]] - offsets[bounds[:-1]]
    cap = max(int(caps.max()), 1)
    idx_s = np.full((n_shards, cap), -1, dtype=np.int32)
    seg_s = np.full((n_shards, cap), num_bags, dtype=np.int32)
    for s in range(n_shards):
        lo, hi = int(offsets[bounds[s]]), int(offsets[bounds[s + 1]])
        idx_s[s, :hi - lo] = indices[lo:hi]
        seg_s[s, :hi - lo] = seg[lo:hi]
    return {"idx": idx_s, "seg": seg_s, "bounds": bounds}
