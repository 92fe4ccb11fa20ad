"""Bank-partitioned embedding lookup (the paper's runtime).

The port of ``repro/core/embedding.py``. A table is
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

Meta tensors (the dry pass, ``launch/dryrun``) take the kernel's route,
where each wrapper reports its cost instead of launching.

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

``backend='tuned'`` resolves each call through the autotuner's dispatch
cache (``repro_torch.tune``, ``TUNE_dispatch_cuda.json``): a signature of
the call's shapes keys a decision (backend, ``tile_b`` = bags per block,
``n_slots`` = ring stages), the kernel's launch geometry; a miss is
``'auto'`` with the caller's ``tile_b``/``n_slots`` (None: the geometry
rule). On CUDA tensors the kernel runs with the decided geometry, and a
``'torch'`` decision raises; on CPU tensors the plain version runs whatever
the decision says. Every geometry gives the same bits. ``tile_b`` and
``n_slots`` given with ``'cuda'``/``'auto'`` set the geometry directly.

The bank axis across processes (``DistCtx``, the reference's
``shard_map`` over its mesh's ``model`` axis) is the paper's dataflow
with banks as separate memories:

  stage 1  each rank holds its dp slice of the ids, the same on every
           rank of its bank group (the CPU -> DPU broadcast);
  stage 2  each rank adds the entries its bank owns, from its bank's rows
           only: the same kernels with ``my = bank_rank`` on the rank-local
           shard and the global ``remap_bank`` / ``remap_slot`` (slots are
           local to a bank);
  stage 3  one all-reduce SUM of the partial bag sums over the bank group
           (``_Psum``; its backward hands every bank the replicated
           cotangent, which each scatters into its own shard only).

Under ``dist`` every tensor is rank-local: a banked table holds rows
``[m * rpb, (m + 1) * rpb)`` (``packed`` is ``(rows_per_bank, dim)``), the
ids are the rank's dp slice, and so are the outputs. Every lookup takes
``with_traffic=True`` for its measured per-bank counters (under ``dist``
summed over dp: the global batch's), and ``degraded_mean_fill`` is the
optional mean-row substitute for the reads a dead bank loses.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Any

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
from repro_torch.obs.tracing import stage
from repro_torch.sparse.ops import offsets_to_segment_ids
from repro_torch.tune.dispatch import resolve, signature

BACKENDS = ("auto", "torch", "cuda", "tuned")
_BWD_BACKENDS = ("auto", "torch", "cuda")
# devices on which the kernels' route runs: CUDA launches, meta reports
_KERNEL_DEVICES = ("cuda", "meta")


def _resolve_backend(backend: str, device: torch.device) -> str:
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    if backend == "tuned":
        raise ValueError("backend='tuned' resolves through the dispatch "
                         "cache at the entry points — this path has no "
                         "tuned signature (pass 'auto')")
    if backend == "cuda" and device.type not in _KERNEL_DEVICES:
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    if backend == "auto":
        return "cuda" if device.type in _KERNEL_DEVICES else "torch"
    return backend


def _lookup_backend(backend: str, device: torch.device, tile_b, n_slots,
                    path: str, **shape) -> tuple[str, tuple | None]:
    """(backend, geometry) of one lookup. ``'tuned'``: the dispatch cache's
    decision for the signature of ``path`` and ``shape`` (a string key and
    a dict lookup), the caller's ``tile_b``/``n_slots`` and the ``auto``
    rule on a miss. On CUDA tensors that is ``('cuda', (tile_b,
    n_slots))``, and a ``'torch'`` decision (one measured off the card)
    raises; on CPU tensors ``('torch', None)``, the plain version whatever
    the decision says. Any other backend resolves as ever, with the
    caller's ``(tile_b, n_slots)`` as the kernel's geometry (None: the
    rule's)."""
    if backend != "tuned":
        return _resolve_backend(backend, device), (tile_b, n_slots)
    decided, tile_b, n_slots, _ = resolve(path, device.type, tile_b, n_slots,
                                          **shape)
    if device.type != "cuda":
        return "torch", None
    if decided != "cuda":
        raise ValueError(
            f"backend='tuned': the dispatch cache decides {decided!r} for "
            f"{signature(path, **shape).key()}, a decision measured off the "
            f"card; CUDA tensors run only the kernel (retune on the card: "
            f"python -m repro_torch.launch.tune)")
    return "cuda", (tile_b, n_slots)


def _batch(idx: torch.Tensor) -> int:
    """The signature's ``batch``: the product of the ids' leading dims."""
    return math.prod(idx.shape[:-1])


def _n_fields(field_offsets) -> int:
    return 1 if field_offsets is None else len(field_offsets)


def _resolve_bwd(bwd_backend: str, fwd_backend: str,
                 device: torch.device) -> str:
    """The backward scatter's backend: 'auto' follows the (resolved)
    forward; 'torch' is the plain version anywhere; 'cuda' the kernel.
    'tuned' is refused: the dispatch keys on ``bwd_backend``, it does not
    select one."""
    if bwd_backend not in _BWD_BACKENDS:
        raise ValueError(f"bwd_backend must be one of {_BWD_BACKENDS}, got "
                         f"{bwd_backend!r} (the tuned dispatch keys on "
                         f"bwd_backend; it does not select one)")
    if bwd_backend == "cuda" and device.type not in _KERNEL_DEVICES:
        raise ValueError(f"bwd_backend='cuda' needs CUDA tensors, got "
                         f"{device}")
    return fwd_backend if bwd_backend == "auto" else bwd_backend


def flat_remap(remap_bank: torch.Tensor, remap_slot: torch.Tensor,
               rows_per_bank: int) -> torch.Tensor:
    """row -> position in the unsharded packed array."""
    return (remap_bank * rows_per_bank + remap_slot).to(torch.int32)


# ---------------------------------------------------------------------------
# the bank axis across processes
# ---------------------------------------------------------------------------

_AXES = ("dp", "bank")


@dataclasses.dataclass(frozen=True, eq=False)
class DistCtx:
    """The data x model grid over an initialized ``torch.distributed``
    world (the reference's ``DistCtx`` over ``make_mesh((data, model),
    ("data", "model"))``): rank ``d * model + m`` is data row ``d``, bank
    ``m``, the mesh's row-major order. The bank group holds the ranks of
    one ``d`` (one replica of the table, a bank each), the dp group those
    of one ``m`` (the same bank in every replica). Build it with
    ``create`` after ``init_process_group``; every rank builds it the same
    way, since making a group is itself collective.

    ``batch``: the global batch the context serves (``for_batch``), where
    the reference's ``dp_ok`` rule is applied: a batch that divides by
    ``dp_size()`` is cut over dp, one that does not is held whole by every
    dp rank (``dp_replicated``), so its counts are not summed over dp and
    the tuned dispatch keys on it as it is. On a grid of more than one dp
    rank, every lookup and the train step need it, and refuse a local
    batch that is not the global batch's cut.

    Collectives (``psum``, ``pmax``, ``gather``) take their axes as
    ``"bank"``, ``"dp"`` or both; a failure of one propagates."""

    data: int
    model: int
    rank: int
    device: torch.device
    bank_group: Any
    dp_group: Any
    batch: int | None = None
    whole: bool = False

    @classmethod
    def create(cls, data: int, model: int, *,
               device: str | torch.device | None = None) -> DistCtx:
        """The grid over the current default process group (world size
        ``data * model``). ``device``: None is ``cuda:<local rank %
        device_count>`` (``LOCAL_RANK``, else the rank), ``"cpu"`` the host
        (the tests' gloo ranks)."""
        import torch.distributed as tdist
        if not tdist.is_initialized():
            raise RuntimeError("DistCtx.create: call "
                               "torch.distributed.init_process_group first")
        world, rank = tdist.get_world_size(), tdist.get_rank()
        if data < 1 or model < 1 or world != data * model:
            raise ValueError(f"DistCtx.create: a {data} x {model} grid on "
                             f"a world of {world} ranks")
        bank_groups = [tdist.new_group([d * model + m for m in range(model)])
                       for d in range(data)]
        dp_groups = [tdist.new_group([d * model + m for d in range(data)])
                     for m in range(model)]
        if device is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            dev = resolve_device(
                f"cuda:{local % max(torch.cuda.device_count(), 1)}")
        else:
            dev = resolve_device(device)
        return cls(data=data, model=model, rank=rank, device=dev,
                   bank_group=bank_groups[rank // model],
                   dp_group=dp_groups[rank % model])

    @property
    def n_banks(self) -> int:
        return self.model

    def dp_size(self) -> int:
        return self.data

    @property
    def bank_rank(self) -> int:
        return self.rank % self.model

    @property
    def dp_rank(self) -> int:
        return self.rank // self.model

    def dp_ok(self, batch: int) -> bool:
        """Whether a global batch of ``batch`` cuts over dp (the
        reference's ``dp_ok``)."""
        return batch % self.data == 0

    def for_batch(self, batch: int, whole: bool = False) -> DistCtx:
        """This context for a global batch of ``batch`` rows: the one place
        the ``dp_ok`` rule is decided (``recsys_batch_shardings`` cuts a
        batch by it and returns this context beside the pieces).
        ``whole=True``: every dp rank holds the whole batch, whatever the
        rule would cut (a query, or ids that are the same on every rank)."""
        if int(batch) < 1:
            raise ValueError(f"for_batch: a global batch of {batch}")
        if batch == self.batch and whole == self.whole:
            return self
        return dataclasses.replace(self, batch=int(batch), whole=whole)

    @property
    def dp_replicated(self) -> bool:
        """Every dp rank holds the whole batch (it does not cut over dp);
        with more than one dp rank, only a context with a batch knows."""
        if self.data == 1:
            return False
        if self.batch is None:
            raise ValueError(
                f"DistCtx on {self.data} dp ranks has no global batch: use "
                f"the context recsys_batch_shardings returns, or "
                f"dist.for_batch(B)")
        return self.whole or not self.dp_ok(self.batch)

    def dp_slice(self) -> slice:
        """This rank's rows of the global batch ``batch``."""
        if self.data == 1 or self.dp_replicated:
            return slice(0, self.batch)
        n = self.batch // self.data
        return slice(self.dp_rank * n, (self.dp_rank + 1) * n)

    def global_batch(self, idx: torch.Tensor) -> int:
        """The dispatch signature's batch (``_batch``) of the global batch
        whose rank-local ids are ``idx``: their leading dim must be this
        context's batch cut by the ``dp_ok`` rule."""
        n = _batch(idx)
        if self.data == 1:
            return n
        sl = self.dp_slice()
        if idx.shape[0] != sl.stop - sl.start:
            raise ValueError(
                f"a local batch of {idx.shape[0]} rows under a context for a "
                f"global batch of {self.batch} on {self.data} dp ranks, which "
                f"holds {sl.stop - sl.start} a rank: cut the batch with "
                f"recsys_batch_shardings and use the context it returns")
        return n if self.dp_replicated else n * self.data

    def dp_sum(self, counts: torch.Tensor) -> torch.Tensor:
        """Counts of this rank's dp slice made the global batch's: summed
        over dp, unless every dp rank holds the whole batch."""
        return counts if self.dp_replicated else self.psum(counts, "dp")

    def size(self, axes) -> int:
        """The rank count of ``axes``."""
        return self._group(axes)[1]

    def _group(self, axes) -> tuple[Any, int]:
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if not axes or any(a not in _AXES for a in axes):
            raise ValueError(f"axes must be drawn from {_AXES}, got {axes}")
        if set(axes) == {"bank"}:
            return self.bank_group, self.model
        if set(axes) == {"dp"}:
            return self.dp_group, self.data
        return None, self.data * self.model       # the default (world) group

    def _all_reduce(self, x: torch.Tensor, axes, op) -> torch.Tensor:
        import torch.distributed as tdist
        group, size = self._group(axes)
        y = x.clone().contiguous()
        if size > 1:
            tdist.all_reduce(y, op=op, group=group)
        return y

    def psum(self, x: torch.Tensor, axes="bank") -> torch.Tensor:
        """The SUM of ``x`` over ``axes``, a new tensor."""
        import torch.distributed as tdist
        return self._all_reduce(x, axes, tdist.ReduceOp.SUM)

    def pmax(self, x: torch.Tensor, axes="dp") -> torch.Tensor:
        """The MAX of ``x`` over ``axes``, a new tensor."""
        import torch.distributed as tdist
        return self._all_reduce(x, axes, tdist.ReduceOp.MAX)

    def gather(self, x: torch.Tensor, axes="dp", dim: int = 0
               ) -> torch.Tensor:
        """The ranks' ``x`` (one shape) over ``axes``, concatenated along
        ``dim`` in rank order: over dp the global batch, over bank the
        column slices of ``col_split_embedding_bag``."""
        import torch.distributed as tdist
        group, size = self._group(axes)
        x = x.contiguous()
        if size == 1:
            return x.clone()

        parts = [torch.empty_like(x) for _ in range(size)]
        tdist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)


class _Psum(torch.autograd.Function):
    """Stage 3: the partial bag sums summed over ``axes`` (the bank group;
    for the split CSR stream, dp and bank). Backward: the cotangent
    unchanged, the transpose of the reference's ``psum`` inside
    ``shard_map``: every rank holds the same replicated cotangent, and
    scatters it into its own shard."""

    @staticmethod
    def forward(ctx, part, dist, axes):
        return dist.psum(part, axes)

    @staticmethod
    def backward(ctx, ct):
        return ct, None, None


def _bank_sum(part: torch.Tensor, dist: DistCtx) -> torch.Tensor:
    return _Psum.apply(part, dist, "bank")


def _check_dist(dist) -> None:
    if dist is not None and not isinstance(dist, DistCtx):
        raise TypeError(f"dist must be a DistCtx or None, got "
                        f"{type(dist).__name__}")


def _check_shard(what: str, rows: int, n_banks: int, rows_per_bank: int,
                 dist: DistCtx) -> None:
    """A rank-local table: ``dist.n_banks`` banks, one shard of
    ``rows_per_bank`` rows."""
    if n_banks != dist.n_banks or rows != rows_per_bank:
        raise ValueError(
            f"{what}: a table of {n_banks} banks holding {rows} rows under a "
            f"grid of {dist.n_banks} banks: a rank holds its bank's "
            f"{rows_per_bank} rows (dist.sharding.recsys_param_shardings)")


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
    by ``fwd``; backward (the stage span ``lookup.backward``):
    ``ct_scatter_bag`` or its plain version by ``bwd``, onto the forward's
    own remap, ownership, offsets and replica columns. ``geometry`` is the
    kernel's launch geometry (the plain version has none). Only ``packed``
    gets a gradient."""

    @staticmethod
    def forward(ctx, packed, bank, slot, off, idx, my: int, fwd: str,
                bwd: str, k_max: int = 1, geometry=None):
        ctx.save_for_backward(bank, slot, off, idx)
        ctx.my, ctx.bwd, ctx.k_max = my, bwd, k_max
        ctx.n_rows, ctx.dtype = packed.shape[0], packed.dtype
        if fwd == "cuda":
            return banked_bag(packed, bank, slot, off, my, idx, k_max,
                              geometry)
        return banked_bag_plain(packed, bank, slot, off, my, idx, k_max)

    @staticmethod
    def backward(ctx, ct):
        bank, slot, off, idx = ctx.saved_tensors
        scatter = ct_scatter_bag if ctx.bwd == "cuda" else ct_scatter_bag_plain
        with stage("lookup.backward", like=ct):
            d_packed = scatter(ct.contiguous(), idx, bank, slot, off, ctx.my,
                               ctx.n_rows, ctx.dtype, ctx.k_max)
        return (d_packed,) + (None,) * 9


def _row_nbytes(t: BankedTable) -> int:
    return t.packed.shape[-1] * t.packed.element_size()


def _effective_bank_map(remap_bank: torch.Tensor, bank_live: torch.Tensor,
                        n_banks: int) -> torch.Tensor:
    """The row -> bank map under which DEAD banks own nothing: rows homed
    on a dead bank get bank id ``n_banks``, which no bank rank matches, so
    their contribution to the bank sum is exactly zero (the zero-fill
    degraded substitute), with no kernel change."""
    return torch.where(bank_live[remap_bank.long()], remap_bank,
                       n_banks).to(torch.int32)


def _local_gather_partial(table_local: torch.Tensor, bank: torch.Tensor,
                          slot: torch.Tensor, idx: torch.Tensor,
                          my: int) -> torch.Tensor:
    """Dense (non-reducing) lookup partial of one bank: (...,) union-vocab
    rows -> (..., dim), zero where the row is padding or another bank's."""
    safe = torch.where(idx >= 0, idx, 0).long()
    mine = (idx >= 0) & (bank[safe] == my)
    rows = table_local[torch.where(mine, slot[safe].long(), 0)]
    return torch.where(mine[..., None], rows, 0)


def banked_embedding_bag(t: BankedTable, idx: torch.Tensor, dist=None, *,
                         reduce_bag: bool = True, backend: str = "auto",
                         bwd_backend: str = "auto", field_offsets=None,
                         tile_b: int | None = None,
                         n_slots: int | None = None,
                         bank_live: torch.Tensor | None = None,
                         with_traffic: bool = False) -> torch.Tensor:
    """The paper's stages 1-3. idx (..., L) int32, -1 padded -> (..., dim)
    [reduce] or (..., L, dim).

    ``field_offsets`` fuses all F fields of a (B, F, L) multi-hot batch into
    one stage-2 pass: bag (b, f) looks up ``idx + field_offsets[f]``
    (applied in-kernel / in-scan, only to valid entries).

    ``bank_live`` ((n_banks,) bool, optional) is the degraded-serving mask:
    reads homed on a False bank resolve to the zero row.

    ``bwd_backend`` ('auto' | 'torch' | 'cuda') picks the gradient scatter
    of the bag sums; 'auto' follows ``backend``.

    ``backend='tuned'`` resolves the backend and the kernel's ``tile_b``
    (bags per block) and ``n_slots`` (ring stages) through the dispatch
    cache, path ``plain`` (the module docstring has the device rule); the
    dense gather (``reduce_bag=False``) has no kernel to tune and runs as
    ``'auto'``.

    ``dist`` (a ``DistCtx``): ``t`` is this rank's bank shard and ``idx``
    its dp slice; each rank adds its bank's entries (``my =
    dist.bank_rank``, under ``bank_live`` against the effective map where a
    dead bank owns nothing) and the partials are summed over the bank
    group. The output is the rank's dp slice; the tuned dispatch keys on
    the global batch. A mean fill (``degraded_mean_fill``) goes on the
    summed output, once.

    ``with_traffic=True`` returns ``(out, BankTraffic)``: the batch's exact
    per-bank reads (each valid entry one read on its row's bank, a dead
    bank's reads not counted) and bytes (``reads * row_nbytes``); under
    ``dist`` the global batch's.
    """
    _check_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import (bank_read_counts,
                                             traffic_from_reads)
        out = banked_embedding_bag(
            t, idx, dist, reduce_bag=reduce_bag, backend=backend,
            bwd_backend=bwd_backend, field_offsets=field_offsets,
            tile_b=tile_b, n_slots=n_slots, bank_live=bank_live)
        reads = bank_read_counts(t.remap_bank,
                                 _traffic_rows(idx, field_offsets),
                                 t.n_banks, bank_live=bank_live)
        if dist is not None:
            reads = dist.dp_sum(reads)
        return out, traffic_from_reads(reads, _row_nbytes(t))
    if backend == "tuned" and not reduce_bag:
        backend = "auto"        # dense gather: no kernel to tune
    batch = _batch(idx) if dist is None else dist.global_batch(idx)
    backend, geometry = _lookup_backend(
        backend, t.packed.device, tile_b, n_slots, "plain", vocab=t.vocab,
        dim=t.dim, batch=batch, bag_len=idx.shape[-1],
        n_fields=_n_fields(field_offsets), bwd_backend=bwd_backend)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    if not reduce_bag and field_offsets is not None:
        raise ValueError("field_offsets requires reduce_bag=True — the dense "
                         "gather path expects pre-offset union-vocab rows")
    if dist is not None:
        _check_shard("banked_embedding_bag", t.packed.shape[0], t.n_banks,
                     t.rows_per_bank, dist)
        bank_map = t.remap_bank if bank_live is None \
            else _effective_bank_map(t.remap_bank, bank_live, t.n_banks)
        my, slot = dist.bank_rank, t.remap_slot
    if not reduce_bag:
        if dist is not None:
            return _bank_sum(_local_gather_partial(
                t.packed, bank_map, slot, idx, my), dist)
        out = lookup_unsharded(t, idx, reduce_bag=False)
        if bank_live is not None:
            safe = torch.where(idx >= 0, idx, 0).long()
            out = torch.where(bank_live[t.remap_bank[safe].long()][..., None],
                              out, 0)
        return out
    off = _offsets(field_offsets, idx.device)
    if dist is None:
        slot = t.remap_flat
        if bank_live is None:
            bank_map, my = t.remap_bank, -1
        else:
            bank_map, my = _binary_live_map(t.remap_bank, bank_live), 0
    lead, L = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(-1, L).to(torch.int32).contiguous()
    out = _BankedBag.apply(t.packed, bank_map, slot, off, flat, my,
                           backend, bwd, 1, geometry)
    if dist is not None:
        out = _bank_sum(out, dist)
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
    costs no scatter. ``geometry`` is the kernel's launch geometry."""

    @staticmethod
    def forward(ctx, emt, cache, e_bank, e_slot, c_bank, c_slot, cache_idx,
                resid_idx, my: int, fwd: str, bwd: str, geometry=None):
        ctx.save_for_backward(e_bank, e_slot, c_bank, c_slot, cache_idx,
                              resid_idx)
        ctx.my, ctx.bwd = my, bwd
        ctx.shapes = (emt.shape[0], emt.dtype, cache.shape[0], cache.dtype)
        if fwd == "cuda":
            return cache_residual_bag(emt, cache, e_bank, e_slot, c_bank,
                                      c_slot, my, cache_idx, resid_idx,
                                      geometry)
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
        return (d_emt, d_cache) + (None,) * 10


def banked_cache_residual_bag(t: BankedTable, cache: BankedTable,
                              cache_idx: torch.Tensor,
                              residual_idx: torch.Tensor, dist=None, *,
                              backend: str = "auto",
                              bwd_backend: str = "auto",
                              tile_b: int | None = None,
                              n_slots: int | None = None,
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
    ('auto' follows ``backend``). ``'tuned'``: the dispatch cache, path
    ``fused``, bag length ``"Lc+Lr"``.

    ``bank_live`` ((n_banks,) bool) masks BOTH tables: a dead bank loses
    its EMT rows and its cache entries alike (binary live maps, ``my = 0``).

    ``dist`` (a ``DistCtx``): both tables are this rank's bank shards (the
    cache table banked over the same axis), the ids its dp slice; the
    fused partial takes ONE sum over the bank group.

    ``with_traffic=True`` returns ``(out, BankTraffic)``: a cache hit is one
    read on its entry's bank, a residual row one on its own (both honouring
    ``bank_live``); bytes are ``reads * row_nbytes`` of the EMT; under
    ``dist`` the global batch's.
    """
    _check_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import (cached_bank_read_counts,
                                             traffic_from_reads)
        out = banked_cache_residual_bag(
            t, cache, cache_idx, residual_idx, dist, backend=backend,
            bwd_backend=bwd_backend, tile_b=tile_b, n_slots=n_slots,
            bank_live=bank_live)
        reads = cached_bank_read_counts(cache.remap_bank, cache_idx,
                                        t.remap_bank, residual_idx,
                                        t.n_banks, bank_live=bank_live)
        if dist is not None:
            reads = dist.dp_sum(reads)
        return out, traffic_from_reads(reads, _row_nbytes(t))
    batch = _batch(cache_idx) if dist is None \
        else dist.global_batch(cache_idx)
    backend, geometry = _lookup_backend(
        backend, t.packed.device, tile_b, n_slots, "fused", vocab=t.vocab,
        dim=t.dim, batch=batch,
        bag_len=f"{cache_idx.shape[-1]}+{residual_idx.shape[-1]}",
        bwd_backend=bwd_backend)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    if dist is not None:
        for what, tab in (("EMT", t), ("cache table", cache)):
            _check_shard(f"banked_cache_residual_bag: {what}",
                         tab.packed.shape[0], tab.n_banks, tab.rows_per_bank,
                         dist)
        e_slot, c_slot, my = t.remap_slot, cache.remap_slot, dist.bank_rank
        if bank_live is None:
            e_bank, c_bank = t.remap_bank, cache.remap_bank
        else:
            e_bank = _effective_bank_map(t.remap_bank, bank_live, t.n_banks)
            c_bank = _effective_bank_map(cache.remap_bank, bank_live,
                                         cache.n_banks)
    else:
        e_slot, c_slot = t.remap_flat, cache.remap_flat
        if bank_live is None:
            e_bank, c_bank, my = t.remap_bank, cache.remap_bank, -1
        else:
            e_bank = _binary_live_map(t.remap_bank, bank_live)
            c_bank = _binary_live_map(cache.remap_bank, bank_live)
            my = 0
    lead = cache_idx.shape[:-1]
    ci = cache_idx.reshape(-1, cache_idx.shape[-1]).to(torch.int32)
    ri = residual_idx.reshape(-1, residual_idx.shape[-1]).to(torch.int32)
    out = _CacheResidualBag.apply(t.packed, cache.packed, e_bank, e_slot,
                                  c_bank, c_slot, ci.contiguous(),
                                  ri.contiguous(), my, backend, bwd, geometry)
    if dist is not None:
        out = _bank_sum(out, dist)
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
                             tile_b: int | None = None,
                             n_slots: int | None = None,
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
    single-copy gradient. ``'tuned'``: the dispatch cache, path
    ``replicated``, keyed on ``k_max``.

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
            field_offsets=field_offsets, tile_b=tile_b, n_slots=n_slots,
            bank_live=bank_live)
        reads = replicated_bank_read_counts(
            t.remap_bank, _traffic_rows(idx, field_offsets), t.n_banks,
            k_max=t.k_max, bank_live=bank_live)
        return out, traffic_from_reads(reads, t.dim * t.packed.element_size())
    backend, geometry = _lookup_backend(
        backend, t.packed.device, tile_b, n_slots, "replicated",
        vocab=t.vocab, dim=t.dim, batch=_batch(idx), bag_len=idx.shape[-1],
        n_fields=_n_fields(field_offsets), k_max=t.k_max,
        bwd_backend=bwd_backend)
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
                           backend, bwd, t.k_max, geometry)
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
                         tile_b: int | None = None,
                         n_slots: int | None = None,
                         with_traffic: bool = False):
    """Stage 2 over a TIERED table (``quant.TieredTable``) on one device:
    idx (..., L) int32, -1 padded -> (..., dim) fp32 bag sums, each row
    dequantized by its tier as it is read.

    ``backend``: ``'cuda'`` the tiered kernel, ``'torch'`` its plain version
    (the reference's jnp scan step for step), ``'auto'`` the kernel for CUDA
    tensors and the plain version for CPU tensors; all give the same bits.
    ``'tuned'``: the dispatch cache, path ``tiered``, keyed on the hot
    dtype. The tiered kernel has one geometry (a block a bag), so on CUDA
    tensors ``tile_b`` and ``n_slots`` other than None or 1, given or
    decided, raise.
    ``fp_packed`` is the fp master table the payload was quantized from
    (same packed layout as ``tt``): the forward never reads its values, but
    gradients flow straight through onto it (``bwd_backend`` picks the
    scatter as on the full-precision path). Serving passes the live
    ``params['emb_packed']``. One-hot fields fold in as length-1 bags.

    ``dist`` (a ``DistCtx``): ``fp_packed`` and the payload, scales and
    tiers of ``tt`` are this rank's bank shard, ``idx`` its dp slice; each
    rank dequantizes and adds its bank's entries, and the partials are
    summed over the bank group.

    ``with_traffic=True`` returns ``(out, BankTraffic)``: the batch's
    per-bank reads and bytes, each read weighted by its row's tier width
    (obs/traffic.py); under ``dist`` each bank's counted by its own rank
    (only it holds its tiers) and summed over the grid.
    """
    _check_dist(dist)
    if with_traffic:
        out = tiered_embedding_bag(fp_packed, tt, idx, dist, backend=backend,
                                   bwd_backend=bwd_backend,
                                   field_offsets=field_offsets,
                                   tile_b=tile_b, n_slots=n_slots)
        return out, tiered_traffic(tt, _traffic_rows(idx, field_offsets),
                                   dist)
    batch = _batch(idx) if dist is None else dist.global_batch(idx)
    backend, geometry = _lookup_backend(
        backend, tt.payload.device, tile_b, n_slots, "tiered",
        vocab=tt.remap_bank.shape[0], dim=tt.dim, batch=batch,
        bag_len=idx.shape[-1], n_fields=_n_fields(field_offsets),
        tier_mix=tt.hot_dtype, bwd_backend=bwd_backend)
    if backend == "cuda" and any(g not in (None, 1) for g in geometry):
        raise ValueError(f"tiered_embedding_bag: tile_b, n_slots = "
                         f"{geometry}; the tiered kernel has one geometry, "
                         f"(1, 1)")
    bwd = _resolve_bwd(bwd_backend, backend, tt.payload.device)
    if fp_packed.shape[0] != tt.payload.shape[0]:
        raise ValueError(
            f"fp table rows {fp_packed.shape[0]} != tiered payload rows "
            f"{tt.payload.shape[0]}: the straight-through gradient needs "
            f"the layout the payload was quantized from")
    off = _offsets(field_offsets, idx.device)
    lead, L = idx.shape[:-1], idx.shape[-1]
    flat = idx.reshape(-1, L).to(torch.int32).contiguous()
    if dist is None:
        slot, my = tt.remap_flat, -1
    else:
        _check_shard("tiered_embedding_bag", tt.payload.shape[0], tt.n_banks,
                     tt.rows_per_bank, dist)
        slot, my = tt.remap_slot, dist.bank_rank
    out = _TieredBag.apply(fp_packed, tt.payload, tt.scale, tt.tier,
                           tt.remap_bank, slot, off, flat, my, tt.dim,
                           tt.hot_dtype, backend, bwd)
    if dist is not None:
        out = _bank_sum(out, dist)
    return out.reshape(*lead, tt.dim)


def tiered_traffic(tt, rows: torch.Tensor, dist=None):
    """The tiered lookup's ``BankTraffic`` for union-vocab ``rows`` (-1
    padded): reads per bank, bytes weighted by each row's tier width. Under
    ``dist`` only a bank's rank holds its tiers, so each rank counts its own
    bank's reads (its tier vector indexed by slot: a packed position with
    rows_per_bank 0) and the counts are summed over the bank group and,
    for a batch cut over dp, over dp."""
    from repro_torch.obs.traffic import tiered_bank_traffic
    from repro_torch.quant import tier_nbytes
    lut = tier_nbytes(tt.dim, tt.hot_dtype)
    if dist is None:
        return tiered_bank_traffic(tt.remap_bank, tt.remap_slot,
                                   tt.rows_per_bank, tt.tier, lut, rows,
                                   tt.n_banks)
    safe = torch.where(rows >= 0, rows, 0).long()
    mine = torch.where(tt.remap_bank[safe] == dist.bank_rank, rows, -1)
    traffic = tiered_bank_traffic(tt.remap_bank, tt.remap_slot, 0, tt.tier,
                                  lut, mine, tt.n_banks)
    axes = "bank" if dist.dp_replicated else ("dp", "bank")
    return type(traffic)(*(dist.psum(x, axes) for x in traffic))


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
    order. The sums are in ``out_dtype`` (None: the table's). Only
    ``packed`` gets a gradient: a dense (n_rows, D) tensor in the table's
    dtype, zero where no entry landed."""

    @staticmethod
    def forward(ctx, packed, bank, slot, indices, seg, offs_ext, my: int,
                fwd: str, bwd: str, geometry=None, out_dtype=None):
        ctx.save_for_backward(bank, slot, indices, seg)
        ctx.my, ctx.bwd = my, bwd
        ctx.n_rows, ctx.dtype = packed.shape[0], packed.dtype
        if fwd == "cuda":
            return csr_bag(packed, bank, slot, my, indices, offs_ext,
                           geometry, out_dtype)
        return csr_bag_plain(packed, bank, slot, my, indices, offs_ext,
                             out_dtype)

    @staticmethod
    def backward(ctx, ct):
        bank, slot, indices, seg = ctx.saved_tensors
        scatter = ct_scatter_csr if ctx.bwd == "cuda" else ct_scatter_csr_plain
        d_packed = scatter(ct.contiguous(), indices, seg, bank, slot, ctx.my,
                           ctx.n_rows, ctx.dtype)
        return (d_packed,) + (None,) * 10


def csr_embedding_bag(t: BankedTable, indices: torch.Tensor,
                      offsets: torch.Tensor, num_bags: int, dist=None, *,
                      backend: str = "auto", bwd_backend: str = "auto",
                      tile_b: int | None = None, n_slots: int | None = None,
                      with_traffic: bool = False, out_dtype=None,
                      layout: tuple | None = None):
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
    ``backend``). ``'tuned'``: the dispatch cache, path ``csr``, bag length
    ``"ragged"``.

    ``dist`` (a ``DistCtx``): ``t`` is this rank's bank shard; ragged bags
    do not cut over dp with equal totals, so the stream is the same on
    every rank (``csr_embedding_bag_sharded`` splits it over dp instead);
    each rank adds its bank's entries and the partials are summed over the
    bank group.

    ``out_dtype``: the sums' dtype, None (the table's) or float32 (the
    fp32 sums of a bf16 table, with no cast; the gradient stays in the
    table's dtype). ``layout``: ``csr_layout(offsets, T)``, built once by
    a caller whose bags keep their starts from call to call (None: built
    in this call).

    ``with_traffic=True`` returns ``(out, BankTraffic)``: each valid entry
    one read on its row's bank.
    """
    _check_dist(dist)
    if with_traffic:
        from repro_torch.obs.traffic import bank_read_counts, traffic_from_reads
        out = csr_embedding_bag(t, indices, offsets, num_bags, dist,
                                backend=backend, bwd_backend=bwd_backend,
                                tile_b=tile_b, n_slots=n_slots,
                                out_dtype=out_dtype, layout=layout)
        reads = bank_read_counts(t.remap_bank, indices, t.n_banks)
        return out, traffic_from_reads(reads, _row_nbytes(t))
    backend, geometry = _lookup_backend(
        backend, t.packed.device, tile_b, n_slots, "csr", vocab=t.vocab,
        dim=t.dim, batch=int(num_bags), bag_len="ragged",
        bwd_backend=bwd_backend)
    bwd = _resolve_bwd(bwd_backend, backend, t.packed.device)
    if offsets.shape[0] != num_bags:
        raise ValueError(f"offsets holds {offsets.shape[0]} bag starts for "
                         f"num_bags {num_bags}")
    if dist is None:
        return _csr_stage2(t.packed, t.remap_bank, t.remap_flat, -1, indices,
                           offsets, backend, bwd, geometry, out_dtype, layout)
    _check_shard("csr_embedding_bag", t.packed.shape[0], t.n_banks,
                 t.rows_per_bank, dist)
    return _bank_sum(_csr_stage2(
        t.packed, t.remap_bank, t.remap_slot, dist.bank_rank, indices,
        offsets, backend, bwd, geometry, out_dtype, layout), dist)


def csr_layout(offsets: torch.Tensor, total: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """(seg, offsets_ext) of CSR bags starting at ``offsets`` over a
    stream of ``total`` entries: each entry's bag (the backward's) and the
    starts with the total appended (the kernel's), both int32."""
    seg = offsets_to_segment_ids(offsets, total)
    offs_ext = torch.cat([offsets.to(torch.int32),
                          torch.full((1,), total, dtype=torch.int32,
                                     device=offsets.device)])
    return seg, offs_ext


def _csr_stage2(packed, bank, slot, my: int, indices: torch.Tensor,
                offsets: torch.Tensor, backend: str, bwd: str, geometry,
                out_dtype=None, layout: tuple | None = None):
    """One bank's CSR partial bag sums (``my < 0``: every row)."""
    indices = indices.to(torch.int32).contiguous()
    seg, offs_ext = layout or csr_layout(offsets, indices.shape[0])
    return _CsrBag.apply(packed, bank, slot, indices, seg, offs_ext, my,
                         backend, bwd, geometry, out_dtype)


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


def csr_embedding_bag_sharded(t: BankedTable, indices: np.ndarray,
                              offsets: np.ndarray, num_bags: int, dist=None,
                              *, backend: str = "auto",
                              bwd_backend: str = "auto",
                              tile_b: int | None = None,
                              n_slots: int | None = None) -> torch.Tensor:
    """CSR bag sums with the flat stream SPLIT over dp (where
    ``csr_embedding_bag`` repeats it on every rank): each dp rank takes the
    contiguous bag range ``balanced_csr_shards`` gives it, so the ranks'
    index totals are near-equal, adds its bank's entries of it (bags
    outside the range collapse to empty spans), and the (num_bags, dim)
    partials are summed over dp and bank: every rank gets every bag.

    ``indices`` / ``offsets`` are HOST arrays (the split depends on the
    data, a pre-processing step as ``shard_csr_batch``); ``offsets`` may be
    the bag starts (num_bags) or include the total (num_bags + 1). With no
    ``dist`` or one dp rank it is ``csr_embedding_bag``."""
    _check_dist(dist)
    indices = np.asarray(indices)
    offsets = np.asarray(offsets, np.int64)
    if offsets.shape[0] == num_bags:          # starts only: add the total
        offsets = np.concatenate([offsets, [indices.shape[0]]])
    if offsets.shape[0] != num_bags + 1:
        raise ValueError(f"offsets of {offsets.shape[0]} for num_bags "
                         f"{num_bags}: the starts, or the starts and total")
    dev = t.packed.device
    if dist is None or dist.dp_size() == 1:
        return csr_embedding_bag(
            t, torch.from_numpy(indices.astype(np.int32)).to(dev),
            torch.from_numpy(offsets[:num_bags].astype(np.int32)).to(dev),
            num_bags, dist, backend=backend, bwd_backend=bwd_backend,
            tile_b=tile_b, n_slots=n_slots)
    backend, geometry = _lookup_backend(
        backend, dev, tile_b, n_slots, "csr", vocab=t.vocab, dim=t.dim,
        batch=int(num_bags), bag_len="ragged", bwd_backend=bwd_backend)
    bwd = _resolve_bwd(bwd_backend, backend, dev)
    _check_shard("csr_embedding_bag_sharded", t.packed.shape[0], t.n_banks,
                 t.rows_per_bank, dist)
    sh = shard_csr_batch(indices, offsets, dist.dp_size())
    d = dist.dp_rank
    lo, hi = offsets[sh["bounds"][d]], offsets[sh["bounds"][d + 1]]
    # this shard's offsets into its own stream: bags outside its range
    # collapse to empty [x, x) spans
    offs = np.clip(offsets[:num_bags] - lo, 0, hi - lo).astype(np.int32)
    part = _csr_stage2(t.packed, t.remap_bank, t.remap_slot, dist.bank_rank,
                       torch.from_numpy(sh["idx"][d]).to(dev),
                       torch.from_numpy(offs).to(dev), backend, bwd,
                       geometry)
    return _Psum.apply(part, dist, ("dp", "bank"))


# ---------------------------------------------------------------------------
# column-split table (the paper's N_c axis)
# ---------------------------------------------------------------------------

def col_split_embedding_bag(table: torch.Tensor, idx: torch.Tensor, dist=None,
                            *, reduce_bag: bool = True) -> torch.Tensor:
    """Uniform column split: ``table`` (vocab, dim) unpermuted; under
    ``dist`` this rank's columns ``[m * dim / n_banks, (m + 1) * dim /
    n_banks)`` (bank m) and ``idx`` its dp slice. Every bank gathers ALL of
    a bag's rows for its slice: no ownership mask, no sum over banks; the
    output is the rank's column slice of the bag sums (``reduce_bag``) or
    of the rows, and ``gather_cols`` makes it the full dim (the
    reference's stage 3, an all-gather of dim slices)."""
    _check_dist(dist)
    valid = idx >= 0
    rows = table[torch.where(valid, idx, 0).long()]
    rows = torch.where(valid[..., None], rows, 0)
    return rows.sum(dim=-2) if reduce_bag else rows


def gather_cols(dist: DistCtx, out: torch.Tensor) -> torch.Tensor:
    """The bank group's column slices of ``col_split_embedding_bag``'s
    output, joined into the full dim."""
    return dist.gather(out, "bank", dim=-1)
