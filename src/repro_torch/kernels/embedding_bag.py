"""Banked embedding-bag sums, the fused cache + residual bag sums, the
tiered-precision bag sums, the ragged CSR bag sums, their identity-layout
drop-ins, and the bag sums' transpose: the CUDA kernels' wrappers and their
plain versions (the port of ``repro/kernels/embedding_bag.py``'s
``banked_embedding_bag_pallas`` / ``_banked_bag_kernel``,
``embedding_bag_pallas`` / ``_plain_bag_kernel``,
``fused_cache_bag_pallas`` / ``_fused_cache_bag_kernel``,
``plain_cache_bag_pallas`` / ``_plain_fused_kernel``,
``tiered_embedding_bag_pallas`` / ``_tiered_bag_kernel``,
``csr_bag_pallas`` / ``_csr_bag_kernel``, and ``ct_scatter_bag_pallas`` /
``ct_scatter_csr_pallas`` / ``_ct_scatter_kernel``).

Forward. For every bag b of an (NB, L) stream of per-field ids padded with
-1, entry j contributes ``table[slot[row]]`` with ``row = raw + off[b % F]``
when ``raw >= 0`` and (``my < 0`` or ``bank[row] == my``). The sum is fp32
in entry order and is cast to the table's dtype once, so the kernel
(``csrc/banked_bag.cu``) and the plain version agree bit for bit.

Fused cache + residual (Fig. 7). A rewritten bag is two -1 padded streams,
cache entry ids into the partial-sum cache table and residual rows into the
EMT, each with its own bank/slot remaps and no field offsets. One fp32
accumulator walks bag b's cache entries, then its residual entries, and is
cast to the EMT's dtype once (``csrc/cache_bag.cu`` and
``cache_residual_bag_plain``, bit for bit).

Identity layout (``plain_bag`` and ``plain_cache_bag``, the identity
instances of ``csrc/banked_bag.cu`` and ``csrc/cache_bag.cu``). The ids are
the table's rows: an entry counts iff it is ``>= 0``, with no remap, no
ownership test and no field offset; the sums' order is the banked kernels'.

CSR (``csrc/csr_bag.cu`` and ``csr_bag_plain``). Ragged bags are one flat
id stream of super-table rows with ``offsets_ext`` (NB + 1,): bag b sums
entries ``[offs[b], offs[b+1])`` in stream order, each counting iff ``raw
>= 0`` and (``my < 0`` or ``bank[raw] == my``) and reading
``table[slot[raw]]``; fp32, cast once to the table's dtype or, with
``out_dtype=torch.float32``, not cast at all (fp32 sums of a bf16 table);
an empty bag is zeros.

Tiered (``csrc/tiered_bag.cu`` and ``tiered_bag_plain``). The table is the
quant package's ``(R, row_bytes)`` int8 payload with per-row fp32 scales and
tier codes; each live entry's row is dequantized to fp32 by its tier (an
exact bitcast of the hot tier's bf16/fp32 bits, ``float(q) * scale`` for
int8 and packed int4) and added in entry order; the output is fp32. Each
quantized value is one rounded multiply followed by one rounded add, on
both paths, so they agree bit for bit, and with the reference's jnp scan.

Backward. The same entries, enumerated j-major (``e = j * NB + bag``), each
drag cotangent row ``ct[bag]`` onto table slot ``slot[row]`` (the CSR prep
takes the stream's order and each entry's bag; the identity prep the
bag-major order ``e = bag * L + j`` of the reference's ``.at[].add``). A
stable sort by slot groups them into per-slot runs that keep entry order
(``scatter_run_metadata``); each run is summed in fp32 and written once,
cast to the table's dtype, over a zero table. Every other row is exactly
zero. The kernel (``csrc/ct_scatter.cu``) and the plain version add in the
same order and agree bit for bit; neither uses atomics. On the card the
prep is ``csrc/scatter_prep.cu`` (``scatter_labels``, one key-value radix
sort and a run table in ``scatter_runs``), which gives the op-by-op prep's
runs bit for bit; CPU and meta tensors run the prep op by op.

The cotangent and the gradient table each have their own dtype; ``ct`` is
summed in fp32 as it is and cast once.

Meta tensors. Every wrapper returns an output of the right shape and
dtype on ``meta`` tensors and reports its kernel's bytes and operations
(``kernels/cost.py``, PERF.md §6's bound column) to the cost counters in
force (``launch/roofline.charge``): nothing runs and nothing is computed.
The backward's prep runs op by op, as on the CPU.

Replicated tables (``k_max > 1``). ``bank`` and ``slot`` are the flattened
``(V * k_max,)`` replica-axis remaps, and bag b reads column ``wang_hash(b)
% k_max`` of every row it touches: ``row = (raw + off[b % F]) * k_max +
col``, b being the bag's index in the call's (NB, L) stream (so a call is
never split into launches with their own bag ids). The backward's prep
routes each entry's cotangent to the same copy. ``k_max == 1`` is the
single-copy code path, with no hash.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import cost as _cost
from repro_torch.obs.tracing import stage
from repro_torch.quant.quantize import dequant_rows_f32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_rows(what: str, table: torch.Tensor, *ids: torch.Tensor) -> None:
    """The checks every bag kernel's wrapper makes before a launch: a 2-D
    f32/bf16 table and (B, L) int32 ids, all contiguous on the table's
    device."""
    if table.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {table.dtype} (float32 or bfloat16)")
    if table.dim() != 2:
        raise ValueError(f"{what}: table {tuple(table.shape)} must be (R, D)")
    for t in (table, *ids):
        if t.device != table.device or not t.is_contiguous():
            raise ValueError(f"{what}: every tensor must be contiguous on "
                             f"{table.device}")
    for t in ids:
        if t.dtype != torch.int32 or t.dim() != 2:
            raise TypeError(f"{what}: ids must be (B, L) int32, got "
                            f"{tuple(t.shape)} {t.dtype}")


def _check_args(what: str, table_like: torch.Tensor, bank: torch.Tensor,
                slot: torch.Tensor, off: torch.Tensor,
                idx: torch.Tensor) -> None:
    """``_check_rows`` and ``_check_remaps``."""
    _check_rows(what, table_like, idx)
    _check_remaps(what, table_like, bank, slot, off)


def _check_remaps(what: str, table_like: torch.Tensor, bank: torch.Tensor,
                  slot: torch.Tensor, off: torch.Tensor) -> None:
    """bank and slot the same (V,), off (F,) with F >= 1, all int32,
    contiguous on the table's device."""
    if off.dim() != 1 or off.shape[0] < 1:
        raise ValueError(f"{what}: off {tuple(off.shape)} must be (F,), "
                         f"F >= 1")
    if bank.shape != slot.shape or bank.dim() != 1:
        raise ValueError(f"{what}: bank {tuple(bank.shape)} and slot "
                         f"{tuple(slot.shape)} must be the same (V,)")
    for name, t in (("bank", bank), ("slot", slot), ("off", off)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.device != table_like.device or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous on "
                             f"{table_like.device}")


def wang_hash(x: torch.Tensor) -> torch.Tensor:
    """Wang's 32-bit integer mix, bit for bit the reference's uint32
    ``wang_hash``: int64 arithmetic masked to 32 bits after each step (every
    product is below 2**62, so nothing overflows). -> int64 in [0, 2**32)."""
    m = 0xFFFFFFFF
    x = x.long() & m
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & m
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & m
    return x ^ (x >> 15)


def replica_of_bag(bag: torch.Tensor, k_max: int) -> torch.Tensor:
    """Replica column of each bag id: ``wang_hash(bag) % k_max`` (int32)."""
    return (wang_hash(bag) % k_max).to(torch.int32)


def _replica_rows(row: torch.Tensor, bag: torch.Tensor,
                  k_max: int) -> torch.Tensor:
    """Rows into the flattened (V * k_max,) remap: each bag's column."""
    if k_max == 1:
        return row
    return row * k_max + replica_of_bag(bag, k_max).long()


# launch geometry of csrc/banked_bag.cu on an H100 SXM (132 SMs; 228 KB of
# shared memory an SM, 227 KB a block at most, 1 KB of it reserved per
# block; at most 32 resident blocks an SM)
SM_COUNT, SM_SMEM, BLOCK_SMEM, BLOCK_RESERVED, SM_BLOCKS = (
    132, 233_472, 232_448, 1_024, 32)
# kStageRows, kMaxStages, 32 x kResolve, kSlotBytes in the kernel
STAGE_ROWS, MAX_STAGES, SEG, SLOT_BYTES = 32, 8, 256, 1024
MAX_BAGS_PER_BLOCK = 2      # kMaxBagsPerBlock: a warp a bag
# csrc/cache_bag.cu and csrc/csr_bag.cu (the same ring): kRound, the
# entries of a bag resolved at once, and kListBytes, their compacted slots
ROUND, LIST_BYTES = 512, 2048


class BagGeometry(NamedTuple):
    """How ``csrc/banked_bag.cu`` is launched: ``blocks`` of
    ``bags_per_block`` warps (a bag each); a bag's slots resolved 256
    entries at a time; its rows streamed through ``stages`` shared-memory
    stages of 32 rows of ``row_bytes``; copies of ``vec`` bytes;
    ``smem_bytes`` of dynamic shared memory a block (the stages and a
    segment's 256 slots, 1 KB, a bag). ``csrc/cache_bag.cu`` and
    ``csrc/csr_bag.cu`` take the same geometry with a round's 512 compacted
    slots (2 KB) in place of the segment's."""
    blocks: int
    bags_per_block: int
    stages: int
    row_bytes: int
    vec: int
    smem_bytes: int


def copy_width(*nbytes: int) -> int:
    """The widest copy unit (16, 4 or 2 bytes) that divides every byte
    count and address given."""
    for vec in (16, 4):
        if all(n % vec == 0 for n in nbytes):
            return vec
    return 2


def bag_geometry(nb: int, bag_len: int, dim: int, itemsize: int,
                 base_ptr: int = 0,
                 slot_bytes: int = SLOT_BYTES) -> BagGeometry:
    """Launch geometry of the bag kernel for ``nb`` bags of ``bag_len``
    entries over a table of ``dim`` columns of ``itemsize`` bytes at
    address ``base_ptr``, with ``slot_bytes`` of resolved slots a bag
    beside its ring (``LIST_BYTES`` for the cache and CSR bags).

    One bag a block while the bags fit the card's resident-block limit
    (132 SMs x 32), else two. The ring takes as many stages of 32 rows as
    one segment of 256 entries needs (at most 8) within the shared memory an
    SM can give each of its blocks when every block is resident; at least
    one.
    A pass covers 32 K columns (K = 1, 2 or 4 a lane: D up to 32, 64, more),
    and a ring row holds a whole pass whatever D is."""
    bags_per_block = 1 if -(-nb // SM_COUNT) <= SM_BLOCKS else 2
    blocks = -(-nb // bags_per_block)
    k = 1 if dim <= 32 else 2 if dim <= 64 else 4
    row_bytes = 32 * k * itemsize       # the ring's row: a pass's columns
    need = max(1, min(MAX_STAGES, -(-min(bag_len, SEG) // STAGE_ROWS)))
    per_sm = min(SM_BLOCKS, max(1, -(-blocks // SM_COUNT)))
    per_bag = min(BLOCK_SMEM, SM_SMEM // per_sm - BLOCK_RESERVED) \
        // bags_per_block
    stages = max(1, min(need, (per_bag - slot_bytes)
                        // (STAGE_ROWS * row_bytes)))
    smem = bags_per_block * (slot_bytes + stages * STAGE_ROWS * row_bytes)
    return BagGeometry(blocks, bags_per_block, stages, row_bytes,
                       copy_width(dim * itemsize, base_ptr), smem)


def tuned_geometry(nb: int, bag_len: int, dim: int, itemsize: int,
                   *base_ptrs: int, bags_per_block: int | None = None,
                   stages: int | None = None,
                   slot_bytes: int = SLOT_BYTES) -> BagGeometry:
    """``bag_geometry`` (``slot_bytes`` a bag) with ``bags_per_block`` and
    ``stages`` replaced where given (the dispatch cache's ``tile_b`` and
    ``n_slots``); the blocks and shared memory follow, and the copy unit
    divides the row stride and every table's base address, as
    ``ring_geometry``'s. With both None it is the rule's geometry.

    Raises ValueError where the override breaks a limit the kernels check
    before a launch: 1 or 2 bags a block, 1 to 8 stages, and at most
    ``BLOCK_SMEM`` bytes of shared memory a block."""
    g = bag_geometry(nb, bag_len, dim, itemsize, slot_bytes=slot_bytes)
    b = g.bags_per_block if bags_per_block is None else int(bags_per_block)
    s = g.stages if stages is None else int(stages)
    if not 1 <= b <= MAX_BAGS_PER_BLOCK:
        raise ValueError(f"bags_per_block {b}: the bag kernels take 1 to "
                         f"{MAX_BAGS_PER_BLOCK}")
    if not 1 <= s <= MAX_STAGES:
        raise ValueError(f"stages {s}: the bag kernels take 1 to "
                         f"{MAX_STAGES}")
    smem = b * (slot_bytes + s * STAGE_ROWS * g.row_bytes)
    if smem > BLOCK_SMEM:
        raise ValueError(f"{b} bag(s) a block x {s} stages of {STAGE_ROWS} "
                         f"rows of {g.row_bytes} B need {smem} B of shared "
                         f"memory a block, over the {BLOCK_SMEM} B limit")
    return BagGeometry(-(-nb // b), b, s, g.row_bytes,
                       copy_width(dim * itemsize, *base_ptrs), smem)


def _geometry_args(table: torch.Tensor, nb: int, bag_len: int,
                   geometry: tuple | None = None) -> tuple:
    b, s = geometry or (None, None)
    g = tuned_geometry(nb, bag_len, table.shape[1], table.element_size(),
                       table.data_ptr(), bags_per_block=b, stages=s)
    return g.bags_per_block, g.stages, g.vec


def ring_geometry(nb: int, bag_len: int, dim: int, itemsize: int,
                  *base_ptrs: int) -> BagGeometry:
    """Launch geometry of ``csrc/cache_bag.cu`` and ``csrc/csr_bag.cu``:
    ``bag_geometry`` with a round's compacted slots (``LIST_BYTES``) a bag,
    for bags of ``bag_len`` entries (the ring's depth follows at most 256 of
    them), and a copy unit that divides the row stride and every table's
    base address."""
    return tuned_geometry(nb, bag_len, dim, itemsize, *base_ptrs,
                          slot_bytes=LIST_BYTES)


def _charge(kernel: str, cost: tuple[int, int]) -> None:
    """A call on meta tensors: the kernel's ``(bytes, operations)``
    reported to the cost counters in force."""
    from repro_torch.launch.roofline import charge
    charge(kernel, *cost)


def _on_meta(kernel: str, shape: tuple, dtype, device,
             cost: tuple[int, int]) -> torch.Tensor:
    """``_charge``, and the call's output of ``shape`` on meta."""
    _charge(kernel, cost)
    return torch.empty(shape, dtype=dtype, device=device)


def banked_bag_plain(table: torch.Tensor, bank: torch.Tensor,
                     slot: torch.Tensor, off: torch.Tensor, my: int,
                     idx: torch.Tensor, k_max: int = 1) -> torch.Tensor:
    """Plain PyTorch version: a loop over j that mirrors the reference's
    ``_bag_partial_scan`` (``_replicated_bag_scan`` for ``k_max > 1``) step
    for step (one (NB, D) gather per entry column, fp32 accumulator, one
    cast at the end)."""
    NB, L = idx.shape
    n = torch.arange(NB, device=idx.device)
    offs = off.long()[n % off.shape[0]]
    acc = torch.zeros((NB, table.shape[-1]), dtype=torch.float32,
                      device=table.device)
    for j in range(L):
        raw = idx[:, j].long()
        valid = raw >= 0
        row = _replica_rows(torch.where(valid, raw + offs, 0), n, k_max)
        mine = valid if my < 0 else valid & (bank[row] == my)
        rows = table[torch.where(mine, slot[row].long(), 0)]
        acc = acc + torch.where(mine[:, None], rows, 0).float()
    return acc.to(table.dtype)


def banked_bag(table: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
               off: torch.Tensor, my: int, idx: torch.Tensor,
               k_max: int = 1, geometry: tuple | None = None) -> torch.Tensor:
    """table (R, D) f32/bf16; bank, slot (V * k_max,) int32; off (F,) int32;
    my (< 0 owns every row); idx (NB, L) int32, -1 padded -> (NB, D).
    ``k_max > 1``: bag b reads replica column ``wang_hash(b) % k_max``.
    ``geometry`` ``(bags_per_block, stages)``, either None for the rule's:
    the launch geometry (``tuned_geometry``, which raises before the launch
    on one the kernel cannot take); the sums are the same bits whatever it
    is.

    CPU tensors take ``banked_bag_plain``. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback. A launch counts on
    ``banked_bag.launches`` (``k_max == 1``) or
    ``banked_bag.replicated_launches`` (``k_max > 1``). Meta tensors: the
    output's shape and the kernel's cost (the module doc).
    """
    if k_max < 1 or bank.shape[0] % k_max:
        raise ValueError(f"banked_bag: k_max {k_max} with a remap of "
                         f"{bank.shape[0]} entries")
    if table.device.type == "meta":
        NB, L = idx.shape
        return _on_meta(
            "banked_bag" if k_max == 1 else "banked_bag_replicated",
            (NB, table.shape[1]), table.dtype, table.device,
            _cost.meta_bag_cost(NB, L, table.shape[1], table.element_size(),
                                n_remap=bank.shape[0],
                                n_table_rows=table.shape[0],
                                n_fields=off.shape[0], owned_test=my >= 0))
    if table.device.type == "cpu":
        return banked_bag_plain(table, bank, slot, off, my, idx, k_max)
    if table.device.type != "cuda":
        raise ValueError(f"banked_bag: unsupported device {table.device}")
    _check_args("banked_bag", table, bank, slot, off, idx)
    NB, L = idx.shape
    D = table.shape[1]
    geo = _geometry_args(table, NB, L, geometry)
    out = torch.empty((NB, D), dtype=table.dtype, device=table.device)
    fn = _build.function("banked_bag", "banked_bag_forward",
                         [_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I,
                          _I, _P, _I, _I, _I])
    err = fn(table.data_ptr(), _DTYPES[table.dtype], bank.data_ptr(),
             slot.data_ptr(), off.data_ptr(), off.shape[0], int(my),
             int(k_max), idx.data_ptr(), out.data_ptr(), NB, L, D,
             table.device.index,
             torch.cuda.current_stream(table.device).cuda_stream, *geo)
    _build.check("banked_bag", err, "banked_bag")
    if k_max == 1:
        banked_bag.launches += 1
    else:
        banked_bag.replicated_launches += 1
    return out


banked_bag.launches = 0     # k_max == 1 launches (counted only where launched)
banked_bag.replicated_launches = 0      # k_max > 1 launches


def plain_bag_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the identity kernel: a loop over j (one
    (B, D) gather of ``table[raw]`` per entry column, masked, fp32
    accumulator, one cast at the end), the reference's
    ``_plain_bag_kernel`` order."""
    acc = torch.zeros((idx.shape[0], table.shape[-1]), dtype=torch.float32,
                      device=table.device)
    _stream_plain(acc, table, None, None, -1, idx)
    return acc.to(table.dtype)


def plain_bag(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Identity-layout bag sums: table (V, D) f32/bf16; idx (B, L) int32
    table rows, -1 padded -> (B, D) in the table's dtype.

    CPU tensors take ``plain_bag_plain``. CUDA tensors launch the identity
    instance of ``csrc/banked_bag.cu`` on the current stream, or raise:
    there is no fallback. A launch counts on ``plain_bag.launches``. Meta
    tensors: the output's shape and the kernel's cost.
    """
    if table.device.type == "meta":
        B, L = idx.shape
        return _on_meta("plain_bag", (B, table.shape[1]), table.dtype,
                        table.device,
                        _cost.meta_bag_cost(B, L, table.shape[1],
                                            table.element_size(),
                                            n_remap=table.shape[0],
                                            n_table_rows=table.shape[0],
                                            remap=False))
    if table.device.type == "cpu":
        return plain_bag_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"plain_bag: unsupported device {table.device}")
    _check_rows("plain_bag", table, idx)
    B, L = idx.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    fn = _build.function("banked_bag", "plain_bag_forward",
                         [_P, _I, _P, _P, _I, _I, _I, _I, _P, _I, _I, _I])
    err = fn(table.data_ptr(), _DTYPES[table.dtype], idx.data_ptr(),
             out.data_ptr(), B, L, D, table.device.index,
             torch.cuda.current_stream(table.device).cuda_stream,
             *_geometry_args(table, B, L))
    _build.check("banked_bag", err, "plain_bag")
    plain_bag.launches += 1
    return out


plain_bag.launches = 0      # kernel launches (counted only where launched)


# ---------------------------------------------------------------------------
# forward: the fused cache + residual bag sums (Fig. 7)
# ---------------------------------------------------------------------------

def effective_lengths(idx: torch.Tensor) -> torch.Tensor:
    """(B, L) -1 padded bags -> (B,) int32 count through the LAST valid
    entry (1 + its position; 0 for all-pad bags). Interior -1 holes stay
    inside the walk, where the validity mask skips them, so a walk that
    stops here gives the same sum for any padding pattern."""
    valid = idx >= 0
    last = idx.shape[1] - torch.argmax(valid.flip(1).to(torch.uint8), dim=1)
    return torch.where(valid.any(dim=1), last, 0).to(torch.int32)


def _stream_plain(acc: torch.Tensor, table: torch.Tensor,
                  bank: torch.Tensor | None, slot: torch.Tensor | None,
                  my: int, idx: torch.Tensor) -> None:
    """Add one -1 padded stream into ``acc`` in entry order, each bag up to
    its effective length (the loop runs to the batch's longest). ``slot``
    None: the identity layout (the id is the row; ``my`` must be < 0)."""
    n = int(effective_lengths(idx).max()) if idx.numel() else 0
    for j in range(n):
        raw = idx[:, j].long()
        valid = raw >= 0
        row = torch.where(valid, raw, 0)
        mine = valid if my < 0 else valid & (bank[row] == my)
        src = row if slot is None else slot[row].long()
        rows = table[torch.where(mine, src, 0)]
        acc += torch.where(mine[:, None], rows, 0).float()


def cache_residual_bag_plain(emt: torch.Tensor, cache: torch.Tensor,
                             emt_bank: torch.Tensor, emt_slot: torch.Tensor,
                             cache_bank: torch.Tensor,
                             cache_slot: torch.Tensor, my: int,
                             cache_idx: torch.Tensor,
                             residual_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, in the kernel's order:
    one fp32 accumulator per bag takes its cache entries j = 0, 1, ...,
    then its residual entries j = 0, 1, ..., and is cast to the EMT's dtype
    once. The cache table is first cast to the EMT's dtype, as the
    reference's ``fused_cache_bag_pallas`` does. (``core/embedding``'s
    ``backend='torch'`` sums the two streams apart and adds them after, as
    the reference's jnp path does: another fp32 order.)"""
    acc = torch.zeros((cache_idx.shape[0], emt.shape[-1]),
                      dtype=torch.float32, device=emt.device)
    _stream_plain(acc, cache.to(emt.dtype), cache_bank, cache_slot, my,
                  cache_idx)
    _stream_plain(acc, emt, emt_bank, emt_slot, my, residual_idx)
    return acc.to(emt.dtype)


def cache_residual_bag(emt: torch.Tensor, cache: torch.Tensor,
                       emt_bank: torch.Tensor, emt_slot: torch.Tensor,
                       cache_bank: torch.Tensor, cache_slot: torch.Tensor,
                       my: int, cache_idx: torch.Tensor,
                       residual_idx: torch.Tensor,
                       geometry: tuple | None = None) -> torch.Tensor:
    """emt (R, D) and cache (Rc, D) f32/bf16; emt_bank/emt_slot (V,) and
    cache_bank/cache_slot (Vc,) int32; my (< 0 owns every row); cache_idx
    (NB, Lc) and residual_idx (NB, Lr) int32, -1 padded -> (NB, D) in the
    EMT's dtype = Σ cached partial sums + Σ residual rows. ``geometry`` as
    ``banked_bag``'s.

    CPU tensors take ``cache_residual_bag_plain``. CUDA tensors launch the
    kernel on the current stream, or raise: there is no fallback. Meta
    tensors: the output's shape and the kernel's cost.
    """
    if emt.device.type == "meta":
        NB, Lc = cache_idx.shape
        if cache.dtype != emt.dtype:
            cache = cache.to(emt.dtype)       # the launch's cast, counted
        return _on_meta(
            "cache_residual_bag", (NB, emt.shape[1]), emt.dtype, emt.device,
            _cost.meta_cache_bag_cost(NB, Lc, residual_idx.shape[1],
                                      emt.shape[1], emt.element_size(),
                                      cache_rows=cache.shape[0],
                                      emt_rows=emt.shape[0]))
    if emt.device.type == "cpu":
        return cache_residual_bag_plain(emt, cache, emt_bank, emt_slot,
                                        cache_bank, cache_slot, my,
                                        cache_idx, residual_idx)
    if emt.device.type != "cuda":
        raise ValueError(f"cache_residual_bag: unsupported device "
                         f"{emt.device}")
    zero = torch.zeros((1,), dtype=torch.int32, device=emt.device)
    _check_args("cache_residual_bag", emt, emt_bank, emt_slot, zero,
                residual_idx)
    if cache.dtype != emt.dtype:
        cache = cache.to(emt.dtype)           # one row dtype, as the reference
    _check_args("cache_residual_bag", cache, cache_bank, cache_slot, zero,
                cache_idx)
    if cache.shape[1] != emt.shape[1] or \
            cache_idx.shape[0] != residual_idx.shape[0]:
        raise ValueError(f"cache_residual_bag: emt {tuple(emt.shape)}, cache "
                         f"{tuple(cache.shape)}, cache_idx "
                         f"{tuple(cache_idx.shape)}, residual_idx "
                         f"{tuple(residual_idx.shape)}")
    NB, Lc = cache_idx.shape
    Lr, D = residual_idx.shape[1], emt.shape[1]
    b, s = geometry or (None, None)
    g = tuned_geometry(NB, Lc + Lr, D, emt.element_size(), emt.data_ptr(),
                       cache.data_ptr(), bags_per_block=b, stages=s,
                       slot_bytes=LIST_BYTES)
    out = torch.empty((NB, D), dtype=emt.dtype, device=emt.device)
    fn = _build.function("cache_bag", "cache_bag_forward",
                         [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                          _I, _I, _I, _P, _I, _I, _I])
    err = fn(emt.data_ptr(), cache.data_ptr(), _DTYPES[emt.dtype],
             emt_bank.data_ptr(), emt_slot.data_ptr(), cache_bank.data_ptr(),
             cache_slot.data_ptr(), int(my), cache_idx.data_ptr(),
             residual_idx.data_ptr(), out.data_ptr(), NB, Lc, Lr, D,
             emt.device.index, torch.cuda.current_stream(emt.device).cuda_stream,
             g.bags_per_block, g.stages, g.vec)
    _build.check("cache_bag", err, "cache_residual_bag")
    cache_residual_bag.launches += 1
    return out


cache_residual_bag.launches = 0  # kernel launches (counted only where launched)


def plain_cache_bag_plain(emt: torch.Tensor, cache: torch.Tensor,
                          cache_idx: torch.Tensor,
                          residual_idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the identity fused kernel: the order of
    ``cache_residual_bag_plain`` (one fp32 accumulator per bag over its
    cache entries, then its residual entries, each to its effective
    length), with the ids as the tables' rows; the cache table is cast to
    the EMT's dtype first, as the reference's ``plain_cache_bag_pallas``
    does."""
    acc = torch.zeros((cache_idx.shape[0], emt.shape[-1]),
                      dtype=torch.float32, device=emt.device)
    _stream_plain(acc, cache.to(emt.dtype), None, None, -1, cache_idx)
    _stream_plain(acc, emt, None, None, -1, residual_idx)
    return acc.to(emt.dtype)


def plain_cache_bag(emt: torch.Tensor, cache: torch.Tensor,
                    cache_idx: torch.Tensor,
                    residual_idx: torch.Tensor) -> torch.Tensor:
    """Identity-layout fused lookup (Fig. 7 on unbanked tables): emt (V, D)
    and cache (C, D) f32/bf16; cache_idx (B, Lc) cache rows and
    residual_idx (B, Lr) EMT rows, int32, -1 padded -> (B, D) in the EMT's
    dtype = Σ cached partial sums + Σ residual rows.

    CPU tensors take ``plain_cache_bag_plain``. CUDA tensors launch the
    identity instance of ``csrc/cache_bag.cu`` on the current stream, or
    raise: there is no fallback. A launch counts on
    ``plain_cache_bag.launches``. Meta tensors: the output's shape and the
    kernel's cost.
    """
    if emt.device.type == "meta":
        B, Lc = cache_idx.shape
        if cache.dtype != emt.dtype:
            cache = cache.to(emt.dtype)       # the launch's cast, counted
        return _on_meta(
            "plain_cache_bag", (B, emt.shape[1]), emt.dtype, emt.device,
            _cost.meta_cache_bag_cost(B, Lc, residual_idx.shape[1],
                                      emt.shape[1], emt.element_size(),
                                      cache_rows=cache.shape[0],
                                      emt_rows=emt.shape[0], remap=False))
    if emt.device.type == "cpu":
        return plain_cache_bag_plain(emt, cache, cache_idx, residual_idx)
    if emt.device.type != "cuda":
        raise ValueError(f"plain_cache_bag: unsupported device {emt.device}")
    if cache.dtype != emt.dtype:
        cache = cache.to(emt.dtype)           # one row dtype, as the reference
    _check_rows("plain_cache_bag", emt, cache_idx, residual_idx)
    _check_rows("plain_cache_bag", cache)
    if cache.shape[1] != emt.shape[1] or \
            cache_idx.shape[0] != residual_idx.shape[0]:
        raise ValueError(f"plain_cache_bag: emt {tuple(emt.shape)}, cache "
                         f"{tuple(cache.shape)}, cache_idx "
                         f"{tuple(cache_idx.shape)}, residual_idx "
                         f"{tuple(residual_idx.shape)}")
    B, Lc = cache_idx.shape
    Lr, D = residual_idx.shape[1], emt.shape[1]
    out = torch.empty((B, D), dtype=emt.dtype, device=emt.device)
    g = ring_geometry(B, Lc + Lr, D, emt.element_size(), emt.data_ptr(),
                      cache.data_ptr())
    fn = _build.function("cache_bag", "plain_cache_bag_forward",
                         [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                          _I, _I])
    err = fn(emt.data_ptr(), cache.data_ptr(), _DTYPES[emt.dtype],
             cache_idx.data_ptr(), residual_idx.data_ptr(), out.data_ptr(),
             B, Lc, Lr, D, emt.device.index,
             torch.cuda.current_stream(emt.device).cuda_stream,
             g.bags_per_block, g.stages, g.vec)
    _build.check("cache_bag", err, "plain_cache_bag")
    plain_cache_bag.launches += 1
    return out


plain_cache_bag.launches = 0    # kernel launches (counted only where launched)


# ---------------------------------------------------------------------------
# forward: ragged CSR bag sums
# ---------------------------------------------------------------------------

def _by_rank(lens: torch.Tensor) -> tuple[torch.Tensor, list[int]]:
    """(order, live) for walking groups (bags, runs) of these lengths by
    rank: ``order`` sorts them longest first (stably), and ``live[k]`` is
    how many are longer than k, a prefix of that order."""
    order = torch.argsort(lens, descending=True, stable=True)
    desc = lens[order].cpu().numpy()
    live = lens.shape[0] - np.searchsorted(desc[::-1], np.arange(int(desc[0])),
                                           side="right")
    return order, live.tolist()


def _csr_ranges(offsets_ext: torch.Tensor, total: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """(begin, end) int64 per bag, clamped into [0, total] with end >=
    begin, as the kernel clamps them."""
    o = offsets_ext.long().clamp(0, total)
    begin = o[:-1]
    return begin, torch.maximum(o[1:], begin)


def _csr_out_dtype(table: torch.Tensor, out_dtype) -> torch.dtype:
    """The CSR sums' dtype: the table's, or float32."""
    if out_dtype is None or out_dtype == table.dtype:
        return table.dtype
    if out_dtype != torch.float32:
        raise ValueError(f"csr_bag: out_dtype {out_dtype}: the sums are the "
                         f"table's dtype ({table.dtype}) or float32")
    return out_dtype


def csr_bag_plain(table: torch.Tensor, bank: torch.Tensor,
                  slot: torch.Tensor, my: int, indices: torch.Tensor,
                  offsets_ext: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of the CSR kernel. Bags are walked by the rank
    of their entries, as ``ct_scatter_runs_plain`` walks runs: step k adds
    the k-th entry of every bag that has one (bags sorted longest first, so
    they are a prefix), in fp32; the loop runs as often as the longest bag
    is long, and each bag adds its entries in stream order. Cast once to
    ``out_dtype`` (None: the table's dtype; float32: no cast)."""
    out_dtype = _csr_out_dtype(table, out_dtype)
    NB = offsets_ext.shape[0] - 1
    acc = torch.zeros((NB, table.shape[-1]), dtype=torch.float32,
                      device=table.device)
    begin, end = _csr_ranges(offsets_ext, indices.shape[0])
    lens = end - begin
    if NB == 0 or int(lens.max()) == 0:
        return acc.to(out_dtype)
    order, live = _by_rank(lens)
    starts = begin[order]
    part = torch.zeros_like(acc)
    for k, m in enumerate(live):
        raw = indices[starts[:m] + k].long()
        valid = raw >= 0
        row = torch.where(valid, raw, 0)
        mine = valid if my < 0 else valid & (bank[row] == my)
        rows = table[torch.where(mine, slot[row].long(), 0)]
        part[:m] += torch.where(mine[:, None], rows, 0).float()
    acc[order] = part
    return acc.to(out_dtype)


def csr_bag(table: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
            my: int, indices: torch.Tensor, offsets_ext: torch.Tensor,
            geometry: tuple | None = None, out_dtype=None) -> torch.Tensor:
    """table (R, D) f32/bf16; bank, slot (V,) int32; my (< 0 owns every
    row); indices (T,) int32 super-table rows, -1 for a hole; offsets_ext
    (NB + 1,) int32, bag b = entries [offs[b], offs[b+1]) -> (NB, D) in
    ``out_dtype``: None (the table's dtype) or float32, which a bf16 table
    gets from its own instance of the kernel (the fp32 sums, no cast).
    ``geometry`` as ``banked_bag``'s.

    CPU tensors take ``csr_bag_plain``. CUDA tensors launch
    ``csrc/csr_bag.cu`` on the current stream, or raise: there is no
    fallback. A launch of any instance counts on ``csr_bag.launches``.
    Meta tensors: the output's shape and the kernel's cost.
    """
    out_dtype = _csr_out_dtype(table, out_dtype)
    if table.device.type == "meta":
        NB = offsets_ext.shape[0] - 1
        return _on_meta(
            "csr_bag", (NB, table.shape[1]), out_dtype, table.device,
            _cost.meta_csr_bag_cost(indices.shape[0], NB, table.shape[1],
                                    table.element_size(),
                                    n_remap=bank.shape[0],
                                    n_table_rows=table.shape[0],
                                    owned_test=my >= 0,
                                    out_itemsize=out_dtype.itemsize))
    if table.device.type == "cpu":
        return csr_bag_plain(table, bank, slot, my, indices, offsets_ext,
                             out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"csr_bag: unsupported device {table.device}")
    if indices.dim() != 1 or offsets_ext.dim() != 1 \
            or offsets_ext.shape[0] < 1:
        raise ValueError(f"csr_bag: indices {tuple(indices.shape)}, "
                         f"offsets_ext {tuple(offsets_ext.shape)}")
    _check_args("csr_bag", table, bank, slot, offsets_ext, indices[None])
    NB, T, D = offsets_ext.shape[0] - 1, indices.shape[0], table.shape[1]
    # the ring's depth from the mean bag length: shapes only, the offsets
    # are never read on the host
    b, s = geometry or (None, None)
    g = tuned_geometry(NB, -(-T // max(NB, 1)), D, table.element_size(),
                       table.data_ptr(), bags_per_block=b, stages=s,
                       slot_bytes=LIST_BYTES)
    out = torch.empty((NB, D), dtype=out_dtype, device=table.device)
    entry = "csr_bag_forward" if out_dtype == table.dtype \
        else "csr_bag_forward_f32"
    fn = _build.function("csr_bag", entry,
                         [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                          _I, _I, _I])
    err = fn(table.data_ptr(), _DTYPES[table.dtype], bank.data_ptr(),
             slot.data_ptr(), int(my), indices.data_ptr(),
             offsets_ext.data_ptr(), out.data_ptr(), NB, T, D,
             table.device.index,
             torch.cuda.current_stream(table.device).cuda_stream,
             g.bags_per_block, g.stages, g.vec)
    _build.check("csr_bag", err, "csr_bag")
    csr_bag.launches += 1
    return out


csr_bag.launches = 0        # kernel launches (counted only where launched)


# ---------------------------------------------------------------------------
# forward: bag sums over a tiered-precision payload
# ---------------------------------------------------------------------------

def tiered_bag_plain(payload: torch.Tensor, scale: torch.Tensor,
                     tier: torch.Tensor, bank: torch.Tensor,
                     slot: torch.Tensor, off: torch.Tensor, my: int,
                     idx: torch.Tensor, *, dim: int,
                     hot_dtype: str = "bf16") -> torch.Tensor:
    """Plain PyTorch version of the tiered kernel, step for step the
    reference's ``_tiered_partial_scan``: a loop over j, one (NB, ·) gather
    of payload rows, scales and tiers per entry column, the shared fp32
    dequant (``quant.dequant_rows_f32``), and a separate masked fp32 add."""
    NB, L = idx.shape
    n = torch.arange(NB, device=idx.device)
    offs = off.long()[n % off.shape[0]]
    acc = torch.zeros((NB, dim), dtype=torch.float32, device=payload.device)
    for j in range(L):
        raw = idx[:, j].long()
        valid = raw >= 0
        row = torch.where(valid, raw + offs, 0)
        mine = valid if my < 0 else valid & (bank[row] == my)
        src = torch.where(mine, slot[row].long(), 0)
        rows = dequant_rows_f32(payload[src], scale[src], tier[src], dim,
                                hot_dtype)
        acc = acc + torch.where(mine[:, None], rows, 0.0)
    return acc


def tiered_bag(payload: torch.Tensor, scale: torch.Tensor,
               tier: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
               off: torch.Tensor, my: int, idx: torch.Tensor, *, dim: int,
               hot_dtype: str = "bf16") -> torch.Tensor:
    """payload (R, row_bytes) int8 with row_bytes = 2 * dim (bf16 hot) or
    4 * dim (fp32 hot); scale (R,) float32; tier (R,) int32; bank, slot
    (V,) int32 (slot: the flat packed position); off (F,) int32; my (< 0
    owns every row); idx (NB, L) int32, -1 padded -> (NB, dim) float32.

    CPU tensors take ``tiered_bag_plain``. CUDA tensors launch the kernel
    on the current stream, or raise: there is no fallback. Meta tensors:
    the output's shape and the kernel's cost (every row scaled, at the
    payload's full width).
    """
    if payload.device.type == "meta":
        NB, L = idx.shape
        return _on_meta(
            "tiered_bag", (NB, dim), torch.float32, payload.device,
            _cost.meta_tiered_bag_cost(NB, L, dim, n_fields=off.shape[0],
                                       n_remap=bank.shape[0],
                                       n_table_rows=payload.shape[0],
                                       payload_row_bytes=payload.shape[1]))
    if payload.device.type == "cpu":
        return tiered_bag_plain(payload, scale, tier, bank, slot, off, my,
                                idx, dim=dim, hot_dtype=hot_dtype)
    if payload.device.type != "cuda":
        raise ValueError(f"tiered_bag: unsupported device {payload.device}")
    if hot_dtype not in ("bf16", "fp32"):
        raise ValueError(f"tiered_bag: hot_dtype {hot_dtype!r}")
    rb = dim * (2 if hot_dtype == "bf16" else 4)
    if payload.dtype != torch.int8 or payload.dim() != 2 \
            or payload.shape[1] != rb:
        raise ValueError(f"tiered_bag: payload {tuple(payload.shape)} "
                         f"{payload.dtype}, want (R, {rb}) int8 for dim "
                         f"{dim} with a {hot_dtype} hot tier")
    R = payload.shape[0]
    if scale.dtype != torch.float32 or tier.dtype != torch.int32 \
            or tuple(scale.shape) != (R,) or tuple(tier.shape) != (R,):
        raise ValueError(f"tiered_bag: scale {tuple(scale.shape)} "
                         f"{scale.dtype}, tier {tuple(tier.shape)} "
                         f"{tier.dtype}; want ({R},) float32 and int32")
    for name, t in (("scale", scale), ("tier", tier)):
        if t.device != payload.device or not t.is_contiguous():
            raise ValueError(f"tiered_bag: {name} must be contiguous on "
                             f"{payload.device}")
    # the int checks of the other wrappers (an fp32 stand-in for the rows)
    _check_args("tiered_bag", scale[:, None], bank, slot, off, idx)
    if not payload.is_contiguous():
        raise ValueError("tiered_bag: payload is not contiguous")
    NB, L = idx.shape
    out = torch.empty((NB, dim), dtype=torch.float32, device=payload.device)
    fn = _build.function("tiered_bag", "tiered_bag_forward",
                         [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I,
                          _I, _I, _I, _P])
    err = fn(payload.data_ptr(), rb, scale.data_ptr(), tier.data_ptr(),
             bank.data_ptr(), slot.data_ptr(), off.data_ptr(), off.shape[0],
             int(my), idx.data_ptr(), out.data_ptr(), NB, L, dim,
             int(hot_dtype == "fp32"), payload.device.index,
             torch.cuda.current_stream(payload.device).cuda_stream)
    _build.check("tiered_bag", err, "tiered_bag")
    tiered_bag.launches += 1
    return out


tiered_bag.launches = 0     # kernel launches (counted only where launched)


# ---------------------------------------------------------------------------
# backward: the bag sum's transpose, as sorted per-slot runs
# ---------------------------------------------------------------------------

class ScatterRuns(NamedTuple):
    """The prep's output, as the kernel reads it."""
    bag_sorted: torch.Tensor    # (E,) int32: entries' cotangent rows, by slot
    run_starts: torch.Tensor    # (n_runs_pad + 1,) int32: run r = [s[r], s[r+1])
    run_slot: torch.Tensor      # (n_runs_pad,) int32: run r's table slot
    n_run: torch.Tensor         # (1,) int32: live runs (a prefix)
    run_of: torch.Tensor        # (max(E, 1),) int32: each sorted entry's run


def dest_slots(row: torch.Tensor, valid: torch.Tensor, bank: torch.Tensor,
               slot: torch.Tensor, my: int, n_rows: int) -> torch.Tensor:
    """An entry scatters iff it is valid and owned (``my < 0`` owns every
    row), onto ``slot[row]``; every other entry gets the out-of-range
    sentinel ``n_rows``, which sorts it out of every run."""
    mine = valid if my < 0 else valid & (bank[row] == my)
    return torch.where(mine, slot[row], n_rows).to(torch.int32)


def scatter_entries(idx: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
                    off: torch.Tensor, my: int, n_rows: int, k_max: int = 1
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dest, bags), each (NB * L,) int32, for the entries of an (NB, L) id
    stream enumerated j-major (``e = j * NB + bag``), the order in which the
    reference's scan over L adds them. ``k_max > 1``: each entry lands on
    the replica column its bag's forward read (``bank``/``slot`` flattened
    (V * k_max,))."""
    NB, L = idx.shape
    e = torch.arange(NB * L, device=idx.device)
    bag = e % NB
    raw = idx.t().reshape(-1).long()
    valid = raw >= 0
    row = _replica_rows(
        torch.where(valid, raw + off.long()[bag % off.shape[0]], 0), bag,
        k_max)
    return dest_slots(row, valid, bank, slot, my, n_rows), bag.to(torch.int32)


def scatter_run_metadata(dest: torch.Tensor, bags: torch.Tensor, n_rows: int,
                         n_runs_pad: int) -> tuple[torch.Tensor, ...]:
    """Slot-sorted scatter metadata, step for step as the reference's prep:
    ``(bag_sorted, run_of, run_starts, run_slot, n_run)`` with the run axis
    padded to ``n_runs_pad >= E``. The stable sort keeps entry order within
    a run. Dead runs (index >= n_run) are empty and point at an in-bounds
    slot; nothing may write them. Nothing here waits for the device."""
    E = dest.shape[0]
    if n_runs_pad < E:
        raise ValueError(f"n_runs_pad {n_runs_pad} < {E} entries")
    dev = dest.device
    perm = torch.argsort(dest, stable=True)
    sd = dest[perm]
    bag_sorted = bags[perm].to(torch.int32)
    live = sd < n_rows
    n_valid = live.sum().to(torch.int32)
    prev = torch.cat([torch.full((1,), -1, dtype=sd.dtype, device=dev),
                      sd[:-1]])
    new_run = (sd != prev) & live
    n_run = new_run.sum().to(torch.int32)
    run_of = torch.clamp(torch.cumsum(new_run, 0) - 1, min=0).to(torch.int32)
    starts = torch.sort(torch.where(
        new_run, torch.arange(E, dtype=torch.int32, device=dev), E)).values
    pad = torch.full((n_runs_pad + 1 - E,), E, dtype=torch.int32, device=dev)
    run_starts = torch.minimum(torch.cat([starts.to(torch.int32), pad]),
                               n_valid)
    run_slot = torch.clamp(sd, max=n_rows - 1)[
        torch.clamp(run_starts[:-1], max=E - 1).long()].to(torch.int32)
    return bag_sorted, run_of, run_starts, run_slot, n_run.reshape(1)


# -- the prep on the card (csrc/scatter_prep.cu): label, sort, run table ----

def label_bits(n_rows: int) -> int:
    """The key bits the sort of a label kernel's dests needs: they lie in
    [0, n_rows]."""
    return max(1, int(n_rows).bit_length())


def scatter_labels_plain(idx: torch.Tensor, bank: torch.Tensor,
                         slot: torch.Tensor, off: torch.Tensor, my: int,
                         n_rows: int, k_max: int = 1
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``scatter_labels``: ``scatter_entries``'
    (dest, bags), with a dest outside [0, n_rows] sent to the sentinel
    ``n_rows`` so that ``label_bits(n_rows)`` key bits hold every label (a
    remap's slots lie in [0, n_rows): there it changes nothing)."""
    dest, bags = scatter_entries(idx, bank, slot, off, my, n_rows, k_max)
    return torch.where((dest < 0) | (dest > n_rows), n_rows,
                       dest).to(torch.int32), bags


def scatter_labels(idx: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
                   off: torch.Tensor, my: int, n_rows: int, k_max: int = 1
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Step 1 of the prep: (dest, bags), each (NB * L,) int32, the labels of
    ``scatter_labels_plain`` for the (NB, L) int32 ids; bank, slot (V *
    k_max,) and off (F,) int32. CPU tensors take the plain version; CUDA
    tensors launch the label kernel of ``csrc/scatter_prep.cu`` (counted on
    ``scatter_labels.launches``), or raise: there is no fallback."""
    if idx.device.type == "cpu":
        return scatter_labels_plain(idx, bank, slot, off, my, n_rows, k_max)
    if idx.device.type != "cuda":
        raise ValueError(f"scatter_labels: unsupported device {idx.device}")
    if idx.dtype != torch.int32 or idx.dim() != 2 or not idx.is_contiguous():
        raise TypeError(f"scatter_labels: idx must be contiguous (NB, L) "
                        f"int32, got {tuple(idx.shape)} {idx.dtype}")
    _check_remaps("scatter_labels", idx, bank, slot, off)
    NB, L = idx.shape
    if k_max < 1 or bank.shape[0] % k_max or NB * L >= 2**31 \
            or not 0 <= n_rows < 2**31:
        raise ValueError(f"scatter_labels: ids {tuple(idx.shape)}, k_max "
                         f"{k_max}, remap {bank.shape[0]}, n_rows {n_rows}")
    dest = torch.empty(NB * L, dtype=torch.int32, device=idx.device)
    bags = torch.empty_like(dest)
    if dest.shape[0]:
        fn = _build.function("scatter_prep", "scatter_prep_label",
                             [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                              _I, _P])
        err = fn(idx.data_ptr(), bank.data_ptr(), slot.data_ptr(),
                 off.data_ptr(), off.shape[0], my, n_rows, k_max, NB, L,
                 dest.data_ptr(), bags.data_ptr(), idx.device.index,
                 torch.cuda.current_stream(idx.device).cuda_stream)
        _build.check("scatter_prep", err, "scatter_labels")
        scatter_labels.launches += 1
    return dest, bags


scatter_labels.launches = 0  # kernel launches (counted only where launched)


def run_table_plain(sd: torch.Tensor, n_rows: int
                    ) -> tuple[torch.Tensor, ...]:
    """Plain PyTorch version of the run-table kernels: from (E >= 1,) int32
    slot-sorted labels, ``(run_of, run_starts, run_slot, n_run)`` as
    ``scatter_run_metadata`` gives them with ``n_runs_pad = E``, computed as
    the kernels do: a run starts at each live entry (``sd < n_rows``) whose
    label differs from its predecessor's (-1 before the first); run_of is
    the inclusive count of starts less one, at least 0; each start's
    position and label go to its run's place; every dead place r >= n_run
    holds n_valid and the slot ``min(sd[min(n_valid, E - 1)], n_rows - 1)``.
    """
    E = sd.shape[0]
    live = sd < n_rows
    prev = torch.cat([sd.new_full((1,), -1), sd[:-1]])
    new_run = (sd != prev) & live
    upto = torch.cumsum(new_run, 0)
    n_valid = live.sum().to(torch.int32)
    place = upto[new_run] - 1
    run_starts = n_valid.expand(E + 1).clone()
    run_starts[place] = torch.nonzero(new_run).reshape(-1).to(torch.int32)
    dead = torch.clamp(sd[torch.clamp(n_valid, max=E - 1).long()],
                       max=n_rows - 1)
    run_slot = dead.expand(E).clone()
    run_slot[place] = torch.clamp(sd[new_run], max=n_rows - 1)
    return (torch.clamp(upto - 1, min=0).to(torch.int32), run_starts,
            run_slot, upto[-1:].to(torch.int32))


def _no_runs(bags: torch.Tensor) -> ScatterRuns:
    """The runs of no entries."""
    z = torch.zeros((2,), dtype=torch.int32, device=bags.device)
    return ScatterRuns(bags.to(torch.int32), z, z[:1], z[:1], z[:1])


def scatter_runs_plain(dest: torch.Tensor, bags: torch.Tensor,
                       n_rows: int) -> ScatterRuns:
    """Plain PyTorch version of ``scatter_runs``: a stable sort of the
    (dest, bag) pairs by dest, then ``run_table_plain``."""
    if dest.shape[0] == 0:
        return _no_runs(bags)
    sd, perm = torch.sort(dest, stable=True)
    run_of, run_starts, run_slot, n_run = run_table_plain(sd, n_rows)
    return ScatterRuns(bags[perm].to(torch.int32), run_starts, run_slot,
                       n_run, run_of)


def scatter_runs(dest: torch.Tensor, bags: torch.Tensor, n_rows: int,
                 end_bit: int = 32) -> ScatterRuns:
    """Steps 2 and 3 of the prep: entries labelled (dest, bag), each (E,)
    int32, sorted stably by dest into runs (``scatter_run_metadata``'s five
    arrays with one run slot per entry). CPU tensors take the plain
    version. CUDA tensors run ``csrc/scatter_prep.cu`` (counted on
    ``scatter_runs.launches``): CUB's key-value radix sort on the low
    ``end_bit`` bits of dest (every dest must lie in [0, 2**end_bit) when
    ``end_bit < 32``), then the run table; the sort runs in place over
    ``dest`` and ``bags``, so the caller gives up both. Nothing waits for
    the device: the scratch is sized from E alone and n_run stays there."""
    if dest.device.type == "cpu":
        return scatter_runs_plain(dest, bags, n_rows)
    if dest.device.type != "cuda":
        raise ValueError(f"scatter_runs: unsupported device {dest.device}")
    E = dest.shape[0]
    for name, t in (("dest", dest), ("bags", bags)):
        if (t.dtype != torch.int32 or t.shape != (E,) or t.device != dest.device
                or not t.is_contiguous()):
            raise ValueError(f"scatter_runs: {name} must be contiguous (E,) "
                             f"int32 on {dest.device}")
    if E >= 2**31 or not 0 <= n_rows < 2**31 or not 1 <= end_bit <= 32:
        raise ValueError(f"scatter_runs: {E} entries, n_rows {n_rows}, "
                         f"end_bit {end_bit}")
    if E == 0:
        return _no_runs(bags)
    dev = dest.device
    size = ctypes.c_int64()
    err = _build.function("scatter_prep", "scatter_prep_scratch",
                          [_I, _I, _P])(E, end_bit, ctypes.byref(size))
    _build.check("scatter_prep", err, "scatter_runs")
    dest_alt, bags_alt = torch.empty_like(dest), torch.empty_like(bags)
    scratch = torch.empty(size.value, dtype=torch.uint8, device=dev)
    run_of = torch.empty(E, dtype=torch.int32, device=dev)
    run_starts = torch.empty(E + 1, dtype=torch.int32, device=dev)
    run_slot = torch.empty(E, dtype=torch.int32, device=dev)
    n_run = torch.empty(1, dtype=torch.int32, device=dev)
    sel = ctypes.c_int()
    fn = _build.function("scatter_prep", "scatter_prep_runs",
                         [_P, _P, _P, _P, _I, _I, _I, _P, ctypes.c_int64, _P,
                          _P, _P, _P, _P, _I, _P])
    err = fn(dest.data_ptr(), dest_alt.data_ptr(), bags.data_ptr(),
             bags_alt.data_ptr(), E, n_rows, end_bit, scratch.data_ptr(),
             size.value, run_of.data_ptr(), run_starts.data_ptr(),
             run_slot.data_ptr(), n_run.data_ptr(), ctypes.byref(sel),
             dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check("scatter_prep", err, "scatter_runs")
    scatter_runs.launches += 1
    return ScatterRuns(bags_alt if sel.value else bags, run_starts, run_slot,
                       n_run, run_of)


scatter_runs.launches = 0   # sort + run table launches (where launched)


def _runs(dest: torch.Tensor, bags: torch.Tensor, n_rows: int,
          plain: bool = False) -> ScatterRuns:
    """Entries labelled (dest, bag), in the order their cotangents are
    added, sorted into runs (one run slot per entry at most): on CUDA
    tensors by ``scatter_runs`` (which takes ``dest`` and ``bags`` over),
    else, or with ``plain``, op by op (``scatter_run_metadata``)."""
    if dest.shape[0] == 0:
        return _no_runs(bags)
    if dest.is_cuda and not plain:
        return scatter_runs(dest, bags, n_rows)
    bag_sorted, run_of, run_starts, run_slot, n_run = scatter_run_metadata(
        dest, bags, n_rows, dest.shape[0])
    return ScatterRuns(bag_sorted, run_starts, run_slot, n_run, run_of)


def scatter_prep(idx: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
                 off: torch.Tensor, my: int, n_rows: int,
                 k_max: int = 1, plain: bool = False) -> ScatterRuns:
    """The backward's prep on the ids' device: label each entry with its
    destination slot (its bag's replica column when ``k_max > 1``), sort
    into runs (one run slot per entry at most). CUDA tensors take the
    card's three steps (``scatter_labels``, ``scatter_runs`` on the labels'
    bits); CPU and meta tensors, or ``plain``, the op-by-op prep. Both give
    the same bits."""
    if idx.is_cuda and not plain:
        return scatter_runs(*scatter_labels(idx, bank, slot, off, my, n_rows,
                                            k_max), n_rows, label_bits(n_rows))
    return _runs(*scatter_entries(idx, bank, slot, off, my, n_rows, k_max),
                 n_rows, plain=True)


def csr_scatter_prep(indices: torch.Tensor, seg: torch.Tensor,
                     bank: torch.Tensor, slot: torch.Tensor, my: int,
                     n_rows: int, plain: bool = False) -> ScatterRuns:
    """The CSR backward's prep (the reference's ``ct_scatter_csr_pallas``):
    each stream entry labelled ``dest_slots(raw, raw >= 0, ...)`` with its
    bag ``seg[e]``, in stream order, which the stable sort keeps inside each
    run; sorted as ``_runs`` does (a copy of ``seg`` on the card, where the
    sort runs in place)."""
    valid = indices >= 0
    row = torch.where(valid, indices, 0).long()
    card = indices.is_cuda and not plain
    return _runs(dest_slots(row, valid, bank, slot, my, n_rows),
                 seg.to(torch.int32, copy=card), n_rows, plain=plain)


def identity_scatter_prep(idx: torch.Tensor, n_rows: int,
                          plain: bool = False) -> ScatterRuns:
    """The identity layout's prep (``kernels/ops.embedding_bag_trainable``):
    entry ``e = bag * L + j`` (bag-major, the flattened order of the
    reference's ``.at[safe].add(updates)``) lands on row ``raw`` if ``raw >=
    0``, else nowhere (the sentinel ``n_rows``, as is any id past the
    table, which the reference's scatter drops); sorted as ``_runs``
    does."""
    NB, L = idx.shape
    raw = idx.reshape(-1)
    dest = torch.where(raw >= 0, raw, n_rows).to(torch.int32)
    bags = torch.arange(NB * L, device=idx.device) // max(L, 1)
    return _runs(dest, bags.to(torch.int32), n_rows, plain=plain)


def ct_scatter_runs_plain(ct: torch.Tensor, runs: ScatterRuns,
                          out: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: sum each run of ``ct`` rows in
    fp32 in entry order and write it, cast, into ``out`` (zeros) at the
    run's slot. No ``index_add_``: on a card it adds duplicates in no fixed
    order. Runs are walked by rank instead: step k adds the k-th entry of
    every run that has one (runs sorted longest first, so they are a
    prefix), and within a step no two rows share an accumulator. The loop
    runs as often as the longest run is long."""
    n = int(runs.n_run[0])
    if n == 0:
        return out
    starts = runs.run_starts[:n].long()
    order, live = _by_rank(runs.run_starts[1:n + 1].long() - starts)
    starts = starts[order]
    ctf = ct.float()
    acc = torch.zeros((n, ct.shape[-1]), dtype=torch.float32,
                      device=ct.device)
    for k, m in enumerate(live):
        acc[:m] += ctf[runs.bag_sorted[starts[:m] + k].long()]
    out[runs.run_slot[:n][order].long()] = acc.to(out.dtype)
    return out


def ct_scatter_bag_plain(ct: torch.Tensor, idx: torch.Tensor,
                         bank: torch.Tensor, slot: torch.Tensor,
                         off: torch.Tensor, my: int, n_rows: int,
                         out_dtype=None, k_max: int = 1) -> torch.Tensor:
    """Plain PyTorch version of ``ct_scatter_bag``: the op-by-op prep, a
    zero table, ``ct_scatter_runs_plain``. Deterministic on any device."""
    out = torch.zeros((n_rows, ct.shape[-1]), dtype=out_dtype or ct.dtype,
                      device=ct.device)
    return ct_scatter_runs_plain(
        ct, scatter_prep(idx, bank, slot, off, my, n_rows, k_max, plain=True),
        out)


def ct_scatter_launch(ct: torch.Tensor, runs: ScatterRuns,
                      out: torch.Tensor) -> torch.Tensor:
    """Launch the scatter alone, as one step of the current stream (the
    tiles of short runs on it, the span blocks of long runs on a side
    stream it forks and joins): each live run of ``runs`` summed from
    ``ct`` (NB, D) and written into ``out`` (n_rows, D), which must hold
    zeros. ``ct`` and ``out`` each are fp32 or bf16, independently: the
    kernel reads ``ct`` in its own dtype and casts the fp32 sum once to
    ``out``'s. Counts the launch on ``ct_scatter_bag.launches``. On meta
    tensors: ``out`` as it is, the kernel's cost reported."""
    if ct.dtype not in _DTYPES or out.dtype not in _DTYPES:
        raise TypeError(f"ct_scatter_bag: ct {ct.dtype}, out {out.dtype} "
                        f"(each float32 or bfloat16)")
    if ct.dim() != 2 or out.dim() != 2 or out.shape[1] != ct.shape[1]:
        raise ValueError(f"ct_scatter_bag: ct {tuple(ct.shape)}, out "
                         f"{tuple(out.shape)}")
    for name, t in (("ct", ct), ("out", out), *zip(runs._fields, runs)):
        if t.device != ct.device or not t.is_contiguous():
            raise ValueError(f"ct_scatter_bag: {name} must be contiguous on "
                             f"{ct.device}")
        if name in runs._fields and t.dtype != torch.int32:
            raise TypeError(f"ct_scatter_bag: {name} must be int32")
    E = runs.bag_sorted.shape[0]
    if (runs.run_starts.shape[0] != runs.run_slot.shape[0] + 1
            or runs.run_slot.shape[0] < E or runs.n_run.shape[0] != 1
            or runs.run_of.shape[0] != max(E, 1)):
        raise ValueError(f"ct_scatter_bag: runs of shapes "
                         f"{[tuple(t.shape) for t in runs]}")
    if ct.device.type == "meta":
        _charge("ct_scatter_bag", _cost.meta_scatter_cost(
            ct.shape[0], ct.shape[1], ct.element_size(), out.element_size(),
            n_entries=E, n_out_rows=out.shape[0]))
        return out
    fn = _build.function("ct_scatter", "ct_scatter_runs",
                         [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                          _P])
    err = fn(ct.data_ptr(), _DTYPES[ct.dtype], runs.bag_sorted.data_ptr(),
             runs.run_starts.data_ptr(), runs.run_slot.data_ptr(),
             runs.run_of.data_ptr(), runs.n_run.data_ptr(), out.data_ptr(),
             _DTYPES[out.dtype], runs.run_slot.shape[0],
             runs.run_of.shape[0], ct.shape[1], ct.device.index,
             torch.cuda.current_stream(ct.device).cuda_stream)
    _build.check("ct_scatter", err, "ct_scatter_bag")
    ct_scatter_bag.launches += 1
    return out


def ct_scatter_bag(ct: torch.Tensor, idx: torch.Tensor, bank: torch.Tensor,
                   slot: torch.Tensor, off: torch.Tensor, my: int,
                   n_rows: int, out_dtype=None,
                   k_max: int = 1) -> torch.Tensor:
    """Transpose of ``banked_bag``: ct (NB, D) f32/bf16 cotangent rows; idx
    (NB, L) int32 the forward's ids; bank, slot (V * k_max,) int32; off (F,)
    int32; my and ``k_max`` as in the forward -> d_table (n_rows, D) in
    ``out_dtype`` (default ct's), zero where no entry lands. ``ct`` is
    summed in fp32 as it is and cast once to ``out_dtype``, on every path.
    With ``k_max > 1`` every copy of a row gets the cotangents of the bags
    it served; the kernel is the same, only the prep changes.

    CPU tensors take ``ct_scatter_bag_plain``. CUDA tensors run the prep's
    three steps on the card (``scatter_labels``, ``scatter_runs``; the
    stage span ``lookup.prep``), zero the output and launch the kernel, or
    raise: there is no fallback. Meta tensors run the prep and the zero
    fill op by op and report the kernel's cost.
    """
    out_dtype = out_dtype or ct.dtype
    if k_max < 1 or bank.shape[0] % k_max:
        raise ValueError(f"ct_scatter_bag: k_max {k_max} with a remap of "
                         f"{bank.shape[0]} entries")
    if ct.device.type == "cpu":
        return ct_scatter_bag_plain(ct, idx, bank, slot, off, my, n_rows,
                                    out_dtype, k_max)
    if ct.device.type not in ("cuda", "meta"):
        raise ValueError(f"ct_scatter_bag: unsupported device {ct.device}")
    _check_args("ct_scatter_bag", ct, bank, slot, off, idx)
    if idx.shape[0] != ct.shape[0]:
        raise ValueError(f"ct_scatter_bag: ct {tuple(ct.shape)} for idx "
                         f"{tuple(idx.shape)}")
    with stage("lookup.prep", like=ct):
        runs = scatter_prep(idx, bank, slot, off, my, n_rows, k_max)
    out = torch.zeros((n_rows, ct.shape[1]), dtype=out_dtype,
                      device=ct.device)
    return ct_scatter_launch(ct, runs, out)


ct_scatter_bag.launches = 0  # kernel launches (counted only where launched)


def _scatter_on(runs: ScatterRuns, ct: torch.Tensor, n_rows: int, out_dtype,
                kernel: bool) -> torch.Tensor:
    """A zero (n_rows, D) table in ``out_dtype`` (default ct's) with the runs
    summed into it: by the kernel (``ct_scatter_launch``, CUDA only) or by
    ``ct_scatter_runs_plain``."""
    out = torch.zeros((n_rows, ct.shape[-1]), dtype=out_dtype or ct.dtype,
                      device=ct.device)
    if kernel:
        return ct_scatter_launch(ct, runs, out)
    return ct_scatter_runs_plain(ct, runs, out)


def _scatter_kernel(what: str, ct: torch.Tensor) -> bool:
    """Whether a scatter wrapper launches the kernel: CUDA tensors do (meta
    tensors report its cost), CPU tensors take the plain version, anything
    else raises."""
    if ct.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{what}: unsupported device {ct.device}")
    return ct.device.type != "cpu"


def ct_scatter_csr_plain(ct: torch.Tensor, indices: torch.Tensor,
                         seg: torch.Tensor, bank: torch.Tensor,
                         slot: torch.Tensor, my: int, n_rows: int,
                         out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of ``ct_scatter_csr``: the CSR prep op by op,
    a zero table, ``ct_scatter_runs_plain``. Deterministic on any
    device."""
    return _scatter_on(csr_scatter_prep(indices, seg, bank, slot, my, n_rows,
                                        plain=True),
                       ct, n_rows, out_dtype, kernel=False)


def ct_scatter_csr(ct: torch.Tensor, indices: torch.Tensor, seg: torch.Tensor,
                   bank: torch.Tensor, slot: torch.Tensor, my: int,
                   n_rows: int, out_dtype=None) -> torch.Tensor:
    """Transpose of ``csr_bag``: ct (NB, D) f32/bf16 bag cotangents;
    indices, seg (T,) the forward's stream and each entry's bag; bank, slot
    (V,) int32; my as in the forward -> d_table (n_rows, D) in
    ``out_dtype`` (default ct's), zero where no entry lands; each run summed
    in fp32 in stream order and cast once.

    CPU tensors take ``ct_scatter_csr_plain``. CUDA tensors label op by op,
    sort into runs on the card (``scatter_runs``), zero the output and
    launch ``csrc/ct_scatter.cu`` (counted on ``ct_scatter_bag.launches``),
    or raise: there is no fallback.
    """
    kernel = _scatter_kernel("ct_scatter_csr", ct)
    if kernel and not (indices.dim() == 1 and indices.shape == seg.shape):
        raise ValueError(f"ct_scatter_csr: indices {tuple(indices.shape)}, "
                         f"seg {tuple(seg.shape)}")
    return _scatter_on(csr_scatter_prep(indices, seg, bank, slot, my, n_rows),
                       ct, n_rows, out_dtype, kernel=kernel)


def ct_scatter_identity_plain(ct: torch.Tensor, idx: torch.Tensor,
                              n_rows: int, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of ``ct_scatter_identity``: the identity prep
    op by op, a zero table, ``ct_scatter_runs_plain``."""
    return _scatter_on(identity_scatter_prep(idx, n_rows, plain=True), ct,
                       n_rows, out_dtype, kernel=False)


def ct_scatter_identity(ct: torch.Tensor, idx: torch.Tensor, n_rows: int,
                        out_dtype=None) -> torch.Tensor:
    """Transpose of ``plain_bag``: ct (B, D) f32/bf16, idx (B, L) int32 the
    forward's rows -> d_table (n_rows, D) in ``out_dtype`` (default ct's):
    each row's cotangents added in fp32, bag-major, and cast once.

    CPU tensors take ``ct_scatter_identity_plain``. CUDA tensors label op
    by op, sort into runs on the card (``scatter_runs``) and launch
    ``csrc/ct_scatter.cu`` (counted on ``ct_scatter_bag.launches``), or
    raise: there is no fallback.
    """
    kernel = _scatter_kernel("ct_scatter_identity", ct)
    if kernel and (idx.dim() != 2 or idx.shape[0] != ct.shape[0]):
        raise ValueError(f"ct_scatter_identity: ct {tuple(ct.shape)} for idx "
                         f"{tuple(idx.shape)}")
    return _scatter_on(identity_scatter_prep(idx, n_rows), ct, n_rows,
                       out_dtype, kernel=kernel)
