"""Banked embedding-bag sums, the fused cache + residual bag sums, the
tiered-precision bag sums, and the bag sums' transpose: the CUDA kernels'
wrappers and their plain versions (the port of
``repro/kernels/embedding_bag.py``'s ``banked_embedding_bag_pallas`` /
``_banked_bag_kernel``, ``fused_cache_bag_pallas`` /
``_fused_cache_bag_kernel``, ``tiered_embedding_bag_pallas`` /
``_tiered_bag_kernel`` and ``ct_scatter_bag_pallas`` /
``_ct_scatter_kernel``).

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

Tiered (``csrc/tiered_bag.cu`` and ``tiered_bag_plain``). The table is the
quant package's ``(R, row_bytes)`` int8 payload with per-row fp32 scales and
tier codes; each live entry's row is dequantized to fp32 by its tier (an
exact bitcast of the hot tier's bf16/fp32 bits, ``float(q) * scale`` for
int8 and packed int4) and added in entry order; the output is fp32. Each
quantized value is one rounded multiply followed by one rounded add, on
both paths, so they agree bit for bit, and with the reference's jnp scan.

Backward. The same entries, enumerated j-major (``e = j * NB + bag``), each
drag cotangent row ``ct[bag]`` onto table slot ``slot[row]``. A stable sort
by slot groups them into per-slot runs that keep entry order
(``scatter_run_metadata``); each run is summed in fp32 and written once,
cast to the table's dtype, over a zero table. Every other row is exactly
zero. The kernel (``csrc/ct_scatter.cu``) and the plain version add in the
same order and agree bit for bit; neither uses atomics.

The cotangent and the gradient table each have their own dtype; ``ct`` is
summed in fp32 as it is and cast once.

Only the single-copy (``k_max == 1``) path is here; the replicated table's
replica select is a later slice.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.quant.quantize import dequant_rows_f32

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_args(what: str, table_like: torch.Tensor, bank: torch.Tensor,
                slot: torch.Tensor, off: torch.Tensor,
                idx: torch.Tensor) -> None:
    """The checks both kernels' wrappers make before a launch."""
    if table_like.dtype not in _DTYPES:
        raise TypeError(f"{what}: dtype {table_like.dtype} "
                        f"(float32 or bfloat16)")
    if table_like.dim() != 2 or idx.dim() != 2 or off.dim() != 1 \
            or off.shape[0] < 1:
        raise ValueError(f"{what}: shapes {tuple(table_like.shape)}, "
                         f"idx {tuple(idx.shape)}, off {tuple(off.shape)}")
    if bank.shape != slot.shape or bank.dim() != 1:
        raise ValueError(f"{what}: bank {tuple(bank.shape)} and slot "
                         f"{tuple(slot.shape)} must be the same (V,)")
    for name, t in (("bank", bank), ("slot", slot), ("off", off),
                    ("idx", idx)):
        if t.dtype != torch.int32:
            raise TypeError(f"{what}: {name} must be int32, got {t.dtype}")
        if t.device != table_like.device:
            raise ValueError(f"{what}: {name} on {t.device}, rows on "
                             f"{table_like.device}")
    for name, t in (("rows", table_like), ("bank", bank), ("slot", slot),
                    ("off", off), ("idx", idx)):
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")


def banked_bag_plain(table: torch.Tensor, bank: torch.Tensor,
                     slot: torch.Tensor, off: torch.Tensor, my: int,
                     idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over j that mirrors the reference's
    ``_bag_partial_scan`` step for step (one (NB, D) gather per entry
    column, fp32 accumulator, one cast at the end)."""
    NB, L = idx.shape
    n = torch.arange(NB, device=idx.device)
    offs = off.long()[n % off.shape[0]]
    acc = torch.zeros((NB, table.shape[-1]), dtype=torch.float32,
                      device=table.device)
    for j in range(L):
        raw = idx[:, j].long()
        valid = raw >= 0
        row = torch.where(valid, raw + offs, 0)
        mine = valid if my < 0 else valid & (bank[row] == my)
        rows = table[torch.where(mine, slot[row].long(), 0)]
        acc = acc + torch.where(mine[:, None], rows, 0).float()
    return acc.to(table.dtype)


def banked_bag(table: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
               off: torch.Tensor, my: int, idx: torch.Tensor) -> torch.Tensor:
    """table (R, D) f32/bf16; bank, slot (V,) int32; off (F,) int32; my
    (< 0 owns every row); idx (NB, L) int32, -1 padded -> (NB, D).

    CPU tensors take ``banked_bag_plain``. CUDA tensors launch the kernel on
    the current stream, or raise: there is no fallback.
    """
    if table.device.type == "cpu":
        return banked_bag_plain(table, bank, slot, off, my, idx)
    if table.device.type != "cuda":
        raise ValueError(f"banked_bag: unsupported device {table.device}")
    _check_args("banked_bag", table, bank, slot, off, idx)
    NB, L = idx.shape
    D = table.shape[1]
    out = torch.empty((NB, D), dtype=table.dtype, device=table.device)
    fn = _build.function("banked_bag", "banked_bag_forward",
                         [_P, _I, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
                          _P])
    err = fn(table.data_ptr(), _DTYPES[table.dtype], bank.data_ptr(),
             slot.data_ptr(), off.data_ptr(), off.shape[0], int(my),
             idx.data_ptr(), out.data_ptr(), NB, L, D, table.device.index,
             torch.cuda.current_stream(table.device).cuda_stream)
    _build.check("banked_bag", err, "banked_bag")
    banked_bag.launches += 1
    return out


banked_bag.launches = 0     # kernel launches (counted only where launched)


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


def _stream_plain(acc: torch.Tensor, table: torch.Tensor, bank: torch.Tensor,
                  slot: torch.Tensor, my: int, idx: torch.Tensor) -> None:
    """Add one -1 padded stream into ``acc`` in entry order, each bag up to
    its effective length (the loop runs to the batch's longest)."""
    n = int(effective_lengths(idx).max()) if idx.numel() else 0
    for j in range(n):
        raw = idx[:, j].long()
        valid = raw >= 0
        row = torch.where(valid, raw, 0)
        mine = valid if my < 0 else valid & (bank[row] == my)
        rows = table[torch.where(mine, slot[row].long(), 0)]
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
                       residual_idx: torch.Tensor) -> torch.Tensor:
    """emt (R, D) and cache (Rc, D) f32/bf16; emt_bank/emt_slot (V,) and
    cache_bank/cache_slot (Vc,) int32; my (< 0 owns every row); cache_idx
    (NB, Lc) and residual_idx (NB, Lr) int32, -1 padded -> (NB, D) in the
    EMT's dtype = Σ cached partial sums + Σ residual rows.

    CPU tensors take ``cache_residual_bag_plain``. CUDA tensors launch the
    kernel on the current stream, or raise: there is no fallback.
    """
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
    out = torch.empty((NB, D), dtype=emt.dtype, device=emt.device)
    fn = _build.function("cache_bag", "cache_bag_forward",
                         [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I,
                          _I, _I, _I, _P])
    err = fn(emt.data_ptr(), cache.data_ptr(), _DTYPES[emt.dtype],
             emt_bank.data_ptr(), emt_slot.data_ptr(), cache_bank.data_ptr(),
             cache_slot.data_ptr(), int(my), cache_idx.data_ptr(),
             residual_idx.data_ptr(), out.data_ptr(), NB, Lc, Lr, D,
             emt.device.index, torch.cuda.current_stream(emt.device).cuda_stream)
    _build.check("cache_bag", err, "cache_residual_bag")
    cache_residual_bag.launches += 1
    return out


cache_residual_bag.launches = 0  # kernel launches (counted only where launched)


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
    on the current stream, or raise: there is no fallback.
    """
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


def dest_slots(row: torch.Tensor, valid: torch.Tensor, bank: torch.Tensor,
               slot: torch.Tensor, my: int, n_rows: int) -> torch.Tensor:
    """An entry scatters iff it is valid and owned (``my < 0`` owns every
    row), onto ``slot[row]``; every other entry gets the out-of-range
    sentinel ``n_rows``, which sorts it out of every run."""
    mine = valid if my < 0 else valid & (bank[row] == my)
    return torch.where(mine, slot[row], n_rows).to(torch.int32)


def scatter_entries(idx: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
                    off: torch.Tensor, my: int, n_rows: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(dest, bags), each (NB * L,) int32, for the entries of an (NB, L) id
    stream enumerated j-major (``e = j * NB + bag``), the order in which the
    reference's scan over L adds them."""
    NB, L = idx.shape
    e = torch.arange(NB * L, device=idx.device)
    bag = e % NB
    raw = idx.t().reshape(-1).long()
    valid = raw >= 0
    row = torch.where(valid, raw + off.long()[bag % off.shape[0]], 0)
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


def scatter_prep(idx: torch.Tensor, bank: torch.Tensor, slot: torch.Tensor,
                 off: torch.Tensor, my: int, n_rows: int) -> ScatterRuns:
    """The backward's prep on the ids' device: label each entry with its
    destination slot, sort into runs (one run slot per entry at most)."""
    dest, bags = scatter_entries(idx, bank, slot, off, my, n_rows)
    if dest.shape[0] == 0:
        z = torch.zeros((2,), dtype=torch.int32, device=idx.device)
        return ScatterRuns(bags, z, z[:1], z[:1])
    bag_sorted, _, run_starts, run_slot, n_run = scatter_run_metadata(
        dest, bags, n_rows, dest.shape[0])
    return ScatterRuns(bag_sorted, run_starts, run_slot, n_run)


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
    lens = runs.run_starts[1:n + 1].long() - starts
    order = torch.argsort(lens, descending=True, stable=True)
    starts = starts[order]
    desc = lens[order].cpu().numpy()
    # live[k] = runs longer than k; desc is non-increasing
    live = n - np.searchsorted(desc[::-1], np.arange(int(desc[0])),
                               side="right")
    ctf = ct.float()
    acc = torch.zeros((n, ct.shape[-1]), dtype=torch.float32,
                      device=ct.device)
    for k, m in enumerate(live.tolist()):
        acc[:m] += ctf[runs.bag_sorted[starts[:m] + k].long()]
    out[runs.run_slot[:n][order].long()] = acc.to(out.dtype)
    return out


def ct_scatter_bag_plain(ct: torch.Tensor, idx: torch.Tensor,
                         bank: torch.Tensor, slot: torch.Tensor,
                         off: torch.Tensor, my: int, n_rows: int,
                         out_dtype=None) -> torch.Tensor:
    """Plain PyTorch version of ``ct_scatter_bag``: the same prep, a zero
    table, ``ct_scatter_runs_plain``. Deterministic on any device."""
    out = torch.zeros((n_rows, ct.shape[-1]), dtype=out_dtype or ct.dtype,
                      device=ct.device)
    return ct_scatter_runs_plain(
        ct, scatter_prep(idx, bank, slot, off, my, n_rows), out)


def ct_scatter_launch(ct: torch.Tensor, runs: ScatterRuns,
                      out: torch.Tensor) -> torch.Tensor:
    """Launch the scatter kernel alone on the current stream: each live run
    of ``runs`` summed from ``ct`` (NB, D) and written into ``out``
    (n_rows, D), which must hold zeros. ``ct`` and ``out`` each are fp32 or
    bf16, independently: the kernel reads ``ct`` in its own dtype and casts
    the fp32 sum once to ``out``'s. Counts the launch on
    ``ct_scatter_bag.launches``."""
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
    n_runs_pad = runs.run_slot.shape[0]
    fn = _build.function("ct_scatter", "ct_scatter_runs",
                         [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    err = fn(ct.data_ptr(), _DTYPES[ct.dtype], runs.bag_sorted.data_ptr(),
             runs.run_starts.data_ptr(), runs.run_slot.data_ptr(),
             runs.n_run.data_ptr(), out.data_ptr(), _DTYPES[out.dtype],
             n_runs_pad, ct.shape[1], ct.device.index,
             torch.cuda.current_stream(ct.device).cuda_stream)
    _build.check("ct_scatter", err, "ct_scatter_bag")
    ct_scatter_bag.launches += 1
    return out


def ct_scatter_bag(ct: torch.Tensor, idx: torch.Tensor, bank: torch.Tensor,
                   slot: torch.Tensor, off: torch.Tensor, my: int,
                   n_rows: int, out_dtype=None) -> torch.Tensor:
    """Transpose of ``banked_bag``: ct (NB, D) f32/bf16 cotangent rows; idx
    (NB, L) int32 the forward's ids; bank, slot (V,) int32; off (F,) int32;
    my as in the forward -> d_table (n_rows, D) in ``out_dtype`` (default
    ct's), zero where no entry lands. ``ct`` is summed in fp32 as it is and
    cast once to ``out_dtype``, on every path.

    CPU tensors take ``ct_scatter_bag_plain``. CUDA tensors run the prep
    on the card, zero the output and launch the kernel, or raise: there is
    no fallback.
    """
    out_dtype = out_dtype or ct.dtype
    if ct.device.type == "cpu":
        return ct_scatter_bag_plain(ct, idx, bank, slot, off, my, n_rows,
                                    out_dtype)
    if ct.device.type != "cuda":
        raise ValueError(f"ct_scatter_bag: unsupported device {ct.device}")
    _check_args("ct_scatter_bag", ct, bank, slot, off, idx)
    if idx.shape[0] != ct.shape[0]:
        raise ValueError(f"ct_scatter_bag: ct {tuple(ct.shape)} for idx "
                         f"{tuple(idx.shape)}")
    runs = scatter_prep(idx, bank, slot, off, my, n_rows)
    out = torch.zeros((n_rows, ct.shape[1]), dtype=out_dtype,
                      device=ct.device)
    return ct_scatter_launch(ct, runs, out)


ct_scatter_bag.launches = 0  # kernel launches (counted only where launched)
