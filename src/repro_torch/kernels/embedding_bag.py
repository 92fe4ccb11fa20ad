"""Banked embedding-bag sums and their transpose: the CUDA kernels'
wrappers and their plain versions (the port of
``repro/kernels/embedding_bag.py``'s ``banked_embedding_bag_pallas`` /
``_banked_bag_kernel`` and ``ct_scatter_bag_pallas`` /
``_ct_scatter_kernel``).

Forward. For every bag b of an (NB, L) stream of per-field ids padded with
-1, entry j contributes ``table[slot[row]]`` with ``row = raw + off[b % F]``
when ``raw >= 0`` and (``my < 0`` or ``bank[row] == my``). The sum is fp32
in entry order and is cast to the table's dtype once, so the kernel
(``csrc/banked_bag.cu``) and the plain version agree bit for bit.

Backward. The same entries, enumerated j-major (``e = j * NB + bag``), each
drag cotangent row ``ct[bag]`` onto table slot ``slot[row]``. A stable sort
by slot groups them into per-slot runs that keep entry order
(``scatter_run_metadata``); each run is summed in fp32 and written once,
cast to the table's dtype, over a zero table. Every other row is exactly
zero. The kernel (``csrc/ct_scatter.cu``) and the plain version add in the
same order and agree bit for bit; neither uses atomics.

Only the single-copy (``k_max == 1``) path is here; the replicated table's
replica select is a later slice.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels import _build

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
    (n_rows, D), which must hold zeros and shares ct's dtype. Counts the
    launch on ``ct_scatter_bag.launches``."""
    if ct.dtype not in _DTYPES or out.dtype != ct.dtype:
        raise TypeError(f"ct_scatter_bag: ct {ct.dtype}, out {out.dtype} "
                        f"(one of float32, bfloat16)")
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
                         [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P])
    err = fn(ct.data_ptr(), _DTYPES[ct.dtype], runs.bag_sorted.data_ptr(),
             runs.run_starts.data_ptr(), runs.run_slot.data_ptr(),
             runs.n_run.data_ptr(), out.data_ptr(), n_runs_pad, ct.shape[1],
             ct.device.index, torch.cuda.current_stream(ct.device).cuda_stream)
    _build.check("ct_scatter", err, "ct_scatter_bag")
    ct_scatter_bag.launches += 1
    return out


def ct_scatter_bag(ct: torch.Tensor, idx: torch.Tensor, bank: torch.Tensor,
                   slot: torch.Tensor, off: torch.Tensor, my: int,
                   n_rows: int, out_dtype=None) -> torch.Tensor:
    """Transpose of ``banked_bag``: ct (NB, D) f32/bf16 cotangent rows; idx
    (NB, L) int32 the forward's ids; bank, slot (V,) int32; off (F,) int32;
    my as in the forward -> d_table (n_rows, D) in ``out_dtype`` (default
    ct's), zero where no entry lands.

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
    return ct_scatter_launch(ct.to(out_dtype).contiguous(), runs, out)


ct_scatter_bag.launches = 0  # kernel launches (counted only where launched)
