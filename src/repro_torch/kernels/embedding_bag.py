"""Banked embedding-bag sums: the CUDA kernel's wrapper and its plain
version (the port of ``repro/kernels/embedding_bag.py``'s
``banked_embedding_bag_pallas`` / ``_banked_bag_kernel``).

For every bag b of an (NB, L) stream of per-field ids padded with -1, entry
j contributes ``table[slot[row]]`` with ``row = raw + off[b % F]`` when
``raw >= 0`` and (``my < 0`` or ``bank[row] == my``). The sum is fp32 in
entry order and is cast to the table's dtype once, so the kernel
(``csrc/banked_bag.cu``) and the plain version agree bit for bit.

Only the single-copy (``k_max == 1``) path is here; the replicated table's
replica select is a later slice.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


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
    if table.dtype not in _DTYPES:
        raise TypeError(f"banked_bag: table dtype {table.dtype} "
                        f"(float32 or bfloat16)")
    if table.dim() != 2 or idx.dim() != 2 or off.dim() != 1 \
            or off.shape[0] < 1:
        raise ValueError(f"banked_bag: shapes table {tuple(table.shape)}, "
                         f"idx {tuple(idx.shape)}, off {tuple(off.shape)}")
    if bank.shape != slot.shape or bank.dim() != 1:
        raise ValueError(f"banked_bag: bank {tuple(bank.shape)} and slot "
                         f"{tuple(slot.shape)} must be the same (V,)")
    for name, t in (("bank", bank), ("slot", slot), ("off", off),
                    ("idx", idx)):
        if t.dtype != torch.int32:
            raise TypeError(f"banked_bag: {name} must be int32, got {t.dtype}")
    for name, t in (("table", table), ("bank", bank), ("slot", slot),
                    ("off", off), ("idx", idx)):
        if t.device != table.device:
            raise ValueError(f"banked_bag: {name} on {t.device}, table on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError(f"banked_bag: {name} is not contiguous")
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
