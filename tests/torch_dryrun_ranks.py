"""Rank side of ``tests/test_torch_dryrun.py``'s collective-bytes case
(torch only): one reduced ``updlrm-paper`` train cell, built by
``launch/cells`` on a real ``DistCtx`` over a 2 x 2 gloo grid, its meta
arguments made real (zeros on the CPU: every id row 0, every remap bank 0
and slot 0, so every shape is the cell's), one step run, and the operand
bytes of every ``torch.distributed`` all-reduce and all-gather the step
makes, by the reference's collective kinds."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.configs import get_arch
from repro_torch.core.embedding import DistCtx
from repro_torch.launch.cells import _recsys_cell
from repro_torch.train.train_step import TrainState

ARCH, SHAPE, BATCH = "updlrm-paper", "train_batch", 8
GRID = (2, 2)


def reduced_cell(dist):
    """The reduced train cell (batch BATCH) on ``dist``'s grid."""
    cfg = get_arch(ARCH).reduced
    meta = torch.device("meta")
    batch = {"dense": torch.empty((BATCH, cfg.n_dense), device=meta),
             "sparse": torch.empty((BATCH, cfg.n_sparse, cfg.multi_hot),
                                   dtype=torch.int32, device=meta),
             "label": torch.empty((BATCH,), device=meta)}
    return _recsys_cell(ARCH, SHAPE, dist, dist.n_banks, cfg_override=cfg,
                        batch_override=batch)


def real(tree):
    """A tree of meta tensors as zeros on the CPU (ints and the rest as
    they are)."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype)
    if isinstance(tree, TrainState):
        return TrainState(*(real(getattr(tree, f.name))
                            for f in dataclasses.fields(tree)))
    if isinstance(tree, dict):
        return {k: real(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(real(x) for x in tree)
    return tree


def collective_bytes(rank: int, world: int, inputs) -> dict:
    dist = DistCtx.create(*GRID, device="cpu")
    cell = reduced_cell(dist)
    args = real(cell.args)
    moved = {"all-reduce": 0, "all-gather": 0}
    all_reduce, all_gather = tdist.all_reduce, tdist.all_gather

    def counted_all_reduce(t, *a, **kw):
        moved["all-reduce"] += t.numel() * t.element_size()
        return all_reduce(t, *a, **kw)

    def counted_all_gather(parts, t, *a, **kw):
        moved["all-gather"] += t.numel() * t.element_size()
        return all_gather(parts, t, *a, **kw)

    tdist.all_reduce, tdist.all_gather = counted_all_reduce, \
        counted_all_gather
    try:
        _, metrics = cell.fn(*args)
    finally:
        tdist.all_reduce, tdist.all_gather = all_reduce, all_gather
    return {"all_reduce": np.array([moved["all-reduce"]]),
            "all_gather": np.array([moved["all-gather"]]),
            "loss": metrics["loss"].numpy()[None]}
