"""Rank side of ``test_torch_dist_gat.py``: GAT's edge-sharded losses on a
1 x 4 and a 2 x 2 grid of the same four gloo ranks. Only torch, numpy and
the port are imported here, so a spawned rank starts without JAX; the
test holds the outputs against the reference's single-device results in
its own process. Inputs are ``case.<name>.<key>`` (the whole batch),
``p.<name>.<layer>.<leaf>`` (the params) and ``cfg.<name>`` (shape id,
d_feat, n_classes); outputs ``<grid>.<name>.<what>``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.embedding import DistCtx
from repro_torch.dist import sharding as SH
from repro_torch.models import gat as G
from repro_torch.train import optim as O
from repro_torch.train import train_step as TS

GRIDS = {"1x4": (1, 4), "2x2": (2, 2)}
LEAVES = ("a_dst", "a_src", "w")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def cases(inp) -> list[str]:
    return sorted({k.split(".")[1] for k in inp if k.startswith("cfg.")})


def case(inp, name: str):
    """(shape id, port cfg, whole batch, params) of case ``name``."""
    shape, d_feat, n_classes = (str(x) for x in inp[f"cfg.{name}"])
    cfg = dataclasses.replace(get_arch("gat-cora").reduced,
                              d_feat=int(d_feat), n_classes=int(n_classes))
    pre = f"case.{name}."
    batch = {k[len(pre):]: _t(v) for k, v in inp.items()
             if k.startswith(pre)}
    n_layers = len({k.split(".")[2] for k in inp
                    if k.startswith(f"p.{name}.")})
    params = {"layers": [{k: _t(inp[f"p.{name}.{i}.{k}"]) for k in LEAVES}
                         for i in range(n_layers)]}
    return shape, cfg, batch, params


def _grads(loss_fn, params):
    leaves = [p.detach().requires_grad_(True) for p in O.tree_leaves(params)]
    loss = loss_fn(O.tree_unflatten(params, leaves))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def gat_grids(rank: int, world: int, inp) -> dict:
    out = {}
    for grid, (data, model) in GRIDS.items():
        dist = DistCtx.create(data, model, device="cpu")
        for name in cases(inp):
            shape, cfg, batch, params = case(inp, name)
            piece, ctx = SH.gnn_batch_shardings(dist, batch)
            loss_fn = G.cell_loss(shape)
            loss, grads = _grads(lambda p: loss_fn(cfg, p, piece, ctx),
                                 params)
            key = f"{grid}.{name}"
            out[f"{key}.loss"] = loss[None]
            out[f"{key}.edges"] = torch.tensor(
                [v.shape[0] for k, v in sorted(piece.items())
                 if SH.is_edge_key(k)])
            for (path, _), g in zip(O.tree_flatten_with_path(params),
                                    grads):
                out[f"{key}.grad{path}"] = g
            # one train step under the grid (SGD at lr 1): the update is
            # minus the gradient the step used, which the dp mean must
            # leave as one device's
            step = TS.build_train_step(
                lambda p, b, dist=None: loss_fn(cfg, p, b, dist),
                O.sgd(1.0), clip_norm=None, dist=ctx)
            state, m = step(TS.TrainState.create(params, O.sgd(1.0)), piece)
            out[f"{key}.step_loss"] = m["loss"][None]
            for (path, p0), p1 in zip(O.tree_flatten_with_path(params),
                                      O.tree_leaves(state.params)):
                out[f"{key}.step{path}"] = p0 - p1
    return out
