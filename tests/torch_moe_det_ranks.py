"""Rank side of ``test_torch_moe_determinism.py``: ``moe_layer_sharded``'s
forward and backward, run twice from the same inputs on each rank of a
1 x 4 and a 2 x 2 grid of the same four gloo ranks, at 2 and at 8 CPU
threads, at fp32 and bf16. Only torch, numpy and the port are imported
here, so a spawned rank starts without JAX. Every output name is
``<grid>.<dtype>.t<threads>.r<run>.<array>``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.embedding import DistCtx
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L

GRIDS = {"1x4": (1, 4), "2x2": (2, 2)}
THREADS = (2, 8)
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
EXPERTS = ("w_gate", "w_up", "w_down")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _fwd_bwd(inp, dist, dtype) -> dict:
    """One forward and backward of this rank's dp slice through its own
    experts, against the fixed cotangent ``moe.ct``."""
    x = _t(inp["moe.x"]).to(dtype)
    d = dist.for_batch(x.shape[0])
    xs = x[d.dp_slice()].clone().requires_grad_(True)
    wr = _t(inp["moe.w_router"]).to(dtype).requires_grad_(True)
    w = {k: SH.lm_param_shardings(dist, {"layers": {
        k: _t(inp[f"moe.{k}"])[None].to(dtype)}})["layers"][k][0]
        .clone().requires_grad_(True) for k in EXPERTS}
    y = L.moe_layer_sharded(xs, wr, *(w[k] for k in EXPERTS),
                            top_k=int(inp["moe.top_k"]),
                            capacity_factor=float(inp["moe.cf"]), dist=dist)
    ct = _t(inp["moe.ct"]).to(dtype)[d.dp_slice()]
    grads = torch.autograd.grad(y, [xs, wr, *(w[k] for k in EXPERTS)], ct)
    names = ("y", "gx", "gw_router", *(f"g{k}" for k in EXPERTS))
    return {n: v.detach().float() for n, v in zip(names, (y, *grads))}


def moe_runs(rank: int, world: int, inp) -> dict:
    out = {}
    for grid, (data, model) in GRIDS.items():
        dist = DistCtx.create(data, model, device="cpu")
        for dt, dtype in DTYPES.items():
            for n in THREADS:
                torch.set_num_threads(n)
                for run in range(2):
                    for k, v in _fwd_bwd(inp, dist, dtype).items():
                        out[f"{grid}.{dt}.t{n}.r{run}.{k}"] = v
    return out
