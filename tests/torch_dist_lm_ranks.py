"""Rank side of ``test_torch_dist_lm.py``: the LM family's sharded paths on
a 1 x 4 and a 2 x 2 grid of the same four gloo ranks. Only torch, numpy
and the port are imported here, so a spawned rank starts without JAX;
the test holds the outputs against the reference's single-device results
in its own process. Every output name is ``<grid>.<case>.<array>``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.embedding import DistCtx
from repro_torch.dist import collectives as C
from repro_torch.dist import sharding as SH
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.train import optim as O

GRIDS = {"1x4": (1, 4), "2x2": (2, 2)}
SEQ_AXES = {"bank": ("bank",), "all": ("dp", "bank")}
LOSS_ARCHS = ("granite-moe-1b-a400m", "smollm-135m")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _decode(inp, dist, grid: str) -> dict:
    """``seqsharded_decode_attention`` at two positions, the cache cut by
    ``kv_cache_shardings`` (a KVCache of one layer) over the bank axis and
    over both axes."""
    out = {}
    q, kn, vn = _t(inp["dec.q"]), _t(inp["dec.kn"]), _t(inp["dec.vn"])
    whole = T.KVCache(k=_t(inp["dec.kc"])[None], v=_t(inp["dec.vc"])[None],
                      length=0)
    for name, axes in SEQ_AXES.items():
        cache, cut, bsl = SH.kv_cache_shardings(dist, whole, axes)
        for pos in (int(p) for p in inp["dec.pos"]):
            o, kc, vc = C.seqsharded_decode_attention(
                q[bsl], kn[bsl], vn[bsl], cache.k[0], cache.v[0], pos,
                dist=dist, seq_axes=cut)
            key = f"{grid}.dec.{name}.{pos}"
            out[f"{key}.o"], out[f"{key}.kc"], out[f"{key}.vc"] = o, kc, vc
        out[f"{grid}.dec.{name}.cut"] = torch.tensor(
            [len(cut), bsl.start, bsl.stop])
    return out


def _moe(inp, dist, grid: str) -> dict:
    """``moe_layer_sharded`` on this rank's dp slice and its experts (cut
    as ``lm_param_shardings`` cuts a stacked expert leaf)."""
    out = {}
    for dt, dtype in DTYPES.items():
        x = _t(inp["moe.x"]).to(dtype)
        B = x.shape[0]
        d = dist.for_batch(B)
        xs = x[d.dp_slice()]
        w = {k: SH.lm_param_shardings(dist, {"layers": {
            k: _t(inp[f"moe.{k}"])[None].to(dtype)}})["layers"][k][0]
            for k in ("w_gate", "w_up", "w_down")}
        y = L.moe_layer_sharded(
            xs, _t(inp["moe.w_router"]).to(dtype), w["w_gate"], w["w_up"],
            w["w_down"], top_k=int(inp["moe.top_k"]),
            capacity_factor=float(inp["moe.cf"]), dist=dist)
        out[f"{grid}.moe.{dt}"] = y.float()
    return out


def _params(inp, prefix: str) -> dict:
    """The reference's LM params written leaf by leaf as
    ``<prefix><path>``."""
    names = [str(n) for n in inp[f"{prefix}names"]]
    tree: dict = {}
    for n in names:
        node = tree
        keys = n.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = _t(inp[f"{prefix}{n}"])
    return tree


def _loss(inp, dist, grid: str) -> dict:
    """``lm_loss`` on this rank's dp slice with its param pieces; the
    loss's gradient w.r.t. the pieces (the train step's, before the dp
    mean)."""
    out = {}
    for arch in LOSS_ARCHS:
        whole = _params(inp, f"lm.{arch}.")
        params = SH.lm_param_shardings(dist, whole)
        batch, d = SH.lm_batch_shardings(dist, {
            "tokens": _t(inp[f"lm.{arch}.tokens"]),
            "labels": _t(inp[f"lm.{arch}.labels"])})
        for dt, dtype in DTYPES.items():
            cfg = dataclasses.replace(get_arch(arch).reduced, dtype=dtype)
            leaves = [p.detach().requires_grad_(True)
                      for p in O.tree_leaves(params)]
            loss = T.lm_loss(cfg, O.tree_unflatten(params, leaves),
                             batch["tokens"], batch["labels"], d)
            grads = torch.autograd.grad(loss, leaves)
            out[f"{grid}.loss.{arch}.{dt}"] = loss.detach()[None]
            if dt == "f32":
                # the dp mean of the pieces' gradients: the step's gradient
                g = O.tree_unflatten(params, [
                    dist.psum(x, "dp") / dist.data for x in grads])
                out[f"{grid}.grad.{arch}.embed"] = g["embed"]
                out[f"{grid}.grad.{arch}.w_up"] = g["layers"]["w_up"]
                out[f"{grid}.grad.{arch}.wq"] = g["layers"]["wq"]
    return out


def lm_grids(rank: int, world: int, inp) -> dict:
    out = {}
    for grid, (data, model) in GRIDS.items():
        dist = DistCtx.create(data, model, device="cpu")
        out.update(_decode(inp, dist, grid))
        out.update(_moe(inp, dist, grid))
        out.update(_loss(inp, dist, grid))
    return out
