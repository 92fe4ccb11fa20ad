"""Rank side of ``test_torch_dist_zoo.py``: what each gloo rank of a
4-rank CPU world runs, as a 1 x 4 and a 2 x 2 grid in turn, on inputs the
test wrote (``run_ranks`` hands them over as ``.npy`` files). Only torch,
numpy and the port are imported, so a spawned rank starts without JAX.
Every output name is ``<grid>.<check>.<array>``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import embedding as TE

CPU = "cpu"
GRIDS = {"g14": (1, 4), "g22": (2, 2)}
RETRIEVAL_ARCHS = ("dlrm-rm2", "din", "xdeepfm", "bert4rec")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x).copy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy()


def _family(arch: str):
    from repro_torch.configs import get_arch
    from repro_torch.models import family_module
    spec = get_arch(arch)
    return spec, family_module(spec.family)


def _params(inp, prefix: str, like: dict) -> dict:
    """The leaves written as ``<prefix>leaf<i>`` in the reference's pytree
    order, in ``like``'s structure (the port's, which has that order)."""
    from repro_torch.train import optim as O
    n = len(O.tree_leaves(like))
    return O.tree_unflatten(like, [_t(inp[f"{prefix}leaf{i}"])
                                   for i in range(n)])


def _statics(inp, prefix: str) -> dict:
    bank, slot = _t(inp[f"{prefix}bank"]), _t(inp[f"{prefix}slot"])
    rpb = int(inp[f"{prefix}rpb"])
    st = {"remap_bank": bank, "remap_slot": slot,
          "remap_flat": TE.flat_remap(bank, slot, rpb),
          "n_banks": int(inp[f"{prefix}nb"]), "rows_per_bank": rpb}
    if f"{prefix}off" in inp:
        st["field_offsets"] = _t(inp[f"{prefix}off"])
    if f"{prefix}cate_offset" in inp:
        st["cate_offset"] = int(inp[f"{prefix}cate_offset"])
    return st


def _model(inp, arch: str, grid: str):
    """(spec, module, this rank's params, statics) of ``arch`` on
    ``grid``'s plan."""
    from repro_torch.dist.sharding import recsys_param_shardings
    spec, mod = _family(arch)
    like, _ = mod.init_params(spec.reduced, torch.Generator().manual_seed(0),
                              device=CPU)
    pre = f"{grid}.{arch}."
    return spec, mod, _params(inp, pre, like), _statics(inp, pre)


def _batch(inp, prefix: str) -> dict:
    keys = [k[len(prefix):] for k in inp if k.startswith(prefix)]
    return {k: _t(inp[prefix + k]) for k in keys}


def _retrieval(inp, grid, dist) -> dict:
    """Every family's retrieval of the query ``rb`` (N divides the world)
    and ``rbx`` (it does not): the rank's scores, and the served top k."""
    from repro_torch.dist.sharding import recsys_param_shardings
    from repro_torch.serve.serve_step import build_retrieval_serve
    out = {}
    for arch in RETRIEVAL_ARCHS:
        spec, mod, params, statics = _model(inp, arch, grid)
        local = recsys_param_shardings(dist, params)
        for b in ("rb", "rbx"):
            batch = _batch(inp, f"{arch}.{b}.")
            with torch.inference_mode():
                out[f"{arch}.{b}.scores"] = mod.retrieval_scores(
                    spec.reduced, local, statics, batch, dist)
            vals, ids = build_retrieval_serve(mod, spec.reduced, statics,
                                              dist, top_k=16)(local, batch)
            out[f"{arch}.{b}.vals"], out[f"{arch}.{b}.ids"] = vals, ids
    return out


def _ties(inp, grid, dist) -> dict:
    """``global_top_k`` of integer scores with many exact ties, 1-D and
    (3, N), from each rank's piece."""
    from repro_torch.dist.collectives import global_top_k, spread_slice
    out = {}
    for name in ("ties1", "ties2"):
        s = _t(inp[name])
        n = s.shape[-1]
        piece = s[..., spread_slice(dist, n)]
        out[f"{name}.vals"], out[f"{name}.ids"] = global_top_k(piece, 20,
                                                               dist, n)
    return out


def _grads(loss, leaves):
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(leaves, gs)]


def _b4r_loss(inp, grid, dist) -> dict:
    """BERT4Rec's loss on the batch cut by ``recsys_batch_shardings``
    (negatives spread by the model), both loss modes: the loss and every
    gradient after the train step's dp mean."""
    import dataclasses
    from repro_torch.dist.sharding import (SPREAD_KEYS,
                                           recsys_batch_shardings,
                                           recsys_param_shardings)
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import _dp_mean
    spec, mod, params, statics = _model(inp, "bert4rec", grid)
    local = recsys_param_shardings(dist, params)
    batch, ctx = recsys_batch_shardings(dist, _batch(inp, "b4r.batch."),
                                        SPREAD_KEYS)
    out = {}
    for mode in ("sampled", "full"):
        cfg = dataclasses.replace(spec.reduced, loss=mode)
        flat = O.tree_leaves(local)
        leaves = [p.clone().requires_grad_(True) for p in flat]
        loss = mod.loss_fn(cfg, O.tree_unflatten(local, leaves), statics,
                           batch, ctx)
        grads, loss = _dp_mean(ctx, O.tree_unflatten(
            local, _grads(loss, leaves)), loss.detach())
        out[f"{mode}.loss"] = loss
        for i, g in enumerate(O.tree_leaves(grads)):
            out[f"{mode}.grad{i}"] = g
    return out


def _compress(inp, grid, dist) -> dict:
    """``compress_roundtrip(dist)`` of this rank's pieces of a fixed tree
    (its bank's rows of the table leaves, the dense leaves whole)."""
    from repro_torch.dist.sharding import recsys_param_shardings
    from repro_torch.train.compress import compress_roundtrip
    tree = {"emb_packed": _t(inp["cmp.emb"]), "lin_packed":
            _t(inp["cmp.lin"]), "mlp": {"w": [_t(inp["cmp.w"])],
                                        "b": [_t(inp["cmp.b"])]}}
    err = {"emb_packed": _t(inp["cmp.e_emb"]), "lin_packed":
           _t(inp["cmp.e_lin"]), "mlp": {"w": [_t(inp["cmp.e_w"])],
                                         "b": [_t(inp["cmp.e_b"])]}}
    g, e = compress_roundtrip(recsys_param_shardings(dist, tree),
                              recsys_param_shardings(dist, err), dist)
    return {"emb": g["emb_packed"], "lin": g["lin_packed"],
            "w": g["mlp"]["w"][0], "b": g["mlp"]["b"][0],
            "e_emb": e["emb_packed"], "e_lin": e["lin_packed"],
            "e_w": e["mlp"]["w"][0]}


def _steps(inp, grid, dist) -> dict:
    """The reduced updlrm-paper on a plan that keeps each field on one
    bank: one step clipped over every leaf (the table included), and two
    compressed steps, from a global TrainState cut by
    ``train_state_shardings``."""
    from repro_torch.dist.sharding import (recsys_batch_shardings,
                                           train_state_shardings)
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    spec, mod, params, statics = _model(inp, "updlrm-paper", grid)
    cfg = spec.reduced
    batches = [recsys_batch_shardings(dist, _batch(inp, f"upd.b{i}."))
               for i in range(2)]
    ctx = batches[0][1]
    opt = default_optimizer()

    def loss(p, b, **k):
        return mod.loss_fn(cfg, p, statics, b, **k)
    out = {}
    clip = build_train_step(loss, opt, clip_include=lambda p: True,
                            dist=ctx)
    _, met = clip(train_state_shardings(dist, TrainState.create(params, opt)),
                  batches[0][0])
    out["clip.norm"], out["clip.loss"] = met["grad_norm"], met["loss"]
    step = build_train_step(loss, opt, compress_grads=True, dist=ctx)
    state = train_state_shardings(
        dist, TrainState.create(params, opt, compress=True))
    losses, norms = [], []
    for b, _ in batches:
        state, met = step(state, b)
        losses.append(met["loss"])
        norms.append(met["grad_norm"])
    out["cmp.losses"], out["cmp.norms"] = torch.stack(losses), \
        torch.stack(norms)
    out["cmp.emb"] = state.params["emb_packed"]
    out["cmp.err"] = state.err_state["emb_packed"]
    out["cmp.top_w0"] = state.params["top"]["w"][0]
    out["cmp.acc"] = state.opt_state["true"][0]
    return out


CHECKS = {"retrieval": _retrieval, "ties": _ties, "b4r": _b4r_loss,
          "compress": _compress, "steps": _steps}


def zoo_grids(rank: int, world: int, inp) -> dict:
    """Every check on the 1 x 4 grid, then on the 2 x 2 grid, of one
    4-rank world."""
    out = {}
    for grid, (data, model) in GRIDS.items():
        dist = TE.DistCtx.create(data, model, device=CPU)
        for name, fn in CHECKS.items():
            for k, v in fn(inp, grid, dist).items():
                out[f"{grid}.{name}.{k}"] = _np(v) \
                    if isinstance(v, torch.Tensor) else v
    return out
