"""Optimizers from first principles: Adam, row-wise Adagrad, SGD (the port
of ``repro/train/optim.py``).

Parameters, gradients and states are trees of nested dicts, lists and
tuples with tensor leaves. Leaves are visited in the reference's pytree
order (dict keys sorted, sequences in order) and named by the reference's
key strings (``"['bot']['w'][0]"``), so ``multi_opt`` routes and orders
leaves as the reference does and a reference state carries across leaf for
leaf (``repro_torch.convert.train_state_from_jax``).

Every update is functional: it returns new tensors and leaves its inputs
as they were, with the reference's formulas in the reference's operation
order. Callers run it under ``torch.no_grad``.

Row-wise Adagrad is the production DLRM choice for embedding tables (one
accumulator per ROW, not per element). ``multi_opt`` routes param leaves
by path predicate so models mix Adam (dense) with row-wise Adagrad
(tables).
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import torch


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def tree_flatten_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """[(key string, leaf)] in the reference's pytree order. None is an
    empty subtree, as in JAX."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in tree_flatten_with_path(tree[k], f"{prefix}['{k}']")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree)
                for kv in tree_flatten_with_path(x, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [v for _, v in tree_flatten_with_path(tree)]


def tree_unflatten(like, leaves) -> Any:
    """A tree of ``like``'s structure holding ``leaves`` in flatten order."""
    return _build(like, iter(leaves))


def _build(t, it):
    # module level, not a closure: a self-referencing nested function is a
    # reference cycle that would keep ``leaves`` (GB-sized tensors) alive
    # until the garbage collector happens to run
    if isinstance(t, dict):
        return {k: _build(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(x, it) for x in t)
    if t is None:
        return None
    return next(it)


def tree_map(fn: Callable, tree, *rest) -> Any:
    leaves = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*leaves)])


def _device_of(tree) -> torch.device:
    leaves = tree_leaves(tree)
    return leaves[0].device if leaves else torch.device("cpu")


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------

class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any], tuple[Any, Any]]  # (grads, state, params)


def sgd(lr: float, momentum: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return tree_map(torch.zeros_like, params)

    def update(grads, state, params):
        if momentum == 0.0:
            return tree_map(lambda g: -lr * g, grads), state
        new_m = tree_map(lambda m, g: momentum * m + g, state, grads)
        return tree_map(lambda m: -lr * m, new_m), new_m

    return Optimizer(init, update)


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {
            "m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params),
            "t": torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        }

    def update(grads, state, params):
        t = state["t"] + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                     grads)
        # fp32 bias correction, as the reference's b1 ** t.astype(float32)
        bc1 = 1 - b1 ** t.to(torch.float32)
        bc2 = 1 - b2 ** t.to(torch.float32)

        def upd(m, v, p):
            step = -lr * (m / bc1) / (torch.sqrt(v / bc2) + eps)
            if weight_decay:
                step = step - lr * weight_decay * p
            return step

        return tree_map(upd, m, v, params), {"m": m, "v": v, "t": t}

    return Optimizer(init, update)


def rowwise_adagrad(lr: float, eps: float = 1e-8) -> Optimizer:
    """For 2D (rows, dim) tables: one accumulator per row. The update is
    dense, as the reference's: every row of the table is stepped, and a row
    no entry touched gets a step of exactly ±0."""
    def init(params):
        return tree_map(
            lambda p: torch.zeros(p.shape[:1], dtype=torch.float32,
                                  device=p.device) if p.dim() == 2
            else torch.zeros_like(p), params)

    def upd(g, a):
        if g.dim() == 2:
            a_new = a + torch.mean(g.float() ** 2, dim=1)
            step = -lr * g / (torch.sqrt(a_new)[:, None] + eps)
            return step.to(g.dtype), a_new
        a_new = a + g.float() ** 2
        return (-lr * g / (torch.sqrt(a_new) + eps)).to(g.dtype), a_new

    def update(grads, state, params):
        out = [upd(g, a) for g, a in zip(tree_leaves(grads),
                                         tree_leaves(state))]
        return (tree_unflatten(grads, [s for s, _ in out]),
                tree_unflatten(state, [a for _, a in out]))

    return Optimizer(init, update)


def multi_opt(route: Callable[[str], bool], opt_true: Optimizer,
              opt_false: Optimizer) -> Optimizer:
    """Route each leaf by its key string: route(path) True -> opt_true.

    Typical: ``lambda path: 'packed' in path or 'embed' in path`` sends
    embedding tables to row-wise Adagrad, the rest to Adam. Each inner
    optimizer sees a list of its leaves in flatten order.
    """
    def init(params):
        flat = tree_flatten_with_path(params)
        return {"true": opt_true.init([v for p, v in flat if route(p)]),
                "false": opt_false.init([v for p, v in flat if not route(p)])}

    def update(grads, state, params):
        gflat = tree_flatten_with_path(grads)
        pflat = tree_flatten_with_path(params)
        g_t = [v for p, v in gflat if route(p)]
        g_f = [v for p, v in gflat if not route(p)]
        p_t = [v for p, v in pflat if route(p)]
        p_f = [v for p, v in pflat if not route(p)]
        s_t, st_t = opt_true.update(g_t, state["true"], p_t)
        s_f, st_f = opt_false.update(g_f, state["false"], p_f)
        it_t, it_f = iter(s_t), iter(s_f)
        steps = [next(it_t) if route(p) else next(it_f) for p, _ in gflat]
        return tree_unflatten(grads, steps), {"true": st_t, "false": st_f}

    return Optimizer(init, update)


def _square_sum(leaves, device=None) -> torch.Tensor:
    total = torch.zeros((), dtype=torch.float32, device=device)
    for g in leaves:
        total = total + torch.sum(torch.square(g.float()))
    return total


def _global_norm(leaves) -> torch.Tensor:
    return torch.sqrt(_square_sum(leaves))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    norm = _global_norm(tree_leaves(grads))
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, grads), norm


def clip_by_global_norm_filtered(grads, max_norm: float, include,
                                 dist=None):
    """Clip only leaves where include(path): embedding tables are excluded
    by the train step (row-wise Adagrad is per-row scale-invariant, and a
    global-norm pass over a multi-GB gradient is pure HBM traffic).

    ``dist`` (a ``DistCtx``): ``grads`` are this rank's pieces; a bank
    shard's squared sum (``compress.is_bank_shard``) is summed over the
    bank group and a replicated leaf's counted once, so the norm is the
    whole tree's."""
    from repro_torch.train.compress import is_bank_shard
    flat = tree_flatten_with_path(grads)
    picked = [(p, v) for p, v in flat if include(p)]
    shards = [v for p, v in picked if is_bank_shard(p, v, dist)]
    if not shards:
        norm = _global_norm([v for _, v in picked])
    else:
        sq = dist.psum(_square_sum(shards), "bank")
        norm = torch.sqrt(_square_sum(
            [v for p, v in picked if not is_bank_shard(p, v, dist)],
            sq.device) + sq)
    scale = _clip_scale(norm, max_norm)
    return tree_unflatten(grads, [g * scale if include(p) else g
                                  for p, g in flat]), norm


def cosine_schedule(base_lr: float, warmup: int, total: int):
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = 0.5 * base_lr * (1 + torch.cos(math.pi * prog))
        return torch.where(step < warmup, warm, cos)
    return lr
