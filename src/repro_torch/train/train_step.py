"""The train step: gradients by autograd, global-norm clipping, the
optimizer update (the port of ``repro/train/train_step.py``).

The family module supplies ``loss_fn(params, batch, **kw) -> scalar``. The
step is functional like the reference's: it returns a new ``TrainState``
and leaves the old one as it was. With ``compress_grads`` the clipped
gradients go through int8 error-feedback compression (``compress.py``)
before the optimizer, the error buffers riding in ``TrainState.err_state``.

Under a ``DistCtx`` the step is the explicit form of what the reference's
GSPMD sharding does: each rank differentiates the loss of its dp slice
(the table shards through the bank-sharded lookup), every gradient is
averaged over the dp group BEFORE clipping, so every rank clips the same
dense gradients, and the optimizer then runs on the rank-local leaves
(the table shards' row-wise Adagrad on their own rows).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.obs.tracing import stage
from repro_torch.train import compress as C
from repro_torch.train import optim as O


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor         # () int32
    err_state: Any = None      # error-feedback buffers (compression on)

    @classmethod
    def create(cls, params, optimizer: O.Optimizer, compress: bool = False):
        return cls(params=params, opt_state=optimizer.init(params),
                   step=torch.zeros((), dtype=torch.int32,
                                    device=O._device_of(params)),
                   err_state=C.init_error_state(params) if compress
                   else None)


def _not_table(path: str) -> bool:
    return "packed" not in path and "embed" not in path


def build_train_step(
    loss_fn: Callable[..., torch.Tensor],
    optimizer: O.Optimizer,
    *,
    clip_norm: float | None = 1.0,
    compress_grads: bool = False,
    clip_include: Callable[[str], bool] = _not_table,
    loss_kwargs: dict | None = None,
    dist=None,
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Returns step(state, batch) -> (state, metrics).

    A step is the stage span ``train.step`` over ``train.forward`` (the
    loss), ``train.backward`` (``torch.autograd.grad``), ``train.clip``
    and ``train.optimizer`` (the update and its apply).

    ``loss_kwargs`` are forwarded to every ``loss_fn(params, batch, ...)``
    call: how launch/train.py binds the embedding backend pair
    (``backend``/``bwd_backend``), so a CUDA step runs the bag kernel
    forward and the sorted-run scatter kernel backward.

    Global-norm clipping skips embedding tables by default: their row-wise
    Adagrad update is per-row scale-invariant. ``compress_grads`` compresses
    the clipped gradients (``compress.compress_roundtrip``, the state's
    ``err_state`` as the error feedback) before the optimizer update.

    ``dist`` (a ``DistCtx``): the state holds this rank's pieces
    (``dist.sharding.train_state_shardings``), ``loss_fn`` takes ``dist``
    among ``loss_kwargs`` and ``batch`` is the rank's dp slice; the
    gradients are averaged over dp before clipping, as the reference's
    GSPMD step orders it (dp mean, clip, compression). A clip that
    includes a bank-sharded table sums the shards' squares over the bank
    group, and ``compress_grads`` quantizes a shard at the whole table's
    scale (a max over the bank group), so both equal one device's.
    """
    kw = dict(loss_kwargs or {})
    if dist is not None:
        kw["dist"] = dist

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if torch.is_inference_mode_enabled():
            raise RuntimeError("the train step cannot run under "
                               "torch.inference_mode (it needs autograd)")
        flat = O.tree_leaves(state.params)
        with stage("train.step", like=flat[0]):
            return _step(state, batch, flat)

    def _step(state: TrainState, batch, flat) -> tuple[TrainState, dict]:
        like = flat[0]
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            with stage("train.forward", like=like):
                loss = loss_fn(O.tree_unflatten(state.params, leaves), batch,
                               **kw)
            with stage("train.backward", like=like):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = O.tree_unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)])
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            if dist is not None:
                grads, metrics["loss"] = _dp_mean(dist, grads,
                                                  metrics["loss"])
            if clip_norm is not None:
                with stage("train.clip", like=like):
                    grads, gnorm = O.clip_by_global_norm_filtered(
                        grads, clip_norm, clip_include, dist)
                metrics["grad_norm"] = gnorm
            err_state = state.err_state
            if compress_grads:
                grads, err_state = C.compress_roundtrip(grads, err_state,
                                                        dist)
            with stage("train.optimizer", like=like):
                updates, opt_state = optimizer.update(grads, state.opt_state,
                                                      state.params)
                params = O.tree_map(lambda p, u: p + u.to(p.dtype),
                                    state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1, err_state=err_state),
                metrics)

    return step


def _dp_mean(dist, grads, loss):
    """Gradients and loss averaged over the dp group (nothing to average
    when every dp rank holds the whole batch)."""
    if dist.dp_size() == 1 or dist.dp_replicated:
        return grads, loss
    n = dist.dp_size()
    return (O.tree_map(lambda g: dist.psum(g, "dp") / n, grads),
            dist.psum(loss, "dp") / n)


def default_optimizer(lr: float = 1e-3, emb_lr: float = 1e-2) -> O.Optimizer:
    """Adam for dense params, row-wise Adagrad for embedding tables: the
    production DLRM recipe."""
    def is_table(path: str) -> bool:
        return "packed" in path or "embed" in path

    return O.multi_opt(is_table, O.rowwise_adagrad(emb_lr), O.adam(lr))
