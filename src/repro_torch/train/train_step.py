"""The train step: gradients by autograd, global-norm clipping, the
optimizer update (the port of ``repro/train/train_step.py``'s single-device
path).

The family module supplies ``loss_fn(params, batch, **kw) -> scalar``. The
step is functional like the reference's: it returns a new ``TrainState``
and leaves the old one as it was. With ``compress_grads`` the clipped
gradients go through int8 error-feedback compression (``compress.py``)
before the optimizer, the error buffers riding in ``TrainState.err_state``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

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
) -> Callable[[TrainState, Any], tuple[TrainState, dict]]:
    """Returns step(state, batch) -> (state, metrics).

    ``loss_kwargs`` are forwarded to every ``loss_fn(params, batch, ...)``
    call: how launch/train.py binds the embedding backend pair
    (``backend``/``bwd_backend``), so a CUDA step runs the bag kernel
    forward and the sorted-run scatter kernel backward.

    Global-norm clipping skips embedding tables by default: their row-wise
    Adagrad update is per-row scale-invariant. ``compress_grads`` compresses
    the clipped gradients (``compress.compress_roundtrip``, the state's
    ``err_state`` as the error feedback) before the optimizer update.
    """
    kw = dict(loss_kwargs or {})

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if torch.is_inference_mode_enabled():
            raise RuntimeError("the train step cannot run under "
                               "torch.inference_mode (it needs autograd)")
        flat = O.tree_leaves(state.params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = loss_fn(O.tree_unflatten(state.params, leaves), batch,
                           **kw)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = O.tree_unflatten(state.params, [
            torch.zeros_like(p) if g is None else g
            for p, g in zip(flat, grads)])
        metrics = {"loss": loss.detach()}
        with torch.no_grad():
            if clip_norm is not None:
                grads, gnorm = O.clip_by_global_norm_filtered(
                    grads, clip_norm, clip_include)
                metrics["grad_norm"] = gnorm
            err_state = state.err_state
            if compress_grads:
                grads, err_state = C.compress_roundtrip(grads, err_state)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = O.tree_map(lambda p, u: p + u.to(p.dtype),
                                state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1, err_state=err_state),
                metrics)

    return step


def default_optimizer(lr: float = 1e-3, emb_lr: float = 1e-2) -> O.Optimizer:
    """Adam for dense params, row-wise Adagrad for embedding tables: the
    production DLRM recipe."""
    def is_table(path: str) -> bool:
        return "packed" in path or "embed" in path

    return O.multi_opt(is_table, O.rowwise_adagrad(emb_lr), O.adam(lr))
