"""An explicit data-parallel train step with the int8 gradient psum (the
port of ``repro/train/dp_step.py``).

The model is replicated on every rank and the batch is cut over the
given axes of a ``DistCtx``: each rank differentiates its local loss, every
gradient leaf is summed over the axes by ``compress.psum_int8`` (int8 on
the wire at a shared scale, with the error feedback of
``TrainState.err_state``) and divided by the rank count, the loss is
averaged, and every rank applies the same optimizer update.
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.train import compress as C
from repro_torch.train import optim as O
from repro_torch.train.train_step import TrainState


def build_dp_compressed_step(loss_fn: Callable[[Any, Any], torch.Tensor],
                             optimizer: O.Optimizer, dist,
                             axes=("dp",)):
    """step(state, local_batch) -> (state, {"loss": global mean}).
    ``loss_fn(params, local_batch)`` is rank-local (no ``dist`` inside);
    ``axes`` (``"dp"``, ``"bank"`` or both, as the reference's
    ``dp_axes``) are the ranks the batch is cut over; the state must carry
    ``err_state`` (``TrainState.create(..., compress=True)``)."""
    n_dp = dist.size(axes)

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        if state.err_state is None:
            raise ValueError("build_dp_compressed_step needs the error "
                             "feedback state: TrainState.create(..., "
                             "compress=True)")
        flat = O.tree_leaves(state.params)
        leaves = [p.detach().requires_grad_(True) for p in flat]
        with torch.enable_grad():
            loss = loss_fn(O.tree_unflatten(state.params, leaves), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        with torch.no_grad():
            out = [C.psum_int8(torch.zeros_like(p) if g is None else g,
                               dist, e, axes)
                   for p, g, e in zip(flat, grads,
                                      O.tree_leaves(state.err_state))]
            grads = O.tree_unflatten(state.params,
                                     [s / n_dp for s, _ in out])
            err = O.tree_unflatten(state.params, [e for _, e in out])
            loss = dist.psum(loss.detach(), axes) / n_dp
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = O.tree_map(lambda p, u: p + u.to(p.dtype),
                                state.params, updates)
        return (TrainState(params=params, opt_state=opt_state,
                           step=state.step + 1, err_state=err),
                {"loss": loss})

    return step
