"""This rank's pieces of a recsys param, batch or train-state tree (the
port of the recsys part of ``repro/dist/sharding.py``).

The reference returns ``NamedSharding`` policies that GSPMD applies to
global arrays. Under ``torch.distributed`` every tensor is rank-local, so
each policy here CUTS a global tree into the rank's pieces, under the same
rules:

  * a banked table (a 2-D leaf whose path names ``packed`` or ``embed``,
    rows divisible by the bank count) is cut by rows over the bank group:
    rank ``(d, m)`` holds rows ``[m * rpb, (m + 1) * rpb)``, bank ``m``;
  * every other param (the small dense MLPs) is replicated;
  * a batch's leading dim is cut over dp where it divides by ``dp_size()``
    and held whole otherwise, and the batch comes back with the context
    for it (``DistCtx.for_batch``);
  * ``spread_keys`` (``SPREAD_KEYS``: retrieval candidates and their
    categories, sampled negatives) are the reference's "spread" arrays,
    which it places over every mesh axis. They are held whole here: the
    models cut them at the point where the reference places them
    (``dist.collectives.spread_slice``, the same rule: the ``rank``-th
    piece, whole where the dim does not divide by the world), since a
    rank's piece alone cannot tell a cut list from a whole one;
  * an optimizer or error-feedback leaf follows the param of its shape and
    dtype; a 1-D leaf as long as a table has rows (the row-wise Adagrad
    accumulator) follows that table's rows too, which the reference's
    GSPMD propagation does implicitly.

Leaves are copied (``clone``), so the global tree can be freed. The LM,
KV-cache and GNN policies belong with the models that use them (ROADMAP
queue 1 #18, parts 3 and 4).
"""
from __future__ import annotations

import torch

from repro_torch.core.embedding import DistCtx
from repro_torch.train import optim as O

# the reference's spread arrays among the recsys families' batch keys
SPREAD_KEYS = ("candidates", "candidate_cates", "negatives")


def _rows(x: torch.Tensor, i: int, n: int) -> torch.Tensor:
    k = x.shape[0] // n
    return x[i * k:(i + 1) * k].clone()


def _is_table(path: str, leaf, n_banks: int) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
            and ("packed" in path or "embed" in path)
            and leaf.shape[0] % n_banks == 0)


def recsys_param_shardings(dist: DistCtx, params):
    """``params`` with every banked table cut to this rank's bank rows;
    the rest unchanged (replicated)."""
    flat = O.tree_flatten_with_path(params)
    return O.tree_unflatten(params, [
        _rows(v, dist.bank_rank, dist.n_banks)
        if _is_table(p, v, dist.n_banks) else v for p, v in flat])


def recsys_batch_shardings(dist: DistCtx, batch: dict,
                           spread_keys: tuple[str, ...] = ()
                           ) -> tuple[dict, DistCtx]:
    """This rank's piece of a batch dict, and the context for it
    (``dist.for_batch`` of the batch's leading dim, which every other key
    shares): the leading dim over dp where the batch divides
    (``dist.dp_ok``), whole otherwise; keys in ``spread_keys`` whole on
    every rank (the models spread them). Lookups and the train step take
    the returned context, which refuses a batch cut any other way."""
    sizes = {int(v.shape[0]) for k, v in batch.items()
             if k not in spread_keys and v.dim()}
    if len(sizes) != 1:
        raise ValueError(f"recsys_batch_shardings: the batch's keys lead "
                         f"with {sorted(sizes)} rows; they must share one")
    ctx = dist.for_batch(sizes.pop())
    sl, out = ctx.dp_slice(), {}
    for k, v in batch.items():
        if k in spread_keys:
            out[k] = v
        elif v.dim():
            out[k] = v[sl].clone()
        else:
            out[k] = v
    return out, ctx


def train_state_shardings(dist: DistCtx, state):
    """A global ``TrainState`` cut to this rank: params by
    ``recsys_param_shardings``; each optimizer and error-feedback leaf cut
    like the table of its shape and dtype (or, 1-D, of its row count),
    replicated otherwise; the step replicated."""
    from repro_torch.train.train_step import TrainState
    tables = [v for p, v in O.tree_flatten_with_path(state.params)
              if _is_table(p, v, dist.n_banks)]
    shapes = {(tuple(v.shape), v.dtype) for v in tables}
    rows = {v.shape[0] for v in tables}

    def cut(x):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        if (tuple(x.shape), x.dtype) in shapes \
                or (x.dim() == 1 and x.shape[0] in rows):
            return _rows(x, dist.bank_rank, dist.n_banks)
        return x

    return TrainState(
        params=recsys_param_shardings(dist, state.params),
        opt_state=O.tree_map(cut, state.opt_state), step=state.step,
        err_state=None if state.err_state is None
        else O.tree_map(cut, state.err_state))
