"""This rank's pieces of a recsys or LM param, batch, KV-cache or
train-state tree (the port of ``repro/dist/sharding.py``'s LM and recsys
policies).

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

The LM policies cut by the reference's rules too: ``lm_param_shardings``
cuts an ``embed`` leaf's rows over the bank group (the reference's first
rule, which a 2-D ``unembed`` meets as well), the stacked ``wq``,
``w_gate``, ``w_up`` by their last dim, ``wo`` and ``w_down`` by their
middle dim, a MoE expert stack (L, E, ...) by its experts, each only
where the dim divides by the bank count, and holds every other leaf
whole; ``lm_batch_shardings`` is the recsys batch rule;
``kv_cache_shardings`` cuts the cache's sequence dim over ``seq_axes``
and its batch dim over dp (when dp is not a sequence axis), each where it
divides, and says what it cut. The models gather a cut weight where they
use it (``models/transformer.py``).

Leaves are copied (``clone``), so the global tree can be freed. The GNN
policy belongs with the model that uses it (ROADMAP queue 1 #18, part 4).
"""
from __future__ import annotations

import torch

from repro_torch.core.embedding import DistCtx
from repro_torch.train import optim as O

# the reference's spread arrays among the recsys families' batch keys
SPREAD_KEYS = ("candidates", "candidate_cates", "negatives")


def _cut(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    """The i-th of n equal pieces of ``x`` along ``dim``, a copy."""
    k = x.shape[dim] // n
    return x.narrow(dim, i * k, k).clone()


def _is_table(path: str, leaf, n_banks: int) -> bool:
    return (isinstance(leaf, torch.Tensor) and leaf.dim() == 2
            and ("packed" in path or "embed" in path)
            and leaf.shape[0] % n_banks == 0)


def recsys_param_shardings(dist: DistCtx, params):
    """``params`` with every banked table cut to this rank's bank rows;
    the rest unchanged (replicated)."""
    flat = O.tree_flatten_with_path(params)
    return O.tree_unflatten(params, [
        _cut(v, 0, dist.bank_rank, dist.n_banks)
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


def lm_param_cut_dim(path: str, shape: tuple, n_banks: int) -> int | None:
    """The dim ``lm_param_shardings`` cuts a leaf at ``path`` over
    ``n_banks`` banks, or None (held whole): the reference's rules, in its
    order."""
    nd = len(shape)

    def div(i):
        return shape[i] % n_banks == 0

    if "embed" in path and nd == 2 and div(0):
        return 0
    if "unembed" in path and nd == 2 and div(1):
        return 1
    if nd == 3 and any(k in path for k in ("wq", "w_gate", "w_up")) \
            and div(2):
        return 2
    if nd == 3 and any(k in path for k in ("wo", "w_down")) and div(1):
        return 1
    if nd == 4 and div(1):
        return 1
    return None


def lm_param_shardings(dist: DistCtx, params):
    """``params`` of ``transformer.init_params`` with each leaf cut to this
    rank's bank piece by ``lm_param_cut_dim``; the rest whole."""
    flat = O.tree_flatten_with_path(params)
    out = []
    for p, v in flat:
        dim = lm_param_cut_dim(p, tuple(v.shape), dist.n_banks)
        out.append(v if dim is None
                   else _cut(v, dim, dist.bank_rank, dist.n_banks))
    return O.tree_unflatten(params, out)


def lm_batch_shardings(dist: DistCtx, batch: dict
                       ) -> tuple[dict, DistCtx]:
    """This rank's piece of an LM batch (``tokens``, ``labels``) and the
    context for it: ``recsys_batch_shardings``' rule, the leading dim over
    dp where it divides."""
    return recsys_batch_shardings(dist, batch)


def kv_cache_shardings(dist: DistCtx, cache, seq_axes=("bank",),
                       batch_gt1: bool = True):
    """This rank's piece of a ``transformer.KVCache`` (k / v (L, B, S, Hkv,
    Dh)): the sequence dim cut over ``seq_axes`` where S divides by their
    size, the batch dim over dp where dp is not a sequence axis, the batch
    is cut at all (``batch_gt1``) and B divides. Returns ``(cache,
    seq_axes, batch)``: the piece, the axes the sequence was cut over
    (empty when it stays whole; pass them to ``decode_step``) and the
    slice of the batch the piece holds (cut the tokens with it)."""
    from repro_torch.dist.collectives import seq_shard_index
    from repro_torch.models.transformer import KVCache
    seq_axes = tuple(seq_axes)
    _, B, S = cache.k.shape[:3]
    n_seq = dist.size(seq_axes)
    cut_s = S % n_seq == 0
    dp_eff = "dp" not in seq_axes and dist.data > 1
    cut_b = batch_gt1 and dp_eff and B % dist.data == 0
    bsl = slice(dist.dp_rank * (B // dist.data),
                (dist.dp_rank + 1) * (B // dist.data)) if cut_b \
        else slice(0, B)

    def piece(x):
        x = x[:, bsl]
        if cut_s:
            x = _cut(x, 2, seq_shard_index(dist, seq_axes), n_seq)
        return x.clone()

    return (KVCache(k=piece(cache.k), v=piece(cache.v), length=cache.length),
            seq_axes if cut_s else (), bsl)


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
            return _cut(x, 0, dist.bank_rank, dist.n_banks)
        return x

    return TrainState(
        params=recsys_param_shardings(dist, state.params),
        opt_state=O.tree_map(cut, state.opt_state), step=state.step,
        err_state=None if state.err_state is None
        else O.tree_map(cut, state.err_state))
