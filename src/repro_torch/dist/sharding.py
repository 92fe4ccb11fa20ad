"""This rank's pieces of a recsys or LM param, batch, KV-cache or
train-state tree, or of a GNN batch (the port of
``repro/dist/sharding.py``'s LM, recsys and GNN policies).

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

``gnn_batch_shardings`` is the GNN policy: the edge arrays (``edge_*``,
``block*_src`` / ``_dst`` / ``_mask``) are cut over the whole grid (dp and
bank) by the ``spread_slice`` rule, after ``pad_edges`` has padded them
to a multiple of the world with masked-off edges (a batch without an
``edge_mask`` gains one), so every edge list is cut; node features,
labels and graph ids are held whole. ``models/gat.py`` runs on the
pieces.

Leaves are copied (``clone``), so the global tree can be freed.
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


def is_edge_key(key: str) -> bool:
    """Whether a GNN batch key names an edge array (the reference's rule:
    ``edge_*``, and a block's ``_src``, ``_dst`` and ``_mask``)."""
    return "edge_" in key or ("block" in key
                              and key.endswith(("_src", "_dst", "_mask")))


def pad_edges(batch: dict, multiple: int) -> dict:
    """``batch`` with each edge array padded to a multiple of ``multiple``
    by masked-off edges (0 -> 0, mask False), as the reference's
    ``launch/cells._gat_cell`` pads its cells' edge lists; a batch with
    ``edge_src`` and no ``edge_mask`` gains one (True on its edges)."""
    out = dict(batch)
    if "edge_src" in out and "edge_mask" not in out:
        out["edge_mask"] = torch.ones(out["edge_src"].shape, dtype=torch.bool,
                                      device=out["edge_src"].device)
    for k, v in out.items():
        if is_edge_key(k) and v.shape[0] % multiple:
            pad = multiple - v.shape[0] % multiple
            out[k] = torch.cat([v, v.new_zeros((pad, *v.shape[1:]))])
    return out


def gnn_batch_shardings(dist: DistCtx, batch: dict
                        ) -> tuple[dict, DistCtx]:
    """This rank's piece of a GNN batch and the context for it: the edge
    arrays padded (``pad_edges``) to a multiple of the world and cut to
    the rank's ``spread_slice``; every other key whole. The context holds
    the batch whole on every dp rank (``for_batch(..., whole=True)``): each
    rank computes the whole loss and, through ``models/gat.py``'s
    collectives, one device's gradient, which the train step's dp mean
    must leave as it is."""
    from repro_torch.dist.collectives import spread_slice
    world = dist.data * dist.model
    out = {}
    for k, v in pad_edges(batch, world).items():
        out[k] = v[spread_slice(dist, v.shape[0])].clone() \
            if is_edge_key(k) else v
    return out, dist.for_batch(int(batch["labels"].shape[0]), whole=True)


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
