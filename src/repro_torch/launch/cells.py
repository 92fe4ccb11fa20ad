"""Dry-pass cell builders: (arch x shape x grid) -> (step function, meta
arguments) (the port of ``repro/launch/cells.py``).

Everything here is shapes only: parameters, optimizer state, KV caches and
batches are ``meta`` tensors at the cell's full dims (no memory), built as
the card builds them (``init_params`` with no generator draws nothing on
meta), then cut to rank 0's pieces of the grid by ``dist/sharding``'s
policies under a ``launch/mesh.DryDistCtx``. The reference lowers and
compiles its pair; the port runs ``cell.fn(*cell.args)`` under
``launch/roofline.CostCounter``, op by op, with every kernel wrapper
reporting its cost (``launch/dryrun``). On one card the context is None:
the single-device path the card runs. The same ``fn`` runs on real
tensors of the same shapes (``chip_smoke.py`` times it on the card).

Kept from the reference: the LM dry config (every layer unrolled,
``q_chunk = S``, ``kv_chunk = min(2048, S)`` for train and prefill), the
decode cell's sequence axes (the bank axis when the batch cuts over dp,
every axis for ``long_500k``'s single sequence), the recsys statics as
shapes with a shape-only plan (no 33.8 M-row greedy), retrieval's
candidates padded to ``EDGE_PAD``, and GAT's edge lists padded to
``EDGE_PAD`` with a mask, one loss per shape, Adam 1e-3 and no clip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.configs import shapes as SH
from repro_torch.dist import sharding as R
from repro_torch.launch.mesh import Grid, make_dist
from repro_torch.train import optim as O
from repro_torch.train.train_step import (TrainState, build_train_step,
                                          default_optimizer)

EDGE_PAD = 512  # edge lists pad to multiples of this (divides 256 and 512)
META = torch.device("meta")


@dataclasses.dataclass
class Cell:
    arch_id: str
    shape_id: str
    step_kind: str
    fn: Callable
    args: tuple          # trees of meta tensors: rank 0's pieces
    meta: dict


def pad_to(n: int, mult: int) -> int:
    return int(math.ceil(n / mult) * mult)


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _lm_cell(arch_id: str, shape_id: str, dist,
             cfg_override=None) -> Cell:
    from repro_torch.models import transformer as T
    spec = get_arch(arch_id)
    cfg = cfg_override if cfg_override is not None else spec.config
    cell = SH.get_cell(arch_id, shape_id)
    B, S = cell.dims["batch"], cell.dims["seq"]
    kind = cell.step_kind
    if cfg_override is None and kind in ("train", "prefill"):
        # the reference's accounting config: every layer unrolled, queries
        # unchunked, KV chunks of at most 2,048
        cfg = dataclasses.replace(cfg, unroll=True, q_chunk=S,
                                  kv_chunk=min(2048, S))
    elif cfg_override is None and kind == "decode":
        cfg = dataclasses.replace(cfg, unroll=True)
    whole = T.init_params(cfg, None, device=META)
    params = whole if dist is None else R.lm_param_shardings(dist, whole)

    if kind == "train":
        batch = {"tokens": _sds((B, S), torch.int32),
                 "labels": _sds((B, S), torch.int32)}
        ctx = None
        if dist is not None:
            batch, ctx = R.lm_batch_shardings(dist, batch)
        opt = default_optimizer()
        step = build_train_step(
            lambda p, b, dist=None: T.lm_loss(cfg, p, b["tokens"],
                                              b["labels"], dist),
            opt, dist=ctx)
        # the optimizer state of rank 0's pieces: each leaf cut as its
        # param (the reference's moments follow their params' shardings)
        state = TrainState.create(params, opt)
        return Cell(arch_id, shape_id, kind, step, (state, batch),
                    dict(tokens=B * S))

    if kind == "prefill":
        toks, ctx = {"tokens": _sds((B, S), torch.int32)}, None
        if dist is not None:
            toks, ctx = R.lm_batch_shardings(dist, toks)
        fn = lambda p, t: T.prefill(cfg, p, t, ctx)  # noqa: E731
        return Cell(arch_id, shape_id, kind, fn, (params, toks["tokens"]),
                    dict(tokens=B * S))

    # decode: the KV cache cut over the sequence; long_500k's one sequence
    # over every axis
    cache = T.KVCache.empty(cfg, B, S, device=META)
    tok = _sds((B,), torch.int32)
    seq_axes: tuple = ()
    if dist is not None:
        batch_gt1 = B >= dist.dp_size()
        axes = ("bank",) if batch_gt1 else ("dp", "bank")
        cache, seq_axes, bsl = R.kv_cache_shardings(dist, cache, axes,
                                                    batch_gt1=batch_gt1)
        tok = tok[bsl]
    fn = lambda p, c, t: T.decode_step(  # noqa: E731
        cfg, p, c, t, dist, seq_axes=seq_axes)
    return Cell(arch_id, shape_id, "decode", fn, (params, cache, tok),
                dict(tokens=B, kv_len=S, seq_axes=list(seq_axes)))


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

def _recsys_vocab(cfg, family: str) -> int:
    return cfg.vocab if family == "bert4rec" else cfg.total_vocab


def _shape_plan(vocab: int, n_banks: int):
    """A plan of the right shapes, every row in bank 0, slot 0: what
    ``init_params`` needs to size the table, with no partitioner run."""
    from repro_torch.core.partitioning import PartitionPlan
    rows = pad_to(vocab, n_banks) // n_banks
    return PartitionPlan(n_banks=n_banks,
                         bank_of_row=np.zeros(vocab, np.int32),
                         slot_of_row=np.zeros(vocab, np.int32),
                         rows_per_bank=np.full(n_banks, rows, np.int32),
                         load_per_bank=np.ones(n_banks))


def _recsys_statics(family: str, cfg, vocab: int, n_banks: int) -> dict:
    """The statics as shapes (replicated): the remaps (and the flat remap
    the port computes once), the field offsets or the category offset,
    the bank count and capacity."""
    rows = pad_to(vocab, n_banks) // n_banks
    st = {"remap_bank": _sds((vocab,), torch.int32),
          "remap_slot": _sds((vocab,), torch.int32),
          "remap_flat": _sds((vocab,), torch.int32),
          "n_banks": n_banks, "rows_per_bank": rows}
    if family in ("dlrm", "xdeepfm"):
        st["field_offsets"] = _sds((len(cfg.vocab_sizes),), torch.int32)
    if family == "din":
        st["cate_offset"] = cfg.n_items
    return st


def _recsys_cell(arch_id: str, shape_id: str, dist, n_banks: int,
                 cfg_override=None, batch_override: dict | None = None
                 ) -> Cell:
    """A recsys cell; ``cfg_override`` and ``batch_override`` (meta
    tensors) replace the full config and batch, as for a reduced cell."""
    from repro_torch.models import family_module
    spec = get_arch(arch_id)
    cfg = spec.config if cfg_override is None else cfg_override
    fam = spec.family
    M = family_module(fam)
    kind, batch = SH.batch_struct(arch_id, shape_id)
    if batch_override is not None:
        batch = batch_override
    vocab = _recsys_vocab(cfg, fam)
    whole, _ = M.init_params(cfg, None, _shape_plan(vocab, n_banks),
                             device=META)
    params = whole if dist is None else R.recsys_param_shardings(dist, whole)
    statics = _recsys_statics(fam, cfg, vocab, n_banks)

    if kind == "retrieval":
        # the candidates spread over every grid axis: padded to divide
        batch = {k: (_sds((pad_to(v.shape[0], EDGE_PAD),) + v.shape[1:],
                          v.dtype) if k.startswith("candidate") else v)
                 for k, v in batch.items()}
    leading = batch_struct_leading(batch)
    ctx = None
    if dist is not None:
        # retrieval's candidates and the sampled negatives are spread by
        # the models; a serve slate of candidates cuts with its batch
        spread = tuple(k for k in R.SPREAD_KEYS if k in batch and (
            kind == "retrieval" or not k.startswith("candidate")))
        batch, ctx = R.recsys_batch_shardings(dist, batch, spread_keys=spread)

    if kind == "train":
        opt = default_optimizer()
        step0 = build_train_step(
            lambda p, sb, dist=None: M.loss_fn(cfg, p, sb[0], sb[1], dist),
            opt, dist=ctx)
        state = TrainState.create(whole, opt)
        if dist is not None:
            state = R.train_state_shardings(dist, state)
        fn = lambda st, s, b: step0(st, (s, b))  # noqa: E731
        return Cell(arch_id, shape_id, kind, fn, (state, statics, batch),
                    dict(batch=leading))

    if kind == "retrieval":
        score = M.retrieval_scores
    elif fam == "bert4rec":
        score = M.next_item_scores
    else:
        score = M.forward
    fn = lambda p, s, b: score(cfg, p, s, b, ctx)  # noqa: E731
    return Cell(arch_id, shape_id, kind, fn, (params, statics, batch),
                dict(batch=leading))


def batch_struct_leading(batch: dict) -> int:
    """The leading dim of the batch's first leaf in key order (the
    reference's ``jax.tree.leaves(...)[0]``)."""
    return int(batch[sorted(batch)[0]].shape[0])


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def _gat_cell(arch_id: str, shape_id: str, dist) -> Cell:
    from repro_torch.models import gat as G
    spec = get_arch(arch_id)
    cell = SH.get_cell(arch_id, shape_id)
    cfg = SH.gat_config_for_shape(spec.config, cell.dims)
    kind, batch = SH.batch_struct(arch_id, shape_id)

    # edge lists padded to a grid-divisible multiple (the mask drops the
    # tail); a full-graph batch gains its edge mask
    out = {}
    for k, v in batch.items():
        out[k] = (_sds((pad_to(v.shape[0], EDGE_PAD),) + v.shape[1:],
                       v.dtype) if R.is_edge_key(k) else v)
    if "edge_src" in out and "edge_mask" not in out:
        out["edge_mask"] = _sds(out["edge_src"].shape, torch.bool)
    batch, ctx = out, None
    if dist is not None:
        batch, ctx = R.gnn_batch_shardings(dist, batch)

    loss = G.cell_loss(shape_id)
    opt = O.adam(1e-3)
    step = build_train_step(lambda p, b, dist=None: loss(cfg, p, b, dist),
                            opt, clip_norm=None, dist=ctx)
    state = TrainState.create(G.init_params(cfg, None, device=META), opt)
    return Cell(arch_id, shape_id, "train", step, (state, batch), dict())


# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_id: str, grid: Grid) -> Cell:
    """The cell's step and its meta arguments on ``grid`` (rank 0's)."""
    dist = make_dist(grid)
    fam = get_arch(arch_id).family
    if fam == "lm":
        return _lm_cell(arch_id, shape_id, dist)
    if fam == "gat":
        return _gat_cell(arch_id, shape_id, dist)
    return _recsys_cell(arch_id, shape_id, dist, grid.model)


def tree_nbytes(tree: Any) -> int:
    """Bytes of every tensor of a tree of dicts, lists, tuples, a
    ``TrainState`` or a ``KVCache``."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, TrainState):
        return tree_nbytes((tree.params, tree.opt_state, tree.step,
                            tree.err_state))
    if dataclasses.is_dataclass(tree):                   # a KVCache
        return tree_nbytes([getattr(tree, f.name)
                            for f in dataclasses.fields(tree)])
    if isinstance(tree, dict):
        return tree_nbytes(list(tree.values()))
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(x) for x in tree)
    return 0
