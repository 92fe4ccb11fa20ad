"""Carry the JAX package's values across into the port's tensors.

The caller converts JAX arrays to numpy (``np.asarray``) first, so this
module never imports JAX. The port never re-initialises weights to match
the reference — ``jax.random`` cannot be reproduced in torch — so parity
tests carry the reference's own params, statics and tables across with the
functions below.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.embedding import (BankedTable, ReplicatedTable,
                                        flat_remap)
from repro_torch.quant.tiered import TieredTable
from repro_torch.train.train_step import TrainState


def to_tensor(x, device: str | torch.device) -> torch.Tensor:
    """numpy array (or scalar) -> tensor on ``device``, dtype preserved.

    bfloat16 numpy arrays (ml_dtypes, which JAX hands out) are carried bit
    for bit through an int16 view, since torch cannot read that dtype.
    """
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.ascontiguousarray(arr).copy()).to(device)


def _mlp(p: dict, device) -> dict:
    return {"w": [to_tensor(w, device) for w in p["w"]],
            "b": [to_tensor(b, device) for b in p["b"]]}


def params_from_jax(params: dict, device: str | torch.device) -> dict:
    """``repro.models.dlrm.init_params`` params (leaves as numpy) -> the
    port's params dict: ``emb_packed`` and the ``bot``/``top`` MLPs with
    ``w`` (in, out) / ``b`` lists."""
    return {"emb_packed": to_tensor(params["emb_packed"], device),
            "bot": _mlp(params["bot"], device),
            "top": _mlp(params["top"], device)}


def statics_from_jax(statics: dict, device: str | torch.device) -> dict:
    """DLRM statics: remap vectors and field offsets as int32 tensors,
    ``n_banks`` / ``rows_per_bank`` as Python ints, and the flat remap
    computed once from them (``remap_flat``)."""
    bank = to_tensor(statics["remap_bank"], device)
    slot = to_tensor(statics["remap_slot"], device)
    rows_per_bank = int(statics["rows_per_bank"])
    return {"remap_bank": bank, "remap_slot": slot,
            "remap_flat": flat_remap(bank, slot, rows_per_bank),
            "n_banks": int(statics["n_banks"]),
            "rows_per_bank": rows_per_bank,
            "field_offsets": to_tensor(statics["field_offsets"], device)}


def zoo_params_from_jax(params: dict, device: str | torch.device) -> dict:
    """The params of ``repro.models.din``, ``xdeepfm`` or ``bert4rec``
    ``init_params`` (leaves as numpy) -> the port's, leaf for leaf and key
    for key: the banked tables (``emb_packed``, xDeepFM's ``lin_packed``),
    the MLPs' ``w`` / ``b`` lists, xDeepFM's ``cin_w`` list, BERT4Rec's
    ``blocks`` with their leading ``n_blocks`` dim."""
    return _tree(params, device)


def zoo_statics_from_jax(statics: dict, device: str | torch.device) -> dict:
    """The statics of those families: the remaps as int32 tensors with the
    flat remap computed once, ``n_banks`` / ``rows_per_bank`` as ints, and
    each family's own: DIN's ``cate_offset`` (an int), xDeepFM's
    ``field_offsets`` (an int32 tensor)."""
    bank = to_tensor(statics["remap_bank"], device)
    slot = to_tensor(statics["remap_slot"], device)
    rows_per_bank = int(statics["rows_per_bank"])
    out = {"remap_bank": bank, "remap_slot": slot,
           "remap_flat": flat_remap(bank, slot, rows_per_bank),
           "n_banks": int(statics["n_banks"]),
           "rows_per_bank": rows_per_bank}
    if "cate_offset" in statics:
        out["cate_offset"] = int(statics["cate_offset"])
    if "field_offsets" in statics:
        out["field_offsets"] = to_tensor(statics["field_offsets"], device)
    return out


def lm_params_from_jax(params: dict, device: str | torch.device) -> dict:
    """``repro.models.transformer.init_params`` params (leaves as numpy)
    -> the port's, key for key: ``embed``, ``final_norm``, ``unembed``
    when untied, and ``layers`` with every leaf stacked on its leading
    ``n_layers`` dim."""
    return _tree(params, device)


def gat_params_from_jax(params: dict, device: str | torch.device) -> dict:
    """``repro.models.gat.init_params`` params (leaves as numpy) -> the
    port's: ``{"layers": [{"w", "a_src", "a_dst"}]}``, leaf for leaf."""
    return _tree(params, device)


def _tree(x, device):
    """Nested dicts / lists / tuples of numpy arrays -> the same of
    tensors (JAX's pytree order is the port's, so lists carry over as
    they are)."""
    if isinstance(x, dict):
        return {k: _tree(v, device) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree(v, device) for v in x)
    return None if x is None else to_tensor(x, device)


def train_state_from_jax(state, device: str | torch.device) -> TrainState:
    """A ``repro.train.train_step.TrainState`` with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, state)``) -> the port's
    ``TrainState``: the DLRM params, the optimizer state leaf for leaf
    (``multi_opt``'s ``{"true": ..., "false": ...}``, Adam's ``m``/``v``/
    ``t``, the row-wise Adagrad accumulators), the step count, and the
    error-feedback buffers of gradient compression (``err_state``, shaped
    like the params; None when compression is off). Carries a reference
    run across mid-trajectory."""
    return TrainState(params=params_from_jax(state.params, device),
                      opt_state=_tree(state.opt_state, device),
                      step=to_tensor(state.step, device),
                      err_state=None if state.err_state is None
                      else params_from_jax(state.err_state, device))


def banked_table_from_jax(packed, remap_bank, remap_slot, n_banks: int,
                          rows_per_bank: int,
                          device: str | torch.device) -> BankedTable:
    """A ``repro.core.embedding.BankedTable``'s fields (arrays as numpy)
    -> the port's ``BankedTable``."""
    return BankedTable(packed=to_tensor(packed, device),
                       remap_bank=to_tensor(remap_bank, device),
                       remap_slot=to_tensor(remap_slot, device),
                       n_banks=int(n_banks), rows_per_bank=int(rows_per_bank))


def tiered_table_from_jax(tt, device: str | torch.device) -> TieredTable:
    """A ``repro.quant.TieredTable`` (its arrays as numpy, or anything
    ``np.asarray`` reads) -> the port's ``TieredTable``: payload, scales,
    tier codes and remaps bit for bit, the static fields as they are."""
    return TieredTable(payload=to_tensor(tt.payload, device),
                       scale=to_tensor(tt.scale, device),
                       tier=to_tensor(tt.tier, device),
                       remap_bank=to_tensor(tt.remap_bank, device),
                       remap_slot=to_tensor(tt.remap_slot, device),
                       n_banks=int(tt.n_banks),
                       rows_per_bank=int(tt.rows_per_bank), dim=int(tt.dim),
                       hot_dtype=str(tt.hot_dtype))


def replicated_table_from_jax(rt, device: str | torch.device
                              ) -> ReplicatedTable:
    """A ``repro.core.embedding.ReplicatedTable`` (its arrays as numpy, or
    anything ``np.asarray`` reads) -> the port's ``ReplicatedTable``: the
    packed copies and the ``(vocab, k_max)`` maps as they are."""
    return ReplicatedTable(packed=to_tensor(rt.packed, device),
                           remap_bank=to_tensor(rt.remap_bank, device),
                           remap_slot=to_tensor(rt.remap_slot, device),
                           n_banks=int(rt.n_banks),
                           rows_per_bank=int(rt.rows_per_bank),
                           k_max=int(rt.k_max))
