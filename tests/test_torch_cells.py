"""The port's cells (``repro_torch/configs/shapes.py``) and FLOP count
(``repro_torch/launch/roofline.model_flops``) against the JAX package's,
and one reduced step of every cell in the port (the counterpart of
``tests/test_models_smoke.py``):

  * ``get_cell``, ``gat_config_for_shape``, ``sampled_block_dims`` and
    ``smoke_batch`` equal the reference's for every (arch x shape) of the
    registry: the same cell, the same reduced config field for field
    (dtypes by name), the same numpy arrays;
  * ``param_count`` of every full and reduced config, and ``model_flops``
    of every cell, equal the reference's exactly;
  * every cell's reduced step runs in the port on the CPU with finite
    outputs of the expected shape: the loss of a train cell, prefill
    logits, one decode step from an empty cache, serve scores, retrieval
    scores (``updlrm-paper``'s multi-hot retrieval cell raises, as the
    reference's retrieval does on multi-hot bags).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import shapes as JSH
from repro.launch import roofline as JR
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import shapes as TSH
from repro_torch.launch import roofline as TR

CELLS = [(a, s) for a, spec in ARCHS.items() for s in spec.shapes]
IDS = [f"{a}-{s}" for a, s in CELLS]


def test_registry_covers_the_reference():
    from repro.configs.registry import ARCHS as JARCHS
    assert list(ARCHS) == list(JARCHS)
    for a in ARCHS:
        t, j = get_arch(a), jax_get_arch(a)
        assert (t.family, t.shapes, t.notes) == (j.family, j.shapes,
                                                 j.notes), a
        _same_config(t.config, j.config)
        _same_config(t.reduced, j.reduced)


def _same_config(got, want):
    assert type(got).__name__ == type(want).__name__
    for f in dataclasses.fields(want):
        gv, wv = getattr(got, f.name), getattr(want, f.name)
        if isinstance(gv, torch.dtype):
            assert str(gv).split(".")[-1] == jnp.dtype(wv).name, f.name
        elif dataclasses.is_dataclass(wv):
            _same_config(gv, wv)
        else:
            assert gv == wv, f.name


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_cell_matches_reference(arch, shape):
    got, want = TSH.get_cell(arch, shape), JSH.get_cell(arch, shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    if get_arch(arch).family == "gat":
        _same_config(TSH.gat_config_for_shape(get_arch(arch).config,
                                              got.dims),
                     JSH.gat_config_for_shape(jax_get_arch(arch).config,
                                              want.dims))


@pytest.mark.parametrize("args", [(1024, 15, 10), (8, 3, 2), (1, 1, 1),
                                  (7, 5, 4)])
def test_sampled_block_dims(args):
    assert TSH.sampled_block_dims(*args) == JSH.sampled_block_dims(*args)


def test_tables_match_reference():
    for name in ("LM_CELLS_RED", "RECSYS_CELLS_RED", "GNN_CELLS_RED",
                 "SLATE"):
        assert getattr(TSH, name) == getattr(JSH, name), name
    for name in ("LM_CELLS", "RECSYS_CELLS", "GNN_CELLS"):
        t, j = getattr(TSH, name), getattr(JSH, name)
        assert {k: dataclasses.asdict(v) for k, v in t.items()} == \
            {k: dataclasses.asdict(v) for k, v in j.items()}, name


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
@pytest.mark.parametrize("seed", [0, 3])
def test_smoke_batch_matches_reference(arch, shape, seed):
    tk, tcfg, tb = TSH.smoke_batch(arch, shape, seed=seed)
    jk, jcfg, jb = JSH.smoke_batch(arch, shape, seed=seed)
    assert tk == jk
    _same_config(tcfg, jcfg)
    assert sorted(tb) == sorted(jb)
    for k in jb:
        if isinstance(jb[k], np.ndarray):
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        else:
            assert tb[k] == jb[k], k


@pytest.mark.parametrize("arch", list(ARCHS))
def test_param_count_matches_reference(arch):
    t, j = get_arch(arch), jax_get_arch(arch)
    assert t.config.param_count() == j.config.param_count()
    assert t.reduced.param_count() == j.reduced.param_count()


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_model_flops_matches_reference(arch, shape):
    got, want = TR.model_flops(arch, shape), JR.model_flops(arch, shape)
    assert got == want and got > 0


# ---------------------------------------------------------------------------
# one reduced step of every cell in the port
# ---------------------------------------------------------------------------

def _finite(x: torch.Tensor) -> bool:
    return bool(torch.isfinite(x).all())


def _init(spec, cfg):
    from repro_torch.models import family_module
    gen = torch.Generator().manual_seed(0)
    mod = family_module(spec.family)
    if spec.family in ("lm", "gat"):
        return mod, mod.init_params(cfg, gen, device="cpu"), None
    params, statics = mod.init_params(cfg, gen, device="cpu")
    return mod, params, statics


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_cell_smoke(arch, shape):
    spec = get_arch(arch)
    kind, cfg, batch = TSH.smoke_batch(arch, shape)
    mod, params, statics = _init(spec, cfg)
    b = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for k, v in batch.items()}
    with torch.no_grad():
        if spec.family == "lm":
            if kind == "train":
                loss = mod.lm_loss(cfg, params, b["tokens"], b["labels"])
                assert loss.shape == () and _finite(loss)
            elif kind == "prefill":
                logits = mod.prefill(cfg, params, b["tokens"])
                assert logits.shape == (b["tokens"].shape[0],
                                        cfg.padded_vocab)
                assert _finite(logits[:, :cfg.vocab])
            else:
                B = b["token"].shape[0]
                cache = mod.KVCache.empty(cfg, B, b["s_max"], device="cpu")
                logits, cache = mod.decode_step(cfg, params, cache,
                                                b["token"])
                assert logits.shape == (B, cfg.padded_vocab)
                assert int(cache.length) == 1
                assert _finite(logits[:, :cfg.vocab])
            return
        if spec.family == "gat":
            loss = mod.cell_loss(shape)(cfg, params, b)
            assert loss.shape == () and _finite(loss)
            return
        if kind == "train":
            loss = mod.loss_fn(cfg, params, statics, b)
            assert loss.shape == () and _finite(loss)
        elif kind == "retrieval" and getattr(cfg, "multi_hot", 1) > 1:
            # the reference's retrieval is one-hot only (its
            # field_offsets[None, 1:] does not broadcast over bags)
            with pytest.raises(ValueError, match="one-hot fields only"):
                mod.retrieval_scores(cfg, params, statics, b)
        elif kind == "retrieval":
            scores = mod.retrieval_scores(cfg, params, statics, b)
            assert scores.dim() in (1, 2) and _finite(scores)
        elif spec.family == "bert4rec":
            assert _finite(mod.next_item_scores(cfg, params, statics, b))
        else:
            logits = mod.forward(cfg, params, statics, b)
            assert logits.shape[0] == next(iter(b.values())).shape[0]
            assert _finite(logits)
