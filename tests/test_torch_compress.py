"""The port's int8 gradient compression against the JAX package's, on the
CPU.

The reference always runs ``compress_roundtrip`` inside its jitted train
step, where XLA folds the division by 127 into a multiplication by its
fp32 reciprocal and fuses ``x - q * scale`` into one rounding; the port
computes the same, so it is compared with ``jax.jit`` of the reference's
functions and must equal it bit for bit (``assert_array_equal``).

Train steps: with the DLRM loss the gradients differ from the reference's
in fp32 rounding (tests/test_torch_train.py), so the compressed
trajectory's losses are compared within rtol 1e-4; with a loss that reads
the table only through the bag sums and is linear in them, the table's
gradient is the bag-sum scatter of one fixed cotangent on both sides
(bit-exact), and so is every step's error-feedback state.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding as JE
from repro.core.partitioning import non_uniform_partition
from repro.data import synthetic as JS
from repro.models import dlrm as JD
from repro.train import compress as JC
from repro.train import train_step as JT
from repro_torch.configs import get_arch
from repro_torch.convert import (params_from_jax, statics_from_jax,
                                 train_state_from_jax)
from repro_torch.core import embedding as TE
from repro_torch.models import dlrm as TD
from repro_torch.train import compress as TC
from repro_torch.train import optim as TO
from repro_torch.train import train_step as TT

JAX_KW = dict(backend="pallas", bwd_backend="pallas")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.dtype == torch.bfloat16 \
            else x.detach().numpy()
    return np.asarray(x).astype(np.float32) \
        if np.asarray(x).dtype.name == "bfloat16" else np.asarray(x)


def _equal(got, want):
    g = TO.tree_flatten_with_path(got)
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_array_equal(_np(a), _np(b), err_msg=path)


def _grads(rng, scale_pick=(1e-30, 1e-6, 1e-3, 1.0, 1e3)):
    """A gradient tree: a table-like (200, 8) leaf, MLP-like leaves, one of
    them bf16; each leaf drawn at its own random scale."""
    def draw(shape):
        return (rng.standard_normal(shape)
                * rng.choice(scale_pick)).astype(np.float32)
    return {"emb_packed": draw((200, 8)),
            "bot": {"w": [draw((13, 4))], "b": [draw((4,))]},
            "top": {"w": [draw((7, 1))], "b": [np.zeros(1, np.float32)]}}


@pytest.mark.parametrize("bf16_leaf", [False, True])
def test_compress_roundtrip_matches_jax_over_50_steps(bf16_leaf):
    """50 error-feedback steps on the same gradients: every compressed
    gradient, every error buffer, and each leaf's (q, scale) equal to the
    reference's bit for bit; a bf16 gradient leaf comes back bf16."""
    rng = np.random.default_rng(7)
    jround = jax.jit(JC.compress_roundtrip)
    jquant = jax.jit(JC.quantize_int8)
    g0 = _grads(rng)
    je = JC.init_error_state(jax.tree_util.tree_map(jnp.asarray, g0))
    te = TC.init_error_state(TO.tree_map(torch.from_numpy, g0))
    _equal(te, je)
    for _ in range(50):
        g = _grads(rng)
        jg = jax.tree_util.tree_map(jnp.asarray, g)
        tg = TO.tree_map(torch.from_numpy, g)
        if bf16_leaf:
            jg["bot"]["w"][0] = jg["bot"]["w"][0].astype(jnp.bfloat16)
            tg["bot"]["w"][0] = tg["bot"]["w"][0].to(torch.bfloat16)
        jg2, je = jround(jg, je)
        tg2, te = TC.compress_roundtrip(tg, te)
        _equal(tg2, jg2)
        _equal(te, je)
        assert tg2["bot"]["w"][0].dtype == (torch.bfloat16 if bf16_leaf
                                            else torch.float32)
        x = g["emb_packed"]
        jq, js = jquant(jnp.asarray(x))
        tq, ts = TC.quantize_int8(torch.from_numpy(x))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert float(ts) == float(js)
        np.testing.assert_array_equal(
            TC.dequantize_int8(tq, ts).numpy(),
            np.asarray(jax.jit(JC.dequantize_int8)(jq, js)))


def test_quantize_int8_edges():
    """All zeros quantize to zeros at the 1e-12 floor; the largest |x|
    maps to +-127; the error state starts as fp32 zeros."""
    q, s = TC.quantize_int8(torch.zeros(5))
    assert torch.equal(q, torch.zeros(5, dtype=torch.int8))
    assert float(s) == float(jax.jit(JC.quantize_int8)(jnp.zeros(5))[1])
    q, _ = TC.quantize_int8(torch.tensor([-3.0, 0.5, 3.0]))
    assert q.tolist() == [-127, 21, 127]
    e = TC.init_error_state({"a": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert e["a"].dtype == torch.float32 and not e["a"].any()
    with pytest.raises(TypeError, match="DistCtx"):
        TC.psum_int8(torch.ones(2), "data")


def _setup(seed=0):
    """Reduced updlrm-paper (8 fields x 500 rows, L = 16, D = 8) on a
    4-bank §3.2 plan; the reference's params carried across."""
    jcfg, tcfg = (jax_get_arch("updlrm-paper").reduced,
                  get_arch("updlrm-paper").reduced)
    freq = np.random.default_rng(11).random(jcfg.total_vocab) + 0.05
    plan = non_uniform_partition(freq, 4)
    params, statics = JD.init_params(jcfg, jax.random.key(seed), plan=plan)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    return jcfg, tcfg, params, statics, tp, ts


def _batch(cfg, b, step, seed=3):
    bt = JS.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, b, seed=seed, step=step,
                       multi_hot=cfg.multi_hot)
    rng = np.random.default_rng((seed, step, 7))
    bt["sparse"][rng.random(bt["sparse"].shape) < 0.15] = -1
    bt["sparse"][0, :, :4] = 5             # in-bag and cross-field repeats
    return bt


def _bag_sum_losses(jcfg, statics, ts):
    """(reference, port) losses linear in the bag sums: sum(emb * c) for a
    fixed cotangent c, so the table's gradient is the bag-sum scatter of c
    on both sides."""
    c = np.random.default_rng(5).standard_normal(
        (6, jcfg.n_sparse, jcfg.embed_dim)).astype(np.float32)

    def jloss(p, b, **kw):
        t = JD._banked(p, statics)
        emb = JE.banked_embedding_bag(t, b["sparse"], None,
                                      field_offsets=statics["field_offsets"],
                                      **kw)
        return jnp.sum(emb * jnp.asarray(c))

    def tloss(p, b, **kw):
        t = TD._banked(p, ts)
        emb = TE.banked_embedding_bag(t, b["sparse"],
                                      field_offsets=ts["field_offsets"], **kw)
        return torch.sum(emb * torch.from_numpy(c))
    return jloss, tloss


@pytest.mark.parametrize("loss", ["bag_sums", "dlrm"])
def test_compressed_trajectory_matches_jax(loss):
    """Four steps of ``build_train_step(compress_grads=True)`` with
    ``default_optimizer`` from the same weights on the same batches.
    'bag_sums': the error-feedback state equals the reference's bit for bit
    at every step (the compressed table gradient with it), losses within
    rtol 1e-5. 'dlrm': losses within rtol 1e-4 (as the uncompressed
    trajectory's, tests/test_torch_train.py). Both: the step count exact,
    the table's error buffer non-zero."""
    jcfg, tcfg, params, statics, tp, ts = _setup(seed=1)
    if loss == "dlrm":
        jloss = lambda p, b, **k: JD.loss_fn(jcfg, p, statics, b, **k)  # noqa
        tloss = lambda p, b, **k: TD.loss_fn(tcfg, p, ts, b, **k)  # noqa
    else:
        jloss, tloss = _bag_sum_losses(jcfg, statics, ts)
    jopt, topt = JT.default_optimizer(), TT.default_optimizer()
    jstep = jax.jit(JT.build_train_step(jloss, jopt, compress_grads=True,
                                        loss_kwargs=JAX_KW))
    tstep = TT.build_train_step(tloss, topt, compress_grads=True)
    js = JT.TrainState.create(params, jopt, compress=True)
    tst = TT.TrainState.create(tp, topt, compress=True)
    _equal(tst.err_state, js.err_state)
    jl, tl = [], []
    for step in range(4):
        bt = _batch(jcfg, 6, step)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in bt.items()})
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in bt.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if loss == "bag_sums":
            _equal(tst.err_state, js.err_state)
    np.testing.assert_allclose(tl, jl, rtol=1e-5 if loss == "bag_sums"
                               else 1e-4)
    assert int(tst.step) == int(js.step) == 4
    assert bool(tst.err_state["emb_packed"].any())


def test_train_state_from_jax_carries_err_state():
    """A compressed reference state after two steps carries across leaf for
    leaf, err_state included (exactly: a copy); one more compressed step
    on both sides gives losses within rtol 1e-5."""
    jcfg, tcfg, params, statics, _, ts = _setup(seed=2)
    opt = JT.default_optimizer()
    jstep = jax.jit(JT.build_train_step(
        lambda p, b: JD.loss_fn(jcfg, p, statics, b, **JAX_KW), opt,
        compress_grads=True))
    js = JT.TrainState.create(params, opt, compress=True)
    for step in range(2):
        js, _ = jstep(js, {k: jnp.asarray(v)
                           for k, v in _batch(jcfg, 4, step).items()})
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    _equal(tst.err_state, js.err_state)
    _equal(tst.params, js.params)
    assert tst.err_state["emb_packed"].dtype == torch.float32
    bt = _batch(jcfg, 4, 2)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in bt.items()})
    tstep = TT.build_train_step(lambda p, b: TD.loss_fn(tcfg, p, ts, b),
                                TT.default_optimizer(), compress_grads=True)
    tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in bt.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert tst.err_state is not None and int(tst.step) == 3


def test_train_state_create_compress_matches_jax_structure():
    """``TrainState.create(compress=True)`` builds fp32 zero buffers shaped
    like every param, a bf16 table's included, as the reference's."""
    jcfg = dataclasses.replace(jax_get_arch("dlrm-rm2").reduced,
                               emb_dtype=jnp.bfloat16)
    params, _ = JD.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    js = JT.TrainState.create(params, JT.default_optimizer(), compress=True)
    tst = TT.TrainState.create(tp, TT.default_optimizer(), compress=True)
    _equal(tst.err_state, js.err_state)
    assert all(e.dtype == torch.float32
               for e in TO.tree_leaves(tst.err_state))
    assert TT.TrainState.create(tp, TT.default_optimizer()).err_state is None
