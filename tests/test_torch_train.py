"""The port's training path against the JAX package's, on the CPU.

The reference's own weights, optimizer state and batches are carried across
with ``repro_torch.convert`` (``jax.random`` cannot be reproduced in torch),
then the same steps run on both sides. The reference's lookup runs its
Pallas kernels in interpret mode (``backend='pallas'``, ``bwd_backend=
'pallas'``), the port's the kernels' plain versions (CPU tensors).

Tolerances, and why: the bag sums and their gradient scatter are bit-exact
(tests/test_torch_scatter.py holds them so), but the MLPs, the interaction
and their gradients are fp32 matmuls and dots summed in another order, so a
gradient agrees to rtol 1e-5 / atol 1e-6. Over several optimizer steps
those differences pass through Adam's ``m / sqrt(v)``, which turns a
relative error into an absolute one on small gradients, so trajectories are
compared on the loss (rtol 1e-4) and on the table after one step (rtol
1e-5 / atol 1e-6).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.partitioning import non_uniform_partition
from repro.data import synthetic as JS
from repro.models import dlrm as JD
from repro.train import optim as JO
from repro.train import train_step as JT
from repro_torch.configs import get_arch
from repro_torch.convert import (params_from_jax, statics_from_jax,
                                 train_state_from_jax)
from repro_torch.launch import train as TTRAIN
from repro_torch.models import dlrm as TD
from repro_torch.train import optim as TO
from repro_torch.train import train_step as TT

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
JAX_KW = dict(backend="pallas", bwd_backend="pallas")


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(t, np.float32)


def _leaves_close(got, want, **tol):
    """Port tree vs reference tree, leaf for leaf in pytree order."""
    g = TO.tree_flatten_with_path(got)
    w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in g] == [jax.tree_util.keystr(p) for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        np.testing.assert_allclose(_np(a), _np(b), err_msg=path, **tol)


def _setup(n_banks=4, seed=0):
    """Reduced updlrm-paper (8 fields x 500 rows, L = 16, D = 8) on an
    n-bank §3.2 plan; the reference's params carried across."""
    jcfg, tcfg = (jax_get_arch("updlrm-paper").reduced,
                  get_arch("updlrm-paper").reduced)
    freq = np.random.default_rng(11).random(jcfg.total_vocab) + 0.05
    plan = non_uniform_partition(freq, n_banks)
    params, statics = JD.init_params(jcfg, jax.random.key(seed), plan=plan)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    return jcfg, tcfg, params, statics, tp, ts


def _batch(cfg, b, step, seed=3, holes=0.15):
    bt = JS.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, b, seed=seed, step=step,
                       multi_hot=cfg.multi_hot)
    rng = np.random.default_rng((seed, step, 7))
    bt["sparse"][rng.random(bt["sparse"].shape) < holes] = -1
    bt["sparse"][0, :, :4] = 5             # in-bag and cross-field repeats
    bt["sparse"][1, :, 0] = 5              # cross-bag repeats
    return bt


def test_loss_gradients_match_jax():
    """One ``loss_fn`` gradient, every leaf, against ``jax.grad`` with the
    Pallas forward and the Pallas sorted-run backward: rtol 1e-5 / atol
    1e-6 (fp32 matmul order; the scatter itself is bit-exact)."""
    jcfg, tcfg, params, statics, tp, ts = _setup()
    bt = _batch(jcfg, 8, 0)
    want = jax.grad(lambda p: JD.loss_fn(
        jcfg, p, statics, {k: jnp.asarray(v) for k, v in bt.items()},
        **JAX_KW))(params)
    leaves = [p.clone().requires_grad_(True) for p in TO.tree_leaves(tp)]
    loss = TD.loss_fn(tcfg, TO.tree_unflatten(tp, leaves), ts,
                      {k: torch.from_numpy(v) for k, v in bt.items()})
    got = TO.tree_unflatten(tp, torch.autograd.grad(loss, leaves))
    _leaves_close(got, want, **GRAD_TOL)
    # the kernels' autograd wrappers pass the gradient on: the table and the
    # bottom MLP (which reaches the loss through the interaction) get some
    assert float(got["emb_packed"].abs().sum()) > 0
    assert all(float(w.abs().sum()) > 0 for w in got["bot"]["w"])
    assert int((got["emb_packed"] != 0).any(1).sum()) < got["emb_packed"].shape[0]


@pytest.mark.parametrize("bwd_backend", ["auto", "torch"])
def test_train_trajectory_matches_jax(bwd_backend):
    """Four steps of ``build_train_step(loss_fn, default_optimizer())`` from
    the same weights on the same batches: losses within rtol 1e-4 (Adam
    amplifies the fp32 gradient differences step by step); the table after
    step 1 within rtol 1e-5 / atol 1e-6 (row-wise Adagrad on gradients that
    agree to 1e-5); the step count and Adam's t exact."""
    jcfg, tcfg, params, statics, tp, ts = _setup(seed=1)
    jopt, topt = JT.default_optimizer(), TT.default_optimizer()
    jstep = jax.jit(JT.build_train_step(
        lambda p, b, **k: JD.loss_fn(jcfg, p, statics, b, **k), jopt,
        loss_kwargs=JAX_KW))
    tstep = TT.build_train_step(
        lambda p, b, **k: TD.loss_fn(tcfg, p, ts, b, **k), topt,
        loss_kwargs={"bwd_backend": bwd_backend})
    js, tst = JT.TrainState.create(params, jopt), TT.TrainState.create(tp, topt)
    jl, tl = [], []
    for step in range(4):
        bt = _batch(jcfg, 8, step)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in bt.items()})
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in bt.items()})
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if step == 0:
            np.testing.assert_allclose(_np(tst.params["emb_packed"]),
                                       _np(js.params["emb_packed"]),
                                       **GRAD_TOL)
            np.testing.assert_allclose(float(tm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert int(tst.step) == int(js.step) == 4
    assert int(tst.opt_state["false"]["t"]) == 4
    assert tl[0] != tl[-1]


def test_train_state_from_jax_round_trips_and_takes_over():
    """A reference state after two steps carries across leaf for leaf
    (exactly: a copy), and a step from it on both sides agrees as one step
    does (rtol 1e-5 / atol 1e-6 on every leaf of params and optimizer
    state)."""
    jcfg, tcfg, params, statics, _, ts = _setup(n_banks=2, seed=2)
    opt = JT.default_optimizer()
    jstep = jax.jit(JT.build_train_step(
        lambda p, b: JD.loss_fn(jcfg, p, statics, b, **JAX_KW), opt))
    js = JT.TrainState.create(params, opt)
    for step in range(2):
        js, _ = jstep(js, {k: jnp.asarray(v)
                           for k, v in _batch(jcfg, 4, step).items()})
    tst = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js), "cpu")
    _leaves_close(tst.params, js.params, rtol=0, atol=0)
    _leaves_close(tst.opt_state, js.opt_state, rtol=0, atol=0)
    assert tst.opt_state["false"]["t"].dtype == torch.int32
    assert tst.step.dtype == torch.int32 and int(tst.step) == 2
    bt = _batch(jcfg, 4, 2)
    js, jm = jstep(js, {k: jnp.asarray(v) for k, v in bt.items()})
    tstep = TT.build_train_step(
        lambda p, b: TD.loss_fn(tcfg, p, ts, b), TT.default_optimizer())
    tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in bt.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    _leaves_close(tst.params, js.params, **GRAD_TOL)
    _leaves_close(tst.opt_state["true"], js.opt_state["true"], **GRAD_TOL)


def test_run_trains_like_jax_on_the_same_weights():
    """The slice end to end: ``launch.train.run`` on the CPU for three
    steps, then the reference's train step from the port's initial weights
    on the same synthetic batches. Losses within rtol 1e-4 (as above)."""
    spec = get_arch("updlrm-paper")
    init = TTRAIN.run(spec, spec.reduced, steps=0, batch=4, seed=5,
                      device="cpu")
    res = TTRAIN.run(spec, spec.reduced, steps=3, batch=4, seed=5,
                     device="cpu")
    assert len(res.losses) == len(res.step_ms) == 3
    assert np.isfinite(res.losses).all() and int(res.state.step) == 3
    assert tuple(res.last_batch["sparse"].shape) == (4, 8, 16)
    jcfg = jax_get_arch("updlrm-paper").reduced
    to_j = lambda t: jnp.asarray(t.numpy())                     # noqa: E731
    jp = jax.tree_util.tree_map(to_j, init.state.params)
    jstat = {k: to_j(v) if isinstance(v, torch.Tensor) else v
             for k, v in init.statics.items() if k != "remap_flat"}
    opt = JT.default_optimizer()
    jstep = jax.jit(JT.build_train_step(
        lambda p, b: JD.loss_fn(jcfg, p, jstat, b, **JAX_KW), opt))
    js = JT.TrainState.create(jp, opt)
    losses = []
    for step in range(3):
        bt = JS.dlrm_batch(jcfg.vocab_sizes, jcfg.n_dense, 4, seed=5,
                           step=step, multi_hot=jcfg.multi_hot)
        js, m = jstep(js, {k: jnp.asarray(v) for k, v in bt.items()})
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(res.losses, losses, rtol=1e-4)


def test_run_backends_agree_and_options_refuse(tmp_path):
    """'auto' and 'torch' are the same plain versions on the CPU, so the
    trajectories are equal; the unported options name their queue item;
    ``--trace-out`` and ``--metrics-out`` write their files."""
    spec = get_arch("updlrm-paper")
    a = TTRAIN.run(spec, spec.reduced, steps=2, batch=3, device="cpu")
    b = TTRAIN.run(spec, spec.reduced, steps=2, batch=3, device="cpu",
                   backend="torch", bwd_backend="torch")
    assert a.losses == b.losses
    for p, q in zip(TO.tree_leaves(a.state.params),
                    TO.tree_leaves(b.state.params)):
        assert torch.equal(p, q)
    for flag in (["--ckpt-dir", "x"], ["--compress-grads"]):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1 #"):
            TTRAIN.main(["--arch", "updlrm-paper", *flag])
    trace, snap = tmp_path / "t.json", tmp_path / "m.json"
    TTRAIN.main(["--arch", "updlrm-paper", "--device", "cpu", "--steps", "2",
                 "--batch", "3", "--trace-out", str(trace), "--metrics-out",
                 str(snap)])
    names = {e["name"] for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"rewrite", "device_step"} <= names
    doc = json.loads(snap.read_text())
    assert doc["meta"] == {"label": "train:updlrm-paper", "schema": 2}
    assert doc["metrics"]["train.step_ms"]["count"] == 2
    assert "fault.straggler_events_total" in doc["metrics"]
    with pytest.raises(RuntimeError, match="is_available"):
        TTRAIN.main(["--arch", "updlrm-paper", "--adaptive"])
    with pytest.raises(NotImplementedError, match="train/compress.py"):
        TT.build_train_step(lambda p, b: 0, TT.default_optimizer(),
                            compress_grads=True)


def test_train_step_refuses_inference_mode():
    _, tcfg, _, _, tp, ts = _setup(n_banks=1)
    opt = TT.default_optimizer()
    step = TT.build_train_step(lambda p, b: TD.loss_fn(tcfg, p, ts, b), opt)
    bt = _batch(jax_get_arch("updlrm-paper").reduced, 2, 0)
    with torch.inference_mode(), pytest.raises(RuntimeError,
                                               match="inference_mode"):
        step(TT.TrainState.create(tp, opt),
             {k: torch.from_numpy(v) for k, v in bt.items()})


# ---------------------------------------------------------------------------
# the dot interaction's backward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("shape", [(6, 9, 8), (3, 2, 5), (4, 27, 16)])
def test_dot_interaction_backward_matches_jax(shape, backend):
    """The gradient of the interaction against ``jax.vjp`` of the
    reference's einsum: rtol 1e-5 / atol 1e-6 (fp32 dots summed in another
    order)."""
    rng = np.random.default_rng(sum(shape))
    z = rng.standard_normal(shape).astype(np.float32)
    B, F, _ = shape
    ct = rng.standard_normal((B, F * (F - 1) // 2)).astype(np.float32)
    out, vjp = jax.vjp(JD.dot_interaction, jnp.asarray(z))
    (want,) = vjp(jnp.asarray(ct))
    zt = torch.from_numpy(z).requires_grad_(True)
    got_out = TD.dot_interaction(zt, backend)
    assert got_out.grad_fn is not None
    (got,) = torch.autograd.grad(got_out, [zt], torch.from_numpy(ct))
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out),
                               **GRAD_TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GRAD_TOL)


# ---------------------------------------------------------------------------
# optimizers: the port's update against the reference's on the same inputs
# ---------------------------------------------------------------------------

def _opt_pair(name):
    """(reference optimizer, port optimizer) of one kind."""
    table = lambda s: "packed" in s or "embed" in s            # noqa: E731
    return {
        "sgd": (JO.sgd(0.1), TO.sgd(0.1)),
        "sgd_momentum": (JO.sgd(0.05, momentum=0.9),
                         TO.sgd(0.05, momentum=0.9)),
        "adam": (JO.adam(0.1), TO.adam(0.1)),
        "adam_wd": (JO.adam(0.01, weight_decay=0.1),
                    TO.adam(0.01, weight_decay=0.1)),
        "rowwise_adagrad": (JO.rowwise_adagrad(0.5), TO.rowwise_adagrad(0.5)),
        "multi_opt": (JO.multi_opt(lambda p: table(jax.tree_util.keystr(p)),
                                   JO.rowwise_adagrad(0.5), JO.adam(0.05)),
                      TO.multi_opt(table, TO.rowwise_adagrad(0.5),
                                   TO.adam(0.05))),
        "default_optimizer": (JT.default_optimizer(0.05, 0.5),
                              TT.default_optimizer(0.05, 0.5)),
    }[name]


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam", "adam_wd",
                                  "rowwise_adagrad", "multi_opt",
                                  "default_optimizer"])
def test_optimizer_updates_match_jax(name):
    """Five updates on the same params and gradients (numpy, from a seed),
    the states carried along on each side: every update and every state
    leaf within rtol 1e-6 / atol 1e-7: the same fp32 formulas in the same
    order (SGD and Adam come out bit-equal), but row-wise Adagrad's per-row
    mean is summed in another order and may differ in the last bit."""
    jopt, topt = _opt_pair(name)
    rng = np.random.default_rng(0)
    p = {"emb_packed": rng.standard_normal((6, 3)).astype(np.float32),
         "bot": {"w": [rng.standard_normal((4, 2)).astype(np.float32)],
                 "b": [rng.standard_normal(2).astype(np.float32)]}}
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = TO.tree_map(torch.from_numpy, p)
    js, ts = jopt.init(jp), topt.init(tp)
    for _ in range(5):
        g = jax.tree_util.tree_map(
            lambda x: rng.standard_normal(x.shape).astype(np.float32), p)
        ju, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tu, ts = topt.update(TO.tree_map(torch.from_numpy, g), ts, tp)
        _leaves_close(tu, ju, rtol=1e-6, atol=1e-7)
        _leaves_close(ts, js, rtol=1e-6, atol=1e-7)
        jp = jax.tree_util.tree_map(lambda a, u: a + u, jp, ju)
        tp = TO.tree_map(lambda a, u: a + u, tp, tu)


def _converges(opt, steps=200, tol=0.05):
    target = torch.tensor([1.0, -2.0, 3.0])
    step = TT.build_train_step(
        lambda p, b: torch.mean((p["w"] - target) ** 2), opt, clip_norm=None)
    state = TT.TrainState.create({"w": torch.zeros(3)}, opt)
    for _ in range(steps):
        state, m = step(state, {})
    return float(m["loss"]) < tol


@pytest.mark.parametrize("name", ["sgd", "sgd_momentum", "adam"])
def test_optimizer_converges(name):
    """``TestOptimizers`` of the reference, on the port: a quadratic."""
    assert _converges(_opt_pair(name)[1])


def test_rowwise_adagrad_converges_on_a_table():
    opt = TO.rowwise_adagrad(0.5)
    target = torch.arange(12.0).reshape(4, 3)
    step = TT.build_train_step(lambda p, b: torch.mean((p["t"] - target) ** 2),
                               opt, clip_norm=None)
    state = TT.TrainState.create({"t": torch.zeros((4, 3))}, opt)
    for _ in range(300):
        state, m = step(state, {})
    assert float(m["loss"]) < 0.5
    assert tuple(state.opt_state["t"].shape) == (4,)        # one per row


def test_default_optimizer_routes_tables_to_adagrad():
    opt = TT.default_optimizer(lr=0.05, emb_lr=0.5)
    params = {"emb_packed": torch.zeros((6, 2)), "dense": {"w": torch.zeros(3)}}
    state = opt.init(params)
    assert [tuple(a.shape) for a in state["true"]] == [(6,)]
    assert [tuple(m.shape) for m in state["false"]["m"]] == [(3,)]
    te, tw = torch.ones((6, 2)), torch.tensor([1.0, 2.0, 3.0])
    step = TT.build_train_step(
        lambda p, b: (torch.mean((p["emb_packed"] - te) ** 2)
                      + torch.mean((p["dense"]["w"] - tw) ** 2)),
        opt, clip_norm=None)
    st = TT.TrainState.create(params, opt)
    for _ in range(300):
        st, m = step(st, {})
    assert float(m["loss"]) < 0.1


@pytest.mark.parametrize("filtered", [False, True])
def test_clip_by_global_norm_matches_jax(filtered):
    """Norm and clipped leaves within rtol 1e-6 (an fp32 sum of squares);
    the filtered form leaves table leaves untouched, as the train step's
    ``_not_table`` asks."""
    rng = np.random.default_rng(1)
    g = {"emb_packed": rng.standard_normal((5, 3)).astype(np.float32) * 4,
         "top": {"w": [rng.standard_normal((3, 2)).astype(np.float32)]}}
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    tg = TO.tree_map(torch.from_numpy, g)
    if filtered:
        want, wn = JO.clip_by_global_norm_filtered(jg, 1.0, JT._not_table)
        got, gn = TO.clip_by_global_norm_filtered(tg, 1.0, TT._not_table)
        assert torch.equal(got["emb_packed"], tg["emb_packed"])
    else:
        want, wn = JO.clip_by_global_norm(jg, 1.0)
        got, gn = TO.clip_by_global_norm(tg, 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    _leaves_close(got, want, rtol=1e-6, atol=1e-7)
    small, n = TO.clip_by_global_norm({"a": torch.tensor([3.0, 4.0])}, 10.0)
    assert float(n) == 5.0 and torch.equal(small["a"], torch.tensor([3.0, 4.0]))


def test_cosine_schedule_matches_jax():
    jl, tl = JO.cosine_schedule(1.0, 10, 100), TO.cosine_schedule(1.0, 10, 100)
    for s in (0, 3, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(tl(s)), float(jl(s)), rtol=1e-6,
                                   atol=1e-7)
    assert float(tl(0)) == 0.0 and float(tl(100)) < 0.01


def test_tree_paths_are_the_references():
    """The port names and orders leaves as JAX's ``keystr`` and pytree
    flatten do, which ``multi_opt`` routing and the state carry rely on."""
    _, _, params, _, tp, _ = _setup(n_banks=1)
    want = [jax.tree_util.keystr(p)
            for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    assert [p for p, _ in TO.tree_flatten_with_path(tp)] == want
    assert TO.tree_flatten_with_path({"a": None, "b": ()}) == []


@pytest.mark.parametrize("dataclass_field", ["params", "opt_state"])
def test_train_state_create_matches_jax_structure(dataclass_field):
    _, _, params, _, tp, _ = _setup(n_banks=1)
    js = JT.TrainState.create(params, JT.default_optimizer())
    tst = TT.TrainState.create(tp, TT.default_optimizer())
    _leaves_close(getattr(tst, dataclass_field),
                  getattr(js, dataclass_field), rtol=0, atol=0)
    assert dataclasses.is_dataclass(tst) and int(tst.step) == 0


def test_tree_helpers_leave_no_reference_cycle():
    """Rebuilding a tree must not keep its leaves alive past the last
    reference (a self-referencing closure would, until the garbage
    collector runs: GB-sized gradients and tables piled up on the card)."""
    import gc
    import weakref
    gc.disable()
    try:
        leaf = torch.ones(4)
        ref = weakref.ref(leaf)
        out = TO.tree_unflatten({"b": [0, (0,)], "a": None}, [leaf, leaf * 2])
        assert out["b"][0] is leaf and out["a"] is None
        del leaf, out
        assert ref() is None
        leaf = torch.ones(4)
        ref = weakref.ref(leaf)
        TO.tree_map(lambda x: x + 1, {"w": [leaf]})
        del leaf
        assert ref() is None
    finally:
        gc.enable()
