"""The port's MoE path gives the same bits on every run.

``moe_layer`` and ``moe_layer_sharded`` add each token's routed slots in a
fixed order (ascending buffer position, the reference's scatter order),
and the token embedding's backward adds a token's repeated rows in token
order, so nothing in the LM path depends on how CPU threads or CUDA
atomics order the adds. Held here at 2 and 8 CPU threads:
  * granite-moe-1b-a400m (reduced) ``lm_loss`` gradients, taken twice from
    the same params and batch, bit-equal in every leaf, at fp32 and at the
    config's bf16; three ``launch.train.run`` steps run twice bit-equal in
    every loss and every leaf of the train state;
  * ``moe_layer``'s output and gradients, taken twice, bit-equal, and
    within fp32 rounding of ``jax.vjp`` of the reference's ``moe_layer``
    (capacity drops included): rtol 1e-5 with an atol of 1e-5 of the
    array's largest magnitude, for sums over up to 512 tokens;
  * ``moe_layer_sharded``'s forward and backward run twice on four gloo
    ranks (rank side ``tests/torch_moe_det_ranks.py``, torch only) as a
    1 x 4 and a 2 x 2 grid, bit-equal on every rank; on 1 x 4 (whose
    capacity is the single device's) within the same tolerance of
    ``jax.vjp``'s output and gradients.
The ranks' routing is held exactly by ``tests/test_torch_dist_lm.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.configs import get_arch
from repro_torch.data import synthetic as syn
from repro_torch.dist.launch import run_ranks
from repro_torch.launch import train as LT
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.train import optim as O

import torch_moe_det_ranks as R

ARCH = "granite-moe-1b-a400m"
THREADS = (2, 8)
RTOL = 1e-5
WORLD = 4


@pytest.fixture
def threads(request):
    before = torch.get_num_threads()
    torch.set_num_threads(request.param)
    yield request.param
    torch.set_num_threads(before)


def _leaves(tree):
    return [v for _, v in O.tree_flatten_with_path(tree)]


def _assert_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()),
                               err_msg=what)


def _cfg(dt):
    cfg = get_arch(ARCH).reduced
    return dataclasses.replace(cfg, dtype=torch.float32) if dt == "f32" \
        else cfg


def _assert_bit_equal(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.dtype == y.dtype and torch.equal(x, y), f"{what}: leaf {i}"


# ---------------------------------------------------------------------------
# the LM path on one device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", THREADS, indirect=True)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_loss_gradients_bit_equal(threads, dt):
    """Batch 8 x 64: the expert dispatch (8 x 64 x 8 slots of width 64)
    and the embedding's cotangent (8 x 64 x 64) both pass 32 k elements,
    where the CPU's indexed adds go parallel."""
    cfg = _cfg(dt)
    params = TT.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    b = syn.lm_batch(8, 64, cfg.vocab, seed=1, step=0)
    toks, labels = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    flat = O.tree_flatten_with_path(params)

    def grads():
        leaves = [v.clone().requires_grad_(True) for _, v in flat]
        loss = TT.lm_loss(cfg, O.tree_unflatten(params, leaves), toks, labels)
        return [loss.detach(), *torch.autograd.grad(loss, leaves)]

    _assert_bit_equal(grads(), grads(), f"lm_loss gradients at {threads} "
                                        f"threads")


@pytest.mark.parametrize("threads", THREADS, indirect=True)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_three_train_steps_bit_equal(threads, dt):
    spec = get_arch(ARCH)
    runs = [LT.run(spec, _cfg(dt), steps=3, batch=8, seed=2, device="cpu")
            for _ in range(2)]
    assert runs[0].losses == runs[1].losses
    _assert_bit_equal(_leaves(runs[0].state.params),
                      _leaves(runs[1].state.params), "params")
    _assert_bit_equal(_leaves(runs[0].state.opt_state),
                      _leaves(runs[1].state.opt_state), "optimizer state")


# ---------------------------------------------------------------------------
# moe_layer against jax.vjp, twice
# ---------------------------------------------------------------------------

MOE_CASES = {  # (T, E, top_k, capacity factor, router scale)
    "top8": (256, 8, 8, 1.25, 0.3),
    "top2_drops": (512, 8, 2, 0.5, 3.0),
    "top4": (512, 16, 4, 1.25, 1.0),
}


def _moe_inputs(T, E, scale, d=64, ff=32, seed=5):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, d)).astype(np.float32),
            (rng.standard_normal((d, E)) * scale).astype(np.float32),
            (rng.standard_normal((E, d, ff)) / 8).astype(np.float32),
            (rng.standard_normal((E, d, ff)) / 8).astype(np.float32),
            (rng.standard_normal((E, ff, d)) / 6).astype(np.float32),
            rng.standard_normal((T, d)).astype(np.float32))


@pytest.mark.parametrize("threads", THREADS, indirect=True)
@pytest.mark.parametrize("case", sorted(MOE_CASES))
def test_moe_layer_vjp_bit_equal_and_matches_jax(threads, case):
    T, E, k, cf, scale = MOE_CASES[case]
    *args, ct = _moe_inputs(T, E, scale)
    out, vjp = jax.vjp(lambda *a: JL.moe_layer(
        *a, top_k=k, capacity_factor=cf)[0], *(jnp.asarray(a) for a in args))
    want = [out, *vjp(jnp.asarray(ct))]

    def run():
        ts = [torch.from_numpy(a).requires_grad_(True) for a in args]
        y, stats = TL.moe_layer(*ts, top_k=k, capacity_factor=cf)
        return [y.detach(), *torch.autograd.grad(y, ts,
                                                 torch.from_numpy(ct))], stats

    (a, stats), (b, _) = run(), run()
    _assert_bit_equal(a, b, f"moe_layer {case} at {threads} threads")
    if case == "top2_drops":
        assert float(stats.dropped) > 0.1
    for name, g, w in zip(("y", "x", "w_router", "w_gate", "w_up",
                           "w_down"), a, want):
        _assert_close(g.numpy(), w, name)


# ---------------------------------------------------------------------------
# moe_layer_sharded on gloo ranks
# ---------------------------------------------------------------------------

def _sharded_inputs():
    """8 x 64 tokens of width 64, 8 experts, top 4 at capacity factor
    1.25: a rank's buffer holds 640 rows of 64 on either grid."""
    *args, ct = _moe_inputs(512, 8, 0.5, seed=9)
    names = ("moe.x", "moe.w_router", "moe.w_gate", "moe.w_up",
             "moe.w_down")
    inp = {n: a for n, a in zip(names, args)}
    inp["moe.x"] = inp["moe.x"].reshape(8, 64, 64)
    inp["moe.ct"] = ct.reshape(8, 64, 64)
    inp.update({"moe.top_k": np.array(4), "moe.cf": np.array(1.25)})
    return inp


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    inp = _sharded_inputs()
    outs = run_ranks(R.moe_runs, WORLD, tmp_path_factory.mktemp("moe_det"),
                     inputs=inp, backend="gloo", timeout=300)
    return inp, outs


NAMES = ("y", "gx", "gw_router", "gw_gate", "gw_up", "gw_down")


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("dt", sorted(R.DTYPES))
@pytest.mark.parametrize("n", R.THREADS)
def test_moe_layer_sharded_bit_equal_on_ranks(sharded_runs, grid, dt, n):
    _, outs = sharded_runs
    for r, o in enumerate(outs):
        for name in NAMES:
            key = f"{grid}.{dt}.t{n}"
            np.testing.assert_array_equal(o[f"{key}.r0.{name}"],
                                          o[f"{key}.r1.{name}"],
                                          err_msg=f"rank {r} {key} {name}")


def test_moe_layer_sharded_matches_jax_vjp(sharded_runs):
    """1 x 4 at fp32: each rank's output and token cotangent are the
    whole batch's, its router cotangent the whole router's, its expert
    cotangents its bank's slice of ``jax.vjp``'s."""
    inp, outs = sharded_runs
    x = inp["moe.x"].reshape(-1, 64)
    args = [jnp.asarray(a) for a in (x, inp["moe.w_router"],
                                     inp["moe.w_gate"], inp["moe.w_up"],
                                     inp["moe.w_down"])]
    out, vjp = jax.vjp(lambda *a: JL.moe_layer(
        *a, top_k=4, capacity_factor=1.25)[0], *args)
    want = [np.asarray(w) for w in (out, *vjp(jnp.asarray(
        inp["moe.ct"].reshape(-1, 64))))]
    e_loc = inp["moe.w_gate"].shape[0] // WORLD
    for r, o in enumerate(outs):
        got = {name: o[f"1x4.f32.t2.r0.{name}"] for name in NAMES}
        _assert_close(got["y"].reshape(-1, 64), want[0], f"rank {r} y")
        _assert_close(got["gx"].reshape(-1, 64), want[1], f"rank {r} gx")
        _assert_close(got["gw_router"], want[2], f"rank {r} gw_router")
        for name, w in zip(NAMES[3:], want[3:]):
            _assert_close(got[name], w[r * e_loc:(r + 1) * e_loc],
                          f"rank {r} {name}")
