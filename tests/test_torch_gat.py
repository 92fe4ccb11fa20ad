"""The port's GAT family (``repro_torch.models.gat``, ``sparse/ops``'
segment ops, ``sparse/sampler.py`` and the graph generators) against the
JAX package's, on the CPU, with the reference's own weights carried
across by ``repro_torch.convert.gat_params_from_jax`` and its numpy
batches:

  * ``segment_sum`` / ``_max`` / ``_mean`` / ``_softmax`` on 1-D and N-D
    data with empty segments, all-negative segments and -1e30 masks
    (rtol 1e-6 / atol 1e-7; the softmax and its gradient rtol 1e-5 /
    atol 1e-6; empty maxima -inf on both sides);
  * ``random_graph``, ``molecule_batch``, ``build_csr`` and the
    ``NeighborSampler``'s blocks ``assert_array_equal`` to the
    reference's;
  * ``gat_layer``, ``forward_full``, ``forward_blocks`` and the three
    losses on the reduced config at every GNN cell's ``smoke_batch``, and
    with nodes whose in-edges are all padding: outputs and losses at
    rtol 1e-5 / atol 1e-6, every gradient against ``jax.grad`` at the
    same tolerance;
  * 3 Adam steps (``build_train_step(loss, adam(1e-3), clip_norm=None)``,
    the reference's ``_gat_cell`` step) against the reference's jitted
    step: losses at rtol 1e-5, params at rtol 1e-4 / atol 1e-6 (Adam's
    update divides by the gradient's own scale);
  * the train CLI refuses ``--arch gat-cora`` with the reference's
    message and the serve CLI refuses it (recsys families only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import shapes as JSH
from repro.data import synthetic as JS
from repro.models import gat as JG
from repro.sparse import ops as JO
from repro.sparse import sampler as JSA
from repro.train import optim as JOPT
from repro.train import train_step as JTS
from repro_torch.configs import get_arch
from repro_torch.convert import gat_params_from_jax
from repro_torch.data import synthetic as TS
from repro_torch.models import gat as TG
from repro_torch.sparse import ops as TO
from repro_torch.sparse import sampler as TSA
from repro_torch.train import optim as TOPT
from repro_torch.train import train_step as TTS

TOL = dict(rtol=1e-5, atol=1e-6)
SEG_TOL = dict(rtol=1e-6, atol=1e-7)
SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")
JLOSS = {"minibatch_lg": JG.loss_blocks, "molecule": JG.loss_molecule}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# segment ops
# ---------------------------------------------------------------------------

def _seg_data(kind: str, ndim: int):
    """(data, ids, num_segments): 40 rows over 12 segments, 3, 7 and 11
    empty; ``neg``: all values negative; ``masked``: a third of the rows
    at -1e30, and every row of segment 4."""
    rng = np.random.default_rng(ndim * 7 + len(kind))
    ids = rng.integers(0, 11, 40)
    ids[np.isin(ids, (3, 7))] = 5
    tail = {1: (), 2: (3,), 3: (2, 3)}[ndim]
    x = rng.standard_normal((40, *tail)).astype(np.float32)
    if kind == "neg":
        x = -np.abs(x) - 2.0
    if kind == "masked":
        x[rng.random(40) < 0.3] = -1e30
        x[ids == 4] = -1e30
    return x, ids, 12


def _cmp_inf(got, want, tol):
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **tol)


@pytest.mark.parametrize("op", ["sum", "max", "softmax"])
@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("kind", ["plain", "neg", "masked"])
def test_segment_ops(op, ndim, kind):
    x, ids, n = _seg_data(kind, ndim)
    got = getattr(TO, f"segment_{op}")(_t(x), _t(ids), n).numpy()
    want = _np(getattr(JO, f"segment_{op}")(jnp.asarray(x),
                                            jnp.asarray(ids), n))
    assert got.shape == want.shape and got.dtype == want.dtype
    _cmp_inf(got, want, TOL if op == "softmax" else SEG_TOL)
    if op == "max":
        assert np.isneginf(got[[3, 7, 11]]).all()


@pytest.mark.parametrize("ndim", [1, 2])
@pytest.mark.parametrize("kind", ["plain", "neg"])
def test_segment_mean(ndim, kind):
    x, ids, n = _seg_data(kind, ndim)
    got = TO.segment_mean(_t(x), _t(ids), n).numpy()
    want = _np(JO.segment_mean(jnp.asarray(x), jnp.asarray(ids), n))
    np.testing.assert_allclose(got, want, **SEG_TOL)
    assert (got[[3, 7, 11]] == 0).all()


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("kind", ["plain", "masked"])
def test_segment_softmax_grad(ndim, kind):
    x, ids, n = _seg_data(kind, ndim)
    w = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    want = _np(jax.grad(lambda v: (JO.segment_softmax(
        v, jnp.asarray(ids), n) * w).sum())(jnp.asarray(x)))
    xt = _t(x).requires_grad_(True)
    (TO.segment_softmax(xt, _t(ids), n) * _t(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# generators and the sampler
# ---------------------------------------------------------------------------

def _same_dict(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("args,power_law", [((40, 120, 16, 3), True),
                                            ((200, 2000, 8, 4), True),
                                            ((3000, 25000, 4, 5), True),
                                            ((50, 300, 6, 2), False)])
def test_random_graph(args, power_law, monkeypatch):
    # a small draw chunk, so the threaded search of a large draw runs here
    monkeypatch.setattr(TS, "_DRAW_CHUNK", 4096)
    _same_dict(TS.random_graph(*args, seed=5, power_law=power_law),
               JS.random_graph(*args, seed=5, power_law=power_law))


@pytest.mark.parametrize("args", [(4, 6, 10, 16, 3), (128, 30, 64, 16, 2),
                                  (3, 1, 0, 2, 2)])
def test_molecule_batch(args):
    _same_dict(TS.molecule_batch(*args, seed=2, step=3),
               JS.molecule_batch(*args, seed=2, step=3))


def _graph(n, e, seed):
    g = JS.random_graph(n, e, 4, 3, seed=seed)
    return g, g["edge_src"].astype(np.int64), g["edge_dst"].astype(np.int64)


@pytest.mark.parametrize("n,e", [(200, 2000), (50, 30), (1000, 20000)])
def test_build_csr(n, e):
    _, src, dst = _graph(n, e, 4)
    got, want = TSA.build_csr(src, dst, n), JSA.build_csr(src, dst, n)
    assert got.n_nodes == want.n_nodes and got.n_edges == want.n_edges
    for f in ("indptr", "indices"):
        assert getattr(got, f).dtype == getattr(want, f).dtype
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(got.degree(), want.degree())


@pytest.mark.parametrize("n", [1, 7, 65536, 65537, 232965, 1 << 20])
def test_stable_order(n):
    """The radix order equals numpy's stable argsort, ties in index order
    (few distinct keys) and across 16-bit digits."""
    rng = np.random.default_rng(n)
    for keys in (rng.integers(0, n, 5000), rng.integers(0, min(n, 3), 5000),
                 np.full(100, n - 1)):
        np.testing.assert_array_equal(TSA.stable_order(keys, n),
                                      np.argsort(keys, kind="stable"))


@pytest.mark.parametrize("n,e,fanouts,batch", [
    (200, 2000, (3, 2), 8), (1000, 20000, (15, 10), 32),
    (300, 200, (4, 4, 2), 16)])
def test_neighbor_sampler(n, e, fanouts, batch):
    """Hub nodes (in-degree far above the fanout: ``rng.choice`` without
    replacement), nodes under it and isolated ones (the sparse graph)."""
    _, src, dst = _graph(n, e, 6)
    seeds = np.random.default_rng(9).choice(n, batch, replace=False)
    tb = TSA.NeighborSampler(TSA.build_csr(src, dst, n), fanouts,
                             seed=3).sample(seeds)
    jb = JSA.NeighborSampler(JSA.build_csr(src, dst, n), fanouts,
                             seed=3).sample(seeds)
    assert len(tb) == len(jb) == len(fanouts)
    for a, b in zip(tb, jb):
        _same_dict(dataclasses.asdict(a), dataclasses.asdict(b))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _cell(shape, seed=0, padded=False):
    """(jax cfg, port cfg, numpy batch) of the cell's smoke batch;
    ``padded``: every in-edge of a few nodes masked off as padding (the
    -1e30 path: such a node's softmax is 1/k before the mask zeroes it)."""
    _, jcfg, b = JSH.smoke_batch("gat-cora", shape, seed=seed)
    b = dict(b)
    if padded:
        if shape == "minibatch_lg":
            for i, (k, n) in enumerate((("block0", 3), ("block1", 2))):
                dst = b[f"{k}_dst"]
                b[f"{k}_mask"] = b[f"{k}_mask"] & (dst >= n)
        else:
            dst = b["edge_dst"]
            b["edge_mask"] = ~np.isin(dst, np.unique(dst)[:3])
    tcfg = dataclasses.replace(get_arch("gat-cora").reduced,
                               d_feat=jcfg.d_feat, n_classes=jcfg.n_classes)
    return jcfg, tcfg, b


def _carry(jcfg, seed=1):
    params = JG.init_params(jcfg, jax.random.key(seed))
    return params, gat_params_from_jax(jax.tree.map(np.asarray, params),
                                       "cpu")


def _leaves(tp):
    return [tp["layers"][i][k] for i in range(len(tp["layers"]))
            for k in ("a_dst", "a_src", "w")]


def _jleaves(g):
    return [g["layers"][i][k] for i in range(len(g["layers"]))
            for k in ("a_dst", "a_src", "w")]


def _value_and_grad(fn, tp):
    leaves = [p.detach().requires_grad_(True) for p in _leaves(tp)]
    it = iter(leaves)
    params = {"layers": [{k: next(it) for k in ("a_dst", "a_src", "w")}
                         for _ in tp["layers"]]}
    out = fn(params)
    grads = torch.autograd.grad(out, leaves)
    return out.detach(), [g.numpy() for g in grads]


def test_config_and_init():
    cfg = get_arch("gat-cora").config
    from repro.configs import get_arch as jga
    assert cfg.param_count() == jga("gat-cora").config.param_count() == \
        92_302
    p = TG.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    j = JG.init_params(jga("gat-cora").config, jax.random.key(0))
    assert jax.tree.map(lambda x: x.shape, j) == \
        {"layers": [{k: tuple(v.shape) for k, v in lw.items()}
                    for lw in p["layers"]]}
    assert all(v.dtype == torch.float32 for lw in p["layers"]
               for v in lw.values())
    assert sum(v.numel() for lw in p["layers"] for v in lw.values()) == \
        cfg.param_count()


@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("padded", [False, True])
def test_gat_layer(final, padded):
    jcfg, tcfg, b = _cell("full_graph_sm", padded=padded)
    params, tp = _carry(jcfg)
    i = 1 if final else 0
    heads = 1 if final else jcfg.n_heads
    out = jcfg.n_classes if final else jcfg.d_hidden
    rng = np.random.default_rng(2)
    h = rng.standard_normal((b["features"].shape[0],
                             jcfg.d_feat if i == 0 else
                             jcfg.n_heads * jcfg.d_hidden)) \
        .astype(np.float32)
    mask = b.get("edge_mask", np.ones(b["edge_src"].shape, bool))
    n = h.shape[0]
    kw = dict(heads=heads, out=out, neg_slope=0.2, dist=None, final=final)

    @jax.jit
    def jf(lw, hh):
        return JG.gat_layer(lw, hh, hh, jnp.asarray(b["edge_src"]),
                            jnp.asarray(b["edge_dst"]), jnp.asarray(mask),
                            n, **kw)

    w = rng.standard_normal(_np(jf(params["layers"][i], h)).shape) \
        .astype(np.float32)
    want = _np(jf(params["layers"][i], jnp.asarray(h)))
    # the gradient of a mean of the outputs, the scale of the model's
    # losses (the layer's sums of O(1) terms then land at O(1e-2))
    jg = jax.jit(jax.grad(lambda lw, hh: (jf(lw, hh) * w).mean(),
                          argnums=(0, 1)))(
        params["layers"][i], jnp.asarray(h))
    lw = {k: v.detach().requires_grad_(True)
          for k, v in tp["layers"][i].items()}
    ht = _t(h).requires_grad_(True)
    got = TG.gat_layer(lw, ht, ht, _t(b["edge_src"]), _t(b["edge_dst"]),
                       _t(mask), n, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    (got * _t(w)).mean().backward()
    for k in lw:
        np.testing.assert_allclose(lw[k].grad.numpy(), _np(jg[0][k]),
                                   **TOL, err_msg=k)
    np.testing.assert_allclose(ht.grad.numpy(), _np(jg[1]), **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("padded", [False, True])
def test_forward(shape, padded):
    jcfg, tcfg, b = _cell(shape, padded=padded)
    params, tp = _carry(jcfg)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    blocks = shape == "minibatch_lg"
    fwd = JG.forward_blocks if blocks else JG.forward_full
    want = _np(jax.jit(lambda p, bb: fwd(jcfg, p, bb))(params, jb))
    got = (TG.forward_blocks if blocks else TG.forward_full)(tcfg, tp, tb)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_grads(shape, padded, seed):
    """The cell's loss (``cell_loss``: full, blocks or molecule) and the
    gradient of every param leaf against ``jax.value_and_grad``."""
    jcfg, tcfg, b = _cell(shape, seed=seed, padded=padded)
    params, tp = _carry(jcfg, seed=seed + 1)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    jloss = JLOSS.get(shape, JG.loss_full)
    lv, g = jax.jit(jax.value_and_grad(lambda p, bb: jloss(jcfg, p, bb)))(
        params, jb)
    tl, tg = _value_and_grad(lambda p: TG.cell_loss(shape)(tcfg, p, tb), tp)
    np.testing.assert_allclose(float(tl), float(lv), **TOL)
    for got, want in zip(tg, _jleaves(g)):
        np.testing.assert_allclose(got, _np(want), **TOL)


def test_masked_ce_loss():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((9, 5)).astype(np.float32)
    labels = rng.integers(-1, 5, 9).astype(np.int32)      # -1: clip to 0
    for mask in (rng.random(9) < 0.5, np.zeros(9, bool)):
        want = _np(JG.masked_ce_loss(jnp.asarray(logits),
                                     jnp.asarray(labels), jnp.asarray(mask)))
        got = TG.masked_ce_loss(_t(logits), _t(labels), _t(mask))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_train_steps(shape):
    """Three steps of the reference's ``_gat_cell`` step (Adam 1e-3, no
    clip) from the same weights on the cell's smoke batch."""
    jcfg, tcfg, b = _cell(shape)
    params, tp = _carry(jcfg)
    jloss = JLOSS.get(shape, JG.loss_full)
    jstep = jax.jit(JTS.build_train_step(lambda p, bb: jloss(jcfg, p, bb),
                                         JOPT.adam(1e-3), clip_norm=None))
    tstep = TTS.build_train_step(
        lambda p, bb: TG.cell_loss(shape)(tcfg, p, bb), TOPT.adam(1e-3),
        clip_norm=None)
    js = JTS.TrainState.create(params, JOPT.adam(1e-3))
    ts = TTS.TrainState.create(tp, TOPT.adam(1e-3))
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    tb = {k: _t(v) for k, v in b.items()}
    for _ in range(3):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        assert "grad_norm" not in tm
    for got, want in zip(_leaves(ts.params), _jleaves(js.params)):
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-4,
                                   atol=1e-6)
    assert int(ts.step) == 3


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

def test_train_cli_refuses_gat():
    from repro_torch.launch import train as LT
    with pytest.raises(ValueError, match="use examples/ for family gat"):
        LT.main(["--arch", "gat-cora", "--steps", "1", "--device", "cpu"])
    spec = get_arch("gat-cora")
    with pytest.raises(ValueError, match="use examples/ for family gat"):
        LT.run(spec, spec.reduced, steps=1, batch=2, device="cpu")
    with pytest.raises(ValueError, match="use examples/ for family gat"):
        TS.family_batch("gat", spec.reduced, 2, seed=0, step=0)


def test_serve_cli_refuses_gat():
    from repro_torch.launch import serve as LS
    with pytest.raises(SystemExit, match="recsys serving CLI"):
        LS.main(["--arch", "gat-cora", "--device", "cpu"])
