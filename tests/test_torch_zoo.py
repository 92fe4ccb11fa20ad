"""The port's DIN, xDeepFM and BERT4Rec (``repro_torch.models``) and the
layers BERT4Rec needs against the JAX package's, on the CPU, on the
reduced configs with the reference's own weights carried across by
``repro_torch.convert`` and batches from the reference's numpy
generators; and the zoo on the serve and train CLIs.

Tolerances: fp32 outputs, losses and gradients at rtol 1e-5 / atol 1e-6
(the lookups are exact; the matmuls, einsums and reductions sum in
another order). Train trajectories of a few steps (Adam and Adagrad
divide by small accumulators) at rtol 1e-4, the tolerance of the port's
other train tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import synthetic as JS
from repro.models import bert4rec as JB
from repro.models import din as JDIN
from repro.models import layers as JL
from repro.models import xdeepfm as JX
from repro.serve import serve_step as JSS
from repro.train import train_step as JTS
from repro_torch.configs import get_arch
from repro_torch.convert import zoo_params_from_jax, zoo_statics_from_jax
from repro_torch.data import synthetic as TS
from repro_torch.launch import serve as LS
from repro_torch.launch import train as LT
from repro_torch.models import bert4rec as TB
from repro_torch.models import din as TDIN
from repro_torch.models import layers as TL
from repro_torch.models import xdeepfm as TX
from repro_torch.serve import serve_step as TSS
from repro_torch.train import optim as O
from repro_torch.train import train_step as TTS

TOL = dict(rtol=1e-5, atol=1e-6)
TRAIN_RTOL = 1e-4
FAMILIES = {"din": (JDIN, TDIN), "xdeepfm": (JX, TX), "bert4rec": (JB, TB)}


def _np(x):
    return np.asarray(x)


def _tn(t):
    return t.detach().numpy()


def _carry(arch, seed=0, **cfg_kw):
    """(jax cfg, torch cfg, jax params, statics, torch params, statics)."""
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced, **cfg_kw)
    tcfg = dataclasses.replace(get_arch(arch).reduced, **cfg_kw)
    jmod, _ = FAMILIES[arch]
    params, statics = jmod.init_params(jcfg, jax.random.key(seed))
    tp = zoo_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                             "cpu")
    ts = zoo_statics_from_jax({k: np.asarray(v) if hasattr(v, "shape")
                               else v for k, v in statics.items()}, "cpu")
    return jcfg, tcfg, params, statics, tp, ts


def _batch(arch, cfg, n, seed=3, step=0):
    if arch == "din":
        return JS.din_batch(cfg.n_items, cfg.n_cates, cfg.seq_len, n,
                            seed=seed, step=step)
    if arch == "xdeepfm":
        b = JS.xdeepfm_batch(cfg.vocab_sizes, n, seed=seed, step=step)
        b["sparse"][0, 1] = -1                 # a missing field reads 0
        return b
    return JS.bert4rec_batch(cfg.n_items, cfg.seq_len, n, seed=seed,
                             step=step, n_negatives=cfg.n_negatives)


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_layer_norm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((4, 7, 16)) * 3 + 1).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    got = TL.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(b))
    np.testing.assert_allclose(_tn(got), _np(JL.layer_norm(x, s, b)), **TOL)
    # eps 1e-6, not nn.LayerNorm's 1e-5: a near-constant row tells them
    x0 = np.full((1, 16), 2.0, np.float32)
    x0[0, 0] += 1e-3
    got = TL.layer_norm(torch.from_numpy(x0), torch.ones(16),
                        torch.zeros(16))
    np.testing.assert_allclose(
        _tn(got), _np(JL.layer_norm(x0, np.ones(16, np.float32),
                                    np.zeros(16, np.float32))), **TOL)


def test_gelu_mlp():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 8)).astype(np.float32) * 2
    w_in = rng.standard_normal((8, 12)).astype(np.float32)
    b_in = rng.standard_normal(12).astype(np.float32)
    w_out = rng.standard_normal((12, 8)).astype(np.float32)
    b_out = rng.standard_normal(8).astype(np.float32)
    got = TL.gelu_mlp(*map(torch.from_numpy, (x, w_in, b_in, w_out, b_out)))
    want = JL.gelu_mlp(x, w_in, b_in, w_out, b_out)
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=1e-5)


ATTN_CASES = [(causal, qc, kc, off)
              for causal in (False, True)
              for qc, kc in ((16, 16), (4, 8), (8, 4), (2, 16))
              for off in ((0, 5) if causal else (0,))]


@pytest.mark.parametrize("causal,q_chunk,kv_chunk,q_offset", ATTN_CASES,
                         ids=[f"{'causal' if c else 'bidir'}-q{q}-kv{k}-o{o}"
                              for c, q, k, o in ATTN_CASES])
def test_blockwise_attention(causal, q_chunk, kv_chunk, q_offset):
    """Grouped heads (4 query heads over 2 KV heads), several chunkings."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 16, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    kw = dict(causal=causal, q_chunk=q_chunk, kv_chunk=kv_chunk,
              q_offset=q_offset)
    got = TL.blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    np.testing.assert_allclose(_tn(got), _np(want), **TOL)


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

def test_registry_and_batches_match_jax():
    for arch in FAMILIES:
        got, want = get_arch(arch), jax_get_arch(arch)
        assert (got.arch_id, got.family, got.shapes, got.notes) == (
            want.arch_id, want.family, want.shapes, want.notes)
        for g, w in ((got.config, want.config), (got.reduced, want.reduced)):
            for f in dataclasses.fields(w):
                gv, wv = getattr(g, f.name), getattr(w, f.name)
                if f.name == "dtype":
                    assert str(gv).split(".")[-1] == jnp.dtype(wv).name
                else:
                    assert gv == wv, (arch, f.name)
            assert g.param_count() == w.param_count()
    for a, b in (
            (TS.din_batch(50, 7, 12, 5, seed=1, step=2),
             JS.din_batch(50, 7, 12, 5, seed=1, step=2)),
            (TS.bert4rec_batch(40, 9, 3, seed=1, step=2, n_negatives=11),
             JS.bert4rec_batch(40, 9, 3, seed=1, step=2, n_negatives=11)),
            (TS.bert4rec_batch(40, 9, 3, seed=1, step=2),
             JS.bert4rec_batch(40, 9, 3, seed=1, step=2)),
            (TS.xdeepfm_batch((5, 6, 7), 4, seed=1, step=2),
             JS.xdeepfm_batch((5, 6, 7), 4, seed=1, step=2))):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_convert_keeps_the_reference_tree():
    """Every leaf carried across bit for bit, under the reference's key
    strings (BERT4Rec's blocks keep their leading n_blocks dim)."""
    for arch in FAMILIES:
        *_, params, statics, tp, ts = _carry(arch)
        want = {jax.tree_util.keystr(p): _np(v) for p, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        got = dict(O.tree_flatten_with_path(tp))
        assert got.keys() == want.keys(), arch
        for k, v in got.items():
            np.testing.assert_array_equal(_tn(v), want[k], err_msg=k)
        assert ts["n_banks"] == int(statics["n_banks"])
    _, cfg, _, _, tp, _ = _carry("bert4rec")
    assert tuple(tp["blocks"]["wq"].shape) == (cfg.n_blocks, cfg.embed_dim,
                                               cfg.embed_dim)


@pytest.mark.parametrize("arch", ["din", "xdeepfm"])
def test_forward(arch):
    jcfg, tcfg, params, statics, tp, ts = _carry(arch)
    b = _batch(arch, jcfg, 8)
    want = FAMILIES[arch][0].forward(jcfg, params, statics, _j(b))
    got = FAMILIES[arch][1].forward(tcfg, tp, ts, _t(b))
    np.testing.assert_allclose(_tn(got), _np(want), **TOL)


def test_bert4rec_encode():
    jcfg, tcfg, params, statics, tp, ts = _carry("bert4rec")
    b = _batch("bert4rec", jcfg, 6)
    b["items"][1, 3:5] = -1                    # padding reads zero rows
    want = JB.encode(jcfg, params, statics, jnp.asarray(b["items"]))
    got = TB.encode(tcfg, tp, ts, torch.from_numpy(b["items"]))
    np.testing.assert_allclose(_tn(got), _np(want), rtol=1e-5, atol=2e-6)


LOSS_CASES = [("din", {}), ("xdeepfm", {}), ("bert4rec", {}),
              ("bert4rec", {"loss": "full"})]
LOSS_IDS = ["din", "xdeepfm", "bert4rec-sampled", "bert4rec-full"]


def _collide(arch, b):
    """BERT4Rec: make some negatives equal some labels, so the -1e30
    collision mask acts."""
    if arch == "bert4rec" and "negatives" in b:
        lab = b["labels"][b["labels"] >= 0]
        b["negatives"][:3] = lab[:3]
    return b


@pytest.mark.parametrize("arch,kw", LOSS_CASES, ids=LOSS_IDS)
def test_loss(arch, kw):
    jcfg, tcfg, params, statics, tp, ts = _carry(arch, **kw)
    b = _collide(arch, _batch(arch, jcfg, 8))
    want = FAMILIES[arch][0].loss_fn(jcfg, params, statics, _j(b))
    got = FAMILIES[arch][1].loss_fn(tcfg, tp, ts, _t(b))
    np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("arch,kw", LOSS_CASES, ids=LOSS_IDS)
def test_gradients(arch, kw):
    """Every leaf's gradient against ``jax.grad`` of the reference's
    loss. The dense per-row gradient of the table is a sum of gathers'
    cotangents, exact up to their order."""
    jcfg, tcfg, params, statics, tp, ts = _carry(arch, **kw)
    b = _collide(arch, _batch(arch, jcfg, 8))
    jmod, tmod = FAMILIES[arch]
    want = jax.grad(lambda p: jmod.loss_fn(jcfg, p, statics, _j(b)))(params)
    want = {jax.tree_util.keystr(p): _np(v) for p, v in
            jax.tree_util.tree_flatten_with_path(want)[0]}
    flat = O.tree_flatten_with_path(tp)
    leaves = [v.clone().requires_grad_(True) for _, v in flat]
    loss = tmod.loss_fn(tcfg, O.tree_unflatten(tp, leaves), ts, _t(b))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for (k, v), g in zip(flat, grads):
        g = torch.zeros_like(v) if g is None else g
        np.testing.assert_allclose(_tn(g), want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=f"{arch} {k}")


def _retrieval_batch(arch, cfg, n, seed=5):
    rng = np.random.default_rng(seed)
    if arch == "din":
        b = JS.din_batch(cfg.n_items, cfg.n_cates, cfg.seq_len, 1,
                         seed=seed, step=0)
        b = {k: b[k] for k in ("hist_items", "hist_cates")}
        b["candidates"] = rng.integers(0, cfg.n_items, n).astype(np.int32)
        b["candidate_cates"] = rng.integers(0, cfg.n_cates, n).astype(
            np.int32)
        b["candidate_cates"][2] = -1
    elif arch == "xdeepfm":
        b = {"sparse": JS.xdeepfm_batch(cfg.vocab_sizes, 1, seed=seed,
                                        step=0)["sparse"],
             "candidates": rng.integers(0, cfg.vocab_sizes[0], n).astype(
                 np.int32)}
    else:
        b = {"items": JS.bert4rec_batch(cfg.n_items, cfg.seq_len, 1,
                                        seed=seed, step=0)["items"],
             "candidates": rng.integers(0, cfg.n_items, n).astype(np.int32)}
    return b


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_retrieval(arch):
    """``retrieval_scores`` and ``build_retrieval_serve``'s top k (drawn
    with repeats, so copies tie: lowest index first, as
    ``jax.lax.top_k``)."""
    jcfg, tcfg, params, statics, tp, ts = _carry(arch)
    b = _retrieval_batch(arch, jcfg, 96)
    jmod, tmod = FAMILIES[arch]
    want = _np(jmod.retrieval_scores(jcfg, params, statics, _j(b)))
    got = tmod.retrieval_scores(tcfg, tp, ts, _t(b))
    np.testing.assert_allclose(_tn(got), want, **TOL)
    wv, wi = JSS.build_retrieval_serve(jmod, jcfg, statics, top_k=16)(
        params, _j(b))
    gv, gi = TSS.build_retrieval_serve(tmod, tcfg, ts, top_k=16)(tp, _t(b))
    np.testing.assert_allclose(_tn(gv), _np(wv), **TOL)
    # ids: the same, or a candidate whose score ties within tolerance
    same = _tn(gi) == _np(wi)
    np.testing.assert_allclose(want.reshape(-1, want.shape[-1])[
        0, _tn(gi).reshape(-1)[~same.reshape(-1)]],
        _np(wv).reshape(-1)[~same.reshape(-1)], **TOL)
    assert same.mean() > 0.9


@pytest.mark.parametrize("form", ["shared", "slate", "catalog"])
def test_bert4rec_next_item_scores(form):
    """The three candidate forms: (N,) shared and (B, N) per user without
    ``out_bias``, the full catalog with it (the bias made non-zero so it
    shows)."""
    jcfg, tcfg, params, statics, tp, ts = _carry("bert4rec")
    rng = np.random.default_rng(7)
    bias = rng.standard_normal(jcfg.vocab).astype(np.float32)
    params = dict(params, out_bias=jnp.asarray(bias))
    tp = dict(tp, out_bias=torch.from_numpy(bias))
    b = {"items": JS.bert4rec_batch(jcfg.n_items, jcfg.seq_len, 4, seed=2,
                                    step=0)["items"]}
    if form == "shared":
        b["candidates"] = rng.integers(0, jcfg.n_items, 30).astype(np.int32)
    elif form == "slate":
        b["candidates"] = rng.integers(0, jcfg.n_items, (4, 12)).astype(
            np.int32)
    want = JB.next_item_scores(jcfg, params, statics, _j(b))
    got = TB.next_item_scores(tcfg, tp, ts, _t(b))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(_tn(got), _np(want), **TOL)


@pytest.mark.parametrize("arch,kw", LOSS_CASES, ids=LOSS_IDS)
def test_train_steps(arch, kw):
    """Three steps of the port's ``build_train_step`` with the default
    optimizer (Adam dense, row-wise Adagrad on the tables) and clipping,
    against the reference's jitted step from the same weights."""
    jcfg, tcfg, params, statics, tp, ts = _carry(arch, **kw)
    jmod, tmod = FAMILIES[arch]
    jopt, topt = JTS.default_optimizer(), TTS.default_optimizer()
    jstep = jax.jit(JTS.build_train_step(
        lambda p, bb: jmod.loss_fn(jcfg, p, statics, bb), jopt))
    tstep = TTS.build_train_step(
        lambda p, bb: tmod.loss_fn(tcfg, p, ts, bb), topt)
    js, tst = JTS.TrainState.create(params, jopt), TTS.TrainState.create(
        tp, topt)
    for i in range(3):
        b = _batch(arch, jcfg, 8, step=i)
        js, jm = jstep(js, _j(b))
        tst, tm = tstep(tst, _t(b))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAIN_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TRAIN_RTOL)
    np.testing.assert_allclose(_tn(tst.params["emb_packed"]),
                               _np(js.params["emb_packed"]),
                               rtol=TRAIN_RTOL, atol=1e-6)


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["din", "xdeepfm"])
def test_serve_cli(arch, capsys):
    LS.main(["--arch", arch, "--requests", "40", "--batch", "16",
             "--device", "cpu"])
    assert "served 40 requests" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["din", "xdeepfm"])
def test_serve_run_scores(arch):
    """``launch.serve.run``'s scores are the family's sigmoid of
    ``forward`` on the requests' features, in request order."""
    spec = get_arch(arch)
    res = LS.run(spec, spec.reduced, requests=20, batch=8, device="cpu")
    feats = [LS._one(spec.reduced, rid, spec.family) for rid in range(20)]
    b = {k: torch.from_numpy(np.concatenate([f[k] for f in feats]))
         for k in feats[0]}
    want = torch.sigmoid(FAMILIES[arch][1].forward(
        spec.reduced, res.params, res.statics, b))
    np.testing.assert_allclose(_tn(res.scores), _tn(want), **TOL)
    assert len(res.latencies) == 20


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_cli(arch, capsys):
    LT.main(["--arch", arch, "--steps", "3", "--batch", "4",
             "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert f"family={get_arch(arch).family}" in out and "step     2" in out


@pytest.mark.parametrize("arch", list(FAMILIES))
def test_train_run(arch):
    spec = get_arch(arch)
    res = LT.run(spec, spec.reduced, steps=3, batch=4, device="cpu")
    assert len(res.losses) == 3 and np.isfinite(res.losses).all()


ADAPTIVE_LANES = {
    "remap": [],
    "tier": ["--quant", "int8"],
    "cache": ["--partition", "cache_aware"],
    "replica": ["--replicate-k-max", "4"],
    "fault": ["--inject-bank-failure", "2:3"],
}


@pytest.mark.parametrize("lane", list(ADAPTIVE_LANES))
def test_adaptive_serve_lanes_refuse_zoo(lane):
    """Each adaptive lane drives the DLRM's banked super-table, as the
    reference asserts: the CLI exits before any work, and so does each
    lane's ``run_*`` for a non-dlrm family."""
    with pytest.raises(SystemExit, match="dlrm only"):
        LS.main(["--arch", "din", "--adaptive", "--device", "cpu",
                 *ADAPTIVE_LANES[lane]])
    spec = get_arch("xdeepfm")
    fn, kw = {"remap": (LS.run_adaptive, {}),
              "tier": (LS.run_adaptive, {"quant": "int8"}),
              "cache": (LS.run_cached_adaptive, {}),
              "replica": (LS.run_replicated, {"k_max": 4}),
              "fault": (LS.run_fault, {"faults": ["2:3"]})}[lane]
    with pytest.raises(ValueError, match="banked super-table"):
        fn(spec, spec.reduced, requests=16, batch=8, device="cpu", **kw)


def test_zoo_refusals():
    """The serving CLI serves dlrm, din and xdeepfm (the reference's
    assert); the cache-aware serve and adaptive training are dlrm only."""
    with pytest.raises(SystemExit, match="serving CLI"):
        LS.main(["--arch", "bert4rec", "--device", "cpu"])
    spec = get_arch("bert4rec")
    with pytest.raises(ValueError, match="serves"):
        LS.run(spec, spec.reduced, requests=4, batch=4, device="cpu")
    spec = get_arch("din")
    with pytest.raises(ValueError, match="banked super-table"):
        LS.run_cached(spec, spec.reduced, requests=16, batch=8,
                      device="cpu")
    for part in ("non_uniform", "cache_aware"):
        with pytest.raises(SystemExit, match="dlrm only"):
            LT.main(["--arch", "din", "--adaptive", "--partition", part,
                     "--device", "cpu"])
        with pytest.raises(ValueError, match="banked super-table"):
            LT.run_adaptive(spec, spec.reduced, steps=2, batch=4,
                            partition=part, device="cpu")
