"""The port's LM family (``repro_torch.models.transformer`` and the layers
it needs) against the JAX package's, on the CPU: all five reduced LM
configs with the reference's own weights carried across by
``repro_torch.convert.lm_params_from_jax`` and batches from the
reference's numpy generator; the train CLI on an LM.

Two precisions per config:
  * fp32 compute (``dataclasses.replace(cfg, dtype=float32)``): hidden
    states, logits, losses and gradients at rtol 1e-5 / atol 1e-5 (the
    matmuls and reductions sum in another order);
  * the configs' own bf16 compute over fp32 params: a layer's output
    within 2 bf16 ulps (rtol 2^-6, atol 1e-2 near zero); hidden states
    (RMS normed, |h| < 8) within 2 ulps at that scale, atol 6.25e-2;
    logits rtol 2e-2 (the reference's own for its bf16 decode-vs-prefill
    logits) and atol 5e-2 (the hidden state's bf16 rounding carried
    through an untied unembedding of d^-1/2-scaled weights: qwen3's
    reduced logits differ by up to 0.026 near zero); losses rtol 1e-3. The reference's and the port's
    CPU matmuls round bf16 products at different points.
MoE routing (top k, capacity drops, loads) is held exactly where the two
take the same inputs. Train trajectories of 3 steps at rtol 1e-4, the
tolerance of the port's other train tests.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data import synthetic as JS
from repro.dist import collectives as JC
from repro.launch import train as JLT
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.train import train_step as JTS
from repro_torch.configs import get_arch
from repro_torch.convert import lm_params_from_jax
from repro_torch.data import synthetic as TS
from repro_torch.dist import collectives as TC
from repro_torch.launch import train as LT
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serve import serve_step as TSS
from repro_torch.train import optim as O
from repro_torch.train import train_step as TTS

ARCHS = ["smollm-135m", "smollm-360m", "granite-20b", "qwen3-moe-30b-a3b",
         "granite-moe-1b-a400m"]
TOL = dict(rtol=1e-5, atol=1e-5)
BF16 = {"act": dict(rtol=2 ** -6, atol=1e-2),
        "hidden": dict(rtol=0, atol=6.25e-2),
        "logits": dict(rtol=2e-2, atol=5e-2), "loss": dict(rtol=1e-3)}
TRAIN_RTOL = 1e-4
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) \
        if hasattr(x, "dtype") and str(x.dtype) == "bfloat16" \
        else np.asarray(x)


def _tn(t):
    return t.detach().float().numpy()


def _carry(arch, dt="f32", seed=0, **kw):
    """(jax cfg, torch cfg, jax params, torch params)."""
    jd, td = DTYPES[dt]
    jcfg = dataclasses.replace(jax_get_arch(arch).reduced, dtype=jd, **kw)
    tcfg = dataclasses.replace(get_arch(arch).reduced, dtype=td, **kw)
    params = JT.init_params(jcfg, jax.random.key(seed))
    tp = lm_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                            "cpu")
    return jcfg, tcfg, params, tp


def _tokens(cfg, b=2, s=32, seed=1, step=0):
    return JS.lm_batch(b, s, cfg.vocab, seed=seed, step=step)


def _tol(dt, what):
    return TOL if dt == "f32" else BF16[what]


# ---------------------------------------------------------------------------
# registry, batches, params
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_registry_matches_jax(arch):
    got, want = get_arch(arch), jax_get_arch(arch)
    assert (got.arch_id, got.family, got.shapes, got.notes) == (
        want.arch_id, want.family, want.shapes, want.notes)
    for g, w in ((got.config, want.config), (got.reduced, want.reduced)):
        for f in dataclasses.fields(w):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if f.name in ("dtype", "param_dtype"):
                assert str(gv).split(".")[-1] == jnp.dtype(wv).name
            elif f.name == "moe":
                assert (gv is None) == (wv is None)
                if wv is not None:
                    assert dataclasses.astuple(gv) == dataclasses.astuple(wv)
            else:
                assert gv == wv, f.name
        assert (g.param_count(), g.active_param_count(), g.padded_vocab) \
            == (w.param_count(), w.active_param_count(), w.padded_vocab)


def test_lm_batch_matches_jax():
    for seed, step in ((0, 0), (3, 7)):
        a = TS.lm_batch(4, 64, 49155, seed=seed, step=step)
        b = JS.lm_batch(4, 64, 49155, seed=seed, step=step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    cfg = get_arch("granite-moe-1b-a400m").reduced
    b = TS.family_batch("lm", cfg, 4, seed=0, step=2)
    assert b["tokens"].shape == (4, 64)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_shapes_match_jax(arch):
    """The port's own init draws params of the reference's tree, shapes
    and dtypes (not its numbers), and counts what ``param_count`` says."""
    jcfg, tcfg = jax_get_arch(arch).reduced, get_arch(arch).reduced
    want = JT.init_params(jcfg, jax.random.key(0))
    got = TT.init_params(tcfg, torch.Generator().manual_seed(0),
                         device="cpu")
    wf = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    gf = dict(O.tree_flatten_with_path(got))
    assert sorted(wf) == sorted(gf)
    for k, v in wf.items():
        assert tuple(gf[k].shape) == v.shape and gf[k].dtype == torch.float32
    n = sum(v.numel() for v in gf.values())
    # param_count counts the vocab unpadded
    pad = (tcfg.padded_vocab - tcfg.vocab) * tcfg.d_model \
        * (1 if tcfg.tied_embeddings else 2)
    assert n == tcfg.param_count() + pad


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
def test_rms_norm_and_rope(dt):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    s = rng.standard_normal(16).astype(np.float32)
    pos = np.tile(np.arange(6)[None] + 5, (2, 1)).astype(np.int32)
    want = JL.rms_norm(jnp.asarray(x).astype(jd), jnp.asarray(s).astype(jd))
    got = TL.rms_norm(torch.from_numpy(x).to(td), torch.from_numpy(s).to(td))
    np.testing.assert_allclose(_tn(got), _np(want), **_tol(dt, "act"))
    want = JL.apply_rope(jnp.asarray(x).astype(jd), jnp.asarray(pos), 1e4)
    got = TL.apply_rope(torch.from_numpy(x).to(td), torch.from_numpy(pos),
                        1e4)
    assert got.dtype == td
    np.testing.assert_allclose(_tn(got), _np(want), **_tol(dt, "act"))
    np.testing.assert_allclose(TL.rope_freqs(16).numpy(),
                               _np(JL.rope_freqs(16)), rtol=1e-6)


def test_decode_attention_and_partials():
    """``decode_attention`` against the reference's; the partials of two
    halves of the cache, combined by the log-sum-exp identity, against the
    whole cache's attention."""
    rng = np.random.default_rng(1)
    B, S, Hq, Hkv, Dh = 3, 12, 4, 2, 8
    q = rng.standard_normal((B, Hq, Dh)).astype(np.float32)
    kc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    vc = rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32)
    ln = np.array([3, 12, 7], np.int32)
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(ln))
    t = [torch.from_numpy(a) for a in (q, kc, vc, ln)]
    np.testing.assert_allclose(_tn(TL.decode_attention(*t)), _np(want),
                               **TOL)
    valid = np.arange(S)[None, :] < ln[:, None]
    parts = []
    for sl in (slice(0, 6), slice(6, 12)):
        o, m, l = TL.decode_attention_partial(
            t[0], t[1][:, sl], t[2][:, sl], torch.from_numpy(valid[:, sl]))
        jo, jm, jl = JL.decode_attention_partial(
            jnp.asarray(q), jnp.asarray(kc[:, sl]), jnp.asarray(vc[:, sl]),
            jnp.asarray(valid[:, sl]))
        for a, b in ((o, jo), (m, jm), (l, jl)):
            np.testing.assert_allclose(_tn(a), _np(b), **TOL)
        parts.append((o, m, l))

    (o0, m0, l0), (o1, m1, l1) = parts

    class _Peer:
        """Shard 0's view of a two-shard group: each collective combines
        its argument with shard 1's term of the same combine."""
        def pmax(self, x, axes):
            self.c1 = torch.exp(m1 - torch.maximum(x, m1))
            return torch.maximum(x, m1)

        def psum(self, x, axes):
            return x + (l1 * self.c1 if x.dim() == 2
                        else o1 * self.c1[..., None])

    got = TL.combine_decode_partials(o0, m0, l0, _Peer(), ("bank",))
    np.testing.assert_allclose(_tn(got), _np(want), **TOL)


@pytest.mark.parametrize("pos", [0, 5, 11])
def test_decode_attention_local_path(pos):
    rng = np.random.default_rng(pos)
    B, S, Hq, Hkv, Dh = 2, 12, 4, 1, 8
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((B, Hq, Dh), (B, Hkv, Dh), (B, Hkv, Dh), (B, S, Hkv, Dh),
             (B, S, Hkv, Dh))]
    want = JC.seqsharded_decode_attention(*map(jnp.asarray, arrs),
                                          jnp.int32(pos))
    got = TC.seqsharded_decode_attention(
        *[torch.from_numpy(a) for a in arrs], pos)
    np.testing.assert_allclose(_tn(got[0]), _np(want[0]), **TOL)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(_tn(g), _np(w))


@pytest.mark.parametrize("dt", list(DTYPES))
def test_glu_mlp(dt):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(2)
    x, wg, wu = (rng.standard_normal(s).astype(np.float32) / 4
                 for s in ((5, 16), (16, 32), (16, 32)))
    wd = rng.standard_normal((32, 16)).astype(np.float32) / 4
    want = JL.glu_mlp(*(jnp.asarray(a).astype(jd) for a in (x, wg, wu, wd)))
    got = TL.glu_mlp(*(torch.from_numpy(a).to(td) for a in (x, wg, wu, wd)))
    np.testing.assert_allclose(_tn(got), _np(want), **_tol(dt, "act"))


MOE_CASES = {  # (E, top_k, capacity factor, router scale)
    "reduced": (8, 8, 1.25, 0.3),      # the reduced configs: every expert
    "top2": (8, 2, 1.25, 0.3),
    "drops": (8, 2, 0.5, 3.0),         # a skewed router over a short buffer
    "top1": (4, 1, 1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("dt", list(DTYPES))
def test_moe_layer(case, dt):
    """Routing, capacity drops, loads and outputs against the reference's
    ``moe_layer``; the kept slots are the same, so fp32 outputs agree to
    rounding."""
    E, k, cf, scale = MOE_CASES[case]
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(3)
    d, ff, T = 16, 24, 40
    x = rng.standard_normal((T, d)).astype(np.float32)
    wr = (rng.standard_normal((d, E)) * scale).astype(np.float32)
    wg, wu = (rng.standard_normal((E, d, ff)).astype(np.float32) / 4
              for _ in range(2))
    wd = rng.standard_normal((E, ff, d)).astype(np.float32) / 5
    args = (x, wr, wg, wu, wd)
    want, ws = JL.moe_layer(*(jnp.asarray(a).astype(jd) for a in args),
                            top_k=k, capacity_factor=cf)
    got, gs = TL.moe_layer(*(torch.from_numpy(a).to(td) for a in args),
                           top_k=k, capacity_factor=cf)
    np.testing.assert_array_equal(_tn(gs.load), _np(ws.load))
    np.testing.assert_allclose(float(gs.dropped), float(ws.dropped),
                               rtol=1e-6)
    if case == "drops":
        assert float(gs.dropped) > 0.1
    np.testing.assert_allclose(_tn(got), _np(want), **_tol(dt, "act"))


# ---------------------------------------------------------------------------
# the model, every reduced config, fp32 and bf16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_prefill(arch, dt):
    jcfg, tcfg, params, tp = _carry(arch, dt)
    b = _tokens(jcfg)
    toks, labels = jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])
    tt, tl = torch.from_numpy(b["tokens"]), torch.from_numpy(b["labels"])
    h_want = JT.forward_hidden(jcfg, params, toks, None)
    h_got = TT.forward_hidden(tcfg, tp, tt)
    assert h_got.dtype == tcfg.dtype
    np.testing.assert_allclose(_tn(h_got), _np(h_want), **_tol(dt, "hidden"))
    l_want = float(JT.lm_loss(jcfg, params, toks, labels))
    l_got = float(TT.lm_loss(tcfg, tp, tt, tl))
    np.testing.assert_allclose(l_got, l_want, **_tol(dt, "loss"))
    p_want = JT.prefill(jcfg, params, toks)
    p_got = TSS.build_lm_prefill(tcfg)(tp, tt)
    np.testing.assert_array_equal(_tn(p_got)[:, jcfg.vocab:], -1e30)
    np.testing.assert_allclose(_tn(p_got)[:, :jcfg.vocab],
                               _np(p_want)[:, :jcfg.vocab],
                               **_tol(dt, "logits"))


@pytest.mark.parametrize("arch", ARCHS)
def test_gradients(arch):
    """Every leaf's gradient of ``lm_loss`` at fp32 against ``jax.grad``."""
    jcfg, tcfg, params, tp = _carry(arch, "f32")
    b = _tokens(jcfg, b=2, s=16)
    want = jax.grad(lambda p: JT.lm_loss(
        jcfg, p, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"])))(params)
    wf = {jax.tree_util.keystr(p): v for p, v in
          jax.tree_util.tree_flatten_with_path(want)[0]}
    flat = O.tree_flatten_with_path(tp)
    leaves = [v.clone().requires_grad_(True) for _, v in flat]
    loss = TT.lm_loss(tcfg, O.tree_unflatten(tp, leaves),
                      torch.from_numpy(b["tokens"]),
                      torch.from_numpy(b["labels"]))
    grads = torch.autograd.grad(loss, leaves)
    for (path, _), g in zip(flat, grads):
        np.testing.assert_allclose(_tn(g), _np(wf[path]), rtol=1e-4,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(arch, dt):
    """Five ``decode_step``s from an empty cache against the reference's:
    the logits each step and the cache after the last."""
    jcfg, tcfg, params, tp = _carry(arch, dt)
    toks = _tokens(jcfg, b=2, s=5)["tokens"]
    jc = JT.KVCache.empty(jcfg, 2, 8)
    tc = TT.KVCache.empty(tcfg, 2, 8, device="cpu")
    serve = TSS.build_lm_decode(tcfg)
    for t in range(5):
        jl, jc = JT.decode_step(jcfg, params, jc, jnp.asarray(toks[:, t]))
        tl, tc = serve(tp, tc, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(_tn(tl)[:, :jcfg.vocab],
                                   _np(jl)[:, :jcfg.vocab],
                                   **_tol(dt, "logits"))
    assert tc.length == int(jc.length) == 5
    np.testing.assert_allclose(_tn(tc.k), _np(jc.k), **_tol(dt, "hidden"))
    np.testing.assert_allclose(_tn(tc.v), _np(jc.v), **_tol(dt, "hidden"))


@pytest.mark.parametrize("arch", ["smollm-135m", "granite-moe-1b-a400m"])
def test_prefill_cache_continues_decode(arch):
    """``prefill(s_max=...)`` returns the prompt's cache: it equals the
    cache of decoding the prompt token by token, and decoding on from it
    gives ``prefill`` of the longer prompt (fp32; the reference's own
    decode-vs-prefill test holds bf16 at 2e-2)."""
    _, tcfg, _, tp = _carry(arch, "f32")
    toks = torch.from_numpy(_tokens(tcfg, b=2, s=12)["tokens"])
    logits, cache = TT.prefill(tcfg, tp, toks[:, :8], s_max=16)
    dc = TT.KVCache.empty(tcfg, 2, 16, device="cpu")
    for t in range(8):
        dl, dc = TT.decode_step(tcfg, tp, dc, toks[:, t])
    np.testing.assert_allclose(_tn(dl), _tn(logits), **TOL)
    np.testing.assert_allclose(_tn(cache.k), _tn(dc.k), **TOL)
    for t in range(8, 12):
        dl, cache = TT.decode_step(tcfg, tp, cache, toks[:, t])
        want = TT.prefill(tcfg, tp, toks[:, :t + 1])
        np.testing.assert_allclose(_tn(dl), _tn(want), **TOL)


def test_decode_matches_prefill_bf16():
    """The reference's decode-vs-prefill test on the port, bf16 as given."""
    tcfg = get_arch("smollm-135m").reduced
    tp = TT.init_params(tcfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.randint(0, tcfg.vocab, (2, 8),
                         generator=torch.Generator().manual_seed(1))
    lp = TT.prefill(tcfg, tp, toks)
    cache = TT.KVCache.empty(tcfg, 2, 16, device="cpu")
    for t in range(8):
        ld, cache = TT.decode_step(tcfg, tp, cache, toks[:, t])
    np.testing.assert_allclose(_tn(lp)[:, :tcfg.vocab],
                               _tn(ld)[:, :tcfg.vocab], atol=2e-2, rtol=2e-2)
    assert bool((lp.argmax(-1) == ld.argmax(-1)).all())


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "smollm-135m"])
def test_train_steps(arch):
    """Three steps of ``build_train_step`` with the CLIs' loss and default
    optimizer (Adam dense, row-wise Adagrad on ``embed``) and clipping,
    against the reference's jitted step from the same weights, at fp32."""
    jcfg, tcfg, params, tp = _carry(arch, "f32")
    jspec, tspec = jax_get_arch(arch), get_arch(arch)
    jopt, topt = JTS.default_optimizer(), TTS.default_optimizer()
    jloss, _ = JLT.build_loss(jspec, jcfg, None)
    tloss, _ = LT.build_loss(tspec, tcfg, {})
    jstep = jax.jit(JTS.build_train_step(jloss, jopt))
    tstep = TTS.build_train_step(tloss, topt)
    js, tst = JTS.TrainState.create(params, jopt), TTS.TrainState.create(
        tp, topt)
    jb, tb = JLT.make_batch_fn(jspec, jcfg), LT.make_batch_fn(tspec, tcfg)
    for i in range(3):
        b = jb(4, 0, i)
        np.testing.assert_array_equal(tb(4, 0, i)["tokens"], b["tokens"])
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        tst, tm = tstep(tst, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=TRAIN_RTOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=TRAIN_RTOL)
    np.testing.assert_allclose(_tn(tst.params["embed"]),
                               _np(js.params["embed"]), rtol=TRAIN_RTOL,
                               atol=1e-6)
    np.testing.assert_allclose(_tn(tst.params["layers"]["wq"]),
                               _np(js.params["layers"]["wq"]),
                               rtol=TRAIN_RTOL, atol=1e-6)


def test_train_cli(capsys):
    LT.main(["--arch", "granite-moe-1b-a400m", "--steps", "3", "--batch",
             "4", "--log-every", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "family=lm" in out and "step     2" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_run(arch):
    spec = get_arch(arch)
    res = LT.run(spec, spec.reduced, steps=2, batch=2, device="cpu")
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    assert res.last_batch["tokens"].shape == (2, 64)


def test_serve_cli_refuses_lm():
    from repro_torch.launch import serve as LS
    with pytest.raises(SystemExit, match="recsys serving CLI"):
        LS.main(["--arch", "smollm-135m", "--device", "cpu"])
