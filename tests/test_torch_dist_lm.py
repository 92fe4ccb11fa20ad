"""The LM family under the bank axis, on the CPU: gloo ranks of the port
(``tests/torch_dist_lm_ranks.py``) against the JAX reference's
single-device results, and the port's LM sharding policies against the
reference's on an ``AbstractMesh``.

One world of 4 ranks is spawned once per file (a module-scoped fixture)
and runs every case as a 1 x 4 and as a 2 x 2 (data x bank) grid. The
reference's own ``shard_map`` path does not run under this JAX (its
``tests/dist_checks.py`` dies there), so the yardstick is its
single-device output on the whole inputs:

  * ``seqsharded_decode_attention`` with the cache cut over the bank axis
    and over both axes (``kv_cache_shardings``), at a position inside the
    first piece and one in the last: the attention within rtol 1e-5 /
    atol 1e-6 of ``_decode_attention_local``'s, each rank's cache piece
    (the new row written by its owner only) bit for bit;
  * ``moe_layer_sharded`` (8 experts, top 2, capacity factor 4: no slot
    is dropped on any dp slice, so the local capacity matches the whole
    batch's): the dp slices' outputs within rtol 1e-5 / atol 1e-6 of
    ``moe_layer``'s at fp32, and atol 2e-2 at bf16 (a bf16 ulp at the
    outputs' scale: the bank sum adds the experts' parts in another
    order);
  * ``lm_loss`` on the reduced granite-moe-1b-a400m (MoE) and smollm-135m
    (dense GQA) with the params cut by ``lm_param_shardings``: the dp mean
    of the ranks' losses within rtol 2e-3 of the reference's at the
    configs' bf16 (the reference's own tolerance for its sharded loss)
    and within rtol 1e-5 at fp32, and the pieces' gradients (after the dp
    mean) within rtol 1e-4 / atol 1e-6 of ``jax.grad``'s at fp32.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.dist import collectives as JC
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.dist.launch import run_ranks

import torch_dist_lm_ranks as R

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WORLD = 4


def _np(x):
    return np.asarray(x)


def _flat_params(params, prefix):
    out, names = {}, []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            n = ".".join(path)
            names.append(n)
            out[f"{prefix}{n}"] = np.asarray(node)
    walk(params, [])
    out[f"{prefix}names"] = np.array(names)
    return out


def _inputs():
    rng = np.random.default_rng(18)
    B, S, Hq, Hkv, Dh = 4, 16, 4, 2, 8
    inp = {"dec.q": rng.standard_normal((B, Hq, Dh)).astype(np.float32),
           "dec.kn": rng.standard_normal((B, Hkv, Dh)).astype(np.float32),
           "dec.vn": rng.standard_normal((B, Hkv, Dh)).astype(np.float32),
           "dec.kc": rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
           "dec.vc": rng.standard_normal((B, S, Hkv, Dh)).astype(np.float32),
           "dec.pos": np.array([2, 13])}
    d, E, ff = 64, 8, 32
    inp.update({
        "moe.x": rng.standard_normal((4, 8, d)).astype(np.float32),
        "moe.w_router": (rng.standard_normal((d, E)) / 8).astype(np.float32),
        "moe.w_gate": (rng.standard_normal((E, d, ff)) / 8)
        .astype(np.float32),
        "moe.w_up": (rng.standard_normal((E, d, ff)) / 8).astype(np.float32),
        "moe.w_down": (rng.standard_normal((E, ff, d)) / 6)
        .astype(np.float32),
        "moe.top_k": np.array(2), "moe.cf": np.array(4.0)})
    for arch in R.LOSS_ARCHS:
        cfg = jax_get_arch(arch).reduced
        params = JT.init_params(cfg, jax.random.key(3))
        inp.update(_flat_params(params, f"lm.{arch}."))
        toks = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)
        inp[f"lm.{arch}.tokens"] = toks
        inp[f"lm.{arch}.labels"] = np.roll(toks, -1, axis=1)
    return inp


def _reference(inp) -> dict:
    ref = {}
    q, kn, vn, kc, vc = (jnp.asarray(inp[f"dec.{k}"])
                         for k in ("q", "kn", "vn", "kc", "vc"))
    for pos in inp["dec.pos"]:
        o, k2, v2 = JC.seqsharded_decode_attention(q, kn, vn, kc, vc,
                                                   jnp.int32(pos), dist=None)
        ref[f"dec.{pos}"] = tuple(map(_np, (o, k2, v2)))
    x = jnp.asarray(inp["moe.x"])
    for dt, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        w = [jnp.asarray(inp[f"moe.{k}"]).astype(dtype)
             for k in ("w_router", "w_gate", "w_up", "w_down")]
        y, stats = JL.moe_layer(x.reshape(-1, x.shape[-1]).astype(dtype), *w,
                                top_k=int(inp["moe.top_k"]),
                                capacity_factor=float(inp["moe.cf"]))
        assert float(stats.dropped) == 0.0
        ref[f"moe.{dt}"] = _np(y.astype(jnp.float32)).reshape(x.shape)
    for arch in R.LOSS_ARCHS:
        base = jax_get_arch(arch).reduced
        params = JT.init_params(base, jax.random.key(3))
        toks = jnp.asarray(inp[f"lm.{arch}.tokens"])
        labels = jnp.asarray(inp[f"lm.{arch}.labels"])
        for dt, dtype in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
            cfg = dataclasses.replace(base, dtype=dtype)
            if dt == "f32":
                loss, g = jax.value_and_grad(
                    lambda p: JT.lm_loss(cfg, p, toks, labels))(params)
                ref[f"grad.{arch}.embed"] = _np(g["embed"])
                ref[f"grad.{arch}.w_up"] = _np(g["layers"]["w_up"])
                ref[f"grad.{arch}.wq"] = _np(g["layers"]["wq"])
            else:
                loss = JT.lm_loss(cfg, params, toks, labels)
            ref[f"loss.{arch}.{dt}"] = float(loss)
    return ref


@pytest.fixture(scope="module")
def lm_grids(tmp_path_factory):
    inp = _inputs()
    ref = _reference(inp)
    outs = run_ranks(R.lm_grids, WORLD, tmp_path_factory.mktemp("lm"),
                     inputs=inp, backend="gloo", timeout=300)
    return inp, ref, outs


def _coords(grid, r):
    data, model = R.GRIDS[grid]
    return r // model, r % model, data, model


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("axes", sorted(R.SEQ_AXES))
def test_seqsharded_decode_attention(lm_grids, grid, axes):
    inp, ref, outs = lm_grids
    B, S = inp["dec.kc"].shape[:2]
    for r, o in enumerate(outs):
        d, m, data, model = _coords(grid, r)
        n_seq = model if axes == "bank" else data * model
        idx = m if axes == "bank" else d * model + m
        cut, b0, b1 = (int(x) for x in o[f"{grid}.dec.{axes}.cut"])
        assert cut == len(R.SEQ_AXES[axes])          # S divides: cut
        want_b = (slice(d * B // data, (d + 1) * B // data)
                  if axes == "bank" and data > 1 else slice(0, B))
        assert (b0, b1) == (want_b.start, want_b.stop)
        s_loc = S // n_seq
        for pos in inp["dec.pos"]:
            o_w, k_w, v_w = ref[f"dec.{pos}"]
            key = f"{grid}.dec.{axes}.{pos}"
            np.testing.assert_allclose(o[f"{key}.o"], o_w[want_b], **TOL)
            sl = slice(idx * s_loc, (idx + 1) * s_loc)
            np.testing.assert_array_equal(o[f"{key}.kc"], k_w[want_b, sl])
            np.testing.assert_array_equal(o[f"{key}.vc"], v_w[want_b, sl])


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_moe_layer_sharded(lm_grids, grid, dt):
    inp, ref, outs = lm_grids
    want = ref[f"moe.{dt}"]
    tol = TOL if dt == "f32" else dict(rtol=0, atol=2e-2)
    for r, o in enumerate(outs):
        d, _, data, _ = _coords(grid, r)
        k = want.shape[0] // data
        np.testing.assert_allclose(o[f"{grid}.moe.{dt}"],
                                   want[d * k:(d + 1) * k], **tol)


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("arch", R.LOSS_ARCHS)
@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_lm_loss_sharded(lm_grids, grid, arch, dt):
    _, ref, outs = lm_grids
    data = R.GRIDS[grid][0]
    losses = [float(o[f"{grid}.loss.{arch}.{dt}"][0]) for o in outs]
    # a bank group's ranks hold the same dp slice and the same loss
    model = R.GRIDS[grid][1]
    for d in range(data):
        grp = losses[d * model:(d + 1) * model]
        assert max(grp) - min(grp) <= 1e-6 * abs(grp[0]), grp
    mean = float(np.mean([losses[d * model] for d in range(data)]))
    np.testing.assert_allclose(mean, ref[f"loss.{arch}.{dt}"],
                               rtol=1e-5 if dt == "f32" else 2e-3)


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("arch", R.LOSS_ARCHS)
def test_lm_loss_sharded_grads(lm_grids, grid, arch):
    """Each rank's gradient of its param pieces, dp-averaged, is its piece
    of the reference's whole-batch gradient."""
    from repro_torch.dist.sharding import lm_param_cut_dim
    _, ref, outs = lm_grids
    model = R.GRIDS[grid][1]
    paths = {"embed": "['embed']", "w_up": "['layers']['w_up']",
             "wq": "['layers']['wq']"}
    for leaf, path in paths.items():
        want = ref[f"grad.{arch}.{leaf}"]
        dim = lm_param_cut_dim(path, want.shape, model)
        assert dim is not None, (arch, leaf)
        k = want.shape[dim] // model
        for r, o in enumerate(outs):
            m = r % model
            piece = np.take(want, range(m * k, (m + 1) * k), axis=dim)
            np.testing.assert_allclose(o[f"{grid}.grad.{arch}.{leaf}"],
                                       piece, **GRAD_TOL,
                                       err_msg=f"{leaf}, rank {r}")


# ---------------------------------------------------------------------------
# the policies against the reference's on an AbstractMesh
# ---------------------------------------------------------------------------

def _ctx(data, model, rank):
    from jax.sharding import AbstractMesh
    from repro.core import embedding as JE
    from repro_torch.core.embedding import DistCtx
    jd = JE.DistCtx(mesh=AbstractMesh((data, model), ("data", "model")),
                    dp_axes=("data",))
    td = DistCtx(data=data, model=model, rank=rank,
                 device=torch.device("cpu"), bank_group=None,
                 dp_group=None)
    return jd, td


def _spec_dims(spec, name):
    return [i for i, e in enumerate(spec)
            if e == name or (isinstance(e, tuple) and name in e)]


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "smollm-135m",
                                  "granite-20b", "qwen3-moe-30b-a3b",
                                  "smollm-360m"])
def test_lm_param_shardings_match_reference(grid, arch):
    from repro.dist import sharding as JSH
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.dist import sharding as TSH
    from repro_torch.train import optim as O
    data, model = R.GRIDS[grid]
    cfg = jax_get_arch(arch).reduced
    params = JT.init_params(cfg, jax.random.key(0))
    tp = lm_params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    specs = [(jax.tree_util.keystr(p), sh.spec) for p, sh in
             jax.tree_util.tree_flatten_with_path(
                 JSH.lm_param_shardings(_ctx(data, model, 0)[0], params))[0]]
    for rank in range(data * model):
        pieces = dict(O.tree_flatten_with_path(
            TSH.lm_param_shardings(_ctx(data, model, rank)[1], tp)))
        whole = dict(O.tree_flatten_with_path(tp))
        assert sorted(pieces) == sorted(k for k, _ in specs)
        for key, spec in specs:
            dims = _spec_dims(spec, "model")
            got, w = pieces[key], whole[key]
            cut = [i for i in range(w.dim()) if got.shape[i] != w.shape[i]]
            assert cut == dims, (key, spec, tuple(got.shape))
            if dims:
                m, k = rank % model, got.shape[dims[0]]
                np.testing.assert_array_equal(
                    got.numpy(), w.narrow(dims[0], m * k, k).numpy())


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
def test_lm_batch_and_kv_cache_shardings_match_reference(grid):
    from repro.dist import sharding as JSH
    from repro_torch.dist import sharding as TSH
    from repro_torch.models import transformer as TT
    data, model = R.GRIDS[grid]
    jd, td = _ctx(data, model, data * model - 1)
    for n in (8, 5):
        b = {"tokens": np.zeros((n, 16), np.int32),
             "labels": np.zeros((n, 16), np.int32)}
        want = JSH.lm_batch_shardings(jd, b)
        got, _ = TSH.lm_batch_shardings(
            td, {k: torch.from_numpy(v) for k, v in b.items()})
        for k in b:
            lead = _spec_dims(want[k].spec, "data")
            assert got[k].shape[0] == (n // data if lead == [0] else n), k
    for (L_, B, S), seq, gt1 in (((2, 4, 16), ("model",), True),
                                 ((2, 4, 16), ("data", "model"), True),
                                 ((2, 3, 16), ("model",), True),
                                 ((2, 4, 6), ("model",), True),
                                 ((2, 4, 16), ("model",), False)):
        jcache = JT.KVCache(k=jnp.zeros((L_, B, S, 2, 8)),
                            v=jnp.zeros((L_, B, S, 2, 8)),
                            length=jnp.zeros((), jnp.int32))
        spec = JSH.kv_cache_shardings(jd, jcache, seq, gt1).k.spec
        tc = TT.KVCache(k=torch.zeros((L_, B, S, 2, 8)),
                        v=torch.zeros((L_, B, S, 2, 8)), length=0)
        taxes = tuple("bank" if a == "model" else "dp" for a in seq)
        piece, cut, bsl = TSH.kv_cache_shardings(td, tc, taxes, gt1)
        n_seq = int(np.prod([{"data": data, "model": model}[a]
                             for a in seq]))
        s_cut = spec[2] is not None
        b_cut = spec[1] is not None
        assert (len(cut) > 0) == s_cut
        assert piece.k.shape[2] == (S // n_seq if s_cut else S)
        assert piece.k.shape[1] == (B // data if b_cut else B)
        assert bsl.stop - bsl.start == piece.k.shape[1]
