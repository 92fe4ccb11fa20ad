"""Retrieval and the zoo's losses under the bank axis, and the compressed
and clipped DP train step, on the CPU: gloo ranks of the port
(``tests/torch_dist_zoo_ranks.py``) against the JAX reference's
single-device results and the port's own.

One world of 4 ranks is spawned once per file (a module-scoped fixture)
and runs every check as a 1 x 4 grid and then as a 2 x 2 grid, at the
reduced sizes. The reference spreads retrieval candidates and sampled
negatives over every mesh axis; so does the port (``dist.collectives``):

  * each rank's retrieval scores are its piece of the single-device
    scores (rtol 1e-5 / atol 1e-6) and no more of them (the whole list
    where N does not divide by the world, as the reference replicates
    it), and every rank returns the single-device top k: values within
    tolerance, ids id for id on a tie-free draw, exact ties lowest global
    index first;
  * BERT4Rec's sampled loss with spread negatives (the cross-rank
    log-sum-exp) and its full-catalog loss equal the reference's on the
    whole batch, and so do the gradients after the train step's dp mean
    (rtol 1e-5 / atol 1e-6);
  * ``compress_roundtrip(dist)`` of a fixed tree's pieces equals the
    reference's whole-tree result bit for bit;
  * the DP step clipped over every leaf, the table included, has the
    single-device norm within rtol 1e-6; two compressed steps on a plan
    that keeps each field on one bank equal the port's single-device
    steps bit for bit on the 1 x 4 grid (the bank sum adds zeros), and
    its losses at rtol 1e-4 on the 2 x 2 grid (the dp mean reorders).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import partitioning as JP
from repro.data import synthetic as JS
from repro.models import bert4rec as JB
from repro.models import din as JDIN
from repro.models import dlrm as JD
from repro.models import xdeepfm as JX
from repro.serve import serve_step as JSS
from repro.train import compress as JCOMP
from repro.train import train_step as JTS
from repro_torch.configs import get_arch
from repro_torch.convert import (params_from_jax, statics_from_jax,
                                 zoo_params_from_jax, zoo_statics_from_jax)
from repro_torch.dist.launch import run_ranks
from repro_torch.models import family_module
from repro_torch.serve import serve_step as TSS
from repro_torch.train import train_step as TTS

import torch_dist_zoo_ranks as R

TOL = dict(rtol=1e-5, atol=1e-6)
WORLD = 4
GRIDS = {"g14": (1, 4), "g22": (2, 2)}
JMODS = {"dlrm-rm2": JD, "din": JDIN, "xdeepfm": JX, "bert4rec": JB,
         "updlrm-paper": JD}
ARCHS = R.RETRIEVAL_ARCHS


def _np(x):
    return np.asarray(x)


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _vocab(cfg):
    return cfg.vocab if hasattr(cfg, "vocab") else cfg.total_vocab


def _plan(arch, cfg, nb):
    """updlrm-paper: contiguous blocks, so each field's rows sit on one
    bank (every bag's bank sum adds zeros); the others: a greedy plan of a
    random popularity, so rows scatter over the banks."""
    if arch == "updlrm-paper":
        return JP.uniform_partition(cfg.total_vocab, nb)
    freq = np.random.default_rng(nb).random(_vocab(cfg)) + 0.05
    return JP.non_uniform_partition(freq, nb)


def _retrieval_batch(arch, cfg, n, seed):
    """One query and n DISTINCT candidates (a tie-free draw)."""
    rng = np.random.default_rng(seed)
    if arch == "dlrm-rm2":
        return {"dense": rng.standard_normal((1, cfg.n_dense)).astype(
                    np.float32),
                "sparse": np.array([[rng.integers(v) for v in
                                     cfg.vocab_sizes]], np.int32),
                "candidates": rng.permutation(cfg.vocab_sizes[0])[:n]
                .astype(np.int32)}
    if arch == "din":
        b = JS.din_batch(cfg.n_items, cfg.n_cates, cfg.seq_len, 1,
                         seed=seed, step=0)
        return {"hist_items": b["hist_items"], "hist_cates": b["hist_cates"],
                "candidates": rng.permutation(cfg.n_items)[:n].astype(
                    np.int32),
                "candidate_cates": rng.integers(0, cfg.n_cates, n).astype(
                    np.int32)}
    if arch == "xdeepfm":
        return {"sparse": JS.xdeepfm_batch(cfg.vocab_sizes, 1, seed=seed,
                                           step=0)["sparse"],
                "candidates": rng.permutation(cfg.vocab_sizes[0])[:n]
                .astype(np.int32)}
    return {"items": JS.bert4rec_batch(cfg.n_items, cfg.seq_len, 1,
                                       seed=seed, step=0)["items"],
            "candidates": rng.permutation(cfg.n_items)[:n].astype(np.int32)}


def _batch_keys(arch, cfg, n):
    """The batch keys of ``n`` examples that ride beside a retrieval
    query's (a train batch's)."""
    if arch == "dlrm-rm2":
        b = JS.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, n, seed=0, step=0)
        return {"dense": b["dense"], "sparse": b["sparse"]}
    if arch == "din":
        return {k: v for k, v in JS.din_batch(
            cfg.n_items, cfg.n_cates, cfg.seq_len, n, seed=0,
            step=0).items()}
    if arch == "xdeepfm":
        return JS.xdeepfm_batch(cfg.vocab_sizes, n, seed=0, step=0)
    return JS.bert4rec_batch(cfg.n_items, cfg.seq_len, n, seed=0, step=0,
                             n_negatives=cfg.n_negatives)


R_SPREAD = ("candidates", "candidate_cates", "negatives")
N_RB = {"dlrm-rm2": 64, "din": 64, "xdeepfm": 48, "bert4rec": 64}
N_RBX = {"dlrm-rm2": 90, "din": 90, "xdeepfm": 45, "bert4rec": 90}


def _inputs():
    inp, ref = {}, {"models": {}}
    for grid, (_, nb) in GRIDS.items():
        for arch in (*ARCHS, "updlrm-paper"):
            jcfg = jax_get_arch(arch).reduced
            jmod = JMODS[arch]
            plan = _plan(arch, jcfg, nb)
            params, statics = jmod.init_params(jcfg, jax.random.key(nb),
                                               plan=plan)
            pre = f"{grid}.{arch}."
            for i, leaf in enumerate(jax.tree_util.tree_leaves(params)):
                inp[f"{pre}leaf{i}"] = _np(leaf)
            inp[f"{pre}bank"] = _np(statics["remap_bank"])
            inp[f"{pre}slot"] = _np(statics["remap_slot"])
            inp[f"{pre}rpb"] = np.asarray(int(statics["rows_per_bank"]))
            inp[f"{pre}nb"] = np.asarray(int(statics["n_banks"]))
            if "field_offsets" in statics:
                inp[f"{pre}off"] = _np(statics["field_offsets"])
            if "cate_offset" in statics:
                inp[f"{pre}cate_offset"] = np.asarray(
                    int(statics["cate_offset"]))
            ref["models"][grid, arch] = (jcfg, params, statics)
    for arch in ARCHS:
        jcfg = jax_get_arch(arch).reduced
        for b, n, seed in (("rb", N_RB[arch], 11), ("rbx", N_RBX[arch], 12)):
            batch = _retrieval_batch(arch, jcfg, n, seed)
            ref[arch, b] = batch
            inp.update({f"{arch}.{b}.{k}": v for k, v in batch.items()})
    # exact ties: small integers, 1-D and three rows
    rng = np.random.default_rng(5)
    inp["ties1"] = rng.integers(0, 6, 64).astype(np.float32)
    inp["ties2"] = rng.integers(0, 4, (3, 64)).astype(np.float32)
    # BERT4Rec: a batch of 8 (4 a dp rank on the 2 x 2 grid), 32
    # negatives, some of them labels of the batch
    bcfg = jax_get_arch("bert4rec").reduced
    bb = JS.bert4rec_batch(bcfg.n_items, bcfg.seq_len, 8, seed=4, step=0,
                           n_negatives=bcfg.n_negatives)
    bb["negatives"][:4] = bb["labels"][bb["labels"] >= 0][:4]
    ref["b4r"] = bb
    inp.update({f"b4r.batch.{k}": v for k, v in bb.items()})
    # compression: a fixed tree whose largest magnitude sits on bank 1's
    # rows of one grid and bank 2's of the other
    emb = (rng.standard_normal((64, 6)) * 0.1).astype(np.float32)
    emb[40, 2] = -3.0
    lin = (rng.standard_normal((64, 1)) * 0.1).astype(np.float32)
    lin[20, 0] = 2.5
    tree = {"emb_packed": emb, "lin_packed": lin,
            "mlp": {"w": [rng.standard_normal((5, 3)).astype(np.float32)],
                    "b": [rng.standard_normal(3).astype(np.float32)]}}
    err = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 1e-3).astype(np.float32),
        tree)
    inp.update({"cmp.emb": emb, "cmp.lin": lin, "cmp.w": tree["mlp"]["w"][0],
                "cmp.b": tree["mlp"]["b"][0], "cmp.e_emb": err["emb_packed"],
                "cmp.e_lin": err["lin_packed"], "cmp.e_w": err["mlp"]["w"][0],
                "cmp.e_b": err["mlp"]["b"][0]})
    ref["cmp"] = (tree, err)
    ucfg = jax_get_arch("updlrm-paper").reduced
    ref["upd"] = []
    for i in range(2):
        b = JS.dlrm_batch(ucfg.vocab_sizes, ucfg.n_dense, 8, seed=6, step=i,
                          multi_hot=ucfg.multi_hot)
        ref["upd"].append(b)
        inp.update({f"upd.b{i}.{k}": v for k, v in b.items()})
    return inp, ref


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    inp, ref = _inputs()
    outs = run_ranks(R.zoo_grids, WORLD, tmp_path_factory.mktemp("zoo"),
                     inputs=inp, timeout=600, init_timeout=180)
    return inp, ref, outs


def _port(ref, grid, arch):
    """The port's single-device model on the grid's plan, whole."""
    jcfg, params, statics = ref["models"][grid, arch]
    tn = jax.tree_util.tree_map(np.asarray, params)
    spec = get_arch(arch)
    if spec.family == "dlrm":
        tp = params_from_jax(tn, "cpu")
        ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape")
                               else v for k, v in statics.items()}, "cpu")
    else:
        tp = zoo_params_from_jax(tn, "cpu")
        ts = zoo_statics_from_jax({k: np.asarray(v) if hasattr(v, "shape")
                                   else v for k, v in statics.items()}, "cpu")
    return spec.reduced, family_module(spec.family), tp, ts


def _tb(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _pieces(n, r, world=WORLD):
    if n % world:
        return slice(0, n)
    k = n // world
    return slice(r * k, (r + 1) * k)


CASES = [(g, a, b) for g in GRIDS for a in ARCHS for b in ("rb", "rbx")]


@pytest.mark.parametrize("grid,arch,b", CASES,
                         ids=[f"{g}-{a}-{b}" for g, a, b in CASES])
def test_retrieval_pieces(zoo, grid, arch, b):
    """Each rank scores its piece of the candidates, and only it: the
    reference's single-device scores of those candidates, and the port's
    (the whole list on every rank where N does not divide)."""
    inp, ref, outs = zoo
    jcfg, params, statics = ref["models"][grid, arch]
    batch = ref[arch, b]
    want = _np(JMODS[arch].retrieval_scores(jcfg, params, statics,
                                            _j(batch)))
    cfg, mod, tp, ts = _port(ref, grid, arch)
    port = mod.retrieval_scores(cfg, tp, ts, _tb(batch)).detach().numpy()
    n = batch["candidates"].shape[0]
    for r, o in enumerate(outs):
        got = o[f"{grid}.retrieval.{arch}.{b}.scores"]
        sl = _pieces(n, r)
        assert got.shape[-1] == sl.stop - sl.start
        np.testing.assert_allclose(got, want[..., sl], **TOL)
        np.testing.assert_allclose(got, port[..., sl], **TOL)


@pytest.mark.parametrize("grid,arch,b", CASES,
                         ids=[f"{g}-{a}-{b}" for g, a, b in CASES])
def test_retrieval_top_k(zoo, grid, arch, b):
    """Every rank returns the single-device top 16: the same on every
    rank, values within tolerance of the reference's, and on this
    tie-free draw the reference's ids wherever its scores are apart (one
    tolerance) from their neighbours."""
    inp, ref, outs = zoo
    jcfg, params, statics = ref["models"][grid, arch]
    wv, wi = JSS.build_retrieval_serve(JMODS[arch], jcfg, statics,
                                       top_k=16)(params, _j(ref[arch, b]))
    wv, wi = _np(wv).reshape(-1), _np(wi).reshape(-1)
    key = f"{grid}.retrieval.{arch}.{b}"
    for o in outs:
        np.testing.assert_array_equal(o[f"{key}.vals"],
                                      outs[0][f"{key}.vals"])
        np.testing.assert_array_equal(o[f"{key}.ids"], outs[0][f"{key}.ids"])
    gv, gi = outs[0][f"{key}.vals"].reshape(-1), \
        outs[0][f"{key}.ids"].reshape(-1)
    assert gi.dtype == np.int32
    np.testing.assert_allclose(gv, wv, **TOL)
    apart = np.abs(np.diff(wv)) > TOL["atol"] + TOL["rtol"] * np.abs(wv[1:])
    clear = np.ones(16, bool)
    clear[1:] &= apart
    clear[:-1] &= apart
    assert clear.sum() >= 8
    np.testing.assert_array_equal(gi[clear], wi[clear])


@pytest.mark.parametrize("grid", list(GRIDS))
def test_global_top_k_ties(zoo, grid):
    """Integer scores with many exact ties: the merged top 20 equals
    ``top_k_lowest_first`` of the whole list, value for value and index
    for index (ties lowest global index first), 1-D and per row."""
    inp, ref, outs = zoo
    for name in ("ties1", "ties2"):
        wv, wi = TSS.top_k_lowest_first(torch.from_numpy(inp[name]), 20)
        for o in outs:
            np.testing.assert_array_equal(o[f"{grid}.ties.{name}.vals"],
                                          wv.numpy())
            np.testing.assert_array_equal(o[f"{grid}.ties.{name}.ids"],
                                          wi.numpy())


LOSS_CASES = [(g, m) for g in GRIDS for m in ("sampled", "full")]


@pytest.mark.parametrize("grid,mode", LOSS_CASES,
                         ids=[f"{g}-{m}" for g, m in LOSS_CASES])
def test_bert4rec_loss_spread(zoo, grid, mode):
    """BERT4Rec's loss on the batch cut over dp, the negatives spread over
    the grid: after the train step's dp mean, the reference's loss on the
    whole batch and ``jax.grad`` of it (each rank's table shard the rows
    of its bank)."""
    inp, ref, outs = zoo
    jcfg, params, statics = ref["models"][grid, "bert4rec"]
    jcfg = dataclasses.replace(jcfg, loss=mode)
    b = _j(ref["b4r"])
    loss, grads = jax.value_and_grad(
        lambda p: JB.mlm_loss(jcfg, p, statics, b))(params)
    leaves = jax.tree_util.tree_flatten_with_path(grads)[0]
    rpb, nb = int(statics["rows_per_bank"]), GRIDS[grid][1]
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o[f"{grid}.b4r.{mode}.loss"],
                                   float(loss), **TOL)
        for i, (path, g) in enumerate(leaves):
            want = _np(g)
            if "emb_packed" in jax.tree_util.keystr(path):
                m = r % nb
                want = want[m * rpb:(m + 1) * rpb]
            np.testing.assert_allclose(
                o[f"{grid}.b4r.{mode}.grad{i}"], want, **TOL,
                err_msg=f"rank {r} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("grid", list(GRIDS))
def test_compress_roundtrip_bits(zoo, grid):
    """The pieces' compression equals the reference's whole tree's under
    ``jax.jit``, bit for bit: a table shard is quantized at the whole
    table's scale (the bank group's max), a replicated leaf at its own."""
    inp, ref, outs = zoo
    tree, err = ref["cmp"]
    g, e = jax.jit(JCOMP.compress_roundtrip)(tree, err)
    nb = GRIDS[grid][1]
    for r, o in enumerate(outs):
        m = r % nb
        for name, whole in (("emb", g["emb_packed"]),
                            ("lin", g["lin_packed"]),
                            ("e_emb", e["emb_packed"]),
                            ("e_lin", e["lin_packed"])):
            whole = _np(whole)
            k = whole.shape[0] // nb
            np.testing.assert_array_equal(
                o[f"{grid}.compress.{name}"], whole[m * k:(m + 1) * k],
                err_msg=f"rank {r} {name}")
        np.testing.assert_array_equal(o[f"{grid}.compress.w"],
                                      _np(g["mlp"]["w"][0]))
        np.testing.assert_array_equal(o[f"{grid}.compress.b"],
                                      _np(g["mlp"]["b"][0]))
        np.testing.assert_array_equal(o[f"{grid}.compress.e_w"],
                                      _np(e["mlp"]["w"][0]))


def _single_steps(ref, grid):
    """The reduced updlrm-paper's clipped step and two compressed steps on
    one device: the reference's (jitted) and the port's."""
    jcfg, params, statics = ref["models"][grid, "updlrm-paper"]
    cfg, mod, tp, ts = _port(ref, grid, "updlrm-paper")
    jopt, topt = JTS.default_optimizer(), TTS.default_optimizer()
    b0 = _j(ref["upd"][0])
    jclip = jax.jit(JTS.build_train_step(
        lambda p, b: JD.loss_fn(jcfg, p, statics, b), jopt,
        clip_include=lambda p: True))
    _, jm = jclip(JTS.TrainState.create(params, jopt), b0)
    jstep = jax.jit(JTS.build_train_step(
        lambda p, b: JD.loss_fn(jcfg, p, statics, b), jopt,
        compress_grads=True))
    tstep = TTS.build_train_step(
        lambda p, b: mod.loss_fn(cfg, p, ts, b), topt, compress_grads=True)
    js = JTS.TrainState.create(params, jopt, compress=True)
    tst = TTS.TrainState.create(tp, topt, compress=True)
    jl, tl = [], []
    for b in ref["upd"]:
        js, m = jstep(js, _j(b))
        jl.append(float(m["loss"]))
        tst, m = tstep(tst, _tb(b))
        tl.append(float(m["loss"]))
    return dict(clip_norm=float(jm["grad_norm"]), clip_loss=float(jm["loss"]),
                ref_losses=np.array(jl), losses=np.array(tl), state=tst,
                rpb=int(statics["rows_per_bank"]))


@pytest.mark.parametrize("grid", list(GRIDS))
def test_clipped_dp_step_norm(zoo, grid):
    """``clip_include`` selecting every leaf, the bank shards included:
    the norm (the shards' squares summed over the bank group, after the dp
    mean) is the single-device one within rtol 1e-6."""
    inp, ref, outs = zoo
    want = _single_steps(ref, grid)
    for o in outs:
        np.testing.assert_allclose(float(o[f"{grid}.steps.clip.norm"]),
                                   want["clip_norm"], rtol=1e-6)
        np.testing.assert_allclose(float(o[f"{grid}.steps.clip.loss"]),
                                   want["clip_loss"], **TOL)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_compressed_dp_steps(zoo, grid):
    """Two ``build_train_step(compress_grads=True, dist=...)`` steps. On
    the 1 x 4 grid every bag lies on one bank, so the bank sum adds zeros
    and the steps equal the port's single-device steps bit for bit (the
    table shards, their errors and accumulators, the dense params); on
    the 2 x 2 grid the dp mean reorders the sums, so the losses are held
    at rtol 1e-4. Both within rtol 1e-4 of the reference's losses."""
    inp, ref, outs = zoo
    want = _single_steps(ref, grid)
    st, rpb, nb = want["state"], want["rpb"], GRIDS[grid][1]
    for r, o in enumerate(outs):
        got = o[f"{grid}.steps.cmp.losses"]
        np.testing.assert_allclose(got, want["ref_losses"], rtol=1e-4)
        if grid == "g22":
            np.testing.assert_allclose(got, want["losses"], rtol=1e-4)
            continue
        m = r % nb
        rows = slice(m * rpb, (m + 1) * rpb)
        np.testing.assert_array_equal(got, want["losses"].astype(np.float32))
        np.testing.assert_array_equal(o[f"{grid}.steps.cmp.emb"],
                                      st.params["emb_packed"][rows].numpy())
        np.testing.assert_array_equal(o[f"{grid}.steps.cmp.err"],
                                      st.err_state["emb_packed"][rows]
                                      .numpy())
        np.testing.assert_array_equal(o[f"{grid}.steps.cmp.acc"],
                                      st.opt_state["true"][0][rows].numpy())
        np.testing.assert_array_equal(o[f"{grid}.steps.cmp.top_w0"],
                                      st.params["top"]["w"][0].numpy())


POLICY_CASES = [(g, a) for g in GRIDS for a in (*ARCHS, "updlrm-paper")]


@pytest.mark.parametrize("grid,arch", POLICY_CASES,
                         ids=[f"{g}-{a}" for g, a in POLICY_CASES])
def test_sharding_policies_match_reference(grid, arch):
    """The port cuts the zoo's params and batches where the reference's
    policies place them, on an abstract mesh of the grid's shape: a leaf is
    a bank shard exactly where ``recsys_param_shardings`` gives
    ``P('model', None)`` (``emb_packed``, xDeepFM's ``lin_packed``); a
    batch key is cut over dp exactly where the reference's spec leads with
    ``'data'``; a spread key (``SPREAD_KEYS``) is held whole by
    ``recsys_batch_shardings`` and cut by the model exactly where the
    reference spreads it over ``('data', 'model')``."""
    from jax.sharding import AbstractMesh, PartitionSpec as P
    from repro.core import embedding as JE
    from repro.dist import sharding as JSH
    from repro_torch.core.embedding import DistCtx
    from repro_torch.dist import collectives as coll
    from repro_torch.dist import sharding as TSH
    data, model = GRIDS[grid]
    jd = JE.DistCtx(mesh=AbstractMesh((data, model), ("data", "model")),
                    dp_axes=("data",))
    td = DistCtx(data=data, model=model, rank=0, device=torch.device("cpu"),
                 bank_group=None, dp_group=None)
    jcfg = jax_get_arch(arch).reduced
    params, _ = JMODS[arch].init_params(jcfg, jax.random.key(0),
                                        plan=_plan(arch, jcfg, model))
    specs = jax.tree_util.tree_flatten_with_path(
        JSH.recsys_param_shardings(jd, params))[0]
    leaves = jax.tree_util.tree_leaves(params)
    cut = 0
    for (path, sh), leaf in zip(specs, leaves):
        key = jax.tree_util.keystr(path)
        mine = TSH._is_table(key, torch.from_numpy(np.array(leaf)), model)
        assert mine == (sh.spec == P("model", None)), key
        cut += mine
    assert cut == (2 if arch == "xdeepfm" else 1)
    for n in (8, 5):
        if arch == "updlrm-paper":
            b = JS.dlrm_batch(jcfg.vocab_sizes, jcfg.n_dense, n, seed=0,
                              step=0, multi_hot=jcfg.multi_hot)
        else:
            b = _retrieval_batch(arch, jcfg, 64 if n == 8 else 45, 0)
            b.update(_batch_keys(arch, jcfg, n))
        keys = tuple(k for k in b if k in R_SPREAD)
        want = {jax.tree_util.keystr(p)[2:-2]: sh.spec for p, sh in
                jax.tree_util.tree_flatten_with_path(
                    JSH.recsys_batch_shardings(jd, b, keys))[0]}
        got, ctx = TSH.recsys_batch_shardings(
            td, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()},
            keys)
        for k, v in b.items():
            lead = want[k][0] if len(want[k]) else None
            if k in keys:
                assert tuple(got[k].shape) == v.shape, k
                sl = coll.spread_slice(td, v.shape[0])
                assert sl.stop - sl.start == (
                    v.shape[0] // (data * model)
                    if lead == ("data", "model") else v.shape[0]), k
            elif v.ndim:
                assert got[k].shape[0] == (
                    v.shape[0] // data if lead == "data" else v.shape[0]), k
