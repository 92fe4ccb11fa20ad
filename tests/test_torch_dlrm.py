"""The port's DLRM forward and serve step against the JAX package's, on the
CPU, with the reference's own weights carried across (``repro_torch.convert``).

Tolerances: the embedding stage is bit-exact (fp32 entry-order sums on
both sides); the MLPs and the interaction are fp32 matmuls and dots summed
in another order, so logits and scores agree to rtol = 1e-5, atol = 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core.partitioning import non_uniform_partition
from repro.models import dlrm as JD
from repro.serve import serve_step as JSS
from repro_torch.configs import get_arch
from repro_torch.convert import (params_from_jax, replicated_table_from_jax,
                                 statics_from_jax, to_tensor)
from repro_torch.core.embedding import banked_embedding_bag
from repro_torch.launch import serve as TSERVE
from repro_torch.models import dlrm as TD
from repro_torch.serve import serve_step as TSS

TOL = dict(rtol=1e-5, atol=1e-6)


def _cfgs(arch):
    jcfg, tcfg = jax_get_arch(arch).reduced, get_arch(arch).reduced
    if arch == "dlrm-rm2":       # the full config stores its table in bf16
        jcfg = dataclasses.replace(jcfg, emb_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, emb_dtype=torch.bfloat16)
    return jcfg, tcfg


def _carry(jcfg, plan, seed=0):
    params, statics = JD.init_params(jcfg, jax.random.key(seed), plan=plan)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    return params, statics, tp, ts


def _batch(cfg, b, seed=3):
    from repro.data import synthetic as JS
    bt = JS.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, b, seed=seed, step=0,
                       multi_hot=cfg.multi_hot)
    sp = bt["sparse"]
    rng = np.random.default_rng(seed)
    sp[rng.random(sp.shape) < 0.15] = -1         # holes / missing fields
    return bt


def _tbatch(bt):
    return {k: torch.from_numpy(v) for k, v in bt.items()}


def _plan(jcfg, n_banks):
    if n_banks == 1:
        return None
    freq = np.random.default_rng(11).random(jcfg.total_vocab) + 0.05
    return non_uniform_partition(freq, n_banks)


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
@pytest.mark.parametrize("n_banks", [1, 4])
def test_forward_matches_jax(arch, n_banks):
    jcfg, tcfg = _cfgs(arch)
    params, statics, tp, ts = _carry(jcfg, _plan(jcfg, n_banks))
    bt = _batch(jcfg, 8)
    want = JD.forward(jcfg, params, statics,
                      {k: jnp.asarray(v) for k, v in bt.items()})
    got = TD.forward(tcfg, tp, ts, _tbatch(bt))
    assert tuple(got.shape) == want.shape == (8,)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(
        TD.forward(tcfg, tp, ts, _tbatch(bt), backend="torch").numpy(),
        got.numpy(), rtol=0, atol=0)


def test_multihot_embedding_stage_is_bit_exact():
    jcfg, tcfg = _cfgs("updlrm-paper")
    params, statics, tp, ts = _carry(jcfg, _plan(jcfg, 4))
    bt = _batch(jcfg, 8)
    from repro.core import embedding as JE
    want = JE.banked_embedding_bag(JD._banked(params, statics),
                                   jnp.asarray(bt["sparse"]), None,
                                   backend="jnp",
                                   field_offsets=statics["field_offsets"])
    got = banked_embedding_bag(TD._banked(tp, ts),
                               torch.from_numpy(bt["sparse"]),
                               field_offsets=ts["field_offsets"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_serve_scores_match_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    params, statics, tp, ts = _carry(jcfg, None, seed=1)
    bt = _batch(jcfg, 6, seed=4)
    bt.pop("label")
    want = JSS.build_recsys_serve(JD, jcfg, statics)(
        params, {k: jnp.asarray(v) for k, v in bt.items()})
    got = TSS.build_recsys_serve(TD, tcfg, ts)(tp, _tbatch(bt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ((got > 0) & (got < 1)).all()


def test_bce_loss_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal(32) * 4).astype(np.float32)
    labels = rng.integers(0, 2, 32).astype(np.float32)
    np.testing.assert_allclose(
        TD.bce_loss(torch.from_numpy(logits), torch.from_numpy(labels)).item(),
        float(JD.bce_loss(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_init_params_layout_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    plan = _plan(jcfg, 4)
    jp, js = JD.init_params(jcfg, jax.random.key(0), plan=plan)
    tp, ts = TD.init_params(tcfg, torch.Generator().manual_seed(0), plan=plan,
                            device="cpu")
    assert tuple(tp["emb_packed"].shape) == jp["emb_packed"].shape
    assert tp["emb_packed"].dtype == tcfg.emb_dtype
    for side in ("bot", "top"):
        for key in ("w", "b"):
            assert [tuple(x.shape) for x in tp[side][key]] == \
                [x.shape for x in jp[side][key]]
    for key in ("remap_bank", "remap_slot", "field_offsets"):
        assert ts[key].dtype == torch.int32
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    assert (ts["n_banks"], ts["rows_per_bank"]) == (js["n_banks"],
                                                    js["rows_per_bank"])
    w = tp["bot"]["w"][0]
    assert w.abs().max().item() <= 2.0 / np.sqrt(w.shape[0]) + 1e-6


def test_microbatcher_pads_and_stacks_like_jax():
    from repro.data import synthetic as JS
    cfg = jax_get_arch("updlrm-paper").reduced
    proto = JS.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, 1, seed=0, step=0,
                          multi_hot=cfg.multi_hot)
    proto.pop("label")
    pad = {k: v[0] for k, v in proto.items()}
    jmb = JSS.MicroBatcher(4, pad)
    tmb = TSS.MicroBatcher(4, pad, device="cpu")
    for rid in range(6):
        b = JS.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, 1, seed=1, step=rid,
                          multi_hot=cfg.multi_hot)
        feats = {k: b[k][0] for k in pad}
        jmb.submit(JSS.Request(rid, feats))
        tmb.submit(TSS.Request(rid, feats))
    for n_real in (4, 2):
        jreqs, jf = jmb.next_batch()
        treqs, tf = tmb.next_batch()
        assert [r.rid for r in treqs] == [r.rid for r in jreqs]
        assert len(treqs) == n_real
        for k in pad:
            assert tf[k].dtype == to_tensor(np.asarray(jf[k]), "cpu").dtype
            np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]))
    tmb.complete(treqs)
    assert len(tmb.latencies) == 2 and tmb.p99() >= 0.0


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_run_serves_like_jax_on_the_same_weights(arch):
    """The slice end to end: ``launch.serve.run`` on the CPU, then the same
    requests scored by the reference with the port's weights carried back."""
    spec = get_arch(arch)
    res = TSERVE.run(spec, spec.reduced, requests=10, batch=4, device="cpu")
    assert tuple(res.scores.shape) == (10,)
    assert torch.isfinite(res.scores).all()
    assert len(res.latencies) == 10 and res.p99_ms >= res.p50_ms >= 0.0
    jcfg = jax_get_arch(arch).reduced
    jp = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), res.params)
    js = {k: jnp.asarray(v.numpy()) if isinstance(v, torch.Tensor) else v
          for k, v in res.statics.items()}
    reqs = [TSERVE._one(spec.reduced, rid) for rid in range(10)]
    batch = {k: jnp.asarray(np.concatenate([r[k] for r in reqs]))
             for k in reqs[0]}
    want = JSS.build_recsys_serve(JD, jcfg, js)(jp, batch)
    np.testing.assert_allclose(res.scores.numpy(), np.asarray(want), **TOL)


def _replicated(ts, tp, k_max, n_banks=4):
    """The reference's ``pack_replicated`` of the carried table's rows (in
    the table's dtype), its 8 hottest rows under a Zipf-like prior given
    ``k_max`` copies."""
    from repro.core import embedding as JE
    from repro.core.partitioning import replicated_partition
    packed = tp["emb_packed"]
    rows = packed[ts["remap_flat"].long()].float().numpy()
    V = rows.shape[0]
    freq = 1.0 / (1.0 + np.arange(V) % 97)
    copies = np.ones(V, np.int32)
    copies[np.argsort(-freq, kind="stable")[:8]] = k_max
    rplan = replicated_partition(freq, n_banks, copies=copies, k_max=k_max)
    return JE.pack_replicated(
        rows, rplan, dtype=jnp.bfloat16 if packed.dtype == torch.bfloat16
        else None)


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
@pytest.mark.parametrize("dead", [False, True])
def test_forward_replicated_matches_jax(arch, dead):
    """``forward(replicated=, bank_live=)``: the same logits as the
    reference within rtol 1e-5 / atol 1e-6, the embedding stage bit for
    bit; with every bank live, the same logits as the single-copy path."""
    from repro.core import embedding as JE
    from repro_torch.core.embedding import replicated_embedding_bag
    jcfg, tcfg = _cfgs(arch)
    params, statics, tp, ts = _carry(jcfg, _plan(jcfg, 4))
    jrt = _replicated(ts, tp, 4)
    trt = replicated_table_from_jax(jrt, "cpu")
    live = np.ones(4, bool)
    if dead:
        live[1] = False
    bt = _batch(jcfg, 8)
    want = JD.forward(jcfg, params, statics,
                      {k: jnp.asarray(v) for k, v in bt.items()},
                      replicated=jrt, bank_live=jnp.asarray(live))
    got = TD.forward(tcfg, tp, ts, _tbatch(bt), replicated=trt,
                     bank_live=torch.from_numpy(live))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    sp = bt["sparse"] if bt["sparse"].ndim == 3 else bt["sparse"][..., None]
    e_want = JE.replicated_embedding_bag(
        jrt, jnp.asarray(sp), None, backend="jnp",
        field_offsets=statics["field_offsets"], bank_live=jnp.asarray(live))
    e_got = replicated_embedding_bag(trt, torch.from_numpy(sp),
                                     field_offsets=ts["field_offsets"],
                                     bank_live=torch.from_numpy(live))
    np.testing.assert_array_equal(e_got.float().numpy(),
                                  np.asarray(e_want.astype(jnp.float32)))
    if not dead:
        np.testing.assert_array_equal(
            got.numpy(), TD.forward(tcfg, tp, ts, _tbatch(bt)).numpy())


def test_forward_refuses_unported_paths():
    jcfg, tcfg = _cfgs("updlrm-paper")
    _, _, tp, ts = _carry(jcfg, None)
    bt = _tbatch(_batch(jcfg, 2))
    # the tiered lookup is ported; its combinations the reference does not
    # wire raise as there
    with pytest.raises(ValueError, match="bank_live"):
        TD.forward(tcfg, tp, ts, bt, tiered=object(),
                   bank_live=torch.ones(8, dtype=torch.bool))
    with pytest.raises(ValueError, match="tiered x replicated"):
        TD.forward(tcfg, tp, ts, bt, tiered=object(), replicated=object())
    # the replicated lookup is ported; its mesh path (DistCtx) refuses as
    # in the reference
    with pytest.raises(ValueError, match="unsharded-only"):
        TD.forward(tcfg, tp, ts, bt, dist=object(),
                   replicated=replicated_table_from_jax(
                       _replicated(ts, tp, 4), "cpu"))
