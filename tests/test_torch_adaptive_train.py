"""The port's adaptive training (``launch.train --adaptive``) against the
JAX package's loops, on the CPU: the §3.2 path (telemetry on the batch's
rows, drift-triggered migrations of the table and its row-wise Adagrad
state) and the cache-aware path (every batch rewritten on the host, the
remaps and the cache table as step arguments, migrations and partial-sum
refreshes through the runtime's cache lane).

The reference's loops (``launch/train.py main``'s adaptive branch and
``_main_train_cached``) are driven from its own modules with its jnp
backend; its weights are carried across with ``repro_torch.convert``.
Planning, mining and rewriting are numpy on both sides: the migrations,
their plans, the refreshes, the rewritten ids and the reads must be equal.
Losses agree within rtol 1e-4 and the trained table within rtol 1e-5 /
atol 1e-6 (the MLPs' fp32 order differs, as in tests/test_torch_train.py);
the Adagrad state is permuted exactly with its rows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.data import synthetic as JSYN
from repro.models import dlrm as JD
from repro.obs import traffic as JTF
from repro.train import train_step as JT
from repro.workload import migrate as JMIG
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax
from repro_torch.launch import train as TTRAIN
from repro_torch.workload import migrate as TMIG

GRAD_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4
KW = dict(steps=9, batch=8, replan_every=3, cache_refresh_every=4, seed=2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _jax_train_adaptive(cfg, *, partition, steps, batch, replan_every,
                        cache_refresh_every, seed, banks=8,
                        capacity_slack=0.25, cache_entries=128):
    """The reference's adaptive train loops, driven from its modules (jnp
    backend, no checkpoints, no exporters): returns the initial params and,
    per step, what the test compares."""
    from repro.workload import (AdaptiveEmbeddingRuntime, ReplanConfig,
                                Replanner, migrate_packed_leaves,
                                rows_from_sparse)
    mh, V = cfg.multi_hot, cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    plan = JP.non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    params, statics = JD.init_params(cfg, jax.random.key(seed), plan=plan,
                                     rows_per_bank=cap)
    offs = np.asarray(statics["field_offsets"])
    opt = JT.default_optimizer()
    state = JT.TrainState.create(params, opt)
    out = {"losses": [], "reads": [], "migrations": [], "refreshes": [],
           "rewritten": []}
    kw = dict(backend="jnp", bwd_backend="jnp")
    if partition == "cache_aware":
        table = JE.BankedTable(packed=params["emb_packed"],
                               remap_bank=statics["remap_bank"],
                               remap_slot=statics["remap_slot"],
                               n_banks=banks, rows_per_bank=cap)
        rcfg = ReplanConfig.for_vocab(
            V, banks, capacity_rows=cap, check_every=replan_every,
            partitioner="cache_aware",
            cache_rows_per_bank=max(1, -(-cache_entries // banks)),
            mine_min_support=2, telemetry_decay=0.8,
            telemetry_decay_every=4096)
        runtime = AdaptiveEmbeddingRuntime(
            table, plan, rcfg, init_freq=np.ones(V),
            max_cache_per_bag=max(2, mh // 4), max_residual_per_bag=mh)

        def loss_cached(p, b):
            logits = JD.forward_cached(
                cfg, p, statics, b["cache_table"],
                {"dense": b["dense"], "cache_idx": b["cache_idx"],
                 "residual_idx": b["residual_idx"]},
                remap_bank=b["remap_bank"], remap_slot=b["remap_slot"], **kw)
            return JD.bce_loss(logits, b["label"])
        step_fn = jax.jit(JT.build_train_step(loss_cached, opt))
    else:
        replanner = Replanner(ReplanConfig.for_vocab(
            V, banks, capacity_rows=cap, check_every=replan_every), V,
            init_freq=np.ones(V))
        bank_of_row = np.asarray(statics["remap_bank"])

        def make_step(st):
            return jax.jit(JT.build_train_step(
                lambda p, b: JD.loss_fn(cfg, p, st, b, **kw), opt))
        step_fn = make_step(statics)
    for step in range(steps):
        b = JSYN.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, batch, seed=seed,
                            step=step, multi_hot=mh)
        if partition == "cache_aware":
            sp = np.asarray(b["sparse"])
            union = np.where(sp >= 0, sp + offs[None, :, None], -1)
            runtime.observe_bags([bag[bag >= 0]
                                  for bag in union.reshape(-1, mh)])
            rb = runtime.rewrite(union)
            out["rewritten"].append((rb.cache_idx, rb.residual_idx,
                                     rb.version))
            batch_j = {"dense": jnp.asarray(b["dense"]),
                       "label": jnp.asarray(b["label"]),
                       "cache_idx": jnp.asarray(rb.cache_idx),
                       "residual_idx": jnp.asarray(rb.residual_idx),
                       "remap_bank": runtime.table.remap_bank,
                       "remap_slot": runtime.table.remap_slot,
                       "cache_table": runtime.cache_table_for(rb.version)}
            out["reads"].append(JTF.host_cached_bank_read_counts(
                np.asarray(batch_j["cache_table"].remap_bank), rb.cache_idx,
                np.asarray(runtime.table.remap_bank), rb.residual_idx,
                banks))
            state, m = step_fn(state, batch_j)
            runtime.table = JE.BankedTable(
                packed=state.params["emb_packed"],
                remap_bank=runtime.table.remap_bank,
                remap_slot=runtime.table.remap_slot, n_banks=banks,
                rows_per_bank=cap)
            update = runtime.replanner.end_batch()
            if update is not None:
                state = migrate_packed_leaves(state, runtime.table,
                                              update.plan, rows_per_bank=cap)
                runtime.apply_migrated(update, JE.BankedTable(
                    packed=state.params["emb_packed"],
                    remap_bank=jnp.asarray(update.plan.bank_of_row,
                                           jnp.int32),
                    remap_slot=jnp.asarray(update.plan.slot_of_row,
                                           jnp.int32),
                    n_banks=banks, rows_per_bank=cap))
                out["migrations"].append((step, update))
            elif (step + 1) % cache_refresh_every == 0:
                out["refreshes"].append((step, runtime.refresh_cache()))
        else:
            rows = rows_from_sparse(b["sparse"], offs)
            replanner.observe_rows(rows)
            out["reads"].append(JTF.host_bank_read_counts(bank_of_row, rows,
                                                          banks))
            state, m = step_fn(state, {k: jnp.asarray(v)
                                       for k, v in b.items()})
            update = replanner.end_batch()
            if update is not None:
                old = JE.BankedTable(packed=state.params["emb_packed"],
                                     remap_bank=statics["remap_bank"],
                                     remap_slot=statics["remap_slot"],
                                     n_banks=banks, rows_per_bank=cap)
                state = migrate_packed_leaves(state, old, update.plan,
                                              rows_per_bank=cap)
                statics = {**statics,
                           "remap_bank": jnp.asarray(update.plan.bank_of_row,
                                                     jnp.int32),
                           "remap_slot": jnp.asarray(update.plan.slot_of_row,
                                                     jnp.int32)}
                step_fn = make_step(statics)
                bank_of_row = update.plan.bank_of_row
                out["migrations"].append((step, update))
        out["losses"].append(float(m["loss"]))
    out["state"] = jax.tree_util.tree_map(np.asarray, state)
    return params, out


@pytest.mark.parametrize("partition", ["non_uniform", "cache_aware"])
def test_run_adaptive_matches_jax_loop(partition, monkeypatch):
    """``updlrm-paper`` reduced, 9 steps at batch 8, a drift check every 3
    steps (cache_aware: a refresh every 4): the same migrations at the same
    steps with the same plans and reports, the same refreshes and rewritten
    ids, the same reads; losses within rtol 1e-4, the trained table and
    its Adagrad state within rtol 1e-5 / atol 1e-6; every migration moves
    the Adagrad state exactly as ``migrate_rowwise_state`` (the port's and
    the reference's) moves it."""
    jcfg = jax_get_arch("updlrm-paper").reduced
    jparams, want = _jax_train_adaptive(jcfg, partition=partition, **KW)
    moved = []
    real = TTRAIN._migrate_state

    def spy(state, table, plan, cap):
        new = real(state, table, plan, cap)
        moved.append((state.opt_state["true"][0].clone(), table, plan, cap,
                      new.opt_state["true"][0]))
        return new

    monkeypatch.setattr(TTRAIN, "_migrate_state", spy)
    spec = get_arch("updlrm-paper")
    res = TTRAIN.run_adaptive(
        spec, spec.reduced, partition=partition, device="cpu",
        params=params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                               "cpu"), **KW)

    assert len(want["migrations"]) >= 2
    assert [s for s, _ in res.migrations] == \
        [s for s, _ in want["migrations"]]
    for (_, a), (_, b) in zip(res.migrations, want["migrations"]):
        for f in ("bank_of_row", "slot_of_row", "load_per_bank"):
            np.testing.assert_array_equal(getattr(a.plan, f),
                                          getattr(b.plan, f))
        assert dataclasses.asdict(a.report) == dataclasses.asdict(b.report)
    assert res.refreshes == want["refreshes"]
    if partition == "cache_aware":
        assert len(res.refreshes) >= 1
        assert len(res.rewritten) == len(want["rewritten"]) == KW["steps"]
        for (ci, ri, v), (jci, jri, jv) in zip(res.rewritten,
                                               want["rewritten"]):
            np.testing.assert_array_equal(ci, jci)
            np.testing.assert_array_equal(ri, jri)
            assert v == jv
        assert any((ci >= 0).any() for ci, _, _ in res.rewritten)
    for g, w in zip(res.reads, want["reads"]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(res.losses, want["losses"], rtol=LOSS_RTOL)
    assert np.isfinite(res.losses).all()
    st = want["state"]
    np.testing.assert_allclose(_np(res.state.params["emb_packed"]),
                               st.params["emb_packed"], **GRAD_TOL)
    np.testing.assert_allclose(_np(res.state.opt_state["true"][0]),
                               st.opt_state["true"][0], **GRAD_TOL)
    np.testing.assert_array_equal(_np(res.statics["remap_bank"]),
                                  want["migrations"][-1][1].plan.bank_of_row)
    assert len(moved) == len(want["migrations"])
    for acc, table, plan, cap, new in moved:
        assert torch.equal(new, TMIG.migrate_rowwise_state(
            acc, table, plan, rows_per_bank=cap))
        jt = JE.BankedTable(packed=jnp.asarray(_np(table.packed)),
                            remap_bank=jnp.asarray(_np(table.remap_bank)),
                            remap_slot=jnp.asarray(_np(table.remap_slot)),
                            n_banks=table.n_banks,
                            rows_per_bank=table.rows_per_bank)
        np.testing.assert_array_equal(_np(new), np.asarray(
            JMIG.migrate_rowwise_state(jnp.asarray(_np(acc)), jt, plan,
                                       rows_per_bank=cap)))


def test_cached_train_step_takes_no_cache_gradient():
    """On the cache-aware path the cache table rides in the batch and takes
    no gradient: the trained state holds the EMT alone, and the cache
    table a step reads is the one of its batch's version."""
    spec = get_arch("updlrm-paper")
    res = TTRAIN.run_adaptive(spec, spec.reduced, partition="cache_aware",
                              steps=4, batch=4, replan_every=2,
                              cache_refresh_every=2, device="cpu")
    assert sorted(res.state.params) == ["bot", "emb_packed", "top"]
    ct = res.last_batch["cache_table"]
    assert not ct.packed.requires_grad
    assert ct is res.runtime.cache_table_for(res.rewritten[-1][2])
    assert len(res.step_ms) == 4 and len(res.host_ms["batch"]) == 4


def test_run_adaptive_refuses_bad_options_and_the_cpu_fallback(monkeypatch):
    spec = get_arch("updlrm-paper")
    with pytest.raises(ValueError, match="partition"):
        TTRAIN.run_adaptive(spec, spec.reduced, steps=1, batch=2,
                            partition="uniform", device="cpu")
    with pytest.raises(ValueError, match="multi-hot"):
        TTRAIN.run_adaptive(spec, dataclasses.replace(spec.reduced,
                                                      multi_hot=1),
                            steps=1, batch=2, partition="cache_aware",
                            device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["--partition", "cache_aware"]):
        with pytest.raises(RuntimeError, match="is_available"):
            TTRAIN.main(["--arch", "updlrm-paper", "--adaptive",
                         "--steps", "2", *extra])
