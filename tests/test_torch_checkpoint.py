"""The port's checkpointing and data pipeline against the JAX package's, on
the CPU.

Checkpoints are compared bit for bit: the port writes and reads the
reference's on-disk format (``step_<n>/leaf_<i>.npy`` + ``tree.json`` with
JAX's key-string paths), so a checkpoint written by either package
restores in the other, bf16 leaves included (stored as raw 2-byte voids).
A restart of ``launch.train.run`` / ``run_adaptive`` from a checkpoint
must end in the state of the uninterrupted run, bit for bit.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as JCK
from repro.configs import get_arch as jax_get_arch
from repro.core.partitioning import non_uniform_partition as j_nup
from repro.core.partitioning import uniform_partition as j_up
from repro.data import pipeline as JP
from repro.data import synthetic as JS
from repro.models import dlrm as JD
from repro.train import train_step as JT
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    reshard_banked_table, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.checkpoint.ckpt import _flatten
from repro_torch.configs import get_arch
from repro_torch.convert import train_state_from_jax
from repro_torch.core.partitioning import (non_uniform_partition,
                                           uniform_partition)
from repro_torch.data import pipeline as TP
from repro_torch.data import synthetic as TS
from repro_torch.launch import train as TTRAIN
from repro_torch.train import train_step as TT


def _bits(x) -> np.ndarray:
    """A leaf's raw bits as an integer array (bf16 / V2 -> uint16), so two
    leaves compare bit for bit whatever their dtype spelling."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.itemsize == 2 and a.dtype.kind in "Vf" \
            and a.dtype.name != "float16":
        return a.view(np.uint16)
    return a


def _same_tree(port_tree, jax_tree):
    """Port tree vs reference tree: the same key-string paths in the same
    order, every leaf equal bit for bit with the same shape."""
    got = _flatten(port_tree)
    want = [(jax.tree_util.keystr(p), v) for p, v in
            jax.tree_util.tree_flatten_with_path(jax_tree)[0]]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        a, b = _bits(a), _bits(b)
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


def _jax_state(emb_bf16: bool, steps: int = 2):
    """A reference TrainState of reduced dlrm-rm2 (bf16 table if asked)
    with compression on, after ``steps`` steps: every leaf non-trivial."""
    jcfg = jax_get_arch("dlrm-rm2").reduced
    if emb_bf16:
        jcfg = dataclasses.replace(jcfg, emb_dtype=jnp.bfloat16)
    params, statics = JD.init_params(jcfg, jax.random.key(4))
    opt = JT.default_optimizer()
    step = jax.jit(JT.build_train_step(
        lambda p, b: JD.loss_fn(jcfg, p, statics, b), opt,
        compress_grads=True))
    st = JT.TrainState.create(params, opt, compress=True)
    for s in range(steps):
        b = JS.dlrm_batch(jcfg.vocab_sizes, jcfg.n_dense, 8, seed=1, step=s)
        st, _ = step(st, {k: jnp.asarray(v) for k, v in b.items()})
    return st


@pytest.mark.parametrize("emb_bf16", [False, True])
def test_reference_checkpoint_round_trips_through_the_port(tmp_path,
                                                           emb_bf16):
    """Reference save -> port restore -> port save -> reference restore:
    equal leaf for leaf, bit for bit (a bf16 table comes back as bf16
    tensors in the port and as the same 2-byte words in the reference);
    the port's manifest is the reference's: the same paths, indices,
    dtypes and shapes."""
    js = _jax_state(emb_bf16)
    JCK.save_checkpoint(str(tmp_path / "ref"), 2, js)
    target = train_state_from_jax(
        jax.tree_util.tree_map(lambda x: np.zeros_like(np.asarray(x)), js),
        "cpu")
    got, step = restore_checkpoint(str(tmp_path / "ref"), target)
    assert step == 2 and isinstance(got, TT.TrainState)
    _same_tree(got, js)
    assert got.params["emb_packed"].dtype == (torch.bfloat16 if emb_bf16
                                              else torch.float32)
    assert got.step.shape == () and got.step.dtype == torch.int32
    save_checkpoint(str(tmp_path / "port"), 2, got)
    back, _ = JCK.restore_checkpoint(str(tmp_path / "port"), js)
    _same_tree(got, back)
    man = [json.loads((tmp_path / d / "step_2" / "tree.json").read_text())
           for d in ("ref", "port")]
    assert man[0] == man[1]


@pytest.mark.parametrize("emb_bf16", [False, True])
def test_port_checkpoint_restores_in_the_reference(tmp_path, emb_bf16):
    """Port save (through the AsyncCheckpointer) -> reference restore ->
    reference save -> port restore: equal leaf for leaf, bit for bit."""
    js = _jax_state(emb_bf16, steps=1)
    state = train_state_from_jax(jax.tree_util.tree_map(np.asarray, js),
                                 "cpu")
    ck = AsyncCheckpointer(str(tmp_path / "port"))
    ck.save(7, state)
    ck.join()
    assert ck.stats[0]["step"] == 7 and ck.stats[0]["nbytes"] > 0
    ref, step = JCK.restore_checkpoint(str(tmp_path / "port"), js)
    assert step == 7
    _same_tree(state, ref)
    JCK.save_checkpoint(str(tmp_path / "ref"), 7, ref)
    again, _ = restore_checkpoint(str(tmp_path / "ref"), state)
    _same_tree(again, ref)


def test_save_restore_layout_and_latest_step(tmp_path):
    """The on-disk layout; ``latest_step`` skips an incomplete ``.tmp``
    save and a directory without its manifest; restore picks the newest
    complete step, keeps dtypes and shapes, raises FileNotFoundError on an
    empty or missing directory and KeyError on a missing leaf."""
    d = str(tmp_path / "ck")
    tree = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": [torch.tensor(3, dtype=torch.int32),
                  torch.ones(2, dtype=torch.bfloat16)], "none": None}
    for s in (1, 3):
        path = save_checkpoint(d, s, {**tree, "w": tree["w"] + s})
        assert path == os.path.join(d, f"step_{s}")
    assert sorted(os.listdir(path)) == ["leaf_0.npy", "leaf_1.npy",
                                        "leaf_2.npy", "tree.json"]
    man = json.loads(open(os.path.join(path, "tree.json")).read())
    assert man == {"step": 3, "leaves": [
        {"path": "['b'][0]", "index": 0, "dtype": "int32", "shape": []},
        {"path": "['b'][1]", "index": 1, "dtype": "bfloat16", "shape": [2]},
        {"path": "['w']", "index": 2, "dtype": "float32", "shape": [2, 3]}]}
    os.makedirs(os.path.join(d, "step_9.tmp"))
    os.makedirs(os.path.join(d, "step_8"))
    assert latest_step(d) == 3
    got, step = restore_checkpoint(d, tree)
    assert step == 3 and got["none"] is None
    assert torch.equal(got["w"], tree["w"] + 3)
    assert got["b"][0].shape == () and got["b"][0].dtype == torch.int32
    assert torch.equal(got["b"][1], tree["b"][1])
    got1, _ = restore_checkpoint(d, tree, step=1)
    assert torch.equal(got1["w"], tree["w"] + 1)
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(d, {**tree, "extra": torch.zeros(1)})
    assert latest_step(str(tmp_path / "nope")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "nope"), tree)
    os.makedirs(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "empty"), tree)


def test_async_checkpointer_keeps_the_newest(tmp_path):
    """``keep=2``: after saves at steps 1..5 only steps 4 and 5 remain, as
    the reference's writer leaves them; the saved tensors are copies (a
    later in-place change does not reach the files)."""
    d = str(tmp_path / "ck")
    ck, ref = AsyncCheckpointer(d, keep=2), JCK.AsyncCheckpointer(
        str(tmp_path / "ref"), keep=2)
    for s in range(1, 6):
        t = {"x": torch.full((3,), float(s))}
        ck.save(s, t)
        t["x"].zero_()
        ref.save(s, {"x": np.full((3,), float(s), np.float32)})
    ck.join()
    ref.join()
    assert sorted(os.listdir(d)) == sorted(os.listdir(tmp_path / "ref")) \
        == ["step_4", "step_5"]
    got, step = restore_checkpoint(d, {"x": torch.zeros(3)})
    assert step == 5 and got["x"].tolist() == [5.0, 5.0, 5.0]
    assert [r["step"] for r in ck.stats] == [1, 2, 3, 4, 5]
    assert all(r["write_s"] >= 0 for r in ck.stats)


@pytest.mark.parametrize("banks", [(4, 8), (8, 4), (4, 4)])
def test_reshard_banked_table_matches_jax(banks):
    """Elastic re-partition between bank counts: the reference's packed
    array exactly, and every logical row in its new home."""
    old_b, new_b = banks
    V, D = 300, 5
    freq = np.random.default_rng(3).random(V) + 0.1
    old_t, new_t = non_uniform_partition(freq, old_b), uniform_partition(
        V, new_b)
    old_j, new_j = j_nup(freq, old_b), j_up(V, new_b)
    table = np.random.default_rng(4).standard_normal((V, D)).astype(
        np.float32)
    packed = np.zeros((old_b * old_t.max_rows_per_bank, D), np.float32)
    packed[old_t.bank_of_row.astype(np.int64) * old_t.max_rows_per_bank
           + old_t.slot_of_row] = table
    got = reshard_banked_table(packed, old_t, new_t)
    want = JCK.reshard_banked_table(packed, old_j, new_j)
    np.testing.assert_array_equal(got, want)
    flat = new_t.bank_of_row.astype(np.int64) * new_t.max_rows_per_bank \
        + new_t.slot_of_row
    np.testing.assert_array_equal(got[flat], table)


def test_sharded_loader_matches_jax():
    """``take(n)`` equals the reference's on the same generator (steps,
    and every array); the prefetch thread yields the same stream; hosts
    draw distinct slices."""
    kw = dict(vocab_sizes=(50, 40), n_dense=3, multi_hot=4)
    for host in (0, 1):
        want = JP.ShardedLoader(JS.dlrm_batch, global_batch=8, n_hosts=2,
                                host_id=host, seed=5, start_step=3,
                                **kw).take(4)
        loader = TP.ShardedLoader(TS.dlrm_batch, global_batch=8, n_hosts=2,
                                  host_id=host, seed=5, start_step=3, **kw)
        got = loader.take(4)
        assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5, 6]
        for (_, g), (_, w) in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        it = iter(loader)
        streamed = [next(it) for _ in range(4)]
        it.close()
        for (s, g), (t, w) in zip(streamed, got):
            assert s == t
            np.testing.assert_array_equal(g["sparse"], w["sparse"])
    a = TP.ShardedLoader(TS.dlrm_batch, global_batch=8, n_hosts=2,
                         host_id=0, **kw).take(1)[0][1]
    b = TP.ShardedLoader(TS.dlrm_batch, global_batch=8, n_hosts=2,
                         host_id=1, **kw).take(1)[0][1]
    assert a["sparse"].shape == (4, 2, 4)
    assert not np.array_equal(a["sparse"], b["sparse"])


def _state_equal(a: TT.TrainState, b: TT.TrainState):
    fa, fb = _flatten(a), _flatten(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert torch.equal(x, y), path


@pytest.mark.parametrize("compress", [True, False])
def test_run_restart_equals_the_uninterrupted_run(tmp_path, compress):
    """``launch.train.run`` for 6 steps against 4 steps, then a second
    call for 6 that restores step 4: the same final params, optimizer
    state, error-feedback state and step count, bit for bit, and the same
    losses for steps 4 and 5; checkpoints every 2 steps and at the end,
    as the reference's, the last three kept."""
    spec = get_arch("updlrm-paper")
    kw = dict(batch=4, device="cpu", compress_grads=compress, ckpt_every=2)
    a = TTRAIN.run(spec, spec.reduced, steps=6,
                   ckpt_dir=str(tmp_path / "a"), **kw)
    b1 = TTRAIN.run(spec, spec.reduced, steps=4,
                    ckpt_dir=str(tmp_path / "b"), **kw)
    assert b1.start_step == 0 and latest_step(str(tmp_path / "b")) == 4
    b = TTRAIN.run(spec, spec.reduced, steps=6,
                   ckpt_dir=str(tmp_path / "b"), **kw)
    assert b.start_step == 4 and b.checkpoints["restore_s"] is not None
    assert b.losses == a.losses[4:] and len(b.step_ms) == 2
    _state_equal(b.state, a.state)
    assert (a.state.err_state is not None) == compress
    assert sorted(os.listdir(tmp_path / "a")) == ["step_2", "step_4",
                                                  "step_6"]
    assert [r["step"] for r in a.checkpoints["saves"]] == [2, 4, 6, 6]


def test_run_adaptive_restart_restores_the_remaps(tmp_path):
    """``run_adaptive`` on the §3.2 path, compressed, 5 steps with a drift
    check after step 2 (a migration) against 4 steps and a restart from
    step 4: the restart reads the migrated plan's remaps saved beside step
    4 (not the initial plan's), and ends in the uninterrupted run's state
    bit for bit, the migrated error-feedback buffers included."""
    spec = get_arch("updlrm-paper")
    kw = dict(batch=8, replan_every=3, device="cpu", compress_grads=True,
              ckpt_every=2)
    a = TTRAIN.run_adaptive(spec, spec.reduced, steps=5,
                            ckpt_dir=str(tmp_path / "a"), **kw)
    assert [s for s, _ in a.migrations] == [2]
    d = str(tmp_path / "b")
    TTRAIN.run_adaptive(spec, spec.reduced, steps=4, ckpt_dir=d, **kw)
    with np.load(os.path.join(d, "adaptive_remaps_4.npz")) as z:
        saved = z["remap_bank"]
    # step 2 was saved before the migration (after step index 1), step 4
    # after it
    plan0 = non_uniform_partition(np.ones(spec.reduced.total_vocab), 8,
                                  capacity_rows=int(a.statics[
                                      "rows_per_bank"]))
    with np.load(os.path.join(d, "adaptive_remaps_2.npz")) as z:
        np.testing.assert_array_equal(z["remap_bank"], plan0.bank_of_row)
    assert not np.array_equal(saved, plan0.bank_of_row)
    b = TTRAIN.run_adaptive(spec, spec.reduced, steps=5, ckpt_dir=d, **kw)
    assert b.start_step == 4 and b.migrations == []
    np.testing.assert_array_equal(b.statics["remap_bank"].numpy(), saved)
    for k in ("remap_bank", "remap_slot", "remap_flat"):
        assert torch.equal(b.statics[k], a.statics[k]), k
    assert b.losses == a.losses[4:]
    _state_equal(b.state, a.state)


def test_run_adaptive_cache_aware_ignores_ckpt_dir(tmp_path):
    """The cache-aware path neither saves nor restores, as the reference's
    ``_main_train_cached``; compression still runs on it."""
    spec = get_arch("updlrm-paper")
    res = TTRAIN.run_adaptive(spec, spec.reduced, partition="cache_aware",
                              steps=2, batch=4, replan_every=2,
                              device="cpu", compress_grads=True,
                              ckpt_dir=str(tmp_path / "c"), ckpt_every=1)
    assert not os.path.exists(tmp_path / "c")
    assert res.checkpoints is None and res.state.err_state is not None
