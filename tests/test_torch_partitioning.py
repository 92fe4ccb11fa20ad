"""The port's numpy planning, synthetic data, registry and table packing
against the JAX package's: for the same inputs, equal arrays."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.core import partitioning as JP
from repro.core.embedding import pack_table as jax_pack_table
from repro.data import synthetic as JS
from repro_torch.configs import get_arch
from repro_torch.core import partitioning as TP
from repro_torch.core.embedding import pack_table
from repro_torch.data import synthetic as TS


def _assert_plans_equal(a, b):
    assert a.n_banks == b.n_banks
    for f in ("bank_of_row", "slot_of_row", "rows_per_bank", "load_per_bank"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)
    assert a.max_rows_per_bank == b.max_rows_per_bank
    assert a.imbalance() == b.imbalance()


@pytest.mark.parametrize("vocab,n_banks", [(1, 1), (100, 1), (100, 3),
                                           (4000, 8), (97, 16)])
def test_uniform_partition_matches_jax(vocab, n_banks):
    freq = np.random.default_rng(vocab).random(vocab)
    _assert_plans_equal(TP.uniform_partition(vocab, n_banks),
                        JP.uniform_partition(vocab, n_banks))
    _assert_plans_equal(TP.uniform_partition(vocab, n_banks, freq),
                        JP.uniform_partition(vocab, n_banks, freq))


def _zipf(v, seed):
    return JS.zipf_popularity(v, 1.1, np.random.default_rng(seed))


@pytest.mark.parametrize("case", [
    dict(freq="uniform", n_banks=4),
    dict(freq="zipf", n_banks=4),
    dict(freq="zipf", n_banks=8, batch=16),
    dict(freq="zipf", n_banks=8, batch=7, capacity_rows=80),
    dict(freq="ties", n_banks=3),
    dict(freq="zipf", n_banks=4, capacity_rows=150,
         bank_capacity_rows=[130, 0, 200, 200]),
    dict(freq="zipf", n_banks=4, row_weights="halves"),
    dict(freq="zipf", n_banks=4, bank_cost=[1.0, 3.0, 1.0, 1.0]),
    # the adaptive loop's plans: all-ones with capacity slack, then byte
    # weights of a tier map; and float32 counts
    dict(freq="uniform", n_banks=8, capacity_rows=63),
    dict(freq="zipf", n_banks=8, capacity_rows=63, row_weights="tiers"),
    dict(freq="counts32", n_banks=5, capacity_rows=110,
         bank_capacity_rows=[110, 110, 0, 110, 110],
         bank_cost=[1, 1, 1, 2, 1]),
])
def test_non_uniform_partition_matches_jax(case):
    case = dict(case)
    v = 400
    kind = case.pop("freq")
    freq = {"uniform": np.ones(v), "zipf": _zipf(v, 3),
            "ties": np.repeat(np.arange(4, dtype=np.float64), v // 4),
            "counts32": np.random.default_rng(5).integers(0, 9, v).astype(
                np.float32)}[kind]
    kw = dict(case)
    n_banks = kw.pop("n_banks")
    if kw.get("row_weights") == "halves":
        kw["row_weights"] = np.where(np.arange(v) % 2 == 0, 1.0, 0.5)
    elif kw.get("row_weights") == "tiers":
        kw["row_weights"] = np.array([64.0, 32.0, 16.0])[
            np.random.default_rng(4).integers(0, 3, v)]
    for k in ("bank_capacity_rows", "bank_cost"):
        if k in kw:
            kw[k] = np.asarray(kw[k])
    got = TP.non_uniform_partition(freq, n_banks, **kw)
    want = JP.non_uniform_partition(freq, n_banks, **kw)
    _assert_plans_equal(got, want)
    got.validate()


def test_non_uniform_partition_raises_like_jax():
    freq = np.ones(100)
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="capacity exhausted"):
            mod.non_uniform_partition(freq, 4, capacity_rows=20)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_banks", [1, 4])
def test_pack_table_matches_jax(dtype, n_banks):
    rng = np.random.default_rng(n_banks)
    v, d = 300, 8
    table = rng.standard_normal((v, d)).astype(np.float32)
    freq = rng.random(v) + 0.1
    plan = TP.non_uniform_partition(freq, n_banks)
    jplan = JP.non_uniform_partition(freq, n_banks)
    got = pack_table(table, plan, dtype=getattr(torch, dtype), device="cpu")
    want = jax_pack_table(table, jplan, dtype=getattr(jnp, dtype))
    assert got.packed.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.packed.float().numpy(),
                                  np.asarray(want.packed, np.float32))
    np.testing.assert_array_equal(got.remap_bank.numpy(),
                                  np.asarray(want.remap_bank))
    np.testing.assert_array_equal(got.remap_slot.numpy(),
                                  np.asarray(want.remap_slot))
    np.testing.assert_array_equal(got.flat_remap().numpy(),
                                  np.asarray(want.flat_remap()))
    assert (got.n_banks, got.rows_per_bank, got.vocab, got.dim) == (
        want.n_banks, want.rows_per_bank, want.vocab, want.dim)


def test_synthetic_matches_jax():
    assert TS.WORKLOADS == {k: TS.WorkloadProfile(*dataclasses.astuple(p))
                            for k, p in JS.WORKLOADS.items()}
    np.testing.assert_array_equal(
        TS.zipf_popularity(1000, 1.18, np.random.default_rng(5)),
        JS.zipf_popularity(1000, 1.18, np.random.default_rng(5)))
    for multi_hot in (1, 16):
        a = TS.dlrm_batch((50, 60, 70), 13, 4, seed=1, step=9,
                          multi_hot=multi_hot)
        b = JS.dlrm_batch((50, 60, 70), 13, 4, seed=1, step=9,
                          multi_hot=multi_hot)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_registry_matches_jax(arch):
    got, want = get_arch(arch), jax_get_arch(arch)
    assert (got.arch_id, got.family, got.shapes, got.notes) == (
        want.arch_id, want.family, want.shapes, want.notes)
    for g, w in ((got.config, want.config), (got.reduced, want.reduced)):
        for f in dataclasses.fields(w):
            gv, wv = getattr(g, f.name), getattr(w, f.name)
            if f.name in ("dtype", "emb_dtype"):
                assert str(gv).split(".")[-1] == jnp.dtype(wv).name
            else:
                assert gv == wv, f.name
        np.testing.assert_array_equal(g.field_offsets(), w.field_offsets())
        assert g.param_count() == w.param_count()


def test_registry_refuses_unported_families():
    # every family of the reference is ported (GAT was the last): the
    # registry refuses only an arch it does not know, as the reference's
    assert get_arch("gat-cora").family == "gat"
    with pytest.raises(KeyError, match="unknown arch 'nope'"):
        get_arch("nope")
