"""The port's banked lookup against the JAX package's, on the CPU.

The same table (the reference's packed arrays, carried across with
``repro_torch.convert``) and the same -1 padded ids go through the port's
``banked_embedding_bag`` and through the reference's ``jnp`` scan and its
Pallas kernel in interpret mode. Bag sums are summed in fp32 in entry order
on every path, so they must agree bit for bit (``assert_array_equal``), in
fp32 and bf16 alike.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE
from repro.core.partitioning import non_uniform_partition, uniform_partition
from repro.kernels import ref as JREF
from repro.kernels.embedding_bag import banked_embedding_bag_pallas
from repro_torch.convert import banked_table_from_jax, to_tensor
from repro_torch.core import embedding as TE
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.embedding_bag import banked_bag, banked_bag_plain

F, PER_FIELD, D = 8, 500, 8


def _table(n_banks, dtype, seed=0):
    rng = np.random.default_rng(seed)
    v = F * PER_FIELD
    table = rng.standard_normal((v, D)).astype(np.float32)
    plan = uniform_partition(v, 1) if n_banks == 1 else \
        non_uniform_partition(rng.random(v) + 0.1, n_banks)
    jt = JE.pack_table(table, plan, dtype=dtype)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), jt.n_banks,
                               jt.rows_per_bank, "cpu")
    return jt, tt


def _ids(b, l, seed=1):
    """(b, F, l) per-field ids with interior -1 holes, short bags and one
    all-pad bag."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, PER_FIELD, (b, F, l)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = -1                    # interior holes
    lens = rng.integers(0, l + 1, (b, F))
    idx[np.arange(l)[None, None, :] >= lens[..., None]] = -1  # short bags
    idx[0, 3] = -1                                           # all-pad bag
    return idx


def _offsets():
    return np.arange(F, dtype=np.int32) * PER_FIELD


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_banks", [1, 4])
@pytest.mark.parametrize("dead", [False, True])
def test_bag_matches_jax_jnp_and_pallas(dtype, n_banks, dead):
    dead_bank = n_banks // 2 if dead else None
    jt, tt = _table(n_banks, getattr(jnp, dtype))
    idx = _ids(6, 16)
    live = np.ones(n_banks, bool)
    if dead_bank is not None:
        live[dead_bank] = False
    j_live = None if dead_bank is None else jnp.asarray(live)
    t_live = None if dead_bank is None else torch.from_numpy(live)
    fo = _offsets()

    got = TE.banked_embedding_bag(tt, torch.from_numpy(idx), None,
                                  backend="torch",
                                  field_offsets=torch.from_numpy(fo),
                                  bank_live=t_live)
    got_auto = TE.banked_embedding_bag(tt, torch.from_numpy(idx),
                                       field_offsets=torch.from_numpy(fo),
                                       bank_live=t_live)
    want_jnp = JE.banked_embedding_bag(jt, jnp.asarray(idx), None,
                                       backend="jnp", field_offsets=fo,
                                       bank_live=j_live)
    want_pallas = JE.banked_embedding_bag(jt, jnp.asarray(idx), None,
                                          backend="pallas", interpret=True,
                                          field_offsets=fo, bank_live=j_live)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want_jnp.shape == (6, F, D)
    np.testing.assert_array_equal(_np(got), _np(want_jnp))
    np.testing.assert_array_equal(_np(got), _np(want_pallas))
    np.testing.assert_array_equal(_np(got_auto), _np(got))
    assert not _np(got)[0, 3].any()                # the all-pad bag is zero
    if dead_bank is not None:
        full = TE.banked_embedding_bag(tt, torch.from_numpy(idx),
                                       field_offsets=torch.from_numpy(fo))
        assert not np.array_equal(_np(full), _np(got))


@pytest.mark.parametrize("my", [-1, 0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_plain_matches_pallas_kernel(my, dtype):
    """The kernel's plain version against the reference's Pallas kernel
    itself (interpret mode), with and without the ownership mask."""
    jt, tt = _table(4, getattr(jnp, dtype), seed=4)
    idx = _ids(5, 12, seed=5).reshape(-1, 12)
    fo = _offsets()
    pad = (-idx.shape[0]) % 8
    idx_p = np.concatenate([idx, np.full((pad, 12), -1, np.int32)])
    want = banked_embedding_bag_pallas(
        jt.packed, jt.remap_bank, jt.flat_remap(), jnp.asarray(fo),
        jnp.asarray([my], jnp.int32), jnp.asarray(idx_p), tile_b=8,
        interpret=True)[:idx.shape[0]]
    args = (tt.packed, tt.remap_bank, tt.flat_remap(), torch.from_numpy(fo),
            my, torch.from_numpy(idx))
    got = banked_bag_plain(*args)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(banked_bag(*args)), _np(got))


@pytest.mark.parametrize("my", [0, 1, 3])
def test_kernel_plain_matches_banked_bag_ref(my):
    """``banked_bag_plain`` with ``my >= 0`` against the reference oracle
    ``kernels/ref.banked_bag_ref`` (no field offsets: ids are union rows).
    The oracle sums with ``jnp.sum``, whose order XLA chooses, so the
    comparison is to fp32 rounding; the port's own oracle is compared to
    the reference's the same way."""
    jt, tt = _table(4, jnp.float32, seed=7)
    rng = np.random.default_rng(8)
    idx = rng.integers(-1, F * PER_FIELD, (9, 10)).astype(np.int32)
    got = banked_bag_plain(tt.packed, tt.remap_bank, tt.flat_remap(),
                           torch.zeros(1, dtype=torch.int32), my,
                           torch.from_numpy(idx))
    want = JREF.banked_bag_ref(jt.packed, jt.remap_bank, jt.flat_remap(),
                               jnp.asarray(idx), my)
    oracle = TREF.banked_bag_ref(tt.packed, tt.remap_bank, tt.flat_remap(),
                                 torch.from_numpy(idx), my)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(_np(oracle), _np(want), rtol=1e-6, atol=1e-6)
    assert np.abs(_np(got)).sum() > 0


def test_embedding_bag_ref_matches_jax():
    rng = np.random.default_rng(9)
    table = rng.standard_normal((50, 8)).astype(np.float32)
    idx = rng.integers(-1, 50, (7, 6)).astype(np.int32)
    np.testing.assert_allclose(
        TREF.embedding_bag_ref(torch.from_numpy(table),
                               torch.from_numpy(idx)).numpy(),
        np.asarray(JREF.embedding_bag_ref(jnp.asarray(table),
                                          jnp.asarray(idx))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dead", [False, True])
def test_banked_gather_matches_jax(dtype, dead):
    jt, tt = _table(4, getattr(jnp, dtype), seed=2)
    rng = np.random.default_rng(3)
    rows = rng.integers(-1, F * PER_FIELD, (6, F)).astype(np.int32)
    live = np.array([True, False, True, True]) if dead else None
    got = TE.banked_gather(tt, torch.from_numpy(rows), None,
                           bank_live=None if live is None
                           else torch.from_numpy(live))
    want = JE.banked_gather(jt, jnp.asarray(rows), None,
                            bank_live=None if live is None
                            else jnp.asarray(live))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(
        _np(TE.lookup_unsharded(tt, torch.from_numpy(rows),
                                reduce_bag=False)),
        _np(JE.lookup_unsharded(jt, jnp.asarray(rows), reduce_bag=False)))


def test_lookup_unsharded_matches_jax():
    jt, tt = _table(4, jnp.float32, seed=6)
    idx = _ids(4, 8, seed=6)
    fo = _offsets()
    np.testing.assert_array_equal(
        _np(TE.lookup_unsharded(tt, torch.from_numpy(idx), reduce_bag=True,
                                field_offsets=torch.from_numpy(fo))),
        _np(JE.lookup_unsharded(jt, jnp.asarray(idx), reduce_bag=True,
                                field_offsets=jnp.asarray(fo))))


def test_init_banked_layout():
    plan = non_uniform_partition(np.random.default_rng(0).random(300), 4)
    g = torch.Generator().manual_seed(0)
    t = TE.init_banked(plan, 8, generator=g, dtype=torch.bfloat16,
                       device="cpu")
    assert t.packed.shape == (4 * plan.max_rows_per_bank, 8)
    assert t.packed.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.remap_bank.numpy(), plan.bank_of_row)
    np.testing.assert_array_equal(t.remap_slot.numpy(), plan.slot_of_row)
    assert 0 < t.packed.float().std().item() < 0.02


def test_unported_options_raise():
    jt, tt = _table(1, jnp.float32)
    ids = _ids(2, 4)
    idx = torch.from_numpy(ids)
    with pytest.raises(TypeError, match="must be a DistCtx"):
        TE.banked_embedding_bag(tt, idx, object())
    # backend='tuned' is ported: on a miss it is 'auto'
    from repro_torch.tune.dispatch import DispatchCache, set_cache
    cache = DispatchCache()
    set_cache(cache)
    try:
        assert torch.equal(TE.banked_embedding_bag(tt, idx, backend="tuned"),
                           TE.banked_embedding_bag(tt, idx))
    finally:
        set_cache(None)
    assert cache.misses == 1 and cache.hits == 0
    # with_traffic is ported: the plain call's sums and the reference's
    # per-bank reads and bytes
    out, traffic = TE.banked_embedding_bag(tt, idx, with_traffic=True)
    assert torch.equal(out, TE.banked_embedding_bag(tt, idx))
    _, want = JE.banked_embedding_bag(jt, jnp.asarray(ids), None,
                                      backend="jnp", with_traffic=True)
    np.testing.assert_array_equal(traffic.reads.numpy(),
                                  np.asarray(want.reads))
    np.testing.assert_array_equal(traffic.nbytes.numpy(),
                                  np.asarray(want.nbytes))
    with pytest.raises(ValueError, match="backend must be one of"):
        TE.banked_embedding_bag(tt, idx, backend="pallas")


def test_cuda_backend_refuses_cpu_tensors():
    _, tt = _table(1, jnp.float32)
    idx = torch.from_numpy(_ids(2, 4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TE.banked_embedding_bag(tt, idx, backend="cuda",
                                field_offsets=torch.from_numpy(_offsets()))


def test_to_tensor_carries_bf16_bits():
    x = jnp.asarray(np.random.default_rng(0).standard_normal(33), jnp.bfloat16)
    t = to_tensor(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(x, np.float32))
