"""The port's ragged CSR lookup (``core/embedding.csr_embedding_bag``, the
CSR kernel's plain version, its gradient through the sorted-run scatter on
the CSR prep, its traffic counters and the host-side shard split) and
``sparse/ops`` against the JAX package's, on the CPU.

The same packed table (the reference's, carried across with
``repro_torch.convert``), the same flat id stream and the same bag starts
(numpy, from a seed) go through both packages. Tolerances:
- the port's ``backend='torch'`` is the CSR kernel's plain version: each
  bag in fp32 in stream order, cast once, which is the reference's Pallas
  kernel's order (run in interpret mode): equal bit for bit, fp32 and
  bf16. Against the reference's jnp path (``segment_sum``): bit for bit in
  fp32; in bf16 that path sums in bf16 and is held at atol 0.3, the
  reference's own bf16 bar;
- the gradient: each slot's cotangents added in fp32 in stream order and
  cast once on every path: equal bit for bit to both reference backends,
  fp32 and bf16;
- counters, seg ids, shard splits: integers, equal;
- ``sparse/ops``: each bag's rows added in the table's dtype, in stream
  order on both sides: equal in fp32; the rectangular and one-hot oracles
  sum in another order: within 1e-5 (fp32), and bf16 within 0.1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import embedding as JE
from repro.core.partitioning import non_uniform_partition
from repro.kernels import embedding_bag as JK
from repro.obs import traffic as JTF
from repro.sparse import ops as JOPS
from repro.workload import trace as JT
from repro_torch import core as TCORE
from repro_torch.convert import banked_table_from_jax, to_tensor
from repro_torch.core import embedding as TE
from repro_torch.kernels import embedding_bag as TK
from repro_torch.obs import traffic as TTF
from repro_torch.sparse import ops as TOPS

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]
DTYPE_IDS = ["float32", "bfloat16"]
# the trap: an empty bag mid-stream (5, 5) and a trailing empty bag (60)
TRAP = [0, 5, 5, 17, 30, 41, 55, 60, 60]


def _bits(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _carry(rng, v, d, banks, jdt):
    table = rng.standard_normal((v, d)).astype(np.float32)
    plan = non_uniform_partition(rng.random(v) + 0.1, banks)
    jt = JE.pack_table(table, plan, dtype=jdt)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), jt.n_banks,
                               jt.rows_per_bank, "cpu")
    return jt, tt


def _stream(rng, v, total, num_bags, offsets=None):
    """(indices, offsets) numpy int32: -1 holes, row 11 every 5th entry,
    random cuts unless ``offsets`` is given."""
    indices = rng.integers(-1, v, (total,)).astype(np.int32)
    indices[::5] = 11
    if offsets is None:
        cuts = np.sort(rng.choice(np.arange(1, total), num_bags - 1,
                                  replace=False)) if num_bags > 1 else []
        offsets = np.concatenate([[0], cuts])
    return indices, np.asarray(offsets, np.int32)


CASES = [(7, 41, None), (8, 8, None), (5, 60, None), (9, 60, TRAP[:-1] + [60])]
CASE_IDS = ["7x41", "8x8", "5x60", "trap"]


# ---------------------------------------------------------------------------
# segment ids
# ---------------------------------------------------------------------------

def test_segment_ids_skip_empty_bags_like_jax():
    off = np.asarray(TRAP, np.int32)
    want = np.asarray(JOPS.offsets_to_segment_ids(jnp.asarray(off), 60))
    got = TOPS.offsets_to_segment_ids(torch.from_numpy(off), 60)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 not in want and want[-1] == 6


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(0, 6), min_size=1, max_size=12),
       st.integers(0, 3))
def test_segment_ids_match_jax(lens, trailing_empty):
    """Any bag lengths (zeros are empty bags, mid-stream or trailing)."""
    lens = lens + [0] * trailing_empty
    off = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    total = int(sum(lens))
    want = np.asarray(JOPS.offsets_to_segment_ids(jnp.asarray(off), total))
    got = TOPS.offsets_to_segment_ids(torch.from_numpy(off), total)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the CSR lookup, forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_bags,total,offsets", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
def test_csr_forward_matches_jax(num_bags, total, offsets, dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(num_bags + total)
    jt, tt = _carry(rng, 64, 20, 4, jdt)
    indices, off = _stream(rng, 64, total, num_bags, offsets)
    ji, jo = jnp.asarray(indices), jnp.asarray(off)
    want_p = JE.csr_embedding_bag(jt, ji, jo, num_bags, None,
                                  backend="pallas", interpret=True)
    want_j = JE.csr_embedding_bag(jt, ji, jo, num_bags, None, backend="jnp")
    got = TE.csr_embedding_bag(tt, torch.from_numpy(indices),
                               torch.from_numpy(off), num_bags,
                               backend="torch")
    assert got.dtype == tdt and tuple(got.shape) == (num_bags, 20)
    np.testing.assert_array_equal(_bits(got), _bits(want_p))
    if tdt == torch.float32:
        np.testing.assert_array_equal(_bits(got), _bits(want_j))
    else:
        np.testing.assert_allclose(_bits(got), _bits(want_j), atol=0.3)
    # 'auto' on CPU tensors is the plain version, and the package exports it
    assert torch.equal(TCORE.csr_embedding_bag(
        tt, torch.from_numpy(indices), torch.from_numpy(off), num_bags), got)


@pytest.mark.parametrize("my", [-1, 2])
def test_csr_bag_plain_matches_pallas(my):
    """The plain version with an owned bank (``my = 2``) and without,
    against ``csr_bag_pallas`` in interpret mode on the flat remap."""
    rng = np.random.default_rng(9)
    jt, tt = _carry(rng, 64, 33, 4, jnp.float32)
    indices, off = _stream(rng, 64, 50, 8)
    off_ext = np.concatenate([off, [50]]).astype(np.int32)
    seg = JOPS.offsets_to_segment_ids(jnp.asarray(off), 50)
    want = JK.csr_bag_pallas(jt.packed, jt.remap_bank, jt.flat_remap(),
                             jnp.asarray([my], jnp.int32),
                             jnp.asarray(indices), seg, jnp.asarray(off_ext),
                             8, tile_b=8, interpret=True)
    got = TK.csr_bag_plain(tt.packed, tt.remap_bank, tt.remap_flat, my,
                           torch.from_numpy(indices),
                           torch.from_numpy(off_ext))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(TK.csr_bag(tt.packed, tt.remap_bank, tt.remap_flat, my,
                                  torch.from_numpy(indices),
                                  torch.from_numpy(off_ext)), got)


def test_csr_equals_the_rectangular_path_on_padded_bags():
    """The CSR sums equal ``banked_bag`` on the same bags padded with -1 to
    the longest: both fp32 in entry order, and padding adds +0."""
    rng = np.random.default_rng(4)
    _, tt = _carry(rng, 64, 16, 4, jnp.float32)
    indices, off = _stream(rng, 64, 60, 9, TRAP[:-1] + [60])
    ends = np.concatenate([off[1:], [60]])
    rect = np.full((9, int((ends - off).max())), -1, np.int32)
    for b in range(9):
        rect[b, :ends[b] - off[b]] = indices[off[b]:ends[b]]
    got = TE.csr_embedding_bag(tt, torch.from_numpy(indices),
                               torch.from_numpy(off), 9)
    zero = torch.zeros((1,), dtype=torch.int32)
    want = TK.banked_bag(tt.packed, tt.remap_bank, tt.remap_flat, zero, -1,
                         torch.from_numpy(rect))
    assert torch.equal(got, want)
    assert (got[1] == 0).all() and (got[8] == 0).all()    # empty bags


def test_csr_refuses_what_is_not_ported():
    rng = np.random.default_rng(0)
    _, tt = _carry(rng, 16, 4, 2, jnp.float32)
    idx, off = torch.zeros(4, dtype=torch.int32), torch.tensor([0, 2],
                                                               dtype=torch.int32)
    with pytest.raises(TypeError, match="must be a DistCtx"):
        TE.csr_embedding_bag(tt, idx, off, 2, object())
    # backend='tuned' is ported: on a miss it is 'auto'
    from repro_torch.tune.dispatch import DispatchCache, set_cache
    cache = DispatchCache()
    set_cache(cache)
    try:
        assert torch.equal(
            TE.csr_embedding_bag(tt, idx, off, 2, backend="tuned"),
            TE.csr_embedding_bag(tt, idx, off, 2))
    finally:
        set_cache(None)
    assert cache.misses == 1 and cache.hits == 0
    with pytest.raises(ValueError, match="CUDA tensors"):
        TE.csr_embedding_bag(tt, idx, off, 2, backend="cuda")
    with pytest.raises(ValueError, match="bag starts"):
        TE.csr_embedding_bag(tt, idx, off, 3)


# ---------------------------------------------------------------------------
# the CSR lookup, gradient and traffic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", [16, 33])
@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
def test_csr_gradient_matches_jax(d, dtypes):
    """``test_pallas_bwd_csr_sweep``'s case: d/dpacked of sum(out ** 2) by
    the port's plain scatter on the CSR prep against both reference
    backends."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(d + 300)
    jt, tt = _carry(rng, 64, d, 4, jdt)
    indices, off = _stream(rng, 64, 41, 7)
    ji, jo = jnp.asarray(indices), jnp.asarray(off)

    def loss(bwd, packed):
        t2 = dataclasses.replace(jt, packed=packed)
        return (JE.csr_embedding_bag(t2, ji, jo, 7, None, backend="pallas",
                                     bwd_backend=bwd,
                                     interpret=True) ** 2).sum()

    want_p = jax.grad(lambda p: loss("pallas", p))(jt.packed)
    want_j = jax.grad(lambda p: loss("jnp", p))(jt.packed)
    packed = tt.packed.clone().requires_grad_(True)
    out = TE.csr_embedding_bag(dataclasses.replace(tt, packed=packed),
                               torch.from_numpy(indices),
                               torch.from_numpy(off), 7, backend="torch",
                               bwd_backend="torch")
    (got,) = torch.autograd.grad((out ** 2).sum(), [packed])
    assert got.dtype == tdt and got.shape == tt.packed.shape
    np.testing.assert_array_equal(_bits(got), _bits(want_p))
    np.testing.assert_array_equal(_bits(got), _bits(want_j))
    hot = int(tt.remap_flat[11])
    assert (got[hot] != 0).any()


@pytest.mark.parametrize("my", [-1, 1])
def test_csr_prep_matches_jax_run_metadata(my):
    """The CSR prep's runs are the reference's ``scatter_run_metadata`` on
    ``_dest_slots`` labels with ``seg`` as the bag."""
    rng = np.random.default_rng(6)
    jt, tt = _carry(rng, 64, 8, 4, jnp.float32)
    indices, off = _stream(rng, 64, 41, 7)
    seg = JOPS.offsets_to_segment_ids(jnp.asarray(off), 41)
    n_rows = jt.packed.shape[0]
    ji = jnp.asarray(indices)
    dest = JK._dest_slots(jnp.where(ji >= 0, ji, 0), ji >= 0, jt.remap_bank,
                          jt.flat_remap(), jnp.asarray([my], jnp.int32),
                          n_rows)
    bag_sorted, run_of, run_starts, run_slot, n_run = JK.scatter_run_metadata(
        dest, seg, n_rows, 41)
    runs = TK.csr_scatter_prep(torch.from_numpy(indices),
                               TOPS.offsets_to_segment_ids(
                                   torch.from_numpy(off), 41),
                               tt.remap_bank, tt.remap_flat, my, n_rows)
    want = (bag_sorted, run_starts, run_slot, n_run, run_of)
    assert len(runs) == len(want)
    for got, w in zip(runs, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_csr_traffic_matches_jax_and_host():
    rng = np.random.default_rng(3)
    jt, tt = _carry(rng, 64, 8, 4, jnp.float32)
    indices, off = _stream(rng, 64, 60, 9, TRAP[:-1] + [60])
    out_j, traffic_j = JE.csr_embedding_bag(
        jt, jnp.asarray(indices), jnp.asarray(off), 9, None,
        backend="pallas", interpret=True, with_traffic=True)
    out_t, traffic_t = TE.csr_embedding_bag(
        tt, torch.from_numpy(indices), torch.from_numpy(off), 9,
        with_traffic=True)
    np.testing.assert_array_equal(_bits(out_t), _bits(out_j))
    for got, want in zip(traffic_t, traffic_j):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    host = TTF.host_bank_read_counts(np.asarray(jt.remap_bank), indices, 4)
    np.testing.assert_array_equal(traffic_t.reads.numpy(), host)
    np.testing.assert_array_equal(
        host, JTF.host_bank_read_counts(np.asarray(jt.remap_bank), indices, 4))
    assert int(traffic_t.reads.sum()) == int((indices >= 0).sum())
    assert int(traffic_t.nbytes.sum()) == int((indices >= 0).sum()) * 8 * 4


# ---------------------------------------------------------------------------
# the slice as a whole: ragged requests of the reduced updlrm-paper shape
# ---------------------------------------------------------------------------

def test_csr_slice_matches_jax_on_drifting_requests():
    """The phase-8 path at the reduced size: 8 fields x 500 rows, D = 8,
    a Zipf(1.05) trace per field (bags of 16 on average, drift off),
    request-major bags offset into the super-table; forward and gradient
    of the port (plain versions) against the reference's Pallas path in
    interpret mode, bit for bit."""
    F, per, D, requests = 8, 500, 8, 4
    rng = np.random.default_rng(12)
    jt, tt = _carry(rng, F * per, D, 8, jnp.float32)
    traces = [JT.DriftingZipfTrace(JT.DriftConfig(
        n_items=per, zipf_a=1.05, avg_bag=16.0), seed=f) for f in range(F)]
    per_field = [tr.bags(requests) for tr in traces]
    bags = [per_field[f][r] + f * per for r in range(requests)
            for f in range(F)]
    indices = np.concatenate(bags).astype(np.int32)
    off = np.concatenate([[0], np.cumsum([len(b) for b in bags])[:-1]]
                         ).astype(np.int32)
    nb = requests * F
    cot = rng.standard_normal((nb, D)).astype(np.float32)

    def loss(packed):
        t2 = dataclasses.replace(jt, packed=packed)
        out = JE.csr_embedding_bag(t2, jnp.asarray(indices), jnp.asarray(off),
                                   nb, None, backend="pallas",
                                   bwd_backend="pallas", interpret=True)
        return (out * jnp.asarray(cot)).sum(), out

    (_, want), want_g = jax.value_and_grad(loss, has_aux=True)(jt.packed)
    packed = tt.packed.clone().requires_grad_(True)
    out = TE.csr_embedding_bag(dataclasses.replace(tt, packed=packed),
                               torch.from_numpy(indices),
                               torch.from_numpy(off), nb)
    (got_g,) = torch.autograd.grad(out, [packed], torch.from_numpy(cot))
    np.testing.assert_array_equal(_bits(out), _bits(want))
    np.testing.assert_array_equal(_bits(got_g), _bits(want_g))
    assert int((got_g != 0).any(dim=1).sum()) > 0


# ---------------------------------------------------------------------------
# host-side shard split
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("seed", [0, 1])
def test_balanced_csr_shards_and_shard_batch_match_jax(n_shards, seed):
    rng = np.random.default_rng(seed)
    lens = rng.poisson(6, 23)
    lens[[3, 4, 22]] = 0                               # empty bags
    offsets = np.concatenate([[0], np.cumsum(lens)])
    indices = rng.integers(-1, 100, int(offsets[-1])).astype(np.int32)
    np.testing.assert_array_equal(TE.balanced_csr_shards(offsets, n_shards),
                                  JE.balanced_csr_shards(offsets, n_shards))
    want = JE.shard_csr_batch(indices, offsets, n_shards)
    got = TE.shard_csr_batch(indices, offsets, n_shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# sparse/ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("num_bags,total,offsets", CASES, ids=CASE_IDS)
def test_sparse_embedding_bag_matches_jax(combiner, num_bags, total,
                                          offsets):
    rng = np.random.default_rng(total)
    table = rng.standard_normal((64, 12)).astype(np.float32)
    indices, off = _stream(rng, 64, total, num_bags, offsets)
    want = JOPS.embedding_bag(jnp.asarray(table), jnp.asarray(indices),
                              jnp.asarray(off), num_bags=num_bags,
                              combiner=combiner)
    got = TOPS.embedding_bag(torch.from_numpy(table),
                             torch.from_numpy(indices), torch.from_numpy(off),
                             num_bags=num_bags, combiner=combiner)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("combiner", ["sum", "mean"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=DTYPE_IDS)
def test_sparse_fixed_and_onehot_match_jax(combiner, dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(8)
    table = jnp.asarray(rng.standard_normal((30, 10)), jdt)
    idx = rng.integers(-1, 30, (7, 6)).astype(np.int32)
    idx[2] = -1
    t = to_tensor(np.asarray(table), "cpu")
    tol = dict(rtol=1e-5, atol=1e-5) if tdt == torch.float32 else \
        dict(rtol=0, atol=0.1)
    got = TOPS.embedding_bag_fixed(t, torch.from_numpy(idx),
                                   combiner=combiner)
    want = JOPS.embedding_bag_fixed(table, jnp.asarray(idx),
                                    combiner=combiner)
    assert got.dtype == tdt
    np.testing.assert_allclose(_bits(got), _bits(want), **tol)
    if combiner == "sum":
        got_o = TOPS.embedding_bag_onehot(t, torch.from_numpy(idx))
        want_o = JOPS.embedding_bag_onehot(table, jnp.asarray(idx))
        np.testing.assert_allclose(_bits(got_o), _bits(want_o), **tol)
        np.testing.assert_allclose(_bits(got_o), _bits(got), **tol)
