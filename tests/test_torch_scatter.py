"""The port's bag-sum backward (the sorted-run scatter) against the JAX
package's, on the CPU.

The same packed table (the reference's, carried across with
``repro_torch.convert``), the same -1 padded ids and the same cotangent
rows (numpy, from a seed) go through the port's ``ct_scatter_bag`` and its
prep, and through the reference's XLA scan ``_scatter_bag_ct`` and its
Pallas kernel ``ct_scatter_bag_pallas`` in interpret mode. Every path adds
the cotangents of one slot in fp32 in entry order (j-major, then by bag)
and casts once, so the gradients must agree bit for bit
(``assert_array_equal``), in fp32 and in bf16 alike: bf16 changes only the
final cast, which is the same round-to-nearest on every path.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE
from repro.core.partitioning import non_uniform_partition, uniform_partition
from repro.kernels import embedding_bag as JK
from repro_torch.convert import banked_table_from_jax
from repro_torch.core import embedding as TE
from repro_torch.kernels import embedding_bag as TK

F, PER_FIELD, D = 8, 500, 8


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32))


def _carry(table, plan, dtype):
    jt = JE.pack_table(table, plan, dtype=dtype)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), jt.n_banks,
                               jt.rows_per_bank, "cpu")
    return jt, tt


def _reduced(dtype, n_banks=4, seed=0):
    """The reduced updlrm-paper shape: 8 fields x 500 rows, D = 8."""
    rng = np.random.default_rng(seed)
    v = F * PER_FIELD
    table = rng.standard_normal((v, D)).astype(np.float32)
    plan = non_uniform_partition(rng.random(v) + 0.1, n_banks)
    return _carry(table, plan, dtype)


def _ids(b, l, seed=1):
    """(b * F, l) per-field ids: interior holes, short bags, one all-pad
    bag, and a hot id repeated inside and across bags."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, PER_FIELD, (b, F, l)).astype(np.int32)
    idx[rng.random(idx.shape) < 0.2] = -1
    lens = rng.integers(0, l + 1, (b, F))
    idx[np.arange(l)[None, None, :] >= lens[..., None]] = -1
    idx[:, :, 0] = 7                       # cross-bag duplicates
    idx[1, 2, 1:5] = 7                     # in-bag duplicates
    idx[0, 3] = -1                         # an all-pad bag
    return idx.reshape(-1, l)


def _offsets():
    return np.arange(F, dtype=np.int32) * PER_FIELD


def _remaps(jt, tt, my, dead):
    """(bank, slot, my) for the reference and the port: the flat remap, and
    either the real bank map or, with a dead bank, the binary live map with
    my = 0 (the single-device degraded path)."""
    j_slot, t_slot = jt.flat_remap(), tt.remap_flat
    if dead is None:
        return (jt.remap_bank, j_slot, my), (tt.remap_bank, t_slot, my)
    live = np.ones(jt.n_banks, bool)
    live[dead] = False
    j_bank = JE._binary_live_map(jt.remap_bank, jnp.asarray(live))
    t_bank = TE._binary_live_map(tt.remap_bank, torch.from_numpy(live))
    return (j_bank, j_slot, 0), (t_bank, t_slot, 0)


CASES = [(-1, None), (0, None), (2, None), (-1, 1)]   # (my, dead bank)


@pytest.mark.parametrize("my,dead", CASES)
def test_prep_matches_jax_scatter_run_metadata(my, dead):
    """Entry enumeration, destination slots and the five run arrays."""
    jt, tt = _reduced(jnp.float32)
    idx = _ids(4, 16)
    NB, L = idx.shape
    n_rows = jt.packed.shape[0]
    (jb, js, jmy), (tb, ts, tmy) = _remaps(jt, tt, my, dead)
    fo = _offsets()
    # the reference's enumeration, as ct_scatter_bag_pallas writes it
    e = jnp.arange(NB * L, dtype=jnp.int32)
    bag, j = e % NB, e // NB
    raw = jnp.asarray(idx).reshape(-1)[bag * L + j]
    valid = raw >= 0
    row = jnp.where(valid, raw + jnp.asarray(fo)[bag % F], 0)
    j_dest = JK._dest_slots(row, valid, jb, js,
                            jnp.asarray([jmy], jnp.int32), n_rows)
    t_dest, t_bags = TK.scatter_entries(torch.from_numpy(idx), tb, ts,
                                        torch.from_numpy(fo), tmy, n_rows)
    np.testing.assert_array_equal(t_dest.numpy(), np.asarray(j_dest))
    np.testing.assert_array_equal(t_bags.numpy(), np.asarray(bag))
    n_pad = -(-NB * L // 8) * 8 + 8
    want = JK.scatter_run_metadata(j_dest, bag, n_rows, n_pad)
    got = TK.scatter_run_metadata(t_dest, t_bags, n_rows, n_pad)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[4][0]) < NB * L       # collisions merged some runs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("my,dead", CASES)
def test_scatter_matches_jax_scan_and_pallas(dtype, my, dead):
    jt, tt = _reduced(getattr(jnp, dtype), seed=2)
    idx = _ids(6, 16, seed=3)
    n_rows = jt.packed.shape[0]
    ct = np.random.default_rng(4).standard_normal(
        (idx.shape[0], D)).astype(np.float32)
    (jb, js, jmy), (tb, ts, tmy) = _remaps(jt, tt, my, dead)
    fo = _offsets()
    j_ct = jnp.asarray(ct, getattr(jnp, dtype))
    t_ct = torch.from_numpy(ct).to(getattr(torch, dtype))
    want_scan = JE._scatter_bag_ct(jt.packed.shape, jt.packed.dtype, jb, js,
                                   jnp.int32(jmy), jnp.asarray(idx), j_ct,
                                   off=jnp.asarray(fo))
    want_pallas = JK.ct_scatter_bag_pallas(
        j_ct, jnp.asarray(idx), jb, js, jnp.asarray(fo),
        jnp.asarray([jmy], jnp.int32), n_rows, jt.packed.dtype, tile_s=8,
        interpret=True)
    args = (t_ct, torch.from_numpy(idx), tb, ts, torch.from_numpy(fo), tmy,
            n_rows)
    got = TK.ct_scatter_bag_plain(*args)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (n_rows, D)
    np.testing.assert_array_equal(_np(got), _np(want_scan))
    np.testing.assert_array_equal(_np(got), _np(want_pallas))
    # on CPU tensors the wrapper takes the plain version
    np.testing.assert_array_equal(_np(TK.ct_scatter_bag(*args)), _np(got))
    hot = int(np.asarray(jt.flat_remap())[7])
    if dead is None and (my < 0 or int(jt.remap_bank[7]) == my):
        assert np.abs(_np(got)[hot]).sum() > 0


@pytest.mark.parametrize("d", [16, 33, 128])          # incl. odd D
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rect_sweep_grad_matches_jax(d, dtype):
    """The reference's rectangular multi-field backward sweep
    (``test_pallas_bwd_rect_sweep``): the port's autograd gradient of a
    loss on the bag sums equals the reference's custom_vjp gradient with
    the Pallas scatter and with the XLA scan."""
    rng = np.random.default_rng(d + 100)
    vocab_sizes = (40, 30, 30)
    v = sum(vocab_sizes)
    offs = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]]).astype(np.int32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    plan = non_uniform_partition(rng.random(v) + 0.1, 4)
    jt, tt = _carry(table, plan, getattr(jnp, dtype))
    idx = np.full((9, 3, 5), -1, np.int32)
    for b in range(9):
        for f in range(3):
            n = rng.integers(0, 6)
            idx[b, f, :n] = rng.integers(0, vocab_sizes[f], n)

    def jloss(bwd, packed):
        t2 = dataclasses.replace(jt, packed=packed)
        return (JE.banked_embedding_bag(t2, jnp.asarray(idx), None,
                                        backend="pallas", bwd_backend=bwd,
                                        field_offsets=offs) ** 2).sum()

    packed = tt.packed.clone().requires_grad_(True)
    t2 = dataclasses.replace(tt, packed=packed)
    out = TE.banked_embedding_bag(t2, torch.from_numpy(idx),
                                  field_offsets=torch.from_numpy(offs))
    (got,) = torch.autograd.grad((out.float() ** 2).sum().to(out.dtype),
                                 [packed])
    for bwd in ("pallas", "jnp"):
        want = jax.grad(lambda p: jloss(bwd, p))(jt.packed)
        np.testing.assert_array_equal(_np(got), _np(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_collisions_in_tile_grad_matches_jax(dtype):
    """The reference's collision case (``test_pallas_bwd_collisions_in_
    tile``): one row hit by every bag and three more times inside bag 0,
    plus an interior hole, on a 2-bank table with no field offsets."""
    rng = np.random.default_rng(5)
    v, d, b, l = 24, 16, 8, 6
    table = rng.standard_normal((v, d)).astype(np.float32)
    jt, tt = _carry(table, non_uniform_partition(rng.random(v) + 0.1, 2),
                    getattr(jnp, dtype))
    idx = np.asarray(rng.integers(0, v, (b, l)), np.int32)
    idx[:, 0] = 3
    idx[0, 1:4] = 3
    idx[2, 2] = -1
    ct = rng.standard_normal((b, d)).astype(np.float32)

    def jbag(packed):
        t2 = dataclasses.replace(jt, packed=packed)
        return JE.banked_embedding_bag(t2, jnp.asarray(idx), None,
                                       backend="pallas", bwd_backend="pallas")

    _, vjp = jax.vjp(jbag, jt.packed)
    (want,) = vjp(jnp.asarray(ct, getattr(jnp, dtype)))
    packed = tt.packed.clone().requires_grad_(True)
    out = TE.banked_embedding_bag(dataclasses.replace(tt, packed=packed),
                                  torch.from_numpy(idx))
    (got,) = torch.autograd.grad(
        out, [packed], torch.from_numpy(ct).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(_np(got), _np(want))
    hot = int(np.asarray(jt.flat_remap())[3])
    assert np.abs(_np(got)[hot]).sum() > 0


@pytest.mark.parametrize("bwd_backend", ["auto", "torch"])
@pytest.mark.parametrize("fwd_backend", ["auto", "torch"])
def test_backend_pairs_give_one_gradient(fwd_backend, bwd_backend):
    """Every CPU backend pair, with a dead bank: the same gradient as the
    reference's XLA scan through the binary live map; 'cuda' refuses CPU
    tensors."""
    jt, tt = _reduced(jnp.float32, seed=6)
    idx = _ids(3, 16, seed=7).reshape(3, F, 16)
    fo = _offsets()
    live = np.array([True, True, False, True])
    ct = np.random.default_rng(8).standard_normal((3, F, D)).astype(np.float32)
    packed = tt.packed.clone().requires_grad_(True)
    out = TE.banked_embedding_bag(
        dataclasses.replace(tt, packed=packed), torch.from_numpy(idx),
        backend=fwd_backend, bwd_backend=bwd_backend,
        field_offsets=torch.from_numpy(fo), bank_live=torch.from_numpy(live))
    assert out.grad_fn is not None
    (got,) = torch.autograd.grad(out, [packed], torch.from_numpy(ct))
    want = JE._scatter_bag_ct(
        jt.packed.shape, jt.packed.dtype,
        JE._binary_live_map(jt.remap_bank, jnp.asarray(live)),
        jt.flat_remap(), jnp.int32(0), jnp.asarray(idx), jnp.asarray(ct),
        off=jnp.asarray(fo))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TE.banked_embedding_bag(tt, torch.from_numpy(idx),
                                bwd_backend="cuda",
                                field_offsets=torch.from_numpy(fo))
    with pytest.raises(ValueError, match="bwd_backend must be one of"):
        TE.banked_embedding_bag(tt, torch.from_numpy(idx),
                                bwd_backend="pallas")


def test_hot_row_sums_in_fp32_under_bf16():
    """300 hits of cotangent 1.0 on one bf16 row give exactly 300 (a bf16
    accumulator would stall near 256), as the reference's
    ``test_bf16_table_grads_accumulate_fp32`` holds."""
    table = np.random.default_rng(0).standard_normal((16, 8)).astype(
        np.float32)
    _, tt = _carry(table, uniform_partition(16, 2), jnp.bfloat16)
    idx = torch.zeros((25, 12), dtype=torch.int32)
    packed = tt.packed.clone().requires_grad_(True)
    out = TE.banked_embedding_bag(dataclasses.replace(tt, packed=packed), idx)
    (g,) = torch.autograd.grad(out.sum(), [packed])
    hot = int(tt.remap_flat[0])
    np.testing.assert_array_equal(_np(g)[hot], np.full(8, 300, np.float32))
    assert int((g != 0).any(dim=1).sum()) == 1


def test_runs_plain_walks_long_runs_in_order():
    """A run longer than any other, and runs of every length between: the
    rank-by-rank walk adds each run's entries in sorted (entry) order, so
    it equals a sequential fp32 sum per slot."""
    rng = np.random.default_rng(9)
    n_rows, NB = 50, 40
    dest = rng.integers(0, n_rows + 3, 500).astype(np.int32)  # some sentinel
    dest[dest > n_rows] = n_rows
    dest[::3] = 11                                            # a long run
    bags = rng.integers(0, NB, 500).astype(np.int32)
    ct = rng.standard_normal((NB, 5)).astype(np.float32)
    meta = TK.scatter_run_metadata(torch.from_numpy(dest),
                                   torch.from_numpy(bags), n_rows, 500)
    runs = TK.ScatterRuns(meta[0], meta[2], meta[3], meta[4])
    got = TK.ct_scatter_runs_plain(torch.from_numpy(ct), runs,
                                   torch.zeros((n_rows, 5)))
    want = np.zeros((n_rows, 5), np.float32)
    for e in range(500):                       # entry order, fp32 per slot
        if dest[e] < n_rows:
            want[dest[e]] = (want[dest[e]] + ct[bags[e]]).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ct_dtype,out_dtype", [("float32", "bfloat16"),
                                                ("bfloat16", "float32")])
def test_scatter_dtype_mix_matches_jax_pallas(ct_dtype, out_dtype):
    """An fp32 cotangent scattered onto a bf16 table, and the reverse (the
    fused cache+residual backward sends the EMT's cotangent onto a cache
    table of its own dtype): ``ct`` summed in fp32 as it is and cast once
    to the table's dtype, bit for bit against the reference's Pallas
    scatter in interpret mode with the same two dtypes (its ``ct`` and
    ``out`` scratch are typed apart). On CPU tensors the wrapper gives the
    plain version's bits."""
    jt, tt = _reduced(getattr(jnp, out_dtype), seed=10)
    idx = _ids(4, 16, seed=11)
    n_rows = jt.packed.shape[0]
    ct = np.random.default_rng(12).standard_normal(
        (idx.shape[0], D)).astype(np.float32)
    j_ct = jnp.asarray(ct, getattr(jnp, ct_dtype))
    t_ct = torch.from_numpy(ct).to(getattr(torch, ct_dtype))
    fo = _offsets()
    for my in (-1, 2):
        want = JK.ct_scatter_bag_pallas(
            j_ct, jnp.asarray(idx), jt.remap_bank, jt.flat_remap(),
            jnp.asarray(fo), jnp.asarray([my], jnp.int32), n_rows,
            getattr(jnp, out_dtype), tile_s=8, interpret=True)
        args = (t_ct, torch.from_numpy(idx), tt.remap_bank, tt.remap_flat,
                torch.from_numpy(fo), my, n_rows, getattr(torch, out_dtype))
        got = TK.ct_scatter_bag_plain(*args)
        assert got.dtype == getattr(torch, out_dtype)
        np.testing.assert_array_equal(_np(got), _np(want))
        np.testing.assert_array_equal(_np(TK.ct_scatter_bag(*args)), _np(got))
    if ct_dtype == "float32":
        # a cast of ct before the sum rounds every addend: other bits
        pre = TK.ct_scatter_bag_plain(t_ct.to(torch.bfloat16), *args[1:])
        assert not np.array_equal(_np(pre), _np(got))
