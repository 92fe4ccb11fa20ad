"""The ragged CSR bag (``csrc/csr_bag.cu``, row 5 of the kernel table)
around its resolve-once ring, on the CPU.

- The plain version ``csr_bag_plain``, which the kernel is held to bit for
  bit on the card, equals the reference's ``csr_bag_pallas`` in interpret
  mode bit for bit, fp32 and bf16, on ranges shaped against the ring: bags
  of 0, 1, 255, 256, 257, 1,000 and 5,000 entries (up to ten rounds),
  holes, an owned bank and a dead bank, trailing empty bags. The reference
  asserts ``num_bags % 8 == 0``, so the batch is padded with empty bags.
  On CPU tensors the wrapper is the plain version and counts no launch.
- Offsets outside ``[0, T]`` and ``T = 0``: clamped as the kernel clamps
  them, the sums equal those of the clamped ranges summed in numpy.
- The launch geometry (``kernels/embedding_bag.ring_geometry`` at the mean
  bag length, from shapes only), which the kernel takes as it is: within a
  block's shared memory on an H100, at least one ring stage, and a walk
  (``_ring_walk``, the kernel's rounds, compaction and ring stages) that
  adds every live entry of every bag's range exactly once, in stream
  order.
Nothing here needs the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE
from repro.core.partitioning import non_uniform_partition
from repro.kernels import embedding_bag as JK
from repro.sparse import ops as JOPS
from repro_torch.convert import banked_table_from_jax
from repro_torch.core import embedding as TE
from repro_torch.kernels import embedding_bag as TK
from test_torch_cache_ring import _ring_walk

LENS = (0, 1, 255, 256, 257, 1000, 5000)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _carry(rng, v, d, jdt):
    plan = non_uniform_partition(rng.random(v) + 0.1, 4)
    jt = JE.pack_table(rng.standard_normal((v, d)).astype(np.float32), plan,
                       dtype=jdt)
    tt = banked_table_from_jax(np.asarray(jt.packed), np.asarray(jt.remap_bank),
                               np.asarray(jt.remap_slot), jt.n_banks,
                               jt.rows_per_bank, "cpu")
    return jt, tt


def _stream(rng, v, lens, p_hole=0.1):
    """(indices, offsets_ext) numpy int32 for bags of ``lens`` entries in
    order, 10% holes, padded with empty bags to a multiple of 8."""
    lens = list(lens) + [0] * (-len(lens) % 8)
    indices = rng.integers(0, v, (sum(lens),)).astype(np.int32)
    indices[rng.random(indices.shape) < p_hole] = -1
    return indices, np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


# (D, dtype, my, dead bank)
CASES = [(8, "float32", -1, None), (9, "bfloat16", 2, None),
         (33, "float32", 0, 1), (3, "bfloat16", -1, None)]


@pytest.mark.parametrize("d,dtype,my,dead", CASES)
def test_csr_plain_matches_pallas_interpret(d, dtype, my, dead):
    """Bags of every length of ``LENS`` (twice, in two orders), an empty
    bag mid-stream and trailing empty bags: ``csr_bag_plain`` ==
    ``csr_bag_pallas`` (interpret) bit for bit."""
    rng = np.random.default_rng(d)
    jt, tt = _carry(rng, 400, d, getattr(jnp, dtype))
    lens = LENS + (3,) + LENS[::-1] + (0, 0)
    indices, off_ext = _stream(rng, 400, lens)
    jbank, tbank = jt.remap_bank, tt.remap_bank
    if dead is not None:
        live = np.ones(4, bool)
        live[dead] = False
        jbank = JE._binary_live_map(jt.remap_bank, jnp.asarray(live))
        tbank = TE._binary_live_map(tt.remap_bank, torch.from_numpy(live))
    nb = off_ext.shape[0] - 1
    seg = JOPS.offsets_to_segment_ids(jnp.asarray(off_ext[:-1]),
                                      indices.shape[0])
    want = JK.csr_bag_pallas(jt.packed, jbank, jt.flat_remap(),
                             jnp.asarray([my], jnp.int32),
                             jnp.asarray(indices), seg, jnp.asarray(off_ext),
                             nb, tile_b=8, interpret=True)
    args = (tt.packed, tbank, tt.remap_flat, my, torch.from_numpy(indices),
            torch.from_numpy(off_ext))
    got = TK.csr_bag_plain(*args)
    assert got.dtype == getattr(torch, dtype) and got.shape == (nb, d)
    np.testing.assert_array_equal(_np(got), _np(want))
    n = TK.csr_bag.launches
    assert torch.equal(TK.csr_bag(*args), got)
    assert TK.csr_bag.launches == n
    assert not got[0].any() and not got[-2:].any()


def _numpy_csr(table, slot, indices, off_ext):
    """Each bag's clamped range summed in fp32 in stream order, in numpy."""
    T = indices.shape[0]
    o = np.clip(off_ext.astype(np.int64), 0, T)
    out = np.zeros((o.shape[0] - 1, table.shape[1]), np.float32)
    for b in range(out.shape[0]):
        for e in range(o[b], max(o[b + 1], o[b])):
            if indices[e] >= 0:
                out[b] += table[slot[indices[e]]]
    return out


@pytest.mark.parametrize("offsets", [
    [-5, 3, 2, 40, 70, 70, 1000],       # below 0, decreasing, past T
    [0, 10, -1, 20, 50],                # a negative end mid-stream
    [60, 60, 60],                       # every bag at T: all empty
    [0, 0, 0, 0],                       # T = 0
])
def test_offsets_are_clamped_into_the_stream(offsets):
    """Offsets outside [0, T] (T = 60, or 0 in the last case) are clamped,
    with end >= begin, by the plain version as by the kernel: the sums are
    those of the clamped ranges."""
    rng = np.random.default_rng(7)
    table = rng.standard_normal((50, 5)).astype(np.float32)
    slot = rng.permutation(50).astype(np.int32)
    T = 0 if offsets == [0, 0, 0, 0] else 60
    indices = rng.integers(-1, 50, (T,)).astype(np.int32)
    off_ext = np.asarray(offsets, np.int32)
    got = TK.csr_bag(torch.from_numpy(table), torch.zeros(50, dtype=torch.int32),
                     torch.from_numpy(slot), -1, torch.from_numpy(indices),
                     torch.from_numpy(off_ext))
    np.testing.assert_array_equal(
        got.numpy(), _numpy_csr(table, slot, indices, off_ext))


# (NB, bag lengths): the CSR path (512 Poisson(256) bags), the adversarial
# lengths, trailing empty bags, more bags than the card holds at once, one
# 5,000-entry bag, T = 0
def _shapes():
    rng = np.random.default_rng(11)
    return {"csr path": rng.poisson(256, 512),
            "adversarial": np.array(LENS * 6 + (0, 0, 0)),
            "4301 short bags": rng.integers(0, 66, 4301),
            "one long bag": np.array([5000]),
            "T = 0": np.zeros(8, np.int64)}


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_fits_and_the_walk_adds_every_entry_once(itemsize):
    """Over D = 1..300 and every shape: shared memory within a block's,
    1..8 stages, a copy unit that divides the row stride; and the ring's
    walk (at each depth the geometry picks) adds every live entry of a
    bag's range exactly once, in stream order."""
    for name, lens in _shapes().items():
        rng = np.random.default_rng(len(lens))
        nb, T = lens.shape[0], int(lens.sum())
        offs = np.concatenate([[0], np.cumsum(lens)])
        live = rng.random(T) < 0.9
        seen = set()
        for dim in range(1, 301):
            g = TK.ring_geometry(nb, -(-T // nb), dim, itemsize, 0)
            assert g.smem_bytes <= TK.BLOCK_SMEM
            assert 1 <= g.stages <= TK.MAX_STAGES
            assert g.bags_per_block in (1, 2)
            assert g.blocks * g.bags_per_block >= nb
            assert g.smem_bytes == g.bags_per_block * (
                TK.LIST_BYTES + g.stages * TK.STAGE_ROWS * g.row_bytes)
            assert (dim * itemsize) % g.vec == 0 and g.vec >= itemsize
            if g.stages in seen:
                continue
            seen.add(g.stages)
            longest = int(np.argmax(lens))
            for b in sorted({0, 1, longest, nb - 1} & set(range(nb))):
                mask = live[offs[b]:offs[b + 1]]
                want = [(int(p), "emt") for p in np.flatnonzero(mask)]
                assert _ring_walk(mask, 0, g.stages) == want, (name, b)


def test_csr_path_shape_keeps_the_bag_in_flight():
    """At the CSR path's shape (512 bags, 131,500 entries, D = 32 fp32): one
    bag a block, 8 stages, 16-byte copies, four blocks an SM within its
    shared memory; the stage count from T / NB alone."""
    g = TK.ring_geometry(512, -(-131_500 // 512), 32, 4, 0)
    assert (g.blocks, g.bags_per_block, g.stages, g.vec) == (512, 1, 8, 16)
    per_sm = -(-g.blocks // TK.SM_COUNT)
    assert per_sm * (g.smem_bytes + TK.BLOCK_RESERVED) <= TK.SM_SMEM
    # short bags: a shallower ring
    assert TK.ring_geometry(512, 40, 32, 4, 0).stages == 2
