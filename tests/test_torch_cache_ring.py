"""The fused cache + residual bag (``csrc/cache_bag.cu``, rows 4 and 8 of
the kernel table) around its resolve-once ring, on the CPU.

- The plain versions ``cache_residual_bag_plain`` and
  ``plain_cache_bag_plain``, which the kernel's two instances are held to
  bit for bit on the card, equal the reference's ``fused_cache_bag_pallas``
  and ``plain_cache_bag_pallas`` in interpret mode bit for bit, fp32 and
  bf16, on streams shaped against the ring: live lists of 0, 1, 255, 256,
  257 and more than 512 entries (a second round), live entries in one
  stream only, every entry padding, interior holes. The reference asserts
  ``B % 8 == 0``, so a batch is padded with all-padding bags. On CPU
  tensors the wrappers are these plain versions and count no launch.
- The launch geometry (``kernels/embedding_bag.ring_geometry``), which the
  kernel takes as it is: within a block's shared memory on an H100, at
  least one ring stage, and a walk (the kernel's rounds, compaction, ring
  stages and column passes, mirrored in ``_ring_walk``) that adds every
  live entry of both streams exactly once, in order, each from its own
  table.
Nothing here needs the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.kernels import embedding_bag as JK
from repro_torch.convert import banked_table_from_jax
from repro_torch.core import embedding as TE
from repro_torch.kernels import embedding_bag as TK


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ring_walk(live, n_cache, stages):
    """The entries of one bag's streams laid end to end (``live``, a bool
    per entry; the first ``n_cache`` are cache entries) in the order the
    kernel adds them, each with the table it is read from: rounds of
    ``ROUND`` entries; a round's live entries compacted in order, the first
    ``nc`` of them cache entries; the list streamed in stages of 32 rows
    through ``stages`` ring buffers, stage t issued stages - 1 steps before
    it is added and a buffer refilled only after it was added."""
    added, ring = [], [None] * stages
    b_issue = b_add = 0
    for r0 in range(0, len(live), TK.ROUND):
        lst = [p for p in range(r0, min(r0 + TK.ROUND, len(live))) if live[p]]
        nc = sum(p < n_cache for p in lst)
        n_st = -(-len(lst) // TK.STAGE_ROWS)
        for t in range(n_st + stages - 1 if n_st else 0):
            if t < n_st:
                assert ring[b_issue] is None, "a buffer refilled before added"
                rows = range(t * TK.STAGE_ROWS,
                             min(len(lst), (t + 1) * TK.STAGE_ROWS))
                ring[b_issue] = [(lst[i], "cache" if i < nc else "emt")
                                 for i in rows]
                b_issue = (b_issue + 1) % stages
            if t >= stages - 1:
                assert ring[b_add] is not None, "a stage added before issued"
                added.extend(ring[b_add])
                ring[b_add] = None
                b_add = (b_add + 1) % stages
    assert all(b is None for b in ring)
    return added


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernels in interpret mode
# ---------------------------------------------------------------------------

def _tables(d, dtype, seed, v=300, nc=24):
    """A 4-bank EMT (a §3.2 plan) and a 2-bank cache table, packed by the
    reference and carried across."""
    rng = np.random.default_rng(seed)
    jt = JE.pack_table(rng.standard_normal((v, d)).astype(np.float32),
                       JP.non_uniform_partition(rng.random(v) + 0.1, 4),
                       dtype=getattr(jnp, dtype))
    jc = JE.pack_table(rng.standard_normal((nc, d)).astype(np.float32),
                       JP.uniform_partition(nc, 2), dtype=getattr(jnp, dtype))
    carry = [banked_table_from_jax(np.asarray(x.packed),
                                   np.asarray(x.remap_bank),
                                   np.asarray(x.remap_slot), x.n_banks,
                                   x.rows_per_bank, "cpu") for x in (jt, jc)]
    return (jt, jc), carry


def _live_counts(seed, v=300, nc=24):
    """Bags whose live entries (both streams together) number 0, 1, 255,
    256, 257, 513 and all 584 of Lc + Lr = 64 + 520, so two rounds, with
    interior holes; one bag with an interior hole run in both streams."""
    rng = np.random.default_rng(seed)
    lc, lr = 64, 520
    ci = rng.integers(0, nc, (8, lc)).astype(np.int32)
    ri = rng.integers(0, v, (8, lr)).astype(np.int32)
    for b, n_live in enumerate((0, 1, 255, 256, 257, 513, 584)):
        keep = np.zeros(lc + lr, bool)
        keep[np.sort(rng.choice(lc + lr, n_live, replace=False))] = True
        ci[b][~keep[:lc]] = -1
        ri[b][~keep[lc:]] = -1
    ci[7, 10:40] = -1                              # interior hole runs
    ri[7, 100:300] = -1
    return ci, ri


def _one_stream(seed, v=300, nc=24):
    """Bags live in the cache stream only, in the residual stream only,
    with every entry padding, with one live entry at each stream's end, and
    padding bags (the batch padded to 8)."""
    rng = np.random.default_rng(seed)
    ci = rng.integers(0, nc, (8, 16)).astype(np.int32)
    ri = rng.integers(0, v, (8, 40)).astype(np.int32)
    ri[0] = -1                                     # cache stream only
    ci[1] = -1                                     # residual stream only
    ci[2], ri[2] = -1, -1                          # every entry padding
    ci[3, :-1], ri[3, :-1] = -1, -1                # the last of each
    ci[4][rng.random(16) < 0.5] = -1               # holes in both
    ri[4][rng.random(40) < 0.5] = -1
    ci[5:], ri[5:] = -1, -1                        # the batch's padding
    return ci, ri


STREAMS = {"live lists 0..584, two rounds": _live_counts,
           "one stream live, all padding": _one_stream}
# (D, dtype, my, dead bank): odd widths, an owned bank, a dead bank
FUSED = [(8, "float32", -1, None), (9, "bfloat16", 2, None),
         (33, "float32", 0, 1)]


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("d,dtype,my,dead", FUSED)
def test_fused_plain_matches_pallas_interpret(stream, d, dtype, my, dead):
    """``cache_residual_bag_plain`` == ``fused_cache_bag_pallas`` (interpret)
    bit for bit; with a dead bank both take the binary live maps and my =
    0. The wrapper on CPU tensors is the plain version, with no launch."""
    (jt, jc), (t, c) = _tables(d, dtype, seed=d)
    ci, ri = STREAMS[stream](seed=d + 1)
    jmaps, tmaps = [x.remap_bank for x in (jt, jc)], [x.remap_bank
                                                     for x in (t, c)]
    if dead is not None:
        live = np.ones(4, bool)
        live[dead] = False
        jmaps = [JE._binary_live_map(x.remap_bank,
                                     jnp.asarray(live[:x.n_banks]))
                 for x in (jt, jc)]
        tmaps = [TE._binary_live_map(x.remap_bank,
                                     torch.from_numpy(live[:x.n_banks]))
                 for x in (t, c)]
    want = JK.fused_cache_bag_pallas(
        jt.packed, jc.packed, jmaps[0], jt.flat_remap(), jmaps[1],
        jc.flat_remap(), jnp.asarray([my], jnp.int32), jnp.asarray(ci),
        jnp.asarray(ri), tile_b=8, interpret=True)
    args = (t.packed, c.packed, tmaps[0], t.remap_flat, tmaps[1],
            c.remap_flat, my, torch.from_numpy(ci), torch.from_numpy(ri))
    got = TK.cache_residual_bag_plain(*args)
    assert got.dtype == getattr(torch, dtype) and got.shape == (8, d)
    np.testing.assert_array_equal(_np(got), _np(want))
    n = TK.cache_residual_bag.launches
    assert torch.equal(TK.cache_residual_bag(*args), got)
    assert TK.cache_residual_bag.launches == n
    if stream.startswith("one"):
        assert not got[2].any() and not got[5:].any()


@pytest.mark.parametrize("stream", list(STREAMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_identity_plain_matches_pallas_interpret(stream, dtype):
    """``plain_cache_bag_plain`` == ``plain_cache_bag_pallas`` (interpret)
    bit for bit on the same streams read as rows of unbanked tables (the
    identity instance's ids), an fp32 cache table cast to a bf16 EMT's
    dtype first as the reference does; the wrapper on CPU tensors is the
    plain version, with no launch."""
    rng = np.random.default_rng(5)
    emt = rng.standard_normal((300, 17)).astype(np.float32)
    cache = rng.standard_normal((24, 17)).astype(np.float32)
    ci, ri = STREAMS[stream](seed=6)
    want = JK.plain_cache_bag_pallas(
        jnp.asarray(emt, getattr(jnp, dtype)), jnp.asarray(cache),
        jnp.asarray(ci), jnp.asarray(ri), tile_b=8, interpret=True)
    args = (torch.from_numpy(emt).to(getattr(torch, dtype)),
            torch.from_numpy(cache), torch.from_numpy(ci),
            torch.from_numpy(ri))
    got = TK.plain_cache_bag_plain(*args)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(_np(got), _np(want))
    n = TK.plain_cache_bag.launches
    assert torch.equal(TK.plain_cache_bag(*args), got)
    assert TK.plain_cache_bag.launches == n


@pytest.mark.parametrize("empty", ["cache", "residual", "both"])
def test_a_stream_of_no_columns_is_a_stream_of_padding(empty):
    """Lc = 0 or Lr = 0 as shapes: the sums equal those with that stream
    all padding, in both instances."""
    (jt, jc), (t, c) = _tables(8, "float32", seed=3)
    ci, ri = _one_stream(seed=4)
    ci0 = np.zeros((8, 0), np.int32) if empty != "residual" else ci
    ri0 = np.zeros((8, 0), np.int32) if empty != "cache" else ri
    cip = np.full_like(ci, -1) if empty != "residual" else ci
    rip = np.full_like(ri, -1) if empty != "cache" else ri
    maps = (t.packed, c.packed, t.remap_bank, t.remap_flat, c.remap_bank,
            c.remap_flat, -1)
    got = TK.cache_residual_bag(*maps, torch.from_numpy(ci0),
                                torch.from_numpy(ri0))
    want = TK.cache_residual_bag_plain(*maps, torch.from_numpy(cip),
                                       torch.from_numpy(rip))
    assert torch.equal(got, want)
    got = TK.plain_cache_bag(t.packed, c.packed, torch.from_numpy(ci0),
                             torch.from_numpy(ri0))
    want = TK.plain_cache_bag_plain(t.packed, c.packed, torch.from_numpy(cip),
                                    torch.from_numpy(rip))
    assert torch.equal(got, want)
    if empty == "both":
        assert not got.any()


# ---------------------------------------------------------------------------
# the launch geometry and the ring's walk
# ---------------------------------------------------------------------------

# (NB, Lc, Lr): the cached serve, one stream of no columns, the
# adversarial shapes (two and three rounds), more bags than the card holds
# at once (two a block), no entry at all
SHAPES = [(512, 64, 256), (512, 0, 256), (512, 64, 0), (37, 100, 450),
          (41, 64, 1100), (4301, 5, 33), (8, 16, 40), (1, 0, 0)]


def _live(nb, lc, lr, seed):
    """Per bag a live mask over its two streams: holes, an all-padding bag,
    a bag live in one stream only, a bag live everywhere."""
    rng = np.random.default_rng(seed)
    live = rng.random((nb, lc + lr)) < 0.6
    live[0] = False
    if nb > 3:
        live[1, lc:] = False
        live[2, :lc] = False
        live[3] = True
    return live


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_fits_and_the_walk_adds_every_live_entry_once(itemsize):
    """Over D = 1..300 and every shape: shared memory within a block's,
    1..8 stages, a copy unit that divides the row stride, column passes
    that cover every column once; and the ring's walk (at each depth the
    geometry picks) adds every live entry of both streams exactly once,
    in entry order, the cache entries from the cache table."""
    walks = {}
    for nb, lc, lr in SHAPES:
        live = _live(nb, lc, lr, seed=nb + lc + lr)
        for dim in range(1, 301):
            g = TK.ring_geometry(nb, lc + lr, dim, itemsize, 0, 0)
            assert g.smem_bytes <= TK.BLOCK_SMEM
            assert 1 <= g.stages <= TK.MAX_STAGES
            assert g.bags_per_block in (1, 2)
            assert g.blocks * g.bags_per_block >= nb
            assert g.smem_bytes == g.bags_per_block * (
                TK.LIST_BYTES + g.stages * TK.STAGE_ROWS * g.row_bytes)
            assert (dim * itemsize) % g.vec == 0 and g.vec >= itemsize
            k = 1 if dim <= 32 else 2 if dim <= 64 else 4
            assert g.row_bytes == 32 * k * itemsize
            cols = [c0 + c for c0 in range(0, dim, 32 * k)
                    for c in range(min(32 * k, dim - c0))]
            assert cols == list(range(dim))
            if g.stages in walks.get((nb, lc, lr), {}):
                continue
            for b in sorted({0, 1, 2, 3, nb - 1} & set(range(nb))):
                want = [(p, "cache" if p < lc else "emt")
                        for p in np.flatnonzero(live[b])]
                assert _ring_walk(live[b], lc, g.stages) == want
            walks.setdefault((nb, lc, lr), {})[g.stages] = True


def test_cached_serve_shape_keeps_the_bag_in_flight():
    """At the cached serve's shape (512 bags, Lc + Lr = 64 + 256, D = 32
    fp32): one bag a block, 8 stages (every live row of a bag, ~117, in
    flight), 16-byte copies, four blocks an SM within its shared memory."""
    g = TK.ring_geometry(512, 64 + 256, 32, 4, 0, 0)
    assert (g.blocks, g.bags_per_block, g.stages, g.vec) == (512, 1, 8, 16)
    assert g.smem_bytes == TK.LIST_BYTES + 8 * 32 * 128
    per_sm = -(-g.blocks // TK.SM_COUNT)
    assert per_sm * (g.smem_bytes + TK.BLOCK_RESERVED) <= TK.SM_SMEM


@pytest.mark.parametrize("dim,itemsize,emt_ptr,cache_ptr,vec", [
    (32, 4, 0, 0, 16), (32, 4, 0, 4, 4), (32, 4, 4, 0, 4), (32, 2, 0, 2, 2),
    (33, 4, 0, 0, 4), (9, 2, 0, 0, 2), (8, 2, 16, 32, 16)])
def test_copy_width_follows_both_tables(dim, itemsize, emt_ptr, cache_ptr,
                                        vec):
    """The copy unit divides the row stride and both tables' bases."""
    assert TK.ring_geometry(64, 40, dim, itemsize, emt_ptr,
                            cache_ptr).vec == vec
