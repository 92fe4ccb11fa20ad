"""The banked-bag kernel's launch geometry (``kernels/embedding_bag.
bag_geometry``), which the CUDA kernel takes as it is, checked on the CPU:
shared memory within what a block may use on an H100, at least one ring
stage, and a schedule (the kernel's grid, bag segments, ring stages and
column passes, enumerated as the kernel walks them) that covers every bag,
every entry and every column exactly once. Nothing here needs the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as TB

# (NB, L): the serve and train batches (64 x 8 fields, bags of 256), the
# replica lane's, phase 8's padded bags, the adversarial lengths, more bags
# than the card holds at once, empty and one-entry bags
SHAPES = [(512, 256), (512, 300), (24, 1000), (37, 33), (5, 31), (8, 1),
          (5000, 32), (20000, 8), (1, 0), (3, 2500)]


def _schedule(g, nb, bag_len, dim):
    """(bags, entries per bag, columns per bag) as the kernel walks them:
    block b's warp w takes bag b * bags_per_block + w (< nb); a bag's
    segments of 256 entries stream in stages of 32 rows; passes of 32 K
    columns."""
    bags = [b * g.bags_per_block + w for b in range(g.blocks)
            for w in range(g.bags_per_block)
            if b * g.bags_per_block + w < nb]
    entries = []
    for e0 in range(0, bag_len, TB.SEG):
        n = min(TB.SEG, bag_len - e0)
        for t in range(-(-n // TB.STAGE_ROWS)):
            rows = min(TB.STAGE_ROWS, n - t * TB.STAGE_ROWS)
            entries.extend(e0 + t * TB.STAGE_ROWS + r for r in range(rows))
    k = 1 if dim <= 32 else 2 if dim <= 64 else 4
    cols = [c0 + c for c0 in range(0, dim, 32 * k)
            for c in range(min(32 * k, dim - c0))]
    return bags, entries, cols


@pytest.mark.parametrize("k_max", [1, 2, 3, 4])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_fits_and_covers_every_bag(itemsize, k_max):
    """Over D = 1..300 in both dtypes. The replica width changes only the
    remaps' length, not the ring: the geometry of a k_max-wide call is the
    single-copy one."""
    for dim in range(1, 301):
        for nb, bag_len in SHAPES:
            g = TB.bag_geometry(nb, bag_len, dim, itemsize)
            assert g == TB.bag_geometry(nb, bag_len, dim, itemsize,
                                        base_ptr=k_max * 4096)
            assert g.smem_bytes <= TB.BLOCK_SMEM
            assert 1 <= g.stages <= TB.MAX_STAGES
            assert g.bags_per_block in (1, 2)
            k = 1 if dim <= 32 else 2 if dim <= 64 else 4
            assert g.row_bytes == 32 * k * itemsize
            assert g.row_bytes % 16 == 0 and g.row_bytes >= min(dim, 128) \
                * itemsize
            assert g.smem_bytes == g.bags_per_block * (
                TB.SLOT_BYTES + g.stages * TB.STAGE_ROWS * g.row_bytes)
            assert (dim * itemsize) % g.vec == 0 and g.vec >= itemsize
            bags, entries, cols = _schedule(g, nb, bag_len, dim)
            assert bags == list(range(nb))
            assert entries == list(range(bag_len))
            assert cols == list(range(dim))


def test_serve_shape_keeps_the_whole_bag_in_flight():
    """At the serve shape (512 bags of 256 entries, D = 32 fp32) one bag a
    block, four blocks an SM, all resident: the ring holds the whole bag."""
    g = TB.bag_geometry(512, 256, 32, 4)
    assert (g.blocks, g.bags_per_block, g.stages, g.vec) == (512, 1, 8, 16)
    assert g.smem_bytes == 1024 + 8 * 32 * 128
    per_sm = -(-g.blocks // TB.SM_COUNT)
    assert per_sm * (g.smem_bytes + TB.BLOCK_RESERVED) <= TB.SM_SMEM


@pytest.mark.parametrize("nb", [512, 4224, 4225, 20000])
def test_bags_per_block_keep_the_batch_resident(nb):
    """Two bags a block only when one a block would pass the card's
    resident-block limit (132 SMs x 32)."""
    g = TB.bag_geometry(nb, 256, 32, 4)
    assert g.bags_per_block == (1 if nb <= 132 * 32 else 2)
    per_sm = -(-g.blocks // TB.SM_COUNT)
    if per_sm <= TB.SM_BLOCKS:
        assert per_sm * (g.smem_bytes + TB.BLOCK_RESERVED) <= TB.SM_SMEM


@pytest.mark.parametrize("dim,itemsize,ptr,vec", [
    (32, 4, 0, 16), (33, 4, 0, 4), (9, 2, 0, 2), (8, 2, 0, 16),
    (10, 2, 0, 4), (32, 4, 4, 4), (32, 2, 2, 2), (1, 4, 0, 4)])
def test_copy_width_follows_row_stride_and_base(dim, itemsize, ptr, vec):
    assert TB.copy_width(dim * itemsize, ptr) == vec
    assert TB.bag_geometry(64, 40, dim, itemsize, ptr).vec == vec


@pytest.mark.parametrize("k_max", [1, 2, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_wrappers_take_the_plain_versions(dtype, k_max):
    """On CPU tensors ``banked_bag`` and ``plain_bag`` are their plain
    versions (the kernel's geometry is computed only for a launch)."""
    rng = np.random.default_rng(k_max)
    V, D, F = 50, 9, 3
    table = torch.from_numpy(rng.standard_normal((V * k_max, D))
                             .astype(np.float32)).to(dtype)
    bank = torch.from_numpy(rng.integers(0, 2, V * k_max).astype(np.int32))
    slot = torch.from_numpy(rng.permutation(V * k_max).astype(np.int32))
    off = torch.arange(F, dtype=torch.int32) * (V // F)
    idx = torch.from_numpy(rng.integers(-1, V // F, (7, 33)).astype(np.int32))
    for my in (-1, 0, 1):
        assert torch.equal(
            TB.banked_bag(table, bank, slot, off, my, idx, k_max),
            TB.banked_bag_plain(table, bank, slot, off, my, idx, k_max))
    rows = torch.where(idx >= 0, idx + 5, idx)
    assert torch.equal(TB.plain_bag(table, rows),
                       TB.plain_bag_plain(table, rows))
