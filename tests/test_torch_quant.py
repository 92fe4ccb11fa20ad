"""The port's tiered-precision storage and lookup against the JAX package's,
on the CPU: row quantization, tier assignment, the from-scratch and the
incremental (re-tier) table builds, the dequant, the tiered bag sums and
their straight-through gradient.

Inputs come from numpy seeds. Quantization and tiering are numpy on both
sides and are held bit for bit. The lookup's plain version
(``tiered_bag_plain``) repeats the reference's jnp scan
(``_tiered_partial_scan``) step for step — one rounded multiply per
quantized value, then one rounded add per entry in entry order — so it is
held bit for bit (``assert_array_equal``) against the jnp path, NOT against
the Pallas interpret path, which differs from both by a few ulp at D = 16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import embedding as JE
from repro.core import partitioning as JP
from repro.quant import quantize as JQ
from repro.quant import tiered as JTT
from repro.quant import tiers as JTI
from repro.workload import migrate as JMIG
from repro_torch.convert import banked_table_from_jax, tiered_table_from_jax
from repro_torch.core import embedding as TE
from repro_torch.kernels.embedding_bag import tiered_bag, tiered_bag_plain
from repro_torch.quant import quantize as TQ
from repro_torch.quant import tiered as TTT
from repro_torch.quant import tiers as TTI
from repro_torch.workload import migrate as TMIG

DIMS = [8, 16, 33, 128]
HOTS = ["bf16", "fp32"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _rows(rng, n, d):
    """fp32 rows with all-zero rows, one huge and one tiny row, and values
    whose low mantissa bits sit exactly on a bf16 rounding tie."""
    rows = (rng.standard_normal((n, d)) * 0.05).astype(np.float32)
    rows[0] = 0
    rows[1] *= 1e4
    rows[2] *= 1e-30
    bits = rows[3].view(np.uint32)
    rows[3] = ((bits & 0xFFFF0000) | 0x8000).view(np.float32)   # ties
    rows[4, : d // 2] = -0.0
    return rows


# ---------------------------------------------------------------------------
# quantize_rows, the byte arithmetic, the dequant: bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("hot", HOTS)
def test_quantize_rows_bit_equal(hot, d):
    rng = np.random.default_rng(d)
    rows = _rows(rng, 64, d)
    tier = rng.integers(0, 3, 64).astype(np.int32)
    tier[:3] = [2, 2, 0]                  # int4 tail on the zero/huge rows
    tier[3] = 0                           # bf16 ties on a hot row
    jp, js = JQ.quantize_rows(rows, tier, hot_dtype=hot)
    tp, ts = TQ.quantize_rows(rows, tier, hot_dtype=hot)
    assert tp.dtype == np.int8 and ts.dtype == np.float32
    np.testing.assert_array_equal(tp, np.asarray(jp))
    np.testing.assert_array_equal(ts.view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    np.testing.assert_array_equal(TQ.tier_nbytes(d, hot),
                                  JQ.tier_nbytes(d, hot))
    assert TQ.row_bytes(d, hot) == JQ.row_bytes(d, hot)
    np.testing.assert_array_equal(TQ.bytes_of_tier(tier, d, hot),
                                  JQ.bytes_of_tier(tier, d, hot))
    # the shared dequant, torch vs jnp, bit for bit
    want = np.asarray(JQ.dequant_rows_f32(jnp.asarray(jp), jnp.asarray(js),
                                          jnp.asarray(tier), d, hot))
    got = _np(TQ.dequant_rows_f32(torch.from_numpy(tp), torch.from_numpy(ts),
                                  torch.from_numpy(tier), d, hot))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_quant_spec_rejects_unknown_hot_dtype():
    with pytest.raises(ValueError, match="hot_dtype"):
        TQ.QuantSpec(hot_dtype="fp16")


# ---------------------------------------------------------------------------
# assign_tiers: the same tier maps and byte accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(),                                              # hot head + int8
    dict(byte_budget=18.0),                              # mostly int4
    dict(byte_budget=5.0),                               # below the int4 floor
    dict(byte_budget=40.0, hot_dtype="fp32"),            # promotes hot rows
    dict(byte_budget=20.0, enable_int4=False),           # int8 only
    dict(byte_budget=33.0, min_hot_rows=0),
])
def test_assign_tiers_matches_jax(kw):
    rng = np.random.default_rng(7)
    freq = rng.zipf(1.2, 3000).astype(np.float64)
    freq[::13] = 0.0                                     # ties at zero
    d = 32
    want = JTI.assign_tiers(freq, JQ.QuantSpec(**kw), d)
    got = TTI.assign_tiers(freq, TQ.QuantSpec(**kw), d)
    np.testing.assert_array_equal(got.tier_of_row, want.tier_of_row)
    assert got.counts == want.counts
    assert got.avg_bytes_per_row == want.avg_bytes_per_row


# ---------------------------------------------------------------------------
# build_tiered_table and retier_tiered: bit for bit, and the incremental
# re-tier equals a fresh build
# ---------------------------------------------------------------------------

def _tables(d, hot, seed=0, n_banks=4, slack=1.25):
    """A packed fp table under a §3.2 plan with capacity slack (pad slots),
    the same on both sides, and a drifted plan and frequency to re-tier
    to."""
    rng = np.random.default_rng(seed + d)
    V = 300
    table = (rng.standard_normal((V, d)) * 0.02).astype(np.float32)
    table[5] = 0.0                                      # an all-zero row
    cap = int(np.ceil(V / n_banks) * slack)
    f0 = rng.random(V) + 0.1
    f1 = np.roll(f0, 97) * rng.random(V)
    p0 = JP.non_uniform_partition(f0, n_banks, capacity_rows=cap)
    p1 = JP.non_uniform_partition(f1, n_banks, capacity_rows=cap)
    jt = JE.pack_table(table, p0)
    jt = JMIG.migrate_table(jt, p0, rows_per_bank=cap)   # pin the capacity
    spec = dict(hot_dtype=hot, byte_budget=0.4 * d + 2, min_hot_rows=6)
    t0 = JTI.assign_tiers(f0, JQ.QuantSpec(**spec), d).tier_of_row
    t1 = JTI.assign_tiers(f1, JQ.QuantSpec(**spec), d).tier_of_row
    return jt, p1, cap, t0, t1


def _assert_tiered_equal(got, want):
    np.testing.assert_array_equal(_np(got.payload), np.asarray(want.payload))
    np.testing.assert_array_equal(_np(got.scale).view(np.uint32),
                                  np.asarray(want.scale).view(np.uint32))
    np.testing.assert_array_equal(_np(got.tier), np.asarray(want.tier))
    np.testing.assert_array_equal(_np(got.remap_bank),
                                  np.asarray(want.remap_bank))
    np.testing.assert_array_equal(_np(got.remap_slot),
                                  np.asarray(want.remap_slot))
    assert (got.n_banks, got.rows_per_bank, got.dim, got.hot_dtype) == \
        (want.n_banks, want.rows_per_bank, want.dim, want.hot_dtype)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("hot", HOTS)
def test_build_and_retier_match_jax(hot, d):
    jt, p1, cap, t0, t1 = _tables(d, hot)
    tt_ = banked_table_from_jax(jt.packed, jt.remap_bank, jt.remap_slot,
                                jt.n_banks, jt.rows_per_bank, "cpu")
    # from scratch
    jv0 = JTT.build_tiered_table(jt, t0, hot_dtype=hot)
    tv0 = TTT.build_tiered_table(tt_, t0, hot_dtype=hot)
    _assert_tiered_equal(tv0, jv0)
    assert (_np(tv0.tier) == TQ.TIER_INT4).any()         # an int4 tail
    np.testing.assert_array_equal(
        TTT.packed_tier_map(tt_, t0), JTT.packed_tier_map(jt, t0))
    np.testing.assert_array_equal(tv0.tier_of_row(), jv0.tier_of_row())
    # migrate to the drifted plan, re-tier incrementally
    jm = JMIG.migrate_table(jt, p1, rows_per_bank=cap)
    tm = TMIG.migrate_table(tt_, p1, rows_per_bank=cap)
    np.testing.assert_array_equal(_np(tm.packed), np.asarray(jm.packed))
    jv1, jstats = JTT.retier_tiered(jv0, jm, t1)
    tv1, tstats = TTT.retier_tiered(tv0, tm, t1)
    assert tstats == jstats and tstats["n_requantized"] > 0
    _assert_tiered_equal(tv1, jv1)
    assert TTT.same_layout(tv0, tv1)
    # the incremental re-tier equals a from-scratch build, bit for bit
    _assert_tiered_equal(tv1, JTT.build_tiered_table(jm, t1, hot_dtype=hot))
    # and the byte model agrees
    rows = np.random.default_rng(1).integers(0, 300, 500)
    np.testing.assert_array_equal(
        TTT.modeled_bank_byte_load(t1, p1.bank_of_row, rows, d, hot),
        JTT.modeled_bank_byte_load(t1, p1.bank_of_row, rows, d, hot))


def test_tiered_table_carries_across_from_jax():
    jt, _, _, t0, _ = _tables(33, "bf16")
    jv = JTT.build_tiered_table(jt, t0)
    tv = tiered_table_from_jax(jv, "cpu")
    _assert_tiered_equal(tv, jv)
    np.testing.assert_array_equal(_np(tv.remap_flat),
                                  np.asarray(jv.flat_remap()))


# ---------------------------------------------------------------------------
# the tiered lookup: plain version and public entry vs the jnp path
# ---------------------------------------------------------------------------

def _lookup_case(d, hot, seed=3):
    """A tiered table over 3 fields, (9 x 3) bags of up to 7 ids with
    interior holes and all-pad bags."""
    jt, _, _, t0, _ = _tables(d, hot, seed=seed)
    jv = JTT.build_tiered_table(jt, t0, hot_dtype=hot)
    rng = np.random.default_rng(seed)
    vs = (120, 100, 80)
    offs = np.array([0, 120, 220], np.int32)
    idx = np.full((9, 3, 7), -1, np.int32)
    for b in range(9):
        for f in range(3):
            n = int(rng.integers(0, 8))
            idx[b, f, :n] = rng.integers(0, vs[f], n)
    idx[2, 1, 1] = -1                                    # interior hole
    idx[4] = -1                                          # all-pad bags
    return jt, jv, idx, offs


def _jnp_scan(jv, idx, offs, my):
    L = idx.shape[-1]
    return np.asarray(JE._tiered_partial_scan(
        jv.payload, jv.scale, jv.tier, jnp.asarray(idx.reshape(-1, L)),
        remap=jv.flat_remap(), bank=jv.remap_bank,
        my_bank=jnp.int32(my), off=jnp.asarray(offs), dim=jv.dim,
        hot_dtype=jv.hot_dtype))


@pytest.mark.parametrize("my", [-1, 2])
@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("hot", HOTS)
def test_tiered_bag_plain_matches_jnp_scan(hot, d, my):
    _, jv, idx, offs = _lookup_case(d, hot)
    tv = tiered_table_from_jax(jv, "cpu")
    L = idx.shape[-1]
    flat = torch.from_numpy(idx.reshape(-1, L))
    args = (tv.payload, tv.scale, tv.tier, tv.remap_bank, tv.remap_flat,
            torch.from_numpy(offs), my, flat)
    got = tiered_bag_plain(*args, dim=d, hot_dtype=hot)
    assert got.dtype == torch.float32 and tuple(got.shape) == (27, d)
    want = _jnp_scan(jv, idx, offs, my)
    np.testing.assert_array_equal(_np(got), want)
    # the wrapper takes the plain version for CPU tensors
    np.testing.assert_array_equal(_np(tiered_bag(*args, dim=d,
                                                 hot_dtype=hot)), want)
    assert not np.abs(want[4 * 3:5 * 3]).any()           # all-pad bags


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("hot", HOTS)
def test_tiered_embedding_bag_matches_jnp(hot, d):
    jt, jv, idx, offs = _lookup_case(d, hot)
    tv = tiered_table_from_jax(jv, "cpu")
    fp = torch.from_numpy(np.array(jt.packed))
    want = np.asarray(JE.tiered_embedding_bag(
        jt.packed, jv, jnp.asarray(idx), None, backend="jnp",
        field_offsets=jnp.asarray(offs)))
    got = TE.tiered_embedding_bag(fp, tv, torch.from_numpy(idx),
                                  backend="torch",
                                  field_offsets=torch.from_numpy(offs))
    assert tuple(got.shape) == (9, 3, d)
    np.testing.assert_array_equal(_np(got), want)
    auto = TE.tiered_embedding_bag(fp, tv, torch.from_numpy(idx),
                                   field_offsets=torch.from_numpy(offs))
    np.testing.assert_array_equal(_np(auto), want)


@pytest.mark.parametrize("d", [16, 33])
def test_straight_through_gradient_matches_jax(d):
    jt, jv, idx, offs = _lookup_case(d, "bf16", seed=5)
    tv = tiered_table_from_jax(jv, "cpu")
    cot = np.random.default_rng(d).standard_normal(
        (9, 3, d)).astype(np.float32)

    def jloss(fp):
        out = JE.tiered_embedding_bag(fp, jv, jnp.asarray(idx), None,
                                      backend="jnp", bwd_backend="jnp",
                                      field_offsets=jnp.asarray(offs))
        return jnp.sum(out * jnp.asarray(cot))

    want = np.asarray(jax.grad(jloss)(jt.packed))
    fp = torch.from_numpy(np.array(jt.packed)).requires_grad_(True)
    out = TE.tiered_embedding_bag(fp, tv, torch.from_numpy(idx),
                                  backend="torch", bwd_backend="torch",
                                  field_offsets=torch.from_numpy(offs))
    (got,) = torch.autograd.grad(out, [fp], torch.from_numpy(cot))
    assert got.shape == fp.shape and got.dtype == fp.dtype
    np.testing.assert_array_equal(_np(got), want)
    assert int((want != 0).any(1).sum()) > 0


def test_tiered_lookup_refuses_a_foreign_fp_table_and_a_mesh():
    _, jv, idx, offs = _lookup_case(8, "bf16")
    tv = tiered_table_from_jax(jv, "cpu")
    with pytest.raises(ValueError, match="fp table rows"):
        TE.tiered_embedding_bag(torch.zeros((7, 8)), tv,
                                torch.from_numpy(idx),
                                field_offsets=torch.from_numpy(offs))
    with pytest.raises(NotImplementedError, match="queue 1 #16"):
        TE.tiered_embedding_bag(torch.zeros((tv.payload.shape[0], 8)), tv,
                                torch.from_numpy(idx), dist=object())
