"""The port's exact greedies place long runs of one frequency at once
(``core/partitioning._merge_run``); the plans must still equal the JAX
reference's, row for row. The inputs here look like the telemetry's
frequency estimates at scale: a few dozen distinct values (sketch floors)
over tens of thousands of rows, most of them zero, so nearly every row
falls in a run of hundreds or thousands; capacity slack, a tight
capacity, bank costs, a dead bank, byte weights, float32 counts, eight
banks, the cache-aware residual greedy and the replicated greedy.
"""
import numpy as np
import pytest

from repro.core import partitioning as JP
from repro_torch.core import partitioning as TP

V = 20_000
PLAN_FIELDS = ("bank_of_row", "slot_of_row", "rows_per_bank",
               "load_per_bank")


def _freq(zero_share, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    f = rng.integers(1, 30, V).astype(dtype)
    f[rng.random(V) < zero_share] = 0
    return f


def _equal(got, want, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)


@pytest.mark.parametrize("case", [
    dict(n_banks=4, zero_share=0.5, slack=1.25),
    dict(n_banks=4, zero_share=1.0, slack=1.25),
    dict(n_banks=4, zero_share=0.5, slack=1.0),
    dict(n_banks=8, zero_share=0.7, slack=1.02),
    dict(n_banks=5, zero_share=0.5, slack=1.3, bank_cost=[1, 3, 1, 1, 2.5]),
    dict(n_banks=4, zero_share=0.5, slack=1.4, dead=1),
    dict(n_banks=4, zero_share=0.3, slack=1.25, weights=True),
    dict(n_banks=4, zero_share=0.5, slack=None, dtype="float32"),
])
def test_non_uniform_runs_match_jax(case):
    nb = case["n_banks"]
    freq = _freq(case["zero_share"],
                 dtype=np.dtype(case.get("dtype", "float64")))
    kw = {}
    if case["slack"] is not None:
        live = nb - (1 if "dead" in case else 0)
        kw["capacity_rows"] = int(np.ceil(V / live) * case["slack"])
    if "bank_cost" in case:
        kw["bank_cost"] = np.asarray(case["bank_cost"], np.float64)
    if "dead" in case:
        caps = np.full(nb, kw["capacity_rows"])
        caps[case["dead"]] = 0
        kw["bank_capacity_rows"] = caps
    if case.get("weights"):
        kw["row_weights"] = np.array([64.0, 32.0, 16.0])[
            np.random.default_rng(4).integers(0, 3, V)]
    got = TP.non_uniform_partition(freq, nb, **kw)
    _equal(got, JP.non_uniform_partition(freq, nb, **kw), PLAN_FIELDS)
    got.validate()


@pytest.mark.parametrize("zero_share,n_banks,slack,n_groups", [
    (0.6, 4, 1.2, 40), (1.0, 4, 1.0, 40), (0.3, 8, 1.1, 40),
    # banks without a group tie at load 0: the loop fills one at a time
    (1.0, 8, 1.2, 2), (0.5, 8, 1.0, 3)])
def test_cache_aware_runs_match_jax(zero_share, n_banks, slack, n_groups):
    freq = _freq(zero_share, seed=1)
    rng = np.random.default_rng(2)
    groups = [rng.choice(V, size=int(rng.integers(2, 6)), replace=False)
              for _ in range(n_groups)]
    benefits = rng.random(n_groups) * 5
    kw = dict(emt_capacity_rows=int(np.ceil(V / n_banks) * slack),
              cache_capacity_entries=8)
    got = TP.cache_aware_partition(freq, groups, benefits, n_banks, **kw)
    want = JP.cache_aware_partition(freq, groups, benefits, n_banks, **kw)
    _equal(got, want, PLAN_FIELDS + ("cache_bank_of_entry",
                                     "cache_slot_of_entry"))


def test_replicated_runs_match_jax():
    freq = _freq(0.5, seed=3)
    freq[:16] = 1000.0 + np.arange(16)
    copies = np.ones(V, np.int32)
    copies[:16] = np.random.default_rng(5).integers(1, 4, 16)
    kw = dict(copies=copies, capacity_rows=int(np.ceil(V / 4) * 1.3),
              k_max=4)
    got = TP.replicated_partition(freq, 4, **kw)
    want = JP.replicated_partition(freq, 4, **kw)
    _equal(got, want, ("copies", "bank_of_copy", "slot_of_copy",
                       "rows_per_bank", "load_per_bank"))


def test_runs_raise_like_jax():
    freq = np.zeros(V)
    for mod in (TP, JP):
        with pytest.raises(ValueError, match="capacity exhausted"):
            mod.non_uniform_partition(freq, 4, capacity_rows=V // 4 - 1)
