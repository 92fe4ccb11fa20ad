"""The backward scatter's prep as the card runs it (``csrc/scatter_prep.cu``:
a label kernel, one stable key-value sort, a run table), through the plain
versions of its kernels, against the op-by-op prep on the CPU.

Plain labels (``scatter_labels_plain``), a stable sort of the (dest, bag)
pairs by dest and the plain run table (``run_table_plain``, computed as the
kernels compute it) must give ``scatter_prep``'s and
``scatter_run_metadata``'s five arrays bit for bit, dead tail included, on
every layout the card's prep takes. The kernels themselves run only on the
card (``tests/test_torch_scatter_prep_card.py``).
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.kernels import embedding_bag as TK
from repro_torch.obs import tracing as T

F, PER_FIELD, N_BANKS = 8, 500, 4
V = F * PER_FIELD


def _remap(seed=0, pad=12):
    """A banked remap of V rows over N_BANKS banks of ceil(V / N_BANKS) +
    pad rows: (bank, slot, n_rows)."""
    rng = np.random.default_rng(seed)
    per = -(-V // N_BANKS) + pad
    slot = rng.permutation(N_BANKS * per)[:V].astype(np.int32)
    return (torch.from_numpy(slot // per).to(torch.int32),
            torch.from_numpy(slot), N_BANKS * per)


def _replicated(bank, slot, k):
    """(V * k,) remaps: copy c of row v at v * k + c, each copy on its own
    slot (copy 0 the row's own, the others past the single-copy table)."""
    n = slot.shape[0]
    cols = [slot] + [torch.arange(n, dtype=torch.int32) + n * c + 10_000
                     for c in range(1, k)]
    return (bank.repeat_interleave(k),
            torch.stack(cols, 1).reshape(-1).to(torch.int32))


def _offsets():
    return torch.arange(F, dtype=torch.int32) * PER_FIELD


def _zipf_ids(b, l, seed, a=1.18):
    """(b * F, l) per-field Zipf(a) ids with Poisson bag lengths cut to
    [1, l], the tail of each bag -1."""
    rng = np.random.default_rng(seed)
    p = np.arange(1, PER_FIELD + 1, dtype=np.float64) ** -a
    ids = rng.permutation(PER_FIELD)[
        rng.choice(PER_FIELD, size=(b, F, l), p=p / p.sum())]
    lens = np.clip(rng.poisson(0.9 * l, (b, F)), 1, l)
    ids[np.arange(l)[None, None, :] >= lens[..., None]] = -1
    return torch.from_numpy(ids.reshape(-1, l).astype(np.int32))


def _card_steps(idx, bank, slot, off, my, n_rows, k_max=1):
    """The card's three steps in their plain versions."""
    dest, bags = TK.scatter_labels_plain(idx, bank, slot, off, my, n_rows,
                                         k_max)
    return TK.scatter_runs_plain(dest, bags, n_rows)


def _equal(got, want):
    for name, g, w in zip(TK.ScatterRuns._fields, got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


CASES = {
    "my=-1": dict(my=-1),
    "my=2": dict(my=2),
    "my=0 dead bank": dict(my=0, dead=1),
    "k_max=2": dict(my=-1, k_max=2),
    "k_max=3 my=1": dict(my=1, k_max=3),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_steps_equal_the_op_by_op_prep_on_zipf_bags(case):
    """A Zipf(1.18) batch of Poisson bags (a dead tail of padding and, with
    my >= 0, of other banks' rows): labels, sort and run table equal
    ``scatter_prep``'s five arrays."""
    kw = CASES[case]
    bank, slot, n_rows = _remap(seed=1)
    if "dead" in kw:          # the binary live map: bank 0 = live
        bank = (bank == kw["dead"]).to(torch.int32)
    k = kw.get("k_max", 1)
    if k > 1:
        bank, slot = _replicated(bank, slot, k)
        n_rows = int(slot.max()) + 1
    idx = _zipf_ids(6, 32, seed=2)
    want = TK.scatter_prep(idx, bank, slot, _offsets(), kw["my"], n_rows, k)
    got = _card_steps(idx, bank, slot, _offsets(), kw["my"], n_rows, k)
    _equal(got, want)
    n_run, live = int(want.n_run[0]), int(want.run_starts[-1])
    assert 0 < n_run < live < idx.numel()        # runs merged, a dead tail
    assert int(want.run_of[-1]) == n_run - 1


def _layout(idx, n_rows=None, off=None):
    bank, slot, rows = _remap(seed=3)
    return (idx, bank, slot, _offsets() if off is None else off, -1,
            rows if n_rows is None else n_rows)


LAYOUTS = {
    "all padding": lambda: _layout(torch.full((16, 8), -1, dtype=torch.int32)),
    "E = 1": lambda: _layout(torch.tensor([[3]], dtype=torch.int32)),
    "E = 1 padding": lambda: _layout(torch.tensor([[-1]], dtype=torch.int32)),
    "one run": lambda: _layout(torch.full((8, 16), 7, dtype=torch.int32),
                               off=torch.zeros(1, dtype=torch.int32)),
    "every entry its own run": lambda: _layout(
        (torch.arange(32 * 10, dtype=torch.int32).reshape(10, 32) % V),
        off=torch.zeros(1, dtype=torch.int32)),
    "odd shape, holes": lambda: _layout(torch.where(
        torch.arange(37 * 5).reshape(37, 5) % 3 == 0, -1,
        torch.arange(37 * 5).reshape(37, 5) % 11).to(torch.int32)),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_plain_steps_equal_the_op_by_op_prep_on_edge_layouts(name):
    args = LAYOUTS[name]()
    want = TK.scatter_prep(*args)
    _equal(_card_steps(*args), want)
    n_run, E = int(want.n_run[0]), args[0].numel()
    expect = {"all padding": 0, "E = 1": 1, "E = 1 padding": 0, "one run": 1,
              "every entry its own run": E}
    if name in expect:
        assert n_run == expect[name]


@settings(max_examples=40, deadline=None)
@given(st.integers(1, 300), st.integers(1, 40), st.floats(0.0, 1.0),
       st.integers(0, 2**31 - 1))
def test_sort_and_run_table_equal_scatter_run_metadata(n, n_rows, dead,
                                                       seed):
    """Any labels in [0, n_rows] (the sentinel among them), repeated or
    not: the stable sort and the plain run table give
    ``scatter_run_metadata``'s five arrays with one run slot per entry."""
    rng = np.random.default_rng(seed)
    dest = rng.integers(0, n_rows, n).astype(np.int32)
    dest[rng.random(n) < dead] = n_rows
    bags = rng.integers(0, 50, n).astype(np.int32)
    got = TK.scatter_runs_plain(torch.from_numpy(dest),
                                torch.from_numpy(bags), n_rows)
    m = TK.scatter_run_metadata(torch.from_numpy(dest),
                                torch.from_numpy(bags), n_rows, n)
    _equal(got, TK.ScatterRuns(m[0], m[2], m[3], m[4], m[1]))


def test_labels_fit_the_sorted_bits():
    """``label_bits`` holds every label of ``scatter_labels_plain``: the
    sentinel n_rows and slots past the table (sent to it). A stable sort on
    those low bits alone is the full sort, as the card's sort relies on."""
    assert TK.label_bits(18_885_200) == 25
    assert TK.label_bits(2**24) == 25 and TK.label_bits(2**24 - 1) == 24
    assert TK.label_bits(0) == 1
    bank, slot, n_rows = _remap(seed=4)
    slot = slot.clone()
    slot[::7] = n_rows + 5                      # out of range: dropped
    slot[3::7] = -3
    idx = _zipf_ids(4, 16, seed=5)
    dest, bags = TK.scatter_labels_plain(idx, bank, slot, _offsets(), -1,
                                         n_rows)
    ref, ref_bags = TK.scatter_entries(idx, bank, slot, _offsets(), -1,
                                       n_rows)
    bad = (ref < 0) | (ref > n_rows)
    assert bad.any()
    np.testing.assert_array_equal(dest.numpy(),
                                  torch.where(bad, n_rows, ref).numpy())
    np.testing.assert_array_equal(bags.numpy(), ref_bags.numpy())
    d = dest.numpy()
    bits = TK.label_bits(n_rows)
    np.testing.assert_array_equal(
        np.argsort(d & ((1 << bits) - 1), kind="stable"),
        np.argsort(d, kind="stable"))
    # on valid remaps the labels are scatter_entries' own
    bank, slot, n_rows = _remap(seed=4)
    for got, want in zip(
            TK.scatter_labels_plain(idx, bank, slot, _offsets(), 2, n_rows),
            TK.scatter_entries(idx, bank, slot, _offsets(), 2, n_rows)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_csr_and_identity_preps_through_the_plain_sort_and_table():
    """The csr and identity layouts label op by op and take the card's
    sort and run table: their labels through ``scatter_runs_plain`` give
    their op-by-op prep's arrays."""
    bank, slot, n_rows = _remap(seed=6)
    rng = np.random.default_rng(7)
    indices = rng.integers(-1, V, 300).astype(np.int32)
    seg = np.sort(rng.integers(0, 40, 300)).astype(np.int32)
    ind_t, seg_t = torch.from_numpy(indices), torch.from_numpy(seg)
    for my in (-1, 1):
        valid = ind_t >= 0
        dest = TK.dest_slots(torch.where(valid, ind_t, 0).long(), valid, bank,
                             slot, my, n_rows)
        _equal(TK.scatter_runs_plain(dest, seg_t, n_rows),
               TK.csr_scatter_prep(ind_t, seg_t, bank, slot, my, n_rows))
    idx = torch.from_numpy(rng.integers(-1, 60, (9, 7)).astype(np.int32))
    idx[0, 0] = 80                               # past the table: dropped
    raw = idx.reshape(-1)
    dest = torch.where(raw >= 0, raw, 50).to(torch.int32)
    bags = (torch.arange(raw.numel()) // 7).to(torch.int32)
    _equal(TK.scatter_runs_plain(dest, bags, 50),
           TK.identity_scatter_prep(idx, 50))


def test_cpu_wrappers_take_the_plain_versions():
    """On CPU tensors the card's wrappers are their plain versions (no
    launch counted), and every prep gives the same bits with ``plain``."""
    bank, slot, n_rows = _remap(seed=8)
    idx = _zipf_ids(3, 16, seed=9)
    n_l, n_r = TK.scatter_labels.launches, TK.scatter_runs.launches
    lab = TK.scatter_labels(idx, bank, slot, _offsets(), 1, n_rows)
    for g, w in zip(lab, TK.scatter_labels_plain(idx, bank, slot, _offsets(),
                                                 1, n_rows)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    _equal(TK.scatter_runs(*lab, n_rows),
           TK.scatter_runs_plain(*lab, n_rows))
    assert (TK.scatter_labels.launches, TK.scatter_runs.launches) == (n_l,
                                                                      n_r)
    _equal(TK.scatter_prep(idx, bank, slot, _offsets(), 1, n_rows),
           TK.scatter_prep(idx, bank, slot, _offsets(), 1, n_rows,
                           plain=True))
    empty = torch.zeros(0, dtype=torch.int32)
    _equal(TK.scatter_runs_plain(empty, empty, n_rows),
           TK._runs(empty, empty, n_rows))
    with pytest.raises(ValueError, match="unsupported device"):
        TK.scatter_runs(empty.to("meta"), empty.to("meta"), n_rows)


def test_prep_span_covers_the_prep_alone():
    """``ct_scatter_bag`` off the CPU opens the stage span ``lookup.prep``
    around its prep (on meta tensors: the op-by-op prep and the kernel's
    cost, no device time); the CPU path opens none."""
    n_rows, NB, L, D = 40, 6, 4, 8
    meta = dict(device="meta")
    args = (torch.empty((NB, D), **meta),
            torch.empty((NB, L), dtype=torch.int32, **meta),
            torch.empty(n_rows, dtype=torch.int32, **meta),
            torch.empty(n_rows, dtype=torch.int32, **meta),
            torch.empty(2, dtype=torch.int32, **meta), -1, n_rows)
    tr = T.Tracer()
    before = T.install(tr)
    try:
        out = TK.ct_scatter_bag(*args)
        assert out.shape == (n_rows, D)
        assert [r.name for r in tr.records] == ["lookup.prep"]
        assert tr.device_ms(tr.records[0]) is None
        bank, slot, rows = _remap(seed=10)
        TK.ct_scatter_bag(torch.ones((NB * 2, D)), _zipf_ids(2, 4, seed=11)[
            :NB * 2], bank, slot, _offsets(), -1, rows)
        assert len(tr.records) == 1
    finally:
        T.install(before)
