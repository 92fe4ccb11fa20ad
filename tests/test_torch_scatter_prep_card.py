"""The backward scatter's prep on the card (``csrc/scatter_prep.cu``: the
label kernel, CUB's key-value radix sort and the run table) against the
op-by-op prep on the same card, bit for bit, and the scatter through it
against ``ct_scatter_bag_plain``.

Needs a CUDA card (skips without one). On the card, from the root of the
repo:

    PYTHONPATH=src python -m pytest -q tests/test_torch_scatter_prep_card.py
"""
import re

import pytest
import torch

from repro_torch.kernels import embedding_bag as TK
from repro_torch.obs import tracing as T

pytestmark = pytest.mark.skipif(not torch.cuda.is_available(),
                                reason="needs a CUDA card")

# updlrm-paper: 8 fields of 2,360,650 rows on 8 banks; paper-train's bags
F, PER_FIELD, N_BANKS, L = 8, 2_360_650, 8, 256


def _remap(dev, pad=1000, seed=0):
    """(bank, slot, n_rows): the rows scattered over N_BANKS banks of
    ceil(V / N_BANKS) + pad slots each."""
    g = torch.Generator(device=dev).manual_seed(seed)
    V = F * PER_FIELD
    per = -(-V // N_BANKS) + pad
    slot = torch.randperm(N_BANKS * per, generator=g, device=dev)[:V]
    return ((slot // per).to(torch.int32), slot.to(torch.int32),
            N_BANKS * per)


def _zipf_bags(batch, dev, seed=1, a=1.18, mean=245.8):
    """(batch * F, L) int32: per-field Zipf(a) ids, ranks permuted over the
    rows, Poisson(mean) bag lengths cut to [1, L], the tail -1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    k = torch.arange(1, PER_FIELD + 1, dtype=torch.float64, device=dev)
    cdf = torch.cumsum(k ** -a, 0)
    cdf /= cdf[-1].clone()
    perm = torch.randperm(PER_FIELD, generator=g, device=dev)
    u = torch.rand(batch * F * L, dtype=torch.float64, generator=g,
                   device=dev)
    r = torch.searchsorted(cdf, u, right=True).clamp_(max=PER_FIELD - 1)
    ids = perm[r].to(torch.int32).reshape(batch * F, L)
    lens = torch.poisson(torch.full((batch * F, 1), mean, device=dev),
                         generator=g).clamp_(1, L)
    ids[torch.arange(L, device=dev)[None, :] >= lens] = -1
    return ids


@pytest.fixture(scope="module")
def card():
    dev = torch.device("cuda", 0)
    bank, slot, n_rows = _remap(dev)
    off = torch.arange(F, dtype=torch.int32, device=dev) * PER_FIELD
    return dict(dev=dev, bank=bank, slot=slot, n_rows=n_rows, off=off,
                idx=_zipf_bags(4096, dev))


def _equal(got, want):
    torch.cuda.synchronize()
    for name, g, w in zip(TK.ScatterRuns._fields, got, want):
        assert g.dtype == torch.int32 and g.is_cuda, name
        assert g.shape == w.shape, name
        assert torch.equal(g, w), f"{name}: card prep != op-by-op prep"


@pytest.mark.parametrize("my,k_max", [(-1, 1), (3, 1), (-1, 2), (5, 3)])
def test_card_prep_equals_the_op_by_op_prep_on_paper_train_bags(card, my,
                                                                k_max):
    """4,096 x 8 x 256 Zipf(1.18) entries (8.4 M), every bank owning or one
    bank, one copy of each row or k_max replicas."""
    bank, slot, n_rows = card["bank"], card["slot"], card["n_rows"]
    if k_max > 1:
        extra = torch.arange(slot.shape[0] * (k_max - 1), dtype=torch.int32,
                             device=slot.device).reshape(-1, k_max - 1)
        slot = torch.cat([slot[:, None], extra + n_rows], 1).reshape(-1)
        bank = bank.repeat_interleave(k_max)
        n_rows += extra.numel()
    n_l, n_r = TK.scatter_labels.launches, TK.scatter_runs.launches
    got = TK.scatter_prep(card["idx"], bank, slot, card["off"], my, n_rows,
                          k_max)
    assert (TK.scatter_labels.launches, TK.scatter_runs.launches) == (
        n_l + 1, n_r + 1)
    want = TK.scatter_prep(card["idx"], bank, slot, card["off"], my, n_rows,
                           k_max, plain=True)
    _equal(got, want)
    n_run, n_valid = int(want.n_run[0]), int(want.run_starts[-1])
    assert 0 < n_run < n_valid < card["idx"].numel()


LAYOUTS = {
    "all padding": lambda d: torch.full((64, 40), -1, dtype=torch.int32,
                                        device=d),
    "E = 1": lambda d: torch.full((1, 1), 9, dtype=torch.int32, device=d),
    "one run": lambda d: torch.full((8, 300), 9, dtype=torch.int32, device=d),
    "every entry its own run": lambda d: torch.arange(
        8 * 5000, dtype=torch.int32, device=d).reshape(8, 5000),
    "odd shape": lambda d: _zipf_bags(37, d, seed=4)[:, :45].contiguous(),
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_card_prep_equals_the_op_by_op_prep_on_edge_layouts(card, name):
    """Tiles cut at every edge: NB and L not multiples of 32, E not a
    multiple of the run table's 2,048, runs across tiles."""
    idx = LAYOUTS[name](card["dev"])
    off = torch.zeros(1, dtype=torch.int32, device=card["dev"])
    args = (idx, card["bank"], card["slot"], off, -1, card["n_rows"])
    _equal(TK.scatter_prep(*args), TK.scatter_prep(*args, plain=True))


def test_csr_and_identity_preps_sort_on_the_card(card):
    """The csr and identity layouts: op-by-op labels, the card's sort (all
    32 bits) and run table, against their op-by-op preps; the caller's
    ``seg`` is left as it was."""
    idx = card["idx"][:8192]
    indices = (idx + card["off"].repeat(idx.shape[0] // F)[:, None]
               ).reshape(-1)
    indices = torch.where(idx.reshape(-1) >= 0, indices, -1)
    seg = torch.arange(idx.shape[0], dtype=torch.int32,
                       device=idx.device).repeat_interleave(idx.shape[1])
    keep = seg.clone()
    n = TK.scatter_runs.launches
    for my in (-1, 2):
        args = (indices, seg, card["bank"], card["slot"], my, card["n_rows"])
        _equal(TK.csr_scatter_prep(*args),
               TK.csr_scatter_prep(*args, plain=True))
    assert torch.equal(seg, keep)
    small = torch.where(idx % 1000 == 0, idx + 3_000_000, idx)   # some past
    _equal(TK.identity_scatter_prep(small, 2_500_000),
           TK.identity_scatter_prep(small, 2_500_000, plain=True))
    assert TK.scatter_runs.launches == n + 3


def test_scatter_through_the_card_prep_equals_the_plain_scatter(card):
    """``ct_scatter_bag`` (the card's prep, the zero fill, ``ct_scatter.cu``)
    against ``ct_scatter_bag_plain`` (the op-by-op prep, the plain walk) on
    the 4,096 x 8 x 256 batch: the d_table bit for bit; each launch counted
    once, and the stage span ``lookup.prep`` timed on the card."""
    g = torch.Generator(device=card["dev"]).manual_seed(2)
    ct = torch.randn((card["idx"].shape[0], 32), generator=g,
                     device=card["dev"])
    args = (ct, card["idx"], card["bank"], card["slot"], card["off"], -1,
            card["n_rows"])
    counts = (TK.scatter_labels.launches, TK.scatter_runs.launches,
              TK.ct_scatter_bag.launches)
    tr = T.Tracer()
    before = T.install(tr)
    try:
        got = TK.ct_scatter_bag(*args)
    finally:
        T.install(before)
    assert (TK.scatter_labels.launches, TK.scatter_runs.launches,
            TK.ct_scatter_bag.launches) == tuple(c + 1 for c in counts)
    want = TK.ct_scatter_bag_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((got != 0).any(dim=1).sum()) > 100_000
    (prep,) = tr.spans("lookup.prep")
    assert tr.device_ms(prep) > 0


def test_card_prep_runs_only_its_own_kernels(card):
    """Inside the prep, the card runs the label kernel, CUB's radix sort and
    the run table, and no op-by-op kernel."""
    args = (card["idx"], card["bank"], card["slot"], card["off"], -1,
            card["n_rows"])
    TK.scatter_prep(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        TK.scatter_prep(*args)
        torch.cuda.synchronize()
    names = {e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA}
    assert any("prep_label" in n for n in names), names
    assert any("DeviceRadixSort" in n for n in names), names
    own = re.compile(r"::prep_(label|count|scan|table)\(|DeviceRadixSort")
    assert all(own.search(n) or n.startswith("Memset") for n in names), \
        names
