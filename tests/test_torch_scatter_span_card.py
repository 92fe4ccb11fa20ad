"""The sorted-run scatter's span blocks on the card (``csrc/ct_scatter.cu``:
runs of more than 64 entries, streamed through a ring of ``cp.async``
stages under full/empty mbarriers) against ``ct_scatter_runs_plain``, bit
for bit (``torch.equal``): ``paper-train``'s hottest run and one of 2^21
entries, ``paper-train``'s Zipf stream at batch 8,192, runs around the
short/long threshold, a span block that starts the most long runs it can,
runs and streams that end on a stage's boundary and inside a stage, the
four cotangent/output dtype mixes and D in {8, 12, 20, 24, 28, 32, 40, 56,
64, 128} (a pass's row in 1 to 8 pieces of 16 bytes, 3, 5, 6 and 7 among
them), and rows that are not 16-byte pieces (the loads-and-stores copy).

Needs a CUDA card (skips without one). On the card, from the root of the
repo:

    PYTHONPATH=src python -m pytest -q tests/test_torch_scatter_span_card.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import embedding_bag as K

SHORT_MAX = 64          # ct_scatter.cu's kShortMax: longer runs are spans'
SPAN = 1024             # kSpan: sorted entries a span block owns
MAX_LONG = SPAN // (SHORT_MAX + 1) + 1      # kMaxLong: 16
# updlrm-paper: 8 fields of 2,360,650 rows on 8 banks; paper-train's bags
F, PER_FIELD, N_BANKS, L = 8, 2_360_650, 8, 256
HOTTEST = 2_773_494     # paper-train's hottest run: 65,536 x 243.3 x 0.1739
MIXES = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
         (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stream(lens, dev, nb, n_rows, seed, rows=None):
    """The identity prep of an (nb, 1) id stream in which run r holds
    ``lens[r]`` entries on row ``rows[r]`` (random distinct rows if None;
    the runs then sort by row), in random entry order; -1 elsewhere. Each
    entry is its own bag, so every entry adds another cotangent row."""
    rng = np.random.default_rng(seed)
    lens = np.asarray(lens)
    if rows is None:
        rows = rng.choice(n_rows, size=lens.size, replace=False)
    ids = np.full(nb, -1, np.int32)
    ids[rng.choice(nb, size=int(lens.sum()), replace=False)] = \
        rng.permutation(np.repeat(rows, lens).astype(np.int32))
    return K.identity_scatter_prep(torch.from_numpy(ids[:, None]).to(dev),
                                   n_rows)


def _check(ct, runs, n_rows, out_dtype, what):
    """The kernel against the plain version on the same runs, bit for bit,
    and one launch counted."""
    d = ct.shape[1]
    n0 = K.ct_scatter_bag.launches
    got = K.ct_scatter_launch(ct, runs, torch.zeros(
        (n_rows, d), dtype=out_dtype, device=ct.device))
    torch.cuda.synchronize()
    assert K.ct_scatter_bag.launches == n0 + 1
    want = K.ct_scatter_runs_plain(ct, runs, torch.zeros(
        (n_rows, d), dtype=out_dtype, device=ct.device))
    err = (got.float() - want.float()).abs().max().item()
    assert torch.equal(got, want), f"{what}: kernel != plain ({err})"
    assert want.abs().sum().item() > 0, f"{what}: an all-zero gradient"


def _lens(runs):
    n = int(runs.n_run[0])
    return (runs.run_starts[1:n + 1] - runs.run_starts[:n]).long()


@pytest.mark.parametrize("n", [HOTTEST, 1 << 21], ids=["hottest", "2^21"])
def test_one_long_run(dev, n):
    """One run over a ring of 16 stages many thousand times; each entry
    its own cotangent row, so a stage added out of order changes bits."""
    runs = _stream([n], dev, n + 77, 1000, seed=n)
    assert int(_lens(runs).max()) == n
    g = torch.Generator(device=dev).manual_seed(3)
    ct = torch.randn((n + 77, 32), generator=g, device=dev)
    _check(ct, runs, 1000, torch.float32, f"one run of {n}")


def _zipf_bags(batch, dev, seed=1, a=1.18, mean=245.8):
    """(batch * F, L) int32: paper-train's ids, per-field Zipf(a) ranks
    permuted over the rows, Poisson(mean) bag lengths cut to [1, L], the
    tail -1."""
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


def test_paper_train_zipf_stream(dev):
    """paper-train's ids at batch 8,192 (16.8 M entries), the card's prep
    over 8 banks: the hot rows' runs of ~10^5 entries beside every other
    length, tiles and span blocks at once."""
    g = torch.Generator(device=dev).manual_seed(0)
    V = F * PER_FIELD
    per = -(-V // N_BANKS) + 1000
    slot = torch.randperm(N_BANKS * per, generator=g, device=dev)[:V]
    bank, slot = (slot // per).to(torch.int32), slot.to(torch.int32)
    n_rows = N_BANKS * per
    off = torch.arange(F, dtype=torch.int32, device=dev) * PER_FIELD
    idx = _zipf_bags(8192, dev)
    runs = K.scatter_prep(idx, bank, slot, off, -1, n_rows)
    lens = _lens(runs)
    assert int(lens.max()) > 100_000
    assert int(lens[lens > SHORT_MAX].sum()) > 0.5 * int(lens.sum())
    ct = torch.randn((idx.shape[0], 32), generator=g, device=dev)
    _check(ct, runs, n_rows, torch.float32, "paper-train Zipf, batch 8,192")


# Run layouts, each an identity prep: (lens, nb, n_rows, rows or None)
LAYOUTS = {
    # runs of 64 (tiles), 65 and 66 (spans) and a few short ones around them
    "around kShortMax": (
        [SHORT_MAX, SHORT_MAX + 1, SHORT_MAX + 2] * 30 + [1, 2, 3] * 40,
        40_000, 5_000, None),
    # rows 0..39 hold 65 entries each, back to back from sorted entry 0, so
    # the first span block starts 16 long runs, the most it can
    "kMaxLong runs in one span": (
        [SHORT_MAX + 1] * 40 + [1] * 100, 8_000, 300, np.arange(140)),
    # the first span block lays runs 0..4 end to end: they end at 96 (a
    # stage's boundary), 196 (inside a stage), 320 and 448 (boundaries),
    # and its stream at 4,448 (139 stages); the 5,000-entry run wraps the
    # ring and ends its block's stream inside a stage, as does the last
    "ends on and inside stages": (
        [96, 100, 124, 128, 4000, 5000, 77], 20_000, 7, np.arange(7)),
}


@pytest.mark.parametrize("d", [8, 12, 20, 24, 28, 32, 40, 56, 64, 128])
@pytest.mark.parametrize("mix", MIXES, ids=["f32-f32", "f32-bf16",
                                            "bf16-f32", "bf16-bf16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_span_layouts(dev, layout, mix, d):
    lens, nb, n_rows, rows = LAYOUTS[layout]
    runs = _stream(lens, dev, nb, n_rows, seed=len(layout), rows=rows)
    assert int((_lens(runs) > SHORT_MAX).sum()) == sum(
        n > SHORT_MAX for n in lens)
    if layout == "kMaxLong runs in one span":
        assert int((runs.run_starts[:40] < SPAN).sum()) == MAX_LONG
    g = torch.Generator(device=dev).manual_seed(d)
    ct = torch.randn((nb, d), generator=g, device=dev).to(mix[0])
    _check(ct, runs, n_rows, mix[1], f"{layout}, D={d}, {mix}")


@pytest.mark.parametrize("case", ["D=33", "ct 8 bytes off 16"])
@pytest.mark.parametrize("mix", MIXES[:1] + MIXES[2:3],
                         ids=["f32-f32", "bf16-f32"])
def test_rows_not_16_byte_pieces(dev, case, mix):
    """Rows a cp.async piece cannot copy (an odd width, or a cotangent
    whose base is not 16-byte aligned) take the loads-and-stores copy."""
    lens, nb, n_rows, rows = LAYOUTS["ends on and inside stages"]
    runs = _stream(lens, dev, nb, n_rows, seed=5, rows=rows)
    d = 33 if case == "D=33" else 32
    g = torch.Generator(device=dev).manual_seed(7)
    flat = torch.randn((nb * d + 8,), generator=g, device=dev).to(mix[0])
    shift = 0 if case == "D=33" else 8 // flat.element_size()
    ct = flat[shift:shift + nb * d].view(nb, d)
    if case != "D=33":
        assert ct.data_ptr() % 16 != 0
    _check(ct, runs, n_rows, mix[1], f"{case}, {mix}")
