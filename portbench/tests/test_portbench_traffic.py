"""Each traffic mix is deterministic in the seed, and every seed asks for
the same work in another order."""
import numpy as np
import pytest
import torch

from portbench import drive
from portbench import generate as G
from portbench.tests.small import CELLS, small_parts

SEED = 2_147_483_659          # above 2**31: seeds may not fit 32 signed bits


def _traffic(p, mix=None):
    gen = drive.load("generators", p.mix["generator"])
    return gen.Traffic(p.cfg, mix or p.mix, "cpu")


def _batch(p, seed, index=0):
    return _traffic(p).batch(seed, index, p.mix["batch"])


@pytest.mark.parametrize("cell", CELLS)
def test_mix_is_deterministic_in_the_seed(cell):
    p = small_parts(cell)
    a, b, c = _batch(p, SEED), _batch(p, SEED), _batch(p, SEED + 1)
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["sparse"], c["sparse"])
    assert not torch.equal(a["dense"], c["dense"])
    # the same work under another seed: as many live entries, per bag
    # length the same count
    live = [(x["sparse"] >= 0).reshape(x["sparse"].shape[0] *
                                        x["sparse"].shape[1], -1).sum(1)
            for x in (a, c)] if a["sparse"].dim() == 3 else None
    if live is not None:
        assert torch.equal(torch.sort(live[0]).values,
                           torch.sort(live[1]).values)
    # every id inside its field's vocabulary, -1 only as padding
    sp = a["sparse"] if a["sparse"].dim() == 3 else a["sparse"][..., None]
    for f, v in enumerate(p.cfg["vocab_sizes"]):
        x = sp[:, f]
        assert int(x.max()) < v and int(x.min()) >= -1


@pytest.mark.parametrize("cell", CELLS)
def test_weights_are_deterministic_in_the_seed(cell):
    p = small_parts(cell)
    make = drive.load("reference", p.cfg["reference"]).make_weights
    w1, w2 = (make(p.cfg, SEED, "cpu") for _ in range(2))
    w3 = make(p.cfg, SEED + 1, "cpu")
    assert torch.equal(w1["table"], w2["table"])
    assert not torch.equal(w1["table"], w3["table"])
    assert w1["table"].dtype == getattr(torch, p.cfg["emb_dtype"])
    for m in ("bot", "top"):
        for k in ("w", "b"):
            for x, y in zip(w1[m][k], w2[m][k]):
                assert torch.equal(x, y)


def test_catalog_is_the_mix_s():
    p = small_parts("paper-bulk")
    a = _traffic(p).popularity()
    b = _traffic(p).popularity()
    np.testing.assert_array_equal(a, b)
    other = dict(p.mix["ids"], catalog_seed=p.mix["ids"]["catalog_seed"] + 1)
    c = _traffic(p, dict(p.mix, ids=other)).popularity()
    assert not np.array_equal(a, c)


def test_popularity_is_the_draws_pmf():
    p = small_parts("paper-bulk")
    ids = _traffic(p)
    pop = ids.popularity()
    V = p.cfg["vocab_sizes"][0]
    assert pop.shape == (sum(p.cfg["vocab_sizes"]),)
    np.testing.assert_allclose(pop[:V].sum(), 1.0, rtol=1e-12)
    g = G.generator(SEED, 99, "cpu")
    x = ids.draw(0, (200_000,), g).numpy()
    hot = np.argsort(-pop[:V])[:5]
    freq = np.bincount(x, minlength=V) / x.size
    np.testing.assert_allclose(freq[hot], pop[hot], rtol=0.05)
