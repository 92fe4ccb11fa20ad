"""The port's identity-layout drop-ins (``repro_torch.kernels.ops``: the bag
sums, their gradient, the fused cache + residual sums and the interaction)
and the examples' multi-hot traces against the JAX package's, on the CPU.

Inputs come from numpy seeds and go through both packages. The reference's
wrappers run its Pallas kernels in interpret mode, at
``tests/test_kernels.py``'s sweep shapes. Tolerances:
- the bag sums and the fused sums add each bag in fp32 in entry order and
  cast once on both sides: equal bit for bit, fp32 and bf16;
- the ``embedding_bag_trainable`` gradient: the port sums each row's
  cotangents in fp32, bag-major, and casts once; the reference's
  ``.at[].add`` adds in the cotangent's dtype in the same order. In fp32
  that is the same arithmetic (bit for bit); in bf16 the reference rounds
  after every add, so atol 0.3, the reference's own bf16 bar;
- the interaction sums each dot in another order: within 1e-5 in fp32, and
  at most one bf16 step (one unit of the bf16 bits) in bf16;
- the traces are numpy on both sides: equal arrays.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synthetic as JS
from repro.kernels import ops as K
from repro_torch.convert import to_tensor
from repro_torch.data import synthetic as TS
from repro_torch.kernels import embedding_bag as TK
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import cache_bag as TCB

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _bits(x):
    """Array -> its fp32 values as numpy (bf16 widens exactly)."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("v,d,b,l", [
    (100, 16, 8, 4), (64, 100, 10, 7), (256, 64, 32, 1), (50, 33, 9, 5),
    (1000, 128, 16, 64), (16, 8, 1, 3),
])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_embedding_bag_matches_jax(v, d, b, l, dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(v + d + b + l)
    table = jnp.array(rng.standard_normal((v, d)), jdt)
    idx = rng.integers(-1, v, (b, l)).astype(np.int32)
    want = K.embedding_bag(table, jnp.asarray(idx), interpret=True)
    got = TOPS.embedding_bag(to_tensor(np.asarray(table), "cpu"),
                             torch.from_numpy(idx))
    assert got.dtype == tdt and tuple(got.shape) == (b, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("v,nc,d,b,lc,lr,dtypes", [
    (80, 20, 24, 12, 3, 6, DTYPES[0]), (40, 5, 8, 8, 1, 1, DTYPES[0]),
    (200, 64, 32, 16, 8, 20, DTYPES[0]), (80, 20, 33, 12, 3, 6, DTYPES[1]),
], ids=["f32-24", "f32-8", "f32-32", "bf16-33"])
def test_cache_bag_matches_jax(v, nc, d, b, lc, lr, dtypes):
    """The fused identity lookup, with a cache table kept in fp32 that both
    sides cast to the EMT's dtype first."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(v + d)
    emt = jnp.array(rng.standard_normal((v, d)), jdt)
    cache = rng.standard_normal((nc, d)).astype(np.float32)
    ci = rng.integers(-1, nc, (b, lc)).astype(np.int32)
    ri = rng.integers(-1, v, (b, lr)).astype(np.int32)
    ri[0] = -1                                    # an all-pad residual bag
    want = K.cache_bag(emt, jnp.asarray(cache), jnp.asarray(ci),
                       jnp.asarray(ri), interpret=True)
    args = (to_tensor(np.asarray(emt), "cpu"), torch.from_numpy(cache),
            torch.from_numpy(ci), torch.from_numpy(ri))
    got = TOPS.cache_bag(*args)
    assert got.dtype == tdt and tuple(got.shape) == (b, d)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the re-export is the same function
    np.testing.assert_array_equal(_bits(TCB.plain_cache_bag(*args)),
                                  _bits(want))


@pytest.mark.parametrize("b,f,d", [
    (16, 27, 64), (8, 5, 10), (128, 40, 10), (8, 2, 64),
])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_dot_interaction_matches_jax(b, f, d, dtypes):
    jdt, tdt = dtypes
    rng = np.random.default_rng(b + f + d)
    z = jnp.array(rng.standard_normal((b, f, d)), jdt)
    want = K.dot_interaction(z, tile_b=8, interpret=True)
    got = TOPS.dot_interaction(to_tensor(np.asarray(z), "cpu"))
    assert got.dtype == tdt and tuple(got.shape) == (b, f * (f - 1) // 2)
    if tdt == torch.float32:
        np.testing.assert_allclose(_bits(got), _bits(want), rtol=1e-5,
                                   atol=1e-5)
    else:       # both round an fp32 dot once: at most one bf16 step apart
        steps = np.abs(got.view(torch.int16).numpy().astype(np.int32)
                       - np.asarray(want).view(np.int16).astype(np.int32))
        assert steps.max() <= 1


def _grads(table_np, idx, jdt, tdt):
    """d/dtable of sum(bag_sums ** 2) through both packages."""
    table = jnp.asarray(table_np, jdt)

    def loss(t):
        return (K.embedding_bag_trainable(t, jnp.asarray(idx)) ** 2).sum()

    want = jax.grad(loss)(table)
    t = to_tensor(np.asarray(table), "cpu").requires_grad_(True)
    out = TOPS.embedding_bag_trainable(t, torch.from_numpy(idx))
    (got,) = torch.autograd.grad((out ** 2).sum(), [t])
    return got, want


@pytest.mark.parametrize("case", ["sweep", "collisions"])
@pytest.mark.parametrize("dtypes", DTYPES, ids=["float32", "bfloat16"])
def test_embedding_bag_trainable_grads_match_jax(case, dtypes):
    """The gradient by the sorted-run scatter on the identity prep against
    the reference's XLA scatter: ``test_embedding_bag_trainable_grads``'s
    case, and a row repeated inside and across bags with a hole."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(5)
    table = rng.standard_normal((50, 16)).astype(np.float32)
    idx = rng.integers(-1, 50, (8, 4)).astype(np.int32)
    if case == "collisions":
        idx[:, 0] = 3
        idx[0, 1:4] = 3
        idx[2, 2] = -1
    got, want = _grads(table, idx, jdt, tdt)
    assert got.dtype == tdt and tuple(got.shape) == table.shape
    if tdt == torch.float32:
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        np.testing.assert_allclose(_bits(got), _bits(want), atol=0.3)
    assert (_bits(got)[3] != 0).all()


def test_identity_scatter_is_bag_major():
    """The identity prep enumerates entries bag-major and drops holes and
    ids past the table; its runs keep that order inside each row."""
    idx = torch.tensor([[2, -1, 2], [0, 2, 7]], dtype=torch.int32)
    runs = TK.identity_scatter_prep(idx, 5)
    assert int(runs.n_run[0]) == 2
    n = int(runs.run_starts[2])
    assert runs.run_slot[:2].tolist() == [0, 2]
    assert runs.bag_sorted[:n].tolist() == [1, 0, 0, 1]
    # each sorted entry's run; the dead entries after them keep the last
    assert runs.run_of.tolist() == [0, 1, 1, 1, 1, 1]
    ct = torch.tensor([[1.0], [10.0]])
    got = TK.ct_scatter_identity(ct, idx, 5)
    assert got[:, 0].tolist() == [10.0, 0.0, 12.0, 0.0, 0.0]
    torch.testing.assert_close(TK.ct_scatter_identity_plain(ct, idx, 5), got,
                               rtol=0, atol=0)


@pytest.mark.parametrize("name,n,n_items,seed", [
    ("read", 40, 5_000, 0), ("clo", 25, 800, 3), ("meta2", 6, 120_000, 1),
])
def test_multihot_trace_and_padded_bags_match_jax(name, n, n_items, seed):
    """The cdf draw gives the reference's ``rng.choice`` bags, and the
    padding (with bags longer than ``pad_to`` cut) the same arrays."""
    want = JS.multihot_trace(JS.WORKLOADS[name], n, seed=seed,
                             n_items=n_items)
    got = TS.multihot_trace(TS.WORKLOADS[name], n, seed=seed,
                            n_items=n_items)
    assert len(got) == len(want) == n
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    pad = int(np.median([len(b) for b in want]))
    np.testing.assert_array_equal(TS.padded_bags(got, pad),
                                  JS.padded_bags(want, pad))


def test_plain_versions_of_the_drop_ins_on_the_cpu():
    """On CPU tensors the wrappers are their plain versions, and the plain
    versions agree with the oracles within fp32 reordering."""
    from repro_torch.kernels import ref as TREF
    g = torch.Generator().manual_seed(2)
    table = torch.randn((30, 12), generator=g)
    cache = torch.randn((7, 12), generator=g)
    idx = torch.randint(-1, 30, (9, 5), generator=g, dtype=torch.int32)
    ci = torch.randint(-1, 7, (9, 3), generator=g, dtype=torch.int32)
    assert torch.equal(TK.plain_bag(table, idx), TK.plain_bag_plain(table,
                                                                    idx))
    torch.testing.assert_close(TK.plain_bag_plain(table, idx),
                               TREF.embedding_bag_ref(table, idx))
    assert torch.equal(TK.plain_cache_bag(table, cache, ci, idx),
                       TK.plain_cache_bag_plain(table, cache, ci, idx))
    torch.testing.assert_close(TK.plain_cache_bag_plain(table, cache, ci, idx),
                               TREF.cache_bag_ref(table, cache, ci, idx))
