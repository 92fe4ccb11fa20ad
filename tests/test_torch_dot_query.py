"""The interaction kernel's query entry (``kernels/dot_interaction.
dot_features_query``, the model's ``query_features``) and its geometry
pickers, on the CPU: the plain version against the broadcast inputs the
model built before and against the reference's ``concatenate([
dot_interaction(z), x])`` (``repro/models/dlrm.py``); retrieval through the
new route against the reference's ``retrieval_scores``; the gradient
against ``jax.vjp``; the geometry, the wrapper's refusals and the meta
cost.

Tolerances: the plain version builds the broadcast inputs and calls
``dot_features_plain``, so it equals the materialised route bit for bit.
Against the reference: fp32 atol = rtol = 1e-5 (dots summed in another
order than XLA's); bf16 one bf16 step (rtol 2^-8). Retrieval scores rtol
1e-5 / atol 1e-6, as ``tests/test_torch_retrieval.py`` states. Gradients
rtol = atol = 1e-4: each query row's gradient sums N = 48 rows of
cotangent times candidate, in another order than the broadcast graph's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import dlrm as JD
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, statics_from_jax
from repro_torch.kernels import cost as TCOST
from repro_torch.kernels import dot_interaction as TDOT
from repro_torch.launch import roofline as TR
from repro_torch.models import dlrm as TD

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -8, atol=1e-6)}
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
META = torch.device("meta")


def _inputs(n_user, n, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(d).astype(np.float32),
            rng.standard_normal((n_user, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _materialised(x, user, cand):
    n = cand.shape[0]
    emb = torch.cat([user.expand(n, -1, -1), cand[:, None]], dim=1)
    return x.expand(n, -1).contiguous(), emb.contiguous()


def _reference(x, user, cand):
    n = cand.shape[0]
    z = jnp.concatenate([jnp.broadcast_to(x, (n, 1, x.shape[0])),
                         jnp.broadcast_to(user, (n,) + user.shape),
                         cand[:, None]], axis=1)
    return jnp.concatenate([JD.dot_interaction(z),
                            jnp.broadcast_to(x, (n, x.shape[0]))], axis=-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_fields", [2, 3, 9, 27])    # U = F - 2 user rows
def test_query_plain_equals_the_materialised_route(n_fields, dtype):
    """On CPU tensors the wrapper equals ``dot_features_plain`` on the
    broadcast inputs bit for bit, and the reference within tolerance."""
    U, N, D = n_fields - 2, 37, 16
    x, user, cand = _inputs(U, N, D, n_fields)
    dt = getattr(torch, dtype)
    tx, tu, tc = (torch.from_numpy(a).to(dt) for a in (x, user, cand))
    got = TDOT.dot_features_query(tx, tu, tc)
    P = n_fields * (n_fields - 1) // 2
    assert tuple(got.shape) == (N, P + D) and got.dtype == dt
    assert torch.equal(got, TDOT.dot_features_plain(*_materialised(tx, tu,
                                                                   tc)))
    assert torch.equal(got, TDOT.dot_features_query_plain(tx, tu, tc))
    assert torch.equal(TD.query_features(tx, tu, tc), got)
    assert torch.equal(TD.query_features(tx, tu, tc, "torch"), got)
    assert torch.equal(got[:, P:], tx.expand(N, -1))     # x copied as it is
    jdt = getattr(jnp, dtype)
    want = np.asarray(_reference(jnp.asarray(x, jdt), jnp.asarray(user, jdt),
                                 jnp.asarray(cand, jdt)), np.float32)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("n_fields", [3, 9, 27])
def test_query_gradient_matches_jax(n_fields):
    """The Function's backward (no broadcast buffer) against ``jax.vjp``
    of the reference's broadcast expression, and against autograd through
    the materialised plain graph."""
    U, N, D = n_fields - 2, 48, 16
    x, user, cand = _inputs(U, N, D, 3 + n_fields)
    P = n_fields * (n_fields - 1) // 2
    ct = np.random.default_rng(n_fields).standard_normal(
        (N, P + D)).astype(np.float32)
    out, vjp = jax.vjp(_reference, jnp.asarray(x), jnp.asarray(user),
                       jnp.asarray(cand))
    want = vjp(jnp.asarray(ct))
    leaves = [torch.from_numpy(a).requires_grad_(True)
              for a in (x, user, cand)]
    got = TD.query_features(*leaves)
    assert type(got.grad_fn).__name__ == "_DotFeaturesQueryBackward"
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **TOL["float32"])
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)
    xe, ee = _materialised(*leaves)
    old = TD.interaction_features(xe, ee)
    old_grads = torch.autograd.grad(old, leaves, torch.from_numpy(ct))
    for g, w in zip(grads, old_grads):
        torch.testing.assert_close(g, w, **GRAD_TOL)


def test_query_bf16_gradient_keeps_the_dtype():
    x, user, cand = _inputs(3, 6, 8, 1)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
              for a in (x, user, cand)]
    out = TD.query_features(*leaves)
    grads = torch.autograd.grad(out.float().sum(), leaves)
    for g, t in zip(grads, leaves):
        assert g.dtype == torch.bfloat16 and g.shape == t.shape


# ---------------------------------------------------------------------------
# retrieval through the query route
# ---------------------------------------------------------------------------

def _rm2(seed=0):
    jcfg, tcfg = (jax_get_arch("dlrm-rm2").reduced,
                  get_arch("dlrm-rm2").reduced)
    params, statics = JD.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    rng = np.random.default_rng(seed + 1)
    b = {"dense": rng.standard_normal((1, jcfg.n_dense)).astype(np.float32),
         "sparse": np.array([[rng.integers(v) for v in jcfg.vocab_sizes]],
                            np.int32),
         "candidates": rng.integers(0, jcfg.vocab_sizes[0], 200).astype(
             np.int32)}
    b["candidates"][5] = -1
    return jcfg, tcfg, params, statics, tp, ts, b


def test_retrieval_scores_take_the_query_route(monkeypatch):
    """Reduced dlrm-rm2: ``retrieval_scores`` calls the query entry once
    (x (D,), user (U, D), cand (N, D): nothing broadcast to N) and never
    the batch entry; its scores equal the broadcast route's bit for bit and
    the reference's within SCORE_TOL."""
    jcfg, tcfg, params, statics, tp, ts, b = _rm2()
    calls = []
    real = TDOT.dot_features_query_plain

    def spy(x, user, cand):
        calls.append((tuple(x.shape), tuple(user.shape), tuple(cand.shape)))
        return real(x, user, cand)

    def batch_entry(*a, **k):
        raise AssertionError("retrieval called the batch entry")

    monkeypatch.setattr(TDOT, "dot_features_query_plain", spy)
    monkeypatch.setattr(TD, "interaction_features", batch_entry)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    got = TD.retrieval_scores(tcfg, tp, ts, tb)
    N, U, D = len(b["candidates"]), tcfg.n_sparse - 1, tcfg.embed_dim
    assert calls == [((D,), (U, D), (N, D))]
    want = np.asarray(JD.retrieval_scores(
        jcfg, params, statics, {k: jnp.asarray(v) for k, v in b.items()}))
    np.testing.assert_allclose(got.numpy(), want, **SCORE_TOL)

    # the broadcast route the model ran before, on the same stages
    monkeypatch.undo()
    t = TD._banked(tp, ts)
    offs = ts["field_offsets"]
    x = TD.mlp_apply(tp["bot"], tb["dense"])
    eu = TD.banked_gather(t, tb["sparse"][:, 1:] + offs[None, 1:])
    ec = TD.banked_gather(t, tb["candidates"] + offs[0])
    emb = torch.cat([eu.expand(N, -1, -1), ec[:, None]], dim=1)
    old = TD.mlp_apply(tp["top"], TD.interaction_features(
        x.expand(N, -1), emb))[:, 0]
    assert torch.equal(got, old)


def test_retrieval_gradient_reaches_every_leaf():
    """Differentiating the scores through the query route reaches the
    bottom MLP, the top MLP and the table; the gradients equal those of
    the broadcast route within GRAD_TOL."""
    _, tcfg, _, _, tp, ts, b = _rm2(3)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    leaves = [tp["emb_packed"], *tp["bot"]["w"], *tp["top"]["w"]]
    for t in leaves:
        t.requires_grad_(True)
    grads = torch.autograd.grad(TD.retrieval_scores(tcfg, tp, ts, tb).sum(),
                                leaves)
    assert all(bool((g != 0).any()) for g in grads)

    N = len(b["candidates"])
    t = TD._banked(tp, ts)
    offs = ts["field_offsets"]
    x = TD.mlp_apply(tp["bot"], tb["dense"])
    eu = TD.banked_gather(t, tb["sparse"][:, 1:] + offs[None, 1:])
    ec = TD.banked_gather(t, tb["candidates"] + offs[0])
    emb = torch.cat([eu.expand(N, -1, -1), ec[:, None]], dim=1)
    old = TD.mlp_apply(tp["top"], TD.interaction_features(
        x.expand(N, -1), emb))[:, 0]
    for g, w in zip(grads, torch.autograd.grad(old.sum(), leaves)):
        torch.testing.assert_close(g, w, **GRAD_TOL)


# ---------------------------------------------------------------------------
# the geometry pickers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_keeps_rows_per_block_up_to_128_pairs(itemsize):
    """For every P <= 128 (F <= 16) the picker is today's one-row
    geometry with ``rows_per_block``'s rows, at any batch and width."""
    for F in range(1, 17):
        for D in (1, 4, 9, 32, 33, 64, 128):
            for B in (1, 5, 64, 512, 262_144):
                geo = TDOT.dot_geometry(B, F, D, itemsize)
                assert not geo.tiled and geo.threads == 128
                assert geo.rows == TDOT.rows_per_block(B, F, D, itemsize)
                assert geo.smem <= 48 * 1024


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("batch", [512, 262_144, 1_000_000])
def test_geometry_tiles_27_fields(batch, itemsize):
    """F = 27, D = 64: tiles of 8 rows, a thread per row and 4 x 4 field
    block (28 blocks), two buffers within the card's shared memory, small
    enough for two blocks an SM at fp32."""
    geo = TDOT.dot_geometry(batch, 27, 64, itemsize)
    assert geo.tiled and geo.rows == 8 and geo.threads == 8 * 28
    assert geo.smem <= TDOT.SMEM_OPTIN // 2
    row = 27 * 64 * itemsize + 16                      # odd 16-byte units
    assert (row // 16) % 2 == 1
    assert geo.smem == 2 * 8 * row


@pytest.mark.parametrize("shape", [(3, 40, 300), (7, 60, 64), (9, 17, 16),
                                   (4, 88, 8)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_fits_above_128_pairs(shape, itemsize):
    B, F, D = shape
    geo = TDOT.dot_geometry(B, F, D, itemsize)
    nb = -(-F // 4)
    if geo.tiled:
        assert geo.threads == geo.rows * nb * (nb + 1) // 2 <= 256
        assert 1 <= geo.rows <= 8 and geo.smem <= TDOT.SMEM_OPTIN
        assert D * itemsize % 16 == 0
    else:
        assert geo.rows == TDOT.rows_per_block(B, F, D, itemsize)


@pytest.mark.parametrize("itemsize", [4, 2])
def test_geometry_raises_where_one_row_cannot_fit(itemsize):
    with pytest.raises(ValueError, match="shared memory"):
        TDOT.dot_geometry(8, 80, 1024, itemsize)        # tiled: two rows
    with pytest.raises(ValueError, match="shared memory"):
        TDOT.dot_geometry(8, 400, 64, itemsize)         # one-row: 48 KB
    with pytest.raises(ValueError, match="shared memory"):
        TDOT.query_geometry(25, 8192, itemsize)
    with pytest.raises(ValueError, match="shared memory"):
        TDOT.query_geometry(1000, 32, itemsize)         # one output row


@pytest.mark.parametrize("itemsize", [4, 2])
def test_query_geometry(itemsize):
    geo = TDOT.query_geometry(25, 64, itemsize)
    assert geo.tiled and geo.rows == 32 and geo.threads == 32 * 7
    assert geo.smem <= TDOT.SMEM_OPTIN // 2                # two blocks an SM
    for U in (0, 1, 7, 100, 200):
        g = TDOT.query_geometry(U, 32, itemsize)
        assert g.threads == g.rows * -(-(U + 1) // 4) <= 256
        assert g.smem <= TDOT.SMEM_OPTIN


# ---------------------------------------------------------------------------
# the wrapper's refusals and its meta branch
# ---------------------------------------------------------------------------

def _m(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def test_query_wrapper_refuses():
    with pytest.raises(ValueError, match="unsupported device"):
        TDOT.dot_features_query(torch.zeros(8), _m(3, 8), _m(5, 8))
    with pytest.raises(TypeError, match="dtype"):
        TDOT.dot_features_query(_m(8), _m(3, 8, dtype=torch.bfloat16),
                                _m(5, 8))
    with pytest.raises(TypeError, match="dtype"):
        TDOT.dot_features_query(_m(8, dtype=torch.float16),
                                _m(3, 8, dtype=torch.float16),
                                _m(5, 8, dtype=torch.float16))
    with pytest.raises(ValueError, match="contiguous"):
        TDOT.dot_features_query(_m(8), _m(3, 8), _m(8, 5).T)
    for x, user, cand in ((_m(1, 8), _m(3, 8), _m(5, 8)),
                          (_m(8), _m(3, 7), _m(5, 8)),
                          (_m(8), _m(3, 8), _m(5, 9)),
                          (_m(8), _m(3, 8), _m(5, 2, 8)),
                          (torch.zeros(8), torch.zeros(3, 8),
                           torch.zeros(5, 7))):
        with pytest.raises(ValueError, match="must be"):
            TDOT.dot_features_query(x, user, cand)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TD.query_features(torch.zeros(4), torch.zeros(2, 4),
                          torch.zeros(3, 4), backend="cuda")


class _Charges(TR.CostCounter):
    def __init__(self):
        super().__init__()
        self.calls = []

    def charge(self, kernel, nbytes, ops, dtype="float32"):
        super().charge(kernel, nbytes, ops, dtype)
        self.calls.append((kernel, nbytes, ops, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("U,N,D", [(25, 1_000_000, 64), (0, 7, 16),
                                   (1, 3, 8)])
def test_query_meta_cost(U, N, D, dtype):
    """The meta branch: the output's shape and ``dot_features_query_cost``:
    x, the user and candidate rows read once, the output written once; the
    (U+1)U/2 query dots once and U + 1 dots a candidate."""
    isz = torch.empty((), dtype=dtype).element_size()
    with _Charges() as c:
        out = TDOT.dot_features_query(_m(D, dtype=dtype),
                                      _m(U, D, dtype=dtype),
                                      _m(N, D, dtype=dtype))
    F = U + 2
    P = F * (F - 1) // 2
    assert out.shape == (N, P + D) and out.dtype == dtype
    assert out.device.type == "meta"
    nbytes = ((1 + U) * D + N * D + N * (P + D)) * isz
    ops = 2 * D * ((U + 1) * U // 2 + N * (U + 1))
    assert c.calls == [("dot_features_query", nbytes, ops, "float32")]
    assert TCOST.dot_features_query_cost(N, U, D, isz) == (nbytes, ops)
    # less than the batch entry's cost on the broadcast inputs
    fb, fo = TCOST.dot_features_cost(N, F, D, isz)
    assert nbytes < fb and ops <= fo


def test_retrieval_on_meta_charges_the_query_entry():
    """``retrieval_scores`` of reduced dlrm-rm2 on meta tensors charges one
    query-entry call and no batch entry."""
    _, tcfg, _, _, tp, ts, b = _rm2()
    meta = lambda t: torch.empty_like(t, device=META)  # noqa: E731
    mp = {"bot": {k: [meta(w) for w in v] for k, v in tp["bot"].items()},
          "top": {k: [meta(w) for w in v] for k, v in tp["top"].items()},
          "emb_packed": meta(tp["emb_packed"])}
    ms = {k: meta(v) if isinstance(v, torch.Tensor) else v
          for k, v in ts.items()}
    mb = {k: meta(torch.from_numpy(v)) for k, v in b.items()}
    with _Charges() as c:
        out = TD.retrieval_scores(tcfg, mp, ms, mb)
    assert out.shape == (len(b["candidates"]),)
    assert [k for k, *_ in c.calls] == ["dot_features_query"]
