"""The port's fused interaction (``kernels/dot_interaction.dot_features``,
the model's ``interaction_features``) against the reference model's
``concatenate([dot_interaction(concatenate([x[:, None], emb])), x])``
(``repro/models/dlrm.py``), on the CPU.

Tolerances: fp32 atol = rtol = 1e-5 (the dots are summed in another order
than XLA's); bf16 one bf16 step (rtol 2^-8: both round one fp32 dot once);
gradients the same rtol = atol = 1e-5 (each is a sum of F - 1 products of
a dot, up to ~10 at D = 64, and z, taken in another order, that cancels
towards 0). The x columns are copies, bit for bit, and the gradients equal
the unfused graph's bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import dlrm as JD
from repro_torch.configs import get_arch
from repro_torch.core.embedding import BankedTable
from repro_torch.kernels import dot_interaction as TDOT
from repro_torch.models import dlrm as TD

SHAPES = [(64, 9, 32), (8, 27, 64), (5, 2, 16)]      # (B, F, D), F counts x
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2 ** -8, atol=1e-6)}


def _reference(x, emb):
    z = jnp.concatenate([x[:, None], emb], axis=1)
    return jnp.concatenate([JD.dot_interaction(z), x], axis=-1)


def _inputs(shape, seed):
    B, F, D = shape
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, D)).astype(np.float32),
            rng.standard_normal((B, F - 1, D)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_features_plain_matches_reference(shape, dtype):
    x, emb = _inputs(shape, sum(shape))
    B, F, D = shape
    P = F * (F - 1) // 2
    want = np.asarray(_reference(jnp.asarray(x, getattr(jnp, dtype)),
                                 jnp.asarray(emb, getattr(jnp, dtype))),
                      np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    te = torch.from_numpy(emb).to(getattr(torch, dtype))
    got = TDOT.dot_features_plain(tx, te)
    assert tuple(got.shape) == (B, P + D) == want.shape
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])
    assert torch.equal(got[:, P:], tx)                 # x copied as it is
    # on CPU tensors the wrapper and the model's entry take the plain version
    assert torch.equal(TDOT.dot_features(tx, te), got)
    assert torch.equal(TD.interaction_features(tx, te), got)
    assert torch.equal(TD.interaction_features(tx, te, "torch"), got)


@pytest.mark.parametrize("backend", ["auto", "torch"])
@pytest.mark.parametrize("shape", SHAPES)
def test_features_gradient_matches_jax(shape, backend):
    """Both inputs' gradients against ``jax.vjp`` of the reference
    expression; and bit for bit the gradients of the unfused graph (cat,
    ``dot_interaction``, cat) that the model ran before."""
    x, emb = _inputs(shape, 7 + sum(shape))
    B, F, D = shape
    ct = np.random.default_rng(3).standard_normal(
        (B, F * (F - 1) // 2 + D)).astype(np.float32)
    out, vjp = jax.vjp(_reference, jnp.asarray(x), jnp.asarray(emb))
    want_x, want_e = vjp(jnp.asarray(ct))
    tx = torch.from_numpy(x).requires_grad_(True)
    te = torch.from_numpy(emb).requires_grad_(True)
    got = TD.interaction_features(tx, te, backend)
    assert type(got.grad_fn).__name__ == "_DotFeaturesBackward"
    gx, ge = torch.autograd.grad(got, [tx, te], torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                               **TOL["float32"])
    np.testing.assert_allclose(gx.numpy(), np.asarray(want_x), **TOL["float32"])
    np.testing.assert_allclose(ge.numpy(), np.asarray(want_e), **TOL["float32"])

    z = torch.cat([tx[:, None], te], dim=1)
    old = torch.cat([TD.dot_interaction(z, backend), tx], dim=-1)
    ox, oe = torch.autograd.grad(old, [tx, te], torch.from_numpy(ct))
    assert torch.equal(old.detach(), got.detach())
    assert torch.equal(ox, gx) and torch.equal(oe, ge)


def test_features_bf16_gradient_keeps_the_dtype():
    x, emb = _inputs((4, 5, 8), 1)
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    te = torch.from_numpy(emb).to(torch.bfloat16).requires_grad_(True)
    out = TD.interaction_features(tx, te)
    gx, ge = torch.autograd.grad(out.float().sum(), [tx, te])
    assert gx.dtype == ge.dtype == torch.bfloat16
    assert gx.shape == tx.shape and ge.shape == te.shape


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TD.interaction_features(torch.zeros(2, 4), torch.zeros(2, 3, 4),
                                backend="cuda")


def _model(seed=0):
    cfg = get_arch("updlrm-paper").reduced
    params, statics = TD.init_params(cfg, torch.Generator().manual_seed(seed),
                                     device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    B, F, L = 6, cfg.n_sparse, cfg.multi_hot
    sparse = torch.randint(-1, 300, (B, F, L), generator=g, dtype=torch.int32)
    dense = torch.randn((B, cfg.n_dense), generator=g)
    return cfg, params, statics, {"dense": dense, "sparse": sparse}


def test_forward_paths_go_through_the_fused_function(monkeypatch):
    """``forward`` and ``forward_cached`` build the top MLP's input with one
    call of the fused entry (its plain version on the CPU) and never with
    ``dot_interaction``; their logits equal the unfused graph's on the same
    stages bit for bit, and a loss reaches the table and the bottom MLP."""
    cfg, params, statics, batch = _model()
    B, F, L = batch["sparse"].shape
    D = cfg.embed_dim
    cache = BankedTable(torch.randn((16, D),
                                    generator=torch.Generator().manual_seed(4)),
                        torch.zeros(16, dtype=torch.int32),
                        torch.arange(16, dtype=torch.int32), 1, 16)
    g = torch.Generator().manual_seed(5)
    cached_batch = {
        "dense": batch["dense"],
        "cache_idx": torch.randint(-1, 16, (B, F, 3), generator=g,
                                   dtype=torch.int32),
        "residual_idx": torch.randint(-1, 300, (B, F, 5), generator=g,
                                      dtype=torch.int32)}
    runs = {"forward": lambda: TD.forward(cfg, params, statics, batch),
            "forward_cached": lambda: TD.forward_cached(
                cfg, params, statics, cache, cached_batch)}

    calls = []
    real_plain = TDOT.dot_features_plain

    def spy(x, emb):
        calls.append((x, emb))
        return real_plain(x, emb)

    real_dot = TD.dot_interaction

    def unfused(*a, **k):
        raise AssertionError("the model called the unfused interaction")

    monkeypatch.setattr(TDOT, "dot_features_plain", spy)
    monkeypatch.setattr(TD, "dot_interaction", unfused)
    for name, run in runs.items():
        got = run()
        assert len(calls) == 1, name
        x, emb = calls.pop()
        assert tuple(x.shape) == (B, D) and tuple(emb.shape) == (B, F, D)
        z = torch.cat([x[:, None], emb], dim=1)
        want = TD.mlp_apply(params["top"], torch.cat(
            [real_dot(z), x], dim=-1))[:, 0]
        assert torch.equal(got, want), name

    leaves = [params["emb_packed"], *params["bot"]["w"]]
    for t in leaves:
        t.requires_grad_(True)
    loss = TD.loss_fn(cfg, params, statics, {**batch, "label": torch.ones(B)})
    assert len(calls) == 1
    grads = torch.autograd.grad(loss, leaves)
    assert all(bool((gr != 0).any()) for gr in grads)


@pytest.mark.parametrize("shape", [(64, 9, 32), (3, 40, 300), (5, 2, 16),
                                   (1, 1, 4), (200, 27, 64)])
@pytest.mark.parametrize("itemsize", [4, 2])
def test_rows_per_block_fit_the_block(shape, itemsize):
    B, F, D = shape
    rpb = TDOT.rows_per_block(B, F, D, itemsize)
    row = -(-F * D * itemsize // 16) * 16
    assert 1 <= rpb <= max(B, 1)
    assert rpb * row <= 48 * 1024
    with pytest.raises(ValueError, match="shared memory"):
        TDOT.rows_per_block(B, 400, 64, itemsize)
