"""The port's pairwise-dot interaction against the JAX package's Pallas
kernel (interpret mode) and its model einsum, on the CPU.

Tolerance: atol = rtol = 1e-5 in fp32 — the dots are summed in another
order than XLA's, so they agree to fp32 rounding, not bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import dlrm as JD
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                 dot_interaction_plain)
from repro_torch.models import dlrm as TD

TOL = dict(rtol=1e-5, atol=1e-5)


def _z(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(8, 9, 8), (16, 27, 64), (8, 2, 64)])
def test_plain_matches_pallas_and_model(shape):
    z = _z(shape)
    got = dot_interaction_plain(torch.from_numpy(z))
    B, F, _ = shape
    assert tuple(got.shape) == (B, F * (F - 1) // 2)
    assert got.dtype == torch.float32
    kernel = JOPS.dot_interaction(jnp.asarray(z), interpret=True)
    model = JD.dot_interaction(jnp.asarray(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(model), **TOL)
    # on CPU tensors the wrapper and the model's entry take the plain version
    np.testing.assert_array_equal(dot_interaction(torch.from_numpy(z)).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(TD.dot_interaction(torch.from_numpy(z)).numpy(),
                                  got.numpy())


@pytest.mark.parametrize("shape", [(8, 9, 8), (4, 5, 16)])
def test_ref_matches_jax_ref(shape):
    z = _z(shape, seed=1)
    np.testing.assert_allclose(
        TREF.dot_interaction_ref(torch.from_numpy(z)).numpy(),
        np.asarray(JREF.dot_interaction_ref(jnp.asarray(z))), **TOL)


def test_bf16_matches_model():
    """bf16 in, bf16 out, fp32 dots: the two round once, at the end, and may
    land one bf16 step apart (2^-8 relative)."""
    z = _z((8, 9, 8), seed=2)
    zj = jnp.asarray(z, jnp.bfloat16)
    zt = torch.from_numpy(z).to(torch.bfloat16)
    got = dot_interaction_plain(zt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(JD.dot_interaction(zj), np.float32),
                               rtol=2 ** -8, atol=1e-6)


def test_cuda_backend_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TD.dot_interaction(torch.zeros(2, 3, 4), backend="cuda")
