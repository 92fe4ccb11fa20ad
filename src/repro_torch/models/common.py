"""Shared model plumbing: initializers.

Both draw from an explicit ``torch.Generator`` on the target device. They
follow the reference's distributions, not its numbers (``jax.random``
cannot be reproduced in torch): parity tests carry the reference's weights
across with ``repro_torch.convert`` instead.
"""
from __future__ import annotations

import math

import torch


def dense_init(generator: torch.Generator, shape, scale: float | None = None,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal fan-in init: a standard normal cut at ±2, times
    ``1/sqrt(fan_in)`` (``shape[0]``, since weights are (in, out))."""
    if scale is None:
        scale = 1.0 / math.sqrt(shape[0])
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (w * scale).to(dtype)


def embed_init(generator: torch.Generator, shape, scale: float = 0.02,
               dtype=torch.float32, device=None) -> torch.Tensor:
    return (torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device) * scale).to(dtype)
