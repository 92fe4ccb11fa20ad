"""Fused cache + EMT bag lookup (paper Fig. 7) over unbanked tables: the
single-table entry point, both tables in the identity layout (the port of
``repro/kernels/cache_bag.py``). The banked flavour is
``embedding_bag.cache_residual_bag``, called with real remaps by
``core/embedding.banked_cache_residual_bag``."""
from __future__ import annotations

from repro_torch.kernels.embedding_bag import (  # noqa: F401
    plain_cache_bag, plain_cache_bag_plain)
