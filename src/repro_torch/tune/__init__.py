"""Kernel autotuner + shape-specialized dispatch (the port of
``repro/tune``).

``dispatch`` — the persisted per-call-signature decision cache
(``TUNE_dispatch_cuda.json``) that ``backend='tuned'`` lookups in
``core/embedding.py`` resolve through on every call.

``autotune`` — the sweep that produces it: time every (backend, tile_b,
n_slots) candidate per signature on the card and record the winner.
"""
from repro_torch.tune.dispatch import (CallSignature, Decision, DispatchCache,
                                       decide, default_cache_path, get_cache,
                                       set_cache, signature)

__all__ = [
    "CallSignature",
    "Decision",
    "DispatchCache",
    "decide",
    "default_cache_path",
    "get_cache",
    "set_cache",
    "signature",
]
