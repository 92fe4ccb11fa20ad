"""Autotune CLI: sweep the bag kernels' launch geometries on the card and
write the dispatch cache (``TUNE_dispatch_cuda.json``) that
``backend='tuned'`` lookups resolve through (the port of
``repro/launch/tune.py``).

Usage::

    python -m repro_torch.launch.tune              # full sweep -> repo root
    python -m repro_torch.launch.tune --smoke --out /tmp/t.json
    python -m repro_torch.launch.tune --smoke --out t.json --device cpu

Smoke mode keeps the SAME signature suite as the full run (the cache's
entry keys are its schema) but times fewer candidates. ``--device cpu``
records the plain version's one decision per signature (``'torch'``),
which CUDA tensors refuse.

After the sweep the CLI SELF-CHECKS the file it wrote: reloads it, installs
it as the process cache, and verifies every recorded signature resolves to
exactly the recorded decision.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch import resolve_device
from repro_torch.tune.dispatch import (CACHE_BASENAME, DispatchCache,
                                       _repo_root, set_cache)


def self_check(cache: DispatchCache, path: str) -> list[str]:
    """Reload ``path``, install it as the process cache and return the keys
    whose decision did not round-trip (every key, when the key sets
    differ); an empty list is a pass. The process cache is reset after."""
    reloaded = DispatchCache.load(path)
    set_cache(reloaded)
    try:
        want = cache.decisions()
        got = reloaded.decisions()
        if sorted(want) != sorted(got):
            return sorted(set(want) ^ set(got))
        return [k for k in want
                if (want[k].backend, want[k].tile_b, want[k].n_slots)
                != (got[k].backend, got[k].tile_b, got[k].n_slots)]
    finally:
        set_cache(None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="kernel autotuner -> TUNE_dispatch_cuda.json")
    ap.add_argument("--out", default=None,
                    help="output path (default: TUNE_dispatch_cuda.json at "
                         "the repo root, the committed location)")
    ap.add_argument("--smoke", action="store_true",
                    help="same signature suite, fewer candidates")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timing repeats per candidate (default: the "
                         "median of 20 launches on the card; best of 3, "
                         "smoke 2, on the CPU)")
    ap.add_argument("--arch", default=None,
                    help="label recorded in the cache meta (default: the "
                         "card's name and power limit from nvidia-smi, or "
                         "'cpu')")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' (the plain "
                         "versions on the host)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from repro_torch.tune.autotune import tune

    out = args.out or os.path.join(_repo_root(), CACHE_BASENAME)
    cache = tune(smoke=args.smoke, repeats=args.repeats, arch=args.arch,
                 device=dev)
    cache.save(out)
    print(f"wrote {out}: {len(cache.entries)} entries (meta {cache.meta})")
    bad = self_check(cache, out)
    if bad:
        print(f"self-check FAILED: round-trip decisions diverge ({bad})",
              file=sys.stderr)
        return 1
    print(f"self-check OK: {len(cache.entries)} decisions round-trip "
          f"bit-exact")
    return 0


if __name__ == "__main__":
    sys.exit(main())
