#!/usr/bin/env python3
"""gloo all-reduce of CUDA tensors among four ranks sharing card 0: gloo's
own CUDA path against staging through a host copy (pageable, and pinned).

    python3 tools/allreduce_probe.py

For 64 KB (the bank sum of phase 15's serve step), 1 MB, 64 MB and 600 MB
of fp32 (half a 2-bank full-width table-shard gradient), each rank times
``all_reduce`` with a barrier and a sync before and a sync after, median
of 20 calls (3 above 1 MB), and the script prints each rank's ms. Through
``repro_torch.dist.launch.run_ranks`` under ``build/allreduce_probe``.
"""
from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SIZES = (512 * 32, 1 << 18, 1 << 24, 150_000_000)


def rank_fn(rank, world, inputs):
    import numpy as np
    import torch
    import torch.distributed as tdist
    torch.cuda.set_device(0)
    out = {}
    for n in SIZES:
        x = torch.ones(n, device="cuda")
        reps = 20 if n < 1 << 20 else 3
        for how in ("native", "staged", "staged_pinned"):
            ts = []
            for _ in range(reps + 1):                 # the first is warm-up
                tdist.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if how == "native":
                    y = x.clone()
                    tdist.all_reduce(y)
                elif how == "staged":
                    h = x.cpu()
                    tdist.all_reduce(h)
                    y = h.to("cuda")
                else:
                    h = torch.empty(n, pin_memory=True)
                    h.copy_(x)
                    tdist.all_reduce(h)
                    y = h.to("cuda", non_blocking=True)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            out[f"{how}_{n}"] = np.array(np.median(ts[1:]))
        del y
    return out


def main() -> int:
    from repro_torch.dist.launch import run_ranks
    work = ROOT / "build" / "allreduce_probe"
    shutil.rmtree(work, ignore_errors=True)
    outs = run_ranks(rank_fn, 4, work, backend="gloo", timeout=600)
    shutil.rmtree(work, ignore_errors=True)
    for k in outs[0]:
        print(f"{k} ms:", [round(float(o[k]), 3) for o in outs])
    return 0


if __name__ == "__main__":
    sys.exit(main())
