#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one
process (the benchmark's own runs do not run this):

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--out FILE]

For each seed: one run of the cell as ``run.py`` makes it, with a window
of ``--seconds`` at the cell's own load, then

- ``program``: the numbers the run compares (the timed path's outputs
  against the reference), the lower reading;
- each of the mode's ``CONTROLS`` (``portbench/modes/<mode>.py``): the
  same numbers with the reference so computed in the program's place
  (``control``: in TF32, where the configurations state fp32 with TF32
  off; ``half_batch``: half of each batch left out, the mean taken over
  the rest), the upper readings.

A line of JSON a seed, on standard output and appended to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1] / "src"),
                str(Path(__file__).resolve().parents[1])]

from portbench import drive  # noqa: E402
from portbench.run import cell_parts, forbidden_modules  # noqa: E402


def readings(name: str, seed: int, seconds: float, device="cuda") -> dict:
    import torch
    parts = cell_parts(name)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(parts.cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(parts.cfg["tf32"])
    mode = drive.load("modes", parts.mix["mode"])
    t0 = time.perf_counter()
    st = drive.build(parts.cfg, parts.mix, seed, device)
    run = mode.run(st, seconds, False, lambda: None)
    out = {"cell": name, "seed": seed, "program": mode.check(st, run)}
    for label, kw in mode.CONTROLS.items():
        out[label] = mode.check(st, run, **kw)
    out["limits"] = parts.limits
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.seconds)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            with open(args.out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    bad = forbidden_modules()
    if bad:
        print(f"loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
