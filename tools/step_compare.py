#!/usr/bin/env python3
"""The full-width serve and train steps of an earlier tree against this
one, in turns on one card.

    python3 tools/step_compare.py --old DIR [--rounds 2] [--out FILE]

DIR is the root of an earlier checkout (for example the parent commit,
unpacked with ``git archive HEAD | tar -x -C build/parent``). Each turn is
a fresh process with DIR's ``src`` or this tree's first on ``sys.path``;
the turns run old, new, new, old, ``--rounds`` times. A turn builds the
kernels (each tree into its own ``build/``), serves one batch of 64
``updlrm-paper`` requests at full width through ``launch.serve.run`` (one
bank: a plan only moves rows between banks), and trains one step at batch
64 through ``launch.train.run``, both with the library's default backend.
It times, with ``chip_smoke.time_ms`` (CUDA events, L2 flushed), the serve
step (median of 20) and the train step (median of 5), and on the host the
serve call to its synchronize (median of 50).

Prints each turn, the medians of each side and the card's name and power
limit, and writes them as JSON to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def worker(src: str) -> dict:
    sys.path.insert(0, src)
    sys.path.insert(1, str(ROOT))
    import torch
    from chip_smoke import time_ms
    from repro_torch.configs import get_arch
    from repro_torch.kernels import _build
    from repro_torch.launch import serve as lserve
    from repro_torch.launch import train as ltrain
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    from repro_torch.train.train_step import build_train_step, default_optimizer

    _build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    spec = get_arch("updlrm-paper")
    cfg = spec.config
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    out = {"src": src}

    res = lserve.run(spec, cfg, requests=64, batch=64, device=dev)
    serve = build_recsys_serve(dlrm, cfg, res.statics)
    out["serve_step_ms"] = time_ms(lambda: serve(res.params, res.last_batch),
                                   flush=scratch.zero_)
    host = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve(res.params, res.last_batch)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    out["serve_call_host_ms"] = statistics.median(host)
    del res, serve
    torch.cuda.empty_cache()

    tr = ltrain.run(spec, cfg, steps=1, batch=64, device=dev)
    loss_fn, kw = ltrain.build_loss(spec, cfg, tr.statics)
    step = build_train_step(loss_fn, default_optimizer(), loss_kwargs=kw)
    out["train_step_ms"] = time_ms(lambda: step(tr.state, tr.last_batch),
                                   reps=5, warmup=1, flush=scratch.zero_)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", help="root of the earlier checkout")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0
    if not args.old:
        ap.error("--old is required")
    srcs = {"old": str(Path(args.old).resolve() / "src"),
            "new": str(ROOT / "src")}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    turns = {"old": [], "new": []}
    for which in ["old", "new", "new", "old"] * args.rounds:
        r = subprocess.run([sys.executable, __file__, "--worker",
                            srcs[which]], capture_output=True, text=True,
                           timeout=900)
        if r.returncode != 0:
            print(f"{which} turn failed:\n{r.stderr[-4000:]}",
                  file=sys.stderr)
            return 1
        got = json.loads(r.stdout.strip().splitlines()[-1])
        turns[which].append(got)
        print(f"{which}: " + ", ".join(f"{k} {v:.4f}" for k, v in got.items()
                                      if k != "src"), flush=True)
    keys = ("serve_step_ms", "serve_call_host_ms", "train_step_ms")
    medians = {w: {k: statistics.median(t[k] for t in turns[w])
                   for k in keys} for w in turns}
    for w, m in medians.items():
        print(f"median {w}: " + ", ".join(f"{k} {v:.4f}"
                                         for k, v in m.items()) + f" [{card}]")
    if args.out:
        Path(args.out).write_text(json.dumps(
            dict(card=card, turns=turns, medians=medians), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
