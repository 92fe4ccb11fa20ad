#!/usr/bin/env python3
"""The retrieval serve call of two trees of the port on one CUDA card, in
turns: its device time and its own peak device memory.

    python3 tools/retrieval_compare.py --old DIR [--reps N] [--out FILE]

DIR is the ``src`` directory of an earlier port, for example the parent
commit's, unpacked with
``git archive HEAD src/repro_torch | tar -x -C build/old_tree`` (then DIR
is ``build/old_tree/src``; its kernels build into ``build/old_tree/build``).
Each tree runs in a process of its own, in the order old, new, new, old.
A run builds full-width ``dlrm-rm2`` from seed 12 and one query against
1,000,000 field-0 candidates, as phase 12 of ``chip_smoke.py`` does, and
serves it through ``serve_step.build_retrieval_serve`` (top 128) once (the
kernels' build and load); then the median of ``--reps`` serve calls
(CUDA events, ``chip_smoke.time_ms``) and the peak device memory of one
call above what the process held before it. The top 128 of the two trees
are compared: values within rtol 1e-5 / atol 1e-6, ids equal where the
values are apart. Prints a line a run and a summary, and writes them as
JSON to ``--out``. Needs a CUDA card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
N, TOP_K, SEED = 1_000_000, 128, 12


def one_run(reps: int) -> dict:
    """The serve call of the ``repro_torch`` first on ``sys.path``."""
    import numpy as np
    import torch
    from chip_smoke import card_line, time_ms
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_retrieval_serve
    if not torch.cuda.is_available():
        raise SystemExit("retrieval_compare: no CUDA card")
    dev = torch.device("cuda")
    cfg = get_arch("dlrm-rm2").config
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED)
    batch = {"dense": torch.from_numpy(rng.standard_normal(
                (1, cfg.n_dense)).astype(np.float32)).to(dev),
             "sparse": torch.from_numpy(np.array(
                 [[rng.integers(v) for v in cfg.vocab_sizes]],
                 np.int32)).to(dev)}
    batch["candidates"] = torch.from_numpy(rng.integers(
        0, cfg.vocab_sizes[0], N).astype(np.int32)).to(dev)
    serve = build_retrieval_serve(dlrm, cfg, statics, top_k=TOP_K)
    vals, ids = serve(params, batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    serve(params, batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - held
    ms = time_ms(lambda: serve(params, batch), reps=reps, warmup=2)
    import repro_torch
    return dict(tree=str(Path(repro_torch.__file__).parents[1]),
                card=card_line(), serve_ms=ms, serve_peak_bytes=peak,
                held_bytes=held, top_values=vals.tolist(),
                top_ids=ids.tolist())


def run_tree(src: Path, reps: int) -> dict:
    env = {**os.environ, "PYTHONPATH": f"{src}{os.pathsep}{ROOT}"}
    r = subprocess.run([sys.executable, __file__, "--one", "--reps",
                        str(reps)], env=env, capture_output=True, text=True,
                       timeout=900)
    if r.returncode != 0:
        raise SystemExit(f"retrieval_compare: the run of {src} failed:\n"
                         f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    line = [x for x in r.stdout.splitlines() if x.startswith("RUN ")][-1]
    return json.loads(line[4:])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, help="an earlier port's src/")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=Path,
                    default=ROOT / "build" / "retrieval_compare.json")
    ap.add_argument("--one", action="store_true",
                    help="(inside) one run of the tree on PYTHONPATH")
    args = ap.parse_args()
    if args.one:
        print("RUN " + json.dumps(one_run(args.reps)), flush=True)
        return 0
    if args.old is None:
        ap.error("--old DIR is needed")
    trees = {"old": args.old.resolve(), "new": ROOT / "src"}
    runs = []
    for tag in ("old", "new", "new", "old"):
        res = run_tree(trees[tag], args.reps)
        res["tag"] = tag
        runs.append(res)
        print(f"{tag}: serve call {res['serve_ms']:.4f} ms, own peak "
              f"{res['serve_peak_bytes'] / 2**30:.3f} GiB (held "
              f"{res['held_bytes'] / 2**30:.3f} GiB) [{res['card']}]",
              flush=True)
    summary = {}
    for tag in ("old", "new"):
        mine = [r for r in runs if r["tag"] == tag]
        summary[tag] = dict(
            serve_ms=[r["serve_ms"] for r in mine],
            serve_ms_median=statistics.median(r["serve_ms"] for r in mine),
            serve_peak_bytes=[r["serve_peak_bytes"] for r in mine])
    import numpy as np
    ov, nv = (np.array(runs[i]["top_values"]) for i in (0, 1))
    oi, ni = (np.array(runs[i]["top_ids"]) for i in (0, 1))
    apart = np.ones(TOP_K, bool)
    gap = np.abs(np.diff(nv)) > 1e-6 + 1e-5 * np.abs(nv[1:])
    apart[1:] &= gap
    apart[:-1] &= gap
    summary["top_values_close"] = bool(np.all(np.abs(ov - nv)
                                              <= 1e-6 + 1e-5 * np.abs(ov)))
    summary["top_ids_equal_where_apart"] = bool((oi[apart] == ni[apart]).all())
    summary["card"] = runs[0]["card"]
    print("summary: " + json.dumps(summary), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(runs=runs, summary=summary),
                                   indent=1))
    if not (summary["top_values_close"]
            and summary["top_ids_equal_where_apart"]):
        print("retrieval_compare: the two trees' top 128 disagree",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
