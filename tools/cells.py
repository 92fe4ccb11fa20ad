#!/usr/bin/env python3
"""Phase 19 of ``chip_smoke.py`` (each cell's cost, three cells measured
against it) alone, with the phases it reads: ``chip_smoke.cells_phase``
on card 0 after phases 12 (retrieval) and 18 (GAT).

    python3 tools/cells.py [--out FILE]
    python3 tools/cells.py --table DIR [--steps FILE]

Builds the kernels, makes phase 1's plan (the §3.2 greedy over the
GoodReads popularity, 8 banks), starts the dry pass of all 44 cells on
``meta`` in a process of its own, runs phases 12 and 18, then phase 19:
``updlrm-paper``'s ``serve_p99``, ``serve_bulk`` and ``train_batch`` at
full width at their own batches, each step's device ms and its roofline
share, every new-shape launch against its plain version. Prints the
phases' lines, writes the record as JSON to ``--out``, and exits non-zero
if a check fails. TF32 is off, as in the script.

``--table DIR`` needs no card: it prints PERF.md's cell table, a row a
cell, from the dry pass's records of both grids under DIR (``python -m
repro_torch.launch.dryrun --all --mesh both --out DIR``), with the
measured steps and shares of a run's ``--out`` FILE (``--steps``).
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def _g(x: float) -> str:
    return f"{x:.4g}"


def _flops(r: dict) -> str:
    short = {"float32": "f32", "bfloat16": "bf16", "tf32": "tf32",
             "float16": "f16", "float64": "f64"}
    return " + ".join(f"{_g(v)} {short.get(k, k)}"
                      for k, v in sorted(r["flops_by_dtype"].items())) or "0"


def table(dry_dir: str, steps_file: str | None) -> str:
    """PERF.md's cell table from the dry records of both grids."""
    from repro_torch.configs import ARCHS
    steps = {}
    if steps_file:
        steps = json.loads(Path(steps_file).read_text())["cells"]["measured"]
    dom = {"compute_s": "c", "memory_s": "m", "collective_s": "x"}
    rows = ["| cell | 1 card: FLOPs; bytes | bound ms | 2 x 2 (rank 0): "
            "FLOPs; bytes; collective bytes | bound ms | model FLOPs | "
            "useful 1 / 4 | fits 80 GB 1 / 4 | step ms, share |",
            "|---|---|---|---|---|---|---|---|---|"]
    for a, spec in ARCHS.items():
        for s in spec.shapes:
            one, four = (json.loads((Path(dry_dir) / f"{g}__{a}__{s}.json")
                                    .read_text())
                         for g in ("card_1x1", "cards_2x2"))
            if one.get("refused"):
                rows.append(f"| {a} {s} | refused (multi-hot retrieval) "
                            f"| | | | {_g(one['model_flops_global'])} | | "
                            f"| |")
                continue
            st = steps.get(f"{a} {s}")
            rows.append(
                f"| {a} {s} | {_flops(one)}; {_g(one['bytes_per_device'])} "
                f"| {_g(one['roofline']['bound_s'] * 1e3)} "
                f"{dom[one['roofline']['dominant']]} | {_flops(four)}; "
                f"{_g(four['bytes_per_device'])}; "
                f"{_g(four['collective_bytes_per_device'])} | "
                f"{_g(four['roofline']['bound_s'] * 1e3)} "
                f"{dom[four['roofline']['dominant']]} | "
                f"{_g(one['model_flops_global'])} | "
                f"{_g(one['useful_flops_ratio'])} / "
                f"{_g(four['useful_flops_ratio'])} | "
                f"{'y' if one['memory']['fits_80gb'] else 'n'} / "
                f"{'y' if four['memory']['fits_80gb'] else 'n'} | "
                + (f"{_g(st['step_median_ms'])}, {st['share']:.4f} |" if st
                   else "not measured |"))
    return "\n".join(rows)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--table", default=None)
    ap.add_argument("--steps", default=None)
    args = ap.parse_args()
    if args.table:
        print(table(args.table, args.steps))
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this tool needs a card")
    from repro_torch.configs import get_arch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    dry_job = cs.start_dry_pass()
    _build.build()
    cfg = get_arch("updlrm-paper").config
    rng = np.random.default_rng(0)
    pop = syn.zipf_popularity(cfg.vocab_sizes[0],
                              syn.WORKLOADS["read"].zipf_a, rng)
    plan = non_uniform_partition(np.tile(pop, cfg.n_sparse), 8,
                                 batch=cs.BAG_TILE)
    print(f"kernels built and phase 1's plan made in "
          f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    retrieval_out, _ = cs.retrieval_phase(dev, collections.defaultdict(dict))
    gat_out, _ = cs.gat_phase(dev, card)
    t1 = time.perf_counter()
    out, launches = cs.cells_phase(dev, card, plan, dry_job, retrieval_out,
                                   gat_out)
    print(f"cells phase: {time.perf_counter() - t1:.1f} s; launches "
          f"{launches} [{card}]", flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(dict(card=card, cells=out,
                                                  launches=launches),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
