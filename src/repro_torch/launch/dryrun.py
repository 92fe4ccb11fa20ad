"""Dry pass of every (arch x shape) cell on the port's grids: each cell's
step run once on ``meta`` tensors at full dims under
``launch/roofline.CostCounter``, and one JSON a cell of its per-card
FLOPs by dtype, bytes, collective bytes, peak of live bytes and H100
roofline bound (the port of ``repro/launch/dryrun.py``). Nothing is
allocated and no card is needed: on the card the same count gives each
measured step its roofline share (``chip_smoke.py``'s phase 19).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch dlrm-rm2 --shape train_batch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

``--mesh single`` is one card (the single-device path), ``multi`` four
cards as dp 2 x bank 2 (rank 0's share), ``both`` each. The reference's
``--save-hlo`` and ``--rolled`` are not here: PyTorch compiles no module
to save, and the pass runs every layer as the card does. LM cells whose
train and prefill cells, whose full-depth pass takes seconds a cell (every
layer's ops go through Python), are counted at 1 and 2 layers and
extrapolated (``launch/extrapolate``: the same FLOPs and peak, bytes within
0.03 %); the record says so under ``accounting``. Decode cells run every
layer (under a second).

A cell the model refuses (``updlrm-paper``'s multi-hot retrieval, which
the reference's ``retrieval_scores`` cannot broadcast either) records the
refusal; any other error is a FAIL, and the run exits 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.core.hwmodel import H100
from repro_torch.launch import roofline as RL
from repro_torch.launch.cells import build_cell, tree_nbytes
from repro_torch.launch.mesh import Grid, make_production_grid

# LM step kinds counted at 1 and 2 layers and extrapolated
EXTRAPOLATED_KINDS = ("train", "prefill")
# what the model raises for a cell it does not serve
REFUSALS = ("one-hot fields only",)


def grid_for(multi: bool) -> Grid:
    return make_production_grid(multi_card=multi)


def count_cell(arch_id: str, shape_id: str, grid: Grid,
               cell=None) -> dict:
    """One dry pass of a cell (``build_cell``'s, or ``cell``): the
    counter's summary, the arguments' and outputs' bytes and the seconds
    it took to build and to run."""
    t0 = time.perf_counter()
    cell = cell or build_cell(arch_id, shape_id, grid)
    t_build = time.perf_counter() - t0
    arg_bytes = tree_nbytes(cell.args)
    grad = contextlib.nullcontext() if cell.step_kind == "train" \
        else torch.no_grad()
    with grad:
        with RL.CostCounter() as c:
            out = cell.fn(*cell.args)
            out_bytes = tree_nbytes(out)
            del out
    return dict(cell=cell, summary=c.summary(), argument_bytes=arg_bytes,
                output_bytes=out_bytes, build_s=t_build,
                count_s=time.perf_counter() - t0 - t_build)


def record(arch_id: str, shape_id: str, grid: Grid, counted: dict,
           accounting: str = "direct") -> dict:
    """The reference's record for a counted cell: per-card counts, the H100
    roofline terms, the memory it needs against 80 GB, the useful-FLOPs
    ratio (``model_flops`` over the counted FLOPs of every card)."""
    s = counted["summary"]
    flops = sum(s["flops"].values())
    terms = RL.cost_terms(s, H100)
    mf = RL.model_flops(arch_id, shape_id)
    peak = s["peak_bytes"]
    args = counted["argument_bytes"]
    cell = counted["cell"]
    return {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": grid.name,
        "n_devices": grid.size,
        "step_kind": cell.step_kind,
        "build_s": round(counted["build_s"], 2),
        "count_s": round(counted["count_s"], 2),
        "flops_per_device": flops,
        "flops_by_dtype": s["flops"],
        "bytes_per_device": s["bytes"],
        "collective_bytes_per_device": s["collective_bytes"],
        "collectives": s["collectives"],
        "kernels": s["kernels"],
        "memory": {
            "argument_bytes": args,
            "output_bytes": counted["output_bytes"],
            "peak_bytes": peak,
            "fits_80gb": bool(peak + args < H100.hbm_bytes),
        },
        "roofline": terms,
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (flops * grid.size)) if flops else None,
        "accounting": accounting,
        "meta": {k: (list(v) if isinstance(v, tuple) else v)
                 for k, v in cell.meta.items()},
    }


def _refused(arch_id: str, shape_id: str, grid: Grid, err: Exception
             ) -> dict:
    from repro_torch.configs import shapes as SH
    return {"arch": arch_id, "shape": shape_id, "mesh": grid.name,
            "n_devices": grid.size,
            "step_kind": SH.get_cell(arch_id, shape_id).step_kind,
            "refused": str(err), "roofline": None,
            "model_flops_global": RL.model_flops(arch_id, shape_id)}


def run_cell(arch_id: str, shape_id: str, multi: bool, out_dir: str,
             grid: Grid | None = None) -> dict:
    """Count one cell (extrapolated for a deep LM train or prefill cell)
    and write its JSON to ``out_dir``."""
    from repro_torch.configs import shapes as SH
    from repro_torch.launch.extrapolate import extrapolate_counts
    grid = grid or grid_for(multi)
    kind = SH.get_cell(arch_id, shape_id).step_kind
    try:
        if get_arch(arch_id).family == "lm" and kind in EXTRAPOLATED_KINDS:
            rec = extrapolate_counts(arch_id, shape_id, grid)
        else:
            rec = record(arch_id, shape_id, grid,
                         count_cell(arch_id, shape_id, grid))
    except ValueError as e:
        if not any(r in str(e) for r in REFUSALS):
            raise
        rec = _refused(arch_id, shape_id, grid, e)
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{grid.name}__{arch_id}__{shape_id}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def describe(rec: dict) -> str:
    """One line: the bound and its dominant term, the memory, the useful
    FLOPs ratio (or the refusal)."""
    if rec.get("refused"):
        return f"refused: {rec['refused']}"
    r, m = rec["roofline"], rec["memory"]
    useful = rec["useful_flops_ratio"]
    return (f"bound={r['bound_s'] * 1e3:11.4f}ms dom={r['dominant']:12s} "
            f"peak={m['peak_bytes'] / 2**30:8.2f}GiB "
            f"fits_80gb={m['fits_80gb']!s:5s} useful="
            + ("none" if useful is None else f"{useful:.3f}"))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    cells: list[tuple[str, str]] = []
    if args.all:
        for a in ARCHS:
            for s in get_arch(a).shapes:
                cells.append((a, s))
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    failures = []
    for arch_id, shape_id in cells:
        for multi in meshes:
            tag = f"{'multi' if multi else 'single'}:{arch_id}:{shape_id}"
            try:
                rec = run_cell(arch_id, shape_id, multi, args.out)
                status = "REFUSED" if rec.get("refused") else "OK  "
                print(f"{status} {tag:50s} {describe(rec)}", flush=True)
            except Exception as e:  # one cell's fault: record, go on
                failures.append((tag, repr(e)))
                print(f"FAIL {tag}: {e}", flush=True)
                traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        raise SystemExit(1)
    print("\nall cells passed")


if __name__ == "__main__":
    main()
