"""Layer-extrapolated cost counts for LM cells whose full-depth dry pass is
slow (the port of ``repro/launch/extrapolate.py``): count the SAME cell at
``n_layers`` = 1 and 2 and extrapolate

    cost(L) = c1 + (L - 1) * (c2 - c1)

which is exact for stacks of identical layers (every transformer layer
here has one shape and one cut). The collectives are clamped below at
their one-layer count, as the reference's (a one-time collective can make
a kind's per-layer slope negative). The memory fields are extrapolated
the same way: the dry pass has no rolled full-depth program to read them
from, and its arguments and its peak both grow by one layer's weights,
state and activations a layer.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.extrapolate --arch granite-20b --shape train_4k
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os

from repro_torch.configs import get_arch
from repro_torch.configs import shapes as SH
from repro_torch.launch.mesh import Grid, make_dist, make_production_grid


def _cfg(arch_id: str, shape_id: str, n_layers: int):
    """The dry config of the cell at ``n_layers`` (``cells._lm_cell``'s)."""
    spec = get_arch(arch_id)
    cell = SH.get_cell(arch_id, shape_id)
    S = cell.dims["seq"]
    decode = cell.step_kind == "decode"
    return dataclasses.replace(
        spec.config, n_layers=n_layers, unroll=True,
        q_chunk=spec.config.q_chunk if decode else S,
        kv_chunk=spec.config.kv_chunk if decode else min(2048, S))


def measure(arch_id: str, shape_id: str, n_layers: int, grid: Grid) -> dict:
    """The dry pass of the cell at ``n_layers`` (``dryrun.count_cell``'s
    result)."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.cells import _lm_cell
    return dryrun.count_cell(
        arch_id, shape_id, grid,
        cell=_lm_cell(arch_id, shape_id, make_dist(grid),
                      cfg_override=_cfg(arch_id, shape_id, n_layers)))


def _line(a: float, b: float, L: int) -> float:
    return a + (L - 1) * (b - a)


def extrapolate_counts(arch_id: str, shape_id: str, grid: Grid,
                       n_layers: int | None = None) -> dict:
    """The cell's record (``dryrun.record``'s keys) at ``n_layers`` (the
    config's by default) from its counts at 1 and 2 layers."""
    from repro_torch.launch import dryrun
    L = get_arch(arch_id).config.n_layers if n_layers is None else n_layers
    one = measure(arch_id, shape_id, 1, grid)
    two = measure(arch_id, shape_id, 2, grid)
    s1, s2 = one["summary"], two["summary"]
    dtypes = set(s1["flops"]) | set(s2["flops"])
    kinds = set(s1["collectives"]) | set(s2["collectives"])
    coll = {k: max(s1["collectives"].get(k, 0.0),
                   _line(s1["collectives"].get(k, 0.0),
                         s2["collectives"].get(k, 0.0), L))
            for k in kinds}
    summary = {
        "flops": {d: _line(s1["flops"].get(d, 0.0), s2["flops"].get(d, 0.0),
                           L) for d in dtypes},
        "bytes": _line(s1["bytes"], s2["bytes"], L),
        "collectives": coll,
        "collective_bytes": sum(coll.values()),
        "peak_bytes": int(_line(s1["peak_bytes"], s2["peak_bytes"], L)),
        "kernels": s2["kernels"],
    }
    counted = dict(
        cell=two["cell"],           # the full cell's kind and meta
        summary=summary,
        argument_bytes=int(_line(one["argument_bytes"],
                                 two["argument_bytes"], L)),
        output_bytes=int(_line(one["output_bytes"], two["output_bytes"], L)),
        build_s=one["build_s"] + two["build_s"],
        count_s=one["count_s"] + two["count_s"])
    return dryrun.record(arch_id, shape_id, grid, counted,
                         accounting="layer-extrapolated (L = 1, 2)")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    grid = make_production_grid(multi_card=args.multi)
    rec = extrapolate_counts(args.arch, args.shape, grid)
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out,
                        f"{grid.name}__{args.arch}__{args.shape}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    r = rec["roofline"]
    print(f"EXTRAP {args.arch}:{args.shape} dom={r['dominant']} "
          f"bound={r['bound_s'] * 1e3:.2f}ms "
          f"useful={rec['useful_flops_ratio']:.3f}")


if __name__ == "__main__":
    main()
