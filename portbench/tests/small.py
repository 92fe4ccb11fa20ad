"""Small cells for the CPU tests: each cell's configuration, mix and
limits as the benchmark finds them, with the sizes cut so that a test run
holds them (widths, vocabularies, batches, bags and the host pool). A
model family gives its small sizes in ``sizes/<model>.py``, a
``small_cfg(cfg)`` that cuts a copy of the configuration in place."""
from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

from portbench.run import cell_parts

CELLS = ("paper-bulk", "rm2-bulk", "paper-train")
SIZES = Path(__file__).resolve().parent / "sizes"


def small_cfg(cfg: dict) -> dict:
    model = cfg["model"]
    spec = importlib.util.spec_from_file_location(
        f"portbench_sizes_{model}", SIZES / f"{model}.py")
    sizes = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sizes)
    return sizes.small_cfg(copy.deepcopy(cfg))


def small_parts(cell: str):
    p = cell_parts(cell)
    p.cfg = small_cfg(p.cfg)
    mix = copy.deepcopy(p.mix)
    if "batch" in mix:
        mix["batch"] = 64
    if "bags" in mix:
        mix["bags"] = dict(mix["bags"], mean=12.0)
    p.mix = mix
    return p
