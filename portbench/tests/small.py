"""Small cells for the CPU tests: each cell's configuration, mix and
limits as the benchmark finds them, with the sizes cut so that a test run
holds them (widths, vocabularies, batches, bags and the host pool)."""
from __future__ import annotations

import copy

from portbench.run import cell_parts

CELLS = ("paper-bulk", "rm2-bulk", "paper-train")


def small_cfg(cfg: dict) -> dict:
    cfg = copy.deepcopy(cfg)
    if cfg["multi_hot"] > 1:
        cfg.update(vocab_sizes=[500] * 8, embed_dim=8, bot_mlp=[32, 8],
                   top_mlp=[32], multi_hot=16)
    else:
        cfg.update(vocab_sizes=[100, 80, 60], embed_dim=8, bot_mlp=[32, 8],
                   top_mlp=[32, 16])
    return cfg


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
