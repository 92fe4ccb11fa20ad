#!/usr/bin/env python3
"""Train-step stage times of several checkouts of the repository, measured
in turns on one CUDA card.

    python3 tools/train_step_compare.py TREE [TREE ...]

For each TREE in the order given (for example a parent commit and a change
unpacked with ``git archive``: PARENT CHANGE CHANGE PARENT), one process
imports that tree's ``src/repro_torch`` and ``chip_smoke.py``, builds its
kernels, and runs ``chip_smoke.py``'s train path at full width (phase 2's
8-bank plan of the GoodReads popularity, 6 steps at batch 64) and its
stage timing ``check_train`` (forward, backward, optimizer, the table's
Adagrad and the whole step: CUDA events, L2 flushed, median of 20). Prints
one JSON line per tree and, last, the medians by tree. Needs a CUDA card
and ``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

STAGES = ("forward", "backward", "optimizer", "rowwise_adagrad_table",
          "train_step")

CHILD = r"""
import json, sys
from pathlib import Path
tree = Path(sys.argv[1]).resolve()
sys.path[:0] = [str(tree / "src"), str(tree)]
import numpy as np
import torch
import chip_smoke as cs
from repro_torch.configs import get_arch
from repro_torch.core.partitioning import non_uniform_partition
from repro_torch.data import synthetic as syn
from repro_torch.kernels import _build
torch.manual_seed(0)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda", 0)
_build.build()
spec = get_arch("updlrm-paper")
cfg = spec.config
rng = np.random.default_rng(0)
pop = syn.zipf_popularity(cfg.vocab_sizes[0], syn.WORKLOADS["read"].zipf_a,
                          rng)
plan = non_uniform_partition(np.tile(pop, cfg.n_sparse), 8,
                             batch=cs.BAG_TILE)
res, _ = cs.train_main_path(dev, spec, plan)
out = cs.check_train(dev, spec, res)
print("RESULT " + json.dumps({k: out[k] for k in %r}), flush=True)
""" % (STAGES,)


def main() -> int:
    trees = [Path(t) for t in sys.argv[1:]]
    if not trees or any(not (t / "chip_smoke.py").is_file() for t in trees):
        raise SystemExit(__doc__)
    times: dict[str, list[dict]] = {}
    for tree in trees:
        r = subprocess.run([sys.executable, "-c", CHILD, str(tree)],
                           capture_output=True, text=True)
        lines = [ln for ln in r.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if r.returncode != 0 or not lines:
            sys.stderr.write(r.stdout[-4000:] + r.stderr[-4000:])
            raise SystemExit(f"{tree}: the train path failed "
                             f"(exit {r.returncode})")
        got = json.loads(lines[-1][len("RESULT "):])
        times.setdefault(str(tree), []).append(got)
        print(json.dumps({"tree": str(tree), **got}), flush=True)
    print(json.dumps({tree: {k: statistics.median(run[k] for run in runs)
                             for k in STAGES}
                      for tree, runs in times.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
