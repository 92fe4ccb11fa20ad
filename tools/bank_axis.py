#!/usr/bin/env python3
"""Phase 15 of ``chip_smoke.py`` (the bank axis) alone: the kernels built,
phase 2's popularity drawn, then ``chip_smoke.bank_axis_phase``.

    python3 tools/bank_axis.py [--out FILE]

Four ranks through ``repro_torch.dist.launch.run_ranks``: NCCL, one rank a
card, where four cards are visible (a four-card machine), else gloo with
all four on card 0. Prints the phase's lines (sharded serve, DP train,
migration, a dead bank, the compressed DP step, each against the
single-device port; retrieval spread over the grid, the compressed and the
clipped train step under ``dist``) and writes its record as JSON to
``--out``; exits non-zero if a check fails, as the script does. TF32 is
off, as in the script, so the single-device references are full fp32.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON record of the phase")
    args = ap.parse_args()
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"device: {card} ({torch.cuda.device_count()} visible)")
    _build.build()
    spec = get_arch("updlrm-paper")
    pop = syn.zipf_popularity(spec.config.vocab_sizes[0],
                              syn.WORKLOADS["read"].zipf_a,
                              np.random.default_rng(0))
    plans = cs.bank_plans(pop, spec.config.n_sparse)
    out, launches = cs.bank_axis_phase(torch.device("cuda", 0), spec, plans,
                                       pop, card)
    if args.out:
        Path(args.out).write_text(json.dumps(
            dict(card=card, launches_total=launches, **out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
