#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (the LM family) alone:
``chip_smoke.lm_phase`` on card 0.

    python3 tools/lm.py [--out FILE]

granite-moe-1b-a400m and smollm-360m at full width: prefill of 8 x 2,048
tokens and 32 greedy decode steps from its cache, decode against prefill
of the same tokens, and three train steps of the MoE at the train CLI's
batch, each checked as the script checks them. Prints the phase's lines,
writes its record as JSON to ``--out``, and exits non-zero if a check
fails. TF32 is off, as in the script.
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
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"device: {card} ({torch.cuda.device_count()} visible)")
    out, _ = cs.lm_phase(torch.device("cuda", 0), card)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(card=card, **out),
                                             indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
