#!/usr/bin/env python3
"""Does MLPerf's DLRM-DCNv2 table fit one card through the set-up hand-over?

    python3 portbench/tools/table_probe.py [--seed N] [--chunk-rows R] \
        [--out FILE]

The table of MLPerf's recommendation benchmark (training
``recommendation_v2/torchrec_dlrm``, inference ``recommendation/dlrm_v2``):
the 26 Criteo 1TB vocabularies capped at 40 M rows, 204,184,588 rows of
dimension 128, stored in bfloat16 (52.3 GB; 104.5 GB in fp32, which does
not fit an 80 GB card).

A toy adapter does what a model adapter's ``setup(cfg, seed, traffic,
device)`` may do (``portbench/models/``): it takes the seed, makes the
table a chunk of ``--chunk-rows`` rows at a time (each chunk N(0, 0.02^2)
from a generator of its own, in fp32, cast to bf16) and writes each chunk
straight into its banks: 8 uniform banks of contiguous rows
(``uniform_partition``), so row r of the union vocabulary sits at flat slot
r of the packed table. No whole fp32 table and no second copy is ever
held.

Printed (and appended to ``--out``), one JSON line: the device, the peak
memory of the set-up (``torch.cuda.max_memory_allocated``), what stays
allocated, the table's bytes, the set-up's seconds, and a check that three
chunks made again give the packed rows bit for bit. Needs a CUDA card:
without one it exits 2 and prints nothing.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[2])]

import torch  # noqa: E402

from portbench.generate import WEIGHTS, generator  # noqa: E402

DCNV2 = {
    "name": "dlrm-dcnv2-table",
    "vocab_sizes": [40000000, 39060, 17295, 7424, 20265, 3, 7122, 1543, 63,
                    40000000, 3067956, 405282, 10, 2209, 11938, 155, 4, 976,
                    14, 40000000, 40000000, 40000000, 590152, 12973, 108,
                    36],
    "embed_dim": 128,
    "emb_dtype": "bfloat16",
    "plan": {"kind": "uniform", "n_banks": 8},
}


def chunk(cfg: dict, seed: int, k: int, rows: int, device) -> torch.Tensor:
    """Chunk ``k``'s ``rows`` rows of the table, its own draw."""
    g = generator(seed, WEIGHTS, device, index=k)
    x = torch.randn((rows, cfg["embed_dim"]), generator=g, device=device)
    return x.mul_(0.02).to(getattr(torch, cfg["emb_dtype"]))


def setup(cfg: dict, seed: int, traffic, device, chunk_rows: int) -> dict:
    """The toy adapter's set-up: the packed table, made in place."""
    V, D = sum(cfg["vocab_sizes"]), cfg["embed_dim"]
    n_banks = cfg["plan"]["n_banks"]
    per_bank = -(-V // n_banks)
    packed = torch.empty((n_banks * per_bank, D),
                         dtype=getattr(torch, cfg["emb_dtype"]), device=device)
    packed[V:].zero_()
    for k, start in enumerate(range(0, V, chunk_rows)):
        rows = min(chunk_rows, V - start)
        packed[start:start + rows] = chunk(cfg, seed, k, rows, device)
    return {"packed": packed, "rows_per_bank": per_bank}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--chunk-rows", type=int, default=1 << 20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cfg, dev = DCNV2, "cuda"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prog = setup(cfg, args.seed, None, dev, args.chunk_rows)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    held = torch.cuda.memory_allocated()
    V, D = sum(cfg["vocab_sizes"]), cfg["embed_dim"]
    n = -(-V // args.chunk_rows)
    same = {}
    for k in (0, n // 2, n - 1):
        start = k * args.chunk_rows
        rows = min(args.chunk_rows, V - start)
        same[k] = bool(torch.equal(
            prog["packed"][start:start + rows],
            chunk(cfg, args.seed, k, rows, dev)))
    out = {"device": torch.cuda.get_device_name(0), "rows": V, "dim": D,
           "dtype": cfg["emb_dtype"], "n_banks": cfg["plan"]["n_banks"],
           "rows_per_bank": prog["rows_per_bank"],
           "table_bytes": prog["packed"].numel()
           * prog["packed"].element_size(),
           "chunk_rows": args.chunk_rows, "chunks": n,
           "setup_peak_bytes": peak, "held_bytes": held,
           "setup_s": seconds, "chunks_same_bits": same,
           "seed": args.seed}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
