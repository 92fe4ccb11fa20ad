#!/usr/bin/env python3
"""Phase 18 of ``chip_smoke.py`` (GAT at its four reference cells) alone:
``chip_smoke.gat_phase`` on card 0.

    python3 tools/gat.py [--out FILE] [--host-breakdown] [--profile]

gat-cora at full width on Cora, the molecule batch, the sampled
``minibatch_lg`` blocks and full-batch ``ogb_products``: each batch built
on the host, step 1 against a float64 recomputation on the card, three
Adam steps with their device ms, model FLOP/s and peak memory, the
reduced config on the card against the CPU, each checked as the script
checks them. Prints the phase's lines, writes its record as JSON to
``--out``, and exits non-zero if a check fails. TF32 is off, as in the
script.

``--host-breakdown`` first times, on the host, each step of building the
``minibatch_lg`` batch at its full size (232,965 nodes, 114,615,892
edges): the Zipf popularity, each endpoint draw both as
``Generator.choice(p=...)`` and as ``data.synthetic._choice_p`` (the
arrays must be equal), the features, ``build_csr``'s stable argsort and
its row counts both as the reference's ``np.add.at`` and as
``np.bincount`` (equal), the stable argsort both as numpy's and as
``sparse.sampler.stable_order`` (equal), and the sampler's fanout 15-10
over 1,024 seeds.

``--profile`` runs one more train step a cell under ``torch.profiler``
and prints its device busy time, window and the kernels by device time.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def host_breakdown(seed: int = cs.GAT_SEED) -> dict:
    """Seconds of each host step of the ``minibatch_lg`` batch at full
    size, each faster form checked equal to the one it replaces."""
    import numpy as np
    from repro_torch.configs import shapes as SH
    from repro_torch.data import synthetic as syn
    from repro_torch.sparse.sampler import (CSRGraph, NeighborSampler,
                                            stable_order)
    d = SH.GNN_CELLS["minibatch_lg"].dims
    n, E = d["n_nodes"], d["n_edges"]
    secs = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        secs[name] = time.perf_counter() - t0
        return out

    rng = np.random.default_rng(seed)
    w = timed("zipf_popularity", lambda: syn.zipf_popularity(n, 0.9, rng))
    ends = []
    for end in ("src", "dst"):
        twin = np.random.default_rng()
        twin.bit_generator.state = rng.bit_generator.state
        ref = timed(f"{end}_choice", lambda: twin.choice(n, E, p=w))
        got = timed(f"{end}_choice_p", lambda: syn._choice_p(rng, n, E, w))
        cs.need(np.array_equal(ref, got),
                f"_choice_p != Generator.choice for the {end} draw")
        ends.append(got)
        del ref
    src, dst = ends
    timed("features", lambda: rng.standard_normal((n, d["d_feat"]))
          .astype(np.float32))
    order = timed("argsort_stable", lambda: np.argsort(dst, kind="stable"))
    order2 = timed("stable_order", lambda: stable_order(dst, n))
    cs.need(np.array_equal(order, order2),
            "stable_order != the stable argsort")
    del order2

    def add_at():
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.add.at(indptr, dst[order] + 1, 1)
        return indptr

    ref = timed("np_add_at", add_at)
    cnt = timed("np_bincount", lambda: np.bincount(dst, minlength=n))
    cs.need(np.array_equal(ref[1:], cnt), "bincount != np.add.at")
    indptr = np.cumsum(ref)
    csr = CSRGraph(indptr=indptr, indices=src[order].astype(np.int32),
                   n_nodes=n)
    seeds = np.random.default_rng(seed).choice(n, d["batch_nodes"],
                                               replace=False)
    blocks = timed("sample", lambda: NeighborSampler(
        csr, (d["fanout0"], d["fanout1"]), seed=seed).sample(seeds))
    deg = np.diff(indptr)
    return dict(seconds=secs, max_in_degree=int(deg.max()),
                block_edges=[int(b.edge_mask.sum()) for b in blocks])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="JSON record of the phase")
    ap.add_argument("--host-breakdown", action="store_true",
                    help="time each host step of minibatch_lg's batch first")
    ap.add_argument("--profile", action="store_true",
                    help="profile one more train step a cell")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False: this needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    print(f"device: {card} ({torch.cuda.device_count()} visible)")
    rec = dict(card=card)
    if args.host_breakdown:
        rec["host_breakdown"] = host_breakdown()
        hb = rec["host_breakdown"]
        print("minibatch_lg host steps at full size (s): "
              + ", ".join(f"{k} {v:.2f}" for k, v in hb["seconds"].items())
              + f"; max in-degree {hb['max_in_degree']:,}, block edges "
              f"{hb['block_edges']} [{card}]", flush=True)
    t0 = time.perf_counter()
    rec["gat"], _ = cs.gat_phase(torch.device("cuda", 0), card,
                                 profile=args.profile)
    rec["seconds"] = time.perf_counter() - t0
    print(f"gat phase: {rec['seconds']:.1f} s [{card}]")
    if args.out:
        Path(args.out).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
