#!/usr/bin/env python3
"""The cache-aware path's host loops, an earlier version against the tree,
on the same full-width inputs in one process.

    python3 tools/host_compare.py --old DIR [--out FILE]

DIR is an earlier ``src/repro_torch`` (for example the parent commit's,
unpacked with ``git archive HEAD src/repro_torch | tar -x -C build/old
--strip-components=2``). Its ``core/partitioning.py`` and
``core/cache_runtime.py`` are loaded beside the tree's. The inputs are
``chip_smoke.py`` phase 5's, at the full ``updlrm-paper`` width: one
drifting-Zipf(1.2) trace per field (seed 0 + f, bags of 256), a profiling
window of 64 requests (its last 512 bags), the window's row counts as the
frequencies over 18,885,200 rows, ``mine_cooccurrence(top_items=2048,
max_groups=256, min_support=2)``, 8 banks at ``ceil(V / 8) * 1.25`` rows.

Then, in turns (old, new, new, old), with the host clock:

* ``cache_aware_partition`` (Algorithm 1): both plans held equal, bit for
  bit (``bank_of_row``, ``slot_of_row``, ``load_per_bank`` and the cache
  placements);
* ``non_uniform_partition`` (§3.2's exact greedy, the adaptive lanes'
  replan) of the same frequencies at the same capacity: both plans held
  equal, bit for bit;
* the host rewrite (``VersionedCacheRewriter.rewrite_rect``) of 4 batches
  of 64 requests under the plan capped to 16 entries a bank: both rewrites
  held equal, timed per batch;
* the replanner's rewrite of its 512-bag window under that capped plan
  (what a cache-aware commit and the hysteresis replay run on every
  replan): the old ``rewrite_bag`` a bag against the tree's one
  ``SubsetMatcher`` for the window, both lists held equal.

Prints the times and the card's name and power limit beside them (the
host of that card ran them), and writes them as JSON to ``--out``.
Numpy and the host only: nothing here runs on the card.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod          # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def _card() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else "no card"
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return "no card"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--old", required=True,
                    help="an earlier src/repro_torch directory")
    ap.add_argument("--out", default=None, help="JSON file for the times")
    args = ap.parse_args()
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core import cache_runtime as new_cr
    from repro_torch.core import partitioning as new_p
    from repro_torch.core.grace import mine_cooccurrence
    from repro_torch.workload.trace import (DriftConfig, DriftingZipfTrace,
                                            dlrm_drifting_batch)
    old = Path(args.old)
    old_p = _load(old / "core" / "partitioning.py", "old_partitioning")
    old_cr = _load(old / "core" / "cache_runtime.py", "old_cache_runtime")
    card = _card()

    cfg = get_arch("updlrm-paper").config
    V, L, banks = cfg.total_vocab, cfg.multi_hot, 8
    cap = int(np.ceil(V / banks) * 1.25)
    offs = cfg.field_offsets()
    traces = [DriftingZipfTrace(DriftConfig(
        n_items=v, zipf_a=1.2, avg_bag=float(L), rotate_every=0,
        rotate_frac=0.25), seed=f) for f, v in enumerate(cfg.vocab_sizes)]

    def requests(n):
        sp = dlrm_drifting_batch(traces, n, L)
        return np.where(sp >= 0, sp + offs[None, :, None], -1)

    window = [r[r >= 0] for r in requests(64).reshape(-1, L)][-512:]
    freq = np.bincount(np.concatenate(window), minlength=V).astype(
        np.float64)
    cp = mine_cooccurrence(window, top_items=2048, max_groups=256,
                           min_support=2)
    out = {"card": card, "groups": len(cp.groups), "entries": cp.n_entries,
           "partition_s": {"old": [], "new": []},
           "non_uniform_s": {"old": [], "new": []},
           "rewrite_ms": {"old": [], "new": []},
           "window_rewrite_ms": {"old": [], "new": []}}
    plans = {}
    for side in ("old", "new", "new", "old"):
        mod = old_p if side == "old" else new_p
        t0 = time.perf_counter()
        plans[side] = mod.cache_aware_partition(
            freq, cp.groups, cp.benefits, banks, emt_capacity_rows=cap)
        out["partition_s"][side].append(time.perf_counter() - t0)
        print(f"cache_aware_partition, {side}: "
              f"{out['partition_s'][side][-1]:.3f} s [{card}]", flush=True)
    for f in ("bank_of_row", "slot_of_row", "rows_per_bank", "load_per_bank",
              "cache_bank_of_entry", "cache_slot_of_entry",
              "cache_rows_per_bank"):
        if not np.array_equal(getattr(plans["old"], f),
                              getattr(plans["new"], f)):
            print(f"host_compare: FAIL: plans differ in {f}", file=sys.stderr)
            return 1
    nu = {}
    for side in ("old", "new", "new", "old"):
        mod = old_p if side == "old" else new_p
        t0 = time.perf_counter()
        nu[side] = mod.non_uniform_partition(freq, banks, capacity_rows=cap)
        out["non_uniform_s"][side].append(time.perf_counter() - t0)
        print(f"non_uniform_partition, {side}: "
              f"{out['non_uniform_s'][side][-1]:.3f} s [{card}]", flush=True)
    for f in ("bank_of_row", "slot_of_row", "rows_per_bank", "load_per_bank"):
        if not np.array_equal(getattr(nu["old"], f), getattr(nu["new"], f)):
            print(f"host_compare: FAIL: non_uniform plans differ in {f}",
                  file=sys.stderr)
            return 1
    plan = plans["new"]
    fcp = new_cr.cap_cache_plan(cp, new_cr.entry_banks(
        cp, plan.bank_of_row, plan.cache_bank_of_entry), banks, 16)
    batches = [requests(64) for _ in range(4)]
    rewriters = {}
    for side, mod in (("old", old_cr), ("new", new_cr)):
        rewriters[side] = mod.VersionedCacheRewriter(
            max_cache_per_bag=max(2, L // 4), max_residual_per_bag=L)
        rewriters[side].install(fcp, None)
    got = {}
    for side in ("old", "new", "new", "old"):
        for i, u in enumerate(batches):
            t0 = time.perf_counter()
            got[side, i] = rewriters[side].rewrite_rect(u)
            out["rewrite_ms"][side].append((time.perf_counter() - t0) * 1e3)
    for i in range(len(batches)):
        a, b = got["old", i], got["new", i]
        if not (np.array_equal(a.cache_idx, b.cache_idx)
                and np.array_equal(a.residual_idx, b.residual_idx)):
            print(f"host_compare: FAIL: rewrites of batch {i} differ",
                  file=sys.stderr)
            return 1
    hits = int(sum((got["new", i].cache_idx >= 0).sum()
                   for i in range(len(batches))))
    out.update(kept_entries=fcp.n_entries, cache_hits=hits)
    for side in ("old", "new"):
        r = out["rewrite_ms"][side]
        print(f"rewrite of a batch of 64, {side}: median "
              f"{sorted(r)[len(r) // 2]:.3f} ms, range {min(r):.3f}-"
              f"{max(r):.3f} ms over {len(r)} rewrites [{card}]")
    lists = {}
    for side in ("old", "new", "new", "old"):
        t0 = time.perf_counter()
        if side == "old":
            lists[side] = [old_cr.rewrite_bag(b, fcp.plan) for b in window]
        else:
            matcher = new_cr.SubsetMatcher(fcp.plan)
            lists[side] = [matcher.rewrite(b) for b in window]
        out["window_rewrite_ms"][side].append(
            (time.perf_counter() - t0) * 1e3)
    if lists["old"] != lists["new"]:
        print("host_compare: FAIL: window rewrites differ", file=sys.stderr)
        return 1
    for side in ("old", "new"):
        r = out["window_rewrite_ms"][side]
        print(f"replanner window rewrite ({len(window)} bags), {side}: "
              + ", ".join(f"{x:.3f}" for x in r) + f" ms [{card}]")
    print(f"plans equal bit for bit; rewrites equal ({fcp.n_entries} kept "
          f"entries of {cp.n_entries} mined, {hits} cache hits in "
          f"{len(batches)} batches)")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
