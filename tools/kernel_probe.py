#!/usr/bin/env python3
"""Probe of the sorted-run scatter (``csrc/ct_scatter.cu``) and the tiered
bag (``csrc/tiered_bag.cu``) on one CUDA card, beside earlier versions of
the same sources.

    python3 tools/kernel_probe.py [--old DIR] [--out DIR] [--reps N]

Builds both kernels from ``src/repro_torch/kernels/csrc`` (ptxas's register
and shared-memory report printed) and, with ``--old``, the same two files
from DIR with the same flags (the scatter's C entry there without
``run_of``, as before ``ScatterRuns`` carried it: for example the parent
commit's sources unpacked with ``git archive``). Then:

* SASS: ``cuobjdump -sass`` of every library into ``--out``, and for each
  kernel function its registers, its instruction mix, and the longest
  batch of global loads issued before a floating-point add or multiply;
* ``chip_smoke.py``'s adversarial run layouts and tiered tables, the new
  kernels against their plain versions, bit for bit;
* the scatter on three synthetic id streams of the train path's size (512
  bags x 256 entries, D = 32 fp32, 8 fields x 2,360,650 rows): uniform ids,
  Zipf(1.18) ids with 5% holes, and Zipf(1.05) ids with Poisson(256) bag
  lengths cut to 256, under a slot layout that puts each bank's hottest
  rows first (rows dealt to 8 banks in popularity order), so hot runs sit
  side by side as under the paper's partition. Each version held bit for
  bit against the plain version, then timed in turns (CUDA events, L2
  flushed, median), beside ``index_add_``, the rows' writes alone
  (``index_copy_``), and the new kernel on the runs of at most 64 entries
  alone and on the longer runs alone; one run of 2,048 to 32,768 entries
  (the span blocks' cost per entry); device time by kernel name
  (``torch.profiler``) on the Zipf streams;
* the tiered bag at the adaptive serve shape (512 bags x 256 Zipf(1.05)
  ids with 2.5% holes, D = 32, bf16 hot / int8 / int4 rows at 1% / 9% /
  90% over 18.9 M rows), each version held bit for bit against the plain
  version and timed in turns, and the new kernel on the same ids packed
  into 65,536 rows (L2-resident).

Prints one JSON line and writes it to ``--out``. Needs a CUDA card and
``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ("ct_scatter", "tiered_bag")
FIELDS, ROWS, NB_BAGS, L, D = 8, 2_360_650, 512, 256, 32
_P, _I = ctypes.c_void_p, ctypes.c_int
SCATTER_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
OLD_SCATTER_ARGS = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
TIERED_ARGS = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
               _I, _P]


def build_old(src_dir: Path, nvcc: str, flags) -> dict:
    """Compile ``src_dir/<name>.cu`` for each kernel into ``src_dir``; the
    libraries, loaded."""
    libs = {}
    for name in KERNELS:
        so = src_dir / f"{name}.so"
        r = subprocess.run([nvcc, *flags, "-o", str(so),
                            str(src_dir / f"{name}.cu")],
                           capture_output=True, text=True)
        print(f"--- {src_dir.name}/{name}.cu (nvcc exit {r.returncode}) ---\n"
              f"{r.stdout}{r.stderr}", flush=True)
        if r.returncode != 0:
            raise SystemExit(f"{src_dir}/{name}.cu did not build")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def entry(lib, symbol, argtypes):
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return fn


def sass_summary(so: Path, out_dir: Path, tag: str) -> dict:
    """Registers, instruction mix and the longest load batch of each kernel
    function in ``so`` (``cuobjdump`` beside nvcc); the SASS to out_dir."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    r = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        return {"error": r.stderr.strip()[:400]}
    (out_dir / f"{tag}.sass").write_text(r.stdout)
    res = subprocess.run([cuobjdump, "-res-usage", str(so)],
                         capture_output=True, text=True).stdout
    regs = {}
    for m in re.finditer(r"Function (\S+):\s*\n\s*REG:(\d+)", res):
        regs[m.group(1)] = int(m.group(2))
    out = {}
    for fn, body in re.findall(r"Function : (\S+)\n(.*?)(?=\n\s*\.{5,}|\Z)",
                               r.stdout, re.S):
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_]+)",
                         body)
        mix, batch, best = {}, 0, 0
        for op in ops:
            mix[op] = mix.get(op, 0) + 1
            if op.startswith("LDG"):
                batch += 1
                best = max(best, batch)
            elif op in ("FADD", "FMUL", "FFMA"):
                batch = 0
        keep = {k: v for k, v in mix.items()
                if k.startswith(("LDG", "STG", "LDS", "STS", "SHFL", "BAR",
                                 "FADD", "FMUL", "FFMA", "BRA", "ATOMS",
                                 "VOTE"))}
        out[fn[:90]] = dict(regs=regs.get(fn), n_instr=len(ops),
                            longest_load_batch=best, mix=keep)
    return out


def time_pairs(fns: dict, flush, reps: int) -> dict:
    """Median ms of each fn, timed in the order given and then reversed
    (old, new, new, old), CUDA events, flush() before each run."""
    import torch
    from chip_smoke import time_ms
    got = {k: [] for k in fns}
    for order in (list(fns), list(fns)[::-1]):
        for k in order:
            got[k].append(time_ms(fns[k], reps=reps, flush=flush))
    return {k: sorted(v) for k, v in got.items()}


def zipf_ids(rng, a, n_items, shape, p_hole=0.0):
    import numpy as np
    ranks = np.arange(1, n_items + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** (-a))
    cdf /= cdf[-1]
    ids = np.searchsorted(cdf, rng.random(shape), side="right")
    ids = np.minimum(ids, n_items - 1).astype(np.int32)
    if p_hole:
        ids[rng.random(shape) < p_hole] = -1
    return ids


def banked_slots(n_rows_field, fields, n_banks, dev):
    """Row r of field f has popularity rank r (ids are ranks); rows dealt
    to the banks in rank order (the hottest row of every field first), so
    bank b's slots start with the hottest rows it holds."""
    import torch
    V = n_rows_field * fields
    rank_major = torch.arange(V, device=dev)
    # order: rank 0 of every field, rank 1 of every field, ...
    row = (rank_major % fields) * n_rows_field + rank_major // fields
    per_bank = -(-V // n_banks)
    bank = rank_major % n_banks
    slot = torch.empty(V, dtype=torch.int32, device=dev)
    slot[row] = (bank * per_bank + rank_major // n_banks).to(torch.int32)
    bank_of = torch.empty(V, dtype=torch.int32, device=dev)
    bank_of[row] = bank.to(torch.int32)
    return bank_of, slot, n_banks * per_bank


def subset_runs(runs, keep):
    """The runs of ``runs`` where ``keep`` (one bool per live run) holds,
    their entries gathered in order, padded back to the same shapes."""
    import torch
    from repro_torch.kernels.embedding_bag import ScatterRuns
    n = int(runs.n_run[0])
    starts = runs.run_starts[:n + 1].long()
    lens = (starts[1:] - starts[:-1])[keep]
    new_starts = torch.cat([lens.new_zeros(1), lens.cumsum(0)])
    total = int(new_starts[-1])
    within = torch.arange(total, device=lens.device) - torch.repeat_interleave(
        new_starts[:-1], lens)
    src = torch.repeat_interleave(starts[:-1][keep], lens) + within
    E, m = runs.bag_sorted.shape[0], int(keep.sum())
    bag_sorted = torch.zeros(E, dtype=torch.int32, device=lens.device)
    bag_sorted[:total] = runs.bag_sorted[src]
    run_starts = torch.full((E + 1,), total, dtype=torch.int32,
                            device=lens.device)
    run_starts[:m + 1] = new_starts.to(torch.int32)
    run_slot = torch.zeros(E, dtype=torch.int32, device=lens.device)
    run_slot[:m] = runs.run_slot[:n][keep]
    run_of = torch.full((E,), max(m - 1, 0), dtype=torch.int32,
                        device=lens.device)
    run_of[:total] = torch.repeat_interleave(
        torch.arange(m, device=lens.device), lens).to(torch.int32)
    return ScatterRuns(bag_sorted, run_starts, run_slot,
                       torch.full((1,), m, dtype=torch.int32,
                                  device=lens.device), run_of)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory with an earlier ct_scatter.cu and "
                         "tiered_bag.cu to build and time beside")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "probe",
                    help="where the SASS and the JSON line go")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed runs per median")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: no CUDA card")
    from chip_smoke import card_line
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as kb
    from repro_torch.quant import TIER_HOT, TIER_INT8, quantize_rows
    dev = torch.device("cuda")
    args.out.mkdir(parents=True, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    logs = _build.build(KERNELS)
    for n, log in logs.items():
        print(f"--- {n}.cu ---\n{log}", flush=True)
    new = {n: ctypes.CDLL(str(_build.target(n))) for n in KERNELS}
    old = build_old(args.old, _build._nvcc(), _build.NVCC_FLAGS) \
        if args.old else {}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"card": card, "sass": {}}
    for n in KERNELS:
        result["sass"][f"new {n}"] = sass_summary(_build.target(n), args.out,
                                                  f"new_{n}")
        if old:
            result["sass"][f"old {n}"] = sass_summary(
                args.old / f"{n}.so", args.out, f"old_{n}")
    print(json.dumps(result["sass"], indent=1), flush=True)

    from chip_smoke import check_scatter_adversarial, tiered_adversarial_cases
    print("scatter adversarial cases:", flush=True)
    check_scatter_adversarial(dev, [])
    for c in tiered_adversarial_cases(dev):
        for my in (-1, 1):
            a = (c["payload"], c["scale"], c["tier"], c["bank"], c["slot"],
                 c["off"], my, c["idx"])
            got = kb.tiered_bag(*a, dim=c["dim"], hot_dtype=c["hot"])
            want = kb.tiered_bag_plain(*a, dim=c["dim"], hot_dtype=c["hot"])
            if not torch.equal(got, want):
                raise SystemExit(f"tiered {c['name']} my={my}: != plain")
        print(f"  tiered {c['name']}: == plain (my = -1, 1)", flush=True)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    flush = scratch.zero_
    rng = np.random.default_rng(0)
    bank, slot, n_rows = banked_slots(ROWS, FIELDS, 8, dev)
    off = torch.arange(FIELDS, dtype=torch.int32, device=dev) * ROWS
    g = torch.Generator(device=dev).manual_seed(1)
    ct = torch.randn((NB_BAGS, D), generator=g, device=dev)

    def scatter_fn(lib, with_run_of=True):
        """The library's scatter entry (the old one has no run_of)."""
        fn = entry(lib, "ct_scatter_runs",
                   SCATTER_ARGS if with_run_of else OLD_SCATTER_ARGS)

        def call(runs, out, c=ct):
            head = (c.data_ptr(), kb._DTYPES[c.dtype],
                    runs.bag_sorted.data_ptr(), runs.run_starts.data_ptr(),
                    runs.run_slot.data_ptr())
            tail = (out.data_ptr(), kb._DTYPES[out.dtype],
                    runs.run_slot.shape[0])
            if with_run_of:
                err = fn(*head, runs.run_of.data_ptr(),
                         runs.n_run.data_ptr(), *tail,
                         runs.run_of.shape[0], c.shape[1], 0,
                         torch.cuda.current_stream().cuda_stream)
            else:
                err = fn(*head, runs.n_run.data_ptr(), *tail, c.shape[1], 0,
                         torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"scatter launch failed: {err}")
            return out
        return call

    poisson = np.minimum(rng.poisson(256, (NB_BAGS,)), L)
    csr_ids = zipf_ids(rng, 1.05, ROWS, (NB_BAGS, L))
    csr_ids[np.arange(L)[None, :] >= poisson[:, None]] = -1
    streams = {
        "uniform": rng.integers(0, ROWS, (NB_BAGS, L)).astype(np.int32),
        "zipf1.18": zipf_ids(rng, 1.18, ROWS, (NB_BAGS, L), 0.05),
        "zipf1.05 poisson": csr_ids,
    }
    scat = {}
    for name, ids in streams.items():
        idx = torch.from_numpy(ids).to(dev)
        runs = kb.scatter_prep(idx, bank, slot, off, -1, n_rows)
        n, n_live, longest = (int(runs.n_run[0]),
                              int(runs.run_starts[int(runs.n_run[0])]), 0)
        lens = runs.run_starts[1:n + 1] - runs.run_starts[:n]
        longest = int(lens.max())
        want = kb.ct_scatter_runs_plain(ct, runs, torch.zeros(
            (n_rows, D), device=dev))
        fns, outs = {}, {}
        for tag, libs in (("old", old), ("new", new)):
            if not libs:
                continue
            call = scatter_fn(libs["ct_scatter"], tag == "new")
            out = torch.zeros((n_rows, D), device=dev)
            call(runs, out)
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise SystemExit(f"scatter {tag} {name}: != plain")
            outs[tag] = out
            fns[tag] = (lambda call=call, out=out: call(runs, out))
        dest, bags = kb.scatter_entries(idx, bank, slot, off, -1, n_rows)
        keep = dest < n_rows
        ld, lb = dest[keep].long(), bags[keep].long()
        lib_out = torch.zeros((n_rows, D), device=dev)
        fns["index_add_"] = lambda: lib_out.index_add_(0, ld, ct[lb])
        # a floor for the writes alone: the runs' finished rows copied to
        # their slots by one PyTorch call
        w_slots = runs.run_slot[:n].long()
        w_rows = want[w_slots].clone()
        w_out = torch.zeros((n_rows, D), device=dev)
        fns["rows written alone (index_copy_)"] = (
            lambda: w_out.index_copy_(0, w_slots, w_rows))
        for part, keep in (("runs <= 64 only", lens <= 64),
                           ("runs > 64 only", lens > 64)):
            if not bool(keep.any()):
                continue
            sub = subset_runs(runs, keep)
            call = scatter_fn(new["ct_scatter"])
            sub_out = torch.zeros((n_rows, D), device=dev)
            fns[f"new, {part}"] = (lambda call=call, sub=sub, o=sub_out:
                                   call(sub, o))
        ms = time_pairs(fns, flush, args.reps)
        scat[name] = dict(runs=n, live_entries=n_live, longest_run=longest,
                          runs_over_64=int((lens > 64).sum()),
                          entries_in_runs_over_64=int(lens[lens > 64].sum()),
                          ms=ms)
        print(f"scatter {name}: {json.dumps(scat[name])}", flush=True)
        del want, outs, lib_out
    result["scatter"] = scat

    # one run of n entries (all ids on one row; identity prep): the span
    # kernel's time against the run's length
    from chip_smoke import profile_device
    single = {}
    call = scatter_fn(new["ct_scatter"])
    calls = {"new": call}
    for n_ent in (2048, 8192, 32768):
        ids1 = torch.full((n_ent // L, L), 5, dtype=torch.int32, device=dev)
        r1 = kb.identity_scatter_prep(ids1, 1000)
        c1 = torch.randn((n_ent // L, D), generator=g, device=dev)
        o1 = torch.zeros((1000, D), device=dev)
        call(r1, o1, c1)
        torch.cuda.synchronize()
        if not torch.equal(o1, kb.ct_scatter_runs_plain(
                c1, r1, torch.zeros((1000, D), device=dev))):
            raise SystemExit(f"scatter one run of {n_ent}: != plain")
        single[n_ent] = time_pairs(
            {tag: (lambda f=f, r1=r1, o1=o1, c1=c1: f(r1, o1, c1))
             for tag, f in calls.items()}, flush, args.reps)
        if n_ent == 32768:
            for tag, f in calls.items():
                single[f"profile {tag}"] = profile_device(
                    lambda f=f, r1=r1, o1=o1, c1=c1: f(r1, o1, c1), n=3)
    result["scatter_one_run"] = single
    print(f"scatter, one run of n entries: {json.dumps(single)}", flush=True)
    # device time by kernel on the zipf streams (the profiler's spans)
    prof = {}
    for name in ("zipf1.18", "zipf1.05 poisson"):
        idx = torch.from_numpy(streams[name]).to(dev)
        runs = kb.scatter_prep(idx, bank, slot, off, -1, n_rows)
        o = torch.zeros((n_rows, D), device=dev)
        prof[name] = profile_device(lambda: call(runs, o), n=5)
    result["scatter_profile"] = prof
    print(f"scatter kernels by name: {json.dumps(prof)}", flush=True)

    # tiered: a bf16-hot / int8 / int4 table of 18.9 M rows
    V = ROWS * FIELDS
    tier = torch.full((V,), 2, dtype=torch.int32, device=dev)
    u = torch.rand(V, generator=g, device=dev)
    tier[u < 0.10] = TIER_INT8
    tier[u < 0.01] = TIER_HOT
    payload = torch.randint(-128, 128, (V, 2 * D), dtype=torch.int8,
                            generator=g, device=dev)
    # hot rows: finite bf16 bits (a quantized row's own encoding)
    hot_rows = torch.nonzero(tier == TIER_HOT).squeeze(1)
    enc, _ = quantize_rows(np.random.default_rng(2).standard_normal(
        (1, D)).astype(np.float32), np.array([TIER_HOT], np.int32),
        hot_dtype="bf16")
    payload[hot_rows] = torch.from_numpy(enc).to(dev)
    scale = torch.rand(V, generator=g, device=dev) * 0.01 + 1e-4
    tslot = torch.randperm(V, generator=g, device=dev).to(torch.int32)
    tbank = torch.zeros(V, dtype=torch.int32, device=dev)
    ids = zipf_ids(rng, 1.05, ROWS, (NB_BAGS, L), 0.025)
    idx = torch.from_numpy(ids).to(dev)
    args_t = (payload, scale, tier, tbank, tslot, off, -1, idx)
    want = kb.tiered_bag_plain(*args_t, dim=D, hot_dtype="bf16")
    fns = {}
    for tag, libs in (("old", old), ("new", new)):
        if not libs:
            continue
        fn = entry(libs["tiered_bag"], "tiered_bag_forward", TIERED_ARGS)
        out = torch.empty((NB_BAGS, D), device=dev)

        def call(fn=fn, out=out):
            err = fn(payload.data_ptr(), 2 * D, scale.data_ptr(),
                     tier.data_ptr(), tbank.data_ptr(), tslot.data_ptr(),
                     off.data_ptr(), FIELDS, -1, idx.data_ptr(),
                     out.data_ptr(), NB_BAGS, L, D, 0, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"tiered launch failed: {err}")
            return out
        call()
        torch.cuda.synchronize()
        if not torch.equal(out, want):
            err = (out - want).abs().max().item()
            raise SystemExit(f"tiered {tag}: != plain (max abs err {err})")
        fns[tag] = call
    # the same ids over 65,536 rows a field packed into the first 65,536
    # slots (4 MB of payload, L2-resident): the kernel without DRAM latency
    small_slot = (torch.arange(V, device=dev) % 65536).to(torch.int32)
    idx_small = torch.where(idx >= 0, idx % 65536, idx)
    if "new" in fns:
        fn = entry(new["tiered_bag"], "tiered_bag_forward", TIERED_ARGS)
        out_s = torch.empty((NB_BAGS, D), device=dev)

        def small():
            err = fn(payload.data_ptr(), 2 * D, scale.data_ptr(),
                     tier.data_ptr(), tbank.data_ptr(), small_slot.data_ptr(),
                     off.data_ptr(), FIELDS, -1, idx_small.data_ptr(),
                     out_s.data_ptr(), NB_BAGS, L, D, 0, 0,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"tiered launch failed: {err}")
        small()
        torch.cuda.synchronize()
        want_s = kb.tiered_bag_plain(payload, scale, tier, tbank, small_slot,
                                     off, -1, idx_small, dim=D,
                                     hot_dtype="bf16")
        if not torch.equal(out_s, want_s):
            raise SystemExit("tiered new, L2-resident rows: != plain")
        fns["new, L2-resident rows"] = small
    result["tiered"] = dict(live_entries=int((idx >= 0).sum()),
                            ms=time_pairs(fns, flush, args.reps))
    print(f"tiered: {json.dumps(result['tiered'])}", flush=True)
    line = json.dumps(result)
    (args.out / "probe.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
