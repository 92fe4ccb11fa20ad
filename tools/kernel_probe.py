#!/usr/bin/env python3
"""Probe of the sorted-run scatter (``csrc/ct_scatter.cu``), the tiered
bag (``csrc/tiered_bag.cu``), the banked bag (``csrc/banked_bag.cu``), the
interaction (``csrc/dot_interaction.cu``), the fused cache bag
(``csrc/cache_bag.cu``) and the CSR bag (``csrc/csr_bag.cu``) on one CUDA
card, beside earlier versions of the same sources.

    python3 tools/kernel_probe.py [--old DIR] [--out DIR] [--reps N]
                                  [--kernels scatter,tiered,bag,dot,dotwide,
                                             cache,csr]

Builds the kernels from ``src/repro_torch/kernels/csrc`` (ptxas's register
and shared-memory report printed) and, with ``--old``, the same files from
DIR with the same flags (the scatter's C entry there without ``run_of``,
as before ``ScatterRuns`` carried it; the bag, cache and CSR entries there
without the launch geometry and the interaction entry without its copy
width, as the C entries of the first designs took them: for example the
parent commit's sources unpacked with ``git archive``). ``--kernels``
picks the parts to run (all by default).
Then:

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
  alone and on the longer runs alone; one run of 2,048 to 2^21 entries
  (the span blocks' cost, and their ns an entry); device time by kernel name
  (``torch.profiler``) on the Zipf streams;
* the tiered bag at the adaptive serve shape (512 bags x 256 Zipf(1.05)
  ids with 2.5% holes, D = 32, bf16 hot / int8 / int4 rows at 1% / 9% /
  90% over 18.9 M rows), each version held bit for bit against the plain
  version and timed in turns, and the new kernel on the same ids packed
  into 65,536 rows (L2-resident);
* the banked bag at the serve shape (512 bags x 256 uniform ids, D = 32
  fp32, 8 fields x 2,360,650 rows under the banked slot layout above):
  the single copy (row 1, ``kRemap``), the replica select at k_max = 4
  (row 1r, ``kReplica``, random (V x 4,) remaps) and the identity instance
  on the ids resolved (row 7, ``kIdentity``), each version held bit for
  bit against the plain version, then timed in turns beside one
  ``F.embedding_bag`` on the resolved ids, with the profiler's kernel time;
  the new kernel also on the same ids folded into 4,096 rows a field
  (L2-resident, no flush); both versions on padding only at 132, 512 and
  2,048 bags and on empty bags (what a bag costs with no row read); the new
  kernel under other launch geometries (1 or 2 bags a block, 1 or 8
  stages) with its resident blocks an SM; ``chip_smoke.py``'s adversarial
  bag cases on the new kernel;
* the interaction at (64, 9, 32) fp32 (no flush, as ``chip_smoke.py``
  times it): the old and new z entries and the new fused entry, each
  against its plain version, timed in turns beside ``bmm``;
* ``dotwide``: the interaction at dlrm-rm2's 27 fields, fp32 (no flush:
  each call moves GBs): the old and new fused entries at (262,144, 27,
  64) and (10^6, 27, 64), each against its plain version, timed in turns
  beside ``bmm`` + triangle and their bound; at 10^6 also the new query
  entry (x and 25 user rows against the 10^6 candidate rows) against its
  plain version, timed with them.
* the fused cache bag at the cached serve's shape (512 bags, Lc = 64 with
  3-5 live entries, Lr = 256 with 80-141 live rows, D = 32 fp32, the banked
  table above as the EMT, a 128-row cache table): the fused instance (row
  4) and the identity instance on the ids resolved (row 8), each version
  held bit for bit against its plain version and timed in turns beside one
  ``F.embedding_bag`` over both tables stacked, with the profiler's kernel
  time; both versions on streams of padding only; ``chip_smoke.py``'s
  adversarial cache cases on the new kernel;
* the CSR bag at the CSR path's shape (512 Poisson(256) bags of Zipf(1.05)
  ids over the banked table, D = 32 fp32; row 5): each version held bit for
  bit against the plain version and timed in turns beside
  ``F.embedding_bag``, with the profiler's kernel time; both versions on
  the same ranges of holes only and on empty bags; ``chip_smoke.py``'s
  adversarial CSR cases on the new kernel.

Prints one JSON line and writes it to ``--out``. Needs a CUDA card and
``nvcc``; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

KERNELS = ("ct_scatter", "tiered_bag", "banked_bag", "dot_interaction",
           "cache_bag", "csr_bag")
PARTS = {"scatter": "ct_scatter", "tiered": "tiered_bag", "bag": "banked_bag",
         "dot": "dot_interaction", "dotwide": "dot_interaction",
         "cache": "cache_bag", "csr": "csr_bag"}
FIELDS, ROWS, NB_BAGS, L, D = 8, 2_360_650, 512, 256, 32
_P, _I = ctypes.c_void_p, ctypes.c_int
SCATTER_ARGS = [_P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
OLD_SCATTER_ARGS = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P]
TIERED_ARGS = [_P, _I, _P, _P, _P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I,
               _I, _P]
OLD_BAG_ARGS = [_P, _I, _P, _P, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _P]
BAG_ARGS = OLD_BAG_ARGS + [_I, _I, _I]
OLD_PLAIN_BAG_ARGS = [_P, _I, _P, _P, _I, _I, _I, _I, _P]
PLAIN_BAG_ARGS = OLD_PLAIN_BAG_ARGS + [_I, _I, _I]
OLD_DOT_ARGS = [_P, _I, _P, _I, _I, _I, _I, _I, _P]
DOT_ARGS = OLD_DOT_ARGS + [_I]
FEATURES_ARGS = [_P, _P, _I, _P, _I, _I, _I, _I, _I, _P, _I]
# the earlier cache and CSR entries took no launch geometry
OLD_CACHE_ARGS = [_P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                  _I, _P]
CACHE_ARGS = OLD_CACHE_ARGS + [_I, _I, _I]
OLD_PLAIN_CACHE_ARGS = [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P]
PLAIN_CACHE_ARGS = OLD_PLAIN_CACHE_ARGS + [_I, _I, _I]
OLD_CSR_ARGS = [_P, _I, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _P]
CSR_ARGS = OLD_CSR_ARGS + [_I, _I, _I]
LC, LR, CACHE_ROWS = 64, 256, 128     # the cached serve's streams and cache


def build_old(src_dir: Path, nvcc: str, flags, names=KERNELS) -> dict:
    """Compile ``src_dir/<name>.cu`` for each kernel in ``names`` into
    ``src_dir``, all nvcc processes at once; the libraries, loaded."""
    procs = {}
    for name in names:
        so = src_dir / f"{name}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-o", str(so), str(src_dir / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        so = src_dir / f"{name}.so"
        log, _ = proc.communicate()
        print(f"--- {src_dir.name}/{name}.cu (nvcc exit {proc.returncode}) "
              f"---\n{log}", flush=True)
        if proc.returncode != 0:
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


def probe_bag(dev, new, old, bank, slot, n_rows, off, flush, rng, reps):
    """Rows 1, 1r and 7 of the bag kernel at the serve shape, old against
    new in turns, each held bit for bit against its plain version; the
    library call on the resolved ids; the new kernel on L2-resident rows;
    then chip_smoke.py's adversarial bag cases on the new kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from chip_smoke import bag_bound_ms, check_bag_adversarial
    from repro_torch.kernels import embedding_bag as kb
    g = torch.Generator(device=dev).manual_seed(3)
    table = torch.randn((n_rows, D), generator=g, device=dev)
    idx = torch.from_numpy(rng.integers(0, ROWS, (NB_BAGS, L))
                           .astype(np.int32)).to(dev)
    V = ROWS * FIELDS
    k = 4
    rbank = torch.randint(0, 8, (V * k,), generator=g, device=dev,
                          dtype=torch.int32)
    rslot = torch.randint(0, n_rows, (V * k,), generator=g, device=dev,
                          dtype=torch.int32)
    bag = torch.arange(NB_BAGS, device=dev)
    rows = idx.long() + off.long()[bag % FIELDS][:, None]
    resolved = slot[rows].to(torch.int32)
    # the same ids folded into 4,096 rows a field, slots the rows
    # themselves: 4 MB of rows, L2-resident when timed without a flush
    small_idx = idx % 4096
    small_slot = torch.arange(V, device=dev, dtype=torch.int32) % (
        4096 * FIELDS)
    small_off = torch.arange(FIELDS, dtype=torch.int32, device=dev) * 4096
    cases = {
        "1 single copy (kRemap)": dict(
            args=(table, bank, slot, off, -1, idx, 1), bound=bag_bound_ms(
                idx, off, FIELDS, D, 4, slot=slot)),
        "1r replica select k_max=4 (kReplica)": dict(
            args=(table, rbank, rslot, off, -1, idx, k), bound=bag_bound_ms(
                idx, off, FIELDS, D, 4, k_max=k, slot=rslot)),
        "7 identity (kIdentity)": dict(
            args=(table, resolved), bound=bag_bound_ms(
                resolved, off[:1] * 0, 1, D, 4, remap=False)),
    }
    out = {}
    for name, c in cases.items():
        a = c["args"]
        identity = len(a) == 2
        want = kb.plain_bag_plain(*a) if identity else kb.banked_bag_plain(*a)
        fns = {}
        for tag, libs in (("old", old), ("new", new)):
            if not libs:
                continue
            sym = "plain_bag_forward" if identity else "banked_bag_forward"
            argt = {("old", False): OLD_BAG_ARGS, ("new", False): BAG_ARGS,
                    ("old", True): OLD_PLAIN_BAG_ARGS,
                    ("new", True): PLAIN_BAG_ARGS}[tag, identity]
            fn = entry(libs["banked_bag"], sym, argt)
            res = torch.empty((NB_BAGS, D), device=dev)
            geo = kb._geometry_args(table, NB_BAGS, L) if tag == "new" \
                else ()

            def call(fn=fn, res=res, geo=geo, a=a, identity=identity):
                stream = torch.cuda.current_stream().cuda_stream
                if identity:
                    err = fn(a[0].data_ptr(), 0, a[1].data_ptr(),
                             res.data_ptr(), NB_BAGS, L, D, 0, stream, *geo)
                else:
                    err = fn(a[0].data_ptr(), 0, a[1].data_ptr(),
                             a[2].data_ptr(), a[3].data_ptr(), FIELDS, a[4],
                             a[6], a[5].data_ptr(), res.data_ptr(), NB_BAGS,
                             L, D, 0, stream, *geo)
                if err:
                    raise RuntimeError(f"bag launch failed: {err}")
                return res
            call()
            torch.cuda.synchronize()
            if not torch.equal(res, want):
                raise SystemExit(f"bag {name} {tag}: != plain")
            fns[tag] = call
        # the library call on the rows resolved beforehand (live only)
        ids = a[1] if identity else slot_rows(a, off)
        valid = ids >= 0
        lib_ids = ids[valid].long()
        lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                                 valid.sum(1).cumsum(0)[:-1]])
        fns["F.embedding_bag"] = lambda i=lib_ids, o=lib_offsets: \
            tnf.embedding_bag(i, table, o, mode="sum")
        ms = time_pairs(fns, flush, reps)
        out[name] = dict(ms=ms, bound_ms=c["bound"][0],
                         live_entries=int(valid.sum()))
        if name.startswith("1 "):
            from chip_smoke import profile_device
            out[name]["profiled"] = {
                tag: (profile_device(f, n=5) or {}).get("top_kernels_ms")
                for tag, f in fns.items() if tag in ("old", "new")}
            out[name]["floors"] = bag_floors(dev, new, old, a, flush, reps)
        if name.startswith("1 "):
            sa = (table, bank, small_slot, small_off, -1, small_idx, 1)
            if not torch.equal(kb.banked_bag(*sa), kb.banked_bag_plain(*sa)):
                raise SystemExit("bag new, L2-resident rows: != plain")
            out[name]["new, L2-resident rows, no flush"] = time_pairs(
                {"new": lambda sa=sa: kb.banked_bag(*sa)}, None, reps)["new"]
        print(f"bag {name}: {json.dumps(out[name])}", flush=True)
    out["geometry sweep, row 1"] = sweep_bag_geometry(
        dev, new, table, bank, slot, off, idx, small_slot, small_off,
        small_idx, flush, reps)
    errs = []
    check_bag_adversarial(dev, errs)
    out["adversarial_calls"] = len(errs)
    return out


def sweep_bag_geometry(dev, new, table, bank, slot, off, idx, small_slot,
                       small_off, small_idx, flush, reps):
    """Row 1 of the new kernel under other launch geometries than the
    wrapper's (bags per block 1 or 2; 1, 2, 4 or 8 stages), each with its
    resident blocks an SM (``banked_bag_occupancy``): the serve ids from
    DRAM (L2 flushed), the same ids folded into L2-resident rows (no
    flush), and a stream of padding only (the resolve and the loops, no
    row copied)."""
    import ctypes as ct
    import torch
    from chip_smoke import profile_device
    from repro_torch.kernels import embedding_bag as kb
    fn = entry(new["banked_bag"], "banked_bag_forward", BAG_ARGS)
    occ = entry(new["banked_bag"], "banked_bag_occupancy",
                [_I, _I, _I, _I, _I, _I, _I, ct.POINTER(ct.c_int)])
    res = torch.empty((NB_BAGS, D), device=dev)
    pad = torch.full_like(idx, -1)
    out = {}
    for bpb in (1, 2):
        for stages in (1, 8):
            smem = bpb * (1024 + stages * 32 * 128)
            blocks = ct.c_int(0)
            err = occ(0, D, 1, bpb, smem, 16, 0, ct.byref(blocks))
            if err:
                raise RuntimeError(f"occupancy query failed: {err}")
            geo = (bpb, stages, 16)

            def run(tab=table, bk=bank, sl=slot, of=off, ix=idx, geo=geo):
                err = fn(tab.data_ptr(), 0, bk.data_ptr(), sl.data_ptr(),
                         of.data_ptr(), FIELDS, -1, 1, ix.data_ptr(),
                         res.data_ptr(), NB_BAGS, L, D, 0,
                         torch.cuda.current_stream().cuda_stream, *geo)
                if err:
                    raise RuntimeError(f"bag launch failed: {err}")
                return res
            run()
            torch.cuda.synchronize()
            if not torch.equal(res, kb.banked_bag_plain(
                    table, bank, slot, off, -1, idx)):
                raise SystemExit(f"bag geometry {geo}: != plain")
            key = f"bags/block {bpb}, stages {stages}"
            prof = profile_device(run, n=5)
            prof_pad = profile_device(lambda run=run: run(ix=pad), n=5)
            out[key] = dict(
                kernel_ms_profiled=prof and prof["top_kernels_ms"],
                padding_only_kernel_ms_profiled=prof_pad and prof_pad[
                    "top_kernels_ms"],
                two_launches_ms=time_pairs({"k": lambda run=run: (
                    run(), run())}, flush, reps)["k"],
                blocks_per_sm=blocks.value, smem=smem,
                dram_ms=time_pairs({"k": run}, flush, reps)["k"],
                l2_ms=time_pairs({"k": lambda run=run: run(
                    sl=small_slot, of=small_off, ix=small_idx)}, None,
                    reps)["k"],
                padding_only_ms=time_pairs({"k": lambda run=run: run(
                    ix=pad)}, None, reps)["k"])
            print(f"bag geometry {key}: {json.dumps(out[key])}", flush=True)
    return out


def bag_floors(dev, new, old, args, flush, reps):
    """Where the single-copy kernel's time goes when no row is read: each
    version on a stream of padding only at 132, 512 and 2,048 bags (one
    bag an SM, the serve batch, four serve batches), and on bags of no
    entry (the launch and the output's stores alone); CUDA events and the
    profiler's kernel time."""
    import torch
    from chip_smoke import profile_device
    from repro_torch.kernels import embedding_bag as kb
    table, bank, slot, off = args[:4]
    out = {}
    for tag, libs in (("old", old), ("new", new)):
        if not libs:
            continue
        fn = entry(libs["banked_bag"], "banked_bag_forward",
                   BAG_ARGS if tag == "new" else OLD_BAG_ARGS)
        for nb, bag_len in ((132, L), (512, L), (2048, L), (512, 0)):
            ids = torch.full((nb, max(bag_len, 1)), -1, dtype=torch.int32,
                             device=dev)
            res = torch.empty((nb, D), device=dev)
            geo = kb._geometry_args(table, nb, bag_len) if tag == "new" \
                else ()

            def run(fn=fn, ids=ids, res=res, nb=nb, bag_len=bag_len,
                    geo=geo):
                err = fn(table.data_ptr(), 0, bank.data_ptr(),
                         slot.data_ptr(), off.data_ptr(), FIELDS, -1, 1,
                         ids.data_ptr(), res.data_ptr(), nb, bag_len, D, 0,
                         torch.cuda.current_stream().cuda_stream, *geo)
                if err:
                    raise RuntimeError(f"bag launch failed: {err}")
            run()
            torch.cuda.synchronize()
            if bool(res.any()):
                raise SystemExit(f"bag {tag} padding only: not zero")
            prof = profile_device(run, n=5)
            out[f"{tag} NB={nb} L={bag_len}"] = dict(
                ms=time_pairs({"k": run}, None, reps)["k"],
                profiled=prof and prof["top_kernels_ms"][0][1])
    print(f"bag floors: {json.dumps(out)}", flush=True)
    return out


def slot_rows(args, off):
    """The table rows a single-copy or replicated bag call reads (its
    entries resolved through the remaps; -1 where an entry adds nothing)."""
    import torch
    from repro_torch.kernels.embedding_bag import replica_of_bag
    table, bank, slot, _, my, idx, k_max = args
    n = torch.arange(idx.shape[0], device=idx.device)
    rows = idx.long() + off.long()[n % off.shape[0]][:, None]
    if k_max > 1:
        rows = rows * k_max + replica_of_bag(n, k_max).long()[:, None]
    return torch.where(idx >= 0, slot[rows.clamp(min=0)], -1)


def timed_versions(tag_calls, want, what, flush, reps, extra=None):
    """Each version's call held bit for bit against ``want``, then all of
    them (and ``extra``, untested library calls) timed in turns, and the
    versions' device time by kernel name from the profiler."""
    import torch
    from chip_smoke import profile_device
    for tag, call in tag_calls.items():
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            err = (got.float() - want.float()).abs().max().item()
            raise SystemExit(f"{what} {tag}: != plain (max abs err {err})")
    fns = dict(tag_calls, **(extra or {}))
    return dict(ms=time_pairs(fns, flush, reps),
                profiled={tag: (profile_device(f, n=5) or {}).get(
                    "top_kernels_ms") for tag, f in tag_calls.items()})


def probe_cache(dev, new, old, bank, slot, n_rows, flush, rng, reps):
    """Rows 4 and 8 (``cache_bag.cu``, fused and identity instances) at the
    cached serve's shape (512 bags, Lc = 64 with 3-5 live cache entries,
    Lr = 256 with 80-141 live residual rows, D = 32 fp32, the EMT of 8
    fields x 2,360,650 rows under the banked slot layout, a 128-row
    8-bank cache table), old against new in turns beside the library
    call(s), with the profiler's kernel time; both versions on padding
    only (the resolve alone, no row copied); then ``chip_smoke.py``'s
    adversarial cache cases on the new kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from chip_smoke import cache_bag_bound_ms, check_cache_adversarial
    from repro_torch.kernels import embedding_bag as kb
    g = torch.Generator(device=dev).manual_seed(7)
    table = torch.randn((n_rows, D), generator=g, device=dev)
    cache = torch.randn((CACHE_ROWS, D), generator=g, device=dev)
    c_bank = torch.arange(CACHE_ROWS, dtype=torch.int32, device=dev) % 8
    c_slot = torch.randperm(CACHE_ROWS, generator=g, device=dev).to(
        torch.int32)
    V = ROWS * FIELDS
    c_len = rng.integers(3, 6, NB_BAGS)
    r_len = np.clip(rng.normal(113, 12, NB_BAGS).round(), 80, 141)
    ci = np.where(np.arange(LC) < c_len[:, None],
                  rng.integers(0, CACHE_ROWS, (NB_BAGS, LC)), -1)
    ri = np.where(np.arange(LR) < r_len[:, None],
                  rng.integers(0, V, (NB_BAGS, LR)), -1)
    ci = torch.from_numpy(ci.astype(np.int32)).to(dev)
    ri = torch.from_numpy(ri.astype(np.int32)).to(dev)
    ci_rows = torch.where(ci >= 0, c_slot[ci.clamp(min=0).long()], -1)
    ri_rows = torch.where(ri >= 0, slot[ri.clamp(min=0).long()], -1)
    pad_c, pad_r = torch.full_like(ci, -1), torch.full_like(ri, -1)
    res = torch.empty((NB_BAGS, D), device=dev)
    both = torch.cat([table, cache])
    out = dict(live_cache_entries=int((ci >= 0).sum()),
               live_residual_entries=int((ri >= 0).sum()))

    def version(libs, tag, identity):
        sym = "plain_cache_bag_forward" if identity else "cache_bag_forward"
        argt = {("old", False): OLD_CACHE_ARGS, ("new", False): CACHE_ARGS,
                ("old", True): OLD_PLAIN_CACHE_ARGS,
                ("new", True): PLAIN_CACHE_ARGS}[tag, identity]
        fn = entry(libs["cache_bag"], sym, argt)
        g = kb.ring_geometry(NB_BAGS, LC + LR, D, 4, table.data_ptr(),
                             cache.data_ptr())
        geo = (g.bags_per_block, g.stages, g.vec) if tag == "new" else ()

        def call(c=ci, r=ri):
            stream = torch.cuda.current_stream().cuda_stream
            if identity:
                err = fn(table.data_ptr(), cache.data_ptr(), 0, c.data_ptr(),
                         r.data_ptr(), res.data_ptr(), NB_BAGS, LC, LR, D, 0,
                         stream, *geo)
            else:
                err = fn(table.data_ptr(), cache.data_ptr(), 0,
                         bank.data_ptr(), slot.data_ptr(), c_bank.data_ptr(),
                         c_slot.data_ptr(), -1, c.data_ptr(), r.data_ptr(),
                         res.data_ptr(), NB_BAGS, LC, LR, D, 0, stream, *geo)
            if err:
                raise RuntimeError(f"cache bag launch failed: {err}")
            return res
        return call

    for name, identity in (("4 fused (kRemap)", False),
                           ("8 identity (kIdentity)", True)):
        c_ids, r_ids = (ci_rows, ri_rows) if identity else (ci, ri)
        want = kb.plain_cache_bag_plain(table, cache, c_ids, r_ids) \
            if identity else kb.cache_residual_bag_plain(
                table, cache, bank, slot, c_bank, c_slot, -1, ci, ri)
        calls = {tag: (lambda v=version(libs, tag, identity), c=c_ids,
                       r=r_ids: v(c, r))
                 for tag, libs in (("old", old), ("new", new)) if libs}
        # the library call: F.embedding_bag over both tables stacked, on
        # the live ids resolved beforehand
        ids = torch.cat([torch.where(ci_rows >= 0, ci_rows + n_rows, -1),
                         ri_rows], dim=1)
        valid = ids >= 0
        lib_ids = ids[valid].long()
        lib_off = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
        res_p = timed_versions(calls, want, f"cache {name}", flush, reps, {
            "F.embedding_bag": lambda: tnf.embedding_bag(
                lib_ids, both, lib_off, mode="sum")})
        res_p["bound_ms"] = cache_bag_bound_ms(
            c_ids, r_ids, D, 4, remap=not identity)[0]
        # padding only: the resolve and the loops, no row copied
        res_p["padding_only_ms"] = time_pairs(
            {tag: (lambda v=version(libs, tag, identity): v(pad_c, pad_r))
             for tag, libs in (("old", old), ("new", new)) if libs},
            None, reps)
        from chip_smoke import profile_device
        res_p["padding_only_profiled"] = {
            tag: (profile_device(lambda v=version(libs, tag, identity):
                                 v(pad_c, pad_r), n=5) or {}).get(
                                     "top_kernels_ms")
            for tag, libs in (("old", old), ("new", new)) if libs}
        out[name] = res_p
        print(f"cache {name}: {json.dumps(res_p)}", flush=True)
    del both
    errs = []
    check_cache_adversarial(dev, errs)
    out["adversarial_calls"] = len(errs)
    return out


def probe_csr(dev, new, old, bank, slot, n_rows, off, flush, rng, reps):
    """Row 5 (``csr_bag.cu``) at the CSR path's shape (512 Poisson(256)
    bags of Zipf(1.05) ids, bag b in field b % 8, D = 32 fp32, the table of
    8 fields x 2,360,650 rows under the banked slot layout), old against
    new in turns beside ``F.embedding_bag``, with the profiler's kernel
    time; both versions on the same ranges of holes only (the resolve
    alone) and on empty bags; then ``chip_smoke.py``'s adversarial CSR
    cases on the new kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from chip_smoke import check_csr_adversarial, csr_bound_ms
    from repro_torch.kernels import embedding_bag as kb
    g = torch.Generator(device=dev).manual_seed(9)
    table = torch.randn((n_rows, D), generator=g, device=dev)
    lens = rng.poisson(L, NB_BAGS)
    T = int(lens.sum())
    field = np.repeat(np.arange(NB_BAGS) % FIELDS, lens)
    ids = zipf_ids(rng, 1.05, ROWS, (T,)) + field * ROWS
    idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(lens)])
                            .astype(np.int32)).to(dev)
    holes = torch.full_like(idx, -1)
    empty = torch.zeros_like(offs)
    res = torch.empty((NB_BAGS, D), device=dev)
    want = kb.csr_bag_plain(table, bank, slot, -1, idx, offs)

    def version(libs, tag):
        fn = entry(libs["csr_bag"], "csr_bag_forward",
                   CSR_ARGS if tag == "new" else OLD_CSR_ARGS)
        g = kb.ring_geometry(NB_BAGS, -(-T // NB_BAGS), D, 4,
                             table.data_ptr())
        geo = (g.bags_per_block, g.stages, g.vec) if tag == "new" else ()

        def call(ix=idx, of=offs):
            err = fn(table.data_ptr(), 0, bank.data_ptr(), slot.data_ptr(),
                     -1, ix.data_ptr(), of.data_ptr(), res.data_ptr(),
                     NB_BAGS, T, D, 0, torch.cuda.current_stream().cuda_stream,
                     *geo)
            if err:
                raise RuntimeError(f"csr bag launch failed: {err}")
            return res
        return call

    versions = {tag: version(libs, tag)
                for tag, libs in (("old", old), ("new", new)) if libs}
    lib_ids = slot[idx.long()].long()
    lib_off = offs[:-1].long()
    out = timed_versions(versions, want, "csr", flush, reps, {
        "F.embedding_bag": lambda: tnf.embedding_bag(lib_ids, table, lib_off,
                                                     mode="sum")})
    out.update(entries=T, bag_len_max=int(lens.max()),
               bound_ms=csr_bound_ms(idx, NB_BAGS, D, 4, slot=slot)[0])
    from chip_smoke import profile_device
    for what, kw in (("holes only", dict(ix=holes)),
                     ("empty bags", dict(of=empty))):
        out[f"{what} ms"] = time_pairs(
            {tag: (lambda v=v, kw=kw: v(**kw)) for tag, v in versions.items()},
            None, reps)
        out[f"{what} profiled"] = {
            tag: (profile_device(lambda v=v, kw=kw: v(**kw), n=5) or {}).get(
                "top_kernels_ms") for tag, v in versions.items()}
    print(f"csr: {json.dumps(out)}", flush=True)
    errs = []
    check_csr_adversarial(dev, errs)
    out["adversarial_calls"] = len(errs)
    return out


def probe_dot(dev, new, old, reps):
    """The interaction at (64, 9, 32) fp32: old and new z entries and the
    new fused entry, each within atol = rtol = 1e-5 of its plain version,
    timed in turns (no flush) beside bmm."""
    import torch
    from repro_torch.kernels import dot_interaction as kd
    g = torch.Generator(device=dev).manual_seed(5)
    B, F, Dz = 64, 9, 32
    P = F * (F - 1) // 2
    z = torch.randn((B, F, Dz), generator=g, device=dev)
    x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
    want = kd.dot_interaction_plain(z)
    want_f = kd.dot_features_plain(x, emb)
    rpb = kd.rows_per_block(B, F, Dz, 4)
    fns = {}
    for tag, libs in (("old", old), ("new", new)):
        if not libs:
            continue
        lib = libs["dot_interaction"]
        fn = entry(lib, "dot_interaction_forward",
                   DOT_ARGS if tag == "new" else OLD_DOT_ARGS)
        res = torch.empty((B, P), device=dev)
        # the old kernel staged fp32 rows of D + 1 columns
        rows = rpb if tag == "new" else max(1, min(128 // P, B))
        tail = (16,) if tag == "new" else ()

        def call(fn=fn, res=res, rows=rows, tail=tail):
            err = fn(z.data_ptr(), 0, res.data_ptr(), B, F, Dz, rows, 0,
                     torch.cuda.current_stream().cuda_stream, *tail)
            if err:
                raise RuntimeError(f"dot launch failed: {err}")
            return res
        call()
        torch.cuda.synchronize()
        if not torch.allclose(res, want, rtol=1e-5, atol=1e-5):
            raise SystemExit(f"dot {tag}: != plain")
        fns[f"{tag} dot_interaction"] = call
    got_f = kd.dot_features(x, emb)
    torch.cuda.synchronize()
    if not torch.allclose(got_f, want_f, rtol=1e-5, atol=1e-5):
        raise SystemExit("dot_features: != plain")
    fns["new dot_features"] = lambda: kd.dot_features(x, emb)
    iu, ju = torch.triu_indices(F, F, offset=1, device=dev)
    fns["bmm"] = lambda: torch.bmm(z, z.mT)[:, iu, ju]
    from chip_smoke import profile_device
    out = dict(ms=time_pairs(fns, None, max(reps, 50)),
               profiled={k: (profile_device(f, n=5) or {}).get(
                   "top_kernels_ms") for k, f in fns.items() if k != "bmm"})
    print(f"dot: {json.dumps(out)}", flush=True)
    return out


def probe_dot_wide(dev, new, old, reps):
    """The fused entry at dlrm-rm2's 27 fields, fp32: old and new at
    (262,144, 27, 64) and (10^6, 27, 64) (the old library one row a block
    at this P, ``rows_per_block``; the new one tiles of rows,
    ``dot_geometry``), each held to its plain version within 1e-5 (1 +
    the dot's sum of |products|) (two fp32 sums of 64 products in other
    orders differ by at most ~2 x 64 x 2^-24 of that sum; on these
    N(0, 1) inputs a dot near 0 can sum products of ~10, where DOT_TOL's
    atol would not hold an order that differs from the plain version's),
    timed in turns (no flush) beside ``bmm`` + triangle; at 10^6 also the
    new query entry on x = z[0, 0], the user rows z[0, 1:26] and the
    candidate rows z[:, 26]."""
    import torch
    from chip_smoke import dot_features_bound_ms, dot_query_bound_ms
    from repro_torch.kernels import dot_interaction as kd
    from repro_torch.kernels.embedding_bag import copy_width
    g = torch.Generator(device=dev).manual_seed(27)
    F, Dz = 27, 64
    P = F * (F - 1) // 2
    out = {}
    for B in (262_144, 1_000_000):
        z = torch.randn((B, F, Dz), generator=g, device=dev)
        x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
        want = kd.dot_features_plain(x, emb)
        tol = 1e-5 * (1 + kd.dot_features_plain(x.abs(), emb.abs()))
        fns = {}
        for tag, libs in (("old", old), ("new", new)):
            if not libs:
                continue
            fn = entry(libs["dot_interaction"], "dot_features_forward",
                       FEATURES_ARGS)
            rows = kd.dot_geometry(B, F, Dz, 4).rows if tag == "new" \
                else kd.rows_per_block(B, F, Dz, 4)
            res = torch.empty((B, P + Dz), device=dev)

            def call(fn=fn, res=res, rows=rows):
                err = fn(x.data_ptr(), emb.data_ptr(), 0, res.data_ptr(), B,
                         F, Dz, rows, 0,
                         torch.cuda.current_stream().cuda_stream,
                         copy_width(Dz * 4, x.data_ptr(), emb.data_ptr()))
                if err:
                    raise RuntimeError(f"dot_features launch failed: {err}")
                return res
            call()
            torch.cuda.synchronize()
            bad = (res - want).abs() > tol
            if bool(bad.any()):
                raise SystemExit(f"dot_features {tag} ({B}, 27, 64): "
                                 f"{int(bad.sum())} values off the plain "
                                 f"version, max abs err "
                                 f"{(res - want).abs().max().item()}")
            fns[f"{tag} dot_features"] = call
        del want, tol
        iu, ju = torch.triu_indices(F, F, offset=1, device=dev)
        fns["bmm + triangle"] = lambda: torch.bmm(z, z.mT)[:, iu, ju]
        row = dict(bound_ms=dot_features_bound_ms(x, emb)[0])
        if B == 1_000_000 and new:
            xq, uq = z[0, 0].contiguous(), z[0, 1:F - 1].contiguous()
            cq = z[:, F - 1].contiguous()
            got = kd.dot_features_query(xq, uq, cq)
            if not torch.allclose(got, kd.dot_features_query_plain(xq, uq, cq),
                                  rtol=1e-5, atol=1e-5):
                raise SystemExit("dot_features_query (10^6, 25, 64): != plain")
            del got
            fns["new dot_features_query"] = \
                lambda: kd.dot_features_query(xq, uq, cq)
            row["query_bound_ms"] = dot_query_bound_ms(B, F - 2, Dz, 4)[0]
        row["ms"] = time_pairs(fns, None, max(reps, 10))
        out[str(B)] = row
        print(f"dotwide ({B:,}, 27, 64): {json.dumps(row)}", flush=True)
        del z, x, emb, fns
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", type=Path, default=None,
                    help="directory with earlier versions of the chosen "
                         "kernels' .cu files to build and time beside")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "probe",
                    help="where the SASS and the JSON line go")
    ap.add_argument("--reps", type=int, default=20,
                    help="timed runs per median")
    ap.add_argument("--kernels", default=",".join(PARTS),
                    help="comma-separated parts to run, of "
                         + ", ".join(PARTS))
    args = ap.parse_args()
    parts = args.kernels.split(",")
    if not parts or any(k not in PARTS for k in parts):
        raise SystemExit(f"kernel_probe: --kernels {args.kernels}: pick of "
                         f"{', '.join(PARTS)}")
    names = tuple(dict.fromkeys(PARTS[k] for k in parts))
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
    logs = _build.build(names)
    for n, log in logs.items():
        print(f"--- {n}.cu ---\n{log}", flush=True)
    new = {n: ctypes.CDLL(str(_build.target(n))) for n in names}
    old = build_old(args.old, _build._nvcc(), _build.NVCC_FLAGS, names) \
        if args.old else {}
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    result = {"card": card, "sass": {}}
    for n in names:
        result["sass"][f"new {n}"] = sass_summary(_build.target(n), args.out,
                                                  f"new_{n}")
        if old:
            result["sass"][f"old {n}"] = sass_summary(
                args.old / f"{n}.so", args.out, f"old_{n}")
    print(json.dumps(result["sass"], indent=1), flush=True)

    from chip_smoke import check_scatter_adversarial, tiered_adversarial_cases
    if "scatter" in parts:
        print("scatter adversarial cases:", flush=True)
        check_scatter_adversarial(dev, [])
    for c in tiered_adversarial_cases(dev) if "tiered" in parts else ():
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

    if "scatter" in parts:
        # the old scatter's C entry takes run_of if its source names it
        old_run_of = bool(old) and "run_of" in (
            args.old / "ct_scatter.cu").read_text()

        def scatter_fn(lib, with_run_of=True):
            """The library's scatter entry (an old one may lack run_of)."""
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
                call = scatter_fn(libs["ct_scatter"],
                                  tag == "new" or old_run_of)
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
        # kernel's time against the run's length, and its ns an entry
        from chip_smoke import profile_device
        single = {}
        call = scatter_fn(new["ct_scatter"])
        calls = {"new": call}
        if old:
            calls["old"] = scatter_fn(old["ct_scatter"], old_run_of)
        for n_ent in (2048, 8192, 32768, 1 << 21):
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
            single[f"{n_ent} ns an entry"] = {
                tag: statistics.median(ms) * 1e6 / n_ent
                for tag, ms in single[n_ent].items()}
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

    if "tiered" in parts:
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
    if "bag" in parts:
        result["bag"] = probe_bag(dev, new, old, bank, slot, n_rows, off,
                                  flush, rng, args.reps)
    if "dot" in parts:
        result["dot"] = probe_dot(dev, new, old, args.reps)
    if "dotwide" in parts:
        result["dotwide"] = probe_dot_wide(dev, new, old, args.reps)
    if "cache" in parts:
        result["cache"] = probe_cache(dev, new, old, bank, slot, n_rows, flush,
                                      rng, args.reps)
    if "csr" in parts:
        result["csr"] = probe_csr(dev, new, old, bank, slot, n_rows, off,
                                  flush, rng, args.reps)
    line = json.dumps(result)
    (args.out / "probe.json").write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
