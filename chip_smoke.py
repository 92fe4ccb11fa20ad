#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths — the paper's CTR serving, and training, of
the full-width ``updlrm-paper`` DLRM (8 multi-hot fields of 2,360,650 rows,
dim 32, bags of 256) — and holds every kernel on them against its plain
PyTorch version on the card:

  1. device: card name and power limit (nvidia-smi), TF32 off;
  2. kernels: builds ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc each,
     in parallel); checks the banked-bag kernel bit for bit against its
     plain version at the main-path shape over an 8-bank §3.2 plan of the
     GoodReads popularity (flat remap, one owned bank, a dead bank, bf16,
     ragged bags) and, in all three instances (single copy, replica select
     at k_max 2 and 4, identity), on cases shaped against its
     shared-memory ring (``bag_adversarial_cases``: D from 1 to 160 in
     fp32 and bf16, L from 1 to 1,000, all-padding bags, NB not a multiple
     of the bags per block, an unaligned table, my = -1, 3 and 0 on a live
     map); both entries of the dot-interaction kernel (z, and the fused
     ``[dots | x]`` the model uses) to atol = rtol = 1e-5; times kernel,
     plain version and one library call with CUDA events, beside the least
     time the card could take (``bound_ms``);
  3. serve: ``launch.serve.run`` at full width with every launch counter
     set to 0 just before and read just after (the bag kernel and the
     interaction's fused entry must have run, its z entry must not: so in
     phases 4-7);
     re-scores the last batch with the plain versions; checks a reduced
     config against a CPU run on the same weights; times the serve step's
     stages;
  4. train: ``launch.train.run`` at full width for a few steps with every
     launch counter set to 0 just before and read just after (all three
     kernels must have run); holds the sorted-run scatter kernel (the bag
     sums' backward) bit for bit against its plain version at the train
     path's shape, on the phase-2 cases and on run layouts that its tiles
     and span blocks split (one run of every entry; runs around 32, 64
     and 1,024 entries; a long run in the last live slot; 40 long runs
     back to back; no live run) at D = 1 to 160 and in both dtype mixes,
     and its prep on the card against the prep on the CPU; times it on the
     train ids and on Zipf ids beside its bound and one ``index_add_``;
     checks that the losses are finite, that a batch
     repeated lowers its loss, that one step's table gradient equals the
     plain scatter of the same cotangent, and that the table and the bottom
     MLP get gradients; times the train step's stages; checks a reduced
     config's losses on the card against the CPU on the same weights;
  5. cache-aware serve (§3.3, Fig. 7): ``launch.serve.run_cached`` at full
     width (64 profiling requests mined into GRACE groups, the cache-aware
     plan, the capped partial-sum table; 256 served requests rewritten on
     the host) with every launch counter set to 0 just before and read just
     after (the fused kernel and the interaction must have run, the plain
     bag kernel must not); holds the fused cache+residual kernel bit for
     bit against its plain version (the served ids, with holes, my = 3, a
     dead bank, bf16, ragged bags) and, in both instances, on cases shaped
     against its ``cp.async`` ring (``cache_adversarial_cases``: D from 1
     to 160 in fp32 and bf16, live lists of 0 to 584 rows across a
     512-entry round, one stream live or of no columns, padding only,
     unaligned tables, my = -1, 3 and 0 on a live map); checks both
     tables' gradients and the
     scatter's two dtype mixes against the plain scatter bit for bit; the
     cached scores against the plain path on the deduplicated bags; a
     reduced config on the card against the CPU; times the kernel beside
     its bound and one ``F.embedding_bag``, the cached serve step, and the
     host's share (``next_batch``, the rewrite, the serve call); then the
     identity-layout drop-in ``kernels.ops.cache_bag`` (kernel 8) on the
     served streams resolved through their remaps, with its launch counter
     set to 0 just before and read just after: equal bit for bit to the
     fused kernel on the raw streams and to its plain version (and on
     small bf16 / ragged cases), timed beside its bound and two
     ``F.embedding_bag`` calls summed;
  6. adaptive serve with tiered-precision tables: ``launch.serve.run_adaptive``
     at full width with ``quant='int4'`` (192 drifting-Zipf requests at batch
     64, a drift check every 2 batches: telemetry -> replan -> live
     migration -> re-tier -> swap) with every launch counter set to 0 just
     before and read just after (the tiered kernel and the interaction must
     have run, the other bag kernels must not); at least one swap, shapes
     stable, the first re-tier equal to a fresh build; holds the tiered
     kernel bit for bit against its plain version (the served ids under the
     live tier map, with holes, my = 3, a dead bank; int8-only, fp32-hot,
     D = 160 and ragged D = 33 tables; tables shaped against its chunking:
     tiers mixed in every chunk, L = 300, L x D past its staging buffer,
     int4-only D = 33, fp32-hot D = 160, D = 300); the traffic counters against their
     host twins; the last batch against the plain lookup; a reduced config's
     adaptive run on the card against the CPU swap for swap; times the
     kernel beside its bound, its plain version and a reference point
     (``F.embedding_bag`` over rows dequantized beforehand), the tiered
     serve step, and the host's share (``next_batch`` with its telemetry
     tap, the serve call, the swaps);
  7. adaptive serve with the hot-row replica lane:
     ``launch.serve.run_replicated`` at full width with ``k_max = 4`` (192
     drifting-Zipf(2.0) requests at batch 64, a drift check every 2
     batches: telemetry -> replan -> replica plan -> live migration ->
     replicated side table -> swap) with every launch counter set to 0 just
     before and read just after (the bag kernel's replica select and the
     interaction must have run; the single-copy bag kernel, the other bag
     kernels and the scatter must not); at least one swap, shapes stable,
     the first swap's table and scores equal to a fresh
     ``pack_replicated``; holds the replica select bit for bit against its
     plain version (the served ids through the all-live failover maps and
     the raw flat maps, with holes, my = 3, a dead bank; small tables with
     k_max 2, 3 and 4, bf16 and ragged D); the replicated gradient (the
     scatter on the k_max = 4 prep, and a ones cotangent's copy sums against
     the single-copy gradient); the traffic counters against their host
     twin; the last batch against the single-copy path on the base table; a
     reduced config's replicated run on the card against the CPU swap for
     swap; times the kernel beside its bound, its plain version and
     ``F.embedding_bag`` on ids resolved beforehand, the replicated serve
     step by stage, and the host's share (``next_batch``, the serve call,
     each swap's base replan, replica plan and migrations);
  8. ragged CSR lookups and the identity drop-ins: the full-width
     super-table packed with phase 2's plan (seeded weights), 64 requests x
     8 fields of untruncated Poisson(256) Zipf(1.05) bags (~131 k entries);
     ``core.embedding.csr_embedding_bag`` forward and backward, then
     ``kernels.ops.embedding_bag_trainable`` forward and backward on the
     same bags padded and resolved, then ``kernels.ops.dot_interaction``
     on each request's 8 sums behind a dense row, each with every launch
     counter set to 0 just before and read just after (the CSR kernel and
     the scatter, then the identity bag kernel, the scatter and the
     interaction's z entry, must have run; no other);
     holds the CSR kernel bit for bit against its plain version (the
     served stream, with holes and my = 3, a dead bank, small bf16 tables
     at D = 33 and 160 with empty bags, and ``csr_adversarial_cases``: D
     from 1 to 160 in fp32 and bf16, bags of 0 to 5,000 entries, trailing
     empty bags, offsets outside [0, T], T = 0, an unaligned table, my =
     -1, 3 and 0 on a live map), the CSR sums against
     ``banked_bag`` on the padded bags and the identity kernel on the
     resolved ids, the CSR gradient against the plain scatter and (within
     1e-5 of the summed magnitudes) the rectangular path's, the identity
     gradient against its plain version, the scatter on the CSR prep
     against its plain version (holes with my = 3, a dead bank, both dtype
     mixes, the small tables); times the CSR kernel, the
     identity kernel and the CSR scatter beside their bounds, plain
     versions and one library call each (``F.embedding_bag``,
     ``index_add_``), and the CSR lookup's forward + backward;
  9. the adaptive loop's cache lane: ``launch.serve.run_cached_adaptive``
     at full width (256 drifting-Zipf(1.2) requests at batch 64, a drift
     check every 2 batches: telemetry -> cache-aware replan -> live
     migration -> cache install -> swap, every batch rewritten on the host
     and version-tagged) with every launch counter set to 0 just before and
     read just after (the fused kernel and the interaction's fused entry
     must have run; the plain bag kernel, the scatter, the tiered kernel
     and the z entry must not); at least one swap, with the first swap's
     EMT, cache table and output equal to a fresh build (checked on the
     card); holds the fused kernel bit for bit against its plain version on
     the post-swap EMT for the batch in flight across the last swap (the
     retired version's cache table) and for the same bags rewritten under
     the new version; the last batch's reads against their host twin and
     its scores against the plain versions; a reduced config's lane on the
     card against the CPU swap for swap; times the lane's serve step, the
     fused kernel at its shape and the interaction on its inputs, and the
     host's share (the tap, the rewrite, the serve call, each swap's
     replan, migration and cache install);
 10. adaptive training at full width, ``launch.train.run_adaptive`` for 5
     steps at batch 64 with a drift check after step 2, on the cache-aware
     path (a refresh after step 3, of the plan mined at the migration) and
     on the §3.2 path, each with every launch counter set to 0 just before
     and read just after (the fused kernel, or the bag kernel, the
     interaction's fused entry, and exactly one scatter a step); every
     migration's Adagrad state equal to ``migrate_rowwise_state`` of the
     state before it and every refreshed cache table, of a non-empty
     plan, equal to a fresh build from the current rows, bit for bit; the
     cached step's EMT gradient against the plain scatter of the same
     cotangent and the fused kernel against its plain version, on the last
     batch and on the migration step's batch replayed under the live plan
     (which must hit the cache: the run's uniform ids rarely repeat a
     mined pair); the kernels timed at the phase's shapes; a reduced
     config's adaptive training, both paths, on the card against the CPU
     (the same migrations, plans, refreshes, rewritten ids and reads;
     losses within rtol 1e-4);
 11. the fault lane: ``launch.serve.run_fault`` at full width (768
     drifting-Zipf(1.05) requests at batch 64; bank 3 dead at batch 2,
     bank 5 8x slow from batch 8; the SLO watchdog's p99 check at 100 us
     on windows of 8) with every launch counter set to 0 just before and
     read just after (the bag kernel under the binary live map and the
     interaction's fused entry must have run, no other kernel); the run
     itself raises unless a recovery happened, the degraded batch's clean
     requests and the first clean batch after the recovery equal the
     never-failed run bit for bit, every swap kept version 0's shapes and
     an SLO breach reached the replanner; then served plus degraded reads
     equal the valid lookups on every batch, the degraded counts equal a
     host recount from the plan, confinement per bag (clean bags equal the
     never-failed sums; every bag equals the plain version on the ids with
     the dead reads set to -1, and with those ids every bag equals the
     never-failed sums), the bag kernel under the live map against its
     plain version, a straggler replan, and a reduced config's fault lane
     on the card against the CPU event for event (a revival included);
     times the degraded serve step against the plain adaptive step, the
     live map alone (``fault_breakdown``), and prints the recovery ms, the
     straggler events, the SLO breaches and the degraded reads.

Each phase prints its seconds, and the run its total. Prints the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
{...}}``. Any failed check exits non-zero with no result line. Without
CUDA, or without the repo's ``src/`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build"           # git-ignored; chip_smoke.json goes here

# H100 SXM published peaks: HBM3 bytes/s and fp32 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BAG_TILE = 1             # non_uniform_partition group size: the exact greedy
DOT_TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4         # trajectories: the CPU tests' tolerance
TRAIN_STEPS, TRAIN_BATCH = 6, 64
CACHED_REQUESTS, CACHED_PROFILE = 256, 64
# phases 6 and 7: three batches, so one swap each (after batch 1) and the
# run stays within half its time limit with phase 11 added
ADAPTIVE_REQUESTS, ADAPTIVE_REPLAN = 192, 2
REPLICATED_REQUESTS, REPLICATED_REPLAN, K_MAX = 192, 2, 4
CSR_REQUESTS = 64        # phase 8: requests of 8 ragged bags each
CACHED_ADAPTIVE_REQUESTS, CACHED_ADAPTIVE_REPLAN = 256, 2     # phase 9
# phase 10: a drift check after step 2 (a migration), a refresh after step
# 3 on the cache-aware path, so the refresh re-sums a mined plan
ADAPTIVE_TRAIN_STEPS, ADAPTIVE_TRAIN_REPLAN, ADAPTIVE_TRAIN_REFRESH = 5, 3, 4
# phase 11: 12 batches of 64; bank 3 dies at batch 2 (one dead bank fits the
# 0.25 capacity slack; a second would not), bank 5 runs 8x slow from batch
# 8 (7 clean batches of straggler history by then); drift checks every 16
# batches, so only the SLO breach's early check can interleave one; a p99
# budget of 100 us, which every full-width device step exceeds
FAULT_REQUESTS, FAULT_REPLAN = 768, 16
FAULT_SCHEDULE = ("2:3", "8:5:degraded:8.0")
FAULT_SLO = dict(p99_us=100.0, window=8)
# its reduced run, card against CPU: the same with a revival at batch 10 and
# the count-driven max_share check in place of the wall-clock p99
FAULT_REDUCED_SCHEDULE = ("2:3", "8:5:degraded:8.0", "10:3:healthy")
EMB_TOL = dict(rtol=0, atol=1e-5)   # cached vs plain bag sums: fp32 reordering


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def need(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, *, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after ``warmup`` runs. ``flush()`` runs before each timed run, outside
    the events (and before each warm-up run). A ~1 ms device-side sleep is
    queued ahead of each start event, so the host has enqueued all of
    ``fn``'s work before the device reaches it: the events then time the
    device, not the Python that launches it."""
    import torch
    for _ in range(warmup):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_device(fn, n: int = 3):
    """Device time of ``n`` back-to-back runs of ``fn`` from a
    ``torch.profiler`` trace: the busy time (union of the kernels' and
    copies' intervals) and the window from the first device event's start
    to the last one's end, per run, and the device time by kernel name.
    None when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(busy_ms=busy / 1e3 / n,
                window_ms=(end - spans[0][0]) / 1e3 / n,
                top_kernels_ms=[[k[:80], v] for k, v in top])


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0 and r.stdout.strip(),
         f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bag_bound_ms(idx, off, n_fields, dim, itemsize, *, k_max=1, my=-1,
                 slot=None, remap=True):
    """Least time for one bag call on these ids: each id read once, each
    distinct remap entry read once (``row``, or with ``k_max > 1`` ``row *
    k_max + wang_hash(bag) % k_max``: its 4-byte slot, and its 4-byte bank
    when ``my >= 0``), each distinct table row read once (its D values;
    with ``slot`` given, the distinct ``slot[entry]``, since columns of a
    single-copy row share one), the output written once; or the fp32 adds,
    if more. Remap reads are counted at 4 bytes, not at the 32-byte sector
    a random read costs. ``remap=False``: identity ids (the rows
    themselves), no offsets and no remap bytes."""
    import torch
    from repro_torch.kernels.embedding_bag import replica_of_bag
    NB, L = idx.shape
    n = torch.arange(NB, device=idx.device)
    valid = idx >= 0
    rows = idx.long() + off.long()[n % n_fields][:, None]
    if k_max > 1:
        rows = rows * k_max + replica_of_bag(n, k_max).long()[:, None]
    entries = torch.unique(rows[valid])
    n_table = entries.numel() if slot is None \
        else torch.unique(slot[entries]).numel()
    nbytes = (NB * L * 4 + n_table * dim * itemsize + NB * dim * itemsize
              + remap * (off.numel() * 4
                         + entries.numel() * (4 + 4 * (my >= 0))))
    return least_ms(nbytes, int(valid.sum()) * dim)


def least_ms(nbytes, n_adds):
    """(ms, what bounds it): the larger of ``nbytes`` over the card's
    memory rate and ``n_adds`` fp32 operations over its fp32 rate."""
    t_bytes, t_ops = nbytes / HBM_BPS, n_adds / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def csr_bound_ms(indices, n_bags, dim, itemsize, *, my=-1, slot=None):
    """Least time for one CSR bag call on this stream: each id read once,
    the n_bags + 1 offsets, each distinct remap entry once (its 4-byte
    slot, and its 4-byte bank when ``my >= 0``), each distinct table row
    once (the distinct ``slot[raw]`` when ``slot`` is given), the output
    written once; or the fp32 adds, if more."""
    import torch
    valid = indices >= 0
    entries = torch.unique(indices[valid])
    n_table = entries.numel() if slot is None \
        else torch.unique(slot[entries.long()]).numel()
    nbytes = (indices.numel() * 4 + (n_bags + 1) * 4
              + entries.numel() * (4 + 4 * (my >= 0))
              + n_table * dim * itemsize + n_bags * dim * itemsize)
    return least_ms(nbytes, int(valid.sum()) * dim)


def dot_bound_ms(z):
    B, F, D = z.shape
    P = F * (F - 1) // 2
    nbytes = (B * F * D + B * P) * z.element_size()
    return least_ms(nbytes, 2 * B * P * D)


def holey(idx, rng, p_hole=0.05):
    """Interior -1 holes, short bags and one all-pad bag in a (B, F, L)
    id array."""
    import numpy as np
    idx = idx.copy()
    idx[rng.random(idx.shape) < p_hole] = -1
    B, F, L = idx.shape
    short = rng.random((B, F)) < 0.25
    lens = rng.integers(0, L + 1, (B, F))
    idx[short[..., None] & (np.arange(L)[None, None, :] >= lens[..., None])] = -1
    idx[0, 1] = -1
    return idx


def to_dev(tree, dev):
    """A params / statics / batch tree with its tensors moved to ``dev``."""
    import torch
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dev(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def small_cases(dev, cases=(("bfloat16", 64, 100, 40, 4),
                            ("float32", 160, 24, 20, 3),
                            ("float32", 40, 37, 33, 5))):
    """Small kernel cases beside the main-path shape: bf16 at D=64 (two
    columns a lane), fp32 at D=160 (two passes), ragged NB with all-pad bags
    at D=40 and L=33. Each over a 4-bank §3.2 plan with the flat remap."""
    import numpy as np
    import torch
    from repro_torch.core.partitioning import non_uniform_partition
    srng = np.random.default_rng(3)
    out = []
    for dtype, D, NB, Ls, nfield in cases:
        per_field = 20_000
        sv = per_field * nfield
        splan = non_uniform_partition(srng.random(sv) + 0.01, 4)
        stab = torch.randn((4 * splan.max_rows_per_bank, D), device=dev
                           ).to(getattr(torch, dtype))
        sbank = torch.from_numpy(splan.bank_of_row).to(dev)
        sslot = torch.from_numpy(
            (splan.bank_of_row.astype(np.int64) * splan.max_rows_per_bank
             + splan.slot_of_row).astype(np.int32)).to(dev)
        soff = torch.arange(nfield, dtype=torch.int32, device=dev) * per_field
        sids = srng.integers(0, per_field, (NB, Ls)).astype(np.int32)
        sids[srng.random(sids.shape) < 0.1] = -1
        sids[::7] = -1                                   # all-pad bags
        out.append(dict(name=f"{dtype} D={D} NB={NB} L={Ls}", table=stab,
                        bank=sbank, slot=sslot, off=soff,
                        idx=torch.from_numpy(sids).to(dev)))
    return out


BAG_DIMS = (1, 8, 9, 31, 32, 33, 64, 100, 128, 129, 160)
BAG_LENS = (1, 31, 32, 33, 256, 1000)


def bag_adversarial_cases(dev):
    """Tables and id streams against the bag kernel's resolve-once ring:
    every D of ``BAG_DIMS`` in fp32 and bf16 (16-, 4- and 2-byte copies;
    one, two and three column passes), each with two bag lengths of
    ``BAG_LENS`` (one entry, around a 32-row stage, a whole 256-entry bag,
    1,000 entries past the 8 stages), and every length at D = 32 and 33;
    NB from 37 to 41, so bags per block never divide it; holes and
    all-padding bags in every stream; then 4,301 bags (two bags a block,
    odd NB), a table whose base is 4 bytes off 16-byte alignment, and a
    stream of padding only. Each case carries a table of 4 x 2,400 rows,
    ids of 3 fields of 800 rows and identity ids into the table."""
    import numpy as np
    import torch
    rng = np.random.default_rng(17)
    V, F = 2400, 3
    shapes = []
    for dtype in ("float32", "bfloat16"):
        for i, D in enumerate(BAG_DIMS):
            for L in (BAG_LENS[i % 6], BAG_LENS[(i + 3) % 6]):
                shapes.append((dtype, D, L, 37 + len(shapes) % 5, ""))
        for L in BAG_LENS:
            for D in (32, 33):
                shapes.append((dtype, D, L, 41, ""))
    shapes += [("float32", 32, 33, 4301, ""),
               ("float32", 32, 256, 40, "base 4 B off alignment"),
               ("bfloat16", 64, 32, 16, "padding only")]
    out = []
    for dtype, D, L, NB, note in shapes:
        R = 4 * V
        tab = torch.from_numpy(rng.standard_normal((R * D + 1,))
                               .astype(np.float32)).to(dev)
        tab = tab.to(getattr(torch, dtype))
        # a view 4 bytes (fp32) or 2 bytes (bf16) past the allocation's base
        table = tab[1:].view(R, D) if note.startswith("base") \
            else tab[:R * D].view(R, D)
        ids = rng.integers(0, V // F, (NB, L)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.1] = -1               # holes
        ids[::5] = -1                                       # all-pad bags
        if note == "padding only":
            ids[:] = -1
        rows = np.where(ids >= 0, rng.integers(0, R, ids.shape), -1)
        out.append(dict(
            name=f"{dtype} D={D} L={L} NB={NB}" + (f" ({note})" if note
                                                   else ""),
            table=table, idx=torch.from_numpy(ids).to(dev),
            rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
            off=torch.arange(F, dtype=torch.int32, device=dev) * (V // F),
            remaps={k: (torch.from_numpy(rng.integers(0, 8, V * k)
                                         .astype(np.int32)).to(dev),
                        torch.from_numpy(rng.integers(0, R, V * k)
                                         .astype(np.int32)).to(dev))
                    for k in (1, 2, 4)}))
    return out


def check_bag_adversarial(dev, errs):
    """The three instances of the bag kernel (kRemap with k_max = 1,
    kReplica with k_max = 2 and 4, kIdentity) against their plain versions,
    bit for bit, on ``bag_adversarial_cases``: my = -1, my = 3 on an 8-bank
    map, and my = 0 on a live map (bank 5 dead)."""
    import torch
    from repro_torch.kernels.embedding_bag import (banked_bag,
                                                   banked_bag_plain,
                                                   plain_bag, plain_bag_plain)
    n = 0
    for c in bag_adversarial_cases(dev):
        for k, (bank, slot) in c["remaps"].items():
            live = (bank != 5).to(torch.int32) ^ 1    # 0 where live
            for my, bk in ((-1, bank), (3, bank), (0, live)):
                a = (c["table"], bk, slot, c["off"], my, c["idx"], k)
                got, want = banked_bag(*a), banked_bag_plain(*a)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item() \
                    if got.numel() else 0.0
                need(got.dtype == want.dtype and torch.equal(got, want),
                     f"banked_bag {c['name']} k_max={k} my={my}: kernel != "
                     f"plain (max abs err {err})")
                errs.append(err)
                n += 1
        got = plain_bag(c["table"], c["rows"])
        want = plain_bag_plain(c["table"], c["rows"])
        torch.cuda.synchronize()
        need(got.dtype == want.dtype and torch.equal(got, want),
             f"plain_bag {c['name']}: kernel != plain")
        n += 1
    print(f"  banked_bag adversarial cases: {n} calls (kRemap, kReplica "
          f"k_max 2 and 4, kIdentity; D {BAG_DIMS}, L {BAG_LENS}) == plain")


def check_bag_kernel(dev, cfg, plan, pop, params, statics, rng, report):
    """Kernel vs plain, bit for bit, at the main-path shape and on small
    bf16 / ragged cases; then the timings at the main-path shape."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.embedding_bag import banked_bag, banked_bag_plain
    from repro_torch.models import dlrm

    t = dlrm._banked(params, statics)
    off = statics["field_offsets"]
    flat_remap = t.flat_remap()
    F, L, B = cfg.n_sparse, cfg.multi_hot, 64
    # the serve path's own ids (uniform, full bags) and Zipf ids with holes
    main_ids = syn.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, B, seed=1,
                              step=0, multi_hot=L)["sparse"]
    zipf_ids = holey(rng.choice(cfg.vocab_sizes[0], size=(B, F, L), p=pop)
                     .astype(np.int32), rng)
    idx_main = torch.from_numpy(main_ids.reshape(-1, L)).to(dev)
    idx_zipf = torch.from_numpy(zipf_ids.reshape(-1, L)).to(dev)
    dead = torch.ones(plan.n_banks, dtype=torch.bool, device=dev)
    dead[5] = False
    live_map = torch.where(dead[t.remap_bank.long()], 0, 1).to(torch.int32)

    errs = []

    def same(name, table, bank, slot, offs, my, idx):
        got = banked_bag(table, bank, slot, offs, my, idx)
        want = banked_bag_plain(table, bank, slot, offs, my, idx)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"banked_bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        need(torch.equal(got, want),
             f"banked_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"banked_bag {name}: non-finite")
        errs.append(err)
        print(f"  banked_bag {name}: {tuple(got.shape)} {got.dtype} "
              f"== plain (max abs err {err})")

    print(f"banked_bag vs plain, bit for bit (table {tuple(t.packed.shape)} "
          f"{t.packed.dtype}):")
    same("main ids, my=-1 flat remap", t.packed, t.remap_bank, flat_remap,
         off, -1, idx_main)
    same("zipf ids+holes, my=-1", t.packed, t.remap_bank, flat_remap, off,
         -1, idx_zipf)
    same("zipf ids+holes, my=3 bank map", t.packed, t.remap_bank, flat_remap,
         off, 3, idx_zipf)
    same("zipf ids+holes, bank 5 dead (binary live map, my=0)", t.packed,
         live_map, flat_remap, off, 0, idx_zipf)

    for c in small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["table"], c["bank"], c["slot"],
                 c["off"], my, c["idx"])
    check_bag_adversarial(dev, errs)

    # timings at the main-path shape, on the serve path's ids, L2 flushed
    # before every run: a real batch finds its rows cold
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (t.packed, t.remap_bank, flat_remap, off, -1, idx_main)
    bag = torch.arange(idx_main.shape[0], device=dev) % F
    rows = idx_main.long() + off.long()[bag][:, None]
    valid = idx_main >= 0
    lib_ids = flat_remap[rows[valid]].long()
    lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
    lib = lambda: tnf.embedding_bag(lib_ids, t.packed, lib_offsets,  # noqa: E731
                                    mode="sum")
    need(torch.allclose(lib(), banked_bag(*args), rtol=1e-5, atol=1e-5),
         "embedding_bag library call disagrees with the kernel")
    ms = time_ms(lambda: banked_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: banked_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    bound_ms, bound_by = bag_bound_ms(idx_main, off, F, t.dim,
                                      t.packed.element_size())
    print(f"banked_bag at NB={idx_main.shape[0]} L={L} D={t.dim} fp32: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})")
    report["banked_bag"] = dict(
        name="banked_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/banked_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:231",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)


def bf16_rounds(got, dot32):
    """Whether each bf16 value of ``got`` is a rounding of the fp32 dot
    ``dot32`` as a kernel that sums in another order may give it: within
    half a bf16 step of ``dot32`` (the step 2^(e - 8) for |dot32| in
    [2^(e-1), 2^e)) plus the fp32 sums' own spread (DOT_TOL)."""
    import torch
    _, e = torch.frexp(dot32)
    half_step = torch.ldexp(torch.ones_like(dot32), e - 9)
    tol = half_step + DOT_TOL["rtol"] * dot32.abs() + DOT_TOL["atol"]
    return bool(((got.float() - dot32).abs() <= tol).all())


def dot_features_bound_ms(x, emb):
    B, D = x.shape
    F = emb.shape[1] + 1
    P = F * (F - 1) // 2
    nbytes = (B * F * D + B * (P + D)) * x.element_size()
    return least_ms(nbytes, 2 * B * P * D)


def check_dot_kernel(dev, report):
    """Both entries of the interaction kernel against their plain versions
    (atol = rtol = 1e-5 in fp32; in bf16 each dot a rounding of the plain
    version's fp32 dot, ``bf16_rounds``) at every path's
    shape (64, 9, 32) and on wider, narrower and odd shapes; the fused
    entry's x columns bit for bit; then both timed at (64, 9, 32) fp32
    beside their bounds, the plain versions, ``bmm`` and the unfused
    sequence the model ran before (cat, the z entry, cat)."""
    import torch
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_features_plain,
                                                     dot_interaction,
                                                     dot_interaction_plain)
    g = torch.Generator(device=dev).manual_seed(5)
    errs, f_errs = [], []
    print("dot_interaction and dot_features vs plain (atol = rtol = 1e-5 in "
          "fp32):")
    for shape, dtype in (((64, 9, 32), torch.float32),
                         ((8, 27, 64), torch.float32),
                         ((5, 2, 16), torch.float32),
                         ((3, 40, 300), torch.float32),
                         ((7, 5, 33), torch.float32),
                         ((6, 4, 9), torch.bfloat16),
                         ((64, 9, 32), torch.bfloat16)):
        z = torch.randn(shape, generator=g, device=dev).to(dtype)
        x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
        P = shape[1] * (shape[1] - 1) // 2
        # bf16 output: the kernel and the plain version each round one fp32
        # dot once, summed in other orders; both held to the fp32 dot
        dot32 = dot_interaction_plain(z.float())
        for name, got, want in (
                ("dot_interaction", dot_interaction(z),
                 dot_interaction_plain(z)),
                ("dot_features", dot_features(x, emb),
                 dot_features_plain(x, emb))):
            torch.cuda.synchronize()
            need(got.shape == want.shape and got.dtype == want.dtype,
                 f"{name} {shape}: shape/dtype")
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                need(torch.allclose(got, want, **DOT_TOL),
                     f"{name} {shape} {dtype}: max abs err {err}")
            else:
                need(bf16_rounds(got[:, :P], dot32)
                     and bf16_rounds(want[:, :P], dot32),
                     f"{name} {shape} {dtype}: not a rounding of the fp32 "
                     f"dot (max abs err to the plain version {err})")
            if name == "dot_features":
                need(torch.equal(got[:, P:], x),
                     f"dot_features {shape}: x columns != x")
            if dtype == torch.float32:
                (errs if name == "dot_interaction" else f_errs).append(err)
            print(f"  {name} {shape} {str(dtype)[6:]}: max abs err {err}")

    z = torch.randn((64, 9, 32), generator=g, device=dev)
    x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
    iu, ju = torch.triu_indices(9, 9, offset=1, device=dev)
    lib = lambda: torch.bmm(z, z.mT)[:, iu, ju]  # noqa: E731
    need(torch.allclose(lib(), dot_interaction(z), **DOT_TOL),
         "bmm library call disagrees with the kernel")

    def unfused():
        zz = torch.cat([x[:, None], emb], dim=1)
        return torch.cat([dot_interaction(zz), x], dim=-1)
    need(torch.allclose(unfused(), dot_features(x, emb), **DOT_TOL),
         "the unfused sequence disagrees with the fused entry")
    ms = time_ms(lambda: dot_interaction(z), reps=50)
    plain_ms = time_ms(lambda: dot_interaction_plain(z), reps=50)
    library_ms = time_ms(lib, reps=50)
    f_ms = time_ms(lambda: dot_features(x, emb), reps=50)
    f_plain_ms = time_ms(lambda: dot_features_plain(x, emb), reps=50)
    unfused_ms = time_ms(unfused, reps=50)
    bound_ms, bound_by = dot_bound_ms(z)
    f_bound_ms, f_bound_by = dot_features_bound_ms(x, emb)
    print(f"dot_interaction at (64, 9, 32) fp32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bmm {library_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}; launch-bound)")
    print(f"dot_features at x (64, 32), emb (64, 8, 32) fp32: kernel "
          f"{f_ms:.4f} ms, plain {f_plain_ms:.4f} ms, unfused (cat, "
          f"dot_interaction, cat) {unfused_ms:.4f} ms, bound "
          f"{f_bound_ms:.6f} ms ({f_bound_by}; launch-bound)")
    report["dot_interaction"] = dict(
        name="dot_interaction", route="cuda",
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:22",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    report["dot_features"] = dict(
        name="dot_features", route="cuda",
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:22",
        max_abs_err=max(f_errs), ms=f_ms, plain_ms=f_plain_ms,
        bound_ms=f_bound_ms, bound_by=f_bound_by, library_ms=None,
        unfused_ms=unfused_ms)


def serve_main_path(dev, spec, plan):
    """The main path with the launch counters read around it."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run
    kbag.banked_bag.launches = 0
    kdot.dot_features.launches = 0
    kdot.dot_interaction.launches = 0
    res = run(spec, spec.config, requests=256, batch=64, device=dev,
              plan=plan)
    launches = {"banked_bag": kbag.banked_bag.launches,
                "dot_features": kdot.dot_features.launches,
                "dot_interaction": kdot.dot_interaction.launches}
    print(f"serve: {len(res.latencies)} requests at batch 64, launches "
          f"{launches}")
    for name in ("banked_bag", "dot_features"):
        need(launches[name] > 0, f"the serve run launched no {name} kernel")
    need(launches["dot_interaction"] == 0,
         "the serve run launched the unfused dot_interaction entry")
    return res, launches


def check_serve_outputs(dev, spec, res):
    import torch
    from repro_torch.core.embedding import banked_embedding_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve

    cfg = spec.config
    need(tuple(res.scores.shape) == (256,), f"scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "scores outside (0, 1)")
    t = dlrm._banked(res.params, res.statics)
    sparse = res.last_batch["sparse"]
    with torch.inference_mode():
        emb_k = banked_embedding_bag(t, sparse, backend="cuda",
                                     field_offsets=res.statics["field_offsets"])
        emb_p = banked_embedding_bag(t, sparse, backend="torch",
                                     field_offsets=res.statics["field_offsets"])
    need(torch.equal(emb_k, emb_p), "served embeddings: kernel != plain")
    plain = build_recsys_serve(dlrm, cfg, res.statics, backend="torch")(
        res.params, res.last_batch)
    err = (plain - res.scores[-64:]).abs().max().item()
    need(torch.allclose(res.scores[-64:], plain, **SCORE_TOL),
         f"served scores vs plain re-score: max abs err {err}")
    print(f"serve outputs: finite, in (0, 1); last batch embeddings equal "
          f"plain, scores within rtol 1e-5/atol 1e-6 (max abs err {err})")

    # a reduced config on the same weights: the card against the CPU
    red = spec.reduced
    params, statics = dlrm.init_params(red, torch.Generator().manual_seed(3),
                                       device="cpu")
    from repro_torch.data import synthetic as syn
    b = syn.dlrm_batch(red.vocab_sizes, red.n_dense, 16, seed=2, step=0,
                       multi_hot=red.multi_hot)
    b.pop("label")
    cpu_batch = {k: torch.from_numpy(v) for k, v in b.items()}

    want = build_recsys_serve(dlrm, red, statics)(params, cpu_batch)
    got = build_recsys_serve(dlrm, red, to_dev(statics, dev))(
        to_dev(params, dev), to_dev(cpu_batch, dev))
    err = (got.cpu() - want).abs().max().item()
    need(torch.allclose(got.cpu(), want, **SCORE_TOL),
         f"reduced config, card vs CPU: max abs err {err}")
    print(f"reduced config on the card vs the CPU, same weights: max abs "
          f"err {err}")


def serve_breakdown(dev, spec, res):
    """Device time of one full-width serve step and of its stages, L2
    flushed before each run."""
    import torch
    from repro_torch.core.embedding import banked_embedding_bag
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_interaction)
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    cfg = spec.config
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    t = dlrm._banked(res.params, res.statics)
    batch = res.last_batch
    serve = build_recsys_serve(dlrm, cfg, res.statics)
    fo = res.statics["field_offsets"]
    with torch.inference_mode():
        x = dlrm.mlp_apply(res.params["bot"], batch["dense"])
        emb = banked_embedding_bag(t, batch["sparse"],
                                   field_offsets=fo).contiguous()
        z = torch.cat([x[:, None], emb], dim=1)
        feat = dot_features(x, emb)
        parts = {
            "serve_step": lambda: serve(res.params, batch),
            "flat_remap": t.flat_remap,
            "embedding_bag": lambda: banked_embedding_bag(
                t, batch["sparse"], field_offsets=fo),
            "bottom_mlp": lambda: dlrm.mlp_apply(res.params["bot"],
                                                 batch["dense"]),
            "dot_features": lambda: dot_features(x, emb),
            "dot_interaction": lambda: dot_interaction(z),
            "top_mlp": lambda: dlrm.mlp_apply(res.params["top"], feat),
        }
        out = {k: time_ms(fn, flush=scratch.zero_) for k, fn in parts.items()}
        prof = profile_device(lambda: serve(res.params, batch), n=5)
    print("serve step breakdown (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per serve call: device busy {prof['busy_ms']:.4f}"
              f" ms of a {prof['window_ms']:.4f} ms window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof

    # host side of one batch, as run() does it: 64 requests made, stacked
    # on the card, scored (host clock, each stage ending in a synchronize)
    from repro_torch.launch.serve import _one
    from repro_torch.serve.serve_step import MicroBatcher, Request
    pad = {k: v[0] for k, v in _one(cfg, 0).items()}
    host = {"make_requests": [], "next_batch": [], "serve_call": []}
    for rep in range(5):
        t0 = time.perf_counter()
        reqs = [Request(rid, {k: v[0] for k, v in
                              _one(cfg, 1000 + 64 * rep + rid).items()})
                for rid in range(64)]
        t1 = time.perf_counter()
        mb = MicroBatcher(64, pad, device=dev)
        for r in reqs:
            mb.submit(r)
        _, feats = mb.next_batch()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        serve(res.params, feats)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
            host[k].append(v * 1e3)
    host = {f"{k}_host_ms": statistics.median(v) for k, v in host.items()}
    print("one batch of 64 on the host (median of 5, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    return {**out, **host}


def train_main_path(dev, spec, plan):
    """The train path with the launch counters read around it."""
    import math
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.train import run
    kbag.banked_bag.launches = 0
    kbag.ct_scatter_bag.launches = 0
    kdot.dot_features.launches = 0
    kdot.dot_interaction.launches = 0
    res = run(spec, spec.config, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
              device=dev, plan=plan)
    launches = {"banked_bag": kbag.banked_bag.launches,
                "ct_scatter_bag": kbag.ct_scatter_bag.launches,
                "dot_features": kdot.dot_features.launches,
                "dot_interaction": kdot.dot_interaction.launches}
    print(f"train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, launches "
          f"{launches}")
    for name in ("banked_bag", "ct_scatter_bag", "dot_features"):
        need(launches[name] > 0, f"the train run launched no {name} kernel")
    need(launches["dot_interaction"] == 0,
         "the train run launched the unfused dot_interaction entry")
    need(len(res.losses) == TRAIN_STEPS
         and all(math.isfinite(x) for x in res.losses),
         f"train losses {res.losses}")
    print("  losses " + ", ".join(f"{x:.6f}" for x in res.losses)
          + "; host ms per step " + ", ".join(f"{x:.3f}" for x in res.step_ms))
    return res, launches


def scatter_bound_ms(runs, nb, dim, itemsize):
    """Least time for one scatter-kernel call on these runs: the prep arrays
    it needs read once (each live entry's cotangent row id, each live run's
    start and slot, the run count), ct read once, each distinct destination
    row written once; or the fp32 adds, if more."""
    n_run = int(runs.n_run[0])
    n_live = int(runs.run_starts[n_run])
    nbytes = (n_live * 4 + (n_run + 1) * 4 + n_run * 4 + 4
              + nb * dim * itemsize + n_run * dim * itemsize)
    return least_ms(nbytes, n_live * dim)


def run_lengths(runs):
    n = int(runs.n_run[0])
    lens = runs.run_starts[1:n + 1] - runs.run_starts[:n]
    return n, int(runs.run_starts[n]), int(lens.max()) if n else 0


SCATTER_SHORT_MAX = 64     # ct_scatter.cu's kShortMax: longer runs go to
SCATTER_SPAN = 1024        # the span blocks of kSpan sorted entries
SCATTER_STAGE = 32         # a span block's stage of entries


def scatter_adversarial_cases(dev):
    """Run layouts that the sorted-run scatter splits, each as the identity
    prep of a -1 padded (NB, L) id stream (entry order bag-major, each
    entry's cotangent row its bag): one run holding every entry; runs of
    every length around the short/long threshold, the span's stage and
    the span itself, in random slot order; a long run as the last live run
    (the highest slot) behind short ones; 40 long runs of 65 entries back
    to back (16 start in one span, boundaries on and off the stages); no
    live run (all ids -1). -> [(name, runs, nb, n_rows)]."""
    import numpy as np
    from repro_torch.kernels.embedding_bag import identity_scatter_prep
    rng = np.random.default_rng(29)
    T, S, W = SCATTER_SHORT_MAX, SCATTER_SPAN, SCATTER_STAGE

    def stream(lens, nb, L, n_rows, rows=None):
        lens = np.asarray(lens)
        if rows is None:
            rows = rng.choice(n_rows, size=lens.size, replace=False)
        ids = np.repeat(rows, lens).astype(np.int32)
        flat = np.full(nb * L, -1, np.int32)
        flat[rng.choice(nb * L, size=ids.size, replace=False)] = \
            rng.permutation(ids)
        idx = torch.from_numpy(flat.reshape(nb, L)).to(dev)
        return identity_scatter_prep(idx, n_rows)

    import torch
    around = [1, 2, 3, 4, 5, 8, W - 1, W, W + 1, T - 1, T, T + 1, T + 2,
              3 * W, 3 * W + 1, 2 * T, 2 * T + 1, S - 1, S, S + 1, 2 * S + 3,
              7 * W * 2 + 5]
    mixed = around + list(rng.integers(1, 12, 3000))
    last = list(rng.integers(1, 6, 2000))
    n_last = 4000
    last_rows = np.concatenate([rng.choice(n_last - 1, size=len(last),
                                           replace=False), [n_last - 1]])
    return [
        ("one run of every entry", stream([64 * 256], 64, 256, 1000), 64,
         1000),
        ("runs around 32, 64, 1024 entries + 3,000 short runs",
         stream(mixed, 256, 128, 50_000), 256, 50_000),
        ("a 700-entry run in the last live slot behind 2,000 short runs",
         stream(last + [700], 64, 128, n_last, rows=last_rows), 64, n_last),
        ("40 runs of 65 entries back to back",
         stream([T + 1] * 40 + [1] * 100, 32, 128, 300,
                rows=np.arange(140)), 32, 300),
        ("no live run (all ids -1)",
         identity_scatter_prep(torch.full((16, 64), -1, dtype=torch.int32,
                                          device=dev), 500), 16, 500),
    ]


def check_scatter_adversarial(dev, errs):
    """Every adversarial layout at D in {1, 31, 32, 33, 65, 129, 160} (fp32
    cotangent onto fp32) and at D = 32 and 33 with bf16 -> fp32 and fp32
    -> bf16: the kernel (``ct_scatter_launch``) equal to
    ``ct_scatter_runs_plain`` bit for bit."""
    import torch
    from repro_torch.kernels.embedding_bag import (ct_scatter_launch,
                                                   ct_scatter_runs_plain)
    g = torch.Generator(device=dev).manual_seed(31)
    combos = [(d, torch.float32, torch.float32)
              for d in (1, 31, 32, 33, 65, 129, 160)]
    combos += [(d, a, b) for d in (32, 33)
               for a, b in ((torch.bfloat16, torch.float32),
                            (torch.float32, torch.bfloat16))]
    for name, runs, nb, n_rows in scatter_adversarial_cases(dev):
        n_run, n_live, longest = run_lengths(runs)
        for d, ct_dt, out_dt in combos:
            ct = torch.randn((nb, d), generator=g, device=dev).to(ct_dt)
            got = ct_scatter_launch(ct, runs, torch.zeros(
                (n_rows, d), dtype=out_dt, device=dev))
            want = ct_scatter_runs_plain(ct, runs, torch.zeros(
                (n_rows, d), dtype=out_dt, device=dev))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            need(torch.equal(got, want),
                 f"ct_scatter {name}, D={d} {ct_dt} -> {out_dt}: kernel != "
                 f"plain (max abs err {err})")
            errs.append(err)
        print(f"  ct_scatter {name} ({n_run} runs, {n_live} entries, "
              f"longest {longest}): == plain at D = 1, 31, 32, 33, 65, 129, "
              f"160 and in both dtype mixes")


def check_scatter_kernel(dev, cfg, pop, res, report):
    """The sorted-run scatter kernel vs its plain version, bit for bit, at
    the train path's shape (its last batch's ids, and Zipf ids with holes
    under three ownership maps) and on the phase-2 small cases; its prep on
    the card vs on the CPU; then the timings at the train path's shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.embedding_bag import (ct_scatter_bag,
                                                   ct_scatter_bag_plain,
                                                   ct_scatter_launch,
                                                   ct_scatter_runs_plain,
                                                   scatter_entries,
                                                   scatter_prep)
    st = res.statics
    F, L, D = cfg.n_sparse, cfg.multi_hot, cfg.embed_dim
    bank, slot, off = st["remap_bank"], st["remap_flat"], st["field_offsets"]
    n_rows = st["n_banks"] * st["rows_per_bank"]
    rng = np.random.default_rng(2)
    idx_main = res.last_batch["sparse"].reshape(-1, L).contiguous()
    zipf_ids = holey(rng.choice(cfg.vocab_sizes[0], size=(TRAIN_BATCH, F, L),
                                p=pop).astype(np.int32), rng)
    idx_zipf = torch.from_numpy(zipf_ids.reshape(-1, L)).to(dev)
    live = torch.ones(st["n_banks"], dtype=torch.bool, device=dev)
    live[5] = False
    live_map = torch.where(live[bank.long()], 0, 1).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(7)
    ct = torch.randn((idx_main.shape[0], D), generator=g, device=dev)
    errs = []

    def same(name, ct, idx, bank, slot, off, my, n_rows):
        got = ct_scatter_bag(ct, idx, bank, slot, off, my, n_rows)
        want = ct_scatter_bag_plain(ct, idx, bank, slot, off, my, n_rows)
        torch.cuda.synchronize()
        need(got.shape == want.shape == (n_rows, ct.shape[1])
             and got.dtype == want.dtype == ct.dtype,
             f"ct_scatter_bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        need(torch.equal(got, want),
             f"ct_scatter_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"ct_scatter_bag {name}: non-finite")
        rows = int((got != 0).any(1).sum())
        need(rows > 0, f"ct_scatter_bag {name}: an all-zero gradient")
        errs.append(err)
        print(f"  ct_scatter_bag {name}: {tuple(got.shape)} {got.dtype}, "
              f"{rows} rows touched, == plain (max abs err {err})")

    print(f"ct_scatter_bag vs plain, bit for bit (d_table ({n_rows}, {D}) "
          f"float32, ct ({idx_main.shape[0]}, {D})):")
    same("train ids, my=-1 flat remap", ct, idx_main, bank, slot, off, -1,
         n_rows)
    same("zipf ids+holes, my=-1", ct, idx_zipf, bank, slot, off, -1, n_rows)
    same("zipf ids+holes, my=3 bank map", ct, idx_zipf, bank, slot, off, 3,
         n_rows)
    same("zipf ids+holes, bank 5 dead (binary live map, my=0)", ct, idx_zipf,
         live_map, slot, off, 0, n_rows)
    for c in small_cases(dev):
        sct = torch.randn((c["idx"].shape[0], c["table"].shape[1]),
                          generator=g, device=dev).to(c["table"].dtype)
        for my in (-1, 1):
            same(f"{c['name']} my={my}", sct, c["idx"], c["bank"], c["slot"],
                 c["off"], my, c["table"].shape[0])

    print("ct_scatter adversarial run layouts vs plain, bit for bit:")
    check_scatter_adversarial(dev, errs)

    cpu = [t.cpu() for t in (idx_zipf, bank, slot, off)]
    for my in (-1, 3):
        on_card = scatter_prep(idx_zipf, bank, slot, off, my, n_rows)
        on_cpu = scatter_prep(*cpu, my, n_rows)
        for name, a, b in zip(on_card._fields, on_card, on_cpu):
            need(torch.equal(a.cpu(), b),
                 f"scatter prep {name}, zipf ids my={my}: card != CPU")
    print("  scatter prep (zipf ids+holes, my=-1 and my=3): card == CPU")

    # timings at the train path's shape, on its own ids, L2 flushed before
    # every run (a step finds the table cold)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    runs = scatter_prep(idx_main, bank, slot, off, -1, n_rows)
    runs_zipf = scatter_prep(idx_zipf, bank, slot, off, -1, n_rows)
    out = torch.zeros((n_rows, D), device=dev)
    ms = time_ms(lambda: ct_scatter_launch(ct, runs, out), flush=scratch.zero_)
    out_p = torch.zeros((n_rows, D), device=dev)
    plain_ms = time_ms(lambda: ct_scatter_runs_plain(ct, runs, out_p), reps=5,
                       flush=scratch.zero_)
    need(torch.equal(out, out_p), "timed kernel output != timed plain output")
    del out_p
    out_z = torch.zeros((n_rows, D), device=dev)
    zipf_ms = time_ms(lambda: ct_scatter_launch(ct, runs_zipf, out_z),
                      flush=scratch.zero_)

    def index_add_ms(idx, want, long_runs):
        """One ``index_add_`` of the same cotangent rows onto the same slots,
        timed. It adds a slot's rows in no fixed order: on short runs held
        to rtol = atol = 1e-5, on runs of thousands of entries to 1e-5 of
        each sum's magnitudes."""
        dest, bags = scatter_entries(idx, bank, slot, off, -1, n_rows)
        keep = dest < n_rows
        lib_dest, lib_bag = dest[keep].long(), bags[keep].long()
        lib_out = torch.zeros((n_rows, D), device=dev)
        lib = lambda: lib_out.index_add_(0, lib_dest,  # noqa: E731
                                         ct[lib_bag])
        lib()
        if long_runs:
            mag = torch.zeros((n_rows, D), device=dev).index_add_(
                0, lib_dest, ct[lib_bag].abs())
            rel = ((lib_out - want).abs() / mag.clamp(min=1e-30)).max().item()
            need(rel <= 1e-5, f"index_add_ library call vs the kernel: {rel} "
                              f"of the summed magnitudes")
            del mag
        else:
            need(torch.allclose(lib_out, want, rtol=1e-5, atol=1e-5),
                 "index_add_ library call disagrees with the kernel")
        ms = time_ms(lib, flush=scratch.zero_)
        del lib_out
        return ms

    library_ms = index_add_ms(idx_main, out, long_runs=False)
    zipf_library_ms = index_add_ms(idx_zipf, out_z, long_runs=True)
    del out_z
    prep_ms = time_ms(lambda: scatter_prep(idx_main, bank, slot, off, -1,
                                           n_rows), flush=scratch.zero_)
    zero_ms = time_ms(lambda: torch.zeros((n_rows, D), device=dev),
                      flush=scratch.zero_)
    wrapper_ms = time_ms(lambda: ct_scatter_bag(ct, idx_main, bank, slot, off,
                                                -1, n_rows),
                         flush=scratch.zero_)
    bound_ms, bound_by = scatter_bound_ms(runs, idx_main.shape[0], D, 4)
    zipf_bound_ms, _ = scatter_bound_ms(runs_zipf, idx_zipf.shape[0], D, 4)
    n_run, n_live, longest = run_lengths(runs)
    zn_run, zn_live, zlongest = run_lengths(runs_zipf)
    print(f"ct_scatter_bag at NB={idx_main.shape[0]} L={L} D={D} fp32 "
          f"({n_live} live entries, {n_run} runs, longest {longest}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} "
          f"ms, bound {bound_ms:.6f} ms ({bound_by}); prep {prep_ms:.4f} ms, "
          f"zero fill {zero_ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms")
    print(f"  on the zipf ids ({zn_live} live entries, {zn_run} runs, longest "
          f"{zlongest}): kernel {zipf_ms:.4f} ms, index_add_ "
          f"{zipf_library_ms:.4f} ms, bound {zipf_bound_ms:.6f} ms")
    report["ct_scatter_bag"] = dict(
        name="ct_scatter_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/ct_scatter.cu",
        replaces="src/repro/kernels/embedding_bag.py:377",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, prep_ms=prep_ms, zero_fill_ms=zero_ms,
                wrapper_ms=wrapper_ms, runs=n_run, live_entries=n_live,
                longest_run=longest, zipf_kernel_ms=zipf_ms,
                zipf_library_ms=zipf_library_ms, zipf_bound_ms=zipf_bound_ms,
                zipf_runs=zn_run, zipf_live_entries=zn_live,
                zipf_longest_run=zlongest)


def check_train(dev, spec, res):
    """One step's gradients against the plain scatter of the same
    cotangent, a repeated batch's loss, and the train step's stages on the
    device (CUDA events, L2 flushed)."""
    import torch
    from repro_torch.kernels.embedding_bag import ct_scatter_bag_plain
    from repro_torch.launch.train import build_loss
    from repro_torch.models import dlrm
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import (_not_table, build_train_step,
                                              default_optimizer)
    cfg = spec.config
    state, batch, st = res.state, res.last_batch, res.statics
    loss_fn, kw = build_loss(spec, cfg, st)
    leaves = [p.detach().requires_grad_(True)
              for p in O.tree_leaves(state.params)]
    params = O.tree_unflatten(state.params, leaves)

    # one step's gradients, with the bag sums' cotangent caught on the way
    caught = {}
    lookup = dlrm.banked_embedding_bag

    def hooked(*a, **k):
        out = lookup(*a, **k)
        out.register_hook(lambda g: caught.__setitem__("ct", g))
        return out
    dlrm.banked_embedding_bag = hooked
    try:
        loss = loss_fn(params, batch, **kw)
    finally:
        dlrm.banked_embedding_bag = lookup
    grads = O.tree_unflatten(state.params, torch.autograd.grad(loss, leaves))
    table_g = grads["emb_packed"]
    want = ct_scatter_bag_plain(
        caught["ct"].reshape(-1, cfg.embed_dim).contiguous(),
        batch["sparse"].reshape(-1, cfg.multi_hot).contiguous(),
        st["remap_bank"], st["remap_flat"], st["field_offsets"], -1,
        table_g.shape[0])
    need(torch.equal(table_g, want),
         "train step: table gradient != plain scatter of the same cotangent")
    rows = int((table_g != 0).any(1).sum())
    bot = [float(g.abs().sum()) for g in grads["bot"]["w"]]
    need(rows > 0 and all(x > 0 for x in bot),
         f"train step: a gradient cut ({rows} table rows, bottom MLP |g| "
         f"{bot})")
    print(f"train step gradients: table gradient == plain scatter of the "
          f"same cotangent ({rows} rows non-zero); bottom MLP |g| sums "
          + ", ".join(f"{x:.4g}" for x in bot))
    del want, caught

    # a batch repeated lowers its loss (tests/test_train.py's learning rates)
    rep_step = build_train_step(loss_fn, default_optimizer(lr=1e-2,
                                                           emb_lr=5e-2),
                                loss_kwargs=kw)
    s, rep = state, []
    for _ in range(20):
        s, m = rep_step(s, batch)
        rep.append(float(m["loss"]))
    del s
    need(rep[-1] < rep[0], f"repeated batch: loss {rep[0]} -> {rep[-1]}")
    print(f"one batch repeated 20 times: loss {rep[0]:.6f} -> {rep[-1]:.6f}")

    # the stages on the device
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    opt = default_optimizer()
    step_fn = build_train_step(loss_fn, opt, loss_kwargs=kw)
    table_opt = O.rowwise_adagrad(1e-2)
    held = {}

    def forward():
        return loss_fn(params, batch, **kw)

    def with_graph():
        scratch.zero_()
        held["loss"] = forward()

    def backward():
        torch.autograd.grad(held.pop("loss"), leaves)

    def optimizer():
        g, _ = O.clip_by_global_norm_filtered(grads, 1.0, _not_table)
        u, _ = opt.update(g, state.opt_state, state.params)
        return O.tree_map(lambda p, u: p + u.to(p.dtype), state.params, u)

    def table_update():
        u, _ = table_opt.update([table_g], state.opt_state["true"],
                                [state.params["emb_packed"]])
        return state.params["emb_packed"] + u[0]

    out = {"forward": time_ms(forward, flush=scratch.zero_),
           "backward": time_ms(backward, flush=with_graph),
           "optimizer": time_ms(optimizer, flush=scratch.zero_),
           "rowwise_adagrad_table": time_ms(table_update, flush=scratch.zero_),
           "train_step": time_ms(lambda: step_fn(state, batch),
                                 flush=scratch.zero_)}
    del held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step_fn(state, batch)
    torch.cuda.synchronize()
    out["allocated_before_step_bytes"] = before
    out["max_allocated_in_step_bytes"] = torch.cuda.max_memory_allocated()
    out["repeated_batch_losses"] = rep
    out["profile"] = profile_device(lambda: step_fn(state, batch))
    print("train step breakdown (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()
                      if k.endswith(("forward", "backward", "optimizer",
                                     "table", "step"))))
    print(f"  device memory: {before / 2**30:.3f} GiB allocated before a "
          f"step, peak {out['max_allocated_in_step_bytes'] / 2**30:.3f} GiB "
          f"during it")
    prof = out["profile"]
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per train step: device busy {prof['busy_ms']:.4f}"
              f" ms of a {prof['window_ms']:.4f} ms window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
    return out


def check_train_reduced(dev, spec):
    """A reduced config trained for 3 steps on the card and on the CPU from
    the same weights on the same batches: losses within LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic as syn
    from repro_torch.launch.train import build_loss
    from repro_torch.models import dlrm
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    red = spec.reduced
    params, statics = dlrm.init_params(red, torch.Generator().manual_seed(4),
                                       device="cpu")
    losses = {}
    for where in ("cpu", dev):
        p, s = to_dev(params, where), to_dev(statics, where)
        loss_fn, kw = build_loss(spec, red, s)
        opt = default_optimizer()
        step = build_train_step(loss_fn, opt, loss_kwargs=kw)
        state = TrainState.create(p, opt)
        ls = []
        for i in range(3):
            b = syn.dlrm_batch(red.vocab_sizes, red.n_dense, 16, seed=6,
                               step=i, multi_hot=red.multi_hot)
            state, m = step(state, to_dev({k: torch.from_numpy(v)
                                           for k, v in b.items()}, where))
            ls.append(float(m["loss"]))
        losses[str(where)] = ls
    cpu, card = losses["cpu"], losses[str(dev)]
    need(np.allclose(card, cpu, rtol=LOSS_RTOL, atol=0),
         f"reduced config train, card vs CPU: losses {card} vs {cpu}")
    print(f"reduced config trained 3 steps on the card vs the CPU, same "
          f"weights: losses {card} vs {cpu}")
    return dict(card=card, cpu=cpu)


def cached_main_path(dev, spec):
    """Phase 5's main path: ``run_cached`` at full width with every launch
    counter set to 0 just before and read just after."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_cached
    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    for fn in counters.values():
        fn.launches = 0
    res = run_cached(spec, spec.config, requests=CACHED_REQUESTS, batch=64,
                     device=dev, profile_requests=CACHED_PROFILE)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"serve_cached: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("cache_residual_bag", "dot_features"):
        need(launches[name] > 0, f"the cached serve run launched no {name} "
                                 f"kernel")
    for name in ("banked_bag", "ct_scatter_bag", "dot_interaction"):
        need(launches[name] == 0, f"the cached serve run launched {name} "
                                  f"{launches[name]} times")
    st = res.stats
    print(f"  mined {st['mined_groups']} groups, {st['mined_entries']} "
          f"entries from {st['profile_bags']} profiled bags; kept "
          f"{st['kept_entries']}, dropped {st['dropped_entries']} (capacity "
          f"{st['cache_capacity']}); plan imbalance "
          f"{st['plan_imbalance']:.6f}, EMT rows/bank {st['emt_rows_per_bank']}")
    print(f"  hit rate on the served bags {st['hit_rate']:.6f} (uncapped "
          f"mined plan {st['hit_rate_uncapped']:.6f}); effective lengths: "
          f"cache mean {st['cache_len_mean']:.3f} max {st['cache_len_max']}, "
          f"residual mean {st['residual_len_mean']:.3f} max "
          f"{st['residual_len_max']}")
    print("  pre-process seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in st.items() if k.endswith("_s")))
    return res, launches


def cached_small_cases(dev):
    """bf16 D = 64 (a fp32 cache table, cast by the wrapper) and a ragged
    fp32 NB = 37, Lc = 5, Lr = 33, D = 40 case with all-pad bags: an EMT
    over a 4-bank §3.2 plan with the flat remap, a 128-entry 4-bank cache
    table with a permuted slot map."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for c in small_cases(dev, cases=(("bfloat16", 64, 100, 64, 1),
                                     ("float32", 40, 37, 33, 1))):
        NB, D = c["idx"].shape[0], c["table"].shape[1]
        Lc = 16 if NB == 100 else 5
        ci = torch.randint(-1, 128, (NB, Lc), generator=g, device=dev,
                           dtype=torch.int32)
        ci[::7] = -1                                     # all-pad bags
        out.append(dict(
            name=c["name"] + f" Lc={Lc}", emt=c["table"],
            e_bank=c["bank"], e_slot=c["slot"], r_idx=c["idx"],
            cache=torch.randn((128, D), generator=g, device=dev),
            c_bank=torch.arange(128, dtype=torch.int32, device=dev) // 32,
            c_slot=torch.randperm(128, generator=g, device=dev).to(
                torch.int32),
            c_idx=ci))
    return out


CACHE_LIVE = (0, 1, 255, 256, 257, 600)   # live entries of a bag


def cache_adversarial_cases(dev):
    """Tables and streams against the fused kernel's resolve-once ring:
    every D of ``BAG_DIMS`` in fp32 and bf16 (16-, 4- and 2-byte copies;
    one to three column passes), each over Lc + Lr = 64 + 520 entries with
    bags whose live entries, both streams together, number ``CACHE_LIVE``
    (0, 1, around a 256-row ring, all 584: past a 512-entry round), at
    random places within the first round where they fit (interior holes,
    compacted lists of exactly 255, 256 and 257 rows, a round of 512 and
    one of 72); NB from 37 to 41, so bags per block never
    divide it; then bags live in the cache stream only and in the residual
    stream only, Lc = 0 and Lr = 0 as shapes, a stream of padding only,
    4,301 bags (two a block), an EMT and a cache table whose bases are 4
    bytes off 16-byte alignment, and 100 + 1,100 entries (three rounds).
    Each case carries an EMT of 4 x 2,400 rows with 8-bank remaps of 2,400
    ids, a cache table of 600 rows with remaps of 300 ids, the streams, and
    the same streams as identity rows of the two tables."""
    import numpy as np
    import torch
    rng = np.random.default_rng(29)
    V, VC, R, RC = 2400, 300, 9600, 600
    shapes = []
    for dtype in ("float32", "bfloat16"):
        for D in BAG_DIMS:
            shapes.append((dtype, D, 64, 520, 37 + len(shapes) % 5,
                           "live counts"))
    shapes += [("float32", 32, 64, 256, 40, "cache stream only"),
               ("float32", 33, 64, 256, 40, "residual stream only"),
               ("float32", 32, 0, 256, 40, "Lc = 0"),
               ("bfloat16", 32, 64, 0, 40, "Lr = 0"),
               ("bfloat16", 64, 64, 256, 16, "padding only"),
               ("float32", 32, 64, 256, 4301, "two bags a block"),
               ("float32", 32, 64, 256, 40, "EMT base 4 B off alignment"),
               ("float32", 32, 64, 256, 40, "cache base 4 B off alignment"),
               ("float32", 33, 100, 1100, 24, "three rounds")]
    out = []
    for dtype, D, Lc, Lr, NB, note in shapes:
        tdt = getattr(torch, dtype)

        def table(n, off):
            t = torch.from_numpy(rng.standard_normal((n * D + 1,))
                                 .astype(np.float32)).to(dev).to(tdt)
            return t[1:].view(n, D) if off else t[:n * D].view(n, D)
        emt = table(R, note.startswith("EMT base"))
        cache = table(RC, note.startswith("cache base"))
        live = rng.random((NB, Lc + Lr)) < 0.6
        live[::5] = False                           # all-padding bags
        if note == "live counts":
            for b in range(NB):      # in the first round where they fit
                n = min(CACHE_LIVE[b % len(CACHE_LIVE)], Lc + Lr)
                live[b] = False
                live[b, rng.choice(Lc + Lr if n > 512 else min(Lc + Lr, 512),
                                   n, replace=False)] = True
        elif note == "cache stream only":
            live[:, Lc:] = False
        elif note == "residual stream only":
            live[:, :Lc] = False
        elif note == "padding only":
            live[:] = False
        ci = np.where(live[:, :Lc], rng.integers(0, VC, (NB, Lc)), -1)
        ri = np.where(live[:, Lc:], rng.integers(0, V, (NB, Lr)), -1)
        ci_rows = np.where(ci >= 0, rng.integers(0, RC, ci.shape), -1)
        ri_rows = np.where(ri >= 0, rng.integers(0, R, ri.shape), -1)

        def ids(a):
            return torch.from_numpy(a.astype(np.int32)).to(dev)

        def remap(n, rows):
            return (ids(rng.integers(0, 8, n)), ids(rng.integers(0, rows, n)))
        out.append(dict(
            name=f"{dtype} D={D} Lc={Lc} Lr={Lr} NB={NB} ({note})",
            emt=emt, cache=cache, emt_remap=remap(V, R),
            cache_remap=remap(VC, RC), c_idx=ids(ci), r_idx=ids(ri),
            c_rows=ids(ci_rows), r_rows=ids(ri_rows)))
    return out


def check_cache_adversarial(dev, errs):
    """Both instances of the fused kernel against their plain versions, bit
    for bit, on ``cache_adversarial_cases``: the remapped instance with my =
    -1, my = 3 on the 8-bank maps, and my = 0 on live maps (bank 5 dead);
    the identity instance on the identity rows."""
    import torch
    from repro_torch.kernels.embedding_bag import (cache_residual_bag,
                                                   cache_residual_bag_plain,
                                                   plain_cache_bag,
                                                   plain_cache_bag_plain)
    n = 0
    for c in cache_adversarial_cases(dev):
        (eb, es), (cb, cs) = c["emt_remap"], c["cache_remap"]
        e_live = (eb != 5).to(torch.int32) ^ 1        # 0 where live
        c_live = (cb != 5).to(torch.int32) ^ 1
        for my, ebk, cbk in ((-1, eb, cb), (3, eb, cb), (0, e_live, c_live)):
            a = (c["emt"], c["cache"], ebk, es, cbk, cs, my, c["c_idx"],
                 c["r_idx"])
            got, want = cache_residual_bag(*a), cache_residual_bag_plain(*a)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item() \
                if got.numel() else 0.0
            need(got.dtype == want.dtype and torch.equal(got, want),
                 f"cache_residual_bag {c['name']} my={my}: kernel != plain "
                 f"(max abs err {err})")
            errs.append(err)
            n += 1
        a = (c["emt"], c["cache"], c["c_rows"], c["r_rows"])
        got, want = plain_cache_bag(*a), plain_cache_bag_plain(*a)
        torch.cuda.synchronize()
        need(got.dtype == want.dtype and torch.equal(got, want),
             f"plain_cache_bag {c['name']}: kernel != plain")
        n += 1
    print(f"  cache_bag adversarial cases: {n} calls (both instances; D "
          f"{BAG_DIMS}, live lists {CACHE_LIVE}) == plain")


def cache_bag_bound_ms(ci, ri, dim, itemsize, *, remap=True):
    """Least time for one ``my = -1`` fused call on these ids, summed over
    both streams: each id read once, each distinct row of each table read
    once (its 4-byte slot, unless ``remap=False``, and its D values), the
    output written once; or the fp32 adds, if more."""
    import torch
    NB = ci.shape[0]
    n_rows = sum(torch.unique(x[x >= 0]).numel() for x in (ci, ri))
    n_valid = int((ci >= 0).sum()) + int((ri >= 0).sum())
    nbytes = (ci.numel() + ri.numel()) * 4 \
        + n_rows * (4 * remap + dim * itemsize) + NB * dim * itemsize
    return least_ms(nbytes, n_valid * dim)


def check_cache_kernel(dev, res, report):
    """The fused kernel vs its plain version, bit for bit, at the cached
    serve path's shape (its last batch's rewritten ids, with holes, my = 3
    and a dead bank) and on small bf16 / ragged cases; then the timings at
    the serve shape."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels.embedding_bag import (cache_residual_bag,
                                                   cache_residual_bag_plain)
    from repro_torch.models import dlrm
    t, ct = dlrm._banked(res.params, res.statics), res.cache_table
    b = res.last_batch
    ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1]).contiguous()
    ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1]
                                   ).contiguous()
    g = torch.Generator(device=dev).manual_seed(13)
    ci_h, ri_h = ci.clone(), ri.clone()
    ci_h[torch.rand(ci.shape, generator=g, device=dev) < 0.1] = -1
    ri_h[torch.rand(ri.shape, generator=g, device=dev) < 0.1] = -1
    live = torch.ones(t.n_banks, dtype=torch.bool, device=dev)
    live[5] = False
    e_live = torch.where(live[t.remap_bank.long()], 0, 1).to(torch.int32)
    c_live = torch.where(live[ct.remap_bank.long()], 0, 1).to(torch.int32)
    errs = []

    def same(name, emt, cache, eb, es, cb, cs, my, c_idx, r_idx):
        args = (emt, cache, eb, es, cb, cs, my, c_idx, r_idx)
        got = cache_residual_bag(*args)
        want = cache_residual_bag_plain(*args)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype == emt.dtype,
             f"cache_residual_bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        need(torch.equal(got, want),
             f"cache_residual_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"cache_residual_bag {name}: non-finite")
        errs.append(err)
        print(f"  cache_residual_bag {name}: {tuple(got.shape)} {got.dtype} "
              f"== plain (max abs err {err})")

    print(f"cache_residual_bag vs plain, bit for bit (EMT "
          f"{tuple(t.packed.shape)}, cache {tuple(ct.packed.shape)}, ids "
          f"{tuple(ci.shape)} + {tuple(ri.shape)}):")
    maps = (t.packed, ct.packed, t.remap_bank, t.remap_flat, ct.remap_bank,
            ct.remap_flat)
    same("served ids, my=-1", *maps, -1, ci, ri)
    same("served ids + holes, my=-1", *maps, -1, ci_h, ri_h)
    same("served ids + holes, my=3 bank maps", *maps, 3, ci_h, ri_h)
    same("served ids + holes, bank 5 dead (binary live maps, my=0)",
         t.packed, ct.packed, e_live, t.remap_flat, c_live, ct.remap_flat, 0,
         ci_h, ri_h)
    for c in cached_small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["emt"], c["cache"], c["e_bank"],
                 c["e_slot"], c["c_bank"], c["c_slot"], my, c["c_idx"],
                 c["r_idx"])
    check_cache_adversarial(dev, errs)

    # timings at the serve shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (*maps, -1, ci, ri)
    R = t.packed.shape[0]
    both = torch.cat([t.packed, ct.packed])
    ids = torch.cat([torch.where(ci >= 0, ct.remap_flat[ci.clamp(min=0).long()]
                                 + R, -1),
                     torch.where(ri >= 0, t.remap_flat[ri.clamp(min=0).long()],
                                 -1)], dim=1)
    valid = ids >= 0
    lib_ids = ids[valid].long()
    lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
    lib = lambda: tnf.embedding_bag(lib_ids, both, lib_offsets,  # noqa: E731
                                    mode="sum")
    need(torch.allclose(lib(), cache_residual_bag(*args), **EMB_TOL),
         "embedding_bag library call disagrees with the kernel")
    ms = time_ms(lambda: cache_residual_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: cache_residual_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    del both
    bound_ms, bound_by = cache_bag_bound_ms(ci, ri, t.dim,
                                            t.packed.element_size())
    n_c, n_r = int((ci >= 0).sum()), int((ri >= 0).sum())
    print(f"cache_residual_bag at NB={ci.shape[0]} Lc={ci.shape[1]} "
          f"Lr={ri.shape[1]} D={t.dim} fp32 ({n_c} cache + {n_r} residual "
          f"entries): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})")
    report["cache_residual_bag"] = dict(
        name="cache_residual_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:245",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, cache_entries=n_c, residual_entries=n_r)


def resolve_ids(ids, remap_flat):
    """-1 padded ids through a flat remap, padding kept: the identity-layout
    ids of the same rows."""
    import torch
    return torch.where(ids >= 0, remap_flat[ids.clamp(min=0).long()],
                       -1).to(torch.int32).contiguous()


def check_plain_cache_kernel(dev, res, report):
    """Kernel 8 (the identity instance of ``cache_bag.cu``) on the cached
    serve path's last batch, both streams resolved through their remaps:
    ``kernels.ops.cache_bag`` is run with its launch counter set to 0 just
    before and read just after; it equals ``cache_bag.cu`` on the raw
    streams and its plain version bit for bit, and so do the small bf16 /
    ragged cases; then the timings beside its bound and two
    ``F.embedding_bag`` calls summed."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ops as kops
    from repro_torch.models import dlrm
    t, ct = dlrm._banked(res.params, res.statics), res.cache_table
    b = res.last_batch
    ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1]).contiguous()
    ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1]
                                   ).contiguous()
    ci_r, ri_r = resolve_ids(ci, ct.remap_flat), resolve_ids(ri, t.remap_flat)
    kbag.plain_cache_bag.launches = 0
    got = kops.cache_bag(t.packed, ct.packed, ci_r, ri_r)
    launches = {"plain_cache_bag": kbag.plain_cache_bag.launches}
    torch.cuda.synchronize()
    need(launches["plain_cache_bag"] > 0,
         "kernels.ops.cache_bag launched no plain_cache_bag kernel")
    banked = kbag.cache_residual_bag(t.packed, ct.packed, t.remap_bank,
                                     t.remap_flat, ct.remap_bank,
                                     ct.remap_flat, -1, ci, ri)
    plain = kbag.plain_cache_bag_plain(t.packed, ct.packed, ci_r, ri_r)
    torch.cuda.synchronize()
    need(torch.equal(got, banked), "plain_cache_bag on resolved ids != "
                                   "cache_residual_bag on the raw streams")
    need(torch.equal(got, plain), "plain_cache_bag != its plain version")
    errs = [(got - plain).abs().max().item()]
    print(f"plain_cache_bag (kernel 8) on the served streams resolved: "
          f"{tuple(got.shape)} == cache_residual_bag on the raw streams == "
          f"plain, bit for bit; launches {launches}")
    for c in cached_small_cases(dev):
        args = (c["emt"], c["cache"], c["c_idx"], c["r_idx"])
        k, pl = kbag.plain_cache_bag(*args), kbag.plain_cache_bag_plain(*args)
        torch.cuda.synchronize()
        need(k.dtype == c["emt"].dtype and torch.equal(k, pl),
             f"plain_cache_bag {c['name']}: kernel != plain")
        errs.append((k.float() - pl.float()).abs().max().item())
        print(f"  plain_cache_bag {c['name']}: == plain")

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (t.packed, ct.packed, ci_r, ri_r)
    ids_c, ids_r = ci_r[ci_r >= 0].long(), ri_r[ri_r >= 0].long()
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    off_c = torch.cat([zero, (ci_r >= 0).sum(1).cumsum(0)[:-1]])
    off_r = torch.cat([zero, (ri_r >= 0).sum(1).cumsum(0)[:-1]])
    lib = lambda: (tnf.embedding_bag(ids_c, ct.packed, off_c, mode="sum")  # noqa: E731
                   + tnf.embedding_bag(ids_r, t.packed, off_r, mode="sum"))
    need(torch.allclose(lib(), got, **EMB_TOL),
         "two embedding_bag library calls disagree with the kernel")
    ms = time_ms(lambda: kbag.plain_cache_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: kbag.plain_cache_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    bound, bound_by = cache_bag_bound_ms(ci_r, ri_r, t.dim,
                                         t.packed.element_size(), remap=False)
    print(f"plain_cache_bag at NB={ci.shape[0]} Lc={ci.shape[1]} "
          f"Lr={ri.shape[1]} D={t.dim} fp32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, 2x F.embedding_bag {library_ms:.4f} ms, bound "
          f"{bound:.6f} ms ({bound_by})")
    report["plain_cache_bag"] = dict(
        name="plain_cache_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:213",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=library_ms)
    return launches, dict(kernel_ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound)


def check_cached_grads(dev, res):
    """Backward through ``banked_cache_residual_bag`` with both tables
    requiring grad: each table's gradient equals the plain scatter of the
    same cotangent bit for bit. Then the scatter kernel with an fp32
    cotangent onto bf16 tables and the reverse, against its plain
    version."""
    import dataclasses

    import torch
    from repro_torch.core.embedding import banked_cache_residual_bag
    from repro_torch.kernels.embedding_bag import (ct_scatter_bag,
                                                   ct_scatter_bag_plain)
    from repro_torch.models import dlrm
    t, ct_tab = dlrm._banked(res.params, res.statics), res.cache_table
    b = res.last_batch
    ep = t.packed.detach().requires_grad_(True)
    cp = ct_tab.packed.detach().clone().requires_grad_(True)
    out = banked_cache_residual_bag(dataclasses.replace(t, packed=ep),
                                    dataclasses.replace(ct_tab, packed=cp),
                                    b["cache_idx"], b["residual_idx"])
    g = torch.Generator(device=dev).manual_seed(17)
    cot = torch.randn(out.shape, generator=g, device=dev)
    d_emt, d_cache = torch.autograd.grad(out, [ep, cp], cot)
    D = t.dim
    ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1]).contiguous()
    ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1]
                                   ).contiguous()
    flat = cot.reshape(-1, D).contiguous()
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    want_c = ct_scatter_bag_plain(flat, ci, ct_tab.remap_bank,
                                  ct_tab.remap_flat, zero, -1, cp.shape[0])
    need(torch.equal(d_cache, want_c), "cached path: d_cache != plain scatter")
    rows_c = int((d_cache != 0).any(1).sum())
    del want_c
    want_e = ct_scatter_bag_plain(flat, ri, t.remap_bank, t.remap_flat, zero,
                                  -1, ep.shape[0])
    need(torch.equal(d_emt, want_e), "cached path: d_emt != plain scatter")
    rows_e = int((d_emt != 0).any(1).sum())
    need(rows_e > 0 and rows_c > 0, f"cached path: a gradient cut ({rows_e} "
                                    f"EMT rows, {rows_c} cache rows)")
    del want_e, d_emt, out
    print(f"cached path gradients: d_emt ({rows_e} rows non-zero) and d_cache "
          f"({rows_c} rows non-zero) == plain scatter of the same cotangent")

    mixes = []
    for ct_dtype, out_dtype in ((torch.float32, torch.bfloat16),
                                (torch.bfloat16, torch.float32)):
        c = flat.to(ct_dtype)
        for name, idx, bank, slot, n in (
                ("residual ids onto the EMT", ri, t.remap_bank, t.remap_flat,
                 ep.shape[0]),
                ("cache ids onto the cache table", ci, ct_tab.remap_bank,
                 ct_tab.remap_flat, cp.shape[0])):
            got = ct_scatter_bag(c, idx, bank, slot, zero, -1, n, out_dtype)
            want = ct_scatter_bag_plain(c, idx, bank, slot, zero, -1, n,
                                        out_dtype)
            torch.cuda.synchronize()
            need(got.dtype == out_dtype and torch.equal(got, want),
                 f"ct_scatter_bag {ct_dtype} -> {out_dtype}, {name}: kernel "
                 f"!= plain")
            mixes.append(f"{str(ct_dtype)[6:]} -> {str(out_dtype)[6:]} {name}")
            del got, want
    print("ct_scatter_bag dtype mixes == plain, bit for bit: "
          + "; ".join(mixes))
    return dict(d_emt_rows=rows_e, d_cache_rows=rows_c, mixes=mixes)


def dedup_sparse(union, offs, L):
    """(B, F, L) union-vocab ids -> each bag's distinct ids, sorted, back to
    per-field ids, -1 padded: the bag the cached path sums."""
    import numpy as np
    B, F, _ = union.shape
    out = np.full((B, F, L), -1, dtype=np.int32)
    for b in range(B):
        for f in range(F):
            u = np.unique(union[b, f][union[b, f] >= 0])
            out[b, f, :u.size] = u - offs[f]
    return out


def check_cached_outputs(dev, spec, res):
    """Cached scores finite, in (0, 1); the last batch's embeddings and
    scores against the plain path (the bag kernel) on the deduplicated bags,
    within atol 1e-5; the reduced config's cached run on the card against
    the CPU on the same weights."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import (banked_cache_residual_bag,
                                            banked_embedding_bag)
    from repro_torch.launch.serve import run_cached
    from repro_torch.models import dlrm
    cfg = spec.config
    need(tuple(res.scores.shape) == (CACHED_REQUESTS,),
         f"cached scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite cached scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "cached scores outside (0, 1)")
    b = res.last_batch
    sparse = torch.from_numpy(dedup_sparse(res.last_union, cfg.field_offsets(),
                                           cfg.multi_hot)).to(dev)
    t = dlrm._banked(res.params, res.statics)
    with torch.inference_mode():
        emb_c = banked_cache_residual_bag(t, res.cache_table, b["cache_idx"],
                                          b["residual_idx"])
        emb_p = banked_embedding_bag(t, sparse,
                                     field_offsets=res.statics["field_offsets"])
        plain = torch.sigmoid(dlrm.forward(cfg, res.params, res.statics,
                                           {"dense": b["dense"],
                                            "sparse": sparse}))
    e_err = (emb_c - emb_p).abs().max().item()
    n = (CACHED_REQUESTS - 1) % 64 + 1           # real requests of the batch
    plain = plain[:n]
    s_err = (plain - res.scores[-n:]).abs().max().item()
    need(torch.allclose(emb_c, emb_p, **EMB_TOL),
         f"cached vs plain embeddings on deduplicated bags: max abs err "
         f"{e_err}")
    need(torch.allclose(res.scores[-n:], plain, **EMB_TOL),
         f"cached vs plain scores on deduplicated bags: max abs err {s_err}")
    print(f"cached outputs: finite, in (0, 1); last batch vs the plain path "
          f"(bag kernel) on the deduplicated bags: embeddings max abs err "
          f"{e_err}, scores max abs err {s_err} (atol 1e-5)")

    red = spec.reduced
    cpu = run_cached(spec, red, requests=32, batch=16, device="cpu",
                     profile_requests=16, seed=3)
    card = run_cached(spec, red, requests=32, batch=16, device=dev,
                      profile_requests=16, seed=3,
                      params=to_dev(cpu.params, dev))
    for k in ("cache_idx", "residual_idx"):
        need(torch.equal(card.last_batch[k].cpu(), cpu.last_batch[k]),
             f"reduced cached run: {k} card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced cached run, card vs CPU: max abs err {err}")
    print(f"reduced config cached run on the card (fused kernel) vs the CPU "
          f"(jnp order), same weights: rewritten ids equal, scores max abs "
          f"err {err} (rtol 1e-5/atol 1e-6)")
    return dict(emb_err=e_err, score_err=s_err, reduced_score_err=err,
                reduced_hit_rate=cpu.stats["hit_rate"])


def cached_breakdown(dev, spec, res, plain_step_ms):
    """Device time of the cached serve step and its lookup (CUDA events, L2
    flushed) beside phase 3's plain step; the host's per-batch times from
    the run."""
    import torch
    from repro_torch.core.embedding import banked_cache_residual_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve_cached
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    t = dlrm._banked(res.params, res.statics)
    b = res.last_batch
    serve = build_recsys_serve_cached(dlrm, spec.config, res.statics,
                                      res.cache_table)
    with torch.inference_mode():
        out = {"serve_step": time_ms(lambda: serve(res.params, b),
                                     flush=scratch.zero_),
               "lookup": time_ms(lambda: banked_cache_residual_bag(
                   t, res.cache_table, b["cache_idx"], b["residual_idx"]),
                   flush=scratch.zero_)}
        prof = profile_device(lambda: serve(res.params, b), n=5)
    out["plain_serve_step"] = plain_step_ms
    host = {f"{k}_host_ms": statistics.median(v)
            for k, v in res.host_ms.items()}
    print(f"cached serve step (device ms, L2 flushed): {out['serve_step']:.4f}"
          f" (lookup {out['lookup']:.4f}) against the plain step "
          f"{plain_step_ms:.4f}")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per cached serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    print("one cached batch of 64 on the host (median over the run, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    print("  per batch, rewrite ms: "
          + ", ".join(f"{x:.3f}" for x in res.host_ms["rewrite"]))
    return {**out, **host}


def adaptive_main_path(dev, spec):
    """Phase 6's main path: ``run_adaptive`` at full width on the int4 tier
    lane, with every launch counter set to 0 just before and read just
    after. ``min_swaps=1`` makes the run itself raise unless a swap took
    place, the shapes stayed stable and the first re-tier equals a fresh
    build bit for bit."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_adaptive
    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction,
                "tiered_bag": kbag.tiered_bag}
    for fn in counters.values():
        fn.launches = 0
    res = run_adaptive(spec, spec.config, quant="int4",
                       requests=ADAPTIVE_REQUESTS, batch=64,
                       replan_every=ADAPTIVE_REPLAN, min_swaps=1, device=dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"serve_adaptive: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("tiered_bag", "dot_features"):
        need(launches[name] > 0, f"the adaptive serve run launched no {name} "
                                 f"kernel")
    for name in ("banked_bag", "cache_residual_bag", "ct_scatter_bag",
                 "dot_interaction"):
        need(launches[name] == 0, f"the adaptive serve run launched {name} "
                                  f"{launches[name]} times")
    need(res.checks["shapes_stable"] and res.checks["retier_ok"] is True,
         f"adaptive swap checks {res.checks}")
    tt = res.runtime.tiered
    counts = [int((tt.tier == k).sum()) for k in range(3)]
    print(f"  tiered table: payload {tuple(tt.payload.shape)} int8 "
          f"({tt.payload.numel() / 1e9:.3f} GB), scales and tiers "
          f"({tt.scale.numel()},) each, hot {tt.hot_dtype}; packed rows by "
          f"tier (hot, int8, int4 incl. pad slots as int8): {counts}")
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] imbalance {e.old_imbalance:.6f} -> "
              f"{e.new_imbalance:.6f}; tiers v{e.tier_version} "
              f"+{e.tier_promoted}/-{e.tier_demoted} (requant "
              f"{e.tier_requantized})")
    print(f"  swap checks: shapes stable {res.checks['shapes_stable']}, "
          f"re-tier == fresh build {res.checks['retier_ok']}")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
    return res, launches


def tiered_small_cases(dev):
    """Tiered tables beside the served one, quantized on the host from the
    phase-2 small tables: int8 only (D = 32, NB = 512, L = 256), an fp32
    hot tier with all three tiers (D = 64), bf16 hot at D = 160 (two
    passes), and a ragged D = 33 case (odd int4 width) with all-pad bags."""
    import numpy as np
    import torch
    from repro_torch.quant import (TIER_INT8, dequant_rows_f32,
                                   quantize_rows)
    rng = np.random.default_rng(19)
    out = []
    for c, hot, int8_only in zip(
            small_cases(dev, cases=(("float32", 32, 512, 256, 8),
                                    ("float32", 64, 100, 40, 4),
                                    ("float32", 160, 24, 20, 3),
                                    ("float32", 33, 37, 33, 5))),
            ("bf16", "fp32", "bf16", "bf16"), (True, False, False, False)):
        rows = (c["table"] * 0.05).cpu().numpy()
        R, D = rows.shape
        tier = np.full(R, TIER_INT8, np.int32) if int8_only \
            else rng.integers(0, 3, R).astype(np.int32)
        payload, scale = quantize_rows(rows, tier, hot_dtype=hot)
        tt = dict(payload=torch.from_numpy(payload).to(dev),
                  scale=torch.from_numpy(scale).to(dev),
                  tier=torch.from_numpy(tier).to(dev))
        need(torch.equal(dequant_rows_f32(tt["payload"], tt["scale"],
                                          tt["tier"], D, hot).cpu(),
                         dequant_rows_f32(*(torch.from_numpy(a) for a in
                                            (payload, scale, tier)), D, hot)),
             "dequant_rows_f32: card != CPU")
        name = ("int8 only " if int8_only else f"{hot} hot ") + c["name"]
        out.append(dict(name=name, hot=hot, dim=D, bank=c["bank"],
                        slot=c["slot"], off=c["off"], idx=c["idx"], **tt))
    return out


def tiered_adversarial_cases(dev):
    """Tiered tables shaped against the kernel's chunking (a 256-thread
    block per bag, 8,192 staged fp32 values): tiers cycling hot, int8, int4
    by row so every 32-entry chunk mixes all three; bags longer than the
    block and not a multiple of 32 (L = 300); L x D past the staging
    buffer (D = 64, L = 300); an all-int4 table at D = 33 (odd width);
    an fp32 hot tier at D = 160; D = 300 (two column passes). Rows are
    packed at slot = row, banks row % 4, 4 fields; 10% holes and all-pad
    bags. -> [dict(name, payload, scale, tier, bank, slot, off, idx, dim,
    hot)]."""
    import numpy as np
    import torch
    from repro_torch.quant import TIER_INT4, quantize_rows
    rng = np.random.default_rng(37)
    out = []
    for name, D, NB, L, hot, tiers in (
            ("tiers cycling by row, every chunk mixed", 32, 64, 256, "bf16",
             "cycle"),
            ("L = 300, past the block", 32, 40, 300, "bf16", "random"),
            ("L x D past the staging buffer", 64, 24, 300, "bf16", "random"),
            ("int4 only, D = 33", 33, 37, 77, "bf16", "int4"),
            ("fp32 hot, D = 160", 160, 24, 100, "fp32", "random"),
            ("D = 300, two column passes", 300, 12, 40, "bf16", "random")):
        F, per_field = 4, 3000
        R = F * per_field
        rows = (rng.standard_normal((R, D)) * 0.05).astype(np.float32)
        tier = {"cycle": np.arange(R) % 3,
                "random": rng.integers(0, 3, R),
                "int4": np.full(R, TIER_INT4)}[tiers].astype(np.int32)
        payload, scale = quantize_rows(rows, tier, hot_dtype=hot)
        ids = rng.integers(0, per_field, (NB, L)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.1] = -1
        ids[::5] = -1                                   # all-pad bags
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        out.append(dict(
            name=f"{name} ({hot} hot, D={D}, NB={NB}, L={L})",
            payload=t(payload), scale=t(scale), tier=t(tier),
            bank=t((np.arange(R) % 4).astype(np.int32)),
            slot=t(np.arange(R, dtype=np.int32)),
            off=t((np.arange(F) * per_field).astype(np.int32)), idx=t(ids),
            dim=D, hot=hot))
    return out


def tiered_bound_ms(idx, off, n_fields, tt):
    """Least time for one ``my = -1`` tiered call on these ids: each id read
    once, each distinct row touched read once (its 4-byte slot and tier,
    its 4-byte scale unless hot, and its bytes at its own tier's width), the
    fp32 output written once; or the fp32 adds and dequant multiplies, if
    more."""
    import torch
    from repro_torch.quant import TIER_HOT, tier_nbytes
    NB, L = idx.shape
    bag = torch.arange(NB, device=idx.device) % n_fields
    valid = idx >= 0
    rows = (idx.long() + off.long()[bag][:, None])[valid]
    uniq = torch.unique(rows)
    tier = tt.tier[tt.remap_flat[uniq].long()].long()
    lut = torch.as_tensor(tier_nbytes(tt.dim, tt.hot_dtype), device=idx.device)
    nbytes = (NB * L * 4 + off.numel() * 4 + uniq.numel() * 8
              + int((tier != TIER_HOT).sum()) * 4 + int(lut[tier].sum())
              + NB * tt.dim * 4)
    entry_tier = tt.tier[tt.remap_flat[rows].long()]
    return least_ms(nbytes, (rows.numel() + int(
        (entry_tier != TIER_HOT).sum())) * tt.dim)


def check_tiered_kernel(dev, res, report):
    """The tiered kernel vs its plain version, bit for bit (``torch.equal``),
    on the served table at the serve path's shape (its last batch's ids,
    with holes, my = 3, a dead bank) and on the small tables; then the
    timings at the serve shape."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels.embedding_bag import tiered_bag, tiered_bag_plain
    from repro_torch.quant import dequant_rows_f32
    tt = res.runtime.tiered
    off = res.statics["field_offsets"]
    sp = res.last_batch["sparse"]
    F, L = sp.shape[1], sp.shape[2]
    idx = sp.reshape(-1, L).contiguous()
    g = torch.Generator(device=dev).manual_seed(23)
    idx_h = idx.clone()
    idx_h[torch.rand(idx.shape, generator=g, device=dev) < 0.1] = -1
    idx_h[::9] = -1                                       # all-pad bags
    live = torch.ones(tt.n_banks, dtype=torch.bool, device=dev)
    live[5] = False
    live_map = torch.where(live[tt.remap_bank.long()], 0, 1).to(torch.int32)
    errs = []

    def same(name, payload, scale, tier, bank, slot, offs, my, ids, dim, hot):
        args = (payload, scale, tier, bank, slot, offs, my, ids)
        got = tiered_bag(*args, dim=dim, hot_dtype=hot)
        want = tiered_bag_plain(*args, dim=dim, hot_dtype=hot)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype
             == torch.float32, f"tiered_bag {name}: {got.shape}/{got.dtype} "
                               f"vs {want.shape}/{want.dtype}")
        err = (got - want).abs().max().item() if got.numel() else 0.0
        need(torch.equal(got, want),
             f"tiered_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got).all()), f"tiered_bag {name}: non-finite")
        errs.append(err)
        print(f"  tiered_bag {name}: {tuple(got.shape)} == plain (max abs "
              f"err {err})")

    print(f"tiered_bag vs plain, bit for bit (payload "
          f"{tuple(tt.payload.shape)}, ids {tuple(idx.shape)}):")
    maps = (tt.payload, tt.scale, tt.tier)
    same("served ids, live tier map, my=-1", *maps, tt.remap_bank,
         tt.remap_flat, off, -1, idx, tt.dim, tt.hot_dtype)
    same("served ids + holes, my=-1", *maps, tt.remap_bank, tt.remap_flat,
         off, -1, idx_h, tt.dim, tt.hot_dtype)
    same("served ids + holes, my=3 bank map", *maps, tt.remap_bank,
         tt.remap_flat, off, 3, idx_h, tt.dim, tt.hot_dtype)
    same("served ids + holes, bank 5 dead (binary live map, my=0)", *maps,
         live_map, tt.remap_flat, off, 0, idx_h, tt.dim, tt.hot_dtype)
    for c in tiered_small_cases(dev) + tiered_adversarial_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["payload"], c["scale"], c["tier"],
                 c["bank"], c["slot"], c["off"], my, c["idx"], c["dim"],
                 c["hot"])

    # timings at the serve shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (*maps, tt.remap_bank, tt.remap_flat, off, -1, idx)
    kw = dict(dim=tt.dim, hot_dtype=tt.hot_dtype)
    bag = torch.arange(idx.shape[0], device=dev) % F
    valid = idx >= 0
    slots = tt.remap_flat[(idx.long() + off.long()[bag][:, None])[valid]
                          ].long()
    uniq, inv = torch.unique(slots, return_inverse=True)
    # the reference point: the touched rows dequantized to fp32 BEFORE the
    # call, then one F.embedding_bag (no PyTorch call dequantizes in a bag)
    deq = dequant_rows_f32(tt.payload[uniq], tt.scale[uniq], tt.tier[uniq],
                           tt.dim, tt.hot_dtype)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         valid.sum(1).cumsum(0)[:-1]])
    ref = lambda: tnf.embedding_bag(inv, deq, offsets,  # noqa: E731
                                    mode="sum")
    need(torch.allclose(ref(), tiered_bag(*args, **kw), **EMB_TOL),
         "embedding_bag reference point disagrees with the kernel")
    ms = time_ms(lambda: tiered_bag(*args, **kw), flush=scratch.zero_)
    plain_ms = time_ms(lambda: tiered_bag_plain(*args, **kw), reps=5,
                       flush=scratch.zero_)
    ref_ms = time_ms(ref, flush=scratch.zero_)
    bound_ms, bound_by = tiered_bound_ms(idx, off, F, tt)
    n_live = int(valid.sum())
    print(f"tiered_bag at NB={idx.shape[0]} L={L} D={tt.dim} {tt.hot_dtype} "
          f"hot ({n_live} entries, {uniq.numel()} distinct rows): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); reference point F.embedding_bag over rows "
          f"dequantized beforehand {ref_ms:.4f} ms")
    report["tiered_bag"] = dict(
        name="tiered_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/tiered_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:270",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    return dict(kernel_ms=ms, plain_ms=plain_ms, reference_ms=ref_ms,
                bound_ms=bound_ms, entries=n_live, distinct_rows=uniq.numel())


def check_adaptive_outputs(dev, spec, res):
    """Scores finite, in (0, 1); the device traffic counters equal their
    host twins on the last batch under the live table; the last batch
    re-scored through the plain lookup (same table) equals the kernel path's
    embeddings bit for bit and its scores within rtol 1e-5 / atol 1e-6; the
    reduced config's adaptive run on the card equals the CPU's swap for
    swap (same weights): the same swap events, tier counts, tiered bytes,
    reads and bytes per batch, scores within rtol 1e-5 / atol 1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import tiered_embedding_bag
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.serve import run_adaptive
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import (host_tiered_bank_traffic,
                                         tiered_bank_traffic)
    from repro_torch.quant import tier_nbytes
    from repro_torch.serve.serve_step import build_recsys_serve_tiered_adaptive
    cfg = spec.config
    need(tuple(res.scores.shape) == (ADAPTIVE_REQUESTS,),
         f"adaptive scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite adaptive scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "adaptive scores outside (0, 1)")
    tt, b = res.runtime.tiered, res.last_batch
    off = res.statics["field_offsets"]
    rows = torch.where(b["sparse"] >= 0, b["sparse"] + off[None, :, None], -1)
    lut = tier_nbytes(tt.dim, tt.hot_dtype)
    got = tiered_bank_traffic(tt.remap_bank, tt.remap_slot, tt.rows_per_bank,
                              tt.tier, lut, rows, tt.n_banks)
    want = host_tiered_bank_traffic(
        tt.remap_bank.cpu().numpy(), tt.remap_slot.cpu().numpy(),
        tt.rows_per_bank, tt.tier.cpu().numpy(), lut, rows.cpu().numpy(),
        tt.n_banks)
    need(np.array_equal(got.reads.cpu().numpy(), want[0])
         and np.array_equal(got.nbytes.cpu().numpy(), want[1]),
         f"tiered traffic counters: card {got} != host {want}")
    print(f"traffic counters on the last batch, card == host twin: reads "
          f"{want[0].tolist()}, bytes {want[1].tolist()}")

    params = {**res.params, "emb_packed": res.runtime.table.packed}
    with torch.inference_mode():
        emb_k = tiered_embedding_bag(params["emb_packed"], tt, b["sparse"],
                                     field_offsets=off)
        emb_p = tiered_embedding_bag(params["emb_packed"], tt, b["sparse"],
                                     backend="torch", field_offsets=off)
    need(torch.equal(emb_k, emb_p), "tiered lookup: kernel path != plain path")
    s_k = build_recsys_serve_tiered_adaptive(dlrm, cfg, res.statics)(
        params, tt, b)
    s_p = build_recsys_serve_tiered_adaptive(dlrm, cfg, res.statics,
                                             backend="torch")(params, tt, b)
    s_err = (s_k - s_p).abs().max().item()
    need(torch.allclose(s_k, s_p, **SCORE_TOL),
         f"tiered serve step, kernels vs plain: max abs err {s_err}")
    print(f"adaptive outputs: finite, in (0, 1); last batch re-served under "
          f"the live table: embeddings kernel == plain, scores max abs err "
          f"{s_err} (rtol 1e-5/atol 1e-6)")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(quant="int4", requests=96, batch=8, replan_every=2,
              drift_rotate_every=24, seed=1, min_swaps=1)
    cpu = run_adaptive(spec, red, device="cpu", params=p0, **kw)
    card = run_adaptive(spec, red, device=dev, params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.old_imbalance, e.new_imbalance,  # noqa: E731
                     e.tier_version, e.tier_promoted, e.tier_demoted,
                     e.tier_requantized) for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) >= 1,
         f"reduced adaptive run: swaps card {ev(card)} != CPU {ev(cpu)}")
    for f in ("payload", "scale", "tier", "remap_bank", "remap_slot"):
        need(torch.equal(getattr(card.runtime.tiered, f).cpu(),
                         getattr(cpu.runtime.tiered, f)),
             f"reduced adaptive run: tiered {f} card != CPU")
    for k in ("reads", "nbytes"):
        need(all(np.array_equal(x, y) for x, y in zip(getattr(card, k),
                                                       getattr(cpu, k)))
             and len(getattr(card, k)) == len(getattr(cpu, k)),
             f"reduced adaptive run: per-batch {k} card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced adaptive run, card vs CPU: max abs err {err}")
    print(f"reduced config adaptive int4 run on the card (tiered kernel) vs "
          f"the CPU (jnp order), same weights: {len(cpu.swaps)} swap(s) "
          f"{ev(cpu)} equal, tiered tables, reads and bytes equal, scores "
          f"max abs err {err} (rtol 1e-5/atol 1e-6)")
    return dict(score_err=s_err, reduced_score_err=err,
                reduced_swaps=ev(cpu), traffic_reads=want[0].tolist(),
                traffic_nbytes=want[1].tolist())


def adaptive_breakdown(dev, spec, res):
    """Device time of the tiered serve step and its lookup (CUDA events, L2
    flushed); the host's per-batch times from the run, the telemetry tap's
    share of ``next_batch``, and the swaps' host times."""
    import torch
    from repro_torch.core.embedding import tiered_embedding_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve_tiered_adaptive
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tt, b = res.runtime.tiered, res.last_batch
    params = {**res.params, "emb_packed": res.runtime.table.packed}
    off = res.statics["field_offsets"]
    serve = build_recsys_serve_tiered_adaptive(dlrm, spec.config, res.statics)
    with torch.inference_mode():
        out = {"serve_step": time_ms(lambda: serve(params, tt, b),
                                     flush=scratch.zero_),
               "lookup": time_ms(lambda: tiered_embedding_bag(
                   params["emb_packed"], tt, b["sparse"], field_offsets=off),
                   flush=scratch.zero_)}
        prof = profile_device(lambda: serve(params, tt, b), n=5)
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "serve", "end_batch")}
    host["telemetry_share_of_next_batch"] = sum(h["observe"]) / sum(
        h["next_batch"])
    print(f"tiered serve step (device ms, L2 flushed): {out['serve_step']:.4f}"
          f" (lookup {out['lookup']:.4f})")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per tiered serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    print("one adaptive batch of 64 on the host (median over the run, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("next_batch", "observe", "serve", "end_batch"):
        print(f"  per batch, {k} ms: "
              + ", ".join(f"{x:.3f}" for x in h[k]))
    print("  per swap, host ms: " + "; ".join(
        f"batch {e.batch}: migrate {m:.1f}, re-tier {r:.1f}, swap checks "
        f"{c:.1f}" for e, m, r, c in zip(res.swaps, h["migrate"], h["retier"],
                                        h["check_swap"])))
    return {**out, **host}


def replicated_main_path(dev, spec):
    """Phase 7's main path: ``run_replicated`` at full width with
    ``k_max = 4``, with every launch counter set to 0 just before and read
    just after. ``min_swaps=1`` makes the run itself raise unless a swap
    took place, the shapes stayed stable and the first swap's replicated
    table (and its scores) equal a fresh ``pack_replicated`` bit for bit."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_replicated
    counters = {"banked_bag": (kbag.banked_bag, "launches"),
                "banked_bag_replicated": (kbag.banked_bag,
                                          "replicated_launches"),
                "cache_residual_bag": (kbag.cache_residual_bag, "launches"),
                "ct_scatter_bag": (kbag.ct_scatter_bag, "launches"),
                "dot_features": (kdot.dot_features, "launches"),
                "dot_interaction": (kdot.dot_interaction, "launches"),
                "tiered_bag": (kbag.tiered_bag, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    res = run_replicated(spec, spec.config, requests=REPLICATED_REQUESTS,
                         batch=64, k_max=K_MAX,
                         replan_every=REPLICATED_REPLAN, min_swaps=1,
                         device=dev)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    print(f"serve_replicated: {len(res.latencies)} requests at batch 64, "
          f"k_max {K_MAX}, launches {launches}")
    for name in ("banked_bag_replicated", "dot_features"):
        need(launches[name] > 0, f"the replicated serve run launched no "
                                 f"{name} kernel")
    for name in ("banked_bag", "cache_residual_bag", "ct_scatter_bag",
                 "dot_interaction", "tiered_bag"):
        need(launches[name] == 0, f"the replicated serve run launched "
                                  f"{name} {launches[name]} times")
    need(res.checks == {"shapes_stable": True, "repack_ok": True},
         f"replicated swap checks {res.checks}")
    rplan, rt = res.runtime.replicated
    st = res.stats
    print(f"  replicated table: packed {tuple(rt.packed.shape)} "
          f"{rt.packed.dtype} ({rt.packed.numel() * 4 / 1e9:.3f} GB), maps "
          f"{tuple(rt.remap_bank.shape)} int32 each; replica v"
          f"{st['replica_version']}: {st['replicated_rows']} replicated "
          f"row(s), modeled max-bank share {st['modeled_max_share']:.6f} "
          f"(ideal {st['ideal_share']:.6f})")
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] imbalance {e.old_imbalance:.6f} -> "
              f"{e.new_imbalance:.6f}; replicas v{e.replica_version} hot="
              f"{e.replica_hot_rows} churn={e.replica_copy_churn}")
    print(f"  swap checks: shapes stable {res.checks['shapes_stable']}, "
          f"replicated table == fresh pack_replicated (arrays and scores) "
          f"{res.checks['repack_ok']}")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in st.items() if k.endswith("_s")))
    return res, launches


def replicated_small_cases(dev):
    """Replicated tables beside the served one, packed on the host: k_max 2
    with bf16 at D = 64, k_max 3 (a modulo that is not a power of two) at a
    ragged D = 33 with all-pad bags, k_max 4 at D = 160 (two passes), and
    k_max 3 at the serve shape (NB = 512, L = 256, D = 32). Each over a
    4-bank replication-aware plan whose 4 hottest rows a field hold k_max
    copies, ids drawn half from those rows, 10% holes."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import pack_replicated
    from repro_torch.core.partitioning import replicated_partition
    rng = np.random.default_rng(29)
    out = []
    for dtype, D, NB, L, F, k in (("bfloat16", 64, 100, 40, 4, 2),
                                  ("float32", 33, 37, 33, 5, 3),
                                  ("float32", 160, 24, 20, 3, 4),
                                  ("float32", 32, 512, 256, 8, 3)):
        per = 20_000
        V = per * F
        freq = rng.random(V) + 0.01
        hot = (np.arange(F)[:, None] * per + np.arange(4)).ravel()
        freq[hot] += 1e4
        copies = np.ones(V, np.int32)
        copies[hot] = k
        rplan = replicated_partition(freq, 4, copies=copies, k_max=k)
        rt = pack_replicated(rng.standard_normal((V, D)).astype(np.float32),
                             rplan, dtype=getattr(torch, dtype), device=dev)
        ids = np.where(rng.random((NB, L)) < 0.5, rng.integers(0, 4, (NB, L)),
                       rng.integers(0, per, (NB, L))).astype(np.int32)
        ids[rng.random(ids.shape) < 0.1] = -1
        ids[::7] = -1                                    # all-pad bags
        out.append(dict(name=f"k_max={k} {dtype} D={D} NB={NB} L={L}",
                        rt=rt, off=torch.arange(F, dtype=torch.int32,
                                                device=dev) * per,
                        idx=torch.from_numpy(ids).to(dev)))
    return out


def check_replica_kernel(dev, res, report):
    """The replica select vs its plain version, bit for bit
    (``torch.equal``): the last served batch's ids under the live replica
    maps through the all-live failover maps (``my = 0``, the serve path)
    and the raw flat maps (``my = -1``), with holes and all-pad bags at
    ``my = 3`` and with bank 5 dead, on the small tables, and on a
    full-width table whose hot rows hold copies (the replica plan of the
    last batch's exact counts); the replicated gradient on that table; then
    the timings at the serve shape."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.core.embedding import _replica_failover_maps
    from repro_torch.core.partitioning import (choose_replication,
                                               replicated_partition)
    from repro_torch.kernels.embedding_bag import (banked_bag,
                                                   banked_bag_plain,
                                                   ct_scatter_bag,
                                                   ct_scatter_bag_plain,
                                                   replica_of_bag)
    from repro_torch.workload.migrate import migrate_replicated
    _, rt = res.runtime.replicated
    k = rt.k_max
    off = res.statics["field_offsets"]
    sp = res.last_batch["sparse"]
    F, L = sp.shape[1], sp.shape[2]
    idx = sp.reshape(-1, L).contiguous()
    g = torch.Generator(device=dev).manual_seed(31)
    idx_h = idx.clone()
    idx_h[torch.rand(idx.shape, generator=g, device=dev) < 0.1] = -1
    idx_h[::9] = -1                                       # all-pad bags
    live = torch.ones(rt.n_banks, dtype=torch.bool, device=dev)
    dead5 = live.clone()
    dead5[5] = False
    bf, sf = _replica_failover_maps(rt, live)
    bf5, sf5 = _replica_failover_maps(rt, dead5)
    errs = []

    def same(name, table, bank, slot, offs, my, ids, kk):
        got = banked_bag(table, bank, slot, offs, my, ids, kk)
        want = banked_bag_plain(table, bank, slot, offs, my, ids, kk)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"replica bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        need(torch.equal(got, want),
             f"replica bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"replica bag {name}: non-finite")
        errs.append(err)
        print(f"  replica bag {name}: {tuple(got.shape)} {got.dtype} == "
              f"plain (max abs err {err})")

    print(f"banked_bag replica select (k_max > 1) vs plain, bit for bit "
          f"(packed {tuple(rt.packed.shape)}, maps "
          f"{tuple(rt.remap_bank.shape)}, ids {tuple(idx.shape)}):")
    same("served ids, all-live failover maps, my=0", rt.packed, bf, sf, off,
         0, idx, k)
    same("served ids, raw flat maps, my=-1", rt.packed, rt.bank_flat,
         rt.remap_flat, off, -1, idx, k)
    same("served ids + holes, my=3 bank map", rt.packed, rt.bank_flat,
         rt.remap_flat, off, 3, idx_h, k)
    same("served ids + holes, bank 5 dead (failover maps, my=0)", rt.packed,
         bf5, sf5, off, 0, idx_h, k)
    for c in replicated_small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["rt"].packed, c["rt"].bank_flat,
                 c["rt"].remap_flat, c["off"], my, c["idx"], c["rt"].k_max)

    # a full-width table whose hot rows really hold copies: the replica
    # plan of the last batch's exact row counts. (The run's own plans copy
    # nothing at this vocab: the telemetry's sketch floor, summed over
    # 18.9 M rows, lifts choose_replication's threshold past every row.)
    t0 = time.perf_counter()
    base = res.runtime.table
    bag = torch.arange(idx.shape[0], device=dev)
    valid = idx >= 0
    rows = (idx.long() + off.long()[bag % F][:, None])[valid]
    freq = np.bincount(rows.cpu().numpy(), minlength=base.vocab
                       ).astype(np.float64)
    copies_x = choose_replication(freq, rt.n_banks, k_max=k, max_r=64)
    xplan = replicated_partition(freq, rt.n_banks, copies=copies_x,
                                 capacity_rows=rt.rows_per_bank, k_max=k)
    xt = migrate_replicated(base, xplan, rows_per_bank=rt.rows_per_bank)
    xbf, xsf = _replica_failover_maps(xt, live)
    print(f"  exact-count replica plan of the last batch: "
          f"{xplan.n_replicated} replicated rows, modeled max-bank share "
          f"{xplan.max_share():.6f} ({time.perf_counter() - t0:.1f} s)")
    need(xplan.n_replicated > 0, "the exact-count plan replicates no row")
    same("served ids, exact-count replicated table, failover maps, my=0",
         xt.packed, xbf, xsf, off, 0, idx, k)
    same("served ids + holes, exact-count replicated table, my=-1",
         xt.packed, xt.bank_flat, xt.remap_flat, off, -1, idx_h, k)

    # the gradient on the exact-count table: the scatter kernel on the
    # k_max = 4 prep, and the copy sum of a ones cotangent against the
    # single-copy gradient of the base table
    R = xt.packed.shape[0]
    ct = torch.randn((idx.shape[0], xt.dim), generator=g, device=dev)
    gk = ct_scatter_bag(ct, idx, xbf, xsf, off, 0, R, k_max=k)
    gp = ct_scatter_bag_plain(ct, idx, xbf, xsf, off, 0, R, k_max=k)
    torch.cuda.synchronize()
    need(torch.equal(gk, gp), "replicated scatter: kernel != plain")
    ones = torch.ones_like(ct)
    g_rep = ct_scatter_bag(ones, idx, xt.bank_flat, xt.remap_flat, off, -1,
                           R, k_max=k)
    g_one = ct_scatter_bag(ones, idx, base.remap_bank, base.remap_flat, off,
                           -1, base.packed.shape[0])
    urows = torch.unique(rows)
    copies = torch.from_numpy(xplan.copies).to(dev)[urows].long()
    pos = xt.remap_flat.view(-1, k)[urows].long()             # (u, k)
    fold = torch.zeros((urows.numel(), xt.dim), device=dev)
    for r in range(k):                                        # copy order
        fold += torch.where((r < copies)[:, None], g_rep[pos[:, r]], 0.0)
    single = g_one[base.remap_flat[urows].long()]
    need(torch.equal(fold, single),
         "replicated gradient: copy sum != single-copy gradient")
    rowk = ((idx.long() + off.long()[bag % F][:, None]) * k
            + replica_of_bag(bag, k).long()[:, None])[valid]
    n_copies = torch.unique(xt.remap_flat[rowk]).numel()
    need(int((g_rep != 0).any(1).sum()) == n_copies > urows.numel()
         and int((g_one != 0).any(1).sum()) == urows.numel(),
         "replicated gradient: rows touched")
    print(f"replicated gradient (exact-count table): scatter kernel == plain "
          f"on the k_max={k} prep (random cotangent); ones cotangent: each "
          f"row's copies sum to the single-copy gradient on {urows.numel()} "
          f"rows ({n_copies} copies touched)")

    # timings at the serve shape, on the serve path's call (all-live
    # failover maps, my = 0), L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    xargs = (xt.packed, xbf, xsf, off, 0, idx, k)
    x_ms = time_ms(lambda: banked_bag(*xargs), flush=scratch.zero_)
    x_bound, _ = bag_bound_ms(idx, off, F, xt.dim, xt.packed.element_size(),
                              k_max=k, my=0, slot=xsf)
    print(f"banked_bag replica select on the exact-count table "
          f"({xplan.n_replicated} rows x {k} copies): kernel {x_ms:.4f} ms, "
          f"bound {x_bound:.6f} ms")
    del xt, xbf, xsf, g_rep, g_one, gk, gp
    args = (rt.packed, bf, sf, off, 0, idx, k)
    rowk_all = ((idx.long() + off.long()[bag % F][:, None]) * k
                + replica_of_bag(bag, k).long()[:, None])
    lib_ids = sf[rowk_all[valid]].long()
    lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
    lib = lambda: tnf.embedding_bag(lib_ids, rt.packed,  # noqa: E731
                                    lib_offsets, mode="sum")
    need(torch.allclose(lib(), banked_bag(*args), rtol=1e-5, atol=1e-5),
         "embedding_bag library call disagrees with the replica kernel")
    ms = time_ms(lambda: banked_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: banked_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    bound_ms, bound_by = bag_bound_ms(idx, off, F, rt.dim,
                                      rt.packed.element_size(), k_max=k,
                                      my=0, slot=sf)
    n_read = torch.unique(sf[rowk_all[valid]]).numel()
    print(f"banked_bag replica select at NB={idx.shape[0]} L={L} D={rt.dim} "
          f"k_max={k} fp32 ({int(valid.sum())} entries, {n_read} distinct "
          f"copies): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.embedding_bag (ids resolved beforehand) {library_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    report["banked_bag_replicated"] = dict(
        name="banked_bag_replicated", route="cuda",
        source="src/repro_torch/kernels/csrc/banked_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:133 (_entry_fns k_max > "
                 "1 branch) in _banked_bag_kernel (:231)",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, entries=int(valid.sum()),
                distinct_copies=n_read, exact_count_kernel_ms=x_ms,
                exact_count_bound_ms=x_bound,
                exact_count_replicated_rows=xplan.n_replicated,
                exact_count_max_share=xplan.max_share())


def check_replicated_outputs(dev, spec, res):
    """Scores finite, in (0, 1); the device traffic counters equal their
    host twin and the run's own reads on the last batch; the last batch
    re-scored through the single-copy path on the base table gives the same
    embeddings bit for bit and scores within rtol 1e-5 / atol 1e-6; the
    reduced config's replicated run on the card equals the CPU's swap for
    swap (same weights): the same swap events, replicated rows, replicated
    tables and reads per batch, scores within rtol 1e-5 / atol 1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import (banked_embedding_bag,
                                            replicated_embedding_bag)
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.serve import run_replicated
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import (host_replicated_bank_read_counts,
                                         replicated_bank_read_counts)
    from repro_torch.serve.serve_step import (
        build_recsys_serve_adaptive, build_recsys_serve_replicated_adaptive)
    cfg = spec.config
    need(tuple(res.scores.shape) == (REPLICATED_REQUESTS,),
         f"replicated scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()),
         "non-finite replicated scores")
    # Zipf(2.0) bags of 256 repeat a field's top row ~150 times, so random
    # weights drive many logits past where fp32's sigmoid rounds to 1
    need(bool(((res.scores >= 0) & (res.scores <= 1)).all()),
         "replicated scores outside [0, 1]")
    n_sat = int(((res.scores == 0) | (res.scores == 1)).sum())
    (rplan, rt), b = res.runtime.replicated, res.last_batch
    off = res.statics["field_offsets"]
    live = torch.ones(rt.n_banks, dtype=torch.bool, device=dev)
    rows = torch.where(b["sparse"] >= 0, b["sparse"] + off[None, :, None], -1)
    # the replica version that served the last batch (a swap may follow it)
    v_last = res.runtime.replica_version - int(
        bool(res.swaps) and res.swaps[-1].batch == len(res.reads))
    lplan, lrt = res.runtime.replicated_for(v_last)
    got = replicated_bank_read_counts(lrt.remap_bank, rows, rt.n_banks,
                                      k_max=rt.k_max, bank_live=live)
    want = host_replicated_bank_read_counts(
        lplan.bank_of_copy, rows.cpu().numpy(), rt.n_banks, k_max=rt.k_max,
        bank_live=np.ones(rt.n_banks, bool))
    need(np.array_equal(got.cpu().numpy(), want)
         and np.array_equal(res.reads[-1], want),
         f"replicated traffic counters: card {got.tolist()}, run "
         f"{res.reads[-1].tolist()}, host {want.tolist()}")
    print(f"traffic counters on the last batch (replica v{v_last}), card == "
          f"host twin == the run's: reads {want.tolist()} (max share "
          f"{want.max() / want.sum():.6f})")

    base = res.runtime.table
    params = {**res.params, "emb_packed": base.packed}
    with torch.inference_mode():
        emb_r = replicated_embedding_bag(rt, b["sparse"], field_offsets=off,
                                         bank_live=live)
        emb_1 = banked_embedding_bag(base, b["sparse"], field_offsets=off)
    need(torch.equal(emb_r, emb_1),
         "replicated lookup != single-copy lookup on the base table")
    s_r, counts = build_recsys_serve_replicated_adaptive(
        dlrm, cfg, res.statics)(params, rt, live, b)
    s_1 = build_recsys_serve_adaptive(dlrm, cfg, res.statics)(
        params, base.remap_bank, base.remap_slot, b,
        remap_flat=base.remap_flat)
    s_err = (s_r - s_1).abs().max().item()
    need(int(counts.sum()) == 0 and torch.allclose(s_r, s_1, **SCORE_TOL)
         and torch.equal(s_r, res.scores[-s_r.shape[0]:]),
         f"replicated scores vs the single-copy re-score: max abs err "
         f"{s_err}")
    # the logits too: saturated scores would hide a difference
    st1 = {**res.statics, "remap_bank": base.remap_bank,
           "remap_slot": base.remap_slot, "remap_flat": base.remap_flat}
    with torch.inference_mode():
        lg_r = dlrm.forward(cfg, params, res.statics, b, replicated=rt,
                            bank_live=live)
        lg_1 = dlrm.forward(cfg, params, st1, b)
    l_err = (lg_r - lg_1).abs().max().item()
    need(torch.allclose(lg_r, lg_1, **SCORE_TOL),
         f"replicated logits vs the single-copy path: max abs err {l_err}")
    print(f"replicated outputs: finite, in [0, 1] (min "
          f"{res.scores.min().item()}, {n_sat} of {res.scores.numel()} "
          f"rounded to exactly 0 or 1); last batch re-scored through the "
          f"single-copy path on the base table: embeddings equal bit for "
          f"bit, scores max abs err {s_err}, logits (from "
          f"{lg_1.min().item():.3f} to {lg_1.max().item():.3f}) max abs err "
          f"{l_err} (rtol 1e-5/atol 1e-6)")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(k_max=K_MAX, requests=96, batch=8, replan_every=2,
              drift_rotate_every=24, seed=1, min_swaps=1)
    cpu = run_replicated(spec, red, device="cpu", params=p0, **kw)
    card = run_replicated(spec, red, device=dev, params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.old_imbalance, e.new_imbalance,  # noqa: E731
                     e.replica_version, e.replica_hot_rows,
                     e.replica_copy_churn) for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) >= 1,
         f"reduced replicated run: swaps card {ev(card)} != CPU {ev(cpu)}")
    (cp, ct_), (gp, gt) = cpu.runtime.replicated, card.runtime.replicated
    need(np.array_equal(cp.copies, gp.copies)
         and all(torch.equal(getattr(gt, f).cpu(), getattr(ct_, f))
                 for f in ("packed", "remap_bank", "remap_slot")),
         "reduced replicated run: replicated table card != CPU")
    need(len(card.reads) == len(cpu.reads)
         and all(np.array_equal(x, y) for x, y in zip(card.reads, cpu.reads)),
         "reduced replicated run: per-batch reads card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced replicated run, card vs CPU: max abs err {err}")
    print(f"reduced config replicated run (k_max {K_MAX}) on the card "
          f"(replica kernel) vs the CPU (plain scan), same weights: "
          f"{len(cpu.swaps)} swap(s) {ev(cpu)} equal, {cp.n_replicated} "
          f"replicated rows, replicated tables and reads equal, scores max "
          f"abs err {err} (rtol 1e-5/atol 1e-6)")
    return dict(score_err=s_err, logit_err=l_err,
                logit_range=[lg_1.min().item(), lg_1.max().item()],
                reduced_score_err=err, reduced_swaps=ev(cpu),
                traffic_reads=want.tolist(), saturated_scores=n_sat)


def replicated_breakdown(dev, spec, res):
    """Device time of the replicated serve step and of its stages (CUDA
    events, L2 flushed): the failover maps, the lookup (maps included),
    the degraded counts, the traffic counters, the MLPs and the
    interaction; the host's per-batch times from the run and the swaps'
    host costs."""
    import torch
    from repro_torch.core.embedding import (_replica_failover_maps,
                                            degraded_row_counts,
                                            replicated_embedding_bag)
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_interaction)
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import replicated_bank_read_counts
    from repro_torch.serve.serve_step import (
        build_recsys_serve_replicated_adaptive)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    _, rt = res.runtime.replicated
    b = res.last_batch
    params = {**res.params, "emb_packed": res.runtime.table.packed}
    off = res.statics["field_offsets"]
    live = torch.ones(rt.n_banks, dtype=torch.bool, device=dev)
    rows = torch.where(b["sparse"] >= 0, b["sparse"] + off[None, :, None], -1)
    serve = build_recsys_serve_replicated_adaptive(dlrm, spec.config,
                                                   res.statics,
                                                   with_traffic=True)
    with torch.inference_mode():
        x = dlrm.mlp_apply(params["bot"], b["dense"])
        emb = replicated_embedding_bag(rt, b["sparse"], field_offsets=off,
                                       bank_live=live).contiguous()
        z = torch.cat([x[:, None], emb], dim=1)
        feat = dot_features(x, emb)
        parts = {
            "serve_step": lambda: serve(params, rt, live, b),
            "failover_maps": lambda: _replica_failover_maps(rt, live),
            "lookup": lambda: replicated_embedding_bag(
                rt, b["sparse"], field_offsets=off, bank_live=live),
            "degraded_counts": lambda: degraded_row_counts(
                rt.remap_bank, live, rows),
            "traffic_counters": lambda: replicated_bank_read_counts(
                rt.remap_bank, rows, rt.n_banks, k_max=rt.k_max,
                bank_live=live),
            "bottom_mlp": lambda: dlrm.mlp_apply(params["bot"], b["dense"]),
            "dot_features": lambda: dot_features(x, emb),
            "dot_interaction": lambda: dot_interaction(z),
            "top_mlp": lambda: dlrm.mlp_apply(params["top"], feat),
        }
        out = {k: time_ms(fn, flush=scratch.zero_) for k, fn in parts.items()}
        prof = profile_device(lambda: serve(params, rt, live, b), n=5)
    print("replicated serve step (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per replicated serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "serve", "end_batch")}
    host["telemetry_share_of_next_batch"] = sum(h["observe"]) / sum(
        h["next_batch"])
    print("one replicated batch of 64 on the host (median over the run, "
          "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("next_batch", "observe", "serve", "end_batch"):
        print(f"  per batch, {k} ms: "
              + ", ".join(f"{x:.3f}" for x in h[k]))
    print("  per swap, host ms: " + "; ".join(
        f"batch {e.batch}: base replan {a:.1f}, replica plan {b_:.1f}, "
        f"migrate {m:.1f}, migrate_replicated {mr:.1f}, swap checks {c:.1f}"
        for e, a, b_, m, mr, c in zip(
            res.swaps, h["replan"], h["replica_plan"], h["migrate"],
            h["migrate_replicated"], h["check_swap"])))
    return {**out, **host}


def csr_requests(cfg, n):
    """Phase 8's stream: ``n`` requests of one ragged bag a field, field f
    drawn from ``DriftingZipfTrace`` with the reference launcher's stream
    settings (its rows, Zipf 1.05, bags of ``multi_hot`` on average, drift
    off, seed f); bags keep their Poisson lengths, each id is offset by its
    field's base into a super-table row, bags in request-major order (bag
    r * F + f). -> (indices (T,), offsets (n * F,) bag starts), int32."""
    import numpy as np
    from repro_torch.workload.trace import DriftConfig, DriftingZipfTrace
    base = np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]])
    per_field = [DriftingZipfTrace(DriftConfig(
        n_items=v, zipf_a=1.05, avg_bag=float(cfg.multi_hot),
        rotate_every=0, rotate_frac=0.25), seed=f).bags(n)
        for f, v in enumerate(cfg.vocab_sizes)]
    bags = [per_field[f][r] + base[f] for r in range(n)
            for f in range(cfg.n_sparse)]
    lens = np.array([len(b) for b in bags])
    return (np.concatenate(bags).astype(np.int32),
            np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32))


def csr_rect(indices, offsets):
    """A CSR stream (numpy) as its bags padded with -1 to the longest:
    (NB, L_max) int32."""
    import numpy as np
    lens = np.diff(np.append(offsets, indices.shape[0]))
    rect = np.full((offsets.shape[0], max(int(lens.max()), 1)), -1, np.int32)
    rect[np.repeat(np.arange(offsets.shape[0]), lens),
         np.arange(indices.shape[0]) - np.repeat(offsets, lens)] = indices
    return rect


def csr_small_cases(dev):
    """bf16 tables at ragged D = 33 and at D = 160 (two passes) over phase
    2's small 4-bank plans with the flat remap: a CSR stream of 37 bags with
    an empty bag in the middle and two trailing, and 10% holes."""
    import numpy as np
    import torch
    srng = np.random.default_rng(21)
    out = []
    for c in small_cases(dev, cases=(("bfloat16", 33, 37, 8, 3),
                                     ("bfloat16", 160, 37, 8, 3))):
        lens = srng.integers(0, 60, 37)
        lens[[5, 35, 36]] = 0
        ids = srng.integers(0, c["bank"].shape[0], int(lens.sum()))
        ids[srng.random(ids.shape) < 0.1] = -1
        offs = np.concatenate([[0], np.cumsum(lens)])
        out.append(dict(
            name=f"bf16 D={c['table'].shape[1]} NB=37 T={ids.size}",
            table=c["table"], bank=c["bank"], slot=c["slot"],
            idx=torch.from_numpy(ids.astype(np.int32)).to(dev),
            offs=torch.from_numpy(offs.astype(np.int32)).to(dev),
            rect=torch.from_numpy(csr_rect(ids, offs[:-1])).to(dev)))
    return out


CSR_LENS = (0, 1, 255, 256, 257, 1000, 5000)    # adversarial bag lengths


def csr_adversarial_cases(dev):
    """Tables and ragged streams against the CSR kernel's resolve-once ring:
    every D of ``BAG_DIMS`` in fp32 and bf16 (16-, 4- and 2-byte copies;
    one to three column passes) over bags of every length of ``CSR_LENS``
    up to 1,000 (empty, one entry, around a 256-row ring, past a 512-entry
    round) in shuffled order, with 10% holes, an all-hole bag and two
    trailing empty bags; then the 5,000-entry bags too (ten rounds; in two
    cases only, since the plain version takes a step per entry of the
    longest bag), offsets outside [0, T] (below 0, past T, decreasing),
    T = 0, a table whose base is 4 bytes off 16-byte alignment, and 4,301
    short bags (two a block). Each case carries a table of 4 x 2,400 rows
    with 8-bank remaps of 2,400 ids."""
    import numpy as np
    import torch
    rng = np.random.default_rng(31)
    V, R = 2400, 9600
    shapes = [(dtype, D, "") for dtype in ("float32", "bfloat16")
              for D in BAG_DIMS]
    shapes += [("float32", 32, "5,000-entry bags"),
               ("bfloat16", 9, "5,000-entry bags"),
               ("float32", 32, "offsets outside [0, T]"),
               ("float32", 32, "T = 0"),
               ("float32", 32, "base 4 B off alignment"),
               ("float32", 33, "4301 short bags")]
    out = []
    for dtype, D, note in shapes:
        tab = torch.from_numpy(rng.standard_normal((R * D + 1,))
                               .astype(np.float32)).to(dev)
        tab = tab.to(getattr(torch, dtype))
        table = tab[1:].view(R, D) if note.startswith("base") \
            else tab[:R * D].view(R, D)
        if note == "T = 0":
            lens = np.zeros(9, np.int64)
        elif note == "4301 short bags":
            lens = rng.integers(0, 66, 4301)
        else:
            lens = CSR_LENS if note.startswith("5,000") else CSR_LENS[:-1]
            lens = np.concatenate([rng.permutation(lens * 2), [3, 0, 0]])
        T = int(lens.sum())
        ids = rng.integers(0, V, T)
        ids[rng.random(T) < 0.1] = -1                   # holes
        offs = np.concatenate([[0], np.cumsum(lens)])
        if note != "T = 0":
            ids[offs[-4]:offs[-3]] = -1                 # an all-hole bag
        if note.startswith("offsets"):
            offs[[1, 4, 7]] = (-7, T + 40, offs[3] - 5)
        out.append(dict(
            name=f"{dtype} D={D} NB={lens.size} T={T}"
                 + (f" ({note})" if note else ""),
            table=table,
            idx=torch.from_numpy(ids.astype(np.int32)).to(dev),
            offs=torch.from_numpy(offs.astype(np.int32)).to(dev),
            bank=torch.from_numpy(rng.integers(0, 8, V).astype(np.int32)
                                  ).to(dev),
            slot=torch.from_numpy(rng.integers(0, R, V).astype(np.int32)
                                  ).to(dev)))
    return out


def check_csr_adversarial(dev, errs):
    """The CSR kernel against its plain version, bit for bit, on
    ``csr_adversarial_cases``: my = -1, my = 3 on the 8-bank map, and my =
    0 on a live map (bank 5 dead)."""
    import torch
    from repro_torch.kernels.embedding_bag import csr_bag, csr_bag_plain
    n = 0
    for c in csr_adversarial_cases(dev):
        live = (c["bank"] != 5).to(torch.int32) ^ 1    # 0 where live
        for my, bk in ((-1, c["bank"]), (3, c["bank"]), (0, live)):
            a = (c["table"], bk, c["slot"], my, c["idx"], c["offs"])
            got, want = csr_bag(*a), csr_bag_plain(*a)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item() \
                if got.numel() else 0.0
            need(got.dtype == want.dtype and torch.equal(got, want),
                 f"csr_bag {c['name']} my={my}: kernel != plain (max abs "
                 f"err {err})")
            errs.append(err)
            n += 1
    print(f"  csr_bag adversarial cases: {n} calls (D {BAG_DIMS}, bag "
          f"lengths {CSR_LENS}, offsets outside [0, T], T = 0) == plain")


def csr_phase(dev, spec, plan, report):
    """Phase 8: ragged CSR lookups, forward and backward, and the
    identity-layout drop-ins, at full width. The super-table packed with
    phase 2's plan (seeded weights); 64 requests x 8 fields of ragged
    bags. ``csr_embedding_bag`` forward and backward, then
    ``kernels.ops.embedding_bag_trainable`` forward and backward on the
    same bags padded and resolved, each run with every launch counter set
    to 0 just before and read just after. Then the checks and timings."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.core.embedding import (_binary_live_map,
                                            csr_embedding_bag, init_banked)
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ops as kops
    from repro_torch.sparse.ops import offsets_to_segment_ids
    cfg = spec.config
    D = cfg.embed_dim
    t0 = time.perf_counter()
    t = init_banked(plan, D, generator=torch.Generator(device=dev)
                    .manual_seed(8), device=dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indices, offsets = csr_requests(cfg, CSR_REQUESTS)
    draw_s = time.perf_counter() - t0
    NB, T, R = offsets.shape[0], indices.shape[0], t.packed.shape[0]
    lens = np.diff(np.append(offsets, T))
    print(f"csr: table {tuple(t.packed.shape)} {t.packed.dtype} "
          f"({table_s:.3f} s); {CSR_REQUESTS} requests, {NB} bags, {T} "
          f"entries (bag lengths {lens.min()}..{lens.max()}, mean "
          f"{lens.mean():.2f}), drawn in {draw_s:.3f} s")
    idx = torch.from_numpy(indices).to(dev)
    off = torch.from_numpy(offsets).to(dev)
    offs_ext = torch.cat([off, torch.full((1,), T, dtype=torch.int32,
                                          device=dev)])
    seg = offsets_to_segment_ids(off, T)
    cot = torch.randn((NB, D), generator=torch.Generator(device=dev)
                      .manual_seed(19), device=dev)
    packed = t.packed.detach().requires_grad_(True)
    tg = dataclasses.replace(t, packed=packed)
    counters = {"csr_bag": kbag.csr_bag, "ct_scatter_bag": kbag.ct_scatter_bag,
                "banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "tiered_bag": kbag.tiered_bag, "plain_bag": kbag.plain_bag,
                "plain_cache_bag": kbag.plain_cache_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    x7 = torch.randn((CSR_REQUESTS, D), generator=torch.Generator(device=dev)
                     .manual_seed(23), device=dev)

    # the main path: the CSR lookup forward and backward
    for fn in counters.values():
        fn.launches = 0
    h0 = time.perf_counter()
    out = csr_embedding_bag(tg, idx, off, NB)
    (grad,) = torch.autograd.grad(out, [packed], cot)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"csr_embedding_bag forward + backward: {host_ms:.3f} ms host, "
          f"launches {launches}")
    for name, n in launches.items():
        if name in ("csr_bag", "ct_scatter_bag"):
            need(n > 0, f"the CSR run launched no {name} kernel")
        else:
            need(n == 0, f"the CSR run launched {name} {n} times")
    out = out.detach()
    need(tuple(out.shape) == (NB, D) and bool(torch.isfinite(out).all()),
         f"CSR sums {tuple(out.shape)}, finite {torch.isfinite(out).all()}")

    # the drop-ins' path: the same bags padded and resolved, through
    # kernels.ops.embedding_bag_trainable forward and backward, and each
    # request's 8 bag sums behind a dense row through
    # kernels.ops.dot_interaction
    rect = torch.from_numpy(csr_rect(indices, offsets)).to(dev)
    resolved = resolve_ids(rect, t.remap_flat)
    for fn in counters.values():
        fn.launches = 0
    out7 = kops.embedding_bag_trainable(packed, resolved)
    (grad7,) = torch.autograd.grad(out7, [packed], cot)
    z7 = torch.cat([x7[:, None], out7.detach().view(CSR_REQUESTS, -1, D)],
                   dim=1)
    inter7 = kops.dot_interaction(z7)
    torch.cuda.synchronize()
    d_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"kernels.ops.embedding_bag_trainable forward + backward on the "
          f"bags padded to {tuple(rect.shape)} and resolved, then "
          f"kernels.ops.dot_interaction on {tuple(z7.shape)}: launches "
          f"{d_launches}")
    for name, n in d_launches.items():
        if name in ("plain_bag", "ct_scatter_bag", "dot_interaction"):
            need(n > 0, f"the drop-in run launched no {name} kernel")
        else:
            need(n == 0, f"the drop-in run launched {name} {n} times")
    need(torch.allclose(inter7, kdot.dot_interaction_plain(z7), **DOT_TOL),
         "kernels.ops.dot_interaction != its plain version")
    out7 = out7.detach()

    # sums: CSR == the rectangle through banked_bag == kernel 7 resolved
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    rect_sum = kbag.banked_bag(t.packed, t.remap_bank, t.remap_flat, zero, -1,
                               rect)
    plain7 = kbag.plain_bag_plain(t.packed, resolved)
    torch.cuda.synchronize()
    need(torch.equal(out, rect_sum),
         "CSR sums != banked_bag on the bags padded with -1")
    need(torch.equal(out7, rect_sum),
         "plain_bag on resolved ids != banked_bag on the raw ids")
    need(torch.equal(out7, plain7), "plain_bag != its plain version")
    errs7 = [(out7 - plain7).abs().max().item()]
    print("  CSR sums == banked_bag on the padded bags == plain_bag on the "
          "resolved ids == plain_bag's plain version, bit for bit")
    del rect_sum, plain7
    for c in csr_small_cases(dev):
        ids_c = resolve_ids(c["rect"], c["slot"])
        k = kbag.plain_bag(c["table"], ids_c)
        pl = kbag.plain_bag_plain(c["table"], ids_c)
        torch.cuda.synchronize()
        need(k.dtype == c["table"].dtype and torch.equal(k, pl),
             f"plain_bag {c['name']}: kernel != plain")
        errs7.append((k.float() - pl.float()).abs().max().item())
        print(f"  plain_bag {c['name']} padded and resolved: == plain")

    # kernel 5 against its plain version
    errs5 = []

    def same(name, table, bank, slot, my, ids, oe):
        got = kbag.csr_bag(table, bank, slot, my, ids, oe)
        want = kbag.csr_bag_plain(table, bank, slot, my, ids, oe)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype
             == table.dtype, f"csr_bag {name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        need(torch.equal(got, want),
             f"csr_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"csr_bag {name}: non-finite")
        errs5.append(err)
        print(f"  csr_bag {name}: {tuple(got.shape)} {got.dtype} == plain "
              f"(max abs err {err})")

    g = torch.Generator(device=dev).manual_seed(23)
    idx_h = idx.clone()
    idx_h[torch.rand(idx.shape, generator=g, device=dev) < 0.05] = -1
    live = torch.ones(t.n_banks, dtype=torch.bool, device=dev)
    live[5] = False
    print("csr_bag vs plain, bit for bit:")
    same("served stream, my=-1 flat remap", t.packed, t.remap_bank,
         t.remap_flat, -1, idx, offs_ext)
    same("served stream + 5% holes, my=3 bank map", t.packed, t.remap_bank,
         t.remap_flat, 3, idx_h, offs_ext)
    same("served stream + 5% holes, bank 5 dead (binary live map, my=0)",
         t.packed, _binary_live_map(t.remap_bank, live), t.remap_flat, 0,
         idx_h, offs_ext)
    for c in csr_small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["table"], c["bank"], c["slot"], my,
                 c["idx"], c["offs"])
    check_csr_adversarial(dev, errs5)

    # gradients
    g_plain = kbag.ct_scatter_csr_plain(cot, idx, seg, t.remap_bank,
                                        t.remap_flat, -1, R)
    need(torch.equal(grad, g_plain),
         "CSR gradient (ct_scatter.cu on the CSR prep) != plain scatter")
    rows = int((grad != 0).any(1).sum())
    need(rows > 0, "CSR gradient: all zero")
    del g_plain
    g_rect = kbag.ct_scatter_bag(cot, rect, t.remap_bank, t.remap_flat, zero,
                                 -1, R)
    g_abs = kbag.ct_scatter_csr_plain(cot.abs(), idx, seg, t.remap_bank,
                                      t.remap_flat, -1, R)
    # the rectangular prep adds j-major, the CSR prep in stream order: an
    # fp32 reordering, held to 1e-5 of each sum's magnitudes
    rel = ((grad - g_rect).abs() / g_abs.clamp(min=1e-30)).max().item()
    need(rel <= 1e-5, f"CSR gradient vs the rectangular path's: {rel} of "
                      f"the summed magnitudes")
    del g_rect, g_abs
    need(torch.equal(grad7, kbag.ct_scatter_identity_plain(cot, resolved, R)),
         "embedding_bag_trainable gradient (the kernel) != plain version")
    # bags sit in the stream in order, so bag-major is stream order
    need(torch.equal(grad7, grad),
         "identity-layout gradient != CSR gradient")
    print(f"  CSR gradient ({rows} rows non-zero) == plain scatter on the CSR "
          f"prep; vs the rectangular path within {rel:.3g} of the summed "
          f"magnitudes; embedding_bag_trainable's == its plain version == "
          f"the CSR gradient, bit for bit")
    del grad, grad7

    # the CSR prep under ownership, dead banks, dtype mixes and small tables:
    # ct_scatter.cu == its plain version, bit for bit
    def same_csr(name, ct, ids, sg, bank, slot, my, n_rows, out_dtype=None):
        got = kbag.ct_scatter_csr(ct, ids, sg, bank, slot, my, n_rows,
                                  out_dtype)
        want = kbag.ct_scatter_csr_plain(ct, ids, sg, bank, slot, my, n_rows,
                                         out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        need(torch.equal(got, want),
             f"CSR scatter {name}: kernel != plain (max abs err {err})")
        errs3.append(err)
        print(f"  CSR scatter {name}: {got.dtype} == plain")

    errs3 = []
    print("ct_scatter.cu on the CSR prep vs plain, bit for bit:")
    same_csr("served stream + 5% holes, my=3 bank map", cot, idx_h, seg,
             t.remap_bank, t.remap_flat, 3, R)
    same_csr("served stream + 5% holes, bank 5 dead (binary live map, my=0)",
             cot, idx_h, seg, _binary_live_map(t.remap_bank, live),
             t.remap_flat, 0, R)
    same_csr("served stream, bf16 ct -> fp32 table", cot.bfloat16(), idx,
             seg, t.remap_bank, t.remap_flat, -1, R, torch.float32)
    same_csr("served stream, fp32 ct -> bf16 table", cot, idx, seg,
             t.remap_bank, t.remap_flat, -1, R, torch.bfloat16)
    for c in csr_small_cases(dev):
        nb_c = c["offs"].shape[0] - 1
        sg_c = offsets_to_segment_ids(c["offs"][:-1], c["idx"].shape[0])
        ct_c = torch.randn((nb_c, c["table"].shape[1]), generator=g,
                           device=dev).to(c["table"].dtype)
        for my in (-1, 1):
            same_csr(f"{c['name']} my={my}", ct_c, c["idx"], sg_c, c["bank"],
                     c["slot"], my, c["table"].shape[0])

    # timings at the served shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fl = scratch.zero_
    args5 = (t.packed, t.remap_bank, t.remap_flat, -1, idx, offs_ext)
    need(bool((idx >= 0).all()), "the served stream holds a hole")
    lib_ids = t.remap_flat[idx.long()].long()
    lib5 = lambda: tnf.embedding_bag(lib_ids, t.packed, off.long(),  # noqa: E731
                                     mode="sum")
    need(torch.allclose(lib5(), out, **EMB_TOL),
         "embedding_bag library call disagrees with csr_bag")
    ms5 = time_ms(lambda: kbag.csr_bag(*args5), flush=fl)
    plain5 = time_ms(lambda: kbag.csr_bag_plain(*args5), reps=5, flush=fl)
    lib5_ms = time_ms(lib5, flush=fl)
    b5, by5 = csr_bound_ms(idx, NB, D, t.packed.element_size(),
                           slot=t.remap_flat)
    print(f"csr_bag at NB={NB} T={T} D={D} fp32: kernel {ms5:.4f} ms, plain "
          f"{plain5:.4f} ms, F.embedding_bag {lib5_ms:.4f} ms, bound "
          f"{b5:.6f} ms ({by5})")
    report["csr_bag"] = dict(
        name="csr_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/csr_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:424",
        max_abs_err=max(errs5), ms=ms5, plain_ms=plain5, bound_ms=b5,
        bound_by=by5, library_ms=lib5_ms)

    valid = resolved >= 0
    ids7 = resolved[valid].long()
    off7 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      valid.sum(1).cumsum(0)[:-1]])
    lib7 = lambda: tnf.embedding_bag(ids7, t.packed, off7,  # noqa: E731
                                     mode="sum")
    need(torch.allclose(lib7(), out7, **EMB_TOL),
         "embedding_bag library call disagrees with plain_bag")
    ms7 = time_ms(lambda: kbag.plain_bag(t.packed, resolved), flush=fl)
    plain7_ms = time_ms(lambda: kbag.plain_bag_plain(t.packed, resolved),
                        reps=5, flush=fl)
    lib7_ms = time_ms(lib7, flush=fl)
    b7, by7 = bag_bound_ms(resolved, zero, 1, D, t.packed.element_size(),
                           remap=False)
    # the same bags through banked_bag on the raw ids: the rectangle's cost
    # beside the CSR walk's, on one stream
    rect_ms = time_ms(lambda: kbag.banked_bag(t.packed, t.remap_bank,
                                              t.remap_flat, zero, -1, rect),
                      flush=fl)
    print(f"plain_bag at NB={NB} L={rect.shape[1]} D={D} fp32 ({T} valid "
          f"entries): kernel {ms7:.4f} ms, plain {plain7_ms:.4f} ms, "
          f"F.embedding_bag {lib7_ms:.4f} ms, bound {b7:.6f} ms ({by7}); "
          f"banked_bag on the padded raw ids {rect_ms:.4f} ms")
    report["plain_bag"] = dict(
        name="plain_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/banked_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:203",
        max_abs_err=max(errs7), ms=ms7, plain_ms=plain7_ms, bound_ms=b7,
        bound_by=by7, library_ms=lib7_ms)

    runs = kbag.csr_scatter_prep(idx, seg, t.remap_bank, t.remap_flat, -1, R)
    out_k = torch.zeros((R, D), device=dev)
    ms_s = time_ms(lambda: kbag.ct_scatter_launch(cot, runs, out_k), flush=fl)
    out_p = torch.zeros((R, D), device=dev)
    plain_s = time_ms(lambda: kbag.ct_scatter_runs_plain(cot, runs, out_p),
                      reps=5, flush=fl)
    need(torch.equal(out_k, out_p), "timed CSR scatter != timed plain")
    del out_p
    dest = kbag.dest_slots(idx.long(), idx >= 0, t.remap_bank, t.remap_flat,
                           -1, R)
    keep = dest < R
    lib_dest, lib_bag = dest[keep].long(), seg[keep].long()
    lib_out = torch.zeros((R, D), device=dev)
    lib_s = lambda: lib_out.index_add_(0, lib_dest, cot[lib_bag])  # noqa: E731
    lib_s()
    # index_add_ adds a slot's cotangents in no fixed order: an fp32
    # reordering of sums up to a head row's thousands of entries, held to
    # 1e-5 of each sum's magnitudes
    mag = torch.zeros((R, D), device=dev).index_add_(0, lib_dest,
                                                      cot[lib_bag].abs())
    lib_rel = ((lib_out - out_k).abs() / mag.clamp(min=1e-30)).max().item()
    need(lib_rel <= 1e-5, f"index_add_ library call vs the CSR scatter: "
                          f"{lib_rel} of the summed magnitudes")
    del mag
    lib_s_ms = time_ms(lib_s, flush=fl)
    del lib_out, out_k
    bs, bys = scatter_bound_ms(runs, NB, D, 4)
    n_run, n_live, longest = run_lengths(runs)
    fb_ms = time_ms(lambda: torch.autograd.grad(
        csr_embedding_bag(tg, idx, off, NB), [packed], cot), reps=5, flush=fl)
    print(f"CSR scatter (ct_scatter.cu on the CSR prep; {n_live} entries, "
          f"{n_run} runs, longest {longest}): kernel {ms_s:.4f} ms, plain "
          f"{plain_s:.4f} ms, index_add_ {lib_s_ms:.4f} ms, bound {bs:.6f} ms "
          f"({bys}); csr_embedding_bag forward + backward {fb_ms:.4f} ms on "
          f"the device")
    if "ct_scatter_bag" in report:
        report["ct_scatter_bag"]["max_abs_err"] = max(
            [report["ct_scatter_bag"]["max_abs_err"], *errs3])
    section = dict(
        requests=CSR_REQUESTS, bags=NB, entries=T,
        bag_len_min=int(lens.min()), bag_len_max=int(lens.max()),
        bag_len_mean=float(lens.mean()), table_s=table_s, draw_s=draw_s,
        fwd_bwd_host_ms=host_ms, fwd_bwd_ms=fb_ms, launches=launches,
        drop_in_launches=d_launches, grad_rows=rows,
        grad_vs_rect_rel=rel,
        csr_bag=dict(kernel_ms=ms5, plain_ms=plain5, library_ms=lib5_ms,
                     bound_ms=b5, banked_bag_rect_ms=rect_ms),
        plain_bag=dict(kernel_ms=ms7, plain_ms=plain7_ms, library_ms=lib7_ms,
                       bound_ms=b7),
        scatter=dict(kernel_ms=ms_s, plain_ms=plain_s, library_ms=lib_s_ms,
                     bound_ms=bs, runs=n_run, live_entries=n_live,
                     longest_run=longest, library_rel_err=lib_rel))
    return section, launches, d_launches


def cached_adaptive_main_path(dev, spec):
    """Phase 9's main path: ``run_cached_adaptive`` at full width (the
    adaptive cache lane), with every launch counter set to 0 just before
    and read just after. ``min_swaps=1`` makes the run itself raise unless
    a swap took place, the shapes stayed stable, and the first swap's EMT
    and cache table (packed, ``remap_bank``, ``remap_slot``) and its output
    equal a fresh build, checked on the card."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_cached_adaptive
    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "tiered_bag": kbag.tiered_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    for fn in counters.values():
        fn.launches = 0
    res = run_cached_adaptive(spec, spec.config,
                              requests=CACHED_ADAPTIVE_REQUESTS, batch=64,
                              replan_every=CACHED_ADAPTIVE_REPLAN,
                              min_swaps=1, device=dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"serve_cached_adaptive: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("cache_residual_bag", "dot_features"):
        need(launches[name] > 0, f"the cache lane launched no {name} kernel")
    for name in ("banked_bag", "ct_scatter_bag", "tiered_bag",
                 "dot_interaction"):
        need(launches[name] == 0, f"the cache lane launched {name} "
                                  f"{launches[name]} times")
    need(res.checks == {"shapes_stable": True, "arrays_ok": True,
                        "outputs_ok": True},
         f"cache lane swap checks {res.checks}")
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] imbalance {e.old_imbalance:.6f} -> "
              f"{e.new_imbalance:.6f}; cache v{e.cache_version}, "
              f"{e.cache_entries} entries ({e.cache_dropped} dropped); "
              f"{e.update.report}")
    print(f"  swap parity on the card (first swap, version "
          f"{res.swap_probe['version']}): EMT and cache table == fresh build,"
          f" scores through the swapped-in table == through the fresh one; "
          f"shapes stable {res.checks['shapes_stable']}")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
    return res, launches


def check_cached_adaptive_kernel(dev, res):
    """The fused kernel vs its plain version, bit for bit, on the post-swap
    EMT: the batch in flight across the last swap with the RETIRED version's
    cache table it was rewritten for, and the same bags rewritten under the
    new version with the new table; then its time at the lane's shape."""
    import torch
    from repro_torch.kernels.embedding_bag import (cache_residual_bag,
                                                   cache_residual_bag_plain)
    rt, e = res.runtime, res.swaps[-1]
    i = e.batch - 1                          # the batch in flight
    ci, ri, v = res.rewritten[i]
    need(v == e.cache_version - 1,
         f"the batch in flight was rewritten under v{v}, the swap installed "
         f"v{e.cache_version}")
    rb = rt.rewriter.rewrite_rect(res.unions[i])
    t = rt.table
    cases = (("in flight, retired version", rt.cache_table_for(v), ci, ri, v),
             ("rewritten after the swap", rt.cache_table, rb.cache_idx,
              rb.residual_idx, rb.version))
    out = {}
    for name, ct, c_np, r_np, ver in cases:
        c = torch.from_numpy(c_np.reshape(-1, c_np.shape[-1])).to(dev)
        r = torch.from_numpy(r_np.reshape(-1, r_np.shape[-1])).to(dev)
        args = (t.packed, ct.packed, t.remap_bank, t.remap_flat,
                ct.remap_bank, ct.remap_flat, -1, c.contiguous(),
                r.contiguous())
        got, want = cache_residual_bag(*args), cache_residual_bag_plain(*args)
        torch.cuda.synchronize()
        need(torch.equal(got, want), f"cache_residual_bag on the cache lane, "
                                     f"{name}: kernel != plain")
        n_c = int((c >= 0).sum())
        print(f"  cache_residual_bag, {name} (v{ver}, {n_c} cache + "
              f"{int((r >= 0).sum())} residual entries): == plain")
        out[name] = (args, n_c, int((r >= 0).sum()))
    args, n_c, n_r = out["rewritten after the swap"]
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: cache_residual_bag(*args), flush=scratch.zero_)
    bound, by = cache_bag_bound_ms(args[7], args[8], t.dim,
                                   t.packed.element_size())
    print(f"cache_residual_bag at the cache lane's shape (NB="
          f"{args[7].shape[0]}, Lc={args[7].shape[1]}, Lr={args[8].shape[1]};"
          f" {n_c} cache + {n_r} residual entries): kernel {ms:.4f} ms, "
          f"bound {bound:.6f} ms ({by})")
    return dict(kernel_ms=ms, bound_ms=bound, bound_by=by, cache_entries=n_c,
                residual_entries=n_r, in_flight_version=v,
                new_version=rb.version)


def check_cached_adaptive_outputs(dev, spec, res):
    """Scores finite, in (0, 1); the last batch's reads equal their host
    twin; the last batch re-scored with the plain versions within rtol
    1e-5 / atol 1e-6; the reduced config's cache lane on the card equals
    the CPU's swap for swap (same weights): the same swap events, rewritten
    ids and versions, reads, cache tables, scores within rtol 1e-5 / atol
    1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.serve import run_cached_adaptive
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import host_cached_bank_read_counts
    from repro_torch.serve.serve_step import build_recsys_serve_cached_adaptive
    cfg = spec.config
    need(tuple(res.scores.shape) == (CACHED_ADAPTIVE_REQUESTS,),
         f"cache lane scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite lane scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "cache lane scores outside (0, 1)")
    rt, b = res.runtime, res.last_batch
    ci, ri, v = res.rewritten[-1]
    want = host_cached_bank_read_counts(rt.rewriter.plan_for(v).entry_bank,
                                        ci, rt.plan.bank_of_row, ri,
                                        rt.table.n_banks)
    need(np.array_equal(res.reads[-1], want),
         f"cached traffic counters: card {res.reads[-1]} != host {want}")
    t, ct = rt.table, rt.cache_table_for(v)
    params = {**res.params, "emb_packed": t.packed}
    s_k = build_recsys_serve_cached_adaptive(dlrm, cfg, res.statics)(
        params, t.remap_bank, t.remap_slot, ct, b, remap_flat=t.remap_flat)
    s_p = build_recsys_serve_cached_adaptive(
        dlrm, cfg, res.statics, backend="torch")(
        params, t.remap_bank, t.remap_slot, ct, b, remap_flat=t.remap_flat)
    n = (CACHED_ADAPTIVE_REQUESTS - 1) % 64 + 1
    need(torch.equal(s_k[:n], res.scores[-n:]),
         "the last batch re-served != the run's scores")
    s_err = (s_k - s_p).abs().max().item()
    need(torch.allclose(s_k, s_p, **SCORE_TOL),
         f"cache lane serve step, kernels vs plain: max abs err {s_err}")
    print(f"cache lane outputs: finite, in (0, 1); last batch reads == host "
          f"twin {want.tolist()}; re-scored with the plain versions: max abs "
          f"err {s_err} (rtol 1e-5/atol 1e-6)")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(requests=96, batch=8, replan_every=2, drift_rotate_every=24,
              seed=1, min_swaps=1)
    cpu = run_cached_adaptive(spec, red, device="cpu", params=p0, **kw)
    card = run_cached_adaptive(spec, red, device=dev,
                               params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.old_imbalance, e.new_imbalance,  # noqa: E731
                     e.cache_version, e.cache_entries, e.cache_dropped)
                    for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) >= 1,
         f"reduced cache lane: swaps card {ev(card)} != CPU {ev(cpu)}")
    need(len(card.rewritten) == len(cpu.rewritten)
         and all(np.array_equal(a[0], x[0]) and np.array_equal(a[1], x[1])
                 and a[2] == x[2]
                 for a, x in zip(card.rewritten, cpu.rewritten)),
         "reduced cache lane: rewritten ids or versions card != CPU")
    need(all(np.array_equal(x, y) for x, y in zip(card.reads, cpu.reads)),
         "reduced cache lane: per-batch reads card != CPU")
    for f in ("packed", "remap_bank", "remap_slot"):
        need(torch.equal(getattr(card.runtime.cache_table, f).cpu(),
                         getattr(cpu.runtime.cache_table, f)),
             f"reduced cache lane: cache table {f} card != CPU")
    need(torch.equal(card.runtime.table.packed.cpu(),
                     cpu.runtime.table.packed),
         "reduced cache lane: packed EMT card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced cache lane, card vs CPU: max abs err {err}")
    print(f"reduced config cache lane on the card (fused kernel) vs the CPU "
          f"(jnp order), same weights: {len(cpu.swaps)} swap(s) {ev(cpu)} "
          f"equal, rewritten ids, versions, reads, EMT and cache table "
          f"equal, scores max abs err {err} (rtol 1e-5/atol 1e-6)")
    return dict(score_err=s_err, reduced_score_err=err,
                reduced_swaps=ev(cpu), last_reads=want.tolist())


def cached_adaptive_breakdown(dev, spec, res):
    """Device time of the lane's serve step and the interaction's fused
    entry on its inputs (CUDA events, L2 flushed); the host's per-batch
    times (tap, rewrite, serve call) and per-swap times (replan, migration,
    cache install) from the run."""
    import torch
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve_cached_adaptive
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rt, b = res.runtime, res.last_batch
    t, ct = rt.table, rt.cache_table_for(res.rewritten[-1][2])
    params = {**res.params, "emb_packed": t.packed}
    serve = build_recsys_serve_cached_adaptive(dlrm, spec.config, res.statics)

    def step():
        return serve(params, t.remap_bank, t.remap_slot, ct, b,
                     remap_flat=t.remap_flat)
    with torch.inference_mode():
        emb = dlrm.banked_cache_residual_bag(t, ct, b["cache_idx"],
                                             b["residual_idx"])
        x = dlrm.mlp_apply(params["bot"], b["dense"])
        out = {"serve_step": time_ms(step, flush=scratch.zero_),
               "dot_features": time_ms(lambda: kdot.dot_features(x, emb))}
        prof = profile_device(step, n=5)
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "rewrite", "serve",
                      "end_batch")}
    rps = len(res.latencies) / res.serve_s
    print(f"cache lane serve step (device ms, L2 flushed): "
          f"{out['serve_step']:.4f}; dot_features on its inputs "
          f"{out['dot_features']:.4f} ms")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per lane serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    print(f"cache lane: p50 {res.p50_ms:.3f} ms, p99 {res.p99_ms:.3f} ms, "
          f"{rps:.1f} requests/s over {len(res.latencies)} requests "
          f"({res.serve_s:.3f} s serving, swaps included); hit rate on the "
          f"served bags {res.stats['hit_rate']:.6f}")
    print("one cache-lane batch of 64 on the host (median over the run, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("next_batch", "observe", "rewrite", "serve", "end_batch"):
        print(f"  per batch, {k} ms: " + ", ".join(f"{x:.3f}" for x in h[k]))
    print("  per swap, host ms: " + "; ".join(
        f"batch {e.batch}: replan {a:.1f}, migrate {m:.1f}, cache install "
        f"{c:.1f}, swap checks {k:.1f}"
        for e, a, m, c, k in zip(res.swaps, h["replan"], h["migrate"],
                                 h["cache_install"], h["check_swap"])))
    return {**out, **host, "requests_per_s": rps}


def adaptive_train_main_path(dev, spec, partition, steps, replan_every,
                             refresh_every):
    """Phase 10's main path for one partition: ``launch.train.run_adaptive``
    at full width with every launch counter set to 0 just before and read
    just after. Spies on the migration and the refresh: every migration's
    Adagrad state must equal ``migrate_rowwise_state`` of the state before
    it, and every refreshed cache table a fresh build from the current
    rows (all of them gathered on the card), bit for bit."""
    import math
    import time as _time
    import torch
    from repro_torch.core.cache_runtime import build_cache_table_fixed
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch import train as ltrain
    from repro_torch.workload.migrate import migrate_rowwise_state
    from repro_torch.workload.runtime import AdaptiveEmbeddingRuntime
    spy = {"adagrad_moved": 0, "refreshes_checked": 0, "refresh_ms": [],
           "refresh_entries": []}
    real_migrate = ltrain._migrate_state
    real_refresh = AdaptiveEmbeddingRuntime.refresh_cache

    def migrate(state, table, plan, cap):
        old = state.opt_state["true"][0]
        new = real_migrate(state, table, plan, cap)
        want = migrate_rowwise_state(old, table, plan, rows_per_bank=cap)
        need(torch.equal(new.opt_state["true"][0], want),
             f"{partition} train: the migrated Adagrad state != "
             f"migrate_rowwise_state of the old state")
        spy["adagrad_moved"] += 1
        return new

    def refresh(self):
        t0 = _time.perf_counter()
        v = real_refresh(self)
        torch.cuda.synchronize()
        spy["refresh_ms"].append((_time.perf_counter() - t0) * 1e3)
        t = self.table
        fresh = build_cache_table_fixed(t.packed.detach()[t.remap_flat.long()],
                                        self.cache_plan,
                                        device=t.packed.device)
        ct = self.cache_table
        need(all(torch.equal(getattr(ct, f), getattr(fresh, f))
                 for f in ("packed", "remap_bank", "remap_slot")),
             f"refresh v{v}: cache table != fresh build from the current rows")
        spy["refreshes_checked"] += 1
        spy["refresh_entries"].append(self.cache_plan.n_entries)
        return v

    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    ltrain._migrate_state = migrate
    AdaptiveEmbeddingRuntime.refresh_cache = refresh
    try:
        for fn in counters.values():
            fn.launches = 0
        res = ltrain.run_adaptive(spec, spec.config, steps=steps,
                                  batch=TRAIN_BATCH, partition=partition,
                                  replan_every=replan_every,
                                  cache_refresh_every=refresh_every,
                                  device=dev)
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        ltrain._migrate_state = real_migrate
        AdaptiveEmbeddingRuntime.refresh_cache = real_refresh
    print(f"adaptive train, {partition}: {steps} steps at batch "
          f"{TRAIN_BATCH}, launches {launches}")
    lookup = "cache_residual_bag" if partition == "cache_aware" \
        else "banked_bag"
    other = "banked_bag" if partition == "cache_aware" \
        else "cache_residual_bag"
    for name in (lookup, "dot_features"):
        need(launches[name] > 0, f"{partition} train launched no {name}")
    # the cache table takes no gradient: one scatter a step, not two
    need(launches["ct_scatter_bag"] == steps,
         f"{partition} train: {launches['ct_scatter_bag']} scatter launches "
         f"in {steps} steps")
    for name in (other, "dot_interaction"):
        need(launches[name] == 0, f"{partition} train launched {name} "
                                  f"{launches[name]} times")
    need(len(res.migrations) >= 1
         and spy["adagrad_moved"] == len(res.migrations),
         f"{partition} train: {len(res.migrations)} migrations, "
         f"{spy['adagrad_moved']} Adagrad moves checked")
    if partition == "cache_aware":
        need(len(res.refreshes) >= 1
             and spy["refreshes_checked"] == len(res.refreshes),
             f"cached train: refreshes {res.refreshes}, "
             f"{spy['refreshes_checked']} checked")
        # a refresh of version 0's empty plan checks nothing: each checked
        # refresh must re-sum a plan mined at a migration before it
        first = res.migrations[0][0]
        need(all(step > first for step, _ in res.refreshes)
             and all(n > 0 for n in spy["refresh_entries"]),
             f"cached train: refreshes at steps "
             f"{[s for s, _ in res.refreshes]} with entries "
             f"{spy['refresh_entries']}, first migration at step {first}")
    need(len(res.losses) == steps
         and all(math.isfinite(x) for x in res.losses),
         f"{partition} train losses {res.losses}")
    h = res.host_ms
    print("  losses " + ", ".join(f"{x:.6f}" for x in res.losses)
          + "; step ms (host, synchronized) "
          + ", ".join(f"{x:.3f}" for x in res.step_ms)
          + "; batch prep ms (draw, tap, rewrite) "
          + ", ".join(f"{x:.1f}" for x in h["batch"]))
    for (step, u), a, m, s in zip(res.migrations, h["replan"], h["migrate"],
                                  h["swap"]):
        print(f"  [migrate @step {step}] imbalance -> "
              f"{u.plan.imbalance():.6f}; host ms: replan {a:.1f}, migrate "
              f"(params + Adagrad) {m:.1f}, swap {s:.1f}; Adagrad == "
              f"migrate_rowwise_state")
    for (step, v), ms, n in zip(res.refreshes, spy["refresh_ms"],
                                spy["refresh_entries"]):
        print(f"  [cache refresh @step {step}] -> v{v}, {n} entries, "
              f"{ms:.1f} ms; == fresh build from the current rows")
    return res, launches, spy


def cached_train_replay(dev, spec, res):
    """The batch of the first migration's step, re-drawn and rewritten
    under the live cache plan (no telemetry feed): the plan was mined from
    that step's bags, so it hits the cache where the run's later, freshly
    drawn batches of uniform ids rarely do. Returned as the train step's
    batch dict, against the live EMT and the current cache table."""
    import torch
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.workload.telemetry import rows_from_sparse
    cfg = spec.config
    step = res.migrations[0][0]
    host = make_batch_fn(spec, cfg)(TRAIN_BATCH, 0, step)
    rt = res.runtime
    rb = rt.rewriter.rewrite_rect(rows_from_sparse(host["sparse"],
                                                   cfg.field_offsets()))
    hits = int((rb.cache_idx >= 0).sum())
    entries = rt.cache_plan.n_entries
    need(hits > 0, f"cached train: the batch of step {step} rewritten under "
                   f"the live plan ({entries} entries) hits no entry")
    t = rt.table
    b = {"dense": torch.from_numpy(host["dense"]).to(dev),
         "label": torch.from_numpy(host["label"]).to(dev),
         "cache_idx": torch.from_numpy(rb.cache_idx).to(dev),
         "residual_idx": torch.from_numpy(rb.residual_idx).to(dev),
         "remap_bank": t.remap_bank, "remap_slot": t.remap_slot,
         "remap_flat": t.remap_flat,
         "cache_table": rt.cache_table_for(rb.version)}
    n_bags = rb.cache_idx.size // rb.cache_idx.shape[-1]
    print(f"cached train replay: step {step}'s batch under cache "
          f"v{rb.version}: {hits} cache hits in {n_bags} bags, {entries} "
          f"live entries of {rt.cache_plan.capacity}")
    return b, dict(step=step, version=rb.version, cache_hits=hits,
                   entries=entries)


def check_cached_train_grad(dev, spec, res, b=None, what="last batch"):
    """One step of the cached train path at the served shape (``b``, by
    default the run's last batch): the EMT's gradient equals the plain
    scatter of the bag sums' cotangent bit for bit, and the backward
    launches one scatter (the cache table takes none)."""
    import torch
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels.embedding_bag import ct_scatter_bag_plain
    from repro_torch.models import dlrm
    cfg = spec.config
    b = res.last_batch if b is None else b
    st = res.statics
    packed = res.state.params["emb_packed"].detach().requires_grad_(True)
    params = {**res.state.params, "emb_packed": packed}
    caught = {}
    lookup = dlrm.banked_cache_residual_bag

    def hooked(*a, **k):
        out = lookup(*a, **k)
        out.register_hook(lambda g: caught.__setitem__("ct", g))
        return out
    dlrm.banked_cache_residual_bag = hooked
    try:
        logits = dlrm.forward_cached(
            cfg, params, st, b["cache_table"],
            {"dense": b["dense"], "cache_idx": b["cache_idx"],
             "residual_idx": b["residual_idx"]},
            remap_bank=b["remap_bank"], remap_slot=b["remap_slot"],
            remap_flat=b["remap_flat"])
        loss = dlrm.bce_loss(logits, b["label"])
    finally:
        dlrm.banked_cache_residual_bag = lookup
    kbag.ct_scatter_bag.launches = 0
    (g,) = torch.autograd.grad(loss, [packed])
    n_scatter = kbag.ct_scatter_bag.launches
    ri = b["residual_idx"]
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    want = ct_scatter_bag_plain(
        caught["ct"].reshape(-1, cfg.embed_dim).contiguous(),
        ri.reshape(-1, ri.shape[-1]).contiguous(), b["remap_bank"],
        b["remap_flat"], zero, -1, packed.shape[0])
    need(torch.equal(g, want), f"cached train step ({what}): EMT gradient "
                               f"!= plain scatter of the same cotangent")
    need(n_scatter == 1, f"cached train backward ({what}): {n_scatter} "
                         f"scatter launches (the cache table takes none)")
    rows = int((g != 0).any(1).sum())
    hits = int((b["cache_idx"] >= 0).sum())
    print(f"cached train step ({what}, {hits} cache hits): EMT gradient == "
          f"plain scatter of the same cotangent ({rows} rows non-zero), one "
          f"scatter launch")
    return dict(grad_rows=rows, scatter_launches=n_scatter, cache_hits=hits)


def check_adaptive_train_reduced(dev, spec):
    """The reduced config's adaptive training, both partitions, on the card
    and on the CPU from the same weights: the same migrations at the same
    steps with the same plans, the same refreshes, rewritten ids and reads,
    losses within LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.train import run_adaptive
    from repro_torch.models import dlrm
    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(4), plan=plan,
                             rows_per_bank=cap, device="cpu")
    out = {}
    for partition in ("non_uniform", "cache_aware"):
        kw = dict(steps=9, batch=8, replan_every=3, cache_refresh_every=4,
                  seed=2, partition=partition)
        cpu = run_adaptive(spec, red, device="cpu", params=p0, **kw)
        card = run_adaptive(spec, red, device=dev, params=to_dev(p0, dev),
                            **kw)
        mig = lambda r: [(s, u.plan.bank_of_row.tobytes())  # noqa: E731
                         for s, u in r.migrations]
        need(mig(card) == mig(cpu) and len(cpu.migrations) >= 1,
             f"reduced {partition} train: migrations card "
             f"{[s for s, _ in card.migrations]} != CPU "
             f"{[s for s, _ in cpu.migrations]}")
        need(card.refreshes == cpu.refreshes,
             f"reduced {partition} train: refreshes {card.refreshes} != "
             f"{cpu.refreshes}")
        need(all(np.array_equal(a[0], x[0]) and np.array_equal(a[1], x[1])
                 and a[2] == x[2]
                 for a, x in zip(card.rewritten, cpu.rewritten))
             and len(card.rewritten) == len(cpu.rewritten),
             f"reduced {partition} train: rewritten ids card != CPU")
        need(all(np.array_equal(x, y) for x, y in zip(card.reads, cpu.reads)),
             f"reduced {partition} train: reads card != CPU")
        need(np.allclose(card.losses, cpu.losses, rtol=LOSS_RTOL, atol=0),
             f"reduced {partition} train, card vs CPU: losses "
             f"{card.losses} vs {cpu.losses}")
        print(f"reduced config adaptive train ({partition}) on the card vs "
              f"the CPU, same weights: migrations at steps "
              f"{[s for s, _ in cpu.migrations]} with equal plans, refreshes "
              f"{cpu.refreshes}, rewritten ids and reads equal; losses "
              f"{card.losses} vs {cpu.losses}")
        out[partition] = dict(card=card.losses, cpu=cpu.losses,
                              migration_steps=[s for s, _ in cpu.migrations],
                              refreshes=cpu.refreshes)
    return out


def adaptive_train_kernel_times(dev, spec, res_c, res_n, replay):
    """The kernels of phase 10 at its shapes (CUDA events, L2 flushed): the
    fused bag on the cached train batch (held against its plain version
    there and on the replayed batch that hits the cache), the scatter
    kernel on its residual ids and on the §3.2 path's raw ids, the bag
    kernel on the §3.2 path's last batch."""
    import torch
    from repro_torch.kernels import embedding_bag as kbag
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    D = spec.config.embed_dim
    out = {}
    packed = res_c.state.params["emb_packed"]
    entries = res_c.runtime.cache_plan.n_entries

    def fused_args(b):
        ct = b["cache_table"]
        ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1])
        ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1])
        return (packed, ct.packed, b["remap_bank"], b["remap_flat"],
                ct.remap_bank, ct.remap_flat, -1, ci.contiguous(),
                ri.contiguous())
    for what, b in (("last batch", res_c.last_batch), ("replay", replay)):
        args = fused_args(b)
        need(torch.equal(kbag.cache_residual_bag(*args),
                         kbag.cache_residual_bag_plain(*args)),
             f"cache_residual_bag on the cached train {what}: kernel != "
             f"plain")
        print(f"cache_residual_bag == plain on the cached train {what}: "
              f"{int((args[7] >= 0).sum())} cache hits, {entries} live "
              f"entries")
    b = res_c.last_batch
    args = fused_args(b)
    ri = args[8]
    out["cache_residual_bag_ms"] = time_ms(
        lambda: kbag.cache_residual_bag(*args), flush=scratch.zero_)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    ct_c = torch.randn((ri.shape[0], D), generator=g, device=dev)
    R = packed.shape[0]
    for name, idx, bank, slot, off in (
            ("cached", ri, b["remap_bank"], b["remap_flat"], zero),
            ("non_uniform",
             res_n.last_batch["sparse"].reshape(-1, spec.config.multi_hot
                                                ).contiguous(),
             res_n.statics["remap_bank"], res_n.statics["remap_flat"],
             res_n.statics["field_offsets"])):
        runs = kbag.scatter_prep(idx, bank, slot, off, -1, R)
        o = torch.zeros((R, D), device=dev)
        out[f"ct_scatter_{name}_ms"] = time_ms(
            lambda: kbag.ct_scatter_launch(ct_c, runs, o), flush=scratch.zero_)
        need(torch.equal(o, kbag.ct_scatter_runs_plain(
            ct_c, runs, torch.zeros((R, D), device=dev))),
             f"ct_scatter on the {name} train ids: kernel != plain")
        n_run, n_live, longest = run_lengths(runs)
        out[f"ct_scatter_{name}_bound_ms"] = scatter_bound_ms(
            runs, idx.shape[0], D, 4)[0]
        out[f"ct_scatter_{name}_runs"] = [n_run, n_live, longest]
        del o
    sn, st = res_n.last_batch["sparse"], res_n.statics
    idx = sn.reshape(-1, spec.config.multi_hot).contiguous()
    pn = res_n.state.params["emb_packed"]
    bag = (pn, st["remap_bank"], st["remap_flat"], st["field_offsets"], -1,
           idx)
    need(torch.equal(kbag.banked_bag(*bag), kbag.banked_bag_plain(*bag)),
         "banked_bag on the adaptive train batch: kernel != plain")
    out["banked_bag_ms"] = time_ms(lambda: kbag.banked_bag(*bag),
                                   flush=scratch.zero_)
    print("phase 10 kernels at its shapes (ms, L2 flushed): "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def fault_main_path(dev, spec):
    """Phase 11's main path: ``run_fault`` at full width (the fault lane)
    with every launch counter set to 0 just before and read just after.
    ``min_recoveries=1`` and ``min_slo_breaches=1`` make the run itself
    raise unless a recovery happened, confinement held on the degraded
    batch, the first clean batch after the recovery equals the never-failed
    run bit for bit, every swap kept version 0's shapes, and an SLO breach
    reached the replanner."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import SLOConfig, run_fault
    counters = {"banked_bag": (kbag.banked_bag, "launches"),
                "banked_bag_replicated": (kbag.banked_bag,
                                          "replicated_launches"),
                "cache_residual_bag": (kbag.cache_residual_bag, "launches"),
                "ct_scatter_bag": (kbag.ct_scatter_bag, "launches"),
                "tiered_bag": (kbag.tiered_bag, "launches"),
                "csr_bag": (kbag.csr_bag, "launches"),
                "dot_features": (kdot.dot_features, "launches"),
                "dot_interaction": (kdot.dot_interaction, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    res = run_fault(spec, spec.config, requests=FAULT_REQUESTS, batch=64,
                    faults=FAULT_SCHEDULE, replan_every=FAULT_REPLAN,
                    slo=SLOConfig(**FAULT_SLO), min_slo_breaches=1,
                    min_recoveries=1, device=dev)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    print(f"serve_fault: {len(res.latencies)} requests at batch 64, "
          f"schedule {FAULT_SCHEDULE}, launches {launches}")
    for name in ("banked_bag", "dot_features"):
        need(launches[name] > 0, f"the fault lane launched no {name} kernel")
    for name in ("banked_bag_replicated", "cache_residual_bag",
                 "ct_scatter_bag", "tiered_bag", "csr_bag",
                 "dot_interaction"):
        need(launches[name] == 0, f"the fault lane launched {name} "
                                  f"{launches[name]} times")
    for b, e in res.fired:
        print(f"  [fault @batch {b}] {e}")
    for e in res.swaps:
        rec = (f", recovery {e.recovery_s * 1e3:.1f} ms"
               if e.reason == "bank_failure" else "")
        print(f"  [{e.reason} swap, runtime batch clock {e.batch}]{rec} "
              f"imbalance {e.old_imbalance:.6f} -> {e.new_imbalance:.6f}")
    for e in res.slo_events:
        print(f"  [slo breach @batch {e['batch']}] {e['kind']}: "
              f"{e['value']:.1f} > {e['threshold']:.1f}, hot bank "
              f"{e['bank']}, penalty x{e['penalty']:.3f} -> replanner")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
    return res, launches


def check_fault_outputs(dev, spec, res, report):
    """The fault lane's outputs: scores finite in [0, 1]; on every batch the
    served reads plus the degraded reads equal the valid lookups; only the
    failure's batch degraded, its per-request counts equal a host recount
    from the plan it was served under; confinement per bag on it — every
    bag with no dead read equals the never-failed bag sums (all banks live)
    bit for bit, and every bag equals the plain version on the same ids
    with the dead bank's ids set to -1; the bag kernel under the binary
    live map (my = 0) equal to its plain version on the batch; a recovery,
    a straggler replan and an SLO breach fed to the replanner; then the
    reduced config's fault lane on the card against the CPU, event for
    event (the same fired events, degraded counts, reads, swaps with their
    plans, straggler steps, SLO breaches and final table; scores within
    rtol 1e-5 / atol 1e-6)."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import (_binary_live_map,
                                            banked_embedding_bag,
                                            degraded_row_counts)
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.kernels.embedding_bag import banked_bag, banked_bag_plain
    from repro_torch.launch.serve import SLOConfig, run_fault
    from repro_torch.models import dlrm
    cfg = spec.config
    need(tuple(res.scores.shape) == (FAULT_REQUESTS,),
         f"fault lane scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite fault scores")
    need(bool(((res.scores >= 0) & (res.scores <= 1)).all()),
         "fault lane scores outside [0, 1]")
    for i, (r, c, n) in enumerate(zip(res.reads, res.degraded, res.lookups)):
        need(int(r.sum()) + int(c.sum()) == n,
             f"batch {i}: reads {int(r.sum())} + degraded {int(c.sum())} != "
             f"{n} valid lookups")
    fail = res.stats["fail_batch"]
    degraded = [i for i, c in enumerate(res.degraded) if c.sum() > 0]
    need(degraded == [fail], f"degraded batches {degraded}, failure at "
                             f"batch {fail}")
    need(len(res.probes) == 1, f"{len(res.probes)} confinement probes")
    p = res.probes[0]
    t, t0 = p["table"], res.never_failed
    sp, offs = p["feats"]["sparse"], res.statics["field_offsets"]
    B, F, L = sp.shape
    live = torch.from_numpy(p["live"]).to(dev)
    rows = torch.where(sp >= 0, sp + offs[None, :, None], -1)
    rows_np = rows.cpu().numpy()
    dead_np = ~p["live"][p["plan"].bank_of_row[np.maximum(rows_np, 0)]]
    host = ((rows_np >= 0) & dead_np).reshape(B, -1).sum(1)
    need(np.array_equal(host, p["counts"]),
         f"degraded counts: card {p['counts'].tolist()} != host recount "
         f"{host.tolist()}")
    got = banked_embedding_bag(t, sp, field_offsets=offs, bank_live=live)
    ref = banked_embedding_bag(t0, sp, field_offsets=offs)
    per_bag = degraded_row_counts(t.remap_bank, live, rows, per_bag=True)
    clean = per_bag == 0
    need(torch.equal(got[clean], ref[clean]),
         "per-bag confinement: a bag with no dead read != never-failed")
    dead_read = (rows >= 0) & ~live[t.remap_bank[rows.clamp(min=0)].long()]
    masked = torch.where(dead_read, -1, sp).reshape(-1, L).to(torch.int32)
    want = banked_bag_plain(t.packed, t.remap_bank, t.remap_flat, offs, -1,
                            masked.contiguous()).reshape(B, F, -1)
    need(torch.equal(got, want),
         "degraded bag sums != plain version on the ids with dead reads -1")
    # the same ids with their dead reads dropped: every bag is clean, so
    # under the live map every bag must equal the never-failed sums (at
    # full width a bag of 256 Zipf rows almost never misses the dead bank)
    masked3 = masked.reshape(B, F, L)
    need(torch.equal(banked_embedding_bag(t, masked3, field_offsets=offs,
                                          bank_live=live),
                     banked_embedding_bag(t0, masked3, field_offsets=offs)),
         "per-bag confinement on the ids without dead reads: != never-failed")
    lm = _binary_live_map(t.remap_bank, live)
    idx = sp.reshape(-1, L).to(torch.int32).contiguous()
    k = banked_bag(t.packed, lm, t.remap_flat, offs, 0, idx)
    pl = banked_bag_plain(t.packed, lm, t.remap_flat, offs, 0, idx)
    torch.cuda.synchronize()
    need(torch.equal(k, pl), "banked_bag under the binary live map (my=0) "
                             "on the fault batch: kernel != plain")
    report["banked_bag"]["max_abs_err"] = max(
        report["banked_bag"]["max_abs_err"],
        (k - pl).abs().max().item())
    n_clean_req = int((p["counts"] == 0).sum())
    print(f"fault lane outputs: finite, in [0, 1]; reads + degraded == valid "
          f"lookups on all {len(res.reads)} batches; batch {fail} degraded "
          f"({int(p['counts'].sum())} reads, counts == host recount); "
          f"{n_clean_req}/{B} requests and {int(clean.sum())}/{clean.numel()}"
          f" bags clean: clean bags == never-failed bit for bit, every bag =="
          f" plain on ids with dead reads -1, and with those ids all "
          f"{clean.numel()} bags == never-failed; banked_bag (binary live "
          f"map, my=0) == plain on the batch")
    reasons = [e.reason for e in res.swaps]
    need("bank_failure" in reasons and "straggler" in reasons,
         f"fault lane swaps {reasons}: need a recovery and a straggler "
         f"replan")
    need(res.checks == {"shapes_stable": True, "confine_ok": True,
                        "recover_parity": True},
         f"fault lane checks {res.checks}")
    need(res.stats["slo_penalties"] >= 1 and res.slo_events,
         "no SLO breach reached the replanner")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(requests=96, batch=8, faults=FAULT_REDUCED_SCHEDULE,
              replan_every=16, seed=1, min_recoveries=2,
              slo=SLOConfig(max_share=0.17, window=4))
    cpu = run_fault(spec, red, device="cpu", params=p0, **kw)
    card = run_fault(spec, red, device=dev, params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.reason, e.old_imbalance,  # noqa: E731
                     e.new_imbalance) for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) == 3,
         f"reduced fault lane: swaps card {ev(card)} != CPU {ev(cpu)}")
    need([(b, str(e)) for b, e in card.fired]
         == [(b, str(e)) for b, e in cpu.fired],
         "reduced fault lane: fired events card != CPU")
    for name in ("degraded", "reads"):
        need(all(np.array_equal(x, y) for x, y in
                 zip(getattr(card, name), getattr(cpu, name))),
             f"reduced fault lane: per-batch {name} card != CPU")
    for a, b in zip(card.swaps, cpu.swaps):
        for f in ("bank_of_row", "slot_of_row", "load_per_bank"):
            need(np.array_equal(getattr(a.update.plan, f),
                                getattr(b.update.plan, f)),
                 f"reduced fault lane: swap @{a.batch} plan {f} card != CPU")
    need(card.stragglers == cpu.stragglers and cpu.stragglers,
         f"reduced fault lane: stragglers card {card.stragglers} != CPU "
         f"{cpu.stragglers}")
    sl = lambda r: [(e["batch"], e["kind"]) for e in r.slo_events]  # noqa
    need(sl(card) == sl(cpu) and sl(cpu),
         f"reduced fault lane: SLO breaches card {sl(card)} != CPU "
         f"{sl(cpu)}")
    need(torch.equal(card.runtime.table.packed.cpu(),
                     cpu.runtime.table.packed),
         "reduced fault lane: packed table card != CPU")
    need(card.checks == cpu.checks == {"shapes_stable": True,
                                       "confine_ok": True,
                                       "recover_parity": True},
         f"reduced fault lane checks: card {card.checks}, CPU {cpu.checks}")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced fault lane, card vs CPU: max abs err {err}")
    print(f"reduced config fault lane on the card vs the CPU, same weights: "
          f"fired {[(b, str(e)) for b, e in cpu.fired]}, swaps {ev(cpu)}, "
          f"stragglers {cpu.stragglers}, SLO breaches {sl(cpu)} equal; "
          f"degraded counts, reads, plans and table equal; scores max abs "
          f"err {err} (rtol 1e-5/atol 1e-6)")
    return dict(clean_requests=n_clean_req, requests=B,
                clean_bags=int(clean.sum()), bags=clean.numel(),
                degraded_reads=int(p["counts"].sum()),
                reduced_score_err=err, reduced_swaps=ev(cpu),
                reduced_stragglers=cpu.stragglers,
                reduced_breaches=sl(cpu))


def fault_breakdown(dev, spec, res):
    """Device time (CUDA events, L2 flushed) of the degraded serve step on
    the failure's batch (one bank dead: the binary live map rebuilt in the
    call) against the plain adaptive step on the same table and batch, and
    of the live map, the degraded counts and the bag kernel under the live
    map alone; the host's per-batch and per-swap times from the run."""
    import torch
    from repro_torch.core.embedding import (_binary_live_map,
                                            degraded_row_counts)
    from repro_torch.kernels.embedding_bag import banked_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import (
        build_recsys_serve_adaptive, build_recsys_serve_degraded_adaptive)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    p = res.probes[0]
    t, feats = p["table"], p["feats"]
    live = torch.from_numpy(p["live"]).to(dev)
    params = {**res.params, "emb_packed": t.packed}
    deg = build_recsys_serve_degraded_adaptive(dlrm, spec.config,
                                               res.statics, with_traffic=True)
    plain = build_recsys_serve_adaptive(dlrm, spec.config, res.statics,
                                        with_traffic=True)
    offs = res.statics["field_offsets"]
    sp = feats["sparse"]
    rows = torch.where(sp >= 0, sp + offs[None, :, None], -1)
    idx = sp.reshape(-1, sp.shape[-1]).to(torch.int32).contiguous()
    lm = _binary_live_map(t.remap_bank, live)

    def degraded_step():
        return deg(params, t.remap_bank, t.remap_slot, live, feats,
                   remap_flat=t.remap_flat)

    def plain_step():
        return plain(params, t.remap_bank, t.remap_slot, feats,
                     remap_flat=t.remap_flat)
    with torch.inference_mode():
        out = {"degraded_step": time_ms(degraded_step, flush=scratch.zero_),
               "plain_step": time_ms(plain_step, flush=scratch.zero_),
               "live_map": time_ms(lambda: _binary_live_map(t.remap_bank,
                                                            live),
                                   flush=scratch.zero_),
               "degraded_counts": time_ms(
                   lambda: degraded_row_counts(t.remap_bank, live, rows),
                   flush=scratch.zero_),
               "bag_live_map": time_ms(
                   lambda: banked_bag(t.packed, lm, t.remap_flat, offs, 0,
                                      idx), flush=scratch.zero_)}
        prof = profile_device(degraded_step, n=5)
    out["live_map_share"] = out["live_map"] / out["degraded_step"]
    print(f"fault lane serve step (device ms, L2 flushed), one bank dead: "
          f"degraded {out['degraded_step']:.4f} against the plain adaptive "
          f"step {out['plain_step']:.4f}; the binary live map "
          f"({t.remap_bank.numel()} rows) {out['live_map']:.4f} "
          f"({out['live_map_share']:.1%} of the step), degraded counts "
          f"{out['degraded_counts']:.4f}, banked_bag under the live map "
          f"{out['bag_live_map']:.4f}")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per degraded serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "serve", "lane")}
    rps = len(res.latencies) / res.serve_s
    rec = [e.recovery_s * 1e3 for e in res.recoveries]
    st = res.stats
    print(f"fault lane: p50 {res.p50_ms:.3f} ms, p99 {res.p99_ms:.3f} ms, "
          f"{rps:.1f} requests/s over {len(res.latencies)} requests "
          f"({res.serve_s:.3f} s serving, replans included); recovery "
          f"{', '.join(f'{x:.1f}' for x in rec)} ms; "
          f"{st['straggler_events']} straggler event(s) at batches "
          f"{res.stragglers}; {st['slo_breaches']} SLO breach(es); "
          f"{st['degraded_reads']} degraded reads over "
          f"{st['degraded_batches']} batch(es)")
    print("one fault-lane batch of 64 on the host (median over the run, "
          "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("serve", "lane", "never_failed", "recovery", "straggler"):
        print(f"  {k} ms: " + ", ".join(f"{x:.3f}" for x in h[k]))
    return {**out, **host, "requests_per_s": rps, "recovery_ms": rec}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.models import dlrm

    # 1. device
    t_start = time.perf_counter()
    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN, so "
          f"fp32 products are full fp32", flush=True)

    # 2. kernels
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    spec = get_arch("updlrm-paper")
    cfg = spec.config
    rng = np.random.default_rng(0)
    profile = syn.WORKLOADS["read"]              # GoodReads: 2,360,650 items
    pop = syn.zipf_popularity(cfg.vocab_sizes[0], profile.zipf_a, rng)
    plan = non_uniform_partition(np.tile(pop, cfg.n_sparse), 8,
                                 batch=BAG_TILE)
    print(f"plan: non_uniform_partition over {plan.vocab} rows, 8 banks, "
          f"groups of {BAG_TILE}: imbalance {plan.imbalance():.6f}, "
          f"max rows/bank {plan.max_rows_per_bank} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), plan=plan,
        device=dev)
    report: dict = {}
    check_bag_kernel(dev, cfg, plan, pop, params, statics, rng, report)
    del params, statics
    check_dot_kernel(dev, report)
    print(f"kernels phase: {time.perf_counter() - t_start:.1f} s [{card}]")

    # 3. serve
    t0 = time.perf_counter()
    res, launches = serve_main_path(dev, spec, plan)
    rps = len(res.latencies) / res.serve_s
    print(f"serve {spec.arch_id} full width: p50 {res.p50_ms:.3f} ms, p99 "
          f"{res.p99_ms:.3f} ms, {rps:.1f} requests/s over "
          f"{len(res.latencies)} requests at batch 64 [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res.latencies), 64)))
    check_serve_outputs(dev, spec, res)
    breakdown = serve_breakdown(dev, spec, res)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s [{card}]")

    # 4. train
    t0 = time.perf_counter()
    res_t, t_launches = train_main_path(dev, spec, plan)
    scatter = check_scatter_kernel(dev, cfg, pop, res_t, report)
    train = check_train(dev, spec, res_t)
    train_reduced = check_train_reduced(dev, spec)
    print(f"train phase: {time.perf_counter() - t0:.1f} s [{card}]")
    train_out = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, losses=res_t.losses,
                     step_host_ms=res_t.step_ms, step_ms=train,
                     scatter=scatter, reduced=train_reduced)
    serve_out = dict(requests=len(res.latencies), batch=64, p50_ms=res.p50_ms,
                     p99_ms=res.p99_ms, requests_per_s=rps,
                     serve_s=res.serve_s, latencies_s=res.latencies)
    del res, res_t
    torch.cuda.empty_cache()

    # 5. cache-aware serve
    t0 = time.perf_counter()
    res_c, c_launches = cached_main_path(dev, spec)
    pre_s = sum(v for k, v in res_c.stats.items() if k.endswith("_s"))
    rps_c = len(res_c.latencies) / res_c.serve_s
    print(f"serve_cached {spec.arch_id} full width: p50 {res_c.p50_ms:.3f} "
          f"ms, p99 {res_c.p99_ms:.3f} ms, {rps_c:.1f} requests/s over "
          f"{len(res_c.latencies)} requests at batch 64; pre-process "
          f"{pre_s:.1f} s [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res_c.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res_c.latencies), 64)))
    cache_kernel = check_cache_kernel(dev, res_c, report)
    p_launches, plain_cache = check_plain_cache_kernel(dev, res_c, report)
    cached_grads = check_cached_grads(dev, res_c)
    cached_outputs = check_cached_outputs(dev, spec, res_c)
    cached_step = cached_breakdown(dev, spec, res_c, breakdown["serve_step"])
    print(f"cache-aware serve phase: {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    serve_cached_out = dict(
        requests=len(res_c.latencies), batch=64,
        profile_requests=CACHED_PROFILE, p50_ms=res_c.p50_ms,
        p99_ms=res_c.p99_ms, requests_per_s=rps_c, serve_s=res_c.serve_s,
        latencies_s=res_c.latencies, stats=res_c.stats,
        host_ms=res_c.host_ms, step_ms=cached_step, kernel=cache_kernel,
        plain_cache_kernel=plain_cache, grads=cached_grads,
        outputs=cached_outputs)
    del res_c
    torch.cuda.empty_cache()

    # 6. adaptive serve, tiered-precision tables
    t0 = time.perf_counter()
    res_a, a_launches = adaptive_main_path(dev, spec)
    rps_a = len(res_a.latencies) / res_a.serve_s
    print(f"serve_adaptive {spec.arch_id} full width, int4 tier lane: p50 "
          f"{res_a.p50_ms:.3f} ms, p99 {res_a.p99_ms:.3f} ms, {rps_a:.1f} "
          f"requests/s over {len(res_a.latencies)} requests at batch 64 "
          f"({res_a.serve_s:.3f} s serving, swaps included); "
          f"{len(res_a.swaps)} swap(s) [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res_a.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res_a.latencies), 64)))
    tiered_kernel = check_tiered_kernel(dev, res_a, report)
    adaptive_outputs = check_adaptive_outputs(dev, spec, res_a)
    adaptive_step = adaptive_breakdown(dev, spec, res_a)
    print(f"adaptive serve phase: {time.perf_counter() - t0:.1f} s [{card}]")
    serve_adaptive_out = dict(
        requests=len(res_a.latencies), batch=64, quant="int4",
        replan_every=ADAPTIVE_REPLAN, p50_ms=res_a.p50_ms,
        p99_ms=res_a.p99_ms, requests_per_s=rps_a, serve_s=res_a.serve_s,
        latencies_s=res_a.latencies, stats=res_a.stats,
        host_ms=res_a.host_ms, checks=res_a.checks,
        swaps=[dict(batch=e.batch, old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    tier_version=e.tier_version, promoted=e.tier_promoted,
                    demoted=e.tier_demoted, requantized=e.tier_requantized)
               for e in res_a.swaps],
        reads=[r.tolist() for r in res_a.reads],
        nbytes=[n.tolist() for n in res_a.nbytes], step_ms=adaptive_step,
        kernel=tiered_kernel, outputs=adaptive_outputs)
    del res_a
    torch.cuda.empty_cache()

    # 7. adaptive serve, hot-row replica lane
    t0 = time.perf_counter()
    res_r, r_launches = replicated_main_path(dev, spec)
    rps_r = len(res_r.latencies) / res_r.serve_s
    print(f"serve_replicated {spec.arch_id} full width, k_max {K_MAX}: p50 "
          f"{res_r.p50_ms:.3f} ms, p99 {res_r.p99_ms:.3f} ms, {rps_r:.1f} "
          f"requests/s over {len(res_r.latencies)} requests at batch 64 "
          f"({res_r.serve_s:.3f} s serving, swaps included); "
          f"{len(res_r.swaps)} swap(s) [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res_r.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res_r.latencies), 64)))
    replica_kernel = check_replica_kernel(dev, res_r, report)
    replicated_outputs = check_replicated_outputs(dev, spec, res_r)
    replicated_step = replicated_breakdown(dev, spec, res_r)
    print(f"replicated serve phase: {time.perf_counter() - t0:.1f} s "
          f"[{card}]")
    serve_replicated_out = dict(
        requests=len(res_r.latencies), batch=64, k_max=K_MAX,
        replan_every=REPLICATED_REPLAN, p50_ms=res_r.p50_ms,
        p99_ms=res_r.p99_ms, requests_per_s=rps_r, serve_s=res_r.serve_s,
        latencies_s=res_r.latencies, stats=res_r.stats,
        host_ms=res_r.host_ms, checks=res_r.checks,
        swaps=[dict(batch=e.batch, old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    replica_version=e.replica_version,
                    hot_rows=e.replica_hot_rows,
                    churn=e.replica_copy_churn) for e in res_r.swaps],
        reads=[r.tolist() for r in res_r.reads], step_ms=replicated_step,
        kernel=replica_kernel, outputs=replicated_outputs)
    del res_r
    torch.cuda.empty_cache()

    # 8. ragged CSR lookups, forward and backward; the identity drop-ins
    t0 = time.perf_counter()
    csr_out, csr_launches, drop_launches = csr_phase(dev, spec, plan, report)
    print(f"csr phase: {time.perf_counter() - t0:.1f} s [{card}]")

    # 9. the adaptive loop's cache lane
    t0 = time.perf_counter()
    res_l, l_launches = cached_adaptive_main_path(dev, spec)
    lane_kernel = check_cached_adaptive_kernel(dev, res_l)
    lane_outputs = check_cached_adaptive_outputs(dev, spec, res_l)
    lane_step = cached_adaptive_breakdown(dev, spec, res_l)
    print(f"cache lane phase: {time.perf_counter() - t0:.1f} s [{card}]")
    serve_lane_out = dict(
        requests=len(res_l.latencies), batch=64,
        replan_every=CACHED_ADAPTIVE_REPLAN, p50_ms=res_l.p50_ms,
        p99_ms=res_l.p99_ms, serve_s=res_l.serve_s,
        latencies_s=res_l.latencies, stats=res_l.stats,
        host_ms=res_l.host_ms, checks=res_l.checks,
        swaps=[dict(batch=e.batch, old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    cache_version=e.cache_version,
                    cache_entries=e.cache_entries,
                    cache_dropped=e.cache_dropped) for e in res_l.swaps],
        reads=[r.tolist() for r in res_l.reads], step_ms=lane_step,
        kernel=lane_kernel, outputs=lane_outputs)
    del res_l
    torch.cuda.empty_cache()

    # 10. adaptive training, both partitions
    t0 = time.perf_counter()
    res_tc, tc_launches, tc_spy = adaptive_train_main_path(
        dev, spec, "cache_aware", ADAPTIVE_TRAIN_STEPS, ADAPTIVE_TRAIN_REPLAN,
        ADAPTIVE_TRAIN_REFRESH)
    replay, replay_info = cached_train_replay(dev, spec, res_tc)
    tc_grad = [check_cached_train_grad(dev, spec, res_tc),
               check_cached_train_grad(dev, spec, res_tc, replay, "replay")]
    res_tn, tn_launches, tn_spy = adaptive_train_main_path(
        dev, spec, "non_uniform", ADAPTIVE_TRAIN_STEPS, ADAPTIVE_TRAIN_REPLAN,
        ADAPTIVE_TRAIN_REFRESH)
    train_kernels = adaptive_train_kernel_times(dev, spec, res_tc, res_tn,
                                                replay)
    del replay
    train_adaptive_reduced = check_adaptive_train_reduced(dev, spec)
    print(f"adaptive train phase: {time.perf_counter() - t0:.1f} s [{card}]")
    train_adaptive_out = {
        part: dict(steps=ADAPTIVE_TRAIN_STEPS,
                   replan_every=ADAPTIVE_TRAIN_REPLAN,
                   refresh_every=ADAPTIVE_TRAIN_REFRESH, losses=r.losses,
                   step_host_ms=r.step_ms, host_ms=r.host_ms,
                   migration_steps=[s for s, _ in r.migrations],
                   refreshes=r.refreshes, launches=la,
                   refresh_ms=sp["refresh_ms"],
                   refresh_entries=sp["refresh_entries"])
        for part, r, la, sp in (("cache_aware", res_tc, tc_launches, tc_spy),
                                ("non_uniform", res_tn, tn_launches,
                                 tn_spy))}
    train_adaptive_out.update(grad=tc_grad, kernels=train_kernels,
                              replay=replay_info,
                              reduced=train_adaptive_reduced)
    del res_tc, res_tn
    torch.cuda.empty_cache()

    # 11. the fault lane: a dead bank, a slow bank, the SLO watchdog
    t0 = time.perf_counter()
    res_f, f_launches = fault_main_path(dev, spec)
    fault_outputs = check_fault_outputs(dev, spec, res_f, report)
    fault_step = fault_breakdown(dev, spec, res_f)
    print(f"fault lane phase: {time.perf_counter() - t0:.1f} s [{card}]")
    serve_fault_out = dict(
        requests=len(res_f.latencies), batch=64, schedule=FAULT_SCHEDULE,
        replan_every=FAULT_REPLAN, slo=FAULT_SLO, p50_ms=res_f.p50_ms,
        p99_ms=res_f.p99_ms, serve_s=res_f.serve_s,
        latencies_s=res_f.latencies, stats=res_f.stats,
        host_ms=res_f.host_ms, checks=res_f.checks,
        fired=[(b, str(e)) for b, e in res_f.fired],
        swaps=[dict(batch=e.batch, reason=e.reason,
                    old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    recovery_ms=None if e.recovery_s is None
                    else e.recovery_s * 1e3) for e in res_f.swaps],
        stragglers=res_f.stragglers, slo_events=res_f.slo_events,
        degraded=[c.tolist() for c in res_f.degraded],
        reads=[r.tolist() for r in res_f.reads], lookups=res_f.lookups,
        launches=f_launches, outputs=fault_outputs, fault_breakdown=fault_step)
    del res_f
    torch.cuda.empty_cache()

    runs = (launches, t_launches, c_launches, p_launches, a_launches,
            r_launches, csr_launches, drop_launches, l_launches,
            tc_launches, tn_launches, f_launches)
    for name in report:                          # each path counted apart
        report[name]["launches"] = sum(r.get(name, 0) for r in runs)

    kernels = [report["banked_bag"], report["banked_bag_replicated"],
               report["cache_residual_bag"], report["ct_scatter_bag"],
               report["dot_interaction"], report["dot_features"],
               report["tiered_bag"],
               report["csr_bag"], report["plain_bag"],
               report["plain_cache_bag"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: kd[k] for k in keys} for kd in kernels]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, serve=serve_out,
        serve_step_ms=breakdown, plan_imbalance=plan.imbalance(),
        launches=dict(serve=launches, train=t_launches,
                      serve_cached=c_launches, plain_cache=p_launches,
                      serve_adaptive=a_launches, serve_replicated=r_launches,
                      csr=csr_launches, drop_in=drop_launches,
                      serve_cache_lane=l_launches,
                      train_cache_aware=tc_launches,
                      train_non_uniform=tn_launches,
                      serve_fault=f_launches),
        train=train_out, serve_cached=serve_cached_out,
        serve_adaptive=serve_adaptive_out,
        serve_replicated=serve_replicated_out, csr=csr_out,
        serve_cache_lane=serve_lane_out, train_adaptive=train_adaptive_out,
        serve_fault=serve_fault_out, total_s=time.perf_counter() - t_start),
        indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
