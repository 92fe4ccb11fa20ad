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
     ragged bags) and the dot-interaction kernel to atol = rtol = 1e-5;
     times kernel, plain version and one library call with CUDA events,
     beside the least time the card could take (``bound_ms``);
  3. serve: ``launch.serve.run`` at full width with every launch counter
     set to 0 just before and read just after (each kernel must have run);
     re-scores the last batch with the plain versions; checks a reduced
     config against a CPU run on the same weights; times the serve step's
     stages;
  4. train: ``launch.train.run`` at full width for a few steps with every
     launch counter set to 0 just before and read just after (all three
     kernels must have run); holds the sorted-run scatter kernel (the bag
     sums' backward) bit for bit against its plain version at the train
     path's shape and on the phase-2 cases, and its prep on the card
     against the prep on the CPU; times it beside its bound and one
     ``index_add_``; checks that the losses are finite, that a batch
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
     dead bank, bf16, ragged bags); checks both tables' gradients and the
     scatter's two dtype mixes against the plain scatter bit for bit; the
     cached scores against the plain path on the deduplicated bags; a
     reduced config on the card against the CPU; times the kernel beside
     its bound and one ``F.embedding_bag``, the cached serve step, and the
     host's share (``next_batch``, the rewrite, the serve call);
  6. adaptive serve with tiered-precision tables: ``launch.serve.run_adaptive``
     at full width with ``quant='int4'`` (256 drifting-Zipf requests at batch
     64, a drift check every 2 batches: telemetry -> replan -> live
     migration -> re-tier -> swap) with every launch counter set to 0 just
     before and read just after (the tiered kernel and the interaction must
     have run, the other bag kernels must not); at least one swap, shapes
     stable, the first re-tier equal to a fresh build; holds the tiered
     kernel bit for bit against its plain version (the served ids under the
     live tier map, with holes, my = 3, a dead bank; int8-only, fp32-hot,
     D = 160 and ragged D = 33 tables); the traffic counters against their
     host twins; the last batch against the plain lookup; a reduced config's
     adaptive run on the card against the CPU swap for swap; times the
     kernel beside its bound, its plain version and a reference point
     (``F.embedding_bag`` over rows dequantized beforehand), the tiered
     serve step, and the host's share (``next_batch`` with its telemetry
     tap, the serve call, the swaps).

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
ADAPTIVE_REQUESTS, ADAPTIVE_REPLAN = 256, 2
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


def bag_bound_ms(idx, off, n_fields, dim, itemsize):
    """Least time for one ``my = -1`` bag call on these ids: each id read
    once, each distinct row touched read once (its 4-byte slot and its D
    values), the output written once; or the fp32 adds, if more. Remap
    reads are counted at 4 bytes, not at the 32-byte sector a random read
    costs."""
    import torch
    NB, L = idx.shape
    bag = torch.arange(NB, device=idx.device) % n_fields
    valid = idx >= 0
    n_rows = torch.unique((idx.long() + off.long()[bag][:, None])[valid]
                          ).numel()
    nbytes = (NB * L * 4 + off.numel() * 4 + n_rows * 4
              + n_rows * dim * itemsize + NB * dim * itemsize)
    flops = int(valid.sum()) * dim
    t_bytes, t_ops = nbytes / HBM_BPS, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def dot_bound_ms(z):
    B, F, D = z.shape
    P = F * (F - 1) // 2
    nbytes = (B * F * D + B * P) * z.element_size()
    t_bytes, t_ops = nbytes / HBM_BPS, 2 * B * P * D / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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


def check_dot_kernel(dev, report):
    import torch
    from repro_torch.kernels.dot_interaction import (dot_interaction,
                                                     dot_interaction_plain)
    g = torch.Generator(device=dev).manual_seed(5)
    errs = []
    print("dot_interaction vs plain (atol = rtol = 1e-5 in fp32):")
    for shape, dtype in (((64, 9, 32), torch.float32),
                         ((8, 27, 64), torch.float32),
                         ((5, 2, 16), torch.float32),
                         ((3, 40, 300), torch.float32),
                         ((64, 9, 32), torch.bfloat16)):
        z = torch.randn(shape, generator=g, device=dev).to(dtype)
        got, want = dot_interaction(z), dot_interaction_plain(z)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"dot_interaction {shape}: shape/dtype")
        err = (got.float() - want.float()).abs().max().item()
        # bf16 output: both round one fp32 dot once; one bf16 step apart
        tol = DOT_TOL if dtype == torch.float32 else dict(rtol=2 ** -8,
                                                          atol=1e-6)
        need(torch.allclose(got.float(), want.float(), **tol),
             f"dot_interaction {shape} {dtype}: max abs err {err}")
        if dtype == torch.float32:
            errs.append(err)
        print(f"  dot_interaction {shape} {str(dtype)[6:]}: max abs err {err}")

    z = torch.randn((64, 9, 32), generator=g, device=dev)
    iu, ju = torch.triu_indices(9, 9, offset=1, device=dev)
    lib = lambda: torch.bmm(z, z.mT)[:, iu, ju]  # noqa: E731
    need(torch.allclose(lib(), dot_interaction(z), **DOT_TOL),
         "bmm library call disagrees with the kernel")
    ms = time_ms(lambda: dot_interaction(z), reps=50)
    plain_ms = time_ms(lambda: dot_interaction_plain(z), reps=50)
    library_ms = time_ms(lib, reps=50)
    bound_ms, bound_by = dot_bound_ms(z)
    print(f"dot_interaction at (64, 9, 32) fp32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bmm {library_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}; launch-bound)")
    report["dot_interaction"] = dict(
        name="dot_interaction", route="cuda",
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:22",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)


def serve_main_path(dev, spec, plan):
    """The main path with the launch counters read around it."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run
    kbag.banked_bag.launches = 0
    kdot.dot_interaction.launches = 0
    res = run(spec, spec.config, requests=256, batch=64, device=dev,
              plan=plan)
    launches = {"banked_bag": kbag.banked_bag.launches,
                "dot_interaction": kdot.dot_interaction.launches}
    print(f"serve: {len(res.latencies)} requests at batch 64, launches "
          f"{launches}")
    for name, n in launches.items():
        need(n > 0, f"the serve run launched no {name} kernel")
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
    from repro_torch.kernels.dot_interaction import dot_interaction
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
        emb = banked_embedding_bag(t, batch["sparse"], field_offsets=fo)
        z = torch.cat([x[:, None], emb], dim=1)
        feat = torch.cat([dot_interaction(z), x], dim=-1)
        parts = {
            "serve_step": lambda: serve(res.params, batch),
            "flat_remap": t.flat_remap,
            "embedding_bag": lambda: banked_embedding_bag(
                t, batch["sparse"], field_offsets=fo),
            "bottom_mlp": lambda: dlrm.mlp_apply(res.params["bot"],
                                                 batch["dense"]),
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
    kdot.dot_interaction.launches = 0
    res = run(spec, spec.config, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
              device=dev, plan=plan)
    launches = {"banked_bag": kbag.banked_bag.launches,
                "ct_scatter_bag": kbag.ct_scatter_bag.launches,
                "dot_interaction": kdot.dot_interaction.launches}
    print(f"train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, launches "
          f"{launches}")
    for name, n in launches.items():
        need(n > 0, f"the train run launched no {name} kernel")
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
    t_bytes, t_ops = nbytes / HBM_BPS, n_live * dim / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def run_lengths(runs):
    n = int(runs.n_run[0])
    lens = runs.run_starts[1:n + 1] - runs.run_starts[:n]
    return n, int(runs.run_starts[n]), int(lens.max()) if n else 0


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
    del out_z
    dest, bags = scatter_entries(idx_main, bank, slot, off, -1, n_rows)
    keep = dest < n_rows
    lib_dest, lib_bag = dest[keep].long(), bags[keep].long()
    lib_out = torch.zeros((n_rows, D), device=dev)
    lib = lambda: lib_out.index_add_(0, lib_dest, ct[lib_bag])  # noqa: E731
    lib()
    need(torch.allclose(lib_out, out, rtol=1e-5, atol=1e-5),
         "index_add_ library call disagrees with the kernel")
    library_ms = time_ms(lib, flush=scratch.zero_)
    del lib_out
    prep_ms = time_ms(lambda: scatter_prep(idx_main, bank, slot, off, -1,
                                           n_rows), flush=scratch.zero_)
    zero_ms = time_ms(lambda: torch.zeros((n_rows, D), device=dev),
                      flush=scratch.zero_)
    wrapper_ms = time_ms(lambda: ct_scatter_bag(ct, idx_main, bank, slot, off,
                                                -1, n_rows),
                         flush=scratch.zero_)
    bound_ms, bound_by = scatter_bound_ms(runs, idx_main.shape[0], D, 4)
    n_run, n_live, longest = run_lengths(runs)
    zn_run, zn_live, zlongest = run_lengths(runs_zipf)
    print(f"ct_scatter_bag at NB={idx_main.shape[0]} L={L} D={D} fp32 "
          f"({n_live} live entries, {n_run} runs, longest {longest}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} "
          f"ms, bound {bound_ms:.6f} ms ({bound_by}); prep {prep_ms:.4f} ms, "
          f"zero fill {zero_ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms")
    print(f"  on the zipf ids ({zn_live} live entries, {zn_run} runs, longest "
          f"{zlongest}): kernel {zipf_ms:.4f} ms")
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
                zipf_runs=zn_run, zipf_longest_run=zlongest)


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
                "dot_interaction": kdot.dot_interaction}
    for fn in counters.values():
        fn.launches = 0
    res = run_cached(spec, spec.config, requests=CACHED_REQUESTS, batch=64,
                     device=dev, profile_requests=CACHED_PROFILE)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"serve_cached: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("cache_residual_bag", "dot_interaction"):
        need(launches[name] > 0, f"the cached serve run launched no {name} "
                                 f"kernel")
    for name in ("banked_bag", "ct_scatter_bag"):
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


def cache_bag_bound_ms(ci, ri, dim, itemsize):
    """Least time for one ``my = -1`` fused call on these ids, summed over
    both streams: each id read once, each distinct row of each table read
    once (its 4-byte slot and its D values), the output written once; or
    the fp32 adds, if more."""
    import torch
    NB = ci.shape[0]
    n_rows = sum(torch.unique(x[x >= 0]).numel() for x in (ci, ri))
    n_valid = int((ci >= 0).sum()) + int((ri >= 0).sum())
    nbytes = (ci.numel() + ri.numel()) * 4 + n_rows * (4 + dim * itemsize) \
        + NB * dim * itemsize
    t_bytes, t_ops = nbytes / HBM_BPS, n_valid * dim / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    for name in ("tiered_bag", "dot_interaction"):
        need(launches[name] > 0, f"the adaptive serve run launched no {name} "
                                 f"kernel")
    for name in ("banked_bag", "cache_residual_bag", "ct_scatter_bag"):
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
    flops = (rows.numel() + int((entry_tier != TIER_HOT).sum())) * tt.dim
    t_bytes, t_ops = nbytes / HBM_BPS, flops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


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
    for c in tiered_small_cases(dev):
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
        grads=cached_grads, outputs=cached_outputs)
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

    runs = (launches, t_launches, c_launches, a_launches)  # each path, apart
    for name in report:
        report[name]["launches"] = sum(r.get(name, 0) for r in runs)

    kernels = [report["banked_bag"], report["cache_residual_bag"],
               report["ct_scatter_bag"], report["dot_interaction"],
               report["tiered_bag"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: kd[k] for k in keys} for kd in kernels]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, serve=serve_out,
        serve_step_ms=breakdown, plan_imbalance=plan.imbalance(),
        launches=dict(serve=launches, train=t_launches,
                      serve_cached=c_launches, serve_adaptive=a_launches),
        train=train_out, serve_cached=serve_cached_out,
        serve_adaptive=serve_adaptive_out,
        total_s=time.perf_counter() - t_start), indent=1))
    print(f"total: {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
