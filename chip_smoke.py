#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main path — the paper's CTR serving of the full-width
``updlrm-paper`` DLRM (8 multi-hot fields of 2,360,650 rows, dim 32, bags of
256) — and holds every kernel on that path against its plain PyTorch
version on the card:

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
     stages.

Prints the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
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


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def need(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def time_ms(fn, *, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after ``warmup`` runs. ``flush()`` runs before each timed run, outside
    the events. A ~1 ms device-side sleep is queued ahead of each start
    event, so the host has enqueued all of ``fn``'s work before the device
    reaches it: the events then time the device, not the Python that
    launches it."""
    import torch
    for _ in range(warmup):
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


def check_bag_kernel(dev, cfg, plan, pop, params, statics, rng, report):
    """Kernel vs plain, bit for bit, at the main-path shape and on small
    bf16 / ragged cases; then the timings at the main-path shape."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.core.partitioning import non_uniform_partition
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

    # small cases: bf16 at D=64 (two columns a lane), fp32 at D=160 (two
    # passes), ragged NB with all-pad bags at D=40 and L=33
    srng = np.random.default_rng(3)
    for dtype, D, NB, Ls, nfield in ((torch.bfloat16, 64, 100, 40, 4),
                                     (torch.float32, 160, 24, 20, 3),
                                     (torch.float32, 40, 37, 33, 5)):
        per_field = 20_000
        sv = per_field * nfield
        splan = non_uniform_partition(srng.random(sv) + 0.01, 4)
        stab = torch.randn((4 * splan.max_rows_per_bank, D), device=dev
                           ).to(dtype)
        sbank = torch.from_numpy(splan.bank_of_row).to(dev)
        sslot = torch.from_numpy(
            (splan.bank_of_row.astype(np.int64) * splan.max_rows_per_bank
             + splan.slot_of_row).astype(np.int32)).to(dev)
        soff = torch.arange(nfield, dtype=torch.int32, device=dev) * per_field
        sids = srng.integers(0, per_field, (NB, Ls)).astype(np.int32)
        sids[srng.random(sids.shape) < 0.1] = -1
        sids[::7] = -1                                   # all-pad bags
        sidx = torch.from_numpy(sids).to(dev)
        for my in (-1, 1):
            same(f"{str(dtype)[6:]} D={D} NB={NB} L={Ls} my={my}", stab,
                 sbank, sslot, soff, my, sidx)

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

    def to(tree):
        return {k: (to(v) if isinstance(v, dict) else
                    [x.to(dev) for x in v] if isinstance(v, list) else
                    v.to(dev) if isinstance(v, torch.Tensor) else v)
                for k, v in tree.items()}

    want = build_recsys_serve(dlrm, red, statics)(params, cpu_batch)
    got = build_recsys_serve(dlrm, red, to(statics))(to(params),
                                                     to(cpu_batch))
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
    print("serve step breakdown (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))

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
    t0 = time.perf_counter()
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

    # 3. serve
    res, launches = serve_main_path(dev, spec, plan)
    for name, n in launches.items():
        report[name]["launches"] = n
    rps = len(res.latencies) / res.serve_s
    print(f"serve {spec.arch_id} full width: p50 {res.p50_ms:.3f} ms, p99 "
          f"{res.p99_ms:.3f} ms, {rps:.1f} requests/s over "
          f"{len(res.latencies)} requests at batch 64 [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res.latencies), 64)))
    check_serve_outputs(dev, spec, res)
    breakdown = serve_breakdown(dev, spec, res)

    kernels = [report["banked_bag"], report["dot_interaction"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: kd[k] for k in keys} for kd in kernels]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, serve=dict(
            requests=len(res.latencies), batch=64, p50_ms=res.p50_ms,
            p99_ms=res.p99_ms, requests_per_s=rps, serve_s=res.serve_s,
            latencies_s=res.latencies),
        serve_step_ms=breakdown, plan_imbalance=plan.imbalance()), indent=1))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
