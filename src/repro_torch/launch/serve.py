"""Serving CLI: ``python -m repro_torch.launch.serve --arch updlrm-paper``.

The port of the plain (non-adaptive) path of ``repro/launch/serve.py``:
simulates the paper's online-inference setup with the MicroBatcher — a
stream of requests, micro-batched scoring on the card, a p50/p99 latency
report. ``main`` parses the arguments and serves the arch's reduced config
on CUDA; ``run`` does the work for any config and device and returns the
scores and latencies.

``run_cached`` serves §3.3's cache-aware path (Fig. 4 and Fig. 7): the
pre-processing stage (profile a window of requests, mine co-occurring
groups, plan with the cache-aware partitioner, build the partial-sum cache
table) and then a serve loop whose batches are rewritten on the host into
cache and residual ids and scored through the fused lookup. It is the
reference's ``--adaptive --partition cache_aware`` path as it stands right
after its first cache swap, with no further swaps.

``run_adaptive`` serves the reference's ``--adaptive`` loop (``_main_adaptive``):
drifting-Zipf requests, the MicroBatcher's telemetry tap, drift checks on a
cadence, a replan, a live migration on the card and a swap between
micro-batches; with ``quant='int8'|'int4'`` the table is tiered-precision
and every swap re-tiers it (the tiered kernel serves the lookups).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.core.cache_runtime import (FixedCachePlan,
                                            VersionedCacheRewriter,
                                            build_cache_table_fixed,
                                            cap_cache_plan, entry_banks,
                                            entry_member_union,
                                            measure_hit_rate)
from repro_torch.core.embedding import BankedTable
from repro_torch.core.grace import mine_cooccurrence
from repro_torch.core.partitioning import (PartitionPlan,
                                           cache_aware_partition,
                                           non_uniform_partition)
from repro_torch.data import synthetic as syn
from repro_torch.kernels.embedding_bag import effective_lengths
from repro_torch.models import dlrm
from repro_torch.obs.metrics import (MetricRegistry, empirical_p50,
                                     empirical_p99)
from repro_torch.obs.tracing import Tracer
from repro_torch.obs.traffic import traffic_from_reads
from repro_torch.quant import QuantSpec, build_tiered_table, same_layout
from repro_torch.serve.serve_step import (MicroBatcher, Request,
                                          build_recsys_serve,
                                          build_recsys_serve_adaptive,
                                          build_recsys_serve_cached,
                                          build_recsys_serve_tiered_adaptive)
from repro_torch.workload.replanner import ReplanConfig
from repro_torch.workload.runtime import AdaptiveEmbeddingRuntime, SwapEvent
from repro_torch.workload.telemetry import rows_from_sparse
from repro_torch.workload.trace import (DriftConfig, DriftingZipfTrace,
                                        dlrm_drifting_batch)


@dataclasses.dataclass
class ServeResult:
    scores: torch.Tensor        # (requests,) CTR scores, request order
    latencies: list[float]      # seconds, arrival -> completion, per request
    p50_ms: float
    p99_ms: float
    serve_s: float              # first request's arrival -> last completion
    params: dict                # the served weights and statics
    statics: dict
    last_batch: dict            # the last micro-batch as the step saw it


def _one(cfg, rid):
    """One request's features (a batch of 1), deterministic in ``rid``."""
    b = syn.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, 1, seed=1, step=rid,
                       multi_hot=cfg.multi_hot)
    b.pop("label", None)
    return b


def run(spec, cfg, *, requests: int, batch: int, seed: int = 0,
        device: str | torch.device | None = "cuda", backend: str = "auto",
        plan=None) -> ServeResult:
    """Serve ``requests`` synthetic CTR requests through ``cfg`` in
    micro-batches of ``batch``. Weights are drawn from ``seed`` on
    ``device``; ``plan`` is the PartitionPlan of the super-table (default:
    one bank). Raises when ``device`` is CUDA and there is none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, statics = dlrm.init_params(cfg, gen, plan=plan, device=dev)
    serve = build_recsys_serve(dlrm, cfg, statics, backend=backend)

    proto = syn.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, 1, seed=0, step=0,
                           multi_hot=cfg.multi_hot)
    proto.pop("label", None)
    pad = {k: v[0] for k, v in proto.items()}
    mb = MicroBatcher(batch, pad, device=dev)
    scores: list[torch.Tensor] = []
    last: dict = {}

    def run_batch():
        reqs, feats = mb.next_batch()
        out = serve(params, feats)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mb.complete(reqs)
        scores.append(out[:len(reqs)])
        last.update(feats)

    t0 = time.monotonic()
    for rid in range(requests):
        feats = {k: v[0] for k, v in _one(cfg, rid).items()}
        mb.submit(Request(rid=rid, features=feats))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()

    return ServeResult(
        scores=torch.cat(scores) if scores else torch.empty(0, device=dev),
        latencies=mb.latencies,
        p50_ms=empirical_p50(mb.latencies) * 1e3,
        p99_ms=empirical_p99(mb.latencies) * 1e3,
        serve_s=time.monotonic() - t0,
        params=params, statics=statics, last_batch=last)


@dataclasses.dataclass
class CachedServeResult(ServeResult):
    """``run_cached``'s result: a ``ServeResult`` (``last_batch`` holds
    ``dense``, ``cache_idx`` and ``residual_idx`` as the step saw them) plus
    the cache side and the statistics of the run."""
    cache_table: BankedTable    # the installed partial-sum table
    plan: PartitionPlan         # the cache-aware plan of the EMT
    fcp: FixedCachePlan         # the capped cache plan the rewriter uses
    stats: dict                 # mining, plan, hit rate, lengths, seconds
    host_ms: dict               # per batch: next_batch, rewrite, serve (ms)
    last_union: np.ndarray      # the last batch's union-vocab ids (B, F, L)


def run_cached(spec, cfg, *, requests: int, batch: int, seed: int = 0,
               device: str | torch.device | None = "cuda",
               backend: str = "auto", banks: int = 8,
               cache_entries: int = 128, capacity_slack: float = 0.25,
               profile_requests: int = 64,
               params: dict | None = None) -> CachedServeResult:
    """Serve ``requests`` drifting-Zipf CTR requests through the cache-aware
    path of ``cfg`` (multi-hot) in micro-batches of ``batch``.

    Set-up, with the reference launcher's defaults: a per-bank EMT capacity
    of ``ceil(V / banks) * (1 + capacity_slack)`` rows; ``ceil(cache_entries
    / banks)`` cache entries a bank; one ``DriftingZipfTrace`` (Zipf 1.2,
    bags of ``multi_hot`` on average, no drift) per field, seeded
    ``seed + f``; at most ``max(2, L // 4)`` cache entries and ``L``
    residual rows a bag.

    Pre-processing, as the reference replanner's first cache-aware swap:
    the first ``profile_requests`` requests (after the batcher's prototype)
    are the profiling window (its last 512 bags); the window's row counts
    are the frequencies; ``mine_cooccurrence(top_items=2048, max_groups=256,
    min_support=2)``; ``cache_aware_partition``; ``cap_cache_plan`` at the
    fixed capacity; the EMT from ``dlrm.init_params`` (``seed``, on
    ``device``) unless ``params`` is given (weights packed under the same
    plan, e.g. another device's run); the cache table summed from the
    entry-member rows of the packed EMT alone; installed in a
    ``VersionedCacheRewriter``.

    Serving: the next ``requests`` requests are drawn (the load generator
    runs before the loop, so latency is the serving system's); each is
    submitted as it is served; each batch is ``next_batch`` (stacked on the
    host), ``rewrite_rect`` of its union-vocab ids, one host-to-device copy
    of both id arrays and one of the dense features, and the serve step.
    Raises when ``device`` is CUDA and there is none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    dev = resolve_device(device)
    mh = cfg.multi_hot
    if mh < 2:
        raise ValueError("the cache-aware path needs multi-hot bags (try "
                         "updlrm-paper): GRACE partial sums fuse >= 2 "
                         "lookups of one bag")
    V = cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    crpb = max(1, -(-cache_entries // banks))
    offs = cfg.field_offsets()
    stats: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stats[f"{name}_s"] = now - clock[0]
        clock[0] = now

    traces = [DriftingZipfTrace(
        DriftConfig(n_items=v, zipf_a=1.2, avg_bag=float(mh), rotate_every=0,
                    rotate_frac=0.25), seed=seed + f)
        for f, v in enumerate(cfg.vocab_sizes)]
    rng = np.random.default_rng(seed)

    def one_request():
        sparse = dlrm_drifting_batch(traces, 1, mh)[0]
        return {"dense": rng.standard_normal(cfg.n_dense).astype(np.float32),
                "sparse": sparse}

    def union(sparse):
        return np.where(sparse >= 0, sparse + offs[:, None], -1)

    # -- pre-processing (Fig. 4 stage 0) --------------------------------------
    proto = one_request()
    window = [row[row >= 0] for _ in range(profile_requests)
              for row in union(one_request()["sparse"])][-512:]
    lap("draw_profile")
    freq = np.bincount(np.concatenate(window), minlength=V).astype(np.float64)
    lap("freq")
    cp = mine_cooccurrence(window, top_items=2048, max_groups=256,
                           min_support=2)
    lap("mine")
    plan = cache_aware_partition(freq, cp.groups, cp.benefits, banks,
                                 emt_capacity_rows=cap)
    lap("plan")
    fcp = cap_cache_plan(cp, entry_banks(cp, plan.bank_of_row,
                                         plan.cache_bank_of_entry),
                         banks, crpb)
    lap("cap")
    if params is None:
        params, statics = dlrm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), plan=plan,
            rows_per_bank=cap, device=dev)
    else:
        if tuple(params["emb_packed"].shape) != (banks * cap, cfg.embed_dim):
            raise ValueError(f"params['emb_packed'] "
                             f"{tuple(params['emb_packed'].shape)} != "
                             f"{(banks * cap, cfg.embed_dim)}")
        statics = dlrm.plan_statics(cfg, plan, cap, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("init_params")
    members = entry_member_union(fcp)
    flat = (plan.bank_of_row.astype(np.int64)[members] * cap
            + plan.slot_of_row[members])
    rows = params["emb_packed"][torch.from_numpy(flat).to(dev)]
    table = build_cache_table_fixed(rows, fcp, row_ids=members, device=dev)
    rewriter = VersionedCacheRewriter(max_cache_per_bag=max(2, mh // 4),
                                      max_residual_per_bag=mh)
    rewriter.install(fcp, table)
    lap("cache_build")
    serve = build_recsys_serve_cached(dlrm, cfg, statics, table,
                                      backend=backend)
    feats_of = [one_request() for _ in range(requests)]
    lap("draw_requests")

    # -- serving ---------------------------------------------------------------
    mb = MicroBatcher(batch, proto, device="cpu")
    scores: list[torch.Tensor] = []
    host_ms = {"next_batch": [], "rewrite": [], "serve": []}
    lens = {"cache": [], "residual": []}
    served: list[np.ndarray] = []
    last: dict = {}
    last_union: list[np.ndarray] = []

    def run_batch():
        t0 = time.perf_counter()
        reqs, feats = mb.next_batch()
        t1 = time.perf_counter()
        u = union(feats["sparse"].numpy())
        rb = rewriter.rewrite_rect(u)
        t2 = time.perf_counter()
        ci, ri = rb.cache_idx, rb.residual_idx
        ids = torch.from_numpy(np.concatenate([ci.ravel(), ri.ravel()])
                               ).to(dev)
        b = {"dense": feats["dense"].to(dev),
             "cache_idx": ids[:ci.size].view(ci.shape),
             "residual_idx": ids[ci.size:].view(ri.shape)}
        out = serve(params, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        mb.complete(reqs)
        for k, v in zip(host_ms, (t1 - t0, t2 - t1, t3 - t2)):
            host_ms[k].append(v * 1e3)
        scores.append(out[:len(reqs)])
        n = len(reqs) * cfg.n_sparse
        for k, a in (("cache", ci), ("residual", ri)):
            lens[k].append(effective_lengths(
                torch.from_numpy(a.reshape(-1, a.shape[-1])))[:n])
        served.extend(row[row >= 0] for row in u[:len(reqs)].reshape(-1, mh))
        last.update(b)
        last_union[:] = [u]

    t0 = time.monotonic()
    for rid in range(requests):
        mb.submit(Request(rid=rid, features=feats_of[rid]))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    serve_s = time.monotonic() - t0

    for k, v in lens.items():
        v = torch.cat(v).double() if v else torch.zeros(1, dtype=torch.double)
        stats[f"{k}_len_mean"] = float(v.mean())
        stats[f"{k}_len_max"] = int(v.max())
    stats.update(
        mined_groups=len(cp.groups), mined_entries=cp.n_entries,
        kept_entries=fcp.n_entries, dropped_entries=fcp.n_dropped,
        cache_capacity=fcp.capacity, plan_imbalance=plan.imbalance(),
        emt_rows_per_bank=cap, profile_bags=len(window),
        hit_rate=measure_hit_rate(served, fcp.plan),
        hit_rate_uncapped=measure_hit_rate(served, cp))
    return CachedServeResult(
        scores=torch.cat(scores) if scores else torch.empty(0, device=dev),
        latencies=mb.latencies,
        p50_ms=empirical_p50(mb.latencies) * 1e3,
        p99_ms=empirical_p99(mb.latencies) * 1e3,
        serve_s=serve_s, params=params, statics=statics, last_batch=last,
        cache_table=table, plan=plan, fcp=fcp, stats=stats, host_ms=host_ms,
        last_union=last_union[0] if last_union else np.zeros((0,)))


@dataclasses.dataclass
class AdaptiveServeResult(ServeResult):
    """``run_adaptive``'s result: a ``ServeResult`` (``params`` holds the
    LIVE packed table after the last swap, ``statics`` the initial plan's)
    plus the adaptive loop's record."""
    swaps: list[SwapEvent]      # every live swap, in order
    reads: list[np.ndarray]     # per batch: (banks,) measured row reads
    nbytes: list[np.ndarray]    # per batch: (banks,) measured bytes moved
    runtime: AdaptiveEmbeddingRuntime
    checks: dict                # shapes_stable, retier_ok (None: not run)
    host_ms: dict               # per batch: next_batch, observe (inside
                                # next_batch), serve, end_batch; per swap:
                                # migrate, retier, check_swap (ms)
    stats: dict                 # set-up seconds, plan imbalance, swaps


def _same_tensor_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


def run_adaptive(spec, cfg, *, requests: int, batch: int, quant: str = "off",
                 banks: int = 8, replan_every: int = 8,
                 capacity_slack: float = 0.25, drift_rotate_every: int = 512,
                 hysteresis: float = 0.0,
                 quant_byte_budget: float | None = None,
                 quant_hot_rows: int = 8, min_swaps: int = 0, seed: int = 0,
                 device: str | torch.device | None = "cuda",
                 backend: str = "auto",
                 params: dict | None = None) -> AdaptiveServeResult:
    """The reference's adaptive serve loop (``launch/serve.py
    _main_adaptive``): serve ``requests`` drifting-Zipf CTR requests of
    ``cfg`` in micro-batches of ``batch`` while telemetry, drift checks,
    replans, live migrations and swaps run between micro-batches.

    Set-up, as the reference: a per-bank capacity of ``ceil(V / banks) *
    (1 + capacity_slack)`` rows; the initial plan is the §3.2 greedy on
    all-ones frequencies; the weights come from ``dlrm.init_params(seed)``
    on ``device`` unless ``params`` is given (packed under that plan, e.g.
    the reference's carried across); ``ReplanConfig.for_vocab`` with
    ``check_every=replan_every`` and ``hysteresis``. ``quant`` 'int8' or
    'int4' turns on the tier lane: ``QuantSpec(enable_int4=quant ==
    'int4', byte_budget=quant_byte_budget or, for int4, dim // 2 + 2,
    min_hot_rows=quant_hot_rows)``, version 0 quantized from the all-ones
    prior, every replan partitioning by byte load and re-tiering.

    The request stream is the reference's: one ``DriftingZipfTrace(zipf_a=
    1.05, avg_bag=L, rotate_every=drift_rotate_every, rotate_frac=0.25,
    seed=seed + f)`` per field, the batcher's pad request drawn first, then
    each request's bags and its dense features from ``default_rng(seed)``.
    All requests are drawn before the loop (the load generator is not in
    the latency); each is submitted as it is served.

    Each batch: ``next_batch`` (whose observer tap feeds the telemetry the
    real requests' union-vocab rows), the serve step with the live table's
    tensors as ARGUMENTS (the remap pair, or the whole ``TieredTable``),
    which also returns the batch's per-bank reads and bytes, then
    ``runtime.end_batch()`` (drift check -> replan -> migrate -> swap).

    The swap contract, checked on every swap: every swapped TieredTable and
    remap pair has the shapes, dtypes and device of version 0
    (``checks['shapes_stable']``); on the first re-tier swap the
    incrementally re-tiered table equals a from-scratch
    ``build_tiered_table`` of the migrated table bit for bit
    (``checks['retier_ok']``). ``min_swaps > 0`` raises ``SystemExit``
    unless at least that many swaps happened and both checks held.
    Raises when ``device`` is CUDA and there is none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    if quant not in ("off", "int8", "int4"):
        raise ValueError(f"quant must be 'off', 'int8' or 'int4', got "
                         f"{quant!r}")
    dev = resolve_device(device)
    V = cfg.total_vocab
    cap = int(np.ceil(V / banks) * (1.0 + capacity_slack))
    offs = cfg.field_offsets()
    stats: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stats[f"{name}_s"] = now - clock[0]
        clock[0] = now

    plan = non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    lap("plan")
    if params is None:
        params, statics = dlrm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), plan=plan,
            rows_per_bank=cap, device=dev)
    else:
        if tuple(params["emb_packed"].shape) != (banks * cap, cfg.embed_dim):
            raise ValueError(f"params['emb_packed'] "
                             f"{tuple(params['emb_packed'].shape)} != "
                             f"{(banks * cap, cfg.embed_dim)}")
        statics = dlrm.plan_statics(cfg, plan, cap, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("init_params")

    quant_on = quant != "off"
    qspec = None
    if quant_on:
        budget = quant_byte_budget
        if budget is None and quant == "int4":
            # mostly-int4 mix: the packed width plus a little int8 headroom
            budget = cfg.embed_dim // 2 + 2.0
        qspec = QuantSpec(enable_int4=(quant == "int4"), byte_budget=budget,
                          min_hot_rows=quant_hot_rows)
    metrics = MetricRegistry()
    tracer = Tracer()          # the runtime's migrate and swap spans
    table = BankedTable(packed=params["emb_packed"],
                        remap_bank=statics["remap_bank"],
                        remap_slot=statics["remap_slot"], n_banks=banks,
                        rows_per_bank=cap, remap_flat=statics["remap_flat"])
    rcfg = ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                  check_every=replan_every,
                                  hysteresis=hysteresis, quant=qspec,
                                  quant_dim=cfg.embed_dim if quant_on
                                  else None)
    runtime = AdaptiveEmbeddingRuntime(table, plan, rcfg,
                                       init_freq=np.ones(V),
                                       tracer=tracer, metrics=metrics)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("runtime")
    if quant_on:
        serve = build_recsys_serve_tiered_adaptive(
            dlrm, cfg, statics, backend=backend, with_traffic=True)
        tiered0 = runtime.tiered
    else:
        serve = build_recsys_serve_adaptive(dlrm, cfg, statics,
                                            backend=backend,
                                            with_traffic=True)
    table0 = runtime.table
    row_nbytes = cfg.embed_dim * params["emb_packed"].element_size()

    host_ms = {"next_batch": [], "observe": [], "serve": [], "end_batch": [],
               "migrate": [], "retier": [], "check_swap": []}

    def observe(feats, n_real):
        t0 = time.perf_counter()
        sp = feats["sparse"][:n_real]            # (n, F) or (n, F, L)
        runtime.observe_batch(rows_from_sparse(sp, offs))
        host_ms["observe"].append((time.perf_counter() - t0) * 1e3)

    mh = max(cfg.multi_hot, 1)
    traces = [DriftingZipfTrace(
        DriftConfig(n_items=v, zipf_a=1.05, avg_bag=float(mh),
                    rotate_every=drift_rotate_every, rotate_frac=0.25),
        seed=seed + f) for f, v in enumerate(cfg.vocab_sizes)]
    rng = np.random.default_rng(seed)

    def one_request():
        sparse = dlrm_drifting_batch(traces, 1, cfg.multi_hot)[0]
        return {"dense": rng.standard_normal(cfg.n_dense).astype(np.float32),
                "sparse": sparse}

    pad = one_request()
    feats_of = [one_request() for _ in range(requests)]
    lap("draw_requests")

    mb = MicroBatcher(batch, pad, device=dev, observer=observe,
                      metrics=metrics)
    scores: list[torch.Tensor] = []
    reads: list[np.ndarray] = []
    nbytes: list[np.ndarray] = []
    checks = {"shapes_stable": True, "retier_ok": None}
    last: dict = {}

    def check_swap(event) -> None:
        t = runtime.table
        stable = all(_same_tensor_layout(getattr(t, f), getattr(table0, f))
                     for f in ("packed", "remap_bank", "remap_slot",
                               "remap_flat"))
        if quant_on:
            stable = stable and same_layout(tiered0, runtime.tiered)
            if checks["retier_ok"] is None:
                tt = runtime.tiered
                fresh = build_tiered_table(t, tt.tier_of_row(),
                                           hot_dtype=tt.hot_dtype)
                checks["retier_ok"] = bool(
                    torch.equal(tt.payload, fresh.payload)
                    and torch.equal(tt.scale, fresh.scale)
                    and torch.equal(tt.tier, fresh.tier))
        checks["shapes_stable"] = checks["shapes_stable"] and stable

    def run_batch():
        t0 = time.perf_counter()
        reqs, feats = mb.next_batch()
        t1 = time.perf_counter()
        p = {**params, "emb_packed": runtime.table.packed}
        if quant_on:
            out, r, nb = serve(p, runtime.tiered, feats)
        else:
            t = runtime.table
            out, r = serve(p, t.remap_bank, t.remap_slot, feats,
                           remap_flat=t.remap_flat)
            nb = traffic_from_reads(r, row_nbytes).nbytes
        r, nb = r.cpu().numpy(), nb.cpu().numpy()    # waits for the step
        t2 = time.perf_counter()
        mb.complete(reqs)
        scores.append(out[:len(reqs)])
        reads.append(r.astype(np.int64))
        nbytes.append(nb.astype(np.int64))
        last.update(feats)
        event = runtime.end_batch()        # drift check -> migrate -> swap
        t3 = time.perf_counter()
        if event is not None:
            # the swap span holds the re-tier (the lane's only work there)
            for k, span in (("migrate", "migrate"), ("retier", "swap")):
                host_ms[k].append(tracer.spans(span)[-1].dur_us / 1e3)
            check_swap(event)
            host_ms["check_swap"].append((time.perf_counter() - t3) * 1e3)
        for k, v in zip(("next_batch", "serve", "end_batch"),
                        (t1 - t0, t2 - t1, t3 - t2)):
            host_ms[k].append(v * 1e3)

    t0 = time.monotonic()
    for rid in range(requests):
        mb.submit(Request(rid=rid, features=feats_of[rid]))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    serve_s = time.monotonic() - t0

    rp = runtime.replanner
    stats.update(swaps=len(runtime.swaps), replans=rp.n_replans,
                 skipped_replans=rp.n_skipped_replans,
                 initial_imbalance=plan.imbalance(), rows_per_bank=cap)
    res = AdaptiveServeResult(
        scores=torch.cat(scores) if scores else torch.empty(0, device=dev),
        latencies=mb.latencies,
        p50_ms=empirical_p50(mb.latencies) * 1e3,
        p99_ms=empirical_p99(mb.latencies) * 1e3,
        serve_s=serve_s,
        params={**params, "emb_packed": runtime.table.packed},
        statics=statics, last_batch=last, swaps=list(runtime.swaps),
        reads=reads, nbytes=nbytes, runtime=runtime, checks=checks,
        host_ms=host_ms, stats=stats)
    if min_swaps > 0:
        ok = (len(runtime.swaps) >= min_swaps and checks["shapes_stable"]
              and (not quant_on or checks["retier_ok"] is True))
        if not ok:
            raise SystemExit(
                f"adaptive serve contract violated: swaps="
                f"{len(runtime.swaps)} (need >= {min_swaps}), shapes stable="
                f"{checks['shapes_stable']}, re-tier parity="
                f"{checks['retier_ok']}")
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="dlrm-rm2")
    ap.add_argument("--requests", type=int, default=512)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="embedding bag and interaction: the CUDA kernels "
                         "('cuda'), their plain PyTorch versions ('torch'), "
                         "or the kernels on CUDA tensors ('auto')")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' (the plain "
                         "versions on the host)")
    ap.add_argument("--adaptive", action="store_true",
                    help="online telemetry + drift-triggered repartitioning "
                         "with live table migration (run_adaptive)")
    ap.add_argument("--partition", default="non_uniform",
                    choices=("non_uniform", "cache_aware"),
                    help="adaptive replanner: plain banked (§3.2); the "
                         "cache-aware lane is not ported yet")
    ap.add_argument("--banks", type=int, default=8)
    ap.add_argument("--replan-every", type=int, default=8,
                    help="micro-batches between drift checks")
    ap.add_argument("--capacity-slack", type=float, default=0.25,
                    help="per-bank row headroom over vocab/banks")
    ap.add_argument("--drift-rotate-every", type=int, default=512,
                    help="requests between hot-set rotations of the "
                         "drifting stream")
    ap.add_argument("--min-swaps", type=int, default=0,
                    help="exit non-zero unless at least this many live "
                         "swaps happened and the swap checks held")
    ap.add_argument("--hysteresis", type=float, default=0.0)
    ap.add_argument("--quant", default="off", choices=("off", "int8", "int4"),
                    help="tiered-precision table on the adaptive path")
    ap.add_argument("--quant-byte-budget", type=float, default=None)
    ap.add_argument("--quant-hot-rows", type=int, default=8)
    ap.add_argument("--replicate-k-max", type=int, default=1,
                    help="hot-row replication (not ported yet)")
    ap.add_argument("--inject-bank-failure", action="append", default=[],
                    metavar="BATCH:BANK[:STATE[:FACTOR]]",
                    help="the fault-injection lane (not ported yet)")
    for flag in ("--slo-p99-us", "--slo-max-share", "--slo-divergence"):
        ap.add_argument(flag, type=float, default=0.0,
                        help="the SLO watchdog (not ported yet)")
    args = ap.parse_args(argv)
    spec = get_arch(args.arch)
    cfg = spec.reduced
    if args.adaptive:
        _main_adaptive(args, spec, cfg)
        return
    res = run(spec, cfg, requests=args.requests, batch=args.batch,
              seed=args.seed, device=args.device, backend=args.backend)
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms")


def _main_adaptive(args, spec, cfg) -> None:
    """``main --adaptive``: the flags of the reference's adaptive lanes that
    are not ported raise, naming their ROADMAP item; the plain and tiered
    lanes run ``run_adaptive``."""
    if args.partition == "cache_aware":
        raise NotImplementedError(
            "--adaptive --partition cache_aware (the cache lane's versioned "
            "swaps, _main_adaptive_cached) is not ported yet: ROADMAP queue "
            "1 #10; launch.serve.run_cached serves its path after the first "
            "swap")
    if args.replicate_k_max > 1:
        raise NotImplementedError(
            "--replicate-k-max > 1 (hot-row replication) is not ported yet: "
            "ROADMAP queue 1 #12")
    if args.inject_bank_failure:
        raise NotImplementedError(
            "--inject-bank-failure (the fault-injection lane) is not ported "
            "yet: ROADMAP queue 1 #13")
    if args.slo_p99_us or args.slo_max_share or args.slo_divergence:
        raise NotImplementedError(
            "the --slo-* watchdog is not ported yet: ROADMAP queue 1 #14")
    res = run_adaptive(
        spec, cfg, requests=args.requests, batch=args.batch,
        quant=args.quant, banks=args.banks, replan_every=args.replan_every,
        capacity_slack=args.capacity_slack,
        drift_rotate_every=args.drift_rotate_every,
        hysteresis=args.hysteresis,
        quant_byte_budget=args.quant_byte_budget,
        quant_hot_rows=args.quant_hot_rows, min_swaps=args.min_swaps,
        seed=args.seed, device=args.device, backend=args.backend)
    for e in res.swaps:
        msg = (f"  [swap @batch {e.batch}] {e.update.report} imbalance "
               f"{e.old_imbalance:.3f} -> {e.new_imbalance:.3f}")
        if e.tier_version is not None:
            msg += (f"  tiers v{e.tier_version} +{e.tier_promoted}/"
                    f"-{e.tier_demoted} (requant {e.tier_requantized})")
        print(msg)
    rp = res.runtime.replanner
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms  replans={rp.n_replans} "
          f"skipped={rp.n_skipped_replans}  shapes stable: "
          f"{res.checks['shapes_stable']}  re-tier parity: "
          f"{res.checks['retier_ok']}")


if __name__ == "__main__":
    main()
