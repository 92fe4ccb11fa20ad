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
cache and residual ids and scored through the fused lookup: one plan,
mined once, and no swaps (the stand-alone §3.3 path).

``run_adaptive`` serves the reference's ``--adaptive`` loop (``_main_adaptive``):
drifting-Zipf requests, the MicroBatcher's telemetry tap, drift checks on a
cadence, a replan, a live migration on the card and a swap between
micro-batches; with ``quant='int8'|'int4'`` the table is tiered-precision
and every swap re-tiers it (the tiered kernel serves the lookups).

``run_cached_adaptive`` serves its cache lane (``--adaptive --partition
cache_aware``, ``_main_adaptive_cached``): every batch is rewritten on the
host against the current GRACE plan and version-tagged, and every
cache-aware replan migrates the EMT and swaps a re-mined cache table
between micro-batches; a batch in flight across a swap is served against
the cache table of the version it was rewritten for.

``run_replicated`` serves its hot-row replica lane (``--adaptive
--replicate-k-max K``, ``_main_adaptive_replicated``): every replan re-picks
the replicated rows and swaps a replicated side table, whose lookups the
bag kernel's replica select serves.
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
                                            measure_hit_rate,
                                            sorted_distinct)
from repro_torch.core.embedding import BankedTable, pack_replicated
from repro_torch.core.grace import mine_cooccurrence
from repro_torch.core.partitioning import (PartitionPlan,
                                           cache_aware_partition,
                                           non_uniform_partition)
from repro_torch.data import synthetic as syn
from repro_torch.dist.bank_fault import BankFaultState
from repro_torch.dist.fault import StragglerWatchdog
from repro_torch.kernels.embedding_bag import effective_lengths
from repro_torch.models import dlrm
from repro_torch.obs.cli import add_obs_args, finalize_obs, setup_obs
from repro_torch.obs.metrics import (MetricRegistry, empirical_p50,
                                     empirical_p99)
from repro_torch.obs.metrics_export import PeriodicMetricsWriter
from repro_torch.obs.slo import SLOConfig, SLOWatchdog, hot_bank_penalty
from repro_torch.obs.tracing import Tracer
from repro_torch.obs.traffic import TrafficAccumulator, traffic_from_reads
from repro_torch.quant import QuantSpec, build_tiered_table, same_layout
from repro_torch.serve.serve_step import (MicroBatcher, Request,
                                          build_recsys_serve,
                                          build_recsys_serve_adaptive,
                                          build_recsys_serve_cached,
                                          build_recsys_serve_cached_adaptive,
                                          build_recsys_serve_degraded_adaptive,
                                          build_recsys_serve_replicated_adaptive,
                                          build_recsys_serve_tiered_adaptive)
from repro_torch.workload.replanner import ReplanConfig
from repro_torch.workload.runtime import (AdaptiveEmbeddingRuntime,
                                          SwapEvent, bank_capacity,
                                          cache_lane_runtime, unpacked_rows)
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
        plan=None, tracer: Tracer | None = None,
        metrics: MetricRegistry | None = None,
        writer: PeriodicMetricsWriter | None = None) -> ServeResult:
    """Serve ``requests`` synthetic CTR requests through ``cfg`` in
    micro-batches of ``batch``. Weights are drawn from ``seed`` on
    ``device``; ``plan`` is the PartitionPlan of the super-table (default:
    one bank). ``tracer`` gets a ``rewrite`` (batch assembly) and a
    ``device_step`` span a batch, ``metrics`` the batcher's request
    counters, and ``writer`` a snapshot on its cadence. Raises when
    ``device`` is CUDA and there is none."""
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
    tracer, metrics = _obs_defaults(tracer, metrics)
    mb = MicroBatcher(batch, pad, device=dev, metrics=metrics)
    scores: list[torch.Tensor] = []
    last: dict = {}

    def run_batch():
        with tracer.span("rewrite"):
            reqs, feats = mb.next_batch()
        with tracer.span("device_step", batch=len(scores)):
            out = serve(params, feats)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        mb.complete(reqs)
        scores.append(out[:len(reqs)])
        last.update(feats)
        if writer is not None:
            writer.maybe_write(len(scores))

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
    cap = bank_capacity(V, banks, capacity_slack)
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
    slo_events: list[dict]      # every SLO breach: kind, batch, value,
                                # threshold, hot bank, penalty


def _same_tensor_layout(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.device == b.device


def _adaptive_weights(cfg, plan, cap: int, banks: int, seed: int, dev,
                      params: dict | None):
    """The adaptive loops' weights: ``dlrm.init_params(seed)`` packed under
    ``plan`` at ``cap`` rows a bank on ``dev``, or ``params`` (packed under
    that plan) with the plan's statics."""
    if params is None:
        return dlrm.init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), plan=plan,
            rows_per_bank=cap, device=dev)
    if tuple(params["emb_packed"].shape) != (banks * cap, cfg.embed_dim):
        raise ValueError(f"params['emb_packed'] "
                         f"{tuple(params['emb_packed'].shape)} != "
                         f"{(banks * cap, cfg.embed_dim)}")
    return params, dlrm.plan_statics(cfg, plan, cap, device=dev)


def _drifting_requests(cfg, *, zipf_a: float, drift_rotate_every: int,
                       seed: int, n: int) -> tuple[dict, list[dict]]:
    """The reference launcher's request stream: one ``DriftingZipfTrace
    (zipf_a, avg_bag=L, rotate_every=drift_rotate_every, rotate_frac=0.25,
    seed=seed + f)`` per field; the batcher's pad request first, then ``n``
    requests, each its bags and then its dense features from
    ``default_rng(seed)``."""
    traces = [DriftingZipfTrace(
        DriftConfig(n_items=v, zipf_a=zipf_a, avg_bag=float(max(
            cfg.multi_hot, 1)), rotate_every=drift_rotate_every,
                    rotate_frac=0.25), seed=seed + f)
        for f, v in enumerate(cfg.vocab_sizes)]
    rng = np.random.default_rng(seed)

    def one_request():
        sparse = dlrm_drifting_batch(traces, 1, cfg.multi_hot)[0]
        return {"dense": rng.standard_normal(cfg.n_dense).astype(np.float32),
                "sparse": sparse}

    pad = one_request()
    return pad, [one_request() for _ in range(n)]


def _projected_share(runtime) -> float:
    """Plan-time projected max-bank share of the INSTALLED plan on the
    recent telemetry window — the promise the SLO watchdog's divergence
    check holds the measured traffic against. Cache-aware lanes project
    through the bag-replay model (reads the cache absorbs count for the
    plan), everything else uses the row-share projection."""
    rp = runtime.replanner
    fcp = rp.current_cache_fixed
    if fcp is not None and rp._recent_bags:
        return rp.projected_max_share_cached(runtime.plan, fcp,
                                             list(rp._recent_bags))
    return rp.projected_max_share(runtime.plan, rp.telemetry.freq_vector())


class _TrafficSLO:
    """One serve loop's measured-traffic lane (the reference launcher's
    ``_TrafficSLO``): the ``TrafficAccumulator`` (``obs.bank_reads`` /
    ``obs.bank_bytes`` / ``obs.bank_share``), the SLO watchdog, and the
    Chrome-trace counter tracks. Every adaptive loop builds it, so the
    metrics snapshot carries the whole ``obs.*`` family whether or not any
    SLO check is armed. A breach pushes ``hot_bank_penalty`` of the
    window's reads into ``runtime.on_slo_breach`` and is recorded in
    ``events``."""

    def __init__(self, cfg: SLOConfig, metrics, tracer, *, banks: int,
                 dim: int, row_nbytes: int, runtime=None):
        self.tracer = tracer
        self.acc = TrafficAccumulator(metrics, banks, row_nbytes=row_nbytes)
        self.penalties = 0
        self.events: list[dict] = []

        def on_breach(kind, info):
            if runtime is None:
                return
            pen = hot_bank_penalty(info["window_reads"], banks)
            runtime.on_slo_breach(pen)
            self.penalties += 1
            self.events.append(dict(
                kind=kind, batch=info["batch"], value=info["value"],
                threshold=info["threshold"], bank=info["bank"],
                penalty=float(pen.max())))

        self.watchdog = SLOWatchdog(cfg, n_banks=banks, dim=dim,
                                    metrics=metrics, tracer=tracer,
                                    on_breach=on_breach)
        if runtime is not None:
            self.watchdog.set_projection(_projected_share(runtime))

    @property
    def breaches(self) -> int:
        return self.watchdog.breaches

    def on_swap(self, runtime) -> None:
        """Refresh the plan-time projection after a live swap."""
        self.watchdog.set_projection(_projected_share(runtime))

    def after_step(self, batch, reads, wall_us, batch_size, *, nbytes=None,
                   p99_ms=None) -> float:
        """Fold one batch's measured counts; feed the watchdog."""
        reads = np.asarray(reads)
        share = self.acc.update(reads, nbytes)
        self.tracer.counter(
            "bank_reads", **{f"bank{i}": int(v) for i, v in enumerate(reads)})
        self.tracer.counter("serve_slo", max_bank_share=share,
                            **({} if p99_ms is None else {"p99_ms": p99_ms}))
        self.watchdog.observe(batch, wall_us=wall_us, reads=reads,
                              batch_size=batch_size)
        return share

    def check_contract(self, min_breaches: int) -> None:
        """The SLO contract: at least ``min_breaches`` detected AND the
        replanner received a penalty."""
        if min_breaches <= 0:
            return
        if self.breaches < min_breaches or self.penalties < 1:
            raise SystemExit(
                f"slo contract violated: breaches={self.breaches} "
                f"(need >= {min_breaches}), replanner penalties="
                f"{self.penalties} (need >= 1)")


def _obs_defaults(tracer, metrics):
    """A loop's tracer and registry: the caller's (``main``'s, from the
    ``--trace-out`` / ``--metrics-out`` flags), else fresh ones. The loops
    read their own spans for ``host_ms``, so they always trace."""
    return (Tracer() if tracer is None else tracer,
            MetricRegistry() if metrics is None else metrics)


def run_adaptive(spec, cfg, *, requests: int, batch: int, quant: str = "off",
                 banks: int = 8, replan_every: int = 8,
                 capacity_slack: float = 0.25, drift_rotate_every: int = 512,
                 hysteresis: float = 0.0,
                 quant_byte_budget: float | None = None,
                 quant_hot_rows: int = 8, min_swaps: int = 0, seed: int = 0,
                 device: str | torch.device | None = "cuda",
                 backend: str = "auto",
                 params: dict | None = None, slo: SLOConfig | None = None,
                 min_slo_breaches: int = 0, tracer: Tracer | None = None,
                 metrics: MetricRegistry | None = None,
                 writer: PeriodicMetricsWriter | None = None
                 ) -> AdaptiveServeResult:
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
    which also returns the batch's per-bank reads and bytes, the SLO lane
    (the reads into ``obs.bank_*``, the watchdog armed by ``slo``, default
    all checks off; a breach calls ``runtime.on_slo_breach`` with the hot
    bank's penalty), then ``runtime.end_batch()`` (drift check -> replan ->
    migrate -> swap). ``tracer``, ``metrics`` and ``writer`` are the
    observability hooks (``run``'s, plus the runtime's spans and series).

    The swap contract, checked on every swap: every swapped TieredTable and
    remap pair has the shapes, dtypes and device of version 0
    (``checks['shapes_stable']``); on the first re-tier swap the
    incrementally re-tiered table equals a from-scratch
    ``build_tiered_table`` of the migrated table bit for bit
    (``checks['retier_ok']``). ``min_swaps > 0`` raises ``SystemExit``
    unless at least that many swaps happened and both checks held, and
    ``min_slo_breaches > 0`` unless that many breaches reached the
    replanner. Raises when ``device`` is CUDA and there is none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    if quant not in ("off", "int8", "int4"):
        raise ValueError(f"quant must be 'off', 'int8' or 'int4', got "
                         f"{quant!r}")
    dev = resolve_device(device)
    V = cfg.total_vocab
    cap = bank_capacity(V, banks, capacity_slack)
    offs = cfg.field_offsets()
    stats: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stats[f"{name}_s"] = now - clock[0]
        clock[0] = now

    plan = non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    lap("plan")
    params, statics = _adaptive_weights(cfg, plan, cap, banks, seed, dev,
                                        params)
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
    tracer, metrics = _obs_defaults(tracer, metrics)
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
    slo_lane = _TrafficSLO(slo or SLOConfig(), metrics, tracer, banks=banks,
                           dim=cfg.embed_dim, row_nbytes=row_nbytes,
                           runtime=runtime)

    host_ms = {"next_batch": [], "observe": [], "serve": [], "end_batch": [],
               "migrate": [], "retier": [], "check_swap": []}

    def observe(feats, n_real):
        t0 = time.perf_counter()
        sp = feats["sparse"][:n_real]            # (n, F) or (n, F, L)
        runtime.observe_batch(rows_from_sparse(sp, offs))
        host_ms["observe"].append((time.perf_counter() - t0) * 1e3)

    pad, feats_of = _drifting_requests(
        cfg, zipf_a=1.05, drift_rotate_every=drift_rotate_every, seed=seed,
        n=requests)
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
        with tracer.span("rewrite"):
            reqs, feats = mb.next_batch()
        t1 = time.perf_counter()
        with tracer.span("device_step", batch=len(scores)):
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
        slo_lane.after_step(len(scores), r, (t2 - t1) * 1e6, batch,
                            nbytes=nb, p99_ms=mb.p99() * 1e3)
        scores.append(out[:len(reqs)])
        reads.append(r.astype(np.int64))
        nbytes.append(nb.astype(np.int64))
        last.update(feats)
        if writer is not None:
            writer.maybe_write(len(scores))
        t3 = time.perf_counter()
        event = runtime.end_batch()        # drift check -> migrate -> swap
        t4 = time.perf_counter()
        if event is not None:
            # the swap span holds the re-tier (the lane's only work there)
            for k, span in (("migrate", "migrate"), ("retier", "swap")):
                host_ms[k].append(tracer.spans(span)[-1].dur_us / 1e3)
            check_swap(event)
            host_ms["check_swap"].append((time.perf_counter() - t4) * 1e3)
            slo_lane.on_swap(runtime)
        for k, v in zip(("next_batch", "serve", "end_batch"),
                        (t1 - t0, t2 - t1, t4 - t3)):
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
        host_ms=host_ms, stats=stats, slo_events=slo_lane.events)
    if min_swaps > 0:
        ok = (len(runtime.swaps) >= min_swaps and checks["shapes_stable"]
              and (not quant_on or checks["retier_ok"] is True))
        if not ok:
            raise SystemExit(
                f"adaptive serve contract violated: swaps="
                f"{len(runtime.swaps)} (need >= {min_swaps}), shapes stable="
                f"{checks['shapes_stable']}, re-tier parity="
                f"{checks['retier_ok']}")
    slo_lane.check_contract(min_slo_breaches)
    return res


def run_replicated(spec, cfg, *, requests: int, batch: int, k_max: int,
                   max_r: int = 64, banks: int = 8, replan_every: int = 8,
                   capacity_slack: float = 0.25,
                   drift_rotate_every: int = 512, hysteresis: float = 0.0,
                   min_swaps: int = 0, seed: int = 0,
                   device: str | torch.device | None = "cuda",
                   backend: str = "auto",
                   params: dict | None = None, slo: SLOConfig | None = None,
                   min_slo_breaches: int = 0, tracer: Tracer | None = None,
                   metrics: MetricRegistry | None = None,
                   writer: PeriodicMetricsWriter | None = None
                   ) -> AdaptiveServeResult:
    """The reference's hot-row replicated adaptive loop (``launch/serve.py
    _main_adaptive_replicated``, ``--adaptive --replicate-k-max K``): serve
    ``requests`` drifting-Zipf(2.0) CTR requests of ``cfg`` in micro-batches
    of ``batch`` while the runtime's replica lane re-picks the replicated
    rows on every drifted replan and swaps the whole ``ReplicatedTable``.

    Set-up as ``run_adaptive`` (capacity ``ceil(V / banks) * (1 +
    capacity_slack)``, the all-ones §3.2 plan, ``dlrm.init_params(seed)``
    on ``device`` unless ``params`` is given), with ``ReplanConfig.for_vocab
    (replicate_k_max=k_max, replicate_max_r=max_r)``; replica version 0 is
    built from the all-ones prior. The request stream is ``run_adaptive``'s
    with ``zipf_a=2.0``: a much heavier head, since a row is replicated
    only when it carries more than 1 / (banks * k_max) of all reads.

    Each batch: ``next_batch`` (its observer tap feeds the telemetry), the
    serve step with the current ``ReplicatedTable`` and an all-live
    ``bank_live`` as ARGUMENTS (returning scores, degraded counts, which
    must be 0, and per-bank reads), the SLO lane (as ``run_adaptive``'s),
    then ``runtime.end_batch()``.

    The swap contract: every swapped base table and replicated table has
    version 0's shapes, dtypes and device (``checks['shapes_stable']``); on
    the first swap the swapped-in replicated table equals
    ``pack_replicated`` of the migrated base table's rows under the same
    plan, and scores the swap's batch equal to it (``checks['repack_ok']``).
    ``min_swaps > 0`` raises ``SystemExit`` unless at least that many swaps
    happened and both checks held. ``stats`` carries the replica lane's
    version, replicated rows and modeled max-bank share; ``host_ms`` per
    swap the base replan, the replica plan, the two migrations and the
    checks. ``slo``, ``min_slo_breaches`` and the observability hooks are
    ``run_adaptive``'s. Raises when ``device`` is CUDA and there is
    none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    if k_max < 2:
        raise ValueError(f"k_max {k_max}: the replica lane needs >= 2")
    dev = resolve_device(device)
    V = cfg.total_vocab
    cap = bank_capacity(V, banks, capacity_slack)
    offs = cfg.field_offsets()
    stats: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stats[f"{name}_s"] = now - clock[0]
        clock[0] = now

    plan = non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    lap("plan")
    params, statics = _adaptive_weights(cfg, plan, cap, banks, seed, dev,
                                        params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("init_params")
    tracer, metrics = _obs_defaults(tracer, metrics)
    table = BankedTable(packed=params["emb_packed"],
                        remap_bank=statics["remap_bank"],
                        remap_slot=statics["remap_slot"], n_banks=banks,
                        rows_per_bank=cap, remap_flat=statics["remap_flat"])
    rcfg = ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                  check_every=replan_every,
                                  hysteresis=hysteresis,
                                  replicate_k_max=k_max,
                                  replicate_max_r=max_r)
    runtime = AdaptiveEmbeddingRuntime(table, plan, rcfg,
                                       init_freq=np.ones(V),
                                       tracer=tracer, metrics=metrics)
    lap("runtime")
    serve = build_recsys_serve_replicated_adaptive(
        dlrm, cfg, statics, backend=backend, with_traffic=True)
    all_live = torch.ones(banks, dtype=torch.bool, device=dev)
    table0, (_, rtable0) = runtime.table, runtime.replicated
    row_nbytes = cfg.embed_dim * params["emb_packed"].element_size()
    slo_lane = _TrafficSLO(slo or SLOConfig(), metrics, tracer, banks=banks,
                           dim=cfg.embed_dim, row_nbytes=row_nbytes,
                           runtime=runtime)

    host_ms = {"next_batch": [], "observe": [], "serve": [], "end_batch": [],
               "replan": [], "replica_plan": [], "migrate": [],
               "migrate_replicated": [], "check_swap": []}

    def observe(feats, n_real):
        t0 = time.perf_counter()
        sp = feats["sparse"][:n_real]
        runtime.observe_batch(rows_from_sparse(sp, offs))
        host_ms["observe"].append((time.perf_counter() - t0) * 1e3)

    pad, feats_of = _drifting_requests(
        cfg, zipf_a=2.0, drift_rotate_every=drift_rotate_every, seed=seed,
        n=requests)
    lap("draw_requests")

    mb = MicroBatcher(batch, pad, device=dev, observer=observe,
                      metrics=metrics)
    scores: list[torch.Tensor] = []
    reads: list[np.ndarray] = []
    nbytes: list[np.ndarray] = []
    checks = {"shapes_stable": True, "repack_ok": None}
    last: dict = {}

    def check_swap(feats) -> None:
        t, (rplan, rt) = runtime.table, runtime.replicated
        stable = all(_same_tensor_layout(getattr(t, f), getattr(table0, f))
                     for f in ("packed", "remap_bank", "remap_slot",
                               "remap_flat"))
        stable = stable and all(
            _same_tensor_layout(getattr(rt, f), getattr(rtable0, f))
            for f in ("packed", "remap_bank", "remap_slot", "remap_flat",
                      "bank_flat"))
        checks["shapes_stable"] = checks["shapes_stable"] and stable
        if checks["repack_ok"] is None:
            fresh = pack_replicated(unpacked_rows(t), rplan,
                                    rows_per_bank=cap, device=dev)
            arrays_ok = all(torch.equal(getattr(rt, f), getattr(fresh, f))
                            for f in ("packed", "remap_bank", "remap_slot"))
            p = {**params, "emb_packed": t.packed}
            out_ok = torch.equal(serve(p, rt, all_live, feats)[0],
                                 serve(p, fresh, all_live, feats)[0])
            checks["repack_ok"] = bool(arrays_ok and out_ok)

    def run_batch():
        t0 = time.perf_counter()
        with tracer.span("rewrite"):
            reqs, feats = mb.next_batch()
        t1 = time.perf_counter()
        with tracer.span("device_step", batch=len(scores)):
            p = {**params, "emb_packed": runtime.table.packed}
            out, counts, r = serve(p, runtime.replicated[1], all_live, feats)
            r = r.cpu().numpy()                          # waits for the step
        if int(counts.sum()) != 0:
            raise RuntimeError(f"degraded reads with every bank live: "
                               f"{counts.tolist()}")
        t2 = time.perf_counter()
        mb.complete(reqs)
        slo_lane.after_step(len(scores), r, (t2 - t1) * 1e6, batch,
                            p99_ms=mb.p99() * 1e3)
        scores.append(out[:len(reqs)])
        reads.append(r.astype(np.int64))
        nbytes.append(r.astype(np.int64) * row_nbytes)
        last.update(feats)
        if writer is not None:
            writer.maybe_write(len(scores))
        n_spans = len(tracer.records)
        t3 = time.perf_counter()
        event = runtime.end_batch()        # drift check -> migrate -> swap
        t4 = time.perf_counter()
        if event is not None:
            spans = {k: sum(rec.dur_us for rec in tracer.records[n_spans:]
                            if rec.name == k) / 1e3
                     for k in ("replica_plan", "migrate", "swap",
                               "migrate_replicated")}
            host_ms["replan"].append((t4 - t3) * 1e3 - spans["replica_plan"]
                                     - spans["migrate"] - spans["swap"])
            for k in ("replica_plan", "migrate", "migrate_replicated"):
                host_ms[k].append(spans[k])
            check_swap(feats)
            host_ms["check_swap"].append((time.perf_counter() - t4) * 1e3)
            slo_lane.on_swap(runtime)
        for k, v in zip(("next_batch", "serve", "end_batch"),
                        (t1 - t0, t2 - t1, t4 - t3)):
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
    rplan, _ = runtime.replicated
    stats.update(swaps=len(runtime.swaps), replans=rp.n_replans,
                 skipped_replans=rp.n_skipped_replans,
                 initial_imbalance=plan.imbalance(), rows_per_bank=cap,
                 k_max=k_max, replica_version=runtime.replica_version,
                 replicated_rows=rplan.n_replicated,
                 modeled_max_share=rplan.max_share(),
                 ideal_share=1.0 / banks)
    res = AdaptiveServeResult(
        scores=torch.cat(scores) if scores else torch.empty(0, device=dev),
        latencies=mb.latencies,
        p50_ms=empirical_p50(mb.latencies) * 1e3,
        p99_ms=empirical_p99(mb.latencies) * 1e3,
        serve_s=serve_s,
        params={**params, "emb_packed": runtime.table.packed},
        statics=statics, last_batch=last, swaps=list(runtime.swaps),
        reads=reads, nbytes=nbytes, runtime=runtime, checks=checks,
        host_ms=host_ms, stats=stats, slo_events=slo_lane.events)
    if min_swaps > 0:
        ok = (len(runtime.swaps) >= min_swaps and checks["shapes_stable"]
              and checks["repack_ok"] is True)
        if not ok:
            raise SystemExit(
                f"replicated serve contract violated: swaps="
                f"{len(runtime.swaps)} (need >= {min_swaps}), shapes stable="
                f"{checks['shapes_stable']}, re-pack parity="
                f"{checks['repack_ok']}")
    slo_lane.check_contract(min_slo_breaches)
    return res


@dataclasses.dataclass
class CachedAdaptiveServeResult(ServeResult):
    """``run_cached_adaptive``'s result: a ``ServeResult`` (``params`` holds
    the LIVE packed EMT after the last swap, ``statics`` the initial plan's,
    ``last_batch`` the last served ``dense``, ``cache_idx`` and
    ``residual_idx``) plus the cache lane's record."""
    swaps: list[SwapEvent]      # every live swap, in order
    rewritten: list[tuple]      # per batch: (cache_idx, residual_idx,
                                # version) as served
    unions: list[np.ndarray]    # per batch: its union-vocab ids (B, F, L)
    reads: list[np.ndarray]     # per batch: (banks,) measured reads
    runtime: AdaptiveEmbeddingRuntime
    checks: dict                # shapes_stable, arrays_ok, outputs_ok
    host_ms: dict               # per batch: next_batch, observe (inside
                                # next_batch), rewrite, end_batch, serve;
                                # per swap: replan, migrate, cache_install,
                                # check_swap (ms)
    stats: dict                 # set-up seconds, swaps, hit rate
    swap_probe: dict            # the first swap's batch: its rewrite under
                                # the new version, the swapped-in cache
                                # table and the fresh build
    slo_events: list[dict]      # every SLO breach (as run_adaptive's)


def _served_hit_rate(unions: list[np.ndarray], rewritten: list[tuple]
                     ) -> float:
    """The row reads the cache absorbed over the served batches, as a
    fraction of their distinct ids: a bag of u distinct ids rewritten to c
    entries and r residual rows saved u - c - r reads."""
    saved = distinct = 0
    for u, (ci, ri, _) in zip(unions, rewritten):
        _, valid = sorted_distinct(u.reshape(-1, u.shape[-1]))
        n = int(valid.sum())
        saved += n - int((ci >= 0).sum() + (ri >= 0).sum())
        distinct += n
    return saved / max(distinct, 1)


def run_cached_adaptive(spec, cfg, *, requests: int, batch: int,
                        banks: int = 8, replan_every: int = 8,
                        capacity_slack: float = 0.25,
                        cache_entries: int = 128,
                        drift_rotate_every: int = 512,
                        hysteresis: float = 0.0, min_swaps: int = 0,
                        seed: int = 0,
                        device: str | torch.device | None = "cuda",
                        backend: str = "auto",
                        params: dict | None = None,
                        slo: SLOConfig | None = None,
                        min_slo_breaches: int = 0,
                        tracer: Tracer | None = None,
                        metrics: MetricRegistry | None = None,
                        writer: PeriodicMetricsWriter | None = None
                        ) -> CachedAdaptiveServeResult:
    """The reference's adaptive cache lane (``launch/serve.py
    _main_adaptive_cached``, ``--adaptive --partition cache_aware``): serve
    ``requests`` drifting-Zipf(1.2) CTR requests of ``cfg`` (multi-hot) in
    micro-batches of ``batch``, every batch rewritten on the host against
    the current cache plan and version-tagged, with live GRACE-table swaps
    between micro-batches.

    Set-up, as the reference: a per-bank EMT capacity of ``ceil(V / banks)
    * (1 + capacity_slack)`` rows (``bank_capacity``); the initial plan is
    the §3.2 greedy on all-ones frequencies; the weights come from
    ``dlrm.init_params(seed)`` on ``device`` unless ``params`` is given
    (packed under that plan); the runtime is ``cache_lane_runtime``'s
    (``ceil(cache_entries / banks)`` cache entries a bank, cache-aware
    replans every ``replan_every`` batches with ``hysteresis``,
    ``mine_min_support=2``, telemetry decayed by 0.8 every 4096, at most
    ``max(2, L // 4)`` cache entries and ``L`` residual rows a bag). Cache
    version 0 is the empty plan. The request stream is ``run_adaptive``'s with
    ``zipf_a=1.2``.

    Each batch: ``next_batch`` on the host (its observer tap feeds the
    real requests' bags to ``observe_bags``), ``runtime.rewrite`` of its
    union-vocab ids, ``runtime.end_batch()`` (drift check -> cache-aware
    replan -> migrate -> cache install -> swap), then the serve step with
    the live EMT's remaps and the cache table OF THE BATCH'S VERSION as
    arguments: a batch rewritten just before a swap is served against the
    retired version's table and the migrated EMT. The step returns the
    batch's per-bank reads (a cache hit is one read on its entry's bank),
    which feed the SLO lane (as ``run_adaptive``'s, after the swap).

    The swap contract, as the reference's: on the first swap the migrated
    EMT and the swapped-in cache table (packed, ``remap_bank``,
    ``remap_slot``) equal a fresh build from the current rows bit for bit
    (``checks['arrays_ok']``, built on the table's device), and the swap's
    batch rewritten under the new version scores the same through the
    swapped-in table as through the fresh one (``checks['outputs_ok']``);
    every swap keeps version 0's shapes (``checks['shapes_stable']``).
    ``min_swaps > 0`` raises ``SystemExit`` unless at least that many swaps
    happened and the checks held, and ``min_slo_breaches > 0`` unless that
    many SLO breaches reached the replanner. ``slo`` and the observability
    hooks are ``run_adaptive``'s. Raises when ``device`` is CUDA and there
    is none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    dev = resolve_device(device)
    V = cfg.total_vocab
    cap = bank_capacity(V, banks, capacity_slack)
    offs = cfg.field_offsets()
    stats: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stats[f"{name}_s"] = now - clock[0]
        clock[0] = now

    plan = non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    lap("plan")
    params, statics = _adaptive_weights(cfg, plan, cap, banks, seed, dev,
                                        params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("init_params")
    tracer, metrics = _obs_defaults(tracer, metrics)
    table = BankedTable(packed=params["emb_packed"],
                        remap_bank=statics["remap_bank"],
                        remap_slot=statics["remap_slot"], n_banks=banks,
                        rows_per_bank=cap, remap_flat=statics["remap_flat"])
    runtime = cache_lane_runtime(
        table, plan, multi_hot=cfg.multi_hot, replan_every=replan_every,
        cache_entries=cache_entries, hysteresis=hysteresis, tracer=tracer,
        metrics=metrics)
    lap("runtime")
    serve = build_recsys_serve_cached_adaptive(dlrm, cfg, statics,
                                               backend=backend,
                                               with_traffic=True)
    table0, ctable0 = runtime.table, runtime.cache_table
    slo_lane = _TrafficSLO(
        slo or SLOConfig(), metrics, tracer, banks=banks, dim=cfg.embed_dim,
        row_nbytes=cfg.embed_dim * params["emb_packed"].element_size(),
        runtime=runtime)

    host_ms = {"next_batch": [], "observe": [], "rewrite": [],
               "end_batch": [], "serve": [], "replan": [], "migrate": [],
               "cache_install": [], "check_swap": []}

    def union(sparse):
        return np.where(sparse >= 0, sparse + offs[None, :, None], -1)

    def observe(feats, n_real):
        t0 = time.perf_counter()
        u = union(feats["sparse"][:n_real])
        runtime.observe_bags([bag[bag >= 0]
                              for bag in u.reshape(-1, u.shape[-1])])
        host_ms["observe"].append((time.perf_counter() - t0) * 1e3)

    pad, feats_of = _drifting_requests(
        cfg, zipf_a=1.2, drift_rotate_every=drift_rotate_every, seed=seed,
        n=requests)
    lap("draw_requests")

    mb = MicroBatcher(batch, pad, device="cpu", observer=observe,
                      metrics=metrics)
    scores: list[torch.Tensor] = []
    reads: list[np.ndarray] = []
    rewritten: list[tuple] = []
    unions: list[np.ndarray] = []
    checks = {"shapes_stable": True, "arrays_ok": None, "outputs_ok": None}
    probe: dict = {}
    last: dict = {}

    def on_device(rb, dense):
        ci, ri = rb.cache_idx, rb.residual_idx
        ids = torch.from_numpy(np.concatenate([ci.ravel(), ri.ravel()])
                               ).to(dev)
        return {"dense": dense.to(dev),
                "cache_idx": ids[:ci.size].view(ci.shape),
                "residual_idx": ids[ci.size:].view(ri.shape)}

    def check_swap(u, dense) -> None:
        """First-swap invariant: the swapped-in state equals a from-scratch
        build of the whole cache path at the same plan, on the device."""
        t, p = runtime.table, runtime.plan
        rows = t.packed[t.remap_flat.long()]
        fresh = torch.zeros_like(t.packed)
        fresh[torch.from_numpy(p.bank_of_row.astype(np.int64) * cap
                               + p.slot_of_row).to(dev)] = rows
        emt_ok = torch.equal(t.packed, fresh)
        del fresh
        fresh_cache = build_cache_table_fixed(rows, runtime.cache_plan,
                                              device=dev)
        del rows
        ct = runtime.cache_table
        cache_ok = all(torch.equal(getattr(ct, f), getattr(fresh_cache, f))
                       for f in ("packed", "remap_bank", "remap_slot"))
        checks["arrays_ok"] = bool(emt_ok and cache_ok)
        # the swap's batch rewritten under the new version (this rewrite
        # feeds the replanner's hit estimate, as the reference's does)
        probe.update(rb=runtime.rewrite(u), dense=dense, table=ct,
                     fresh=fresh_cache, version=runtime.rewriter.version)

    def stable() -> bool:
        t, ct = runtime.table, runtime.cache_table
        return all(_same_tensor_layout(getattr(t, f), getattr(table0, f))
                   for f in ("packed", "remap_bank", "remap_slot",
                             "remap_flat")) and all(
            _same_tensor_layout(getattr(ct, f), getattr(ctable0, f))
            for f in ("packed", "remap_bank", "remap_slot", "remap_flat"))

    def run_batch():
        t0 = time.perf_counter()
        with tracer.span("rewrite"):
            reqs, feats = mb.next_batch()
            t1 = time.perf_counter()
            u = union(feats["sparse"].numpy())
            rb = runtime.rewrite(u)                  # host pipeline, v
        t2 = time.perf_counter()
        n_spans = len(tracer.records)
        event = runtime.end_batch()                  # may swap to v + 1
        t3 = time.perf_counter()
        if event is not None:
            spans = {k: sum(rec.dur_us for rec in tracer.records[n_spans:]
                            if rec.name == k) / 1e3
                     for k in ("migrate", "swap", "cache_install")}
            host_ms["replan"].append((t3 - t2) * 1e3 - spans["migrate"]
                                     - spans["swap"])
            host_ms["migrate"].append(spans["migrate"])
            host_ms["cache_install"].append(spans["cache_install"])
            checks["shapes_stable"] = checks["shapes_stable"] and stable()
            if checks["arrays_ok"] is None:
                check_swap(u, feats["dense"])
            host_ms["check_swap"].append((time.perf_counter() - t3) * 1e3)
            slo_lane.on_swap(runtime)
        t4 = time.perf_counter()
        # the in-flight batch resolves against ITS version's cache table,
        # even when the swap above just retired it from "current"
        with tracer.span("device_step", batch=len(scores),
                         cache_version=rb.version):
            b = on_device(rb, feats["dense"])
            t = runtime.table
            p = {**params, "emb_packed": t.packed}
            out, r = serve(p, t.remap_bank, t.remap_slot,
                           runtime.cache_table_for(rb.version), b,
                           remap_flat=t.remap_flat)
            r = r.cpu().numpy()                      # waits for the step
        t5 = time.perf_counter()
        mb.complete(reqs)
        slo_lane.after_step(len(scores), r, (t5 - t4) * 1e6, batch,
                            p99_ms=mb.p99() * 1e3)
        if writer is not None:
            writer.maybe_write(len(scores) + 1)
        scores.append(out[:len(reqs)])
        reads.append(r.astype(np.int64))
        rewritten.append((rb.cache_idx, rb.residual_idx, rb.version))
        unions.append(u)
        last.update(b)
        for k, v in zip(("next_batch", "rewrite", "end_batch", "serve"),
                        (t1 - t0, t2 - t1, t3 - t2, t5 - t4)):
            host_ms[k].append(v * 1e3)

    t0 = time.monotonic()
    for rid in range(requests):
        mb.submit(Request(rid=rid, features=feats_of[rid]))
        if len(mb.queue) >= batch:
            run_batch()
    while mb.ready():
        run_batch()
    serve_s = time.monotonic() - t0

    if probe:
        t = runtime.table
        p = {**params, "emb_packed": t.packed}
        b = on_device(probe["rb"], probe["dense"])
        swapped = serve(p, t.remap_bank, t.remap_slot, probe["table"], b,
                        remap_flat=t.remap_flat)[0]
        fresh = serve(p, t.remap_bank, t.remap_slot, probe["fresh"], b,
                      remap_flat=t.remap_flat)[0]
        checks["outputs_ok"] = bool(torch.equal(swapped, fresh))
    rp = runtime.replanner
    stats.update(swaps=len(runtime.swaps), replans=rp.n_replans,
                 skipped_replans=rp.n_skipped_replans,
                 initial_imbalance=plan.imbalance(), rows_per_bank=cap,
                 cache_capacity=runtime.cache_plan.capacity,
                 cache_entries=runtime.cache_plan.n_entries,
                 cache_version=runtime.rewriter.version,
                 hit_rate=_served_hit_rate(unions, rewritten))
    res = CachedAdaptiveServeResult(
        scores=torch.cat(scores) if scores else torch.empty(0, device=dev),
        latencies=mb.latencies,
        p50_ms=empirical_p50(mb.latencies) * 1e3,
        p99_ms=empirical_p99(mb.latencies) * 1e3,
        serve_s=serve_s,
        params={**params, "emb_packed": runtime.table.packed},
        statics=statics, last_batch=last, swaps=list(runtime.swaps),
        rewritten=rewritten, unions=unions, reads=reads, runtime=runtime,
        checks=checks,
        host_ms=host_ms, stats=stats, swap_probe=probe,
        slo_events=slo_lane.events)
    if min_swaps > 0:
        ok = (len(runtime.swaps) >= min_swaps and checks["shapes_stable"]
              and checks["arrays_ok"] is True
              and checks["outputs_ok"] is True)
        if not ok:
            raise SystemExit(
                f"cached adaptive serve contract violated: swaps="
                f"{len(runtime.swaps)} (need >= {min_swaps}), shapes stable="
                f"{checks['shapes_stable']}, parity={checks['arrays_ok']}/"
                f"{checks['outputs_ok']}")
    slo_lane.check_contract(min_slo_breaches)
    return res


@dataclasses.dataclass
class FaultServeResult(AdaptiveServeResult):
    """``run_fault``'s result: an ``AdaptiveServeResult`` (``swaps`` holds
    every swap in order: recoveries, the straggler replan and drift swaps;
    ``reads`` the served reads, a dead bank's excluded) plus the fault
    lane's record."""
    degraded: list[np.ndarray]  # per batch: (batch,) degraded reads a request
    lookups: list[int]          # per batch: its valid (row >= 0) lookups
    live: list[np.ndarray]      # per batch: the (banks,) live mask served
    fired: list[tuple]          # (batch, FaultEvent), in schedule order
    recoveries: list[SwapEvent]     # the recovery replans, in order
    stragglers: list[int]       # batches the StragglerWatchdog flagged
    never_failed: BankedTable   # version 0 on the device (the reference)
    probes: list[dict]          # the confinement-checked batches: batch,
                                # feats, live, counts, scores, the table and
                                # plan served


def run_fault(spec, cfg, *, requests: int, batch: int,
              faults: list[str] | tuple[str, ...] = (), banks: int = 8,
              replan_every: int = 8, capacity_slack: float = 0.25,
              drift_rotate_every: int = 512, hysteresis: float = 0.0,
              straggler_factor: float = 3.0, min_recoveries: int = 0,
              seed: int = 0, device: str | torch.device | None = "cuda",
              backend: str = "auto", params: dict | None = None,
              slo: SLOConfig | None = None, min_slo_breaches: int = 0,
              tracer: Tracer | None = None,
              metrics: MetricRegistry | None = None,
              writer: PeriodicMetricsWriter | None = None
              ) -> FaultServeResult:
    """The reference's fault-tolerant serve loop (``launch/serve.py
    _main_adaptive_fault``, ``--adaptive --inject-bank-failure``): the
    adaptive loop of ``run_adaptive`` (same set-up and Zipf(1.05) request
    stream) under the per-bank fault schedule ``faults`` (specs
    ``BATCH:BANK[:STATE[:FACTOR]]``, ``dist.bank_fault``).

    Each batch: ``fault.advance(batch)`` (every fired event counted in
    ``fault.injected_total`` and marked by a ``fault_injected`` instant);
    the degraded serve step with the live table's remaps and the live mask
    on the device as ARGUMENTS, returning scores, degraded reads a request
    and the served per-bank reads; ``serve.degraded_reads_total`` and
    ``serve.degraded_batches_total``; the SLO lane (as ``run_adaptive``'s).
    On the first two degraded batches the requests with no degraded read
    must score bit for bit as the never-failed run (confinement); the first
    clean batch after a recovery must equal it in full (recovery parity).
    The never-failed run is the same step on version 0's table and remaps
    (kept on the device) with every bank live. Then one lane: when the dead
    set changed, ``runtime.on_bank_failure(live)`` (a revival goes through
    it too); else the straggler lane — the modeled per-bank time
    ``bincount(plan.bank_of_row[rows]) * slow_factor`` of the batch into
    ``StragglerWatchdog(straggler_factor).observe``, and on the first flag
    ``runtime.on_straggler`` with the slow bank's factor as its penalty;
    else ``runtime.end_batch()``.

    ``min_recoveries > 0`` raises ``SystemExit`` unless at least that many
    recoveries happened, confinement held, recovery parity is True and
    every swapped table kept version 0's shapes, dtypes and device;
    ``min_slo_breaches > 0`` unless that many SLO breaches reached the
    replanner. Raises when ``device`` is CUDA and there is none."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    dev = resolve_device(device)
    V = cfg.total_vocab
    cap = bank_capacity(V, banks, capacity_slack)
    offs = cfg.field_offsets()
    stats: dict = {}
    clock = [time.perf_counter()]

    def lap(name):
        now = time.perf_counter()
        stats[f"{name}_s"] = now - clock[0]
        clock[0] = now

    fault = BankFaultState.from_specs(banks, list(faults))
    plan = non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
    lap("plan")
    params, statics = _adaptive_weights(cfg, plan, cap, banks, seed, dev,
                                        params)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    lap("init_params")
    tracer, metrics = _obs_defaults(tracer, metrics)
    m_deg_reads = metrics.counter("serve.degraded_reads_total",
                                  "bounded-degraded row reads served")
    m_deg_batches = metrics.counter("serve.degraded_batches_total",
                                    "micro-batches with >0 degraded reads")
    m_faults = metrics.counter("fault.injected_total",
                               "bank-fault schedule events fired")
    table = BankedTable(packed=params["emb_packed"],
                        remap_bank=statics["remap_bank"],
                        remap_slot=statics["remap_slot"], n_banks=banks,
                        rows_per_bank=cap, remap_flat=statics["remap_flat"])
    rcfg = ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                  check_every=replan_every,
                                  hysteresis=hysteresis)
    runtime = AdaptiveEmbeddingRuntime(table, plan, rcfg,
                                       init_freq=np.ones(V),
                                       tracer=tracer, metrics=metrics)
    watchdog = StragglerWatchdog(factor=straggler_factor, metrics=metrics)
    lap("runtime")
    serve = build_recsys_serve_degraded_adaptive(dlrm, cfg, statics,
                                                 backend=backend,
                                                 with_traffic=True)
    all_live = torch.ones(banks, dtype=torch.bool, device=dev)
    row_nbytes = cfg.embed_dim * params["emb_packed"].element_size()
    slo_lane = _TrafficSLO(slo or SLOConfig(), metrics, tracer, banks=banks,
                           dim=cfg.embed_dim, row_nbytes=row_nbytes,
                           runtime=runtime)
    table0 = runtime.table         # never-failed reference: version 0

    host_ms = {"next_batch": [], "observe": [], "serve": [], "lane": [],
               "never_failed": [], "recovery": [], "straggler": []}
    host_feats: dict = {}

    def observe(feats, n_real):
        t0 = time.perf_counter()
        host_feats.update(feats)
        runtime.observe_batch(rows_from_sparse(feats["sparse"][:n_real],
                                               offs))
        host_ms["observe"].append((time.perf_counter() - t0) * 1e3)

    pad, feats_of = _drifting_requests(
        cfg, zipf_a=1.05, drift_rotate_every=drift_rotate_every, seed=seed,
        n=requests)
    lap("draw_requests")

    mb = MicroBatcher(batch, pad, device=dev, observer=observe,
                      metrics=metrics)
    scores: list[torch.Tensor] = []
    reads: list[np.ndarray] = []
    degraded: list[np.ndarray] = []
    lookups: list[int] = []
    lives: list[np.ndarray] = []
    fired: list[tuple] = []
    recoveries: list[SwapEvent] = []
    probes: list[dict] = []
    checks = {"shapes_stable": True, "confine_ok": True,
              "recover_parity": None}
    st = {"handled_dead": frozenset(), "penalized": False,
          "fail_batch": None, "recover_batch": None}
    last: dict = {}

    def never_failed(feats):
        t0 = time.perf_counter()
        p0 = {**params, "emb_packed": table0.packed}
        out = serve(p0, table0.remap_bank, table0.remap_slot, all_live,
                    feats, remap_flat=table0.remap_flat)[0]
        host_ms["never_failed"].append((time.perf_counter() - t0) * 1e3)
        return out

    def after_swap():
        t = runtime.table
        checks["shapes_stable"] = checks["shapes_stable"] and all(
            _same_tensor_layout(getattr(t, f), getattr(table0, f))
            for f in ("packed", "remap_bank", "remap_slot", "remap_flat"))
        slo_lane.on_swap(runtime)

    def run_batch():
        b = len(scores)
        for e in fault.advance(b):
            m_faults.inc()
            tracer.instant("fault_injected", batch=b, event=str(e))
            fired.append((b, e))
            if st["fail_batch"] is None and fault.dead_banks():
                st["fail_batch"] = b
        live = fault.live_mask()
        t0 = time.perf_counter()
        with tracer.span("rewrite"):
            reqs, feats = mb.next_batch()
        t1 = time.perf_counter()
        with tracer.span("device_step", batch=b):
            t = runtime.table
            p = {**params, "emb_packed": t.packed}
            out, counts, r = serve(p, t.remap_bank, t.remap_slot,
                                   torch.from_numpy(live).to(dev), feats,
                                   remap_flat=t.remap_flat)
            r, counts = r.cpu().numpy(), counts.cpu().numpy()  # waits
        t2 = time.perf_counter()
        mb.complete(reqs)
        slo_lane.after_step(b, r, (t2 - t1) * 1e6, batch,
                            p99_ms=mb.p99() * 1e3)
        scores.append(out[:len(reqs)])
        reads.append(r.astype(np.int64))
        degraded.append(counts)
        lookups.append(int((host_feats["sparse"] >= 0).sum()))
        lives.append(live)
        last.update(feats)
        if writer is not None:
            writer.maybe_write(len(scores))
        n_deg = int(counts.sum())
        m_deg_reads.inc(n_deg)
        if n_deg > 0:
            m_deg_batches.inc()
            # confinement: requests that read NO dead-bank row score bit
            # for bit as the never-failed run, mid-failure included
            if len(probes) < 2:
                clean = torch.from_numpy(counts == 0).to(dev)
                ref = never_failed(feats)
                ok = (torch.equal(out[clean], ref[clean])
                      and bool((counts > 0).any()))
                checks["confine_ok"] = checks["confine_ok"] and ok
                probes.append(dict(batch=b, feats=feats, live=live,
                                   counts=counts, scores=out, table=t,
                                   plan=runtime.plan, clean_ok=ok))
        elif st["recover_batch"] is None and st["fail_batch"] is not None \
                and st["handled_dead"]:
            # the first clean batch after the recovery swap: full parity
            st["recover_batch"] = b
            checks["recover_parity"] = torch.equal(out, never_failed(feats))
        t3 = time.perf_counter()

        # recovery lane: any not-yet-handled change of the dead set replans
        dead = frozenset(fault.dead_banks())
        if dead != st["handled_dead"]:
            recoveries.append(runtime.on_bank_failure(live))
            st["handled_dead"] = dead
            host_ms["recovery"].append((time.perf_counter() - t3) * 1e3)
            after_swap()
        else:
            # straggler lane: modeled per-bank batch time (reads x slow
            # factor; banks run in parallel, so the slowest bank's time)
            sf = fault.slow_factor()
            rows = rows_from_sparse(host_feats["sparse"], offs)
            t_bank = np.bincount(runtime.plan.bank_of_row[rows[rows >= 0]],
                                 minlength=banks).astype(np.float64) * sf
            if watchdog.observe(b, float(t_bank.max())) \
                    and not st["penalized"]:
                slow = int(np.argmax(t_bank))
                pen = np.ones(banks)
                pen[slow] = float(max(sf[slow], 1.0))
                runtime.on_straggler(pen)
                st["penalized"] = True
                host_ms["straggler"].append(
                    (time.perf_counter() - t3) * 1e3)
                after_swap()
            elif runtime.end_batch() is not None:   # ordinary drift lane
                after_swap()
        for k, v in zip(("next_batch", "serve", "lane"),
                        (t1 - t0, t2 - t1, time.perf_counter() - t3)):
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
    n_rec = sum(e.reason == "bank_failure" for e in recoveries)
    stats.update(swaps=len(runtime.swaps), replans=rp.n_replans,
                 skipped_replans=rp.n_skipped_replans,
                 initial_imbalance=plan.imbalance(), rows_per_bank=cap,
                 faults_fired=len(fired), recoveries=n_rec,
                 straggler_events=len(watchdog.events),
                 degraded_reads=int(sum(c.sum() for c in degraded)),
                 degraded_batches=sum(bool(c.any()) for c in degraded),
                 fail_batch=st["fail_batch"],
                 recover_batch=st["recover_batch"],
                 slo_breaches=slo_lane.breaches,
                 slo_penalties=slo_lane.penalties)
    res = FaultServeResult(
        scores=torch.cat(scores) if scores else torch.empty(0, device=dev),
        latencies=mb.latencies,
        p50_ms=empirical_p50(mb.latencies) * 1e3,
        p99_ms=empirical_p99(mb.latencies) * 1e3,
        serve_s=serve_s,
        params={**params, "emb_packed": runtime.table.packed},
        statics=statics, last_batch=last, swaps=list(runtime.swaps),
        reads=reads, nbytes=[r * row_nbytes for r in reads],
        runtime=runtime, checks=checks, host_ms=host_ms, stats=stats,
        slo_events=slo_lane.events, degraded=degraded, lookups=lookups,
        live=lives, fired=fired, recoveries=recoveries,
        stragglers=list(watchdog.events), never_failed=table0,
        probes=probes)
    if min_recoveries > 0:
        ok = (n_rec >= min_recoveries and checks["shapes_stable"]
              and checks["confine_ok"] and checks["recover_parity"] is True)
        if not ok:
            raise SystemExit(
                f"fault-serve contract violated: recoveries={n_rec} (need "
                f">= {min_recoveries}), shapes stable="
                f"{checks['shapes_stable']}, confinement="
                f"{checks['confine_ok']}, recovery parity="
                f"{checks['recover_parity']}")
    slo_lane.check_contract(min_slo_breaches)
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
                    help="adaptive replanner: plain banked (§3.2), or the "
                         "cache-aware lane (§3.3: every batch rewritten on "
                         "the host, live GRACE cache-table swaps; "
                         "run_cached_adaptive)")
    ap.add_argument("--cache-entries", type=int, default=128,
                    help="TOTAL cache-entry capacity across banks "
                         "(cache_aware; fixed for the life of the server)")
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
                    help="hot-row replication on the adaptive path "
                         "(non_uniform, full precision): up to this many "
                         "copies of the telemetry-chosen hottest rows on "
                         "distinct banks, a per-bag hash splitting their "
                         "reads (run_replicated). 1 = off")
    ap.add_argument("--replicate-max-r", type=int, default=64,
                    help="cap on the replicated rows per plan (further "
                         "clamped so the copies fit the fixed capacity)")
    ap.add_argument("--inject-bank-failure", action="append", default=[],
                    metavar="BATCH:BANK[:STATE[:FACTOR]]",
                    help="fault-tolerant serving lane (--adaptive, "
                         "non_uniform; run_fault): kill bank BANK at "
                         "micro-batch BATCH (state 'dead', the default), "
                         "slow it (state 'degraded', FACTOR x), or revive it "
                         "('healthy'). Repeatable. Serving continues with "
                         "bounded-degraded reads; recovery re-packs the dead "
                         "bank's rows onto the survivors")
    ap.add_argument("--straggler-factor", type=float, default=3.0,
                    help="StragglerWatchdog threshold: a micro-batch whose "
                         "modeled bank time exceeds this multiple of the "
                         "running median flags its slowest bank, feeding a "
                         "latency penalty into the planner")
    ap.add_argument("--min-recoveries", type=int, default=0,
                    help="exit non-zero unless at least this many "
                         "bank-failure recoveries happened and the fault "
                         "checks held (confinement, recovery parity, shapes "
                         "stable)")
    ap.add_argument("--slo-p99-us", type=float, default=0.0,
                    help="SLO watchdog (--adaptive): breach when the "
                         "rolling-window p99 of the measured device-step "
                         "wall time exceeds this budget (microseconds; 0 = "
                         "off); a breach pushes a hot-bank penalty into the "
                         "replanner")
    ap.add_argument("--slo-max-share", type=float, default=0.0,
                    help="SLO watchdog: breach when the window-mean "
                         "MEASURED max-bank read share exceeds this fraction "
                         "(0 = off; 1/banks is perfect balance)")
    ap.add_argument("--slo-divergence", type=float, default=0.0,
                    help="SLO watchdog: breach when the realized modeled "
                         "latency (hwmodel at MEASURED bank shares) exceeds "
                         "the plan-time projection by this relative margin "
                         "(0 = off)")
    ap.add_argument("--slo-window", type=int, default=16,
                    help="micro-batches per SLO evaluation window (also the "
                         "per-check cooldown after a breach)")
    ap.add_argument("--min-slo-breaches", type=int, default=0,
                    help="exit non-zero unless at least this many SLO "
                         "breaches were detected and the replanner received "
                         "the hot-bank penalty")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    spec = get_arch(args.arch)
    cfg = spec.reduced
    if args.adaptive:
        _main_adaptive(args, spec, cfg)
        return
    tracer, metrics, writer = setup_obs(args, label=f"serve:{args.arch}")
    res = run(spec, cfg, requests=args.requests, batch=args.batch,
              seed=args.seed, device=args.device, backend=args.backend,
              tracer=tracer, metrics=metrics, writer=writer)
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms")
    finalize_obs(args, tracer, metrics, writer, latencies=res.latencies)


def _main_adaptive(args, spec, cfg) -> None:
    """``main --adaptive``: the reference's guards on the fault and replica
    lanes refuse as there; the fault lane runs ``run_fault``, the plain and
    tiered lanes ``run_adaptive``, the replica lane ``run_replicated``, the
    cache lane ``run_cached_adaptive``; every lane with the SLO lane and
    the ``--trace-out`` / ``--metrics-out`` exports."""
    if args.inject_bank_failure:
        if args.partition != "non_uniform":
            raise SystemExit("--inject-bank-failure rides the non_uniform "
                             "adaptive path (cache_aware recovery packing is "
                             "not wired, as in the reference)")
        if args.quant != "off":
            raise SystemExit("--inject-bank-failure serves the "
                             "full-precision path")
        if args.replicate_k_max > 1:
            raise SystemExit("--inject-bank-failure x --replicate-k-max in "
                             "one run is not wired (as in the reference)")
    if args.replicate_k_max > 1:
        if args.partition != "non_uniform":
            raise SystemExit("--replicate-k-max rides the non_uniform "
                             "adaptive path (cache_aware entry placement "
                             "has no replica axis)")
        if args.quant != "off":
            raise SystemExit("--replicate-k-max serves the full-precision "
                             "path; the dequant+replica-select kernel is "
                             "not wired (as in the reference)")
    if args.partition == "cache_aware" and args.quant != "off":
        raise SystemExit("--partition cache_aware serves the full-precision "
                         "fused cache + residual path; --quant is the "
                         "non_uniform lane's")
    if args.inject_bank_failure:
        lane, label = _main_fault, f"serve-fault:{args.arch}"
    elif args.replicate_k_max > 1:
        lane = _main_replicated
        label = f"serve-replicated:{args.arch}:k={args.replicate_k_max}"
    elif args.partition == "cache_aware":
        lane, label = _main_cached, f"serve-cached:{args.arch}"
    else:
        lane = _main_plain_adaptive
        label = f"serve-adaptive:{args.arch}:quant={args.quant}"
    tracer, metrics, writer = setup_obs(args, label=label)
    obs = dict(slo=SLOConfig(p99_us=args.slo_p99_us,
                             max_share=args.slo_max_share,
                             divergence=args.slo_divergence,
                             window=args.slo_window),
               min_slo_breaches=args.min_slo_breaches,
               tracer=tracer if args.trace_out else None, metrics=metrics,
               writer=writer)
    try:
        res = lane(args, spec, cfg, obs)
    except SystemExit:
        finalize_obs(args, tracer, metrics, writer)   # exports, then fails
        raise
    for e in res.slo_events:
        print(f"  [slo breach @batch {e['batch']}] {e['kind']}: "
              f"{e['value']:.1f} > {e['threshold']:.1f} (hot bank "
              f"{e['bank']}, penalty x{e['penalty']:.2f} -> replanner)")
    print(f"slo lane: {len(res.slo_events)} breach(es) over "
          f"{len(res.reads)} measured batch(es)")
    finalize_obs(args, tracer, metrics, writer, latencies=res.latencies)


def _main_plain_adaptive(args, spec, cfg, obs) -> AdaptiveServeResult:
    """``main --adaptive`` (the remap and tier lanes): ``run_adaptive`` and
    the reference launcher's report."""
    res = run_adaptive(
        spec, cfg, requests=args.requests, batch=args.batch,
        quant=args.quant, banks=args.banks, replan_every=args.replan_every,
        capacity_slack=args.capacity_slack,
        drift_rotate_every=args.drift_rotate_every,
        hysteresis=args.hysteresis,
        quant_byte_budget=args.quant_byte_budget,
        quant_hot_rows=args.quant_hot_rows, min_swaps=args.min_swaps,
        seed=args.seed, device=args.device, backend=args.backend, **obs)
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
    return res


def _main_fault(args, spec, cfg, obs) -> FaultServeResult:
    """``main --adaptive --inject-bank-failure ...``: ``run_fault`` and the
    reference launcher's report."""
    res = run_fault(
        spec, cfg, requests=args.requests, batch=args.batch,
        faults=args.inject_bank_failure, banks=args.banks,
        replan_every=args.replan_every, capacity_slack=args.capacity_slack,
        drift_rotate_every=args.drift_rotate_every,
        hysteresis=args.hysteresis, straggler_factor=args.straggler_factor,
        min_recoveries=args.min_recoveries, seed=args.seed,
        device=args.device, backend=args.backend, **obs)
    for b, e in res.fired:
        print(f"  [fault @batch {b}] {e}")
    for p in res.probes:
        n = int((p["counts"] > 0).sum())
        print(f"  [degraded @batch {p['batch']}] {int(p['counts'].sum())} "
              f"degraded reads, {n}/{len(p['counts'])} requests; clean "
              f"requests bit-exact: {p['clean_ok']}")
    for e in res.swaps:
        extra = (f" recovery={e.recovery_s * 1e3:.1f}ms"
                 if e.reason == "bank_failure" else "")
        print(f"  [{e.reason} swap, runtime batch clock {e.batch}]{extra} "
              f"imbalance {e.old_imbalance:.3f} -> {e.new_imbalance:.3f}")
    rp, st, ck = res.runtime.replanner, res.stats, res.checks
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms  replans={rp.n_replans} "
          f"skipped={rp.n_skipped_replans}")
    print(f"fault lane: {st['faults_fired']} fault(s) fired, "
          f"{st['degraded_reads']} degraded reads over "
          f"{st['degraded_batches']} batch(es), {st['recoveries']} recovery "
          f"replan(s), {st['straggler_events']} straggler event(s); "
          f"confinement {'OK' if ck['confine_ok'] else 'VIOLATED'}, "
          f"recovery parity {ck['recover_parity']}, shapes stable "
          f"{ck['shapes_stable']}")
    return res


def _main_cached(args, spec, cfg, obs) -> CachedAdaptiveServeResult:
    """``main --adaptive --partition cache_aware``: ``run_cached_adaptive``
    and the reference launcher's report."""
    res = run_cached_adaptive(
        spec, cfg, requests=args.requests, batch=args.batch, banks=args.banks,
        replan_every=args.replan_every, capacity_slack=args.capacity_slack,
        cache_entries=args.cache_entries,
        drift_rotate_every=args.drift_rotate_every,
        hysteresis=args.hysteresis, min_swaps=args.min_swaps,
        seed=args.seed, device=args.device, backend=args.backend, **obs)
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] {e.update.report} imbalance "
              f"{e.old_imbalance:.3f} -> {e.new_imbalance:.3f}  cache "
              f"v{e.cache_version} entries {e.cache_entries} (dropped "
              f"{e.cache_dropped})")
    rp, st, ck = res.runtime.replanner, res.stats, res.checks
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms  replans={rp.n_replans} "
          f"skipped={rp.n_skipped_replans} swaps={st['swaps']}  cache "
          f"entries={st['cache_entries']} hit rate {st['hit_rate']:.4f}")
    print(f"swap parity: arrays {'OK' if ck['arrays_ok'] else 'n/a'}, "
          f"outputs {'OK' if ck['outputs_ok'] else 'n/a'}; shapes stable: "
          f"{ck['shapes_stable']}")
    return res


def _main_replicated(args, spec, cfg, obs) -> AdaptiveServeResult:
    """``main --adaptive --replicate-k-max K``: ``run_replicated`` and the
    reference launcher's report."""
    res = run_replicated(
        spec, cfg, requests=args.requests, batch=args.batch,
        k_max=args.replicate_k_max, max_r=args.replicate_max_r,
        banks=args.banks, replan_every=args.replan_every,
        capacity_slack=args.capacity_slack,
        drift_rotate_every=args.drift_rotate_every,
        hysteresis=args.hysteresis, min_swaps=args.min_swaps,
        seed=args.seed, device=args.device, backend=args.backend, **obs)
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] {e.update.report} imbalance "
              f"{e.old_imbalance:.3f} -> {e.new_imbalance:.3f}  replicas v"
              f"{e.replica_version} hot={e.replica_hot_rows} "
              f"churn={e.replica_copy_churn}")
    rp, st = res.runtime.replanner, res.stats
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms  replans={rp.n_replans} "
          f"skipped={rp.n_skipped_replans}")
    print(f"replica lane: v{st['replica_version']}, "
          f"{st['replicated_rows']} replicated row(s) (k_max {st['k_max']}),"
          f" modeled max-bank share {st['modeled_max_share']:.4f} vs ideal "
          f"{st['ideal_share']:.4f}; shapes stable: "
          f"{res.checks['shapes_stable']}  re-pack parity: "
          f"{res.checks['repack_ok']}")
    return res


if __name__ == "__main__":
    main()
