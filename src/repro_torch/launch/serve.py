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
after its first cache swap, with no further swaps (the adaptive loop is a
later slice).
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
                                           cache_aware_partition)
from repro_torch.data import synthetic as syn
from repro_torch.kernels.embedding_bag import effective_lengths
from repro_torch.models import dlrm
from repro_torch.obs.metrics import empirical_p50, empirical_p99
from repro_torch.serve.serve_step import (MicroBatcher, Request,
                                          build_recsys_serve,
                                          build_recsys_serve_cached)
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
    ap.add_argument("--adaptive", action="store_true",
                    help="the adaptive repartitioning loop (not ported yet; "
                         "its cache-aware path without swaps is "
                         "run_cached)")
    args = ap.parse_args(argv)
    if args.adaptive:
        raise NotImplementedError(
            "--adaptive (telemetry, replanning and live swaps) is not ported "
            "yet: ROADMAP queue 1 #10. launch.serve.run_cached serves its "
            "cache-aware path as it stands after the first swap")
    spec = get_arch(args.arch)
    cfg = spec.reduced
    res = run(spec, cfg, requests=args.requests, batch=args.batch,
              seed=args.seed, device="cuda", backend=args.backend)
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms")


if __name__ == "__main__":
    main()
