"""Serving CLI: ``python -m repro_torch.launch.serve --arch updlrm-paper``.

The port of the plain (non-adaptive) path of ``repro/launch/serve.py``:
simulates the paper's online-inference setup with the MicroBatcher — a
stream of requests, micro-batched scoring on the card, a p50/p99 latency
report. ``main`` parses the arguments and serves the arch's reduced config
on CUDA; ``run`` does the work for any config and device and returns the
scores and latencies.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.data import synthetic as syn
from repro_torch.models import dlrm
from repro_torch.obs.metrics import empirical_p50, empirical_p99
from repro_torch.serve.serve_step import (MicroBatcher, Request,
                                          build_recsys_serve)


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
    args = ap.parse_args(argv)
    spec = get_arch(args.arch)
    cfg = spec.reduced
    res = run(spec, cfg, requests=args.requests, batch=args.batch,
              seed=args.seed, device="cuda", backend=args.backend)
    print(f"served {len(res.latencies)} requests  p50={res.p50_ms:.2f}ms "
          f"p99={res.p99_ms:.2f}ms")


if __name__ == "__main__":
    main()
