"""The recsys serve step and a micro-batching request queue (the port of
``repro/serve/serve_step.py``'s plain path).

The recsys serve path is the paper's object of study: p99-latency online
inference over micro-batches of CTR requests.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from repro_torch.obs.metrics import empirical_p99


def build_recsys_serve(family_mod, cfg, statics, dist=None,
                       backend: str | None = None):
    """CTR scoring: forward + sigmoid, under ``torch.inference_mode``.

    ``backend`` selects the kernels or their plain versions for families
    that expose the knob (dlrm: 'auto' | 'torch' | 'cuda'); None keeps the
    family default.
    """
    kw = {} if backend is None else {"backend": backend}

    def serve(params, batch):
        with torch.inference_mode():
            logits = family_mod.forward(cfg, params, statics, batch, dist,
                                        **kw)
            return torch.sigmoid(logits)
    return serve


@dataclasses.dataclass
class Request:
    rid: int
    features: dict
    t_arrival: float = dataclasses.field(default_factory=time.monotonic)


class MicroBatcher:
    """Collects requests into fixed-size batches (pad the tail with a
    prototype request) so the serve step sees one shape; tracks
    per-request latency.

    Batches are stacked on the host and copied to ``device`` once per
    feature key (one host-to-device copy each, not one per request). The
    reference also taps each batch for workload telemetry (``observer``) and
    feeds a metrics registry; those come with the adaptive-loop and
    observability slices (ROADMAP queue 1 #10 and #14).
    """

    def __init__(self, batch_size: int, pad_request: dict, *,
                 device: str | torch.device):
        self.batch_size = batch_size
        self.pad_request = pad_request
        self.device = torch.device(device)
        self.queue: deque[Request] = deque()
        self.latencies: list[float] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def ready(self) -> bool:
        return len(self.queue) > 0

    def next_batch(self) -> tuple[list[Request], dict]:
        reqs = [self.queue.popleft()
                for _ in range(min(self.batch_size, len(self.queue)))]
        feats = {}
        n_pad = self.batch_size - len(reqs)
        for key in self.pad_request:
            rows = [r.features[key] for r in reqs]
            rows += [self.pad_request[key]] * n_pad
            host = torch.from_numpy(np.stack([np.asarray(r) for r in rows]))
            feats[key] = host.to(self.device)
        return reqs, feats

    def complete(self, reqs: list[Request]) -> None:
        now = time.monotonic()
        for r in reqs:
            self.latencies.append(now - r.t_arrival)

    def p99(self) -> float:
        return empirical_p99(self.latencies)
