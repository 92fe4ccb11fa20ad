"""The recsys serve steps, the LM prefill and decode steps, and a
micro-batching request queue (the port of ``repro/serve/serve_step.py``'s
plain, cache-aware and adaptive paths: the remap, cache, tier, replica and
fault lanes; retrieval's top-k; ``build_lm_decode`` and
``build_lm_prefill``).

The recsys serve path is the paper's object of study: p99-latency online
inference over micro-batches of CTR requests.

Every builder takes ``dist`` (a ``DistCtx``): the params then hold this
rank's bank shard, a batch is the rank's dp slice and so are the scores;
the per-bank counts a step returns are summed over dp (the global
batch's), the per-request degraded counts stay the rank's own.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.obs.metrics import MetricRegistry, empirical_p99
from repro_torch.obs.tracing import stage


def build_recsys_serve(family_mod, cfg, statics, dist=None,
                       backend: str | None = None):
    """CTR scoring: forward + sigmoid, under ``torch.inference_mode``; a
    call is the stage span ``serve.step``.

    ``backend`` selects the kernels or their plain versions for families
    that expose the knob (dlrm: 'auto' | 'torch' | 'cuda' | 'tuned'); None
    keeps the family default.
    """
    kw = {} if backend is None else {"backend": backend}

    def serve(params, batch):
        with stage("serve.step", like=batch), torch.inference_mode():
            logits = family_mod.forward(cfg, params, statics, batch, dist,
                                        **kw)
            return torch.sigmoid(logits)
    return serve


def build_recsys_serve_cached(family_mod, cfg, statics, cache_table,
                              dist=None, backend: str | None = None):
    """Cache-aware CTR scoring (Fig. 7), under ``torch.inference_mode``:
    requests pre-rewritten into (``cache_idx``, ``residual_idx``) bags by
    the host pipeline, scored through ``family_mod.forward_cached`` against
    ``cache_table``."""
    kw = {} if backend is None else {"backend": backend}

    def serve(params, batch):
        with torch.inference_mode():
            logits = family_mod.forward_cached(cfg, params, statics,
                                               cache_table, batch, dist, **kw)
            return torch.sigmoid(logits)
    return serve


def top_k_lowest_first(scores: torch.Tensor, k: int
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, int32 indices) of the ``k`` largest ``scores``, ties broken
    toward the lower index as ``jax.lax.top_k`` breaks them (a stable
    descending sort: ``torch.topk`` makes no promise about ties)."""
    if not 0 <= k <= scores.shape[-1]:
        raise ValueError(f"top_k {k} outside [0, {scores.shape[-1]}]")
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k].to(torch.int32)


def build_lm_decode(cfg, dist=None, seq_axes=("bank",)):
    """``serve(params, cache, token) -> (logits, cache)``: one
    ``transformer.decode_step`` under ``torch.inference_mode``."""
    from repro_torch.models.transformer import decode_step

    def serve(params, cache, token):
        with torch.inference_mode():
            return decode_step(cfg, params, cache, token, dist,
                               seq_axes=seq_axes)
    return serve


def build_lm_prefill(cfg, dist=None, s_max: int | None = None):
    """``serve(params, tokens) -> logits`` (with ``s_max``: ``(logits,
    cache)``, the prompt's KV cache to decode from):
    ``transformer.prefill`` under ``torch.inference_mode``."""
    from repro_torch.models.transformer import prefill

    def serve(params, tokens):
        with torch.inference_mode():
            return prefill(cfg, params, tokens, dist, s_max=s_max)
    return serve


def build_retrieval_serve(family_mod, cfg, statics, dist=None,
                          top_k: int = 128, backend: str | None = None):
    """1 query x N candidates -> (top-k scores, top-k candidate indices),
    under ``torch.inference_mode``: ``family_mod.retrieval_scores`` (logits)
    then ``top_k_lowest_first``. ``backend`` as ``build_recsys_serve``'s.

    ``dist``: the batch (the query and its ``candidates`` (N,)) is the
    same on every rank; each rank scores its piece of the candidates and
    every rank returns the top k of all N, ties lowest index first, as one
    device does (``dist.collectives.global_top_k``). A family without a
    candidate list (BERT4Rec's full catalog, or a per-user slate) scores
    it whole on every rank."""
    from repro_torch.dist.collectives import global_top_k
    kw = {} if backend is None else {"backend": backend}

    def serve(params, batch):
        with torch.inference_mode():
            scores = family_mod.retrieval_scores(cfg, params, statics, batch,
                                                 dist, **kw)
            cand = batch.get("candidates")
            if dist is None or cand is None or cand.dim() != 1:
                return top_k_lowest_first(scores, top_k)
            return global_top_k(scores, top_k, dist, cand.shape[0])
    return serve


def _counts(dist, counts: torch.Tensor) -> torch.Tensor:
    return counts if dist is None else dist.dp_sum(counts)


def _rows(sparse: torch.Tensor, field_offsets: torch.Tensor) -> torch.Tensor:
    """Per-field ids (B, F) or (B, F, L) -> union-vocab rows, -1 kept."""
    offs = field_offsets[None, :] if sparse.dim() == 2 \
        else field_offsets[None, :, None]
    return torch.where(sparse >= 0, sparse + offs, -1)


def build_recsys_serve_adaptive(family_mod, cfg, statics, dist=None,
                                backend: str | None = None,
                                with_traffic: bool = False):
    """CTR scoring under the ADAPTIVE runtime's remap lane: the returned
    ``serve(params, remap_bank, remap_slot, batch, remap_flat=None)`` takes
    everything a live swap replaces as arguments — the packed rows ride in
    ``params['emb_packed']``, the remap vectors beside them — and closes
    over none of it, so a swap is a pure argument change. ``remap_flat``
    is the flat remap computed once with the remaps (the runtime's
    ``BankedTable.remap_flat``); None computes it anew.

    ``with_traffic=True`` returns ``(scores, bank_reads)``: the batch's
    measured per-bank row reads (obs/traffic.py).
    """
    from repro_torch.core.embedding import flat_remap
    from repro_torch.obs.traffic import bank_read_counts
    kw = {} if backend is None else {"backend": backend}

    def serve(params, remap_bank, remap_slot, batch, remap_flat=None):
        if remap_flat is None:
            remap_flat = flat_remap(remap_bank, remap_slot,
                                    statics["rows_per_bank"])
        st = {**statics, "remap_bank": remap_bank, "remap_slot": remap_slot,
              "remap_flat": remap_flat}
        with torch.inference_mode():
            scores = torch.sigmoid(family_mod.forward(cfg, params, st, batch,
                                                      dist, **kw))
            if not with_traffic:
                return scores
            rows = _rows(batch["sparse"], statics["field_offsets"])
            return scores, _counts(dist, bank_read_counts(
                remap_bank, rows, statics["n_banks"]))
    return serve


def build_recsys_serve_degraded_adaptive(family_mod, cfg, statics, dist=None,
                                         backend: str | None = None,
                                         with_traffic: bool = False):
    """CTR scoring that stays up through bank failures: the returned
    ``serve(params, remap_bank, remap_slot, bank_live, batch,
    remap_flat=None)`` takes the per-bank liveness mask ((n_banks,) bool)
    as ONE MORE swap-style argument next to the remap vectors — reads homed
    on a dead bank resolve to the zero row (core/embedding.py's
    bounded-degradation contract), and the step returns ``(scores,
    degraded_read_count)`` so every response carries exactly how many row
    contributions it is missing (0 = exact). With every bank live it scores
    bit for bit as ``build_recsys_serve_adaptive``'s step. ``remap_flat``
    is the flat remap computed once with the remaps; None computes it anew.

    ``with_traffic=True`` returns ``(scores, degraded_counts,
    bank_reads)``. Reads resolved to the zero row on a dead bank are NOT
    counted as bank traffic (the bank never served them), so
    ``bank_reads.sum() + degraded_counts.sum()`` equals the batch's valid
    lookups.
    """
    from repro_torch.core.embedding import degraded_row_counts, flat_remap
    from repro_torch.obs.traffic import bank_read_counts
    kw = {} if backend is None else {"backend": backend}

    def serve(params, remap_bank, remap_slot, bank_live, batch,
              remap_flat=None):
        if remap_flat is None:
            remap_flat = flat_remap(remap_bank, remap_slot,
                                    statics["rows_per_bank"])
        st = {**statics, "remap_bank": remap_bank, "remap_slot": remap_slot,
              "remap_flat": remap_flat}
        with torch.inference_mode():
            scores = torch.sigmoid(family_mod.forward(
                cfg, params, st, batch, dist, bank_live=bank_live, **kw))
            rows = _rows(batch["sparse"], statics["field_offsets"])
            counts = degraded_row_counts(remap_bank, bank_live, rows)
            if not with_traffic:
                return scores, counts
            return scores, counts, _counts(dist, bank_read_counts(
                remap_bank, rows, bank_live.shape[0], bank_live=bank_live))
    return serve


def build_recsys_serve_cached_adaptive(family_mod, cfg, statics, dist=None,
                                       backend: str | None = None,
                                       with_traffic: bool = False):
    """Cache-aware CTR scoring under the ADAPTIVE runtime's cache lane:
    everything a live swap replaces — the EMT remap vectors AND the GRACE
    cache table — is an argument of the returned ``serve(params,
    remap_bank, remap_slot, cache_table, batch, remap_flat=None)``, never a
    closure constant; the packed EMT rides in ``params['emb_packed']``.
    ``batch`` carries ``dense``, ``cache_idx`` and ``residual_idx``.
    ``remap_flat`` is the flat remap computed once with the remaps (the
    runtime's ``BankedTable.remap_flat``); None computes it anew.

    ``with_traffic=True`` returns ``(scores, bank_reads)``: a cache hit is
    one read on its entry's bank, a residual row one on its own
    (``cached_bank_read_counts``).
    """
    from repro_torch.obs.traffic import cached_bank_read_counts
    kw = {} if backend is None else {"backend": backend}

    def serve(params, remap_bank, remap_slot, cache_table, batch,
              remap_flat=None):
        with torch.inference_mode():
            scores = torch.sigmoid(family_mod.forward_cached(
                cfg, params, statics, cache_table, batch, dist,
                remap_bank=remap_bank, remap_slot=remap_slot,
                remap_flat=remap_flat, **kw))
            if not with_traffic:
                return scores
            return scores, _counts(dist, cached_bank_read_counts(
                cache_table.remap_bank, batch["cache_idx"], remap_bank,
                batch["residual_idx"], cache_table.n_banks))
    return serve


def build_recsys_serve_tiered_adaptive(family_mod, cfg, statics, dist=None,
                                       backend: str | None = None,
                                       with_traffic: bool = False):
    """CTR scoring over TIERED-precision embeddings under the adaptive
    runtime: the whole ``TieredTable`` — quantized payload, per-row scales,
    tier map AND the remap vectors — is an argument of the returned
    ``serve(params, tiered, batch)``. Its tensors' shapes depend only on
    (capacity, dim, hot dtype), never on the tier mix, so a live re-tier
    swap is a pure argument change.

    ``with_traffic=True`` returns ``(scores, bank_reads, bank_nbytes)``:
    bytes weight each read by its row's CURRENT tier width.
    """
    from repro_torch.core.embedding import tiered_traffic
    kw = {} if backend is None else {"backend": backend}

    def serve(params, tiered, batch):
        with torch.inference_mode():
            scores = torch.sigmoid(family_mod.forward(
                cfg, params, statics, batch, dist, tiered=tiered, **kw))
            if not with_traffic:
                return scores
            traffic = tiered_traffic(
                tiered, _rows(batch["sparse"], statics["field_offsets"]),
                dist)
            return scores, traffic.reads, traffic.nbytes
    return serve


def build_recsys_serve_replicated_adaptive(family_mod, cfg, statics,
                                           dist=None,
                                           backend: str | None = None,
                                           with_traffic: bool = False):
    """CTR scoring over HOT-ROW-REPLICATED embeddings under the adaptive
    runtime: the whole ``ReplicatedTable`` — the packed copies and the
    ``(vocab, k_max)`` maps — is an argument of the returned
    ``serve(params, replicated, bank_live, batch)``, whose shapes depend
    only on (vocab, k_max) and the fixed capacity, so a replica swap is a
    pure argument change. ``bank_live`` ((n_banks,) bool) composes the
    fault lane in: a surviving copy serves a dead bank's reads, and the
    step returns ``(scores, degraded_read_count)`` per request, a read
    counting as degraded only when EVERY copy of its row is dead.

    ``with_traffic=True`` returns ``(scores, degraded_counts,
    bank_reads)``: the measured per-bank reads, routed to the copy each
    bag reads (and its failover).
    """
    from repro_torch.core.embedding import degraded_row_counts
    from repro_torch.obs.traffic import replicated_bank_read_counts
    kw = {} if backend is None else {"backend": backend}

    def serve(params, replicated, bank_live, batch):
        with torch.inference_mode():
            scores = torch.sigmoid(family_mod.forward(
                cfg, params, statics, batch, dist, replicated=replicated,
                bank_live=bank_live, **kw))
            rows = _rows(batch["sparse"], statics["field_offsets"])
            counts = degraded_row_counts(replicated.remap_bank, bank_live,
                                         rows)
            if not with_traffic:
                return scores, counts
            return scores, counts, replicated_bank_read_counts(
                replicated.remap_bank, rows, bank_live.shape[0],
                k_max=replicated.k_max, bank_live=bank_live)
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
    feature key (one host-to-device copy each, not one per request).

    ``observer`` is the workload-telemetry tap: called as
    ``observer(feats, n_real)`` on every assembled batch with the HOST
    (numpy) features, before the copy, where ``n_real`` is the count of
    genuine (non-pad) requests — pad rows replicate a prototype request and
    must not be counted as traffic. ``metrics`` receives
    ``serve.requests_total`` and ``serve.request_latency_ms``.
    """

    def __init__(self, batch_size: int, pad_request: dict, *,
                 device: str | torch.device,
                 observer: Callable[[dict, int], None] | None = None,
                 metrics: MetricRegistry | None = None):
        self.batch_size = batch_size
        self.pad_request = pad_request
        self.device = torch.device(device)
        self.observer = observer
        self.queue: deque[Request] = deque()
        self.latencies: list[float] = []
        metrics = metrics if metrics is not None else MetricRegistry()
        self._m_requests = metrics.counter("serve.requests_total",
                                           "completed (non-pad) requests")
        self._m_latency = metrics.histogram(
            "serve.request_latency_ms", "arrival -> completion per request")

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def ready(self) -> bool:
        return len(self.queue) > 0

    def next_batch(self) -> tuple[list[Request], dict]:
        reqs = [self.queue.popleft()
                for _ in range(min(self.batch_size, len(self.queue)))]
        n_pad = self.batch_size - len(reqs)
        host = {}
        for key in self.pad_request:
            rows = [r.features[key] for r in reqs]
            rows += [self.pad_request[key]] * n_pad
            host[key] = np.stack([np.asarray(r) for r in rows])
        if self.observer is not None:
            self.observer(host, len(reqs))
        feats = {k: torch.from_numpy(v).to(self.device)
                 for k, v in host.items()}
        return reqs, feats

    def complete(self, reqs: list[Request]) -> None:
        now = time.monotonic()
        for r in reqs:
            lat = now - r.t_arrival
            self.latencies.append(lat)
            self._m_latency.observe(lat * 1e3)
        self._m_requests.inc(len(reqs))

    def p99(self) -> float:
        return empirical_p99(self.latencies)
