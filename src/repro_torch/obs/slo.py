"""SLO watchdog: modeled-vs-measured breach detection over rolling windows.

Closes the observation loop the measured traffic counters
(``obs.traffic``) open: every batch feeds its measured per-bank reads
through ``hwmodel.embedding_stage_latency`` to get a *realized* modeled
latency — the paper's Eq.-1 cost priced at the bank shares the hardware
actually saw, not the shares the plan projected. Each full window the
watchdog compares three signals and fires a breach per violated check:

``p99``         empirical p99 of the measured wall-clock batch times (the
                tracer's ``device_step`` spans) over the SLO budget
``hot_bank``    measured max-bank read share over threshold — the plan's
                balance promise broken by real traffic
``divergence``  realized modeled latency vs the plan-time projection —
                the calibration drift signal (same batch, same cost model,
                only the shares differ)

A breach emits an instant into the Chrome trace (an alert marker on the
timeline), increments the ``obs.slo_breaches_*`` counter family, and
invokes ``on_breach`` — the serve loop uses that hook to push a hot-bank
``bank_cost`` penalty into the ``Replanner``, so a measured imbalance
becomes a planning input instead of a log line. After firing, a check
cools down for one full window (deterministic: re-arms exactly ``window``
batches later), so tests and run contracts can count breaches exactly.

A copy of the reference's ``repro/obs/slo.py`` (numpy + ``core.hwmodel``
+ the registry): the watchdog runs host-side between micro-batches on
already-pulled counter values.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass

import numpy as np

from repro_torch.core.hwmodel import embedding_stage_latency
from repro_torch.obs.metrics import empirical_p99


@dataclass(frozen=True)
class SLOConfig:
    """Thresholds; 0 disables a check. ``window`` batches per evaluation."""

    p99_us: float = 0.0          # wall-clock p99 budget (us)
    max_share: float = 0.0       # measured max-bank read share ceiling
    divergence: float = 0.0      # realized/projected - 1 ceiling
    window: int = 16

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"slo window must be >= 1, got {self.window}")

    @property
    def enabled(self) -> bool:
        return (self.p99_us > 0 or self.max_share > 0
                or self.divergence > 0)


CHECKS = ("p99", "hot_bank", "divergence")


def hot_bank_penalty(reads, n_banks: int) -> np.ndarray:
    """Bank-cost multipliers from a measured read vector: the hottest bank
    pays its overload factor (measured share / ideal share, floored at 1),
    everyone else stays at 1 — the shape ``Replanner.set_bank_penalty``
    expects, same as the straggler path."""
    reads = np.asarray(reads, np.float64)
    pen = np.ones(n_banks)
    total = reads.sum()
    if total > 0:
        hot = int(np.argmax(reads))
        pen[hot] = max(1.0, float(reads[hot] / total) * n_banks)
    return pen


class SLOWatchdog:
    """Rolling-window breach detector over measured traffic + wall clock.

    Pre-registers the whole ``obs.slo_*`` family up front, so a run where
    nothing breaches still exports the counters at 0 (the snapshot's key
    set does not depend on what fired).
    """

    def __init__(self, cfg: SLOConfig, *, n_banks: int, dim: int,
                 metrics=None, tracer=None, on_breach=None, hw=None):
        self.cfg = cfg
        self.n_banks = int(n_banks)
        self.dim = int(dim)
        self.tracer = tracer
        self.on_breach = on_breach
        self.hw = hw
        self._window: deque = deque(maxlen=cfg.window)
        self._cooldown = {k: 0 for k in CHECKS}
        self._projected_share = 1.0 / self.n_banks
        self.breaches = 0
        self._m_total = self._m_kind = None
        self._g_realized = self._g_projected = self._g_share = None
        if metrics is not None:
            self._m_total = metrics.counter(
                "obs.slo_breaches_total", "SLO breaches detected (all checks)")
            self._m_kind = {
                "p99": metrics.counter(
                    "obs.slo_breaches_p99_total",
                    "wall-clock p99 over the SLO budget"),
                "hot_bank": metrics.counter(
                    "obs.slo_breaches_hot_bank_total",
                    "measured max-bank share over threshold"),
                "divergence": metrics.counter(
                    "obs.slo_breaches_divergence_total",
                    "realized modeled latency diverged from the projection"),
            }
            self._g_realized = metrics.gauge(
                "obs.slo_realized_latency_us",
                "modeled embedding-stage latency at MEASURED bank shares")
            self._g_projected = metrics.gauge(
                "obs.slo_projected_latency_us",
                "modeled embedding-stage latency at plan-PROJECTED shares")
            self._g_share = metrics.gauge(
                "obs.slo_projected_share",
                "plan-time projected max-bank share (updated on swaps)")
            self._g_share.set(self._projected_share)

    def set_projection(self, max_share: float) -> None:
        """Install the plan-time projected max-bank share (call at start
        and after every swap — the divergence check compares against the
        LIVE plan's promise)."""
        self._projected_share = float(max_share)
        if self._g_share is not None:
            self._g_share.set(self._projected_share)

    def _modeled_us(self, batch_size: int, total_reads: float,
                    max_share: float) -> float:
        avg_red = total_reads / max(batch_size, 1)
        kw = {} if self.hw is None else {"hw": self.hw}
        lat = embedding_stage_latency(
            batch_size=batch_size, avg_reduction=avg_red, n_c=self.dim,
            per_bank_lookup_share=[max_share], n_banks=self.n_banks, **kw)
        return float(lat.total) * 1e6

    def observe(self, batch: int, *, wall_us: float, reads,
                batch_size: int) -> list[str]:
        """Feed one batch; returns the breach kinds fired (usually [])."""
        reads = np.asarray(reads, np.float64)
        total = float(reads.sum())
        share = float(reads.max() / total) if total else 0.0
        realized = self._modeled_us(batch_size, total, share) if total else 0.0
        projected = (self._modeled_us(batch_size, total,
                                      self._projected_share)
                     if total else 0.0)
        if self._g_realized is not None:
            self._g_realized.set(realized)
            self._g_projected.set(projected)
        self._window.append({"wall_us": float(wall_us), "share": share,
                             "realized": realized, "projected": projected,
                             "reads": reads})
        if len(self._window) < self.cfg.window:
            return []
        return self._evaluate(batch)

    def _evaluate(self, batch: int) -> list[str]:
        w = list(self._window)
        p99_wall = empirical_p99([x["wall_us"] for x in w])
        mean_share = float(np.mean([x["share"] for x in w]))
        mean_real = float(np.mean([x["realized"] for x in w]))
        mean_proj = float(np.mean([x["projected"] for x in w]))
        div = mean_real / mean_proj - 1.0 if mean_proj > 0 else 0.0
        window_reads = np.sum([x["reads"] for x in w], axis=0)
        fired: list[str] = []
        candidates = (
            ("p99", self.cfg.p99_us, p99_wall,
             self.cfg.p99_us > 0 and p99_wall > self.cfg.p99_us),
            ("hot_bank", self.cfg.max_share, mean_share,
             self.cfg.max_share > 0 and mean_share > self.cfg.max_share),
            ("divergence", self.cfg.divergence, div,
             self.cfg.divergence > 0 and div > self.cfg.divergence),
        )
        for kind, threshold, value, hit in candidates:
            if not hit or batch < self._cooldown[kind]:
                continue
            self._cooldown[kind] = batch + self.cfg.window
            fired.append(kind)
            self.breaches += 1
            if self._m_total is not None:
                self._m_total.inc()
                self._m_kind[kind].inc()
            if self.tracer is not None:
                self.tracer.instant("slo_breach", kind=kind, batch=batch,
                                    value=value, threshold=threshold)
            if self.on_breach is not None:
                self.on_breach(kind, {
                    "batch": batch, "value": value, "threshold": threshold,
                    "share": mean_share, "p99_wall_us": p99_wall,
                    "realized_us": mean_real, "projected_us": mean_proj,
                    "window_reads": window_reads,
                    "bank": int(np.argmax(window_reads)),
                })
        return fired
