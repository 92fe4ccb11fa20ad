"""AdaptiveEmbeddingRuntime: the closed loop around one banked table (the
port of the reference's ``repro/workload/runtime.py``: the remap lane and
the tier lane).

    observe_batch(rows)  ->  telemetry                       (every batch)
    end_batch()          ->  drift check -> replan -> MIGRATE -> swap
                                                             (on cadence)

The swap happens on the host between micro-batches: the serve step takes
the table's tensors (packed rows, remap vectors, and on the tier lane the
whole ``TieredTable``) as ARGUMENTS and closes over none of them, and the
runtime replaces all of them at once. Shapes never change — the table keeps
its initial ``rows_per_bank`` capacity across plans — so every version the
serve step sees has the shapes, dtypes and device of version 0.

The tier lane (``ReplanConfig.quant``): version 0 is quantized from the
initial frequencies; every replan re-tiers on the frequencies its plan was
built from, carrying stay-tier rows' bytes through the migration and
re-quantizing only promoted and demoted rows from the CURRENT fp values
(bit-identical to a from-scratch build). ``tier_keep`` versions are
retained for batches in flight across a swap (``tiered_for``).

For training, ``migrate_aux`` applies the same row permutation to any
packed-row-aligned extra (the row-wise Adagrad accumulator). The cache lane
(``cache_rows_per_bank``) and the replica lane (``replicate_k_max > 1``)
are not ported yet and raise.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.embedding import BankedTable
from repro_torch.core.partitioning import PartitionPlan
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.tracing import NULL_TRACER
from repro_torch.quant import assign_tiers, build_tiered_table, retier_tiered
from repro_torch.workload.migrate import migrate_rowwise_state, migrate_table
from repro_torch.workload.replanner import PlanUpdate, ReplanConfig, Replanner


def unpacked_rows(t: BankedTable) -> np.ndarray:
    """(vocab, dim) row values in union-vocab order, gathered from the
    packed layout and brought to the host."""
    return t.packed[t.remap_flat.long()].detach().cpu().numpy()


@dataclasses.dataclass
class SwapEvent:
    """What a completed replan+migration looked like (for logs)."""

    batch: int
    update: PlanUpdate
    old_imbalance: float
    new_imbalance: float
    tier_version: int | None = None     # tiered lane: version installed
    tier_promoted: int = 0              # rows moved to a MORE precise tier
    tier_demoted: int = 0               # rows moved to a LESS precise tier
    tier_requantized: int = 0           # rows whose payload was rebuilt
    # what triggered the swap: "drift" (detector cadence), "bank_failure"
    # (recovery re-pack off dead banks), "straggler" (penalty-driven shed)
    reason: str = "drift"
    # bank_failure only: wall-clock seconds from failure handling entry to
    # the recovered table being live (replan + migrate + swap)
    recovery_s: float | None = None


def _sync(t: torch.Tensor) -> None:
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class AdaptiveEmbeddingRuntime:
    def __init__(self, table: BankedTable, plan: PartitionPlan,
                 cfg: ReplanConfig, *, dist=None,
                 init_freq: np.ndarray | None = None,
                 on_swap: Callable[[SwapEvent], None] | None = None,
                 tier_keep: int = 2, tracer=None,
                 metrics: MetricRegistry | None = None):
        if dist is not None:
            raise NotImplementedError(
                "the multi-GPU bank axis (DistCtx) is not ported yet: "
                "ROADMAP queue 1 #16")
        if cfg.cache_rows_per_bank is not None:
            raise NotImplementedError(
                "the runtime's cache lane (cache_rows_per_bank: versioned "
                "GRACE cache swaps) is not ported yet: ROADMAP queue 1 #10")
        if cfg.replicate_k_max > 1:
            raise NotImplementedError(
                "the runtime's replica lane (replicate_k_max > 1) is not "
                "ported yet: ROADMAP queue 1 #12")
        if cfg.capacity_rows is not None \
                and cfg.capacity_rows != table.rows_per_bank:
            raise ValueError(
                f"capacity_rows {cfg.capacity_rows} != table rows_per_bank "
                f"{table.rows_per_bank}: shape-stable swaps need them equal")
        self.table = table
        self.plan = plan
        self.on_swap = on_swap
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.metrics = metrics if metrics is not None else MetricRegistry()
        # pre-register every metric this runtime can emit so a run where a
        # lane never fires still exports its counters at 0
        m = self.metrics
        self._m_swaps = m.counter("runtime.swaps_total",
                                  "completed replan+migrate+swap cycles")
        self._m_swaps_by = {r: m.counter(f"runtime.swaps_{r}_total",
                                         f"swaps triggered by {r}")
                            for r in ("drift", "bank_failure", "straggler")}
        self._m_migrate_ms = m.histogram("runtime.migrate_ms",
                                         "migrate_table wall time (synced)")
        self._m_recovery_ms = m.histogram(
            "runtime.recovery_ms",
            "bank-failure handled -> recovered table live")
        self._m_imbalance = m.gauge("runtime.plan_imbalance",
                                    "imbalance of the live plan")
        self._m_tier_version = m.gauge("runtime.tier_version")
        self._m_tier_promoted = m.counter("runtime.tier_promoted_total")
        self._m_tier_demoted = m.counter("runtime.tier_demoted_total")
        self._m_tier_requant = m.counter("runtime.tier_requantized_total")
        self.replanner = Replanner(cfg, table.vocab, init_freq=init_freq,
                                   init_plan=plan, metrics=self.metrics)
        self._m_imbalance.set(plan.imbalance())
        self.swaps: list[SwapEvent] = []
        self._batch = 0
        # tiered-precision lane: version 0 from the initial frequencies
        self.tier_version: int | None = None
        self._tier_keep = int(tier_keep)
        self._tier_states: dict[int, object] = {}
        if cfg.quant is not None:
            if cfg.quant_dim != table.dim:
                raise ValueError(
                    f"quant_dim {cfg.quant_dim} != table dim {table.dim}")
            freq0 = init_freq if init_freq is not None \
                else np.ones(table.vocab)
            ta = assign_tiers(freq0, cfg.quant, cfg.quant_dim)
            self.tier_version = 0
            self._tier_states[0] = build_tiered_table(
                table, ta.tier_of_row, hot_dtype=cfg.quant.hot_dtype)

    # -- per-batch hooks ----------------------------------------------------

    def observe_batch(self, rows: np.ndarray) -> None:
        """Union-vocab row ids actually looked up this batch (padding < 0)."""
        self.replanner.observe_rows(np.asarray(rows))

    def observe_bags(self, bags: list[np.ndarray]) -> None:
        self.replanner.observe_bags(bags)

    def end_batch(self) -> SwapEvent | None:
        """Advance the clock; migrate + swap if the replanner fired."""
        self._batch += 1
        update = self.replanner.end_batch()
        if update is None:
            return None
        return self.apply(update)

    # -- migration + swap ---------------------------------------------------

    def apply(self, update: PlanUpdate, *, reason: str = "drift") -> SwapEvent:
        with self.tracer.span("migrate", reason=reason):
            t0 = time.perf_counter()
            new_table = migrate_table(self.table, update.plan,
                                      rows_per_bank=self.table.rows_per_bank)
            _sync(new_table.packed)
            self._m_migrate_ms.observe((time.perf_counter() - t0) * 1e3)
        return self.apply_migrated(update, new_table, reason=reason)

    def apply_migrated(self, update: PlanUpdate, new_table: BankedTable, *,
                       reason: str = "drift") -> SwapEvent:
        """Swap in a table the CALLER already migrated under ``update.plan``
        (a train loop migrates params + optimizer state together through
        ``migrate_packed_leaves`` and hands the resulting table here); the
        tier lane still swaps versioned through this runtime."""
        with self.tracer.span("swap", reason=reason):
            event = self._apply_migrated(update, new_table, reason)
        self._m_swaps.inc()
        if reason in self._m_swaps_by:
            self._m_swaps_by[reason].inc()
        self._m_imbalance.set(event.new_imbalance)
        if event.tier_version is not None:
            self._m_tier_version.set(event.tier_version)
            self._m_tier_promoted.inc(event.tier_promoted)
            self._m_tier_demoted.inc(event.tier_demoted)
            self._m_tier_requant.inc(event.tier_requantized)
        self.tracer.instant("swap_live", batch=event.batch, reason=reason)
        if self.on_swap is not None:
            self.on_swap(event)
        return event

    def _apply_migrated(self, update: PlanUpdate, new_table: BankedTable,
                        reason: str) -> SwapEvent:
        old_imb = self._realized_imbalance(self.plan, update.freq)
        prev_tiered = self._tier_states.get(self.tier_version) \
            if self.tier_version is not None else None
        # callers that drive the replanner directly advance its clock but
        # not ours — sync so SwapEvent.batch records when the swap happened
        self._batch = max(self._batch, self.replanner._batches)
        event = SwapEvent(batch=self._batch, update=update,
                          old_imbalance=old_imb,
                          new_imbalance=update.plan.imbalance(),
                          reason=reason)
        # the swap: one host-side rebind of all plan-coupled references
        self.table = new_table
        self.plan = update.plan
        self.replanner.current_plan = update.plan
        if self.tier_version is not None:
            # re-tier on the frequencies the plan was built from: stay-tier
            # rows carry their payload through the permutation, promoted and
            # demoted rows re-quantize from the migrated CURRENT values
            cfg = self.replanner.cfg
            tiers = update.tier_of_row
            if tiers is None:
                tiers = assign_tiers(update.freq, cfg.quant,
                                     cfg.quant_dim).tier_of_row
            tiered, stats = retier_tiered(prev_tiered, self.table, tiers)
            self.tier_version += 1
            self._tier_states[self.tier_version] = tiered
            for v in [v for v in self._tier_states
                      if v <= self.tier_version - self._tier_keep]:
                del self._tier_states[v]
            event.tier_version = self.tier_version
            event.tier_promoted = stats["n_promoted"]
            event.tier_demoted = stats["n_demoted"]
            event.tier_requantized = stats["n_requantized"]
        self.swaps.append(event)
        return event

    # -- fault recovery ------------------------------------------------------

    def on_bank_failure(self, live_mask: np.ndarray) -> SwapEvent:
        """Recovery lane: a bank (or banks) died — re-pack their rows onto
        the survivors NOW, through the ordinary versioned migrate/swap
        machinery (no drift gate, no hysteresis). The migration gathers
        every row from the OLD table's positions, which stand in for the
        host master table a real deployment would re-pack from. Returns the
        SwapEvent with ``reason="bank_failure"`` and ``recovery_s``."""
        with self.tracer.span("recovery",
                              dead=int((~np.asarray(live_mask)).sum())):
            t0 = time.monotonic()
            self.replanner.set_bank_health(live_mask)
            update = self.replanner.force_replan()
            event = self.apply(update, reason="bank_failure")
            event.recovery_s = time.monotonic() - t0
        self._m_recovery_ms.observe(event.recovery_s * 1e3)
        return event

    def on_straggler(self, penalty: np.ndarray) -> SwapEvent:
        """Straggler lane: feed per-bank latency penalties (1.0 = nominal,
        k = observed k-times slower) into the planner's load model and
        re-pack immediately — slow banks shed load like hot ones do."""
        self.replanner.set_bank_penalty(penalty)
        update = self.replanner.force_replan()
        return self.apply(update, reason="straggler")

    def on_slo_breach(self, penalty: np.ndarray) -> None:
        """SLO lane: the MEASURED per-bank traffic breached an objective.
        Unlike ``on_straggler`` this does NOT migrate at once — it folds the
        hot-bank penalty into the planner's bank-cost model and arms an
        early drift check, so the next check replans under the measured
        costs only if the detector agrees the traffic moved."""
        self.tracer.instant("slo_penalty", batch=self._batch)
        self.replanner.apply_slo_penalty(penalty)

    # -- tiered-precision lane accessors ------------------------------------

    @property
    def tiered(self):
        """The CURRENT TieredTable (quant lane on)."""
        if self.tier_version is None:
            raise ValueError("tiered lane disabled: set ReplanConfig.quant")
        return self._tier_states[self.tier_version]

    def tiered_for(self, version: int):
        """The TieredTable of a still-retained version, for pipelines deeper
        than one micro-batch."""
        try:
            return self._tier_states[version]
        except KeyError:
            raise KeyError(
                f"tier version {version} retired (retained: "
                f"{sorted(self._tier_states)}); raise tier_keep="
            ) from None

    def migrate_aux(self, arr: torch.Tensor, update_or_plan) -> torch.Tensor:
        """Permute a packed-row-aligned tensor (optimizer state) to match a
        plan that apply() is about to install. Call BEFORE apply() — it
        needs the pre-swap remap still on self.table."""
        plan = update_or_plan.plan if isinstance(update_or_plan, PlanUpdate) \
            else update_or_plan
        return migrate_rowwise_state(arr, self.table, plan,
                                     rows_per_bank=self.table.rows_per_bank)

    @staticmethod
    def _realized_imbalance(plan: PartitionPlan, freq: np.ndarray) -> float:
        """max/mean of the CURRENT traffic under the (possibly stale) plan —
        what the old plan actually costs, as opposed to plan.imbalance()
        which scores it against its own build-time frequencies."""
        # bincount adds in index order, as the reference's np.add.at does
        loads = np.bincount(plan.bank_of_row, weights=freq,
                            minlength=plan.n_banks)
        mean = loads.mean()
        return float(loads.max() / mean) if mean > 0 else 1.0
