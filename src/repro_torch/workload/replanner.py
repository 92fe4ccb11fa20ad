"""Background replanning: live counters -> fresh §3 partition plan (a numpy
copy of the reference's ``repro/workload/replanner.py``; for the same
traffic it emits the same plans, tier maps and skips).

The decision loop:

    every ``check_every`` batches:
        report = DriftDetector.check(telemetry)       # vs plan-time freqs
        if report.drifted:
            freq = telemetry.freq_vector()
            plan = non_uniform_partition(freq, ...)   # or cache-aware
            (cache plan remined + cache table rebuilt when cache-aware)
            -> PlanUpdate for the runtime to migrate + swap

The replanner itself is host-side and cheap (the greedy partitioners are
O(V log B)); the expensive part — moving rows — is migrate.py's job, and
WHETHER to pay it is exactly what the drift detector gates.

``capacity_rows`` should be the serving table's fixed per-bank capacity so
every plan the replanner emits fits the already-allocated packed array
(shape-stable swaps; see migrate.py).
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.cache_runtime import (FixedCachePlan, SubsetMatcher,
                                            cap_cache_plan, entry_banks)
from repro_torch.core.grace import CachePlan, mine_cooccurrence
from repro_torch.core.partitioning import (PartitionPlan,
                                           cache_aware_partition,
                                           choose_replication,
                                           non_uniform_partition,
                                           replicated_partition)
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.tracing import NULL_TRACER
from repro_torch.quant import assign_tiers, bytes_of_tier
from repro_torch.workload.telemetry import (DriftDetector, DriftReport,
                                            TableTelemetry)


@dataclasses.dataclass(frozen=True)
class ReplanConfig:
    n_banks: int
    partitioner: str = "non_uniform"       # 'non_uniform' | 'cache_aware'
    capacity_rows: int | None = None       # per-bank row budget (fixed shape)
    check_every: int = 20                  # batches between drift checks
    topk: int = 256                        # hot-set size for the Jaccard test
    min_jaccard: float = 0.5
    max_weighted_l1: float = 0.5
    min_observations: int = 2000
    # past this vocab the drift check runs on the top-K UNION instead of
    # materializing a (vocab,) estimate per check (telemetry.DriftDetector)
    drift_sparse_above: int = 10_000_000
    # telemetry exponential window (TableTelemetry): < 1.0 multiplies all
    # counters by ``telemetry_decay`` every ``telemetry_decay_every`` observed
    # ids. Without it the freq estimate is CUMULATIVE since process start, so
    # a long-lived server's detector goes blind to late drift (the reference
    # rebases onto an average the new regime barely moves) and replans keep
    # re-installing history's plan. Serving loops should set it.
    telemetry_decay: float = 1.0
    telemetry_decay_every: int = 100_000
    # cache-aware only: GRACE re-mining window + knobs
    mine_window: int = 512                 # recent bags kept for re-mining
    mine_top_items: int = 2048
    mine_max_groups: int = 256
    mine_min_support: int = 3
    # cache-aware serving: fixed per-bank cache-entry budget. When set, every
    # PlanUpdate carries ``cache_fixed`` — the re-mined plan padded/truncated
    # to n_banks * cache_rows_per_bank entry positions, so the swapped-in
    # cache table always has the shape the serve jit was compiled for.
    cache_rows_per_bank: int | None = None
    # replan hysteresis: a drift-triggered candidate plan must beat the
    # incumbent's PROJECTED max-bank load share on the recent telemetry
    # window by this relative margin, or the migration is skipped (counted
    # in ``Replanner.n_skipped_replans``). Guards against adversarial
    # rotations where the detector trips but the candidate layout would not
    # actually serve the current traffic better than what is installed.
    # 0.0 disables the gate (every drifted check migrates).
    hysteresis: float = 0.0
    # tiered-precision lane (quant package): when set, every replan re-runs
    # the tier assigner on the live frequencies and partitions by BYTE load
    # (freq x bytes-per-row under the new tier map) instead of row load;
    # PlanUpdate carries ``tier_of_row`` for the runtime to re-quantize
    # promoted/demoted rows. ``quant_dim`` is the table's embedding dim
    # (the byte arithmetic needs it). non_uniform partitioner only.
    quant: "object | None" = None          # quant.QuantSpec
    quant_dim: int | None = None
    # hot-row replication lane: > 1 gives the top-R hottest rows
    # ``replicate_k_max`` copies each (core/partitioning.choose_replication
    # picks R from live head mass; copies land on distinct banks and a
    # per-bag hash splits their traffic). Every committed PlanUpdate then
    # carries ``replica_plan`` for the runtime's replica swap lane.
    # ``replicate_max_r`` bounds the capacity cost — and is further clamped
    # so R * (k_max - 1) extra physical rows always fit the fixed
    # ``capacity_rows`` (shape-stable swaps). non_uniform partitioner only.
    replicate_k_max: int = 1
    replicate_max_r: int = 64

    @classmethod
    def for_vocab(cls, vocab: int, n_banks: int, **overrides) -> "ReplanConfig":
        """Defaults scaled to the table size: the hot-set Jaccard needs a k
        well under the vocab (k=vocab makes it identically 1.0), and the
        detector should not arm before ~a few observations per hot row."""
        scaled = dict(
            topk=max(16, min(256, vocab // 8)),
            min_observations=max(256, min(2000, 4 * vocab)),
        )
        scaled.update(overrides)
        return cls(n_banks=n_banks, **scaled)


@dataclasses.dataclass
class PlanUpdate:
    plan: PartitionPlan
    freq: np.ndarray                       # frequencies the plan was built on
    report: DriftReport
    cache_plan: CachePlan | None = None    # cache-aware: remined groups
    # remined plan at the FIXED serving capacity (cache_rows_per_bank set):
    # what the runtime actually swaps into the rewriter + cache table
    cache_fixed: FixedCachePlan | None = None
    # tiered lane (ReplanConfig.quant set): the fresh per-row tier map the
    # plan's byte-load balance was computed under — the runtime re-quantizes
    # exactly the rows whose tier changed (quant.retier_tiered)
    tier_of_row: np.ndarray | None = None
    # replica lane (ReplanConfig.replicate_k_max > 1): the fresh
    # replication-aware plan (core/partitioning.ReplicatedPlan) — the
    # runtime rebuilds the replicated side table from the migrated base
    # (workload.migrate.migrate_replicated) and swaps it versioned
    replica_plan: "object | None" = None


class Replanner:
    """Owns the telemetry + drift detector + replan policy for ONE table
    (DLRM's union-vocab super-table counts as one)."""

    def __init__(self, cfg: ReplanConfig, vocab: int, *,
                 init_freq: np.ndarray | None = None,
                 telemetry: TableTelemetry | None = None,
                 init_plan: PartitionPlan | None = None,
                 metrics: MetricRegistry | None = None, tracer=None):
        if cfg.quant is not None:
            if cfg.partitioner != "non_uniform":
                raise ValueError("ReplanConfig.quant drives byte-load "
                                 "partitioning on the non_uniform path only")
            if cfg.quant_dim is None:
                raise ValueError("ReplanConfig.quant needs quant_dim (the "
                                 "embedding dim) for the byte arithmetic")
        if cfg.replicate_k_max > 1:
            if cfg.partitioner != "non_uniform":
                raise ValueError("ReplanConfig.replicate_k_max rides the "
                                 "non_uniform path only (cache_aware entry "
                                 "placement has no replica axis)")
            if cfg.replicate_k_max > cfg.n_banks:
                raise ValueError(f"replicate_k_max {cfg.replicate_k_max} > "
                                 f"n_banks {cfg.n_banks}: copies must land "
                                 f"on distinct banks")
        self.cfg = cfg
        self.vocab = vocab
        # host spans of the replica plan's build ("replica_plan")
        self.tracer = tracer if tracer is not None else NULL_TRACER
        # the INSTALLED plan (+ its capped cache plan, cache_aware), for
        # hysteresis projection; tracked on every committed replan (the
        # runtime seeds the plan with the serving one)
        self.current_plan = init_plan
        self.current_cache_fixed: FixedCachePlan | None = None
        self.telemetry = telemetry or TableTelemetry(
            vocab, decay=cfg.telemetry_decay,
            decay_every=cfg.telemetry_decay_every)
        if init_freq is None:
            init_freq = np.ones(vocab, dtype=np.float64)
        self.detector = DriftDetector(
            init_freq, k=cfg.topk, min_jaccard=cfg.min_jaccard,
            max_weighted_l1=cfg.max_weighted_l1,
            min_observations=cfg.min_observations,
            sparse_above=cfg.drift_sparse_above)
        self._recent_bags: deque[np.ndarray] = deque(maxlen=cfg.mine_window)
        self._batches = 0
        self.n_replans = 0
        self.n_skipped_replans = 0         # hysteresis: drifted but kept plan
        self.last_report: DriftReport | None = None
        # metrics mirror the counters above (pre-registered so the snapshot
        # schema is the same whether or not anything ever drifts)
        self.metrics = metrics if metrics is not None else MetricRegistry()
        m = self.metrics
        self._m_replans = m.counter("replanner.replans_total",
                                    "committed replans (migrations)")
        self._m_skips = m.counter("replanner.hysteresis_skips_total",
                                  "drifted checks where the candidate lost")
        self._m_checks = m.counter("replanner.drift_checks_total",
                                   "cadenced drift-detector runs")
        self._m_drifted = m.counter("replanner.drift_detected_total",
                                    "checks that reported drift")
        self._m_hit_rate = m.gauge("replanner.realized_hit_rate",
                                   "realized/predicted cache saved-reads")
        self._m_hit_rate.set(1.0)
        self._m_slo_pen = m.counter("replanner.slo_penalties_total",
                                    "SLO-watchdog bank penalties received")
        # fault-tolerance state (all-healthy defaults are exactly the legacy
        # planner: no per-bank caps, unit costs — bit-identical plans)
        self.bank_live = np.ones(cfg.n_banks, dtype=bool)
        self.bank_penalty = np.ones(cfg.n_banks, dtype=np.float64)
        # realized-hit-rate feed (cache_aware): what the serve loop actually
        # saved vs what the miner predicted at the last commit
        self._pred_saved_per_bag: float | None = None
        self._realized_saved = 0.0
        self._realized_bags = 0
        # SLO feedback: an armed early check makes the NEXT end_batch run
        # the drift detector off-cadence (set by apply_slo_penalty)
        self._early_check = False

    # -- fault state ---------------------------------------------------------

    def set_bank_health(self, live_mask: np.ndarray) -> None:
        """(n_banks,) bool — False marks a DEAD bank. Every subsequent
        ``build_plan`` treats dead banks as zero-capacity so their rows
        re-pack onto the survivors (the recovery half of bounded-degraded
        serving; the runtime's ``on_bank_failure`` drives this)."""
        live = np.asarray(live_mask, dtype=bool)
        if live.shape != (self.cfg.n_banks,):
            raise ValueError(f"live_mask {live.shape} != ({self.cfg.n_banks},)")
        self.bank_live = live.copy()

    def set_bank_penalty(self, penalty: np.ndarray) -> None:
        """(n_banks,) latency multipliers (1.0 = nominal). A bank observed
        k-times slower accounts each accepted row at k x its frequency, so
        the greedy sheds load off stragglers like it sheds hot rows off
        loaded banks (StragglerWatchdog feedback)."""
        pen = np.asarray(penalty, dtype=np.float64)
        if pen.shape != (self.cfg.n_banks,):
            raise ValueError(f"penalty {pen.shape} != ({self.cfg.n_banks},)")
        if (pen <= 0).any():
            raise ValueError("bank penalties must be positive multipliers")
        self.bank_penalty = pen.copy()

    def apply_slo_penalty(self, penalty: np.ndarray) -> None:
        """SLO-watchdog feedback (the reference's obs/slo.py; its port is
        ROADMAP queue 1 #14): the MEASURED per-bank traffic
        breached a latency/share objective, so fold the hot bank's observed
        overload into the planner's ``bank_cost`` model (same mechanism as
        the straggler penalty — an overloaded bank accounts each accepted
        row at penalty x its frequency and sheds load on the next plan) and
        arm an early off-cadence drift check so the loop closes without
        waiting out ``check_every``: the measure -> plan feedback edge."""
        self.set_bank_penalty(penalty)
        self._m_slo_pen.inc()
        self._early_check = True

    # -- feeding ------------------------------------------------------------

    def observe_rows(self, rows: np.ndarray) -> None:
        """Union-vocab row ids from one serve/train batch (any shape,
        negatives = padding)."""
        self.telemetry.observe(rows)

    def observe_bags(self, bags: list[np.ndarray]) -> None:
        """Bag-granular feed — also retained for cache re-mining."""
        for bag in bags:
            self.telemetry.observe(bag)
            self._recent_bags.append(np.asarray(bag))

    def observe_cache_hits(self, saved_reads: float, n_bags: int) -> None:
        """Cache-aware serving feedback: ``saved_reads`` row reads were
        actually absorbed by the installed cache over ``n_bags`` bags (a bag
        rewritten to c entries + r residuals saves ``len(bag) - c - r``).
        Accumulated until the next commit; see ``realized_hit_rate``."""
        self._realized_saved += float(saved_reads)
        self._realized_bags += int(n_bags)
        self._m_hit_rate.set(self.realized_hit_rate())

    def realized_hit_rate(self) -> float:
        """REALIZED / PREDICTED saved-reads-per-bag for the installed cache,
        clipped to [0, 1]. 1.0 until both sides exist (no feedback, or no
        committed prediction) — the discount only ever shrinks benefits, and
        only once there is evidence the miner over-promised."""
        if self._pred_saved_per_bag is None or self._pred_saved_per_bag <= 0 \
                or self._realized_bags == 0:
            return 1.0
        realized = self._realized_saved / self._realized_bags
        return float(np.clip(realized / self._pred_saved_per_bag, 0.0, 1.0))

    # -- planning -----------------------------------------------------------

    def build_plan(self, freq: np.ndarray
                   ) -> tuple[PartitionPlan, CachePlan | None,
                              "np.ndarray | None"]:
        """(plan, cache_plan, tier_of_row) from a frequency estimate. With
        ``cfg.quant`` set, tiers come first and the greedy balances BYTE
        load (freq x bytes-per-row under the fresh tier map)."""
        cfg = self.cfg
        # fault/straggler state folds into every plan — but ONLY when
        # non-trivial, so all-healthy serving stays bit-identical to the
        # legacy planner
        all_live = bool(self.bank_live.all())
        unit_cost = bool((self.bank_penalty == 1.0).all())
        if cfg.partitioner == "non_uniform":
            row_weights = None
            tiers = None
            if cfg.quant is not None:
                ta = assign_tiers(freq, cfg.quant, cfg.quant_dim)
                tiers = ta.tier_of_row
                row_weights = bytes_of_tier(
                    tiers, cfg.quant_dim, cfg.quant.hot_dtype
                ).astype(np.float64)
            bank_caps = None
            if not all_live:
                per_bank = cfg.capacity_rows if cfg.capacity_rows is not None \
                    else self.vocab
                bank_caps = np.where(self.bank_live, per_bank, 0)
            plan = non_uniform_partition(
                freq, cfg.n_banks, capacity_rows=cfg.capacity_rows,
                row_weights=row_weights, bank_capacity_rows=bank_caps,
                bank_cost=None if unit_cost else self.bank_penalty)
            return plan, None, tiers
        if cfg.partitioner == "cache_aware":
            if not all_live:
                raise ValueError(
                    "cache_aware replanning cannot exclude dead banks yet — "
                    "Algorithm 1's joint cache/EMT packing has no per-bank "
                    "capacity mask; serve fault recovery runs on the "
                    "non_uniform partitioner")
            if not self._recent_bags:
                raise ValueError("cache_aware replanning needs observe_bags() "
                                 "traffic to re-mine co-occurrence groups")
            cp = mine_cooccurrence(
                list(self._recent_bags), top_items=cfg.mine_top_items,
                max_groups=cfg.mine_max_groups,
                min_support=cfg.mine_min_support)
            # discount the miner's predicted benefits by the hit rate the
            # SERVED traffic realized on the incumbent cache — an
            # over-promising miner stops distorting the bank packing
            rate = self.realized_hit_rate()
            benefits = cp.benefits if rate >= 1.0 \
                else np.asarray(cp.benefits, np.float64) * rate
            plan = cache_aware_partition(
                freq, cp.groups, benefits, cfg.n_banks,
                emt_capacity_rows=cfg.capacity_rows)
            return plan, cp, None
        raise ValueError(f"unknown partitioner {cfg.partitioner!r}")

    def build_replica_plan(self, freq: np.ndarray,
                           tier_of_row: "np.ndarray | None" = None):
        """Fresh replication-aware plan (``ReplicatedPlan``) for the replica
        swap lane; None when replication is off (``replicate_k_max <= 1``).
        R comes from live head mass (``choose_replication``), clamped so the
        ``R * (k - 1)`` extra physical rows always fit the fixed per-bank
        capacity; with the tier lane on, candidates are restricted to the
        hot head (replicas stay full-precision); dead banks get zero
        replica capacity and the copy count clamps to the live banks. The
        map width stays ``replicate_k_max`` whatever fits, so every plan has
        the serve step's shapes."""
        cfg = self.cfg
        if cfg.replicate_k_max <= 1:
            return None
        with self.tracer.span("replica_plan"):
            per_bank = cfg.capacity_rows if cfg.capacity_rows is not None \
                else self.vocab
            bank_caps = None
            if bool(self.bank_live.all()):
                headroom = cfg.n_banks * per_bank - self.vocab
            else:
                bank_caps = np.where(self.bank_live, per_bank, 0)
                headroom = int(bank_caps.sum()) - self.vocab
            # copies must land on distinct LIVE banks
            k_eff = min(cfg.replicate_k_max, int(self.bank_live.sum()))
            if k_eff <= 1 or headroom <= 0:
                copies = np.ones(self.vocab, dtype=np.int32)
            else:
                max_r = max(0, min(cfg.replicate_max_r,
                                   headroom // (k_eff - 1)))
                hot = None
                if tier_of_row is not None:
                    hot = np.flatnonzero(np.asarray(tier_of_row) == 0)
                copies = choose_replication(freq, cfg.n_banks, k_max=k_eff,
                                            max_r=max_r, hot_rows=hot)
            return replicated_partition(
                freq, cfg.n_banks, copies=copies,
                capacity_rows=cfg.capacity_rows, k_max=cfg.replicate_k_max,
                bank_capacity_rows=bank_caps)

    @staticmethod
    def projected_max_share(plan: PartitionPlan, freq: np.ndarray) -> float:
        """Fraction of ``freq``'s row-read mass landing on the hottest bank
        under ``plan`` — the hysteresis currency: what each layout would
        cost on the RECENT window, not the window it was built from."""
        loads = np.zeros(plan.n_banks)
        np.add.at(loads, plan.bank_of_row, freq)
        total = loads.sum()
        return float(loads.max() / total) if total > 0 else 1.0 / plan.n_banks

    @staticmethod
    def projected_max_share_cached(plan: PartitionPlan, fcp: FixedCachePlan,
                                   bags: list) -> float:
        """Cache-aware hysteresis currency: replay the recent-bag window
        through each (plan, capped cache plan) pair — a cache hit costs ONE
        read on the entry's bank, residual rows read their own banks (the
        same cost model the reference's cache benchmarks score). Raw row
        share would ignore exactly the reads the cache absorbs, skipping
        candidates whose whole improvement IS a better cache."""
        matcher = SubsetMatcher(fcp.plan)
        loads = np.zeros(plan.n_banks)
        for bag in bags:
            c, r = matcher.rewrite(bag)
            if c:
                np.add.at(loads, fcp.entry_bank[np.asarray(c)], 1.0)
            if r:
                np.add.at(loads, plan.bank_of_row[np.asarray(r)], 1.0)
        total = loads.sum()
        return float(loads.max() / total) if total > 0 else 1.0 / plan.n_banks

    def _cap(self, cache_plan: CachePlan | None,
             plan: PartitionPlan) -> FixedCachePlan | None:
        if cache_plan is None or self.cfg.cache_rows_per_bank is None:
            return None
        return cap_cache_plan(
            cache_plan,
            entry_banks(cache_plan, plan.bank_of_row,
                        plan.cache_bank_of_entry),
            self.cfg.n_banks, self.cfg.cache_rows_per_bank)

    def _commit(self, freq: np.ndarray, plan: PartitionPlan,
                cache_plan: CachePlan | None,
                tier_of_row: "np.ndarray | None", report: DriftReport,
                cache_fixed: FixedCachePlan | None = None) -> PlanUpdate:
        self.detector.rebase(freq)
        self.n_replans += 1
        self._m_replans.inc()
        self.current_plan = plan
        if cache_fixed is None:
            cache_fixed = self._cap(cache_plan, plan)
        self.current_cache_fixed = cache_fixed
        # rebase the realized-hit-rate baseline: predict what the FRESH cache
        # should save per bag on the recent window, reset the realized feed
        self._pred_saved_per_bag = None
        self._realized_saved = 0.0
        self._realized_bags = 0
        self._m_hit_rate.set(1.0)
        if cache_fixed is not None and self._recent_bags:
            matcher = SubsetMatcher(cache_fixed.plan)
            saved = 0
            bags = list(self._recent_bags)
            for bag in bags:
                b = np.asarray(bag)
                b = b[b >= 0]
                c, r = matcher.rewrite(b)
                saved += len(b) - len(c) - len(r)
            self._pred_saved_per_bag = saved / max(len(bags), 1)
        return PlanUpdate(plan=plan, freq=freq, report=report,
                          cache_plan=cache_plan, cache_fixed=cache_fixed,
                          tier_of_row=tier_of_row,
                          replica_plan=self.build_replica_plan(
                              freq, tier_of_row))

    def force_replan(self, report: DriftReport | None = None) -> PlanUpdate:
        """Replan unconditionally — no drift gate, no hysteresis."""
        freq = self.telemetry.freq_vector()
        plan, cache_plan, tiers = self.build_plan(freq)
        if report is None:
            report = self.detector.check(self.telemetry)
        return self._commit(freq, plan, cache_plan, tiers, report)

    def end_batch(self) -> PlanUpdate | None:
        """Advance the batch clock; on cadence, drift-check and (only if
        drifted) emit a PlanUpdate. Returns None when the plan stands —
        including when hysteresis judges the drifted candidate no better
        than the incumbent on the recent window (skips are counted in
        ``n_skipped_replans``; the detector is NOT rebased on a skip, so a
        later check that the incumbent really does lose still trips)."""
        self._batches += 1
        early = self._early_check
        if not early and self._batches % self.cfg.check_every != 0:
            return None
        self._early_check = False
        report = self.detector.check(self.telemetry)
        self.last_report = report
        self._m_checks.inc()
        if not report.drifted:
            return None
        self._m_drifted.inc()
        if self.cfg.hysteresis > 0.0 and self.current_plan is not None:
            freq = self.telemetry.freq_vector()
            plan, cache_plan, tiers = self.build_plan(freq)
            # project in the planner's own currency, not raw row reads:
            #   * quant lane      — freq x bytes under the fresh tier map
            #     (tier is a property of the row, not the plan). Caveat: a
            #     skip also keeps the incumbent TIER map (tiers ship with a
            #     committed PlanUpdate) — acceptable, since a skipped
            #     candidate means the installed byte layout already serves
            #     the window within the margin.
            #   * cache_aware     — replay the recent-bag window through
            #     each (plan, capped cache) pair, so reads the candidate's
            #     cache would absorb count in its favor (needs BOTH sides'
            #     capped plans; falls back to row share when the incumbent
            #     predates the cache lane).
            cache_fixed = self._cap(cache_plan, plan)
            inc_fcp = self.current_cache_fixed
            if cache_fixed is not None and inc_fcp is not None \
                    and self._recent_bags:
                bags = list(self._recent_bags)
                incumbent = self.projected_max_share_cached(
                    self.current_plan, inc_fcp, bags)
                candidate = self.projected_max_share_cached(
                    plan, cache_fixed, bags)
            else:
                proj = freq
                if self.cfg.quant is not None:
                    proj = freq * bytes_of_tier(
                        tiers, self.cfg.quant_dim,
                        self.cfg.quant.hot_dtype).astype(np.float64)
                incumbent = self.projected_max_share(self.current_plan, proj)
                candidate = self.projected_max_share(plan, proj)
            if candidate > incumbent * (1.0 - self.cfg.hysteresis):
                self.n_skipped_replans += 1
                self._m_skips.inc()
                return None
            return self._commit(freq, plan, cache_plan, tiers, report,
                                cache_fixed=cache_fixed)
        return self.force_replan(report)
