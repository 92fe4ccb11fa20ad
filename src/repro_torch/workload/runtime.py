"""AdaptiveEmbeddingRuntime: the closed loop around one banked table (the
port of the reference's ``repro/workload/runtime.py``: the remap lane, the
cache lane, the tier lane and the replica lane).

    observe_batch(rows)  ->  telemetry                       (every batch)
    end_batch()          ->  drift check -> replan -> MIGRATE -> swap
                                                             (on cadence)

The swap happens on the host between micro-batches: the serve step takes
the table's tensors (packed rows, remap vectors, and on the tier lane the
whole ``TieredTable``) as ARGUMENTS and closes over none of them, and the
runtime replaces all of them at once. Shapes never change — the table keeps
its initial ``rows_per_bank`` capacity across plans — so every version the
serve step sees has the shapes, dtypes and device of version 0.

The cache lane (``ReplanConfig.cache_rows_per_bank``): the GRACE cache
side swaps under the same contract. Version 0 is an EMPTY plan (every bag
all-residual) at the fixed capacity ``n_banks * cache_rows_per_bank``; a
cache-aware replan carries its re-mined plan at that capacity
(``PlanUpdate.cache_fixed``), the runtime re-sums the surviving entries from
the migrated table's CURRENT rows (a gather of the entry-member rows on
the table's device, never the vocab) into a fixed-shape banked cache table,
and publishes (rewrite plan, cache table) as one new version of a
``VersionedCacheRewriter``. The serve loop rewrites each batch against the
current plan and resolves it against the table of the version it was
rewritten for (``cache_table_for``), so a batch in flight across a swap
never mixes entry numberings. A replan that is not cache-aware installs the
empty plan. ``refresh_cache`` re-sums the current plan's entries (the train
loop's staleness refresh). ``cache_keep`` versions are retained.

The tier lane (``ReplanConfig.quant``): version 0 is quantized from the
initial frequencies; every replan re-tiers on the frequencies its plan was
built from, carrying stay-tier rows' bytes through the migration and
re-quantizing only promoted and demoted rows from the CURRENT fp values
(bit-identical to a from-scratch build). ``tier_keep`` versions are
retained for batches in flight across a swap (``tiered_for``).

The replica lane (``ReplanConfig.replicate_k_max > 1``): version 0 comes
from the initial frequencies (an all-ones prior replicates nothing); every
swap rebuilds the replicated side table (``ReplicatedTable``: the packed
copies and the ``(vocab, k_max)`` maps) from the MIGRATED base table under
the plan the replanner attached, on the table's device. Its shapes depend
only on (vocab, k_max) and the fixed capacity, never on which rows are
replicated. ``replica_keep`` versions are retained (``replicated_for``).

Under a ``DistCtx`` (``dist``) the table is this rank's bank shard and a
swap migrates it through the sharded exchange (workload/migrate.py); the
remap lane and the fault lane's recovery run as on one device. Every rank
replans from its own telemetry, so every rank must observe the same rows:
the GLOBAL batch (where the batch was cut over dp, the rank's rows
gathered over dp with ``dist.gather(rows, "dp")``). A rank that observes
only its dp slice builds another plan, and the swap's migration raises on
every rank rather than exchange rows under two plans. Each lane then
builds, on its own rank, exactly the shard of what one device would
build: the cache lane gathers the entry-member rows over the bank group
(every member row has one owner and the other ranks add exact zeros, an
integer sum of the bits), sums the entries as one device does and keeps
its bank's piece of the cache table; the tier lane quantizes its own rows
under the global tiers (quantization is per row) and moves payload and
scales through the migration's exchange; ``migrate_aux`` moves a shard
through the same exchange. The replica lane refuses ``dist``, as the
reference's replicated lookup does.

For training, ``migrate_aux`` applies the same row permutation to any
packed-row-aligned extra (the row-wise Adagrad accumulator).

``bank_capacity`` and ``cache_lane_runtime`` hold the adaptive launchers'
shared set-up (the serve loop's and the train loop's cache lane).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import torch

from repro_torch.core.cache_runtime import (FixedCachePlan, RewrittenBatch,
                                            VersionedCacheRewriter,
                                            build_cache_table_fixed,
                                            cap_cache_plan, empty_cache_plan,
                                            entry_member_union,
                                            sorted_distinct)
from repro_torch.core.embedding import BankedTable, _check_dist, pack_table
from repro_torch.core.partitioning import PartitionPlan, uniform_partition
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.tracing import NULL_TRACER
from repro_torch.quant import assign_tiers, build_tiered_table, retier_tiered
from repro_torch.workload.migrate import (_exact_bank_sum, migrate_replicated,
                                          migrate_rowwise_state, migrate_table)
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
    cache_version: int | None = None    # rewriter version installed (if any)
    cache_entries: int = 0              # live entries in the swapped table
    cache_dropped: int = 0              # mined entries truncated to residual
    tier_version: int | None = None     # tiered lane: version installed
    tier_promoted: int = 0              # rows moved to a MORE precise tier
    tier_demoted: int = 0               # rows moved to a LESS precise tier
    tier_requantized: int = 0           # rows whose payload was rebuilt
    replica_version: int | None = None  # replica lane: version installed
    replica_hot_rows: int = 0           # rows holding > 1 copy in the new plan
    replica_copy_churn: int = 0         # rows whose copy count changed
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
                 max_cache_per_bag: int = 4,
                 max_residual_per_bag: int = 16,
                 cache_keep: int = 2, tier_keep: int = 2,
                 replica_keep: int = 2, tracer=None,
                 metrics: MetricRegistry | None = None):
        _check_dist(dist)
        if dist is not None and cfg.replicate_k_max > 1:
            raise ValueError(
                "the replica lane takes dist=None: a replicated lookup "
                "under dist is refused, as in the reference")
        if cfg.capacity_rows is not None \
                and cfg.capacity_rows != table.rows_per_bank:
            raise ValueError(
                f"capacity_rows {cfg.capacity_rows} != table rows_per_bank "
                f"{table.rows_per_bank}: shape-stable swaps need them equal")
        self.table = table
        self.plan = plan
        self.dist = dist
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
        self._m_cache_version = m.gauge("runtime.cache_version")
        self._m_cache_entries = m.gauge("runtime.cache_entries",
                                        "live entries in the swapped cache")
        self._m_cache_dropped = m.counter("runtime.cache_dropped_total",
                                          "mined entries truncated away")
        self._m_tier_version = m.gauge("runtime.tier_version")
        self._m_tier_promoted = m.counter("runtime.tier_promoted_total")
        self._m_tier_demoted = m.counter("runtime.tier_demoted_total")
        self._m_tier_requant = m.counter("runtime.tier_requantized_total")
        self._m_replica_version = m.gauge("runtime.replica_version")
        self._m_replica_hot = m.gauge("runtime.replica_hot_rows",
                                      "rows holding > 1 copy in the live plan")
        self._m_replica_churn = m.counter(
            "runtime.replica_copy_churn_total",
            "rows whose copy count changed across swaps")
        self.replanner = Replanner(cfg, table.vocab, init_freq=init_freq,
                                   init_plan=plan, metrics=self.metrics,
                                   tracer=self.tracer)
        self._m_imbalance.set(plan.imbalance())
        self.swaps: list[SwapEvent] = []
        self._batch = 0
        # cache lane: a versioned rewriter starts at version 0 with an EMPTY
        # plan (all-residual) at the fixed capacity, so the serve step sees
        # the final shapes before any swap
        self.rewriter: VersionedCacheRewriter | None = None
        if cfg.cache_rows_per_bank is not None:
            self.rewriter = VersionedCacheRewriter(
                max_cache_per_bag=max_cache_per_bag,
                max_residual_per_bag=max_residual_per_bag, keep=cache_keep)
            self._install_cache(self._empty_cache_fixed())
        # tiered-precision lane: version 0 from the initial frequencies
        self.tier_version: int | None = None
        self._tier_rows: np.ndarray | None = None   # the live tier_of_row
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
            self._tier_rows = ta.tier_of_row
            self._tier_states[0] = build_tiered_table(
                table, ta.tier_of_row, hot_dtype=cfg.quant.hot_dtype,
                bank=None if dist is None else dist.bank_rank)
        # hot-row replica lane: version 0 from the initial frequencies (an
        # all-ones prior replicates nothing until telemetry finds a head)
        self.replica_version: int | None = None
        self._replica_keep = int(replica_keep)
        self._replica_states: dict[int, tuple[object, object]] = {}
        if cfg.replicate_k_max > 1:
            freq0 = init_freq if init_freq is not None \
                else np.ones(table.vocab)
            rplan0 = self.replanner.build_replica_plan(freq0)
            rtable0 = migrate_replicated(table, rplan0,
                                         rows_per_bank=table.rows_per_bank)
            self.replica_version = 0
            self._replica_states[0] = (rplan0, rtable0)
            self._m_replica_version.set(0)
            self._m_replica_hot.set(rplan0.n_replicated)

    def _empty_cache_fixed(self) -> FixedCachePlan:
        cfg = self.replanner.cfg
        return cap_cache_plan(empty_cache_plan(), np.zeros(0, np.int32),
                              cfg.n_banks, cfg.cache_rows_per_bank)

    def _member_rows(self, rows: np.ndarray) -> torch.Tensor:
        """(n, dim) current values of union-vocab ``rows`` on the table's
        device. Under ``dist``: each rank fills the rows its bank holds and
        zeros elsewhere, and one exact integer sum over the bank group
        hands every rank all of them, bit for bit."""
        t = self.table
        dev = t.packed.device
        idx = torch.from_numpy(np.asarray(rows, np.int64)).to(dev)
        if self.dist is None:
            return t.packed.detach()[t.remap_flat[idx].long()]
        if idx.numel() == 0:
            return t.packed.new_zeros((0, t.dim))
        mine = t.remap_bank[idx] == self.dist.bank_rank
        buf = t.packed.new_zeros((idx.numel(), t.dim))
        buf[mine] = t.packed.detach()[t.remap_slot[idx][mine].long()]
        return _exact_bank_sum(self.dist, buf)

    def _bank_piece(self, table: BankedTable) -> BankedTable:
        """This rank's bank of a whole banked table (itself without dist)."""
        if self.dist is None:
            return table
        m, rpb = self.dist.bank_rank, table.rows_per_bank
        return BankedTable(packed=table.packed[m * rpb:(m + 1) * rpb].clone(),
                           remap_bank=table.remap_bank,
                           remap_slot=table.remap_slot,
                           n_banks=table.n_banks, rows_per_bank=rpb,
                           remap_flat=table.remap_flat)

    def _install_cache(self, fcp: FixedCachePlan) -> int:
        # re-sum from ONLY the entry-member rows (a gather of a few hundred
        # rows on the table's device) — never the (vocab, dim) unpack
        members = entry_member_union(fcp)
        table = build_cache_table_fixed(
            self._member_rows(members), fcp, row_ids=members,
            device=self.table.packed.device)
        return self.rewriter.install(fcp, self._bank_piece(table))

    # -- per-batch hooks ----------------------------------------------------

    def observe_batch(self, rows: np.ndarray) -> None:
        """Union-vocab row ids actually looked up this batch (padding < 0);
        under ``dist`` the global batch's, on every rank alike."""
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
            new_table = migrate_table(self.table, update.plan, self.dist,
                                      rows_per_bank=self.table.rows_per_bank)
            _sync(new_table.packed)
            self._m_migrate_ms.observe((time.perf_counter() - t0) * 1e3)
        return self.apply_migrated(update, new_table, reason=reason)

    def apply_migrated(self, update: PlanUpdate, new_table: BankedTable, *,
                       reason: str = "drift") -> SwapEvent:
        """Swap in a table the CALLER already migrated under ``update.plan``
        (a train loop migrates params + optimizer state together through
        ``migrate_packed_leaves`` and hands the resulting table here); the
        tier and replica lanes still swap versioned through this runtime."""
        with self.tracer.span("swap", reason=reason):
            event = self._apply_migrated(update, new_table, reason)
        self._m_swaps.inc()
        if reason in self._m_swaps_by:
            self._m_swaps_by[reason].inc()
        self._m_imbalance.set(event.new_imbalance)
        if event.cache_version is not None:
            self._m_cache_version.set(event.cache_version)
            self._m_cache_entries.set(event.cache_entries)
            self._m_cache_dropped.inc(event.cache_dropped)
        if event.tier_version is not None:
            self._m_tier_version.set(event.tier_version)
            self._m_tier_promoted.inc(event.tier_promoted)
            self._m_tier_demoted.inc(event.tier_demoted)
            self._m_tier_requant.inc(event.tier_requantized)
        if event.replica_version is not None:
            self._m_replica_version.set(event.replica_version)
            self._m_replica_hot.set(event.replica_hot_rows)
            self._m_replica_churn.inc(event.replica_copy_churn)
        self.tracer.instant("swap_live", batch=event.batch, reason=reason)
        if self.on_swap is not None:
            self.on_swap(event)
        return event

    def _apply_migrated(self, update: PlanUpdate, new_table: BankedTable,
                        reason: str) -> SwapEvent:
        old_imb = self._realized_imbalance(self.plan, update.freq)
        prev_tiered = self._tier_states.get(self.tier_version) \
            if self.tier_version is not None else None
        prev_replica = self._replica_states.get(self.replica_version) \
            if self.replica_version is not None else None
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
        if self.rewriter is not None:
            # cache lane of the same swap: re-sum the surviving entries from
            # the migrated rows and publish (rewrite plan, cache table) as
            # one new version; a replan that is not cache-aware (or a mined
            # plan that fit nothing) installs the empty plan, so no entry sum
            # outlives the plan it was mined under
            fcp = update.cache_fixed if update.cache_fixed is not None \
                else self._empty_cache_fixed()
            with self.tracer.span("cache_install"):
                event.cache_version = self._install_cache(fcp)
                _sync(self.cache_table.packed)
            event.cache_entries = fcp.n_entries
            event.cache_dropped = fcp.n_dropped
        if self.tier_version is not None:
            # re-tier on the frequencies the plan was built from: stay-tier
            # rows carry their payload through the permutation, promoted and
            # demoted rows re-quantize from the migrated CURRENT values
            cfg = self.replanner.cfg
            tiers = update.tier_of_row
            if tiers is None:
                tiers = assign_tiers(update.freq, cfg.quant,
                                     cfg.quant_dim).tier_of_row
            tiered, stats = retier_tiered(prev_tiered, self.table, tiers,
                                          self.dist, self._tier_rows)
            self._tier_rows = np.asarray(tiers)
            self.tier_version += 1
            self._tier_states[self.tier_version] = tiered
            for v in [v for v in self._tier_states
                      if v <= self.tier_version - self._tier_keep]:
                del self._tier_states[v]
            event.tier_version = self.tier_version
            event.tier_promoted = stats["n_promoted"]
            event.tier_demoted = stats["n_demoted"]
            event.tier_requantized = stats["n_requantized"]
        if self.replica_version is not None:
            # replica lane: rebuild the side table from the MIGRATED base
            # (every copy reads its row's post-migration value) under the
            # plan the replanner attached; recovery and straggler replans
            # that bypassed its commit get one built here on the same freq
            rplan = update.replica_plan
            if rplan is None:
                rplan = self.replanner.build_replica_plan(
                    update.freq, update.tier_of_row)
            with self.tracer.span("migrate_replicated"):
                rtable = migrate_replicated(
                    self.table, rplan, rows_per_bank=self.table.rows_per_bank)
                _sync(rtable.packed)
            self.replica_version += 1
            self._replica_states[self.replica_version] = (rplan, rtable)
            for v in [v for v in self._replica_states
                      if v <= self.replica_version - self._replica_keep]:
                del self._replica_states[v]
            event.replica_version = self.replica_version
            event.replica_hot_rows = rplan.n_replicated
            prev_plan = prev_replica[0] if prev_replica is not None else None
            event.replica_copy_churn = int(
                (prev_plan.copies != rplan.copies).sum()
            ) if prev_plan is not None else rplan.n_replicated
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

    # -- replica lane accessors ----------------------------------------------

    @property
    def replicated(self):
        """The CURRENT (ReplicatedPlan, ReplicatedTable) pair (replica lane
        on). The serve step takes the table as an argument; the plan
        carries the copy counts and the modeled loads."""
        if self.replica_version is None:
            raise ValueError("replica lane disabled: set "
                             "ReplanConfig.replicate_k_max > 1")
        return self._replica_states[self.replica_version]

    def replicated_for(self, version: int):
        """The (plan, table) pair of a still-retained replica version, for
        pipelines deeper than one micro-batch."""
        try:
            return self._replica_states[version]
        except KeyError:
            raise KeyError(
                f"replica version {version} retired (retained: "
                f"{sorted(self._replica_states)}); raise replica_keep="
            ) from None

    # -- cache lane ------------------------------------------------------------

    def _need_cache(self) -> VersionedCacheRewriter:
        if self.rewriter is None:
            raise ValueError("cache side disabled: set "
                             "ReplanConfig.cache_rows_per_bank")
        return self.rewriter

    def refresh_cache(self) -> int:
        """Re-sum the CURRENT cache plan's entries from the table's current
        row values and publish them as a new rewriter version — the train
        loop's staleness refresh (trained EMT rows drift away from the
        partial sums)."""
        return self._install_cache(self._need_cache().current[0])

    def rewrite(self, union_idx: np.ndarray) -> RewrittenBatch:
        """Host pipeline stage: rewrite a (..., L) union-vocab id batch
        against the CURRENT cache plan; the result is version-tagged.

        Also feeds the replanner's realized-hit-rate estimate: a bag of u
        distinct rows rewritten to c entries + r residuals saved ``u - c -
        r`` reads."""
        rb = self._need_cache().rewrite_rect(union_idx)
        _, distinct = sorted_distinct(
            np.asarray(union_idx).reshape(-1, union_idx.shape[-1]))
        n_distinct = int(distinct.sum())
        used = int((rb.cache_idx >= 0).sum() + (rb.residual_idx >= 0).sum())
        self.replanner.observe_cache_hits(n_distinct - used,
                                          distinct.shape[0])
        return rb

    def cache_table_for(self, version: int) -> BankedTable:
        """The cache table a version-tagged batch must be served against."""
        return self._need_cache().table_for(version)

    @property
    def cache_table(self) -> BankedTable:
        return self._need_cache().current[1]

    @property
    def cache_plan(self) -> FixedCachePlan:
        return self._need_cache().current[0]

    def rebuild_cache_table(self, update: PlanUpdate,
                            dtype=None) -> BankedTable | None:
        """Cache-aware replans: rebuild the GRACE partial-sum table under the
        new plan (entries re-summed from the CURRENT row values of their
        members, as the reference's numpy sum, placed on the banks
        Algorithm 1 chose); under ``dist`` this rank's bank of it. A check,
        not the swap's path."""
        if update.cache_plan is None:
            return None
        t, cp = self.table, update.cache_plan
        members = np.unique(np.fromiter(
            (m for e in cp.entries for m in e.members), np.int64,
            count=sum(len(e.members) for e in cp.entries)))
        rows = self._member_rows(members).cpu().numpy()
        pos = {int(m): i for i, m in enumerate(members)}
        cache_np = np.zeros((max(cp.n_entries, 1), t.dim), rows.dtype)
        for e, entry in enumerate(cp.entries):
            cache_np[e] = rows[[pos[int(m)] for m in entry.members]].sum(0)
        plan = update.plan
        if plan.cache_bank_of_entry is None:
            cplan = uniform_partition(cache_np.shape[0], t.n_banks)
        else:
            cplan = _cache_side_plan(plan, cp, t.n_banks)
        return self._bank_piece(pack_table(cache_np, cplan, dtype=dtype,
                                           device=t.packed.device))

    def migrate_aux(self, arr: torch.Tensor, update_or_plan) -> torch.Tensor:
        """Permute a packed-row-aligned tensor (optimizer state) to match a
        plan that apply() is about to install. Call BEFORE apply() — it
        needs the pre-swap remap still on self.table. Under ``dist``
        ``arr`` is this rank's shard, moved through the migration's
        exchange (every rank of the grid calls it)."""
        plan = update_or_plan.plan if isinstance(update_or_plan, PlanUpdate) \
            else update_or_plan
        return migrate_rowwise_state(arr, self.table, plan, self.dist,
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


def bank_capacity(vocab: int, n_banks: int, capacity_slack: float) -> int:
    """The adaptive launchers' fixed per-bank EMT capacity: ``ceil(vocab /
    n_banks) * (1 + capacity_slack)`` rows, the headroom every later plan
    packs into."""
    return int(np.ceil(vocab / n_banks) * (1.0 + capacity_slack))


def cache_lane_runtime(table: BankedTable, plan: PartitionPlan, *,
                       multi_hot: int, replan_every: int, cache_entries: int,
                       hysteresis: float = 0.0, tracer=None,
                       metrics: MetricRegistry | None = None, dist=None
                       ) -> AdaptiveEmbeddingRuntime:
    """The runtime of the cache lane (``--adaptive --partition
    cache_aware``) with the reference launchers' settings: cache-aware
    replans every ``replan_every`` batches, ``ceil(cache_entries /
    n_banks)`` cache entries a bank, ``mine_min_support=2``, telemetry
    decayed by 0.8 every 4096 observations, an all-ones initial frequency,
    at most ``max(2, multi_hot // 4)`` cache and ``multi_hot`` residual
    slots a bag. Raises for one-hot bags (a partial sum fuses two or more
    lookups of one bag). ``dist``: ``table`` is this rank's bank shard."""
    if multi_hot < 2:
        raise ValueError("--partition cache_aware needs multi-hot bags (try "
                         "updlrm-paper): GRACE partial sums fuse >= 2 "
                         "lookups of one bag")
    banks, vocab = table.n_banks, table.vocab
    cfg = ReplanConfig.for_vocab(
        vocab, banks, capacity_rows=table.rows_per_bank,
        check_every=replan_every, partitioner="cache_aware",
        cache_rows_per_bank=max(1, -(-cache_entries // banks)),
        mine_min_support=2, hysteresis=hysteresis, telemetry_decay=0.8,
        telemetry_decay_every=4096)
    return AdaptiveEmbeddingRuntime(
        table, plan, cfg, dist=dist, init_freq=np.ones(vocab),
        max_cache_per_bag=max(2, multi_hot // 4),
        max_residual_per_bag=multi_hot, tracer=tracer, metrics=metrics)


def _cache_side_plan(plan: PartitionPlan, cache_plan, n_banks: int
                     ) -> PartitionPlan:
    """Entry -> (bank, slot) for the partial-sum table: every subset entry
    lives on its mined group's bank (Algorithm 1's co-location invariant);
    groups that overflowed the cache fall back to bank of member 0."""
    n_entries = max(cache_plan.n_entries, 1)
    bank = np.zeros(n_entries, dtype=np.int32)
    for eid, entry in enumerate(cache_plan.entries):
        g = _group_of(cache_plan, eid)
        b = int(plan.cache_bank_of_entry[g]) if g is not None else -1
        bank[eid] = b if b >= 0 else int(plan.bank_of_row[entry.members[0]])
    slot = np.zeros(n_entries, dtype=np.int32)
    rows_per_bank = np.zeros(n_banks, dtype=np.int32)
    for e in range(n_entries):
        slot[e] = rows_per_bank[bank[e]]
        rows_per_bank[bank[e]] += 1
    freq = np.array([e.hits for e in cache_plan.entries], np.float64) \
        if cache_plan.entries else np.zeros(1)
    load = np.zeros(n_banks)
    np.add.at(load, bank, freq[:n_entries])
    return PartitionPlan(n_banks=n_banks, bank_of_row=bank, slot_of_row=slot,
                         rows_per_bank=rows_per_bank, load_per_bank=load)


def _group_of(cache_plan, entry_id: int) -> int | None:
    """The first group whose members hold entry ``entry_id``'s."""
    members = set(cache_plan.entries[entry_id].members)
    for g, grp in enumerate(cache_plan.groups):
        if members <= set(int(x) for x in grp):
            return g
    return None
