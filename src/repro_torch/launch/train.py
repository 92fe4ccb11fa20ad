"""Training CLI: ``python -m repro_torch.launch.train --arch updlrm-paper``.

The port of ``repro/launch/train.py``: config -> params -> train step ->
loop over synthetic batches. ``main`` parses the arguments and trains the
arch's reduced config (``--full``: the full config) on CUDA; ``run`` does
the work of the plain path for any config and device and returns the
losses, the per-step times, the final state and the last batch. ``run``
trains every family but GAT (lm, dlrm, din, bert4rec, xdeepfm; the LMs on
sequences of 64 tokens, ``lm_loss``, params from
``transformer.init_params``); the adaptive paths are dlrm only, and
``--arch gat-cora`` is refused, as in the reference.

``run_adaptive`` (``--adaptive``) repartitions the banked table while it
trains: with ``partition='non_uniform'`` telemetry on every batch's rows,
drift checks and §3.2 replans, each migration moving the table AND its
row-wise Adagrad state to the new plan; with ``partition='cache_aware'``
the fused cache + residual train path, every batch rewritten on the host
and the remaps and the GRACE cache table passed to the step as arguments,
so a migration and the periodic partial-sum refresh swap through the
runtime's versioned cache lane.

Both loops run the reference's ``StragglerWatchdog`` on every step's wall
time and feed the ``--trace-out`` / ``--metrics-out`` exports (spans
``rewrite``, ``device_step``, ``migrate``, ``cache_refresh``; the
``train.*``, ``fault.*`` and, adaptive, ``obs.bank_*`` series).

``compress_grads`` (``--compress-grads``) trains with int8 error-feedback
gradient compression on every path. ``ckpt_dir`` (``--ckpt-dir``) restores
the latest complete checkpoint at start and saves every ``ckpt_every``
steps and at the end through an ``AsyncCheckpointer``, in the reference's
on-disk format; the adaptive §3.2 path saves the live plan's remaps beside
each step and restores them with it. The cache-aware path ignores
``ckpt_dir``, as the reference's does.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.configs import get_arch
from repro_torch.core.embedding import BankedTable, flat_remap
from repro_torch.core.partitioning import non_uniform_partition
from repro_torch.data import synthetic as syn
from repro_torch.dist.fault import StragglerWatchdog
from repro_torch.models import dlrm, family_module
from repro_torch.obs.cli import add_obs_args, finalize_obs, setup_obs
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.metrics_export import PeriodicMetricsWriter
from repro_torch.obs.tracing import NULL_TRACER, Tracer
from repro_torch.obs.traffic import (TrafficAccumulator,
                                     host_bank_read_counts,
                                     host_cached_bank_read_counts)
from repro_torch.train.train_step import (TrainState, build_train_step,
                                          default_optimizer)
from repro_torch.workload.migrate import migrate_packed_leaves
from repro_torch.workload.replanner import ReplanConfig, Replanner
from repro_torch.workload.runtime import (AdaptiveEmbeddingRuntime,
                                          bank_capacity, cache_lane_runtime)
from repro_torch.workload.telemetry import rows_from_sparse


@dataclasses.dataclass
class TrainResult:
    losses: list[float]         # per step, the loss the step was taken on
    step_ms: list[float]        # host clock per step, ending in a synchronize
    state: TrainState           # after the last step
    statics: dict               # the remaps and field offsets trained through
    last_batch: dict            # the last batch, as tensors on the device
    stragglers: list[int]       # steps the StragglerWatchdog flagged
    start_step: int             # the restored step (0 without one); losses
                                # and step_ms cover steps start_step..steps-1
    checkpoints: dict | None    # with ckpt_dir: the saves' AsyncCheckpointer
                                # stats, the restore's seconds (or None)


def make_batch_fn(spec, cfg):
    """``fn(batch, seed, step)``: a numpy batch of the family's synthetic
    generator, deterministic in ``(seed, step)``
    (``data.synthetic.family_batch``). A family without one (GAT, whose
    cells are graphs: ``configs/shapes.py``) is refused here, with the
    reference's message."""
    if spec.family not in syn.BATCH_FAMILIES:
        raise ValueError(f"use examples/ for family {spec.family}")
    return lambda batch, seed, step: syn.family_batch(
        spec.family, cfg, batch, seed=seed, step=step)


def build_loss(spec, cfg, statics, backend: str | None = None,
               bwd_backend: str | None = None):
    """The family loss and the kwargs the train step binds to it (dlrm's
    embedding backend pair; the other families take none)."""
    mod = family_module(spec.family)
    kw = {}
    if spec.family == "dlrm":
        if backend is not None:
            kw["backend"] = backend
        if bwd_backend is not None:
            kw["bwd_backend"] = bwd_backend
    return (lambda p, b, **k: mod.loss_fn(cfg, p, statics, b, **k)), kw


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class _Checkpoints:
    """The loops' checkpointing, as the reference's: restore the latest
    complete step at start, save every ``every`` steps and at the end,
    then join. ``ckpt_dir`` None: every call is a no-op."""

    def __init__(self, ckpt_dir: str | None, every: int):
        self.dir, self.every = ckpt_dir, every
        self.ck = AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
        self.restore_s = None

    def restore(self, state: TrainState) -> tuple[TrainState, int]:
        if self.ck is None or latest_step(self.dir) is None:
            return state, 0
        t0 = time.perf_counter()
        state, start = restore_checkpoint(self.dir, state)
        self.restore_s = time.perf_counter() - t0
        return state, start

    def step_done(self, step: int, state: TrainState,
                  before_save=None) -> None:
        """Save after step index ``step`` when the cadence says so;
        ``before_save(n)`` runs first (the remaps saved beside step n)."""
        if self.ck is not None and (step + 1) % self.every == 0:
            if before_save is not None:
                before_save(step + 1)
            self.ck.save(step + 1, state)

    def finish(self, steps: int, state: TrainState, before_save=None) -> None:
        """The end-of-run save, then join."""
        if self.ck is None:
            return
        if before_save is not None:
            before_save(steps)
        self.ck.save(steps, state)
        self.ck.join()

    def record(self) -> dict | None:
        return None if self.ck is None else {"saves": self.ck.stats,
                                             "restore_s": self.restore_s}


class _StepObs:
    """The train loops' per-step observability, as the reference's loops
    have it: the ``train.step_ms`` histogram, the ``StragglerWatchdog`` on
    every step's wall time (``fault.straggler_events_total``), the
    ``train.migrations_total`` counter and the snapshot writer's cadence."""

    def __init__(self, tracer, metrics, writer):
        self.tracer = NULL_TRACER if tracer is None else tracer
        self.metrics = MetricRegistry() if metrics is None else metrics
        self.writer = writer
        self.step_ms = self.metrics.histogram("train.step_ms",
                                              "train-step wall time")
        self.migrations = self.metrics.counter(
            "train.migrations_total", "drift-triggered table migrations")
        self.watchdog = StragglerWatchdog(metrics=self.metrics)

    def step_done(self, step: int, ms: float) -> None:
        self.step_ms.observe(ms)
        self.watchdog.observe(step, ms / 1e3)

    def end_step(self, step: int) -> None:
        if self.writer is not None:
            self.writer.maybe_write(step + 1)


def run(spec, cfg, *, steps: int, batch: int, seed: int = 0,
        lr: float = 1e-3, emb_lr: float = 1e-2,
        device: str | torch.device | None = "cuda", backend: str = "auto",
        bwd_backend: str = "auto", plan=None, compress_grads: bool = False,
        ckpt_dir: str | None = None, ckpt_every: int = 50,
        tracer: Tracer | None = None, metrics: MetricRegistry | None = None,
        writer: PeriodicMetricsWriter | None = None) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` synthetic examples
    (batch ``i`` drawn from ``(seed, i)``). Weights are drawn from ``seed``
    on ``device``; ``plan`` is the PartitionPlan of the super-table
    (default: one bank). Adam for the dense weights, row-wise Adagrad for
    the table; ``compress_grads``: int8 error-feedback compression of the
    clipped gradients. ``ckpt_dir``: the latest complete checkpoint there
    is restored first (training resumes at its step) and the state is
    saved every ``ckpt_every`` steps and at the end. Every step's wall time
    goes through a ``StragglerWatchdog`` (flagged steps in
    ``stragglers``); ``tracer`` gets a ``rewrite`` (batch draw and copy)
    and a ``device_step`` span a step, ``metrics`` the ``train.*`` and
    ``fault.*`` series, ``writer`` a snapshot on its cadence. Raises when
    ``device`` is CUDA and there is none."""
    dev = resolve_device(device)
    obs = _StepObs(tracer, metrics, writer)
    batch_fn = make_batch_fn(spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if spec.family == "lm":
        params, statics = family_module("lm").init_params(
            cfg, gen, device=dev), {}
    else:
        params, statics = family_module(spec.family).init_params(
            cfg, gen, plan=plan, device=dev)
    opt = default_optimizer(lr=lr, emb_lr=emb_lr)
    loss_fn, loss_kw = build_loss(spec, cfg, statics, backend=backend,
                                  bwd_backend=bwd_backend)
    step_fn = build_train_step(loss_fn, opt, compress_grads=compress_grads,
                               loss_kwargs=loss_kw)
    ckpt = _Checkpoints(ckpt_dir, ckpt_every)
    state, start = ckpt.restore(
        TrainState.create(params, opt, compress=compress_grads))
    del params
    losses, times, b = [], [], {}
    for step in range(start, steps):
        with obs.tracer.span("rewrite", step=step):
            b = to_device(batch_fn(batch, seed, step), dev)
        t0 = time.perf_counter()
        with obs.tracer.span("device_step", step=step):
            state, out = step_fn(state, b)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out["loss"]))
        obs.step_done(step, times[-1])
        obs.end_step(step)
        ckpt.step_done(step, state)
    ckpt.finish(steps, state)
    return TrainResult(losses=losses, step_ms=times, state=state,
                       statics=statics, last_batch=b,
                       stragglers=list(obs.watchdog.events),
                       start_step=start, checkpoints=ckpt.record())


@dataclasses.dataclass
class AdaptiveTrainResult(TrainResult):
    """``run_adaptive``'s result: a ``TrainResult`` (``statics`` hold the
    LIVE plan's remaps) plus the adaptive loop's record."""
    partition: str
    migrations: list[tuple]     # (step, PlanUpdate), in order
    refreshes: list[tuple]      # cache_aware: (step, installed version)
    reads: list[np.ndarray]     # per step: (banks,) host-counted reads
    rewritten: list[tuple]      # cache_aware, per step: (cache_idx,
                                # residual_idx, version) as trained on
    runtime: AdaptiveEmbeddingRuntime | None   # cache_aware
    host_ms: dict               # per step: batch (draw, tap, rewrite);
                                # per migration: replan, migrate, swap;
                                # per refresh: refresh (ms)


def _migrate_state(state: TrainState, table: BankedTable, plan,
                   cap: int) -> TrainState:
    """Params, optimizer state and error-feedback state moved to ``plan``
    in one pass: every packed-row-aligned leaf (the table, its row-wise
    Adagrad accumulator, its compression error) follows its rows."""
    def move(tree):
        return migrate_packed_leaves(tree, table, plan, rows_per_bank=cap)
    return TrainState(params=move(state.params),
                      opt_state=move(state.opt_state), step=state.step,
                      err_state=move(state.err_state))


def _remaps(plan, dev, packed: torch.Tensor, banks: int,
            cap: int) -> BankedTable:
    return BankedTable(
        packed=packed,
        remap_bank=torch.from_numpy(plan.bank_of_row.astype(np.int32)).to(dev),
        remap_slot=torch.from_numpy(plan.slot_of_row.astype(np.int32)).to(dev),
        n_banks=banks, rows_per_bank=cap)


def run_adaptive(spec, cfg, *, steps: int, batch: int,
                 partition: str = "non_uniform", banks: int = 8,
                 replan_every: int = 25, capacity_slack: float = 0.25,
                 cache_entries: int = 128, cache_refresh_every: int = 25,
                 seed: int = 0, lr: float = 1e-3, emb_lr: float = 1e-2,
                 device: str | torch.device | None = "cuda",
                 backend: str = "auto", bwd_backend: str = "auto",
                 params: dict | None = None, compress_grads: bool = False,
                 ckpt_dir: str | None = None, ckpt_every: int = 50,
                 tracer: Tracer | None = None,
                 metrics: MetricRegistry | None = None,
                 writer: PeriodicMetricsWriter | None = None
                 ) -> AdaptiveTrainResult:
    """The reference's ``--adaptive`` training (``launch/train.py main``'s
    adaptive branch and ``_main_train_cached``): train ``cfg`` for ``steps``
    steps of ``batch`` synthetic examples (batch ``i`` drawn from ``(seed,
    i)``) while the banked table is repartitioned on drift.

    Set-up, as the reference: a per-bank capacity of ``ceil(V / banks) * (1
    + capacity_slack)`` rows; the initial plan is the §3.2 greedy on
    all-ones frequencies; the weights come from ``dlrm.init_params(seed)``
    on ``device`` unless ``params`` is given (packed under that plan); Adam
    for the dense weights, row-wise Adagrad for the table;
    ``compress_grads``: int8 error-feedback compression (the error buffers
    migrate with their rows).

    ``partition='non_uniform'``: a ``Replanner`` (``check_every=
    replan_every``) observes every batch's union-vocab rows; each step's
    per-bank reads are counted on the host under the live plan; on an
    update the params and the optimizer state migrate together and the
    remaps the loss reads are replaced. ``ckpt_dir`` as ``run``'s, with the
    live plan's remaps saved beside every step
    (``adaptive_remaps_<step>.npz``) and restored with it, so a table that
    migrated restores with its own remaps (the replanner starts afresh).

    ``partition='cache_aware'``: the serve loop's cache-lane runtime
    (``cache_lane_runtime``: ``ceil(cache_entries / banks)`` entries a
    bank, ``mine_min_support=2``, ``telemetry_decay=0.8`` every 4096, at
    most ``max(2, L // 4)`` cache and ``L`` residual slots a bag). Each
    step: ``observe_bags`` and ``runtime.rewrite`` of
    the batch, the fused loss with the live remaps and the cache table of
    the batch's version as ARGUMENTS (the cache table takes no gradient),
    the runtime's view rebound to the trained table; on an update the
    params and optimizer state migrate and the runtime adopts the table
    (``apply_migrated``: a new cache version re-summed from the trained
    rows); otherwise every ``cache_refresh_every`` steps
    ``runtime.refresh_cache()``. Reads per step count a cache hit as one
    read on its entry's bank; they feed a ``TrafficAccumulator``
    (``obs.bank_*``). It ignores ``ckpt_dir``, as the reference's does.

    Observability as ``run``'s (the watchdog, ``tracer``, ``metrics``,
    ``writer``), plus ``migrate`` and ``cache_refresh`` spans and, on the
    cache-aware path, ``train.cache_refreshes_total``; the runtime's own
    spans and series land in the same tracer and registry. Raises when
    ``device`` is CUDA and there is none."""
    if spec.family != "dlrm":
        raise ValueError(f"run_adaptive drives the banked super-table of a "
                         f"dlrm; {spec.arch_id} is a {spec.family}")
    if partition not in ("non_uniform", "cache_aware"):
        raise ValueError(f"partition must be 'non_uniform' or 'cache_aware',"
                         f" got {partition!r}")
    dev = resolve_device(device)
    obs = _StepObs(tracer, metrics, writer)
    cached = partition == "cache_aware"
    V = cfg.total_vocab
    cap = bank_capacity(V, banks, capacity_slack)
    offs = cfg.field_offsets()
    plan = non_uniform_partition(np.ones(V), banks, capacity_rows=cap)
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
    opt = default_optimizer(lr=lr, emb_lr=emb_lr)
    state = TrainState.create(params, opt, compress=compress_grads)
    batch_fn = make_batch_fn(spec, cfg)
    kw = {"backend": backend, "bwd_backend": bwd_backend}
    ckpt = _Checkpoints(None if cached else ckpt_dir, ckpt_every)
    start = 0
    runtime = replanner = None
    if cached:
        table = BankedTable(packed=params["emb_packed"],
                            remap_bank=statics["remap_bank"],
                            remap_slot=statics["remap_slot"], n_banks=banks,
                            rows_per_bank=cap,
                            remap_flat=statics["remap_flat"])
        runtime = cache_lane_runtime(
            table, plan, multi_hot=cfg.multi_hot, replan_every=replan_every,
            cache_entries=cache_entries,
            tracer=obs.tracer, metrics=obs.metrics)
        replanner = runtime.replanner
        m_refreshes = obs.metrics.counter(
            "train.cache_refreshes_total",
            "periodic partial-sum re-sums (staleness)")

        def loss_cached(p, b, **k):
            logits = dlrm.forward_cached(
                cfg, p, statics, b["cache_table"],
                {"dense": b["dense"], "cache_idx": b["cache_idx"],
                 "residual_idx": b["residual_idx"]},
                remap_bank=b["remap_bank"], remap_slot=b["remap_slot"],
                remap_flat=b["remap_flat"], **k)
            return dlrm.bce_loss(logits, b["label"])
        step_fn = build_train_step(loss_cached, opt,
                                   compress_grads=compress_grads,
                                   loss_kwargs=kw)
    else:
        replanner = Replanner(
            ReplanConfig.for_vocab(V, banks, capacity_rows=cap,
                                   check_every=replan_every),
            V, init_freq=np.ones(V), metrics=obs.metrics)
        bank_of_row = plan.bank_of_row
        state, start = ckpt.restore(state)
        # the restored table follows the plan that was live at its save:
        # its remaps come back with it (None: saved without --adaptive)
        remaps = _load_remaps(ckpt_dir, start) if start else None
        if remaps is not None:
            bank = torch.from_numpy(remaps["remap_bank"]).to(dev)
            slot = torch.from_numpy(remaps["remap_slot"]).to(dev)
            statics = {**statics, "remap_bank": bank, "remap_slot": slot,
                       "remap_flat": flat_remap(bank, slot, cap)}
            bank_of_row = remaps["remap_bank"]
        loss_fn, loss_kw = build_loss(spec, cfg, statics, **kw)
        step_fn = build_train_step(loss_fn, opt,
                                   compress_grads=compress_grads,
                                   loss_kwargs=loss_kw)
    del params

    traffic = TrafficAccumulator(
        obs.metrics, banks,
        row_nbytes=cfg.embed_dim * state.params["emb_packed"].element_size())
    losses, times, reads, rewritten = [], [], [], []
    migrations, refreshes = [], []
    host_ms = {"batch": [], "replan": [], "migrate": [], "swap": [],
               "refresh": []}
    b = {}

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def save_remaps(n: int) -> None:
        # the live plan's remaps (``statics`` is rebound on a migration)
        _save_remaps(ckpt_dir, statics, n)

    for step in range(start, steps):
        t0 = time.perf_counter()
        with obs.tracer.span("rewrite", step=step):
            host = batch_fn(batch, seed, step)
            if cached:
                u = rows_from_sparse(host["sparse"], offs)      # (B, F, L)
                runtime.observe_bags(
                    [bag[bag >= 0] for bag in u.reshape(-1, u.shape[-1])])
                rb = runtime.rewrite(u)
                ctab = runtime.cache_table_for(rb.version)
                reads.append(host_cached_bank_read_counts(
                    runtime.rewriter.plan_for(rb.version).entry_bank,
                    rb.cache_idx, runtime.plan.bank_of_row,
                    rb.residual_idx, banks))
                rewritten.append((rb.cache_idx, rb.residual_idx, rb.version))
                t = runtime.table
                # everything a swap replaces is a step ARGUMENT; the batch
                # resolves against the cache table it was rewritten for
                b = {**to_device({k: host[k] for k in ("dense", "label")},
                                 dev),
                     "cache_idx": torch.from_numpy(rb.cache_idx).to(dev),
                     "residual_idx": torch.from_numpy(
                         rb.residual_idx).to(dev),
                     "remap_bank": t.remap_bank, "remap_slot": t.remap_slot,
                     "remap_flat": t.remap_flat, "cache_table": ctab}
            else:
                rows = rows_from_sparse(host["sparse"], offs)
                replanner.observe_rows(rows)
                reads.append(host_bank_read_counts(bank_of_row, rows,
                                                   banks))
                b = to_device(host, dev)
            traffic.update(reads[-1])
        t1 = time.perf_counter()
        with obs.tracer.span("device_step", step=step):
            state, out = step_fn(state, b)
            sync()
        t2 = time.perf_counter()
        host_ms["batch"].append((t1 - t0) * 1e3)
        times.append((t2 - t1) * 1e3)
        losses.append(float(out["loss"]))
        obs.step_done(step, times[-1])
        if cached:
            # rebind the runtime's view to the trained table, so replans
            # and refreshes re-sum from CURRENT values
            t = runtime.table
            runtime.table = BankedTable(
                packed=state.params["emb_packed"], remap_bank=t.remap_bank,
                remap_slot=t.remap_slot, n_banks=banks, rows_per_bank=cap,
                remap_flat=t.remap_flat)
        update = replanner.end_batch()
        t3 = time.perf_counter()
        if update is not None:
            with obs.tracer.span("migrate", step=step):
                old = runtime.table if cached else BankedTable(
                    packed=state.params["emb_packed"],
                    remap_bank=statics["remap_bank"],
                    remap_slot=statics["remap_slot"], n_banks=banks,
                    rows_per_bank=cap, remap_flat=statics["remap_flat"])
                state = _migrate_state(state, old, update.plan, cap)
                new = _remaps(update.plan, dev, state.params["emb_packed"],
                              banks, cap)
                del old
                sync()
            t4 = time.perf_counter()
            if cached:
                runtime.apply_migrated(update, new)
                sync()
            else:
                statics = {**statics, "remap_bank": new.remap_bank,
                           "remap_slot": new.remap_slot,
                           "remap_flat": new.remap_flat}
                bank_of_row = update.plan.bank_of_row
                loss_fn, loss_kw = build_loss(spec, cfg, statics, **kw)
                step_fn = build_train_step(loss_fn, opt,
                                           compress_grads=compress_grads,
                                           loss_kwargs=loss_kw)
            migrations.append((step, update))
            obs.migrations.inc()
            for k, v in zip(("replan", "migrate", "swap"),
                            (t3 - t2, t4 - t3, time.perf_counter() - t4)):
                host_ms[k].append(v * 1e3)
        elif cached and (step + 1) % cache_refresh_every == 0:
            with obs.tracer.span("cache_refresh", step=step):
                refreshes.append((step, runtime.refresh_cache()))
                sync()
            m_refreshes.inc()
            host_ms["refresh"].append((time.perf_counter() - t3) * 1e3)
        obs.end_step(step)
        ckpt.step_done(step, state, save_remaps)
    ckpt.finish(steps, state, save_remaps)
    if cached:
        t = runtime.table
        statics = {**statics, "remap_bank": t.remap_bank,
                   "remap_slot": t.remap_slot, "remap_flat": t.remap_flat}
    return AdaptiveTrainResult(
        losses=losses, step_ms=times, state=state, statics=statics,
        last_batch=b, stragglers=list(obs.watchdog.events),
        start_step=start, checkpoints=ckpt.record(), partition=partition,
        migrations=migrations, refreshes=refreshes, reads=reads,
        rewritten=rewritten, runtime=runtime, host_ms=host_ms)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--emb-lr", type=float, default=1e-2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the full config (needs a card with the memory)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "torch", "cuda", "tuned"),
                    help="embedding bag and interaction: the CUDA kernels "
                         "('cuda'), their plain PyTorch versions ('torch'), "
                         "or the kernels on CUDA tensors with the bag "
                         "kernels' geometry from the dispatch cache "
                         "TUNE_dispatch_cuda.json ('tuned'; 'auto' means "
                         "'tuned')")
    ap.add_argument("--bwd-backend", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="the bag sums' gradient scatter only ('auto' "
                         "follows --backend)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu' (the plain "
                         "versions on the host)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="restore the latest complete checkpoint here, and "
                         "save every --ckpt-every steps and at the end "
                         "(ignored by --partition cache_aware, as in the "
                         "reference)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression with error feedback")
    ap.add_argument("--adaptive", action="store_true",
                    help="telemetry + drift-triggered repartitioning of the "
                         "banked table during training (run_adaptive); the "
                         "row-wise Adagrad state migrates with its rows")
    ap.add_argument("--partition", default="non_uniform",
                    choices=("non_uniform", "cache_aware"),
                    help="adaptive replanner (--adaptive): plain banked "
                         "(§3.2) or the fused GRACE cache + residual train "
                         "path (§3.3), the remaps and the cache table "
                         "passed to the step as arguments")
    ap.add_argument("--banks", type=int, default=8,
                    help="bank count for the adaptive partition")
    ap.add_argument("--replan-every", type=int, default=25,
                    help="steps between drift checks (--adaptive)")
    ap.add_argument("--capacity-slack", type=float, default=0.25,
                    help="per-bank row headroom over vocab/banks")
    ap.add_argument("--cache-entries", type=int, default=128,
                    help="TOTAL cache-entry capacity across banks "
                         "(cache_aware; fixed for the life of the run)")
    ap.add_argument("--cache-refresh-every", type=int, default=25,
                    help="steps between partial-sum refreshes (cache_aware):"
                         " trained rows drift away from their cached sums")
    add_obs_args(ap)
    args = ap.parse_args(argv)
    if args.backend == "auto":
        args.backend = "tuned"   # auto means: consult the dispatch cache
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.reduced
    if args.adaptive and spec.family != "dlrm":
        raise SystemExit("--adaptive drives the banked super-table (dlrm "
                         f"only); {args.arch} is a {spec.family}")
    print(f"arch={args.arch} family={spec.family} "
          f"params={cfg.param_count():,}")
    label = "train-cached" if args.adaptive and \
        args.partition == "cache_aware" else "train"
    tracer, metrics, writer = setup_obs(args, label=f"{label}:{args.arch}")
    obs = dict(tracer=tracer if args.trace_out else None, metrics=metrics,
               writer=writer)
    t_begin = time.perf_counter()
    ck = dict(compress_grads=args.compress_grads, ckpt_dir=args.ckpt_dir,
              ckpt_every=args.ckpt_every)
    if args.adaptive:
        res = run_adaptive(
            spec, cfg, steps=args.steps, batch=args.batch,
            partition=args.partition, banks=args.banks,
            replan_every=args.replan_every,
            capacity_slack=args.capacity_slack,
            cache_entries=args.cache_entries,
            cache_refresh_every=args.cache_refresh_every, seed=args.seed,
            lr=args.lr, emb_lr=args.emb_lr, device=args.device,
            backend=args.backend, bwd_backend=args.bwd_backend, **ck, **obs)
        for step, update in res.migrations:
            print(f"  [migrate @step {step}] {update.report} imbalance -> "
                  f"{update.plan.imbalance():.3f}")
        for step, version in res.refreshes:
            print(f"  [cache refresh @step {step}] -> v{version}")
    else:
        res = run(spec, cfg, steps=args.steps, batch=args.batch,
                  seed=args.seed, lr=args.lr, emb_lr=args.emb_lr,
                  device=args.device, backend=args.backend,
                  bwd_backend=args.bwd_backend, **ck, **obs)
    if res.start_step:
        print(f"restored step {res.start_step}")
    for step, (loss, ms) in enumerate(zip(res.losses, res.step_ms),
                                      start=res.start_step):
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({ms:.0f} ms)")
    print(f"done in {time.perf_counter() - t_begin:.1f}s; "
          f"stragglers={res.stragglers}")
    finalize_obs(args, tracer, metrics, writer, prefix="train")


def _remaps_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"adaptive_remaps_{step}.npz")


def _save_remaps(ckpt_dir: str, statics: dict, step: int) -> None:
    """Persist the LIVE plan's remap vectors for THIS checkpoint step, as
    the reference does: the packed table layout and its remaps restore as a
    pair, and the restored step may be older than the newest remaps.
    Written synchronously BEFORE the save, so a crash can only orphan a
    remaps file, never a checkpoint."""
    os.makedirs(ckpt_dir, exist_ok=True)
    np.savez(_remaps_path(ckpt_dir, step),
             remap_bank=statics["remap_bank"].cpu().numpy(),
             remap_slot=statics["remap_slot"].cpu().numpy())


def _load_remaps(ckpt_dir: str, step: int):
    p = _remaps_path(ckpt_dir, step)
    if not os.path.exists(p):
        return None     # saved without --adaptive: the initial plan holds
    with np.load(p) as z:
        return {"remap_bank": z["remap_bank"], "remap_slot": z["remap_slot"]}


if __name__ == "__main__":
    main()
