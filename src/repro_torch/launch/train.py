"""Training CLI: ``python -m repro_torch.launch.train --arch updlrm-paper``.

The port of the plain (non-adaptive) path of ``repro/launch/train.py``:
config -> params -> train step -> loop over synthetic batches. ``main``
parses the arguments and trains the arch's reduced config (``--full``: the
full config) on CUDA; ``run`` does the work for any config and device and
returns the losses, the per-step times, the final state and the last batch.
Checkpointing, gradient compression, the adaptive repartitioning loop and
the observability exporters are later slices and raise.
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
from repro_torch.train.train_step import (TrainState, build_train_step,
                                          default_optimizer)


@dataclasses.dataclass
class TrainResult:
    losses: list[float]         # per step, the loss the step was taken on
    step_ms: list[float]        # host clock per step, ending in a synchronize
    state: TrainState           # after the last step
    statics: dict               # the remaps and field offsets trained through
    last_batch: dict            # the last batch, as tensors on the device


def make_batch_fn(spec, cfg):
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    return lambda batch, seed, step: syn.dlrm_batch(
        cfg.vocab_sizes, cfg.n_dense, batch, seed=seed, step=step,
        multi_hot=cfg.multi_hot)


def build_loss(spec, cfg, statics, backend: str | None = None,
               bwd_backend: str | None = None):
    """The family loss and the kwargs the train step binds to it (the
    embedding backend pair)."""
    if spec.family != "dlrm":
        raise NotImplementedError(f"family {spec.family!r} is not ported yet")
    kw = {}
    if backend is not None:
        kw["backend"] = backend
    if bwd_backend is not None:
        kw["bwd_backend"] = bwd_backend
    return (lambda p, b, **k: dlrm.loss_fn(cfg, p, statics, b, **k)), kw


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def run(spec, cfg, *, steps: int, batch: int, seed: int = 0,
        lr: float = 1e-3, emb_lr: float = 1e-2,
        device: str | torch.device | None = "cuda", backend: str = "auto",
        bwd_backend: str = "auto", plan=None) -> TrainResult:
    """Train ``cfg`` for ``steps`` steps of ``batch`` synthetic examples
    (batch ``i`` drawn from ``(seed, i)``). Weights are drawn from ``seed``
    on ``device``; ``plan`` is the PartitionPlan of the super-table
    (default: one bank). Adam for the dense weights, row-wise Adagrad for
    the table. Raises when ``device`` is CUDA and there is none."""
    dev = resolve_device(device)
    batch_fn = make_batch_fn(spec, cfg)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, statics = dlrm.init_params(cfg, gen, plan=plan, device=dev)
    opt = default_optimizer(lr=lr, emb_lr=emb_lr)
    loss_fn, loss_kw = build_loss(spec, cfg, statics, backend=backend,
                                  bwd_backend=bwd_backend)
    step_fn = build_train_step(loss_fn, opt, loss_kwargs=loss_kw)
    state = TrainState.create(params, opt)
    losses, times, b = [], [], {}
    for step in range(steps):
        b = to_device(batch_fn(batch, seed, step), dev)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(metrics["loss"]))
    return TrainResult(losses=losses, step_ms=times, state=state,
                       statics=statics, last_batch=b)


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
                    choices=("auto", "torch", "cuda"),
                    help="embedding bag and interaction: the CUDA kernels "
                         "('cuda'), their plain PyTorch versions ('torch'), "
                         "or the kernels on CUDA tensors ('auto')")
    ap.add_argument("--bwd-backend", default="auto",
                    choices=("auto", "torch", "cuda"),
                    help="the bag sums' gradient scatter only ('auto' "
                         "follows --backend)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--adaptive", action="store_true")
    ap.add_argument("--trace-out", default=None)
    ap.add_argument("--metrics-out", default=None)
    args = ap.parse_args(argv)
    for flag, on, item in (("--ckpt-dir", args.ckpt_dir, "#17"),
                           ("--compress-grads", args.compress_grads, "#17"),
                           ("--adaptive", args.adaptive, "#10"),
                           ("--trace-out", args.trace_out, "#14"),
                           ("--metrics-out", args.metrics_out, "#14")):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet: ROADMAP "
                                      f"queue 1 {item}")
    spec = get_arch(args.arch)
    cfg = spec.config if args.full else spec.reduced
    print(f"arch={args.arch} family={spec.family} "
          f"params={cfg.param_count():,}")
    t_begin = time.perf_counter()
    res = run(spec, cfg, steps=args.steps, batch=args.batch, seed=args.seed,
              lr=args.lr, emb_lr=args.emb_lr, device="cuda",
              backend=args.backend, bwd_backend=args.bwd_backend)
    for step, (loss, ms) in enumerate(zip(res.losses, res.step_ms)):
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} ({ms:.0f} ms)")
    print(f"done in {time.perf_counter() - t_begin:.1f}s")


if __name__ == "__main__":
    main()
