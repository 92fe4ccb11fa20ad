"""End-to-end example on the PyTorch port: train a ~100M-parameter DLRM.

Model: 1.5M-row x 64-dim banked embedding (non-uniform partitioned from a
profiled trace) + Criteo-style MLPs -> ~98M params. Demonstrates the whole
substrate: partitioner -> banked table -> row-wise Adagrad + Adam ->
checkpoint/restart (a crash injected mid-run!) -> deterministic replay.
The port of ``examples/train_dlrm_e2e.py``; its checkpoints are in the
reference's on-disk format.

    PYTHONPATH=src python examples/torch_train_dlrm_e2e.py [--steps 200]
        [--device cpu] [--init-from DIR]

``--init-from DIR`` starts from the params of the latest step in DIR, a
checkpoint in the reference's format written by either package (for
example the reference's initial state, to train from its weights).
"""
import argparse
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint)
from repro_torch.core.partitioning import non_uniform_partition
from repro_torch.data.synthetic import dlrm_batch
from repro_torch.dist.fault import FailureInjector, run_with_restarts
from repro_torch.models import dlrm as D
from repro_torch.train.train_step import (TrainState, build_train_step,
                                          default_optimizer)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--ckpt", default=str(Path(tempfile.gettempdir())
                                          / "updlrm_torch_e2e_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--crash-at", type=int, default=120)
    ap.add_argument("--init-from", default=None,
                    help="start from the params of this checkpoint")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    shutil.rmtree(args.ckpt, ignore_errors=True)

    # ~100M params: 3 x 500k-row tables x 64 dims = 96M + MLPs
    cfg = D.DLRMConfig(
        name="dlrm-100m", vocab_sizes=(500_000, 500_000, 500_000),
        embed_dim=64, n_dense=13, bot_mlp=(512, 256, 64),
        top_mlp=(512, 256))
    print(f"params: {cfg.param_count():,}")

    # profile a trace -> frequency-aware (non-uniform) partition, 8 banks
    rng = np.random.default_rng(0)
    freq = (np.arange(1, cfg.total_vocab + 1) ** -0.9)[rng.permutation(
        cfg.total_vocab)]
    plan = non_uniform_partition(freq, 8, batch=4096)
    print(f"banked over {plan.n_banks} banks, imbalance "
          f"{plan.imbalance():.3f}")

    params, statics = D.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), plan, device=dev)
    opt = default_optimizer(lr=1e-3, emb_lr=1e-2)
    if args.init_from is not None:
        params = restore_checkpoint(args.init_from,
                                    TrainState.create(params, opt))[0].params
        print(f"initial params from {args.init_from}")
    step_fn = build_train_step(lambda p, b: D.loss_fn(cfg, p, statics, b),
                               opt)

    injector = FailureInjector(fail_at_step=args.crash_at)
    ck = AsyncCheckpointer(args.ckpt, keep=2)
    losses: list[float] = []

    def loop(start: int) -> int:
        state = TrainState.create(params, opt)
        if latest_step(args.ckpt) is not None:
            state, s0 = restore_checkpoint(args.ckpt, state)
            print(f"  [restart] restored step {s0}")
        t0 = time.time()
        for step in range(start, args.steps):
            injector.check(step)           # simulated host failure
            b = dlrm_batch(cfg.vocab_sizes, cfg.n_dense, args.batch,
                           seed=0, step=step)
            state, m = step_fn(state, {k: torch.from_numpy(v).to(dev)
                                       for k, v in b.items()})
            losses.append(float(m["loss"]))
            if step % 25 == 0:
                print(f"  step {step:4d} loss {losses[-1]:.4f}")
            if (step + 1) % args.ckpt_every == 0:
                ck.save(step + 1, state)
        ck.save(args.steps, state)
        ck.join()
        print(f"  {args.steps - start} steps in {time.time() - t0:.1f}s")
        return args.steps

    run_with_restarts(loop, restore_step=lambda: latest_step(args.ckpt) or 0)
    print(f"crash injected at step {args.crash_at}: "
          f"{'yes' if injector.fired else 'no'}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"({'improved' if losses[-1] < losses[0] else 'NO IMPROVEMENT'})")


if __name__ == "__main__":
    main()
