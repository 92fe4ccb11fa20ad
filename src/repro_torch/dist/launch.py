"""Run a function on every rank of a ``torch.distributed`` world of local
processes: the launcher of the bank axis's tests and of ``chip_smoke.py``.

    outs = run_ranks(fn, world_size, workdir, inputs={"x": arr},
                     backend="gloo")

starts ``world_size`` processes from a ``spawn`` context (the parent may
hold CUDA already, which a fork cannot carry), each joining one process
group through a ``file://`` rendezvous under ``workdir`` with
``init_process_group(timeout=init_timeout)``, which also bounds every
collective. Rank ``r`` calls ``fn(r, world_size, inputs)`` and returns a
dict of numpy arrays; ``run_ranks`` returns the ranks' dicts in rank order.

Arrays travel as ``.npy`` files under ``workdir`` (``inputs`` are loaded
memory-mapped, read-only), not as shared-memory tensors: a container's
``/dev/shm`` may be small. ``fn`` must be importable by name (a module's
top-level function) for the spawned process to find it.

A failure is never swallowed: a rank that raises writes its traceback and
exits non-zero; a rank still running at the deadline (``timeout`` seconds
from the start) is killed. Either way every rank is stopped and
``run_ranks`` raises ``RankError`` with each failed rank's traceback.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

import numpy as np


class RankError(RuntimeError):
    """A rank raised, exited non-zero or outlived the deadline."""


def _rank_main(fn, rank: int, world_size: int, workdir: str, backend: str,
               init_timeout: float, names: list[str]) -> None:
    import torch
    import torch.distributed as tdist
    wd = Path(workdir)
    try:
        torch.set_num_threads(1)
        tdist.init_process_group(
            backend, init_method=f"file://{wd / 'rendezvous'}",
            world_size=world_size, rank=rank,
            timeout=datetime.timedelta(seconds=init_timeout))
        try:
            inputs = {n: np.load(wd / f"in.{n}.npy", mmap_mode="r")
                      for n in names}
            out = fn(rank, world_size, inputs)
            for k, v in (out or {}).items():
                np.save(wd / f"out.{rank}.{k}.npy", np.asarray(v))
            (wd / f"done.{rank}").write_text(" ".join(out or {}))
        finally:
            tdist.destroy_process_group()
    except BaseException:
        (wd / f"error.{rank}.txt").write_text(traceback.format_exc())
        raise SystemExit(1)


def run_ranks(fn, world_size: int, workdir: str | os.PathLike, *,
              inputs: dict[str, np.ndarray] | None = None,
              backend: str = "gloo", timeout: float = 300.0,
              init_timeout: float = 60.0) -> list[dict[str, np.ndarray]]:
    """``fn(rank, world_size, inputs) -> {name: array}`` on ``world_size``
    spawned ranks of one process group; the ranks' outputs in rank order.
    ``workdir`` (created; must be empty of an earlier run's files) holds
    the rendezvous and the arrays. Raises ``RankError`` if any rank fails
    or is still running ``timeout`` seconds after the start."""
    wd = Path(workdir).resolve()       # a file:// URL needs an absolute path
    wd.mkdir(parents=True, exist_ok=True)
    if any(wd.iterdir()):
        raise ValueError(f"run_ranks: workdir {wd} is not empty")
    names = sorted(inputs or {})
    for n in names:
        np.save(wd / f"in.{n}.npy", np.asarray(inputs[n]))
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world_size, str(wd), backend,
                               init_timeout, names), daemon=True)
             for r in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.is_alive() for p in procs):
            if time.monotonic() > deadline \
                    or any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
    failed = []
    for r, p in enumerate(procs):
        err = wd / f"error.{r}.txt"
        if err.exists():
            failed.append(f"--- rank {r} (exit {p.exitcode}) ---\n"
                          f"{err.read_text()}")
        elif p.exitcode != 0 or not (wd / f"done.{r}").exists():
            failed.append(f"--- rank {r}: exit {p.exitcode}"
                          + (" (killed at the deadline)"
                             if time.monotonic() > deadline else "") + " ---")
    if failed:
        raise RankError(f"{len(failed)} of {world_size} ranks failed:\n"
                        + "\n".join(failed))
    return [{k: np.load(wd / f"out.{r}.{k}.npy")
             for k in (wd / f"done.{r}").read_text().split()}
            for r in range(world_size)]
