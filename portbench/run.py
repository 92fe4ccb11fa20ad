#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's configuration (its ``file``, which names the model
adapter that binds the program and the plain reference that checks it:
``portbench/models/``, ``portbench/reference/``), its traffic mix
(``portbench/traffic/<traffic>.json``, which names the generator that
reads it and the mode that drives the program: ``portbench/generators/``,
``portbench/modes/``), its limits (``portbench/limits/<cell>.json``) and a
reader a metric (``portbench/metrics/<metric>.py``, a ``read(ctx)`` that
returns the value or None): the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``. The system under
test is the PyTorch and CUDA port, ``src/repro_torch``.

A run builds the traffic from the seed on the card, has the adapter make
the weights from the seed and do the program's set-up, warms every shape
the cell uses, measures for ``--seconds`` (under the profiler with
``--trace 1``), reads the peak memory, then checks what the window
produced against the plain reference. It prints each number compared
beside its limit as the last lines of standard error, and one JSON line as
the last line of standard output. It exits non-zero and prints no result
without a card, or if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def cell_parts(name: str) -> SimpleNamespace:
    """The cell's entry, configuration, mix and limits, found by name."""
    b = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in b["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in b["configs"]}[w["config"]]
    return SimpleNamespace(
        cell=w, cfg=load_json(ROOT / conf["file"]),
        mix=load_json(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(HERE / "limits" / f"{name}.json"),
        end_to_end=[m for m in b["end_to_end"] if name in m.get(
            "workloads", [name])],
        per_layer=[m for m in b["per_layer"] if name in m.get(
            "workloads", [name])])


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", parts: SimpleNamespace | None = None
             ) -> tuple[dict, list[str]]:
    """One run of cell ``name``: (the result's object, the check's lines).
    ``parts`` replaces what ``cell_parts`` finds (the tests' small
    cells)."""
    import torch
    from portbench import drive
    parts = parts or cell_parts(name)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = bool(parts.cfg["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(parts.cfg["tf32"])
    mode = drive.load("modes", parts.mix["mode"])
    st = drive.build(parts.cfg, parts.mix, seed, device)
    setup = {}

    def on_setup():
        setup["s"] = time.perf_counter() - _T0

    run = mode.run(st, seconds, trace, on_setup)
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    values = mode.check(st, run)
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad} (jax, jaxlib, flax or the "
              f"JAX package repro)", file=sys.stderr)
        raise SystemExit(3)
    checks = {k: {"value": v, "limit": parts.limits[k]}
              for k, v in values.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    if trace and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
    ctx = SimpleNamespace(cfg=parts.cfg, mix=parts.mix, run=run,
                          summary=run.summary, setup_s=setup["s"])
    metrics = {}
    for m in parts.per_layer if trace else parts.end_to_end:
        v = drive.load("metrics", m["name"]).read(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.summary is not None:
        out["breakdown"] = run.summary.breakdown()
    out["checks"] = checks
    lines = [f"check {k}: {c['value']!r} limit {c['limit']!r} "
             f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
             for k, c in checks.items()]
    return out, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    parts = cell_parts(args.workload)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < parts.cell["chips"]:
        print(f"the cell needs {parts.cell['chips']} cards, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out, lines = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace), parts=parts)
    sys.stderr.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
