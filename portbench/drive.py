"""What the ways of driving the program share, and the loader that finds a
cell's parts by name.

A configuration names its ``model`` (``portbench/models/<name>.py``, the
adapter that binds the program: its kernels, its set-up from the seed, its
train state in the reference's terms, its FLOPs and its spans) and its
``reference`` (``portbench/reference/<name>.py``, the plain model that
makes the same weights from the seed and checks the program). A mix names
its ``generator`` (``portbench/generators/<name>.py``, a class
``Traffic(cfg, mix, device)``) and its ``mode``
(``portbench/modes/<name>.py``): the mode's ``run(st, seconds, trace,
on_setup)`` does set-up through the measured window, its ``check(st, run,
**control)`` compares what the window produced with the reference, and its
``CONTROLS`` name the controls and faults that the limits' upper readings
come from. A metric is ``portbench/metrics/<name>.py``, whose
``read(ctx)`` returns its value or None. A later cell or model adds such
files; it edits none.
"""
from __future__ import annotations

import importlib.util
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

HERE = Path(__file__).resolve().parent
_LOADED: dict[Path, ModuleType] = {}


def load(kind: str, name: str) -> ModuleType:
    """``portbench/<kind>/<name>.py``, loaded once by its file."""
    path = HERE / kind / f"{name}.py"
    if path not in _LOADED:
        if not path.is_file():
            raise SystemExit(f"no {kind} entry {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"portbench_{kind}_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Clock:
    """Device-side elapsed time between two marks (CUDA events on the
    card; the host clock after a sync elsewhere)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if self.cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def seconds(self, a, b) -> float:
        if self.cuda:
            b.synchronize()
            return a.elapsed_time(b) * 1e-3
        return b - a


def build(cfg: dict, mix: dict, seed: int, device) -> SimpleNamespace:
    """The model's kernels, the traffic, then the program's set-up, which
    makes its weights from the seed itself (``model.setup``)."""
    model = load("models", cfg["model"])
    if torch.device(device).type == "cuda":
        model.build_kernels(cfg)
    traffic = load("generators", mix["generator"]).Traffic(cfg, mix, device)
    prog = model.setup(cfg, seed, traffic, device)
    return SimpleNamespace(cfg=cfg, mix=mix, seed=seed, device=device,
                           model=model, traffic=traffic, prog=prog)


def pool(st, n: int) -> list[dict]:
    """The mix's ``pool_batches`` batches of ``n`` samples, on the device."""
    return [st.traffic.batch(st.seed, i, n)
            for i in range(st.mix["pool_batches"])]


def free(st) -> None:
    """Drop the program (its weights and state) before the reference
    runs."""
    st.prog = None
    if torch.device(st.device).type == "cuda":
        torch.cuda.empty_cache()
