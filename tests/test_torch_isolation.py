"""The port stands alone: no module of ``src/repro_torch/`` imports JAX or
the JAX package, and its entry points never fall back to the CPU on their
own."""
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_arch
from repro_torch.launch import serve as TSERVE

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.launch.serve" in mods and len(mods) >= 15
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_no_port_source_names_jax_or_repro():
    pat = re.compile(r"^\s*(import jax|from jax|from repro\.|from repro "
                     r"|import repro(\.|\s|$))", re.M)
    files = sorted(PORT.rglob("*.py"))
    assert files
    offenders = [str(f) for f in files if pat.search(f.read_text())]
    assert not offenders, offenders


def test_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_arch("updlrm-paper")
    with pytest.raises(RuntimeError, match="is_available"):
        TSERVE.run(spec, spec.reduced, requests=2, batch=2)
    with pytest.raises(RuntimeError, match="is_available"):
        TSERVE.main(["--arch", "updlrm-paper", "--requests", "2"])
    with pytest.raises(RuntimeError, match="is_available"):
        repro_torch.resolve_device(None)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")


def test_run_serves_reduced_requests_on_the_cpu():
    spec = get_arch("updlrm-paper")
    res = TSERVE.run(spec, spec.reduced, requests=5, batch=2, device="cpu")
    assert tuple(res.scores.shape) == (5,)
    assert res.scores.device.type == "cpu"
    assert ((res.scores > 0) & (res.scores < 1)).all()
    assert len(res.latencies) == 5
    assert res.last_batch["sparse"].shape == (2, 8, 16)
