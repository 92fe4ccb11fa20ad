"""The port's last modules against the reference's:
  * ``core.expert_placement`` equals ``repro.core.expert_placement`` array
    for array (n_banks dividing E or not) and keeps the reference's own
    balance bound (``tests/test_partitioning.py::TestExpertPlacement``);
  * ``configs.list_archs`` equals the reference's in both modes;
  * ``launch.serve.CompileProbe``: every adaptive lane on the CPU prints a
    "compile probe:" line with 0 kernel builds or loads (CPU tensors take
    the plain versions), a build and a load through ``kernels/_build.py``
    (a stand-in nvcc, a stand-in library) each count once, and a load
    after warm-up breaks a lane's swap contract;
  * ``examples/torch_partition_explorer.py`` imports nothing of ``repro``,
    ``jax`` or ``benchmarks``, and its statistics, shares and modeled
    stage times for one workload equal ``benchmarks/common.py``'s and the
    reference's ``embedding_stage_latency``.
"""
from __future__ import annotations

import importlib.util
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

import repro_torch.configs as TC
import repro_torch.core as TCORE
from repro.configs import list_archs as jax_list_archs
from repro.core import expert_placement as jax_expert_placement
from repro.core.hwmodel import embedding_stage_latency as jax_stage_latency
from repro.core.hwmodel import updlrm_layout as jax_layout
from repro_torch.configs import get_arch
from repro_torch.kernels import _build
from repro_torch.launch import serve as TSERVE
from repro_torch.obs.metrics import MetricRegistry
from repro_torch.workload.runtime import AdaptiveEmbeddingRuntime

ROOT = Path(__file__).resolve().parent.parent
EXPLORER = ROOT / "examples" / "torch_partition_explorer.py"


# ---------------------------------------------------------------------------
# expert_placement, list_archs
# ---------------------------------------------------------------------------

PLACEMENTS = [  # (experts, banks, load seed); None: the reference test's
    (32, 8, None), (32, 8, 0), (30, 8, 1), (7, 3, 2), (128, 16, 3),
    (33, 4, 4), (5, 5, 5), (40, 6, 6)]


def _load(n_exp, seed):
    if seed is None:     # tests/test_partitioning.py's zipf_freq(n_exp)
        p = np.arange(1, n_exp + 1, dtype=np.float64) ** -1.1
        return np.random.default_rng(0).permutation(p * 1000)
    rng = np.random.default_rng(seed)
    return rng.zipf(1.3, n_exp).astype(np.float64) + rng.random(n_exp)


@pytest.mark.parametrize("n_exp,banks,seed", PLACEMENTS)
def test_expert_placement_matches_reference(n_exp, banks, seed):
    load = _load(n_exp, seed)
    got = TCORE.expert_placement(load, banks)
    want = jax_expert_placement(load, banks)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    counts = np.bincount(got, minlength=banks)
    assert counts.max() == -(-n_exp // banks)
    per_bank = np.bincount(got, weights=load, minlength=banks)
    assert per_bank.max() <= per_bank.mean() + load.max() + 1e-9


def test_list_archs_matches_reference_and_is_exported():
    assert "list_archs" in TC.__all__ and "expert_placement" in dir(TCORE)
    assert TC.list_archs() == jax_list_archs()
    assert TC.list_archs(assigned_only=False) == jax_list_archs(False)
    assert "updlrm-paper" not in TC.list_archs()
    assert TC.list_archs(False) == list(TC.ARCHS)


# ---------------------------------------------------------------------------
# CompileProbe
# ---------------------------------------------------------------------------

LANE_KW = dict(requests=48, batch=8, replan_every=2, device="cpu")


def _lane(name, reg, **kw):
    spec = get_arch("updlrm-paper")
    if name == "int4":
        return TSERVE.run_adaptive(spec, spec.reduced, quant="int4",
                                   min_swaps=1, metrics=reg, **LANE_KW, **kw)
    if name == "cached":
        return TSERVE.run_cached_adaptive(spec, spec.reduced, min_swaps=1,
                                          metrics=reg, **LANE_KW, **kw)
    if name == "replicated":
        return TSERVE.run_replicated(spec, spec.reduced, k_max=4,
                                     min_swaps=1, metrics=reg, **LANE_KW,
                                     **kw)
    return TSERVE.run_fault(spec, spec.reduced, faults=["2:3"],
                            min_recoveries=1, metrics=reg, **LANE_KW, **kw)


@pytest.mark.parametrize("lane", ["int4", "cached", "replicated", "fault"])
def test_adaptive_lanes_print_a_zero_compile_probe_on_the_cpu(lane, capsys):
    reg = MetricRegistry()
    res = _lane(lane, reg)
    assert res.stats["swaps"] >= 1
    assert res.stats["kernel_builds_and_loads"] == 0
    assert res.stats["kernel_builds_after_warm"] == 0
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("compile probe:")]
    assert len(lines) == 1
    assert lines[0].startswith("compile probe: 0 kernel build(s) or load(s) "
                               "after warm-up across ")
    assert "ZERO rebuilds" in lines[0] and "CPU tensors" in lines[0]
    # the fault lane keeps the reference's metric schema: its probe counts
    # into a registry of its own
    names = set(reg.names())
    if lane == "fault":
        assert "kernels.builds_and_loads_total" not in names
    else:
        assert reg.get("kernels.builds_and_loads_total").value == 0


@pytest.fixture
def stand_in_toolchain(tmp_path, monkeypatch):
    """``kernels/_build.py`` on a stand-in source, nvcc and library: the
    "nvcc" writes its ``-o`` file, the "library" has one entry."""
    csrc, out = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    (csrc / "probe_kernel.cu").write_text("// a stand-in source\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo stand-in > "$2"\n')
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_functions", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: types.
                        SimpleNamespace(probe_entry=types.SimpleNamespace()))


def test_compile_probe_counts_builds_and_loads(stand_in_toolchain, capsys):
    import torch
    reg = MetricRegistry()
    with TSERVE.CompileProbe(reg) as probe:
        probe.mark_warm()
        assert _build.build(("probe_kernel",)) == {"probe_kernel": ""}
        assert _build.build(("probe_kernel",)) == {}    # built: no 2nd nvcc
        _build.function("probe_kernel", "probe_entry", [])
        _build.function("probe_kernel", "probe_entry", [])  # loaded once
    _build._notify("load", "probe_kernel")          # closed: not counted
    stats = {}
    assert not probe.report(stats, 1, "swap", torch.device("cuda"))
    assert stats == {"kernel_builds_and_loads": 2,
                     "kernel_builds_after_warm": 2}
    assert reg.get("kernels.builds_and_loads_total").value == 2
    assert "compile probe: 2 kernel build(s) or load(s) after warm-up " \
           "across 1 swap(s) — REBUILT (2 in all)" in capsys.readouterr().out
    assert _build._listeners == []


def test_a_load_after_warm_up_breaks_the_swap_contract(monkeypatch):
    end_batch = AdaptiveEmbeddingRuntime.end_batch

    def loading_end_batch(self):
        event = end_batch(self)
        if event is not None:
            _build._notify("load", "tiered_bag")
        return event

    monkeypatch.setattr(AdaptiveEmbeddingRuntime, "end_batch",
                        loading_end_batch)
    with pytest.raises(SystemExit, match="kernel builds after warm-up=1"):
        _lane("int4", MetricRegistry())


# ---------------------------------------------------------------------------
# the partition explorer
# ---------------------------------------------------------------------------

def _explorer():
    spec = importlib.util.spec_from_file_location("torch_partition_explorer",
                                                  EXPLORER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_explorer_imports_only_the_port():
    code = ("import importlib.util, sys\n"
            f"path = {str(EXPLORER)!r}\n"
            "s = importlib.util.spec_from_file_location('x', path)\n"
            "s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
            "('jax', 'repro', 'benchmarks', 'ml_dtypes'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert r.returncode == 0, r.stdout + r.stderr


def test_explorer_rows_match_the_reference():
    """The ``home`` workload: the trace statistics equal
    ``benchmarks.common.workload_stats``', every partitioner's shares at
    each N_c's bin count equal ``plan_shares``', and the modeled stage
    times equal the reference's ``embedding_stage_latency`` on them."""
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import common as BC
    finally:
        sys.path.pop(0)
    X = _explorer()
    assert (X.BENCH_ITEMS, X.BENCH_SAMPLES) == (BC.BENCH_ITEMS,
                                                BC.BENCH_SAMPLES)
    got, want = X.workload_stats("home"), BC.workload_stats("home")
    np.testing.assert_array_equal(got["freq"], want["freq"])
    assert got["hit_rate"] == want["hit_rate"]
    for a, b in zip(got["trace"], want["trace"]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["cache_plan"].benefits,
                                  want["cache_plan"].benefits)
    p = want["profile"]
    for name in X.PARTITIONERS:
        ref_us = []
        for n_c in X.N_CS:
            rg, _ = jax_layout(X.BANKS_PER_TABLE, X.C, n_c)
            s_got, _ = X.plan_shares(got, name, rg)
            s_want, _ = BC.plan_shares(want, name, rg)
            np.testing.assert_array_equal(s_got, s_want)
            ref_us.append(jax_stage_latency(
                batch_size=X.BATCH, avg_reduction=p.avg_reduction, n_c=n_c,
                per_bank_lookup_share=s_want,
                cache_hit_rate=want["hit_rate"] if name == "CA" else 0.0,
            ).total * 1e6)
        np.testing.assert_allclose(X.stage_us(got, name), ref_us,
                                   rtol=1e-12)
