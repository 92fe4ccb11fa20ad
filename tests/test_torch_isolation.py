"""The port stands alone: no module of ``src/repro_torch/`` imports JAX,
the JAX package or ``ml_dtypes`` (a CUDA host need not have any of them),
and its entry points never fall back to the CPU on their own."""
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
from repro_torch.launch import train as TTRAIN

SRC = Path(__file__).resolve().parent.parent / "src"
PORT = SRC / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(PORT)], prefix="repro_torch."))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.launch.serve" in mods and len(mods) >= 15
    assert {"repro_torch.workload.trace", "repro_torch.core.grace",
            "repro_torch.core.cache_runtime", "repro_torch.quant.tiered",
            "repro_torch.workload.runtime",
            "repro_torch.obs.traffic", "repro_torch.sparse.ops",
            "repro_torch.kernels.ops",
            "repro_torch.kernels.cache_bag"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(n for n in sys.modules if n.split('.')[0] in "
        "('jax', 'repro', 'ml_dtypes'))\n"
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
        TSERVE.run_cached(spec, spec.reduced, requests=2, batch=2)
    with pytest.raises(RuntimeError, match="is_available"):
        TTRAIN.run(spec, spec.reduced, steps=1, batch=2)
    with pytest.raises(RuntimeError, match="is_available"):
        TTRAIN.main(["--arch", "updlrm-paper", "--steps", "1"])
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


def test_run_cached_serves_reduced_requests_on_the_cpu():
    spec = get_arch("updlrm-paper")
    res = TSERVE.run_cached(spec, spec.reduced, requests=5, batch=2,
                            device="cpu", profile_requests=8)
    assert tuple(res.scores.shape) == (5,)
    assert res.scores.device.type == "cpu"
    assert ((res.scores > 0) & (res.scores < 1)).all()
    assert len(res.latencies) == 5 and len(res.host_ms["rewrite"]) == 3
    assert res.last_batch["cache_idx"].shape == (2, 8, 4)
    assert res.last_batch["residual_idx"].shape == (2, 8, 16)
    assert res.cache_table.packed.shape == (128, 8)
    assert 0 <= res.stats["hit_rate"] <= 1


def test_adaptive_flag_names_what_is_missing():
    base = ["--arch", "updlrm-paper", "--adaptive", "--device", "cpu"]
    TSERVE.main(base + ["--partition", "cache_aware", "--requests", "16",
                        "--batch", "8"])
    # the replica lane is ported; the reference's guards on it refuse
    rep = base + ["--replicate-k-max", "2"]
    for extra, what in ((["--quant", "int8"], "full-precision"),
                        (["--partition", "cache_aware"], "non_uniform"),
                        (["--inject-bank-failure", "2:1"],
                         "inject-bank-failure")):
        with pytest.raises(SystemExit, match=what):
            TSERVE.main(rep + extra)
    # the fault lane and the SLO watchdog are ported; the reference's
    # guards on the fault lane refuse as there
    fault = base + ["--inject-bank-failure", "2:1"]
    for extra, what in ((["--partition", "cache_aware"], "non_uniform"),
                        (["--quant", "int8"], "full-precision")):
        with pytest.raises(SystemExit, match=what):
            TSERVE.main(fault + extra)
    TSERVE.main(fault + ["--requests", "32", "--batch", "8",
                         "--min-recoveries", "1"])
    TSERVE.main(base + ["--slo-p99-us", "500", "--slo-max-share", "0.2",
                        "--requests", "16", "--batch", "8"])


def test_run_adaptive_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_arch("updlrm-paper")
    with pytest.raises(RuntimeError, match="is_available"):
        TSERVE.run_adaptive(spec, spec.reduced, requests=2, batch=2,
                            quant="int4")
    with pytest.raises(RuntimeError, match="is_available"):
        TSERVE.main(["--arch", "updlrm-paper", "--adaptive", "--quant",
                     "int8", "--requests", "2"])


def test_main_adaptive_int8_serves_on_the_cpu(capsys):
    TSERVE.main(["--arch", "updlrm-paper", "--adaptive", "--quant", "int8",
                 "--device", "cpu", "--requests", "48", "--batch", "8",
                 "--replan-every", "2", "--min-swaps", "1"])
    out = capsys.readouterr().out
    assert "[swap @batch" in out and "tiers v1" in out
    assert "served 48 requests" in out
    assert "shapes stable: True" in out and "re-tier parity: True" in out


def test_main_adaptive_replicated_serves_on_the_cpu(capsys):
    TSERVE.main(["--arch", "updlrm-paper", "--adaptive", "--replicate-k-max",
                 "4", "--device", "cpu", "--requests", "48", "--batch", "8",
                 "--replan-every", "2", "--min-swaps", "1"])
    out = capsys.readouterr().out
    assert "[swap @batch" in out and "replicas v1 hot=8" in out
    assert "served 48 requests" in out
    assert "shapes stable: True" in out and "re-pack parity: True" in out


def test_run_replicated_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = get_arch("updlrm-paper")
    with pytest.raises(RuntimeError, match="is_available"):
        TSERVE.run_replicated(spec, spec.reduced, requests=2, batch=2,
                              k_max=4)
    with pytest.raises(ValueError, match="k_max 1"):
        TSERVE.run_replicated(spec, spec.reduced, requests=2, batch=2,
                              k_max=1, device="cpu")


def test_run_trains_reduced_steps_on_the_cpu():
    spec = get_arch("updlrm-paper")
    res = TTRAIN.run(spec, spec.reduced, steps=3, batch=4, device="cpu")
    assert len(res.losses) == 3 and all(0 < x < 10 for x in res.losses)
    assert res.state.params["emb_packed"].device.type == "cpu"
    assert int(res.state.step) == 3
    assert res.last_batch["sparse"].shape == (4, 8, 16)


def test_both_forward_kernels_carry_a_grad_fn():
    """On the CPU path the wrappers of both forward kernels sit inside
    autograd Functions: their outputs carry a ``grad_fn`` when an input
    requires a gradient, so a loss reaches the table and the bottom MLP."""
    from repro_torch.core.embedding import banked_embedding_bag
    from repro_torch.models import dlrm
    spec = get_arch("updlrm-paper")
    cfg = spec.reduced
    params, statics = dlrm.init_params(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
    packed = params["emb_packed"].requires_grad_(True)
    idx = torch.randint(0, 500, (2, cfg.n_sparse, cfg.multi_hot),
                        dtype=torch.int32)
    emb = banked_embedding_bag(dlrm._banked(params, statics), idx,
                               field_offsets=statics["field_offsets"])
    assert emb.grad_fn is not None
    z = torch.randn((2, 9, 8), requires_grad=True)
    assert dlrm.dot_interaction(z).grad_fn is not None
    with torch.no_grad():
        assert dlrm.dot_interaction(z).grad_fn is None
    (g,) = torch.autograd.grad(emb.sum(), [packed])
    assert int((g != 0).any(dim=1).sum()) > 0


def test_cached_lookup_carries_a_grad_fn():
    """The fused cache+residual lookup sits inside ``_CacheResidualBag``:
    its output carries a ``grad_fn`` and both tables get a gradient."""
    from repro_torch.core.embedding import (BankedTable,
                                            banked_cache_residual_bag)
    g = torch.Generator().manual_seed(1)
    emt = torch.randn((40, 8), generator=g).requires_grad_(True)
    cache = torch.randn((16, 8), generator=g).requires_grad_(True)
    ones = torch.zeros(40, dtype=torch.int32)
    t = BankedTable(emt, ones, torch.arange(40, dtype=torch.int32), 1, 40)
    c = BankedTable(cache, torch.zeros(16, dtype=torch.int32),
                    torch.arange(16, dtype=torch.int32), 1, 16)
    ci = torch.randint(-1, 16, (6, 3), generator=g, dtype=torch.int32)
    ri = torch.randint(-1, 40, (6, 5), generator=g, dtype=torch.int32)
    out = banked_cache_residual_bag(t, c, ci, ri)
    assert out.grad_fn is not None
    assert type(out.grad_fn.next_functions[0][0]).__name__ == \
        "_CacheResidualBagBackward"
    de, dc = torch.autograd.grad(out.sum(), [emt, cache])
    assert de.abs().sum() > 0 and dc.abs().sum() > 0
