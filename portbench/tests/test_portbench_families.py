"""A model family enters the benchmark by new files alone. The toy family
``toy_linear`` (``portbench/tests/toy/``: an adapter, a reference, a
configuration, a mix and limits) is laid over a copy of ``portbench/``
with its own ``BENCHMARK.json``; the harness's ``drive.py``, ``run.py``,
modes and metrics, as they are, find it by name and run it, correct; the
toy program scoring with a wrong weight fails its limit."""
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import drive
from portbench import run as RUN
from portbench.counts import PEAKS

ROOT = Path(__file__).resolve().parents[2]
TOY = Path(__file__).resolve().parent / "toy"
SEED = 3_000_000_019
CELL = "toy-bulk"


@pytest.fixture
def toy_tree(monkeypatch, tmp_path):
    """A checkout whose ``portbench/`` is this one's with the toy family's
    files added, and whose ``BENCHMARK.json`` holds the toy cell alone;
    the harness pointed at it."""
    bench = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    added = []
    for f in sorted(TOY.rglob("*.*")):
        dest = bench / f.relative_to(TOY)
        assert not dest.exists(), f"{dest} would be edited, not added"
        shutil.copy(f, dest)
        added.append(dest)
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    metric = {m["name"]: m for m in b["end_to_end"] + b["per_layer"]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        **b,
        "configs": [{"name": "toy-linear", "source": "a test's family",
                     "file": "portbench/configs/toy-linear.json",
                     "reduced": [], "why": "a model brought by files"}],
        "workloads": [{"name": CELL, "config": "toy-linear",
                       "traffic": CELL, "chips": 1, "why": "bulk scoring"}],
        "end_to_end": [dict(metric["score_rate"], workloads=[CELL]),
                       metric["setup_s"]],
        "per_layer": [dict(metric["mfu.bulk"], workloads=[CELL])]}))
    monkeypatch.setattr(RUN, "ROOT", tmp_path)
    monkeypatch.setattr(RUN, "HERE", bench)
    monkeypatch.setattr(drive, "HERE", bench)
    monkeypatch.setattr(drive, "_LOADED", {})
    return added


def test_a_family_brought_by_files_runs_correct(toy_tree):
    assert {p.parent.name for p in toy_tree} == {
        "models", "reference", "configs", "traffic", "limits"}
    out, lines = RUN.run_cell(CELL, SEED, 0.3, False, device="cpu")
    assert out["correct"], lines
    assert out["checks"]["score_gap"]["value"] <= 1e-6
    assert set(out["metrics"]) == {"score_rate", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0


def test_mfu_reads_the_named_model_s_flops(toy_tree):
    p = RUN.cell_parts(CELL)
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    run = drive.load("modes", "bulk").run(st, 0.2, False, lambda: None)
    got = drive.load("metrics", "mfu.bulk").read(
        SimpleNamespace(cfg=p.cfg, run=run))
    flops = 2.0 * (3 + 4 + 1) * 64 * run.steps
    assert got == pytest.approx(100.0 * flops / run.device_s
                                / PEAKS["fp32_flops"], rel=1e-12)


def test_the_set_up_makes_the_reference_s_table(toy_tree):
    p = RUN.cell_parts(CELL)
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    w = drive.load("reference", "toy_linear").make_weights(p.cfg, SEED, "cpu")
    assert st.prog.params["table"].dtype == torch.bfloat16
    assert torch.equal(st.prog.params["table"], w["table"])
    assert w["table"].shape[0] > p.cfg["chunk_rows"]


def test_a_wrong_weight_is_not_correct(toy_tree, monkeypatch):
    build = drive.build

    def broken_build(*a, **k):
        st = build(*a, **k)
        st.prog.params["v"] = st.prog.params["v"].clone()
        st.prog.params["v"][0] += 0.25
        return st
    monkeypatch.setattr(drive, "build", broken_build)
    out, lines = RUN.run_cell(CELL, SEED, 0.3, False, device="cpu")
    assert not out["correct"], lines
    assert out["checks"]["score_gap"]["value"] > 1e-3


def test_the_table_probe_packs_in_place():
    """``tools/table_probe.py``'s set-up at a small size: every chunk's
    rows in their slots and the banks' padding zero."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "table_probe", ROOT / "portbench" / "tools" / "table_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    cfg = dict(probe.DCNV2, vocab_sizes=[30, 7, 12], embed_dim=4)
    got = probe.setup(cfg, SEED, None, "cpu", chunk_rows=8)
    packed, V = got["packed"], 49
    assert packed.shape == (8 * 7, 4) and packed.dtype == torch.bfloat16
    for k, start in enumerate(range(0, V, 8)):
        rows = min(8, V - start)
        assert torch.equal(packed[start:start + rows],
                           probe.chunk(cfg, SEED, k, rows, "cpu"))
    assert not packed[V:].any()
