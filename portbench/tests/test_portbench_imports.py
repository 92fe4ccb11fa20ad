"""What the benchmark loads: in a fresh process, after a whole small run
and every reader, no module whose top-level name is ``jax``, ``jaxlib``,
``flax`` or the JAX package ``repro`` (``repro_torch`` is not ``repro``),
and nothing of the old ``benchmarks/``. Without a card the entry point
exits non-zero and prints no result."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

PROBE = r"""
import json, sys
from pathlib import Path
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
from portbench import drive, run as RUN, control  # noqa: F401
from portbench.tests.small import CELLS, small_parts
for cell in CELLS:
    out, _ = RUN.run_cell(cell, 5, 0.2, False, device="cpu",
                          parts=small_parts(cell))
    assert out["correct"], out
for kind in ("metrics", "modes", "generators", "models", "reference"):
    for f in sorted((Path(sys.argv[1]) / "portbench" / kind).glob("*.py")):
        drive.load(kind, f.name[:-3])
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": RUN.forbidden_modules(), "tops": tops}))
"""


def test_no_jax_nor_the_jax_package_is_loaded():
    import json
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", PROBE, str(ROOT)], env=env,
                       capture_output=True, text=True, timeout=600,
                       cwd=ROOT)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro", "benchmarks"} & set(
        got["tops"])
    assert "repro_torch" in got["tops"]


@pytest.mark.parametrize("argv", [
    ["--workload", "paper-bulk", "--seed", "1", "--seconds", "1",
     "--trace", "0"],
    ["--workload", "paper-train", "--seed", "2", "--seconds", "1",
     "--trace", "1"]])
def test_without_a_card_no_result(argv):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    r = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"),
                        *argv], capture_output=True, text=True, timeout=300,
                       cwd=ROOT)
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_metric_files_match_the_benchmark():
    import json
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in b["per_layer"] + b["end_to_end"]}
    files = {f.name[:-3] for f in (ROOT / "portbench" / "metrics").glob(
        "*.py")}
    assert names == files
    for w in b["workloads"]:
        mix = json.loads((ROOT / "portbench" / "traffic" /
                          f"{w['traffic']}.json").read_text())
        for kind, name in (("modes", mix["mode"]),
                           ("generators", mix["generator"])):
            assert (ROOT / "portbench" / kind / f"{name}.py").exists()
        assert (ROOT / "portbench" / "limits" / f"{w['name']}.json").exists()


def test_only_the_model_adapters_import_the_port():
    """The port is imported by ``portbench/models/`` alone; the harness's
    drive, run, modes and metrics reach a model and its reference only by
    the names a configuration gives (the DLRM kernels' rooflines keep the
    DLRM counts)."""
    import re
    port = re.compile(r"^\s*(from|import)\s+repro_torch\b", re.M)
    named = re.compile(r"^\s*from\s+portbench(\.reference|\.models|\.counts"
                       r"\.dlrm|\.counts import dlrm|\s+import\s+.*\b(sut|"
                       r"reference|models)\b)", re.M)
    bench = ROOT / "portbench"
    for f in bench.rglob("*.py"):
        rel = f.relative_to(bench).parts
        if rel[0] in ("models", "tests"):
            continue
        assert not port.search(f.read_text()), f
    harness = [bench / "drive.py", bench / "run.py",
               *(bench / "modes").glob("*.py"),
               *(bench / "metrics").glob("*.py")]
    rooflines = {"bag_roofline.bulk.py", "dot_roofline.bulk.py",
                 "scatter_roofline.train.py"}
    for f in harness:
        text = f.read_text()
        if f.name in rooflines:
            text = text.replace("from portbench.counts import dlrm as C", "")
        assert not named.search(text), f
