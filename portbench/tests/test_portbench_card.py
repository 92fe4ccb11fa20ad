"""On the card: one short run of every cell through the entry point, as
the benchmark's check runs it, correct and with the result's keys. Skips
at run time without a card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench.tests.small import CELLS

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(card, cell, trace):
    r = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         cell, "--seed", "4294967311", "--seconds", "3", "--trace",
         str(trace)], capture_output=True, text=True, timeout=360, cwd=ROOT)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    if trace:
        assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
    assert list(out)[-1] == "checks"
