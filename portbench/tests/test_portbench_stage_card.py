"""On the card: a traced run of every cell, in this process, as ``run.py``
makes it. Every stage span of the cell is a ``repro_torch.*`` range in
the profiler's exported trace, so on its clock; the stages' CUDA-event
times agree with the profiler's kernel times of the same run, and cover
the step (``-rP`` prints each cell's readings). Skips at run time
without a card."""
import gc
import os
from types import SimpleNamespace

import pytest

from portbench import program_spans
from portbench import run as RUN
from portbench import trace as TRACE
from portbench.tests.small import CELLS

SEED = 4294967357
FORWARD = ("dlrm.lookup", "dlrm.bot_mlp", "dlrm.interaction",
           "dlrm.top_mlp")
SPANS = {"paper-bulk": ("serve.step", *FORWARD),
         "rm2-bulk": ("serve.step", *FORWARD),
         "paper-train": ("train.step", "train.forward", "train.backward",
                         "train.clip", "train.optimizer",
                         "lookup.backward", *FORWARD)}
# the kernel each stage holds, as the trace names it: the stage's device
# time includes it
LOOKUP = {"paper-bulk": r"banked_bag_kernel", "rm2-bulk": r"gather|index"}
DOT = r"dot_interaction_kernel|dot_tiled_kernel"


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_stage_spans_on_the_card(card, cell, monkeypatch):
    import torch
    from repro_torch.obs import tracing
    got = {}
    summarize = TRACE.summarize

    def keep(trace):
        got["names"] = {e["name"] for e in trace.get("traceEvents", [])
                        if e.get("ph") == "X"}
        got["summary"] = summarize(trace)
        return got["summary"]
    monkeypatch.setattr(TRACE, "summarize", keep)
    gc.collect()
    torch.cuda.empty_cache()
    tracing.process_tracer().records.clear()
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    out, lines = RUN.run_cell(cell, SEED, 3.0, True)
    assert out["correct"], lines
    assert {tracing.PREFIX + n for n in SPANS[cell]} <= got["names"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    want = {w["name"] for w in RUN.cell_parts(cell).per_layer}
    assert want <= set(m), want - set(m)
    assert m["plan_s"] > 0
    s = got["summary"]
    if cell == "paper-train":
        steps = len(tracing.process_tracer().spans("train.step"))
        clip = program_spans.stage_ms(
            SimpleNamespace(run=SimpleNamespace(mode="train"),
                            cfg={"model": "dlrm"}), "train.clip", "train")
        cover = (m["fwd_ms.train"] + m["bwd_ms.train"]
                 + m["optim_ms.train"] + clip) / m["step_ms.train"]
        assert m["lookup_bwd_ms.train"] <= m["bwd_ms.train"]
        scatter = s.device_s(r"ct_scatter_(tiles|spans)") / steps * 1e3
        assert m["lookup_bwd_ms.train"] >= scatter > 0
    else:
        steps = len(tracing.process_tracer().spans("serve.step"))
        cover = (m["lookup_ms.bulk"] + m["bot_mlp_ms.bulk"]
                 + m["interact_ms.bulk"] + m["top_mlp_ms.bulk"]) \
            / m["step_ms.bulk"]
        look = s.device_s(LOOKUP[cell]) / steps * 1e3
        assert m["lookup_ms.bulk"] >= look > 0
        assert m["interact_ms.bulk"] >= s.device_s(DOT) / steps * 1e3 > 0
        assert m["bot_mlp_ms.bulk"] + m["top_mlp_ms.bulk"] \
            >= m["mlp_ms.bulk"]
    print(cell, "stage readings", m, "coverage", cover)
    assert 0.97 <= cover <= 1.01, cover
