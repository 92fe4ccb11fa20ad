"""The ``dlrm`` adapter's weights and FLOPs are the ones the accepted cells
were measured and their limits set with: at small sizes on the CPU,
``make_weights`` of each configuration gives the bits of the function it
replaced (kept here), and the program's packed table holds them; at full
size, ``model_flops`` gives the counts the cells' ``mfu`` readings were
taken with."""
import math

import pytest
import torch

from portbench import drive
from portbench.generate import generator
from portbench.run import cell_parts
from portbench.tests.small import CELLS, small_parts

SEED = 2_147_483_659


def _weights_before(cfg: dict, seed: int, device) -> dict:
    """``generate.make_weights`` as it was before the model adapters."""
    g = generator(seed, 1, device)
    emb_dtype = getattr(torch, cfg["emb_dtype"])
    dtype = getattr(torch, cfg["dtype"])
    V, D = sum(cfg["vocab_sizes"]), cfg["embed_dim"]
    table = (torch.randn((V, D), generator=g, device=device) * 0.02
             ).to(emb_dtype)
    F = len(cfg["vocab_sizes"])

    def mlp(dims):
        ws, bs = [], []
        for a, b in zip(dims[:-1], dims[1:]):
            w = torch.empty((a, b), device=device)
            torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
            ws.append((w / math.sqrt(a)).to(dtype))
            bs.append((torch.randn((b,), generator=g, device=device) * 0.05
                       ).to(dtype))
        return {"w": ws, "b": bs}

    bot = mlp([cfg["n_dense"], *cfg["bot_mlp"]])
    top = mlp([(F + 1) * F // 2 + D, *cfg["top_mlp"], 1])
    return {"table": table, "bot": bot, "top": top}


def _leaves(w: dict) -> dict:
    return {"table": w["table"],
            **{f"{m}.{k}{i}": t for m in ("bot", "top") for k in ("b", "w")
               for i, t in enumerate(w[m][k])}}


@pytest.mark.parametrize("cell", CELLS)
def test_weights_keep_their_bits(cell):
    p = small_parts(cell)
    model = drive.load("models", p.cfg["model"])
    ref = drive.load("reference", p.cfg["reference"])
    want = _leaves(_weights_before(p.cfg, SEED, "cpu"))
    for got in (model.make_weights(p.cfg, SEED, "cpu"),
                ref.make_weights(p.cfg, SEED, "cpu")):
        got = _leaves(got)
        assert got.keys() == want.keys()
        for n, t in want.items():
            assert got[n].dtype == t.dtype and torch.equal(got[n], t), n
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    packed = model.param_leaves(st.prog.params)
    remap = st.prog.statics["remap_flat"].long()
    assert torch.equal(packed["table"][remap], want["table"])
    for n, t in want.items():
        if n != "table":
            assert torch.equal(packed[n], t), n


# a step's FLOPs at the cells' full sizes, as the accepted cells' mfu
# readings were taken: (serving, training)
FLOPS = {"paper-bulk": (164434018304.0, 493302054912.0),
         "rm2-bulk": (399600254976.0, 1198800764928.0),
         "paper-train": (41108504576.0, 123325513728.0)}


@pytest.mark.parametrize("cell", CELLS)
def test_model_flops_are_pinned(cell):
    p = cell_parts(cell)
    model = drive.load("models", p.cfg["model"])
    B = p.mix["batch"]
    assert (model.model_flops(p.cfg, B),
            model.model_flops(p.cfg, B, train=True)) == FLOPS[cell]
