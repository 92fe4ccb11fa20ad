"""The seeds' streams, and the weights that the program and the reference
share, made from ``--seed`` with a ``torch.Generator`` on the device, in a
few large calls. Traffic comes from the generator that a mix names
(``portbench/generators/<generator>.py``).
"""
from __future__ import annotations

import math

import torch

_WEIGHTS = 1


def sub_seed(seed: int, tag: int, index: int = 0) -> int:
    return (int(seed) * 1_000_003 + tag * 7919 + index) % (1 << 62)


def generator(seed: int, tag: int, device, index: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, tag, index))
    return g


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The model's weights from the seed, in the types they are served in:
    the logical table (sum of the vocabularies, D) N(0, 0.02^2) in
    ``emb_dtype``; each MLP's (in, out) weights a standard normal cut at
    +-2 times 1/sqrt(in), its biases N(0, 0.05^2), in ``dtype``. The same
    seed gives the same bits on the same device."""
    g = generator(seed, _WEIGHTS, device)
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
