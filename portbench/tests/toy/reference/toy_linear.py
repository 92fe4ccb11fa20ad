"""The plain reference of the ``toy_linear`` family: the logit is the sum,
field by field, of each id's weight, then the dense features' weights one
by one, then the bias. Its table is drawn a chunk of ``chunk_rows`` rows at
a time, each chunk from a generator of its own, so that a program can hold
one chunk at a time and make the same bits."""
from __future__ import annotations

import torch

from portbench.generate import WEIGHTS, generator


def table_chunks(cfg: dict, seed: int, device):
    """(first row, rows N(0, 0.5^2) in ``emb_dtype``), a chunk at a time."""
    V, n = sum(cfg["vocab_sizes"]), cfg["chunk_rows"]
    dtype = getattr(torch, cfg["emb_dtype"])
    for k, start in enumerate(range(0, V, n)):
        g = generator(seed, WEIGHTS, device, index=1 + k)
        rows = min(n, V - start)
        yield start, (torch.randn((rows, 1), generator=g, device=device)
                      * 0.5).to(dtype)


def dense_weights(cfg: dict, seed: int, device) -> dict:
    g = generator(seed, WEIGHTS, device)
    return {"v": torch.randn((cfg["n_dense"],), generator=g, device=device),
            "b": torch.randn((), generator=g, device=device)}


def make_weights(cfg: dict, seed: int, device) -> dict:
    table = torch.cat([c for _, c in table_chunks(cfg, seed, device)])
    return {"table": table, **dense_weights(cfg, seed, device)}


def scores(cfg: dict, w: dict, batch: dict, precision: str = "fp32"
           ) -> torch.Tensor:
    if precision != "fp32":
        raise ValueError(f"the toy family has no {precision} control")
    sparse, dense = batch["sparse"].long(), batch["dense"]
    x = torch.zeros(dense.shape[0], device=dense.device)
    start = 0
    for f, v in enumerate(cfg["vocab_sizes"]):
        x += w["table"][start + sparse[:, f], 0].float()
        start += v
    for j in range(dense.shape[1]):
        x += dense[:, j] * w["v"][j]
    return torch.sigmoid(x + w["b"])
