"""The ``toy_linear`` model adapter, a family that exists only for the
harness's tests: a logistic scorer, the sum of one weight a field's row
and a linear term of the dense features, in plain PyTorch. Its set-up
takes the seed and makes the table itself, a chunk at a time in its
stored type, straight into the table it serves from."""
from __future__ import annotations

import torch

from portbench import drive


def build_kernels(cfg: dict) -> None:
    """No kernels of its own."""


def model_flops(cfg: dict, batch: int, train: bool = False) -> float:
    return (6.0 if train else 2.0) * (len(cfg["vocab_sizes"])
                                      + cfg["n_dense"] + 1) * batch


def setup(cfg: dict, seed: int, traffic, device) -> "Program":
    R = drive.load("reference", cfg["reference"])
    table = torch.empty((sum(cfg["vocab_sizes"]), 1),
                        dtype=getattr(torch, cfg["emb_dtype"]), device=device)
    for start, chunk in R.table_chunks(cfg, seed, device):
        table[start:start + chunk.shape[0]] = chunk
    return Program(cfg, {"table": table, **R.dense_weights(cfg, seed,
                                                           device)}, device)


class Program:
    def __init__(self, cfg: dict, params: dict, device):
        self.params = params
        self.offsets = torch.tensor([0, *cfg["vocab_sizes"][:-1]],
                                    device=device).cumsum(0)

    def serve(self, params: dict, batch: dict) -> torch.Tensor:
        rows = batch["sparse"].long() + self.offsets
        x = (params["table"][rows, 0].float().sum(1)
             + batch["dense"] @ params["v"] + params["b"])
        return torch.sigmoid(x)
