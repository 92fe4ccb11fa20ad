"""The yardstick's frozen counts for the DLRM-DCNv2 cells, by the rule of
``counts/dlrm.py``: each input byte read once, each output byte written
once, an add per live entry and column, a repeated id one read of its row.
The model's FLOPs; the cross network's operations and bytes (the stage
``dlrm.cross``); the CSR bag kernel's (``csr_bag.cu``, its fp32-output
instance); the live entries and distinct rows of a batch.
"""
from __future__ import annotations

from portbench.counts.dlrm import bound_s  # noqa: F401  (the readers')


def n_fields(cfg: dict) -> int:
    return len(cfg["vocab_sizes"])


def cross_width(cfg: dict) -> int:
    """x0 = [x | e_0 ... e_{F-1}]: (F + 1) D."""
    return (n_fields(cfg) + 1) * cfg["embed_dim"]


def dense_params(cfg: dict) -> int:
    """Weights and biases of the bottom MLP, the cross layers (V, W, b)
    and the top MLP."""
    N, r = cross_width(cfg), cfg["cross_rank"]
    bot = [cfg["n_dense"], *cfg["bot_mlp"]]
    top = [N, *cfg["top_mlp"], 1]
    mlps = sum(a * b + b for dims in (bot, top)
               for a, b in zip(dims[:-1], dims[1:]))
    return mlps + cfg["cross_layers"] * (2 * N * r + N)


def model_flops(cfg: dict, batch: int, train: bool = False) -> float:
    """Textbook FLOPs of a step: 2 a dense parameter and sample forward, 6
    with the backward."""
    return (6.0 if train else 2.0) * dense_params(cfg) * batch


def cross_bytes_ops(cfg: dict, batch: int) -> tuple[int, int]:
    """The cross stage as one pass: x (B, D) and the field sums (B, F D)
    read, every layer's V, W and b read, the (B, N) output written, in
    fp32; a multiply and an add per product term of both matrix products,
    and per layer and value the bias add, the multiply by x0 and the add of
    x_l."""
    N, r, L = cross_width(cfg), cfg["cross_rank"], cfg["cross_layers"]
    nbytes = 4 * (batch * N + L * (2 * N * r + N) + batch * N)
    return nbytes, L * batch * (4 * N * r + 3 * N)


def csr_bytes_ops(cfg: dict, batch: int, *, n_valid: int, n_rows: int
                  ) -> tuple[int, int]:
    """The CSR bag kernel on a batch's (B, sum of sizes) ids, B F bags: the
    id stream, the B F + 1 offsets, each distinct row's slot (4 bytes) and
    its D values in ``emb_dtype``, the (B F, D) fp32 output; an add per
    live entry and column."""
    F, D = n_fields(cfg), cfg["embed_dim"]
    T, NB = batch * sum(cfg["multi_hot_sizes"]), batch * F
    item = 4 if cfg["emb_dtype"] == "float32" else 2
    nbytes = T * 4 + (NB + 1) * 4 + n_rows * (4 + D * item) + NB * D * 4
    return nbytes, n_valid * D


def batch_counts(cfg: dict, sparse) -> dict:
    """Live entries and distinct rows of the union vocabulary in a batch's
    (B, sum of sizes) per-field ids (-1 is a hole)."""
    import torch
    sizes = torch.tensor(cfg["multi_hot_sizes"], device=sparse.device)
    starts = torch.tensor([0, *cfg["vocab_sizes"][:-1]],
                          device=sparse.device).cumsum(0)
    offs = torch.repeat_interleave(starts, sizes)
    valid = sparse >= 0
    seen = torch.zeros(sum(cfg["vocab_sizes"]), dtype=torch.bool,
                       device=sparse.device)
    seen[(sparse.long() + offs)[valid]] = True
    return {"n_valid": int(valid.sum()), "n_rows": int(seen.sum())}
