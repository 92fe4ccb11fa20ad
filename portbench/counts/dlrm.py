"""The yardstick's frozen counts for the DLRM cells: the model's FLOPs and
each hand-written kernel's bytes and operations, from the shapes and from
counts of the inputs (live entries, distinct rows), and the H100's
published peaks (``peaks.json``, with its source).

The kernel counts follow one rule: each input byte read once, each output
byte written once, an add per live entry and column. A repeated id is one
read of its row, however many entries name it.
"""
from __future__ import annotations

from portbench.counts import PEAKS


def n_fields(cfg: dict) -> int:
    return len(cfg["vocab_sizes"])


def dense_params(cfg: dict) -> int:
    """Weights and biases of both MLPs."""
    F, D = n_fields(cfg), cfg["embed_dim"]
    bot = [cfg["n_dense"], *cfg["bot_mlp"]]
    top = [(F + 1) * F // 2 + D, *cfg["top_mlp"], 1]
    return sum(a * b + b for dims in (bot, top)
               for a, b in zip(dims[:-1], dims[1:]))


def model_flops(cfg: dict, batch: int, train: bool = False) -> float:
    """Textbook FLOPs of a step: 2 a dense parameter and sample forward, 6
    with the backward."""
    return (6.0 if train else 2.0) * dense_params(cfg) * batch


def bag_bytes_ops(cfg: dict, batch: int, *, n_valid: int, n_rows: int
                  ) -> tuple[int, int]:
    """The bag kernel on a (B, F, L) batch: the ids, the field offsets,
    each distinct row's remap entry (4 bytes) and its D values, the (B, F,
    D) output; an add per live entry and column."""
    F, L, D = n_fields(cfg), cfg["multi_hot"], cfg["embed_dim"]
    item = 4 if cfg["emb_dtype"] == "float32" else 2
    nb = batch * F
    nbytes = (nb * L * 4 + F * 4 + n_rows * 4 + n_rows * D * item
              + nb * D * item)
    return nbytes, n_valid * D


def dot_bytes_ops(cfg: dict, batch: int) -> tuple[int, int]:
    """The interaction's fused entry: x and emb ((B, F + 1, D) in all)
    read, the (B, P + D) features written; a multiply and an add per pair
    and column."""
    F, D = n_fields(cfg) + 1, cfg["embed_dim"]
    p = F * (F - 1) // 2
    return (batch * F * D + batch * (p + D)) * 4, 2 * batch * p * D


def scatter_bytes_ops(cfg: dict, batch: int, *, n_valid: int, n_rows: int
                      ) -> tuple[int, int]:
    """The backward scatter on its runs (one run a distinct row): each live
    entry's bag id, each run's start (and the end) and its row, the run
    count, the (B, F, D) cotangent read, each run's row written once; an
    add per live entry and column."""
    F, D = n_fields(cfg), cfg["embed_dim"]
    nbytes = (n_valid * 4 + (n_rows + 1) * 4 + n_rows * 4 + 4
              + batch * F * D * 4 + n_rows * D * 4)
    return nbytes, n_valid * D


def bound_s(nbytes: float, ops: float) -> float:
    """The least time on the card: the larger of the fp32 operations over
    the fp32 peak and the bytes over the HBM bandwidth."""
    return max(ops / PEAKS["fp32_flops"], nbytes / PEAKS["hbm_bytes_per_s"])


def batch_counts(cfg: dict, sparse) -> dict:
    """Live entries and distinct rows of the union vocabulary in a batch's
    (B, F) or (B, F, L) ids (-1 is padding)."""
    import torch
    sp = sparse if sparse.dim() == 3 else sparse[..., None]
    offs = torch.tensor([0, *cfg["vocab_sizes"][:-1]], device=sp.device
                        ).cumsum(0)
    valid = sp >= 0
    seen = torch.zeros(sum(cfg["vocab_sizes"]), dtype=torch.bool,
                       device=sp.device)
    for f in range(sp.shape[1]):
        ids = sp[:, f][valid[:, f]].long() + offs[f]
        seen[ids] = True
    return {"n_valid": int(valid.sum()), "n_rows": int(seen.sum())}
