"""A plain reference of DLRM-DCNv2 in PyTorch, for the tests: MLPerf's
DLRM-DCNv2 as torchrec's ``DLRM_DCN`` computes it (``SparseArch`` sums each
field's multi-hot bag; ``DenseArch`` is an MLP with a ReLU after every
layer; ``InteractionDCNArch`` runs ``LowRankCrossNet`` over the
concatenation of the dense output and the field sums; ``OverArch`` is an
MLP whose last layer has no activation). DCN-v2 is arXiv:2008.13535.

Everything is fp32 with TF32 off. It imports nothing of ``repro_torch``
and no JAX. Departures from MLPerf, here as in the port's tests: the table
may be stored in bfloat16 (each row is cast to fp32 before it is summed),
the weights are seeded random ones, and the ids are synthetic.

Weights are a dict: ``table`` (V, D), the union vocabulary's rows, fields
in order; ``bot``, ``top``: ``{"w": [(in, out)], "b": [(out,)]}``;
``cross``: ``{"v": [(N, r)], "w": [(r, N)], "b": [(N,)]}``. ``sparse`` is
(B, sum(sizes)) int32, each sample's ids field by field, -1 for a hole.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def fp32_matmuls():
    """Both TF32 switches off inside, restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def field_sums(table: torch.Tensor, sparse: torch.Tensor, sizes,
               vocab_sizes) -> torch.Tensor:
    """(B, F, D) fp32: each field's rows gathered, cast to fp32, summed
    over the bag (a hole adds nothing)."""
    out, col, start = [], 0, 0
    for n, v in zip(sizes, vocab_sizes):
        ids = sparse[:, col:col + n].long()
        rows = table[torch.where(ids >= 0, ids + start, 0)].float()
        out.append(torch.where((ids >= 0)[..., None], rows, 0.0).sum(1))
        col, start = col + n, start + v
    return torch.stack(out, 1)


def mlp(p: dict, x: torch.Tensor, last_relu: bool) -> torch.Tensor:
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w.float() + b.float()
        if i < n - 1 or last_relu:
            x = torch.relu(x)
    return x


def cross(p: dict, x0: torch.Tensor, layers: int | None = None
          ) -> torch.Tensor:
    """``x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l`` for the first
    ``layers`` layers (None: all)."""
    x = x0
    for v, w, b in list(zip(p["v"], p["w"], p["b"]))[:layers]:
        x = x0 * ((x @ v.float()) @ w.float() + b.float()) + x
    return x


def forward(w: dict, dense: torch.Tensor, sparse: torch.Tensor, sizes,
            vocab_sizes, cross_layers: int | None = None) -> torch.Tensor:
    """The logits (B,). ``cross_layers`` runs only the first that many
    cross layers (a planted fault for the tests)."""
    with torch.no_grad(), fp32_matmuls():
        e = field_sums(w["table"], sparse, sizes, vocab_sizes)
        x = mlp(w["bot"], dense.float(), last_relu=True)
        x0 = torch.cat([x, e.reshape(e.shape[0], -1)], dim=1)
        return mlp(w["top"], cross(w["cross"], x0, cross_layers),
                   last_relu=False)[:, 0]
