"""The plain reference DLRM-DCNv2, in plain PyTorch: MLPerf's DLRM-DCNv2
(MLCommons training ``recommendation_v2/torchrec_dlrm``, inference
``recommendation/dlrm_v2``) as torchrec's ``DLRM_DCN`` computes it, with
DCN-v2's low-rank cross network (arXiv:2008.13535). It imports nothing of
the program and no JAX.

- the lookup: each field's multi-hot bag gathered from the logical table
  (one row per id of the union vocabulary, the fields' rows in order), the
  rows cast to fp32 and summed in fp32, in torch's order;
- the bottom MLP ``x @ w + b`` with a ReLU after every layer, the last too
  (torchrec's ``DenseArch``);
- the cross network over x0 = [x | e_0 ... e_25]: ``x_{l+1} = x0 *
  ((x_l @ V_l) @ W_l + b_l) + x_l`` (``LowRankCrossNet``);
- the top MLP, with no activation after its last layer, then the sigmoid.

Departures from MLPerf: the table is stored in bfloat16 (MLPerf's is fp32,
104.5 GB, which one 80 GB card cannot hold); the weights are random from
the seed (MLPerf trains them); the ids are synthetic (MLPerf's multi-hot
bags are materialised from Criteo 1TB, which is not here).

The weights come from the seed (``make_weights``): the table a chunk of
``chunk_rows`` rows at a time (``table_chunks``), each chunk N(0, 0.02^2)
in fp32 from a generator of its own, cast to ``emb_dtype``; the dense
weights from one generator (``dense_weights``). The ``dlrm_dcn`` adapter
makes the program's table from the same chunks, one at a time, in place.

``precision='tf32'`` is the control: every matrix product in TF32 (on the
card the backend's TF32 switch; on the CPU each operand rounded to TF32's
10-bit mantissa first).
"""
from __future__ import annotations

import math

import torch

from portbench.generate import WEIGHTS, generator
from portbench.reference.dlrm import _mm, precision_ctx

BLOCK = 16384              # samples a block of the scores


def table_chunks(cfg: dict, seed: int, device):
    """(first row, rows) of the logical table, ``chunk_rows`` rows at a
    time: chunk k N(0, 0.02^2) in fp32 from the seed's generator ``1 +
    k``, cast to ``emb_dtype``."""
    V, D, n = sum(cfg["vocab_sizes"]), cfg["embed_dim"], cfg["chunk_rows"]
    dtype = getattr(torch, cfg["emb_dtype"])
    for k, start in enumerate(range(0, V, n)):
        g = generator(seed, WEIGHTS, device, index=1 + k)
        rows = min(n, V - start)
        x = torch.randn((rows, D), generator=g, device=device)
        yield start, x.mul_(0.02).to(dtype)


def _linear(g, a: int, b: int, device, dtype) -> torch.Tensor:
    """(a, b): a standard normal cut at +-2, times 1/sqrt(a)."""
    w = torch.empty((a, b), device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=g)
    return (w / math.sqrt(a)).to(dtype)


def _bias(g, n: int, device, dtype) -> torch.Tensor:
    return (torch.randn((n,), generator=g, device=device) * 0.05).to(dtype)


def dense_weights(cfg: dict, seed: int, device) -> dict:
    """The bottom MLP, the cross layers and the top MLP, in that order from
    the seed's generator 0, in ``dtype``: weights (in, out) cut normals
    over sqrt(in), biases N(0, 0.05^2)."""
    g = generator(seed, WEIGHTS, device)
    dtype = getattr(torch, cfg["dtype"])
    F, D = len(cfg["vocab_sizes"]), cfg["embed_dim"]
    N, r = (F + 1) * D, cfg["cross_rank"]

    def mlp(dims):
        ws, bs = [], []
        for a, b in zip(dims[:-1], dims[1:]):
            ws.append(_linear(g, a, b, device, dtype))
            bs.append(_bias(g, b, device, dtype))
        return {"w": ws, "b": bs}

    bot = mlp([cfg["n_dense"], *cfg["bot_mlp"]])
    cross = {"v": [], "w": [], "b": []}
    for _ in range(cfg["cross_layers"]):
        cross["v"].append(_linear(g, N, r, device, dtype))
        cross["w"].append(_linear(g, r, N, device, dtype))
        cross["b"].append(_bias(g, N, device, dtype))
    top = mlp([N, *cfg["top_mlp"], 1])
    return {"bot": bot, "cross": cross, "top": top}


def make_weights(cfg: dict, seed: int, device) -> dict:
    """The logical table (sum of the vocabularies, D) in ``emb_dtype``, made
    a chunk at a time in place, and the dense weights."""
    V, D = sum(cfg["vocab_sizes"]), cfg["embed_dim"]
    table = torch.empty((V, D), dtype=getattr(torch, cfg["emb_dtype"]),
                        device=device)
    for start, chunk in table_chunks(cfg, seed, device):
        table[start:start + chunk.shape[0]] = chunk
    return {"table": table, **dense_weights(cfg, seed, device)}


def field_sums(cfg: dict, table: torch.Tensor, sparse: torch.Tensor
               ) -> torch.Tensor:
    """(B, F, D) fp32: each field's rows (its columns of the (B, sum of
    sizes) ids) cast to fp32 and summed; a hole (-1) adds nothing."""
    out, col, start = [], 0, 0
    for n, v in zip(cfg["multi_hot_sizes"], cfg["vocab_sizes"]):
        ids = sparse[:, col:col + n].long()
        rows = table[torch.where(ids >= 0, ids + start, 0)].float()
        out.append(torch.where((ids >= 0)[..., None], rows, 0.0).sum(1))
        col, start = col + n, start + v
    return torch.stack(out, 1)


def mlp(p: dict, x: torch.Tensor, precision: str, last_relu: bool
        ) -> torch.Tensor:
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = _mm(x, w, precision) + b
        if i < n - 1 or last_relu:
            x = torch.relu(x)
    return x


def cross(p: dict, x0: torch.Tensor, precision: str) -> torch.Tensor:
    x = x0
    for v, w, b in zip(p["v"], p["w"], p["b"]):
        x = x0 * (_mm(_mm(x, v, precision), w, precision) + b) + x
    return x


def logits(cfg: dict, w: dict, dense: torch.Tensor, sparse: torch.Tensor,
           precision: str = "fp32") -> torch.Tensor:
    """(B,) logits of one block."""
    e = field_sums(cfg, w["table"], sparse)
    x = mlp(w["bot"], dense, precision, last_relu=True)
    x0 = torch.cat([x, e.reshape(e.shape[0], -1)], dim=1)
    return mlp(w["top"], cross(w["cross"], x0, precision), precision,
               last_relu=False)[:, 0]


def scores(cfg: dict, w: dict, batch: dict, precision: str = "fp32",
           block: int = BLOCK) -> torch.Tensor:
    """sigmoid of the logits, (B,) fp32, in blocks of ``block`` samples."""
    out = []
    with torch.no_grad(), precision_ctx(precision, batch["dense"].device):
        for s in range(0, batch["dense"].shape[0], block):
            z = logits(cfg, w, batch["dense"][s:s + block],
                       batch["sparse"][s:s + block], precision)
            out.append(torch.sigmoid(z).float())
    return torch.cat(out)
