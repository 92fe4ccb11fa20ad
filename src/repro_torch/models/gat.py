"""GAT (Veličković et al., arXiv:1710.10903) on segment ops (the port of
``repro/models/gat.py``).

Message passing is an SDDMM (per-edge attention scores), a segment
softmax over each node's in-edges, and an SpMM (the attention-weighted
scatter-sum of the sources' projections). The reference builds all three
on ``jax.ops.segment_*`` outside any Pallas call, so their port is plain
PyTorch gathers and scatters (``sparse/ops.py``); no kernel of the port
runs here.

Three input forms, one layer:
  full graph   — ``edge_src`` / ``edge_dst`` over the whole graph
                 (``forward_full``; ``loss_full``)
  sampled      — padded bipartite blocks from ``sparse/sampler.py``
                 (``forward_blocks``; ``loss_blocks``)
  batched mol  — a block-diagonal edge list over small graphs, mean-pooled
                 per graph (``loss_molecule``)

The SpMM is ``_EdgeSpMM``: it adds the messages edge chunk by edge chunk
and recomputes them in the backward, so the (E, heads, out) messages,
15.8 GB at ``ogb_products``' 61.9 M edges, never exist at once. The chunks
add in stream order, so on the CPU the sum is the unchunked one.

Under a ``DistCtx`` (``dist``) the EDGE LIST is cut over the whole grid
(dp and bank; ``dist.sharding.gnn_batch_shardings``) and the node
features, params and outputs are held whole on every rank, as the
reference's ``shard_map`` branch: each rank scatters its edges into a
full-size node buffer and the partials are summed over the grid. The
softmax spans ranks: the local segment max (without a gradient, as the
reference's ``stop_gradient``), a ``pmax``, the ``exp``, and a ``psum`` of
the denominators and of the messages. The replicated projections enter
the rank's edge work through ``pbroadcast`` (their cotangents summed over
the grid) and the summed outputs leave it through ``psum_replicated``, so
every rank ends with one device's gradient.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.embedding import DistCtx
from repro_torch.dist.collectives import WORLD, pbroadcast, psum_replicated
from repro_torch.models.common import dense_init
from repro_torch.sparse.ops import segment_max, segment_softmax, segment_sum

MASKED = -1e30          # a padding edge's score, as the reference's
SPMM_CHUNK = 1 << 27    # elements of one chunk's (edges, heads, out) message


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    d_feat: int
    n_classes: int
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    dtype: Any = torch.float32
    neg_slope: float = 0.2

    def param_count(self) -> int:
        n = self.d_feat * self.d_hidden * self.n_heads
        n += 2 * self.n_heads * self.d_hidden
        hid = self.d_hidden * self.n_heads
        for _ in range(self.n_layers - 2):
            n += hid * hid + 2 * hid
        n += hid * self.n_classes + 2 * self.n_classes
        return n


def init_params(cfg: GATConfig, generator: torch.Generator, *,
                device: str | torch.device | None = "cuda") -> dict:
    """``{"layers": [{"w": (in, heads * out), "a_src": (heads, out),
    "a_dst": (heads, out)}]}``: the reference's shapes and fan-in
    truncated-normal scales, drawn from ``generator`` on ``device``
    (torch's draws: parity tests carry the reference's params across with
    ``convert.gat_params_from_jax``)."""
    dev = resolve_device(device)
    dims_in = [cfg.d_feat] + [cfg.d_hidden * cfg.n_heads] * (cfg.n_layers - 1)
    heads = [cfg.n_heads] * (cfg.n_layers - 1) + [1]
    outs = [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    layers = []
    for i in range(cfg.n_layers):
        H, O = heads[i], outs[i]
        layers.append({
            k: dense_init(generator, shape, dtype=cfg.dtype, device=dev)
            for k, shape in (("w", (dims_in[i], H * O)), ("a_src", (H, O)),
                             ("a_dst", (H, O)))})
    return {"layers": layers}


class _EdgeSpMM(torch.autograd.Function):
    """out[d, h, :] = the sum over the edges e into d of att[e, h] *
    z[src_e, h, :]: (n_dst, heads, out). The messages are made and added
    SPMM_CHUNK elements at a time, and remade in the backward (z's
    cotangent scatters back over src, att's is the message's dot with the
    output cotangent), so only z, att and the edge list are kept."""

    @staticmethod
    def forward(ctx, z, att, e_src, e_dst, n_dst):
        ctx.save_for_backward(z, att, e_src, e_dst)
        out = z.new_zeros((n_dst, *z.shape[1:]))
        for s in _chunks(e_src.shape[0], z):
            out.index_add_(0, e_dst[s], z[e_src[s]] * att[s, :, None])
        return out

    @staticmethod
    def backward(ctx, ct):
        z, att, e_src, e_dst = ctx.saved_tensors
        gz = torch.zeros_like(z) if ctx.needs_input_grad[0] else None
        gatt = torch.empty_like(att) if ctx.needs_input_grad[1] else None
        for s in _chunks(e_src.shape[0], z):
            g = ct[e_dst[s]]                                  # (C, H, O)
            if gz is not None:
                gz.index_add_(0, e_src[s], g * att[s, :, None])
            if gatt is not None:
                gatt[s] = (g * z[e_src[s]]).sum(-1)
        return gz, gatt, None, None, None


def _chunks(n_edges: int, z: torch.Tensor):
    step = max(1, SPMM_CHUNK // max(1, z.shape[1] * z.shape[2]))
    return [slice(lo, min(lo + step, n_edges))
            for lo in range(0, n_edges, step)]


def _scores(alpha_src, alpha_dst, e_src, e_dst, mask, neg_slope):
    """SDDMM: LeakyReLU of each edge's source and destination terms, a
    padding edge's score MASKED. The gathers are ``index_select``, whose
    backward is an ``index_add_``: a subscript's (``x[idx]``) sorts the
    indices and adds each node's run in one pass, which a hub of millions
    of in-edges serialises (2.3 s of an ``ogb_products`` step of 2.95 s on
    an H100)."""
    s = F.leaky_relu(alpha_src.index_select(0, e_src)
                     + alpha_dst.index_select(0, e_dst), neg_slope)
    return torch.where(mask, s, MASKED)


def _agg_sharded(z_src, alpha_src, alpha_dst, e_src, e_dst, mask, n_dst,
                 neg_slope, dist: DistCtx):
    """This rank's edges' share of the layer's aggregation, summed over
    the grid: the softmax's max and denominator span every rank's edges."""
    z_src, alpha_src, alpha_dst = (pbroadcast(x, dist)
                                   for x in (z_src, alpha_src, alpha_dst))
    s = _scores(alpha_src, alpha_dst, e_src, e_dst, mask, neg_slope)
    with torch.no_grad():
        m = segment_max(s, e_dst, n_dst)
        m = dist.pmax(torch.where(torch.isfinite(m), m, MASKED), WORLD)
    ex = torch.where(mask, torch.exp(s - m.index_select(0, e_dst)), 0.0)
    denom = pbroadcast(psum_replicated(segment_sum(ex, e_dst, n_dst), dist),
                       dist)
    att = ex / torch.clamp(denom.index_select(0, e_dst), min=1e-20)
    return psum_replicated(_EdgeSpMM.apply(z_src, att, e_src, e_dst, n_dst),
                           dist)


def gat_layer(lw: dict, h_src: torch.Tensor, h_dst: torch.Tensor,
              edge_src: torch.Tensor, edge_dst: torch.Tensor,
              edge_mask: torch.Tensor, n_dst: int, *, heads: int, out: int,
              neg_slope: float, dist: DistCtx | None,
              final: bool) -> torch.Tensor:
    """One GAT conv. h_src: (Ns, F) features of message sources; h_dst:
    (Nd, F) of updated nodes; edges are (src local, dst local) with a
    mask (under ``dist``: this rank's piece of them). -> (n_dst, heads *
    out) after ELU, or the final layer's (n_dst, out), the mean over its
    heads."""
    z_src = (h_src @ lw["w"]).reshape(-1, heads, out)
    z_dst = (h_dst @ lw["w"]).reshape(-1, heads, out)
    alpha_src = torch.einsum("nho,ho->nh", z_src, lw["a_src"])
    alpha_dst = torch.einsum("nho,ho->nh", z_dst, lw["a_dst"])
    e_src, e_dst = edge_src.long(), edge_dst.long()
    mask = edge_mask[:, None]
    if dist is None:
        s = _scores(alpha_src, alpha_dst, e_src, e_dst, mask, neg_slope)
        att = torch.where(mask, segment_softmax(s, e_dst, n_dst), 0.0)
        hz = _EdgeSpMM.apply(z_src, att, e_src, e_dst, n_dst)
    else:
        hz = _agg_sharded(z_src, alpha_src, alpha_dst, e_src, e_dst, mask,
                          n_dst, neg_slope, dist)
    if final:
        return hz.mean(dim=1)                              # (Nd, n_classes)
    return F.elu(hz.reshape(hz.shape[0], heads * out))


def _layer_shape(cfg: GATConfig, i: int) -> tuple[bool, int, int]:
    final = i == cfg.n_layers - 1
    return (final, 1 if final else cfg.n_heads,
            cfg.n_classes if final else cfg.d_hidden)


def forward_full(cfg: GATConfig, params: dict, batch: dict,
                 dist: DistCtx | None = None) -> torch.Tensor:
    """Full-graph forward: features (N, F), edge_src / edge_dst (E,), an
    optional edge_mask -> logits (N, C)."""
    h = batch["features"].to(cfg.dtype)
    e_src, e_dst = batch["edge_src"].long(), batch["edge_dst"].long()
    e_mask = batch.get("edge_mask")
    if e_mask is None:
        e_mask = torch.ones(e_src.shape, dtype=torch.bool,
                            device=e_src.device)
    n = h.shape[0]
    for i, lw in enumerate(params["layers"]):
        final, heads, out = _layer_shape(cfg, i)
        h = gat_layer(lw, h, h, e_src, e_dst, e_mask, n, heads=heads,
                      out=out, neg_slope=cfg.neg_slope, dist=dist,
                      final=final)
    return h


def forward_blocks(cfg: GATConfig, params: dict, batch: dict,
                   dist: DistCtx | None = None) -> torch.Tensor:
    """Sampled mini-batch forward over bipartite blocks (outermost first).

    Each block's dst count comes from the arrays' shapes, as the
    reference's (the dst nodes of block i are the src prefix of block
    i+1): the innermost is ``len(labels)`` (the seeds), and walking
    outward ``ndst[i] = ndst[i+1] + len(edges[i+1])``. Under ``dist`` an
    edge array is this rank's piece, one of the world's equal cuts
    (``gnn_batch_shardings``), so the whole length is the world times
    it."""
    world = 1 if dist is None else dist.data * dist.model
    ndst = [0] * cfg.n_layers
    ndst[-1] = batch["labels"].shape[0]
    for i in range(cfg.n_layers - 2, -1, -1):
        ndst[i] = ndst[i + 1] + world * batch[f"block{i + 1}_src"].shape[0]
    h = batch["block0_feats"].to(cfg.dtype)
    for i in range(cfg.n_layers):
        final, heads, out = _layer_shape(cfg, i)
        n_dst = ndst[i]
        # the dst nodes are the first n_dst of the src set by construction
        h = gat_layer(params["layers"][i], h, h[:n_dst],
                      batch[f"block{i}_src"], batch[f"block{i}_dst"],
                      batch[f"block{i}_mask"], n_dst, heads=heads, out=out,
                      neg_slope=cfg.neg_slope, dist=dist, final=final)
    return h


def masked_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """The mean cross-entropy over the rows where ``mask`` holds (0 rows:
    0), in fp32 at least (fp32 for the reference's dtypes); a negative
    label is read as class 0, as the reference clips it."""
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    lse = torch.logsumexp(lf, dim=-1)
    ll = lf.gather(-1, labels.long().clamp(min=0)[:, None])[:, 0]
    per = torch.where(mask, lse - ll, 0.0)
    return per.sum() / torch.clamp(mask.sum(), min=1)


def loss_full(cfg, params, batch, dist=None):
    logits = forward_full(cfg, params, batch, dist)
    return masked_ce_loss(logits, batch["labels"], batch["label_mask"])


def loss_blocks(cfg, params, batch, dist=None):
    logits = forward_blocks(cfg, params, batch, dist)
    return masked_ce_loss(logits, batch["labels"], batch["label_mask"])


def loss_molecule(cfg, params, batch, dist=None):
    """Batched small graphs (block-diagonal edges): the mean of each
    graph's node logits, one label a graph."""
    logits = forward_full(cfg, params, batch, dist)              # (B*Nn, C)
    gid = batch["graph_ids"].long()
    n_graphs = batch["labels"].shape[0]
    pooled = segment_sum(logits, gid, n_graphs)
    cnt = segment_sum(torch.ones(gid.shape, dtype=logits.dtype,
                                 device=logits.device), gid, n_graphs)
    pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
    return masked_ce_loss(pooled, batch["labels"],
                          torch.ones(n_graphs, dtype=torch.bool,
                                     device=pooled.device))


def cell_loss(shape_id: str):
    """The loss of a GNN cell (``configs/shapes.GNN_CELLS``), as the
    reference's ``launch/cells._gat_cell`` picks it: the sampled blocks'
    for ``minibatch_lg``, the pooled one for ``molecule``, else the full
    graph's."""
    return {"minibatch_lg": loss_blocks,
            "molecule": loss_molecule}.get(shape_id, loss_full)
