"""GNN neighbor sampling (GraphSAGE-style fanout) and CSR utilities, on the
host in numpy (the port of ``repro/sparse/sampler.py``).

Sampling is part of the data pipeline: it turns a graph into padded,
static-shape bipartite blocks that ``models/gat.forward_blocks`` consumes
(the ``minibatch_lg`` cell: 232,965 nodes / 114.6 M edges, batch 1,024,
fanout 15-10). Given the same graph and seed, the sampler makes the
reference's ``rng.choice`` calls in the reference's order, so its blocks
equal the reference's array for array.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    """Compressed sparse row adjacency, host-resident."""

    indptr: np.ndarray   # (n_nodes+1,) int64
    indices: np.ndarray  # (n_edges,) int32  — neighbor ids
    n_nodes: int

    @property
    def n_edges(self) -> int:
        return int(self.indices.shape[0])

    def degree(self) -> np.ndarray:
        return np.diff(self.indptr)


def stable_order(keys: np.ndarray, n: int) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` for integer keys in ``[0, n)``:
    an LSD radix sort over 16-bit digits, each a stable argsort of uint16
    digits (which numpy radix-sorts in O(len)). A stable sort's order is
    unique, so this is the same permutation; at ``minibatch_lg``'s 114.6 M
    edges numpy's timsort of the int64 keys takes ~26 s."""
    order, shift = None, 0
    while True:
        d = keys if order is None else keys[order]
        o = np.argsort(((d >> shift) & 0xFFFF).astype(np.uint16),
                       kind="stable")
        order = o if order is None else order[o]
        shift += 16
        if (max(n, 1) - 1) >> shift == 0:
            return order


def build_csr(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> CSRGraph:
    """COO edge list -> CSR by dst (``indices`` are each node's in-neighbors
    in edge order). The reference's stable argsort (``stable_order``) and
    its row counts by ``np.bincount`` where it scatters ones with
    ``np.add.at``: the same integers, each in fewer passes."""
    order = stable_order(dst, n_nodes)
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    indptr[1:] = np.bincount(dst, minlength=n_nodes)
    np.cumsum(indptr, out=indptr)
    return CSRGraph(indptr=indptr, indices=src[order].astype(np.int32),
                    n_nodes=n_nodes)


@dataclasses.dataclass
class SampledBlock:
    """One bipartite message-passing block (padded static shapes)."""

    src_ids: np.ndarray    # (n_src,) global node ids feeding this layer
    dst_ids: np.ndarray    # (n_dst,) global node ids updated by this layer
    edge_src: np.ndarray   # (n_edges,) local index into src_ids
    edge_dst: np.ndarray   # (n_edges,) local index into dst_ids
    edge_mask: np.ndarray  # (n_edges,) bool — False for padding


class NeighborSampler:
    """Uniform fanout sampler: seeds -> L blocks (outermost first).

    Shapes are padded to the worst case ``n_seeds * prod(fanouts[:k])``
    edges, so a step sees the same shapes across batches. A node of
    in-degree at most the fanout takes all its in-neighbors; a larger one
    takes ``rng.choice(deg, fanout, replace=False)`` of them."""

    def __init__(self, graph: CSRGraph, fanouts: tuple[int, ...],
                 seed: int = 0):
        self.graph = graph
        self.fanouts = tuple(fanouts)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> list[SampledBlock]:
        blocks: list[SampledBlock] = []
        dst = np.asarray(seeds, dtype=np.int64)
        g = self.graph
        for fanout in self.fanouts:
            cap = dst.shape[0] * fanout
            e_src = np.zeros(cap, dtype=np.int64)
            e_dst = np.zeros(cap, dtype=np.int64)
            mask = np.zeros(cap, dtype=bool)
            k = 0
            for j, node in enumerate(dst):
                lo, hi = g.indptr[node], g.indptr[node + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(fanout, deg)
                if deg <= fanout:
                    picks = g.indices[lo:hi]
                else:
                    picks = g.indices[lo + self.rng.choice(
                        deg, size=take, replace=False)]
                e_src[k:k + take] = picks
                e_dst[k:k + take] = j
                mask[k:k + take] = True
                k += take
            # src set = dst PREFIX ++ new neighbors: the dst-prefix order
            # lets the model take h_dst = h[:n_dst] (gat.forward_blocks)
            extra = np.setdiff1d(e_src[mask], dst)
            src_ids = np.concatenate([dst, extra])
            # edge endpoints as local indices (src_ids holds no repeat)
            loc = {n: i for i, n in enumerate(src_ids)}
            e_src_loc = np.zeros(cap, dtype=np.int32)
            e_src_loc[mask] = np.array([loc[n] for n in e_src[mask]],
                                       dtype=np.int32)
            blocks.append(SampledBlock(
                src_ids=src_ids.astype(np.int64),
                dst_ids=dst.astype(np.int64),
                edge_src=e_src_loc,
                edge_dst=e_dst.astype(np.int32),
                edge_mask=mask,
            ))
            dst = src_ids  # the next (outer) layer covers every src here
        return blocks[::-1]  # outermost first, the forward's order
