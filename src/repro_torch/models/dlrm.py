"""DLRM (Naumov et al., arXiv:1906.00091) with UpDLRM banked embeddings.

The port of ``repro/models/dlrm.py``. All sparse fields share ONE banked
super-table (per-field row offsets), so the paper's partitioners operate on
the union vocabulary. Two lookup flavours:

  * one-hot fields (Criteo-style ``dlrm-rm2``): dense gather (B, F) -> (B, F, D)
  * multi-hot bags (the paper's Table-1 datasets): (B, F, L) -> bag sums
    (B, F, D) in one fused stage-2 pass (the banked-bag kernel on CUDA).

The pairwise-dot interaction, with the concatenations around it, runs the
dot-interaction kernel's fused entry on CUDA (``interaction_features``: one
launch builds the top MLP's input) and its plain version on the CPU;
retrieval runs its query entry (``query_features``: one query against N
candidates, nothing broadcast to N). MLP
weights keep the reference's (in, out) layout and are applied as
``x @ w + b``. Both kernels sit inside
``torch.autograd.Function``s, so ``loss_fn`` differentiates through them:
the bag sums' backward is the sorted-run scatter (core/embedding.py), the
interaction's is plain torch (the reference leaves it to XLA too).

DLRM-DCNv2 (``interaction="dcn"``, MLPerf's DLRM-DCNv2 after torchrec's
``DLRM_DCN``; DCN-v2 is arXiv:2008.13535) is the same model with another
lookup and another interaction. Its fields are multi-hot bags of a fixed
size each (``multi_hot`` a tuple, one size a field): a batch's ``sparse``
is (B, sum(sizes)) int32, each sample's ids field by field, and the bags
are summed as CSR bags over that stream (``csr_embedding_bag``, the CSR
kernel on CUDA), in fp32 whatever the table's dtype. The bottom MLP ends in
a ReLU too. The low-rank cross network (``cross_apply``) takes x0 = [x | e_0
... e_{F-1}] (B, (F + 1) D) through ``cross_layers`` layers of rank
``cross_rank``, ``x_{l+1} = x0 * (x_l V_l W_l + b_l) + x_l``, and the top
MLP reads its output. Only ``forward`` takes this path; the dot path,
one-hot and rectangular bags, are untouched by it.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.embedding import (BankedTable,
                                        banked_cache_residual_bag,
                                        banked_embedding_bag, banked_gather,
                                        csr_embedding_bag, csr_layout,
                                        flat_remap, replicated_embedding_bag,
                                        tiered_embedding_bag)
from repro_torch.core.partitioning import uniform_partition
from repro_torch.dist.collectives import query_ctx, spread_gather
from repro_torch.kernels import dot_interaction as _dot
from repro_torch.models.common import (banked, dense_init, embed_init,
                                       table_statics)
from repro_torch.obs.tracing import setup_stage, stage


@dataclasses.dataclass(frozen=True)
class DLRMConfig:
    name: str
    vocab_sizes: tuple[int, ...]       # per sparse field
    embed_dim: int
    n_dense: int
    bot_mlp: tuple[int, ...]           # hidden dims incl. final (== embed_dim)
    top_mlp: tuple[int, ...]           # hidden dims, final 1 appended
    # bag length per field (1 => one-hot), or a tuple of each field's fixed
    # bag size (the per-field bags of interaction="dcn")
    multi_hot: int | tuple[int, ...] = 1
    interaction: str = "dot"           # "dot" | "dcn" (low-rank cross)
    dtype: Any = torch.float32
    # table STORAGE dtype — bf16 halves every table-sized buffer; dense
    # compute stays cfg.dtype
    emb_dtype: Any = torch.float32
    cross_layers: int = 0              # interaction="dcn": layers, rank
    cross_rank: int = 0

    def __post_init__(self):
        if self.interaction not in ("dot", "dcn"):
            raise ValueError(f"interaction {self.interaction!r}: 'dot' or "
                             f"'dcn'")
        if self.interaction == "dcn" and (
                not isinstance(self.multi_hot, tuple)
                or len(self.multi_hot) != self.n_sparse
                or min(self.multi_hot) < 1
                or self.cross_layers < 1 or self.cross_rank < 1):
            raise ValueError(f"{self.name}: interaction='dcn' takes a bag "
                             f"size for each of the {self.n_sparse} fields "
                             f"(multi_hot {self.multi_hot}), cross_layers "
                             f"and cross_rank >= 1")
        if self.interaction == "dot" and (
                isinstance(self.multi_hot, tuple)
                or self.cross_layers or self.cross_rank):
            raise ValueError(f"{self.name}: interaction='dot' takes one bag "
                             f"length for every field (multi_hot "
                             f"{self.multi_hot}) and no cross layers "
                             f"(cross_layers {self.cross_layers}, cross_rank "
                             f"{self.cross_rank})")

    @property
    def n_sparse(self) -> int:
        return len(self.vocab_sizes)

    @property
    def cross_width(self) -> int:
        """The cross network's width: [x | e_0 ... e_{F-1}]."""
        return (self.n_sparse + 1) * self.embed_dim

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))

    def field_offsets(self) -> np.ndarray:
        return np.concatenate([[0], np.cumsum(self.vocab_sizes)[:-1]]).astype(np.int64)

    def top_in(self) -> int:
        """The top MLP's input: the dots and x, or the cross's output."""
        if self.interaction == "dcn":
            return self.cross_width
        n_inter = self.n_sparse + 1
        return n_inter * (n_inter - 1) // 2 + self.embed_dim

    def param_count(self) -> int:
        n = self.total_vocab * self.embed_dim
        dims = [self.n_dense, *self.bot_mlp]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        dims = [self.top_in(), *self.top_mlp, 1]
        n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        if self.interaction == "dcn":
            n += self.cross_layers * (2 * self.cross_width * self.cross_rank
                                      + self.cross_width)
        return n


def _mlp_params(generator: torch.Generator, dims: Sequence[int], dtype,
                device) -> dict:
    return {
        "w": [dense_init(generator, (a, b), dtype=dtype, device=device)
              for a, b in zip(dims[:-1], dims[1:])],
        "b": [torch.zeros((b,), dtype=dtype, device=device) for b in dims[1:]],
    }


def mlp_apply(p: dict, x: torch.Tensor, act=torch.relu,
              final_act=None) -> torch.Tensor:
    n = len(p["w"])
    for i, (w, b) in enumerate(zip(p["w"], p["b"])):
        x = x @ w + b
        if i < n - 1:
            x = act(x)
        elif final_act is not None:
            x = final_act(x)
    return x


def init_params(cfg: DLRMConfig, generator: torch.Generator, plan=None,
                rows_per_bank: int | None = None, *,
                device: str | torch.device | None = "cuda"
                ) -> tuple[dict, dict]:
    """Returns (params, statics). ``plan`` is a PartitionPlan over the union
    vocab (default: one bank, identity layout); statics carries the row
    remap. ``generator`` lives on ``device``. ``rows_per_bank``
    over-allocates each bank to a fixed capacity (>= the plan's max)."""
    dev = resolve_device(device)
    if plan is None:
        plan = uniform_partition(cfg.total_vocab, 1)
    rows_per_bank = int(plan.max_rows_per_bank if rows_per_bank is None
                        else rows_per_bank)
    if rows_per_bank < plan.max_rows_per_bank:
        raise ValueError(f"rows_per_bank {rows_per_bank} < the plan's "
                         f"{plan.max_rows_per_bank}")
    packed = embed_init(generator, (plan.n_banks * rows_per_bank,
                                    cfg.embed_dim),
                        dtype=cfg.emb_dtype, device=dev)
    params = {
        "emb_packed": packed,
        "bot": _mlp_params(generator, [cfg.n_dense, *cfg.bot_mlp], cfg.dtype,
                           dev),
        "top": _mlp_params(generator, [cfg.top_in(), *cfg.top_mlp, 1],
                           cfg.dtype, dev),
    }
    if cfg.interaction == "dcn":
        params["cross"] = _cross_params(generator, cfg, dev)
    return params, plan_statics(cfg, plan, rows_per_bank, device=dev)


def _cross_params(generator: torch.Generator, cfg: DLRMConfig,
                  device) -> dict:
    """Each cross layer's V (width, rank), W (rank, width) and bias b
    (width,), in the (in, out) layout."""
    n, r = cfg.cross_width, cfg.cross_rank
    return {
        "v": [dense_init(generator, (n, r), dtype=cfg.dtype, device=device)
              for _ in range(cfg.cross_layers)],
        "w": [dense_init(generator, (r, n), dtype=cfg.dtype, device=device)
              for _ in range(cfg.cross_layers)],
        "b": [torch.zeros((n,), dtype=cfg.dtype, device=device)
              for _ in range(cfg.cross_layers)],
    }


@setup_stage("setup.statics")
def plan_statics(cfg: DLRMConfig, plan, rows_per_bank: int, *,
                 device: str | torch.device | None = "cuda") -> dict:
    """The statics ``init_params`` returns for ``plan`` at a per-bank
    capacity of ``rows_per_bank``: the row remaps (bank, slot and the flat
    remap computed once), the bank count and capacity, the field offsets.
    Per-field bags (``multi_hot`` a tuple) add ``entry_offsets``, the field
    offset of each of a sample's ids, and ``bag_layouts``, the CSR layout
    of a batch size, filled by ``forward`` at its first batch of that
    size."""
    dev = resolve_device(device)
    statics = table_statics(plan, rows_per_bank, device=dev)
    statics["field_offsets"] = torch.from_numpy(
        cfg.field_offsets().astype(np.int32)).to(dev)
    if isinstance(cfg.multi_hot, tuple):
        statics["entry_offsets"] = torch.from_numpy(np.repeat(
            cfg.field_offsets(), cfg.multi_hot).astype(np.int32)).to(dev)
        statics["bag_layouts"] = {}
    return statics


def _banked(params: dict, statics: dict) -> BankedTable:
    return banked(params, statics)


class _DotInteraction(torch.autograd.Function):
    """The interaction kernel's wrapper (``plain``: its plain version) with
    a plain-torch backward: the (B, P) cotangent scattered into the upper
    triangle of G (B, F, F), then ``dz = (G + Gᵀ) z``."""

    @staticmethod
    def forward(ctx, z, plain: bool):
        ctx.save_for_backward(z)
        return (_dot.dot_interaction_plain if plain
                else _dot.dot_interaction)(z)

    @staticmethod
    def backward(ctx, ct):
        (z,) = ctx.saved_tensors
        return _dot_grad(z, ct), None


def _dot_grad(z: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """dz of the pairwise dots of z (B, F, D) for their (B, P) cotangent:
    ct scattered into the upper triangle of G (B, F, F), then
    ``(G + Gᵀ) z`` in fp32, cast to z's dtype."""
    B, F, _ = z.shape
    iu, ju = torch.triu_indices(F, F, offset=1, device=z.device)
    g = torch.zeros((B, F, F), dtype=torch.float32, device=z.device)
    g[:, iu, ju] = ct.float()
    return torch.bmm(g + g.mT, z.float()).to(z.dtype)


_INTERACTION_BACKENDS = ("auto", "torch", "cuda", "tuned")


def _interaction_plain(backend: str, device: torch.device) -> bool:
    """Whether the interaction runs its plain version. 'tuned' is 'auto':
    the interaction has no tuned signature (nor in the reference)."""
    if backend not in _INTERACTION_BACKENDS:
        raise ValueError(f"backend must be one of {_INTERACTION_BACKENDS}, "
                         f"got {backend!r}")
    if backend == "cuda" and device.type not in ("cuda", "meta"):
        raise ValueError(f"backend='cuda' needs CUDA tensors, got {device}")
    return backend == "torch"


def dot_interaction(z: torch.Tensor, backend: str = "auto") -> torch.Tensor:
    """z: (B, F, D) -> (B, F*(F-1)/2) upper-triangular pairwise dots.

    'auto' (and 'tuned') runs the kernel on CUDA tensors and the plain
    version on CPU tensors; 'torch' the plain version anywhere; 'cuda' the
    kernel only. All share one backward."""
    return _DotInteraction.apply(z.contiguous(),
                                 _interaction_plain(backend, z.device))


class _DotFeatures(torch.autograd.Function):
    """The interaction with its two concatenations, ``feat = [dots([x |
    emb]) | x]`` (the top MLP's input), in one launch of the kernel's fused
    entry (``plain``: its plain version). Backward: ``_dot_grad`` on z =
    [x | emb] rebuilt, plus the copied x's own cotangent."""

    @staticmethod
    def forward(ctx, x, emb, plain: bool):
        ctx.save_for_backward(x, emb)
        return (_dot.dot_features_plain if plain
                else _dot.dot_features)(x, emb)

    @staticmethod
    def backward(ctx, ct):
        x, emb = ctx.saved_tensors
        P = ct.shape[1] - x.shape[1]
        dz = _dot_grad(torch.cat([x[:, None], emb], dim=1), ct[:, :P])
        return dz[:, 0] + ct[:, P:], dz[:, 1:], None


def interaction_features(x: torch.Tensor, emb: torch.Tensor,
                         backend: str = "auto") -> torch.Tensor:
    """x (B, D), emb (B, F-1, D) -> (B, P + D): the pairwise dots of
    [x | emb] followed by x, the top MLP's input (the reference's
    ``concatenate([dot_interaction(concatenate([x[:, None], emb])), x])``).
    Backends as ``dot_interaction``'s."""
    return _DotFeatures.apply(x.contiguous(), emb.contiguous(),
                              _interaction_plain(backend, x.device))


class _DotFeaturesQuery(torch.autograd.Function):
    """The query entry (``plain``: its plain version): row n of ``feat`` is
    ``interaction_features`` of x and ``[user | cand[n]]``, with x (D,) and
    the user rows (U, D) never broadcast to N. A Function, not a plain call
    under ``inference_mode``: the serve step runs it under
    ``inference_mode`` (nothing saved, nothing recorded), and a caller that
    differentiates the scores, as ``jax.grad`` can the reference's, gets
    the broadcast graph's gradients without its (N, F, D) buffer. Backward:
    the constant columns' summed cotangent S (upper triangle over x and
    the user rows) gives ``(S + Sᵀ) q``, the candidate columns' cotangent C
    (N, U + 1) gives ``Cᵀ cand`` to q and ``C q`` to cand, and the copied
    x's columns add their sum to x (q = [x | user], fp32)."""

    @staticmethod
    def forward(ctx, x, user, cand, plain: bool):
        ctx.save_for_backward(x, user, cand)
        return (_dot.dot_features_query_plain if plain
                else _dot.dot_features_query)(x, user, cand)

    @staticmethod
    def backward(ctx, ct):
        x, user, cand = ctx.saved_tensors
        F = user.shape[0] + 2
        P = F * (F - 1) // 2
        iu, ju = torch.triu_indices(F, F, offset=1, device=ct.device)
        last = ju == F - 1                   # the columns against cand[n]
        dots = ct[:, :P].float()
        s = torch.zeros((F - 1, F - 1), dtype=torch.float32,
                        device=ct.device)
        s[iu[~last], ju[~last]] = dots[:, ~last].sum(0)
        c = dots[:, last]                                         # (N, U + 1)
        q = torch.cat([x[None], user]).float()                    # (U + 1, D)
        dq = (s + s.T) @ q + c.T @ cand.float()
        dx = dq[0] + ct[:, P:].float().sum(0)
        return (dx.to(x.dtype), dq[1:].to(user.dtype),
                (c @ q).to(cand.dtype), None)


def query_features(x: torch.Tensor, user: torch.Tensor, cand: torch.Tensor,
                   backend: str = "auto") -> torch.Tensor:
    """x (D,), user (U, D), cand (N, D) -> (N, P + D): the top MLP's input
    for one query against N candidates, ``interaction_features(x.expand(N,
    -1), cat([user.expand(N, -1, -1), cand[:, None]], 1))`` without the
    broadcast (the kernel's query entry). Backends as
    ``dot_interaction``'s."""
    return _DotFeaturesQuery.apply(x.contiguous(), user.contiguous(),
                                   cand.contiguous(),
                                   _interaction_plain(backend, cand.device))


def forward(cfg: DLRMConfig, params: dict, statics: dict, batch: dict,
            dist=None, *, backend: str = "auto", bwd_backend: str = "auto",
            tiered=None, replicated=None,
            bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """batch: dense (B, n_dense) fp; sparse (B, F) int32 (one-hot fields) or
    (B, F, L) multi-hot. Returns logits (B,).

    ``backend`` selects the kernels or their plain versions for the bag
    sums and the interaction ('auto' | 'torch' | 'cuda' | 'tuned'; see
    core/embedding.py: 'tuned' resolves the bag sums through the dispatch
    cache, the interaction as 'auto'); ``bwd_backend`` the bag sums'
    gradient scatter ('auto' follows ``backend``). The multi-hot path
    hands the RAW (B, F, L) per-field ids plus ``field_offsets`` to ONE
    fused banked_embedding_bag call. ``bank_live`` ((n_banks,) bool)
    serves through a bank failure: reads homed on dead banks resolve to
    the zero row.

    ``cfg.interaction == "dcn"`` takes the DCN path (``forward_dcn``):
    sparse (B, sum(multi_hot)) per-field ids, no ``dist``, ``tiered``,
    ``replicated`` or ``bank_live``.

    ``tiered`` (a ``quant.TieredTable`` in the packed layout of
    ``params['emb_packed']``) serves the tiered-precision lookup instead:
    the bag sums dequantize each row by its tier (the tiered kernel on CUDA
    tensors), and gradients flow straight through onto
    ``params['emb_packed']``; one-hot fields fold into length-1 bags. It
    does not combine with ``bank_live`` or ``replicated`` (ValueError, as
    in the reference).

    ``dist`` (a ``core.embedding.DistCtx``): ``params['emb_packed']`` is
    this rank's bank shard (``dist.sharding.recsys_param_shardings``), the
    dense MLPs are whole, ``batch`` is the rank's dp slice and so are the
    logits; the lookup sums its banks' partials over the bank group. The
    replicated lookup refuses it, as the reference's does.

    ``replicated`` (a ``core.embedding.ReplicatedTable``, the runtime's
    hot-row replica side table) serves the replica-aware lookup instead:
    each bag reads one copy of each row, picked by a hash of the bag, so a
    hot row's traffic splits across its copies' banks. It composes with
    ``bank_live``: a surviving copy serves a dead bank's reads before any
    read degrades to the zero row. One-hot fields fold into length-1 bags.
    """
    if cfg.interaction == "dcn":
        if dist is not None or tiered is not None or replicated is not None \
                or bank_live is not None:
            raise ValueError(f"{cfg.name}: the DCN path serves one device's "
                             f"whole table (no dist, tiered, replicated or "
                             f"bank_live)")
        return forward_dcn(cfg, params, statics, batch, backend=backend,
                           bwd_backend=bwd_backend)
    dense, sparse = batch["dense"], batch["sparse"]
    t = _banked(params, statics)
    with stage("dlrm.lookup", like=dense):
        if replicated is not None:
            if tiered is not None:
                raise ValueError("tiered x replicated serving is not "
                                 "wired — replicas are the full-precision "
                                 "head")
            bags = sparse if sparse.dim() == 3 else sparse[..., None]
            emb = replicated_embedding_bag(                      # (B, F, D)
                replicated, bags, dist, backend=backend,
                bwd_backend=bwd_backend,
                field_offsets=statics["field_offsets"], bank_live=bank_live)
        elif tiered is not None:
            if bank_live is not None:
                raise ValueError("bank_live degraded serving is not wired "
                                 "into the tiered lookup path")
            bags = sparse if sparse.dim() == 3 else sparse[..., None]
            emb = tiered_embedding_bag(                          # (B, F, D)
                params["emb_packed"], tiered, bags, dist, backend=backend,
                bwd_backend=bwd_backend,
                field_offsets=statics["field_offsets"])
        elif sparse.dim() == 2:
            # one-hot fields: dense gather; per-field ids -> union-vocab rows
            rows = sparse + statics["field_offsets"][None, :]
            rows = torch.where(sparse >= 0, rows, -1)
            emb = banked_gather(t, rows, dist,
                                bank_live=bank_live)             # (B, F, D)
        else:
            emb = banked_embedding_bag(                          # (B, F, D)
                t, sparse, dist, backend=backend, bwd_backend=bwd_backend,
                field_offsets=statics["field_offsets"], bank_live=bank_live)
        emb = emb.to(cfg.dtype)

    with stage("dlrm.bot_mlp", like=dense):
        x = mlp_apply(params["bot"], dense.to(cfg.dtype))        # (B, D)
    with stage("dlrm.interaction", like=dense):
        feat = interaction_features(x, emb, backend)             # (B, P + D)
    with stage("dlrm.top_mlp", like=dense):
        return mlp_apply(params["top"], feat)[:, 0]


def field_bags(cfg: DLRMConfig, params: dict, statics: dict,
               sparse: torch.Tensor, *, backend: str = "auto",
               bwd_backend: str = "auto") -> torch.Tensor:
    """The per-field bag sums of DLRM-DCNv2, (B, F, D) fp32: ``sparse`` (B,
    sum(multi_hot)) int32 holds each sample's ids field by field, -1 for a
    hole. The field offsets are added to the ids, and the B * F bags,
    ragged by field, are summed as CSR bags (``csr_embedding_bag``, the
    kernel's fp32-output instance on CUDA). Bag (b, f) starts at ``b *
    sum(multi_hot) + prefix[f]``: a batch size's bag starts and segment
    ids are built once and kept in ``statics['bag_layouts']``."""
    B, width = sparse.shape
    sizes = cfg.multi_hot
    if width != sum(sizes):
        raise ValueError(f"{cfg.name}: sparse {tuple(sparse.shape)}, want "
                         f"(B, {sum(sizes)}) per-field ids")
    F = len(sizes)
    layout = statics["bag_layouts"].get(B)
    if layout is None:
        with torch.inference_mode(False):      # kept, and saved for backward
            prefix = torch.tensor([0, *np.cumsum(sizes)[:-1]],
                                  dtype=torch.int32, device=sparse.device)
            starts = (torch.arange(B, dtype=torch.int32, device=sparse.device
                                   )[:, None] * width + prefix).reshape(-1)
            layout = (starts, *csr_layout(starts, B * width))
        statics["bag_layouts"][B] = layout
    rows = torch.where(sparse >= 0, sparse + statics["entry_offsets"], -1)
    emb = csr_embedding_bag(_banked(params, statics), rows.reshape(-1),
                            layout[0], B * F, backend=backend,
                            bwd_backend=bwd_backend, out_dtype=torch.float32,
                            layout=layout[1:])
    return emb.reshape(B, F, -1)


def cross_apply(p: dict, x0: torch.Tensor) -> torch.Tensor:
    """The low-rank cross network (DCN-v2, torchrec's ``LowRankCrossNet``):
    ``x_{l+1} = x0 * (x_l V_l W_l + b_l) + x_l`` from x_0 = x0, each layer
    two matrix products (the bias added in the second) and one fused
    multiply-add."""
    x = x0
    for v, w, b in zip(p["v"], p["w"], p["b"]):
        x = torch.addcmul(x, x0, torch.addmm(b, x @ v, w))
    return x


def forward_dcn(cfg: DLRMConfig, params: dict, statics: dict, batch: dict,
                *, backend: str = "auto",
                bwd_backend: str = "auto") -> torch.Tensor:
    """DLRM-DCNv2's logits (B,): the per-field bag sums (``field_bags``),
    the bottom MLP with a ReLU after every layer, the cross network over
    [x | e_0 ... e_{F-1}] (``cross_apply``), the top MLP. Its stage spans:
    ``dlrm.lookup``, ``dlrm.bot_mlp``, ``dlrm.cross`` (the concatenation
    and every layer) and ``dlrm.top_mlp``."""
    dense, sparse = batch["dense"], batch["sparse"]
    with stage("dlrm.lookup", like=dense):
        emb = field_bags(cfg, params, statics, sparse, backend=backend,
                         bwd_backend=bwd_backend).to(cfg.dtype)
    with stage("dlrm.bot_mlp", like=dense):
        x = mlp_apply(params["bot"], dense.to(cfg.dtype),
                      final_act=torch.relu)                      # (B, D)
    with stage("dlrm.cross", like=dense):
        x0 = torch.cat([x, emb.reshape(emb.shape[0], -1)], dim=1)
        h = cross_apply(params["cross"], x0)                 # (B, (F + 1) D)
    with stage("dlrm.top_mlp", like=dense):
        return mlp_apply(params["top"], h)[:, 0]


def forward_cached(cfg: DLRMConfig, params: dict, statics: dict,
                   cache_table: BankedTable, batch: dict, dist=None, *,
                   backend: str = "auto", bwd_backend: str = "auto",
                   remap_bank: torch.Tensor | None = None,
                   remap_slot: torch.Tensor | None = None,
                   remap_flat: torch.Tensor | None = None,
                   bank_live: torch.Tensor | None = None) -> torch.Tensor:
    """Cache-aware path (Fig. 7): the batch carries rewritten multi-hot
    bags, ``cache_idx`` (B, F, Lc) entries into the partial-sum cache table
    and ``residual_idx`` (B, F, Lr) union-vocab rows, beside ``dense``.
    Bag sum = cache partials + residual rows in ONE fused stage-2 pass
    (``banked_cache_residual_bag``: the fused kernel on CUDA tensors), then
    the same CTR compute as ``forward``. Returns logits (B,).

    ``remap_bank`` / ``remap_slot`` override the EMT remaps in ``statics``;
    ``remap_flat`` is their flat remap, computed once with them (the
    runtime's ``BankedTable.remap_flat``), or None to compute it anew."""
    if remap_bank is not None:
        if remap_flat is None:
            remap_flat = flat_remap(remap_bank, remap_slot,
                                    statics["rows_per_bank"])
        statics = {**statics, "remap_bank": remap_bank,
                   "remap_slot": remap_slot, "remap_flat": remap_flat}
    t = _banked(params, statics)
    emb = banked_cache_residual_bag(t, cache_table, batch["cache_idx"],
                                    batch["residual_idx"], dist,
                                    backend=backend, bwd_backend=bwd_backend,
                                    bank_live=bank_live)             # (B, F, D)
    x = mlp_apply(params["bot"], batch["dense"].to(cfg.dtype))       # (B, D)
    feat = interaction_features(x, emb, backend)                     # (B, P + D)
    return mlp_apply(params["top"], feat)[:, 0]


def retrieval_scores(cfg: DLRMConfig, params: dict, statics: dict,
                     batch: dict, dist=None, *,
                     backend: str = "auto") -> torch.Tensor:
    """retrieval_cand: one query x N candidate ids for field 0 -> (N,)
    logits (no sigmoid).

    ``batch``: ``dense`` (1, n_dense), ``sparse`` (1, F) one-hot ids (field
    0's is not read), ``candidates`` (N,) field-0 ids. As the reference:
    the user side is ``x`` = the bottom MLP of the dense features and the
    rows ``sparse[:, 1:] + field_offsets[1:]`` (no mask of negative ids,
    unlike ``forward``); the candidates' rows are ``candidates +
    field_offsets[0]``; both through ``banked_gather`` (a row < 0 reads
    zeros). Then the interaction of ``[x | user rows | candidate row]`` for
    every candidate, in ``cfg.dtype``, followed by x, through the top MLP.
    The interaction is the kernel's query entry (``query_features``,
    ``backend`` as in ``forward``): x and the user rows are never broadcast
    to N, and the dots among them are taken once (on the CPU its plain
    version broadcasts, so the scores are the fused entry's bits). A
    multi-hot config raises ValueError: the reference's broadcast of (1,
    F, L) ids against (1, F - 1) offsets fails there too.

    ``dist``: the query and its N candidates are the same on every rank
    (the params the rank's bank shard). The user side is computed on every
    rank; the candidates are spread over the grid as the reference's
    ``all_mesh_axes`` spreads them (``dist.collectives.spread_gather``), so
    a rank scores only its piece and returns those scores
    (``spread_slice(dist, N)``); ``serve_step.build_retrieval_serve``
    merges the ranks' top k."""
    if cfg.multi_hot > 1 or batch["sparse"].dim() != 2:
        raise ValueError(f"retrieval_scores: {cfg.name} has multi-hot bags "
                         f"(L = {cfg.multi_hot}); the reference's retrieval "
                         f"supports one-hot fields only")
    dense, sparse, cand = batch["dense"], batch["sparse"], batch["candidates"]
    t = _banked(params, statics)
    offs = statics["field_offsets"]
    x = mlp_apply(params["bot"], dense.to(cfg.dtype))               # (1, D)
    emb_user = banked_gather(t, sparse[:, 1:] + offs[None, 1:],
                             query_ctx(dist, sparse.shape[0]))
    emb_cand = spread_gather(t, cand + offs[0], dist)               # (n, D)
    feat = query_features(x[0], emb_user[0].to(cfg.dtype),
                          emb_cand.to(cfg.dtype), backend)          # (n, P + D)
    return mlp_apply(params["top"], feat)[:, 0]


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    return torch.mean(
        torch.clamp(logits, min=0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits))))


def loss_fn(cfg: DLRMConfig, params: dict, statics: dict, batch: dict,
            dist=None, *, backend: str = "auto", bwd_backend: str = "auto",
            tiered=None) -> torch.Tensor:
    return bce_loss(forward(cfg, params, statics, batch, dist,
                            backend=backend, bwd_backend=bwd_backend,
                            tiered=tiered),
                    batch["label"])
