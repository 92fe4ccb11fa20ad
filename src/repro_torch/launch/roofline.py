"""Roofline terms of a step on the H100 and the per-op count they come
from (the port of ``repro/launch/roofline.py``), and the step's useful
("textbook") FLOPs (``model_flops``, ``_recsys_dense_params``,
``_gat_flops``: plain arithmetic over ``configs/shapes``' cells).

    compute    = sum over dtypes of FLOPs / that dtype's peak
    memory     = bytes / HBM rate
    collective = collective operand bytes / link rate

The reference reads its FLOPs and bytes from XLA's ``cost_analysis()`` of
a compiled module, parses the post-optimisation HLO text for the
collectives' operand bytes (``parse_collective_bytes``, ``_SHAPE_RE``,
``_DEF_RE``) and corrects the gathers' and scatters' bytes
(``analyze_hlo``). PyTorch compiles no module to read, so the port counts
the ops themselves as they run: ``CostCounter``, a dispatch mode, sees
every ATen op of a step run on ``meta`` tensors (shapes only, nothing
computed) and counts

  * FLOPs by dtype of the matrix products (``mm``, ``addmm``, ``bmm``,
    ``baddbmm``, and ``einsum`` / ``matmul`` as they decompose into them;
    torch's own ``flop_counter`` registry), an fp32 product under the
    ``"tf32"`` peak only where TF32 is allowed;
  * bytes: each input read once, each output written once; views,
    allocations and metadata move nothing; a gather (``index_select``,
    ``embedding``, ``gather``, ``index``) reads only the rows it touches,
    and a scatter (``index_add_``, ``index_put_``, ``scatter_add_``, ...)
    reads and writes the rows it touches: the reference's touched-rows
    correction (``analyze_hlo``: ``2 * out + idx`` and ``3 * updates +
    idx``), plus the copy of the operand for the out-of-place forms;
  * each hand-written kernel's own bytes and operations (PERF.md §6's
    bound column), which its wrapper reports on ``meta`` tensors through
    ``charge`` instead of running (``kernels/cost.py``);
  * collective operand bytes by the reference's ``COLLECTIVE_OPS`` kinds,
    which ``launch/mesh.DryDistCtx`` (the shape-only ``DistCtx``) reports
    through ``charge_collective``: ``psum`` and ``pmax`` are all-reduces,
    ``gather`` an all-gather;
  * the peak of live bytes: each new storage an op allocates, freed when
    the last tensor on it is (the counterpart of ``memory_analysis()``).

Elementwise FLOPs are not counted (nor are they in XLA's FLOPs of the
products that dominate); ``model_flops`` counts some (GAT's edge work).
"""
from __future__ import annotations

import math
import weakref

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

from repro_torch.core.hwmodel import H100

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute", "ragged-all-to-all", "collective-broadcast",
)

_aten = torch.ops.aten
# ops that allocate (or describe) without reading or writing a byte
_FREE = {_aten.empty, _aten.empty_like, _aten.empty_strided,
         _aten.new_empty, _aten.new_empty_strided, _aten.lift_fresh}
# ops that only write their output
_WRITE_ONLY = {_aten.zeros, _aten.zeros_like, _aten.ones, _aten.ones_like,
               _aten.full, _aten.full_like, _aten.new_zeros, _aten.new_ones,
               _aten.new_full, _aten.fill_, _aten.zero_, _aten.arange,
               _aten.randn, _aten.randn_like, _aten.rand, _aten.rand_like,
               _aten.randint, _aten.normal_, _aten.uniform_, _aten.eye,
               _aten.scalar_tensor}
# (table operand, index arguments) of the gathers
_GATHERS = {_aten.index_select: (0, (2,)), _aten.embedding: (0, (1,)),
            _aten.gather: (0, (2,)), _aten.index: (0, (1,)),
            _aten.take: (0, (1,))}
# (index arguments, updates argument, in place) of the scatters
_SCATTERS = {_aten.index_add_: ((2,), 3, True), _aten.index_add: ((2,), 3, False),
             _aten.index_copy_: ((2,), 3, True),
             _aten.index_copy: ((2,), 3, False),
             _aten.index_put_: ((1,), 2, True), _aten.index_put: ((1,), 2, False),
             _aten._index_put_impl_: ((1,), 2, True),
             _aten.scatter_add_: ((2,), 3, True),
             _aten.scatter_add: ((2,), 3, False),
             _aten.scatter_: ((2,), 3, True), _aten.scatter: ((2,), 3, False),
             _aten.scatter_reduce_: ((2,), 3, True),
             _aten.scatter_reduce: ((2,), 3, False)}


def _meta_bincount(x, weights=None, minlength=0):
    """``bincount`` on meta: ``minlength`` bins (the only use, MoE expert
    loads, counts ids below it), where the data would decide."""
    dtype = torch.int64 if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dtype, device=x.device)


# the data-dependent output shapes a meta step needs, decided from shapes
_META_SHAPES = {_aten.bincount: _meta_bincount}


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of the distinct elements a tensor reads: a broadcast
    (stride-0) dim reads one element."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else min(size, 1)
    return n * t.element_size()


def _tensors(tree, out: list | None = None) -> list:
    """The tensors of an op's arguments or outputs, in order."""
    out = [] if out is None else out
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


def _arg(args, kwargs, i):
    return args[i] if i < len(args) else None


def _mm_dtype(t: torch.Tensor) -> str:
    name = str(t.dtype).removeprefix("torch.")
    if name == "float32" and torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return name


class CostCounter(TorchDispatchMode):
    """Counts a step's FLOPs by dtype, bytes, collective bytes by kind and
    peak of live bytes, op by op, while it runs (see the module doc).
    Run the step on ``meta`` tensors: nothing is computed, and a kernel
    wrapper reports its own cost. ``summary()`` gives the totals.

        with CostCounter() as c:
            step(state, batch)
        c.flops, c.bytes, c.collectives, c.peak_bytes
    """

    def __init__(self):
        super().__init__()
        self.flops: dict[str, float] = {}
        self.bytes = 0.0
        self.collectives: dict[str, float] = {}
        self.kernels: dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._held: dict[int, int] = {}

    # -- what the kernels and the collectives report --
    def charge(self, kernel: str, nbytes: float, ops: float,
               dtype: str = "float32") -> None:
        self.kernels[kernel] = self.kernels.get(kernel, 0) + 1
        self.bytes += nbytes
        self.flops[dtype] = self.flops.get(dtype, 0.0) + ops

    def charge_collective(self, kind: str, nbytes: float) -> None:
        if kind not in COLLECTIVE_OPS:
            raise ValueError(f"collective kind {kind!r} (one of "
                             f"{COLLECTIVE_OPS})")
        self.collectives[kind] = self.collectives.get(kind, 0.0) + nbytes

    @property
    def collective_bytes(self) -> float:
        return sum(self.collectives.values())

    def summary(self) -> dict:
        return {"flops": dict(self.flops), "bytes": self.bytes,
                "collectives": dict(self.collectives),
                "collective_bytes": self.collective_bytes,
                "peak_bytes": self.peak_bytes, "kernels": dict(self.kernels)}

    # -- the ops --
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func.overloadpacket
        ins = _tensors((args, kwargs))
        meta_rule = _META_SHAPES.get(packet)
        if meta_rule is not None and ins and ins[0].device.type == "meta":
            out = meta_rule(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = _tensors(out)
        if packet in flop_registry:
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            dt = _mm_dtype(ins[0])
            self.flops[dt] = self.flops.get(dt, 0.0) + n
        if not func.is_view and packet not in _FREE:
            self.bytes += self._op_bytes(packet, args, ins, outs)
        self._allocate(ins, outs)
        return out

    def _op_bytes(self, packet, args, ins, outs) -> float:
        out_b = sum(o.numel() * o.element_size() for o in outs)
        if packet in _WRITE_ONLY:
            return out_b
        if packet is _aten.copy_:
            return _distinct_bytes(args[1]) + out_b
        if packet in _GATHERS:
            _, idx_at = _GATHERS[packet]
            idx = _tensors([_arg(args, {}, i) for i in idx_at])
            return sum(_distinct_bytes(i) for i in idx) + 2 * out_b
        if packet in _SCATTERS:
            idx_at, upd_at, in_place = _SCATTERS[packet]
            idx = _tensors([_arg(args, {}, i) for i in idx_at])
            upd = _arg(args, {}, upd_at)
            idx_b = sum(_distinct_bytes(i) for i in idx)
            itemsize = args[0].element_size()
            if isinstance(upd, torch.Tensor):
                upd_b = _distinct_bytes(upd)
                touched = upd.numel() * itemsize
            else:           # a scalar value: as many elements as indices
                upd_b = 0
                touched = max((i.numel() for i in idx), default=0) * itemsize
            copy = 0 if in_place else 2 * args[0].numel() * itemsize
            return idx_b + upd_b + 2 * touched + copy
        return sum(_distinct_bytes(t) for t in ins) + out_b

    def _allocate(self, ins, outs) -> None:
        seen = {id(t.untyped_storage()) for t in ins}
        for o in outs:
            st = o.untyped_storage()
            key = id(st)
            if key in seen or key in self._held:
                continue
            seen.add(key)
            n = st.nbytes()
            self._held[key] = n
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live_bytes -= self._held.pop(key, 0)


def _counters() -> list[CostCounter]:
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, CostCounter)]


def charge(kernel: str, nbytes: float, ops: float,
           dtype: str = "float32") -> None:
    """A hand-written kernel's bytes and operations for one call, added to
    every ``CostCounter`` in force (none: nothing to add). Its wrapper
    calls this on ``meta`` tensors in place of the launch."""
    for c in _counters():
        c.charge(kernel, nbytes, ops, dtype)


def charge_collective(kind: str, nbytes: float) -> None:
    """One collective's operand bytes (a kind of ``COLLECTIVE_OPS``), added
    to every ``CostCounter`` in force."""
    for c in _counters():
        c.charge_collective(kind, nbytes)


def _link_bw(hw) -> float:
    return hw.nvlink_bw if hasattr(hw, "nvlink_bw") else hw.ici_bw


def _peak(hw, dtype: str) -> float:
    return hw.peak(dtype) if hasattr(hw, "peak") else hw.peak_flops


def roofline_terms(flops, bytes_accessed: float, collective_bytes: float,
                   hw=H100) -> dict:
    """The reference's terms and keys. ``flops`` is a count, over
    ``hw.peak_flops``, or a ``{dtype: count}`` (``CostCounter.flops``),
    each over that dtype's peak on a profile with per-dtype peaks (the
    H100), over ``peak_flops`` on one without (the TPUv5e). The collective
    term is over the NVLink rate (the TPU's ICI link rate)."""
    if isinstance(flops, dict):
        compute = sum(n / _peak(hw, dt) for dt, n in flops.items())
    else:
        compute = flops / hw.peak_flops
    memory = bytes_accessed / hw.hbm_bw
    collective = collective_bytes / _link_bw(hw)
    terms = {"compute_s": compute, "memory_s": memory,
             "collective_s": collective}
    dom = max(terms, key=terms.get)
    terms["dominant"] = dom
    terms["bound_s"] = max(compute, memory, collective)
    return terms


def cost_terms(summary: dict, hw=H100) -> dict:
    """``roofline_terms`` of a ``CostCounter.summary()``."""
    return roofline_terms(summary["flops"], summary["bytes"],
                          summary["collective_bytes"], hw)


def model_flops(arch_id: str, shape_id: str) -> float:
    """Global textbook FLOPs for one step of the cell."""
    from repro_torch.configs import get_arch
    from repro_torch.configs import shapes as SH
    spec = get_arch(arch_id)
    cell = SH.get_cell(arch_id, shape_id)
    d = cell.dims
    fam = spec.family
    cfg = spec.config

    if fam == "lm":
        B, S = d["batch"], d["seq"]
        N = cfg.active_param_count()
        if cell.step_kind == "train":
            # 6·N·D + attention quadratic term (12·L·d_attn·S² per seq ×3)
            attn = 3 * cfg.n_layers * 4 * B * S * S * cfg.qkv_dim
            return 6.0 * N * (B * S) + attn
        if cell.step_kind == "prefill":
            attn = cfg.n_layers * 4 * B * S * S * cfg.qkv_dim * 0.5
            return 2.0 * N * (B * S) + attn
        # decode: one token per sequence + KV attention
        attn = cfg.n_layers * 4 * B * S * cfg.qkv_dim
        return 2.0 * N * B + attn

    if fam in ("dlrm", "din", "bert4rec", "xdeepfm"):
        B = d.get("n_candidates", d["batch"]) \
            if cell.step_kind == "retrieval" else d["batch"]
        dense = _recsys_dense_params(spec)
        mult = 6.0 if cell.step_kind == "train" else 2.0
        return mult * dense * B

    if fam == "gat":
        return _gat_flops(spec, cell)
    raise ValueError(fam)


def _recsys_dense_params(spec) -> float:
    cfg = spec.config
    total = cfg.param_count()
    if spec.family in ("dlrm", "xdeepfm", "din"):
        emb = cfg.total_vocab * cfg.embed_dim
        if spec.family == "xdeepfm":
            emb = cfg.total_vocab * (cfg.embed_dim + 1)
        return max(total - emb, 1)
    # bert4rec: per-sequence transformer cost + the MLM head. The head's
    # useful work depends on the loss: full-catalog softmax scores S x V,
    # sampled softmax scores max_masked x (1 + n_negatives).
    emb = cfg.vocab * cfg.embed_dim
    per_tok = max(cfg.param_count() - emb - cfg.seq_len * cfg.embed_dim, 1)
    body = per_tok * cfg.seq_len
    if getattr(cfg, "loss", "full") == "sampled":
        head = cfg.max_masked * (1 + cfg.n_negatives) * cfg.embed_dim
    else:
        head = cfg.seq_len * cfg.vocab * cfg.embed_dim
    return body + head


def _gat_flops(spec, cell) -> float:
    """Two layers' projections (2·n·in·out) and edge work (8 a head-out
    element an edge: scores, softmax, message, sum), x3 for the
    backward; the sampled cell at its padded block sizes."""
    d = cell.dims
    cfg = spec.config
    H, O = cfg.n_heads, cfg.d_hidden
    if cell.shape_id == "minibatch_lg":
        from repro_torch.configs.shapes import sampled_block_dims
        bd = sampled_block_dims(d["batch_nodes"], d["fanout0"], d["fanout1"])
        n, e = bd["n0"], bd["e0"] + bd["e1"]
        feat = d["d_feat"]
    elif cell.shape_id == "molecule":
        n = d["n_graphs"] * d["nodes_per"]
        e = d["n_graphs"] * d["edges_per"]
        feat = d["d_feat"]
    else:
        n, e, feat = d["n_nodes"], d["n_edges"], d["d_feat"]
    l1 = 2 * n * feat * H * O + 8 * e * H * O
    l2 = 2 * n * H * O * d["n_classes"] + 8 * e * d["n_classes"]
    return 3.0 * (l1 + l2)   # fwd+bwd
