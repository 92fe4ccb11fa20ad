"""The port's per-cell cost accounting (``configs/shapes.batch_struct``,
``core/hwmodel.H100``, ``launch/roofline``'s ``roofline_terms`` and
``CostCounter``, the kernels' ``meta`` costs, ``launch/mesh``,
``launch/cells``, ``launch/dryrun``, ``launch/extrapolate``) against the
JAX package's, on the CPU:

  * ``batch_struct`` equals the reference's, shape and dtype, for all 44
    (arch x shape) cells, and ``build_cell``'s argument trees on one card
    equal the reference's ``build_cell(arch, shape, make_host_mesh((1,
    1)))`` at full dims (parameters by path, optimizer state, statics,
    KV caches, batches);
  * ``roofline_terms`` under ``TPUV5E`` equals the reference's; under the
    H100 the compute term sums each dtype's FLOPs over its own peak;
  * the counter's FLOPs and bytes match hand counts for ``mm``, ``bmm``,
    ``einsum``, ``index_select`` (the gather correction) and
    ``index_add_`` (the scatter correction), and its peak of live bytes a
    hand trace; each kernel wrapper's ``meta`` cost matches PERF.md §6's
    bound formula with every entry live and distinct up to the table;
  * extrapolation from 1 and 2 layers equals the direct count at 4;
  * the collective bytes the shape-only ``DryDistCtx`` counts on a 2 x 2
    grid equal what the real ``DistCtx`` moves on four gloo CPU ranks,
    for one reduced train cell (``tests/torch_dryrun_ranks.py``);
  * every cell's dry record on one card, its useful-FLOPs ratio reported,
    and every ratio above 1 named here with its reason;
  * the dry CLI runs a cell in a subprocess.

The reference's ``launch/dryrun`` and ``launch/extrapolate`` set
``XLA_FLAGS`` when imported, so neither is imported here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hwmodel as JH
from repro.configs import shapes as JSH
from repro.launch import roofline as JR
from repro.launch.cells import build_cell as jax_build_cell
from repro.launch.mesh import make_host_mesh
from repro_torch.configs import ARCHS
from repro_torch.configs import shapes as TSH
from repro_torch.core import hwmodel as TH
from repro_torch.dist.launch import run_ranks
from repro_torch.kernels import dot_interaction as TDOT
from repro_torch.kernels import embedding_bag as TK
from repro_torch.launch import cells as TC
from repro_torch.launch import dryrun as TDRY
from repro_torch.launch import extrapolate as TX
from repro_torch.launch import mesh as TM
from repro_torch.launch import roofline as TR
from repro_torch.train import optim as O
from repro_torch.train.train_step import TrainState

import torch_dryrun_ranks as RK

SRC = Path(__file__).resolve().parent.parent / "src"
CELLS = [(a, s) for a, spec in ARCHS.items() for s in spec.shapes]
IDS = [f"{a}-{s}" for a, s in CELLS]
META = torch.device("meta")

# cells whose useful-FLOPs ratio (model_flops over the counted FLOPs) is
# above 1, and why: model_flops counts work the step does not do as a
# matrix product. Besides these, an LM's ratio may exceed 1 by at most its
# norms' share of its parameters (NORMS).
ABOVE_ONE = {
    ("dlrm-rm2", "retrieval_cand"):
        "model_flops counts the bottom MLP once a candidate; the step runs "
        "it once for the one query",
    ("bert4rec", "retrieval_cand"):
        "model_flops counts the encoder once a candidate; the step encodes "
        "the one query once and scores the candidates with one product",
    ("gat-cora", "minibatch_lg"):
        "model_flops counts 8 elementwise FLOPs an edge, head and output "
        "(scores, softmax, message, sum), which the counter does not",
    ("gat-cora", "ogb_products"):
        "model_flops counts 8 elementwise FLOPs an edge, head and output "
        "(scores, softmax, message, sum), which the counter does not",
}
NORMS = ("model_flops counts 6 FLOPs a token (2 in inference) for every "
         "parameter of an LM, its norms' weights too, which multiply "
         "elementwise")


def _sig(x: torch.Tensor) -> tuple:
    return tuple(x.shape), str(x.dtype).removeprefix("torch.")


def _jsig(x) -> tuple:
    return tuple(x.shape), jnp.dtype(x.dtype).name


def _port_leaves(tree) -> list:
    return [(p, _sig(v)) for p, v in O.tree_flatten_with_path(tree)
            if isinstance(v, torch.Tensor)]


def _ref_leaves(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), _jsig(v)) for p, v in flat]


def _same_tree(got, want, what: str) -> None:
    assert _port_leaves(got) == _ref_leaves(want), what


def _same_part(got, want, what: str) -> None:
    """One argument of a cell: a TrainState, a KV cache, a batch or
    statics dict, a params tree or one array."""
    if isinstance(got, TrainState):
        _same_tree(got.params, want.params, what + ".params")
        _same_tree(got.opt_state, want.opt_state, what + ".opt_state")
        assert _sig(got.step) == _jsig(want.step), what
        assert got.err_state is None and want.err_state is None
    elif dataclasses.is_dataclass(got):                     # a KVCache
        for f in ("k", "v"):
            assert _sig(getattr(got, f)) == _jsig(getattr(want, f)), what
    elif isinstance(got, torch.Tensor):
        assert _sig(got) == _jsig(want), what
    elif isinstance(got, dict) and "remap_bank" in got:     # statics
        for k, v in want.items():
            if isinstance(got[k], torch.Tensor):
                assert _sig(got[k]) == _jsig(v), (what, k)
            else:    # the port's scalar statics are Python ints
                assert v.shape == () and isinstance(got[k], int), (what, k)
        # the port carries the flat remap, computed once, beside them
        assert _sig(got["remap_flat"]) == _jsig(want["remap_bank"])
    else:
        _same_tree(got, want, what)


# ---------------------------------------------------------------------------
# batch_struct and the cells' arguments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_batch_struct_matches_reference(arch, shape):
    tk, tb = TSH.batch_struct(arch, shape)
    jk, jb = JSH.batch_struct(arch, shape)
    assert tk == jk
    assert list(tb) == list(jb)
    for k in jb:
        assert tb[k].device == META, k
        assert _sig(tb[k]) == _jsig(jb[k]), k


@pytest.fixture(scope="module")
def host_mesh():
    return make_host_mesh((1, 1))


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_build_cell_args_match_reference(arch, shape, host_mesh):
    got = TC.build_cell(arch, shape, TM.make_production_grid())
    want = jax_build_cell(arch, shape, host_mesh)
    assert got.step_kind == want.step_kind
    assert len(got.args) == len(want.args)
    for i, (g, w) in enumerate(zip(got.args, want.args)):
        _same_part(g, w, f"{arch} {shape} arg {i}")
    for k in ("tokens", "batch", "kv_len"):
        assert got.meta.get(k) == want.meta.get(k), k
    leaves = [x for x in O.tree_leaves(got.args[-1])
              if isinstance(x, torch.Tensor)]
    assert leaves and all(x.device == META for x in leaves)


def test_grids_and_dp_axes():
    one, four = TM.make_production_grid(), \
        TM.make_production_grid(multi_card=True)
    assert (one.data, one.model, one.size) == (1, 1, 1)
    assert (four.data, four.model, four.size) == (2, 2, 4)
    assert TM.make_host_grid((1, 4))[:2] == (1, 4)
    assert TM.dp_axes_for(four) == ("dp",)
    assert TM.make_dist(one) is None
    d = TM.make_dist(four)
    assert (d.data, d.model, d.rank, d.bank_rank, d.dp_rank) == \
        (2, 2, 0, 0, 0)
    with pytest.raises(ValueError):
        TM.DryDistCtx.dry(four, rank=4)


# ---------------------------------------------------------------------------
# roofline_terms and the H100 profile
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("terms", [(1e15, 1e9, 1e6), (1e9, 1e12, 1e6),
                                   (1e9, 1e9, 1e12), (0.0, 0.0, 0.0),
                                   (3.3e14, 2.1e11, 7.0e9)])
def test_roofline_terms_match_reference_on_tpuv5e(terms):
    got = TR.roofline_terms(*terms, hw=TH.TPUV5E)
    want = JR.roofline_terms(*terms, hw=JH.TPUV5E)
    assert got == want
    assert list(got) == list(want)


def test_h100_terms_sum_each_dtype_over_its_peak():
    h = TH.H100
    assert (h.peak("bfloat16"), h.peak("float32"), h.peak("tf32"),
            h.peak("int8"), h.hbm_bw, h.hbm_bytes, h.nvlink_bw) == \
        (989e12, 67e12, 495e12, 1979e12, 3.35e12, 80 * 10**9, 450e9)
    with pytest.raises(KeyError):
        h.peak("float4")
    t = TR.roofline_terms({"float32": 67e12, "bfloat16": 989e12}, 6.7e12,
                          4.5e11)
    assert t["compute_s"] == pytest.approx(2.0)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(1.0)
    assert t["bound_s"] == max(t["compute_s"], t["memory_s"])
    # a bare count is over the bf16 peak; a dict on the TPU over its one
    assert TR.roofline_terms(989e12, 0.0, 0.0)["compute_s"] == 1.0
    assert TR.roofline_terms({"float32": 197e12}, 0.0, 0.0,
                             hw=TH.TPUV5E)["compute_s"] == 1.0


# ---------------------------------------------------------------------------
# the counter, op by op
# ---------------------------------------------------------------------------

def _rand(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device=META)


def _count(fn, *args):
    """(flops by dtype, bytes) of ``fn(*args)`` alone."""
    with TR.CostCounter() as c:
        fn(*args)
    return c.flops, c.bytes


def test_counter_mm_bmm_einsum():
    a, b = _rand(64, 32), _rand(32, 16)
    assert _count(torch.mm, a, b) == ({"float32": 2 * 64 * 32 * 16},
                                      (64 * 32 + 32 * 16 + 64 * 16) * 4)
    a, b = _rand(4, 8, 16), _rand(4, 16, 2)
    want = ({"float32": 2 * 4 * 8 * 16 * 2},
            (4 * 8 * 16 + 4 * 16 * 2 + 4 * 8 * 2) * 4)
    assert _count(torch.bmm, a, b) == want
    assert _count(lambda x, y: torch.einsum("bij,bjk->bik", x, y), a,
                  b) == want
    a, b = _rand(64, 32, dtype=torch.bfloat16), \
        _rand(32, 16, dtype=torch.bfloat16)
    assert _count(torch.matmul, a, b) == (
        {"bfloat16": 2 * 64 * 32 * 16}, (64 * 32 + 32 * 16 + 64 * 16) * 2)


def test_counter_fp32_products_are_tf32_only_where_allowed(monkeypatch):
    a, b = _rand(8, 8), _rand(8, 8)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    assert _count(torch.mm, a, b)[0] == {"tf32": 2 * 8 * 8 * 8}


def test_counter_gather_and_scatter_corrections():
    table, idx = _rand(1000, 8), _rand(10, dtype=torch.int64)
    rows = _rand(10, 8)
    # a gather reads the rows it touches: idx + 2 * out
    assert _count(lambda t, i: t.index_select(0, i), table, idx)[1] == \
        10 * 8 + 2 * 10 * 8 * 4
    assert _count(lambda t, i: t[i], table, idx)[1] == \
        10 * 8 + 2 * 10 * 8 * 4
    # a scatter reads its updates and reads and writes the rows it touches
    assert _count(lambda t, i, u: t.index_add_(0, i, u), table, idx,
                  rows)[1] == 10 * 8 + 3 * 10 * 8 * 4
    # out of place, it also copies the operand
    assert _count(lambda t, i, u: t.index_add(0, i, u), table, idx,
                  rows)[1] == 10 * 8 + 3 * 10 * 8 * 4 + 2 * 1000 * 8 * 4
    # neither counts FLOPs
    assert _count(lambda t, i: t.index_select(0, i), table, idx)[0] == {}


def test_counter_views_allocations_and_peak():
    with TR.CostCounter() as c:
        x = torch.randn(1000, device=META)     # writes 4,000
        y = x * 2                              # 4,000 + 4,000
        del x
        z = (y + 1).view(10, 100)              # 8,000; the view is free
        v = z.sum(0)                           # 4,000 + 400
        e = torch.empty(10 ** 6, device=META)  # allocates, moves nothing
        del e
    assert c.bytes == 4000 + 8000 + 8000 + 4400
    # x, y; then y, z, v; then the empty 4 MB on top of them
    assert c.peak_bytes == 8400 + 4 * 10 ** 6
    assert c.live_bytes == 8400


# ---------------------------------------------------------------------------
# each kernel's cost on meta tensors: PERF.md §6's bound formula with every
# entry live and distinct up to the rows it can touch
# ---------------------------------------------------------------------------

class _Charges(TR.CostCounter):
    def __init__(self):
        super().__init__()
        self.calls = []

    def charge(self, kernel, nbytes, ops, dtype="float32"):
        super().charge(kernel, nbytes, ops, dtype)
        self.calls.append((kernel, nbytes, ops, dtype))


def _charged(fn, *args, **kw):
    with _Charges() as c:
        out = fn(*args, **kw)
    return out, c.calls


def _i32(*shape):
    return _rand(*shape, dtype=torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("my,k_max", [(-1, 1), (3, 1), (-1, 2)])
def test_banked_bag_meta_cost(dtype, my, k_max):
    R, D, V, F, NB, L = 100, 8, 50, 2, 6, 4
    isz = torch.empty((), dtype=dtype).element_size()
    out, calls = _charged(TK.banked_bag, _rand(R, D, dtype=dtype),
                          _i32(V * k_max), _i32(V * k_max), _i32(F), my,
                          _i32(NB, L), k_max)
    assert _sig(out) == ((NB, D), str(dtype).removeprefix("torch."))
    entries = min(NB * L, V * k_max)
    rows = min(entries, R)
    nbytes = (NB * L * 4 + rows * D * isz + NB * D * isz
              + F * 4 + entries * (4 + 4 * (my >= 0)))
    name = "banked_bag" if k_max == 1 else "banked_bag_replicated"
    assert calls == [(name, nbytes, NB * L * D, "float32")]


def test_plain_and_cache_bag_meta_costs():
    V, C, D, B, L, Lc, Lr = 30, 5, 8, 4, 9, 2, 16
    out, calls = _charged(TK.plain_bag, _rand(V, D), _i32(B, L))
    assert out.shape == (B, D)
    assert calls == [("plain_bag", B * L * 4 + min(B * L, V) * D * 4
                      + B * D * 4, B * L * D, "float32")]
    rows = min(B * Lc, C) + min(B * Lr, V)
    out, calls = _charged(TK.cache_residual_bag, _rand(V, D), _rand(C, D),
                          _i32(V), _i32(V), _i32(C), _i32(C), -1,
                          _i32(B, Lc), _i32(B, Lr))
    assert out.shape == (B, D)
    assert calls == [("cache_residual_bag",
                      B * (Lc + Lr) * 4 + rows * (4 + D * 4) + B * D * 4,
                      B * (Lc + Lr) * D, "float32")]
    out, calls = _charged(TK.plain_cache_bag, _rand(V, D), _rand(C, D),
                          _i32(B, Lc), _i32(B, Lr))
    assert calls == [("plain_cache_bag",
                      B * (Lc + Lr) * 4 + rows * D * 4 + B * D * 4,
                      B * (Lc + Lr) * D, "float32")]


def test_csr_and_tiered_bag_meta_costs():
    R, V, D, T, NB = 40, 40, 8, 70, 5
    out, calls = _charged(TK.csr_bag, _rand(R, D), _i32(V), _i32(V), 2,
                          _i32(T), _i32(NB + 1))
    assert out.shape == (NB, D)
    entries = min(T, V)
    assert calls == [("csr_bag", T * 4 + (NB + 1) * 4 + entries * 8
                      + min(entries, R) * D * 4 + NB * D * 4, T * D,
                      "float32")]
    F, L = 2, 3
    out, calls = _charged(TK.tiered_bag, _rand(R, 2 * D, dtype=torch.int8),
                          _rand(R), _i32(R), _i32(V), _i32(V), _i32(F), -1,
                          _i32(NB, L), dim=D)
    assert _sig(out) == ((NB, D), "float32")
    rows = min(NB * L, V, R)
    assert calls == [("tiered_bag", NB * L * 4 + F * 4 + rows * 8 + rows * 4
                      + rows * 2 * D + NB * D * 4, 2 * NB * L * D,
                      "float32")]


def test_scatter_meta_cost():
    n_rows, V, D, NB, L, F = 20, 20, 8, 6, 4, 2
    ct = _rand(NB, D)
    out, calls = _charged(TK.ct_scatter_bag, ct, _i32(NB, L), _i32(V),
                          _i32(V), _i32(F), -1, n_rows, torch.bfloat16)
    assert _sig(out) == ((n_rows, D), "bfloat16")
    E = NB * L
    runs = min(E, n_rows)
    assert calls == [("ct_scatter_bag", E * 4 + (runs + 1) * 4 + runs * 4
                      + 4 + NB * D * 4 + runs * D * 2, E * D, "float32")]


def test_dot_meta_costs():
    B, F, D = 16, 9, 32
    P = F * (F - 1) // 2
    out, calls = _charged(TDOT.dot_interaction, _rand(B, F, D))
    assert out.shape == (B, P)
    assert calls == [("dot_interaction", (B * F * D + B * P) * 4,
                      2 * B * P * D, "float32")]
    out, calls = _charged(TDOT.dot_features, _rand(B, D),
                          _rand(B, F - 1, D))
    assert out.shape == (B, P + D)
    assert calls == [("dot_features", (B * F * D + B * (P + D)) * 4,
                      2 * B * P * D, "float32")]


def test_cpu_tensors_still_take_the_plain_versions():
    t = torch.randn(10, 4)
    idx = torch.tensor([[0, 3, -1], [9, 9, 2]], dtype=torch.int32)
    _, calls = _charged(TK.plain_bag, t, idx)
    assert calls == []
    assert torch.equal(TK.plain_bag(t, idx), TK.plain_bag_plain(t, idx))


# ---------------------------------------------------------------------------
# extrapolation
# ---------------------------------------------------------------------------

def _direct(arch, shape, grid, n_layers):
    from repro_torch.launch.cells import _lm_cell
    cell = _lm_cell(arch, shape, TM.make_dist(grid),
                    cfg_override=TX._cfg(arch, shape, n_layers))
    return TDRY.record(arch, shape, grid,
                       TDRY.count_cell(arch, shape, grid, cell=cell))


@pytest.mark.parametrize("shape,multi", [("prefill_32k", False),
                                         ("prefill_32k", True),
                                         ("decode_32k", True),
                                         ("train_4k", True)])
def test_extrapolation_equals_the_direct_count(shape, multi):
    arch = "smollm-135m"
    grid = TM.make_production_grid(multi_card=multi)
    got = TX.extrapolate_counts(arch, shape, grid, n_layers=4)
    want = _direct(arch, shape, grid, 4)
    assert got["flops_by_dtype"] == want["flops_by_dtype"]
    assert got["collectives"] == want["collectives"]
    assert got["memory"]["argument_bytes"] == want["memory"]["argument_bytes"]
    if shape == "train_4k":
        # the gradient of a stacked (L, ...) weight taken a layer at a time
        # writes a whole (L, ...) zero tensor a layer: bytes quadratic in L
        assert got["bytes_per_device"] == pytest.approx(
            want["bytes_per_device"], rel=1e-3)
        assert got["memory"]["peak_bytes"] == want["memory"]["peak_bytes"]
    else:
        assert got["bytes_per_device"] == want["bytes_per_device"]
    if shape == "prefill_32k":
        assert got["memory"]["peak_bytes"] == want["memory"]["peak_bytes"]
    if multi:
        assert got["collective_bytes_per_device"] > 0


# ---------------------------------------------------------------------------
# collective bytes: the shape-only context against gloo ranks
# ---------------------------------------------------------------------------

def test_dry_collectives_equal_gloo_ranks(tmp_path):
    cell = RK.reduced_cell(TM.DryDistCtx.dry(TM.make_host_grid(RK.GRID)))
    with TR.CostCounter() as c:
        cell.fn(*cell.args)
    outs = run_ranks(RK.collective_bytes, 4, tmp_path / "ranks")
    rank0 = outs[0]
    moved = {"all-reduce": float(rank0["all_reduce"][0]),
             "all-gather": float(rank0["all_gather"][0])}
    assert c.collectives == {k: v for k, v in moved.items() if v}
    assert rank0["all_reduce"][0] > 0
    for o in outs:              # every rank of the grid moves as much
        assert o["all_reduce"][0] == rank0["all_reduce"][0]
        assert np.isfinite(o["loss"]).all()


# ---------------------------------------------------------------------------
# every cell's dry record on one card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def one_card(tmp_path_factory):
    out = tmp_path_factory.mktemp("dry")
    return {(a, s): TDRY.run_cell(a, s, False, str(out)) for a, s in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS, ids=IDS)
def test_every_cell_has_a_record(arch, shape, one_card):
    rec = one_card[(arch, shape)]
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["n_devices"]) == \
        (arch, shape, "card_1x1", 1)
    if (arch, shape) == ("updlrm-paper", "retrieval_cand"):
        # the reference's retrieval is one-hot only, and so is the port's
        assert "one-hot fields only" in rec["refused"]
        return
    assert rec["collective_bytes_per_device"] == 0
    r = rec["roofline"]
    assert r["bound_s"] > 0 and r["bound_s"] == max(
        r["compute_s"], r["memory_s"], r["collective_s"])
    assert isinstance(rec["memory"]["fits_80gb"], bool)
    ratio = rec["useful_flops_ratio"]
    assert ratio is not None and ratio > 0
    family = ARCHS[arch].family
    if (arch, shape) in ABOVE_ONE:
        assert ratio > 1, (arch, shape, ratio)
    elif family == "lm" and ratio > 1:
        cfg = ARCHS[arch].config
        norms = (2 * cfg.n_layers + 1) * cfg.d_model
        assert ratio - 1 <= norms / cfg.active_param_count(), \
            (arch, shape, ratio, NORMS)
    else:
        assert ratio <= 1, (arch, shape, ratio)
    if arch == "updlrm-paper":
        want = {"banked_bag": 1, "dot_features": 1}
        if shape == "train_batch":
            want["ct_scatter_bag"] = 1
        assert rec["kernels"] == want
    elif family != "dlrm":
        assert rec["kernels"] == {}


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_dry_cli_runs_a_cell(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gat-cora", "--shape", "molecule", "--mesh", "both", "--out",
         str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("OK ") == 2 and "all cells passed" in r.stdout
    for grid in ("card_1x1", "cards_2x2"):
        rec = json.loads((tmp_path / f"{grid}__gat-cora__molecule.json")
                         .read_text())
        assert rec["roofline"]["bound_s"] > 0
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "gat-cora"], env=env, capture_output=True, text=True, timeout=300)
    assert bad.returncode != 0
