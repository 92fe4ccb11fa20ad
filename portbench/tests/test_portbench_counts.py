"""The yardstick's frozen counts agree with the program's dry pass
(``launch/roofline.model_flops``, ``kernels/cost.py``, ``core/hwmodel``)
on the cells' shapes, and the batch counts with a count by hand."""
import numpy as np
import pytest
import torch

from portbench import drive
from portbench.counts import dlrm as C
from portbench.run import cell_parts
from portbench.tests.small import small_parts

# (cell, the registry's arch, the dry pass's shape at the cell's batch)
CELLS = [("paper-bulk", "updlrm-paper", "serve_bulk"),
         ("rm2-bulk", "dlrm-rm2", "serve_bulk"),
         ("paper-train", "updlrm-paper", "train_batch")]


@pytest.mark.parametrize("cell,arch,shape", CELLS)
def test_model_flops_match_the_dry_pass(cell, arch, shape):
    from repro_torch.configs import shapes as SH
    from repro_torch.launch.roofline import model_flops
    p = cell_parts(cell)
    assert SH.get_cell(arch, shape).dims["batch"] == p.mix["batch"]
    got = C.model_flops(p.cfg, p.mix["batch"], train=shape == "train_batch")
    assert got == pytest.approx(model_flops(arch, shape), rel=1e-12)


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_configs_match_the_registry(arch):
    from repro_torch.configs import get_arch
    spec = get_arch(arch)
    cfg = cell_parts({"updlrm-paper": "paper-bulk",
                      "dlrm-rm2": "rm2-bulk"}[arch]).cfg
    full = spec.config
    assert tuple(cfg["vocab_sizes"]) == full.vocab_sizes
    assert cfg["embed_dim"] == full.embed_dim
    assert tuple(cfg["bot_mlp"]) == full.bot_mlp
    assert tuple(cfg["top_mlp"]) == full.top_mlp
    assert cfg["multi_hot"] == full.multi_hot
    assert getattr(torch, cfg["emb_dtype"]) == full.emb_dtype
    assert C.dense_params(cfg) == full.param_count() - (
        full.total_vocab * full.embed_dim)
    red = small_parts("paper-bulk" if arch == "updlrm-paper"
                      else "rm2-bulk").cfg
    assert tuple(red["vocab_sizes"]) == spec.reduced.vocab_sizes
    assert tuple(red["bot_mlp"]) == spec.reduced.bot_mlp
    assert tuple(red["top_mlp"]) == spec.reduced.top_mlp
    assert red["multi_hot"] == spec.reduced.multi_hot


@pytest.mark.parametrize("cell", ["paper-bulk", "rm2-bulk", "paper-train"])
def test_kernel_counts_match_the_program_cost(cell):
    from repro_torch.kernels import cost
    p = cell_parts(cell)
    cfg, B = p.cfg, p.mix["batch"]
    F, D, L = len(cfg["vocab_sizes"]), cfg["embed_dim"], cfg["multi_hot"]
    V = sum(cfg["vocab_sizes"])
    assert C.dot_bytes_ops(cfg, B) == cost.dot_features_cost(B, F + 1, D, 4)
    if L == 1:
        return
    n_valid, n_rows = B * F * 240, 1_234_567
    assert C.bag_bytes_ops(cfg, B, n_valid=n_valid, n_rows=n_rows) == \
        cost.bag_cost(B * F, L, D, 4, n_valid=n_valid, n_entries=n_rows,
                      n_rows=n_rows, n_fields=F)
    assert C.scatter_bytes_ops(cfg, B, n_valid=n_valid, n_rows=n_rows) == \
        cost.scatter_cost(B * F, D, 4, 4, n_live=n_valid, n_run=n_rows)
    # the dry pass's data-free counts: every entry live, rows all distinct
    e = B * F * L
    assert C.bag_bytes_ops(cfg, B, n_valid=e, n_rows=min(e, V)) == \
        cost.meta_bag_cost(B * F, L, D, 4, n_remap=V, n_table_rows=V,
                           n_fields=F)
    assert C.scatter_bytes_ops(cfg, B, n_valid=e, n_rows=min(e, V)) == \
        cost.meta_scatter_cost(B * F, D, 4, 4, n_entries=e, n_out_rows=V)


def test_peaks_match_the_program_profile():
    from repro_torch.core.hwmodel import H100
    assert C.PEAKS["fp32_flops"] == H100.peak("float32")
    assert C.PEAKS["tf32_flops"] == H100.peak("tf32")
    assert C.PEAKS["bf16_flops"] == H100.peak("bfloat16")
    assert C.PEAKS["hbm_bytes_per_s"] == H100.hbm_bw


@pytest.mark.parametrize("cell", ["paper-bulk", "rm2-bulk"])
def test_batch_counts(cell):
    p = small_parts(cell)
    gen = drive.load("generators", p.mix["generator"])
    b = gen.Traffic(p.cfg, p.mix, "cpu").batch(7, 0, 64)
    sp = b["sparse"].numpy()
    sp = sp if sp.ndim == 3 else sp[..., None]
    offs = np.concatenate([[0], np.cumsum(p.cfg["vocab_sizes"])[:-1]])
    rows = {int(x) + int(offs[f]) for f in range(sp.shape[1])
            for x in sp[:, f].ravel() if x >= 0}
    assert C.batch_counts(p.cfg, b["sparse"]) == {
        "n_valid": int((sp >= 0).sum()), "n_rows": len(rows)}
