"""DLRM-DCNv2 in the port (``models/dlrm.py``, ``interaction="dcn"``) on
the CPU at small sizes: its forward against the plain reference
``tests/torch_ref_dlrm_dcn.py`` with fp32 and bf16 tables on uneven
per-field bag sizes; a planted fault that the comparison catches; the CSR
bag sums' fp32-output form; the dot path's one-hot and rectangular bags
unchanged bit for bit; the DCN path's stage spans on CPU and meta
tensors."""
import numpy as np
import pytest
import torch

import torch_ref_dlrm_dcn as REF
from repro_torch.configs import get_arch
from repro_torch.core.embedding import csr_embedding_bag, csr_layout
from repro_torch.core.partitioning import (non_uniform_partition,
                                           uniform_partition)
from repro_torch.kernels import embedding_bag as K
from repro_torch.launch.roofline import CostCounter
from repro_torch.models import dlrm as TD
from repro_torch.models.common import banked
from repro_torch.obs import tracing as T
from repro_torch.serve.serve_step import build_recsys_serve

# uneven sizes, 1 among them; one field longer than a warp's 32 entries
SIZES = (3, 1, 7, 1, 40, 2)
VOCAB = (50, 3, 400, 9, 700, 64)
# the port and the reference differ only in the order of fp32 sums (the
# bags in stream order against torch's sum, addmm and addcmul against a
# product, an add and a multiply-add): a few ulps of logits near 1
TOL = dict(rtol=2e-6, atol=2e-6)


def _cfg(emb_dtype=torch.float32, **kw):
    return TD.DLRMConfig(
        name="dcn-small", vocab_sizes=VOCAB, embed_dim=16, n_dense=13,
        bot_mlp=(32, 16), top_mlp=(64, 32), multi_hot=SIZES,
        interaction="dcn", cross_layers=3, cross_rank=8,
        emb_dtype=emb_dtype, **kw)


def _model(cfg, plan="non_uniform", seed=0):
    """Params and statics on 4 banks, with nonzero biases and a table big
    enough to read: the reference's weights are the same tensors, the
    table unpacked to its logical rows."""
    V = cfg.total_vocab
    p = (non_uniform_partition(np.random.default_rng(1).random(V) + 0.05, 4)
         if plan == "non_uniform" else uniform_partition(V, 4))
    g = torch.Generator().manual_seed(seed)
    params, statics = TD.init_params(cfg, g, plan=p, device="cpu")
    params["emb_packed"] = (torch.randn(params["emb_packed"].shape,
                                        generator=g) * 0.3
                            ).to(cfg.emb_dtype)
    for m in ("bot", "top", "cross"):
        params[m]["b"] = [torch.randn(b.shape, generator=g) * 0.05
                          for b in params[m]["b"]]
    w = {"table": params["emb_packed"][statics["remap_flat"].long()],
         **{m: params[m] for m in ("bot", "top", "cross")}}
    return params, statics, w


def _batch(cfg, b=24, seed=2, holes=True):
    g = torch.Generator().manual_seed(seed)
    sparse = torch.cat([torch.randint(0, v, (b, n), generator=g)
                        for v, n in zip(cfg.vocab_sizes, cfg.multi_hot)],
                       1).to(torch.int32)
    if holes:
        sparse[0, :5] = -1
        sparse[3, 11:20] = -1
    return {"dense": torch.randn((b, cfg.n_dense), generator=g),
            "sparse": sparse}


def _ref(cfg, w, batch, **kw):
    return REF.forward(w, batch["dense"], batch["sparse"], cfg.multi_hot,
                       cfg.vocab_sizes, **kw)


@pytest.mark.parametrize("plan", ["non_uniform", "uniform"])
@pytest.mark.parametrize("emb_dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_forward_matches_the_reference(emb_dtype, plan):
    cfg = _cfg(emb_dtype)
    params, statics, w = _model(cfg, plan)
    batch = _batch(cfg)
    got = TD.forward(cfg, params, statics, batch)
    want = _ref(cfg, w, batch)
    assert got.dtype == torch.float32 and got.shape == (24,)
    assert float(want.std()) > 0.05            # logits not all alike
    torch.testing.assert_close(got, want, **TOL)
    # served: the sigmoid of the same logits, twice (the layout kept)
    serve = build_recsys_serve(TD, cfg, statics)
    for _ in range(2):
        torch.testing.assert_close(serve(params, batch), torch.sigmoid(want),
                                   **TOL)
    assert list(statics["bag_layouts"]) == [24]


@pytest.mark.parametrize("fault", ["a_cross_layer_left_out",
                                   "a_bag_entry_left_out"])
def test_a_planted_fault_fails_the_comparison(fault):
    cfg = _cfg(torch.bfloat16)
    params, statics, w = _model(cfg)
    batch = _batch(cfg, holes=False)
    got = TD.forward(cfg, params, statics, batch)
    if fault == "a_cross_layer_left_out":
        bad = _ref(cfg, w, batch, cross_layers=2)
    else:
        cut = dict(batch, sparse=batch["sparse"].clone())
        cut["sparse"][:, 4] = -1              # field 2's first id
        bad = _ref(cfg, w, cut)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(got, bad, **TOL)


def _csr_case(dtype, seed=3):
    g = torch.Generator().manual_seed(seed)
    table = (torch.randn((300, 40), generator=g) * 0.5).to(dtype)
    lens = torch.tensor([3, 1, 0, 45, 7, 1, 2, 33])
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         lens.cumsum(0)[:-1]]).to(torch.int32)
    idx = torch.randint(0, 300, (int(lens.sum()),), generator=g,
                        dtype=torch.int32)
    idx[::9] = -1                                  # holes
    ident = torch.arange(300, dtype=torch.int32)
    return table, ident, idx, offsets, lens


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_csr_bag_plain_fp32_output(dtype):
    table, ident, idx, offsets, lens = _csr_case(dtype)
    ext = torch.cat([offsets, torch.tensor([idx.shape[0]],
                                           dtype=torch.int32)])
    got = K.csr_bag_plain(table, ident, ident, -1, idx, ext,
                          out_dtype=torch.float32)
    assert got.dtype == torch.float32
    # the fp32 sum of each bag in stream order, bit for bit
    want = torch.zeros((8, 40), dtype=torch.float32)
    for b in range(8):
        for e in range(int(offsets[b]), int(offsets[b] + lens[b])):
            if idx[e] >= 0:
                want[b] += table[idx[e]].float()
    assert torch.equal(got, want)
    # the table's-dtype form is the same sums cast once, as ever
    same = K.csr_bag_plain(table, ident, ident, -1, idx, ext)
    assert same.dtype == dtype and torch.equal(same, want.to(dtype))
    assert torch.equal(K.csr_bag(table, ident, ident, -1, idx, ext,
                                 out_dtype=torch.float32), got)
    with pytest.raises(ValueError, match="out_dtype"):
        K.csr_bag_plain(table, ident, ident, -1, idx, ext,
                        out_dtype=torch.float16)


def test_csr_fp32_output_backward_keeps_the_table_dtype():
    table, ident, idx, offsets, lens = _csr_case(torch.bfloat16)
    from repro_torch.core.embedding import BankedTable
    t = BankedTable(packed=table.clone().requires_grad_(True),
                    remap_bank=torch.zeros(300, dtype=torch.int32),
                    remap_slot=ident, n_banks=1, rows_per_bank=300,
                    remap_flat=ident)
    layout = csr_layout(offsets, idx.shape[0])
    out = csr_embedding_bag(t, idx, offsets, 8, out_dtype=torch.float32,
                            layout=layout)
    assert out.dtype == torch.float32
    ct = torch.randn(out.shape, generator=torch.Generator().manual_seed(4))
    out.backward(ct)
    g = t.packed.grad
    assert g.dtype == torch.bfloat16 and g.shape == table.shape
    ref = torch.zeros((300, 40), dtype=torch.float32)
    seg = layout[0]
    for e in range(idx.shape[0]):
        if idx[e] >= 0:
            ref[idx[e]] += ct[seg[e]]
    torch.testing.assert_close(g.float(), ref.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


def _dot_forward_as_composed(cfg, params, statics, batch):
    """The dot path by hand, from the lookups, MLP and interaction that
    ``forward`` composes: the lookup cast to the dense dtype, the bottom
    MLP (no last ReLU), the fused interaction, the top MLP."""
    from repro_torch.core.embedding import banked_embedding_bag, banked_gather
    t = banked(params, statics)
    sparse = batch["sparse"]
    if sparse.dim() == 2:
        rows = sparse + statics["field_offsets"][None, :]
        emb = banked_gather(t, torch.where(sparse >= 0, rows, -1))
    else:
        emb = banked_embedding_bag(t, sparse,
                                   field_offsets=statics["field_offsets"])
    x = TD.mlp_apply(params["bot"], batch["dense"].to(cfg.dtype))
    feat = TD.interaction_features(x, emb.to(cfg.dtype), "auto")
    return TD.mlp_apply(params["top"], feat)[:, 0]


@pytest.mark.parametrize("arch", ["updlrm-paper", "dlrm-rm2"])
def test_the_dot_path_is_unchanged(arch):
    cfg = get_arch(arch).reduced
    assert cfg.interaction == "dot"
    plan = uniform_partition(cfg.total_vocab, 4)
    params, statics = TD.init_params(cfg, torch.Generator().manual_seed(5),
                                     plan=plan, device="cpu")
    assert "entry_offsets" not in statics and "bag_layouts" not in statics
    assert "cross" not in params
    assert params["top"]["w"][0].shape[0] == \
        cfg.n_sparse * (cfg.n_sparse + 1) // 2 + cfg.embed_dim
    g = torch.Generator().manual_seed(6)
    B = 16
    shape = (B, cfg.n_sparse) + ((cfg.multi_hot,) if cfg.multi_hot > 1
                                 else ())
    hi = torch.tensor(cfg.vocab_sizes).view(1, -1, *([1] * (len(shape) - 2)))
    sparse = (torch.rand(shape, generator=g) * hi).to(torch.int32)
    sparse[0, 0] = -1
    batch = {"dense": torch.randn((B, cfg.n_dense), generator=g),
             "sparse": sparse}
    got = TD.forward(cfg, params, statics, batch)
    assert torch.equal(got, _dot_forward_as_composed(cfg, params, statics,
                                                     batch))
    spec = get_arch(arch).config
    dims = [spec.n_dense, *spec.bot_mlp]
    dense = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    dims = [spec.n_sparse * (spec.n_sparse + 1) // 2 + spec.embed_dim,
            *spec.top_mlp, 1]
    dense += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
    assert spec.param_count() == spec.total_vocab * spec.embed_dim + dense


def test_config_checks_and_the_published_count():
    with pytest.raises(ValueError, match="dcn"):
        TD.DLRMConfig(name="x", vocab_sizes=(5, 6), embed_dim=4, n_dense=3,
                      bot_mlp=(4,), top_mlp=(4,), multi_hot=4,
                      interaction="dcn", cross_layers=1, cross_rank=2)
    with pytest.raises(ValueError, match="interaction"):
        TD.DLRMConfig(name="x", vocab_sizes=(5,), embed_dim=4, n_dense=3,
                      bot_mlp=(4,), top_mlp=(4,), interaction="cat")
    # the dot path takes neither per-field sizes nor cross layers
    for kw in (dict(multi_hot=(2, 3)), dict(cross_layers=1),
               dict(cross_rank=2)):
        with pytest.raises(ValueError, match="'dot'"):
            TD.DLRMConfig(name="x", vocab_sizes=(5, 6), embed_dim=4,
                          n_dense=3, bot_mlp=(4,), top_mlp=(4,), **kw)
    cfg = _cfg()
    with pytest.raises(ValueError, match="sparse"):
        params, statics, _ = _model(cfg)
        b = _batch(cfg)
        TD.forward(cfg, params, statics, dict(b, sparse=b["sparse"][:, 1:]))
    # MLPerf's DLRM-DCNv2: 16,044,545 dense parameters
    mlperf = TD.DLRMConfig(
        name="dlrm-dcnv2", vocab_sizes=(1,) * 26, embed_dim=128, n_dense=13,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256),
        multi_hot=(3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1,
                   12, 100, 27, 10, 3, 1, 1),
        interaction="dcn", cross_layers=3, cross_rank=512)
    assert sum(mlperf.multi_hot) == 214 and mlperf.cross_width == 3456
    assert mlperf.param_count() - 26 * 128 == 16_044_545


@pytest.fixture
def installed():
    tr = T.Tracer()
    before = T.install(tr)
    try:
        yield tr
    finally:
        T.install(before)


DCN_STAGES = ["dlrm.lookup", "dlrm.bot_mlp", "dlrm.cross", "dlrm.top_mlp"]


def test_stage_spans_on_cpu(installed):
    cfg = _cfg(torch.bfloat16)
    params, statics, _ = _model(cfg)
    build_recsys_serve(TD, cfg, statics)(params, _batch(cfg))
    tr = installed
    (step,) = tr.spans("serve.step")
    kids = sorted(tr.children(step), key=lambda r: r.ts_us)
    assert [r.name for r in kids] == DCN_STAGES
    assert not tr.spans("dlrm.interaction")


def test_stage_spans_and_cost_on_meta(installed):
    cfg = _cfg(torch.bfloat16)
    params, statics, _ = _model(cfg)
    def meta(t):
        return t.to("meta") if isinstance(t, torch.Tensor) else t
    params = {k: (meta(v) if isinstance(v, torch.Tensor) else
                  {n: [meta(t) for t in ts] for n, ts in v.items()})
              for k, v in params.items()}
    statics = {k: meta(v) for k, v in statics.items()}
    statics["bag_layouts"] = {}
    b = _batch(cfg, b=8)
    with CostCounter() as c:
        out = TD.forward(cfg, params, statics, {k: meta(v)
                                                for k, v in b.items()})
    assert out.device.type == "meta" and out.shape == (8,)
    assert c.kernels == {"csr_bag": 1}
    names = [r.name for r in installed.records
             if not r.name.startswith("setup.")]
    assert names == DCN_STAGES
    # the fp32 output's bytes: 8 * 6 bags of 16 fp32 values
    T_ids, NB, D = 8 * sum(SIZES), 8 * len(SIZES), 16
    from repro_torch.kernels import cost
    want = cost.meta_csr_bag_cost(T_ids, NB, D, 2,
                                  n_remap=cfg.total_vocab,
                                  n_table_rows=params["emb_packed"].shape[0],
                                  out_itemsize=4)
    assert want[0] - cost.meta_csr_bag_cost(
        T_ids, NB, D, 2, n_remap=cfg.total_vocab,
        n_table_rows=params["emb_packed"].shape[0])[0] == NB * D * 2
