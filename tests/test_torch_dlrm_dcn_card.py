"""DLRM-DCNv2's lookup on the card: the CSR kernel's fp32-output instance
(``csrc/csr_bag.cu``, ``csr_bag_forward_f32``) against its plain version
bit for bit at a ``dcnv2-bulk``-like shape (MLPerf's 26 bag sizes, D =
128, a bf16 table), the table's-dtype instances unchanged beside it, and
one ``csr_bag`` launch a serve step, with no launch of the rectangular bag
kernel or the dot kernel.

Needs a CUDA card (skips without one). On the card, from the root of the
repo:

    PYTHONPATH=src python -m pytest -q tests/test_torch_dlrm_dcn_card.py
"""
import pytest
import torch

from repro_torch.core.partitioning import uniform_partition
from repro_torch.kernels import dot_interaction as DOT
from repro_torch.kernels import embedding_bag as K
from repro_torch.models import dlrm as TD
from repro_torch.serve.serve_step import build_recsys_serve

SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
         27, 10, 3, 1, 1)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _stream(dev, batch, rows, seed=0):
    """(indices, offsets_ext) of ``batch`` samples' 26 bags of MLPerf's
    sizes over ``rows`` table rows, a few holes among them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    width = sum(SIZES)
    idx = torch.randint(0, rows, (batch * width,), generator=g, device=dev,
                        dtype=torch.int32)
    idx[::97] = -1
    prefix = torch.tensor([0, *torch.tensor(SIZES).cumsum(0)[:-1].tolist()],
                          dtype=torch.int32, device=dev)
    starts = (torch.arange(batch, dtype=torch.int32, device=dev)[:, None]
              * width + prefix).reshape(-1)
    ext = torch.cat([starts, torch.tensor([batch * width], dtype=torch.int32,
                                          device=dev)])
    return idx, ext


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
def test_fp32_output_instance_matches_its_plain_version(dev, dtype):
    rows, D = 2_000_003, 128
    g = torch.Generator(device=dev).manual_seed(1)
    table = (torch.randn((rows, D), generator=g, device=dev) * 0.02
             ).to(dtype)
    ident = torch.arange(rows, dtype=torch.int32, device=dev)
    idx, ext = _stream(dev, 8192, rows)
    n0 = K.csr_bag.launches
    got = K.csr_bag(table, ident, ident, -1, idx, ext,
                    out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert K.csr_bag.launches == n0 + 1 and got.dtype == torch.float32
    want = K.csr_bag_plain(table, ident, ident, -1, idx, ext,
                           out_dtype=torch.float32)
    assert torch.equal(got, want)
    # the table's-dtype instance: its own bits, the same sums cast once
    same = K.csr_bag(table, ident, ident, -1, idx, ext)
    assert same.dtype == dtype
    assert torch.equal(same, K.csr_bag_plain(table, ident, ident, -1, idx,
                                             ext))
    assert torch.equal(same, want.to(dtype))


def test_one_csr_launch_a_serve_step(dev):
    vocab = (40_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
             40_000, 30_679, 40_528, 10, 2_209, 11_938, 155, 4, 976, 14,
             40_000, 40_000, 40_000, 59_015, 12_973, 108, 36)
    cfg = TD.DLRMConfig(
        name="dcn-card", vocab_sizes=vocab, embed_dim=128, n_dense=13,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256),
        multi_hot=SIZES, interaction="dcn", cross_layers=3, cross_rank=512,
        emb_dtype=torch.bfloat16)
    plan = uniform_partition(cfg.total_vocab, 8)
    params, statics = TD.init_params(
        cfg, torch.Generator(device=dev).manual_seed(2), plan=plan,
        device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    B = 4096
    sparse = torch.cat([torch.randint(0, v, (B, n), generator=g, device=dev)
                        for v, n in zip(vocab, SIZES)], 1).to(torch.int32)
    batch = {"dense": torch.randn((B, 13), generator=g, device=dev),
             "sparse": sparse}
    serve = build_recsys_serve(TD, cfg, statics)
    first = serve(params, batch)
    before = (K.csr_bag.launches, K.banked_bag.launches,
              DOT.dot_features.launches)
    for _ in range(3):
        out = serve(params, batch)
    torch.cuda.synchronize()
    assert (K.csr_bag.launches, K.banked_bag.launches,
            DOT.dot_features.launches) == (before[0] + 3, *before[1:])
    assert torch.equal(out, first) and out.shape == (B,)
    assert bool(torch.isfinite(out).all())
