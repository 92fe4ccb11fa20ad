"""Arch registry: every entry of the reference's
``repro/configs/registry.py`` (the five LMs, the two DLRMs, DIN, BERT4Rec,
xDeepFM and GAT) with its reduced variant. Dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.bert4rec import Bert4RecConfig
from repro_torch.models.din import DINConfig
from repro_torch.models.dlrm import DLRMConfig
from repro_torch.models.gat import GATConfig
from repro_torch.models.transformer import LMConfig, MoESpec
from repro_torch.models.xdeepfm import XDeepFMConfig

# Criteo-Kaggle per-field cardinalities (facebookresearch/dlrm day-0 counts) —
# the standard public vocab set for DLRM-style models; sum = 33.76M rows.
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)

LM_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")
GNN_SHAPES = ("full_graph_sm", "minibatch_lg", "ogb_products", "molecule")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                 # lm | dlrm | din | bert4rec | xdeepfm | gat
    config: Any
    reduced: Any
    shapes: tuple[str, ...]
    notes: str = ""


def _lm(arch_id, **kw):
    """The full config and its reduced twin: 2 layers, d 64, 4 query heads
    of 16, the KV heads in the same ratio, ff 128, vocab 512, 8 experts."""
    full = LMConfig(name=arch_id, **kw)
    red = dataclasses.replace(
        full, name=arch_id + "-reduced", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, 4 * kw["n_kv_heads"] // kw["n_heads"]),
        d_head=16, d_ff=128, vocab=512,
        moe=(MoESpec(8, min(8, full.moe.top_k)) if full.moe else None),
        q_chunk=16, kv_chunk=16, loss_chunk=16)
    return full, red


_smollm360, _smollm360_red = _lm(
    "smollm-360m", n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_head=64, d_ff=2560, vocab=49152, tied_embeddings=True)

_smollm135, _smollm135_red = _lm(
    "smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_head=64, d_ff=1536, vocab=49152, tied_embeddings=True)

_granite20b, _granite20b_red = _lm(
    "granite-20b", n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1,
    d_head=128, d_ff=24576, vocab=49152, mlp_type="gelu",
    tied_embeddings=True)

_qwen3moe, _qwen3moe_red = _lm(
    "qwen3-moe-30b-a3b", n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
    d_head=128, d_ff=768, vocab=151936, moe=MoESpec(128, 8))

_granitemoe, _granitemoe_red = _lm(
    "granite-moe-1b-a400m", n_layers=24, d_model=1024, n_heads=16,
    n_kv_heads=8, d_head=64, d_ff=512, vocab=49155, moe=MoESpec(32, 8),
    tied_embeddings=True)


_dlrm = DLRMConfig(
    name="dlrm-rm2", vocab_sizes=CRITEO_KAGGLE_VOCABS, embed_dim=64,
    n_dense=13, bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256),
    emb_dtype=torch.bfloat16)   # bf16 table storage, fp32 dense compute
_dlrm_red = DLRMConfig(
    name="dlrm-rm2-reduced", vocab_sizes=(100, 80, 60), embed_dim=8,
    n_dense=13, bot_mlp=(32, 8), top_mlp=(32, 16))

# GAT: 2 layers, hidden 8, 8 heads; d_feat and classes come from each
# cell's dataset (configs/shapes.gat_config_for_shape)
_gat = GATConfig(name="gat-cora", d_feat=1433, n_classes=7, n_layers=2,
                 d_hidden=8, n_heads=8)
_gat_red = GATConfig(name="gat-cora-reduced", d_feat=16, n_classes=3,
                     n_layers=2, d_hidden=4, n_heads=2)

# the paper's own workload: one Table-1 dataset duplicated into 8 EMTs,
# 32-dim embeddings, batch 64 (§4.1)
_updlrm = DLRMConfig(
    name="updlrm-paper", vocab_sizes=(2_360_650,) * 8, embed_dim=32,
    n_dense=13, bot_mlp=(512, 256, 32), top_mlp=(512, 256),
    multi_hot=256)
_updlrm_red = DLRMConfig(
    name="updlrm-paper-reduced", vocab_sizes=(500,) * 8, embed_dim=8,
    n_dense=13, bot_mlp=(32, 8), top_mlp=(32,), multi_hot=16)

# DIN: embed_dim 18, seq 100, attn_mlp 80-40, mlp 200-80; an industrial
# catalog (1M items, 1k categories) so the retrieval_cand shape is defined
_din = DINConfig(name="din", n_items=1_000_000, n_cates=1000, embed_dim=18,
                 seq_len=100, attn_mlp=(80, 40), mlp=(200, 80))
_din_red = DINConfig(name="din-reduced", n_items=500, n_cates=20, embed_dim=8,
                     seq_len=10, attn_mlp=(16, 8), mlp=(32, 16))

# BERT4Rec: embed_dim 64, 2 blocks, 2 heads, seq 200; a 1M-item catalog
_b4r = Bert4RecConfig(name="bert4rec", n_items=1_000_000, embed_dim=64,
                      n_blocks=2, n_heads=2, seq_len=200)
_b4r_red = Bert4RecConfig(name="bert4rec-reduced", n_items=200, embed_dim=16,
                          n_blocks=2, n_heads=2, seq_len=16, d_ff=32,
                          n_negatives=32, max_masked=8)

# xDeepFM: 39 fields = the 26 Criteo sparse + 13 bucketized dense (64 buckets)
XDEEPFM_VOCABS = CRITEO_KAGGLE_VOCABS + (64,) * 13
_xdeepfm = XDeepFMConfig(name="xdeepfm", vocab_sizes=XDEEPFM_VOCABS,
                         embed_dim=10, cin_layers=(200, 200, 200),
                         mlp=(400, 400))
_xdeepfm_red = XDeepFMConfig(name="xdeepfm-reduced",
                             vocab_sizes=(50,) * 5, embed_dim=4,
                             cin_layers=(8, 8), mlp=(16,))


ARCHS: dict[str, ArchSpec] = {
    "smollm-360m": ArchSpec("smollm-360m", "lm", _smollm360, _smollm360_red,
                            LM_SHAPES,
                            "[hf:HuggingFaceTB/SmolLM-360M] llama-arch GQA"),
    "smollm-135m": ArchSpec("smollm-135m", "lm", _smollm135, _smollm135_red,
                            LM_SHAPES,
                            "[hf:HuggingFaceTB/SmolLM-135M] llama-arch GQA"),
    "granite-20b": ArchSpec("granite-20b", "lm", _granite20b, _granite20b_red,
                            LM_SHAPES,
                            "[arXiv:2405.04324] MQA kv=1, gelu MLP, tied"),
    "qwen3-moe-30b-a3b": ArchSpec("qwen3-moe-30b-a3b", "lm", _qwen3moe,
                                  _qwen3moe_red, LM_SHAPES,
                                  "[hf:Qwen/Qwen3-30B-A3B] 128e top-8"),
    "granite-moe-1b-a400m": ArchSpec("granite-moe-1b-a400m", "lm",
                                     _granitemoe, _granitemoe_red, LM_SHAPES,
                                     "[hf:ibm-granite/granite-3.0-1b-a400m]"),
    "dlrm-rm2": ArchSpec("dlrm-rm2", "dlrm", _dlrm, _dlrm_red, RECSYS_SHAPES,
                         "[arXiv:1906.00091] Criteo-Kaggle vocabs"),
    "din": ArchSpec("din", "din", _din, _din_red, RECSYS_SHAPES,
                    "[arXiv:1706.06978]"),
    "bert4rec": ArchSpec("bert4rec", "bert4rec", _b4r, _b4r_red,
                         RECSYS_SHAPES, "[arXiv:1904.06690]"),
    "xdeepfm": ArchSpec("xdeepfm", "xdeepfm", _xdeepfm, _xdeepfm_red,
                        RECSYS_SHAPES, "[arXiv:1803.05170]"),
    "gat-cora": ArchSpec("gat-cora", "gat", _gat, _gat_red, GNN_SHAPES,
                         "[arXiv:1710.10903]"),
    "updlrm-paper": ArchSpec("updlrm-paper", "dlrm", _updlrm, _updlrm_red,
                             RECSYS_SHAPES, "paper §4.1 workload"),
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def list_archs(assigned_only: bool = True) -> list[str]:
    """The registry's ids in order; ``assigned_only`` leaves out the
    paper's own ``updlrm-paper``, as the reference's."""
    return [a for a in ARCHS if a != "updlrm-paper" or not assigned_only]
