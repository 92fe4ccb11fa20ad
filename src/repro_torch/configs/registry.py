"""Arch registry for the ported families: the two DLRM entries of the
reference's ``repro/configs/registry.py`` with their reduced variants.

Dtypes are torch dtypes. Any other arch id of the reference belongs to a
family the port has not reached yet, and ``get_arch`` says so.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.dlrm import DLRMConfig

# Criteo-Kaggle per-field cardinalities (facebookresearch/dlrm day-0 counts) —
# the standard public vocab set for DLRM-style models; sum = 33.76M rows.
CRITEO_KAGGLE_VOCABS = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)

RECSYS_SHAPES = ("train_batch", "serve_p99", "serve_bulk", "retrieval_cand")


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                 # dlrm (the only family ported so far)
    config: Any
    reduced: Any
    shapes: tuple[str, ...]
    notes: str = ""


_dlrm = DLRMConfig(
    name="dlrm-rm2", vocab_sizes=CRITEO_KAGGLE_VOCABS, embed_dim=64,
    n_dense=13, bot_mlp=(512, 256, 64), top_mlp=(512, 512, 256),
    emb_dtype=torch.bfloat16)   # bf16 table storage, fp32 dense compute
_dlrm_red = DLRMConfig(
    name="dlrm-rm2-reduced", vocab_sizes=(100, 80, 60), embed_dim=8,
    n_dense=13, bot_mlp=(32, 8), top_mlp=(32, 16))

# the paper's own workload: one Table-1 dataset duplicated into 8 EMTs,
# 32-dim embeddings, batch 64 (§4.1)
_updlrm = DLRMConfig(
    name="updlrm-paper", vocab_sizes=(2_360_650,) * 8, embed_dim=32,
    n_dense=13, bot_mlp=(512, 256, 32), top_mlp=(512, 256),
    multi_hot=256)
_updlrm_red = DLRMConfig(
    name="updlrm-paper-reduced", vocab_sizes=(500,) * 8, embed_dim=8,
    n_dense=13, bot_mlp=(32, 8), top_mlp=(32,), multi_hot=16)


ARCHS: dict[str, ArchSpec] = {
    "dlrm-rm2": ArchSpec("dlrm-rm2", "dlrm", _dlrm, _dlrm_red, RECSYS_SHAPES,
                         "[arXiv:1906.00091] Criteo-Kaggle vocabs"),
    "updlrm-paper": ArchSpec("updlrm-paper", "dlrm", _updlrm, _updlrm_red,
                             RECSYS_SHAPES, "paper §4.1 workload"),
}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in ARCHS:
        raise KeyError(f"arch {arch_id!r}: its family is not ported yet "
                       f"(ported: {sorted(ARCHS)})")
    return ARCHS[arch_id]
