"""The ``dlrm_dcn`` model adapter: a configuration whose ``"model"`` is
``"dlrm_dcn"`` (MLPerf's DLRM-DCNv2) runs the port's DLRM with the
low-rank cross network (``repro_torch.models.dlrm``, ``interaction="dcn"``)
through this file. It gives what ``portbench/models/dlrm.py`` lists for a
bulk cell: ``build_kernels``, ``setup``, ``param_leaves``, ``model_flops``
and ``tracer``.

The port's ``DLRMConfig`` is built first, before any kernel or table, so
that a port without the DCN path fails at once. The table (204 M rows of
128 in bf16 at MLPerf's size, 52.3 GB) is never held whole in fp32 nor
twice: the packed table is allocated once, zero, and each chunk of
``portbench/reference/dlrm_dcn.py``'s ``table_chunks`` is made and written
into its slots (the plan's flat remap), one at a time; the dense weights
are the reference's ``dense_weights``. The serve entry is
``serve_step.build_recsys_serve`` -> ``models/dlrm.forward``.
"""
from __future__ import annotations

import torch

from portbench.counts import dlrm_dcn as C
from portbench.reference.dlrm_dcn import dense_weights, table_chunks

KERNELS = ("csr_bag",)


def port_config(cfg: dict):
    """The port's ``DLRMConfig`` of the configuration."""
    from repro_torch.models import dlrm
    return dlrm.DLRMConfig(
        name=cfg["name"], vocab_sizes=tuple(cfg["vocab_sizes"]),
        embed_dim=cfg["embed_dim"], n_dense=cfg["n_dense"],
        bot_mlp=tuple(cfg["bot_mlp"]), top_mlp=tuple(cfg["top_mlp"]),
        multi_hot=tuple(cfg["multi_hot_sizes"]), interaction="dcn",
        cross_layers=cfg["cross_layers"], cross_rank=cfg["cross_rank"],
        dtype=getattr(torch, cfg["dtype"]),
        emb_dtype=getattr(torch, cfg["emb_dtype"]))


def build_kernels(cfg: dict) -> None:
    """Build the CSR bag kernel, the one the scoring step launches (a no-op
    when built), once the port has taken the configuration."""
    port_config(cfg)
    from repro_torch.kernels import _build
    _build.build(KERNELS)


def model_flops(cfg: dict, batch: int, train: bool = False) -> float:
    return C.model_flops(cfg, batch, train)


def tracer():
    """The port's process tracer, or None where the port has none."""
    from repro_torch.obs import tracing
    get = getattr(tracing, "process_tracer", None)
    return None if get is None else get()


def setup(cfg: dict, seed: int, traffic, device) -> "Program":
    return Program(cfg, seed, device)


class Program:
    def __init__(self, cfg: dict, seed: int, device):
        self.cfg = port_config(cfg)      # first: before the table is made
        from repro_torch.core.partitioning import uniform_partition
        from repro_torch.models import dlrm
        from repro_torch.serve.serve_step import build_recsys_serve
        plan = cfg["plan"]
        if plan["kind"] != "uniform":
            raise ValueError(f"unknown plan {plan}")
        self.plan = uniform_partition(self.cfg.total_vocab, plan["n_banks"])
        rows = int(self.plan.max_rows_per_bank)
        self.statics = dlrm.plan_statics(self.cfg, self.plan, rows,
                                         device=device)
        packed = torch.zeros((self.plan.n_banks * rows, cfg["embed_dim"]),
                             dtype=self.cfg.emb_dtype, device=device)
        remap = self.statics["remap_flat"]
        for start, chunk in table_chunks(cfg, seed, device):
            packed[remap[start:start + chunk.shape[0]].long()] = chunk
        self.params = {"emb_packed": packed, **dense_weights(cfg, seed,
                                                             device)}
        self.serve = build_recsys_serve(dlrm, self.cfg, self.statics)


def param_leaves(params) -> dict:
    """The program's params by the reference's names (the table packed)."""
    out = {"table": params["emb_packed"]}
    for m in ("bot", "cross", "top"):
        for k, ts in params[m].items():
            for i, t in enumerate(ts):
                out[f"{m}.{k}{i}"] = t
    return out
