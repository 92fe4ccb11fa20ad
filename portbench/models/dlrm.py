"""The ``dlrm`` model adapter: a configuration whose ``"model"`` is
``"dlrm"`` runs the port's DLRM (``repro_torch``) through this file. The
adapters under ``portbench/models/`` are the only part of the benchmark
that imports the port.

An adapter gives the harness:

- ``build_kernels(cfg)``: the kernels the configuration launches, built;
- ``setup(cfg, seed, traffic, device)``: the program's set-up from the seed
  and the traffic: an object with ``params``, ``serve(params, batch)`` and
  ``train_step(opt)``. The adapter makes the weights from the seed itself,
  as the configuration's reference lays them out, so that it can make and
  pack a table a chunk at a time in the type it is stored in;
- ``param_leaves(params)``, ``train_probe(state, cfg, opt)`` and
  ``reference_state(state, prog)``: the train state in the reference's
  terms;
- ``model_flops(cfg, batch, train)``: a step's textbook FLOPs;
- ``tracer()``: the port's process tracer, whose stage spans the per-layer
  readers take (``portbench/program_spans.py``), or None.

Here: the weights of ``portbench/reference/dlrm.py`` (``make_weights``,
whole, as the cells' limits were measured with); the partition plan
(the config's ``plan``), the table packed by it, the serve entry
(``serve_step.build_recsys_serve`` -> ``models/dlrm.forward``) and the
train step (``train_step.build_train_step(dlrm.loss_fn, optimizer)``).
"""
from __future__ import annotations

import torch

from portbench.counts import dlrm as C
from portbench.reference.dlrm import make_weights


def kernel_names(cfg: dict) -> tuple[str, ...]:
    """The kernel libraries a DLRM of this configuration launches."""
    bag = ("banked_bag", "ct_scatter") if cfg["multi_hot"] > 1 else ()
    return (*bag, "dot_interaction")


def build_kernels(cfg: dict) -> None:
    """Build the configuration's kernels, every nvcc at once (a no-op when
    they are built: the libraries live in the checkout's
    ``build/repro_torch``, named by a hash of their source)."""
    from repro_torch.kernels import _build
    _build.build(kernel_names(cfg))


def model_flops(cfg: dict, batch: int, train: bool = False) -> float:
    return C.model_flops(cfg, batch, train)


def tracer():
    """The port's process tracer, or None where the port has none."""
    from repro_torch.obs import tracing
    get = getattr(tracing, "process_tracer", None)
    return None if get is None else get()


def setup(cfg: dict, seed: int, traffic, device) -> "Program":
    """The weights from the seed, the traffic's popularity where the plan
    needs it, then the program's set-up."""
    weights = make_weights(cfg, seed, device)
    pop = (traffic.popularity() if cfg["plan"]["kind"] == "non_uniform"
           else None)
    return Program(cfg, weights, pop, device)


class Program:
    def __init__(self, cfg: dict, weights: dict, popularity, device):
        from repro_torch.core.partitioning import (non_uniform_partition,
                                                   uniform_partition)
        from repro_torch.models import dlrm
        from repro_torch.serve.serve_step import build_recsys_serve
        self.dlrm = dlrm
        self.cfg = dlrm.DLRMConfig(
            name=cfg["name"], vocab_sizes=tuple(cfg["vocab_sizes"]),
            embed_dim=cfg["embed_dim"], n_dense=cfg["n_dense"],
            bot_mlp=tuple(cfg["bot_mlp"]), top_mlp=tuple(cfg["top_mlp"]),
            multi_hot=cfg["multi_hot"], dtype=getattr(torch, cfg["dtype"]),
            emb_dtype=getattr(torch, cfg["emb_dtype"]))
        plan = cfg["plan"]
        V = self.cfg.total_vocab
        if plan["kind"] == "non_uniform":
            self.plan = non_uniform_partition(popularity, plan["n_banks"],
                                              batch=plan.get("group", 1))
        elif plan["kind"] == "uniform":
            self.plan = uniform_partition(V, plan["n_banks"])
        else:
            raise ValueError(f"unknown plan {plan}")
        rows = int(self.plan.max_rows_per_bank)
        self.statics = dlrm.plan_statics(self.cfg, self.plan, rows,
                                         device=device)
        packed = torch.zeros((self.plan.n_banks * rows, cfg["embed_dim"]),
                             dtype=weights["table"].dtype, device=device)
        packed[self.statics["remap_flat"].long()] = weights["table"]
        self.params = {"emb_packed": packed,
                       "bot": {k: list(v) for k, v in weights["bot"].items()},
                       "top": {k: list(v) for k, v in weights["top"].items()}}
        self.serve = build_recsys_serve(dlrm, self.cfg, self.statics)

    def train_step(self, opt: dict):
        """(step, state): the train step of the config's recipe and its
        state at step 0, on this program's params."""
        from repro_torch.train.train_step import (TrainState,
                                                  build_train_step,
                                                  default_optimizer)
        d, t = opt["dense"], opt["table"]
        if d["kind"] != "adam" or t["kind"] != "rowwise_adagrad":
            raise ValueError(f"unknown optimizer {opt}")
        optimizer = default_optimizer(lr=d["lr"], emb_lr=t["lr"])
        cfg, statics, dlrm = self.cfg, self.statics, self.dlrm
        step = build_train_step(
            lambda p, b, **k: dlrm.loss_fn(cfg, p, statics, b, **k),
            optimizer, clip_norm=opt["clip_norm"])
        return step, TrainState.create(self.params, optimizer)


def _dense_names(params) -> list[str]:
    """The MLP leaves' names (the reference's ``mlp_leaves``) in the
    program's flatten order, which is Adam's order of its leaves."""
    return [f"{m}.{k}{i}" for m in ("bot", "top") for k in ("b", "w")
            for i in range(len(params[m][k]))]


def train_probe(state, cfg: dict, opt: dict) -> dict:
    """What the program's train state says of its first step: the norm of
    each MLP leaf's gradient as the optimizer got it (Adam's m = (1 - b1) g
    after one step), and the table's (row-wise Adagrad's accumulator holds
    mean(g^2) of each row). Names follow the reference's ``leaves``."""
    s = state.opt_state
    b1 = opt["dense"]["b1"]
    out = {n: float(torch.linalg.vector_norm((m / (1 - b1)).double()))
           for n, m in zip(_dense_names(state.params), s["false"]["m"])}
    out["table"] = float(torch.sqrt(s["true"][0].double().sum()
                                    * cfg["embed_dim"]))
    return out


def reference_state(state, prog) -> dict:
    """The program's train state in the reference's terms, copied: the
    weights as ``make_weights`` lays them out (the table's logical rows),
    Adam's ``m``, ``v`` and ``t`` by leaf name, and row-wise Adagrad's
    accumulator of each logical row."""
    p, s = state.params, state.opt_state
    remap = prog.statics["remap_flat"].long()
    names = _dense_names(p)
    w = {"table": p["emb_packed"][remap],
         **{m: {k: [t.clone() for t in p[m][k]] for k in ("b", "w")}
            for m in ("bot", "top")}}
    return {"w": w,
            "m": {n: t.clone() for n, t in zip(names, s["false"]["m"])},
            "v": {n: t.clone() for n, t in zip(names, s["false"]["v"])},
            "t": int(s["false"]["t"]),
            "acc": s["true"][0][remap]}


def param_leaves(params) -> dict:
    """The program's params by the reference's names (the table packed)."""
    out = {"table": params["emb_packed"]}
    for m in ("bot", "top"):
        for k in ("b", "w"):
            for i, t in enumerate(params[m][k]):
                out[f"{m}.{k}{i}"] = t
    return out
