"""GAT's edge-sharded path under the bank axis, on the CPU: gloo ranks of
the port (``tests/torch_dist_gat_ranks.py``) against the JAX reference's
single-device results, and the port's GNN sharding policy against the
reference's on an ``AbstractMesh``.

One world of 4 ranks is spawned once per file (a module-scoped fixture)
and runs every case as a 1 x 4 and as a 2 x 2 (data x bank) grid; the
edge lists are cut over all four ranks, node features held whole. The
reference's own ``shard_map`` path does not run under this JAX (its
``tests/dist_checks.py`` dies there), so the yardstick is its
single-device ``jax.value_and_grad`` on the whole batch. Cases, all on the
reduced config (two layers): every GNN cell's smoke batch (``loss_full``,
``loss_blocks``, ``loss_molecule``), and edge lists that do not divide by
the world (a full graph of 123 edges, sampled blocks of 21 and 56 edges,
a molecule batch of 35 edges, which gains an ``edge_mask``), and a graph
whose nodes 0-2 have only padding in-edges. On every rank: the loss and
the gradient of every param leaf within atol 1e-4 of the reference's (the
tolerance of the reference's own sharded GAT check), the rank's edge
pieces a quarter of the padded lists, and one train step (SGD, lr 1)
whose update is minus that gradient: the step's dp mean leaves one
device's gradient as it is.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.configs import shapes as JSH
from repro.data import synthetic as JS
from repro.models import gat as JG
from repro_torch.dist.launch import run_ranks

import torch_dist_gat_ranks as R

ATOL = 1e-4
WORLD = 4
JLOSS = {"minibatch_lg": JG.loss_blocks, "molecule": JG.loss_molecule}


def _case_batches() -> dict:
    """name -> (shape id, numpy batch, reduced dims)."""
    out = {}
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products",
                  "molecule"):
        _, cfg, b = JSH.smoke_batch("gat-cora", shape, seed=0)
        out[shape] = (shape, b, cfg)
    red = jax_get_arch("gat-cora").reduced
    cfg = dataclasses.replace(red, d_feat=16, n_classes=3)
    out["full_odd"] = ("full_graph_sm",
                       JS.random_graph(40, 123, 16, 3, seed=4), cfg)
    g = JS.random_graph(40, 160, 16, 3, seed=5)
    dst = g["edge_dst"]
    g["edge_mask"] = ~np.isin(dst, (0, 1, 2))
    out["full_padding"] = ("full_graph_sm", g, cfg)
    rd = dict(batch_nodes=7, fanout0=3, fanout1=2, d_feat=16, n_classes=3)
    out["blocks_odd"] = ("minibatch_lg", JSH._smoke_sampled_blocks(rd, 2),
                         cfg)
    out["molecule_odd"] = ("molecule",
                           JS.molecule_batch(5, 6, 7, 16, 3, seed=1), cfg)
    return out


CASES = sorted(_case_batches())


def _inputs_and_reference():
    inp, ref = {}, {}
    for name, (shape, b, cfg) in _case_batches().items():
        params = JG.init_params(cfg, jax.random.key(len(name)))
        inp[f"cfg.{name}"] = np.array([shape, cfg.d_feat, cfg.n_classes])
        for k, v in b.items():
            inp[f"case.{name}.{k}"] = v
        for i, lw in enumerate(params["layers"]):
            for k, v in lw.items():
                inp[f"p.{name}.{i}.{k}"] = np.asarray(v)
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        loss, g = jax.jit(jax.value_and_grad(
            lambda p, bb: JLOSS.get(shape, JG.loss_full)(cfg, p, bb)))(
                params, jb)
        ref[name] = dict(loss=float(loss), grads={
            f"['layers'][{i}]['{k}']": np.asarray(v)
            for i, lw in enumerate(g["layers"]) for k, v in lw.items()},
            edges=sorted((k, v.shape[0]) for k, v in b.items()
                         if "edge_" in k or (k.startswith("block") and
                                             k.endswith(("_src", "_dst",
                                                         "_mask")))))
    return inp, ref


@pytest.fixture(scope="module")
def gat_grids(tmp_path_factory):
    inp, ref = _inputs_and_reference()
    outs = run_ranks(R.gat_grids, WORLD, tmp_path_factory.mktemp("gat"),
                     inputs=inp, backend="gloo", timeout=300)
    return ref, outs


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("name", CASES)
def test_sharded_loss_and_grads(gat_grids, grid, name):
    ref, outs = gat_grids
    want = ref[name]
    for r, o in enumerate(outs):
        key = f"{grid}.{name}"
        np.testing.assert_allclose(float(o[f"{key}.loss"][0]), want["loss"],
                                   rtol=0, atol=ATOL, err_msg=f"rank {r}")
        for path, g in want["grads"].items():
            np.testing.assert_allclose(o[f"{key}.grad{path}"], g, rtol=0,
                                       atol=ATOL,
                                       err_msg=f"{path}, rank {r}")


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("name", CASES)
def test_sharded_train_step(gat_grids, grid, name):
    ref, outs = gat_grids
    want = ref[name]
    for r, o in enumerate(outs):
        key = f"{grid}.{name}"
        np.testing.assert_allclose(float(o[f"{key}.step_loss"][0]),
                                   want["loss"], rtol=0, atol=ATOL)
        for path, g in want["grads"].items():
            np.testing.assert_allclose(o[f"{key}.step{path}"], g, rtol=0,
                                       atol=ATOL,
                                       err_msg=f"{path}, rank {r}")


@pytest.mark.parametrize("name", CASES)
def test_edge_pieces(gat_grids, name):
    """Each rank holds a quarter of every edge list padded to a multiple of
    the world (a full-graph or molecule batch gains its edge_mask)."""
    ref, outs = gat_grids
    edges = dict(ref[name]["edges"])
    lens = list(edges.values())
    if "edge_src" in edges and "edge_mask" not in edges:
        lens.append(edges["edge_src"])            # the added edge_mask
    want = sorted(-(-n // WORLD) for n in lens)
    for grid in R.GRIDS:
        for o in outs:
            assert sorted(o[f"{grid}.{name}.edges"].tolist()) == want


# ---------------------------------------------------------------------------
# the policy against the reference's on an AbstractMesh
# ---------------------------------------------------------------------------

def _ctx(data, model, rank):
    from jax.sharding import AbstractMesh
    from repro.core import embedding as JE
    from repro_torch.core.embedding import DistCtx
    jd = JE.DistCtx(mesh=AbstractMesh((data, model), ("data", "model")),
                    dp_axes=("data",))
    td = DistCtx(data=data, model=model, rank=rank,
                 device=torch.device("cpu"), bank_group=None,
                 dp_group=None)
    return jd, td


@pytest.mark.parametrize("grid", sorted(R.GRIDS))
@pytest.mark.parametrize("name", CASES)
def test_gnn_batch_shardings_match_reference(grid, name):
    """On the padded batch (the reference's cells pad their edge lists
    before its policy sees them) the port cuts exactly the keys the
    reference spreads over every axis, to the rank's piece, and holds the
    rest whole."""
    from repro.dist import sharding as JSH_
    from repro_torch.dist import sharding as TSH
    data, model = R.GRIDS[grid]
    _, b, _ = _case_batches()[name]
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    padded = {k: v.numpy() for k, v in TSH.pad_edges(tb, WORLD).items()}
    specs = JSH_.gnn_batch_shardings(_ctx(data, model, 0)[0], padded)
    for rank in range(WORLD):
        piece, ctx = TSH.gnn_batch_shardings(_ctx(data, model, rank)[1], tb)
        assert ctx.dp_replicated or data == 1
        assert sorted(piece) == sorted(padded)
        for k, v in padded.items():
            spec = specs[k].spec
            cut = spec[0] is not None
            assert cut == TSH.is_edge_key(k), (k, spec)
            if cut:
                assert set(spec[0]) == {"data", "model"}
                n = v.shape[0] // WORLD
                np.testing.assert_array_equal(
                    piece[k].numpy(), v[rank * n:(rank + 1) * n])
            else:
                np.testing.assert_array_equal(piece[k].numpy(), v)


def test_pad_edges():
    from repro_torch.dist import sharding as TSH
    b = {k: torch.from_numpy(v) for k, v in
         JS.molecule_batch(5, 6, 7, 16, 3, seed=1).items()}
    p = TSH.pad_edges(b, 4)
    assert p["edge_src"].shape[0] == p["edge_mask"].shape[0] == 36
    assert p["edge_mask"][:35].all() and not p["edge_mask"][35:].any()
    assert (p["edge_src"][35:] == 0).all() and (p["edge_dst"][35:] == 0).all()
    for k in ("features", "graph_ids", "labels"):
        assert p[k] is b[k]
    assert "edge_mask" not in b
