"""The port's retrieval scoring (``models/dlrm.retrieval_scores``) and its
serve step (``serve_step.build_retrieval_serve``) against the JAX
package's, on the CPU, with the reference's own weights carried across.

Tolerances: the gathers are exact; the MLPs and the interaction are fp32
matmuls and dots summed in another order, so scores agree to rtol 1e-5 /
atol 1e-6. Ties: ``jax.lax.top_k`` returns equal scores lowest index first,
and so must the port (copies of one candidate id score the same, so with
N = 640 draws over field 0's 100 rows every returned id has copies).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.models import dlrm as JD
from repro.serve import serve_step as JSS
from repro_torch.configs import get_arch
from repro_torch.convert import params_from_jax, statics_from_jax
from repro_torch.models import dlrm as TD
from repro_torch.serve import serve_step as TSS

TOL = dict(rtol=1e-5, atol=1e-6)


def _carry(arch, emb_bf16=False, seed=0):
    jcfg, tcfg = jax_get_arch(arch).reduced, get_arch(arch).reduced
    if emb_bf16:
        jcfg = dataclasses.replace(jcfg, emb_dtype=jnp.bfloat16)
        tcfg = dataclasses.replace(tcfg, emb_dtype=torch.bfloat16)
    params, statics = JD.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, params), "cpu")
    ts = statics_from_jax({k: np.asarray(v) if hasattr(v, "shape") else v
                           for k, v in statics.items()}, "cpu")
    return jcfg, tcfg, params, statics, tp, ts


def _query(cfg, n, seed=1, holes=True):
    """One query (dense, one-hot ids) and n field-0 candidates drawn with
    repeats; with ``holes`` a -1 candidate and a -1 user id (field 1)."""
    rng = np.random.default_rng(seed)
    b = {"dense": rng.standard_normal((1, cfg.n_dense)).astype(np.float32),
         "sparse": np.array([[rng.integers(v) for v in cfg.vocab_sizes]],
                            np.int32),
         "candidates": rng.integers(0, cfg.vocab_sizes[0], n).astype(
             np.int32)}
    if holes:
        b["candidates"][3] = -1
        b["sparse"][0, 1] = -1
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


@pytest.mark.parametrize("emb_bf16", [False, True])
@pytest.mark.parametrize("n", [64, 640])
def test_retrieval_scores_match_jax(n, emb_bf16):
    """(N,) logits of reduced dlrm-rm2 (fp32 and bf16 tables) within rtol
    1e-5 / atol 1e-6 of the reference's, a -1 candidate and a -1 user id
    among the inputs; fp32 out; the plain and 'auto' backends equal."""
    jcfg, tcfg, params, statics, tp, ts = _carry("dlrm-rm2", emb_bf16)
    b = _query(jcfg, n)
    want = np.asarray(JD.retrieval_scores(jcfg, params, statics, _j(b)))
    got = TD.retrieval_scores(tcfg, tp, ts, _t(b))
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, TD.retrieval_scores(tcfg, tp, ts, _t(b),
                                                backend="torch"))


def test_negative_ids_are_kept_as_the_reference_keeps_them():
    """No mask, as in the reference: a -1 candidate reads the zero row
    (its score is that of a candidate whose row is zero), and a -1 user id
    in field 1 reads union row ``vocab[0] - 1``, field 0's last (zeroing
    that row changes the scores; zeroing field 1's first row, ``vocab[0]``,
    which nothing else reads, does not)."""
    jcfg, tcfg, params, statics, tp, ts = _carry("dlrm-rm2")
    b = _query(jcfg, 16)
    got = TD.retrieval_scores(tcfg, tp, ts, _t(b))
    np.testing.assert_allclose(
        got.numpy(), np.asarray(JD.retrieval_scores(jcfg, params, statics,
                                                    _j(b))), **TOL)

    def zeroed(row):
        p = {**tp, "emb_packed": tp["emb_packed"].clone()}
        p["emb_packed"][row] = 0.0
        return p
    b0 = {**b, "candidates": b["candidates"].copy()}
    b0["candidates"][3] = 0
    assert float(TD.retrieval_scores(tcfg, zeroed(0), ts, _t(b0))[3]) \
        == float(got[3])
    last0 = jcfg.vocab_sizes[0] - 1
    assert not torch.equal(
        TD.retrieval_scores(tcfg, zeroed(last0), ts, _t(b)), got)
    assert torch.equal(
        TD.retrieval_scores(tcfg, zeroed(last0 + 1), ts, _t(b)), got)


@pytest.mark.parametrize("n,k", [(64, 16), (640, 128)])
def test_retrieval_serve_matches_jax(n, k):
    """(top-k scores, top-k ids): the scores within rtol 1e-5 / atol 1e-6,
    the ids int32 and equal to ``jax.lax.top_k``'s, copies of one
    candidate id in increasing index order (N = 640 draws over 100 rows:
    every id repeats)."""
    jcfg, tcfg, params, statics, tp, ts = _carry("dlrm-rm2", True, seed=3)
    b = _query(jcfg, n, seed=4)
    jv, ji = JSS.build_retrieval_serve(JD, jcfg, statics, top_k=k)(params,
                                                                  _j(b))
    tv, ti = TSS.build_retrieval_serve(TD, tcfg, ts, top_k=k)(tp, _t(b))
    assert tv.shape == (k,) and ti.dtype == torch.int32
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    cand = b["candidates"][ti.numpy()]
    for v in np.unique(cand):
        pos = ti.numpy()[cand == v]
        assert (np.diff(pos) > 0).all()
        every = np.flatnonzero(b["candidates"] == v)
        np.testing.assert_array_equal(pos, every[:len(pos)])
    if n == 640:
        assert len(np.unique(cand)) < k                  # copies returned


@pytest.mark.parametrize("case", ["integers", "all_equal", "k_is_n"])
def test_top_k_breaks_ties_as_jax(case):
    """``top_k_lowest_first`` against ``jax.lax.top_k`` on scores with many
    exact ties: values and indices equal."""
    rng = np.random.default_rng(9)
    s = {"integers": rng.integers(-5, 5, 300).astype(np.float32),
         "all_equal": np.full(50, 0.25, np.float32),
         "k_is_n": rng.integers(0, 3, 40).astype(np.float32)}[case]
    k = len(s) if case == "k_is_n" else 37
    jv, ji = jax.lax.top_k(jnp.asarray(s), k)
    tv, ti = TSS.top_k_lowest_first(torch.from_numpy(s), k)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(ValueError, match="top_k"):
        TSS.top_k_lowest_first(torch.from_numpy(s), len(s) + 1)


def test_multi_hot_raises_where_the_reference_raises():
    """On reduced updlrm-paper (bags of 16) the reference's retrieval
    fails to broadcast (1, F, L) ids against (1, F - 1) offsets; the port
    raises a ValueError that says so."""
    jcfg, tcfg, params, statics, tp, ts = _carry("updlrm-paper")
    rng = np.random.default_rng(0)
    b = {"dense": rng.standard_normal((1, 13)).astype(np.float32),
         "sparse": rng.integers(0, 500, (1, 8, 16)).astype(np.int32),
         "candidates": rng.integers(0, 500, 32).astype(np.int32)}
    with pytest.raises((ValueError, TypeError)):
        JD.retrieval_scores(jcfg, params, statics, _j(b))
    with pytest.raises(ValueError, match="one-hot"):
        TD.retrieval_scores(tcfg, tp, ts, _t(b))
    with pytest.raises(ValueError, match="one-hot"):
        TSS.build_retrieval_serve(TD, tcfg, ts, top_k=4)(tp, _t(b))
