"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``): both run in subprocesses on the CPU, the port's with
``--device cpu``, and the port's printout is held to the reference's live
output on the same inputs.

The quickstart and the serve example print the same workload, plans, hit
rates and checks: those lines must be equal. The e2e example runs the
reference's recipe (``--steps 12 --crash-at 6 --batch 32``) on both sides;
the port starts from the reference's initial weights (``--init-from``, a
checkpoint of the reference's ``init_params`` in the shared on-disk
format), so the printed losses must agree within the train tests' rtol
1e-4, plus 1e-4 for the four decimals both print. The synthetic labels are
coin flips, so both print "NO IMPROVEMENT" on this recipe: the test holds
the same verdict, not an improvement.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# the reference's recipe for the e2e example
E2E_RECIPE = ["--steps", "12", "--crash-at", "6", "--batch", "32"]


def _run(script, *args, check=True):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src") + os.pathsep
           + os.environ.get("PYTHONPATH", ""), "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(ROOT / "examples" / script),
                        *args], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    if check:
        assert r.returncode == 0, r.stdout + r.stderr
    return r


def _lines(out, skip=()):
    return [ln for ln in out.splitlines()
            if not any(re.search(p, ln) for p in skip)]


def test_quickstart():
    """The reference's five stages, line for line (the same trace, groups,
    hit rate and plans, both lookup checks true); only the port's stage-4
    heading also names the device."""
    ref = _run("quickstart.py").stdout
    out = _run("torch_quickstart.py", "--device", "cpu").stdout
    assert "== 4. banked lookup == plain EmbeddingBag (cpu) ==" in out
    assert _lines(out, [r"^== 4\. "]) == _lines(ref, [r"^== 4\. "])
    assert "allclose: True" in out
    assert "cache path reconstructs bag sums: True" in out
    assert out.rstrip().endswith("done.")


def test_serve_updlrm():
    """Fig. 4's pre-process (groups, hit rate and imbalance) as the
    reference prints it, both serve paths timed, and the cached scores
    matching the plain ones on the deduplicated bags, as in the reference;
    without CUDA the default device refuses."""
    ref = _run("serve_updlrm.py").stdout
    out = _run("torch_serve_updlrm.py", "--device", "cpu").stdout
    pre = re.compile(r"groups=\d+ hit_rate=[\d.]+% imbalance=[\d.]+")
    assert pre.search(out).group() == pre.search(ref).group()
    assert re.search(r"plain lookup\s+: [\d.]+ ms/batch", out)
    assert re.search(r"cache-aware lookup: [\d.]+ ms/batch", out)
    assert "scores match: True" in ref and "scores match: True" in out
    if not __import__("torch").cuda.is_available():
        r = _run("torch_serve_updlrm.py", check=False)
        assert r.returncode != 0 and "is_available" in r.stderr


def _reference_initial_state(path):
    """What the reference's e2e example trains from (its config, plan and
    ``init_params(key(0))``), saved as step 0 in the shared format."""
    import jax

    from repro.checkpoint import save_checkpoint
    from repro.core.partitioning import non_uniform_partition
    from repro.models import dlrm as D
    from repro.train.train_step import TrainState, default_optimizer

    cfg = D.DLRMConfig(
        name="dlrm-100m", vocab_sizes=(500_000, 500_000, 500_000),
        embed_dim=64, n_dense=13, bot_mlp=(512, 256, 64),
        top_mlp=(512, 256))
    rng = np.random.default_rng(0)
    freq = (np.arange(1, cfg.total_vocab + 1) ** -0.9)[rng.permutation(
        cfg.total_vocab)]
    plan = non_uniform_partition(freq, 8, batch=4096)
    params, _ = D.init_params(cfg, jax.random.key(0), plan)
    state = TrainState.create(params, default_optimizer(lr=1e-3,
                                                        emb_lr=1e-2))
    save_checkpoint(str(path), 0, state)


def _losses(out):
    first = float(re.search(r"step +0 loss ([\d.]+)", out).group(1))
    a, b, verdict = re.search(r"loss ([\d.]+) -> ([\d.]+) \((.+)\)",
                              out).groups()
    return [first, float(a), float(b)], verdict


def test_train_dlrm_e2e(tmp_path):
    """The reference's recipe on both sides: the injected crash fires at
    step 6 and the run completes. With the reference's cadence (every 50
    steps) nothing was saved by then and the port replays from step 0, as
    the reference does; with ``--ckpt-every 4`` the restart restores step
    4 from the AsyncCheckpointer and runs 8 steps. From the reference's
    initial weights, the port's step-0 loss and first and last losses
    match the reference's, and both port runs print the same ones
    (deterministic replay)."""
    _reference_initial_state(tmp_path / "init")
    ref = _run("train_dlrm_e2e.py", *E2E_RECIPE,
               "--ckpt", str(tmp_path / "ref")).stdout
    args = [*E2E_RECIPE, "--device", "cpu", "--init-from",
            str(tmp_path / "init"), "--ckpt", str(tmp_path / "ck")]
    runs = [_run("torch_train_dlrm_e2e.py", *args).stdout,
            _run("torch_train_dlrm_e2e.py", *args, "--ckpt-every",
                 "4").stdout]
    for out in (ref, *runs):
        assert "params: 96,322,881" in out
        assert "crash injected at step 6: yes" in out
    imb = re.compile(r"banked over 8 banks, imbalance [\d.]+")
    assert imb.search(runs[0]).group() == imb.search(ref).group()
    assert "restored step" not in ref and "12 steps in" in ref
    assert "restored step" not in runs[0] and "12 steps in" in runs[0]
    assert "[restart] restored step 4" in runs[1] and "8 steps in" in runs[1]
    want, verdict = _losses(ref)
    for out in runs:
        got, v = _losses(out)
        assert v == verdict
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    assert _losses(runs[0]) == _losses(runs[1])
