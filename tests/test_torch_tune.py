"""The port's autotuned dispatch (``repro_torch.tune``, ``launch/tune.py``,
``backend='tuned'``) against the reference's ``repro.tune``.

Signature keys and the signature suite equal the reference's; the dispatch
cache's contract is the reference's (``tests/test_dispatch.py``), with the
port's own file and environment variable; at the reference's small
``_CASES`` shapes every case's plain version gives the reference's jnp bits
and the kernel's plain version its Pallas bits (interpret mode); a tuned
call consults the cache and gives the same bits; ``tuned_geometry`` holds
the kernels' limits; the tune, serve and train CLIs run on the CPU.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.tune import autotune as JA
from repro.tune import dispatch as JD
from repro_torch.configs import get_arch
from repro_torch.core import embedding as TE
from repro_torch.kernels import embedding_bag as TK
from repro_torch.launch import serve as TSERVE
from repro_torch.launch import train as TTRAIN
from repro_torch.launch import tune as TTUNE
from repro_torch.models import dlrm as TDLRM
from repro_torch.tune import autotune as TA
from repro_torch.tune import dispatch as TD


@pytest.fixture(autouse=True)
def _reset_cache():
    """Every test starts and ends with an explicit EMPTY port cache (never
    the committed ``TUNE_dispatch_cuda.json``)."""
    TD.set_cache(TD.DispatchCache())
    yield
    TD.set_cache(None)


# ---------------------------------------------------------------------------
# keys: the reference's, byte for byte
# ---------------------------------------------------------------------------

SIGS = [
    ("plain", dict(vocab=18_885_200, dim=32, batch=512, bag_len=256,
                   n_fields=8)),
    ("plain", dict(vocab=1000, dim=32, batch=16, bag_len="4")),
    ("fused", dict(vocab=2000, dim=64, batch=32, bag_len="4+8")),
    ("csr", dict(vocab=10_000, dim=64, batch=64, bag_len="ragged",
                 bwd_backend="torch")),
    ("tiered", dict(vocab=2000, dim=64, batch=32, bag_len=8,
                    tier_mix="bf16")),
    ("replicated", dict(vocab=2000, dim=64, batch=32, bag_len=8, k_max=4,
                        n_fields=3)),
]


@pytest.mark.parametrize("path,kw", SIGS,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(SIGS)])
def test_signature_key_equals_the_references(path, kw):
    assert TD.signature(path, **kw).key() == JD.signature(path, **kw).key()
    assert TD.CallSignature(path, **{**kw, "bag_len": str(kw["bag_len"])}) \
        .key() == JD.signature(path, **kw).key()


def test_suite_keys_equal_the_references():
    port = [c.sig.key() for c in TA.default_signature_suite(device="cpu")]
    ref = [c.sig.key() for c in JA.default_signature_suite()]
    assert port == ref and len(port) == 8
    assert TA.PLAIN_CONFIGS == JA.PLAIN_CONFIGS


# ---------------------------------------------------------------------------
# the dispatch cache's contract, mirrored
# ---------------------------------------------------------------------------

def test_signature_key_deterministic():
    a = TD.signature("plain", vocab=1000, dim=32, batch=16, bag_len=4)
    b = TD.signature("plain", vocab=1000, dim=32, batch=16, bag_len="4")
    assert a == b and a.key() == b.key()
    assert a.key() == "plain|v1000|d32|b16|l4|f1|k1|tnone|bwauto"


@pytest.mark.parametrize("field,val", [
    ("path", "csr"), ("vocab", 999), ("dim", 64), ("batch", 8),
    ("bag_len", "8"), ("n_fields", 2), ("k_max", 2), ("tier_mix", "bf16"),
    ("bwd_backend", "torch"),
])
def test_signature_key_covers_every_field(field, val):
    base = dict(path="plain", vocab=1000, dim=32, batch=16, bag_len="4",
                n_fields=1, k_max=1, tier_mix="none", bwd_backend="auto")
    changed = dict(base)
    changed[field] = val
    assert TD.CallSignature(**base).key() != TD.CallSignature(**changed).key()


def test_bad_path_and_bad_backend_rejected():
    with pytest.raises(ValueError):
        TD.signature("nope", vocab=1, dim=1, batch=1, bag_len=1)
    for backend in ("auto", "tuned", "jnp", "pallas"):
        with pytest.raises(ValueError):
            TD.Decision(backend=backend, tile_b=1, n_slots=1)
    assert TD.SCHEMA_VERSION == JD.SCHEMA_VERSION == 1


def test_persistence_round_trip(tmp_path):
    cache = TD.DispatchCache(meta={"arch": "test", "smoke": False,
                                   "repeats": 1, "n_candidates": 3})
    for i, path in enumerate(("plain", "fused", "csr")):
        sig = TD.signature(path, vocab=100 * (i + 1), dim=32, batch=8,
                           bag_len="ragged" if path == "csr" else 4)
        cache.record(sig, backend="cuda" if i % 2 else "torch",
                     tile_b=1 + i % 2, n_slots=2 ** i,
                     timings={"best_us": 1.5, "cuda_us": 1.5,
                              "torch_us": 2.0})
    out = tmp_path / TD.CACHE_BASENAME
    cache.save(str(out))
    reloaded = TD.DispatchCache.load(str(out))
    assert reloaded.meta["version"] == cache.meta["version"]
    assert reloaded.decisions() == cache.decisions()
    assert reloaded.to_doc() == json.loads(out.read_text())


def test_load_rejects_schema_version_mismatch(tmp_path):
    out = tmp_path / TD.CACHE_BASENAME
    out.write_text('{"meta": {"version": 999}, "entries": {}}')
    with pytest.raises(ValueError):
        TD.DispatchCache.load(str(out))


def _one_entry_file(path, sig):
    c = TD.DispatchCache()
    c.record(sig, backend="torch", tile_b=2, n_slots=4)
    c.save(str(path))


def test_port_env_var_wins_and_the_references_are_ignored(tmp_path,
                                                          monkeypatch):
    assert TD.CACHE_ENV == "REPRO_TORCH_TUNE_CACHE" != JD.CACHE_ENV
    assert TD.CACHE_BASENAME == "TUNE_dispatch_cuda.json" != JD.CACHE_BASENAME
    monkeypatch.setenv(TD.CACHE_ENV, str(tmp_path / "elsewhere.json"))
    assert TD.default_cache_path() == str(tmp_path / "elsewhere.json")

    # the reference's env var and file name, in the cwd: never read
    sig = TD.signature("plain", vocab=50, dim=8, batch=4, bag_len=2)
    _one_entry_file(tmp_path / JD.CACHE_BASENAME, sig)
    monkeypatch.setenv(JD.CACHE_ENV, str(tmp_path / JD.CACHE_BASENAME))
    monkeypatch.chdir(tmp_path)
    TD.set_cache(None)
    assert TD.get_cache().entries == {}          # the port's env: absent
    monkeypatch.delenv(TD.CACHE_ENV)
    p = TD.default_cache_path()
    assert p is None or os.path.basename(p) == TD.CACHE_BASENAME

    # the port's file in the cwd is found, and loaded once
    _one_entry_file(tmp_path / TD.CACHE_BASENAME, sig)
    assert TD.default_cache_path() == os.path.join(str(tmp_path),
                                                   TD.CACHE_BASENAME)
    TD.set_cache(None)
    assert TD.get_cache() is TD.get_cache()
    assert TD.decide("plain", vocab=50, dim=8, batch=4, bag_len=2) \
        == TD.Decision("torch", 2, 4, source="cache")


def test_miss_falls_back_to_callers_values():
    cache = TD.DispatchCache()
    TD.set_cache(cache)
    dec = TD.decide("plain", vocab=50, dim=8, batch=4, bag_len=2,
                    default_backend="torch", default_tile_b=2,
                    default_n_slots=4)
    assert dec == TD.Decision(backend="torch", tile_b=2, n_slots=4,
                              source="default")
    assert cache.misses == 1 and cache.hits == 0
    # the auto rule by device; None geometry is the kernels' fixed rule
    for device, backend in (("cuda", "cuda"), ("cpu", "torch")):
        assert TD.decide("plain", vocab=50, dim=8, batch=4, bag_len=2,
                         device=device) \
            == TD.Decision(backend, None, None, source="default")


def test_hit_returns_recorded_decision():
    cache = TD.DispatchCache()
    sig = TD.signature("plain", vocab=50, dim=8, batch=4, bag_len=2)
    cache.record(sig, backend="cuda", tile_b=2, n_slots=8)
    TD.set_cache(cache)
    dec = TD.decide("plain", vocab=50, dim=8, batch=4, bag_len=2,
                    default_backend="torch", default_tile_b=1,
                    default_n_slots=1)
    assert dec == TD.Decision(backend="cuda", tile_b=2, n_slots=8,
                              source="cache")
    assert cache.hits == 1 and cache.misses == 0


def test_near_miss_is_a_miss():
    cache = TD.DispatchCache()
    cache.record(TD.signature("plain", vocab=50, dim=8, batch=4, bag_len=2),
                 backend="cuda", tile_b=2, n_slots=4)
    TD.set_cache(cache)
    dec = TD.decide("plain", vocab=50, dim=8, batch=8, bag_len=2,
                    default_backend="torch")      # batch differs
    assert dec.source == "default" and dec.backend == "torch"


# ---------------------------------------------------------------------------
# the cases, held against the reference's at test_dispatch.py's shapes
# ---------------------------------------------------------------------------

SMALL = [
    ("plain_case", (500, 32, 8, 4, 1), dict(seed=10)),
    ("plain_case", (400, 16, 4, 4, 2), dict(seed=11)),
    ("fused_case", (), dict(v=500, nc=32, d=32, b=8, lc=2, lr=4, seed=12)),
    ("csr_case", (), dict(v=500, d=32, num_bags=8, avg_len=4, seed=13)),
    ("tiered_case", (), dict(v=500, d=32, b=8, l=4, seed=14)),
    ("replicated_case", (), dict(v=500, d=32, b=8, l=4, k_max=2, n_hot=8,
                                 seed=15)),
]
SMALL_IDS = [f"{n}-{kw.get('seed')}" for n, _, kw in SMALL]


def _cases(name, args, kw):
    return (getattr(JA, name)(*args, **kw),
            getattr(TA, name)(*args, **kw, device="cpu"))


@pytest.mark.parametrize("name,args,kw", SMALL, ids=SMALL_IDS)
def test_case_equals_the_references_jnp_and_pallas(name, args, kw):
    jcase, tcase = _cases(name, args, kw)
    assert tcase.sig.key() == jcase.sig.key()
    want = np.asarray(jcase.make("jnp", 8, 2)())
    got = tcase.make("torch", None, None)()
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the kernel's plain version: the Pallas kernel's bits (interpret mode)
    np.testing.assert_array_equal(tcase.plain().numpy(),
                                  np.asarray(jcase.make("pallas", 8, 2)()))


@pytest.mark.parametrize("decision", [("cuda", 2, 4), ("torch", 1, 1),
                                      ("cuda", 2, 8)])
@pytest.mark.parametrize("name,args,kw", SMALL, ids=SMALL_IDS)
def test_tuned_call_consults_the_cache_and_keeps_the_bits(name, args, kw,
                                                          decision):
    """On CPU tensors every decision (even one no kernel could launch) runs
    the plain version; the caller's tile_b/n_slots are decoys."""
    jcase, tcase = _cases(name, args, kw)
    want = np.asarray(jcase.make("jnp", 8, 2)())
    cache = TD.DispatchCache()
    backend, tile_b, n_slots = decision
    cache.record(tcase.sig, backend=backend, tile_b=tile_b, n_slots=n_slots)
    TD.set_cache(cache)
    got = tcase.make("tuned", tile_b + 3, n_slots + 1)()
    assert cache.hits >= 1 and cache.misses == 0, \
        "tuned call never consulted the cache"
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_decisions_and_refusals_on_the_card_side():
    """The device rule as ``_lookup_backend`` applies it (no tensor is
    touched): on CUDA a 'cuda' decision is its geometry, a 'torch' one
    raises naming the signature; on the CPU it is the plain version."""
    shape = dict(vocab=50, dim=8, batch=4, bag_len=2, n_fields=1,
                 bwd_backend="auto")
    sig = TD.signature("plain", **shape)
    cache = TD.DispatchCache()
    cache.record(sig, backend="cuda", tile_b=2, n_slots=4)
    TD.set_cache(cache)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert TE._lookup_backend("tuned", cuda, 1, 1, "plain", **shape) \
        == ("cuda", (2, 4))
    assert TE._lookup_backend("tuned", cpu, 1, 1, "plain", **shape) \
        == ("torch", None)
    cache.record(sig, backend="torch", tile_b=1, n_slots=1)
    with pytest.raises(ValueError, match=sig.key().replace("|", r"\|")):
        TE._lookup_backend("tuned", cuda, None, None, "plain", **shape)
    # a miss on CUDA is the rule's kernel with the caller's geometry
    assert TE._lookup_backend("tuned", cuda, None, 8, "plain",
                              **{**shape, "batch": 5}) == ("cuda", (None, 8))
    assert TE._lookup_backend("auto", cuda, 2, None, "plain", **shape) \
        == ("cuda", (2, None))
    assert cache.hits == 3 and cache.misses == 1


def test_tuned_refusals_and_auto_paths_on_the_cpu():
    t, ids = _plain_inputs()
    with pytest.raises(ValueError, match="does not select one"):
        TE.banked_embedding_bag(t, ids, backend="tuned", bwd_backend="tuned")
    cache = TD.DispatchCache()
    TD.set_cache(cache)
    # the dense gather has no kernel to tune: 'auto', no lookup
    assert torch.equal(
        TE.banked_embedding_bag(t, ids, reduce_bag=False, backend="tuned"),
        TE.banked_embedding_bag(t, ids, reduce_bag=False))
    assert cache.hits == cache.misses == 0
    with pytest.raises(ValueError, match="backend must be one of"):
        TE.banked_embedding_bag(t, ids, backend="pallas")
    with pytest.raises(ValueError, match="no tuned signature"):
        TE._resolve_backend("tuned", torch.device("cpu"))


def _plain_inputs():
    from repro_torch.core.embedding import pack_table
    from repro_torch.core.partitioning import non_uniform_partition
    rng = np.random.default_rng(5)
    t = pack_table(rng.standard_normal((64, 8)).astype(np.float32),
                   non_uniform_partition(rng.random(64) + 0.1, 4),
                   device="cpu")
    ids = torch.from_numpy(rng.integers(-1, 64, (6, 5)).astype(np.int32))
    return t, ids


def test_tuned_gradient_equals_auto():
    t, ids = _plain_inputs()
    grads = []
    for backend in ("auto", "tuned"):
        p = t.packed.clone().requires_grad_(True)
        out = TE.banked_embedding_bag(dataclasses.replace(t, packed=p), ids,
                                      backend=backend)
        (g,) = torch.autograd.grad(out.square().sum(), [p])
        grads.append(g)
    assert torch.equal(grads[0], grads[1])


def test_interaction_takes_tuned_as_auto_and_refuses_the_unknown():
    rng = np.random.default_rng(0)
    z = torch.from_numpy(rng.standard_normal((4, 5, 8)).astype(np.float32))
    x, emb = z[:, 0], z[:, 1:]
    assert torch.equal(TDLRM.dot_interaction(z, "tuned"),
                       TDLRM.dot_interaction(z))
    assert torch.equal(TDLRM.interaction_features(x, emb, "tuned"),
                       TDLRM.interaction_features(x, emb))
    for bad in ("pallas", "jnp", "Torch"):
        with pytest.raises(ValueError, match="backend must be one of"):
            TDLRM.dot_interaction(z, bad)
        with pytest.raises(ValueError, match="backend must be one of"):
            TDLRM.interaction_features(x, emb, bad)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        TDLRM.interaction_features(x, emb, "cuda")


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------

GEO_SHAPES = [(nb, L, d, isz) for nb in (1, 64, 512, 4224, 9000)
              for L in (1, 8, 33, 256, 1000) for d in (8, 32, 64, 128, 160)
              for isz in (4, 2)]


def test_tuned_geometry_is_the_rule_when_the_override_is():
    for nb, L, d, isz in GEO_SHAPES:
        for ptrs, slot, rule in (
                ((0,), TK.SLOT_BYTES,
                 TK.bag_geometry(nb, L, d, isz, 0)),
                ((256, 64), TK.LIST_BYTES,
                 TK.bag_geometry(nb, L, d, isz, slot_bytes=TK.LIST_BYTES)
                 ._replace(vec=TK.copy_width(d * isz, 256, 64)))):
            assert TK.tuned_geometry(nb, L, d, isz, *ptrs,
                                     slot_bytes=slot) == rule
            assert TK.tuned_geometry(
                nb, L, d, isz, *ptrs, bags_per_block=rule.bags_per_block,
                stages=rule.stages, slot_bytes=slot) == rule


def test_tuned_geometry_override_replaces_and_recounts():
    g = TK.tuned_geometry(513, 256, 32, 4, 16, bags_per_block=2, stages=3)
    assert g == TK.BagGeometry(257, 2, 3, 128, 16,
                               2 * (1024 + 3 * 32 * 128))
    g = TK.tuned_geometry(7, 8, 33, 2, 6, bags_per_block=1, stages=8,
                          slot_bytes=TK.LIST_BYTES)
    assert (g.blocks, g.vec, g.smem_bytes) == (7, 2, 2048 + 8 * 32 * 128)


@pytest.mark.parametrize("b,s,d,isz", [
    (0, 1, 32, 4), (3, 1, 32, 4), (1, 0, 32, 4), (1, 9, 32, 4),
    (2, 8, 128, 4), (2, 8, 160, 4), (-1, 2, 8, 2),
])
def test_tuned_geometry_refuses_what_no_kernel_can_launch(b, s, d, isz):
    for slot in (TK.SLOT_BYTES, TK.LIST_BYTES):
        with pytest.raises(ValueError):
            TK.tuned_geometry(64, 16, d, isz, bags_per_block=b, stages=s,
                              slot_bytes=slot)


def test_two_bags_of_eight_stages_at_d128_fp32_raises_on_the_host():
    # 2 x (1 KB + 8 x 16 KB) = 258 KB > 227 KB
    with pytest.raises(ValueError, match="264192 B"):
        TK.tuned_geometry(64, 16, 128, 4, bags_per_block=2, stages=8)
    # the CPU wrapper runs its plain version: no geometry there
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((40, 128))
                             .astype(np.float32))
    remap = torch.arange(40, dtype=torch.int32)
    idx = torch.from_numpy(rng.integers(-1, 40, (3, 4)).astype(np.int32))
    zero = torch.zeros(1, dtype=torch.int32)
    assert torch.equal(
        TK.banked_bag(table, remap, remap, zero, -1, idx, 1, (2, 8)),
        TK.banked_bag_plain(table, remap, remap, zero, -1, idx))


def test_every_listed_candidate_fits_at_every_suite_shape():
    suite = TA.default_signature_suite(device="cpu")
    full = TA.candidates(smoke=False, device="cuda")
    assert full == [("cuda", b, s) for b in (1, 2) for s in (1, 2, 4, 8)]
    assert TA.candidates(smoke=True, device="cuda") == [("cuda", 1, 2),
                                                        ("cuda", 1, 8)]
    for case in suite:
        for smoke in (False, True):
            listed = TA.case_candidates(case, smoke, "cuda")
            assert TA.case_candidates(case, smoke, "cpu") \
                == [("torch", 1, 1)]
            if case.sig.path == "tiered":
                assert listed == [("cuda", 1, 1)]
                continue
            for _, b, s in listed:
                case.geometry(b, s)                # raises if it does not fit
            dropped = set(TA.candidates(smoke, "cuda")) - set(listed)
            for _, b, s in dropped:
                with pytest.raises(ValueError):
                    case.geometry(b, s)
        if case.sig.dim == 128:
            assert ("cuda", 2, 8) not in TA.case_candidates(case)
        elif case.sig.path != "tiered":
            assert len(TA.case_candidates(case)) == 8
        assert case.rule() == (1, 1)             # every suite bag is short


# ---------------------------------------------------------------------------
# the CLIs on the CPU
# ---------------------------------------------------------------------------

def test_tune_cli_smoke_on_the_cpu(tmp_path):
    out = tmp_path / "t.json"
    assert TTUNE.main(["--smoke", "--out", str(out), "--device", "cpu"]) == 0
    doc = json.loads(out.read_text())
    keys = [c.sig.key() for c in JA.default_signature_suite()]
    assert sorted(doc["entries"]) == sorted(keys)
    assert doc["meta"]["arch"] == "cpu" and doc["meta"]["smoke"] is True
    for e in doc["entries"].values():
        assert (e["backend"], e["tile_b"], e["n_slots"]) == ("torch", 1, 1)
        assert e["best_us"] > 0 and e["torch_us"] == e["best_us"]
        assert e["cuda_us"] is None and e["default_us"] is None
    cache = TD.DispatchCache.load(str(out))
    assert TTUNE.self_check(cache, str(out)) == []


def test_tune_cli_refuses_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        TTUNE.main(["--smoke", "--out", str(tmp_path / "t.json")])
    assert not (tmp_path / "t.json").exists()


def test_self_check_catches_a_diverging_file(tmp_path):
    cache = TD.DispatchCache()
    sig = TD.signature("csr", vocab=9, dim=4, batch=2, bag_len="ragged")
    cache.record(sig, backend="cuda", tile_b=1, n_slots=2)
    out = tmp_path / "t.json"
    cache.save(str(out))
    assert TTUNE.self_check(cache, str(out)) == []
    cache.record(sig, backend="cuda", tile_b=2, n_slots=2)
    assert TTUNE.self_check(cache, str(out)) == [sig.key()]
    cache.record(TD.signature("csr", vocab=9, dim=4, batch=3,
                              bag_len="ragged"),
                 backend="cuda", tile_b=1, n_slots=1)
    assert len(TTUNE.self_check(cache, str(out))) == 1


def _spy(monkeypatch, module, name):
    seen = []
    real = getattr(module, name)

    def spy(*a, **kw):
        res = real(*a, **kw)
        seen.append((kw["backend"], res))
        return res
    monkeypatch.setattr(module, name, spy)
    return seen


def test_serve_cli_maps_auto_to_tuned(monkeypatch):
    seen = _spy(monkeypatch, TSERVE, "run")
    cache = TD.DispatchCache()
    TD.set_cache(cache)
    base = ["--arch", "updlrm-paper", "--requests", "6", "--batch", "4",
            "--device", "cpu"]
    for extra in ([], ["--backend", "tuned"], ["--backend", "torch"]):
        TSERVE.main(base + extra)
    assert [b for b, _ in seen] == ["tuned", "tuned", "torch"]
    assert cache.misses >= 4 and cache.hits == 0
    for _, res in seen[:2]:
        assert torch.equal(res.scores, seen[2][1].scores)


def test_train_cli_maps_auto_to_tuned(monkeypatch):
    seen = _spy(monkeypatch, TTRAIN, "run")
    cache = TD.DispatchCache()
    TD.set_cache(cache)
    base = ["--arch", "updlrm-paper", "--steps", "3", "--batch", "4",
            "--device", "cpu"]
    for extra in ([], ["--backend", "tuned"], ["--backend", "torch"]):
        TTRAIN.main(base + extra)
    assert [b for b, _ in seen] == ["tuned", "tuned", "torch"]
    assert cache.misses >= 6 and cache.hits == 0
    for _, res in seen[:2]:
        assert res.losses == seen[2][1].losses
        assert torch.equal(res.state.params["emb_packed"],
                           seen[2][1].state.params["emb_packed"])


def test_run_keeps_auto_as_its_default():
    import inspect
    for fn in (TSERVE.run, TSERVE.run_cached, TSERVE.run_adaptive,
               TTRAIN.run, TTRAIN.run_adaptive):
        assert inspect.signature(fn).parameters["backend"].default == "auto"
    spec = get_arch("updlrm-paper")
    assert spec.family == "dlrm"
