"""The DLRM-DCNv2 family (``models/dlrm_dcn.py``, ``reference/dlrm_dcn.py``,
``generators/field_bags.py``, ``counts/dlrm_dcn.py``) and its cell
``dcnv2-bulk`` on the CPU at small sizes: the table made in chunks is the
same bits in the program and the reference; the benchmark's reference is
the tests' (``tests/torch_ref_dlrm_dcn.py``); the traffic has each field's
exact bag size and the same work under every seed; a sound run is correct
and the control and a wrong answer are not; the new readers read their
records and nothing on the other cells; the counts at full size."""
import importlib.util
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import drive, program_spans
from portbench import run as RUN
from portbench.counts import PEAKS
from portbench.run import cell_parts
from portbench.tests.small import small_parts
from repro_torch.obs import tracing

ROOT = Path(__file__).resolve().parents[2]
CELL = "dcnv2-bulk"
SEED = 2_147_483_659


def _tests_reference():
    spec = importlib.util.spec_from_file_location(
        "torch_ref_dlrm_dcn", ROOT / "tests" / "torch_ref_dlrm_dcn.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_table_made_in_chunks_is_the_reference_s():
    p = small_parts(CELL)
    assert sum(p.cfg["vocab_sizes"]) > 4 * p.cfg["chunk_rows"]
    model = drive.load("models", "dlrm_dcn")
    R = drive.load("reference", "dlrm_dcn")
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    w = R.make_weights(p.cfg, SEED, "cpu")
    got = model.param_leaves(st.prog.params)
    remap = st.prog.statics["remap_flat"].long()
    assert got["table"].dtype == torch.bfloat16
    assert torch.equal(got["table"][remap], w["table"])
    pad = torch.ones(got["table"].shape[0], dtype=torch.bool)
    pad[remap] = False
    assert not got["table"][pad].any()
    n = 0
    for m in ("bot", "cross", "top"):
        for k, ts in w[m].items():
            for i, t in enumerate(ts):
                assert torch.equal(got[f"{m}.{k}{i}"], t)
                n += 1
    layers = len(p.cfg["bot_mlp"]) + len(p.cfg["top_mlp"]) + 1
    assert n == 2 * layers + 3 * p.cfg["cross_layers"] and len(got) == n + 1
    # another seed, another table
    assert not torch.equal(R.make_weights(p.cfg, SEED + 1, "cpu")["table"],
                           w["table"])


def test_the_benchmark_reference_is_the_tests_reference():
    p = small_parts(CELL)
    R = drive.load("reference", "dlrm_dcn")
    ref = _tests_reference()
    w = R.make_weights(p.cfg, SEED, "cpu")
    b = drive.load("generators", "field_bags").Traffic(
        p.cfg, p.mix, "cpu").batch(SEED, 0, 64)
    b["sparse"][0, :9] = -1                    # holes count for nothing
    got = R.scores(p.cfg, w, b, block=24)
    want = torch.sigmoid(ref.forward(w, b["dense"], b["sparse"],
                                     p.cfg["multi_hot_sizes"],
                                     p.cfg["vocab_sizes"]))
    torch.testing.assert_close(got, want, rtol=0, atol=1e-7)
    cut = ref.forward(w, b["dense"], b["sparse"], p.cfg["multi_hot_sizes"],
                      p.cfg["vocab_sizes"], cross_layers=2)
    assert float((torch.sigmoid(cut) - got).abs().max()) > 1e-5


def test_the_traffic_has_exact_bags_and_the_same_work():
    p = cell_parts(CELL)
    assert p.mix["batch"] == 65536 and p.mix["pool_batches"] == 4
    assert p.mix["ids"] == {"dist": "zipf", "exponent": 0.9,
                            "permute": "per_field", "catalog_seed": 0}
    sizes = p.cfg["multi_hot_sizes"]
    assert len(sizes) == 26 and sum(sizes) == 214
    assert sizes == [3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1,
                     1, 12, 100, 27, 10, 3, 1, 1]
    s = small_parts(CELL)
    gen = drive.load("generators", "field_bags")
    a, b, c = (gen.Traffic(s.cfg, s.mix, "cpu").batch(x, 1, 96)
               for x in (SEED, SEED, SEED + 1))
    assert a["sparse"].shape == (96, 214) and a["sparse"].dtype == torch.int32
    assert a["dense"].shape == (96, 13)
    assert torch.equal(a["sparse"], b["sparse"])
    assert torch.equal(a["dense"], b["dense"])
    assert not torch.equal(a["sparse"], c["sparse"])
    col = 0
    for n, v in zip(sizes, s.cfg["vocab_sizes"]):
        for x in (a, c):
            ids = x["sparse"][:, col:col + n]
            assert int(ids.min()) >= 0 and int(ids.max()) < v
        col += n
    with pytest.raises(ValueError, match="bags"):
        gen.Traffic(s.cfg, dict(s.mix, bags={"dist": "poisson"}), "cpu")


def test_a_sound_run_is_correct_and_the_faults_are_not(monkeypatch):
    p = small_parts(CELL)
    out, lines = RUN.run_cell(CELL, SEED, 0.3, False, device="cpu", parts=p)
    assert out["correct"], lines
    assert set(out["metrics"]) == {"score_rate", "setup_s"}
    assert out["failed"] == 0 and out["attempted"] > 0
    mode = drive.load("modes", "bulk")
    st = drive.build(p.cfg, p.mix, SEED, "cpu")
    run = mode.run(st, 0.2, False, lambda: None)
    ctl = mode.check(st, run, **mode.CONTROLS["control"])
    assert ctl["score_gap"] > p.limits["score_gap"], ctl
    build = drive.build

    def broken_build(*a, **k):
        st = build(*a, **k)
        serve = st.prog.serve

        def altered(params, batch):
            return serve(params, batch) + 1e-3
        st.prog.serve = altered
        return st
    monkeypatch.setattr(drive, "build", broken_build)
    out, lines = RUN.run_cell(CELL, SEED, 0.3, False, device="cpu", parts=p)
    assert not out["correct"], lines


def test_the_port_without_the_dcn_path_fails_before_the_table(monkeypatch):
    from repro_torch.models import dlrm
    p = small_parts(CELL)
    model = drive.load("models", "dlrm_dcn")

    def old_config(*a, interaction="dot", cross_layers=None, **k):
        raise TypeError("DLRMConfig.__init__() got an unexpected keyword "
                        "argument 'cross_layers'")
    monkeypatch.setattr(dlrm, "DLRMConfig", old_config)
    made = []
    monkeypatch.setattr(model, "table_chunks",
                        lambda *a: made.append(1) or iter(()))
    with pytest.raises(TypeError, match="cross_layers"):
        model.setup(p.cfg, SEED, None, "cpu")
    with pytest.raises(TypeError, match="cross_layers"):
        model.build_kernels(p.cfg)
    assert not made


def _tracer(steps: int, name: str, ms):
    tr = tracing.Tracer()
    R = tracing.SpanRecord
    for i in range(steps):
        tr.records.append(R("serve.step", 100.0 * i, 90.0, 1, 0, {},
                            span_id=10 * i + 1, step=10 * i + 1))
    for i, m in enumerate(ms):
        tr.records.append(R(name, 100.0 * i + 1, 20.0, 1, 1, {},
                            span_id=10 * i + 2, parent=10 * i + 1,
                            step=10 * i + 1, device_ms=m))
    return tr


def _ctx(cell, mode="bulk", summary=None, **run):
    p = cell_parts(cell)
    return SimpleNamespace(cfg=p.cfg, mix=p.mix, summary=summary,
                           run=SimpleNamespace(mode=mode, batch=p.mix.get(
                               "batch"), **run))


def test_cross_readers(monkeypatch):
    tr = _tracer(4, "dlrm.cross", [30.0, 31.0, 29.0, 30.0])
    monkeypatch.setattr(program_spans, "tracer", lambda ctx: tr)
    ms = drive.load("metrics", "cross_ms.bulk").read(_ctx(CELL))
    assert ms == pytest.approx(30.0)
    roof = drive.load("metrics", "cross_roofline.bulk").read(_ctx(CELL))
    B, N, r = 65536, 3456, 512
    flops = 3 * B * (4 * N * r + 3 * N)
    assert flops == pytest.approx(1.3936e12, rel=1e-4)
    assert roof == pytest.approx(100.0 * flops / PEAKS["fp32_flops"]
                                 / 30e-3, rel=1e-12)
    # another mode, another cell's model (no cross network), no spans
    assert drive.load("metrics", "cross_ms.bulk").read(
        _ctx(CELL, mode="train")) is None
    for cell in ("paper-bulk", "rm2-bulk"):
        assert drive.load("metrics", "cross_roofline.bulk").read(
            _ctx(cell)) is None
    monkeypatch.setattr(program_spans, "tracer",
                        lambda ctx: _tracer(4, "dlrm.lookup", [1.0]))
    for name in ("cross_ms.bulk", "cross_roofline.bulk"):
        assert drive.load("metrics", name).read(_ctx(CELL)) is None


def test_csr_roofline_reader():
    from portbench.trace import TraceSummary
    p = small_parts(CELL)
    gen = drive.load("generators", "field_bags").Traffic(p.cfg, p.mix, "cpu")
    batches = [gen.batch(SEED, i, 64) for i in range(2)]
    C = drive.load("counts", "dlrm_dcn")
    kernel = "void (anonymous namespace)::csr_bag_kernel<__nv_bfloat16, " \
             "float, 4, 16>(...)"
    s = TraceSummary({kernel: 2e-3, "other": 5.0}, 1.0, 1.0, {})
    ctx = SimpleNamespace(cfg=p.cfg, summary=s, run=SimpleNamespace(
        mode="bulk", batch=64, batches=batches, used=[3, 2]))
    got = drive.load("metrics", "csr_roofline.bulk").read(ctx)
    least = sum(u * C.bound_s(*C.csr_bytes_ops(
        p.cfg, 64, **C.batch_counts(p.cfg, b["sparse"]))) for b, u in
        zip(batches, [3, 2]))
    assert got == pytest.approx(100.0 * least / 2e-3, rel=1e-12)
    n = C.batch_counts(p.cfg, batches[0]["sparse"])
    assert n["n_valid"] == 64 * 214
    offs = torch.tensor([0, *p.cfg["vocab_sizes"][:-1]]).cumsum(0)
    rows = batches[0]["sparse"].long() + torch.repeat_interleave(
        offs, torch.tensor(p.cfg["multi_hot_sizes"]))
    assert n["n_rows"] == len(set(rows.flatten().tolist()))
    # no CSR kernel in the trace, another cell's model, or no trace
    ctx.summary = TraceSummary({"banked_bag_kernel<float>": 1.0}, 1.0, 1.0,
                               {})
    assert drive.load("metrics", "csr_roofline.bulk").read(ctx) is None
    ctx.summary = s
    ctx.cfg = cell_parts("paper-bulk").cfg
    assert drive.load("metrics", "csr_roofline.bulk").read(ctx) is None
    ctx.cfg, ctx.summary = p.cfg, None
    assert drive.load("metrics", "csr_roofline.bulk").read(ctx) is None


def test_the_counts_at_full_size():
    p = cell_parts(CELL)
    model = drive.load("models", "dlrm_dcn")
    C = drive.load("counts", "dlrm_dcn")
    assert C.dense_params(p.cfg) == 16_044_545
    assert model.model_flops(p.cfg, 65536) == 32_089_090 * 65536
    assert model.model_flops(p.cfg, 1, train=True) == 3 * 32_089_090
    T, NB = 65536 * 214, 65536 * 26
    assert C.csr_bytes_ops(p.cfg, 65536, n_valid=T, n_rows=1000) == (
        T * 4 + (NB + 1) * 4 + 1000 * (4 + 256) + NB * 128 * 4, T * 128)
    # the port's meta count of the same call, every row distinct
    from repro_torch.kernels import cost
    assert C.csr_bytes_ops(p.cfg, 65536, n_valid=T, n_rows=T) == \
        cost.meta_csr_bag_cost(T, NB, 128, 2, n_remap=10 ** 9,
                               n_table_rows=10 ** 9, out_itemsize=4)
    from repro_torch.models.dlrm import DLRMConfig
    cfg = model.port_config(p.cfg)
    assert isinstance(cfg, DLRMConfig)
    assert cfg.param_count() - cfg.total_vocab * 128 == 16_044_545
    assert p.cfg["reduced"] == [] and "assumed" in p.cfg
