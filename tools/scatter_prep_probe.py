#!/usr/bin/env python3
"""Probe of the backward scatter's prep on one CUDA card: the card's three
steps (``csrc/scatter_prep.cu``: ``scatter_labels``, then ``scatter_runs``'s
key-value radix sort and run table) beside the op-by-op prep
(``scatter_prep(..., plain=True)``), at ``paper-train``'s shape.

    python3 tools/scatter_prep_probe.py [--batch 65536] [--reps 10]
                                        [--out build/scatter_prep_probe.json]

The ids are ``paper-train``'s (``portbench/traffic/paper-train.json``
through its generator, seed ``--seed``): ``--batch`` samples x 8 fields x
256 entries of Zipf(1.18) ids with Poisson(245.8) bag lengths, over
updlrm-paper's 8 x 2,360,650 rows, scattered over 8 banks by a random
remap (every bank owning, my = -1). It checks the two preps' five arrays
bit for bit, then times in turns (CUDA events, median of ``--reps``): the
op-by-op prep, the card's prep, its label kernel alone and its sort and
run table alone (on fresh copies of the labels, made outside the events),
the zero fill of the (n_rows, 32) fp32 gradient and the scatter kernel on
the runs; and reports each prep's peak of device memory, the device time
of the card prep's kernels by name (``torch.profiler``) and its byte
bound: the ids read, each live run's slot read once, bag_sorted, run_of,
run_starts and run_slot written, at 3.35 TB/s.

For the scatter's span blocks it reports the longest run's length, the
share of entries in runs of more than 64 (the span blocks' share), the
span kernel's ns an entry on the longest run (the scatter on that run
alone, CUDA events; and the ``ct_scatter_spans`` kernel's device time in
the whole scatter over the longest run) beside the run's add chain: its
entries x 4 cycles (one dependent fp32 add each) at the SM clock that
``nvidia-smi`` reads while the run is timed, else at 1.98 GHz, and says
which.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

HBM_BYTES_S = 3.35e12
ADD_CYCLES = 4          # a dependent fp32 add on the card
MAX_SM_MHZ = 1980       # the H100 SXM's boost clock


def _ids(batch: int, seed: int, dev):
    import torch
    from portbench.generators.zipf_bags import Traffic
    cfg = json.loads((ROOT / "portbench/configs/updlrm-paper.json")
                     .read_text())
    mix = json.loads((ROOT / "portbench/traffic/paper-train.json")
                     .read_text())
    sparse = Traffic(cfg, mix, dev).batch(seed, 0, batch)["sparse"]
    off = torch.tensor([0] + list(cfg["vocab_sizes"][:-1]), device=dev
                       ).cumsum(0).to(torch.int32)
    return sparse.reshape(-1, sparse.shape[-1]).contiguous(), off, cfg


def _remap(cfg, dev, pad=1000):
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    V, banks = sum(cfg["vocab_sizes"]), cfg["plan"]["n_banks"]
    per = -(-V // banks) + pad
    slot = torch.randperm(banks * per, generator=g, device=dev)[:V]
    return (slot // per).to(torch.int32), slot.to(torch.int32), banks * per


def _sm_mhz(fn) -> list[int]:
    """Run ``fn()`` with ``nvidia-smi`` reading the SM clock every 20 ms;
    the MHz it read (empty when it read none)."""
    try:
        proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "20"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    except OSError:
        fn()
        return []
    try:
        fn()
    finally:
        proc.terminate()
        out, _ = proc.communicate()
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _peak(fn) -> int:
    import torch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    del out
    return peak


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="build/scatter_prep_probe.json")
    args = ap.parse_args(argv)
    import torch
    from chip_smoke import time_ms
    from kernel_probe import subset_runs
    from repro_torch.kernels import _build
    from repro_torch.kernels import embedding_bag as K
    if not torch.cuda.is_available():
        print("scatter_prep_probe: needs a CUDA card")
        return 1
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(f"card: {card}")
    logs = _build.build(("scatter_prep", "ct_scatter"))
    for name, log in logs.items():
        print(f"--- nvcc {name}.cu ---\n{log}")
    idx, off, cfg = _ids(args.batch, args.seed, dev)
    bank, slot, n_rows = _remap(cfg, dev)
    NB, L = idx.shape
    E = NB * L
    res = {"card": card, "batch": args.batch, "entries": E,
           "n_rows": n_rows, "end_bit": K.label_bits(n_rows)}

    def op_by_op():
        return K.scatter_prep(idx, bank, slot, off, -1, n_rows, plain=True)

    def on_card():
        return K.scatter_prep(idx, bank, slot, off, -1, n_rows)

    want, got = op_by_op(), on_card()
    torch.cuda.synchronize()
    same = {f: bool(torch.equal(g, w))
            for f, g, w in zip(K.ScatterRuns._fields, got, want)}
    res["bit_equal"] = same
    n_run, n_valid = int(want.n_run[0]), int(want.run_starts[-1])
    lens = want.run_starts[1:n_run + 1] - want.run_starts[:n_run]
    res.update(n_run=n_run, n_valid=n_valid, longest_run=int(lens.max()),
               span_entry_share=int(lens[lens > 64].sum()) / n_valid)
    hottest = lens == lens.max()
    hottest &= torch.cumsum(hottest.int(), 0) == 1    # the first longest
    bound_bytes = E * 4 + n_run * 4 + E * 4 * 4 + 4 * 2
    res["bound_bytes"] = bound_bytes
    res["bound_ms"] = bound_bytes / HBM_BYTES_S * 1e3
    print(f"E {E:,}, n_rows {n_rows:,}, runs {n_run:,}, live {n_valid:,}, "
          f"bit equal {same}")
    del want, got

    labels = K.scatter_labels(idx, bank, slot, off, -1, n_rows)
    pool = [None]

    def fresh():
        pool[0] = (labels[0].clone(), labels[1].clone())

    def runs_alone():
        return K.scatter_runs(*pool[0], n_rows, K.label_bits(n_rows))

    runs = on_card()
    ct = torch.randn((NB, cfg["embed_dim"]), device=dev)
    out = torch.zeros((n_rows, cfg["embed_dim"]), device=dev)
    timed = {}
    for turn in range(2):       # op-by-op, card, card, op-by-op
        order = ["op_by_op", "card"] if turn == 0 else ["card", "op_by_op"]
        for name in order:
            fn = op_by_op if name == "op_by_op" else on_card
            timed.setdefault(f"{name}_ms", []).append(
                time_ms(fn, reps=args.reps))
    timed["label_ms"] = [time_ms(lambda: K.scatter_labels(
        idx, bank, slot, off, -1, n_rows), reps=args.reps)]
    timed["sort_and_table_ms"] = [time_ms(runs_alone, reps=args.reps,
                                          flush=fresh)]
    timed["zero_fill_ms"] = [time_ms(out.zero_, reps=args.reps)]
    timed["scatter_ms"] = [time_ms(lambda: K.ct_scatter_launch(ct, runs, out),
                                   reps=args.reps, flush=out.zero_)]
    one = subset_runs(runs, hottest)
    mhz = _sm_mhz(lambda: timed.setdefault("longest_run_alone_ms", []).append(
        time_ms(lambda: K.ct_scatter_launch(ct, one, out), reps=args.reps,
                flush=out.zero_)))
    res["ms"] = {k: statistics.median(v) for k, v in timed.items()}
    res["ms_turns"] = timed
    res["peak_bytes"] = {"op_by_op": _peak(op_by_op), "card": _peak(on_card)}
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    on_card()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        on_card()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t and ev.key and not ev.key.startswith(("cuda", "aten::",
                                                   "Memcpy", "Memset")):
            kernels[ev.key[:120]] = t / 1e3
    res["card_kernels_ms"] = dict(sorted(kernels.items(),
                                         key=lambda kv: -kv[1]))
    out.zero_()
    with torch.profiler.profile(activities=acts) as prof:
        K.ct_scatter_launch(ct, runs, out)
        torch.cuda.synchronize()
    spans_ms = sum(getattr(ev, "device_time_total", None)
                   or getattr(ev, "cuda_time_total", 0)
                   for ev in prof.key_averages()
                   if "ct_scatter_spans" in ev.key) / 1e3
    n = res["longest_run"]
    clock = statistics.median(mhz) if mhz else MAX_SM_MHZ
    res["span"] = {
        "longest_run": n,
        "span_entry_share": res["span_entry_share"],
        "ns_an_entry_alone": res["ms"]["longest_run_alone_ms"] * 1e6 / n,
        "spans_kernel_ms_in_scatter": spans_ms,
        "ns_an_entry_in_scatter": spans_ms * 1e6 / n,
        "sm_mhz": clock,
        "sm_mhz_from": (f"nvidia-smi, {len(mhz)} readings "
                        f"{min(mhz)}-{max(mhz)}" if mhz
                        else "none read: the H100 SXM's 1,980 MHz boost"),
        "chain_floor_ms": n * ADD_CYCLES / (clock * 1e6) * 1e3,
        "chain_floor_ns_an_entry": ADD_CYCLES / (clock * 1e6) * 1e9,
    }
    res["launches"] = {"scatter_labels": K.scatter_labels.launches,
                       "scatter_runs": K.scatter_runs.launches}
    for k, v in res["ms"].items():
        print(f"  {k:20s} {v:9.4f}")
    print(f"  bound {res['bound_ms']:.4f} ms ({bound_bytes / 1e9:.3f} GB); "
          f"peak GB {res['peak_bytes']['op_by_op'] / 1e9:.2f} op-by-op, "
          f"{res['peak_bytes']['card'] / 1e9:.2f} card")
    for k, v in res["card_kernels_ms"].items():
        print(f"  {v:9.4f} ms  {k}")
    print("  span blocks: " + json.dumps(res["span"]))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
