"""Partition explorer on the PyTorch port: sweep the §3.1 layout (N_c) and
the three partitioners across all six Table-1 workloads under the analytic
UPMEM model, and print each workload's optimum the way UpDLRM's auto-tuner
picks it.

The port of ``examples/partition_explorer.py``, on host numpy only: it runs
no kernel and takes no device. ``workload_stats`` and ``plan_shares`` are
copies of ``benchmarks/common.py``'s, at its reduced item count.

    PYTHONPATH=src python examples/torch_partition_explorer.py
"""
import numpy as np

from repro_torch.core.cache_runtime import measure_hit_rate
from repro_torch.core.grace import mine_cooccurrence
from repro_torch.core.hwmodel import embedding_stage_latency, updlrm_layout
from repro_torch.core.partitioning import (cache_aware_partition,
                                           non_uniform_partition,
                                           uniform_partition)
from repro_torch.data.synthetic import WORKLOADS, multihot_trace

# reduced item counts keep the trace seconds-fast; the popularity shape
# (zipf_a, avg_reduction) is the paper's
BENCH_ITEMS = 200_000
BENCH_SAMPLES = 2000
BANKS_PER_TABLE, C, BATCH = 32, 32, 64
N_CS = (2, 4, 8)
PARTITIONERS = ("U", "NU", "CA")


def workload_stats(key: str, seed: int = 0) -> dict:
    """A workload's trace, item frequencies, mined cache plan and cache hit
    rate: the trace-derived inputs of the latency model."""
    prof = WORKLOADS[key]
    trace = multihot_trace(prof, BENCH_SAMPLES, seed=seed,
                           n_items=BENCH_ITEMS)
    freq = np.zeros(BENCH_ITEMS)
    for bag in trace:
        np.add.at(freq, bag, 1.0)
    cp = mine_cooccurrence(trace[:500], top_items=2048, max_groups=256,
                           min_support=3)
    return {"profile": prof, "trace": trace, "freq": freq,
            "hit_rate": measure_hit_rate(trace[:300], cp), "cache_plan": cp}


def plan_shares(stats: dict, partitioner: str, n_bins: int):
    """(per-bin lookup shares summing to 1, the plan) of ``partitioner``:
    'U' uniform (§3.1), 'NU' non-uniform (§3.2), 'CA' cache-aware (§3.3)."""
    freq = stats["freq"]
    if partitioner == "U":
        plan = uniform_partition(len(freq), n_bins, freq)
    elif partitioner == "NU":
        plan = non_uniform_partition(freq, n_bins)
    elif partitioner == "CA":
        cp = stats["cache_plan"]
        plan = cache_aware_partition(freq, cp.groups, cp.benefits, n_bins)
    else:
        raise ValueError(partitioner)
    tot = plan.load_per_bank.sum()
    return plan.load_per_bank / max(tot, 1e-9), plan


def stage_us(stats: dict, partitioner: str) -> list[float]:
    """The modeled embedding-stage time (µs) of a batch at each N_c."""
    p = stats["profile"]
    out = []
    for n_c in N_CS:
        rg, _ = updlrm_layout(BANKS_PER_TABLE, C, n_c)
        shares, _ = plan_shares(stats, partitioner, rg)
        out.append(embedding_stage_latency(
            batch_size=BATCH, avg_reduction=p.avg_reduction, n_c=n_c,
            per_bank_lookup_share=shares,
            cache_hit_rate=stats["hit_rate"] if partitioner == "CA" else 0.0,
        ).total * 1e6)
    return out


def main() -> None:
    print(f"{'workload':8s} {'part':4s} " +
          " ".join(f"Nc={n:<2d}" for n in N_CS) + "   best")
    for key in WORKLOADS:
        st = workload_stats(key)
        for name in PARTITIONERS:
            cells = stage_us(st, name)
            i = int(np.argmin(cells))
            print(f"{key:8s} {name:4s} " +
                  " ".join(f"{c:6.0f}" for c in cells) +
                  f"   Nc={N_CS[i]} ({cells[i]:.0f}us)")


if __name__ == "__main__":
    main()
