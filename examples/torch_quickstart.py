"""Quickstart on the PyTorch port: the paper's full pipeline on one host.

1. generate a Table-1-style skewed multi-hot trace,
2. mine co-occurrence groups (GRACE-lite) and build the partial-sum cache,
3. partition the embedding table three ways (uniform / non-uniform /
   cache-aware, §3.1-3.3) and compare realized bank balance,
4. run the banked (PIM-style) lookup and verify it matches a plain
   EmbeddingBag, then the cache-rewritten lookup (Fig. 7).

The port of ``examples/quickstart.py``: the lookups run on ``--device``
(the bag kernel on CUDA, its plain version on the CPU).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cache_runtime import (build_cache_table,
                                            measure_hit_rate, rewrite_bags)
from repro_torch.core.embedding import banked_embedding_bag, pack_table
from repro_torch.core.grace import mine_cooccurrence
from repro_torch.core.partitioning import (cache_aware_partition,
                                           non_uniform_partition,
                                           uniform_partition)
from repro_torch.data.synthetic import WORKLOADS, multihot_trace, padded_bags
from repro_torch.sparse.ops import embedding_bag_fixed

N_ITEMS, DIM, N_BANKS, BATCH = 50_000, 32, 8, 64


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    dev = resolve_device(ap.parse_args().device)

    print("== 1. workload (GoodReads profile, Table 1) ==")
    trace = multihot_trace(WORKLOADS["read"], 1000, n_items=N_ITEMS, seed=0)
    freq = np.zeros(N_ITEMS)
    for bag in trace:
        np.add.at(freq, bag, 1.0)
    print(f"   {len(trace)} samples, avg bag "
          f"{np.mean([len(b) for b in trace]):.0f}, hottest item freq "
          f"{freq.max():.0f} vs median {np.median(freq):.0f}")

    print("== 2. GRACE-lite mining ==")
    cp = mine_cooccurrence(trace[:400], top_items=2048, max_groups=128)
    hit = measure_hit_rate(trace[:200], cp)
    print(f"   {len(cp.groups)} groups, {cp.n_entries} cached partial sums, "
          f"hit rate {hit:.1%}")

    print("== 3. partitioning (§3.1-3.3) ==")
    plans = {
        "uniform": uniform_partition(N_ITEMS, N_BANKS, freq),
        "non-uniform": non_uniform_partition(freq, N_BANKS),
        "cache-aware": cache_aware_partition(freq, cp.groups, cp.benefits,
                                             N_BANKS),
    }
    for name, plan in plans.items():
        print(f"   {name:12s} load imbalance (max/mean) = "
              f"{plan.imbalance():.3f}")

    print(f"== 4. banked lookup == plain EmbeddingBag ({dev.type}) ==")
    rng = np.random.default_rng(0)
    table = rng.standard_normal((N_ITEMS, DIM)).astype(np.float32)
    bt = pack_table(table, plans["cache-aware"], device=dev)
    table_t = torch.from_numpy(table).to(dev)
    idx = torch.from_numpy(padded_bags(trace[:BATCH], 300)).to(dev)
    with torch.inference_mode():
        banked = banked_embedding_bag(bt, idx)
        plain = embedding_bag_fixed(table_t, idx)
    print(f"   allclose: {torch.allclose(banked, plain, atol=1e-4)}")

    print("== 5. cache-rewritten lookup (Fig. 7) ==")
    ctab = torch.from_numpy(build_cache_table(table, cp)).to(dev)
    ci, ri = rewrite_bags(trace[:BATCH], cp, max_cache_per_bag=16,
                          max_residual_per_bag=300)
    # bag sums count unique items once; compare against deduped plain bags
    uniq = [np.unique(b) for b in trace[:BATCH]]
    with torch.inference_mode():
        cached = embedding_bag_fixed(ctab, torch.from_numpy(ci).to(dev)) \
            + embedding_bag_fixed(table_t, torch.from_numpy(ri).to(dev))
        plain_u = embedding_bag_fixed(
            table_t, torch.from_numpy(padded_bags(uniq, 300)).to(dev))
    print(f"   cache path reconstructs bag sums: "
          f"{torch.allclose(cached, plain_u, atol=1e-3)}")
    print(f"   row reads saved by cache: {hit:.1%}")
    print("done.")


if __name__ == "__main__":
    main()
