"""Batched serving with cache-aware partitioning on the PyTorch port: the
paper's Fig. 4 flow.

Pre-process stage: profile trace -> mine cache lists -> cache-aware
partition -> build partial-sum cache. Serving stage: requests are rewritten
(cache ids + residual ids) on the host and scored by the banked lookup
(the bag kernel on CUDA) + a CTR MLP; reports the time per batch with and
without the cache path. The port of ``examples/serve_updlrm.py``.

    PYTHONPATH=src python examples/torch_serve_updlrm.py [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.cache_runtime import (build_cache_table,
                                            measure_hit_rate, rewrite_bags)
from repro_torch.core.embedding import banked_embedding_bag, pack_table
from repro_torch.core.grace import mine_cooccurrence
from repro_torch.core.partitioning import cache_aware_partition
from repro_torch.data.synthetic import WORKLOADS, multihot_trace, padded_bags
from repro_torch.models.dlrm import _mlp_params, mlp_apply

N_ITEMS, DIM, BANKS, BATCH, PAD = 100_000, 32, 8, 64, 256


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    dev = resolve_device(ap.parse_args().device)

    print("== pre-process (Fig. 4 stage 0) ==")
    trace = multihot_trace(WORKLOADS["read"], 1200, n_items=N_ITEMS, seed=0)
    freq = np.zeros(N_ITEMS)
    for bag in trace:
        np.add.at(freq, bag, 1.0)
    cp = mine_cooccurrence(trace[:400], top_items=2048, max_groups=256)
    plan = cache_aware_partition(freq, cp.groups, cp.benefits, BANKS)
    print(f"   groups={len(cp.groups)} hit_rate="
          f"{measure_hit_rate(trace[:200], cp):.1%} "
          f"imbalance={plan.imbalance():.2f}")

    rng = np.random.default_rng(0)
    table = rng.standard_normal((N_ITEMS, DIM)).astype(np.float32)
    bt = pack_table(table, plan, device=dev)
    cache_tab = torch.from_numpy(build_cache_table(table, cp)).to(dev)
    top = _mlp_params(torch.Generator(device=dev).manual_seed(1),
                      [DIM, 256, 64, 1], torch.float32, dev)

    def serve_plain(bags):
        emb = banked_embedding_bag(bt, bags)
        return torch.sigmoid(mlp_apply(top, emb)[:, 0])

    def serve_cached(cache_idx, resid_idx):
        valid = cache_idx >= 0
        emb = cache_tab[torch.where(valid, cache_idx, 0).long()] \
            * valid[..., None]
        emb = emb.sum(1) + banked_embedding_bag(bt, resid_idx)
        return torch.sigmoid(mlp_apply(top, emb)[:, 0])

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def bench(fn, *a, iters=20):
        fn(*a)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*a)
        sync()
        return (time.perf_counter() - t0) / iters * 1e3, out

    print(f"== serving ({dev.type}) ==")
    reqs = trace[400:400 + BATCH]
    bags = torch.from_numpy(padded_bags(reqs, PAD)).to(dev)
    ci, ri = rewrite_bags(reqs, cp, max_cache_per_bag=16,
                          max_residual_per_bag=PAD)
    ci, ri = torch.from_numpy(ci).to(dev), torch.from_numpy(ri).to(dev)
    # plain bags may repeat an item; the rewritten path dedupes: compare
    # against the deduplicated bags
    uniq = torch.from_numpy(
        padded_bags([np.unique(b) for b in reqs], PAD)).to(dev)
    with torch.inference_mode():
        t_plain, _ = bench(serve_plain, bags)
        t_cached, s_cached = bench(serve_cached, ci, ri)
        s_plain_u = serve_plain(uniq)
    print(f"   plain lookup      : {t_plain:.2f} ms/batch")
    print(f"   cache-aware lookup: {t_cached:.2f} ms/batch "
          f"({t_plain / t_cached:.2f}x)")
    print(f"   scores match: "
          f"{torch.allclose(s_plain_u, s_cached, atol=1e-3)}")


if __name__ == "__main__":
    main()
