#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths — the paper's CTR serving, and training, of
the full-width ``updlrm-paper`` DLRM (8 multi-hot fields of 2,360,650 rows,
dim 32, bags of 256) — and holds every kernel on them against its plain
PyTorch version on the card:

  1. device: card name and power limit (nvidia-smi), TF32 off;
  2. kernels: builds ``src/repro_torch/kernels/csrc/*.cu`` (one nvcc each,
     in parallel); checks the banked-bag kernel bit for bit against its
     plain version at the main-path shape over an 8-bank §3.2 plan of the
     GoodReads popularity (flat remap, one owned bank, a dead bank, bf16,
     ragged bags) and, in all three instances (single copy, replica select
     at k_max 2 and 4, identity), on cases shaped against its
     shared-memory ring (``bag_adversarial_cases``: D from 1 to 160 in
     fp32 and bf16, L from 1 to 1,000, all-padding bags, NB not a multiple
     of the bags per block, an unaligned table, my = -1, 3 and 0 on a live
     map); the batch entries of the dot-interaction kernel (z, and the
     fused ``[dots | x]`` the model uses) and its query entry (retrieval's:
     one query against N candidate rows, its query-only columns equal
     across the rows) to atol = rtol = 1e-5; times kernel,
     plain version and one library call with CUDA events, beside the least
     time the card could take (``bound_ms``);
  3. serve: ``launch.serve.run`` at full width with every launch counter
     set to 0 just before and read just after (the bag kernel and the
     interaction's fused entry must have run, its z entry must not: so in
     phases 4-7);
     re-scores the last batch with the plain versions; checks a reduced
     config against a CPU run on the same weights; times the serve step's
     stages;
  4. train: ``launch.train.run`` at full width for a few steps with every
     launch counter set to 0 just before and read just after (all three
     kernels must have run); holds the sorted-run scatter kernel (the bag
     sums' backward) bit for bit against its plain version at the train
     path's shape, on the phase-2 cases and on run layouts that its tiles
     and span blocks split (one run of every entry; runs around 32, 64
     and 1,024 entries; a long run in the last live slot; 40 long runs
     back to back; no live run) at D = 1 to 160 and in both dtype mixes,
     and its prep on the card against the prep on the CPU; times it on the
     train ids and on Zipf ids beside its bound and one ``index_add_``;
     checks that the losses are finite, that a batch
     repeated lowers its loss, that one step's table gradient equals the
     plain scatter of the same cotangent, and that the table and the bottom
     MLP get gradients; times the train step's stages; checks a reduced
     config's losses on the card against the CPU on the same weights;
  5. cache-aware serve (§3.3, Fig. 7): ``launch.serve.run_cached`` at full
     width (64 profiling requests mined into GRACE groups, the cache-aware
     plan, the capped partial-sum table; 256 served requests rewritten on
     the host) with every launch counter set to 0 just before and read just
     after (the fused kernel and the interaction must have run, the plain
     bag kernel must not); holds the fused cache+residual kernel bit for
     bit against its plain version (the served ids, with holes, my = 3, a
     dead bank, bf16, ragged bags) and, in both instances, on cases shaped
     against its ``cp.async`` ring (``cache_adversarial_cases``: D from 1
     to 160 in fp32 and bf16, live lists of 0 to 584 rows across a
     512-entry round, one stream live or of no columns, padding only,
     unaligned tables, my = -1, 3 and 0 on a live map); checks both
     tables' gradients and the
     scatter's two dtype mixes against the plain scatter bit for bit; the
     cached scores against the plain path on the deduplicated bags; a
     reduced config on the card against the CPU; times the kernel beside
     its bound and one ``F.embedding_bag``, the cached serve step, and the
     host's share (``next_batch``, the rewrite, the serve call); then the
     identity-layout drop-in ``kernels.ops.cache_bag`` (kernel 8) on the
     served streams resolved through their remaps, with its launch counter
     set to 0 just before and read just after: equal bit for bit to the
     fused kernel on the raw streams and to its plain version (and on
     small bf16 / ragged cases), timed beside its bound and two
     ``F.embedding_bag`` calls summed;
  6. adaptive serve with tiered-precision tables: ``launch.serve.run_adaptive``
     at full width with ``quant='int4'`` (192 drifting-Zipf requests at batch
     64, a drift check every 2 batches: telemetry -> replan -> live
     migration -> re-tier -> swap) with every launch counter set to 0 just
     before and read just after (the tiered kernel and the interaction must
     have run, the other bag kernels must not); at least one swap, shapes
     stable, the first re-tier equal to a fresh build; holds the tiered
     kernel bit for bit against its plain version (the served ids under the
     live tier map, with holes, my = 3, a dead bank; int8-only, fp32-hot,
     D = 160 and ragged D = 33 tables; tables shaped against its chunking:
     tiers mixed in every chunk, L = 300, L x D past its staging buffer,
     int4-only D = 33, fp32-hot D = 160, D = 300); the traffic counters against their
     host twins; the last batch against the plain lookup; a reduced config's
     adaptive run on the card against the CPU swap for swap; times the
     kernel beside its bound, its plain version and a reference point
     (``F.embedding_bag`` over rows dequantized beforehand), the tiered
     serve step, and the host's share (``next_batch`` with its telemetry
     tap, the serve call, the swaps);
  7. adaptive serve with the hot-row replica lane:
     ``launch.serve.run_replicated`` at full width with ``k_max = 4`` (192
     drifting-Zipf(2.0) requests at batch 64, a drift check every 2
     batches: telemetry -> replan -> replica plan -> live migration ->
     replicated side table -> swap) with every launch counter set to 0 just
     before and read just after (the bag kernel's replica select and the
     interaction must have run; the single-copy bag kernel, the other bag
     kernels and the scatter must not); at least one swap, shapes stable,
     the first swap's table and scores equal to a fresh
     ``pack_replicated``; holds the replica select bit for bit against its
     plain version (the served ids through the all-live failover maps and
     the raw flat maps, with holes, my = 3, a dead bank; small tables with
     k_max 2, 3 and 4, bf16 and ragged D); the replicated gradient (the
     scatter on the k_max = 4 prep, and a ones cotangent's copy sums against
     the single-copy gradient); the traffic counters against their host
     twin; the last batch against the single-copy path on the base table; a
     reduced config's replicated run on the card against the CPU swap for
     swap; times the kernel beside its bound, its plain version and
     ``F.embedding_bag`` on ids resolved beforehand, the replicated serve
     step by stage, and the host's share (``next_batch``, the serve call,
     each swap's base replan, replica plan and migrations);
  8. ragged CSR lookups and the identity drop-ins: the full-width
     super-table packed with phase 2's plan (seeded weights), 64 requests x
     8 fields of untruncated Poisson(256) Zipf(1.05) bags (~131 k entries);
     ``core.embedding.csr_embedding_bag`` forward and backward, then
     ``kernels.ops.embedding_bag_trainable`` forward and backward on the
     same bags padded and resolved, then ``kernels.ops.dot_interaction``
     on each request's 8 sums behind a dense row, each with every launch
     counter set to 0 just before and read just after (the CSR kernel and
     the scatter, then the identity bag kernel, the scatter and the
     interaction's z entry, must have run; no other);
     holds the CSR kernel bit for bit against its plain version (the
     served stream, with holes and my = 3, a dead bank, small bf16 tables
     at D = 33 and 160 with empty bags, and ``csr_adversarial_cases``: D
     from 1 to 160 in fp32 and bf16, bags of 0 to 5,000 entries, trailing
     empty bags, offsets outside [0, T], T = 0, an unaligned table, my =
     -1, 3 and 0 on a live map), the CSR sums against
     ``banked_bag`` on the padded bags and the identity kernel on the
     resolved ids, the CSR gradient against the plain scatter and (within
     1e-5 of the summed magnitudes) the rectangular path's, the identity
     gradient against its plain version, the scatter on the CSR prep
     against its plain version (holes with my = 3, a dead bank, both dtype
     mixes, the small tables); times the CSR kernel, the
     identity kernel and the CSR scatter beside their bounds, plain
     versions and one library call each (``F.embedding_bag``,
     ``index_add_``), and the CSR lookup's forward + backward;
  9. the adaptive loop's cache lane: ``launch.serve.run_cached_adaptive``
     at full width (192 drifting-Zipf(1.2) requests at batch 64, a drift
     check every 2 batches, so one swap: telemetry -> cache-aware replan ->
     live migration -> cache install -> swap, every batch rewritten on the host
     and version-tagged) with every launch counter set to 0 just before and
     read just after (the fused kernel and the interaction's fused entry
     must have run; the plain bag kernel, the scatter, the tiered kernel
     and the z entry must not); at least one swap, with the first swap's
     EMT, cache table and output equal to a fresh build (checked on the
     card); holds the fused kernel bit for bit against its plain version on
     the post-swap EMT for the batch in flight across the last swap (the
     retired version's cache table) and for the same bags rewritten under
     the new version; the last batch's reads against their host twin and
     its scores against the plain versions; a reduced config's lane on the
     card against the CPU swap for swap; times the lane's serve step, the
     fused kernel at its shape and the interaction on its inputs, and the
     host's share (the tap, the rewrite, the serve call, each swap's
     replan, migration and cache install);
 10. adaptive training at full width, ``launch.train.run_adaptive`` for 5
     steps at batch 64 with a drift check after step 2, on the cache-aware
     path (a refresh after step 3, of the plan mined at the migration) and
     on the §3.2 path, each with every launch counter set to 0 just before
     and read just after (the fused kernel, or the bag kernel, the
     interaction's fused entry, and exactly one scatter a step); every
     migration's Adagrad state equal to ``migrate_rowwise_state`` of the
     state before it and every refreshed cache table, of a non-empty
     plan, equal to a fresh build from the current rows, bit for bit; the
     cached step's EMT gradient against the plain scatter of the same
     cotangent and the fused kernel against its plain version, on the last
     batch and on the migration step's batch replayed under the live plan
     (which must hit the cache: the run's uniform ids rarely repeat a
     mined pair); the kernels timed at the phase's shapes; a reduced
     config's adaptive training, both paths, on the card against the CPU
     (the same migrations, plans, refreshes, rewritten ids and reads;
     losses within rtol 1e-4);
 11. the fault lane: ``launch.serve.run_fault`` at full width (768
     drifting-Zipf(1.05) requests at batch 64; bank 3 dead at batch 2,
     bank 5 8x slow from batch 8; the SLO watchdog's p99 check at 100 us
     on windows of 8) with every launch counter set to 0 just before and
     read just after (the bag kernel under the binary live map and the
     interaction's fused entry must have run, no other kernel); the run
     itself raises unless a recovery happened, the degraded batch's clean
     requests and the first clean batch after the recovery equal the
     never-failed run bit for bit, every swap kept version 0's shapes and
     an SLO breach reached the replanner; then served plus degraded reads
     equal the valid lookups on every batch, the degraded counts equal a
     host recount from the plan, confinement per bag (clean bags equal the
     never-failed sums; every bag equals the plain version on the ids with
     the dead reads set to -1, and with those ids every bag equals the
     never-failed sums), the bag kernel under the live map against its
     plain version, a straggler replan, and a reduced config's fault lane
     on the card against the CPU event for event (a revival included);
     times the degraded serve step against the plain adaptive step, the
     live map alone (``fault_breakdown``), and prints the recovery ms, the
     straggler events, the SLO breaches and the degraded reads;
 12. retrieval at full ``dlrm-rm2`` width (the reference's
     ``retrieval_cand`` cell: 26 one-hot Criteo-Kaggle fields over one
     33,762,577 x 64 bf16 table, one query against 1,000,000 field-0
     candidates, top 128): ``serve_step.build_retrieval_serve`` with every
     launch counter set to 0 just before and read just after (the
     interaction's query entry, at (10^6, 25 user rows, 64) fp32, must
     have run, no other kernel); the query entry against its plain version
     (atol = rtol = 1e-5) with its 325 query-only columns bit-equal across
     the rows, the batch entry (tiles of rows at P = 351) against its
     plain version at the materialised (10^6, 27, 64) and at (512, 27, 64)
     and (262,144, 27, 64) in fp32 and bf16 (``check_dot_wide``), the
     (N,) scores against the plain path (rtol 1e-5 /
     atol 1e-6), the top-k values and every returned id's plain score
     against the plain top-k at its rank, copies of one id lowest index
     first (``jax.lax.top_k``'s tie-break); a tie-free draw (the 1,460
     ids permuted) id for id wherever the plain scores are apart; a
     reduced config on the card against the CPU; times the gathers,
     both entries (beside their plain versions, ``bmm`` + triangle and
     their bounds), the broadcast inputs the batch entry would need, the
     top MLP and the top-k, and records the serve call's own peak device
     memory and the phase's;
 13. training with int8 gradient compression and a restart at full
     ``updlrm-paper`` width: ``launch.train.run(compress_grads=True,
     ckpt_every=2)`` on phase 2's plan at batch 64 under ``build/`` (run
     A: 6 steps, with every launch counter set to 0 just before and read
     just after: the bag kernel, the fused interaction and the scatter
     must have run; run B: 4 steps, then a call for 6 that restores step
     4); B's final params, optimizer and error-feedback state equal A's
     bit for bit, the manifest is the reference's format, one more step's
     compressed gradient and error equal ``compress_roundtrip`` on the
     CPU bit for bit; records each save's and the restore's seconds, the
     bytes on disk and the step's device ms with and without compression;
     the checkpoints are removed at the end;
 14. the autotuned dispatch (``backend='tuned'``): ``tune.autotune.tune``
     over the port's signature suite (the reference's eight shapes; every
     fitting (bags per block, stages) of the bag kernels, CUDA events,
     written under ``build/``), the tune CLI's self-check, every fitting
     candidate of every case bit for bit against the case's plain version
     and the suite's decisions through ``backend='tuned'``; phase 3's
     full-width table and last batch: the 8 candidates of its signature
     timed and bit-checked, a cache holding the winner installed, the 64
     requests served through ``build_recsys_serve(..., backend='tuned')``
     with every launch counter set to 0 just before and read just after (a
     cache hit; the bag kernel and the fused interaction must have run),
     scores equal to the default path's bit for bit, both device steps
     timed in turns and the host cost of a lookup; a decision that does not
     fit, a 'torch' decision on CUDA tensors and a tiered decision other
     than (1, 1) raise before any launch;
 15. the bank axis (``DistCtx``): four ranks of one ``torch.distributed``
     world (NCCL, one rank a card, where 4 cards are visible; else gloo
     with all four on card 0), launched by ``dist.launch.run_ranks``, as a
     1 x 4 grid and a 2 x 2 grid: (a) 256 requests at batch 64 served at
     full width through ``build_recsys_serve(..., dist)`` over a 4-bank
     §3.2 plan (scores against the single-device port's, each bank's
     partials against ``banked_bag`` on the whole table bit for bit, the
     step and the bank sum timed); (b) 4 DP train steps at full width on
     a 2-bank plan against ``launch.train.run`` on one card (losses,
     touched rows, dense params; a bank's scatter bit for bit); (c) the
     compact migration to a drifted plan bit for bit against the
     single-device one, both exchanges at the reduced size; (d) bank 3
     dead, every bag against the single-device fault lane; (e) the
     compressed DP step on the reduced ``dlrm-rm2``, its int8 psum bit for
     bit; (f) one retrieval query on the 1 x 4 grid at ``dlrm-rm2`` widths
     (fields capped at 10^5 rows): 10^6 candidates spread over the ranks,
     each scoring its quarter through the fused interaction, the top 128
     merged over the grid, against the single-device scores and top k
     (row 2f on each rank's piece against its plain version); (g) the
     compressed train step under ``dist`` (1 x 4, full width, each field
     on one bank): a fixed tree's compression bit for bit against the
     whole tree's, two steps against one card's at (b)'s tolerances; (h)
     a step clipped over every leaf, the table shards included, its norm
     within rtol 1e-6 of one card's; (i) one drift replan under ``dist``
     (full width, every rank observing the global batches) driving a swap
     of the adaptive runtime's cache lane and one of its int4 tier lane,
     and a ``migrate_aux`` of an accumulator: each rank's shards bit for bit
     against single-device builds from the same plan, cache plan and
     tiers, the sharded cached and tiered kernels on the batch in flight
     across each swap against their plain versions; (j) at
     granite-moe-1b-a400m widths, one ``seqsharded_decode_attention`` step
     and one ``moe_layer_sharded`` layer (32 experts over 4 banks) against
     one card's, its forward and backward run twice bit-equal; (k) GAT's
     edge-sharded ``loss_full`` at full gat-cora width on Cora, 2 x 2, the
     edge list cut over the four ranks, its loss and every gradient
     against one card's (atol 1e-4), and one Adam step under the grid;
     every main path with every launch counter set to 0 just before and
     read just after on each rank, the launches summed over the ranks;
 16. the recommendation zoo at full width (``zoo_phase``): DIN, xDeepFM
     and BERT4Rec through ``launch.serve.run`` (256 requests at batch 64;
     DIN and xDeepFM, the reference's serving CLI's families),
     ``launch.train.run`` (4 steps at batch 64) and one retrieval query
     (N = 10^5, 10^4 and 10^6) with its peak memory, BERT4Rec's
     full-catalog scores of a batch of 64; every loss and score finite,
     the top k re-scored through the family's forward path, the reduced
     configs on the card against the CPU; no kernel runs (their lookups
     are dense gathers).
 17. the LM family at full width (``lm_phase``): granite-moe-1b-a400m (24
     layers, d 1,024, 32 experts top 8, ~1.33 B parameters) and
     smollm-360m (dense GLU): prefill of 8 x 2,048 tokens and 32 greedy
     decode steps from its cache through ``build_lm_prefill`` /
     ``build_lm_decode`` (the reference's prefill_32k and decode_32k cells
     cut in batch and sequence only), tokens per second, ms a step, peak
     memory; decode against prefill of the same tokens, held at fp32
     compute; the MoE's ``launch.train.run`` for 3 steps at the train
     CLI's 32 x 64 tokens, run twice from the same seed: every loss and
     every leaf of the train state bit-equal; no kernel of the table runs.
 18. GAT at its four reference cells (``gat_phase``): gat-cora (2 layers,
     8 heads x 8 hidden) at each cell's own dims, Cora (``full_graph_sm``),
     ``molecule`` (128 graphs of 30 nodes and 64 edges), ``minibatch_lg``
     (fanout 15-10 blocks of 1,024 seeds sampled from a 232,965-node,
     114.6 M-edge graph) and ``ogb_products`` (2,449,029 nodes, 61.9 M
     edges, full batch): the batch built on the host (each step timed),
     step 1's loss and gradient norm against a float64 recomputation on
     the card, 3 Adam steps (the reference's ``_gat_cell`` step) with their
     device ms, model FLOP/s (``launch.roofline.model_flops``) and peak
     memory, the reduced config on the card against the CPU; no kernel of
     the table runs.
 19. every cell's cost (``cells_phase``): (a) the dry pass of all 44
     (arch x shape) cells on one card (``launch/dryrun`` on ``meta``
     tensors, in a process started in phase 2), a line a cell: its H100
     roofline bound (a count over published peaks) and dominant term,
     whether it fits 80 GB, its useful-FLOPs ratio; (b) ``updlrm-paper``'s
     ``serve_p99``, ``serve_bulk`` and ``train_batch`` cells at full width
     at their own batches (512, 262,144 and 65,536; 537 M ids drawn on the
     card for ``serve_bulk``), the step ``launch/cells.build_cell`` builds,
     on phase 1's plan and table, with every launch counter set to 0 just
     before and read just after (the bag kernel, the fused interaction and,
     training, the scatter must have run; no other), each step's device
     ms, and each new-shape launch against its plain version on the first
     and last 1,024 bags (the bag kernel and the scatter bit for bit, the
     interaction within 1e-5); (c) the steps of phases 12 and 18. Each
     measured cell's share, its bound over its step, must lie in (0,
     1.05]; every other cell says why it is not measured.
 20. MLPerf's DLRM-DCNv2 at full size (``dcn_phase``), the shape of the
     ``dcnv2-bulk`` cell: its 52.3 GB bf16 table (204,184,588 rows of 128,
     past 2^31 bytes) in 8 uniform banks and a batch of 65,536 x 214 ids
     (1,703,936 bags); one serve step with every launch counter set to 0
     just before and read just after (exactly one ``csr_bag`` launch), its
     scores equal to the plain path's; the lookup's fp32-output instance
     of ``csr_bag`` bit for bit against its plain version on the batch's
     stream and on the adversarial CSR cases, the bf16 instance equal to
     its sums cast once; both instances timed beside the least time.

Phases 6, 7, 9 and 11 print their lane's "compile probe:" line
(``launch.serve.CompileProbe``) and fail if a kernel is built or a kernel
library loaded after the lane's first served batch. Each phase prints its
seconds, and the run a line of them all and its total. Prints the
``{"kernels": [...]}`` line and, last, ``{"ok": true, "device": {...}}``.
Any failed check exits non-zero with no result line. Without CUDA, or
without the repo's ``src/`` beside it, it exits non-zero at once.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "build"           # git-ignored; chip_smoke.json goes here

# H100 SXM published peaks: HBM3 bytes/s and fp32 (non-tensor-core) FLOP/s
HBM_BPS = 3.35e12
FP32_FLOPS = 67e12
BAG_TILE = 1             # non_uniform_partition group size: the exact greedy
DOT_TOL = dict(rtol=1e-5, atol=1e-5)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
LOSS_RTOL = 1e-4         # trajectories: the CPU tests' tolerance
TRAIN_STEPS, TRAIN_BATCH = 6, 64
CACHED_REQUESTS, CACHED_PROFILE = 256, 64
# phases 6 and 7: three batches, so one swap each (after batch 1) and the
# run stays within half its time limit with phase 11 added
ADAPTIVE_REQUESTS, ADAPTIVE_REPLAN = 192, 2
REPLICATED_REQUESTS, REPLICATED_REPLAN, K_MAX = 192, 2, 4
CSR_REQUESTS = 64        # phase 8: requests of 8 ragged bags each
# phase 9: three batches, one cache-aware swap (after batch 2); 256 made two
# replans of ~20 s each, cut with phase 15 added
CACHED_ADAPTIVE_REQUESTS, CACHED_ADAPTIVE_REPLAN = 192, 2
# phase 10: a drift check after step 2 (a migration), a refresh after step
# 3 on the cache-aware path, so the refresh re-sums a mined plan
ADAPTIVE_TRAIN_STEPS, ADAPTIVE_TRAIN_REPLAN, ADAPTIVE_TRAIN_REFRESH = 5, 3, 4
# phase 11: 12 batches of 64; bank 3 dies at batch 2 (one dead bank fits the
# 0.25 capacity slack; a second would not), bank 5 runs 8x slow from batch
# 8 (7 clean batches of straggler history by then); drift checks every 16
# batches, so only the SLO breach's early check can interleave one; a p99
# budget of 100 us, which every full-width device step exceeds
FAULT_REQUESTS, FAULT_REPLAN = 768, 16
FAULT_SCHEDULE = ("2:3", "8:5:degraded:8.0")
FAULT_SLO = dict(p99_us=100.0, window=8)
# its reduced run, card against CPU: the same with a revival at batch 10 and
# the count-driven max_share check in place of the wall-clock p99
FAULT_REDUCED_SCHEDULE = ("2:3", "8:5:degraded:8.0", "10:3:healthy")
EMB_TOL = dict(rtol=0, atol=1e-5)   # cached vs plain bag sums: fp32 reordering
# phase 12: the reference's retrieval_cand cell (src/repro/configs/shapes.py)
RETRIEVAL_N, RETRIEVAL_TOP_K = 1_000_000, 128
# phase 20: MLPerf's DLRM-DCNv2 (Criteo 1TB's 26 vocabularies capped at 40 M
# rows, its fixed multi-hot sizes, 214 ids a sample) at the bulk cell's batch
DCN_VOCAB = (40_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
             40_000_000, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976,
             14, 40_000_000, 40_000_000, 40_000_000, 590_152, 12_973, 108, 36)
DCN_SIZES = (3, 2, 1, 2, 6, 1, 1, 1, 1, 7, 3, 8, 1, 6, 9, 5, 1, 1, 1, 12, 100,
             27, 10, 3, 1, 1)
DCN_BATCH = 65_536


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def need(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def need_warm_probe(res, what: str) -> None:
    """An adaptive lane's ``CompileProbe``: no kernel build or library load
    after its first served batch (the lane's contract raises on it too)."""
    n = res.stats["kernel_builds_after_warm"]
    need(n == 0, f"{what}: {n} kernel build(s) or load(s) after warm-up")


def time_ms(fn, *, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn()`` over ``reps`` runs (CUDA events),
    after ``warmup`` runs. ``flush()`` runs before each timed run, outside
    the events (and before each warm-up run). A ~1 ms device-side sleep is
    queued ahead of each start event, so the host has enqueued all of
    ``fn``'s work before the device reaches it: the events then time the
    device, not the Python that launches it."""
    import torch
    for _ in range(warmup):
        if flush is not None:
            flush()
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profile_device(fn, n: int = 3):
    """Device time of ``n`` back-to-back runs of ``fn`` from a
    ``torch.profiler`` trace: the busy time (union of the kernels' and
    copies' intervals) and the window from the first device event's start
    to the last one's end, per run, and the device time by kernel name.
    None when the trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    if not spans:
        return None
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3 / n
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(busy_ms=busy / 1e3 / n,
                window_ms=(end - spans[0][0]) / 1e3 / n,
                top_kernels_ms=[[k[:80], v] for k, v in top])


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    need(r.returncode == 0 and r.stdout.strip(),
         f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def bag_bound_ms(idx, off, n_fields, dim, itemsize, *, k_max=1, my=-1,
                 slot=None, remap=True):
    """Least time for one bag call on these ids: each id read once, each
    distinct remap entry read once (``row``, or with ``k_max > 1`` ``row *
    k_max + wang_hash(bag) % k_max``: its 4-byte slot, and its 4-byte bank
    when ``my >= 0``), each distinct table row read once (its D values;
    with ``slot`` given, the distinct ``slot[entry]``, since columns of a
    single-copy row share one), the output written once; or the fp32 adds,
    if more. Remap reads are counted at 4 bytes, not at the 32-byte sector
    a random read costs. ``remap=False``: identity ids (the rows
    themselves), no offsets and no remap bytes."""
    import torch
    from repro_torch.kernels.embedding_bag import replica_of_bag
    NB, L = idx.shape
    n = torch.arange(NB, device=idx.device)
    valid = idx >= 0
    rows = idx.long() + off.long()[n % n_fields][:, None]
    if k_max > 1:
        rows = rows * k_max + replica_of_bag(n, k_max).long()[:, None]
    entries = torch.unique(rows[valid])
    n_table = entries.numel() if slot is None \
        else torch.unique(slot[entries]).numel()
    nbytes = (NB * L * 4 + n_table * dim * itemsize + NB * dim * itemsize
              + remap * (off.numel() * 4
                         + entries.numel() * (4 + 4 * (my >= 0))))
    return least_ms(nbytes, int(valid.sum()) * dim)


def least_ms(nbytes, n_adds):
    """(ms, what bounds it): the larger of ``nbytes`` over the card's
    memory rate and ``n_adds`` fp32 operations over its fp32 rate."""
    t_bytes, t_ops = nbytes / HBM_BPS, n_adds / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def csr_bound_ms(indices, n_bags, dim, itemsize, *, my=-1, slot=None,
                 out_itemsize=None):
    """Least time for one CSR bag call on this stream: each id read once,
    the n_bags + 1 offsets, each distinct remap entry once (its 4-byte
    slot, and its 4-byte bank when ``my >= 0``), each distinct table row
    once (the distinct ``slot[raw]`` when ``slot`` is given), the output
    written once (``out_itemsize`` bytes a value, the table's if None); or
    the fp32 adds, if more."""
    import torch
    valid = indices >= 0
    entries = torch.unique(indices[valid])
    n_table = entries.numel() if slot is None \
        else torch.unique(slot[entries.long()]).numel()
    nbytes = (indices.numel() * 4 + (n_bags + 1) * 4
              + entries.numel() * (4 + 4 * (my >= 0))
              + n_table * dim * itemsize
              + n_bags * dim * (out_itemsize or itemsize))
    return least_ms(nbytes, int(valid.sum()) * dim)


def dot_bound_ms(z):
    B, F, D = z.shape
    P = F * (F - 1) // 2
    nbytes = (B * F * D + B * P) * z.element_size()
    return least_ms(nbytes, 2 * B * P * D)


def holey(idx, rng, p_hole=0.05):
    """Interior -1 holes, short bags and one all-pad bag in a (B, F, L)
    id array."""
    import numpy as np
    idx = idx.copy()
    idx[rng.random(idx.shape) < p_hole] = -1
    B, F, L = idx.shape
    short = rng.random((B, F)) < 0.25
    lens = rng.integers(0, L + 1, (B, F))
    idx[short[..., None] & (np.arange(L)[None, None, :] >= lens[..., None])] = -1
    idx[0, 1] = -1
    return idx


def to_dev(tree, dev):
    """A params / statics / batch tree with its tensors moved to ``dev``."""
    import torch
    if isinstance(tree, dict):
        return {k: to_dev(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_dev(v, dev) for v in tree]
    return tree.to(dev) if isinstance(tree, torch.Tensor) else tree


def small_cases(dev, cases=(("bfloat16", 64, 100, 40, 4),
                            ("float32", 160, 24, 20, 3),
                            ("float32", 40, 37, 33, 5))):
    """Small kernel cases beside the main-path shape: bf16 at D=64 (two
    columns a lane), fp32 at D=160 (two passes), ragged NB with all-pad bags
    at D=40 and L=33. Each over a 4-bank §3.2 plan with the flat remap."""
    import numpy as np
    import torch
    from repro_torch.core.partitioning import non_uniform_partition
    srng = np.random.default_rng(3)
    out = []
    for dtype, D, NB, Ls, nfield in cases:
        per_field = 20_000
        sv = per_field * nfield
        splan = non_uniform_partition(srng.random(sv) + 0.01, 4)
        stab = torch.randn((4 * splan.max_rows_per_bank, D), device=dev
                           ).to(getattr(torch, dtype))
        sbank = torch.from_numpy(splan.bank_of_row).to(dev)
        sslot = torch.from_numpy(
            (splan.bank_of_row.astype(np.int64) * splan.max_rows_per_bank
             + splan.slot_of_row).astype(np.int32)).to(dev)
        soff = torch.arange(nfield, dtype=torch.int32, device=dev) * per_field
        sids = srng.integers(0, per_field, (NB, Ls)).astype(np.int32)
        sids[srng.random(sids.shape) < 0.1] = -1
        sids[::7] = -1                                   # all-pad bags
        out.append(dict(name=f"{dtype} D={D} NB={NB} L={Ls}", table=stab,
                        bank=sbank, slot=sslot, off=soff,
                        idx=torch.from_numpy(sids).to(dev)))
    return out


BAG_DIMS = (1, 8, 9, 31, 32, 33, 64, 100, 128, 129, 160)
BAG_LENS = (1, 31, 32, 33, 256, 1000)


def bag_adversarial_cases(dev):
    """Tables and id streams against the bag kernel's resolve-once ring:
    every D of ``BAG_DIMS`` in fp32 and bf16 (16-, 4- and 2-byte copies;
    one, two and three column passes), each with two bag lengths of
    ``BAG_LENS`` (one entry, around a 32-row stage, a whole 256-entry bag,
    1,000 entries past the 8 stages), and every length at D = 32 and 33;
    NB from 37 to 41, so bags per block never divide it; holes and
    all-padding bags in every stream; then 4,301 bags (two bags a block,
    odd NB), a table whose base is 4 bytes off 16-byte alignment, and a
    stream of padding only. Each case carries a table of 4 x 2,400 rows,
    ids of 3 fields of 800 rows and identity ids into the table."""
    import numpy as np
    import torch
    rng = np.random.default_rng(17)
    V, F = 2400, 3
    shapes = []
    for dtype in ("float32", "bfloat16"):
        for i, D in enumerate(BAG_DIMS):
            for L in (BAG_LENS[i % 6], BAG_LENS[(i + 3) % 6]):
                shapes.append((dtype, D, L, 37 + len(shapes) % 5, ""))
        for L in BAG_LENS:
            for D in (32, 33):
                shapes.append((dtype, D, L, 41, ""))
    shapes += [("float32", 32, 33, 4301, ""),
               ("float32", 32, 256, 40, "base 4 B off alignment"),
               ("bfloat16", 64, 32, 16, "padding only")]
    out = []
    for dtype, D, L, NB, note in shapes:
        R = 4 * V
        tab = torch.from_numpy(rng.standard_normal((R * D + 1,))
                               .astype(np.float32)).to(dev)
        tab = tab.to(getattr(torch, dtype))
        # a view 4 bytes (fp32) or 2 bytes (bf16) past the allocation's base
        table = tab[1:].view(R, D) if note.startswith("base") \
            else tab[:R * D].view(R, D)
        ids = rng.integers(0, V // F, (NB, L)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.1] = -1               # holes
        ids[::5] = -1                                       # all-pad bags
        if note == "padding only":
            ids[:] = -1
        rows = np.where(ids >= 0, rng.integers(0, R, ids.shape), -1)
        out.append(dict(
            name=f"{dtype} D={D} L={L} NB={NB}" + (f" ({note})" if note
                                                   else ""),
            table=table, idx=torch.from_numpy(ids).to(dev),
            rows=torch.from_numpy(rows.astype(np.int32)).to(dev),
            off=torch.arange(F, dtype=torch.int32, device=dev) * (V // F),
            remaps={k: (torch.from_numpy(rng.integers(0, 8, V * k)
                                         .astype(np.int32)).to(dev),
                        torch.from_numpy(rng.integers(0, R, V * k)
                                         .astype(np.int32)).to(dev))
                    for k in (1, 2, 4)}))
    return out


def shard_beside_nan(rows, bank, slot, b, nan_row=None):
    """Bank ``b``'s local shard of a table (the bank axis's stage 2): the
    rows ``rows[slot[v]]`` of every id ``v`` homed on ``b``, at local slots
    ``0..n-1``, and one row past them that every other id's slot points at:
    NaN (``rows``' dtype) unless ``nan_row`` is given, so an entry of
    another bank that a kernel added would show. -> (shard, local slots);
    ``rows`` may be a tuple of row-aligned tensors (the tiered payload,
    scale and tier), each with its own row in ``nan_row``."""
    import torch
    mine = bank == b
    n = int(mine.sum())
    idx = slot[mine].long()
    parts = rows if isinstance(rows, tuple) else (rows,)
    if nan_row is None:
        nan_row = (torch.full((1,) + tuple(parts[0].shape[1:]), float("nan"),
                              dtype=parts[0].dtype, device=parts[0].device),)
    shard = tuple(torch.cat([x[idx], z]) for x, z in zip(parts, nan_row))
    local = torch.full_like(slot, n)
    local[mine] = torch.arange(n, dtype=slot.dtype, device=slot.device)
    return (shard if isinstance(rows, tuple) else shard[0]), local


def check_bag_adversarial(dev, errs):
    """The three instances of the bag kernel (kRemap with k_max = 1,
    kReplica with k_max = 2 and 4, kIdentity) against their plain versions,
    bit for bit, on ``bag_adversarial_cases``: my = -1, my = 3 on an 8-bank
    map, and my = 0 on a live map (bank 5 dead)."""
    import torch
    from repro_torch.kernels.embedding_bag import (banked_bag,
                                                   banked_bag_plain,
                                                   plain_bag, plain_bag_plain)
    n = 0
    for c in bag_adversarial_cases(dev):
        for k, (bank, slot) in c["remaps"].items():
            live = (bank != 5).to(torch.int32) ^ 1    # 0 where live
            for my, bk in ((-1, bank), (3, bank), (0, live)):
                a = (c["table"], bk, slot, c["off"], my, c["idx"], k)
                got, want = banked_bag(*a), banked_bag_plain(*a)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item() \
                    if got.numel() else 0.0
                need(got.dtype == want.dtype and torch.equal(got, want),
                     f"banked_bag {c['name']} k_max={k} my={my}: kernel != "
                     f"plain (max abs err {err})")
                errs.append(err)
                n += 1
        # a bank's local shard (the bank axis's stage 2): bank 3's rows
        # only, at local slots, and every other bank's rows pointed at a
        # NaN row past them, which an entry of another bank would add
        bank, slot = c["remaps"][1]
        shard, local = shard_beside_nan(c["table"], bank, slot, 3)
        a = (shard, bank, local, c["off"], 3, c["idx"])
        got, want = banked_bag(*a), banked_bag_plain(*a)
        whole = banked_bag(c["table"], bank, slot, c["off"], 3, c["idx"])
        torch.cuda.synchronize()
        need(torch.equal(got, want) and torch.equal(got, whole),
             f"banked_bag {c['name']} on bank 3's shard: != plain or != "
             f"the whole table's bank-3 sums (another bank's entry added?)")
        n += 2
        got = plain_bag(c["table"], c["rows"])
        want = plain_bag_plain(c["table"], c["rows"])
        torch.cuda.synchronize()
        need(got.dtype == want.dtype and torch.equal(got, want),
             f"plain_bag {c['name']}: kernel != plain")
        n += 1
    print(f"  banked_bag adversarial cases: {n} calls (kRemap, kReplica "
          f"k_max 2 and 4, kIdentity, kRemap on a bank's shard beside a NaN "
          f"row; D {BAG_DIMS}, L {BAG_LENS}) == plain")


def check_bag_kernel(dev, cfg, plan, pop, params, statics, rng, report):
    """Kernel vs plain, bit for bit, at the main-path shape and on small
    bf16 / ragged cases; then the timings at the main-path shape."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels.embedding_bag import banked_bag, banked_bag_plain
    from repro_torch.models import dlrm

    t = dlrm._banked(params, statics)
    off = statics["field_offsets"]
    flat_remap = t.flat_remap()
    F, L, B = cfg.n_sparse, cfg.multi_hot, 64
    # the serve path's own ids (uniform, full bags) and Zipf ids with holes
    main_ids = syn.dlrm_batch(cfg.vocab_sizes, cfg.n_dense, B, seed=1,
                              step=0, multi_hot=L)["sparse"]
    zipf_ids = holey(rng.choice(cfg.vocab_sizes[0], size=(B, F, L), p=pop)
                     .astype(np.int32), rng)
    idx_main = torch.from_numpy(main_ids.reshape(-1, L)).to(dev)
    idx_zipf = torch.from_numpy(zipf_ids.reshape(-1, L)).to(dev)
    dead = torch.ones(plan.n_banks, dtype=torch.bool, device=dev)
    dead[5] = False
    live_map = torch.where(dead[t.remap_bank.long()], 0, 1).to(torch.int32)

    errs = []

    def same(name, table, bank, slot, offs, my, idx):
        got = banked_bag(table, bank, slot, offs, my, idx)
        want = banked_bag_plain(table, bank, slot, offs, my, idx)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"banked_bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        need(torch.equal(got, want),
             f"banked_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"banked_bag {name}: non-finite")
        errs.append(err)
        print(f"  banked_bag {name}: {tuple(got.shape)} {got.dtype} "
              f"== plain (max abs err {err})")

    print(f"banked_bag vs plain, bit for bit (table {tuple(t.packed.shape)} "
          f"{t.packed.dtype}):")
    same("main ids, my=-1 flat remap", t.packed, t.remap_bank, flat_remap,
         off, -1, idx_main)
    same("zipf ids+holes, my=-1", t.packed, t.remap_bank, flat_remap, off,
         -1, idx_zipf)
    same("zipf ids+holes, my=3 bank map", t.packed, t.remap_bank, flat_remap,
         off, 3, idx_zipf)
    same("zipf ids+holes, bank 5 dead (binary live map, my=0)", t.packed,
         live_map, flat_remap, off, 0, idx_zipf)

    for c in small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["table"], c["bank"], c["slot"],
                 c["off"], my, c["idx"])
    check_bag_adversarial(dev, errs)

    # timings at the main-path shape, on the serve path's ids, L2 flushed
    # before every run: a real batch finds its rows cold
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (t.packed, t.remap_bank, flat_remap, off, -1, idx_main)
    bag = torch.arange(idx_main.shape[0], device=dev) % F
    rows = idx_main.long() + off.long()[bag][:, None]
    valid = idx_main >= 0
    lib_ids = flat_remap[rows[valid]].long()
    lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
    lib = lambda: tnf.embedding_bag(lib_ids, t.packed, lib_offsets,  # noqa: E731
                                    mode="sum")
    need(torch.allclose(lib(), banked_bag(*args), rtol=1e-5, atol=1e-5),
         "embedding_bag library call disagrees with the kernel")
    ms = time_ms(lambda: banked_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: banked_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    bound_ms, bound_by = bag_bound_ms(idx_main, off, F, t.dim,
                                      t.packed.element_size())
    print(f"banked_bag at NB={idx_main.shape[0]} L={L} D={t.dim} fp32: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})")
    report["banked_bag"] = dict(
        name="banked_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/banked_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:231",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)


def bf16_rounds(got, dot32):
    """Whether each bf16 value of ``got`` is a rounding of the fp32 dot
    ``dot32`` as a kernel that sums in another order may give it: within
    half a bf16 step of ``dot32`` (the step 2^(e - 8) for |dot32| in
    [2^(e-1), 2^e)) plus the fp32 sums' own spread (DOT_TOL)."""
    import torch
    _, e = torch.frexp(dot32)
    half_step = torch.ldexp(torch.ones_like(dot32), e - 9)
    tol = half_step + DOT_TOL["rtol"] * dot32.abs() + DOT_TOL["atol"]
    return bool(((got.float() - dot32).abs() <= tol).all())


def dot_features_bound_ms(x, emb):
    B, D = x.shape
    F = emb.shape[1] + 1
    P = F * (F - 1) // 2
    nbytes = (B * F * D + B * (P + D)) * x.element_size()
    return least_ms(nbytes, 2 * B * P * D)


def query_columns(n_fields, dev):
    """The columns of the query entry's output that hold dots among x and
    the user rows (every pair but those with the last field), which every
    row must hold bit for bit alike."""
    import torch
    _, ju = torch.triu_indices(n_fields, n_fields, offset=1, device=dev)
    return (ju < n_fields - 1).nonzero()[:, 0]


def dot_query_bound_ms(n_cand, n_user, dim, itemsize):
    """Least time for one query-entry call: x, the user rows and the
    candidate rows read once, the (N, P + D) output written once; or the
    fp32 operations of the query dots once and U + 1 dots a candidate."""
    from repro_torch.kernels.cost import dot_features_query_cost
    return least_ms(*dot_features_query_cost(n_cand, n_user, dim, itemsize))


def check_dot_kernel(dev, report):
    """The batch entries of the interaction kernel against their plain
    versions (atol = rtol = 1e-5 in fp32; in bf16 each dot a rounding of
    the plain version's fp32 dot, ``bf16_rounds``) at every path's
    shape (64, 9, 32) and on wider, narrower and odd shapes; the fused
    entry's x columns bit for bit; the query entry likewise at odd shapes,
    its query-only columns bit-equal across rows; then the batch entries
    timed at (64, 9, 32) fp32 beside their bounds, the plain versions,
    ``bmm`` and the unfused sequence the model ran before (cat, the z
    entry, cat). Phase 12 times the query entry."""
    import torch
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_features_plain,
                                                     dot_features_query,
                                                     dot_features_query_plain,
                                                     dot_interaction,
                                                     dot_interaction_plain)
    g = torch.Generator(device=dev).manual_seed(5)
    errs, f_errs = [], []
    print("dot_interaction and dot_features vs plain (atol = rtol = 1e-5 in "
          "fp32):")
    for shape, dtype in (((64, 9, 32), torch.float32),
                         ((8, 27, 64), torch.float32),
                         ((5, 2, 16), torch.float32),
                         ((3, 40, 300), torch.float32),
                         ((7, 5, 33), torch.float32),
                         ((6, 4, 9), torch.bfloat16),
                         ((64, 9, 32), torch.bfloat16)):
        z = torch.randn(shape, generator=g, device=dev).to(dtype)
        x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
        P = shape[1] * (shape[1] - 1) // 2
        # bf16 output: the kernel and the plain version each round one fp32
        # dot once, summed in other orders; both held to the fp32 dot
        dot32 = dot_interaction_plain(z.float())
        for name, got, want in (
                ("dot_interaction", dot_interaction(z),
                 dot_interaction_plain(z)),
                ("dot_features", dot_features(x, emb),
                 dot_features_plain(x, emb))):
            torch.cuda.synchronize()
            need(got.shape == want.shape and got.dtype == want.dtype,
                 f"{name} {shape}: shape/dtype")
            err = (got.float() - want.float()).abs().max().item()
            if dtype == torch.float32:
                need(torch.allclose(got, want, **DOT_TOL),
                     f"{name} {shape} {dtype}: max abs err {err}")
            else:
                need(bf16_rounds(got[:, :P], dot32)
                     and bf16_rounds(want[:, :P], dot32),
                     f"{name} {shape} {dtype}: not a rounding of the fp32 "
                     f"dot (max abs err to the plain version {err})")
            if name == "dot_features":
                need(torch.equal(got[:, P:], x),
                     f"dot_features {shape}: x columns != x")
            if dtype == torch.float32:
                (errs if name == "dot_interaction" else f_errs).append(err)
            print(f"  {name} {shape} {str(dtype)[6:]}: max abs err {err}")

    # the query entry at odd shapes: no user row, one, a width that is no
    # multiple of 16 bytes, a last tile of 9 rows, bf16
    q_errs = []
    for (U, N, D), dtype in (((25, 1001, 64), torch.float32),
                             ((25, 1001, 64), torch.bfloat16),
                             ((0, 77, 16), torch.float32),
                             ((1, 50, 8), torch.bfloat16),
                             ((7, 333, 33), torch.float32)):
        x, user, cand = (torch.randn(sh, generator=g, device=dev).to(dtype)
                         for sh in ((D,), (U, D), (N, D)))
        got = dot_features_query(x, user, cand)
        want = dot_features_query_plain(x, user, cand)
        torch.cuda.synchronize()
        P = (U + 2) * (U + 1) // 2
        shape = (N, U + 2, D)
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"dot_features_query {shape}: shape/dtype")
        err = (got.float() - want.float()).abs().max().item()
        if dtype == torch.float32:
            need(torch.allclose(got, want, **DOT_TOL),
                 f"dot_features_query {shape} {dtype}: max abs err {err}")
            q_errs.append(err)
        else:
            dot32 = dot_features_query_plain(x.float(), user.float(),
                                             cand.float())[:, :P]
            need(bf16_rounds(got[:, :P], dot32)
                 and bf16_rounds(want[:, :P], dot32),
                 f"dot_features_query {shape} {dtype}: not a rounding of "
                 f"the fp32 dot (max abs err to the plain version {err})")
        const = query_columns(U + 2, dev)
        need(torch.equal(got[:, P:], x.expand(N, -1))
             and torch.equal(got[:, const], got[:1, const].expand(N, -1)),
             f"dot_features_query {shape}: x columns != x, or a query-only "
             f"column differs across rows")
        print(f"  dot_features_query {shape} {str(dtype)[6:]}: max abs err "
              f"{err}; query-only columns equal across rows")
    report["dot_features_query"] = dict(
        name="dot_features_query", route="cuda",
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:22",
        max_abs_err=max(q_errs), library_ms=None)

    z = torch.randn((64, 9, 32), generator=g, device=dev)
    x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
    iu, ju = torch.triu_indices(9, 9, offset=1, device=dev)
    lib = lambda: torch.bmm(z, z.mT)[:, iu, ju]  # noqa: E731
    need(torch.allclose(lib(), dot_interaction(z), **DOT_TOL),
         "bmm library call disagrees with the kernel")

    def unfused():
        zz = torch.cat([x[:, None], emb], dim=1)
        return torch.cat([dot_interaction(zz), x], dim=-1)
    need(torch.allclose(unfused(), dot_features(x, emb), **DOT_TOL),
         "the unfused sequence disagrees with the fused entry")
    ms = time_ms(lambda: dot_interaction(z), reps=50)
    plain_ms = time_ms(lambda: dot_interaction_plain(z), reps=50)
    library_ms = time_ms(lib, reps=50)
    f_ms = time_ms(lambda: dot_features(x, emb), reps=50)
    f_plain_ms = time_ms(lambda: dot_features_plain(x, emb), reps=50)
    unfused_ms = time_ms(unfused, reps=50)
    bound_ms, bound_by = dot_bound_ms(z)
    f_bound_ms, f_bound_by = dot_features_bound_ms(x, emb)
    print(f"dot_interaction at (64, 9, 32) fp32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bmm {library_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}; launch-bound)")
    print(f"dot_features at x (64, 32), emb (64, 8, 32) fp32: kernel "
          f"{f_ms:.4f} ms, plain {f_plain_ms:.4f} ms, unfused (cat, "
          f"dot_interaction, cat) {unfused_ms:.4f} ms, bound "
          f"{f_bound_ms:.6f} ms ({f_bound_by}; launch-bound)")
    report["dot_interaction"] = dict(
        name="dot_interaction", route="cuda",
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:22",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    report["dot_features"] = dict(
        name="dot_features", route="cuda",
        source="src/repro_torch/kernels/csrc/dot_interaction.cu",
        replaces="src/repro/kernels/dot_interaction.py:22",
        max_abs_err=max(f_errs), ms=f_ms, plain_ms=f_plain_ms,
        bound_ms=f_bound_ms, bound_by=f_bound_by, library_ms=None,
        unfused_ms=unfused_ms)


def serve_main_path(dev, spec, plan):
    """The main path with the launch counters read around it."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run
    kbag.banked_bag.launches = 0
    kdot.dot_features.launches = 0
    kdot.dot_interaction.launches = 0
    res = run(spec, spec.config, requests=256, batch=64, device=dev,
              plan=plan)
    launches = {"banked_bag": kbag.banked_bag.launches,
                "dot_features": kdot.dot_features.launches,
                "dot_interaction": kdot.dot_interaction.launches}
    print(f"serve: {len(res.latencies)} requests at batch 64, launches "
          f"{launches}")
    for name in ("banked_bag", "dot_features"):
        need(launches[name] > 0, f"the serve run launched no {name} kernel")
    need(launches["dot_interaction"] == 0,
         "the serve run launched the unfused dot_interaction entry")
    return res, launches


def check_serve_outputs(dev, spec, res):
    import torch
    from repro_torch.core.embedding import banked_embedding_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve

    cfg = spec.config
    need(tuple(res.scores.shape) == (256,), f"scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "scores outside (0, 1)")
    t = dlrm._banked(res.params, res.statics)
    sparse = res.last_batch["sparse"]
    with torch.inference_mode():
        emb_k = banked_embedding_bag(t, sparse, backend="cuda",
                                     field_offsets=res.statics["field_offsets"])
        emb_p = banked_embedding_bag(t, sparse, backend="torch",
                                     field_offsets=res.statics["field_offsets"])
    need(torch.equal(emb_k, emb_p), "served embeddings: kernel != plain")
    plain = build_recsys_serve(dlrm, cfg, res.statics, backend="torch")(
        res.params, res.last_batch)
    err = (plain - res.scores[-64:]).abs().max().item()
    need(torch.allclose(res.scores[-64:], plain, **SCORE_TOL),
         f"served scores vs plain re-score: max abs err {err}")
    print(f"serve outputs: finite, in (0, 1); last batch embeddings equal "
          f"plain, scores within rtol 1e-5/atol 1e-6 (max abs err {err})")

    # a reduced config on the same weights: the card against the CPU
    red = spec.reduced
    params, statics = dlrm.init_params(red, torch.Generator().manual_seed(3),
                                       device="cpu")
    from repro_torch.data import synthetic as syn
    b = syn.dlrm_batch(red.vocab_sizes, red.n_dense, 16, seed=2, step=0,
                       multi_hot=red.multi_hot)
    b.pop("label")
    cpu_batch = {k: torch.from_numpy(v) for k, v in b.items()}

    want = build_recsys_serve(dlrm, red, statics)(params, cpu_batch)
    got = build_recsys_serve(dlrm, red, to_dev(statics, dev))(
        to_dev(params, dev), to_dev(cpu_batch, dev))
    err = (got.cpu() - want).abs().max().item()
    need(torch.allclose(got.cpu(), want, **SCORE_TOL),
         f"reduced config, card vs CPU: max abs err {err}")
    print(f"reduced config on the card vs the CPU, same weights: max abs "
          f"err {err}")


def serve_breakdown(dev, spec, res):
    """Device time of one full-width serve step and of its stages, L2
    flushed before each run."""
    import torch
    from repro_torch.core.embedding import banked_embedding_bag
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_interaction)
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    cfg = spec.config
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    t = dlrm._banked(res.params, res.statics)
    batch = res.last_batch
    serve = build_recsys_serve(dlrm, cfg, res.statics)
    fo = res.statics["field_offsets"]
    with torch.inference_mode():
        x = dlrm.mlp_apply(res.params["bot"], batch["dense"])
        emb = banked_embedding_bag(t, batch["sparse"],
                                   field_offsets=fo).contiguous()
        z = torch.cat([x[:, None], emb], dim=1)
        feat = dot_features(x, emb)
        parts = {
            "serve_step": lambda: serve(res.params, batch),
            "flat_remap": t.flat_remap,
            "embedding_bag": lambda: banked_embedding_bag(
                t, batch["sparse"], field_offsets=fo),
            "bottom_mlp": lambda: dlrm.mlp_apply(res.params["bot"],
                                                 batch["dense"]),
            "dot_features": lambda: dot_features(x, emb),
            "dot_interaction": lambda: dot_interaction(z),
            "top_mlp": lambda: dlrm.mlp_apply(res.params["top"], feat),
        }
        out = {k: time_ms(fn, flush=scratch.zero_) for k, fn in parts.items()}
        prof = profile_device(lambda: serve(res.params, batch), n=5)
    print("serve step breakdown (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per serve call: device busy {prof['busy_ms']:.4f}"
              f" ms of a {prof['window_ms']:.4f} ms window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof

    # host side of one batch, as run() does it: 64 requests made, stacked
    # on the card, scored (host clock, each stage ending in a synchronize)
    from repro_torch.launch.serve import _one
    from repro_torch.serve.serve_step import MicroBatcher, Request
    pad = {k: v[0] for k, v in _one(cfg, 0).items()}
    host = {"make_requests": [], "next_batch": [], "serve_call": []}
    for rep in range(5):
        t0 = time.perf_counter()
        reqs = [Request(rid, {k: v[0] for k, v in
                              _one(cfg, 1000 + 64 * rep + rid).items()})
                for rid in range(64)]
        t1 = time.perf_counter()
        mb = MicroBatcher(64, pad, device=dev)
        for r in reqs:
            mb.submit(r)
        _, feats = mb.next_batch()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        serve(res.params, feats)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for k, v in zip(host, (t1 - t0, t2 - t1, t3 - t2)):
            host[k].append(v * 1e3)
    host = {f"{k}_host_ms": statistics.median(v) for k, v in host.items()}
    print("one batch of 64 on the host (median of 5, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    return {**out, **host}


def train_main_path(dev, spec, plan):
    """The train path with the launch counters read around it."""
    import math
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.train import run
    kbag.banked_bag.launches = 0
    kbag.ct_scatter_bag.launches = 0
    kdot.dot_features.launches = 0
    kdot.dot_interaction.launches = 0
    res = run(spec, spec.config, steps=TRAIN_STEPS, batch=TRAIN_BATCH,
              device=dev, plan=plan)
    launches = {"banked_bag": kbag.banked_bag.launches,
                "ct_scatter_bag": kbag.ct_scatter_bag.launches,
                "dot_features": kdot.dot_features.launches,
                "dot_interaction": kdot.dot_interaction.launches}
    print(f"train: {TRAIN_STEPS} steps at batch {TRAIN_BATCH}, launches "
          f"{launches}")
    for name in ("banked_bag", "ct_scatter_bag", "dot_features"):
        need(launches[name] > 0, f"the train run launched no {name} kernel")
    need(launches["dot_interaction"] == 0,
         "the train run launched the unfused dot_interaction entry")
    need(len(res.losses) == TRAIN_STEPS
         and all(math.isfinite(x) for x in res.losses),
         f"train losses {res.losses}")
    print("  losses " + ", ".join(f"{x:.6f}" for x in res.losses)
          + "; host ms per step " + ", ".join(f"{x:.3f}" for x in res.step_ms))
    return res, launches


def scatter_bound_ms(runs, nb, dim, itemsize):
    """Least time for one scatter-kernel call on these runs: the prep arrays
    it needs read once (each live entry's cotangent row id, each live run's
    start and slot, the run count), ct read once, each distinct destination
    row written once; or the fp32 adds, if more."""
    n_run = int(runs.n_run[0])
    n_live = int(runs.run_starts[n_run])
    nbytes = (n_live * 4 + (n_run + 1) * 4 + n_run * 4 + 4
              + nb * dim * itemsize + n_run * dim * itemsize)
    return least_ms(nbytes, n_live * dim)


def run_lengths(runs):
    n = int(runs.n_run[0])
    lens = runs.run_starts[1:n + 1] - runs.run_starts[:n]
    return n, int(runs.run_starts[n]), int(lens.max()) if n else 0


SCATTER_SHORT_MAX = 64     # ct_scatter.cu's kShortMax: longer runs go to
SCATTER_SPAN = 1024        # the span blocks of kSpan sorted entries
SCATTER_STAGE = 32         # a span block's stage of entries


def scatter_adversarial_cases(dev):
    """Run layouts that the sorted-run scatter splits, each as the identity
    prep of a -1 padded (NB, L) id stream (entry order bag-major, each
    entry's cotangent row its bag): one run holding every entry; runs of
    every length around the short/long threshold, the span's stage and
    the span itself, in random slot order; a long run as the last live run
    (the highest slot) behind short ones; 40 long runs of 65 entries back
    to back (16 start in one span, boundaries on and off the stages); no
    live run (all ids -1). -> [(name, runs, nb, n_rows)]."""
    import numpy as np
    from repro_torch.kernels.embedding_bag import identity_scatter_prep
    rng = np.random.default_rng(29)
    T, S, W = SCATTER_SHORT_MAX, SCATTER_SPAN, SCATTER_STAGE

    def stream(lens, nb, L, n_rows, rows=None):
        lens = np.asarray(lens)
        if rows is None:
            rows = rng.choice(n_rows, size=lens.size, replace=False)
        ids = np.repeat(rows, lens).astype(np.int32)
        flat = np.full(nb * L, -1, np.int32)
        flat[rng.choice(nb * L, size=ids.size, replace=False)] = \
            rng.permutation(ids)
        idx = torch.from_numpy(flat.reshape(nb, L)).to(dev)
        return identity_scatter_prep(idx, n_rows)

    import torch
    around = [1, 2, 3, 4, 5, 8, W - 1, W, W + 1, T - 1, T, T + 1, T + 2,
              3 * W, 3 * W + 1, 2 * T, 2 * T + 1, S - 1, S, S + 1, 2 * S + 3,
              7 * W * 2 + 5]
    mixed = around + list(rng.integers(1, 12, 3000))
    last = list(rng.integers(1, 6, 2000))
    n_last = 4000
    last_rows = np.concatenate([rng.choice(n_last - 1, size=len(last),
                                           replace=False), [n_last - 1]])
    return [
        ("one run of every entry", stream([64 * 256], 64, 256, 1000), 64,
         1000),
        ("runs around 32, 64, 1024 entries + 3,000 short runs",
         stream(mixed, 256, 128, 50_000), 256, 50_000),
        ("a 700-entry run in the last live slot behind 2,000 short runs",
         stream(last + [700], 64, 128, n_last, rows=last_rows), 64, n_last),
        ("40 runs of 65 entries back to back",
         stream([T + 1] * 40 + [1] * 100, 32, 128, 300,
                rows=np.arange(140)), 32, 300),
        ("no live run (all ids -1)",
         identity_scatter_prep(torch.full((16, 64), -1, dtype=torch.int32,
                                          device=dev), 500), 16, 500),
    ]


def check_scatter_adversarial(dev, errs):
    """Every adversarial layout at D in {1, 31, 32, 33, 65, 129, 160} (fp32
    cotangent onto fp32) and at D = 32 and 33 with bf16 -> fp32 and fp32
    -> bf16: the kernel (``ct_scatter_launch``) equal to
    ``ct_scatter_runs_plain`` bit for bit."""
    import torch
    from repro_torch.kernels.embedding_bag import (ct_scatter_launch,
                                                   ct_scatter_runs_plain)
    g = torch.Generator(device=dev).manual_seed(31)
    combos = [(d, torch.float32, torch.float32)
              for d in (1, 31, 32, 33, 65, 129, 160)]
    combos += [(d, a, b) for d in (32, 33)
               for a, b in ((torch.bfloat16, torch.float32),
                            (torch.float32, torch.bfloat16))]
    for name, runs, nb, n_rows in scatter_adversarial_cases(dev):
        n_run, n_live, longest = run_lengths(runs)
        for d, ct_dt, out_dt in combos:
            ct = torch.randn((nb, d), generator=g, device=dev).to(ct_dt)
            got = ct_scatter_launch(ct, runs, torch.zeros(
                (n_rows, d), dtype=out_dt, device=dev))
            want = ct_scatter_runs_plain(ct, runs, torch.zeros(
                (n_rows, d), dtype=out_dt, device=dev))
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            need(torch.equal(got, want),
                 f"ct_scatter {name}, D={d} {ct_dt} -> {out_dt}: kernel != "
                 f"plain (max abs err {err})")
            errs.append(err)
        print(f"  ct_scatter {name} ({n_run} runs, {n_live} entries, "
              f"longest {longest}): == plain at D = 1, 31, 32, 33, 65, 129, "
              f"160 and in both dtype mixes")


def check_scatter_kernel(dev, cfg, pop, res, report):
    """The sorted-run scatter kernel vs its plain version, bit for bit, at
    the train path's shape (its last batch's ids, and Zipf ids with holes
    under three ownership maps) and on the phase-2 small cases; its prep on
    the card vs on the CPU; then the timings at the train path's shape."""
    import numpy as np
    import torch
    from repro_torch.kernels.embedding_bag import (ct_scatter_bag,
                                                   ct_scatter_bag_plain,
                                                   ct_scatter_launch,
                                                   ct_scatter_runs_plain,
                                                   scatter_entries,
                                                   scatter_prep)
    st = res.statics
    F, L, D = cfg.n_sparse, cfg.multi_hot, cfg.embed_dim
    bank, slot, off = st["remap_bank"], st["remap_flat"], st["field_offsets"]
    n_rows = st["n_banks"] * st["rows_per_bank"]
    rng = np.random.default_rng(2)
    idx_main = res.last_batch["sparse"].reshape(-1, L).contiguous()
    zipf_ids = holey(rng.choice(cfg.vocab_sizes[0], size=(TRAIN_BATCH, F, L),
                                p=pop).astype(np.int32), rng)
    idx_zipf = torch.from_numpy(zipf_ids.reshape(-1, L)).to(dev)
    live = torch.ones(st["n_banks"], dtype=torch.bool, device=dev)
    live[5] = False
    live_map = torch.where(live[bank.long()], 0, 1).to(torch.int32)
    g = torch.Generator(device=dev).manual_seed(7)
    ct = torch.randn((idx_main.shape[0], D), generator=g, device=dev)
    errs = []

    def same(name, ct, idx, bank, slot, off, my, n_rows):
        got = ct_scatter_bag(ct, idx, bank, slot, off, my, n_rows)
        want = ct_scatter_bag_plain(ct, idx, bank, slot, off, my, n_rows)
        torch.cuda.synchronize()
        need(got.shape == want.shape == (n_rows, ct.shape[1])
             and got.dtype == want.dtype == ct.dtype,
             f"ct_scatter_bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        need(torch.equal(got, want),
             f"ct_scatter_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"ct_scatter_bag {name}: non-finite")
        rows = int((got != 0).any(1).sum())
        need(rows > 0, f"ct_scatter_bag {name}: an all-zero gradient")
        errs.append(err)
        print(f"  ct_scatter_bag {name}: {tuple(got.shape)} {got.dtype}, "
              f"{rows} rows touched, == plain (max abs err {err})")

    print(f"ct_scatter_bag vs plain, bit for bit (d_table ({n_rows}, {D}) "
          f"float32, ct ({idx_main.shape[0]}, {D})):")
    same("train ids, my=-1 flat remap", ct, idx_main, bank, slot, off, -1,
         n_rows)
    same("zipf ids+holes, my=-1", ct, idx_zipf, bank, slot, off, -1, n_rows)
    same("zipf ids+holes, my=3 bank map", ct, idx_zipf, bank, slot, off, 3,
         n_rows)
    same("zipf ids+holes, bank 5 dead (binary live map, my=0)", ct, idx_zipf,
         live_map, slot, off, 0, n_rows)
    for c in small_cases(dev):
        sct = torch.randn((c["idx"].shape[0], c["table"].shape[1]),
                          generator=g, device=dev).to(c["table"].dtype)
        for my in (-1, 1):
            same(f"{c['name']} my={my}", sct, c["idx"], c["bank"], c["slot"],
                 c["off"], my, c["table"].shape[0])

    print("ct_scatter adversarial run layouts vs plain, bit for bit:")
    check_scatter_adversarial(dev, errs)

    cpu = [t.cpu() for t in (idx_zipf, bank, slot, off)]
    for my in (-1, 3):
        on_card = scatter_prep(idx_zipf, bank, slot, off, my, n_rows)
        on_cpu = scatter_prep(*cpu, my, n_rows)
        for name, a, b in zip(on_card._fields, on_card, on_cpu):
            need(torch.equal(a.cpu(), b),
                 f"scatter prep {name}, zipf ids my={my}: card != CPU")
    print("  scatter prep (zipf ids+holes, my=-1 and my=3): card == CPU")

    # timings at the train path's shape, on its own ids, L2 flushed before
    # every run (a step finds the table cold)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    runs = scatter_prep(idx_main, bank, slot, off, -1, n_rows)
    runs_zipf = scatter_prep(idx_zipf, bank, slot, off, -1, n_rows)
    out = torch.zeros((n_rows, D), device=dev)
    ms = time_ms(lambda: ct_scatter_launch(ct, runs, out), flush=scratch.zero_)
    out_p = torch.zeros((n_rows, D), device=dev)
    plain_ms = time_ms(lambda: ct_scatter_runs_plain(ct, runs, out_p), reps=5,
                       flush=scratch.zero_)
    need(torch.equal(out, out_p), "timed kernel output != timed plain output")
    del out_p
    out_z = torch.zeros((n_rows, D), device=dev)
    zipf_ms = time_ms(lambda: ct_scatter_launch(ct, runs_zipf, out_z),
                      flush=scratch.zero_)

    def index_add_ms(idx, want, long_runs):
        """One ``index_add_`` of the same cotangent rows onto the same slots,
        timed. It adds a slot's rows in no fixed order: on short runs held
        to rtol = atol = 1e-5, on runs of thousands of entries to 1e-5 of
        each sum's magnitudes."""
        dest, bags = scatter_entries(idx, bank, slot, off, -1, n_rows)
        keep = dest < n_rows
        lib_dest, lib_bag = dest[keep].long(), bags[keep].long()
        lib_out = torch.zeros((n_rows, D), device=dev)
        lib = lambda: lib_out.index_add_(0, lib_dest,  # noqa: E731
                                         ct[lib_bag])
        lib()
        if long_runs:
            mag = torch.zeros((n_rows, D), device=dev).index_add_(
                0, lib_dest, ct[lib_bag].abs())
            rel = ((lib_out - want).abs() / mag.clamp(min=1e-30)).max().item()
            need(rel <= 1e-5, f"index_add_ library call vs the kernel: {rel} "
                              f"of the summed magnitudes")
            del mag
        else:
            need(torch.allclose(lib_out, want, rtol=1e-5, atol=1e-5),
                 "index_add_ library call disagrees with the kernel")
        ms = time_ms(lib, flush=scratch.zero_)
        del lib_out
        return ms

    library_ms = index_add_ms(idx_main, out, long_runs=False)
    zipf_library_ms = index_add_ms(idx_zipf, out_z, long_runs=True)
    del out_z
    prep_ms = time_ms(lambda: scatter_prep(idx_main, bank, slot, off, -1,
                                           n_rows), flush=scratch.zero_)
    zero_ms = time_ms(lambda: torch.zeros((n_rows, D), device=dev),
                      flush=scratch.zero_)
    wrapper_ms = time_ms(lambda: ct_scatter_bag(ct, idx_main, bank, slot, off,
                                                -1, n_rows),
                         flush=scratch.zero_)
    bound_ms, bound_by = scatter_bound_ms(runs, idx_main.shape[0], D, 4)
    zipf_bound_ms, _ = scatter_bound_ms(runs_zipf, idx_zipf.shape[0], D, 4)
    n_run, n_live, longest = run_lengths(runs)
    zn_run, zn_live, zlongest = run_lengths(runs_zipf)
    print(f"ct_scatter_bag at NB={idx_main.shape[0]} L={L} D={D} fp32 "
          f"({n_live} live entries, {n_run} runs, longest {longest}): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {library_ms:.4f} "
          f"ms, bound {bound_ms:.6f} ms ({bound_by}); prep {prep_ms:.4f} ms, "
          f"zero fill {zero_ms:.4f} ms, whole wrapper {wrapper_ms:.4f} ms")
    print(f"  on the zipf ids ({zn_live} live entries, {zn_run} runs, longest "
          f"{zlongest}): kernel {zipf_ms:.4f} ms, index_add_ "
          f"{zipf_library_ms:.4f} ms, bound {zipf_bound_ms:.6f} ms")
    report["ct_scatter_bag"] = dict(
        name="ct_scatter_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/ct_scatter.cu",
        replaces="src/repro/kernels/embedding_bag.py:377",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, prep_ms=prep_ms, zero_fill_ms=zero_ms,
                wrapper_ms=wrapper_ms, runs=n_run, live_entries=n_live,
                longest_run=longest, zipf_kernel_ms=zipf_ms,
                zipf_library_ms=zipf_library_ms, zipf_bound_ms=zipf_bound_ms,
                zipf_runs=zn_run, zipf_live_entries=zn_live,
                zipf_longest_run=zlongest)


def check_train(dev, spec, res):
    """One step's gradients against the plain scatter of the same
    cotangent, a repeated batch's loss, and the train step's stages on the
    device (CUDA events, L2 flushed)."""
    import torch
    from repro_torch.kernels.embedding_bag import ct_scatter_bag_plain
    from repro_torch.launch.train import build_loss
    from repro_torch.models import dlrm
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import (_not_table, build_train_step,
                                              default_optimizer)
    cfg = spec.config
    state, batch, st = res.state, res.last_batch, res.statics
    loss_fn, kw = build_loss(spec, cfg, st)
    leaves = [p.detach().requires_grad_(True)
              for p in O.tree_leaves(state.params)]
    params = O.tree_unflatten(state.params, leaves)

    # one step's gradients, with the bag sums' cotangent caught on the way
    caught = {}
    lookup = dlrm.banked_embedding_bag

    def hooked(*a, **k):
        out = lookup(*a, **k)
        out.register_hook(lambda g: caught.__setitem__("ct", g))
        return out
    dlrm.banked_embedding_bag = hooked
    try:
        loss = loss_fn(params, batch, **kw)
    finally:
        dlrm.banked_embedding_bag = lookup
    grads = O.tree_unflatten(state.params, torch.autograd.grad(loss, leaves))
    table_g = grads["emb_packed"]
    want = ct_scatter_bag_plain(
        caught["ct"].reshape(-1, cfg.embed_dim).contiguous(),
        batch["sparse"].reshape(-1, cfg.multi_hot).contiguous(),
        st["remap_bank"], st["remap_flat"], st["field_offsets"], -1,
        table_g.shape[0])
    need(torch.equal(table_g, want),
         "train step: table gradient != plain scatter of the same cotangent")
    rows = int((table_g != 0).any(1).sum())
    bot = [float(g.abs().sum()) for g in grads["bot"]["w"]]
    need(rows > 0 and all(x > 0 for x in bot),
         f"train step: a gradient cut ({rows} table rows, bottom MLP |g| "
         f"{bot})")
    print(f"train step gradients: table gradient == plain scatter of the "
          f"same cotangent ({rows} rows non-zero); bottom MLP |g| sums "
          + ", ".join(f"{x:.4g}" for x in bot))
    del want, caught

    # a batch repeated lowers its loss (tests/test_train.py's learning rates)
    rep_step = build_train_step(loss_fn, default_optimizer(lr=1e-2,
                                                           emb_lr=5e-2),
                                loss_kwargs=kw)
    s, rep = state, []
    for _ in range(20):
        s, m = rep_step(s, batch)
        rep.append(float(m["loss"]))
    del s
    need(rep[-1] < rep[0], f"repeated batch: loss {rep[0]} -> {rep[-1]}")
    print(f"one batch repeated 20 times: loss {rep[0]:.6f} -> {rep[-1]:.6f}")

    # the stages on the device
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    opt = default_optimizer()
    step_fn = build_train_step(loss_fn, opt, loss_kwargs=kw)
    table_opt = O.rowwise_adagrad(1e-2)
    held = {}

    def forward():
        return loss_fn(params, batch, **kw)

    def with_graph():
        scratch.zero_()
        held["loss"] = forward()

    def backward():
        torch.autograd.grad(held.pop("loss"), leaves)

    def optimizer():
        g, _ = O.clip_by_global_norm_filtered(grads, 1.0, _not_table)
        u, _ = opt.update(g, state.opt_state, state.params)
        return O.tree_map(lambda p, u: p + u.to(p.dtype), state.params, u)

    def table_update():
        u, _ = table_opt.update([table_g], state.opt_state["true"],
                                [state.params["emb_packed"]])
        return state.params["emb_packed"] + u[0]

    out = {"forward": time_ms(forward, flush=scratch.zero_),
           "backward": time_ms(backward, flush=with_graph),
           "optimizer": time_ms(optimizer, flush=scratch.zero_),
           "rowwise_adagrad_table": time_ms(table_update, flush=scratch.zero_),
           "train_step": time_ms(lambda: step_fn(state, batch),
                                 flush=scratch.zero_)}
    del held
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    step_fn(state, batch)
    torch.cuda.synchronize()
    out["allocated_before_step_bytes"] = before
    out["max_allocated_in_step_bytes"] = torch.cuda.max_memory_allocated()
    out["repeated_batch_losses"] = rep
    out["profile"] = profile_device(lambda: step_fn(state, batch))
    print("train step breakdown (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()
                      if k.endswith(("forward", "backward", "optimizer",
                                     "table", "step"))))
    print(f"  device memory: {before / 2**30:.3f} GiB allocated before a "
          f"step, peak {out['max_allocated_in_step_bytes'] / 2**30:.3f} GiB "
          f"during it")
    prof = out["profile"]
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per train step: device busy {prof['busy_ms']:.4f}"
              f" ms of a {prof['window_ms']:.4f} ms window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
    return out


def check_train_reduced(dev, spec):
    """A reduced config trained for 3 steps on the card and on the CPU from
    the same weights on the same batches: losses within LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic as syn
    from repro_torch.launch.train import build_loss
    from repro_torch.models import dlrm
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    red = spec.reduced
    params, statics = dlrm.init_params(red, torch.Generator().manual_seed(4),
                                       device="cpu")
    losses = {}
    for where in ("cpu", dev):
        p, s = to_dev(params, where), to_dev(statics, where)
        loss_fn, kw = build_loss(spec, red, s)
        opt = default_optimizer()
        step = build_train_step(loss_fn, opt, loss_kwargs=kw)
        state = TrainState.create(p, opt)
        ls = []
        for i in range(3):
            b = syn.dlrm_batch(red.vocab_sizes, red.n_dense, 16, seed=6,
                               step=i, multi_hot=red.multi_hot)
            state, m = step(state, to_dev({k: torch.from_numpy(v)
                                           for k, v in b.items()}, where))
            ls.append(float(m["loss"]))
        losses[str(where)] = ls
    cpu, card = losses["cpu"], losses[str(dev)]
    need(np.allclose(card, cpu, rtol=LOSS_RTOL, atol=0),
         f"reduced config train, card vs CPU: losses {card} vs {cpu}")
    print(f"reduced config trained 3 steps on the card vs the CPU, same "
          f"weights: losses {card} vs {cpu}")
    return dict(card=card, cpu=cpu)


def cached_main_path(dev, spec):
    """Phase 5's main path: ``run_cached`` at full width with every launch
    counter set to 0 just before and read just after."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_cached
    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    for fn in counters.values():
        fn.launches = 0
    res = run_cached(spec, spec.config, requests=CACHED_REQUESTS, batch=64,
                     device=dev, profile_requests=CACHED_PROFILE)
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"serve_cached: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("cache_residual_bag", "dot_features"):
        need(launches[name] > 0, f"the cached serve run launched no {name} "
                                 f"kernel")
    for name in ("banked_bag", "ct_scatter_bag", "dot_interaction"):
        need(launches[name] == 0, f"the cached serve run launched {name} "
                                  f"{launches[name]} times")
    st = res.stats
    print(f"  mined {st['mined_groups']} groups, {st['mined_entries']} "
          f"entries from {st['profile_bags']} profiled bags; kept "
          f"{st['kept_entries']}, dropped {st['dropped_entries']} (capacity "
          f"{st['cache_capacity']}); plan imbalance "
          f"{st['plan_imbalance']:.6f}, EMT rows/bank {st['emt_rows_per_bank']}")
    print(f"  hit rate on the served bags {st['hit_rate']:.6f} (uncapped "
          f"mined plan {st['hit_rate_uncapped']:.6f}); effective lengths: "
          f"cache mean {st['cache_len_mean']:.3f} max {st['cache_len_max']}, "
          f"residual mean {st['residual_len_mean']:.3f} max "
          f"{st['residual_len_max']}")
    print("  pre-process seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in st.items() if k.endswith("_s")))
    return res, launches


def cached_small_cases(dev):
    """bf16 D = 64 (a fp32 cache table, cast by the wrapper) and a ragged
    fp32 NB = 37, Lc = 5, Lr = 33, D = 40 case with all-pad bags: an EMT
    over a 4-bank §3.2 plan with the flat remap, a 128-entry 4-bank cache
    table with a permuted slot map."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    out = []
    for c in small_cases(dev, cases=(("bfloat16", 64, 100, 64, 1),
                                     ("float32", 40, 37, 33, 1))):
        NB, D = c["idx"].shape[0], c["table"].shape[1]
        Lc = 16 if NB == 100 else 5
        ci = torch.randint(-1, 128, (NB, Lc), generator=g, device=dev,
                           dtype=torch.int32)
        ci[::7] = -1                                     # all-pad bags
        out.append(dict(
            name=c["name"] + f" Lc={Lc}", emt=c["table"],
            e_bank=c["bank"], e_slot=c["slot"], r_idx=c["idx"],
            cache=torch.randn((128, D), generator=g, device=dev),
            c_bank=torch.arange(128, dtype=torch.int32, device=dev) // 32,
            c_slot=torch.randperm(128, generator=g, device=dev).to(
                torch.int32),
            c_idx=ci))
    return out


CACHE_LIVE = (0, 1, 255, 256, 257, 600)   # live entries of a bag


def cache_adversarial_cases(dev):
    """Tables and streams against the fused kernel's resolve-once ring:
    every D of ``BAG_DIMS`` in fp32 and bf16 (16-, 4- and 2-byte copies;
    one to three column passes), each over Lc + Lr = 64 + 520 entries with
    bags whose live entries, both streams together, number ``CACHE_LIVE``
    (0, 1, around a 256-row ring, all 584: past a 512-entry round), at
    random places within the first round where they fit (interior holes,
    compacted lists of exactly 255, 256 and 257 rows, a round of 512 and
    one of 72); NB from 37 to 41, so bags per block never
    divide it; then bags live in the cache stream only and in the residual
    stream only, Lc = 0 and Lr = 0 as shapes, a stream of padding only,
    4,301 bags (two a block), an EMT and a cache table whose bases are 4
    bytes off 16-byte alignment, and 100 + 1,100 entries (three rounds).
    Each case carries an EMT of 4 x 2,400 rows with 8-bank remaps of 2,400
    ids, a cache table of 600 rows with remaps of 300 ids, the streams, and
    the same streams as identity rows of the two tables."""
    import numpy as np
    import torch
    rng = np.random.default_rng(29)
    V, VC, R, RC = 2400, 300, 9600, 600
    shapes = []
    for dtype in ("float32", "bfloat16"):
        for D in BAG_DIMS:
            shapes.append((dtype, D, 64, 520, 37 + len(shapes) % 5,
                           "live counts"))
    shapes += [("float32", 32, 64, 256, 40, "cache stream only"),
               ("float32", 33, 64, 256, 40, "residual stream only"),
               ("float32", 32, 0, 256, 40, "Lc = 0"),
               ("bfloat16", 32, 64, 0, 40, "Lr = 0"),
               ("bfloat16", 64, 64, 256, 16, "padding only"),
               ("float32", 32, 64, 256, 4301, "two bags a block"),
               ("float32", 32, 64, 256, 40, "EMT base 4 B off alignment"),
               ("float32", 32, 64, 256, 40, "cache base 4 B off alignment"),
               ("float32", 33, 100, 1100, 24, "three rounds")]
    out = []
    for dtype, D, Lc, Lr, NB, note in shapes:
        tdt = getattr(torch, dtype)

        def table(n, off):
            t = torch.from_numpy(rng.standard_normal((n * D + 1,))
                                 .astype(np.float32)).to(dev).to(tdt)
            return t[1:].view(n, D) if off else t[:n * D].view(n, D)
        emt = table(R, note.startswith("EMT base"))
        cache = table(RC, note.startswith("cache base"))
        live = rng.random((NB, Lc + Lr)) < 0.6
        live[::5] = False                           # all-padding bags
        if note == "live counts":
            for b in range(NB):      # in the first round where they fit
                n = min(CACHE_LIVE[b % len(CACHE_LIVE)], Lc + Lr)
                live[b] = False
                live[b, rng.choice(Lc + Lr if n > 512 else min(Lc + Lr, 512),
                                   n, replace=False)] = True
        elif note == "cache stream only":
            live[:, Lc:] = False
        elif note == "residual stream only":
            live[:, :Lc] = False
        elif note == "padding only":
            live[:] = False
        ci = np.where(live[:, :Lc], rng.integers(0, VC, (NB, Lc)), -1)
        ri = np.where(live[:, Lc:], rng.integers(0, V, (NB, Lr)), -1)
        ci_rows = np.where(ci >= 0, rng.integers(0, RC, ci.shape), -1)
        ri_rows = np.where(ri >= 0, rng.integers(0, R, ri.shape), -1)

        def ids(a):
            return torch.from_numpy(a.astype(np.int32)).to(dev)

        def remap(n, rows):
            return (ids(rng.integers(0, 8, n)), ids(rng.integers(0, rows, n)))
        out.append(dict(
            name=f"{dtype} D={D} Lc={Lc} Lr={Lr} NB={NB} ({note})",
            emt=emt, cache=cache, emt_remap=remap(V, R),
            cache_remap=remap(VC, RC), c_idx=ids(ci), r_idx=ids(ri),
            c_rows=ids(ci_rows), r_rows=ids(ri_rows)))
    return out


def check_cache_adversarial(dev, errs):
    """Both instances of the fused kernel against their plain versions, bit
    for bit, on ``cache_adversarial_cases``: the remapped instance with my =
    -1, my = 3 on the 8-bank maps, and my = 0 on live maps (bank 5 dead);
    the identity instance on the identity rows."""
    import torch
    from repro_torch.kernels.embedding_bag import (cache_residual_bag,
                                                   cache_residual_bag_plain,
                                                   plain_cache_bag,
                                                   plain_cache_bag_plain)
    n = 0
    for c in cache_adversarial_cases(dev):
        (eb, es), (cb, cs) = c["emt_remap"], c["cache_remap"]
        e_live = (eb != 5).to(torch.int32) ^ 1        # 0 where live
        c_live = (cb != 5).to(torch.int32) ^ 1
        for my, ebk, cbk in ((-1, eb, cb), (3, eb, cb), (0, e_live, c_live)):
            a = (c["emt"], c["cache"], ebk, es, cbk, cs, my, c["c_idx"],
                 c["r_idx"])
            got, want = cache_residual_bag(*a), cache_residual_bag_plain(*a)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item() \
                if got.numel() else 0.0
            need(got.dtype == want.dtype and torch.equal(got, want),
                 f"cache_residual_bag {c['name']} my={my}: kernel != plain "
                 f"(max abs err {err})")
            errs.append(err)
            n += 1
        # bank 3's local shards of both tables beside NaN rows
        e_sh, e_loc = shard_beside_nan(c["emt"], eb, es, 3)
        c_sh, c_loc = shard_beside_nan(c["cache"], cb, cs, 3)
        a = (e_sh, c_sh, eb, e_loc, cb, c_loc, 3, c["c_idx"], c["r_idx"])
        got, want = cache_residual_bag(*a), cache_residual_bag_plain(*a)
        whole = cache_residual_bag(c["emt"], c["cache"], eb, es, cb, cs, 3,
                                   c["c_idx"], c["r_idx"])
        torch.cuda.synchronize()
        need(torch.equal(got, want) and torch.equal(got, whole),
             f"cache_residual_bag {c['name']} on bank 3's shards: != plain "
             f"or != the whole tables' bank-3 sums (another bank's entry "
             f"added?)")
        n += 2
        a = (c["emt"], c["cache"], c["c_rows"], c["r_rows"])
        got, want = plain_cache_bag(*a), plain_cache_bag_plain(*a)
        torch.cuda.synchronize()
        need(got.dtype == want.dtype and torch.equal(got, want),
             f"plain_cache_bag {c['name']}: kernel != plain")
        n += 1
    print(f"  cache_bag adversarial cases: {n} calls (both instances, and "
          f"the remapped one on bank 3's shards beside NaN rows; D "
          f"{BAG_DIMS}, live lists {CACHE_LIVE}) == plain")


def cache_bag_bound_ms(ci, ri, dim, itemsize, *, remap=True):
    """Least time for one ``my = -1`` fused call on these ids, summed over
    both streams: each id read once, each distinct row of each table read
    once (its 4-byte slot, unless ``remap=False``, and its D values), the
    output written once; or the fp32 adds, if more."""
    import torch
    NB = ci.shape[0]
    n_rows = sum(torch.unique(x[x >= 0]).numel() for x in (ci, ri))
    n_valid = int((ci >= 0).sum()) + int((ri >= 0).sum())
    nbytes = (ci.numel() + ri.numel()) * 4 \
        + n_rows * (4 * remap + dim * itemsize) + NB * dim * itemsize
    return least_ms(nbytes, n_valid * dim)


def check_cache_kernel(dev, res, report):
    """The fused kernel vs its plain version, bit for bit, at the cached
    serve path's shape (its last batch's rewritten ids, with holes, my = 3
    and a dead bank) and on small bf16 / ragged cases; then the timings at
    the serve shape."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels.embedding_bag import (cache_residual_bag,
                                                   cache_residual_bag_plain)
    from repro_torch.models import dlrm
    t, ct = dlrm._banked(res.params, res.statics), res.cache_table
    b = res.last_batch
    ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1]).contiguous()
    ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1]
                                   ).contiguous()
    g = torch.Generator(device=dev).manual_seed(13)
    ci_h, ri_h = ci.clone(), ri.clone()
    ci_h[torch.rand(ci.shape, generator=g, device=dev) < 0.1] = -1
    ri_h[torch.rand(ri.shape, generator=g, device=dev) < 0.1] = -1
    live = torch.ones(t.n_banks, dtype=torch.bool, device=dev)
    live[5] = False
    e_live = torch.where(live[t.remap_bank.long()], 0, 1).to(torch.int32)
    c_live = torch.where(live[ct.remap_bank.long()], 0, 1).to(torch.int32)
    errs = []

    def same(name, emt, cache, eb, es, cb, cs, my, c_idx, r_idx):
        args = (emt, cache, eb, es, cb, cs, my, c_idx, r_idx)
        got = cache_residual_bag(*args)
        want = cache_residual_bag_plain(*args)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype == emt.dtype,
             f"cache_residual_bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        need(torch.equal(got, want),
             f"cache_residual_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"cache_residual_bag {name}: non-finite")
        errs.append(err)
        print(f"  cache_residual_bag {name}: {tuple(got.shape)} {got.dtype} "
              f"== plain (max abs err {err})")

    print(f"cache_residual_bag vs plain, bit for bit (EMT "
          f"{tuple(t.packed.shape)}, cache {tuple(ct.packed.shape)}, ids "
          f"{tuple(ci.shape)} + {tuple(ri.shape)}):")
    maps = (t.packed, ct.packed, t.remap_bank, t.remap_flat, ct.remap_bank,
            ct.remap_flat)
    same("served ids, my=-1", *maps, -1, ci, ri)
    same("served ids + holes, my=-1", *maps, -1, ci_h, ri_h)
    same("served ids + holes, my=3 bank maps", *maps, 3, ci_h, ri_h)
    same("served ids + holes, bank 5 dead (binary live maps, my=0)",
         t.packed, ct.packed, e_live, t.remap_flat, c_live, ct.remap_flat, 0,
         ci_h, ri_h)
    for c in cached_small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["emt"], c["cache"], c["e_bank"],
                 c["e_slot"], c["c_bank"], c["c_slot"], my, c["c_idx"],
                 c["r_idx"])
    check_cache_adversarial(dev, errs)

    # timings at the serve shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (*maps, -1, ci, ri)
    R = t.packed.shape[0]
    both = torch.cat([t.packed, ct.packed])
    ids = torch.cat([torch.where(ci >= 0, ct.remap_flat[ci.clamp(min=0).long()]
                                 + R, -1),
                     torch.where(ri >= 0, t.remap_flat[ri.clamp(min=0).long()],
                                 -1)], dim=1)
    valid = ids >= 0
    lib_ids = ids[valid].long()
    lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
    lib = lambda: tnf.embedding_bag(lib_ids, both, lib_offsets,  # noqa: E731
                                    mode="sum")
    need(torch.allclose(lib(), cache_residual_bag(*args), **EMB_TOL),
         "embedding_bag library call disagrees with the kernel")
    ms = time_ms(lambda: cache_residual_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: cache_residual_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    del both
    bound_ms, bound_by = cache_bag_bound_ms(ci, ri, t.dim,
                                            t.packed.element_size())
    n_c, n_r = int((ci >= 0).sum()), int((ri >= 0).sum())
    print(f"cache_residual_bag at NB={ci.shape[0]} Lc={ci.shape[1]} "
          f"Lr={ri.shape[1]} D={t.dim} fp32 ({n_c} cache + {n_r} residual "
          f"entries): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.embedding_bag {library_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by})")
    report["cache_residual_bag"] = dict(
        name="cache_residual_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:245",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, cache_entries=n_c, residual_entries=n_r)


def resolve_ids(ids, remap_flat):
    """-1 padded ids through a flat remap, padding kept: the identity-layout
    ids of the same rows."""
    import torch
    return torch.where(ids >= 0, remap_flat[ids.clamp(min=0).long()],
                       -1).to(torch.int32).contiguous()


def check_plain_cache_kernel(dev, res, report):
    """Kernel 8 (the identity instance of ``cache_bag.cu``) on the cached
    serve path's last batch, both streams resolved through their remaps:
    ``kernels.ops.cache_bag`` is run with its launch counter set to 0 just
    before and read just after; it equals ``cache_bag.cu`` on the raw
    streams and its plain version bit for bit, and so do the small bf16 /
    ragged cases; then the timings beside its bound and two
    ``F.embedding_bag`` calls summed."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ops as kops
    from repro_torch.models import dlrm
    t, ct = dlrm._banked(res.params, res.statics), res.cache_table
    b = res.last_batch
    ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1]).contiguous()
    ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1]
                                   ).contiguous()
    ci_r, ri_r = resolve_ids(ci, ct.remap_flat), resolve_ids(ri, t.remap_flat)
    kbag.plain_cache_bag.launches = 0
    got = kops.cache_bag(t.packed, ct.packed, ci_r, ri_r)
    launches = {"plain_cache_bag": kbag.plain_cache_bag.launches}
    torch.cuda.synchronize()
    need(launches["plain_cache_bag"] > 0,
         "kernels.ops.cache_bag launched no plain_cache_bag kernel")
    banked = kbag.cache_residual_bag(t.packed, ct.packed, t.remap_bank,
                                     t.remap_flat, ct.remap_bank,
                                     ct.remap_flat, -1, ci, ri)
    plain = kbag.plain_cache_bag_plain(t.packed, ct.packed, ci_r, ri_r)
    torch.cuda.synchronize()
    need(torch.equal(got, banked), "plain_cache_bag on resolved ids != "
                                   "cache_residual_bag on the raw streams")
    need(torch.equal(got, plain), "plain_cache_bag != its plain version")
    errs = [(got - plain).abs().max().item()]
    print(f"plain_cache_bag (kernel 8) on the served streams resolved: "
          f"{tuple(got.shape)} == cache_residual_bag on the raw streams == "
          f"plain, bit for bit; launches {launches}")
    for c in cached_small_cases(dev):
        args = (c["emt"], c["cache"], c["c_idx"], c["r_idx"])
        k, pl = kbag.plain_cache_bag(*args), kbag.plain_cache_bag_plain(*args)
        torch.cuda.synchronize()
        need(k.dtype == c["emt"].dtype and torch.equal(k, pl),
             f"plain_cache_bag {c['name']}: kernel != plain")
        errs.append((k.float() - pl.float()).abs().max().item())
        print(f"  plain_cache_bag {c['name']}: == plain")

    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (t.packed, ct.packed, ci_r, ri_r)
    ids_c, ids_r = ci_r[ci_r >= 0].long(), ri_r[ri_r >= 0].long()
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    off_c = torch.cat([zero, (ci_r >= 0).sum(1).cumsum(0)[:-1]])
    off_r = torch.cat([zero, (ri_r >= 0).sum(1).cumsum(0)[:-1]])
    lib = lambda: (tnf.embedding_bag(ids_c, ct.packed, off_c, mode="sum")  # noqa: E731
                   + tnf.embedding_bag(ids_r, t.packed, off_r, mode="sum"))
    need(torch.allclose(lib(), got, **EMB_TOL),
         "two embedding_bag library calls disagree with the kernel")
    ms = time_ms(lambda: kbag.plain_cache_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: kbag.plain_cache_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    bound, bound_by = cache_bag_bound_ms(ci_r, ri_r, t.dim,
                                         t.packed.element_size(), remap=False)
    print(f"plain_cache_bag at NB={ci.shape[0]} Lc={ci.shape[1]} "
          f"Lr={ri.shape[1]} D={t.dim} fp32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, 2x F.embedding_bag {library_ms:.4f} ms, bound "
          f"{bound:.6f} ms ({bound_by})")
    report["plain_cache_bag"] = dict(
        name="plain_cache_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/cache_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:213",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by=bound_by, library_ms=library_ms)
    return launches, dict(kernel_ms=ms, plain_ms=plain_ms,
                          library_ms=library_ms, bound_ms=bound)


def check_cached_grads(dev, res):
    """Backward through ``banked_cache_residual_bag`` with both tables
    requiring grad: each table's gradient equals the plain scatter of the
    same cotangent bit for bit. Then the scatter kernel with an fp32
    cotangent onto bf16 tables and the reverse, against its plain
    version."""
    import dataclasses

    import torch
    from repro_torch.core.embedding import banked_cache_residual_bag
    from repro_torch.kernels.embedding_bag import (ct_scatter_bag,
                                                   ct_scatter_bag_plain)
    from repro_torch.models import dlrm
    t, ct_tab = dlrm._banked(res.params, res.statics), res.cache_table
    b = res.last_batch
    ep = t.packed.detach().requires_grad_(True)
    cp = ct_tab.packed.detach().clone().requires_grad_(True)
    out = banked_cache_residual_bag(dataclasses.replace(t, packed=ep),
                                    dataclasses.replace(ct_tab, packed=cp),
                                    b["cache_idx"], b["residual_idx"])
    g = torch.Generator(device=dev).manual_seed(17)
    cot = torch.randn(out.shape, generator=g, device=dev)
    d_emt, d_cache = torch.autograd.grad(out, [ep, cp], cot)
    D = t.dim
    ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1]).contiguous()
    ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1]
                                   ).contiguous()
    flat = cot.reshape(-1, D).contiguous()
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    want_c = ct_scatter_bag_plain(flat, ci, ct_tab.remap_bank,
                                  ct_tab.remap_flat, zero, -1, cp.shape[0])
    need(torch.equal(d_cache, want_c), "cached path: d_cache != plain scatter")
    rows_c = int((d_cache != 0).any(1).sum())
    del want_c
    want_e = ct_scatter_bag_plain(flat, ri, t.remap_bank, t.remap_flat, zero,
                                  -1, ep.shape[0])
    need(torch.equal(d_emt, want_e), "cached path: d_emt != plain scatter")
    rows_e = int((d_emt != 0).any(1).sum())
    need(rows_e > 0 and rows_c > 0, f"cached path: a gradient cut ({rows_e} "
                                    f"EMT rows, {rows_c} cache rows)")
    del want_e, d_emt, out
    print(f"cached path gradients: d_emt ({rows_e} rows non-zero) and d_cache "
          f"({rows_c} rows non-zero) == plain scatter of the same cotangent")

    mixes = []
    for ct_dtype, out_dtype in ((torch.float32, torch.bfloat16),
                                (torch.bfloat16, torch.float32)):
        c = flat.to(ct_dtype)
        for name, idx, bank, slot, n in (
                ("residual ids onto the EMT", ri, t.remap_bank, t.remap_flat,
                 ep.shape[0]),
                ("cache ids onto the cache table", ci, ct_tab.remap_bank,
                 ct_tab.remap_flat, cp.shape[0])):
            got = ct_scatter_bag(c, idx, bank, slot, zero, -1, n, out_dtype)
            want = ct_scatter_bag_plain(c, idx, bank, slot, zero, -1, n,
                                        out_dtype)
            torch.cuda.synchronize()
            need(got.dtype == out_dtype and torch.equal(got, want),
                 f"ct_scatter_bag {ct_dtype} -> {out_dtype}, {name}: kernel "
                 f"!= plain")
            mixes.append(f"{str(ct_dtype)[6:]} -> {str(out_dtype)[6:]} {name}")
            del got, want
    print("ct_scatter_bag dtype mixes == plain, bit for bit: "
          + "; ".join(mixes))
    return dict(d_emt_rows=rows_e, d_cache_rows=rows_c, mixes=mixes)


def dedup_sparse(union, offs, L):
    """(B, F, L) union-vocab ids -> each bag's distinct ids, sorted, back to
    per-field ids, -1 padded: the bag the cached path sums."""
    import numpy as np
    B, F, _ = union.shape
    out = np.full((B, F, L), -1, dtype=np.int32)
    for b in range(B):
        for f in range(F):
            u = np.unique(union[b, f][union[b, f] >= 0])
            out[b, f, :u.size] = u - offs[f]
    return out


def check_cached_outputs(dev, spec, res):
    """Cached scores finite, in (0, 1); the last batch's embeddings and
    scores against the plain path (the bag kernel) on the deduplicated bags,
    within atol 1e-5; the reduced config's cached run on the card against
    the CPU on the same weights."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import (banked_cache_residual_bag,
                                            banked_embedding_bag)
    from repro_torch.launch.serve import run_cached
    from repro_torch.models import dlrm
    cfg = spec.config
    need(tuple(res.scores.shape) == (CACHED_REQUESTS,),
         f"cached scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite cached scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "cached scores outside (0, 1)")
    b = res.last_batch
    sparse = torch.from_numpy(dedup_sparse(res.last_union, cfg.field_offsets(),
                                           cfg.multi_hot)).to(dev)
    t = dlrm._banked(res.params, res.statics)
    with torch.inference_mode():
        emb_c = banked_cache_residual_bag(t, res.cache_table, b["cache_idx"],
                                          b["residual_idx"])
        emb_p = banked_embedding_bag(t, sparse,
                                     field_offsets=res.statics["field_offsets"])
        plain = torch.sigmoid(dlrm.forward(cfg, res.params, res.statics,
                                           {"dense": b["dense"],
                                            "sparse": sparse}))
    e_err = (emb_c - emb_p).abs().max().item()
    n = (CACHED_REQUESTS - 1) % 64 + 1           # real requests of the batch
    plain = plain[:n]
    s_err = (plain - res.scores[-n:]).abs().max().item()
    need(torch.allclose(emb_c, emb_p, **EMB_TOL),
         f"cached vs plain embeddings on deduplicated bags: max abs err "
         f"{e_err}")
    need(torch.allclose(res.scores[-n:], plain, **EMB_TOL),
         f"cached vs plain scores on deduplicated bags: max abs err {s_err}")
    print(f"cached outputs: finite, in (0, 1); last batch vs the plain path "
          f"(bag kernel) on the deduplicated bags: embeddings max abs err "
          f"{e_err}, scores max abs err {s_err} (atol 1e-5)")

    red = spec.reduced
    cpu = run_cached(spec, red, requests=32, batch=16, device="cpu",
                     profile_requests=16, seed=3)
    card = run_cached(spec, red, requests=32, batch=16, device=dev,
                      profile_requests=16, seed=3,
                      params=to_dev(cpu.params, dev))
    for k in ("cache_idx", "residual_idx"):
        need(torch.equal(card.last_batch[k].cpu(), cpu.last_batch[k]),
             f"reduced cached run: {k} card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced cached run, card vs CPU: max abs err {err}")
    print(f"reduced config cached run on the card (fused kernel) vs the CPU "
          f"(jnp order), same weights: rewritten ids equal, scores max abs "
          f"err {err} (rtol 1e-5/atol 1e-6)")
    return dict(emb_err=e_err, score_err=s_err, reduced_score_err=err,
                reduced_hit_rate=cpu.stats["hit_rate"])


def cached_breakdown(dev, spec, res, plain_step_ms):
    """Device time of the cached serve step and its lookup (CUDA events, L2
    flushed) beside phase 3's plain step; the host's per-batch times from
    the run."""
    import torch
    from repro_torch.core.embedding import banked_cache_residual_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve_cached
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    t = dlrm._banked(res.params, res.statics)
    b = res.last_batch
    serve = build_recsys_serve_cached(dlrm, spec.config, res.statics,
                                      res.cache_table)
    with torch.inference_mode():
        out = {"serve_step": time_ms(lambda: serve(res.params, b),
                                     flush=scratch.zero_),
               "lookup": time_ms(lambda: banked_cache_residual_bag(
                   t, res.cache_table, b["cache_idx"], b["residual_idx"]),
                   flush=scratch.zero_)}
        prof = profile_device(lambda: serve(res.params, b), n=5)
    out["plain_serve_step"] = plain_step_ms
    host = {f"{k}_host_ms": statistics.median(v)
            for k, v in res.host_ms.items()}
    print(f"cached serve step (device ms, L2 flushed): {out['serve_step']:.4f}"
          f" (lookup {out['lookup']:.4f}) against the plain step "
          f"{plain_step_ms:.4f}")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per cached serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    print("one cached batch of 64 on the host (median over the run, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    print("  per batch, rewrite ms: "
          + ", ".join(f"{x:.3f}" for x in res.host_ms["rewrite"]))
    return {**out, **host}


def adaptive_main_path(dev, spec):
    """Phase 6's main path: ``run_adaptive`` at full width on the int4 tier
    lane, with every launch counter set to 0 just before and read just
    after. ``min_swaps=1`` makes the run itself raise unless a swap took
    place, the shapes stayed stable and the first re-tier equals a fresh
    build bit for bit."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_adaptive
    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction,
                "tiered_bag": kbag.tiered_bag}
    for fn in counters.values():
        fn.launches = 0
    res = run_adaptive(spec, spec.config, quant="int4",
                       requests=ADAPTIVE_REQUESTS, batch=64,
                       replan_every=ADAPTIVE_REPLAN, min_swaps=1, device=dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    need_warm_probe(res, "serve_adaptive")
    print(f"serve_adaptive: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("tiered_bag", "dot_features"):
        need(launches[name] > 0, f"the adaptive serve run launched no {name} "
                                 f"kernel")
    for name in ("banked_bag", "cache_residual_bag", "ct_scatter_bag",
                 "dot_interaction"):
        need(launches[name] == 0, f"the adaptive serve run launched {name} "
                                  f"{launches[name]} times")
    need(res.checks["shapes_stable"] and res.checks["retier_ok"] is True,
         f"adaptive swap checks {res.checks}")
    tt = res.runtime.tiered
    counts = [int((tt.tier == k).sum()) for k in range(3)]
    print(f"  tiered table: payload {tuple(tt.payload.shape)} int8 "
          f"({tt.payload.numel() / 1e9:.3f} GB), scales and tiers "
          f"({tt.scale.numel()},) each, hot {tt.hot_dtype}; packed rows by "
          f"tier (hot, int8, int4 incl. pad slots as int8): {counts}")
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] imbalance {e.old_imbalance:.6f} -> "
              f"{e.new_imbalance:.6f}; tiers v{e.tier_version} "
              f"+{e.tier_promoted}/-{e.tier_demoted} (requant "
              f"{e.tier_requantized})")
    print(f"  swap checks: shapes stable {res.checks['shapes_stable']}, "
          f"re-tier == fresh build {res.checks['retier_ok']}")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
    return res, launches


def tiered_small_cases(dev):
    """Tiered tables beside the served one, quantized on the host from the
    phase-2 small tables: int8 only (D = 32, NB = 512, L = 256), an fp32
    hot tier with all three tiers (D = 64), bf16 hot at D = 160 (two
    passes), and a ragged D = 33 case (odd int4 width) with all-pad bags."""
    import numpy as np
    import torch
    from repro_torch.quant import (TIER_INT8, dequant_rows_f32,
                                   quantize_rows)
    rng = np.random.default_rng(19)
    out = []
    for c, hot, int8_only in zip(
            small_cases(dev, cases=(("float32", 32, 512, 256, 8),
                                    ("float32", 64, 100, 40, 4),
                                    ("float32", 160, 24, 20, 3),
                                    ("float32", 33, 37, 33, 5))),
            ("bf16", "fp32", "bf16", "bf16"), (True, False, False, False)):
        rows = (c["table"] * 0.05).cpu().numpy()
        R, D = rows.shape
        tier = np.full(R, TIER_INT8, np.int32) if int8_only \
            else rng.integers(0, 3, R).astype(np.int32)
        payload, scale = quantize_rows(rows, tier, hot_dtype=hot)
        tt = dict(payload=torch.from_numpy(payload).to(dev),
                  scale=torch.from_numpy(scale).to(dev),
                  tier=torch.from_numpy(tier).to(dev))
        need(torch.equal(dequant_rows_f32(tt["payload"], tt["scale"],
                                          tt["tier"], D, hot).cpu(),
                         dequant_rows_f32(*(torch.from_numpy(a) for a in
                                            (payload, scale, tier)), D, hot)),
             "dequant_rows_f32: card != CPU")
        name = ("int8 only " if int8_only else f"{hot} hot ") + c["name"]
        out.append(dict(name=name, hot=hot, dim=D, bank=c["bank"],
                        slot=c["slot"], off=c["off"], idx=c["idx"], **tt))
    return out


def tiered_adversarial_cases(dev):
    """Tiered tables shaped against the kernel's chunking (a 256-thread
    block per bag, 8,192 staged fp32 values): tiers cycling hot, int8, int4
    by row so every 32-entry chunk mixes all three; bags longer than the
    block and not a multiple of 32 (L = 300); L x D past the staging
    buffer (D = 64, L = 300); an all-int4 table at D = 33 (odd width);
    an fp32 hot tier at D = 160; D = 300 (two column passes). Rows are
    packed at slot = row, banks row % 4, 4 fields; 10% holes and all-pad
    bags. -> [dict(name, payload, scale, tier, bank, slot, off, idx, dim,
    hot)]."""
    import numpy as np
    import torch
    from repro_torch.quant import TIER_INT4, quantize_rows
    rng = np.random.default_rng(37)
    out = []
    for name, D, NB, L, hot, tiers in (
            ("tiers cycling by row, every chunk mixed", 32, 64, 256, "bf16",
             "cycle"),
            ("L = 300, past the block", 32, 40, 300, "bf16", "random"),
            ("L x D past the staging buffer", 64, 24, 300, "bf16", "random"),
            ("int4 only, D = 33", 33, 37, 77, "bf16", "int4"),
            ("fp32 hot, D = 160", 160, 24, 100, "fp32", "random"),
            ("D = 300, two column passes", 300, 12, 40, "bf16", "random")):
        F, per_field = 4, 3000
        R = F * per_field
        rows = (rng.standard_normal((R, D)) * 0.05).astype(np.float32)
        tier = {"cycle": np.arange(R) % 3,
                "random": rng.integers(0, 3, R),
                "int4": np.full(R, TIER_INT4)}[tiers].astype(np.int32)
        payload, scale = quantize_rows(rows, tier, hot_dtype=hot)
        ids = rng.integers(0, per_field, (NB, L)).astype(np.int32)
        ids[rng.random(ids.shape) < 0.1] = -1
        ids[::5] = -1                                   # all-pad bags
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
        out.append(dict(
            name=f"{name} ({hot} hot, D={D}, NB={NB}, L={L})",
            payload=t(payload), scale=t(scale), tier=t(tier),
            bank=t((np.arange(R) % 4).astype(np.int32)),
            slot=t(np.arange(R, dtype=np.int32)),
            off=t((np.arange(F) * per_field).astype(np.int32)), idx=t(ids),
            dim=D, hot=hot))
    return out


def tiered_bound_ms(idx, off, n_fields, tt):
    """Least time for one ``my = -1`` tiered call on these ids: each id read
    once, each distinct row touched read once (its 4-byte slot and tier,
    its 4-byte scale unless hot, and its bytes at its own tier's width), the
    fp32 output written once; or the fp32 adds and dequant multiplies, if
    more."""
    import torch
    from repro_torch.quant import TIER_HOT, tier_nbytes
    NB, L = idx.shape
    bag = torch.arange(NB, device=idx.device) % n_fields
    valid = idx >= 0
    rows = (idx.long() + off.long()[bag][:, None])[valid]
    uniq = torch.unique(rows)
    tier = tt.tier[tt.remap_flat[uniq].long()].long()
    lut = torch.as_tensor(tier_nbytes(tt.dim, tt.hot_dtype), device=idx.device)
    nbytes = (NB * L * 4 + off.numel() * 4 + uniq.numel() * 8
              + int((tier != TIER_HOT).sum()) * 4 + int(lut[tier].sum())
              + NB * tt.dim * 4)
    entry_tier = tt.tier[tt.remap_flat[rows].long()]
    return least_ms(nbytes, (rows.numel() + int(
        (entry_tier != TIER_HOT).sum())) * tt.dim)


def check_tiered_kernel(dev, res, report):
    """The tiered kernel vs its plain version, bit for bit (``torch.equal``),
    on the served table at the serve path's shape (its last batch's ids,
    with holes, my = 3, a dead bank) and on the small tables; then the
    timings at the serve shape."""
    import torch
    import torch.nn.functional as tnf
    from repro_torch.kernels.embedding_bag import tiered_bag, tiered_bag_plain
    from repro_torch.quant import TIER_HOT, dequant_rows_f32
    tt = res.runtime.tiered
    off = res.statics["field_offsets"]
    sp = res.last_batch["sparse"]
    F, L = sp.shape[1], sp.shape[2]
    idx = sp.reshape(-1, L).contiguous()
    g = torch.Generator(device=dev).manual_seed(23)
    idx_h = idx.clone()
    idx_h[torch.rand(idx.shape, generator=g, device=dev) < 0.1] = -1
    idx_h[::9] = -1                                       # all-pad bags
    live = torch.ones(tt.n_banks, dtype=torch.bool, device=dev)
    live[5] = False
    live_map = torch.where(live[tt.remap_bank.long()], 0, 1).to(torch.int32)
    errs = []

    def same(name, payload, scale, tier, bank, slot, offs, my, ids, dim, hot):
        args = (payload, scale, tier, bank, slot, offs, my, ids)
        got = tiered_bag(*args, dim=dim, hot_dtype=hot)
        want = tiered_bag_plain(*args, dim=dim, hot_dtype=hot)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype
             == torch.float32, f"tiered_bag {name}: {got.shape}/{got.dtype} "
                               f"vs {want.shape}/{want.dtype}")
        err = (got - want).abs().max().item() if got.numel() else 0.0
        need(torch.equal(got, want),
             f"tiered_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got).all()), f"tiered_bag {name}: non-finite")
        errs.append(err)
        print(f"  tiered_bag {name}: {tuple(got.shape)} == plain (max abs "
              f"err {err})")

    print(f"tiered_bag vs plain, bit for bit (payload "
          f"{tuple(tt.payload.shape)}, ids {tuple(idx.shape)}):")
    maps = (tt.payload, tt.scale, tt.tier)
    same("served ids, live tier map, my=-1", *maps, tt.remap_bank,
         tt.remap_flat, off, -1, idx, tt.dim, tt.hot_dtype)
    same("served ids + holes, my=-1", *maps, tt.remap_bank, tt.remap_flat,
         off, -1, idx_h, tt.dim, tt.hot_dtype)
    same("served ids + holes, my=3 bank map", *maps, tt.remap_bank,
         tt.remap_flat, off, 3, idx_h, tt.dim, tt.hot_dtype)
    same("served ids + holes, bank 5 dead (binary live map, my=0)", *maps,
         live_map, tt.remap_flat, off, 0, idx_h, tt.dim, tt.hot_dtype)
    adversarial = tiered_adversarial_cases(dev)
    for c in tiered_small_cases(dev) + adversarial:
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["payload"], c["scale"], c["tier"],
                 c["bank"], c["slot"], c["off"], my, c["idx"], c["dim"],
                 c["hot"])
    for c in adversarial:
        # bank 3's local shard beside a NaN row: hot, every payload byte
        # 0xFF (a NaN in bf16 and fp32), scale NaN
        nan_row = (torch.full((1, c["payload"].shape[1]), -1,
                              dtype=torch.int8, device=dev),
                   torch.full((1,), float("nan"), device=dev),
                   torch.full((1,), TIER_HOT, dtype=torch.int32, device=dev))
        (pay, sc, ti), local = shard_beside_nan(
            (c["payload"], c["scale"], c["tier"]), c["bank"], c["slot"], 3,
            nan_row)
        same(f"{c['name']} on bank 3's shard beside a NaN row", pay, sc, ti,
             c["bank"], local, c["off"], 3, c["idx"], c["dim"], c["hot"])
        whole = tiered_bag(c["payload"], c["scale"], c["tier"], c["bank"],
                           c["slot"], c["off"], 3, c["idx"], dim=c["dim"],
                           hot_dtype=c["hot"])
        got = tiered_bag(pay, sc, ti, c["bank"], local, c["off"], 3,
                         c["idx"], dim=c["dim"], hot_dtype=c["hot"])
        torch.cuda.synchronize()
        need(torch.equal(got, whole),
             f"tiered_bag {c['name']} on bank 3's shard != the whole "
             f"table's bank-3 sums (another bank's entry added?)")

    # timings at the serve shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    args = (*maps, tt.remap_bank, tt.remap_flat, off, -1, idx)
    kw = dict(dim=tt.dim, hot_dtype=tt.hot_dtype)
    bag = torch.arange(idx.shape[0], device=dev) % F
    valid = idx >= 0
    slots = tt.remap_flat[(idx.long() + off.long()[bag][:, None])[valid]
                          ].long()
    uniq, inv = torch.unique(slots, return_inverse=True)
    # the reference point: the touched rows dequantized to fp32 BEFORE the
    # call, then one F.embedding_bag (no PyTorch call dequantizes in a bag)
    deq = dequant_rows_f32(tt.payload[uniq], tt.scale[uniq], tt.tier[uniq],
                           tt.dim, tt.hot_dtype)
    offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                         valid.sum(1).cumsum(0)[:-1]])
    ref = lambda: tnf.embedding_bag(inv, deq, offsets,  # noqa: E731
                                    mode="sum")
    need(torch.allclose(ref(), tiered_bag(*args, **kw), **EMB_TOL),
         "embedding_bag reference point disagrees with the kernel")
    ms = time_ms(lambda: tiered_bag(*args, **kw), flush=scratch.zero_)
    plain_ms = time_ms(lambda: tiered_bag_plain(*args, **kw), reps=5,
                       flush=scratch.zero_)
    ref_ms = time_ms(ref, flush=scratch.zero_)
    bound_ms, bound_by = tiered_bound_ms(idx, off, F, tt)
    n_live = int(valid.sum())
    print(f"tiered_bag at NB={idx.shape[0]} L={L} D={tt.dim} {tt.hot_dtype} "
          f"hot ({n_live} entries, {uniq.numel()} distinct rows): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"({bound_by}); reference point F.embedding_bag over rows "
          f"dequantized beforehand {ref_ms:.4f} ms")
    report["tiered_bag"] = dict(
        name="tiered_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/tiered_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:270",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None)
    return dict(kernel_ms=ms, plain_ms=plain_ms, reference_ms=ref_ms,
                bound_ms=bound_ms, entries=n_live, distinct_rows=uniq.numel())


def check_adaptive_outputs(dev, spec, res):
    """Scores finite, in (0, 1); the device traffic counters equal their
    host twins on the last batch under the live table; the last batch
    re-scored through the plain lookup (same table) equals the kernel path's
    embeddings bit for bit and its scores within rtol 1e-5 / atol 1e-6; the
    reduced config's adaptive run on the card equals the CPU's swap for
    swap (same weights): the same swap events, tier counts, tiered bytes,
    reads and bytes per batch, scores within rtol 1e-5 / atol 1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import tiered_embedding_bag
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.serve import run_adaptive
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import (host_tiered_bank_traffic,
                                         tiered_bank_traffic)
    from repro_torch.quant import tier_nbytes
    from repro_torch.serve.serve_step import build_recsys_serve_tiered_adaptive
    cfg = spec.config
    need(tuple(res.scores.shape) == (ADAPTIVE_REQUESTS,),
         f"adaptive scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite adaptive scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "adaptive scores outside (0, 1)")
    tt, b = res.runtime.tiered, res.last_batch
    off = res.statics["field_offsets"]
    rows = torch.where(b["sparse"] >= 0, b["sparse"] + off[None, :, None], -1)
    lut = tier_nbytes(tt.dim, tt.hot_dtype)
    got = tiered_bank_traffic(tt.remap_bank, tt.remap_slot, tt.rows_per_bank,
                              tt.tier, lut, rows, tt.n_banks)
    want = host_tiered_bank_traffic(
        tt.remap_bank.cpu().numpy(), tt.remap_slot.cpu().numpy(),
        tt.rows_per_bank, tt.tier.cpu().numpy(), lut, rows.cpu().numpy(),
        tt.n_banks)
    need(np.array_equal(got.reads.cpu().numpy(), want[0])
         and np.array_equal(got.nbytes.cpu().numpy(), want[1]),
         f"tiered traffic counters: card {got} != host {want}")
    print(f"traffic counters on the last batch, card == host twin: reads "
          f"{want[0].tolist()}, bytes {want[1].tolist()}")

    params = {**res.params, "emb_packed": res.runtime.table.packed}
    with torch.inference_mode():
        emb_k = tiered_embedding_bag(params["emb_packed"], tt, b["sparse"],
                                     field_offsets=off)
        emb_p = tiered_embedding_bag(params["emb_packed"], tt, b["sparse"],
                                     backend="torch", field_offsets=off)
    need(torch.equal(emb_k, emb_p), "tiered lookup: kernel path != plain path")
    s_k = build_recsys_serve_tiered_adaptive(dlrm, cfg, res.statics)(
        params, tt, b)
    s_p = build_recsys_serve_tiered_adaptive(dlrm, cfg, res.statics,
                                             backend="torch")(params, tt, b)
    s_err = (s_k - s_p).abs().max().item()
    need(torch.allclose(s_k, s_p, **SCORE_TOL),
         f"tiered serve step, kernels vs plain: max abs err {s_err}")
    print(f"adaptive outputs: finite, in (0, 1); last batch re-served under "
          f"the live table: embeddings kernel == plain, scores max abs err "
          f"{s_err} (rtol 1e-5/atol 1e-6)")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(quant="int4", requests=96, batch=8, replan_every=2,
              drift_rotate_every=24, seed=1, min_swaps=1)
    cpu = run_adaptive(spec, red, device="cpu", params=p0, **kw)
    card = run_adaptive(spec, red, device=dev, params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.old_imbalance, e.new_imbalance,  # noqa: E731
                     e.tier_version, e.tier_promoted, e.tier_demoted,
                     e.tier_requantized) for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) >= 1,
         f"reduced adaptive run: swaps card {ev(card)} != CPU {ev(cpu)}")
    for f in ("payload", "scale", "tier", "remap_bank", "remap_slot"):
        need(torch.equal(getattr(card.runtime.tiered, f).cpu(),
                         getattr(cpu.runtime.tiered, f)),
             f"reduced adaptive run: tiered {f} card != CPU")
    for k in ("reads", "nbytes"):
        need(all(np.array_equal(x, y) for x, y in zip(getattr(card, k),
                                                       getattr(cpu, k)))
             and len(getattr(card, k)) == len(getattr(cpu, k)),
             f"reduced adaptive run: per-batch {k} card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced adaptive run, card vs CPU: max abs err {err}")
    print(f"reduced config adaptive int4 run on the card (tiered kernel) vs "
          f"the CPU (jnp order), same weights: {len(cpu.swaps)} swap(s) "
          f"{ev(cpu)} equal, tiered tables, reads and bytes equal, scores "
          f"max abs err {err} (rtol 1e-5/atol 1e-6)")
    return dict(score_err=s_err, reduced_score_err=err,
                reduced_swaps=ev(cpu), traffic_reads=want[0].tolist(),
                traffic_nbytes=want[1].tolist())


def adaptive_breakdown(dev, spec, res):
    """Device time of the tiered serve step and its lookup (CUDA events, L2
    flushed); the host's per-batch times from the run, the telemetry tap's
    share of ``next_batch``, and the swaps' host times."""
    import torch
    from repro_torch.core.embedding import tiered_embedding_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve_tiered_adaptive
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    tt, b = res.runtime.tiered, res.last_batch
    params = {**res.params, "emb_packed": res.runtime.table.packed}
    off = res.statics["field_offsets"]
    serve = build_recsys_serve_tiered_adaptive(dlrm, spec.config, res.statics)
    with torch.inference_mode():
        out = {"serve_step": time_ms(lambda: serve(params, tt, b),
                                     flush=scratch.zero_),
               "lookup": time_ms(lambda: tiered_embedding_bag(
                   params["emb_packed"], tt, b["sparse"], field_offsets=off),
                   flush=scratch.zero_)}
        prof = profile_device(lambda: serve(params, tt, b), n=5)
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "serve", "end_batch")}
    host["telemetry_share_of_next_batch"] = sum(h["observe"]) / sum(
        h["next_batch"])
    print(f"tiered serve step (device ms, L2 flushed): {out['serve_step']:.4f}"
          f" (lookup {out['lookup']:.4f})")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per tiered serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    print("one adaptive batch of 64 on the host (median over the run, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("next_batch", "observe", "serve", "end_batch"):
        print(f"  per batch, {k} ms: "
              + ", ".join(f"{x:.3f}" for x in h[k]))
    print("  per swap, host ms: " + "; ".join(
        f"batch {e.batch}: migrate {m:.1f}, re-tier {r:.1f}, swap checks "
        f"{c:.1f}" for e, m, r, c in zip(res.swaps, h["migrate"], h["retier"],
                                        h["check_swap"])))
    return {**out, **host}


def replicated_main_path(dev, spec):
    """Phase 7's main path: ``run_replicated`` at full width with
    ``k_max = 4``, with every launch counter set to 0 just before and read
    just after. ``min_swaps=1`` makes the run itself raise unless a swap
    took place, the shapes stayed stable and the first swap's replicated
    table (and its scores) equal a fresh ``pack_replicated`` bit for bit."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_replicated
    counters = {"banked_bag": (kbag.banked_bag, "launches"),
                "banked_bag_replicated": (kbag.banked_bag,
                                          "replicated_launches"),
                "cache_residual_bag": (kbag.cache_residual_bag, "launches"),
                "ct_scatter_bag": (kbag.ct_scatter_bag, "launches"),
                "dot_features": (kdot.dot_features, "launches"),
                "dot_interaction": (kdot.dot_interaction, "launches"),
                "tiered_bag": (kbag.tiered_bag, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    res = run_replicated(spec, spec.config, requests=REPLICATED_REQUESTS,
                         batch=64, k_max=K_MAX,
                         replan_every=REPLICATED_REPLAN, min_swaps=1,
                         device=dev)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    need_warm_probe(res, "serve_replicated")
    print(f"serve_replicated: {len(res.latencies)} requests at batch 64, "
          f"k_max {K_MAX}, launches {launches}")
    for name in ("banked_bag_replicated", "dot_features"):
        need(launches[name] > 0, f"the replicated serve run launched no "
                                 f"{name} kernel")
    for name in ("banked_bag", "cache_residual_bag", "ct_scatter_bag",
                 "dot_interaction", "tiered_bag"):
        need(launches[name] == 0, f"the replicated serve run launched "
                                  f"{name} {launches[name]} times")
    need(res.checks == {"shapes_stable": True, "repack_ok": True},
         f"replicated swap checks {res.checks}")
    rplan, rt = res.runtime.replicated
    st = res.stats
    print(f"  replicated table: packed {tuple(rt.packed.shape)} "
          f"{rt.packed.dtype} ({rt.packed.numel() * 4 / 1e9:.3f} GB), maps "
          f"{tuple(rt.remap_bank.shape)} int32 each; replica v"
          f"{st['replica_version']}: {st['replicated_rows']} replicated "
          f"row(s), modeled max-bank share {st['modeled_max_share']:.6f} "
          f"(ideal {st['ideal_share']:.6f})")
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] imbalance {e.old_imbalance:.6f} -> "
              f"{e.new_imbalance:.6f}; replicas v{e.replica_version} hot="
              f"{e.replica_hot_rows} churn={e.replica_copy_churn}")
    print(f"  swap checks: shapes stable {res.checks['shapes_stable']}, "
          f"replicated table == fresh pack_replicated (arrays and scores) "
          f"{res.checks['repack_ok']}")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in st.items() if k.endswith("_s")))
    return res, launches


def replicated_small_cases(dev):
    """Replicated tables beside the served one, packed on the host: k_max 2
    with bf16 at D = 64, k_max 3 (a modulo that is not a power of two) at a
    ragged D = 33 with all-pad bags, k_max 4 at D = 160 (two passes), and
    k_max 3 at the serve shape (NB = 512, L = 256, D = 32). Each over a
    4-bank replication-aware plan whose 4 hottest rows a field hold k_max
    copies, ids drawn half from those rows, 10% holes."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import pack_replicated
    from repro_torch.core.partitioning import replicated_partition
    rng = np.random.default_rng(29)
    out = []
    for dtype, D, NB, L, F, k in (("bfloat16", 64, 100, 40, 4, 2),
                                  ("float32", 33, 37, 33, 5, 3),
                                  ("float32", 160, 24, 20, 3, 4),
                                  ("float32", 32, 512, 256, 8, 3)):
        per = 20_000
        V = per * F
        freq = rng.random(V) + 0.01
        hot = (np.arange(F)[:, None] * per + np.arange(4)).ravel()
        freq[hot] += 1e4
        copies = np.ones(V, np.int32)
        copies[hot] = k
        rplan = replicated_partition(freq, 4, copies=copies, k_max=k)
        rt = pack_replicated(rng.standard_normal((V, D)).astype(np.float32),
                             rplan, dtype=getattr(torch, dtype), device=dev)
        ids = np.where(rng.random((NB, L)) < 0.5, rng.integers(0, 4, (NB, L)),
                       rng.integers(0, per, (NB, L))).astype(np.int32)
        ids[rng.random(ids.shape) < 0.1] = -1
        ids[::7] = -1                                    # all-pad bags
        out.append(dict(name=f"k_max={k} {dtype} D={D} NB={NB} L={L}",
                        rt=rt, off=torch.arange(F, dtype=torch.int32,
                                                device=dev) * per,
                        idx=torch.from_numpy(ids).to(dev)))
    return out


def check_replica_kernel(dev, res, report):
    """The replica select vs its plain version, bit for bit
    (``torch.equal``): the last served batch's ids under the live replica
    maps through the all-live failover maps (``my = 0``, the serve path)
    and the raw flat maps (``my = -1``), with holes and all-pad bags at
    ``my = 3`` and with bank 5 dead, on the small tables, and on a
    full-width table whose hot rows hold copies (the replica plan of the
    last batch's exact counts); the replicated gradient on that table; then
    the timings at the serve shape."""
    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.core.embedding import _replica_failover_maps
    from repro_torch.core.partitioning import (choose_replication,
                                               replicated_partition)
    from repro_torch.kernels.embedding_bag import (banked_bag,
                                                   banked_bag_plain,
                                                   ct_scatter_bag,
                                                   ct_scatter_bag_plain,
                                                   replica_of_bag)
    from repro_torch.workload.migrate import migrate_replicated
    _, rt = res.runtime.replicated
    k = rt.k_max
    off = res.statics["field_offsets"]
    sp = res.last_batch["sparse"]
    F, L = sp.shape[1], sp.shape[2]
    idx = sp.reshape(-1, L).contiguous()
    g = torch.Generator(device=dev).manual_seed(31)
    idx_h = idx.clone()
    idx_h[torch.rand(idx.shape, generator=g, device=dev) < 0.1] = -1
    idx_h[::9] = -1                                       # all-pad bags
    live = torch.ones(rt.n_banks, dtype=torch.bool, device=dev)
    dead5 = live.clone()
    dead5[5] = False
    bf, sf = _replica_failover_maps(rt, live)
    bf5, sf5 = _replica_failover_maps(rt, dead5)
    errs = []

    def same(name, table, bank, slot, offs, my, ids, kk):
        got = banked_bag(table, bank, slot, offs, my, ids, kk)
        want = banked_bag_plain(table, bank, slot, offs, my, ids, kk)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype,
             f"replica bag {name}: {got.shape}/{got.dtype} vs "
             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item() \
            if got.numel() else 0.0
        need(torch.equal(got, want),
             f"replica bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"replica bag {name}: non-finite")
        errs.append(err)
        print(f"  replica bag {name}: {tuple(got.shape)} {got.dtype} == "
              f"plain (max abs err {err})")

    print(f"banked_bag replica select (k_max > 1) vs plain, bit for bit "
          f"(packed {tuple(rt.packed.shape)}, maps "
          f"{tuple(rt.remap_bank.shape)}, ids {tuple(idx.shape)}):")
    same("served ids, all-live failover maps, my=0", rt.packed, bf, sf, off,
         0, idx, k)
    same("served ids, raw flat maps, my=-1", rt.packed, rt.bank_flat,
         rt.remap_flat, off, -1, idx, k)
    same("served ids + holes, my=3 bank map", rt.packed, rt.bank_flat,
         rt.remap_flat, off, 3, idx_h, k)
    same("served ids + holes, bank 5 dead (failover maps, my=0)", rt.packed,
         bf5, sf5, off, 0, idx_h, k)
    for c in replicated_small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["rt"].packed, c["rt"].bank_flat,
                 c["rt"].remap_flat, c["off"], my, c["idx"], c["rt"].k_max)

    # a full-width table whose hot rows really hold copies: the replica
    # plan of the last batch's exact row counts. (The run's own plans copy
    # nothing at this vocab: the telemetry's sketch floor, summed over
    # 18.9 M rows, lifts choose_replication's threshold past every row.)
    t0 = time.perf_counter()
    base = res.runtime.table
    bag = torch.arange(idx.shape[0], device=dev)
    valid = idx >= 0
    rows = (idx.long() + off.long()[bag % F][:, None])[valid]
    freq = np.bincount(rows.cpu().numpy(), minlength=base.vocab
                       ).astype(np.float64)
    copies_x = choose_replication(freq, rt.n_banks, k_max=k, max_r=64)
    xplan = replicated_partition(freq, rt.n_banks, copies=copies_x,
                                 capacity_rows=rt.rows_per_bank, k_max=k)
    xt = migrate_replicated(base, xplan, rows_per_bank=rt.rows_per_bank)
    xbf, xsf = _replica_failover_maps(xt, live)
    print(f"  exact-count replica plan of the last batch: "
          f"{xplan.n_replicated} replicated rows, modeled max-bank share "
          f"{xplan.max_share():.6f} ({time.perf_counter() - t0:.1f} s)")
    need(xplan.n_replicated > 0, "the exact-count plan replicates no row")
    same("served ids, exact-count replicated table, failover maps, my=0",
         xt.packed, xbf, xsf, off, 0, idx, k)
    same("served ids + holes, exact-count replicated table, my=-1",
         xt.packed, xt.bank_flat, xt.remap_flat, off, -1, idx_h, k)

    # the gradient on the exact-count table: the scatter kernel on the
    # k_max = 4 prep, and the copy sum of a ones cotangent against the
    # single-copy gradient of the base table
    R = xt.packed.shape[0]
    ct = torch.randn((idx.shape[0], xt.dim), generator=g, device=dev)
    gk = ct_scatter_bag(ct, idx, xbf, xsf, off, 0, R, k_max=k)
    gp = ct_scatter_bag_plain(ct, idx, xbf, xsf, off, 0, R, k_max=k)
    torch.cuda.synchronize()
    need(torch.equal(gk, gp), "replicated scatter: kernel != plain")
    ones = torch.ones_like(ct)
    g_rep = ct_scatter_bag(ones, idx, xt.bank_flat, xt.remap_flat, off, -1,
                           R, k_max=k)
    g_one = ct_scatter_bag(ones, idx, base.remap_bank, base.remap_flat, off,
                           -1, base.packed.shape[0])
    urows = torch.unique(rows)
    copies = torch.from_numpy(xplan.copies).to(dev)[urows].long()
    pos = xt.remap_flat.view(-1, k)[urows].long()             # (u, k)
    fold = torch.zeros((urows.numel(), xt.dim), device=dev)
    for r in range(k):                                        # copy order
        fold += torch.where((r < copies)[:, None], g_rep[pos[:, r]], 0.0)
    single = g_one[base.remap_flat[urows].long()]
    need(torch.equal(fold, single),
         "replicated gradient: copy sum != single-copy gradient")
    rowk = ((idx.long() + off.long()[bag % F][:, None]) * k
            + replica_of_bag(bag, k).long()[:, None])[valid]
    n_copies = torch.unique(xt.remap_flat[rowk]).numel()
    need(int((g_rep != 0).any(1).sum()) == n_copies > urows.numel()
         and int((g_one != 0).any(1).sum()) == urows.numel(),
         "replicated gradient: rows touched")
    print(f"replicated gradient (exact-count table): scatter kernel == plain "
          f"on the k_max={k} prep (random cotangent); ones cotangent: each "
          f"row's copies sum to the single-copy gradient on {urows.numel()} "
          f"rows ({n_copies} copies touched)")

    # timings at the serve shape, on the serve path's call (all-live
    # failover maps, my = 0), L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    xargs = (xt.packed, xbf, xsf, off, 0, idx, k)
    x_ms = time_ms(lambda: banked_bag(*xargs), flush=scratch.zero_)
    x_bound, _ = bag_bound_ms(idx, off, F, xt.dim, xt.packed.element_size(),
                              k_max=k, my=0, slot=xsf)
    print(f"banked_bag replica select on the exact-count table "
          f"({xplan.n_replicated} rows x {k} copies): kernel {x_ms:.4f} ms, "
          f"bound {x_bound:.6f} ms")
    del xt, xbf, xsf, g_rep, g_one, gk, gp
    args = (rt.packed, bf, sf, off, 0, idx, k)
    rowk_all = ((idx.long() + off.long()[bag % F][:, None]) * k
                + replica_of_bag(bag, k).long()[:, None])
    lib_ids = sf[rowk_all[valid]].long()
    lib_offsets = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                             valid.sum(1).cumsum(0)[:-1]])
    lib = lambda: tnf.embedding_bag(lib_ids, rt.packed,  # noqa: E731
                                    lib_offsets, mode="sum")
    need(torch.allclose(lib(), banked_bag(*args), rtol=1e-5, atol=1e-5),
         "embedding_bag library call disagrees with the replica kernel")
    ms = time_ms(lambda: banked_bag(*args), flush=scratch.zero_)
    plain_ms = time_ms(lambda: banked_bag_plain(*args), reps=5,
                       flush=scratch.zero_)
    library_ms = time_ms(lib, flush=scratch.zero_)
    bound_ms, bound_by = bag_bound_ms(idx, off, F, rt.dim,
                                      rt.packed.element_size(), k_max=k,
                                      my=0, slot=sf)
    n_read = torch.unique(sf[rowk_all[valid]]).numel()
    print(f"banked_bag replica select at NB={idx.shape[0]} L={L} D={rt.dim} "
          f"k_max={k} fp32 ({int(valid.sum())} entries, {n_read} distinct "
          f"copies): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"F.embedding_bag (ids resolved beforehand) {library_ms:.4f} ms, "
          f"bound {bound_ms:.6f} ms ({bound_by})")
    report["banked_bag_replicated"] = dict(
        name="banked_bag_replicated", route="cuda",
        source="src/repro_torch/kernels/csrc/banked_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:133 (_entry_fns k_max > "
                 "1 branch) in _banked_bag_kernel (:231)",
        max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms)
    return dict(kernel_ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, entries=int(valid.sum()),
                distinct_copies=n_read, exact_count_kernel_ms=x_ms,
                exact_count_bound_ms=x_bound,
                exact_count_replicated_rows=xplan.n_replicated,
                exact_count_max_share=xplan.max_share())


def check_replicated_outputs(dev, spec, res):
    """Scores finite, in (0, 1); the device traffic counters equal their
    host twin and the run's own reads on the last batch; the last batch
    re-scored through the single-copy path on the base table gives the same
    embeddings bit for bit and scores within rtol 1e-5 / atol 1e-6; the
    reduced config's replicated run on the card equals the CPU's swap for
    swap (same weights): the same swap events, replicated rows, replicated
    tables and reads per batch, scores within rtol 1e-5 / atol 1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import (banked_embedding_bag,
                                            replicated_embedding_bag)
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.serve import run_replicated
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import (host_replicated_bank_read_counts,
                                         replicated_bank_read_counts)
    from repro_torch.serve.serve_step import (
        build_recsys_serve_adaptive, build_recsys_serve_replicated_adaptive)
    cfg = spec.config
    need(tuple(res.scores.shape) == (REPLICATED_REQUESTS,),
         f"replicated scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()),
         "non-finite replicated scores")
    # Zipf(2.0) bags of 256 repeat a field's top row ~150 times, so random
    # weights drive many logits past where fp32's sigmoid rounds to 1
    need(bool(((res.scores >= 0) & (res.scores <= 1)).all()),
         "replicated scores outside [0, 1]")
    n_sat = int(((res.scores == 0) | (res.scores == 1)).sum())
    (rplan, rt), b = res.runtime.replicated, res.last_batch
    off = res.statics["field_offsets"]
    live = torch.ones(rt.n_banks, dtype=torch.bool, device=dev)
    rows = torch.where(b["sparse"] >= 0, b["sparse"] + off[None, :, None], -1)
    # the replica version that served the last batch (a swap may follow it)
    v_last = res.runtime.replica_version - int(
        bool(res.swaps) and res.swaps[-1].batch == len(res.reads))
    lplan, lrt = res.runtime.replicated_for(v_last)
    got = replicated_bank_read_counts(lrt.remap_bank, rows, rt.n_banks,
                                      k_max=rt.k_max, bank_live=live)
    want = host_replicated_bank_read_counts(
        lplan.bank_of_copy, rows.cpu().numpy(), rt.n_banks, k_max=rt.k_max,
        bank_live=np.ones(rt.n_banks, bool))
    need(np.array_equal(got.cpu().numpy(), want)
         and np.array_equal(res.reads[-1], want),
         f"replicated traffic counters: card {got.tolist()}, run "
         f"{res.reads[-1].tolist()}, host {want.tolist()}")
    print(f"traffic counters on the last batch (replica v{v_last}), card == "
          f"host twin == the run's: reads {want.tolist()} (max share "
          f"{want.max() / want.sum():.6f})")

    base = res.runtime.table
    params = {**res.params, "emb_packed": base.packed}
    with torch.inference_mode():
        emb_r = replicated_embedding_bag(rt, b["sparse"], field_offsets=off,
                                         bank_live=live)
        emb_1 = banked_embedding_bag(base, b["sparse"], field_offsets=off)
    need(torch.equal(emb_r, emb_1),
         "replicated lookup != single-copy lookup on the base table")
    s_r, counts = build_recsys_serve_replicated_adaptive(
        dlrm, cfg, res.statics)(params, rt, live, b)
    s_1 = build_recsys_serve_adaptive(dlrm, cfg, res.statics)(
        params, base.remap_bank, base.remap_slot, b,
        remap_flat=base.remap_flat)
    s_err = (s_r - s_1).abs().max().item()
    need(int(counts.sum()) == 0 and torch.allclose(s_r, s_1, **SCORE_TOL)
         and torch.equal(s_r, res.scores[-s_r.shape[0]:]),
         f"replicated scores vs the single-copy re-score: max abs err "
         f"{s_err}")
    # the logits too: saturated scores would hide a difference
    st1 = {**res.statics, "remap_bank": base.remap_bank,
           "remap_slot": base.remap_slot, "remap_flat": base.remap_flat}
    with torch.inference_mode():
        lg_r = dlrm.forward(cfg, params, res.statics, b, replicated=rt,
                            bank_live=live)
        lg_1 = dlrm.forward(cfg, params, st1, b)
    l_err = (lg_r - lg_1).abs().max().item()
    need(torch.allclose(lg_r, lg_1, **SCORE_TOL),
         f"replicated logits vs the single-copy path: max abs err {l_err}")
    print(f"replicated outputs: finite, in [0, 1] (min "
          f"{res.scores.min().item()}, {n_sat} of {res.scores.numel()} "
          f"rounded to exactly 0 or 1); last batch re-scored through the "
          f"single-copy path on the base table: embeddings equal bit for "
          f"bit, scores max abs err {s_err}, logits (from "
          f"{lg_1.min().item():.3f} to {lg_1.max().item():.3f}) max abs err "
          f"{l_err} (rtol 1e-5/atol 1e-6)")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(k_max=K_MAX, requests=96, batch=8, replan_every=2,
              drift_rotate_every=24, seed=1, min_swaps=1)
    cpu = run_replicated(spec, red, device="cpu", params=p0, **kw)
    card = run_replicated(spec, red, device=dev, params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.old_imbalance, e.new_imbalance,  # noqa: E731
                     e.replica_version, e.replica_hot_rows,
                     e.replica_copy_churn) for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) >= 1,
         f"reduced replicated run: swaps card {ev(card)} != CPU {ev(cpu)}")
    (cp, ct_), (gp, gt) = cpu.runtime.replicated, card.runtime.replicated
    need(np.array_equal(cp.copies, gp.copies)
         and all(torch.equal(getattr(gt, f).cpu(), getattr(ct_, f))
                 for f in ("packed", "remap_bank", "remap_slot")),
         "reduced replicated run: replicated table card != CPU")
    need(len(card.reads) == len(cpu.reads)
         and all(np.array_equal(x, y) for x, y in zip(card.reads, cpu.reads)),
         "reduced replicated run: per-batch reads card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced replicated run, card vs CPU: max abs err {err}")
    print(f"reduced config replicated run (k_max {K_MAX}) on the card "
          f"(replica kernel) vs the CPU (plain scan), same weights: "
          f"{len(cpu.swaps)} swap(s) {ev(cpu)} equal, {cp.n_replicated} "
          f"replicated rows, replicated tables and reads equal, scores max "
          f"abs err {err} (rtol 1e-5/atol 1e-6)")
    return dict(score_err=s_err, logit_err=l_err,
                logit_range=[lg_1.min().item(), lg_1.max().item()],
                reduced_score_err=err, reduced_swaps=ev(cpu),
                traffic_reads=want.tolist(), saturated_scores=n_sat)


def replicated_breakdown(dev, spec, res):
    """Device time of the replicated serve step and of its stages (CUDA
    events, L2 flushed): the failover maps, the lookup (maps included),
    the degraded counts, the traffic counters, the MLPs and the
    interaction; the host's per-batch times from the run and the swaps'
    host costs."""
    import torch
    from repro_torch.core.embedding import (_replica_failover_maps,
                                            degraded_row_counts,
                                            replicated_embedding_bag)
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_interaction)
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import replicated_bank_read_counts
    from repro_torch.serve.serve_step import (
        build_recsys_serve_replicated_adaptive)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    _, rt = res.runtime.replicated
    b = res.last_batch
    params = {**res.params, "emb_packed": res.runtime.table.packed}
    off = res.statics["field_offsets"]
    live = torch.ones(rt.n_banks, dtype=torch.bool, device=dev)
    rows = torch.where(b["sparse"] >= 0, b["sparse"] + off[None, :, None], -1)
    serve = build_recsys_serve_replicated_adaptive(dlrm, spec.config,
                                                   res.statics,
                                                   with_traffic=True)
    with torch.inference_mode():
        x = dlrm.mlp_apply(params["bot"], b["dense"])
        emb = replicated_embedding_bag(rt, b["sparse"], field_offsets=off,
                                       bank_live=live).contiguous()
        z = torch.cat([x[:, None], emb], dim=1)
        feat = dot_features(x, emb)
        parts = {
            "serve_step": lambda: serve(params, rt, live, b),
            "failover_maps": lambda: _replica_failover_maps(rt, live),
            "lookup": lambda: replicated_embedding_bag(
                rt, b["sparse"], field_offsets=off, bank_live=live),
            "degraded_counts": lambda: degraded_row_counts(
                rt.remap_bank, live, rows),
            "traffic_counters": lambda: replicated_bank_read_counts(
                rt.remap_bank, rows, rt.n_banks, k_max=rt.k_max,
                bank_live=live),
            "bottom_mlp": lambda: dlrm.mlp_apply(params["bot"], b["dense"]),
            "dot_features": lambda: dot_features(x, emb),
            "dot_interaction": lambda: dot_interaction(z),
            "top_mlp": lambda: dlrm.mlp_apply(params["top"], feat),
        }
        out = {k: time_ms(fn, flush=scratch.zero_) for k, fn in parts.items()}
        prof = profile_device(lambda: serve(params, rt, live, b), n=5)
    print("replicated serve step (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in out.items()))
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per replicated serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "serve", "end_batch")}
    host["telemetry_share_of_next_batch"] = sum(h["observe"]) / sum(
        h["next_batch"])
    print("one replicated batch of 64 on the host (median over the run, "
          "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("next_batch", "observe", "serve", "end_batch"):
        print(f"  per batch, {k} ms: "
              + ", ".join(f"{x:.3f}" for x in h[k]))
    print("  per swap, host ms: " + "; ".join(
        f"batch {e.batch}: base replan {a:.1f}, replica plan {b_:.1f}, "
        f"migrate {m:.1f}, migrate_replicated {mr:.1f}, swap checks {c:.1f}"
        for e, a, b_, m, mr, c in zip(
            res.swaps, h["replan"], h["replica_plan"], h["migrate"],
            h["migrate_replicated"], h["check_swap"])))
    return {**out, **host}


def csr_requests(cfg, n):
    """Phase 8's stream: ``n`` requests of one ragged bag a field, field f
    drawn from ``DriftingZipfTrace`` with the reference launcher's stream
    settings (its rows, Zipf 1.05, bags of ``multi_hot`` on average, drift
    off, seed f); bags keep their Poisson lengths, each id is offset by its
    field's base into a super-table row, bags in request-major order (bag
    r * F + f). -> (indices (T,), offsets (n * F,) bag starts), int32."""
    import numpy as np
    from repro_torch.workload.trace import DriftConfig, DriftingZipfTrace
    base = np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]])
    per_field = [DriftingZipfTrace(DriftConfig(
        n_items=v, zipf_a=1.05, avg_bag=float(cfg.multi_hot),
        rotate_every=0, rotate_frac=0.25), seed=f).bags(n)
        for f, v in enumerate(cfg.vocab_sizes)]
    bags = [per_field[f][r] + base[f] for r in range(n)
            for f in range(cfg.n_sparse)]
    lens = np.array([len(b) for b in bags])
    return (np.concatenate(bags).astype(np.int32),
            np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32))


def csr_rect(indices, offsets):
    """A CSR stream (numpy) as its bags padded with -1 to the longest:
    (NB, L_max) int32."""
    import numpy as np
    lens = np.diff(np.append(offsets, indices.shape[0]))
    rect = np.full((offsets.shape[0], max(int(lens.max()), 1)), -1, np.int32)
    rect[np.repeat(np.arange(offsets.shape[0]), lens),
         np.arange(indices.shape[0]) - np.repeat(offsets, lens)] = indices
    return rect


def csr_small_cases(dev):
    """bf16 tables at ragged D = 33 and at D = 160 (two passes) over phase
    2's small 4-bank plans with the flat remap: a CSR stream of 37 bags with
    an empty bag in the middle and two trailing, and 10% holes."""
    import numpy as np
    import torch
    srng = np.random.default_rng(21)
    out = []
    for c in small_cases(dev, cases=(("bfloat16", 33, 37, 8, 3),
                                     ("bfloat16", 160, 37, 8, 3))):
        lens = srng.integers(0, 60, 37)
        lens[[5, 35, 36]] = 0
        ids = srng.integers(0, c["bank"].shape[0], int(lens.sum()))
        ids[srng.random(ids.shape) < 0.1] = -1
        offs = np.concatenate([[0], np.cumsum(lens)])
        out.append(dict(
            name=f"bf16 D={c['table'].shape[1]} NB=37 T={ids.size}",
            table=c["table"], bank=c["bank"], slot=c["slot"],
            idx=torch.from_numpy(ids.astype(np.int32)).to(dev),
            offs=torch.from_numpy(offs.astype(np.int32)).to(dev),
            rect=torch.from_numpy(csr_rect(ids, offs[:-1])).to(dev)))
    return out


CSR_LENS = (0, 1, 255, 256, 257, 1000, 5000)    # adversarial bag lengths


def csr_adversarial_cases(dev):
    """Tables and ragged streams against the CSR kernel's resolve-once ring:
    every D of ``BAG_DIMS`` in fp32 and bf16 (16-, 4- and 2-byte copies;
    one to three column passes) over bags of every length of ``CSR_LENS``
    up to 1,000 (empty, one entry, around a 256-row ring, past a 512-entry
    round) in shuffled order, with 10% holes, an all-hole bag and two
    trailing empty bags; then the 5,000-entry bags too (ten rounds; in two
    cases only, since the plain version takes a step per entry of the
    longest bag), offsets outside [0, T] (below 0, past T, decreasing),
    T = 0, a table whose base is 4 bytes off 16-byte alignment, and 4,301
    short bags (two a block). Each case carries a table of 4 x 2,400 rows
    with 8-bank remaps of 2,400 ids."""
    import numpy as np
    import torch
    rng = np.random.default_rng(31)
    V, R = 2400, 9600
    shapes = [(dtype, D, "") for dtype in ("float32", "bfloat16")
              for D in BAG_DIMS]
    shapes += [("float32", 32, "5,000-entry bags"),
               ("bfloat16", 9, "5,000-entry bags"),
               ("float32", 32, "offsets outside [0, T]"),
               ("float32", 32, "T = 0"),
               ("float32", 32, "base 4 B off alignment"),
               ("float32", 33, "4301 short bags")]
    out = []
    for dtype, D, note in shapes:
        tab = torch.from_numpy(rng.standard_normal((R * D + 1,))
                               .astype(np.float32)).to(dev)
        tab = tab.to(getattr(torch, dtype))
        table = tab[1:].view(R, D) if note.startswith("base") \
            else tab[:R * D].view(R, D)
        if note == "T = 0":
            lens = np.zeros(9, np.int64)
        elif note == "4301 short bags":
            lens = rng.integers(0, 66, 4301)
        else:
            lens = CSR_LENS if note.startswith("5,000") else CSR_LENS[:-1]
            lens = np.concatenate([rng.permutation(lens * 2), [3, 0, 0]])
        T = int(lens.sum())
        ids = rng.integers(0, V, T)
        ids[rng.random(T) < 0.1] = -1                   # holes
        offs = np.concatenate([[0], np.cumsum(lens)])
        if note != "T = 0":
            ids[offs[-4]:offs[-3]] = -1                 # an all-hole bag
        if note.startswith("offsets"):
            offs[[1, 4, 7]] = (-7, T + 40, offs[3] - 5)
        out.append(dict(
            name=f"{dtype} D={D} NB={lens.size} T={T}"
                 + (f" ({note})" if note else ""),
            table=table,
            idx=torch.from_numpy(ids.astype(np.int32)).to(dev),
            offs=torch.from_numpy(offs.astype(np.int32)).to(dev),
            bank=torch.from_numpy(rng.integers(0, 8, V).astype(np.int32)
                                  ).to(dev),
            slot=torch.from_numpy(rng.integers(0, R, V).astype(np.int32)
                                  ).to(dev)))
    return out


def check_csr_adversarial(dev, errs, out_dtype=None):
    """The CSR kernel against its plain version, bit for bit, on
    ``csr_adversarial_cases``: my = -1, my = 3 on the 8-bank map, and my =
    0 on a live map (bank 5 dead). ``out_dtype=torch.float32``: the
    fp32-output instance, whose sums cast once to the table's dtype are
    also the table's-dtype instance's, bit for bit."""
    import torch
    from repro_torch.kernels.embedding_bag import csr_bag, csr_bag_plain
    n = 0
    for c in csr_adversarial_cases(dev):
        live = (c["bank"] != 5).to(torch.int32) ^ 1    # 0 where live
        want_dtype = out_dtype or c["table"].dtype
        for my, bk in ((-1, c["bank"]), (3, c["bank"]), (0, live)):
            a = (c["table"], bk, c["slot"], my, c["idx"], c["offs"])
            got = csr_bag(*a, out_dtype=out_dtype)
            want = csr_bag_plain(*a, out_dtype=out_dtype)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item() \
                if got.numel() else 0.0
            need(got.dtype == want.dtype == want_dtype
                 and torch.equal(got, want),
                 f"csr_bag {c['name']} my={my} out {want_dtype}: kernel != "
                 f"plain (max abs err {err})")
            if out_dtype is not None:
                need(torch.equal(csr_bag(*a), want.to(c["table"].dtype)),
                     f"csr_bag {c['name']} my={my}: the table's-dtype sums "
                     f"!= the fp32 sums cast once")
            errs.append(err)
            n += 1
        shard, local = shard_beside_nan(c["table"], c["bank"], c["slot"], 3)
        a = (shard, c["bank"], local, 3, c["idx"], c["offs"])
        got = csr_bag(*a, out_dtype=out_dtype)
        want = csr_bag_plain(*a, out_dtype=out_dtype)
        whole = csr_bag(c["table"], c["bank"], c["slot"], 3, c["idx"],
                        c["offs"], out_dtype=out_dtype)
        torch.cuda.synchronize()
        need(torch.equal(got, want) and torch.equal(got, whole),
             f"csr_bag {c['name']} on bank 3's shard: != plain or != the "
             f"whole table's bank-3 sums (another bank's entry added?)")
        n += 2
    print(f"  csr_bag adversarial cases, sums in "
          f"{'the table dtype' if out_dtype is None else out_dtype}: {n} "
          f"calls (D {BAG_DIMS}, bag lengths {CSR_LENS}, offsets outside "
          f"[0, T], T = 0; on bank 3's shard beside a NaN row) == plain")


def csr_phase(dev, spec, plan, report):
    """Phase 8: ragged CSR lookups, forward and backward, and the
    identity-layout drop-ins, at full width. The super-table packed with
    phase 2's plan (seeded weights); 64 requests x 8 fields of ragged
    bags. ``csr_embedding_bag`` forward and backward, then
    ``kernels.ops.embedding_bag_trainable`` forward and backward on the
    same bags padded and resolved, each run with every launch counter set
    to 0 just before and read just after. Then the checks and timings."""
    import dataclasses

    import numpy as np
    import torch
    import torch.nn.functional as tnf
    from repro_torch.core.embedding import (_binary_live_map,
                                            csr_embedding_bag, init_banked)
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels import ops as kops
    from repro_torch.sparse.ops import offsets_to_segment_ids
    cfg = spec.config
    D = cfg.embed_dim
    t0 = time.perf_counter()
    t = init_banked(plan, D, generator=torch.Generator(device=dev)
                    .manual_seed(8), device=dev)
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    indices, offsets = csr_requests(cfg, CSR_REQUESTS)
    draw_s = time.perf_counter() - t0
    NB, T, R = offsets.shape[0], indices.shape[0], t.packed.shape[0]
    lens = np.diff(np.append(offsets, T))
    print(f"csr: table {tuple(t.packed.shape)} {t.packed.dtype} "
          f"({table_s:.3f} s); {CSR_REQUESTS} requests, {NB} bags, {T} "
          f"entries (bag lengths {lens.min()}..{lens.max()}, mean "
          f"{lens.mean():.2f}), drawn in {draw_s:.3f} s")
    idx = torch.from_numpy(indices).to(dev)
    off = torch.from_numpy(offsets).to(dev)
    offs_ext = torch.cat([off, torch.full((1,), T, dtype=torch.int32,
                                          device=dev)])
    seg = offsets_to_segment_ids(off, T)
    cot = torch.randn((NB, D), generator=torch.Generator(device=dev)
                      .manual_seed(19), device=dev)
    packed = t.packed.detach().requires_grad_(True)
    tg = dataclasses.replace(t, packed=packed)
    counters = {"csr_bag": kbag.csr_bag, "ct_scatter_bag": kbag.ct_scatter_bag,
                "banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "tiered_bag": kbag.tiered_bag, "plain_bag": kbag.plain_bag,
                "plain_cache_bag": kbag.plain_cache_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    x7 = torch.randn((CSR_REQUESTS, D), generator=torch.Generator(device=dev)
                     .manual_seed(23), device=dev)

    # the main path: the CSR lookup forward and backward
    for fn in counters.values():
        fn.launches = 0
    h0 = time.perf_counter()
    out = csr_embedding_bag(tg, idx, off, NB)
    (grad,) = torch.autograd.grad(out, [packed], cot)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - h0) * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    print(f"csr_embedding_bag forward + backward: {host_ms:.3f} ms host, "
          f"launches {launches}")
    for name, n in launches.items():
        if name in ("csr_bag", "ct_scatter_bag"):
            need(n > 0, f"the CSR run launched no {name} kernel")
        else:
            need(n == 0, f"the CSR run launched {name} {n} times")
    out = out.detach()
    need(tuple(out.shape) == (NB, D) and bool(torch.isfinite(out).all()),
         f"CSR sums {tuple(out.shape)}, finite {torch.isfinite(out).all()}")

    # the drop-ins' path: the same bags padded and resolved, through
    # kernels.ops.embedding_bag_trainable forward and backward, and each
    # request's 8 bag sums behind a dense row through
    # kernels.ops.dot_interaction
    rect = torch.from_numpy(csr_rect(indices, offsets)).to(dev)
    resolved = resolve_ids(rect, t.remap_flat)
    for fn in counters.values():
        fn.launches = 0
    out7 = kops.embedding_bag_trainable(packed, resolved)
    (grad7,) = torch.autograd.grad(out7, [packed], cot)
    z7 = torch.cat([x7[:, None], out7.detach().view(CSR_REQUESTS, -1, D)],
                   dim=1)
    inter7 = kops.dot_interaction(z7)
    torch.cuda.synchronize()
    d_launches = {k: fn.launches for k, fn in counters.items()}
    print(f"kernels.ops.embedding_bag_trainable forward + backward on the "
          f"bags padded to {tuple(rect.shape)} and resolved, then "
          f"kernels.ops.dot_interaction on {tuple(z7.shape)}: launches "
          f"{d_launches}")
    for name, n in d_launches.items():
        if name in ("plain_bag", "ct_scatter_bag", "dot_interaction"):
            need(n > 0, f"the drop-in run launched no {name} kernel")
        else:
            need(n == 0, f"the drop-in run launched {name} {n} times")
    need(torch.allclose(inter7, kdot.dot_interaction_plain(z7), **DOT_TOL),
         "kernels.ops.dot_interaction != its plain version")
    out7 = out7.detach()

    # sums: CSR == the rectangle through banked_bag == kernel 7 resolved
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    rect_sum = kbag.banked_bag(t.packed, t.remap_bank, t.remap_flat, zero, -1,
                               rect)
    plain7 = kbag.plain_bag_plain(t.packed, resolved)
    torch.cuda.synchronize()
    need(torch.equal(out, rect_sum),
         "CSR sums != banked_bag on the bags padded with -1")
    need(torch.equal(out7, rect_sum),
         "plain_bag on resolved ids != banked_bag on the raw ids")
    need(torch.equal(out7, plain7), "plain_bag != its plain version")
    errs7 = [(out7 - plain7).abs().max().item()]
    print("  CSR sums == banked_bag on the padded bags == plain_bag on the "
          "resolved ids == plain_bag's plain version, bit for bit")
    del rect_sum, plain7
    for c in csr_small_cases(dev):
        ids_c = resolve_ids(c["rect"], c["slot"])
        k = kbag.plain_bag(c["table"], ids_c)
        pl = kbag.plain_bag_plain(c["table"], ids_c)
        torch.cuda.synchronize()
        need(k.dtype == c["table"].dtype and torch.equal(k, pl),
             f"plain_bag {c['name']}: kernel != plain")
        errs7.append((k.float() - pl.float()).abs().max().item())
        print(f"  plain_bag {c['name']} padded and resolved: == plain")

    # kernel 5 against its plain version
    errs5 = []

    def same(name, table, bank, slot, my, ids, oe):
        got = kbag.csr_bag(table, bank, slot, my, ids, oe)
        want = kbag.csr_bag_plain(table, bank, slot, my, ids, oe)
        torch.cuda.synchronize()
        need(got.shape == want.shape and got.dtype == want.dtype
             == table.dtype, f"csr_bag {name}: {got.shape}/{got.dtype} vs "
                             f"{want.shape}/{want.dtype}")
        err = (got.float() - want.float()).abs().max().item()
        need(torch.equal(got, want),
             f"csr_bag {name}: kernel != plain (max abs err {err})")
        need(bool(torch.isfinite(got.float()).all()),
             f"csr_bag {name}: non-finite")
        errs5.append(err)
        print(f"  csr_bag {name}: {tuple(got.shape)} {got.dtype} == plain "
              f"(max abs err {err})")

    g = torch.Generator(device=dev).manual_seed(23)
    idx_h = idx.clone()
    idx_h[torch.rand(idx.shape, generator=g, device=dev) < 0.05] = -1
    live = torch.ones(t.n_banks, dtype=torch.bool, device=dev)
    live[5] = False
    print("csr_bag vs plain, bit for bit:")
    same("served stream, my=-1 flat remap", t.packed, t.remap_bank,
         t.remap_flat, -1, idx, offs_ext)
    same("served stream + 5% holes, my=3 bank map", t.packed, t.remap_bank,
         t.remap_flat, 3, idx_h, offs_ext)
    same("served stream + 5% holes, bank 5 dead (binary live map, my=0)",
         t.packed, _binary_live_map(t.remap_bank, live), t.remap_flat, 0,
         idx_h, offs_ext)
    for c in csr_small_cases(dev):
        for my in (-1, 1):
            same(f"{c['name']} my={my}", c["table"], c["bank"], c["slot"], my,
                 c["idx"], c["offs"])
    check_csr_adversarial(dev, errs5)

    # gradients
    g_plain = kbag.ct_scatter_csr_plain(cot, idx, seg, t.remap_bank,
                                        t.remap_flat, -1, R)
    need(torch.equal(grad, g_plain),
         "CSR gradient (ct_scatter.cu on the CSR prep) != plain scatter")
    rows = int((grad != 0).any(1).sum())
    need(rows > 0, "CSR gradient: all zero")
    del g_plain
    g_rect = kbag.ct_scatter_bag(cot, rect, t.remap_bank, t.remap_flat, zero,
                                 -1, R)
    g_abs = kbag.ct_scatter_csr_plain(cot.abs(), idx, seg, t.remap_bank,
                                      t.remap_flat, -1, R)
    # the rectangular prep adds j-major, the CSR prep in stream order: an
    # fp32 reordering, held to 1e-5 of each sum's magnitudes
    rel = ((grad - g_rect).abs() / g_abs.clamp(min=1e-30)).max().item()
    need(rel <= 1e-5, f"CSR gradient vs the rectangular path's: {rel} of "
                      f"the summed magnitudes")
    del g_rect, g_abs
    need(torch.equal(grad7, kbag.ct_scatter_identity_plain(cot, resolved, R)),
         "embedding_bag_trainable gradient (the kernel) != plain version")
    # bags sit in the stream in order, so bag-major is stream order
    need(torch.equal(grad7, grad),
         "identity-layout gradient != CSR gradient")
    print(f"  CSR gradient ({rows} rows non-zero) == plain scatter on the CSR "
          f"prep; vs the rectangular path within {rel:.3g} of the summed "
          f"magnitudes; embedding_bag_trainable's == its plain version == "
          f"the CSR gradient, bit for bit")
    del grad, grad7

    # the CSR prep under ownership, dead banks, dtype mixes and small tables:
    # ct_scatter.cu == its plain version, bit for bit
    def same_csr(name, ct, ids, sg, bank, slot, my, n_rows, out_dtype=None):
        got = kbag.ct_scatter_csr(ct, ids, sg, bank, slot, my, n_rows,
                                  out_dtype)
        want = kbag.ct_scatter_csr_plain(ct, ids, sg, bank, slot, my, n_rows,
                                         out_dtype)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        need(torch.equal(got, want),
             f"CSR scatter {name}: kernel != plain (max abs err {err})")
        errs3.append(err)
        print(f"  CSR scatter {name}: {got.dtype} == plain")

    errs3 = []
    print("ct_scatter.cu on the CSR prep vs plain, bit for bit:")
    same_csr("served stream + 5% holes, my=3 bank map", cot, idx_h, seg,
             t.remap_bank, t.remap_flat, 3, R)
    same_csr("served stream + 5% holes, bank 5 dead (binary live map, my=0)",
             cot, idx_h, seg, _binary_live_map(t.remap_bank, live),
             t.remap_flat, 0, R)
    same_csr("served stream, bf16 ct -> fp32 table", cot.bfloat16(), idx,
             seg, t.remap_bank, t.remap_flat, -1, R, torch.float32)
    same_csr("served stream, fp32 ct -> bf16 table", cot, idx, seg,
             t.remap_bank, t.remap_flat, -1, R, torch.bfloat16)
    for c in csr_small_cases(dev):
        nb_c = c["offs"].shape[0] - 1
        sg_c = offsets_to_segment_ids(c["offs"][:-1], c["idx"].shape[0])
        ct_c = torch.randn((nb_c, c["table"].shape[1]), generator=g,
                           device=dev).to(c["table"].dtype)
        for my in (-1, 1):
            same_csr(f"{c['name']} my={my}", ct_c, c["idx"], sg_c, c["bank"],
                     c["slot"], my, c["table"].shape[0])

    # timings at the served shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fl = scratch.zero_
    args5 = (t.packed, t.remap_bank, t.remap_flat, -1, idx, offs_ext)
    need(bool((idx >= 0).all()), "the served stream holds a hole")
    lib_ids = t.remap_flat[idx.long()].long()
    lib5 = lambda: tnf.embedding_bag(lib_ids, t.packed, off.long(),  # noqa: E731
                                     mode="sum")
    need(torch.allclose(lib5(), out, **EMB_TOL),
         "embedding_bag library call disagrees with csr_bag")
    ms5 = time_ms(lambda: kbag.csr_bag(*args5), flush=fl)
    plain5 = time_ms(lambda: kbag.csr_bag_plain(*args5), reps=5, flush=fl)
    lib5_ms = time_ms(lib5, flush=fl)
    b5, by5 = csr_bound_ms(idx, NB, D, t.packed.element_size(),
                           slot=t.remap_flat)
    print(f"csr_bag at NB={NB} T={T} D={D} fp32: kernel {ms5:.4f} ms, plain "
          f"{plain5:.4f} ms, F.embedding_bag {lib5_ms:.4f} ms, bound "
          f"{b5:.6f} ms ({by5})")
    report["csr_bag"] = dict(
        name="csr_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/csr_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:424",
        max_abs_err=max(errs5), ms=ms5, plain_ms=plain5, bound_ms=b5,
        bound_by=by5, library_ms=lib5_ms)

    valid = resolved >= 0
    ids7 = resolved[valid].long()
    off7 = torch.cat([torch.zeros(1, dtype=torch.long, device=dev),
                      valid.sum(1).cumsum(0)[:-1]])
    lib7 = lambda: tnf.embedding_bag(ids7, t.packed, off7,  # noqa: E731
                                     mode="sum")
    need(torch.allclose(lib7(), out7, **EMB_TOL),
         "embedding_bag library call disagrees with plain_bag")
    ms7 = time_ms(lambda: kbag.plain_bag(t.packed, resolved), flush=fl)
    plain7_ms = time_ms(lambda: kbag.plain_bag_plain(t.packed, resolved),
                        reps=5, flush=fl)
    lib7_ms = time_ms(lib7, flush=fl)
    b7, by7 = bag_bound_ms(resolved, zero, 1, D, t.packed.element_size(),
                           remap=False)
    # the same bags through banked_bag on the raw ids: the rectangle's cost
    # beside the CSR walk's, on one stream
    rect_ms = time_ms(lambda: kbag.banked_bag(t.packed, t.remap_bank,
                                              t.remap_flat, zero, -1, rect),
                      flush=fl)
    print(f"plain_bag at NB={NB} L={rect.shape[1]} D={D} fp32 ({T} valid "
          f"entries): kernel {ms7:.4f} ms, plain {plain7_ms:.4f} ms, "
          f"F.embedding_bag {lib7_ms:.4f} ms, bound {b7:.6f} ms ({by7}); "
          f"banked_bag on the padded raw ids {rect_ms:.4f} ms")
    report["plain_bag"] = dict(
        name="plain_bag", route="cuda",
        source="src/repro_torch/kernels/csrc/banked_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:203",
        max_abs_err=max(errs7), ms=ms7, plain_ms=plain7_ms, bound_ms=b7,
        bound_by=by7, library_ms=lib7_ms)

    runs = kbag.csr_scatter_prep(idx, seg, t.remap_bank, t.remap_flat, -1, R)
    out_k = torch.zeros((R, D), device=dev)
    ms_s = time_ms(lambda: kbag.ct_scatter_launch(cot, runs, out_k), flush=fl)
    out_p = torch.zeros((R, D), device=dev)
    plain_s = time_ms(lambda: kbag.ct_scatter_runs_plain(cot, runs, out_p),
                      reps=5, flush=fl)
    need(torch.equal(out_k, out_p), "timed CSR scatter != timed plain")
    del out_p
    dest = kbag.dest_slots(idx.long(), idx >= 0, t.remap_bank, t.remap_flat,
                           -1, R)
    keep = dest < R
    lib_dest, lib_bag = dest[keep].long(), seg[keep].long()
    lib_out = torch.zeros((R, D), device=dev)
    lib_s = lambda: lib_out.index_add_(0, lib_dest, cot[lib_bag])  # noqa: E731
    lib_s()
    # index_add_ adds a slot's cotangents in no fixed order: an fp32
    # reordering of sums up to a head row's thousands of entries, held to
    # 1e-5 of each sum's magnitudes
    mag = torch.zeros((R, D), device=dev).index_add_(0, lib_dest,
                                                      cot[lib_bag].abs())
    lib_rel = ((lib_out - out_k).abs() / mag.clamp(min=1e-30)).max().item()
    need(lib_rel <= 1e-5, f"index_add_ library call vs the CSR scatter: "
                          f"{lib_rel} of the summed magnitudes")
    del mag
    lib_s_ms = time_ms(lib_s, flush=fl)
    del lib_out, out_k
    bs, bys = scatter_bound_ms(runs, NB, D, 4)
    n_run, n_live, longest = run_lengths(runs)
    fb_ms = time_ms(lambda: torch.autograd.grad(
        csr_embedding_bag(tg, idx, off, NB), [packed], cot), reps=5, flush=fl)
    print(f"CSR scatter (ct_scatter.cu on the CSR prep; {n_live} entries, "
          f"{n_run} runs, longest {longest}): kernel {ms_s:.4f} ms, plain "
          f"{plain_s:.4f} ms, index_add_ {lib_s_ms:.4f} ms, bound {bs:.6f} ms "
          f"({bys}); csr_embedding_bag forward + backward {fb_ms:.4f} ms on "
          f"the device")
    if "ct_scatter_bag" in report:
        report["ct_scatter_bag"]["max_abs_err"] = max(
            [report["ct_scatter_bag"]["max_abs_err"], *errs3])
    section = dict(
        requests=CSR_REQUESTS, bags=NB, entries=T,
        bag_len_min=int(lens.min()), bag_len_max=int(lens.max()),
        bag_len_mean=float(lens.mean()), table_s=table_s, draw_s=draw_s,
        fwd_bwd_host_ms=host_ms, fwd_bwd_ms=fb_ms, launches=launches,
        drop_in_launches=d_launches, grad_rows=rows,
        grad_vs_rect_rel=rel,
        csr_bag=dict(kernel_ms=ms5, plain_ms=plain5, library_ms=lib5_ms,
                     bound_ms=b5, banked_bag_rect_ms=rect_ms),
        plain_bag=dict(kernel_ms=ms7, plain_ms=plain7_ms, library_ms=lib7_ms,
                       bound_ms=b7),
        scatter=dict(kernel_ms=ms_s, plain_ms=plain_s, library_ms=lib_s_ms,
                     bound_ms=bs, runs=n_run, live_entries=n_live,
                     longest_run=longest, library_rel_err=lib_rel))
    return section, launches, d_launches


def cached_adaptive_main_path(dev, spec):
    """Phase 9's main path: ``run_cached_adaptive`` at full width (the
    adaptive cache lane), with every launch counter set to 0 just before
    and read just after. ``min_swaps=1`` makes the run itself raise unless
    a swap took place, the shapes stayed stable, and the first swap's EMT
    and cache table (packed, ``remap_bank``, ``remap_slot``) and its output
    equal a fresh build, checked on the card."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import run_cached_adaptive
    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "tiered_bag": kbag.tiered_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    for fn in counters.values():
        fn.launches = 0
    res = run_cached_adaptive(spec, spec.config,
                              requests=CACHED_ADAPTIVE_REQUESTS, batch=64,
                              replan_every=CACHED_ADAPTIVE_REPLAN,
                              min_swaps=1, device=dev)
    launches = {k: fn.launches for k, fn in counters.items()}
    need_warm_probe(res, "serve_cached_adaptive")
    print(f"serve_cached_adaptive: {len(res.latencies)} requests at batch 64, "
          f"launches {launches}")
    for name in ("cache_residual_bag", "dot_features"):
        need(launches[name] > 0, f"the cache lane launched no {name} kernel")
    for name in ("banked_bag", "ct_scatter_bag", "tiered_bag",
                 "dot_interaction"):
        need(launches[name] == 0, f"the cache lane launched {name} "
                                  f"{launches[name]} times")
    need(res.checks == {"shapes_stable": True, "arrays_ok": True,
                        "outputs_ok": True},
         f"cache lane swap checks {res.checks}")
    for e in res.swaps:
        print(f"  [swap @batch {e.batch}] imbalance {e.old_imbalance:.6f} -> "
              f"{e.new_imbalance:.6f}; cache v{e.cache_version}, "
              f"{e.cache_entries} entries ({e.cache_dropped} dropped); "
              f"{e.update.report}")
    print(f"  swap parity on the card (first swap, version "
          f"{res.swap_probe['version']}): EMT and cache table == fresh build,"
          f" scores through the swapped-in table == through the fresh one; "
          f"shapes stable {res.checks['shapes_stable']}")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
    return res, launches


def check_cached_adaptive_kernel(dev, res):
    """The fused kernel vs its plain version, bit for bit, on the post-swap
    EMT: the batch in flight across the last swap with the RETIRED version's
    cache table it was rewritten for, and the same bags rewritten under the
    new version with the new table; then its time at the lane's shape."""
    import torch
    from repro_torch.kernels.embedding_bag import (cache_residual_bag,
                                                   cache_residual_bag_plain)
    rt, e = res.runtime, res.swaps[-1]
    i = e.batch - 1                          # the batch in flight
    ci, ri, v = res.rewritten[i]
    need(v == e.cache_version - 1,
         f"the batch in flight was rewritten under v{v}, the swap installed "
         f"v{e.cache_version}")
    rb = rt.rewriter.rewrite_rect(res.unions[i])
    t = rt.table
    cases = (("in flight, retired version", rt.cache_table_for(v), ci, ri, v),
             ("rewritten after the swap", rt.cache_table, rb.cache_idx,
              rb.residual_idx, rb.version))
    out = {}
    for name, ct, c_np, r_np, ver in cases:
        c = torch.from_numpy(c_np.reshape(-1, c_np.shape[-1])).to(dev)
        r = torch.from_numpy(r_np.reshape(-1, r_np.shape[-1])).to(dev)
        args = (t.packed, ct.packed, t.remap_bank, t.remap_flat,
                ct.remap_bank, ct.remap_flat, -1, c.contiguous(),
                r.contiguous())
        got, want = cache_residual_bag(*args), cache_residual_bag_plain(*args)
        torch.cuda.synchronize()
        need(torch.equal(got, want), f"cache_residual_bag on the cache lane, "
                                     f"{name}: kernel != plain")
        n_c = int((c >= 0).sum())
        print(f"  cache_residual_bag, {name} (v{ver}, {n_c} cache + "
              f"{int((r >= 0).sum())} residual entries): == plain")
        out[name] = (args, n_c, int((r >= 0).sum()))
    args, n_c, n_r = out["rewritten after the swap"]
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    ms = time_ms(lambda: cache_residual_bag(*args), flush=scratch.zero_)
    bound, by = cache_bag_bound_ms(args[7], args[8], t.dim,
                                   t.packed.element_size())
    print(f"cache_residual_bag at the cache lane's shape (NB="
          f"{args[7].shape[0]}, Lc={args[7].shape[1]}, Lr={args[8].shape[1]};"
          f" {n_c} cache + {n_r} residual entries): kernel {ms:.4f} ms, "
          f"bound {bound:.6f} ms ({by})")
    return dict(kernel_ms=ms, bound_ms=bound, bound_by=by, cache_entries=n_c,
                residual_entries=n_r, in_flight_version=v,
                new_version=rb.version)


def check_cached_adaptive_outputs(dev, spec, res):
    """Scores finite, in (0, 1); the last batch's reads equal their host
    twin; the last batch re-scored with the plain versions within rtol
    1e-5 / atol 1e-6; the reduced config's cache lane on the card equals
    the CPU's swap for swap (same weights): the same swap events, rewritten
    ids and versions, reads, cache tables, scores within rtol 1e-5 / atol
    1e-6."""
    import numpy as np
    import torch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.serve import run_cached_adaptive
    from repro_torch.models import dlrm
    from repro_torch.obs.traffic import host_cached_bank_read_counts
    from repro_torch.serve.serve_step import build_recsys_serve_cached_adaptive
    cfg = spec.config
    need(tuple(res.scores.shape) == (CACHED_ADAPTIVE_REQUESTS,),
         f"cache lane scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite lane scores")
    need(bool(((res.scores > 0) & (res.scores < 1)).all()),
         "cache lane scores outside (0, 1)")
    rt, b = res.runtime, res.last_batch
    ci, ri, v = res.rewritten[-1]
    want = host_cached_bank_read_counts(rt.rewriter.plan_for(v).entry_bank,
                                        ci, rt.plan.bank_of_row, ri,
                                        rt.table.n_banks)
    need(np.array_equal(res.reads[-1], want),
         f"cached traffic counters: card {res.reads[-1]} != host {want}")
    t, ct = rt.table, rt.cache_table_for(v)
    params = {**res.params, "emb_packed": t.packed}
    s_k = build_recsys_serve_cached_adaptive(dlrm, cfg, res.statics)(
        params, t.remap_bank, t.remap_slot, ct, b, remap_flat=t.remap_flat)
    s_p = build_recsys_serve_cached_adaptive(
        dlrm, cfg, res.statics, backend="torch")(
        params, t.remap_bank, t.remap_slot, ct, b, remap_flat=t.remap_flat)
    n = (CACHED_ADAPTIVE_REQUESTS - 1) % 64 + 1
    need(torch.equal(s_k[:n], res.scores[-n:]),
         "the last batch re-served != the run's scores")
    s_err = (s_k - s_p).abs().max().item()
    need(torch.allclose(s_k, s_p, **SCORE_TOL),
         f"cache lane serve step, kernels vs plain: max abs err {s_err}")
    print(f"cache lane outputs: finite, in (0, 1); last batch reads == host "
          f"twin {want.tolist()}; re-scored with the plain versions: max abs "
          f"err {s_err} (rtol 1e-5/atol 1e-6)")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(requests=96, batch=8, replan_every=2, drift_rotate_every=24,
              seed=1, min_swaps=1)
    cpu = run_cached_adaptive(spec, red, device="cpu", params=p0, **kw)
    card = run_cached_adaptive(spec, red, device=dev,
                               params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.old_imbalance, e.new_imbalance,  # noqa: E731
                     e.cache_version, e.cache_entries, e.cache_dropped)
                    for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) >= 1,
         f"reduced cache lane: swaps card {ev(card)} != CPU {ev(cpu)}")
    need(len(card.rewritten) == len(cpu.rewritten)
         and all(np.array_equal(a[0], x[0]) and np.array_equal(a[1], x[1])
                 and a[2] == x[2]
                 for a, x in zip(card.rewritten, cpu.rewritten)),
         "reduced cache lane: rewritten ids or versions card != CPU")
    need(all(np.array_equal(x, y) for x, y in zip(card.reads, cpu.reads)),
         "reduced cache lane: per-batch reads card != CPU")
    for f in ("packed", "remap_bank", "remap_slot"):
        need(torch.equal(getattr(card.runtime.cache_table, f).cpu(),
                         getattr(cpu.runtime.cache_table, f)),
             f"reduced cache lane: cache table {f} card != CPU")
    need(torch.equal(card.runtime.table.packed.cpu(),
                     cpu.runtime.table.packed),
         "reduced cache lane: packed EMT card != CPU")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced cache lane, card vs CPU: max abs err {err}")
    print(f"reduced config cache lane on the card (fused kernel) vs the CPU "
          f"(jnp order), same weights: {len(cpu.swaps)} swap(s) {ev(cpu)} "
          f"equal, rewritten ids, versions, reads, EMT and cache table "
          f"equal, scores max abs err {err} (rtol 1e-5/atol 1e-6)")
    return dict(score_err=s_err, reduced_score_err=err,
                reduced_swaps=ev(cpu), last_reads=want.tolist())


def cached_adaptive_breakdown(dev, spec, res):
    """Device time of the lane's serve step and the interaction's fused
    entry on its inputs (CUDA events, L2 flushed); the host's per-batch
    times (tap, rewrite, serve call) and per-swap times (replan, migration,
    cache install) from the run."""
    import torch
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve_cached_adaptive
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    rt, b = res.runtime, res.last_batch
    t, ct = rt.table, rt.cache_table_for(res.rewritten[-1][2])
    params = {**res.params, "emb_packed": t.packed}
    serve = build_recsys_serve_cached_adaptive(dlrm, spec.config, res.statics)

    def step():
        return serve(params, t.remap_bank, t.remap_slot, ct, b,
                     remap_flat=t.remap_flat)
    with torch.inference_mode():
        emb = dlrm.banked_cache_residual_bag(t, ct, b["cache_idx"],
                                             b["residual_idx"])
        x = dlrm.mlp_apply(params["bot"], b["dense"])
        out = {"serve_step": time_ms(step, flush=scratch.zero_),
               "dot_features": time_ms(lambda: kdot.dot_features(x, emb))}
        prof = profile_device(step, n=5)
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "rewrite", "serve",
                      "end_batch")}
    rps = len(res.latencies) / res.serve_s
    print(f"cache lane serve step (device ms, L2 flushed): "
          f"{out['serve_step']:.4f}; dot_features on its inputs "
          f"{out['dot_features']:.4f} ms")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per lane serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    print(f"cache lane: p50 {res.p50_ms:.3f} ms, p99 {res.p99_ms:.3f} ms, "
          f"{rps:.1f} requests/s over {len(res.latencies)} requests "
          f"({res.serve_s:.3f} s serving, swaps included); hit rate on the "
          f"served bags {res.stats['hit_rate']:.6f}")
    print("one cache-lane batch of 64 on the host (median over the run, ms): "
          + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("next_batch", "observe", "rewrite", "serve", "end_batch"):
        print(f"  per batch, {k} ms: " + ", ".join(f"{x:.3f}" for x in h[k]))
    print("  per swap, host ms: " + "; ".join(
        f"batch {e.batch}: replan {a:.1f}, migrate {m:.1f}, cache install "
        f"{c:.1f}, swap checks {k:.1f}"
        for e, a, m, c, k in zip(res.swaps, h["replan"], h["migrate"],
                                 h["cache_install"], h["check_swap"])))
    return {**out, **host, "requests_per_s": rps}


def adaptive_train_main_path(dev, spec, partition, steps, replan_every,
                             refresh_every):
    """Phase 10's main path for one partition: ``launch.train.run_adaptive``
    at full width with every launch counter set to 0 just before and read
    just after. Spies on the migration and the refresh: every migration's
    Adagrad state must equal ``migrate_rowwise_state`` of the state before
    it, and every refreshed cache table a fresh build from the current
    rows (all of them gathered on the card), bit for bit."""
    import math
    import time as _time
    import torch
    from repro_torch.core.cache_runtime import build_cache_table_fixed
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch import train as ltrain
    from repro_torch.workload.migrate import migrate_rowwise_state
    from repro_torch.workload.runtime import AdaptiveEmbeddingRuntime
    spy = {"adagrad_moved": 0, "refreshes_checked": 0, "refresh_ms": [],
           "refresh_entries": []}
    real_migrate = ltrain._migrate_state
    real_refresh = AdaptiveEmbeddingRuntime.refresh_cache

    def migrate(state, table, plan, cap):
        old = state.opt_state["true"][0]
        new = real_migrate(state, table, plan, cap)
        want = migrate_rowwise_state(old, table, plan, rows_per_bank=cap)
        need(torch.equal(new.opt_state["true"][0], want),
             f"{partition} train: the migrated Adagrad state != "
             f"migrate_rowwise_state of the old state")
        spy["adagrad_moved"] += 1
        return new

    def refresh(self):
        t0 = _time.perf_counter()
        v = real_refresh(self)
        torch.cuda.synchronize()
        spy["refresh_ms"].append((_time.perf_counter() - t0) * 1e3)
        t = self.table
        fresh = build_cache_table_fixed(t.packed.detach()[t.remap_flat.long()],
                                        self.cache_plan,
                                        device=t.packed.device)
        ct = self.cache_table
        need(all(torch.equal(getattr(ct, f), getattr(fresh, f))
                 for f in ("packed", "remap_bank", "remap_slot")),
             f"refresh v{v}: cache table != fresh build from the current rows")
        spy["refreshes_checked"] += 1
        spy["refresh_entries"].append(self.cache_plan.n_entries)
        return v

    counters = {"banked_bag": kbag.banked_bag,
                "cache_residual_bag": kbag.cache_residual_bag,
                "ct_scatter_bag": kbag.ct_scatter_bag,
                "dot_features": kdot.dot_features,
                "dot_interaction": kdot.dot_interaction}
    ltrain._migrate_state = migrate
    AdaptiveEmbeddingRuntime.refresh_cache = refresh
    try:
        for fn in counters.values():
            fn.launches = 0
        res = ltrain.run_adaptive(spec, spec.config, steps=steps,
                                  batch=TRAIN_BATCH, partition=partition,
                                  replan_every=replan_every,
                                  cache_refresh_every=refresh_every,
                                  device=dev)
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        ltrain._migrate_state = real_migrate
        AdaptiveEmbeddingRuntime.refresh_cache = real_refresh
    print(f"adaptive train, {partition}: {steps} steps at batch "
          f"{TRAIN_BATCH}, launches {launches}")
    lookup = "cache_residual_bag" if partition == "cache_aware" \
        else "banked_bag"
    other = "banked_bag" if partition == "cache_aware" \
        else "cache_residual_bag"
    for name in (lookup, "dot_features"):
        need(launches[name] > 0, f"{partition} train launched no {name}")
    # the cache table takes no gradient: one scatter a step, not two
    need(launches["ct_scatter_bag"] == steps,
         f"{partition} train: {launches['ct_scatter_bag']} scatter launches "
         f"in {steps} steps")
    for name in (other, "dot_interaction"):
        need(launches[name] == 0, f"{partition} train launched {name} "
                                  f"{launches[name]} times")
    need(len(res.migrations) >= 1
         and spy["adagrad_moved"] == len(res.migrations),
         f"{partition} train: {len(res.migrations)} migrations, "
         f"{spy['adagrad_moved']} Adagrad moves checked")
    if partition == "cache_aware":
        need(len(res.refreshes) >= 1
             and spy["refreshes_checked"] == len(res.refreshes),
             f"cached train: refreshes {res.refreshes}, "
             f"{spy['refreshes_checked']} checked")
        # a refresh of version 0's empty plan checks nothing: each checked
        # refresh must re-sum a plan mined at a migration before it
        first = res.migrations[0][0]
        need(all(step > first for step, _ in res.refreshes)
             and all(n > 0 for n in spy["refresh_entries"]),
             f"cached train: refreshes at steps "
             f"{[s for s, _ in res.refreshes]} with entries "
             f"{spy['refresh_entries']}, first migration at step {first}")
    need(len(res.losses) == steps
         and all(math.isfinite(x) for x in res.losses),
         f"{partition} train losses {res.losses}")
    h = res.host_ms
    print("  losses " + ", ".join(f"{x:.6f}" for x in res.losses)
          + "; step ms (host, synchronized) "
          + ", ".join(f"{x:.3f}" for x in res.step_ms)
          + "; batch prep ms (draw, tap, rewrite) "
          + ", ".join(f"{x:.1f}" for x in h["batch"]))
    for (step, u), a, m, s in zip(res.migrations, h["replan"], h["migrate"],
                                  h["swap"]):
        print(f"  [migrate @step {step}] imbalance -> "
              f"{u.plan.imbalance():.6f}; host ms: replan {a:.1f}, migrate "
              f"(params + Adagrad) {m:.1f}, swap {s:.1f}; Adagrad == "
              f"migrate_rowwise_state")
    for (step, v), ms, n in zip(res.refreshes, spy["refresh_ms"],
                                spy["refresh_entries"]):
        print(f"  [cache refresh @step {step}] -> v{v}, {n} entries, "
              f"{ms:.1f} ms; == fresh build from the current rows")
    return res, launches, spy


def cached_train_replay(dev, spec, res):
    """The batch of the first migration's step, re-drawn and rewritten
    under the live cache plan (no telemetry feed): the plan was mined from
    that step's bags, so it hits the cache where the run's later, freshly
    drawn batches of uniform ids rarely do. Returned as the train step's
    batch dict, against the live EMT and the current cache table."""
    import torch
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.workload.telemetry import rows_from_sparse
    cfg = spec.config
    step = res.migrations[0][0]
    host = make_batch_fn(spec, cfg)(TRAIN_BATCH, 0, step)
    rt = res.runtime
    rb = rt.rewriter.rewrite_rect(rows_from_sparse(host["sparse"],
                                                   cfg.field_offsets()))
    hits = int((rb.cache_idx >= 0).sum())
    entries = rt.cache_plan.n_entries
    need(hits > 0, f"cached train: the batch of step {step} rewritten under "
                   f"the live plan ({entries} entries) hits no entry")
    t = rt.table
    b = {"dense": torch.from_numpy(host["dense"]).to(dev),
         "label": torch.from_numpy(host["label"]).to(dev),
         "cache_idx": torch.from_numpy(rb.cache_idx).to(dev),
         "residual_idx": torch.from_numpy(rb.residual_idx).to(dev),
         "remap_bank": t.remap_bank, "remap_slot": t.remap_slot,
         "remap_flat": t.remap_flat,
         "cache_table": rt.cache_table_for(rb.version)}
    n_bags = rb.cache_idx.size // rb.cache_idx.shape[-1]
    print(f"cached train replay: step {step}'s batch under cache "
          f"v{rb.version}: {hits} cache hits in {n_bags} bags, {entries} "
          f"live entries of {rt.cache_plan.capacity}")
    return b, dict(step=step, version=rb.version, cache_hits=hits,
                   entries=entries)


def check_cached_train_grad(dev, spec, res, b=None, what="last batch"):
    """One step of the cached train path at the served shape (``b``, by
    default the run's last batch): the EMT's gradient equals the plain
    scatter of the bag sums' cotangent bit for bit, and the backward
    launches one scatter (the cache table takes none)."""
    import torch
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.kernels.embedding_bag import ct_scatter_bag_plain
    from repro_torch.models import dlrm
    cfg = spec.config
    b = res.last_batch if b is None else b
    st = res.statics
    packed = res.state.params["emb_packed"].detach().requires_grad_(True)
    params = {**res.state.params, "emb_packed": packed}
    caught = {}
    lookup = dlrm.banked_cache_residual_bag

    def hooked(*a, **k):
        out = lookup(*a, **k)
        out.register_hook(lambda g: caught.__setitem__("ct", g))
        return out
    dlrm.banked_cache_residual_bag = hooked
    try:
        logits = dlrm.forward_cached(
            cfg, params, st, b["cache_table"],
            {"dense": b["dense"], "cache_idx": b["cache_idx"],
             "residual_idx": b["residual_idx"]},
            remap_bank=b["remap_bank"], remap_slot=b["remap_slot"],
            remap_flat=b["remap_flat"])
        loss = dlrm.bce_loss(logits, b["label"])
    finally:
        dlrm.banked_cache_residual_bag = lookup
    kbag.ct_scatter_bag.launches = 0
    (g,) = torch.autograd.grad(loss, [packed])
    n_scatter = kbag.ct_scatter_bag.launches
    ri = b["residual_idx"]
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    want = ct_scatter_bag_plain(
        caught["ct"].reshape(-1, cfg.embed_dim).contiguous(),
        ri.reshape(-1, ri.shape[-1]).contiguous(), b["remap_bank"],
        b["remap_flat"], zero, -1, packed.shape[0])
    need(torch.equal(g, want), f"cached train step ({what}): EMT gradient "
                               f"!= plain scatter of the same cotangent")
    need(n_scatter == 1, f"cached train backward ({what}): {n_scatter} "
                         f"scatter launches (the cache table takes none)")
    rows = int((g != 0).any(1).sum())
    hits = int((b["cache_idx"] >= 0).sum())
    print(f"cached train step ({what}, {hits} cache hits): EMT gradient == "
          f"plain scatter of the same cotangent ({rows} rows non-zero), one "
          f"scatter launch")
    return dict(grad_rows=rows, scatter_launches=n_scatter, cache_hits=hits)


def check_adaptive_train_reduced(dev, spec):
    """The reduced config's adaptive training, both partitions, on the card
    and on the CPU from the same weights: the same migrations at the same
    steps with the same plans, the same refreshes, rewritten ids and reads,
    losses within LOSS_RTOL."""
    import numpy as np
    import torch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.launch.train import run_adaptive
    from repro_torch.models import dlrm
    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(4), plan=plan,
                             rows_per_bank=cap, device="cpu")
    out = {}
    for partition in ("non_uniform", "cache_aware"):
        kw = dict(steps=9, batch=8, replan_every=3, cache_refresh_every=4,
                  seed=2, partition=partition)
        cpu = run_adaptive(spec, red, device="cpu", params=p0, **kw)
        card = run_adaptive(spec, red, device=dev, params=to_dev(p0, dev),
                            **kw)
        mig = lambda r: [(s, u.plan.bank_of_row.tobytes())  # noqa: E731
                         for s, u in r.migrations]
        need(mig(card) == mig(cpu) and len(cpu.migrations) >= 1,
             f"reduced {partition} train: migrations card "
             f"{[s for s, _ in card.migrations]} != CPU "
             f"{[s for s, _ in cpu.migrations]}")
        need(card.refreshes == cpu.refreshes,
             f"reduced {partition} train: refreshes {card.refreshes} != "
             f"{cpu.refreshes}")
        need(all(np.array_equal(a[0], x[0]) and np.array_equal(a[1], x[1])
                 and a[2] == x[2]
                 for a, x in zip(card.rewritten, cpu.rewritten))
             and len(card.rewritten) == len(cpu.rewritten),
             f"reduced {partition} train: rewritten ids card != CPU")
        need(all(np.array_equal(x, y) for x, y in zip(card.reads, cpu.reads)),
             f"reduced {partition} train: reads card != CPU")
        need(np.allclose(card.losses, cpu.losses, rtol=LOSS_RTOL, atol=0),
             f"reduced {partition} train, card vs CPU: losses "
             f"{card.losses} vs {cpu.losses}")
        print(f"reduced config adaptive train ({partition}) on the card vs "
              f"the CPU, same weights: migrations at steps "
              f"{[s for s, _ in cpu.migrations]} with equal plans, refreshes "
              f"{cpu.refreshes}, rewritten ids and reads equal; losses "
              f"{card.losses} vs {cpu.losses}")
        out[partition] = dict(card=card.losses, cpu=cpu.losses,
                              migration_steps=[s for s, _ in cpu.migrations],
                              refreshes=cpu.refreshes)
    return out


def adaptive_train_kernel_times(dev, spec, res_c, res_n, replay):
    """The kernels of phase 10 at its shapes (CUDA events, L2 flushed): the
    fused bag on the cached train batch (held against its plain version
    there and on the replayed batch that hits the cache), the scatter
    kernel on its residual ids and on the §3.2 path's raw ids, the bag
    kernel on the §3.2 path's last batch."""
    import torch
    from repro_torch.kernels import embedding_bag as kbag
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    D = spec.config.embed_dim
    out = {}
    packed = res_c.state.params["emb_packed"]
    entries = res_c.runtime.cache_plan.n_entries

    def fused_args(b):
        ct = b["cache_table"]
        ci = b["cache_idx"].reshape(-1, b["cache_idx"].shape[-1])
        ri = b["residual_idx"].reshape(-1, b["residual_idx"].shape[-1])
        return (packed, ct.packed, b["remap_bank"], b["remap_flat"],
                ct.remap_bank, ct.remap_flat, -1, ci.contiguous(),
                ri.contiguous())
    for what, b in (("last batch", res_c.last_batch), ("replay", replay)):
        args = fused_args(b)
        need(torch.equal(kbag.cache_residual_bag(*args),
                         kbag.cache_residual_bag_plain(*args)),
             f"cache_residual_bag on the cached train {what}: kernel != "
             f"plain")
        print(f"cache_residual_bag == plain on the cached train {what}: "
              f"{int((args[7] >= 0).sum())} cache hits, {entries} live "
              f"entries")
    b = res_c.last_batch
    args = fused_args(b)
    ri = args[8]
    out["cache_residual_bag_ms"] = time_ms(
        lambda: kbag.cache_residual_bag(*args), flush=scratch.zero_)
    zero = torch.zeros((1,), dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(19)
    ct_c = torch.randn((ri.shape[0], D), generator=g, device=dev)
    R = packed.shape[0]
    for name, idx, bank, slot, off in (
            ("cached", ri, b["remap_bank"], b["remap_flat"], zero),
            ("non_uniform",
             res_n.last_batch["sparse"].reshape(-1, spec.config.multi_hot
                                                ).contiguous(),
             res_n.statics["remap_bank"], res_n.statics["remap_flat"],
             res_n.statics["field_offsets"])):
        runs = kbag.scatter_prep(idx, bank, slot, off, -1, R)
        o = torch.zeros((R, D), device=dev)
        out[f"ct_scatter_{name}_ms"] = time_ms(
            lambda: kbag.ct_scatter_launch(ct_c, runs, o), flush=scratch.zero_)
        need(torch.equal(o, kbag.ct_scatter_runs_plain(
            ct_c, runs, torch.zeros((R, D), device=dev))),
             f"ct_scatter on the {name} train ids: kernel != plain")
        n_run, n_live, longest = run_lengths(runs)
        out[f"ct_scatter_{name}_bound_ms"] = scatter_bound_ms(
            runs, idx.shape[0], D, 4)[0]
        out[f"ct_scatter_{name}_runs"] = [n_run, n_live, longest]
        del o
    sn, st = res_n.last_batch["sparse"], res_n.statics
    idx = sn.reshape(-1, spec.config.multi_hot).contiguous()
    pn = res_n.state.params["emb_packed"]
    bag = (pn, st["remap_bank"], st["remap_flat"], st["field_offsets"], -1,
           idx)
    need(torch.equal(kbag.banked_bag(*bag), kbag.banked_bag_plain(*bag)),
         "banked_bag on the adaptive train batch: kernel != plain")
    out["banked_bag_ms"] = time_ms(lambda: kbag.banked_bag(*bag),
                                   flush=scratch.zero_)
    print("phase 10 kernels at its shapes (ms, L2 flushed): "
          + ", ".join(f"{k} {v}" for k, v in out.items()))
    return out


def fault_main_path(dev, spec):
    """Phase 11's main path: ``run_fault`` at full width (the fault lane)
    with every launch counter set to 0 just before and read just after.
    ``min_recoveries=1`` and ``min_slo_breaches=1`` make the run itself
    raise unless a recovery happened, confinement held on the degraded
    batch, the first clean batch after the recovery equals the never-failed
    run bit for bit, every swap kept version 0's shapes, and an SLO breach
    reached the replanner."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.serve import SLOConfig, run_fault
    counters = {"banked_bag": (kbag.banked_bag, "launches"),
                "banked_bag_replicated": (kbag.banked_bag,
                                          "replicated_launches"),
                "cache_residual_bag": (kbag.cache_residual_bag, "launches"),
                "ct_scatter_bag": (kbag.ct_scatter_bag, "launches"),
                "tiered_bag": (kbag.tiered_bag, "launches"),
                "csr_bag": (kbag.csr_bag, "launches"),
                "dot_features": (kdot.dot_features, "launches"),
                "dot_interaction": (kdot.dot_interaction, "launches")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    res = run_fault(spec, spec.config, requests=FAULT_REQUESTS, batch=64,
                    faults=FAULT_SCHEDULE, replan_every=FAULT_REPLAN,
                    slo=SLOConfig(**FAULT_SLO), min_slo_breaches=1,
                    min_recoveries=1, device=dev)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    need_warm_probe(res, "serve_fault")
    print(f"serve_fault: {len(res.latencies)} requests at batch 64, "
          f"schedule {FAULT_SCHEDULE}, launches {launches}")
    for name in ("banked_bag", "dot_features"):
        need(launches[name] > 0, f"the fault lane launched no {name} kernel")
    for name in ("banked_bag_replicated", "cache_residual_bag",
                 "ct_scatter_bag", "tiered_bag", "csr_bag",
                 "dot_interaction"):
        need(launches[name] == 0, f"the fault lane launched {name} "
                                  f"{launches[name]} times")
    for b, e in res.fired:
        print(f"  [fault @batch {b}] {e}")
    for e in res.swaps:
        rec = (f", recovery {e.recovery_s * 1e3:.1f} ms"
               if e.reason == "bank_failure" else "")
        print(f"  [{e.reason} swap, runtime batch clock {e.batch}]{rec} "
              f"imbalance {e.old_imbalance:.6f} -> {e.new_imbalance:.6f}")
    for e in res.slo_events:
        print(f"  [slo breach @batch {e['batch']}] {e['kind']}: "
              f"{e['value']:.1f} > {e['threshold']:.1f}, hot bank "
              f"{e['bank']}, penalty x{e['penalty']:.3f} -> replanner")
    print("  set-up seconds: " + ", ".join(
        f"{k[:-2]} {v:.3f}" for k, v in res.stats.items() if k.endswith("_s")))
    return res, launches


def check_fault_outputs(dev, spec, res, report):
    """The fault lane's outputs: scores finite in [0, 1]; on every batch the
    served reads plus the degraded reads equal the valid lookups; only the
    failure's batch degraded, its per-request counts equal a host recount
    from the plan it was served under; confinement per bag on it — every
    bag with no dead read equals the never-failed bag sums (all banks live)
    bit for bit, and every bag equals the plain version on the same ids
    with the dead bank's ids set to -1; the bag kernel under the binary
    live map (my = 0) equal to its plain version on the batch; a recovery,
    a straggler replan and an SLO breach fed to the replanner; then the
    reduced config's fault lane on the card against the CPU, event for
    event (the same fired events, degraded counts, reads, swaps with their
    plans, straggler steps, SLO breaches and final table; scores within
    rtol 1e-5 / atol 1e-6)."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import (_binary_live_map,
                                            banked_embedding_bag,
                                            degraded_row_counts)
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.kernels.embedding_bag import banked_bag, banked_bag_plain
    from repro_torch.launch.serve import SLOConfig, run_fault
    from repro_torch.models import dlrm
    cfg = spec.config
    need(tuple(res.scores.shape) == (FAULT_REQUESTS,),
         f"fault lane scores {res.scores.shape}")
    need(bool(torch.isfinite(res.scores).all()), "non-finite fault scores")
    need(bool(((res.scores >= 0) & (res.scores <= 1)).all()),
         "fault lane scores outside [0, 1]")
    for i, (r, c, n) in enumerate(zip(res.reads, res.degraded, res.lookups)):
        need(int(r.sum()) + int(c.sum()) == n,
             f"batch {i}: reads {int(r.sum())} + degraded {int(c.sum())} != "
             f"{n} valid lookups")
    fail = res.stats["fail_batch"]
    degraded = [i for i, c in enumerate(res.degraded) if c.sum() > 0]
    need(degraded == [fail], f"degraded batches {degraded}, failure at "
                             f"batch {fail}")
    need(len(res.probes) == 1, f"{len(res.probes)} confinement probes")
    p = res.probes[0]
    t, t0 = p["table"], res.never_failed
    sp, offs = p["feats"]["sparse"], res.statics["field_offsets"]
    B, F, L = sp.shape
    live = torch.from_numpy(p["live"]).to(dev)
    rows = torch.where(sp >= 0, sp + offs[None, :, None], -1)
    rows_np = rows.cpu().numpy()
    dead_np = ~p["live"][p["plan"].bank_of_row[np.maximum(rows_np, 0)]]
    host = ((rows_np >= 0) & dead_np).reshape(B, -1).sum(1)
    need(np.array_equal(host, p["counts"]),
         f"degraded counts: card {p['counts'].tolist()} != host recount "
         f"{host.tolist()}")
    got = banked_embedding_bag(t, sp, field_offsets=offs, bank_live=live)
    ref = banked_embedding_bag(t0, sp, field_offsets=offs)
    per_bag = degraded_row_counts(t.remap_bank, live, rows, per_bag=True)
    clean = per_bag == 0
    need(torch.equal(got[clean], ref[clean]),
         "per-bag confinement: a bag with no dead read != never-failed")
    dead_read = (rows >= 0) & ~live[t.remap_bank[rows.clamp(min=0)].long()]
    masked = torch.where(dead_read, -1, sp).reshape(-1, L).to(torch.int32)
    want = banked_bag_plain(t.packed, t.remap_bank, t.remap_flat, offs, -1,
                            masked.contiguous()).reshape(B, F, -1)
    need(torch.equal(got, want),
         "degraded bag sums != plain version on the ids with dead reads -1")
    # the same ids with their dead reads dropped: every bag is clean, so
    # under the live map every bag must equal the never-failed sums (at
    # full width a bag of 256 Zipf rows almost never misses the dead bank)
    masked3 = masked.reshape(B, F, L)
    need(torch.equal(banked_embedding_bag(t, masked3, field_offsets=offs,
                                          bank_live=live),
                     banked_embedding_bag(t0, masked3, field_offsets=offs)),
         "per-bag confinement on the ids without dead reads: != never-failed")
    lm = _binary_live_map(t.remap_bank, live)
    idx = sp.reshape(-1, L).to(torch.int32).contiguous()
    k = banked_bag(t.packed, lm, t.remap_flat, offs, 0, idx)
    pl = banked_bag_plain(t.packed, lm, t.remap_flat, offs, 0, idx)
    torch.cuda.synchronize()
    need(torch.equal(k, pl), "banked_bag under the binary live map (my=0) "
                             "on the fault batch: kernel != plain")
    report["banked_bag"]["max_abs_err"] = max(
        report["banked_bag"]["max_abs_err"],
        (k - pl).abs().max().item())
    n_clean_req = int((p["counts"] == 0).sum())
    print(f"fault lane outputs: finite, in [0, 1]; reads + degraded == valid "
          f"lookups on all {len(res.reads)} batches; batch {fail} degraded "
          f"({int(p['counts'].sum())} reads, counts == host recount); "
          f"{n_clean_req}/{B} requests and {int(clean.sum())}/{clean.numel()}"
          f" bags clean: clean bags == never-failed bit for bit, every bag =="
          f" plain on ids with dead reads -1, and with those ids all "
          f"{clean.numel()} bags == never-failed; banked_bag (binary live "
          f"map, my=0) == plain on the batch")
    reasons = [e.reason for e in res.swaps]
    need("bank_failure" in reasons and "straggler" in reasons,
         f"fault lane swaps {reasons}: need a recovery and a straggler "
         f"replan")
    need(res.checks == {"shapes_stable": True, "confine_ok": True,
                        "recover_parity": True},
         f"fault lane checks {res.checks}")
    need(res.stats["slo_penalties"] >= 1 and res.slo_events,
         "no SLO breach reached the replanner")

    red = spec.reduced
    V = red.total_vocab
    cap = int(np.ceil(V / 8) * 1.25)
    plan = non_uniform_partition(np.ones(V), 8, capacity_rows=cap)
    p0, _ = dlrm.init_params(red, torch.Generator().manual_seed(3), plan=plan,
                             rows_per_bank=cap, device="cpu")
    kw = dict(requests=96, batch=8, faults=FAULT_REDUCED_SCHEDULE,
              replan_every=16, seed=1, min_recoveries=2,
              slo=SLOConfig(max_share=0.17, window=4))
    cpu = run_fault(spec, red, device="cpu", params=p0, **kw)
    card = run_fault(spec, red, device=dev, params=to_dev(p0, dev), **kw)
    ev = lambda r: [(e.batch, e.reason, e.old_imbalance,  # noqa: E731
                     e.new_imbalance) for e in r.swaps]
    need(ev(card) == ev(cpu) and len(cpu.swaps) == 3,
         f"reduced fault lane: swaps card {ev(card)} != CPU {ev(cpu)}")
    need([(b, str(e)) for b, e in card.fired]
         == [(b, str(e)) for b, e in cpu.fired],
         "reduced fault lane: fired events card != CPU")
    for name in ("degraded", "reads"):
        need(all(np.array_equal(x, y) for x, y in
                 zip(getattr(card, name), getattr(cpu, name))),
             f"reduced fault lane: per-batch {name} card != CPU")
    for a, b in zip(card.swaps, cpu.swaps):
        for f in ("bank_of_row", "slot_of_row", "load_per_bank"):
            need(np.array_equal(getattr(a.update.plan, f),
                                getattr(b.update.plan, f)),
                 f"reduced fault lane: swap @{a.batch} plan {f} card != CPU")
    need(card.stragglers == cpu.stragglers and cpu.stragglers,
         f"reduced fault lane: stragglers card {card.stragglers} != CPU "
         f"{cpu.stragglers}")
    sl = lambda r: [(e["batch"], e["kind"]) for e in r.slo_events]  # noqa
    need(sl(card) == sl(cpu) and sl(cpu),
         f"reduced fault lane: SLO breaches card {sl(card)} != CPU "
         f"{sl(cpu)}")
    need(torch.equal(card.runtime.table.packed.cpu(),
                     cpu.runtime.table.packed),
         "reduced fault lane: packed table card != CPU")
    need(card.checks == cpu.checks == {"shapes_stable": True,
                                       "confine_ok": True,
                                       "recover_parity": True},
         f"reduced fault lane checks: card {card.checks}, CPU {cpu.checks}")
    err = (card.scores.cpu() - cpu.scores).abs().max().item()
    need(torch.allclose(card.scores.cpu(), cpu.scores, **SCORE_TOL),
         f"reduced fault lane, card vs CPU: max abs err {err}")
    print(f"reduced config fault lane on the card vs the CPU, same weights: "
          f"fired {[(b, str(e)) for b, e in cpu.fired]}, swaps {ev(cpu)}, "
          f"stragglers {cpu.stragglers}, SLO breaches {sl(cpu)} equal; "
          f"degraded counts, reads, plans and table equal; scores max abs "
          f"err {err} (rtol 1e-5/atol 1e-6)")
    return dict(clean_requests=n_clean_req, requests=B,
                clean_bags=int(clean.sum()), bags=clean.numel(),
                degraded_reads=int(p["counts"].sum()),
                reduced_score_err=err, reduced_swaps=ev(cpu),
                reduced_stragglers=cpu.stragglers,
                reduced_breaches=sl(cpu))


def fault_breakdown(dev, spec, res):
    """Device time (CUDA events, L2 flushed) of the degraded serve step on
    the failure's batch (one bank dead: the binary live map rebuilt in the
    call) against the plain adaptive step on the same table and batch, and
    of the live map, the degraded counts and the bag kernel under the live
    map alone; the host's per-batch and per-swap times from the run."""
    import torch
    from repro_torch.core.embedding import (_binary_live_map,
                                            degraded_row_counts)
    from repro_torch.kernels.embedding_bag import banked_bag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import (
        build_recsys_serve_adaptive, build_recsys_serve_degraded_adaptive)
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    p = res.probes[0]
    t, feats = p["table"], p["feats"]
    live = torch.from_numpy(p["live"]).to(dev)
    params = {**res.params, "emb_packed": t.packed}
    deg = build_recsys_serve_degraded_adaptive(dlrm, spec.config,
                                               res.statics, with_traffic=True)
    plain = build_recsys_serve_adaptive(dlrm, spec.config, res.statics,
                                        with_traffic=True)
    offs = res.statics["field_offsets"]
    sp = feats["sparse"]
    rows = torch.where(sp >= 0, sp + offs[None, :, None], -1)
    idx = sp.reshape(-1, sp.shape[-1]).to(torch.int32).contiguous()
    lm = _binary_live_map(t.remap_bank, live)

    def degraded_step():
        return deg(params, t.remap_bank, t.remap_slot, live, feats,
                   remap_flat=t.remap_flat)

    def plain_step():
        return plain(params, t.remap_bank, t.remap_slot, feats,
                     remap_flat=t.remap_flat)
    with torch.inference_mode():
        out = {"degraded_step": time_ms(degraded_step, flush=scratch.zero_),
               "plain_step": time_ms(plain_step, flush=scratch.zero_),
               "live_map": time_ms(lambda: _binary_live_map(t.remap_bank,
                                                            live),
                                   flush=scratch.zero_),
               "degraded_counts": time_ms(
                   lambda: degraded_row_counts(t.remap_bank, live, rows),
                   flush=scratch.zero_),
               "bag_live_map": time_ms(
                   lambda: banked_bag(t.packed, lm, t.remap_flat, offs, 0,
                                      idx), flush=scratch.zero_)}
        prof = profile_device(degraded_step, n=5)
    out["live_map_share"] = out["live_map"] / out["degraded_step"]
    print(f"fault lane serve step (device ms, L2 flushed), one bank dead: "
          f"degraded {out['degraded_step']:.4f} against the plain adaptive "
          f"step {out['plain_step']:.4f}; the binary live map "
          f"({t.remap_bank.numel()} rows) {out['live_map']:.4f} "
          f"({out['live_map_share']:.1%} of the step), degraded counts "
          f"{out['degraded_counts']:.4f}, banked_bag under the live map "
          f"{out['bag_live_map']:.4f}")
    if prof is None:
        print("  profiler: no device events in the trace; busy time not "
              "measured")
    else:
        print(f"  profiler, per degraded serve call: device busy "
              f"{prof['busy_ms']:.4f} ms of a {prof['window_ms']:.4f} ms "
              f"window; by kernel: "
              + "; ".join(f"{k} {v:.4f}" for k, v in prof["top_kernels_ms"]))
        out["profile"] = prof
    h = res.host_ms
    host = {f"{k}_host_ms": statistics.median(h[k])
            for k in ("next_batch", "observe", "serve", "lane")}
    rps = len(res.latencies) / res.serve_s
    rec = [e.recovery_s * 1e3 for e in res.recoveries]
    st = res.stats
    print(f"fault lane: p50 {res.p50_ms:.3f} ms, p99 {res.p99_ms:.3f} ms, "
          f"{rps:.1f} requests/s over {len(res.latencies)} requests "
          f"({res.serve_s:.3f} s serving, replans included); recovery "
          f"{', '.join(f'{x:.1f}' for x in rec)} ms; "
          f"{st['straggler_events']} straggler event(s) at batches "
          f"{res.stragglers}; {st['slo_breaches']} SLO breach(es); "
          f"{st['degraded_reads']} degraded reads over "
          f"{st['degraded_batches']} batch(es)")
    print("one fault-lane batch of 64 on the host (median over the run, "
          "ms): " + ", ".join(f"{k} {v:.4f}" for k, v in host.items()))
    for k in ("serve", "lane", "never_failed", "recovery", "straggler"):
        print(f"  {k} ms: " + ", ".join(f"{x:.3f}" for x in h[k]))
    return {**out, **host, "requests_per_s": rps, "recovery_ms": rec}


def all_counters():
    """Every kernel wrapper's launch counter, by the kernel table's names
    (the replica select counts apart on the bag kernel's wrapper)."""
    from repro_torch.kernels import dot_interaction as kdot
    from repro_torch.kernels import embedding_bag as kbag
    return {"banked_bag": (kbag.banked_bag, "launches"),
            "banked_bag_replicated": (kbag.banked_bag,
                                      "replicated_launches"),
            "cache_residual_bag": (kbag.cache_residual_bag, "launches"),
            "ct_scatter_bag": (kbag.ct_scatter_bag, "launches"),
            "dot_interaction": (kdot.dot_interaction, "launches"),
            "dot_features": (kdot.dot_features, "launches"),
            "dot_features_query": (kdot.dot_features_query, "launches"),
            "tiered_bag": (kbag.tiered_bag, "launches"),
            "csr_bag": (kbag.csr_bag, "launches"),
            "plain_bag": (kbag.plain_bag, "launches"),
            "plain_cache_bag": (kbag.plain_cache_bag, "launches")}


def zero_counters():
    for fn, attr in all_counters().values():
        setattr(fn, attr, 0)


def read_counters() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in all_counters().items()}


def close(a, b, tol=SCORE_TOL):
    """Elementwise |a - b| <= atol + rtol |b| (tensors on one device)."""
    return (a - b).abs() <= tol["atol"] + tol["rtol"] * b.abs()


def check_topk(what, vals, ids, plain_scores, plain_vals, cand):
    """A top-k against the plain version's scores: the values within
    SCORE_TOL of the plain top-k's at the same rank, and every returned
    id's plain score too; copies of one candidate id returned lowest index
    first (the returned positions of each id are its first ones in the
    candidate list, in increasing order)."""
    import torch
    need(ids.dtype == torch.int32, f"{what}: ids {ids.dtype}, not int32")
    need(bool(close(vals, plain_vals).all()),
         f"{what}: top-k values vs plain, max abs err "
         f"{(vals - plain_vals).abs().max().item()}")
    need(bool(close(plain_scores[ids.long()], plain_vals).all()),
         f"{what}: a returned id's plain score is not the plain value at "
         f"its rank")
    ids_h, cand_h = ids.cpu().numpy(), cand.cpu().numpy()
    for v in set(cand_h[ids_h].tolist()):
        pos = ids_h[cand_h[ids_h] == v]
        first = (cand_h == v).nonzero()[0][:len(pos)]
        need((pos == first).all(), f"{what}: copies of candidate id {v} "
                                   f"not returned lowest index first")
    return len(set(cand_h[ids_h].tolist()))


def retrieval_phase(dev, report):
    """Phase 12: retrieval scoring (the reference's ``retrieval_cand``
    cell) at full ``dlrm-rm2`` width: 26 one-hot Criteo-Kaggle fields over
    one 33,762,577 x 64 bf16 table (one bank, the reference's default
    plan), one query against N = 1,000,000 field-0 candidates drawn
    uniformly over its 1,460 rows, top 128, through
    ``build_retrieval_serve`` with every launch counter set to 0 just
    before and read just after (the interaction's query entry must have
    run, no other kernel). Holds the query entry against its plain version
    at (N, 25 user rows, 64), its 325 query-only columns bit-equal across
    the rows, and the batch entry against its plain version at the
    materialised (N, 27, 64); the scores and the top-k against the plain
    path, a tie-free draw (N = 1,460, a permutation) id for id, and a
    reduced config on the card against the CPU; times the stages, the
    serve call's own peak device memory and the phase's; then
    ``check_dot_wide``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core.embedding import banked_gather
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_features_plain,
                                                     dot_features_query,
                                                     dot_features_query_plain)
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import (build_retrieval_serve,
                                              top_k_lowest_first)
    spec = get_arch("dlrm-rm2")
    cfg = spec.config
    N, K = RETRIEVAL_N, RETRIEVAL_TOP_K
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(12), device=dev)
    rng = np.random.default_rng(12)

    def query(cand):
        return {"dense": torch.from_numpy(rng.standard_normal(
                    (1, cfg.n_dense)).astype(np.float32)).to(dev),
                "sparse": torch.from_numpy(np.array(
                    [[rng.integers(v) for v in cfg.vocab_sizes]],
                    np.int32)).to(dev),
                "candidates": torch.from_numpy(cand.astype(np.int32)).to(dev)}
    batch = query(rng.integers(0, cfg.vocab_sizes[0], N))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    serve = build_retrieval_serve(dlrm, cfg, statics, top_k=K)
    plain_serve = build_retrieval_serve(dlrm, cfg, statics, top_k=K,
                                        backend="torch")
    zero_counters()
    t0 = time.perf_counter()
    vals, ids = serve(params, batch)
    torch.cuda.synchronize()
    first_call_s = time.perf_counter() - t0
    launches = read_counters()
    print(f"retrieval: 1 query x {N:,} candidates at full {cfg.name} width "
          f"({cfg.total_vocab:,} x {cfg.embed_dim} bf16), top {K}; first "
          f"call {first_call_s:.3f} s; launches {launches}")
    need(launches["dot_features_query"] > 0,
         "the retrieval run launched no dot_features_query kernel")
    for name, n in launches.items():
        need(name == "dot_features_query" or n == 0,
             f"the retrieval run launched {name} {n} times")
    need(tuple(vals.shape) == (K,) and tuple(ids.shape) == (K,),
         f"retrieval top-k shapes {vals.shape} {ids.shape}")
    need(bool(torch.isfinite(vals).all()), "non-finite top-k scores")
    # the serve call's own peak: what it allocates above what it holds
    first_peak = torch.cuda.max_memory_allocated() - base_mem
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    v_again, i_again = serve(params, batch)
    torch.cuda.synchronize()
    serve_peak = torch.cuda.max_memory_allocated() - held
    need(torch.equal(v_again, vals) and torch.equal(i_again, ids),
         "a second serve call returned another top k")
    del v_again, i_again

    with torch.inference_mode():
        scores = dlrm.retrieval_scores(cfg, params, statics, batch)
        plain = dlrm.retrieval_scores(cfg, params, statics, batch,
                                      backend="torch")
    need(tuple(scores.shape) == (N,) and bool(torch.isfinite(scores).all()),
         f"retrieval scores {tuple(scores.shape)}, finite "
         f"{bool(torch.isfinite(scores).all())}")
    s_err = (scores - plain).abs().max().item()
    need(bool(close(scores, plain).all()),
         f"retrieval scores vs plain: max abs err {s_err}")
    pv, pi = top_k_lowest_first(plain, K)
    distinct = check_topk("retrieval top-k", vals, ids, plain, pv,
                          batch["candidates"])
    need(torch.equal(vals, scores[ids.long()]),
         "served top-k values != the scores at their ids")
    print(f"  scores (N,) vs plain path: max abs err {s_err}; top {K}: "
          f"{distinct} distinct candidate id(s), copies lowest index first; "
          f"values in [{vals.min().item():.6f}, {vals.max().item():.6f}]; "
          f"the serve call's own peak {serve_peak / 2**30:.3f} GiB")

    # both entries at the retrieval shape, against their plain versions
    t = dlrm._banked(params, statics)
    offs = statics["field_offsets"]
    with torch.inference_mode():
        x = dlrm.mlp_apply(params["bot"], batch["dense"])
        user_rows = batch["sparse"][:, 1:] + offs[None, 1:]
        cand_rows = batch["candidates"] + offs[0]
        eu, ec = banked_gather(t, user_rows), banked_gather(t, cand_rows)
        xq, uq, cq = x[0], eu[0].float(), ec.float()
        U = uq.shape[0]
        F = U + 2
        P = F * (F - 1) // 2
        got_q = dot_features_query(xq, uq, cq)
        want_q = dot_features_query_plain(xq, uq, cq)
        torch.cuda.synchronize()
        q_err = (got_q - want_q).abs().max().item()
        need(torch.allclose(got_q, want_q, **DOT_TOL),
             f"dot_features_query at {(N, F, cfg.embed_dim)}: max abs err "
             f"{q_err}")
        const = query_columns(F, dev)
        need(torch.equal(got_q[:, const], got_q[:1, const].expand(N, -1)),
             f"dot_features_query: a query-only column differs across rows")
        need(torch.equal(got_q[:, P:], xq.expand(N, -1)),
             "dot_features_query: x columns != x")
        print(f"  dot_features_query at x {tuple(xq.shape)}, user "
              f"{tuple(uq.shape)}, cand {tuple(cq.shape)} fp32 vs plain: "
              f"max abs err {q_err} (atol = rtol = 1e-5); its "
              f"{const.numel()} query-only columns equal across all {N:,} "
              f"rows")
        del want_q
        emb = torch.cat([eu.float().expand(N, -1, -1), ec.float()[:, None]],
                        dim=1)
        xn = x.expand(N, -1).contiguous()
        got, want = dot_features(xn, emb), dot_features_plain(xn, emb)
        torch.cuda.synchronize()
        d_err = (got - want).abs().max().item()
        need(torch.allclose(got, want, **DOT_TOL),
             f"dot_features at {tuple(emb.shape)}: max abs err {d_err}")
        need(torch.equal(got[:, P:], xn), "dot_features: x columns != x")
        need(torch.allclose(got_q, got, **DOT_TOL),
             "the query entry disagrees with the batch entry")
        print(f"  dot_features at x {tuple(xn.shape)}, emb "
              f"{tuple(emb.shape)} fp32 vs plain: max abs err {d_err} "
              f"(atol = rtol = 1e-5)")
        del want, got_q

        # a tie-free draw: every field-0 id once, in a seeded permutation
        b2 = query(rng.permutation(cfg.vocab_sizes[0]))
        v2, i2 = serve(params, b2)
        s2 = dlrm.retrieval_scores(cfg, params, statics, b2,
                                   backend="torch")
        p2v, p2i = top_k_lowest_first(s2, K)
        check_topk("tie-free top-k", v2, i2, s2, p2v, b2["candidates"])
        gap = torch.diff(p2v).abs() > SCORE_TOL["atol"] \
            + SCORE_TOL["rtol"] * p2v[1:].abs()
        clear = torch.ones(K, dtype=torch.bool, device=dev)
        clear[1:] &= gap
        clear[:-1] &= gap
        need(torch.equal(i2[clear], p2i[clear]),
             "tie-free top-k: ids differ from the plain top-k where the "
             "plain scores are apart")
        print(f"  tie-free draw (N = {cfg.vocab_sizes[0]}): ids equal the "
              f"plain top-k at {int(clear.sum())} of {K} ranks clear of "
              f"their neighbours, the others within tolerance")

        # the stages, CUDA events (each ~GB of traffic: no L2 flush needed)
        iu, ju = torch.triu_indices(F, F, offset=1, device=dev)
        z = torch.cat([xn[:, None], emb], dim=1)
        lib = lambda: torch.bmm(z, z.mT)[:, iu, ju]  # noqa: E731
        need(torch.allclose(lib(), got[:, :P], **DOT_TOL),
             "bmm library call disagrees with the kernel at the retrieval "
             "shape")
        feat = got
        stages = {
            "serve_call": lambda: serve(params, batch),
            "plain_serve_call": lambda: plain_serve(params, batch),
            "gathers": lambda: (banked_gather(t, user_rows),
                                banked_gather(t, cand_rows)),
            "dot_features_query": lambda: dot_features_query(xq, uq, cq),
            "dot_features_query_plain":
                lambda: dot_features_query_plain(xq, uq, cq),
            "build_inputs": lambda: (
                torch.cat([eu.float().expand(N, -1, -1),
                           ec.float()[:, None]], dim=1),
                x.expand(N, -1).contiguous()),
            "dot_features": lambda: dot_features(xn, emb),
            "dot_features_plain": lambda: dot_features_plain(xn, emb),
            "bmm_triangle": lib,
            "top_mlp": lambda: dlrm.mlp_apply(params["top"], feat),
            "top_k": lambda: top_k_lowest_first(scores, K),
        }
        ms = {k: time_ms(fn, reps=10, warmup=2) for k, fn in stages.items()}
    bound_ms, bound_by = dot_features_bound_ms(xn, emb)
    q_bound_ms, q_bound_by = dot_query_bound_ms(N, U, cfg.embed_dim, 4)
    peak = max(first_peak, torch.cuda.max_memory_allocated() - base_mem)
    print("retrieval step breakdown (device ms, CUDA events): "
          + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
          + " (build_inputs and dot_features: the batch entry's route, off "
            "the serve path)")
    print(f"  dot_features_query at the retrieval shape: kernel "
          f"{ms['dot_features_query']:.4f} ms, plain "
          f"{ms['dot_features_query_plain']:.4f} ms, bound "
          f"{q_bound_ms:.4f} ms ({q_bound_by}); dot_features at "
          f"{tuple(z.shape)}: kernel {ms['dot_features']:.4f} ms, plain "
          f"{ms['dot_features_plain']:.4f} ms, bmm + triangle "
          f"{ms['bmm_triangle']:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}); the serve call's own peak "
          f"{serve_peak / 2**30:.3f} GiB; the phase's peak "
          f"{peak / 2**30:.3f} GiB above the {base_mem / 2**30:.3f} GiB held "
          f"before it")
    report["dot_features"]["retrieval"] = dict(
        shape=[N, F, cfg.embed_dim], ms=ms["dot_features"],
        plain_ms=ms["dot_features_plain"], library_ms=ms["bmm_triangle"],
        bound_ms=bound_ms, bound_by=bound_by, max_abs_err=d_err)
    report["dot_features_query"].update(
        ms=ms["dot_features_query"], plain_ms=ms["dot_features_query_plain"],
        bound_ms=q_bound_ms, bound_by=q_bound_by,
        max_abs_err=max(q_err, report["dot_features_query"].get(
            "max_abs_err", 0.0)),
        retrieval=dict(shape=[N, U, cfg.embed_dim],
                       bmm_triangle_ms=ms["bmm_triangle"],
                       max_abs_err=q_err))
    del z, emb, xn, got, feat, scores, plain, stages, xq, uq, cq
    del params, statics
    torch.cuda.empty_cache()
    reduced = check_retrieval_reduced(dev, spec)
    wide = check_dot_wide(dev, report)
    return dict(n=N, top_k=K, setup_s=setup_s, first_call_s=first_call_s,
                score_max_abs_err=s_err, dot_max_abs_err=d_err,
                query_max_abs_err=q_err, distinct_ids=distinct,
                top_values=vals.tolist(), top_ids=ids.tolist(), stage_ms=ms,
                bound_ms=bound_ms, query_bound_ms=q_bound_ms,
                serve_peak_bytes=serve_peak, peak_bytes=peak,
                reduced=reduced, wide=wide), launches


def check_dot_wide(dev, report):
    """The batch entry at dlrm-rm2's 27 fields (tiles of rows, P = 351)
    at the serve cells' batches 512 and 262,144, fp32 and bf16, against
    its plain version (fp32 within DOT_TOL, bf16 each dot a rounding of
    the fp32 dot), x columns bit for bit; timed beside its plain version,
    ``bmm`` + triangle and its bound."""
    import torch
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_features_plain,
                                                     dot_interaction_plain)
    g = torch.Generator(device=dev).manual_seed(27)
    out = {}
    for B in (512, 262_144):
        for dtype in (torch.float32, torch.bfloat16):
            z = torch.randn((B, 27, 64), generator=g, device=dev).to(dtype)
            x, emb = z[:, 0].contiguous(), z[:, 1:].contiguous()
            P = 27 * 26 // 2
            got, want = dot_features(x, emb), dot_features_plain(x, emb)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            what = f"dot_features ({B}, 27, 64) {str(dtype)[6:]}"
            if dtype == torch.float32:
                need(torch.allclose(got, want, **DOT_TOL),
                     f"{what}: max abs err {err}")
            else:
                dot32 = dot_interaction_plain(z.float())
                need(bf16_rounds(got[:, :P], dot32)
                     and bf16_rounds(want[:, :P], dot32),
                     f"{what}: not a rounding of the fp32 dot (max abs err "
                     f"to the plain version {err})")
                del dot32
            need(torch.equal(got[:, P:], x), f"{what}: x columns != x")
            iu, ju = torch.triu_indices(27, 27, offset=1, device=dev)
            reps = 20 if B > 512 else 50
            ms = time_ms(lambda: dot_features(x, emb), reps=reps)
            plain_ms = time_ms(lambda: dot_features_plain(x, emb), reps=reps)
            lib_ms = time_ms(lambda: torch.bmm(z, z.mT)[:, iu, ju],
                             reps=reps)
            bound_ms, bound_by = dot_features_bound_ms(x, emb)
            print(f"  {what}: max abs err {err}; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, bmm + triangle {lib_ms:.4f} ms, "
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            out[f"{B}_{str(dtype)[6:]}"] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=bound_ms, bound_by=bound_by, max_abs_err=err)
            del z, x, emb, got, want
    report["dot_features"]["wide"] = out
    torch.cuda.empty_cache()
    return out


def check_retrieval_reduced(dev, spec):
    """Reduced dlrm-rm2 retrieval (N = 64 over 100 rows, top 16) on the
    card against the CPU on the same weights: scores and top-k values
    within SCORE_TOL, every card id's CPU score the CPU value at its
    rank."""
    import numpy as np
    import torch
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_retrieval_serve
    red = spec.reduced
    params, statics = dlrm.init_params(red, torch.Generator().manual_seed(8),
                                       device="cpu")
    rng = np.random.default_rng(8)
    b = {"dense": torch.from_numpy(rng.standard_normal(
            (1, red.n_dense)).astype(np.float32)),
         "sparse": torch.from_numpy(np.array(
             [[rng.integers(v) for v in red.vocab_sizes]], np.int32)),
         "candidates": torch.from_numpy(rng.integers(
             0, red.vocab_sizes[0], 64).astype(np.int32))}
    cpu_s = dlrm.retrieval_scores(red, params, statics, b)
    cv, ci = build_retrieval_serve(dlrm, red, statics, top_k=16)(params, b)
    pd, sd, bd = to_dev(params, dev), to_dev(statics, dev), to_dev(b, dev)
    card_s = dlrm.retrieval_scores(red, pd, sd, bd).cpu()
    gv, gi = build_retrieval_serve(dlrm, red, sd, top_k=16)(pd, bd)
    err = (card_s - cpu_s).abs().max().item()
    need(bool(close(card_s, cpu_s).all()),
         f"reduced retrieval, card vs CPU: max abs err {err}")
    check_topk("reduced retrieval top-k, card vs CPU", gv.cpu(), gi.cpu(),
               cpu_s, cv, b["candidates"])
    print(f"reduced retrieval on the card vs the CPU, same weights: scores "
          f"max abs err {err}; top 16 within tolerance")
    return dict(max_abs_err=err, ids_equal=bool(torch.equal(gi.cpu(), ci)))


def compress_train_phase(dev, spec, plan):
    """Phase 13: training with int8 gradient compression and a restart at
    full ``updlrm-paper`` width on phase 2's plan. ``launch.train.run``
    with ``compress_grads=True``, ``ckpt_every=2``, batch 64, under
    ``build/``: run A, 6 steps straight through, with every launch counter
    set to 0 just before and read just after (the bag kernel, the
    interaction's fused entry and the scatter must have run); run B in a
    fresh directory, 4 steps, then a second call for 6 that must restore
    step 4. B's final params, optimizer state and error-feedback state
    must equal A's bit for bit; the manifest must be the reference's
    format; one more step's compressed gradient and error must equal
    ``compress_roundtrip`` of its clipped gradient on the CPU, bit for bit.
    Records the seconds of each save and of the restore, the bytes on
    disk, and the step's device ms with and without compression."""
    import shutil
    import torch
    from repro_torch.checkpoint.ckpt import _flatten
    from repro_torch.launch import train as ltrain
    from repro_torch.train import compress as C
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    cfg = spec.config
    base = OUT / "ckpt_smoke"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    disk = shutil.disk_usage(base)
    print(f"compressed train: checkpoints under {base} ({disk.free / 2**30:.1f}"
          f" GiB free)")
    kw = dict(batch=TRAIN_BATCH, device=dev, plan=plan, compress_grads=True,
              ckpt_every=2)
    try:
        zero_counters()
        res_a = ltrain.run(spec, cfg, steps=6, ckpt_dir=str(base / "a"), **kw)
        launches = read_counters()
        print(f"  run A: 6 steps, launches {launches}; losses "
              + ", ".join(f"{x:.6f}" for x in res_a.losses))
        for name in ("banked_bag", "ct_scatter_bag", "dot_features"):
            need(launches[name] > 0, f"compressed train launched no {name}")
        for name, n in launches.items():
            need(name in ("banked_bag", "ct_scatter_bag", "dot_features")
                 or n == 0, f"compressed train launched {name} {n} times")
        final = base / "a" / "step_6"
        man = json.loads((final / "tree.json").read_text())
        paths = {m["path"]: m for m in man["leaves"]}
        want = {".params['emb_packed']": "float32",
                ".err_state['emb_packed']": "float32",
                ".opt_state['true'][0]": "float32",
                ".opt_state['false']['t']": "int32", ".step": "int32"}
        need(man["step"] == 6 and all(
            p in paths and paths[p]["dtype"] == d for p, d in want.items()),
            f"manifest: step {man['step']}, leaves {sorted(paths)[:6]}...")
        need([m["index"] for m in man["leaves"]]
             == list(range(len(man["leaves"]))) and all(
                 (final / f"leaf_{i}.npy").exists()
                 for i in range(len(man["leaves"]))),
             "manifest indices or leaf files")
        need(paths[".err_state['emb_packed']"]["shape"]
             == list(res_a.state.params["emb_packed"].shape),
             "manifest: the table's error buffer is not table-shaped")
        on_disk = sum(f.stat().st_size for f in final.iterdir())
        by_leaf = {p: (final / f"leaf_{m['index']}.npy").stat().st_size
                   for p, m in paths.items()}
        table, err, adagrad = (by_leaf[p] for p in list(want)[:3])
        print(f"  manifest: {len(paths)} leaves in the reference's format; "
              f"step_6 holds {on_disk:,} bytes (table {table:,}, its error "
              f"buffer {err:,}, Adagrad {adagrad:,})")
        shutil.rmtree(base / "a")

        res_b1 = ltrain.run(spec, cfg, steps=4, ckpt_dir=str(base / "b"),
                            **kw)
        b1_saves = res_b1.checkpoints["saves"]
        del res_b1
        torch.cuda.empty_cache()
        res_b = ltrain.run(spec, cfg, steps=6, ckpt_dir=str(base / "b"), **kw)
        need(res_b.start_step == 4, f"run B restored step {res_b.start_step}"
                                    f", not 4")
        need(res_b.losses == res_a.losses[4:],
             f"run B losses {res_b.losses} != run A's {res_a.losses[4:]}")
        diff = [p for (p, x), (_, y) in zip(_flatten(res_a.state),
                                            _flatten(res_b.state))
                if not torch.equal(x, y)]
        need(len(_flatten(res_a.state)) == len(_flatten(res_b.state))
             and not diff, f"run B != run A at {diff}")
        restore_s = res_b.checkpoints["restore_s"]
        print(f"  run B: 4 steps, then restored step 4 in "
              f"{restore_s:.3f} s and ran 2: params, "
              f"optimizer and error state equal run A's bit for bit "
              f"({len(_flatten(res_a.state))} leaves); losses 4-5 equal")
        saves = res_a.checkpoints["saves"] + b1_saves \
            + res_b.checkpoints["saves"]
        print("  saves (step: host copy s, write s, bytes): " + "; ".join(
            f"{r['step']}: {r['host_s']:.3f}, {r['write_s']:.3f}, "
            f"{r['nbytes']:,}" for r in saves))

        # one more step: its compressed gradient against the CPU's
        state, batch = res_b.state, res_b.last_batch
        del res_b
        loss_fn, lkw = ltrain.build_loss(spec, cfg, res_a.statics)
        opt = default_optimizer()
        caught = {}
        real = C.compress_roundtrip

        def spy(grads, err, dist=None):
            g2, e2 = real(grads, err, dist)
            caught["in"] = [t.cpu() for t in (grads["emb_packed"],
                                              err["emb_packed"])]
            caught["out"] = [t.cpu() for t in (g2["emb_packed"],
                                               e2["emb_packed"])]
            caught["dense"] = list(zip(*(
                [x.cpu() for x in O.tree_leaves({**t, "emb_packed": None})]
                for t in (grads, err, g2, e2))))
            return g2, e2
        step_c = build_train_step(loss_fn, opt, compress_grads=True,
                                  loss_kwargs=lkw)
        C.compress_roundtrip = spy          # the step calls it by module
        try:
            nxt, _ = step_c(state, batch)
        finally:
            C.compress_roundtrip = real
        need(torch.equal(nxt.err_state["emb_packed"].cpu(),
                         caught["out"][1]), "the step's error state is not "
                                            "the compression's output")
        del nxt
        t0 = time.perf_counter()
        g_cpu, e_cpu = C._one(*caught["in"])
        cpu_s = time.perf_counter() - t0
        need(torch.equal(g_cpu, caught["out"][0])
             and torch.equal(e_cpu, caught["out"][1]),
             "compressed table gradient on the card != compress_roundtrip on "
             "the CPU")
        for g, e, g2, e2 in caught["dense"]:
            cg, ce = C._one(g, e)
            need(torch.equal(cg, g2) and torch.equal(ce, e2),
                 "a dense leaf's compression on the card != the CPU's")
        nz = int((caught["out"][0] != 0).any(1).sum())
        print(f"  one more step: the compressed gradient and error of all "
              f"{1 + len(caught['dense'])} leaves equal compress_roundtrip "
              f"on the CPU bit for bit (the table's: {nz:,} of "
              f"{caught['out'][0].shape[0]:,} rows non-zero; CPU "
              f"{cpu_s:.2f} s)")
        del caught, g_cpu, e_cpu

        # the step on the device, with and without compression
        step_p = build_train_step(loss_fn, opt, loss_kwargs=lkw)
        plain_state = TrainState(params=state.params,
                                 opt_state=state.opt_state, step=state.step)
        step_ms = {
            "compressed": time_ms(lambda: step_c(state, batch), reps=5,
                                  warmup=1),
            "uncompressed": time_ms(lambda: step_p(plain_state, batch),
                                    reps=5, warmup=1),
            "compress_roundtrip": time_ms(
                lambda: C._one(state.params["emb_packed"],
                               state.err_state["emb_packed"]),
                reps=5, warmup=1)}
        print("  train step (device ms, CUDA events): " + ", ".join(
            f"{k} {v:.4f}" for k, v in step_ms.items()))
        return dict(losses_a=res_a.losses, saves=saves,
                    restore_s=restore_s, step_ms=step_ms, bytes_on_disk=on_disk,
                    bytes_by_leaf=by_leaf, table_rows_nonzero=nz,
                    cpu_compress_s=cpu_s), launches
    finally:
        shutil.rmtree(base, ignore_errors=True)


def refuses(fn, what: str, counter) -> str:
    """``fn()`` must raise ValueError before any kernel launch (the
    counter ``(wrapper, attr)`` unchanged); the message."""
    obj, attr = counter
    before = getattr(obj, attr)
    try:
        fn()
    except ValueError as e:
        need(getattr(obj, attr) == before, f"{what}: launched before raising")
        return str(e)
    fail(f"{what}: did not raise")


def tuned_phase(dev, spec, live):
    """Phase 14: the autotuned dispatch. (1) ``tune.autotune.tune`` over
    the port's signature suite on the card (written under ``build/``), the
    CLI's self-check, and every fitting candidate of every case held bit
    for bit against the case's plain version; (2) phase 3's full-width
    table and last batch of 64 requests: the main path's signature timed at
    its 8 candidates, a cache holding the winner installed, the batch
    served through ``build_recsys_serve(..., backend='tuned')`` with every
    launch counter set to 0 just before and read just after (a cache hit,
    the bag kernel and the interaction's fused entry launched), its scores
    equal to the default path's bit for bit, both device steps timed and
    the host cost of a lookup; (3) the refusals: a decision that does not
    fit, and a 'torch' decision on CUDA tensors, raise before any
    launch."""
    import torch
    from repro_torch.core.embedding import _lookup_backend, banked_embedding_bag
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.launch.tune import self_check
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    from repro_torch.tune import autotune as ta
    from repro_torch.tune.dispatch import DispatchCache, set_cache, signature

    def log(msg):
        print(f"  {msg}", flush=True)

    # 1. the suite
    t0 = time.perf_counter()
    cases = ta.default_signature_suite(device=dev)
    with torch.inference_mode():
        suite = ta.tune(cases, device=dev, log=log)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "tune_dispatch_suite.json"
    suite.save(str(path))
    bad = self_check(suite, str(path))
    need(not bad, f"tune self-check: decisions diverge {bad}")
    n_bits = 0
    with torch.inference_mode():
        for case in cases:
            want = case.plain()
            for backend, b, s in ta.case_candidates(case, False, dev):
                got = case.make(backend, b, s)()
                need(got.dtype == want.dtype and torch.equal(got, want),
                     f"{case.sig.key()} at ({b}, {s}): kernel != plain")
                n_bits += 1
        set_cache(suite)
        try:
            for case in cases:
                need(torch.equal(case.make("tuned", None, None)(),
                                 case.plain()),
                     f"{case.sig.key()} tuned != plain")
            need(suite.hits == len(cases) and suite.misses == 0,
                 f"suite through 'tuned': {suite.hits} hits, "
                 f"{suite.misses} misses")
        finally:
            set_cache(None)
    rows = []
    print(f"tune suite ({len(cases)} signatures, {n_bits} candidate launches "
          f"bit for bit against the plain versions; µs, median of "
          f"{suite.meta['repeats']} launches, L2 warm: every suite table "
          f"fits the 50 MB L2) [{suite.meta['arch']}]:")
    for key, e in sorted(suite.entries.items()):
        rows.append(dict(key=key, default=[e["default_tile_b"],
                                           e["default_n_slots"]],
                         default_us=e["default_us"],
                         tuned=[e["tile_b"], e["n_slots"]],
                         tuned_us=e["best_us"], torch_us=e["torch_us"]))
        print(f"  {key}: default ({e['default_tile_b']}, "
              f"{e['default_n_slots']}) {e['default_us']:.3f} -> tuned "
              f"({e['tile_b']}, {e['n_slots']}) {e['best_us']:.3f}; plain "
              f"{e['torch_us']:.3f}")
    suite_s = time.perf_counter() - t0

    # 2. the main path: phase 3's live table and last batch
    params, statics, batch = live["params"], live["statics"], live["batch"]
    cfg = spec.config
    t = dlrm._banked(params, statics)
    sparse, fo = batch["sparse"], statics["field_offsets"]
    B, F, L = sparse.shape
    sig = signature("plain", vocab=t.vocab, dim=t.dim, batch=B * F,
                    bag_len=L, n_fields=len(fo))
    need(sig.key() == "plain|v18885200|d32|b512|l256|f8|k1|tnone|bwauto",
         f"main-path signature {sig.key()}")

    def make(backend, b, s):
        return lambda: banked_embedding_bag(t, sparse, backend=backend,
                                            field_offsets=fo, tile_b=b,
                                            n_slots=s)
    case = ta.TuneCase(
        sig=sig, make=make, plain=make("torch", None, None),
        geometry=lambda b, s: kbag.tuned_geometry(
            B * F, L, t.dim, t.packed.element_size(), bags_per_block=b,
            stages=s))
    need(case.rule() == (1, 8), f"main-path rule {case.rule()}")
    cand = ta.case_candidates(case, False, dev)
    need(len(cand) == 8, f"main-path candidates {cand}")
    with torch.inference_mode():
        want = case.plain()
        for backend, b, s in cand:
            need(torch.equal(make(backend, b, s)(), want),
                 f"main path at ({b}, {s}): kernel != plain")
        main = ta.tune([case], device=dev, log=log)
    e = main.entries[sig.key()]
    dec = main.decisions()[sig.key()]
    lookups = DispatchCache(entries={sig.key(): e}, meta=main.meta)
    set_cache(lookups)
    try:
        serve_t = build_recsys_serve(dlrm, cfg, statics, backend="tuned")
        zero_counters()
        scores_t = serve_t(params, batch)
        torch.cuda.synchronize()
        launches = read_counters()
        hits = lookups.hits
        scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        serve_d = build_recsys_serve(dlrm, cfg, statics)
        scores_d = serve_d(params, batch)
        need(hits >= 1, f"the tuned serve call made {hits} cache hits")
        need(launches["banked_bag"] >= 1 and launches["dot_features"] >= 1,
             f"tuned serve launches {launches}")
        need(torch.equal(scores_t, scores_d),
             "tuned scores != the default path's")
        step_ms = {}
        for k, fn in (("default", lambda: serve_d(params, batch)),
                      ("tuned", lambda: serve_t(params, batch)),
                      ("tuned_2", lambda: serve_t(params, batch)),
                      ("default_2", lambda: serve_d(params, batch))):
            step_ms[k] = time_ms(fn, flush=scratch.zero_)
        # the host side: each serve call's enqueue (200 of each, in
        # alternating turns; "auto" is the default path again, the spread
        # of two equal paths), and the backend's resolution alone
        serve_a = build_recsys_serve(dlrm, cfg, statics, backend="auto")
        host_us = {"default": [], "tuned": [], "auto": []}
        turns = (("default", serve_d), ("tuned", serve_t), ("auto", serve_a))
        for i in range(200):
            for k, fn in turns[::1 if i % 2 else -1]:
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                fn(params, batch)
                host_us[k].append((time.perf_counter() - h0) * 1e6)
        torch.cuda.synchronize()
        host_us = {k: statistics.median(v) for k, v in host_us.items()}
        shape = dict(vocab=t.vocab, dim=t.dim, batch=B * F, bag_len=L,
                     n_fields=F, bwd_backend="auto")
        n = 10_000
        for k, backend in (("resolve_auto", "auto"),
                           ("resolve_tuned", "tuned"), ("resolve_auto_2",
                                                        "auto")):
            h0 = time.perf_counter()
            for _ in range(n):
                _lookup_backend(backend, dev, None, None, "plain", **shape)
            host_us[k] = (time.perf_counter() - h0) / n * 1e6
        del scratch
    finally:
        set_cache(None)
    print("  main-path candidates (us): " + ", ".join(
        f"{k} {v:.3f}" for k, v in e["candidates_us"].items()))
    print(f"main path {sig.key()}: default {case.rule()} "
          f"{e['default_us']:.3f} us "
          f"-> tuned ({dec.tile_b}, {dec.n_slots}) {e['best_us']:.3f} us "
          f"(bag kernel alone, L2 warm); 64 requests through "
          f"backend='tuned': {hits} hit(s), scores equal the default path's "
          f"bit for bit, launches {launches}")
    print("  serve step (device ms, L2 flushed): "
          + ", ".join(f"{k} {v:.4f}" for k, v in step_ms.items())
          + "; host us (a serve call's enqueue, median of 200; the "
          "backend's resolution, mean of 10,000): "
          + ", ".join(f"{k} {v:.2f}" for k, v in host_us.items()))

    # 3. the refusals
    big = next(c for c in cases if c.sig.dim == 128)
    nofit = DispatchCache()
    nofit.record(big.sig, backend="cuda", tile_b=2, n_slots=8)
    torch_dec = DispatchCache()
    torch_dec.record(sig, backend="torch", tile_b=1, n_slots=1)
    tiered = next(c for c in cases if c.sig.path == "tiered")
    tiered_dec = DispatchCache()
    tiered_dec.record(tiered.sig, backend="cuda", tile_b=2, n_slots=4)
    msgs = {}
    with torch.inference_mode():
        msgs["direct"] = refuses(big.make("cuda", 2, 8),
                                 "2 x 8 stages at D = 128 fp32",
                                 (kbag.banked_bag, "launches"))
        for name, c, fn, ctr in (
                ("nofit", nofit, big.make("tuned", None, None),
                 (kbag.banked_bag, "launches")),
                ("torch", torch_dec, make("tuned", None, None),
                 (kbag.banked_bag, "launches")),
                ("tiered", tiered_dec, tiered.make("tuned", None, None),
                 (kbag.tiered_bag, "launches"))):
            set_cache(c)
            try:
                msgs[name] = refuses(fn, f"'tuned' {name} decision", ctr)
                need(c.hits == 1, f"{name}: {c.hits} hits")
            finally:
                set_cache(None)
    need(sig.key() in msgs["torch"], f"the 'torch' refusal names no "
         f"signature: {msgs['torch']}")
    for k, v in msgs.items():
        print(f"  refused ({k}): {v}")
    return dict(suite=rows, suite_meta=suite.meta, suite_s=suite_s,
                bit_checked=n_bits, main=dict(key=sig.key(), entry=e,
                                              hits=hits, step_ms=step_ms,
                                              host_us=host_us),
                refusals=msgs), launches


# ---------------------------------------------------------------------------
# phase 15: the bank axis (ranks of one torch.distributed world)
# ---------------------------------------------------------------------------

BANK_REQUESTS, BANK_TRAIN_STEPS, BANK_DP_STEPS = 256, 4, 15
BANK_SEED = 15
TRAIN_TOL = dict(rtol=1e-4, atol=1e-6)   # DP vs single-device training
# the dense params after 4 Adam steps (lr 1e-3): an element whose gradient
# nearly cancels has its update m/sqrt(v) move with the fp32 reordering of
# the dp mean (two half-batch means against one), so the absolute term is
# 5 % of one step's largest move (2 of 313,633 elements needed it on an
# H100: 0.0641178 against 0.0641367)
DENSE_TOL = dict(rtol=1e-4, atol=5e-5)


def bank_plans(pop, F, n_banks=4, moved=0.01):
    """Phase 15's plans: the §3.2 plan of phase 2's popularity over the
    F-field super-table with a +-50 % per-row jitter (seeded: tied copies
    of an item would all land on the bank of their field, and no bag would
    span banks), and a drifted plan that swaps the homes (bank and slot) of
    the ``moved / 2`` hottest rows of each bank, under the same
    popularity rotated by a third of a field, with as many of the next
    bank's coldest rows: a valid replan at the same capacity that moves
    ``moved`` of the rows across banks."""
    import numpy as np
    from repro_torch.core.partitioning import (PartitionPlan,
                                               non_uniform_partition)
    V0 = pop.shape[0]
    jitter = np.random.default_rng(BANK_SEED).uniform(0.5, 1.5, V0 * F)
    plan = non_uniform_partition(np.tile(pop, F) * jitter, n_banks,
                                 batch=BAG_TILE)
    hot = np.tile(np.roll(pop, V0 // 3), F) * jitter
    bank, slot = plan.bank_of_row.copy(), plan.slot_of_row.copy()
    k = int(moved / 2 * V0 * F / n_banks)
    for b in range(n_banks):
        nb = (b + 1) % n_banks
        rows_b = np.flatnonzero(plan.bank_of_row == b)
        rows_n = np.flatnonzero(plan.bank_of_row == nb)
        give = rows_b[np.argsort(-hot[rows_b], kind="stable")[:k]]
        take = rows_n[np.argsort(hot[rows_n], kind="stable")[:k]]
        bank[give], bank[take] = nb, b
        slot[give], slot[take] = plan.slot_of_row[take], \
            plan.slot_of_row[give]
    drift = PartitionPlan(n_banks=n_banks, bank_of_row=bank,
                          slot_of_row=slot, rows_per_bank=plan.rows_per_bank,
                          load_per_bank=plan.load_per_bank)
    return plan, drift


def _bank_plans_job(pop, F, path: str) -> None:
    """``bank_plans`` in a process of its own, written to ``path``."""
    import numpy as np
    plan, drift = bank_plans(pop, F)
    np.savez(path, bank=plan.bank_of_row, slot=plan.slot_of_row,
             rows=plan.rows_per_bank, load=plan.load_per_bank,
             d_bank=drift.bank_of_row, d_slot=drift.slot_of_row)


def start_bank_plans(pop, F):
    """Start phase 15's plans in a spawned process (started in phase 2, so
    the exact greedy's ~25 s over 18.9 M rows runs beside phases 2-14;
    daemonic, so it ends with the script)."""
    import multiprocessing as mp
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "bank_plans.npz"
    path.unlink(missing_ok=True)
    proc = mp.get_context("spawn").Process(
        target=_bank_plans_job, args=(pop, F, str(path)), daemon=True)
    proc.start()
    return proc, path


def bank_plans_result(job, timeout: float = 600.0):
    """The plans of ``start_bank_plans``: (plan, drift)."""
    import numpy as np
    from repro_torch.core.partitioning import PartitionPlan
    proc, path = job
    proc.join(timeout)
    if proc.is_alive():
        proc.kill()
    need(proc.exitcode == 0 and path.exists(),
         f"phase 15's plan process exited {proc.exitcode}")
    z = np.load(path)
    plans = tuple(PartitionPlan(
        n_banks=4, bank_of_row=z[f"{p}bank"], slot_of_row=z[f"{p}slot"],
        rows_per_bank=z["rows"], load_per_bank=z["load"])
        for p in ("", "d_"))
    path.unlink()
    return plans


def worst_line(got, want, tol) -> str:
    """The elements of ``got`` outside ``tol`` of ``want``, and the worst."""
    import numpy as np
    err = np.abs(got - want)
    bad = err > tol["atol"] + tol["rtol"] * np.abs(want)
    i = int(np.argmax(err))
    return (f"{int(bad.sum())} of {err.size} outside, worst at flat {i}: "
            f"{float(got.flat[i])!r} vs {float(want.flat[i])!r} "
            f"(abs {err.flat[i]:.3g})")


def _plan_of(bank, slot, n_banks):
    import numpy as np
    from repro_torch.core.partitioning import PartitionPlan
    bank = np.asarray(bank, np.int32)
    return PartitionPlan(
        n_banks=n_banks, bank_of_row=bank,
        slot_of_row=np.asarray(slot, np.int32),
        rows_per_bank=np.bincount(bank, minlength=n_banks).astype(np.int32),
        load_per_bank=np.zeros(n_banks))


def _sync_ms(t0):
    import torch
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _bank_serve(inp, d14, dev):
    """(a) serve 256 requests at batch 64 on the 1 x 4 grid through
    ``build_recsys_serve(..., dist)``, every launch counter set to 0 just
    before and read just after; one bank's partials against the whole
    table's ``banked_bag`` with my = bank, bit for bit; the bank sum and the
    step timed. (d) the degraded lookup with bank 3 dead; (c) the compact
    migration to a drifted plan against the single-device migration, bit
    for bit. Returns the whole table's tensors it freed."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import embedding as TE
    from repro_torch.dist.sharding import recsys_param_shardings
    from repro_torch.kernels.embedding_bag import banked_bag, banked_bag_plain
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import (
        build_recsys_serve, build_recsys_serve_degraded_adaptive)
    from repro_torch.workload.migrate import migrate_table
    cfg = get_arch("updlrm-paper").config
    r, out = d14.bank_rank, {}
    plan4 = _plan_of(inp["p4_bank"], inp["p4_slot"], 4)
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(BANK_SEED), plan=plan4,
        device=dev)
    whole = params["emb_packed"]
    rpb = statics["rows_per_bank"]
    local = recsys_param_shardings(d14, params)
    del params
    serve = build_recsys_serve(dlrm, cfg, statics, d14)
    batches = [{"dense": torch.from_numpy(np.array(inp["s_dense"][i])).to(dev),
                "sparse": torch.from_numpy(np.array(inp["s_sparse"][i]))
                .to(dev)} for i in range(inp["s_sparse"].shape[0])]
    zero_counters()
    step_ms, scores = [], []
    for b in batches:
        t0 = time.perf_counter()
        scores.append(serve(local, b))
        step_ms.append(_sync_ms(t0))
    out["serve_launches"] = np.array(list(read_counters().values()))
    out["scores"] = torch.cat(scores).cpu().numpy()
    out["serve_step_ms"] = np.array(step_ms)
    rep = []
    for _ in range(10):
        t0 = time.perf_counter()
        serve(local, batches[0])
        rep.append(_sync_ms(t0))
    out["serve_rep_ms"] = np.array(rep)
    part = torch.zeros((64 * cfg.n_sparse, cfg.embed_dim), device=dev)
    d14.psum(part, "bank")
    psum_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        d14.psum(part, "bank")
        psum_ms.append(_sync_ms(t0))
    out["psum_ms"] = np.array(psum_ms)
    off, t_loc = statics["field_offsets"], dlrm._banked(local, statics)
    flat = batches[0]["sparse"].reshape(-1, cfg.multi_hot).contiguous()
    got = banked_bag(t_loc.packed, statics["remap_bank"],
                     statics["remap_slot"], off, r, flat)
    want = banked_bag(whole, statics["remap_bank"], statics["remap_flat"],
                      off, r, flat)
    plain = banked_bag_plain(t_loc.packed, statics["remap_bank"],
                             statics["remap_slot"], off, r, flat)
    out["partials_equal"] = np.array(torch.equal(got, want)
                                     and torch.equal(got, plain))
    out.update(_bank_other_lookups(d14, dev, t_loc, statics,
                                   batches[0]["sparse"], cfg))

    # (d) bank 3 dead: the sharded degraded step, then its bags
    live = torch.ones(4, dtype=torch.bool, device=dev)
    live[3] = False
    deg = build_recsys_serve_degraded_adaptive(dlrm, cfg, statics, d14)
    zero_counters()
    deg_scores, deg_counts = deg(local, statics["remap_bank"],
                                 statics["remap_slot"], live, batches[0])
    torch.cuda.synchronize()
    out["degraded_launches"] = np.array(list(read_counters().values()))
    out["degraded_counts"] = deg_counts.cpu().numpy()
    bags = TE.banked_embedding_bag(t_loc, batches[0]["sparse"], d14,
                                   field_offsets=off, bank_live=live)
    t_whole = dlrm._banked({"emb_packed": whole}, statics)
    single = TE.banked_embedding_bag(t_whole, batches[0]["sparse"],
                                     field_offsets=off, bank_live=live)
    rows = TE._traffic_rows(batches[0]["sparse"], off).reshape(
        batches[0]["sparse"].shape)
    out["degraded_err"] = np.array((bags - single).abs().max().item())
    out["degraded_reads"] = np.array(int(TE.degraded_row_counts(
        statics["remap_bank"], live, rows).sum()))
    eff = TE._effective_bank_map(statics["remap_bank"], live, 4)
    out["dead_partial_max"] = np.array(banked_bag(
        t_loc.packed, eff, statics["remap_slot"], off, r, flat)
        .abs().max().item())

    # (c) the compact migration to a drifted plan, at full width
    drift = _plan_of(inp["pd_bank"], inp["pd_slot"], 4)
    ref = migrate_table(t_whole, drift, rows_per_bank=rpb)
    mine = ref.packed[r * rpb:(r + 1) * rpb].clone()
    del ref, t_whole, whole
    torch.cuda.empty_cache()
    d14.psum(torch.zeros(1, device=dev), "bank")          # line the ranks up
    t0 = time.perf_counter()
    mig = migrate_table(t_loc, drift, d14, rows_per_bank=rpb)
    out["migrate_s"] = np.array(_sync_ms(t0) / 1e3)
    out["migrate_equal"] = np.array(torch.equal(mig.packed, mine))
    out["moved_rows"] = np.array(int((inp["p4_bank"] != inp["pd_bank"]).sum()))
    return out


BANK_CACHE_ROWS, BANK_CACHE_LEN = 1024, 4     # a bank's cache entries; Lc


def _bank_other_lookups(d14, dev, t_loc, statics, sparse, cfg):
    """The sharded cached, tiered and CSR lookups on the serve batch
    ``sparse`` (64 x 8 bags of 256) over the rank's full-width shard, each
    with every launch counter set to 0 just before and read just after;
    then each rank's partial from the kernel against the kernel's plain
    version on the same shard inputs, bit for bit, and the lookup's output
    against the bank sum of that plain partial, bit for bit.

      cached: a cache table of 4 x BANK_CACHE_ROWS entries (entry e on
              bank e % 4, slot e // 4; seeded values), BANK_CACHE_LEN
              cache ids a bag with 20 % holes, the batch's rows residual;
      tiered: the shard quantized at the rows the batch reads on this
              bank, tiers cycling hot (bf16), int8, int4 by slot;
      CSR:    the batch's bags as a ragged stream (holes kept)."""
    import numpy as np
    import torch
    from repro_torch.core import embedding as TE
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.quant import quantize_rows, row_bytes
    from repro_torch.quant.tiered import PAD_TIER, TieredTable
    r, D, L = d14.bank_rank, cfg.embed_dim, sparse.shape[-1]
    bank, slot, off = (statics["remap_bank"], statics["remap_slot"],
                       statics["field_offsets"])
    rpb = t_loc.rows_per_bank
    rows = TE._traffic_rows(sparse, off).to(torch.int32).contiguous()
    NB, out = rows.shape[0], {}

    def run(name, fn):
        zero_counters()
        with torch.no_grad():
            y = fn()
        torch.cuda.synchronize()
        out[f"{name}_launches"] = np.array(list(read_counters().values()))
        return y

    def same(name, y, got, plain):
        torch.cuda.synchronize()
        summed = d14.psum(plain, "bank")
        out[f"{name}_partial_equal"] = np.array(torch.equal(got, plain))
        out[f"{name}_sum_equal"] = np.array(torch.equal(
            y.reshape(summed.shape), summed))

    # cached
    n_ent = 4 * BANK_CACHE_ROWS
    ent = torch.arange(n_ent, device=dev, dtype=torch.int32)
    c_loc = TE.BankedTable(
        torch.randn((BANK_CACHE_ROWS, D), device=dev, generator=torch
                    .Generator(device=dev).manual_seed(BANK_SEED + 1 + r)),
        ent % 4, ent // 4, 4, BANK_CACHE_ROWS)
    g = torch.Generator(device=dev).manual_seed(BANK_SEED + 9)
    ci = torch.randint(0, n_ent, (NB, BANK_CACHE_LEN), device=dev,
                       generator=g, dtype=torch.int32)
    ci[torch.rand(ci.shape, device=dev, generator=g) < 0.2] = -1
    y = run("cached", lambda: TE.banked_cache_residual_bag(
        t_loc, c_loc, ci, rows, d14))
    a = (t_loc.packed, c_loc.packed, bank, slot, c_loc.remap_bank,
         c_loc.remap_slot, r, ci, rows)
    same("cached", y, kbag.cache_residual_bag(*a),
         kbag.cache_residual_bag_plain(*a))

    # tiered: quantize the rows this bank serves to the batch
    flat = rows.reshape(-1)
    hit = (flat >= 0) & (bank[flat.clamp(min=0).long()] == r)
    used = torch.unique(slot[flat[hit].long()].long())
    tier_u = (used % 3).to(torch.int32).cpu().numpy()
    pay_u, scale_u = quantize_rows(t_loc.packed[used].cpu().numpy(), tier_u,
                                   hot_dtype="bf16")
    payload = torch.zeros((rpb, row_bytes(D, "bf16")), dtype=torch.int8,
                          device=dev)
    scale = torch.ones(rpb, device=dev)
    tier = torch.full((rpb,), PAD_TIER, dtype=torch.int32, device=dev)
    payload[used] = torch.from_numpy(pay_u).to(dev)
    scale[used] = torch.from_numpy(scale_u).to(dev)
    tier[used] = torch.from_numpy(tier_u).to(dev)
    tt = TieredTable(payload=payload, scale=scale, tier=tier, remap_bank=bank,
                     remap_slot=slot, n_banks=4, rows_per_bank=rpb, dim=D,
                     hot_dtype="bf16")
    y = run("tiered", lambda: TE.tiered_embedding_bag(
        t_loc.packed, tt, sparse, d14, field_offsets=off))
    ids = sparse.reshape(-1, L).to(torch.int32).contiguous()
    a = (payload, scale, tier, bank, slot, off, r, ids)
    same("tiered", y, kbag.tiered_bag(*a, dim=D, hot_dtype="bf16"),
         kbag.tiered_bag_plain(*a, dim=D, hot_dtype="bf16"))

    # CSR: the bags as a ragged stream
    starts = torch.arange(NB, device=dev, dtype=torch.int32) * L
    y = run("csr", lambda: TE.csr_embedding_bag(t_loc, flat, starts, NB,
                                                d14))
    offs = torch.cat([starts, torch.full((1,), flat.numel(),
                                         dtype=torch.int32, device=dev)])
    a = (t_loc.packed, bank, slot, r, flat, offs)
    same("csr", y, kbag.csr_bag(*a), kbag.csr_bag_plain(*a))
    return out


def _bank_migrate_reduced(d14, dev):
    """(c) both exchanges at the reduced size (the full exchange sums a
    buffer of the whole packed size), fp32 and bf16, against the
    single-device migration, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.core import embedding as TE
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.workload.migrate import migrate_table
    red = get_arch("updlrm-paper").reduced
    V, D, nb = red.total_vocab, red.embed_dim, 4
    rng = np.random.default_rng(BANK_SEED)
    freq = rng.random(V) + 0.05
    cap = V // nb + 200
    pa = non_uniform_partition(freq, nb, capacity_rows=cap)
    pb = non_uniform_partition(np.roll(freq, 997), nb, capacity_rows=cap)
    ok = []
    for dtype in (torch.float32, torch.bfloat16):
        table = torch.from_numpy(rng.standard_normal((V, D)).astype(
            np.float32)).to(dev, dtype)
        packed = torch.zeros((nb * cap, D), dtype=dtype, device=dev)
        packed[torch.from_numpy(pa.bank_of_row.astype(np.int64) * cap
                                + pa.slot_of_row).to(dev)] = table
        t = TE.BankedTable(packed, torch.from_numpy(pa.bank_of_row).to(dev),
                           torch.from_numpy(pa.slot_of_row).to(dev), nb, cap)
        want = migrate_table(t, pb, rows_per_bank=cap).packed
        m = d14.bank_rank
        loc = TE.BankedTable(packed[m * cap:(m + 1) * cap].clone(),
                             t.remap_bank, t.remap_slot, nb, cap)
        for ex in ("compact", "full"):
            got = migrate_table(loc, pb, d14, rows_per_bank=cap, exchange=ex)
            ok.append(torch.equal(got.packed, want[m * cap:(m + 1) * cap]))
    return {"migrate_reduced_equal": np.array(all(ok))}


def _bank_train(inp, d22, dev):
    """(b) 4 DP train steps at full width on the 2 x 2 grid (a 2-bank
    plan, batch 64: 32 per dp rank), every launch counter set to 0 just
    before and read just after; the touched rows of the rank's shard, their
    row-wise Adagrad accumulators, each step's dense gradient norm and the
    dense params returned for the parent's single-device run; each
    bank's scatter of one cotangent against the single-device scatter's
    rows, bit for bit."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (recsys_batch_shardings,
                                           recsys_param_shardings)
    from repro_torch.kernels.embedding_bag import ct_scatter_bag
    from repro_torch.launch.train import build_loss, make_batch_fn, to_device
    from repro_torch.models import dlrm
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    spec = get_arch("updlrm-paper")
    cfg = spec.config
    plan2 = _plan_of(inp["p2_bank"], inp["p2_slot"], 2)
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), plan=plan2,
        device=dev)
    rpb, m = statics["rows_per_bank"], d22.bank_rank
    flat_remap = statics["remap_flat"]
    local = recsys_param_shardings(d22, params)
    del params
    init = local["emb_packed"].clone()
    opt = default_optimizer()
    loss_fn, kw = build_loss(spec, cfg, statics)
    state = TrainState.create(local, opt)
    batch_fn = make_batch_fn(spec, cfg)
    cut = [recsys_batch_shardings(d22, to_device(batch_fn(64, 0, i), dev))
           for i in range(BANK_TRAIN_STEPS)]
    batches, d64 = [b for b, _ in cut], cut[0][1]
    step = build_train_step(loss_fn, opt, loss_kwargs=kw, dist=d64)
    out = {}
    zero_counters()
    losses, norms, ms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
        ms.append(_sync_ms(t0))
    out["train_launches"] = np.array(list(read_counters().values()))
    out["train_losses"], out["train_step_ms"] = np.array(losses), np.array(ms)
    out["train_grad_norms"] = np.array(norms)
    emb, acc = state.params["emb_packed"], state.opt_state["true"][0]
    pos = inp["touched"]
    mine = pos[(pos >= m * rpb) & (pos < (m + 1) * rpb)] - m * rpb
    mine_t = torch.from_numpy(mine).to(dev)
    out["train_rows"] = emb[mine_t].cpu().numpy()
    out["train_acc"] = acc[mine_t].cpu().numpy()
    changed = (emb != init).any(dim=1) | (acc != 0)
    changed[mine_t] = False
    out["train_changed_elsewhere"] = np.array(int(changed.sum()))
    dense = O.tree_leaves({"bot": state.params["bot"],
                           "top": state.params["top"]})
    out["train_dense"] = torch.cat([x.reshape(-1) for x in dense]) \
        .cpu().numpy()
    # one cotangent of the whole step-0 batch scattered by bank and whole
    full = to_device(batch_fn(64, 0, 0), dev)["sparse"]
    flat = full.reshape(-1, cfg.multi_hot).contiguous()
    ct = torch.randn((flat.shape[0], cfg.embed_dim), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(9))
    off = statics["field_offsets"]
    whole = ct_scatter_bag(ct, flat, statics["remap_bank"], flat_remap, off,
                           -1, 2 * rpb, torch.float32)
    shard = ct_scatter_bag(ct, flat, statics["remap_bank"],
                           statics["remap_slot"], off, m, rpb, torch.float32)
    out["scatter_equal"] = np.array(torch.equal(
        shard, whole[m * rpb:(m + 1) * rpb]))
    return out


def _bank_train_ref(spec, plan2, dev):
    """(b)'s single-device reference: ``launch.train.run``'s loop (seed 0,
    its optimizer, loss and batches) at batch 64 on the 2-bank plan, with
    each step's dense gradient norm. -> (losses, grad norms, state)."""
    import numpy as np
    import torch
    from repro_torch.launch.train import build_loss, make_batch_fn, to_device
    from repro_torch.models import dlrm
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    cfg = spec.config
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), plan=plan2,
        device=dev)
    opt = default_optimizer()
    loss_fn, kw = build_loss(spec, cfg, statics)
    step = build_train_step(loss_fn, opt, loss_kwargs=kw)
    state = TrainState.create(params, opt)
    del params
    batch_fn = make_batch_fn(spec, cfg)
    losses, norms = [], []
    for i in range(BANK_TRAIN_STEPS):
        state, met = step(state, to_device(batch_fn(64, 0, i), dev))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    return np.array(losses), np.array(norms), state


def _bank_dp_step(d22, dev):
    """(e) the compressed DP step on the reduced dlrm-rm2, dp over all 4
    ranks of the 2 x 2 grid: one step's int8 psum of every gradient leaf
    against the plain formula on the ranks' gathered gradients, bit for
    bit; then 15 steps of one batch of 64 (16 a rank), every launch counter
    set to 0 just before and read just after, against the uncompressed
    single-device step's losses."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.models import dlrm
    from repro_torch.train import compress as C
    from repro_torch.train import optim as O
    from repro_torch.train.dp_step import build_dp_compressed_step
    from repro_torch.train.train_step import TrainState, build_train_step
    cfg = get_arch("dlrm-rm2").reduced
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    b = {k: torch.from_numpy(v).to(dev) for k, v in syn.dlrm_batch(
        cfg.vocab_sizes, cfg.n_dense, 64, seed=0, step=0).items()}
    axes = ("dp", "bank")
    n = 64 // d22.size(axes)
    local = {k: v[d22.rank * n:(d22.rank + 1) * n] for k, v in b.items()}

    def loss(p, bb):
        return dlrm.loss_fn(cfg, p, statics, bb)
    flat = O.tree_leaves(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    grads = torch.autograd.grad(loss(O.tree_unflatten(params, leaves), local),
                                leaves)
    ok = True
    for g in grads:
        e = torch.zeros(g.shape, dtype=torch.float32, device=dev)
        s, err = C.psum_int8(g, d22, e, axes)
        xs = d22.gather(g.float()[None], axes)              # (ranks, ...)
        scale = torch.stack([C.quantize_int8(x)[1] for x in xs]).max()
        q = torch.clamp(torch.round(torch.div(xs, scale)), -127, 127)
        want_s = q.to(torch.int32).sum(0).float() * scale
        want_e = (xs[d22.rank].double()
                  - q[d22.rank].double() * scale.double()).float()
        ok &= torch.equal(s, want_s) and torch.equal(err, want_e)
    opt = O.adam(1e-2)
    step = build_dp_compressed_step(loss, opt, d22, axes)
    state = TrainState.create(params, opt, compress=True)
    zero_counters()
    losses, ms = [], []
    for _ in range(BANK_DP_STEPS):
        t0 = time.perf_counter()
        state, met = step(state, local)
        losses.append(float(met["loss"]))
        ms.append(_sync_ms(t0))
    out = {"dp_launches": np.array(list(read_counters().values())),
           "dp_losses": np.array(losses), "dp_step_ms": np.array(ms),
           "psum_int8_equal": np.array(ok)}
    step_r = build_train_step(loss, opt, clip_norm=None)
    state = TrainState.create(params, opt)
    ref = []
    for _ in range(BANK_DP_STEPS):
        state, met = step_r(state, b)
        ref.append(float(met["loss"]))
    out["dp_ref_losses"] = np.array(ref)
    return out


# phase 15 (f)-(h): retrieval spread over the grid, compressed and clipped
# training under DistCtx
BANK_RETRIEVAL_N, BANK_RETRIEVAL_TOP_K = 1_000_000, 128
# (f) caps each dlrm-rm2 field at 10^5 rows (840,543 rows in all): four
# ranks' tables and the parent's single-device reference then fit one card
# beside phases 1-14's leftovers; the widths (26 fields, D = 64, both MLPs)
# and the candidates (field 0's 1,460 rows) are uncut
BANK_RETRIEVAL_ROWS = 100_000
BANK_CMP_STEPS = 2
BANK_CMP_TREE_ROWS = 1 << 20    # (g)'s fixed gradient tree: its table's rows


def _bank_retrieval_cfg():
    import dataclasses
    from repro_torch.configs import get_arch
    cfg = get_arch("dlrm-rm2").config
    return dataclasses.replace(
        cfg, name=f"{cfg.name}-rows-capped",
        vocab_sizes=tuple(min(v, BANK_RETRIEVAL_ROWS)
                          for v in cfg.vocab_sizes))


def _bank_retrieval_model(dev):
    import torch
    from repro_torch.core.partitioning import uniform_partition
    from repro_torch.models import dlrm
    cfg = _bank_retrieval_cfg()
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(BANK_SEED + 1),
        plan=uniform_partition(cfg.total_vocab, 4), device=dev)
    return cfg, params, statics


def _bank_retrieval(inp, d14, dev):
    """(f) one retrieval query on the 1 x 4 grid: ``build_retrieval_serve
    (..., dist)`` with every launch counter set to 0 just before and read
    just after (each rank scores its quarter of the 10^6 candidates through
    the interaction's query entry; the top 128 merged over the grid),
    timed; the rank's scores; rows 2q and 2f on the rank's piece against
    their plain version."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import banked_gather
    from repro_torch.dist.collectives import query_ctx, spread_gather
    from repro_torch.dist.sharding import recsys_param_shardings
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_features_plain,
                                                     dot_features_query)
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_retrieval_serve
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg, params, statics = _bank_retrieval_model(dev)
    local = recsys_param_shardings(d14, params)
    del params
    batch = {k: torch.from_numpy(np.array(inp[f"r_{k}"])).to(dev)
             for k in ("dense", "sparse", "candidates")}
    serve = build_retrieval_serve(dlrm, cfg, statics, d14,
                                  top_k=BANK_RETRIEVAL_TOP_K)
    d14.psum(torch.zeros(1, device=dev), "bank")          # line the ranks up
    zero_counters()
    t0 = time.perf_counter()
    vals, ids = serve(local, batch)
    first_ms = _sync_ms(t0)
    out = {"retrieval_launches": np.array(list(read_counters().values())),
           "r_vals": vals.cpu().numpy(), "r_ids": ids.cpu().numpy(),
           "r_first_ms": np.array(first_ms)}
    rep = []
    for _ in range(3):
        t0 = time.perf_counter()
        serve(local, batch)
        rep.append(_sync_ms(t0))
    out["r_ms"] = np.array(rep)
    with torch.inference_mode():
        out["r_scores"] = dlrm.retrieval_scores(
            cfg, local, statics, batch, d14).cpu().numpy()
        t, offs = dlrm._banked(local, statics), statics["field_offsets"]
        x = dlrm.mlp_apply(local["bot"], batch["dense"])
        eu = banked_gather(t, batch["sparse"][:, 1:] + offs[None, 1:],
                           query_ctx(d14, 1))
        ec = spread_gather(t, batch["candidates"] + offs[0], d14)
        n = ec.shape[0]
        emb = torch.cat([eu.float().expand(n, -1, -1), ec.float()[:, None]],
                        dim=1)
        xn = x.expand(n, -1).contiguous()
        got, want = dot_features(xn, emb), dot_features_plain(xn, emb)
        out["r_dot_err"] = np.array((got - want).abs().max().item())
        out["r_dot_ok"] = np.array(bool(torch.allclose(got, want, **DOT_TOL)))
        # the query entry's plain version is this broadcast, bit for bit
        got_q = dot_features_query(x[0], eu[0].float(), ec.float())
        out["r_query_err"] = np.array((got_q - want).abs().max().item())
        out["r_query_ok"] = np.array(bool(torch.allclose(got_q, want,
                                                         **DOT_TOL)))
        del got_q
        out["r_dot_shape"] = np.array([n, emb.shape[1] + 1, emb.shape[2]])
    out["r_peak"] = np.array(torch.cuda.max_memory_allocated() - base)
    del got, want, emb, xn, local
    torch.cuda.empty_cache()
    return out


def _bank_cmp_tree(dev, cfg):
    """(g)'s fixed gradient tree and error state: a (2^20, D) table whose
    largest magnitude sits on bank 2's rows (so a shard's own max is not
    the table's on three ranks of four), and the bottom MLP's leaves."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(BANK_SEED + 2)

    def rnd(*shape, s=1.0):
        return torch.randn(shape, generator=gen, device=dev) * s
    tab = rnd(BANK_CMP_TREE_ROWS, cfg.embed_dim, s=0.01)
    tab[BANK_CMP_TREE_ROWS // 2 + 7, 3] = 1.5
    tree = {"emb_packed": tab, "bot": {"w": [rnd(cfg.n_dense, 512)],
                                       "b": [rnd(512)]}}
    err = {"emb_packed": rnd(BANK_CMP_TREE_ROWS, cfg.embed_dim, s=1e-4),
           "bot": {"w": [rnd(cfg.n_dense, 512, s=1e-3)],
                   "b": [rnd(512, s=1e-3)]}}
    return tree, err


def _bank_compress(inp, d14, dev):
    """(g) ``compress_roundtrip(dist)`` of the rank's pieces of a fixed
    tree against the whole tree's on the card, bit for bit (and a shard
    quantized at its own max, which must differ on three ranks); two
    ``build_train_step(compress_grads=True, dist=...)`` steps at full
    width on the 1 x 4 grid, every launch counter set to 0 just before and
    read just after; (h) one step clipped over every leaf, the table
    shards included (the same)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.dist.sharding import (recsys_param_shardings,
                                           train_state_shardings)
    from repro_torch.launch.train import build_loss, make_batch_fn, to_device
    from repro_torch.train import compress as C
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    spec = get_arch("updlrm-paper")
    cfg, r = spec.config, d14.bank_rank
    tree, err = _bank_cmp_tree(dev, cfg)
    g_w, e_w = C.compress_roundtrip(tree, err)
    loc_t, loc_e = (recsys_param_shardings(d14, x) for x in (tree, err))
    g_l, e_l = C.compress_roundtrip(loc_t, loc_e, d14)
    own, _ = C.compress_roundtrip(loc_t, loc_e)
    k = BANK_CMP_TREE_ROWS // 4
    rows = slice(r * k, (r + 1) * k)
    out = {"cmp_tree_equal": np.array(
        torch.equal(g_l["emb_packed"], g_w["emb_packed"][rows])
        and torch.equal(e_l["emb_packed"], e_w["emb_packed"][rows])
        and all(torch.equal(a, b) for a, b in zip(
            O.tree_leaves(g_l["bot"]), O.tree_leaves(g_w["bot"])))),
        "cmp_tree_own_differs": np.array(not torch.equal(
            own["emb_packed"], g_w["emb_packed"][rows]))}
    del tree, err, g_w, e_w, loc_t, loc_e, g_l, e_l, own

    params, statics = _bank_cmp_model(dev, spec)
    rpb = statics["rows_per_bank"]
    opt = default_optimizer()
    loss_fn, kw = build_loss(spec, cfg, statics)
    st_c = train_state_shardings(d14, TrainState.create(params, opt,
                                                        compress=True))
    st_h = train_state_shardings(d14, TrainState.create(params, opt))
    del params
    init = st_c.params["emb_packed"].clone()
    batch_fn = make_batch_fn(spec, cfg)
    batches = [to_device(batch_fn(64, 0, i), dev)
               for i in range(BANK_CMP_STEPS)]
    step = build_train_step(loss_fn, opt, compress_grads=True,
                            loss_kwargs=kw, dist=d14)
    d14.psum(torch.zeros(1, device=dev), "bank")
    zero_counters()
    losses, norms, ms = [], [], []
    for b in batches:
        t0 = time.perf_counter()
        st_c, met = step(st_c, b)
        ms.append(_sync_ms(t0))
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    out["cmp_launches"] = np.array(list(read_counters().values()))
    out.update(cmp_losses=np.array(losses), cmp_norms=np.array(norms),
               cmp_step_ms=np.array(ms))
    pos = inp["g_rows"]
    mine = torch.from_numpy(pos[(pos >= r * rpb) & (pos < (r + 1) * rpb)]
                            - r * rpb).to(dev)
    emb = st_c.params["emb_packed"]
    out["cmp_rows"] = emb[mine].cpu().numpy()
    out["cmp_err"] = st_c.err_state["emb_packed"][mine].cpu().numpy()
    out["cmp_acc"] = st_c.opt_state["true"][0][mine].cpu().numpy()
    changed = (emb != init).any(dim=1)
    changed[mine] = False
    out["cmp_changed_elsewhere"] = np.array(int(changed.sum()))
    out["cmp_dense"] = torch.cat([x.reshape(-1) for x in O.tree_leaves(
        {"bot": st_c.params["bot"], "top": st_c.params["top"]})]) \
        .cpu().numpy()
    del st_c, init, emb, changed
    torch.cuda.empty_cache()

    clip = build_train_step(loss_fn, opt, clip_include=lambda p: True,
                            loss_kwargs=kw, dist=d14)
    zero_counters()
    _, met = clip(st_h, batches[0])
    torch.cuda.synchronize()
    out["clip_launches"] = np.array(list(read_counters().values()))
    out["clip_norm"] = np.array(float(met["grad_norm"]))
    out["clip_loss"] = np.array(float(met["loss"]))
    del st_h
    torch.cuda.empty_cache()
    return out


def _bank_cmp_model(dev, spec):
    """(g) and (h)'s model: full-width updlrm-paper on 4 contiguous banks
    of its 18.9 M rows, so each field's rows sit on one bank and every
    bag's bank sum adds three exact zeros: the sharded step's arithmetic
    is the single-device step's."""
    import torch
    from repro_torch.core.partitioning import uniform_partition
    from repro_torch.models import dlrm
    cfg = spec.config
    return dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(BANK_SEED + 3),
        plan=uniform_partition(cfg.total_vocab, 4), device=dev)


def _bank_retrieval_ref(dev):
    """(f)'s query (numpy, for the ranks) and the single-device scores and
    top 128 on the card."""
    import numpy as np
    import torch
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_retrieval_serve
    cfg, params, statics = _bank_retrieval_model(dev)
    rng = np.random.default_rng(BANK_SEED + 1)
    q = {"dense": rng.standard_normal((1, cfg.n_dense)).astype(np.float32),
         "sparse": np.array([[rng.integers(v) for v in cfg.vocab_sizes]],
                            np.int32),
         "candidates": rng.integers(0, cfg.vocab_sizes[0],
                                    BANK_RETRIEVAL_N).astype(np.int32)}
    b = {k: torch.from_numpy(v).to(dev) for k, v in q.items()}
    with torch.inference_mode():
        scores = dlrm.retrieval_scores(cfg, params, statics, b)
    vals, ids = build_retrieval_serve(dlrm, cfg, statics,
                                      top_k=BANK_RETRIEVAL_TOP_K)(params, b)
    ref = dict(scores=scores.cpu(), vals=vals.cpu(), ids=ids.cpu(),
               cand=torch.from_numpy(q["candidates"]))
    del params, statics, scores, b
    torch.cuda.empty_cache()
    return {f"r_{k}": v for k, v in q.items()}, ref


def _bank_compress_ref(dev):
    """(g) and (h)'s single-device run on the card: two compressed steps
    (losses, dense gradient norms, the touched rows' values, errors and
    accumulators, the dense params) and one step clipped over every leaf
    (its norm and loss); the touched rows' packed positions for the
    ranks."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch.train import build_loss, make_batch_fn, to_device
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import (TrainState, build_train_step,
                                              default_optimizer)
    spec = get_arch("updlrm-paper")
    cfg = spec.config
    params, statics = _bank_cmp_model(dev, spec)
    opt = default_optimizer()
    loss_fn, kw = build_loss(spec, cfg, statics)
    batch_fn = make_batch_fn(spec, cfg)
    np_b = [batch_fn(64, 0, i) for i in range(BANK_CMP_STEPS)]
    batches = [to_device(b, dev) for b in np_b]
    clip = build_train_step(loss_fn, opt, clip_include=lambda p: True,
                            loss_kwargs=kw)
    _, met = clip(TrainState.create(params, opt), batches[0])
    ref = dict(clip_norm=float(met["grad_norm"]),
               clip_loss=float(met["loss"]))
    step = build_train_step(loss_fn, opt, compress_grads=True,
                            loss_kwargs=kw)
    state = TrainState.create(params, opt, compress=True)
    del params
    losses, norms = [], []
    for b in batches:
        state, met = step(state, b)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    offs = cfg.field_offsets()
    rows = np.concatenate([(b["sparse"] + offs[None, :, None])[
        b["sparse"] >= 0] for b in np_b])
    flat = statics["remap_flat"].cpu().numpy()
    touched = np.unique(flat[rows].astype(np.int64))
    tt = torch.from_numpy(touched).to(dev)
    ref.update(losses=np.array(losses), norms=np.array(norms),
               touched=touched,
               rows=state.params["emb_packed"][tt].cpu().numpy(),
               err=state.err_state["emb_packed"][tt].cpu().numpy(),
               acc=state.opt_state["true"][0][tt].cpu().numpy(),
               dense=torch.cat([x.reshape(-1) for x in O.tree_leaves(
                   {"bot": state.params["bot"],
                    "top": state.params["top"]})]).cpu().numpy(),
               rpb=statics["rows_per_bank"])
    del state, tt, statics
    torch.cuda.empty_cache()
    return {"g_rows": touched}, ref


# (i) the adaptive runtime's cache and int4 tier lanes and migrate_aux
# under dist; (j) the LM family's sharded decode attention and MoE layer

BANK_LANE_ENTRIES = 128     # (i): the cache lane's entries, 32 a bank
BANK_LANE_BATCHES = 2       # (i): batches observed before the drift check
BANK_LANE_SEED = 27


def _digest(t):
    """SHA-256 of a tensor's bytes, as 32 uint8: equal digests are equal
    bits, without moving the tensors between processes."""
    import hashlib
    import numpy as np
    import torch
    b = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu()
    return np.frombuffer(hashlib.sha256(b.numpy().tobytes()).digest(),
                         np.uint8).copy()


def _lane_table(inp, dev):
    """Phase 15's full-width table over the 4-bank plan (the seed of (a)),
    whole, with its statics."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import dlrm
    cfg = get_arch("updlrm-paper").config
    plan4 = _plan_of(inp["p4_bank"], inp["p4_slot"], 4)
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(BANK_SEED), plan=plan4,
        device=dev)
    return cfg, plan4, dlrm._banked(params, statics), statics


def _lane_acc(n, dev):
    import torch
    return torch.rand(n, device=dev, generator=torch.Generator(
        device=dev).manual_seed(BANK_LANE_SEED))


def _lane_runtime(cfg, t, plan4, lane, d14):
    """The runtime of one lane: the cache lane as the launchers set it up
    (``cache_lane_runtime``: cache-aware replans, BANK_LANE_ENTRIES
    entries), or the int4 tier lane as ``run_adaptive --quant int4``."""
    import numpy as np
    from repro_torch.quant import QuantSpec
    from repro_torch.workload.replanner import ReplanConfig
    from repro_torch.workload.runtime import (AdaptiveEmbeddingRuntime,
                                              cache_lane_runtime)
    if lane == "cache":
        return cache_lane_runtime(t, plan4, multi_hot=cfg.multi_hot,
                                  replan_every=BANK_LANE_BATCHES,
                                  cache_entries=BANK_LANE_ENTRIES, dist=d14)
    V, D = cfg.total_vocab, cfg.embed_dim
    rcfg = ReplanConfig.for_vocab(
        V, 4, capacity_rows=t.rows_per_bank, check_every=BANK_LANE_BATCHES,
        quant=QuantSpec(enable_int4=True, byte_budget=D // 2 + 2.0,
                        min_hot_rows=8), quant_dim=D)
    return AdaptiveEmbeddingRuntime(t, plan4, rcfg, dist=d14,
                                    init_freq=np.ones(V))


def _bank_lanes(inp, d14, dev):
    """(i) on the 1 x 4 grid: the cache lane and the int4 tier lane, each an
    ``AdaptiveEmbeddingRuntime(dist=d14)`` over the rank's shard of (a)'s
    full-width table, both observing the global batches of (a)'s draw
    (every rank the same) until the cache lane's drift check fires. That
    one replan (cache-aware, over 18.9 M rows, on every rank) drives both
    swaps: the cache lane migrates the shard and installs the re-mined
    cache (``migrate_aux`` of a seeded Adagrad accumulator first); the
    tier lane swaps to the migrated shard (``apply_migrated``) and
    re-tiers it under ``assign_tiers`` of the update's frequencies, as its
    own replan would. The batch in flight across the swap (rewritten, or
    drawn, before it) and the next are served through the sharded fused
    cache and tiered lookups against the version they belong to, with
    every launch counter set to 0 just before and read just after; each
    kernel's partial equals its plain version on the same shard inputs,
    and the lookup the bank sum of it, bit for bit. Returns the plan,
    cache plan and tiers (from rank 0; a digest of them from every rank)
    for the parent's single-device builds, SHA-256 digests of the rank's
    shards (cache table, TieredTable, accumulator) and the seconds of each
    step (the runtime's own migration time apart)."""
    import numpy as np
    import torch
    from repro_torch.core import embedding as TE
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.quant import QuantSpec, assign_tiers
    from repro_torch.workload.replanner import PlanUpdate
    from repro_torch.workload.telemetry import rows_from_sparse
    cfg, plan4, whole, statics = _lane_table(inp, dev)
    r, rpb, out = d14.bank_rank, statics["rows_per_bank"], {}
    t_loc = TE.BankedTable(whole.packed[r * rpb:(r + 1) * rpb].clone(),
                           whole.remap_bank, whole.remap_slot, 4, rpb,
                           whole.remap_flat)
    acc = _lane_acc(4 * rpb, dev)[r * rpb:(r + 1) * rpb].clone()
    del whole
    torch.cuda.empty_cache()
    off = statics["field_offsets"]
    L, D = cfg.multi_hot, cfg.embed_dim
    sparse = [torch.from_numpy(np.array(inp["s_sparse"][i])).to(dev)
              for i in range(BANK_LANE_BATCHES + 1)]
    union = [rows_from_sparse(np.array(inp["s_sparse"][i]),
                              cfg.field_offsets()).reshape(-1, L)
             for i in range(BANK_LANE_BATCHES + 1)]

    def launched(name):
        torch.cuda.synchronize()
        out[f"{name}_launches"] = np.array(list(read_counters().values()))

    def served(name, y, got, plain):
        torch.cuda.synchronize()
        summed = d14.psum(plain, "bank")
        out[f"{name}_partial_equal"] = np.array(torch.equal(got, plain))
        out[f"{name}_sum_equal"] = np.array(torch.equal(
            y.reshape(summed.shape), summed))

    t0 = time.perf_counter()
    rt_c = _lane_runtime(cfg, t_loc, plan4, "cache", d14)
    out["lane_cache_setup_s"] = np.array(time.perf_counter() - t0)
    t0 = time.perf_counter()
    rt_t = _lane_runtime(cfg, t_loc, plan4, "tier", d14)
    out["lane_tier_setup_s"] = np.array(time.perf_counter() - t0)
    update = None
    for i in range(BANK_LANE_BATCHES):
        for rt in (rt_c, rt_t):
            rt.observe_batch(union[i].reshape(-1))
        rt_c.observe_bags([b[b >= 0] for b in union[i]])
        flight = rt_c.rewrite(union[i])
        t0 = time.perf_counter()
        update = rt_c.replanner.end_batch()
        out["lane_check_s"] = np.array(time.perf_counter() - t0)
    need(update is not None, "(i) the cache lane's drift check did not fire")
    old = rt_c.table
    t0 = time.perf_counter()
    aux = rt_c.migrate_aux(acc, update)
    torch.cuda.synchronize()
    out["lane_aux_s"] = np.array(time.perf_counter() - t0)
    t0 = time.perf_counter()
    event = rt_c.apply(update)
    torch.cuda.synchronize()
    out["lane_cache_swap_s"] = np.array(time.perf_counter() - t0)
    out["lane_cache_migrate_s"] = np.array(rt_c.metrics.snapshot()[
        "runtime.migrate_ms"]["sum"] / 1e3)
    qspec = rt_t.replanner.cfg.quant
    tiers = assign_tiers(update.freq, qspec, D).tier_of_row
    fp_old, v0 = rt_t.table.packed, rt_t.tier_version
    t0 = time.perf_counter()
    t_event = rt_t.apply_migrated(PlanUpdate(
        plan=update.plan, freq=update.freq, report=update.report,
        tier_of_row=tiers), rt_c.table)
    torch.cuda.synchronize()
    out["lane_tier_swap_s"] = np.array(time.perf_counter() - t0)

    after = rt_c.rewrite(union[BANK_LANE_BATCHES])
    for name, rb in (("lane_cflight", flight), ("lane_cafter", after)):
        ct = rt_c.cache_table_for(rb.version)
        ci = torch.from_numpy(rb.cache_idx).to(dev)
        ri = torch.from_numpy(rb.residual_idx).to(dev)
        zero_counters()
        with torch.no_grad():
            y = TE.banked_cache_residual_bag(rt_c.table, ct, ci, ri, d14)
        launched(name)
        a = (rt_c.table.packed, ct.packed, rt_c.table.remap_bank,
             rt_c.table.remap_slot, ct.remap_bank, ct.remap_slot, r, ci, ri)
        served(name, y, kbag.cache_residual_bag(*a),
               kbag.cache_residual_bag_plain(*a))
        out[f"{name}_hits"] = np.array(int((ci >= 0).sum()))
    for name, (fp, tt, sp) in (
            ("lane_tflight", (fp_old, rt_t.tiered_for(v0),
                              sparse[BANK_LANE_BATCHES - 1])),
            ("lane_tafter", (rt_t.table.packed, rt_t.tiered,
                             sparse[BANK_LANE_BATCHES]))):
        zero_counters()
        with torch.no_grad():
            y = TE.tiered_embedding_bag(fp, tt, sp, d14, field_offsets=off)
        launched(name)
        ids = sp.reshape(-1, L).to(torch.int32).contiguous()
        a = (tt.payload, tt.scale, tt.tier, tt.remap_bank, tt.remap_slot,
             off, r, ids)
        served(name, y, kbag.tiered_bag(*a, dim=D, hot_dtype=tt.hot_dtype),
               kbag.tiered_bag_plain(*a, dim=D, hot_dtype=tt.hot_dtype))
    fcp, tt = rt_c.cache_plan, rt_t.tiered
    members = [e.members for e in fcp.plan.entries]
    big = dict(lane_bank=update.plan.bank_of_row.astype(np.int32),
               lane_slot=update.plan.slot_of_row.astype(np.int32),
               lane_tiers=np.asarray(tiers, np.int8))
    # the swap every rank made: a digest from each rank, the arrays from
    # rank 0 alone (the parent builds from them)
    out["lane_d_plans"] = np.concatenate(
        [_digest(torch.from_numpy(big[k])) for k in sorted(big)])
    if r == 0:
        out.update(big)
    out.update(
        lane_ebank=fcp.entry_bank, lane_eslot=fcp.entry_slot,
        lane_members=np.array([m for e in members for m in e], np.int64),
        lane_moff=np.cumsum([0] + [len(e) for e in members]),
        lane_c_event=np.array([event.cache_version, event.cache_entries,
                               event.cache_dropped]),
        lane_t_event=np.array([t_event.tier_version, t_event.tier_promoted,
                               t_event.tier_demoted,
                               t_event.tier_requantized]),
        lane_moved=np.array(int((old.remap_bank.cpu().numpy()
                                 != update.plan.bank_of_row).sum())),
        lane_d_cache=_digest(rt_c.cache_table.packed),
        lane_d_aux=_digest(aux),
        lane_d_tier=np.concatenate([_digest(tt.payload), _digest(tt.scale),
                                    _digest(tt.tier)]))
    del rt_c, rt_t, tt, fp_old, t_loc, old, aux, acc
    torch.cuda.empty_cache()
    return out


def _bank_lanes_check(outs, plan_inp, dev):
    """(i)'s single-device builds on the card from the plan, cache plan
    and tiers the ranks swapped to (no second replan): the migration of
    (a)'s whole table, the fixed cache table from its entry-member rows,
    the Adagrad accumulator's migration, the tiered table of the swap from
    scratch (``build_tiered_table``); each rank's shard digests must equal
    its bank's slices'. (The migrated EMT itself is (c)'s check.) Returns
    the seconds of the builds and the checks."""
    import numpy as np
    import torch
    from repro_torch.core.cache_runtime import (FixedCachePlan,
                                                build_cache_table_fixed,
                                                entry_member_union)
    from repro_torch.core.grace import CacheEntry, CachePlan
    from repro_torch.quant import build_tiered_table
    from repro_torch.workload.migrate import (migrate_rowwise_state,
                                              migrate_table)
    t0 = time.perf_counter()
    o0 = outs[0]
    for o in outs[1:]:
        for k in ("lane_d_plans", "lane_members", "lane_moff", "lane_ebank",
                  "lane_eslot", "lane_c_event", "lane_t_event"):
            need(np.array_equal(o[k], o0[k]),
                 f"(i) the ranks swapped to different {k}")
    cfg, plan4, whole, statics = _lane_table(plan_inp, dev)
    rpb = statics["rows_per_bank"]

    def held(key, tensors, what):
        for m, o in enumerate(outs):
            want = np.concatenate([_digest(x[m * (x.shape[0] // 4):
                                              (m + 1) * (x.shape[0] // 4)])
                                   for x in tensors])
            need(np.array_equal(o[key], want),
                 f"(i) rank {m}: its {what} != the single-device build's "
                 f"bank {m} slice")

    plan = _plan_of(o0["lane_bank"], o0["lane_slot"], 4)
    mig = migrate_table(whole, plan, rows_per_bank=rpb)
    moff = o0["lane_moff"]
    entries = [CacheEntry(members=tuple(int(x) for x in
                                        o0["lane_members"][a:b]), hits=0.0)
               for a, b in zip(moff[:-1], moff[1:])]
    fcp = FixedCachePlan(plan=CachePlan(groups=[], benefits=np.zeros(0),
                                        entries=entries, entry_of_subset={}),
                         entry_bank=o0["lane_ebank"],
                         entry_slot=o0["lane_eslot"], n_banks=4,
                         rows_per_bank=BANK_LANE_ENTRIES // 4)
    members = entry_member_union(fcp)
    ctab = build_cache_table_fixed(
        mig.packed[mig.remap_flat[torch.from_numpy(members).to(dev)].long()],
        fcp, row_ids=members, device=dev)
    held("lane_d_cache", [ctab.packed], "cache table")
    held("lane_d_aux", [migrate_rowwise_state(_lane_acc(4 * rpb, dev),
                                              whole, plan,
                                              rows_per_bank=rpb)],
         "migrated accumulator")
    cache_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    del whole
    tt = build_tiered_table(mig, o0["lane_tiers"].astype(np.int32),
                            hot_dtype="bf16")
    held("lane_d_tier", [tt.payload, tt.scale, tt.tier], "TieredTable")
    del tt, mig, ctab
    torch.cuda.empty_cache()
    for m, o in enumerate(outs):
        for name in ("lane_cflight", "lane_cafter", "lane_tflight",
                     "lane_tafter"):
            need(bool(o[f"{name}_partial_equal"])
                 and bool(o[f"{name}_sum_equal"]),
                 f"(i) rank {m}: {name}: the kernel's partial != its plain "
                 f"version, or the lookup != the bank sum of it")
    need(int(o0["lane_cafter_hits"]) > 0,
         "(i) no cache hit on the batch after the cache lane's swap")
    need(int(o0["lane_cflight_hits"]) == 0,
         "(i) the batch in flight hit version 0's empty cache")
    need(int(o0["lane_t_event"][3]) > 0, "(i) the re-tier changed no tier")
    return dict(cache_ref_s=cache_s, tier_ref_s=time.perf_counter() - t0)


BANK_LM_ARCH = "granite-moe-1b-a400m"
BANK_LM_B, BANK_LM_S, BANK_LM_POS = 8, 2048, 1500     # (j) decode cache
BANK_LM_TOKENS = 8 * 256                              # (j) MoE tokens
BANK_LM_SEED = 28
# (j) tolerances: the attention's fp32 combine and the one-card softmax,
# both cast to bf16: one bf16 ulp; the MoE at fp32 (TF32 off) to rounding,
# at bf16 two ulps (the bank sum adds the experts' parts in another order)
BANK_LM_ATTN_TOL = dict(rtol=2 ** -7, atol=1e-3)
BANK_LM_MOE_TOL = {"f32": dict(rtol=1e-5, atol=1e-5),
                   "bf16": dict(rtol=2 ** -6, atol=1e-2)}


def _lm_inputs(dev):
    """(j)'s inputs at granite-moe-1b-a400m widths, drawn on the card from
    BANK_LM_SEED (the same on every rank and in the parent): a decode
    step's q, new K/V and a bf16 cache of BANK_LM_S positions; one MoE
    layer's tokens, router and 32 experts (fp32)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(BANK_LM_ARCH).config
    g = torch.Generator(device=dev).manual_seed(BANK_LM_SEED)

    def rn(*shape, scale=1.0):
        return torch.randn(shape, device=dev, generator=g) * scale

    B, S, H, Hk, Dh = (BANK_LM_B, BANK_LM_S, cfg.n_heads, cfg.n_kv_heads,
                       cfg.d_head)
    d, E, ff = cfg.d_model, cfg.moe.n_experts, cfg.d_ff
    dec = dict(q=rn(B, H, Dh).bfloat16(), kn=rn(B, Hk, Dh).bfloat16(),
               vn=rn(B, Hk, Dh).bfloat16(),
               cache=T.KVCache(k=rn(1, B, S, Hk, Dh).bfloat16(),
                               v=rn(1, B, S, Hk, Dh).bfloat16(), length=0))
    moe = dict(x=rn(BANK_LM_TOKENS // 256, 256, d),
               w_router=rn(d, E, scale=d ** -0.5),
               w_gate=rn(E, d, ff, scale=d ** -0.5),
               w_up=rn(E, d, ff, scale=d ** -0.5),
               w_down=rn(E, ff, d, scale=ff ** -0.5))
    return cfg, dec, moe


def _bank_lm(inp, d14, dev):
    """(j) on the 1 x 4 grid at granite-moe-1b-a400m widths: one
    ``seqsharded_decode_attention`` step with the cache cut over the bank
    axis by ``kv_cache_shardings`` (the new row lands on the rank that owns
    position BANK_LM_POS), and one ``moe_layer_sharded`` layer with the
    rank's 8 of the 32 experts (``lm_param_shardings``' cut), at fp32 and
    at the config's bf16; each timed. Then that layer's forward and
    backward twice from the same inputs and cotangent, each dtype. Returns
    the outputs, whether the two runs' output and gradients are bit-equal
    and finite, and the digests of the rank's cache pieces."""
    import numpy as np
    import torch
    from repro_torch.dist import collectives as C
    from repro_torch.dist import sharding as SH
    from repro_torch.models import layers as L
    cfg, dec, moe = _lm_inputs(dev)
    out = {}
    cache, cut, bsl = SH.kv_cache_shardings(d14, dec["cache"], ("bank",))
    del dec["cache"]
    ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        o, kc, vc = C.seqsharded_decode_attention(
            dec["q"], dec["kn"], dec["vn"], cache.k[0], cache.v[0],
            BANK_LM_POS, dist=d14, seq_axes=cut)
        ms.append(_sync_ms(t0))
    out.update(lm_attn=o.float().cpu().numpy(), lm_attn_ms=np.array(ms),
               lm_d_k=_digest(kc), lm_d_v=_digest(vc),
               lm_cut=np.array([len(cut), bsl.start, bsl.stop]))
    pieces = SH.lm_param_shardings(d14, {"layers": {
        k: moe[k][None] for k in ("w_gate", "w_up", "w_down")}})["layers"]
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            with torch.no_grad():
                y = L.moe_layer_sharded(
                    moe["x"].to(dtype), moe["w_router"].to(dtype),
                    *(pieces[k][0].to(dtype) for k in ("w_gate", "w_up",
                                                        "w_down")),
                    top_k=cfg.moe.top_k,
                    capacity_factor=cfg.moe.capacity_factor, dist=d14)
            ms.append(_sync_ms(t0))
        out[f"lm_moe_{dt}"] = y.float().cpu().numpy()
        out[f"lm_moe_{dt}_ms"] = np.array(ms)
    # forward and backward twice from the same inputs and cotangent: the
    # order-fixed dispatch and combine give the same bits on every run
    ct = torch.randn(moe["x"].shape, device=dev, generator=torch.Generator(
        device=dev).manual_seed(BANK_LM_SEED + 1))
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        runs, ms = [], []
        for _ in range(2):
            t0 = time.perf_counter()
            leaves = [t.to(dtype).detach().requires_grad_(True) for t in (
                moe["x"], moe["w_router"],
                *(pieces[k][0] for k in ("w_gate", "w_up", "w_down")))]
            y = L.moe_layer_sharded(*leaves, top_k=cfg.moe.top_k,
                                    capacity_factor=cfg.moe.capacity_factor,
                                    dist=d14)
            runs.append([y.detach(), *torch.autograd.grad(
                y, leaves, ct.to(dtype))])
            ms.append(_sync_ms(t0))
        out[f"lm_moe_{dt}_bwd_ms"] = np.array(ms)
        out[f"lm_moe_{dt}_bwd_same"] = np.array(int(all(
            torch.equal(a, b) for a, b in zip(*runs))))
        out[f"lm_moe_{dt}_bwd_finite"] = np.array(int(all(
            bool(torch.isfinite(t).all()) for t in runs[0])))
    return out


def _bank_lm_check(outs, dev):
    """(j)'s one-card results on the same inputs: ``seqsharded_decode_
    attention`` without dist over the whole cache, ``moe_layer`` over all
    32 experts; each rank's attention and MoE output within the stated
    tolerances, its cache pieces bit for bit. Returns the one-card times
    and the worst errors."""
    import numpy as np
    import torch
    from repro_torch.dist import collectives as C
    from repro_torch.models import layers as L
    cfg, dec, moe = _lm_inputs(dev)
    S = dec["cache"].k.shape[2]
    ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        o, kc, vc = C.seqsharded_decode_attention(
            dec["q"], dec["kn"], dec["vn"], dec["cache"].k[0],
            dec["cache"].v[0], BANK_LM_POS)
        ms.append(_sync_ms(t0))
    want = o.float().cpu().numpy()
    res = dict(attn_ms=ms, attn_err=0.0)
    for m, out in enumerate(outs):
        k = S // 4
        need(tuple(int(x) for x in out["lm_cut"]) == (1, 0, BANK_LM_B),
             f"(j) rank {m}: the cache was not cut over the bank axis")
        need(np.array_equal(out["lm_d_k"], _digest(kc[:, m * k:(m + 1) * k]))
             and np.array_equal(out["lm_d_v"],
                                _digest(vc[:, m * k:(m + 1) * k])),
             f"(j) rank {m}: its cache piece != one card's after the write")
        err = np.abs(out["lm_attn"] - want)
        res["attn_err"] = max(res["attn_err"], float(err.max()))
        need(bool((err <= BANK_LM_ATTN_TOL["atol"] + BANK_LM_ATTN_TOL["rtol"]
                   * np.abs(want)).all()),
             f"(j) rank {m}: sharded decode attention vs one card, max abs "
             f"err {err.max()}")
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x = moe["x"].to(dtype)
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            with torch.no_grad():
                y, stats = L.moe_layer(
                    x.reshape(-1, x.shape[-1]),
                    *(moe[k].to(dtype) for k in ("w_router", "w_gate",
                                                  "w_up", "w_down")),
                    top_k=cfg.moe.top_k,
                    capacity_factor=cfg.moe.capacity_factor)
            ms.append(_sync_ms(t0))
        want = y.float().reshape(x.shape).cpu().numpy()
        tol = BANK_LM_MOE_TOL[dt]
        worst = 0.0
        for m, out in enumerate(outs):
            err = np.abs(out[f"lm_moe_{dt}"] - want)
            worst = max(worst, float(err.max()))
            need(bool((err <= tol["atol"] + tol["rtol"] * np.abs(want))
                      .all()),
                 f"(j) rank {m}: moe_layer_sharded {dt} vs one card's "
                 f"moe_layer, max abs err {err.max()}")
        res[f"moe_{dt}_ms"] = ms
        res[f"moe_{dt}_err"] = worst
        res[f"moe_{dt}_dropped"] = float(stats.dropped)
        for m, out in enumerate(outs):
            need(int(out[f"lm_moe_{dt}_bwd_finite"]) == 1,
                 f"(j) rank {m}: moe_layer_sharded {dt} forward or "
                 f"backward not finite")
            need(int(out[f"lm_moe_{dt}_bwd_same"]) == 1,
                 f"(j) rank {m}: moe_layer_sharded {dt} forward and "
                 f"backward differ between two runs on the same inputs")
    return res



# phase 15 (k): GAT's edge-sharded loss at full gat-cora width
BANK_GAT_TOL = dict(rtol=0.0, atol=1e-4)   # tests/dist_checks.py:157's
BANK_GAT_STEPS = 3


def _bank_gat_inputs(dev):
    """(k)'s inputs: phase 18's Cora batch (``gat_cell_batch``) and
    ``gat-cora``'s weights at Cora's dims, drawn on the card from GAT_SEED
    (the parent's draw, handed to every rank)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import shapes as SH
    from repro_torch.models import gat as G
    b, _ = gat_cell_batch("full_graph_sm")
    cfg = SH.gat_config_for_shape(get_arch(GAT_ARCH).config,
                                  SH.GNN_CELLS["full_graph_sm"].dims)
    params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(
        GAT_SEED), device=dev)
    inp = {f"gat_b.{k}": v for k, v in b.items()}
    inp.update({f"gat_p.{i}.{k}": v.cpu().numpy()
                for i, lw in enumerate(params["layers"])
                for k, v in lw.items()})
    return inp


def _bank_gat_unpack(inp, dev):
    """(cfg, batch, params) on ``dev`` from ``_bank_gat_inputs``' arrays."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import shapes as SH
    cfg = SH.gat_config_for_shape(get_arch(GAT_ARCH).config,
                                  SH.GNN_CELLS["full_graph_sm"].dims)

    def t(x):
        return torch.from_numpy(np.array(x)).to(dev)
    batch = {k[6:]: t(v) for k, v in inp.items() if k.startswith("gat_b.")}
    layers = sorted({int(k.split(".")[1]) for k in inp
                     if k.startswith("gat_p.")})
    params = {"layers": [{k: t(inp[f"gat_p.{i}.{k}"])
                          for k in ("a_dst", "a_src", "w")} for i in layers]}
    return cfg, batch, params


def _bank_gat(inp, d22, dev):
    """(k) on the 2 x 2 grid: the edge list cut over the four ranks
    (``gnn_batch_shardings``), ``loss_full`` and the gradient of every
    leaf BANK_GAT_STEPS times (each timed), then one Adam train step under
    the grid's context; the launch counters around both."""
    import numpy as np
    from repro_torch.dist import sharding as SH
    from repro_torch.models import gat as G
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import TrainState, build_train_step
    cfg, batch, params = _bank_gat_unpack(inp, dev)
    piece, ctx = SH.gnn_batch_shardings(d22, batch)
    zero_counters()
    ms = []
    for _ in range(BANK_GAT_STEPS):
        t0 = time.perf_counter()
        loss, grads = _gat_grads(
            cfg, params, piece, lambda c, p, b: G.loss_full(c, p, b, ctx))
        ms.append(_sync_ms(t0))
    opt = O.adam(GAT_LR)
    step = build_train_step(lambda p, b, dist=None: G.loss_full(
        cfg, p, b, dist), opt, clip_norm=None, dist=ctx)
    t0 = time.perf_counter()
    _, m = step(TrainState.create(params, opt), piece)
    step_ms = _sync_ms(t0)
    out = {"gat_launches": np.array(list(read_counters().values())),
           "gat_loss": np.array([float(loss), float(m["loss"])]),
           "gat_ms": np.array(ms), "gat_step_ms": np.array([step_ms]),
           "gat_edges": np.array([int(piece["edge_src"].shape[0])])}
    for i, g in enumerate(grads):
        out[f"gat_grad.{i}"] = g.cpu().numpy()
    return out


def _bank_gat_check(outs, inp, dev):
    """(k)'s one-card results on the same inputs: ``loss_full`` and every
    gradient without dist (each timed); every rank's loss, its step's loss
    and every gradient within BANK_GAT_TOL of them. Returns the one-card
    times and the worst errors."""
    import numpy as np
    from repro_torch.models import gat as G
    cfg, batch, params = _bank_gat_unpack(inp, dev)
    ms = []
    for _ in range(BANK_GAT_STEPS):
        t0 = time.perf_counter()
        loss, grads = _gat_grads(cfg, params, batch, G.loss_full)
        ms.append(_sync_ms(t0))
    want = [g.cpu().numpy() for g in grads]
    res = dict(ms=ms, loss=float(loss), loss_err=0.0, grad_err=0.0)
    for r, o in enumerate(outs):
        err = float(np.abs(o["gat_loss"] - float(loss)).max())
        res["loss_err"] = max(res["loss_err"], err)
        need(err <= BANK_GAT_TOL["atol"],
             f"(k) rank {r}: edge-sharded loss {o['gat_loss']} vs one card's"
             f" {float(loss)}")
        for i, w in enumerate(want):
            e = np.abs(o[f"gat_grad.{i}"] - w)
            res["grad_err"] = max(res["grad_err"], float(e.max()))
            need(bool((e <= BANK_GAT_TOL["atol"]
                       + BANK_GAT_TOL["rtol"] * np.abs(w)).all()),
                 f"(k) rank {r}: gradient of leaf {i} vs one card's, max abs"
                 f" err {e.max()}")
    return res



def bank_axis_rank(rank, world, inp):
    """One rank of phase 15: a 1 x 4 grid and a 2 x 2 grid over the same
    four ranks (one card each under NCCL, all on card 0 under gloo)."""
    import numpy as np
    import torch
    from repro_torch.core.embedding import DistCtx
    torch.cuda.set_device(rank % torch.cuda.device_count())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d14, d22 = DistCtx.create(1, 4), DistCtx.create(2, 2)
    dev = d14.device
    out = _bank_serve(inp, d14, dev)
    torch.cuda.empty_cache()
    out.update(_bank_migrate_reduced(d14, dev))
    out.update(_bank_train(inp, d22, dev))
    torch.cuda.empty_cache()
    out.update(_bank_dp_step(d22, dev))
    torch.cuda.empty_cache()
    out.update(_bank_retrieval(inp, d14, dev))
    out.update(_bank_compress(inp, d14, dev))
    torch.cuda.empty_cache()
    out.update(_bank_lanes(inp, d14, dev))
    out.update(_bank_lm(inp, d14, dev))
    out.update(_bank_gat(inp, d22, dev))
    out["device"] = np.array(str(dev))
    return out


def _check_bank_retrieval(outs, ref):
    """(f): every rank's scores are its quarter of the single-device
    scores (SCORE_TOL) and no more; every rank returns the same top k,
    within SCORE_TOL of the single-device top k, each id's single-device
    score the value at its rank, copies of a candidate id lowest index
    first; rows 2q and 2f on each rank's piece within DOT_TOL of their
    plain version."""
    import torch
    n = ref["scores"].shape[0]
    k = n // 4
    for r, o in enumerate(outs):
        got = torch.from_numpy(o["r_scores"])
        want = ref["scores"][r * k:(r + 1) * k]
        need(got.shape == want.shape,
             f"bank retrieval rank {r}: scored {tuple(got.shape)} "
             f"candidates, its piece is {tuple(want.shape)}")
        need(bool(close(got, want).all()),
             f"bank retrieval rank {r}: scores vs single device, max abs "
             f"err {(got - want).abs().max().item()}")
        need(bool(o["r_dot_ok"]),
             f"bank retrieval rank {r}: row 2f vs plain, max abs err "
             f"{float(o['r_dot_err'])}")
        need(bool(o["r_query_ok"]),
             f"bank retrieval rank {r}: row 2q vs plain, max abs err "
             f"{float(o['r_query_err'])}")
        need((o["r_vals"] == outs[0]["r_vals"]).all()
             and (o["r_ids"] == outs[0]["r_ids"]).all(),
             f"bank retrieval rank {r}: its top k differs from rank 0's")
    check_topk("bank retrieval top-k", torch.from_numpy(outs[0]["r_vals"]),
               torch.from_numpy(outs[0]["r_ids"]), ref["scores"],
               ref["vals"], ref["cand"])


def _check_bank_compress(outs, ref) -> bool:
    """(g) and (h): the fixed tree's compression bit for bit on every rank
    (and a shard at its own max differs, but on bank 2, which holds the
    max); the two compressed steps within phase 15 (b)'s tolerances of
    the single-device steps (losses rtol 1e-4, touched rows, errors and
    accumulators TRAIN_TOL, dense params DENSE_TOL; no other row moved);
    the clipped norm within rtol 1e-6. Returns whether the steps were
    also equal bit for bit."""
    import numpy as np
    rpb, touched, bits = ref["rpb"], ref["touched"], True
    for r, o in enumerate(outs):
        need(bool(o["cmp_tree_equal"]),
             f"bank compress rank {r}: compress_roundtrip(dist) of the "
             f"shards != the whole tree's rows")
        need(bool(o["cmp_tree_own_differs"]) == (r != 2),
             f"bank compress rank {r}: a shard at its own max "
             f"{'equals' if r != 2 else 'differs from'} the whole tree's")
        need(np.allclose(o["cmp_losses"], ref["losses"], rtol=1e-4),
             f"bank compress rank {r}: losses {o['cmp_losses']} vs "
             f"{ref['losses']}")
        sel = (touched >= r * rpb) & (touched < (r + 1) * rpb)
        for name, tol in (("rows", TRAIN_TOL), ("err", TRAIN_TOL),
                          ("acc", TRAIN_TOL)):
            got, want = o[f"cmp_{name}"], ref[name][sel]
            need(np.allclose(got, want, **tol),
                 f"bank compress rank {r}: {name} vs single device: "
                 + worst_line(got, want, tol))
            bits &= bool(np.array_equal(got, want))
        need(np.allclose(o["cmp_dense"], ref["dense"], **DENSE_TOL),
             f"bank compress rank {r}: dense params vs single device: "
             + worst_line(o["cmp_dense"], ref["dense"], DENSE_TOL))
        bits &= bool(np.array_equal(o["cmp_dense"], ref["dense"])
                     and np.array_equal(o["cmp_losses"], ref["losses"]))
        need(o["cmp_changed_elsewhere"] == 0,
             f"bank compress rank {r}: {o['cmp_changed_elsewhere']} "
             f"untouched rows changed")
        need(np.isclose(float(o["clip_norm"]), ref["clip_norm"], rtol=1e-6,
                        atol=0),
             f"bank clip rank {r}: grad norm {float(o['clip_norm'])!r} vs "
             f"single device {ref['clip_norm']!r}")
        need(np.isclose(float(o["clip_loss"]), ref["clip_loss"], rtol=1e-5),
             f"bank clip rank {r}: loss {float(o['clip_loss'])!r} vs "
             f"{ref['clip_loss']!r}")
    print(f"  (g) the two compressed steps equal the single-device steps "
          f"bit for bit: {bits}")
    return bits


def bank_axis_phase(dev, spec, plans, pop, card):
    """Phase 15: the bank axis. Four ranks of one ``torch.distributed``
    world (NCCL, one rank a card, where 4 cards are visible; else gloo,
    all four on card 0), launched by ``dist.launch.run_ranks``, each a 1 x
    4 (bank) grid and a 2 x 2 (data x bank) grid; the parent computes the
    single-device references on the card first:

      (a) serve 256 requests at batch 64, full width, over a 4-bank §3.2
          plan of phase 2's popularity: scores within SCORE_TOL of the
          single-device port's; each rank's partials equal ``banked_bag``
          with my = its bank on the whole table and ``banked_bag_plain`` on
          the shard, bit for bit; then one batch each through the sharded
          cached, tiered and CSR lookups (``_bank_other_lookups``): each
          kernel's partial equals its plain version on the shard, and the
          lookup the bank sum of it, bit for bit;
      (b) 4 DP train steps at full width on a 2-bank plan, batch 64 (32 a
          dp rank): losses, each step's dense gradient norm, the touched
          table rows and their Adagrad accumulators (every other row and
          accumulator must not change) within TRAIN_TOL, the dense params
          within DENSE_TOL, of ``launch.train.run``'s loop on one device
          (``_bank_train_ref``; the norm and the accumulator scale with the
          gradient, the Adam and Adagrad updates do not); a bank's scatter
          equals the single-device scatter's rows bit for bit;
      (c) the compact migration to a drifted plan (``bank_plans``: 1 % of
          the rows swap banks) against the single-device migration, bit
          for bit; both exchanges at the reduced size (the full one sums
          a buffer of the whole packed size), fp32 and bf16;
      (d) bank 3 dead: the degraded step through
          ``build_recsys_serve_degraded_adaptive``; every bag within
          EMB_TOL of the single-device fault lane's (the dead reads zero
          on both); the dead bank's rank adds 0;
      (e) the compressed DP step (reduced dlrm-rm2, dp over all 4 ranks):
          the int8 psum bit for bit against its formula, and converging
          like the uncompressed step.
      (i) the adaptive runtime under dist (``_bank_lanes``): one
          cache-aware drift replan, every rank observing the global
          batches, drives a swap of the cache lane and one of the int4
          tier lane; ``migrate_aux`` of an Adagrad accumulator; each rank's shards (EMT, cache table, TieredTable,
          accumulator) against the single-device builds from the same
          plan, cache plan and tiers, bit for bit (SHA-256 digests); the
          sharded cached and tiered kernels on the batch in flight and the
          next against their plain versions, bit for bit;
      (j) the LM family's sharded paths at granite-moe-1b-a400m widths
          (``_bank_lm``): one ``seqsharded_decode_attention`` step and one
          ``moe_layer_sharded`` layer (32 experts over 4 banks) against
          one card's, within BANK_LM_ATTN_TOL and BANK_LM_MOE_TOL; that
          layer's forward and backward run twice bit-equal on each rank;
      (k) GAT's edge-sharded ``loss_full`` at full gat-cora width on Cora
          (``_bank_gat``), 2 x 2: the edge list cut over the four ranks by
          ``gnn_batch_shardings``, the loss and every gradient against
          one card's within BANK_GAT_TOL, one Adam step under the grid's
          context (its loss held too); no kernel of the table runs.

    Every main path runs with the counters set to 0 just before and read
    just after, on every rank; the launches are summed over the ranks."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.core.partitioning import uniform_partition
    from repro_torch.dist.launch import run_ranks
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    from repro_torch.train import optim as O
    cfg = spec.config
    n_cards = torch.cuda.device_count()
    backend = "nccl" if n_cards >= 4 else "gloo"
    t0 = time.perf_counter()
    V0, F = cfg.vocab_sizes[0], cfg.n_sparse
    plan4, drift = plans() if callable(plans) else plans
    plan2 = uniform_partition(cfg.total_vocab, 2)
    plans_s = time.perf_counter() - t0
    # (a) the single-device scores on the card
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(BANK_SEED), plan=plan4,
        device=dev)
    rng = np.random.default_rng(BANK_SEED)
    n_b = BANK_REQUESTS // 64
    sp = np.stack([holey(rng.choice(V0, size=(64, F, cfg.multi_hot),
                                    p=pop).astype(np.int32), rng)
                   for _ in range(n_b)])
    dense = rng.standard_normal((n_b, 64, cfg.n_dense)).astype(np.float32)
    serve = build_recsys_serve(dlrm, cfg, statics)
    want = torch.cat([serve(params, {
        "dense": torch.from_numpy(dense[i]).to(dev),
        "sparse": torch.from_numpy(sp[i]).to(dev)}) for i in range(n_b)])
    del params, statics
    torch.cuda.empty_cache()
    # (b) the single-device training
    ref_losses, ref_norms, ref_state = _bank_train_ref(spec, plan2, dev)
    batch_fn = make_batch_fn(spec, cfg)
    offs = cfg.field_offsets()
    rows = np.concatenate([
        (lambda s: (s + offs[None, :, None])[s >= 0])(
            batch_fn(64, 0, i)["sparse"]) for i in range(BANK_TRAIN_STEPS)])
    rpb2 = int(plan2.max_rows_per_bank)
    touched = np.unique(plan2.bank_of_row[rows].astype(np.int64) * rpb2
                        + plan2.slot_of_row[rows])
    touched_t = torch.from_numpy(touched).to(dev)
    ref_rows = ref_state.params["emb_packed"][touched_t].cpu().numpy()
    ref_acc = ref_state.opt_state["true"][0][touched_t].cpu().numpy()
    ref_dense = torch.cat([x.reshape(-1) for x in O.tree_leaves(
        {"bot": ref_state.params["bot"], "top": ref_state.params["top"]})]) \
        .cpu().numpy()
    del ref_state, touched_t
    torch.cuda.empty_cache()
    # (f), (g), (h): the single-device retrieval, compressed and clipped
    # runs on the card
    r_inp, r_ref = _bank_retrieval_ref(dev)
    k_inp = _bank_gat_inputs(dev)
    g_inp, g_ref = _bank_compress_ref(dev)
    ref_s = time.perf_counter() - t0 - plans_s
    work = OUT / "bank_axis"
    shutil.rmtree(work, ignore_errors=True)
    t1 = time.perf_counter()
    outs = run_ranks(bank_axis_rank, 4, work, backend=backend, timeout=600,
                     inputs=dict(p4_bank=plan4.bank_of_row,
                                 p4_slot=plan4.slot_of_row,
                                 pd_bank=drift.bank_of_row,
                                 pd_slot=drift.slot_of_row,
                                 p2_bank=plan2.bank_of_row,
                                 p2_slot=plan2.slot_of_row,
                                 s_sparse=sp, s_dense=dense,
                                 touched=touched, **r_inp, **g_inp,
                                 **k_inp))
    ranks_s = time.perf_counter() - t1
    shutil.rmtree(work, ignore_errors=True)
    names = list(all_counters())
    launches = {}
    for path in ("serve", "degraded", "train", "dp", "cached", "tiered",
                 "csr", "retrieval", "cmp", "clip", "lane_cflight",
                 "lane_cafter", "lane_tflight", "lane_tafter", "gat"):
        tot = sum(o[f"{path}_launches"] for o in outs)
        launches[path] = {k: int(v) for k, v in zip(names, tot) if v}
    step = [float(np.median(o["serve_rep_ms"])) for o in outs]
    psum = [float(np.median(o["psum_ms"])) for o in outs]
    train = [float(np.median(o["train_step_ms"][1:])) for o in outs]
    dp = [float(np.median(o["dp_step_ms"][1:])) for o in outs]
    mig = [float(o["migrate_s"]) for o in outs]
    where = (f"{backend}, 4 ranks on {n_cards if backend == 'nccl' else 1} "
             f"card(s), {n_cards} visible")
    print(f"bank axis ({where}): grids 1 x 4 and 2 x 2; waited {plans_s:.1f} "
          f"s for the plans, single-device references {ref_s:.1f} s, ranks "
          f"{ranks_s:.1f} s [{card}]")
    print(f"  (a) serve {BANK_REQUESTS} requests at batch 64, full width: "
          f"step ms per rank {', '.join(f'{x:.3f}' for x in step)}; bank sum "
          f"of (512, 32) fp32 ms {', '.join(f'{x:.3f}' for x in psum)} "
          f"({100 * np.median(psum) / np.median(step):.1f}% of the step); "
          f"scores within SCORE_TOL, partials bit for bit; launches "
          f"{launches['serve']}")
    print(f"  (a) sharded lookups of one batch (cached, Lc "
          f"{BANK_CACHE_LEN}; tiered; CSR): kernel partial == plain on the "
          f"shard and output == bank sum of it, bit for bit; launches "
          f"cached {launches['cached']}, tiered {launches['tiered']}, csr "
          f"{launches['csr']}")
    print(f"  (b) DP train {BANK_TRAIN_STEPS} steps, 2 x 2, full width: "
          f"losses {', '.join(f'{x:.6f}' for x in outs[0]['train_losses'])} "
          f"(single device {', '.join(f'{x:.6f}' for x in ref_losses)}); "
          f"step ms per rank {', '.join(f'{x:.3f}' for x in train)}; "
          f"{touched.size} touched rows and their Adagrad accumulators "
          f"within rtol 1e-4 / atol 1e-6; grad norms "
          f"{', '.join(f'{x:.6f}' for x in outs[0]['train_grad_norms'])} "
          f"(single device {', '.join(f'{x:.6f}' for x in ref_norms)}); "
          f"launches {launches['train']}")
    print(f"  (c) compact migration of {int(outs[0]['moved_rows'])} moved "
          f"rows, full width: s per rank {', '.join(f'{x:.3f}' for x in mig)}"
          f", bit for bit; both exchanges at the reduced size bit for bit")
    print(f"  (d) bank 3 dead: {int(outs[0]['degraded_reads'])} degraded "
          f"reads; every bag within atol 1e-5 of the single-device fault "
          f"lane's, the dead rank adds 0; launches {launches['degraded']}")
    print(f"  (e) compressed DP step (reduced dlrm-rm2, dp 4): psum_int8 bit "
          f"for bit; losses {outs[0]['dp_losses'][0]:.6f} -> "
          f"{outs[0]['dp_losses'][-1]:.6f} (uncompressed "
          f"{outs[0]['dp_ref_losses'][-1]:.6f}); step ms per rank "
          f"{', '.join(f'{x:.3f}' for x in dp)}; launches {launches['dp']}")
    r_ms = [float(np.median(o["r_ms"])) for o in outs]
    cmp_ms = [float(np.median(o["cmp_step_ms"][1:])) for o in outs]
    print(f"  (f) retrieval, 1 x 4, {_bank_retrieval_cfg().name} (fields "
          f"capped at {BANK_RETRIEVAL_ROWS:,} rows; widths uncut), "
          f"{BANK_RETRIEVAL_N:,} candidates spread, top "
          f"{BANK_RETRIEVAL_TOP_K}: query ms per rank "
          f"{', '.join(f'{x:.3f}' for x in r_ms)} (first "
          f"{', '.join(f'{float(o['r_first_ms']):.1f}' for o in outs)}); "
          f"peak GiB per rank "
          f"{', '.join(f'{float(o['r_peak']) / 2**30:.3f}' for o in outs)};"
          f" rows 2q and 2f at "
          f"{tuple(int(x) for x in outs[0]['r_dot_shape'])} vs plain max "
          f"abs err {max(float(o['r_query_err']) for o in outs):.3g} and "
          f"{max(float(o['r_dot_err']) for o in outs):.3g}; launches "
          f"{launches['retrieval']}")
    print(f"  (g) compressed train, 1 x 4, full width on 4 contiguous "
          f"banks: fixed tree's compression bit for bit on every rank; "
          f"losses {', '.join(f'{x:.6f}' for x in outs[0]['cmp_losses'])} "
          f"(single device "
          f"{', '.join(f'{x:.6f}' for x in g_ref['losses'])}); step ms per "
          f"rank {', '.join(f'{x:.3f}' for x in cmp_ms)}; launches "
          f"{launches['cmp']}")
    print(f"  (h) clip over every leaf, table shards included: grad norm "
          f"{float(outs[0]['clip_norm']):.9g} (single device "
          f"{g_ref['clip_norm']:.9g}); launches {launches['clip']}")
    row_sel = [(touched >= (r % 2) * rpb2) & (touched < (r % 2 + 1) * rpb2)
               for r in range(4)]
    for what, pairs in (
            ("dense params", [(o["train_dense"], ref_dense) for o in outs]),
            ("touched rows", [(o["train_rows"], ref_rows[row_sel[r]])
                              for r, o in enumerate(outs)])):
        print(f"  (b) {what} vs single device, rtol 1e-4 / atol 1e-6: "
              + "; ".join(worst_line(g, w, TRAIN_TOL) for g, w in pairs))
    want_h = want.cpu()
    for r, o in enumerate(outs):
        got = torch.from_numpy(o["scores"])
        need(bool(close(got, want_h).all()),
             f"bank axis rank {r}: scores vs single device, max abs err "
             f"{(got - want_h).abs().max().item()}")
        need(bool(o["partials_equal"]),
             f"bank axis rank {r}: its partials != banked_bag with my = {r} "
             f"on the whole table")
        need(o["degraded_err"] <= EMB_TOL["atol"],
             f"bank axis rank {r}: degraded bags vs the single-device fault "
             f"lane's, max abs err {o['degraded_err']}")
        need(bool(o["migrate_equal"]) and bool(o["migrate_reduced_equal"]),
             f"bank axis rank {r}: sharded migration != single-device")
        need(bool(o["scatter_equal"]),
             f"bank axis rank {r}: a bank's scatter != the single-device "
             f"scatter's rows")
        need(bool(o["psum_int8_equal"]),
             f"bank axis rank {r}: psum_int8 != its formula")
        lc, lr = o["dp_losses"], o["dp_ref_losses"]
        need(lc[-1] < lc[0] and abs(lc[-1] - lr[-1]) < 0.15
             and abs(lc[0] - lr[0]) <= 1e-5,
             f"bank axis rank {r}: compressed DP losses {lc} vs {lr}")
        need(np.allclose(o["train_losses"], ref_losses, rtol=1e-4),
             f"bank axis rank {r}: DP losses {o['train_losses']} vs "
             f"{ref_losses}")
        need(o["train_changed_elsewhere"] == 0,
             f"bank axis rank {r}: {o['train_changed_elsewhere']} untouched "
             f"rows changed")
        need(np.allclose(o["train_grad_norms"], ref_norms, **TRAIN_TOL),
             f"bank axis rank {r}: DP gradient norms "
             f"{o['train_grad_norms']} vs {ref_norms}")
        for name in ("cached", "tiered", "csr"):
            need(bool(o[f"{name}_partial_equal"]),
                 f"bank axis rank {r}: the sharded {name} lookup's kernel "
                 f"partial != its plain version on the same shard")
            need(bool(o[f"{name}_sum_equal"]),
                 f"bank axis rank {r}: the sharded {name} lookup != the "
                 f"bank sum of the plain partials")
        need(np.allclose(o["train_dense"], ref_dense, **DENSE_TOL),
             f"bank axis rank {r}: dense params vs single device, max abs "
             f"err {np.abs(o['train_dense'] - ref_dense).max()}")
    for r in range(4):
        got, ref = outs[r]["train_rows"], ref_rows[row_sel[r]]
        need(np.allclose(got, ref, **TRAIN_TOL),
             f"bank axis rank {r}: trained rows vs single device, max abs "
             f"err {np.abs(got - ref).max()}")
        got, ref = outs[r]["train_acc"], ref_acc[row_sel[r]]
        need(np.allclose(got, ref, **TRAIN_TOL),
             f"bank axis rank {r}: Adagrad accumulators vs single device, "
             f"max abs err {np.abs(got - ref).max()}")
    _check_bank_retrieval(outs, r_ref)
    cmp_bits = _check_bank_compress(outs, g_ref)
    t2 = time.perf_counter()
    lanes_ref = _bank_lanes_check(outs, dict(p4_bank=plan4.bank_of_row,
                                             p4_slot=plan4.slot_of_row), dev)
    lm_ref = _bank_lm_check(outs, dev)
    gat_ref = _bank_gat_check(outs, k_inp, dev)
    checks_s = time.perf_counter() - t2
    o0 = outs[0]
    lane_s = {k: [float(o[f"lane_{k}_s"]) for o in outs] for k in (
        "cache_setup", "tier_setup", "check", "aux", "cache_swap",
        "cache_migrate", "tier_swap")}
    print(f"  (i) the runtime's lanes under dist, 1 x 4, full width, one "
          f"cache-aware drift replan driving both swaps: cache lane swap "
          f"({int(o0['lane_moved']):,} rows change bank, entries "
          f"{int(o0['lane_c_event'][1])}, dropped "
          f"{int(o0['lane_c_event'][2])}) and int4 tier lane swap (promoted "
          f"{int(o0['lane_t_event'][1])}, demoted "
          f"{int(o0['lane_t_event'][2])}, re-quantized "
          f"{int(o0['lane_t_event'][3])}): each rank's cache table, "
          f"TieredTable and migrate_aux'd accumulator == its bank's "
          f"slice of the single-device build from the same plan, cache plan"
          f" and tiers, bit for bit; the batch in flight and the next, "
          f"kernel partial == plain and lookup == bank sum, bit for bit; "
          f"s per rank: " + "; ".join(
              f"{k} {', '.join(f'{x:.2f}' for x in v)}"
              for k, v in lane_s.items())
          + f"; single-device builds cache {lanes_ref['cache_ref_s']:.1f} s,"
          f" tier {lanes_ref['tier_ref_s']:.1f} s; launches cache "
          f"{launches['lane_cflight']} + {launches['lane_cafter']}, tiered "
          f"{launches['lane_tflight']} + {launches['lane_tafter']}")
    def bwd_ms(dt):
        return "; ".join(", ".join(f"{x:.3f}" for x in ms) for ms in (
            o[f"lm_moe_{dt}_bwd_ms"] for o in outs))
    print(f"  (j) {BANK_LM_ARCH} widths, 1 x 4: seqsharded_decode_attention "
          f"(batch {BANK_LM_B}, cache {BANK_LM_S} cut over the bank axis, "
          f"new row at {BANK_LM_POS}) ms per rank "
          f"{', '.join(f'{float(np.median(o['lm_attn_ms'][1:])):.3f}' for o in outs)}"
          f" (one card {float(np.median(lm_ref['attn_ms'][1:])):.3f}), max "
          f"abs err {lm_ref['attn_err']:.3g}, cache pieces bit for bit; "
          f"moe_layer_sharded ({BANK_LM_TOKENS} tokens, 8 of 32 experts a "
          f"rank) fp32 ms per rank "
          f"{', '.join(f'{float(np.median(o['lm_moe_f32_ms'][1:])):.3f}' for o in outs)}"
          f" (one card {float(np.median(lm_ref['moe_f32_ms'][1:])):.3f}), "
          f"max abs err {lm_ref['moe_f32_err']:.3g}; bf16 ms "
          f"{', '.join(f'{float(np.median(o['lm_moe_bf16_ms'][1:])):.3f}' for o in outs)}"
          f" (one card {float(np.median(lm_ref['moe_bf16_ms'][1:])):.3f}), "
          f"max abs err {lm_ref['moe_bf16_err']:.3g}; one card dropped "
          f"{lm_ref['moe_bf16_dropped']:.4f} of the slots; forward and "
          f"backward run twice bit-equal on every rank, fp32 and bf16, ms "
          f"of the two runs per rank fp32 {bwd_ms('f32')}, bf16 "
          f"{bwd_ms('bf16')}; checks {checks_s:.1f} s")
    print(f"  (k) {GAT_ARCH} full width on Cora (2,708 nodes, 10,556 edges, "
          f"1,433 features), 2 x 2, the edge list cut over the four ranks "
          f"({int(outs[0]['gat_edges'][0]):,} a rank): loss_full and every "
          f"gradient ms per rank "
          f"{', '.join(f'{float(np.median(o['gat_ms'][1:])):.3f}' for o in outs)}"
          f" (one card {float(np.median(gat_ref['ms'][1:])):.3f}); loss "
          f"{gat_ref['loss']:.6f}, max abs err of the loss "
          f"{gat_ref['loss_err']:.3g} and of the gradients "
          f"{gat_ref['grad_err']:.3g} (atol {BANK_GAT_TOL['atol']:g}); one "
          f"Adam step under the grid ms per rank "
          f"{', '.join(f'{float(o['gat_step_ms'][0]):.1f}' for o in outs)}; "
          f"launches {launches['gat']}")
    need(not launches["gat"], f"bank axis gat: launches {launches['gat']} "
                              f"(GAT runs no kernel of the table)")
    need(outs[3]["dead_partial_max"] == 0,
         f"bank axis: the dead bank's rank added {outs[3]['dead_partial_max']}")
    need(all(o["dead_partial_max"] > 0 for o in outs[:3]),
         "bank axis: a live bank's rank added nothing")
    for path, kernels in (("serve", ("banked_bag", "dot_features")),
                          ("degraded", ("banked_bag", "dot_features")),
                          ("train", ("banked_bag", "ct_scatter_bag",
                                     "dot_features")),
                          ("dp", ("dot_features",)),
                          ("cached", ("cache_residual_bag",)),
                          ("tiered", ("tiered_bag",)),
                          ("csr", ("csr_bag",)),
                          ("retrieval", ("dot_features_query",)),
                          ("cmp", ("banked_bag", "ct_scatter_bag",
                                   "dot_features")),
                          ("clip", ("banked_bag", "ct_scatter_bag",
                                    "dot_features")),
                          ("lane_cflight", ("cache_residual_bag",)),
                          ("lane_cafter", ("cache_residual_bag",)),
                          ("lane_tflight", ("tiered_bag",)),
                          ("lane_tafter", ("tiered_bag",))):
        for k in kernels:
            need(launches[path].get(k, 0) > 0,
                 f"bank axis {path}: no {k} launch")
        need(launches[path].get("dot_interaction", 0) == 0,
             f"bank axis {path}: the unfused dot_interaction entry ran")
    need(launches["retrieval"].get("dot_features", 0) == 0,
         "bank axis retrieval: the batch entry ran, not the query entry")
    run = {}
    for path in launches.values():
        for k, v in path.items():
            run[k] = run.get(k, 0) + v
    return dict(backend=backend, cards=n_cards, devices=[
        str(o["device"]) for o in outs], plans_s=plans_s, ref_s=ref_s,
        ranks_s=ranks_s, serve_step_ms=step, bank_sum_ms=psum,
        train_step_ms=train, dp_step_ms=dp, migrate_s=mig,
        moved_rows=int(outs[0]["moved_rows"]), launches=launches,
        train_losses=outs[0]["train_losses"].tolist(),
        ref_train_losses=ref_losses.tolist(),
        dp_losses=outs[0]["dp_losses"].tolist(),
        train_grad_norms=outs[0]["train_grad_norms"].tolist(),
        ref_train_grad_norms=ref_norms.tolist(), retrieval=dict(
            n=BANK_RETRIEVAL_N, top_k=BANK_RETRIEVAL_TOP_K,
            field_rows_cap=BANK_RETRIEVAL_ROWS, query_ms=r_ms,
            first_ms=[float(o["r_first_ms"]) for o in outs],
            peak_bytes=[int(o["r_peak"]) for o in outs],
            dot_shape=outs[0]["r_dot_shape"].tolist(),
            dot_max_abs_err=max(float(o["r_dot_err"]) for o in outs),
            query_max_abs_err=max(float(o["r_query_err"]) for o in outs)),
        compressed=dict(losses=outs[0]["cmp_losses"].tolist(),
                        ref_losses=g_ref["losses"].tolist(),
                        step_ms=cmp_ms, bit_equal=cmp_bits),
        clipped=dict(grad_norm=float(outs[0]["clip_norm"]),
                     ref_grad_norm=g_ref["clip_norm"]),
        lanes=dict(moved_rows=int(o0["lane_moved"]),
                   cache_event=o0["lane_c_event"].tolist(),
                   tier_event=o0["lane_t_event"].tolist(), seconds=lane_s,
                   **lanes_ref),
        lm=dict(rank_attn_ms=[o["lm_attn_ms"].tolist() for o in outs],
                rank_moe_f32_ms=[o["lm_moe_f32_ms"].tolist() for o in outs],
                rank_moe_bf16_ms=[o["lm_moe_bf16_ms"].tolist()
                                  for o in outs],
                rank_moe_bwd_ms={dt: [o[f"lm_moe_{dt}_bwd_ms"].tolist()
                                      for o in outs]
                                 for dt in ("f32", "bf16")},
                **lm_ref),
        gat=dict(rank_ms=[o["gat_ms"].tolist() for o in outs],
                 rank_step_ms=[float(o["gat_step_ms"][0]) for o in outs],
                 rank_losses=[o["gat_loss"].tolist() for o in outs],
                 **gat_ref)), run


# ---------------------------------------------------------------------------
# phase 16: the recommendation zoo (DIN, xDeepFM, BERT4Rec)
# ---------------------------------------------------------------------------

ZOO_REQUESTS, ZOO_BATCH, ZOO_TRAIN_STEPS, ZOO_TOP_K = 256, 64, 4, 128
# retrieval's N: BERT4Rec the reference's 10^6; DIN and xDeepFM the largest
# power of ten whose peak stays under 40 GiB (no chunking of candidates, as
# the reference): DIN's (N, 100, 144) attention input is ~58 KB a candidate
# before its MLP, xDeepFM's CIN outer product (N, 200, 39, 10) ~312 KB
ZOO_RETRIEVAL_N = {"din": 100_000, "xdeepfm": 10_000, "bert4rec": 1_000_000}
ZOO_SEED = 16


def _zoo_query(spec, cfg, n, rng):
    """One retrieval query of ``spec``'s family with ``n`` candidates
    drawn with repeats (numpy)."""
    import numpy as np
    from repro_torch.data import synthetic as syn
    fam = spec.family
    if fam == "din":
        b = syn.din_batch(cfg.n_items, cfg.n_cates, cfg.seq_len, 1,
                          seed=ZOO_SEED, step=0)
        return {"hist_items": b["hist_items"], "hist_cates": b["hist_cates"],
                "candidates": rng.integers(0, cfg.n_items, n).astype(
                    np.int32),
                "candidate_cates": rng.integers(0, cfg.n_cates, n).astype(
                    np.int32)}
    if fam == "xdeepfm":
        return {"sparse": syn.xdeepfm_batch(cfg.vocab_sizes, 1, seed=ZOO_SEED,
                                            step=0)["sparse"],
                "candidates": rng.integers(0, cfg.vocab_sizes[0], n).astype(
                    np.int32)}
    return {"items": syn.bert4rec_batch(cfg.n_items, cfg.seq_len, 1,
                                        seed=ZOO_SEED, step=0)["items"],
            "candidates": rng.integers(0, cfg.n_items, n).astype(np.int32)}


def _zoo_rescore(spec, cfg, mod, params, statics, q, ids):
    """The top k's candidates scored again through the family's own
    forward path: DIN with ``target`` = the candidate, xDeepFM with field
    0 replaced, BERT4Rec through ``next_item_scores`` on those
    candidates."""
    import torch
    ids = ids.reshape(-1).long()
    cand = q["candidates"][ids]
    with torch.inference_mode():
        if spec.family == "din":
            k = cand.shape[0]
            return mod.forward(cfg, params, statics, {
                "hist_items": q["hist_items"].expand(k, -1),
                "hist_cates": q["hist_cates"].expand(k, -1),
                "target_item": cand,
                "target_cate": q["candidate_cates"][ids]})
        if spec.family == "xdeepfm":
            sp = q["sparse"].expand(cand.shape[0], -1).clone()
            sp[:, 0] = cand
            return mod.forward(cfg, params, statics, {"sparse": sp})
        return mod.next_item_scores(cfg, params, statics, {
            "items": q["items"], "candidates": cand}).reshape(-1)


def _zoo_reduced(dev, spec):
    """The reduced config on the card against the CPU, the same weights:
    logits (or BERT4Rec's hidden states), the loss and the retrieval
    scores within SCORE_TOL."""
    import numpy as np
    import torch
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import family_module
    mod, cfg = family_module(spec.family), spec.reduced
    params, statics = mod.init_params(cfg, torch.Generator().manual_seed(3),
                                      device="cpu")
    b = {k: torch.from_numpy(v) for k, v in
         make_batch_fn(spec, cfg)(8, ZOO_SEED, 0).items()}
    q = {k: torch.from_numpy(v) for k, v in _zoo_query(
        spec, cfg, 96, np.random.default_rng(ZOO_SEED)).items()}
    pd, sd, bd, qd = (to_dev(x, dev) for x in (params, statics, b, q))
    errs = {}
    with torch.inference_mode():
        if spec.family == "bert4rec":
            pairs = [("encode", mod.encode(cfg, params, statics, b["items"]),
                      mod.encode(cfg, pd, sd, bd["items"]))]
        else:
            pairs = [("logits", mod.forward(cfg, params, statics, b),
                      mod.forward(cfg, pd, sd, bd))]
        pairs += [("loss", mod.loss_fn(cfg, params, statics, b),
                   mod.loss_fn(cfg, pd, sd, bd)),
                  ("retrieval", mod.retrieval_scores(cfg, params, statics, q),
                   mod.retrieval_scores(cfg, pd, sd, qd))]
    for name, cpu, card in pairs:
        card = card.cpu()
        errs[name] = (card - cpu).abs().max().item()
        need(bool(close(card, cpu).all()),
             f"zoo {spec.arch_id} reduced, card vs CPU {name}: max abs err "
             f"{errs[name]}")
    return errs


def zoo_phase(dev, card):
    """Phase 16: DIN, xDeepFM and BERT4Rec at full width on one card, each
    through the paths a user calls, with every launch counter set to 0
    just before and read just after each (the zoo runs no kernel: its
    lookups are dense gathers, as the reference's run outside any Pallas
    kernel): the serve loop ``launch.serve.run`` for 256 requests at batch
    64 (DIN, xDeepFM: the reference's serving CLI's families), p50 and
    p99; ``launch.train.run`` for 4 steps at batch 64, the step ms; one
    retrieval query through ``build_retrieval_serve`` (N of
    ``ZOO_RETRIEVAL_N``), timed, with its peak memory; BERT4Rec's
    full-catalog ``next_item_scores`` of a batch of 64. Checks: every loss
    and score finite; the top k re-scored through the family's forward
    path within SCORE_TOL; the reduced config on the card against the CPU
    on the same weights."""
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as LS
    from repro_torch.launch import train as LT
    from repro_torch.launch.train import make_batch_fn
    from repro_torch.models import family_module
    from repro_torch.serve.serve_step import build_retrieval_serve
    out, launches = {}, {}
    for arch in ("din", "xdeepfm", "bert4rec"):
        spec = get_arch(arch)
        cfg, mod = spec.config, family_module(spec.family)
        res, t0 = {}, time.perf_counter()
        if arch in LS.SERVE_FAMILIES:
            zero_counters()
            sv = LS.run(spec, cfg, requests=ZOO_REQUESTS, batch=ZOO_BATCH,
                        seed=ZOO_SEED, device=dev)
            launches[f"{arch}.serve"] = read_counters()
            need(bool(torch.isfinite(sv.scores).all())
                 and sv.scores.shape[0] == ZOO_REQUESTS,
                 f"zoo {arch} serve: scores {tuple(sv.scores.shape)}, "
                 f"finite {bool(torch.isfinite(sv.scores).all())}")
            res["serve"] = dict(p50_ms=sv.p50_ms, p99_ms=sv.p99_ms,
                                serve_s=sv.serve_s,
                                requests_per_s=ZOO_REQUESTS / sv.serve_s)
            del sv
            torch.cuda.empty_cache()
        zero_counters()
        tr = LT.run(spec, cfg, steps=ZOO_TRAIN_STEPS, batch=ZOO_BATCH,
                    seed=ZOO_SEED, device=dev)
        launches[f"{arch}.train"] = read_counters()
        need(bool(np.isfinite(tr.losses).all()),
             f"zoo {arch} train: losses {tr.losses}")
        res["train"] = dict(losses=tr.losses, step_ms=tr.step_ms)
        params, statics = tr.state.params, tr.statics
        del tr
        torch.cuda.empty_cache()

        n = ZOO_RETRIEVAL_N[arch]
        qn = _zoo_query(spec, cfg, n, np.random.default_rng(ZOO_SEED))
        q = {k: torch.from_numpy(v).to(dev) for k, v in qn.items()}
        serve = build_retrieval_serve(mod, cfg, statics, top_k=ZOO_TOP_K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counters()
        t1 = time.perf_counter()
        vals, ids = serve(params, q)
        first = _sync_ms(t1)
        launches[f"{arch}.retrieval"] = read_counters()
        peak = torch.cuda.max_memory_allocated() - base
        ms = []
        for _ in range(3):
            t1 = time.perf_counter()
            serve(params, q)
            ms.append(_sync_ms(t1))
        need(bool(torch.isfinite(vals).all()) and vals.numel() == ZOO_TOP_K,
             f"zoo {arch} retrieval: top-k {tuple(vals.shape)}, finite "
             f"{bool(torch.isfinite(vals).all())}")
        again = _zoo_rescore(spec, cfg, mod, params, statics, q, ids)
        r_err = (again.reshape(-1) - vals.reshape(-1)).abs().max().item()
        need(bool(close(again.reshape(-1), vals.reshape(-1)).all()),
             f"zoo {arch} retrieval: the top {ZOO_TOP_K} re-scored through "
             f"the forward path, max abs err {r_err}")
        res["retrieval"] = dict(n=n, first_ms=first, ms=ms, peak_bytes=peak,
                                rescore_max_abs_err=r_err,
                                top_values=vals.reshape(-1)[:8].tolist())
        del q, vals, ids, again
        torch.cuda.empty_cache()
        if arch == "bert4rec":
            b = {k: torch.from_numpy(v).to(dev) for k, v in make_batch_fn(
                spec, cfg)(ZOO_BATCH, ZOO_SEED, 99).items()}
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            fc = []
            for _ in range(3):
                t1 = time.perf_counter()
                with torch.inference_mode():
                    cat = mod.next_item_scores(cfg, params, statics,
                                               {"items": b["items"]})
                fc.append(_sync_ms(t1))
            need(tuple(cat.shape) == (ZOO_BATCH, cfg.vocab)
                 and bool(torch.isfinite(cat).all()),
                 f"zoo bert4rec full catalog: {tuple(cat.shape)}, finite "
                 f"{bool(torch.isfinite(cat).all())}")
            res["full_catalog"] = dict(
                ms=fc, peak_bytes=torch.cuda.max_memory_allocated() - base)
            del cat, b
        del params, statics
        torch.cuda.empty_cache()
        res["reduced"] = _zoo_reduced(dev, spec)
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        sv = res.get("serve")
        print(f"zoo {arch} full width ({cfg.param_count():,} params): "
              + (f"serve {ZOO_REQUESTS} requests at batch {ZOO_BATCH} p50 "
                 f"{sv['p50_ms']:.3f} ms p99 {sv['p99_ms']:.3f} ms; "
                 if sv else "")
              + f"train step ms {', '.join(f'{x:.2f}' for x in res['train']['step_ms'])}"
              f"; retrieval N = {n:,}: {', '.join(f'{x:.2f}' for x in ms)}"
              f" ms (first {first:.1f}), peak {peak / 2**30:.3f} GiB, "
              f"re-score max abs err {r_err:.3g}"
              + (f"; full catalog of {ZOO_BATCH}: "
                 f"{', '.join(f'{x:.2f}' for x in res['full_catalog']['ms'])}"
                 f" ms, peak "
                 f"{res['full_catalog']['peak_bytes'] / 2**30:.3f} GiB"
                 if "full_catalog" in res else "")
              + f"; reduced card vs CPU {res['reduced']} [{card}]",
              flush=True)
    for path, counts in launches.items():
        for k, v in counts.items():
            need(v == 0, f"zoo {path}: {k} launched {v} times (the zoo's "
                         f"paths run no kernel)")
    return out, {}


# ---------------------------------------------------------------------------
# phase 17: the LM family at full width
# ---------------------------------------------------------------------------

LM_ARCHS = ("granite-moe-1b-a400m", "smollm-360m")   # MoE; dense GLU
# the reference's prefill_32k (32 x 32,768) and decode_32k (128 x 32,768)
# cells, cut in batch and sequence only: a prompt of 8 x 2,048, then 32
# greedy decode steps at batch 8 from its cache; widths uncut
LM_BATCH, LM_PROMPT, LM_DECODE = 8, 2048, 32
LM_TRAIN_STEPS, LM_TRAIN_BATCH = 3, 32     # the train CLI's batch, seq 64
LM_CHECK_PROMPT, LM_CHECK_STEPS = 96, 8    # the decode-vs-prefill window
LM_SEED = 17
# decode vs prefill of the same tokens, held at fp32 compute (TF32 off):
# the KV cache path against full attention, to fp32 rounding over 24-32
# layers; at the configs' bf16 the agreement is reported, not held (MoE
# routing flips on bf16 noise, and capacity drops differ between a prompt
# and a step)
LM_CONSIST_TOL = dict(rtol=1e-3, atol=1e-3)


def _lm_consistency(cfg, params, prompt, steps, dev, hold: bool):
    """Greedy decode of ``steps`` tokens from ``prefill``'s cache of
    ``prompt`` (1, P) against ``prefill`` of the prompt and the tokens
    decoded so far, step by step. ``hold``: every step's logits within
    LM_CONSIST_TOL and the same greedy token, else a failure. The MoE runs
    at a capacity factor of E / k, under which no slot is ever dropped
    (decode at batch 1 drops none either), so both paths route alike."""
    import dataclasses
    import torch
    from repro_torch.models import transformer as T
    if cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
    P = prompt.shape[1]
    with torch.inference_mode():
        logits, cache = T.prefill(cfg, params, prompt, s_max=P + steps)
        seq = prompt
        worst, agree = 0.0, 0
        for _ in range(steps):
            tok = logits[:, :cfg.vocab].argmax(-1)
            seq = torch.cat([seq, tok[:, None]], dim=1)
            logits, cache = T.decode_step(cfg, params, cache, tok)
            want = T.prefill(cfg, params, seq)
            a, b = logits[:, :cfg.vocab], want[:, :cfg.vocab]
            err = (a - b).abs()
            worst = max(worst, err.max().item())
            agree += int((a.argmax(-1) == b.argmax(-1)).all())
            if hold:
                need(bool((err <= LM_CONSIST_TOL["atol"]
                           + LM_CONSIST_TOL["rtol"] * b.abs()).all())
                     and bool((a.argmax(-1) == b.argmax(-1)).all()),
                     f"lm {cfg.name}: decode at position {seq.shape[1] - 1}"
                     f" vs prefill of the same tokens, max abs err "
                     f"{err.max().item()}")
    return dict(max_abs_err=worst, argmax_agree=agree, steps=steps)


def _lm_serve(cfg, params, dev):
    """Prefill of LM_BATCH x LM_PROMPT tokens and LM_DECODE greedy decode
    steps from its cache, through ``build_lm_prefill`` /
    ``build_lm_decode``, each timed (host clock, synchronized), with the
    peak memory of each."""
    import numpy as np
    import torch
    from repro_torch.data import synthetic as syn
    from repro_torch.serve.serve_step import build_lm_decode, build_lm_prefill
    toks = torch.from_numpy(syn.lm_batch(LM_BATCH, LM_PROMPT, cfg.vocab,
                                         seed=LM_SEED, step=0)["tokens"]) \
        .to(dev)
    prefill = build_lm_prefill(cfg, s_max=LM_PROMPT + LM_DECODE)
    decode = build_lm_decode(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    logits, cache = prefill(params, toks)
    prefill_ms = _sync_ms(t0)
    prefill_peak = torch.cuda.max_memory_allocated() - base
    need(tuple(logits.shape) == (LM_BATCH, cfg.padded_vocab)
         and bool(torch.isfinite(logits[:, :cfg.vocab]).all())
         and bool((logits[:, cfg.vocab:] == -1e30).all()),
         f"lm {cfg.name}: prefill logits {tuple(logits.shape)}")
    torch.cuda.reset_peak_memory_stats()
    step_ms, out_toks = [], []
    tok = logits[:, :cfg.vocab].argmax(-1)
    for _ in range(LM_DECODE):
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok)
        step_ms.append(_sync_ms(t0))
        need(bool(torch.isfinite(logits[:, :cfg.vocab]).all()),
             f"lm {cfg.name}: decode logits not finite")
        tok = logits[:, :cfg.vocab].argmax(-1)
        out_toks.append(tok)
    need(cache.length == LM_PROMPT + LM_DECODE,
         f"lm {cfg.name}: cache length {cache.length}")
    decode_peak = torch.cuda.max_memory_allocated() - base
    med = float(np.median(step_ms[1:]))
    return dict(prefill_ms=prefill_ms,
                prefill_tokens_per_s=LM_BATCH * LM_PROMPT / prefill_ms * 1e3,
                prefill_peak_bytes=prefill_peak, decode_step_ms=step_ms,
                decode_step_median_ms=med,
                decode_tokens_per_s=LM_BATCH / med * 1e3,
                decode_peak_bytes=decode_peak,
                greedy=torch.stack(out_toks, 1)[0, :8].tolist())


def lm_phase(dev, card):
    """Phase 17: the LM family at full width on one card, with every
    launch counter set to 0 just before and read just after each path (the
    LMs run no kernel of the table: no Pallas kernel of the reference
    serves them). For each of granite-moe-1b-a400m (24 layers, d 1,024,
    16 / 8 heads, 32 experts top 8, vocab 49,155) and smollm-360m (dense
    GLU): weights drawn from LM_SEED on the card; prefill of 8 x 2,048
    tokens and 32 greedy decode steps from its cache (tokens per second,
    ms a step, peak memory); decode against prefill of the same tokens
    (``_lm_consistency``: held at fp32 compute, reported at bf16). Then
    ``launch.train.run`` of the MoE for 3 steps at the train CLI's batch of
    32 x 64 tokens (ms a step, peak memory, finite losses), and once more
    from the same seed: every loss and every leaf of the train state
    bit-equal (the order-fixed MoE dispatch and combine)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.data import synthetic as syn
    from repro_torch.launch import train as LT
    from repro_torch.models import transformer as T
    from repro_torch.train import optim as O
    out = {}
    for arch in LM_ARCHS:
        spec = get_arch(arch)
        cfg, t0 = spec.config, time.perf_counter()
        params = T.init_params(cfg, torch.Generator(device=dev).manual_seed(
            LM_SEED), device=dev)
        zero_counters()
        res = _lm_serve(cfg, params, dev)
        launches = read_counters()
        prompt = torch.from_numpy(syn.lm_batch(
            1, LM_CHECK_PROMPT, cfg.vocab, seed=LM_SEED, step=1)["tokens"]) \
            .to(dev)
        res["consistency_bf16"] = _lm_consistency(
            cfg, params, prompt, LM_CHECK_STEPS, dev, hold=False)
        res["consistency_f32"] = _lm_consistency(
            dataclasses.replace(cfg, dtype=torch.float32), params, prompt,
            LM_CHECK_STEPS, dev, hold=True)
        del params
        torch.cuda.empty_cache()
        if arch == LM_ARCHS[0]:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            zero_counters()
            tr = LT.run(spec, cfg, steps=LM_TRAIN_STEPS,
                        batch=LM_TRAIN_BATCH, seed=LM_SEED, device=dev)
            for k, v in read_counters().items():
                launches[k] = launches.get(k, 0) + v
            need(len(tr.losses) == LM_TRAIN_STEPS
                 and all(x == x and abs(x) < 1e4 for x in tr.losses),
                 f"lm {arch} train: losses {tr.losses}")
            res["train"] = dict(
                losses=tr.losses, step_ms=tr.step_ms,
                tokens_per_s=LM_TRAIN_BATCH * 64 / min(tr.step_ms) * 1e3,
                peak_bytes=torch.cuda.max_memory_allocated() - base)
            t1 = time.perf_counter()
            zero_counters()
            again = LT.run(spec, cfg, steps=LM_TRAIN_STEPS,
                           batch=LM_TRAIN_BATCH, seed=LM_SEED, device=dev)
            for k, v in read_counters().items():
                launches[k] = launches.get(k, 0) + v
            a, b = (O.tree_flatten_with_path(
                [r.state.params, r.state.opt_state, r.state.step])
                for r in (tr, again))
            same = [pa == pb and torch.equal(x, y)
                    for (pa, x), (pb, y) in zip(a, b)]
            need(again.losses == tr.losses and len(a) == len(b)
                 and all(same),
                 f"lm {arch} train: a second run from seed {LM_SEED} "
                 f"differs (losses {again.losses} vs {tr.losses}; "
                 f"{same.count(False)} of {len(a)} state leaves differ)")
            res["train"].update(repeat_bit_equal_leaves=len(a),
                                repeat_s=time.perf_counter() - t1)
            del tr, again
            torch.cuda.empty_cache()
        for k, v in launches.items():
            need(v == 0, f"lm {arch}: {k} launched {v} times (the LM paths "
                         f"run no kernel of the table)")
        res["params"] = cfg.param_count()
        res["seconds"] = time.perf_counter() - t0
        out[arch] = res
        c16, c32 = res["consistency_bf16"], res["consistency_f32"]
        tr = res.get("train")
        print(f"lm {arch} full width ({cfg.param_count():,} params, "
              f"{cfg.n_layers} layers, d {cfg.d_model}): prefill "
              f"{LM_BATCH} x {LM_PROMPT} in {res['prefill_ms']:.1f} ms "
              f"({res['prefill_tokens_per_s']:.0f} tokens/s, peak "
              f"{res['prefill_peak_bytes'] / 2**30:.2f} GiB); {LM_DECODE} "
              f"decode steps at batch {LM_BATCH}: median "
              f"{res['decode_step_median_ms']:.2f} ms a step "
              f"({res['decode_tokens_per_s']:.0f} tokens/s, first "
              f"{res['decode_step_ms'][0]:.1f} ms, peak "
              f"{res['decode_peak_bytes'] / 2**30:.2f} GiB); decode vs "
              f"prefill over {c32['steps']} steps: fp32 max abs err "
              f"{c32['max_abs_err']:.3g} (held, rtol = atol = 1e-3), "
              f"bf16 {c16['max_abs_err']:.3g} with {c16['argmax_agree']}/"
              f"{c16['steps']} greedy tokens equal (reported)"
              + (f"; train {LM_TRAIN_STEPS} steps at {LM_TRAIN_BATCH} x 64:"
                 f" ms {', '.join(f'{x:.1f}' for x in tr['step_ms'])}, "
                 f"losses {', '.join(f'{x:.4f}' for x in tr['losses'])}, "
                 f"peak {tr['peak_bytes'] / 2**30:.2f} GiB; run again from "
                 f"the same seed in {tr['repeat_s']:.1f} s: losses and all "
                 f"{tr['repeat_bit_equal_leaves']} state leaves bit-equal"
                 if tr else "")
              + f" [{card}]", flush=True)
    return out, {}


# ---------------------------------------------------------------------------
# phase 18: GAT at its four reference cells
# ---------------------------------------------------------------------------

GAT_ARCH, GAT_SEED, GAT_STEPS, GAT_LR = "gat-cora", 18, 3, 1e-3
GAT_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg", "ogb_products")
# step 1's loss and gradient norm against a float64 recomputation on the
# card: a per-mille, for fp32 sums over in-degrees up to ~1.8 M edges
# (Zipf 0.9) that the card's index_add_ adds in no fixed order
GAT_F64_RTOL = 1e-3
# the reduced config on the card against the CPU (the CPU tests' tolerance)
GAT_RED_TOL = dict(rtol=1e-5, atol=1e-6)


def gat_cell_batch(shape: str, seed: int = GAT_SEED):
    """The numpy batch of a GNN cell at its own dims
    (``configs/shapes.GNN_CELLS``), as the reference's cells define it: a
    ``random_graph`` of the cell's nodes and edges for the full-graph cells;
    ``molecule_batch`` for ``molecule``; for ``minibatch_lg`` a
    ``random_graph`` of the 232,965-node, 114,615,892-edge graph, its CSR
    by destination, 1,024 seeds and the ``NeighborSampler``'s fanout 15-10
    blocks padded to ``sampled_block_dims``. Returns the batch and the host
    seconds of each step."""
    import numpy as np
    from repro_torch.configs import shapes as SH
    from repro_torch.data import synthetic as syn
    from repro_torch.sparse.sampler import build_csr
    d = SH.GNN_CELLS[shape].dims
    secs, t0 = {}, time.perf_counter()
    if shape == "molecule":
        b = syn.molecule_batch(d["n_graphs"], d["nodes_per"], d["edges_per"],
                               d["d_feat"], d["n_classes"], seed=seed)
        secs["molecule_batch"] = time.perf_counter() - t0
        return b, secs
    g = syn.random_graph(d["n_nodes"], d["n_edges"], d["d_feat"],
                         d["n_classes"], seed=seed)
    secs["random_graph"] = time.perf_counter() - t0
    if shape != "minibatch_lg":
        return g, secs
    t0 = time.perf_counter()
    csr = build_csr(g["edge_src"].astype(np.int64),
                    g["edge_dst"].astype(np.int64), d["n_nodes"])
    secs["build_csr"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    seeds = np.random.default_rng(seed).choice(d["n_nodes"],
                                               d["batch_nodes"],
                                               replace=False)
    b = SH.sampled_blocks(g, csr, seeds, d, seed)
    secs["sample"] = time.perf_counter() - t0
    return b, secs


def _gat_grads(cfg, params, batch, loss_fn):
    """(loss, [gradient of every param leaf]) of ``loss_fn`` at
    ``params``: the gradient the train step's first step takes."""
    import torch
    from repro_torch.train import optim as O
    leaves = [p.detach().requires_grad_(True) for p in O.tree_leaves(params)]
    loss = loss_fn(cfg, O.tree_unflatten(params, leaves), batch)
    return loss.detach(), list(torch.autograd.grad(loss, leaves))


def _gat_norm(grads) -> float:
    import torch
    return float(torch.sqrt(sum((g.double() ** 2).sum() for g in grads)))


def _gat_reduced(dev, shape):
    """The reduced config's loss and every gradient at the cell's smoke
    batch on the card against the CPU, the same weights: the worst error
    (held within GAT_RED_TOL)."""
    import numpy as np
    import torch
    from repro_torch.configs import shapes as SH
    from repro_torch.models import gat as G
    from repro_torch.train import optim as O
    _, cfg, b = SH.smoke_batch(GAT_ARCH, shape, seed=GAT_SEED)
    params = G.init_params(cfg, torch.Generator().manual_seed(GAT_SEED),
                           device="cpu")
    out = []
    for where in ("cpu", dev):
        bt = {k: torch.from_numpy(v).to(where) for k, v in b.items()}
        pt = O.tree_map(lambda x: x.to(where), params)
        loss, grads = _gat_grads(cfg, pt, bt, G.cell_loss(shape))
        out.append([loss.cpu().numpy()] + [g.cpu().numpy() for g in grads])
    worst = 0.0
    for c, k in zip(*out):
        err = np.abs(k - c)
        worst = max(worst, float(err.max()))
        need(bool((err <= GAT_RED_TOL["atol"]
                   + GAT_RED_TOL["rtol"] * np.abs(c)).all()),
             f"gat {shape} reduced: card vs CPU, max abs err {err.max()}")
    return worst


def gat_phase(dev, card, profile: bool = False):
    """Phase 18: GAT (``gat-cora``: 2 layers, 8 heads x 8 hidden) trained
    on the card at each of its four reference cells at the cell's own dims
    (``GNN_CELLS``; the reference only compiled these), the step the
    reference's ``launch/cells._gat_cell`` builds: ``build_train_step`` on
    the cell's loss with Adam 1e-3 and no clip. For each cell: the batch
    built on the host (each step timed), step 1's loss and the gradient of
    every leaf at the initial weights, finite, and held against a float64
    recomputation on the card (loss and gradient norm within GAT_F64_RTOL);
    GAT_STEPS Adam steps with every launch counter set to 0 just before and
    read just after (GAT runs no kernel of the table), each step's device
    ms (CUDA events), the model FLOP/s (``launch.roofline.model_flops`` over
    the median step), the steps' peak memory and finite weights after; and
    the reduced config on the card against the CPU (GAT_RED_TOL).
    ``profile``: one more step a cell under ``profile_device`` (its device
    busy time, window and kernels by time; ``tools/gat.py --profile``)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import shapes as SH
    from repro_torch.launch.roofline import model_flops
    from repro_torch.models import gat as G
    from repro_torch.train import optim as O
    from repro_torch.train.train_step import TrainState, build_train_step
    spec = get_arch(GAT_ARCH)
    out = {}
    for shape in GAT_SHAPES:
        t_cell = time.perf_counter()
        dims = SH.GNN_CELLS[shape].dims
        cfg = SH.gat_config_for_shape(spec.config, dims)
        loss_fn = G.cell_loss(shape)
        b, host_s = gat_cell_batch(shape)
        t0 = time.perf_counter()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in b.items()}
        torch.cuda.synchronize()
        host_s["to_device"] = time.perf_counter() - t0
        n_edges = sum(int(v.shape[0]) for k, v in b.items()
                      if k in ("edge_src", "block0_src", "block1_src"))
        del b
        params = G.init_params(cfg, torch.Generator(device=dev).manual_seed(
            GAT_SEED), device=dev)
        # step 1's gradient, fp32 and float64
        l32, g32 = _gat_grads(cfg, params, batch, loss_fn)
        need(bool(torch.isfinite(l32)) and all(bool(torch.isfinite(g).all())
                                               for g in g32),
             f"gat {shape}: step 1's loss or gradient not finite")
        n32 = _gat_norm(g32)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        l64, g64 = _gat_grads(cfg64, O.tree_map(lambda x: x.double(),
                                                params), batch, loss_fn)
        peak64 = torch.cuda.max_memory_allocated() - base
        n64 = _gat_norm(g64)
        leaf_err = max(float((a.double() - b_).abs().max())
                       for a, b_ in zip(g32, g64))
        del g64, g32
        torch.cuda.empty_cache()
        # the train step
        opt = O.adam(GAT_LR)
        step = build_train_step(lambda p, bb: loss_fn(cfg, p, bb), opt,
                                clip_norm=None)
        state = TrainState.create(params, opt)
        del params
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        zero_counters()
        ms, losses = [], []
        for _ in range(GAT_STEPS):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            state, m = step(state, batch)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            losses.append(float(m["loss"]))
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated() - base
        prof = None
        if profile:
            holder = [state]

            def one():
                holder[0], _ = step(holder[0], batch)
            prof = profile_device(one, n=1)
            state = holder[0]
            print(f"  gat {shape} profiled step: " + (
                "no device events" if prof is None else
                f"busy {prof['busy_ms']:.2f} of {prof['window_ms']:.2f} ms;"
                f" by kernel (ms): " + "; ".join(
                    f"{k} {v:.2f}" for k, v in prof["top_kernels_ms"])),
                flush=True)
        for k, v in launches.items():
            need(v == 0, f"gat {shape}: {k} launched {v} times (GAT runs no "
                         f"kernel of the table)")
        need(all(np.isfinite(losses)) and all(
            bool(torch.isfinite(p).all()) for p in O.tree_leaves(
                state.params)), f"gat {shape}: losses {losses} or weights "
                                f"not finite after {GAT_STEPS} steps")
        loss_err = abs(losses[0] - float(l64)) / abs(float(l64))
        norm_err = abs(n32 - n64) / n64
        need(loss_err <= GAT_F64_RTOL and norm_err <= GAT_F64_RTOL,
             f"gat {shape}: step 1 vs float64, loss {losses[0]} vs "
             f"{float(l64)}, grad norm {n32} vs {n64}")
        del state, batch
        torch.cuda.empty_cache()
        red_err = _gat_reduced(dev, shape)
        med = float(np.median(ms[1:]))
        flops = model_flops(GAT_ARCH, shape)
        res = dict(dims=dims, edges=n_edges, host_s=host_s, step_ms=ms,
                   step_median_ms=med, model_flops=flops,
                   model_tflops_per_s=flops / med / 1e9, losses=losses,
                   loss_f64=float(l64), loss_rel_err=loss_err,
                   grad_norm=n32, grad_norm_f64=n64,
                   grad_norm_rel_err=norm_err, grad_max_abs_err_f64=leaf_err,
                   peak_bytes=peak, peak_f64_bytes=peak64,
                   reduced_max_abs_err=red_err, profile=prof,
                   seconds=time.perf_counter() - t_cell)
        out[shape] = res
        print(f"gat {shape} ({cfg.n_heads} heads x {cfg.d_hidden}, "
              f"{cfg.n_layers} layers, d_feat {cfg.d_feat}, "
              f"{cfg.n_classes} classes; {n_edges:,} edges): host set-up "
              + ", ".join(f"{k} {v:.2f} s" for k, v in host_s.items())
              + f"; {GAT_STEPS} Adam steps, device ms "
              f"{', '.join(f'{x:.2f}' for x in ms)} (median of 2-3 "
              f"{med:.2f}: {flops / med / 1e9:.3f} model TFLOP/s of "
              f"{flops:.4g}), losses {', '.join(f'{x:.5f}' for x in losses)}"
              f", peak {peak / 2**30:.2f} GiB; step 1 vs float64: loss rel "
              f"err {loss_err:.2e}, grad norm {n32:.6g} vs {n64:.6g} (rel "
              f"{norm_err:.2e}), worst leaf abs err {leaf_err:.2e}, float64 "
              f"peak {peak64 / 2**30:.2f} GiB; reduced card vs CPU max abs "
              f"err {red_err:.2e} [{card}]", flush=True)
    return out, {}


# phase 19: each cell's cost counts, and three cells measured against them
CELLS_ARCH = "updlrm-paper"
CELLS_MEASURED = ("serve_p99", "serve_bulk", "train_batch")
CELLS_REPS = {"serve_p99": 20, "serve_bulk": 3, "train_batch": 3}
CELLS_SAMPLE = 1024      # bags held against the plain versions at each end
CELLS_SHARE_MAX = 1.05   # a share above it (or 0) means a wrong count
CELLS_SEED = 19


def _dry_pass_job(out: str) -> None:
    """Phase 19 (a)'s dry pass in a process of its own: every cell of the
    registry on the one-card grid, one JSON a cell under ``out``."""
    from repro_torch.configs import ARCHS
    from repro_torch.launch import dryrun
    for arch_id, spec in ARCHS.items():
        for shape_id in spec.shapes:
            dryrun.run_cell(arch_id, shape_id, False, out)


def start_dry_pass():
    """Start the dry pass of all cells in a spawned process (started in
    phase 2, so its ~25 s of host work runs beside phases 2-18; daemonic,
    so it ends with the script). It needs no card: every tensor is on
    ``meta``."""
    import multiprocessing as mp
    import shutil
    out = OUT / "dryrun"
    shutil.rmtree(out, ignore_errors=True)
    proc = mp.get_context("spawn").Process(
        target=_dry_pass_job, args=(str(out),), daemon=True)
    proc.start()
    return proc, out


def dry_pass_result(job, timeout: float = 600.0) -> dict:
    """The dry pass's records, by (arch, shape)."""
    from repro_torch.configs import ARCHS
    proc, out = job
    proc.join(timeout)
    if proc.is_alive():
        proc.kill()
    need(proc.exitcode == 0, f"phase 19's dry pass exited {proc.exitcode}")
    recs = {}
    for arch_id, spec in ARCHS.items():
        for shape_id in spec.shapes:
            path = out / f"card_1x1__{arch_id}__{shape_id}.json"
            need(path.exists(), f"the dry pass wrote no record of "
                                f"{arch_id} {shape_id}")
            recs[(arch_id, shape_id)] = json.loads(path.read_text())
    return recs


def _cell_batch(cfg, kind: str, B: int, gen, dev) -> dict:
    """A full-width ``updlrm-paper`` batch of B rows drawn on the card from
    ``gen``: uniform ids over each field's rows (full bags), normal dense
    features, coin-flip labels."""
    import torch
    F, L = cfg.n_sparse, cfg.multi_hot
    V = cfg.vocab_sizes[0]
    need(all(v == V for v in cfg.vocab_sizes), "fields of unequal vocab")
    b = {"dense": torch.randn((B, cfg.n_dense), generator=gen, device=dev),
         "sparse": torch.randint(0, V, (B, F, L), generator=gen, device=dev,
                                 dtype=torch.int32)}
    if kind == "train":
        b["label"] = torch.randint(0, 2, (B,), generator=gen,
                                   device=dev).float()
    return b


def _ends(n: int) -> list:
    """The first and the last CELLS_SAMPLE of n rows (all n, once, when
    they overlap)."""
    if n <= 2 * CELLS_SAMPLE:
        return [slice(0, n)]
    return [slice(0, CELLS_SAMPLE), slice(n - CELLS_SAMPLE, n)]


def _check_cell_kernels(cfg, params, statics, batch, train: bool, gen):
    """The cell's new-shape launches against their plain versions on the
    first and the last CELLS_SAMPLE bags (rows): the bag kernel and the
    scatter bit for bit, the fused interaction within DOT_TOL (its x
    columns bit for bit). Returns the worst interaction error."""
    import torch
    from repro_torch.kernels.dot_interaction import (dot_features,
                                                     dot_features_plain)
    from repro_torch.kernels.embedding_bag import (banked_bag,
                                                   banked_bag_plain,
                                                   ct_scatter_bag,
                                                   ct_scatter_bag_plain)
    from repro_torch.models import dlrm
    t = dlrm._banked(params, statics)
    off = statics["field_offsets"]
    B, F, L = batch["sparse"].shape
    NB, D = B * F, t.dim
    flat = batch["sparse"].reshape(NB, L)
    ends = _ends(NB)
    with torch.inference_mode():
        got = banked_bag(t.packed, t.remap_bank, t.remap_flat, off, -1, flat)
        for sl in ends:
            want = banked_bag_plain(t.packed, t.remap_bank, t.remap_flat, off,
                                    -1, flat[sl])
            need(torch.equal(got[sl], want),
                 f"banked_bag at ({NB}, {L}) != plain on bags {sl}")
        emb = got.reshape(B, F, D).to(cfg.dtype)
        x = dlrm.mlp_apply(params["bot"], batch["dense"].to(cfg.dtype))
        feat = dot_features(x, emb)
        P = feat.shape[1] - D
        err = 0.0
        for sl in _ends(B):
            want = dot_features_plain(x[sl], emb[sl])
            err = max(err, (feat[sl] - want).abs().max().item())
            need(torch.allclose(feat[sl], want, **DOT_TOL),
                 f"dot_features at {tuple(emb.shape)}: max abs err {err}")
            need(torch.equal(feat[sl, P:], x[sl]),
                 "dot_features: x columns != x")
        del got, emb, x, feat
        if train:
            # a cotangent on the sampled bags only: the full-shape scatter
            # adds exact zeros for every other bag
            ct = torch.zeros((NB, D), device=flat.device)
            for sl in ends:
                ct[sl] = torch.randn((sl.stop - sl.start, D), generator=gen,
                                     device=flat.device)
            n_rows = t.packed.shape[0]
            got = ct_scatter_bag(ct, flat, t.remap_bank, t.remap_flat, off,
                                 -1, n_rows, t.packed.dtype)
            want = ct_scatter_bag_plain(
                torch.cat([ct[sl] for sl in ends]),
                torch.cat([flat[sl] for sl in ends]), t.remap_bank,
                t.remap_flat, off, -1, n_rows, t.packed.dtype)
            need(torch.equal(got, want),
                 f"ct_scatter_bag at ({NB}, {L}) != plain on the sampled "
                 f"bags")
            del got, want, ct
    return err


def _share(bound_ms: float, step_ms: float, what: str) -> float:
    share = bound_ms / step_ms
    need(0 < share <= CELLS_SHARE_MAX,
         f"{what}: roofline share {share:.4f} (bound {bound_ms:.6f} ms over "
         f"a {step_ms:.6f} ms step) outside (0, {CELLS_SHARE_MAX}]: the "
         f"count is wrong")
    return share


def _not_measured(rec: dict) -> str:
    if rec.get("refused"):
        return f"refused by the model: {rec['refused']}"
    m = rec["memory"]
    why = "no phase drives this cell at its own dims"
    if not m["fits_80gb"]:
        why += (f"; it needs {(m['peak_bytes'] + m['argument_bytes']) / 2**30:.1f}"
                f" GiB, more than one card's 80 GB")
    return why


def cells_phase(dev, card, plan, dry_job, retrieval_out, gat_out):
    """Phase 19: (a) the dry pass of every cell on the one-card grid
    (``launch/dryrun``, run on ``meta`` in a process started in phase 2):
    one line a cell, its H100 bound and dominant term, whether it fits 80
    GB and its useful-FLOPs ratio; (b) ``updlrm-paper``'s ``serve_p99``,
    ``serve_bulk`` and ``train_batch`` at full width at each cell's own
    batch (512, 262,144, 65,536), the step ``launch/cells.build_cell``
    builds, on phase 1's plan and table (seed 0) with ids drawn on the card
    from a seeded generator, with every launch counter set to 0 just
    before and read just after (the bag kernel, the fused interaction and,
    training, the scatter must have run; no other kernel): each step's
    device ms (CUDA events, median after one warm-up), its new-shape
    launches held against their plain versions on the first and last 1,024
    bags; (c) the steps phases 12 and 18 measured at their cells' own dims.
    Every measured cell's roofline share (the bound over the step) must lie
    in (0, 1.05]; the other cells print why they are not measured."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.configs import shapes as SH
    from repro_torch.launch.cells import build_cell
    from repro_torch.launch.mesh import make_production_grid
    from repro_torch.models import dlrm
    from repro_torch.train.train_step import TrainState, default_optimizer
    recs = dry_pass_result(dry_job)
    print(f"cells (a): dry pass of {len(recs)} cells on one card "
          f"(launch/dryrun, meta tensors; bounds are counts over the H100's "
          f"published peaks, not times):")
    for (a, s), r in recs.items():
        if r.get("refused"):
            print(f"  {a:22s} {s:15s} refused: {r['refused']}")
            continue
        t, m = r["roofline"], r["memory"]
        u = r["useful_flops_ratio"]
        print(f"  {a:22s} {s:15s} bound {t['bound_s'] * 1e3:14.6f} ms "
              f"({t['dominant']}), fits_80gb {m['fits_80gb']}, useful "
              + ("none" if u is None else f"{u:.4f}")
              + f", {r['accounting']}")

    spec = get_arch(CELLS_ARCH)
    cfg = spec.config
    grid = make_production_grid()
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), plan=plan,
        device=dev)
    gen = torch.Generator(device=dev).manual_seed(CELLS_SEED)
    measured, launches_all = {}, {}
    for shape in CELLS_MEASURED:
        cell = build_cell(CELLS_ARCH, shape, grid)
        B = SH.get_cell(CELLS_ARCH, shape).dims["batch"]
        train = cell.step_kind == "train"
        batch = _cell_batch(cfg, cell.step_kind, B, gen, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = TrainState.create(params, default_optimizer()) if train \
            else None
        zero_counters()
        ms, losses = [], []
        for _ in range(CELLS_REPS[shape] + 1):            # one warm-up
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if train:
                state, m = cell.fn(state, statics, batch)
            else:
                with torch.inference_mode():
                    out = cell.fn(params, statics, batch)
            e1.record()
            e1.synchronize()
            ms.append(e0.elapsed_time(e1))
            if train:
                losses.append(float(m["loss"]))
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated() - base
        for name in ("banked_bag", "dot_features") + (
                ("ct_scatter_bag",) if train else ()):
            need(launches[name] > 0, f"cells {shape}: no {name} launch")
        for name, n in launches.items():
            need(n == 0 or name in ("banked_bag", "dot_features",
                                    "ct_scatter_bag"),
                 f"cells {shape}: {name} launched {n} times")
        for k, v in launches.items():
            launches_all[k] = launches_all.get(k, 0) + v
        if train:
            need(all(torch.isfinite(torch.tensor(losses)).tolist()),
                 f"cells {shape}: losses {losses}")
            del state
        else:
            need(tuple(out.shape) == (B,) and bool(torch.isfinite(out).all()),
                 f"cells {shape}: logits {tuple(out.shape)}, finite "
                 f"{bool(torch.isfinite(out).all())}")
            del out
        d_err = _check_cell_kernels(cfg, params, statics, batch, train, gen)
        del batch
        torch.cuda.empty_cache()
        step = statistics.median(ms[1:])
        rec = recs[(CELLS_ARCH, shape)]
        bound = rec["roofline"]["bound_s"] * 1e3
        share = _share(bound, step, f"{CELLS_ARCH} {shape}")
        measured[(CELLS_ARCH, shape)] = dict(
            step_ms=ms, step_median_ms=step, bound_ms=bound, share=share,
            dominant=rec["roofline"]["dominant"], launches=launches,
            peak_bytes=peak, losses=losses, dot_max_abs_err=d_err)
        print(f"cells (b): {CELLS_ARCH} {shape} at batch {B:,} full width: "
              f"device ms {', '.join(f'{x:.3f}' for x in ms)} (median after "
              f"the warm-up {step:.4f}); bound {bound:.4f} ms "
              f"({rec['roofline']['dominant']}), share {share:.4f}; "
              f"launches {launches}; peak {peak / 2**30:.2f} GiB; the bag "
              f"kernel" + (" and the scatter" if train else "")
              + f" bit for bit on the first and last {CELLS_SAMPLE} bags, "
              f"dot_features within 1e-5 (max abs err {d_err:.3g}) [{card}]",
              flush=True)
    del params, statics
    torch.cuda.empty_cache()

    # (c) the steps phases 12 and 18 already measured at their cells' dims
    elsewhere = {("dlrm-rm2", "retrieval_cand"):
                 (retrieval_out["stage_ms"]["serve_call"],
                  "phase 12's serve call (the top 128 included)")}
    for shape, r in gat_out.items():
        elsewhere[("gat-cora", shape)] = (
            r["step_median_ms"], "phase 18's Adam step (edges unpadded)")
    for key, (step, what) in elsewhere.items():
        rec = recs[key]
        bound = rec["roofline"]["bound_s"] * 1e3
        share = _share(bound, step, f"{key[0]} {key[1]}")
        measured[key] = dict(step_median_ms=step, bound_ms=bound,
                             share=share, dominant=rec["roofline"]["dominant"],
                             measured_by=what)
        print(f"cells (c): {key[0]} {key[1]}: {what} {step:.4f} ms, bound "
              f"{bound:.4f} ms ({rec['roofline']['dominant']}), share "
              f"{share:.4f} [{card}]")
    unmeasured = {f"{a} {s}": _not_measured(r) for (a, s), r in recs.items()
                  if (a, s) not in measured}
    for k, why in unmeasured.items():
        print(f"  {k}: not measured ({why})")
    return dict(records={f"{a} {s}": r for (a, s), r in recs.items()},
                measured={f"{a} {s}": v for (a, s), v in measured.items()},
                not_measured=unmeasured), launches_all


def dcn_phase(dev, card):
    """Phase 20: MLPerf's DLRM-DCNv2 at full size on one card, the shape of
    the ``dcnv2-bulk`` cell: the 204,184,588 x 128 bf16 table (52.3 GB,
    past 2^31 bytes, so the kernel's row offsets must be 64-bit) packed in
    8 uniform banks, made in 2^20-row chunks; a batch of 65,536 samples of
    214 ids (1,703,936 bags), each field's ids uniform over its vocabulary.
    (a) one ``build_recsys_serve`` step with every launch counter set to 0
    just before and read just after: exactly one ``csr_bag`` launch, no
    other kernel of the table; the scores equal to the plain path's
    (``backend='torch'``) bit for bit; (b) the lookup's fp32-output
    instance of ``csr_bag`` against ``csr_bag_plain`` bit for bit on the
    batch's stream (my = -1 on the flat remap; my = 3 on the bank map with
    5% holes), the table's-dtype instance equal to the fp32 sums cast
    once; (c) the adversarial CSR cases through the fp32-output instance;
    (d) both instances, the plain version and ``F.embedding_bag`` timed on
    the batch's stream (CUDA events, L2 flushed) beside the least time, and
    the serve step's device time."""
    import dataclasses

    import torch
    import torch.nn.functional as tnf
    from repro_torch.core.partitioning import uniform_partition
    from repro_torch.kernels import embedding_bag as kbag
    from repro_torch.models import dlrm
    from repro_torch.serve.serve_step import build_recsys_serve
    t0 = time.perf_counter()
    cfg = dlrm.DLRMConfig(
        name="dlrm-dcnv2", vocab_sizes=DCN_VOCAB, embed_dim=128, n_dense=13,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256),
        multi_hot=DCN_SIZES, interaction="dcn", cross_layers=3,
        cross_rank=512, emb_dtype=torch.bfloat16)
    plan = uniform_partition(cfg.total_vocab, 8)
    rows_per_bank = int(plan.max_rows_per_bank)
    statics = dlrm.plan_statics(cfg, plan, rows_per_bank, device=dev)
    D = cfg.embed_dim
    packed = torch.empty((plan.n_banks * rows_per_bank, D),
                         dtype=cfg.emb_dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(38)
    for s in range(0, packed.shape[0], 1 << 20):
        chunk = packed[s:s + (1 << 20)]
        chunk.copy_(torch.randn(chunk.shape, generator=g, device=dev) * 0.02)
    # the dense layers' shapes do not depend on the vocabularies
    params, _ = dlrm.init_params(
        dataclasses.replace(cfg, vocab_sizes=(1,) * cfg.n_sparse),
        torch.Generator(device=dev).manual_seed(39), device=dev)
    params["emb_packed"] = packed
    B = DCN_BATCH
    sparse = torch.cat([torch.randint(0, v, (B, n), generator=g, device=dev,
                                      dtype=torch.int32)
                        for v, n in zip(DCN_VOCAB, DCN_SIZES)], 1)
    batch = {"dense": torch.randn((B, cfg.n_dense), generator=g, device=dev),
             "sparse": sparse}
    torch.cuda.synchronize()
    table_bytes = packed.numel() * packed.element_size()
    need(table_bytes > 2 ** 31, f"the DCN table holds {table_bytes} B")
    print(f"dcn: {cfg.name} table {tuple(packed.shape)} {packed.dtype} "
          f"({table_bytes} B) in {plan.n_banks} uniform banks, batch {B} x "
          f"{sum(DCN_SIZES)} ids, made in {time.perf_counter() - t0:.1f} s; "
          f"held {torch.cuda.memory_allocated()} B [{card}]", flush=True)

    # (a) the serve step: one CSR launch, the plain path's scores
    serve = build_recsys_serve(dlrm, cfg, statics)
    first = serve(params, batch)
    torch.cuda.synchronize()
    zero_counters()
    out = serve(params, batch)
    torch.cuda.synchronize()
    launches = read_counters()
    print(f"dcn serve step at batch {B}: launches {launches}")
    for name, n in launches.items():
        need(n == (1 if name == "csr_bag" else 0),
             f"the DCN serve step launched {name} {n} times")
    plain = build_recsys_serve(dlrm, cfg, statics, backend="torch")(params,
                                                                  batch)
    torch.cuda.synchronize()
    need(out.shape == (B,) and bool(torch.isfinite(out).all()),
         f"DCN scores {tuple(out.shape)}, finite {torch.isfinite(out).all()}")
    need(torch.equal(out, first), "two DCN serve steps on one batch differ")
    need(torch.equal(out, plain),
         f"DCN scores != the plain path's (max abs err "
         f"{(out - plain).abs().max().item()})")
    logits = torch.logit(out.double())
    print(f"  scores == the plain path's, bit for bit; logits "
          f"{logits.min().item():.6f}..{logits.max().item():.6f}, std "
          f"{logits.std().item():.6f}")
    del first, plain

    # (b) the lookup's kernel against its plain version on the batch
    width = sum(DCN_SIZES)
    rows = torch.where(sparse >= 0, sparse + statics["entry_offsets"],
                       -1).reshape(-1).contiguous()
    prefix = torch.tensor([0, *torch.tensor(DCN_SIZES).cumsum(0)[:-1]
                           .tolist()], dtype=torch.int32, device=dev)
    starts = (torch.arange(B, dtype=torch.int32, device=dev)[:, None] * width
              + prefix).reshape(-1)
    ext = torch.cat([starts, torch.full((1,), B * width, dtype=torch.int32,
                                        device=dev)])
    NB = starts.shape[0]
    bank, flat = statics["remap_bank"], statics["remap_flat"]
    far = int(flat[rows.long()].max()) * D * packed.element_size()
    need(far > 2 ** 31, f"the batch's farthest row starts at byte {far}")
    holes = rows.clone()
    holes[torch.rand(rows.shape, generator=g, device=dev) < 0.05] = -1
    f32 = torch.float32
    errs = []
    for name, a in (("my=-1 flat remap", (packed, bank, flat, -1, rows, ext)),
                    ("5% holes, my=3 bank map",
                     (packed, bank, flat, 3, holes, ext))):
        got = kbag.csr_bag(*a, out_dtype=f32)
        want = kbag.csr_bag_plain(*a, out_dtype=f32)
        same = kbag.csr_bag(*a)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        need(got.dtype == want.dtype == f32 and torch.equal(got, want),
             f"csr_bag fp32 sums at DCN shape, {name}: kernel != plain (max "
             f"abs err {err})")
        need(same.dtype == packed.dtype and torch.equal(same, want.to(
            packed.dtype)), f"csr_bag bf16 sums at DCN shape, {name}: != "
                            f"the fp32 sums cast once")
        errs.append(err)
        print(f"  csr_bag at NB={NB} T={rows.numel()} D={D} bf16 rows, "
              f"{name}: fp32 sums == plain, bf16 sums == them cast once "
              f"(farthest row at byte {far})")
        del got, want, same

    # (c) the adversarial cases through the fp32-output instance
    check_csr_adversarial(dev, errs, out_dtype=f32)

    # (d) timings at the batch's shape, L2 flushed before every run
    scratch = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    fl = scratch.zero_
    args = (packed, bank, flat, -1, rows, ext)
    ms32 = time_ms(lambda: kbag.csr_bag(*args, out_dtype=f32), flush=fl)
    ms16 = time_ms(lambda: kbag.csr_bag(*args), flush=fl)
    plain_ms = time_ms(lambda: kbag.csr_bag_plain(*args, out_dtype=f32),
                       reps=3, warmup=1, flush=fl)
    lib_ids, lib_offs = flat[rows.long()].long(), starts.long()
    lib_ms = time_ms(lambda: tnf.embedding_bag(lib_ids, packed, lib_offs,
                                               mode="sum"), flush=fl)
    b32, by32 = csr_bound_ms(rows, NB, D, packed.element_size(), slot=flat,
                             out_itemsize=4)
    b16, by16 = csr_bound_ms(rows, NB, D, packed.element_size(), slot=flat)
    step_ms = time_ms(lambda: serve(params, batch), reps=10, warmup=2,
                      flush=fl)
    print(f"csr_bag at dcnv2-bulk's shape (NB={NB} T={rows.numel()} D={D}, "
          f"bf16 rows): fp32 sums {ms32:.4f} ms (bound {b32:.4f} ms, "
          f"{by32}), bf16 sums {ms16:.4f} ms (bound {b16:.4f} ms, {by16}), "
          f"plain {plain_ms:.4f} ms, F.embedding_bag (bf16 sums) "
          f"{lib_ms:.4f} ms; the serve step {step_ms:.3f} ms on the device "
          f"[{card}]")
    section = dict(table_bytes=table_bytes, batch=B, bags=NB,
                   entries=rows.numel(), farthest_row_byte=far,
                   launches=launches, max_abs_err=max(errs),
                   csr_bag_f32_ms=ms32, csr_bag_bf16_ms=ms16,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_f32_ms=b32,
                   bound_bf16_ms=b16, serve_step_ms=step_ms,
                   logit_min=logits.min().item(),
                   logit_max=logits.max().item(),
                   logit_std=logits.std().item())
    return section, launches


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        fail(f"no src/repro_torch beside {Path(__file__).name}: run it from "
             f"a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs a "
             "CUDA card")
    sys.path.insert(0, str(SRC))
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.data import synthetic as syn
    from repro_torch.kernels import _build
    from repro_torch.models import dlrm

    # 1. device
    t_start = time.perf_counter()
    phase_s: dict = {}

    def phase_done(name: str, since: float) -> None:
        phase_s[name] = time.perf_counter() - since
        print(f"{name} phase: {phase_s[name]:.1f} s [{card}]", flush=True)
    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda", 0)
    print(f"device: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; TF32 off for matmul and cuDNN, so "
          f"fp32 products are full fp32", flush=True)

    # 2. kernels
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"built {sorted(logs) or 'nothing (cached)'} in "
          f"{time.perf_counter() - t0:.1f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    spec = get_arch("updlrm-paper")
    cfg = spec.config
    rng = np.random.default_rng(0)
    profile = syn.WORKLOADS["read"]              # GoodReads: 2,360,650 items
    pop = syn.zipf_popularity(cfg.vocab_sizes[0], profile.zipf_a, rng)
    bank_plans_job = start_bank_plans(pop, cfg.n_sparse)     # phase 15's
    dry_job = start_dry_pass()                               # phase 19's
    plan = non_uniform_partition(np.tile(pop, cfg.n_sparse), 8,
                                 batch=BAG_TILE)
    print(f"plan: non_uniform_partition over {plan.vocab} rows, 8 banks, "
          f"groups of {BAG_TILE}: imbalance {plan.imbalance():.6f}, "
          f"max rows/bank {plan.max_rows_per_bank} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    params, statics = dlrm.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), plan=plan,
        device=dev)
    report: dict = {}
    check_bag_kernel(dev, cfg, plan, pop, params, statics, rng, report)
    del params, statics
    check_dot_kernel(dev, report)
    phase_done("kernels", t_start)

    # 3. serve
    t0 = time.perf_counter()
    res, launches = serve_main_path(dev, spec, plan)
    rps = len(res.latencies) / res.serve_s
    print(f"serve {spec.arch_id} full width: p50 {res.p50_ms:.3f} ms, p99 "
          f"{res.p99_ms:.3f} ms, {rps:.1f} requests/s over "
          f"{len(res.latencies)} requests at batch 64 [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res.latencies), 64)))
    check_serve_outputs(dev, spec, res)
    breakdown = serve_breakdown(dev, spec, res)
    phase_done("serve", t0)

    # 4. train
    t0 = time.perf_counter()
    res_t, t_launches = train_main_path(dev, spec, plan)
    scatter = check_scatter_kernel(dev, cfg, pop, res_t, report)
    train = check_train(dev, spec, res_t)
    train_reduced = check_train_reduced(dev, spec)
    phase_done("train", t0)
    train_out = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, losses=res_t.losses,
                     step_host_ms=res_t.step_ms, step_ms=train,
                     scatter=scatter, reduced=train_reduced)
    serve_out = dict(requests=len(res.latencies), batch=64, p50_ms=res.p50_ms,
                     p99_ms=res.p99_ms, requests_per_s=rps,
                     serve_s=res.serve_s, latencies_s=res.latencies)
    # phase 14 serves this table and batch again through the tuned dispatch
    live = dict(params=res.params, statics=res.statics, batch=res.last_batch)
    del res, res_t
    torch.cuda.empty_cache()

    # 5. cache-aware serve
    t0 = time.perf_counter()
    res_c, c_launches = cached_main_path(dev, spec)
    pre_s = sum(v for k, v in res_c.stats.items() if k.endswith("_s"))
    rps_c = len(res_c.latencies) / res_c.serve_s
    print(f"serve_cached {spec.arch_id} full width: p50 {res_c.p50_ms:.3f} "
          f"ms, p99 {res_c.p99_ms:.3f} ms, {rps_c:.1f} requests/s over "
          f"{len(res_c.latencies)} requests at batch 64; pre-process "
          f"{pre_s:.1f} s [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res_c.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res_c.latencies), 64)))
    cache_kernel = check_cache_kernel(dev, res_c, report)
    p_launches, plain_cache = check_plain_cache_kernel(dev, res_c, report)
    cached_grads = check_cached_grads(dev, res_c)
    cached_outputs = check_cached_outputs(dev, spec, res_c)
    cached_step = cached_breakdown(dev, spec, res_c, breakdown["serve_step"])
    phase_done("cache-aware serve", t0)
    serve_cached_out = dict(
        requests=len(res_c.latencies), batch=64,
        profile_requests=CACHED_PROFILE, p50_ms=res_c.p50_ms,
        p99_ms=res_c.p99_ms, requests_per_s=rps_c, serve_s=res_c.serve_s,
        latencies_s=res_c.latencies, stats=res_c.stats,
        host_ms=res_c.host_ms, step_ms=cached_step, kernel=cache_kernel,
        plain_cache_kernel=plain_cache, grads=cached_grads,
        outputs=cached_outputs)
    del res_c
    torch.cuda.empty_cache()

    # 6. adaptive serve, tiered-precision tables
    t0 = time.perf_counter()
    res_a, a_launches = adaptive_main_path(dev, spec)
    rps_a = len(res_a.latencies) / res_a.serve_s
    print(f"serve_adaptive {spec.arch_id} full width, int4 tier lane: p50 "
          f"{res_a.p50_ms:.3f} ms, p99 {res_a.p99_ms:.3f} ms, {rps_a:.1f} "
          f"requests/s over {len(res_a.latencies)} requests at batch 64 "
          f"({res_a.serve_s:.3f} s serving, swaps included); "
          f"{len(res_a.swaps)} swap(s) [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res_a.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res_a.latencies), 64)))
    tiered_kernel = check_tiered_kernel(dev, res_a, report)
    adaptive_outputs = check_adaptive_outputs(dev, spec, res_a)
    adaptive_step = adaptive_breakdown(dev, spec, res_a)
    phase_done("adaptive serve", t0)
    serve_adaptive_out = dict(
        requests=len(res_a.latencies), batch=64, quant="int4",
        replan_every=ADAPTIVE_REPLAN, p50_ms=res_a.p50_ms,
        p99_ms=res_a.p99_ms, requests_per_s=rps_a, serve_s=res_a.serve_s,
        latencies_s=res_a.latencies, stats=res_a.stats,
        host_ms=res_a.host_ms, checks=res_a.checks,
        swaps=[dict(batch=e.batch, old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    tier_version=e.tier_version, promoted=e.tier_promoted,
                    demoted=e.tier_demoted, requantized=e.tier_requantized)
               for e in res_a.swaps],
        reads=[r.tolist() for r in res_a.reads],
        nbytes=[n.tolist() for n in res_a.nbytes], step_ms=adaptive_step,
        kernel=tiered_kernel, outputs=adaptive_outputs)
    del res_a
    torch.cuda.empty_cache()

    # 7. adaptive serve, hot-row replica lane
    t0 = time.perf_counter()
    res_r, r_launches = replicated_main_path(dev, spec)
    rps_r = len(res_r.latencies) / res_r.serve_s
    print(f"serve_replicated {spec.arch_id} full width, k_max {K_MAX}: p50 "
          f"{res_r.p50_ms:.3f} ms, p99 {res_r.p99_ms:.3f} ms, {rps_r:.1f} "
          f"requests/s over {len(res_r.latencies)} requests at batch 64 "
          f"({res_r.serve_s:.3f} s serving, swaps included); "
          f"{len(res_r.swaps)} swap(s) [{card}]")
    print("  per batch, max request latency (ms): "
          + ", ".join(f"{max(res_r.latencies[i:i + 64]) * 1e3:.3f}"
                      for i in range(0, len(res_r.latencies), 64)))
    replica_kernel = check_replica_kernel(dev, res_r, report)
    replicated_outputs = check_replicated_outputs(dev, spec, res_r)
    replicated_step = replicated_breakdown(dev, spec, res_r)
    phase_done("replicated serve", t0)
    serve_replicated_out = dict(
        requests=len(res_r.latencies), batch=64, k_max=K_MAX,
        replan_every=REPLICATED_REPLAN, p50_ms=res_r.p50_ms,
        p99_ms=res_r.p99_ms, requests_per_s=rps_r, serve_s=res_r.serve_s,
        latencies_s=res_r.latencies, stats=res_r.stats,
        host_ms=res_r.host_ms, checks=res_r.checks,
        swaps=[dict(batch=e.batch, old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    replica_version=e.replica_version,
                    hot_rows=e.replica_hot_rows,
                    churn=e.replica_copy_churn) for e in res_r.swaps],
        reads=[r.tolist() for r in res_r.reads], step_ms=replicated_step,
        kernel=replica_kernel, outputs=replicated_outputs)
    del res_r
    torch.cuda.empty_cache()

    # 8. ragged CSR lookups, forward and backward; the identity drop-ins
    t0 = time.perf_counter()
    csr_out, csr_launches, drop_launches = csr_phase(dev, spec, plan, report)
    phase_done("csr", t0)

    # 9. the adaptive loop's cache lane
    t0 = time.perf_counter()
    res_l, l_launches = cached_adaptive_main_path(dev, spec)
    lane_kernel = check_cached_adaptive_kernel(dev, res_l)
    lane_outputs = check_cached_adaptive_outputs(dev, spec, res_l)
    lane_step = cached_adaptive_breakdown(dev, spec, res_l)
    phase_done("cache lane", t0)
    serve_lane_out = dict(
        requests=len(res_l.latencies), batch=64,
        replan_every=CACHED_ADAPTIVE_REPLAN, p50_ms=res_l.p50_ms,
        p99_ms=res_l.p99_ms, serve_s=res_l.serve_s,
        latencies_s=res_l.latencies, stats=res_l.stats,
        host_ms=res_l.host_ms, checks=res_l.checks,
        swaps=[dict(batch=e.batch, old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    cache_version=e.cache_version,
                    cache_entries=e.cache_entries,
                    cache_dropped=e.cache_dropped) for e in res_l.swaps],
        reads=[r.tolist() for r in res_l.reads], step_ms=lane_step,
        kernel=lane_kernel, outputs=lane_outputs)
    del res_l
    torch.cuda.empty_cache()

    # 10. adaptive training, both partitions
    t0 = time.perf_counter()
    res_tc, tc_launches, tc_spy = adaptive_train_main_path(
        dev, spec, "cache_aware", ADAPTIVE_TRAIN_STEPS, ADAPTIVE_TRAIN_REPLAN,
        ADAPTIVE_TRAIN_REFRESH)
    replay, replay_info = cached_train_replay(dev, spec, res_tc)
    tc_grad = [check_cached_train_grad(dev, spec, res_tc),
               check_cached_train_grad(dev, spec, res_tc, replay, "replay")]
    res_tn, tn_launches, tn_spy = adaptive_train_main_path(
        dev, spec, "non_uniform", ADAPTIVE_TRAIN_STEPS, ADAPTIVE_TRAIN_REPLAN,
        ADAPTIVE_TRAIN_REFRESH)
    train_kernels = adaptive_train_kernel_times(dev, spec, res_tc, res_tn,
                                                replay)
    del replay
    train_adaptive_reduced = check_adaptive_train_reduced(dev, spec)
    phase_done("adaptive train", t0)
    train_adaptive_out = {
        part: dict(steps=ADAPTIVE_TRAIN_STEPS,
                   replan_every=ADAPTIVE_TRAIN_REPLAN,
                   refresh_every=ADAPTIVE_TRAIN_REFRESH, losses=r.losses,
                   step_host_ms=r.step_ms, host_ms=r.host_ms,
                   migration_steps=[s for s, _ in r.migrations],
                   refreshes=r.refreshes, launches=la,
                   refresh_ms=sp["refresh_ms"],
                   refresh_entries=sp["refresh_entries"])
        for part, r, la, sp in (("cache_aware", res_tc, tc_launches, tc_spy),
                                ("non_uniform", res_tn, tn_launches,
                                 tn_spy))}
    train_adaptive_out.update(grad=tc_grad, kernels=train_kernels,
                              replay=replay_info,
                              reduced=train_adaptive_reduced)
    del res_tc, res_tn
    torch.cuda.empty_cache()

    # 11. the fault lane: a dead bank, a slow bank, the SLO watchdog
    t0 = time.perf_counter()
    res_f, f_launches = fault_main_path(dev, spec)
    fault_outputs = check_fault_outputs(dev, spec, res_f, report)
    fault_step = fault_breakdown(dev, spec, res_f)
    phase_done("fault lane", t0)
    serve_fault_out = dict(
        requests=len(res_f.latencies), batch=64, schedule=FAULT_SCHEDULE,
        replan_every=FAULT_REPLAN, slo=FAULT_SLO, p50_ms=res_f.p50_ms,
        p99_ms=res_f.p99_ms, serve_s=res_f.serve_s,
        latencies_s=res_f.latencies, stats=res_f.stats,
        host_ms=res_f.host_ms, checks=res_f.checks,
        fired=[(b, str(e)) for b, e in res_f.fired],
        swaps=[dict(batch=e.batch, reason=e.reason,
                    old_imbalance=e.old_imbalance,
                    new_imbalance=e.new_imbalance,
                    recovery_ms=None if e.recovery_s is None
                    else e.recovery_s * 1e3) for e in res_f.swaps],
        stragglers=res_f.stragglers, slo_events=res_f.slo_events,
        degraded=[c.tolist() for c in res_f.degraded],
        reads=[r.tolist() for r in res_f.reads], lookups=res_f.lookups,
        launches=f_launches, outputs=fault_outputs, fault_breakdown=fault_step)
    del res_f
    torch.cuda.empty_cache()

    # 12. retrieval at full dlrm-rm2 width
    t0 = time.perf_counter()
    retrieval_out, rt_launches = retrieval_phase(dev, report)
    phase_done("retrieval", t0)
    torch.cuda.empty_cache()

    # 13. training with gradient compression and a restart
    t0 = time.perf_counter()
    compressed_out, cp_launches = compress_train_phase(dev, spec, plan)
    phase_done("compressed train", t0)
    torch.cuda.empty_cache()

    # 14. the autotuned dispatch
    t0 = time.perf_counter()
    tuned_out, tu_launches = tuned_phase(dev, spec, live)
    del live
    phase_done("tuned dispatch", t0)
    torch.cuda.empty_cache()

    # 15. the bank axis: ranks of one torch.distributed world
    t0 = time.perf_counter()
    bank_out, ba_launches = bank_axis_phase(
        dev, spec, lambda: bank_plans_result(bank_plans_job), pop, card)
    phase_done("bank axis", t0)
    torch.cuda.empty_cache()

    # 16. the recommendation zoo: DIN, xDeepFM, BERT4Rec at full width
    t0 = time.perf_counter()
    zoo_out, zo_launches = zoo_phase(dev, card)
    phase_done("zoo", t0)
    torch.cuda.empty_cache()

    # 17. the LM family: granite-moe-1b-a400m and smollm-360m at full width
    t0 = time.perf_counter()
    lm_out, lm_launches = lm_phase(dev, card)
    phase_done("lm", t0)
    torch.cuda.empty_cache()

    # 18. GAT at its four reference cells
    t0 = time.perf_counter()
    gat_out, gat_launches = gat_phase(dev, card)
    phase_done("gat", t0)
    torch.cuda.empty_cache()

    # 19. every cell's cost counts; three cells measured against them
    t0 = time.perf_counter()
    cells_out, ce_launches = cells_phase(dev, card, plan, dry_job,
                                         retrieval_out, gat_out)
    phase_done("cells", t0)
    torch.cuda.empty_cache()

    # 20. MLPerf's DLRM-DCNv2 at full size: the CSR kernel's fp32 sums
    t0 = time.perf_counter()
    dcn_out, dcn_launches = dcn_phase(dev, card)
    phase_done("dcn", t0)
    torch.cuda.empty_cache()

    runs = (launches, t_launches, c_launches, p_launches, a_launches,
            r_launches, csr_launches, drop_launches, l_launches,
            tc_launches, tn_launches, f_launches, rt_launches, cp_launches,
            tu_launches, ba_launches, zo_launches, lm_launches,
            gat_launches, ce_launches, dcn_launches)
    for name in report:                          # each path counted apart
        report[name]["launches"] = sum(r.get(name, 0) for r in runs)

    kernels = [report["banked_bag"], report["banked_bag_replicated"],
               report["cache_residual_bag"], report["ct_scatter_bag"],
               report["dot_interaction"], report["dot_features"],
               report["dot_features_query"], report["tiered_bag"],
               report["csr_bag"], report["plain_bag"],
               report["plain_cache_bag"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: kd[k] for k in keys} for kd in kernels]
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "chip_smoke.json").write_text(json.dumps(dict(
        card=card, kernels=kernels, serve=serve_out,
        serve_step_ms=breakdown, plan_imbalance=plan.imbalance(),
        launches=dict(serve=launches, train=t_launches,
                      serve_cached=c_launches, plain_cache=p_launches,
                      serve_adaptive=a_launches, serve_replicated=r_launches,
                      csr=csr_launches, drop_in=drop_launches,
                      serve_cache_lane=l_launches,
                      train_cache_aware=tc_launches,
                      train_non_uniform=tn_launches,
                      serve_fault=f_launches, retrieval=rt_launches,
                      train_compressed=cp_launches, serve_tuned=tu_launches,
                      bank_axis=ba_launches, zoo=zo_launches,
                      lm=lm_launches, gat=gat_launches,
                      cells=ce_launches, dcn=dcn_launches),
        train=train_out, serve_cached=serve_cached_out,
        serve_adaptive=serve_adaptive_out,
        serve_replicated=serve_replicated_out, csr=csr_out,
        serve_cache_lane=serve_lane_out, train_adaptive=train_adaptive_out,
        serve_fault=serve_fault_out, retrieval=retrieval_out,
        train_compressed=compressed_out, tuned=tuned_out,
        bank_axis=bank_out, zoo=zoo_out, lm=lm_out, gat=gat_out,
        cells=cells_out, dcn=dcn_out,
        phase_s=phase_s,
        total_s=time.perf_counter() - t_start),
        indent=1))
    print("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in phase_s.items()))
    print(f"total: {time.perf_counter() - t_start:.1f} s [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
