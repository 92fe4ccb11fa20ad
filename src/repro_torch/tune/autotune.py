"""The autotuner: time every (backend, tile_b, n_slots) candidate per call
signature and record the winner in a ``DispatchCache`` (the port of
``repro/tune/autotune.py``).

Candidate space on the card (the reference's three knobs, as the bag
kernels take them):

  * backend — ``'cuda'``, the hand-written kernel. Its plain version
    (``'torch'``) is timed once per case as evidence (``torch_us``) and is
    never a candidate on the card: it is the CPU's only implementation;
  * ``tile_b`` — bags per block, 1 or 2 (a warp a bag);
  * ``n_slots`` — stages of 32 rows in the ``cp.async`` ring, 1 to 8.

Each case keeps the candidates its shape can launch (``tuned_geometry``
raises on the rest: 2 bags x 8 stages at D = 128 fp32 needs more shared
memory than a block has). The tiered kernel has one geometry, so its case
has the one candidate ``('cuda', 1, 1)``. On the CPU every case has the one
candidate ``('torch', 1, 1)``.

``smoke=True`` keeps the SAME signature suite (the cache's entry keys are
its schema) with fewer candidates: one bag a block, 2 or 8 stages.

Timings on the card are the median of ``repeats`` launches (CUDA events,
each after a ~1 ms device sleep so the events time the device, not the
host that enqueues the call), after a warm-up; the suite's tables fit the
card's 50 MB L2, which is left warm. On the CPU they are the best of
``repeats`` host-clock runs, the reference's protocol. Every entry carries
``best_us``, ``cuda_us`` (the kernel's best; the reference's
``pallas_us``), ``torch_us`` (the plain version; the reference's
``jnp_us``), ``default_us`` (the kernel at the fixed geometry rule, with
that geometry as ``default_tile_b``/``default_n_slots``; null on the CPU)
and ``candidates_us`` (each candidate's time, keyed
``"<tile_b>x<n_slots>"``).
"""
from __future__ import annotations

import dataclasses
import statistics
import subprocess
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tune.dispatch import (CallSignature, DispatchCache,
                                       signature)

#: (vocab, dim, batch, bag_len, n_fields) — the rectangular lookup shapes
#: (the reference's bench_embedding CONFIGS)
PLAIN_CONFIGS = [
    (10_000, 64, 32, 8, 1),
    (10_000, 64, 128, 8, 1),
    (50_000, 128, 64, 16, 1),
    (20_000, 32, 32, 16, 4),      # multi-field fused (B, F, L)
]

#: full sweep on the card: {tile_b} x {n_slots}
TILE_B_CANDIDATES = (1, 2)
N_SLOT_CANDIDATES = (1, 2, 4, 8)
#: smoke sweep: one bag a block, a shallow and the deepest ring
SMOKE_TILE_B = (1,)
SMOKE_N_SLOTS = (2, 8)

DEFAULT_REPEATS = 20      # on the card: the median of 20 launches
CPU_REPEATS = 3           # on the CPU: best of 3, the reference's
SMOKE_CPU_REPEATS = 2
WARMUP = 3


def candidates(smoke: bool = False, device="cuda"
               ) -> list[tuple[str, int, int]]:
    """(backend, tile_b, n_slots) triples to measure on ``device``: the
    kernel's geometries on the card, the plain version's one entry on the
    CPU (it has no geometry; ``1, 1`` keeps the entry well-formed)."""
    if torch.device(device).type != "cuda":
        return [("torch", 1, 1)]
    tiles = SMOKE_TILE_B if smoke else TILE_B_CANDIDATES
    slots = SMOKE_N_SLOTS if smoke else N_SLOT_CANDIDATES
    return [("cuda", tb, ns) for tb in tiles for ns in slots]


@dataclasses.dataclass
class TuneCase:
    """One signature plus its measurement factory: ``make(backend, tile_b,
    n_slots)`` returns a zero-arg callable running one lookup through its
    entry point in ``core/embedding.py``. ``plain()`` is the kernel's plain
    version on the same inputs (its bits are every geometry's).
    ``geometry(tile_b, n_slots)`` is the kernel's ``tuned_geometry`` at the
    case's shape (ValueError where it cannot launch); None for the tiered
    kernel, whose one geometry is fixed."""

    sig: CallSignature
    make: Callable[[str, int | None, int | None], Callable[[], torch.Tensor]]
    plain: Callable[[], torch.Tensor]
    geometry: Callable | None = None

    def fits(self, tile_b: int, n_slots: int) -> bool:
        if self.geometry is None:
            return (tile_b, n_slots) == (1, 1)
        try:
            self.geometry(tile_b, n_slots)
        except ValueError:
            return False
        return True

    def rule(self) -> tuple[int, int]:
        """The fixed rule's (bags per block, stages) at this shape."""
        if self.geometry is None:
            return 1, 1
        g = self.geometry(None, None)
        return g.bags_per_block, g.stages


def case_candidates(case: TuneCase, smoke: bool = False, device="cuda"
                    ) -> list[tuple[str, int, int]]:
    """``candidates`` that ``case`` can launch (the tiered case: ``('cuda',
    1, 1)`` alone)."""
    if torch.device(device).type == "cuda" and case.geometry is None:
        return [("cuda", 1, 1)]
    return [c for c in candidates(smoke, device)
            if c[0] == "torch" or case.fits(c[1], c[2])]


def _geometry(nb: int, bag_len: int, dim: int, itemsize: int,
              slot_bytes: int) -> Callable:
    from repro_torch.kernels.embedding_bag import tuned_geometry
    return lambda tile_b, n_slots: tuned_geometry(
        nb, bag_len, dim, itemsize, bags_per_block=tile_b, stages=n_slots,
        slot_bytes=slot_bytes)


def _time_us(fn: Callable[[], object], repeats: int,
             device: torch.device) -> float:
    """Device time of one call in µs: on the card the median over
    ``repeats`` launches (CUDA events) after ``WARMUP`` calls, each timed
    call queued behind a ~1 ms device sleep; on the CPU the best of
    ``repeats`` host-clock runs after one warm call."""
    if device.type != "cuda":
        fn()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        return best * 1e6
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize(device)
    times = []
    for _ in range(repeats):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) * 1e3


# ---------------------------------------------------------------------------
# case builders — the reference's inputs (same seeds, same draws in the same
# order), one per lookup path
# ---------------------------------------------------------------------------

def _dev(x: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def plain_case(v: int, d: int, b: int, l: int, f: int,
               seed: int = 0, *, device="cuda") -> TuneCase:
    from repro_torch.core.embedding import banked_embedding_bag, pack_table
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.kernels.embedding_bag import SLOT_BYTES

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    bt = pack_table(table, non_uniform_partition(rng.random(v) + 0.1, 8),
                    device=dev)
    per_field = v // f
    offs = _dev(np.arange(f, dtype=np.int32) * per_field, dev) \
        if f > 1 else None
    shape = (b, f, l) if f > 1 else (b, l)
    idx = _dev(rng.integers(-1, per_field, shape).astype(np.int32), dev)

    def make(backend, tile_b, n_slots):
        return lambda: banked_embedding_bag(
            bt, idx, backend=backend, field_offsets=offs, tile_b=tile_b,
            n_slots=n_slots)

    return TuneCase(
        sig=signature("plain", vocab=v, dim=d, batch=b * f, bag_len=l,
                      n_fields=f),
        make=make, plain=make("torch", None, None),
        geometry=_geometry(b * f, l, d, 4, SLOT_BYTES))


def fused_case(v: int = 2_000, nc: int = 128, d: int = 64, b: int = 32,
               lc: int = 4, lr: int = 8, seed: int = 1, *,
               device="cuda") -> TuneCase:
    from repro_torch.core.embedding import (banked_cache_residual_bag,
                                            pack_table)
    from repro_torch.core.partitioning import (non_uniform_partition,
                                               uniform_partition)
    from repro_torch.kernels.embedding_bag import (LIST_BYTES,
                                                   cache_residual_bag_plain)

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    bt = pack_table(table, non_uniform_partition(rng.random(v) + 0.1, 8),
                    device=dev)
    cbt = pack_table(rng.standard_normal((nc, d)).astype(np.float32),
                     uniform_partition(nc, 4), device=dev)
    ci = _dev(rng.integers(-1, nc, (b, lc)).astype(np.int32), dev)
    ri = _dev(rng.integers(-1, v, (b, lr)).astype(np.int32), dev)

    def make(backend, tile_b, n_slots):
        return lambda: banked_cache_residual_bag(
            bt, cbt, ci, ri, backend=backend, tile_b=tile_b, n_slots=n_slots)

    # the kernel's order (one accumulator, cache stream then residual), not
    # backend='torch''s (the reference's jnp order: the streams apart)
    def plain():
        return cache_residual_bag_plain(
            bt.packed, cbt.packed, bt.remap_bank, bt.remap_flat,
            cbt.remap_bank, cbt.remap_flat, -1, ci, ri)

    return TuneCase(
        sig=signature("fused", vocab=v, dim=d, batch=b,
                      bag_len=f"{lc}+{lr}"),
        make=make, plain=plain,
        geometry=_geometry(b, lc + lr, d, 4, LIST_BYTES))


def csr_case(v: int = 10_000, d: int = 64, num_bags: int = 64,
             avg_len: int = 8, seed: int = 2, *, device="cuda") -> TuneCase:
    from repro_torch.core.embedding import csr_embedding_bag, pack_table
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.kernels.embedding_bag import LIST_BYTES

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((v, d)).astype(np.float32)
    bt = pack_table(table, non_uniform_partition(rng.random(v) + 0.1, 8),
                    device=dev)
    lens = rng.integers(1, 2 * avg_len, num_bags)
    total = int(lens.sum())
    indices = _dev(rng.integers(0, v, total).astype(np.int32), dev)
    offsets = _dev(np.concatenate([[0], np.cumsum(lens)[:-1]])
                   .astype(np.int32), dev)

    def make(backend, tile_b, n_slots):
        return lambda: csr_embedding_bag(
            bt, indices, offsets, num_bags, backend=backend, tile_b=tile_b,
            n_slots=n_slots)

    return TuneCase(
        sig=signature("csr", vocab=v, dim=d, batch=num_bags,
                      bag_len="ragged"),
        make=make, plain=make("torch", None, None),
        geometry=_geometry(num_bags, -(-total // num_bags), d, 4,
                           LIST_BYTES))


def tiered_case(v: int = 2_000, d: int = 64, b: int = 32, l: int = 8,
                hot_dtype: str = "bf16", seed: int = 3, *,
                device="cuda") -> TuneCase:
    from repro_torch.core.embedding import pack_table, tiered_embedding_bag
    from repro_torch.core.partitioning import non_uniform_partition
    from repro_torch.quant import QuantSpec, assign_tiers, build_tiered_table

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    table = (rng.standard_normal((v, d)) * 0.01).astype(np.float32)
    freq = rng.random(v) + 0.1
    bt = pack_table(table, non_uniform_partition(freq, 8), device=dev)
    # budget below the int8 width forces a mixed bf16/int8/int4 tier map
    ta = assign_tiers(freq, QuantSpec(byte_budget=0.75 * d,
                                      min_hot_rows=16), d)
    tt = build_tiered_table(bt, ta.tier_of_row)
    idx = _dev(rng.integers(-1, v, (b, l)).astype(np.int32), dev)

    def make(backend, tile_b, n_slots):
        return lambda: tiered_embedding_bag(
            bt.packed, tt, idx, backend=backend, tile_b=tile_b,
            n_slots=n_slots)

    return TuneCase(
        sig=signature("tiered", vocab=v, dim=d, batch=b, bag_len=l,
                      tier_mix=hot_dtype),
        make=make, plain=make("torch", None, None))


def replicated_case(v: int = 2_000, d: int = 64, b: int = 32, l: int = 8,
                    k_max: int = 4, n_hot: int = 16,
                    seed: int = 4, *, device="cuda") -> TuneCase:
    from repro_torch.core.embedding import (pack_replicated,
                                            replicated_embedding_bag)
    from repro_torch.core.partitioning import replicated_partition
    from repro_torch.kernels.embedding_bag import SLOT_BYTES

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    banks = 8
    table = (rng.standard_normal((v, d)) * 0.1).astype(np.float32)
    freq = rng.random(v) + 0.1
    freq[:n_hot] += 50.0
    copies = np.ones(v, np.int32)
    copies[:n_hot] = k_max
    cap = int(np.ceil((v + n_hot * (k_max - 1)) / banks) * 1.3)
    rplan = replicated_partition(freq, banks, copies=copies,
                                 capacity_rows=cap, k_max=k_max)
    rt = pack_replicated(table, rplan, rows_per_bank=cap, device=dev)
    idx = np.full((b, l), -1, np.int32)
    for i in range(b):
        k = rng.integers(1, l + 1)
        hot = rng.random(k) < 0.5
        idx[i, :k] = np.where(hot, rng.integers(0, n_hot, k),
                              rng.integers(0, v, k))
    idx = _dev(idx, dev)

    def make(backend, tile_b, n_slots):
        return lambda: replicated_embedding_bag(
            rt, idx, backend=backend, tile_b=tile_b, n_slots=n_slots)

    return TuneCase(
        sig=signature("replicated", vocab=v, dim=d, batch=b, bag_len=l,
                      k_max=k_max),
        make=make, plain=make("torch", None, None),
        geometry=_geometry(b, l, d, 4, SLOT_BYTES))


def default_signature_suite(device="cuda") -> list[TuneCase]:
    """The committed-cache suite: every reference bench shape on the plain
    path, plus one representative case per remaining entry point, in the
    reference's order. Smoke mode runs THIS SAME list."""
    cases = [plain_case(*cfg, device=device) for cfg in PLAIN_CONFIGS]
    cases += [fused_case(device=device), csr_case(device=device),
              tiered_case(device=device), replicated_case(device=device)]
    return cases


# ---------------------------------------------------------------------------
# the sweep
# ---------------------------------------------------------------------------

def arch_label(device) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or ``'cpu'``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader",
                            f"--id={dev.index or 0}"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        r = None
    if r is not None and r.returncode == 0 and r.stdout.strip():
        return r.stdout.strip().splitlines()[0]
    return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def tune(cases: list[TuneCase] | None = None, *, smoke: bool = False,
         repeats: int | None = None, arch: str | None = None,
         device="cuda", log: Callable[[str], None] = print) -> DispatchCache:
    """Sweep every candidate for every case on ``device``; return the
    populated cache. The winner is the strictly least measured time (the
    first listed on a tie)."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    if cases is None:
        cases = default_signature_suite(device=dev)
    if repeats is None:
        repeats = DEFAULT_REPEATS if on_card else (
            SMOKE_CPU_REPEATS if smoke else CPU_REPEATS)
    meta = {
        "arch": arch or arch_label(dev),
        "device": dev.type,
        "smoke": smoke,
        "repeats": repeats,
        "n_candidates": len(candidates(smoke, dev)),
        "timing": ("median of CUDA-event launches, L2 warm" if on_card
                   else "best host-clock run"),
    }
    cache = DispatchCache(meta=meta)
    for case in cases:
        best, each = None, {}
        for backend, tile_b, n_slots in case_candidates(case, smoke, dev):
            us = _time_us(case.make(backend, tile_b, n_slots), repeats, dev)
            each[f"{tile_b}x{n_slots}"] = round(us, 3)
            if best is None or us < best[3]:
                best = (backend, tile_b, n_slots, us)
        backend, tile_b, n_slots, us = best
        rule_b, rule_s = case.rule()
        if on_card:
            torch_us = _time_us(case.make("torch", None, None), repeats, dev)
            default_us = _time_us(case.make("cuda", None, None), repeats, dev)
            cuda_us = us
        else:
            torch_us, default_us, cuda_us = us, None, None
        cache.record(case.sig, backend=backend, tile_b=tile_b,
                     n_slots=n_slots, timings={
                         "best_us": round(us, 3),
                         "cuda_us": None if cuda_us is None
                         else round(cuda_us, 3),
                         "torch_us": round(torch_us, 3),
                         "default_us": None if default_us is None
                         else round(default_us, 3),
                         "default_tile_b": rule_b,
                         "default_n_slots": rule_s,
                         "candidates_us": each})
        log(f"tuned {case.sig.key()}: {backend} tile_b={tile_b} "
            f"n_slots={n_slots} ({us:.2f}us; default ({rule_b}, {rule_s}) "
            f"{'-' if default_us is None else f'{default_us:.2f}'}us; "
            f"torch {torch_us:.2f}us)")
    return cache
