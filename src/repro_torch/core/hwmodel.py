"""Hardware profiles + the paper's analytic three-stage embedding latency model
(a numpy copy of the reference's ``repro/core/hwmodel.py``, with its
profiles; the SLO watchdog prices measured bank shares with it).

Two profiles:
  * UPMEM  — constants from the paper (Fig. 3 MRAM latency curve, 256 DPUs,
             64 MB MRAM, ~800 MB/s MRAM-WRAM per DPU, 350 MHz) so the benchmark
             harness can reproduce Figs. 8–11 under the paper's own cost model.
  * TPUv5e — the adaptation target (197 TFLOP/s bf16, 819 GB/s HBM, 16 GB,
             ~50 GB/s/link ICI) used by the roofline analysis.

The stage model is Eq. 1–3 of the paper:
    T_embed = T_c_comm + T_lkp + T_d_comm
    T_c_comm = per-bank index traffic * t_c      (stage 1: broadcast IDX/OFFSET)
    T_lkp    = per-bank lookups * t_a(N_c*4B)    (stage 2: near-memory gather+reduce)
    T_d_comm = N_c * batch * t_d                 (stage 3: partial sums back)
with the bank's share of lookups depending on the partitioner (uniform => even
split; non-uniform/cache-aware => the partitioner's realized per-bank load).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class UPMEMProfile:
    """Constants for the paper's hardware (UPMEM DPU, Table 2 / §2.2)."""

    n_dpus: int = 256
    mram_bytes: int = 64 * 2**20          # 64 MB per bank
    wram_bytes: int = 64 * 2**10
    tasklets: int = 14                    # per-DPU threads (paper §4.1)
    dpu_hz: float = 350e6
    mram_wram_bw: float = 800e6           # B/s per DPU (paper §2.2)
    # CPU<->DPU DDR4 transfer cost per 4-byte value as seen by ONE bank when
    # all banks transfer concurrently (UPMEM parallel xfer mode; PrIM,
    # arXiv:2105.03814 reports per-DPU shares of rank bandwidth). Calibrated
    # so the stage shares reproduce the paper's Fig. 10 (lookup 71-77% at
    # N_c=2 under U/NU; d_comm rising to ~35% at N_c=8).
    t_c_per_val: float = 4.0 / 500e6      # s per 4B value, CPU->DPU
    t_d_per_val: float = 4.0 / 30e6       # s per 4B value, DPU->CPU (slower dir)

    def mram_read_latency(self, nbytes: float) -> float:
        """Fig. 3: MRAM read latency vs access size.

        Shape measured by the paper (and PrIM, arXiv:2105.03814): a fixed DMA
        setup cost dominates up to ~32 B, then the transfer term takes over and
        latency grows ~linearly to the 2048 B max.
        """
        setup_s = 77e-9                    # ~27 cycles @350 MHz DMA setup
        per_byte = 1.0 / self.mram_wram_bw
        nbytes = float(np.clip(nbytes, 8, 2048))
        # sub-32B reads ride almost entirely on the setup cost (Fig. 3 plateau)
        plateau = setup_s + 32 * per_byte
        if nbytes <= 32:
            return plateau
        return setup_s + nbytes * per_byte


@dataclasses.dataclass(frozen=True)
class TPUv5eProfile:
    """Roofline constants for the adaptation target (per chip)."""

    peak_flops: float = 197e12            # bf16 FLOP/s
    hbm_bw: float = 819e9                 # B/s
    hbm_bytes: int = 16 * 2**30
    ici_bw: float = 50e9                  # B/s per link
    vmem_bytes: int = 128 * 2**20         # ~128 MB VMEM v5e


@dataclasses.dataclass(frozen=True)
class CPUProfile:
    """Xeon Silver 4110 host (paper Table 2): DDR4-2400 x 6ch theoretical
    ~115 GB/s; random row-granular gathers achieve a small fraction of it
    (pointer-chasing, TLB misses) — rand_eff calibrated to published DLRM
    CPU inference studies (Gupta et al., HPCA'20)."""

    ddr_bw: float = 115e9
    rand_eff: float = 0.08            # effective fraction on random gathers
    mlp_gflops: float = 150e9         # sustained CPU GEMM throughput
    pcie_bw: float = 12e9             # effective PCIe 3.0 x16 to GPU


CPU_HOST = CPUProfile()
UPMEM = UPMEMProfile()
TPUV5E = TPUv5eProfile()


def cpu_lookup_time(total_lookups: float, row_bytes: float,
                    cpu: CPUProfile = CPU_HOST) -> float:
    return total_lookups * row_bytes / (cpu.ddr_bw * cpu.rand_eff)


def system_inference_time(
    system: str,
    *,
    batch_size: int,
    avg_reduction: float,
    n_tables: int,
    dim: int,
    mlp_flops: float,
    per_bank_lookup_share: np.ndarray | None = None,
    n_banks: int = 256,
    cache_hit_rate: float = 0.0,
    fae_hot_fraction: float = 0.8,
    n_c: int = 8,
    hw: UPMEMProfile = UPMEM,
    cpu: CPUProfile = CPU_HOST,
) -> float:
    """End-to-end inference-time model for the paper's four systems (Fig. 8).

    DLRM-CPU    : CPU random-gather lookups + CPU MLP.
    DLRM-Hybrid : CPU lookups + PCIe transfer of pooled embeddings + GPU MLP
                  (GPU compute overlapped; PCIe + CPU lookup serialize - §4.2).
    FAE         : hot fraction of lookups served from GPU HBM cache (free vs
                  PCIe), cold remainder follows the hybrid path.
    UpDLRM      : Eq. 1-3 stage model (banked lookups + combine) + CPU MLP.
    """
    row_bytes = dim * 4.0
    total_lookups = batch_size * avg_reduction * n_tables
    t_mlp_cpu = mlp_flops * batch_size / cpu.mlp_gflops
    pooled_bytes = batch_size * n_tables * row_bytes

    # GPU-side fixed cost per inference batch in the hybrid designs: kernel
    # launches + CPU<->GPU sync while the GPU stalls on embedding results —
    # the effect the paper names to explain DLRM-Hybrid ranking WORST (§4.2).
    # Calibrated against Fig. 8's orderings (hybrid < cpu < fae < updlrm).
    gpu_sync_overhead = 1.0e-3

    if system == "cpu":
        return cpu_lookup_time(total_lookups, row_bytes, cpu) + t_mlp_cpu
    if system == "hybrid":
        t_lkp = cpu_lookup_time(total_lookups, row_bytes, cpu)
        t_pcie = pooled_bytes / cpu.pcie_bw
        return t_lkp + t_pcie + 0.1 * t_mlp_cpu + gpu_sync_overhead
    if system == "fae":
        cold = 1.0 - fae_hot_fraction
        t_lkp = cpu_lookup_time(total_lookups * cold, row_bytes, cpu)
        t_pcie = pooled_bytes * cold / cpu.pcie_bw
        return t_lkp + t_pcie + 0.1 * t_mlp_cpu + 0.3 * gpu_sync_overhead
    if system == "updlrm":
        # tables occupy disjoint bank groups and run in parallel
        st = embedding_stage_latency(
            batch_size=batch_size, avg_reduction=avg_reduction, n_c=n_c,
            per_bank_lookup_share=per_bank_lookup_share,
            n_banks=max(1, n_banks // n_tables), hw=hw,
            cache_hit_rate=cache_hit_rate)
        return st.total + t_mlp_cpu
    raise ValueError(system)


@dataclasses.dataclass
class StageLatency:
    c_comm: float
    lookup: float
    d_comm: float

    @property
    def total(self) -> float:
        return self.c_comm + self.lookup + self.d_comm


def updlrm_layout(n_banks_table: int, cols: int, n_c: int
                  ) -> tuple[int, int]:
    """§3.1 bank factorization for one table: banks = row_groups x col_groups.

    A row is split over ``col_groups = C/N_c`` banks (each holding its N_c
    columns); rows distribute over ``row_groups = n_banks_table/col_groups``
    bins — the bins the row partitioners (U/NU/CA) operate on. Larger N_c =>
    fewer column groups => MORE row groups => smaller per-bank lookup share
    but wider (slower past 32 B) MRAM reads and a fatter stage-3 return: the
    paper's Eq. 1 tradeoff.
    """
    col_groups = max(1, cols // n_c)
    row_groups = max(1, n_banks_table // col_groups)
    return row_groups, col_groups


def embedding_stage_latency(
    *,
    batch_size: int,
    avg_reduction: float,
    n_c: int,
    per_bank_lookup_share: np.ndarray | None = None,
    n_banks: int | None = None,
    hw: UPMEMProfile = UPMEM,
    cache_hit_rate: float = 0.0,
    cache_avg_group: float = 2.0,
) -> StageLatency:
    """Eq. 1 of the paper for ONE table, generalized to a per-row-group load
    vector (tables run on disjoint banks in parallel, so the embedding layer
    time is the max over same-profile tables = one table's time).

    per_bank_lookup_share: fraction of the table's lookups landing on each
    ROW GROUP (length = row_groups from updlrm_layout; sums to 1). Uniform
    partitioning => all-equal; skewed traces under uniform => the hottest
    bank bounds stage 2 (banks run in parallel) — exactly why the paper's
    non-uniform partitioning helps.

    cache_hit_rate: fraction of lookups resolved by a cached partial sum;
    each hit replaces ~cache_avg_group row reads with one.
    """
    if per_bank_lookup_share is None:
        assert n_banks is not None
        per_bank_lookup_share = np.full(n_banks, 1.0 / n_banks)

    total_lookups = batch_size * avg_reduction
    # caching collapses groups of cache_avg_group reads into one
    effective_lookups = total_lookups * (1 - cache_hit_rate) \
        + total_lookups * cache_hit_rate / cache_avg_group

    t_a = hw.mram_read_latency(n_c * 4)
    # banks run in parallel => stage-1/2 set by the HOTTEST bank's share;
    # tasklet pipelining overlaps successive MRAM DMAs (§4.4).
    hottest_share = float(np.max(per_bank_lookup_share))
    lkp = effective_lookups * hottest_share * t_a / min(hw.tasklets, 4)

    # stage 1 (paper Eq.): T_c-comm = share * batch * Avg_Red * t_c — each
    # bank receives only the indices of rows it owns; ranks transfer in
    # parallel.
    c_comm = effective_lookups * hottest_share * hw.t_c_per_val

    # stage 3 (paper Eq.): T_d-comm = N_c * batch * t_d — every bank returns
    # an N_c-wide partial per sample; same-size buffers transfer concurrently
    # (§2.2), so no n_banks factor.
    d_comm = n_c * batch_size * hw.t_d_per_val
    return StageLatency(c_comm=c_comm, lookup=lkp, d_comm=d_comm)


def solve_uniform_tile(
    *,
    rows: int,
    cols: int,
    n_banks: int,
    batch_size: int,
    avg_reduction: float,
    hw: UPMEMProfile = UPMEM,
) -> tuple[int, int]:
    """§3.1 uniform-partitioning solver: pick (N_r, N_c) minimizing Eq. 1.

    Constraints (Eq. 2–3): N_r*N_c = R*C/N_banks <= 1.6e7 values (64 MB of 4B),
    N_c in {2,4,6,8}. Exhaustive search over the (tiny) feasible set.
    """
    budget_vals = hw.mram_bytes // 4
    per_bank_vals = rows * cols / n_banks
    if per_bank_vals > budget_vals:
        raise ValueError(
            f"table ({rows}x{cols}) needs more than {n_banks} banks "
            f"({per_bank_vals:.0f} > {budget_vals} values/bank)")
    best, best_t = None, float("inf")
    for k in range(1, 5):
        n_c = 2 * k
        if n_c > cols:
            break
        n_row_groups, n_col_groups = updlrm_layout(n_banks, cols, n_c)
        n_r = int(np.ceil(rows / n_row_groups))
        if n_r * n_c > budget_vals:
            continue
        lat = embedding_stage_latency(
            batch_size=batch_size, avg_reduction=avg_reduction, n_c=n_c,
            n_banks=n_row_groups, hw=hw).total
        if lat < best_t:
            best, best_t = (n_r, n_c), lat
    if best is None:
        raise ValueError("no feasible (N_r, N_c) under the MRAM budget")
    return best
