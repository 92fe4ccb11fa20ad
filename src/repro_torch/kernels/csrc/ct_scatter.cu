// Sorted-run scatter (the bag sum's transpose: the training backward of the
// banked embedding bag) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_ct_scatter_kernel (called
// through _ct_scatter_call by ct_scatter_bag_pallas), which walks the runs
// that the prep scatter_run_metadata sorted out, accumulates each in fp32
// and DMAs the finished row onto a zeros-aliased d_table.
//
// What it computes. The prep (csrc/scatter_prep.cu on the card: a label
// kernel, one key-value radix sort, a run table; op by op in
// kernels/embedding_bag.py on the CPU) labels every entry of the forward's
// (NB, L) id stream, enumerated j-major (e = j * NB + bag), with its
// destination table slot, and sorts the entries stably by slot. Entries
// that land on one slot form a run [run_starts[r], run_starts[r + 1]) of
// bag_sorted, in entry order; runs r < n_run are live, the rest are empty.
// For each live run:
//     out[run_slot[r]] = cast(sum_{p in run r} float(ct[bag_sorted[p]]))
// summed in fp32 in entry order and cast to the table's dtype once, exactly
// as the reference's scan (_scatter_bag_ct) adds the same cotangents onto
// the same slot. ``out`` holds zeros on entry; every other row stays zero.
// ct and out each have their own dtype (fp32 or bf16): ct is read in its
// own, and only the finished fp32 sum is cast, once, to out's. The fused
// cache+residual backward scatters the EMT-typed cotangent onto a cache
// table that may be typed otherwise; a cast of ct before the sum would round
// every addend and change the bits.
//
// What bounds it on the card: bytes, in principle. At the train shape (NB =
// 512 bags, L = 256, D = 32 fp32) there are 131,072 entries: the prep
// arrays (~1.5 MB) are read once, ct (NB x D = 64 KB) stays in L2, and each
// live run writes one 128-byte row to a random place in a 2.4 GB table
// (~16.8 MB for ~131 k distinct rows): ~18 MB, ~5.5 us at 3.35 TB/s. The
// adds are nothing against the card's rate. In practice it is latency and
// the longest run. The first design (one warp per run, PR 12) paid a chain
// of four dependent loads (n_run, run_starts, bag_sorted, the ct row) on
// each of ~130 k runs that mostly hold one entry, and walked a Zipf head
// row's 2,511 entries 32 per round trip in one straggler warp: 114.3 us on
// the train ids, 103.3 on Zipf ids, 99.7 on the CSR prep (NVIDIA H100 80GB
// HBM3, 700 W, CUDA events, L2 flushed; chip_smoke.py). A run's fp32 add
// chain cannot be split (partial sums combined afterwards give other bits),
// so the longest run is a floor: one add per entry, in order.
//
// What the design does about it: two kernels, launched together (the span
// blocks on a side stream of the library's own that waits on the caller's
// stream, the tiles on the caller's, which then waits on the spans):
//   * tiles (runs of at most kShortMax entries): a block owns kMaxTile /
//     (column vectors per row) consecutive runs. It reads the tile's
//     run_starts and run_slot with coalesced loads issued together with
//     the n_run load (one latency; a tile past n_run exits there). Each
//     (run, column vector) pair is an item: 16-byte vectors (4 fp32 or 8
//     bf16 columns) when the rows of ct and out allow, else one column. A
//     thread takes kItems items and walks their runs in rounds of kDepth
//     entries: a round's ct rows are read together with the next round's
//     bag ids, then added in entry order, so a tile costs about three
//     latencies plus one per round of its longest run. Each item stores
//     its vector once; a run's row is written by its items, neighbouring
//     runs' rows side by side;
//   * spans (runs of more than kShortMax entries): block w owns the runs
//     that start among sorted entries [w kSpan, (w + 1) kSpan), found from
//     the prep's run_of at the span's two ends, so the work is balanced by
//     entries: a bank's cluster of hot rows spreads over as many blocks as
//     it has entries, and a block starts at most kMaxLong long runs. The
//     block lays its long runs end to end and streams them through a ring
//     of kRingBytes in shared memory: stages of 32 entries' rows in ct's
//     own dtype, row-major (16 stages of fp32 rows or 32 of bf16 at D >=
//     32: 512 or 1,024 entries in flight), a full and an empty mbarrier to
//     each group of kGroup stages. Warps 1..7 each fill every 7th stage:
//     the bag ids, a contiguous range of bag_sorted per run, read coalesced
//     four of the warp's stages ahead, the stage's rows copied by cp.async in
//     16-byte pieces (loads and stores when rows are not 16-byte pieces), the
//     group's full barrier completing when its stages land. Warp 0, a lane a
//     column (32 a pass), does nothing but shared loads and the ordered add
//     chain: a group that lies in one run is one unrolled block that reads
//     each stage's second half and the next stage's first half while it adds
//     the first, so the chain waits on no load; a group where a run ends adds
//     stage by stage, with one cut where the run ends, and stores the run's
//     row there. It tests the next group before its adds and waits for it, if
//     need be, after them, and hands the group back on its empty barrier. A
//     long run costs one dependent add per entry plus a few barrier operations
//     per 128, with no block-wide barrier and no load latency on the chain.
// Measured: PERF.md's kernel table (row 3); tools/kernel_probe.py and
// tools/scatter_prep_probe.py give the span kernel's ns an entry on a run.
// Each slot is written by exactly one thread group, once, in the
// reference's summation order: every column one fp32 accumulator from +0,
// __fadd_rn in entry order, one cast at the end. No atomics (the shared
// work lists are built with ballots), no host sync: n_run stays on the
// device and both grids come from static shapes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kShortMax = 64;     // longer runs go to the span blocks
constexpr int kDepth = 4;         // tile items: rows read per round
constexpr int kItems = 2;         // tile items per thread
constexpr int kMaxTile = kThreads * kItems;
constexpr int kSpan = 1024;       // sorted entries owned by a span block
constexpr int kMaxLong = kSpan / (kShortMax + 1) + 1;   // long runs a span
                                                        // block can start
constexpr int kProducers = kWarps - 1;     // warps 1.. copy, warp 0 adds
constexpr int kRingBytes = 64 * 1024;      // a span block's ring of stages
constexpr int kSpanBlocksPerSm = 2;        // resident span blocks (registers)
constexpr int kGroup = 4;                  // ring stages a barrier pair guards

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A column vector of ct as it is read: VEC values of TC in one load.
template <typename TC, int VEC> struct Raw;
template <> struct Raw<float, 1> { using T = float; };
template <> struct Raw<float, 4> { using T = float4; };
template <> struct Raw<__nv_bfloat16, 1> { using T = unsigned short; };
template <> struct Raw<__nv_bfloat16, 8> { using T = uint4; };

template <typename TC, int VEC>
__device__ __forceinline__ typename Raw<TC, VEC>::T load_raw(const TC* p) {
  return __ldg(reinterpret_cast<const typename Raw<TC, VEC>::T*>(p));
}

__device__ __forceinline__ float bf16_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ void accumulate(float (&a)[1], float v) {
  a[0] = __fadd_rn(a[0], v);
}
__device__ __forceinline__ void accumulate(float (&a)[4], float4 v) {
  a[0] = __fadd_rn(a[0], v.x);
  a[1] = __fadd_rn(a[1], v.y);
  a[2] = __fadd_rn(a[2], v.z);
  a[3] = __fadd_rn(a[3], v.w);
}
__device__ __forceinline__ void accumulate(float (&a)[1], unsigned short v) {
  a[0] = __fadd_rn(a[0], bf16_lo(v));
}
__device__ __forceinline__ void accumulate(float (&a)[8], uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[2 * i] = __fadd_rn(a[2 * i], bf16_lo(w[i]));
    a[2 * i + 1] = __fadd_rn(a[2 * i + 1], bf16_hi(w[i]));
  }
}

__device__ __forceinline__ unsigned pack_bf16(float a, float b) {
  const unsigned lo = __bfloat16_as_ushort(__float2bfloat16_rn(a));
  const unsigned hi = __bfloat16_as_ushort(__float2bfloat16_rn(b));
  return lo | (hi << 16);
}

// Store VEC finished sums at p (aligned to VEC * sizeof(TO)).
template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    *p = a[0];
  } else {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  }
}
template <int VEC>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&a)[VEC]) {
  if constexpr (VEC == 1) {
    *p = __float2bfloat16_rn(a[0]);
  } else if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(p) =
        make_uint2(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]));
  } else {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(a[0], a[1]), pack_bf16(a[2], a[3]),
                   pack_bf16(a[4], a[5]), pack_bf16(a[6], a[7]));
  }
}

// ---------------------------------------------------------------------------
// tiles: consecutive runs of at most kShortMax entries, an item per column
// vector
// ---------------------------------------------------------------------------

template <typename TC, typename TO, int VEC>
__device__ __forceinline__ void tile_role(
    const TC* __restrict__ ct, const int* __restrict__ bag_sorted,
    const int* __restrict__ run_starts, const int* __restrict__ run_slot,
    const int* __restrict__ n_run, TO* __restrict__ out, int n_runs_pad,
    int dim, int tile, int t) {
  using RawT = typename Raw<TC, VEC>::T;
  __shared__ int s_start[kMaxTile + 1];
  __shared__ int s_slot[kMaxTile];
  const int tid = threadIdx.x;
  const int s0 = t * tile;
  const int cnt = min(tile, n_runs_pad - s0);
  // the tile's bounds and slots, read together with n_run (one latency)
  constexpr int kLd = kMaxTile / kThreads + 1;
  int st_r[kLd], sl_r[kLd];
#pragma unroll
  for (int q = 0; q < kLd; ++q) {
    const int i = q * kThreads + tid;
    st_r[q] = i <= cnt ? __ldg(run_starts + s0 + i) : 0;
    sl_r[q] = i < cnt ? __ldg(run_slot + s0 + i) : 0;
  }
  const int nr = min(__ldg(n_run), n_runs_pad);
  if (s0 >= nr) return;                       // uniform: a dead tile
#pragma unroll
  for (int q = 0; q < kLd; ++q) {
    const int i = q * kThreads + tid;
    if (i <= cnt) s_start[i] = st_r[q];
    if (i < cnt) s_slot[i] = sl_r[q];
  }
  __syncthreads();
  const int live = min(cnt, nr - s0);
  const int nv = (dim + VEC - 1) / VEC;       // vectors per row
  const int n_items = live * nv;
  for (int base = 0; base < n_items; base += kThreads * kItems) {
    int st[kItems], n[kItems], vv[kItems], r[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = base + k * kThreads + tid;
      const bool ok = i < n_items;
      r[k] = ok ? i / nv : 0;
      vv[k] = i - r[k] * nv;
      st[k] = s_start[r[k]];
      const int len = ok ? s_start[r[k] + 1] - st[k] : 0;
      n[k] = len <= kShortMax ? len : 0;      // long: a span block's
    }
    // rounds of kDepth entries: a round's rows are read together with the
    // next round's bag ids, then added in entry order
    int ids[kItems][kDepth];
    int rounds = 0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      rounds = max(rounds, (n[k] + kDepth - 1) / kDepth);
#pragma unroll
      for (int u = 0; u < kDepth; ++u)
        ids[k][u] = u < n[k] ? __ldg(bag_sorted + st[k] + u) : 0;
    }
    float acc[kItems][VEC];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[k][q] = 0.0f;
    }
    for (int rd = 0; rd < rounds; ++rd) {
      const int p0 = rd * kDepth;
      RawT v[kItems][kDepth];
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          // int64: bag * D stays small, slot * D below does not
          v[k][u] = p0 + u < n[k]
                        ? load_raw<TC, VEC>(
                              ct + static_cast<int64_t>(ids[k][u]) * dim +
                              vv[k] * VEC)
                        : RawT{};
        }
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u) {
          const int p = p0 + kDepth + u;
          ids[k][u] = p < n[k] ? __ldg(bag_sorted + st[k] + p) : 0;
        }
      }
#pragma unroll
      for (int k = 0; k < kItems; ++k) {
#pragma unroll
        for (int u = 0; u < kDepth; ++u)
          if (p0 + u < n[k]) accumulate(acc[k], v[k][u]);
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if (n[k] > 0)
        store_vec<VEC>(out + static_cast<int64_t>(s_slot[r[k]]) * dim +
                           vv[k] * VEC, acc[k]);
    }
  }
}

// ---------------------------------------------------------------------------
// spans: the long runs that start among kSpan consecutive sorted entries
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n"
               :: "r"(smem(bar)), "r"(count) : "memory");
}

// One arrival, with release: this thread's earlier shared accesses are
// done before the phase it helps complete is seen.
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 st;\n"
               " mbarrier.arrive.shared.b64 st, [%0];\n}\n"
               :: "r"(smem(bar)) : "memory");
}

// One arrival when this thread's cp.async copies so far have landed.
__device__ __forceinline__ void bar_arrive_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n"
               :: "r"(smem(bar)) : "memory");
}

// Whether the barrier's phase of this parity has completed (no waiting).
__device__ __forceinline__ bool bar_test(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile("{\n .reg .pred p;\n"
               " mbarrier.test_wait.parity.shared.b64 p, [%1], %2;\n"
               " selp.u32 %0, 1, 0, p;\n}\n"
               : "=r"(done) : "r"(smem(bar)), "r"(parity) : "memory");
  return done != 0;
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile("{\n .reg .pred p;\n"
               "WAIT:\n"
               " mbarrier.try_wait.parity.shared.b64 p, [%0], %1;\n"
               " @!p bra WAIT;\n}\n"
               :: "r"(smem(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem(dst)), "l"(src) : "memory");
}

// Stages of kWarp rows of kWarp columns in the ring: 16 of fp32, 32 of bf16;
// each group of kGroup consecutive stages has one full and one empty
// barrier.
template <typename TC>
constexpr int kStages = kRingBytes / (kWarp * kWarp * sizeof(TC));
template <typename TC>
constexpr int kGroups = kStages<TC> / kGroup;

// The bag id of virtual entry v of the span's long runs laid end to end
// (past the end, the last entry's, which nothing copies): run k holds
// virtual entries [off[k], off[k + 1]) = sorted entries start[k]... `k` is
// the run of the caller's previous v, which only grows. The id is the load
// itself, with no select after it, so that the load's latency lands on its
// first use and not here.
__device__ __forceinline__ int entry_id(const int* __restrict__ bag_sorted,
                                        const int* off, const int* start,
                                        int n_long, int total, int v, int& k) {
  v = min(v, total - 1);
  while (k + 1 < n_long && off[k + 1] <= v) ++k;
  return __ldg(bag_sorted + start[k] + v - off[k]);
}

// One stage of a producer warp: stage s of a pass is global stage g, in
// ring slot g % S of barrier group g / kGroup; its kWarp rows land
// row-major (row u, column c at slot[u * W + c]), lane u holding the bag id
// of row u in `ids`. The rows are copied by cp.async in 16-byte pieces, the
// stage's pieces in row-major order kWarp a warp instruction (piece p is
// row p / per_row's piece p % per_row, for any pieces-a-row), or by loads
// and stores when rows are not 16-byte pieces. A stage past the stream (a
// group's padding) copies nothing and still arrives.
template <typename TC>
__device__ __forceinline__ void fill_stage(
    const TC* __restrict__ ct, int ids, int s, int g, int total, int dim,
    int c0, int W, bool vec16, TC* ring, uint64_t* full, uint64_t* empty,
    int lane) {
  constexpr int S = kStages<TC>, G = kGroups<TC>;
  constexpr int kPiece = 16 / sizeof(TC);
  const int q = g / kGroup;
  if (q >= G) bar_wait(&empty[q % G], ((q / G) - 1) & 1);
  TC* slot = ring + (g % S) * (kWarp * kWarp);
  const int v0 = s * kWarp;
  if (vec16) {
    // piece i * kWarp + lane: row u, piece `piece`, stepped kWarp pieces
    // (du rows and dp pieces, with at most one carry) an instruction
    const int per_row = W * static_cast<int>(sizeof(TC)) / 16;
    const int du = kWarp / per_row, dp = kWarp - du * per_row;
    int u = lane / per_row, piece = lane - u * per_row;
    for (int i = 0; i < per_row; ++i) {
      const int id = __shfl_sync(kFull, ids, u);
      if (v0 + u < total)
        copy16(slot + u * W + piece * kPiece,
               ct + static_cast<int64_t>(id) * dim + c0 + piece * kPiece);
      u += du;
      piece += dp;
      if (piece >= per_row) {
        piece -= per_row;
        ++u;
      }
    }
    bar_arrive_copies(&full[q % G]);
  } else {
    TC v[kWarp];
#pragma unroll
    for (int u = 0; u < kWarp; ++u) {
      const int id = __shfl_sync(kFull, ids, u);
      if (v0 + u < total && lane < W)
        v[u] = ct[static_cast<int64_t>(id) * dim + c0 + lane];
    }
#pragma unroll
    for (int u = 0; u < kWarp; ++u)
      if (v0 + u < total && lane < W) slot[u * W + lane] = v[u];
    bar_arrive(&full[q % G]);
  }
}

// A producer warp (me in 0..kProducers - 1): stages me, me + kProducers, ...
// of every pass of kWarp columns, n_pad stages a pass (the stream's n_st
// stages padded to whole groups; global stage g = pass * n_pad + s). Lane l
// holds the bag ids of entry l of the warp's next four stages in four
// registers, each reloaded for the stage four ahead right after its own
// stage is issued: the loop is unrolled four times, so no register is
// moved, and a load's latency is paid only at its use four stages later.
template <typename TC>
__device__ __forceinline__ void span_producer(
    const TC* __restrict__ ct, const int* __restrict__ bag_sorted,
    const int* off, const int* start, int n_long, int total, int n_pad,
    int dim, bool vec16, TC* ring, uint64_t* full, uint64_t* empty, int me,
    int lane) {
  constexpr int P = kProducers;
  for (int c0 = 0, g0 = 0; c0 < dim; c0 += kWarp, g0 += n_pad) {
    const int W = min(kWarp, dim - c0);
    int k = 0;
    auto id_of = [&](int s) {
      return entry_id(bag_sorted, off, start, n_long, total, s * kWarp + lane,
                      k);
    };
    int id0 = id_of(me), id1 = id_of(me + P), id2 = id_of(me + 2 * P),
        id3 = id_of(me + 3 * P);
    auto fill = [&](int s, int ids) {
      fill_stage<TC>(ct, ids, s, g0 + s, total, dim, c0, W, vec16, ring, full,
                     empty, lane);
    };
    for (int s = me; s < n_pad; s += 4 * P) {
      fill(s, id0);
      id0 = id_of(s + 4 * P);
      if (s + P >= n_pad) break;
      fill(s + P, id1);
      id1 = id_of(s + 5 * P);
      if (s + 2 * P >= n_pad) break;
      fill(s + 2 * P, id2);
      id2 = id_of(s + 6 * P);
      if (s + 3 * P >= n_pad) break;
      fill(s + 3 * P, id3);
      id3 = id_of(s + 7 * P);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// acc plus rows [h, h + 16) of a stage as read, in order.
template <typename TC>
__device__ __forceinline__ float add_half(float acc, const TC (&a)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) acc = __fadd_rn(acc, to_f32(a[i]));
  return acc;
}

template <typename TC>
__device__ __forceinline__ void read_half(TC (&a)[16], const TC* slot, int h,
                                          int W, int lane) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = slot[(h + i) * W + lane];
}

// The adder warp, lane c0 + lane a column: every stage in order, a barrier
// group (kGroup stages) at a time. A group is waited for once, and the next
// one tested before its adds and waited for, if it has not landed, after
// them; its slots go back to the producers together. A run's row is stored
// where the run ends; the last run's after the stream.
template <typename TC, typename TO>
__device__ __forceinline__ void span_adder(
    const int* off, const int* slots, int total, int n_st, int n_pad,
    int dim, const TC* ring, uint64_t* full, uint64_t* empty,
    TO* __restrict__ out, int lane) {
  constexpr int S = kStages<TC>, G = kGroups<TC>;
  constexpr int kSlot = kWarp * kWarp;
  for (int c0 = 0, g0 = 0; c0 < dim; c0 += kWarp, g0 += n_pad) {
    const int W = min(kWarp, dim - c0);
    const int c = c0 + lane;
    float acc = 0.0f;
    int k = 0;                                // the run being added
    int end = off[1];                         // where it ends
    const int q0 = g0 / kGroup, n_grp = n_pad / kGroup;
    bar_wait(&full[q0 % G], (q0 / G) & 1);
    for (int j = 0; j < n_grp; ++j) {
      const int q = q0 + j;
      const bool landed = j + 1 >= n_grp ||
                          bar_test(&full[(q + 1) % G], ((q + 1) / G) & 1);
      const TC* group = ring + ((q * kGroup) % S) * kSlot;
      const int first = j * kGroup;
      if (end >= (first + kGroup) * kWarp && first + kGroup <= n_st) {
        // the whole group is run k's: one block of adds from registers,
        // each stage's second half and the next stage's first half read
        // while its first half is added, so the chain waits on no load
        TC a[16], b[16];
        read_half(a, group, 0, W, lane);
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const TC* slot = group + i * kSlot;
          read_half(b, slot, 16, W, lane);
          acc = add_half(acc, a);
          if (i + 1 < kGroup) read_half(a, slot + kSlot, 0, W, lane);
          acc = add_half(acc, b);
        }
      } else {
        // a run or the stream ends in the group: stage by stage; runs are
        // longer than a stage, so at most one ends in it, after cut entries
        for (int i = 0; i < kGroup && first + i < n_st; ++i) {
          const TC* slot = group + i * kSlot;
          const int v0 = (first + i) * kWarp;
          const int n = min(kWarp, total - v0);
          const int cut = min(end - v0, n);
          int u = 0;
          for (; u < cut; ++u)
            acc = __fadd_rn(acc, to_f32(slot[u * W + lane]));
          if (u < n) {                        // run k ends: its row
            if (c < dim)
              store(out + static_cast<int64_t>(slots[k]) * dim + c, acc);
            acc = 0.0f;
            ++k;
            end = off[k + 1];
            for (; u < n; ++u)
              acc = __fadd_rn(acc, to_f32(slot[u * W + lane]));
          }
        }
      }
      bar_arrive(&empty[q % G]);
      if (!landed) bar_wait(&full[(q + 1) % G], ((q + 1) / G) & 1);
    }
    if (c < dim) store(out + static_cast<int64_t>(slots[k]) * dim + c, acc);
  }
}

template <typename TC, typename TO>
__device__ __forceinline__ void span_role(
    const TC* __restrict__ ct, const int* __restrict__ bag_sorted,
    const int* __restrict__ run_starts, const int* __restrict__ run_slot,
    const int* __restrict__ run_of, const int* __restrict__ n_run,
    TO* __restrict__ out, int n_entries, int dim, bool vec16, int w) {
  constexpr int G = kGroups<TC>;
  extern __shared__ __align__(16) unsigned char ring_bytes[];
  __shared__ int s_list[kMaxLong];
  __shared__ int s_lstart[kMaxLong];
  __shared__ int s_lslot[kMaxLong];
  __shared__ int s_off[kMaxLong + 1];
  __shared__ int s_cnt[kWarps];
  __shared__ uint64_t s_full[G], s_empty[G];
  // the span's run bounds, in the ring until it is filled
  int* s_start = reinterpret_cast<int*>(ring_bytes);
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  // the runs that start among sorted entries [e0, e1): r_lo .. r_hi - 1
  const int e0 = w * kSpan;
  const int e1 = min(e0 + kSpan, n_entries);
  const int before = e0 > 0 ? __ldg(run_of + e0 - 1) : -1;
  const int last = __ldg(run_of + e1 - 1);
  const int nr = __ldg(n_run);
  const int r_lo = min(before + 1, nr);
  const int r_hi = min(last + 1, nr);
  if (r_lo >= r_hi) return;                   // uniform: no run starts here
  const int cnt = r_hi - r_lo;
  for (int i = tid; i <= cnt; i += kThreads) s_start[i] = run_starts[r_lo + i];
  __syncthreads();
  // the long ones, in run order
  int n_long = 0;
  for (int q0 = 0; q0 < cnt; q0 += kThreads) {
    const int j = q0 + tid;
    const bool is_long = j < cnt && s_start[j + 1] - s_start[j] > kShortMax;
    const unsigned m = __ballot_sync(kFull, is_long);
    if (lane == 0) s_cnt[warp] = __popc(m);
    __syncthreads();
    int pre = n_long;
#pragma unroll
    for (int x = 0; x < kWarps; ++x) {
      if (x < warp) pre += s_cnt[x];
      n_long += s_cnt[x];
    }
    if (is_long) s_list[pre + __popc(m & ((1u << lane) - 1u))] = j;
    __syncthreads();                          // s_cnt is rewritten next
  }
  if (n_long == 0) return;                    // uniform
  // the long runs laid end to end: run k is virtual entries [off[k],
  // off[k + 1]); n_long <= kMaxLong (each but the last lies in the span)
  if (tid < n_long) {
    const int j = s_list[tid];
    s_lstart[tid] = s_start[j];
    s_lslot[tid] = run_slot[r_lo + j];
  }
  if (tid == 0) {
    int o = 0;
    for (int k = 0; k < n_long; ++k) {
      s_off[k] = o;
      o += s_start[s_list[k] + 1] - s_start[s_list[k]];
    }
    s_off[n_long] = o;
    for (int i = 0; i < G; ++i) {
      bar_init(&s_full[i], kGroup * kWarp);   // the producer lanes of a group
      bar_init(&s_empty[i], kWarp);           // the adder's lanes
    }
  }
  __syncthreads();                            // s_start is dead from here
  const int total = s_off[n_long];
  const int n_st = (total + kWarp - 1) / kWarp;
  const int n_pad = (n_st + kGroup - 1) / kGroup * kGroup;
  TC* ring = reinterpret_cast<TC*>(ring_bytes);
  if (warp > 0)
    span_producer<TC>(ct, bag_sorted, s_off, s_lstart, n_long, total, n_pad,
                      dim, vec16, ring, s_full, s_empty,
                      warp - 1, lane);
  else
    span_adder<TC, TO>(s_off, s_lslot, total, n_st, n_pad, dim, ring, s_full,
                       s_empty, out, lane);
}

template <typename TC, typename TO, int VEC>
__global__ void __launch_bounds__(kThreads)
ct_scatter_tiles(const TC* __restrict__ ct, const int* __restrict__ bag_sorted,
                 const int* __restrict__ run_starts,
                 const int* __restrict__ run_slot,
                 const int* __restrict__ n_run, TO* __restrict__ out,
                 int n_runs_pad, int dim, int tile) {
  tile_role<TC, TO, VEC>(ct, bag_sorted, run_starts, run_slot, n_run, out,
                         n_runs_pad, dim, tile, blockIdx.x);
}

template <typename TC, typename TO>
__global__ void __launch_bounds__(kThreads, kSpanBlocksPerSm)
ct_scatter_spans(const TC* __restrict__ ct,
                 const int* __restrict__ bag_sorted,
                 const int* __restrict__ run_starts,
                 const int* __restrict__ run_slot,
                 const int* __restrict__ run_of,
                 const int* __restrict__ n_run, TO* __restrict__ out,
                 int n_entries, int dim, int vec16) {
  span_role<TC, TO>(ct, bag_sorted, run_starts, run_slot, run_of, n_run, out,
                    n_entries, dim, vec16 != 0, blockIdx.x);
}

// The library's own stream on each device, for the span blocks, and the
// two events that fork it from the caller's stream and join it back; made
// at a device's first call, and used under `mu` (one launch at a time).
constexpr int kMaxDevices = 64;
struct Side {
  cudaStream_t stream = nullptr;
  cudaEvent_t fork = nullptr, join = nullptr;
};
std::mutex mu;
Side sides[kMaxDevices];

cudaError_t side_for(int device, Side** out) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  Side& s = sides[device];
  cudaError_t err = cudaSuccess;
  if (s.stream == nullptr &&
      (err = cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking)))
    return err;
  if (s.fork == nullptr &&
      (err = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming)))
    return err;
  if (s.join == nullptr &&
      (err = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming)))
    return err;
  *out = &s;
  return cudaSuccess;
}

// The span blocks (long runs) on a side stream and the tiles (short runs)
// on the caller's, at once: the side stream waits for the caller's work so
// far, and the caller's stream for the span blocks, so to the caller it is
// one step on its stream. The two write disjoint rows. The tiles read
// 16-byte column vectors when the rows of ct and of out allow it.
template <typename TC, typename TO>
cudaError_t launch(const void* ct_v, const void* bag_sorted_v,
                   const void* run_starts_v, const void* run_slot_v,
                   const void* run_of_v, const void* n_run_v, void* out_v,
                   int n_runs_pad, int n_entries, int dim, int device,
                   cudaStream_t stream) {
  const TC* ct = static_cast<const TC*>(ct_v);
  const int* bs = static_cast<const int*>(bag_sorted_v);
  const int* rs = static_cast<const int*>(run_starts_v);
  const int* sl = static_cast<const int*>(run_slot_v);
  const int* ro = static_cast<const int*>(run_of_v);
  const int* nr = static_cast<const int*>(n_run_v);
  TO* out = static_cast<TO*>(out_v);
  std::lock_guard<std::mutex> lock(mu);
  Side* side;
  cudaError_t err = side_for(device, &side);
  if (err != cudaSuccess) return err;
  static bool ring_set[kMaxDevices] = {};     // per kernel instance
  if (!ring_set[device]) {
    err = cudaFuncSetAttribute(ct_scatter_spans<TC, TO>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kRingBytes);
    if (err != cudaSuccess) return err;
    ring_set[device] = true;
  }
  if ((err = cudaEventRecord(side->fork, stream)) != cudaSuccess) return err;
  if ((err = cudaStreamWaitEvent(side->stream, side->fork, 0)) != cudaSuccess)
    return err;
  const int n_spans = (n_entries + kSpan - 1) / kSpan;
  const bool rows16 = dim * sizeof(TC) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(ct) % 16 == 0;
  ct_scatter_spans<TC, TO><<<n_spans, kThreads, kRingBytes, side->stream>>>(
      ct, bs, rs, sl, ro, nr, out, n_entries, dim, rows16 ? 1 : 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = cudaEventRecord(side->join, side->stream)) != cudaSuccess)
    return err;
  constexpr int V = 16 / sizeof(TC);
  const bool vec = dim % V == 0 &&
                   reinterpret_cast<uintptr_t>(ct) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % (V * sizeof(TO)) == 0;
  const int nv = vec ? dim / V : dim;         // column vectors per row
  const int tile = nv >= kMaxTile ? 1 : kMaxTile / nv;
  const int n_tiles = (n_runs_pad + tile - 1) / tile;
  if (vec) {
    ct_scatter_tiles<TC, TO, V><<<n_tiles, kThreads, 0, stream>>>(
        ct, bs, rs, sl, nr, out, n_runs_pad, dim, tile);
  } else {
    ct_scatter_tiles<TC, TO, 1><<<n_tiles, kThreads, 0, stream>>>(
        ct, bs, rs, sl, nr, out, n_runs_pad, dim, tile);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return cudaStreamWaitEvent(stream, side->join, 0);
}

template <typename TC>
cudaError_t launch_out(int out_dtype, const void* ct, const void* bag_sorted,
                       const void* run_starts, const void* run_slot,
                       const void* run_of, const void* n_run, void* out,
                       int n_runs_pad, int n_entries, int dim, int device,
                       cudaStream_t stream) {
  if (out_dtype == 0)
    return launch<TC, float>(ct, bag_sorted, run_starts, run_slot, run_of,
                             n_run, out, n_runs_pad, n_entries, dim, device,
                             stream);
  if (out_dtype == 1)
    return launch<TC, __nv_bfloat16>(ct, bag_sorted, run_starts, run_slot,
                                     run_of, n_run, out, n_runs_pad,
                                     n_entries, dim, device, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// ct_dtype, out_dtype: 0 = float32, 1 = bfloat16, each on its own.
// n_runs_pad: the length of run_slot; n_entries: the length of run_of.
extern "C" int ct_scatter_runs(const void* ct, int ct_dtype,
                               const void* bag_sorted, const void* run_starts,
                               const void* run_slot, const void* run_of,
                               const void* n_run, void* out, int out_dtype,
                               int n_runs_pad, int n_entries, int dim,
                               int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_runs_pad == 0 || n_entries == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct_dtype == 0)
    return launch_out<float>(out_dtype, ct, bag_sorted, run_starts, run_slot,
                             run_of, n_run, out, n_runs_pad, n_entries, dim,
                             device, s);
  if (ct_dtype == 1)
    return launch_out<__nv_bfloat16>(out_dtype, ct, bag_sorted, run_starts,
                                     run_slot, run_of, n_run, out, n_runs_pad,
                                     n_entries, dim, device, s);
  return cudaErrorInvalidValue;
}

extern "C" const char* ct_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
