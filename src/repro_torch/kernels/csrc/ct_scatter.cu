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
// destination table slot, and sorts the entries stably by slot. Entries that land on one slot form a run
// [run_starts[r], run_starts[r + 1]) of bag_sorted, in entry order; runs
// r < n_run are live, the rest are empty. For each live run:
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
//     of two rounds in shared memory: warps 1..7 each copy one 32-entry
//     stage a round (bag ids read two rounds ahead, rows one round ahead,
//     converted to fp32, stored column-major with 16-byte accesses), and
//     warp 0, lanes across 32 columns a pass, adds every staged row in
//     order, reading a round's stages ahead of its adds, and stores a run's
//     row where the run ends. A long run costs its adds at shared-memory
//     speed, not a load latency each.
// Measured (chip_smoke.py, the same card and method): 19.3 us on the train
// ids, 31.6 on Zipf ids, 30.4 on the CSR prep; one 32,768-entry run costs
// ~7 ns an entry in its span block, about twice its add chain
// (tools/kernel_probe.py).
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
constexpr int kPitch = kWarp + 4;  // a staged column: 32 entries, padded so
                                   // 16-byte accesses of 8 lanes miss no bank
constexpr int kSlot = kWarp * kPitch;                   // a stage: 32 columns
constexpr int kBufFloats = kProducers * kSlot;          // a round's stages
constexpr int kRing = 2;                                // rounds in the ring
constexpr int kRingBytes = kRing * kBufFloats * 4;      // fp32

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

// Producer side: column c of the rows of virtual entries [32 st, 32 st + 32)
// of the span's long runs laid end to end (bag ids in `ids`, one per lane),
// as fp32 in v[entry]; 0.0f past the end or past D. The ids pass through
// the warp's slot of shared memory, not a shuffle: the producers run in a
// branch, where each shuffle would pay a collective warp sync.
template <typename TC>
__device__ __forceinline__ void load_stage(float (&v)[kWarp], int* id_buf,
                                           const TC* __restrict__ ct, int ids,
                                           int st, int total, int dim, int c,
                                           int lane) {
  id_buf[lane] = ids;
  __syncwarp();
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q) {
    const int4 b = reinterpret_cast<const int4*>(id_buf)[q];
    const int bq[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = 4 * q + i;
      v[u] = st * kWarp + u < total && c < dim
                 ? to_f32(ct[static_cast<int64_t>(bq[i]) * dim + c])
                 : 0.0f;
    }
  }
  __syncwarp();                               // id_buf is rewritten next
}

// The stage's rows into its slot, column-major: entry u of column lane at
// slot[lane * kPitch + u].
__device__ __forceinline__ void store_stage(float* slot,
                                            const float (&v)[kWarp],
                                            int lane) {
  float4* col = reinterpret_cast<float4*>(slot + lane * kPitch);
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q)
    col[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
}

// acc plus the 32 staged entries of column lane of a slot, in order.
__device__ __forceinline__ float add_slot(float acc, const float* slot,
                                          int lane) {
  const float4* col = reinterpret_cast<const float4*>(slot + lane * kPitch);
  float4 a[kWarp / 4];
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q) a[q] = col[q];
#pragma unroll
  for (int q = 0; q < kWarp / 4; ++q) {
    acc = __fadd_rn(acc, a[q].x);
    acc = __fadd_rn(acc, a[q].y);
    acc = __fadd_rn(acc, a[q].z);
    acc = __fadd_rn(acc, a[q].w);
  }
  return acc;
}

// acc plus the `full` whole stages of a round (full <= kProducers), in
// entry order; the next stage's shared loads are issued before the current
// stage's adds.
__device__ __forceinline__ float add_stages(float acc, const float* buf,
                                            int full, int lane) {
  float4 a[kWarp / 4], b[kWarp / 4];
  if (full > 0) {
    const float4* col = reinterpret_cast<const float4*>(buf + lane * kPitch);
#pragma unroll
    for (int q = 0; q < kWarp / 4; ++q) a[q] = col[q];
  }
#pragma unroll
  for (int i = 0; i < kProducers; i += 2) {
    if (i + 1 < full) {
      const float4* col = reinterpret_cast<const float4*>(
          buf + (i + 1) * kSlot + lane * kPitch);
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) b[q] = col[q];
    }
    if (i < full) {
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) {
        acc = __fadd_rn(acc, a[q].x);
        acc = __fadd_rn(acc, a[q].y);
        acc = __fadd_rn(acc, a[q].z);
        acc = __fadd_rn(acc, a[q].w);
      }
    }
    if (i + 2 < full) {
      const float4* col = reinterpret_cast<const float4*>(
          buf + (i + 2) * kSlot + lane * kPitch);
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) a[q] = col[q];
    }
    if (i + 1 < full) {
#pragma unroll
      for (int q = 0; q < kWarp / 4; ++q) {
        acc = __fadd_rn(acc, b[q].x);
        acc = __fadd_rn(acc, b[q].y);
        acc = __fadd_rn(acc, b[q].z);
        acc = __fadd_rn(acc, b[q].w);
      }
    }
  }
  return acc;
}

// The bag id of the lane's virtual entry 32 st + lane (0 past the end): run
// k holds virtual entries [off[k], off[k + 1]) = sorted entries start[k]...
__device__ __forceinline__ int stage_ids(const int* __restrict__ bag_sorted,
                                         const int* off, const int* start,
                                         int n_long, int st, int total,
                                         int lane) {
  const int v = st * kWarp + lane;
  if (v >= total) return 0;
  int k = 0;
  while (k + 1 < n_long && off[k + 1] <= v) ++k;
  return __ldg(bag_sorted + start[k] + v - off[k]);
}

template <typename TC, typename TO>
__device__ __forceinline__ void span_role(
    const TC* __restrict__ ct, const int* __restrict__ bag_sorted,
    const int* __restrict__ run_starts, const int* __restrict__ run_slot,
    const int* __restrict__ run_of, const int* __restrict__ n_run,
    TO* __restrict__ out, int n_entries, int dim, int w) {
  __shared__ int s_start[kSpan + 1];
  __shared__ int s_list[kMaxLong];
  __shared__ int s_lstart[kMaxLong];
  __shared__ int s_lslot[kMaxLong];
  __shared__ int s_off[kMaxLong + 1];
  __shared__ __align__(16) int s_ids[kProducers][kWarp];
  __shared__ int s_cnt[kWarps];
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
  }
  __syncthreads();
  const int total = s_off[n_long];
  const int n_st = (total + kWarp - 1) / kWarp;
  const int rounds = (n_st + kProducers - 1) / kProducers;
  extern __shared__ __align__(16) float ring[];   // [kRing][kProducers] slots
  for (int c0 = 0; c0 < dim; c0 += kWarp) {
    const int c = c0 + lane;
    if (warp > 0) {
      // producer: stage t * kProducers + warp - 1 of round t; its rows are
      // read a round before they are stored (so a round's loads are in
      // flight while the adder takes the round before), and its bag ids
      // two rounds before they are used
      const int me = warp - 1;
      float* mine = ring + me * kSlot;
      float v[kWarp];
      int ids = stage_ids(bag_sorted, s_off, s_lstart, n_long, me, total,
                          lane);
      load_stage<TC>(v, s_ids[me], ct, ids, me, total, dim, c, lane);
      store_stage(mine, v, lane);
      ids = stage_ids(bag_sorted, s_off, s_lstart, n_long, kProducers + me,
                      total, lane);
      int next = stage_ids(bag_sorted, s_off, s_lstart, n_long,
                           2 * kProducers + me, total, lane);
      int after = stage_ids(bag_sorted, s_off, s_lstart, n_long,
                            3 * kProducers + me, total, lane);
      if (rounds > 1)
        load_stage<TC>(v, s_ids[me], ct, ids, kProducers + me, total, dim, c,
                       lane);
      __syncthreads();
      for (int t = 0; t < rounds; ++t) {
        if (t + 1 < rounds)
          store_stage(mine + ((t + 1) % kRing) * kBufFloats, v, lane);
        if (t + 2 < rounds) {
          load_stage<TC>(v, s_ids[me], ct, next, (t + 2) * kProducers + me,
                         total, dim, c, lane);
          next = after;
          after = stage_ids(bag_sorted, s_off, s_lstart, n_long,
                            (t + 4) * kProducers + me, total, lane);
        }
        __syncthreads();
      }
    } else {
      // the adder: every stage in order; one store per run, where it ends
      __syncthreads();
      float acc = 0.0f;
      int k = 0;                              // the run being added
      for (int t = 0; t < rounds; ++t) {
        const float* buf = ring + (t % kRing) * kBufFloats;
        const int r0 = t * kProducers * kWarp;
        const int rn = min(kProducers * kWarp, total - r0);
        if (rn % kWarp == 0 && (k + 1 >= n_long || s_off[k + 1] >= r0 + rn)) {
          // no run ends inside this round: its whole stages, in order
          acc = add_stages(acc, buf, rn / kWarp, lane);
          __syncthreads();
          continue;
        }
        for (int i = 0; i < kProducers; ++i) {
          const int v0 = (t * kProducers + i) * kWarp;
          if (v0 >= total) break;
          const float* rows = buf + i * kSlot + lane * kPitch;
          const int n = min(kWarp, total - v0);
          if (k + 1 < n_long && s_off[k + 1] == v0) {   // a run ended
            if (c < dim)
              store(out + static_cast<int64_t>(s_lslot[k]) * dim + c, acc);
            acc = 0.0f;
            ++k;
          }
          // runs are longer than 32 entries: one more ends here at most
          const int cut = k + 1 < n_long ? min(n, s_off[k + 1] - v0) : n;
          if (cut == kWarp) {
            acc = add_slot(acc, buf + i * kSlot, lane);
          } else {
            int u = 0;
            for (; u < cut; ++u) acc = __fadd_rn(acc, rows[u]);
            if (u < n) {
              if (c < dim)
                store(out + static_cast<int64_t>(s_lslot[k]) * dim + c, acc);
              acc = 0.0f;
              ++k;
              for (; u < n; ++u) acc = __fadd_rn(acc, rows[u]);
            }
          }
        }
        __syncthreads();
      }
      if (c < dim)
        store(out + static_cast<int64_t>(s_lslot[k]) * dim + c, acc);
    }
    __syncthreads();                          // the ring is refilled next
  }
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
__global__ void __launch_bounds__(kThreads)
ct_scatter_spans(const TC* __restrict__ ct,
                 const int* __restrict__ bag_sorted,
                 const int* __restrict__ run_starts,
                 const int* __restrict__ run_slot,
                 const int* __restrict__ run_of,
                 const int* __restrict__ n_run, TO* __restrict__ out,
                 int n_entries, int dim) {
  span_role<TC, TO>(ct, bag_sorted, run_starts, run_slot, run_of,
                            n_run, out, n_entries, dim, blockIdx.x);
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
  ct_scatter_spans<TC, TO><<<n_spans, kThreads, kRingBytes, side->stream>>>(
      ct, bs, rs, sl, ro, nr, out, n_entries, dim);
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
