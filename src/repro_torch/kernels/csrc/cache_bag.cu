// Fused cache + residual bag sums (the paper's Fig. 7 lookup, §3.3) for
// Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_fused_cache_bag_kernel
// (called by fused_cache_bag_pallas; per-entry resolution _entry_fns with
// one field and zero offsets, k_max == 1, and the row-DMA ring
// _dma_accumulate), and ::_plain_fused_kernel (entry plain_cache_bag_pallas,
// resolution _plain_entry_fns) as the identity instance below.
//
// What it computes. A request's bag has been rewritten on the host into two
// -1 padded streams: cache_idx (NB, Lc), ids of cached partial sums of
// co-occurring rows (the GRACE cache table, Rc x D), and residual_idx
// (NB, Lr), the union-vocab rows no cache entry covered (the EMT, R x D).
// Each table has its own bank and slot remaps; ``my`` is shared:
//     mine(id) = id >= 0 && (my < 0 || bank[id] == my)
//     out[b] = cast(sum_{j < Lc, mine} float(cache[c_slot[cache_idx[b, j]]])
//                 + sum_{j < Lr, mine} float(emt[e_slot[residual_idx[b, j]]]))
// with ONE fp32 accumulator that walks bag b's cache entries j = 0, 1, ...
// and then its residual entries j = 0, 1, ..., cast once to the EMT's dtype.
// The cache table has the EMT's dtype (the wrapper casts it, as the
// reference does). That is the fused order of the reference's kernel, which
// the plain version cache_residual_bag_plain repeats step for step, so the
// two agree bit for bit. (The reference's jnp path sums the two streams
// apart and adds them after: another fp32 order.)
// The identity instance (plain_cache_bag_forward, the unbanked drop-in of
// kernels/ops.cache_bag) reads each id as its table's row: an entry counts
// iff id >= 0, with no remap or bank read.
//
// Entries that add nothing are skipped: padding, interior holes and foreign
// rows. The reference stops each bag's walk at its effective length (one
// past the last valid entry) and adds +0.0 for the masked entries inside
// it; the accumulator starts at +0 and round-to-nearest never turns it into
// -0, so adding +0 changes nothing, and skipping them gives the same bits.
//
// What bounds it on the card: bytes. At the main-path shape (NB = 512 bags
// of batch 64 x 8 fields, Lc = 64, Lr = 256, D = 32 fp32) a bag holds ~113
// residual rows and ~4 cache entries: ~60 k random reads of 128-byte rows
// of a 2.4 GB EMT (about half of them distinct) and of a few hundred cache
// rows, their 4-byte slots and the ids: ~4.5 MB of distinct bytes, ~1.4 us
// at 3.35 TB/s. The adds are nothing against the card's rate.
// Every row read is the end of a dependent chain idx -> bank/slot -> row,
// so the kernel is latency-bound unless the chain is paid rarely and many
// rows are in flight. The first design paid the chain once per 32-entry
// chunk, 10 times a bag, with 32 rows in flight: 22.2 us (NVIDIA
// H100 80GB HBM3, 700 W, CUDA events, L2 flushed; chip_smoke.py).
//
// What the design does about it (banked_bag.cu's resolve-once ring, over
// two streams): one warp per bag, and
//   * resolve a round of 512 entries of the bag's two streams at once, the
//     cache entries first, then the residual ones: lane l takes entries l,
//     l + 32, ..., l + 480, all 16 idx loads first, then every bank and
//     slot load, each through its own table's remaps. At the main path
//     (Lc + Lr = 320) one round is the whole bag, so the chain costs about
//     two memory latencies a bag;
//   * compact the round's live slots into shared memory in entry order
//     (ballot and popc prefix), counting nc, the live cache entries, which
//     come first: padding, holes and foreign rows cost no copy at all (about
//     half of each residual stream on the cached path is padding);
//   * stream the live rows through a shared-memory ring of up to 8 stages
//     of 32 rows with cp.async (16-byte units when both tables' bases and
//     the row stride allow it, 4-byte ones otherwise, 2-byte bf16 rows of
//     odd width by plain loads and stores): list entry i reads the cache
//     table if i < nc, the EMT otherwise. A round's list of up to 512 rows
//     runs through the ring as one pipeline; a longer bag takes more rounds;
//   * the lane that owns a column adds it from the ring in list order while
//     later stages are still landing;
//   * the launch geometry (bags per block, stages, copy unit) comes from the
//     wrapper (kernels/embedding_bag.bag_geometry, shapes and base
//     addresses only) and is checked here;
//   * D > 128 takes one pass of 128 columns at a time (K = 4 columns a
//     lane), reusing the compacted list when the bag is one round.
// The per-column order is the reference's: one thread owns one column of one
// bag, adds in list order in fp32, casts once; no bag is split and there
// are no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxBagsPerBlock = 2;  // one warp per bag
constexpr int kStageRows = 32;       // rows of a bag per ring stage
constexpr int kMaxStages = 8;
constexpr int kResolve = 16;         // entries a lane resolves per round
constexpr int kRound = kWarp * kResolve;   // entries resolved at once
constexpr int kIssue = 8;            // copies a lane issues per batch
constexpr int kMaxBlockSmem = 232448;  // 227 KB, the most a block may use
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Copy kVec bytes of a table row into the ring: cp.async for 16 and 4
// bytes (asynchronous; completes at the wait below), a plain 2-byte load
// and store for bf16 rows of odd width.
template <int kVec>
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if constexpr (kVec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Wait until at most n of this thread's committed groups are in flight
// (a chain of tests, the full ring's n = 7 first: a switch's jump table
// costs a constant-memory load each time).
__device__ __forceinline__ void wait_pending(int n) {
  if (n >= 7) {
    wait_group<7>();
  } else if (n == 6) {
    wait_group<6>();
  } else if (n == 5) {
    wait_group<5>();
  } else if (n == 4) {
    wait_group<4>();
  } else if (n == 3) {
    wait_group<3>();
  } else if (n == 2) {
    wait_group<2>();
  } else if (n == 1) {
    wait_group<1>();
  } else {
    wait_group<0>();
  }
}

// How an entry's id becomes a table slot: through its table's (bank, slot)
// remaps (kRemap), or as it is (kIdentity: no remap, no ownership test).
enum class Resolve { kRemap, kIdentity };

// Slots of entries base + lane + 32 i (i < kResolve) of a bag's two streams
// laid end to end (cache entries [0, lc), then residual entries [lc, lc +
// lr)), into s[]: the slot in its own table, or -1 when the entry adds
// nothing (padding, past the streams' end, or a row another bank owns).
// All idx loads are issued first, then every bank and slot load.
template <Resolve kMode>
__device__ __forceinline__ void resolve_round(
    const int* __restrict__ c_ids, int lc, const int* __restrict__ r_ids,
    int lr, int base, const int* __restrict__ c_bank,
    const int* __restrict__ c_slot, const int* __restrict__ e_bank,
    const int* __restrict__ e_slot, int my, int lane, int (&s)[kResolve]) {
  int raw[kResolve];
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    const int p = base + lane + kWarp * i;
    raw[i] = p < lc ? c_ids[p] : p < lc + lr ? r_ids[p - lc] : -1;
  }
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    if constexpr (kMode == Resolve::kIdentity) {
      s[i] = raw[i] >= 0 ? raw[i] : -1;
    } else {
      const bool in_cache = base + lane + kWarp * i < lc;
      int owner = my;                   // my < 0 owns every row
      int got = -1;
      if (raw[i] >= 0) {
        got = __ldg((in_cache ? c_slot : e_slot) + raw[i]);
        if (my >= 0) owner = __ldg((in_cache ? c_bank : e_bank) + raw[i]);
      }
      s[i] = owner == my && got >= 0 ? got : -1;
    }
  }
}

// The live slots of a round (s[i] >= 0 for entry base + lane + 32 i), in
// entry order, into list[0..n); returns n. *nc: how many of them are cache
// entries (the round's entries below n_cache, which is lc - base).
__device__ __forceinline__ int compact(const int (&s)[kResolve], int n_cache,
                                       int lane, int* __restrict__ list,
                                       int* nc) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0, c = 0;
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    const unsigned m = __ballot_sync(kFull, s[i] >= 0);
    if (s[i] >= 0) list[n + __popc(m & below)] = s[i];
    // lanes of this group that hold cache entries: the first k
    const int k = min(max(n_cache - kWarp * i, 0), kWarp);
    c += __popc(k == kWarp ? m : m & ((1u << k) - 1u));
    n += __popc(m);
  }
  *nc = c;
  return n;
}

// Add the rows of list[0..n) into acc, in list order, through the ring of
// `stages` buffers of kStageRows rows: row i is read at slot list[i] of
// table `a` (a pass's base) if i < nc, else of table `b`. Stage t is issued
// stages - 1 steps before it is added; one cp.async group a step; a lane
// issues 8 units at a time, their slots read first. b_issue and b_add (the
// ring buffers of the next stage to issue and to add) carry across calls.
template <typename T, int K, int kVec>
__device__ __forceinline__ void stream_rows(
    float (&acc)[K], const int* __restrict__ list, int n, int nc,
    const unsigned char* a, const unsigned char* b, int64_t stride,
    int units, uint32_t magic, int cols, unsigned char* ring, int stages,
    int& b_issue, int& b_add, int lane) {
  constexpr int kPass = kWarp * K;
  constexpr int kRowBytes = kPass * static_cast<int>(sizeof(T));
  constexpr int kStageBytes = kStageRows * kRowBytes;
  const int n_st = (n + kStageRows - 1) / kStageRows;
  if (n_st == 0) return;
  for (int t = 0; t < n_st + stages - 1; ++t) {
    if (t < n_st) {
      const int row0 = t * kStageRows;
      unsigned char* dst0 = ring + b_issue * kStageBytes;
      const int total = min(kStageRows, n - row0) * units;
      for (int u0 = lane; u0 < total; u0 += kWarp * kIssue) {
        int r[kIssue];
        const unsigned char* src[kIssue];
#pragma unroll
        for (int i = 0; i < kIssue; ++i) {
          const int u = u0 + kWarp * i;
          r[i] = units == 1 ? u : static_cast<int>(
              __umulhi(static_cast<uint32_t>(u), magic));
          const int e = row0 + r[i];
          src[i] = u < total ? (e < nc ? a : b) + list[e] * stride : a;
        }
#pragma unroll
        for (int i = 0; i < kIssue; ++i) {
          const int u = u0 + kWarp * i;
          if (u < total) {
            const int v = (u - r[i] * units) * kVec;
            copy_unit<kVec>(dst0 + r[i] * kRowBytes + v, src[i] + v);
          }
        }
      }
      b_issue = b_issue + 1 == stages ? 0 : b_issue + 1;
    }
    commit_group();
    const int ta = t - (stages - 1);
    if (ta >= 0) {
      const int buf = b_add;
      b_add = b_add + 1 == stages ? 0 : b_add + 1;
      wait_pending(stages - 1);               // stage ta's copies landed
      __syncwarp();
      const T* rb = reinterpret_cast<const T*>(ring + buf * kStageBytes)
          + lane;
      const int rows = min(kStageRows, n - ta * kStageRows);
      if (rows == kStageRows) {
#pragma unroll
        for (int r = 0; r < kStageRows; ++r) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            acc[k] += lane + kWarp * k < cols
                ? to_f32(rb[r * kPass + kWarp * k]) : 0.0f;
          }
        }
      } else {
#pragma unroll 4
        for (int r = 0; r < rows; ++r) {
#pragma unroll
          for (int k = 0; k < K; ++k) {
            acc[k] += lane + kWarp * k < cols
                ? to_f32(rb[r * kPass + kWarp * k]) : 0.0f;
          }
        }
      }
      __syncwarp();                           // buffer buf free again
    }
  }
}

// Shared memory of one bag: a round's compacted slots (512 x 4 bytes),
// then `stages` ring stages of kStageRows rows of a pass's 32 K columns
// each (the ring's row stride is a compile-time constant, whatever D is).
constexpr int kListBytes = kRound * 4;

__host__ __device__ __forceinline__ int bag_smem_bytes(int stages,
                                                       int row_bytes) {
  return kListBytes + stages * kStageRows * row_bytes;
}

template <typename T, int K, int kVec, Resolve kMode>
__global__ void __launch_bounds__(kWarp * kMaxBagsPerBlock)
cache_bag_kernel(const T* __restrict__ emt, const T* __restrict__ cache,
                 const int* __restrict__ e_bank,
                 const int* __restrict__ e_slot,
                 const int* __restrict__ c_bank,
                 const int* __restrict__ c_slot, int my,
                 const int* __restrict__ cache_idx,
                 const int* __restrict__ resid_idx, T* __restrict__ out,
                 int nb, int lc, int lr, int dim, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPass = kWarp * K;            // columns per pass
  constexpr int kRowBytes = kPass * static_cast<int>(sizeof(T));
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int bag = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (bag >= nb) return;                      // uniform across the warp
  unsigned char* region = smem + warp * bag_smem_bytes(stages, kRowBytes);
  int* list = reinterpret_cast<int*>(region);
  unsigned char* ring = region + kListBytes;
  const int* c_ids = cache_idx + static_cast<int64_t>(bag) * lc;
  const int* r_ids = resid_idx + static_cast<int64_t>(bag) * lr;
  T* out_row = out + static_cast<int64_t>(bag) * dim;
  const unsigned char* ebytes = reinterpret_cast<const unsigned char*>(emt);
  const unsigned char* cbytes = reinterpret_cast<const unsigned char*>(cache);
  // int64: slot * row stride exceeds 2^31 on the largest tables
  const int64_t stride = static_cast<int64_t>(dim) * sizeof(T);
  const int n_rounds = (lc + lr + kRound - 1) / kRound;
  int resolved = -1;                          // the round list[] holds
  int n = 0, nc = 0;
  int b_issue = 0, b_add = 0;

  for (int c0 = 0; c0 < dim; c0 += kPass) {
    const int cols = min(kPass, dim - c0);
    // copy units of a row's pass, and u / units as a multiply-high (exact
    // for u < 2^16 and 1 < units < 2^16)
    const int units = cols * static_cast<int>(sizeof(T)) / kVec;
    const uint32_t magic =
        units == 1 ? 0u : 0xffffffffu / static_cast<uint32_t>(units) + 1u;
    const int64_t c0_bytes = static_cast<int64_t>(c0) * sizeof(T);
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;

    for (int rd = 0; rd < n_rounds; ++rd) {
      if (resolved != rd) {                   // one round: resolve once
        int s[kResolve];
        resolve_round<kMode>(c_ids, lc, r_ids, lr, rd * kRound, c_bank,
                             c_slot, e_bank, e_slot, my, lane, s);
        __syncwarp();                         // the last round's reads
        n = compact(s, lc - rd * kRound, lane, list, &nc);
        __syncwarp();
        resolved = rd;
      }
      stream_rows<T, K, kVec>(acc, list, n, nc, cbytes + c0_bytes,
                              ebytes + c0_bytes, stride, units, magic, cols,
                              ring, stages, b_issue, b_add, lane);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = lane + kWarp * k;
      if (c < cols) store(out_row + c0 + c, acc[k]);
    }
  }
}

struct Geometry {
  int bags_per_block, stages, vec;
};

// Opt a kernel in to `smem` bytes of dynamic shared memory where that is
// more than the 48 KB a block gets without (D > 64 with several stages).
cudaError_t opt_in(const void* kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T>
using CacheKernel = void (*)(const T*, const T*, const int*, const int*,
                             const int*, const int*, int, const int*,
                             const int*, T*, int, int, int, int, int);

// The instance for D (K = 1, 2 or 4 columns a lane) and the copy unit; null
// for a unit the dtype does not take.
template <typename T, int K, Resolve kMode>
CacheKernel<T> pick_vec(int vec) {
  if (vec == 16) return cache_bag_kernel<T, K, 16, kMode>;
  if (vec == 4) return cache_bag_kernel<T, K, 4, kMode>;
  if constexpr (sizeof(T) == 2) {
    if (vec == 2) return cache_bag_kernel<T, K, 2, kMode>;
  }
  return nullptr;
}

template <typename T, Resolve kMode>
CacheKernel<T> pick(int dim, int vec, int* row_bytes) {
  const int k = dim <= kWarp ? 1 : dim <= 2 * kWarp ? 2 : 4;
  *row_bytes = kWarp * k * static_cast<int>(sizeof(T));
  if (k == 1) return pick_vec<T, 1, kMode>(vec);
  if (k == 2) return pick_vec<T, 2, kMode>(vec);
  return pick_vec<T, 4, kMode>(vec);
}

template <typename T, Resolve kMode>
cudaError_t launch(const void* emt, const void* cache, const void* e_bank,
                   const void* e_slot, const void* c_bank, const void* c_slot,
                   int my, const void* cache_idx, const void* resid_idx,
                   void* out, int nb, int lc, int lr, int dim, Geometry g,
                   cudaStream_t stream) {
  // the geometry the wrapper computed, checked against what the kernel
  // needs: a copy unit that divides the row stride and both tables' bases
  const int64_t row = static_cast<int64_t>(dim) * sizeof(T);
  int row_bytes = 0;
  const CacheKernel<T> kernel = pick<T, kMode>(dim, g.vec, &row_bytes);
  if (kernel == nullptr || row % g.vec != 0 ||
      reinterpret_cast<uintptr_t>(emt) % g.vec != 0 ||
      reinterpret_cast<uintptr_t>(cache) % g.vec != 0 ||
      g.bags_per_block < 1 || g.bags_per_block > kMaxBagsPerBlock ||
      g.stages < 1 || g.stages > kMaxStages) {
    return cudaErrorInvalidValue;
  }
  const int smem = g.bags_per_block * bag_smem_bytes(g.stages, row_bytes);
  if (smem > kMaxBlockSmem) return cudaErrorInvalidValue;
  const cudaError_t err = opt_in(reinterpret_cast<const void*>(kernel), smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nb + g.bags_per_block - 1) / g.bags_per_block);
  const dim3 block(kWarp * g.bags_per_block);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(emt), static_cast<const T*>(cache),
      static_cast<const int*>(e_bank), static_cast<const int*>(e_slot),
      static_cast<const int*>(c_bank), static_cast<const int*>(c_slot), my,
      static_cast<const int*>(cache_idx), static_cast<const int*>(resid_idx),
      static_cast<T*>(out), nb, lc, lr, dim, g.stages);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (EMT, cache table and output alike).
// The launch geometry (kernels/embedding_bag.bag_geometry): bags per block
// (1 or 2), stages (ring stages of 32 rows, 1 to 8) and vec (the copy unit
// in bytes: 16 or 4 by cp.async, 2 by plain loads and stores).
extern "C" int cache_bag_forward(const void* emt, const void* cache,
                                 int dtype, const void* e_bank,
                                 const void* e_slot, const void* c_bank,
                                 const void* c_slot, int my,
                                 const void* cache_idx, const void* resid_idx,
                                 void* out, int nb, int lc, int lr, int dim,
                                 int device, void* stream, int bags_per_block,
                                 int stages, int vec) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{bags_per_block, stages, vec};
  if (dtype == 0) {
    return launch<float, Resolve::kRemap>(emt, cache, e_bank, e_slot, c_bank,
                                          c_slot, my, cache_idx, resid_idx,
                                          out, nb, lc, lr, dim, g, s);
  } else if (dtype == 1) {
    return launch<__nv_bfloat16, Resolve::kRemap>(
        emt, cache, e_bank, e_slot, c_bank, c_slot, my, cache_idx, resid_idx,
        out, nb, lc, lr, dim, g, s);
  }
  return cudaErrorInvalidValue;
}

// The identity instance: both tables read at the ids themselves (no remap,
// no ownership). dtype and the geometry as above.
extern "C" int plain_cache_bag_forward(const void* emt, const void* cache,
                                       int dtype, const void* cache_idx,
                                       const void* resid_idx, void* out,
                                       int nb, int lc, int lr, int dim,
                                       int device, void* stream,
                                       int bags_per_block, int stages,
                                       int vec) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{bags_per_block, stages, vec};
  if (dtype == 0) {
    return launch<float, Resolve::kIdentity>(
        emt, cache, nullptr, nullptr, nullptr, nullptr, -1, cache_idx,
        resid_idx, out, nb, lc, lr, dim, g, s);
  } else if (dtype == 1) {
    return launch<__nv_bfloat16, Resolve::kIdentity>(
        emt, cache, nullptr, nullptr, nullptr, nullptr, -1, cache_idx,
        resid_idx, out, nb, lc, lr, dim, g, s);
  }
  return cudaErrorInvalidValue;
}

extern "C" const char* cache_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
