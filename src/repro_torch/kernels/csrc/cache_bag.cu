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
// of batch 64 x 8 fields, Lc = 64, Lr = 256, D = 32 fp32) a bag holds ~124
// residual rows and a few cache entries: ~64 k random 128-byte rows of a
// 3 GB EMT, a few hundred distinct cache rows, and 4-byte slots: ~9 MB,
// ~3 us at 3.35 TB/s. The adds are nothing against the card's rate. Every
// row read is a dependent chain idx -> bank/slot -> row, so the kernel is
// latency-bound unless enough loads are in flight.
//
// What the design does about it (the first design; banked_bag.cu's):
//   * one warp per bag, lanes across D: at D = 32 fp32 a row is one coalesced
//     128-byte read; for D > 32 a lane owns K columns (K = 2 or 4), and
//     D > 128 walks the bag again per 128-column pass;
//   * each lane resolves one entry of a 32-entry chunk (coalesced idx read,
//     then its own bank/slot reads); the warp compacts the chunk's live
//     entries, in entry order, into a per-warp list in shared memory (ballot
//     and popc), so holes and the -1 tail cost no row loads and an all-pad
//     chunk costs none at all;
//   * the next chunk's entries are resolved before the current chunk's rows
//     are read, and a lane issues all row loads of a chunk before it adds
//     them (32 / K loads in flight), in order, into its fp32 accumulators;
//   * slot * D in int64; one store per bag; no bag is split across threads
//     and there are no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBagsPerBlock = 4;   // one warp per bag
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Slot of entry j of a bag's stream, or -1 when the entry adds nothing
// (past the stream's end, padding or a hole, or a row another bank owns).
// kIdentity: the id is the slot (no remap or bank read).
template <bool kIdentity>
__device__ __forceinline__ int resolve(const int* __restrict__ ids, int j,
                                       int len, const int* __restrict__ bank,
                                       const int* __restrict__ slot, int my) {
  if (j >= len) return -1;
  const int id = ids[j];
  if (id < 0) return -1;
  if constexpr (kIdentity) {
    return id;
  } else {
    if (my >= 0 && bank[id] != my) return -1;
    return slot[id];
  }
}

// Add one stream of bag ``ids`` (``len`` entries) into acc, in entry order.
// ``live`` is this warp's 32-slot compaction list in shared memory.
template <typename T, int K, bool kIdentity>
__device__ __forceinline__ void walk(float (&acc)[K],
                                     const T* __restrict__ table,
                                     const int* __restrict__ ids, int len,
                                     const int* __restrict__ bank,
                                     const int* __restrict__ slot, int my,
                                     int dim, int c0, int lane,
                                     int* __restrict__ live) {
  constexpr int kUnroll = kWarp / K;          // row loads in flight per lane
  const unsigned below = (1u << lane) - 1u;
  int src = resolve<kIdentity>(ids, lane, len, bank, slot, my);
  for (int j0 = 0; j0 < len; j0 += kWarp) {
    const int nxt =
        resolve<kIdentity>(ids, j0 + kWarp + lane, len, bank, slot, my);
    const unsigned mask = __ballot_sync(kFull, src >= 0);
    const int n = __popc(mask);
    if (src >= 0) live[__popc(mask & below)] = src;
    __syncwarp();
    for (int u0 = 0; u0 < n; u0 += kUnroll) {
      float v[kUnroll][K];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool take = u0 + u < n;
        const int s = take ? live[u0 + u] : 0;
        // int64: slot * D exceeds 2^31 on the largest tables
        const T* row = table + static_cast<int64_t>(s) * dim;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int c = c0 + lane + kWarp * k;
          v[u][k] = (take && c < dim) ? to_f32(row[c]) : 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int k = 0; k < K; ++k) acc[k] += v[u][k];
      }
    }
    __syncwarp();                             // the list is rewritten next
    src = nxt;
  }
}

template <typename T, int K, bool kIdentity>
__global__ void __launch_bounds__(kWarp * kBagsPerBlock)
cache_bag_kernel(const T* __restrict__ emt, const T* __restrict__ cache,
                 const int* __restrict__ e_bank,
                 const int* __restrict__ e_slot,
                 const int* __restrict__ c_bank,
                 const int* __restrict__ c_slot, int my,
                 const int* __restrict__ cache_idx,
                 const int* __restrict__ resid_idx, T* __restrict__ out,
                 int nb, int lc, int lr, int dim) {
  __shared__ int live[kBagsPerBlock][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int bag = blockIdx.x * kBagsPerBlock + w;
  if (bag >= nb) return;                      // uniform across the warp
  const int* c_ids = cache_idx + static_cast<int64_t>(bag) * lc;
  const int* r_ids = resid_idx + static_cast<int64_t>(bag) * lr;
  T* out_row = out + static_cast<int64_t>(bag) * dim;

  for (int c0 = 0; c0 < dim; c0 += kWarp * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;
    walk<T, K, kIdentity>(acc, cache, c_ids, lc, c_bank, c_slot, my, dim, c0, lane,
               live[w]);
    walk<T, K, kIdentity>(acc, emt, r_ids, lr, e_bank, e_slot, my, dim, c0, lane,
               live[w]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + lane + kWarp * k;
      if (c < dim) store(out_row + c, acc[k]);
    }
  }
}

template <typename T, bool kIdentity>
void launch(const void* emt, const void* cache, const void* e_bank,
            const void* e_slot, const void* c_bank, const void* c_slot,
            int my, const void* cache_idx, const void* resid_idx, void* out,
            int nb, int lc, int lr, int dim, cudaStream_t stream) {
  const dim3 grid((nb + kBagsPerBlock - 1) / kBagsPerBlock);
  const dim3 block(kWarp * kBagsPerBlock);
  const T* e = static_cast<const T*>(emt);
  const T* c = static_cast<const T*>(cache);
  const int* eb = static_cast<const int*>(e_bank);
  const int* es = static_cast<const int*>(e_slot);
  const int* cb = static_cast<const int*>(c_bank);
  const int* cs = static_cast<const int*>(c_slot);
  const int* ci = static_cast<const int*>(cache_idx);
  const int* ri = static_cast<const int*>(resid_idx);
  T* o = static_cast<T*>(out);
  if (dim <= kWarp) {
    cache_bag_kernel<T, 1, kIdentity><<<grid, block, 0, stream>>>(
        e, c, eb, es, cb, cs, my, ci, ri, o, nb, lc, lr, dim);
  } else if (dim <= 2 * kWarp) {
    cache_bag_kernel<T, 2, kIdentity><<<grid, block, 0, stream>>>(
        e, c, eb, es, cb, cs, my, ci, ri, o, nb, lc, lr, dim);
  } else {
    cache_bag_kernel<T, 4, kIdentity><<<grid, block, 0, stream>>>(
        e, c, eb, es, cb, cs, my, ci, ri, o, nb, lc, lr, dim);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (EMT, cache table and output alike).
extern "C" int cache_bag_forward(const void* emt, const void* cache,
                                 int dtype, const void* e_bank,
                                 const void* e_slot, const void* c_bank,
                                 const void* c_slot, int my,
                                 const void* cache_idx, const void* resid_idx,
                                 void* out, int nb, int lc, int lr, int dim,
                                 int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, false>(emt, cache, e_bank, e_slot, c_bank, c_slot, my,
                         cache_idx, resid_idx, out, nb, lc, lr, dim, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, false>(emt, cache, e_bank, e_slot, c_bank, c_slot,
                                 my, cache_idx, resid_idx, out, nb, lc, lr,
                                 dim, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The identity instance: both tables read at the ids themselves (no remap,
// no ownership). dtype as above.
extern "C" int plain_cache_bag_forward(const void* emt, const void* cache,
                                       int dtype, const void* cache_idx,
                                       const void* resid_idx, void* out,
                                       int nb, int lc, int lr, int dim,
                                       int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, true>(emt, cache, nullptr, nullptr, nullptr, nullptr, -1,
                        cache_idx, resid_idx, out, nb, lc, lr, dim, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, true>(emt, cache, nullptr, nullptr, nullptr,
                                nullptr, -1, cache_idx, resid_idx, out, nb,
                                lc, lr, dim, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* cache_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
