// Ragged CSR embedding-bag sums for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_csr_bag_kernel (entry
// csr_bag_pallas, with its in-kernel entry resolution and the row-DMA ring
// _dma_accumulate). Its backward, ct_scatter_csr_pallas, is ct_scatter.cu
// on a CSR prep (kernels/embedding_bag.csr_scatter_prep); no kernel here.
//
// What it computes. A batch of ragged bags is one flat id stream in CSR
// form: indices (T,) int32, rows of the super-table (no field offsets: the
// ids are already offset), -1 for a hole; offs (NB + 1,) int32, bag b's
// entries in [offs[b], offs[b+1]). For every bag b:
//     mine(e) = raw >= 0 && (my < 0 || bank[raw] == my),   raw = indices[e]
//     out[b]  = cast(sum_{e = offs[b] .. offs[b+1]-1, mine} float(table[slot[raw]]))
// in fp32, in stream order, cast to the table's dtype once; an empty bag is
// a row of zeros. Offsets are clamped into [0, T] (and end >= begin), so a
// bad offsets vector cannot read outside the stream; the plain version
// clamps the same way. The reference picks each entry's bag row through
// seg[e] - b0 over a tile of bags; a bag's range is that same set of
// entries in the same order, so the kernel needs no seg and sums each bag
// in the reference's order: it equals the plain version bit for bit.
//
// What bounds it on the card: bytes. At the CSR path's shape (64 requests
// x 8 fields = 512 Poisson(256) bags, ~131 k entries, D = 32 fp32) a batch
// gathers ~131 k random 128-byte rows out of a 2.4 GB table, a 4-byte slot
// (and with my >= 0 a 4-byte bank id) per entry from 75 MB remap vectors,
// the ids and the offsets: ~18 MB, ~5.5 us at 3.35 TB/s. The adds are
// nothing against the card's rate. Every row read is a dependent chain
// offs -> idx -> bank/slot -> row, so the kernel is latency-bound unless
// enough loads are in flight.
//
// What the design does about it (banked_bag.cu's):
//   * one warp per bag over its range, lanes across D: at D = 32 fp32 a row
//     is one coalesced 128-byte read; for D > 32 a lane owns K columns (K = 2
//     or 4), and D > 128 walks the bag again per 128-column pass;
//   * each lane resolves one entry of a 32-entry chunk (coalesced idx read,
//     then its own bank/slot reads), and the warp shares the resolved slots
//     with shuffles;
//   * the next chunk's entries are resolved before the current chunk's rows
//     are read, and a lane issues all row loads of a chunk before it adds
//     them (32 / K loads in flight), in order, into its fp32 accumulators;
//   * the bag's two offsets are read by one lane and shuffled to the others,
//     so the chunk loop's bounds are warp-uniform;
//   * the grid is one warp per bag, with no padding of the bag count or of D
//     (the TPU kernel's tile_b and lane padding); no bag is split across
//     warps and there are no atomics.
// An entry that is a hole or foreign adds 0.0f: the accumulator starts at +0
// and round-to-nearest never turns it into -0, so adding +0 changes nothing,
// exactly as the reference's masked add.
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

// Slot of stream entry e, or -1 when it adds nothing (past the bag's end, a
// hole, or a row another bank owns).
__device__ __forceinline__ int resolve(const int* __restrict__ indices, int e,
                                       int end, const int* __restrict__ bank,
                                       const int* __restrict__ slot, int my) {
  if (e >= end) return -1;
  const int raw = indices[e];
  if (raw < 0) return -1;
  if (my >= 0 && bank[raw] != my) return -1;
  return slot[raw];
}

template <typename T, int K>
__global__ void __launch_bounds__(kWarp * kBagsPerBlock)
csr_bag_kernel(const T* __restrict__ table, const int* __restrict__ bank,
               const int* __restrict__ slot, int my,
               const int* __restrict__ indices, const int* __restrict__ offs,
               T* __restrict__ out, int nb, int total, int dim) {
  constexpr int kUnroll = kWarp / K;          // row loads in flight per lane
  const int lane = threadIdx.x % kWarp;
  const int bag = blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp;
  if (bag >= nb) return;                      // uniform across the warp
  // The bag's range is read by lane 0 and broadcast: bounds that come from
  // a shuffle, not from a load in every lane, let the compiler treat the
  // chunk loop as warp-uniform, which keeps its 32 row loads in flight
  // (offsets loaded in every lane took 1.5x the time on an H100 at the CSR
  // path's shape).
  int b_raw = 0, e_raw = 0;
  if (lane == 0) {
    b_raw = offs[bag];
    e_raw = offs[bag + 1];
  }
  b_raw = __shfl_sync(kFull, b_raw, 0);
  e_raw = __shfl_sync(kFull, e_raw, 0);
  const int begin = min(max(b_raw, 0), total);
  const int end = max(min(max(e_raw, 0), total), begin);
  T* out_row = out + static_cast<int64_t>(bag) * dim;

  for (int c0 = 0; c0 < dim; c0 += kWarp * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;

    int src = resolve(indices, begin + lane, end, bank, slot, my);
    for (int j0 = begin; j0 < end; j0 += kWarp) {
      const int nxt = resolve(indices, j0 + kWarp + lane, end, bank, slot,
                              my);
      const int n = min(kWarp, end - j0);
      for (int u0 = 0; u0 < n; u0 += kUnroll) {
        float v[kUnroll][K];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(kFull, src, u0 + u);
          const bool take = (u0 + u < n) && s >= 0;
          // int64: slot * D exceeds 2^31 on the largest tables
          const T* row = table + (take ? static_cast<int64_t>(s) * dim : 0);
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
      src = nxt;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + lane + kWarp * k;
      if (c < dim) store(out_row + c, acc[k]);
    }
  }
}

template <typename T>
void launch(const void* table, const void* bank, const void* slot, int my,
            const void* indices, const void* offs, void* out, int nb,
            int total, int dim, cudaStream_t stream) {
  const dim3 grid((nb + kBagsPerBlock - 1) / kBagsPerBlock);
  const dim3 block(kWarp * kBagsPerBlock);
  const T* t = static_cast<const T*>(table);
  const int* bk = static_cast<const int*>(bank);
  const int* sl = static_cast<const int*>(slot);
  const int* ix = static_cast<const int*>(indices);
  const int* of = static_cast<const int*>(offs);
  T* o = static_cast<T*>(out);
  if (dim <= kWarp) {
    csr_bag_kernel<T, 1><<<grid, block, 0, stream>>>(t, bk, sl, my, ix, of, o,
                                                     nb, total, dim);
  } else if (dim <= 2 * kWarp) {
    csr_bag_kernel<T, 2><<<grid, block, 0, stream>>>(t, bk, sl, my, ix, of, o,
                                                     nb, total, dim);
  } else {
    csr_bag_kernel<T, 4><<<grid, block, 0, stream>>>(t, bk, sl, my, ix, of, o,
                                                     nb, total, dim);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and output alike). offs holds
// nb + 1 int32 offsets into the total-entry stream.
extern "C" int csr_bag_forward(const void* table, int dtype, const void* bank,
                               const void* slot, int my, const void* indices,
                               const void* offs, void* out, int nb, int total,
                               int dim, int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(table, bank, slot, my, indices, offs, out, nb, total, dim,
                  s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(table, bank, slot, my, indices, offs, out, nb,
                          total, dim, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* csr_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
