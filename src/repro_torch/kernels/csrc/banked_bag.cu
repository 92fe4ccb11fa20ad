// Banked embedding-bag sums (the PIM stage-2 lookup) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_banked_bag_kernel (with its
// entry resolution _entry_fns, including its k_max > 1 replica branch, and
// the row-DMA ring _dma_accumulate), and ::_plain_bag_kernel (entry
// embedding_bag_pallas, resolution _plain_entry_fns) as the identity
// instance below.
//
// What it computes, for every bag b of an (NB, L) stream of per-field ids
// padded with -1:
//     row  = raw + off[b % F]                    (per-field offset)
//     row  = row * k_max + wang_hash(b) % k_max  (k_max > 1 only)
//     mine = raw >= 0 && (my < 0 || bank[row] == my)
//     out[b] = cast(sum_{j = 0..L-1, mine} float(table[slot[row]]))
// With k_max > 1 the table is replicated: bank and slot are the flattened
// (V * k_max,) replica-axis remaps and every bag reads one column of them,
// the same for all its entries; b is the bag's index in this call's stream.
// The hash is computed once per warp in uint32, whose wrap-around is the
// reference's jnp.uint32 arithmetic. k_max == 1 instantiates the
// single-copy code without the hash or the multiply.
// The identity instance (plain_bag_forward, the unbanked drop-in of
// kernels/ops.embedding_bag) reads the id as the table row: an entry counts
// iff raw >= 0 and adds table[raw]; it reads no remap, no bank and no field
// offset, so it pays none of the remap reads an arange remap would cost.
// The sum is taken in fp32 in entry order j = 0, 1, ..., L-1 and cast to the
// table's dtype once, exactly as the reference's scan (_bag_partial_scan)
// does, so the result equals the plain version bit for bit.
//
// What bounds it on the card: bytes. At the main-path shape (NB = 512 bags,
// L = 256, D = 32 fp32) a batch gathers 131,072 random 128-byte rows out of a
// 2.4 GB table, plus a 4-byte slot (and, with my >= 0, a 4-byte bank id) per
// entry from 75 MB remap vectors: ~18 MB, ~5.5 us at 3.35 TB/s. The work is
// a few million fp32 adds, nothing against the card's rate. The random remap
// reads cost a 32-byte sector each, and every row read is a dependent chain
// idx -> bank/slot -> row, so the kernel is latency-bound unless enough loads
// are in flight. A replicated table (k_max = 4) reads the same bytes per
// entry from remaps four times as long (302 MB each): the chain and the
// sectors are the same, only the multiply-add of the index is new. The
// identity instance drops the remap sectors and one link of the chain
// (idx -> row).
//
// What the design does about it:
//   * one warp per bag, lanes across D: at D = 32 fp32 a row is one coalesced
//     128-byte read; for D > 32 a lane owns K columns (K = 2 or 4), and
//     D > 128 walks the bag again per 128-column pass;
//   * each lane resolves one entry of a 32-entry chunk (coalesced idx read,
//     then its own bank/slot reads), and the warp shares the resolved slots
//     with shuffles;
//   * the next chunk's entries are resolved before the current chunk's rows
//     are read, and a lane issues all row loads of a chunk before it adds
//     them (32 / K loads in flight), in order, into its fp32 accumulators;
//   * no bag is split across threads and there are no atomics: the per-column
//     summation order is the reference's, which is what makes it exact.
// An entry that is padding or foreign adds 0.0f: the accumulator starts at
// +0 and round-to-nearest never turns it into -0, so adding +0 changes
// nothing, exactly as the reference's masked add.
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

// Wang's 32-bit integer mix (kernels/embedding_bag.py::wang_hash).
__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27D4EB2Du;
  return x ^ (x >> 15);
}

// How an entry's id becomes a table slot: through the (bank, slot) remaps
// with the field offset (kRemap), through the flattened replica-axis remaps
// at row * k_max + col (kReplica), or as it is (kIdentity: no remap, no
// ownership test, no field offset).
enum class Resolve { kRemap, kReplica, kIdentity };

// Slot of entry j of a bag, or -1 when the entry adds nothing (padding,
// past the bag's end, or a row another bank owns). kReplica: the row
// indexes the flattened replica-axis remaps at row * k_max + col (int64).
template <Resolve kMode>
__device__ __forceinline__ int resolve(const int* __restrict__ bag_idx, int j,
                                       int bag_len, int field_off,
                                       const int* __restrict__ bank,
                                       const int* __restrict__ slot, int my,
                                       int k_max, int col) {
  if (j >= bag_len) return -1;
  const int raw = bag_idx[j];
  if (raw < 0) return -1;
  if constexpr (kMode == Resolve::kIdentity) {
    return raw;
  } else {
    const int row = raw + field_off;
    if constexpr (kMode == Resolve::kReplica) {
      const int64_t rk = static_cast<int64_t>(row) * k_max + col;
      if (my >= 0 && bank[rk] != my) return -1;
      return slot[rk];
    } else {
      if (my >= 0 && bank[row] != my) return -1;
      return slot[row];
    }
  }
}

template <typename T, int K, Resolve kMode>
__global__ void __launch_bounds__(kWarp * kBagsPerBlock)
banked_bag_kernel(const T* __restrict__ table, const int* __restrict__ bank,
                  const int* __restrict__ slot, const int* __restrict__ off,
                  int n_fields, int my, int k_max,
                  const int* __restrict__ idx, T* __restrict__ out, int nb,
                  int bag_len, int dim) {
  constexpr int kUnroll = kWarp / K;          // row loads in flight per lane
  const int lane = threadIdx.x % kWarp;
  const int bag = blockIdx.x * kBagsPerBlock + threadIdx.x / kWarp;
  if (bag >= nb) return;                      // uniform across the warp
  const int field_off =
      kMode == Resolve::kIdentity ? 0 : off[bag % n_fields];
  // the bag's replica column: one hash per warp, every lane the same
  const int col = kMode == Resolve::kReplica ? static_cast<int>(
      wang_hash(static_cast<uint32_t>(bag)) % static_cast<uint32_t>(k_max))
      : 0;
  const int* bag_idx = idx + static_cast<int64_t>(bag) * bag_len;
  T* out_row = out + static_cast<int64_t>(bag) * dim;

  for (int c0 = 0; c0 < dim; c0 += kWarp * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;

    int src = resolve<kMode>(bag_idx, lane, bag_len, field_off, bank, slot,
                            my, k_max, col);
    for (int j0 = 0; j0 < bag_len; j0 += kWarp) {
      const int nxt = resolve<kMode>(bag_idx, j0 + kWarp + lane, bag_len,
                                    field_off, bank, slot, my, k_max, col);
      const int n = min(kWarp, bag_len - j0);
      for (int u0 = 0; u0 < n; u0 += kUnroll) {
        float v[kUnroll][K];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int s = __shfl_sync(kFull, src, u0 + u);
          const bool take = (u0 + u < n) && s >= 0;
          // int64: slot * D exceeds 2^31 on the largest tables (dlrm-rm2)
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

template <typename T, Resolve kMode>
void launch(const void* table, const void* bank, const void* slot,
            const void* off, int n_fields, int my, int k_max, const void* idx,
            void* out, int nb, int bag_len, int dim, cudaStream_t stream) {
  const dim3 grid((nb + kBagsPerBlock - 1) / kBagsPerBlock);
  const dim3 block(kWarp * kBagsPerBlock);
  const T* t = static_cast<const T*>(table);
  const int* bk = static_cast<const int*>(bank);
  const int* sl = static_cast<const int*>(slot);
  const int* of = static_cast<const int*>(off);
  const int* ix = static_cast<const int*>(idx);
  T* o = static_cast<T*>(out);
  if (dim <= kWarp) {
    banked_bag_kernel<T, 1, kMode><<<grid, block, 0, stream>>>(
        t, bk, sl, of, n_fields, my, k_max, ix, o, nb, bag_len, dim);
  } else if (dim <= 2 * kWarp) {
    banked_bag_kernel<T, 2, kMode><<<grid, block, 0, stream>>>(
        t, bk, sl, of, n_fields, my, k_max, ix, o, nb, bag_len, dim);
  } else {
    banked_bag_kernel<T, 4, kMode><<<grid, block, 0, stream>>>(
        t, bk, sl, of, n_fields, my, k_max, ix, o, nb, bag_len, dim);
  }
}

template <typename T>
void launch(const void* table, const void* bank, const void* slot,
            const void* off, int n_fields, int my, int k_max, const void* idx,
            void* out, int nb, int bag_len, int dim, cudaStream_t stream) {
  if (k_max == 1) {
    launch<T, Resolve::kRemap>(table, bank, slot, off, n_fields, my, 1, idx,
                               out, nb, bag_len, dim, stream);
  } else {
    launch<T, Resolve::kReplica>(table, bank, slot, off, n_fields, my, k_max,
                                 idx, out, nb, bag_len, dim, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and output alike). k_max >= 1:
// the replica width of the bank/slot remaps (1: a single-copy table).
extern "C" int banked_bag_forward(const void* table, int dtype,
                                  const void* bank, const void* slot,
                                  const void* off, int n_fields, int my,
                                  int k_max, const void* idx, void* out,
                                  int nb, int bag_len, int dim, int device,
                                  void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k_max < 1) return cudaErrorInvalidValue;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(table, bank, slot, off, n_fields, my, k_max, idx, out, nb,
                  bag_len, dim, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(table, bank, slot, off, n_fields, my, k_max, idx,
                          out, nb, bag_len, dim, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The identity instance: table (V, D) read at the ids themselves, no remap,
// no ownership, no field offsets. dtype as above.
extern "C" int plain_bag_forward(const void* table, int dtype,
                                 const void* idx, void* out, int nb,
                                 int bag_len, int dim, int device,
                                 void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float, Resolve::kIdentity>(table, nullptr, nullptr, nullptr, 1,
                                      -1, 1, idx, out, nb, bag_len, dim, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16, Resolve::kIdentity>(table, nullptr, nullptr,
                                              nullptr, 1, -1, 1, idx, out,
                                              nb, bag_len, dim, s);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* banked_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
