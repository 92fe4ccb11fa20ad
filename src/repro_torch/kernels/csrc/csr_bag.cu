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
// in fp32, in stream order, cast to the output's dtype once; an empty bag is
// a row of zeros. The output is the table's dtype (csr_bag_forward) or fp32
// whatever the table's (csr_bag_forward_f32: the accumulator stored with no
// cast, so bf16 rows give fp32 sums that no bf16 rounding has touched). Offsets are clamped into [0, T] (and end >= begin), so a
// bad offsets vector cannot read outside the stream; the plain version
// clamps the same way. The reference picks each entry's bag row through
// seg[e] - b0 over a tile of bags; a bag's range is that same set of
// entries in the same order, so the kernel needs no seg and sums each bag
// in the reference's order: it equals the plain version bit for bit.
// An entry that is a hole or foreign is skipped: the reference adds +0.0
// for it, the accumulator starts at +0 and round-to-nearest never turns it
// into -0, so adding +0 changes nothing.
//
// What bounds it on the card: bytes. At the CSR path's shape (64 requests
// x 8 fields = 512 Poisson(256) bags, ~131 k entries, D = 32 fp32) a batch
// gathers ~131 k random 128-byte rows out of a 2.4 GB table, a 4-byte slot
// (and with my >= 0 a 4-byte bank id) per entry from 75 MB remap vectors,
// the ids and the offsets: ~8 MB of distinct bytes, ~2.5 us at 3.35 TB/s.
// The adds are nothing against the card's rate. Every row read is the end
// of a dependent chain offs -> idx -> bank/slot -> row, so the kernel is
// latency-bound unless the chain is paid rarely and many rows are in
// flight. The first design paid it once per 32-entry chunk, with 32 rows
// of a bag in flight: 29.7 us (NVIDIA H100 80GB HBM3, 700 W, CUDA
// events, L2 flushed; chip_smoke.py).
//
// What the design does about it (banked_bag.cu's resolve-once ring over a
// ragged range): one warp per bag, and
//   * the bag's two offsets are read by lane 0 and shuffled to the others,
//     so the range's bounds are warp-uniform (offsets loaded in every lane
//     took 1.5x the time on an H100 at the CSR path's shape);
//   * resolve a round of 512 entries of the range at once: lane l takes
//     entries begin + l, + 32, ..., + 480, all 16 idx loads first, then
//     every bank and slot load. A Poisson(256) bag is one round, so the
//     chain costs about three memory latencies a bag;
//   * compact the round's live slots into shared memory in stream order
//     (ballot and popc prefix): holes and foreign rows cost no copy;
//   * stream the live rows through a shared-memory ring of up to 8 stages
//     of 32 rows with cp.async (16-byte units when the table's base and the
//     row stride allow it, 4-byte ones otherwise, 2-byte bf16 rows of odd
//     width by plain loads and stores); a round's list runs through the ring
//     as one pipeline; a longer bag takes more rounds;
//   * the lane that owns a column adds it from the ring in stream order
//     while later stages are still landing;
//   * the launch geometry (bags per block, stages, copy unit) comes from the
//     wrapper (kernels/embedding_bag.bag_geometry at the mean bag length
//     T / NB: shapes only, offsets are never read on the host) and is
//     checked here;
//   * D > 128 takes one pass of 128 columns at a time (K = 4 columns a
//     lane), reusing the compacted list when the bag is one round.
// No bag is split across warps and there are no atomics.
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

// Slots of stream entries first + lane + 32 i (i < kResolve, those below
// end), into s[]: the slot, or -1 when the entry adds nothing (past the
// bag's end, a hole, or a row another bank owns). All idx loads are issued
// first, then every bank and slot load.
__device__ __forceinline__ void resolve_round(
    const int* __restrict__ indices, int first, int end,
    const int* __restrict__ bank, const int* __restrict__ slot, int my,
    int lane, int (&s)[kResolve]) {
  int raw[kResolve];
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    const int e = first + lane + kWarp * i;
    raw[i] = e < end ? indices[e] : -1;
  }
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    int owner = my;                     // my < 0 owns every row
    int got = -1;
    if (raw[i] >= 0) {
      got = slot[raw[i]];
      if (my >= 0) owner = bank[raw[i]];
    }
    s[i] = owner == my && got >= 0 ? got : -1;
  }
}

// The live slots of a round (s[i] >= 0), in stream order, into
// list[0..n); returns n.
__device__ __forceinline__ int compact(const int (&s)[kResolve], int lane,
                                       int* __restrict__ list) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    const unsigned m = __ballot_sync(kFull, s[i] >= 0);
    if (s[i] >= 0) list[n + __popc(m & below)] = s[i];
    n += __popc(m);
  }
  return n;
}

// Add the rows of list[0..n) of the table at `tpass` (a pass's base) into
// acc, in list order, through the ring of `stages` buffers of kStageRows
// rows. Stage t is issued stages - 1 steps before it is added; one cp.async
// group a step; a lane issues 8 units at a time, their slots read first.
// b_issue and b_add (the ring buffers of the next stage to issue and to
// add) carry across calls.
template <typename T, int K, int kVec>
__device__ __forceinline__ void stream_rows(
    float (&acc)[K], const int* __restrict__ list, int n,
    const unsigned char* tpass, int64_t stride, int units, uint32_t magic,
    int cols, unsigned char* ring, int stages, int& b_issue, int& b_add,
    int lane) {
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
        int r[kIssue], st[kIssue];
#pragma unroll
        for (int i = 0; i < kIssue; ++i) {
          const int u = u0 + kWarp * i;
          r[i] = units == 1 ? u : static_cast<int>(
              __umulhi(static_cast<uint32_t>(u), magic));
          st[i] = u < total ? list[row0 + r[i]] : 0;
        }
#pragma unroll
        for (int i = 0; i < kIssue; ++i) {
          const int u = u0 + kWarp * i;
          if (u < total) {
            const int v = (u - r[i] * units) * kVec;
            copy_unit<kVec>(dst0 + r[i] * kRowBytes + v,
                            tpass + st[i] * stride + v);
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

template <typename T, typename O, int K, int kVec>
__global__ void __launch_bounds__(kWarp * kMaxBagsPerBlock)
csr_bag_kernel(const T* __restrict__ table, const int* __restrict__ bank,
               const int* __restrict__ slot, int my,
               const int* __restrict__ indices, const int* __restrict__ offs,
               O* __restrict__ out, int nb, int total, int dim, int stages) {
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
  int b_raw = 0, e_raw = 0;
  if (lane == 0) {
    b_raw = offs[bag];
    e_raw = offs[bag + 1];
  }
  b_raw = __shfl_sync(kFull, b_raw, 0);
  e_raw = __shfl_sync(kFull, e_raw, 0);
  const int begin = min(max(b_raw, 0), total);
  const int end = max(min(max(e_raw, 0), total), begin);
  O* out_row = out + static_cast<int64_t>(bag) * dim;
  const unsigned char* tbytes = reinterpret_cast<const unsigned char*>(table);
  // int64: slot * row stride exceeds 2^31 on the largest tables
  const int64_t stride = static_cast<int64_t>(dim) * sizeof(T);
  const int n_rounds = (end - begin + kRound - 1) / kRound;
  int resolved = -1;                          // the round list[] holds
  int n = 0;
  int b_issue = 0, b_add = 0;

  for (int c0 = 0; c0 < dim; c0 += kPass) {
    const int cols = min(kPass, dim - c0);
    // copy units of a row's pass, and u / units as a multiply-high (exact
    // for u < 2^16 and 1 < units < 2^16)
    const int units = cols * static_cast<int>(sizeof(T)) / kVec;
    const uint32_t magic =
        units == 1 ? 0u : 0xffffffffu / static_cast<uint32_t>(units) + 1u;
    const unsigned char* tpass = tbytes + static_cast<int64_t>(c0) * sizeof(T);
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;

    for (int rd = 0; rd < n_rounds; ++rd) {
      if (resolved != rd) {                   // one round: resolve once
        int s[kResolve];
        resolve_round(indices, begin + rd * kRound, end, bank, slot, my,
                      lane, s);
        __syncwarp();                         // the last round's reads
        n = compact(s, lane, list);
        __syncwarp();
        resolved = rd;
      }
      stream_rows<T, K, kVec>(acc, list, n, tpass, stride, units, magic,
                              cols, ring, stages, b_issue, b_add, lane);
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

template <typename T, typename O>
using CsrKernel = void (*)(const T*, const int*, const int*, int, const int*,
                           const int*, O*, int, int, int, int);

// The instance for D (K = 1, 2 or 4 columns a lane) and the copy unit; null
// for a unit the dtype does not take.
template <typename T, typename O, int K>
CsrKernel<T, O> pick_vec(int vec) {
  if (vec == 16) return csr_bag_kernel<T, O, K, 16>;
  if (vec == 4) return csr_bag_kernel<T, O, K, 4>;
  if constexpr (sizeof(T) == 2) {
    if (vec == 2) return csr_bag_kernel<T, O, K, 2>;
  }
  return nullptr;
}

template <typename T, typename O>
CsrKernel<T, O> pick(int dim, int vec, int* row_bytes) {
  const int k = dim <= kWarp ? 1 : dim <= 2 * kWarp ? 2 : 4;
  *row_bytes = kWarp * k * static_cast<int>(sizeof(T));
  if (k == 1) return pick_vec<T, O, 1>(vec);
  if (k == 2) return pick_vec<T, O, 2>(vec);
  return pick_vec<T, O, 4>(vec);
}

template <typename T, typename O>
cudaError_t launch(const void* table, const void* bank, const void* slot,
                   int my, const void* indices, const void* offs, void* out,
                   int nb, int total, int dim, Geometry g,
                   cudaStream_t stream) {
  // the geometry the wrapper computed, checked against what the kernel
  // needs: a copy unit that divides the row stride and the table's base
  const int64_t row = static_cast<int64_t>(dim) * sizeof(T);
  int row_bytes = 0;
  const CsrKernel<T, O> kernel = pick<T, O>(dim, g.vec, &row_bytes);
  if (kernel == nullptr || row % g.vec != 0 ||
      reinterpret_cast<uintptr_t>(table) % g.vec != 0 ||
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
      static_cast<const T*>(table), static_cast<const int*>(bank),
      static_cast<const int*>(slot), my, static_cast<const int*>(indices),
      static_cast<const int*>(offs), static_cast<O*>(out), nb, total, dim,
      g.stages);
  return cudaGetLastError();
}

// The launch of either entry: the table's dtype (0 = float32, 1 =
// bfloat16), the output's the table's or, with f32_out, float32.
cudaError_t forward(const void* table, int dtype, bool f32_out,
                    const void* bank, const void* slot, int my,
                    const void* indices, const void* offs, void* out, int nb,
                    int total, int dim, int device, void* stream,
                    int bags_per_block, int stages, int vec) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{bags_per_block, stages, vec};
  if (dtype == 0) {
    return launch<float, float>(table, bank, slot, my, indices, offs, out,
                                nb, total, dim, g, s);
  } else if (dtype == 1 && f32_out) {
    return launch<__nv_bfloat16, float>(table, bank, slot, my, indices, offs,
                                        out, nb, total, dim, g, s);
  } else if (dtype == 1) {
    return launch<__nv_bfloat16, __nv_bfloat16>(table, bank, slot, my,
                                                indices, offs, out, nb,
                                                total, dim, g, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and output alike). offs holds
// nb + 1 int32 offsets into the total-entry stream. The launch geometry
// (kernels/embedding_bag.bag_geometry): bags per block (1 or 2), stages
// (ring stages of 32 rows, 1 to 8) and vec (the copy unit in bytes: 16 or
// 4 by cp.async, 2 by plain loads and stores).
extern "C" int csr_bag_forward(const void* table, int dtype, const void* bank,
                               const void* slot, int my, const void* indices,
                               const void* offs, void* out, int nb, int total,
                               int dim, int device, void* stream,
                               int bags_per_block, int stages, int vec) {
  return forward(table, dtype, false, bank, slot, my, indices, offs, out, nb,
                 total, dim, device, stream, bags_per_block, stages, vec);
}

// csr_bag_forward with a float32 output whatever the table's dtype (the
// table's dtype as there): the fp32 sums with no cast at the end.
extern "C" int csr_bag_forward_f32(const void* table, int dtype,
                                   const void* bank, const void* slot, int my,
                                   const void* indices, const void* offs,
                                   void* out, int nb, int total, int dim,
                                   int device, void* stream,
                                   int bags_per_block, int stages, int vec) {
  return forward(table, dtype, true, bank, slot, my, indices, offs, out, nb,
                 total, dim, device, stream, bags_per_block, stages, vec);
}

extern "C" const char* csr_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
