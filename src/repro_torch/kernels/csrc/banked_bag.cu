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
// entry from 75 MB remap vectors: ~18 MB, ~5.3 us at 3.35 TB/s. The work is
// a few million fp32 adds, nothing against the card's rate. Every row read
// is the end of a dependent chain idx -> bank/slot -> row, so the kernel is
// latency-bound unless the chain is paid rarely and many rows are in flight.
// The first design (PR 11) paid the chain once per 32-entry chunk, 8 times a
// bag, with 32 rows of a bag in flight: 34.6 us (NVIDIA H100 80GB HBM3,
// 700 W, CUDA events, L2 flushed; chip_smoke.py).
//
// What the design does about it: one warp per bag, as before, but
//   * resolve once per bag (per segment of 256 entries when L is longer):
//     lane l resolves entries l, l + 32, ..., l + 224, all 8 idx loads
//     first, then all its bank and slot loads, so the chain costs about two
//     memory latencies per bag; the slots (-1 for an entry that adds
//     nothing) go to shared memory;
//   * stream the rows through a shared-memory ring of up to 8 stages of 32
//     rows with cp.async: 16-byte copies when the table's base and row
//     stride allow it, 4-byte ones otherwise (2-byte bf16 rows of odd
//     width are copied by plain loads and stores). At D = 32 fp32 the ring
//     holds the whole bag (32 KB): all 256 rows can be in flight at once. A
//     masked entry's units are zero-filled by cp.async itself (src-size 0);
//   * the lane that owns a column adds it from the ring in entry order,
//     with no test per row, while later stages are still landing;
//   * a block holds 1 or 2 bags, chosen with the stages by the wrapper
//     (kernels/embedding_bag.bag_geometry) so that all bags of a serve batch
//     are resident at once; above 48 KB the block's shared memory is opted
//     in with cudaFuncSetAttribute;
//   * D > 128 takes one pass of 128 columns at a time (K = 4 columns a
//     lane), reusing the resolved slots when the bag is one segment.
// A cp.async costs a warp ~100 cycles to issue (clock64 on the card), 64 of
// them for a 256-row bag of 128-byte rows, and a row copied whole per lane
// by the copy engine (cp.async.bulk with an mbarrier) was slower still:
// the issue, not the memory, is what this design still pays per bag.
// The per-column order is the reference's: one thread owns one column of one
// bag, adds in entry order in fp32, casts once; no bag is split and there
// are no atomics. An entry that is padding or foreign adds 0.0f: the
// accumulator starts at +0 and round-to-nearest never turns it into -0, so
// adding +0 changes nothing, exactly as the reference's masked add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kMaxBagsPerBlock = 2;  // one warp per bag
constexpr int kStageRows = 32;       // rows of a bag per ring stage
constexpr int kMaxStages = 8;
constexpr int kResolve = 8;          // entries a lane resolves per round
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

// Wang's 32-bit integer mix (kernels/embedding_bag.py::wang_hash).
__device__ __forceinline__ uint32_t wang_hash(uint32_t x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27D4EB2Du;
  return x ^ (x >> 15);
}

// Copy kVec bytes of a table row into the ring: cp.async for 16 and 4
// bytes (asynchronous; completes at the wait below), whose src-size operand
// 0 fills a masked entry's unit with zeros without reading global memory;
// a plain 2-byte load and store (or zero) for bf16 rows of odd width.
template <int kVec>
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src,
                                          bool live) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (kVec == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(d), "l"(src), "r"(live ? 16 : 0) : "memory");
  } else if constexpr (kVec == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(d), "l"(src), "r"(live ? 4 : 0) : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        live ? *reinterpret_cast<const uint16_t*>(src) : uint16_t{0};
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

// How an entry's id becomes a table slot: through the (bank, slot) remaps
// with the field offset (kRemap), through the flattened replica-axis remaps
// at row * k_max + col (kReplica), or as it is (kIdentity: no remap, no
// ownership test, no field offset).
enum class Resolve { kRemap, kReplica, kIdentity };

// Slots of entries lane, lane + 32, ..., lane + 224 of one segment of up
// to 256 entries (n of them live), into s[0..7]: the slot, or -1 when the
// entry adds nothing (padding, past the segment, or a row another bank
// owns). All 8 idx loads are issued first, then every bank and slot load.
template <Resolve kMode>
__device__ __forceinline__ void resolve_segment(
    const int* __restrict__ ids, int n, int field_off,
    const int* __restrict__ bank, const int* __restrict__ slot, int my,
    int k_max, int col, int lane, int (&s)[8]) {
  int raw[kResolve];
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    const int j = lane + kWarp * i;
    raw[i] = j < n ? ids[j] : -1;
  }
#pragma unroll
  for (int i = 0; i < kResolve; ++i) {
    if constexpr (kMode == Resolve::kIdentity) {
      s[i] = raw[i] >= 0 ? raw[i] : -1;
    } else {
      int64_t row = raw[i] + field_off;
      if constexpr (kMode == Resolve::kReplica) {
        row = row * k_max + col;
      }
      int owner = my;                   // my < 0 owns every row
      int got = -1;
      if (raw[i] >= 0) {
        got = slot[row];
        if (my >= 0) owner = bank[row];
      }
      s[i] = owner == my && got >= 0 ? got : -1;
    }
  }
}

// Shared memory of one bag: the slots of a segment (256 x 4 bytes), then
// `stages` ring stages of kStageRows rows of a pass's 32 K columns each
// (the ring's row stride is a compile-time constant, whatever D is).
constexpr int kSlotBytes = kWarp * kResolve * 4;

__host__ __device__ __forceinline__ int bag_smem_bytes(int stages,
                                                       int row_bytes) {
  return kSlotBytes + stages * kStageRows * row_bytes;
}

template <typename T, int K, int kVec, Resolve kMode>
__global__ void __launch_bounds__(kWarp * kMaxBagsPerBlock)
banked_bag_kernel(const T* __restrict__ table, const int* __restrict__ bank,
                  const int* __restrict__ slot, const int* __restrict__ off,
                  int n_fields, int my, int k_max,
                  const int* __restrict__ idx, T* __restrict__ out, int nb,
                  int bag_len, int dim, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kPass = kWarp * K;            // columns per pass
  constexpr int kRowBytes = kPass * static_cast<int>(sizeof(T));
  constexpr int kStageBytes = kStageRows * kRowBytes;
  constexpr int kSeg = kWarp * kResolve;      // entries resolved at once
  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int bag = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (bag >= nb) return;                      // uniform across the warp
  unsigned char* region = smem + warp * bag_smem_bytes(stages, kRowBytes);
  int* sl = reinterpret_cast<int*>(region);
  unsigned char* ring = region + kSlotBytes;
  const int field_off =
      kMode == Resolve::kIdentity ? 0 : off[bag % n_fields];
  // the bag's replica column: one hash per warp, every lane the same
  const int col = kMode == Resolve::kReplica ? static_cast<int>(
      wang_hash(static_cast<uint32_t>(bag)) % static_cast<uint32_t>(k_max))
      : 0;
  const int* bag_idx = idx + static_cast<int64_t>(bag) * bag_len;
  T* out_row = out + static_cast<int64_t>(bag) * dim;
  const unsigned char* tbytes = reinterpret_cast<const unsigned char*>(table);
  // int64: slot * row stride exceeds 2^31 on the largest tables (dlrm-rm2)
  const int64_t stride = static_cast<int64_t>(dim) * sizeof(T);
  const int n_segs = (bag_len + kSeg - 1) / kSeg;
  int s[kResolve];
  int resolved = -1;                          // the segment s[] holds
  // ring buffers of the next stage to issue and to add, wrapping round
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

    for (int sg = 0; sg < n_segs; ++sg) {
      const int n = min(kSeg, bag_len - sg * kSeg);
      if (resolved != sg) {                   // one segment: resolve once
        resolve_segment<kMode>(bag_idx + sg * kSeg, n, field_off, bank,
                               slot, my, k_max, col, lane, s);
        __syncwarp();                         // the last segment's read
#pragma unroll
        for (int i = 0; i < kResolve; ++i) sl[lane + kWarp * i] = s[i];
        __syncwarp();
        resolved = sg;
      }
      const int n_st = (n + kStageRows - 1) / kStageRows;

      // stage t: the copies of its 32 rows into ring buffer b, 8 units a
      // lane at a time: the 8 slots read first, then the 8 copies. A
      // masked entry's units are zero-filled, so that the adds need no test
      // (adding the +0.0f is the masked add).
      auto issue = [&](int t, int b) {
        const int* st_sl = sl + t * kStageRows;
        unsigned char* dst0 = ring + b * kStageBytes;
        const int total = min(kStageRows, n - t * kStageRows) * units;
        for (int u0 = lane; u0 < total; u0 += kWarp * kIssue) {
          int r[kIssue], st[kIssue];
#pragma unroll
          for (int i = 0; i < kIssue; ++i) {
            const int u = u0 + kWarp * i;
            r[i] = units == 1 ? u : static_cast<int>(
                __umulhi(static_cast<uint32_t>(u), magic));
            st[i] = u < total ? st_sl[r[i]] : -1;
          }
#pragma unroll
          for (int i = 0; i < kIssue; ++i) {
            const int u = u0 + kWarp * i;
            if (u < total) {
              const int v = (u - r[i] * units) * kVec;
              const bool live = st[i] >= 0;
              copy_unit<kVec>(dst0 + r[i] * kRowBytes + v,
                              live ? tpass + st[i] * stride + v : tbytes,
                              live);
            }
          }
        }
      };

      // software pipeline: stage t issued `stages - 1` steps before it is
      // added; one cp.async group a step
      for (int t = 0; t < n_st + stages - 1; ++t) {
        if (t < n_st) {
          issue(t, b_issue);
          b_issue = b_issue + 1 == stages ? 0 : b_issue + 1;
        }
        commit_group();
        const int ta = t - (stages - 1);
        if (ta >= 0) {
          const int b = b_add;
          b_add = b_add + 1 == stages ? 0 : b_add + 1;
          wait_pending(stages - 1);           // stage ta's copies landed
          __syncwarp();
          const T* rb = reinterpret_cast<const T*>(ring + b * kStageBytes)
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
          __syncwarp();                       // buffer b free again
        }
      }
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
using BagKernel = void (*)(const T*, const int*, const int*, const int*, int,
                           int, int, const int*, T*, int, int, int, int);

// The instance for D (K = 1, 2 or 4 columns a lane) and the copy unit; null
// for a unit the dtype does not take.
template <typename T, int K, Resolve kMode>
BagKernel<T> pick_vec(int vec) {
  if (vec == 16) return banked_bag_kernel<T, K, 16, kMode>;
  if (vec == 4) return banked_bag_kernel<T, K, 4, kMode>;
  if constexpr (sizeof(T) == 2) {
    if (vec == 2) return banked_bag_kernel<T, K, 2, kMode>;
  }
  return nullptr;
}

template <typename T, Resolve kMode>
BagKernel<T> pick(int dim, int vec, int* row_bytes) {
  const int k = dim <= kWarp ? 1 : dim <= 2 * kWarp ? 2 : 4;
  *row_bytes = kWarp * k * static_cast<int>(sizeof(T));
  if (k == 1) return pick_vec<T, 1, kMode>(vec);
  if (k == 2) return pick_vec<T, 2, kMode>(vec);
  return pick_vec<T, 4, kMode>(vec);
}

template <typename T, Resolve kMode>
cudaError_t launch(const void* table, const void* bank, const void* slot,
                   const void* off, int n_fields, int my, int k_max,
                   const void* idx, void* out, int nb, int bag_len, int dim,
                   Geometry g, cudaStream_t stream) {
  // the geometry the wrapper computed, checked against what the kernel
  // needs: a copy unit that divides the row stride and the table's base
  const int64_t row = static_cast<int64_t>(dim) * sizeof(T);
  int row_bytes = 0;
  const BagKernel<T> kernel = pick<T, kMode>(dim, g.vec, &row_bytes);
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
      static_cast<const int*>(slot), static_cast<const int*>(off), n_fields,
      my, k_max, static_cast<const int*>(idx), static_cast<T*>(out), nb,
      bag_len, dim, g.stages);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* table, const void* bank, const void* slot,
                   const void* off, int n_fields, int my, int k_max,
                   const void* idx, void* out, int nb, int bag_len, int dim,
                   Geometry g, cudaStream_t stream) {
  if (k_max == 1) {
    return launch<T, Resolve::kRemap>(table, bank, slot, off, n_fields, my,
                                      1, idx, out, nb, bag_len, dim, g,
                                      stream);
  }
  return launch<T, Resolve::kReplica>(table, bank, slot, off, n_fields, my,
                                      k_max, idx, out, nb, bag_len, dim, g,
                                      stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (table and output alike). k_max >= 1:
// the replica width of the bank/slot remaps (1: a single-copy table). The
// launch geometry (kernels/embedding_bag.bag_geometry): bags per block (1
// or 2), stages (ring stages of 32 rows, 1 to 8) and vec (the copy unit in
// bytes: 16 or 4 by cp.async, 2 by plain loads and stores).
extern "C" int banked_bag_forward(const void* table, int dtype,
                                  const void* bank, const void* slot,
                                  const void* off, int n_fields, int my,
                                  int k_max, const void* idx, void* out,
                                  int nb, int bag_len, int dim, int device,
                                  void* stream, int bags_per_block,
                                  int stages, int vec) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (k_max < 1) return cudaErrorInvalidValue;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{bags_per_block, stages, vec};
  if (dtype == 0) {
    return launch<float>(table, bank, slot, off, n_fields, my, k_max, idx,
                         out, nb, bag_len, dim, g, s);
  } else if (dtype == 1) {
    return launch<__nv_bfloat16>(table, bank, slot, off, n_fields, my, k_max,
                                 idx, out, nb, bag_len, dim, g, s);
  }
  return cudaErrorInvalidValue;
}

// The identity instance: table (V, D) read at the ids themselves, no remap,
// no ownership, no field offsets. dtype and the geometry as above.
extern "C" int plain_bag_forward(const void* table, int dtype,
                                 const void* idx, void* out, int nb,
                                 int bag_len, int dim, int device,
                                 void* stream, int bags_per_block,
                                 int stages, int vec) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geometry g{bags_per_block, stages, vec};
  if (dtype == 0) {
    return launch<float, Resolve::kIdentity>(table, nullptr, nullptr,
                                             nullptr, 1, -1, 1, idx, out, nb,
                                             bag_len, dim, g, s);
  } else if (dtype == 1) {
    return launch<__nv_bfloat16, Resolve::kIdentity>(
        table, nullptr, nullptr, nullptr, 1, -1, 1, idx, out, nb, bag_len,
        dim, g, s);
  }
  return cudaErrorInvalidValue;
}

// Resident blocks an SM of the kernel instance a launch with this dtype,
// D, k_max (0: the identity instance), bags per block, shared memory and
// copy unit would use (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into
// *blocks.
extern "C" int banked_bag_occupancy(int dtype, int dim, int k_max,
                                    int bags_per_block, int smem, int vec,
                                    int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  int row_bytes = 0;
  const void* fn = nullptr;
  if (dtype == 0) {
    fn = reinterpret_cast<const void*>(
        k_max == 0 ? pick<float, Resolve::kIdentity>(dim, vec, &row_bytes)
        : k_max == 1 ? pick<float, Resolve::kRemap>(dim, vec, &row_bytes)
                     : pick<float, Resolve::kReplica>(dim, vec, &row_bytes));
  } else {
    fn = reinterpret_cast<const void*>(
        k_max == 0
            ? pick<__nv_bfloat16, Resolve::kIdentity>(dim, vec, &row_bytes)
        : k_max == 1
            ? pick<__nv_bfloat16, Resolve::kRemap>(dim, vec, &row_bytes)
            : pick<__nv_bfloat16, Resolve::kReplica>(dim, vec, &row_bytes));
  }
  if (fn == nullptr) return cudaErrorInvalidValue;
  err = opt_in(fn, smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kWarp * bags_per_block, smem);
}

extern "C" const char* banked_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
