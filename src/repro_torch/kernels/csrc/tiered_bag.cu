// Banked bag sums over a tiered-precision table (bf16/fp32 hot rows, int8
// and packed int4 rows, dequantized per row as they are read) for Hopper,
// sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_tiered_bag_kernel (called
// by tiered_embedding_bag_pallas; entry resolution _entry_fns, k_max == 1;
// the row-DMA ring _dma_accumulate with its dequantizing row_fn; the dequant
// math quant/quantize.py::dequant_rows_f32).
//
// What it computes, for every bag b of an (NB, L) stream of per-field ids
// padded with -1, and entry j:
//     row  = raw + off[b % F]
//     live = raw >= 0 && (my < 0 || bank[row] == my)
//     s    = slot[row]                       (position in the packed table)
//     v    = dequant(payload[s], tier[s], scale[s])
//     out[b] = sum_{j = 0..L-1, live} v     (fp32, entry order)
// payload is (R, row_bytes) bytes; a row's tier picks how its bytes read:
//     HOT  bf16: column c is the 16 bits at bytes 2c, 2c+1, widened << 16
//     HOT  fp32: column c is the 32 bits at bytes 4c..4c+3
//     INT8     : (float)q * scale[s], q the signed byte c
//     INT4     : (float)q * scale[s], q the signed nibble of byte c / 2,
//                the low nibble for even c, the high one for odd c,
//                sign-extended as ((x & 0xF) ^ 8) - 8
// (any tier code other than HOT and INT8 reads as INT4, as the reference's
// selection does). The output is fp32 (NB, dim).
//
// Bit equality with the plain version (and the reference's jnp scan): each
// quantized value is ONE rounded fp32 multiply and is then added to the
// accumulator by ONE rounded fp32 add. __fmul_rn and __fadd_rn are never
// contracted into an FMA (nvcc's default -fmad=true would otherwise fuse
// acc + q * s and round once, giving other bits). The sum runs in entry
// order; entries that add nothing (padding, holes, foreign rows) are
// skipped: the accumulator starts at +0 and round-to-nearest never turns it
// into -0, so skipping a +0 add changes nothing.
//
// What bounds it on the card: bytes. At the main-path shape (NB = 512 bags
// of batch 64 x 8 fields, L = 256, D = 32, bf16 hot) a batch reads 131,072
// entries of Zipf ids over a 1.5 GB payload: per distinct row its 4-byte
// slot, 4-byte tier, 4-byte scale and 16 (int4), 32 (int8) or 64 (bf16)
// payload bytes. The dequant is a few integer ops and one multiply per
// value, nothing against the card's rate. Every row read is a dependent
// chain idx -> bank/slot -> tier/scale -> row bytes, so the kernel is
// latency-bound unless enough loads are in flight.
//
// What the design does about it (the design of cache_bag.cu):
//   * one warp per bag, lanes across D: lane c reads only its own bytes of
//     a row (2 bytes bf16, 1 byte int8, half a byte int4); for D > 32 a
//     lane owns K columns (K = 2 or 4), and D > 128 walks the bag again per
//     128-column pass;
//   * each lane resolves one entry of a 32-entry chunk (coalesced idx read,
//     then its own bank/slot, tier and scale reads); the warp compacts the
//     chunk's live entries, in entry order, into per-warp lists in shared
//     memory (ballot and popc), so holes and the -1 tail cost no loads;
//   * the next chunk's entries are resolved before the current chunk's rows
//     are read, and a lane reads and dequantizes all rows of a chunk
//     (32 / K of them) before it adds them, in order, into its fp32
//     accumulators; the tier branch is uniform across the warp (all lanes
//     read the same row);
//   * slot * row_bytes in int64; one store per bag; no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kBagsPerBlock = 4;   // one warp per bag
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTierHot = 0;
constexpr int kTierInt8 = 1;

struct Entry {
  int slot;      // packed position, or -1 when the entry adds nothing
  int tier;
  float scale;
};

// Entry j of a bag: its packed position, tier and scale, or slot -1 when
// the entry adds nothing (past the bag's end, padding or a hole, or a row
// another bank owns).
__device__ __forceinline__ Entry resolve(const int* __restrict__ bag_idx,
                                         int j, int bag_len, int field_off,
                                         const int* __restrict__ bank,
                                         const int* __restrict__ slot,
                                         const int* __restrict__ tier,
                                         const float* __restrict__ scale,
                                         int my) {
  Entry e{-1, 0, 0.0f};
  if (j >= bag_len) return e;
  const int raw = bag_idx[j];
  if (raw < 0) return e;
  const int row = raw + field_off;
  if (my >= 0 && bank[row] != my) return e;
  e.slot = slot[row];
  e.tier = tier[e.slot];
  e.scale = scale[e.slot];
  return e;
}

// Column c of a payload row, dequantized to fp32.
__device__ __forceinline__ float dequant(const int8_t* __restrict__ row,
                                         int t, float s, int c,
                                         bool hot_fp32) {
  if (t == kTierHot) {
    if (hot_fp32) return reinterpret_cast<const float*>(row)[c];
    const unsigned bits =
        static_cast<unsigned>(reinterpret_cast<const uint16_t*>(row)[c]);
    return __uint_as_float(bits << 16);
  }
  if (t == kTierInt8) {
    return __fmul_rn(static_cast<float>(row[c]), s);
  }
  const int b = row[c >> 1];                 // sign-extended byte
  const int x = (c & 1) ? (b >> 4) : b;
  const int q = ((x & 0xF) ^ 8) - 8;
  return __fmul_rn(static_cast<float>(q), s);
}

template <int K>
__global__ void __launch_bounds__(kWarp * kBagsPerBlock)
tiered_bag_kernel(const int8_t* __restrict__ payload, int row_bytes,
                  const float* __restrict__ scale,
                  const int* __restrict__ tier, const int* __restrict__ bank,
                  const int* __restrict__ slot, const int* __restrict__ off,
                  int n_fields, int my, const int* __restrict__ idx,
                  float* __restrict__ out, int nb, int bag_len, int dim,
                  bool hot_fp32) {
  constexpr int kUnroll = kWarp / K;          // rows in flight per lane
  __shared__ int live_slot[kBagsPerBlock][kWarp];
  __shared__ int live_tier[kBagsPerBlock][kWarp];
  __shared__ float live_scale[kBagsPerBlock][kWarp];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int bag = blockIdx.x * kBagsPerBlock + w;
  if (bag >= nb) return;                      // uniform across the warp
  const int field_off = off[bag % n_fields];
  const int* bag_idx = idx + static_cast<int64_t>(bag) * bag_len;
  float* out_row = out + static_cast<int64_t>(bag) * dim;
  const unsigned below = (1u << lane) - 1u;

  for (int c0 = 0; c0 < dim; c0 += kWarp * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;

    Entry cur = resolve(bag_idx, lane, bag_len, field_off, bank, slot, tier,
                        scale, my);
    for (int j0 = 0; j0 < bag_len; j0 += kWarp) {
      const Entry nxt = resolve(bag_idx, j0 + kWarp + lane, bag_len,
                                field_off, bank, slot, tier, scale, my);
      const unsigned mask = __ballot_sync(kFull, cur.slot >= 0);
      const int n = __popc(mask);
      if (cur.slot >= 0) {
        const int p = __popc(mask & below);
        live_slot[w][p] = cur.slot;
        live_tier[w][p] = cur.tier;
        live_scale[w][p] = cur.scale;
      }
      __syncwarp();
      for (int u0 = 0; u0 < n; u0 += kUnroll) {
        float v[kUnroll][K];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool take = u0 + u < n;
          const int s = take ? live_slot[w][u0 + u] : 0;
          const int t = take ? live_tier[w][u0 + u] : kTierInt8;
          const float sc = take ? live_scale[w][u0 + u] : 0.0f;
          // int64: slot * row_bytes exceeds 2^31 on full-width tables
          const int8_t* row = payload + static_cast<int64_t>(s) * row_bytes;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int c = c0 + lane + kWarp * k;
            v[u][k] = (take && c < dim) ? dequant(row, t, sc, c, hot_fp32)
                                        : 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
          for (int k = 0; k < K; ++k) acc[k] = __fadd_rn(acc[k], v[u][k]);
        }
      }
      __syncwarp();                           // the lists are rewritten next
      cur = nxt;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = c0 + lane + kWarp * k;
      if (c < dim) out_row[c] = acc[k];
    }
  }
}

}  // namespace

// hot_fp32: 0 = the hot tier stores bf16 bits (row_bytes = 2 * dim), 1 =
// fp32 bits (row_bytes = 4 * dim). The output is fp32 (nb, dim).
extern "C" int tiered_bag_forward(const void* payload, int row_bytes,
                                  const void* scale, const void* tier,
                                  const void* bank, const void* slot,
                                  const void* off, int n_fields, int my,
                                  const void* idx, void* out, int nb,
                                  int bag_len, int dim, int hot_fp32,
                                  int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || dim == 0) return cudaSuccess;
  if (row_bytes != dim * (hot_fp32 ? 4 : 2)) return cudaErrorInvalidValue;
  const dim3 grid((nb + kBagsPerBlock - 1) / kBagsPerBlock);
  const dim3 block(kWarp * kBagsPerBlock);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* p = static_cast<const int8_t*>(payload);
  const float* sc = static_cast<const float*>(scale);
  const int* t = static_cast<const int*>(tier);
  const int* bk = static_cast<const int*>(bank);
  const int* sl = static_cast<const int*>(slot);
  const int* of = static_cast<const int*>(off);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  const bool f32 = hot_fp32 != 0;
  if (dim <= kWarp) {
    tiered_bag_kernel<1><<<grid, block, 0, s>>>(
        p, row_bytes, sc, t, bk, sl, of, n_fields, my, ix, o, nb, bag_len,
        dim, f32);
  } else if (dim <= 2 * kWarp) {
    tiered_bag_kernel<2><<<grid, block, 0, s>>>(
        p, row_bytes, sc, t, bk, sl, of, n_fields, my, ix, o, nb, bag_len,
        dim, f32);
  } else {
    tiered_bag_kernel<4><<<grid, block, 0, s>>>(
        p, row_bytes, sc, t, bk, sl, of, n_fields, my, ix, o, nb, bag_len,
        dim, f32);
  }
  return cudaGetLastError();
}

extern "C" const char* tiered_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
