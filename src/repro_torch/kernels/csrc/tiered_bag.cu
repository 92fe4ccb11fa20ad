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
// quantized value is ONE rounded fp32 multiply (__fmul_rn) and is then added
// to the accumulator by ONE rounded fp32 add (__fadd_rn); the two never meet
// in one FMA (the product goes through shared memory). Every column is one
// fp32 accumulator from +0, added in entry order; entries that add nothing
// (padding, holes, foreign rows) are skipped: the accumulator starts at +0
// and round-to-nearest never turns it into -0, so skipping a +0 add changes
// nothing.
//
// What bounds it on the card: bytes, in principle. At the adaptive serve
// shape (NB = 512 bags of batch 64 x 8 fields, L = 256, D = 32, bf16 hot,
// int4 cold) a batch reads 127,795 live entries of Zipf ids over a 1.5 GB
// payload, 56,699 distinct rows: per distinct row its 4-byte slot, 4-byte
// tier, 4-byte scale and 16 (int4), 32 (int8) or 64 (bf16) payload bytes,
// 0.684 us at 3.35 TB/s. In practice it is latency: every row is the end of
// a dependent chain idx -> bank/slot -> tier/scale -> row bytes. The first
// design (PR 14) gave each bag one warp (512 warps on 132 SMs), paid the
// chain once per 32-entry chunk, and branched on the tier between a row's
// load and its use, so a chunk's row loads did not overlap: 102.5 us
// (NVIDIA H100 80GB HBM3, 700 W, CUDA events, L2 flushed; chip_smoke.py).
//
// What the design does about it: a block of 256 threads per bag, four
// blocks an SM (at most 64 registers a thread), so the 512 bags run as one
// wave of 4,096 warps, and the chain is paid once per bag (once per chunk
// of up to 256 entries when L is longer):
//   * resolve: thread j resolves entry j (the idx read, then bank and slot
//     read together, then tier and scale read together); the live entries
//     are compacted in entry order (ballot and popc per warp, a prefix over
//     the warps) into shared lists of row pointers, tiers and scales;
//   * gather: warp w takes live entries w, w + 8, ..., its lanes the
//     columns; a lane issues the loads of kItems (entry, column) items
//     before it decodes any. A load reads the aligned 32-bit word that
//     holds the column's bits, its byte picked by selects on the tier (2c
//     or 4c hot, c int8, c / 2 int4), with no branch between one load and
//     the next; the word is then decoded for all three tiers and the
//     tier's value selected. Each value (one __fmul_rn for int8/int4) goes
//     to shared memory as fp32. (16 items in flight spill under the
//     register cap and run slower; a whole-row read beside tier and scale
//     reads 4x the bytes of an int4 row and ran slower too.)
//   * sum: thread c < D walks the staged values of column c in entry order
//     with __fadd_rn and, after the last chunk, stores the bag's column
//     once. The staging buffer holds kStage values; where L x D exceeds it
//     (or L exceeds the block), the bag is walked in chunks of entries and
//     the accumulators carry over; D above the block walks it again per
//     pass of 256 columns.
// Measured (chip_smoke.py, the same card and method): 28.4 us; 25.5 with
// the rows L2-resident (tools/kernel_probe.py), so the per-bag chain and
// in-order sum, not memory, hold it now.
// The aligned word of a valid byte never leaves the allocation (CUDA
// allocations start 256-byte aligned and are whole words long). slot *
// row_bytes in int64; one store per column; no atomics.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                 // one block per bag
constexpr int kWarps = kThreads / kWarp;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStage = 8192;                  // staged fp32 values (32 KB)
constexpr int kItems = 8;                     // gather loads in flight
constexpr int kTierHot = 0;
constexpr int kTierInt8 = 1;

// Byte of a row that holds column c at tier t (its aligned 32-bit word
// holds all of the column's bits): 2c or 4c hot, c int8, c / 2 int4.
// Selects, no branch.
__device__ __forceinline__ int column_byte(int t, int c, int hot_width) {
  return t == kTierHot ? c * hot_width : t == kTierInt8 ? c : c >> 1;
}

// Column c of a row at tier t (scale sc) from the 32-bit word at byte `at`
// of the row (any byte offset; the word is the aligned one holding it).
__device__ __forceinline__ float decode(unsigned word, uintptr_t at, int t,
                                        float sc, int c, bool hot_fp32) {
  const unsigned x = word >> ((at & 3u) * 8);
  const float hot = hot_fp32 ? __uint_as_float(word)
                             : __uint_as_float((x & 0xffffu) << 16);
  const int b = static_cast<int>(static_cast<int8_t>(x & 0xffu));
  const int nib = (c & 1) ? (b >> 4) : b;
  const int q = t == kTierInt8 ? b : ((nib & 0xF) ^ 8) - 8;
  const float deq = __fmul_rn(static_cast<float>(q), sc);
  return t == kTierHot ? hot : deq;
}

__global__ void __launch_bounds__(kThreads, 4)
tiered_bag_kernel(const int8_t* __restrict__ payload, int row_bytes,
                  const float* __restrict__ scale,
                  const int* __restrict__ tier, const int* __restrict__ bank,
                  const int* __restrict__ slot, const int* __restrict__ off,
                  int n_fields, int my, const int* __restrict__ idx,
                  float* __restrict__ out, int bag_len, int dim,
                  bool hot_fp32) {
  __shared__ float s_val[kStage];
  __shared__ const int8_t* s_row[kThreads];
  __shared__ int s_tier[kThreads];
  __shared__ float s_scale[kThreads];
  __shared__ int s_cnt[kWarps];
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  const int bag = blockIdx.x;
  const int field_off = __ldg(off + bag % n_fields);
  const int* bag_idx = idx + static_cast<int64_t>(bag) * bag_len;
  float* out_row = out + static_cast<int64_t>(bag) * dim;
  const int hot_width = hot_fp32 ? 4 : 2;

  for (int c0 = 0; c0 < dim; c0 += kThreads) {
    const int dp = min(kThreads, dim - c0);   // columns in this pass
    const int chunk = min(kThreads, kStage / dp);
    float acc = 0.0f;                         // column c0 + tid, if < dim
    for (int j0 = 0; j0 < bag_len; j0 += chunk) {
      // resolve entry j0 + tid: its slot, tier and scale, or not live
      const int j = j0 + tid;
      const int raw = tid < chunk && j < bag_len ? __ldg(bag_idx + j) : -1;
      const int row = raw + field_off;
      const bool valid = raw >= 0;
      const int bk = valid && my >= 0 ? __ldg(bank + row) : my;
      const int s = valid ? __ldg(slot + row) : 0;
      const bool live = valid && (my < 0 || bk == my);
      const int t = live ? __ldg(tier + s) : 0;
      const float sc = live ? __ldg(scale + s) : 0.0f;
      const unsigned m = __ballot_sync(kFull, live);
      if (lane == 0) s_cnt[warp] = __popc(m);
      __syncthreads();
      int pre = 0, n_live = 0;
#pragma unroll
      for (int x = 0; x < kWarps; ++x) {
        if (x < warp) pre += s_cnt[x];
        n_live += s_cnt[x];
      }
      if (live) {
        const int p = pre + __popc(m & ((1u << lane) - 1u));
        s_row[p] = payload + static_cast<int64_t>(s) * row_bytes;
        s_tier[p] = t;
        s_scale[p] = sc;
      }
      __syncthreads();

      // gather: warp w takes entries w, w + 8, ..., lane the columns
      // c0 + lane + 32 m; kItems (entry, column) items at a time, all their
      // loads first, then the decodes
      const int cpl = (dp + kWarp - 1) / kWarp;   // columns a lane
      const int n_items = ((n_live - warp + kWarps - 1) / kWarps) * cpl;
      for (int i0 = 0; i0 < n_items; i0 += kItems) {
        unsigned word[kItems];
        int k = i0 / cpl, mm = i0 - k * cpl;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int e = warp + k * kWarps, c = lane + mm * kWarp;
          if (i0 + i < n_items && c < dp) {
            const uintptr_t at = reinterpret_cast<uintptr_t>(
                s_row[e] + column_byte(s_tier[e], c0 + c, hot_width));
            word[i] = __ldg(reinterpret_cast<const unsigned*>(
                at & ~uintptr_t{3}));
          }
          if (++mm == cpl) {
            mm = 0;
            ++k;
          }
        }
        k = i0 / cpl;
        mm = i0 - k * cpl;
#pragma unroll
        for (int i = 0; i < kItems; ++i) {
          const int e = warp + k * kWarps, c = lane + mm * kWarp;
          if (i0 + i < n_items && c < dp) {
            const int t = s_tier[e];
            const uintptr_t at = reinterpret_cast<uintptr_t>(
                s_row[e] + column_byte(t, c0 + c, hot_width));
            s_val[e * dp + c] =
                decode(word[i], at, t, s_scale[e], c0 + c, hot_fp32);
          }
          if (++mm == cpl) {
            mm = 0;
            ++k;
          }
        }
      }
      __syncthreads();

      // sum: column c0 + tid over the chunk's live entries, in entry order
      if (tid < dp) {
        int k = 0;
        for (; k + 8 <= n_live; k += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u) v[u] = s_val[(k + u) * dp + tid];
#pragma unroll
          for (int u = 0; u < 8; ++u) acc = __fadd_rn(acc, v[u]);
        }
        for (; k < n_live; ++k) acc = __fadd_rn(acc, s_val[k * dp + tid]);
      }
      __syncthreads();                        // the lists are rewritten next
    }
    if (tid < dp) out_row[c0 + tid] = acc;
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
  tiered_bag_kernel<<<nb, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(payload), row_bytes,
      static_cast<const float*>(scale), static_cast<const int*>(tier),
      static_cast<const int*>(bank), static_cast<const int*>(slot),
      static_cast<const int*>(off), n_fields, my,
      static_cast<const int*>(idx), static_cast<float*>(out), bag_len, dim,
      hot_fp32 != 0);
  return cudaGetLastError();
}

extern "C" const char* tiered_bag_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
