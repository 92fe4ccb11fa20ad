// Sorted-run scatter (the bag sum's transpose: the training backward of the
// banked embedding bag) for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/embedding_bag.py::_ct_scatter_kernel (called
// through _ct_scatter_call by ct_scatter_bag_pallas), which walks the runs
// that the prep scatter_run_metadata sorted out, accumulates each in fp32
// and DMAs the finished row onto a zeros-aliased d_table.
//
// What it computes. The prep (kernels/embedding_bag.py, plain torch on the
// card) labels every entry of the forward's (NB, L) id stream, enumerated
// j-major (e = j * NB + bag), with its destination table slot, and sorts the
// entries stably by slot. Entries that land on one slot form a run
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
// What bounds it on the card: bytes. At the main-path shape (NB = 512 bags,
// L = 256, D = 32 fp32) there are 131,072 entries: the three prep arrays
// (~1.5 MB) are read once, ct (NB x D = 64 KB) stays in L2, and each live
// run writes one 128-byte row to a random place in a 2.4 GB table (~16.8 MB
// for ~131 k distinct rows): ~18 MB, ~5.5 us at 3.35 TB/s. The adds are
// nothing against the card's rate. The zero fill of the dense table
// (2.4 GB) is the caller's and dwarfs this kernel.
//
// What the design does about it:
//   * one warp per run, lanes across D: at D = 32 fp32 a row is one
//     coalesced 128-byte read of ct and one coalesced 128-byte write; for
//     D > 32 a lane owns K columns (K = 2 or 4), and D > 128 walks the run
//     again per 128-column pass;
//   * each lane reads one bag_sorted entry of a 32-entry chunk (coalesced),
//     the warp shares them by shuffle, and a lane issues all ct row loads of
//     a chunk before it adds them, in order (32 / K loads in flight); the
//     next chunk's entries are read before the current chunk's rows;
//   * no run is split across threads and there are no atomics: each slot is
//     written by exactly one warp, once, in the reference's summation order.
// A past-the-end lane of the last chunk adds 0.0f: the accumulator starts at
// +0 and round-to-nearest never turns it into -0, so that adds nothing.
// Hot rows under Zipf ids make long runs that one warp walks serially; that
// is left as it is in this first design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kRunsPerBlock = 4;   // one warp per run
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename TC, typename TO, int K>
__global__ void __launch_bounds__(kWarp * kRunsPerBlock)
ct_scatter_kernel(const TC* __restrict__ ct,
                  const int* __restrict__ bag_sorted,
                  const int* __restrict__ run_starts,
                  const int* __restrict__ run_slot,
                  const int* __restrict__ n_run, TO* __restrict__ out,
                  int n_runs_pad, int dim) {
  constexpr int kUnroll = kWarp / K;          // ct row loads in flight
  const int lane = threadIdx.x % kWarp;
  const int run = blockIdx.x * kRunsPerBlock + threadIdx.x / kWarp;
  if (run >= n_runs_pad || run >= *n_run) return;   // uniform in the warp
  const int start = run_starts[run];
  const int end = run_starts[run + 1];
  // int64: slot * D exceeds 2^31 on the largest tables (dlrm-rm2)
  TO* out_row = out + static_cast<int64_t>(run_slot[run]) * dim;

  for (int c0 = 0; c0 < dim; c0 += kWarp * K) {
    float acc[K];
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = 0.0f;

    int src = start + lane < end ? bag_sorted[start + lane] : 0;
    for (int p0 = start; p0 < end; p0 += kWarp) {
      const int q = p0 + kWarp + lane;
      const int nxt = q < end ? bag_sorted[q] : 0;
      const int n = min(kWarp, end - p0);
      for (int u0 = 0; u0 < n; u0 += kUnroll) {
        float v[kUnroll][K];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int b = __shfl_sync(kFull, src, u0 + u);
          const bool take = u0 + u < n;
          const TC* row = ct + (take ? static_cast<int64_t>(b) * dim : 0);
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

template <typename TC, typename TO>
void launch(const void* ct, const void* bag_sorted, const void* run_starts,
            const void* run_slot, const void* n_run, void* out,
            int n_runs_pad, int dim, cudaStream_t stream) {
  const dim3 grid((n_runs_pad + kRunsPerBlock - 1) / kRunsPerBlock);
  const dim3 block(kWarp * kRunsPerBlock);
  const TC* c = static_cast<const TC*>(ct);
  const int* bs = static_cast<const int*>(bag_sorted);
  const int* rs = static_cast<const int*>(run_starts);
  const int* sl = static_cast<const int*>(run_slot);
  const int* nr = static_cast<const int*>(n_run);
  TO* o = static_cast<TO*>(out);
  if (dim <= kWarp) {
    ct_scatter_kernel<TC, TO, 1><<<grid, block, 0, stream>>>(
        c, bs, rs, sl, nr, o, n_runs_pad, dim);
  } else if (dim <= 2 * kWarp) {
    ct_scatter_kernel<TC, TO, 2><<<grid, block, 0, stream>>>(
        c, bs, rs, sl, nr, o, n_runs_pad, dim);
  } else {
    ct_scatter_kernel<TC, TO, 4><<<grid, block, 0, stream>>>(
        c, bs, rs, sl, nr, o, n_runs_pad, dim);
  }
}

template <typename TC>
cudaError_t launch_out(int out_dtype, const void* ct, const void* bag_sorted,
                       const void* run_starts, const void* run_slot,
                       const void* n_run, void* out, int n_runs_pad, int dim,
                       cudaStream_t stream) {
  if (out_dtype == 0) {
    launch<TC, float>(ct, bag_sorted, run_starts, run_slot, n_run, out,
                      n_runs_pad, dim, stream);
  } else if (out_dtype == 1) {
    launch<TC, __nv_bfloat16>(ct, bag_sorted, run_starts, run_slot, n_run,
                              out, n_runs_pad, dim, stream);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

}  // namespace

// ct_dtype, out_dtype: 0 = float32, 1 = bfloat16, each on its own.
extern "C" int ct_scatter_runs(const void* ct, int ct_dtype,
                               const void* bag_sorted, const void* run_starts,
                               const void* run_slot, const void* n_run,
                               void* out, int out_dtype, int n_runs_pad,
                               int dim, int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_runs_pad == 0 || dim == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ct_dtype == 0) {
    err = launch_out<float>(out_dtype, ct, bag_sorted, run_starts, run_slot,
                            n_run, out, n_runs_pad, dim, s);
  } else if (ct_dtype == 1) {
    err = launch_out<__nv_bfloat16>(out_dtype, ct, bag_sorted, run_starts,
                                    run_slot, n_run, out, n_runs_pad, dim, s);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

extern "C" const char* ct_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
