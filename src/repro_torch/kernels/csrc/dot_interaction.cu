// DLRM pairwise-dot feature interaction for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/dot_interaction.py::_dot_kernel (and, in the
// model, its einsum twin src/repro/models/dlrm.py::dot_interaction).
//
// What it computes: z (B, F, D) -> out (B, F(F-1)/2), the upper triangle of
// z[b] z[b]^T with pairs in np.triu_indices(F, 1) order (row-major: (0,1),
// (0,2), ..., (1,2), ...), each dot taken in fp32 and cast to z's dtype. The
// TPU kernel pads its output to 128 columns for its lane layout; this one
// writes the F(F-1)/2 columns only.
//
// What bounds it on the card: neither bytes nor operations, but the launch.
// At the main-path shape (B = 64, F = 9, D = 32 fp32) z is 73.7 KB and the
// output 9.2 KB, ~0.025 us of memory traffic; 147 kFLOP is less still. The
// kernel's time is its launch and one pass of a few blocks.
//
// What the design does about it: keep it to one short pass. A block takes
// a few batch rows, stages their F x D values in shared memory as fp32 (row
// stride D + 1, so the threads of a warp, which read different rows j at the
// same d, hit different banks), and gives one thread to each pair (i < j):
// an fp32 dot over D, written to its triu position. No Gram matrix is formed
// and nothing is padded. Tensor cores do not pay at these sizes; a later PR
// may fuse this into the MLP around it instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ z, T* __restrict__ out,
                       int batch, int n_fields, int dim, int rows_per_block) {
  extern __shared__ float zs[];               // rows_per_block * F * (D + 1)
  const int ld = dim + 1;
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  const int per_row = n_fields * dim;
  const T* zb = z + static_cast<int64_t>(b0) * per_row;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int f = e / dim, d = e % dim;       // f counts rows * F vectors
    zs[f * ld + d] = to_f32(zb[e]);
  }
  __syncthreads();

  const int n_pairs = n_fields * (n_fields - 1) / 2;
  for (int t = threadIdx.x; t < rows * n_pairs; t += blockDim.x) {
    const int r = t / n_pairs;
    int p = t % n_pairs, i = 0;
    while (p >= n_fields - 1 - i) {           // pair index -> (i, j), i < j
      p -= n_fields - 1 - i;
      ++i;
    }
    const int j = i + 1 + p;
    const float* zi = zs + (r * n_fields + i) * ld;
    const float* zj = zs + (r * n_fields + j) * ld;
    float acc = 0.0f;
    for (int d = 0; d < dim; ++d) acc = fmaf(zi[d], zj[d], acc);
    store(out + static_cast<int64_t>(b0 + r) * n_pairs + t % n_pairs, acc);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z and output alike). The caller picks
// rows_per_block so that rows_per_block * F * (D + 1) * 4 bytes fit in the
// 48 KB of shared memory a block gets without opting in.
extern "C" int dot_interaction_forward(const void* z, int dtype, void* out,
                                       int batch, int n_fields, int dim,
                                       int rows_per_block, int device,
                                       void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (batch == 0 || n_fields < 2) return cudaSuccess;
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block);
  const size_t smem =
      static_cast<size_t>(rows_per_block) * n_fields * (dim + 1) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dot_interaction_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(z), static_cast<float*>(out), batch,
        n_fields, dim, rows_per_block);
  } else if (dtype == 1) {
    dot_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<__nv_bfloat16*>(out),
        batch, n_fields, dim, rows_per_block);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

extern "C" const char* dot_interaction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
