// DLRM pairwise-dot feature interaction for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/dot_interaction.py::_dot_kernel (and, in the
// model, its einsum twin src/repro/models/dlrm.py::dot_interaction together
// with the two concatenations around it, src/repro/models/dlrm.py:224-226).
//
// What it computes, for every batch row b of z = [x | emb] (F = 1 + the
// embedding fields, D columns): the upper triangle of z[b] z[b]^T with pairs
// in np.triu_indices(F, 1) order (row-major: (0,1), (0,2), ..., (1,2), ...),
// each dot taken in fp32 and cast to z's dtype once. Two entries share the
// kernel:
//   * dot_interaction_forward: z (B, F, D) -> out (B, P), P = F(F-1)/2; x is
//     z[:, 0] and emb is z[:, 1:], read through z's strides;
//   * dot_features_forward: x (B, D) and emb (B, F-1, D) from their own
//     buffers -> feat (B, P + D) = [inter | x], the top MLP's input, so the
//     model's two torch.cat launches around the interaction go away.
// The TPU kernel pads its output to 128 columns for its lane layout; this
// one writes the P (and D) columns only.
//
// What bounds it on the card: neither bytes nor operations, but the launch
// and one memory latency. At the main-path shape (B = 64, F = 9, D = 32
// fp32) z is 73.7 KB and the output 9.2 KB, ~0.025 us of memory traffic;
// 147 kFLOP is less still. The first design (PR 11) staged z element by
// element with a div and a mod by D per element, found each pair's (i, j)
// with a loop and took 6.75 us (NVIDIA H100 80GB HBM3, 700 W, CUDA events;
// chip_smoke.py).
//
// What the design does about it: one short pass. A block takes a few batch
// rows and copies each row's x and emb bytes, both contiguous, into shared
// memory with cp.async (16-byte copies when the strides and bases allow,
// 4-byte ones otherwise, 2-byte plain copies for odd-width bf16), all issued
// before one wait, with no div or mod by D. A thread per pair (i < j) maps
// its index to (i, j) in closed form, then takes an fp32 dot over D from
// shared memory, each lane of a warp starting at its own column so that the
// lanes' reads fall in different banks. The fused entry also writes x's D
// values (bit for bit) after the P dots. No Gram matrix is formed and
// nothing is padded. Tensor cores do not pay at these sizes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
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

// Copy 1 << shift bytes from global to shared memory: cp.async for 16 and
// 4 bytes, a plain 2-byte load and store otherwise.
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src,
                                          int shift) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (shift == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else if (shift == 2) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src) : "memory");
  } else {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

// Pair p -> (i, j): the first pair of row i is start(i) = i (2F - i - 1) / 2,
// so i is the root of a quadratic; the float estimate is corrected by a
// step where rounding put it on the wrong side of a row's start.
__device__ __forceinline__ void pair_of(int p, int f, int* i, int* j) {
  const float b = 2.0f * f - 1.0f;
  int r = static_cast<int>(floorf((b - sqrtf(b * b - 8.0f * p)) * 0.5f));
  r = max(0, min(r, f - 2));
  while (r > 0 && r * (2 * f - r - 1) / 2 > p) --r;
  while ((r + 1) * (2 * f - r - 2) / 2 <= p) ++r;
  *i = r;
  *j = p - r * (2 * f - r - 1) / 2 + r + 1;
}

// x (B, D) with row stride sx, emb (B, F-1, D) with row stride se (each
// batch row's F-1 vectors contiguous), out (B, *) with row stride so: the
// P dots at columns [0, P), and with write_x x at [P, P + D). Strides in
// elements; shift = log2 of the copy unit in bytes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
dot_interaction_kernel(const T* __restrict__ x, int64_t sx,
                       const T* __restrict__ emb, int64_t se,
                       T* __restrict__ out, int64_t so, int write_x,
                       int batch, int n_fields, int dim, int rows_per_block,
                       int shift) {
  extern __shared__ __align__(16) unsigned char zs_raw[];
  const int row_bytes =
      (n_fields * dim * static_cast<int>(sizeof(T)) + 15) / 16 * 16;
  const int b0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, batch - b0);
  const int xu = dim * static_cast<int>(sizeof(T)) >> shift;
  const int all_u = n_fields * dim * static_cast<int>(sizeof(T)) >> shift;
  for (int r = 0; r < rows; ++r) {
    const unsigned char* xs =
        reinterpret_cast<const unsigned char*>(x + (b0 + r) * sx);
    const unsigned char* es =
        reinterpret_cast<const unsigned char*>(emb + (b0 + r) * se);
    unsigned char* dst = zs_raw + r * row_bytes;
    for (int u = threadIdx.x; u < all_u; u += blockDim.x) {
      const unsigned char* src =
          u < xu ? xs + (u << shift) : es + ((u - xu) << shift);
      copy_unit(dst + (u << shift), src, shift);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const T* zs = reinterpret_cast<const T*>(zs_raw);
  const int ld = row_bytes / static_cast<int>(sizeof(T));
  const int n_pairs = n_fields * (n_fields - 1) / 2;
  const int d0 = dim > 0 ? (threadIdx.x % 32) % dim : 0;  // first column
  for (int t = threadIdx.x; t < rows * n_pairs; t += blockDim.x) {
    const int r = t / n_pairs;
    const int p = t - r * n_pairs;
    int i, j;
    pair_of(p, n_fields, &i, &j);
    const T* zi = zs + r * ld + i * dim;
    const T* zj = zs + r * ld + j * dim;
    // one loop of D steps for every lane (no divergence), the column
    // wrapping round from d0
    float acc = 0.0f;
    int d = d0;
#pragma unroll 4
    for (int k = 0; k < dim; ++k) {
      acc = fmaf(to_f32(zi[d]), to_f32(zj[d]), acc);
      d = d + 1 == dim ? 0 : d + 1;
    }
    store(out + (b0 + r) * so + p, acc);
  }
  if (write_x) {
    for (int r = 0; r < rows; ++r) {
      for (int d = threadIdx.x; d < dim; d += blockDim.x) {
        out[(b0 + r) * so + n_pairs + d] = zs[r * ld + d];
      }
    }
  }
}

cudaError_t launch(const void* x, int64_t sx, const void* emb, int64_t se,
                   int dtype, void* out, int64_t so, int write_x, int batch,
                   int n_fields, int dim, int rows_per_block, int vec,
                   int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int n_pairs = n_fields * (n_fields - 1) / 2;
  if (batch == 0 || (n_pairs == 0 && !write_x)) {
    return cudaSuccess;
  }
  const int shift = vec == 16 ? 4 : vec == 4 ? 2 : vec == 2 ? 1 : -1;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (shift < 0 || vec < itemsize || rows_per_block < 1 ||
      (static_cast<int64_t>(dim) * itemsize) % vec != 0 ||
      (sx * itemsize) % vec != 0 || (se * itemsize) % vec != 0 ||
      reinterpret_cast<uintptr_t>(x) % vec != 0 ||
      reinterpret_cast<uintptr_t>(emb) % vec != 0) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block);
  const size_t smem = static_cast<size_t>(rows_per_block) *
      ((static_cast<size_t>(n_fields) * dim * itemsize + 15) / 16 * 16);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dot_interaction_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), sx, static_cast<const float*>(emb), se,
        static_cast<float*>(out), so, write_x, batch, n_fields, dim,
        rows_per_block, shift);
  } else if (dtype == 1) {
    dot_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), sx,
        static_cast<const __nv_bfloat16*>(emb), se,
        static_cast<__nv_bfloat16*>(out), so, write_x, batch, n_fields, dim,
        rows_per_block, shift);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z and output alike). z (B, F, D)
// contiguous -> out (B, P). The caller picks rows_per_block so that
// rows_per_block rows of F x D values (each rounded up to 16 bytes) fit in
// the 48 KB of shared memory a block gets without opting in, and vec, the
// copy unit in bytes (16, 4 or 2), so that it divides D's bytes and z's
// address.
extern "C" int dot_interaction_forward(const void* z, int dtype, void* out,
                                       int batch, int n_fields, int dim,
                                       int rows_per_block, int device,
                                       void* stream, int vec) {
  const int itemsize = dtype == 0 ? 4 : 2;
  const int64_t row = static_cast<int64_t>(n_fields) * dim;
  return launch(z, row, static_cast<const unsigned char*>(z) +
                static_cast<int64_t>(dim) * itemsize, row, dtype, out,
                n_fields * (n_fields - 1) / 2, 0, batch, n_fields, dim,
                rows_per_block, vec, device, stream);
}

// The fused entry: x (B, D) and emb (B, F-1, D), both contiguous, ->
// feat (B, P + D) = [dots | x]. n_fields counts x: F = 1 + emb's fields.
// dtype, rows_per_block and vec as above (vec also divides emb's address).
extern "C" int dot_features_forward(const void* x, const void* emb,
                                    int dtype, void* out, int batch,
                                    int n_fields, int dim,
                                    int rows_per_block, int device,
                                    void* stream, int vec) {
  const int n_pairs = n_fields * (n_fields - 1) / 2;
  return launch(x, dim, emb, static_cast<int64_t>(n_fields - 1) * dim, dtype,
                out, n_pairs + dim, 1, batch, n_fields, dim, rows_per_block,
                vec, device, stream);
}

extern "C" const char* dot_interaction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
