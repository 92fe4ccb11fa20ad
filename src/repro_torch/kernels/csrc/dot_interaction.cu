// DLRM pairwise-dot feature interaction for Hopper, sm_90a.
//
// Replaces: src/repro/kernels/dot_interaction.py::_dot_kernel (and, in the
// model, its einsum twin src/repro/models/dlrm.py::dot_interaction together
// with the two concatenations around it, src/repro/models/dlrm.py:224-226,
// and the broadcast of the query side in retrieval_scores,
// src/repro/models/dlrm.py:301-305).
//
// What it computes, for every batch row b of z = [x | emb] (F = 1 + the
// embedding fields, D columns): the upper triangle of z[b] z[b]^T with pairs
// in np.triu_indices(F, 1) order (row-major: (0,1), (0,2), ..., (1,2), ...),
// each dot taken in fp32 and cast to z's dtype once. Three entries:
//   * dot_interaction_forward: z (B, F, D) -> out (B, P), P = F(F-1)/2; x is
//     z[:, 0] and emb is z[:, 1:], read through z's strides;
//   * dot_features_forward: x (B, D) and emb (B, F-1, D) from their own
//     buffers -> feat (B, P + D) = [inter | x], the top MLP's input, so the
//     model's two torch.cat launches around the interaction go away;
//   * dot_features_query_forward: one query, x (D) and user (U, D), against
//     N candidate rows cand (N, D) -> (N, P + D), F = U + 2: the fused
//     entry's output for z[n] = [x | user | cand[n]] without x and user
//     broadcast to N.
// The TPU kernel pads its output to 128 columns for its lane layout; this
// one writes the P (and D) columns only.
//
// Three geometries, picked by the host (kernels/dot_interaction.py):
//
// One row at a time (P <= 128; the serve and train paths' F = 9). What
// bounds it is neither bytes nor operations but the launch and one memory
// latency: at (64, 9, 32) fp32 z is 73.7 KB, ~0.025 us of traffic. A block
// takes a few batch rows and copies each row's x and emb bytes, both
// contiguous, into shared memory with cp.async (16-byte copies when the
// strides and bases allow, 4-byte ones otherwise, 2-byte plain copies for
// odd-width bf16), all issued before one wait, with no div or mod by D. A
// thread per pair (i < j) maps its index to (i, j) in closed form, then
// takes an fp32 dot over D from shared memory, each lane of a warp starting
// at its own column so that the lanes' reads fall in different banks.
//
// Tiles of rows (P > 128; dlrm-rm2's F = 27, P = 351). At (262,144, 27, 64)
// fp32 the bytes bound the call: 2.25 GB of z and output (0.67 ms at 3.35
// TB/s) against 11.8 GFLOP (0.18 ms of fp32 FMA). One row a block, as the
// first geometry gives at this P, took 10.55 ms at N = 10^6 (24 % of the
// bound; NVIDIA H100 80GB HBM3, 700 W): a million blocks, each dot reading
// both operands from shared memory on every step, two loads an FMA. Here a
// block stages a tile of R rows (R = 8 at F = 27) into one of two shared
// buffers with cp.async while it computes the tile staged before, and walks
// every gridDim-th tile, so a persistent grid of about two blocks an SM
// streams the batch. The fields are cut into blocks of 4; each thread owns
// one 4 x 4 block (I <= J) of the upper triangle of one row's Gram matrix
// (28 blocks at F = 27, R x 28 = 224 threads) and keeps its 16 dots in
// registers: each 16-byte shared load of z_i or z_j (4 fp32 or 8 bf16
// columns) serves 4 rows of FMAs, a quarter load an FMA. Lane l of a warp
// takes row l % R, and rows are staged an odd number of 16-byte units
// apart, so the 8 lanes of a 16-byte load phase hit 8 different bank
// groups. The finished tile's dots (and the x columns, re-read from L2)
// are written over the staged rows as R contiguous output rows, then
// stored with 16-byte coalesced stores. The dots stay fp32 FFMA, each
// summed in column order.
//
// The query entry (retrieval). Of a candidate's P = 351 dots, the 325
// among x and the user rows are the same for every candidate; only the 26
// against the candidate row differ. A block reads x and the user rows into
// shared memory once, computes the constant dots once (every block the
// same arithmetic, so every output row holds the same bits), and lays out
// R = 32 output rows of [constants | x] in shared memory once. Then for
// each tile of R candidate rows, staged with cp.async into one of two
// buffers while the previous tile is scored, a thread takes one row and
// 4 query rows (the query loads are broadcasts across the warp), writes
// its dots into the 26 candidate columns, and the block stores the R rows
// with 16-byte coalesced stores. The (N, 415) fp32 output, 1.66 GB at
// N = 10^6, is most of its 1.92 GB of traffic.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 128;       // the one-row geometry's block
constexpr int kTileThreads = 256;   // at most, the tiled and query blocks

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

__device__ __forceinline__ void commit_group() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (0 or 1).
__device__ __forceinline__ void wait_groups(int pending) {
  if (pending) {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// Rows of a tile of `rows` rows with `left` rows of the batch left.
__device__ __forceinline__ int tile_rows(int rows, int64_t left) {
  return left < rows ? static_cast<int>(left) : rows;
}

// Column of pair (i, j), i < j, in triu_indices(F, 1) order.
__device__ __forceinline__ int pair_col(int i, int j, int f) {
  return i * (2 * f - i - 1) / 2 + j - i - 1;
}

// V consecutive values at p as fp32: one 16-byte shared load where V values
// of T make 16 bytes, one load a value otherwise.
template <typename T, int V>
__device__ __forceinline__ void load_f32(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16 && sizeof(T) == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else if constexpr (V * sizeof(T) == 16) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(h[k]);
      v[2 * k] = f.x;
      v[2 * k + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = to_f32(p[k]);
  }
}

// Store n contiguous elements of T from shared src to global dst, 16 bytes
// a store where dst is 16-byte aligned (src always is), then the tail.
template <typename T>
__device__ __forceinline__ void store_rows(T* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int64_t n) {
  constexpr int kPer = 16 / sizeof(T);
  int64_t done = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int64_t units = n / kPer;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int64_t u = threadIdx.x; u < units; u += blockDim.x) d4[u] = s4[u];
    done = units * kPer;
  }
  for (int64_t e = done + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// ---------------------------------------------------------------------------
// One row at a time (P <= 128)
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// Tiles of rows (P > 128)
// ---------------------------------------------------------------------------

// Stage rows [b0, b0 + n) of [x | emb] into buf, row r at r * row_bytes;
// each thread issues its cp.async copies (no commit).
template <typename T>
__device__ __forceinline__ void stage_rows(
    unsigned char* buf, const T* __restrict__ x, int64_t sx,
    const T* __restrict__ emb, int64_t se, int64_t b0, int n, int n_fields,
    int dim, int row_bytes, int shift) {
  const int xu = dim * static_cast<int>(sizeof(T)) >> shift;
  const int all_u = n_fields * dim * static_cast<int>(sizeof(T)) >> shift;
  for (int r = 0; r < n; ++r) {
    const unsigned char* xs =
        reinterpret_cast<const unsigned char*>(x + (b0 + r) * sx);
    const unsigned char* es =
        reinterpret_cast<const unsigned char*>(emb + (b0 + r) * se);
    unsigned char* dst = buf + r * row_bytes;
    for (int u = threadIdx.x; u < all_u; u += blockDim.x) {
      const unsigned char* src =
          u < xu ? xs + (u << shift) : es + ((u - xu) << shift);
      copy_unit(dst + (u << shift), src, shift);
    }
  }
}

// As dot_interaction_kernel, for rows tiles of `rows` rows: the block has
// rows x n_tiles threads, n_tiles the 4 x 4 field blocks (I <= J) of the
// upper triangle; two shared buffers of buf_bytes each, a staged row
// row_bytes apart (an odd number of 16-byte units). Needs D * sizeof(T) a
// multiple of 16.
template <typename T>
__global__ void __launch_bounds__(kTileThreads)
dot_tiled_kernel(const T* __restrict__ x, int64_t sx,
                 const T* __restrict__ emb, int64_t se, T* __restrict__ out,
                 int64_t so, int write_x, int batch, int n_fields, int dim,
                 int rows, int row_bytes, int buf_bytes, int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int V = 16 / sizeof(T);
  const int n_pairs = n_fields * (n_fields - 1) / 2;
  const int n_blocks = (n_fields + 3) / 4;
  const int n_stages = (batch + rows - 1) / rows;
  const int r = threadIdx.x % rows;
  // this thread's field block (I, J), I <= J, row-major over the triangle
  int k = threadIdx.x / rows, bi = 0;
  while (k >= n_blocks - bi) {
    k -= n_blocks - bi;
    ++bi;
  }
  const int bj = bi + k;
  int fi[4], fj[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {               // past F: read field F - 1
    fi[a] = min(4 * bi + a, n_fields - 1);
    fj[a] = min(4 * bj + a, n_fields - 1);
  }

  if (blockIdx.x < n_stages) {
    const int64_t b0 = static_cast<int64_t>(blockIdx.x) * rows;
    stage_rows(smem, x, sx, emb, se, b0,
               tile_rows(rows, batch - b0), n_fields,
               dim, row_bytes, shift);
  }
  commit_group();
  int it = 0;
  for (int s = blockIdx.x; s < n_stages; s += gridDim.x, ++it) {
    unsigned char* buf = smem + (it & 1) * buf_bytes;
    const int s_next = s + gridDim.x;
    if (s_next < n_stages) {
      const int64_t nb0 = static_cast<int64_t>(s_next) * rows;
      stage_rows(smem + ((it + 1) & 1) * buf_bytes, x, sx, emb, se, nb0,
                 tile_rows(rows, batch - nb0),
                 n_fields, dim, row_bytes, shift);
    }
    commit_group();
    wait_groups(1);                           // tile s has landed
    __syncthreads();

    const int64_t b0 = static_cast<int64_t>(s) * rows;
    const int n = tile_rows(rows, batch - b0);
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
    }
    if (r < n) {
      const T* zr = reinterpret_cast<const T*>(buf + r * row_bytes);
      for (int d = 0; d < dim; d += V) {
        float vi[4][V], vj[4][V];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          load_f32<T, V>(zr + fi[a] * dim + d, vi[a]);
          load_f32<T, V>(zr + fj[a] * dim + d, vj[a]);
        }
#pragma unroll
        for (int e = 0; e < V; ++e) {
#pragma unroll
          for (int a = 0; a < 4; ++a) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              acc[a][c] = fmaf(vi[a][e], vj[c][e], acc[a][c]);
            }
          }
        }
      }
    }
    __syncthreads();                          // the staged rows are read

    // the tile's output rows, contiguous, over the staged rows
    T* ob = reinterpret_cast<T*>(buf);
    if (r < n) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = 4 * bi + a, j = 4 * bj + c;
          if (i < j && j < n_fields) {
            store(ob + r * so + pair_col(i, j, n_fields), acc[a][c]);
          }
        }
      }
    }
    if (write_x) {
      for (int e = threadIdx.x; e < n * dim; e += blockDim.x) {
        const int rr = e / dim, d = e - rr * dim;
        ob[rr * so + n_pairs + d] = x[(b0 + rr) * sx + d];
      }
    }
    __syncthreads();
    store_rows(out + b0 * so, ob, static_cast<int64_t>(n) * so);
    __syncthreads();                          // buf is free to refill
  }
  wait_groups(0);
}

// ---------------------------------------------------------------------------
// The query entry
// ---------------------------------------------------------------------------

// Stage candidate rows [c0, c0 + n) into buf, row r at r * row_bytes.
template <typename T>
__device__ __forceinline__ void stage_cands(unsigned char* buf,
                                            const T* __restrict__ cand,
                                            int64_t c0, int n, int dim,
                                            int row_bytes, int shift) {
  const int units = dim * static_cast<int>(sizeof(T)) >> shift;
  const unsigned char* src =
      reinterpret_cast<const unsigned char*>(cand + c0 * dim);
  for (int t = threadIdx.x; t < n * units; t += blockDim.x) {
    const int r = t / units, u = t - r * units;
    copy_unit(buf + r * row_bytes + (u << shift),
              src + (static_cast<int64_t>(t) << shift), shift);
  }
}

// x (D), user (U, D), cand (N, D), all contiguous -> out (N, P + D),
// F = U + 2. The block has rows x ceil((U + 1) / 4) threads: thread t
// scores row t % rows against query rows 4 (t / rows) .. + 3 (query row 0
// is x, q the user rows). Shared memory: the U + 1 query rows (q_bytes),
// two candidate buffers of rows x row_bytes, and the rows output rows.
template <typename T, int V>
__global__ void __launch_bounds__(kTileThreads)
dot_query_kernel(const T* __restrict__ x, const T* __restrict__ user,
                 const T* __restrict__ cand, T* __restrict__ out, int n_user,
                 int n_cand, int dim, int rows, int row_bytes, int q_bytes,
                 int shift) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_fields = n_user + 2, n_q = n_user + 1;
  const int n_pairs = n_fields * (n_fields - 1) / 2;
  const int width = n_pairs + dim;
  const int n_stages = (n_cand + rows - 1) / rows;
  T* qs = reinterpret_cast<T*>(smem);
  unsigned char* cbuf = smem + q_bytes;
  T* ob = reinterpret_cast<T*>(cbuf + 2 * rows * row_bytes);

  if (blockIdx.x < n_stages) {
    const int64_t c0 = static_cast<int64_t>(blockIdx.x) * rows;
    stage_cands(cbuf, cand, c0,
                tile_rows(rows, n_cand - c0), dim,
                row_bytes, shift);
  }
  commit_group();
  for (int e = threadIdx.x; e < n_q * dim; e += blockDim.x) {
    qs[e] = e < dim ? x[e] : user[e - dim];
  }
  __syncthreads();
  // output row 0: the constant dots, 0 in the candidate columns, then x
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float v = 0.0f;
    if (c < n_pairs) {
      int i, j;
      pair_of(c, n_fields, &i, &j);
      if (j < n_fields - 1) {
        const T* qi = qs + i * dim;
        const T* qj = qs + j * dim;
        for (int d = 0; d < dim; ++d) {
          v = fmaf(to_f32(qi[d]), to_f32(qj[d]), v);
        }
      }
      store(ob + c, v);
    } else {
      ob[c] = qs[c - n_pairs];
    }
  }
  __syncthreads();
  for (int e = width + threadIdx.x; e < rows * width; e += blockDim.x) {
    ob[e] = ob[e % width];
  }

  const int r = threadIdx.x % rows;
  const int g = threadIdx.x / rows;
  int qi[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) qi[a] = min(4 * g + a, n_q - 1);
  int it = 0;
  for (int s = blockIdx.x; s < n_stages; s += gridDim.x, ++it) {
    const int s_next = s + gridDim.x;
    if (s_next < n_stages) {
      const int64_t c0 = static_cast<int64_t>(s_next) * rows;
      stage_cands(cbuf + ((it + 1) & 1) * rows * row_bytes, cand, c0,
                  tile_rows(rows, n_cand - c0), dim,
                  row_bytes, shift);
    }
    commit_group();
    wait_groups(1);                           // tile s has landed
    __syncthreads();                          // (and row 0 is copied)

    const int64_t c0 = static_cast<int64_t>(s) * rows;
    const int n = tile_rows(rows, n_cand - c0);
    if (r < n) {
      const T* cr = reinterpret_cast<const T*>(
          cbuf + (it & 1) * rows * row_bytes + r * row_bytes);
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int d = 0; d < dim; d += V) {
        float vc[V], vq[4][V];
        load_f32<T, V>(cr + d, vc);
#pragma unroll
        for (int a = 0; a < 4; ++a) load_f32<T, V>(qs + qi[a] * dim + d, vq[a]);
#pragma unroll
        for (int e = 0; e < V; ++e) {
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a] = fmaf(vq[a][e], vc[e], acc[a]);
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = 4 * g + a;
        if (i < n_q) {
          store(ob + r * width + pair_col(i, n_fields - 1, n_fields),
                acc[a]);
        }
      }
    }
    __syncthreads();
    store_rows(out + c0 * width, ob, static_cast<int64_t>(n) * width);
    __syncthreads();                          // ob and the buffer are free
  }
  wait_groups(0);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

int round16(int64_t n) { return static_cast<int>((n + 15) / 16 * 16); }

// A staged row's stride in the tiled and query geometries: the row's bytes
// rounded up to an odd number of 16-byte units.
int staged_row_bytes(int64_t nbytes) {
  const int b = round16(nbytes);
  return (b / 16) % 2 ? b : b + 16;
}

// Blocks that fit on the card at once for kern, threads and smem bytes of
// dynamic shared memory (opted in above 48 KB), or 0 on error.
template <typename K>
int resident_blocks(K kern, int threads, int smem, int device,
                    cudaError_t* err) {
  int optin = 0, sms = 0, per_sm = 0;
  *err = cudaDeviceGetAttribute(&optin,
                                cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                device);
  if (*err != cudaSuccess) return 0;
  if (smem > optin) {
    *err = cudaErrorInvalidValue;
    return 0;
  }
  *err = cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
  if (*err != cudaSuccess) return 0;
  *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                device);
  if (*err != cudaSuccess) return 0;
  *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                       threads, smem);
  if (*err != cudaSuccess) return 0;
  return std::max(per_sm, 1) * sms;
}

template <typename T>
cudaError_t launch_tiled(const void* x, int64_t sx, const void* emb,
                         int64_t se, void* out, int64_t so, int write_x,
                         int batch, int n_fields, int dim, int rows,
                         int shift, int device, cudaStream_t s) {
  const int itemsize = static_cast<int>(sizeof(T));
  const int n_blocks = (n_fields + 3) / 4;
  const int threads = rows * (n_blocks * (n_blocks + 1) / 2);
  const int n_pairs = n_fields * (n_fields - 1) / 2;
  if ((static_cast<int64_t>(dim) * itemsize) % 16 != 0 ||
      threads > kTileThreads) {
    return cudaErrorInvalidValue;
  }
  const int row_bytes =
      staged_row_bytes(static_cast<int64_t>(n_fields) * dim * itemsize);
  const int64_t buf = std::max(static_cast<int64_t>(rows) * row_bytes,
                          static_cast<int64_t>(round16(
                              static_cast<int64_t>(rows) *
                              (n_pairs + dim) * itemsize)));
  if (2 * buf > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(2 * buf);
  cudaError_t err;
  const int resident =
      resident_blocks(dot_tiled_kernel<T>, threads, smem, device, &err);
  if (err != cudaSuccess) return err;
  const int n_stages = (batch + rows - 1) / rows;
  const dim3 grid(std::min(n_stages, resident));
  dot_tiled_kernel<T><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(emb), se,
      static_cast<T*>(out), so, write_x, batch, n_fields, dim, rows,
      row_bytes, static_cast<int>(buf), shift);
  return cudaGetLastError();
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
      reinterpret_cast<uintptr_t>(emb) % vec != 0 ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n_fields + 3) / 4;
  if (n_pairs > kThreads && (static_cast<int64_t>(dim) * itemsize) % 16 == 0
      && n_blocks * (n_blocks + 1) / 2 <= kTileThreads) {  // tiles of rows
    if (reinterpret_cast<uintptr_t>(out) % 16 != 0) {
      return cudaErrorInvalidValue;
    }
    return dtype == 0
        ? launch_tiled<float>(x, sx, emb, se, out, so, write_x, batch,
                              n_fields, dim, rows_per_block, shift, device, s)
        : launch_tiled<__nv_bfloat16>(x, sx, emb, se, out, so, write_x,
                                      batch, n_fields, dim, rows_per_block,
                                      shift, device, s);
  }
  const dim3 grid((batch + rows_per_block - 1) / rows_per_block);
  const size_t smem = static_cast<size_t>(rows_per_block) *
      ((static_cast<size_t>(n_fields) * dim * itemsize + 15) / 16 * 16);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  if (dtype == 0) {
    dot_interaction_kernel<float><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(x), sx, static_cast<const float*>(emb), se,
        static_cast<float*>(out), so, write_x, batch, n_fields, dim,
        rows_per_block, shift);
  } else {
    dot_interaction_kernel<__nv_bfloat16><<<grid, kThreads, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x), sx,
        static_cast<const __nv_bfloat16*>(emb), se,
        static_cast<__nv_bfloat16*>(out), so, write_x, batch, n_fields, dim,
        rows_per_block, shift);
  }
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_query(const void* x, const void* user, const void* cand,
                         void* out, int n_user, int n_cand, int dim, int rows,
                         int shift, int device, cudaStream_t s) {
  const int itemsize = static_cast<int>(sizeof(T));
  const int n_q = n_user + 1;
  const int threads = rows * ((n_q + 3) / 4);
  const int64_t n_pairs = static_cast<int64_t>(n_user + 2) * (n_user + 1) / 2;
  if (threads > kTileThreads) return cudaErrorInvalidValue;
  const int row_bytes =
      staged_row_bytes(static_cast<int64_t>(dim) * itemsize);
  const int64_t q_bytes =
      round16(static_cast<int64_t>(n_q) * dim * itemsize);
  const int64_t smem64 = q_bytes + 2 * static_cast<int64_t>(rows) * row_bytes
      + round16(static_cast<int64_t>(rows) * (n_pairs + dim) * itemsize);
  if (smem64 > INT32_MAX) return cudaErrorInvalidValue;
  const int smem = static_cast<int>(smem64);
  cudaError_t err;
  const int resident =
      resident_blocks(dot_query_kernel<T, V>, threads, smem, device, &err);
  if (err != cudaSuccess) return err;
  const int n_stages = (n_cand + rows - 1) / rows;
  const dim3 grid(std::min(n_stages, resident));
  dot_query_kernel<T, V><<<grid, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(user),
      static_cast<const T*>(cand), static_cast<T*>(out), n_user, n_cand, dim,
      rows, row_bytes, static_cast<int>(q_bytes), shift);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (z and output alike). z (B, F, D)
// contiguous -> out (B, P). Tiles of rows where P > 128, D's bytes are a
// multiple of 16 and the 4 x 4 field blocks number at most 256 (then out
// must be 16-byte aligned); one row at a time otherwise, as
// kernels/dot_interaction.dot_geometry picks. The caller picks
// rows_per_block there: a tile's rows, or the rows a one-row block
// stages, which (each row's F x D values rounded up to 16 bytes) fit in
// the 48 KB of shared memory a block gets without opting in. vec is the
// copy unit in bytes (16, 4 or 2): it divides D's bytes and z's address.
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

// The query entry: x (D), user (U, D) and cand (N, D), all contiguous, ->
// out (N, P + D) with P = F(F-1)/2, F = U + 2: row n is dot_features' row
// for x and emb = [user | cand[n]]. rows: candidate rows a tile
// (kernels/dot_interaction.query_geometry); vec the copy unit of a
// candidate row (it divides D's bytes and cand's address); out 16-byte
// aligned.
extern "C" int dot_features_query_forward(const void* x, const void* user,
                                          const void* cand, int dtype,
                                          void* out, int n_user, int n_cand,
                                          int dim, int rows, int device,
                                          void* stream, int vec) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n_cand == 0) return cudaSuccess;
  const int shift = vec == 16 ? 4 : vec == 4 ? 2 : vec == 2 ? 1 : -1;
  const int itemsize = dtype == 0 ? 4 : 2;
  if (shift < 0 || vec < itemsize || rows < 1 || n_user < 0 || dim < 1 ||
      (static_cast<int64_t>(dim) * itemsize) % vec != 0 ||
      reinterpret_cast<uintptr_t>(cand) % vec != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0 ||
      (dtype != 0 && dtype != 1)) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = (static_cast<int64_t>(dim) * itemsize) % 16 == 0;
  if (dtype == 0) {
    return wide ? launch_query<float, 4>(x, user, cand, out, n_user, n_cand,
                                         dim, rows, shift, device, s)
                : launch_query<float, 1>(x, user, cand, out, n_user, n_cand,
                                         dim, rows, shift, device, s);
  }
  return wide ? launch_query<__nv_bfloat16, 8>(x, user, cand, out, n_user,
                                               n_cand, dim, rows, shift,
                                               device, s)
              : launch_query<__nv_bfloat16, 1>(x, user, cand, out, n_user,
                                               n_cand, dim, rows, shift,
                                               device, s);
}

extern "C" const char* dot_interaction_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
