// The backward scatter's prep (the bag sum's transpose: the sorted runs that
// csrc/ct_scatter.cu walks) on the card, for Hopper, sm_90a.
//
// Replaces no Pallas kernel. The reference builds these runs with plain
// array code that XLA compiles (src/repro/kernels/embedding_bag.py:
// ct_scatter_bag_pallas's entry enumeration and scatter_run_metadata). On
// the card the port ran the same steps op by op in PyTorch
// (kernels/embedding_bag.py: scatter_entries, then scatter_run_metadata):
// ~20 passes over every entry, int64 temporaries of 8 bytes an entry, a
// stable argsort of all 32 key bits with int64 indices, two gathers through
// its permutation and a second full sort that only compacts the run starts.
// This file does the same work in three device steps; CPU and meta tensors
// keep the op-by-op prep.
//
// What it computes, for the forward's (NB, L) ids padded with -1, entries
// enumerated j-major (e = j * NB + b, the order in which the reference's scan
// over L adds them):
//   1. label (prep_label, written here): for entry e of bag b,
//          valid = raw >= 0
//          row   = (raw + off[b % F]) * k_max + col(b)   (col(b) =
//                  wang_hash(b) % k_max, 0 when k_max == 1)
//          dest  = valid && (my < 0 || bank[row] == my) ? slot[row] : n_rows
//          bag   = b
//      with any dest outside [0, n_rows] sent to n_rows (a remap's slots lie
//      in [0, n_rows), so the sort's key bits below hold every key);
//      (csr and identity layouts label op by op and enter at step 2);
//   2. one stable key-value radix sort of (dest, bag) by dest: CUB's
//      DeviceRadixSort::SortPairs over the low end_bit bits (25 for the
//      18.9 M rows of updlrm-paper; 32 for labels from elsewhere), ping-pong
//      through two buffers of each: sd and bag_sorted, no permutation;
//   3. run table (prep_count, prep_scan, prep_table, written here), a
//      two-phase scan of the new-run flags over sd:
//          live[i]    = sd[i] < n_rows                  (a prefix of n_valid)
//          new_run[i] = live[i] && sd[i] != (i ? sd[i - 1] : -1)
//          run_of[i]  = max(inclusive prefix of new_run at i - 1, 0)
//          run r < n_run: run_starts[r] = its first i, run_slot[r] = sd[i]
//          dead r >= n_run: run_starts[r] = n_valid (r <= E), run_slot[r] =
//              min(sd[min(n_valid, E - 1)], n_rows - 1)
//      bit for bit scatter_run_metadata's arrays with n_runs_pad = E,
//      dead tail included (the scatter reads run_of at its span ends).
// No atomics and no host sync: n_run and n_valid stay on the device, every
// grid comes from E, and CUB's storage is sized on the host from E alone.
//
// What bounds it on the card: bytes. At paper-train's shape (65,536 samples
// x 8 fields x 256: E = 134,217,728 entries) the prep must read the ids
// (0.537 GB) and the slot of each distinct row, and write bag_sorted,
// run_of, run_starts and run_slot (2.147 GB): 2.68 GB, 0.80 ms at 3.35 TB/s.
// A radix sort cannot reach that: each of its passes reads and writes keys
// and values, four passes for 25 bits at CUB's 8-bit digits.
//
// What the design does about it: every array is int32 and written once per
// step; the label kernel reads (32 bags x 32 entries) tiles of ids row by
// row, coalesced, and writes their transpose through shared memory, each
// thread resolving four entries with their slot loads in flight together;
// the sort is one key-value sort on the bits the keys need; the run table
// reads sd twice (counts, then the table), each tile of 2,048 entries with
// coalesced block loads, and writes its run starts compacted in shared
// memory and then copied out in order.
// Measured at that shape (tools/scatter_prep_probe.py, NVIDIA H100 80GB
// HBM3, 700 W, CUDA events, median): 5.93 ms, 7.3x the byte bound (the
// sort 3.84, the label 1.08, the run table 1.06), against 44.05 ms for the
// op-by-op prep; its peak of device memory 3.77 GB against 9.42.
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include <cub/block/block_discontinuity.cuh>
#include <cub/block/block_load.cuh>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/block/block_store.cuh>
#include <cub/device/device_radix_sort.cuh>

namespace {

// label: a block transposes a (kTile bags x kTile entries) tile of ids
constexpr int kTile = 32;
constexpr int kTileRows = 8;                   // threadIdx.y extent
constexpr int kPer = kTile / kTileRows;        // entries a thread resolves
// run table: a block owns kRunTile consecutive sorted entries
constexpr int kRunThreads = 256;
constexpr int kRunItems = 8;
constexpr int kRunTile = kRunThreads * kRunItems;
constexpr int kScanThreads = 1024;

__device__ __forceinline__ unsigned wang_hash(unsigned x) {
  x = (x ^ 61u) ^ (x >> 16);
  x *= 9u;
  x ^= x >> 4;
  x *= 0x27d4eb2du;
  return x ^ (x >> 15);
}

// Step 1. grid (ceil(NB / kTile), ceil(L / kTile)), block (kTile, kTileRows).
__global__ void __launch_bounds__(kTile * kTileRows)
prep_label(const int* __restrict__ idx, const int* __restrict__ bank,
           const int* __restrict__ slot, const int* __restrict__ off,
           int n_fields, int my, int n_rows, int k_max, int nb,
           int bag_len, int* __restrict__ dest, int* __restrict__ bag_of) {
  __shared__ int tile[kTile][kTile + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int b0 = blockIdx.x * kTile, j0 = blockIdx.y * kTile;
  // read: bag b0 + r's entries j0 + tx, along the rows of idx
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int r = ty + u * kTileRows, b = b0 + r, j = j0 + tx;
    tile[r][tx] = b < nb && j < bag_len
                      ? __ldg(idx + static_cast<int64_t>(b) * bag_len + j)
                      : -1;
  }
  __syncthreads();
  // write: entry j0 + ty + u * kTileRows of bag b0 + tx, along e
  const int b = b0 + tx;
  if (b >= nb) return;
  const int64_t field_off = __ldg(off + b % n_fields);
  const int64_t col =
      k_max > 1 ? wang_hash(static_cast<unsigned>(b)) %
                      static_cast<unsigned>(k_max)
                : 0;
  bool valid[kPer];
  int64_t row[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int raw = tile[tx][ty + u * kTileRows];
    valid[u] = raw >= 0;
    row[u] = (raw + field_off) * k_max + col;
  }
  int s[kPer], owner[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    s[u] = valid[u] ? __ldg(slot + row[u]) : n_rows;
    owner[u] = valid[u] && my >= 0 ? __ldg(bank + row[u]) : my;
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int j = j0 + ty + u * kTileRows;
    if (j >= bag_len) continue;
    int d = valid[u] && (my < 0 || owner[u] == my) ? s[u] : n_rows;
    if (static_cast<unsigned>(d) > static_cast<unsigned>(n_rows)) d = n_rows;
    const int64_t e = static_cast<int64_t>(j) * nb + b;
    dest[e] = d;
    bag_of[e] = b;
  }
}

struct NotEqual {
  __device__ __forceinline__ bool operator()(const int& a,
                                             const int& b) const {
    return a != b;
  }
};

using RunLoad = cub::BlockLoad<int, kRunThreads, kRunItems,
                               cub::BLOCK_LOAD_WARP_TRANSPOSE>;
using RunHeads = cub::BlockDiscontinuity<int, kRunThreads>;
using RunScan = cub::BlockScan<int, kRunThreads>;
using RunSum = cub::BlockReduce<int, kRunThreads>;
using RunStore = cub::BlockStore<int, kRunThreads, kRunItems,
                                 cub::BLOCK_STORE_WARP_TRANSPOSE>;

union RunTemp {
  RunLoad::TempStorage load;
  RunHeads::TempStorage heads;
  RunScan::TempStorage scan;
  RunSum::TempStorage sum;
  RunStore::TempStorage store;
};

// A tile's sorted entries, blocked (thread t holds entries base + t *
// kRunItems + u), which of them start a run, and how many are live. Ends
// with the block synchronised, so `tmp` may be reused.
__device__ __forceinline__ void tile_flags(const int* __restrict__ sd,
                                           int n_rows, int base, int valid,
                                           RunTemp& tmp,
                                           int (&key)[kRunItems],
                                           int (&flag)[kRunItems],
                                           int& live) {
  RunLoad(tmp.load).Load(sd + base, key, valid, INT_MAX);
  __syncthreads();
  int head[kRunItems];
  const int pred = base > 0 ? __ldg(sd + base - 1) : -1;
  RunHeads(tmp.heads).FlagHeads(head, key, NotEqual(), pred);
  __syncthreads();
  live = 0;
  const int first = threadIdx.x * kRunItems;
#pragma unroll
  for (int u = 0; u < kRunItems; ++u) {
    const bool l = first + u < valid && key[u] < n_rows;
    flag[u] = l && head[u];
    live += l;
  }
}

// Step 3a: each tile's run starts and live entries, packed (runs | live <<
// 16; each is at most kRunTile).
__global__ void __launch_bounds__(kRunThreads)
prep_count(const int* __restrict__ sd, int n, int n_rows,
           int* __restrict__ counts) {
  __shared__ RunTemp tmp;
  const int base = blockIdx.x * kRunTile;
  const int valid = min(kRunTile, n - base);
  int key[kRunItems], flag[kRunItems], live;
  tile_flags(sd, n_rows, base, valid, tmp, key, flag, live);
  int runs = 0;
#pragma unroll
  for (int u = 0; u < kRunItems; ++u) runs += flag[u];
  const int total = RunSum(tmp.sum).Sum(runs | (live << 16));
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// Step 3b, one block: each tile's first run (an exclusive scan of the
// counts), n_run and n_valid.
__global__ void __launch_bounds__(kScanThreads)
prep_scan(const int* __restrict__ counts, int tiles,
          int* __restrict__ first_run, int* __restrict__ n_run,
          int* __restrict__ n_valid) {
  using Scan = cub::BlockScan<int, kScanThreads>;
  using Sum = cub::BlockReduce<int, kScanThreads>;
  __shared__ union {
    Scan::TempStorage scan;
    Sum::TempStorage sum;
  } tmp;
  const int per = (tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = min(static_cast<int>(threadIdx.x) * per, tiles);
  const int t1 = min(t0 + per, tiles);
  int runs = 0, live = 0;
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    const int c = counts[t];
    runs += c & 0xffff;
    live += c >> 16;
  }
  int before, total;
  Scan(tmp.scan).ExclusiveSum(runs, before, total);
  __syncthreads();
  const int lives = Sum(tmp.sum).Sum(live);
#pragma unroll 8
  for (int t = t0; t < t1; ++t) {
    first_run[t] = before;
    before += counts[t] & 0xffff;
  }
  if (threadIdx.x == 0) {
    *n_run = total;
    *n_valid = lives;
  }
}

// Step 3c: run_of of each entry, each run's start and slot (compacted in
// shared memory, then copied out in run order), and the dead tail.
__global__ void __launch_bounds__(kRunThreads)
prep_table(const int* __restrict__ sd, int n, int n_rows,
           const int* __restrict__ first_run,
           const int* __restrict__ n_run_p, const int* __restrict__ n_valid_p,
           int* __restrict__ run_of, int* __restrict__ run_starts,
           int* __restrict__ run_slot) {
  __shared__ RunTemp tmp;
  __shared__ int s_start[kRunTile], s_slot[kRunTile];
  const int base = blockIdx.x * kRunTile;
  const int valid = min(kRunTile, n - base);
  int key[kRunItems], flag[kRunItems], live;
  tile_flags(sd, n_rows, base, valid, tmp, key, flag, live);
  int runs = 0;
#pragma unroll
  for (int u = 0; u < kRunItems; ++u) runs += flag[u];
  int before, tile_runs;
  RunScan(tmp.scan).ExclusiveSum(runs, before, tile_runs);
  __syncthreads();
  const int off = first_run[blockIdx.x];
  const int first = base + threadIdx.x * kRunItems;
  int p = off + before;                 // runs started before this item
  int ro[kRunItems];
#pragma unroll
  for (int u = 0; u < kRunItems; ++u) {
    p += flag[u];
    ro[u] = max(p - 1, 0);
    if (flag[u]) {
      s_start[p - 1 - off] = first + u;
      s_slot[p - 1 - off] = min(key[u], n_rows - 1);
    }
  }
  RunStore(tmp.store).Store(run_of + base, ro, valid);
  __syncthreads();
  for (int r = threadIdx.x; r < tile_runs; r += kRunThreads) {
    run_starts[off + r] = s_start[r];
    run_slot[off + r] = s_slot[r];
  }
  const int nr = *n_run_p, nv = *n_valid_p;
  if (base + valid > nr) {
    const int dead = min(__ldg(sd + min(nv, n - 1)), n_rows - 1);
    for (int i = max(base, nr) + threadIdx.x; i < base + valid;
         i += kRunThreads) {
      run_starts[i] = nv;
      run_slot[i] = dead;
    }
  }
  if (base + valid == n && threadIdx.x == 0) run_starts[n] = nv;
}

size_t round_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

// The scratch of n entries: the tiles' counts and first runs, n_valid, then
// CUB's temporary storage.
struct Layout {
  size_t counts, first_run, n_valid, sort, total;
};

cudaError_t layout(int n, int end_bit, Layout* l) {
  cub::DoubleBuffer<int> keys(nullptr, nullptr), vals(nullptr, nullptr);
  size_t sort_bytes = 0;
  cudaError_t err = cub::DeviceRadixSort::SortPairs(
      nullptr, sort_bytes, keys, vals, n, 0, end_bit);
  if (err != cudaSuccess) return err;
  const size_t tiles = (static_cast<size_t>(n) + kRunTile - 1) / kRunTile;
  l->counts = 0;
  l->first_run = round_up(tiles * sizeof(int));
  l->n_valid = l->first_run + round_up(tiles * sizeof(int));
  l->sort = l->n_valid + 256;
  l->total = l->sort + sort_bytes;
  return cudaSuccess;
}

}  // namespace

// Bytes of scratch that scatter_prep_runs needs for n entries sorted on
// bits [0, end_bit): written to *bytes (an int64), from n and end_bit alone.
extern "C" int scatter_prep_scratch(int n, int end_bit, void* bytes) {
  cudaGetLastError();                         // clear any stale error
  if (n < 1 || end_bit < 1 || end_bit > 32) return cudaErrorInvalidValue;
  Layout l;
  cudaError_t err = layout(n, end_bit, &l);
  if (err != cudaSuccess) return err;
  *static_cast<int64_t*>(bytes) = static_cast<int64_t>(l.total);
  return cudaSuccess;
}

// Step 1: dest and bag (nb * bag_len,) int32 from idx (nb, bag_len) int32;
// bank and slot (V * k_max,), off (n_fields,), all int32.
extern "C" int scatter_prep_label(const void* idx, const void* bank,
                                  const void* slot, const void* off,
                                  int n_fields, int my, int n_rows, int k_max,
                                  int nb, int bag_len, void* dest, void* bag,
                                  int device, void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nb == 0 || bag_len == 0) return cudaSuccess;
  if (n_fields < 1 || k_max < 1 || n_rows < 0) return cudaErrorInvalidValue;
  const dim3 grid((nb + kTile - 1) / kTile, (bag_len + kTile - 1) / kTile);
  prep_label<<<grid, dim3(kTile, kTileRows), 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int*>(bank),
      static_cast<const int*>(slot), static_cast<const int*>(off), n_fields,
      my, n_rows, k_max, nb, bag_len, static_cast<int*>(dest),
      static_cast<int*>(bag));
  return cudaGetLastError();
}

// Steps 2 and 3 over n >= 1 labelled entries: keys/vals hold (dest, bag) and
// keys_alt/vals_alt are buffers of the same size; the sort ping-pongs
// through them and *selector (a host int) says which pair holds the sorted
// (sd, bag_sorted) after it: 0 keys/vals, 1 the alternates. Every dest must
// lie in [0, 2^end_bit) when end_bit < 32 (any int32 when it is 32). Writes
// run_of (n,), run_starts (n + 1,), run_slot (n,) and n_run (1,).
extern "C" int scatter_prep_runs(void* keys, void* keys_alt, void* vals,
                                 void* vals_alt, int n, int n_rows,
                                 int end_bit, void* scratch,
                                 int64_t scratch_bytes, void* run_of,
                                 void* run_starts, void* run_slot,
                                 void* n_run, void* selector, int device,
                                 void* stream) {
  cudaGetLastError();                         // clear any stale error
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (n < 1 || end_bit < 1 || end_bit > 32) return cudaErrorInvalidValue;
  Layout l;
  if ((err = layout(n, end_bit, &l)) != cudaSuccess) return err;
  if (static_cast<int64_t>(l.total) > scratch_bytes)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* base = static_cast<char*>(scratch);
  cub::DoubleBuffer<int> k(static_cast<int*>(keys),
                           static_cast<int*>(keys_alt));
  cub::DoubleBuffer<int> v(static_cast<int*>(vals),
                           static_cast<int*>(vals_alt));
  size_t sort_bytes = l.total - l.sort;
  err = cub::DeviceRadixSort::SortPairs(base + l.sort, sort_bytes, k, v, n, 0,
                                        end_bit, s);
  if (err != cudaSuccess) return err;
  if (k.selector != v.selector) return cudaErrorUnknown;
  *static_cast<int*>(selector) = k.selector;
  const int* sd = k.Current();
  int* counts = reinterpret_cast<int*>(base + l.counts);
  int* first_run = reinterpret_cast<int*>(base + l.first_run);
  int* n_valid = reinterpret_cast<int*>(base + l.n_valid);
  const int tiles = (n + kRunTile - 1) / kRunTile;
  prep_count<<<tiles, kRunThreads, 0, s>>>(sd, n, n_rows, counts);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  prep_scan<<<1, kScanThreads, 0, s>>>(counts, tiles, first_run,
                                         static_cast<int*>(n_run), n_valid);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  prep_table<<<tiles, kRunThreads, 0, s>>>(
      sd, n, n_rows, first_run, static_cast<const int*>(n_run), n_valid,
      static_cast<int*>(run_of), static_cast<int*>(run_starts),
      static_cast<int*>(run_slot));
  return cudaGetLastError();
}

extern "C" const char* scatter_prep_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
