// bincount_tiles: per-tile bucket histogram C, cross-tile exclusive prefix P
// and in-tile exclusive bucket offsets F of a (T, tile_n) int32 id matrix.
//
// Replaces the Pallas kernel src/repro/kernels/bincount.py::bincount_tiles
// (body _bincount_tiles_kernel).  Contract: ids < 0 or >= V are ignored;
// outputs are three (T, V) int32 matrices, exact.
//
// What bounds it on an H100: bytes.  The function reads T*tile_n*4 bytes and
// writes 3*T*V*4; the counting itself is one shared-memory atomic per id.
//
// Design:
// - The TPU kernel gets P from a carry in VMEM that works only because its
//   grid runs in order.  Blocks here run in no order, so P is a separate
//   column scan over T in three short passes: per-chunk column sums, a scan
//   of those sums down the chunks, and a pass that writes each chunk's
//   running prefix.  It reads C twice more (about T*V*8 bytes) but needs no
//   inter-block waiting, which a decoupled look-back would, and every pass
//   is a coalesced sweep across the bucket axis.
// - Counting: one block per tile.  For V up to kSmemBuckets the histogram is
//   block-private in dynamic shared memory (atomicAdd there, no one-hot);
//   the block then writes C, scans the histogram in place and writes F.
//   Above that V (kernel_fits admits V up to about 2^21) the histogram
//   cannot fit 227 KB of shared memory: the counts go by global atomics into
//   a zeroed C and a row-scan kernel writes F.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;
constexpr long long kChunkRows = 64;     // rows of C per chunk of the column scan
constexpr long long kSmemBuckets = 48 * 1024;   // 192 KB of shared histogram

// Exclusive scan of one int per thread across the block (blockDim.x a
// multiple of 32, at most 1024).  Returns the thread's exclusive prefix and
// stores the block total in *total, readable after the call returns.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? warp_sums[lane] : 0;
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  int out = warp_sums[warp] + incl - v;
  __syncthreads();
  return out;
}

// One block per tile: shared histogram -> C row, in-place exclusive scan -> F row.
__global__ void count_tiles_smem(const int* __restrict__ tiles, long long tile_n,
                                 int V, int* __restrict__ C, int* __restrict__ F) {
  extern __shared__ int hist[];
  __shared__ int warp_sums[32];
  __shared__ int total;
  const long long t = blockIdx.x;
  for (int b = threadIdx.x; b < V; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const int* row = tiles + t * tile_n;
  for (long long i = threadIdx.x; i < tile_n; i += blockDim.x) {
    const int id = row[i];
    if (id >= 0 && id < V) atomicAdd(&hist[id], 1);
  }
  __syncthreads();
  int* c_row = C + t * V;
  for (int b = threadIdx.x; b < V; b += blockDim.x) c_row[b] = hist[b];
  // Thread k owns buckets [k*per, (k+1)*per): local sums, one block scan,
  // then each thread rewrites its buckets with their exclusive offsets.
  const int per = (V + blockDim.x - 1) / blockDim.x;
  const int lo = min(V, (int)threadIdx.x * per);
  const int hi = min(V, lo + per);
  int s = 0;
  for (int b = lo; b < hi; ++b) s += hist[b];
  int run = block_exclusive_scan(s, warp_sums, &total);
  for (int b = lo; b < hi; ++b) {
    const int c = hist[b];
    hist[b] = run;
    run += c;
  }
  __syncthreads();
  int* f_row = F + t * V;
  for (int b = threadIdx.x; b < V; b += blockDim.x) f_row[b] = hist[b];
}

// Large-V counting: global atomics into a zeroed C.
__global__ void count_tiles_global(const int* __restrict__ tiles, long long tile_n,
                                   long long V, int* __restrict__ C) {
  const long long t = blockIdx.x;
  const int* row = tiles + t * tile_n;
  int* c_row = C + t * V;
  for (long long i = threadIdx.x; i < tile_n; i += blockDim.x) {
    const int id = row[i];
    if (id >= 0 && id < V) atomicAdd(&c_row[id], 1);
  }
}

// Large-V in-tile offsets: one block per row, exclusive scan over V in
// block-wide steps with a running carry.
__global__ void row_exclusive_scan(const int* __restrict__ C, long long V,
                                   int* __restrict__ F) {
  __shared__ int warp_sums[32];
  __shared__ int total;
  const long long t = blockIdx.x;
  const int* c_row = C + t * V;
  int* f_row = F + t * V;
  int carry = 0;
  for (long long base = 0; base < V; base += blockDim.x) {
    const long long b = base + threadIdx.x;
    const int v = b < V ? c_row[b] : 0;
    const int ex = block_exclusive_scan(v, warp_sums, &total);
    if (b < V) f_row[b] = carry + ex;
    carry += total;
  }
}

// Column scan over T, pass 1: S[c, v] = sum of C[t, v] over the rows t of chunk c.
__global__ void chunk_column_sums(const int* __restrict__ C, long long T, long long V,
                                  long long n_chunks, int* __restrict__ S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_chunks * V) return;
  const long long c = idx / V, v = idx % V;
  const long long t1 = min(T, (c + 1) * kChunkRows);
  int s = 0;
  for (long long t = c * kChunkRows; t < t1; ++t) s += C[t * V + v];
  S[idx] = s;
}

// Pass 2: exclusive scan of S down the chunks, one thread per column.
__global__ void chunk_scan(int* __restrict__ S, long long V, long long n_chunks) {
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= V) return;
  int run = 0;
  for (long long c = 0; c < n_chunks; ++c) {
    const int s = S[c * V + v];
    S[c * V + v] = run;
    run += s;
  }
}

// Pass 3: P[t, v] = S[c, v] + the counts of the earlier rows of chunk c.
__global__ void chunk_prefix(const int* __restrict__ C, const int* __restrict__ S,
                             long long T, long long V, long long n_chunks,
                             int* __restrict__ P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n_chunks * V) return;
  const long long c = idx / V, v = idx % V;
  const long long t1 = min(T, (c + 1) * kChunkRows);
  int run = S[idx];
  for (long long t = c * kChunkRows; t < t1; ++t) {
    P[t * V + v] = run;
    run += C[t * V + v];
  }
}

inline unsigned grid_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

}  // namespace

extern "C" {

// int32 elements of the scratch buffer repro_bincount_tiles needs.
long long repro_bincount_tiles_scratch_elems(long long T, long long V) {
  return ((T + kChunkRows - 1) / kChunkRows) * V;
}

// tiles: (T, tile_n) int32; C, P, F: (T, V) int32; scratch: see above.
// Requires T >= 1 and V >= 1.  Returns a cudaError_t, 0 on success.
int repro_bincount_tiles(const int* tiles, long long T, long long tile_n, long long V,
                         int* C, int* P, int* F, int* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (V <= kSmemBuckets) {
    const size_t smem = (size_t)V * sizeof(int);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(count_tiles_smem,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    count_tiles_smem<<<(unsigned)T, kThreads, smem, s>>>(tiles, tile_n, (int)V, C, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  } else {
    err = cudaMemsetAsync(C, 0, (size_t)T * V * sizeof(int), s);
    if (err != cudaSuccess) return err;
    count_tiles_global<<<(unsigned)T, kThreads, 0, s>>>(tiles, tile_n, V, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    row_exclusive_scan<<<(unsigned)T, kScanThreads, 0, s>>>(C, V, F);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const long long n_chunks = (T + kChunkRows - 1) / kChunkRows;
  chunk_column_sums<<<grid_for(n_chunks * V, kThreads), kThreads, 0, s>>>(
      C, T, V, n_chunks, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_scan<<<grid_for(V, kThreads), kThreads, 0, s>>>(scratch, V, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_prefix<<<grid_for(n_chunks * V, kThreads), kThreads, 0, s>>>(
      C, scratch, T, V, n_chunks, P);
  return cudaGetLastError();
}

}  // extern "C"
