// bincount: the global histogram of an (n,) int32 id vector over
// [0, n_buckets); ids outside that range, negative ones included, are
// ignored.  Counts are int32 and exact.
//
// Replaces the Pallas kernel src/repro/kernels/bincount.py::bincount (body
// _bincount_kernel), whose one-hot comparison matrix summed over a sequential
// grid suits the TPU's vector units, not a GPU.
//
// What bounds it on an H100: bytes, n * 4 read and V * 4 written (n = 2^24
// ids into 2048 buckets: 67 MB, 0.020 ms at 3.35 TB/s), as long as the
// atomics keep up.  Reaching the memory rate takes about 20 KB of loads in
// flight an SM (3.35 TB/s times a DRAM latency near 0.8 us, over 132 SMs).
//
// Design:
// - Loads: 16-byte streaming loads (__ldcs of int4), kUnroll = 4 of them in
//   flight a thread before any is counted: 512 threads x 2 blocks x 64 bytes
//   = 64 KB in flight an SM.  ids may be a view at any 4-byte offset: the ids
//   before the first 16-byte boundary (at most 3) and the last n % 4 after
//   the vectors are counted one by one.
// - Grid: two blocks of 512 threads an SM (one where the histograms need
//   more than half the SM's shared memory), never more than the ids need;
//   each block strides over the vectors.
// - Histograms: each block counts into shared memory with shared atomics,
//   in R replicas interleaved bucket by bucket (word id * R + r, r = thread
//   & (R - 1)): the lanes of a warp that hit one bucket add to R words in R
//   banks, which cuts same-address serialisation on skewed ids R-fold.  R is
//   the largest power of two up to 8 whose histograms still fit two blocks
//   an SM in kSmemPerSm (R = 8 at 2048 buckets: 64 KB a block), else 1.
// - The flush: each block sums a bucket's replicas and adds the sum into the
//   output with one global atomic, for non-zero buckets only.
// - Above kSmemBuckets buckets one histogram does not fit shared memory and
//   every id goes by a global atomic into the output, with the same loads.
// - The zeroing is folded into the count: each block zeroes a slice of the
//   output first, and the blocks wait at one grid barrier (a cooperative
//   launch, so every block is resident) before any add into it.  A
//   cudaMemsetAsync ahead of the count cost more than the 2 us that a
//   separate launch may cost here (back to back on an H100, the count
//   alone against memset + count).  A static device buffer (a zeroed
//   counter for a last-block reduction) is ruled out, since two streams may
//   count at once; the cooperative launch needs none.
//
// Atomic adds commute, so the result does not depend on their order.
//
// Measured (chip_smoke.py, phase ssm-timings, two runs; NVIDIA H100 80GB
// HBM3, 700.00 W) at 2^24 ids into 2048 buckets: 0.034 / 0.033 ms back to
// back (20 calls between two events), 0.069 / 0.049 ms one call per event
// pair (the kernel before this design: 0.079 / 0.064); torch.bincount
// 0.303 / 0.268 ms.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;                        // int4 loads in flight
constexpr int kBlocksPerSm = 2;
constexpr int kMaxReplicas = 8;
constexpr long long kSmemBuckets = 48 * 1024;     // 192 KB of histogram
constexpr long long kSmemPerSm = 200 * 1024;      // budget for one SM's blocks

struct SmemHist {
  int* hist;
  unsigned V;
  int log_r;
  int rep;
  __device__ __forceinline__ void add(int id) const {
    if ((unsigned)id < V) atomicAdd(&hist[(id << log_r) + rep], 1);
  }
};

struct GlobalHist {
  int* out;
  long long V;
  __device__ __forceinline__ void add(int id) const {
    if (id >= 0 && id < V) atomicAdd(&out[id], 1);
  }
};

// Every id of ids[0, n) once into h, across the grid.
template <class H>
__device__ __forceinline__ void count_ids(const int* __restrict__ ids,
                                          long long n, const H& h) {
  const long long mis = (long long)((16 - ((size_t)ids & 15)) & 15) / 4;
  const long long head = mis < n ? mis : n;
  const int4* body = reinterpret_cast<const int4*>(ids + head);
  const long long nvec = (n - head) / 4;
  const long long tail = head + nvec * 4;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid < head) h.add(ids[tid]);
  if (tid < n - tail) h.add(ids[tail + tid]);
  const long long step = (long long)gridDim.x * blockDim.x * kUnroll;
  for (long long base = (long long)blockIdx.x * blockDim.x * kUnroll
                        + threadIdx.x;
       base < nvec; base += step) {
    int4 q[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + (long long)u * blockDim.x;
      q[u] = i < nvec ? __ldcs(body + i) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h.add(q[u].x);
      h.add(q[u].y);
      h.add(q[u].z);
      h.add(q[u].w);
    }
  }
}

// out[0, V) = 0, a slice a block
__device__ __forceinline__ void zero_slice(int* __restrict__ out,
                                           long long V) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < V;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = 0;
}

__global__ void __launch_bounds__(kThreads)
count_smem(const int* __restrict__ ids, long long n, int V, int log_r,
           int* __restrict__ out) {
  extern __shared__ int hist[];
  zero_slice(out, V);
  const int words = V << log_r;
  for (int i = threadIdx.x; i < words; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  const int R = 1 << log_r;
  count_ids(ids, n, SmemHist{hist, (unsigned)V, log_r,
                             (int)(threadIdx.x & (R - 1))});
  cg::this_grid().sync();             // out is zero everywhere
  for (int b = threadIdx.x; b < V; b += blockDim.x) {
    int c = 0;
    for (int r = 0; r < R; ++r) c += hist[(b << log_r) + r];
    if (c) atomicAdd(&out[b], c);
  }
}

__global__ void __launch_bounds__(kThreads)
count_global(const int* __restrict__ ids, long long n, long long V,
             int* __restrict__ out) {
  zero_slice(out, V);
  cg::this_grid().sync();
  count_ids(ids, n, GlobalHist{out, V});
}

// One cooperative launch of kernel on as many blocks as the ids need, at
// most kBlocksPerSm an SM and never more than fit the card at once.
cudaError_t launch(const void* kernel, long long needed, size_t smem,
                   void** args, cudaStream_t s) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm > kBlocksPerSm) per_sm = kBlocksPerSm;
  const long long cap = (long long)per_sm * sms;
  const long long blocks = needed < 1 ? 1 : (needed < cap ? needed : cap);
  return cudaLaunchCooperativeKernel(kernel, dim3((unsigned)blocks),
                                     dim3(kThreads), args, smem, s);
}

}  // namespace

extern "C" {

// ids: (n,) int32, 4-byte aligned; out: (V,) int32, written whole.
// Requires n >= 1 and V >= 1.  Returns a cudaError_t, 0 on success.
int repro_bincount(const int* ids, long long n, long long V, int* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long per_block = (long long)kThreads * kUnroll * 4;
  const long long needed = (n + per_block - 1) / per_block;
  if (V <= kSmemBuckets) {
    int log_r = 0;
    while ((1 << (log_r + 1)) <= kMaxReplicas
           && kBlocksPerSm * V * 4 * (2LL << log_r) <= kSmemPerSm)
      ++log_r;
    const size_t smem = (size_t)V * 4 << log_r;
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          count_smem, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    int v = (int)V;
    void* args[] = {&ids, &n, &v, &log_r, &out};
    return launch((const void*)count_smem, needed, smem, args, s);
  }
  void* args[] = {&ids, &n, &V, &out};
  return launch((const void*)count_global, needed, 0, args, s);
}

}  // extern "C"
