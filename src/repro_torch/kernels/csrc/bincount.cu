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
// atomics keep up.
//
// Design: the block-private shared-memory histogram of bincount_tiles.cu.
// A grid of a few blocks per SM strides over the ids, each block counting
// into its own histogram with shared-memory atomics, then adding its
// non-zero counts into the zeroed output with one global atomic per bucket.
// Above kSmemBuckets buckets the histogram does not fit shared memory and
// every id goes by a global atomic.  Atomic adds commute, so the result does
// not depend on their order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr long long kSmemBuckets = 48 * 1024;     // 192 KB of histogram
constexpr long long kSmemPerSm = 200 * 1024;      // budget for the blocks of one SM

__global__ void __launch_bounds__(kThreads)
count_smem(const int* __restrict__ ids, long long n, int V, int* __restrict__ out) {
  extern __shared__ int hist[];
  for (int b = threadIdx.x; b < V; b += blockDim.x) hist[b] = 0;
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int id = ids[i];
    if (id >= 0 && id < V) atomicAdd(&hist[id], 1);
  }
  __syncthreads();
  for (int b = threadIdx.x; b < V; b += blockDim.x) {
    const int c = hist[b];
    if (c) atomicAdd(&out[b], c);
  }
}

__global__ void __launch_bounds__(kThreads)
count_global(const int* __restrict__ ids, long long n, long long V,
             int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const int id = ids[i];
    if (id >= 0 && id < V) atomicAdd(&out[id], 1);
  }
}

}  // namespace

extern "C" {

// ids: (n,) int32; out: (V,) int32.  Requires n >= 1 and V >= 1.  Returns a
// cudaError_t, 0 on success.
int repro_bincount(const int* ids, long long n, long long V, int* out,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, (size_t)V * sizeof(int), s);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long needed = (n + kThreads - 1) / kThreads;
  if (V <= kSmemBuckets) {
    const size_t smem = (size_t)V * sizeof(int);
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(count_smem,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    // at most two blocks of 1024 threads fit an SM; fewer when the
    // histograms outgrow its shared memory
    const long long per_sm = smem * 2 <= (size_t)kSmemPerSm ? 2 : 1;
    const long long blocks = needed < per_sm * sms ? needed : per_sm * sms;
    count_smem<<<(unsigned)blocks, kThreads, smem, s>>>(ids, n, (int)V, out);
  } else {
    const long long blocks = needed < 2LL * sms ? needed : 2LL * sms;
    count_global<<<(unsigned)blocks, kThreads, 0, s>>>(ids, n, V, out);
  }
  return cudaGetLastError();
}

}  // extern "C"
