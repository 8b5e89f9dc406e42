// prefix_scan: inclusive or exclusive cumulative sum along the last axis of
// a (rows, n) int32 or float32 matrix.
//
// Replaces the Pallas kernel src/repro/kernels/prefix_scan.py::prefix_scan
// (body _scan_kernel).  Contract: the result has the input's type; int32
// sums wrap modulo 2^32, as JAX's do; exclusive[i] = sum of x[0..i-1].
//
// What bounds it on an H100: bytes, rows * n * 4 read and the same written
// (at the local-sort count-scan shape, 2048 x 12288 int32: 201 MB, 0.060
// ms at 3.35 TB/s).  One add per element is nothing against that.
//
// Design: the TPU kernel carries the running row sums in VMEM across a grid
// that runs in order.  Blocks here run in no order, so the scan is three
// deterministic passes, as bincount_tiles.cu's column scan is, with no
// inter-block waiting:
//   1. one block per (row, chunk of kChunk elements): each thread scans its
//      kItems consecutive elements, one block-wide scan of the thread sums
//      gives the chunk's local scan, written out, and the chunk total goes
//      to scratch;
//   2. one block per row: exclusive scan of its chunk totals, in place;
//   3. one block per (row, chunk) after the first: add the chunk's offset.
// A row of one chunk needs pass 1 only.  int32 adds are unsigned, so they
// wrap without undefined behaviour.  float32: a chunk's local scan is
// float32 (as the TPU block's cumsum is); chunk totals and their offsets are
// float64, so the only rounding beyond the chunk is the final one.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kChunk = kThreads * kItems;
constexpr int kRowThreads = 1024;

// The type a chunk's local scan runs in, and the type of the chunk totals
// and offsets (scratch).
template <typename T> struct Types;
template <> struct Types<int> {
  using Local = unsigned;
  using Carry = unsigned;
  static __device__ unsigned to_local(int v) { return (unsigned)v; }
  static __device__ int from(unsigned v) { return (int)v; }
  static __device__ int add(int v, unsigned off) { return (int)((unsigned)v + off); }
};
template <> struct Types<float> {
  using Local = float;
  using Carry = double;
  static __device__ float to_local(float v) { return v; }
  static __device__ float from(float v) { return v; }
  static __device__ float add(float v, double off) { return (float)((double)v + off); }
};

// Exclusive scan of one value per thread across the block (blockDim.x a
// multiple of 32, at most 1024); *total gets the block's sum.  Every thread
// must call it.
template <typename V>
__device__ V block_exclusive_scan(V v, V* warp_sums, V* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  V incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    V t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    V w = lane < n_warps ? warp_sums[lane] : V(0);
    V wi = w;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      V t = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += t;
    }
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  V out = warp_sums[warp] + (incl - v);
  __syncthreads();
  return out;
}

// Pass 1: local scan of chunk (blockIdx.x % n_chunks) of row
// (blockIdx.x / n_chunks); its total to sums[blockIdx.x].
template <typename T>
__global__ void __launch_bounds__(kThreads)
chunk_scan(const T* __restrict__ x, T* __restrict__ out, long long n,
           long long n_chunks, int exclusive,
           typename Types<T>::Carry* __restrict__ sums) {
  using L = typename Types<T>::Local;
  __shared__ L warp_sums[32];
  __shared__ L total;
  const long long row = blockIdx.x / n_chunks;
  const long long c = blockIdx.x % n_chunks;
  const long long i0 = c * kChunk + (long long)threadIdx.x * kItems;
  const T* xr = x + row * n;
  T* orow = out + row * n;
  L v[kItems];
  L s = L(0);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    v[j] = i0 + j < n ? Types<T>::to_local(xr[i0 + j]) : L(0);
    s += v[j];
  }
  L run = block_exclusive_scan<L>(s, warp_sums, &total);
#pragma unroll
  for (int j = 0; j < kItems; ++j) {
    const L incl = run + v[j];
    if (i0 + j < n) orow[i0 + j] = Types<T>::from(exclusive ? run : incl);
    run = incl;
  }
  if (threadIdx.x == 0) sums[blockIdx.x] = (typename Types<T>::Carry)total;
}

// Pass 2: exclusive scan of one row's chunk totals, in place.
template <typename C>
__global__ void __launch_bounds__(kRowThreads)
row_offsets(C* __restrict__ sums, long long n_chunks) {
  __shared__ C warp_sums[32];
  __shared__ C total;
  C* r = sums + (long long)blockIdx.x * n_chunks;
  C carry = C(0);
  for (long long base = 0; base < n_chunks; base += blockDim.x) {
    const long long c = base + threadIdx.x;
    const C v = c < n_chunks ? r[c] : C(0);
    const C ex = block_exclusive_scan<C>(v, warp_sums, &total);
    if (c < n_chunks) r[c] = carry + ex;
    carry += total;
  }
}

// Pass 3: add each chunk's offset to its elements (chunk 0's is 0).
template <typename T>
__global__ void __launch_bounds__(kThreads)
add_offsets(T* __restrict__ out, long long n, long long n_chunks,
            const typename Types<T>::Carry* __restrict__ offsets) {
  const long long c = blockIdx.x % n_chunks;
  if (c == 0) return;
  const auto off = offsets[blockIdx.x];
  T* orow = out + (blockIdx.x / n_chunks) * n;
  for (long long i = c * kChunk + threadIdx.x; i < min(n, (c + 1) * kChunk);
       i += kThreads)
    orow[i] = Types<T>::add(orow[i], off);
}

template <typename T>
cudaError_t run(const void* x, void* out, long long rows, long long n,
                int exclusive, void* scratch, cudaStream_t s) {
  using C = typename Types<T>::Carry;
  const long long n_chunks = (n + kChunk - 1) / kChunk;
  const unsigned blocks = (unsigned)(rows * n_chunks);
  C* sums = static_cast<C*>(scratch);
  chunk_scan<T><<<blocks, kThreads, 0, s>>>(static_cast<const T*>(x),
                                            static_cast<T*>(out), n, n_chunks,
                                            exclusive, sums);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_chunks == 1) return err;
  row_offsets<C><<<(unsigned)rows, kRowThreads, 0, s>>>(sums, n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  add_offsets<T><<<blocks, kThreads, 0, s>>>(static_cast<T*>(out), n, n_chunks,
                                             sums);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch repro_prefix_scan needs: one chunk total per
// (row, chunk of 1024), 4 bytes each for int32, 8 for float32.
long long repro_prefix_scan_scratch_bytes(long long rows, long long n,
                                          int dtype) {
  return rows * ((n + kChunk - 1) / kChunk) * (dtype == 0 ? 4 : 8);
}

// x, out: (rows, n) contiguous, dtype 0 int32, 1 float32.  Requires
// rows, n >= 1 and rows * ceil(n / 1024) < 2^31.  Returns a cudaError_t,
// 0 on success.
int repro_prefix_scan(const void* x, void* out, long long rows, long long n,
                      int exclusive, int dtype, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<int>(x, out, rows, n, exclusive, scratch, s);
  if (dtype == 1) return run<float>(x, out, rows, n, exclusive, scratch, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
