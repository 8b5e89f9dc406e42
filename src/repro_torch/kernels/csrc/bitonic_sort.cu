// bitonic_sort: sorts each row of a (rows, n) key matrix ascending and moves a
// same-shape 4-byte value matrix along, by a bitonic network.
//
// Replaces the Pallas kernel src/repro/kernels/bitonic_sort.py::bitonic_sort
// (bodies _bitonic_kernel and _compare_exchange).  Same network and the same
// direction rule: for merge size k and distance j, the element pair
// (i, i + j) is put in ascending order iff (i & k) == 0.  Rows are padded
// to a power of two n_pad with the key type's maximum (INT32_MAX, FLT_MAX),
// inside the kernel; the padding is never written out.  Not stable: ties
// keep whatever order the network leaves them in, exactly as on the TPU.
//
// What bounds it on an H100: the floor is bytes.  A row of n_pad = 4096 is
// 78 compare-exchange stages over 2048 pairs, about 1.6e5 comparisons per
// 32 KB of keys and values read and written once, and the card's int32 rate
// would clear those comparisons before its memory rate moves the bytes.  As
// measured (chip_smoke.py, H100 SXM), the kernel runs at about 14 times
// that byte floor and slower than a stable argsort plus gather; what holds
// it there is not yet known (PERF.md, open questions).
//
// Design: a row of n_pad <= kSmemN keys and values lives in shared memory
// (kSmemN * 8 bytes = 128 KB), one block per row, and every stage runs there
// between two __syncthreads, so the row is read once and written once.  A
// wider row (up to the 2^18 contract) is cut into kSmemN-wide chunks: the
// chunks are sorted in shared memory, then for each merge size k > kSmemN
// the stages with j >= kSmemN run as global compare-exchange launches over a
// padded work buffer and the stages with j < kSmemN finish in shared memory.
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>

namespace {

constexpr long long kSmemN = 1 << 14;
constexpr int kGlobalThreads = 256;

template <typename K> __device__ __forceinline__ K key_max();
template <> __device__ __forceinline__ int key_max<int>() { return INT_MAX; }
template <> __device__ __forceinline__ float key_max<float>() { return FLT_MAX; }

template <typename K>
__device__ __forceinline__ void compare_exchange(K* k, unsigned* v, long long a,
                                                 long long b, bool ascending) {
  const K ka = k[a], kb = k[b];
  if (ascending ? (ka > kb) : (ka < kb)) {
    k[a] = kb;
    k[b] = ka;
    const unsigned t = v[a];
    v[a] = v[b];
    v[b] = t;
  }
}

// One block sorts one `width`-wide chunk of one row in shared memory, running
// merge sizes k_lo..k_hi and, for each, the distances j < width.  Input rows
// have stride in_n (columns >= in_n are padding); output rows stride out_n
// (columns >= out_n are not written).  The direction uses the column within
// the whole row, so chunks of a wider row take their part of the network.
// A block reads its chunk wholly before it writes it, so in and out may be
// the same buffer.
template <typename K>
__global__ void bitonic_smem(const K* in_k, const unsigned* in_v, long long in_n, K* out_k,
                             unsigned* out_v, long long out_n,
                             long long n_pad, int width, long long k_lo, long long k_hi) {
  extern __shared__ unsigned char smem[];
  K* sk = reinterpret_cast<K*>(smem);
  unsigned* sv = reinterpret_cast<unsigned*>(smem + (size_t)width * sizeof(K));
  const long long chunks = n_pad / width;
  const long long row = blockIdx.x / chunks;
  const long long col0 = (blockIdx.x % chunks) * width;
  const K* rk = in_k + row * in_n;
  const unsigned* rv = in_v + row * in_n;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const long long col = col0 + i;
    const bool real = col < in_n;
    sk[i] = real ? rk[col] : key_max<K>();
    sv[i] = real ? rv[col] : 0u;
  }
  __syncthreads();
  const int half = width >> 1;
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    for (int j = (int)min(k >> 1, (long long)half); j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < half; p += blockDim.x) {
        const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
        compare_exchange(sk, sv, i, i + j, ((col0 + i) & k) == 0);
      }
      __syncthreads();
    }
  }
  K* ok = out_k + row * out_n;
  unsigned* ov = out_v + row * out_n;
  for (int i = threadIdx.x; i < width; i += blockDim.x) {
    const long long col = col0 + i;
    if (col < out_n) {
      ok[col] = sk[i];
      ov[col] = sv[i];
    }
  }
}

// One stage (k, j) with j >= kSmemN over a padded (rows, n_pad) work buffer.
template <typename K>
__global__ void bitonic_global(K* __restrict__ keys, unsigned* __restrict__ vals,
                               long long rows, long long n_pad, long long k, long long j) {
  const long long half = n_pad >> 1;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < rows * half;
       t += stride) {
    const long long row = t / half, p = t % half;
    const long long i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    compare_exchange(keys + row * n_pad, vals + row * n_pad, i, i + j, (i & k) == 0);
  }
}

template <typename K>
int launch(const void* keys, const void* vals, void* out_k, void* out_v, void* work_k,
           void* work_v, long long rows, long long n, long long n_pad, cudaStream_t s) {
  const int width = (int)(n_pad < kSmemN ? n_pad : kSmemN);
  const int threads = width >= 2048 ? 1024 : (width >= 2 ? width / 2 : 1);
  const size_t smem = (size_t)width * (sizeof(K) + sizeof(unsigned));
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(bitonic_smem<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)(rows * (n_pad / width));
  const K* ik = static_cast<const K*>(keys);
  const unsigned* iv = static_cast<const unsigned*>(vals);
  K* ok = static_cast<K*>(out_k);
  unsigned* ov = static_cast<unsigned*>(out_v);
  if (n_pad <= kSmemN) {
    bitonic_smem<K><<<blocks, threads, smem, s>>>(ik, iv, n, ok, ov, n, n_pad, width, 2,
                                                  n_pad);
    return cudaGetLastError();
  }
  K* wk = static_cast<K*>(work_k);
  unsigned* wv = static_cast<unsigned*>(work_v);
  bitonic_smem<K><<<blocks, threads, smem, s>>>(ik, iv, n, wk, wv, n_pad, n_pad, width, 2,
                                                width);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long pairs = rows * (n_pad >> 1);
  long long g = (pairs + kGlobalThreads - 1) / kGlobalThreads;
  if (g > 132LL * 64) g = 132LL * 64;
  for (long long k = 2 * (long long)width; k <= n_pad; k <<= 1) {
    for (long long j = k >> 1; j >= width; j >>= 1) {
      bitonic_global<K><<<(unsigned)g, kGlobalThreads, 0, s>>>(wk, wv, rows, n_pad, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    const bool last = k == n_pad;
    bitonic_smem<K><<<blocks, threads, smem, s>>>(wk, wv, n_pad, last ? ok : wk,
                                                  last ? ov : wv, last ? n : n_pad, n_pad,
                                                  width, k, k);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Widest padded row sorted wholly in shared memory; wider rows need the
// (rows, n_pad) work buffers.
long long repro_bitonic_smem_width(void) { return kSmemN; }

// keys: (rows, n) int32 (key_is_float = 0) or float32 (1); vals: (rows, n)
// of any 4-byte type; out_k, out_v: (rows, n); work_k, work_v: (rows, n_pad)
// when n_pad > repro_bitonic_smem_width(), else unused.  n_pad is the power
// of two >= n.  Requires rows >= 1 and n >= 1.  Returns a cudaError_t.
int repro_bitonic_sort(const void* keys, const void* vals, void* out_k, void* out_v,
                       void* work_k, void* work_v, long long rows, long long n,
                       long long n_pad, int key_is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_is_float)
    return launch<float>(keys, vals, out_k, out_v, work_k, work_v, rows, n, n_pad, s);
  return launch<int>(keys, vals, out_k, out_v, work_k, work_v, rows, n, n_pad, s);
}

}  // extern "C"
