// ssm_scan: the diagonal linear recurrence h_t = a_t * h_{t-1} + x_t along
// t of (B, T, D) tensors, h_{-1} = 0, carried in float32; h in x's type.
//
// Replaces the Pallas kernel src/repro/kernels/ssm_scan.py::ssm_scan (body
// _ssm_kernel), the inter-chunk state scan of the Mamba2 block
// (src/repro/models/ssm.py:133) and of RWKV6 time mixing
// (src/repro/models/rwkv.py:136).  a and x are float32 or bfloat16, each on
// its own; every product and sum is float32.
//
// ssm_scan_bwd_kernel is its adjoint, the backward of the custom VJP at
// src/repro/kernels/ops.py:85-116 (_ssm_scan_bwd): for a cotangent dh,
//   g_t = dh_t + a_{t+1} g_{t+1}   (a_T = 1),   dx_t = g_t,
//   da_t = g_t h_{t-1}             (h_{-1} = 0),
// g carried in float32, da in a's type, dx in x's.  The JAX backward runs
// the forward Pallas kernel on flipped, shifted copies and flips and
// concatenates again; this kernel walks t downwards instead and reads dh, a
// and h once and writes da and dx once: 5 * B * T * D * 4 bytes in float32,
// 671 MB at both training shapes of the LM path (the same (B, T, D) as the
// prefill shapes below), 0.200 ms at 3.35 TB/s.
//
// What bounds it on an H100: bytes.  The function reads a and x once and
// writes h once, 3 * B * T * D * 4 bytes in float32: 403 MB at both prefill
// shapes of the LM path (zamba2-1.2b: B 8, T 16, D 262144; rwkv6-1.6b: B 8,
// T 32, D 131072), 0.120 ms at 3.35 TB/s.  One FMA per element is nothing
// against that.
//
// Design: the TPU kernel runs a log-depth associative scan inside each VMEM
// block and carries h across a grid that runs in order.  No H100 grid runs
// in order, and T is short on the LM path (16 or 32 chunks) while D is wide,
// so the scan axis stays inside one thread: one thread per (batch, channel)
// walks t with its carry in a register.  Channels are the fastest axis, so
// each warp reads and writes 128 contiguous bytes of a, x and h per step;
// the loads of a step do not depend on the carry, and the unrolled loop lets
// several steps' loads be in flight at once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Block k covers channels [(k % blocks_per_row) * kThreads, ...) of batch
// row k / blocks_per_row.
template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const TA* __restrict__ a, const TX* __restrict__ x,
                TX* __restrict__ h, long long T, long long D,
                long long blocks_per_row) {
  const long long row = blockIdx.x / blocks_per_row;
  const long long c = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  if (c >= D) return;
  const long long base = row * T * D + c;
  float carry = 0.f;
#pragma unroll 8
  for (long long t = 0; t < T; ++t) {
    const long long i = base + t * D;
    carry = load(a + i) * carry + load(x + i);
    store(h + i, carry);
  }
}

// The same blocks as the forward; each thread walks its channel from
// t = T-1 down to 0.  a_{t+1} is the value loaded one step earlier.
template <typename TA, typename TX>
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const TA* __restrict__ a, const TX* __restrict__ h,
                    const TX* __restrict__ dh, TA* __restrict__ da,
                    TX* __restrict__ dx, long long T, long long D,
                    long long blocks_per_row) {
  const long long row = blockIdx.x / blocks_per_row;
  const long long c = (blockIdx.x % blocks_per_row) * kThreads + threadIdx.x;
  if (c >= D) return;
  const long long base = row * T * D + c;
  float g = 0.f;
  float a_next = 1.f;
#pragma unroll 8
  for (long long t = T - 1; t >= 0; --t) {
    const long long i = base + t * D;
    g = load(dh + i) + a_next * g;
    const float h_prev = t > 0 ? load(h + i - D) : 0.f;
    a_next = load(a + i);
    store(dx + i, g);
    store(da + i, g * h_prev);
  }
}

template <typename TA, typename TX>
cudaError_t launch(const void* a, const void* x, void* h, long long B,
                   long long T, long long D, cudaStream_t s) {
  const long long per_row = (D + kThreads - 1) / kThreads;
  ssm_scan_kernel<TA, TX><<<(unsigned)(B * per_row), kThreads, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TX*>(x),
      static_cast<TX*>(h), T, D, per_row);
  return cudaGetLastError();
}

template <typename TA, typename TX>
cudaError_t launch_bwd(const void* a, const void* h, const void* dh, void* da,
                       void* dx, long long B, long long T, long long D,
                       cudaStream_t s) {
  const long long per_row = (D + kThreads - 1) / kThreads;
  ssm_scan_bwd_kernel<TA, TX><<<(unsigned)(B * per_row), kThreads, 0, s>>>(
      static_cast<const TA*>(a), static_cast<const TX*>(h),
      static_cast<const TX*>(dh), static_cast<TA*>(da), static_cast<TX*>(dx),
      T, D, per_row);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// a, x, h: (B, T, D) contiguous; a_dtype, x_dtype: 0 float32, 1 bfloat16;
// h has x's type.  Requires B, T, D >= 1 and B * ceil(D / 256) < 2^31.
// Returns a cudaError_t, 0 on success.
int repro_ssm_scan(const void* a, const void* x, void* h, long long B,
                   long long T, long long D, int a_dtype, int x_dtype,
                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && x_dtype == 0) return launch<float, float>(a, x, h, B, T, D, s);
  if (a_dtype == 0 && x_dtype == 1)
    return launch<float, __nv_bfloat16>(a, x, h, B, T, D, s);
  if (a_dtype == 1 && x_dtype == 0)
    return launch<__nv_bfloat16, float>(a, x, h, B, T, D, s);
  if (a_dtype == 1 && x_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(a, x, h, B, T, D, s);
  return cudaErrorInvalidValue;
}

// The backward: a (B, T, D) in a's type, h and dh in x's type, all
// contiguous; writes da (a's type) and dx (x's type).  The same dtype codes
// and limits as repro_ssm_scan.  Returns a cudaError_t, 0 on success.
int repro_ssm_scan_bwd(const void* a, const void* h, const void* dh, void* da,
                       void* dx, long long B, long long T, long long D,
                       int a_dtype, int x_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && x_dtype == 0)
    return launch_bwd<float, float>(a, h, dh, da, dx, B, T, D, s);
  if (a_dtype == 0 && x_dtype == 1)
    return launch_bwd<float, __nv_bfloat16>(a, h, dh, da, dx, B, T, D, s);
  if (a_dtype == 1 && x_dtype == 0)
    return launch_bwd<__nv_bfloat16, float>(a, h, dh, da, dx, B, T, D, s);
  if (a_dtype == 1 && x_dtype == 1)
    return launch_bwd<__nv_bfloat16, __nv_bfloat16>(a, h, dh, da, dx, B, T,
                                                    D, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
