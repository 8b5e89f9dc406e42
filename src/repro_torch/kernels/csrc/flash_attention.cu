// Blocked (flash) attention forward for Hopper, CUDA cores, f32 accumulate.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention` / `_flash_kernel`, its pl.pallas_call), with the
// wrapper work of src/repro/kernels/ops.py:50-82 folded in:
//
//   q (B, HQ, SQ, D), k and v (B, HKV, SK, D), HQ % HKV == 0, contiguous,
//   float32 or bfloat16; out (B, HQ, SQ, D) in q's type.
//   s = (q * 1/sqrt(D)) k^T in f32 (q scaled in f32 before the product),
//   masked to the finite NEG_INF = -1e30 where k_idx >= SK or, when causal,
//   where q_idx < k_idx (absolute indices from 0 on both axes); online
//   softmax with (m, l, acc) in f32; out = acc / max(l, 1e-30).
//
// Translation.  The TPU grid's sequential KV axis, which carries (m, l, acc)
// in VMEM scratch, is a loop over key tiles inside one block here: one block
// per (batch * query head, 64-query tile), 256 threads, K/V tiles of 64 keys
// staged in shared memory as f32.  A causal block stops at its diagonal.
// GQA reads KV head h / (HQ / HKV) in place (no repeat in memory); the head
// dim is not padded to 128 lanes and the sequence is not padded to the
// tiles: the ragged edges are masked here.  The f32 path uses plain FMAs,
// never TF32.
//
// Bound.  At the main shape (B 8, HQ 32, HKV 4, S 2048, D 64, bf16, causal)
// the work is 4 * B * HQ * S^2 * D / 2 = 137 GFLOP against about 0.15 GB
// moved (q, k, v read once, out written once): bound by tensor-core FLOPs
// (989 TFLOP/s bf16, about 0.14 ms), not bytes (0.05 ms at 3.35 TB/s).
// This kernel is the simple, right one: both types run as f32 FMAs on the
// CUDA cores (67 TFLOP/s, so at least 2.05 ms), each thread owning a 4x4
// tile of scores and a 4 x D/16 tile of the output, with both operands read
// from shared memory (one load for every two FMAs), so it runs below even
// the CUDA-core rate: 5.08 ms in bf16 and in f32 at the main shape, 37
// times the tensor-core bound and 40 % of the CUDA-core rate (chip_smoke.py
// on an NVIDIA H100 80GB HBM3, 700 W).  mma.sync / wgmma with TMA-fed tiles
// is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // queries per block
constexpr int BK = 64;        // keys per shared-memory tile
constexpr int THREADS = 256;  // 16 x 16: ty owns 4 query rows, tx columns
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Reductions over the 16 lanes that share a query row (lanes tx = 0..15 of
// one half-warp).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
struct Smem {
  static constexpr int QS = D + 1;   // padded rows: no bank conflicts
  static constexpr int KS = D + 1;
  static constexpr int PS = BK + 1;
  static constexpr size_t floats = BQ * QS + BK * KS + BK * D + BQ * PS;
  static constexpr size_t bytes = floats * sizeof(float);
};

template <int D, typename T>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int HQ,
                 int HKV, int SQ, int SK, int causal, float scale) {
  constexpr int NC = D / 16;         // output columns per thread
  using S = Smem<D>;
  extern __shared__ float smem[];
  float* Qs = smem;                  // (BQ, D+1), scaled
  float* Ks = Qs + BQ * S::QS;       // (BK, D+1)
  float* Vs = Ks + BK * S::KS;       // (BK, D)
  float* Ps = Vs + BK * D;           // (BQ, BK+1)

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int bh = blockIdx.x;
  const int hq = bh % HQ;
  const int b = bh / HQ;
  const int hk = hq / (HQ / HKV);
  // Query tiles run last to first: under a causal mask the late tiles do
  // the most work, so they start first and the short ones fill the tail.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const T* qb = q + ((int64_t)bh * SQ) * D;
  const T* kb = k + ((int64_t)(b * HKV + hk) * SK) * D;
  const T* vb = v + ((int64_t)(b * HKV + hk) * SK) * D;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i - r * D;
    const int qi = q0 + r;
    Qs[r * S::QS + c] = qi < SQ ? to_f32(qb[(int64_t)qi * D + c]) * scale
                                : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  // Keys past the diagonal of the last query row are masked for every row
  // of this block: a causal block stops there.
  const int k_end = causal ? min(SK, q0 + BQ) : SK;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                 // the previous tile is consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i - r * D;
      const int ki = k0 + r;
      const bool in = ki < SK;
      Ks[r * S::KS + c] = in ? to_f32(kb[(int64_t)ki * D + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vb[(int64_t)ki * D + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * S::QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * S::KS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        if (ki >= SK || (causal && qi < ki)) s[i][j] = NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * S::PS + tx + 16 * j] = p;
        sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * S::PS + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* ob = out + ((int64_t)bh * SQ) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= SQ) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c)
      from_f32(ob + (int64_t)qi * D + tx + 16 * c, acc[i][c] / denom);
  }
}

template <int D, typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int HQ, int HKV, int SQ, int SK, int causal,
                   float scale, cudaStream_t stream) {
  auto kern = flash_fwd_kernel<D, T>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * HQ, (SQ + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), HQ, HKV, SQ, SK, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       void* out, int B, int HQ, int HKV, int SQ, int SK,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<32, T>(q, k, v, out, B, HQ, HKV, SQ, SK, causal, scale, stream);
    case 48: return launch<48, T>(q, k, v, out, B, HQ, HKV, SQ, SK, causal, scale, stream);
    case 64: return launch<64, T>(q, k, v, out, B, HQ, HKV, SQ, SK, causal, scale, stream);
    case 128: return launch<128, T>(q, k, v, out, B, HQ, HKV, SQ, SK, causal, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success); the
// wrapper has checked shapes, types and head dims before the call.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, long long B,
                                     long long HQ, long long HKV, long long SQ,
                                     long long SK, long long D, int causal,
                                     int dtype, float scale, void* stream) {
  if (B == 0 || HQ == 0 || SQ == 0) return 0;
  if (HKV <= 0 || HQ % HKV) return (int)cudaErrorInvalidValue;
  if ((SQ + BQ - 1) / BQ > 65535 || B * HQ > INT32_MAX)
    return (int)cudaErrorInvalidValue;                      // grid limits
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 0
          ? dispatch_d<float>((int)D, q, k, v, out, (int)B, (int)HQ, (int)HKV,
                              (int)SQ, (int)SK, causal, scale, s)
          : dispatch_d<__nv_bfloat16>((int)D, q, k, v, out, (int)B, (int)HQ,
                                      (int)HKV, (int)SQ, (int)SK, causal,
                                      scale, s);
  return (int)err;
}
