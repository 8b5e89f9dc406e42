// monotone_chain: Andrew's monotone chain over a batch of runs, the reducer
// of the 2-D convex hull (src/repro_torch/core/geometry/chain.py).
//
// Input: (V, L, 2) float32 runs, each lex-sorted by (x, y) and deduplicated,
// whose live points form a prefix of counts[v] slots.  Output: (V, L, 2)
// float32 hulls in the JAX package's layout (the lower chain without its last
// point, then the upper chain without its last point: CCW from the lex-min),
// zero from slot h on, and (V,) int32 counts h (a run of 0 or 1 points gives
// itself).
//
// It has no Pallas counterpart: the JAX package computes this function
// outside any kernel, as a lax.scan over the padded run with a lax.while_loop
// of pops at every step (src/repro/core/geometry/chain.py:31-61), under vmap
// over the mailbox's nodes.
//
// What bounds it on an H100: in bytes, the live points read once and the
// (V, L, 2) hulls written once.  In fact the chain itself, which is serial:
// every push depends on the pops before it.  One run of n points takes about
// n dependent steps, whatever the card.
//
// Design (simple first): one block per run, with the lower chain run by lane
// 0 of warp 0 and the upper chain by lane 0 of warp 1, so the two diverge on
// separate warps.  All 64 threads stage the next kChunk points of each
// direction into shared memory, then the two chain threads consume them.
// The lower chain's stack is the run's output row itself; the upper chain's
// is a global scratch row.  The top two stack entries stay in registers, so
// a push is one store and a pop one load.  At the end the block copies the
// upper chain behind the lower one and zeroes the rest of the row.
//
// The orientation test is computed with __fmul_rn / __fsub_rn in the JAX
// package's operand order: nvcc would otherwise contract a*b - c*d into an
// fma, which rounds differently and pops other near-collinear points than
// XLA and PyTorch do.  With it the kernel equals its plain PyTorch version
// bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;      // warp 0: lower chain, warp 1: upper chain
constexpr int kChunk = 1024;      // points of each direction a stage holds

// (b - a) x (p - a), each operation rounded on its own (no fma)
__device__ __forceinline__ float turn(float2 a, float2 b, float2 p) {
  return __fsub_rn(__fmul_rn(__fsub_rn(b.x, a.x), __fsub_rn(p.y, a.y)),
                   __fmul_rn(__fsub_rn(b.y, a.y), __fsub_rn(p.x, a.x)));
}

__global__ void __launch_bounds__(kThreads)
chain_runs(const float2* __restrict__ pts, const int* __restrict__ counts,
           long long L, float2* __restrict__ hull, int* __restrict__ h_out,
           float2* __restrict__ upper) {
  __shared__ float2 stage[2][kChunk];
  __shared__ long long tops[2];
  const long long v = blockIdx.x;
  const float2* run = pts + v * L;
  float2* lo = hull + v * L;
  float2* up = upper + v * L;
  long long cnt = counts[v];
  cnt = cnt < 0 ? 0 : (cnt > L ? L : cnt);
  const int dir = threadIdx.x / 32;
  const bool chain = (threadIdx.x % 32) == 0;
  float2* stack = dir ? up : lo;
  long long top = 0;
  float2 a = make_float2(0.f, 0.f);   // stack[top - 2] when top >= 2
  float2 b = make_float2(0.f, 0.f);   // stack[top - 1] when top >= 1
  for (long long base = 0; base < cnt; base += kChunk) {
    const int m = (int)(cnt - base < kChunk ? cnt - base : kChunk);
    __syncthreads();                  // the last stage has been consumed
    for (int j = threadIdx.x; j < m; j += kThreads) {
      stage[0][j] = run[base + j];
      stage[1][j] = run[cnt - 1 - base - j];
    }
    __syncthreads();
    if (chain) {
      for (int j = 0; j < m; ++j) {
        const float2 p = stage[dir][j];
        while (top >= 2 && turn(a, b, p) <= 0.f) {
          --top;
          b = a;
          if (top >= 2) a = stack[top - 2];
        }
        stack[top++] = p;
        a = b;
        b = p;
      }
    }
  }
  if (chain) tops[dir] = top;
  __syncthreads();
  const long long lo_top = tops[0], up_top = tops[1];
  const long long h = cnt >= 2 ? lo_top + up_top - 2 : cnt;
  const long long n_lower = lo_top > 1 ? lo_top - 1 : 0;
  for (long long i = n_lower + threadIdx.x; i < L; i += kThreads)
    lo[i] = i < h ? up[i - n_lower] : make_float2(0.f, 0.f);
  if (threadIdx.x == 0) h_out[v] = (int)h;
}

}  // namespace

extern "C" {

// pts, hull, upper: (V, L, 2) float32; counts, h: (V,) int32.  upper is
// scratch.  Requires 1 <= V < 2^31 and 1 <= L < 2^31.  Returns a
// cudaError_t, 0 on success.
int repro_monotone_chain(const float* pts, const int* counts, long long V,
                         long long L, float* hull, int* h, float* upper,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  chain_runs<<<(unsigned)V, kThreads, 0, s>>>(
      reinterpret_cast<const float2*>(pts), counts, L,
      reinterpret_cast<float2*>(hull), h, reinterpret_cast<float2*>(upper));
  return cudaGetLastError();
}

}  // extern "C"
