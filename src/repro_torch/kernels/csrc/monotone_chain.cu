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
// Why the walk stays serial.  The float32 pops depend on which triples are
// tested: a near-collinear point can be kept by one order of tests and
// popped by another.  A divide-and-conquer hull (segments per thread,
// bridges between sub-hulls, an Akl-Toussaint pre-filter) is exact in real
// arithmetic but tests other triples, so it can differ from the JAX scan,
// and the port must not.  So each chain is walked in order and makes
// exactly the scan's turn tests: the lower chain forward over the run, the
// upper chain backward over it.
//
// What bounds it on an H100: in bytes, the live points read once and the
// (V, L, 2) hulls written once.  In fact the dependent chain of turn tests:
// every test waits for the one before it (a pop changes the stack the next
// test reads), so a chain of c points costs about 2c - h dependent
// test-and-branch steps whatever the card.  With many runs (merge-0 of the
// 2-D hull: 2048 runs) the walkers of all runs are resident at once and the
// SMs' instruction throughput bounds the call instead.  On the dependent
// chain a compare and the branch on it cost several arithmetic operations,
// and a shared load, a warp ballot or a find-first-set more still, so the
// design keeps loads, stores and branches off it:
//
// - The stack lives next to the walker.  Its top four entries are
//   registers, and each point's first two turn tests, the one before any
//   pop and the one after one pop, are made at once: no pop and one pop
//   (nearly every point of a random run) resolve with selects, with no
//   branch on the first test's outcome and no load.  Only two pops or more
//   reload entries, from a window of the next `window` entries kept in
//   shared memory as a ring.  A push writes through to the device row (the
//   output row for the lower chain, a scratch row for the upper) and to the
//   ring.  Only pops below the window read device memory: the warp refills
//   window / 2 entries at once.  The tests are the chain's own triples in
//   the chain's order; the second is made and not read when the first
//   turns left.
// - One warp walks each chain, all 32 lanes in lockstep on the same values
//   (shared reads broadcast; lane 0 alone stores), so no branch diverges.
// - Input arrives asynchronously, per chain.  Block = two warps, one a
//   chain; the warp's 32 lanes fill that chain's ring of `depth` stages of
//   `stage` points with 8-byte cp.async copies (any alignment of a point),
//   the upper chain reading the same contiguous range in reverse.  The
//   walker waits only for its own next stage (cp.async.wait_group, then
//   __syncwarp among its own lanes); the two chains never meet at a block
//   barrier until both are done.  Points are read from the ring four at a
//   time, the next four while these are walked.
// - The orientation test rounds as the JAX package's does: XLA on the CPU
//   contracts (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x) into
//   fma(b.x - a.x, p.y - a.y, -((b.y - a.y) * (p.x - a.x))), the second
//   product rounded on its own, and flushes subnormal operands and results
//   to zero (as a TPU does).  The kernel spells that out in PTX (sub, mul
//   and fma, each .rn.ftz), so nvcc contracts nothing else, and
//   near-collinear or tiny points are popped as the JAX scan pops them.
//   With it the kernel equals its plain PyTorch version bit for bit.
//
// Stage depth and window size (pick_shape): k = ceil(V / SMs), at most 16,
// blocks share an SM; each block gets kBlockBudget / k bytes of dynamic
// shared memory, half a chain; of a chain's half a third is the window and
// two thirds the ring, each a power of two of float2 entries, none larger
// than L rounded up to a power of two.  depth = 4 when a block has an SM to
// itself (k = 1), else 2.  So merge-0 (V 2048 on 132 SMs: k 16) runs 16
// blocks an SM in 12 KB each (stage 256, depth 2, window 256: its runs of
// about 8,192 points keep hull chains far shallower than 256); one long run
// (the finalize, the all-extreme run: k 1) gets stage 2048, depth 4 and a
// window of 4096 entries (192 KB), so a chain pops into device memory only
// after more than 4096 points stood on its stack.
//
// The upper chain's scratch stays (V, L, 2): an upper chain can hold every
// point of its run (points on a concave curve), and the output row cannot
// hold it beside the lower chain while the two walkers run unsynchronised.
// It is written through once a push, and read only by a pop below the window
// and by the final copy of the entries that left the window; the final copy
// takes the rest from the shared-memory ring.
//
// Measured (chip_smoke.py, phase geometry-chain, two runs; NVIDIA H100
// 80GB HBM3, 700.00 W; one call per event pair): the 2-D hull's merge-0 of
// 2^24 points 3.574 / 3.619 ms and its finalize of 40,649 points 3.855 /
// 3.860 ms (the kernel before this design: 4.593 / 4.355 and 6.085 /
// 6.020), 65,536 extreme points 3.732 / 3.830 ms (8.215 / 8.158), 2^20
// extreme points 57.544 / 57.971 ms.  The finalize takes about 190 cycles
// a point at 1,980 MHz, nearly five times its serial floor (20 cycles a
// test, two tests a point); merge-0 is bound by the SMs' instruction
// throughput, its 4,096 walkers resident at once.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;           // warp 0: lower chain, warp 1: upper
constexpr int kMaxBlocksPerSm = 16;
constexpr long long kBlockBudget = 192 * 1024;   // dynamic smem of a block

struct Shape {
  int stage;    // points of one stage
  int depth;    // stages in a chain's ring
  int window;   // stack entries a chain keeps in shared memory
};

long long pow2_floor(long long x) {
  long long p = 1;
  while (p * 2 <= x) p *= 2;
  return p;
}

long long pow2_ceil(long long x) {
  long long p = 1;
  while (p < x) p *= 2;
  return p;
}

Shape pick_shape(long long V, long long L, int sms) {
  long long k = (V + sms - 1) / sms;
  k = k < 1 ? 1 : (k > kMaxBlocksPerSm ? kMaxBlocksPerSm : k);
  const long long chain = kBlockBudget / k / 2;
  const long long cap = pow2_ceil(L < 32 ? 32 : L);
  Shape s;
  s.depth = k == 1 ? 4 : 2;
  const long long window = pow2_floor(chain / 3 / 8);
  const long long stage = pow2_floor(chain * 2 / 3 / s.depth / 8);
  s.window = (int)(window < cap ? window : cap);
  s.stage = (int)(stage < cap ? stage : cap);
  return s;
}

size_t smem_bytes(Shape s) {
  return 2 * ((size_t)s.depth * s.stage + s.window) * sizeof(float2);
}

__device__ __forceinline__ float sub_ftz(float u, float v) {
  float r;
  asm("sub.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(u), "f"(v));
  return r;
}

__device__ __forceinline__ float mul_ftz(float u, float v) {
  float r;
  asm("mul.rn.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(u), "f"(v));
  return r;
}

__device__ __forceinline__ float fma_ftz(float u, float v, float w) {
  float r;
  asm("fma.rn.ftz.f32 %0, %1, %2, %3;" : "=f"(r) : "f"(u), "f"(v), "f"(w));
  return r;
}

// (b - a) x (p - a) as XLA computes it: the first product fused, subnormal
// values flushed to zero
__device__ __forceinline__ float turn(float2 a, float2 b, float2 p) {
  return fma_ftz(sub_ftz(b.x, a.x), sub_ftz(p.y, a.y),
                 -mul_ftz(sub_ftz(b.y, a.y), sub_ftz(p.x, a.x)));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void copy8(unsigned dst, const float2* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

// Shared-memory accesses by 32-bit shared address (no generic-address
// conversion a step), volatile, so they keep their program order among
// themselves and around the cp.async waits.
__device__ __forceinline__ float4 lds4(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ float2 lds2(unsigned addr) {
  float2 v;
  asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts2(unsigned addr, float2 v) {
  asm volatile("st.shared.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v.x),
               "f"(v.y)
               : "memory");
}

template <int kDepth>
__global__ void __launch_bounds__(kThreads, kMaxBlocksPerSm)
chain_runs(const float2* __restrict__ pts, const int* __restrict__ counts,
           int L, int stage, int window, float2* __restrict__ hull,
           int* __restrict__ h_out, float2* __restrict__ upper) {
  extern __shared__ __align__(16) float2 smem[];
  __shared__ int tops[2], bottoms[2];
  const int dir = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long v = blockIdx.x;
  const float2* run = pts + v * L;
  float2* lo = hull + v * L;
  float2* up = upper + v * L;
  int cnt = counts[v];
  cnt = cnt < 0 ? 0 : (cnt > L ? L : cnt);
  const int per_chain = kDepth * stage + window;
  float2* ring = smem + dir * per_chain;
  float2* win = ring + kDepth * stage;
  float2* row = dir ? up : lo;        // the chain's stack in device memory
  const int mask = window - 1;
  const int n_stages = (cnt + stage - 1) / stage;

  // Stage s of this chain: walking positions [s * stage, ...), read from
  // slot j (lower) or cnt - 1 - j (upper).  One commit group a call.
  const unsigned ring_s = smem_addr(ring);
  const unsigned win_s = smem_addr(win);
  auto fill = [&](int s) {
    if (s < n_stages) {
      const unsigned dst = ring_s + (s % kDepth) * stage * 8;
      const int base = s * stage;
      const int m = min(stage, cnt - base);
      for (int i = lane; i < m; i += 32) {
        const int j = base + i;
        copy8(dst + i * 8, run + (dir ? cnt - 1 - j : j));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int s = 0; s < kDepth - 1; ++s) fill(s);
  // slots past the live prefix are zero whatever the chains do
  for (int i = cnt + threadIdx.x; i < L; i += kThreads)
    lo[i] = make_float2(0.f, 0.f);

  // The warp walks the chain in lockstep, every lane on the same values
  // (shared reads broadcast), so no branch diverges.  The top four stack
  // entries are registers; each point's first two turn tests (before any
  // pop and after one) are made at once, and the common outcomes, no pop or
  // one, need no branch and no load.  Lane 0 alone writes the stack through
  // to device memory.
  int top = 0;
  int bottom = 0;                     // win holds stack[bottom, top)
  // r0 = stack[top - 1], r1 = stack[top - 2], r2 = stack[top - 3],
  // r3 = stack[top - 4], where they exist
  float2 r0 = make_float2(0.f, 0.f), r1 = r0, r2 = r0, r3 = r0;
  auto load = [&](int i) -> float2 {
    if (i < bottom) {
      // below the window: the warp refills it down to window / 2 entries
      // under i from the row (lane 0 wrote them; __ldcg reads them from L2)
      const int first = max(0, i - window / 2 + 1);
      __syncwarp();
      for (int k = first + lane; k < bottom; k += 32)
        sts2(win_s + (k & mask) * 8, __ldcg(row + k));
      __syncwarp();
      bottom = first;
    }
    return lds2(win_s + (i & mask) * 8);
  };
  auto step = [&](float2 p) {
    for (;;) {
      const float t0 = turn(r1, r0, p);   // the test before any pop
      const float t1 = turn(r2, r1, p);   // the test after one pop
      const bool keep0 = top < 2 || t0 > 0.f;
      if (keep0 || top < 3 || t1 > 0.f) {
        // no pop, or one pop: p goes on top either way
        r3 = keep0 ? r2 : r3;
        r2 = keep0 ? r1 : r2;
        r1 = keep0 ? r0 : r1;
        r0 = p;
        top += keep0;
        if (lane == 0) __stcg(row + top - 1, p);
        sts2(win_s + ((top - 1) & mask) * 8, p);
        bottom = max(bottom, top - window);
        return;
      }
      // both tests pop: two pops, then test p again
      top -= 2;
      r0 = r2;
      r1 = r3;
      if (top >= 3) r2 = load(top - 3);
      if (top >= 4) r3 = load(top - 4);
    }
  };
  for (int s = 0; s < n_stages; ++s) {
    fill(s + kDepth - 1);             // into the stage consumed at s - 1
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
    __syncwarp();                     // every lane's copies of stage s landed
    const unsigned st = ring_s + (s % kDepth) * stage * 8;
    const int m = min(stage, cnt - s * stage);
    // four points a group, the next group read while this one is walked
    int j = 0;
    float4 g0 = lds4(st), g1 = lds4(st + 16);
    for (; j + 4 <= m; j += 4) {
      const unsigned nx = st + min(j + 4, stage - 4) * 8;
      const float4 n0 = lds4(nx), n1 = lds4(nx + 16);
      step(make_float2(g0.x, g0.y));
      step(make_float2(g0.z, g0.w));
      step(make_float2(g1.x, g1.y));
      step(make_float2(g1.z, g1.w));
      g0 = n0;
      g1 = n1;
    }
    for (; j < m; ++j) step(lds2(st + j * 8));
    __syncwarp();                     // stage s consumed: free to refill
  }
  if (lane == 0) {
    tops[dir] = top;
    bottoms[dir] = bottom;
  }
  __syncthreads();
  // behind the lower chain: the upper chain (from its ring where it still
  // is, else from its scratch row), then zeros up to the live prefix's end
  const int lo_top = tops[0], up_top = tops[1], up_bottom = bottoms[1];
  const int h = cnt >= 2 ? lo_top + up_top - 2 : cnt;
  const int n_lower = lo_top > 1 ? lo_top - 1 : 0;
  const float2* up_win = smem + per_chain + kDepth * stage;
  for (int i = n_lower + threadIdx.x; i < cnt; i += kThreads) {
    const int k = i - n_lower;
    float2 q = make_float2(0.f, 0.f);
    if (i < h) q = k >= up_bottom ? up_win[k & mask] : __ldcg(up + k);
    lo[i] = q;
  }
  if (threadIdx.x == 0) h_out[v] = h;
}

cudaError_t shape_for(long long V, long long L, Shape* s) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *s = pick_shape(V, L, sms);
  return cudaSuccess;
}

}  // namespace

extern "C" {

// The stage size, ring depth and window size a launch over V runs of L
// slots takes on the current device, into shape[0..2].  Returns a
// cudaError_t, 0 on success.
int repro_monotone_chain_shape(long long V, long long L, int* shape) {
  Shape s;
  const cudaError_t err = shape_for(V, L, &s);
  if (err != cudaSuccess) return err;
  shape[0] = s.stage;
  shape[1] = s.depth;
  shape[2] = s.window;
  return 0;
}

// pts, hull, upper: (V, L, 2) float32, pts 8-byte aligned; counts, h: (V,)
// int32.  upper is scratch.  Requires 1 <= V < 2^31 and 1 <= L < 2^31.
// Returns a cudaError_t, 0 on success.
int repro_monotone_chain(const float* pts, const int* counts, long long V,
                         long long L, float* hull, int* h, float* upper,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Shape s;
  cudaError_t err = shape_for(V, L, &s);
  if (err != cudaSuccess) return err;
  const size_t smem = smem_bytes(s);
  void (*kern)(const float2*, const int*, int, int, int, float2*, int*,
               float2*) = s.depth == 4 ? chain_runs<4> : chain_runs<2>;
  // Above 48 KB a block's shared memory (the dynamic part and the static
  // tops/bottoms) needs the opt-in; k = 3 or 4 asks exactly 48 KB of
  // dynamic memory, which with the static words is past the default.
  if (smem >= 48 * 1024) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  kern<<<(unsigned)V, kThreads, smem, st>>>(
      reinterpret_cast<const float2*>(pts), counts, (int)L, s.stage,
      s.window, reinterpret_cast<float2*>(hull), h,
      reinterpret_cast<float2*>(upper));
  return cudaGetLastError();
}

}  // extern "C"
