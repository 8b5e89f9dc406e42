// Blocked (flash) attention forward for Hopper: bf16 on the tensor cores
// (wgmma), float32 on the CUDA cores.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py
// (`flash_attention` / `_flash_kernel`, its pl.pallas_call), with the
// wrapper work of src/repro/kernels/ops.py:50-82 folded in:
//
//   q (B, HQ, SQ, D), k and v (B, HKV, SK, D), HQ % HKV == 0, contiguous,
//   float32 or bfloat16; out (B, HQ, SQ, D) in q's type.
//   s = (q k^T) / sqrt(D) in f32, masked to the finite NEG_INF = -1e30 where
//   k_idx >= SK or, when causal, where q_idx < k_idx (absolute indices from
//   0 on both axes); online softmax with (m, l, acc) in f32;
//   out = acc / max(l, 1e-30).
//
// Translation.  The TPU grid's sequential KV axis, which carries (m, l, acc)
// in VMEM scratch, is a loop over key tiles inside one block here, one block
// per (batch * query head, query tile); query tiles run last to first and a
// causal block stops at its diagonal.  GQA reads KV head h / (HQ / HKV) in
// place; the head dim is not padded to 128 lanes and the sequence is not
// padded to the tiles: the ragged edges are masked here.
//
// Bound.  At the main shapes (B 8, HQ 32, HKV 4 or 32, S 2048, D 64, bf16,
// causal) the work is 4 * B * HQ * S (S + 1) / 2 * D = 137.5 GFLOP against
// about 0.15 GB moved: bound by tensor-core FLOPs (989 TFLOP/s bf16, 0.139
// ms), not bytes (0.05 ms at 3.35 TB/s).
//
// Two routes, picked by repro_flash_attention_route (never as a fallback):
//
// * bf16 with D 64 or 128: `flash_wgmma_kernel`.  A block of two consumer
//   warpgroups owns 128 query rows, 64 each; Q is loaded once.  Both
//   products are wgmma.mma_async with bf16 operands and f32 accumulators:
//   S = Q K^T with Q and K from shared memory (K-major), O += P V with P
//   from registers and V from shared memory in its (keys, D) layout
//   (MN-major B).  K/V tiles of 64 keys go through a two-stage ring fed by
//   cp.async, so the loads of tile j+1 overlap the products of tile j.
//   Every tile is stored with the 128-byte swizzle that the wgmma
//   descriptors name (16-byte chunk c of a 128-byte row r lands at c ^ (r %
//   8)), so the tensor cores read it without bank conflicts.  The online
//   softmax works on the S accumulator fragment in registers, and P is
//   rounded to bf16 in registers (the one rounding the TPU kernel does not
//   make; FlashAttention-2/3 practice) and never touches shared memory.  A
//   warpgroup skips the key tiles its causal mask hides wholly.
// * float32 (any D), and bf16 with D 32 or 48: `flash_fwd_kernel`, plain
//   FMAs on the CUDA cores, never TF32 (67 TFLOP/s, so at least 2.05 ms at
//   the main shape): one block per 64 queries, 256 threads, each owning a
//   4x4 tile of scores and a 4 x D/16 tile of the output.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): bf16 at the main
// shapes 0.598 ms (hkv 4) and 0.636 ms (hkv 32), 4.4 times the tensor-core
// bound and 1.55 times SDPA (0.395, 0.400 ms), where the CUDA-core route
// took 4.97 and 5.16 ms; float32 5.10 and 5.24 ms (bound 2.05 ms at the
// CUDA-core rate).
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

// ---------------------------------------------------------------------------
// The bf16 route: wgmma on the tensor cores.

namespace wg {

constexpr int BQ = 128;        // queries per block: two warpgroups of 64
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;
constexpr int ROW_BYTES = 128; // one swizzle row: 64 bf16

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c of row r in a tile of `rows` rows stored as
// column blocks of 64 elements (128 bytes a row), each block 128-byte
// swizzled: chunk c % 8 of row r sits at (c % 8) ^ (r % 8).
__device__ __forceinline__ uint32_t sw128(int rows, int r, int c) {
  return (uint32_t)((c >> 3) * rows * ROW_BYTES + r * ROW_BYTES +
                    (((c & 7) ^ (r & 7)) << 4));
}

// Copies rows [row0, row0 + ROWS) of a (n, D) bf16 matrix into a swizzled
// shared tile with cp.async; rows at or past `limit` are filled with zeros.
template <int ROWS, int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const __nv_bfloat16* g,
                                          int row0, int limit, int tid) {
  constexpr int CH = D / 8;    // 16-byte chunks a row
  static_assert(ROWS * CH % THREADS == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < ROWS * CH / THREADS; ++it) {
    const int i = tid + it * THREADS;
    const int r = i / CH, c = i - r * CH;
    const int gr = row0 + r;
    const bool in = gr < limit;
    const __nv_bfloat16* src = g + (int64_t)(in ? gr : 0) * D + c * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     dst + sw128(ROWS, r, c)),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  }
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand whose
// 8-row groups lie 1024 bytes apart.  No single wgmma here spans two
// 64-element column blocks, so the one other stride a layout can name is
// 1024 too: the stride byte offset (bits 32-45) and the leading byte offset
// (bits 16-29) both hold it, whichever of the two the MN-major B operand
// (V) reads as its step between 8-key groups.
__device__ __forceinline__ uint64_t desc(uint32_t saddr) {
  constexpr uint64_t kGroup = 1024 >> 4;
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (kGroup << 16) |
         (kGroup << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void commit_and_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Ties the registers to this point, so that no read of an accumulator
// moves above the wait.
__device__ __forceinline__ void hold(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_ACC32(d)                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),     \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),            \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),        \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),        \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),        \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),        \
      "+f"(d[31])
#define WG_OUT32                                                             \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31}"

// d (64 x 64, f32) (+)= A (64 x 16) B (16 x 64), A and B K-major in shared
// memory; scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t da,
                                       uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_OUT32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32(d)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, f32) += A (64 x 16, bf16 pairs in registers) B (16 x 64), B
// MN-major in shared memory.
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_OUT32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int D>
struct Smem {
  static constexpr int Q = BQ * D * 2;
  static constexpr int KV = BK * D * 2;                   // one K or V tile
  static constexpr size_t bytes = Q + 4 * KV + 1024;      // + alignment
};

// Register fragments (the wgmma accumulator layout): thread `lane` of warp
// w of a warpgroup holds, for column block j (8 columns), rows
// 16 w + lane / 4 (registers 4 j, 4 j + 1) and that + 8 (4 j + 2, 4 j + 3),
// columns 8 j + 2 (lane % 4) + {0, 1}.  The S fragment of 16 keys, rounded
// to bf16 pairs, is in that order the A fragment of P V.
template <int D>
__global__ void __launch_bounds__(THREADS, D == 64 ? 2 : 1)
flash_wgmma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int HQ, int HKV, int SQ,
                   int SK, int causal, float scale_log2) {
  constexpr int NB = D / 64;         // 64-wide column blocks of D
  constexpr int KS = D / 16;         // k16 steps of Q K^T
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base;               // then K stages 0, 1, V 0, 1
  const uint32_t sK = base + S::Q, sV = base + S::Q + 2 * S::KV;

  const int tid = threadIdx.x;
  const int wgi = tid >> 7;                  // warpgroup: rows 64 wgi..
  const int warp = (tid & 127) >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.x;
  const int hq = bh % HQ;
  const int b = bh / HQ;
  const int hk = hq / (HQ / HKV);
  // Query tiles run last to first: under a causal mask the late tiles do
  // the most work, so they start first and the short ones fill the tail.
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int qw0 = q0 + wgi * 64;
  const int r0 = qw0 + warp * 16 + (lane >> 2);
  const int r1 = r0 + 8;

  const __nv_bfloat16* qb = q + (int64_t)bh * SQ * D;
  const __nv_bfloat16* kb = k + (int64_t)(b * HKV + hk) * SK * D;
  const __nv_bfloat16* vb = v + (int64_t)(b * HKV + hk) * SK * D;

  // Keys past the diagonal of the block's last row are masked for all its
  // rows: a causal block stops there, and each warpgroup at its own.
  const int k_end = causal ? min(SK, q0 + BQ) : SK;
  const int wg_end = causal ? min(k_end, qw0 + 64) : k_end;
  const int n_tiles = (k_end + BK - 1) / BK;

  load_tile<BQ, D>(sQ, qb, q0, SQ, tid);
  if (n_tiles > 0) {
    load_tile<BK, D>(sK, kb, 0, SK, tid);
    load_tile<BK, D>(sV, vb, 0, SK, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float o[NB][32];
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[n][i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t cur = (t & 1) * S::KV, next = S::KV - cur;
    const int k0 = t * BK;
    if (t + 1 < n_tiles) {           // the next tile loads during this one
      load_tile<BK, D>(sK + next, kb, k0 + BK, SK, tid);
      load_tile<BK, D>(sV + next, vb, k0 + BK, SK, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    // the copies are generic-proxy writes; wgmma reads through the async
    // proxy
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    if (k0 < wg_end) {               // uniform over the warpgroup
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        const uint32_t off = (kk & 3) * 32;   // 16 elements in
        mma_ss(s,
               desc(sQ + (kk >> 2) * BQ * ROW_BYTES + wgi * 64 * ROW_BYTES +
                    off),
               desc(sK + cur + (kk >> 2) * BK * ROW_BYTES + off), kk > 0);
      }
      commit_and_wait();
      hold(s);

      // mask, scale (log2 domain), online softmax on the fragment
      const bool need_mask =
          k0 + BK > SK || (causal && k0 + BK - 1 > qw0);
      const int cb = k0 + 2 * (lane & 3);
      float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x0 = s[4 * j + e] * scale_log2;
          float x1 = s[4 * j + 2 + e] * scale_log2;
          if (need_mask) {
            const int key = cb + 8 * j + e;
            if (key >= SK || (causal && key > r0)) x0 = NEG_INF;
            if (key >= SK || (causal && key > r1)) x1 = NEG_INF;
          }
          s[4 * j + e] = x0;
          s[4 * j + 2 + e] = x1;
          mx0 = fmaxf(mx0, x0);
          mx1 = fmaxf(mx1, x1);
        }
      // a row's 64 columns lie in the 4 lanes of one quad
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[4 * j + e] = exp2f(s[4 * j + e] - mn0);
          s[4 * j + 2 + e] = exp2f(s[4 * j + 2 + e] - mn1);
          ls0 += s[4 * j + e];
          ls1 += s[4 * j + 2 + e];
        }
      l0 = l0 * a0 + ls0;              // this thread's columns; summed
      l1 = l1 * a1 + ls1;              // over the quad at the end
#pragma unroll
      for (int n = 0; n < NB; ++n)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[n][4 * j] *= a0;
          o[n][4 * j + 1] *= a0;
          o[n][4 * j + 2] *= a1;
          o[n][4 * j + 3] *= a1;
        }
      uint32_t p[4][4];                // P in bf16: the A fragment of P V
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          p[ks][i] = pack_bf16(s[8 * ks + 2 * i], s[8 * ks + 2 * i + 1]);

      fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int n = 0; n < NB; ++n)
          mma_rs(o[n], p[ks],
                 desc(sV + cur + n * BK * ROW_BYTES + ks * 16 * ROW_BYTES));
      commit_and_wait();
#pragma unroll
      for (int n = 0; n < NB; ++n) hold(o[n]);
    }
    __syncthreads();                 // the stage is free for tile t + 2
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = out + (int64_t)bh * SQ * D;
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n * 64 + 8 * j + 2 * (lane & 3);
      if (r0 < SQ)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r0 * D + col) =
            __floats2bfloat162_rn(o[n][4 * j] / d0, o[n][4 * j + 1] / d0);
      if (r1 < SQ)
        *reinterpret_cast<__nv_bfloat162*>(ob + (int64_t)r1 * D + col) =
            __floats2bfloat162_rn(o[n][4 * j + 2] / d1, o[n][4 * j + 3] / d1);
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int HQ, int HKV, int SQ, int SK, int causal,
                   float scale, cudaStream_t stream) {
  auto kern = flash_wgmma_kernel<D>;
  const size_t smem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * HQ, (SQ + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      HQ, HKV, SQ, SK, causal, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace wg

template <typename T>
cudaError_t cuda_core(int D, const void* q, const void* k, const void* v,
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

bool wgmma_route(long long D, int dtype) {
  return dtype == 1 && (D == 64 || D == 128);
}

}  // namespace

// 1 when (D, dtype) runs on the tensor cores (flash_wgmma_kernel), 0 when it
// runs on the CUDA cores (flash_fwd_kernel).  dtype: 0 float32, 1 bfloat16.
extern "C" int repro_flash_attention_route(long long D, int dtype) {
  return wgmma_route(D, dtype) ? 1 : 0;
}

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 on success); the
// wrapper has checked shapes, types, head dims and 16-byte alignment before
// the call.
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
  cudaError_t err;
  if (wgmma_route(D, dtype))
    err = D == 64 ? wg::launch<64>(q, k, v, out, (int)B, (int)HQ, (int)HKV,
                                   (int)SQ, (int)SK, causal, scale, s)
                  : wg::launch<128>(q, k, v, out, (int)B, (int)HQ, (int)HKV,
                                    (int)SQ, (int)SK, causal, scale, s);
  else if (dtype == 0)
    err = cuda_core<float>((int)D, q, k, v, out, (int)B, (int)HQ, (int)HKV,
                           (int)SQ, (int)SK, causal, scale, s);
  else
    err = cuda_core<__nv_bfloat16>((int)D, q, k, v, out, (int)B, (int)HQ,
                                   (int)HKV, (int)SQ, (int)SK, causal, scale,
                                   s);
  return (int)err;
}
