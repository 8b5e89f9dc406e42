// bitonic_sort: sorts each row of a (rows, n) key matrix ascending and moves a
// same-shape 4-byte value matrix along, by a bitonic network.
//
// Replaces the Pallas kernel src/repro/kernels/bitonic_sort.py::bitonic_sort
// (bodies _bitonic_kernel and _compare_exchange).  Same network and the same
// direction rule: for merge size k and distance j, the element pair
// (i, i + j) is put in ascending order iff (i & k) == 0, swapped only when
// strictly out of order, comparing keys alone in their own type.  Rows are
// padded to a power of two n_pad with the key type's maximum (INT32_MAX,
// FLT_MAX), inside the kernel; the padding is never written out.  Not
// stable: ties keep whatever order the network leaves them in, exactly as on
// the TPU, and the result is the same on every input as that of the earlier
// shared-memory kernel, ties included.
//
// What bounds it on an H100: the floor is bytes.  A row of n_pad = 4096 is
// 78 compare-exchange stages over 2048 pairs, about 1.6e5 comparisons per
// 32 KB of keys and values read and written once, and the card's int32 rate
// would clear those comparisons before its memory rate moves the bytes.  The
// earlier kernel ran each of the 78 stages as a pass over shared memory
// between two __syncthreads (scalar loads, a branch, bank conflicts at
// j < 32), at 7 % of the byte floor and slower than torch.sort + gather.
//
// Design: the network runs in registers.  A block of C = 2^LOGC elements
// (C = 4096 for rows up to 4096 wide, then the row: 8192, 16384) has C / 16
// threads, each holding 16 (key, value) pairs.  In layout L(b) thread t
// holds the elements whose index bits b..b+3 are its register number r and
// whose other bits are t's: idx = (t mod 2^b) | r << b | (t >> b) << (b+4).
// A stage of distance j = 2^q with b <= q < b + 4 pairs registers r and
// r | 2^(q-b) of one thread: no synchronisation, no memory.  The stages of
// one merge size run from high bits to low in chunks of four bits at
// b = 0, 4, 8 (or LOGC - 4 at the top), each a compile-time layout, so
// shared-memory addresses are constants from one base.  The direction of
// every pair is known at compile time too: k's bit is a register bit (a
// fixed pattern over r) or a thread bit (one direction for the thread; in
// a warp whose threads differ, the descending ones flip their keys, NOT or
// the sign, so that every pair ascends), and a compare-exchange is one
// compare, a min, a max and two selects.  Between chunks the block changes
// layout through shared memory, (key, value) packed in one 8-byte word,
// one spare word every 16 so that no layout conflicts on banks; a change
// between L(0) and L(4) stays inside each warp and waits only on the warp.
// A 4096-wide row thus costs 20 layout changes (12 of them warp-local)
// instead of 78 passes.  A block that sorts one whole row of C = n_pad
// (the shuffle's rows) runs the network as a schedule fixed at compile time
// (`full_network`): no loop, no dispatch, and a warp's direction test only
// where k's bit is one of its lanes; other blocks (narrower rows, chunks of
// wider ones) walk the same chunks in a loop.  Rows come in and go out in
// layout L(0), 16 consecutive elements a thread, in 16-byte loads and
// stores.  Rows narrower than C share a block (the direction uses the
// column within the row).  A row wider than kSmemN (up to the 2^18 contract) is cut into
// kSmemN-wide chunks: the chunks are sorted by this kernel, then for each
// merge size k > kSmemN the stages with j >= kSmemN run as global
// compare-exchange launches over a padded work buffer and this kernel
// finishes the stages with j < kSmemN.
//
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W): the two calls of
// a sort query, (4096, 4096) and (12288, 4096) int32, take 0.363 + 0.924
// ms against torch.sort + gather's 0.696 + 1.805 and the earlier kernel's
// 4.48 ms; 4.0 times the byte bound (0.321 ms).
#include <cuda_runtime.h>
#include <cfloat>
#include <climits>
#include <stdint.h>

namespace {

constexpr long long kSmemN = 1 << 14;   // widest row one block sorts
constexpr int kLogE = 4;
constexpr int kE = 1 << kLogE;          // (key, value) pairs a thread holds
constexpr int kGlobalThreads = 256;

template <typename K> __device__ __forceinline__ K key_max();
template <> __device__ __forceinline__ int key_max<int>() { return INT_MAX; }
template <> __device__ __forceinline__ float key_max<float>() { return FLT_MAX; }

__device__ __forceinline__ unsigned key_bits(int k) { return (unsigned)k; }
__device__ __forceinline__ unsigned key_bits(float k) { return __float_as_uint(k); }
template <typename K> __device__ __forceinline__ K key_from(unsigned b);
template <> __device__ __forceinline__ int key_from<int>(unsigned b) { return (int)b; }
template <> __device__ __forceinline__ float key_from<float>(unsigned b) {
  return __uint_as_float(b);
}

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

// The same compare-exchange on registers, without a branch.
template <typename K>
__device__ __forceinline__ void compare_exchange(K& ka, unsigned& va, K& kb,
                                                 unsigned& vb, bool ascending) {
  const bool swap = ascending ? (ka > kb) : (ka < kb);
  const K k1 = swap ? kb : ka, k2 = swap ? ka : kb;
  const unsigned v1 = swap ? vb : va, v2 = swap ? va : vb;
  ka = k1;
  kb = k2;
  va = v1;
  vb = v2;
}

// Element index of thread t's register 0 in layout L(b); register r adds
// r << b.
__device__ __forceinline__ int layout_base(int t, int b) {
  return (t & ((1 << b) - 1)) | ((t >> b) << (b + kLogE));
}

// Shared-memory word of element i: one spare word every 16, so that the
// lanes of a warp hit distinct banks in every layout used (b = 0 or b >= 4).
__device__ __forceinline__ int slot(int i) { return i + (i >> 4); }

// Word offset of register r from register 0 in layout L(B), B = 0 or
// B >= 4: a constant.
template <int B>
__device__ __forceinline__ constexpr int slot_step(int r) {
  return B == 0 ? r : r * ((1 << B) + (1 << (B >= kLogE ? B - kLogE : 0)));
}

template <int B, typename K>
__device__ __forceinline__ void put(const K (&key)[kE], const unsigned (&val)[kE],
                                    uint2* sm, int t) {
  uint2* base = sm + slot(layout_base(t, B));
#pragma unroll
  for (int r = 0; r < kE; ++r)
    base[slot_step<B>(r)] = make_uint2(key_bits(key[r]), val[r]);
}

template <int B, typename K>
__device__ __forceinline__ void get(K (&key)[kE], unsigned (&val)[kE],
                                    const uint2* sm, int t) {
  const uint2* base = sm + slot(layout_base(t, B));
#pragma unroll
  for (int r = 0; r < kE; ++r) {
    const uint2 w = base[slot_step<B>(r)];
    key[r] = key_from<K>(w.x);
    val[r] = w.y;
  }
}

// Layouts L(0) and L(4) give a warp the same elements (index bits 9 and up
// are its warp number in both), so a change between them stays inside each
// warp's part of shared memory and needs only the warp's barrier; the get
// before it, of L(0) or L(4), read only the warp's own part too.
__device__ __forceinline__ void relayout_barrier(int from, int to) {
  if ((from | to) == 4)
    __syncwarp();
  else
    __syncthreads();
}

// Order-reversing bit flip of a key: NOT for int32, the sign for float32
// (so a descending pair of flipped keys is an ascending one, ties and -0.0
// included).
template <typename K> constexpr unsigned kFlip = 0xFFFFFFFFu;
template <> constexpr unsigned kFlip<float> = 0x80000000u;

template <typename K>
__device__ __forceinline__ void flip_keys(K (&key)[kE], unsigned mask) {
#pragma unroll
  for (int r = 0; r < kE; ++r) key[r] = key_from<K>(key_bits(key[r]) ^ mask);
}

// The stages of distances 2^(hi-1) .. 2^B within the registers of layout
// L(B).  DIR 0: every pair ascends; 1: every pair descends; 3, 4, 5: k's
// bit is bit DIR - 2 of the register number (B + DIR - 2 of the index), and
// the pairs of register r ascend iff that bit of r is 0.  The direction of
// each pair is thus known at compile time.
template <int B, int DIR, typename K>
__device__ __forceinline__ void stages(K (&key)[kE], unsigned (&val)[kE], int hi) {
#pragma unroll
  for (int qq = kLogE - 1; qq >= 0; --qq) {
    if (DIR >= 2 && qq >= DIR - 2) continue;     // only distances below k
    if (B + qq >= hi) continue;
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      if (r & (1 << qq)) continue;
      const bool asc = DIR == 0 || (DIR >= 2 && ((r >> (DIR - 2)) & 1) == 0);
      compare_exchange(key[r], val[r], key[r | (1 << qq)], val[r | (1 << qq)],
                       asc);
    }
  }
}

template <int B, typename K>
__device__ __forceinline__ void run_stages(K (&key)[kE], unsigned (&val)[kE],
                                           int hi, int dir) {
  switch (dir) {
    case 0: stages<B, 0>(key, val, hi); break;
    case 1: stages<B, 1>(key, val, hi); break;
    case 3: stages<B, 3>(key, val, hi); break;
    case 4: stages<B, 4>(key, val, hi); break;
    default: stages<B, 5>(key, val, hi); break;
  }
}

// The chunk positions a block of 2^LOGC elements uses: 0, 4, 8 and, for the
// top bits, LOGC - 4 (the same 8 when LOGC = 12).
#define REPRO_BITONIC_CHUNKS(b, CALL) \
  switch (b) {                        \
    case 0: CALL(0); break;           \
    case 4: CALL(4); break;           \
    case 8: CALL(8); break;           \
    default: CALL(LOGC - kLogE);      \
  }

template <int FROM, int TO, typename K>
__device__ __forceinline__ void relayout(K (&key)[kE], unsigned (&val)[kE],
                                         uint2* sm, int t) {
  relayout_barrier(FROM, TO);
  put<FROM>(key, val, sm, t);
  relayout_barrier(FROM, TO);
  get<TO>(key, val, sm, t);
}

// The whole network of a C-wide row (k = 2 .. C) as a compile-time
// schedule: merge size 2^P, distances 2^(HI-1) .. 1 left, registers in
// layout L(CUR).
template <typename K, int LOGC, int P, int HI, int CUR>
__device__ __forceinline__ void full_network(K (&key)[kE], unsigned (&val)[kE],
                                             uint2* sm, int t) {
  if constexpr (P > LOGC) {
    if constexpr (CUR != 0) relayout<CUR, 0>(key, val, sm, t);
  } else if constexpr (HI == 0) {
    full_network<K, LOGC, P + 1, (P + 1 < LOGC ? P + 1 : LOGC), CUR>(key, val, sm, t);
  } else {
    constexpr int B0 = (HI - 1) & ~(kLogE - 1);
    constexpr int B = B0 + kLogE > LOGC ? LOGC - kLogE : B0;
    if constexpr (B != CUR) relayout<CUR, B>(key, val, sm, t);
    if constexpr (P == LOGC) {
      stages<B, 0>(key, val, HI);                 // k = C: all ascend
    } else if constexpr (P >= B && P < B + kLogE) {
      stages<B, 2 + P - B>(key, val, HI);         // k's bit in the registers
    } else {
      constexpr int TB = P < B ? P : P - kLogE;   // k's bit among t's bits
      const bool desc = (t >> TB) & 1;
      if constexpr (TB < 5) {                     // a lane bit: warps mix
        flip_keys(key, desc ? kFlip<K> : 0u);
        stages<B, 0>(key, val, HI);
        flip_keys(key, desc ? kFlip<K> : 0u);
      } else if (desc) {
        stages<B, 1>(key, val, HI);
      } else {
        stages<B, 0>(key, val, HI);
      }
    }
    full_network<K, LOGC, P, B, B>(key, val, sm, t);
  }
}

// The same chunks in a loop, for blocks the fixed schedule does not cover
// (rows narrower than C sharing a block, C-wide chunks of wider rows): the
// stages of one merge size k run from distance k/2 (or C/2) down to 1,
// four bits at a time in layout L(b), b = 0, 4, 8 or LOGC - 4.
template <typename K, int LOGC>
__device__ __forceinline__ void loop_network(K (&key)[kE], unsigned (&val)[kE],
                                             uint2* bitonic_sm, int t,
                                             long long v0, long long n_pad,
                                             long long k_lo, long long k_hi) {
  constexpr int C = 1 << LOGC;
  int cur = 0;                           // the layout the registers are in
  for (long long k = k_lo; k <= k_hi; k <<= 1) {
    // ascending iff (column & k) == 0; k == n_pad: every pair ascends
    const long long kk = k & (n_pad - 1);
    const int k_in = kk < C ? (int)kk : 0;
    const int k_bit = k_in ? __ffs(k_in) - 1 : -1;
    const bool flip = kk >= C && (v0 & kk) != 0;   // a chunk of a wider row
    int hi = min(__ffsll(k) - 1, LOGC);  // distances 2^(hi-1) .. 1 remain
    while (hi > 0) {
      int b = (hi - 1) & ~(kLogE - 1);
      if (b + kLogE > LOGC) b = LOGC - kLogE;
      if (b != cur) {
        relayout_barrier(cur, b);        // the last layout change is read
#define REPRO_PUT(B) put<B>(key, val, bitonic_sm, t)
        REPRO_BITONIC_CHUNKS(cur, REPRO_PUT)
#undef REPRO_PUT
        relayout_barrier(cur, b);
#define REPRO_GET(B) get<B>(key, val, bitonic_sm, t)
        REPRO_BITONIC_CHUNKS(b, REPRO_GET)
#undef REPRO_GET
        cur = b;
      }
      // k's bit is a bit of the register number (dir 3..5; it lies above
      // every distance of the chunk), or of the thread: then one direction
      // for all its pairs, the same over the warp (dir 0 or 1) or not, when
      // the descending threads flip their keys and every pair ascends.
      int dir = 0;
      bool mixed = false;
      unsigned key_mask = 0u;
      if (k_bit >= b && k_bit < b + kLogE) {
        dir = 2 + k_bit - b;
      } else {
        const bool desc = ((k_in & layout_base(t, b)) != 0) != flip;
        const unsigned ballot = __ballot_sync(0xFFFFFFFFu, desc);
        mixed = ballot != 0u && ballot != 0xFFFFFFFFu;
        if (ballot == 0xFFFFFFFFu) dir = 1;
        if (desc) key_mask = kFlip<K>;
      }
      if (mixed) flip_keys(key, key_mask);
#define REPRO_STAGES(B) run_stages<B>(key, val, hi, dir)
      REPRO_BITONIC_CHUNKS(b, REPRO_STAGES)
#undef REPRO_STAGES
      if (mixed) flip_keys(key, key_mask);
      hi = b;
    }
  }
  if (cur != 0) {
    relayout_barrier(cur, 0);
#define REPRO_PUT(B) put<B>(key, val, bitonic_sm, t)
    REPRO_BITONIC_CHUNKS(cur, REPRO_PUT)
#undef REPRO_PUT
    relayout_barrier(cur, 0);
    get<0>(key, val, bitonic_sm, t);
  }
}

// Blocks a multiprocessor should hold: four 256-thread blocks of int32 keys
// (the shuffle's rows) fit in 64 registers a thread; the float32 network
// would spill there, so it keeps what it needs.
template <typename K, int LOGC> constexpr int kMinBlocks = 1;
template <> constexpr int kMinBlocks<int, 12> = 4;

// One block sorts C = 2^LOGC consecutive elements of the virtual padded
// (rows, n_pad) matrix: C / n_pad whole rows, or one C-wide chunk of a row,
// running merge sizes k_lo..k_hi and, for each, the distances j < C.
// Input rows have stride in_n (columns >= in_n are padding); output rows
// stride out_n (columns >= out_n are not written); rows >= rows are padding.
// A block reads its elements wholly before it writes them, so in and out
// may be the same buffer.
template <typename K, int LOGC>
__global__ void __launch_bounds__((1 << LOGC) / kE, kMinBlocks<K, LOGC>)
bitonic_regs(const K* in_k, const unsigned* in_v, long long in_n, K* out_k,
             unsigned* out_v, long long out_n, long long rows, long long n_pad,
             long long k_lo, long long k_hi) {
  constexpr int C = 1 << LOGC;
  extern __shared__ uint2 bitonic_sm[];  // C + C / 16 words
  const int t = threadIdx.x;
  const long long v0 = (long long)blockIdx.x * C;
  const int log_np = __ffsll(n_pad) - 1;
  K key[kE];
  unsigned val[kE];

  // Layout L(0): thread t holds elements 16 t .. 16 t + 15.
  if (n_pad >= kE && (in_n & 3) == 0) {  // one row, 16-byte aligned groups
    const long long v = v0 + (long long)t * kE;
    const long long row = v >> log_np, col0 = v & (n_pad - 1);
#pragma unroll
    for (int g = 0; g < kE / 4; ++g) {
      const long long col = col0 + 4 * g;
      uint4 kw = make_uint4(key_bits(key_max<K>()), key_bits(key_max<K>()),
                            key_bits(key_max<K>()), key_bits(key_max<K>()));
      uint4 vw = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && col < in_n) {
        kw = *reinterpret_cast<const uint4*>(in_k + row * in_n + col);
        vw = *reinterpret_cast<const uint4*>(in_v + row * in_n + col);
      }
      key[4 * g] = key_from<K>(kw.x);
      key[4 * g + 1] = key_from<K>(kw.y);
      key[4 * g + 2] = key_from<K>(kw.z);
      key[4 * g + 3] = key_from<K>(kw.w);
      val[4 * g] = vw.x;
      val[4 * g + 1] = vw.y;
      val[4 * g + 2] = vw.z;
      val[4 * g + 3] = vw.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const long long v = v0 + (long long)t * kE + r;
      const long long row = v >> log_np, col = v & (n_pad - 1);
      const bool real = row < rows && col < in_n;
      key[r] = real ? in_k[row * in_n + col] : key_max<K>();
      val[r] = real ? in_v[row * in_n + col] : 0u;
    }
  }

  if (n_pad == C && k_lo == 2 && k_hi == C)
    full_network<K, LOGC, 1, 1, 0>(key, val, bitonic_sm, t);
  else
    loop_network<K, LOGC>(key, val, bitonic_sm, t, v0, n_pad, k_lo, k_hi);

  if (n_pad >= kE && (out_n & 3) == 0) {
    const long long v = v0 + (long long)t * kE;
    const long long row = v >> log_np, col0 = v & (n_pad - 1);
#pragma unroll
    for (int g = 0; g < kE / 4; ++g) {
      const long long col = col0 + 4 * g;
      if (row < rows && col < out_n) {
        *reinterpret_cast<uint4*>(out_k + row * out_n + col) =
            make_uint4(key_bits(key[4 * g]), key_bits(key[4 * g + 1]),
                       key_bits(key[4 * g + 2]), key_bits(key[4 * g + 3]));
        *reinterpret_cast<uint4*>(out_v + row * out_n + col) = make_uint4(
            val[4 * g], val[4 * g + 1], val[4 * g + 2], val[4 * g + 3]);
      }
    }
  } else {
#pragma unroll
    for (int r = 0; r < kE; ++r) {
      const long long v = v0 + (long long)t * kE + r;
      const long long row = v >> log_np, col = v & (n_pad - 1);
      if (row < rows && col < out_n) {
        out_k[row * out_n + col] = key[r];
        out_v[row * out_n + col] = val[r];
      }
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

template <typename K, int LOGC>
cudaError_t launch_regs(const K* in_k, const unsigned* in_v, long long in_n, K* out_k,
                        unsigned* out_v, long long out_n, long long rows,
                        long long n_pad, long long k_lo, long long k_hi,
                        cudaStream_t s) {
  constexpr long long C = 1LL << LOGC;
  const size_t smem = (size_t)(C + C / 16) * sizeof(uint2);
  auto kern = bitonic_regs<K, LOGC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long long blocks = (rows * n_pad + C - 1) / C;
  kern<<<(unsigned)blocks, (unsigned)(C / kE), smem, s>>>(
      in_k, in_v, in_n, out_k, out_v, out_n, rows, n_pad, k_lo, k_hi);
  return cudaGetLastError();
}

template <typename K>
cudaError_t sort_blocks(int log_c, const K* in_k, const unsigned* in_v, long long in_n,
                        K* out_k, unsigned* out_v, long long out_n, long long rows,
                        long long n_pad, long long k_lo, long long k_hi,
                        cudaStream_t s) {
  switch (log_c) {
    case 12: return launch_regs<K, 12>(in_k, in_v, in_n, out_k, out_v, out_n, rows, n_pad, k_lo, k_hi, s);
    case 13: return launch_regs<K, 13>(in_k, in_v, in_n, out_k, out_v, out_n, rows, n_pad, k_lo, k_hi, s);
    case 14: return launch_regs<K, 14>(in_k, in_v, in_n, out_k, out_v, out_n, rows, n_pad, k_lo, k_hi, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename K>
int launch(const void* keys, const void* vals, void* out_k, void* out_v, void* work_k,
           void* work_v, long long rows, long long n, long long n_pad, cudaStream_t s) {
  const K* ik = static_cast<const K*>(keys);
  const unsigned* iv = static_cast<const unsigned*>(vals);
  K* ok = static_cast<K*>(out_k);
  unsigned* ov = static_cast<unsigned*>(out_v);
  if (n_pad <= kSmemN) {
    int log_c = 12;                      // blocks of at least 4096 elements
    while ((1LL << log_c) < n_pad) ++log_c;
    return sort_blocks<K>(log_c, ik, iv, n, ok, ov, n, rows, n_pad, 2, n_pad, s);
  }
  K* wk = static_cast<K*>(work_k);
  unsigned* wv = static_cast<unsigned*>(work_v);
  cudaError_t err = sort_blocks<K>(14, ik, iv, n, wk, wv, n_pad, rows, n_pad, 2, kSmemN, s);
  if (err != cudaSuccess) return err;
  const long long pairs = rows * (n_pad >> 1);
  long long g = (pairs + kGlobalThreads - 1) / kGlobalThreads;
  if (g > 132LL * 64) g = 132LL * 64;
  for (long long k = 2 * kSmemN; k <= n_pad; k <<= 1) {
    for (long long j = k >> 1; j >= kSmemN; j >>= 1) {
      bitonic_global<K><<<(unsigned)g, kGlobalThreads, 0, s>>>(wk, wv, rows, n_pad, k, j);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    const bool last = k == n_pad;
    err = sort_blocks<K>(14, wk, wv, n_pad, last ? ok : wk, last ? ov : wv,
                         last ? n : n_pad, rows, n_pad, k, k, s);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Widest padded row sorted wholly in one block; wider rows need the
// (rows, n_pad) work buffers.
long long repro_bitonic_smem_width(void) { return kSmemN; }

// keys: (rows, n) int32 (key_is_float = 0) or float32 (1); vals: (rows, n)
// of any 4-byte type; out_k, out_v: (rows, n); work_k, work_v: (rows, n_pad)
// when n_pad > repro_bitonic_smem_width(), else unused.  n_pad is the power
// of two >= n.  All four row arrays 16-byte aligned.  Requires rows >= 1 and
// n >= 1.  Returns a cudaError_t.
int repro_bitonic_sort(const void* keys, const void* vals, void* out_k, void* out_v,
                       void* work_k, void* work_v, long long rows, long long n,
                       long long n_pad, int key_is_float, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (key_is_float)
    return launch<float>(keys, vals, out_k, out_v, work_k, work_v, rows, n, n_pad, s);
  return launch<int>(keys, vals, out_k, out_v, work_k, work_v, rows, n, n_pad, s);
}

}  // extern "C"
