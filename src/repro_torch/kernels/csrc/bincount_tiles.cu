// bincount_tiles: per-tile bucket histogram C, cross-tile exclusive prefix P
// and in-tile exclusive bucket offsets F of a (B, T, tile_n) int32 id array:
// B independent queries of T tiles each, P restarting at each query.
//
// Replaces the Pallas kernel src/repro/kernels/bincount.py::bincount_tiles
// (body _bincount_tiles_kernel), and that kernel under jax.vmap, whose grid
// gains a batch axis.  Contract: ids < 0 or >= V are ignored; outputs are
// three (B, T, V) int32 arrays, exact.
//
// What bounds it on an H100: bytes.  The function reads B*T*tile_n*4 bytes
// and writes 3*B*T*V*4; the counting itself is one shared-memory atomic per id.
//
// Design, for V up to kSmemBuckets (and fewer than 2^30 ids a query): one
// launch that reads the ids once and writes C, P and F once each.  The TPU kernel
// gets P from a carry in VMEM that works only because its grid runs in
// order; here the carry crosses blocks by decoupled look-back over groups of
// tiles, bucket by bucket, as Onesweep's digit counts do (Adinets & Merrill,
// "Onesweep: A Faster Least Significant Digit Radix Sort for GPUs", 2022):
// - a block takes the next group of G consecutive tiles from an atomic
//   counter (the scratch's first word), so its predecessors have started.
//   G = kGroupBytes / (4 V), at most 8 (8 at V = 2048): the G histograms
//   fill 64 KB of dynamic shared memory at most, room for 3 blocks an SM.
//   A group never spans two queries: query b owns groups
//   [b ceil(T/G), (b+1) ceil(T/G)), the last one short when G does not
//   divide T;
// - counting: 16-byte streaming loads of the ids (read once), kUnroll in
//   flight a thread across the group's rows (scalar ones when
//   tile_n % 4 != 0 or the base is not 16-byte aligned), one shared-memory
//   atomic an id;
// - a status word per (group, bucket) holds a flag in its top 2 bits (none,
//   aggregate, inclusive) and a count in the other 30, which hold since a
//   query has fewer than 2^30 ids.  The group publishes its column totals as
//   aggregates first (a query's first group as inclusive prefixes, so every
//   look-back stops there and P restarts at each query),
//   then writes C and F, each tile's F scanned by warps in bucket order;
// - a lane owns runs of 4 consecutive buckets (V % 4 == 0; else runs of 1):
//   shared memory, C, P, F and the status words move as 16-byte accesses
//   (C, P and F as streaming stores), and consecutive lanes touch
//   consecutive runs (no bank conflict);
// - look-back: each thread walks back along its own runs, reading the words
//   of 4 predecessor groups at a time and adding counts until each bucket
//   meets an inclusive one, and publishes its buckets' inclusive prefixes at
//   once: no block barrier and no fence, since a flag and its count travel
//   in one 32-bit word (relaxed loads and stores at gpu scope);
// - it then writes its tiles' P rows from that exclusive prefix and the
//   histograms still in shared memory.  Nothing of C is read back from
//   device memory.
// The counter and the status words are zeroed on the stream by
// repro_bincount_tiles itself, before the launch: B ceil(T / G) V 4 bytes
// (12.6 MB at B = 1, T = 12,288, V = 2048).
//
// Above kSmemBuckets (kernel_fits admits V up to about 2^21), or from 2^30
// ids a query on, the global route: the counts go by global atomics into a
// zeroed C, a row-scan kernel writes F (both over the B T rows), and P is a
// three-pass column scan over each query's C (per-chunk column sums, a scan
// down the query's chunks, each chunk's running prefix).
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;
constexpr long long kGroupBytes = 64 * 1024;   // shared histograms a block
constexpr int kUnroll = 8;                     // 16-byte id loads in flight
constexpr int kPer = 2;                        // bucket runs a thread walks
constexpr int kWindow = 4;                     // predecessors a read
constexpr unsigned kCountMask = (1u << 30) - 1;
constexpr long long kMaxIds = 1LL << 30;       // counts fit 30 bits below
constexpr long long kCounterBytes = 16;
constexpr int kScanThreads = 1024;
constexpr long long kChunkRows = 64;     // rows of C per chunk of the column scan
constexpr long long kSmemBuckets = 48 * 1024;   // 192 KB of shared histogram

// Tiles a block counts on the single-pass route; 0 for the global route.
// The limits hold per query, whatever the batch.
inline int group_tiles(long long T, long long tile_n, long long V) {
  if (V > kSmemBuckets || T * tile_n >= kMaxIds) return 0;
  const long long g = kGroupBytes / (4 * V);
  return (int)(g < 1 ? 1 : g > kMaxGroup ? kMaxGroup : g);
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// Q consecutive ints (a run of buckets): Q = 4 moves them as one 16-byte
// access (V % 4 == 0, so every row starts 16-byte aligned), Q = 1 one by one.
template <int Q> struct Run {
  int v[Q];
  __device__ void load(const int* p) {
    if constexpr (Q == 4) {
      const int4 q = *reinterpret_cast<const int4*>(p);
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      v[0] = *p;
    }
  }
  // an output row in device memory, written once and not read here again
  __device__ void store_out(int* p) const {
    if constexpr (Q == 4)
      __stcs(reinterpret_cast<int4*>(p), make_int4(v[0], v[1], v[2], v[3]));
    else
      __stcs(p, v[0]);
  }
  __device__ void store(int* p) const {
    if constexpr (Q == 4)
      *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
    else
      *p = v[0];
  }
  // the status words of a run (each word is read and written whole)
  __device__ void load_words(const unsigned* p) {
    if constexpr (Q == 4) {
      unsigned a, b, c, d;
      asm volatile("ld.relaxed.gpu.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(a), "=r"(b), "=r"(c), "=r"(d) : "l"(p) : "memory");
      v[0] = (int)a; v[1] = (int)b; v[2] = (int)c; v[3] = (int)d;
    } else {
      v[0] = (int)lookback::ld_relaxed(p);
    }
  }
  __device__ void store_words(unsigned* p) const {
    if constexpr (Q == 4)
      asm volatile("st.relaxed.gpu.v4.u32 [%0], {%1, %2, %3, %4};"
                   ::"l"(p), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
                   : "memory");
    else
      lookback::st_relaxed(p, (unsigned)v[0]);
  }
};

__device__ __forceinline__ int word_of(unsigned flag, int count) {
  return (int)(flag << 30 | (unsigned)count);
}

__device__ __forceinline__ void hit(int* h, int id, unsigned V) {
  if ((unsigned)id < V) atomicAdd(h + id, 1);
}

// Counts the ids of the group's ng tiles (consecutive rows of tile_n ids
// from row) into hist, tile g into hist + g V.  With 16-byte loads the
// group's rows are one range of vectors, kUnroll of them in flight a thread.
__device__ void count_group(const int* __restrict__ row, int ng,
                            long long tile_n, unsigned V, int vec, int* hist) {
  if (vec) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
    const unsigned nv = (unsigned)(tile_n / 4);
    const unsigned total = ng * nv;
    for (unsigned b = 0; b < total; b += kThreads * kUnroll) {
      int4 q[kUnroll];
      unsigned g[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const unsigned i = b + u * kThreads + threadIdx.x;
        q[u] = i < total ? __ldcs(r4 + i) : make_int4(-1, -1, -1, -1);
        g[u] = i < total ? i / nv : 0;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        int* h = hist + g[u] * V;
        hit(h, q[u].x, V);
        hit(h, q[u].y, V);
        hit(h, q[u].z, V);
        hit(h, q[u].w, V);
      }
    }
    return;
  }
  for (int g = 0; g < ng; ++g) {
    const int* r = row + g * tile_n;
    for (long long b = 0; b < tile_n; b += kThreads * kUnroll) {
      int q[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long i = b + u * kThreads + threadIdx.x;
        q[u] = i < tile_n ? __ldcs(r + i) : -1;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) hit(hist + g * V, q[u], V);
    }
  }
}

// Writes the C and F rows of the group's ng tiles from their histograms,
// Q buckets a lane.  kWarps / G warps share a tile, each scanning one
// segment of its buckets after the segments' totals meet in shared memory.
template <int Q>
__device__ void write_c_f(const int* hist, int G, int ng, int V,
                          int* __restrict__ C, int* __restrict__ F,
                          int* seg_total, int lane, int warp) {
  constexpr int kStep = 32 * Q;
  const int per_tile = kWarps / G;
  const int g = warp / per_tile;
  const int seg = warp % per_tile;
  const int seg_len = ((V + per_tile - 1) / per_tile + kStep - 1) / kStep * kStep;
  const int lo = min(V, seg * seg_len);
  const int hi = min(V, lo + seg_len);
  const bool active = g < ng;
  const int* h = hist + (long long)g * V;
  int carry = 0;
  if (per_tile > 1) {
    int s = 0;
    if (active)
      for (int b = lo + lane; b < hi; b += 32) s += h[b];
    s = warp_sum(s);
    if (lane == 0) seg_total[warp] = s;
    __syncthreads();
    for (int k = 0; k < seg; ++k) carry += seg_total[g * per_tile + k];
  }
  if (!active) return;
  int* c_row = C + (long long)g * V;
  int* f_row = F + (long long)g * V;
  for (int b0 = lo; b0 < hi; b0 += kStep) {
    const int b = b0 + lane * Q;      // hi - b is a multiple of Q
    Run<Q> c, f;
    if (b < hi) c.load(h + b);
    else
#pragma unroll
      for (int q = 0; q < Q; ++q) c.v[q] = 0;
    int s = 0;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      f.v[q] = s;
      s += c.v[q];
    }
    const int incl = warp_inclusive_scan(s, lane);
    const int before = carry + incl - s;
#pragma unroll
    for (int q = 0; q < Q; ++q) f.v[q] += before;
    if (b < hi) {
      c.store_out(c_row + b);
      f.store_out(f_row + b);
    }
    carry += __shfl_sync(0xffffffffu, incl, 31);
  }
}

// Exclusive prefix, over the groups before k, of this thread's bucket runs
// b0 + m kThreads Q (m < kPer): the walk back along each run's status words,
// kWindow predecessor groups a read, until each bucket meets an inclusive
// one.  A run passes a group only once none of its open buckets reads kNone
// there; it reads that group again next time.
template <int Q>
__device__ __forceinline__ void look_back(const unsigned* word, long long k,
                                          int V, int b0, Run<Q> (&pre)[kPer]) {
  long long next[kPer];        // the next group to read, -1 once closed
  unsigned open[kPer];         // bit q: bucket q still walks
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
#pragma unroll
    for (int q = 0; q < Q; ++q) pre[m].v[q] = 0;
    const bool in = b0 + m * kThreads * Q < V;
    next[m] = in ? k - 1 : -1;
    open[m] = in ? (1u << Q) - 1 : 0;
  }
  long long spins = 0;
  for (;;) {
    Run<Q> w[kPer][kWindow];
#pragma unroll
    for (int m = 0; m < kPer; ++m)
#pragma unroll
      for (int u = 0; u < kWindow; ++u)
        if (next[m] - u >= 0)
          w[m][u].load_words(word + (next[m] - u) * V + b0 + m * kThreads * Q);
    bool walking = false;
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
#pragma unroll
      for (int u = 0; u < kWindow; ++u) {
        if (next[m] < 0) break;
        bool ready = true;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          if ((open[m] >> q & 1) &&
              ((unsigned)w[m][u].v[q] >> 30) == lookback::kNone)
            ready = false;
        if (!ready) break;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          if (!(open[m] >> q & 1)) continue;
          pre[m].v[q] += (int)((unsigned)w[m][u].v[q] & kCountMask);
          if (((unsigned)w[m][u].v[q] >> 30) == lookback::kInclusive)
            open[m] &= ~(1u << q);
        }
        next[m] = open[m] ? next[m] - 1 : -1;
      }
      walking |= next[m] >= 0;
    }
    if (!walking) return;
    lookback::count_spin(spins);
  }
}

template <int Q>
__global__ void __launch_bounds__(kThreads)
count_groups(const int* __restrict__ tiles, long long T, long long tile_n,
             int V, int G, long long per_query, int vec, int* __restrict__ C,
             int* __restrict__ P, int* __restrict__ F, unsigned* counter,
             unsigned* word) {
  extern __shared__ int4 smem4[];
  int* hist = reinterpret_cast<int*>(smem4);     // G x V
  __shared__ long long s_group;
  __shared__ int s_seg[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_group = atomicAdd(counter, 1u);
  const int cells = G * V;
  for (int i = threadIdx.x; i < cells / 4; i += kThreads)
    smem4[i] = make_int4(0, 0, 0, 0);
  for (int i = cells / 4 * 4 + threadIdx.x; i < cells; i += kThreads)
    hist[i] = 0;
  __syncthreads();
  // k numbers the groups of all queries; kq within query k / per_query,
  // whose tile t0 is row r0 of the (B T, tile_n) ids
  const long long k = s_group;
  const long long kq = k % per_query;
  const long long t0 = kq * G;
  const long long r0 = k / per_query * T + t0;
  const int ng = (int)min((long long)G, T - t0);
  unsigned* mine = word + k * V;

  count_group(tiles + r0 * tile_n, ng, tile_n, (unsigned)V, vec, hist);
  __syncthreads();

  // the group's column totals: aggregates (a query's first group: inclusive
  // prefixes, where every look-back of the query stops)
  const unsigned flag = kq == 0 ? lookback::kInclusive : lookback::kAggregate;
  for (int b = threadIdx.x * Q; b < V; b += kThreads * Q) {
    Run<Q> a, c;
#pragma unroll
    for (int q = 0; q < Q; ++q) a.v[q] = 0;
    for (int g = 0; g < ng; ++g) {
      c.load(hist + g * V + b);
#pragma unroll
      for (int q = 0; q < Q; ++q) a.v[q] += c.v[q];
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) a.v[q] = word_of(flag, a.v[q]);
    a.store_words(mine + b);
  }

  write_c_f<Q>(hist, G, ng, V, C + r0 * V, F + r0 * V, s_seg, lane, warp);
  __syncthreads();

  // run by run, each thread its own: hist[g] <- counts of the group's
  // tiles before g, the walk back, the inclusive prefixes out, the P rows
  int* p = P + r0 * V;
  for (int b0 = threadIdx.x * Q; b0 < V; b0 += kThreads * Q * kPer) {
    Run<Q> total[kPer], pre[kPer];
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int b = b0 + m * kThreads * Q;
#pragma unroll
      for (int q = 0; q < Q; ++q) total[m].v[q] = 0;
      if (b < V)
        for (int g = 0; g < ng; ++g) {
          Run<Q> c;
          c.load(hist + g * V + b);
          total[m].store(hist + g * V + b);
#pragma unroll
          for (int q = 0; q < Q; ++q) total[m].v[q] += c.v[q];
        }
    }
    if (kq > 0) {
      look_back<Q>(word, k, V, b0, pre);
#pragma unroll
      for (int m = 0; m < kPer; ++m) {
        const int b = b0 + m * kThreads * Q;
        if (b >= V) continue;
        Run<Q> w;
#pragma unroll
        for (int q = 0; q < Q; ++q)
          w.v[q] = word_of(lookback::kInclusive, pre[m].v[q] + total[m].v[q]);
        w.store_words(mine + b);
      }
    } else {
#pragma unroll
      for (int m = 0; m < kPer; ++m)
#pragma unroll
        for (int q = 0; q < Q; ++q) pre[m].v[q] = 0;
    }
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      const int b = b0 + m * kThreads * Q;
      if (b >= V) continue;
      for (int g = 0; g < ng; ++g) {
        Run<Q> e;
        e.load(hist + g * V + b);
#pragma unroll
        for (int q = 0; q < Q; ++q) e.v[q] += pre[m].v[q];
        e.store_out(p + (long long)g * V + b);
      }
    }
  }
}

// Exclusive scan of one int per thread across the block (blockDim.x a
// multiple of 32, at most 1024).  Returns the thread's exclusive prefix and
// stores the block total in *total, readable after the call returns.
__device__ int block_exclusive_scan(int v, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int incl = warp_inclusive_scan(v, lane);
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < n_warps ? warp_sums[lane] : 0;
    const int wi = warp_inclusive_scan(w, lane);
    if (lane < n_warps) warp_sums[lane] = wi - w;
    if (lane == 31) *total = wi;
  }
  __syncthreads();
  int out = warp_sums[warp] + incl - v;
  __syncthreads();
  return out;
}

// Large-V counting: global atomics into a zeroed C.
__global__ void count_tiles_global(const int* __restrict__ tiles, long long tile_n,
                                   long long V, int* __restrict__ C) {
  const long long t = blockIdx.x;
  const int* row = tiles + t * tile_n;
  int* c_row = C + t * V;
  for (long long i = threadIdx.x; i < tile_n; i += blockDim.x) {
    const int id = row[i];
    if (id >= 0 && id < V) atomicAdd(&c_row[id], 1);
  }
}

// Large-V in-tile offsets: one block per row, exclusive scan over V in
// block-wide steps with a running carry.
__global__ void row_exclusive_scan(const int* __restrict__ C, long long V,
                                   int* __restrict__ F) {
  __shared__ int warp_sums[32];
  __shared__ int total;
  const long long t = blockIdx.x;
  const int* c_row = C + t * V;
  int* f_row = F + t * V;
  int carry = 0;
  for (long long base = 0; base < V; base += blockDim.x) {
    const long long b = base + threadIdx.x;
    const int v = b < V ? c_row[b] : 0;
    const int ex = block_exclusive_scan(v, warp_sums, &total);
    if (b < V) f_row[b] = carry + ex;
    carry += total;
  }
}

// Column scan over each query's T rows of the (B T, V) matrix C, with
// n_chunks chunks a query.  Pass 1: S[b, c, v] = sum of C[b, t, v] over the
// rows t of chunk c.
__global__ void chunk_column_sums(const int* __restrict__ C, long long B,
                                  long long T, long long V, long long n_chunks,
                                  int* __restrict__ S) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n_chunks * V) return;
  const long long b = idx / (n_chunks * V);
  const long long c = idx / V % n_chunks, v = idx % V;
  const long long t1 = min(T, (c + 1) * kChunkRows);
  const int* cb = C + b * T * V;
  int s = 0;
  for (long long t = c * kChunkRows; t < t1; ++t) s += cb[t * V + v];
  S[idx] = s;
}

// Pass 2: exclusive scan of S down each query's chunks, one thread per
// (query, column).
__global__ void chunk_scan(int* __restrict__ S, long long B, long long V,
                           long long n_chunks) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * V) return;
  int* sb = S + idx / V * n_chunks * V + idx % V;
  int run = 0;
  for (long long c = 0; c < n_chunks; ++c) {
    const int s = sb[c * V];
    sb[c * V] = run;
    run += s;
  }
}

// Pass 3: P[b, t, v] = S[b, c, v] + the counts of the earlier rows of chunk c.
__global__ void chunk_prefix(const int* __restrict__ C, const int* __restrict__ S,
                             long long B, long long T, long long V,
                             long long n_chunks, int* __restrict__ P) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= B * n_chunks * V) return;
  const long long b = idx / (n_chunks * V);
  const long long c = idx / V % n_chunks, v = idx % V;
  const long long t1 = min(T, (c + 1) * kChunkRows);
  const long long base = b * T * V;
  int run = S[idx];
  for (long long t = c * kChunkRows; t < t1; ++t) {
    P[base + t * V + v] = run;
    run += C[base + t * V + v];
  }
}

inline unsigned grid_for(long long n, int threads) {
  return (unsigned)((n + threads - 1) / threads);
}

cudaError_t run_global(const int* tiles, long long B, long long T,
                       long long tile_n, long long V, int* C, int* P, int* F,
                       int* scratch, cudaStream_t s) {
  const long long rows = B * T;
  cudaError_t err = cudaMemsetAsync(C, 0, (size_t)rows * V * sizeof(int), s);
  if (err != cudaSuccess) return err;
  count_tiles_global<<<(unsigned)rows, kThreads, 0, s>>>(tiles, tile_n, V, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  row_exclusive_scan<<<(unsigned)rows, kScanThreads, 0, s>>>(C, V, F);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const long long n_chunks = (T + kChunkRows - 1) / kChunkRows;
  chunk_column_sums<<<grid_for(B * n_chunks * V, kThreads), kThreads, 0, s>>>(
      C, B, T, V, n_chunks, scratch);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_scan<<<grid_for(B * V, kThreads), kThreads, 0, s>>>(scratch, B, V,
                                                            n_chunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  chunk_prefix<<<grid_for(B * n_chunks * V, kThreads), kThreads, 0, s>>>(
      C, scratch, B, T, V, n_chunks, P);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Tiles a block counts on the single-pass route (8 at V = 2048), or 0 for
// the global route (V above 48 Ki buckets, or 2^30 ids or more a query).
// The batch B changes neither.
int repro_bincount_tiles_group(long long B, long long T, long long tile_n,
                               long long V) {
  (void)B;
  return group_tiles(T, tile_n, V);
}

// Bytes of scratch repro_bincount_tiles needs.  Single pass: a 16-byte
// group counter and a status word per (group of tiles, bucket), groups
// counted over all B queries; global route: one V-vector per chunk of 64
// rows of each query.
long long repro_bincount_tiles_scratch_bytes(long long B, long long T,
                                             long long tile_n, long long V) {
  const int G = group_tiles(T, tile_n, V);
  if (G == 0) return B * ((T + kChunkRows - 1) / kChunkRows) * V * 4;
  return kCounterBytes + B * ((T + G - 1) / G) * V * 4;
}

// tiles: (B, T, tile_n) int32; C, P, F: (B, T, V) int32; scratch: see
// above.  Requires B >= 1, T >= 1 and V >= 1.  Single pass: one memset of
// the counter and status words, then one kernel launch.  Returns a
// cudaError_t, 0 on success.
int repro_bincount_tiles(const int* tiles, long long B, long long T,
                         long long tile_n, long long V, int* C, int* P, int* F,
                         void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int G = group_tiles(T, tile_n, V);
  if (G == 0)
    return run_global(tiles, B, T, tile_n, V, C, P, F,
                      static_cast<int*>(scratch), s);
  const long long per_query = (T + G - 1) / G;
  const long long groups = B * per_query;
  cudaError_t err =
      cudaMemsetAsync(scratch, 0, kCounterBytes + groups * V * 4, s);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)G * V * sizeof(int);
  const int vec = tile_n % 4 == 0 &&
                  reinterpret_cast<unsigned long long>(tiles) % 16 == 0;
  unsigned* counter = static_cast<unsigned*>(scratch);
  unsigned* word =
      reinterpret_cast<unsigned*>(static_cast<char*>(scratch) + kCounterBytes);
  const bool quad = V % 4 == 0 &&
                    (reinterpret_cast<unsigned long long>(C) |
                     reinterpret_cast<unsigned long long>(P) |
                     reinterpret_cast<unsigned long long>(F)) % 16 == 0;
  auto kernel = quad ? count_groups<4> : count_groups<1>;
  // (the static shared memory counts against the same 48 KB default)
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)groups, kThreads, smem, s>>>(
      tiles, T, tile_n, (int)V, G, per_query, vec, C, P, F, counter, word);
  return cudaGetLastError();
}

}  // extern "C"
