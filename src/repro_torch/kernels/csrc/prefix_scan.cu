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
// Design: one launch that reads x once and writes the result once.  The TPU
// kernel carries the running row sum in VMEM across a grid that runs in
// order; here the carry crosses blocks by decoupled look-back (lookback.cuh):
// - a tile is kTile = 4096 elements of one row: 256 threads, each holding
//   four 16-byte vectors (int4 / float4) laid out so that a warp's load is
//   512 contiguous bytes; loads and stores are streaming (x is read once,
//   the result written once).  A row whose width is not a multiple of 4, or a
//   base that is not 16-byte aligned, takes scalar loads and stores at the
//   same positions; the ragged tail is masked, nothing past a row is read;
// - in registers: a serial scan of each vector's 4 elements, a warp shuffle
//   scan per vector slot, and one shared-memory step across the 8 warps;
// - tile ids come from a per-call atomic counter (the scratch's first word),
//   so a tile's predecessors in its row have always started.  The tile
//   publishes its aggregate, warp 0 looks back over 32 predecessors at a
//   time, summing aggregates until it meets an inclusive prefix, and the
//   tile publishes its own inclusive prefix before writing its outputs.
//   The first tile of a row needs no look-back; a row of one tile needs no
//   status at all;
// - a status is written once as an aggregate and once as an inclusive
//   prefix, and read with one relaxed load at gpu scope: the scratch is all
//   ones until written (one memset of 0xff on the stream, inside
//   repro_prefix_scan), so a status is its own flag and needs no fence;
// - int32: unsigned adds (they wrap without undefined behaviour); the flag
//   and the 32-bit value packed into one 64-bit word;
// - float32: each warp scans its 512 elements in float32; warp offsets and
//   the carry across tiles are float64, so the only rounding beyond a warp
//   is the final one.  The aggregate and the inclusive prefix each have a
//   float64 slot.  Because the look-back adds aggregates in an order that
//   depends on timing, float32 results are not bitwise identical from run
//   to run; int32 results are exact.
#include <cuda_runtime.h>

#include "lookback.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVecs = 4;                      // 16-byte vectors a thread
constexpr int kWarpElems = 32 * kVecs * 4;    // 512
constexpr long long kTile = kWarps * kWarpElems;   // 4096
constexpr long long kCounterBytes = 16;
// What the scratch holds until written: every byte 0xff.  The tile counter
// starts at 2^32 - 1, so the first atomicAdd hands out tile 0.
constexpr unsigned long long kUnset = ~0ull;

// The type a warp's scan runs in, the carry's type, and the tile status.
template <typename T> struct Types;

template <> struct Types<int> {
  using Local = unsigned;
  using Carry = unsigned;
  static __device__ unsigned to_local(int v) { return (unsigned)v; }
  static __device__ int out(unsigned off, unsigned local) {
    return (int)(off + local);
  }
  static __device__ void load4(const int* p, unsigned v[4]) {
    const int4 q = __ldcs(reinterpret_cast<const int4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ void store4(int* p, const int o[4]) {
    __stcs(reinterpret_cast<int4*>(p), make_int4(o[0], o[1], o[2], o[3]));
  }
  // one 64-bit word per tile: flag << 32 | value; all ones until published
  struct Status {
    unsigned long long* word;
    __device__ void publish(long long i, unsigned flag, unsigned v) const {
      lookback::st_relaxed(word + i, (unsigned long long)flag << 32 | v);
    }
    __device__ unsigned wait(long long i, unsigned& v,
                             long long& spins) const {
      unsigned long long w;
      for (;;) {
        w = lookback::ld_relaxed(word + i);
        if (w != kUnset) break;
        lookback::count_spin(spins);
      }
      v = (unsigned)w;
      return (unsigned)(w >> 32);
    }
  };
  static Status status(char* scratch, long long) {
    return {reinterpret_cast<unsigned long long*>(scratch + kCounterBytes)};
  }
  static long long scratch_bytes(long long tiles) {
    return kCounterBytes + 8 * tiles;
  }
};

template <> struct Types<float> {
  using Local = float;
  using Carry = double;
  static __device__ float to_local(float v) { return v; }
  static __device__ float out(double off, float local) {
    return (float)(off + (double)local);
  }
  static __device__ void load4(const float* p, float v[4]) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
  static __device__ void store4(float* p, const float o[4]) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(o[0], o[1], o[2], o[3]));
  }
  // per tile, the aggregate and the inclusive prefix each in a float64 of
  // its own, all ones until published: a value is its own flag, so one
  // relaxed load reads both.  A published value that happens to be all
  // ones (a NaN) is stored as the canonical quiet NaN instead.
  struct Status {
    double* agg;
    double* incl;
    __device__ void publish(long long i, unsigned f, double v) const {
      if ((unsigned long long)__double_as_longlong(v) == kUnset)
        v = __longlong_as_double(0x7ff8000000000000LL);
      lookback::st_relaxed((f == lookback::kAggregate ? agg : incl) + i, v);
    }
    __device__ unsigned wait(long long i, double& v, long long& spins) const {
      for (;;) {
        const double c = lookback::ld_relaxed(incl + i);
        const double a = lookback::ld_relaxed(agg + i);
        if ((unsigned long long)__double_as_longlong(c) != kUnset) {
          v = c;
          return lookback::kInclusive;
        }
        if ((unsigned long long)__double_as_longlong(a) != kUnset) {
          v = a;
          return lookback::kAggregate;
        }
        lookback::count_spin(spins);
      }
    }
  };
  static Status status(char* scratch, long long tiles) {
    double* agg = reinterpret_cast<double*>(scratch + kCounterBytes);
    return {agg, agg + tiles};
  }
  static long long scratch_bytes(long long tiles) {
    return kCounterBytes + 16 * tiles;
  }
};

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Exclusive prefix of the tile at index t of its row (global status index
// tile): warp 0 looks back over 32 predecessors at a time.  Lanes past the
// row's first tile count as inclusive zeros; the first tile is inclusive,
// so the look-back ends there at the latest.
template <typename T>
__device__ typename Types<T>::Carry look_back(const typename Types<T>::Status& st,
                                              long long tile, long long t,
                                              int lane) {
  using C = typename Types<T>::Carry;
  C sum = C(0);
  long long spins = 0;
  for (long long top = t - 1;; top -= 32) {
    const long long q = top - lane;
    C v = C(0);
    unsigned f = lookback::kInclusive;
    if (q >= 0) f = st.wait(tile - t + q, v, spins);
    const unsigned incl = __ballot_sync(0xffffffffu, f == lookback::kInclusive);
    const int stop = incl ? __ffs(incl) - 1 : 31;
    sum += warp_sum<C>(lane <= stop ? v : C(0));
    if (incl) return sum;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_tiles(const T* __restrict__ x, T* __restrict__ out, long long n,
           long long tiles_per_row, int exclusive, int vec,
           typename Types<T>::Status st, unsigned* counter) {
  using L = typename Types<T>::Local;
  using C = typename Types<T>::Carry;
  __shared__ long long s_tile;
  __shared__ L s_warp[kWarps];
  __shared__ C s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u) + 1u;
  __syncthreads();
  const long long tile = s_tile;
  const long long row = tile / tiles_per_row;
  const long long t = tile % tiles_per_row;
  const long long base = t * kTile + warp * kWarpElems;
  const T* xr = x + row * n;
  T* orow = out + row * n;

  // vector j of this thread holds elements e..e+3, e = base + 4 (32 j + lane)
  L v[kVecs][4];
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long e = base + 4 * (32 * j + lane);
    if (vec) {         // n % 4 == 0: a vector lies wholly inside or outside
      if (e < n) {
        Types<T>::load4(xr + e, v[j]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) v[j][k] = L(0);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[j][k] = e + k < n ? Types<T>::to_local(xr[e + k]) : L(0);
    }
  }

  // warp scan of the vector sums, slot by slot; ex[j] is this vector's
  // exclusive prefix inside the warp's 512 elements
  L ex[kVecs];
  L run = L(0);
#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const L s = (v[j][0] + v[j][1]) + (v[j][2] + v[j][3]);
    L incl = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const L u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    const L before = __shfl_up_sync(0xffffffffu, incl, 1);
    ex[j] = run + (lane ? before : L(0));
    run += __shfl_sync(0xffffffffu, incl, 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();

  if (warp == 0) {
    C agg = C(0);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) agg += (C)s_warp[w];
    C prefix = C(0);
    if (tiles_per_row > 1) {
      if (t == 0) {
        if (lane == 0) st.publish(tile, lookback::kInclusive, agg);
      } else {
        if (lane == 0) st.publish(tile, lookback::kAggregate, agg);
        prefix = look_back<T>(st, tile, t, lane);
        if (lane == 0) st.publish(tile, lookback::kInclusive, prefix + agg);
      }
    }
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  C off = s_prefix;
#pragma unroll
  for (int w = 0; w < kWarps; ++w)
    if (w < warp) off += (C)s_warp[w];

#pragma unroll
  for (int j = 0; j < kVecs; ++j) {
    const long long e = base + 4 * (32 * j + lane);
    T o[4];
    L r = ex[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const L incl = r + v[j][k];
      o[k] = Types<T>::out(off, exclusive ? r : incl);
      r = incl;
    }
    if (vec) {
      if (e < n) Types<T>::store4(orow + e, o);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (e + k < n) orow[e + k] = o[k];
    }
  }
}

inline long long tiles_per_row(long long n) { return (n + kTile - 1) / kTile; }

template <typename T>
cudaError_t run(const void* x, void* out, long long rows, long long n,
                int exclusive, void* scratch, cudaStream_t s) {
  const long long per_row = tiles_per_row(n);
  const long long tiles = rows * per_row;
  if (tiles >= (1LL << 31)) return cudaErrorInvalidValue;
  char* sc = static_cast<char*>(scratch);
  cudaError_t err = cudaMemsetAsync(sc, 0xff, Types<T>::scratch_bytes(tiles), s);
  if (err != cudaSuccess) return err;
  const int vec = n % 4 == 0 &&
                  (reinterpret_cast<unsigned long long>(x) |
                   reinterpret_cast<unsigned long long>(out)) % 16 == 0;
  scan_tiles<T><<<(unsigned)tiles, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n, per_row, exclusive,
      vec, Types<T>::status(sc, tiles), reinterpret_cast<unsigned*>(sc));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of scratch repro_prefix_scan needs: a 16-byte tile counter, then a
// status per (row, tile of 4096): 8 bytes for int32, 16 for float32.
long long repro_prefix_scan_scratch_bytes(long long rows, long long n,
                                          int dtype) {
  const long long tiles = rows * tiles_per_row(n);
  return dtype == 0 ? Types<int>::scratch_bytes(tiles)
                    : Types<float>::scratch_bytes(tiles);
}

// x, out: (rows, n) contiguous, dtype 0 int32, 1 float32.  Requires
// rows, n >= 1 and rows * ceil(n / 4096) < 2^31.  One memset of the
// scratch, then one kernel launch.  Returns a
// cudaError_t, 0 on success.
int repro_prefix_scan(const void* x, void* out, long long rows, long long n,
                      int exclusive, int dtype, void* scratch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<int>(x, out, rows, n, exclusive, scratch, s);
  if (dtype == 1) return run<float>(x, out, rows, n, exclusive, scratch, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
