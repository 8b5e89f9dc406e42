// Status words of a decoupled look-back (Merrill & Garland, "Single-pass
// Parallel Prefix Scan with Decoupled Look-back", NVIDIA 2016), shared by
// prefix_scan.cu and bincount_tiles.cu.
//
// A block takes the next tile (or group of tiles) from an atomic counter,
// so every tile with a smaller id has started and runs to the point where
// it publishes its aggregate without waiting on anyone: a block that spins
// on a predecessor never waits on one that is not resident.  A tile's
// status goes from kNone to kAggregate (its own sum) to kInclusive (the
// sum of everything up to and including it); the first tile publishes
// kInclusive at once.  A look-back adds aggregates until it meets an
// inclusive prefix and waits only while a status reads kNone.
//
// Memory order: each status is one 32- or 64-bit word that holds its flag
// beside its value (or, for a float64, a value whose bits differ from the
// unwritten pattern), written and read whole with relaxed accesses at gpu
// scope.  A reader never needs a value written by another store than the
// one it reads, so no fence or release/acquire pair is needed.  Every spin
// is bounded: past kMaxSpin polls the kernel traps, so a fault ends in a
// launch error that the wrapper raises, not in a hung card.
#pragma once

#include <cuda_runtime.h>

namespace lookback {

constexpr unsigned kNone = 0;
constexpr unsigned kAggregate = 1;
constexpr unsigned kInclusive = 2;
constexpr long long kMaxSpin = 1LL << 22;

__device__ __forceinline__ void st_relaxed(unsigned* p, unsigned v) {
  asm volatile("st.relaxed.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned ld_relaxed(const unsigned* p) {
  unsigned v;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(double* p, double v) {
  asm volatile("st.relaxed.gpu.f64 [%0], %1;" ::"l"(p), "d"(v) : "memory");
}

__device__ __forceinline__ double ld_relaxed(const double* p) {
  double v;
  asm volatile("ld.relaxed.gpu.f64 %0, [%1];" : "=d"(v) : "l"(p) : "memory");
  return v;
}

// One more poll; traps once a block has polled kMaxSpin times.
__device__ __forceinline__ void count_spin(long long& spins) {
  if (++spins > kMaxSpin) __trap();
}

}  // namespace lookback
