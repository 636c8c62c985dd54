// The hand-off between blocks of the ring-fused kernels (caar.cu,
// tracer.cu): a producer computes one 128-lane tile of s1 into a scratch
// field, and the sweep of a tile reads s1 up to `halo` tiles away, written by
// other blocks. The TPU kernel ran its grid in order and kept s1 in an
// on-chip ring (kernels/ring_fused.py:175-184); the card has no ordered
// grid, so the same schedule is built from tickets and flags:
//
//   * a block takes a ticket with atomicAdd when it starts; tickets are
//     handed out in the order blocks start, so every block holding a lower
//     ticket is already resident;
//   * the block with ticket t < nb produces tile t, stores it, and flags it:
//     __syncthreads, __threadfence, then a release store of the call's epoch;
//   * the same block then sweeps tile j = t - halo: it waits (acquire loads)
//     until tiles j-halo .. j+halo, all <= t, hold the epoch, and reads them
//     with __ldcg (L2; an SM's L1 is not coherent with the others').
//
// A block waits only on tiles of lower or equal tickets, and a producer
// never waits, so the schedule cannot deadlock at any residency. The flags
// keep the epoch of the call that last set them, so they are never cleared;
// the launch resets the ticket counter with a stream-ordered memset. A tile
// that never comes is a fault: the wait traps after about a second.
#pragma once

#include <cuda_runtime.h>

#include "dss_sweep.cuh"

namespace ring {

constexpr long long kSpinLimit = 1LL << 24;   // polls of 64 ns sleep each

struct Args {
  const float* s1;        // the producer's scratch field [rows, e16]
  const float* rsp;       // rspheremp [nrsp, e16]
  const float* mx;        // the mix field [rows, e16], or null
  float* w;               // the swept output [rows, e16]
  unsigned* flags;        // one per tile (per row chunk and tile)
  int* counter;           // the ticket counter, 0 at launch
  unsigned epoch;         // this call's flag value, never 0
  int nrsp, ne, nb, halo;
  float ca, cb;
};

// whether a launch's tables hold: `ntiles` flags fit the buffer, and a
// halo of `halo` tiles of `tile` lanes covers the sweep's reach, 16*ne + 1
// lanes, within one flag a waiting thread (2*halo + 1 <= tile)
inline bool fits(int ntiles, int nflags, int ne, int halo, int tile) {
  return ntiles <= nflags && static_cast<long long>(halo) * tile >=
         16LL * ne + 1 && 2 * halo + 1 <= tile;
}

// the calling block's ticket (every thread gets it)
__device__ __forceinline__ int ticket(int* counter) {
  __shared__ int t;
  if (threadIdx.x == 0) t = atomicAdd(counter, 1);
  __syncthreads();
  return t;
}

// flag a tile once every thread of the block has stored its part
__device__ __forceinline__ void publish(unsigned* flag, unsigned epoch) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(flag), "r"(epoch) : "memory");
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// wait until flags[lo..hi] hold epoch (one thread a flag; hi - lo must be
// below the block size), then let the whole block read those tiles. Returns
// 0 from an asm that cannot move above the barrier: the tile loads add it to
// their addresses, so no compiler can move them above the wait.
__device__ __forceinline__ int wait(const unsigned* flags, int lo, int hi,
                                    unsigned epoch) {
  const int t = lo + static_cast<int>(threadIdx.x);
  if (t <= hi) {
    long long polls = 0;
    while (load_acquire(flags + t) != epoch) {
      if (++polls > kSpinLimit) __trap();
      __nanosleep(64);
    }
    __threadfence();
  }
  __syncthreads();
  int zero;
  asm volatile("mov.u32 %0, 0;" : "=r"(zero) :: "memory");
  return zero;
}

// rows row0 .. row0 + nrows - 1 of the sweep at lane l, stored to w: each the
// swept value of s1 (with kMix ca*mx + cb*that), the sweep kernel's
// expressions, s1 read through L2. `after` is wait()'s token.
template <bool kMix>
__device__ __forceinline__ void emit(const Args& r, int after, size_t row0,
                                     int nrows, int l, int e16) {
  const size_t base = row0 * e16 + after;
  const float* __restrict__ s1 = r.s1 + base;
  const float* __restrict__ mx = r.mx + (kMix ? base : 0);
  float* __restrict__ w = r.w + base;
  for (int i = 0; i < nrows; ++i) {
    const float* xr = s1 + static_cast<size_t>(i) * e16;
    const auto load = [xr](int j) { return __ldcg(xr + j); };
    float res = dss_sweep::swept(load, l, r.ne, r.rsp, r.nrsp, e16);
    const size_t o = static_cast<size_t>(i) * e16 + l;
    if constexpr (kMix) res = dss_sweep::mix(r.ca, mx[o], r.cb, res);
    w[o] = res;
  }
}

}  // namespace ring
