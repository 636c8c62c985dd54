// The hand-off between blocks of the ring-fused kernels (caar.cu,
// tracer.cu): a producer computes one tile of s1 (tile lanes of every row)
// into a scratch field, and the sweep of a tile reads s1 up to `halo` tiles
// away, written by other blocks. The TPU kernel ran its grid in order and
// kept s1 in an on-chip ring (kernels/ring_fused.py:175-184); the card has
// no ordered grid, so the same schedule is built from tickets and flags:
//
//   * a block takes a ticket with atomicAdd when it starts; tickets are
//     handed out in the order blocks start, so every block holding a lower
//     ticket is already resident;
//   * the block with a producing ticket produces its tile, stores it, and
//     flags it: __syncthreads, __threadfence, then a release store of 1;
//   * the same block then sweeps the tile halo + lag tickets behind its own:
//     it waits (acquire loads) until the tiles that sweep reads, all of
//     lower tickets, are flagged, and reads them;
//   * having swept tile j, the block counts itself as a reader of each tile
//     j-halo .. j+halo; the block whose count completes a tile's readers
//     (every sweep i with |i - u| <= halo, inside 0 .. nb-1) discards that
//     tile's s1 lines from L2 (discard.global.L2: no write-back), so s1
//     need not reach device memory while it stays in L2 from its store to
//     its last read.
//
// Why it cannot deadlock at any residency: a block waits only on flags of
// tiles of lower or equal tickets, each set by the producer half of a
// block that is resident (it started first) and never waits before it
// flags; by induction on the ticket every block finishes. The discard
// waits on nothing: the last reader does it. Why no tile is discarded
// early: a tile's count reaches its reader total only after every sweep
// that may read it (each sweep reads only tiles inside its wait range) has
// finished its loads, counted after a __syncthreads and a fence;
// tests/test_torch_ring_schedule.py models both rings' schedules. The
// state of a launch, [ticket counter | reader counts | flags], comes new
// from the caller for each call and the launch clears it with one
// stream-ordered memset, so a CUDA graph of the launch replays correctly
// and two launches on two streams never share it. A tile that never comes
// is a fault: the wait traps after about a second.
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
  unsigned* flags;        // one per tile, 0 at launch, 1 once produced
  int* counter;           // the ticket counter, 0 at launch
  int nrsp, ne, nb, halo;
  float ca, cb;
  int* done;              // the reader count a tile, 0 at launch
};

// the row of s1 (and of w and mx) that a sweep's row i is: every row of
// the field (the CAAR ring)
struct AllRows {
  __device__ __forceinline__ int operator()(int i) const { return i; }
};

// whether a launch's tables hold: `ntiles` flags fit the buffer and a halo
// of `halo` tiles of `tile` lanes covers the sweep's reach, 16*ne + 1 lanes
inline bool covers(int ntiles, int nflags, int ne, int halo, int tile) {
  return ntiles <= nflags &&
         static_cast<long long>(halo) * tile >= 16LL * ne + 1;
}

// L2 eviction policies (createpolicy, sm_80+): lines stored under
// evict_last are evicted after every evict_normal and evict_first line
__device__ __forceinline__ unsigned long long evict_last() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long p;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
               : "=l"(p));
  return p;
}

// a store under an L2 policy
__device__ __forceinline__ void store(float* p, float v,
                                      unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.f32 [%0], %1, %2;"
               :: "l"(p), "f"(v), "l"(pol) : "memory");
}

__device__ __forceinline__ void store4(float* p, float4 v,
                                       unsigned long long pol) {
  asm volatile("st.global.L2::cache_hint.v4.f32 [%0], {%1, %2, %3, %4}, %5;"
               :: "l"(p), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "l"(pol)
               : "memory");
}

// the calling block's ticket (every thread gets it)
__device__ __forceinline__ int ticket(int* counter) {
  __shared__ int t;
  if (threadIdx.x == 0) t = atomicAdd(counter, 1);
  __syncthreads();
  return t;
}

// flag a tile once every thread of the block has stored its part
__device__ __forceinline__ void publish(unsigned* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(flag), "r"(1u) : "memory");
  }
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

// wait until flags[lo..hi] are set (a thread a flag, in turns of the
// block's size), then let the whole block read those tiles. Returns 0 from
// an asm that cannot move above the barrier: the tile loads add it to their
// addresses, so no compiler can move them above the wait.
__device__ __forceinline__ int wait(const unsigned* flags, int lo, int hi) {
  for (int t = lo + static_cast<int>(threadIdx.x); t <= hi;
       t += static_cast<int>(blockDim.x)) {
    long long polls = 0;
    while (load_acquire(flags + t) == 0u) {
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
// expressions, s1 read through L2: the lane-a-thread sweep of both rings'
// designs before their float4 sweeps, kept for experiments/
// kernel_variants.py. `after` is wait()'s token.
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

// The sweep of tile j (kTile lanes, kTile/4 aligned groups of 4) over rows
// 0 .. rows-1 into w, by the calling block: thread (g, y) = (tid % G, tid /
// G), G = kTile/4, takes group g in rows y, y + ny, ... (ny = blockDim/G),
// as the sweep kernel does one group of one row (dss.cu, dss_sweep::swept4):
// it decodes the group's partner offsets and reads its rspheremp rows once,
// then, kU rows at a time, issues every load of those rows (the group and
// its alpha partner as float4s, the two beta partners and their alpha
// partners, the mix group) before it sums, mixes and stores their float4s
// (with kFirst evict-first in L2: w is not read again): the loads of kU
// rows in flight, not one row's (kLoads < 2, an experiment, drops the
// partner loads, and 0 the group's too). With kL1 s1 is read through L1: the
// partner loads of a warp fall on the lines of its own and its neighbours'
// groups, which L1 then serves (through L2 alone, __ldcg, every one of the
// six loads of a group-row is a request of its own to L2). That is
// coherent: no SM reads a tile's lines before its flag, a tile is written
// once a launch, and the acquire of the flags (ld.acquire.gpu, a gpu-scope
// fence) orders the block's later loads after the producer's release.
// `after` is wait()'s token; row i of the sweep is row row_of(i) of s1, w
// and mx (a tracer ring item holds some levels of some tracers).
template <int kTile, int kU, bool kMix, bool kFirst, bool kL1,
          int kLoads = 2, class RowOf = AllRows>
__device__ __forceinline__ void emit4(const Args& r, int after, int j,
                                      int rows, int e16,
                                      RowOf row_of = RowOf()) {
  static_assert(kTile % 16 == 0, "a tile is whole elements");
  constexpr int G = kTile / 4;
  const int tid = threadIdx.x, g = tid % G;
  const int ny = static_cast<int>(blockDim.x) / G;
  const int l0 = j * kTile + 4 * g;
  if (l0 >= e16 || tid >= ny * G) return;
  const int ne = r.ne, e = l0 >> 4, i = (l0 >> 2) & 3;
  const int ei = e % ne, ej = (e / ne) % ne, rl = 16 * ne;
  const int da = (i == 3 && ei < ne - 1) ? 4 : (i == 0 && ei > 0) ? -4 : 0;
  const bool alpha = da != 0, up = ej < ne - 1, dn = ej > 0;
  const float4 hi = *reinterpret_cast<const float4*>(r.rsp + l0);
  const float4 lo = r.nrsp == 2
                        ? *reinterpret_cast<const float4*>(r.rsp + e16 + l0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  [[maybe_unused]] const unsigned long long first =
      kFirst ? evict_first() : 0ull;
  const auto ld4 = [](const float* p) {
    if constexpr (kL1) return *reinterpret_cast<const float4*>(p);
    else return __ldcg(reinterpret_cast<const float4*>(p));
  };
  const auto ld = [](const float* p) {
    if constexpr (kL1) return *p;
    else return __ldcg(p);
  };
  for (int row0 = tid / G; row0 < rows; row0 += kU * ny) {
    float4 c[kU], a[kU], m[kU];
    float bu[kU], bua[kU], bd[kU], bda[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = row0 + u * ny;
      const size_t o =
          static_cast<size_t>(row_of(row < rows ? row : 0)) * e16 + l0;
      const float* xr = r.s1 + o + after;
      c[u] = kLoads > 0 ? ld4(xr) : hi;
      a[u] = kLoads > 1 && alpha ? ld4(xr + da) : zero4;
      bu[u] = kLoads > 1 && up ? ld(xr + rl) : 0.f;
      bua[u] = kLoads > 1 && up && alpha ? ld(xr + rl + da) : 0.f;
      bd[u] = kLoads > 1 && dn ? ld(xr + 3 - rl) : 0.f;
      bda[u] = kLoads > 1 && dn && alpha ? ld(xr + 3 - rl + da) : 0.f;
      m[u] = kMix ? __ldg(reinterpret_cast<const float4*>(r.mx + o)) : zero4;
    }
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      const int row = row0 + u * ny;
      if (row >= rows) break;
      float4 w = dss_sweep::swept4(c[u], a[u], alpha, bu[u], bua[u], up,
                                   bd[u], bda[u], dn, hi, lo, r.nrsp);
      if constexpr (kMix) {
        w.x = dss_sweep::mix(r.ca, m[u].x, r.cb, w.x);
        w.y = dss_sweep::mix(r.ca, m[u].y, r.cb, w.y);
        w.z = dss_sweep::mix(r.ca, m[u].z, r.cb, w.z);
        w.w = dss_sweep::mix(r.ca, m[u].w, r.cb, w.w);
      }
      float* out = r.w + static_cast<size_t>(row_of(row)) * e16 + l0;
      if constexpr (kFirst) store4(out, w, first);
      else *reinterpret_cast<float4*>(out) = w;
    }
  }
}

// the sweeps that may read tile u: i = max(u - halo, 0) .. min(u + halo,
// nb - 1), as many as its reader count must reach
__device__ __forceinline__ int readers(int u, int halo, int nb) {
  return min(u + halo, nb - 1) - max(u - halo, 0) + 1;
}

// After the calling block's sweep of a tile whose wait covered tiles lo ..
// hi: count the block as a reader of each, and discard from L2 the s1 lines
// of every tile whose count this block completes (kTile lanes of each of
// the `rows` rows row_of(0 ..), e16 lanes apart; kTile*4 bytes a whole
// number of 128-byte lines, s1 128-byte aligned and e16 a multiple of 32,
// so a tile's rows are whole lines of its own, the last tile's up to e16).
// The __syncthreads orders every thread's s1 loads (their values are
// stored already) before the counts. `now` (an experiment) discards lo ..
// hi without counting. kThreads is the block's largest size.
template <int kTile, int kThreads = kTile * 8, class RowOf = AllRows>
__device__ __forceinline__ void retire(const Args& r, int lo, int hi,
                                       int rows, int e16,
                                       bool now = false,
                                       RowOf row_of = RowOf()) {
  static_assert(kTile % 32 == 0, "a tile's row is whole 128-byte lines");
  constexpr int kLines = kTile / 32;
  __shared__ int last[kThreads];
  __shared__ int nlast;
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int base = lo; base <= hi; base += nt) {
    __syncthreads();
    if (tid == 0) nlast = 0;
    __syncthreads();
    const int u = base + tid;
    if (u <= hi) {
      __threadfence();
      if (now || atomicAdd(r.done + u, 1) == readers(u, r.halo, r.nb) - 1) {
        __threadfence();
        last[atomicAdd(&nlast, 1)] = u;
      }
    }
    __syncthreads();
    for (int n = 0; n < nlast; ++n) {
      const int l0 = last[n] * kTile;
      const float* s1 = r.s1 + l0;
      // the lines of the tile inside the row (fewer in a ragged last tile)
      const int lines = min(kLines, (e16 - l0) >> 5);
      for (int p = tid; p < rows * kLines; p += nt) {
        if (p % kLines >= lines) continue;
        const float* line = s1 +
                            static_cast<size_t>(row_of(p / kLines)) * e16 +
                            (p % kLines) * 32;
        asm volatile("discard.global.L2 [%0], 128;" :: "l"(line)
                     : "memory");
      }
    }
  }
}

}  // namespace ring
