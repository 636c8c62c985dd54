// Tracer advection on the packed layouts. On [qsize*nlev, E16], all tracers
// on the row axis (row = tracer*nlev + level), two kernels:
//
//   tracer_kernel<false, false>:  out = sph * (q - dt * div(v q))  (or
//                                 without sph): the Euler stage
//   tracer_kernel<true, kMix>:    e = q - dt * div(v q);  y = e  or
//                                 ca*mx + cb*e;  y = L(y, bounds(q));
//                                 out = sph * y: the limited stage
//
// with div(v q) = (D_x(gv1) + D_y(gv2)) * rmetdet * rrearth,
// gv1 = metdet*(dinv00*vu*q + dinv01*vv*q), gv2 alike (EulerStepFunctor.hpp:
// 33-69, SphereOperators.hpp:362-403), and L the element-local monotone
// mass-conserving limiter (HOMME limiter8 analog): clamp y into the extrema
// of the stage input q over the element's 16 nodes while conserving
// sum(sph*y), by redistribution into the room that is left.
//
// Replaces the Pallas kernels of tinman_sandbox_tpu/kernels/tracer_pallas_t.py:
// tracer_euler_pallas_packed_t (:404), tracer_euler_pallas_packed_t_lg (:507)
// and tracer_euler_pallas_packed_t_ext (:674), body _tracer_kernel_t
// (:195-251), by the Euler stage; tracer_limit_pallas_packed_t_ext (:322),
// body _tracer_limit_kernel_t (:254-317) with the limiter _limit_lanes
// (:145-192), by the limited stage. The TPU forms differ in how the grid
// cuts lanes and rows for VMEM and in the layout of the fix-lane slab; their
// 128x128 block-diagonal derivative operands, bf16 limb splits and one-hot
// group tables fed a matrix unit. Here the 4x4 Dvv is contracted with FP32
// FMAs and the group reductions run in registers and quad shuffles.
//
// What bounds them on the H100: device-memory traffic, if the body runs
// few enough instructions. A stage reads the tracer block (and mx), two wind
// blocks and 7 meta rows and writes the tracer block (plus the slab): at
// ne30 x 72 about 100 MB for one tracer and 1.8-2.7 GB for 35, some 0.55-0.80
// ms at 3.35 TB/s at qsize 35. That leaves the card ~100 thread instructions
// a node and row. The first design (one lane a thread, the 16 lanes of an
// element in a half-warp, every group reduction a width-16 butterfly) spent
// ~180 on the limited stage, 32 of them shuffles, and ran at 3.5x its bound.
//
// Design (the quad layout): a thread owns one row li of an element, its 4
// lanes li*4 .. li*4+3, as one float4, and four neighbouring threads (a quad)
// make the element; a warp's load of a row is 512 contiguous bytes. A block
// takes a tile of 128 lanes (8 elements, a warp's quads) and kLevels = 8
// levels, split over its warps (the ring kernel's tiles and chunks; warp w
// of 4 the levels w and w + 4). A thread forms the wind-metric products
// c1 = metdet*(dinv00*u + dinv01*v) and c2 = metdet*(dinv10*u + dinv11*v)
// of a level once, and every tracer takes gv1 = c1*q and gv2 = c2*q.
// D_y contracts the thread's own row in registers with the rows of Dvv
// read from shared memory; D_x takes the other three rows of gv1 by three
// float4 xor shuffles inside the quad, summed in the order m = 0..3 of row
// li ^ m. Each group reduction of the limiter is a tree over the thread's 4
// lanes ((a0 + a1) + (a2 + a3)) and two xor shuffles (1, then 2), so every
// thread of the quad gets the same bits; the divisions run once a thread, a
// quarter of the element's lanes. The 8 levels of a tracer at a fix lane
// (one 32-byte sector of the slab) are written by one block's warps close
// together, so the sector fills in L2 before it goes to memory: the Euler
// stage's 4 warps hold both of their levels at once and walk the tracers
// outside them; the limited stage, whose body needs the registers, runs 8
// warps of one level each at 64 registers for 4 blocks an SM. Each thread
// starts the next tracer's loads (q and mx) before it computes its rows.
// The deficit is summed from
// the clipped-off amounts w*(y - clip(y)) themselves, never as a difference
// of two masses, which would cancel. Divisions are __fdiv_rn; a uniform
// element has no room (tot = 0): give = 0 and the coefficient is
// 0 / FLT_MIN = 0, no NaN. Every FMA is an explicit fmaf and the source is
// built with -fmad=false (kernels/_build.py), so the bits of a row do not
// depend on which kernel inlines its body.
// bf16 storage (kQBf, kMxBf; the `bf16` argument of both stage launches):
// the JAX package's full step under `bench --prim --storage` (bench.py:
// 340-352) hands the first step's tracer stages a bf16 qdp: stage 1 reads it
// as q, and the limited stages 2 and 3 as the mix field mx (the unlimited
// stages mix in the sweep). The kernel reads such an operand itself, 4
// lanes as 8 bytes, and upcasts it exactly (__bfloat1622float2) into the
// registers where the float4 would have landed; compute, out and the slab
// stay f32, so each such instance is, bit for bit, the f32 instance on the
// operand upcast. The instances: the Euler stage with a bf16 q, the limited
// stage with a bf16 q and no mix, and with an f32 q and a bf16 mx.
// The winds are read out of taller tensors (the [4*nlev] prognostic state)
// by row-block offset, with no slice copy. Every tensor a thread reads or
// writes by float4 must be 16-byte aligned with ld % 4 == 0 (the wrappers
// check). Optional fix-lane slab, as the CAAR kernel's: the thread owning a
// lane with fix_rank[lane] = r >= 0 also writes its output at every row to
// slab[r*nq*nlev + row].
// Ring-fused mode (tracer_ring_kernel): replaces tracer_ring_packed_t of
// tinman_sandbox_tpu/kernels/ring_fused.py (:369, body _tracer_ring_kernel
// :303), the folded Euler stage and the rspheremp-scaled sweep of its output
// in one launch, with the sweep's mix epilogue. The items of the launch are
// (row block, tile) pairs, row-block-major: a tile of 128 lanes and a row
// block of `group` chunks of kLevels levels and `tracers` tracers. The
// block with ticket t < items produces item t into a scratch through
// stage_block, chunk by chunk (the Euler kernel's code and schedule, so
// the same bits), s1 stored evict-last in L2, and flags it; every block
// then sweeps the item halo + lag tickets behind its own in float4 groups
// with the sweep kernel's sums (ring::emit4, dss_sweep.cuh; s1 read
// through L1, w stored evict-first), waiting on the tiles of that item's
// row block that it reads, and discards from L2 the s1 lines of the tiles
// whose last reader it is (ring.cuh). A sweep waits on tickets at most
// halo above its item's, so the lag lets them finish before it asks. The
// plan (tile, row blocks, halo, lag, the waits and the reader counts) is
// kernels/ring_fused.py::tracer_ring_plan, which sizes the items
// (TRACER_RING_ITEM_ROWS): at qsize 1 three chunks (3 x 675 items of 24
// rows: a block's fixed costs, its ticket, the tile's tables and the flag,
// paid once for 24 rows), at qsize 35 one chunk of 9 or 8 tracers (9 x 4 x
// 675 items of 72 or 64 rows: the s1 of the items in flight, some 800 of
// 36 KB, about fits L2, where whole chunks of 280 rows would not). On the
// H100 the ring still takes 1.1x its two launches (PERF.md row 19): its
// producer costs more than the Euler kernel alone and the sweep inside it
// nearly what the sweep kernel does. The fix lanes keep their in-face
// partial sums for the fixup and the patch (dss.cu).
//
// On the row layout [E16, qsize*nlev] (tracer-major on the contiguous axis,
// column j = tracer*nlev + level) a third kernel:
//
//   tracer_row_kernel:    out = q - dt * div(v q)
//
// replaces euler_step_pallas_packed of tinman_sandbox_tpu/kernels/
// tracer_pallas.py (:61, body _tracer_kernel :30-57), whose 128x128
// block-diagonal operators fed the matrix unit with a qsize-times wider
// right-hand side. Bound by bytes as the others: q read, out written, the
// two [E16, nlev] wind blocks and 6 metric values a point, against ~30 FP32
// operations a point. Design: a block holds ONE element and a chunk of the
// q*nlev columns, one thread per column, so each of the element's 16 rows
// is read and written by neighbouring threads at neighbouring addresses
// (coalesced). The Dvv exchange is per element and a thread holds all 16
// GLL points of its column, so the contractions run in registers with no
// shared-memory exchange and no barrier after the metric load. The winds at
// level j mod nlev broadcast over the tracers (neighbouring columns of one
// tracer read neighbouring wind addresses; other tracers hit the cache).
#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kTile = 128;             // lanes of a block: one warp of quads
constexpr int kLevels = 8;             // levels a block: one slab sector
constexpr int kRingWarps = 4;          // warps of a ring block (ring.cuh)
constexpr int kRingLanes = 32;         // the ring's lane multiple: a row's
                                       // tiles are whole 128-byte lines
// The ring kernel's design, each part a constant that
// experiments/kernel_variants.py (group tracer_ring) builds otherwise, the
// port's value first:
//   kRingSweep    1 the float4 sweep (ring::emit4); 0 none and no wait (the
//                 producer alone); 2 a lane a thread (ring::emit, the design
//                 before); 3 the wait without the sweep;
//   kRingUnroll   1 row of loads in flight a thread, or 2;
//   kRingL1       the sweep reads s1 through L1 (else through L2 alone);
//   kRingKeep     s1 stored evict-last and w evict-first in L2 (else plain
//                 stores);
//   kRingDiscard  s1 lines discarded from L2 by their last reader;
//   kRingBlocks   the blocks an SM the registers are capped for: 5 (102,
//                 of which it takes 95, no spills; uncapped it took 122
//                 and held 4), or 6, or 0 (none).
#ifdef TRACER_RING_SWEEP
constexpr int kRingSweep = TRACER_RING_SWEEP;
#else
constexpr int kRingSweep = 1;
#endif
#ifdef TRACER_RING_UNROLL
constexpr int kRingUnroll = TRACER_RING_UNROLL;
#else
constexpr int kRingUnroll = 1;
#endif
#ifdef TRACER_RING_L1
constexpr bool kRingL1 = TRACER_RING_L1;
#else
constexpr bool kRingL1 = true;
#endif
#ifdef TRACER_RING_KEEP
constexpr bool kRingKeep = TRACER_RING_KEEP;
#else
constexpr bool kRingKeep = true;
#endif
#ifdef TRACER_RING_DISCARD
constexpr bool kRingDiscard = TRACER_RING_DISCARD;
#else
constexpr bool kRingDiscard = true;
#endif
#ifdef TRACER_RING_BLOCKS
constexpr int kRingBlocks = TRACER_RING_BLOCKS;
#else
constexpr int kRingBlocks = 5;
#endif
// Per stage, the warps of a block (the chunk's levels split over them), the
// levels a warp holds at once (their wind products and rows in flight) and
// the blocks an SM its registers are capped for, the best of
// experiments/kernel_variants.py's builds on the H100 (which override them
// with TRACER_WARPS, TRACER_GROUP and TRACER_MIN_BLOCKS): the Euler stage
// runs 4 warps of 2 levels held at once, uncapped (96 registers, 5 blocks
// an SM); the limited stage, whose body needs the registers, 8 warps of 1
// level at 64 registers for 4 blocks an SM.
#ifdef TRACER_WARPS
constexpr int kWarpsEuler = TRACER_WARPS, kWarpsLimit = TRACER_WARPS;
#else
constexpr int kWarpsEuler = 4, kWarpsLimit = 8;
#endif
#ifdef TRACER_GROUP
constexpr int kGroupEuler = TRACER_GROUP, kGroupLimit = TRACER_GROUP;
#else
constexpr int kGroupEuler = 2, kGroupLimit = 1;
#endif
#ifdef TRACER_MIN_BLOCKS
constexpr int kMinEuler = TRACER_MIN_BLOCKS, kMinLimit = TRACER_MIN_BLOCKS;
#else
constexpr int kMinEuler = 1, kMinLimit = 4;
#endif
constexpr unsigned kFull = 0xffffffffu;

// META_COLS row indices (kernels/layout.py)
enum Meta {
  kDinv00 = 0, kDinv01, kDinv10, kDinv11, kMetdet = 8, kRmetdet = 9,
  kSpheremp = 11
};

// four lanes of one row of an element, the thread's share
struct V4 {
  float v[4];
};

__device__ __forceinline__ V4 zero4() { return V4{{0.f, 0.f, 0.f, 0.f}}; }

__device__ __forceinline__ V4 ld4(const float* __restrict__ p, size_t o) {
  const float4 f = *reinterpret_cast<const float4*>(p + o);
  return V4{{f.x, f.y, f.z, f.w}};
}

// four lanes of a tracer operand from element o: float, or with kBf bf16
// (8 bytes, o a multiple of 4) upcast exactly
template <bool kBf>
__device__ __forceinline__ V4 ld4op(const void* __restrict__ p, size_t o) {
  if constexpr (kBf) {
    const uint2 w = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(p) + o);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&w.y));
    return V4{{a.x, a.y, b.x, b.y}};
  } else {
    return ld4(static_cast<const float*>(p), o);
  }
}

__device__ __forceinline__ void st4(float* __restrict__ p, size_t o,
                                    const V4& a) {
  *reinterpret_cast<float4*>(p + o) =
      make_float4(a.v[0], a.v[1], a.v[2], a.v[3]);
}

__device__ __forceinline__ V4 shfl_xor4(const V4& a, int m) {
  V4 r;
#pragma unroll
  for (int j = 0; j < 4; ++j) r.v[j] = __shfl_xor_sync(kFull, a.v[j], m, 4);
  return r;
}

// reductions over the element's 16 lanes: a tree over the thread's 4, then
// the quad's partial results by xor 1 and xor 2; every thread of the quad
// gets the same bits (each step adds the same two values)
__device__ __forceinline__ float qsum(const V4& a) {
  float s = (a.v[0] + a.v[1]) + (a.v[2] + a.v[3]);
  s += __shfl_xor_sync(kFull, s, 1, 4);
  return s + __shfl_xor_sync(kFull, s, 2, 4);
}

__device__ __forceinline__ float qmin(const V4& a) {
  float s = fminf(fminf(a.v[0], a.v[1]), fminf(a.v[2], a.v[3]));
  s = fminf(s, __shfl_xor_sync(kFull, s, 1, 4));
  return fminf(s, __shfl_xor_sync(kFull, s, 2, 4));
}

__device__ __forceinline__ float qmax(const V4& a) {
  float s = fmaxf(fmaxf(a.v[0], a.v[1]), fmaxf(a.v[2], a.v[3]));
  s = fmaxf(s, __shfl_xor_sync(kFull, s, 1, 4));
  return fmaxf(s, __shfl_xor_sync(kFull, s, 2, 4));
}

// What a block keeps in shared memory for its tile, read where it is used
// so that it costs the threads no registers: the rows of Dvv (the D_y
// weights), each row li's D_x weights, and its lanes' rmetdet*rrearth and
// spheremp.
struct Tile {
  float4 dvv[4];                 // Dvv[m, 0..3]
  float4 wx[4];                  // Dvv[li ^ m, li], m = 0..3, by li
  float4 rmr[kTile / 4];         // by quad row (thread of a warp)
  float4 sph[kTile / 4];
};

__device__ __forceinline__ V4 lds4(const float4* p) {
  float4 f;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(f.x), "=f"(f.y), "=f"(f.z), "=f"(f.w)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(p))));
  return V4{{f.x, f.y, f.z, f.w}};
}

// The per-thread constants of one launch.
struct Quad {
  int li;                  // the thread's row of its element
  int qi;                  // its 4 lanes' place in the tile, by 4
  int col;                 // its first lane
  bool live;
  int fix;                 // bit j: lane col + j has a fix rank
  float wsum;              // the element's sum of spheremp
};

// Fill the tile (behind a barrier: every thread of the block must call it)
// and the thread's constants for the tile's lanes from lane0.
__device__ __forceinline__ Quad load_tile(Tile& tl,
                                          const float* __restrict__ meta,
                                          const float* __restrict__ dvv,
                                          const int* __restrict__ fix_rank,
                                          size_t ldz, int ncol, int lane0,
                                          float rr) {
  Quad t;
  t.li = threadIdx.x & 3;
  t.qi = threadIdx.x & 31;
  t.col = lane0 + 4 * t.qi;
  t.live = t.col < ncol;     // ncol % 16 == 0: a quad is live or dead whole
  if (threadIdx.x < 4) {
    const int li = threadIdx.x;
    tl.dvv[li] = *reinterpret_cast<const float4*>(dvv + 4 * li);
    tl.wx[li] = make_float4(dvv[li * 4 + li], dvv[(li ^ 1) * 4 + li],
                            dvv[(li ^ 2) * 4 + li], dvv[(li ^ 3) * 4 + li]);
  }
  if (threadIdx.x < 32) {
    float4 r = make_float4(1.f, 1.f, 1.f, 1.f), w = r;
    if (t.live) {
      r = *reinterpret_cast<const float4*>(meta + kRmetdet * ldz + t.col);
      r = make_float4(r.x * rr, r.y * rr, r.z * rr, r.w * rr);
      w = *reinterpret_cast<const float4*>(meta + kSpheremp * ldz + t.col);
    }
    tl.rmr[t.qi] = r;
    tl.sph[t.qi] = w;
  }
  t.fix = 0;
  if (t.live && fix_rank) {
    const int4 r = *reinterpret_cast<const int4*>(fix_rank + t.col);
    t.fix = (r.x >= 0) | (r.y >= 0) << 1 | (r.z >= 0) << 2 | (r.w >= 0) << 3;
  }
  __syncthreads();
  t.wsum = qsum(lds4(tl.sph + t.qi));
  return t;
}

// The operands of one stage launch.
struct Stage {
  const float* __restrict__ meta;
  const float* __restrict__ vu;      // the nlev wind rows
  const float* __restrict__ vv;
  const void* __restrict__ q;        // float, or bf16 by the instance
  const void* __restrict__ mx;       // the mix field, or null; likewise
  float* __restrict__ out;
  const int* __restrict__ fix_rank;  // null: no slab
  float* __restrict__ slab;
  size_t ld;                         // leading dimension of every field
  int nlev, nq, fold, iters;         // fold: out = sph * e (Euler stage)
  float dt, ca, cb;
};

// the wind-metric products of level k at the thread's lanes, which every
// tracer of the level shares: gv1 = c1*q, gv2 = c2*q
struct Wind {
  V4 c1, c2;
};

__device__ __forceinline__ Wind wind_products(const Quad& t, const Stage& s,
                                              int k) {
  Wind w{zero4(), zero4()};
  if (!t.live) return w;
  const size_t ld = s.ld;
  const V4 u = ld4(s.vu, k * ld + t.col), v = ld4(s.vv, k * ld + t.col);
  const V4 d00 = ld4(s.meta, kDinv00 * ld + t.col);
  const V4 d01 = ld4(s.meta, kDinv01 * ld + t.col);
  const V4 d10 = ld4(s.meta, kDinv10 * ld + t.col);
  const V4 d11 = ld4(s.meta, kDinv11 * ld + t.col);
  const V4 md = ld4(s.meta, kMetdet * ld + t.col);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    w.c1.v[j] = md.v[j] * fmaf(d00.v[j], u.v[j], d01.v[j] * v.v[j]);
    w.c2.v[j] = md.v[j] * fmaf(d10.v[j], u.v[j], d11.v[j] * v.v[j]);
  }
  return w;
}

// e = q - dt * div(v q) at the thread's 4 lanes. Every thread of the warp
// must call it (the quad exchanges its rows of gv1).
__device__ __forceinline__ V4 advect(const Quad& t, const Tile& tl,
                                     const Wind& w, const V4& q, float dt) {
  V4 g1, g2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    g1.v[j] = w.c1.v[j] * q.v[j];
    g2.v[j] = w.c2.v[j] * q.v[j];
  }
  // rows li ^ 1, li ^ 2, li ^ 3 of gv1
  const V4 r1 = shfl_xor4(g1, 1), r2 = shfl_xor4(g1, 2),
           r3 = shfl_xor4(g1, 3);
  const V4 wx = lds4(tl.wx + t.li), rmr = lds4(tl.rmr + t.qi);
  const V4 y0 = lds4(tl.dvv), y1 = lds4(tl.dvv + 1), y2 = lds4(tl.dvv + 2),
           y3 = lds4(tl.dvv + 3);
  V4 e;
#pragma unroll
  for (int lj = 0; lj < 4; ++lj) {
    // strong d/dx at (li, lj): sum_i Dvv[i, li] * gv1[i, lj], i = li ^ m
    float ax = wx.v[0] * g1.v[lj];
    ax = fmaf(wx.v[1], r1.v[lj], ax);
    ax = fmaf(wx.v[2], r2.v[lj], ax);
    ax = fmaf(wx.v[3], r3.v[lj], ax);
    // strong d/dy at (li, lj): sum_m Dvv[m, lj] * gv2[li, m]
    float ay = y0.v[lj] * g2.v[0];
    ay = fmaf(y1.v[lj], g2.v[1], ay);
    ay = fmaf(y2.v[lj], g2.v[2], ay);
    ay = fmaf(y3.v[lj], g2.v[3], ay);
    e.v[lj] = fmaf(-dt, (ax + ay) * rmr.v[lj], q.v[lj]);
  }
  return e;
}

// The limiter on the thread's 4 lanes: bounds from the stage input q,
// weights w = sph, `iters` clip-and-redistribute passes with the carry,
// then the residual spread uniformly by weight. Every thread of the warp
// must call it.
__device__ __forceinline__ V4 limit(V4 y, const V4& q, const V4& w,
                                    float wsum, int iters) {
  const float lo = qmin(q), hi = qmax(q);
  V4 a;
#pragma unroll
  for (int j = 0; j < 4; ++j) a.v[j] = w.v[j] * y.v[j];
  const float mass = qsum(a);
  float carry = 0.f;
  for (int i = 0; i < iters; ++i) {
    V4 yc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yc.v[j] = fminf(fmaxf(y.v[j], lo), hi);
      a.v[j] = w.v[j] * (y.v[j] - yc.v[j]);
    }
    // the deficit from the clipped-off amounts: no cancellation
    const float d = qsum(a) + carry;
    const bool pos = d > 0.f;
    const float bsel = pos ? hi : lo;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      a.v[j] = w.v[j] * (pos ? hi - yc.v[j] : yc.v[j] - lo);
    const float tot = qsum(a);
    const float give = pos ? fminf(d, tot) : fmaxf(d, -tot);
    carry = d - give;
    const float c = fabsf(__fdiv_rn(give, fmaxf(tot, FLT_MIN)));
#pragma unroll
    for (int j = 0; j < 4; ++j) y.v[j] = fmaf(c, bsel - yc.v[j], yc.v[j]);
  }
  // what the bounds could not take is spread uniformly by weight
#pragma unroll
  for (int j = 0; j < 4; ++j) a.v[j] = w.v[j] * y.v[j];
  const float r = __fdiv_rn(mass - qsum(a), wsum);
#pragma unroll
  for (int j = 0; j < 4; ++j) y.v[j] += r;
  return y;
}

// One row (tracer n, level k) at the thread's 4 lanes: the stage's value
// from q (and the mix field's mv), into out at o and the slab; with kKeep
// out is stored under the L2 policy `keep` (the ring's s1). The Euler
// kernel and the ring kernel both run stage_row<false, false>, so both
// write the same bits. Every thread of the warp must call it.
template <bool kLimit, bool kMix, bool kKeep = false>
__device__ __forceinline__ void stage_row(const Quad& t, const Tile& tl,
                                          const Stage& s, const Wind& w,
                                          const V4& qv, const V4& mv,
                                          size_t o, size_t row,
                                          unsigned long long keep) {
  V4 y = advect(t, tl, w, qv, s.dt);
  if constexpr (kMix) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y.v[j] = __fadd_rn(__fmul_rn(s.ca, mv.v[j]), __fmul_rn(s.cb, y.v[j]));
  }
  if (kLimit || s.fold) {
    const V4 sph = lds4(tl.sph + t.qi);
    if constexpr (kLimit) y = limit(y, qv, sph, t.wsum, s.iters);
#pragma unroll
    for (int j = 0; j < 4; ++j) y.v[j] *= sph.v[j];
  }
  if (t.live) {
    if constexpr (kKeep)
      ring::store4(s.out + o, make_float4(y.v[0], y.v[1], y.v[2], y.v[3]),
                   keep);
    else
      st4(s.out, o, y);
    if (t.fix && s.slab) {
      const size_t nrows = static_cast<size_t>(s.nq) * s.nlev;
      const int4 r = *reinterpret_cast<const int4*>(s.fix_rank + t.col);
      const int rank[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (t.fix >> j & 1) s.slab[rank[j] * nrows + row] = y.v[j];
    }
  }
}

// One block's share: the kTile lanes from lane0 (a warp's quads; every warp
// takes the same lanes) at levels k0 .. k1 - 1, warp w of kWarps the levels
// k0 + w + i*kWarps (i < kPer), the tracers n0 .. n1 - 1 (the stages take
// every tracer, a ring item some), kGroup of its levels at a
// time: the tracer loop outside the group's levels, so a tracer's levels
// at a fix lane (a 32-byte sector of a slab row holds 8) are written by
// the block's warps close together and the sector fills in L2 before it
// goes to memory (on the H100 the Euler stage at qsize 35 took 0.94 ms with
// 4 warps of one level at a time, 0.74 with two). The next tracer's loads
// start before the current tracer's rows run. With kKeep (the ring) out is
// stored evict-last in L2; with kQBf (kMxBf) q (mx) is bf16. Every thread
// of the block must call it.
template <bool kLimit, bool kMix, int kWarps, bool kKeep = false,
          bool kQBf = false, bool kMxBf = false>
__device__ __forceinline__ void stage_block(const Stage& s,
                                            const float* __restrict__ dvv,
                                            int ncol, float rr, int lane0,
                                            int k0, int k1, int n0, int n1,
                                            Tile& tl) {
  constexpr int kPer = kLevels / kWarps;         // levels a warp takes
  constexpr int kGroup = (kLimit ? kGroupLimit : kGroupEuler) < kPer
                             ? (kLimit ? kGroupLimit : kGroupEuler)
                             : kPer;
  static_assert(kLevels % kWarps == 0 && kPer % kGroup == 0,
                "a chunk's levels split over the warps, a warp's in groups");
  const Quad t = load_tile(tl, s.meta, dvv, s.fix_rank, s.ld, ncol, lane0,
                           rr);
  const int kw = k0 + static_cast<int>(threadIdx.x >> 5);
  const size_t step = static_cast<size_t>(s.nlev) * s.ld;   // a tracer
  [[maybe_unused]] const unsigned long long keep =
      kKeep ? ring::evict_last() : 0ull;
#pragma unroll 1
  for (int g = 0; g < kPer; g += kGroup) {
    bool on[kGroup];          // warp-uniform: the level is in the chunk
    Wind w[kGroup];
    size_t o[kGroup];
    V4 qn[kGroup], mn[kGroup];
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int k = kw + (g + i) * kWarps;
      on[i] = k < k1;
      w[i] = on[i] ? wind_products(t, s, k) : Wind{zero4(), zero4()};
      o[i] = static_cast<size_t>(k) * s.ld + t.col + n0 * step;
      qn[i] = mn[i] = zero4();
      if (on[i] && t.live) {
        qn[i] = ld4op<kQBf>(s.q, o[i]);
        if constexpr (kMix) mn[i] = ld4op<kMxBf>(s.mx, o[i]);
      }
    }
    for (int n = n0; n < n1; ++n) {
      V4 qv[kGroup], mv[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        qv[i] = qn[i];
        mv[i] = mn[i];
        if (on[i] && t.live && n + 1 < n1) {     // the next tracer's loads
          qn[i] = ld4op<kQBf>(s.q, o[i] + step);
          if constexpr (kMix) mn[i] = ld4op<kMxBf>(s.mx, o[i] + step);
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (on[i])
          stage_row<kLimit, kMix, kKeep>(t, tl, s, w[i], qv[i], mv[i],
                                         o[i],
                                         static_cast<size_t>(n) * s.nlev +
                                             kw + (g + i) * kWarps,
                                         keep);
        o[i] += step;
      }
    }
  }
}

// The Euler (kLimit false) and limited stages: block (x, y) takes lanes
// x*kTile .. +kTile and levels y*kLevels .. +kLevels, every tracer; q (mx)
// bf16 with kQBf (kMxBf).
template <bool kLimit, bool kMix, bool kQBf = false, bool kMxBf = false>
__global__ void __launch_bounds__(32 * (kLimit ? kWarpsLimit : kWarpsEuler),
                                  kLimit ? kMinLimit : kMinEuler)
tracer_kernel(Stage s, const float* __restrict__ dvv, int ncol, float rr) {
  static_assert(kMix || !kMxBf, "a bf16 mix field needs the mix");
  __shared__ Tile tl;
  const int k0 = blockIdx.y * kLevels;
  stage_block<kLimit, kMix, kLimit ? kWarpsLimit : kWarpsEuler, false, kQBf,
              kMxBf>(s, dvv, ncol, rr, blockIdx.x * kTile, k0,
                     min(k0 + kLevels, s.nlev), 0, s.nq, tl);
}

// threads of a block of tracer_kernel<kLimit, *>
constexpr int stage_threads(bool limit) {
  return 32 * (limit ? kWarpsLimit : kWarpsEuler);
}

// the scratch rows of one item's sweep: row i of the sweep is tracer n0 +
// i / nk at level k0 + i % nk (the f32 quotient is exact: its error is
// ~1e-7 of i / nk, the margin 0.5 / nk)
struct ItemRows {
  int nk, nlev, k0, n0;
  float rnk;
  __device__ __forceinline__ int operator()(int i) const {
    const int n = __float2int_rz((static_cast<float>(i) + 0.5f) * rnk);
    return (n0 + n) * nlev + k0 + (i - n * nk);
  }
};

// The row block g of a launch whose row blocks are ngt tracer groups of
// `tracers` tracers for each level group of `group` chunks: its levels
// [k0, k1) and tracers [n0, n1)
struct RowBlock {
  int k0, k1, n0, n1;
};

__device__ __forceinline__ RowBlock row_block(const Stage& s, int g, int ngt,
                                              int group, int tracers) {
  const int gl = g / ngt, gt = g - gl * ngt;
  const int k0 = gl * group * kLevels, n0 = gt * tracers;
  return {k0, min(k0 + group * kLevels, s.nlev), n0, min(n0 + tracers, s.nq)};
}

// The ring-fused Euler stage over nrb*nb items (row block, tile), row-
// block-major: the block with ticket t < nrb*nb produces item t into the
// scratch r.s1 (and the slab) and flags it; the block sweeps item t - halo
// - lag into r.w, waiting on its row block's flags only, and retires the
// tiles it completes (r.done and r.flags by item). nrb*nb + halo + lag
// blocks, nrb = ngl*ngt row blocks (row_block). The constants kRing* above
// select the design (the port's: float4 sweep, hints, discard, L1 reads).
template <bool kMix>
__global__ void __launch_bounds__(32 * kRingWarps, kRingBlocks)
tracer_ring_kernel(Stage s, const float* __restrict__ dvv, int ncol,
                   float rr, ring::Args r, int nrb, int ngt, int group,
                   int tracers, int lag) {
  __shared__ Tile tl;
  const int t = ring::ticket(r.counter);
  const int items = nrb * r.nb;
  if (t < items) {
    const int g = t / r.nb, p = t - g * r.nb;
    const RowBlock b = row_block(s, g, ngt, group, tracers);
    for (int k0 = b.k0; k0 < b.k1; k0 += kLevels) {
      if (k0 > b.k0) __syncthreads();          // the tile's tables reused
      stage_block<false, false, kRingWarps, kRingKeep>(
          s, dvv, ncol, rr, p * kTile, k0, min(k0 + kLevels, b.k1), b.n0,
          b.n1, tl);
    }
    ring::publish(r.flags + t);
  }
  const int sw = t - r.halo - lag;
  if (kRingSweep == 0 || sw < 0 || sw >= items) return;
  const int c = sw / r.nb, j = sw - c * r.nb;
  const RowBlock b = row_block(s, c, ngt, group, tracers);
  const int k0 = b.k0, nk = b.k1 - b.k0;
  ring::Args rc = r;                   // the row block's flags and counts
  rc.flags += static_cast<size_t>(c) * r.nb;
  rc.done += static_cast<size_t>(c) * r.nb;
  const int lo = max(j - r.halo, 0), hi = min(j + r.halo, r.nb - 1);
  const int after = ring::wait(rc.flags, lo, hi);
  const ItemRows rows{nk, s.nlev, k0, b.n0, 1.f / static_cast<float>(nk)};
  const int nrows = (b.n1 - b.n0) * nk;
  if constexpr (kRingSweep == 1) {
    ring::emit4<kTile, kRingUnroll, kMix, kRingKeep, kRingL1>(
        rc, after, j, nrows, ncol, rows);
  } else if constexpr (kRingSweep == 2) {
    const int l = j * kTile + threadIdx.x;
    if (l < ncol)
      for (int n = b.n0; n < b.n1; ++n)
        ring::emit<kMix>(rc, after, static_cast<size_t>(n) * s.nlev + k0,
                         nk, l, ncol);
  }
  if constexpr (kRingDiscard && kRingSweep != 3)
    ring::retire<kTile, 32 * kRingWarps>(rc, lo, hi, nrows, ncol, false,
                                         rows);
}

// strong d/dx at lane (li, lj): sum_i Dvv[i, li] * s[i, lj]
__device__ __forceinline__ float dx(const float* dvv, const float* s, int li,
                                    int lj) {
  float acc = dvv[0 * 4 + li] * s[0 * 4 + lj];
  acc = fmaf(dvv[1 * 4 + li], s[1 * 4 + lj], acc);
  acc = fmaf(dvv[2 * 4 + li], s[2 * 4 + lj], acc);
  return fmaf(dvv[3 * 4 + li], s[3 * 4 + lj], acc);
}

// strong d/dy at lane (li, lj): sum_m Dvv[m, lj] * s[li, m]
__device__ __forceinline__ float dy(const float* dvv, const float* s, int li,
                                    int lj) {
  float acc = dvv[0 * 4 + lj] * s[li * 4 + 0];
  acc = fmaf(dvv[1 * 4 + lj], s[li * 4 + 1], acc);
  acc = fmaf(dvv[2 * 4 + lj], s[li * 4 + 2], acc);
  return fmaf(dvv[3 * 4 + lj], s[li * 4 + 3], acc);
}

constexpr int kRowThreads = 128;   // most columns a row-kernel block holds

__global__ void __launch_bounds__(kRowThreads)
tracer_row_kernel(const float* __restrict__ meta,
                  const float* __restrict__ dvv_g,
                  const float* __restrict__ vu, const float* __restrict__ vv,
                  const float* __restrict__ q, float* __restrict__ out,
                  int nlev, int qk, float dt, float rr) {
  // the element's metric values by GLL point: dinv00, dinv01, dinv10,
  // dinv11, metdet, rmetdet*rrearth
  __shared__ float mt[6][16];
  __shared__ float dvv[16];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * 16;  // element row
  if (tid < 16) {
    const float* mrow = meta + (base + tid) * 16;
    dvv[tid] = dvv_g[tid];
    mt[0][tid] = mrow[kDinv00];
    mt[1][tid] = mrow[kDinv01];
    mt[2][tid] = mrow[kDinv10];
    mt[3][tid] = mrow[kDinv11];
    mt[4][tid] = mrow[kMetdet];
    mt[5][tid] = mrow[kRmetdet] * rr;
  }
  __syncthreads();
  const int j = blockIdx.y * blockDim.x + tid;
  if (j >= qk) return;
  const int k = j % nlev;
  float qv[16], g1[16], g2[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const size_t r = base + p;
    const float x = q[r * qk + j];
    const float vq1 = vu[r * nlev + k] * x, vq2 = vv[r * nlev + k] * x;
    qv[p] = x;
    g1[p] = mt[4][p] * fmaf(mt[0][p], vq1, mt[1][p] * vq2);
    g2[p] = mt[4][p] * fmaf(mt[2][p], vq1, mt[3][p] * vq2);
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float div =
        (dx(dvv, g1, p >> 2, p & 3) + dy(dvv, g2, p >> 2, p & 3)) * mt[5][p];
    out[(base + p) * qk + j] = fmaf(-dt, div, qv[p]);
  }
}

Stage make_stage(const void* meta, const void* vu, const void* vv,
                 const void* q, const void* mx, void* out,
                 const void* fix_rank, void* slab, int nlev, int nq, int ld,
                 int wu, int wv, int fold, int iters, float dt, float ca,
                 float cb) {
  const size_t blk = static_cast<size_t>(nlev) * ld;
  Stage s;
  s.meta = static_cast<const float*>(meta);
  s.vu = static_cast<const float*>(vu) + wu * blk;
  s.vv = static_cast<const float*>(vv) + wv * blk;
  s.q = q;
  s.mx = mx;
  s.out = static_cast<float*>(out);
  s.fix_rank = static_cast<const int*>(fix_rank);
  s.slab = fix_rank ? static_cast<float*>(slab) : nullptr;
  s.ld = static_cast<size_t>(ld);
  s.nlev = nlev;
  s.nq = nq;
  s.fold = fold;
  s.iters = iters;
  s.dt = dt;
  s.ca = ca;
  s.cb = cb;
  return s;
}

dim3 stage_grid(int ncol, int nlev) {
  return dim3((ncol + kTile - 1) / kTile, (nlev + kLevels - 1) / kLevels);
}

}  // namespace

extern "C" {

const char* tracer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each launch enqueues one kernel on `stream` and returns the cudaError_t of
// the launch. Pointers are device pointers of contiguous float32 / int32
// tensors of leading dimension ld; q, mx and out hold nq*nlev rows; the winds
// are the nlev rows of vu from row wu*nlev and of vv from row wv*nlev.
// fix_rank and slab may be null (no slab output); mx may be null (no
// combination: y = e). The Euler and limited stages and the ring read and
// write float4s: every field 16-byte aligned and ld % 4 == 0 (a bf16 field
// 8-byte aligned). bf16 (the stages only): bit 0 q is bf16, bit 1 mx is
// bf16; the Euler stage takes 0 and 1, the limited stage 0, 1 (no mx) and 2
// (with mx).

int tracer_euler_launch(const void* meta, const void* dvv, const void* vu,
                        const void* vv, const void* q, void* out,
                        const void* fix_rank, void* slab, int nlev, int nq,
                        int ncol, int ld, int wu, int wv, int fold_sph,
                        int bf16, float dt, float rrearth, void* stream,
                        int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (ld % 4 || (bf16 != 0 && bf16 != 1)) return cudaErrorInvalidValue;
  const Stage s = make_stage(meta, vu, vv, q, nullptr, out, fix_rank, slab,
                             nlev, nq, ld, wu, wv, fold_sph, 0, dt, 0.f, 0.f);
  auto* kernel = bf16 ? tracer_kernel<false, false, true>
                      : tracer_kernel<false, false>;
  kernel<<<stage_grid(ncol, nlev), stage_threads(false), 0,
           static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(dvv), ncol, rrearth);
  return cudaGetLastError();
}

// The row kernel: meta [ncol, 16], vu and vv [ncol, nlev], q and out
// [ncol, qk] with qk = nq*nlev, all contiguous.
int tracer_row_launch(const void* meta, const void* dvv, const void* vu,
                      const void* vv, const void* q, void* out, int nlev,
                      int qk, int ncol, float dt, float rrearth, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int warps32 = (qk + 31) / 32 * 32;
  const int threads = warps32 < kRowThreads ? warps32 : kRowThreads;
  const dim3 grid(ncol / 16, (qk + threads - 1) / threads);
  tracer_row_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(vu), static_cast<const float*>(vv),
      static_cast<const float*>(q), static_cast<float*>(out), nlev, qk, dt,
      rrearth);
  return cudaGetLastError();
}

int tracer_limit_launch(const void* meta, const void* dvv, const void* vu,
                        const void* vv, const void* q, const void* mx,
                        void* out, const void* fix_rank, void* slab, int nlev,
                        int nq, int ncol, int ld, int wu, int wv, int iters,
                        int bf16, float dt, float ca, float cb,
                        float rrearth, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (ld % 4 || bf16 < 0 || bf16 > 2 || (bf16 == 1 && mx) ||
      (bf16 == 2 && !mx))
    return cudaErrorInvalidValue;
  const Stage s = make_stage(meta, vu, vv, q, mx, out, fix_rank, slab, nlev,
                             nq, ld, wu, wv, 1, iters, dt, ca, cb);
  auto* kernel = bf16 == 1   ? tracer_kernel<true, false, true>
                 : bf16 == 2 ? tracer_kernel<true, true, false, true>
                 : mx        ? tracer_kernel<true, true>
                             : tracer_kernel<true, false>;
  kernel<<<stage_grid(ncol, nlev), stage_threads(true), 0,
           static_cast<cudaStream_t>(stream)>>>(
      s, static_cast<const float*>(dvv), ncol, rrearth);
  return cudaGetLastError();
}

// The ring-fused Euler stage (sph folded in, with the slab) on `stream`: a
// memset of the launch's state, then one kernel of nrb*nb + halo + lag
// blocks, nb = ceil(ncol / kTile), nrb = ceil(nlev / (group*kLevels)) *
// ceil(nq / tracers) row blocks of `group` chunks of kLevels levels and
// `tracers` tracers. s1 is the
// [nq*nlev, ncol] scratch (128-byte aligned, ncol a multiple of kRingLanes:
// a tile's rows are whole L2 lines), w the swept output, mx null (no mix) or
// of w's shape; state holds nstate >= 1 + 2*nrb*nb ints: the ticket
// counter, the reader counts and the flags of every item, all cleared by
// the memset (so a CUDA graph of the launch replays correctly; the flags
// take the value 1). (group, tracers, halo, lag) are kernels/ring_fused.py::
// tracer_ring_plan's.
int tracer_ring_launch(const void* meta, const void* dvv, const void* vu,
                       const void* vv, const void* q, void* s1,
                       const void* fix_rank, void* slab, const void* rsp,
                       const void* mx, void* w, void* state, int nstate,
                       int nlev, int nq, int ncol, int wu, int wv, int nrsp,
                       int ne, int halo, int group, int tracers, int lag,
                       float dt, float rrearth, float ca, float cb,
                       void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nb = (ncol + kTile - 1) / kTile;
  if (group < 1 || tracers < 1) return cudaErrorInvalidValue;
  const int ngt = (nq + tracers - 1) / tracers;
  const int nrb = (nlev + group * kLevels - 1) / (group * kLevels) * ngt;
  const long long items = static_cast<long long>(nrb) * nb;
  if (fix_rank == nullptr || nlev < 1 || nq < 1 || ne < 1 ||
      ncol < kRingLanes || ncol % kRingLanes || lag < 0 ||
      reinterpret_cast<size_t>(s1) % 128 ||
      1 + 2 * items > nstate || !ring::covers(nb, nb, ne, halo, kTile))
    return cudaErrorInvalidValue;
  ring::Args r = {};
  r.s1 = static_cast<const float*>(s1);
  r.rsp = static_cast<const float*>(rsp);
  r.mx = static_cast<const float*>(mx);
  r.w = static_cast<float*>(w);
  r.counter = static_cast<int*>(state);
  r.done = r.counter + 1;
  r.flags = reinterpret_cast<unsigned*>(r.done + items);
  r.nrsp = nrsp;
  r.ne = ne;
  r.nb = nb;
  r.halo = halo;
  r.ca = ca;
  r.cb = cb;
  const Stage s = make_stage(meta, vu, vv, q, nullptr, s1, fix_rank, slab,
                             nlev, nq, ncol, wu, wv, 1, 0, dt, 0.f, 0.f);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(state, 0, (1 + 2 * static_cast<size_t>(items)) *
                        sizeof(int), st);
  if (err != cudaSuccess) return err;
  auto* kernel = mx ? tracer_ring_kernel<true> : tracer_ring_kernel<false>;
  kernel<<<static_cast<unsigned>(items + halo + lag), 32 * kRingWarps, 0,
           st>>>(s, static_cast<const float*>(dvv), ncol, rrearth, r,
                 nrb, ngt, group, tracers, lag);
  return cudaGetLastError();
}

// Blocks that one SM holds, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor, of kernel `kind`: 0 the
// Euler stage, 1 the ring kernel without mix, 2 the limited stage with mix,
// 3 the limited stage without mix; their bf16 instances: 4 the Euler stage
// with a bf16 q, 5 the limited stage with a bf16 q, 6 with a bf16 mx;
// negative: a CUDA error.
int tracer_blocks_per_sm(int kind, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  switch (kind) {
    case 0:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_kernel<false, false>, stage_threads(false), 0);
      break;
    case 1:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_ring_kernel<false>, 32 * kRingWarps, 0);
      break;
    case 2:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_kernel<true, true>, stage_threads(true), 0);
      break;
    case 3:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_kernel<true, false>, stage_threads(true), 0);
      break;
    case 4:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_kernel<false, false, true>, stage_threads(false), 0);
      break;
    case 5:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_kernel<true, false, true>, stage_threads(true), 0);
      break;
    case 6:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_kernel<true, true, false, true>, stage_threads(true), 0);
      break;
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
