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
// operations a point (at ne30 x 72, qsize 35: 1.79 GB, 0.535 ms at 3.35
// TB/s). The design as ported (a block of one element and 128 columns, a
// column a thread, scalar loads, the metric values staged behind a barrier
// in each of an element's 20 column blocks, the winds re-read and gv formed
// from v*q for every tracer) spent ~18 load, store and shared-memory
// instructions a point and took 1.94x its bound
// (experiments/row_tracer_variants.cu keeps it as the control). Design
// (the quad layout of the t-layout kernel turned onto rows): a thread owns
// one row li of an element's 4x4 GLL points (points li*4 .. li*4+3, four
// rows of q) and kVec = 4 contiguous columns, four levels of one tracer, as
// one float4 a point; four neighbouring threads (a quad) make the element.
// A warp's 8 quads hold 8 neighbouring level groups, so each of its loads
// and stores is 4 rows x 128 contiguous bytes. The thread forms the
// wind-metric products c1 = metdet*(dinv00*u + dinv01*v), c2 alike, of its
// 16 (point, level) pairs and its points' rmetdet*rrearth once, in
// registers, from float4 loads of the meta and wind rows (no shared memory,
// no barrier), and walks its block's chunk of tracers with stride nlev in
// the column index, the next tracer's q loaded before this one's
// arithmetic. Per level, gv1 = c1*q and gv2 = c2*q; D_y contracts the
// thread's own points, D_x takes the quad's other rows of gv1 by xor
// shuffles, in the t-layout kernel's order (advect), so the output is bit
// for bit tracer_euler_cuda's without spheremp on the transposed problem.
// Where nlev % 4 != 0 the same kernel runs with kVec = 1 (scalar columns,
// a level a quad) in blocks of 64 quads (kernels/tracer.py::row_tracer_plan
// picks it; float2 columns at an even nlev were no faster on the H100).
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
// The stages' body cut down, for experiments/kernel_variants.py (group
// tracer_bf16), which builds with TRACER_CUT: 0 (the port) the whole body;
// 1 the loads and stores alone (y = q, or its mix, with the wind products
// kept live); 2 without the limiter (the advection, the mix and sph). The
// limiter's parts follow from the port's build at iters 0, 1 and 2.
#ifdef TRACER_CUT
constexpr int kCut = TRACER_CUT;
#else
constexpr int kCut = 0;
#endif
// The limited stage with a bf16 q keeps the tracers it prefetches raw (a
// uint2 of 4 bf16 lanes, 2 registers where the upcast V4 takes 4) and
// upcasts each at its use, kBfAhead tracers ahead at each level: in the
// registers of the f32 instance's one float4 ahead, twice its tracers in
// flight. experiments/kernel_variants.py (group tracer_bf16) builds with
// TRACER_BF_AHEAD=0 the design before (one tracer ahead, upcast as it was
// loaded) and 1 (one raw tracer ahead).
#ifdef TRACER_BF_AHEAD
constexpr int kBfAhead = TRACER_BF_AHEAD;
#else
constexpr int kBfAhead = 2;
#endif
// Every limited instance (f32 or bf16 q, with or without mx) skips the
// room, the give and the division of a limiter pass for a warp whose
// elements all have nothing to give (limit, kSkip): in E3SM's ne30 step
// with 35 tracers half of the warp-passes, nearly all second passes, have
// none. The Euler and ring instances run no limiter.
// experiments/kernel_variants.py builds with TRACER_SKIP=0 (no instance
// skips), the control that the skip keeps every bit.
#ifdef TRACER_SKIP
constexpr bool kSkipLimit = TRACER_SKIP != 0;
#else
constexpr bool kSkipLimit = true;
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

// four bf16 lanes from element o (8 bytes, o a multiple of 4), raw
__device__ __forceinline__ uint2 ld4raw(const void* __restrict__ p,
                                        size_t o) {
  return *reinterpret_cast<const uint2*>(
      static_cast<const __nv_bfloat16*>(p) + o);
}

// four raw bf16 lanes upcast exactly
__device__ __forceinline__ V4 up4(uint2 w) {
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&w.y));
  return V4{{a.x, a.y, b.x, b.y}};
}

// four lanes of a tracer operand from element o: float, or with kBf bf16
// upcast exactly
template <bool kBf>
__device__ __forceinline__ V4 ld4op(const void* __restrict__ p, size_t o) {
  if constexpr (kBf)
    return up4(ld4raw(p, o));
  else
    return ld4(static_cast<const float*>(p), o);
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

// A warp's limiter counts in the counting twin (tracer_count_kernel), the
// same in every lane: the passes computed in full, those among them in
// which some element of the warp had a deficit, the passes skipped (kSkip),
// and the lanes with a deficit over the passes (4 an element: a quad's
// threads hold the same d).
struct Count {
  unsigned full = 0, deficit = 0, skipped = 0, lanes = 0;
};

// The limiter on the thread's 4 lanes: bounds from the stage input q,
// weights w = sph, `iters` clip-and-redistribute passes with the carry,
// then the residual spread uniformly by weight. With kSkip a pass in which
// no element of the warp has a deficit (d = 0) skips the room, the give and
// the division: c = +0 and give = d, which the whole pass gives too (pos
// is false, give = +-0, c = |+-0 / tot| = +0), so the update fmaf(c, lo -
// yc, yc) is its result bit for bit, and the carry's zero sign never
// reaches y. Both take the one update, and the pass loop is not unrolled:
// so the mix instance spills no more at its 64 registers than without the
// skip (32 bytes on the H100; unrolled, with the update in each branch,
// 40). With kCount each pass is counted into cnt (the arithmetic is
// untouched). Every thread of the warp must call it.
template <bool kSkip, bool kCount = false>
__device__ __forceinline__ V4 limit(V4 y, const V4& q, const V4& w,
                                    float wsum, int iters,
                                    Count* cnt = nullptr) {
  const float lo = qmin(q), hi = qmax(q);
  V4 a;
#pragma unroll
  for (int j = 0; j < 4; ++j) a.v[j] = w.v[j] * y.v[j];
  const float mass = qsum(a);
  float carry = 0.f;
#pragma unroll 1
  for (int i = 0; i < iters; ++i) {
    V4 yc;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      yc.v[j] = fminf(fmaxf(y.v[j], lo), hi);
      a.v[j] = w.v[j] * (y.v[j] - yc.v[j]);
    }
    // the deficit from the clipped-off amounts: no cancellation
    const float d = qsum(a) + carry;
    if constexpr (kCount) {
      const unsigned has = __ballot_sync(kFull, d != 0.f);
      cnt->lanes += __popc(has);
      if (kSkip && has == 0u) {
        ++cnt->skipped;
      } else {
        ++cnt->full;
        cnt->deficit += has != 0u;
      }
    }
    const bool pos = d > 0.f;
    const float bsel = pos ? hi : lo;
    float c = 0.f, give = d;
    if (!kSkip || !__all_sync(kFull, d == 0.f)) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        a.v[j] = w.v[j] * (pos ? hi - yc.v[j] : yc.v[j] - lo);
      const float tot = qsum(a);
      give = pos ? fminf(d, tot) : fmaxf(d, -tot);
      c = fabsf(__fdiv_rn(give, fmaxf(tot, FLT_MIN)));
    }
    carry = d - give;
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
// write the same bits; with kCount the limiter counts its passes into
// cnt. Every thread of the warp must call it.
template <bool kLimit, bool kMix, bool kKeep = false, bool kSkip = false,
          bool kCount = false>
__device__ __forceinline__ void stage_row(const Quad& t, const Tile& tl,
                                          const Stage& s, const Wind& w,
                                          const V4& qv, const V4& mv,
                                          size_t o, size_t row,
                                          unsigned long long keep,
                                          Count* cnt = nullptr) {
  V4 y;
  if constexpr (kCut == 1) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y.v[j] = fmaf(0.f, w.c1.v[j] + w.c2.v[j], qv.v[j]);
  } else {
    y = advect(t, tl, w, qv, s.dt);
  }
  if constexpr (kMix) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      y.v[j] = __fadd_rn(__fmul_rn(s.ca, mv.v[j]), __fmul_rn(s.cb, y.v[j]));
  }
  if (kLimit || s.fold) {
    const V4 sph = lds4(tl.sph + t.qi);
    if constexpr (kLimit && kCut == 0)
      y = limit<kSkip, kCount>(y, qv, sph, t.wsum, s.iters, cnt);
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
// start before the current tracer's rows run (with kRawQ, the limited
// stage's bf16 q, the next kBfAhead tracers' q, kept raw). With kKeep (the
// ring) out is stored evict-last in L2; with kQBf (kMxBf) q (mx) is bf16.
// With kCount (the counting twin) each warp adds its limiter counts into
// counts[4] at its end, one atomic a count (profiling.LIMITER_COUNTS's
// order). Every thread of the block must call it.
template <bool kLimit, bool kMix, int kWarps, bool kKeep = false,
          bool kQBf = false, bool kMxBf = false, bool kCount = false>
__device__ __forceinline__ void stage_block(
    const Stage& s, const float* __restrict__ dvv, int ncol, float rr,
    int lane0, int k0, int k1, int n0, int n1, Tile& tl,
    unsigned long long* __restrict__ counts = nullptr) {
  constexpr int kPer = kLevels / kWarps;         // levels a warp takes
  constexpr int kGroup = (kLimit ? kGroupLimit : kGroupEuler) < kPer
                             ? (kLimit ? kGroupLimit : kGroupEuler)
                             : kPer;
  static_assert(kLevels % kWarps == 0 && kPer % kGroup == 0,
                "a chunk's levels split over the warps, a warp's in groups");
  constexpr bool kRawQ = kLimit && kQBf && kBfAhead > 0;
  constexpr int kAhead = kRawQ ? kBfAhead : 1;
  static_assert(!kRawQ || !kMix, "the limited stage takes a bf16 q unmixed");
  constexpr bool kSkip = kLimit && kSkipLimit;
  const Quad t = load_tile(tl, s.meta, dvv, s.fix_rank, s.ld, ncol, lane0,
                           rr);
  const int kw = k0 + static_cast<int>(threadIdx.x >> 5);
  const size_t step = static_cast<size_t>(s.nlev) * s.ld;   // a tracer
  [[maybe_unused]] const unsigned long long keep =
      kKeep ? ring::evict_last() : 0ull;
  [[maybe_unused]] Count cnt;
#pragma unroll 1
  for (int g = 0; g < kPer; g += kGroup) {
    bool on[kGroup];          // warp-uniform: the level is in the chunk
    Wind w[kGroup];
    size_t o[kGroup];
    V4 qn[kGroup], mn[kGroup];
    uint2 qr[kGroup][kAhead];   // kRawQ: tracers n .. n + kAhead - 1, raw
#pragma unroll
    for (int i = 0; i < kGroup; ++i) {
      const int k = kw + (g + i) * kWarps;
      on[i] = k < k1;
      w[i] = on[i] ? wind_products(t, s, k) : Wind{zero4(), zero4()};
      o[i] = static_cast<size_t>(k) * s.ld + t.col + n0 * step;
      qn[i] = mn[i] = zero4();
#pragma unroll
      for (int j = 0; j < kAhead; ++j) qr[i][j] = make_uint2(0u, 0u);
      if (on[i] && t.live) {
        if constexpr (kRawQ) {
#pragma unroll
          for (int j = 0; j < kAhead; ++j)
            if (n0 + j < n1) qr[i][j] = ld4raw(s.q, o[i] + j * step);
        } else {
          qn[i] = ld4op<kQBf>(s.q, o[i]);
        }
        if constexpr (kMix) mn[i] = ld4op<kMxBf>(s.mx, o[i]);
      }
    }
    for (int n = n0; n < n1; ++n) {
      V4 qv[kGroup], mv[kGroup];
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        mv[i] = mn[i];
        if constexpr (kRawQ) {
          qv[i] = up4(qr[i][0]);                 // upcast at its use
#pragma unroll
          for (int j = 0; j + 1 < kAhead; ++j) qr[i][j] = qr[i][j + 1];
          if (on[i] && t.live && n + kAhead < n1)
            qr[i][kAhead - 1] = ld4raw(s.q, o[i] + kAhead * step);
        } else {
          qv[i] = qn[i];
          if (on[i] && t.live && n + 1 < n1) {   // the next tracer's loads
            qn[i] = ld4op<kQBf>(s.q, o[i] + step);
            if constexpr (kMix) mn[i] = ld4op<kMxBf>(s.mx, o[i] + step);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        if (on[i])
          stage_row<kLimit, kMix, kKeep, kSkip, kCount>(
              t, tl, s, w[i], qv[i], mv[i], o[i],
              static_cast<size_t>(n) * s.nlev + kw + (g + i) * kWarps, keep,
              &cnt);
        o[i] += step;
      }
    }
  }
  if constexpr (kCount) {
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(counts, static_cast<unsigned long long>(cnt.full));
      atomicAdd(counts + 1, static_cast<unsigned long long>(cnt.deficit));
      atomicAdd(counts + 2, static_cast<unsigned long long>(cnt.skipped));
      atomicAdd(counts + 3, static_cast<unsigned long long>(cnt.lanes / 4));
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

// The counting twin of the limited stage tracer_kernel<true, kMix, kQBf,
// kMxBf>: the same body, so the same bits, with each warp's limiter counts
// added into counts[4] (stage_block). A separate instance, so that the one
// the cadence runs is not touched; the wrapper launches it only while the
// profiling counters are on.
template <bool kMix, bool kQBf = false, bool kMxBf = false>
__global__ void __launch_bounds__(32 * kWarpsLimit, kMinLimit)
tracer_count_kernel(Stage s, const float* __restrict__ dvv, int ncol,
                    float rr, unsigned long long* __restrict__ counts) {
  __shared__ Tile tl;
  const int k0 = blockIdx.y * kLevels;
  stage_block<true, kMix, kWarpsLimit, false, kQBf, kMxBf, true>(
      s, dvv, ncol, rr, blockIdx.x * kTile, k0, min(k0 + kLevels, s.nlev), 0,
      s.nq, tl, counts);
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

// The row kernel's design, each part a constant that
// experiments/kernel_variants.py (group row_tracer) builds otherwise, the
// port's value first:
//   kRowQuads      quads (4-thread groups) a block with float4 columns: 32
//                  (128 threads);
//   kRowQuadsNarrow  the same with scalar columns: 64;
//   kRowAhead      the next tracer's q loaded before this one's arithmetic
//                  (1), or after its store (0);
//   kRowMinBlocks  the blocks an SM the float4 instance's registers are
//                  capped for: 4 (128 registers, no spills; on the H100
//                  at ne30 x 72, qsize 35, 0.6356 ms against 0.6459-
//                  0.6510 uncapped at 158 registers and 3 blocks, and
//                  0.68 capped for 5 at 96 with spills).
#ifdef TRACER_ROW_QUADS
constexpr int kRowQuads = TRACER_ROW_QUADS;
#else
constexpr int kRowQuads = 32;
#endif
#ifdef TRACER_ROW_QUADS_NARROW
constexpr int kRowQuadsNarrow = TRACER_ROW_QUADS_NARROW;
#else
constexpr int kRowQuadsNarrow = 64;
#endif
#ifdef TRACER_ROW_AHEAD
constexpr int kRowAhead = TRACER_ROW_AHEAD;
#else
constexpr int kRowAhead = 1;
#endif
#ifdef TRACER_ROW_MIN_BLOCKS
constexpr int kRowMinBlocks = TRACER_ROW_MIN_BLOCKS;
#else
constexpr int kRowMinBlocks = 4;
#endif
template <int kVec>
constexpr int kRowQuadsOf = kVec == 4 ? kRowQuads : kRowQuadsNarrow;
template <int kVec>
constexpr int kRowMinOf = kVec == 4 ? kRowMinBlocks : 1;

// kVec contiguous columns of one row: a float4 or a float
template <int kVec>
struct Cols {
  float v[kVec];
};

template <int kVec>
__device__ __forceinline__ Cols<kVec> ldc(const float* __restrict__ p,
                                          size_t o) {
  Cols<kVec> c;
  if constexpr (kVec == 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + o);
    c.v[0] = f.x;
    c.v[1] = f.y;
    c.v[2] = f.z;
    c.v[3] = f.w;
  } else {
    static_assert(kVec == 1, "kVec is 4 or 1");
    c.v[0] = p[o];
  }
  return c;
}

template <int kVec>
__device__ __forceinline__ void stc(float* __restrict__ p, size_t o,
                                    const Cols<kVec>& c) {
  if constexpr (kVec == 4)
    *reinterpret_cast<float4*>(p + o) =
        make_float4(c.v[0], c.v[1], c.v[2], c.v[3]);
  else
    p[o] = c.v[0];
}

// The operands of one row-kernel launch.
struct RowArgs {
  const float* __restrict__ meta;    // [ncol, 16], META_COLS columns
  const float* __restrict__ dvv;     // [4, 4]
  const float* __restrict__ vu;      // [ncol, nlev]
  const float* __restrict__ vv;
  const float* __restrict__ q;       // [ncol, nq*nlev]
  float* __restrict__ out;
  int nlev, nq;
  int groups;                        // level groups of kVec: nlev / kVec
  int nquads;                        // (ncol / 16) * groups
  int tracers, chunks;               // tracers a block; chunks of them
  float dt, rr;
};

// the q of tracer n at the thread's 4 points and kVec levels
template <int kVec>
__device__ __forceinline__ void row_load(Cols<kVec> (&c)[4],
                                         const RowArgs& a, size_t row0,
                                         size_t qk, int col) {
#pragma unroll
  for (int lj = 0; lj < 4; ++lj) c[lj] = ldc<kVec>(a.q, (row0 + lj) * qk + col);
}

template <int kVec>
__global__ void __launch_bounds__(4 * kRowQuadsOf<kVec>, kRowMinOf<kVec>)
tracer_row_kernel(const RowArgs a) {
  const int li = threadIdx.x & 3;
  const int chunk = blockIdx.x % a.chunks;
  const int quad =
      blockIdx.x / a.chunks * kRowQuadsOf<kVec> + (threadIdx.x >> 2);
  // a quad is live or dead whole; a dead one joins the shuffles alone
  const bool live = quad < a.nquads;
  const int e = live ? quad / a.groups : 0;
  const int k0 = (live ? quad - e * a.groups : 0) * kVec;
  const size_t row0 = static_cast<size_t>(e) * 16 + li * 4;
  const size_t qk = static_cast<size_t>(a.nq) * a.nlev;
  // D_x weights Dvv[li ^ m, li]; D_y weights Dvv[m, 0..3]
  float wx[4];
  V4 wy[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wx[m] = a.dvv[(m ^ li) * 4 + li];
    wy[m] = ld4(a.dvv, 4 * m);
  }
  // c1, c2 of each (level, point) and rmetdet*rrearth of each point
  V4 c1[kVec], c2[kVec], rmr;
#pragma unroll
  for (int lv = 0; lv < kVec; ++lv) c1[lv] = c2[lv] = zero4();
  rmr = zero4();
  if (live) {
#pragma unroll
    for (int lj = 0; lj < 4; ++lj) {
      const float* m = a.meta + (row0 + lj) * 16;
      const float4 d = *reinterpret_cast<const float4*>(m + kDinv00);
      const float4 g = *reinterpret_cast<const float4*>(m + kMetdet);
      rmr.v[lj] = g.y * a.rr;
      const Cols<kVec> u = ldc<kVec>(a.vu, (row0 + lj) * a.nlev + k0);
      const Cols<kVec> v = ldc<kVec>(a.vv, (row0 + lj) * a.nlev + k0);
#pragma unroll
      for (int lv = 0; lv < kVec; ++lv) {
        c1[lv].v[lj] = g.x * fmaf(d.x, u.v[lv], d.y * v.v[lv]);
        c2[lv].v[lj] = g.x * fmaf(d.z, u.v[lv], d.w * v.v[lv]);
      }
    }
  }
  const int n0 = chunk * a.tracers;
  const int n1 = min(n0 + a.tracers, a.nq);
  Cols<kVec> cur[4] = {};
  if (kRowAhead && live) row_load(cur, a, row0, qk, n0 * a.nlev + k0);
  for (int n = n0; n < n1; ++n) {
    const int col = n * a.nlev + k0;
    Cols<kVec> nxt[4] = {};
    if (live) {
      if (!kRowAhead)
        row_load(cur, a, row0, qk, col);
      else if (n + 1 < n1)
        row_load(nxt, a, row0, qk, col + a.nlev);
    }
    Cols<kVec> y[4];
#pragma unroll
    for (int lv = 0; lv < kVec; ++lv) {
      V4 q, g1, g2;
#pragma unroll
      for (int lj = 0; lj < 4; ++lj) {
        q.v[lj] = cur[lj].v[lv];
        g1.v[lj] = c1[lv].v[lj] * q.v[lj];
        g2.v[lj] = c2[lv].v[lj] * q.v[lj];
      }
      // rows li ^ 1, li ^ 2, li ^ 3 of gv1
      const V4 r1 = shfl_xor4(g1, 1), r2 = shfl_xor4(g1, 2),
               r3 = shfl_xor4(g1, 3);
#pragma unroll
      for (int lj = 0; lj < 4; ++lj) {
        // strong d/dx at (li, lj): sum_i Dvv[i, li] * gv1[i, lj], i = li ^ m
        float ax = wx[0] * g1.v[lj];
        ax = fmaf(wx[1], r1.v[lj], ax);
        ax = fmaf(wx[2], r2.v[lj], ax);
        ax = fmaf(wx[3], r3.v[lj], ax);
        // strong d/dy at (li, lj): sum_m Dvv[m, lj] * gv2[li, m]
        float ay = wy[0].v[lj] * g2.v[0];
        ay = fmaf(wy[1].v[lj], g2.v[1], ay);
        ay = fmaf(wy[2].v[lj], g2.v[2], ay);
        ay = fmaf(wy[3].v[lj], g2.v[3], ay);
        y[lj].v[lv] = fmaf(-a.dt, (ax + ay) * rmr.v[lj], q.v[lj]);
      }
    }
    if (live) {
#pragma unroll
      for (int lj = 0; lj < 4; ++lj) stc(a.out, (row0 + lj) * qk + col, y[lj]);
    }
    if (kRowAhead) {
#pragma unroll
      for (int lj = 0; lj < 4; ++lj) cur[lj] = nxt[lj];
    }
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

// The limited stage's launch (tracer_limit_launch), or with counts its
// counting twin's (tracer_limit_count_launch).
int limit_launch(const void* meta, const void* dvv, const void* vu,
                 const void* vv, const void* q, const void* mx, void* out,
                 const void* fix_rank, void* slab, int nlev, int nq,
                 int ncol, int ld, int wu, int wv, int iters, int bf16,
                 float dt, float ca, float cb, float rrearth, void* stream,
                 int device, void* counts) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (ld % 4 || bf16 < 0 || bf16 > 2 || (bf16 == 1 && mx) ||
      (bf16 == 2 && !mx))
    return cudaErrorInvalidValue;
  const Stage s = make_stage(meta, vu, vv, q, mx, out, fix_rank, slab, nlev,
                             nq, ld, wu, wv, 1, iters, dt, ca, cb);
  const dim3 grid = stage_grid(ncol, nlev);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dvv);
  if (counts) {
    auto* kernel = bf16 == 1   ? tracer_count_kernel<false, true>
                   : bf16 == 2 ? tracer_count_kernel<true, false, true>
                   : mx        ? tracer_count_kernel<true>
                               : tracer_count_kernel<false>;
    kernel<<<grid, stage_threads(true), 0, st>>>(
        s, d, ncol, rrearth, static_cast<unsigned long long*>(counts));
  } else {
    auto* kernel = bf16 == 1   ? tracer_kernel<true, false, true>
                   : bf16 == 2 ? tracer_kernel<true, true, false, true>
                   : mx        ? tracer_kernel<true, true>
                               : tracer_kernel<true, false>;
    kernel<<<grid, stage_threads(true), 0, st>>>(s, d, ncol, rrearth);
  }
  return cudaGetLastError();
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
// [ncol, nq*nlev], all contiguous, ncol a multiple of 16; vec 4 (nlev % 4
// == 0, and q, out, vu and vv 16-byte aligned) or 1; `tracers` a block
// (kernels/tracer.py::row_tracer_plan). meta and dvv 16-byte aligned.
int tracer_row_launch(const void* meta, const void* dvv, const void* vu,
                      const void* vv, const void* q, void* out, int nlev,
                      int nq, int ncol, int vec, int tracers, float dt,
                      float rrearth, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  auto off = [](const void* p, int bytes) {
    return reinterpret_cast<size_t>(p) % bytes != 0;
  };
  if (nlev < 1 || nq < 1 || ncol < 16 || ncol % 16 || tracers < 1 ||
      (vec != 1 && vec != 4) || nlev % vec || off(meta, 16) ||
      off(dvv, 16) || off(vu, 4 * vec) || off(vv, 4 * vec) ||
      off(q, 4 * vec) || off(out, 4 * vec))
    return cudaErrorInvalidValue;
  RowArgs a;
  a.meta = static_cast<const float*>(meta);
  a.dvv = static_cast<const float*>(dvv);
  a.vu = static_cast<const float*>(vu);
  a.vv = static_cast<const float*>(vv);
  a.q = static_cast<const float*>(q);
  a.out = static_cast<float*>(out);
  a.nlev = nlev;
  a.nq = nq;
  a.groups = nlev / vec;
  a.nquads = ncol / 16 * a.groups;
  a.tracers = tracers;
  a.chunks = (nq + tracers - 1) / tracers;
  a.dt = dt;
  a.rr = rrearth;
  const int quads = vec == 4 ? kRowQuads : kRowQuadsNarrow;
  const long long blocks =
      static_cast<long long>((a.nquads + quads - 1) / quads) * a.chunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto* kernel = vec == 4 ? tracer_row_kernel<4> : tracer_row_kernel<1>;
  kernel<<<static_cast<unsigned>(blocks), 4 * quads, 0,
           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

int tracer_limit_launch(const void* meta, const void* dvv, const void* vu,
                        const void* vv, const void* q, const void* mx,
                        void* out, const void* fix_rank, void* slab, int nlev,
                        int nq, int ncol, int ld, int wu, int wv, int iters,
                        int bf16, float dt, float ca, float cb,
                        float rrearth, void* stream, int device) {
  return limit_launch(meta, dvv, vu, vv, q, mx, out, fix_rank, slab, nlev,
                      nq, ncol, ld, wu, wv, iters, bf16, dt, ca, cb, rrearth,
                      stream, device, nullptr);
}

// tracer_limit_launch's counting twin: the same arguments and bits, and the
// limiter's counts added into counts, four int64 on the device
// (profiling.LIMITER_COUNTS: the warp-passes computed in full, those with a
// deficit, the warp-passes skipped, the element-passes with a deficit).
int tracer_limit_count_launch(const void* meta, const void* dvv,
                              const void* vu, const void* vv, const void* q,
                              const void* mx, void* out, const void* fix_rank,
                              void* slab, int nlev, int nq, int ncol, int ld,
                              int wu, int wv, int iters, int bf16, float dt,
                              float ca, float cb, float rrearth, void* stream,
                              int device, void* counts) {
  if (counts == nullptr) return cudaErrorInvalidValue;
  return limit_launch(meta, dvv, vu, vv, q, mx, out, fix_rank, slab, nlev,
                      nq, ncol, ld, wu, wv, iters, bf16, dt, ca, cb, rrearth,
                      stream, device, counts);
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
// with a bf16 q, 5 the limited stage with a bf16 q, 6 with a bf16 mx; the
// row kernel: 7 with float4 columns, 8 with scalar columns; negative: a
// CUDA error.
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
    case 7:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_row_kernel<4>, 4 * kRowQuads, 0);
      break;
    case 8:
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, tracer_row_kernel<1>, 4 * kRowQuadsNarrow, 0);
      break;
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
