// CAAR (compute_and_apply_rhs) on the packed layouts: [nlev, E16] ("t") and
// [E16, nlev] ("row"), rsplit>0 and rsplit=0.
//
// Replaces the Pallas kernels of tinman_sandbox_tpu/kernels/caar_pallas_t.py:
// caar_pallas_packed_t4_lg (the bench headline), caar_pallas_packed_t,
// caar_pallas_packed_t4 and the single-state Runge-Kutta stage kernel
// caar_pallas_packed_t4_rk. All run _caar_physics plus the accumulator
// update; they differ only in how the buffers are cut, so this one kernel
// takes one pointer per field row block and covers the stacked and the
// unstacked forms. Its rsplit=0 mode replaces caar_pallas_packed_rsplit0_t
// (caar_pallas_t.py:856); its row mode replaces caar_pallas_packed and
// caar_pallas_packed_rsplit0 of tinman_sandbox_tpu/kernels/caar_pallas.py
// (:307, :365). The modes are template parameters (see below).
//
// What bounds it on the H100: device-memory traffic. Per step it must read
// 13 fields (n0 and nm1 prognostics, qdp, pecnd, three accumulators) and the
// meta rows, and write 8 fields: about 99 MB at 1024 x 72, some 30 us at
// 3.35 TB/s, against ~0.2 GFLOP of FP32 work (~3 us at 67 TFLOP/s). The
// rsplit=0 mode adds the eta accumulator, read and written: 23 fields.
//
// One body, the level-chunked caar_chunked, for every mode: the t layout at
// rsplit>0 (pair and stage forms, the slab; the bench, assembled, dynamics
// and prim steps and the ring) and at rsplit=0, and the row layout at both
// rsplits (below). Why: the column-a-thread body it replaced gave the card
// E16 threads in all (16,384 at 1024 x 72: 128
// blocks of 4 warps, one a SM) and walked 72 levels three times with a
// __syncthreads at each, so it was latency-bound at 2.5-4.8x its memory
// bound; at ne30 its 675 blocks of 44 KB left 15 for a second wave.
// The chunked body splits the level axis over warps: a block takes a tile
// of kTile columns (a template constant: 32 in caar_chunk_kernel, the
// ring's 128) in `chunks` level chunks of `levels` levels, kTile*chunks
// threads, so a warp is 32 consecutive columns (two whole
// elements) of one chunk: its loads of a level's row coalesce into whole
// 128-byte lines and the 4-point Dvv contractions (grad, div, vort) are
// warp shuffles inside the element, 4-term FP32 FMAs on the 4x4 Dvv in the
// order the column-a-thread body took (no exchange row, no per-level
// barrier).
// The three vertical recurrences (the midpoint pressure's running dp sum,
// the reverse strict q sum into phi, the running divdp sum that omega needs)
// become chunk-local running sums started at the sum of the other chunks'
// totals, exchanged through shared memory: two barriers a step in place of
// three a level. divdp's totals need the contractions, so pass 2 computes q
// and divdp together (caar_chunked's note lists the passes). Pass 1 reads
// dp, pass 2 dp, t, qdp, u and v, pass 3 all 13 input fields: where the
// plan has the stash (nlev <= 146) passes 2 and 3 take what earlier passes
// read from shared memory, else the re-reads come back from L2 (a block's
// columns are a few tens of KB). The f32 sums
// therefore run in another order than a single running sum: each output
// stays within 5e-5 scaled of the plain version (chip_smoke.py phases 3, 5,
// 9; tests/test_torch_plan.py repeats the order on the CPU), and a column's
// bits depend on nlev and (chunks, levels) only. The plan (chunks, levels,
// stash) is kernels/caar_t.py::caar_plan, a pure function of (ncol, nlev);
// chunks and levels depend on nlev alone, so a shard's step (fewer columns)
// has the whole sphere's bits. The dxbt/dybt block-diagonal operators and
// triangular scan matrices of the TPU kernel fed its matrix unit; here the
// scans are running sums. No TF32.
// The row layout at both rsplits (kRow, caar_row_kernel) runs the same
// chunked body on [E16, nlev] fields, where a tile's 32 columns are one
// contiguous span of 32*nlev floats a field (9,216 bytes at nlev 72): the
// block copies each input's span into a shared-memory plane [nlev][32]
// with 4-byte cp.async, a warp's 32 copies one whole 128-byte line, the
// plane XOR-swizzled (column x of level k at k*32 + (x ^ (k & 31))) so that
// neither the copies (consecutive levels of a column) nor the passes (one
// level of 32 columns) meet a bank twice; pass 3 leaves the tendencies,
// omega_p and eta_hi in planes, and an epilogue walks the span again,
// reads the nm1 state and the accumulators a line at a time, applies the
// update with the t form's expressions and writes every output a line at a
// time. The arithmetic is the t form's line for line, so on the transposed
// problem the row kernel gives caar_chunk_kernel's bits. Shared memory:
// 9 planes (phi; dp, u, v, T, qdp, pecnd; two tendency planes; the others
// over pecnd, qdp and T), 11 at rsplit=0 (ttens and eta_hi apart: the
// vertical advection reads T at other chunks' levels), the chunk totals
// and the meta: 86 KB and 104 KB at nlev 72, two blocks an SM; staged up to
// 197 and 161 levels (one block). Above that it is windowed: phi's plane
// stays, and each warp copies a window of kRowWindow levels of its chunk
// for the tile's 32 columns (8 lanes a column: 32-byte sectors) into 13
// slots of its own (14 at rsplit=0), pass by pass, and writes a window's
// outputs back the same way: 165 KB at 400 levels, one block an SM
// (kernels/caar_t.py::caar_row_plan). Reading and writing in place at
// col*nlev + k instead thrashed L1 (32 lines a field a warp).
// The t layout's rsplit=0 mode (caar_r0_kernel, caar_packed_rsplit0_t) runs
// the same kR0 body on the t kernel's stash: caar_plan(r0=True), the row
// kernel's chunks, so on the transposed problem it gives the row rsplit=0
// kernel's bits at every nlev. It replaced a column-a-thread body (one
// thread a column in 128-column blocks, three walks over the levels with a
// __syncthreads at each, one more in the first to sum divdp for sdot):
// 6.1x its bound at 1024 x 72 and 2.8x at ne30 on the H100.
// Optional fix-lane slab (replaces the sf/cq slab modes of
// caar_pallas_packed_t4_lg :552-630 and caar_pallas_packed_t4_ext :652):
// the thread owning a column with fix_rank[col] = r >= 0 also writes its
// four outputs u1/v1/t1/dp1 at every level to row r of the slab,
// slab[r*slab_ld + f*nlev + k] for field f, the pre-DSS values that the
// DSS fixup (csrc/dss.cu) reads; without a slab fix_rank is null.
// Runge-Kutta stage mode (caar_pallas_packed_t4_rk :740 and the single=True
// mode of caar_pallas_packed_t4_lg; chunked body): with a null um1 the base
// state of the
// update IS the evaluation state, s1 = spheremp*(s0 + dt2*tendency), and the
// four nm1 row blocks are never fetched (17 row blocks of traffic in place of
// 21). With a null phi the geopotential is not stored (16 row blocks): only
// the last stage of a step needs it. Both modes are template parameters, not
// branches: a test of the pointers inside the level loop kept the compiler
// from issuing the 13 loads of a level together and cost the pair form 8%
// at 5,400 x 72 and 20% at 1024 x 72 on the H100.
// rsplit=0 mode (kR0, a non-null etaacc): the interface mass flux
//   eta_lo(k) = hybi(k)*sdot - sum_{l<k} divdp(l),   0 at k = 0,
//   eta_hi(k) = hybi(k+1)*sdot - sum_{l<=k} divdp(l), 0 at k = nlev-1,
// with sdot = sum_k divdp(k) the column total, then the vertical advection
// of u, v and T, dp1 = sph*(dpm1 - dt2*(divdp + eta_hi - eta_lo)) and
// etaacc += eta_ave_w*eta_hi in place (interfaces 1..nlev). The boundary
// zeros are forced by the level test, not computed (hybi(nlev)*sdot - sdot
// is not 0 in f32). hybi comes as two strided vectors (hyb_lo[k*hs] =
// hybi(k), hyb_hi[k*hs] = hybi(k+1)), so the [nlev, 2] hyb of the t kernel
// and the [2, nlev] of the row kernel go in without a copy. sdot is the sum
// of pass 2's chunk totals, the advection reads the neighbouring levels
// from the planes or the stash (else from device memory), and the dp
// tendency is formed as the (hybi(k+1) - hybi(k))*sdot it equals,
// without the f32 cancellation of divdp + eta_hi - eta_lo. The row mode
// takes neither a slab nor the stage mode, and the rsplit=0 modes no slab:
// no caller needs them.
//
// Ring-fused mode (caar_ring_kernel): replaces caar_ring_packed_t4 of
// tinman_sandbox_tpu/kernels/ring_fused.py (:189, body _caar_ring_kernel
// :106), the CAAR step and the rspheremp-scaled alpha/beta sweep of its s1
// in one launch, optionally with the sweep's mix epilogue. A block runs
// caar_chunked on the chunked kernel's own tile and plan (32 columns in
// caar_plan's chunks, its stash where it takes it: so the same bits, and
// three blocks an SM) into a scratch s1, stored evict-last in L2, flags
// the tile, then sweeps the tile halo + lag tickets behind it in float4
// groups with the sweep kernel's sums (ring::emit4, dss_sweep.cuh; s1 read
// through L1, w stored evict-first), waiting for the tiles that sweep
// reads, and discards from L2 the s1 lines of the tiles whose last reader
// it is (ring.cuh). The fix lanes keep their in-face partial sums; the
// fixup and the patch (dss.cu) complete the DSS. Bound: the CAAR step's
// bytes and the swept output. What the H100 showed
// (experiments/kernel_variants.py ring, PERF.md): the design before
// (128-column tiles of 1024 threads, one block an SM, a lane-a-thread
// sweep through L2, s1 written back) lost ~0.09 ms to its 128-column
// producer and ~0.31 to its sweep at ne30 x 72; here the producer costs
// what the chunked kernel does, the lag leaves the waits little to spin
// on, and the hints and the discard keep most of s1 out of device memory,
// but the sweep's w stores and partner loads still add ~0.07 ms to a
// producer that is not bound by bytes, so the ring stays slower than the
// two launches it fuses.
// The stage and phi modes carry over; the ring takes neither rsplit=0 nor
// the row layout.
//
// Mixed-precision storage (kSt, the `storage` argument of both launches;
// replaces the storage= modes of caar_pallas_t.py:903-950 and
// caar_pallas.py:415-477): 0 every operand f32; 1 ("bf16_aux") qdp and
// pecnd stored bf16; 2 ("bf16_ro") also um1, vm1, tm1 and dpm1; 3 pecnd
// alone bf16 (the stage mode only). The kernel
// reads a bf16 operand itself, 2 bytes an element, and upcasts it exactly
// (__bfloat162float) into the f32 register, stash, plane or window slot
// where the f32 operand would have landed; compute and every output stay
// f32 and the arithmetic is unchanged, so each storage mode gives, bit for
// bit, the f32 mode on the bf16 operands upcast. bf16_ro cuts the pair
// step's 21 fields of traffic by 3 (the root bench's ~23% of the reads).
// cp.async moves 4 bytes at least, so the bf16 operands leave the cp.async
// groups: the row kernel's staging loads each bf16 span two elements at a
// time (one 4-byte load; the span starts on an even element and holds a
// whole number of elements' 16 columns, so it is even) into the f32 planes
// after issuing the f32 groups; the
// windowed mode fills its f32 slots with single loads, and the t layout (a
// thread a column) and the row epilogue read their bf16 elements with
// plain loads. The stage mode (t layout, with or without phi, the stash
// and the slab) takes the two mixes that the JAX package's full step hands
// its stage kernel under `bench --prim --storage` (bench.py:340-352):
// bf16 qdp and pecnd (1: the first step, and every step of `--rk`), and an
// f32 qdp beside a bf16 pecnd (3: the tracers write f32, the rotation keeps
// pecnd). The ring kernel's stage mode takes f32 only. Each storage is a
// template instance, made only where a launch reaches it (the pair form: t
// with and without the stash, t rsplit=0, the row kernel at both rsplits,
// the ring with and without mix; the stage mode: 1 and 3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "ring.cuh"

namespace {

// the chunked kernel's tile (a warp of columns: two elements), its largest
// block (at most 8 chunks) and the blocks an SM holds at its register cap
// (80)
constexpr int kChunkTile = 32;
constexpr int kChunkThreads = 256;
constexpr int kChunkBlocks = 3;
constexpr size_t kMaxSmem = 232448;        // a block's shared memory (227 KB)
constexpr size_t kSmSmem = 233472;         // an SM's (228 KB), and the 1 KB
constexpr size_t kSmemReserved = 1024;     // the system keeps a block
constexpr int kMaxNlev = 400;              // kernels/caar_t.py _MAX_NLEV
constexpr unsigned kFull = 0xffffffffu;

// The ring kernel's design, each part a constant that
// experiments/kernel_variants.py (group ring) builds otherwise, the port's
// value first:
//   kRingTile    32 columns (kernels/caar_t.py RING_TILE: the chunked
//                kernel's tile, one 128-byte line a row of s1); 64, 128;
//   kRingSweep   1 the float4 sweep (ring::emit4); 2 a lane a thread
//                (ring::emit, the design before); 0 none and no wait (the
//                producer alone); 3 the wait without the sweep; 4 none,
//                each producer discarding its own tile at once; 5 and 6
//                the float4 sweep's stores alone, and with the group's
//                loads but no partner's;
//   kRingUnroll  1 row of loads in flight a thread (3 measured no faster);
//   kRingDiscard s1 lines discarded from L2 by their last reader;
//   kRingKeep    1 s1 stored evict-last and w evict-first in L2; 0 plain
//                stores; 2 no s1 stores (with no sweep only);
//   kRingL1      the sweep reads s1 through L1 (else through L2 alone).
// kRingThreads is the largest block (8 chunks), kRingBlocks the blocks an
// SM its register cap (80 at 32 columns) leaves.
#ifdef CAAR_RING_TILE
constexpr int kRingTile = CAAR_RING_TILE;
#else
constexpr int kRingTile = 32;
#endif
#ifdef CAAR_RING_SWEEP
constexpr int kRingSweep = CAAR_RING_SWEEP;
#else
constexpr int kRingSweep = 1;
#endif
#ifdef CAAR_RING_UNROLL
constexpr int kRingUnroll = CAAR_RING_UNROLL;
#else
constexpr int kRingUnroll = 1;
#endif
#ifdef CAAR_RING_DISCARD
constexpr bool kRingDiscard = CAAR_RING_DISCARD;
#else
constexpr bool kRingDiscard = true;
#endif
#ifdef CAAR_RING_KEEP
constexpr int kRingKeep = CAAR_RING_KEEP;
#else
constexpr int kRingKeep = 1;
#endif
#ifdef CAAR_RING_L1
constexpr bool kRingL1 = CAAR_RING_L1;
#else
constexpr bool kRingL1 = true;
#endif
constexpr int kRingThreads = 8 * kRingTile;
constexpr int kRingBlocks = kRingTile == 32 ? 3 : kRingTile == 64 ? 2 : 1;

// META_COLS row indices (kernels/layout.py)
enum Meta {
  kDinv00 = 0, kDinv01, kDinv10, kDinv11, kD00, kD01, kD10, kD11,
  kMetdet, kRmetdet, kFcor, kSpheremp, kPhis
};

struct CaarArgs {
  const float* scal;   // [4]: dt2, eta_ave_w, hyai0*ps0, unused
  const float* meta;   // [16, ld]
  const float* dvv;    // [4, 4] row-major, dvv[i*4+l] = Dvv[i, l]
  const float* u0; const float* v0; const float* t0; const float* dp0;
  // the base state of the update; all four null = the evaluation state.
  // These six are float, or bf16 by the instance's storage (kSt): read
  // through ld_op
  const void* um1; const void* vm1; const void* tm1; const void* dpm1;
  const void* qdp; const void* pecnd;
  float* vn0u; float* vn0v; float* omg;      // accumulators, in place
  float* u1; float* v1; float* t1; float* dp1;
  float* phi;                                // null = not stored
  const int* fix_rank;                       // [ncol] slab row or -1; or null
  float* slab;                               // [nfix, slab_ld]
  // rsplit=0: hybi(k) = hyb_lo[k*hyb_stride], hybi(k+1) = hyb_hi[...];
  // etaacc (interfaces 1..nlev, a field) is updated in place
  const float* hyb_lo; const float* hyb_hi;
  float* etaacc;
  int nlev, ncol, ld, moist, slab_ld, hyb_stride;
  float rgas, kappa, rv_factor, rrearth;
};

// d/dx at lane (li, lj) of the calling thread's element, the element's 16
// values of s taken from its warp by shuffles: sum_i Dvv[i, li] * s(i, lj);
// dxv[i] = Dvv[i, li]; eb = the element's first lane in the warp (0 or 16).
// Every lane of the warp must call it.
__device__ __forceinline__ float dx_w(const float (&dxv)[4], float s, int eb,
                                      int lj) {
  float acc = dxv[0] * __shfl_sync(kFull, s, eb + lj);
  acc = fmaf(dxv[1], __shfl_sync(kFull, s, eb + 4 + lj), acc);
  acc = fmaf(dxv[2], __shfl_sync(kFull, s, eb + 8 + lj), acc);
  return fmaf(dxv[3], __shfl_sync(kFull, s, eb + 12 + lj), acc);
}

// d/dy at lane (li, lj): sum_m Dvv[m, lj] * s(li, m); dyv[m] = Dvv[m, lj]
__device__ __forceinline__ float dy_w(const float (&dyv)[4], float s, int eb,
                                      int li) {
  const int b = eb + 4 * li;
  float acc = dyv[0] * __shfl_sync(kFull, s, b);
  acc = fmaf(dyv[1], __shfl_sync(kFull, s, b + 1), acc);
  acc = fmaf(dyv[2], __shfl_sync(kFull, s, b + 2), acc);
  return fmaf(dyv[3], __shfl_sync(kFull, s, b + 3), acc);
}

// div(v dp) at one level: the metric products, then the two contractions
// (one expression, so both passes that take it get the same bits)
__device__ __forceinline__ float divdp_w(const float* m, const float (&dxv)[4],
                                         const float (&dyv)[4], float vdp1,
                                         float vdp2, float rmr, int eb,
                                         int li, int lj) {
  const float gv1 = m[kMetdet] * (m[kDinv00] * vdp1 + m[kDinv01] * vdp2);
  const float gv2 = m[kMetdet] * (m[kDinv10] * vdp1 + m[kDinv11] * vdp2);
  return (dx_w(dxv, gv1, eb, lj) + dy_w(dyv, gv2, eb, li)) * rmr;
}

// The row layout's staging (caar_chunked with kRow and kStash): planes of
// [nlev][kChunkTile] floats, column x of level k at swz(k, x). The XOR
// swizzle keeps both accesses free of bank conflicts: a warp of the passes
// reads one level of 32 columns (x ^ (k & 31): a permutation of the banks),
// and a warp of the staging copies 32 consecutive floats of the tile's span,
// which are consecutive levels of one column (k & 31 takes every value) or,
// where a column ends, of two.
__device__ __forceinline__ int swz(int k, int x) {
  return k * kChunkTile + (x ^ (k & 31));
}

// The row staging's planes, in this order: phi; the inputs dp, u, v, T,
// qdp and pecnd, copied in before pass 1; the outputs of pass 3: vtens1
// over pecnd, vtens2, dptens, omega_p over qdp, ttens over T (rsplit>0) or
// in a plane of its own (rsplit=0, whose vertical advection reads T at the
// neighbouring levels of other chunks), and eta_hi (rsplit=0).
enum RowPlane {
  kPPhi = 0, kPDp, kPU, kPV, kPT, kPQdp, kPPec, kPVt2, kPDpt, kPTt, kPEta
};
__host__ __device__ constexpr int row_planes(bool r0) { return r0 ? 11 : 9; }
constexpr int kMetaPitch = 33;      // the staged meta [16][kMetaPitch]

// The row kernel beyond the planes' budget (the windowed mode): each warp
// copies a window of kRowWindow levels of its chunk for the tile's 32
// columns into slots [win_slots][kRowWindow][32] of its own, 4-byte
// cp.async, 8 lanes a column (32 bytes: one sector), and writes a window's
// outputs back the same way (kernels/caar_t.py ROW_WINDOW,
// ROW_WINDOW_SLOTS). experiments/kernel_variants.py (group row) builds
// other windows with -DCAAR_ROW_WINDOW (0: every field read and written in
// place at col*nlev + k, uncoalesced) and a shared-memory carveout hint in
// percent with -DCAAR_ROW_CARVEOUT (none by default).
#ifdef CAAR_ROW_WINDOW
constexpr int kRowWindow = CAAR_ROW_WINDOW;
#else
constexpr int kRowWindow = 8;
#endif
#ifdef CAAR_ROW_CARVEOUT
constexpr int kRowCarveout = CAAR_ROW_CARVEOUT;
#else
constexpr int kRowCarveout = -1;
#endif
static_assert(kRowWindow == 0 || (kRowWindow <= kChunkTile &&
                                  kChunkTile % kRowWindow == 0),
              "a window is a power of two of at most 32 levels");
constexpr int kWinLen = kRowWindow > 0 ? kRowWindow : 1;

// The staged row kernel stages bf16 qdp and pecnd (kSt >= 1) by plain
// loads before pass 1. experiments/kernel_variants.py (group storage)
// builds with -DCAAR_ROW_SYNC_AUX=1 a kernel whose f32 mode stages f32 qdp
// and pecnd the same way, in place of the cp.async groups that overlap
// passes 1 and 2.
#ifdef CAAR_ROW_SYNC_AUX
constexpr bool kRowSyncAux = CAAR_ROW_SYNC_AUX;
#else
constexpr bool kRowSyncAux = false;
#endif

// The window's slots: the inputs of pass 3 in this order; a level's
// outputs overwrite its nm1 state (u1..dp1), pecnd (phi) and the
// accumulators
enum WinSlot {
  kWDp = 0, kWU, kWV, kWT, kWQdp, kWPec, kWUm1, kWVm1, kWTm1, kWDpm1, kWAn,
  kWAv, kWAo, kWAe
};
__host__ __device__ constexpr int win_slots(bool r0) { return r0 ? 14 : 13; }

// column x of window level w: the XOR keeps the copies (kRowWindow
// consecutive levels of 32 / kRowWindow columns a warp) and the passes (one
// level of 32 columns) free of bank conflicts
__device__ __forceinline__ int wsw(int w, int x) {
  return w * kChunkTile + (x ^ (w * (kChunkTile / kWinLen)));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// element o of a storage operand: float, or with kBf bf16 upcast exactly
template <bool kBf>
__device__ __forceinline__ float ld_op(const void* p, size_t o) {
  if constexpr (kBf)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[o]);
  else
    return static_cast<const float*>(p)[o];
}

// element o of a storage operand into the f32 shared-memory slot dst: a
// cp.async of the float, or with kBf a bf16 load upcast and stored (the
// caller's wait and barrier cover both)
template <bool kBf>
__device__ __forceinline__ void stage_op(float* dst, const void* src,
                                         size_t o) {
  if constexpr (kBf)
    *dst = ld_op<true>(src, o);
  else
    cp_async4(dst, static_cast<const float*>(src) + o);
}

// elements o and o + 1 of a storage operand in one load (o even): with kBf
// 4 bytes of bf16 upcast exactly, else 8 bytes of float
template <bool kBf>
__device__ __forceinline__ float2 ld_pair(const void* p, size_t o) {
  if constexpr (kBf)
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(p) + o));
  else
    return *reinterpret_cast<const float2*>(static_cast<const float*>(p) +
                                            o);
}

// (column, level) of element i of a tile's span (i < 32 * 400): the f32
// quotient is exact there, its error ~3e-6 against a margin of 0.5/nlev
__device__ __forceinline__ void span_at(int i, int nlev, float rnlev,
                                        int& cx, int& k) {
  cx = __float2int_rz((static_cast<float>(i) + 0.5f) * rnlev);
  k = i - cx * nlev;
}

// The level-chunked body: the t layout at rsplit>0 (pair and stage forms,
// the optional slab) and the row layout (kRow: [E16, nlev] fields, [E16, 16]
// meta; pair form, no slab), both also at rsplit=0 (kR0: the pair form, no
// slab). One step for the
// kTile columns of tile `tile_idx` by
// a block of kTile*chunks threads. Thread (c, x) = (tid / kTile, tid %
// kTile) takes column tile_idx*kTile + x at levels [c*levels, min(nlev,
// (c+1)*levels)); a warp is 32 consecutive columns (two elements) of one
// chunk, so its loads coalesce and the Dvv contractions are shuffles inside
// it. Shared memory: phi [nlev][tile] (q, then phi), then the chunk totals
// tot [3][chunks][tile] (dp, q, divdp), then with kStash the stash
// [5][nlev][tile] of dp, u, v, t and qdp: pass 1 and pass 2 store what they
// read there and passes 2 and 3 take it back, so every input field is read
// from device memory once (without it, passes 2 and 3 read those fields
// again, from L2 where they are still there). The three vertical
// recurrences are
// chunk-local running sums started at the sums of the other chunks' totals,
// taken in chunk order:
//   pass 1: the chunk's dp total; barrier; s0 = sum of the totals above;
//   pass 2: p from s = s0 + the running dp sum, q = Rgas*Tv*dp/p into phi,
//           and the chunk's q and divdp totals; barrier;
//   pass 2b (own cells only): phi = phis + (the q totals below + the
//           running q sum from the chunk's bottom) + q/2, bottom-up;
//   pass 3: everything else, cum = the divdp totals above + the running
//           divdp sum.
// The bits of a column depend on nlev and (chunks, levels) only, never on
// the tile or the column's place, so a shard's step equals the whole
// sphere's and the ring kernel (tile 128) equals this one.
// Row layout, kStash (staged): the tile's columns are one contiguous span
// of 32*nlev floats a field, so the block copies each input's span into a
// swizzled plane (swz) with cp.async, a warp's 32 copies one 128-byte line:
// meta and dp, then u, v, T and qdp, then pecnd, three groups waited for
// before passes 1, 2 and 3. The passes run on the planes as the t form runs
// on its stash; pass 3 leaves the tendencies, omega_p and (kR0) eta_hi in
// planes, and an epilogue walks the span again, each thread 4 elements at
// once: it reads um1..dpm1 and the accumulators, applies the update with
// the same expressions as the t form and writes every output, a warp a
// line. So the row kernel gives the t kernel's bits on the transposed
// problem. Shared memory row_planes(kR0) planes, tot and the meta. Row
// layout without kStash (nlev beyond the planes' budget), kWin: the passes
// read this warp's window slots, filled (win_fill) at each window's first
// level, and pass 3 writes a level's outputs over its slots, which the
// window's last level copies out (win_flush); the vertical advection reads
// the neighbouring levels from the slots inside the window, else from
// device memory. The same arithmetic as the staged body: the same bits.
// kR0: sdot = the sum of every chunk's divdp total, in chunk order; eta_lo
// = hybi(k)*sdot - cum and eta_hi = hybi(k+1)*sdot - (cum + divdp), 0 at the
// top and at the bottom by the level test; the vertical advection reads u,
// v and T at k-1 and k+1 from the planes or the t layout's stash (without
// them from device memory); dp1 = sph*(dpm1 - dt2*dptens) with dptens =
// divdp + eta_hi - eta_lo formed as the (hybi(k+1) - hybi(k))*sdot it
// equals (see pass 3), and etaacc += eta_ave_w*eta_hi.
// kSt: the storage of qdp (bf16 at 1 and 2), pecnd (bf16 from 1) and
// um1..dpm1 (bf16 at 2), each element upcast where it is read or staged
// (the note above).
template <int kTile, bool kSingle, bool kPhi, bool kStash, bool kRow = false,
          bool kR0 = false, int kS1 = 0, int kSt = 0>
__device__ __forceinline__ void caar_chunked(const CaarArgs& a, int tile_idx,
                                             int chunks, int levels,
                                             float* phi_sm) {
  static_assert(kTile % 32 == 0, "a tile is whole warps of columns");
  static_assert(!kRow || (kTile == kChunkTile && !kSingle && kPhi),
                "the row layout runs the pair form on tiles of 32 columns");
  static_assert(!kR0 || (!kSingle && kPhi && kTile == kChunkTile),
                "rsplit=0 runs the pair form on tiles of 32 columns");
  static_assert(kSt >= 0 && kSt <= 3 && (kSingle ? kSt != 2 : kSt != 3),
                "the stage mode stores no nm1 state; a lone bf16 pecnd is "
                "the stage mode's");
  static_assert(!kRow || kSt != 3, "the row layout has no stage mode");
  // qdp and pecnd bf16 together (as the row kernel's staging moves them),
  // and each of qdp, pecnd and the nm1 fields on its own
  constexpr bool kAux = kSt == 1 || kSt == 2, kQdpBf = kAux;
  constexpr bool kPecBf = kSt >= 1, kRo = kSt == 2;
  constexpr int tile = kTile;
  constexpr bool kStaged = kRow && kStash;
  constexpr bool kWin = kRow && !kStash && kRowWindow > 0;
  const int tid = threadIdx.x;
  const int c = tid / tile, x = tid - c * tile;
  const int col = tile_idx * tile + x;
  const bool live = col < a.ncol;               // ncol % 16 == 0
  const int lane = tid & 31, eb = lane & 16;
  const int li = (lane >> 2) & 3, lj = lane & 3;
  const size_t ld = (size_t)a.ld;
  const int k0 = c * levels, k1 = min(a.nlev, k0 + levels);
  // offset of level k of this thread's column, and its place in phi_sm
  const auto off = [&](int k) -> size_t {
    if constexpr (kRow) return static_cast<size_t>(col) * ld + k;
    else return k * ld + col;
  };
  const auto ph = [&](int k) -> int {
    if constexpr (kStaged) return swz(k, x);
    else return k * tile + x;
  };
  float dxv[4], dyv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dxv[i] = a.dvv[i * 4 + li];
    dyv[i] = a.dvv[i * 4 + lj];
  }
  const size_t plane = static_cast<size_t>(a.nlev) * tile;
  float* const tot_s =
      phi_sm + (kStaged ? row_planes(kR0) : 1) * plane + x;
  const int stride = tile;
  // the stash's five planes at this thread's column: dp, u, v, t, qdp
  float* const st = phi_sm + plane + 3 * chunks * tile + x;
  // the row staging: plane p, the meta, the tile's span
  const auto P = [&](int p) { return phi_sm + p * plane; };
  float* const meta_sm =
      phi_sm + row_planes(kR0) * plane + 3 * chunks * tile;
  const int col0 = tile_idx * tile;
  const int span = min(tile, a.ncol - col0) * a.nlev;
  const size_t base = static_cast<size_t>(col0) * ld;
  const float rnlev = 1.f / static_cast<float>(a.nlev);
  // the windowed mode: this warp's slots, the window [win_lo, win_hi) they
  // hold, and the copies in and out
  constexpr int kWinPlane = kWinLen * kChunkTile;
  float* const win =
      phi_sm + plane + 3 * chunks * tile + c * win_slots(kR0) * kWinPlane;
  const auto W = [&](int slot) { return win + slot * kWinPlane; };
  int win_lo = 0, win_hi = 0;
  // the window starting at level kw of this chunk: dp (pass 1); dp, u, v,
  // T, qdp (pass 2); every input (pass 3)
  const auto win_fill = [&](int kw, int pass) {
    __syncwarp();
    win_lo = kw;
    win_hi = min(k1, kw + kWinLen);
    for (int i = lane; i < kWinPlane; i += 32) {
      const int cx = i / kWinLen, w = i - cx * kWinLen;
      if (kw + w >= win_hi || col0 + cx >= a.ncol) continue;
      const size_t o = static_cast<size_t>(col0 + cx) * ld + kw + w;
      const int p = wsw(w, cx);
      cp_async4(W(kWDp) + p, a.dp0 + o);
      if (pass >= 2) {
        cp_async4(W(kWU) + p, a.u0 + o);
        cp_async4(W(kWV) + p, a.v0 + o);
        cp_async4(W(kWT) + p, a.t0 + o);
        if (a.moist) stage_op<kQdpBf>(W(kWQdp) + p, a.qdp, o);
      }
      if (pass == 3) {
        stage_op<kPecBf>(W(kWPec) + p, a.pecnd, o);
        stage_op<kRo>(W(kWUm1) + p, a.um1, o);
        stage_op<kRo>(W(kWVm1) + p, a.vm1, o);
        stage_op<kRo>(W(kWTm1) + p, a.tm1, o);
        stage_op<kRo>(W(kWDpm1) + p, a.dpm1, o);
        cp_async4(W(kWAn) + p, a.vn0u + o);
        cp_async4(W(kWAv) + p, a.vn0v + o);
        cp_async4(W(kWAo) + p, a.omg + o);
        if constexpr (kR0) cp_async4(W(kWAe) + p, a.etaacc + o);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
  };
  // pass 3's outputs of the window, from the slots they overwrote
  const auto win_flush = [&]() {
    __syncwarp();
    for (int i = lane; i < kWinPlane; i += 32) {
      const int cx = i / kWinLen, w = i - cx * kWinLen;
      if (win_lo + w >= win_hi || col0 + cx >= a.ncol) continue;
      const size_t o = static_cast<size_t>(col0 + cx) * ld + win_lo + w;
      const int p = wsw(w, cx);
      a.u1[o] = W(kWUm1)[p];
      a.v1[o] = W(kWVm1)[p];
      a.t1[o] = W(kWTm1)[p];
      a.dp1[o] = W(kWDpm1)[p];
      a.phi[o] = W(kWPec)[p];
      a.vn0u[o] = W(kWAn)[p];
      a.vn0v[o] = W(kWAv)[p];
      a.omg[o] = W(kWAo)[p];
      if constexpr (kR0) a.etaacc[o] = W(kWAe)[p];
    }
  };
  float m[13];
  if constexpr (kStaged) {
    // qdp and pecnd staged by plain loads (bf16; or f32 in the
    // CAAR_ROW_SYNC_AUX experiment), not by cp.async
    constexpr bool kSyncAux = kAux || kRowSyncAux;
    const float* const mrow = a.meta + static_cast<size_t>(col0) * 16;
    for (int i = tid; i < span / a.nlev * 16; i += blockDim.x)
      cp_async4(meta_sm + (i & 15) * kMetaPitch + (i >> 4), mrow + i);
    const auto stage = [&](auto&& copy) {
      for (int i = tid; i < span; i += blockDim.x) {
        int cx, k;
        span_at(i, a.nlev, rnlev, cx, k);
        copy(base + i, swz(k, cx));
      }
    };
    stage([&](size_t o, int p) { cp_async4(P(kPDp) + p, a.dp0 + o); });
    cp_async_commit();
    stage([&](size_t o, int p) {
      cp_async4(P(kPU) + p, a.u0 + o);
      cp_async4(P(kPV) + p, a.v0 + o);
      cp_async4(P(kPT) + p, a.t0 + o);
      if constexpr (!kSyncAux)
        if (a.moist) cp_async4(P(kPQdp) + p, static_cast<const float*>(
                                                  a.qdp) + o);
    });
    cp_async_commit();
    if constexpr (!kSyncAux)
      stage([&](size_t o, int p) {
        cp_async4(P(kPPec) + p, static_cast<const float*>(a.pecnd) + o);
      });
    cp_async_commit();
    if constexpr (kSyncAux) {
      // qdp and pecnd (bf16, or f32 in the experiment), while the groups
      // above are in flight: two elements of each a load (base and span
      // are even), each upcast into its own place (the two of a pair may
      // be the last level of one column and the first of the next); the
      // barrier below publishes them
      for (int j = tid; 2 * j < span; j += blockDim.x) {
        const float2 q = a.moist ? ld_pair<kAux>(a.qdp, base + 2 * j)
                                 : float2{};
        const float2 e = ld_pair<kAux>(a.pecnd, base + 2 * j);
        int cx, k;
        span_at(2 * j, a.nlev, rnlev, cx, k);
        const int p0 = swz(k, cx);
        span_at(2 * j + 1, a.nlev, rnlev, cx, k);
        const int p1 = swz(k, cx);
        P(kPQdp)[p0] = q.x;
        P(kPQdp)[p1] = q.y;
        P(kPPec)[p0] = e.x;
        P(kPPec)[p1] = e.y;
      }
    }
    cp_async_wait<2>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 13; ++r)
      m[r] = live ? meta_sm[r * kMetaPitch + x] : 1.f;
  } else if constexpr (kRow) {
#pragma unroll
    for (int r = 0; r < 13; ++r)
      m[r] = live ? a.meta[static_cast<size_t>(col) * 16 + r] : 1.f;
  } else {
#pragma unroll
    for (int r = 0; r < 13; ++r) m[r] = live ? a.meta[r * ld + col] : 1.f;
  }
  const float dt2 = a.scal[0], eta = a.scal[1], h = a.scal[2];
  const float rr = a.rrearth, rmr = m[kRmetdet] * rr;

  // pass 1: the chunk's dp total
  float sum = 0.f;
  for (int k = k0; k < k1; ++k) {
    float dp;
    if constexpr (kWin) {
      if (k == win_hi || k == k0) win_fill(k, 1);
      dp = live ? W(kWDp)[wsw(k - win_lo, x)] : 1.f;
    } else if constexpr (kStaged) {
      dp = live ? P(kPDp)[swz(k, x)] : 1.f;
    } else {
      dp = live ? a.dp0[off(k)] : 1.f;
    }
    if constexpr (kStash && !kRow) st[k * tile] = dp;
    if (live) sum += dp;
  }
  tot_s[c * stride] = sum;
  if constexpr (kStaged) cp_async_wait<1>();
  __syncthreads();
  float s0 = 0.f;
  for (int cc = 0; cc < c; ++cc) s0 += tot_s[cc * stride];

  // pass 2: q into phi_sm; the chunk's q and divdp totals. Each level's
  // device-memory loads are issued one level ahead (nx), before the
  // current level's shuffles and sums.
  struct In2 { float dp = 1.f, t = 0.f, u = 0.f, v = 0.f, qd = 0.f; };
  const auto load2 = [&](int k) {
    In2 r;
    if constexpr (kWin) {
      const int p = wsw(k - win_lo, x);
      r.dp = W(kWDp)[p]; r.t = W(kWT)[p]; r.u = W(kWU)[p]; r.v = W(kWV)[p];
      if (a.moist) r.qd = W(kWQdp)[p];
    } else if constexpr (kStaged) {
      const int p = swz(k, x);
      r.dp = P(kPDp)[p]; r.t = P(kPT)[p]; r.u = P(kPU)[p]; r.v = P(kPV)[p];
      if (a.moist) r.qd = P(kPQdp)[p];
    } else {
      const size_t o = off(k);
      if constexpr (!kStash) r.dp = a.dp0[o];
      r.t = a.t0[o]; r.u = a.u0[o]; r.v = a.v0[o];
      if (a.moist) r.qd = ld_op<kQdpBf>(a.qdp, o);
    }
    return r;
  };
  float s = s0, qsum = 0.f, dsum = 0.f;
  In2 nx;
  if constexpr (!kWin)
    if (live && k0 < k1) nx = load2(k0);
  for (int k = k0; k < k1; ++k) {
    In2 in = nx;
    if constexpr (kWin) {
      if (k == win_hi || k == k0) win_fill(k, 2);
      if (live) in = load2(k);
    } else if (live && k + 1 < k1) {
      nx = load2(k + 1);
    }
    if constexpr (kStash && !kRow) {
      in.dp = st[k * tile];
      st[plane + k * tile] = in.u;
      st[2 * plane + k * tile] = in.v;
      st[3 * plane + k * tile] = in.t;
      st[4 * plane + k * tile] = in.qd;
    }
    const float dp = in.dp, t = in.t, qd = in.qd;
    s += dp;
    const float p = (h + s) - 0.5f * dp;
    const float tv = a.moist ? t * (1.f + a.rv_factor * (qd / dp)) : t;
    const float q = live ? a.rgas * tv * (dp / p) : 0.f;
    phi_sm[ph(k)] = q;
    qsum += q;
    dsum += divdp_w(m, dxv, dyv, in.u * dp, in.v * dp, rmr, eb, li, lj);
  }
  tot_s[(chunks + c) * stride] = qsum;
  tot_s[(2 * chunks + c) * stride] = dsum;
  if constexpr (kStaged) cp_async_wait<0>();
  __syncthreads();
  float rsum = 0.f, cum = 0.f;
  for (int cc = chunks - 1; cc > c; --cc)
    rsum += tot_s[(chunks + cc) * stride];
  for (int cc = 0; cc < c; ++cc) cum += tot_s[(2 * chunks + cc) * stride];
  // kR0: the column total of divdp, every chunk's in chunk order
  float sdot = 0.f;
  if constexpr (kR0)
    for (int cc = 0; cc < chunks; ++cc)
      sdot += tot_s[(2 * chunks + cc) * stride];

  // pass 2b: phi = phis + sum_{l>k} q(l) + q(k)/2, bottom-up, own cells
  for (int k = k1 - 1; k >= k0; --k) {
    const float q = phi_sm[ph(k)];
    phi_sm[ph(k)] = (m[kPhis] + rsum) + 0.5f * q;
    rsum += q;
  }

  // pass 3: tendencies and apply, top-down; with kS1 = 1 (the ring) s1 is
  // stored evict-last in L2, for the sweep to read back there (kS1 = 2, an
  // experiment, does not store it)
  [[maybe_unused]] const unsigned long long keep =
      kS1 == 1 ? ring::evict_last() : 0ull;
  const int srow = (live && a.fix_rank) ? a.fix_rank[col] : -1;
  float* const slab = srow >= 0 ? a.slab + (size_t)srow * a.slab_ld : nullptr;
  // the device-memory loads of pass 3, one level ahead as in pass 2
  struct In3 {
    float u = 0.f, v = 0.f, t = 0.f, dp = 1.f, qd = 0.f, pec = 0.f;
    float um1 = 0.f, vm1 = 0.f, tm1 = 0.f, dpm1 = 0.f;
    float an = 0.f, av = 0.f, ao = 0.f, ae = 0.f;
  };
  const auto load3 = [&](int k) {
    In3 r;
    if constexpr (kWin) {
      const int p = wsw(k - win_lo, x);
      r.u = W(kWU)[p]; r.v = W(kWV)[p]; r.t = W(kWT)[p]; r.dp = W(kWDp)[p];
      if (a.moist) r.qd = W(kWQdp)[p];
      r.pec = W(kWPec)[p];
      r.um1 = W(kWUm1)[p]; r.vm1 = W(kWVm1)[p]; r.tm1 = W(kWTm1)[p];
      r.dpm1 = W(kWDpm1)[p];
      r.an = W(kWAn)[p]; r.av = W(kWAv)[p]; r.ao = W(kWAo)[p];
      if constexpr (kR0) r.ae = W(kWAe)[p];
      return r;
    } else if constexpr (kStaged) {
      const int p = swz(k, x);
      r.u = P(kPU)[p]; r.v = P(kPV)[p]; r.t = P(kPT)[p]; r.dp = P(kPDp)[p];
      if (a.moist) r.qd = P(kPQdp)[p];
      r.pec = P(kPPec)[p];
      return r;
    } else {
      const size_t o = off(k);
      if constexpr (!kStash) {
        r.u = a.u0[o]; r.v = a.v0[o]; r.t = a.t0[o]; r.dp = a.dp0[o];
        if (a.moist) r.qd = ld_op<kQdpBf>(a.qdp, o);
      }
      r.pec = ld_op<kPecBf>(a.pecnd, o);
      if constexpr (!kSingle) {
        r.um1 = ld_op<kRo>(a.um1, o); r.vm1 = ld_op<kRo>(a.vm1, o);
        r.tm1 = ld_op<kRo>(a.tm1, o); r.dpm1 = ld_op<kRo>(a.dpm1, o);
      }
      r.an = a.vn0u[o]; r.av = a.vn0v[o]; r.ao = a.omg[o];
      if constexpr (kR0) r.ae = a.etaacc[o];
      return r;
    }
  };
  // kR0: u, v and T of this column at level k (k inside the column; pass
  // 2 has stashed every chunk's levels before the barrier)
  const auto uvt = [&](int k, float& u, float& v, float& t) {
    if constexpr (kStaged) {
      const int p = swz(k, x);
      u = P(kPU)[p]; v = P(kPV)[p]; t = P(kPT)[p];
    } else if constexpr (kStash) {
      u = st[plane + k * tile];
      v = st[2 * plane + k * tile];
      t = st[3 * plane + k * tile];
    } else {
      if constexpr (kWin) {
        if (k >= win_lo && k < win_hi) {
          const int p = wsw(k - win_lo, x);
          u = W(kWU)[p]; v = W(kWV)[p]; t = W(kWT)[p];
          return;
        }
      }
      const size_t o = off(k);
      u = a.u0[o]; v = a.v0[o]; t = a.t0[o];
    }
  };
  In3 nx3;
  if constexpr (!kWin)
    if (live && k0 < k1) nx3 = load3(k0);
  s = s0;
  for (int k = k0; k < k1; ++k) {
    const size_t o = off(k);
    In3 in = nx3;
    if constexpr (kWin) {
      if (k == win_hi || k == k0) win_fill(k, 3);
      if (live) in = load3(k);
    } else if (live && k + 1 < k1) {
      nx3 = load3(k + 1);
    }
    if (live) {
      if constexpr (kStash && !kRow) {
        in.dp = st[k * tile];
        in.u = st[plane + k * tile];
        in.v = st[2 * plane + k * tile];
        in.t = st[3 * plane + k * tile];
        in.qd = st[4 * plane + k * tile];
      }
      if constexpr (kSingle) {
        in.um1 = in.u; in.vm1 = in.v; in.tm1 = in.t; in.dpm1 = in.dp;
      }
    }
    const float u = in.u, v = in.v, t = in.t, dp = in.dp, qd = in.qd;
    const float pec = in.pec, um1 = in.um1, vm1 = in.vm1, tm1 = in.tm1;
    const float dpm1 = in.dpm1, an = in.an, av = in.av, ao = in.ao;
    s += dp;
    const float p = (h + s) - 0.5f * dp;
    const float vdp1 = u * dp, vdp2 = v * dp;
    const float phi = phi_sm[ph(k)];

    // grad p, v.grad p
    float g1 = dx_w(dxv, p, eb, lj) * rr, g2 = dy_w(dyv, p, eb, li) * rr;
    const float gp1 = m[kDinv00] * g1 + m[kDinv10] * g2;
    const float gp2 = m[kDinv01] * g1 + m[kDinv11] * g2;
    const float vgrad_p = u * gp1 + v * gp2;
    // div(v dp), vorticity
    const float divdp = divdp_w(m, dxv, dyv, vdp1, vdp2, rmr, eb, li, lj);
    const float vco1 = m[kD00] * u + m[kD10] * v;
    const float vco2 = m[kD01] * u + m[kD11] * v;
    const float vort =
        (dx_w(dxv, vco2, eb, lj) - dy_w(dyv, vco1, eb, li)) * rmr;
    // virtual temperature, omega/p
    const float tv = a.moist ? t * (1.f + a.rv_factor * (qd / dp)) : t;
    const float omega_p = (vgrad_p - cum - 0.5f * divdp) / p;
    // kR0: interface fluxes above and below level k, vertical advection
    float eta_lo = 0.f, eta_hi = 0.f, u_vadv = 0.f, v_vadv = 0.f,
          t_vadv = 0.f;
    if constexpr (kR0) {
      const float cum_inc = cum + divdp;
      if (k > 0)
        eta_lo = a.hyb_lo[static_cast<size_t>(k) * a.hyb_stride] * sdot - cum;
      if (k < a.nlev - 1)
        eta_hi = a.hyb_hi[static_cast<size_t>(k) * a.hyb_stride] * sdot
                 - cum_inc;
      const float rpdel = 1.f / dp;
      const float facp = 0.5f * rpdel * eta_hi;
      const float facm = 0.5f * rpdel * eta_lo;
      // the neighbours, equal to level k at the top and the bottom (the
      // missing difference is 0)
      float un = u, vn = v, tn = t, up = u, vp = v, tp = t;
      if (live && k + 1 < a.nlev) uvt(k + 1, un, vn, tn);
      if (live && k > 0) uvt(k - 1, up, vp, tp);
      u_vadv = facp * (un - u) + facm * (u - up);
      v_vadv = facp * (vn - v) + facm * (v - vp);
      t_vadv = facp * (tn - t) + facm * (t - tp);
    }
    cum += divdp;
    // grad T, grad(E + phi)
    g1 = dx_w(dxv, t, eb, lj) * rr;
    g2 = dy_w(dyv, t, eb, li) * rr;
    const float gt1 = m[kDinv00] * g1 + m[kDinv10] * g2;
    const float gt2 = m[kDinv01] * g1 + m[kDinv11] * g2;
    const float ephi = 0.5f * (u * u + v * v) + phi + pec;
    g1 = dx_w(dxv, ephi, eb, lj) * rr;
    g2 = dy_w(dyv, ephi, eb, li) * rr;
    const float ge1 = m[kDinv00] * g1 + m[kDinv10] * g2;
    const float ge2 = m[kDinv01] * g1 + m[kDinv11] * g2;
    // tendencies
    const float gpterm = a.rgas * (tv / p);
    const float fcor_vort = m[kFcor] + vort;
    float vtens1, vtens2, ttens, dptens;
    if constexpr (kR0) {
      vtens1 = -u_vadv + v * fcor_vort - ge1 - gpterm * gp1;
      vtens2 = -v_vadv - (u * fcor_vort) - ge2 - gpterm * gp2;
      ttens = -t_vadv - (u * gt1 + v * gt2) + a.kappa * tv * omega_p;
      // divdp + eta_hi - eta_lo is (H(k+1) - H(k))*sdot, H = hybi inside,
      // H(0) = 0 and H(nlev) = 1 (the forced zeros); formed so, without the
      // f32 cancellation of the running sums (~eps*|cum| over a tendency
      // that is ~1/nlev of sdot)
      const float hlo =
          k > 0 ? a.hyb_lo[static_cast<size_t>(k) * a.hyb_stride] : 0.f;
      const float hhi = k < a.nlev - 1
          ? a.hyb_hi[static_cast<size_t>(k) * a.hyb_stride] : 1.f;
      dptens = (hhi - hlo) * sdot;
    } else {
      vtens1 = v * fcor_vort - ge1 - gpterm * gp1;
      vtens2 = -(u * fcor_vort) - ge2 - gpterm * gp2;
      ttens = -(u * gt1 + v * gt2) + a.kappa * tv * omega_p;
      dptens = divdp;
    }

    if constexpr (kStaged) {
      // own cells only: the epilogue applies them
      const int q = swz(k, x);
      P(kPPec)[q] = vtens1;
      P(kPVt2)[q] = vtens2;
      P(kR0 ? kPTt : kPT)[q] = ttens;
      P(kPDpt)[q] = dptens;
      P(kPQdp)[q] = omega_p;
      if constexpr (kR0) P(kPEta)[q] = eta_hi;
    } else if constexpr (kWin) {
      // the outputs over the level's nm1 state, pecnd and accumulators;
      // the window's last level writes them all out
      if (live) {
        const float sph = m[kSpheremp];
        const int q = wsw(k - win_lo, x);
        W(kWUm1)[q] = sph * (um1 + dt2 * vtens1);
        W(kWVm1)[q] = sph * (vm1 + dt2 * vtens2);
        W(kWTm1)[q] = sph * (tm1 + dt2 * ttens);
        W(kWDpm1)[q] = sph * (dpm1 - dt2 * dptens);
        W(kWPec)[q] = phi;
        W(kWAn)[q] = an + eta * vdp1;
        W(kWAv)[q] = av + eta * vdp2;
        W(kWAo)[q] = ao + eta * omega_p;
        if constexpr (kR0) W(kWAe)[q] = in.ae + eta * eta_hi;
      }
      if (k + 1 == win_hi) win_flush();
    } else if (live) {
      const float sph = m[kSpheremp];
      const float u1 = sph * (um1 + dt2 * vtens1);
      const float v1 = sph * (vm1 + dt2 * vtens2);
      const float t1 = sph * (tm1 + dt2 * ttens);
      const float dp1 = sph * (dpm1 - dt2 * dptens);
      if constexpr (kS1 == 1) {
        ring::store(a.u1 + o, u1, keep);
        ring::store(a.v1 + o, v1, keep);
        ring::store(a.t1 + o, t1, keep);
        ring::store(a.dp1 + o, dp1, keep);
      } else if constexpr (kS1 == 0) {
        a.u1[o] = u1;
        a.v1[o] = v1;
        a.t1[o] = t1;
        a.dp1[o] = dp1;
      }
      if (slab) {
        slab[k] = u1;
        slab[a.nlev + k] = v1;
        slab[2 * a.nlev + k] = t1;
        slab[3 * a.nlev + k] = dp1;
      }
      if constexpr (kPhi) a.phi[o] = phi;
      a.vn0u[o] = an + eta * vdp1;
      a.vn0v[o] = av + eta * vdp2;
      a.omg[o] = ao + eta * omega_p;
      if constexpr (kR0) a.etaacc[o] = in.ae + eta * eta_hi;
    }
  }

  if constexpr (kStaged) {
    // the epilogue: the update applied over the span, kEpi elements a
    // thread at once (their loads issued together), every output written a
    // warp a line
    constexpr int kEpi = 4;
    __syncthreads();
    const float* const sphv = meta_sm + kSpheremp * kMetaPitch;
    for (int i0 = tid; i0 < span; i0 += kEpi * blockDim.x) {
      struct Old { float um1, vm1, tm1, dpm1, an, av, ao, ae; };
      Old old[kEpi];
      int pos[kEpi], cxs[kEpi];
#pragma unroll
      for (int j = 0; j < kEpi; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < span) {
          int k;
          span_at(i, a.nlev, rnlev, cxs[j], k);
          pos[j] = swz(k, cxs[j]);
          const size_t o = base + i;
          old[j].um1 = ld_op<kRo>(a.um1, o);
          old[j].vm1 = ld_op<kRo>(a.vm1, o);
          old[j].tm1 = ld_op<kRo>(a.tm1, o);
          old[j].dpm1 = ld_op<kRo>(a.dpm1, o);
          old[j].an = a.vn0u[o]; old[j].av = a.vn0v[o]; old[j].ao = a.omg[o];
          if constexpr (kR0) old[j].ae = a.etaacc[o];
        }
      }
#pragma unroll
      for (int j = 0; j < kEpi; ++j) {
        const int i = i0 + j * blockDim.x;
        if (i < span) {
          const size_t o = base + i;
          const int q = pos[j];
          const float sph = sphv[cxs[j]];
          const float dp = P(kPDp)[q];
          const float vdp1 = P(kPU)[q] * dp, vdp2 = P(kPV)[q] * dp;
          a.u1[o] = sph * (old[j].um1 + dt2 * P(kPPec)[q]);
          a.v1[o] = sph * (old[j].vm1 + dt2 * P(kPVt2)[q]);
          a.t1[o] = sph * (old[j].tm1 + dt2 * P(kR0 ? kPTt : kPT)[q]);
          a.dp1[o] = sph * (old[j].dpm1 - dt2 * P(kPDpt)[q]);
          a.phi[o] = P(kPPhi)[q];
          a.vn0u[o] = old[j].an + eta * vdp1;
          a.vn0v[o] = old[j].av + eta * vdp2;
          a.omg[o] = old[j].ao + eta * P(kPQdp)[q];
          if constexpr (kR0) a.etaacc[o] = old[j].ae + eta * P(kPEta)[q];
        }
      }
    }
  }
}

// shared memory of the chunked body: phi [nlev][tile], tot [3][chunks][tile]
// and with the stash [5][nlev][tile]
inline size_t chunked_smem(int nlev, int tile, int chunks, bool stash) {
  return ((stash ? 6 : 1) * static_cast<size_t>(nlev) + 3 * chunks) * tile *
         sizeof(float);
}

// whether (chunks, levels) on tiles of `tile` columns is a plan the chunked
// body takes at nlev: at most max_threads threads, every level in exactly
// one chunk (no empty chunk), and its shared memory
inline bool plan_ok(int nlev, int tile, int chunks, int levels,
                    bool stash, int max_threads) {
  return nlev >= 1 && chunks >= 1 && levels >= 1 &&
         tile * chunks <= max_threads &&
         chunks * levels >= nlev && (chunks - 1) * levels < nlev &&
         chunked_smem(nlev, tile, chunks, stash) <= kMaxSmem;
}

// shared memory of the row kernel: staged, row_planes(r0) planes
// [nlev][kChunkTile], tot [3][chunks][kChunkTile] and the meta
// [16][kMetaPitch]; else the chunked body's without the stash
inline size_t row_smem(int nlev, int chunks, bool stage, bool r0) {
  if (!stage)
    return chunked_smem(nlev, kChunkTile, chunks, false) +
           (kRowWindow > 0 ? static_cast<size_t>(chunks) * win_slots(r0) *
                                 kRowWindow * kChunkTile * sizeof(float)
                           : 0);
  return ((row_planes(r0) * static_cast<size_t>(nlev) + 3 * chunks) *
              kChunkTile + 16 * kMetaPitch) * sizeof(float);
}

template <bool kSingle, bool kPhi, bool kStash, int kSt = 0>
__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
caar_chunk_kernel(CaarArgs a, int chunks, int levels) {
  extern __shared__ float sm[];
  caar_chunked<kChunkTile, kSingle, kPhi, kStash, false, false, 0, kSt>(
      a, blockIdx.x, chunks, levels, sm);
}

// The row layout's step (rows 7 and 8 of the kernel table): the chunked
// body with kRow, staged through shared memory where kStage; two blocks an
// SM at nlev 72 (row_smem: 86 KB, 104 KB at rsplit=0), so 128 registers.
template <bool kR0, bool kStage, int kSt = 0>
__global__ void __launch_bounds__(kChunkThreads, 2)
caar_row_kernel(CaarArgs a, int chunks, int levels) {
  extern __shared__ float sm[];
  caar_chunked<kChunkTile, false, true, kStage, true, kR0, 0, kSt>(
      a, blockIdx.x, chunks, levels, sm);
}

// The t layout's rsplit=0 step (row 6 of the kernel table): the chunked
// body's kR0 mode on caar_plan(r0=True)'s chunks and stash, its registers
// capped for kBlocks blocks an SM: 2 (128 registers, as the row kernel:
// no spills), or with the stash 3 (80, the chunked kernel's cap: pass 3's
// neighbour reads and fluxes spill 20 bytes), which the plan takes where
// the launch is at least R0_WAVES waves of 3 blocks an SM
// (experiments/kernel_variants.py rsplit0: on the H100 3 blocks were 13%
// faster at ne30 x 72 and 13% slower at 1024 x 72, 1.3 waves).
template <bool kStash, int kBlocks, int kSt = 0>
__global__ void __launch_bounds__(kChunkThreads, kBlocks)
caar_r0_kernel(CaarArgs a, int chunks, int levels) {
  extern __shared__ float sm[];
  caar_chunked<kChunkTile, false, true, kStash, false, true, 0, kSt>(
      a, blockIdx.x, chunks, levels, sm);
}

// The ring-fused step (t layout, rsplit>0): tile t of the CAAR step into the
// scratch s1 (a.u1..a.dp1 are its four row blocks), with phi, the
// accumulators and the slab as caar_chunk_kernel writes them (the same body,
// tile and plan: caar_plan's chunks, its stash where it takes it); then the
// sweep of tile t - halo - lag over all 4*nlev rows into r.w in float4
// groups (ring::emit4), and the retirement of the tiles that sweep
// completes (ring::retire). nb + halo + lag blocks; the fix lanes of r.w
// hold in-face partial sums. The lag (ring_plan) lets the tiles a sweep
// reads finish before it asks for them, so that its wait seldom spins.
// The constants k* above select the design (the port's: float4 sweep,
// hints, discard, L1 reads).
template <bool kSingle, bool kPhi, bool kMix, bool kStash, int kSt = 0>
__global__ void __launch_bounds__(kRingThreads, kRingBlocks)
caar_ring_kernel(CaarArgs a, ring::Args r, int chunks, int levels, int lag) {
  extern __shared__ float sm[];
  const int t = ring::ticket(r.counter);
  if (t < r.nb) {
    caar_chunked<kRingTile, kSingle, kPhi, kStash, false, false, kRingKeep,
                 kSt>(a, t, chunks, levels, sm);
    ring::publish(r.flags + t);
    if constexpr (kRingSweep == 4)     // the producer discarding its own
      ring::retire<kRingTile>(r, t, t, 4 * a.nlev, a.ncol, true);
  }
  const int j = t - r.halo - lag;
  if (kRingSweep == 0 || kRingSweep == 4 || j < 0) return;
  const int lo = max(j - r.halo, 0), hi = min(j + r.halo, r.nb - 1);
  const int after = ring::wait(r.flags, lo, hi);
  const int rows = 4 * a.nlev;
  if constexpr (kRingSweep == 1 || kRingSweep >= 5) {
    // 5 and 6 (experiments): the sweep's stores alone, and with the group's
    // loads but not the partners'
    ring::emit4<kRingTile, kRingUnroll, kMix, kRingKeep == 1, kRingL1,
                kRingSweep == 1 ? 2 : kRingSweep - 5>(r, after, j, rows,
                                                      a.ncol);
  } else if constexpr (kRingSweep == 2) {
    // the column-a-thread sweep of the design before: a lane a thread, the
    // rows split over the chunks
    const int g = threadIdx.x / kRingTile;
    const int l = j * kRingTile + threadIdx.x - g * kRingTile;
    const int per = (rows + chunks - 1) / chunks;
    const int row0 = min(rows, g * per), nrows = min(rows, row0 + per) - row0;
    if (l < a.ncol) ring::emit<kMix>(r, after, row0, nrows, l, a.ncol);
  }
  if constexpr (kRingDiscard && kRingSweep != 3)
    ring::retire<kRingTile>(r, lo, hi, rows, a.ncol);
}

template <bool kStash, int kBlocks, int kSt>
cudaError_t launch_r0(const CaarArgs& a, int chunks, int levels,
                      cudaStream_t stream) {
  auto* kernel = caar_r0_kernel<kStash, kBlocks, kSt>;
  const size_t smem = chunked_smem(a.nlev, kChunkTile, chunks, kStash);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.ncol + kChunkTile - 1) / kChunkTile;
  kernel<<<grid, kChunkTile * chunks, smem, stream>>>(a, chunks, levels);
  return cudaGetLastError();
}

template <bool kSingle, bool kPhi, bool kStash, int kSt = 0>
cudaError_t launch_chunked(const CaarArgs& a, int chunks, int levels,
                           cudaStream_t stream) {
  auto* kernel = caar_chunk_kernel<kSingle, kPhi, kStash, kSt>;
  const size_t smem = chunked_smem(a.nlev, kChunkTile, chunks, kStash);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.ncol + kChunkTile - 1) / kChunkTile;
  kernel<<<grid, kChunkTile * chunks, smem, stream>>>(a, chunks, levels);
  return cudaGetLastError();
}

template <bool kR0, bool kStage, int kSt>
cudaError_t launch_row(const CaarArgs& a, int chunks, int levels,
                       cudaStream_t stream) {
  auto* kernel = caar_row_kernel<kR0, kStage, kSt>;
  const size_t smem = row_smem(a.nlev, chunks, kStage, kR0);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (kRowCarveout >= 0) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               kRowCarveout);
    if (err != cudaSuccess) return err;
  }
  const int grid = (a.ncol + kChunkTile - 1) / kChunkTile;
  kernel<<<grid, kChunkTile * chunks, smem, stream>>>(a, chunks, levels);
  return cudaGetLastError();
}

// the ring kernel's instance for a launch's modes (a bf16 storage only in
// the pair form)
template <bool kStash, int kSt>
auto* ring_kernel(bool single, bool phi, const void* mx) {
  if constexpr (kSt == 0)
    return single
               ? (phi ? (mx ? caar_ring_kernel<true, true, true, kStash>
                            : caar_ring_kernel<true, true, false, kStash>)
                      : (mx ? caar_ring_kernel<true, false, true, kStash>
                            : caar_ring_kernel<true, false, false, kStash>))
               : (mx ? caar_ring_kernel<false, true, true, kStash>
                     : caar_ring_kernel<false, true, false, kStash>);
  else
    return mx ? caar_ring_kernel<false, true, true, kStash, kSt>
              : caar_ring_kernel<false, true, false, kStash, kSt>;
}

// f(std::integral_constant<int, kSt>{}) for the run-time storage code s
// (0 f32, 1 bf16_aux, 2 bf16_ro, 3 a lone bf16 pecnd; checked by the
// caller), the codes above kMax left out
template <int kMax = 2, typename F>
auto by_storage(int s, F&& f) {
  if constexpr (kMax >= 3)
    if (s == 3) return f(std::integral_constant<int, 3>{});
  return s == 2 ? f(std::integral_constant<int, 2>{})
         : s == 1 ? f(std::integral_constant<int, 1>{})
                  : f(std::integral_constant<int, 0>{});
}

}  // namespace

extern "C" {

const char* caar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Enqueues one CAAR step on `stream`. Returns the cudaError_t of the launch.
// fix_rank and slab may be null (no slab output); um1, vm1, tm1 and dpm1
// may all be null (the stage mode: base state = u0..dp0); phi may be null
// in the stage mode only. A non-null etaacc selects rsplit=0 and needs
// hyb_lo and hyb_hi; row = 1 selects the [E16, nlev] layout (ld = nlev,
// meta [E16, 16]). The stage mode and the slab take the t layout and
// rsplit>0 only. (chunks, levels, stash) is the plan of the chunked body:
// kernels/caar_t.py::caar_plan on the t layout (caar_plan(r0=True) at
// rsplit=0), caar_row_plan on the row layout (stash = staged); `blocks` the
// t layout's rsplit=0 instance, 2 or 3 blocks an SM (3 with the stash
// only, where three fit), ignored by the other modes. storage: 0 f32, 1
// qdp and pecnd bf16, 2 also um1..dpm1 bf16 (the pair form only), 3 pecnd
// alone bf16 (the stage mode only); the row layout's staged bf16 spans
// 4-byte aligned.
int caar_launch(const void* scal, const void* meta, const void* dvv,
                const void* u0, const void* v0, const void* t0,
                const void* dp0, const void* um1, const void* vm1,
                const void* tm1, const void* dpm1, const void* qdp,
                const void* pecnd, void* vn0u, void* vn0v, void* omg,
                void* u1, void* v1, void* t1, void* dp1, void* phi,
                const void* fix_rank, void* slab, const void* hyb_lo,
                const void* hyb_hi, void* etaacc, int nlev, int ncol,
                int ld, int moist, int slab_ld, int hyb_stride, int row,
                int chunks, int levels, int stash, int blocks, int storage,
                float rgas, float kappa, float rv_factor, float rrearth,
                void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  // the stage mode (um1 null) takes 0, 1 and 3, the pair form 0, 1 and 2
  if (storage < 0 || storage > 3 ||
      storage == (um1 == nullptr ? 2 : 3) ||
      (storage && row && stash &&
       (reinterpret_cast<size_t>(qdp) % 4 ||
        reinterpret_cast<size_t>(pecnd) % 4)))
    return cudaErrorInvalidValue;
  if (nlev > kMaxNlev || ncol < 1 || ncol % 16 ||
      (um1 == nullptr) != (vm1 == nullptr) ||
      (um1 == nullptr) != (tm1 == nullptr) ||
      (um1 == nullptr) != (dpm1 == nullptr))
    return cudaErrorInvalidValue;
  if (phi == nullptr && um1 != nullptr)   // only a stage may drop phi
    return cudaErrorInvalidValue;
  const bool r0 = etaacc != nullptr;
  if (r0 && (hyb_lo == nullptr || hyb_hi == nullptr))
    return cudaErrorInvalidValue;
  if ((r0 || row) && (um1 == nullptr || fix_rank != nullptr))
    return cudaErrorInvalidValue;
  if (!row &&
      !plan_ok(nlev, kChunkTile, chunks, levels, stash, kChunkThreads))
    return cudaErrorInvalidValue;
  if (r0 && !row &&
      !(blocks == 2 ||
        (blocks == 3 && stash &&
         3 * (chunked_smem(nlev, kChunkTile, chunks, true) +
              kSmemReserved) <= kSmSmem)))
    return cudaErrorInvalidValue;
  if (row && (!plan_ok(nlev, kChunkTile, chunks, levels, false,
                       kChunkThreads) ||
              row_smem(nlev, chunks, stash, r0) > kMaxSmem))
    return cudaErrorInvalidValue;
  CaarArgs a;
  a.scal = static_cast<const float*>(scal);
  a.meta = static_cast<const float*>(meta);
  a.dvv = static_cast<const float*>(dvv);
  a.u0 = static_cast<const float*>(u0);
  a.v0 = static_cast<const float*>(v0);
  a.t0 = static_cast<const float*>(t0);
  a.dp0 = static_cast<const float*>(dp0);
  a.um1 = um1;
  a.vm1 = vm1;
  a.tm1 = tm1;
  a.dpm1 = dpm1;
  a.qdp = qdp;
  a.pecnd = pecnd;
  a.vn0u = static_cast<float*>(vn0u);
  a.vn0v = static_cast<float*>(vn0v);
  a.omg = static_cast<float*>(omg);
  a.u1 = static_cast<float*>(u1);
  a.v1 = static_cast<float*>(v1);
  a.t1 = static_cast<float*>(t1);
  a.dp1 = static_cast<float*>(dp1);
  a.phi = static_cast<float*>(phi);
  a.fix_rank = static_cast<const int*>(fix_rank);
  a.slab = static_cast<float*>(slab);
  a.slab_ld = slab_ld;
  a.hyb_lo = static_cast<const float*>(hyb_lo);
  a.hyb_hi = static_cast<const float*>(hyb_hi);
  a.hyb_stride = hyb_stride;
  a.etaacc = static_cast<float*>(etaacc);
  a.nlev = nlev;
  a.ncol = ncol;
  a.ld = ld;
  a.moist = moist;
  a.rgas = rgas;
  a.kappa = kappa;
  a.rv_factor = rv_factor;
  a.rrearth = rrearth;

  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_storage<3>(storage, [&](auto kst) -> cudaError_t {
    constexpr int kSt = decltype(kst)::value;
    if constexpr (kSt != 2) {    // the stage mode: storage 0, 1 or 3
      if (um1 == nullptr) {
        if (stash)
          return phi ? launch_chunked<true, true, true, kSt>(a, chunks,
                                                             levels, st)
                     : launch_chunked<true, false, true, kSt>(a, chunks,
                                                              levels, st);
        return phi ? launch_chunked<true, true, false, kSt>(a, chunks, levels,
                                                            st)
                   : launch_chunked<true, false, false, kSt>(a, chunks,
                                                             levels, st);
      }
    }
    if constexpr (kSt == 3) {
      return cudaErrorInvalidValue;        // refused above
    } else {
      if (row) {
        if (r0)
          return stash ? launch_row<true, true, kSt>(a, chunks, levels, st)
                       : launch_row<true, false, kSt>(a, chunks, levels, st);
        return stash ? launch_row<false, true, kSt>(a, chunks, levels, st)
                     : launch_row<false, false, kSt>(a, chunks, levels, st);
      }
      if (r0)
        return !stash ? launch_r0<false, 2, kSt>(a, chunks, levels, st)
               : blocks == 3 ? launch_r0<true, 3, kSt>(a, chunks, levels, st)
                             : launch_r0<true, 2, kSt>(a, chunks, levels, st);
      return stash ? launch_chunked<false, true, true, kSt>(a, chunks, levels,
                                                            st)
                   : launch_chunked<false, true, false, kSt>(a, chunks,
                                                             levels, st);
    }
  });
}

// Enqueues one ring-fused step (t layout, rsplit>0, with the slab) on
// `stream`: a memset of the launch's state, then one kernel of nb + halo +
// lag blocks of `tile`*chunks threads. state holds nstate >= 1 + 2*nb ints: the
// ticket counter, the nb reader counts and the nb tile flags, all cleared
// by the memset (so a CUDA graph of the launch replays correctly; the flags
// take the value 1). s1 is the [4*nlev, ncol] scratch (128-byte aligned,
// ncol a multiple of the tile: a tile's rows are whole L2 lines), w the
// swept output, mx null (no mix) or a [4*nlev, ncol] field; um1..dpm1 all
// null = the stage mode, phi null only there; (halo, lag, tile, chunks,
// levels, stash) the plan of kernels/ring_fused.py::ring_plan, the tile the
// built kRingTile; storage as caar_launch's (the pair form only). Returns
// the cudaError_t.
int caar_ring_launch(const void* scal, const void* meta, const void* dvv,
                     const void* u0, const void* v0, const void* t0,
                     const void* dp0, const void* um1, const void* vm1,
                     const void* tm1, const void* dpm1, const void* qdp,
                     const void* pecnd, void* vn0u, void* vn0v, void* omg,
                     void* s1, void* phi, const void* fix_rank, void* slab,
                     const void* rsp, const void* mx, void* w, void* state,
                     int nstate, int nlev, int ncol, int moist, int nrsp,
                     int ne, int halo, int lag, int tile, int chunks,
                     int levels, int stash, int storage, float rgas,
                     float kappa, float rv_factor, float rrearth, float ca,
                     float cb, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool single = um1 == nullptr;
  const int nb = ncol / kRingTile;
  if (storage < 0 || storage > 2 || (storage && single) ||
      single != (vm1 == nullptr) || single != (tm1 == nullptr) ||
      single != (dpm1 == nullptr) || (phi == nullptr && !single) ||
      fix_rank == nullptr || tile != kRingTile || nlev > kMaxNlev || ne < 1 ||
      ncol < tile || ncol % tile || reinterpret_cast<size_t>(s1) % 128 ||
      1 + 2 * static_cast<long long>(nb) > nstate || lag < 0 ||
      !plan_ok(nlev, kRingTile, chunks, levels, stash, kRingThreads) ||
      !ring::covers(nb, nb, ne, halo, kRingTile))
    return cudaErrorInvalidValue;
  CaarArgs a = {};
  a.scal = static_cast<const float*>(scal);
  a.meta = static_cast<const float*>(meta);
  a.dvv = static_cast<const float*>(dvv);
  a.u0 = static_cast<const float*>(u0);
  a.v0 = static_cast<const float*>(v0);
  a.t0 = static_cast<const float*>(t0);
  a.dp0 = static_cast<const float*>(dp0);
  a.um1 = um1;
  a.vm1 = vm1;
  a.tm1 = tm1;
  a.dpm1 = dpm1;
  a.qdp = qdp;
  a.pecnd = pecnd;
  a.vn0u = static_cast<float*>(vn0u);
  a.vn0v = static_cast<float*>(vn0v);
  a.omg = static_cast<float*>(omg);
  const size_t blk = static_cast<size_t>(nlev) * ncol;
  float* s1f = static_cast<float*>(s1);
  a.u1 = s1f;
  a.v1 = s1f + blk;
  a.t1 = s1f + 2 * blk;
  a.dp1 = s1f + 3 * blk;
  a.phi = static_cast<float*>(phi);
  a.fix_rank = static_cast<const int*>(fix_rank);
  a.slab = static_cast<float*>(slab);
  a.slab_ld = 4 * nlev;
  a.nlev = nlev;
  a.ncol = ncol;
  a.ld = ncol;
  a.moist = moist;
  a.rgas = rgas;
  a.kappa = kappa;
  a.rv_factor = rv_factor;
  a.rrearth = rrearth;
  ring::Args r = {};
  r.s1 = s1f;
  r.rsp = static_cast<const float*>(rsp);
  r.mx = static_cast<const float*>(mx);
  r.w = static_cast<float*>(w);
  r.counter = static_cast<int*>(state);
  r.done = r.counter + 1;
  r.flags = reinterpret_cast<unsigned*>(r.done + nb);
  r.nrsp = nrsp;
  r.ne = ne;
  r.nb = nb;
  r.halo = halo;
  r.ca = ca;
  r.cb = cb;

  auto* kernel = by_storage(storage, [&](auto kst) {
    constexpr int kSt = decltype(kst)::value;
    return stash ? ring_kernel<true, kSt>(single, phi != nullptr, mx)
                 : ring_kernel<false, kSt>(single, phi != nullptr, mx);
  });
  const size_t smem = chunked_smem(nlev, kRingTile, chunks, stash);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(state, 0, (1 + 2 * static_cast<size_t>(nb)) *
                        sizeof(int), st);
  if (err != cudaSuccess) return err;
  kernel<<<r.nb + halo + lag, kRingTile * chunks, smem, st>>>(
      a, r, chunks, levels, lag);
  return cudaGetLastError();
}

// Blocks of the pair-form kernel (fused = 0: caar_chunk_kernel on tiles of
// kChunkTile columns, with or without the stash; fused = 1:
// caar_ring_kernel, tiles of kRingTile, with or without the stash; fused =
// 2 and 3: caar_row_kernel at rsplit>0 and at rsplit=0, staged where
// stash; fused = 4 and 5: caar_r0_kernel, the t layout at rsplit=0, at 2
// and 3 blocks an SM), in the instance of `storage` (caar_launch's), that
// one SM holds at nlev levels in `chunks` chunks, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a CUDA error.
int caar_blocks_per_sm(int fused, int nlev, int chunks, int stash,
                       int storage, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (storage < 0 || storage > 2)
    return -static_cast<int>(cudaErrorInvalidValue);
  const bool row = fused == 2 || fused == 3, r0 = fused == 3;
  const int tile = fused == 1 ? kRingTile : kChunkTile;
  const size_t smem = row ? row_smem(nlev, chunks, stash, r0)
                          : chunked_smem(nlev, tile, chunks, stash);
  int n = 0;
  auto occupancy = [&](auto* kernel) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                        tile * chunks, smem);
    return e;
  };
  err = by_storage(storage, [&](auto kst) -> cudaError_t {
    constexpr int kSt = decltype(kst)::value;
    if (row)
      return r0 ? (stash ? occupancy(caar_row_kernel<true, true, kSt>)
                         : occupancy(caar_row_kernel<true, false, kSt>))
                : (stash ? occupancy(caar_row_kernel<false, true, kSt>)
                         : occupancy(caar_row_kernel<false, false, kSt>));
    if (fused == 4)
      return stash ? occupancy(caar_r0_kernel<true, 2, kSt>)
                   : occupancy(caar_r0_kernel<false, 2, kSt>);
    if (fused == 5) return occupancy(caar_r0_kernel<true, 3, kSt>);
    if (fused)
      return stash ? occupancy(caar_ring_kernel<false, true, false, true, kSt>)
                   : occupancy(
                         caar_ring_kernel<false, true, false, false, kSt>);
    return stash ? occupancy(caar_chunk_kernel<false, true, true, kSt>)
                 : occupancy(caar_chunk_kernel<false, true, false, kSt>);
  });
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
