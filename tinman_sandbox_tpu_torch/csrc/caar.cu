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
// Two bodies. The t layout at rsplit>0 (pair and stage forms, the slab; the
// bench, assembled, dynamics and prim steps and the ring) runs the level-
// chunked body, caar_chunked. Why: the column-a-thread body it
// replaced gave the card E16 threads in all (16,384 at 1024 x 72: 128
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
// order of the column-a-thread body (no exchange row, no per-level barrier).
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
// The rsplit=0 and row modes keep the column-a-thread body (caar_tile):
// one thread per column, 128-column blocks, the element's values of a
// level exchanged through a shared-memory row double-buffered by level
// parity, and three passes over the levels:
//   1. top-down: midpoint pressure p and q = Rgas*T_v*dp/p, q kept in shared
//      memory ([nlev][128] floats, 36 KB at nlev = 72);
//   2. bottom-up over shared memory only: q becomes phi in place;
//   3. top-down: everything else, with p's scan recomputed from dp.
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
// etaacc += eta_ave_w*eta_hi in place (interfaces 1..nlev). Every level's
// flux needs the column total first, so pass 1 also builds the mass-flux
// exchange rows and sums divdp: one more __syncthreads per level and u, v
// read twice. The boundary zeros are forced by the level test, not
// computed (hybi(nlev)*sdot - sdot is not 0 in f32). The advection reads one
// level ahead: pass 3 carries a register window of u, v, T at k-1, k, k+1,
// so each is still read once there. hybi comes as two strided vectors
// (hyb_lo[k*hs] = hybi(k), hyb_hi[k*hs] = hybi(k+1)), so the [nlev, 2] hyb
// of the t kernel and the [2, nlev] of the row kernel go in without a copy.
// Row mode (kRow): the same thread per column on [E16, nlev] fields (and
// the [E16, 16] meta), element (col, k) at col*nlev + k. The 32 threads of a
// warp then read addresses nlev*4 = 288 bytes apart: every access is
// uncoalesced and each 32-byte sector is reused over 8 levels through L1.
// Accepted for now; a shared-memory transpose of the tile is later work.
// The row mode takes neither a slab nor the stage mode, and the rsplit=0
// mode no slab: no caller needs them. Both are latency-bound as the t form
// was before its chunked body (one thread a column); moving them to it is
// later work.
//
// Ring-fused mode (caar_ring_kernel): replaces caar_ring_packed_t4 of
// tinman_sandbox_tpu/kernels/ring_fused.py (:189, body _caar_ring_kernel
// :106), the CAAR step and the rspheremp-scaled alpha/beta sweep of its s1
// in one launch, optionally with the sweep's mix epilogue. A block of
// 128*chunks threads runs caar_chunked (the same code and chunks as
// caar_chunk_kernel, so the same bits) for one 128-column tile into a
// scratch s1, flags it, and then sweeps the tile `halo` tiles behind it,
// its rows split over the chunks' threads (dss_sweep.cuh, the sweep's
// expressions), waiting for the tiles that sweep reads (ring.cuh). The fix
// lanes keep their in-face partial sums; the fixup and the patch (dss.cu)
// complete the DSS. Bound: the CAAR
// step's bytes and the swept output; s1 goes to the scratch and is read
// back from L2 while it is recent (the TPU kernel kept it in VMEM only;
// keeping it out of device memory here is later work). The stage and phi
// modes carry over; the ring takes neither rsplit=0 nor the row layout.
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kBlock = 128;   // 8 elements x 16 GLL points: the column-a-
                              // thread body's block and the ring's tile
constexpr int kRows = 7;      // exchange rows: p, gv1, gv2, vco1, vco2, t, ephi
constexpr int kMaxThreads = 1024;          // the ring's largest block
// the chunked kernel's tile (a warp of columns: two elements), its largest
// block (at most 8 chunks) and the blocks an SM holds at its register cap
// (80)
constexpr int kChunkTile = 32;
constexpr int kChunkThreads = 256;
constexpr int kChunkBlocks = 3;
constexpr size_t kMaxSmem = 232448;        // a block's shared memory (227 KB)
constexpr unsigned kFull = 0xffffffffu;

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
  // the base state of the update; all four null = the evaluation state
  const float* um1; const float* vm1; const float* tm1; const float* dpm1;
  const float* qdp; const float* pecnd;
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

// d/dx at lane (li, lj): sum_i Dvv[i, li] * s[i, lj]
__device__ __forceinline__ float dx(const float* dvv, const float* s, int li,
                                    int lj) {
  float acc = dvv[0 * 4 + li] * s[0 * 4 + lj];
  acc = fmaf(dvv[1 * 4 + li], s[1 * 4 + lj], acc);
  acc = fmaf(dvv[2 * 4 + li], s[2 * 4 + lj], acc);
  return fmaf(dvv[3 * 4 + li], s[3 * 4 + lj], acc);
}

// d/dy at lane (li, lj): sum_m Dvv[m, lj] * s[li, m]
__device__ __forceinline__ float dy(const float* dvv, const float* s, int li,
                                    int lj) {
  float acc = dvv[0 * 4 + lj] * s[li * 4 + 0];
  acc = fmaf(dvv[1 * 4 + lj], s[li * 4 + 1], acc);
  acc = fmaf(dvv[2 * 4 + lj], s[li * 4 + 2], acc);
  return fmaf(dvv[3 * 4 + lj], s[li * 4 + 3], acc);
}

// offset of level k of column col: ld is the level stride on the t layout
// and the column stride on the row layout
template <bool kRow>
__device__ __forceinline__ size_t at(int k, int col, size_t ld) {
  return kRow ? static_cast<size_t>(col) * ld + k
              : static_cast<size_t>(k) * ld + col;
}

// The column-a-thread body of the rsplit=0 and row-layout modes:
// kR0: rsplit=0 (interface flux, vertical advection, eta accumulator);
// kRow: [E16, nlev] fields and [E16, 16] meta. One step for the 128
// columns of tile `tile`, by the calling block of kBlock threads; the
// block's shared memory comes in: col_sm [nlev][kBlock] (q, then phi), the
// exchange rows xch and dvv. The pair form only: no stage mode, no fix-lane
// output, phi always stored.
template <bool kR0, bool kRow>
__device__ __forceinline__ void caar_tile(const CaarArgs& a, int tile,
                                          float* col_sm,
                                          float (*xch)[kRows][kBlock],
                                          float* dvv) {
  const int tid = threadIdx.x;
  const int col = tile * kBlock + tid;
  const bool live = col < a.ncol;               // ncol % 16 == 0: whole elements
  const int eb = tid & ~15;                     // element's first lane in block
  const int li = (tid & 15) >> 2, lj = tid & 3; // lane = li*4 + lj
  const size_t ld = (size_t)a.ld;

  if (tid < 16) dvv[tid] = a.dvv[tid];
  float m[13];
#pragma unroll
  for (int r = 0; r < 13; ++r)
    m[r] = live ? a.meta[kRow ? static_cast<size_t>(col) * 16 + r
                              : r * ld + col]
                : 1.f;
  const float dt2 = a.scal[0], eta = a.scal[1], h = a.scal[2];
  const float rr = a.rrearth;
  __syncthreads();

  // pass 1: p and q, top-down; with kR0 also the column total of divdp
  float s = 0.f, sdot = 0.f;
  for (int k = 0; k < a.nlev; ++k) {
    float q = 0.f, gv1 = 0.f, gv2 = 0.f;
    if (live) {
      const size_t o = at<kRow>(k, col, ld);
      const float dp = a.dp0[o], t = a.t0[o];
      s += dp;
      const float p = (h + s) - 0.5f * dp;
      const float tv = a.moist ? t * (1.f + a.rv_factor * (a.qdp[o] / dp)) : t;
      q = a.rgas * tv * (dp / p);
      if constexpr (kR0) {
        const float vdp1 = a.u0[o] * dp, vdp2 = a.v0[o] * dp;
        gv1 = m[kMetdet] * (m[kDinv00] * vdp1 + m[kDinv01] * vdp2);
        gv2 = m[kMetdet] * (m[kDinv10] * vdp1 + m[kDinv11] * vdp2);
      }
    }
    col_sm[k * kBlock + tid] = q;
    if constexpr (kR0) {
      float* x = &xch[k & 1][0][0];
      x[1 * kBlock + tid] = gv1;
      x[2 * kBlock + tid] = gv2;
      __syncthreads();
      sdot += (dx(dvv, x + 1 * kBlock + eb, li, lj) +
               dy(dvv, x + 2 * kBlock + eb, li, lj)) * (m[kRmetdet] * rr);
    }
  }
  // pass 3's first exchange must not overtake pass 1's last reads
  if constexpr (kR0) __syncthreads();
  // pass 2: phi = phis + sum_{l>k} q(l) + q(k)/2, bottom-up, in place
  float rsum = 0.f;
  for (int k = a.nlev - 1; k >= 0; --k) {
    const float q = col_sm[k * kBlock + tid];
    col_sm[k * kBlock + tid] = (m[kPhis] + rsum) + 0.5f * q;
    rsum += q;
  }

  // pass 3: tendencies and apply, top-down
  s = 0.f;
  float cum = 0.f;                              // sum_{l<k} divdp(l)
  // kR0: u, v, T at the next level, and at the previous one (equal to the
  // current one at the top and the bottom, so the missing difference is 0)
  float un = 0.f, vn = 0.f, tn = 0.f;
  if constexpr (kR0) {
    if (live) {
      const size_t o = at<kRow>(0, col, ld);
      un = a.u0[o]; vn = a.v0[o]; tn = a.t0[o];
    }
  }
  float up = un, vp = vn, tp = tn;
  for (int k = 0; k < a.nlev; ++k) {
    const size_t o = at<kRow>(k, col, ld);
    float u = 0.f, v = 0.f, t = 0.f, dp = 1.f, qd = 0.f, pec = 0.f;
    float um1 = 0.f, vm1 = 0.f, tm1 = 0.f, dpm1 = 0.f;
    float an = 0.f, av = 0.f, ao = 0.f, ae = 0.f;
    if (live) {
      if constexpr (kR0) {
        u = un; v = vn; t = tn;
        if (k + 1 < a.nlev) {
          const size_t o1 = at<kRow>(k + 1, col, ld);
          un = a.u0[o1]; vn = a.v0[o1]; tn = a.t0[o1];
        }
        ae = a.etaacc[o];
      } else {
        u = a.u0[o]; v = a.v0[o]; t = a.t0[o];
      }
      dp = a.dp0[o];
      if (a.moist) qd = a.qdp[o];
      pec = a.pecnd[o];
      um1 = a.um1[o]; vm1 = a.vm1[o]; tm1 = a.tm1[o]; dpm1 = a.dpm1[o];
      an = a.vn0u[o]; av = a.vn0v[o]; ao = a.omg[o];
    }
    s += dp;
    const float p = (h + s) - 0.5f * dp;
    const float vdp1 = u * dp, vdp2 = v * dp;
    const float phi = col_sm[k * kBlock + tid];
    float* x = &xch[k & 1][0][0];
    x[0 * kBlock + tid] = p;
    x[1 * kBlock + tid] = m[kMetdet] * (m[kDinv00] * vdp1 + m[kDinv01] * vdp2);
    x[2 * kBlock + tid] = m[kMetdet] * (m[kDinv10] * vdp1 + m[kDinv11] * vdp2);
    x[3 * kBlock + tid] = m[kD00] * u + m[kD10] * v;
    x[4 * kBlock + tid] = m[kD01] * u + m[kD11] * v;
    x[5 * kBlock + tid] = t;
    x[6 * kBlock + tid] = 0.5f * (u * u + v * v) + phi + pec;
    __syncthreads();

    const float* xp = x + 0 * kBlock + eb;
    const float* xg1 = x + 1 * kBlock + eb;
    const float* xg2 = x + 2 * kBlock + eb;
    const float* xc1 = x + 3 * kBlock + eb;
    const float* xc2 = x + 4 * kBlock + eb;
    const float* xt = x + 5 * kBlock + eb;
    const float* xe = x + 6 * kBlock + eb;

    // grad p, v.grad p
    float g1 = dx(dvv, xp, li, lj) * rr, g2 = dy(dvv, xp, li, lj) * rr;
    const float gp1 = m[kDinv00] * g1 + m[kDinv10] * g2;
    const float gp2 = m[kDinv01] * g1 + m[kDinv11] * g2;
    const float vgrad_p = u * gp1 + v * gp2;
    // div(v dp), vorticity
    const float rmr = m[kRmetdet] * rr;
    const float divdp = (dx(dvv, xg1, li, lj) + dy(dvv, xg2, li, lj)) * rmr;
    const float vort = (dx(dvv, xc2, li, lj) - dy(dvv, xc1, li, lj)) * rmr;
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
      u_vadv = facp * (un - u) + facm * (u - up);
      v_vadv = facp * (vn - v) + facm * (v - vp);
      t_vadv = facp * (tn - t) + facm * (t - tp);
      up = u; vp = v; tp = t;
    }
    cum += divdp;
    // grad T, grad(E + phi)
    g1 = dx(dvv, xt, li, lj) * rr;
    g2 = dy(dvv, xt, li, lj) * rr;
    const float gt1 = m[kDinv00] * g1 + m[kDinv10] * g2;
    const float gt2 = m[kDinv01] * g1 + m[kDinv11] * g2;
    g1 = dx(dvv, xe, li, lj) * rr;
    g2 = dy(dvv, xe, li, lj) * rr;
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
      dptens = divdp + (eta_hi - eta_lo);
    } else {
      vtens1 = v * fcor_vort - ge1 - gpterm * gp1;
      vtens2 = -(u * fcor_vort) - ge2 - gpterm * gp2;
      ttens = -(u * gt1 + v * gt2) + a.kappa * tv * omega_p;
      dptens = divdp;
    }

    if (live) {
      const float sph = m[kSpheremp];
      const float u1 = sph * (um1 + dt2 * vtens1);
      const float v1 = sph * (vm1 + dt2 * vtens2);
      const float t1 = sph * (tm1 + dt2 * ttens);
      const float dp1 = sph * (dpm1 - dt2 * dptens);
      a.u1[o] = u1;
      a.v1[o] = v1;
      a.t1[o] = t1;
      a.dp1[o] = dp1;
      a.phi[o] = phi;
      a.vn0u[o] = an + eta * vdp1;
      a.vn0v[o] = av + eta * vdp2;
      a.omg[o] = ao + eta * omega_p;
      if constexpr (kR0) a.etaacc[o] = ae + eta * eta_hi;
    }
  }
}

template <bool kR0, bool kRow>
__global__ void __launch_bounds__(kBlock) caar_kernel(CaarArgs a) {
  extern __shared__ float col_sm[];             // [nlev][kBlock]: q, then phi
  __shared__ float xch[2][kRows][kBlock];
  __shared__ float dvv[16];
  caar_tile<kR0, kRow>(a, blockIdx.x, col_sm, xch, dvv);
}

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

// The level-chunked body of the t layout, rsplit>0 (pair and stage forms,
// the optional slab): one step for the kTile columns of tile `tile_idx` by
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
template <int kTile, bool kSingle, bool kPhi, bool kStash>
__device__ __forceinline__ void caar_chunked(const CaarArgs& a, int tile_idx,
                                             int chunks, int levels,
                                             float* phi_sm) {
  static_assert(kTile % 32 == 0, "a tile is whole warps of columns");
  constexpr int tile = kTile;
  const int tid = threadIdx.x;
  const int c = tid / tile, x = tid - c * tile;
  const int col = tile_idx * tile + x;
  const bool live = col < a.ncol;               // ncol % 16 == 0
  const int lane = tid & 31, eb = lane & 16;
  const int li = (lane >> 2) & 3, lj = lane & 3;
  const size_t ld = (size_t)a.ld;
  const int k0 = c * levels, k1 = min(a.nlev, k0 + levels);
  float dxv[4], dyv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    dxv[i] = a.dvv[i * 4 + li];
    dyv[i] = a.dvv[i * 4 + lj];
  }
  float m[13];
#pragma unroll
  for (int r = 0; r < 13; ++r) m[r] = live ? a.meta[r * ld + col] : 1.f;
  const float dt2 = a.scal[0], eta = a.scal[1], h = a.scal[2];
  const float rr = a.rrearth, rmr = m[kRmetdet] * rr;
  const size_t plane = static_cast<size_t>(a.nlev) * tile;
  float* const tot_s = phi_sm + plane + x;      // tot[f][cc] at f*chunks + cc
  const int stride = tile;
  // the stash's five planes at this thread's column: dp, u, v, t, qdp
  float* const st = phi_sm + plane + 3 * chunks * tile + x;

  // pass 1: the chunk's dp total
  float sum = 0.f;
  for (int k = k0; k < k1; ++k) {
    const float dp = live ? a.dp0[k * ld + col] : 1.f;
    if constexpr (kStash) st[k * tile] = dp;
    if (live) sum += dp;
  }
  tot_s[c * stride] = sum;
  __syncthreads();
  float s0 = 0.f;
  for (int cc = 0; cc < c; ++cc) s0 += tot_s[cc * stride];

  // pass 2: q into phi_sm; the chunk's q and divdp totals. Each level's
  // device-memory loads are issued one level ahead (nx), before the
  // current level's shuffles and sums.
  struct In2 { float dp = 1.f, t = 0.f, u = 0.f, v = 0.f, qd = 0.f; };
  const auto load2 = [&](int k) {
    In2 r;
    const size_t o = k * ld + col;
    if constexpr (!kStash) r.dp = a.dp0[o];
    r.t = a.t0[o]; r.u = a.u0[o]; r.v = a.v0[o];
    if (a.moist) r.qd = a.qdp[o];
    return r;
  };
  float s = s0, qsum = 0.f, dsum = 0.f;
  In2 nx;
  if (live && k0 < k1) nx = load2(k0);
  for (int k = k0; k < k1; ++k) {
    In2 in = nx;
    if (live && k + 1 < k1) nx = load2(k + 1);
    if constexpr (kStash) {
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
    phi_sm[k * tile + x] = q;
    qsum += q;
    dsum += divdp_w(m, dxv, dyv, in.u * dp, in.v * dp, rmr, eb, li, lj);
  }
  tot_s[(chunks + c) * stride] = qsum;
  tot_s[(2 * chunks + c) * stride] = dsum;
  __syncthreads();
  float rsum = 0.f, cum = 0.f;
  for (int cc = chunks - 1; cc > c; --cc)
    rsum += tot_s[(chunks + cc) * stride];
  for (int cc = 0; cc < c; ++cc) cum += tot_s[(2 * chunks + cc) * stride];

  // pass 2b: phi = phis + sum_{l>k} q(l) + q(k)/2, bottom-up, own cells
  for (int k = k1 - 1; k >= k0; --k) {
    const float q = phi_sm[k * tile + x];
    phi_sm[k * tile + x] = (m[kPhis] + rsum) + 0.5f * q;
    rsum += q;
  }

  // pass 3: tendencies and apply, top-down
  const int srow = (live && a.fix_rank) ? a.fix_rank[col] : -1;
  float* const slab = srow >= 0 ? a.slab + (size_t)srow * a.slab_ld : nullptr;
  // the device-memory loads of pass 3, one level ahead as in pass 2
  struct In3 {
    float u = 0.f, v = 0.f, t = 0.f, dp = 1.f, qd = 0.f, pec = 0.f;
    float um1 = 0.f, vm1 = 0.f, tm1 = 0.f, dpm1 = 0.f;
    float an = 0.f, av = 0.f, ao = 0.f;
  };
  const auto load3 = [&](int k) {
    In3 r;
    const size_t o = k * ld + col;
    if constexpr (!kStash) {
      r.u = a.u0[o]; r.v = a.v0[o]; r.t = a.t0[o]; r.dp = a.dp0[o];
      if (a.moist) r.qd = a.qdp[o];
    }
    r.pec = a.pecnd[o];
    if constexpr (!kSingle) {
      r.um1 = a.um1[o]; r.vm1 = a.vm1[o]; r.tm1 = a.tm1[o];
      r.dpm1 = a.dpm1[o];
    }
    r.an = a.vn0u[o]; r.av = a.vn0v[o]; r.ao = a.omg[o];
    return r;
  };
  In3 nx3;
  if (live && k0 < k1) nx3 = load3(k0);
  s = s0;
  for (int k = k0; k < k1; ++k) {
    const size_t o = k * ld + col;
    In3 in = nx3;
    if (live && k + 1 < k1) nx3 = load3(k + 1);
    if (live) {
      if constexpr (kStash) {
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
    const float phi = phi_sm[k * tile + x];

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
    const float vtens1 = v * fcor_vort - ge1 - gpterm * gp1;
    const float vtens2 = -(u * fcor_vort) - ge2 - gpterm * gp2;
    const float ttens = -(u * gt1 + v * gt2) + a.kappa * tv * omega_p;

    if (live) {
      const float sph = m[kSpheremp];
      const float u1 = sph * (um1 + dt2 * vtens1);
      const float v1 = sph * (vm1 + dt2 * vtens2);
      const float t1 = sph * (tm1 + dt2 * ttens);
      const float dp1 = sph * (dpm1 - dt2 * divdp);
      a.u1[o] = u1;
      a.v1[o] = v1;
      a.t1[o] = t1;
      a.dp1[o] = dp1;
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

template <bool kSingle, bool kPhi, bool kStash>
__global__ void __launch_bounds__(kChunkThreads, kChunkBlocks)
caar_chunk_kernel(CaarArgs a, int chunks, int levels) {
  extern __shared__ float sm[];
  caar_chunked<kChunkTile, kSingle, kPhi, kStash>(a, blockIdx.x, chunks,
                                                  levels, sm);
}

// The ring-fused step (t layout, rsplit>0): tile t of the CAAR step into the
// scratch s1 (a.u1..a.dp1 are its four row blocks), with phi, the
// accumulators and the slab as caar_chunk_kernel writes them (the same body
// on tiles of kBlock columns, kBlock*chunks threads); then the sweep of
// tile t - halo over all 4*nlev rows into r.w (see ring.cuh), the rows
// split over the block's chunks. nb + halo blocks; the fix lanes of r.w
// hold in-face partial sums.
template <bool kSingle, bool kPhi, bool kMix>
__global__ void __launch_bounds__(kMaxThreads)
caar_ring_kernel(CaarArgs a, ring::Args r, int chunks, int levels) {
  extern __shared__ float sm[];
  const int t = ring::ticket(r.counter);
  if (t < r.nb) {
    caar_chunked<kBlock, kSingle, kPhi, false>(a, t, chunks, levels, sm);
    ring::publish(r.flags + t, r.epoch);
  }
  const int j = t - r.halo;
  if (j < 0) return;
  const int after = ring::wait(r.flags, max(j - r.halo, 0),
                               min(j + r.halo, r.nb - 1), r.epoch);
  const int g = threadIdx.x / kBlock;
  const int l = j * kBlock + threadIdx.x - g * kBlock;
  const int rows = 4 * a.nlev, per = (rows + chunks - 1) / chunks;
  const int row0 = min(rows, g * per), nrows = min(rows, row0 + per) - row0;
  if (l < a.ncol) ring::emit<kMix>(r, after, row0, nrows, l, a.ncol);
}

template <bool kR0, bool kRow>
cudaError_t launch_tile(const CaarArgs& a, cudaStream_t stream) {
  auto* kernel = caar_kernel<kR0, kRow>;
  const size_t smem = static_cast<size_t>(a.nlev) * kBlock * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.ncol + kBlock - 1) / kBlock;
  kernel<<<grid, kBlock, smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool kSingle, bool kPhi, bool kStash>
cudaError_t launch_chunked(const CaarArgs& a, int chunks, int levels,
                           cudaStream_t stream) {
  auto* kernel = caar_chunk_kernel<kSingle, kPhi, kStash>;
  const size_t smem = chunked_smem(a.nlev, kChunkTile, chunks, kStash);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (a.ncol + kChunkTile - 1) / kChunkTile;
  kernel<<<grid, kChunkTile * chunks, smem, stream>>>(a, chunks, levels);
  return cudaGetLastError();
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
// rsplit>0 only. (chunks, levels, stash) is the plan of the chunked body
// (kernels/caar_t.py::caar_plan), which the t layout at rsplit>0 runs; the
// rsplit=0 and row modes run the column-a-thread body and ignore it.
int caar_launch(const void* scal, const void* meta, const void* dvv,
                const void* u0, const void* v0, const void* t0,
                const void* dp0, const void* um1, const void* vm1,
                const void* tm1, const void* dpm1, const void* qdp,
                const void* pecnd, void* vn0u, void* vn0v, void* omg,
                void* u1, void* v1, void* t1, void* dp1, void* phi,
                const void* fix_rank, void* slab, const void* hyb_lo,
                const void* hyb_hi, void* etaacc, int nlev, int ncol,
                int ld, int moist, int slab_ld, int hyb_stride, int row,
                int chunks, int levels, int stash, float rgas, float kappa,
                float rv_factor, float rrearth, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if ((um1 == nullptr) != (vm1 == nullptr) ||
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
  if (!r0 && !row &&
      !plan_ok(nlev, kChunkTile, chunks, levels, stash, kChunkThreads))
    return cudaErrorInvalidValue;
  CaarArgs a;
  a.scal = static_cast<const float*>(scal);
  a.meta = static_cast<const float*>(meta);
  a.dvv = static_cast<const float*>(dvv);
  a.u0 = static_cast<const float*>(u0);
  a.v0 = static_cast<const float*>(v0);
  a.t0 = static_cast<const float*>(t0);
  a.dp0 = static_cast<const float*>(dp0);
  a.um1 = static_cast<const float*>(um1);
  a.vm1 = static_cast<const float*>(vm1);
  a.tm1 = static_cast<const float*>(tm1);
  a.dpm1 = static_cast<const float*>(dpm1);
  a.qdp = static_cast<const float*>(qdp);
  a.pecnd = static_cast<const float*>(pecnd);
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
  if (row)
    return r0 ? launch_tile<true, true>(a, st)
              : launch_tile<false, true>(a, st);
  if (r0) return launch_tile<true, false>(a, st);
  if (stash) {
    if (um1 == nullptr)
      return phi ? launch_chunked<true, true, true>(a, chunks, levels, st)
                 : launch_chunked<true, false, true>(a, chunks, levels, st);
    return launch_chunked<false, true, true>(a, chunks, levels, st);
  }
  if (um1 == nullptr)
    return phi ? launch_chunked<true, true, false>(a, chunks, levels, st)
               : launch_chunked<true, false, false>(a, chunks, levels, st);
  return launch_chunked<false, true, false>(a, chunks, levels, st);
}

// Enqueues one ring-fused step (t layout, rsplit>0, with the slab) on
// `stream`: a 4-byte memset of the ticket counter, then one kernel of
// nb + halo blocks of kBlock*chunks threads; flags holds nflags >= nb
// entries. s1 is the [4*nlev, ncol] scratch, w the swept output, mx null
// (no mix) or a [4*nlev, ncol] field; um1..dpm1 all null = the stage mode,
// phi null only there; (chunks, levels) as caar_launch's plan at nlev.
// Returns the cudaError_t.
int caar_ring_launch(const void* scal, const void* meta, const void* dvv,
                     const void* u0, const void* v0, const void* t0,
                     const void* dp0, const void* um1, const void* vm1,
                     const void* tm1, const void* dpm1, const void* qdp,
                     const void* pecnd, void* vn0u, void* vn0v, void* omg,
                     void* s1, void* phi, const void* fix_rank, void* slab,
                     const void* rsp, const void* mx, void* w, void* flags,
                     void* counter, unsigned epoch, int nflags, int nlev,
                     int ncol, int moist, int nrsp, int ne, int halo,
                     int chunks, int levels, float rgas,
                     float kappa, float rv_factor, float rrearth, float ca,
                     float cb, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool single = um1 == nullptr;
  if (single != (vm1 == nullptr) || single != (tm1 == nullptr) ||
      single != (dpm1 == nullptr) || (phi == nullptr && !single) ||
      fix_rank == nullptr || epoch == 0 ||
      !plan_ok(nlev, kBlock, chunks, levels, false, kMaxThreads) ||
      !ring::fits((ncol + kBlock - 1) / kBlock, nflags, ne, halo, kBlock))
    return cudaErrorInvalidValue;
  CaarArgs a = {};
  a.scal = static_cast<const float*>(scal);
  a.meta = static_cast<const float*>(meta);
  a.dvv = static_cast<const float*>(dvv);
  a.u0 = static_cast<const float*>(u0);
  a.v0 = static_cast<const float*>(v0);
  a.t0 = static_cast<const float*>(t0);
  a.dp0 = static_cast<const float*>(dp0);
  a.um1 = static_cast<const float*>(um1);
  a.vm1 = static_cast<const float*>(vm1);
  a.tm1 = static_cast<const float*>(tm1);
  a.dpm1 = static_cast<const float*>(dpm1);
  a.qdp = static_cast<const float*>(qdp);
  a.pecnd = static_cast<const float*>(pecnd);
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
  r.flags = static_cast<unsigned*>(flags);
  r.counter = static_cast<int*>(counter);
  r.epoch = epoch;
  r.nrsp = nrsp;
  r.ne = ne;
  r.nb = (ncol + kBlock - 1) / kBlock;
  r.halo = halo;
  r.ca = ca;
  r.cb = cb;

  auto* kernel =
      single ? (phi ? (mx ? caar_ring_kernel<true, true, true>
                          : caar_ring_kernel<true, true, false>)
                    : (mx ? caar_ring_kernel<true, false, true>
                          : caar_ring_kernel<true, false, false>))
             : (mx ? caar_ring_kernel<false, true, true>
                   : caar_ring_kernel<false, true, false>);
  const size_t smem = chunked_smem(nlev, kBlock, chunks, false);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  kernel<<<r.nb + halo, kBlock * chunks, smem, st>>>(a, r, chunks, levels);
  return cudaGetLastError();
}

// Blocks of the pair-form kernel (fused = 0: caar_chunk_kernel on tiles of
// kChunkTile columns, with or without the stash; fused = 1:
// caar_ring_kernel, tiles of kBlock, no stash) that one SM holds at nlev
// levels in `chunks` chunks, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a CUDA error.
int caar_blocks_per_sm(int fused, int nlev, int chunks, int stash,
                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int tile = fused ? kBlock : kChunkTile;
  if (fused) stash = 0;
  const size_t smem = chunked_smem(nlev, tile, chunks, stash);
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
  err = fused ? occupancy(caar_ring_kernel<false, true, false>)
        : stash ? occupancy(caar_chunk_kernel<false, true, true>)
                : occupancy(caar_chunk_kernel<false, true, false>);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
