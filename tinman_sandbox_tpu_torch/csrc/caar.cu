// CAAR (compute_and_apply_rhs, rsplit>0) on the packed [nlev, E16] layout.
//
// Replaces the Pallas kernels of tinman_sandbox_tpu/kernels/caar_pallas_t.py:
// caar_pallas_packed_t4_lg (the bench headline), caar_pallas_packed_t and
// caar_pallas_packed_t4. All three run _caar_physics plus the accumulator
// update; they differ only in how the buffers are cut, so this one kernel
// takes one pointer per field row block and covers the stacked and the
// unstacked forms.
//
// What bounds it on the H100: device-memory traffic. Per step it must read
// 13 fields (n0 and nm1 prognostics, qdp, pecnd, three accumulators) and the
// meta rows, and write 8 fields: about 99 MB at 1024 x 72, some 30 us at
// 3.35 TB/s, against ~0.2 GFLOP of FP32 work (~3 us at 67 TFLOP/s).
//
// Design: one thread per column of E16 (one GLL point of one element), so
// neighbouring threads read neighbouring addresses of each level's row; 16
// consecutive columns are one element and a 128-thread block holds 8
// elements. Each thread walks the levels carrying the vertical scans in
// registers. The 4-point Dvv contractions (grad, div, vort) read the
// element's 16 values of the current level from a shared-memory exchange
// row, double-buffered by level parity so one __syncthreads per level
// suffices. The geopotential is a REVERSE strict scan, which every level's
// tendencies need, so the kernel takes three passes over the levels:
//   1. top-down: midpoint pressure p and q = Rgas*T_v*dp/p, q kept in shared
//      memory ([nlev][128] floats, 36 KB at nlev = 72);
//   2. bottom-up over shared memory only: q becomes phi in place;
//   3. top-down: everything else, with p's scan recomputed from dp.
// Pass 1 re-reads dp, t and qdp that pass 3 reads again (16 field reads in
// place of 13). The dxbt/dybt block-diagonal operators and triangular scan
// matrices of the TPU kernel fed its matrix unit; here the contractions are
// 4-term FP32 FMAs on the 4x4 Dvv and the scans are running sums. No TF32.
// Known limit of this simple form: one thread per column gives E16 threads
// in all (16,384 at 1024 elements, ~6% of the card's thread slots), so the
// kernel is latency-bound well above its memory bound; splitting levels
// across warps with a cross-chunk scan is the next step.
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;   // 8 elements x 16 GLL points
constexpr int kRows = 7;      // exchange rows: p, gv1, gv2, vco1, vco2, t, ephi

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
  const float* um1; const float* vm1; const float* tm1; const float* dpm1;
  const float* qdp; const float* pecnd;
  float* vn0u; float* vn0v; float* omg;      // accumulators, in place
  float* u1; float* v1; float* t1; float* dp1; float* phi;
  int nlev, ncol, ld, moist;
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

__global__ void __launch_bounds__(kBlock) caar_kernel(CaarArgs a) {
  extern __shared__ float col_sm[];             // [nlev][kBlock]: q, then phi
  __shared__ float xch[2][kRows][kBlock];
  __shared__ float dvv[16];

  const int tid = threadIdx.x;
  const int col = blockIdx.x * kBlock + tid;
  const bool live = col < a.ncol;               // ncol % 16 == 0: whole elements
  const int eb = tid & ~15;                     // element's first lane in block
  const int li = (tid & 15) >> 2, lj = tid & 3; // lane = li*4 + lj
  const size_t ld = (size_t)a.ld;

  if (tid < 16) dvv[tid] = a.dvv[tid];
  float m[13];
#pragma unroll
  for (int r = 0; r < 13; ++r) m[r] = live ? a.meta[r * ld + col] : 1.f;
  const float dt2 = a.scal[0], eta = a.scal[1], h = a.scal[2];
  const float rr = a.rrearth;
  __syncthreads();

  // pass 1: p and q, top-down
  float s = 0.f;
  for (int k = 0; k < a.nlev; ++k) {
    float q = 0.f;
    if (live) {
      const size_t o = k * ld + col;
      const float dp = a.dp0[o], t = a.t0[o];
      s += dp;
      const float p = (h + s) - 0.5f * dp;
      const float tv = a.moist ? t * (1.f + a.rv_factor * (a.qdp[o] / dp)) : t;
      q = a.rgas * tv * (dp / p);
    }
    col_sm[k * kBlock + tid] = q;
  }
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
  for (int k = 0; k < a.nlev; ++k) {
    const size_t o = k * ld + col;
    float u = 0.f, v = 0.f, t = 0.f, dp = 1.f, qd = 0.f, pec = 0.f;
    float um1 = 0.f, vm1 = 0.f, tm1 = 0.f, dpm1 = 0.f;
    float an = 0.f, av = 0.f, ao = 0.f;
    if (live) {
      u = a.u0[o]; v = a.v0[o]; t = a.t0[o]; dp = a.dp0[o];
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
    const float vtens1 = v * fcor_vort - ge1 - gpterm * gp1;
    const float vtens2 = -(u * fcor_vort) - ge2 - gpterm * gp2;
    const float ttens = -(u * gt1 + v * gt2) + a.kappa * tv * omega_p;

    if (live) {
      const float sph = m[kSpheremp];
      a.u1[o] = sph * (um1 + dt2 * vtens1);
      a.v1[o] = sph * (vm1 + dt2 * vtens2);
      a.t1[o] = sph * (tm1 + dt2 * ttens);
      a.dp1[o] = sph * (dpm1 - dt2 * divdp);
      a.phi[o] = phi;
      a.vn0u[o] = an + eta * vdp1;
      a.vn0v[o] = av + eta * vdp2;
      a.omg[o] = ao + eta * omega_p;
    }
  }
}

}  // namespace

extern "C" {

const char* caar_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Enqueues one CAAR step on `stream`. Returns the cudaError_t of the launch.
int caar_launch(const void* scal, const void* meta, const void* dvv,
                const void* u0, const void* v0, const void* t0,
                const void* dp0, const void* um1, const void* vm1,
                const void* tm1, const void* dpm1, const void* qdp,
                const void* pecnd, void* vn0u, void* vn0v, void* omg,
                void* u1, void* v1, void* t1, void* dp1, void* phi,
                int nlev, int ncol, int ld, int moist, float rgas,
                float kappa, float rv_factor, float rrearth, void* stream,
                int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
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
  a.nlev = nlev;
  a.ncol = ncol;
  a.ld = ld;
  a.moist = moist;
  a.rgas = rgas;
  a.kappa = kappa;
  a.rv_factor = rv_factor;
  a.rrearth = rrearth;

  const size_t smem = static_cast<size_t>(nlev) * kBlock * sizeof(float);
  err = cudaFuncSetAttribute(caar_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int grid = (ncol + kBlock - 1) / kBlock;
  caar_kernel<<<grid, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

}  // extern "C"
