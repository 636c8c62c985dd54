// The hyperviscosity Laplacians on the packed [k, E16] layout: one pass over
// the (u, v, T) row blocks computes the weak VECTOR Laplacian of (u, v) in
// the contravariant formulation,
//   grad_wk(nu_ratio * div) - curl_wk(vort) + 2 rr^2 spheremp (u, v)
// (SphereOperators.hpp:938-994), and the weak SCALAR Laplacian of T,
// div_wk(grad T) (hpp:537-550): the spheremp-weighted residuals that
// rspheremp * DSS closes.
//
// Replaces the Pallas kernels of
// tinman_sandbox_tpu/kernels/hypervis_pallas_t.py: vlap_pallas_packed_t
// (:144), vlap_pallas_packed_t_lg (:252) and vlap_pallas_packed_t_ext
// (:343), body _vlap_kernel_t (:42-139). Those differ in how the lane axis
// is cut for the TPU's grid and in the layout of the fix-lane slab; here
// one kernel with an optional slab covers the three. Their fast_dots mode
// (1-pass bf16 products) is left out on purpose of accuracy.
//
// What bounds it on the H100: device-memory traffic. It reads three row
// blocks and 12 meta rows and writes three row blocks (plus the slab), about
// 156 MB at ne30 x 72, some 0.047 ms at 3.35 TB/s, against ~0.9 GFLOP of
// FP32 work (~0.013 ms at 67 TFLOP/s).
//
// Design: no level couples to another, so a thread owns one lane of E16 and
// a chunk of kLevels levels, over which it keeps its 12 metric values (and
// metinv = Dinv Dinv^T, rebuilt from them as the TPU kernel does) in
// registers. The 16 lanes of an element sit in one half-warp. Each level
// takes two exchange rounds among them through shared memory, fenced by
// __syncwarp (an element never spans two warps): first the strong
// derivatives of T, gv1, gv2, vco1, vco2, then the adjoint contractions
// (_ax, _ay of ops/sphere.py) of spheremp*c1, spheremp*c2, mp*nu_ratio*div
// and mp*vort. The two rounds use separate buffers, so a level's first
// write cannot overtake the previous level's last read. Contractions are
// 4-term FP32 FMAs on the 4x4 Dvv; no TF32. x may be taller than 3*nlev
// rows (the [4*nlev] prognostic buffer): only its first three row blocks are
// read, by pointer offset, with no slice copy.
// Optional fix-lane slab, as the CAAR kernel's: the thread owning a lane
// with fix_rank[lane] = r >= 0 also writes its three outputs at every level
// to slab[r*3*nlev + f*nlev + level].
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;   // 8 elements x 16 GLL points
constexpr int kLevels = 8;    // levels walked by one block

// META_COLS row indices (kernels/layout.py)
enum Meta {
  kDinv00 = 0, kDinv01, kDinv10, kDinv11, kD00, kD01, kD10, kD11,
  kMetdet, kRmetdet, kFcor, kSpheremp, kPhis, kMp
};

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

// adjoint along the first GLL axis at (li, lj): sum_s Dvv[li, s] * x[s, lj]
__device__ __forceinline__ float ax(const float* dvv, const float* x, int li,
                                    int lj) {
  float acc = dvv[li * 4 + 0] * x[0 * 4 + lj];
  acc = fmaf(dvv[li * 4 + 1], x[1 * 4 + lj], acc);
  acc = fmaf(dvv[li * 4 + 2], x[2 * 4 + lj], acc);
  return fmaf(dvv[li * 4 + 3], x[3 * 4 + lj], acc);
}

// adjoint along the second GLL axis at (li, lj): sum_s x[li, s] * Dvv[lj, s]
__device__ __forceinline__ float ay(const float* dvv, const float* x, int li,
                                    int lj) {
  float acc = x[li * 4 + 0] * dvv[lj * 4 + 0];
  acc = fmaf(x[li * 4 + 1], dvv[lj * 4 + 1], acc);
  acc = fmaf(x[li * 4 + 2], dvv[lj * 4 + 2], acc);
  return fmaf(x[li * 4 + 3], dvv[lj * 4 + 3], acc);
}

__global__ void __launch_bounds__(kBlock)
vlap_kernel(const float* __restrict__ meta, const float* __restrict__ dvv_g,
            const float* __restrict__ x, float* __restrict__ out,
            const int* __restrict__ fix_rank, float* __restrict__ slab,
            int nlev, int ncol, int ld, float nu_ratio, float rr) {
  __shared__ float xs[5][kBlock];               // round 1: strong derivatives
  __shared__ float ws[4][kBlock];               // round 2: adjoint contractions
  __shared__ float dvv[16];

  const int tid = threadIdx.x;
  const int col = blockIdx.x * kBlock + tid;
  const bool live = col < ncol;                 // ncol % 16 == 0: whole elements
  const int eb = tid & ~15;                     // element's first lane in block
  const int li = (tid & 15) >> 2, lj = tid & 3; // lane = li*4 + lj
  const size_t ldz = static_cast<size_t>(ld);

  if (tid < 16) dvv[tid] = dvv_g[tid];
  float m[14];                                  // fcor and phis are not read
#pragma unroll
  for (int r = 0; r < 14; ++r)
    m[r] = (live && r != kFcor && r != kPhis) ? meta[r * ldz + col] : 1.f;
  // metinv = Dinv Dinv^T, the contravariant metric
  const float mi00 = m[kDinv00] * m[kDinv00] + m[kDinv01] * m[kDinv01];
  const float mi01 = m[kDinv00] * m[kDinv10] + m[kDinv01] * m[kDinv11];
  const float mi11 = m[kDinv10] * m[kDinv10] + m[kDinv11] * m[kDinv11];
  const float rmr = m[kRmetdet] * rr;
  const float sph = m[kSpheremp];
  const float rigid = (2.0f * rr * rr) * sph;
  const int srow = (live && fix_rank) ? fix_rank[col] : -1;
  float* const srow_p =
      srow >= 0 ? slab + static_cast<size_t>(srow) * 3 * nlev : nullptr;
  __syncthreads();

  const float* const xu = x;
  const float* const xv = x + static_cast<size_t>(nlev) * ldz;
  const float* const xt = x + 2 * static_cast<size_t>(nlev) * ldz;
  const int k0 = blockIdx.y * kLevels;
  const int k1 = min(k0 + kLevels, nlev);
  for (int k = k0; k < k1; ++k) {
    const size_t o = k * ldz + col;
    float u = 0.f, v = 0.f, t = 0.f;
    if (live) { u = xu[o]; v = xv[o]; t = xt[o]; }
    xs[0][tid] = t;
    xs[1][tid] = m[kMetdet] * (m[kDinv00] * u + m[kDinv01] * v);
    xs[2][tid] = m[kMetdet] * (m[kDinv10] * u + m[kDinv11] * v);
    xs[3][tid] = m[kD00] * u + m[kD10] * v;
    xs[4][tid] = m[kD01] * u + m[kD11] * v;
    __syncwarp();

    // grad T, then its contravariant components for div_wk
    const float v1 = dx(dvv, xs[0] + eb, li, lj) * rr;
    const float v2 = dy(dvv, xs[0] + eb, li, lj) * rr;
    const float g1 = m[kDinv00] * v1 + m[kDinv10] * v2;
    const float g2 = m[kDinv01] * v1 + m[kDinv11] * v2;
    const float c1 = m[kDinv00] * g1 + m[kDinv01] * g2;
    const float c2 = m[kDinv10] * g1 + m[kDinv11] * g2;
    const float div =
        (dx(dvv, xs[1] + eb, li, lj) + dy(dvv, xs[2] + eb, li, lj)) * rmr;
    const float vort =
        (dx(dvv, xs[4] + eb, li, lj) - dy(dvv, xs[3] + eb, li, lj)) * rmr;

    ws[0][tid] = sph * c1;
    ws[1][tid] = sph * c2;
    ws[2][tid] = m[kMp] * (nu_ratio * div);
    ws[3][tid] = m[kMp] * vort;
    __syncwarp();

    // laplace_simple(T) = div_wk(grad T)
    const float lap_t =
        -rr * (ax(dvv, ws[0] + eb, li, lj) + ay(dvv, ws[1] + eb, li, lj));
    // grad_sphere_wk_testcov(nu_ratio * div)
    const float axg = ax(dvv, ws[2] + eb, li, lj);
    const float ayg = ay(dvv, ws[2] + eb, li, lj);
    const float b0 = -m[kMetdet] * (mi00 * axg + mi01 * ayg);
    const float b1 = -m[kMetdet] * (mi01 * axg + mi11 * ayg);
    const float gw1 = (m[kD00] * b0 + m[kD01] * b1) * rr;
    const float gw2 = (m[kD10] * b0 + m[kD11] * b1) * rr;
    // curl_sphere_wk_testcov(vort)
    const float c0 = -ay(dvv, ws[3] + eb, li, lj);
    const float c1c = ax(dvv, ws[3] + eb, li, lj);
    const float cw1 = (m[kD00] * c0 + m[kD01] * c1c) * rr;
    const float cw2 = (m[kD10] * c0 + m[kD11] * c1c) * rr;

    if (live) {
      const float lu = rigid * u + (gw1 - cw1);
      const float lv = rigid * v + (gw2 - cw2);
      out[o] = lu;
      out[static_cast<size_t>(nlev) * ldz + o] = lv;
      out[2 * static_cast<size_t>(nlev) * ldz + o] = lap_t;
      if (srow_p) {
        srow_p[k] = lu;
        srow_p[nlev + k] = lv;
        srow_p[2 * nlev + k] = lap_t;
      }
    }
  }
}

}  // namespace

extern "C" {

const char* hypervis_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Enqueues the weak Laplacians of the first 3*nlev rows of x [>= 3*nlev, ld]
// into out [3*nlev, ld] on `stream`. Returns the cudaError_t of the launch.
// fix_rank and slab may be null (no slab output).
int hypervis_vlap_launch(const void* meta, const void* dvv, const void* x,
                         void* out, const void* fix_rank, void* slab,
                         int nlev, int ncol, int ld, float nu_ratio,
                         float rrearth, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((ncol + kBlock - 1) / kBlock,
                  (nlev + kLevels - 1) / kLevels);
  vlap_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<const int*>(fix_rank), static_cast<float*>(slab), nlev,
      ncol, ld, nu_ratio, rrearth);
  return cudaGetLastError();
}

}  // extern "C"
