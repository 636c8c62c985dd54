// The row-layout tracer Euler kernel before its redesign for the H100
// (tinman_sandbox_tpu_torch/csrc/tracer.cu, tracer_row_kernel as ported),
// the control of experiments/kernel_variants.py's row_tracer group:
//   out = q - dt * div(v q) on q [E16, qsize*nlev], column j = tracer*nlev
//   + level, winds [E16, nlev], meta [E16, 16] (kernels/layout.py).
// A block is ONE element and 128 of the q*nlev columns, a thread a column:
// 16 threads stage the element's metric values in shared memory behind a
// barrier, then each thread reads the 16 GLL points of its column and the
// winds of level j % nlev with scalar loads (re-read for every tracer),
// forms gv1 = metdet*(dinv00*(u*q) + dinv01*(v*q)) and gv2 per tracer and
// contracts Dvv in registers. Built with -fmad=false as the port's source.
#include <cuda_runtime.h>

namespace {

enum Meta {
  kDinv00 = 0, kDinv01, kDinv10, kDinv11, kMetdet = 8, kRmetdet = 9
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

constexpr int kRowThreads = 128;   // most columns a block holds

__global__ void __launch_bounds__(kRowThreads)
tracer_row_kernel_old(const float* __restrict__ meta,
                      const float* __restrict__ dvv_g,
                      const float* __restrict__ vu,
                      const float* __restrict__ vv,
                      const float* __restrict__ q, float* __restrict__ out,
                      int nlev, int qk, float dt, float rr) {
  __shared__ float mt[6][16];
  __shared__ float dvv[16];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * 16;
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

}  // namespace

// The old launch: meta [ncol, 16], vu and vv [ncol, nlev], q and out
// [ncol, qk], all contiguous; returns the cudaError_t of the launch.
extern "C" int row_tracer_old_launch(const void* meta, const void* dvv,
                                     const void* vu, const void* vv,
                                     const void* q, void* out, int nlev,
                                     int qk, int ncol, float dt,
                                     float rrearth, void* stream) {
  const int warps32 = (qk + 31) / 32 * 32;
  const int threads = warps32 < kRowThreads ? warps32 : kRowThreads;
  const dim3 grid(ncol / 16, (qk + threads - 1) / threads);
  tracer_row_kernel_old<<<grid, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(vu), static_cast<const float*>(vv),
      static_cast<const float*>(q), static_cast<float*>(out), nlev, qk, dt,
      rrearth);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int row_tracer_old_blocks_per_sm() {
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, tracer_row_kernel_old, kRowThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
