// The banded sweep as it was before its float4 redesign
// (tinman_sandbox_tpu_torch/csrc/dss.cu, dss_sweep_banded_kernel up to its
// parent commit), for experiments/kernel_variants.py (group banded): one
// shard lane a thread (256 a block, blockIdx.y a row), its chunk by an
// integer division, scalar loads, the sums of the scalar swept_banded below
// (the same adds in the same order as dss_sweep::swept4_banded), so it
// equals the port's kernel and the plain version bit for bit.
#include <cuda_runtime.h>

#include "dss_sweep.cuh"

namespace {

constexpr int kThreads = 256;

template <class Load>
__device__ __forceinline__ float swept_banded(const Load& load, int L, int ne,
                                              int bl, bool first, bool last,
                                              const float* __restrict__ rsp,
                                              int nrsp, int e16, int lr) {
  const int rl = 16 * ne, db = rl - 3, j = L & 3;
  float z = dss_sweep::alpha_sum(load, L, ne);
  if (j == 3 && !(last && L >= bl - rl))
    z = __fadd_rn(z, dss_sweep::alpha_sum(load, L + db, ne));
  else if (j == 0 && !(first && L < rl))
    z = __fadd_rn(z, dss_sweep::alpha_sum(
                         load, L >= db ? L - db : L - db + bl + 2 * rl, ne));
  return dss_sweep::scale(z, rsp, nrsp, e16, lr);
}

template <bool kMix, bool kMerge>
__global__ void __launch_bounds__(kThreads)
banded_lane_kernel(const float* __restrict__ x_ext,
                   const float* __restrict__ rsp, int nrsp,
                   const float* __restrict__ vd, int nfix,
                   const int* __restrict__ fix_col,
                   const int* __restrict__ flags, const float* mx, float ca,
                   float cb, float* out, int lanes, int bl, int nchunks,
                   int ne) {
  const int lo = blockIdx.x * kThreads + threadIdx.x;
  if (lo >= lanes) return;
  const size_t row = blockIdx.y;
  float res;
  int col = -1;
  if constexpr (kMerge) col = fix_col[lo];
  if (col >= 0) {
    res = vd[row * nfix + col];
  } else {
    const int c = lo / bl, ext = bl + 32 * ne;
    const float* xr = x_ext + (row * nchunks + c) * ext;
    const auto load = [xr](int i) { return xr[i]; };
    const int f = flags[c];
    res = swept_banded(load, lo - c * bl, ne, bl, f & 1, f & 2, rsp, nrsp,
                       lanes, lo);
  }
  const size_t o = row * lanes + lo;
  if constexpr (kMix) res = dss_sweep::mix(ca, mx[o], cb, res);
  out[o] = res;
}

}  // namespace

extern "C" {

// dss_sweep_banded_launch's arguments (a null vd: merge-free)
int banded_lane_launch(const void* x_ext, const void* rsp, int nrsp,
                       const void* vd, int nfix, const void* fix_col,
                       const void* flags, const void* mx, float ca, float cb,
                       void* out, int k, int lanes, int bl, int nchunks,
                       int ne, void* stream) {
  const dim3 grid((lanes + kThreads - 1) / kThreads, k);
  auto* kernel = vd ? (mx ? banded_lane_kernel<true, true>
                          : banded_lane_kernel<false, true>)
                    : (mx ? banded_lane_kernel<true, false>
                          : banded_lane_kernel<false, false>);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_ext), static_cast<const float*>(rsp), nrsp,
      static_cast<const float*>(vd), nfix, static_cast<const int*>(fix_col),
      static_cast<const int*>(flags), static_cast<const float*>(mx), ca, cb,
      static_cast<float*>(out), lanes, bl, nchunks, ne);
  return cudaGetLastError();
}

}  // extern "C"
