// Variants of the DSS fixup (tinman_sandbox_tpu_torch/csrc/dss.cu,
// dss_fixup_kernel) for experiments/kernel_variants.py. Every variant sums
// the same slab rows in the same order with the same rounding as the port's
// kernel, so each equals dss_fixup_plain bit for bit; they differ only in
// which thread computes which element of vd [k, nfix] from slab [nsrc, k]:
//   0 flat, u fastest (the kernel before the tile): a warp's loads of one
//     summand are k floats apart, its stores contiguous;
//   1 flat, row fastest: loads contiguous along the level axis, stores nfix
//     floats apart;
//   2 tiled, 32 fix lanes x 32 rows a block (the port's plan): loads along
//     the level axis, the tile turned in shared memory, stores along u;
//   3 tiled, 32 fix lanes x 64 rows a block.
#include <cuda_runtime.h>

#include "dss_sweep.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 32;
constexpr int kRowsA = 8;   // thread rows of a tiled block

__device__ __forceinline__ float value(const float* __restrict__ slab,
                                       int4 s, size_t row, int k) {
  float za = slab[static_cast<size_t>(s.x) * k + row];
  if (s.y >= 0) za = __fadd_rn(za, slab[static_cast<size_t>(s.y) * k + row]);
  float zb = slab[static_cast<size_t>(s.z) * k + row];
  if (s.w >= 0) zb = __fadd_rn(zb, slab[static_cast<size_t>(s.w) * k + row]);
  return __fadd_rn(za, zb);
}

template <bool kRowFastest>
__global__ void __launch_bounds__(kThreads)
fixup_flat(const float* __restrict__ slab, const int4* __restrict__ src,
           const int* __restrict__ fix_lanes, const float* __restrict__ rsp,
           int nrsp, int e16, float* __restrict__ vd, int nfix, int k) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= static_cast<size_t>(nfix) * k) return;
  const int u = kRowFastest ? static_cast<int>(idx / k)
                            : static_cast<int>(idx % nfix);
  const size_t row = kRowFastest ? idx % k : idx / nfix;
  vd[row * nfix + u] = dss_sweep::scale(value(slab, src[u], row, k), rsp,
                                        nrsp, e16, fix_lanes[u]);
}

template <int kRows>
__global__ void __launch_bounds__(kLanes * kRowsA)
fixup_tiled(const float* __restrict__ slab, const int4* __restrict__ src,
            const int* __restrict__ fix_lanes, const float* __restrict__ rsp,
            int nrsp, int e16, float* __restrict__ vd, int nfix, int k) {
  __shared__ float tile[kLanes][kRows + 1];
  const int u0 = blockIdx.x * kLanes, row0 = blockIdx.y * kRows;
  const int tx = threadIdx.x, ty = threadIdx.y;
  for (int dx = tx; dx < kRows; dx += kLanes) {
    const int row = row0 + dx;
    if (row >= k) break;
    for (int du = ty; du < kLanes && u0 + du < nfix; du += kRowsA) {
      const int u = u0 + du;
      tile[du][dx] = dss_sweep::scale(value(slab, src[u], row, k), rsp, nrsp,
                                      e16, fix_lanes[u]);
    }
  }
  __syncthreads();
  const int u = u0 + tx;
  if (u < nfix)
    for (int dr = ty; dr < kRows && row0 + dr < k; dr += kRowsA)
      vd[static_cast<size_t>(row0 + dr) * nfix + u] = tile[tx][dr];
}

}  // namespace

extern "C" int fixup_variant_launch(int variant, const void* slab,
                                    const void* src, const void* fix_lanes,
                                    const void* rsp, int nrsp, int e16,
                                    void* vd, int nfix, int k, void* stream) {
  const auto* a = static_cast<const float*>(slab);
  const auto* b = static_cast<const int4*>(src);
  const auto* c = static_cast<const int*>(fix_lanes);
  const auto* d = static_cast<const float*>(rsp);
  auto* out = static_cast<float*>(vd);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 0 || variant == 1) {
    const size_t total = static_cast<size_t>(nfix) * k;
    const unsigned grid =
        static_cast<unsigned>((total + kThreads - 1) / kThreads);
    auto* kernel = variant ? fixup_flat<true> : fixup_flat<false>;
    kernel<<<grid, kThreads, 0, st>>>(a, b, c, d, nrsp, e16, out, nfix, k);
  } else if (variant == 2 || variant == 3) {
    const int rows = variant == 2 ? 32 : 64;
    const dim3 grid((nfix + kLanes - 1) / kLanes, (k + rows - 1) / rows);
    const dim3 block(kLanes, kRowsA);
    auto* kernel = variant == 2 ? fixup_tiled<32> : fixup_tiled<64>;
    kernel<<<grid, block, 0, st>>>(a, b, c, d, nrsp, e16, out, nfix, k);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
