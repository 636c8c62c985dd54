// Variants of the structured DSS sweep (tinman_sandbox_tpu_torch/csrc/dss.cu,
// dss_sweep_kernel, merged form, with or without mix), for
// experiments/kernel_variants.py. A thread owns an aligned group of 4 lanes
// in kRows rows. Its tables (rspheremp, fix_col) and its partner offsets
// (two divisions by ne) are read and decoded once for all its rows, or with
// kReread once for each row, as a thread of the one-row kernel does. Every
// variant is capped at 80 registers (__launch_bounds__(256, 3)) and launched
// with the same dynamic shared memory, which pins the blocks an SM (and so
// the warps an SM) whatever its registers; the shared memory is not used.
// The sums are dss_sweep::swept4, so every variant equals the plain sweep
// bit for bit.
#include <cuda_runtime.h>

#include "dss_sweep.cuh"

namespace {

constexpr int kThreads = 256;

struct Group {
  int rl, da;
  bool alpha, up, dn;
  float4 hi, lo;
  int4 fc;
};

__device__ __forceinline__ Group decode(const float* __restrict__ rsp,
                                        int nrsp,
                                        const int* __restrict__ fix_col,
                                        int e16, int ne, int l0) {
  Group q;
  const int g = l0 >> 2, e = g >> 2, i = g & 3, ei = e % ne,
            ej = (e / ne) % ne;
  q.rl = 16 * ne;
  q.da = (i == 3 && ei < ne - 1) ? 4 : (i == 0 && ei > 0) ? -4 : 0;
  q.alpha = q.da != 0;
  q.up = ej < ne - 1;
  q.dn = ej > 0;
  q.hi = *reinterpret_cast<const float4*>(rsp + l0);
  q.lo = nrsp == 2 ? *reinterpret_cast<const float4*>(rsp + e16 + l0)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  q.fc = *reinterpret_cast<const int4*>(fix_col + l0);
  return q;
}

// rows r0 .. r0 + kRows - 1, r0 = blockIdx.y * kRows. `zero` is 0 at run
// time: with kReread, row r decodes at ne + zero*r and reads its tables at
// an offset zero*r, which the compiler cannot share between rows.
template <int kRows, bool kReread, bool kMix>
__global__ void __launch_bounds__(kThreads, 3)
sweep_variant(const float* __restrict__ x, const float* __restrict__ rsp,
              int nrsp, const float* __restrict__ vd, int nfix,
              const int* __restrict__ fix_col, const float* mx, float ca,
              float cb, float* out, int k, int e16, int ne, int zero) {
  const int l0 = 4 * (blockIdx.x * kThreads + threadIdx.x);
  if (l0 >= e16) return;
  const int r0 = blockIdx.y * kRows, nr = min(kRows, k - r0);
  constexpr int kGroups = kReread ? kRows : 1;
  Group q[kGroups];
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 c[kRows], a[kRows], m[kRows];
  float bu[kRows], bua[kRows], bd[kRows], bda[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    c[r] = a[r] = m[r] = zero4;
    bu[r] = bua[r] = bd[r] = bda[r] = 0.f;
    if (r < nr) {
      if (r < kGroups)
        q[r] = decode(rsp + zero * r, nrsp, fix_col + zero * r, e16,
                      ne + zero * r, l0);
      const Group& g = q[kReread ? r : 0];
      const size_t o = static_cast<size_t>(r0 + r) * e16 + l0;
      const float* xr = x + o;
      c[r] = *reinterpret_cast<const float4*>(xr);
      if (g.alpha) a[r] = *reinterpret_cast<const float4*>(xr + g.da);
      if (g.up) {
        bu[r] = xr[g.rl];
        if (g.alpha) bua[r] = xr[g.rl + g.da];
      }
      if (g.dn) {
        bd[r] = xr[3 - g.rl];
        if (g.alpha) bda[r] = xr[3 - g.rl + g.da];
      }
      if constexpr (kMix) m[r] = *reinterpret_cast<const float4*>(mx + o);
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < nr) {
      const Group& g = q[kReread ? r : 0];
      const size_t row = static_cast<size_t>(r0 + r);
      float4 w = dss_sweep::swept4(c[r], a[r], g.alpha, bu[r], bua[r], g.up,
                                   bd[r], bda[r], g.dn, g.hi, g.lo, nrsp);
      const float* vr = vd + row * nfix;
      if (g.fc.x >= 0) w.x = vr[g.fc.x];
      if (g.fc.y >= 0) w.y = vr[g.fc.y];
      if (g.fc.z >= 0) w.z = vr[g.fc.z];
      if (g.fc.w >= 0) w.w = vr[g.fc.w];
      if constexpr (kMix) {
        w.x = dss_sweep::mix(ca, m[r].x, cb, w.x);
        w.y = dss_sweep::mix(ca, m[r].y, cb, w.y);
        w.z = dss_sweep::mix(ca, m[r].z, cb, w.z);
        w.w = dss_sweep::mix(ca, m[r].w, cb, w.w);
      }
      *reinterpret_cast<float4*>(out + row * e16 + l0) = w;
    }
  }
}

using Kernel = void (*)(const float*, const float*, int, const float*, int,
                        const int*, const float*, float, float, float*, int,
                        int, int, int);

template <int kRows, bool kReread>
Kernel pick_mix(bool mix) {
  return mix ? sweep_variant<kRows, kReread, true>
             : sweep_variant<kRows, kReread, false>;
}

Kernel pick(int rows, int reread, int mix) {
  switch (rows * 2 + (reread ? 1 : 0)) {
    case 2: return pick_mix<1, false>(mix);
    case 4: return pick_mix<2, false>(mix);
    case 5: return pick_mix<2, true>(mix);
    case 8: return pick_mix<4, false>(mix);
    case 9: return pick_mix<4, true>(mix);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// One launch of variant (rows a thread in {1, 2, 4}, reread) with `smem`
// bytes of dynamic shared memory; mx null = no mix. Returns the cudaError_t.
int sweep_variant_launch(int rows, int reread, const void* x, const void* rsp,
                         int nrsp, const void* vd, int nfix,
                         const void* fix_col, const void* mx, float ca,
                         float cb, void* out, int k, int e16, int ne,
                         int smem, void* stream) {
  Kernel kernel = pick(rows, reread, mx != nullptr);
  if (kernel == nullptr || e16 % 16 || k < 1) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((e16 / 4 + kThreads - 1) / kThreads,
                  (k + rows - 1) / rows);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rsp), nrsp,
      static_cast<const float*>(vd), nfix, static_cast<const int*>(fix_col),
      static_cast<const float*>(mx), ca, cb, static_cast<float*>(out), k,
      e16, ne, 0);
  return cudaGetLastError();
}

// Blocks of the variant an SM holds with `smem` bytes of dynamic shared
// memory (cudaOccupancy); negative: a CUDA error.
int sweep_variant_blocks_per_sm(int rows, int reread, int mix, int smem) {
  Kernel kernel = pick(rows, reread, mix);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads,
                                                        smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
