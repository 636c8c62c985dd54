// The in-face alpha / beta sweep of the structured DSS at one lane of one
// row, and its affine mix epilogue: the one expression sequence that the
// sweep kernel (dss.cu) and the ring-fused producers (caar.cu, tracer.cu)
// share, so that their outputs agree bit for bit.
//
// Lane = ((face*ne + ej)*ne + ei)*16 + i*4 + j:
//   y(l) = x(l) + x(l+4)   if i == 3 and ei < ne-1   (alpha sweep)
//        = x(l) + x(l-4)   if i == 0 and ei > 0
//   z(l) = y(l) + y(l+db)  if j == 3 and ej < ne-1   (beta sweep,
//        = y(l) + y(l-db)  if j == 0 and ej > 0       db = 16*ne - 3)
//   w(l) = z*hi + z*lo (two-float rspheremp) or z*rsp
// Every add and product is rounded on its own (__fadd_rn / __fmul_rn, no FMA
// contraction), in the order of the JAX package. A lane reads the row at most
// db + 4 = 16*ne + 1 lanes away.
//
// `load(l)` returns the row's value at lane l: a plain load in the sweep
// kernel, an L2 load (__ldcg) of another block's output in the ring kernels.
#pragma once

#include <cuda_runtime.h>

namespace dss_sweep {

// x(l) plus its alpha partner, where there is one (y of the header)
template <class Load>
__device__ __forceinline__ float alpha_sum(const Load& load, int l, int ne) {
  const int i = (l >> 2) & 3, ei = (l >> 4) % ne;
  float v = load(l);
  if (i == 3 && ei < ne - 1) v = __fadd_rn(v, load(l + 4));
  else if (i == 0 && ei > 0) v = __fadd_rn(v, load(l - 4));
  return v;
}

// v * rspheremp at lane l: nrsp = 2 rows (hi, lo) or 1
__device__ __forceinline__ float scale(float v, const float* __restrict__ rsp,
                                       int nrsp, int e16, int l) {
  if (nrsp == 2)
    return __fadd_rn(__fmul_rn(v, rsp[l]), __fmul_rn(v, rsp[e16 + l]));
  return __fmul_rn(v, rsp[l]);
}

// w(l): the scaled alpha-then-beta sum at lane l, fix lanes included (there
// it is the in-face partial sum that the fixup value replaces)
template <class Load>
__device__ __forceinline__ float swept(const Load& load, int l, int ne,
                                       const float* __restrict__ rsp,
                                       int nrsp, int e16) {
  const int j = l & 3, ej = (l / (16 * ne)) % ne, db = 16 * ne - 3;
  float z = alpha_sum(load, l, ne);
  if (j == 3 && ej < ne - 1) z = __fadd_rn(z, alpha_sum(load, l + db, ne));
  else if (j == 0 && ej > 0) z = __fadd_rn(z, alpha_sum(load, l - db, ne));
  return scale(z, rsp, nrsp, e16, l);
}

// the affine epilogue ca*mx + cb*w: two rounded products, then their sum
__device__ __forceinline__ float mix(float ca, float mx, float cb, float w) {
  return __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, w));
}

}  // namespace dss_sweep
