// The in-face alpha / beta sweep of the structured DSS at one lane of one
// row, and its affine mix epilogue: the one expression sequence that the
// sweep kernels (dss.cu) and the ring-fused producers (caar.cu, tracer.cu)
// share, so that their outputs agree bit for bit. swept() takes one lane,
// swept4() an aligned group of four lanes from values already loaded (the
// sweep kernel's form); both add the same terms in the same order.
//
// Lane = ((face*ne + ej)*ne + ei)*16 + i*4 + j:
//   y(l) = x(l) + x(l+4)   if i == 3 and ei < ne-1   (alpha sweep)
//        = x(l) + x(l-4)   if i == 0 and ei > 0
//   z(l) = y(l) + y(l+db)  if j == 3 and ej < ne-1   (beta sweep,
//        = y(l) + y(l-db)  if j == 0 and ej > 0       db = 16*ne - 3)
//   w(l) = fmaf(z, hi, z*lo) (two-float rspheremp) or z*rsp
// Every other add and product is rounded on its own (__fadd_rn / __fmul_rn,
// no FMA contraction), in the order of the JAX package. A lane reads the row
// at most db + 4 = 16*ne + 1 lanes away.
//
// `load(l)` returns the row's value at lane l: a plain load in the sweep
// kernels, an L2 load (__ldcg) of another block's output in the ring kernels.
// swept4_banded() is swept4() on a group of one band chunk of the banded
// DSS, where the group's neighbouring element rows may be halo rows.
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

// v * rspheremp, given the lane's rspheremp rows: v*(hi + lo) with two
// rows (nrsp = 2) as v*lo, then v*hi plus that rounded once (a rounded
// v*hi would drop lo, ~1e-8 of hi, below half an ulp nearly everywhere,
// and with it the fix of fl(rspheremp)'s per-dof bias), else v*hi
__device__ __forceinline__ float scale_by(float v, float hi, float lo,
                                          int nrsp) {
  if (nrsp == 2) return __fmaf_rn(v, hi, __fmul_rn(v, lo));
  return __fmul_rn(v, hi);
}

// v * rspheremp at lane l: nrsp = 2 rows (hi, lo) or 1
__device__ __forceinline__ float scale(float v, const float* __restrict__ rsp,
                                       int nrsp, int e16, int l) {
  return scale_by(v, rsp[l], nrsp == 2 ? rsp[e16 + l] : 0.f, nrsp);
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

// w at the four lanes l0 .. l0+3 of one aligned group (l0 % 4 == 0: j = 0..3
// of one i-row of an element), the sums of swept() at each lane in the same
// order, from values the caller has loaded: c = x(l0 .. l0+3); a = the
// alpha partners x(l0+da .. l0+da+3) where `alpha` (da = +-4: every lane of
// a group shares i and ei, so they share the partner offset); bu, bua =
// x(l0 + 16*ne) and its alpha partner, the beta partner of j = 3, where
// `up` (ej < ne-1); bd, bda = x(l0 + 3 - 16*ne) and its alpha partner, the
// beta partner of j = 0, where `dn` (ej > 0); hi, lo = the group's
// rspheremp rows.
__device__ __forceinline__ float4 swept4(float4 c, float4 a, bool alpha,
                                         float bu, float bua, bool up,
                                         float bd, float bda, bool dn,
                                         float4 hi, float4 lo, int nrsp) {
  if (alpha) {
    c.x = __fadd_rn(c.x, a.x);
    c.y = __fadd_rn(c.y, a.y);
    c.z = __fadd_rn(c.z, a.z);
    c.w = __fadd_rn(c.w, a.w);
    bu = __fadd_rn(bu, bua);
    bd = __fadd_rn(bd, bda);
  }
  if (dn) c.x = __fadd_rn(c.x, bd);
  if (up) c.w = __fadd_rn(c.w, bu);
  return make_float4(scale_by(c.x, hi.x, lo.x, nrsp),
                     scale_by(c.y, hi.y, lo.y, nrsp),
                     scale_by(c.z, hi.z, lo.z, nrsp),
                     scale_by(c.w, hi.w, lo.w, nrsp));
}

// w at the four lanes L0 .. L0+3 of one aligned group of one band chunk of
// the banded (multi-device) DSS (L0 % 4 == 0, L0 < bl), the sums of
// swept4() in the same order. The chunk is laid out [band | next row | prev
// row], each row rl = 16*ne lanes, the band bl = br*rl lanes (br element
// rows); bl is a multiple of 16, so a group never straddles a chunk. The
// alpha partners lie in the group's own element row (in a halo row too);
// the beta partner of the j == 3 lane is rl lanes on (db = rl - 3 from lane
// L0 + 3), which for the band's last row is the next-row halo; the partner
// of the j == 0 lane is db lanes back, taken cyclically inside the chunk,
// which for the band's first row is the prev-row halo (L0 + 3 - rl + ext).
// `first` / `last`: the band is the first / last of its face, so its first
// row has no partner below / its last row none above. A halo partner shares
// the group's i and ei (rl and ext are multiples of 16*ne), so it shares
// its alpha offset. load4(L) returns the chunk's float4 at lane L (L % 4 ==
// 0), load(L) its float; every load is issued before the sums.
template <class Load4, class Load>
__device__ __forceinline__ float4 swept4_banded(const Load4& load4,
                                                const Load& load, int L0,
                                                int ne, int bl, bool first,
                                                bool last, float4 hi,
                                                float4 lo, int nrsp) {
  const int rl = 16 * ne, i = (L0 >> 2) & 3, ei = (L0 >> 4) % ne;
  const int da = (i == 3 && ei < ne - 1) ? 4 : (i == 0 && ei > 0) ? -4 : 0;
  const bool alpha = da != 0;
  const bool up = !(last && L0 >= bl - rl), dn = !(first && L0 < rl);
  const int pu = L0 + rl;
  const int pd = L0 + 3 - rl + (L0 < rl ? bl + 2 * rl : 0);
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 c = load4(L0);
  const float4 a = alpha ? load4(L0 + da) : zero4;
  float bu = 0.f, bua = 0.f, bd = 0.f, bda = 0.f;
  if (up) {
    bu = load(pu);
    if (alpha) bua = load(pu + da);
  }
  if (dn) {
    bd = load(pd);
    if (alpha) bda = load(pd + da);
  }
  return swept4(c, a, alpha, bu, bua, up, bd, bda, dn, hi, lo, nrsp);
}

// the affine epilogue ca*mx + cb*w: two rounded products, then their sum
__device__ __forceinline__ float mix(float ca, float mx, float cb, float w) {
  return __fadd_rn(__fmul_rn(ca, mx), __fmul_rn(cb, w));
}

}  // namespace dss_sweep
