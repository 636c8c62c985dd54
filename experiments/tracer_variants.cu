// Variants of the tracer stages (tinman_sandbox_tpu_torch/csrc/tracer.cu:
// the Euler stage with spheremp folded in, and the limited stage with and
// without the Shu-Osher mix) for experiments/kernel_variants.py. The port's
// own design (the quad layout) is timed from tracer.cu itself; these are the
// designs it was chosen against. The half-warp variants write no fix-lane
// slab; "element" writes it as the port does, when given one. Each is
// checked against tracer_euler_plain / tracer_limit_plain at the 5e-5 gate.
//
//   0 "half": the design before the quad layout, one lane a thread, the 16
//     lanes of an element in a half-warp, the derivative rows exchanged
//     through shared memory behind a __syncwarp, every group reduction a
//     width-16 butterfly of 4 shuffles (32 a row in the limited stage);
//   1 "half_ahead" (P): the same body with rows in flight: each thread
//     loads the q, mx and winds of the next kAhead = 2 (level, tracer) rows
//     into a register ring before it runs the current row (bytes in flight
//     at fixed warps: hypothesis H2);
//   2 "half_once" (L): the same body with the limiter's uniform work
//     merged: the minimum and maximum in one transposed butterfly (lanes
//     0-7 of the half keep the minimum, 8-15 the maximum, 5 shuffles for
//     both), the mass and the first deficit likewise (26 shuffles a row in
//     place of 32; hypothesis H1, the limiter's instruction chain). The
//     divisions stay per lane: in SIMT a division that one lane of a warp
//     runs costs the warp the same instruction slots as one that all lanes
//     run;
//   3 "element" (E): a thread owns an element, its 16 lanes in registers
//     (4 float4 loads a row), the reductions register trees with no
//     shuffle, D_x and D_y in registers; a block is 32 elements x 4 level
//     slots (slot s the levels s and s + 4 of the block's 8, so a slab
//     sector is one block's) with the block's metric rows and fix ranks in
//     shared memory, read once for every level and tracer;
//   4 "element_3": the same, its registers capped for 3 blocks an SM.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr int kLevels = 8;          // levels a block walks (half, element)
constexpr int kAhead = 2;           // rows in flight of "half_ahead"
constexpr unsigned kFull = 0xffffffffu;

enum Meta {
  kDinv00 = 0, kDinv01, kDinv10, kDinv11, kMetdet = 8, kRmetdet = 9,
  kSpheremp = 11
};

struct Args {
  const float* __restrict__ meta;
  const float* __restrict__ dvv;
  const float* __restrict__ vu;
  const float* __restrict__ vv;
  const float* __restrict__ q;
  const float* __restrict__ mx;
  float* __restrict__ out;
  const int* __restrict__ fix_rank;   // null: no slab
  float* __restrict__ slab;
  int nlev, nq, ncol, iters;
  float dt, ca, cb, rr;
};

// ---------------------------------------------------------------- half-warp

__device__ __forceinline__ float dx(const float* dvv, const float* s, int li,
                                    int lj) {
  float acc = dvv[0 * 4 + li] * s[0 * 4 + lj];
  acc = fmaf(dvv[1 * 4 + li], s[1 * 4 + lj], acc);
  acc = fmaf(dvv[2 * 4 + li], s[2 * 4 + lj], acc);
  return fmaf(dvv[3 * 4 + li], s[3 * 4 + lj], acc);
}

__device__ __forceinline__ float dy(const float* dvv, const float* s, int li,
                                    int lj) {
  float acc = dvv[0 * 4 + lj] * s[li * 4 + 0];
  acc = fmaf(dvv[1 * 4 + lj], s[li * 4 + 1], acc);
  acc = fmaf(dvv[2 * 4 + lj], s[li * 4 + 2], acc);
  return fmaf(dvv[3 * 4 + lj], s[li * 4 + 3], acc);
}

__device__ __forceinline__ float gsum(float v) {
  v += __shfl_xor_sync(kFull, v, 8, 16);
  v += __shfl_xor_sync(kFull, v, 4, 16);
  v += __shfl_xor_sync(kFull, v, 2, 16);
  return v + __shfl_xor_sync(kFull, v, 1, 16);
}

__device__ __forceinline__ float gmin(float v) {
  v = fminf(v, __shfl_xor_sync(kFull, v, 8, 16));
  v = fminf(v, __shfl_xor_sync(kFull, v, 4, 16));
  v = fminf(v, __shfl_xor_sync(kFull, v, 2, 16));
  return fminf(v, __shfl_xor_sync(kFull, v, 1, 16));
}

__device__ __forceinline__ float gmax(float v) {
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 8, 16));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 4, 16));
  v = fmaxf(v, __shfl_xor_sync(kFull, v, 2, 16));
  return fmaxf(v, __shfl_xor_sync(kFull, v, 1, 16));
}

// the minimum and maximum over the half-warp in one transposed butterfly:
// lanes 0-7 of the half reduce the minimum, 8-15 the maximum
__device__ __forceinline__ void gminmax(float v, float& lo, float& hi) {
  const bool low = (threadIdx.x & 8) == 0;
  float x = v;
#pragma unroll
  for (int s = 8; s >= 1; s >>= 1) {
    const float o = __shfl_xor_sync(kFull, x, s, 16);
    x = low ? fminf(x, o) : fmaxf(x, o);
  }
  const float other = __shfl_xor_sync(kFull, x, 8, 16);
  lo = low ? x : other;
  hi = low ? other : x;
}

// two sums over the half-warp in one transposed butterfly, each with the
// bits of gsum: lanes 0-7 reduce a, 8-15 reduce b
__device__ __forceinline__ void gsum2(float a, float b, float& sa,
                                      float& sb) {
  const bool low = (threadIdx.x & 8) == 0;
  float x = (low ? a : b) + __shfl_xor_sync(kFull, low ? b : a, 8, 16);
  x += __shfl_xor_sync(kFull, x, 4, 16);
  x += __shfl_xor_sync(kFull, x, 2, 16);
  x += __shfl_xor_sync(kFull, x, 1, 16);
  const float other = __shfl_xor_sync(kFull, x, 8, 16);
  sa = low ? x : other;
  sb = low ? other : x;
}

template <bool kLimit, bool kMix, int kAheadRows, bool kOnce>
__global__ void __launch_bounds__(kBlock) half_kernel(Args a) {
  __shared__ float xs[2][2][kBlock];
  __shared__ float dvv[16];
  const size_t ld = static_cast<size_t>(a.ncol);
  const int tid = threadIdx.x;
  const int col = blockIdx.x * kBlock + tid;
  const bool live = col < a.ncol;
  const int eb = tid & ~15, li = (tid & 15) >> 2, lj = tid & 3;
  if (tid < 16) dvv[tid] = a.dvv[tid];
  auto m = [&](int r) { return live ? a.meta[r * ld + col] : 1.f; };
  const float d00 = m(kDinv00), d01 = m(kDinv01), d10 = m(kDinv10),
              d11 = m(kDinv11), md = m(kMetdet), rmr = m(kRmetdet) * a.rr,
              w = m(kSpheremp);
  const float wsum = gsum(w);
  __syncthreads();
  const int k0 = blockIdx.y * kLevels;
  const int nrow = (min(k0 + kLevels, a.nlev) - k0) * a.nq;
  // the ring of rows in flight: q, mx and the winds of row r
  float qb[kAheadRows + 1], mb[kAheadRows + 1], ub[kAheadRows + 1],
      vb[kAheadRows + 1];
  auto load = [&](int r, float& qd, float& md_, float& ud, float& vd) {
    qd = md_ = ud = vd = 0.f;
    if (r < nrow && live) {
      const int k = k0 + r / a.nq, n = r % a.nq;
      const size_t o = (static_cast<size_t>(n) * a.nlev + k) * ld + col;
      qd = a.q[o];
      if (kMix) md_ = a.mx[o];
      ud = a.vu[k * ld + col];
      vd = a.vv[k * ld + col];
    }
  };
#pragma unroll
  for (int i = 0; i < kAheadRows; ++i) load(i, qb[i], mb[i], ub[i], vb[i]);
  for (int r = 0; r < nrow; ++r) {
    load(r + kAheadRows, qb[kAheadRows], mb[kAheadRows], ub[kAheadRows],
         vb[kAheadRows]);
    const float qv = qb[0], mv = mb[0], u = ub[0], v = vb[0];
#pragma unroll
    for (int i = 0; i < kAheadRows; ++i) {
      qb[i] = qb[i + 1]; mb[i] = mb[i + 1]; ub[i] = ub[i + 1];
      vb[i] = vb[i + 1];
    }
    float (*x)[kBlock] = xs[r & 1];
    const float vq1 = u * qv, vq2 = v * qv;
    x[0][tid] = md * fmaf(d00, vq1, d01 * vq2);
    x[1][tid] = md * fmaf(d10, vq1, d11 * vq2);
    __syncwarp();
    float y = fmaf(-a.dt, (dx(dvv, x[0] + eb, li, lj) +
                           dy(dvv, x[1] + eb, li, lj)) * rmr, qv);
    if (kMix) y = fmaf(a.ca, mv, a.cb * y);
    if (kLimit) {
      float lo, hi, mass = 0.f, d;
      float carry = 0.f;
      if (kOnce) {
        gminmax(qv, lo, hi);
      } else {
        lo = gmin(qv);
        hi = gmax(qv);
      }
      for (int i = 0; i < a.iters; ++i) {
        const float yc = fminf(fmaxf(y, lo), hi);
        if (i == 0) {
          if (kOnce) {
            gsum2(w * y, w * (y - yc), mass, d);
          } else {
            mass = gsum(w * y);
            d = gsum(w * (y - yc));
          }
        } else {
          d = gsum(w * (y - yc));
        }
        d += carry;
        const bool pos = d > 0.f;
        const float bsel = pos ? hi : lo;
        const float tot = gsum(w * (pos ? hi - yc : yc - lo));
        const float give = pos ? fminf(d, tot) : fmaxf(d, -tot);
        carry = d - give;
        const float c = __fdiv_rn(give, fmaxf(tot, FLT_MIN));
        y = fmaf(fabsf(c), bsel - yc, yc);
      }
      y += __fdiv_rn(mass - gsum(w * y), wsum);
    }
    if (live) {
      const int k = k0 + r / a.nq, n = r % a.nq;
      a.out[(static_cast<size_t>(n) * a.nlev + k) * ld + col] = w * y;
    }
  }
}

// ----------------------------------------------------------- element a thread

__device__ __forceinline__ void ld16(const float* __restrict__ p, size_t o,
                                     float* r) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 f = *reinterpret_cast<const float4*>(p + o + 4 * j);
    r[4 * j] = f.x; r[4 * j + 1] = f.y; r[4 * j + 2] = f.z;
    r[4 * j + 3] = f.w;
  }
}

__device__ __forceinline__ float tree16(const float* a) {
  float s[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = a[2 * i] + a[2 * i + 1];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = s[2 * i] + s[2 * i + 1];
  return (s[0] + s[1]) + (s[2] + s[3]);
}

constexpr int kMetaRows = 7;     // dinv00, 01, 10, 11, metdet, rmr, sph

template <bool kLimit, bool kMix, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks) element_kernel(Args a) {
  __shared__ float4 mt[kMetaRows][kBlock];   // the block's 512 lanes
  __shared__ int rk[4 * kBlock];             // their fix ranks, -1: none
  __shared__ float dvv[16];
  const size_t ld = static_cast<size_t>(a.ncol);
  const int tid = threadIdx.x;
  const int base = blockIdx.x * 4 * kBlock;
  const int rows[kMetaRows] = {kDinv00, kDinv01, kDinv10, kDinv11, kMetdet,
                               kRmetdet, kSpheremp};
  if (tid < 16) dvv[tid] = a.dvv[tid];
#pragma unroll
  for (int r = 0; r < kMetaRows; ++r) {
    const int col = base + 4 * tid;
    float4 f = make_float4(1.f, 1.f, 1.f, 1.f);
    if (col < a.ncol)
      f = *reinterpret_cast<const float4*>(a.meta + rows[r] * ld + col);
    if (r == 5) { f.x *= a.rr; f.y *= a.rr; f.z *= a.rr; f.w *= a.rr; }
    mt[r][tid] = f;
  }
  for (int i = tid; i < 4 * kBlock; i += kBlock)
    rk[i] = (a.fix_rank && base + i < a.ncol) ? a.fix_rank[base + i] : -1;
  __syncthreads();
  const int el = tid & 31, slot = tid >> 5;
  const int col = base + 16 * el;
  if (col >= a.ncol) return;                 // no shuffles below
  unsigned fmask = 0;                        // the element's fix lanes
#pragma unroll
  for (int p = 0; p < 16; ++p)
    if (rk[16 * el + p] >= 0) fmask |= 1u << p;
  const size_t nrows = static_cast<size_t>(a.nq) * a.nlev;
  auto meta16 = [&](int r, float* out16) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 f = mt[r][4 * el + j];
      out16[4 * j] = f.x; out16[4 * j + 1] = f.y; out16[4 * j + 2] = f.z;
      out16[4 * j + 3] = f.w;
    }
  };
  const int k0 = blockIdx.y * kLevels;
  const int k1 = min(k0 + kLevels, a.nlev);
  for (int k = k0 + slot; k < k1; k += 4) {
    float c1[16], c2[16];
    {
      float u[16], v[16], t0[16], t1[16], m[16];
      ld16(a.vu, k * ld + col, u);
      ld16(a.vv, k * ld + col, v);
      meta16(4, m);
      meta16(0, t0);
      meta16(1, t1);
#pragma unroll
      for (int p = 0; p < 16; ++p)
        c1[p] = m[p] * fmaf(t0[p], u[p], t1[p] * v[p]);
      meta16(2, t0);
      meta16(3, t1);
#pragma unroll
      for (int p = 0; p < 16; ++p)
        c2[p] = m[p] * fmaf(t0[p], u[p], t1[p] * v[p]);
    }
    for (int n = 0; n < a.nq; ++n) {
      const size_t o = (static_cast<size_t>(n) * a.nlev + k) * ld + col;
      float qv[16], y[16];
      ld16(a.q, o, qv);
      {
        float g1[16], g2[16], rmr[16];
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          g1[p] = c1[p] * qv[p];
          g2[p] = c2[p] * qv[p];
        }
        meta16(5, rmr);
#pragma unroll
        for (int p = 0; p < 16; ++p)
          y[p] = fmaf(-a.dt, (dx(dvv, g1, p >> 2, p & 3) +
                              dy(dvv, g2, p >> 2, p & 3)) * rmr[p], qv[p]);
      }
      if (kMix) {
        float mv[16];
        ld16(a.mx, o, mv);
#pragma unroll
        for (int p = 0; p < 16; ++p) y[p] = fmaf(a.ca, mv[p], a.cb * y[p]);
      }
      float w[16];
      meta16(6, w);
      if (kLimit) {
        float lo = qv[0], hi = qv[0], t[16];
#pragma unroll
        for (int p = 1; p < 16; ++p) {
          lo = fminf(lo, qv[p]);
          hi = fmaxf(hi, qv[p]);
        }
#pragma unroll
        for (int p = 0; p < 16; ++p) t[p] = w[p] * y[p];
        const float mass = tree16(t);
        float carry = 0.f;
        for (int i = 0; i < a.iters; ++i) {
          float yc[16];
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            yc[p] = fminf(fmaxf(y[p], lo), hi);
            t[p] = w[p] * (y[p] - yc[p]);
          }
          const float d = tree16(t) + carry;
          const bool pos = d > 0.f;
          const float bsel = pos ? hi : lo;
#pragma unroll
          for (int p = 0; p < 16; ++p)
            t[p] = w[p] * (pos ? hi - yc[p] : yc[p] - lo);
          const float tot = tree16(t);
          const float give = pos ? fminf(d, tot) : fmaxf(d, -tot);
          carry = d - give;
          const float c = fabsf(__fdiv_rn(give, fmaxf(tot, FLT_MIN)));
#pragma unroll
          for (int p = 0; p < 16; ++p) y[p] = fmaf(c, bsel - yc[p], yc[p]);
        }
#pragma unroll
        for (int p = 0; p < 16; ++p) t[p] = w[p] * y[p];
        const float r = __fdiv_rn(mass - tree16(t), tree16(w));
#pragma unroll
        for (int p = 0; p < 16; ++p) y[p] += r;
      }
#pragma unroll
      for (int p = 0; p < 16; ++p) y[p] *= w[p];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(a.out + o + 4 * j) = make_float4(
            y[4 * j], y[4 * j + 1], y[4 * j + 2], y[4 * j + 3]);
      if (fmask) {
        const size_t row = static_cast<size_t>(n) * a.nlev + k;
#pragma unroll
        for (int p = 0; p < 16; ++p)
          if (fmask >> p & 1u) a.slab[rk[16 * el + p] * nrows + row] = y[p];
      }
    }
  }
}

using Kernel = void (*)(Args);

// the instance of variant v for (limit, mix); null: none
Kernel pick(int variant, int limit, int mix) {
  const int key = limit * 2 + mix;      // 0 Euler, 2 limited, 3 with mix
  switch (variant * 4 + key) {
    case 0: return half_kernel<false, false, 0, false>;
    case 2: return half_kernel<true, false, 0, false>;
    case 3: return half_kernel<true, true, 0, false>;
    case 4: return half_kernel<false, false, kAhead, false>;
    case 6: return half_kernel<true, false, kAhead, false>;
    case 7: return half_kernel<true, true, kAhead, false>;
    case 10: return half_kernel<true, false, 0, true>;
    case 11: return half_kernel<true, true, 0, true>;
    case 12: return element_kernel<false, false, 1>;
    case 14: return element_kernel<true, false, 1>;
    case 15: return element_kernel<true, true, 1>;
    case 16: return element_kernel<false, false, 3>;
    case 18: return element_kernel<true, false, 3>;
    case 19: return element_kernel<true, true, 3>;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// One launch of variant `variant` (0 half, 1 half_ahead, 2 half_once, 3
// element, 4 element_3) on `stream`: the Euler stage with spheremp folded
// in (limit 0) or the limited stage (limit 1; mx null: no mix). Fields
// [nq*nlev, ncol] of leading dimension ncol; the winds are the nlev rows
// of vu from row wu*nlev and of vv from row wv*nlev; fix_rank and slab
// (the elements only) may be null. Returns the cudaError_t of the launch
// (invalid value: no such variant).
int tracer_variant_launch(int variant, int limit, const void* meta,
                          const void* dvv, const void* vu, const void* vv,
                          const void* q, const void* mx, void* out,
                          const void* fix_rank, void* slab, int nlev,
                          int nq, int ncol, int wu, int wv, int iters,
                          float dt, float ca, float cb, float rrearth,
                          void* stream) {
  const Kernel kernel = pick(variant, limit, mx != nullptr);
  if (kernel == nullptr || ncol % 16) return cudaErrorInvalidValue;
  const size_t blk = static_cast<size_t>(nlev) * ncol;
  Args a;
  a.meta = static_cast<const float*>(meta);
  a.dvv = static_cast<const float*>(dvv);
  a.vu = static_cast<const float*>(vu) + wu * blk;
  a.vv = static_cast<const float*>(vv) + wv * blk;
  a.q = static_cast<const float*>(q);
  a.mx = static_cast<const float*>(mx);
  a.out = static_cast<float*>(out);
  a.fix_rank = static_cast<const int*>(fix_rank);
  a.slab = static_cast<float*>(slab);
  a.nlev = nlev;
  a.nq = nq;
  a.ncol = ncol;
  a.iters = iters;
  a.dt = dt;
  a.ca = ca;
  a.cb = cb;
  a.rr = rrearth;
  const int lanes = variant >= 3 ? 4 * kBlock : kBlock;
  const dim3 grid((ncol + lanes - 1) / lanes, (nlev + kLevels - 1) / kLevels);
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

// Blocks of the instance that one SM holds (cudaOccupancy); negative: error.
int tracer_variant_blocks_per_sm(int variant, int limit, int mix) {
  const Kernel kernel = pick(variant, limit, mix);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kBlock, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
