// The remap kernel as it stood before its redesign for the H100
// (tinman_sandbox_tpu_torch/csrc/remap.cu at commit ce16e8b: 32 columns and
// 8 warps a block, every field's passes redone, the geometry re-walked from
// the column's top by every warp, the two chains on warps 0 and 1), kept for
// experiments/kernel_variants.py, which times its passes apart. A build flag
// read only by that script picks what the launch does:
//   REMAP_VARIANT 0  the kernel, bit for bit the kernel of that commit;
//                 1  no field passes (S1): every field staged and waited
//                    for, no reconstruction, no target pass;
//                 2  the chains only (S3): dp staged, both chains, the dp
//                    rows stored;
//                 3  the chains and the geometry (S2), 8 warps re-walking;
//                 4  the chains and the geometry as one pass of warp 0;
//                 5  loads and stores only (S4): dp and every field staged
//                    as the kernel stages them and stored back unchanged.
#include <cuda_runtime.h>

namespace {

constexpr int kPcm = 0, kPlm = 1, kPpm = 2;
constexpr int kCols = 32;          // columns a block, one a lane
// warps a block: each takes every kWarps-th level or target cell (a build
// flag only for experiments/kernel_variants.py, which times other values)
#ifndef REMAP_WARPS
#define REMAP_WARPS 8
#endif
constexpr int kWarps = REMAP_WARPS;
#ifndef REMAP_VARIANT
#define REMAP_VARIANT 0
#endif
constexpr int kVariant = REMAP_VARIANT;
static_assert(kWarps >= 2, "warps 0 and 1 take the two chains");
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take

template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
               "l"(src), "n"(sizeof(T)));
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Issues the copies of rows [row0, row0 + k) of src (ncol columns), this
// thread's column, levels w, w + kWarps, ... into dst[l * kCols], as one
// group; a warp copies one level of its 32 columns at a time
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      size_t row0, int k, int ncol, int col,
                                      int w) {
  if (col < ncol)
    for (int l = w; l < k; l += kWarps)
      copy_async(dst + l * kCols, src + (row0 + l) * ncol + col);
  commit();
}

// Neumaier's compensated sum, ops/remap.py::comp_sum's order and rounding
template <typename T>
struct CompSum {
  T s = 0, c = 0;
  __device__ __forceinline__ void add(T v) {
    const T t = s + v;
    c = c + (fabs(s) >= fabs(v) ? (s - t) + v : (v - t) + s);
    s = t;
  }
  __device__ __forceinline__ T total() const { return s + c; }
};

template <typename T>
__device__ __forceinline__ T clip(T x, T hi) {
  return fmin(fmax(x, T(0)), hi);
}

// The scheme's coefficient arrays a field needs beside its means
__host__ __device__ constexpr int coefficients(int scheme) {
  return scheme == kPcm ? 0 : scheme == kPlm ? 1 : 2;
}

// One thread's column in shared memory, every array [level][kCols]: dp_src,
// the target interfaces' local coordinates a_j and cells c_j (j = 0..K),
// the field's means q and its coefficients (plm: the slope m; ppm: the
// monotone edges aL, aR)
template <typename T, int kScheme>
struct Column {
  T* dp;
  T* a;
  T* q;
  T* cf0;
  T* cf1;
  unsigned short* c;
  int k;

  __device__ __forceinline__ T at(const T* x, int l) const {
    return x[l * kCols];
  }

  // plm slopes / ppm edges of cells w, w + step, ..., the plain code's
  // array formulas
  __device__ __forceinline__ void reconstruct(int w, int step) const {
    if constexpr (kScheme == kPlm) {
      // g_l: the centred slope between cells l and l + 1 (0 past the ends)
      const auto g = [&](int l) -> T {
        return l >= 0 && l + 1 < k ? (at(q, l + 1) - at(q, l)) /
                                         (T(0.5) * (at(dp, l + 1) + at(dp, l)))
                                   : T(0);
      };
      for (int l = w; l < k; l += step) {
        const T g_lo = g(l - 1), g_hi = g(l);
        cf0[l * kCols] = g_lo * g_hi > T(0)
                             ? copysign(fmin(fabs(g_lo), fabs(g_hi)), g_lo)
                             : T(0);
      }
    } else if constexpr (kScheme == kPpm) {
      // edge i from q_{i-2}, q_{i-1}, q_i, q_{i+1}, indices clamped to the
      // column (the plain code's edge replication)
      const auto qc = [&](int l) {
        return at(q, l < 0 ? 0 : l >= k ? k - 1 : l);
      };
      const auto edge = [&](int i) {
        const T qm2 = qc(i - 2), qm1 = qc(i - 1), qp0 = qc(i), qp1 = qc(i + 1);
        const T e = T(7.0 / 12.0) * (qm1 + qp0) - T(1.0 / 12.0) * (qm2 + qp1);
        return fmin(fmax(e, fmin(qm1, qp0)), fmax(qm1, qp0));
      };
      for (int l = w; l < k; l += step) {
        const T ql = at(q, l);
        T a_l = edge(l), a_r = edge(l + 1);
        if ((a_r - ql) * (ql - a_l) <= T(0)) a_l = a_r = ql;
        const T d = a_r - a_l;
        const T dev = ql - T(0.5) * (a_l + a_r);
        if (d * dev > d * d / T(6)) a_l = T(3) * ql - T(2) * a_r;
        if (-(d * d) / T(6) > d * dev) a_r = T(3) * ql - T(2) * a_l;
        cf0[l * kCols] = a_l;
        cf1[l * kCols] = a_r;
      }
    }
  }

  // integral of cell l's reconstruction over [a, b] of [0, dp_l]
  __device__ __forceinline__ T piece(int l, T a, T b) const {
    const T ql = at(q, l);
    if constexpr (kScheme == kPcm) {
      return ql * (b - a);
    } else if constexpr (kScheme == kPlm) {
      // q + m (x - dp/2)
      return (b - a) *
             (ql + at(cf0, l) * (T(0.5) * (a + b) - T(0.5) * at(dp, l)));
    } else {
      // the parabola aL + xi (da + a6 (1 - xi)), xi = x / dp
      const T al = at(cf0, l), ar = at(cf1, l), dpl = at(dp, l);
      const T da = ar - al, a6 = T(6) * (ql - T(0.5) * (al + ar));
      const T xa = a / dpl, xb = b / dpl;
      return (b - a) * (al + (da + a6) * (T(0.5) * (xa + xb)) -
                        a6 * (xa * xa + xa * xb + xb * xb) / T(3));
    }
  }

  // The geometry pass, warp w's share: t_j = sum of tgt(i), i < j, in
  // double and in that order; c_j the first cell whose local coordinate
  // clip(t_j - s_c) is below dp_c (K past the column's end), a_j that
  // coordinate; t_K is the column's end. Warp w takes the interfaces of its
  // segment of 1 .. K-1: it sums t and merges from the column's top, which
  // gives the bits of one merge down the whole column, since a cell passed
  // at t stays passed at any later t.
  template <typename Tgt>
  __device__ __forceinline__ void geometry(Tgt tgt, int w,
                                           int nseg = kWarps) const {
    const int n = k - 1;
    const int j_lo = 1 + w * n / nseg, j_hi = 1 + (w + 1) * n / nseg;
    double s = 0, t = 0;
    int cell = 0;
    for (int i = 0; i + 1 < j_lo; ++i) t += tgt(i);
    if (w == 0) {
      c[0] = 0;
      a[0] = 0;
    }
    for (int j = j_lo; j < j_hi; ++j) {
      t += tgt(j - 1);
      T aj = 0;
      while (cell < k) {
        const T d = at(dp, cell);
        aj = static_cast<T>(clip(t - s, static_cast<double>(d)));
        if (aj < d) break;
        s += d;
        ++cell;
        aj = 0;
      }
      c[j * kCols] = static_cast<unsigned short>(cell);
      a[j * kCols] = aj;
    }
    if (w == nseg - 1) {
      c[k * kCols] = static_cast<unsigned short>(k);
      a[k * kCols] = 0;
    }
  }

  // The target pass of one field for target cells w, w + kWarps, ...:
  // out[j * ncol], target cell j's mass, or (kMean) its mass over tgt(j)
  template <bool kMean, typename Tgt>
  __device__ __forceinline__ void remap(Tgt tgt, T* __restrict__ out,
                                        int ncol, int w) const {
    for (int j = w; j < k; j += kWarps) {
      const int c0 = c[j * kCols], c1 = c[(j + 1) * kCols];
      const T a0 = at(a, j), a1 = at(a, j + 1);
      T acc = 0;
      if (c1 == c0) {
        if (c0 < k && a1 > a0) acc = piece(c0, a0, a1);
      } else {
        const T d0 = at(dp, c0);
        acc = a0 == T(0) ? at(q, c0) * d0 : piece(c0, a0, d0);
        for (int l = c0 + 1; l < c1; ++l) acc += at(q, l) * at(dp, l);
        if (c1 < k && a1 > T(0)) acc += piece(c1, T(0), a1);
      }
      out[static_cast<size_t>(j) * ncol] = kMean ? acc / tgt(j) : acc;
    }
  }
};

// Packed (kPacked): src = s [4K, ncol] (fields u, v, T, then dp_src) and
// qdp [nq*K, ncol]; out = s' [4K, ncol] and q' [nq*K, ncol]; hyai, hybi
// [K+1]. Level form: src = q [nq*K, ncol] (densities), dp_src and dp_tgt
// [K, ncol], out = q' [nq*K, ncol]; qdp, hyai, hybi, s_out unused.
template <typename T, int kScheme, bool kPacked>
__global__ void __launch_bounds__(kCols * kWarps)
remap_kernel(const T* __restrict__ src, const T* __restrict__ qdp,
             const T* __restrict__ dp_src, const T* __restrict__ dp_tgt,
             const T* __restrict__ hyai, const T* __restrict__ hybi, T ps0,
             T* __restrict__ s_out, T* __restrict__ q_out, int k, int nq,
             int ncol) {
  extern __shared__ double smem_raw[];
  __shared__ double col_ps[kCols], col_r[kCols];   // the double chain's ps, r
  const int x = threadIdx.x, w = threadIdx.y;
  const int col = blockIdx.x * kCols + x;
  const bool live = col < ncol;
  constexpr int kCoef = coefficients(kScheme);
  // the block's hybrid terms da_l = (hyai[l+1] - hyai[l])*ps0 and db_l =
  // hybi[l+1] - hybi[l] (packed form), then the columns' arrays
  T* da = reinterpret_cast<T*>(smem_raw);
  T* db = da + k;
  T* base = db + k + x;
  Column<T, kScheme> cl;
  cl.k = k;
  cl.dp = base;
  cl.a = cl.dp + k * kCols;
  cl.q = cl.a + (k + 1) * kCols;
  cl.cf0 = cl.q + k * kCols;
  cl.cf1 = cl.cf0 + (kCoef > 0 ? k * kCols : 0);
  // the cell indices after the T arrays, [level][kCols] of their own
  cl.c = reinterpret_cast<unsigned short*>(
             cl.cf1 + (kCoef > 1 ? k * kCols : 0) - x) +
         x;
  const int nfield = kPacked ? 3 + nq : nq;
  const size_t kc = static_cast<size_t>(k);
  // field f's first row, its source and its output
  const auto field_src = [&](int f) -> const T* {
    return kPacked && f >= 3 ? qdp + (f - 3) * kc * ncol
                             : src + f * kc * ncol;
  };
  const auto field_out = [&](int f) -> T* {
    return kPacked ? (f >= 3 ? q_out + (f - 3) * kc * ncol
                             : s_out + f * kc * ncol)
                   : q_out + f * kc * ncol;
  };

  if constexpr (kVariant == 5) {
    // loads and stores only: each thread stores back the rows it staged
    stage(cl.dp, kPacked ? src : dp_src, kPacked ? 3 * kc : 0, k, ncol, col,
          w);
    wait_copies<0>();
    if (kPacked && live)
      for (int l = w; l < k; l += kWarps)
        s_out[(3 * kc + l) * ncol + col] = cl.at(cl.dp, l);
    for (int f = 0; f < nfield; ++f) {
      __syncthreads();
      stage(cl.q, field_src(f), 0, k, ncol, col, w);
      wait_copies<0>();
      if (live)
        for (int l = w; l < k; l += kWarps)
          field_out(f)[static_cast<size_t>(l) * ncol + col] = cl.at(cl.q, l);
    }
    return;
  }
  // dp_src and field 0 in flight; the hybrid terms; then the column's sums
  // (warps 0 and 1) and its geometry (every warp)
  stage(cl.dp, kPacked ? src : dp_src, kPacked ? 3 * kc : 0, k, ncol, col, w);
  if (nfield > 0 && (kVariant < 2 || kVariant > 4))
    stage(cl.q, field_src(0), 0, k, ncol, col, w);
  if constexpr (kPacked)
    for (int l = w * kCols + x; l < k; l += kCols * kWarps) {
      da[l] = (hyai[l + 1] - hyai[l]) * ps0;
      db[l] = hybi[l + 1] - hybi[l];
    }
  wait_copies<0>();
  __syncthreads();

  // the packed form's target layers, twice: in T by the plain code's
  // operations (stored as the dp rows, bit for bit the plain code's), and
  // from the same rounded hybrid terms in double (the layers the fields
  // are remapped onto: the plain float64 code's dp_tgt bit for bit on
  // float32 inputs)
  const auto ref_d = [&](int l, double ps_d) -> double {
    return static_cast<double>(da[l]) + static_cast<double>(db[l]) * ps_d;
  };
  // the target thickness in double (the geometry) and rounded to T (the
  // means' divisor)
  const auto tgt_d = [&](int j) -> double {
    if constexpr (kPacked)
      return ref_d(j, col_ps[x]) * col_r[x];
    else
      return dp_tgt[static_cast<size_t>(j) * ncol + col];
  };
  const auto tgt = [&](int j) -> T { return static_cast<T>(tgt_d(j)); };
  if constexpr (kPacked) {
    const T ptop = hyai[0] * ps0;
    if (w == 0 && live) {
      // the float chain: the dp rows, the plain code's operations
      T ps = 0;
      const auto ref = [&](int l) -> T {   // reference_dp: da*ps0 + db*ps
        return da[l] + db[l] * ps;
      };
      CompSum<T> src_t, tgt_t;
      for (int l = 0; l < k; ++l) src_t.add(cl.at(cl.dp, l));
      ps = ptop + src_t.total();
      for (int l = 0; l < k; ++l) tgt_t.add(ref(l));
      const T r = src_t.total() / tgt_t.total();
      T* dp_out = s_out + 3 * kc * ncol + col;
      for (int l = 0; l < k; ++l)
        dp_out[static_cast<size_t>(l) * ncol] = ref(l) * r;
    } else if (w == 1 && live) {
      // the double chain: the layers the fields are remapped onto
      CompSum<double> src_d, tgt_d2;
      for (int l = 0; l < k; ++l) src_d.add(cl.at(cl.dp, l));
      const double ps_d = static_cast<double>(ptop) + src_d.total();
      for (int l = 0; l < k; ++l) tgt_d2.add(ref_d(l, ps_d));
      col_ps[x] = ps_d;
      col_r[x] = src_d.total() / tgt_d2.total();
    }
    __syncthreads();
  }
  // what a cut-down variant computed, written to one output row, so that
  // the compiler keeps it
  T* keep = (kPacked ? s_out : q_out) + col;
  if constexpr (kVariant == 2) {
    if (kPacked && live && w == 0)
      *keep = static_cast<T>(col_ps[x] * col_r[x]);
    return;
  }
  if constexpr (kVariant == 4) {
    if (live && w == 0) cl.geometry(tgt_d, 0, 1);
  } else {
    if (live) cl.geometry(tgt_d, w);
  }
  if constexpr (kVariant >= 1 && kVariant <= 4) {
    __syncthreads();
    if (live && w == 0)
      *keep = cl.at(cl.a, k / 2) + static_cast<T>(cl.c[(k / 2) * kCols]);
    if constexpr (kVariant != 1) return;
  }

  for (int f = 0; f < nfield; ++f) {
    if (f > 0) {
      __syncthreads();   // the last field's passes are done with q
      stage(cl.q, field_src(f), 0, k, ncol, col, w);
      wait_copies<0>();
    }
    __syncthreads();
    if constexpr (kVariant == 1) continue;
    const bool tracer = kPacked && f >= 3;
    if (tracer && live) {
      for (int l = w; l < k; l += kWarps)
        cl.q[l * kCols] = cl.at(cl.q, l) / cl.at(cl.dp, l);
    }
    if constexpr (kScheme != kPcm) {
      if (tracer) __syncthreads();
      if (live) cl.reconstruct(w, kWarps);
      __syncthreads();
    } else if (tracer) {
      __syncthreads();
    }
    if (!live) continue;
    if (tracer)
      cl.template remap<false>(tgt, field_out(f) + col, ncol, w);
    else
      cl.template remap<true>(tgt, field_out(f) + col, ncol, w);
  }
}

template <typename T, bool kPacked>
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                        const T*, T, T*, T*, int, int, int);

template <typename T, bool kPacked>
Kernel<T, kPacked> pick(int scheme) {
  return scheme == kPcm   ? remap_kernel<T, kPcm, kPacked>
         : scheme == kPlm ? remap_kernel<T, kPlm, kPacked>
                          : remap_kernel<T, kPpm, kPacked>;
}

// shared memory of a block: the 2K hybrid terms, and per column (3 + the
// coefficients) x K + 1 values of T and K + 1 cell indices
size_t smem_bytes(int k, int itemsize, int scheme) {
  const size_t per_col =
      (static_cast<size_t>(3 + coefficients(scheme)) * k + 1) * itemsize +
      (static_cast<size_t>(k) + 1) * sizeof(unsigned short);
  return (2 * static_cast<size_t>(k) * itemsize + per_col * kCols + 7) / 8 *
         8;
}

// A block's dynamic shared memory, and the SM's carveout at its most shared
// memory: the blocks an SM holds are set by shared memory alone
template <typename Kern>
cudaError_t configure(Kern* kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, bool kPacked>
cudaError_t launch(int scheme, const void* src, const void* qdp,
                   const void* dp_src, const void* dp_tgt, const void* hyai,
                   const void* hybi, double ps0, void* s_out, void* q_out,
                   int k, int nq, int ncol, void* stream) {
  const size_t smem = smem_bytes(k, sizeof(T), scheme);
  if (scheme < kPcm || scheme > kPpm || k < 1 || k > 65535 || nq < 0 ||
      ncol < 1 || smem > kMaxSmem)
    return cudaErrorInvalidValue;
  auto* kernel = pick<T, kPacked>(scheme);
  cudaError_t err = configure(kernel, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((ncol + kCols - 1) / kCols);
  kernel<<<grid, dim3(kCols, kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const T*>(qdp),
      static_cast<const T*>(dp_src), static_cast<const T*>(dp_tgt),
      static_cast<const T*>(hyai), static_cast<const T*>(hybi),
      static_cast<T>(ps0), static_cast<T*>(s_out), static_cast<T*>(q_out), k,
      nq, ncol);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* remap_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Dynamic shared memory a block of the kernel takes for K levels of
// `itemsize`-byte values and `scheme` (kernels/remap.py::remap_plan mirrors
// it); the launch refuses more than a block may have.
int remap_smem_bytes(int k, int itemsize, int scheme) {
  return static_cast<int>(smem_bytes(k, itemsize, scheme));
}

// Blocks of the packed (or level-form) kernel one SM holds, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a CUDA error.
int remap_blocks_per_sm(int f64, int scheme, int packed, int k, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t smem = smem_bytes(k, f64 ? 8 : 4, scheme);
  int n = 0;
  const auto blocks = [&](auto* kernel) {
    cudaError_t e = configure(kernel, smem);
    return e == cudaSuccess ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                  &n, kernel, kCols * kWarps, smem)
                            : e;
  };
  if (scheme < kPcm || scheme > kPpm || smem > kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  err = f64 ? (packed ? blocks(pick<double, true>(scheme))
                      : blocks(pick<double, false>(scheme)))
            : (packed ? blocks(pick<float, true>(scheme))
                      : blocks(pick<float, false>(scheme)));
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The packed remap: s [4k, ncol] and qdp [nq*k, ncol] -> s_out, q_out of
// the same shapes; hyai, hybi [k+1]; f64 selects double (else float),
// scheme 0 pcm, 1 plm, 2 ppm. One launch.
int remap_packed_launch(int f64, int scheme, const void* s, const void* qdp,
                        const void* hyai, const void* hybi, double ps0,
                        void* s_out, void* q_out, int k, int nq, int ncol,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return f64 ? launch<double, true>(scheme, s, qdp, nullptr, nullptr, hyai,
                                    hybi, ps0, s_out, q_out, k, nq, ncol,
                                    stream)
             : launch<float, true>(scheme, s, qdp, nullptr, nullptr, hyai,
                                   hybi, ps0, s_out, q_out, k, nq, ncol,
                                   stream);
}

// The level form: q [nq*k, ncol] (nq fields of k levels), dp_src and dp_tgt
// [k, ncol] -> out [nq*k, ncol]. One launch.
int remap_levels_launch(int f64, int scheme, const void* q,
                        const void* dp_src, const void* dp_tgt, void* out,
                        int k, int nq, int ncol, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return f64 ? launch<double, false>(scheme, q, nullptr, dp_src, dp_tgt,
                                     nullptr, nullptr, 0.0, nullptr, out, k,
                                     nq, ncol, stream)
             : launch<float, false>(scheme, q, nullptr, dp_src, dp_tgt,
                                    nullptr, nullptr, 0.0, nullptr, out, k,
                                    nq, ncol, stream);
}

}  // extern "C"
