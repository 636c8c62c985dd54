// Conservative vertical remap of column cell averages, the rsplit cadence's
// remap, as one kernel.
//
// Replaces tinman_sandbox_tpu/dist/step_pallas.py:693 remap_packed_t4 over
// tinman_sandbox_tpu/ops/remap.py:68 remap_column: XLA array code, no
// pallas_call. The JAX package builds, for every column, the dense
// [K+1, K] overlap of every target interface with every source cell and
// takes differences of the cumulative integrals I(t_j): 73 x 72 products a
// column and field, which suits the TPU's vector units. On this card the
// dense form is ~1,200 small launches and 1.5 GB of temporaries a call.
//
// What this kernel computes, per column:
//   * the packed form (kPacked): the column total of dp_src by Neumaier's
//     compensated sum in level order, ps = hyai[0]*ps0 + that total,
//     dp_ref_k = (hyai[k+1] - hyai[k])*ps0 + (hybi[k+1] - hybi[k])*ps, the
//     compensated total of dp_ref, and dp_tgt_k = dp_ref_k * (tot_src /
//     tot_tgt): the same rounded operations in the same order as
//     dist/step_t.py::remap_packed_t4_plain, so the dp rows equal the plain
//     code's bit for bit (the source is built with -fmad=false: no
//     expression here is contracted into an FMA). The same chain runs once
//     more in double from the same rounded terms hyai[0]*ps0, da*ps0 and
//     db: the layers the fields are remapped onto, which are the plain
//     float64 code's dp_tgt on the same inputs, bit for bit. (On float32
//     inputs the float chain's dp_tgt is a few ulps off those layers, and
//     a column's interfaces sum that offset: remapping onto the float dp
//     rows would carry it into every field.) Then it remaps u, v and T
//     (densities: out = mass / dp_tgt) and every tracer (its mass qdp;
//     out = the target cell's mass);
//   * the level form: dp_tgt is given; every field is a density.
// The reconstruction in each source cell is pcm, plm (minmod slopes) or ppm
// (4th-order edges, Colella-Woodward monotonisation), the formulas of
// ops/remap.py::_remap_chunk. The last target interface covers the whole
// column (the plain code's x[-1] = dp_src rule).
//
// The integral, once a column and once a field. The geometry pass walks
// the source interfaces s_c and the target interfaces t_j, running sums in
// double in level order (in float their rounding grows along the column,
// and a shifted interface moves a whole piece): for every target interface
// the cell c_j it falls in and its place in that cell as a fraction xi_j =
// a_j / dp_c of the local coordinate a_j = clip(t_j - s_c), c_j and a_j
// bit for bit the walk of the design before. A field then needs, for
// every cell, its mass M_c (a density times dp, a tracer's qdp itself) and
// its reconstruction's coefficients, and the integral of the cell's
// reconstruction over [0, a] is a polynomial in xi with those as weights,
// L(c, xi): pcm M xi; plm M xi + C1 xi (xi - 1), C1 = m dp^2 / 2; ppm
// M xi^2 (3 - 2 xi) + C1 xi (1 - xi)^2 + C2 xi^2 (xi - 1), C1 = dp aL,
// C2 = dp aR; L(c, 1) = M exactly. Target cell j takes
//   M_j = (M_{c_j} - L(c_j, xi_j)) + sum of M_c, c_j < c < c_{j+1},
//         + L(c_{j+1}, xi_{j+1}),
// or L(c, xi_{j+1}) - L(c, xi_j) when both interfaces lie in one cell c: a
// few products a piece, a whole cell its mass, and the pieces of a cell sum
// to its mass. A density's mean is M_j times the reciprocal of its target
// layer rounded to T.
//
// What bounds it on the H100. At ne30 x 72, f32, it reads s and qdp once
// and writes s' and q' once: 248.8 MB at qsize 1 (0.074 ms at 3.35 TB/s),
// 1.94 GB at qsize 35 (0.579 ms). Its instructions, not its bytes, set its
// time: on input that stays in L2 it takes what it takes on cold input,
// and a field costs ~1.3x what copying it through shared memory and back
// does; at qsize 1 each column's serial work (the two chains and the
// geometry, 0.076 ms at ne30 alone) is what the few fields cannot hide
// (experiments/kernel_variants.py, group remap, times each pass apart).
// The design:
//   * a block is 32 columns (a lane each: a level's row of the block is one
//     128-byte line in f32) and kWarps warps; every array is [level][lane],
//     so a thread reads its own bank at any level;
//   * the block copies dp_src and each field into shared memory with
//     cp.async, 16 bytes a copy where the rows allow;
//   * warp 0 runs the double chain, warp kFloat the float chain and the dp
//     rows, the warps from kField reconstruct field 0 meanwhile; then every
//     warp a segment of the geometry, summing its t and walking the cells
//     from the column's top, four a step (the shortest walk a warp);
//   * per field, the warps split the levels into contiguous ranges: the
//     reconstruction slides down its range (a slope, a ppm edge once an
//     interface), the target pass down its targets (each cell's mass and
//     coefficients read once), storing row j coalesced.
// One field buffer and no stored reciprocals: a block then takes 42 KB at
// K = 72 in f32, 5 blocks an SM (their registers capped at 48), which
// served better than a second buffer or stored reciprocals at 3 or 4
// blocks. A block's shared memory (remap_smem_bytes) is the 2K hybrid terms
// (to 16 bytes) and, per column, dp_src, the field, the coefficient arrays,
// the interface fractions xi_j of T and the cells c_j: the level limits of
// the design before (f32 plm 397, ppm 326, f64 plm 210).
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kPcm = 0, kPlm = 1, kPpm = 2;
constexpr int kCols = 32;          // columns a block, one a lane
// warps a block (a build flag only for experiments/kernel_variants.py,
// which times other values)
#ifndef REMAP_WARPS
#define REMAP_WARPS 8
#endif
constexpr int kWarps = REMAP_WARPS;
// warp 0 takes the double chain, warp kFloat the float chain, the warps
// from kField reconstruct field 0; then every warp a segment of the
// geometry
constexpr int kFloat = 2, kField = 3;
static_assert(kWarps > kField, "the chains' warps and at least one more");
constexpr int kMaxSmem = 232448;   // dynamic shared memory a block may take
// what a launch does (an experiment's build flag): 0 the kernel; 1 no field
// passes; 2 the chains only; 3 and 4 the chains and the geometry; 5 loads
// and stores only; 6 no reconstruction; 7 no target pass; 8 and 9 the
// chains and the geometry without its sums of t, or without its walk
#ifndef REMAP_VARIANT
#define REMAP_VARIANT 0
#endif
constexpr int kVariant = REMAP_VARIANT;
constexpr bool kStaged = kVariant <= 1 || (kVariant >= 5 && kVariant <= 7);
constexpr bool kRecon = kVariant == 0 || kVariant == 7;
constexpr bool kTarget = kVariant == 0 || kVariant == 6;
// per-phase clocks of the blocks (an experiment's build flag: each phase's
// cycles summed over the blocks by the warp that runs it, read back by
// remap_clocks)
#ifdef REMAP_CLOCKS
__device__ unsigned long long phase_clocks[16];
#define REMAP_CLOCK_START(name) const long long name = clock64()
#define REMAP_CLOCK(slot, since)                                     \
  do {                                                               \
    if (threadIdx.x == 0)                                            \
      atomicAdd(&phase_clocks[slot],                                 \
                static_cast<unsigned long long>(clock64() - since)); \
  } while (0)
#define REMAP_COUNT(slot) \
  do {                    \
    if (threadIdx.x == 0) atomicAdd(&phase_clocks[slot], 1ull); \
  } while (0)
#else
#define REMAP_CLOCK_START(name) \
  do {                          \
  } while (0)
#define REMAP_CLOCK(slot, since) \
  do {                           \
  } while (0)
#define REMAP_COUNT(slot) \
  do {                    \
  } while (0)
#endif

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

// a barrier of the warps kField.. alone
__device__ __forceinline__ void sync_field_warps() {
  asm volatile("bar.sync 1, %0;\n" ::"r"((kWarps - kField) * kCols)
               : "memory");
}

// an asynchronous 16-byte copy into shared memory, past L1
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

// Starts this thread's copies of rows [row0, row0 + k) of src (ncol
// columns), the block's 32 columns from col0, into dst[l * kCols + column],
// levels handed out to ranks r of step: with vec 16 bytes a copy (a lane
// takes 16 / sizeof(T) columns of a level, a warp as many levels at once),
// else a column a copy (a warp one level of its 32 columns at a time)
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src,
                                      size_t row0, int k, int ncol, int col0,
                                      int x, int r, int step, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(T), kLanes = kCols / kPer;
    const int lc = (x % kLanes) * kPer;
    for (int l = r * kPer + x / kLanes; l < k; l += step * kPer)
      copy16(dst + l * kCols + lc, src + (row0 + l) * ncol + col0 + lc);
  } else if (col0 + x < ncol) {
    for (int l = r; l < k; l += step)
      copy_async(dst + l * kCols + x, src + (row0 + l) * ncol + col0 + x);
  }
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

// a slope's division: in float the card's fast division (2 ulps; a slope
// only chooses and scales a cell's linear part), in double the exact one
__device__ __forceinline__ float quotient(float a, float b) {
  return __fdividef(a, b);
}
__device__ __forceinline__ double quotient(double a, double b) {
  return a / b;
}

// The scheme's coefficient arrays a field needs beside its masses
__host__ __device__ constexpr int coefficients(int scheme) {
  return scheme == kPcm ? 0 : scheme == kPlm ? 1 : 2;
}

// level range [lo, hi) of rank r of n over k
__device__ __forceinline__ int split(int k, int r, int n) {
  return static_cast<int>(static_cast<long long>(k) * r / n);
}

// One thread's column in shared memory, every array [level][kCols]: dp_src,
// the field being remapped x (a density, or a tracer's mass), its
// coefficients c1, c2, the interface fractions xi (j = 0..K) and the cells c
// (j = 0..K)
template <typename T, int kScheme>
struct Column {
  T* dp;
  T* x;
  T* c1;
  T* c2;
  T* xi;
  unsigned short* c;
  int k;

  __device__ __forceinline__ static T at(const T* a, int l) {
    return a[l * kCols];
  }

  // the field's mean in cell l (a tracer's mass over dp)
  template <bool kTracer>
  __device__ __forceinline__ T mean(int l) const {
    return kTracer ? at(x, l) / at(dp, l) : at(x, l);
  }

  // cell l's mass
  template <bool kTracer>
  __device__ __forceinline__ T mass(int l) const {
    return kTracer ? at(x, l) : at(x, l) * at(dp, l);
  }

  // the reconstruction of levels [lo, hi): plm c1 = m dp^2 / 2 from the
  // minmod of the centred slopes g_l = (q_{l+1} - q_l) / (half the sum of
  // the two cells' dp), each g once; ppm c1, c2 = dp aL, dp aR from the
  // monotone edges, each edge once
  template <bool kTracer>
  __device__ __forceinline__ void reconstruct(int lo, int hi) const {
    if (lo >= hi) return;
    if constexpr (kScheme == kPlm) {
      // the slope between cells of values x0, x1 and thicknesses d0, d1:
      // of the means, a tracer's from its masses with one division
      const auto slope = [&](T x0, T x1, T d0, T d1) {
        if constexpr (kTracer)
          return quotient(x1 * d0 - x0 * d1,
                          (d0 * d1) * (T(0.5) * (d1 + d0)));
        else
          return quotient(x1 - x0, T(0.5) * (d1 + d0));
      };
      T dc = at(dp, lo), xc = at(x, lo), g_lo = 0;
      if (lo > 0) g_lo = slope(at(x, lo - 1), xc, at(dp, lo - 1), dc);
      for (int l = lo; l < hi; ++l) {
        T g_hi = 0, dn = 0, xn = 0;
        if (l + 1 < k) {
          dn = at(dp, l + 1);
          xn = at(x, l + 1);
          g_hi = slope(xc, xn, dc, dn);
        }
        const T m = g_lo * g_hi > T(0)
                        ? copysign(fmin(fabs(g_lo), fabs(g_hi)), g_lo)
                        : T(0);
        c1[l * kCols] = (T(0.5) * (m * dc)) * dc;
        g_lo = g_hi;
        xc = xn;
        dc = dn;
      }
    } else if constexpr (kScheme == kPpm) {
      // edge i from q_{i-2}, q_{i-1}, q_i, q_{i+1}, indices clamped to the
      // column (the plain code's edge replication)
      const auto qc = [&](int l) {
        return mean<kTracer>(l < 0 ? 0 : l >= k ? k - 1 : l);
      };
      const auto edge = [&](T qm2, T qm1, T qp0, T qp1) {
        const T e = T(7.0 / 12.0) * (qm1 + qp0) - T(1.0 / 12.0) * (qm2 + qp1);
        return fmin(fmax(e, fmin(qm1, qp0)), fmax(qm1, qp0));
      };
      // the window q_{l-2} .. q_{l+1} at edge l = lo
      T qm2 = qc(lo - 2), qm1 = qc(lo - 1), qp0 = qc(lo), qp1 = qc(lo + 1);
      T e_l = edge(qm2, qm1, qp0, qp1);
      for (int l = lo; l < hi; ++l) {
        const T ql = qp0;
        qm2 = qm1;
        qm1 = qp0;
        qp0 = qp1;
        qp1 = qc(l + 2);
        const T e_r = edge(qm2, qm1, qp0, qp1);
        T a_l = e_l, a_r = e_r;
        if ((a_r - ql) * (ql - a_l) <= T(0)) a_l = a_r = ql;
        const T d = a_r - a_l;
        const T dev = ql - T(0.5) * (a_l + a_r);
        if (d * dev > d * d / T(6)) a_l = T(3) * ql - T(2) * a_r;
        if (-(d * d) / T(6) > d * dev) a_r = T(3) * ql - T(2) * a_l;
        const T dl = at(dp, l);
        c1[l * kCols] = dl * a_l;
        c2[l * kCols] = dl * a_r;
        e_l = e_r;
      }
    }
  }

  // L(l, f): the integral of cell l's reconstruction over [0, f dp_l], m
  // the cell's mass
  __device__ __forceinline__ T lower(int l, T f, T m) const {
    if constexpr (kScheme == kPcm) {
      return m * f;
    } else if constexpr (kScheme == kPlm) {
      return m * f + at(c1, l) * (f * (f - T(1)));
    } else {
      const T g = T(1) - f;
      return m * (f * f * (T(3) - T(2) * f)) + at(c1, l) * (f * g * g) -
             at(c2, l) * (f * f * g);
    }
  }

  // The geometry pass, segment seg of nseg of this thread's column: t_j =
  // sum of tgt_d(i), i < j, in double and in that order; c_j the first cell
  // whose local coordinate a = clip(t_j - s_c) rounded to T is below dp_c
  // (K past the column's end), xi_j = a / dp_c; t_K is the column's end.
  // Each segment of the interfaces 1 .. K-1 sums its t and walks the cells
  // from the column's top, which gives the bits of one walk down the whole
  // column, since a cell passed at t stays passed at any later t. A cell
  // counts as passed where t - s_c reaches its threshold (passed_at), so
  // the walk rounds no a on the way, and takes four cells a step.
  template <typename Tgt>
  __device__ __forceinline__ void geometry(Tgt tgt_d, int seg,
                                           int nseg) const {
    const int n = k - 1;
    const int j_lo = 1 + split(n, seg, nseg);
    const int j_hi = 1 + split(n, seg + 1, nseg);
    if (seg == 0) {
      c[0] = 0;
      xi[0] = 0;
    }
    if (seg == nseg - 1) {
      c[k * kCols] = static_cast<unsigned short>(k);
      xi[k * kCols] = 0;
    }
    if (j_lo >= j_hi) return;
    double t = 0, s = 0;
    if constexpr (kVariant == 8) {
      t = j_lo * tgt_d(0);
    } else {
#pragma unroll 8
      for (int i = 0; i < j_lo; ++i) t += tgt_d(i);
    }
    // the segment's first cell, four cells a step from the column's top;
    // then the cell's thickness d and threshold th held while the targets
    // pass it, read anew only when the walk moves on
    int cell = 0;
    if (kVariant != 9) walk(t, s, cell);
    T d = at(dp, min(cell, k - 1));
    double th = passed_at(d);
    for (int j = j_lo; j < j_hi; ++j) {
      if (j > j_lo) {
        t += tgt_d(j - 1);
        while (kVariant != 9 && cell < k && t - s >= th) {
          s += d;
          if (++cell < k) {
            d = at(dp, cell);
            th = passed_at(d);
          }
        }
      }
      // not passed: t - s < th <= d, so clip(t - s, d) is max(t - s, 0)
      c[j * kCols] = static_cast<unsigned short>(cell);
      xi[j * kCols] =
          cell < k ? static_cast<T>(fmax(t - s, 0.0)) / d : T(0);
    }
  }

  // Advances (s, cell) past every cell passed at t, four cells a step
  // while t lies past the fourth one's end by more than the rounding of
  // these sums can move (the margin): then t - s_c exceeds d_c, and so its
  // threshold, for each of the four (none of them of negative thickness);
  // else cell by cell
  __device__ __forceinline__ void walk(double t, double& s, int& cell) const {
    const double margin = fabs(t) * 0x1p-40;
    while (cell + 4 <= k) {
      const T d0 = at(dp, cell), d1 = at(dp, cell + 1),
              d2 = at(dp, cell + 2), d3 = at(dp, cell + 3);
      const double s4 = s + d0 + d1 + d2 + d3;
      if (!(t - s4 >= margin && fmin(fmin(d0, d1), fmin(d2, d3)) >= T(0)))
        break;
      s = s4;
      cell += 4;
    }
    while (cell < k) {
      const T d = at(dp, cell);
      if (!(t - s >= passed_at(d))) return;
      s += d;
      ++cell;
    }
  }

  // The least x = t - s at which a cell of finite thickness d counts as
  // passed, for finite x: where T(clip(x, d)) >= d. In double, x >= d; in
  // float, x at or above the midpoint of d and the float below it (a tie
  // rounds to the even of the two, so past the midpoint where d's last bit
  // is odd); always where d <= 0 (clip gives d).
  __device__ __forceinline__ static double passed_at(T d) {
    if (!(d > T(0))) return -CUDART_INF;
    if constexpr (sizeof(T) == sizeof(double)) {
      return d;
    } else {
      // the midpoint of a normal d and the float below it is d in double
      // less 2^28 in its bits (a power of two borrows from its exponent: the
      // float below is nearer); of a subnormal d, their mean
      const int bits = __float_as_int(d);
      const double dd = d;
      const long long mid =
          bits < 0x00800000
              ? __double_as_longlong(
                    0.5 * (static_cast<double>(__int_as_float(bits - 1)) + dd))
              : __double_as_longlong(dd) - (1ll << 28);
      return __longlong_as_double(mid + (bits & 1));
    }
  }

  // The target pass of one field for target cells [j0, j1): out[j * ncol],
  // target cell j's mass (a tracer), or its mass times the reciprocal of
  // its layer, rcp(j)
  template <bool kTracer, typename Rcp>
  __device__ __forceinline__ void remap(int j0, int j1, Rcp rcp_of,
                                        T* __restrict__ out, int ncol) const {
    if (j0 >= j1) return;
    // the cell at the target's top interface, its mass and L there
    int cell = c[j0 * kCols];
    const int c_top = min(cell, k - 1);
    T m_c = cell < k ? mass<kTracer>(c_top) : T(0);
    T l_prev = cell < k ? lower(c_top, at(xi, j0), m_c) : T(0);
    const unsigned short* c_at = c + (j0 + 1) * kCols;
    const T* xi_at = xi + (j0 + 1) * kCols;
    T* out_at = out + static_cast<size_t>(j0) * ncol;
    for (int j = j0; j < j1;
         ++j, c_at += kCols, xi_at += kCols, out_at += ncol) {
      // the cell at the bottom interface (K past the end: nothing of it)
      const int next = *c_at, nc = min(next, k - 1);
      const bool inside = next < k;
      const T m_nc = mass<kTracer>(nc), l_nc = lower(nc, *xi_at, m_nc);
      const T m_n = inside ? m_nc : T(0), l_next = inside ? l_nc : T(0);
      // (M_c - L(c, xi_j)) + the cells between + L(next, xi_{j+1}), or
      // L(c, xi_{j+1}) - L(c, xi_j) within one cell
      T acc = (next == cell ? T(0) : m_c) - l_prev;
      if (next > cell + 1) {
#pragma unroll 1
        for (int l = cell + 1; l < next; ++l) acc += mass<kTracer>(l);
      }
      acc += l_next;
      *out_at = kTracer ? acc : acc * rcp_of(j);
      l_prev = l_next;
      m_c = m_n;
      cell = next;
    }
  }
};

// bytes of the block's hybrid terms, 2K values, to a 16-byte boundary (the
// column arrays after them take 16-byte copies)
__host__ __device__ inline size_t hybrid_bytes(int k, int itemsize) {
  return (2 * static_cast<size_t>(k) * itemsize + 15) / 16 * 16;
}

// shared memory of a block: the 2K hybrid terms, and per column (3 + the
// coefficients) x K + 1 values of T (dp_src, the field, the coefficients,
// the interfaces' fractions) and K + 1 cell indices
size_t smem_bytes(int k, int itemsize, int scheme) {
  const size_t per_col =
      (static_cast<size_t>(3 + coefficients(scheme)) * k + 1) * itemsize +
      (static_cast<size_t>(k) + 1) * sizeof(unsigned short);
  return (hybrid_bytes(k, itemsize) + per_col * kCols + 7) / 8 * 8;
}

// blocks an SM the registers are capped for (an experiment's build flag):
// 5, the blocks an SM that shared memory leaves at K = 72 in f32 (42 KB a
// block), which more warps in flight served better than a second field
// buffer or stored reciprocals at 3 or 4 blocks (experiments/
// kernel_variants.py, group remap)
#ifndef REMAP_MIN_BLOCKS
#define REMAP_MIN_BLOCKS 5
#endif

// Packed (kPacked): src = s [4K, ncol] (fields u, v, T, then dp_src) and
// qdp [nq*K, ncol]; out = s' [4K, ncol] and q' [nq*K, ncol]; hyai, hybi
// [K+1]. Level form: src = q [nq*K, ncol] (densities), dp_src and dp_tgt
// [K, ncol], out = q' [nq*K, ncol]; qdp, hyai, hybi, s_out unused. vec:
// every operand 16-byte aligned and ncol a multiple of 16 / sizeof(T).
template <typename T, int kScheme, bool kPacked>
__global__ void __launch_bounds__(kCols * kWarps, REMAP_MIN_BLOCKS)
remap_kernel(const T* __restrict__ src, const T* __restrict__ qdp,
             const T* __restrict__ dp_src, const T* __restrict__ dp_tgt,
             const T* __restrict__ hyai, const T* __restrict__ hybi, T ps0,
             T* __restrict__ s_out, T* __restrict__ q_out, int k, int nq,
             int ncol, int vec_ok) {
  extern __shared__ __align__(16) double smem_raw[];
  __shared__ double col_ps[kCols], col_r[kCols];   // the double chain's ps, r
  const int x = threadIdx.x, w = threadIdx.y;
  const int col0 = blockIdx.x * kCols, col = col0 + x;
  const bool live = col < ncol;
  const bool vec = vec_ok && col0 + kCols <= ncol;
  constexpr int kCoef = coefficients(kScheme);
  REMAP_CLOCK_START(t_start);
  // the block's hybrid terms da_l = (hyai[l+1] - hyai[l])*ps0 and db_l =
  // hybi[l+1] - hybi[l] (packed form), then the columns' arrays, each
  // [level][kCols] from a block-wide base
  T* da = reinterpret_cast<T*>(smem_raw);
  T* db = da + k;
  const int kk = k * kCols;
  T* dp_b = reinterpret_cast<T*>(reinterpret_cast<char*>(smem_raw) +
                                 hybrid_bytes(k, sizeof(T)));
  T* x_b = dp_b + kk;
  T* c1_b = x_b + kk;
  T* c2_b = c1_b + (kCoef > 0 ? kk : 0);
  T* xi_b = c2_b + (kCoef > 1 ? kk : 0);
  Column<T, kScheme> cl;
  cl.k = k;
  cl.dp = dp_b + x;
  cl.x = x_b + x;
  cl.c1 = c1_b + x;
  cl.c2 = c2_b + x;
  cl.xi = xi_b + x;
  // the cell indices after the T arrays, [level][kCols] of their own
  cl.c = reinterpret_cast<unsigned short*>(xi_b + (k + 1) * kCols) + x;
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
  const auto stage_rows = [&](T* dst, const T* from, size_t row0, int r,
                              int step) {
    stage(dst, from, row0, k, ncol, col0, x, r, step, vec);
  };

  // in flight: dp_src, and field 0, staged by the warps that reconstruct it
  stage_rows(dp_b, kPacked ? src : dp_src, kPacked ? 3 * kc : 0, w, kWarps);
  commit();
  if (nfield > 0 && kStaged && w >= kField)
    stage_rows(x_b, field_src(0), 0, w - kField, kWarps - kField);
  commit();
  if constexpr (kPacked)
    for (int l = w * kCols + x; l < k; l += kCols * kWarps) {
      da[l] = (hyai[l + 1] - hyai[l]) * ps0;
      db[l] = hybi[l + 1] - hybi[l];
    }
  wait_copies<1>();
  __syncthreads();
  if (w == 0) REMAP_CLOCK(0, t_start);
  REMAP_CLOCK_START(t_phase);

  // the double chain's layers (warp 0): the plain float64 code's
  // operations on the same rounded terms, so the layers the fields are
  // remapped onto are that code's dp_tgt bit for bit
  const auto ref_d = [&](int l, double ps_d) -> double {
    return static_cast<double>(da[l]) + static_cast<double>(db[l]) * ps_d;
  };
  if (w == 0 && kPacked && live && kVariant != 5) {
    const T ptop = hyai[0] * ps0;
    CompSum<double> src_d, tgt_d2;
#pragma unroll 8
    for (int l = 0; l < k; ++l) src_d.add(cl.at(cl.dp, l));
    const double ps_d = static_cast<double>(ptop) + src_d.total();
#pragma unroll 8
    for (int l = 0; l < k; ++l) tgt_d2.add(ref_d(l, ps_d));
    col_ps[x] = ps_d;
    col_r[x] = src_d.total() / tgt_d2.total();
  }
  if (w == 0) REMAP_CLOCK(1, t_phase);
  // the target thickness in double (the geometry's) and its reciprocal
  // rounded to T (the means' factor)
  const auto tgt_d = [&](int j) -> double {
    if constexpr (kPacked)
      return ref_d(j, col_ps[x]) * col_r[x];
    else
      return dp_tgt[static_cast<size_t>(j) * ncol + col];
  };
  const auto rcp_of = [&](int j) -> T {
    return T(1) / static_cast<T>(tgt_d(j));
  };
  if (w == kFloat) {
    if (kPacked && live) {
      T* dp_out = s_out + 3 * kc * ncol + col;
      if constexpr (kVariant == 5) {
        for (int l = 0; l < k; ++l)
          dp_out[static_cast<size_t>(l) * ncol] = cl.at(cl.dp, l);
      } else {
        // the float chain: the dp rows, the plain code's operations
        const T ptop = hyai[0] * ps0;
        T ps = 0;
        const auto ref = [&](int l) -> T {   // reference_dp: da*ps0 + db*ps
          return da[l] + db[l] * ps;
        };
        CompSum<T> src_t, tgt_t;
#pragma unroll 8
        for (int l = 0; l < k; ++l) src_t.add(cl.at(cl.dp, l));
        ps = ptop + src_t.total();
#pragma unroll 8
        for (int l = 0; l < k; ++l) tgt_t.add(ref(l));
        const T r = src_t.total() / tgt_t.total();
#pragma unroll 8
        for (int l = 0; l < k; ++l)
          dp_out[static_cast<size_t>(l) * ncol] = ref(l) * r;
      }
    }
    REMAP_CLOCK(4, t_phase);
  }
  if (w >= kField && nfield > 0 && kStaged) {
    // field 0's reconstruction while the chains run
    wait_copies<0>();
    sync_field_warps();
    const int r = w - kField, n = kWarps - kField;
    if (live && kRecon)
      cl.template reconstruct<false>(split(k, r, n), split(k, r + 1, n));
    if (w == kField) REMAP_CLOCK(5, t_phase);
  }
  // the geometry, a segment a warp, once the double chain has given the
  // layers
  __syncthreads();
  REMAP_CLOCK_START(t_geo);
  if (live && kVariant != 2 && kVariant != 5) cl.geometry(tgt_d, w, kWarps);
  if (w < 2) REMAP_CLOCK(2 + w, t_geo);
  __syncthreads();
  if (w == 0) REMAP_CLOCK(6, t_phase);
  if constexpr ((kVariant != 0 && kVariant < 5) || kVariant > 7) {
    // what a cut-down variant computed, written to one output row, so that
    // the compiler keeps it
    T* keep = (kPacked ? s_out : q_out) + col;
    if (live && w == 0)
      *keep = kVariant == 2 ? static_cast<T>(col_ps[x] * col_r[x])
                            : cl.at(cl.xi, k / 2) +
                                  static_cast<T>(cl.c[(k / 2) * kCols]);
    if constexpr (kVariant != 1) return;
  }

  // field by field: its copy (after the passes of the field before are done
  // with x and c1), its reconstruction, then its target pass, this
  // thread's targets [j0, j1) and reconstruction levels the same
  REMAP_CLOCK_START(t_fields);
  const int j0 = split(k, w, kWarps), j1 = split(k, w + 1, kWarps);
  for (int f = 0; f < nfield; ++f) {
    const bool tracer = kPacked && f >= 3;
    if (f > 0) {
      __syncthreads();
      stage_rows(x_b, field_src(f), 0, w, kWarps);
      commit();
      wait_copies<0>();
      __syncthreads();
      if (live && kRecon) {
        if (tracer)
          cl.template reconstruct<true>(j0, j1);
        else
          cl.template reconstruct<false>(j0, j1);
      }
      __syncthreads();
    }
    if (!live) continue;
    T* out = field_out(f) + col;
    if constexpr (kVariant == 5) {
      for (int j = j0; j < j1; ++j)
        out[static_cast<size_t>(j) * ncol] = cl.at(cl.x, j);
    } else if constexpr (kVariant == 7) {
      if (j0 < j1) out[static_cast<size_t>(j0) * ncol] = cl.at(cl.c1, j0);
    } else if constexpr (kTarget) {
      if (tracer)
        cl.template remap<true>(j0, j1, rcp_of, out, ncol);
      else
        cl.template remap<false>(j0, j1, rcp_of, out, ncol);
    }
  }
  if (w == 0) {
    REMAP_CLOCK(7, t_fields);
    REMAP_CLOCK(8, t_start);
    REMAP_COUNT(9);
  }
}

template <typename T, bool kPacked>
using Kernel = void (*)(const T*, const T*, const T*, const T*, const T*,
                        const T*, T, T*, T*, int, int, int, int);

template <typename T, bool kPacked>
Kernel<T, kPacked> pick(int scheme) {
  return scheme == kPcm   ? remap_kernel<T, kPcm, kPacked>
         : scheme == kPlm ? remap_kernel<T, kPlm, kPacked>
                          : remap_kernel<T, kPpm, kPacked>;
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
  // 16-byte copies: every operand aligned, rows a whole number of copies
  const auto aligned = [](const void* p) {
    return p == nullptr || reinterpret_cast<size_t>(p) % 16 == 0;
  };
  const int vec_ok = ncol % (16 / static_cast<int>(sizeof(T))) == 0 &&
                     aligned(src) && aligned(qdp) && aligned(dp_src) &&
                     aligned(dp_tgt);
  kernel<<<grid, dim3(kCols, kWarps), smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(src), static_cast<const T*>(qdp),
      static_cast<const T*>(dp_src), static_cast<const T*>(dp_tgt),
      static_cast<const T*>(hyai), static_cast<const T*>(hybi),
      static_cast<T>(ps0), static_cast<T*>(s_out), static_cast<T*>(q_out), k,
      nq, ncol, vec_ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

#ifdef REMAP_CLOCKS
// The per-phase clocks summed since the last call into out[16], then zeroed
int remap_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, phase_clocks, sizeof(
      unsigned long long) * 16);
  if (err != cudaSuccess) return err;
  const unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(phase_clocks, zero, sizeof(zero));
}
#endif

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
  if (scheme < kPcm || scheme > kPpm || k < 1)
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(k, f64 ? 8 : 4, scheme);
  if (smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const auto blocks = [&](auto* kernel) {
    cudaError_t e = configure(kernel, smem);
    return e == cudaSuccess ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                                  &n, kernel, kCols * kWarps, smem)
                            : e;
  };
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
