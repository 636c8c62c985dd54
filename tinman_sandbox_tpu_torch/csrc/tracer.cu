// Tracer advection on the packed layouts. On [qsize*nlev, E16], all tracers
// on the row axis (row = tracer*nlev + level), two kernels:
//
//   tracer_euler_kernel:  out = sph * (q - dt * div(v q))      (or without sph)
//   tracer_limit_kernel:  e = q - dt * div(v q);  y = e  or  ca*mx + cb*e;
//                         y = L(y, bounds(q));  out = sph * y
//
// with div(v q) = (D_x(gv1) + D_y(gv2)) * rmetdet * rrearth,
// gv1 = metdet*(dinv00*vu*q + dinv01*vv*q), gv2 alike (EulerStepFunctor.hpp:
// 33-69, SphereOperators.hpp:362-403), and L the element-local monotone
// mass-conserving limiter (HOMME limiter8 analog): clamp y into the extrema
// of the stage input q over the element's 16 nodes while conserving
// sum(sph*y), by redistribution into the room that is left.
//
// Replaces the Pallas kernels of tinman_sandbox_tpu/kernels/tracer_pallas_t.py:
// tracer_euler_pallas_packed_t (:404), tracer_euler_pallas_packed_t_lg (:507)
// and tracer_euler_pallas_packed_t_ext (:674), body _tracer_kernel_t
// (:195-251), by the first kernel; tracer_limit_pallas_packed_t_ext (:322),
// body _tracer_limit_kernel_t (:254-317) with the limiter _limit_lanes
// (:145-192), by the second. The TPU forms differ in how the grid cuts lanes
// and rows for VMEM and in the layout of the fix-lane slab; their 128x128
// block-diagonal derivative operands, bf16 limb splits and one-hot group
// tables fed a matrix unit. Here the 4x4 Dvv is contracted with FP32 FMAs
// and the group reductions are shuffles.
//
// What bounds them on the H100: device-memory traffic. A stage reads the
// tracer block (and mx), two wind blocks and 7 meta rows and writes the
// tracer block (plus the slab): at ne30 x 72 about 100 MB for one tracer and
// 1.8-2.7 GB for 35, against ~40 (Euler) to ~150 (limited) FP32 operations
// a point.
//
// Design: no level and no tracer couples to another, so a thread owns one
// lane of E16 and a chunk of kLevels levels, over which it keeps its 7
// metric values in registers. The tracer loop is INSIDE the level loop, so
// the two winds of a (level, lane) are read once and serve every tracer.
// The 16 lanes of an element sit in one half-warp. Each (level, tracer)
// takes one exchange among them through shared memory for the derivative
// contractions, fenced by one __syncwarp (an element never spans two warps);
// the exchange buffers alternate, so an iteration's write cannot overtake the
// previous iteration's reads. The limiter's group minimum, maximum and sums
// are __shfl_xor_sync butterflies of width 16: every lane of the element
// gets the same bits, in a fixed order, with no atomics and no second pass
// over memory. The deficit is summed from the clipped-off amounts
// w*(y - clip(y)) themselves, never as a difference of two masses, which
// would cancel. Divisions are __fdiv_rn; a uniform element has no room
// (tot = 0): give = 0 and the coefficient is 0 / FLT_MIN = 0, no NaN.
// The winds are read out of taller tensors (the [4*nlev] prognostic state)
// by row-block offset, with no slice copy.
// Optional fix-lane slab, as the CAAR kernel's: the thread owning a lane
// with fix_rank[lane] = r >= 0 also writes its output at every row to
// slab[r*nq*nlev + row].
// Ring-fused mode (tracer_ring_kernel): replaces tracer_ring_packed_t of
// tinman_sandbox_tpu/kernels/ring_fused.py (:369, body _tracer_ring_kernel
// :303), the folded Euler stage and the rspheremp-scaled sweep of its output
// in one launch, with the sweep's mix epilogue. A block runs euler_tile (the
// Euler kernel's code, so the same bits) for one tile of 128 lanes and one
// chunk of kLevels levels into a scratch, flags it and sweeps the tile
// `halo` tiles behind it in the same chunk (ring.cuh, dss_sweep.cuh). At
// qsize 35 the stack is [2520, 86400]: 9 chunks x (675 + 4) blocks keep the
// card busy where one chunk a block would not. The fix lanes keep their
// in-face partial sums for the fixup and the patch (dss.cu).
//
// On the row layout [E16, qsize*nlev] (tracer-major on the contiguous axis,
// column j = tracer*nlev + level) a third kernel:
//
//   tracer_row_kernel:    out = q - dt * div(v q)
//
// replaces euler_step_pallas_packed of tinman_sandbox_tpu/kernels/
// tracer_pallas.py (:61, body _tracer_kernel :30-57), whose 128x128
// block-diagonal operators fed the matrix unit with a qsize-times wider
// right-hand side. Bound by bytes as the others: q read, out written, the
// two [E16, nlev] wind blocks and 6 metric values a point, against ~30 FP32
// operations a point. Design: a block holds ONE element and a chunk of the
// q*nlev columns, one thread per column, so each of the element's 16 rows
// is read and written by neighbouring threads at neighbouring addresses
// (coalesced). The Dvv exchange is per element and a thread holds all 16
// GLL points of its column, so the contractions run in registers with no
// shared-memory exchange and no barrier after the metric load. The winds at
// level j mod nlev broadcast over the tracers (neighbouring columns of one
// tracer read neighbouring wind addresses; other tracers hit the cache).
#include <cfloat>
#include <cuda_runtime.h>

#include "ring.cuh"

namespace {

constexpr int kBlock = 128;   // 8 elements x 16 GLL points
constexpr int kLevels = 8;    // levels walked by one block
constexpr unsigned kFull = 0xffffffffu;

// META_COLS row indices (kernels/layout.py)
enum Meta {
  kDinv00 = 0, kDinv01, kDinv10, kDinv11, kMetdet = 8, kRmetdet = 9,
  kSpheremp = 11
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

// reductions over the 16 lanes of an element (a half-warp): every lane gets
// the same bits
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

// The per-thread constants of one launch: the lane's metric values, its
// place in its element and its slab row.
struct Lane {
  float dinv00, dinv01, dinv10, dinv11, metdet, rmr, sph;
  int tid, col, eb, li, lj;
  bool live;
  float* slab_row;            // null: no slab row for this lane
};

__device__ __forceinline__ Lane load_lane(const float* __restrict__ meta,
                                          const int* __restrict__ fix_rank,
                                          float* __restrict__ slab, int ncol,
                                          size_t ldz, int nrows, float rr,
                                          int tile) {
  Lane t;
  t.tid = threadIdx.x;
  t.col = tile * kBlock + t.tid;
  t.live = t.col < ncol;                  // ncol % 16 == 0: whole elements
  t.eb = t.tid & ~15;                     // element's first lane in block
  t.li = (t.tid & 15) >> 2;               // lane = li*4 + lj
  t.lj = t.tid & 3;
  auto m = [&](int r) { return t.live ? meta[r * ldz + t.col] : 1.f; };
  t.dinv00 = m(kDinv00); t.dinv01 = m(kDinv01);
  t.dinv10 = m(kDinv10); t.dinv11 = m(kDinv11);
  t.metdet = m(kMetdet);
  t.rmr = m(kRmetdet) * rr;
  t.sph = m(kSpheremp);
  const int srow = (t.live && fix_rank) ? fix_rank[t.col] : -1;
  t.slab_row = srow >= 0 ? slab + static_cast<size_t>(srow) * nrows : nullptr;
  return t;
}

// e = q - dt * div(v q) at this lane; xs is the iteration's exchange buffer
// [2][kBlock]. Every thread of the warp must call it (it fences the warp).
__device__ __forceinline__ float advect(const Lane& t, const float* dvv,
                                        float (*xs)[kBlock], float u, float v,
                                        float q, float dt) {
  const float vq1 = u * q, vq2 = v * q;
  xs[0][t.tid] = t.metdet * (t.dinv00 * vq1 + t.dinv01 * vq2);
  xs[1][t.tid] = t.metdet * (t.dinv10 * vq1 + t.dinv11 * vq2);
  __syncwarp();
  const float div = (dx(dvv, xs[0] + t.eb, t.li, t.lj) +
                     dy(dvv, xs[1] + t.eb, t.li, t.lj)) * t.rmr;
  return q - dt * div;
}

// The Euler stage for the 128 lanes of tile `tile` and the levels of row
// chunk `chunk`, by the calling block, with the block's shared exchange
// buffers xs and dvv. The Euler kernel and the ring kernel both call it, so
// both produce the same bits.
__device__ __forceinline__ void euler_tile(
    const float* __restrict__ meta, const float* __restrict__ dvv_g,
    const float* __restrict__ vu, const float* __restrict__ vv,
    const float* __restrict__ q, float* __restrict__ out,
    const int* __restrict__ fix_rank, float* __restrict__ slab, int nlev,
    int nq, int ncol, int ld, int fold_sph, float dt, float rr, int tile,
    int chunk, float (*xs)[2][kBlock], float* dvv) {
  const size_t ldz = static_cast<size_t>(ld);
  if (threadIdx.x < 16) dvv[threadIdx.x] = dvv_g[threadIdx.x];
  const Lane t = load_lane(meta, fix_rank, slab, ncol, ldz, nq * nlev, rr,
                           tile);
  const float wout = fold_sph ? t.sph : 1.f;
  __syncthreads();

  const int k0 = chunk * kLevels;
  const int k1 = min(k0 + kLevels, nlev);
  int it = 0;
  for (int k = k0; k < k1; ++k) {
    float u = 0.f, v = 0.f;
    if (t.live) { u = vu[k * ldz + t.col]; v = vv[k * ldz + t.col]; }
    for (int n = 0; n < nq; ++n, ++it) {
      const int row = n * nlev + k;
      const size_t o = row * ldz + t.col;
      const float qv = t.live ? q[o] : 0.f;
      const float res = wout * advect(t, dvv, xs[it & 1], u, v, qv, dt);
      if (t.live) {
        out[o] = res;
        if (t.slab_row) t.slab_row[row] = res;
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
tracer_euler_kernel(const float* __restrict__ meta,
                    const float* __restrict__ dvv_g,
                    const float* __restrict__ vu, const float* __restrict__ vv,
                    const float* __restrict__ q, float* __restrict__ out,
                    const int* __restrict__ fix_rank, float* __restrict__ slab,
                    int nlev, int nq, int ncol, int ld, int fold_sph, float dt,
                    float rr) {
  __shared__ float xs[2][2][kBlock];      // alternating exchange buffers
  __shared__ float dvv[16];
  euler_tile(meta, dvv_g, vu, vv, q, out, fix_rank, slab, nlev, nq, ncol, ld,
             fold_sph, dt, rr, blockIdx.x, blockIdx.y, xs, dvv);
}

// The ring-fused Euler stage: per row chunk of kLevels levels (all tracers
// of those levels), the tile schedule of ring.cuh. Ticket t is chunk
// t / (nb + halo) and place p = t % (nb + halo) in it: p < nb produces tile
// p of the chunk into the scratch r.s1 (and the slab), then the block
// sweeps tile p - halo of the chunk, waiting on its own chunk's flags only.
// nchunk * (nb + halo) blocks.
template <bool kMix>
__global__ void __launch_bounds__(kBlock)
tracer_ring_kernel(const float* __restrict__ meta,
                   const float* __restrict__ dvv_g,
                   const float* __restrict__ vu, const float* __restrict__ vv,
                   const float* __restrict__ q, const int* __restrict__ fix_rank,
                   float* __restrict__ slab, int nlev, int nq, int ncol,
                   float dt, float rr, ring::Args r) {
  __shared__ float xs[2][2][kBlock];
  __shared__ float dvv[16];
  const int t = ring::ticket(r.counter);
  const int per = r.nb + r.halo;
  const int chunk = t / per, p = t % per;
  unsigned* flags = r.flags + static_cast<size_t>(chunk) * r.nb;
  if (p < r.nb) {
    euler_tile(meta, dvv_g, vu, vv, q, const_cast<float*>(r.s1), fix_rank,
               slab, nlev, nq, ncol, ncol, 1, dt, rr, p, chunk, xs, dvv);
    ring::publish(flags + p, r.epoch);
  }
  const int j = p - r.halo;
  if (j < 0) return;
  const int after = ring::wait(flags, max(j - r.halo, 0),
                               min(j + r.halo, r.nb - 1), r.epoch);
  const int l = j * kBlock + threadIdx.x;
  if (l >= ncol) return;
  const int k0 = chunk * kLevels;
  const int k1 = min(k0 + kLevels, nlev);
  for (int n = 0; n < nq; ++n)
    ring::emit<kMix>(r, after, static_cast<size_t>(n) * nlev + k0, k1 - k0, l,
                     ncol);
}

template <bool kMix>
__global__ void __launch_bounds__(kBlock)
tracer_limit_kernel(const float* __restrict__ meta,
                    const float* __restrict__ dvv_g,
                    const float* __restrict__ vu, const float* __restrict__ vv,
                    const float* __restrict__ q, const float* __restrict__ mx,
                    float* __restrict__ out, const int* __restrict__ fix_rank,
                    float* __restrict__ slab, int nlev, int nq, int ncol,
                    int ld, int iters, float dt, float ca, float cb,
                    float rr) {
  __shared__ float xs[2][2][kBlock];      // alternating exchange buffers
  __shared__ float dvv[16];
  const size_t ldz = static_cast<size_t>(ld);
  if (threadIdx.x < 16) dvv[threadIdx.x] = dvv_g[threadIdx.x];
  const Lane t = load_lane(meta, fix_rank, slab, ncol, ldz, nq * nlev, rr,
                           blockIdx.x);
  const float w = t.sph;
  const float wsum = gsum(w);
  __syncthreads();

  const int k0 = blockIdx.y * kLevels;
  const int k1 = min(k0 + kLevels, nlev);
  int it = 0;
  for (int k = k0; k < k1; ++k) {
    float u = 0.f, v = 0.f;
    if (t.live) { u = vu[k * ldz + t.col]; v = vv[k * ldz + t.col]; }
    for (int n = 0; n < nq; ++n, ++it) {
      const int row = n * nlev + k;
      const size_t o = row * ldz + t.col;
      const float qv = t.live ? q[o] : 0.f;
      float y = advect(t, dvv, xs[it & 1], u, v, qv, dt);
      if constexpr (kMix) y = ca * (t.live ? mx[o] : 0.f) + cb * y;

      // the limiter: bounds from the stage input, weights sph
      const float qmin = gmin(qv), qmax = gmax(qv);
      const float mass = gsum(w * y);
      float carry = 0.f;
      for (int i = 0; i < iters; ++i) {
        const float yc = fminf(fmaxf(y, qmin), qmax);
        // the deficit from the clipped-off amounts: no cancellation
        const float d = gsum(w * (y - yc)) + carry;
        const bool pos = d > 0.f;
        const float bsel = pos ? qmax : qmin;
        const float tot = gsum(w * (pos ? qmax - yc : yc - qmin));
        const float give = pos ? fminf(d, tot) : fmaxf(d, -tot);
        carry = d - give;
        const float c = __fdiv_rn(give, fmaxf(tot, FLT_MIN));
        y = yc + fabsf(c) * (bsel - yc);
      }
      // what the bounds could not take is spread uniformly by weight
      y += __fdiv_rn(mass - gsum(w * y), wsum);

      const float res = w * y;
      if (t.live) {
        out[o] = res;
        if (t.slab_row) t.slab_row[row] = res;
      }
    }
  }
}

constexpr int kRowThreads = 128;   // most columns a row-kernel block holds

__global__ void __launch_bounds__(kRowThreads)
tracer_row_kernel(const float* __restrict__ meta,
                  const float* __restrict__ dvv_g,
                  const float* __restrict__ vu, const float* __restrict__ vv,
                  const float* __restrict__ q, float* __restrict__ out,
                  int nlev, int qk, float dt, float rr) {
  // the element's metric values by GLL point: dinv00, dinv01, dinv10,
  // dinv11, metdet, rmetdet*rrearth
  __shared__ float mt[6][16];
  __shared__ float dvv[16];
  const int tid = threadIdx.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * 16;  // element row
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
    g1[p] = mt[4][p] * (mt[0][p] * vq1 + mt[1][p] * vq2);
    g2[p] = mt[4][p] * (mt[2][p] * vq1 + mt[3][p] * vq2);
  }
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    const float div =
        (dx(dvv, g1, p >> 2, p & 3) + dy(dvv, g2, p >> 2, p & 3)) * mt[5][p];
    out[(base + p) * qk + j] = qv[p] - dt * div;
  }
}

}  // namespace

extern "C" {

const char* tracer_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each launch enqueues one kernel on `stream` and returns the cudaError_t of
// the launch. Pointers are device pointers of contiguous float32 / int32
// tensors of leading dimension ld; q, mx and out hold nq*nlev rows; the winds
// are the nlev rows of vu from row wu*nlev and of vv from row wv*nlev.
// fix_rank and slab may be null (no slab output); mx may be null (no
// combination: y = e).

int tracer_euler_launch(const void* meta, const void* dvv, const void* vu,
                        const void* vv, const void* q, void* out,
                        const void* fix_rank, void* slab, int nlev, int nq,
                        int ncol, int ld, int wu, int wv, int fold_sph,
                        float dt, float rrearth, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t blk = static_cast<size_t>(nlev) * ld;
  const dim3 grid((ncol + kBlock - 1) / kBlock,
                  (nlev + kLevels - 1) / kLevels);
  tracer_euler_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(vu) + wu * blk,
      static_cast<const float*>(vv) + wv * blk, static_cast<const float*>(q),
      static_cast<float*>(out), static_cast<const int*>(fix_rank),
      static_cast<float*>(slab), nlev, nq, ncol, ld, fold_sph, dt, rrearth);
  return cudaGetLastError();
}

// The row kernel: meta [ncol, 16], vu and vv [ncol, nlev], q and out
// [ncol, qk] with qk = nq*nlev, all contiguous.
int tracer_row_launch(const void* meta, const void* dvv, const void* vu,
                      const void* vv, const void* q, void* out, int nlev,
                      int qk, int ncol, float dt, float rrearth, void* stream,
                      int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int warps32 = (qk + 31) / 32 * 32;
  const int threads = warps32 < kRowThreads ? warps32 : kRowThreads;
  const dim3 grid(ncol / 16, (qk + threads - 1) / threads);
  tracer_row_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(vu), static_cast<const float*>(vv),
      static_cast<const float*>(q), static_cast<float*>(out), nlev, qk, dt,
      rrearth);
  return cudaGetLastError();
}

int tracer_limit_launch(const void* meta, const void* dvv, const void* vu,
                        const void* vv, const void* q, const void* mx,
                        void* out, const void* fix_rank, void* slab, int nlev,
                        int nq, int ncol, int ld, int wu, int wv, int iters,
                        float dt, float ca, float cb, float rrearth,
                        void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t blk = static_cast<size_t>(nlev) * ld;
  const dim3 grid((ncol + kBlock - 1) / kBlock,
                  (nlev + kLevels - 1) / kLevels);
  auto* kernel = mx ? tracer_limit_kernel<true> : tracer_limit_kernel<false>;
  kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(vu) + wu * blk,
      static_cast<const float*>(vv) + wv * blk, static_cast<const float*>(q),
      static_cast<const float*>(mx), static_cast<float*>(out),
      static_cast<const int*>(fix_rank), static_cast<float*>(slab), nlev, nq,
      ncol, ld, iters, dt, ca, cb, rrearth);
  return cudaGetLastError();
}

// The ring-fused Euler stage (sph folded in, with the slab) on `stream`: a
// 4-byte memset of the ticket counter, then one kernel of
// ceil(nlev / kLevels) * (nb + halo) blocks. s1 is the [nq*nlev, ncol]
// scratch, w the swept output, mx null (no mix) or of w's shape; flags hold
// nflags >= ceil(nlev / kLevels) * nb entries.
int tracer_ring_launch(const void* meta, const void* dvv, const void* vu,
                       const void* vv, const void* q, void* s1,
                       const void* fix_rank, void* slab, const void* rsp,
                       const void* mx, void* w, void* flags, void* counter,
                       unsigned epoch, int nflags, int nlev, int nq, int ncol,
                       int wu, int wv, int nrsp, int ne, int halo, float dt,
                       float rrearth, float ca, float cb, void* stream,
                       int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int nb = (ncol + kBlock - 1) / kBlock;
  const int nchunk = (nlev + kLevels - 1) / kLevels;
  if (fix_rank == nullptr || epoch == 0 ||
      !ring::fits(nchunk * nb, nflags, ne, halo, kBlock))
    return cudaErrorInvalidValue;
  const size_t blk = static_cast<size_t>(nlev) * ncol;
  ring::Args r = {};
  r.s1 = static_cast<const float*>(s1);
  r.rsp = static_cast<const float*>(rsp);
  r.mx = static_cast<const float*>(mx);
  r.w = static_cast<float*>(w);
  r.flags = static_cast<unsigned*>(flags);
  r.counter = static_cast<int*>(counter);
  r.epoch = epoch;
  r.nrsp = nrsp;
  r.ne = ne;
  r.nb = nb;
  r.halo = halo;
  r.ca = ca;
  r.cb = cb;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counter, 0, sizeof(int), st);
  if (err != cudaSuccess) return err;
  auto* kernel = mx ? tracer_ring_kernel<true> : tracer_ring_kernel<false>;
  kernel<<<nchunk * (r.nb + halo), kBlock, 0, st>>>(
      static_cast<const float*>(meta), static_cast<const float*>(dvv),
      static_cast<const float*>(vu) + wu * blk,
      static_cast<const float*>(vv) + wv * blk, static_cast<const float*>(q),
      static_cast<const int*>(fix_rank), static_cast<float*>(slab), nlev, nq,
      ncol, dt, rrearth, r);
  return cudaGetLastError();
}

// Blocks of the Euler kernel (fused = 0) or of the ring kernel without mix
// (fused = 1) that one SM holds, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a CUDA error.
int tracer_blocks_per_sm(int fused, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  int n = 0;
  err = fused ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, tracer_ring_kernel<false>, kBlock, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &n, tracer_euler_kernel, kBlock, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // extern "C"
