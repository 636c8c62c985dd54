// Structured DSS (direct stiffness summation) on the transposed [k, E16]
// layout of the ne x ne x 6 cubed sphere: four kernels.
//
// Replaces the Pallas kernels of tinman_sandbox_tpu/kernels/dss_pallas.py:
//   dss_extract  <- extract_tiles_t (:721) and extract_tiles_ct (:759);
//   dss_fixup    <- vals_to_vd_pallas (:1306) together with the XLA line
//                   math _fixup_from_rows (:890-929) that feeds it;
//   dss_sweep    <- dss_sweeps_pallas_t (:617) and dss_sweeps_pallas_ct
//                   (:1227), with their affine mix= epilogue; with the
//                   merge turned off (kMerge = false: no vd, no fix_col) it
//                   replaces the merge-free sweep dss_sweeps_pallas_nomerge
//                   (:335), whose fix lanes keep the in-face partial sums;
//   dss_patch    <- merge_patch_pallas (:1477): in place, each fix lane of
//                   a merge-free sweep's output w gets its fixup value
//                   (or ca*mx + cb*value), every other lane stays as it is;
//                   with shard-local fix lanes and a w (and mx) that may be
//                   taller than vd, whose further rows it never touches, it
//                   also replaces merge_patch_tiles (:251);
//   dss_sweep_banded <- dss_sweeps_banded_t (:428) and dss_sweeps_banded_ct
//                   (:544), and with the merge off dss_sweeps_banded_nomerge
//                   (:190): the sweep of the band-sharded multi-device DSS
//                   on one shard's chunks, each extended with its two
//                   neighbouring element rows [band | next | prev]
//                   (dss_sweep.cuh, swept4_banded), the chunk's place in its
//                   face given by a flag (first / last band) in place of the
//                   TPU's four precomputed lane masks.
// The TPU forms cut the lane axis into 128-lane tiles, padded the fix lanes
// to whole tiles or to per-tile slots, and placed them with one-hot matrix
// products. None of that is needed here: a thread reads the lane it wants.
//
// The sweep's algebra is in dss_sweep.cuh (shared with the ring-fused
// producers of caar.cu and tracer.cu). The merged sweep takes it at every
// lane except the 2,856 fix lanes of ne30 (cube-edge line interiors and cube
// corners), whose value is computed from the PRE-sweep field by the fixup:
//   v = (g[s0] + g[s1]) + (g[s2] + g[s3]),  then fmaf(v, hi, v*lo),
// with s0/s1 the lane and its in-face junction partner on its own line,
// s2/s3 the same on the paired line of the neighbouring face (read in
// reverse on a flipped edge), and for a cube corner (c0 + c1) + c2. An
// absent s1 or s3 (-1) adds nothing.
// With mix = (mx, ca, cb) the sweep stores ca*mx + cb*w (ca*mx + cb*v at a
// fix lane): two products, then their sum. That folds the Shu-Osher
// combinations of SSPRK3 and the hyperviscosity update x - step*lap into the
// sweep. mx may have more rows than x and the output may BE mx (in place):
// each thread reads and writes only its own element of mx, its partner reads
// go to x, and the grid covers x's rows only, so further rows of mx ride
// through untouched. The output must never alias x.
// mx may be bf16 (kMxBf, the `mx_bf16` argument of the sweep's launch; the
// merged sweep with mix only): the JAX package's full step under `bench
// --prim --storage` hands the unlimited tracer stages 2 and 3 of its first
// step a bf16 qdp as the mix field (dss_sweeps_pallas_ct, :1227). The kernel
// reads its 4 lanes as 8 bytes and upcasts them exactly, so the instance is
// bit for bit the f32 sweep on mx upcast; the output is f32 and never mx.
// Every add and product but the two-float scale's fmaf is rounded on its own
// (__fadd_rn / __fmul_rn, no FMA contraction) in the order of the JAX
// package, so each kernel equals its plain PyTorch version bit for bit and
// every alias of a shared dof ends with the same bits. The patch's value at
// a fix lane is the sweep's own fix-lane expression, so merge-free sweep +
// patch equals the merged sweep bit for bit.
//
// What bounds them on the H100: device-memory traffic. The sweep reads and
// writes the whole field once (199 MB at ne30 x 288 rows, ~0.06 ms at
// 3.35 TB/s); the fixup, the extraction and the patch move a ~3.3 MB slab
// each and are bound by launch latency. The banded sweep reads its x_ext
// once, the bands and their halo rows (112.8 MB over the 12 shards of
// ne30 x 288 rows with 2 bands a face), and writes the bands (99.5 MB):
// ~0.064 ms. It runs the sweep's design below on its chunks: the
// column-a-thread banded kernel it replaced (one lane a thread, two integer
// divisions a lane, scalar loads) ran at 3.6-4.2x its bound.
// The sweep: a thread owns an aligned group of 4 lanes (j = 0..3 of
// one i-row of an element) in one row and moves it as float4s. Every lane
// of a group shares i, ei and ej, so the thread decodes the group's
// partner offsets once (two divisions by ne for 4 outputs), reads its
// rspheremp rows and fix_col as float4 / int4, and issues all its loads
// before its sums: the group, its alpha partner group (the neighbouring
// float4), the beta partner of j = 3 (component 0 of the group 16*ne lanes
// on) and of j = 0 (component 3 of the group 16*ne lanes back) with their
// alpha partners, and with mix the mx group. The column-a-thread sweep it
// replaced ran at 3.7-3.9x its bound at every height: with 4 bytes a
// thread and three divisions an element it kept too few bytes in flight.
// What bounds this one is still the bytes in flight: registers are capped
// at 40 (__launch_bounds__(256, 6)) so that an SM holds 48 warps. On the
// H100, at a fixed 24 warps an SM, two rows a thread ran 15% faster than
// one, and reading the tables and decoding once for both rows bought
// nothing over doing it per row; one row at 48 warps beat every variant
// at 24 (experiments/kernel_variants.py). The beta partner reads hit L2:
// they are other blocks' groups. The extraction and the fixup turn 32x32
// tiles in shared memory, so that their slab accesses run along the level
// axis and their x or vd accesses along the lanes: the fixup with one
// thread an element of vd (u fastest) read each summand k floats apart, a
// 32-byte sector for every 4-byte load, and ran at 8x its bound (PERF.md
// row 21). The patch reads vd and writes the scattered fix lanes of w: at
// ne30 the 2,856 4-byte stores of a row touch 1,056 32-byte sectors (33.8
// KB for 11.4 KB of values), each a partial sector write, so its floor
// counts sectors, not bytes. Its grid is 2-D: fix lanes along x in
// ascending lane order (the slab's read_lanes, with their vd columns
// read_col), so a warp's stores fall on neighbouring sectors and the blocks
// in flight on a few neighbouring rows, and rows along y. A thread reads its
// lane and column once; its offsets are made by 64-bit multiplication (a
// flat element index would cost a 64-bit division and modulo an element,
// tens of instructions each). On the H100 ascending lanes and one row a
// thread measured faster than vals-column order and than several rows a
// thread. Offsets are size_t: 4*nlev*E16 exceeds 2^31 from ne ~ 160 on.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dss_sweep.cuh"

namespace {

// the sweep's plan (kernels/dss.py::sweep_plan mirrors it), the banded
// sweep's too: 256 lane groups of 4 lanes a block, one row a thread,
// registers capped (40) so that an SM holds kSweepBlocks blocks (48 warps)
constexpr int kSweepThreads = 256;
constexpr int kSweepBlocks = 6;
constexpr int kPatchLanes = 128;   // fix lanes of a patch block
constexpr int kMaxGridY = 65535;   // grid rows: the sweep's rows at most;
                                   // the patch loops over further rows
constexpr int kTile = 32;       // the extraction's and the fixup's tiles:
constexpr int kTileRows = 8;    // kTile x kTile, kTileRows thread rows

// out[row, l]: the swept, scaled value, or with kMerge at a fix lane the fix
// value vd[row, fix_col[l]]; with kMix ca*mx[row, l] + cb*that, mx bf16
// with kMxBf. out may be mx (f32), never x. Without kMerge vd and fix_col
// are not read.
// Thread g owns the aligned lane group l0 = 4g (j = 0..3 of one i-row of an
// element) in row blockIdx.y: it decodes the group's partner offsets, reads
// its rspheremp and fix_col, issues all its loads, then sums and stores
// (dss_sweep::swept4).
template <bool kMix, bool kMerge, bool kMxBf = false>
__global__ void __launch_bounds__(kSweepThreads, kSweepBlocks)
dss_sweep_kernel(const float* __restrict__ x, const float* __restrict__ rsp,
                 int nrsp, const float* __restrict__ vd, int nfix,
                 const int* __restrict__ fix_col, const void* mx, float ca,
                 float cb, float* out, int e16, int ne) {
  static_assert(kMix || !kMxBf, "a bf16 mix field needs the mix");
  const int g = blockIdx.x * kSweepThreads + threadIdx.x;
  const int l0 = 4 * g;
  if (l0 >= e16) return;
  const int e = g >> 2, i = g & 3, ei = e % ne, ej = (e / ne) % ne;
  const int rl = 16 * ne;
  const int da = (i == 3 && ei < ne - 1) ? 4 : (i == 0 && ei > 0) ? -4 : 0;
  const bool alpha = da != 0, up = ej < ne - 1, dn = ej > 0;
  const float4 hi = *reinterpret_cast<const float4*>(rsp + l0);
  const float4 lo = nrsp == 2
                        ? *reinterpret_cast<const float4*>(rsp + e16 + l0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  int4 fc = make_int4(-1, -1, -1, -1);
  if constexpr (kMerge) fc = *reinterpret_cast<const int4*>(fix_col + l0);
  const size_t row = blockIdx.y;
  const size_t o = row * e16 + l0;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // plain loads: forcing the read-only path (__ldg) slowed the
  // column-a-thread sweep
  const float* xr = x + o;
  const float4 c = *reinterpret_cast<const float4*>(xr);
  const float4 a = alpha ? *reinterpret_cast<const float4*>(xr + da) : zero4;
  float bu = 0.f, bua = 0.f, bd = 0.f, bda = 0.f;
  if (up) {
    bu = xr[rl];
    if (alpha) bua = xr[rl + da];
  }
  if (dn) {
    bd = xr[3 - rl];
    if (alpha) bda = xr[3 - rl + da];
  }
  float4 m = zero4;
  if constexpr (kMxBf) {
    // 4 bf16 lanes in one 8-byte load, upcast exactly
    const uint2 p = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(mx) + o);
    const float2 m01 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&p.x));
    const float2 m23 = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&p.y));
    m = make_float4(m01.x, m01.y, m23.x, m23.y);
  } else if constexpr (kMix) {
    m = *reinterpret_cast<const float4*>(static_cast<const float*>(mx) + o);
  }
  float4 w = dss_sweep::swept4(c, a, alpha, bu, bua, up, bd, bda, dn, hi, lo,
                               nrsp);
  if constexpr (kMerge) {
    const float* vr = vd + row * nfix;
    if (fc.x >= 0) w.x = vr[fc.x];
    if (fc.y >= 0) w.y = vr[fc.y];
    if (fc.z >= 0) w.z = vr[fc.z];
    if (fc.w >= 0) w.w = vr[fc.w];
  }
  if constexpr (kMix) {
    w.x = dss_sweep::mix(ca, m.x, cb, w.x);
    w.y = dss_sweep::mix(ca, m.y, cb, w.y);
    w.z = dss_sweep::mix(ca, m.z, cb, w.z);
    w.w = dss_sweep::mix(ca, m.w, cb, w.w);
  }
  *reinterpret_cast<float4*>(out + o) = w;
}

// The banded sweep: out[row, lo] for the shard lane lo = c*bl + L of chunk c,
// read from x_ext [k, nchunks*ext] (ext = bl + 32*ne); merge and mix as
// dss_sweep. A chunk's fix lanes are the fix lanes of the whole sphere that
// lie in it (W and E, and S in a face's first band, N in its last), whose
// vd column fix_col gives; the banded sweep of every other lane equals the
// whole sphere's sweep there bit for bit. The sweep's design: thread g owns
// the aligned group lo0 = 4g in row blockIdx.y (bl is a multiple of 16, so
// the group lies in one chunk, and ext a multiple of 4, so every x_ext row
// starts 16-byte aligned), decodes its chunk and partner offsets once,
// reads rspheremp, fix_col and the chunk flags once, issues all its loads
// (dss_sweep::swept4_banded), then sums and stores a float4.
template <bool kMix, bool kMerge>
__global__ void __launch_bounds__(kSweepThreads, kSweepBlocks)
dss_sweep_banded_kernel(const float* __restrict__ x_ext,
                        const float* __restrict__ rsp, int nrsp,
                        const float* __restrict__ vd, int nfix,
                        const int* __restrict__ fix_col,
                        const int* __restrict__ flags, const float* mx,
                        float ca, float cb, float* out, int lanes, int bl,
                        int nchunks, int ne) {
  const int g = blockIdx.x * kSweepThreads + threadIdx.x;
  const int lo0 = 4 * g;
  if (lo0 >= lanes) return;
  const int c = lo0 / bl, ext = bl + 32 * ne;
  const float4 hi = *reinterpret_cast<const float4*>(rsp + lo0);
  const float4 lo = nrsp == 2
                        ? *reinterpret_cast<const float4*>(rsp + lanes + lo0)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  int4 fc = make_int4(-1, -1, -1, -1);
  if constexpr (kMerge) fc = *reinterpret_cast<const int4*>(fix_col + lo0);
  const int f = flags[c];
  const size_t row = blockIdx.y;
  const size_t o = row * lanes + lo0;
  const float* xr = x_ext + (row * nchunks + c) * ext;
  const auto load4 = [xr](int l) {
    return *reinterpret_cast<const float4*>(xr + l);
  };
  const auto load = [xr](int l) { return xr[l]; };
  float4 m = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kMix) m = *reinterpret_cast<const float4*>(mx + o);
  float4 w = dss_sweep::swept4_banded(load4, load, lo0 - c * bl, ne, bl,
                                      f & 1, f & 2, hi, lo, nrsp);
  if constexpr (kMerge) {
    const float* vr = vd + row * nfix;
    if (fc.x >= 0) w.x = vr[fc.x];
    if (fc.y >= 0) w.y = vr[fc.y];
    if (fc.z >= 0) w.z = vr[fc.z];
    if (fc.w >= 0) w.w = vr[fc.w];
  }
  if constexpr (kMix) {
    w.x = dss_sweep::mix(ca, m.x, cb, w.x);
    w.y = dss_sweep::mix(ca, m.y, cb, w.y);
    w.z = dss_sweep::mix(ca, m.z, cb, w.z);
    w.w = dss_sweep::mix(ca, m.w, cb, w.w);
  }
  *reinterpret_cast<float4*>(out + o) = w;
}

// in place: w[row, lanes[p]] = vd[row, cols[p]] for each fix lane p, or with
// kMix ca*mx + cb*that at the same element, for the first k rows; every
// other element of w is left as it is. Thread (p, y) takes the p-th fix lane
// (ascending) in rows y, y + gridDim.y, ...
template <bool kMix>
__global__ void __launch_bounds__(kPatchLanes)
dss_patch_kernel(float* __restrict__ w, const float* __restrict__ vd,
                 const int* __restrict__ lanes,
                 const int* __restrict__ cols, int nfix,
                 const float* __restrict__ mx, float ca, float cb, int k,
                 int e16) {
  const int p = blockIdx.x * kPatchLanes + threadIdx.x;
  if (p >= nfix) return;
  const int lane = lanes[p], u = cols[p];
  for (int row = blockIdx.y; row < k; row += gridDim.y) {
    float v = vd[static_cast<size_t>(row) * nfix + u];
    const size_t o = static_cast<size_t>(row) * e16 + lane;
    if constexpr (kMix) v = dss_sweep::mix(ca, mx[o], cb, v);
    w[o] = v;
  }
}

// vd[row, u] for fix lane u = fix_lanes[u]: the line / corner sum of the
// slab rows src[u] = (s0, s1, s2, s3), scaled by the lane's rspheremp.
// A block takes a tile of kTile fix lanes x kTile rows: a warp sums one fix
// lane over 32 consecutive rows (each summand's slab row read along the
// level axis, 128 bytes a warp), the tile is turned in shared memory, and
// a warp stores one row of 32 consecutive vd columns.
__global__ void __launch_bounds__(kTile * kTileRows)
dss_fixup_kernel(const float* __restrict__ slab, const int4* __restrict__ src,
                 const int* __restrict__ fix_lanes,
                 const float* __restrict__ rsp, int nrsp, int e16,
                 float* __restrict__ vd, int nfix, int k) {
  __shared__ float tile[kTile][kTile + 1];
  const int u0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = row0 + tx;
  if (row < k) {
    for (int du = ty; du < kTile && u0 + du < nfix; du += kTileRows) {
      const int u = u0 + du;
      const int4 s = src[u];
      float za = slab[static_cast<size_t>(s.x) * k + row];
      if (s.y >= 0)
        za = __fadd_rn(za, slab[static_cast<size_t>(s.y) * k + row]);
      float zb = slab[static_cast<size_t>(s.z) * k + row];
      if (s.w >= 0)
        zb = __fadd_rn(zb, slab[static_cast<size_t>(s.w) * k + row]);
      tile[du][tx] = dss_sweep::scale(__fadd_rn(za, zb), rsp, nrsp, e16,
                                      fix_lanes[u]);
    }
  }
  __syncthreads();
  const int u = u0 + tx;
  if (u < nfix)
    for (int dr = ty; dr < kTile && row0 + dr < k; dr += kTileRows)
      vd[static_cast<size_t>(row0 + dr) * nfix + u] = tile[tx][dr];
}

// slab[r, row] = x[row, lanes[r]], through a 32x32 shared-memory tile
__global__ void dss_extract_kernel(const float* __restrict__ x,
                                   const int* __restrict__ lanes,
                                   float* __restrict__ slab, int n, int k,
                                   int e16) {
  __shared__ float tile[kTile][kTile + 1];
  const int r0 = blockIdx.x * kTile, row0 = blockIdx.y * kTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = r0 + tx;
  const int lane = r < n ? lanes[r] : 0;
  for (int dy = ty; dy < kTile; dy += kTileRows) {
    const int row = row0 + dy;
    if (r < n && row < k)
      tile[dy][tx] = x[static_cast<size_t>(row) * e16 + lane];
  }
  __syncthreads();
  for (int dy = ty; dy < kTile; dy += kTileRows) {
    const int rr = r0 + dy, row = row0 + tx;
    if (rr < n && row < k) slab[static_cast<size_t>(rr) * k + row] = tile[tx][dy];
  }
}

cudaError_t prepare(int device) { return cudaSetDevice(device); }

}  // namespace

extern "C" {

const char* dss_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each launch enqueues one kernel on `stream` and returns the cudaError_t of
// the launch. Pointers are device pointers of contiguous float32 / int32
// tensors; rsp holds nrsp (1 or 2) rows of e16 lanes. The sweep's mx is
// null (no mix) or a field of at least k rows; out may be mx; a null vd is
// the merge-free sweep (fix_col not read); mx_bf16 = 1: mx is a bf16 field
// of k rows, 8-byte aligned (the merged sweep only), never out. The
// patch's lanes are the nfix fix lanes ascending, cols the vd column of
// each, and its mx null or a field of at least k rows of e16 lanes that w
// does not overlap.

int dss_sweep_launch(const void* x, const void* rsp, int nrsp, const void* vd,
                     int nfix, const void* fix_col, const void* mx,
                     int mx_bf16, float ca, float cb, void* out, int k,
                     int e16, int ne, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  // float4 access needs whole groups and 16-byte aligned rows
  if (e16 % 16 || k < 1 || k > kMaxGridY ||
      (mx_bf16 && (!mx || !vd || mx == out)))
    return cudaErrorInvalidValue;
  const dim3 grid((e16 / 4 + kSweepThreads - 1) / kSweepThreads, k);
  auto* kernel = mx_bf16 ? dss_sweep_kernel<true, true, true>
                 : vd    ? (mx ? dss_sweep_kernel<true, true>
                               : dss_sweep_kernel<false, true>)
                         : (mx ? dss_sweep_kernel<true, false>
                               : dss_sweep_kernel<false, false>);
  kernel<<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rsp), nrsp,
      static_cast<const float*>(vd), nfix, static_cast<const int*>(fix_col),
      mx, ca, cb, static_cast<float*>(out), e16, ne);
  return cudaGetLastError();
}

// Blocks of the sweep kernel (merged or not, with or without mix; mix = 2
// the merged sweep with a bf16 mix field) that one SM holds, from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor; negative: a CUDA error.
int dss_sweep_blocks_per_sm(int merge, int mix, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  auto* kernel = mix == 2 ? dss_sweep_kernel<true, true, true>
                 : merge  ? (mix ? dss_sweep_kernel<true, true>
                                 : dss_sweep_kernel<false, true>)
                          : (mix ? dss_sweep_kernel<true, false>
                                 : dss_sweep_kernel<false, false>);
  int n = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel,
                                                      kSweepThreads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The banded sweep: x_ext holds k rows of nchunks*(bl + 32*ne) lanes, out
// and mx rows of lanes = nchunks*bl; flags[c] bit 0 / bit 1: chunk c is the
// first / last band of its face; a null vd is the merge-free sweep. bl must
// be a positive multiple of 16*ne (whole element rows), so its groups of 4
// lanes never straddle a chunk and every x_ext row is 16-byte aligned.
int dss_sweep_banded_launch(const void* x_ext, const void* rsp, int nrsp,
                            const void* vd, int nfix, const void* fix_col,
                            const void* flags, const void* mx, float ca,
                            float cb, void* out, int k, int lanes, int bl,
                            int nchunks, int ne, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  if (ne < 1 || bl < 16 * ne || bl % (16 * ne) || nchunks < 1 ||
      lanes != nchunks * bl || k < 1 || k > kMaxGridY)
    return cudaErrorInvalidValue;
  const dim3 grid((lanes / 4 + kSweepThreads - 1) / kSweepThreads, k);
  auto* kernel = vd ? (mx ? dss_sweep_banded_kernel<true, true>
                          : dss_sweep_banded_kernel<false, true>)
                    : (mx ? dss_sweep_banded_kernel<true, false>
                          : dss_sweep_banded_kernel<false, false>);
  kernel<<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x_ext), static_cast<const float*>(rsp), nrsp,
      static_cast<const float*>(vd), nfix, static_cast<const int*>(fix_col),
      static_cast<const int*>(flags), static_cast<const float*>(mx), ca, cb,
      static_cast<float*>(out), lanes, bl, nchunks, ne);
  return cudaGetLastError();
}

int dss_fixup_launch(const void* slab, const void* src, const void* fix_lanes,
                     const void* rsp, int nrsp, int e16, void* vd, int nfix,
                     int k, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  if (k < 1 || (k + kTile - 1) / kTile > kMaxGridY) return cudaErrorInvalidValue;
  const dim3 grid((nfix + kTile - 1) / kTile, (k + kTile - 1) / kTile);
  const dim3 block(kTile, kTileRows);
  dss_fixup_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const int4*>(src),
      static_cast<const int*>(fix_lanes), static_cast<const float*>(rsp),
      nrsp, e16, static_cast<float*>(vd), nfix, k);
  return cudaGetLastError();
}

int dss_patch_launch(void* w, const void* vd, const void* lanes,
                     const void* cols, int nfix, const void* mx, float ca,
                     float cb, int k, int e16, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((nfix + kPatchLanes - 1) / kPatchLanes,
                  k < kMaxGridY ? k : kMaxGridY);
  auto* kernel = mx ? dss_patch_kernel<true> : dss_patch_kernel<false>;
  kernel<<<grid, kPatchLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<const float*>(vd),
      static_cast<const int*>(lanes), static_cast<const int*>(cols), nfix,
      static_cast<const float*>(mx), ca, cb, k, e16);
  return cudaGetLastError();
}

int dss_extract_launch(const void* x, const void* lanes, void* slab, int n,
                       int k, int e16, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kTile - 1) / kTile, (k + kTile - 1) / kTile);
  const dim3 block(kTile, kTileRows);
  dss_extract_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(lanes),
      static_cast<float*>(slab), n, k, e16);
  return cudaGetLastError();
}

}  // extern "C"
