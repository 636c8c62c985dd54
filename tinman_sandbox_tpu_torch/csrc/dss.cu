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
//                   (dss_sweep.cuh, swept_banded), the chunk's place in its
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
//   v = (g[s0] + g[s1]) + (g[s2] + g[s3]),  then v*hi + v*lo,
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
// Every add and product is rounded on its own (__fadd_rn / __fmul_rn, no FMA
// contraction) in the order of the JAX package, so each kernel equals its
// plain PyTorch version bit for bit and every alias of a shared dof ends
// with the same bits. The patch's value at a fix lane is the sweep's own
// fix-lane expression, so merge-free sweep + patch equals the merged sweep
// bit for bit.
//
// What bounds them on the H100: device-memory traffic. The sweep reads and
// writes the whole field once (199 MB at ne30 x 288 rows, ~0.06 ms at
// 3.35 TB/s); the fixup, the extraction and the patch move a ~3.3 MB slab
// each and are bound by launch latency. The banded sweep reads its x_ext
// once, the bands and their halo rows (112.8 MB over the 12 shards of
// ne30 x 288 rows with 2 bands a face), and writes the bands (99.5 MB):
// ~0.064 ms. Design: one thread per output
// element; the sweep's threads run along lanes, so loads and stores
// coalesce, and the partner reads (4 and 16*ne-3 lanes away) hit lines
// already in cache;
// the extraction transposes 32x32 tiles through shared memory; the patch
// is one thread per (row, fix lane), reading vd coalesced and writing the
// scattered fix lanes of w. Offsets are size_t: 4*nlev*E16 exceeds 2^31
// from ne ~ 160 on.
#include <cuda_runtime.h>

#include "dss_sweep.cuh"

namespace {

constexpr int kSweepThreads = 256;
constexpr int kFixupThreads = 256;
constexpr int kPatchThreads = 256;
constexpr int kTile = 32;
constexpr int kTileRows = 8;

// out[row, l]: the swept, scaled value, or with kMerge at a fix lane the fix
// value vd[row, fix_col[l]]; with kMix ca*mx[row, l] + cb*that. out may be
// mx, never x. Without kMerge vd and fix_col are not read.
template <bool kMix, bool kMerge>
__global__ void __launch_bounds__(kSweepThreads)
dss_sweep_kernel(const float* __restrict__ x, const float* __restrict__ rsp,
                 int nrsp, const float* __restrict__ vd, int nfix,
                 const int* __restrict__ fix_col, const float* mx, float ca,
                 float cb, float* out, int e16, int ne) {
  const int l = blockIdx.x * kSweepThreads + threadIdx.x;
  if (l >= e16) return;
  const size_t row = blockIdx.y;
  const float* xr = x + row * e16;
  float res;
  int c = -1;
  if constexpr (kMerge) c = fix_col[l];
  if (c >= 0) {
    res = vd[row * nfix + c];
  } else {
    // plain loads: forcing the read-only path (__ldg) slowed the sweep
    const auto load = [xr](int i) { return xr[i]; };
    res = dss_sweep::swept(load, l, ne, rsp, nrsp, e16);
  }
  const size_t o = row * e16 + l;
  if constexpr (kMix) res = dss_sweep::mix(ca, mx[o], cb, res);
  out[o] = res;
}

// The banded sweep: out[row, lo] for the shard lane lo = c*bl + L of chunk c,
// read from x_ext [k, nchunks*(bl + 2*rl)]; merge and mix as dss_sweep. A
// chunk's fix lanes are the fix lanes of the whole sphere that lie in it
// (W and E, and S in a face's first band, N in its last), whose vd column
// fix_col gives; the banded sweep of every other lane equals the whole
// sphere's sweep there bit for bit.
template <bool kMix, bool kMerge>
__global__ void __launch_bounds__(kSweepThreads)
dss_sweep_banded_kernel(const float* __restrict__ x_ext,
                        const float* __restrict__ rsp, int nrsp,
                        const float* __restrict__ vd, int nfix,
                        const int* __restrict__ fix_col,
                        const int* __restrict__ flags, const float* mx,
                        float ca, float cb, float* out, int lanes, int bl,
                        int nchunks, int ne) {
  const int lo = blockIdx.x * kSweepThreads + threadIdx.x;
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
    res = dss_sweep::swept_banded(load, lo - c * bl, ne, bl, f & 1, f & 2,
                                  rsp, nrsp, lanes, lo);
  }
  const size_t o = row * lanes + lo;
  if constexpr (kMix) res = dss_sweep::mix(ca, mx[o], cb, res);
  out[o] = res;
}

// in place: w[row, fix_lanes[u]] = vd[row, u], or with kMix ca*mx + cb*that
// at the same element; every other element of w is left as it is
template <bool kMix>
__global__ void __launch_bounds__(kPatchThreads)
dss_patch_kernel(float* __restrict__ w, const float* __restrict__ vd,
                 const int* __restrict__ fix_lanes, int nfix,
                 const float* __restrict__ mx, float ca, float cb, int k,
                 int e16) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kPatchThreads +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(nfix) * k) return;
  const int u = static_cast<int>(idx % nfix);
  const size_t row = idx / nfix;
  const size_t o = row * e16 + fix_lanes[u];
  float res = vd[idx];
  if constexpr (kMix) res = dss_sweep::mix(ca, mx[o], cb, res);
  w[o] = res;
}

// vd[row, u] for fix lane u = fix_lanes[u]: the line / corner sum of the
// slab rows src[u] = (s0, s1, s2, s3), scaled by the lane's rspheremp
__global__ void __launch_bounds__(kFixupThreads)
dss_fixup_kernel(const float* __restrict__ slab, const int4* __restrict__ src,
                 const int* __restrict__ fix_lanes,
                 const float* __restrict__ rsp, int nrsp, int e16,
                 float* __restrict__ vd, int nfix, int k) {
  const size_t idx = static_cast<size_t>(blockIdx.x) * kFixupThreads +
                     threadIdx.x;
  if (idx >= static_cast<size_t>(nfix) * k) return;
  const int u = static_cast<int>(idx % nfix);
  const size_t row = idx / nfix;
  const int4 s = src[u];
  float za = slab[static_cast<size_t>(s.x) * k + row];
  if (s.y >= 0) za = __fadd_rn(za, slab[static_cast<size_t>(s.y) * k + row]);
  float zb = slab[static_cast<size_t>(s.z) * k + row];
  if (s.w >= 0) zb = __fadd_rn(zb, slab[static_cast<size_t>(s.w) * k + row]);
  vd[idx] = dss_sweep::scale(__fadd_rn(za, zb), rsp, nrsp, e16,
                             fix_lanes[u]);
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
// the merge-free sweep (fix_col not read). The patch's mx is null or a
// field of w's [k, e16] that w does not overlap.

int dss_sweep_launch(const void* x, const void* rsp, int nrsp, const void* vd,
                     int nfix, const void* fix_col, const void* mx, float ca,
                     float cb, void* out, int k, int e16, int ne,
                     void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((e16 + kSweepThreads - 1) / kSweepThreads, k);
  auto* kernel = vd ? (mx ? dss_sweep_kernel<true, true>
                          : dss_sweep_kernel<false, true>)
                    : (mx ? dss_sweep_kernel<true, false>
                          : dss_sweep_kernel<false, false>);
  kernel<<<grid, kSweepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(rsp), nrsp,
      static_cast<const float*>(vd), nfix, static_cast<const int*>(fix_col),
      static_cast<const float*>(mx), ca, cb, static_cast<float*>(out), e16,
      ne);
  return cudaGetLastError();
}

// The banded sweep: x_ext holds k rows of nchunks*(bl + 32*ne) lanes, out
// and mx rows of lanes = nchunks*bl; flags[c] bit 0 / bit 1: chunk c is the
// first / last band of its face; a null vd is the merge-free sweep.
int dss_sweep_banded_launch(const void* x_ext, const void* rsp, int nrsp,
                            const void* vd, int nfix, const void* fix_col,
                            const void* flags, const void* mx, float ca,
                            float cb, void* out, int k, int lanes, int bl,
                            int nchunks, int ne, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  const dim3 grid((lanes + kSweepThreads - 1) / kSweepThreads, k);
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
  const size_t total = static_cast<size_t>(nfix) * k;
  const unsigned grid =
      static_cast<unsigned>((total + kFixupThreads - 1) / kFixupThreads);
  dss_fixup_kernel<<<grid, kFixupThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<const int4*>(src),
      static_cast<const int*>(fix_lanes), static_cast<const float*>(rsp),
      nrsp, e16, static_cast<float*>(vd), nfix, k);
  return cudaGetLastError();
}

int dss_patch_launch(void* w, const void* vd, const void* fix_lanes,
                     int nfix, const void* mx, float ca, float cb, int k,
                     int e16, void* stream, int device) {
  cudaError_t err = prepare(device);
  if (err != cudaSuccess) return err;
  const size_t total = static_cast<size_t>(nfix) * k;
  const unsigned grid =
      static_cast<unsigned>((total + kPatchThreads - 1) / kPatchThreads);
  auto* kernel = mx ? dss_patch_kernel<true> : dss_patch_kernel<false>;
  kernel<<<grid, kPatchThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(w), static_cast<const float*>(vd),
      static_cast<const int*>(fix_lanes), nfix,
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
