// Variants of the DSS extract (tinman_sandbox_tpu_torch/csrc/dss.cu,
// dss_extract_kernel) for experiments/kernel_variants.py (group extract):
//   slab[r, row] = x[row, lanes[r]],  x [k, e16], lanes ascending [n].
// Every variant moves the same floats, so each equals dss_extract_plain bit
// for bit; they differ in how a block's loads are cut and in flight:
//   0 the kernel before its redesign, as it was: tiles of 32 lanes x 32
//     rows, 8 thread rows (4 loads a thread), turned in shared memory;
//   7 as 0 with the loads in a loop of fixed count (as every variant below:
//     the thread's loads issued together before the first shared store);
//   1 tiles of 32 lanes x 64 rows, 8 thread rows (8 loads a thread);
//   2 tiles of 32 lanes x 32 rows, 4 thread rows (8 loads a thread, 128
//     threads a block);
//   3 as 0, the loads cached in L2 only (ld.global.cg: no L1 line);
//   4 as 0 on a grid of one wave (the blocks an SM cudaOccupancy gives x
//     the SMs), each block walking the tiles with the grid's stride;
//   5 tiles of 32 lanes x 128 rows, 8 thread rows (16 loads a thread);
//   6 as 1 on a grid of one wave.
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;

// variant 0: dss_extract_kernel before its redesign, verbatim
__global__ void extract_old(const float* __restrict__ x,
                            const int* __restrict__ lanes,
                            float* __restrict__ slab, int n, int k, int e16) {
  __shared__ float tile[kLanes][kLanes + 1];
  const int r0 = blockIdx.x * kLanes, row0 = blockIdx.y * kLanes;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = r0 + tx;
  const int lane = r < n ? lanes[r] : 0;
  for (int dy = ty; dy < kLanes; dy += 8) {
    const int row = row0 + dy;
    if (r < n && row < k)
      tile[dy][tx] = x[static_cast<size_t>(row) * e16 + lane];
  }
  __syncthreads();
  for (int dy = ty; dy < kLanes; dy += 8) {
    const int rr = r0 + dy, row = row0 + tx;
    if (rr < n && row < k) slab[static_cast<size_t>(rr) * k + row] = tile[tx][dy];
  }
}

template <int kRows, int kThreadRows, bool kCg>
__device__ __forceinline__ void tile(const float* __restrict__ x,
                                     const int* __restrict__ lanes,
                                     float* __restrict__ slab, int n, int k,
                                     int e16, int r0, int row0,
                                     float (*sm)[kLanes + 1]) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = r0 + tx;
  const int lane = r < n ? lanes[r] : 0;
#pragma unroll
  for (int i = 0; i < kRows / kThreadRows; ++i) {
    const int dy = ty + i * kThreadRows, row = row0 + dy;
    if (r < n && row < k) {
      const float* p = x + static_cast<size_t>(row) * e16 + lane;
      sm[dy][tx] = kCg ? __ldcg(p) : *p;
    }
  }
  __syncthreads();
  // the tile turned: 32 rows of one slab row r a warp, contiguous
  for (int c = ty; c < kLanes * (kRows / kLanes); c += kThreadRows) {
    const int rr = r0 + c % kLanes;
    const int dy = c / kLanes * kLanes + tx;
    const int row = row0 + dy;
    if (rr < n && row < k)
      slab[static_cast<size_t>(rr) * k + row] = sm[dy][c % kLanes];
  }
}

template <int kRows, int kThreadRows, bool kCg>
__global__ void __launch_bounds__(kLanes * kThreadRows)
extract_tiled(const float* __restrict__ x, const int* __restrict__ lanes,
              float* __restrict__ slab, int n, int k, int e16) {
  __shared__ float sm[kRows][kLanes + 1];
  tile<kRows, kThreadRows, kCg>(x, lanes, slab, n, k, e16,
                                blockIdx.x * kLanes, blockIdx.y * kRows, sm);
}

template <int kRows, int kThreadRows>
__global__ void __launch_bounds__(kLanes * kThreadRows)
extract_wave(const float* __restrict__ x, const int* __restrict__ lanes,
             float* __restrict__ slab, int n, int k, int e16) {
  __shared__ float sm[kRows][kLanes + 1];
  const int nx = (n + kLanes - 1) / kLanes;
  const int tiles = nx * ((k + kRows - 1) / kRows);
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    tile<kRows, kThreadRows, false>(x, lanes, slab, n, k, e16,
                                    t % nx * kLanes, t / nx * kRows, sm);
    __syncthreads();   // the tile's reads of sm before the next one's writes
  }
}

template <int kRows, int kThreadRows, bool kCg>
int launch_tiled(const float* x, const int* lanes, float* slab, int n, int k,
                 int e16, cudaStream_t st) {
  const dim3 grid((n + kLanes - 1) / kLanes, (k + kRows - 1) / kRows);
  extract_tiled<kRows, kThreadRows, kCg>
      <<<grid, dim3(kLanes, kThreadRows), 0, st>>>(x, lanes, slab, n, k, e16);
  return static_cast<int>(cudaGetLastError());
}

template <int kRows, int kThreadRows>
int launch_wave(const float* x, const int* lanes, float* slab, int n, int k,
                int e16, cudaStream_t st) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per, extract_wave<kRows, kThreadRows>, kLanes * kThreadRows, 0);
  const int tiles = (n + kLanes - 1) / kLanes * ((k + kRows - 1) / kRows);
  const int grid = tiles < sms * per ? tiles : sms * per;
  extract_wave<kRows, kThreadRows>
      <<<grid, dim3(kLanes, kThreadRows), 0, st>>>(x, lanes, slab, n, k, e16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int extract_variant_launch(int variant, const void* x,
                                      const void* lanes, void* slab, int n,
                                      int k, int e16, void* stream) {
  const auto* a = static_cast<const float*>(x);
  const auto* b = static_cast<const int*>(lanes);
  auto* c = static_cast<float*>(slab);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (variant) {
    case 0:
      extract_old<<<dim3((n + kLanes - 1) / kLanes, (k + kLanes - 1) / kLanes),
                    dim3(kLanes, 8), 0, st>>>(a, b, c, n, k, e16);
      return static_cast<int>(cudaGetLastError());
    case 1: return launch_tiled<64, 8, false>(a, b, c, n, k, e16, st);
    case 2: return launch_tiled<32, 4, false>(a, b, c, n, k, e16, st);
    case 3: return launch_tiled<32, 8, true>(a, b, c, n, k, e16, st);
    case 4: return launch_wave<32, 8>(a, b, c, n, k, e16, st);
    case 5: return launch_tiled<128, 8, false>(a, b, c, n, k, e16, st);
    case 6: return launch_wave<64, 8>(a, b, c, n, k, e16, st);
    case 7: return launch_tiled<32, 8, false>(a, b, c, n, k, e16, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The context's L2 fetch granularity (cudaLimitMaxL2FetchGranularity, the
// bytes L2 asks device memory for on a miss, a hint): set to `bytes` where
// bytes > 0; returns the value the context then reports, or -1.
extern "C" int extract_l2_fetch(int bytes) {
  if (bytes > 0 &&
      cudaDeviceSetLimit(cudaLimitMaxL2FetchGranularity, bytes) != cudaSuccess)
    return -1;
  size_t now = 0;
  if (cudaDeviceGetLimit(&now, cudaLimitMaxL2FetchGranularity) != cudaSuccess)
    return -1;
  return static_cast<int>(now);
}
