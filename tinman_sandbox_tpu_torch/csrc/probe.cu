// The compute-rate probe: o = sum over reps of a @ b, f32, each product a
// full FP32 dot added into the accumulator once per repetition.
//
// Replaces the mm_kernel of tools/probe_kernel.py::main (the pallas_call
// that chains twenty f32 [m,k]@[k,n] dots on operands held in VMEM, at the
// CAAR kernel's inner shapes and up to 1024^3).
//
// What bounds it on the H100: FP32 operations outside the tensor cores,
// reps * 2*m*k*n of them against 67 TFLOP/s (no TF32, no wgmma: plain TF32
// keeps about three decimal digits, and the probe measures the FP32 rate).
// The operands are read once from device memory; every repetition after the
// first finds them in the L2.
//
// Design: a classic tiled SGEMM. One block of 256 threads owns a 64 x 64
// output tile; each thread holds a 4 x 4 register micro-tile whose rows are
// ty + 16*i and columns tx + 16*j (so a warp reads 16 consecutive B values
// and broadcasts A). A and B come through shared memory in k-steps of 16,
// A stored transposed (and padded by one column, so its transposing store
// hits distinct banks). The repetitions are the OUTER loop: each one zeroes
// the micro-tile, walks the whole k loop with its shared-memory reloads and
// barriers, and then adds the tile into the accumulator, so the compiler
// cannot fold the twenty products into one, and the rounding is that of
// acc = acc + dot(a, b). Every load and store is bounds-checked (n = 72 is
// not a multiple of 64; m, k and n are general); out-of-range operands load
// as zero.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;     // output rows and columns of a block
constexpr int kStep = 16;     // k-step of the shared-memory tiles
constexpr int kSide = 16;     // threads along each side of the block
constexpr int kMicro = 4;     // micro-tile rows and columns of a thread

__global__ void __launch_bounds__(kSide * kSide)
probe_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ o, int m, int k, int n, int reps) {
  __shared__ float as[kStep][kTile + 1];
  __shared__ float bs[kStep][kTile];
  const int tx = threadIdx.x % kSide;
  const int ty = threadIdx.x / kSide;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;

  for (int r = 0; r < reps; ++r) {
    float d[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) d[i][j] = 0.0f;

    for (int k0 = 0; k0 < k; k0 += kStep) {
      // 64 x 16 of A and 16 x 64 of B: four values of each a thread,
      // neighbouring threads on neighbouring addresses of a row
#pragma unroll
      for (int e = 0; e < (kTile * kStep) / (kSide * kSide); ++e) {
        const int idx = threadIdx.x + e * kSide * kSide;
        const int ar = idx / kStep, ac = idx % kStep;
        const int gr = row0 + ar, gk = k0 + ac;
        as[ac][ar] = (gr < m && gk < k) ? a[(long long)gr * k + gk] : 0.0f;
        const int br = idx / kTile, bc = idx % kTile;
        const int hk = k0 + br, gc = col0 + bc;
        bs[br][bc] = (hk < k && gc < n) ? b[(long long)hk * n + gc] : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kStep; ++kk) {
        float av[kMicro], bv[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) av[i] = as[kk][ty + kSide * i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) bv[j] = bs[kk][tx + kSide * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = __fadd_rn(acc[i][j], d[i][j]);
  }

#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    const int gr = row0 + ty + kSide * i;
    if (gr >= m) continue;
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      const int gc = col0 + tx + kSide * j;
      if (gc < n) o[(long long)gr * n + gc] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a [m, k], b [k, n], o [m, n], all f32 and row-major contiguous; returns
// the cudaError_t of the launch.
int probe_mm_launch(const void* a, const void* b, void* o, int m, int k,
                    int n, int reps, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || k <= 0 || n <= 0 || reps <= 0) return cudaErrorInvalidValue;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  probe_mm_kernel<<<grid, kSide * kSide, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(o), m, k, n, reps);
  return cudaGetLastError();
}

}  // extern "C"
