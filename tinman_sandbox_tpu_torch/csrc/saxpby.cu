// saxpby triad x <- a*x + b*y, in place, for float32 and float64.
//
// Replaces tinman_sandbox_tpu/kernels/saxpby.py::saxpby (the Pallas triad,
// itself the reference's saxpby_test bandwidth probe).
//
// What bounds it on the H100: device-memory traffic, 2 reads and 1 write per
// element and 3 flops, far below the card's ~20 flops per byte balance.
//
// Design: 16-byte vector loads and stores (float4 / double2) so each thread
// moves the widest unit one instruction can, neighbouring threads on
// neighbouring addresses, in a grid-stride loop over a grid of a few blocks
// per SM; a scalar loop takes the tail. The products and the sum are rounded
// separately (__fmul_rn/__fadd_rn, no FMA contraction), so the result is
// bitwise equal to PyTorch's x*a + y*b.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float triad(float a, float x, float b, float y) {
  return __fadd_rn(__fmul_rn(a, x), __fmul_rn(b, y));
}

__device__ __forceinline__ double triad(double a, double x, double b,
                                        double y) {
  return __dadd_rn(__dmul_rn(a, x), __dmul_rn(b, y));
}

__device__ __forceinline__ float4 triad(float a, float4 x, float b, float4 y) {
  return make_float4(triad(a, x.x, b, y.x), triad(a, x.y, b, y.y),
                     triad(a, x.z, b, y.z), triad(a, x.w, b, y.w));
}

__device__ __forceinline__ double2 triad(double a, double2 x, double b,
                                         double2 y) {
  return make_double2(triad(a, x.x, b, y.x), triad(a, x.y, b, y.y));
}

template <typename T, typename V>
__global__ void saxpby_kernel(T a, T b, T* __restrict__ x,
                              const T* __restrict__ y, long long n) {
  constexpr int kW = sizeof(V) / sizeof(T);
  const long long nv = n / kW;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  V* xv = reinterpret_cast<V*>(x);
  const V* yv = reinterpret_cast<const V*>(y);
  for (long long i = first; i < nv; i += stride) xv[i] = triad(a, xv[i], b, yv[i]);
  for (long long i = nv * kW + first; i < n; i += stride)
    x[i] = triad(a, x[i], b, y[i]);
}

int grid_for(long long nvec, int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || sms <= 0)
    sms = 1;
  long long want = (nvec + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(sms) * 8;
  if (want < 1) want = 1;
  return static_cast<int>(want < cap ? want : cap);
}

template <typename T, typename V>
int launch(T a, T b, void* x, const void* y, long long n, void* stream,
           int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = grid_for(n / (sizeof(V) / sizeof(T)), device);
  saxpby_kernel<T, V><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, b, static_cast<T*>(x), static_cast<const T*>(y), n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* saxpby_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x and y must be 16-byte aligned; returns the cudaError_t of the launch.
int saxpby_f32_launch(float a, float b, void* x, const void* y, long long n,
                      void* stream, int device) {
  return launch<float, float4>(a, b, x, y, n, stream, device);
}

int saxpby_f64_launch(double a, double b, void* x, const void* y, long long n,
                      void* stream, int device) {
  return launch<double, double2>(a, b, x, y, n, stream, device);
}

}  // extern "C"
