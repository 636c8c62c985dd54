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
// first finds them in the L2 or in shared memory.
//
// Design: one kernel template, its launch plan chosen per shape by
// kernels/probe.py::probe_plan.
//  * Register tiling. A block owns a 128 x 64 output tile (128 threads) or
//    64 x 64 (64); each thread an 8 x 8 micro-tile, rows
//    {ly*4 + i, 32 + ly*4 + i} and columns {lx*4 + j, 16 + lx*4 + j} of its
//    warp's 64 x 32 tile (lanes 8 x 4). A is kept
//    transposed in shared memory, so a k-step of a thread reads 2 float4 of
//    A (eight lanes apart, 128 contiguous bytes a warp) and 2 float4 of B
//    (broadcast in groups of eight) for 64 FFMA.
//  * Asynchronous copies. Each k-step of 16 comes through shared memory by
//    4-byte cp.async with zero fill (the 4-byte form writes A transposed and
//    takes any m, k, n; a row or column outside the matrix or the block's k
//    range loads as zero and adds fma(0, 0, d) = d). Pipelined, three
//    stages: the next steps' copies are in flight during the current step's
//    FFMA, one barrier a step. Resident, when the block's whole k range fits:
//    its panels of a and b are loaded once and serve all the repetitions,
//    with no barrier after the load (the TPU kernel also held both operands
//    in VMEM for all twenty dots).
//  * Filling the card. Where the output tiles are fewer than the SMs, a
//    thread-block cluster of ksplit CTAs (grid z) splits the k range: CTA q
//    takes [q*kc, min(k, (q+1)*kc)). After the repetitions each CTA stores
//    its accumulator tile in its shared memory, and CTA q sums rows
//    [q*tm/ksplit, (q+1)*tm/ksplit) of the tile over the cluster's CTAs
//    through distributed shared memory in rank order 0, 1, ..., so the
//    result is the same bits run to run.
// The repetitions are the OUTER loop: each zeroes the micro-tile d, walks
// its whole k range, and adds d into the accumulator (acc = acc + d,
// rounded), so the twenty products stay twenty; in resident mode a compiler
// memory barrier at each step keeps the shared-memory loads in every
// repetition.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMicro = 8;     // micro-tile rows and columns of a thread
constexpr int kStep = 16;     // k-step of the shared-memory tiles
constexpr int kPadA = 4;      // A^T rows padded: 16-byte aligned, fewer
                              // bank conflicts on the transposing copies
constexpr int kStages = 3;    // pipelined k-steps in shared memory
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may use

// a block tile of kM x kN outputs: warps of 64 x 32, threads of 8 x 8
template <int kM, int kN>
struct Shape {
  static constexpr int kThreads = (kM / kMicro) * (kN / kMicro);
  static constexpr int kWarpCols = kN / 32;      // warps across the tile
  static constexpr int kStrideA = kM + kPadA;
  static constexpr int kStageFloats = kStep * (kM + kPadA) + kStep * kN;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Copies k-step [kb, kb + kStep) of the block's panels into stage `st`: A^T
// [kStep][kM + kPadA] and B [kStep][kN], zero outside the matrix and at
// k >= kend.
template <int kM, int kN>
__device__ __forceinline__ void load_step(
    float* st, const float* __restrict__ a, const float* __restrict__ b,
    int m, int k, int n, int row0, int col0, int kb, int kend) {
  using S = Shape<kM, kN>;
  float* as = st;
  float* bs = st + kStep * S::kStrideA;
#pragma unroll
  for (int i = 0; i < kM * kStep / S::kThreads; ++i) {
    const int e = threadIdx.x + i * S::kThreads;
    const int cc = e % kStep, rr = e / kStep;
    const int gr = row0 + rr, gk = kb + cc;
    const bool ok = gr < m && gk < kend;
    cp_async4(as + cc * S::kStrideA + rr,
              ok ? a + static_cast<size_t>(gr) * k + gk : a, ok);
  }
#pragma unroll
  for (int i = 0; i < kN * kStep / S::kThreads; ++i) {
    const int e = threadIdx.x + i * S::kThreads;
    const int jj = e % kN, cc = e / kN;
    const int gk = kb + cc, gc = col0 + jj;
    const bool ok = gk < kend && gc < n;
    cp_async4(bs + cc * kN + jj,
              ok ? b + static_cast<size_t>(gk) * n + gc : b, ok);
  }
}

// d += the thread's 8 x 8 block of A^T[:, rows]^T @ B[:, cols] over one
// k-step in stage `st`
template <int kM, int kN>
__device__ __forceinline__ void step_fma(const float* st, int ar, int bc,
                                         float (&d)[kMicro][kMicro]) {
  using S = Shape<kM, kN>;
  const float* as = st + ar;
  const float* bs = st + kStep * S::kStrideA + bc;
#pragma unroll
  for (int kk = 0; kk < kStep; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * S::kStrideA);
    const float4 a1 =
        *reinterpret_cast<const float4*>(as + kk * S::kStrideA + 32);
    const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kN);
    const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kN + 16);
    const float av[kMicro] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float bv[kMicro] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) d[i][j] = fmaf(av[i], bv[j], d[i][j]);
  }
}

__device__ __forceinline__ void add_into(float (&acc)[kMicro][kMicro],
                                         float (&d)[kMicro][kMicro]) {
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) {
      acc[i][j] = __fadd_rn(acc[i][j], d[i][j]);
      d[i][j] = 0.0f;
    }
}

// grid (n tiles, m tiles, ksplit), clusters (1, 1, ksplit); kc the k range
// of a cluster rank; dynamic shared memory: the stages (kResident: all
// ceil(kc / kStep) k-steps) and at least kM*kN floats when ksplit > 1
template <int kM, int kN, bool kResident>
__global__ void __launch_bounds__(Shape<kM, kN>::kThreads, 1)
probe_mm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ o, int m, int k, int n, int reps,
                int kc) {
  using S = Shape<kM, kN>;
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wr = warp / S::kWarpCols, wc = warp % S::kWarpCols;
  const int ly = lane / 4, lx = lane % 4;
  const int ar = wr * 64 + ly * 4;      // the thread's rows ar + {0..3, 32..}
  const int bc = wc * 32 + lx * 4;      // its columns bc + {0..3, 16..}
  const int row0 = blockIdx.y * kM, col0 = blockIdx.x * kN;
  const int ksplit = gridDim.z, rank = blockIdx.z;
  const int kbeg = rank * kc;
  const int kend = min(k, kbeg + kc);
  const int nsteps = (kc + kStep - 1) / kStep;

  float acc[kMicro][kMicro], d[kMicro][kMicro];
#pragma unroll
  for (int i = 0; i < kMicro; ++i)
#pragma unroll
    for (int j = 0; j < kMicro; ++j) acc[i][j] = d[i][j] = 0.0f;

  if constexpr (kResident) {
    for (int s = 0; s < nsteps; ++s)
      load_step<kM, kN>(smem + s * S::kStageFloats, a, b, m, k, n, row0, col0,
                       kbeg + s * kStep, kend);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int r = 0; r < reps; ++r) {
      for (int s = 0; s < nsteps; ++s) {
        asm volatile("" ::: "memory");
        step_fma<kM, kN>(smem + s * S::kStageFloats, ar, bc, d);
      }
      add_into(acc, d);
    }
  } else {
    const int total = reps * nsteps;
    // prologue: steps 0 .. kStages-2 in flight (one group each)
    int ls = 0;                       // k-step of the next copy
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < total)
        load_step<kM, kN>(smem + t * S::kStageFloats, a, b, m, k, n, row0,
                         col0, kbeg + ls * kStep, kend);
      cp_async_commit();
      if (++ls == nsteps) ls = 0;
    }
    int s = 0, slot = 0, lslot = kStages - 1;
    for (int t = 0; t < total; ++t) {
      cp_async_wait<kStages - 2>();   // step t has landed
      __syncthreads();                // ... for every thread; step t-1 done
      if (t + kStages - 1 < total)    // refill the slot of step t-1
        load_step<kM, kN>(smem + lslot * S::kStageFloats, a, b, m, k, n, row0,
                         col0, kbeg + ls * kStep, kend);
      cp_async_commit();
      if (++ls == nsteps) ls = 0;
      if (++lslot == kStages) lslot = 0;
      step_fma<kM, kN>(smem + slot * S::kStageFloats, ar, bc, d);
      if (++slot == kStages) slot = 0;
      if (++s == nsteps) {
        s = 0;
        add_into(acc, d);
      }
    }
    cp_async_wait<0>();
  }

  if (ksplit == 1) {
#pragma unroll
    for (int i = 0; i < kMicro; ++i) {
      const int gr = row0 + ar + (i / 4) * 32 + i % 4;
      if (gr >= m) continue;
#pragma unroll
      for (int j = 0; j < kMicro; ++j) {
        const int gc = col0 + bc + (j / 4) * 16 + j % 4;
        if (gc < n) o[static_cast<size_t>(gr) * n + gc] = acc[i][j];
      }
    }
    return;
  }

  // the cluster's sum: this CTA's tile into its shared memory, then rows
  // [rank*rows, (rank+1)*rows) summed over the ranks in order
  cg::cluster_group cluster = cg::this_cluster();
  __syncthreads();                    // every thread done with the operands
  float* red = smem;                  // [kM][kN]
#pragma unroll
  for (int i = 0; i < kMicro; ++i) {
    float* p = red + (ar + (i / 4) * 32 + i % 4) * kN + bc;
    *reinterpret_cast<float4*>(p) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(p + 16) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  cluster.sync();
  const int rows = kM / ksplit;
  for (int e = threadIdx.x; e < rows * kN; e += S::kThreads) {
    const int rr = rank * rows + e / kN, cc = e % kN;
    const int off = rr * kN + cc;
    float sum = *cluster.map_shared_rank(red + off, 0);
    for (int q = 1; q < ksplit; ++q)
      sum = __fadd_rn(sum, *cluster.map_shared_rank(red + off, q));
    const int gr = row0 + rr, gc = col0 + cc;
    if (gr < m && gc < n) o[static_cast<size_t>(gr) * n + gc] = sum;
  }
  cluster.sync();                     // no CTA leaves while others read it
}

template <int kM, int kN, bool kResident>
int smem_bytes(int kc, int ksplit) {
  const int nsteps = (kc + kStep - 1) / kStep;
  const int stages = kResident ? nsteps : kStages;
  int floats = stages * Shape<kM, kN>::kStageFloats;
  if (ksplit > 1 && floats < kM * kN) floats = kM * kN;
  return floats * static_cast<int>(sizeof(float));
}

template <int kM, int kN, bool kResident>
cudaLaunchConfig_t config(int m, int n, int ksplit, int kc,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n + kN - 1) / kN, (m + kM - 1) / kM, ksplit);
  cfg.blockDim = dim3(Shape<kM, kN>::kThreads);
  cfg.dynamicSmemBytes = smem_bytes<kM, kN, kResident>(kc, ksplit);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = ksplit;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the kernel of a plan, its shared-memory limit raised once
template <int kM, int kN, bool kResident>
cudaError_t kernel_of(void (**kernel)(const float*, const float*, float*, int,
                                      int, int, int, int)) {
  *kernel = probe_mm_kernel<kM, kN, kResident>;
  static cudaError_t set = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return set;
}

// F<kM, kN, kResident>::run(args...) for the plan's tile and mode
template <template <int, int, bool> class F, class... Args>
int dispatch(int tm, int tn, int resident, Args... args) {
  if (tm == 128 && tn == 64)
    return resident ? F<128, 64, true>::run(args...)
                    : F<128, 64, false>::run(args...);
  if (tm == 64 && tn == 64)
    return resident ? F<64, 64, true>::run(args...)
                    : F<64, 64, false>::run(args...);
  return cudaErrorInvalidValue;
}

template <int kM, int kN, bool kResident>
struct Launch {
  static int run(const float* a, const float* b, float* o, int m, int k,
                 int n, int reps, int ksplit, int kc, cudaStream_t stream) {
    if (smem_bytes<kM, kN, kResident>(kc, ksplit) > kMaxSmem)
      return cudaErrorInvalidValue;
    void (*kernel)(const float*, const float*, float*, int, int, int, int,
                   int);
    cudaError_t err = kernel_of<kM, kN, kResident>(&kernel);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config<kM, kN, kResident>(m, n, ksplit, kc, &attr);
    cfg.stream = stream;
    return cudaLaunchKernelEx(&cfg, kernel, a, b, o, m, k, n, reps, kc);
  }
};

template <int kM, int kN, bool kResident>
struct Occupancy {
  static int run(int m, int n, int ksplit, int kc, int* blocks_per_sm,
                 int* clusters) {
    void (*kernel)(const float*, const float*, float*, int, int, int, int,
                   int);
    cudaError_t err = kernel_of<kM, kN, kResident>(&kernel);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, kernel, Shape<kM, kN>::kThreads,
        smem_bytes<kM, kN, kResident>(kc, ksplit));
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = config<kM, kN, kResident>(m, n, ksplit, kc, &attr);
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  }
};

bool plan_ok(int ksplit, int kc, int k) {
  return (ksplit == 1 || ksplit == 2 || ksplit == 4 || ksplit == 8) &&
         kc > 0 && static_cast<long long>(kc) * ksplit >= k;
}

}  // namespace

extern "C" {

const char* probe_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// a [m, k], b [k, n], o [m, n], all f32 and row-major contiguous; the plan
// of kernels/probe.py::probe_plan: block tile tm x tn (128 x 64 or 64 x 64),
// cluster size ksplit (1, 2, 4, 8), the k range kc of a cluster
// rank, resident panels or the three-stage pipeline. Returns the cudaError_t
// of the launch.
int probe_mm_launch(const void* a, const void* b, void* o, int m, int k,
                    int n, int reps, int tm, int tn, int ksplit, int kc,
                    int resident, void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (m <= 0 || k <= 0 || n <= 0 || reps <= 0 || !plan_ok(ksplit, kc, k))
    return cudaErrorInvalidValue;
  const int launched = dispatch<Launch>(
      tm, tn, resident, static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<float*>(o), m, k, n, reps,
      ksplit, kc, static_cast<cudaStream_t>(stream));
  if (launched != cudaSuccess) return launched;
  return cudaGetLastError();
}

// blocks of the plan's kernel an SM holds, and the clusters of its launch
// the card holds at once; returns a cudaError_t
int probe_occupancy(int m, int k, int n, int tm, int tn, int ksplit, int kc,
                    int resident, int device, int* blocks_per_sm,
                    int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (!plan_ok(ksplit, kc, k)) return cudaErrorInvalidValue;
  return dispatch<Occupancy>(tm, tn, resident, m, n, ksplit, kc,
                             blocks_per_sm, clusters);
}

}  // extern "C"
