// Kernel S: the ordered, Kahan-compensated sum of a vector of reduction
// partials, for Hopper (sm_90a) -- the serial-reduce mode of the port.
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrapper is serial_sum in poisson_tpu_torch/ops/serial.py, beside
// its plain PyTorch version serial_sum_plain.
//
// It replaces the serial variant of every Pallas kernel of the JAX package
// (serial=True: poisson_tpu/ops/pallas_cg.py:94-109 states the rule,
// _kahan_add at :464 is the accumulation; A :448, A' :527, B and B' :563;
// pallas_ca.py:218-229 for C and :269 for D). On the TPU the grid runs in
// order on one core, so those kernels carry one (1, 1) SMEM cell and a Kahan
// compensation cell from one grid step to the next: each step adds its
// strip's (or tile's) partial with compensation. CUDA blocks run in no
// order, so the port keeps its field kernels as they are (one partial per
// block) and sums their partials here, in the TPU grid's order:
//
//   - the partials of one sum are cut, in canvas order, into consecutive
//     runs of `run` partials, each run the partials of one TPU grid step
//     (a strip of strip_height rows; on the column-blocked canvas one
//     (strip, column block) tile, column index fastest);
//   - each run is tree-summed inside this block, by one warp: lane l adds
//     the run's partials l, l + 32, l + 64, ... in order, then the 32 lane
//     sums are combined by the shuffle tree (offsets 16, 8, 4, 2, 1);
//   - thread 0 then adds the run sums in order with Kahan compensation,
//     exactly as _kahan_add does:
//         y = part - comp;  t = sum + y;  comp = (t - sum) - y;  sum = t.
//
// The sequential chain is therefore as long as the TPU kernel's (one link
// per strip or tile), not one link per partial. The warps of the block tree-
// sum different runs at once (run k by warp k mod 32), kMaxRuns at a time,
// into shared memory, and thread 0 walks them in order. One block per
// vector: one launch sums several vectors (kernel A's one, B's two, C's
// twelve), each its own block.
//
// Bound on the H100: latency, not bytes or operations. The partials are a
// few thousand floats; the chain of run sums is sequential by definition.
//
// Every add uses __fadd_rn/__fsub_rn, so nothing is contracted or
// reassociated, and the result equals serial_sum_plain's bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRuns = 2048;   // run sums held in shared memory at once

// One run's tree sum by one warp; valid in lane 0.
__device__ __forceinline__ float warp_run_sum(const float* __restrict__ x,
                                              long long start, long long len,
                                              long long stride, int lane) {
  float acc = 0.0f;
  long long k = lane;
  // Four loads in flight, added in the same order as one at a time.
  for (; k + 96 < len; k += 128) {
    const float a0 = x[(start + k) * stride];
    const float a1 = x[(start + k + 32) * stride];
    const float a2 = x[(start + k + 64) * stride];
    const float a3 = x[(start + k + 96) * stride];
    acc = __fadd_rn(acc, a0);
    acc = __fadd_rn(acc, a1);
    acc = __fadd_rn(acc, a2);
    acc = __fadd_rn(acc, a3);
  }
  for (; k < len; k += 32) acc = __fadd_rn(acc, x[(start + k) * stride]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  return acc;
}

__global__ void __launch_bounds__(kThreads)
serial_sum_kernel(const float* __restrict__ src, float* __restrict__ out,
                  long long n, long long elem_stride, long long vec_stride,
                  long long run) {
  __shared__ float run_sums[kMaxRuns];
  const float* x = src + blockIdx.x * vec_stride;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long runs = (n + run - 1) / run;
  float sum = 0.0f, comp = 0.0f;   // thread 0's
  for (long long base = 0; base < runs; base += kMaxRuns) {
    const long long count = runs - base < kMaxRuns ? runs - base : kMaxRuns;
    for (long long q = warp; q < count; q += kWarps) {
      const long long start = (base + q) * run;
      const long long len = n - start < run ? n - start : run;
      const float s = warp_run_sum(x, start, len, elem_stride, lane);
      if (lane == 0) run_sums[q] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (long long q = 0; q < count; ++q) {
        const float y = __fsub_rn(run_sums[q], comp);
        const float t = __fadd_rn(sum, y);
        comp = __fsub_rn(__fsub_rn(t, sum), y);
        sum = t;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = sum;
}

}  // namespace

extern "C" {

int serial_sum_threads() { return kThreads; }

const char* serial_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sums `vectors` vectors of `n` partials each: vector v's partial k is at
// src[v * vec_stride + k * elem_stride]; its sum goes to out[v]. Launches on
// `stream` and returns cudaGetLastError().
int serial_sum_launch(const float* src, float* out, long long n,
                      long long elem_stride, long long vec_stride,
                      long long run, int vectors, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  serial_sum_kernel<<<vectors, kThreads, 0, stream>>>(src, out, n,
                                                      elem_stride, vec_stride,
                                                      run);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
