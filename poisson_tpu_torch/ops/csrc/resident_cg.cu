// Kernel R: the whole scaled-CG solve in one persistent cooperative kernel,
// for Hopper (sm_90a).
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrapper is resident_solve in poisson_tpu_torch/ops/resident.py,
// beside its plain PyTorch version.
//
// Replaces the Pallas kernel poisson_tpu/ops/pallas_resident.py:
// _make_resident_kernel (pallas_call in _resident_solve), which keeps the
// whole solver state in one TensorCore's VMEM and runs the PCG loop as an
// in-kernel while_loop. One Hopper SM holds 227 KB of shared memory, far
// less than a 400 x 600 canvas set, so here the state lives in device
// memory (it stays L2-resident at the grids resident.fits_resident admits)
// and the loop runs in a grid of blocks that stay resident together
// (cudaLaunchCooperativeKernel, SM count x occupancy blocks) and meet at
// cooperative_groups grid syncs.
//
// Each iteration, over the band points each block owns (grid-stride, one
// thread per point per stride):
//   1. pn = r + beta p into the other buffer of a ping-pong pair, the
//      neighbours' pn recomputed from r and p as kernel A does; Ap in
//      difference form; one <Ap, pn> partial per block;
//   2. grid sync; every block sums all partials in one fixed order, so every
//      block holds the same alpha bit for bit (a block that left the loop
//      while another waits at a grid sync would hang the card);
//   3. w += alpha pn, r -= alpha Ap, partials of sum pn^2 sc2 and sum r^2;
//   4. grid sync; every block forms diff, zeta, beta and done the same way.
// The count, the cap and the degenerate-direction corner follow
// pallas_resident.py:105-134. k, diff and zeta are written once at the end.
// Arrays written inside the kernel (w, r, p, Ap, partials) are read with
// plain loads, never through the read-only path, since other blocks write
// them between syncs.
//
// Bound on the H100: at the grids admitted, operations and syncs. The
// function must read 5 canvases and write 1 (6 MB at 400 x 600, 1.8 us at
// 3.35 TB/s) but needs 26 flops per band point per iteration, kernel A's
// 17 and kernel B's 9 (54.24 us of fp32 at 67 TFLOP/s for the 546-iteration
// 400 x 600 solve); a streaming solver would move 14 canvases per iteration
// (4.3 us each at the HBM rate).
// The design keeps all of it on the card: one launch per solve, no host in
// the loop, the working set in L2, two grid syncs per iteration. Keeping
// the state in shared memory across SMs is later work.
//
// Arithmetic uses explicit round-to-nearest intrinsics in the plain
// version's order; the sums differ from it in order, so the iterates agree
// to fp32 round-off over the solve, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr float kDenomTol = 1e-15f;   // degenerate-direction guard

// Sum of v over the block, returned to every thread. `slots` holds
// kWarps + 1 floats; every thread must call it.
__device__ float block_sum_all(float v, float* slots) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();                       // slots free from the last call
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = slots[0];
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, slots[w]);
    slots[kWarps] = s;
  }
  __syncthreads();
  return slots[kWarps];
}

// Sum of part[0..n) in one fixed order, the same in every block.
__device__ float sum_partials(const float* part, int n, float* slots) {
  float v = 0.0f;
  for (int i = threadIdx.x; i < n; i += kBlock) v = __fadd_rn(v, part[i]);
  return block_sum_all(v, slots);
}

__device__ __forceinline__ float direction(const float* r, const float* p,
                                           float beta, long long i,
                                           bool live) {
  return live ? __fadd_rn(r[i], __fmul_rn(beta, p[i])) : 0.0f;
}

__global__ void __launch_bounds__(kBlock)
resident_kernel(const float* __restrict__ cs, const float* __restrict__ cw,
                const float* __restrict__ g, const float* __restrict__ rhs,
                const float* __restrict__ sc2, float* w, float* r, float* p0,
                float* p1, float* ap, float* part, int* k_out,
                float* diff_out, float* zr_out, float h1h2, float norm_w,
                float delta, int cap, int rows, int cols, int halo) {
  __shared__ float slots[kWarps + 1];
  cg::grid_group grid = cg::this_grid();
  const int blocks = gridDim.x;
  float* part_dot = part;                // <Ap, pn>
  float* part_diff = part + blocks;      // sum pn^2 sc2
  float* part_zr = part + 2 * blocks;    // sum r^2
  const long long base = static_cast<long long>(halo) * cols;
  const long long points = static_cast<long long>(rows - 2 * halo) * cols;
  const long long stride = static_cast<long long>(blocks) * kBlock;
  const long long first = static_cast<long long>(blockIdx.x) * kBlock
                          + threadIdx.x;

  // r = b~ (w and both p buffers arrive zeroed); zeta0 = sum r^2 h1h2.
  float acc = 0.0f;
  for (long long t = first; t < points; t += stride) {
    const float v = rhs[base + t];
    r[base + t] = v;
    acc = __fadd_rn(acc, __fmul_rn(v, v));
  }
  acc = block_sum_all(acc, slots);
  if (threadIdx.x == 0) part_zr[blockIdx.x] = acc;
  grid.sync();
  float zr = __fmul_rn(sum_partials(part_zr, blocks, slots), h1h2);

  int k = 0;
  bool done = false;
  float beta = 0.0f, diff = __int_as_float(0x7f800000);   // +inf
  float* p = p0;       // previous direction
  float* pn_buf = p1;  // the new one
  while (!done && k < cap) {
    // 1. pn = r + beta p, Ap = A~ pn, partial <Ap, pn>.
    acc = 0.0f;
    for (long long t = first; t < points; t += stride) {
      const int row = halo + static_cast<int>(t / cols);
      const int col = static_cast<int>(t % cols);
      const long long i = base + t;
      const float c = direction(r, p, beta, i, true);
      const float north = direction(r, p, beta, i + cols,
                                    row + 1 < rows - halo);
      const float south = direction(r, p, beta, i - cols, row - 1 >= halo);
      const float east = direction(r, p, beta, i + 1, col + 1 < cols);
      const float west = direction(r, p, beta, i - 1, col >= 1);
      const float cw_east = col + 1 < cols ? cw[i + 1] : 0.0f;
      float a = __fmul_rn(cs[i + cols], __fsub_rn(c, north));
      a = __fadd_rn(a, __fmul_rn(cs[i], __fsub_rn(c, south)));
      a = __fadd_rn(a, __fmul_rn(cw_east, __fsub_rn(c, east)));
      a = __fadd_rn(a, __fmul_rn(cw[i], __fsub_rn(c, west)));
      a = __fadd_rn(a, __fmul_rn(g[i], c));
      pn_buf[i] = c;
      ap[i] = a;
      acc = __fadd_rn(acc, __fmul_rn(a, c));
    }
    acc = block_sum_all(acc, slots);
    if (threadIdx.x == 0) part_dot[blockIdx.x] = acc;
    grid.sync();

    // 2-3. alpha from all partials; w += alpha pn, r -= alpha Ap.
    const float denom = __fmul_rn(sum_partials(part_dot, blocks, slots),
                                  h1h2);
    const bool deg = fabsf(denom) < kDenomTol;
    const float alpha = deg ? 0.0f : __fdiv_rn(zr, denom);
    float acc_d = 0.0f, acc_z = 0.0f;
    for (long long t = first; t < points; t += stride) {
      const long long i = base + t;
      const float pv = pn_buf[i];
      w[i] = __fadd_rn(w[i], __fmul_rn(alpha, pv));
      const float rn = __fsub_rn(r[i], __fmul_rn(alpha, ap[i]));
      r[i] = rn;
      acc_d = __fadd_rn(acc_d, __fmul_rn(__fmul_rn(pv, pv), sc2[i]));
      acc_z = __fadd_rn(acc_z, __fmul_rn(rn, rn));
    }
    acc_d = block_sum_all(acc_d, slots);
    if (threadIdx.x == 0) part_diff[blockIdx.x] = acc_d;
    acc_z = block_sum_all(acc_z, slots);
    if (threadIdx.x == 0) part_zr[blockIdx.x] = acc_z;
    grid.sync();

    // 4. diff, zeta, beta, done: the same bits in every block.
    const float sd = sum_partials(part_diff, blocks, slots);
    const float zr_new = __fmul_rn(sum_partials(part_zr, blocks, slots),
                                   h1h2);
    diff = __fmul_rn(fabsf(alpha), __fsqrt_rn(__fmul_rn(sd, norm_w)));
    beta = __fdiv_rn(zr_new, zr == 0.0f ? 1.0f : zr);
    zr = zr_new;
    k += 1;
    done = deg || diff < delta;
    float* tmp = p;
    p = pn_buf;
    pn_buf = tmp;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *k_out = k;
    *diff_out = diff;
    *zr_out = zr;
  }
}

}  // namespace

extern "C" {

const char* resident_cg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The cooperative grid: SM count x resident blocks per SM. Refuses a
// device without cooperative launch (cudaErrorNotSupported).
int resident_cg_grid(int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, resident_kernel, kBlock, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = sms * per_sm;
  return 0;
}

// One cooperative launch of `blocks` blocks (resident_cg_grid's count) on
// `stream`; `part` holds 3 x blocks floats. Returns cudaGetLastError().
int resident_cg_solve(const float* cs, const float* cw, const float* g,
                      const float* rhs, const float* sc2, float* w, float* r,
                      float* p0, float* p1, float* ap, float* part,
                      int* k, float* diff, float* zr, float h1h2,
                      float norm_w, float delta, int cap, int rows, int cols,
                      int halo, int blocks, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&cs, &cw, &g, &rhs, &sc2, &w, &r, &p0, &p1, &ap, &part,
                  &k, &diff, &zr, &h1h2, &norm_w, &delta, &cap, &rows,
                  &cols, &halo};
  err = cudaLaunchCooperativeKernel(
      (const void*)resident_kernel, dim3(blocks),
      dim3(kBlock), args, 0, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
