// Kernels A' and B': the fused two-sweep PCG iteration on the column-blocked
// canvas, for Hopper (sm_90a).
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrappers are direction_and_stencil and fused_update in
// poisson_tpu_torch/ops/fused_cg.py, which route a column-blocked canvas
// (cg > 0) here, each beside its plain PyTorch version
// (direction_and_stencil_blocked_plain, fused_update_blocked_plain).
//
// Kernel A', blocked_stencil_kernel, replaces the Pallas kernel
// poisson_tpu/ops/pallas_cg.py:_make_blocked_stencil_kernel (pallas_call in
// direction_and_stencil, the cv.cg branch). Kernel B', blocked_update_kernel,
// replaces _make_update_kernel(ndims=2) (pallas_call in fused_update, the
// cv.cg branch). They compute kernel A's and B's math on the canvas the JAX
// package uses for grids too wide for a full-width strip: content column j
// sits at canvas column cg + j, with cg guard columns on each side, and the
// content is cut into nb strips of bm rows and ncb column blocks of bn
// columns. Only the centre tiles, rows [halo, halo + nb bm) x columns
// [cg, cg + ncb bn), are swept; the guard columns are never written, so the
// caller's zeroed outputs keep them zero.
//
// Design: a 2D-tiled stencil. Each CUDA block owns a kTileRows x kTileCols
// tile of centre points (the grid is (column tiles, row tiles); bm is a
// multiple of 8 and bn of 128, so tiles never straddle a strip or a column
// block). Kernel A' stages the tile's (kTileRows + 2) x (kTileCols + 2)
// window of z and p in shared memory, forming pn = z + beta p once per point
// there (zero off the live rows and the content columns), and reads the four
// neighbours of every point from shared memory instead of recomputing them
// from z and p, as kernel A does through L1/L2. The +/-1 column reads come
// from the window's edge columns, which are the neighbouring tile's content
// or the guard columns, never a shifted-in zero. Kernel B' is a plain sweep
// over the same tiles.
//
// Bound on the H100: memory. A' reads z, p, cS, cW, gamma and writes pn, Ap;
// B' reads p, Ap, sc2, w, r and writes w, r: 28 bytes per centre point each,
// against 17 (A') and 9 (B') flops per point, far below the ~20 flops per
// byte where the card's fp32 rate would bind.
//
// Arithmetic uses explicit round-to-nearest intrinsics in the plain
// versions' order, so pn, Ap, w and r agree with them bit for bit; only the
// per-block sums differ, in their order of summation. Each block writes one
// partial per sum, no atomics, at the index the Pallas grid's order gives
// its tile: JAX tile (strip i, column block j), column index fastest, then
// the CUDA tiles inside it row-major. So the partials of one JAX tile are
// consecutive, which is what the serial-reduce mode's kernel S sums as one
// run (poisson_tpu_torch/ops/csrc/serial_sum.cu).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;     // centre rows per block (bm % 8 == 0)
constexpr int kTileCols = 128;   // columns per block (bn % 128 == 0)
constexpr int kRowStep = kThreads / kTileCols;               // 2
constexpr int kPointsPerThread = kTileRows / kRowStep;       // 4
constexpr int kWinRows = kTileRows + 2;
constexpr int kWinCols = kTileCols + 2;

// Sum of v over the block; valid in thread 0. Every thread must call it.
__device__ __forceinline__ float block_sum(float v, float* slots) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? slots[lane] : 0.0f;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// Geometry shared by both kernels, from the block's position in the grid.
struct Tile {
  int row0;          // first centre row of the tile
  int col0;          // first centre column of the tile
  long long slot;    // index of the block's partial
};

__device__ __forceinline__ Tile tile_of(int halo, int cg, int bm, int bn,
                                        int ncb) {
  const int rt = blockIdx.y;   // row tile over all strips
  const int ct = blockIdx.x;   // column tile over all column blocks
  const int bm_tiles = bm / kTileRows;
  const int bn_tiles = bn / kTileCols;
  const int i = rt / bm_tiles, ri = rt % bm_tiles;
  const int j = ct / bn_tiles, cj = ct % bn_tiles;
  Tile t;
  t.row0 = halo + rt * kTileRows;
  t.col0 = cg + ct * kTileCols;
  t.slot = ((static_cast<long long>(i) * ncb + j) * bm_tiles + ri) * bn_tiles
           + cj;
  return t;
}

// Kernel A': pn = z + beta p on the live rows [halo, rows - halo) and the
// content columns [cg, cg + ncb bn), zero elsewhere; Ap = A~ pn in
// difference form on the centre tiles
//   Ap_c = cS_{i+1} (pn_c - pn_{i+1}) + cS_i (pn_c - pn_{i-1})
//        + cW_{j+1} (pn_c - pn_{j+1}) + cW_j (pn_c - pn_{j-1}) + g pn_c;
// one partial of sum(Ap * pn) per block. pn must not alias p or z: other
// blocks read them around this tile while it is written.
__global__ void __launch_bounds__(kThreads)
blocked_stencil_kernel(const float* __restrict__ beta_ptr,
                       const float* __restrict__ z,
                       const float* __restrict__ p,
                       const float* __restrict__ cs,
                       const float* __restrict__ cw,
                       const float* __restrict__ g,
                       float* __restrict__ pn, float* __restrict__ ap,
                       float* __restrict__ part, int rows, int cols, int halo,
                       int cg, int bm, int bn, int ncb) {
  __shared__ float win[kWinRows][kWinCols];
  __shared__ float slots[kWarps];
  const Tile t = tile_of(halo, cg, bm, bn, ncb);
  const int lo = halo, hi = rows - halo;
  const int c_lo = cg, c_hi = cg + ncb * bn;
  const float beta = *beta_ptr;

  for (int e = threadIdx.x; e < kWinRows * kWinCols; e += kThreads) {
    const int row = t.row0 - 1 + e / kWinCols;
    const int col = t.col0 - 1 + e % kWinCols;
    const bool live = row >= lo && row < hi && col >= c_lo && col < c_hi;
    const long long i = static_cast<long long>(row) * cols + col;
    win[e / kWinCols][e % kWinCols] =
        live ? __fadd_rn(z[i], __fmul_rn(beta, p[i])) : 0.0f;
  }
  __syncthreads();

  const int x = threadIdx.x % kTileCols;
  float prod = 0.0f;
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const int r = threadIdx.x / kTileCols + k * kRowStep;
    const long long i = static_cast<long long>(t.row0 + r) * cols + t.col0 + x;
    const float c = win[r + 1][x + 1];
    float a = __fmul_rn(cs[i + cols], __fsub_rn(c, win[r + 2][x + 1]));
    a = __fadd_rn(a, __fmul_rn(cs[i], __fsub_rn(c, win[r][x + 1])));
    a = __fadd_rn(a, __fmul_rn(cw[i + 1], __fsub_rn(c, win[r + 1][x + 2])));
    a = __fadd_rn(a, __fmul_rn(cw[i], __fsub_rn(c, win[r + 1][x])));
    a = __fadd_rn(a, __fmul_rn(g[i], c));
    pn[i] = c;
    ap[i] = a;
    prod = __fadd_rn(prod, __fmul_rn(a, c));
  }
  const float s = block_sum(prod, slots);
  if (threadIdx.x == 0) part[t.slot] = s;
}

// Kernel B': w += alpha p, r -= alpha Ap in place on the centre tiles (each
// thread owns its points, so in place is safe); one partial each of
// sum(p^2 sc2) and sum(r_new^2) per block.
__global__ void __launch_bounds__(kThreads)
blocked_update_kernel(const float* __restrict__ alpha_ptr,
                      const float* __restrict__ p,
                      const float* __restrict__ ap,
                      const float* __restrict__ sc2, float* __restrict__ w,
                      float* __restrict__ r, float* __restrict__ diff_part,
                      float* __restrict__ zr_part, int cols, int halo, int cg,
                      int bm, int bn, int ncb) {
  __shared__ float diff_slots[kWarps];
  __shared__ float zr_slots[kWarps];
  const Tile t = tile_of(halo, cg, bm, bn, ncb);
  const float alpha = *alpha_ptr;
  const int x = threadIdx.x % kTileCols;
  float d = 0.0f, zz = 0.0f;
#pragma unroll
  for (int k = 0; k < kPointsPerThread; ++k) {
    const int row = t.row0 + threadIdx.x / kTileCols + k * kRowStep;
    const long long i = static_cast<long long>(row) * cols + t.col0 + x;
    const float pv = p[i];
    const float rn = __fsub_rn(r[i], __fmul_rn(alpha, ap[i]));
    w[i] = __fadd_rn(w[i], __fmul_rn(alpha, pv));
    r[i] = rn;
    d = __fadd_rn(d, __fmul_rn(__fmul_rn(pv, pv), sc2[i]));
    zz = __fadd_rn(zz, __fmul_rn(rn, rn));
  }
  d = block_sum(d, diff_slots);
  zz = block_sum(zz, zr_slots);
  if (threadIdx.x == 0) {
    diff_part[t.slot] = d;
    zr_part[t.slot] = zz;
  }
}

}  // namespace

extern "C" {

void blocked_cg_layout(int* tile_rows, int* tile_cols, int* threads) {
  *tile_rows = kTileRows;
  *tile_cols = kTileCols;
  *threads = kThreads;
}

const char* blocked_cg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry launches one kernel on `stream` (PyTorch's current stream of
// `device`) over the (ncb bn / kTileCols, nb bm / kTileRows) grid and
// returns cudaGetLastError(): a launch the runtime refused never runs, and a
// later synchronise would not report it.
int blocked_cg_direction_stencil(const float* beta, const float* z,
                                 const float* p, const float* cs,
                                 const float* cw, const float* g, float* pn,
                                 float* ap, float* part, int rows, int cols,
                                 int halo, int cg, int bm, int bn, int nb,
                                 int ncb, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ncb * bn / kTileCols, nb * bm / kTileRows);
  blocked_stencil_kernel<<<grid, kThreads, 0, stream>>>(
      beta, z, p, cs, cw, g, pn, ap, part, rows, cols, halo, cg, bm, bn, ncb);
  return static_cast<int>(cudaGetLastError());
}

int blocked_cg_update(const float* alpha, const float* p, const float* ap,
                      const float* sc2, float* w, float* r, float* diff_part,
                      float* zr_part, int cols, int halo, int cg, int bm,
                      int bn, int nb, int ncb, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(ncb * bn / kTileCols, nb * bm / kTileRows);
  blocked_update_kernel<<<grid, kThreads, 0, stream>>>(
      alpha, p, ap, sc2, w, r, diff_part, zr_part, cols, halo, cg, bm, bn,
      ncb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
