// Kernels C and D of the communication-avoiding (s=2) CG pair iteration,
// for Hopper (sm_90a).
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrappers are basis_sweep and pair_update in
// poisson_tpu_torch/ops/ca_cg.py, each beside its plain PyTorch version.
//
// Kernel C, basis_sweep, replaces the Pallas kernel
// poisson_tpu/ops/pallas_ca.py:_make_basis_kernel (pallas_call in
// basis_sweep). Kernel D, pair_update, replaces
// poisson_tpu/ops/pallas_ca.py:_make_pair_update_kernel (pallas_call in
// pair_update). Each has a second form for the sharded CA solve
// (poisson_tpu_torch/parallel/ca_sharded.py), the counterpart of the Pallas
// kernels' `masked` form (poisson_tpu/parallel/pallas_ca_sharded.py:216,223):
// a (1, cols) column mask keeps the neighbours' values in a shard's halo
// columns out of the unweighted sums. The band on which C forms pn is a
// runtime argument of both forms of C.
//
// Canvas: rows x cols fp32, row-major, centre rows [halo, rows - halo);
// (rows - 2 halo) is a multiple of 8 and cols of 128. Guard rows are never
// written; the caller allocates outputs zeroed once, which keeps them zero.
//
// Bound on the H100: memory. C reads p_prev, r, cS, cW, g, sc2 and writes
// pn, t1, t2, t3 (10 canvas passes) for about 71 flops per point; D reads
// pn, t1, t2, t3, x, r and writes x, r, p1 (9 passes) for about 18. Both
// are far below the ~20 flops per byte where the fp32 rate (67 TFLOP/s)
// would bind: at 800 x 1200 C moves 41 MB (12.2 us at 3.35 TB/s), D 37 MB.
//
// Design of C. t2 at a point needs t1 at its four neighbours, and t1 needs
// pn at radius 2, so a block must never read t1 or pn from global memory
// that another block writes in the same launch. Each block owns a tile of
// kTileH x kTileW band points. It forms pn = r + beta p_prev into shared
// memory over the tile plus a halo of 2 (zero off the live band and beyond
// the canvas edge), then t1 into shared memory over the tile plus a halo of
// 1, then t2 and t3 on the tile. t1 in the halo is recomputed by the same
// device function, in the same order, as the block that owns it, so it is
// the same bits. Reading r, p_prev and the coefficients a second time in
// the halo costs L2 traffic, not HBM traffic: the tiles are 32 columns wide
// (128-byte rows per warp) and neighbouring tiles run close together.
//
// Design of D: elementwise, one thread per band point, coefficients read
// through a device pointer (the host reads nothing), x and r updated in
// place (each thread reads r before it writes it), p1 to its own buffer.
// coefs[5] says the pair applied its first step only; p1 is then pn, so the
// driver needs no select over the canvas to pick the next direction.
//
// Arithmetic is written with explicit round-to-nearest intrinsics in the
// same order as the plain PyTorch versions, so no multiply-add is contracted
// and every field agrees with them bit for bit; only the per-block sums
// differ, in their order of summation.
//
// Reductions: each block writes its partials (12 for C in the order
// a1 b1 e f g h | wpp wpr wpt wrr wrt wtt, one for D) with warp shuffles and
// one shared-memory slot per warp, summed in a fixed order. No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                 // C: tile columns (one warp)
constexpr int kTileH = 8;                  // C: tile rows (one per warp)
constexpr int kThreads = kTileW * kTileH;  // 256 threads per block, C and D
constexpr int kWarps = kThreads / 32;
constexpr int kGram = 12;

// Difference-form stencil of pallas_ca._stencil, in its order:
//   cS_{i+1} (c - n) + cS_i (c - s) + cW_{j+1} (c - e) + cW_j (c - w) + g c
__device__ __forceinline__ float stencil(float c, float n, float s, float e,
                                         float w, float cs_n, float cs_c,
                                         float cw_e, float cw_c, float g) {
  float a = __fmul_rn(cs_n, __fsub_rn(c, n));
  a = __fadd_rn(a, __fmul_rn(cs_c, __fsub_rn(c, s)));
  a = __fadd_rn(a, __fmul_rn(cw_e, __fsub_rn(c, e)));
  a = __fadd_rn(a, __fmul_rn(cw_c, __fsub_rn(c, w)));
  return __fadd_rn(a, __fmul_rn(g, c));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  return v;
}

// Kernel C. Block (bx, by) owns canvas rows halo + by*kTileH + [0, kTileH)
// and columns bx*kTileW + [0, kTileW); thread (ty, tx) = (tid / 32, tid % 32)
// owns one point of it. pn = r + beta p_prev is live on the rows [lo, hi):
// the centre rows on one device; on a shard the band is widened by two rows
// on each side (lo = halo - 2, hi = rows - halo + 2), so pn is real on the
// width-2 halo ring, whose r and p_prev hold the neighbours' values, and t1
// next to the shard's edge reads them, not zeros
// (poisson_tpu/parallel/pallas_ca_sharded.py:212-220). When kMasked, the six
// unweighted Gram products are multiplied by colmask[col] before they are
// summed; the weighted six need no mask, since a shard's sc2 is zero outside
// the points it owns.
constexpr int kPw = kTileW + 4, kPh = kTileH + 4;  // pn: halo 2
constexpr int kTw = kTileW + 2, kTh = kTileH + 2;  // t1, r: halo 1

struct BasisShared {
  float pn[kPh][kPw];
  float t1[kTh][kTw];
  float r[kTh][kTw];
  float slots[kGram][kWarps];
};

template <bool kMasked>
__device__ __forceinline__ void basis_sweep_body(
    const float* __restrict__ beta_ptr, const float* __restrict__ pprev,
    const float* __restrict__ r, const float* __restrict__ cs,
    const float* __restrict__ cw, const float* __restrict__ g,
    const float* __restrict__ sc2, const float* __restrict__ colmask,
    float* __restrict__ pn, float* __restrict__ t1, float* __restrict__ t2,
    float* __restrict__ t3, float* __restrict__ gram, int cols, int halo,
    int lo, int hi, BasisShared& sh) {
  auto& s_pn = sh.pn;
  auto& s_t1 = sh.t1;
  auto& s_r = sh.r;
  auto& slots = sh.slots;

  const int tid = threadIdx.x;
  const int row0 = halo + blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const float beta = *beta_ptr;

  // pn over the tile plus 2: zero off the live band and beyond the edges.
  // Rows row0 - 2 .. row0 + kTileH + 1 lie inside the canvas (halo >= 2),
  // and so does the band (the wrapper checks halo - 2 <= lo, hi <= rows -
  // halo + 2).
  for (int i = tid; i < kPh * kPw; i += kThreads) {
    const int lr = i / kPw, lc = i % kPw;
    const int row = row0 - 2 + lr, col = col0 - 2 + lc;
    float v = 0.0f;
    if (row >= lo && row < hi && col >= 0 && col < cols) {
      const long long k = static_cast<long long>(row) * cols + col;
      v = __fadd_rn(r[k], __fmul_rn(beta, pprev[k]));
    }
    s_pn[lr][lc] = v;
  }
  // r over the tile plus 1, as stored (guard rows hold zeros, a shard's
  // halo rows its neighbours' values).
  for (int i = tid; i < kTh * kTw; i += kThreads) {
    const int lr = i / kTw, lc = i % kTw;
    const int row = row0 - 1 + lr, col = col0 - 1 + lc;
    s_r[lr][lc] = (col >= 0 && col < cols)
                      ? r[static_cast<long long>(row) * cols + col] : 0.0f;
  }
  __syncthreads();

  // t1 = A~ pn over the tile plus 1 (guard rows included, as the Pallas
  // kernel computes it on center +/- 1 rows); zero beyond the canvas edge,
  // which is what t2's column shifts bring in.
  for (int i = tid; i < kTh * kTw; i += kThreads) {
    const int lr = i / kTw, lc = i % kTw;
    const int row = row0 - 1 + lr, col = col0 - 1 + lc;
    float v = 0.0f;
    if (col >= 0 && col < cols) {
      const long long k = static_cast<long long>(row) * cols + col;
      const int pr = lr + 1, pc = lc + 1;
      v = stencil(s_pn[pr][pc], s_pn[pr + 1][pc], s_pn[pr - 1][pc],
                  s_pn[pr][pc + 1], s_pn[pr][pc - 1], cs[k + cols], cs[k],
                  col + 1 < cols ? cw[k + 1] : 0.0f, cw[k], g[k]);
    }
    s_t1[lr][lc] = v;
  }
  __syncthreads();

  const int ty = tid / kTileW, tx = tid % kTileW;
  const int row = row0 + ty, col = col0 + tx;
  const long long k = static_cast<long long>(row) * cols + col;
  const float cs_n = cs[k + cols], cs_c = cs[k], cw_c = cw[k], gk = g[k];
  const float cw_e = col + 1 < cols ? cw[k + 1] : 0.0f;
  const int y = ty + 1, x = tx + 1;
  const float p = s_pn[ty + 2][tx + 2];
  const float a = s_t1[y][x];
  const float b = stencil(a, s_t1[y + 1][x], s_t1[y - 1][x], s_t1[y][x + 1],
                          s_t1[y][x - 1], cs_n, cs_c, cw_e, cw_c, gk);
  const float rc = s_r[y][x];
  const float c = stencil(rc, s_r[y + 1][x], s_r[y - 1][x], s_r[y][x + 1],
                          s_r[y][x - 1], cs_n, cs_c, cw_e, cw_c, gk);
  pn[k] = p;
  t1[k] = a;
  t2[k] = b;
  t3[k] = c;

  const float w2 = sc2[k];
  float v[kGram] = {
      __fmul_rn(p, a),                       // a1 = <pn, t1>
      __fmul_rn(a, a),                       // b1 = <t1, t1>
      __fmul_rn(rc, a),                      // e  = <r, t1>
      __fmul_rn(rc, c),                      // f  = <r, t3>
      __fmul_rn(a, c),                       // g  = <t1, t3>
      __fmul_rn(a, b),                       // h  = <t1, t2>
      __fmul_rn(__fmul_rn(p, p), w2),        // wpp
      __fmul_rn(__fmul_rn(p, rc), w2),       // wpr
      __fmul_rn(__fmul_rn(p, a), w2),        // wpt
      __fmul_rn(__fmul_rn(rc, rc), w2),      // wrr
      __fmul_rn(__fmul_rn(rc, a), w2),       // wrt
      __fmul_rn(__fmul_rn(a, a), w2),        // wtt
  };
  if (kMasked) {
    const float m = colmask[col];
#pragma unroll
    for (int j = 0; j < kGram / 2; ++j) v[j] = __fmul_rn(v[j], m);
  }
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int j = 0; j < kGram; ++j) {
    const float s = warp_sum(v[j]);
    if (lane == 0) slots[j][warp] = s;
  }
  __syncthreads();
  if (tid < kGram) {
    float s = slots[tid][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, slots[tid][w]);
    const long long blk = static_cast<long long>(blockIdx.y) * gridDim.x
                          + blockIdx.x;
    gram[blk * kGram + tid] = s;
  }
}

// Kernel D. coefs = [c_p, a2, a2a1, alpha1, beta1, only1, 0, 0]:
//   r' = r - c_p t1 + a2a1 t2 - a2 t3
//   x' = x + c_p pn + a2 r - a2a1 t1
//   p1 = pn if only1 != 0 (the pair applied its first step only, so pn is
//        the next direction material), else r - alpha1 t1 + beta1 pn
// one partial of sum(r'^2) per block, each r'^2 multiplied by colmask[col]
// first when kMasked.
template <bool kMasked>
__device__ __forceinline__ void pair_update_body(
    const float* __restrict__ coefs, const float* __restrict__ pn,
    const float* __restrict__ t1, const float* __restrict__ t2,
    const float* __restrict__ t3, const float* __restrict__ colmask,
    float* __restrict__ x, float* __restrict__ r, float* __restrict__ p1,
    float* __restrict__ rr_part, int cols, int halo, float* slots) {
  const long long t = static_cast<long long>(blockIdx.x) * kThreads
                      + threadIdx.x;
  const long long i = static_cast<long long>(halo) * cols + t;
  const float c_p = coefs[0], a2 = coefs[1], a2a1 = coefs[2];
  const float alpha1 = coefs[3], beta1 = coefs[4];
  const bool only1 = coefs[5] != 0.0f;
  const float pv = pn[i], a = t1[i], rv = r[i];
  float rn = __fsub_rn(rv, __fmul_rn(c_p, a));
  rn = __fadd_rn(rn, __fmul_rn(a2a1, t2[i]));
  rn = __fsub_rn(rn, __fmul_rn(a2, t3[i]));
  float xn = __fadd_rn(x[i], __fmul_rn(c_p, pv));
  xn = __fadd_rn(xn, __fmul_rn(a2, rv));
  xn = __fsub_rn(xn, __fmul_rn(a2a1, a));
  const float pv1 = only1 ? pv
                          : __fadd_rn(__fsub_rn(rv, __fmul_rn(alpha1, a)),
                                      __fmul_rn(beta1, pv));
  x[i] = xn;
  r[i] = rn;
  p1[i] = pv1;

  float rr = __fmul_rn(rn, rn);
  if (kMasked) rr = __fmul_rn(rr, colmask[t % cols]);
  const float s = warp_sum(rr);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) slots[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = slots[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) sum = __fadd_rn(sum, slots[w]);
    rr_part[blockIdx.x] = sum;
  }
}

// The single-device forms and the sharded (masked) forms are separate
// kernels with names neither of which contains the other, so a profiler
// trace tells them apart by name.
__global__ void __launch_bounds__(kThreads)
basis_sweep_kernel(const float* __restrict__ beta,
                   const float* __restrict__ pprev,
                   const float* __restrict__ r,
                   const float* __restrict__ cs,
                   const float* __restrict__ cw,
                   const float* __restrict__ g,
                   const float* __restrict__ sc2, float* __restrict__ pn,
                   float* __restrict__ t1, float* __restrict__ t2,
                   float* __restrict__ t3, float* __restrict__ gram,
                   int cols, int halo, int lo, int hi) {
  __shared__ BasisShared sh;
  basis_sweep_body<false>(beta, pprev, r, cs, cw, g, sc2, nullptr, pn, t1,
                          t2, t3, gram, cols, halo, lo, hi, sh);
}

__global__ void __launch_bounds__(kThreads)
basis_sweep_sharded(const float* __restrict__ beta,
                    const float* __restrict__ pprev,
                    const float* __restrict__ r,
                    const float* __restrict__ cs,
                    const float* __restrict__ cw,
                    const float* __restrict__ g,
                    const float* __restrict__ sc2,
                    const float* __restrict__ colmask,
                    float* __restrict__ pn, float* __restrict__ t1,
                    float* __restrict__ t2, float* __restrict__ t3,
                    float* __restrict__ gram, int cols, int halo, int lo,
                    int hi) {
  __shared__ BasisShared sh;
  basis_sweep_body<true>(beta, pprev, r, cs, cw, g, sc2, colmask, pn, t1,
                         t2, t3, gram, cols, halo, lo, hi, sh);
}

__global__ void __launch_bounds__(kThreads)
pair_update_kernel(const float* __restrict__ coefs,
                   const float* __restrict__ pn,
                   const float* __restrict__ t1,
                   const float* __restrict__ t2,
                   const float* __restrict__ t3, float* __restrict__ x,
                   float* __restrict__ r, float* __restrict__ p1,
                   float* __restrict__ rr_part, int cols, int halo) {
  __shared__ float slots[kWarps];
  pair_update_body<false>(coefs, pn, t1, t2, t3, nullptr, x, r, p1, rr_part,
                          cols, halo, slots);
}

__global__ void __launch_bounds__(kThreads)
pair_update_sharded(const float* __restrict__ coefs,
                    const float* __restrict__ pn,
                    const float* __restrict__ t1,
                    const float* __restrict__ t2,
                    const float* __restrict__ t3,
                    const float* __restrict__ colmask,
                    float* __restrict__ x, float* __restrict__ r,
                    float* __restrict__ p1, float* __restrict__ rr_part,
                    int cols, int halo) {
  __shared__ float slots[kWarps];
  pair_update_body<true>(coefs, pn, t1, t2, t3, colmask, x, r, p1, rr_part,
                         cols, halo, slots);
}

}  // namespace

extern "C" {

// The partial layouts the Python side must reproduce.
void ca_cg_layout(int* tile_rows, int* tile_cols, int* threads) {
  *tile_rows = kTileH;
  *tile_cols = kTileW;
  *threads = kThreads;
}

const char* ca_cg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry launches one kernel on `stream` (PyTorch's current stream of
// `device`) and returns cudaGetLastError(): a launch the runtime refused
// never runs, and a later synchronise would not report it. A null `colmask`
// launches the single-device form, any other the sharded (masked) form.
int ca_cg_basis_sweep(const float* beta, const float* pprev, const float* r,
                      const float* cs, const float* cw, const float* g,
                      const float* sc2, const float* colmask, float* pn,
                      float* t1, float* t2, float* t3, float* gram, int rows,
                      int cols, int halo, int lo, int hi, int device,
                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(cols / kTileW, (rows - 2 * halo) / kTileH);
  if (colmask == nullptr) {
    basis_sweep_kernel<<<grid, kThreads, 0, stream>>>(
        beta, pprev, r, cs, cw, g, sc2, pn, t1, t2, t3, gram, cols, halo, lo,
        hi);
  } else {
    basis_sweep_sharded<<<grid, kThreads, 0, stream>>>(
        beta, pprev, r, cs, cw, g, sc2, colmask, pn, t1, t2, t3, gram, cols,
        halo, lo, hi);
  }
  return static_cast<int>(cudaGetLastError());
}

int ca_cg_pair_update(const float* coefs, const float* pn, const float* t1,
                      const float* t2, const float* t3, const float* colmask,
                      float* x, float* r, float* p1, float* rr_part, int cols,
                      int halo, int blocks, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (colmask == nullptr) {
    pair_update_kernel<<<blocks, kThreads, 0, stream>>>(
        coefs, pn, t1, t2, t3, x, r, p1, rr_part, cols, halo);
  } else {
    pair_update_sharded<<<blocks, kThreads, 0, stream>>>(
        coefs, pn, t1, t2, t3, colmask, x, r, p1, rr_part, cols, halo);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
