// Kernels A and B of the fused two-sweep PCG iteration, for Hopper (sm_90a),
// and the two halves of its scalar recurrence.
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrappers are direction_and_stencil and fused_update in
// poisson_tpu_torch/ops/fused_cg.py, each beside its plain PyTorch version,
// and Recurrence.step_size and Recurrence.close in
// poisson_tpu_torch/ops/recurrence.py, beside theirs (the *_plain methods).
//
// Kernel A, direction_stencil, replaces the Pallas kernel
// poisson_tpu/ops/pallas_cg.py:_make_direction_stencil_kernel (pallas_call in
// direction_and_stencil). Kernel B, fused_update, replaces
// poisson_tpu/ops/pallas_cg.py:_make_update_kernel (pallas_call in
// fused_update). Each has a second form for the sharded solve
// (poisson_tpu_torch/parallel/fused_sharded.py), the counterpart of the
// Pallas kernels' `masked` form with a widened `band`
// (poisson_tpu/parallel/pallas_sharded.py:210,228): a shard's canvas holds
// its neighbours' values in its halo columns, so a (1, cols) column mask
// keeps them out of the sums. The sharded forms differ from the
// single-device ones in that multiply and, for kernel A, in storing the
// direction on the shard's halo rows; the band [lo, hi) is a runtime
// argument of kernel A in both.
//
// Canvas: rows x cols fp32, row-major. The centre rows are
// [halo, rows - halo) x all columns; they are contiguous in memory and
// (rows - 2 halo) * cols is a multiple of kBlock (rows - 2 halo is a multiple
// of 8 and cols of 128), so the grid covers them exactly with one thread
// per point and needs no tail masking. Guard rows are never written, except
// a shard's halo rows of pn (kernel A): the caller allocates the outputs
// zeroed once, which keeps the rest zero.
//
// Bound on the H100: memory. Each kernel reads 5 canvases and writes 2, about
// 7 x 4 bytes per point against 17 (A) or 9 (B) flops per point, far
// below the ~20 flops per byte where the card's fp32 rate (67 TFLOP/s) would
// bind. At the
// flagship 816 x 1280 canvas that is about 29 MB a sweep, ~8.7 us at
// 3.35 TB/s. The design does the one thing that matters for that bound: each
// kernel is one sweep that fuses what would otherwise be separate passes
// (direction update, stencil and dot in A; two axpys and two dots in B), and
// recomputes the direction at the four neighbours in registers instead of
// reading a stored direction back (A reads z and p, never pn). Loads are
// coalesced: neighbouring threads own neighbouring columns, rows are
// 512-byte aligned, and the +/-1 row and column neighbours come through L1/L2.
// Shared-memory tiling, TMA and a CUDA graph over the iteration are later
// work.
//
// Arithmetic is written with explicit round-to-nearest intrinsics in the
// same order as the plain PyTorch versions, so no multiply-add is contracted
// and pn, Ap, w and r agree with them bit for bit; only the per-block sums
// differ, in their order of summation.
//
// Reductions: each block writes one partial per sum (warp shuffles, then one
// shared-memory slot per warp). No atomics, so the partials, and the
// iteration count that depends on them, are the same on every run. The
// caller sums the partials vector with plain PyTorch, as jnp.sum does for the
// Pallas kernels' per-strip partials.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 256;  // threads per block = points per partial
constexpr int kWarps = kBlock / 32;

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

// The new direction z + beta * p at element i, or 0 off the live band and
// beyond the canvas edge (shifts bring in zeros, never wrap around).
__device__ __forceinline__ float direction(const float* __restrict__ z,
                                           const float* __restrict__ p,
                                           float beta, long long i,
                                           bool live) {
  return live ? __fadd_rn(z[i], __fmul_rn(beta, p[i])) : 0.0f;
}

// Kernel A: pn = z + beta p on the live band [lo, hi); Ap = A~ pn in
// difference form on the centre rows [halo, rows - halo)
//   Ap_c = cS_{i+1} (pn_c - pn_{i+1}) + cS_i (pn_c - pn_{i-1})
//        + cW_{j+1} (pn_c - pn_{j+1}) + cW_j (pn_c - pn_{j-1}) + g pn_c;
// one partial of sum(Ap * pn) per block. pn must not alias p or z: the
// neighbours' threads read p at this point.
//
// The single-device band is the centre rows. A shard widens it by one row
// on each side (lo = halo - 1, hi = rows - halo + 1): its halo rows of z
// and p hold the neighbour's values, so the direction there is the one the
// neighbour forms for its own edge row, with the same two roundings. The
// sharded form (kSharded) has the threads of the first and last centre row
// also store it into pn's halo rows, which the next iteration reads as p,
// so p's halos are never exchanged
// (poisson_tpu/parallel/pallas_sharded.py:10-20,217-219), and multiplies
// each product by colmask[col] before it is summed.
template <bool kSharded>
__device__ __forceinline__ void direction_stencil_body(
    const float* __restrict__ beta_ptr, const float* __restrict__ z,
    const float* __restrict__ p, const float* __restrict__ cs,
    const float* __restrict__ cw, const float* __restrict__ g,
    const float* __restrict__ colmask, float* __restrict__ pn,
    float* __restrict__ ap, float* __restrict__ part, int rows, int cols,
    int halo, int lo, int hi, float* slots) {
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const int row = halo + static_cast<int>(t / cols);
  const int col = static_cast<int>(t % cols);
  const long long i = static_cast<long long>(row) * cols + col;
  const float beta = *beta_ptr;

  const float c = direction(z, p, beta, i, true);
  const float north = direction(z, p, beta, i + cols, row + 1 < hi);
  const float south = direction(z, p, beta, i - cols, row - 1 >= lo);
  const float east = direction(z, p, beta, i + 1, col + 1 < cols);
  const float west = direction(z, p, beta, i - 1, col >= 1);
  const float cw_east = col + 1 < cols ? cw[i + 1] : 0.0f;

  float a = __fmul_rn(cs[i + cols], __fsub_rn(c, north));
  a = __fadd_rn(a, __fmul_rn(cs[i], __fsub_rn(c, south)));
  a = __fadd_rn(a, __fmul_rn(cw_east, __fsub_rn(c, east)));
  a = __fadd_rn(a, __fmul_rn(cw[i], __fsub_rn(c, west)));
  a = __fadd_rn(a, __fmul_rn(g[i], c));
  pn[i] = c;
  ap[i] = a;
  if (kSharded && row == halo && lo < halo) pn[i - cols] = south;
  if (kSharded && row == rows - halo - 1 && hi > rows - halo)
    pn[i + cols] = north;

  float prod = __fmul_rn(a, c);
  if (kSharded) prod = __fmul_rn(prod, colmask[col]);
  const float s = block_sum(prod, slots);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

// Kernel B: w += alpha p, r -= alpha Ap in place on the centre rows (each
// thread owns its element, so in place is safe); one partial each of
// sum(p^2 sc2) and sum(r_new^2) per block, r_new^2 multiplied by
// colmask[col] first when kMasked. sum(p^2 sc2) needs no mask: a shard's
// sc2 is zero outside the columns it owns.
template <bool kMasked>
__device__ __forceinline__ void fused_update_body(
    const float* __restrict__ alpha_ptr, const float* __restrict__ p,
    const float* __restrict__ ap, const float* __restrict__ sc2,
    const float* __restrict__ colmask, float* __restrict__ w,
    float* __restrict__ r, float* __restrict__ diff_part,
    float* __restrict__ zr_part, int cols, int halo, float* diff_slots,
    float* zr_slots) {
  const long long t = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;
  const long long i = static_cast<long long>(halo) * cols + t;
  const float alpha = *alpha_ptr;
  const float pv = p[i];
  const float rn = __fsub_rn(r[i], __fmul_rn(alpha, ap[i]));
  w[i] = __fadd_rn(w[i], __fmul_rn(alpha, pv));
  r[i] = rn;

  float rr = __fmul_rn(rn, rn);
  if (kMasked) rr = __fmul_rn(rr, colmask[t % cols]);
  const float d = block_sum(__fmul_rn(__fmul_rn(pv, pv), sc2[i]), diff_slots);
  const float zz = block_sum(rr, zr_slots);
  if (threadIdx.x == 0) {
    diff_part[blockIdx.x] = d;
    zr_part[blockIdx.x] = zz;
  }
}

// The single-device forms and the sharded (masked) forms are separate
// kernels with names neither of which contains the other, so a profiler
// trace tells them apart by name.
__global__ void __launch_bounds__(kBlock)
direction_stencil_kernel(const float* __restrict__ beta,
                         const float* __restrict__ z,
                         const float* __restrict__ p,
                         const float* __restrict__ cs,
                         const float* __restrict__ cw,
                         const float* __restrict__ g,
                         float* __restrict__ pn, float* __restrict__ ap,
                         float* __restrict__ part, int rows, int cols,
                         int halo, int lo, int hi) {
  __shared__ float slots[kWarps];
  direction_stencil_body<false>(beta, z, p, cs, cw, g, nullptr, pn, ap, part,
                                rows, cols, halo, lo, hi, slots);
}

__global__ void __launch_bounds__(kBlock)
direction_stencil_sharded(const float* __restrict__ beta,
                          const float* __restrict__ z,
                          const float* __restrict__ p,
                          const float* __restrict__ cs,
                          const float* __restrict__ cw,
                          const float* __restrict__ g,
                          const float* __restrict__ colmask,
                          float* __restrict__ pn, float* __restrict__ ap,
                          float* __restrict__ part, int rows, int cols,
                          int halo, int lo, int hi) {
  __shared__ float slots[kWarps];
  direction_stencil_body<true>(beta, z, p, cs, cw, g, colmask, pn, ap, part,
                               rows, cols, halo, lo, hi, slots);
}

__global__ void __launch_bounds__(kBlock)
fused_update_kernel(const float* __restrict__ alpha,
                    const float* __restrict__ p,
                    const float* __restrict__ ap,
                    const float* __restrict__ sc2, float* __restrict__ w,
                    float* __restrict__ r, float* __restrict__ diff_part,
                    float* __restrict__ zr_part, int cols, int halo) {
  __shared__ float diff_slots[kWarps];
  __shared__ float zr_slots[kWarps];
  fused_update_body<false>(alpha, p, ap, sc2, nullptr, w, r, diff_part,
                           zr_part, cols, halo, diff_slots, zr_slots);
}

__global__ void __launch_bounds__(kBlock)
fused_update_sharded(const float* __restrict__ alpha,
                     const float* __restrict__ p,
                     const float* __restrict__ ap,
                     const float* __restrict__ sc2,
                     const float* __restrict__ colmask,
                     float* __restrict__ w, float* __restrict__ r,
                     float* __restrict__ diff_part,
                     float* __restrict__ zr_part, int cols, int halo) {
  __shared__ float diff_slots[kWarps];
  __shared__ float zr_slots[kWarps];
  fused_update_body<true>(alpha, p, ap, sc2, colmask, w, r, diff_part,
                          zr_part, cols, halo, diff_slots, zr_slots);
}

// The scalar recurrence of one iteration, which the fused body and the
// sharded one (on the mesh's lead card) run between the sweeps:
// recurrence_step between A's sum and B, recurrence_close after B's two
// sums. Each is one thread of one block: a chain of about a dozen dependent
// scalar operations on a few 0-d tensors, bound by its latency, never by
// bytes or flops. Each replaces the torch operations of its plain version
// (7 and 17 of them, each one small kernel or more) by one launch.
//
// Every operation is rounded alone, as each torch operation rounds its
// result: explicit round-to-nearest intrinsics, so nothing is contracted
// into a multiply-add, and IEEE division and square root, so α, ζ, β and
// diff are the plain version's bits. The constants h1·h2, the norm's
// weight and δ come in by value, as the fp32 values the plain version's
// tensors hold. kDenomTol is the degenerate-direction guard
// (solvers/pcg.py _DENOM_TOL): torch compares an fp32 tensor with that
// Python float in fp32, so the kernel compares with it rounded to fp32.
constexpr float kDenomTol = 1e-15f;

// α and `degenerate` from Σ⟨Ap, p⟩: denom = Σ·h1h2; a direction with
// |denom| < kDenomTol is degenerate and gets α = 0, as does a done state;
// else α = ζ / denom.
__global__ void __launch_bounds__(1)
recurrence_step_kernel(const float* __restrict__ denom_sum,
                       const float* __restrict__ zr,
                       const bool* __restrict__ done,
                       float* __restrict__ alpha,
                       bool* __restrict__ degenerate, float h1h2) {
  const float denom = __fmul_rn(*denom_sum, h1h2);
  const bool deg = fabsf(denom) < kDenomTol;
  *alpha = (deg || *done) ? 0.0f : __fdiv_rn(*zr, denom);
  *degenerate = deg;
}

// k, done, ζ, β and diff after the step, from α, `degenerate`, Σ p²·sc²
// and Σ r²: diff = |α|·sqrt(Σ p²·sc² · norm_w), ζ' = Σ r²·h1h2,
// β = ζ' / ζ (ζ = 0 read as 1), done once degenerate or diff < δ. A done
// state is frozen: k, ζ, β and diff keep their values.
__global__ void __launch_bounds__(1)
recurrence_close_kernel(const float* __restrict__ alpha,
                        const bool* __restrict__ degenerate,
                        const float* __restrict__ diff_sum,
                        const float* __restrict__ zr_sum,
                        const int* __restrict__ k,
                        const bool* __restrict__ done,
                        const float* __restrict__ zr,
                        const float* __restrict__ beta,
                        const float* __restrict__ diff,
                        int* __restrict__ k_out, bool* __restrict__ done_out,
                        float* __restrict__ zr_out,
                        float* __restrict__ beta_out,
                        float* __restrict__ diff_out, float h1h2,
                        float norm_w, float delta) {
  const float d = __fmul_rn(fabsf(*alpha),
                            __fsqrt_rn(__fmul_rn(*diff_sum, norm_w)));
  const float zr_new = __fmul_rn(*zr_sum, h1h2);
  const bool frozen = *done;
  const float zr_old = *zr;
  *k_out = frozen ? *k : *k + 1;
  *done_out = frozen || *degenerate || d < delta;
  *zr_out = frozen ? zr_old : zr_new;
  *beta_out = frozen ? *beta
                     : __fdiv_rn(zr_new, zr_old == 0.0f ? 1.0f : zr_old);
  *diff_out = frozen ? *diff : d;
}

}  // namespace

extern "C" {

int fused_cg_block_size() { return kBlock; }

const char* fused_cg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each entry launches one kernel on `stream` (PyTorch's current stream of
// `device`) over `blocks` blocks and returns cudaGetLastError(): a launch the
// runtime refused never runs, and a later synchronise would not report it.
// A null `colmask` launches the single-device form, any other the sharded
// (masked) form.
int fused_cg_direction_stencil(const float* beta, const float* z,
                               const float* p, const float* cs,
                               const float* cw, const float* g,
                               const float* colmask, float* pn, float* ap,
                               float* part, int rows, int cols, int halo,
                               int lo, int hi, int blocks, int device,
                               cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (colmask == nullptr) {
    direction_stencil_kernel<<<blocks, kBlock, 0, stream>>>(
        beta, z, p, cs, cw, g, pn, ap, part, rows, cols, halo, lo, hi);
  } else {
    direction_stencil_sharded<<<blocks, kBlock, 0, stream>>>(
        beta, z, p, cs, cw, g, colmask, pn, ap, part, rows, cols, halo, lo,
        hi);
  }
  return static_cast<int>(cudaGetLastError());
}

int fused_cg_update(const float* alpha, const float* p, const float* ap,
                    const float* sc2, const float* colmask, float* w,
                    float* r, float* diff_part, float* zr_part, int cols,
                    int halo, int blocks, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (colmask == nullptr) {
    fused_update_kernel<<<blocks, kBlock, 0, stream>>>(
        alpha, p, ap, sc2, w, r, diff_part, zr_part, cols, halo);
  } else {
    fused_update_sharded<<<blocks, kBlock, 0, stream>>>(
        alpha, p, ap, sc2, colmask, w, r, diff_part, zr_part, cols, halo);
  }
  return static_cast<int>(cudaGetLastError());
}

// The recurrence's two halves, each one thread on `stream`. The outputs are
// fresh tensors, none aliasing an input.
int fused_cg_recurrence_step(const float* denom_sum, const float* zr,
                             const bool* done, float* alpha,
                             bool* degenerate, float h1h2, int device,
                             cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  recurrence_step_kernel<<<1, 1, 0, stream>>>(denom_sum, zr, done, alpha,
                                              degenerate, h1h2);
  return static_cast<int>(cudaGetLastError());
}

int fused_cg_recurrence_close(const float* alpha, const bool* degenerate,
                              const float* diff_sum, const float* zr_sum,
                              const int* k, const bool* done,
                              const float* zr, const float* beta,
                              const float* diff, int* k_out, bool* done_out,
                              float* zr_out, float* beta_out,
                              float* diff_out, float h1h2, float norm_w,
                              float delta, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  recurrence_close_kernel<<<1, 1, 0, stream>>>(
      alpha, degenerate, diff_sum, zr_sum, k, done, zr, beta, diff, k_out,
      done_out, zr_out, beta_out, diff_out, h1h2, norm_w, delta);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
