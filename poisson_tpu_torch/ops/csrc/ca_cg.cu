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
// are below the ~20 flops per byte where the fp32 rate (67 TFLOP/s) would
// bind: at 800 x 1200 C moves 41 MB (12.2 us at 3.35 TB/s), D 37 MB. C
// also issues many instructions per point (three stencils, twelve products
// and their sums across the warp), and its shuffles and shared-memory loads
// share one pipe per SM, so it only nears the memory bound when its loads
// overlap its arithmetic and its sums take few shuffles.
//
// Design of C: a row-marching sweep. t2 at a point needs t1 at its four
// neighbours and t1 needs pn at radius 2, so a block must never read t1 or
// pn from global memory that another block writes in the same launch. A
// block owns a strip of kStripW columns (one thread each, warp w the w-th
// 32-column Gram tile) and a segment of seg_h band rows (a multiple of 8,
// chosen by the wrapper so that the grid fills the card,
// ca_cg.sweep_geometry), and marches down it one row at a time. At step j
// it stages input row L = seg0 - 2 + j (r, p_prev, cS, cW, g, sc2 over the
// strip plus 4 columns each side) and, from rows already staged, forms pn
// on row L and t2, t3 and the Gram products on row L - 3, then, after one
// barrier, t1 on row L - 1: two barriers per row.
//   - inputs arrive by cp.async, kAhead rows ahead of the row computed, in
//     a ring of kAhead + 5 rows (t3 reads r four rows back), so a row's
//     loads overlap the arithmetic of the rows before it; each input is
//     read from global memory once per strip, plus 4 staged columns on each
//     side and the 5 rows past a segment (from L2);
//   - pn and t1 live in rings of four rows; the rings are powers of two,
//     indexed by a mask, since a thread computes one point per step and
//     every instruction of the step counts per point; the coefficients t1
//     loads for its row stay in registers for t2 and t3 two steps later,
//     so each is read from shared memory once per point;
//   - pn on the two halo columns each side, and t1 on one, are formed by
//     four lanes of one warp and two of another; t1 on a segment's edge
//     rows and on the halo columns is recomputed by the same device
//     function, in the same order, as the block that owns it, so it is the
//     same bits;
//   - loops walk rows and fixed column offsets: no division per point.
// Partials keep the (tiles, 12) layout, one set per 8 x 32 tile in
// n_tiles order, formed with the same bits: each row's 32 lanes summed in
// warp_sum's tree (sum_lanes does the twelve at once), then the 8 row sums
// added in row order.
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
// Reductions: each block writes its partials (12 per Gram tile for C in the
// order a1 b1 e f g h | wpp wpr wpt wrr wrt wtt, one per block for D) with
// warp shuffles, summed in a fixed order. No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kTileW = 32;                 // C: Gram tile columns (one warp)
constexpr int kTileH = 8;                  // C: Gram tile rows
constexpr int kThreads = 256;              // D: threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kGram = 12;

// Kernel C's row march.
constexpr int kStripW = 128;               // block columns, one thread each
constexpr int kSweepThreads = kStripW;
constexpr int kPad = 4;                    // staged columns each side (16 B)
constexpr int kRowW = kStripW + 2 * kPad;  // floats per staged row
constexpr int kAhead = 3;                  // rows in flight past the one used
// The input ring: rows L - 4 .. L + kAhead, the oldest read by t3 on the
// centre row L - 3; a thread refills the slot of row L - 5 before the
// step's first barrier, when every thread has left the phase that read it.
constexpr int kSlots = kAhead + 5;
constexpr int kRing = 4;                   // pn and t1 rows kept (3 in use)
static_assert((kSlots & (kSlots - 1)) == 0 && (kRing & (kRing - 1)) == 0,
              "rings are indexed by a mask");
constexpr int kInputs = 6;                 // r, p_prev, cS, cW, g, sc2
constexpr int kChunks = kRowW / 4;         // 16-byte copies per staged row
constexpr int kCopies = kInputs * kChunks; // copies per ring slot
constexpr int kCopiesPerThread = (kCopies + kSweepThreads - 1) / kSweepThreads;
enum { kR, kP, kCS, kCW, kG, kSC2 };

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

// Kernel C. Block (bx, by) owns columns bx*kStripW + [0, kStripW) and band
// rows halo + by*seg_h + [0, seg_h) (the last segment ends at the band's
// end); thread t owns column c0 + t. pn = r + beta p_prev is live on the
// rows [lo, hi): the centre rows on one device; on a shard the band is
// widened by two rows on each side (lo = halo - 2, hi = rows - halo + 2), so
// pn is real on the width-2 halo ring, whose r and p_prev hold the
// neighbours' values, and t1 next to the shard's edge reads them, not zeros
// (poisson_tpu/parallel/pallas_ca_sharded.py:212-220). When kMasked, the six
// unweighted Gram products are multiplied by colmask[col] before they are
// summed; the weighted six need no mask, since a shard's sc2 is zero outside
// the points it owns.
// The twelve warp sums of one row at once: a transposed xor butterfly over
// sixteen slots (the last four zero). At the step of offset 2H each lane
// keeps half of its slots, by that bit of its lane, and adds its partner's
// copy of them, so after four steps lane l holds slot l >> 1 summed over
// the 16 lanes that share its bit 0, and the last step adds lane l ^ 1.
// Every slot is summed over the same pairs, level by level, as warp_sum's
// shfl_down tree sums it into lane 0, and a + b rounds as b + a, so each
// sum has warp_sum's bits, in 16 shuffles for the twelve instead of 60.
// Shuffles and shared-memory loads share one pipe, which bounds this
// kernel from L2. Each step is its own instantiation, so every index is a
// constant and x stays in registers (ptxas: no stack frame).
template <int H>
__device__ __forceinline__ void fold(float (&x)[16], int lane) {
  const bool upper = (lane & (2 * H)) != 0;
#pragma unroll
  for (int q = 0; q < H; ++q) {
    const float keep = upper ? x[q + H] : x[q];
    const float send = upper ? x[q] : x[q + H];
    x[q] = __fadd_rn(keep, __shfl_xor_sync(0xffffffffu, send, 2 * H));
  }
}

__device__ __forceinline__ float sum_lanes(const float (&v)[kGram]) {
  const int lane = threadIdx.x & 31;
  float x[16];
#pragma unroll
  for (int q = 0; q < 16; ++q) x[q] = q < kGram ? v[q] : 0.0f;
  fold<8>(x, lane);
  fold<4>(x, lane);
  fold<2>(x, lane);
  fold<1>(x, lane);
  return __fadd_rn(x[0], __shfl_xor_sync(0xffffffffu, x[0], 1));
}

struct SweepShared {
  float in[kSlots][kInputs][kRowW];   // staged rows, column c0 - kPad + x
  float pn[kRing][kRowW];             // pn rows, same columns
  float t1[kRing][kRowW];             // t1 rows, same columns
};

__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  // A copy past the canvas edge reads nothing and fills zeros.
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void copy_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead) : "memory");
}

__device__ __forceinline__ const float* input_field(
    int f, const float* r, const float* pprev, const float* cs,
    const float* cw, const float* g, const float* sc2) {
  switch (f) {
    case kR: return r;
    case kP: return pprev;
    case kCS: return cs;
    case kCW: return cw;
    case kG: return g;
    default: return sc2;
  }
}

template <bool kMasked>
__device__ __forceinline__ void basis_sweep_body(
    const float* __restrict__ beta_ptr, const float* __restrict__ pprev,
    const float* __restrict__ r, const float* __restrict__ cs,
    const float* __restrict__ cw, const float* __restrict__ g,
    const float* __restrict__ sc2, const float* __restrict__ colmask,
    float* __restrict__ pn, float* __restrict__ t1, float* __restrict__ t2,
    float* __restrict__ t3, float* __restrict__ gram, int rows, int cols,
    int halo, int lo, int hi, int seg_h, SweepShared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * kStripW;
  const int seg0 = halo + blockIdx.y * seg_h;
  const int seg1 = min(seg0 + seg_h, rows - halo);
  const int first = seg0 - 2;          // first staged row
  const int steps = seg1 - seg0 + 5;   // staged rows: seg0 - 2 .. seg1 + 2
  const int col = c0 + tid;
  const int x = kPad + tid;            // the thread's column in a staged row
  const float beta = *beta_ptr;
  const float m = kMasked ? colmask[col] : 1.0f;
  const int tiles_per_row = cols / kTileW;

  // The thread's copies of each staged row: field, column, and whether the
  // column lies on the canvas (a chunk lies wholly on or off it).
  const float* src[kCopiesPerThread];
  int dst[kCopiesPerThread];
  bool live[kCopiesPerThread], on[kCopiesPerThread];
#pragma unroll
  for (int k = 0; k < kCopiesPerThread; ++k) {
    const int q = tid + k * kSweepThreads;
    const int f = q / kChunks, ch = q - f * kChunks;
    const int c = c0 - kPad + 4 * ch;
    live[k] = q < kCopies;
    on[k] = c >= 0 && c < cols;
    src[k] = input_field(live[k] ? f : 0, r, pprev, cs, cw, g, sc2)
             + (on[k] ? c : 0);
    dst[k] = f * kRowW + 4 * ch;
  }
  // Row first + j goes to ring slot j & (kSlots - 1); the rows' offsets
  // advance by one row per step.
  long long src_off = static_cast<long long>(first) * cols;
  auto stage = [&](int j) {
    if (j < steps) {
      float* slot = &sh.in[j & (kSlots - 1)][0][0];
#pragma unroll
      for (int k = 0; k < kCopiesPerThread; ++k)
        if (live[k]) copy16(slot + dst[k], src[k] + src_off, on[k]);
    }
    src_off += cols;
    copy_commit();             // one group per step, empty or not
  };

  for (int j = 0; j < kAhead; ++j) stage(j);
  // The coefficients of t1's row, carried to the step whose centre row it
  // is: set a for row L - 3 (used at step j), set b for row L - 2.
  float a_cs_n = 0.0f, a_cs_c = 0.0f, a_cw_c = 0.0f, a_cw_e = 0.0f;
  float a_g = 0.0f;
  float b_cs_n = 0.0f, b_cs_c = 0.0f, b_cw_c = 0.0f, b_cw_e = 0.0f;
  float b_g = 0.0f;
  float acc = 0.0f;
  long long out_k = static_cast<long long>(seg0) * cols + col;

  // Step j (row L = first + j), two phases between barriers: pn on row L
  // and the centre row L - 3, then t1 on row L - 1. Ring slots: input row
  // first + i in slot i & (kSlots - 1), pn and t1 row first + i in slot
  // i & (kRing - 1).
  for (int j = 0; j < steps; ++j) {
    stage(j + kAhead);
    copy_wait_ahead();         // this thread's copies of row j have landed
    __syncthreads();           // ... and every thread's; t1 of row L - 2 too
    const int L = first + j;
    const float (*in)[kRowW] = sh.in[j & (kSlots - 1)];

    // pn on row L: every thread its column (on the canvas), four lanes of
    // warp 2 the halo columns c0 - 2, c0 - 1, c0 + kStripW, c0 + kStripW + 1
    // (zero past the canvas edge).
    const bool row_live = L >= lo && L < hi;
    float* pn_l = sh.pn[j & (kRing - 1)];
    pn_l[x] = row_live ? __fadd_rn(in[kR][x], __fmul_rn(beta, in[kP][x]))
                       : 0.0f;
    if (warp == 2 && lane < 4) {
      const int xx = lane < 2 ? kPad - 2 + lane : kPad + kStripW + lane - 2;
      const int c = c0 - kPad + xx;
      pn_l[xx] = (row_live && c >= 0 && c < cols)
                     ? __fadd_rn(in[kR][xx], __fmul_rn(beta, in[kP][xx]))
                     : 0.0f;
    }

    // t2, t3 and the Gram products on the centre row L - 3, from t1 on rows
    // L - 4 .. L - 2 and the coefficients t1 loaded for the row.
    if (j >= 5) {
      const int row = L - 3;
      const float* tc = sh.t1[(j - 3) & (kRing - 1)];
      const float* tn = sh.t1[(j - 2) & (kRing - 1)];
      const float* ts = sh.t1[(j - 4) & (kRing - 1)];
      const float (*in_r)[kRowW] = sh.in[(j - 3) & (kSlots - 1)];
      const float* rc_row = in_r[kR];
      const float* rn_row = sh.in[(j - 2) & (kSlots - 1)][kR];
      const float* rs_row = sh.in[(j - 4) & (kSlots - 1)][kR];
      const float p = sh.pn[(j - 3) & (kRing - 1)][x];
      const float a = tc[x];
      const float b = stencil(a, tn[x], ts[x], tc[x + 1], tc[x - 1], a_cs_n,
                              a_cs_c, a_cw_e, a_cw_c, a_g);
      const float rc = rc_row[x];
      const float c = stencil(rc, rn_row[x], rs_row[x], rc_row[x + 1],
                              rc_row[x - 1], a_cs_n, a_cs_c, a_cw_e, a_cw_c,
                              a_g);
      pn[out_k] = p;
      t1[out_k] = a;
      t2[out_k] = b;
      t3[out_k] = c;
      out_k += cols;

      const float w2 = in_r[kSC2][x];
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
#pragma unroll
        for (int q = 0; q < kGram / 2; ++q) v[q] = __fmul_rn(v[q], m);
      }
      // A tile's sums: each row's 32 lanes summed (sum_lanes, warp_sum's
      // tree), the 8 rows added in order; lane 2q holds sum q.
      const int tile_row = (row - seg0) & (kTileH - 1);
      const float s = sum_lanes(v);
      acc = tile_row == 0 ? s : __fadd_rn(acc, s);
      if (tile_row == kTileH - 1 && (lane & 1) == 0 && lane < 2 * kGram) {
        const long long tile = static_cast<long long>((row - halo) / kTileH)
                               * tiles_per_row + c0 / kTileW + warp;
        gram[tile * kGram + (lane >> 1)] = acc;
      }
    }
    a_cs_n = b_cs_n;
    a_cs_c = b_cs_c;
    a_cw_c = b_cw_c;
    a_cw_e = b_cw_e;
    a_g = b_g;
    __syncthreads();           // pn of row L
    if (j < 2 || j == steps - 1) continue;   // the last step needs no t1

    // t1 on row L - 1 (from pn on rows L - 2 .. L): every thread its
    // column, two lanes of warp 3 the halo columns c0 - 1 and c0 + kStripW
    // (zero past the canvas edge, which is what t2's shifts bring in).
    const float (*in_c)[kRowW] = sh.in[(j - 1) & (kSlots - 1)];   // L - 1
    const float* pc = sh.pn[(j - 1) & (kRing - 1)];
    const float* pns = sh.pn[(j - 2) & (kRing - 1)];
    float* t1_c = sh.t1[(j - 1) & (kRing - 1)];
    b_cs_n = in[kCS][x];
    b_cs_c = in_c[kCS][x];
    b_cw_c = in_c[kCW][x];
    b_cw_e = in_c[kCW][x + 1];
    b_g = in_c[kG][x];
    t1_c[x] = stencil(pc[x], pn_l[x], pns[x], pc[x + 1], pc[x - 1], b_cs_n,
                      b_cs_c, b_cw_e, b_cw_c, b_g);
    if (warp == 3 && lane < 2) {
      const int xx = lane == 0 ? kPad - 1 : kPad + kStripW;
      const int c = c0 - kPad + xx;
      t1_c[xx] = (c >= 0 && c < cols)
                     ? stencil(pc[xx], pn_l[xx], pns[xx], pc[xx + 1],
                               pc[xx - 1], in[kCS][xx], in_c[kCS][xx],
                               in_c[kCW][xx + 1], in_c[kCW][xx], in_c[kG][xx])
                     : 0.0f;
    }
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
__global__ void __launch_bounds__(kSweepThreads)
basis_sweep_kernel(const float* __restrict__ beta,
                   const float* __restrict__ pprev,
                   const float* __restrict__ r,
                   const float* __restrict__ cs,
                   const float* __restrict__ cw,
                   const float* __restrict__ g,
                   const float* __restrict__ sc2, float* __restrict__ pn,
                   float* __restrict__ t1, float* __restrict__ t2,
                   float* __restrict__ t3, float* __restrict__ gram,
                   int rows, int cols, int halo, int lo, int hi, int seg_h) {
  __shared__ __align__(16) SweepShared sh;
  basis_sweep_body<false>(beta, pprev, r, cs, cw, g, sc2, nullptr, pn, t1,
                          t2, t3, gram, rows, cols, halo, lo, hi, seg_h, sh);
}

__global__ void __launch_bounds__(kSweepThreads)
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
                    float* __restrict__ gram, int rows, int cols, int halo,
                    int lo, int hi, int seg_h) {
  __shared__ __align__(16) SweepShared sh;
  basis_sweep_body<true>(beta, pprev, r, cs, cw, g, sc2, colmask, pn, t1,
                         t2, t3, gram, rows, cols, halo, lo, hi, seg_h, sh);
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

// The layouts the Python side must reproduce: C's Gram tile and strip,
// D's block.
void ca_cg_layout(int* tile_rows, int* tile_cols, int* threads,
                  int* strip_cols) {
  *tile_rows = kTileH;
  *tile_cols = kTileW;
  *threads = kThreads;
  *strip_cols = kStripW;
}

// The card's SM count and how many blocks of kernel C (either form) one SM
// holds at once, from which ca_cg.sweep_geometry sizes the segments.
int ca_cg_sweep_occupancy(int device, int* sms, int* per_sm) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int a = 0, b = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &a, basis_sweep_kernel, kSweepThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b, basis_sweep_sharded, kSweepThreads, 0);
  *per_sm = a < b ? a : b;
  return static_cast<int>(err);
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
                      int cols, int halo, int lo, int hi, int seg_h,
                      int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int band = rows - 2 * halo;
  if (seg_h <= 0 || seg_h % kTileH || cols % kStripW || band % kTileH)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(cols / kStripW, (band + seg_h - 1) / seg_h);
  if (colmask == nullptr) {
    basis_sweep_kernel<<<grid, kSweepThreads, 0, stream>>>(
        beta, pprev, r, cs, cw, g, sc2, pn, t1, t2, t3, gram, rows, cols,
        halo, lo, hi, seg_h);
  } else {
    basis_sweep_sharded<<<grid, kSweepThreads, 0, stream>>>(
        beta, pprev, r, cs, cw, g, sc2, colmask, pn, t1, t2, t3, gram, rows,
        cols, halo, lo, hi, seg_h);
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
