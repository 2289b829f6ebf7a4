// Kernel R: the whole scaled-CG solve in one persistent cooperative kernel,
// for Hopper (sm_90a), with the solver state held on chip.
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrapper is resident_solve in poisson_tpu_torch/ops/resident.py,
// beside its plain PyTorch version and resident_layout, which computes the
// geometry this kernel is launched with.
//
// Replaces the Pallas kernel poisson_tpu/ops/pallas_resident.py:
// _make_resident_kernel (pallas_call in _resident_solve), which keeps the
// whole solver state in one TensorCore's VMEM and runs the PCG loop as an
// in-kernel while_loop.
//
// What bounds it on the H100. The function needs 26 flops per band point
// per iteration and reads its five input canvases once, so a 400 x 600
// solve could take 54 us and an 800 x 1200 solve 393 us (fp32 at
// 67 TFLOP/s). What costs time instead is latency: every iteration needs
// two grid-wide sums (<Ap, pn>, then sum pn^2 sc2 and sum r^2), each a
// round trip through L2 between all SMs, and the halo rows' trip from the
// neighbouring SMs. The design keeps everything else on the SM:
//   - One block of kThreads threads per SM (cooperative launch, so all are
//     resident at once; the wrapper passes the card's SM count, or the
//     band's row count if smaller). Block b owns a contiguous range of band
//     rows (resident_layout).
//   - Before the loop a block copies its rows of cS (and the row below),
//     cW, gamma and sc2 into dynamic shared memory, and keeps the direction
//     p (updated in place into pn, with one halo row above and below) and
//     w there. r and Ap, which only the thread that owns a point reads and
//     writes, live in registers: kGroups groups of 4 consecutive points per
//     thread, read and written 16 bytes at a time. What does not fit stays
//     in device memory: a field the layout could not place in shared memory
//     lives in a per-block region of `spill`, and points past kPPT per
//     thread keep r and Ap in the r and ap canvases. Fields are reached
//     through generic pointers, so one code path serves both.
//   - Only the edge rows cross blocks: at the end of the update phase a
//     block writes its top and bottom rows of r and p to `xch` (at L2,
//     past the SM's own L1: __stcg, __ldcg), and in the next iteration its
//     neighbours form their halo rows of pn = r + beta p from them, with
//     the same two roundings as the owner.
//   - Each block writes one partial per sum, and warp 0 of every block
//     gathers all of them and sums them in one fixed order (strided lanes,
//     then an xor butterfly), so every block holds the same alpha, beta and
//     done bit for bit. This is required: a block that left the loop while
//     another waits for its partial would hang the card. The two sums of
//     the update phase are gathered in one pass.
//   - The blocks meet twice per iteration, at these gathers, and nowhere
//     else: no grid.sync(). Partials carry the step's tag in the same
//     64-bit word as the value, so a block waits exactly until the words it
//     needs have arrived, and only the meeting after the update phase,
//     which hands over the exchange rows, pays for fences (see publish).
//     Tagging the exchange rows as well, to drop those fences, measured
//     slower on the H100 (each halo word then needs its own check).
//   - Points are walked as q = 4 (tid + j kThreads) with the column carried
//     from one group to the next by an add and a compare: no division in
//     the loop.
//
// Arithmetic uses explicit round-to-nearest intrinsics in the plain
// version's order; the sums differ from it in order, so the iterates agree
// to fp32 round-off over the solve, not bit for bit. The count, the cap and
// the degenerate-direction corner follow pallas_resident.py:105-134; k,
// diff and zeta are written once at the end.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kGroups = 5;            // 4-point groups per thread in registers
constexpr int kPPT = 4 * kGroups;     // points per thread held in registers
constexpr float kDenomTol = 1e-15f;   // degenerate-direction guard
constexpr int kFields = 6;            // pn, cS, cW, gamma, sc2, w
constexpr int kMaxBlocks = 256;       // partials a warp gathers (8 a lane)
constexpr int kPerLane = kMaxBlocks / 32;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// Sum of the block's per-thread values, returned to thread 0: warp
// shuffles, then thread 0 adds the warp sums in warp order. Every thread
// must call it; only thread 0's return value is the sum.
__device__ float block_sum(float v, float* slots) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) slots[warp] = v;
  __syncthreads();
  float s = 0.0f;
  if (threadIdx.x == 0) {
    s = slots[0];
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, slots[w]);
  }
  return s;
}

// A partial is published with its tag in one 64-bit store: the value's
// bits low, the tag high. Tags rise through the launch (1 for the first
// sum, then 2k + 2 and 2k + 3 in iteration k) and the buffer starts at 0,
// so a reader that sees the tag it waits for sees that step's value.
// Where the readers also go on to read the block's exchange rows (the sums
// of the update phase and the first sum), a fence orders the block's
// writes, which __syncthreads has gathered, before the store, and the
// gather ends in a fence too. The <Ap, pn> partial needs neither: it
// carries its own value, and the exchange rows the block read before it
// are used in computing it, so they are read before it is stored, before
// any neighbour may overwrite them.
template <bool kFence>
__device__ __forceinline__ void publish(unsigned long long* slot, float v,
                                        unsigned tag) {
  if (kFence) __threadfence();
  *reinterpret_cast<volatile unsigned long long*>(slot) =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
}

__device__ __forceinline__ unsigned long long poll(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

// Warp 0: waits until all n partials of each of the NA arrays carry `tag`,
// then sums each in one fixed order (lanes stride the partials, then an
// xor butterfly; a + b and b + a round alike), so every lane of every
// block gets the same bits. All partials are polled in one batch, so the
// wait costs one round trip once the last block has published. Together
// with publish this is the grid-wide meeting point of the iteration: no
// block passes it before every block has reached it.
template <int NA, bool kFence>
__device__ void gather(const unsigned long long* const (&part)[NA], int n,
                       unsigned tag, float (&sum)[NA]) {
  const int lane = threadIdx.x & 31;
  const unsigned long long ready = static_cast<unsigned long long>(tag)
                                   << 32;
  unsigned long long x[NA][kPerLane];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = lane + 32 * j;
      x[a][j] = i < n ? poll(part[a] + i) : ready;
    }
  for (;;) {
    bool ok = true;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) ok = ok && (x[a][j] >> 32) == tag;
    if (__all_sync(0xffffffffu, ok)) break;
#pragma unroll
    for (int a = 0; a < NA; ++a)
#pragma unroll
      for (int j = 0; j < kPerLane; ++j)
        if ((x[a][j] >> 32) != tag) x[a][j] = poll(part[a] + lane + 32 * j);
  }
  if (kFence) __threadfence();
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      s = __fadd_rn(s, __uint_as_float(static_cast<unsigned>(x[a][j])));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
    sum[a] = s;
  }
}

// Scalars every thread of a block reads after the broadcast sync.
struct Scalars {
  float alpha, beta, zr, diff;
  int k, done, deg;
};

// Kernel A's difference-form stencil at one point, in its order.
__device__ __forceinline__ float point(float c, float n, float s, float e,
                                       float w, float cs_n, float cs_c,
                                       float cw_e, float cw_c, float g) {
  float a = __fmul_rn(cs_n, __fsub_rn(c, n));
  a = __fadd_rn(a, __fmul_rn(cs_c, __fsub_rn(c, s)));
  a = __fadd_rn(a, __fmul_rn(cw_e, __fsub_rn(c, e)));
  a = __fadd_rn(a, __fmul_rn(cw_c, __fsub_rn(c, w)));
  return __fadd_rn(a, __fmul_rn(g, c));
}

// The stencil at the four points q .. q + 3 of the block's rows (columns
// lc .. lc + 3 of one row), pn on chip with one halo row above (pn[q] is
// the point's south neighbour, pn[q + 2 cols] its north one); c returns
// the four centre values.
__device__ __forceinline__ float4 stencil4(const float* pn, const float* cs,
                                           const float* cw, const float* g,
                                           int q, int lc, int cols,
                                           float4& c) {
  c = ld4(pn + cols + q);
  const float4 n = ld4(pn + 2 * cols + q), s = ld4(pn + q);
  const float4 cs_n = ld4(cs + q + cols), cs_c = ld4(cs + q);
  const float4 cw_c = ld4(cw + q), gg = ld4(g + q);
  const bool has_e = lc + 4 < cols;
  const float east = has_e ? pn[cols + q + 4] : 0.0f;
  const float cw_e = has_e ? cw[q + 4] : 0.0f;
  const float west = lc >= 1 ? pn[cols + q - 1] : 0.0f;
  float4 a;
  a.x = point(c.x, n.x, s.x, c.y, west, cs_n.x, cs_c.x, cw_c.y, cw_c.x, gg.x);
  a.y = point(c.y, n.y, s.y, c.z, c.x, cs_n.y, cs_c.y, cw_c.z, cw_c.y, gg.y);
  a.z = point(c.z, n.z, s.z, c.w, c.y, cs_n.z, cs_c.z, cw_c.w, cw_c.z, gg.z);
  a.w = point(c.w, n.w, s.w, east, c.z, cs_n.w, cs_c.w, cw_e, cw_c.w, gg.w);
  return a;
}

__device__ __forceinline__ float dot4(float acc, float4 a, float4 b) {
  acc = __fadd_rn(acc, __fmul_rn(a.x, b.x));
  acc = __fadd_rn(acc, __fmul_rn(a.y, b.y));
  acc = __fadd_rn(acc, __fmul_rn(a.z, b.z));
  return __fadd_rn(acc, __fmul_rn(a.w, b.w));
}

// w += alpha p, r -= alpha Ap at four points; partials of sum p^2 sc2 and
// sum r^2.
__device__ __forceinline__ void update4(float alpha, float4 pv, float4 ap,
                                        float4 s2, float4& w, float4& r,
                                        float& acc_d, float& acc_z) {
  w.x = __fadd_rn(w.x, __fmul_rn(alpha, pv.x));
  w.y = __fadd_rn(w.y, __fmul_rn(alpha, pv.y));
  w.z = __fadd_rn(w.z, __fmul_rn(alpha, pv.z));
  w.w = __fadd_rn(w.w, __fmul_rn(alpha, pv.w));
  r.x = __fsub_rn(r.x, __fmul_rn(alpha, ap.x));
  r.y = __fsub_rn(r.y, __fmul_rn(alpha, ap.y));
  r.z = __fsub_rn(r.z, __fmul_rn(alpha, ap.z));
  r.w = __fsub_rn(r.w, __fmul_rn(alpha, ap.w));
  acc_d = __fadd_rn(acc_d, __fmul_rn(__fmul_rn(pv.x, pv.x), s2.x));
  acc_d = __fadd_rn(acc_d, __fmul_rn(__fmul_rn(pv.y, pv.y), s2.y));
  acc_d = __fadd_rn(acc_d, __fmul_rn(__fmul_rn(pv.z, pv.z), s2.z));
  acc_d = __fadd_rn(acc_d, __fmul_rn(__fmul_rn(pv.w, pv.w), s2.w));
  acc_z = dot4(acc_z, r, r);
}

__global__ void __launch_bounds__(kThreads, 1)
resident_kernel(const float* __restrict__ cs, const float* __restrict__ cw,
                const float* __restrict__ g, const float* __restrict__ rhs,
                const float* __restrict__ sc2, float* w_c, float* r_c,
                float* ap_c, float* xch, float* spill,
                unsigned long long* part, int* k_out, float* diff_out,
                float* zr_out, float h1h2, float norm_w, float delta, int cap,
                int rows, int cols, int halo, int off_pn, int off_cs,
                int off_cw, int off_g, int off_sc2, int off_w,
                int spill_stride) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float slots[2][kWarps];
  __shared__ Scalars sh;
  const int tid = threadIdx.x, b = blockIdx.x, blocks = gridDim.x;
  unsigned long long* const part_dot = part;              // <Ap, pn>
  unsigned long long* const part_diff = part + blocks;    // sum pn^2 sc2
  unsigned long long* const part_zr = part + 2 * blocks;  // sum r^2

  // The block's rows: [row0, row0 + nrows) of the band.
  const int band = rows - 2 * halo;
  const int base = band / blocks, extra = band % blocks;
  const int nrows = base + (b < extra ? 1 : 0);
  const int row0 = b * base + (b < extra ? b : extra);
  const int npts = nrows * cols;
  const long long gbase = static_cast<long long>(halo + row0) * cols;

  // Each field's home: dynamic shared memory (offset >= 0) or this block's
  // region of `spill` (offset -1 - o).
  float* const spill_b = spill + static_cast<long long>(b) * spill_stride;
  auto home = [&](int off) -> float* {
    return off >= 0 ? smem + off : spill_b + (-1 - off);
  };
  float* const pn = home(off_pn);
  float* const cs_s = home(off_cs);
  float* const cw_s = home(off_cw);
  float* const g_s = home(off_g);
  float* const sc2_s = home(off_sc2);
  float* const w_s = home(off_w);
  float* const r_g = r_c + gbase;    // r and Ap of points past kPPT
  float* const ap_g = ap_c + gbase;
  // Exchange rows: block b's top r, top p, bottom r, bottom p.
  float* const xch_b = xch + static_cast<long long>(b) * 4 * cols;
  const int last_row = (nrows - 1) * cols;

  // Fields on chip, once; w and p start at 0.
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = 4 * tid; q < npts + cols; q += 4 * kThreads)
    st4(cs_s + q, ld4(cs + gbase + q));
  for (int q = 4 * tid; q < npts; q += 4 * kThreads) {
    st4(cw_s + q, ld4(cw + gbase + q));
    st4(g_s + q, ld4(g + gbase + q));
    st4(sc2_s + q, ld4(sc2 + gbase + q));
    st4(w_s + q, zero4);
    st4(pn + cols + q, zero4);
  }

  // A thread's points: groups q_j = 4 (tid + j kThreads), column carried.
  const int lc0 = (4 * tid) % cols, dc = (4 * kThreads) % cols;
  auto next_col = [&](int lc) {
    lc += dc;
    return lc >= cols ? lc - cols : lc;
  };
  auto exchange = [&](int q, float4 rv, float4 pv) {
    if (q < cols) {
      __stcg(reinterpret_cast<float4*>(xch_b + q), rv);
      __stcg(reinterpret_cast<float4*>(xch_b + cols + q), pv);
    }
    if (q >= last_row) {
      __stcg(reinterpret_cast<float4*>(xch_b + 2 * cols + q - last_row), rv);
      __stcg(reinterpret_cast<float4*>(xch_b + 3 * cols + q - last_row), pv);
    }
  };

  float4 r[kGroups], ap[kGroups];
  // r = b~; zeta0 = sum r^2 h1h2; p's edge rows (0) exchanged.
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const int q = 4 * (tid + j * kThreads);
    r[j] = zero4;
    ap[j] = zero4;
    if (q < npts) {
      r[j] = ld4(rhs + gbase + q);
      acc = dot4(acc, r[j], r[j]);
      exchange(q, r[j], zero4);
    }
  }
  for (int q = 4 * (tid + kGroups * kThreads); q < npts; q += 4 * kThreads) {
    const float4 v = ld4(rhs + gbase + q);
    st4(r_g + q, v);
    acc = dot4(acc, v, v);
    exchange(q, v, zero4);
  }
  acc = block_sum(acc, slots[0]);
  if (tid == 0) publish<true>(part_zr + b, acc, 1u);
  if (tid < 32) {
    float s[1];
    gather<1, true>({part_zr}, blocks, 1u, s);
    if (tid == 0) {
      sh.zr = __fmul_rn(s[0], h1h2);
      sh.beta = 0.0f;
      sh.diff = __int_as_float(0x7f800000);   // +inf
      sh.k = 0;
      sh.done = 0;
    }
  }
  __syncthreads();

  while (!sh.done && sh.k < cap) {
    const float beta = sh.beta;
    const unsigned tag = 2u * static_cast<unsigned>(sh.k) + 2u;
    // 1a. pn = r + beta p on the block's rows (in place) and on the halo
    // rows from the neighbours' exchanged r and p (0 past the band).
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int q = 4 * (tid + j * kThreads);
      if (q < npts) {
        float4 p = ld4(pn + cols + q);
        p.x = __fadd_rn(r[j].x, __fmul_rn(beta, p.x));
        p.y = __fadd_rn(r[j].y, __fmul_rn(beta, p.y));
        p.z = __fadd_rn(r[j].z, __fmul_rn(beta, p.z));
        p.w = __fadd_rn(r[j].w, __fmul_rn(beta, p.w));
        st4(pn + cols + q, p);
      }
    }
    for (int q = 4 * (tid + kGroups * kThreads); q < npts;
         q += 4 * kThreads) {
      const float4 rv = ld4(r_g + q);
      float4 p = ld4(pn + cols + q);
      p.x = __fadd_rn(rv.x, __fmul_rn(beta, p.x));
      p.y = __fadd_rn(rv.y, __fmul_rn(beta, p.y));
      p.z = __fadd_rn(rv.z, __fmul_rn(beta, p.z));
      p.w = __fadd_rn(rv.w, __fmul_rn(beta, p.w));
      st4(pn + cols + q, p);
    }
    for (int c = 4 * tid; c < cols; c += 4 * kThreads) {
      float4 top = zero4, bottom = zero4;
      if (b > 0) {
        const float* up = xch_b - 4 * cols;      // block b-1's bottom rows
        const float4 rv = __ldcg(reinterpret_cast<const float4*>(
            up + 2 * cols + c));
        const float4 pv = __ldcg(reinterpret_cast<const float4*>(
            up + 3 * cols + c));
        top = make_float4(__fadd_rn(rv.x, __fmul_rn(beta, pv.x)),
                          __fadd_rn(rv.y, __fmul_rn(beta, pv.y)),
                          __fadd_rn(rv.z, __fmul_rn(beta, pv.z)),
                          __fadd_rn(rv.w, __fmul_rn(beta, pv.w)));
      }
      if (b + 1 < blocks) {
        const float* down = xch_b + 4 * cols;    // block b+1's top rows
        const float4 rv = __ldcg(reinterpret_cast<const float4*>(down + c));
        const float4 pv = __ldcg(reinterpret_cast<const float4*>(
            down + cols + c));
        bottom = make_float4(__fadd_rn(rv.x, __fmul_rn(beta, pv.x)),
                             __fadd_rn(rv.y, __fmul_rn(beta, pv.y)),
                             __fadd_rn(rv.z, __fmul_rn(beta, pv.z)),
                             __fadd_rn(rv.w, __fmul_rn(beta, pv.w)));
      }
      st4(pn + c, top);
      st4(pn + (nrows + 1) * cols + c, bottom);
    }
    __syncthreads();

    // 1b. Ap = A~ pn, partial <Ap, pn>.
    acc = 0.0f;
    int lc = lc0;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int q = 4 * (tid + j * kThreads);
      if (q < npts) {
        float4 c;
        ap[j] = stencil4(pn, cs_s, cw_s, g_s, q, lc, cols, c);
        acc = dot4(acc, ap[j], c);
      }
      lc = next_col(lc);
    }
    for (int q = 4 * (tid + kGroups * kThreads); q < npts;
         q += 4 * kThreads) {
      float4 c;
      const float4 a = stencil4(pn, cs_s, cw_s, g_s, q, lc, cols, c);
      st4(ap_g + q, a);
      acc = dot4(acc, a, c);
      lc = next_col(lc);
    }
    acc = block_sum(acc, slots[0]);
    if (tid == 0) publish<false>(part_dot + b, acc, tag);

    // 2. alpha from all partials, the same bits in every block.
    if (tid < 32) {
      float s[1];
      gather<1, false>({part_dot}, blocks, tag, s);
      if (tid == 0) {
        const float denom = __fmul_rn(s[0], h1h2);
        const bool deg = fabsf(denom) < kDenomTol;
        sh.deg = deg;
        sh.alpha = deg ? 0.0f : __fdiv_rn(sh.zr, denom);
      }
    }
    __syncthreads();

    // 3. w += alpha pn, r -= alpha Ap; partials of sum pn^2 sc2 and sum r^2;
    // the edge rows of r and p to the exchange buffer.
    const float alpha = sh.alpha;
    float acc_d = 0.0f, acc_z = 0.0f;
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const int q = 4 * (tid + j * kThreads);
      if (q < npts) {
        const float4 pv = ld4(pn + cols + q);
        float4 wv = ld4(w_s + q);
        update4(alpha, pv, ap[j], ld4(sc2_s + q), wv, r[j], acc_d, acc_z);
        st4(w_s + q, wv);
        exchange(q, r[j], pv);
      }
    }
    for (int q = 4 * (tid + kGroups * kThreads); q < npts;
         q += 4 * kThreads) {
      const float4 pv = ld4(pn + cols + q);
      float4 wv = ld4(w_s + q), rv = ld4(r_g + q);
      update4(alpha, pv, ld4(ap_g + q), ld4(sc2_s + q), wv, rv, acc_d,
              acc_z);
      st4(w_s + q, wv);
      st4(r_g + q, rv);
      exchange(q, rv, pv);
    }
    acc_d = block_sum(acc_d, slots[0]);
    acc_z = block_sum(acc_z, slots[1]);
    if (tid == 0) {
      publish<true>(part_diff + b, acc_d, tag + 1u);
      publish<true>(part_zr + b, acc_z, tag + 1u);
    }

    // 4. diff, zeta, beta, done: the two sums in one gather of warp 0.
    if (tid < 32) {
      float s[2];
      gather<2, true>({part_diff, part_zr}, blocks, tag + 1u, s);
      if (tid == 0) {
        const float zr_new = __fmul_rn(s[1], h1h2);
        const float diff = __fmul_rn(fabsf(sh.alpha),
                                     __fsqrt_rn(__fmul_rn(s[0], norm_w)));
        sh.beta = __fdiv_rn(zr_new, sh.zr == 0.0f ? 1.0f : sh.zr);
        sh.zr = zr_new;
        sh.diff = diff;
        sh.k += 1;
        sh.done = sh.deg || diff < delta;
      }
    }
    __syncthreads();
  }

  for (int q = 4 * tid; q < npts; q += 4 * kThreads)
    st4(w_c + gbase + q, ld4(w_s + q));
  if (b == 0 && tid == 0) {
    *k_out = sh.k;
    *diff_out = sh.diff;
    *zr_out = sh.zr;
  }
}

}  // namespace

extern "C" {

const char* resident_cg_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The kernel's constants, which resident_layout must use.
void resident_cg_layout(int* threads, int* reg_points, int* fields,
                        int* max_blocks) {
  *threads = kThreads;
  *reg_points = kPPT;
  *fields = kFields;
  *max_blocks = kMaxBlocks;
}

// The card's SM count and the shared memory one block may opt in to.
// Refuses a device without cooperative launch (cudaErrorNotSupported).
int resident_cg_device(int device, int* sms, int* smem_optin) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int coop = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  return static_cast<int>(err);
}

// One cooperative launch of `blocks` blocks with `smem_bytes` of dynamic
// shared memory on `stream`: the blocks wait on each other's partials, so
// all of them must be resident at once, which the cooperative launch
// guarantees or refuses (cudaErrorCooperativeLaunchTooLarge, also returned
// when the card cannot hold that many such blocks). `part` holds
// 3 x blocks zeroed 64-bit slots, `xch` blocks x 4 x cols floats, `spill`
// blocks x spill_stride. Returns cudaGetLastError().
int resident_cg_solve(const float* cs, const float* cw, const float* g,
                      const float* rhs, const float* sc2, float* w, float* r,
                      float* ap, float* xch, float* spill,
                      unsigned long long* part, int* k, float* diff,
                      float* zr, float h1h2, float norm_w, float delta,
                      int cap, int rows, int cols, int halo, int off_pn,
                      int off_cs, int off_cw, int off_g, int off_sc2,
                      int off_w, int spill_stride, int smem_bytes,
                      int blocks, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || blocks > kMaxBlocks || cols % 4 || spill_stride % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(resident_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, resident_kernel, kThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm * sms < blocks)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* args[] = {&cs, &cw, &g, &rhs, &sc2, &w, &r, &ap, &xch, &spill,
                  &part, &k, &diff, &zr, &h1h2, &norm_w, &delta, &cap,
                  &rows, &cols, &halo, &off_pn, &off_cs, &off_cw, &off_g,
                  &off_sc2, &off_w, &spill_stride};
  err = cudaLaunchCooperativeKernel(
      (const void*)resident_kernel, dim3(blocks), dim3(kThreads), args,
      static_cast<size_t>(smem_bytes), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
