// Kernel S: the ordered, Kahan-compensated sum of a vector of reduction
// partials, for Hopper (sm_90a) -- the serial-reduce mode of the port.
//
// Built by poisson_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes; the
// Python wrapper is serial_sum in poisson_tpu_torch/ops/serial.py, beside
// its plain PyTorch version serial_sum_plain and serial_plan, which mirrors
// the launch geometry chosen here.
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
//   - each run is tree-summed: lane l adds the run's partials l, l + 32,
//     l + 64, ... in order, then the 32 lane sums are combined by the
//     shuffle tree (offsets 16, 8, 4, 2, 1);
//   - the run sums are added in order with Kahan compensation, exactly as
//     _kahan_add does:
//         y = part - comp;  t = sum + y;  comp = (t - sum) - y;  sum = t.
//
// The order is fixed; what the design chooses is how the partials reach the
// adds. The bound is latency: a few thousand floats, chains of dependent
// adds. So:
//
//   - Staging. A block copies its runs of every vector of the launch into
//     shared memory in one pass of 16-byte cp.async copies (4-byte ones for
//     an unaligned head and tail), all in flight at once, then one wait:
//     one memory round trip. A vector is one contiguous segment (A's, D's;
//     B's two rows) or, for kernel C's twelve Gram vectors, the columns of
//     one (tiles, 12) buffer, whose rows are one contiguous segment, staged
//     once for all twelve.
//   - Dealing. A lane's chain is fixed (l, l + 32, ... in order), not the
//     thread that walks it. On a contiguous vector a warp walks the 32
//     lanes of one run, reading consecutive words. On the interleaved Gram
//     buffer lane l of vector v reads word 12·l + v of each row group, so a
//     warp walks 8 lanes of 4 vectors (the general rule: 32/g lanes of g
//     vectors, g = gcd(vectors, 32)), which fall in 32 different banks; its
//     lane sums go through shared memory to the warp of their run for the
//     shuffle tree.
//   - Blocks. A launch is one thread-block cluster of 1 to kMaxCluster
//     blocks, each staging and tree-summing a share of the runs; each block
//     writes its run sums into block 0's shared memory (distributed shared
//     memory; a block's first remote write waits until the whole cluster
//     has started), the cluster meets once at its barrier, and block 0
//     walks the Kahan chains, one thread per vector. A short launch is a
//     cluster of one block, which needs no barrier and no remote mapping.
//   - A block's runs that do not fit in one stage are staged in pieces of
//     whole runs; a run that does not fit alone is staged in slices of
//     whole warp rows, each lane carrying its sum from slice to slice, one
//     run after another.
//
// Every add uses __fadd_rn/__fsub_rn, so nothing is contracted or
// reassociated, and the result equals serial_sum_plain's bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// Every constant of the launch rule is written here once; serial.py reads
// them from this file (the lines "constexpr <type> k<Name> = <integer>;").
constexpr int kThreads = 1024;   // the most threads a block is launched with
constexpr int kWarp = 32;
// Shared memory of a block (floats): the stage, the run sums of the whole
// launch (block 0's are the ones read), and the lane sums of the
// interleaved layout. 192 + 8 + 12 KB, under the 227 KB a block may opt in
// to.
constexpr long long kStageFloats = 49152;
constexpr long long kSumFloats = 2048;
constexpr long long kLaneFloats = 3072;
// The block rule, from the H100 timings in PERF.md: a launch of at most
// kSingleFloats partials (all vectors) runs in one block; a longer one in a
// cluster of a block per kBlockFloats partials, at most kMaxCluster (16, a
// non-portable cluster size the H100 allows). Blocks run
// kThreadsContiguous threads on contiguous vectors and kThreadsInterleaved
// on kernel C's interleaved Gram buffer.
constexpr long long kSingleFloats = 4096;
constexpr long long kBlockFloats = 1024;
constexpr long long kMaxCluster = 16;
constexpr long long kThreadsContiguous = 256;
constexpr long long kThreadsInterleaved = 512;
constexpr int kMaxDevices = 64;

struct Plan {
  long long runs;        // runs per vector
  long long rpb;         // runs per block
  long long blocks;      // the cluster's size
  long long piece_runs;  // runs per stage (whole runs), or 0 for slices
  long long slice;       // partials per slice of one run, or 0
  long long group;       // vectors a warp walks at once (g above)
  long long threads;     // threads per block
  long long stage;       // floats of the stage region
  long long lanes;       // floats of the lane-sum region (interleaved)
  long long smem_bytes;  // stage, then nv·runs run sums, then lane sums
};

__host__ __device__ inline long long ceil_div(long long a, long long b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline long long gcd32(long long nv) {
  long long g = 1;
  while (g < kWarp && nv % (2 * g) == 0) g *= 2;
  return g;
}

// Stage floats for `len` partials of each of `nv` vectors: a contiguous
// segment per vector (rows 16-byte aligned, room for a 3-float shift), or
// one interleaved segment.
__host__ __device__ inline long long stage_floats(long long len,
                                                  long long nv,
                                                  bool interleaved) {
  return interleaved ? ceil_div(nv * len + 3, 4) * 4
                     : nv * ceil_div(len + 3, 4) * 4;
}

// The launch geometry. Returns false when the launch cannot be served.
// Mirrored by serial_plan in poisson_tpu_torch/ops/serial.py.
bool make_plan(long long n, long long nv, long long run, bool interleaved,
               Plan* p) {
  if (n < 1 || nv < 1 || run < 1 || nv > kWarp) return false;
  p->runs = ceil_div(n, run);
  if (nv * p->runs > kSumFloats) return false;
  p->group = interleaved ? gcd32(nv) : 1;
  long long wanted = nv * n <= kSingleFloats ? 1
                     : ceil_div(nv * n, kBlockFloats);
  wanted = wanted < kMaxCluster ? wanted : kMaxCluster;
  p->rpb = ceil_div(p->runs, wanted);
  p->blocks = ceil_div(p->runs, p->rpb);
  const long long lanes_per_run = interleaved ? nv * kWarp : 0;
  p->piece_runs = 0;
  p->slice = 0;
  if (stage_floats(run, nv, interleaved) <= kStageFloats &&
      lanes_per_run <= kLaneFloats) {
    long long pr = p->rpb;
    while (pr > 1 && (stage_floats(pr * run, nv, interleaved) > kStageFloats
                      || pr * lanes_per_run > kLaneFloats))
      --pr;
    p->piece_runs = pr;
  } else {
    long long s = (kStageFloats / nv - 8) / kWarp * kWarp;
    while (stage_floats(s, nv, interleaved) > kStageFloats) s -= kWarp;
    p->slice = s;
  }
  const long long staged = p->slice ? p->slice
                           : (p->piece_runs * run < n ? p->piece_runs * run
                                                      : n);
  p->stage = stage_floats(staged, nv, interleaved);
  p->threads = interleaved ? kThreadsInterleaved : kThreadsContiguous;
  if (p->slice && p->threads < nv * kWarp) p->threads = nv * kWarp;
  p->lanes = lanes_per_run * (p->piece_runs > 1 ? p->piece_runs : 1);
  p->smem_bytes = (p->stage + nv * p->runs + p->lanes) *
                  static_cast<long long>(sizeof(float));
  return true;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Issue the copies of `cnt` contiguous floats at `g` into the 16-byte
// aligned `dst`, shifted by the floats `g` lies past a 16-byte boundary (so
// the body moves in 16-byte copies); returns that shift.
__device__ __forceinline__ int copy_segment(float* dst, const float* g,
                                           int cnt) {
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(g) >> 2) & 3);
  const int head = min((4 - sh) & 3, cnt);
  const int body = (cnt - head) >> 2;
  const int tail = cnt - head - 4 * body;
  for (int j = threadIdx.x; j < body; j += blockDim.x)
    cp_async16(dst + sh + head + 4 * j, g + head + 4 * j);
  if (static_cast<int>(threadIdx.x) < head)
    cp_async4(dst + sh + threadIdx.x, g + threadIdx.x);
  if (static_cast<int>(threadIdx.x) < tail)
    cp_async4(dst + sh + head + 4 * body + threadIdx.x,
              g + head + 4 * body + threadIdx.x);
  return sh;
}

__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
}

// The cluster barrier in two halves: every thread arrives at kernel entry
// and waits before its block's first write into block 0's shared memory,
// so no block writes there before the whole cluster has started.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float warp_tree(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  return acc;
}

// A lane's adds over `len` partials at `row`, `step` floats apart:
// partials l, l + 32, ... of [0, len), onto `acc`. Each batch of eight
// loads is issued before its adds; past `len` a load gives +0.0, which
// leaves the sum unchanged (it is never -0.0), as serial_sum_plain's zero
// padding does.
__device__ __forceinline__ float lane_chain(const float* row, int len,
                                            int lane, int step, float acc) {
  constexpr int kBatch = 8;
  for (int k0 = lane; k0 < len; k0 += kBatch * kWarp) {
    float x[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u * kWarp;
      x[u] = k < len ? row[k * step] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) acc = __fadd_rn(acc, x[u]);
  }
  return acc;
}

__device__ __forceinline__ void kahan_link(float part, float* sum,
                                           float* comp) {
  const float y = __fsub_rn(part, *comp);
  const float t = __fadd_rn(*sum, y);
  *comp = __fsub_rn(__fsub_rn(t, *sum), y);
  *sum = t;
}

// The Kahan chain over `count` run sums in order. The loads of each batch
// of eight are issued before its links, so the chain waits on shared memory
// once per batch, not once per link; links past `count` are skipped.
__device__ __forceinline__ float kahan_walk(const float* s, int count) {
  constexpr int kBatch = 8;
  float sum = 0.0f, comp = 0.0f;
  for (int q = 0; q < count; q += kBatch) {
    float part[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      part[u] = q + u < count ? s[q + u] : 0.0f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (q + u < count) kahan_link(part[u], &sum, &comp);
  }
  return sum;
}

struct Layout {
  const float* src;
  long long n, es, vs, run;
  int nv;
  bool interleaved;
};

// Stage partials [e0, e0 + len) of every vector; returns where element
// (0, v) of the staged range lies, via base[v], and the element step.
__device__ __forceinline__ void stage_range(const Layout& L, float* stage,
                                            long long e0, int len,
                                            int* base) {
  if (L.interleaved) {
    const int sh = copy_segment(stage, L.src + e0 * L.nv, L.nv * len);
    for (int v = 0; v < L.nv; ++v) base[v] = sh + v;
  } else {
    const int pitch = static_cast<int>(ceil_div(len + 3, 4) * 4);
    for (int v = 0; v < L.nv; ++v)
      base[v] = v * pitch +
                copy_segment(stage + v * pitch, L.src + v * L.vs + e0, len);
  }
  wait_copies();
}

// Thread t's (vector, lane) in warp w of a run's nv warps: on a contiguous
// layout warp w walks vector w; interleaved, warp w walks lanes
// (w mod g)·32/g + t/g of vectors (w/g)·g + t mod g.
__device__ __forceinline__ void chain_of(int w, int t, int g, int* v,
                                         int* l) {
  if (g == 1) {
    *v = w;
    *l = t;
    return;
  }
  const int lanes = kWarp / g;
  *v = (w / g) * g + t % g;
  *l = (w % g) * lanes + t / g;
}

// A single block is the hardware's implicit cluster of one: it is launched
// with no cluster attribute, skips the cluster barrier and keeps its run
// sums in its own shared memory. Of the forms tried on the H100, this one
// kernel with a runtime check was the fastest for a single block: a
// cluster attribute of one, and a second kernel with the cluster code
// compiled out, were both slower (PERF.md, the findings on kernel S).
__global__ void __launch_bounds__(kThreads)
serial_sum_kernel(Layout L, float* __restrict__ out, Plan p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int base[kWarp];
  const bool clustered = gridDim.x > 1;
  if (clustered) cluster_arrive_relaxed();
  const int tid = threadIdx.x, t = tid & (kWarp - 1);
  const int nv = L.nv, g = static_cast<int>(p.group);
  float* stage = smem;
  float* sums = smem + p.stage;                // [v * runs + q]
  float* lane_sums = sums + nv * p.runs;       // interleaved only
  const int runs = static_cast<int>(p.runs);
  const int step = L.interleaved ? nv : 1;
  const long long q0 = static_cast<long long>(blockIdx.x) * p.rpb;
  const long long q1 = q0 + p.rpb < runs ? q0 + p.rpb : runs;
  cg::cluster_group cluster = cg::this_cluster();
  float* sums0 = clustered ? cluster.map_shared_rank(sums, 0) : sums;
  bool joined = !clustered;   // whether the block has waited for its cluster

  if (p.slice == 0) {
    // Pieces of whole runs; each chain ends inside its piece.
    for (long long qa = q0; qa < q1; qa += p.piece_runs) {
      const long long qb = qa + p.piece_runs < q1 ? qa + p.piece_runs : q1;
      const long long ea = qa * L.run;
      const long long eb = qb * L.run < L.n ? qb * L.run : L.n;
      stage_range(L, stage, ea, static_cast<int>(eb - ea), base);
      if (!joined) {
        cluster_wait();
        joined = true;
      }
      const int nq = static_cast<int>(qb - qa);
      const int chains = nv * nq * kWarp;
      for (int c = tid; c < chains; c += blockDim.x) {
        const int warp = c / kWarp, qq = nv == 1 ? warp : warp / nv;
        int v, l;
        chain_of(warp - qq * nv, t, g, &v, &l);
        const long long start = (qa + qq) * L.run;
        const int len = static_cast<int>(
            L.n - start < L.run ? L.n - start : L.run);
        const float acc = lane_chain(
            stage + base[v] + static_cast<int>(start - ea) * step, len, l,
            step, 0.0f);
        if (g == 1) {
          const float s = warp_tree(acc);
          if (t == 0) sums0[v * runs + qa + qq] = s;
        } else {
          lane_sums[(qq * nv + v) * kWarp + l] = acc;
        }
      }
      if (g > 1) {
        __syncthreads();
        for (int c = tid; c < chains; c += blockDim.x) {
          const int warp = c / kWarp, qq = warp / nv, v = warp - qq * nv;
          const float s = warp_tree(lane_sums[(qq * nv + v) * kWarp + t]);
          if (t == 0) sums0[v * runs + qa + qq] = s;
        }
      }
      __syncthreads();   // the next piece overwrites the stage
    }
  } else {
    // Each run in slices; the thread of chain (v, l) carries its sum.
    const int slice = static_cast<int>(p.slice);
    const bool mine = tid < nv * kWarp;
    for (long long q = q0; q < q1; ++q) {
      const long long start = q * L.run;
      const int len = static_cast<int>(
          L.n - start < L.run ? L.n - start : L.run);
      int v, l;
      chain_of(tid / kWarp, t, g, &v, &l);
      float acc = 0.0f;
      for (int sa = 0; sa < len; sa += slice) {
        const int sl = len - sa < slice ? len - sa : slice;
        stage_range(L, stage, start + sa, sl, base);
        if (mine) acc = lane_chain(stage + base[v], sl, l, step, acc);
        __syncthreads();
      }
      if (g > 1) {
        if (mine) lane_sums[v * kWarp + l] = acc;
        __syncthreads();
        if (mine) acc = lane_sums[tid];
        v = tid / kWarp;
      }
      if (!joined) {
        cluster_wait();
        joined = true;
      }
      if (mine) {
        const float s = warp_tree(acc);
        if (t == 0) sums0[v * runs + q] = s;
      }
      __syncthreads();   // the next run's lane sums overwrite these
    }
  }

  if (clustered) {
    cluster.sync();   // every block's run sums are in block 0's memory
    if (blockIdx.x != 0) return;
  }   // one block: each branch above ended on a barrier after its writes
  if (tid < nv) out[tid] = kahan_walk(sums + tid * runs, runs);
}

bool g_opted_in[kMaxDevices];   // shared-memory and cluster attributes set

int launch(const float* src, float* out, long long n, long long es,
           long long vs, long long run, int vectors, int device,
           cudaStream_t stream) {
  const bool interleaved = es != 1;
  if (interleaved && (vs != 1 || es != vectors))
    return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  if (!make_plan(n, vectors, run, interleaved, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!g_opted_in[device]) {
    err = cudaFuncSetAttribute(
        serial_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>((kStageFloats + kSumFloats + kLaneFloats) *
                         sizeof(float)));
    if (err == cudaSuccess && kMaxCluster > 8)
      err = cudaFuncSetAttribute(
          serial_sum_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed,
          1);
    if (err != cudaSuccess) return static_cast<int>(err);
    g_opted_in[device] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(p.blocks));
  cfg.blockDim = dim3(static_cast<unsigned>(p.threads));
  cfg.dynamicSmemBytes = static_cast<size_t>(p.smem_bytes);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned>(p.blocks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.blocks > 1 ? 1 : 0;
  const Layout L{src, n, es, vs, run, vectors, interleaved};
  err = cudaLaunchKernelEx(&cfg, serial_sum_kernel, L, out, p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int serial_sum_threads() { return kThreads; }

const char* serial_sum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Sums `vectors` vectors of `n` partials each: vector v's partial k is at
// src[v * vec_stride + k * elem_stride], with elem_stride 1 (a contiguous
// vector each) or elem_stride == vectors and vec_stride 1 (the columns of
// one row-major buffer); its sum goes to out[v]. Launches on `stream` and
// returns the CUDA error code (0 on success).
int serial_sum_launch(const float* src, float* out, long long n,
                      long long elem_stride, long long vec_stride,
                      long long run, int vectors, int device,
                      cudaStream_t stream) {
  return launch(src, out, n, elem_stride, vec_stride, run, vectors, device,
                stream);
}

}  // extern "C"
