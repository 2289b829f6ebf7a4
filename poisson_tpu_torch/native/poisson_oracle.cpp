// Native fp64 oracle: fictitious-domain Poisson PCG, serial + OpenMP.
//
// This is the framework's native counterpart of the reference's CPU stages
// (serial `solve`, stage0/Withoutopenmp1.cpp:106-172; OpenMP variant,
// stage1-openmp/Withopenmp1.cpp:133-199): a double-precision,
// diagonally-preconditioned conjugate-gradient solve of the 5-point
// variable-coefficient system produced by the fictitious-domain method on
// the ellipse x^2 + 4y^2 < 1.  It serves as the bit-stable correctness
// oracle the TPU (JAX/XLA/Pallas) paths are validated against, and as the
// framework's shared-memory CPU backend.
//
// Design differences from the reference (deliberate, not drift):
//   - flat row-major arrays (idx = i*(N+1)+j) instead of vector<vector>;
//   - the Jacobi diagonal is built once before the loop instead of being
//     recomputed from a,b every iteration;
//   - the w/r update, the convergence sum, and the p update are fused
//     single sweeps;
//   - one implementation serves serial and OpenMP: thread count is a
//     runtime parameter (0 = keep the runtime's current team; pass 1 for a
//     fixed sequential reduction order).
//
// Exported C ABI (consumed by poisson_tpu/native/__init__.py via ctypes):
//   poisson_native_solve(...) -> 0 on success.

#include <cmath>
#include <cstdint>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

// Length of the intersection of [lo, hi] with [-half, half].
inline double clamped_overlap(double lo, double hi, double half) {
  const double a = lo > -half ? lo : -half;
  const double b = hi < half ? hi : half;
  return b > a ? b - a : 0.0;
}

// Half-extent in y of the ellipse x^2 + 4y^2 = 1 at abscissa x (0 outside).
inline double half_extent_y(double x) {
  const double t = (1.0 - x * x) * 0.25;
  return t > 0.0 ? std::sqrt(t) : 0.0;
}

// Half-extent in x at ordinate y.
inline double half_extent_x(double y) {
  const double t = 1.0 - 4.0 * y * y;
  return t > 0.0 ? std::sqrt(t) : 0.0;
}

// Face-fraction blend: full face -> 1, empty face -> 1/eps, cut face ->
// l/h + (1 - l/h)/eps.  Tolerance 1e-9 as in the reference
// (stage0/Withoutopenmp1.cpp:53-54).
inline double blend(double len, double h, double eps) {
  if (std::fabs(len - h) < 1e-9) return 1.0;
  if (len < 1e-9) return 1.0 / eps;
  const double frac = len / h;
  return frac + (1.0 - frac) / eps;
}

struct Problem {
  int M, N;
  double x_min, y_min, h1, h2, eps, f_val;
  std::int64_t stride;  // N+1

  std::int64_t at(int i, int j) const { return i * stride + j; }
  double x(int i) const { return x_min + i * h1; }
  double y(int j) const { return y_min + j * h2; }
};

// Fictitious-domain coefficient fields a, b (edge coefficients) and RHS B
// (stage0/Withoutopenmp1.cpp:42-61 `fic_reg`).  a[i][j] lives on the
// vertical face at x_i - h1/2; b[i][j] on the horizontal face at
// y_j - h2/2; B[i][j] = f_val * 1[(x_i, y_j) inside the ellipse] on
// interior nodes.
void build_fields(const Problem& P, std::vector<double>& a,
                  std::vector<double>& b, std::vector<double>& B) {
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 0; i <= P.M; ++i) {
    for (int j = 0; j <= P.N; ++j) {
      const double xf = P.x(i) - 0.5 * P.h1;
      const double yf = P.y(j) - 0.5 * P.h2;
      const double la =
          clamped_overlap(yf, yf + P.h2, half_extent_y(xf));
      const double lb =
          clamped_overlap(xf, xf + P.h1, half_extent_x(yf));
      a[P.at(i, j)] = blend(la, P.h2, P.eps);
      b[P.at(i, j)] = blend(lb, P.h1, P.eps);
      const bool interior =
          i >= 1 && i <= P.M - 1 && j >= 1 && j <= P.N - 1;
      const double xi = P.x(i), yj = P.y(j);
      B[P.at(i, j)] =
          (interior && xi * xi + 4.0 * yj * yj < 1.0) ? P.f_val : 0.0;
    }
  }
}

}  // namespace

extern "C" {

// Solve to convergence.  w_out may be null; if non-null it receives the
// full (M+1)*(N+1) row-major solution grid (zero Dirichlet ring included).
// Returns 0 on success, 1 on bad arguments.
int poisson_native_solve(int M, int N, double x_min, double x_max,
                         double y_min, double y_max, double f_val,
                         double delta, std::int64_t max_iter,
                         int weighted_norm, int num_threads, double* w_out,
                         std::int64_t* iters_out, double* diff_out,
                         double* zr_out) {
  if (M < 2 || N < 2) return 1;

  Problem P;
  P.M = M;
  P.N = N;
  P.x_min = x_min;
  P.y_min = y_min;
  P.h1 = (x_max - x_min) / M;
  P.h2 = (y_max - y_min) / N;
  const double h = P.h1 > P.h2 ? P.h1 : P.h2;
  P.eps = h * h;
  P.f_val = f_val;
  P.stride = N + 1;

#ifdef _OPENMP
  if (num_threads > 0) omp_set_num_threads(num_threads);
#else
  (void)num_threads;
#endif

  const std::int64_t n = static_cast<std::int64_t>(M + 1) * (N + 1);
  std::vector<double> a(n, 0.0), b(n, 0.0), B(n, 0.0);
  build_fields(P, a, b, B);

  const double inv_h1sq = 1.0 / (P.h1 * P.h1);
  const double inv_h2sq = 1.0 / (P.h2 * P.h2);
  const double cell = P.h1 * P.h2;

  // Jacobi diagonal, built once (the reference recomputes it every
  // iteration, stage0/Withoutopenmp1.cpp:91-103 — ~20% of stage4 runtime).
  std::vector<double> D(n, 0.0);
#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
  for (int i = 1; i <= M - 1; ++i)
    for (int j = 1; j <= N - 1; ++j)
      D[P.at(i, j)] = (a[P.at(i + 1, j)] + a[P.at(i, j)]) * inv_h1sq +
                      (b[P.at(i, j + 1)] + b[P.at(i, j)]) * inv_h2sq;

  // CG state: w = 0, r = B, z = D^{-1} r, p = z, zr = (z, r).
  std::vector<double> w(n, 0.0), r(B), z(n, 0.0), p(n, 0.0), Ap(n, 0.0);
  double zr = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : zr)
#endif
  for (int i = 1; i <= M - 1; ++i)
    for (int j = 1; j <= N - 1; ++j) {
      const std::int64_t k = P.at(i, j);
      const double d = D[k];
      z[k] = d != 0.0 ? r[k] / d : 0.0;
      p[k] = z[k];
      zr += z[k] * r[k];
    }
  zr *= cell;

  std::int64_t it = 0;
  double diff = 0.0;
  while (it < max_iter) {
    // Ap = A p and denom = (Ap, p) in one sweep.
    double denom = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : denom)
#endif
    for (int i = 1; i <= M - 1; ++i)
      for (int j = 1; j <= N - 1; ++j) {
        const std::int64_t k = P.at(i, j);
        const double pc = p[k];
        const double ax = (a[P.at(i + 1, j)] * (p[P.at(i + 1, j)] - pc) -
                           a[k] * (pc - p[P.at(i - 1, j)])) *
                          inv_h1sq;
        const double ay = (b[P.at(i, j + 1)] * (p[P.at(i, j + 1)] - pc) -
                           b[k] * (pc - p[P.at(i, j - 1)])) *
                          inv_h2sq;
        Ap[k] = -(ax + ay);
        denom += Ap[k] * pc;
      }
    denom *= cell;

    ++it;
    if (std::fabs(denom) < 1e-15) break;  // degenerate direction: state kept
    const double alpha = zr / denom;

    // Fused w/r update + convergence sum + preconditioner + (z, r).
    double sq = 0.0, zr_new = 0.0;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) reduction(+ : sq, zr_new)
#endif
    for (int i = 1; i <= M - 1; ++i)
      for (int j = 1; j <= N - 1; ++j) {
        const std::int64_t k = P.at(i, j);
        const double dw = alpha * p[k];
        w[k] += dw;
        r[k] -= alpha * Ap[k];
        sq += dw * dw;
        const double d = D[k];
        z[k] = d != 0.0 ? r[k] / d : 0.0;
        zr_new += z[k] * r[k];
      }
    zr_new *= cell;
    diff = weighted_norm ? std::sqrt(sq * cell) : std::sqrt(sq);

    const double beta = zr != 0.0 ? zr_new / zr : zr_new;
    zr = zr_new;
    if (diff < delta) break;  // converged: this iteration's updates kept

#ifdef _OPENMP
#pragma omp parallel for schedule(static)
#endif
    for (int i = 1; i <= M - 1; ++i)
      for (int j = 1; j <= N - 1; ++j) {
        const std::int64_t k = P.at(i, j);
        p[k] = z[k] + beta * p[k];
      }
  }

  if (w_out)
    for (std::int64_t k = 0; k < n; ++k) w_out[k] = w[k];
  if (iters_out) *iters_out = it;
  if (diff_out) *diff_out = diff;
  if (zr_out) *zr_out = zr;
  return 0;
}

// Introspection: 1 if built with OpenMP, else 0.
int poisson_native_has_openmp(void) {
#ifdef _OPENMP
  return 1;
#else
  return 0;
#endif
}

}  // extern "C"
