"""Mixed-precision iterative refinement: fp64 accuracy from the fp32 device
paths (counterpart of ``poisson_tpu/solvers/refine.py``).

    w ← fp32_solve(b)
    repeat:
        r ← b − A·w        in fp64, on the host
        e ← fp32_solve(r)
        w ← w + e          in fp64

The measure is the residual of the scaled system, ‖D^{-1/2}(b − A·w)‖ /
‖D^{-1/2}b‖: the raw residual is dominated by the 1/ε coefficients of the
fictitious region and says nothing about accuracy. The inner solver is the
fused path's arbitrary-RHS hook (``ops.fused_cg.fused_cg_solve_rhs``) or,
for grids within the residency budget, kernel R's
(``ops.resident.resident_cg_solve_rhs``), one launch per correction.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.fused_cg import fused_cg_solve_rhs
from poisson_tpu_torch.ops.resident import resident_cg_solve_rhs
from poisson_tpu_torch.solvers.pcg import host_fields64

INNER_SOLVERS = {"fused": fused_cg_solve_rhs,
                 "resident": resident_cg_solve_rhs}


class RefineResult(NamedTuple):
    w: np.ndarray                 # fp64 solution, full (M+1, N+1) grid
    residual_norms: tuple         # weighted L2 of D^{-1/2}(b − A·w) per pass
    inner_iterations: tuple       # PCG iterations of each inner solve
    refinements: int
    relative_residual: float      # final ‖D^{-1/2}(b−A·w)‖ / ‖D^{-1/2}b‖
    converged: bool               # relative_residual <= tol was reached


def apply_A64_host(problem: Problem, a64, b64, w64) -> np.ndarray:
    """The 5-point variable-coefficient operator in fp64 numpy on interior
    points (zero ring kept): the host-side exact-residual oracle, in the
    JAX package's operation order."""
    h1sq, h2sq = problem.h1 ** 2, problem.h2 ** 2
    out = np.zeros_like(w64)
    c = w64[1:-1, 1:-1]
    ax = a64[1:-1, 1:-1]        # a[i, j]   (south face of point (i, j))
    axn = a64[2:, 1:-1]         # a[i+1, j] (north face)
    bw = b64[1:-1, 1:-1]        # b[i, j]   (west face)
    be = b64[1:-1, 2:]          # b[i, j+1] (east face)
    out[1:-1, 1:-1] = (
        -(axn * (w64[2:, 1:-1] - c) - ax * (c - w64[:-2, 1:-1])) / h1sq
        - (be * (w64[1:-1, 2:] - c) - bw * (c - w64[1:-1, :-2])) / h2sq
    )
    return out


def _weighted_norm(problem: Problem, v64) -> float:
    return float(np.sqrt(np.sum(v64 * v64) * problem.h1 * problem.h2))


def _fields(problem: Problem):
    """(a, b, B, sc) in fp64: the unscaled operator the residual is exact
    for, and sc = D^{-1/2} (zero ring), which defines the residual metric."""
    a64, b64, rhs64, _ = host_fields64(problem, False)
    sc64 = host_fields64(problem, True)[3]
    return a64, b64, rhs64, sc64


def refined_solve(problem: Problem, tol: float = 1e-10,
                  max_refinements: int = 8, backend: str = "fused",
                  device=None, bm: int | None = None, bn: int | None = None,
                  serial: bool | None = None) -> RefineResult:
    """Solve A w = B to relative scaled-system residual ``tol`` with fp32
    inner solves on ``device`` (default ``cuda``) and fp64 host residuals.

    Stops when the relative residual is at most ``tol`` or after
    ``max_refinements`` correction passes. ``backend`` is ``"fused"`` or
    ``"resident"`` (grids within the residency budget only). ``bm``, ``bn``
    and ``serial`` reach the fused inner solver (``fused_cg_solve_rhs``);
    the resident solve has one fixed geometry and refuses them, as the JAX
    package's ``refined_solve`` does."""
    if backend not in INNER_SOLVERS:
        raise ValueError(f"unknown refine backend {backend!r}; expected one "
                         f"of {sorted(INNER_SOLVERS)}")
    if backend == "resident":
        if bm is not None or bn is not None or serial:
            raise ValueError(
                "bm/bn/serial shape the fused streaming kernels; the "
                "resident backend has a fixed single-strip geometry")
        inner_solve = INNER_SOLVERS[backend]
    else:
        inner_solve = functools.partial(INNER_SOLVERS[backend], bm=bm, bn=bn,
                                        serial=serial)
    a64, b64, rhs64, sc64 = _fields(problem)
    bt_norm = _weighted_norm(problem, sc64 * rhs64)   # ‖b̃‖
    if bt_norm == 0.0:
        return RefineResult(np.zeros_like(rhs64), (0.0,), (), 0, 0.0, True)

    w64 = np.zeros_like(rhs64)
    norms, inner = [], []
    residual, rt_norm = rhs64, bt_norm
    for _ in range(max_refinements + 1):
        # The inner solve stops on an absolute update norm (δ); scale the
        # correction's RHS to b's size and the correction back (exact by
        # linearity), so every pass does the same well-conditioned work.
        scale = bt_norm / rt_norm
        e64, iters = inner_solve(problem, residual * scale, device=device)
        w64 = w64 + e64 / scale
        inner.append(iters)
        residual = rhs64 - apply_A64_host(problem, a64, b64, w64)
        rt_norm = _weighted_norm(problem, sc64 * residual)
        norms.append(rt_norm)
        if rt_norm / bt_norm <= tol or rt_norm == 0.0:
            break
    rel = rt_norm / bt_norm
    return RefineResult(
        w=w64, residual_norms=tuple(norms),
        inner_iterations=tuple(inner), refinements=len(inner) - 1,
        relative_residual=rel, converged=bool(rel <= tol),
    )
