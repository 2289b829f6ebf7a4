"""Problem setup: elliptic geometry and fictitious-domain coefficient fields
(counterpart of ``poisson_tpu/models/fictitious_domain.py``).

Setup runs on the host in numpy fp64, as the reference's setup does
(``poisson_tpu/solvers/pcg.py:546-571`` takes the ``xp=np`` route of the JAX
module), so the fields here are bitwise equal to the JAX package's. The
solvers cast them once to the state dtype and move them to the device.

Discretisation recap (matching the reference bit-for-bit in fp64):
  - Grid nodes x_i = x_min + i·h1, y_j = y_min + j·h2, i=0..M, j=0..N.
  - Edge coefficient a[i,j] sits on the *vertical* cell face at
    x = x_i − h1/2, y ∈ [y_j − h2/2, y_j + h2/2]; b[i,j] on the *horizontal*
    face at y = y_j − h2/2, x ∈ [x_i − h1/2, x_i + h1/2].
  - With ℓ the face length inside D = {x²+4y² < 1} and h the face length:
      coeff = 1               if |ℓ − h| < 1e-9   (face fully inside)
            = 1/ε             if ℓ < 1e-9         (face fully outside)
            = ℓ/h + (1−ℓ/h)/ε otherwise           (cut face)
    with ε = max(h1,h2)²   (``stage0/Withoutopenmp1.cpp:53-54,108``).
  - RHS B[i,j] = f_val · 1[(x_i,y_j) ∈ D]  (``stage0/Withoutopenmp1.cpp:57-60``).
"""

from __future__ import annotations

import numpy as np

from poisson_tpu_torch.config import Problem

# The reference's exact-hit tolerances (``stage0/Withoutopenmp1.cpp:53-54``).
_FACE_TOL = 1e-9


def is_in_domain(x, y):
    """Ellipse membership x² + 4y² < 1 (``stage0/Withoutopenmp1.cpp:14-16``)."""
    return x * x + 4.0 * y * y < 1.0


def segment_length_in_domain(const_coord, start_var, end_var, *,
                             vertical: bool):
    """Length of an axis-aligned segment's intersection with the ellipse,
    closed form via the ellipse half-width at the fixed coordinate
    (``stage0/Withoutopenmp1.cpp:19-39``), vectorised over numpy arrays."""
    if vertical:
        half = np.sqrt(np.maximum(0.0, (1.0 - const_coord * const_coord) / 4.0))
    else:
        half = np.sqrt(np.maximum(0.0, 1.0 - 4.0 * const_coord * const_coord))
    return np.maximum(
        0.0, np.minimum(end_var, half) - np.maximum(start_var, -half)
    )


def _blend(length, h, eps):
    """ℓ → coefficient blend (full / empty / cut face), elementwise."""
    frac = length / h
    cut = frac + (1.0 - frac) / eps
    return np.where(
        np.abs(length - h) < _FACE_TOL,
        1.0,
        np.where(length < _FACE_TOL, 1.0 / eps, cut),
    )


def _node_coords(problem: Problem, i_idx, j_idx, dtype):
    x = (problem.x_min + i_idx.astype(dtype) * problem.h1)[:, None]
    y = (problem.y_min + j_idx.astype(dtype) * problem.h2)[None, :]
    return x, y


def coefficient_fields(problem: Problem, i_idx, j_idx, dtype=np.float64):
    """Edge coefficients a, b evaluated at the index mesh i_idx × j_idx
    (1-D integer arrays of global grid indices); shape
    (len(i_idx), len(j_idx))."""
    h1, h2, eps = problem.h1, problem.h2, problem.eps
    x, y = _node_coords(problem, i_idx, j_idx, dtype)
    la = segment_length_in_domain(
        x - 0.5 * h1, y - 0.5 * h2, y + 0.5 * h2, vertical=True
    )
    lb = segment_length_in_domain(
        y - 0.5 * h2, x - 0.5 * h1, x + 0.5 * h1, vertical=False
    )
    a = _blend(la, h2, eps).astype(dtype)
    b = _blend(lb, h1, eps).astype(dtype)
    return a, b


def rhs_field(problem: Problem, i_idx, j_idx, dtype=np.float64):
    """RHS B = f_val · 1[node ∈ D] at the index mesh, zero outside the
    interior index range 1..M-1 × 1..N-1 (``stage0/Withoutopenmp1.cpp:57-60``)."""
    x, y = _node_coords(problem, i_idx, j_idx, dtype)
    inside = is_in_domain(x, y)
    interior_mask = (
        (i_idx >= 1) & (i_idx <= problem.M - 1)
    )[:, None] & ((j_idx >= 1) & (j_idx <= problem.N - 1))[None, :]
    f = np.asarray(problem.f_val, dtype)
    return np.where(inside & interior_mask, f, np.zeros((), dtype))


def build_fields(problem: Problem, dtype=np.float64):
    """Full-grid fields a, b, B of shape (M+1, N+1), numpy on the host."""
    i_idx = np.arange(problem.M + 1)
    j_idx = np.arange(problem.N + 1)
    a, b = coefficient_fields(problem, i_idx, j_idx, dtype)
    rhs = rhs_field(problem, i_idx, j_idx, dtype)
    return a, b, rhs


def analytic_solution(problem: Problem, i_idx=None, j_idx=None,
                      dtype=np.float64):
    """Exact solution u = (1 − x² − 4y²)/10 inside D, 0 outside
    (−Δu = 1 in D, u = 0 on ∂D), numpy on the host."""
    if i_idx is None:
        i_idx = np.arange(problem.M + 1)
    if j_idx is None:
        j_idx = np.arange(problem.N + 1)
    x, y = _node_coords(problem, i_idx, j_idx, dtype)
    val = (1.0 - x * x - 4.0 * y * y) / 10.0
    return np.where(is_in_domain(x, y), val, np.zeros((), dtype))
