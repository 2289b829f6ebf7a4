"""Problem setup: elliptic geometry and fictitious-domain coefficient fields
(counterpart of ``poisson_tpu/models/fictitious_domain.py``).

Setup runs on the host in numpy fp64, as the reference's setup does
(``poisson_tpu/solvers/pcg.py:546-571`` takes the ``xp=np`` route of the JAX
module), so the fields here are bitwise equal to the JAX package's. The
solvers cast them once to the state dtype and move them to the device.
The sharded solve's ``setup="device"`` passes index tensors instead: each
shard then builds its block on its own device, in the state's dtype (the
JAX module's ``xp=jnp`` route).

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
import torch

from poisson_tpu_torch.config import Problem

# The reference's exact-hit tolerances (``stage0/Withoutopenmp1.cpp:53-54``).
_FACE_TOL = 1e-9


def is_in_domain(x, y):
    """Ellipse membership x² + 4y² < 1 (``stage0/Withoutopenmp1.cpp:14-16``)."""
    return x * x + 4.0 * y * y < 1.0


def _xp(x):
    """The array namespace of ``x``: torch for tensors, else numpy."""
    return torch if isinstance(x, torch.Tensor) else np


def _clamp0(x):
    """max(0, x) elementwise."""
    return torch.clamp(x, min=0.0) if isinstance(x, torch.Tensor) \
        else np.maximum(0.0, x)


def sqrt_rn(x):
    """The correctly rounded square root. torch's CPU fp32 ``sqrt`` is off by
    an ulp on some inputs, which the cut-face blend's ``(1 - frac) / eps``
    turns into a coefficient hundreds of ulps away; an fp64 root rounded
    once to fp32 is the IEEE root, as numpy's and XLA's are."""
    if isinstance(x, torch.Tensor):
        return torch.sqrt(x.double()).to(x.dtype)
    return np.sqrt(x)


def segment_length_in_domain(const_coord, start_var, end_var, *,
                             vertical: bool):
    """Length of an axis-aligned segment's intersection with the ellipse,
    closed form via the ellipse half-width at the fixed coordinate
    (``stage0/Withoutopenmp1.cpp:19-39``), vectorised over numpy arrays or
    tensors."""
    xp = _xp(const_coord)
    if vertical:
        half = sqrt_rn(_clamp0((1.0 - const_coord * const_coord) / 4.0))
    else:
        half = sqrt_rn(_clamp0(1.0 - 4.0 * const_coord * const_coord))
    return _clamp0(xp.minimum(end_var, half) - xp.maximum(start_var, -half))


def _blend(length, h, eps):
    """ℓ → coefficient blend (full / empty / cut face), elementwise."""
    xp = _xp(length)
    frac = length / h
    cut = frac + (1.0 - frac) / eps
    return xp.where(
        xp.abs(length - h) < _FACE_TOL,
        1.0,
        xp.where(length < _FACE_TOL, 1.0 / eps, cut),
    )


def _cast(idx, dtype):
    return idx.to(dtype) if isinstance(idx, torch.Tensor) \
        else idx.astype(dtype)


def _node_coords(problem: Problem, i_idx, j_idx, dtype):
    x = (problem.x_min + _cast(i_idx, dtype) * problem.h1)[:, None]
    y = (problem.y_min + _cast(j_idx, dtype) * problem.h2)[None, :]
    return x, y


def coefficient_fields(problem: Problem, i_idx, j_idx, dtype=np.float64):
    """Edge coefficients a, b evaluated at the index mesh i_idx × j_idx
    (1-D integer arrays or tensors of global grid indices, ``dtype`` a
    numpy or torch dtype to match); shape (len(i_idx), len(j_idx))."""
    h1, h2, eps = problem.h1, problem.h2, problem.eps
    x, y = _node_coords(problem, i_idx, j_idx, dtype)
    la = segment_length_in_domain(
        x - 0.5 * h1, y - 0.5 * h2, y + 0.5 * h2, vertical=True
    )
    lb = segment_length_in_domain(
        y - 0.5 * h2, x - 0.5 * h1, x + 0.5 * h1, vertical=False
    )
    a = _cast(_blend(la, h2, eps), dtype)
    b = _cast(_blend(lb, h1, eps), dtype)
    return a, b


def rhs_field(problem: Problem, i_idx, j_idx, dtype=np.float64):
    """RHS B = f_val · 1[node ∈ D] at the index mesh, zero outside the
    interior index range 1..M-1 × 1..N-1 (``stage0/Withoutopenmp1.cpp:57-60``)."""
    x, y = _node_coords(problem, i_idx, j_idx, dtype)
    inside = is_in_domain(x, y)
    interior_mask = (
        (i_idx >= 1) & (i_idx <= problem.M - 1)
    )[:, None] & ((j_idx >= 1) & (j_idx <= problem.N - 1))[None, :]
    if isinstance(x, torch.Tensor):
        return torch.where(inside & interior_mask,
                           torch.tensor(problem.f_val, dtype=dtype,
                                        device=x.device), 0.0)
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
