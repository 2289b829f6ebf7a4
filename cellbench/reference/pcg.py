"""Jacobi-preconditioned conjugate gradients in plain PyTorch: the
benchmark's reference solve.

The reference project's iteration (``stage2-mpi/poisson_mpi_decomp.cpp:384-457``),
on the unscaled system with the Jacobi diagonal, in the precision asked
for (fp64 is the reference; a lower one is the control that must fail the
comparison):

    w0 = 0;  r0 = B;  z0 = D⁻¹r0;  p0 = z0;  ζ0 = (z0, r0)
    repeat:  Ap = A p;  den = (Ap, p);  stop if |den| < 1e-15 (not counted)
             α = ζ/den;  w += αp;  r −= αAp;  diff = ‖αp‖;  k += 1
             z = D⁻¹r;  ζ' = (z, r);  stop if diff < δ
             β = ζ'/ζ;  p = z + βp

with (u, v) = h1·h2·Σ u·v over the interior, ‖·‖ weighted by h1·h2 (the
published runs' norm), and

    (Aw)ij = −[a_{i+1,j}(w_{i+1,j} − w_ij) − a_ij(w_ij − w_{i−1,j})]/h1²
             −[b_{i,j+1}(w_{i,j+1} − w_ij) − b_ij(w_ij − w_{i,j−1})]/h2²
    D_ij   = (a_{i+1,j} + a_ij)/h1² + (b_{i,j+1} + b_ij)/h2².

It imports nothing of the program under test and takes nothing the program
made: the operator comes from :mod:`cellbench.reference.fields`.
"""

from __future__ import annotations

import numpy as np
import torch

from cellbench.reference.fields import Grid, coefficients

DENOM_TOL = 1e-15


class Operator:
    """The five-point operator and its diagonal on one device, in ``dtype``."""

    def __init__(self, g: Grid, device, dtype=torch.float64):
        a, b = (torch.tensor(x, device=device).to(dtype)
                for x in coefficients(g))
        self.g, self.dtype, self.device = g, dtype, device
        self.h1sq, self.h2sq = g.h1 * g.h1, g.h2 * g.h2
        self.north, self.south = a[2:, 1:-1], a[1:-1, 1:-1]
        self.east, self.west = b[1:-1, 2:], b[1:-1, 1:-1]
        self.diag = ((self.north + self.south) / self.h1sq
                     + (self.east + self.west) / self.h2sq)

    def apply(self, p):
        """A·p on the interior, for p on the full grid with a zero ring."""
        c = p[1:-1, 1:-1]
        ax = (self.north * (p[2:, 1:-1] - c)
              - self.south * (c - p[:-2, 1:-1])) / self.h1sq
        ay = (self.east * (p[1:-1, 2:] - c)
              - self.west * (c - p[1:-1, :-2])) / self.h2sq
        return -(ax + ay)


def solve(op: Operator, rhs_grid, cap: int | None = None):
    """Solve A w = rhs for a full (M+1, N+1) fp64 host grid. Returns
    (w, k): the full fp64 solution grid on the host (zero ring) and the
    iteration count. ``cap`` bounds the iterations, (M−1)(N−1) by default."""
    g = op.g
    cap = (g.M - 1) * (g.N - 1) if cap is None else cap
    h1h2 = g.h1 * g.h2
    norm_w = h1h2 if g.weighted_norm else 1.0
    r = torch.tensor(np.asarray(rhs_grid, np.float64)[1:-1, 1:-1],
                     device=op.device).to(op.dtype)
    w = torch.zeros_like(r)
    p = torch.zeros((g.M + 1, g.N + 1), dtype=op.dtype, device=op.device)
    pc = p[1:-1, 1:-1]
    z = r / op.diag
    pc.copy_(z)
    zr = torch.sum(z * r) * h1h2
    k = 0
    while k < cap:
        ap = op.apply(p)
        den = torch.sum(ap * pc) * h1h2
        degenerate = torch.abs(den) < DENOM_TOL
        alpha = torch.where(degenerate, 0.0, zr / den)
        w += alpha * pc
        r -= alpha * ap
        diff = torch.abs(alpha) * torch.sqrt(torch.sum(pc * pc) * norm_w)
        stop_degenerate, converged = torch.stack(
            [degenerate, diff < g.delta]).tolist()
        if stop_degenerate:
            break
        k += 1
        z = r / op.diag
        zr_new = torch.sum(z * r) * h1h2
        if converged:
            break
        pc.mul_(zr_new / zr).add_(z)
        zr = zr_new
    out = np.zeros(g.shape, np.float64)
    out[1:-1, 1:-1] = w.double().cpu().numpy()
    return out, k
