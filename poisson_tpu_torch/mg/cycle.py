"""The geometric V-cycle: transfers, smoothing, and the cycle itself
(counterpart of ``poisson_tpu/mg/cycle.py``).

Plain PyTorch over the ``ops.stencil`` array convention: full grids
(…, M+1, N+1) with an identically-zero Dirichlet ring, leading batch axes
allowed everywhere (ellipsis indexing), so one implementation serves the
solo solve and the (B, M+1, N+1) stacks of the batched and lane solves.

The transfer pair is chosen for symmetry: bilinear prolongation P and
full-weighting restriction R (the 1/16·[1 2 1; 2 4 2; 1 2 1] stencil)
satisfy R = ¼·Pᵀ, so the coarse-grid correction P·A_c⁻¹·R is symmetric
whenever A_c is; weighted Jacobi is A-self-adjoint; so the whole V-cycle
is an SPD operator that plain CG may precondition with.

Bit parity between a member of a batch and its solo solve: every step is
elementwise except the dense coarsest matvec, which runs one ``torch.mv``
per member on the solo call's shape and alignment (:func:`coarse_solve`).
"""

from __future__ import annotations

import math

import torch

from poisson_tpu_torch.mg.hierarchy import DEFAULT_MG, MGConfig, MGLevels
from poisson_tpu_torch.ops.stencil import _MEMBER_ALIGN, apply_A, pad_interior


def restrict_full_weighting(r):
    """Fine (…, M+1, N+1) → coarse (…, M/2+1, N/2+1) by the 9-point
    full-weighting stencil over the interior coarse nodes (the ring stays
    zero). Coarse node (I, J) sits on fine node (2I, 2J); the weights sum
    to 1, so the restricted residual keeps function-value scaling."""
    c = r[..., 2:-1:2, 2:-1:2]                 # (2I, 2J)
    up, dn = r[..., 1:-2:2, 2:-1:2], r[..., 3::2, 2:-1:2]
    lf, rt = r[..., 2:-1:2, 1:-2:2], r[..., 2:-1:2, 3::2]
    ul, ur = r[..., 1:-2:2, 1:-2:2], r[..., 1:-2:2, 3::2]
    dl, dr = r[..., 3::2, 1:-2:2], r[..., 3::2, 3::2]
    core = (4.0 * c + 2.0 * (up + dn + lf + rt)
            + (ul + ur + dl + dr)) / 16.0
    return pad_interior(core)


def prolong_bilinear(e):
    """Coarse (…, Mc+1, Nc+1) → fine (…, 2Mc+1, 2Nc+1) by bilinear
    interpolation: coincident fine nodes copy, edge midpoints average
    their two coarse neighbours, cell centres the row midpoints on either
    side (the tensor product of two 1D interpolations, in the JAX
    package's order). Written by strided stores into the fine grid; the
    coarse ring is zero, so the fine ring is too."""
    mc, nc = e.shape[-2] - 1, e.shape[-1] - 1
    out = e.new_empty(e.shape[:-2] + (2 * mc + 1, 2 * nc + 1))
    out[..., ::2, ::2] = e
    torch.mul(e[..., :-1, :] + e[..., 1:, :], 0.5, out=out[..., 1::2, ::2])
    torch.mul(out[..., :, :-1:2] + out[..., :, 2::2], 0.5,
              out=out[..., :, 1::2])
    return out


def smooth_jacobi(x, rhs, a, b, dinv, h1: float, h2: float,
                  sweeps: int, omega: float, from_zero: bool = False):
    """``sweeps`` damped-Jacobi sweeps x ← x + ω·D⁻¹(rhs − Ax).

    ``dinv`` is the zero-ring-padded inverse diagonal, so the ring stays
    zero. ``from_zero`` starts from x = 0 and takes the first sweep in its
    closed form ω·D⁻¹·rhs. ω·D⁻¹ is formed once per call: the products
    ``(ω·D⁻¹)·v`` the JAX expression ``omega * dinv * v`` evaluates."""
    if from_zero and sweeps <= 0:
        return torch.zeros_like(rhs)
    if sweeps <= 0:
        return x
    wdinv = omega * dinv
    if from_zero:
        x = wdinv * rhs
        sweeps -= 1
    for _ in range(sweeps):
        x = x + wdinv * (rhs - apply_A(x, a, b, h1, h2))
    return x


def coarse_matvec(coarse_inv, flat):
    """``coarse_inv @ v`` for every member v of ``flat`` (…, n): one
    ``torch.mv`` per member, each on a contiguous vector that starts where
    a fresh tensor does (``ops.stencil.member_sums``' alignment), written
    into an aligned output. So a member of a stack gets the bits of its
    solo matvec: one ``torch.mv`` over the whole stack, or a matmul, would
    pick its kernel and its order by the batch size."""
    lead, n = flat.shape[:-1], flat.shape[-1]
    nb = math.prod(lead)
    stride = -(-n // _MEMBER_ALIGN) * _MEMBER_ALIGN
    src = flat.new_empty((nb, stride))[:, :n]
    src.copy_(flat.reshape(nb, n))
    out = flat.new_empty((nb, stride))[:, :n]
    for i in range(nb):
        torch.mv(coarse_inv, src[i], out=out[i])
    return out.reshape(lead + (n,))


def coarse_solve(rhs, a, b, dinv, coarse_inv, h1: float, h2: float,
                 config: MGConfig):
    """The coarsest-level solve: the dense symmetrised inverse as one
    interior matvec per member when it was built (``coarse_dense_limit``),
    else ``coarse_sweeps`` smoother sweeps from zero."""
    if coarse_inv is None:
        return smooth_jacobi(None, rhs, a, b, dinv, h1, h2,
                             config.coarse_sweeps, config.omega,
                             from_zero=True)
    mc, nc = rhs.shape[-2] - 1, rhs.shape[-1] - 1
    flat = rhs[..., 1:-1, 1:-1].reshape(rhs.shape[:-2]
                                        + ((mc - 1) * (nc - 1),))
    e = coarse_matvec(coarse_inv, flat)
    return pad_interior(e.reshape(rhs.shape[:-2] + (mc - 1, nc - 1)))


def v_cycle(hier: MGLevels, r, h1: float, h2: float,
            config: MGConfig = DEFAULT_MG):
    """One V(ν₁, ν₂) cycle applied to the residual ``r``: z ≈ A⁻¹r.

    Recursion over the level tuple; ``h1``/``h2`` are the finest spacings,
    doubled at each level. Symmetric by construction (module docstring),
    so the result is an SPD preconditioner application for the outer CG.
    """
    levels = hier.levels

    def cycle(lvl: int, rl):
        a, b, dinv = levels[lvl]
        h1l, h2l = h1 * (1 << lvl), h2 * (1 << lvl)
        if lvl == len(levels) - 1:
            return coarse_solve(rl, a, b, dinv, hier.coarse_inv,
                                h1l, h2l, config)
        x = smooth_jacobi(None, rl, a, b, dinv, h1l, h2l,
                          config.pre_smooth, config.omega, from_zero=True)
        res = rl - apply_A(x, a, b, h1l, h2l)
        ec = cycle(lvl + 1, restrict_full_weighting(res))
        x = x + prolong_bilinear(ec)
        return smooth_jacobi(x, rl, a, b, dinv, h1l, h2l,
                             config.post_smooth, config.omega)

    return cycle(0, r)
