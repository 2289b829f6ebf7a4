"""Operator library in PyTorch: variable-coefficient 5-point stencil, Jacobi
preconditioner, weighted inner product (counterpart of
``poisson_tpu/ops/stencil.py``).

Array convention: full grids of shape (…, M+1, N+1); the Dirichlet ring
(i ∈ {0, M} or j ∈ {0, N}) is identically zero for all solver state.
Operators read the ring but only ever write the interior.

Every op is polymorphic in leading batch dimensions, as in the JAX module
(``poisson_tpu/ops/stencil.py:17-30``): state tensors may carry leading axes;
the coefficient fields a/b/d either stay unbatched and broadcast or carry
their own matching leading axes. Reductions (``dot_weighted``,
``member_sums``) sum only the two trailing grid axes, so they are
per-member; ``member_sums`` also keeps each member's bits those of its
own unbatched sum, whatever the batch around it.

These are the plain reference operators of the port (the ``torch`` backend
of ``solvers.pcg``); the fused canvas path (``ops.fused_cg``) runs its own
folded-coefficient form of the same operator.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def weak(c: float, dtype) -> float:
    """A Python constant as it meets a ``dtype`` operand in the JAX package:
    its weak typing rounds the constant to bfloat16 for a bf16 operand,
    where torch would keep it in fp32. Other dtypes take it unchanged."""
    if dtype == torch.bfloat16:
        return float(torch.tensor(c, dtype=torch.bfloat16))
    return c


def interior(u):
    """Interior view u[…, 1:-1, 1:-1] (unknowns i=1..M-1, j=1..N-1)."""
    return u[..., 1:-1, 1:-1]


def _cslice(field, rows, cols):
    """Coefficient-field slice on the LAST two axes (leading member axes,
    if any, are kept)."""
    return field[..., rows, cols]


def pad_interior(u_int):
    """Embed a (…, M-1, N-1) interior block into the zero Dirichlet ring
    (leading batch axes, if any, are left untouched)."""
    return F.pad(u_int, (1, 1, 1, 1))


def apply_A(w, a, b, h1: float, h2: float):
    """5-point variable-coefficient Laplacian, zero outside the interior.

    (Aw)ij = −[a_{i+1,j}(w_{i+1,j}−w_ij) − a_ij(w_ij−w_{i−1,j})]/h1²
             −[b_{i,j+1}(w_{i,j+1}−w_ij) − b_ij(w_ij−w_{i,j−1})]/h2²
    (``stage0/Withoutopenmp1.cpp:75-88``), in the JAX module's operation
    order, so fp64 results agree with it to the last bit or two.
    """
    wc = w[..., 1:-1, 1:-1]
    mid = slice(1, -1)
    ax = (
        _cslice(a, slice(2, None), mid) * (w[..., 2:, 1:-1] - wc)
        - _cslice(a, mid, mid) * (wc - w[..., :-2, 1:-1])
    ) / weak(h1 * h1, w.dtype)
    ay = (
        _cslice(b, mid, slice(2, None)) * (w[..., 1:-1, 2:] - wc)
        - _cslice(b, mid, mid) * (wc - w[..., 1:-1, :-2])
    ) / weak(h2 * h2, w.dtype)
    return pad_interior(-(ax + ay))


def diag_D(a, b, h1: float, h2: float):
    """Jacobi diagonal D_ij = (a_{i+1,j}+a_ij)/h1² + (b_{i,j+1}+b_ij)/h2²
    over the interior, shape (…, M-1, N-1)
    (``stage0/Withoutopenmp1.cpp:91-103``). Slicing and arithmetic only, so
    it takes numpy arrays (the host fp64 setup) as well as tensors."""
    mid = slice(1, -1)
    return (
        _cslice(a, slice(2, None), mid) + _cslice(a, mid, mid)
    ) / (h1 * h1) + (
        _cslice(b, mid, slice(2, None)) + _cslice(b, mid, mid)
    ) / (h2 * h2)


def apply_Dinv(r, d):
    """z = D⁻¹ r with a precomputed interior diagonal ``d`` (z = 0 where
    D == 0, ``stage0/Withoutopenmp1.cpp:100``). The division, not a hoisted
    reciprocal, keeps fp64 results equal to the reference's."""
    nz = d != 0.0
    z = torch.where(nz, r[..., 1:-1, 1:-1] / torch.where(nz, d, 1.0), 0.0)
    return pad_interior(z)


def sum_products(u, v):
    """Σ over the two trailing axes of u·v. The product of two bfloat16
    values is exact in fp32, where the JAX package sums it unrounded, so
    bf16 operands multiply in fp32 and only the sum rounds to bf16."""
    if u.dtype == torch.bfloat16:
        return torch.sum(u.float() * v.float(), dim=(-2, -1)).to(u.dtype)
    return torch.sum(u * v, dim=(-2, -1))


def dot_weighted(u, v, h1: float, h2: float):
    """Weighted inner product h1·h2·Σ_interior u·v, reduced per batch member:
    a 0-d tensor for 2D grids, shape (…,) for batched stacks."""
    return sum_products(u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1]) * weak(
        h1 * h2, u.dtype)


# A member of a ``member_sums`` buffer starts on a multiple of this many
# elements (512 bytes or more), where a fresh tensor starts.
_MEMBER_ALIGN = 128


def member_sums(op, x, *args):
    """Σ over the two trailing axes of the elementwise ``op(x, *args)`` on
    a (B, m, n) stack, per member, as (B, 1, 1) member scalars.

    Each member is summed by the call an unbatched solve makes on its own
    (m, n) product, ``torch.sum(t, dim=(-2, -1))`` of a contiguous tensor
    on an aligned start: ``op`` writes into a buffer whose members are
    contiguous and start on :data:`_MEMBER_ALIGN` boundaries. So member i's
    sum has the bits of its own solve's, whatever B. One ``torch.sum`` over
    the stack would not: its order depends on the number of outputs (its
    launch geometry on the card, its thread split on the CPU). One
    elementwise launch and B sums (each two launches on the card)."""
    nb, m, n = x.shape
    size = m * n
    stride = -(-size // _MEMBER_ALIGN) * _MEMBER_ALIGN
    out = x.new_empty((nb, stride))[:, :size].view(nb, m, n)
    op(x, *args, out=out)
    sums = x.new_empty((nb, 1, 1))
    for i in range(nb):
        torch.sum(out[i], dim=(-2, -1), out=sums[i, 0, 0])
    return sums
