"""Differentiable solves: implicit adjoint differentiation through PCG
(counterpart of ``poisson_tpu/solvers/adjoint.py``).

The fictitious-domain operator A is symmetric (shared edge coefficients),
so the vector–Jacobian product of the solve w = A⁻¹b is itself a solve:

    ∂L/∂b = λ = A⁻¹ (∂L/∂w),     ∂L/∂(a, b) = −∂/∂(a, b) ⟨λ, A(a, b)·w⟩

The JAX package gets this from ``lax.custom_linear_solve(symmetric=True)``;
here it is a ``torch.autograd.Function``, :class:`LinearSolve`:

- forward: the port's plain solve (``solvers.pcg.run_setup``, the loop
  ``pcg_solve`` runs) of the ring-projected RHS, under ``no_grad``;
- backward: λ = the same solve of the cotangent; the coefficient grads by
  one ``torch.autograd.grad`` of ``ops.stencil.apply_A``;
- jvp (forward mode): dw = A⁻¹(db − dA·w), with dA·w = A(da, db)·w since
  the operator is linear in its coefficients.

Autograd never sees the CG loop: memory is O(1) in the iteration count and
the gradients are exact to the solver's δ. The preconditioner (aux) is
built from detached coefficients and carries no derivative, as JAX's
``solve_fn`` is a black box to ``custom_linear_solve``.

:func:`differentiable_geometry_solve` builds the canvases of a closed-form
spec (``Ellipse``, ``Rectangle``) with torch operations
(``geometry.canvas.traced_fields``), so the gradient reaches the shape
parameters through the ε-blend; :func:`shape_gradient` returns (loss,
∂loss/∂params) for a shape-design objective with one forward and one
adjoint solve. Sampled families raise.
"""

from __future__ import annotations

import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.stencil import (
    apply_A,
    diag_D,
    interior,
    pad_interior,
)
from poisson_tpu_torch.solvers.pcg import (
    SolveSetup,
    resolve_dtype,
    resolve_scaled,
    run_setup,
    setup_from_fields,
    solve_fields,
)
from poisson_tpu_torch.utils.platform import resolve_device


def _solve(problem: Problem, setup: SolveSetup, rhs):
    """w = A⁻¹ rhs for a physical RHS (ring ignored): the scaled system
    solves b̃ = D^{-1/2}·rhs, whose aux has a zero ring."""
    r = rhs * setup.aux if setup.scaled else pad_interior(interior(rhs))
    return run_setup(problem, setup, r).w


class LinearSolve(torch.autograd.Function):
    """``w = A(a, b)⁻¹ rhs`` with implicit (adjoint) derivatives in
    ``rhs``, ``a`` and ``b``. ``setup`` is the plain solve's bundle on the
    detached coefficients; ``rhs`` arrives ring-projected."""

    @staticmethod
    def forward(ctx, rhs, a, b, problem, setup):
        w = _solve(problem, setup, rhs)
        ctx.problem, ctx.setup = problem, setup
        ctx.save_for_backward(w, a, b)
        ctx.save_for_forward(w, a, b)
        return w

    @staticmethod
    def backward(ctx, grad_w):
        w, a, b = ctx.saved_tensors
        problem = ctx.problem
        lam = _solve(problem, ctx.setup, grad_w)
        need_a, need_b = ctx.needs_input_grad[1:3]
        grad_a = grad_b = None
        if need_a or need_b:
            with torch.enable_grad():
                a_ = a.detach().requires_grad_(need_a)
                b_ = b.detach().requires_grad_(need_b)
                inner = torch.sum(lam * apply_A(w, a_, b_, problem.h1,
                                                problem.h2))
                wrt = [t for t, need in ((a_, need_a), (b_, need_b)) if need]
                grads = iter(torch.autograd.grad(inner, wrt))
            grad_a = -next(grads) if need_a else None
            grad_b = -next(grads) if need_b else None
        return lam, grad_a, grad_b, None, None

    @staticmethod
    def jvp(ctx, d_rhs, d_a, d_b, _problem, _setup):
        w, a, b = ctx.saved_tensors
        problem = ctx.problem
        rhs_dot = (torch.zeros_like(w) if d_rhs is None
                   else pad_interior(interior(d_rhs)))
        if d_a is not None or d_b is not None:
            da = torch.zeros_like(a) if d_a is None else d_a
            db = torch.zeros_like(b) if d_b is None else d_b
            rhs_dot = rhs_dot - apply_A(w, da, db, problem.h1, problem.h2)
        return _solve(problem, ctx.setup, rhs_dot)


def _aux(a, b, problem: Problem, scaled: bool):
    """The solve's aux from (detached) coefficients: D, or D^{-1/2}, in the
    zero ring."""
    from poisson_tpu_torch.models.fictitious_domain import sqrt_rn

    d = diag_D(a, b, problem.h1, problem.h2)
    return pad_interior(1.0 / sqrt_rn(d) if scaled else d)


def differentiable_solve(problem: Problem, rhs_grid, dtype=None,
                         scaled=None, device=None):
    """``w = A⁻¹ rhs`` on the full (M+1, N+1) grid of the reference
    ellipse, differentiable in ``rhs_grid`` (reverse mode, and forward
    mode under ``torch.autograd.forward_ad``). Ring entries of
    ``rhs_grid`` are ignored (Dirichlet). Runs on ``device`` (default
    ``cuda``)."""
    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    a, b, _, aux = solve_fields(problem, dtype_name, use_scaled, dev)
    setup = setup_from_fields(problem, a, b, None, aux, dtype_name,
                              use_scaled)
    rhs = torch.as_tensor(rhs_grid, dtype=getattr(torch, dtype_name),
                          device=dev)
    return LinearSolve.apply(pad_interior(interior(rhs)), a, b, problem,
                             setup)


def differentiable_geometry_solve(problem: Problem, spec, dtype=None,
                                  scaled=None, device=None):
    """``w(spec)`` on the full (M+1, N+1) grid, differentiable in the shape
    parameters of a closed-form spec (``Ellipse``, ``Rectangle``) whose
    fields may be tensors with ``requires_grad``. The canvases come from
    ``geometry.canvas.traced_fields``; the RHS indicator carries no
    derivative (it is piecewise constant in the parameters), so the shape
    sensitivity flows through the blend coefficients. Runs on ``device``
    (default ``cuda``)."""
    from poisson_tpu_torch.geometry.canvas import traced_fields

    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    a, b, rhs = traced_fields(problem, spec, getattr(torch, dtype_name),
                              dev)
    aux = _aux(a.detach(), b.detach(), problem, use_scaled)
    setup = setup_from_fields(problem, a.detach(), b.detach(), None, aux,
                              dtype_name, use_scaled)
    return LinearSolve.apply(pad_interior(interior(rhs)), a, b, problem,
                             setup)


def shape_gradient(problem: Problem, spec_fn, params, loss_fn, dtype=None,
                   scaled=None, device=None):
    """(loss, ∂loss/∂params) for a shape-design objective: ``spec_fn``
    builds a closed-form spec from ``params`` (a tensor, a sequence of
    numbers, or a dict of them), ``loss_fn(w)`` scores the solution grid.
    One forward and one adjoint solve, whatever the iteration counts.
    The gradient has the structure of ``params`` (a tensor for a tensor
    or a sequence)."""
    dev = resolve_device(device)
    dt = getattr(torch, resolve_dtype(dtype))
    leaf = lambda v: torch.as_tensor(v, dtype=dt, device=dev).detach(
        ).clone().requires_grad_(True)
    if isinstance(params, dict):
        p = {k: leaf(v) for k, v in params.items()}
        leaves = list(p.values())
    else:
        p = leaf(params)
        leaves = [p]
    w = differentiable_geometry_solve(problem, spec_fn(p), dtype=dtype,
                                      scaled=scaled, device=dev)
    loss = loss_fn(w)
    grads = torch.autograd.grad(loss, leaves)
    grad = (dict(zip(p, grads)) if isinstance(params, dict) else grads[0])
    return loss.detach(), grad
