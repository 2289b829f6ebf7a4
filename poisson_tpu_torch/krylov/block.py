"""Block conjugate gradients: one (n × B) iterate, B×B recurrences
(counterpart of ``poisson_tpu/krylov/block.py``).

Where ``solvers.batched`` steps B independent recurrences, each member
searching only its own Krylov space, the block recurrence applies the
operator to all B search directions and couples them through small B×B
solves, so each member converges over the union of the members' spaces:
fewer total iterations on spectrally rich ("clustered") batches.

The recurrence is the breakdown-free variant (O'Leary's rank-deficiency
remedy, as in the JAX package): the direction block is re-orthonormalized
every iteration by a rank-revealing symmetric orthogonalization,

    P ← P·Q·Λ^{-1/2}   over the eigenpairs of PᵀP above a relative cut;
                        truncated directions become zero columns,

so a rank-deficient block (near-parallel right-hand sides) runs at its
effective rank instead of breaking down:

    P  = orth(Z₀)
    Q  = A P
    Λ  = (PᵀQ)⁺ (PᵀR)                   (B×B eigh pseudo-inverse)
    X += P Λ;   R −= Q Λ
    Z  = M⁻¹ R
    Ψ  = −(PᵀQ)⁺ (QᵀZ)
    P  = orth(Z + P Ψ)

Any truncation sets ``PCGResult.deficient``. Only a fully degenerate block
(max |λ(PᵀQ)| under 1e-15) or a non-finite update stops it, with
FLAG_BREAKDOWN / FLAG_NONFINITE on every unconverged member and the
pre-update state kept. Each member records its own first crossing of δ
(``iterations``, ``diff``, ``flag``); a converged member's iterate is frozen
while its residual column keeps riding the recurrence.

The port's loop is eager: ``solvers.pcg.drive`` steps it and reads ``done``
after every step (``check_every=1``, as MG does). Each step already waits
for the host in its two eigendecompositions (``torch.linalg.eigh``
synchronizes on the card), so the read costs nothing more and no frozen
step runs after the stop. One eigendecomposition of S = PᵀAP serves both
the α and the β solve (the JAX package runs it twice on the same matrix).
The B×B math runs in fp64 on the state's device, with the JAX package's
x64 cuts (PyTorch always has fp64).

The block inner products are one matrix product over the flattened grids
(no interior copies): the loop keeps every field's Dirichlet ring zero
(``block_init`` projects the right-hand sides), so the whole grid's sum is
the interior's. The big products P·Λ are matrix products over the same
views, as the JAX package's are XLA dots outside any Pallas kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.stencil import interior, pad_interior
from poisson_tpu_torch.solvers.pcg import (
    FLAG_BREAKDOWN,
    FLAG_CONVERGED,
    FLAG_NONE,
    FLAG_NONFINITE,
    PCGOps,
    PCGResult,
    _select,
    drive,
    scaled_single_device_ops,
    single_device_ops,
)

# Scale-free spectral cuts (the JAX package's). _pinv: PᵀAP eigenvalues
# below tol·max|λ| are truncated from the B×B solves; _orth: the
# orthonormalization's PᵀP cut. The port always solves the B×B systems in
# fp64, so it always takes the x64 cuts; the JAX package's f32 cuts (for a
# runtime without x64) are kept for the record.
BLOCK_RANK_TOL_X64 = 1e-7
BLOCK_RANK_TOL_F32 = 1e-6
BLOCK_ORTH_TOL_X64 = 1e-10
BLOCK_ORTH_TOL_F32 = 1e-8

# Fully degenerate block: the analog of the scalar loop's |(Ap, p)| < 1e-15.
_BLOCK_DENOM_TOL = 1e-15


class BlockState(NamedTuple):
    """Block loop state: the (B, M+1, N+1) stacks and per-member verdicts."""

    k: torch.Tensor        # block iterations completed (0-d int32)
    km: torch.Tensor       # (B,) per-member first-crossing iteration
    done: torch.Tensor     # (B,) member crossed δ (all, after a stop)
    X: torch.Tensor        # (B, M+1, N+1) iterates (frozen once done)
    R: torch.Tensor
    P: torch.Tensor        # orthonormalized direction block
    rdot: torch.Tensor     # (B,) per-member (z, r) (reporting only)
    diff: torch.Tensor     # (B,) ‖ΔX_j‖ at the member's stop
    flag: torch.Tensor     # (B,) verdicts (FLAG_*)
    stop: torch.Tensor     # block-level stop (breakdown or non-finite)
    deficient: torch.Tensor  # a rank truncation at any iteration


def block_dot(U, V, h1: float, h2: float):
    """(B, B) matrix of weighted inner products S[i, j] = h1·h2·Σ U_i V_j
    over two stacks whose rings are zero (see the module note): one matrix
    product of the flattened grids."""
    return (U.reshape(U.shape[0], -1) @ V.reshape(V.shape[0], -1).T) * (
        h1 * h2)


def _combine(P, C):
    """Σ_i P_i·C[i, j] for each j: the stack ``P`` times the B×B ``C``
    (``einsum("imn,ij->jmn")``), one matrix product."""
    return (C.T @ P.reshape(P.shape[0], -1)).reshape(P.shape)


def _pinv(S, tol: float):
    """The eigendecomposition pseudo-inverse of the symmetric PSD ``S``, in
    fp64: eigenvalues below tol·max|λ| are truncated (the rank-deficiency
    remedy). Returns (``apply``, max|λ|, truncated-any), ``apply(Rm)`` being
    S⁺·Rm, so that one eigendecomposition serves the α and β solves."""
    S = S.double()
    lam, Q = torch.linalg.eigh(0.5 * (S + S.T))
    mx = lam.abs().max()
    good = lam > tol * mx
    inv = torch.where(good, 1.0 / torch.where(good, lam, 1.0), 0.0)
    return (lambda Rm: Q @ (inv[:, None] * (Q.T @ Rm.double()))), mx, \
        ~good.all()


def _orth(P, h1: float, h2: float, tol: float):
    """Rank-revealing symmetric orthonormalization of the direction block:
    P → P·Q·Λ^{-1/2} over the eigenpairs of PᵀP above tol·max λ (fp64);
    truncated directions become zero columns, so the width stays B while
    the effective block shrinks. Returns (P̃, truncated-any, max λ)."""
    G = block_dot(P, P, h1, h2).double()
    lam, Q = torch.linalg.eigh(0.5 * (G + G.T))
    mx = lam.abs().max()
    good = lam > tol * mx
    scale = torch.where(good, 1.0 / torch.sqrt(torch.where(good, lam, 1.0)),
                        0.0)
    return _combine(P, (Q * scale[None, :]).to(P.dtype)), ~good.all(), mx


def block_init(ops: PCGOps, rhs_stack, h1: float, h2: float,
               orth_tol: float = BLOCK_ORTH_TOL_X64) -> BlockState:
    """X = 0, R = B (its ring projected to zero), P = orth(M⁻¹R): the block
    form of ``solvers.pcg.init_state``."""
    B = rhs_stack.shape[0]
    dev = rhs_stack.device
    R = pad_interior(interior(rhs_stack))
    Z = ops.apply_Dinv(R)
    P, cut0, _ = _orth(Z, h1, h2, orth_tol)
    count = dict(dtype=torch.int32, device=dev)
    return BlockState(
        k=torch.zeros((), **count),
        km=torch.zeros((B,), **count),
        done=torch.zeros((B,), dtype=torch.bool, device=dev),
        X=torch.zeros_like(R), R=R, P=P,
        rdot=ops.dot(Z, R),
        diff=torch.full((B,), float("inf"), dtype=R.dtype, device=dev),
        flag=torch.full((B,), FLAG_NONE, **count),
        stop=torch.zeros((), dtype=torch.bool, device=dev),
        deficient=cut0,
    )


def make_block_step(ops: PCGOps, *, delta: float, max_iter: int,
                    weighted_norm: bool, h1: float, h2: float):
    """One block iteration as a state→state function. A finished state
    (a block stop, every member done, or ``max_iter`` reached) passes
    through unchanged, as ``solvers.pcg.drive`` requires."""

    def step(s: BlockState) -> BlockState:
        dtype = s.X.dtype
        Q = ops.apply_A(ops.exchange(s.P))
        pinv, mx, cutA = _pinv(block_dot(s.P, Q, h1, h2), BLOCK_RANK_TOL_X64)
        alpha = pinv(block_dot(s.P, s.R, h1, h2)).to(dtype)
        degenerate = mx < _BLOCK_DENOM_TOL
        dX = _combine(s.P, alpha)
        # A converged member's answer stops moving; its residual column
        # keeps riding the recurrence (the block needs its full width).
        Xn = torch.where(s.done[:, None, None], s.X, s.X + dX)
        Rn = s.R - _combine(Q, alpha)
        sq = ops.sqnorm(dX)
        diff = torch.sqrt(sq * (h1 * h2)) if weighted_norm else torch.sqrt(sq)
        Z = ops.apply_Dinv(Rn)
        beta = pinv(-block_dot(Q, Z, h1, h2)).to(dtype)
        Pn, cutP, _ = _orth(Z + _combine(s.P, beta), h1, h2,
                            BLOCK_ORTH_TOL_X64)

        conv = diff < delta
        nonfinite = ~torch.isfinite(diff).all()
        k = s.k + 1
        km = torch.where(s.done, s.km, k)
        done = s.done | conv
        flag = torch.where(conv & ~s.done, FLAG_CONVERGED, s.flag).to(
            torch.int32)
        deficient = s.deficient | cutA | cutP
        candidate = BlockState(
            k=k, km=km, done=done, X=Xn, R=Rn, P=Pn, rdot=ops.dot(Z, Rn),
            diff=torch.where(s.done, s.diff, diff), flag=flag,
            stop=torch.zeros_like(s.stop), deficient=deficient)
        # A degenerate or non-finite step keeps the pre-update state and
        # stamps the verdict on every member not yet converged.
        flag_bad = torch.where(
            s.done, s.flag,
            torch.where(nonfinite, FLAG_NONFINITE, FLAG_BREAKDOWN)).to(
                torch.int32)
        kept = s._replace(k=k, km=km, done=torch.ones_like(s.done),
                          flag=flag_bad, stop=torch.ones_like(s.stop),
                          deficient=deficient)
        new = _select(degenerate | nonfinite, kept, candidate)
        finished = s.stop | s.done.all() | (s.k >= max_iter)
        return _select(finished, s, new)

    return step


def pcg_loop_block(ops: PCGOps, rhs_stack, *, delta: float, max_iter: int,
                   weighted_norm: bool, h1: float, h2: float) -> BlockState:
    """Run the breakdown-free block recurrence to per-member convergence,
    a block stop, or ``max_iter`` block iterations, reading ``done`` after
    every step."""
    step = make_block_step(ops, delta=delta, max_iter=max_iter,
                           weighted_norm=weighted_norm, h1=h1, h2=h2)
    return drive(step, block_init(ops, rhs_stack, h1, h2), max_iter,
                 check_every=1)


def clustered_ellipse_stack(problem: Problem, B: int, eps: float = 0.4,
                            seed: int = 0):
    """A clustered right-hand-side batch with exact solutions, numpy fp64
    (the JAX package's, bit for bit).

    Member j's forcing is ``g_j·f₀ + ε·f_j`` where each (u_i, f_i) pair is
    analytic on the reference ellipse: u = φ·p with φ = 1 − x²/rx² − y²/ry²
    and p a low-order polynomial, so f = −Δu is closed-form and the mixed
    forcing's exact solution is ``g_j·u₀ + ε·u_j``. The gates come from
    ``numpy.random.default_rng(seed)``.

    Returns ``(rhs_stack, exact_u, inside)``: the (B, M+1, N+1) physical
    forcing (zero outside D ∩ interior, the ``solve_batched(rhs_stack=…)``
    contract), the exact solutions, and the strictly-inside-D mask."""
    from poisson_tpu_torch.geometry.dsl import DEFAULT_ELLIPSE as e

    if B < 1:
        raise ValueError(f"B must be >= 1, got {B}")
    h1, h2 = problem.h1, problem.h2
    i_idx = np.arange(problem.M + 1)
    j_idx = np.arange(problem.N + 1)
    x = (problem.x_min + i_idx.astype(np.float64) * h1)[:, None]
    y = (problem.y_min + j_idx.astype(np.float64) * h2)[None, :]
    rx2, ry2 = e.rx ** 2, e.ry ** 2
    phi = 1.0 - x * x / rx2 - y * y / ry2
    c = 2.0 / rx2 + 2.0 / ry2
    # (p, ∂p/∂x, ∂p/∂y, Δp) for u = φ·p; f = −Δu = c·p + 2∇φ·∇p − φ·Δp
    # with ∇φ = (−2x/rx², −2y/ry²) folded into the sign below.
    zeros = np.zeros_like(phi)
    polys = [
        (np.ones_like(phi), zeros, zeros, 0.0),
        (x + 0 * y, np.ones_like(phi), zeros, 0.0),
        (y + 0 * x, zeros, np.ones_like(phi), 0.0),
        (x * y, y + 0 * x, x + 0 * y, 0.0),
        (x * x + 0 * y, 2 * x + 0 * y, zeros, 2.0),
        (y * y + 0 * x, zeros, 2 * y + 0 * x, 2.0),
        (x * x * y, 2 * x * y, x * x + 0 * y, 2 * y + 0 * x),
        (x * y * y, y * y + 0 * x, 2 * x * y, 2 * x + 0 * y),
    ]
    modes = []
    for p, px, py, lap in polys:
        u = phi * p
        f = c * p + 2.0 * ((2 * x / rx2) * px + (2 * y / ry2) * py) \
            - phi * lap
        modes.append((u, f))
    inside = phi > 0.0
    interior_mask = np.zeros_like(inside)
    interior_mask[1:-1, 1:-1] = True
    dom = inside & interior_mask
    rng = np.random.default_rng(seed)
    gates = 1.0 + rng.random(B)
    u0, f0 = modes[0]
    us, fs = [], []
    for j in range(B):
        uj, fj = modes[j % len(modes)]
        us.append(gates[j] * u0 + eps * uj)
        fs.append(np.where(dom, gates[j] * f0 + eps * fj, 0.0))
    return np.stack(fs), np.stack(us), inside


def block_l2_errors(problem: Problem, result: PCGResult, exact_u,
                    inside) -> list:
    """Per-member weighted relative L2 against the exact solutions of
    :func:`clustered_ellipse_stack`, over the nodes strictly inside D."""
    h1h2 = problem.h1 * problem.h2
    interior_mask = np.zeros_like(inside)
    interior_mask[1:-1, 1:-1] = True
    dom = inside & interior_mask
    w = result.w.detach().cpu().double().numpy()
    out = []
    for j in range(w.shape[0]):
        err = np.sqrt(np.where(dom, (w[j] - exact_u[j]) ** 2,
                               0.0).sum() * h1h2)
        nrm = np.sqrt(np.where(dom, exact_u[j] ** 2, 0.0).sum() * h1h2)
        out.append(err / nrm if nrm else float("inf"))
    return out


def _solve_block(problem: Problem, scaled: bool, a, b, rhs_stack,
                 aux) -> PCGResult:
    """The block solve of a (B, M+1, N+1) stack (in the solve's system: b̃
    when ``scaled``) sharing ONE operator (a, b, aux unbatched). Members
    that neither converged nor stopped ran out of budget (FLAG_NONE) and
    report the loop's count."""
    ops = (scaled_single_device_ops(problem, a, b, aux) if scaled
           else single_device_ops(problem, a, b, aux))
    s = pcg_loop_block(ops, rhs_stack, delta=problem.delta,
                       max_iter=problem.iteration_cap,
                       weighted_norm=problem.weighted_norm,
                       h1=problem.h1, h2=problem.h2)
    km = torch.where(s.done | s.stop, s.km, s.k)
    w = s.X * aux if scaled else s.X
    return PCGResult(w=w, iterations=km, diff=s.diff, residual_dot=s.rdot,
                     flag=s.flag, max_iterations=km.max(),
                     deficient=s.deficient)
