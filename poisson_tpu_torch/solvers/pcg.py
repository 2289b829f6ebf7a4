"""Diagonally-preconditioned conjugate gradients in plain PyTorch
(counterpart of ``poisson_tpu/solvers/pcg.py``, the JAX ``xla`` backend).

This is the port's library-free solver: every step is an ordinary tensor
operation, and it is the reference the fused canvas path
(``ops.fused_cg``) is held against on the card.

Iteration structure (exactly the reference's, ``stage2:…cpp:400-457``):
    w0 = 0;  r0 = B;  z0 = D⁻¹r0;  p0 = z0;  ζ0 = (z0,r0)
    repeat k = 1, 2, …:
        Ap   = A p
        den  = (Ap, p);  stop if |den| < 1e-15 (degenerate, state kept)
        α    = ζ/den
        w   += αp;  r −= αAp;  diff = ‖αp‖  (weighted or not, Problem.weighted_norm)
        z    = D⁻¹r;  ζ' = (z, r)
        stop if diff < δ  (this iteration counts, updates kept)
        β    = ζ'/ζ;  p = z + βp

The JAX loop never leaves the device (``poisson_tpu/solvers/pcg.py:458-487``).
Here the state — k, done, ζ, diff and flag included — stays in device
tensors too; the host reads ``done`` only once every ``check_every``
iterations (:func:`drive`). Iterations run after the stop are masked by
``done``, which freezes the state, so the count stays exact.

The same body runs a batch (``solvers.batched``): with ``members`` ops the
scalars are (B, 1, 1) member scalars that broadcast over the (B, M+1, N+1)
fields, and each member's sums are its own solve's ``torch.sum`` calls
(``ops.stencil.member_sums``), so member i of a batch equals its own solve
bit for bit.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.models.fictitious_domain import build_fields
from poisson_tpu_torch.ops.stencil import (
    apply_A,
    apply_Dinv,
    diag_D,
    dot_weighted,
    member_sums,
)
from poisson_tpu_torch.utils.platform import resolve_device

_DENOM_TOL = 1e-15  # degenerate-direction guard (stage2:…cpp:414)

# How often the host reads the device's ``done`` flag: the only sync in the
# loop. Iterations past the stop are frozen by the done mask, so this sets
# how much work is wasted after convergence, never the count.
CHECK_EVERY = 32

# Termination verdicts in PCGState.flag / PCGResult.flag (the JAX package's
# codes, poisson_tpu/solvers/pcg.py:57-61).
FLAG_NONE = 0        # still running, or a solver that does not track verdicts
FLAG_CONVERGED = 1   # ‖Δw‖ < δ
FLAG_BREAKDOWN = 2   # |(Ap, p)| below the degenerate-direction guard
FLAG_NONFINITE = 3   # NaN/Inf reached the residual or update norm
FLAG_STAGNATED = 4   # no best-‖Δw‖ improvement for a full stagnation window
FLAG_DEADLINE = 5    # a chunked solve's deadline expired (result only)

FLAG_NAMES = {
    FLAG_NONE: "running",
    FLAG_CONVERGED: "converged",
    FLAG_BREAKDOWN: "breakdown",
    FLAG_NONFINITE: "nonfinite",
    FLAG_STAGNATED: "stagnated",
    FLAG_DEADLINE: "deadline",
}


def _unchanged(p):
    return p


class PCGOps(NamedTuple):
    """Backend bundle consumed by the PCG loop.

    apply_A:    p → Ap, zero outside the interior
    apply_Dinv: r → D⁻¹r, zero outside the interior
    dot:        (u, v) → weighted inner product h1·h2·Σ u·v
    sqnorm:     u → Σ_interior u², unweighted (the convergence sum)
    exchange:   p → p with refreshed halos, at the top of every iteration
                (the identity on one device; ``parallel.pcg_sharded``)
    """

    apply_A: Callable
    apply_Dinv: Callable
    dot: Callable
    sqnorm: Callable
    exchange: Callable = _unchanged


class PCGState(NamedTuple):
    k: torch.Tensor        # iterations completed (int32)
    done: torch.Tensor     # converged, degenerate, or diverged (bool)
    w: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    zr: torch.Tensor       # ζ = (z, r)
    diff: torch.Tensor     # last ‖w(k+1)−w(k)‖
    flag: torch.Tensor     # termination verdict (FLAG_*, int32)
    best: torch.Tensor     # best ‖Δw‖ seen so far
    stall: torch.Tensor    # iterations since best improved (int32)


class PCGResult(NamedTuple):
    """Solve result. A batched solve (``solvers.batched``) returns the same
    type with a leading batch axis on ``w``/``iterations``/``diff``/
    ``residual_dot``/``flag``, plus ``max_iterations`` (the count the batch
    loop ran, its slowest member's) and ``origin`` (one id per member)."""

    w: torch.Tensor            # full (…, M+1, N+1) solution grid(s)
    iterations: torch.Tensor   # iteration count; a vector when batched
    diff: torch.Tensor         # final update norm
    residual_dot: torch.Tensor  # final ζ = (D⁻¹r, r)
    flag: int | torch.Tensor = FLAG_NONE  # termination verdict (FLAG_*)
    max_iterations: object = None   # batched only: max over the members
    origin: object = None           # batched only: member ids, in order


def iterations_scalar(iterations) -> int:
    """One honest count from an ``iterations`` field: the value itself for
    a single solve, the max over members for a batched vector (what the
    batch loop ran and the wall clock paid for)."""
    if isinstance(iterations, torch.Tensor):
        iterations = iterations.cpu()
    arr = np.asarray(iterations)
    return int(arr.max()) if arr.ndim else int(arr)


def _select(pred, new, old):
    """Field-wise ``where(pred, new, old)`` over two states of one type; a
    field that is one tensor in both is taken as it is."""
    return type(new)(*(n if n is o else torch.where(pred, n, o)
                       for n, o in zip(new, old)))


def drive(step, s, cap: int, check_every: int = CHECK_EVERY):
    """Apply ``step`` to state ``s`` until ``s.done`` or ``cap`` iterations.

    ``step`` must freeze a done state (count included). The host reads
    ``s.done`` once per ``check_every`` steps — the loop's only device sync —
    and never runs more than ``cap`` steps in all. A batched state is done
    when every member is."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    ran = 0
    while ran < cap:
        n = min(check_every, cap - ran)
        for _ in range(n):
            s = step(s)
        ran += n
        if bool(torch.all(s.done)):
            break
    return s


def init_state(ops: PCGOps, rhs) -> PCGState:
    """w=0, r=B, z=D⁻¹r, p=z, ζ=(z,r)  (stage2:…cpp:384-396). The scalars
    take ζ's shape: 0-d for one solve, (B, 1, 1) for a batch."""
    z = ops.apply_Dinv(rhs)
    zr = ops.dot(z, rhs)
    shape, device = tuple(zr.shape), zr.device
    scalar = dict(dtype=zr.dtype, device=device)
    count = dict(dtype=torch.int32, device=device)
    return PCGState(
        k=torch.zeros(shape, **count),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        w=torch.zeros_like(rhs), r=rhs, z=z, p=z, zr=zr,
        diff=torch.full(shape, float("inf"), **scalar),
        flag=torch.full(shape, FLAG_NONE, **count),
        best=torch.full(shape, float("inf"), **scalar),
        stall=torch.zeros(shape, **count),
    )


def make_pcg_body(ops: PCGOps, *, delta: float, weighted_norm: bool,
                  h1: float, h2: float, stagnation_window: int = 0):
    """One PCG iteration as a state→state function, with the JAX body's
    in-loop verdicts (``poisson_tpu/solvers/pcg.py:268-395``): NaN/Inf in
    the scalars sets FLAG_NONFINITE, the degenerate-direction break
    FLAG_BREAKDOWN (state kept), and — when ``stagnation_window`` > 0 — that
    many iterations without a new best ‖Δw‖ set FLAG_STAGNATED.

    A state that is already done passes through unchanged, count included,
    so the loop may run past the stop (see :func:`drive`)."""

    def body(s: PCGState) -> PCGState:
        p = ops.exchange(s.p)
        Ap = ops.apply_A(p)
        denom = ops.dot(Ap, p)
        degenerate = denom.abs() < _DENOM_TOL
        alpha = s.zr / torch.where(degenerate, 1.0, denom)

        dw = alpha * p
        w_new = s.w + dw
        r_new = s.r - alpha * Ap
        sq = ops.sqnorm(dw)
        diff = torch.sqrt(sq * (h1 * h2)) if weighted_norm else torch.sqrt(sq)

        z_new = ops.apply_Dinv(r_new)
        zr_new = ops.dot(z_new, r_new)
        converged = diff < delta
        beta = zr_new / torch.where(s.zr == 0.0, 1.0, s.zr)
        p_new = z_new + beta * p

        nonfinite = ~(torch.isfinite(diff) & torch.isfinite(zr_new))
        improved = diff < s.best
        best_new = torch.minimum(s.best, diff)
        stall_new = torch.where(improved, 0, s.stall + 1).to(torch.int32)
        if stagnation_window > 0:
            stagnated = (~converged) & (stall_new >= stagnation_window)
        else:
            stagnated = torch.zeros_like(converged)
        flag = torch.where(
            nonfinite, FLAG_NONFINITE,
            torch.where(converged, FLAG_CONVERGED,
                        torch.where(stagnated, FLAG_STAGNATED, FLAG_NONE)),
        ).to(torch.int32)
        stop = degenerate | converged | nonfinite | stagnated

        # Degenerate break happens before any update (stage2:…cpp:410-415):
        # keep the old state, counting the iteration. Convergence keeps this
        # iteration's updates. A done state keeps everything.
        k = s.k + (~s.done).to(torch.int32)
        done = s.done | stop
        flag = torch.where(
            s.done, s.flag,
            torch.where(degenerate, FLAG_BREAKDOWN, flag).to(torch.int32))
        candidate = PCGState(
            k=k, done=done, w=w_new, r=r_new, z=z_new, p=p_new,
            zr=zr_new, diff=diff, flag=flag, best=best_new, stall=stall_new,
        )
        kept = s._replace(k=k, done=done, flag=flag)
        return _select(s.done | degenerate, kept, candidate)

    return body


def pcg_loop(ops: PCGOps, rhs, *, delta: float, max_iter: int,
             weighted_norm: bool, h1: float, h2: float,
             stagnation_window: int = 0,
             check_every: int = CHECK_EVERY) -> PCGState:
    """Run the PCG iteration to convergence. The body freezes a done state,
    so the iterations :func:`drive` runs between two reads of ``done``
    leave the result and the count untouched."""
    body = make_pcg_body(ops, delta=delta, weighted_norm=weighted_norm,
                         h1=h1, h2=h2, stagnation_window=stagnation_window)
    return drive(body, init_state(ops, rhs), max_iter, check_every)


def single_device_ops(problem: Problem, a, b, aux,
                      members: bool = False) -> PCGOps:
    """The reference's literal Jacobi-PCG on A. ``aux`` is the Jacobi
    diagonal embedded in the full grid's zero ring. ``members``: the state
    is a (B, M+1, N+1) stack and every sum a (B, 1, 1) member scalar with
    the bits of the member's own solve (``ops.stencil.member_sums``), for
    ``solvers.batched``."""
    h1, h2 = problem.h1, problem.h2
    d = aux[..., 1:-1, 1:-1]
    if members:
        sqnorm = lambda u: member_sums(torch.mul, u[..., 1:-1, 1:-1],
                                       u[..., 1:-1, 1:-1])
    else:
        sqnorm = lambda u: torch.sum(
            u[..., 1:-1, 1:-1] * u[..., 1:-1, 1:-1], dim=(-2, -1)
        )
    return PCGOps(
        apply_A=lambda p: apply_A(p, a, b, h1, h2),
        apply_Dinv=lambda r: apply_Dinv(r, d),
        dot=_dot(h1, h2, members),
        sqnorm=sqnorm,
    )


def _dot(h1: float, h2: float, members: bool):
    """The weighted inner product; per member with ``members``."""
    if members:
        return lambda u, v: member_sums(
            torch.mul, u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1]) * (h1 * h2)
    return lambda u, v: dot_weighted(u, v, h1, h2)


def scaled_single_device_ops(problem: Problem, a, b, sc,
                             members: bool = False) -> PCGOps:
    """Plain CG on the symmetrically scaled Ã = D^{-1/2} A D^{-1/2}.

    Iterate-identical to Jacobi-PCG on A under y = D^{1/2}w, with unit
    diagonal and O(1) entries — what makes fp32 reproduce the fp64 golden
    counts. ``sc`` is D^{-1/2} on the full grid (zero ring); the
    preconditioner is the identity, the convergence norm is mapped back to
    w-space via ‖Δw‖ = ‖sc·Δy‖, and the caller maps the solution back with
    w = sc·y."""
    h1, h2 = problem.h1, problem.h2
    if members:
        sqnorm = lambda u: member_sums(torch.pow,
                                       (u * sc)[..., 1:-1, 1:-1], 2)
    else:
        sqnorm = lambda u: torch.sum((u * sc)[..., 1:-1, 1:-1] ** 2,
                                     dim=(-2, -1))
    return PCGOps(
        apply_A=lambda p: apply_A(p * sc, a, b, h1, h2) * sc,
        apply_Dinv=lambda r: r,
        dot=_dot(h1, h2, members),
        sqnorm=sqnorm,
    )


@functools.lru_cache(maxsize=8)
def host_fields64(problem: Problem, scaled: bool):
    """The problem fields on the host in numpy fp64: (a, b, rhs_use, aux) on
    the full (M+1, N+1) grid. ``aux`` is the zero-ring embedding of D
    (unscaled) or of D^{-1/2} (scaled); ``rhs_use`` is B or b̃ = D^{-1/2}B.

    Cached and shared between callers, so the arrays are read-only."""
    a64, b64, rhs64 = build_fields(problem, dtype=np.float64)
    d64 = diag_D(a64, b64, problem.h1, problem.h2)
    if not scaled:
        out = (a64, b64, rhs64, np.pad(d64, 1))
    else:
        inv_sqrt_d = 1.0 / np.sqrt(d64)
        out = (a64, b64, np.pad(rhs64[1:-1, 1:-1] * inv_sqrt_d, 1),
               np.pad(inv_sqrt_d, 1))
    for arr in out:
        arr.flags.writeable = False
    return out


def resolve_dtype(dtype) -> str:
    """The state precision's name. ``None`` is float64: unlike JAX without
    x64, PyTorch always has it, and fp64 Jacobi is the oracle mode."""
    if dtype is None:
        return "float64"
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    else:
        name = np.dtype(dtype).name
    if name not in ("float32", "float64"):
        raise ValueError(f"dtype must be float32 or float64, got {dtype!r}")
    return name


def resolve_scaled(scaled, dtype_name: str) -> bool:
    """Default precision policy: sub-64-bit state uses the symmetrically
    scaled system; fp64 runs the reference's literal Jacobi-PCG."""
    if scaled is None:
        return dtype_name != "float64"
    return bool(scaled)


class SolveSetup(NamedTuple):
    """The plain solve's operands on one device, and how often its loop
    reads ``done`` (``mg.preconditioner`` reads it every iteration)."""

    ops: PCGOps
    rhs: torch.Tensor
    aux: torch.Tensor   # D (unscaled) or D^{-1/2} (scaled), zero ring
    dtype_name: str
    scaled: bool
    check_every: int = CHECK_EVERY


def solve_setup(problem: Problem, dtype=None, scaled=None,
                device=None, members: bool = False) -> SolveSetup:
    """Host fp64 setup cast once to the state precision on ``device``
    (default ``cuda``; raises without a card), and the backend bundle
    (with ``members``, the batched one)."""
    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    tdtype = getattr(torch, dtype_name)
    a, b, rhs, aux = (torch.tensor(x, dtype=tdtype, device=dev)
                      for x in host_fields64(problem, use_scaled))
    ops = (scaled_single_device_ops(problem, a, b, aux, members)
           if use_scaled else single_device_ops(problem, a, b, aux, members))
    return SolveSetup(ops, rhs, aux, dtype_name, use_scaled)


def gate_rhs(rhs: torch.Tensor, rhs_gate) -> torch.Tensor:
    """``rhs`` times the scalar ``rhs_gate``, cast to the state's type
    first, as the JAX package multiplies it (``rhs * asarray(gate,
    dtype)``); a vector of B gates gives the (B, M+1, N+1) stack, each
    member the same products as its own gated solve."""
    gate = torch.as_tensor(rhs_gate, dtype=rhs.dtype, device=rhs.device)
    if gate.dim() == 0:
        return rhs * gate
    return rhs * gate.reshape(-1, *([1] * rhs.dim()))


def pcg_solve(problem: Problem, dtype=None, scaled=None, device=None,
              check_every: Optional[int] = None, rhs_gate=None,
              preconditioner: str = "jacobi", mg_config=None) -> PCGResult:
    """Single-device plain solve. ``device`` defaults to ``cuda`` (raises
    without a card); setup runs on the host in fp64 and is cast once.
    ``rhs_gate``, if given, is a scalar the RHS is multiplied by (in the
    state's type): member i of ``solve_batched(problem, rhs_gates=g)`` is
    ``pcg_solve(problem, rhs_gate=g[i])``, bit for bit.

    ``preconditioner`` is the M⁻¹ of the recurrence: ``"jacobi"`` (the
    default, the diagonal) or ``"mg"``, one geometric V-cycle per
    iteration (``poisson_tpu_torch.mg``; the grid must coarsen, see
    ``mg.validate_mg_problem``), tuned by ``mg_config`` (an
    ``mg.MGConfig``; None for the defaults). ``check_every`` (see
    :func:`drive`) defaults to the setup's: CHECK_EVERY for Jacobi, 1 for
    MG, whose few iterations are each dear."""
    from poisson_tpu_torch.mg.hierarchy import mg_config_for

    config = mg_config_for(problem, preconditioner, mg_config)
    if config is None:
        setup = solve_setup(problem, dtype, scaled, device)
    else:
        from poisson_tpu_torch import obs
        from poisson_tpu_torch.mg.preconditioner import mg_solve_setup

        setup = mg_solve_setup(problem, dtype, scaled, device, config=config)
        obs.inc("mg.solves")
    rhs = setup.rhs if rhs_gate is None else gate_rhs(setup.rhs, rhs_gate)
    s = pcg_loop(setup.ops, rhs, delta=problem.delta,
                 max_iter=problem.iteration_cap,
                 weighted_norm=problem.weighted_norm,
                 h1=problem.h1, h2=problem.h2,
                 check_every=(setup.check_every if check_every is None
                              else check_every))
    w = s.w * setup.aux if setup.scaled else s.w
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr,
                     flag=s.flag)
