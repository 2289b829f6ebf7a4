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

The integrity probe (``verify_every``, ``poisson_tpu_torch.integrity``), the
streamed convergence samples (``stream_every``, ``obs.stream``) and the
forecast's residual history (``history_every``, ``obs.forecast``) ride the
same body (:func:`make_pcg_member_body`); at 0, the default, each adds no
operation.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.models.fictitious_domain import build_fields
from poisson_tpu_torch.obs.profile import region
from poisson_tpu_torch.ops.stencil import (
    apply_A,
    apply_Dinv,
    dot_weighted,
    member_sums,
    sum_products,
    weak,
)
from poisson_tpu_torch.solvers import graphs
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
FLAG_INTEGRITY = 6   # the integrity probe found silent corruption

FLAG_NAMES = {
    FLAG_NONE: "running",
    FLAG_CONVERGED: "converged",
    FLAG_BREAKDOWN: "breakdown",
    FLAG_NONFINITE: "nonfinite",
    FLAG_STAGNATED: "stagnated",
    FLAG_DEADLINE: "deadline",
    FLAG_INTEGRITY: "integrity",
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
    loop ran, its slowest member's) and ``origin`` (one id per member). A
    block solve (``krylov.block``) also sets ``deficient``."""

    w: torch.Tensor            # full (…, M+1, N+1) solution grid(s)
    iterations: torch.Tensor   # iteration count; a vector when batched
    diff: torch.Tensor         # final update norm
    residual_dot: torch.Tensor  # final ζ = (D⁻¹r, r)
    flag: int | torch.Tensor = FLAG_NONE  # termination verdict (FLAG_*)
    max_iterations: object = None   # batched only: max over the members
    origin: object = None           # batched only: member ids, in order
    # Recovery provenance, set by the resilient driver only: attempts
    # taken and the ((iteration, verdict, action), …) history.
    restarts: object = None
    recovery_history: tuple = ()
    # Block solves only: whether the B×B coefficient solves truncated a
    # rank-deficient direction (a bool tensor); None on every other path.
    deficient: object = None


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
    when every member is.

    For a step marked ``capturable`` (``solvers.graphs``; the fused body on
    a card, the sharded body on a mesh's cards) each whole block is
    replayed as a captured CUDA graph, and the state returned owns its
    tensors; every other step runs eagerly.

    While a profiler runs, each block is two host ranges
    (``obs.profile.region``): ``pcg.drive.enqueue`` around its steps and
    ``pcg.drive.check`` around the flush and the read of ``done``."""
    if check_every < 1:
        raise ValueError(f"check_every must be >= 1, got {check_every}")
    flush = getattr(step, "flush", None)   # a streaming body's tap
    run = graphs.claim(step, check_every)  # None for an unmarked step
    ran = 0
    try:
        while ran < cap:
            n = min(check_every, cap - ran)
            with region("pcg.drive.enqueue"):
                if run is None:
                    for _ in range(n):
                        s = step(s)
                else:
                    s = run.advance(step, s, n)
            ran += n
            with region("pcg.drive.check"):
                if flush is not None:
                    flush()
                done = bool(torch.all(s.done))
            if done:
                break
        return s if run is None else run.finish(s)
    finally:
        if run is not None:
            run.release()


def chunked_advance(step, chunk: int, cap: int, check_every: int):
    """A chunked driver's advance (``solvers.checkpoint.run_chunked``):
    ``step`` driven ``chunk`` more iterations, never past ``cap`` in all."""
    return lambda s: drive(step, s, min(chunk, cap - int(s.k)), check_every)


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


def restart_state(ops: PCGOps, rhs, w) -> PCGState:
    """A fresh CG start from the iterate ``w``: r = B − Aw, z = M⁻¹r, p = z
    (the resilient driver's restart; the Krylov history is dropped, the
    solution kept). Built directly, not from :func:`init_state`, so that an
    MG restart runs one V-cycle, not two."""
    r = rhs - ops.apply_A(ops.exchange(w))
    z = ops.apply_Dinv(r)
    zr = ops.dot(z, r)
    shape, device = tuple(zr.shape), zr.device
    count = dict(dtype=torch.int32, device=device)
    inf = torch.full(shape, float("inf"), dtype=zr.dtype, device=device)
    return PCGState(
        k=torch.zeros(shape, **count),
        done=torch.zeros(shape, dtype=torch.bool, device=device),
        w=w, r=r, z=z, p=z, zr=zr, diff=inf,
        flag=torch.full(shape, FLAG_NONE, **count),
        best=inf.clone(), stall=torch.zeros(shape, **count),
    )


def make_pcg_member_body(ops: PCGOps, *, delta: float, weighted_norm: bool,
                         h1: float, h2: float, stagnation_window: int = 0,
                         stream_every: int = 0, verify_every: int = 0,
                         verify_tol: float = 0.0,
                         verify_jump: Optional[float] = None,
                         verify_colsum=None,
                         preconditioner: str = "jacobi",
                         history_every: int = 0):
    """One PCG iteration as ``body(state, rhs) -> state`` with the JAX
    body's in-loop verdicts (``poisson_tpu/solvers/pcg.py:220-397``): NaN/Inf
    in the scalars sets FLAG_NONFINITE, the degenerate-direction break
    FLAG_BREAKDOWN (state kept), and — when ``stagnation_window`` > 0 — that
    many iterations without a new best ‖Δw‖ set FLAG_STAGNATED. The second
    argument is read only when ``verify_every`` > 0: it is the RHS the
    integrity probe checks the true residual against (a (B, M+1, N+1) stack
    with a batched bundle, so each member checks its own).

    ``verify_every`` > 0 arms the probe (``poisson_tpu_torch.integrity``)
    with JAX's verdict: the drift check on iterations where (k+1) is a
    multiple of ``verify_every`` and on every convergence event (with the
    ABFT identity when ``verify_colsum`` is given), and the jump and
    collapse guards (``preconditioner``-calibrated ratios) on every
    iteration; a corrupt verdict sets FLAG_INTEGRITY and keeps the
    pre-step ``best``. Flags rank nonfinite > integrity > converged >
    stagnated. The drift check is computed on every iteration and selected
    where due, which keeps the host out of the loop; it only reads, so a
    clean verified solve equals the unverified one bit for bit.

    ``stream_every`` > 0 stages (k, ‖Δw‖) for ``obs.stream``, and
    ``history_every`` > 0 for the forecast history sink
    (``obs.forecast.emit_history``): the step's own count and ‖Δw‖ tensors,
    no launch added; the body's ``flush`` copies them to the host and emits
    them (see :func:`drive`). With all three at 0 the body runs exactly the
    operations of the plain iteration.

    A state that is already done passes through unchanged, count included,
    so the loop may run past the stop (see :func:`drive`)."""
    if verify_every > 0:
        from poisson_tpu_torch.integrity.probe import (
            abft_drift_exceeds,
            default_verify_collapse,
            default_verify_jump,
            drift_exceeds,
        )

        if verify_jump is None:
            verify_jump = default_verify_jump(preconditioner)
        verify_collapse = default_verify_collapse(preconditioner)
    taps = []
    if stream_every > 0 or history_every > 0:
        from poisson_tpu_torch.obs.stream import StreamTap

        if stream_every > 0:
            taps.append(StreamTap(stream_every))
        if history_every > 0:
            from poisson_tpu_torch.obs.forecast import emit_history

            taps.append(StreamTap(history_every, emit=emit_history))

    def body(s: PCGState, vrhs=None) -> PCGState:
        p = ops.exchange(s.p)
        Ap = ops.apply_A(p)
        denom = ops.dot(Ap, p)
        degenerate = denom.abs() < _DENOM_TOL
        alpha = s.zr / torch.where(degenerate, 1.0, denom)

        dw = alpha * p
        w_new = s.w + dw
        r_new = s.r - alpha * Ap
        sq = ops.sqnorm(dw)
        diff = (torch.sqrt(sq * weak(h1 * h2, sq.dtype)) if weighted_norm
                else torch.sqrt(sq))

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
        if verify_every > 0:
            due = (((s.k + 1) % verify_every) == 0) | converged
            bad = drift_exceeds(ops, w_new, r_new, vrhs, verify_tol)
            if verify_colsum is not None:
                bad = bad | abft_drift_exceeds(verify_colsum, p, Ap,
                                               verify_tol)
            # The jump guard (a convergence whose previous best sat far
            # above this step's ‖Δw‖) and the collapse guard (a one-step
            # drop without converging): the flipped-direction faces the
            # drift check cannot see. isfinite exempts the first step
            # after an init or restart.
            suspicious = (converged & torch.isfinite(s.best)
                          & (s.best > verify_jump * diff))
            collapsed = ((~converged) & torch.isfinite(s.diff)
                         & (s.diff > verify_collapse * diff))
            corrupt = ((due & bad) | suspicious | collapsed) & ~nonfinite
            best_new = torch.where(corrupt, s.best, best_new)
            flag = torch.where(
                nonfinite, FLAG_NONFINITE,
                torch.where(corrupt, FLAG_INTEGRITY,
                            torch.where(converged, FLAG_CONVERGED,
                                        torch.where(stagnated,
                                                    FLAG_STAGNATED,
                                                    FLAG_NONE))),
            ).to(torch.int32)
            stop = degenerate | converged | nonfinite | stagnated | corrupt
        else:
            flag = torch.where(
                nonfinite, FLAG_NONFINITE,
                torch.where(converged, FLAG_CONVERGED,
                            torch.where(stagnated, FLAG_STAGNATED,
                                        FLAG_NONE)),
            ).to(torch.int32)
            stop = degenerate | converged | nonfinite | stagnated

        # Degenerate break happens before any update (stage2:…cpp:410-415):
        # keep the old state, counting the iteration. Convergence keeps this
        # iteration's updates. A done state keeps everything.
        k = s.k + (~s.done).to(torch.int32)
        for tap in taps:
            tap.record(s.k, k, diff)
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

    if taps:
        def flush():
            for tap in taps:
                tap.flush()

        body.flush = flush
    return body


def make_pcg_body(ops: PCGOps, *, delta: float, weighted_norm: bool,
                  h1: float, h2: float, stagnation_window: int = 0,
                  stream_every: int = 0, verify_every: int = 0,
                  verify_tol: float = 0.0,
                  verify_jump: Optional[float] = None,
                  verify_rhs=None, verify_colsum=None,
                  preconditioner: str = "jacobi", history_every: int = 0):
    """One PCG iteration as a state→state function: the member body of
    :func:`make_pcg_member_body`, with the probe (``verify_every`` > 0)
    checking ``verify_rhs``."""
    if verify_every > 0 and verify_rhs is None:
        raise ValueError(
            "verify_every > 0 needs verify_rhs — the in-loop integrity "
            "probe recomputes the true residual b - Aw against it")
    member = make_pcg_member_body(
        ops, delta=delta, weighted_norm=weighted_norm, h1=h1, h2=h2,
        stagnation_window=stagnation_window, stream_every=stream_every,
        verify_every=verify_every, verify_tol=verify_tol,
        verify_jump=verify_jump, verify_colsum=verify_colsum,
        preconditioner=preconditioner, history_every=history_every)
    if verify_every == 0:
        return member     # vrhs defaults to None and is never read

    def body(s: PCGState) -> PCGState:
        return member(s, verify_rhs)

    if hasattr(member, "flush"):
        body.flush = member.flush
    return body


def pcg_loop(ops: PCGOps, rhs, *, delta: float, max_iter: int,
             weighted_norm: bool, h1: float, h2: float,
             stagnation_window: int = 0,
             check_every: int = CHECK_EVERY, stream_every: int = 0,
             verify_every: int = 0, verify_tol: float = 0.0,
             verify_abft: bool = False,
             preconditioner: str = "jacobi",
             history_every: int = 0) -> PCGState:
    """Run the PCG iteration to convergence. The body freezes a done state,
    so the iterations :func:`drive` runs between two reads of ``done``
    leave the result and the count untouched. ``verify_every`` /
    ``verify_tol`` arm the integrity probe against this solve's own RHS;
    ``verify_abft`` adds the ABFT identity (its column sums computed once
    here); ``history_every`` feeds the forecast history sink."""
    colsum = None
    if verify_every > 0 and verify_abft:
        from poisson_tpu_torch.integrity.probe import abft_colsum

        colsum = abft_colsum(ops, rhs)
    body = make_pcg_body(
        ops, delta=delta, weighted_norm=weighted_norm, h1=h1, h2=h2,
        stagnation_window=stagnation_window, stream_every=stream_every,
        verify_every=verify_every, verify_tol=verify_tol,
        verify_rhs=(rhs if verify_every > 0 else None),
        verify_colsum=colsum, preconditioner=preconditioner,
        history_every=history_every)
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
        sqnorm = lambda u: sum_products(u[..., 1:-1, 1:-1],
                                        u[..., 1:-1, 1:-1])
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
            torch.mul, u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1]) * weak(
                h1 * h2, u.dtype)
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
        def sqnorm(u):
            v = (u * sc)[..., 1:-1, 1:-1]
            return sum_products(v, v)
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
    from poisson_tpu_torch.geometry.canvas import scaled_operands

    out = scaled_operands(*build_fields(problem, dtype=np.float64),
                          problem, scaled)
    for arr in out:
        arr.flags.writeable = False
    return out


STATE_DTYPES = ("bfloat16", "float32", "float64")


def resolve_dtype(dtype) -> str:
    """The state precision's name. ``None`` is float64: unlike JAX without
    x64, PyTorch always has it, and fp64 Jacobi is the oracle mode.
    ``bfloat16`` runs the scaled system on the plain paths, as in the JAX
    package; the kernel backends take fp32 only."""
    if dtype is None:
        return "float64"
    if isinstance(dtype, torch.dtype):
        name = str(dtype).removeprefix("torch.")
    elif str(dtype) == "bfloat16":
        name = "bfloat16"      # numpy alone has no bfloat16
    else:
        name = np.dtype(dtype).name
    if name not in STATE_DTYPES:
        raise ValueError(f"dtype must be bfloat16, float32 or float64, got "
                         f"{dtype!r}")
    return name


def resolve_scaled(scaled, dtype_name: str) -> bool:
    """Default precision policy: sub-64-bit state uses the symmetrically
    scaled system; fp64 runs the reference's literal Jacobi-PCG."""
    if scaled is None:
        return dtype_name != "float64"
    return bool(scaled)


def resolve_verify_tol(verify_tol, dtype_name: str) -> float:
    """The probe's relative drift tolerance: the caller's, else the
    dtype-aware default (``integrity.probe.default_verify_tol``)."""
    if verify_tol is not None:
        return float(verify_tol)
    from poisson_tpu_torch.integrity.probe import default_verify_tol

    return default_verify_tol(dtype_name)


class SolveSetup(NamedTuple):
    """The plain solve's operands on one device, how often its loop reads
    ``done`` (``mg.preconditioner`` reads it every iteration), and the
    preconditioner its ``apply_Dinv`` applies (it picks the integrity
    probe's guard ratios)."""

    ops: PCGOps
    rhs: torch.Tensor
    aux: torch.Tensor   # D (unscaled) or D^{-1/2} (scaled), zero ring
    dtype_name: str
    scaled: bool
    check_every: int = CHECK_EVERY
    preconditioner: str = "jacobi"


def solve_fields(problem: Problem, dtype_name: str, scaled: bool, device,
                 geometry=None):
    """(a, b, rhs, aux) on ``device`` in ``dtype_name``: the host fp64
    setup of the reference ellipse cast once, or, with ``geometry``, the
    fingerprint-cached canvases of ``geometry.canvas`` (same shapes, same
    contract). The one setup seam of every plain solve, as the JAX
    package's ``solve_setup``.

    The ellipse's four copies up are one host range ``stage.fields_in``
    while a profiler runs, and are counted once a call on
    ``pcg.setup.fields_in`` and ``pcg.setup.fields_in_bytes`` (the bytes
    copied up); a geometry's canvases are counted by ``geom.cache.*``."""
    if geometry is not None:
        from poisson_tpu_torch.geometry.canvas import geometry_setup

        return geometry_setup(problem, geometry, dtype_name, scaled, device)
    tdtype = getattr(torch, dtype_name)
    with region("stage.fields_in"):
        fields = tuple(torch.tensor(x, dtype=tdtype, device=device)
                       for x in host_fields64(problem, scaled))
    obs.inc("pcg.setup.fields_in")
    obs.inc("pcg.setup.fields_in_bytes",
            sum(t.numel() * t.element_size() for t in fields))
    return fields


def setup_from_fields(problem: Problem, a, b, rhs, aux, dtype_name: str,
                      scaled: bool, members: bool = False) -> SolveSetup:
    """The plain bundle over explicit fields (with ``members``, the batched
    one; the fields may then be (B, M+1, N+1) stacks, one per member)."""
    ops = (scaled_single_device_ops(problem, a, b, aux, members)
           if scaled else single_device_ops(problem, a, b, aux, members))
    return SolveSetup(ops, rhs, aux, dtype_name, scaled)


def solve_setup(problem: Problem, dtype=None, scaled=None,
                device=None, members: bool = False,
                geometry=None) -> SolveSetup:
    """Host fp64 setup cast once to the state precision on ``device``
    (default ``cuda``; raises without a card), and the backend bundle
    (with ``members``, the batched one). ``geometry`` (a
    ``poisson_tpu_torch.geometry`` spec) swaps the reference ellipse's
    fields for the spec's canvases."""
    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    fields = solve_fields(problem, dtype_name, use_scaled, dev, geometry)
    return setup_from_fields(problem, *fields, dtype_name, use_scaled,
                             members)


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
              preconditioner: str = "jacobi", mg_config=None,
              stream_every: int = 0, verify_every: int = 0,
              verify_tol=None, verify_abft: bool = False,
              geometry=None, history_every: int = 0) -> PCGResult:
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
    MG, whose few iterations are each dear.

    ``stream_every`` > 0 streams (k, ‖Δw‖) to the ``obs.stream`` sink every
    that many iterations. ``verify_every`` > 0 arms the in-loop integrity
    probe (``poisson_tpu_torch.integrity``; see
    :func:`make_pcg_member_body`): a detected corruption stops the solve
    with FLAG_INTEGRITY. ``verify_tol`` defaults by dtype;
    ``verify_abft`` adds the checksum-row identity (Jacobi only, as in the
    JAX package). At 0 each is off and the loop is the plain one.

    ``geometry`` (a ``poisson_tpu_torch.geometry`` spec, a dict or its
    JSON) solves that domain instead of the reference ellipse: same grid,
    same loop, only the canvases change (fingerprint-cached,
    ``geom.cache.*``); it composes with every option above. The default
    spec is the no-geometry solve bit for bit.

    ``history_every`` > 0 ships (k, ‖Δw‖) to the forecast history sink
    (``obs.forecast``) every that many iterations, staged on the device
    and copied to the host at the loop's reads of ``done``; counts and
    iterates are those of ``history_every=0``. The Jacobi path only, as in
    the JAX package."""
    from poisson_tpu_torch.mg.hierarchy import mg_config_for

    history_every = int(history_every)
    config = mg_config_for(problem, preconditioner, mg_config)
    if config is None:
        setup = solve_setup(problem, dtype, scaled, device,
                            geometry=geometry)
    else:
        from poisson_tpu_torch.mg.preconditioner import mg_solve_setup

        if verify_abft:
            raise ValueError(
                "verify_abft is wired for the jacobi path only; drop it "
                "or use preconditioner='jacobi'")
        if history_every > 0:
            raise ValueError(
                "history_every is wired for the jacobi path only; drop "
                "it or use preconditioner='jacobi'")
        setup = mg_solve_setup(problem, dtype, scaled, device, config=config,
                               geometry=geometry)
        obs.inc("mg.solves")
    verify_every = int(verify_every)
    tol = (resolve_verify_tol(verify_tol, setup.dtype_name)
           if verify_every > 0 else 0.0)
    rhs = setup.rhs if rhs_gate is None else gate_rhs(setup.rhs, rhs_gate)
    return run_setup(problem, setup, rhs, check_every=check_every,
                     stream_every=int(stream_every),
                     verify_every=verify_every, verify_tol=tol,
                     verify_abft=bool(verify_abft and verify_every > 0),
                     history_every=history_every)


def run_setup(problem: Problem, setup: SolveSetup, rhs,
              check_every: Optional[int] = None, **loop) -> PCGResult:
    """The plain solve of ``rhs`` (the setup's system: b̃ when scaled) on
    ``setup``'s bundle, the iterate mapped back to w. ``loop`` passes the
    probe and stream options on to :func:`pcg_loop`."""
    s = pcg_loop(setup.ops, rhs, delta=problem.delta,
                 max_iter=problem.iteration_cap,
                 weighted_norm=problem.weighted_norm,
                 h1=problem.h1, h2=problem.h2,
                 check_every=(setup.check_every if check_every is None
                              else check_every),
                 preconditioner=setup.preconditioner, **loop)
    w = s.w * setup.aux if setup.scaled else s.w
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr,
                     flag=s.flag)
