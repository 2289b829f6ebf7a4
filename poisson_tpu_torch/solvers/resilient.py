"""Self-healing single-device solve: divergence recovery with precision
escalation and verified restarts (counterpart of
``poisson_tpu/solvers/resilient.py``).

The solve runs in chunks (the chunk seam of ``solvers.checkpoint``), and
after every chunk the host reads the termination verdict:

- **converged** — done; the checkpoint (if any) is cleaned up;
- **non-finite / breakdown / stagnation** — the Krylov history went bad,
  so CG restarts from the last good iterate (``solvers.pcg.restart_state``:
  ``w`` kept, r/z/p/ζ re-derived);
- **repeated failure at one precision** — the state moves one rung up the
  bf16 → f32 → f64 ladder and restarts there (the setup, the MG hierarchy
  included, is rebuilt at the new dtype on the same device);
- **integrity** (``verify_every`` > 0, ``poisson_tpu_torch.integrity``) —
  a flipped bit is a hardware event, not a precision problem: the solve
  restarts from the last *verified* iterate without escalating, and a
  detection the host recheck cannot reproduce is a counted false alarm
  that resumes from the state that fired;
- **budget exhausted** — :class:`DivergenceError` with diagnostics.

Faults are injected between chunks through the ``on_chunk`` hook
(``testing.faults``). The warnings' texts, the diagnostics and the
counters (``resilient.*``, ``integrity.*``) are the JAX package's.

The ladder is the JAX package's, ``bfloat16`` rung included: a bf16 solve
runs the scaled system in bf16 and climbs to fp32, then fp64.
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.integrity import probe
from poisson_tpu_torch.solvers.checkpoint import (
    _chunked,
    _fingerprint,
    load_state_any,
    remove_generations,
    save_state,
)
from poisson_tpu_torch.solvers.pcg import (
    FLAG_CONVERGED,
    FLAG_DEADLINE,
    FLAG_INTEGRITY,
    FLAG_NAMES,
    FLAG_NONE,
    FLAG_NONFINITE,
    PCGResult,
    PCGState,
    iterations_scalar,
    resolve_dtype,
    resolve_scaled,
    resolve_verify_tol,
    restart_state,
)

# Escalation ladder, low to high (the JAX package's). A resilient solve
# enters at its requested dtype and only ever moves up.
_LADDER = ("bfloat16", "float32", "float64")


class DivergenceError(RuntimeError):
    """The solve kept failing after every recovery the policy allows.
    ``diagnostics`` records the restart and escalation history."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    """What the resilient driver may do about a failing solve.

    max_restarts: recovery attempts (restarts + escalations) before
        DivergenceError.
    escalate: move up the precision ladder after a repeated failure at
        the same precision.
    stagnation_window: iterations without a new best ‖Δw‖ before the loop
        stops with FLAG_STAGNATED (0 disables).
    """

    max_restarts: int = 3
    escalate: bool = True
    stagnation_window: int = 200


def _rungs_above(dtype_name: str) -> list:
    """Ladder rungs strictly above ``dtype_name`` (PyTorch always has
    fp64, so no rung is skipped)."""
    if dtype_name not in _LADDER:
        return []
    return list(_LADDER[_LADDER.index(dtype_name) + 1:])


def _load_any_rung(path: str, problem: Problem, dtype_name: str,
                   scaled: bool, keep_last: int,
                   preconditioner: str = "jacobi", mg_config=None):
    """Resume across an earlier run's escalation: the newest loadable
    generation whose fingerprint is the requested precision's or any
    higher rung's (generations outermost, rungs innermost). Returns
    ``(state or None, dtype_name)``."""
    rungs = [dtype_name] + _rungs_above(dtype_name)
    found = load_state_any(
        path,
        [_fingerprint(problem, dn, scaled, preconditioner, mg_config)
         for dn in rungs],
        keep_last)
    if found is None:
        return None, dtype_name
    state, index = found
    return state, rungs[index]


def pcg_solve_resilient(problem: Problem, dtype=None, scaled=None,
                        chunk: int = 100,
                        policy: Optional[RecoveryPolicy] = None,
                        checkpoint_path: Optional[str] = None,
                        keep_last: int = 2,
                        keep_checkpoint: bool = False,
                        stream_every: int = 0,
                        watchdog=None,
                        on_chunk=None,
                        deadline=None,
                        verify_every: int = 0,
                        verify_tol=None,
                        preconditioner: str = "jacobi",
                        mg_config=None, device=None) -> PCGResult:
    """Single-device solve that survives NaN blow-ups, breakdowns and
    stagnation by restarting from the last good iterate, escalating
    precision when a restart alone does not help, and (``verify_every`` >
    0) silent corruption by restarting from the last verified iterate.

    Converging solves run the same iterations as ``pcg_solve``. With
    ``checkpoint_path`` the state is persisted every ``chunk`` iterations
    (and resumed, even from a file written at an escalated rung by an
    earlier run). ``watchdog``/``on_chunk`` are the chunk-boundary hooks
    of ``solvers.checkpoint.run_chunked``; ``deadline``
    (``expired() -> bool``) stops before a chunk or a restart once it has
    expired, and the partial iterate returns with FLAG_DEADLINE. The
    result carries ``restarts`` and ``recovery_history``. The solve runs
    on ``device`` (default ``cuda``)."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    policy = policy or RecoveryPolicy()
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)

    if checkpoint_path:
        saved, dtype_name = _load_any_rung(
            checkpoint_path, problem, dtype_name, use_scaled, keep_last,
            preconditioner, mg_config)
    else:
        saved = None

    verify_every = int(verify_every)
    v_tol = (resolve_verify_tol(verify_tol, dtype_name)
             if verify_every > 0 else 0.0)
    # One rung's (setup, advance, init), through the chunk seam, so that
    # an MG rung rebuilds its hierarchy at the new dtype like every other
    # operand.
    build = lambda dn: _chunked(
        problem, chunk, dn, use_scaled, device, None,
        policy.stagnation_window, preconditioner, mg_config, stream_every,
        verify_every, verify_tol)
    setup, advance, init = build(dtype_name)
    if setup.preconditioner != "jacobi":
        obs.inc("mg.solves")   # entry only: a rebuild is the same solve
    ops, rhs = setup.ops, setup.rhs
    dev = rhs.device
    state = (init() if saved is None
             else PCGState(*(v.to(dev) for v in saved)))

    cap = problem.iteration_cap
    restarts = 0
    restarts_at_dtype = 0
    history = []            # (iteration, verdict, action)
    last_good = (state.w, int(state.k))
    # The verified-good snapshot: the newest chunk-boundary iterate whose
    # drift passed the recheck (the entry state is verified by
    # construction). The integrity recovery restarts from here.
    last_verified = (state.w, int(state.k))
    fp = _fingerprint(problem, dtype_name, use_scaled, preconditioner,
                      mg_config)
    chunks_done = 0

    def diagnostics(flag: int) -> dict:
        return {
            "problem": f"{problem.M}x{problem.N}",
            "verdict": FLAG_NAMES.get(flag, str(flag)),
            "iteration": iterations_scalar(state.k),
            "dtype": dtype_name,
            "restarts": restarts,
            "history": list(history),
            "diff": float(torch.max(state.diff)),
            "residual_dot": float(torch.max(state.zr)),
        }

    def restarted(w_src, k_src: int) -> PCGState:
        w_good = w_src.to(dtype=getattr(torch, dtype_name), device=dev)
        return restart_state(ops, rhs, w_good)._replace(
            k=torch.tensor(k_src, dtype=torch.int32, device=dev))

    deadline_hit = False
    if watchdog is not None:
        watchdog.start()
    try:
        while True:
            if deadline is not None and deadline.expired():
                # Checked before a chunk OR a recovery starts.
                deadline_hit = True
                obs.inc("resilient.deadline_stops")
                obs.event("resilient.deadline_stop", iteration=int(state.k),
                          restarts=restarts, chunks=chunks_done)
                break
            state = advance(state)
            chunks_done += 1
            if watchdog is not None:
                watchdog.beat(k=int(state.k), diff=float(state.diff),
                              dtype=dtype_name, restarts=restarts)
            flag = int(state.flag)

            if flag == FLAG_CONVERGED:
                break
            if flag == FLAG_NONE:
                # A NaN confined to w never enters a reduction: check the
                # would-be snapshot on the device (one scalar crosses).
                if not bool(torch.isfinite(state.w).all()):
                    flag = FLAG_NONFINITE
            if flag == FLAG_NONE and verify_every > 0:
                # Boundary verification: a flip in the chunk's tail could
                # slip past the stride into the snapshot.
                obs.inc("integrity.checks")
                drifted, _ = probe.recheck_state(ops, state.w, state.r, rhs,
                                                 v_tol)
                if drifted:
                    flag = FLAG_INTEGRITY
                else:
                    last_verified = (state.w, int(state.k))
            if flag == FLAG_NONE:
                # Healthy boundary: snapshot, persist, inject. The body
                # never writes a state in place, so holding the reference
                # is the snapshot.
                last_good = (state.w, int(state.k))
                if checkpoint_path:
                    save_state(checkpoint_path, state, fp,
                               keep_last=keep_last)
                if on_chunk is not None:
                    replacement = on_chunk(state, chunks_done)
                    if replacement is not None:
                        state = replacement
                if int(state.k) >= cap:
                    break  # budget exhausted, unconverged: like pcg_solve
                continue

            if flag == FLAG_INTEGRITY:
                obs.inc("integrity.detections")
                drifted, drift_rel = probe.recheck_state(
                    ops, state.w, state.r, rhs, v_tol)
                # The update-norm verdicts stop with a consistent
                # recurrence, so a clean drift recheck does not clear
                # them: the body froze the pre-flip best, so a genuine
                # verdict carries best well above the collapsed ‖Δw‖
                # (any clean state has best ≤ diff). isfinite guards the
                # first probed step after an init or restart.
                best = float(state.best)
                jump_stop = (math.isfinite(best)
                             and best > probe.default_verify_collapse(
                                 preconditioner or "jacobi") / 2
                             * float(state.diff))
                if not drifted and not jump_stop:
                    obs.inc("integrity.false_alarms")
                    obs.event("integrity.false_alarm",
                              iteration=int(state.k), drift=drift_rel)
                    warnings.warn(
                        f"integrity probe fired at iteration "
                        f"{int(state.k)} but the recheck measures drift "
                        f"{drift_rel:.2e} under tolerance {v_tol:.2e}; "
                        f"resuming without a restart",
                        RuntimeWarning, stacklevel=2,
                    )
                    state = state._replace(
                        done=torch.zeros_like(state.done),
                        flag=torch.full_like(state.flag, FLAG_NONE))
                    continue
                restarts += 1
                if restarts > policy.max_restarts:
                    raise DivergenceError(
                        f"solve kept failing integrity verification "
                        f"(detection at iteration "
                        f"{iterations_scalar(state.k)}, dtype "
                        f"{dtype_name}) and the recovery budget "
                        f"({policy.max_restarts} restarts) is exhausted "
                        f"— the device is likely producing silent data "
                        f"corruption",
                        diagnostics=diagnostics(flag),
                    )
                w_src, k_src = last_verified
                history.append((int(state.k), "integrity",
                                f"verified-restart@{k_src}"))
                obs.inc("resilient.restarts")
                obs.inc("integrity.verified_restarts")
                obs.event("integrity.verified_restart",
                          iteration=int(state.k), from_iteration=k_src,
                          drift=drift_rel, restart=restarts)
                warnings.warn(
                    f"integrity check failed at iteration "
                    f"{int(state.k)} (relative drift {drift_rel:.2e}); "
                    f"restarting from the last verified iterate "
                    f"(iteration {k_src})",
                    RuntimeWarning, stacklevel=2,
                )
                state = restarted(w_src, k_src)
                continue

            # A failure verdict: recover or give up.
            restarts += 1
            restarts_at_dtype += 1
            if restarts > policy.max_restarts:
                raise DivergenceError(
                    f"solve failed ({FLAG_NAMES.get(flag, flag)} at "
                    f"iteration {iterations_scalar(state.k)}, "
                    f"dtype {dtype_name}) and "
                    f"the recovery budget ({policy.max_restarts} restarts) "
                    f"is exhausted",
                    diagnostics=diagnostics(flag),
                )
            escalated = False
            if policy.escalate and restarts_at_dtype > 1:
                rungs = _rungs_above(dtype_name)
                if rungs:
                    dtype_name = rungs[0]
                    if verify_every > 0:
                        # The drift floor moved with the precision.
                        v_tol = resolve_verify_tol(verify_tol, dtype_name)
                    setup, advance, init = build(dtype_name)
                    ops, rhs = setup.ops, setup.rhs
                    fp = _fingerprint(problem, dtype_name, use_scaled,
                                      preconditioner, mg_config)
                    restarts_at_dtype = 0
                    escalated = True
            action = (f"escalate->{dtype_name}" if escalated
                      else f"restart@{dtype_name}")
            history.append((int(state.k), FLAG_NAMES.get(flag, str(flag)),
                            action))
            obs.inc("resilient.restarts")
            if escalated:
                obs.inc("resilient.escalations")
            obs.event("resilient.restart",
                      iteration=int(state.k),
                      verdict=FLAG_NAMES.get(flag, str(flag)),
                      action=action, restart=restarts,
                      from_iteration=last_good[1])
            warnings.warn(
                f"solve {FLAG_NAMES.get(flag, str(flag))} at iteration "
                f"{iterations_scalar(state.k)}; {action} from last good "
                f"iterate (iteration {last_good[1]})",
                RuntimeWarning, stacklevel=2,
            )
            state = restarted(*last_good)
    except KeyboardInterrupt:
        if watchdog is not None:
            watchdog.raise_if_fired()   # timeout → typed SolveTimeout
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()

    if (checkpoint_path and int(state.flag) == FLAG_CONVERGED
            and not keep_checkpoint):
        remove_generations(checkpoint_path, keep_last)

    w = state.w * setup.aux if use_scaled else state.w
    flag_out = state.flag
    if deadline_hit and int(state.flag) != FLAG_CONVERGED:
        # Result only: a persisted state keeps its in-loop verdict.
        flag_out = torch.tensor(FLAG_DEADLINE, dtype=torch.int32)
    return PCGResult(
        w=w, iterations=state.k, diff=state.diff, residual_dot=state.zr,
        flag=flag_out, restarts=restarts, recovery_history=tuple(history))
