"""Session-step solvers: warm-started and implicit-Euler-shifted solves
(counterpart of ``poisson_tpu/solvers/session.py``).

A session is an ordered stream of dependent solves on slowly varying
canvases: heat-equation time stepping, or a shape-design gradient loop.
Consecutive operators are near each other, so each step restarts CG from
the previous step's iterate (``solvers.pcg.restart_state``, the recovery
driver's primitive) instead of from zero.

In order of precedence:

- **The cold path is the plain solve.** A step without a usable warm
  iterate calls the port's ``pcg_solve`` itself (the JAX package pins its
  counterpart to the same executable).
- **Warm starts are gated and fall back audibly.** A warm iterate is used
  only when the geometry drift between its operator and this step's is
  bounded (:func:`warm_drift`: equal fingerprints, or closed-form ellipses
  within ``drift_bound`` per parameter) and one stencil application shows
  its residual finite and within ``residual_factor`` of the RHS scale. A
  rejected warm start counts ``session.warm.fallbacks``, emits a
  ``session.warm.fallback`` event with its reason and runs cold.

The implicit-Euler heat step solves ``(A + m·I) u⁺ = B + m·uⁿ`` on the
interior, ``m = 1/Δt``. The mass shift cannot ride the edge coefficients,
so the shifted step has its own ops (:func:`_shifted_ops`): matvec
``A·w + m·w`` on the interior, Jacobi diagonal ``D + m`` and, scaled,
``(D + m)^{-1/2}``, built on the host in fp64 (:func:`shifted_setup`).

Counters are the JAX package's: ``session.steps``,
``session.warm.{hits,fallbacks}``, ``session.setup.{hits,misses}``,
``session.design.steps``.
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry.dsl import Ellipse, fingerprint_of
from poisson_tpu_torch.models.fictitious_domain import build_fields
from poisson_tpu_torch.ops.stencil import (
    apply_A,
    diag_D,
    interior,
    pad_interior,
)
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGResult,
    drive,
    gate_rhs,
    init_state,
    make_pcg_body,
    pcg_solve,
    resolve_dtype,
    resolve_scaled,
    restart_state,
    scaled_single_device_ops,
    single_device_ops,
    solve_fields,
)
from poisson_tpu_torch.utils.platform import resolve_device

# Warm-validity defaults (the JAX package's): geometry drift beyond this
# bound means the warm iterate solved a meaningfully different operator.
DEFAULT_DRIFT_BOUND = 0.05
# The warm guess's true residual must be finite and within this factor of
# the RHS scale (NaN-poisoned iterates, grid mismatches).
DEFAULT_RESIDUAL_FACTOR = 100.0


# -- warm-start validity -------------------------------------------------

def warm_drift(prev_spec, spec):
    """Geometry drift between the operator a warm iterate solved and this
    step's: a non-negative float, or ``None`` when the pair is
    incomparable (different families, sampled specs), which is invalid.
    Equal fingerprints (None/None included) are drift 0.0; two closed-form
    ellipses compare per parameter (max |Δcx|, |Δcy|, |Δrx|, |Δry|)."""
    if fingerprint_of(prev_spec) == fingerprint_of(spec):
        return 0.0
    if isinstance(prev_spec, Ellipse) and isinstance(spec, Ellipse):
        return max(
            abs(float(spec.cx) - float(prev_spec.cx)),
            abs(float(spec.cy) - float(prev_spec.cy)),
            abs(float(spec.rx) - float(prev_spec.rx)),
            abs(float(spec.ry) - float(prev_spec.ry)),
        )
    return None


def warm_validity(prev_spec, spec,
                  drift_bound: float = DEFAULT_DRIFT_BOUND):
    """(valid, reason) for the geometry half of the warm gate: ``""``,
    ``"family"`` (incomparable specs) or ``"drift"`` (over the bound)."""
    d = warm_drift(prev_spec, spec)
    if d is None:
        return False, "family"
    if d > float(drift_bound):
        return False, "drift"
    return True, ""


def _residual_norms(problem: Problem, scaled: bool, a, b, rhs, aux, w0, m):
    """(‖B − (A + m·I)w₀‖, ‖B‖) in the solve's system (the w-space residual
    maps into the scaled one by one multiply with aux)."""
    Aw = apply_A(w0, a, b, problem.h1, problem.h2)
    Aw = Aw + m * pad_interior(interior(w0))
    r0 = rhs - (Aw * aux if scaled else Aw)
    return torch.sqrt(torch.sum(r0 * r0)), torch.sqrt(torch.sum(rhs * rhs))


def _residual_ok(problem: Problem, a, b, rhs, aux, scaled: bool, w0,
                 mass_shift: float,
                 factor: float = DEFAULT_RESIDUAL_FACTOR) -> bool:
    """Residual sanity on a warm guess ``w0`` (w-space) against ``rhs`` in
    the solve's system: one stencil application, two scalars to the
    host."""
    m = torch.tensor(float(mass_shift), dtype=rhs.dtype, device=rhs.device)
    r0, bnorm = _residual_norms(problem, bool(scaled), a, b, rhs, aux, w0, m)
    r0n, bn = float(r0), float(bnorm)
    return bool(np.isfinite(r0n) and r0n <= float(factor) * max(bn, 1e-300))


def _y_start(w0, aux, scaled: bool):
    """A w-space guess in the solve's variable: y = w/aux where aux > 0
    (aux is D^{-1/2} with a zero ring, which maps to 0), else w itself."""
    if not scaled:
        return w0
    pos = aux > 0
    return torch.where(pos, w0 / torch.where(pos, aux, 1.0), 0.0)


def _run(problem: Problem, ops, state, scaled: bool, aux) -> PCGResult:
    """The plain body from ``state`` to convergence or the cap."""
    body = make_pcg_body(ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm,
                         h1=problem.h1, h2=problem.h2)
    s = drive(body, state, problem.iteration_cap, CHECK_EVERY)
    w = s.w * aux if scaled else s.w
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr,
                     flag=s.flag)


def _solve_warm(problem: Problem, scaled: bool, a, b, rhs, aux,
                w0) -> PCGResult:
    """The plain body restarted from the w-space iterate ``w0``."""
    ops = (scaled_single_device_ops(problem, a, b, aux) if scaled
           else single_device_ops(problem, a, b, aux))
    return _run(problem, ops, restart_state(ops, rhs,
                                            _y_start(w0, aux, scaled)),
                scaled, aux)


def _shifted_ops(problem: Problem, a, b, aux, m, scaled: bool):
    """PCGOps for the implicit-Euler operator ``A + m·I`` (interior). The
    shift is added to the matvec explicitly; ``aux`` must already embed
    the shifted diagonal, ``D + m`` or ``(D + m)^{-1/2}``
    (:func:`shifted_setup`)."""
    h1, h2 = problem.h1, problem.h2
    if not scaled:
        base = single_device_ops(problem, a, b, aux)
        return base._replace(
            apply_A=lambda p: (apply_A(p, a, b, h1, h2)
                               + m * pad_interior(interior(p))))
    base = scaled_single_device_ops(problem, a, b, aux)

    def apply_shifted(p):
        w = p * aux
        return (apply_A(w, a, b, h1, h2)
                + m * pad_interior(interior(w))) * aux

    return base._replace(apply_A=apply_shifted)


def _solve_shifted(problem: Problem, scaled: bool, warm: bool, a, b, rhs0,
                   aux, m, u_prev, w0) -> PCGResult:
    """One implicit-Euler step ``(A + m·I) u⁺ = B + m·uⁿ``: ``rhs0`` is the
    unscaled forcing B, ``u_prev`` is uⁿ (w-space), ``warm`` selects a
    restart from ``w0`` over the zero start."""
    rhs = rhs0 + m * pad_interior(interior(u_prev))
    if scaled:
        rhs = rhs * aux
    ops = _shifted_ops(problem, a, b, aux, m, scaled)
    state = (restart_state(ops, rhs, _y_start(w0, aux, scaled)) if warm
             else init_state(ops, rhs))
    return _run(problem, ops, state, scaled, aux)


# -- shifted-operator setup cache ---------------------------------------

# Keyed like the canvas cache plus the mass shift and device: a session's
# heat steps share one setup.
_SHIFT_CACHE: dict = {}
_SHIFT_CACHE_CAP = 32


def reset_session_cache() -> None:
    """Drop the shifted-setup cache."""
    _SHIFT_CACHE.clear()


def shifted_setup(problem: Problem, geometry, dtype_name: str,
                  scaled: bool, mass_shift: float, device=None):
    """(a, b, rhs0, aux) on ``device`` (default ``cuda``) for ``A + m·I``.
    ``rhs0`` is the unscaled forcing B (the transient term changes every
    step, so the scaled b̃ is formed per step); ``aux`` embeds the shifted
    diagonal, ``D + m`` or ``(D + m)^{-1/2}``, derived on the host in
    fp64. Counts ``session.setup.hits``/``misses``."""
    dev = resolve_device(device)
    m = float(mass_shift)
    key = (problem, fingerprint_of(geometry), dtype_name, bool(scaled), m,
           str(dev))
    hit = _SHIFT_CACHE.get(key)
    if hit is not None:
        obs.inc("session.setup.hits")
        return hit
    obs.inc("session.setup.misses")
    if geometry is None:
        a64, b64, rhs64 = build_fields(problem, dtype=np.float64)
    else:
        from poisson_tpu_torch.geometry.canvas import build_geometry_fields

        a64, b64, rhs64 = build_geometry_fields(problem, geometry)
    dm = diag_D(a64, b64, problem.h1, problem.h2) + m
    aux64 = np.pad(1.0 / np.sqrt(dm), 1) if scaled else np.pad(dm, 1)
    tdtype = getattr(torch, dtype_name)
    out = tuple(torch.tensor(x, dtype=tdtype, device=dev)
                for x in (a64, b64, rhs64, aux64))
    if len(_SHIFT_CACHE) >= _SHIFT_CACHE_CAP:
        _SHIFT_CACHE.pop(next(iter(_SHIFT_CACHE)))
    _SHIFT_CACHE[key] = out
    return out


# -- the session step entry point ---------------------------------------

def session_step_solve(problem: Problem, dtype=None, scaled=None,
                       geometry=None, warm=None, warm_geometry=None,
                       mass_shift: float = 0.0, u_prev=None,
                       rhs_gate=None,
                       drift_bound: float = DEFAULT_DRIFT_BOUND,
                       residual_factor: float = DEFAULT_RESIDUAL_FACTOR,
                       device=None):
    """One session step on ``device`` (default ``cuda``). Returns
    ``(PCGResult, {"warm_used": bool, "fallback": reason})``.

    ``mass_shift == 0`` is a Poisson step of the (possibly moved) domain:
    with a valid ``warm`` iterate (the previous step's w-space grid, which
    solved ``warm_geometry``) it restarts from it, otherwise it calls
    ``pcg_solve``. ``mass_shift = 1/Δt > 0`` is one implicit-Euler heat
    step with transient RHS ``B + m·uⁿ`` (``u_prev``; zero when omitted).
    An offered warm start that is rejected runs cold and counts
    ``session.warm.fallbacks``; a used one counts ``session.warm.hits``."""
    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    m = float(mass_shift)
    if m < 0.0:
        raise ValueError(f"mass_shift must be >= 0, got {m} "
                         "(it is 1/dt of an implicit-Euler step)")
    obs.inc("session.steps")

    def _gate(a, b, rhs, aux):
        """(warm_ok, w0, reason) against the built canvases."""
        if warm is None:
            return False, None, "none"
        ok, reason = warm_validity(warm_geometry, geometry, drift_bound)
        if not ok:
            return False, None, reason
        w0 = torch.as_tensor(warm, dtype=rhs.dtype).to(rhs.device)
        if w0.shape != rhs.shape:
            return False, None, "shape"
        if not _residual_ok(problem, a, b, rhs, aux, use_scaled, w0, m,
                            residual_factor):
            return False, None, "residual"
        return True, w0, ""

    def _audit(used: bool, reason: str) -> dict:
        if used:
            obs.inc("session.warm.hits")
        elif warm is not None:
            # An offered warm start was rejected: audible. (warm=None is a
            # deliberate cold step, not a fallback.)
            obs.inc("session.warm.fallbacks")
            obs.event("session.warm.fallback", reason=reason,
                      geometry=fingerprint_of(geometry),
                      warm_geometry=fingerprint_of(warm_geometry))
        return {"warm_used": used, "fallback": "" if used else reason}

    if m != 0.0:
        a, b, rhs0, aux = shifted_setup(problem, geometry, dtype_name,
                                        use_scaled, m, dev)
        if rhs_gate is not None:
            rhs0 = gate_rhs(rhs0, rhs_gate)
        up = (torch.zeros_like(rhs0) if u_prev is None
              else torch.as_tensor(u_prev, dtype=rhs0.dtype).to(dev))
        md = torch.tensor(m, dtype=rhs0.dtype, device=dev)
        # Gate against the true transient RHS in the solve's system.
        rhs_step = rhs0 + md * pad_interior(interior(up))
        if use_scaled:
            rhs_step = rhs_step * aux
        used, w0, reason = _gate(a, b, rhs_step, aux)
        result = _solve_shifted(problem, use_scaled, used, a, b, rhs0, aux,
                                md, up, w0 if used else None)
        return result, _audit(used, reason)

    a, b, rhs, aux = solve_fields(problem, dtype_name, use_scaled, dev,
                                  geometry)
    if rhs_gate is not None:
        rhs = gate_rhs(rhs, rhs_gate)
    used, w0, reason = _gate(a, b, rhs, aux)
    if used:
        result = _solve_warm(problem, use_scaled, a, b, rhs, aux, w0)
        return result, _audit(True, "")
    # The cold path: the plain entry point itself.
    result = pcg_solve(problem, dtype=dtype_name, scaled=use_scaled,
                       rhs_gate=rhs_gate, geometry=geometry, device=dev)
    return result, _audit(False, reason)


def design_step(problem: Problem, params, target, lr: float, dtype=None,
                scaled=None, device=None):
    """One gradient-descent step of a shape-design loop. ``params`` is a
    dict of ``cx, cy, rx, ry`` (an ellipse), ``target`` the solution grid
    to match; the loss is the mean squared interior mismatch. Returns
    ``(new_params, loss, grads)`` as floats, from one forward and one
    adjoint solve (``solvers.adjoint.shape_gradient``); counts
    ``session.design.steps``."""
    from poisson_tpu_torch.solvers.adjoint import shape_gradient

    dev = resolve_device(device)
    tgt = torch.as_tensor(target, dtype=getattr(torch, resolve_dtype(dtype))
                          ).to(dev)

    def spec_fn(p):
        return Ellipse(cx=p["cx"], cy=p["cy"], rx=p["rx"], ry=p["ry"])

    def loss_fn(w):
        d = interior(w) - interior(tgt)
        return torch.mean(d * d)

    loss, grads = shape_gradient(problem, spec_fn, params, loss_fn,
                                 dtype=dtype, scaled=scaled, device=dev)
    new_params = {k: float(params[k]) - float(lr) * float(grads[k])
                  for k in params}
    obs.inc("session.design.steps")
    return new_params, float(loss), {k: float(v) for k, v in grads.items()}
