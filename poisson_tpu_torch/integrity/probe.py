"""The integrity invariants on the port's ``PCGOps`` (counterpart of
``poisson_tpu/integrity/probe.py``).

Each is exact in exact arithmetic and O(ε)-small in clean floating point:

1. **Residual drift** — CG carries ``r`` by recurrence (``r ← r − αAp``);
   after a storage flip in ``w`` or ``r`` the recurrence and the true
   residual ``b − Aw`` part ways. ``‖(b − Aw) − r‖`` measures the gap for
   one extra stencil application.
2. **Update-norm anomalies** — a flip that inflates the search direction
   ``p`` keeps the recurrence consistent but collapses α and ‖Δw‖ by the
   flip's gain. The convergence-jump guard (a collapse that crosses δ) and
   the collapse guard (a one-step drop beyond
   :data:`DEFAULT_VERIFY_COLLAPSE` without converging) see it from scalars
   already in the state.
3. **Checksum-row ABFT** (optional) — ``Σ(Ap) = (A·𝟙)ᵀp`` by symmetry,
   with ``A·𝟙`` computed once outside the loop.

Every check is relative (drift against ``max(‖r‖, ‖b‖, ‖w‖)``), and the
tolerances are the JAX package's, dtype-aware and sized for no false alarm
on the golden solves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

# The convergence-jump guard ratio: a convergence whose previous best
# ‖Δw‖ sat more than this factor above the converging step's own ‖Δw‖ is
# corrupt (clean final ratios are single digits, ~1.4 on the goldens).
DEFAULT_VERIFY_JUMP = 50.0

# The mid-solve collapse guard ratio: a one-step ‖Δw‖ drop by more than
# this factor without a convergence event is a corrupted search direction
# (clean CG one-step drops measure ≤ 2.5×; a silent exponent flip ≥ 11× by
# mid-solve in scaled fp32). Early fp32 flips can land inside CG's own
# range: that regime converges to the right answer, merely slower.
DEFAULT_VERIFY_COLLAPSE = 8.0

# MG-preconditioned CG contracts much faster per iteration (clean one-step
# drops up to 28.6×, convergence-event ratios up to 11.9×, measured by the
# JAX package), so its guard ratios sit a ≥4× margin above those.
DEFAULT_VERIFY_JUMP_MG = 200.0
DEFAULT_VERIFY_COLLAPSE_MG = 128.0


def default_verify_jump(preconditioner: str = "jacobi") -> float:
    """The convergence-jump guard ratio for a preconditioner."""
    return (DEFAULT_VERIFY_JUMP_MG if preconditioner == "mg"
            else DEFAULT_VERIFY_JUMP)


def default_verify_collapse(preconditioner: str = "jacobi") -> float:
    """The mid-solve collapse guard ratio for a preconditioner."""
    return (DEFAULT_VERIFY_COLLAPSE_MG if preconditioner == "mg"
            else DEFAULT_VERIFY_COLLAPSE)


# Relative drift tolerances by state dtype (the JAX package's table).
_VERIFY_TOLS = {
    "float64": 1e-6,
    # fp32 runs the scaled system, where a silent exponent flip is capped
    # near O(1) absolute: flip drift ≥ 2e-4 of the iterate scale, clean
    # floor ≤ ~5e-7 through 300 iterations.
    "float32": 2e-5,
    "bfloat16": 5e-2,
}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def default_verify_tol(dtype_name) -> float:
    """The dtype-aware default relative drift tolerance."""
    return _VERIFY_TOLS.get(_dtype_name(dtype_name), 1e-3)


@dataclasses.dataclass(frozen=True)
class IntegrityPolicy:
    """The numerical-integrity knobs, threaded through the solvers and the
    solve service (``ServicePolicy.integrity``); the JAX package's fields
    and defaults.

    verify_every: in-loop verification stride (0: no probe, the body is
        the unverified one and counts stay bit for bit).
    verify_tol: relative drift tolerance (None: :func:`default_verify_tol`).
    verify_on_suspect: once a dispatch on a (backend, device_kind) cohort
        trips an integrity detection, later dispatches on that cohort run
        with ``suspect_verify_every`` even when ``verify_every`` is 0.
    suspect_verify_every: the stride for suspect cohorts (and for
        integrity-escalated retries through the resilient driver).
    abft: also check the checksum-row ABFT identity at each probe
        (single-device solve paths).
    """

    verify_every: int = 0
    verify_tol: Optional[float] = None
    verify_on_suspect: bool = True
    suspect_verify_every: int = 25
    abft: bool = False


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (a Python float that the dtype holds
    exactly), as the JAX package casts its tolerances."""
    return float(np.asarray(value, dtype=_dtype_name(dtype)))


def _tol_sq(tol: float, dtype: torch.dtype) -> float:
    """``tol · tol`` with the tolerance and the product in ``dtype``."""
    t = np.asarray(tol, dtype=_dtype_name(dtype))
    return float(t * t)


def residual_drift(ops, w, r, rhs):
    """``(drift_sq, scale_sq)``: ``‖(rhs − Aw) − r‖²`` and
    ``max(‖r‖², ‖rhs‖², ‖w‖²)``, per member with a batched bundle. The
    iterate norm belongs in the scale: the clean gap between recurrence
    and true residual is O(k·ε·‖A‖·‖w‖), so a residual-relative scale would
    false-alarm near convergence."""
    true_r = rhs - ops.apply_A(ops.exchange(w))
    drift_sq = ops.sqnorm(true_r - r)
    scale_sq = torch.maximum(torch.maximum(ops.sqnorm(r), ops.sqnorm(rhs)),
                             ops.sqnorm(w))
    return drift_sq, scale_sq


def drift_exceeds(ops, w, r, rhs, tol):
    """True where the drift exceeds ``tol`` relative to the scale. The
    ``tiny`` floor keeps an all-zero member (an empty lane) from 0/0, and a
    non-finite drift or scale is itself a corruption verdict (an overflowed
    buffer would otherwise compare False)."""
    drift_sq, scale_sq = residual_drift(ops, w, r, rhs)
    floor = torch.finfo(drift_sq.dtype).tiny
    exceeded = drift_sq > (_tol_sq(tol, drift_sq.dtype)
                           * torch.clamp(scale_sq, min=floor))
    blown = ~(torch.isfinite(drift_sq) & torch.isfinite(scale_sq))
    return exceeded | blown


def abft_colsum(ops, like):
    """The checksum row ``A·𝟙`` (interior indicator, zero ring), computed
    once outside the loop; ``like`` gives the shape, dtype and device."""
    ones = torch.zeros_like(like)
    ones[..., 1:-1, 1:-1] = 1.0
    return ops.apply_A(ops.exchange(ones))


def abft_drift_exceeds(colsum, p, Ap, tol):
    """True where the stencil application broke ``Σ(Ap) = (A·𝟙)ᵀp``
    beyond ``tol`` relative to ``Σ|colsum·p|``."""
    lhs = torch.sum(Ap, dim=(-2, -1))
    prod = colsum * p
    rhs = torch.sum(prod, dim=(-2, -1))
    scale = torch.sum(torch.abs(prod), dim=(-2, -1))
    floor = torch.finfo(scale.dtype).tiny
    return (torch.abs(lhs - rhs)
            > _in_dtype(tol, scale.dtype) * torch.clamp(scale, min=floor))


def recheck_state(ops, w, r, rhs, tol):
    """Host recheck of a stopped state: ``(confirmed, drift_rel)``, the
    resilient driver's false-alarm classifier. A non-finite ratio is an
    overflowed buffer: confirmed."""
    drift_sq, scale_sq = residual_drift(ops, w, r, rhs)
    floor = torch.finfo(drift_sq.dtype).tiny
    drift_rel = float(torch.sqrt(drift_sq)
                      / torch.sqrt(torch.clamp(scale_sq, min=floor)))
    confirmed = (not math.isfinite(drift_rel)) or drift_rel > float(tol)
    return confirmed, drift_rel
