"""Numerical integrity: the silent-data-corruption defense (counterpart of
``poisson_tpu/integrity``).

A flipped exponent or mantissa bit in a CG buffer is silent: nothing goes
NaN, the recurrence residual keeps shrinking, and the iterate converges to
the wrong answer. The invariants in :mod:`poisson_tpu_torch.integrity.probe`
detect it:

- the residual drift ``‖(b − Aw) − r‖`` between the true and the
  recurrence residual, which a flip in ``w`` or ``r`` (or a corrupted
  ``Ap`` landing in ``r``) opens;
- the update-norm guards: a convergence that jumped (the previous best
  ‖Δw‖ far above this step's) and a one-step ‖Δw‖ collapse, the two faces
  of a flipped search direction, which keeps the recurrence consistent;
- optionally the checksum-row ABFT identity ``Σ(Ap) = (A·𝟙)ᵀp`` on the
  stencil application.

``verify_every=K`` threads them into the PCG body (``solvers.pcg``,
``solvers.batched``, ``solvers.lanes``): every K iterations and on every
convergence event the drift probe runs, and a corrupt verdict stops the
member with ``FLAG_INTEGRITY``. The resilient driver
(``solvers.resilient``) restarts such a solve from its last verified
iterate, without a precision escalation. ``verify_every=0`` (the default)
adds no operation to the body.

Counters, by the JAX package's names: ``integrity.checks``,
``integrity.detections``, ``integrity.verified_restarts`` and
``integrity.false_alarms``.
"""

from poisson_tpu_torch.integrity.probe import (
    DEFAULT_VERIFY_JUMP,
    IntegrityPolicy,
    abft_colsum,
    abft_drift_exceeds,
    default_verify_tol,
    drift_exceeds,
    recheck_state,
    residual_drift,
)

__all__ = [
    "DEFAULT_VERIFY_JUMP",
    "IntegrityPolicy",
    "abft_colsum",
    "abft_drift_exceeds",
    "default_verify_tol",
    "drift_exceeds",
    "recheck_state",
    "residual_drift",
]
