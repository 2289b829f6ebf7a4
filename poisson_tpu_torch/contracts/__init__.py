"""The port's program-contract gate (the counterpart of the JAX package's
``poisson_tpu/contracts``).

Three layers, one gate (``python -m poisson_tpu_torch.contracts``):

- :mod:`~poisson_tpu_torch.contracts.lint` — the source lint (stdlib
  ``ast``): host reads and value branches in step bodies, mutable
  defaults, wall clocks and unseeded RNG in solver code, undocumented
  counters, undeclared flight kinds, unregistered chaos scenarios,
  fingerprints in cohort keys; inline suppression needs a reason.
- :mod:`~poisson_tpu_torch.contracts.trace` +
  :mod:`~poisson_tpu_torch.contracts.manifest` — the program ledger: the
  aten op trace of every flag-off program, canonicalized and
  fingerprinted, with structural markers, and the fingerprint of every
  CUDA source with its build command and launch configuration, checked
  against the committed ``ledger.json``.
- :mod:`~poisson_tpu_torch.contracts.drift` — registry drift: the
  bench's ``detail`` keys join the regress cohort key or are declared
  attribution-only; every ``ServicePolicy``/``FleetPolicy`` field has a
  chaos drill or a written exemption.
"""

from poisson_tpu_torch.contracts.lint import Finding, lint_source, run_lint
from poisson_tpu_torch.contracts.trace import (
    CALLBACK_MARKERS,
    COLLECTIVE_MARKERS,
    MG_MARKERS,
    find_forbidden,
    record,
    trace_fingerprint,
)

__all__ = [
    "CALLBACK_MARKERS",
    "COLLECTIVE_MARKERS",
    "MG_MARKERS",
    "Finding",
    "find_forbidden",
    "lint_source",
    "record",
    "run_lint",
    "trace_fingerprint",
]
