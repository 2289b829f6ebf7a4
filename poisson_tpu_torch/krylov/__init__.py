"""Krylov memory: block-CG batched mode and fingerprint-keyed recycling
(counterpart of ``poisson_tpu/krylov/__init__.py``).

Two opt-in levers over the shared PCG machinery, each cutting iterations
on traffic the JAX package's users send:

- **block mode** (:mod:`poisson_tpu_torch.krylov.block`,
  ``solve_batched(mode="block")``): the batch's B recurrences become one
  block recurrence over the (n × B) iterate with B×B coefficient solves,
  so every member searches the union of the members' Krylov spaces. A
  rank-deficient block degrades to its effective rank instead of breaking
  down (``PCGResult.deficient``);
- **deflation recycling** (:mod:`poisson_tpu_torch.krylov.recycle`,
  ``solve_recycled``): a converged solve harvests a small deflation basis
  (the solution direction and Ritz vectors of its Lanczos window), cached
  per operator; later solves of the same operator warm-start from the
  Galerkin projection and keep every direction A-orthogonal to the basis.

Both trade golden-count parity for iteration counts, so both are off by
default (``mode="independent"``, ``deflation=False``) and gated by the
manufactured-solution oracle (``geometry.manufactured.manufactured_error(
krylov=…)``).

This module is the policy alone (stdlib only); its messages are the JAX
package's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

KRYLOV_INDEPENDENT = "independent"
KRYLOV_BLOCK = "block"
KRYLOV_MODES = (KRYLOV_INDEPENDENT, KRYLOV_BLOCK)


@dataclasses.dataclass(frozen=True)
class KrylovPolicy:
    """The Krylov-memory knobs a request carries.

    ``mode``: ``"independent"`` (the batched driver's member recurrences)
    or ``"block"`` (the B×B block recurrence). ``deflation`` arms subspace
    recycling for a single solve: ``harvest`` is the Lanczos window (the
    first ``harvest`` normalized residuals of the cold solve), ``keep`` the
    Ritz vectors kept (the basis also carries the converged solution's
    direction), ``budget_bytes`` the basis cache's size (LRU). Block mode
    and deflation do not compose; :func:`resolve_krylov` refuses the pair.
    """

    mode: str = KRYLOV_INDEPENDENT
    deflation: bool = False
    harvest: int = 32
    keep: int = 8
    budget_bytes: int = 256 * 1024 * 1024


DEFAULT_KRYLOV = KrylovPolicy()


def resolve_krylov(policy: Optional[KrylovPolicy]) -> KrylovPolicy:
    """Validate a (possibly None) policy, loudly: an unknown mode or an
    uncomposable combination fails here, never dispatches something else."""
    kp = policy or DEFAULT_KRYLOV
    if kp.mode not in KRYLOV_MODES:
        raise ValueError(
            f"unknown krylov mode {kp.mode!r} — expected one of "
            f"{KRYLOV_MODES}")
    if kp.mode == KRYLOV_BLOCK and kp.deflation:
        raise ValueError(
            "krylov mode='block' does not compose with deflation yet "
            "(the block recurrence has no deflated program); pick one")
    if kp.deflation:
        if kp.keep < 1:
            raise ValueError(f"krylov.keep must be >= 1, got {kp.keep}")
        if kp.harvest < kp.keep:
            raise ValueError(
                f"krylov.harvest ({kp.harvest}) must be >= keep "
                f"({kp.keep}) — the Ritz extraction needs at least as "
                "many snapshots as vectors it keeps")
        if kp.budget_bytes < 1:
            raise ValueError("krylov.budget_bytes must be >= 1")
    return kp
