"""Per-cohort circuit breaker (counterpart of
``poisson_tpu/serve/breaker.py``).

A cohort — one (grid, dtype, backend) combination — that keeps failing
is usually failing for a structural reason: a grid that breaks a kernel,
a precision that diverges on this conditioning, a wedged device behind
one executable shape. Retrying every arriving request into it burns the
queue's capacity on work that will fail; the breaker converts "keeps
failing" into "fail fast, probe occasionally":

- **CLOSED** (healthy): dispatches flow; consecutive failures are
  counted, any success resets the count.
- **OPEN** (tripped, after ``failure_threshold`` consecutive failures):
  every request in the cohort is shed with the typed ``breaker_open``
  reason — cheap, immediate, and honest — for ``cooldown_seconds``.
- **HALF_OPEN** (after cooldown): ``half_open_probes`` real dispatches
  are let through as probes. A probe success closes the breaker; a probe
  failure re-trips it for another cooldown.

State transitions land on ``serve.breaker.{trips,half_opens,closes}``
counters and events, so a trip is visible in the metrics snapshot, not
just in per-request outcomes.
"""

from __future__ import annotations

import time
from typing import Callable

from poisson_tpu_torch import obs
from poisson_tpu_torch.serve.types import BreakerPolicy

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class CircuitBreaker:
    """One breaker instance per cohort (the service keeps a registry).
    Clock-injectable for deterministic chaos scenarios. Single-threaded
    by design — the service's dispatch loop is the only caller."""

    def __init__(self, policy: BreakerPolicy,
                 clock: Callable[[], float] = time.monotonic,
                 cohort: str = ""):
        if policy.failure_threshold < 1:
            raise ValueError("failure_threshold must be >= 1")
        self.policy = policy
        self.cohort = cohort
        self._clock = clock
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probes_left = 0

    @property
    def state(self) -> str:
        """Current state, accounting for cooldown expiry (reading the
        state can move OPEN → HALF_OPEN; it never moves anything else)."""
        if (self._state == OPEN
                and self._clock() - self._opened_at
                >= self.policy.cooldown_seconds):
            self._state = HALF_OPEN
            self._probes_left = self.policy.half_open_probes
            obs.inc("serve.breaker.half_opens")
            obs.event("serve.breaker.half_open", cohort=self.cohort)
        return self._state

    def allow(self) -> bool:
        """May a dispatch for this cohort proceed right now? HALF_OPEN
        consumes one probe slot per allowed dispatch."""
        state = self.state
        if state == CLOSED:
            return True
        if state == HALF_OPEN and self._probes_left > 0:
            self._probes_left -= 1
            return True
        return False

    def record_success(self) -> None:
        self._consecutive_failures = 0
        if self._state == HALF_OPEN:
            self._state = CLOSED
            obs.inc("serve.breaker.closes")
            obs.event("serve.breaker.close", cohort=self.cohort)

    def record_failure(self) -> None:
        self._consecutive_failures += 1
        tripping = (self._state == HALF_OPEN
                    or self._consecutive_failures
                    >= self.policy.failure_threshold)
        if tripping and self._state != OPEN:
            self._state = OPEN
            self._opened_at = self._clock()
            self._consecutive_failures = 0
            obs.inc("serve.breaker.trips")
            obs.event("serve.breaker.trip", cohort=self.cohort)
