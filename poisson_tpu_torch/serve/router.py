"""Cost-model backend router with misprediction sentinels (counterpart of
``poisson_tpu/serve/router.py``).

``ServicePolicy.router`` picks a backend arm per dispatch cohort:

**Cold** (no measured evidence for the cohort) the router follows the
analytic model's structure:

- grids the port's resident kernel admits (``ops.resident.fits_resident``:
  9 fp32 canvases within 40 MB) go to ``resident``;
- working sets on the memory plateau (≥ :data:`CA_PLATEAU_BYTES`) go to
  the s-step ``ca`` arm;
- everything else goes to ``torch``, the plain solve.

The resident rule is the port's own, not the JAX package's (12 fp32
arrays within 15 MiB of VMEM), so the two routers part ways where the
card holds a grid a TPU core does not: 800×800 and 800×1200 go resident
here and to the floor arm in JAX.

**Warm** (a candidate's cohort has ≥ ``warm_min_samples`` roofline
samples) the router ranks candidates by modeled time per iteration,
``effective_passes(backend) / measured fraction of peak`` (cold
candidates priced at :data:`DEFAULT_COLD_FRACTION`).

**Sentinels.** Each measured dispatch is graded against its decision: a
fraction below ``misprediction_fraction ×`` expected is a misprediction
(``serve.router.misprediction``); ``demote_after`` of them demote the
(backend, device_id) arm with the breaker's state machine (cooldown →
HALF_OPEN re-probe → recovery). ``torch`` is the floor arm and never
demotes. At ``downshift_at`` queue pressure every dispatch is forced onto
the floor arm (``serve.degraded.backend_downshift``).

**Execution gate.** :func:`executor_backend` returns ``"torch"`` for every
arm, as the JAX package's returns ``"xla"``: routing changes labels,
telemetry and evidence, never the solve, and a routed choice other than
the floor is counted in ``serve.router.executor_fallbacks``.

**Arm names.** The arms carry the port's backend names, the ones
``obs.costs.EFFECTIVE_PASSES`` and ``obs.roofline`` use; this is the only
renaming between the two packages' services (:data:`JAX_ARM_NAMES`):

    ``xla`` → ``torch``, ``pallas_resident`` → ``resident``,
    ``pallas_ca`` → ``ca``

Counters (see ``obs/metrics.py``): ``serve.router.decisions`` with
``serve.router.{cold,warm}_decisions`` and per-arm
``serve.router.chosen.<backend>``; the sentinel family
``serve.router.{mispredictions,demotions,half_opens,recoveries}``;
``serve.router.executor_fallbacks``; and the ``serve.router.demoted_arms``
gauge.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs.costs import grid_points
from poisson_tpu_torch.obs.roofline import (DEFAULT_COLD_FRACTION,
                                            RooflineModel, RooflineSample,
                                            effective_passes,
                                            roofline_cohort)
from poisson_tpu_torch.ops.resident import fits_resident

# Working-set size past which the model places the s-step CA solve's
# fusion win over the plain solve's lower pass count (the JAX package's
# constant).
CA_PLATEAU_BYTES = 64 * 2**20

# Arm states (the circuit breaker's vocabulary).
HEALTHY = "healthy"
DEMOTED = "demoted"
HALF_OPEN = "half_open"

# The backend names the router can emit. Executor gate: all of them
# execute on the plain solve (see executor_backend).
BACKEND_TORCH = "torch"
BACKEND_RESIDENT = "resident"
BACKEND_CA = "ca"

# The JAX package's arm name → the port's (module docstring).
JAX_ARM_NAMES = {"xla": BACKEND_TORCH,
                 "pallas_resident": BACKEND_RESIDENT,
                 "pallas_ca": BACKEND_CA}


def available_backends(device_kind: Optional[str],
                       assume: Tuple[str, ...] = ()
                       ) -> Tuple[str, ...]:
    """Candidate arms for a device kind. ``torch`` is always available;
    the kernel arms require a CUDA device kind (an NVIDIA card's name, as
    ``utils.platform.device_name`` gives it) or an explicit
    ``assume_available`` override (the chaos/test seam that runs the
    whole routing state machine on the CPU)."""
    kinds = [BACKEND_TORCH]
    kind = (device_kind or "").lower()
    on_cuda = "nvidia" in kind or "cuda" in kind
    for cand in (BACKEND_RESIDENT, BACKEND_CA):
        if on_cuda or cand in assume:
            kinds.append(cand)
    return tuple(kinds)


def fits_resident_bytes(M: int, N: int) -> bool:
    """Whether kernel R admits an (M, N) grid (``ops.resident``: its
    canvases are fp32 whatever the request's dtype)."""
    return fits_resident(Problem(M=M, N=N))


def analytic_choice(M: int, N: int, dtype_bytes: int,
                    candidates: Tuple[str, ...]) -> str:
    """The cold policy table (module docstring): resident when kernel R
    admits the grid, CA on the memory plateau, torch elsewhere."""
    if BACKEND_RESIDENT in candidates and fits_resident_bytes(M, N):
        return BACKEND_RESIDENT
    if (BACKEND_CA in candidates
            and grid_points(M, N) * dtype_bytes >= CA_PLATEAU_BYTES):
        return BACKEND_CA
    return BACKEND_TORCH


def executor_backend(backend: str) -> str:
    """The execution path a routed choice actually runs on: ``"torch"``
    for every arm, as in the JAX package (whose contract pin raises if
    its gate opens). Routing accumulates evidence without changing the
    solve."""
    return BACKEND_TORCH


@dataclass(frozen=True)
class Decision:
    """One routing decision: the arm picked for a dispatch cohort,
    whether it came from the cold analytic table or warm measured
    evidence, and the roofline fraction the sentinel will grade the
    measurement against."""

    backend: str
    cohort: str
    expected_fraction: float
    cold: bool
    device_id: int
    forced_xla: bool = False


class _Arm:
    """Per-(backend, device_id) sentinel state — the circuit breaker's
    CLOSED/OPEN/HALF_OPEN machine with misprediction strikes in place
    of dispatch failures."""

    __slots__ = ("strikes", "state", "until", "probes_left")

    def __init__(self):
        self.strikes = 0
        self.state = HEALTHY
        self.until = 0.0
        self.probes_left = 0


class BackendRouter:
    """Routes dispatch cohorts across backend arms and grades every
    measured sample against its decision (see module docstring)."""

    def __init__(self, policy, roofline: RooflineModel,
                 clock=None):
        import time as _time
        self.policy = policy
        self.roofline = roofline
        self._clock = clock if clock is not None else _time.monotonic
        self._arms: Dict[Tuple[str, int], _Arm] = {}
        self._chosen: Dict[str, int] = {}
        self._decisions = 0
        self._cold = 0
        self._warm = 0
        self._mispredictions = 0
        self._demotions = 0
        self._recoveries = 0
        self._lock = threading.Lock()

    # -- arm state machine ----------------------------------------------

    def _arm(self, backend: str, device_id: int) -> _Arm:
        key = (backend, int(device_id))
        arm = self._arms.get(key)
        if arm is None:
            arm = self._arms[key] = _Arm()
        return arm

    def _probe_candidate(self, backend: str, device_id: int,
                         consume: bool) -> bool:
        """True when ``backend``'s arm is due a half-open re-probe:
        DEMOTED with its cooldown expired, or already HALF_OPEN with
        probe budget left. With ``consume`` the state transition and
        probe decrement happen; the peek path only observes."""
        arm = self._arm(backend, device_id)
        if arm.state == DEMOTED and self._clock() >= arm.until:
            if consume:
                arm.state = HALF_OPEN
                arm.probes_left = max(1, int(
                    self.policy.half_open_probes))
                obs.inc("serve.router.half_opens")
                obs.event("serve.router.half_open", backend=backend,
                          device=int(device_id))
                arm.probes_left -= 1
            return True
        if arm.state == HALF_OPEN and arm.probes_left > 0:
            if consume:
                arm.probes_left -= 1
            return True
        return False

    def demoted_arms(self) -> Tuple[str, ...]:
        with self._lock:
            return tuple(sorted(
                f"{b}:{d}" for (b, d), arm in self._arms.items()
                if arm.state == DEMOTED))

    # -- decisions -------------------------------------------------------

    def peek(self, *, M: int, N: int, dtype_bytes: int, batch: int = 1,
             preconditioner: Optional[str] = None,
             verify_every: int = 0,
             device_kind: Optional[str] = None,
             device_id: int = 0) -> str:
        """The backend :meth:`route` would pick, without counters, arm
        probe consumption, or events — the pure variant the service's
        cohort labeler calls (labels must not tick decision counters)."""
        return self._choose(M, N, dtype_bytes, batch, preconditioner,
                            verify_every, device_kind, device_id,
                            consume=False)[0]

    def route(self, *, M: int, N: int, dtype_bytes: int, batch: int = 1,
              preconditioner: Optional[str] = None,
              verify_every: int = 0,
              device_kind: Optional[str] = None,
              device_id: int = 0,
              queue_fraction: float = 0.0) -> Decision:
        """Pick the arm for one dispatch and record the decision."""
        forced = False
        with self._lock:
            backend, cold, expected = self._choose(
                M, N, dtype_bytes, batch, preconditioner, verify_every,
                device_kind, device_id, consume=True)
            if (backend != BACKEND_TORCH
                    and queue_fraction >= self.policy.downshift_at):
                # Backend-downshift rung: under pressure the service
                # runs only the floor arm.
                backend, forced = BACKEND_TORCH, True
                expected, cold, _ = self._expectation(
                    backend, M, N, batch, dtype_bytes, preconditioner,
                    verify_every, device_kind)
            self._decisions += 1
            if cold:
                self._cold += 1
            else:
                self._warm += 1
            self._chosen[backend] = self._chosen.get(backend, 0) + 1
        obs.inc("serve.router.decisions")
        obs.inc("serve.router.cold_decisions" if cold
                else "serve.router.warm_decisions")
        obs.inc(f"serve.router.chosen.{backend}")
        if forced:
            obs.inc("serve.degraded.backend_downshift")
            obs.event("serve.degraded", rung="backend_downshift",
                      queue_fraction=round(queue_fraction, 3))
        cohort = roofline_cohort(backend, M, N, max(1, int(batch)),
                                 dtype_bytes, preconditioner,
                                 int(verify_every), device_kind)
        return Decision(backend=backend, cohort=cohort,
                        expected_fraction=expected, cold=cold,
                        device_id=int(device_id), forced_xla=forced)

    def _expectation(self, backend, M, N, batch, dtype_bytes,
                     preconditioner, verify_every, device_kind):
        cohort = roofline_cohort(backend, M, N, max(1, int(batch)),
                                 dtype_bytes, preconditioner,
                                 int(verify_every), device_kind)
        expected, cold, samples = self.roofline.expected_fraction(cohort)
        return expected, cold, samples

    def _choose(self, M, N, dtype_bytes, batch, preconditioner,
                verify_every, device_kind, device_id, consume):
        """(backend, cold, expected_fraction). Cold until some allowed
        candidate's cohort carries ``warm_min_samples`` measurements;
        then an argmin over modeled seconds/iteration —
        passes / fraction-of-peak — with cold candidates priced at the
        prior."""
        fixed = getattr(self.policy, "backend", "auto")
        candidates = available_backends(
            device_kind, tuple(self.policy.assume_available))
        if fixed and fixed != "auto":
            backend = fixed if fixed in candidates else BACKEND_TORCH
            expected, cold, _ = self._expectation(
                backend, M, N, batch, dtype_bytes, preconditioner,
                verify_every, device_kind)
            return backend, cold, expected
        # Half-open re-probe: an arm past its cooldown that the
        # analytic model still prefers is probed ahead of warm
        # ranking — the measured evidence that demoted it would
        # otherwise keep it demoted forever. The probe is graded
        # against the cold prior, not the arm's own (bad) history.
        analytic = analytic_choice(M, N, dtype_bytes, candidates)
        if (analytic != BACKEND_TORCH
                and self._probe_candidate(analytic, device_id,
                                          consume)):
            return analytic, True, DEFAULT_COLD_FRACTION
        allowed = [
            b for b in candidates
            if b == BACKEND_TORCH
            or self._arm(b, device_id).state == HEALTHY
        ]
        scored = []
        warm_evidence = False
        for b in allowed:
            passes = effective_passes(b, preconditioner, M, N,
                                      dtype_bytes)
            if passes is None:
                continue
            expected, cold, samples = self._expectation(
                b, M, N, batch, dtype_bytes, preconditioner,
                verify_every, device_kind)
            if samples >= max(1, int(self.policy.warm_min_samples)):
                warm_evidence = True
            frac = expected if not cold else DEFAULT_COLD_FRACTION
            scored.append((passes / max(frac, 1e-9), b, cold,
                           expected))
        if not warm_evidence or not scored:
            backend = analytic_choice(M, N, dtype_bytes,
                                      tuple(allowed))
            expected, cold, _ = self._expectation(
                backend, M, N, batch, dtype_bytes, preconditioner,
                verify_every, device_kind)
            return backend, True, expected
        scored.sort(key=lambda t: (t[0], t[1]))
        _, backend, cold, expected = scored[0]
        return backend, False, expected

    # -- sentinel --------------------------------------------------------

    def grade(self, decision: Optional[Decision],
              sample: Optional[RooflineSample]) -> None:
        """Grade one measured dispatch against its decision. A None
        sample (unmeasurable dispatch — VirtualClock) is a no-op: the
        sentinel only ever acts on real measurements."""
        if decision is None or sample is None:
            return
        threshold = (self.policy.misprediction_fraction
                     * decision.expected_fraction)
        if sample.fraction < threshold:
            with self._lock:
                self._mispredictions += 1
            obs.inc("serve.router.mispredictions")
            obs.event("serve.router.misprediction",
                      backend=decision.backend,
                      cohort=decision.cohort,
                      device=decision.device_id,
                      fraction=round(sample.fraction, 6),
                      expected=round(decision.expected_fraction, 6),
                      threshold=round(threshold, 6))
            self._record_misprediction(decision)
        else:
            self._record_good(decision)
        obs.gauge("serve.router.demoted_arms",
                  len(self.demoted_arms()))

    def _record_misprediction(self, decision: Decision) -> None:
        if decision.backend == BACKEND_TORCH:
            return  # the floor arm never demotes
        arm = self._arm(decision.backend, decision.device_id)
        arm.strikes += 1
        tripped = (arm.state == HALF_OPEN
                   or arm.strikes >= max(1, int(
                       self.policy.demote_after)))
        if tripped:
            arm.state = DEMOTED
            arm.strikes = 0
            arm.until = self._clock() + float(
                self.policy.cooldown_seconds)
            with self._lock:
                self._demotions += 1
            obs.inc("serve.router.demotions")
            obs.event("serve.router.demote",
                      backend=decision.backend,
                      device=decision.device_id,
                      cooldown_seconds=float(
                          self.policy.cooldown_seconds))

    def _record_good(self, decision: Decision) -> None:
        if decision.backend == BACKEND_TORCH:
            return
        arm = self._arm(decision.backend, decision.device_id)
        arm.strikes = 0
        if arm.state == HALF_OPEN:
            arm.state = HEALTHY
            arm.probes_left = 0
            with self._lock:
                self._recoveries += 1
            obs.inc("serve.router.recoveries")
            obs.event("serve.router.recover",
                      backend=decision.backend,
                      device=decision.device_id)

    # -- reporting -------------------------------------------------------

    def stats(self) -> dict:
        """The ``stats()["router"]`` block: decision mix, sentinel
        tallies, demoted arms, and per-backend measured fractions."""
        with self._lock:
            chosen = dict(sorted(self._chosen.items()))
            out = {
                "decisions": self._decisions,
                "cold_decisions": self._cold,
                "warm_decisions": self._warm,
                "mispredictions": self._mispredictions,
                "demotions": self._demotions,
                "recoveries": self._recoveries,
                "chosen": chosen,
            }
        out["demoted_arms"] = list(self.demoted_arms())
        fractions = {}
        for b in chosen:
            f = self.roofline.backend_fraction(b)
            if f is not None:
                fractions[b] = round(f, 6)
        out["measured_fractions"] = fractions
        return out
