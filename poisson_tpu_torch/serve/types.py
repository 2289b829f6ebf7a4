"""Typed request/outcome taxonomy for the solve service (counterpart of
``poisson_tpu/serve/types.py``).

The central invariant the whole ``poisson_tpu_torch.serve`` layer exists to
uphold: **every admitted request terminates with exactly one typed
outcome** — a result (possibly partial), a typed error, or a typed shed.
No request is ever silently lost, and nothing about a request's fate has
to be reconstructed from logs: the outcome object says what happened,
after how many attempts, and in how long.

Outcome kinds:

- ``result`` — a solution grid came back. ``converged`` says whether it
  met δ; a deadline or degraded-iteration-cap stop returns the partial
  iterate with ``partial=True`` and the stop verdict in ``flag``
  (``solvers.pcg.FLAG_NAMES``) rather than pretending to have failed —
  the partial iterate of an elliptic solve is a usable warm start.
- ``error`` — the service gave up after its retry/escalation budget:
  ``error_type`` ∈ ``divergence`` (recovery exhausted, see
  ``solvers.resilient.DivergenceError``), ``transient`` (dispatch kept
  failing — device fault, injected chaos), ``integrity`` (the in-loop
  verification probe kept detecting silent data corruption —
  ``poisson_tpu_torch.integrity``; the first detection also taints the
  (backend, device_kind) hardware cohort as SDC-suspect), ``internal``
  (a bug; never retried, always surfaced).
- ``shed`` — the service refused the work, by policy, with a reason:
  ``queue_full`` (bounded admission queue — overload never becomes
  unbounded memory growth), ``breaker_open`` (the request's cohort is
  circuit-broken), ``deadline_expired`` (the budget ran out while the
  request was still queued — dispatching it would burn capacity on an
  answer nobody is waiting for), ``predicted_deadline`` (the forecast
  guard priced the deadline hopeless before any compute), or
  ``quota_exceeded`` (the tenant is over its admission quota —
  ``ServicePolicy.tenancy``; one hot client's overload never becomes
  everyone's).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.integrity.probe import IntegrityPolicy
from poisson_tpu_torch.krylov import KrylovPolicy
from poisson_tpu_torch.serve.tenancy import TenancyPolicy

OUTCOME_RESULT = "result"
OUTCOME_ERROR = "error"
OUTCOME_SHED = "shed"

ERROR_DIVERGENCE = "divergence"
ERROR_TRANSIENT = "transient"
ERROR_INTERNAL = "internal"
ERROR_INTEGRITY = "integrity"
# A placement that cannot be satisfied on the current topology: a
# request pinned to a device id that no longer exists (recovery on a
# smaller topology, a lost fault domain). Typed — never a wedge.
ERROR_PLACEMENT = "placement"

SHED_QUEUE_FULL = "queue_full"
SHED_BREAKER_OPEN = "breaker_open"
SHED_DEADLINE_EXPIRED = "deadline_expired"
# The forecast guard's verdict (ServicePolicy.forecast): the cohort's
# p90 ETA says this deadline cannot be met — refused at admission (or
# pre-empted at a lane boundary) BEFORE burning the compute, which is
# the whole point of forecasting.
SHED_PREDICTED_DEADLINE = "predicted_deadline"
# The tenant's token-bucket admission quota is empty
# (ServicePolicy.tenancy): refused at admission, zero compute burned —
# per-client overload is that client's problem, not the fleet's.
SHED_QUOTA_EXCEEDED = "quota_exceeded"


class TransientDispatchError(RuntimeError):
    """A dispatch-level fault that poisoned the whole batch (device
    crash, wedged transfer, injected chaos). Retryable: the service
    re-enqueues every member into a *different* bucket — one poisoned
    member must not re-kill its batchmates on the retry."""


@dataclasses.dataclass(frozen=True)
class SolveRequest:
    """One Poisson solve as a service request.

    ``rhs_gate`` scales the problem's RHS (the multi-tenant knob: many
    requests share one operator cohort and differ in forcing). Requests
    whose ``deadline_seconds``/``chunk`` is set are dispatched through
    the chunked single-request path (deadlines need chunk boundaries to
    be enforceable); the rest ride the batched multi-RHS path.
    ``on_chunk`` is the fault-injection seam (``testing.faults``) for
    chunked dispatches — None in production.

    ``geometry`` makes the DOMAIN a request parameter
    (:mod:`poisson_tpu_torch.geometry`): a spec compiled to fingerprint-cached
    coefficient canvases. Geometry requests form their own ``…:geo``
    cohorts in which *different* geometries on the same grid co-batch
    inside one bucket executable (only the canvases differ per member);
    the fingerprint rides the flight trace for attribution, and
    poison-isolation taint keys on (request, fingerprint) — a geometry
    family implicated in a batch kill never re-co-batches with the
    batchmates it took down. ``None`` is the reference ellipse path,
    byte-identical to every prior release.

    ``preconditioner`` selects the request's M⁻¹ (``"jacobi"`` |
    ``"mg"`` — :mod:`poisson_tpu_torch.mg`; None defers to
    ``ServicePolicy.preconditioner``). MG requests form their own
    ``…:mg`` cohorts — separate bucket executables, separate breakers,
    separate sentinel baselines — so an MG rollout can never indict (or
    hide behind) the Jacobi fleet; MG+geometry requests dispatch solo
    (per-member hierarchies do not co-batch yet).
    """

    request_id: Union[int, str]
    problem: Problem
    rhs_gate: float = 1.0
    dtype: Optional[str] = None
    deadline_seconds: Optional[float] = None
    chunk: Optional[int] = None
    max_attempts: Optional[int] = None
    on_chunk: Optional[Callable] = None
    geometry: Optional[object] = None     # geometry.dsl.GeometrySpec
    preconditioner: Optional[str] = None  # None -> policy default
    # Hard placement pin (serve.placement): the request may only run on
    # a worker bound to this fault-domain slot — the A/B-on-one-chip
    # and indict-the-part debugging knob. Validated alive at admission;
    # a pin whose device dies while the request is pending (or is gone
    # at journal recovery on a smaller topology) becomes a typed
    # ``placement`` error, never a wedge. None (default): any worker.
    device_id: Optional[int] = None
    # Krylov-memory knobs (:mod:`poisson_tpu_torch.krylov`; None defers to
    # ``ServicePolicy.krylov``). ``mode="block"`` requests form their
    # own ``…:blk`` cohorts (block bucket executables — co-batched
    # members must share one operator, so block batches additionally
    # require fingerprint-uniform geometry); ``deflation=True``
    # requests form ``…:defl`` cohorts and dispatch solo through the
    # fingerprint-keyed basis cache (``krylov.recycle``), with routing
    # preferring the worker already holding the family's basis.
    # Validated at admission: an unknown mode, block+deflation, or
    # deflation combined with the chunked/deadline path is a loud
    # ValueError.
    krylov: Optional[KrylovPolicy] = None
    # Session stream identity (:mod:`poisson_tpu_torch.serve.session`): a
    # request carrying ``session_id`` is step ``session_step`` of an
    # ordered stream of dependent solves. Session steps dispatch solo
    # (the warm-start seam is a single-request program) and journal
    # their session fields, so a recovery re-enqueues a killed step
    # into the SAME stream. ``warm_start`` is the previous step's
    # w-space iterate and ``warm_geometry`` the spec it solved — device
    # state, deliberately NEVER journaled: a recovered step always runs
    # cold (unreplayed device state is not evidence). ``mass_shift`` is
    # the implicit-Euler 1/Δt operator shift (0 = plain Poisson step).
    # ``on_solution`` hands the step's solution grid back to the
    # session host for the next step's warm start — a process handle,
    # like ``on_chunk`` it does not survive a crash (audibly).
    session_id: Optional[str] = None
    session_step: Optional[int] = None
    mass_shift: float = 0.0
    warm_start: Optional[object] = None
    warm_geometry: Optional[object] = None
    on_solution: Optional[Callable] = None
    # The client identity behind the request (``rhs_gate`` is the
    # multi-tenant *payload* knob; this is the multi-tenant *identity*
    # knob). With ``ServicePolicy.tenancy`` set it selects the tenant's
    # admission-quota bucket, fair-share weight, and retry budget
    # (``serve.tenancy``); it rides the journal and the flight trace.
    # None pools the request under the ``"default"`` pseudo-tenant —
    # and with tenancy off (the default) it is inert metadata.
    tenant: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class Outcome:
    """The one typed terminal record of a request's lifecycle."""

    request_id: Union[int, str]
    kind: str                     # result | error | shed
    flag: str = ""                # stop verdict name (result outcomes)
    converged: bool = False
    partial: bool = False         # deadline/cap-stopped result
    iterations: int = 0
    restarts: int = 0             # recovery attempts inside the solve
    attempts: int = 1             # service-level dispatch attempts
    latency_seconds: float = 0.0  # admission → outcome, service clock
    error_type: str = ""          # divergence | transient | internal
    shed_reason: str = ""         # queue_full | breaker_open |
    #                               deadline_expired | predicted_deadline |
    #                               quota_exceeded
    message: str = ""
    diff: Optional[float] = None  # final ‖Δw‖ (result outcomes)
    # Flight-recorder attribution (obs.flight): the request's causal
    # trace id (joins the JSONL span tree / `python -m poisson_tpu_torch
    # trace`) and its latency decomposition — wall_s = queue_s +
    # compute_s + lane_wait_s + backoff_s + overhead_s on the service
    # clock, components summing to the measured wall.
    trace_id: str = ""
    decomposition: Optional[dict] = None

    @property
    def ok(self) -> bool:
        return self.kind == OUTCOME_RESULT and self.converged


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Retry-with-exponential-backoff-and-jitter for retryable failures.

    ``max_attempts`` counts dispatches (1 = never retry). Backoff delay
    for attempt *n* (1-based) is
    ``min(backoff_base · 2^(n−1), backoff_cap)``, jittered over
    ``[1 − jitter, 1]`` by the service's seeded RNG — deterministic under
    a fixed seed, decorrelated across requests. ``escalate_divergence``
    routes a divergence-class retry through the self-healing driver
    (``solvers.resilient``: restart from last good iterate, precision
    escalation) instead of a plain re-dispatch.
    """

    max_attempts: int = 3
    backoff_base: float = 0.05
    backoff_cap: float = 2.0
    jitter: float = 0.5
    escalate_divergence: bool = True


@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Per-cohort circuit breaker: trip after ``failure_threshold``
    consecutive dispatch failures, hold OPEN for ``cooldown_seconds``,
    then HALF_OPEN with ``half_open_probes`` probe dispatches."""

    failure_threshold: int = 3
    cooldown_seconds: float = 5.0
    half_open_probes: int = 1


@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """The graceful-degradation policy ladder, driven by queue depth as a
    fraction of capacity. Each engaged step is audible as a
    ``serve.degraded.*`` counter and event — degradation that cannot be
    seen in the metrics is indistinguishable from silent data loss.

    1. ``shrink_padding_at`` — dispatch exact-size batches instead of
       power-of-two buckets: no padding-member work when every real
       member counts (costs executable-cache reuse, buys latency).
    2. ``cap_iterations_at`` — cap ``max_iterations`` at
       ``degraded_iteration_cap``: slow-converging requests return
       partial results instead of holding the queue hostage.
    3. ``downshift_precision_at`` — downshift float64 requests to
       float32 (symmetrically-scaled fp32 reproduces fp64 iteration
       counts on this problem class — README "Precision policy").
    """

    shrink_padding_at: float = 0.5
    cap_iterations_at: float = 0.75
    degraded_iteration_cap: int = 256
    downshift_precision_at: float = 0.9


@dataclasses.dataclass(frozen=True)
class FleetPolicy:
    """The durable-fleet knobs (``serve.fleet``): ``workers`` dispatch
    contexts pull from the shared admission queue, each owning its own
    sticky bucket executables, circuit-breaker cohort, lane table, and
    heartbeat watchdog (``parallel.watchdog``).

    A worker that crashes mid-dispatch (``WorkerCrashError`` from the
    worker-fault seam), hangs past ``heartbeat_timeout`` on the service
    clock (``WorkerHangError``, or a successful step that overran the
    watchdog), or keeps poisoning its dispatches is **quarantined** for
    ``quarantine_seconds``: its in-flight requests are recovered —
    mutual-tainted, ``recovery_backoff``-delayed, flight-marked
    ``recovered`` — and re-dispatched to the surviving workers. After
    cooldown the worker restarts through warm-up (``warm_restart``
    runs its sticky buckets once before it takes traffic);
    after ``max_restarts`` restarts it is declared dead and never
    scheduled again. Every transition is audible as a
    ``serve.fleet.*`` counter/event.

    ``heartbeat_timeout`` is **opt-in** (None disables the stall
    verdict): it bounds one dispatch/chunk step on the service clock,
    and only the operator knows what "too long" means for their grids —
    a default would mistake a legitimately slow large-grid dispatch
    (cold compile included) for a hang and evict healthy lane progress.
    Size it well past the worst healthy step, like the solve watchdog.

    ``devices`` spreads the fleet over real silicon
    (``serve.placement``): N fault-domain slots backed by the service's
    devices (every CUDA card, or the CPU; oversubscribed when fewer
    physical devices exist), workers bound round-robin, sticky bucket
    executables compiled ON the bound device, breaker/integrity
    cohorts keyed by ``(device_kind, device_id)``. A
    :class:`~poisson_tpu_torch.serve.fleet.DeviceLossError` from the
    worker-fault seam quarantines EVERY worker in the lost fault
    domain and rebinds them to survivors at restart. None (default):
    one slot on the process default device — byte-for-byte the
    pre-placement fleet.
    """

    workers: int = 1
    heartbeat_timeout: Optional[float] = None
    quarantine_seconds: float = 0.5
    max_restarts: int = 3
    recovery_backoff: float = 0.05
    warm_restart: bool = True
    devices: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Declared service-level objectives, scored per outcome by the
    flight recorder's :class:`~poisson_tpu_torch.obs.flight.SLOTracker`.

    An outcome is **good** iff it is a converged result delivered within
    ``latency_objective_seconds``; everything else — sheds, typed
    errors, partial results, and slow successes — spends error budget
    (budget = ``1 − availability_target``). The tracker publishes
    ``serve.slo.{good,bad}`` counters, the real latency histogram
    (``serve.slo.latency_seconds`` — Prometheus histogram exposition),
    ``serve.slo.budget_remaining``, and one burn-rate gauge per entry in
    ``burn_windows`` (seconds on the service clock; two windows is the
    classic short-says-now / long-says-not-a-blip pairing).

    ``degrade_on_burn`` lets the degradation ladder consult the burn
    rate: rung *i+1* engages when EVERY window burns at or above
    ``burn_degrade_thresholds[i]`` (multi-window rule), making
    downshifts SLO-driven rather than only queue-depth-driven. Off by
    default: burn-driven downshifts change scheduling decisions, so the
    operator opts in with the thresholds they mean.
    """

    latency_objective_seconds: float = 2.0
    availability_target: float = 0.999
    burn_windows: tuple = (60.0, 600.0)
    degrade_on_burn: bool = False
    burn_degrade_thresholds: tuple = (2.0, 6.0, 14.0)


@dataclasses.dataclass(frozen=True)
class SessionPolicy:
    """Durable-session knobs (:mod:`poisson_tpu_torch.serve.session`).

    ``max_sessions`` bounds concurrently-open sessions (an open beyond
    it sheds, typed). ``shed_open_at`` is the session rung of the
    degradation ladder: a NEW session open sheds once queue depth
    reaches this fraction of capacity — deliberately *below* the
    queue-full threshold that sheds individual steps, because a
    half-finished stream is sunk cost (shed new sessions before steps
    of in-flight ones). ``warm_drift_bound``/``warm_residual_factor``
    parameterize the warm-start validity gate
    (``solvers.session.warm_validity``/residual sanity — a failing gate
    falls back cold, audibly). ``step_deadline_seconds`` is the
    default per-step deadline (enforced at step boundaries — the fused
    session programs do not chunk; a miss counts
    ``session.step.deadline_misses``). ``slo_seconds`` is the
    per-session wall objective scored at close on the session's own
    flight trace (``session.slo.{good,bad}``)."""

    max_sessions: int = 8
    shed_open_at: float = 0.75
    warm_drift_bound: float = 0.05
    warm_residual_factor: float = 100.0
    step_deadline_seconds: Optional[float] = None
    slo_seconds: float = 60.0


@dataclasses.dataclass(frozen=True)
class ForecastPolicy:
    """Predicted-deadline knobs (:mod:`poisson_tpu_torch.obs.forecast`).

    ``admission_shed``: a request whose deadline is below the cohort's
    p90 ETA × ``margin`` at submit sheds as typed
    ``predicted_deadline`` — refused before any dispatch, never
    admitted-then-burned. ``reforecast``: at every lane/chunk boundary
    an admitted deadline request is re-forecast from its own measured
    log-residual slope; hopeless work is pre-empted there (also a
    typed ``predicted_deadline`` shed, plus
    ``serve.forecast.preempted``). ``backlog_degradation``: the
    degradation ladder consults ETA backlog-seconds (queued p50 ETAs
    against ``backlog_objective_seconds``) instead of only raw queue
    depth. The shed condition is ``eta_p90 × margin > deadline``, so
    ``margin`` > 1 demands head-room (sheds more eagerly) and < 1
    tolerates optimistic ETAs. ``history_every`` > 0 additionally traces
    the residual-history callback into chunked solo dispatches
    (``pcg_solve(history_every=…)``); 0 keeps every program
    byte-identical and estimates from lane-boundary samples only."""

    admission_shed: bool = True
    reforecast: bool = True
    backlog_degradation: bool = False
    backlog_objective_seconds: float = 60.0
    margin: float = 1.0
    history_every: int = 0


@dataclasses.dataclass(frozen=True)
class RouterPolicy:
    """Backend-router knobs (:mod:`poisson_tpu_torch.serve.router`).

    ``backend``: ``"auto"`` routes per cohort (analytic model cold,
    measured roofline evidence warm); any explicit backend name pins
    every dispatch to that arm (falling back to ``torch`` where the arm
    is unavailable). ``misprediction_fraction``: a measured dispatch
    landing below this fraction of its cohort's expected roofline
    fraction is a misprediction (typed ``serve.router.misprediction``
    event). ``demote_after`` consecutive mispredictions demote the
    (backend, device_id) arm for ``cooldown_seconds``, then HALF_OPEN
    with ``half_open_probes`` probe dispatches — a good probe is a
    ``serve.router.recover``. ``warm_min_samples`` measured samples in
    a candidate's cohort graduate routing from the cold analytic table
    to warm measured ranking. ``assume_available`` force-lists kernel
    arms on hosts without a card — the chaos/test seam that exercises the
    full routing state machine on CPU. ``downshift_at`` is the
    degradation ladder's backend-downshift rung: at that queue
    fraction every dispatch is forced onto the ``torch`` floor
    arm (``serve.degraded.backend_downshift``)."""

    backend: str = "auto"
    misprediction_fraction: float = 0.5
    demote_after: int = 2
    cooldown_seconds: float = 30.0
    half_open_probes: int = 1
    warm_min_samples: int = 3
    assume_available: Tuple[str, ...] = ()
    downshift_at: float = 0.95


# Scheduling modes (ServicePolicy.scheduling):
SCHED_DRAIN = "drain"            # batch-drain: dispatch, wait, repeat
SCHED_CONTINUOUS = "continuous"  # lane table + refill state machine


@dataclasses.dataclass(frozen=True)
class ServicePolicy:
    """Top-level service knobs: bounded queue ``capacity`` (admission
    beyond it sheds — typed, immediate, never unbounded growth),
    ``max_batch`` members per fused dispatch, ``default_chunk``
    iterations between deadline checks on chunked dispatches.

    ``scheduling`` selects the dispatch engine: ``"drain"`` (form a
    batch, run it to completion, form the next) or ``"continuous"``
    (Orca-style in-flight refill — a lane table steps the fused program
    ``refill_chunk`` iterations at a time, retires
    converged lanes to their typed outcomes at each boundary, and
    splices queued RHS into the freed lanes of the same bucket
    executable; breaker/degradation/taint policies are re-checked at
    every refill decision). Both engines uphold the same ledger
    invariant; ``drain`` stays the default so the two are A/B-comparable
    (``bench.py --serve --arrival-rate`` measures exactly that).
    ``refill_chunk`` is the continuous engine's iterations-per-step —
    smaller means fresher refill decisions and tighter deadline
    enforcement, at more host round-trips.

    ``integrity`` is the silent-data-corruption defense
    (:class:`~poisson_tpu_torch.integrity.IntegrityPolicy`): with
    ``verify_every`` > 0 every dispatch — batched, chunked solo, and
    lane-table programs — runs the in-loop drift probe and a
    FLAG_INTEGRITY member becomes a typed ``integrity`` retry; at the
    default 0 the probe only arms *defensively*, after a first
    detection has tainted the (backend, device_kind) hardware cohort
    as SDC-suspect (``verify_on_suspect``/``suspect_verify_every``) —
    the executables of an untainted flag-off service stay
    byte-identical to every prior release.

    ``fleet`` sizes and supervises the worker pool (:class:`FleetPolicy`
    — ``workers=1`` is the single-worker service every prior PR ran).
    ``dedup`` makes submission idempotent: a second ``submit`` with an
    already-seen ``request_id`` returns the original outcome (or None
    while it is still pending) and counts a ``serve.dedup.hits`` —
    instead of raising — so a client retry or a replayed submission can
    never double-admit. Off by default: with deduplication off, a
    recycled id is a caller bug and stays a loud ``ValueError``.

    ``preconditioner`` is the service-wide default M⁻¹ for requests
    that do not set their own (``"jacobi"`` keeps every prior release's
    executables; ``"mg"`` makes the V-cycle the fleet default —
    requests on uncoarsenable grids are then rejected loudly at
    submission rather than failing inside a dispatch).

    ``krylov`` is the service-wide Krylov-memory default
    (:class:`~poisson_tpu_torch.krylov.KrylovPolicy`) for requests that do
    not set their own: the default (independent mode, no deflation)
    keeps every prior release's executables and cohorts byte-for-byte;
    ``mode="block"`` makes the block recurrence the fleet default for
    batchable dispatches (``…:blk`` cohorts), ``deflation=True`` routes
    every request through the fingerprint-keyed solver memory
    (``…:defl`` cohorts, solo dispatch, basis-holder sticky routing).

    ``session`` governs durable solver sessions
    (:class:`SessionPolicy` — ``poisson_tpu_torch.serve.session``): open
    bounds, the shed-new-sessions-first degradation rung, warm-start
    validity, per-step deadlines, and the per-session SLO. The defaults
    change nothing for session-free traffic.

    ``forecast`` arms the convergence observatory
    (:class:`ForecastPolicy` — ``poisson_tpu_torch.obs.forecast``):
    predicted-deadline admission, lane-boundary re-forecast
    pre-emption, and ETA-backlog degradation. None (the default)
    traces nothing, sheds nothing, and predicts nothing — byte- and
    behavior-identical to every prior release.

    ``router`` arms the cost-model backend router
    (:class:`RouterPolicy` — ``poisson_tpu_torch.serve.router``): per-cohort
    backend choice (analytic model cold, measured roofline evidence
    warm), misprediction sentinels with breaker-style arm demotion,
    and the backend-downshift degradation rung. None (the default)
    routes nothing — every cohort string, program, and dispatch path
    stays byte-identical to every prior release (pinned by the
    ``serve.routed_default_f64`` contracts ledger entry).

    ``tenancy`` arms tenant isolation & overload fairness
    (:class:`~poisson_tpu_torch.serve.tenancy.TenancyPolicy` —
    ``poisson_tpu_torch.serve.tenancy``): per-tenant token-bucket admission
    quotas (typed ``quota_exceeded`` sheds), deficit-weighted
    round-robin head selection in both engines, per-bucket lane-share
    caps, retry budgets that convert a poisoned tenant's requeue storm
    into typed errors, and tenant-scoped degradation/SLO accounting
    (``serve.tenant.*``). None (the default) polices nothing — strict
    FIFO service, byte- and behavior-identical to every prior release.
    """

    capacity: int = 64
    max_batch: int = 32
    default_chunk: int = 50
    scheduling: str = SCHED_DRAIN
    refill_chunk: int = 25
    dedup: bool = False
    preconditioner: str = "jacobi"
    retry: RetryPolicy = RetryPolicy()
    breaker: BreakerPolicy = BreakerPolicy()
    degradation: DegradationPolicy = DegradationPolicy()
    slo: SLOPolicy = SLOPolicy()
    fleet: FleetPolicy = FleetPolicy()
    integrity: IntegrityPolicy = IntegrityPolicy()
    krylov: KrylovPolicy = KrylovPolicy()
    session: SessionPolicy = SessionPolicy()
    forecast: Optional[ForecastPolicy] = None
    router: Optional[RouterPolicy] = None
    tenancy: Optional[TenancyPolicy] = None
