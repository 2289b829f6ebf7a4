"""Resilient solve service: the request-lifecycle layer over the solvers
(counterpart of ``poisson_tpu/serve``).

The resilient solve makes a *single* solve survivable (divergence
recovery, hardened checkpoints, watchdog) and the batched solve makes
*many* solves cheap. This package makes batched solves survivable **as a
service**: bounded admission with typed shedding, per-request deadlines
propagated into chunked solves, retry with exponential backoff + jitter
and poisoned-member bucket isolation, a circuit breaker per
(grid, dtype, backend) cohort, and a documented graceful-degradation
ladder — every mechanism audible as ``serve.*`` counters/spans
(``poisson_tpu_torch.obs``) and exportable to Prometheus (``obs.export``).

It has a silent-data-corruption defense
(``poisson_tpu_torch.integrity``): integrity failures are a typed
``integrity`` outcome class with retry through the verified-restart
driver, and the first detection taints the (backend, device_kind)
hardware cohort as SDC-suspect so later dispatches on it run
defensively verified (``ServicePolicy.integrity``,
``serve.integrity.*`` counters).

The service is *durable*: a supervised worker fleet
(``serve.fleet`` — sticky executables, per-worker breakers, heartbeat
watchdogs, quarantine → warm-up restart) and a CRC-sealed write-ahead
journal (``serve.journal``) whose replay recovers queued and
lane-resident requests after a crash without double-admitting or
double-delivering.

The load-bearing invariant, asserted by the chaos campaign
(``poisson_tpu_torch.testing.chaos``;
``python -m poisson_tpu_torch chaos --all``):
every admitted request terminates with exactly one typed outcome —
result, typed error, or typed shed. ``admitted − (completed + errors +
shed) == 0``; no request is ever silently lost — now including across a
process kill/replay boundary, where the merged per-process ``serve.*``
snapshots close the same equation.

    from poisson_tpu_torch.serve import SolveRequest, SolveService
    svc = SolveService()
    svc.submit(SolveRequest(request_id=0, problem=Problem(M=40, N=40)))
    outcomes = svc.drain()
"""

from poisson_tpu_torch.serve.breaker import (CLOSED, HALF_OPEN, OPEN,
                                             CircuitBreaker)
from poisson_tpu_torch.serve.deadline import Deadline
from poisson_tpu_torch.serve.fleet import (
    WORKER_DEAD,
    WORKER_QUARANTINED,
    WORKER_RUNNING,
    DeviceLossError,
    Worker,
    WorkerCrashError,
    WorkerHangError,
    WorkerPool,
)
from poisson_tpu_torch.serve.placement import (
    RUNG_MESH,
    RUNG_SHED,
    RUNG_SINGLE,
    DeviceRegistry,
    Placement,
    PlacementError,
    elastic_plan,
)
from poisson_tpu_torch.serve.journal import (
    JournalReplay,
    PendingRequest,
    SessionReplay,
    SolveJournal,
    replay_journal,
    replay_sessions,
)
from poisson_tpu_torch.serve.session import SessionHost, SolveSession
from poisson_tpu_torch.serve.tenancy import (
    DEFAULT_TENANT,
    TenancyPolicy,
    TenantLedger,
    parse_tenant_spec,
)
from poisson_tpu_torch.serve.service import (
    SolveService,
    p99_exemplar,
    slowest_requests,
)
from poisson_tpu_torch.integrity.probe import IntegrityPolicy
from poisson_tpu_torch.krylov import KrylovPolicy
from poisson_tpu_torch.serve.types import (
    ERROR_DIVERGENCE,
    ERROR_INTEGRITY,
    ERROR_INTERNAL,
    ERROR_PLACEMENT,
    ERROR_TRANSIENT,
    OUTCOME_ERROR,
    OUTCOME_RESULT,
    OUTCOME_SHED,
    BreakerPolicy,
    DegradationPolicy,
    FleetPolicy,
    ForecastPolicy,
    Outcome,
    RetryPolicy,
    RouterPolicy,
    SCHED_CONTINUOUS,
    SCHED_DRAIN,
    ServicePolicy,
    SessionPolicy,
    SHED_BREAKER_OPEN,
    SHED_DEADLINE_EXPIRED,
    SHED_PREDICTED_DEADLINE,
    SHED_QUEUE_FULL,
    SHED_QUOTA_EXCEEDED,
    SLOPolicy,
    SolveRequest,
    TransientDispatchError,
)

__all__ = [
    "BreakerPolicy", "CircuitBreaker", "CLOSED", "Deadline",
    "DEFAULT_TENANT",
    "DegradationPolicy", "DeviceLossError", "DeviceRegistry",
    "ERROR_DIVERGENCE", "ERROR_INTEGRITY",
    "ERROR_INTERNAL", "ERROR_PLACEMENT",
    "ERROR_TRANSIENT", "FleetPolicy", "ForecastPolicy",
    "HALF_OPEN", "IntegrityPolicy",
    "JournalReplay", "KrylovPolicy",
    "OPEN", "Outcome", "OUTCOME_ERROR",
    "OUTCOME_RESULT", "OUTCOME_SHED", "PendingRequest", "Placement",
    "PlacementError", "RetryPolicy", "RouterPolicy",
    "RUNG_MESH", "RUNG_SHED", "RUNG_SINGLE",
    "SCHED_CONTINUOUS", "SCHED_DRAIN", "ServicePolicy",
    "SessionHost", "SessionPolicy", "SessionReplay",
    "SHED_BREAKER_OPEN", "SHED_DEADLINE_EXPIRED",
    "SHED_PREDICTED_DEADLINE", "SHED_QUEUE_FULL",
    "SHED_QUOTA_EXCEEDED",
    "SLOPolicy", "SolveJournal", "SolveRequest", "SolveService",
    "SolveSession", "TenancyPolicy", "TenantLedger",
    "TransientDispatchError", "WORKER_DEAD", "WORKER_QUARANTINED",
    "WORKER_RUNNING", "Worker", "WorkerCrashError", "WorkerHangError",
    "WorkerPool", "elastic_plan", "p99_exemplar", "parse_tenant_spec",
    "replay_journal",
    "replay_sessions", "slowest_requests",
]
