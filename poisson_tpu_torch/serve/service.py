"""The solve service: request lifecycle over the existing solvers
(counterpart of ``poisson_tpu/serve/service.py``).

Everything below the batched dispatch already exists — one batched
solve, hundreds of Poisson problems per dispatch — but a fault
mid-batch lost every co-batched request with it, and nothing bounded how
much work could pile up behind a wedged cohort. This module adds the
request level (the shape Orca, PAPERS.md, gives a serving stack):

- **bounded admission** — a queue of at most ``policy.capacity``
  requests; admission beyond it is a typed ``queue_full`` shed, never
  unbounded growth;
- **deadlines** — propagated into chunked solves (chunk-boundary checks,
  ``solvers.checkpoint``); expiry returns the partial iterate flagged
  ``deadline``, and a request whose budget dies while queued is shed
  without burning a dispatch;
- **retry with exponential backoff + jitter** — transient dispatch
  faults re-enqueue every member into a *different* bucket (mutual
  taint: one poisoned member cannot re-kill its batchmates);
  divergence-class member failures escalate through the self-healing
  driver (``solvers.resilient``);
- **circuit breaking** — per (grid, dtype, backend) cohort
  (``serve.breaker``), trip / cooldown / half-open probes;
- **graceful degradation** — the documented policy ladder
  (``types.DegradationPolicy``) driven by queue depth, every step
  audible as ``serve.degraded.*`` counters;
- **the ledger invariant** — every admitted request terminates with
  exactly one typed outcome; ``stats()['lost']`` is computed, asserted
  by the chaos campaign, and exported with the ``serve.*`` counters;
- **flight recording** (``obs.flight``) — every admitted request gets a
  trace id and a causal span tree (admit → queue_wait → lane_resident
  with chunk-step points → backoff_wait/retry → one typed outcome leaf)
  on the JSONL rails, a latency decomposition on its Outcome
  (components summing to the measured wall), and SLO accounting
  (``serve.slo.*`` counters/histogram/burn rates) that the degradation
  ladder can consult (``SLOPolicy.degrade_on_burn``).

- **the solve fleet** (``serve.fleet``) — ``FleetPolicy(workers=N)``
  runs N supervised dispatch contexts over this one queue and ledger:
  sticky bucket executables, per-worker breaker cohorts and lane
  tables, heartbeat watchdogs; a crashed/hung worker is quarantined,
  its in-flight requests recovered onto the survivors, and it restarts
  through warm-up;
- **durability** (``serve.journal``) — an optional CRC-sealed
  write-ahead journal records every transition, and
  :meth:`SolveService.recover` replays it after a crash: prior outcomes
  are deduplicated, pending requests re-enqueue as ``serve.recovered``
  (never re-admitted), and the merged per-process snapshots close the
  invariant across the kill/replay boundary.

The service is deliberately single-threaded and clock/sleep-injectable:
the dispatch loop IS the unit under chaos test, and determinism (seeded
jitter, virtual clocks) is what makes the chaos campaign a regression
suite instead of a flake generator. Fleet workers are cooperatively
scheduled dispatch contexts on that same loop — the supervisor state
machine (quarantine, restart, recovery) is the deterministic substrate
chaos needs; mapping workers onto OS threads or processes is a
deployment concern the API does not preclude.
"""

from __future__ import annotations

import random
import time
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.obs.costs import apportion_compute
from poisson_tpu_torch.obs.flight import (
    POINT_DEADLINE,
    POINT_FORECAST_SHED,
    POINT_PLACEMENT,
    POINT_QUARANTINE,
    POINT_RECOVERED,
    POINT_REFORECAST,
    POINT_RETRY,
    POINT_WARM_FALLBACK,
    SPAN_BACKOFF,
    SPAN_QUEUE,
    SPAN_RESIDENT,
    FlightRecorder,
    SLOTracker,
)
from poisson_tpu_torch.geometry.dsl import fingerprint_of
from poisson_tpu_torch.serve.breaker import CircuitBreaker
from poisson_tpu_torch.serve.deadline import Deadline
from poisson_tpu_torch.serve.fleet import (
    WORKER_QUARANTINED,
    WORKER_RUNNING,
    DeviceLossError,
    Worker,
    WorkerCrashError,
    WorkerHangError,
    WorkerPool,
)
from poisson_tpu_torch.serve.placement import PlacementError
from poisson_tpu_torch.krylov import DEFAULT_KRYLOV as DEFAULT_KRYLOV_POLICY
from poisson_tpu_torch.serve.types import (
    ERROR_DIVERGENCE,
    ERROR_INTEGRITY,
    ERROR_INTERNAL,
    ERROR_PLACEMENT,
    ERROR_TRANSIENT,
    OUTCOME_ERROR,
    OUTCOME_RESULT,
    OUTCOME_SHED,
    Outcome,
    SCHED_CONTINUOUS,
    SCHED_DRAIN,
    ServicePolicy,
    SHED_BREAKER_OPEN,
    SHED_DEADLINE_EXPIRED,
    SHED_PREDICTED_DEADLINE,
    SHED_QUEUE_FULL,
    SHED_QUOTA_EXCEEDED,
    SolveRequest,
    TransientDispatchError,
)
from poisson_tpu_torch.utils.platform import device_name, resolve_device


def _host(x) -> np.ndarray:
    """A result field as a host numpy array (the tensor's device may be
    the card)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class _Entry:
    """Queue-resident lifecycle state for one admitted request."""

    __slots__ = ("request", "admitted_at", "deadline", "attempts",
                 "taint", "taint_fp", "not_before", "escalate",
                 "last_failure", "iter_cap", "recovered",
                 "eta", "history", "spi")

    def __init__(self, request: SolveRequest, admitted_at: float,
                 deadline: Optional[Deadline]):
        self.request = request
        self.admitted_at = admitted_at
        self.deadline = deadline
        self.attempts = 0          # dispatches so far
        self.taint: set = set()    # request_ids never to co-batch with again
        # Geometry FINGERPRINTS never to co-batch with again: taint keys
        # on (request, fingerprint), so a geometry family implicated in
        # a batch kill is excluded wholesale — a fresh request carrying
        # the same bad fingerprint cannot re-kill this entry either.
        self.taint_fp: set = set()
        self.not_before = 0.0      # backoff gate (service clock)
        self.escalate = False      # next dispatch via the resilient driver
        self.last_failure = ""
        self.iter_cap = None       # degraded per-member cap (lane splices)
        self.recovered = False     # pulled off a dead worker / the journal
        self.eta = None            # admission forecast p50 ETA (seconds)
        self.history = []          # (k, diff) lane-boundary residual ring
        self.spi = 0.0             # measured seconds/iteration (this entry)


def _geo_fps(entries) -> set:
    """The geometry fingerprints present in a batch of entries —
    the (request, fingerprint) taint unit. Requests with no geometry
    contribute nothing: the 'default' path is not a suspect family
    (request-id taint already isolates those pairs)."""
    return {fingerprint_of(e.request.geometry) for e in entries
            if e.request.geometry is not None}


def _percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over an already-sorted sample."""
    if not sorted_vals:
        return 0.0
    idx = max(0, min(len(sorted_vals) - 1,
                     int(np.ceil(q * len(sorted_vals))) - 1))
    return float(sorted_vals[idx])


def p99_exemplar(outcomes) -> Optional[dict]:
    """The outcome whose latency IS the nearest-rank p99 — the exemplar
    trace id bench records and the fire drill attach, so a p99 number
    is always traceable to the request that paid it (the flight
    recorder's `trace` CLI renders it end to end)."""
    if not outcomes:
        return None
    ranked = sorted(outcomes, key=lambda o: o.latency_seconds)
    idx = max(0, min(len(ranked) - 1,
                     -(-99 * len(ranked) // 100) - 1))   # stdlib ceil
    o = ranked[idx]
    return {"request_id": o.request_id, "trace_id": o.trace_id,
            "latency_seconds": round(o.latency_seconds, 4)}


def slowest_requests(outcomes, n: int = 3) -> list:
    """Top-N slowest outcomes with their latency decompositions — the
    bench/fire-drill ``detail`` block that makes a bad percentile
    diagnosable (where did THIS request's latency go) instead of just
    reportable."""
    ranked = sorted(outcomes, key=lambda o: -o.latency_seconds)[:n]
    return [{"request_id": o.request_id, "trace_id": o.trace_id,
             "latency_seconds": round(o.latency_seconds, 4),
             "kind": o.kind,
             "decomposition": o.decomposition} for o in ranked]


class SolveService:
    """Single-process solve service over the port's solvers.

    ``submit`` admits a request (or sheds it, typed, immediately);
    ``drain`` runs the dispatch loop until every admitted request has its
    outcome. ``clock``/``sleep`` default to real monotonic time; chaos
    scenarios inject a :class:`testing.chaos.VirtualClock` pair.
    ``dispatch_fault`` is the service-level fault seam: called with the
    entry batch immediately before the solver runs, it may raise
    :class:`TransientDispatchError` (a device-level batch kill) or stall
    on the injected clock (a slow worker). ``device`` is where the
    workers' solves run: None means the CUDA cards (raising without
    one), ``"cpu"`` the CPU.
    """

    def __init__(self, policy: Optional[ServicePolicy] = None, *,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Optional[Callable[[float], None]] = None,
                 seed: int = 0,
                 dispatch_fault: Optional[Callable] = None,
                 worker_fault: Optional[Callable] = None,
                 journal=None, device=None):
        # The device the workers are bound to: None means the CUDA
        # cards (raising without one), "cpu" the plain solves on the CPU.
        self._device = resolve_device(device)
        self.policy = policy or ServicePolicy()
        if self.policy.capacity < 1:
            raise ValueError("service capacity must be >= 1")
        if self.policy.retry.max_attempts < 1:
            raise ValueError("retry.max_attempts must be >= 1")
        if self.policy.scheduling not in (SCHED_DRAIN, SCHED_CONTINUOUS):
            raise ValueError(
                f"scheduling must be {SCHED_DRAIN!r} or "
                f"{SCHED_CONTINUOUS!r}, got {self.policy.scheduling!r}"
            )
        if self.policy.refill_chunk < 1:
            raise ValueError("refill_chunk must be >= 1")
        self._clock = clock
        self._sleep = sleep if sleep is not None else time.sleep
        self._rng = random.Random(seed)
        self._dispatch_fault = dispatch_fault
        # The worker-fault seam: called as (worker_id, requests,
        # attempts) right where dispatch_fault is, it may raise
        # WorkerCrashError/WorkerHangError — faults of the WORKER, which
        # quarantine it and recover its in-flight requests, where
        # dispatch faults only cost the dispatch.
        self._worker_fault = worker_fault
        # Write-ahead journal (serve.journal.SolveJournal or None):
        # every lifecycle transition below is recorded before the
        # in-memory ledger moves, so a crash can be replayed.
        self._journal = journal
        self._queue: deque = deque()
        self._delayed: List[_Entry] = []
        self._pending_ids: set = set()  # ids queued or backing off
        self._outcomes: dict = {}
        self._prior_outcomes: dict = {}  # journal-replayed (pre-crash)
        self._recovered_ids: set = set()  # str ids that came via replay
        self._order: List = []          # outcome completion order
        self._latencies: List[float] = []
        self._counts = {"admitted": 0, "completed": 0, "errors": 0,
                        "shed": 0, "recovered": 0}
        # SDC-suspect hardware cohorts (poisson_tpu_torch.integrity): the
        # (backend, device_kind) pairs on which an integrity detection
        # has already fired. With integrity.verify_on_suspect, later
        # dispatches on a tainted cohort run defensively verified even
        # when the policy default is off — a core that miscomputed once
        # is the textbook mercurial core (Hochschild et al. 2021).
        self._suspect_hw: set = set()
        # Basis-holder stickiness (poisson_tpu_torch.krylov.recycle): which
        # worker last harvested/used each geometry fingerprint's
        # deflation basis. Routing prefers the holder for
        # deflation-class heads (serve.krylov.sticky_{hits,misses}) —
        # the second stickiness axis beside bucket executables: on a
        # real fleet the basis lives in the holder's device memory.
        self._basis_holder: dict = {}
        # The worker pool: N dispatch contexts over this one queue and
        # ledger (serve.fleet; workers=1 is the classic single-worker
        # service — same scheduling decisions, same golden outcomes).
        # The pool's device registry (serve.placement) binds every
        # worker to a fault-domain slot; fleet.devices=None keeps the
        # pre-placement topology (one slot, the default device).
        self._pool = WorkerPool(self.policy.fleet, clock=clock,
                                device=self._device)
        self._registry = self._pool.registry
        # The worker whose dispatch is currently on the hot path —
        # single-threaded by design, so hardware-cohort attribution
        # (suspect taint) can name the device without threading the
        # worker through every classification call.
        self._active_worker: Optional[Worker] = None
        # Flight recorder + SLO tracker (obs.flight): per-request causal
        # span trees on the service clock, latency decomposition on
        # every outcome, and the serve.slo.* accounting the degradation
        # ladder may consult. Host-side bookkeeping only — deterministic
        # under VirtualClock, no-op on the JSONL rails when telemetry is
        # unconfigured.
        self._flight = FlightRecorder(clock=clock)
        self._slo = SLOTracker(self.policy.slo, clock=clock)
        # Tenant ledger (serve.tenancy, ServicePolicy.tenancy): quota
        # buckets, deficit-weighted round-robin counters, and retry
        # budgets per tenant — plus one SLOTracker per tenant publishing
        # under serve.tenant.slo.<tenant> so a noisy neighbor's burn is
        # attributable without touching the global serve.slo.* surface.
        # None (the default) is the strict-FIFO service of every prior
        # release, byte-compatible.
        self._tenancy = None
        self._tenant_slo: dict = {}
        self._offender: Optional[str] = None
        if self.policy.tenancy is not None:
            from poisson_tpu_torch.serve.tenancy import TenantLedger

            self._tenancy = TenantLedger(self.policy.tenancy, clock=clock)
        # Iteration forecaster (obs.forecast, ServicePolicy.forecast):
        # per-cohort iteration/cost estimator behind predicted-deadline
        # admission, lane re-forecast preemption, and the ETA backlog
        # gauge. Journal-adjacent snapshot warm-loads across restarts —
        # a recovered service predicts from its previous life's
        # calibration instead of re-entering the cold-model regime.
        self._forecast = None
        if self.policy.forecast is not None:
            from poisson_tpu_torch.obs.forecast import (ForecastModel,
                                                  snapshot_path)

            self._forecast = ForecastModel()
            if self._journal is not None:
                self._forecast.load(snapshot_path(self._journal.path))
        # Roofline observatory (obs.roofline): always-on measured
        # bandwidth attribution — every measured dispatch and lane
        # chunk-step grades its achieved GB/s against the analytic
        # bytes/iter model for its cohort. Observation never changes
        # a solve (the counters-pillar rule), so unlike the
        # forecaster it does not hide behind a policy knob. Its
        # journal-adjacent snapshot warm-loads across restarts for the
        # same reason the forecaster's does: a recovered service routes
        # from its previous life's measured evidence.
        from poisson_tpu_torch.obs.roofline import RooflineModel
        from poisson_tpu_torch.obs.roofline import \
            snapshot_path as _roofline_snapshot

        self._roofline = RooflineModel()
        if self._journal is not None:
            self._roofline.load(_roofline_snapshot(self._journal.path))
        # Backend router (serve.router, ServicePolicy.router): cohort
        # backend choice from the analytic model cold and the roofline
        # profiles warm, with misprediction sentinels demoting
        # (backend, device) arms breaker-style. None = off = every
        # cohort string and program byte-identical to prior releases.
        self._router = None
        self._active_decision = None
        if self.policy.router is not None:
            from poisson_tpu_torch.serve.router import BackendRouter

            self._router = BackendRouter(self.policy.router,
                                         self._roofline, clock=clock)
        if self._journal is not None:
            # The journal opens with this incarnation's topology, so a
            # recovery on a DIFFERENT topology can see the change and
            # remap audibly instead of resuming onto ghost device ids.
            self._journal.record("topology", **self._registry.describe())

    # -- admission -----------------------------------------------------

    def submit(self, request: SolveRequest) -> Optional[Outcome]:
        """Admit ``request`` into the ledger. Returns the typed Outcome
        immediately iff the request was shed at admission (queue full);
        None when it was queued — its outcome arrives via :meth:`drain`.
        Either way the request is admitted for accounting: exactly one
        typed outcome will exist for it.

        With ``policy.dedup`` on, a re-submitted ``request_id`` is an
        idempotent no-op: the original outcome comes back (None while
        still pending), a ``serve.dedup.hits`` is counted, and nothing
        is re-admitted — a client retry or a replayed submission can
        never double-enter the ledger."""
        # The journal stringifies ids, so a recovered/replayed request
        # lives under str(id): a client retry with the original (e.g.
        # int) id must still hit the guard. The str-spelling check is
        # scoped to ids that actually came through a replay
        # (_recovered_ids) — outside recovery, distinct ids that merely
        # collide under str() (1 vs "1") stay distinct requests.
        # Preconditioner validation happens AT ADMISSION, loudly: an MG
        # request on an uncoarsenable grid (odd dimensions) would
        # otherwise burn a dispatch and surface as an opaque internal
        # error; a typo'd preconditioner name must never silently run
        # jacobi. Same caller-bug contract as the duplicate-id check.
        pre = request.preconditioner or self.policy.preconditioner
        if pre not in (None, "jacobi"):
            from poisson_tpu_torch.mg import (
                resolve_preconditioner,
                validate_mg_problem,
            )

            resolve_preconditioner(pre)
            validate_mg_problem(request.problem)
        # Krylov-memory validation, same loud-at-admission contract: an
        # unknown mode / block+deflation never enters the queue, and
        # the uncomposable combinations are caller bugs, not dispatch
        # surprises.
        kp = self._krylov(request)
        if kp != DEFAULT_KRYLOV_POLICY:
            from poisson_tpu_torch.krylov import resolve_krylov

            resolve_krylov(kp)
            if kp.mode == "block" and pre not in (None, "jacobi"):
                raise ValueError(
                    "krylov mode='block' composes with the jacobi body "
                    f"only (preconditioner={pre!r} has no block "
                    "program)")
            if kp.deflation:
                if pre not in (None, "jacobi"):
                    raise ValueError(
                        "krylov deflation composes with the jacobi "
                        f"body only (preconditioner={pre!r} has no "
                        "deflated program)")
                if (request.deadline_seconds is not None
                        or request.chunk is not None):
                    raise ValueError(
                        "krylov deflation does not ride the chunked/"
                        "deadline path yet — drop deadline_seconds/"
                        "chunk or deflation")
        # Session-step validation, same loud-at-admission contract
        # (serve.session): a session step runs the fused session
        # programs — warm restart / implicit-Euler shift — which do not
        # compose with the chunked driver, non-jacobi preconditioner
        # bodies, or Krylov block/deflation memory; and the session
        # fields are meaningless outside a session.
        if request.session_id is not None:
            if kp != DEFAULT_KRYLOV_POLICY:
                raise ValueError(
                    "session steps do not compose with krylov "
                    f"block/deflation (session {request.session_id!r}) "
                    "— the warm-start seam IS the session's solver "
                    "memory")
            if pre not in (None, "jacobi"):
                raise ValueError(
                    "session steps run the fused jacobi session "
                    f"programs only (preconditioner={pre!r})")
            if request.chunk is not None:
                raise ValueError(
                    "session steps are fused single-program solves — "
                    "per-step deadlines are checked at step boundaries; "
                    "drop chunk")
        elif (request.warm_start is not None
              or request.warm_geometry is not None
              or request.session_step is not None
              or request.mass_shift):
            raise ValueError(
                "warm_start/warm_geometry/session_step/mass_shift "
                "require session_id — session semantics do not attach "
                "to per-request traffic")
        # A placement pin outside the fleet topology — or to a healthy
        # device no worker is bound to (the pin could never be served)
        # — is a caller bug, loud at admission (same contract as a
        # typo'd preconditioner). A pin to a device that DIED is
        # admitted and becomes a typed ``placement`` error at dispatch
        # — the silicon's fate is not the caller's mistake.
        if request.device_id is not None:
            pin = int(request.device_id)
            if not 0 <= pin < len(self._registry):
                raise ValueError(
                    f"device_id {request.device_id} outside the fleet "
                    f"topology (devices 0..{len(self._registry) - 1})")
            if (self._registry.is_alive(pin)
                    and not self._pool.workers_on_device(pin)):
                raise ValueError(
                    f"device_id {pin} has no worker bound to it "
                    "(workers bind round-robin over the device slots; "
                    "size fleet.workers >= the highest pinned slot + 1)")
        rid = request.request_id
        recovered_twin = str(rid) in self._recovered_ids
        seen = (rid in self._outcomes or rid in self._prior_outcomes
                or rid in self._pending_ids or recovered_twin)
        if seen:
            if not self.policy.dedup:
                raise ValueError(
                    f"duplicate request_id {request.request_id!r} — the "
                    "one-outcome-per-request ledger needs unique ids"
                )
            obs.inc("serve.dedup.hits")
            obs.event("serve.dedup.hit",
                      request_id=str(request.request_id))
            out = (self._outcomes.get(rid)
                   or self._prior_outcomes.get(rid))
            if out is None and recovered_twin:
                out = (self._outcomes.get(str(rid))
                       or self._prior_outcomes.get(str(rid)))
            return out
        self._counts["admitted"] += 1
        obs.inc("serve.admitted")
        tenant = self._tenant(request)
        if tenant is not None:
            obs.inc(f"serve.tenant.admitted.{tenant}")
        trace_id = self._flight.admit(request.request_id)  # trace root
        if self._journal is not None:
            self._journal.submit(request, trace_id)
        now = self._clock()
        deadline = (Deadline(request.deadline_seconds, clock=self._clock)
                    if request.deadline_seconds is not None else None)
        entry = _Entry(request, now, deadline)
        if self._tenancy is not None and not self._tenancy.admit(tenant):
            # Per-tenant token-bucket quota: over-quota is a typed shed
            # with ZERO compute burned — refused here, before any
            # dispatch, through the same _shed path as queue_full, so
            # the ledger invariant closes unchanged and one hot client
            # cannot convert its overload into everyone's queue time.
            obs.inc("serve.tenant.quota_sheds")
            return self._shed(
                entry, SHED_QUOTA_EXCEEDED,
                f"tenant {tenant!r} over admission quota "
                f"({self.policy.tenancy.quota_rate:g}/s × share "
                f"{self._tenancy.share_of(tenant):g})")
        depth = len(self._queue) + len(self._delayed)
        if depth >= self.policy.capacity:
            return self._shed(entry, SHED_QUEUE_FULL,
                              "admission queue at capacity "
                              f"({self.policy.capacity})")
        if self._forecast is not None:
            fc = self._forecast_predict(request)
            entry.eta = fc.eta_p50_seconds
            fp = self.policy.forecast
            if fp.admission_shed and deadline is not None:
                # Predicted-deadline admission: a request whose p90 ETA
                # already exceeds its budget is shed HERE, typed, with
                # zero compute burned — never admitted-then-doomed.
                obs.inc("serve.forecast.admission_checks")
                if fc.eta_p90_seconds * fp.margin > request.deadline_seconds:
                    self._flight.point(
                        request.request_id, POINT_FORECAST_SHED,
                        eta=round(fc.eta_p90_seconds, 6),
                        deadline=request.deadline_seconds)
                    return self._shed(
                        entry, SHED_PREDICTED_DEADLINE,
                        f"p90 ETA {fc.eta_p90_seconds:.3g}s exceeds "
                        f"deadline {request.deadline_seconds:.3g}s "
                        f"(cohort {fc.cohort}, "
                        f"{'cold' if fc.cold else 'calibrated'} model)")
        self._pending_ids.add(request.request_id)
        if tenant is not None:
            self._flight.begin(request.request_id, SPAN_QUEUE,
                               tenant=tenant)
        else:
            self._flight.begin(request.request_id, SPAN_QUEUE)
        self._queue.append(entry)
        obs.gauge("serve.queue_depth", len(self._queue) + len(self._delayed))
        return None

    # -- lifecycle loop ------------------------------------------------

    def drain(self) -> List[Outcome]:
        """Run the dispatch loop until no admitted request is pending;
        returns every outcome reached during this drain, in completion
        order. Publishes the ``serve.*`` stats gauges afterwards."""
        start = len(self._order)
        while self.pump():
            pass
        self._publish_stats()
        return [self._outcomes[rid] for rid in self._order[start:]]

    def pump(self) -> bool:
        """One scheduling step of the configured engine — a full
        dispatch in drain mode, one chunk-and-refill cycle in continuous
        mode. Returns False when no admitted request is pending. This is
        the open-loop seam: a load generator interleaves ``submit`` with
        ``pump`` so arrivals can join work already in flight
        (``bench.py --serve --arrival-rate``).

        With a multi-worker fleet, each pump schedules ONE worker
        (sticky-preferred, else round-robin), restarting due-quarantined
        workers through warm-up first; with no runnable worker the pump
        either waits out the earliest quarantine or — the whole fleet
        dead — fails the remaining backlog with typed internal errors,
        so the ledger invariant survives even total fleet loss."""
        self._restart_due_workers()
        if self._tenancy is not None:
            # Weighted-fair head selection happens ONCE per pump,
            # before any head-based routing (placement pin, basis
            # stickiness, sticky cohort) reads queue[0]: pull due
            # backed-off entries in first so the DWRR pick sees the
            # real backlog, then rotate the picked tenant's oldest
            # entry to the head. FIFO order *within* a tenant is
            # preserved — shares reorder across tenants only.
            self._pump_delayed()
            self._promote_tenant_head()
        pinned = self._pinned_head_worker()
        if pinned is not None:
            worker, verdict = pinned
            if worker is None:
                return verdict       # head errored typed / waited out
        else:
            worker = (self._basis_sticky_worker()
                      or self._pool.next_worker(self._head_cohort()))
        if worker is None:
            return self._no_worker_step()
        # Beat only when the step has work: the beat marks the step's
        # START (the baseline the post-step stall check measures from),
        # and an idle open-loop pump must neither flood the telemetry
        # rails with no-op beats nor let idle wait read as a stall.
        active = bool(self._queue or self._delayed
                      or (worker.table is not None
                          and worker.table.occupied()))
        if active:
            worker.watchdog.beat(worker=worker.id)
        # The scheduled worker is the hardware-attribution context for
        # everything this step does (dispatch, retire classification,
        # suspect-cohort taint) — see _hw_cohort.
        self._active_worker = worker
        try:
            if self.policy.scheduling == SCHED_CONTINUOUS:
                progressed = self._step_continuous(worker)
            else:
                progressed = self._step(worker)
        finally:
            self._active_worker = None
        if active:
            self._post_step_health(worker)
        return progressed

    # -- fleet supervision ---------------------------------------------

    @property
    def _table(self):
        """Worker 0's live lane table — the pre-fleet single-worker
        view (tables are per worker now; multi-worker callers inspect
        ``self._pool.workers[i].table``)."""
        return self._pool.workers[0].table

    def _head_cohort(self) -> Optional[str]:
        if not self._queue:
            return None
        return self._cohort(self._queue[0].request)

    # -- tenant isolation (serve.tenancy) ------------------------------

    def _tenant(self, request: SolveRequest) -> Optional[str]:
        """The request's ledger tenant — None iff tenancy is off (the
        tenant field is then inert metadata, costing nothing)."""
        if self._tenancy is None:
            return None
        return self._tenancy.resolve(request.tenant)

    def _tenant_slo_tracker(self, tenant: str) -> SLOTracker:
        tracker = self._tenant_slo.get(tenant)
        if tracker is None:
            tracker = SLOTracker(self.policy.slo, clock=self._clock,
                                 prefix=f"serve.tenant.slo.{tenant}")
            self._tenant_slo[tenant] = tracker
        return tracker

    def _promote_tenant_head(self) -> None:
        """Deficit-weighted round-robin head selection: rotate the
        picked tenant's oldest queued entry to the queue front. One
        pick per pump — over any window the dispatch-head mix
        converges to the share vector regardless of arrival order."""
        if len(self._queue) < 2:
            return
        backlogged = sorted({self._tenant(e.request) for e in self._queue})
        if len(backlogged) < 2:
            return
        pick = self._tenancy.pick(backlogged)
        if self._tenant(self._queue[0].request) == pick:
            return
        for i, entry in enumerate(self._queue):
            if self._tenant(entry.request) == pick:
                del self._queue[i]
                self._queue.appendleft(entry)
                obs.inc("serve.tenant.promotions")
                return

    def _tenant_offender(self) -> Optional[str]:
        """The tenant whose backlog most exceeds its share — the one
        the degradation ladder downshifts first (tenant-scoped
        Hochschild-style indictment: blame the client, not the
        queue)."""
        backlog: dict = {}
        for entry in list(self._queue) + self._delayed:
            t = self._tenant(entry.request)
            backlog[t] = backlog.get(t, 0) + 1
        return self._tenancy.offender(backlog)

    def _tenant_level(self, entry: _Entry, level: int,
                      count: bool = False) -> int:
        """Tenant-scoped degradation: the offending tenant pays the
        full queue-pressure rung, every other tenant runs one rung
        gentler (``TenancyPolicy.isolate_degradation``). ``count``
        makes the spared/charged decision audible — set only at the
        application sites (dispatch, lane splice), not in cohort
        probes, so the counters read as decisions, not scans."""
        if (self._tenancy is None or level <= 0
                or not self.policy.tenancy.isolate_degradation
                or self._offender is None):
            return level
        if self._tenant(entry.request) == self._offender:
            if count:
                obs.inc("serve.tenant.degraded_offender")
            return level
        if count:
            obs.inc("serve.tenant.degraded_spared")
        return max(0, level - 1)

    def _pinned_head_worker(self):
        """Placement-pinned head scheduling. None: the head is unpinned
        (or no head) — ordinary routing applies. Otherwise a
        ``(worker, progressed)`` pair: a live worker bound to the
        pinned device, or ``(None, True)`` when the step was consumed
        resolving the pin — a dead device or a worker-less domain is a
        typed ``placement`` error (never a wedge), a quarantined
        domain waits out the earliest release."""
        if not self._queue or self._queue[0].request.device_id is None:
            return None
        pin = int(self._queue[0].request.device_id)
        if not self._registry.is_alive(pin):
            head = self._queue.popleft()
            self._error(head, ERROR_PLACEMENT,
                        f"pinned device {pin} is lost (placement epoch "
                        f"{self._registry.epoch})")
            return (None, True)
        bound = self._pool.workers_on_device(pin)
        live = [w for w in bound if w.state == WORKER_RUNNING]
        if live:
            return (live[0], True)
        waiting = [w.quarantined_until for w in bound
                   if w.state == WORKER_QUARANTINED]
        if waiting:
            self._sleep(max(0.0, min(waiting) - self._clock()))
            return (None, True)
        head = self._queue.popleft()
        self._error(head, ERROR_PLACEMENT,
                    f"no live worker bound to pinned device {pin} "
                    f"({len(bound)} bound)")
        return (None, True)

    def _basis_sticky_worker(self):
        """Soft routing preference for deflation-class heads: the
        worker that last held this fingerprint's basis, when it is
        still RUNNING (serve.krylov.sticky_hits); otherwise ordinary
        routing applies (serve.krylov.sticky_misses — counted only for
        deflation heads with a recorded holder, so the ratio reads as
        basis-affinity effectiveness, not as generic routing traffic).
        None: not a deflation head, or no preference."""
        if not self._queue:
            return None
        head = self._queue[0]
        if not self._krylov(head.request).deflation:
            return None
        holder = self._basis_holder.get(
            fingerprint_of(head.request.geometry))
        if holder is None:
            return None
        for w in self._pool.workers:
            if w.id == holder and w.state == WORKER_RUNNING:
                obs.inc("serve.krylov.sticky_hits")
                return w
        obs.inc("serve.krylov.sticky_misses")
        return None

    def _restart_due_workers(self) -> None:
        for worker in self._pool.release_due():
            sticky = self._pool.restart(worker)
            if sticky:
                self._warm_worker(worker, sticky)

    def _note_sticky(self, worker: Worker, cohort: str, problem, dtype,
                     bucket=None, preconditioner: str = "jacobi") -> None:
        """Record that ``worker`` holds ``cohort``'s executable at
        ``bucket`` width — what routing prefers and restart warm-up
        runs again (the preconditioner is part of the solve's identity,
        so the warm-up must run the same solve family)."""
        info = worker.sticky.setdefault(
            cohort, {"problem": problem, "dtype": dtype, "buckets": set(),
                     "preconditioner": preconditioner})
        if bucket:
            info["buckets"].add(int(bucket))

    def _device_of(self, worker: Optional[Worker]):
        """The device a worker's solves run on: its BOUND placement
        device (warm-ups, dispatches and lane tables all land on the
        silicon the worker lives on), else the service's device. The
        port has no ambient device, so every solver call takes it as
        ``device=``."""
        if worker is None or worker.placement is None \
                or worker.placement.device is None:
            return self._device
        return worker.placement.device

    def _warm_worker(self, worker: Worker, sticky: dict) -> None:
        """Restart warm-up: run each sticky bucket once — at the widths
        the worker actually dispatched, with degenerate zero-gate
        members, ON the worker's bound device (a rebound worker's
        buckets must run where the worker now does) — before the worker
        takes traffic: a
        restarted worker must not absorb first-call costs (allocator
        growth, setup caches) into the first real request's latency."""
        from poisson_tpu_torch.solvers.batched import solve_batched

        for cohort, info in sticky.items():
            for width in sorted(info["buckets"]) or [1]:
                try:
                    solve_batched(info["problem"],
                                  rhs_gates=[0.0] * width,
                                  dtype=info["dtype"], bucket=width,
                                  preconditioner=info.get(
                                      "preconditioner", "jacobi"),
                                  device=self._device_of(worker))
                    obs.inc("serve.fleet.warmup_solves")
                except Exception as e:   # warm-up is best-effort
                    obs.inc("serve.fleet.warmup_failures")
                    obs.event("serve.fleet.warmup_failure",
                              worker=worker.id, cohort=cohort,
                              bucket=width,
                              error=f"{type(e).__name__}: {e}")
        obs.event("serve.fleet.warmed", worker=worker.id,
                  cohorts=len(sticky),
                  device=(worker.placement.device_id
                          if worker.placement else None))

    def _post_step_health(self, worker: Worker) -> None:
        """After a step that did NOT raise a worker fault: the heartbeat
        may still show the step overran the watchdog (a slow wedge that
        eventually returned). Quarantine post hoc — outcomes the step
        produced stand; the worker does not take more traffic until it
        restarts."""
        if worker.state != WORKER_RUNNING:
            return
        if worker.watchdog.check() is not None:
            obs.inc("serve.fleet.hangs")
            self._quarantine_worker(worker, "stall")

    def _quarantine_worker(self, worker: Worker, reason: str) -> None:
        """Quarantine ``worker``, recovering any lane occupants it still
        holds (their in-flight progress died with the worker)."""
        evicted = []
        if worker.table is not None:
            evicted = worker.table.evict_all()
            worker.table = None
            for entry in evicted:
                self._flight.end(entry.request.request_id, SPAN_RESIDENT,
                                 error=reason)
        self._pool.quarantine(worker, reason)
        if evicted:
            self._recover_entries(worker, evicted, reason)

    def _recover_entries(self, worker: Worker, entries: List[_Entry],
                         reason: str) -> None:
        """Re-dispatch a fallen worker's in-flight requests to the
        survivors: mutual taint (the worker's death may have been one of
        them), recovery backoff, ``recovered``/``quarantine`` flight
        points — then the ordinary retry budget decides retry vs typed
        error."""
        co_ids = {e.request.request_id for e in entries}
        co_fps = _geo_fps(entries)
        for entry in entries:
            rid = entry.request.request_id
            entry.recovered = True
            obs.inc("serve.fleet.recovered_requests")
            self._flight.point(rid, POINT_QUARANTINE, worker=worker.id,
                               reason=reason)
            self._flight.point(rid, POINT_RECOVERED, worker=worker.id,
                               reason=reason)
            self._retry_or_fail(entry, ERROR_TRANSIENT,
                                f"worker {worker.id} {reason} "
                                "mid-dispatch", co_ids - {rid}, co_fps)

    def _handle_worker_fault(self, worker: Worker, exc: Exception,
                             entries: List[_Entry], did: str,
                             t0: float) -> None:
        """A dispatch raised a worker-level fault: close the affected
        flight spans, evict any lane occupants the worker still holds
        (a solo dispatch can crash a worker whose lane table is live),
        quarantine it, and recover everything onto the survivors. A
        :class:`DeviceLossError` widens the blast radius to the fault
        DOMAIN: the device is marked lost in the placement registry
        (epoch bump), every worker bound to it is quarantined with its
        lane occupants, and the quarantined workers rebind to
        surviving devices at restart."""
        hang = isinstance(exc, WorkerHangError)
        loss = isinstance(exc, DeviceLossError)
        reason = "device_loss" if loss else ("hang" if hang else "crash")
        if hang and worker.watchdog.check() is not None:
            obs.inc("serve.fleet.hangs")
        self._flight_dispatch_failed(entries, did, t0,
                                     type(exc).__name__)
        extra = []
        if worker.table is not None:
            known = {id(e) for e in entries}
            extra = [e for e in worker.table.evict_all()
                     if id(e) not in known]
            worker.table = None
            for entry in extra:
                self._flight.end(entry.request.request_id, SPAN_RESIDENT,
                                 error=type(exc).__name__)
        self._pool.quarantine(worker, reason)
        if loss:
            extra = extra + self._lose_device(worker, exc)
        self._recover_entries(worker, list(entries) + extra, reason)

    def _lose_device(self, worker: Worker, exc: DeviceLossError
                     ) -> List[_Entry]:
        """The fault domain died, not just the dispatching worker: mark
        the device lost (placement epoch bump, ``serve.fleet.
        device_losses``), quarantine every OTHER running worker bound
        to it, and return their evicted lane occupants — all of whom
        shared the silicon that is gone."""
        device_id = exc.device_id
        if device_id is None and worker.placement is not None:
            device_id = worker.placement.device_id
        if device_id is None:
            return []
        if self._registry.lose(int(device_id)):
            obs.inc("serve.fleet.device_losses")
            obs.event("serve.fleet.device_loss", device=int(device_id),
                      worker=worker.id, epoch=self._registry.epoch,
                      alive=len(self._registry.alive()))
        if self._journal is not None:
            self._journal.record("device_loss", device=int(device_id),
                                 epoch=self._registry.epoch)
        evicted: List[_Entry] = []
        for mate in self._pool.workers_on_device(int(device_id)):
            if mate is worker or mate.state != WORKER_RUNNING:
                continue
            if mate.table is not None:
                for entry in mate.table.evict_all():
                    self._flight.end(entry.request.request_id,
                                     SPAN_RESIDENT, error="device_loss")
                    evicted.append(entry)
                mate.table = None
            self._pool.quarantine(mate, "device_loss")
        return evicted

    def _no_worker_step(self) -> bool:
        """No runnable worker. Wait out the earliest quarantine when one
        will come back; with the whole fleet dead, every pending request
        still gets its one typed outcome — as an internal error."""
        release = self._pool.earliest_release()
        if release is not None:
            if not self._pending_ids:
                return False
            self._sleep(max(0.0, release - self._clock()))
            return True
        if not self._pool.all_dead():
            return bool(self._pending_ids)
        self._pump_delayed()
        while self._delayed:          # backoff cannot outlive the fleet
            self._queue.append(self._delayed.pop(0))
        progressed = False
        while self._queue:
            entry = self._queue.popleft()
            self._error(entry, ERROR_INTERNAL,
                        "no live workers: every worker in the fleet is "
                        "dead (restart budget exhausted)")
            progressed = True
        return progressed

    def _advance_past_backoff(self) -> bool:
        """Everything runnable is backing off: advance to the earliest
        ready time (virtual clocks advance instantly; real clocks
        sleep), force-promoting afterwards so a coarse injected clock
        can never wedge the loop. Returns False when nothing is pending
        at all."""
        if not self._delayed:
            return False
        wait = max(0.0, min(e.not_before for e in self._delayed)
                   - self._clock())
        self._sleep(wait)
        self._pump_delayed()
        if not self._queue and self._delayed:
            self._delayed.sort(key=lambda e: e.not_before)
            head = self._delayed.pop(0)
            self._end_backoff(head)
            self._queue.append(head)
        return True

    def _pop_live_head(self) -> Optional[_Entry]:
        """Pop the queue head; a head whose deadline died while queued
        is shed typed here (returns None — the ledger entry is closed)."""
        head = self._queue.popleft()
        if head.deadline is not None and head.deadline.expired():
            obs.inc("serve.deadline.expired_in_queue")
            self._flight.point(head.request.request_id, POINT_DEADLINE,
                               where="queued",
                               elapsed=round(head.deadline.elapsed(), 4))
            self._shed(head, SHED_DEADLINE_EXPIRED,
                       "deadline expired while queued")
            return None
        return head

    def _step(self, worker: Worker) -> bool:
        self._pump_delayed()
        if not self._queue and not self._advance_past_backoff():
            return False
        head = self._pop_live_head()
        if head is None:
            return True
        # Load is measured at dispatch-cycle start (head included), BEFORE
        # batch formation empties the queue — degradation responds to the
        # pressure the service is under, not to the hole a big batch just
        # carved out of it.
        level = self._load_level(len(self._queue) + len(self._delayed) + 1)
        batch = self._form_batch(head)
        breaker = self._breaker(worker, self._cohort(head.request))
        if not breaker.allow():
            for entry in batch:
                self._shed(entry, SHED_BREAKER_OPEN,
                           f"circuit breaker open for cohort "
                           f"{self._cohort(entry.request)}")
            return True
        self._dispatch(worker, batch, breaker, level)
        return True

    def _pump_delayed(self) -> None:
        now = self._clock()
        ready = [e for e in self._delayed if e.not_before <= now]
        if ready:
            self._delayed = [e for e in self._delayed
                             if e.not_before > now]
            for e in ready:
                self._end_backoff(e)
            self._queue.extend(ready)

    def _end_backoff(self, entry: _Entry) -> None:
        """Backoff over, back in line: the flight-recorder transition
        every promotion path (timer pump OR forced) must take."""
        rid = entry.request.request_id
        self._flight.end(rid, SPAN_BACKOFF)
        self._flight.begin(rid, SPAN_QUEUE, attempt=entry.attempts + 1)

    # -- batching ------------------------------------------------------

    def _precond(self, request: SolveRequest) -> str:
        """The request's effective preconditioner: its own knob, else
        the service default."""
        return request.preconditioner or self.policy.preconditioner

    def _krylov(self, request: SolveRequest):
        """The request's effective Krylov-memory policy
        (:mod:`poisson_tpu_torch.krylov`): its own knob, else the service
        default."""
        return request.krylov or self.policy.krylov

    def _krylov_marker(self, request: SolveRequest) -> str:
        """The cohort suffix the Krylov policy contributes: ``:blk``
        (block bucket executables) / ``:defl`` (deflated solo
        dispatch) split executables, breakers, and — downstream —
        sentinel baselines, exactly like the ``:mg`` marker: a block
        or deflated rollout never indicts the independent fleet, and
        vice versa. The default policy contributes nothing — historical
        cohort strings byte-for-byte."""
        kp = self._krylov(request)
        if kp.mode == "block":
            return ":blk"
        if kp.deflation:
            return ":defl"
        return ""

    def _backend_token(self, request: SolveRequest) -> str:
        """The backend segment of the cohort string. Router off (the
        default) this is the literal ``"torch"`` (the JAX package's
        ``"xla"``, renamed by ``serve.router.JAX_ARM_NAMES``). Router
        on, it is the arm
        the router would pick for this request (the pure ``peek``:
        cohort labeling must not tick decision counters or consume
        half-open probes), so auto-routed traffic forms per-backend
        cohorts — its breakers, sentinel baselines, and regression
        records never blend with hand-picked ones."""
        if self._router is None:
            return "torch"
        return self._router.peek(**self._roofline_args(request),
                                 device_id=self._hw_cohort()[2])

    def _cohort(self, request: SolveRequest) -> str:
        p = request.problem
        base = (f"{p.M}x{p.N}:{request.dtype or 'auto'}:"
                f"{self._backend_token(request)}")
        # MG requests are their own cohort family: different
        # executables (V-cycle in the body), different cost
        # profile, so their own breaker state and — downstream — their
        # own sentinel baselines (benchmarks/regress.py): an MG rollout
        # never indicts the Jacobi fleet, and vice versa.
        if self._precond(request) == "mg":
            base += ":mg"
        base += self._krylov_marker(request)
        # Geometry requests form their own cohorts — the executable
        # family differs (stacked canvases) — but the FINGERPRINT stays
        # out of the key: different geometries on the same grid share
        # the cohort, the bucket executable, and the breaker, which is
        # the mixed-geometry co-batching seam. (Block cohorts are the
        # one exception to fingerprint-blind batch FORMATION — the
        # block recurrence needs one shared operator, so _form_batch
        # additionally requires fingerprint uniformity there — but the
        # cohort string still never carries the fingerprint.)
        return base + (":geo" if request.geometry is not None else "")

    # -- convergence forecasting (obs.forecast) ------------------------

    def _forecast_args(self, request: SolveRequest) -> dict:
        """The cohort-model keyword set for this request — the cold
        analytic seed needs the grid, precision, and device kind the
        dispatch would actually run with."""
        from poisson_tpu_torch.solvers.pcg import resolve_dtype

        dtype = resolve_dtype(request.dtype)
        p = request.problem
        return {
            "M": p.M, "N": p.N,
            "dtype_bytes": 8 if dtype == "float64" else 4,
            "scaled": dtype != "float64",
            "device_kind": self._hw_cohort()[1],
        }

    def _forecast_predict(self, request: SolveRequest):
        return self._forecast.predict(self._cohort(request),
                                      **self._forecast_args(request))

    def _forecast_observe(self, entry: _Entry, iterations: int,
                          compute_s: float) -> None:
        """Feed one completed solve back into the cohort model and
        persist the snapshot beside the journal (best-effort, atomic) so
        a recovered service warm-starts its calibration."""
        self._forecast.observe(self._cohort(entry.request),
                               iterations, compute_s,
                               **self._forecast_args(entry.request))
        if self._journal is not None:
            from poisson_tpu_torch.obs.forecast import snapshot_path

            self._forecast.save(snapshot_path(self._journal.path))

    def _forecast_backlog(self) -> float:
        """Predicted seconds of queued work — the sum of every waiting
        entry's admission-time p50 ETA. The degradation ladder's
        backlog-seconds rung keys on this, and it is published as
        ``serve.forecast.backlog_seconds`` either way."""
        backlog = sum(e.eta or 0.0 for e in self._queue)
        backlog += sum(e.eta or 0.0 for e in self._delayed)
        obs.gauge("serve.forecast.backlog_seconds", round(backlog, 6))
        return backlog

    # -- roofline observatory + backend router (obs.roofline) ----------

    def _roofline_args(self, request: SolveRequest, batch: int = 1,
                       verify_every: Optional[int] = None) -> dict:
        """The roofline-cohort keyword set for one request — the full
        dispatch identity the measured fraction is attributed to."""
        from poisson_tpu_torch.solvers.pcg import resolve_dtype

        p = request.problem
        if verify_every is None:
            verify_every = self._verify_params()[0]
        return {
            "M": p.M, "N": p.N, "batch": max(1, int(batch)),
            "dtype_bytes": (8 if resolve_dtype(request.dtype)
                            == "float64" else 4),
            "preconditioner": self._precond(request) or "jacobi",
            "verify_every": int(verify_every),
            "device_kind": self._hw_cohort()[1],
        }

    def _observe_roofline(self, request: SolveRequest, *,
                          iterations: int, seconds: float,
                          batch: int = 1, verify_every: int = 0,
                          backend: Optional[str] = None) -> None:
        """Feed one measured dispatch into the roofline observatory,
        grade it through the router's misprediction sentinel (when the
        router made the call — lane chunk-steps always run the torch
        engine and are never graded against a routed arm), and persist
        the profile snapshot beside the journal. Unmeasurable
        dispatches (zero wall — VirtualClock) produce no sample, no
        grade, no write."""
        decision = self._active_decision
        if backend is None:
            backend = (decision.backend if decision is not None
                       else "torch")
        sample = self._roofline.observe(
            backend=backend, iterations=int(iterations),
            seconds=float(seconds),
            **self._roofline_args(request, batch=batch,
                                  verify_every=verify_every))
        if (self._router is not None and decision is not None
                and decision.backend == backend):
            self._router.grade(decision, sample)
        if sample is not None and self._journal is not None:
            from poisson_tpu_torch.obs.roofline import snapshot_path

            self._roofline.save(snapshot_path(self._journal.path))

    def _reforecast_doomed(self, entry: _Entry, view, table) -> bool:
        """Mid-flight ETA check for a lane occupant: fit the convergence
        rate to the entry's lane-boundary residual history, extrapolate
        iterations-to-δ, and price them with the entry's own measured
        seconds/iteration (cohort/analytic model when unmeasured — the
        VirtualClock case). Unknown rate never preempts: blind eviction
        of converging work would be worse than a deadline partial."""
        from poisson_tpu_torch.obs import forecast as fcast

        slope = fcast.log_residual_slope(entry.history)
        rem = fcast.remaining_iterations(float(view["diff"]),
                                         float(table.problem.delta),
                                         slope)
        if rem is None:
            return False
        spi = entry.spi
        if spi <= 0.0:
            spi = self._forecast_predict(
                entry.request).seconds_per_iteration
        eta = rem * spi
        remaining = entry.deadline.remaining()
        if remaining is None:
            return False
        rid = entry.request.request_id
        self._flight.annotate(
            rid, SPAN_RESIDENT, eta=round(eta, 6),
            progress=round(fcast.progress_fraction(
                int(view["k"]), int(view["k"]) + rem), 3))
        doomed = eta * self.policy.forecast.margin > max(0.0, remaining)
        if doomed:
            self._flight.point(rid, POINT_REFORECAST, k=int(view["k"]),
                               eta=round(eta, 6),
                               remaining=round(max(0.0, remaining), 6))
        return doomed

    def _hw_cohort(self) -> tuple:
        """The (backend, device_kind, device_id) triple integrity
        suspicion taints — hardware identity at placement granularity:
        a bit flip indicts the PART it ran on (Hochschild 2021), so the
        suspicion keys on the dispatching worker's bound fault domain,
        and only the request cohorts sharing that device inherit it —
        a flip on device 3 never arms defensive verification on device
        5's dispatches. Outside a dispatch (no active worker) the
        process default device stands in."""
        worker = self._active_worker
        if worker is not None and worker.placement is not None:
            p = worker.placement
            return ("torch", p.device_kind, p.device_id)
        if not hasattr(self, "_hw_cohort_cache"):
            self._hw_cohort_cache = ("torch", device_name(self._device), 0)
        return self._hw_cohort_cache

    def _verify_params(self, entries=()) -> tuple:
        """The (verify_every, verify_tol) the next dispatch touching
        ``entries`` should run with: the policy's always-on stride when
        set; else — with ``verify_on_suspect`` — the defensive
        ``suspect_verify_every`` when this process's hardware cohort is
        already SDC-suspect or any entry is an integrity-class retry
        (its redo must be able to defend itself). (0, None) means no
        probe runs: the flag-off solves are the plain ones."""
        pol = self.policy.integrity
        if pol.verify_every > 0:
            return int(pol.verify_every), pol.verify_tol
        suspect_retry = any(e.last_failure == ERROR_INTEGRITY
                            for e in entries)
        if pol.verify_on_suspect and (
                suspect_retry or self._hw_cohort() in self._suspect_hw):
            return int(pol.suspect_verify_every), pol.verify_tol
        return 0, None

    def _count_defensive_verify(self, verify_every: int) -> None:
        """A dispatch armed the probe only because of suspicion (the
        policy default is off) — the audible record of paying the
        defense after the first strike."""
        if verify_every and not self.policy.integrity.verify_every:
            obs.inc("serve.integrity.suspect_dispatches")

    def _taint_suspect_hw(self) -> None:
        """First integrity detection on this hardware cohort: taint it.
        Idempotent — the counter counts cohorts, not detections."""
        cohort = self._hw_cohort()
        if cohort not in self._suspect_hw:
            self._suspect_hw.add(cohort)
            obs.inc("serve.integrity.suspect_cohorts")
            obs.event("serve.integrity.suspect_cohort",
                      backend=cohort[0], device_kind=cohort[1],
                      device=cohort[2])
            # A deflation basis harvested on a flip-suspect part is not
            # evidence: drop it so warm solves rebuild on trusted
            # silicon (krylov.cache.invalidations, audible).
            from poisson_tpu_torch.krylov.recycle import invalidate

            invalidate(hw=cohort, reason="sdc-suspect-cohort")

    def _breaker(self, worker: Worker, cohort: str) -> CircuitBreaker:
        """The ``worker``'s breaker for ``cohort``: breaker state is
        keyed per worker cohort (a wedged worker trips its own breakers,
        not the fleet's)."""
        if cohort not in worker.breakers:
            worker.breakers[cohort] = CircuitBreaker(
                self.policy.breaker, clock=self._clock, cohort=cohort)
        return worker.breakers[cohort]

    def _solo(self, entry: _Entry) -> bool:
        """Chunked single-request dispatch classes: deadline-carrying
        (expiry needs chunk boundaries), explicitly chunked, escalated
        divergence retries (the resilient driver is single-request),
        deflation-enabled requests (the fingerprint-keyed solver
        memory is a single-request program — ``krylov.recycle``),
        MG+geometry requests (per-member hierarchies do not co-batch —
        ``solvers.batched`` rejects the combination loudly, so the
        service routes it through the chunked solo path instead), or
        placement-pinned requests (the pin binds the dispatch to one
        worker's device; co-batched members would inherit it
        silently)."""
        return (entry.deadline is not None
                or entry.request.chunk is not None
                or entry.escalate
                or entry.request.device_id is not None
                or entry.request.session_id is not None
                or self._krylov(entry.request).deflation
                or (entry.request.geometry is not None
                    and self._precond(entry.request) == "mg"))

    def _form_batch(self, head: _Entry) -> List[_Entry]:
        if self._solo(head):
            return [head]
        cohort = self._cohort(head.request)
        # Block cohorts batch one OPERATOR: the block recurrence is
        # only defined for a shared A, so candidates must match the
        # head's geometry fingerprint exactly (the one deliberate
        # exception to fingerprint-blind batch formation).
        block = self._krylov(head.request).mode == "block"
        head_fp = fingerprint_of(head.request.geometry)
        batch = [head]
        ids = {head.request.request_id}
        taints = set(head.taint)
        # Fingerprint-keyed exclusion, both directions: the batch's
        # accumulated geometry fingerprints vs the candidate's taint
        # list, and the candidate's fingerprint vs the batch's.
        fps = {head_fp}
        taint_fps = set(head.taint_fp)
        kept = deque()
        while self._queue and len(batch) < self.policy.max_batch:
            e = self._queue.popleft()
            e_fp = fingerprint_of(e.request.geometry)
            compatible = (
                not self._solo(e)
                and self._cohort(e.request) == cohort
                and (not block or e_fp == head_fp)
                and e.request.request_id not in taints
                and not (ids & e.taint)
                and e_fp not in taint_fps
                and not (fps & e.taint_fp)
            )
            if compatible:
                batch.append(e)
                ids.add(e.request.request_id)
                taints |= e.taint
                fps.add(e_fp)
                taint_fps |= e.taint_fp
            else:
                kept.append(e)
        kept.extend(self._queue)
        self._queue = kept
        return batch

    def _load_level(self, depth: int) -> int:
        frac = depth / self.policy.capacity
        d = self.policy.degradation
        level = 0
        if frac >= d.shrink_padding_at:
            level = 1
        if frac >= d.cap_iterations_at:
            level = 2
        if frac >= d.downshift_precision_at:
            level = 3
        # SLO-driven rung (opt-in, SLOPolicy.degrade_on_burn): when the
        # multi-window burn rate asks for a deeper downshift than queue
        # depth does, the burn wins — the ladder responds to the
        # objective being missed, not only to backlog. Audible as its
        # own counter so an SLO-triggered downshift is attributable.
        slo_level = self._slo.degrade_level()
        if slo_level > level:
            obs.inc("serve.degraded.slo_driven")
            level = slo_level
        # Predicted-backlog rung (opt-in, ForecastPolicy
        # .backlog_degradation): the ladder can respond to SECONDS of
        # queued work, not only request count — ten 4096² solves are a
        # deeper backlog than a hundred 64² ones. The backlog objective
        # normalizes ETA-seconds onto the same fractional thresholds the
        # depth rungs use; audible as its own counter.
        fp = self.policy.forecast
        if self._forecast is not None and fp.backlog_degradation:
            bfrac = (self._forecast_backlog()
                     / max(1e-9, fp.backlog_objective_seconds))
            blevel = 0
            if bfrac >= d.shrink_padding_at:
                blevel = 1
            if bfrac >= d.cap_iterations_at:
                blevel = 2
            if bfrac >= d.downshift_precision_at:
                blevel = 3
            if blevel > level:
                obs.inc("serve.degraded.backlog_driven")
                level = blevel
        if self._tenancy is not None:
            # Recompute the degradation offender once per level read —
            # _tenant_level then consults the cached verdict at every
            # application site without rescanning the queue.
            self._offender = self._tenant_offender()
        return level

    # -- continuous batching (lane table + refill state machine) -------

    def _lane_eligible(self, entry: _Entry) -> bool:
        """Continuous mode: deadline-carrying requests ride lanes (the
        engine's chunk boundary IS the deadline check), so only
        explicitly-chunked requests, escalated divergence retries (the
        resilient driver is single-request), Krylov-memory requests
        (the block recurrence couples members — it cannot step
        per-lane; deflation is a single-request program), and
        MG+geometry requests (per-lane hierarchies do not exist yet)
        still dispatch through the drain-mode machinery."""
        kp = self._krylov(entry.request)
        return (entry.request.chunk is None and not entry.escalate
                and entry.request.device_id is None
                and entry.request.session_id is None
                and kp.mode == "independent" and not kp.deflation
                and not (entry.request.geometry is not None
                         and self._precond(entry.request) == "mg"))

    def _effective_dtype(self, entry: _Entry, level: int) -> str:
        """The dtype a lane splice would run this entry at — the
        degradation ladder's precision downshift applied at the refill
        decision, re-checked every time rather than once per batch."""
        dtype = entry.request.dtype or "auto"
        if level >= 3 and dtype == "float64":
            return "float32"
        return dtype

    def _lane_cohort(self, entry: _Entry, level: int) -> str:
        # Tenant-scoped rung first (no-op with tenancy off): a spared
        # tenant's float64 must not downshift — and must not be spliced
        # into a downshifted table — just because the offender's rung
        # says 3.
        level = self._tenant_level(entry, level)
        p = entry.request.problem
        base = f"{p.M}x{p.N}:{self._effective_dtype(entry, level)}:torch"
        if self._precond(entry.request) == "mg":
            base += ":mg"
        base += self._krylov_marker(entry.request)
        # Same rule as _cohort: the :geo marker splits executables, the
        # fingerprint never does — mixed geometries share the lane table.
        return base + (":geo" if entry.request.geometry is not None
                       else "")

    def _step_continuous(self, worker: Worker) -> bool:
        """One cycle of the refill engine: promote backed-off work,
        dispatch a solo-class head, refill EMPTY lanes from the queue
        (policy re-checked per splice), then advance every ACTIVE lane
        one chunk and retire what the boundary shows as finished."""
        self._pump_delayed()
        busy = worker.table is not None and worker.table.occupied()
        if not self._queue and not busy:
            # Another worker's lanes may still be live: this worker has
            # nothing, but the service does.
            if self._busy_elsewhere(worker):
                return True
            if not self._advance_past_backoff():
                worker.table = None
                return False
        # A solo-class head (escalated retry, explicit chunk) dispatches
        # between chunk steps through the drain-mode machinery — the
        # lane program pauses in wall time but burns no iterations.
        if self._queue and not self._lane_eligible(self._queue[0]):
            return self._dispatch_head_solo(worker)
        self._refill(worker)
        if worker.table is not None and worker.table.occupied():
            self._step_lane_table(worker)
            return True
        return bool(self._queue or self._delayed
                    or self._busy_elsewhere(worker))

    def _busy_elsewhere(self, worker: Worker) -> bool:
        return any(w.table is not None and w.table.occupied()
                   for w in self._pool.workers if w is not worker)

    def _dispatch_head_solo(self, worker: Worker) -> bool:
        head = self._pop_live_head()
        if head is None:
            return True
        level = self._load_level(len(self._queue) + len(self._delayed)
                                 + 1)
        breaker = self._breaker(worker, self._cohort(head.request))
        if not breaker.allow():
            self._shed(head, SHED_BREAKER_OPEN,
                       f"circuit breaker open for cohort "
                       f"{self._cohort(head.request)}")
            return True
        # A block-mode head is lane-ineligible (the recurrence couples
        # members) but NOT solo: it still wants its cohort co-batched,
        # so the continuous engine borrows drain-mode batch formation
        # for it between chunk steps.
        if (self._krylov(head.request).mode == "block"
                and not self._solo(head)):
            self._dispatch(worker, self._form_batch(head), breaker,
                           level)
            return True
        self._dispatch(worker, [head], breaker, level)
        return True

    def _refill(self, worker: Worker) -> None:
        """The refill decision: splice queued, lane-eligible requests
        into the live table's EMPTY lanes. Every policy is re-checked
        per splice — deadline liveness, taint-pair exclusion against the
        current occupants, the circuit breaker (denials counted as
        ``serve.refill.refill_denied_by_breaker``), and the degradation
        ladder (padding shrink at table creation, iteration cap and
        precision downshift per spliced member). With no program in
        flight, the table is (re)built for the queue head's cohort —
        the same bucket executable is reused for every later splice."""
        from poisson_tpu_torch.serve.refill import LaneTable
        from poisson_tpu_torch.solvers.batched import bucket_size

        if not self._queue:
            return
        level = self._load_level(len(self._queue) + len(self._delayed))
        obs.gauge("serve.load_level", level)
        head = self._queue[0]
        head_cohort = self._lane_cohort(head, level)
        from poisson_tpu_torch.serve.breaker import OPEN

        if self._breaker(worker, head_cohort).state == OPEN:
            # An OPEN breaker (cooldown still running) can admit nothing
            # for this cohort: shed the head without paying lane-table
            # construction for a program no splice could ever enter.
            # (HALF_OPEN falls through — a probe splice is allowed.)
            obs.inc("serve.refill.refill_denied_by_breaker")
            entry = self._queue.popleft()
            self._shed(entry, SHED_BREAKER_OPEN,
                       f"circuit breaker open for cohort {head_cohort} "
                       f"at refill")
            return
        ready = sum(
            1 for e in self._queue
            if self._lane_eligible(e)
            and self._lane_cohort(e, level) == head_cohort
            and e.request.problem == head.request.problem
        )
        head_level = self._tenant_level(head, level)
        if head_level >= 1:
            # Padding shrink: size the table to the work actually
            # waiting — no speculative lanes when every real member
            # counts.
            bucket = min(max(1, ready), self.policy.max_batch)
        else:
            # Size to the backlog, plus one speculative EMPTY lane
            # (bucket ladder rounding) so an arrival can always join
            # the running program mid-flight — that in-flight join is
            # the continuous-batching win, and the idle width it costs
            # is audible as serve.refill.idle_lane_steps.
            bucket = bucket_size(
                min(max(ready + 1, 2), self.policy.max_batch))
        verify_every, verify_tol = self._verify_params([head])
        table = worker.table
        # An in-flight program is immutable (fixed executable width); an
        # EMPTY one is replaceable — on cohort change, to re-size the
        # bucket to the backlog the load has grown (or shrunk) into, or
        # when the integrity-probe stride changed (suspicion arrived:
        # the NEXT program runs defended; a live one is never
        # retrofitted).
        if table is not None and not table.occupied() and (
                table.cohort != head_cohort
                or table.problem != head.request.problem
                or table.bucket != bucket
                or table.verify_every != verify_every):
            table = worker.table = None
        if table is None:
            if head_level >= 1:
                obs.inc("serve.degraded.padding")
            self._count_defensive_verify(verify_every)
            eff_dtype = self._effective_dtype(head, head_level)
            table = worker.table = LaneTable(
                head_cohort, head.request.problem,
                None if eff_dtype == "auto" else eff_dtype,
                bucket, self.policy.refill_chunk,
                worker_id=worker.id,
                multi_geometry=head.request.geometry is not None,
                verify_every=verify_every, verify_tol=verify_tol,
                preconditioner=self._precond(head.request),
                device=self._device_of(worker),
            )
            self._note_sticky(worker, head_cohort, head.request.problem,
                              None if eff_dtype == "auto" else eff_dtype,
                              bucket,
                              preconditioner=self._precond(head.request))
            obs.event("serve.refill.table", cohort=head_cohort,
                      bucket=bucket, level=level, worker=worker.id)
        if not table.free_lane_count():
            return
        lane_cap = None
        if self._tenancy is not None:
            # Per-bucket lane fair share: when more than one tenant has
            # lane-eligible work for THIS table's cohort, each tenant's
            # resident-lane count is capped at its share of the bucket
            # (ceil, min 1) — one tenant cannot monopolize a bucket
            # executable's lanes while a competitor waits. With a
            # single tenant present the cap is void (work-conserving:
            # fairness must never idle lanes nobody else wants).
            present = {self._tenant(e.request) for e in self._queue
                       if self._lane_eligible(e)
                       and self._lane_cohort(e, level) == table.cohort
                       and e.request.problem == table.problem}
            present |= {self._tenant(e.request)
                        for e in table.occupants()}
            if len(present) > 1:
                total_share = sum(self._tenancy.share_of(t)
                                  for t in present)
                lane_cap = {
                    t: max(1, int(np.ceil(
                        table.bucket * self._tenancy.share_of(t)
                        / total_share)))
                    for t in present}
        kept: deque = deque()
        while self._queue and table.free_lane_count():
            entry = self._queue.popleft()
            if (not self._lane_eligible(entry)
                    or self._lane_cohort(entry, level) != table.cohort
                    or entry.request.problem != table.problem):
                kept.append(entry)
                continue
            if entry.deadline is not None and entry.deadline.expired():
                obs.inc("serve.deadline.expired_in_queue")
                self._flight.point(entry.request.request_id,
                                   POINT_DEADLINE, where="refill_queue",
                                   elapsed=round(
                                       entry.deadline.elapsed(), 4))
                self._shed(entry, SHED_DEADLINE_EXPIRED,
                           "deadline expired while queued")
                continue
            if not table.taint_compatible(entry):
                kept.append(entry)     # waits for its taint partner
                continue
            tenant = self._tenant(entry.request)
            if lane_cap is not None:
                held = sum(1 for o in table.occupants()
                           if self._tenant(o.request) == tenant)
                if held >= lane_cap.get(tenant, table.bucket):
                    # Over fair share with a competitor waiting: defer
                    # (kept, re-offered next refill), never shed — the
                    # cap costs position, not the request.
                    obs.inc("serve.tenant.lane_deferred")
                    kept.append(entry)
                    continue
            breaker = self._breaker(worker, table.cohort)
            if not breaker.allow():
                obs.inc("serve.refill.refill_denied_by_breaker")
                self._shed(entry, SHED_BREAKER_OPEN,
                           f"circuit breaker open for cohort "
                           f"{table.cohort} at refill")
                continue
            eff_level = self._tenant_level(entry, level, count=True)
            if eff_level >= 2:
                entry.iter_cap = min(
                    entry.request.problem.iteration_cap,
                    self.policy.degradation.degraded_iteration_cap)
                obs.inc("serve.degraded.iteration_cap")
            else:
                # Re-checked at every refill decision: a cap set while
                # degraded must not stick to a retried entry splicing
                # into a now-healthy service.
                entry.iter_cap = None
            if (eff_level >= 3
                    and (entry.request.dtype or "auto") == "float64"):
                obs.inc("serve.degraded.precision")
            if tenant is not None:
                obs.inc(f"serve.tenant.dispatches.{tenant}")
            lane = table.splice(entry, entry.request.rhs_gate)
            rid = entry.request.request_id
            if self._journal is not None:
                self._journal.record(
                    "splice", request_id=str(rid), worker=worker.id,
                    lane=lane,
                    device=(worker.placement.device_id
                            if worker.placement else None),
                    epoch=self._registry.epoch)
            self._flight.end(rid, SPAN_QUEUE)
            attrs = dict(mode="lane", bucket=table.bucket, lane=lane,
                         level=level, worker=worker.id)
            if tenant is not None:
                attrs["tenant"] = tenant
            if entry.request.geometry is not None:
                attrs["geometry"] = fingerprint_of(entry.request.geometry)
            self._flight.begin(rid, SPAN_RESIDENT, **attrs)
        while kept:        # skipped entries return in arrival order
            self._queue.appendleft(kept.pop())

    def _step_lane_table(self, worker: Worker) -> None:
        """Advance the lane program one chunk through the dispatch-fault
        seam, then classify the boundary. A transient fault kills the
        device program: every occupant is evicted and retried with
        mutual taint (the batch-drain contract, applied to lanes); a
        worker fault quarantines the worker and recovers the occupants
        onto the survivors; an internal fault surfaces every occupant as
        a typed error."""
        table = worker.table
        breaker = self._breaker(worker, table.cohort)
        occupants = table.occupants()
        did = self._flight.next_dispatch_id()
        t_step = self._clock()
        try:
            with obs.span("serve.refill.step", fence=False,
                          cohort=table.cohort, active=len(occupants),
                          worker=worker.id):
                if self._worker_fault is not None:
                    self._worker_fault(worker.id,
                                       [e.request for e in occupants],
                                       {e.request.request_id: e.attempts
                                        for e in occupants})
                if self._dispatch_fault is not None:
                    self._dispatch_fault(
                        [e.request for e in occupants],
                        {e.request.request_id: e.attempts
                         for e in occupants})
                # No beat here: the pump-level beat marked the step's
                # START, and the post-step stall check must measure this
                # step's duration — a beat on completion would reset the
                # baseline and make a slow-but-returning step invisible.
                # (Placement targeting lives inside LaneBatch.step —
                # the table was built with the worker's bound device.)
                table.step()
        except (WorkerCrashError, WorkerHangError) as e:
            self._handle_worker_fault(worker, e, occupants, did, t_step)
            return
        except TransientDispatchError as e:
            breaker.record_failure()
            self._flight_dispatch_failed(occupants, did, t_step,
                                         type(e).__name__)
            evicted = table.evict_all()
            worker.table = None
            co_ids = {en.request.request_id for en in evicted}
            co_fps = _geo_fps(evicted)
            for en in evicted:
                self._retry_or_fail(en, ERROR_TRANSIENT, str(e),
                                    co_ids - {en.request.request_id},
                                    co_fps)
            return
        except Exception as e:  # internal: surfaced, never retried
            breaker.record_failure()
            self._flight_dispatch_failed(occupants, did, t_step,
                                         type(e).__name__)
            evicted = table.evict_all()
            worker.table = None
            for en in evicted:
                self._error(en, ERROR_INTERNAL,
                            f"{type(e).__name__}: {e}")
            return
        # Flight: one chunk step advanced every resident lane inside one
        # measured span; divide its wall by the iterations it bought
        # (apportion_compute) and stamp a chunk_step point per member.
        views = table.lane_view()
        secs = max(0.0, self._clock() - t_step)
        deltas = table.advance_marks(views)
        by_member = {table.entries[lane].request.request_id: dk
                     for lane, dk in deltas.items()}
        shares = apportion_compute(secs, by_member)
        # Roofline: one chunk step of the lane program, attributed to
        # the longest per-lane iteration delta. Lane tables always run
        # the torch engine (routed arms apply to drain/solo dispatches),
        # so the backend is pinned here and no sentinel grades it.
        if deltas and occupants:
            self._observe_roofline(
                occupants[0].request, backend="torch",
                iterations=max(deltas.values()), seconds=secs,
                batch=len(occupants),
                verify_every=self._verify_params(occupants)[0])
        for lane, dk in deltas.items():
            entry = table.entries[lane]
            rid = entry.request.request_id
            self._flight.add_step(rid, secs, dk, shares[rid], did,
                                  k=views[lane]["k"])
            # Per-member iteration delta on the resident span: timelines
            # render iterations/chunk without decoding the step points.
            self._flight.annotate(rid, SPAN_RESIDENT, dk=int(dk),
                                  k=int(views[lane]["k"]))
            if self._forecast is not None and dk > 0:
                # Lane-boundary residual history: each member reports
                # its own (k, ‖Δw‖) pair from the lane view — the
                # re-forecast slope rides chunk boundaries, LaneBatch
                # members individually.
                entry.history.append(
                    (int(views[lane]["k"]), float(views[lane]["diff"])))
                if len(entry.history) > 32:
                    del entry.history[0]
                if shares[rid] > 0.0:
                    entry.spi = shares[rid] / dk
        self._retire_boundary(table, breaker, views)

    def _retire_boundary(self, table, breaker, views) -> None:
        from poisson_tpu_torch.solvers.pcg import FLAG_DEADLINE, FLAG_NONE

        co_ids = table.occupant_ids()
        co_fps = _geo_fps(table.occupants())
        any_failed = False
        any_clean = False
        for view in views:
            if view["member_id"] is None:
                continue
            entry = table.entries[view["lane"]]
            cap = (entry.iter_cap if entry.iter_cap is not None
                   else table.problem.iteration_cap)
            deadline_hit = (entry.deadline is not None
                            and entry.deadline.expired())
            if not (view["done"] or view["k"] >= cap or deadline_hit):
                # Lane-boundary re-forecast (ForecastPolicy.reforecast):
                # a converging-but-doomed occupant — remaining-iterations
                # ETA past its remaining budget — is preempted NOW,
                # freeing the lane for work that can still make its
                # deadline, instead of burning chunks to an inevitable
                # deadline-flagged partial.
                if (self._forecast is not None
                        and self.policy.forecast.reforecast
                        and entry.deadline is not None
                        and self._reforecast_doomed(entry, view, table)):
                    entry, result = table.retire(view["lane"])
                    if self._journal is not None:
                        self._journal.record(
                            "retire",
                            request_id=str(entry.request.request_id),
                            iterations=int(result.iterations),
                            flag=result.flag_name)
                    self._flight.end(entry.request.request_id,
                                     SPAN_RESIDENT,
                                     iterations=result.iterations,
                                     flag=result.flag_name)
                    obs.inc("serve.forecast.preempted")
                    # Preemption is a capacity decision, not a cohort
                    # fault: the breaker never hears about it.
                    self._shed(entry, SHED_PREDICTED_DEADLINE,
                               "re-forecast ETA exceeds remaining "
                               f"deadline budget at k={int(view['k'])}")
                continue               # still ACTIVE: rides the next chunk
            entry, result = table.retire(view["lane"])
            if self._journal is not None:
                self._journal.record(
                    "retire", request_id=str(entry.request.request_id),
                    iterations=int(result.iterations),
                    flag=result.flag_name)
            if deadline_hit:
                self._flight.point(entry.request.request_id,
                                   POINT_DEADLINE, where="lane",
                                   elapsed=round(
                                       entry.deadline.elapsed(), 4))
            self._flight.end(entry.request.request_id, SPAN_RESIDENT,
                             iterations=result.iterations,
                             flag=result.flag_name)
            flag = result.flag
            if deadline_hit and flag == FLAG_NONE:
                # A healthy lane overtaken by its budget: partial result,
                # deadline-flagged. Verdicts win over deadlines — the
                # same precedence as checkpoint._deadline_flag.
                flag = FLAG_DEADLINE
            failed = self._classify_member(
                entry, flag, result.iterations, result.diff,
                restarts=0, cap=cap,
                co_ids=co_ids - {entry.request.request_id},
                co_fps=co_fps,
            )
            any_failed = any_failed or failed
            any_clean = any_clean or not failed
        if any_failed:
            breaker.record_failure()
        elif any_clean:
            breaker.record_success()

    # -- dispatch ------------------------------------------------------

    def _dispatch(self, worker: Worker, batch: List[_Entry],
                  breaker: CircuitBreaker, level: int) -> None:
        from poisson_tpu_torch.solvers.pcg import resolve_dtype

        policy = self.policy
        obs.gauge("serve.load_level", level)
        head = batch[0]
        # Tenant-scoped degradation: the batch is dispatched at the
        # head's effective rung (batches are cohort-homogeneous; a
        # spared tenant's head runs one rung gentler than the
        # offender's — serve.tenant.degraded_{offender,spared}).
        level = self._tenant_level(head, level, count=level > 0)
        problem = head.request.problem
        dtype = head.request.dtype
        exact_bucket = False
        if level >= 1:
            exact_bucket = True
            obs.inc("serve.degraded.padding")
        if level >= 2:
            cap = min(problem.iteration_cap,
                      policy.degradation.degraded_iteration_cap)
            problem = problem.with_(max_iter=cap)
            obs.inc("serve.degraded.iteration_cap")
        if level >= 3 and resolve_dtype(dtype) == "float64":
            dtype = "float32"
            obs.inc("serve.degraded.precision")
        if level > 0:
            obs.event("serve.degraded", level=level,
                      batch=len(batch), exact_bucket=exact_bucket,
                      iteration_cap=problem.iteration_cap, dtype=dtype)

        obs.inc("serve.dispatches")
        obs.inc("serve.batch_members", len(batch))
        cohort = self._cohort(head.request)
        if self._router is not None:
            # Route this dispatch cohort across the backend arms. The
            # backend-downshift rung rides the decision (queue pressure
            # forces the torch floor). Execution gate: every arm runs
            # the plain torch solve (router.executor_backend, closed as
            # in the JAX package), so routing changes evidence and
            # telemetry but not the solve; a non-torch choice is counted
            # as an executor fallback to keep that gap audible.
            ve, _ = self._verify_params(batch)
            self._active_decision = self._router.route(
                **self._roofline_args(head.request, batch=len(batch),
                                      verify_every=ve),
                device_id=(worker.placement.device_id
                           if worker.placement else 0),
                queue_fraction=(len(self._queue)
                                / max(1, policy.capacity)))
            if self._active_decision.backend != "torch":
                obs.inc("serve.router.executor_fallbacks")
        # Sticky buckets: this worker has run the cohort at this
        # bucket width — routing will prefer it, and a restart
        # warm-up runs exactly these widths again.
        solo_head = len(batch) == 1 and self._solo(head)
        if solo_head:
            width = None          # chunked drivers, no bucket program
        elif exact_bucket:
            width = len(batch)
        else:
            from poisson_tpu_torch.solvers.batched import bucket_size

            width = bucket_size(len(batch))
        self._note_sticky(worker, cohort, head.request.problem,
                          head.request.dtype, width,
                          preconditioner=self._precond(head.request))
        # Flight: members leave the queue and become resident in one
        # shared dispatch — the dispatch id is the causal parent linking
        # every member's residency span and chunk-step points.
        did = self._flight.next_dispatch_id()
        solo = solo_head
        mode = "solo" if solo else "drain"
        for entry in batch:
            rid = entry.request.request_id
            self._flight.end(rid, SPAN_QUEUE)
            attrs = dict(dispatch=did, mode=mode, batch=len(batch),
                         level=level, worker=worker.id)
            tenant = self._tenant(entry.request)
            if tenant is not None:
                obs.inc(f"serve.tenant.dispatches.{tenant}")
                attrs["tenant"] = tenant
            if entry.request.geometry is not None:
                # Fingerprint attribution: a mixed-geometry dispatch's
                # members are distinguishable in the causal trace.
                attrs["geometry"] = fingerprint_of(entry.request.geometry)
            self._flight.begin(rid, SPAN_RESIDENT, **attrs)
        if self._journal is not None:
            # The dispatch record carries the placement (device + epoch)
            # so a recovery on a different topology can see which
            # silicon the in-flight work was on and remap it audibly.
            self._journal.record(
                "dispatch", worker=worker.id, mode=mode,
                request_ids=[str(e.request.request_id) for e in batch],
                device=(worker.placement.device_id
                        if worker.placement else None),
                epoch=self._registry.epoch)
        t_disp = self._clock()
        try:
            with obs.span("serve.dispatch", fence=False, cohort=cohort,
                          batch=len(batch), level=level,
                          worker=worker.id):
                if self._worker_fault is not None:
                    self._worker_fault(worker.id,
                                       [e.request for e in batch],
                                       {e.request.request_id: e.attempts
                                        for e in batch})
                if self._dispatch_fault is not None:
                    self._dispatch_fault([e.request for e in batch],
                                         {e.request.request_id: e.attempts
                                          for e in batch})
                if solo:
                    member_failed = self._dispatch_solo(
                        head, problem, dtype, did, t_disp)
                else:
                    member_failed = self._dispatch_batched(
                        batch, problem, dtype, exact_bucket, did,
                        t_disp)
                # No completion beat — see _step_lane_table: the
                # post-step stall check measures from the pump-level
                # start-of-step beat.
        except (WorkerCrashError, WorkerHangError) as e:
            self._handle_worker_fault(worker, e, batch, did, t_disp)
            return
        except TransientDispatchError as e:
            breaker.record_failure()
            self._flight_dispatch_failed(batch, did, t_disp,
                                         type(e).__name__)
            co_ids = {entry.request.request_id for entry in batch}
            co_fps = _geo_fps(batch)
            for entry in batch:
                self._retry_or_fail(entry, ERROR_TRANSIENT, str(e),
                                    co_ids - {entry.request.request_id},
                                    co_fps)
            return
        except Exception as e:  # internal: surfaced, never retried
            breaker.record_failure()
            self._flight_dispatch_failed(batch, did, t_disp,
                                         type(e).__name__)
            for entry in batch:
                self._error(entry, ERROR_INTERNAL,
                            f"{type(e).__name__}: {e}")
            return
        finally:
            # The routing decision is scoped to this dispatch: a stale
            # one must never grade a later dispatch's measurement.
            self._active_decision = None
        if member_failed:
            breaker.record_failure()
        else:
            breaker.record_success()

    def _flight_dispatch_failed(self, batch: List[_Entry], did: str,
                                t_disp: float, error: str) -> None:
        """A whole dispatch died: the members' residency still happened
        (and is accounted), but no iterations can be attributed — the
        time they paid is lane-wait on a program that produced nothing."""
        secs = max(0.0, self._clock() - t_disp)
        for entry in batch:
            rid = entry.request.request_id
            self._flight.add_step(rid, secs, 0, 0.0, did)
            self._flight.end(rid, SPAN_RESIDENT, error=error)

    def _dispatch_batched(self, batch: List[_Entry], problem, dtype,
                          exact_bucket: bool, did: str,
                          t_disp: float) -> bool:
        from poisson_tpu_torch.solvers.batched import solve_batched

        # Geometry cohorts dispatch with per-member canvases — mixed
        # fingerprints share the one stacked-canvas bucket executable.
        geoms = [e.request.geometry for e in batch]
        verify_every, verify_tol = self._verify_params(batch)
        # The batch is cohort-homogeneous (the :mg marker splits
        # cohorts), so the head's preconditioner is everyone's.
        # The batch is cohort-homogeneous in its Krylov mode too (the
        # :blk marker splits cohorts), so the head's mode is everyone's.
        kp = self._krylov(batch[0].request)
        if kp.mode == "block" and verify_every > 0:
            # The block recurrence has no per-member integrity probe
            # yet: when verification is demanded (always-on policy, or
            # a suspect cohort arming the defensive stride), the SDC
            # defense WINS — the batch dispatches through the VERIFIED
            # independent program instead (same members, same typed
            # outcomes, block acceleration suspended audibly). A
            # silent unverified block dispatch would bypass the SDC
            # defense; passing the stride through would ValueError
            # into a non-retried internal error for every member.
            obs.inc("serve.krylov.verify_suspensions")
            obs.event("krylov.verify_suspended", mode="block",
                      batch=len(batch), verify_every=verify_every)
            kp = DEFAULT_KRYLOV_POLICY
        self._count_defensive_verify(verify_every)
        result = solve_batched(
            problem,
            rhs_gates=[e.request.rhs_gate for e in batch],
            member_ids=[e.request.request_id for e in batch],
            dtype=dtype,
            bucket=(len(batch) if exact_bucket and kp.mode != "block"
                    else None),
            geometries=(geoms if any(g is not None for g in geoms)
                        else None),
            verify_every=verify_every, verify_tol=verify_tol,
            preconditioner=self._precond(batch[0].request),
            mode=kp.mode, device=self._device_of(self._active_worker),
        )
        if result.deficient is not None and bool(
                _host(result.deficient)):
            # Graceful rank degradation inside the block recurrence —
            # audible, not a failure (near-parallel RHS columns).
            obs.inc("krylov.block.rank_deficient")
        co_ids = {e.request.request_id for e in batch}
        co_fps = _geo_fps(batch)
        iters = _host(result.iterations)
        flags = _host(result.flag)
        diffs = _host(result.diff)
        # Flight: one fused dispatch advanced every member; its measured
        # wall divides among them by iteration count (the measured
        # per-iteration cost of the shared program — obs.costs).
        secs = max(0.0, self._clock() - t_disp)
        shares = apportion_compute(
            secs, {e.request.request_id: int(iters[i])
                   for i, e in enumerate(batch)})
        # Roofline: one fused program moved passes × grid × max(iters)
        # bytes (padding members ride the longest-running lane).
        self._observe_roofline(
            batch[0].request, iterations=int(iters.max()),
            seconds=secs, batch=len(batch), verify_every=verify_every)
        for i, entry in enumerate(batch):
            rid = entry.request.request_id
            self._flight.add_step(rid, secs, int(iters[i]),
                                  shares[rid], did, k=int(iters[i]))
            self._flight.end(rid, SPAN_RESIDENT,
                             iterations=int(iters[i]))
        any_failed = False
        for i, entry in enumerate(batch):
            assert result.origin[i] == entry.request.request_id
            failed = self._classify_member(
                entry, int(flags[i]), int(iters[i]), float(diffs[i]),
                restarts=0, cap=problem.iteration_cap,
                co_ids=co_ids - {entry.request.request_id},
                co_fps=co_fps,
            )
            any_failed = any_failed or failed
        return any_failed

    def _dispatch_solo(self, entry: _Entry, problem, dtype, did: str,
                       t_disp: float) -> bool:
        from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
        from poisson_tpu_torch.solvers.resilient import (
            DivergenceError,
            pcg_solve_resilient,
        )

        req = entry.request
        chunk = req.chunk or self.policy.default_chunk
        # The RHS gate rides rhs_gate (not f_val) when a geometry is
        # present — the canvas cache keys on f_val, and a gate folded
        # into it would fragment the cache per gate. Without geometry,
        # folding into f_val keeps the historical solo path unchanged.
        if req.geometry is not None:
            solo_problem = problem
        else:
            solo_problem = problem.with_(
                f_val=problem.f_val * req.rhs_gate)
        rid = req.request_id
        if req.session_id is not None:
            return self._dispatch_session(entry, problem, dtype, did,
                                          t_disp)
        verify_every, verify_tol = self._verify_params([entry])
        self._count_defensive_verify(verify_every)
        kp = self._krylov(req)
        if (kp.deflation and not entry.escalate
                and verify_every > 0):
            # The deflated program has no in-loop integrity probe yet:
            # when verification is demanded (always-on policy, or a
            # suspect hardware cohort arming the defensive stride),
            # the SDC defense WINS — the request falls through to the
            # verified chunked path below (cold, correct, defended)
            # and the suspension is audible. Silently running the
            # unverified warm program on flip-suspect silicon would
            # bypass the SDC defense for the whole :defl cohort.
            obs.inc("serve.krylov.verify_suspensions")
            obs.event("krylov.verify_suspended",
                      request_id=str(rid), mode="deflation",
                      verify_every=verify_every)
        elif kp.deflation and not entry.escalate:
            from poisson_tpu_torch.geometry.dsl import fingerprint_of
            from poisson_tpu_torch.krylov.recycle import solve_recycled

            # The fingerprint-keyed solver memory: warm solves deflate
            # against the cached basis, cold solves harvest one. The
            # dispatching worker becomes the family's basis holder —
            # the second stickiness axis routing prefers (see pump()).
            result = solve_recycled(
                problem, dtype=dtype, rhs_gate=req.rhs_gate,
                geometry=req.geometry, policy=kp,
                hw=self._hw_cohort(),
                device=self._device_of(self._active_worker),
            )
            worker = self._active_worker
            if worker is not None:
                self._basis_holder[fingerprint_of(req.geometry)] = \
                    worker.id
            secs = max(0.0, self._clock() - t_disp)
            iters = int(result.iterations)
            self._flight.add_step(rid, secs, iters,
                                  secs if iters else 0.0, did, k=iters)
            self._flight.end(rid, SPAN_RESIDENT, iterations=iters)
            self._observe_roofline(req, iterations=iters, seconds=secs,
                                   verify_every=verify_every)
            return self._classify_member(
                entry, int(result.flag), iters,
                float(np.max(_host(result.diff))),
                restarts=0, cap=problem.iteration_cap, co_ids=set(),
            )
        if entry.escalate and self.policy.retry.escalate_divergence:
            obs.inc("serve.escalations")
            try:
                # An integrity-class escalation rides the SAME resilient
                # driver as divergence — with the probe armed it IS the
                # verified-restart driver (restart from the last
                # verified-good iterate, no precision escalation); a
                # persistent detector exhausting the restart budget
                # surfaces as DivergenceError below, typed by the
                # entry's failure class.
                result = pcg_solve_resilient(
                    solo_problem, dtype=dtype, chunk=chunk,
                    deadline=entry.deadline, on_chunk=req.on_chunk,
                    verify_every=verify_every, verify_tol=verify_tol,
                    preconditioner=self._precond(req),
                    device=self._device_of(self._active_worker),
                )
            except DivergenceError as e:
                secs = max(0.0, self._clock() - t_disp)
                self._flight.add_step(rid, secs, 0, 0.0, did)
                self._flight.end(rid, SPAN_RESIDENT,
                                 error="DivergenceError")
                self._error(entry,
                            (ERROR_INTEGRITY
                             if entry.last_failure == ERROR_INTEGRITY
                             else ERROR_DIVERGENCE), str(e))
                return True
        else:
            result = pcg_solve_chunked(
                solo_problem, chunk=chunk, dtype=dtype,
                deadline=entry.deadline, on_chunk=req.on_chunk,
                geometry=req.geometry,
                rhs_gate=(req.rhs_gate if req.geometry is not None
                          else None),
                verify_every=verify_every, verify_tol=verify_tol,
                preconditioner=self._precond(req),
                history=(self._forecast is not None
                         and self.policy.forecast.history_every > 0),
                device=self._device_of(self._active_worker),
            )
        # Flight: a solo dispatch's whole wall is this member's compute
        # (it shares the program with nobody).
        secs = max(0.0, self._clock() - t_disp)
        iters = int(result.iterations)
        self._flight.add_step(rid, secs, iters, secs if iters else 0.0,
                              did, k=iters)
        self._flight.end(rid, SPAN_RESIDENT, iterations=iters)
        self._observe_roofline(req, iterations=iters, seconds=secs,
                               verify_every=verify_every)
        return self._classify_member(
            entry, int(result.flag), int(result.iterations),
            float(np.max(_host(result.diff))),
            restarts=int(getattr(result, "restarts", 0) or 0),
            cap=problem.iteration_cap, co_ids=set(),
        )

    def _dispatch_session(self, entry: _Entry, problem, dtype, did: str,
                          t_disp: float) -> bool:
        """One session step (``serve.session``): a fused solve through
        the warm-start seam. The warm iterate rides the request
        (``warm_start`` — process memory, never the journal: a replayed
        step arrives with the field at its default and runs COLD), the
        validity gate lives in the solver layer
        (:func:`solvers.session.session_step_solve`), and a gate
        fallback is audible here too (``warm_fallback`` flight point on
        the step's own trace). Per-step deadlines are enforced at step
        boundaries — an expired deadline sheds the step in the queue
        like any request; a step that finishes past its deadline still
        returns its (correct) result, with the miss counted
        (``session.step.deadline_misses``) and pointed on the trace."""
        from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED
        from poisson_tpu_torch.solvers.session import session_step_solve

        req = entry.request
        rid = req.request_id
        sp = self.policy.session
        result, info = session_step_solve(
            problem, dtype=dtype, geometry=req.geometry,
            warm=req.warm_start, warm_geometry=req.warm_geometry,
            mass_shift=req.mass_shift,
            # The previous iterate is the implicit-Euler step's uⁿ —
            # transient DATA, not just a guess (the gate only decides
            # whether it also seeds the restart).
            u_prev=(req.warm_start if req.mass_shift else None),
            rhs_gate=req.rhs_gate,
            drift_bound=sp.warm_drift_bound,
            residual_factor=sp.warm_residual_factor,
            device=self._device_of(self._active_worker),
        )
        if not info["warm_used"] and req.warm_start is not None:
            self._flight.point(rid, POINT_WARM_FALLBACK,
                               reason=info["fallback"],
                               step=req.session_step,
                               session=str(req.session_id))
        secs = max(0.0, self._clock() - t_disp)
        iters = int(result.iterations)
        flag = int(result.flag)
        if flag == FLAG_CONVERGED and req.on_solution is not None:
            # Hand the converged iterate back to the session host (the
            # next step's warm-start source). A throwing hook must not
            # void the outcome — the step solved; the hook is the
            # caller's code.
            try:
                req.on_solution(_host(result.w))
            except Exception:
                obs.inc("session.callback_errors")
        if entry.deadline is not None and entry.deadline.expired():
            obs.inc("session.step.deadline_misses")
            self._flight.point(rid, POINT_DEADLINE,
                               where="session_step",
                               elapsed=round(entry.deadline.elapsed(), 4))
        self._flight.add_step(rid, secs, iters, secs if iters else 0.0,
                              did, k=iters)
        self._flight.end(rid, SPAN_RESIDENT, iterations=iters,
                         warm=info["warm_used"])
        self._observe_roofline(req, iterations=iters, seconds=secs)
        return self._classify_member(
            entry, flag, iters, float(np.max(_host(result.diff))),
            restarts=0, cap=problem.iteration_cap, co_ids=set(),
        )

    # -- outcome classification ----------------------------------------

    def _classify_member(self, entry: _Entry, flag: int, iterations: int,
                         diff: float, restarts: int, cap: int,
                         co_ids: set, co_fps: set = frozenset()) -> bool:
        """Turn one member's stop verdict into an outcome or a retry.
        Returns True iff this member counts as a dispatch failure for the
        breaker."""
        from poisson_tpu_torch.solvers.pcg import (
            FLAG_CONVERGED,
            FLAG_DEADLINE,
            FLAG_INTEGRITY,
            FLAG_NAMES,
            FLAG_NONE,
        )

        name = FLAG_NAMES.get(flag, str(flag))
        if flag == FLAG_CONVERGED:
            self._complete(entry, name, True, False, iterations, restarts,
                           diff)
            return False
        if flag == FLAG_DEADLINE:
            obs.inc("serve.deadline.expired_mid_solve")
            self._complete(entry, name, False, True, iterations, restarts,
                           diff)
            return False
        if flag == FLAG_NONE:
            # Budget exhausted without a failure verdict (incl. the
            # degraded iteration cap): the partial iterate is the answer
            # the policy bought.
            self._complete(entry, "cap_hit", False, True, iterations,
                           restarts, diff)
            return False
        if flag == FLAG_INTEGRITY:
            # Silent-data-corruption verdict (poisson_tpu_torch.integrity):
            # its own outcome class — the iterate is suspect, not
            # divergent, and the suspicion attaches to the HARDWARE
            # cohort (Hochschild 2021), so later dispatches on this
            # (backend, device_kind) run defensively verified even when
            # the policy default is off. The member itself is retried
            # (through the verified-restart resilient driver when it
            # can escalate), typed ``integrity`` once the budget runs
            # out.
            obs.inc("serve.integrity.detections")
            obs.event("serve.integrity.detection",
                      request_id=str(entry.request.request_id),
                      iteration=iterations)
            self._taint_suspect_hw()
            self._retry_or_fail(entry, ERROR_INTEGRITY,
                                f"integrity verification failed at "
                                f"iteration {iterations}", co_ids, co_fps)
            return True
        # breakdown / nonfinite / stagnated: divergence-class failure.
        self._retry_or_fail(entry, ERROR_DIVERGENCE,
                            f"solver stopped: {name} at iteration "
                            f"{iterations}", co_ids, co_fps)
        return True

    def _retry_or_fail(self, entry: _Entry, error_type: str, message: str,
                       co_ids: set, co_fps: set = frozenset()) -> None:
        entry.attempts += 1
        entry.last_failure = error_type
        max_attempts = (entry.request.max_attempts
                        or self.policy.retry.max_attempts)
        if entry.attempts >= max_attempts:
            self._error(entry, error_type,
                        f"{message} (attempt {entry.attempts}/"
                        f"{max_attempts})")
            return
        if self._tenancy is not None:
            # Per-tenant retry budget (Dean & Barroso 2013): every
            # requeue spends a token only successes refund. A poisoned
            # tenant exhausts it after retry_budget requeues and each
            # later retry converts into this typed error — its total
            # dispatch count is bounded by admitted + retry_budget, so
            # a retry storm cannot multiply load on a degraded fleet.
            tenant = self._tenant(entry.request)
            if not self._tenancy.spend_retry(tenant):
                obs.inc("serve.tenant.retry_exhausted")
                obs.event("serve.tenant.retry_exhausted",
                          request_id=str(entry.request.request_id),
                          tenant=tenant, error=error_type)
                self._error(entry, error_type,
                            f"{message} (tenant {tenant!r} retry budget "
                            "exhausted)")
                return
            obs.inc(f"serve.tenant.retries.{tenant}")
        delay = self._backoff_delay(entry.attempts)
        if entry.deadline is not None:
            remaining = entry.deadline.remaining()
            if remaining is not None and remaining <= delay:
                obs.inc("serve.deadline.expired_in_queue")
                self._shed(entry, SHED_DEADLINE_EXPIRED,
                           f"deadline cannot survive the {delay:.3f}s "
                           f"retry backoff after: {message}")
                return
        # Mutual taint: this member never shares a bucket with its failed
        # batchmates again (and vice versa, applied on their entries) —
        # a poisoned member cannot re-kill the same cohort twice. The
        # fingerprint half keys on the GEOMETRY: any request carrying a
        # co-failed member's geometry family is excluded too, so a bad
        # geometry never re-co-batches with its batchmates under a fresh
        # request id.
        entry.taint |= co_ids
        if co_fps:
            new_fps = (set(co_fps)
                       - {fingerprint_of(entry.request.geometry)}
                       - entry.taint_fp)
            if new_fps:
                entry.taint_fp |= new_fps
                obs.inc("serve.requeued.geometry_isolated")
        # Divergence AND integrity escalation run the single-request
        # resilient driver — for an integrity retry that driver, with
        # the probe armed by _verify_params, IS the verified-restart
        # recovery path. It solves the reference geometry, so a
        # geometry request must not escalate into solving the wrong
        # domain; it retries through the ordinary (geometry-aware,
        # defensively-verified) dispatch instead.
        entry.escalate = (error_type in (ERROR_DIVERGENCE,
                                         ERROR_INTEGRITY)
                          and self.policy.retry.escalate_divergence
                          and entry.request.geometry is None)
        # A deflation-class request whose solve went divergence/
        # integrity-bad implicates its cached basis: invalidate the
        # family so the retry (escalated or not) runs cold and
        # re-harvests on success — stale memory costs a rebuild, never
        # a second poisoned dispatch.
        if (self._krylov(entry.request).deflation
                and error_type in (ERROR_DIVERGENCE, ERROR_INTEGRITY)):
            from poisson_tpu_torch.krylov.recycle import invalidate

            invalidate(
                fingerprint=fingerprint_of(entry.request.geometry),
                reason=f"escalation-{error_type}")
        entry.not_before = self._clock() + delay
        obs.inc("serve.retries")
        if error_type == ERROR_INTEGRITY:
            obs.inc("serve.integrity.retries")
        obs.inc("serve.backoff_seconds", delay)
        if co_ids:
            obs.inc("serve.requeued.isolated")
        if self._journal is not None:
            # Taint rides the record: the never-co-batch-again pairs
            # must survive a crash while the entry is backing off, or
            # replay would re-batch a poison with its old victims.
            self._journal.record(
                "requeue", request_id=str(entry.request.request_id),
                attempt=entry.attempts, error=error_type,
                recovered=entry.recovered,
                taint=sorted(str(t) for t in entry.taint),
                taint_fp=sorted(entry.taint_fp))
        obs.event("serve.retry", request_id=str(entry.request.request_id),
                  attempt=entry.attempts, delay=round(delay, 4),
                  error=error_type, escalate=entry.escalate)
        rid = entry.request.request_id
        self._flight.point(rid, POINT_RETRY, attempt=entry.attempts,
                           error=error_type, delay=round(delay, 4),
                           escalate=entry.escalate)
        self._flight.begin(rid, SPAN_BACKOFF, attempt=entry.attempts,
                           delay=round(delay, 4))
        self._delayed.append(entry)

    def _backoff_delay(self, attempt: int) -> float:
        r = self.policy.retry
        base = min(r.backoff_base * (2 ** (attempt - 1)), r.backoff_cap)
        # Jitter over [1-jitter, 1]: decorrelates retries without ever
        # exceeding the cap. Seeded RNG — deterministic campaigns.
        return base * (1.0 - r.jitter * self._rng.random())

    # -- outcome recording ---------------------------------------------

    def _record(self, outcome: Outcome) -> Outcome:
        self._pending_ids.discard(outcome.request_id)
        self._outcomes[outcome.request_id] = outcome
        self._order.append(outcome.request_id)
        self._latencies.append(outcome.latency_seconds)
        if self._journal is not None:
            self._journal.record(
                "outcome", request_id=str(outcome.request_id),
                outcome=outcome.kind,
                type=(outcome.error_type or outcome.shed_reason
                      or outcome.flag),
                attempts=outcome.attempts)
        obs.gauge("serve.queue_depth",
                  len(self._queue) + len(self._delayed))
        return outcome

    def _latency(self, entry: _Entry) -> float:
        return max(0.0, self._clock() - entry.admitted_at)

    def _close_flight(self, entry: _Entry, kind: str, type_: str,
                      latency: float, attempts: int,
                      good: bool) -> dict:
        """Close the request's causal trace (one typed outcome leaf, any
        open span folded into its accumulator) and score the SLO."""
        fo = self._flight.outcome(entry.request.request_id, kind=kind,
                                  type_=type_, attempts=attempts)
        self._slo.record(latency, good)
        return fo

    def _complete(self, entry: _Entry, flag: str, converged: bool,
                  partial: bool, iterations: int, restarts: int,
                  diff: float) -> Outcome:
        self._counts["completed"] += 1
        obs.inc("serve.completed")
        if partial:
            obs.inc("serve.completed.partial")
        if restarts:
            obs.inc("serve.completed.recovered")
        latency = self._latency(entry)
        # SLO-good: a converged result inside the latency objective.
        # Partial results and slow successes spend error budget.
        good = (converged and latency
                <= self.policy.slo.latency_objective_seconds)
        fo = self._close_flight(entry, OUTCOME_RESULT, flag, latency,
                                entry.attempts + 1, good)
        tenant = self._tenant(entry.request)
        if tenant is not None:
            obs.inc(f"serve.tenant.completed.{tenant}")
            self._tenancy.credit_success(tenant)
            self._tenant_slo_tracker(tenant).record(latency, good)
        if self._forecast is not None and converged and not partial:
            # Only full converged solves calibrate the cohort model —
            # a deadline partial's iteration count measures the budget,
            # not the problem. compute_s is the flight decomposition's
            # measured per-request compute share.
            self._forecast_observe(
                entry, int(iterations),
                float((fo.get("decomposition") or {})
                      .get("compute_s", 0.0)))
        return self._record(Outcome(
            request_id=entry.request.request_id, kind=OUTCOME_RESULT,
            flag=flag, converged=converged, partial=partial,
            iterations=iterations, restarts=restarts,
            attempts=entry.attempts + 1,
            latency_seconds=latency, diff=diff,
            trace_id=fo["trace_id"], decomposition=fo["decomposition"],
        ))

    def _error(self, entry: _Entry, error_type: str, message: str
               ) -> Outcome:
        self._counts["errors"] += 1
        obs.inc("serve.errors")
        obs.inc(f"serve.errors.{error_type}")
        obs.event("serve.error", request_id=str(entry.request.request_id),
                  error=error_type, message=message[:200])
        latency = self._latency(entry)
        fo = self._close_flight(entry, OUTCOME_ERROR, error_type,
                                latency, max(1, entry.attempts), False)
        tenant = self._tenant(entry.request)
        if tenant is not None:
            obs.inc(f"serve.tenant.errors.{tenant}")
            self._tenant_slo_tracker(tenant).record(latency, False)
        return self._record(Outcome(
            request_id=entry.request.request_id, kind=OUTCOME_ERROR,
            error_type=error_type, message=message,
            attempts=max(1, entry.attempts),
            latency_seconds=latency,
            trace_id=fo["trace_id"], decomposition=fo["decomposition"],
        ))

    def _shed(self, entry: _Entry, reason: str, message: str) -> Outcome:
        self._counts["shed"] += 1
        obs.inc("serve.shed")
        obs.inc(f"serve.shed.{reason}")
        obs.event("serve.shed", request_id=str(entry.request.request_id),
                  reason=reason)
        latency = self._latency(entry)
        fo = self._close_flight(entry, OUTCOME_SHED, reason, latency,
                                entry.attempts, False)
        tenant = self._tenant(entry.request)
        if tenant is not None:
            obs.inc(f"serve.tenant.shed.{tenant}")
            self._tenant_slo_tracker(tenant).record(latency, False)
        return self._record(Outcome(
            request_id=entry.request.request_id, kind=OUTCOME_SHED,
            shed_reason=reason, message=message,
            attempts=entry.attempts,
            latency_seconds=latency,
            trace_id=fo["trace_id"], decomposition=fo["decomposition"],
        ))

    # -- crash recovery (serve.journal) --------------------------------

    @classmethod
    def recover(cls, journal, policy: Optional[ServicePolicy] = None,
                **kwargs) -> "SolveService":
        """Rebuild a service from ``journal``'s write-ahead log after a
        crash: replay the log, re-enqueue every request that was queued
        or in-flight when the previous process died (``recovered``
        taint/backoff path, counted as ``serve.recovered`` — NOT as a
        fresh admission, so merged cross-process ``serve.*`` snapshots
        close the ledger invariant), remember every prior outcome (a
        replayed or retried submission can never double-admit), and
        keep journaling into the same file. The replay report rides on
        the returned service as ``.recovery``."""
        from poisson_tpu_torch.krylov.recycle import invalidate
        from poisson_tpu_torch.serve.journal import replay_journal

        # Journal-safe solver memory: bases live in device memory and
        # are NEVER journaled, so a recovered process must rebuild
        # them from fresh cold solves rather than trust whatever an
        # earlier life (or a same-process predecessor service) left in
        # the process-global cache — unreplayed device state is not
        # evidence. Audible (krylov.cache.invalidations).
        invalidate(all_entries=True, reason="journal-recovery")
        replay = replay_journal(journal.path)
        svc = cls(policy, journal=journal, **kwargs)
        svc._absorb_replay(replay)
        return svc

    def _absorb_replay(self, replay) -> None:
        self.recovery = replay
        for rid, kind in replay.outcomes.items():
            # Terminal truth from the previous life: enough to dedup
            # against; the full Outcome object died with its process.
            self._prior_outcomes.setdefault(
                rid, Outcome(request_id=rid, kind=kind,
                             message="replayed from journal"))
            self._recovered_ids.add(str(rid))
        self._recovered_ids.update(
            str(p.request.request_id) for p in replay.pending)
        now = self._clock()
        for pend in replay.pending:
            req = pend.request
            # Keep the original admission time when the journal clock is
            # comparable with ours (same monotonic epoch — true for a
            # same-boot restart and for shared virtual clocks): latency,
            # SLO scoring, and the flight decomposition then cover the
            # crash gap (it lands in overhead_s — nobody worked on the
            # request while the process was dead). A t_submit from an
            # incomparable clock (in the future) falls back to now.
            t_admit = (pend.t_submit
                       if 0.0 <= pend.t_submit <= now else now)
            entry = _Entry(
                req, t_admit,
                Deadline(req.deadline_seconds, clock=self._clock)
                if req.deadline_seconds is not None else None)
            entry.recovered = True
            entry.attempts = pend.attempts
            entry.taint = set(pend.taint)
            entry.taint_fp = set(getattr(pend, "taint_fp", ()) or ())
            if self._tenancy is not None:
                # Rebuild the tenant ledger from the journal: register
                # the tenant (share, fresh quota bucket) and re-charge
                # its journaled dispatch attempts beyond the first
                # against the retry budget — a poisoned tenant cannot
                # reset its amplification cap by crashing the process
                # mid-storm.
                tenant = self._tenant(req)
                self._tenancy.charge_attempts(tenant,
                                              max(0, pend.attempts - 1))
            self._counts["recovered"] += 1
            obs.inc("serve.recovered")
            self._pending_ids.add(req.request_id)
            rid = req.request_id
            if pend.trace_id:
                # Continue the crashed process's causal trace: same
                # trace id, span ids offset past the dead incarnation's.
                self._flight.adopt(rid, pend.trace_id, t_admit,
                                   span_base=1000 * pend.generation)
            else:
                self._flight.admit(rid)
            self._flight.point(rid, POINT_RECOVERED,
                               reason="journal_replay",
                               generation=pend.generation,
                               in_flight=pend.in_flight,
                               lost_hook=pend.lost_hook)
            if self._tenancy is not None:
                self._flight.begin(rid, SPAN_QUEUE, recovered=True,
                                   tenant=self._tenant(req))
            else:
                self._flight.begin(rid, SPAN_QUEUE, recovered=True)
            # Topology-aware recovery: work that was on a device this
            # topology no longer has is REMAPPED audibly — never
            # silently resumed onto a ghost device id. A hard pin that
            # cannot map is a typed ``placement`` error, not a wedge.
            dev = pend.device_id
            if req.device_id is not None and not self._registry.is_alive(
                    int(req.device_id)):
                self._flight.end(rid, SPAN_QUEUE)
                self._error(entry, ERROR_PLACEMENT,
                            f"recovered request pinned to device "
                            f"{req.device_id}, which does not exist on "
                            f"this topology "
                            f"({len(self._registry)} devices)")
                continue
            if dev is not None and not self._registry.is_alive(int(dev)):
                try:
                    placement = self._registry.remap(int(dev))
                except PlacementError as e:
                    self._flight.end(rid, SPAN_QUEUE)
                    self._error(entry, ERROR_PLACEMENT, str(e))
                    continue
                self._flight.point(rid, POINT_PLACEMENT,
                                   from_device=int(dev),
                                   to_device=placement.device_id,
                                   from_epoch=pend.epoch,
                                   epoch=self._registry.epoch)
            if self._journal is not None:
                self._journal.record("recover", request_id=str(rid),
                                     generation=pend.generation,
                                     in_flight=pend.in_flight)
            if pend.in_flight:
                # Mid-dispatch at the crash: back off before the redo —
                # the crash may have been this cohort's fault.
                entry.not_before = now + self.policy.fleet.recovery_backoff
                self._delayed.append(entry)
                self._flight.end(rid, SPAN_QUEUE)
                self._flight.begin(rid, SPAN_BACKOFF, recovered=True)
            else:
                self._queue.append(entry)
        obs.event("serve.recovery", recovered=len(replay.pending),
                  prior_outcomes=len(replay.outcomes),
                  torn=replay.torn_records)
        obs.gauge("serve.queue_depth",
                  len(self._queue) + len(self._delayed))

    # -- accounting ----------------------------------------------------

    def worker_device(self, worker_id: int) -> Optional[int]:
        """The fault-domain slot worker ``worker_id`` is bound to (None
        when unbound) — the placement lookup the device-loss chaos
        injectors use to target silicon rather than workers."""
        worker = self._pool.workers[int(worker_id)]
        return (worker.placement.device_id
                if worker.placement is not None else None)

    def outcomes(self) -> List[Outcome]:
        """Every outcome so far, in completion order."""
        return [self._outcomes[rid] for rid in self._order]

    def stats(self) -> dict:
        """The ledger: admitted vs terminated (the no-lost-request
        invariant is ``lost == 0`` once the queue is drained), latency
        percentiles on the service clock, and the shed rate.

        ``recovered`` counts requests adopted from a journal replay:
        they were admitted (and counted) by the crashed process, so this
        process's ledger balances admitted + recovered against outcomes
        — and the *merged* cross-process counters balance plain admitted
        against outcomes, which is how the chaos campaign asserts the
        invariant across a kill/replay boundary."""
        c = dict(self._counts)
        # Pending = every admitted request without an outcome yet —
        # queued, backing off, OR resident in a lane / mid-dispatch.
        # _pending_ids is exactly that set (discarded only when the
        # outcome is recorded), so the ledger stays honest when stats()
        # is read mid-flight between pump() calls (the open-loop seam).
        pending = len(self._pending_ids)
        lats = sorted(self._latencies)
        single = self.policy.fleet.workers == 1
        breakers = {}
        for w in self._pool.workers:
            for cohort, b in w.breakers.items():
                breakers[cohort if single else f"{cohort}@w{w.id}"] = \
                    b.state
        router = (self._router.stats() if self._router is not None
                  else None)
        tenants = None
        if self._tenancy is not None:
            tenants = self._tenancy.describe()
            for name, tracker in self._tenant_slo.items():
                row = tenants.setdefault(name, {})
                row["slo_budget_remaining"] = round(
                    tracker.budget_remaining(), 6)
        return {
            "admitted": c["admitted"],
            "completed": c["completed"],
            "errors": c["errors"],
            "shed": c["shed"],
            "recovered": c["recovered"],
            "pending": pending,
            **({"router": router} if router is not None else {}),
            **({"tenants": tenants} if tenants is not None else {}),
            "lost": (c["admitted"] + c["recovered"]
                     - (c["completed"] + c["errors"] + c["shed"])
                     - pending),
            "latency_seconds": {
                "p50": _percentile(lats, 0.50),
                "p95": _percentile(lats, 0.95),
                "p99": _percentile(lats, 0.99),
            },
            "shed_rate": (c["shed"] / c["admitted"] if c["admitted"]
                          else 0.0),
            "breakers": breakers,
            "workers": {w.id: w.state for w in self._pool.workers},
            "placement": {
                **self._registry.describe(),
                "bindings": {w.id: (w.placement.device_id
                                    if w.placement else None)
                             for w in self._pool.workers},
            },
        }

    def _publish_stats(self) -> None:
        s = self.stats()
        obs.gauge("serve.latency_seconds", s["latency_seconds"])
        obs.gauge("serve.p99_latency_seconds",
                  s["latency_seconds"]["p99"])
        obs.gauge("serve.shed_rate", round(s["shed_rate"], 6))
        obs.gauge("serve.queue_depth", s["pending"])
        obs.gauge("serve.lost_requests", s["lost"])
        if self._tenancy is not None:
            # Per-tenant gauges for the scoreboard's tenants pane —
            # flat scalar families (one suffix per tenant) so the
            # prefix scan renders them identically from a live
            # endpoint and a trace-dir snapshot.
            for name, row in self._tenancy.describe().items():
                obs.gauge(f"serve.tenant.share.{name}", row["share"])
                obs.gauge(f"serve.tenant.quota_tokens.{name}",
                          row["quota_tokens"])
                obs.gauge(f"serve.tenant.retry_tokens.{name}",
                          row["retry_tokens"])
            shortest = (min(self.policy.slo.burn_windows)
                        if self.policy.slo.burn_windows else None)
            for name, tracker in self._tenant_slo.items():
                tracker.publish()
                if shortest is not None:
                    obs.gauge(f"serve.tenant.slo_burn.{name}",
                              round(tracker.burn_rate(shortest), 4))
        if self._forecast is not None:
            self._forecast_backlog()
