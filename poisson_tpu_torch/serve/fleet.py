"""The solve fleet: supervised workers over the shared admission queue
(counterpart of ``poisson_tpu/serve/fleet.py``).

Per-device workers pull from the shared admission queue, with
breaker/degradation state keyed per worker cohort. This module is the
worker half of that split: a
:class:`WorkerPool` of N :class:`Worker` dispatch contexts that the
service's pump loop schedules cooperatively — deterministic under an
injected clock, which is what lets the chaos campaign kill, hang and
poison workers mid-dispatch and still be a regression suite. (OS-thread
or per-process execution is a deployment mapping of the same states; the
supervisor API is execution-agnostic — Orca's scheduler/engine split,
PAPERS.md.)

Each worker owns:

- a **sticky set of bucket executables** (the cohorts it has dispatched
  — routing prefers the worker that already has the head's executable
  hot: ``serve.fleet.sticky_{hits,misses}``);
- its **own circuit-breaker registry** (a wedged worker trips *its*
  breakers, not the fleet's) and its own lane table in continuous mode;
- a **heartbeat watchdog** (``parallel.watchdog.Watchdog`` on the
  service clock, no monitor thread): the worker beats at every dispatch
  and chunk boundary, and the supervisor's synchronous
  :meth:`~poisson_tpu_torch.parallel.watchdog.Watchdog.check` turns a
  too-long gap into a stall verdict.

Worker lifecycle (README "Solve fleet & durability" has the diagram)::

    RUNNING ──crash/hang/stall──▶ QUARANTINED ──cooldown──▶ RUNNING
       ▲                              │                    (restart
       └────────── warm-up ◀──────────┘                     counted)
                                      └─ max_restarts ──▶ DEAD

A quarantined worker's in-flight requests are recovered (mutual taint +
backoff, ``serve.fleet.recovered_requests``) and re-dispatched to the
survivors; the restart replays warm-up over the worker's sticky buckets
before it takes traffic again. When every worker is dead, the service
fails remaining work with typed internal errors — the ledger invariant
holds even through total fleet loss.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

from poisson_tpu_torch import obs
from poisson_tpu_torch.parallel.watchdog import Watchdog
from poisson_tpu_torch.serve.placement import (DeviceRegistry,
                                               PlacementError,
                                               default_devices)
from poisson_tpu_torch.serve.types import FleetPolicy

WORKER_RUNNING = "running"
WORKER_QUARANTINED = "quarantined"
WORKER_DEAD = "dead"


class WorkerCrashError(RuntimeError):
    """The worker executing a dispatch died (process kill, device loss,
    injected chaos). Unlike :class:`~poisson_tpu_torch.serve.types.
    TransientDispatchError` — a fault of the *dispatch* — this is a
    fault of the *worker*: the supervisor quarantines it, recovers its
    in-flight requests onto the survivors, and restarts it through
    warm-up."""


class WorkerHangError(RuntimeError):
    """The worker wedged mid-dispatch long enough for its heartbeat
    watchdog to fire (the injected-chaos analog of a stuck collective).
    Same recovery path as a crash, with the stall verdict landing on
    ``watchdog.stalls`` first."""


class DeviceLossError(WorkerCrashError):
    """The worker's *device* died mid-dispatch (the
    device-unavailable shape: a card dropping off the bus, a host
    losing its PCIe link, injected chaos). A strict superset of a
    worker crash: the fault domain is the silicon, so the supervisor
    quarantines EVERY worker bound to the lost device — not just the
    one whose dispatch surfaced the loss — marks the device lost in
    the placement registry (epoch bump), and rebinds the quarantined
    workers to surviving devices at restart. ``device_id`` names the
    lost fault domain; None means "whatever the dispatching worker is
    bound to" (the bench churn injector's case)."""

    def __init__(self, message: str, device_id: Optional[int] = None):
        super().__init__(message)
        self.device_id = device_id


class Worker:
    """One dispatch context: sticky executables, breaker registry, lane
    table, heartbeat. Scheduled by the pool; stepped by the service."""

    __slots__ = ("id", "state", "breakers", "table", "watchdog",
                 "sticky", "restarts", "quarantined_until",
                 "quarantine_reason", "placement")

    def __init__(self, worker_id: int, timeout: float,
                 clock: Callable[[], float], placement=None):
        self.id = worker_id
        self.state = WORKER_RUNNING
        self.breakers: dict = {}
        self.table = None             # continuous mode's live LaneTable
        self.watchdog = Watchdog(timeout=timeout, clock=clock)
        self.watchdog.beat(worker=worker_id)
        # cohort -> {"problem", "dtype", "buckets": {widths dispatched}}
        self.sticky: dict = {}
        self.restarts = 0
        self.quarantined_until = 0.0
        self.quarantine_reason = ""
        # serve.placement.Placement: the device this worker is bound to
        # — sticky executables compile ON it, breaker/integrity cohorts
        # key on it, and a device loss quarantines every worker that
        # shares it (the fault domain).
        self.placement = placement


class WorkerPool:
    """Supervisor bookkeeping for the fleet. The pool owns worker
    lifecycle state and scheduling order; the *service* owns the queue,
    the ledger, and the dispatch machinery — a worker is somewhere for
    the service to run a dispatch, never a second source of truth."""

    def __init__(self, policy: FleetPolicy,
                 clock: Callable[[], float] = time.monotonic,
                 registry: Optional[DeviceRegistry] = None,
                 device=None):
        if policy.workers < 1:
            raise ValueError("fleet.workers must be >= 1")
        if policy.max_restarts < 0:
            raise ValueError("fleet.max_restarts must be >= 0")
        self.policy = policy
        self._clock = clock
        # The placement registry binds every worker to a device slot at
        # construction (round-robin over the topology), backed by
        # ``device``'s devices (None: every CUDA card). The default —
        # one slot on the first device — is the pre-placement fleet:
        # every worker on one device, one fault domain.
        self.registry = registry if registry is not None else \
            DeviceRegistry(count=policy.devices
                           if policy.devices is not None else 1,
                           devices=default_devices(device))
        self.workers: List[Worker] = [
            Worker(i, policy.heartbeat_timeout, clock,
                   placement=self.registry.bind(i))
            for i in range(policy.workers)
        ]
        self._rr = 0
        obs.gauge("serve.fleet.workers", policy.workers)
        self._publish()

    def workers_on_device(self, device_id: int) -> List[Worker]:
        """Every worker bound to fault domain ``device_id`` — who
        shares a fate when that silicon dies."""
        return [w for w in self.workers
                if w.placement is not None
                and w.placement.device_id == int(device_id)]

    # -- scheduling ----------------------------------------------------

    def running(self) -> List[Worker]:
        return [w for w in self.workers if w.state == WORKER_RUNNING]

    def all_dead(self) -> bool:
        return all(w.state == WORKER_DEAD for w in self.workers)

    def release_due(self) -> List[Worker]:
        """Quarantined workers whose cooldown has passed — the service
        restarts each through warm-up before scheduling it."""
        now = self._clock()
        return [w for w in self.workers
                if w.state == WORKER_QUARANTINED
                and w.quarantined_until <= now]

    def earliest_release(self) -> Optional[float]:
        times = [w.quarantined_until for w in self.workers
                 if w.state == WORKER_QUARANTINED]
        return min(times) if times else None

    def next_worker(self, head_cohort: Optional[str] = None
                    ) -> Optional[Worker]:
        """The next worker to step: sticky preference first (the worker
        whose executable cache already holds the queue head's cohort),
        else round-robin over RUNNING workers. None when nothing runs."""
        live = self.running()
        if not live:
            return None
        if head_cohort is not None and len(live) > 1:
            sticky = [w for w in live if head_cohort in w.sticky
                      or (w.table is not None
                          and w.table.cohort == head_cohort)]
            if sticky:
                obs.inc("serve.fleet.sticky_hits")
                return sticky[0]
            obs.inc("serve.fleet.sticky_misses")
        worker = live[self._rr % len(live)]
        self._rr += 1
        return worker

    # -- lifecycle -----------------------------------------------------

    def quarantine(self, worker: Worker, reason: str) -> None:
        """RUNNING → QUARANTINED (idempotent for an already-dead
        worker). The caller has already evicted/recovered the worker's
        in-flight entries — the pool only records the verdict."""
        if worker.state == WORKER_DEAD:
            return
        worker.state = WORKER_QUARANTINED
        worker.quarantined_until = (self._clock()
                                    + self.policy.quarantine_seconds)
        worker.quarantine_reason = reason
        worker.table = None
        obs.inc("serve.fleet.quarantines")
        obs.event("serve.fleet.quarantine", worker=worker.id,
                  reason=reason, restarts=worker.restarts)
        self._publish()

    def restart(self, worker: Worker) -> Optional[dict]:
        """QUARANTINED → RUNNING through warm-up, or → DEAD when the
        restart budget is spent. Returns the sticky map to warm (the
        service runs the compiles — the pool holds no solver imports),
        or None when the worker died instead.

        Topology-aware: a worker whose bound device died since the
        quarantine is REBOUND to a surviving device before it runs
        again (its sticky buckets warm up there through the ordinary
        warm-up); with no survivor at all the worker dies —
        restarts cannot manufacture silicon."""
        if worker.restarts >= self.policy.max_restarts:
            worker.state = WORKER_DEAD
            obs.inc("serve.fleet.worker_deaths")
            obs.event("serve.fleet.worker_dead", worker=worker.id,
                      restarts=worker.restarts,
                      reason=worker.quarantine_reason)
            self._publish()
            return None
        if (worker.placement is not None
                and not self.registry.is_alive(worker.placement.device_id)):
            try:
                rebound = self.registry.bind(worker.id)
            except PlacementError:
                worker.state = WORKER_DEAD
                obs.inc("serve.fleet.worker_deaths")
                obs.event("serve.fleet.worker_dead", worker=worker.id,
                          restarts=worker.restarts, reason="no_devices")
                self._publish()
                return None
            obs.inc("serve.placement.rebinds")
            obs.event("serve.placement.rebind", worker=worker.id,
                      from_device=worker.placement.device_id,
                      to_device=rebound.device_id,
                      epoch=rebound.epoch)
            worker.placement = rebound
        worker.restarts += 1
        worker.state = WORKER_RUNNING
        # A fresh heartbeat watchdog: the stall verdict is one-shot per
        # instance, and the new incarnation starts with a clean record.
        worker.watchdog = Watchdog(timeout=self.policy.heartbeat_timeout,
                                   clock=self._clock)
        worker.watchdog.beat(worker=worker.id, restart=worker.restarts)
        obs.inc("serve.fleet.restarts")
        obs.event("serve.fleet.restart", worker=worker.id,
                  restarts=worker.restarts,
                  reason=worker.quarantine_reason)
        self._publish()
        return dict(worker.sticky) if self.policy.warm_restart else {}

    def _publish(self) -> None:
        obs.gauge("serve.fleet.live_workers", len(self.running()))
