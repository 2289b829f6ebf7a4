"""The refill state machine: service-side lane table for continuous batching
(counterpart of ``poisson_tpu/serve/refill.py``).

``solvers.lanes.LaneBatch`` is the solver half (a resumable stepping
program over a fixed bucket of lanes); this module is the service half —
a :class:`LaneTable` that binds each lane to the service's queue-resident
request entry and makes every transition of the lane lifecycle

    EMPTY ──splice──▶ ACTIVE ──verdict/deadline/cap──▶ RETIRING ──▶ EMPTY

audible as ``serve.refill.*`` counters:

- ``serve.refill.splices`` — queued RHS spliced into freed lanes;
- ``serve.refill.retired_lanes`` — lanes retired to a typed outcome
  (converged, partial, or failure verdict — eviction on a batch-killing
  fault is counted by the retry machinery instead);
- ``serve.refill.idle_lane_steps`` — Σ over chunk steps of EMPTY lanes
  the fused program still paid compute width for (the utilization loss
  refill exists to minimize);
- ``serve.refill.refill_denied_by_breaker`` — refill decisions refused
  because the cohort's circuit breaker was not accepting work
  (incremented by the service at the decision point).

The scheduling policy — breaker checks, degradation re-checks, taint
compatibility, retries — lives in ``serve.service``; this class only
guarantees occupancy bookkeeping: a lane is at all times either EMPTY or
attributed to exactly one request entry, and an entry leaves the table
only through ``retire`` (with its iterate) or ``evict_all`` (a dispatch
fault that owes every member a retry or a typed error). That is the
structural half of the no-lost-request invariant.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

from poisson_tpu_torch import obs
from poisson_tpu_torch.solvers.lanes import LaneBatch, LaneResult

LANE_EMPTY = "empty"
LANE_ACTIVE = "active"
LANE_RETIRING = "retiring"


class LaneTable:
    """A :class:`~poisson_tpu_torch.solvers.lanes.LaneBatch` whose lanes carry
    the service's request entries. ``cohort``/``problem``/``dtype_name``
    pin what may splice in (checked by the service's refill decision);
    ``entries[lane]`` is the occupant (None = EMPTY)."""

    def __init__(self, cohort: str, problem, dtype, bucket: int,
                 chunk: int, worker_id: int = 0,
                 multi_geometry: bool = False, verify_every: int = 0,
                 verify_tol=None, preconditioner: str = "jacobi",
                 device=None):
        self.cohort = cohort
        self.problem = problem
        self.worker_id = worker_id
        # The owning worker's bound torch.device (serve.placement): the
        # lane stepping program compiles and runs there, not on the
        # process default device.
        self.device = device
        self.multi_geometry = bool(multi_geometry)
        # The per-lane integrity probe (poisson_tpu_torch.integrity): decided
        # at table construction like multi_geometry — an occupied
        # program's operand signature can never change, so a service
        # turning defensive verification on (suspect-cohort taint)
        # applies it to the NEXT table, never retrofits a running one.
        self.verify_every = int(verify_every)
        # The preconditioner is program identity too (the :mg cohort
        # marker means a table is only ever offered same-preconditioner
        # entries; carried here so the lane programs match the cohort).
        self.preconditioner = preconditioner or "jacobi"
        self.batch = LaneBatch(
            problem, bucket, dtype=dtype, chunk=chunk,
            multi_geometry=multi_geometry,
            verify_every=verify_every, verify_tol=verify_tol,
            preconditioner=self.preconditioner,
            device=device,
            # Chunk-boundary hook (solvers.lanes): each boundary is a
            # timeline event, so a wedged lane program's last boundary
            # is on disk for forensics — attributed to the worker that
            # owns the program (serve.fleet). Host-side only — flag-off
            # lane programs are byte-identical.
            on_boundary=lambda acc: obs.event(
                "serve.refill.chunk_boundary", cohort=cohort,
                worker=worker_id, **acc),
        )
        self.entries: List[Optional[object]] = [None] * self.batch.bucket
        self.dtype_name = self.batch.dtype_name
        # Per-lane iteration high-water marks: advance_marks() turns two
        # consecutive boundaries into per-member iteration deltas — the
        # flight recorder's compute-apportionment input.
        self._k_mark: List[int] = [0] * self.batch.bucket

    @property
    def bucket(self) -> int:
        return self.batch.bucket

    def occupied(self) -> bool:
        return any(e is not None for e in self.entries)

    def free_lane_count(self) -> int:
        return sum(1 for e in self.entries if e is None)

    def occupants(self) -> List[object]:
        return [e for e in self.entries if e is not None]

    def occupant_ids(self) -> Set:
        return {e.request.request_id for e in self.entries
                if e is not None}

    def occupant_taints(self) -> Set:
        taints: Set = set()
        for e in self.entries:
            if e is not None:
                taints |= e.taint
        return taints

    def occupant_fps(self) -> Set:
        from poisson_tpu_torch.geometry.dsl import fingerprint_of

        return {fingerprint_of(e.request.geometry)
                for e in self.entries
                if e is not None and e.request.geometry is not None}

    def occupant_fp_taints(self) -> Set:
        taints: Set = set()
        for e in self.entries:
            if e is not None:
                taints |= e.taint_fp
        return taints

    def taint_compatible(self, entry) -> bool:
        """True iff ``entry`` may share lanes with the current occupants:
        none of them is on its never-co-batch list and it is on none of
        theirs — the taint-pair exclusion that must hold *across a
        splice*, not just at batch formation. Keys on (request,
        fingerprint): the request-id pairs AND the geometry-fingerprint
        pairs are both checked, so a bad geometry cannot rejoin its
        batchmates under a fresh request id either."""
        from poisson_tpu_torch.geometry.dsl import fingerprint_of

        ids = self.occupant_ids()
        if (entry.taint & ids) or (
                entry.request.request_id in self.occupant_taints()):
            return False
        if entry.request.geometry is not None and \
                fingerprint_of(entry.request.geometry) in \
                self.occupant_fp_taints():
            return False
        return not (entry.taint_fp & self.occupant_fps())

    def splice(self, entry, rhs_gate: float = 1.0) -> int:
        """EMPTY → ACTIVE for ``entry``; returns the lane. On a
        multi-geometry table the entry's canvases splice in with its
        state (``solvers.lanes``) — same executable, new domain."""
        lane = self.batch.splice(
            entry.request.request_id, rhs_gate,
            geometry=(entry.request.geometry if self.multi_geometry
                      else None))
        self.entries[lane] = entry
        self._k_mark[lane] = 0      # a spliced member starts at k = 0
        obs.inc("serve.refill.splices")
        obs.event("serve.refill.splice", cohort=self.cohort, lane=lane,
                  request_id=str(entry.request.request_id),
                  occupancy=len(self.occupants()),
                  worker=self.worker_id)
        return lane

    def step(self) -> dict:
        """One chunk over every ACTIVE lane (EMPTY lanes ride as frozen
        width — counted as idle)."""
        accounting = self.batch.step()
        obs.inc("serve.refill.idle_lane_steps", accounting["idle"])
        obs.gauge("serve.refill.active_lanes", accounting["active"])
        return accounting

    def lane_view(self) -> List[dict]:
        """Per-lane host truth (``solvers.lanes.LaneBatch.lane_view``)
        with the lifecycle state attached."""
        views = self.batch.lane_view()
        for v in views:
            v["state"] = (LANE_EMPTY if v["member_id"] is None
                          else LANE_ACTIVE)
        return views

    def advance_marks(self, views: List[dict]) -> dict:
        """Iteration deltas since the previous boundary, per occupied
        lane (``{lane: dk}``), advancing the marks — what one chunk
        step actually bought each member, the flight recorder's
        compute-apportionment input (``obs.costs.apportion_compute``)."""
        deltas = {}
        for v in views:
            lane = v["lane"]
            if self.entries[lane] is None:
                continue
            deltas[lane] = max(0, v["k"] - self._k_mark[lane])
            self._k_mark[lane] = v["k"]
        return deltas

    def retire(self, lane: int) -> Tuple[object, LaneResult]:
        """ACTIVE → RETIRING → EMPTY: pull the lane's entry and its
        attributed solver result; the slot is EMPTY on return."""
        entry = self.entries[lane]
        if entry is None:
            raise ValueError(f"lane {lane} is EMPTY")
        result = self.batch.retire(lane)
        assert result.member_id == entry.request.request_id, (
            "lane identity drifted: lane result for "
            f"{result.member_id!r} but entry is "
            f"{entry.request.request_id!r}"
        )
        self.entries[lane] = None
        obs.inc("serve.refill.retired_lanes")
        obs.event("serve.refill.retire", cohort=self.cohort, lane=lane,
                  request_id=str(entry.request.request_id),
                  iterations=result.iterations, flag=result.flag_name,
                  worker=self.worker_id)
        return entry, result

    def evict_all(self) -> List[object]:
        """A dispatch-level fault killed the device program: clear every
        lane WITHOUT producing results (the members' in-flight progress
        died with the program) and hand the entries back — each one is
        owed a retry or a typed error by the caller."""
        evicted = []
        for lane, entry in enumerate(self.entries):
            if entry is None:
                continue
            self.batch.retire(lane)    # discard the poisoned iterate
            self.entries[lane] = None
            evicted.append(entry)
        return evicted
