"""Durable solver sessions: crash-safe ordered streams of dependent
solves admitted through the service (counterpart of
``poisson_tpu/serve/session.py``).

A *session* is a stream of dependent solves — transient
implicit-Euler time stepping and server-driven shape optimization are
sequences of requests against slowly-varying canvases
(Glowinski/Pan/Périaux's *possibly moving* domains, PAPERS.md). Each
step is an ordinary :class:`serve.types.SolveRequest` carrying session
identity (``session_id``/``session_step``) plus the session-only fields
(``mass_shift``, ``warm_start``/``warm_geometry``, ``on_solution``),
dispatched solo through :meth:`SolveService._dispatch_session` into the
fused session programs (``solvers.session``). The host in this module
owns everything *between* the steps:

- **Durability.** Every stream transition is journaled
  (``serve.journal`` ``session_*`` records): open (identity, kind,
  schedule params, problem dims, flight trace id), step submission
  (with warm-start PROVENANCE — the source step index, never the
  iterate), advance (the committed step boundary + the geometry it
  solved), close/shed. A killed process replays
  (:func:`serve.journal.replay_sessions` + :meth:`SessionHost.recover`)
  back to the exact step boundary: steps with a typed outcome are never
  re-run (the service's dedup guard holds across the crash), the
  mid-step request is re-enqueued COLD by the service's own recovery,
  and the stream continues from ``last_advanced + 1`` with no warm
  iterate — unreplayed device state is not evidence (as with the
  deflation cache). The ledger invariant
  ``admitted − (completed + errors + shed) == 0`` closes across the
  kill for the steps AND for the session root itself.

- **Ledger citizenship.** A session root is admitted like a request:
  ``open`` counts ``serve.admitted`` and roots one flight trace
  spanning the whole stream (``adopt()``-continued across crashes, span
  ids offset per generation); ``close`` counts ``serve.completed`` with
  one typed ``session`` outcome leaf; a shed open counts ``serve.shed``.
  One causal tree per stream, validated by the same
  ``flight.validate_trace`` contract as per-request traffic.

- **Warm-start handoff.** The previous step's converged iterate comes
  back through the request's ``on_solution`` hook (process memory) and
  rides the next step's ``warm_start``; the validity gate and its
  audible fallback live in the solver layer
  (``solvers.session.session_step_solve``).

- **The session rung of the degradation ladder.** A NEW session open
  sheds (``serve.session.shed_opens``) once queue depth crosses
  ``SessionPolicy.shed_open_at`` (default 0.75 of capacity) or
  ``max_sessions`` streams are already open — steps of in-flight
  sessions keep dispatching until the queue is actually full, because a
  half-finished stream is sunk cost.

- **Per-session SLO.** Scored at close on the session's own wall
  (``slo_seconds``, crash gap included via the adopted admit time):
  ``session.slo.good``/``session.slo.bad``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry.dsl import Ellipse, parse_geometry
from poisson_tpu_torch.obs.flight import (
    POINT_RECOVERED,
    POINT_SESSION_STEP,
    SPAN_RESIDENT,
)
from poisson_tpu_torch.serve.journal import replay_sessions
from poisson_tpu_torch.serve.types import (
    OUTCOME_RESULT,
    OUTCOME_SHED,
    Outcome,
    SolveRequest,
)

SESSION_KINDS = ("poisson", "heat", "design")

# The problem fields a session_open record persists (recovery rebuilds
# the Problem from them — the same contract as the journal's submit
# records).
_PROBLEM_FIELDS = ("M", "N", "x_min", "x_max", "y_min", "y_max", "f_val",
                   "delta", "max_iter", "weighted_norm")

_UNSET = object()


@dataclasses.dataclass
class SolveSession:
    """One open stream's host-side state. The *durable* subset (identity,
    kind, schedule params, committed boundary, geometry) is journaled;
    the warm iterate and design target are process memory only."""

    session_id: str
    problem: Problem
    kind: str = "poisson"
    dtype: Optional[str] = None
    mass_shift: float = 0.0
    geometry: object = None          # the current step's geometry spec
    trace_id: str = ""
    t_open: float = 0.0
    next_step: int = 0
    advanced: int = -1               # committed step boundary
    errors: int = 0                  # typed error/shed step outcomes
    generation: int = 1              # 1 + prior crash recoveries
    closed: bool = False
    recovered: bool = False
    params: dict = dataclasses.field(default_factory=dict)  # journaled
    design_params: Optional[dict] = None   # kind="design": cx/cy/rx/ry
    warm: Optional[np.ndarray] = None      # last converged iterate
    warm_geometry: object = None           # the spec that iterate solved
    warm_from: int = -1                    # its source step (journaled)

    @property
    def steps(self) -> int:
        return self.next_step


class SessionHost:
    """The session lifecycle layer over one :class:`SolveService`.

    Single-threaded like the service itself; uses the service's own
    clock, journal, and flight recorder so session records interleave
    with the per-request ones in one log and one trace dir."""

    def __init__(self, service):
        self._svc = service
        self._sessions: Dict[str, SolveSession] = {}

    @property
    def policy(self):
        return self._svc.policy.session

    def open_sessions(self) -> List[str]:
        return sorted(self._sessions)

    def _journal(self, kind: str, **fields) -> None:
        if self._svc._journal is not None:
            self._svc._journal.record(kind, **fields)

    # -- admission -----------------------------------------------------

    def open(self, session_id: str, problem: Problem, *,
             kind: str = "poisson", geometry=None, dtype=None,
             mass_shift: float = 0.0, design_params: Optional[dict] = None,
             params: Optional[dict] = None) -> Optional[SolveSession]:
        """Admit a new stream. Returns its :class:`SolveSession` handle,
        or ``None`` when the open was shed (the session rung: audible,
        journaled, one typed ``shed`` outcome on its own flight trace —
        the ledger counts it like any shed admission)."""
        sid = str(session_id)
        if kind not in SESSION_KINDS:
            raise ValueError(f"unknown session kind {kind!r} "
                             f"(one of {SESSION_KINDS})")
        if kind == "heat" and not mass_shift > 0.0:
            raise ValueError("heat sessions need mass_shift = 1/dt > 0")
        if kind == "design":
            if not isinstance(geometry, Ellipse) and design_params is None:
                raise ValueError("design sessions optimize ellipse "
                                 "parameters — open with an Ellipse "
                                 "geometry or design_params")
            if design_params is None:
                design_params = {"cx": float(geometry.cx),
                                 "cy": float(geometry.cy),
                                 "rx": float(geometry.rx),
                                 "ry": float(geometry.ry)}
        if sid in self._sessions:
            raise ValueError(f"session {sid!r} is already open — "
                             "stream identity must be unique")
        svc = self._svc
        # The session root is a ledger citizen: admitted here, one typed
        # outcome at close/shed. (The service's internal request ledger
        # is untouched — sessions are not queue entries.)
        obs.inc("serve.admitted")
        trace_id = svc._flight.admit(sid)
        depth = len(svc._queue) + len(svc._delayed)
        frac = depth / svc.policy.capacity
        open_count = len(self._sessions)
        shed_reason = ""
        if open_count >= self.policy.max_sessions:
            shed_reason = "max_sessions"
        elif frac >= self.policy.shed_open_at:
            # The degradation ladder's session rung: new streams shed
            # well before the queue is full, so steps of in-flight
            # sessions (sunk cost) keep their headroom.
            shed_reason = "overload"
        if shed_reason:
            obs.inc("serve.shed")
            obs.inc("serve.session.shed_opens")
            obs.event("session.shed_open", session_id=sid,
                      reason=shed_reason, open_sessions=open_count,
                      queue_fraction=round(frac, 4))
            self._journal("session_shed", session_id=sid,
                          reason=shed_reason)
            svc._flight.outcome(sid, OUTCOME_SHED, shed_reason)
            return None
        obs.inc("session.opens")
        record_params = dict(params or {})
        record_params["dtype"] = dtype
        record_params["mass_shift"] = float(mass_shift)
        record_params["problem"] = {k: getattr(problem, k)
                                    for k in _PROBLEM_FIELDS}
        if design_params is not None:
            record_params["design"] = dict(design_params)
        self._journal(
            "session_open", session_id=sid, session_kind=kind,
            trace_id=trace_id, params=record_params,
            geometry=(geometry.to_json() if geometry is not None
                      else None))
        t_open = svc._clock()
        svc._flight.begin(sid, SPAN_RESIDENT, mode="session", kind=kind)
        sess = SolveSession(
            session_id=sid, problem=problem, kind=kind, dtype=dtype,
            mass_shift=float(mass_shift), geometry=geometry,
            trace_id=trace_id, t_open=t_open, params=record_params,
            design_params=design_params)
        self._sessions[sid] = sess
        return sess

    # -- stepping ------------------------------------------------------

    def step(self, sess: SolveSession, geometry=_UNSET,
             rhs_gate: Optional[float] = None) -> Outcome:
        """Submit and drive the stream's next step to its typed outcome.

        ``geometry`` moves the domain for this step (omitted = the
        session's current spec). The step is journaled before admission
        (with warm provenance), admitted through ``service.submit`` —
        which dedups it against a pre-crash outcome, so a replayed step
        is never executed twice — and advanced in the journal once its
        outcome exists. The converged iterate comes back through the
        request's ``on_solution`` hook and becomes the next step's warm
        start."""
        if sess.closed:
            raise ValueError(f"session {sess.session_id!r} is closed")
        svc = self._svc
        k = sess.next_step
        sid = sess.session_id
        rid = f"{sid}#{k:04d}"
        geo = sess.geometry if geometry is _UNSET else geometry
        sess.geometry = geo
        warm_from = sess.warm_from if sess.warm is not None else -1
        self._journal("session_step", session_id=sid, step=k,
                      request_id=rid, warm_from=warm_from)
        holder: dict = {}
        req = SolveRequest(
            request_id=rid, problem=sess.problem, dtype=sess.dtype,
            geometry=geo,
            rhs_gate=1.0 if rhs_gate is None else float(rhs_gate),
            session_id=sid, session_step=k,
            mass_shift=sess.mass_shift,
            warm_start=sess.warm, warm_geometry=sess.warm_geometry,
            on_solution=lambda w: holder.__setitem__("w", w),
            deadline_seconds=self.policy.step_deadline_seconds,
        )
        out = None
        if rid in svc._pending_ids:
            # The service's own journal recovery already re-enqueued
            # this step (COLD — warm fields never replay): drive it to
            # its outcome instead of re-admitting it.
            for o in svc.drain():
                if str(o.request_id) == rid:
                    out = o
        elif rid in svc._prior_outcomes:
            # Typed before the crash but not yet advanced in the
            # session records: fold the journal's outcome truth in —
            # never execute the step twice.
            out = svc._prior_outcomes[rid]
        else:
            out = svc.submit(req)
            if out is None:
                for o in svc.drain():
                    if str(o.request_id) == rid:
                        out = o
        if out is None:       # the service broke its own ledger contract
            raise RuntimeError(f"session step {rid} has no outcome")
        sess.next_step = k + 1
        ok = out.kind == OUTCOME_RESULT
        if not ok:
            sess.errors += 1
        svc._flight.point(sid, POINT_SESSION_STEP, step=k,
                          outcome=out.kind,
                          iterations=int(out.iterations),
                          warm_from=warm_from)
        # The committed boundary: this step has its one typed outcome —
        # a recovery must continue AFTER it, never re-run it.
        self._journal("session_advance", session_id=sid, step=k,
                      outcome=out.kind,
                      geometry=(geo.to_json() if geo is not None
                                else None))
        sess.advanced = k
        if ok and "w" in holder:
            sess.warm = holder["w"]
            sess.warm_geometry = geo
            sess.warm_from = k
        return out

    def design_step(self, sess: SolveSession, target, lr: float):
        """One server-driven shape-optimization step: differentiate the
        mismatch against ``target`` at the current ellipse parameters
        (``solvers.session.design_step`` — one forward + one adjoint
        solve), descend, then admit the solve at the MOVED ellipse as
        the session's next step (warm-started from the previous iterate
        when the move is within the drift bound). Returns
        ``(outcome, loss, grads)``; the moved parameters are journaled
        with the step's advance record, so recovery resumes the descent
        from the committed ellipse."""
        from poisson_tpu_torch.solvers.session import design_step

        if sess.kind != "design":
            raise ValueError(f"session {sess.session_id!r} is "
                             f"kind={sess.kind!r}, not a design stream")
        new_params, loss, grads = design_step(
            sess.problem, sess.design_params, target, lr,
            dtype=sess.dtype, device=self._svc._device)
        sess.design_params = new_params
        geo = Ellipse(cx=new_params["cx"], cy=new_params["cy"],
                      rx=new_params["rx"], ry=new_params["ry"])
        out = self.step(sess, geometry=geo)
        return out, loss, grads

    # -- termination ---------------------------------------------------

    def close(self, sess: SolveSession) -> dict:
        """Close the stream: one typed ``session`` outcome on its flight
        trace (spans folded, decomposition summing to the stream's
        wall), the per-session SLO scored, the journal's terminal
        record written, and the session root completed in the ledger."""
        if sess.closed:
            raise ValueError(f"session {sess.session_id!r} is closed")
        sess.closed = True
        sid = sess.session_id
        self._sessions.pop(sid, None)
        svc = self._svc
        wall = max(0.0, svc._clock() - sess.t_open)
        good = sess.errors == 0 and wall <= self.policy.slo_seconds
        obs.inc("session.slo.good" if good else "session.slo.bad")
        obs.inc("session.closes")
        self._journal("session_close", session_id=sid,
                      steps=sess.next_step, errors=sess.errors,
                      slo_good=good)
        obs.inc("serve.completed")
        fo = svc._flight.outcome(sid, OUTCOME_RESULT, "session",
                                 attempts=max(1, sess.next_step))
        obs.event("session.closed", session_id=sid,
                  steps=sess.next_step, errors=sess.errors,
                  wall_s=round(wall, 4), slo_good=good,
                  generation=sess.generation)
        return {"session_id": sid, "steps": sess.next_step,
                "errors": sess.errors, "wall_s": wall,
                "slo_good": good, "trace_id": fo["trace_id"],
                "decomposition": fo["decomposition"]}

    # -- crash recovery ------------------------------------------------

    def recover(self) -> List[SolveSession]:
        """Re-open every stream the journal shows open, at its exact
        committed boundary. Call on a service built by
        ``SolveService.recover`` (the per-request half: prior outcomes
        deduped, the mid-step request re-enqueued cold). Each recovered
        stream adopts its original flight trace (span ids offset one
        generation past the dead process's), re-journals its open (so a
        second crash recovers with the generation bumped again), and
        continues from ``last_advanced + 1`` with NO warm iterate —
        device state died with the process, and replaying it is not
        recovery, it is guessing."""
        svc = self._svc
        if svc._journal is None:
            return []
        reps = replay_sessions(svc._journal.path)
        now = svc._clock()
        recovered: List[SolveSession] = []
        for sid, rep in sorted(reps.items()):
            if not rep.open or sid in self._sessions:
                continue
            params = dict(rep.params)
            try:
                problem = Problem(**params["problem"])
            except (KeyError, TypeError, ValueError) as e:
                obs.inc("session.recovery_errors")
                obs.event("session.recovery_error", session_id=sid,
                          error=f"problem unreconstructable: {e}")
                continue
            geo = None
            if rep.advanced_geometry:
                try:
                    geo = parse_geometry(rep.advanced_geometry)
                except (KeyError, TypeError, ValueError):
                    obs.inc("session.recovery_errors")
                    geo = None
            obs.inc("session.recovered")
            t_open = rep.t_open if 0.0 <= rep.t_open <= now else now
            if rep.trace_id:
                svc._flight.adopt(sid, rep.trace_id, t_open,
                                  span_base=1000 * rep.generations)
                trace_id = rep.trace_id
            else:
                trace_id = svc._flight.admit(sid)
            svc._flight.point(sid, POINT_RECOVERED,
                              reason="journal_replay",
                              generation=rep.generations,
                              boundary=rep.last_advanced)
            svc._flight.begin(sid, SPAN_RESIDENT, mode="session",
                              kind=rep.kind, recovered=True)
            self._journal("session_open", session_id=sid,
                          session_kind=rep.kind, trace_id=trace_id,
                          params=params, recovered=True)
            design = params.get("design")
            if design is not None and isinstance(geo, Ellipse):
                # The committed ellipse IS the descent state: resume
                # the optimization from the last advanced step's
                # parameters, not the opening ones.
                design = {"cx": float(geo.cx), "cy": float(geo.cy),
                          "rx": float(geo.rx), "ry": float(geo.ry)}
            sess = SolveSession(
                session_id=sid, problem=problem, kind=rep.kind,
                dtype=params.get("dtype"),
                mass_shift=float(params.get("mass_shift", 0.0)),
                geometry=geo, trace_id=trace_id, t_open=t_open,
                next_step=rep.last_advanced + 1,
                advanced=rep.last_advanced,
                generation=rep.generations + 1,
                recovered=True, params=params,
                design_params=design)
            self._sessions[sid] = sess
            recovered.append(sess)
        return recovered
