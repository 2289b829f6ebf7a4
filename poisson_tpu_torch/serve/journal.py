"""Crash-safe request journal: a CRC-sealed, append-only write-ahead log
of every request lifecycle transition (counterpart of
``poisson_tpu/serve/journal.py``, in its format: either package replays
the other's journal).

The service's ledger invariant — every admitted request terminates with
exactly one typed outcome — lived, until this module, only in process
memory: a crash (preemption, OOM, a wedged device taking the host down)
silently voided it for every request that was queued or lane-resident at
the moment of death. The journal is the durable half of the invariant:

- **append-only JSONL**, one record per transition (``submit``,
  ``dispatch``/``dispatch_end``, ``splice``/``retire``, ``requeue``,
  ``recover``, ``outcome``), each line sealed with a CRC32 over its
  canonical payload (the same zlib.crc32 sealing idiom as
  ``solvers.checkpoint``) and flushed before the transition is
  considered taken — a submit that was acknowledged is on disk;

- **replay** (:func:`replay_journal`) folds the log back into ledger
  truth: which requests got their one typed outcome, which were still
  queued or in flight when the log stops, and with how many dispatch
  attempts. Requests co-resident in an open dispatch at the crash are
  returned mutually tainted — the crash may have been one of them;

- **torn tails are tolerated audibly**, like ``obs.trace``'s
  ``merge_trace_dir``: a truncated final line (the crash landed
  mid-write) or a CRC-failing record is skipped, counted
  (``serve.journal.torn_records``), and reported in the replay — never
  silently trusted, never fatal. A torn *submit* means the client was
  never acknowledged, so dropping it is correct; a torn mid-file record
  degrades attempt/taint detail, never outcome truth, because outcomes
  are whole lines too.

``SolveService.recover`` re-enqueues every replayed pending request with
a ``recovered`` taint/backoff path and counts it as ``serve.recovered``
(NOT as a fresh admission — the original process already counted the
admission, so merged ``serve.*`` snapshots close the invariant across
the crash boundary: admitted − (completed + errors + shed) == 0).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
import zlib
from typing import Callable, Dict, List, Optional, Set

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.serve.types import SolveRequest

SCHEMA = "poisson_tpu.serve.journal/1"   # the JAX package's format

# The request fields a submit record persists (everything a recovery
# needs to rebuild the SolveRequest; ``on_chunk``/``on_solution`` hooks
# are process handles and deliberately do not survive — recovery notes
# their loss). Session identity (session_id/session_step/mass_shift)
# replays so a recovered step re-enters the SAME stream; the warm-start
# iterate (``warm_start``/``warm_geometry``) deliberately does NOT —
# mid-step work is re-enqueued COLD, never resumed from unreplayed
# device state.
_REQUEST_FIELDS = ("rhs_gate", "dtype", "deadline_seconds", "chunk",
                   "max_attempts", "device_id", "session_id",
                   "session_step", "mass_shift")
_PROBLEM_FIELDS = ("M", "N", "x_min", "x_max", "y_min", "y_max", "f_val",
                   "delta", "max_iter", "weighted_norm")


def _seal(payload: dict) -> int:
    """CRC32 over the canonical (sorted-key) JSON of ``payload``."""
    blob = json.dumps(payload, sort_keys=True, default=str)
    return zlib.crc32(blob.encode()) & 0xFFFFFFFF


class SolveJournal:
    """Append-only journal bound to one file. Single-writer by design —
    the service's dispatch loop is the only caller, exactly like the
    breaker registry. ``clock`` is the service clock (injectable, so
    chaos replays are deterministic); ``fsync`` forces each record to
    the device (the flush-only default survives process death, which is
    the failure mode the chaos drills exercise; fsync additionally
    survives kernel/power loss at a per-record cost)."""

    def __init__(self, path: str, *,
                 clock: Callable[[], float] = time.monotonic,
                 fsync: bool = False):
        self.path = path
        self._clock = clock
        self._fsync = fsync
        self._seq = 0
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        # Append mode: a recovery process continues the same file, so
        # the journal carries the whole multi-process history of the
        # ledger (replay_journal reads it end to end).
        self._fh = open(path, "a")

    def record(self, kind: str, **fields) -> None:
        """Seal and append one transition. Best-effort on OSError after
        open succeeds: a failing journal disk must not take the service
        down mid-dispatch (the in-memory ledger still holds; durability
        is degraded, audibly)."""
        self._seq += 1
        payload = {"seq": self._seq, "kind": kind,
                   "t": round(self._clock(), 6), **fields}
        payload["crc32"] = _seal(payload)
        try:
            self._fh.write(json.dumps(payload, sort_keys=True,
                                      default=str) + "\n")
            self._fh.flush()
            if self._fsync:
                os.fsync(self._fh.fileno())
        except (OSError, ValueError):
            obs.inc("serve.journal.write_errors")
            return
        obs.inc("serve.journal.records")

    def submit(self, request: SolveRequest, trace_id: str) -> None:
        req = {k: getattr(request, k) for k in _REQUEST_FIELDS}
        if request.tenant is not None:
            # Tenant identity rides the journal (only when set, so
            # tenancy-off journals stay byte-identical): a recovery
            # must rebuild each tenant's fair share and re-charge its
            # retry budget — a poisoned tenant cannot launder its
            # amplification cap through a process crash.
            req["tenant"] = request.tenant
        if request.geometry is not None:
            # The spec's canonical JSON reconstructs the geometry on
            # replay (raw-SDF specs serialize name-only and replay as
            # unreconstructable — audibly torn, never silently solved
            # as the wrong domain).
            req["geometry"] = request.geometry.to_json()
        if request.krylov is not None:
            # The request-level Krylov knobs replay too: a recovered
            # block/deflation request must re-dispatch through the SAME
            # cohort and program family it was admitted into (the basis
            # itself is never journaled — device state rebuilds,
            # poisson_tpu_torch.krylov.recycle).
            import dataclasses as _dc

            req["krylov"] = _dc.asdict(request.krylov)
        self.record(
            "submit", request_id=str(request.request_id),
            trace_id=trace_id,
            problem={k: getattr(request.problem, k)
                     for k in _PROBLEM_FIELDS},
            request=req,
            has_hook=request.on_chunk is not None,
        )

    def close(self) -> None:
        try:
            self._fh.close()
        except OSError:
            pass


# Session lifecycle record kinds (poisson_tpu_torch.serve.session): every
# step transition of a durable session is journaled so ``--recover``
# replays a killed process back to the exact step boundary.
#
# - ``session_open``  — the stream was admitted: identity, kind
#   (poisson|heat|design), base geometry JSON, schedule parameters, and
#   the session's flight trace id (adopt()-continued across crashes).
# - ``session_step``  — step k was submitted, with its request id and
#   warm-start PROVENANCE (``warm_from``: the step index the warm
#   iterate came from, or -1 for a cold step) — never the iterate.
# - ``session_advance`` — step k reached its typed outcome; the stream's
#   committed boundary moves to k.
# - ``session_close`` / ``session_shed`` — the stream's one terminal
#   record (a shed open is terminal too).
SESSION_RECORD_KINDS = ("session_open", "session_step",
                        "session_advance", "session_close",
                        "session_shed")


@dataclasses.dataclass
class SessionReplay:
    """One session's journal truth (:func:`replay_sessions`)."""

    session_id: str = ""
    kind: str = "poisson"
    trace_id: str = ""
    t_open: float = 0.0
    params: dict = dataclasses.field(default_factory=dict)
    steps_submitted: int = 0          # highest step with a session_step
    last_advanced: int = -1           # highest step with session_advance
    advanced_geometry: Optional[str] = None  # geometry JSON at that step
    closed: bool = False
    shed: bool = False
    generations: int = 1              # 1 + prior session recoveries

    @property
    def open(self) -> bool:
        return not (self.closed or self.shed)


def replay_sessions(path: str) -> Dict[str, SessionReplay]:
    """Fold the journal's ``session_*`` records into per-session truth:
    which streams are still open, the exact step boundary each one
    committed to (``last_advanced``), and the schedule parameters a
    recovery needs to continue the stream. Torn records are skipped
    like :func:`replay_journal` (the per-request ledger half already
    counts them)."""
    sessions: Dict[str, SessionReplay] = {}
    scratch = JournalReplay()
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return sessions
    for lineno, line in enumerate(lines, start=1):
        rec = _parse_line(line, lineno, scratch)
        if rec is None or rec.get("kind") not in SESSION_RECORD_KINDS:
            continue
        sid = str(rec.get("session_id", ""))
        kind = rec["kind"]
        if kind == "session_open":
            prior = sessions.get(sid)
            srep = SessionReplay(
                session_id=sid,
                kind=str(rec.get("session_kind", "poisson")),
                trace_id=str(rec.get("trace_id", "")),
                t_open=float(rec.get("t", 0.0)),
                params=dict(rec.get("params") or {}),
            )
            if prior is not None:
                # A recovery re-opened the stream: keep the committed
                # boundary, bump the generation (flight span offsets).
                srep.steps_submitted = prior.steps_submitted
                srep.last_advanced = prior.last_advanced
                srep.advanced_geometry = prior.advanced_geometry
                srep.generations = prior.generations + 1
                srep.trace_id = srep.trace_id or prior.trace_id
            sessions[sid] = srep
            continue
        srep = sessions.get(sid)
        if srep is None:
            continue
        if kind == "session_step":
            srep.steps_submitted = max(srep.steps_submitted,
                                       int(rec.get("step", 0)))
        elif kind == "session_advance":
            step = int(rec.get("step", 0))
            if step > srep.last_advanced:
                srep.last_advanced = step
                srep.advanced_geometry = rec.get("geometry")
        elif kind == "session_close":
            srep.closed = True
        elif kind == "session_shed":
            srep.shed = True
    return sessions


@dataclasses.dataclass
class PendingRequest:
    """One request the journal shows as admitted but not terminated —
    what a recovery re-enqueues."""

    request: SolveRequest
    trace_id: str
    t_submit: float
    attempts: int = 0
    in_flight: bool = False      # mid-dispatch / lane-resident at crash
    taint: Set[str] = dataclasses.field(default_factory=set)
    # Geometry-fingerprint taint (requeue-recorded): never-co-batch
    # families survive the crash like the request-id pairs do.
    taint_fp: Set[str] = dataclasses.field(default_factory=set)
    generation: int = 1          # 1 + prior recover records for this id
    lost_hook: bool = False      # an on_chunk hook did not survive
    # Placement at the crash (serve.placement): the fault-domain slot
    # the last dispatch/splice put this request on, and the placement
    # epoch it was recorded under — what lets a recovery on a DIFFERENT
    # topology see that the device is gone and remap audibly.
    device_id: Optional[int] = None
    epoch: int = 0


@dataclasses.dataclass
class JournalReplay:
    """What :func:`replay_journal` reconstructed."""

    records: int = 0
    torn_records: int = 0
    torn_detail: List[str] = dataclasses.field(default_factory=list)
    outcomes: Dict[str, str] = dataclasses.field(default_factory=dict)
    duplicate_outcomes: List[str] = dataclasses.field(default_factory=list)
    pending: List[PendingRequest] = dataclasses.field(default_factory=list)
    submitted: int = 0
    # The last topology record in the log (the crashed incarnation's
    # device view) — recovery compares it against its own registry.
    topology: Optional[dict] = None

    @property
    def lost(self) -> int:
        """Requests neither terminated nor recoverable — must be 0 for a
        readable journal (pending covers the difference by construction;
        anything else means torn submit records, which were never
        acknowledged and are not ledger debt)."""
        return self.submitted - len(self.outcomes) - len(self.pending)


def _parse_line(line: str, lineno: int, replay: JournalReplay
                ) -> Optional[dict]:
    line = line.strip()
    if not line:
        return None
    try:
        rec = json.loads(line)
    except ValueError:
        replay.torn_records += 1
        replay.torn_detail.append(f"line {lineno}: unparseable (torn tail)")
        return None
    if not isinstance(rec, dict):
        replay.torn_records += 1
        replay.torn_detail.append(f"line {lineno}: not an object")
        return None
    stored = rec.pop("crc32", None)
    if stored is None or _seal(rec) != stored:
        replay.torn_records += 1
        replay.torn_detail.append(
            f"line {lineno}: CRC mismatch "
            f"(stored {stored}, kind {rec.get('kind')!r})")
        return None
    return rec


def replay_journal(path: str) -> JournalReplay:
    """Fold the journal back into ledger truth. Torn/corrupt records are
    skipped audibly (``serve.journal.torn_records`` + the replay's
    ``torn_detail``); everything readable is folded in order."""
    replay = JournalReplay()
    submits: Dict[str, dict] = {}
    attempts: Dict[str, int] = {}
    open_dispatch: Dict[str, Set[str]] = {}   # request_id -> co-ids
    open_lanes: Dict[object, Set[str]] = {}   # worker -> resident ids
    taints: Dict[str, Set[str]] = {}          # requeue-recorded taint
    fp_taints: Dict[str, Set[str]] = {}       # geometry-fingerprint taint
    generations: Dict[str, int] = {}
    last_place: Dict[str, tuple] = {}         # rid -> (device, epoch)

    def _close(rid_: str) -> None:
        open_dispatch.pop(rid_, None)
        for resident in open_lanes.values():
            resident.discard(rid_)
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError as e:
        replay.torn_detail.append(f"journal unreadable: {e}")
        obs.inc("serve.journal.torn_records")
        return replay
    for lineno, line in enumerate(lines, start=1):
        rec = _parse_line(line, lineno, replay)
        if rec is None:
            continue
        replay.records += 1
        kind = rec.get("kind")
        rid = str(rec.get("request_id", ""))
        if kind == "submit":
            submits[rid] = rec
        elif kind == "topology":
            replay.topology = {k: rec.get(k) for k in
                               ("devices", "alive", "lost", "epoch",
                                "kinds")}
        elif kind in ("dispatch", "splice"):
            ids = ([str(i) for i in rec.get("request_ids", [])]
                   if kind == "dispatch" else [rid])
            place = (rec.get("device"), int(rec.get("epoch", 0) or 0))
            for i in ids:
                # Attempts = dispatches this request has burned (the
                # one open at the crash included: it died with the
                # process, which is exactly what an attempt costs).
                attempts[i] = attempts.get(i, 0) + 1
                open_dispatch[i] = set(ids) - {i}
                # Last-known placement: where this work last ran — the
                # recovery's remap input on a changed topology.
                last_place[i] = place
            if kind == "splice":
                open_lanes.setdefault(rec.get("worker"), set()).add(rid)
        elif kind in ("dispatch_end", "retire", "requeue"):
            ids = ([str(i) for i in rec.get("request_ids", [rid])]
                   if "request_ids" in rec else [rid])
            for i in ids:
                _close(i)
            if kind == "requeue":
                # Mutual-taint pairs established before the crash must
                # survive the replay (never-co-batch-again is forever) —
                # the geometry-fingerprint pairs included.
                taints[rid] = (taints.get(rid, set())
                               | {str(t) for t in rec.get("taint", ())})
                fp_taints[rid] = (fp_taints.get(rid, set())
                                  | {str(t) for t in
                                     rec.get("taint_fp", ())})
        elif kind == "recover":
            generations[rid] = generations.get(rid, 0) + 1
            _close(rid)
        elif kind == "outcome":
            if rid in replay.outcomes:
                replay.duplicate_outcomes.append(rid)
            replay.outcomes[rid] = str(rec.get("outcome", ""))
            _close(rid)
    # Lane co-residency at the crash is mutual taint too: everything
    # still resident on one worker shared the program that died.
    for resident in open_lanes.values():
        for rid in resident:
            open_dispatch[rid] = (open_dispatch.get(rid, set())
                                  | resident) - {rid}
    replay.submitted = len(submits)
    if replay.torn_records:
        obs.inc("serve.journal.torn_records", replay.torn_records)
        obs.event("serve.journal.torn_tail", path=path,
                  skipped=replay.torn_records,
                  detail="; ".join(replay.torn_detail[:5]))
    for rid, rec in submits.items():
        if rid in replay.outcomes:
            continue
        try:
            problem = Problem(**rec["problem"])
            req_fields = dict(rec.get("request") or {})
            geo_json = req_fields.pop("geometry", None)
            if geo_json:
                from poisson_tpu_torch.geometry.dsl import parse_geometry

                # Raw-SDF specs raise here (a callable does not survive
                # JSON) and fall into the unreconstructable branch —
                # audible, never the wrong domain.
                req_fields["geometry"] = parse_geometry(geo_json)
            krylov_d = req_fields.pop("krylov", None)
            if krylov_d:
                from poisson_tpu_torch.krylov import KrylovPolicy

                # Unknown keys (a future policy field) raise TypeError
                # into the unreconstructable branch — audible.
                req_fields["krylov"] = KrylovPolicy(**krylov_d)
            request = SolveRequest(request_id=rid, problem=problem,
                                   **req_fields)
        except (KeyError, TypeError, ValueError) as e:
            replay.torn_records += 1
            replay.torn_detail.append(
                f"submit {rid!r} unreconstructable: {e}")
            obs.inc("serve.journal.torn_records")
            continue
        device, epoch = last_place.get(rid, (None, 0))
        replay.pending.append(PendingRequest(
            request=request,
            trace_id=str(rec.get("trace_id", "")),
            t_submit=float(rec.get("t", 0.0)),
            attempts=attempts.get(rid, 0),
            in_flight=rid in open_dispatch,
            taint=(set(open_dispatch.get(rid, ()))
                   | taints.get(rid, set())),
            taint_fp=fp_taints.get(rid, set()),
            generation=generations.get(rid, 0) + 1,
            lost_hook=bool(rec.get("has_hook")),
            device_id=(int(device) if device is not None else None),
            epoch=epoch,
        ))
    obs.inc("serve.journal.replays")
    obs.event("serve.journal.replay", path=path,
              records=replay.records, outcomes=len(replay.outcomes),
              pending=len(replay.pending),
              torn=replay.torn_records)
    return replay
