"""Request flight recorder: per-request causal tracing, latency
decomposition, and SLO accounting for the solve service (counterpart of
``poisson_tpu/obs/flight.py``; the JSONL records are the JAX package's, so
either package's ``trace`` reader loads the other's).

The serve stack's telemetry was aggregate-only: ``serve.*`` counters say
*how many* requests were shed and the span rails say how fast the fleet
ran, but Orca-style iteration-level scheduling (PAPERS.md) makes
per-request cost invisible to batch-level timing by design — a request's
latency is smeared across shared dispatches, lane residencies, backoffs
and retries that no process-level span attributes back to it. This
module is the request-scoped layer:

- **causal span trees** — every admitted request gets a ``trace_id`` and
  a tree of lifecycle spans threaded through its whole life::

      admit ─┬─ queue_wait
             ├─ lane_resident[bucket,lane]   (chunk_step points,
             │                                shared-dispatch ids as
             │                                causal parents)
             ├─ backoff_wait                 (retry points)
             └─ outcome                      (exactly one, typed)

  recorded lock-free through the telemetry JSONL rails (``obs.event`` — the
  events gain ``trace_id``/``request_id`` attribution in the
  schema-versioned ``attrs`` block, old readers unaffected). The tree is
  reconstructable from the JSONL alone: :func:`trace_records`,
  :func:`validate_trace`, :func:`render_timeline`.

- **latency decomposition** — at the outcome, the recorder reduces the
  tree to where the wall time went::

      wall_s = queue_s + compute_s + lane_wait_s + backoff_s + overhead_s

  ``compute_s`` is the request's share of every shared dispatch it rode:
  each chunk step's measured wall is divided by the iterations it
  advanced across all co-resident members (the measured per-iteration
  cost — the same quantity ``obs.costs`` models analytically) and
  multiplied by this member's own iteration count
  (:func:`poisson_tpu_torch.obs.costs.apportion_compute`). ``lane_wait_s`` is
  residency time paid for *other* lanes' work (the fused-width cost);
  ``overhead_s`` is the residual (host machinery between segments), so
  the components sum to the measured wall exactly.

- **SLO accounting** (:class:`SLOTracker`) — declared objectives
  (``serve.types.SLOPolicy``) scored per outcome into
  ``serve.slo.{good,bad}`` counters, a real latency **histogram**
  (``serve.slo.latency_seconds`` — Prometheus histogram exposition, not
  just percentile summaries), the ``serve.slo.budget_remaining`` gauge,
  and a multi-window burn rate (``serve.slo.burn_rate.{W}s``) that the
  service's degradation ladder consults (``SLOPolicy.degrade_on_burn``)
  so downshifts can be SLO-driven rather than only queue-depth-driven.

Everything here is host-side bookkeeping on the service clock
(clock-injectable — chaos campaigns stay deterministic under
``VirtualClock``): no solver change, and with
telemetry unconfigured the JSONL emission degrades to the usual
``obs.event`` no-op while decompositions still ride the Outcome.
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from poisson_tpu_torch import obs
from poisson_tpu_torch.obs import metrics

# Lifecycle span names (the taxonomy README "Flight recorder & SLOs"
# tabulates). The admit root is span_id 0; every lifecycle span is a
# direct child of it, with shared dispatches linked by dispatch id.
SPAN_QUEUE = "queue_wait"
SPAN_RESIDENT = "lane_resident"
SPAN_BACKOFF = "backoff_wait"
POINT_RETRY = "retry"
POINT_CHUNK = "chunk_step"
POINT_DEADLINE = "deadline"
POINT_RECOVERED = "recovered"      # re-enqueued off a dead worker/journal
POINT_QUARANTINE = "quarantine"    # the worker serving this request fell
POINT_PLACEMENT = "placement_remapped"  # recovered onto a different device
#                                    (topology changed under the journal)
POINT_SESSION_STEP = "session_step"     # one step of a durable session
#                                    advanced (serve.session)
POINT_WARM_FALLBACK = "warm_fallback"   # an offered warm start failed the
#                                    validity gate — the step ran cold
POINT_FORECAST_SHED = "forecast_shed"   # refused at admission: the p90 ETA
#                                    said the deadline cannot be met
POINT_REFORECAST = "reforecast"         # lane-boundary re-forecast verdict:
#                                    measured slope says hopeless — pre-empt

_ROOT_SPAN_ID = 0

# Trace-id uniqueness has two layers. The recorder sequence keeps ids
# unique when several services (chaos scenarios, A/B bench arms) share
# one JSONL file within a process; the process token keeps them unique
# ACROSS processes — the events JSONL is opened in append mode, so a
# re-run into the same --trace-dir would otherwise merge two distinct
# requests under one id and fail flight validation with doubled admit
# roots. pid alone recycles; pid + wall-clock millis does not (within
# any horizon a trace dir plausibly spans). Ids are opaque — nothing
# fingerprints their values, so chaos determinism is untouched.
_PROCESS_TOKEN = f"{os.getpid():x}{int(time.time() * 1000) & 0xFFFFFF:x}"
_RECORDER_SEQ = itertools.count()


class _Trace:
    """One request's in-flight causal record (host-side, popped at the
    outcome)."""

    __slots__ = ("trace_id", "request_id", "t_admit",
                 "span_seq", "open_spans", "queue_s", "backoff_s",
                 "compute_s", "resident_s", "iterations", "chunk_steps",
                 "dispatches")

    def __init__(self, trace_id: str, request_id, t_admit: float):
        self.trace_id = trace_id
        self.request_id = request_id
        self.t_admit = t_admit
        self.span_seq = _ROOT_SPAN_ID     # 0 is the admit root itself
        self.open_spans: Dict[str, tuple] = {}  # name -> (id, t0, attrs)
        self.queue_s = 0.0
        self.backoff_s = 0.0
        self.compute_s = 0.0
        self.resident_s = 0.0
        self.iterations = 0
        self.chunk_steps = 0
        self.dispatches: set = set()


class FlightRecorder:
    """Builds one causal span tree per admitted request on an injectable
    clock, emits it through the JSONL rails, and reduces it to the
    latency decomposition at the outcome.

    The API mirrors the request lifecycle: :meth:`admit` opens the root,
    :meth:`begin`/:meth:`end` bracket lifecycle spans (``queue_wait``,
    ``lane_resident``, ``backoff_wait``), :meth:`add_step` accounts one
    shared-dispatch chunk step's residency + apportioned compute,
    :meth:`point` marks instants (retries, retirements), and
    :meth:`outcome` closes the tree — any still-open span is folded into
    its accumulator so a shed or evicted request's tree is as complete
    as a converged one. All methods are defensive no-ops for unknown
    request ids: telemetry must never take the service down with it.
    """

    def __init__(self, clock: Callable[[], float] = time.monotonic):
        self._clock = clock
        self._rec_seq = next(_RECORDER_SEQ)
        self._trace_seq = itertools.count(1)
        self._dispatch_seq = itertools.count(1)
        self._traces: Dict[object, _Trace] = {}

    # -- lifecycle -----------------------------------------------------

    def admit(self, request_id) -> str:
        """Open the root span; returns the request's trace id."""
        trace_id = (f"f{_PROCESS_TOKEN}-{self._rec_seq:x}"
                    f"-{next(self._trace_seq):x}")
        tr = _Trace(trace_id, request_id, self._clock())
        self._traces[request_id] = tr
        obs.event("flight.admit", trace_id=trace_id,
                  request_id=str(request_id), t=tr.t_admit)
        return trace_id

    def adopt(self, request_id, trace_id: str, t_admit: float,
              span_base: int = 1000) -> None:
        """Continue an EXISTING trace in a new recorder — the journal
        recovery path (``serve.journal``): the crashed process emitted
        the admit root and any completed spans; the recovering process
        adopts the same trace id so the request's causal tree still has
        exactly one root and one outcome leaf across the crash boundary.
        ``span_base`` offsets this incarnation's span ids past the dead
        process's sequence (1000 per recovery generation — a trace would
        need a thousand lifecycle spans per life to collide, two orders
        of magnitude past the deepest retry ladder the policy can
        express); ``t_admit`` is the original admission time on the
        service clock, so the final decomposition's wall covers the
        crash gap (it lands in ``overhead_s`` — honest: nobody worked on
        the request while the process was dead)."""
        tr = _Trace(trace_id, request_id, t_admit)
        tr.span_seq = span_base
        self._traces[request_id] = tr

    def next_dispatch_id(self) -> str:
        """A shared-dispatch id: the causal parent linking every member
        span/point of one fused dispatch or lane chunk step."""
        return (f"d{_PROCESS_TOKEN}-{self._rec_seq:x}"
                f"-{next(self._dispatch_seq):x}")

    def begin(self, request_id, span: str, **attrs) -> None:
        tr = self._traces.get(request_id)
        if tr is None or span in tr.open_spans:
            return
        tr.span_seq += 1
        tr.open_spans[span] = (tr.span_seq, self._clock(), dict(attrs))

    def end(self, request_id, span: str, **attrs) -> float:
        """Close ``span``; returns its seconds (0.0 when it was not
        open). The duration lands in the matching accumulator."""
        tr = self._traces.get(request_id)
        if tr is None or span not in tr.open_spans:
            return 0.0
        span_id, t0, begin_attrs = tr.open_spans.pop(span)
        seconds = max(0.0, self._clock() - t0)
        self._account(tr, span, seconds)
        fields = dict(begin_attrs)
        fields.update(attrs)
        obs.event("flight.span", trace_id=tr.trace_id,
                  request_id=str(request_id), span=span, span_id=span_id,
                  parent_id=_ROOT_SPAN_ID, t0=t0,
                  seconds=round(seconds, 6), **fields)
        return seconds

    def point(self, request_id, name: str, **attrs) -> None:
        tr = self._traces.get(request_id)
        if tr is None:
            return
        obs.event("flight.point", trace_id=tr.trace_id,
                  request_id=str(request_id), point=name,
                  t=self._clock(), **attrs)

    def annotate(self, request_id, span: str, **attrs) -> None:
        """Merge attrs into an OPEN span's begin-attrs so they ride the
        ``flight.span`` event when it eventually closes — progress
        context discovered mid-span (iterations/chunk, ETA fractions)
        without emitting an extra record per boundary. Later values
        win; a no-op for unknown requests or closed spans."""
        tr = self._traces.get(request_id)
        if tr is None or span not in tr.open_spans:
            return
        span_id, t0, begin_attrs = tr.open_spans[span]
        begin_attrs.update(attrs)

    def add_step(self, request_id, seconds: float, iterations: int,
                 compute_share: float, dispatch_id: str,
                 k: Optional[int] = None) -> None:
        """Account one shared dispatch (or lane chunk step) the request
        rode: ``seconds`` of residency, with ``compute_share`` the
        member's apportioned slice of the step's measured wall (the
        caller computes it with ``obs.costs.apportion_compute`` — the
        measured per-iteration cost times this member's own iteration
        count)."""
        tr = self._traces.get(request_id)
        if tr is None:
            return
        share = max(0.0, min(float(compute_share), float(seconds)))
        tr.resident_s += seconds
        tr.compute_s += share
        tr.iterations += max(0, int(iterations))
        tr.chunk_steps += 1
        tr.dispatches.add(dispatch_id)
        fields = {"dispatch_id": dispatch_id, "dk": int(iterations),
                  "step_seconds": round(seconds, 6),
                  "compute_share": round(share, 6)}
        if k is not None:
            fields["k"] = int(k)
        self.point(request_id, POINT_CHUNK, **fields)

    def outcome(self, request_id, kind: str, type_: str,
                attempts: int = 1) -> dict:
        """Close the tree with its one typed outcome leaf and return
        ``{"trace_id": …, "decomposition": …}``. Still-open spans are
        folded into their accumulators first (a shed request's
        ``queue_wait`` ends here), so components always sum to wall."""
        tr = self._traces.pop(request_id, None)
        if tr is None:
            return {"trace_id": "", "decomposition": None}
        # Re-register briefly so end() can close the stragglers.
        self._traces[request_id] = tr
        for span in list(tr.open_spans):
            self.end(request_id, span, closed_by="outcome")
        self._traces.pop(request_id, None)
        wall = max(0.0, self._clock() - tr.t_admit)
        lane_wait = max(0.0, tr.resident_s - tr.compute_s)
        accounted = tr.queue_s + tr.backoff_s + tr.compute_s + lane_wait
        decomposition = {
            "wall_s": round(wall, 6),
            "queue_s": round(tr.queue_s, 6),
            "compute_s": round(tr.compute_s, 6),
            "lane_wait_s": round(lane_wait, 6),
            "backoff_s": round(tr.backoff_s, 6),
            # The residual: host machinery between segments. Can only be
            # negative by float rounding — kept raw so the sum-to-wall
            # property test is honest, not cosmetically clamped.
            "overhead_s": round(wall - accounted, 6),
            "iterations": tr.iterations,
            "chunk_steps": tr.chunk_steps,
            "dispatches": len(tr.dispatches),
        }
        obs.event("flight.outcome", trace_id=tr.trace_id,
                  request_id=str(request_id), kind=kind, type=type_,
                  attempts=attempts, t=self._clock(), **decomposition)
        return {"trace_id": tr.trace_id, "decomposition": decomposition}

    # -- internals -----------------------------------------------------

    @staticmethod
    def _account(tr: _Trace, span: str, seconds: float) -> None:
        if span == SPAN_QUEUE:
            tr.queue_s += seconds
        elif span == SPAN_BACKOFF:
            tr.backoff_s += seconds
        # SPAN_RESIDENT durations are informational for the timeline;
        # residency is accounted per chunk step (add_step) so host gaps
        # between steps land in overhead, not in lane_wait.


# -- SLO accounting ------------------------------------------------------

# Latency histogram bucket upper bounds (seconds). The ladder covers a
# 40×40 CPU fire drill (~5 ms) through a deadline-heavy campaign
# (minutes); +Inf is implicit.
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                   1.0, 2.5, 5.0, 10.0, 30.0, 60.0)


class LatencyHistogram:
    """A fixed-bucket latency histogram — the real distribution the SLO
    burn rate is computed from (a percentile summary cannot be
    re-aggregated or re-thresholded after the fact; a histogram can)."""

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = max(0.0, float(value))
        self._sum += v
        self._count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self._counts[i] += 1
                return
        self._counts[-1] += 1

    def snapshot(self) -> dict:
        """Prometheus-histogram-shaped dict: cumulative ``le`` counts
        plus ``sum``/``count`` (what ``obs.export`` renders as ``# TYPE
        … histogram``)."""
        cumulative: Dict[str, int] = {}
        running = 0
        for le, n in zip(self.buckets, self._counts):
            running += n
            cumulative[f"{le:g}"] = running
        cumulative["+Inf"] = self._count
        return {"le": cumulative, "sum": round(self._sum, 6),
                "count": self._count}


class SLOTracker:
    """Scores every outcome against the declared objectives
    (``serve.types.SLOPolicy``) and publishes the SLO surface:
    ``serve.slo.{good,bad}`` counters, the latency histogram gauge, the
    remaining error budget, and one burn-rate gauge per window.

    Burn rate over a window = (bad fraction in window) / error budget,
    where error budget = 1 − availability_target: burn 1.0 spends the
    budget exactly at the target rate, 14 is the classic page-now
    threshold. :meth:`degrade_level` applies the multi-window rule — a
    ladder rung engages only when EVERY window burns above its
    threshold (the short window says "burning now", the long window
    says "not just a blip") — which is what makes an SLO-driven
    downshift deliberate rather than twitchy.

    ``prefix`` names the published metric family — the default
    ``"serve.slo"`` is the fleet-wide surface every prior release
    published; per-tenant trackers (``ServicePolicy.tenancy``) pass
    ``serve.tenant.slo.<tenant>`` so one tenant's burn is attributable
    without double-counting the global counters.
    """

    def __init__(self, policy, clock: Callable[[], float] = time.monotonic,
                 prefix: str = "serve.slo"):
        self.policy = policy
        self._clock = clock
        self._prefix = prefix
        self._hist = LatencyHistogram()
        # One (timestamps, running-bad) pair per window: append on
        # record, evict expired samples from the head — amortized O(1)
        # per outcome, where a shared list rescanned per window would be
        # O(window population) inside the single-threaded dispatch loop
        # (latency the decomposition would then attribute to overhead).
        self._windows = {
            float(w): {"dq": deque(), "total": 0, "bad": 0}
            for w in policy.burn_windows
        }
        self._good = 0
        self._bad = 0

    def record(self, latency_seconds: float, good: bool) -> None:
        t = self._clock()
        self._hist.observe(latency_seconds)
        bad = 0 if good else 1
        if good:
            self._good += 1
            metrics.inc(f"{self._prefix}.good")
        else:
            self._bad += 1
            metrics.inc(f"{self._prefix}.bad")
        for w, st in self._windows.items():
            st["dq"].append((t, bad))
            st["total"] += 1
            st["bad"] += bad
        self._evict(t)
        self.publish()

    def _evict(self, now: float) -> None:
        for w, st in self._windows.items():
            dq = st["dq"]
            horizon = now - w
            while dq and dq[0][0] < horizon:
                _, b = dq.popleft()
                st["total"] -= 1
                st["bad"] -= b

    def burn_rate(self, window_seconds: float) -> float:
        """Burn over the trailing window (0.0 with no samples). Windows
        not declared in the policy fall back to a scan of the widest
        tracked one (clamped to its horizon)."""
        budget = max(1e-9, 1.0 - self.policy.availability_target)
        now = self._clock()
        self._evict(now)
        st = self._windows.get(float(window_seconds))
        if st is not None:
            if not st["total"]:
                return 0.0
            return (st["bad"] / st["total"]) / budget
        if not self._windows:
            return 0.0
        widest = self._windows[max(self._windows)]
        t0 = now - window_seconds
        total = bad = 0
        for t, b in widest["dq"]:
            if t >= t0:
                total += 1
                bad += b
        if not total:
            return 0.0
        return (bad / total) / budget

    def budget_remaining(self) -> float:
        """Fraction of the cumulative error budget left (may go
        negative — an honest overdraft beats a clamped 0)."""
        total = self._good + self._bad
        if not total:
            return 1.0
        budget = max(1e-9, 1.0 - self.policy.availability_target)
        return 1.0 - (self._bad / total) / budget

    def degrade_level(self) -> int:
        """The degradation rung the burn rate asks for (0 = none);
        always 0 unless ``SLOPolicy.degrade_on_burn``."""
        if not self.policy.degrade_on_burn or not self.policy.burn_windows:
            # No windows declared → no burn evidence; telemetry must
            # never take the dispatch loop down over a policy corner.
            return 0
        burn = min(self.burn_rate(w) for w in self.policy.burn_windows)
        level = 0
        for i, thr in enumerate(self.policy.burn_degrade_thresholds):
            if burn >= thr:
                level = i + 1
        return level

    def publish(self) -> None:
        metrics.gauge(f"{self._prefix}.latency_seconds",
                      self._hist.snapshot())
        metrics.gauge(f"{self._prefix}.budget_remaining",
                      round(self.budget_remaining(), 6))
        metrics.gauge(f"{self._prefix}.objective_seconds",
                      self.policy.latency_objective_seconds)
        for w in self.policy.burn_windows:
            metrics.gauge(f"{self._prefix}.burn_rate.{w:g}s",
                          round(self.burn_rate(w), 4))


# -- JSONL-side readers (forensics / the `trace` CLI subcommand) ---------


def _field(rec: dict, key: str, default=None):
    """A flight field off a JSONL record, tolerant of both schemas.
    The v2 ``attrs`` block wins over the flat layout: a flight field
    that shadows a reserved envelope key (``kind`` — the outcome's
    result/error/shed discriminator vs the envelope's "event") is only
    unambiguous there; v1 flat lines fall back to the top level."""
    attrs = rec.get("attrs")
    if isinstance(attrs, dict) and key in attrs:
        return attrs[key]
    if key in rec:
        return rec[key]
    return default


def is_flight_record(rec: dict) -> bool:
    return (rec.get("kind") == "event"
            and str(rec.get("name", "")).startswith("flight."))


def trace_records(events: List[dict]) -> Dict[str, List[dict]]:
    """Group a JSONL event list by ``trace_id`` (flight records only),
    each group sorted by service-clock time."""
    groups: Dict[str, List[dict]] = {}
    for rec in events:
        if not is_flight_record(rec):
            continue
        tid = _field(rec, "trace_id")
        if tid:
            groups.setdefault(str(tid), []).append(rec)
    for recs in groups.values():
        recs.sort(key=lambda r: (
            _field(r, "t", _field(r, "t0", 0.0)) or 0.0,
            r.get("at_unix", 0.0),
        ))
    return groups


def find_trace(events: List[dict], request_id=None,
               trace_id=None) -> Tuple[Optional[str], List[dict]]:
    """The one trace matching ``trace_id``, or the LAST trace whose
    ``request_id`` matches (ids recycle across scenarios; the newest is
    what a forensics pass wants). Returns ``(trace_id, records)`` —
    ``(None, [])`` when nothing matches."""
    groups = trace_records(events)
    if trace_id is not None:
        tid = str(trace_id)
        return (tid, groups[tid]) if tid in groups else (None, [])
    want = str(request_id)
    best = None
    for tid, recs in groups.items():
        if any(str(_field(r, "request_id")) == want for r in recs):
            admit = next((r for r in recs
                          if r.get("name") == "flight.admit"), None)
            at = admit.get("at_unix", 0.0) if admit else 0.0
            if best is None or at >= best[0]:
                best = (at, tid, recs)
    if best is None:
        return None, []
    return best[1], best[2]


def validate_trace(records: List[dict]) -> List[str]:
    """Structural completeness of one trace: exactly one ``admit`` root,
    exactly one typed ``outcome`` leaf, no orphan spans — every span
    carries a unique non-null id, a parent resolvable among the trace's
    ids, and sits inside the admit→outcome window with a non-negative
    duration — and a decomposition whose components sum to the wall
    within tolerance. Returns the list of problems ([] = complete)."""
    problems: List[str] = []
    admits = [r for r in records if r.get("name") == "flight.admit"]
    outcomes = [r for r in records if r.get("name") == "flight.outcome"]
    spans = [r for r in records if r.get("name") == "flight.span"]
    if len(admits) != 1:
        problems.append(f"expected exactly 1 admit root, got {len(admits)}")
    if len(outcomes) != 1:
        problems.append(
            f"expected exactly 1 outcome leaf, got {len(outcomes)}")
    elif not _field(outcomes[0], "kind"):
        problems.append("outcome leaf is untyped (no kind)")
    seen_ids = [_field(s, "span_id") for s in spans]
    if any(sid is None for sid in seen_ids):
        problems.append("span without a span_id")
    if len(set(seen_ids)) != len(seen_ids):
        problems.append(f"duplicate span ids: {sorted(map(str, seen_ids))}")
    span_ids = {_ROOT_SPAN_ID} | set(seen_ids)
    for s in spans:
        parent = _field(s, "parent_id")
        if parent is None or parent not in span_ids:
            problems.append(
                f"orphan span {_field(s, 'span')!r} "
                f"(parent_id {parent} unknown)")
        if _field(s, "span_id") == parent:
            problems.append(
                f"span {_field(s, 'span')!r} is its own parent")
        seconds = _field(s, "seconds")
        if seconds is None or seconds < 0:
            problems.append(
                f"span {_field(s, 'span')!r} has bad duration {seconds}")
    # Temporal containment: every span starts inside the request's
    # admit→outcome window (the tree claims causality, so a span
    # stamped before the root or after the leaf is a recorder bug).
    if admits and outcomes:
        t_admit = _field(admits[0], "t")
        t_out = _field(outcomes[0], "t")
        if t_admit is not None and t_out is not None:
            for s in spans:
                t0 = _field(s, "t0")
                if t0 is None or t0 < t_admit - 1e-6 or t0 > t_out + 1e-6:
                    problems.append(
                        f"span {_field(s, 'span')!r} starts at {t0}, "
                        f"outside [{t_admit}, {t_out}]")
    ids = {str(_field(r, "request_id")) for r in records}
    if len(ids) > 1:
        problems.append(f"trace spans multiple request ids: {sorted(ids)}")
    if outcomes:
        o = outcomes[0]
        wall = _field(o, "wall_s")
        parts = [_field(o, k) for k in ("queue_s", "compute_s",
                                        "lane_wait_s", "backoff_s",
                                        "overhead_s")]
        if wall is None or any(p is None for p in parts):
            problems.append("outcome decomposition incomplete")
        else:
            if abs(sum(parts) - wall) > max(1e-4, 0.001 * wall):
                problems.append(
                    f"decomposition {sum(parts):.6f} != wall {wall:.6f}")
            for key, val in zip(("queue_s", "compute_s", "lane_wait_s",
                                 "backoff_s"), parts):
                if val < -1e-9:
                    problems.append(f"negative {key}: {val}")
            if parts[-1] < -1e-4:
                problems.append(f"negative overhead_s: {parts[-1]}")
    return problems


def validate_events(events: List[dict]) -> dict:
    """Every flight trace in an event list, validated: the acceptance
    surface the chaos CLI reports (``{"traces": N, "complete": bool,
    "problems": {trace_id: [...]}}``)."""
    groups = trace_records(events)
    problems = {}
    for tid, recs in groups.items():
        issues = validate_trace(recs)
        if issues:
            problems[tid] = issues
    return {"traces": len(groups), "complete": not problems,
            "problems": problems}


def render_timeline(records: List[dict]) -> str:
    """One request's timeline as human-readable text (the ``trace`` CLI
    subcommand and the forensics report's "Flight recorder" section).
    Times are service-clock seconds relative to the admit root."""
    if not records:
        return "(no flight records)"
    admit = next((r for r in records if r.get("name") == "flight.admit"),
                 None)
    t_admit = _field(admit, "t", 0.0) if admit else 0.0
    tid = _field(records[0], "trace_id", "?")
    rid = _field(records[0], "request_id", "?")
    lines = [f"trace {tid} (request {rid})"]

    def rel(t):
        return f"+{max(0.0, (t or 0.0) - t_admit):.4f}s"

    for rec in records:
        name = rec.get("name")
        if name == "flight.admit":
            lines.append(f"  {rel(_field(rec, 't'))} admit")
        elif name == "flight.span":
            extra = []
            for key in ("bucket", "lane", "dispatch", "mode", "batch",
                        "worker", "error", "iterations", "flag",
                        "dk", "k", "progress", "eta"):
                val = _field(rec, key)
                if val is not None:
                    extra.append(f"{key}={val}")
            lines.append(
                f"  {rel(_field(rec, 't0'))} {_field(rec, 'span')}"
                f" [{_field(rec, 'seconds', 0.0):.4f}s]"
                + (f" ({', '.join(extra)})" if extra else ""))
        elif name == "flight.point":
            extra = []
            for key in ("dispatch_id", "k", "dk", "attempt", "error",
                        "lane", "compute_share", "worker", "reason",
                        "generation", "eta", "deadline", "remaining"):
                val = _field(rec, key)
                if val is not None:
                    extra.append(f"{key}={val}")
            lines.append(
                f"  {rel(_field(rec, 't'))} · {_field(rec, 'point')}"
                + (f" ({', '.join(extra)})" if extra else ""))
        elif name == "flight.outcome":
            lines.append(
                f"  {rel(_field(rec, 't'))} outcome "
                f"{_field(rec, 'kind')}:{_field(rec, 'type')} "
                f"(attempts {_field(rec, 'attempts')})")
            lines.append(
                "    decomposition: wall "
                f"{_field(rec, 'wall_s')}s = queue "
                f"{_field(rec, 'queue_s')} + compute "
                f"{_field(rec, 'compute_s')} + lane_wait "
                f"{_field(rec, 'lane_wait_s')} + backoff "
                f"{_field(rec, 'backoff_s')} + overhead "
                f"{_field(rec, 'overhead_s')}"
                f"  [{_field(rec, 'iterations')} iters, "
                f"{_field(rec, 'chunk_steps')} chunk steps, "
                f"{_field(rec, 'dispatches')} dispatches]")
    return "\n".join(lines)
