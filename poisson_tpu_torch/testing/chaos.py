"""Chaos campaign: named, seeded, deterministic fault scenarios
(counterpart of ``poisson_tpu/testing/chaos.py``: the same 35 scenarios,
names and groups, on ``run_scenario``'s ``device``).

``python -m poisson_tpu_torch chaos --all --seed 0`` drives every scenario
on the card (``--device cpu`` on the CPU) and exits 0 iff each one upheld
its checks — first among them the
service's no-lost-request invariant, asserted from the emitted
``serve.*`` metrics snapshot:

    admitted − (completed + typed-error + shed) == 0

The campaign composes the solver-level fault injectors
(``testing.faults``: NaN-at-k, preemption, checkpoint corruption, stall)
with service-level faults (slow-worker, queue-burst,
repeated-poison-request) and fleet-level faults (worker kill/hang via
the ``worker_fault`` seam, journal bit-rot, a real subprocess
kill/restart) into scenarios that each exercise one named survival
property end to end:

==========================  ============================================
scenario                    property under test
==========================  ============================================
overload-shed               bounded admission: burst beyond capacity →
                            typed ``queue_full`` sheds, never growth
breaker-trip                consecutive cohort failures trip the
                            breaker; cooldown → half-open probe → close
deadline-mid-chunk          deadline expiry mid-solve → partial result
                            flagged ``deadline``; expiry in queue → shed
poison-requeue              a batch-killing member is isolated on retry;
                            batchmates survive, the poison gets a typed
                            transient error
slow-worker                 a stalling worker burns queued deadlines:
                            late requests shed instead of hanging
queue-burst-degradation     the graceful-degradation ladder engages
                            step by step as the queue drains
divergence-escalate         a repeatedly-NaN-poisoned request escalates
                            through the resilient driver and converges
preempt-typed-error         an unexpected mid-chunk exception still
                            yields exactly one typed outcome
corrupt-checkpoint-resume   preempt + bit-flip the newest checkpoint →
                            resume falls back a generation, bit-exact
stall-watchdog              a wedged chunk trips the watchdog while a
                            generous deadline stays out of the way
refill-poison-splice        continuous batching: a poison member spliced
                            into a RUNNING lane program kills the step;
                            the in-flight victim is retried and
                            converges, the poison gets a typed error
refill-deadline-mid-splice  a lane member's deadline expires mid-flight
                            (partial, flagged ``deadline``); a request
                            starved behind occupied lanes sheds at the
                            refill decision
refill-taint-across-splice  taint-pair exclusion holds ACROSS splices:
                            after a batch kill, no two mutually tainted
                            requests are ever lane-co-resident again
refill-preempt-occupied     a preemption with occupied lanes surfaces
                            every occupant as a typed error, trips the
                            breaker (refill denials counted), and the
                            breaker recovers through the refill path
fleet-worker-kill-          a worker killed mid-dispatch is quarantined;
mid-dispatch                its in-flight requests recover onto the
                            survivors with mutual taint, and the worker
                            restarts through warm-up
fleet-worker-hang-          a worker wedged past the heartbeat timeout
watchdog                    is caught by its watchdog (stall verdict),
                            quarantined, and its requests recover
journal-crash-replay        a crash with requests queued AND
                            lane-resident: journal replay reconstructs
                            the ledger, re-enqueues the survivors
                            (recovered taint/backoff), invariant closes
                            with zero lost and zero duplicated outcomes
journal-torn-tail           torn/CRC-corrupt journal records are
                            skipped audibly; recovery still closes the
                            invariant from the readable prefix
crash-restart-subprocess    ``python -m poisson_tpu_torch serve`` killed
                            mid-run (exit 75), restarted against the
                            journal: the invariant closes ACROSS the
                            kill/replay boundary from the two emitted
                            serve.* snapshots
dedup-idempotent-submit     duplicate client submits (pending and
                            terminated) dedup against the ledger — the
                            original outcome returns, nothing re-admits
sdc-verified-restart        a silent bit flip mid-solve is detected by
                            the in-loop drift probe, typed ``integrity``
                            with suspect-cohort taint, and recovered by
                            a verified restart — no precision burned
sdc-batch-member-isolated   a flipped bit in ONE member of a running
                            mixed-geometry bucket trips only that
                            member; its batchmates converge untouched
sdc-refill-splice           SDC lands on a member freshly spliced into
                            a RUNNING bucket: detected and retried
                            without perturbing the in-flight member
device-loss-mid-dispatch    a DEVICE dies mid-dispatch: its fault
                            domain is quarantined whole, the in-flight
                            batch recovers onto survivors, the worker
                            rebinds to surviving silicon at restart
mesh-member-drop-replan     losing planned mesh members walks the
                            elastic ladder (mesh shrink → single
                            device → shed); the re-planned
                            solve_batched(mesh=) dispatch reproduces
                            the unsharded verdicts
recover-on-smaller-topology journal recovery on a SMALLER topology:
                            lane-resident work on a dead device is
                            remapped audibly, a pinned request whose
                            device is gone gets a typed ``placement``
                            error, the merged ledger closes
deflation-stale-basis       a poisoned/evicted deflation basis makes
                            warm requests fall back to a cold solve
                            with a typed audible event — never a wrong
                            answer — and the rebuilt basis serves the
                            tail warm again
router-mispredict-downshift a slow routed backend lands below its
                            predicted roofline fraction → typed
                            misprediction, arm demotion, traffic
                            downshifts to the torch floor, and a
                            half-open re-probe recovers the arm
tenant-noisy-neighbor       an aggressor flooding at 10× its quota
                            share sheds typed ``quota_exceeded`` (zero
                            compute) while the victim's completions and
                            p99 match its solo baseline within 10%;
                            the same schedule with tenancy OFF
                            demonstrably starves the victim
tenant-retry-storm          a poison-fault tenant exhausts its retry
                            budget: dispatches bounded by admitted +
                            budget, exhausted retries become typed
                            errors, the steady tenant is untouched,
                            co-batch taint holds across tenants
==========================  ============================================

Every scenario resets the metrics registry, runs against a
:class:`VirtualClock` where timing matters (deadlines, backoff,
breaker cooldowns — no wall-clock flake), seeds every RNG from the
campaign seed, and returns a JSON-ready report embedding its ``serve.*``
counter snapshot. Same seed → same outcomes, run to run.
"""

from __future__ import annotations

import json
import os
import random
import tempfile
import time
import warnings

import numpy as np
import torch


class VirtualClock:
    """A monotonic clock that only moves when told to: ``sleep``/
    ``advance`` are the only sources of time. Injected as the service's
    ``clock``/``sleep`` pair, it makes deadlines, backoff, and breaker
    cooldowns deterministic — a chaos campaign must be a regression
    suite, not a flake generator."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def __call__(self) -> float:
        return self._now

    now = __call__

    def sleep(self, seconds: float) -> None:
        self._now += max(0.0, float(seconds))

    def advance(self, seconds: float) -> None:
        self._now += float(seconds)


_SCENARIOS: dict = {}
_GROUPS: dict = {}      # scenario name → subsystem group (for --list)


def scenario(name: str, group: str = "service"):
    def register(fn):
        _SCENARIOS[name] = fn
        _GROUPS[name] = group
        return fn

    return register


def scenario_names() -> list:
    return list(_SCENARIOS)


def scenario_groups() -> dict:
    """The campaign catalogue grouped by subsystem, registration order
    preserved within each group — what ``chaos --list`` renders (a flat
    list of dozens of names is not readable)."""
    groups: dict = {}
    for name, group in _GROUPS.items():
        groups.setdefault(group, []).append(name)
    return groups


# The harness device (run_scenario's ``device``): None means the CUDA
# card, "cpu" the CPU, as everywhere in the port.
_DEVICE = None


def _service(*args, **kwargs):
    """A :class:`SolveService` on the harness device."""
    from poisson_tpu_torch.serve import SolveService

    kwargs.setdefault("device", _DEVICE)
    return SolveService(*args, **kwargs)


def _recover(journal, *args, **kwargs):
    """:meth:`SolveService.recover` on the harness device."""
    from poisson_tpu_torch.serve import SolveService

    kwargs.setdefault("device", _DEVICE)
    return SolveService.recover(journal, *args, **kwargs)


def _device_arg() -> str:
    """The harness device as a CLI ``--device`` value."""
    return "cuda" if _DEVICE is None else str(_DEVICE)


def _child_env() -> dict:
    """The environment of a drill's child process: this one's, with the
    checkout that holds this package first on the path."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    return env


def _problem():
    from poisson_tpu_torch.config import Problem

    # 40×40 converges in 50 iterations — big enough for chunk boundaries
    # and recovery to mean something, small enough that the whole
    # campaign runs in seconds on CPU.
    return Problem(M=40, N=40)


def _quiet_degradation():
    """Degradation disabled (thresholds unreachable) for scenarios that
    are not about the ladder."""
    from poisson_tpu_torch.serve import DegradationPolicy

    return DegradationPolicy(shrink_padding_at=9.0, cap_iterations_at=9.0,
                             downshift_precision_at=9.0)


def _reset_registries() -> None:
    from poisson_tpu_torch.geometry.canvas import reset_geometry_cache
    from poisson_tpu_torch.krylov.recycle import reset_krylov_cache
    from poisson_tpu_torch.obs import metrics
    from poisson_tpu_torch.solvers.batched import reset_bucket_cache
    from poisson_tpu_torch.solvers.session import reset_session_cache

    metrics.reset()
    reset_bucket_cache()
    reset_geometry_cache()
    reset_krylov_cache()
    reset_session_cache()


def _finish(name: str, seed: int, checks: dict, detail: dict) -> dict:
    """Close a scenario: snapshot the metrics registry, assert the
    no-lost-request invariant FROM THE SNAPSHOT (the emitted counters are
    the record of truth, not the service's in-memory ledger), and bundle
    the report."""
    from poisson_tpu_torch.obs import metrics

    snap = metrics.snapshot()
    counters = snap["counters"]
    admitted = counters.get("serve.admitted", 0)
    terminated = (counters.get("serve.completed", 0)
                  + counters.get("serve.errors", 0)
                  + counters.get("serve.shed", 0))
    checks = dict(checks)
    checks["no_lost_requests"] = (admitted - terminated) == 0
    serve_counters = {k: v for k, v in sorted(counters.items())
                      if k.startswith(("serve.", "resilient.",
                                       "checkpoint.", "watchdog."))}
    return {
        "scenario": name,
        "seed": seed,
        "ok": all(checks.values()),
        "checks": checks,
        "invariant": {"admitted": admitted, "terminated": terminated,
                      "lost": admitted - terminated},
        "serve_counters": serve_counters,
        "detail": detail,
        "metrics_snapshot": snap,
    }


def _counter(name: str) -> float:
    from poisson_tpu_torch.obs import metrics

    return metrics.get(name)


# -- scenarios ----------------------------------------------------------


@scenario("overload-shed")
def _overload_shed(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_SHED,
        ServicePolicy,
        SHED_QUEUE_FULL,
        SolveRequest,
    )

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(capacity=6, max_batch=4,
                      degradation=_quiet_degradation()),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    rng = random.Random(seed)
    p = _problem()
    admission_sheds = 0
    for i in range(14):                       # burst: 14 into capacity 6
        out = svc.submit(SolveRequest(request_id=i, problem=p,
                                      rhs_gate=1.0 + rng.random()))
        if out is not None:
            admission_sheds += 1
            assert out.kind == OUTCOME_SHED
            assert out.shed_reason == SHED_QUEUE_FULL
    outs = svc.drain()
    return _finish("overload-shed", seed, {
        "burst_exceeded_capacity": admission_sheds == 8,
        "queue_full_sheds_counted": _counter("serve.shed.queue_full") == 8,
        "admitted_work_completed": all(o.converged for o in outs),
        "completed_matches_capacity": _counter("serve.completed") == 6,
    }, {"admission_sheds": admission_sheds,
        "drained": len(outs)})


@scenario("breaker-trip")
def _breaker_trip(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        BreakerPolicy,
        CLOSED,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
        TransientDispatchError,
    )

    vc = VirtualClock()
    outage = {"on": True}

    def fault(requests, attempts):
        if outage["on"]:
            raise TransientDispatchError("injected cohort outage")

    svc = _service(
        ServicePolicy(
            capacity=16,
            retry=RetryPolicy(max_attempts=1),
            breaker=BreakerPolicy(failure_threshold=3,
                                  cooldown_seconds=10.0),
            degradation=_quiet_degradation(),
        ),
        clock=vc, sleep=vc.sleep, seed=seed, dispatch_fault=fault,
    )
    p = _problem()
    for i in range(3):                 # three consecutive typed failures
        svc.submit(SolveRequest(request_id=i, problem=p))
        svc.drain()
    tripped = _counter("serve.breaker.trips") >= 1
    svc.submit(SolveRequest(request_id=3, problem=p))
    svc.submit(SolveRequest(request_id=4, problem=p))
    shed_outs = svc.drain()            # breaker open: shed, no dispatch
    outage["on"] = False
    vc.advance(10.5)                   # cooldown passes → half-open
    svc.submit(SolveRequest(request_id=5, problem=p))
    probe_outs = svc.drain()           # probe succeeds → closed
    svc.submit(SolveRequest(request_id=6, problem=p))
    after_outs = svc.drain()
    return _finish("breaker-trip", seed, {
        "breaker_tripped": tripped,
        "open_breaker_sheds": all(o.shed_reason == "breaker_open"
                                  for o in shed_outs) and len(shed_outs) == 2,
        "half_opened": _counter("serve.breaker.half_opens") >= 1,
        "probe_closed_breaker": _counter("serve.breaker.closes") >= 1
        and probe_outs[0].converged,
        "healthy_after_close": after_outs[0].converged
        and svc.stats()["breakers"]["40x40:auto:torch"] == CLOSED,
    }, {"errors_during_outage": _counter("serve.errors.transient")})


@scenario("deadline-mid-chunk")
def _deadline_mid_chunk(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_RESULT,
        OUTCOME_SHED,
        ServicePolicy,
        SolveRequest,
    )

    vc = VirtualClock()
    # default_chunk is the knob under drill: the deadlined request sets
    # no chunk of its own, so deadline enforcement happens at the
    # POLICY-default boundaries (5 iterations — small enough that the
    # 1.0 s budget expires mid-solve).
    svc = _service(
        ServicePolicy(default_chunk=5, degradation=_quiet_degradation()),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()

    def tick(state, chunks_done):      # each chunk costs 0.4 virtual s
        vc.advance(0.4)
        return None

    svc.submit(SolveRequest(request_id="deadlined", problem=p,
                            deadline_seconds=1.0, on_chunk=tick))
    svc.submit(SolveRequest(request_id="starved", problem=p,
                            deadline_seconds=0.5))
    outs = {o.request_id: o for o in svc.drain()}
    partial = outs["deadlined"]
    starved = outs["starved"]
    return _finish("deadline-mid-chunk", seed, {
        "partial_result_with_flag": partial.kind == OUTCOME_RESULT
        and partial.flag == "deadline" and partial.partial
        and not partial.converged,
        "stopped_mid_solve": 0 < partial.iterations < 50,
        "mid_solve_expiry_counted":
            _counter("serve.deadline.expired_mid_solve") == 1,
        "queued_expiry_shed": starved.kind == OUTCOME_SHED
        and starved.shed_reason == "deadline_expired",
    }, {"partial_iterations": partial.iterations})


@scenario("poison-requeue")
def _poison_requeue(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_ERROR,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import poison_batch_fault

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=16,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            degradation=_quiet_degradation(),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=poison_batch_fault({"poison"}),
    )
    p = _problem()
    svc.submit(SolveRequest(request_id="poison", problem=p))
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"innocent-{i}", problem=p,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    poison = outs["poison"]
    innocents = [outs[f"innocent-{i}"] for i in range(3)]
    return _finish("poison-requeue", seed, {
        "poison_got_typed_error": poison.kind == OUTCOME_ERROR
        and poison.error_type == "transient" and poison.attempts == 3,
        "batchmates_survived": all(o.converged for o in innocents),
        "requeues_isolated": _counter("serve.requeued.isolated") >= 3,
        "retries_backed_off": _counter("serve.retries") >= 4
        and _counter("serve.backoff_seconds") > 0,
    }, {"poison_attempts": poison.attempts,
        "innocent_attempts": [o.attempts for o in innocents]})


@scenario("slow-worker")
def _slow_worker(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import slow_worker_fault

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(capacity=16, degradation=_quiet_degradation()),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=slow_worker_fault(2.0, vc.sleep),
    )
    p = _problem()
    for i in range(5):
        svc.submit(SolveRequest(request_id=i, problem=p,
                                deadline_seconds=3.0))
    outs = {o.request_id: o for o in svc.drain()}
    kinds = [outs[i].kind for i in range(5)]
    return _finish("slow-worker", seed, {
        "first_request_beat_its_deadline": outs[0].converged,
        "in_flight_request_went_partial": outs[1].kind == "result"
        and outs[1].flag == "deadline",
        "starved_requests_shed": kinds[2:] == ["shed"] * 3
        and _counter("serve.shed.deadline_expired") == 3,
        "latency_reflects_stall":
            svc.stats()["latency_seconds"]["p99"] >= 2.0,
    }, {"kinds": kinds,
        "p99": svc.stats()["latency_seconds"]["p99"]})


@scenario("queue-burst-degradation")
def _queue_burst_degradation(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        DegradationPolicy,
        ServicePolicy,
        SolveRequest,
    )

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=12, max_batch=4,
            degradation=DegradationPolicy(
                shrink_padding_at=0.5, cap_iterations_at=0.75,
                degraded_iteration_cap=10, downshift_precision_at=0.9,
            ),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()
    for i in range(11):                # burst to 11/12 of capacity
        svc.submit(SolveRequest(request_id=i, problem=p))
    outs = svc.drain()
    partials = [o for o in outs if o.partial]
    converged = [o for o in outs if o.converged]
    return _finish("queue-burst-degradation", seed, {
        "padding_shrunk_under_load": _counter("serve.degraded.padding") >= 2,
        "iterations_capped_under_load":
            _counter("serve.degraded.iteration_cap") >= 1,
        "precision_downshifted_at_peak":
            _counter("serve.degraded.precision") >= 1,
        "capped_dispatches_went_partial": len(partials) == 4
        and all(o.flag == "cap_hit" and o.iterations == 10
                for o in partials),
        "load_drained_back_to_full_service": len(converged) == 7,
    }, {"partials": len(partials), "converged": len(converged)})


@scenario("divergence-escalate", group="solver-recovery")
def _divergence_escalate(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import nan_per_solve_hook

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            degradation=_quiet_degradation(),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # restart notices
        svc.submit(SolveRequest(request_id="poisoned", problem=p, chunk=5,
                                on_chunk=nan_per_solve_hook(10)))
        (out,) = svc.drain()
    return _finish("divergence-escalate", seed, {
        "converged_after_escalation": out.converged and out.attempts == 2,
        "escalated_via_resilient": _counter("serve.escalations") == 1
        and out.restarts >= 1,
        "in_solve_recovery_counted": _counter("resilient.restarts") >= 1,
        # The restart discards the poisoned Krylov history, so the count
        # may differ from the clean 50 — it must still be a real solve.
        "full_convergence_reached": out.iterations >= 40,
    }, {"attempts": out.attempts, "restarts": out.restarts,
        "iterations": out.iterations})


@scenario("preempt-typed-error", group="solver-recovery")
def _preempt_typed_error(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_ERROR,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import FaultPlan, chunk_hook

    vc = VirtualClock()
    svc = _service(ServicePolicy(degradation=_quiet_degradation()),
                       clock=vc, sleep=vc.sleep, seed=seed)
    p = _problem()
    svc.submit(SolveRequest(
        request_id="preempted", problem=p, chunk=5,
        on_chunk=chunk_hook(FaultPlan(preempt_after_chunks=2)),
    ))
    (out,) = svc.drain()
    return _finish("preempt-typed-error", seed, {
        "typed_internal_error": out.kind == OUTCOME_ERROR
        and out.error_type == "internal"
        and "PreemptionInjected" in out.message,
        "error_counted": _counter("serve.errors.internal") == 1,
    }, {"message": out.message[:120]})


@scenario("corrupt-checkpoint-resume", group="solver-recovery")
def _corrupt_checkpoint_resume(seed: int) -> dict:
    from poisson_tpu_torch.solvers.checkpoint import (
        pcg_solve_checkpointed,
        pcg_solve_chunked,
    )
    from poisson_tpu_torch.testing.faults import (
        FaultPlan,
        PreemptionInjected,
        chunk_hook,
        corrupt_file,
    )

    p = _problem()
    golden = pcg_solve_chunked(p, chunk=10, device=_DEVICE)
    with tempfile.TemporaryDirectory(prefix="poisson-chaos-") as td:
        path = os.path.join(td, "ck.npz")
        try:
            pcg_solve_checkpointed(
                p, path, chunk=10, keep_last=2,
                on_chunk=chunk_hook(FaultPlan(preempt_after_chunks=3)),
                device=_DEVICE,
            )
            preempted = False
        except PreemptionInjected:
            preempted = True
        corrupt_file(path, "flip")      # bit-rot the newest generation
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            resumed = pcg_solve_checkpointed(p, path, chunk=10,
                                             keep_last=2, device=_DEVICE)
    return _finish("corrupt-checkpoint-resume", seed, {
        "preemption_fired": preempted,
        # The flipped byte may land in the payload (CRC catches it) or in
        # the npz structure itself (the loader reports it unreadable) —
        # either way the damage must be DETECTED, never resumed.
        "corruption_detected": _counter("checkpoint.crc_failures")
        + _counter("checkpoint.corrupt") >= 1,
        "older_generation_resumed":
            _counter("checkpoint.generation_fallbacks") >= 1,
        "bit_exact_after_recovery":
            int(resumed.iterations) == int(golden.iterations)
            and bool(torch.equal(resumed.w, golden.w)),
    }, {"iterations": int(resumed.iterations)})


@scenario("stall-watchdog", group="solver-recovery")
def _stall_watchdog(seed: int) -> dict:
    from poisson_tpu_torch.parallel.watchdog import Watchdog
    from poisson_tpu_torch.serve import Deadline
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked

    p = _problem()
    fired = []
    wd = Watchdog(timeout=0.15, poll_interval=0.03,
                  on_timeout=fired.append)   # record, don't interrupt
    stalled = {"done": False}

    def stall_once(state, chunks_done):
        if not stalled["done"]:
            stalled["done"] = True
            time.sleep(0.5)                  # a genuinely wedged chunk
        return None

    res = pcg_solve_chunked(p, chunk=10, watchdog=wd, on_chunk=stall_once,
                            deadline=Deadline(3600.0), device=_DEVICE)
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED

    return _finish("stall-watchdog", seed, {
        "watchdog_fired_on_stall": wd.fired and len(fired) == 1
        and _counter("watchdog.stalls") >= 1,
        "beats_recorded": _counter("watchdog.beats") >= 4,
        # Deadline-vs-watchdog: the stall is a liveness event, not a
        # budget event — the generous deadline must NOT flag the result.
        "deadline_stayed_quiet": int(res.flag) == FLAG_CONVERGED
        and int(res.iterations) == 50,
    }, {"stall_diag_beats": fired[0]["beats"] if fired else None})


# -- continuous-batching refill races -----------------------------------
# All four drive ServicePolicy(scheduling="continuous"): the lane table
# (serve.refill) with converged lanes retiring and queued RHS splicing
# into a RUNNING bucket executable. Every scenario's invariant is still
# admitted − (completed + errors + shed) == 0, read from the snapshot.


def _continuous_policy(**kw):
    from poisson_tpu_torch.serve import SCHED_CONTINUOUS, ServicePolicy

    kw.setdefault("degradation", _quiet_degradation())
    return ServicePolicy(scheduling=SCHED_CONTINUOUS, **kw)


@scenario("refill-poison-splice", group="refill")
def _refill_poison_splice(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_ERROR,
        RetryPolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import poison_batch_fault

    vc = VirtualClock()
    svc = _service(
        _continuous_policy(
            capacity=16, max_batch=2, refill_chunk=10,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=poison_batch_fault({"poison"}),
    )
    p = _problem()
    # The race this scenario exists for: innocent-0 is 20 iterations
    # into a lane program (two pumped chunks) when the poison arrives
    # and splices into the free lane of the SAME running executable —
    # its kill lands on a genuinely in-flight victim, not a fresh batch.
    svc.submit(SolveRequest(request_id="innocent-0", problem=p))
    svc.pump()
    svc.pump()
    svc.submit(SolveRequest(request_id="poison", problem=p))
    svc.submit(SolveRequest(request_id="innocent-1", problem=p,
                            rhs_gate=1.1))
    outs = {o.request_id: o for o in svc.drain()}
    poison = outs["poison"]
    innocents = [outs[f"innocent-{i}"] for i in range(2)]
    return _finish("refill-poison-splice", seed, {
        "poison_got_typed_error": poison.kind == OUTCOME_ERROR
        and poison.error_type == "transient" and poison.attempts == 3,
        "in_flight_victim_recovered": outs["innocent-0"].converged
        and outs["innocent-0"].attempts == 2,
        "all_innocents_converged": all(o.converged for o in innocents),
        "splices_counted": _counter("serve.refill.splices") >= 5,
        "retired_lanes_counted":
            _counter("serve.refill.retired_lanes") >= 2,
        "requeues_isolated": _counter("serve.requeued.isolated") >= 2,
    }, {"poison_attempts": poison.attempts,
        "innocent_attempts": [o.attempts for o in innocents],
        "splices": _counter("serve.refill.splices")})


@scenario("refill-deadline-mid-splice", group="refill")
def _refill_deadline_mid_splice(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_RESULT,
        OUTCOME_SHED,
        SolveRequest,
    )

    vc = VirtualClock()
    svc = _service(
        _continuous_policy(capacity=16, max_batch=2, refill_chunk=10),
        clock=vc, sleep=vc.sleep, seed=seed,
        # Each chunk step costs 0.3 virtual seconds: the lane engine's
        # boundary is where deadlines are observed.
        dispatch_fault=lambda requests, attempts: vc.advance(0.3),
    )
    p = _problem()
    svc.submit(SolveRequest(request_id="fits", problem=p))
    svc.submit(SolveRequest(request_id="mid", problem=p, rhs_gate=1.1,
                            deadline_seconds=1.0))
    svc.submit(SolveRequest(request_id="starved", problem=p,
                            deadline_seconds=0.5))
    outs = {o.request_id: o for o in svc.drain()}
    mid, starved = outs["mid"], outs["starved"]
    return _finish("refill-deadline-mid-splice", seed, {
        "lane_deadline_went_partial": mid.kind == OUTCOME_RESULT
        and mid.flag == "deadline" and mid.partial
        and not mid.converged,
        "stopped_mid_flight": 0 < mid.iterations < 50,
        "mid_flight_expiry_counted":
            _counter("serve.deadline.expired_mid_solve") == 1,
        "starved_behind_occupied_lanes_shed":
            starved.kind == OUTCOME_SHED
            and starved.shed_reason == "deadline_expired",
        "undeadlined_member_converged": outs["fits"].converged,
    }, {"mid_iterations": mid.iterations,
        "fits_iterations": outs["fits"].iterations})


@scenario("refill-taint-across-splice", group="refill")
def _refill_taint_across_splice(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        OUTCOME_ERROR,
        RetryPolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import (compose_faults,
                                                  poison_batch_fault)

    co_resident: list = []

    def record(requests, attempts):
        co_resident.append({r.request_id for r in requests})

    vc = VirtualClock()
    svc = _service(
        _continuous_policy(
            capacity=16, max_batch=4, refill_chunk=10,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=compose_faults(record,
                                      poison_batch_fault({"bad"})),
    )
    p = _problem()
    svc.submit(SolveRequest(request_id="bad", problem=p))
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"mate-{i}", problem=p,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    # The first kill mutually taints everything co-resident with it;
    # from then on no step may ever see two of those ids share lanes.
    kill_at = next(i for i, ids in enumerate(co_resident) if "bad" in ids)
    tainted = co_resident[kill_at]
    violations = [ids for ids in co_resident[kill_at + 1:]
                  if len(ids & tainted) > 1]
    return _finish("refill-taint-across-splice", seed, {
        "kill_saw_full_lanes": len(tainted) == 4,
        "tainted_pairs_never_co_resident_again": not violations,
        "mates_converged": all(outs[f"mate-{i}"].converged
                               for i in range(3)),
        "bad_got_typed_error": outs["bad"].kind == OUTCOME_ERROR
        and outs["bad"].error_type == "transient",
    }, {"steps_observed": len(co_resident),
        "violations": [sorted(map(str, v)) for v in violations]})


@scenario("refill-preempt-occupied", group="refill")
def _refill_preempt_occupied(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        BreakerPolicy,
        CLOSED,
        OUTCOME_ERROR,
        SolveRequest,
    )

    boom = {"armed": True}

    def preempt_once(requests, attempts):
        if boom["armed"] and len(requests) >= 2:
            boom["armed"] = False
            raise RuntimeError("injected preemption with occupied lanes")

    vc = VirtualClock()
    svc = _service(
        _continuous_policy(
            capacity=16, max_batch=4, refill_chunk=10,
            breaker=BreakerPolicy(failure_threshold=1,
                                  cooldown_seconds=10.0),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=preempt_once,
    )
    p = _problem()
    for i in range(4):
        svc.submit(SolveRequest(request_id=i, problem=p,
                                rhs_gate=1.0 + i / 10))
    svc.submit(SolveRequest(request_id="denied", problem=p))
    outs = {o.request_id: o for o in svc.drain()}
    errors = [outs[i] for i in range(4)]
    vc.advance(10.5)               # cooldown passes → half-open probe
    svc.submit(SolveRequest(request_id="after", problem=p))
    (after,) = svc.drain()
    cohort = "40x40:auto:torch"
    return _finish("refill-preempt-occupied", seed, {
        "occupants_got_typed_internal_errors": all(
            o.kind == OUTCOME_ERROR and o.error_type == "internal"
            and "preemption" in o.message for o in errors),
        "errors_counted": _counter("serve.errors.internal") == 4,
        "refill_denied_by_breaker":
            _counter("serve.refill.refill_denied_by_breaker") == 1
            and outs["denied"].shed_reason == "breaker_open",
        "breaker_recovered_through_refill": after.converged
        and svc.stats()["breakers"][cohort] == CLOSED,
    }, {"after_iterations": after.iterations})


# -- durable-fleet scenarios (serve.fleet + serve.journal) --------------
# Worker faults are injected through the service's worker_fault seam
# (testing.faults.worker_kill_fault/worker_hang_fault); crash scenarios
# exercise the write-ahead journal, in-process (abandon the service,
# recover into a fresh one on the same registry) and across a real
# process kill (subprocess, exit 75 — the preemption convention).
# The invariant stays admitted − (completed + errors + shed) == 0, read
# from the emitted serve.* snapshot(s).


@scenario("fleet-worker-kill-mid-dispatch", group="fleet")
def _fleet_worker_kill_mid_dispatch(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        FleetPolicy,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
        WORKER_RUNNING,
    )
    from poisson_tpu_torch.testing.faults import worker_kill_fault

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=16, max_batch=4,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.05,
                              backoff_cap=0.1),
            degradation=_quiet_degradation(),
            # warm_restart/max_restarts are pinned, not inherited: the
            # scenario's checks (restarts >= 1 THROUGH warm-up, fleet
            # healthy after) are exactly these knobs' behavior — a
            # changed default must not silently change what this drill
            # proves.
            fleet=FleetPolicy(workers=2, quarantine_seconds=0.02,
                              recovery_backoff=0.05, max_restarts=3,
                              warm_restart=True),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        worker_fault=worker_kill_fault({0}),
    )
    p = _problem()
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"r{i}", problem=p,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    workers = svc.stats()["workers"]
    return _finish("fleet-worker-kill-mid-dispatch", seed, {
        "all_recovered_and_converged": all(
            o.converged and o.attempts == 2 for o in outs.values()),
        "worker_quarantined": _counter("serve.fleet.quarantines") == 1,
        "in_flight_recovered":
            _counter("serve.fleet.recovered_requests") == 4,
        "worker_restarted_through_warmup":
            _counter("serve.fleet.restarts") >= 1
            and _counter("serve.fleet.warmup_solves") >= 1,
        "fleet_healthy_after": all(s == WORKER_RUNNING
                                   for s in workers.values()),
    }, {"attempts": sorted(o.attempts for o in outs.values()),
        "workers": {str(k): v for k, v in workers.items()}})


@scenario("fleet-worker-hang-watchdog", group="fleet")
def _fleet_worker_hang_watchdog(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        FleetPolicy,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import worker_hang_fault

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=16, max_batch=4,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.05,
                              backoff_cap=0.1),
            degradation=_quiet_degradation(),
            fleet=FleetPolicy(workers=2, heartbeat_timeout=0.2,
                              quarantine_seconds=0.02,
                              recovery_backoff=0.05),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        # The hang (0.5s on the virtual clock) overruns the 0.2s
        # heartbeat timeout: the stall verdict must land on the
        # worker's watchdog before the supervisor quarantines it.
        worker_fault=worker_hang_fault({0}, 0.5, vc.advance),
    )
    p = _problem()
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"h{i}", problem=p,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    return _finish("fleet-worker-hang-watchdog", seed, {
        "watchdog_caught_the_hang": _counter("watchdog.stalls") >= 1
        and _counter("serve.fleet.hangs") >= 1,
        "worker_quarantined": _counter("serve.fleet.quarantines") == 1,
        "requests_recovered":
            _counter("serve.fleet.recovered_requests") == 3,
        "all_converged_on_survivors": all(
            o.converged and o.attempts == 2 for o in outs.values()),
    }, {"p99": svc.stats()["latency_seconds"]["p99"]})


@scenario("journal-crash-replay", group="journal")
def _journal_crash_replay(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        SolveJournal,
        SolveRequest,
        replay_journal,
    )

    p = _problem()
    with tempfile.TemporaryDirectory(prefix="poisson-journal-") as td:
        path = os.path.join(td, "serve.journal")
        vc = VirtualClock()
        policy = _continuous_policy(capacity=16, max_batch=2,
                                    refill_chunk=10)
        journal_a = SolveJournal(path, clock=vc)
        svc_a = _service(policy, clock=vc, sleep=vc.sleep,
                             seed=seed, journal=journal_a)
        for i in range(4):
            svc_a.submit(SolveRequest(request_id=f"req-{i}", problem=p,
                                      rhs_gate=1.0 + i / 10))
        # Run until exactly two outcomes exist, then one more pump so
        # the remaining two have SPLICED into the freed lanes — the
        # process "dies" with both survivors genuinely lane-resident,
        # mid-flight, which is the recovery case that matters.
        while len(svc_a.outcomes()) < 2:
            svc_a.pump()
        svc_a.pump()
        journal_a.close()
        # Restart: a fresh service replays the same journal on the SAME
        # metrics registry (the merged-counters model of two processes).
        journal_b = SolveJournal(path, clock=vc)
        svc_b = _recover(journal_b, policy, clock=vc,
                                     sleep=vc.sleep, seed=seed)
        replay = svc_b.recovery
        outs = {o.request_id: o for o in svc_b.drain()}
        stats = svc_b.stats()
        journal_b.close()
        final = replay_journal(path)
    return _finish("journal-crash-replay", seed, {
        "replay_reconstructed_the_ledger": replay.submitted == 4
        and len(replay.outcomes) == 2 and len(replay.pending) == 2
        and replay.lost == 0,
        "survivors_were_mid_flight_and_tainted": all(
            pend.in_flight for pend in replay.pending)
        and all(pend.taint == {other.request.request_id}
                for pend, other in zip(replay.pending,
                                       reversed(replay.pending))),
        "survivors_recovered_and_converged": len(outs) == 2
        and all(o.converged for o in outs.values()),
        "recovered_counted_not_readmitted":
            stats["recovered"] == 2 and stats["lost"] == 0
            and _counter("serve.recovered") == 2
            and _counter("serve.admitted") == 4,
        "exactly_one_outcome_per_request":
            sorted(final.outcomes) == [f"req-{i}" for i in range(4)]
            and not final.duplicate_outcomes and not final.pending,
    }, {"pre_crash_outcomes": 2,
        "recovered_attempts": sorted(o.attempts for o in outs.values())})


@scenario("journal-torn-tail", group="journal")
def _journal_torn_tail(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        SolveJournal,
        SolveRequest,
        replay_journal,
    )

    p = _problem()
    with tempfile.TemporaryDirectory(prefix="poisson-torn-") as td:
        path = os.path.join(td, "serve.journal")
        vc = VirtualClock()
        policy = _continuous_policy(capacity=16, max_batch=2,
                                    refill_chunk=10)
        journal_a = SolveJournal(path, clock=vc)
        svc_a = _service(policy, clock=vc, sleep=vc.sleep,
                             seed=seed, journal=journal_a)
        for i in range(3):
            svc_a.submit(SolveRequest(request_id=f"t{i}", problem=p,
                                      rhs_gate=1.0 + i / 10))
        svc_a.pump()                  # dispatch/splice records exist
        journal_a.close()
        # Bit-rot the tail: corrupt the CRC of the last record, then
        # append a sealed-looking fake outcome with a WRONG crc and a
        # half-written line (the crash landed mid-write). None of the
        # three may be trusted — the fake outcome in particular must
        # not mark t0 terminated.
        lines = open(path).read().splitlines()
        tampered = json.loads(lines[-1])
        tampered["crc32"] = (tampered["crc32"] + 1) % (2 ** 32)
        lines[-1] = json.dumps(tampered, sort_keys=True)
        with open(path, "w") as fh:
            fh.write("\n".join(lines) + "\n")
            fh.write('{"kind": "outcome", "outcome": "result", '
                     '"request_id": "t0", "seq": 999, "t": 9.9, '
                     '"crc32": 12345}\n')
            fh.write('{"seq": 1000, "ki')        # torn mid-write
        journal_b = SolveJournal(path, clock=vc)
        svc_b = _recover(journal_b, policy, clock=vc,
                                     sleep=vc.sleep, seed=seed)
        replay = svc_b.recovery
        outs = {o.request_id: o for o in svc_b.drain()}
        journal_b.close()
        final = replay_journal(path)
    return _finish("journal-torn-tail", seed, {
        "torn_records_skipped_audibly": replay.torn_records == 3
        and _counter("serve.journal.torn_records") >= 3
        and len(replay.torn_detail) == 3,
        "fake_outcome_not_trusted": not replay.outcomes
        and len(replay.pending) == 3,
        "all_recovered_and_converged": len(outs) == 3
        and all(o.converged for o in outs.values()),
        "ledger_closed_despite_corruption":
            sorted(o for o in final.outcomes
                   if not final.duplicate_outcomes)
            == [f"t{i}" for i in range(3)],
    }, {"torn_detail": replay.torn_detail})


@scenario("crash-restart-subprocess", group="journal")
def _crash_restart_subprocess(seed: int) -> dict:
    """The acceptance-criteria drill: kill ``python -m poisson_tpu_torch
    serve`` mid-run (exit 75 after two outcomes, telemetry flushed,
    queue and lanes abandoned), restart it against the journal, and
    assert the ledger invariant ACROSS the kill/replay boundary from the
    two emitted serve.* snapshots — zero lost, zero duplicated."""
    import subprocess
    import sys

    from poisson_tpu_torch.serve.journal import replay_journal

    with tempfile.TemporaryDirectory(prefix="poisson-crash-") as td:
        journal = os.path.join(td, "serve.journal")
        a_metrics = os.path.join(td, "metrics-a.json")
        b_metrics = os.path.join(td, "metrics-b.json")
        env = _child_env()
        base = [sys.executable, "-m", "poisson_tpu_torch", "serve", "40",
                "40", "--continuous", "--refill-chunk", "10",
                "--max-batch", "2", "--journal", journal,
                "--seed", str(seed), "--device", _device_arg()]
        phase_a = subprocess.run(
            base + ["--requests", "6", "--kill-after", "2",
                    "--metrics-out", a_metrics],
            capture_output=True, text=True, timeout=240, env=env)
        phase_b = subprocess.run(
            base + ["--requests", "0", "--recover", "--json",
                    "--metrics-out", b_metrics],
            capture_output=True, text=True, timeout=240, env=env)

        def counters(path):
            try:
                with open(path) as fh:
                    return json.load(fh).get("counters", {})
            except (OSError, ValueError):
                return {}

        ca, cb = counters(a_metrics), counters(b_metrics)

        def terminated(c):
            return (c.get("serve.completed", 0) + c.get("serve.errors", 0)
                    + c.get("serve.shed", 0))

        admitted = ca.get("serve.admitted", 0) + cb.get("serve.admitted", 0)
        done = terminated(ca) + terminated(cb)
        final = replay_journal(journal)
        detail = {
            "phase_a_rc": phase_a.returncode,
            "phase_b_rc": phase_b.returncode,
            "admitted": admitted, "terminated": done,
            "terminated_before_kill": terminated(ca),
            "recovered": cb.get("serve.recovered", 0),
            "stderr_tail_a": phase_a.stderr.strip()[-300:],
            "stderr_tail_b": phase_b.stderr.strip()[-300:],
        }
    return _finish("crash-restart-subprocess", seed, {
        "phase_a_died_mid_run": phase_a.returncode == 75
        and terminated(ca) < 6,
        "phase_b_recovered_cleanly": phase_b.returncode == 0,
        "invariant_closes_across_restart": admitted == 6
        and admitted - done == 0,
        "zero_lost": sorted(final.outcomes) == [str(i) for i in range(6)]
        and not final.pending,
        "zero_duplicated": not final.duplicate_outcomes,
        "recovery_balanced_the_deficit":
            cb.get("serve.recovered", 0) == 6 - terminated(ca),
    }, detail)


@scenario("dedup-idempotent-submit")
def _dedup_idempotent_submit(seed: int) -> dict:
    from poisson_tpu_torch.serve import (
        ServicePolicy,
        SolveRequest,
    )

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(capacity=8, dedup=True,
                      degradation=_quiet_degradation()),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()
    svc.submit(SolveRequest(request_id="once", problem=p))
    dup_pending = svc.submit(SolveRequest(request_id="once", problem=p))
    (out,) = svc.drain()
    dup_done = svc.submit(SolveRequest(request_id="once", problem=p))
    return _finish("dedup-idempotent-submit", seed, {
        "pending_duplicate_not_readmitted": dup_pending is None,
        "done_duplicate_returns_original": dup_done is out
        and dup_done.converged,
        "dedup_hits_counted": _counter("serve.dedup.hits") == 2,
        "admitted_exactly_once": _counter("serve.admitted") == 1,
    }, {"outcome_kind": out.kind})


@scenario("geometry-mixed-cobatch", group="geometry")
def _geometry_mixed_cobatch(seed: int) -> dict:
    """A mixed-geometry bucket under a poison-member fault: taint and
    requeue key on (request, fingerprint) — the poisoned request never
    re-co-batches with its batchmates, AND a fresh request carrying the
    poison's GEOMETRY FAMILY never joins them either. Dispatch
    compositions are recorded at the fault seam; the invariant is
    asserted from the emitted ``serve.*`` snapshot like every scenario."""
    from poisson_tpu_torch.geometry import Ellipse, Rectangle, fingerprint_of
    from poisson_tpu_torch.serve import (
        OUTCOME_ERROR,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import (compose_faults,
                                                  poison_batch_fault)

    geo_a = Ellipse(cx=0.1, cy=0.0, rx=0.7, ry=0.4)     # the bad family
    geo_b = Rectangle(-0.6, -0.3, 0.5, 0.3)
    dispatches: list = []

    def record(requests, attempts):
        dispatches.append({r.request_id for r in requests})

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=16, max_batch=8,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            degradation=_quiet_degradation(),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=compose_faults(record,
                                      poison_batch_fault({"poison"})),
    )
    p = _problem()
    svc.submit(SolveRequest(request_id="poison", problem=p,
                            geometry=geo_a))
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"innocent-{i}", problem=p,
                                geometry=geo_b, rhs_gate=1.0 + i / 10))
    # Pump until the first batch kill has happened, then submit a FRESH
    # request carrying the poison's geometry family: the fingerprint
    # half of the taint must keep it away from the tainted innocents.
    while svc.pump():
        if _counter("serve.retries") >= 1:
            break
    svc.submit(SolveRequest(request_id="twin", problem=p,
                            geometry=geo_a))
    outs = {o.request_id: o for o in svc.drain()}
    innocents = [outs[f"innocent-{i}"] for i in range(3)]
    kill_at = next(i for i, ids in enumerate(dispatches)
                   if "poison" in ids)
    mates = dispatches[kill_at] - {"poison"}
    # After the kill: the poison must never share a dispatch with its
    # batchmates again (request taint), and NO carrier of the poison's
    # fingerprint — the twin included — may join them (fingerprint
    # taint). The twin may still co-batch with the poison (same family,
    # no pair taint), which is exactly the (request, fingerprint) rule.
    violations = [
        ids for ids in dispatches[kill_at + 1:]
        if (("poison" in ids or "twin" in ids) and (ids & mates))
    ]
    fps = {rid: fingerprint_of(g) for rid, g in
           [("poison", geo_a), ("twin", geo_a),
            ("innocent-0", geo_b)]}
    return _finish("geometry-mixed-cobatch", seed, {
        "mixed_bucket_cobatched": len(mates) == 3
        and fps["poison"] != fps["innocent-0"],
        "twin_shares_bad_fingerprint": fps["twin"] == fps["poison"],
        "bad_geometry_never_rejoined_batchmates": not violations,
        "poison_got_typed_error": outs["poison"].kind == OUTCOME_ERROR
        and outs["poison"].error_type == "transient",
        "innocents_converged": all(o.converged for o in innocents),
        "twin_converged": outs["twin"].converged,
        "geometry_isolation_counted":
            _counter("serve.requeued.geometry_isolated") >= 1,
    }, {"dispatches": [sorted(map(str, d)) for d in dispatches],
        "poison_attempts": outs["poison"].attempts})


# -- silent-data-corruption scenarios (poisson_tpu_torch.integrity) -----------
# A flipped bit is the fault every OTHER scenario cannot see: no NaN, no
# crash, no hang — the recurrence residual keeps shrinking while the
# iterate silently goes wrong. These three drill the detector (the
# in-loop drift probe), the recovery (verified restart, typed integrity
# retry, suspect-cohort taint) and the isolation (one corrupted member
# of a running bucket, innocents untouched) end to end; the invariant is
# still admitted − (completed + errors + shed) == 0, from the snapshot.


@scenario("sdc-verified-restart", group="integrity")
def _sdc_verified_restart(seed: int) -> dict:
    """A seeded exponent bit flip mid-chunked-solve with always-on
    verification: the in-loop probe stamps FLAG_INTEGRITY, the service
    types it ``integrity``, taints the hardware cohort, and the retry
    escalates through the resilient driver — which re-hits the SAME
    flip (per-solve hook) and recovers via verified restart WITHOUT
    burning a precision escalation."""
    from poisson_tpu_torch.serve import (
        IntegrityPolicy,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import bitflip_per_solve_hook

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            degradation=_quiet_degradation(),
            integrity=IntegrityPolicy(verify_every=5),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        svc.submit(SolveRequest(
            request_id="sdc", problem=p, chunk=5,
            on_chunk=bitflip_per_solve_hook(20, buffer="w", seed=seed),
        ))
        (out,) = svc.drain()
    return _finish("sdc-verified-restart", seed, {
        "detected_and_typed": _counter("serve.integrity.detections") >= 1
        and _counter("serve.integrity.retries") >= 1,
        "hardware_cohort_tainted":
            _counter("serve.integrity.suspect_cohorts") == 1,
        "verified_restart_recovered": out.converged and out.restarts >= 1
        and _counter("integrity.verified_restarts") >= 1,
        "no_precision_escalation_burned":
            _counter("resilient.escalations") == 0,
        "no_false_alarms": _counter("integrity.false_alarms") == 0,
    }, {"attempts": out.attempts, "restarts": out.restarts,
        "iterations": out.iterations})


@scenario("sdc-batch-member-isolated", group="integrity")
def _sdc_batch_member_isolated(seed: int) -> dict:
    """One member of a RUNNING mixed-geometry bucket takes a bit flip
    mid-flight: the per-member probe stops the corrupted member alone
    (FLAG_INTEGRITY, masked), its batchmates — different fictitious
    domains sharing the same lane executable — converge untouched on
    their first attempt, and the victim converges on its defended
    retry."""
    from poisson_tpu_torch.geometry import Ellipse, Rectangle
    from poisson_tpu_torch.serve import (
        IntegrityPolicy,
        RetryPolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import bitflip_lane

    vc = VirtualClock()
    svc = _service(
        _continuous_policy(
            capacity=16, max_batch=4, refill_chunk=10,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            integrity=IntegrityPolicy(verify_every=5),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()
    geo_a = Ellipse(cx=0.1, cy=0.0, rx=0.7, ry=0.4)
    geo_b = Rectangle(-0.6, -0.3, 0.5, 0.3)
    svc.submit(SolveRequest(request_id="victim", problem=p,
                            geometry=geo_a))
    svc.submit(SolveRequest(request_id="innocent-0", problem=p,
                            geometry=geo_b, rhs_gate=1.1))
    svc.submit(SolveRequest(request_id="innocent-1", problem=p,
                            geometry=geo_a, rhs_gate=1.2))
    svc.pump()
    svc.pump()                   # all three lane-resident, ~20 deep
    table = svc._pool.workers[0].table
    lane = next(i for i, e in enumerate(table.entries)
                if e is not None
                and e.request.request_id == "victim")
    co_resident = table.occupied() and len(table.occupants()) == 3
    bitflip_lane(table.batch, lane, buffer="w", seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        outs = {o.request_id: o for o in svc.drain()}
    innocents = [outs["innocent-0"], outs["innocent-1"]]
    return _finish("sdc-batch-member-isolated", seed, {
        "flip_landed_mid_flight": co_resident,
        "only_the_victim_tripped":
            _counter("serve.integrity.detections") == 1,
        "victim_recovered_on_retry": outs["victim"].converged
        and outs["victim"].attempts == 2,
        "innocents_untouched": all(
            o.converged and o.attempts == 1 for o in innocents),
        "mixed_geometries_shared_the_bucket": table.multi_geometry
        and geo_a.fingerprint != geo_b.fingerprint,
    }, {"victim_attempts": outs["victim"].attempts,
        "innocent_attempts": [o.attempts for o in innocents]})


@scenario("sdc-refill-splice", group="integrity")
def _sdc_refill_splice(seed: int) -> dict:
    """The refill race under SDC: a fresh member splices into a lane of
    a RUNNING bucket program, takes a bit flip right after its splice,
    and is detected/retried without perturbing the in-flight member it
    joined — the splice machinery and the integrity masking compose,
    and the ledger still closes."""
    from poisson_tpu_torch.serve import (
        IntegrityPolicy,
        RetryPolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import bitflip_lane

    vc = VirtualClock()
    svc = _service(
        _continuous_policy(
            capacity=16, max_batch=2, refill_chunk=10,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            integrity=IntegrityPolicy(verify_every=5),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()
    svc.submit(SolveRequest(request_id="early", problem=p))
    svc.pump()
    svc.pump()                   # "early" ~20 iterations deep
    svc.submit(SolveRequest(request_id="late", problem=p, rhs_gate=1.1))
    svc.pump()                   # "late" splices into the running bucket
    table = svc._pool.workers[0].table
    views = {table.entries[v["lane"]].request.request_id: v["k"]
             for v in table.batch.lane_view()
             if table.entries[v["lane"]] is not None}
    spliced_mid_flight = ("late" in views and "early" in views
                         and views["early"] - views["late"] >= 10)
    lane = next(i for i, e in enumerate(table.entries)
                if e is not None and e.request.request_id == "late")
    bitflip_lane(table.batch, lane, buffer="r", seed=seed)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        outs = {o.request_id: o for o in svc.drain()}
    return _finish("sdc-refill-splice", seed, {
        "splice_landed_mid_flight": spliced_mid_flight,
        "spliced_member_detected":
            _counter("serve.integrity.detections") == 1,
        "spliced_member_recovered": outs["late"].converged
        and outs["late"].attempts == 2,
        "in_flight_member_untouched": outs["early"].converged
        and outs["early"].attempts == 1,
        # Two lane splices (the retry is an escalated SOLO dispatch
        # through the verified-restart driver, not a re-splice).
        "splices_counted": _counter("serve.refill.splices") >= 2,
    }, {"lane_depths_at_flip": views,
        "late_attempts": outs["late"].attempts})


# -- placement / fault-domain scenarios (serve.placement) ---------------
# The fleet is bound to real device slots (fault domains); these three
# drill the placement rail end to end: a device dying mid-dispatch
# (quarantine by fault domain, rebind at restart), the elastic re-plan
# ladder for sharded work (mesh shrink → single device → shed) beside a
# real batch×mesh dispatch, and journal recovery on a SMALLER topology
# (remap audibly, type the unmappable). The invariant stays
# admitted − (completed + errors + shed) == 0, from the snapshot.


@scenario("device-loss-mid-dispatch", group="placement")
def _device_loss_mid_dispatch(seed: int) -> dict:
    """A device (not just a worker) dies mid-dispatch: the supervisor
    marks the fault domain lost (placement epoch bump), quarantines the
    device's worker, recovers the in-flight batch onto the survivor
    with mutual taint, and the quarantined worker REBINDS to a
    surviving device at restart — warm-up running its sticky buckets
    there."""
    from poisson_tpu_torch.serve import (
        FleetPolicy,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
        WORKER_RUNNING,
    )
    from poisson_tpu_torch.testing.faults import device_loss_fault

    vc = VirtualClock()
    holder: dict = {}
    svc = _service(
        ServicePolicy(
            capacity=16, max_batch=4,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.05,
                              backoff_cap=0.1),
            degradation=_quiet_degradation(),
            fleet=FleetPolicy(workers=2, devices=2,
                              quarantine_seconds=0.02,
                              recovery_backoff=0.05),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        worker_fault=device_loss_fault(
            {0}, lambda wid: holder["svc"].worker_device(wid)),
    )
    holder["svc"] = svc
    p = _problem()
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"d{i}", problem=p,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    stats = svc.stats()
    placement = stats["placement"]
    return _finish("device-loss-mid-dispatch", seed, {
        "device_loss_counted":
            _counter("serve.fleet.device_losses") == 1,
        "epoch_bumped_and_device_marked_lost":
            placement["epoch"] == 2 and placement["lost"] == [0],
        "fault_domain_quarantined":
            _counter("serve.fleet.quarantines") == 1,
        "in_flight_recovered_onto_survivor":
            _counter("serve.fleet.recovered_requests") == 4
            and all(o.converged and o.attempts == 2
                    for o in outs.values()),
        "worker_rebound_to_survivor":
            _counter("serve.placement.rebinds") == 1
            and set(placement["bindings"].values()) == {1},
        "fleet_healthy_after": all(
            s == WORKER_RUNNING for s in stats["workers"].values()),
    }, {"attempts": sorted(o.attempts for o in outs.values()),
        "placement": placement})


@scenario("mesh-member-drop-replan", group="placement")
def _mesh_member_drop_replan(seed: int) -> dict:
    """Losing members of a planned mesh walks the elastic ladder —
    full mesh → shrunken mesh → single device → shed, each rung
    counted — while a real ``solve_batched(mesh=)`` dispatch on the
    re-planned topology reproduces the unsharded batched verdicts
    (the re-plan changes WHERE the work runs, never what it
    computes)."""
    from poisson_tpu_torch.parallel.mesh import make_solver_mesh
    from poisson_tpu_torch.serve import (
        RUNG_MESH,
        RUNG_SHED,
        RUNG_SINGLE,
        DeviceRegistry,
        elastic_plan,
    )
    from poisson_tpu_torch.serve.placement import default_devices
    from poisson_tpu_torch.solvers.batched import solve_batched

    registry = DeviceRegistry(count=4, devices=default_devices(_DEVICE))
    rung0, plan0 = elastic_plan(registry, 4)
    registry.lose(1)
    rung1, plan1 = elastic_plan(registry, 4)      # shrunken mesh
    shrink_counted = _counter("serve.degraded.mesh_shrink") == 1
    # A real sharded dispatch on the re-planned width: the port's mesh
    # may repeat a device, so the planned slots map through the registry
    # onto the harness device however many cards there are.
    mesh = make_solver_mesh([registry.device(slot) for slot in plan1])
    ref = solve_batched(_problem(), rhs_gates=[1.0, 1.1], device=_DEVICE)
    got = solve_batched(_problem(), rhs_gates=[1.0, 1.1], mesh=mesh)
    registry.lose(0)
    registry.lose(2)
    rung2, _ = elastic_plan(registry, 4)          # one survivor
    registry.lose(3)
    rung3, _ = elastic_plan(registry, 4)          # nothing left
    return _finish("mesh-member-drop-replan", seed, {
        "full_mesh_planned": rung0 == RUNG_MESH and plan0 == [0, 1, 2, 3],
        "member_drop_shrinks_the_mesh": rung1 == RUNG_MESH
        and plan1 == [0, 2, 3] and shrink_counted,
        "replanned_dispatch_reproduces_unsharded":
            bool(torch.equal(got.iterations.cpu(), ref.iterations.cpu()))
            and bool(np.array_equal(np.asarray(torch.as_tensor(got.flag)
                                               .cpu()),
                                    np.asarray(torch.as_tensor(ref.flag)
                                               .cpu())))
            and bool(torch.allclose(got.w.cpu(), ref.w.cpu(), atol=1e-6)),
        "single_device_rung": rung2 == RUNG_SINGLE
        and _counter("serve.degraded.single_device") == 1,
        "shed_rung": rung3 == RUNG_SHED
        and _counter("serve.degraded.mesh_shed") == 1,
        "epoch_tracked_every_loss": registry.epoch == 5,
    }, {"mesh_devices": mesh.px * mesh.py,
        "plans": [plan0, plan1]})


@scenario("recover-on-smaller-topology", group="placement")
def _recover_on_smaller_topology(seed: int) -> dict:
    """The crash/recovery drill ACROSS a topology change: a fleet on a
    2-device topology loses device 0 mid-run (worker rebinds to device
    1), then the process dies with work lane-resident on device 1 and a
    request PINNED to device 1 still queued. Recovery runs on a
    1-device topology: the journal's placement records show device 1 is
    gone, the lane-resident work is remapped audibly
    (``serve.placement.remapped`` + a ``placement_remapped`` flight
    point), the pinned request gets a typed ``placement`` error — and
    the merged ledger still closes with zero lost."""
    from poisson_tpu_torch.serve import (
        FleetPolicy,
        RetryPolicy,
        SolveJournal,
        SolveRequest,
        replay_journal,
    )
    from poisson_tpu_torch.testing.faults import device_loss_fault

    p = _problem()
    with tempfile.TemporaryDirectory(prefix="poisson-topology-") as td:
        path = os.path.join(td, "serve.journal")
        vc = VirtualClock()
        retry = RetryPolicy(max_attempts=4, backoff_base=0.01,
                            backoff_cap=0.05)
        policy_a = _continuous_policy(
            capacity=16, max_batch=2, refill_chunk=10, retry=retry,
            fleet=FleetPolicy(workers=1, devices=2,
                              quarantine_seconds=0.02,
                              recovery_backoff=0.02))
        holder: dict = {}
        journal_a = SolveJournal(path, clock=vc)
        svc_a = _service(
            policy_a, clock=vc, sleep=vc.sleep, seed=seed,
            journal=journal_a,
            worker_fault=device_loss_fault(
                {0}, lambda wid: holder["svc"].worker_device(wid)))
        holder["svc"] = svc_a
        for i in range(3):
            svc_a.submit(SolveRequest(request_id=f"t{i}", problem=p,
                                      rhs_gate=1.0 + i / 10))
        # Run past the device loss until the rebound worker (now on
        # device 1) has finished one request and respliced the rest.
        while len(svc_a.outcomes()) < 1:
            svc_a.pump()
        svc_a.pump()
        lost_in_phase_a = _counter("serve.fleet.device_losses")
        # A request pinned to device 1 — alive NOW, gone after the
        # crash: the recovery topology has only device 0.
        svc_a.submit(SolveRequest(request_id="pinned", problem=p,
                                  device_id=1))
        journal_a.close()                 # the process "dies" here
        replay_probe = replay_journal(path)
        in_flight = [pend for pend in replay_probe.pending
                     if pend.in_flight]
        policy_b = _continuous_policy(
            capacity=16, max_batch=2, refill_chunk=10, retry=retry,
            fleet=FleetPolicy(workers=1, devices=1,
                              quarantine_seconds=0.02,
                              recovery_backoff=0.02))
        journal_b = SolveJournal(path, clock=vc)
        svc_b = _recover(journal_b, policy_b, clock=vc,
                                     sleep=vc.sleep, seed=seed)
        svc_b.drain()
        # outcomes() rather than drain()'s return: the unmappable pin
        # is typed DURING recovery, before the first pump.
        outs = {o.request_id: o for o in svc_b.outcomes()}
        stats_b = svc_b.stats()
        journal_b.close()
        final = replay_journal(path)
    survivors = [rid for rid in outs if rid != "pinned"]
    return _finish("recover-on-smaller-topology", seed, {
        "device_lost_before_crash": lost_in_phase_a == 1
        and _counter("serve.placement.rebinds") >= 1,
        "journal_recorded_the_placement": len(in_flight) >= 1
        and all(pend.device_id == 1 for pend in in_flight)
        and replay_probe.topology is not None
        and replay_probe.topology["devices"] == 2,
        "remapped_audibly_not_silently":
            _counter("serve.placement.remapped") >= 1,
        "survivors_converged_on_new_topology":
            len(survivors) >= 1
            and all(outs[rid].converged for rid in survivors),
        "unmappable_pin_typed_not_wedged":
            outs["pinned"].kind == "error"
            and outs["pinned"].error_type == "placement",
        "merged_ledger_closed": stats_b["lost"] == 0
        and not final.pending,
    }, {"in_flight_devices": [pend.device_id for pend in in_flight],
        "outcomes": {str(k): v.kind for k, v in outs.items()},
        "recovered": stats_b["recovered"]})


@scenario("deflation-stale-basis", group="krylov")
def _deflation_stale_basis(seed: int) -> dict:
    """Solver memory gone stale (``poisson_tpu_torch.krylov.recycle``): the
    cached deflation basis for a repeat fingerprint F is POISONED
    mid-run (NaN overwrite — the silent-staleness shape) and later
    EVICTED outright. Warm requests against F must fall back to a cold
    solve with a typed audible event (``krylov.fallbacks`` +
    ``krylov.invalidate``), never a wrong answer: every outcome is a
    converged result whose iterate the deflated recurrence maintained
    against the TRUE operator, and the rebuilt basis serves the tail of
    the traffic warm again. The ledger invariant closes from the
    emitted snapshot like every scenario."""
    from poisson_tpu_torch.geometry import Ellipse
    from poisson_tpu_torch.krylov import KrylovPolicy
    from poisson_tpu_torch.krylov.recycle import (
        cache_stats,
        has_basis,
        invalidate,
        poison_basis,
    )
    from poisson_tpu_torch.serve import (
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
    )

    fam = Ellipse(cx=0.12, cy=-0.04, rx=0.62, ry=0.33)   # fingerprint F
    kp = KrylovPolicy(deflation=True)
    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=16,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            degradation=_quiet_degradation(),
            krylov=kp,
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    p = _problem()

    def run(rid, gate):
        svc.submit(SolveRequest(request_id=rid, problem=p, geometry=fam,
                                rhs_gate=gate))
        return svc.drain()[-1]

    cold = run("cold", 1.0)                 # miss → harvest
    warm = run("warm", 1.3)                 # hit → deflated warm solve
    harvested = has_basis(p, geometry=fam, policy=kp, device=_DEVICE)
    warm_won = warm.iterations < cold.iterations

    poisoned = poison_basis()               # NaN the cached basis
    after_poison = run("stale", 0.8)        # warm attempt → fallback
    fallback_fired = _counter("krylov.fallbacks") >= 1
    rebuilt = has_basis(p, geometry=fam, policy=kp, device=_DEVICE)
    rewarm = run("rewarm", 1.1)             # rebuilt basis serves warm

    evicted = invalidate(fingerprint=fam.fingerprint,
                         reason="chaos-eviction")
    after_evict = run("evicted", 1.2)       # cold again, audibly
    tail = run("tail", 0.9)                 # … and warm again

    outs = [cold, warm, after_poison, rewarm, after_evict, tail]
    return _finish("deflation-stale-basis", seed, {
        "cold_solve_harvested_a_basis": harvested
        and _counter("krylov.harvests") >= 1,
        "warm_start_beat_cold": bool(warm_won),
        "poisoned_basis_fell_back_audibly": poisoned == 1
        and fallback_fired
        and _counter("krylov.cache.invalidations") >= 1,
        "fallback_rebuilt_the_basis": rebuilt
        and rewarm.iterations < cold.iterations,
        "eviction_fell_back_to_cold": evicted == 1
        and after_evict.iterations >= cold.iterations - 2,
        "tail_served_warm_again": tail.iterations < cold.iterations,
        "never_a_wrong_answer": all(
            o.kind == "result" and o.converged for o in outs),
        "ledger_closed": svc.stats()["lost"] == 0,
    }, {"iterations": {o.request_id: o.iterations for o in outs},
        "cache": cache_stats(),
        "iterations_saved": _counter("krylov.iterations_saved")})


@scenario("session-kill-recover-subprocess", group="session")
def _session_kill_recover_subprocess(seed: int) -> dict:
    """The session acceptance drill: kill ``python -m poisson_tpu_torch
    session`` mid-dispatch of step 3 (exit 75 — the step's submit is in
    the journal, its outcome is not), restart with ``--recover``, and
    assert from the two emitted metrics snapshots plus the journal that
    the merged ledger closes across the kill with zero lost and zero
    duplicated steps, the stream re-opened at the exact committed
    boundary, and the recovered process finished the schedule COLD for
    the mid-step work (warm iterates never cross a crash)."""
    import subprocess
    import sys

    from poisson_tpu_torch.serve.journal import replay_journal, replay_sessions

    with tempfile.TemporaryDirectory(prefix="poisson-session-") as td:
        journal = os.path.join(td, "session.journal")
        a_metrics = os.path.join(td, "metrics-a.json")
        b_metrics = os.path.join(td, "metrics-b.json")
        env = _child_env()
        base = [sys.executable, "-m", "poisson_tpu_torch", "session",
                "40", "40", "--steps", "6", "--journal", journal,
                "--seed", str(seed), "--json", "--device", _device_arg()]
        phase_a = subprocess.run(
            base + ["--kill-after", "3", "--metrics-out", a_metrics],
            capture_output=True, text=True, timeout=240, env=env)
        phase_b = subprocess.run(
            base + ["--recover", "--metrics-out", b_metrics],
            capture_output=True, text=True, timeout=240, env=env)

        def counters(path):
            try:
                with open(path) as fh:
                    return json.load(fh).get("counters", {})
            except (OSError, ValueError):
                return {}

        ca, cb = counters(a_metrics), counters(b_metrics)

        def terminated(c):
            return (c.get("serve.completed", 0) + c.get("serve.errors", 0)
                    + c.get("serve.shed", 0))

        # Root + 6 steps = 7 admissions across both lives.
        admitted = ca.get("serve.admitted", 0) + cb.get("serve.admitted", 0)
        done = terminated(ca) + terminated(cb)
        final = replay_journal(journal)
        srep = replay_sessions(journal).get("cli")
        step_ids = [f"cli#{k:04d}" for k in range(6)]
        detail = {
            "phase_a_rc": phase_a.returncode,
            "phase_b_rc": phase_b.returncode,
            "admitted": admitted, "terminated": done,
            "terminated_before_kill": terminated(ca),
            "recovered": cb.get("serve.recovered", 0),
            "warm_hits_a": ca.get("session.warm.hits", 0),
            "warm_hits_b": cb.get("session.warm.hits", 0),
            "stderr_tail_a": phase_a.stderr.strip()[-300:],
            "stderr_tail_b": phase_b.stderr.strip()[-300:],
        }
    return _finish("session-kill-recover-subprocess", seed, {
        "phase_a_died_mid_step": phase_a.returncode == 75
        and terminated(ca) < 7,
        "phase_b_recovered_cleanly": phase_b.returncode == 0,
        "invariant_closes_across_kill": admitted == 7
        and admitted - done == 0,
        "zero_lost_steps": sorted(final.outcomes) == step_ids
        and not final.pending,
        "zero_duplicated_steps": not final.duplicate_outcomes,
        "mid_step_recovered_not_readmitted":
            cb.get("serve.recovered", 0) == 1
            and cb.get("session.recovered", 0) == 1,
        "stream_closed_at_boundary": srep is not None and srep.closed
        and srep.last_advanced == 5 and srep.generations == 2,
    }, detail)


@scenario("session-stale-warm-start", group="session")
def _session_stale_warm_start(seed: int) -> dict:
    """A geometry JUMP mid-stream (far past the drift bound): the warm
    validity gate must refuse the previous iterate AUDIBLY and run the
    step cold — converging fast against the wrong operator is the
    failure this gate exists to prevent — then warm starts resume once
    consecutive steps are nearby again. Covers the SessionPolicy warm
    knobs (drift bound + residual factor) under chaos."""
    from poisson_tpu_torch.geometry.dsl import Ellipse
    from poisson_tpu_torch.serve import (
        ServicePolicy,
        SessionHost,
        SessionPolicy,
    )

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(
            capacity=16,
            degradation=_quiet_degradation(),
            session=SessionPolicy(warm_drift_bound=0.05,
                                  warm_residual_factor=100.0,
                                  slo_seconds=60.0),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
    )
    host = SessionHost(svc)
    p = _problem()
    sess = host.open("jump", p, geometry=Ellipse())
    near = [host.step(sess, geometry=Ellipse(cx=5e-4 * k, cy=0.0,
                                             rx=1.0, ry=1.0))
            for k in range(3)]
    hits_before = _counter("session.warm.hits")
    # The jump: 0.4 of center drift against a 0.05 bound.
    jumped = host.step(sess, geometry=Ellipse(cx=0.4, cy=0.0,
                                              rx=0.8, ry=1.0))
    fallbacks = _counter("session.warm.fallbacks")
    # Settled again: the next step is nearby, warm starts resume.
    settled = host.step(sess, geometry=Ellipse(cx=0.4005, cy=0.0,
                                               rx=0.8, ry=1.0))
    summary = host.close(sess)
    return _finish("session-stale-warm-start", seed, {
        "warm_starts_held_while_nearby": hits_before >= 2
        and all(o.converged for o in near),
        "stale_warm_fell_back_audibly": fallbacks == 1
        and jumped.converged,
        "cold_fallback_paid_full_iterations":
            jumped.iterations > max(o.iterations for o in near[1:]),
        "warm_resumed_after_jump":
            _counter("session.warm.hits") == hits_before + 1
            and settled.converged,
        "stream_closed_good": summary["slo_good"]
        and summary["errors"] == 0,
    }, {"iterations": [o.iterations for o in near]
        + [jumped.iterations, settled.iterations],
        "fallbacks": fallbacks})


@scenario("session-device-loss-reroute", group="session")
def _session_device_loss_reroute(seed: int) -> dict:
    """A device dies while a session step is resident on it: the fault
    domain is marked lost, the step is recovered onto the survivor
    (retry, typed outcome), and the STREAM continues — later steps
    dispatch on the surviving device, warm starts intact, the session
    closing with its one typed outcome. A half-finished stream must
    survive silicon loss like any request."""
    from poisson_tpu_torch.geometry.dsl import Ellipse
    from poisson_tpu_torch.serve import (
        FleetPolicy,
        RetryPolicy,
        ServicePolicy,
        SessionHost,
        SolveRequest,
    )
    from poisson_tpu_torch.testing.faults import device_loss_fault

    vc = VirtualClock()
    holder: dict = {}
    svc = _service(
        ServicePolicy(
            capacity=16,
            retry=RetryPolicy(max_attempts=3, backoff_base=0.05,
                              backoff_cap=0.1),
            degradation=_quiet_degradation(),
            fleet=FleetPolicy(workers=2, devices=2,
                              quarantine_seconds=0.02,
                              recovery_backoff=0.05),
        ),
        clock=vc, sleep=vc.sleep, seed=seed,
        worker_fault=device_loss_fault(
            {0}, lambda wid: holder["svc"].worker_device(wid)),
    )
    holder["svc"] = svc
    host = SessionHost(svc)
    p = _problem()
    sess = host.open("loss", p, geometry=Ellipse())
    outs = [host.step(sess, geometry=Ellipse(cx=5e-4 * k, cy=0.0,
                                             rx=1.0, ry=1.0))
            for k in range(4)]
    summary = host.close(sess)
    stats = svc.stats()
    placement = stats["placement"]
    return _finish("session-device-loss-reroute", seed, {
        "device_loss_counted":
            _counter("serve.fleet.device_losses") == 1,
        "step_recovered_onto_survivor":
            _counter("serve.fleet.recovered_requests") >= 1
            and outs[0].converged and outs[0].attempts == 2,
        "stream_finished_on_survivor": all(o.converged for o in outs)
        and set(placement["bindings"].values()) == {1},
        "warm_starts_survived_reroute":
            _counter("session.warm.hits") >= 2,
        "stream_closed_good": summary["errors"] == 0
        and summary["slo_good"],
    }, {"attempts": [o.attempts for o in outs],
        "iterations": [o.iterations for o in outs],
        "placement": placement})


@scenario("forecast-predicted-shed", group="forecast")
def _forecast_predicted_shed(seed: int) -> dict:
    """A deadline the calibrated forecaster already prices as hopeless
    is shed AT ADMISSION — typed ``predicted_deadline``, zero compute
    burned (counter-asserted from the outcome's decomposition) — while
    a feasible deadline on the same warm cohort still admits and
    completes. The admission guard must neither burn a dispatch on
    work it predicted dead nor replace viable work with false sheds,
    and the ledger must close around both."""
    from poisson_tpu_torch.serve import (
        ForecastPolicy,
        OUTCOME_SHED,
        ServicePolicy,
        SHED_PREDICTED_DEADLINE,
        SolveRequest,
    )

    vc = VirtualClock()
    svc = _service(
        ServicePolicy(capacity=32, degradation=_quiet_degradation(),
                      forecast=ForecastPolicy()),
        clock=vc, sleep=vc.sleep, seed=seed)
    p = _problem()
    # Warm the cohort model: four identical solves calibrate the
    # iteration quantiles (the VirtualClock yields no measured wall, so
    # the ETA prices with the analytic per-iteration cost model —
    # deterministic by construction).
    for k in range(4):
        svc.submit(SolveRequest(request_id=f"warm-{k}", problem=p))
    warm = svc.drain()
    doomed = svc.submit(SolveRequest(request_id="doomed", problem=p,
                                     deadline_seconds=1e-7))
    feasible = svc.submit(SolveRequest(request_id="feasible", problem=p,
                                       deadline_seconds=3600.0))
    done = svc.drain()
    d = (doomed.decomposition or {}) if doomed is not None else {}
    return _finish("forecast-predicted-shed", seed, {
        "warm_cohort_calibrated": all(o.converged for o in warm)
        and _counter("obs.forecast.predictions") >= 4,
        "doomed_shed_at_admission": doomed is not None
        and doomed.kind == OUTCOME_SHED
        and doomed.shed_reason == SHED_PREDICTED_DEADLINE,
        "typed_shed_counted":
            _counter("serve.shed.predicted_deadline") == 1,
        "zero_compute_burned": d.get("compute_s", 1) == 0
        and d.get("dispatches", 1) == 0 and d.get("iterations", 1) == 0,
        "feasible_twin_still_served": feasible is None
        and any(o.request_id == "feasible" and o.converged
                for o in done),
        "admission_checks_counted":
            _counter("serve.forecast.admission_checks") == 2,
    }, {"iterations": [int(o.iterations) for o in warm],
        "shed_message": (doomed.message if doomed is not None else None),
        "predictions": int(_counter("obs.forecast.predictions"))})


@scenario("router-mispredict-downshift", group="router")
def _router_mispredict_downshift(seed: int) -> dict:
    """The backend router's misprediction sentinel end to end: the
    cold analytic model routes a grid kernel R admits to the resident arm,
    an injected slow dispatch lands far below the predicted roofline
    fraction → typed misprediction + (backend, device) demotion,
    traffic downshifts to the torch floor arm with zero lost requests,
    and after the cooldown a half-open re-probe measures healthy and
    recovers the arm. The run must span ≥2 distinct backends and the
    ledger must close."""
    from poisson_tpu_torch.obs.costs import platform_peak_gbps
    from poisson_tpu_torch.obs.forecast import DEFAULT_COLD_GBPS
    from poisson_tpu_torch.serve import (
        RouterPolicy,
        ServicePolicy,
        SolveRequest,
    )
    from poisson_tpu_torch.utils.platform import device_name, resolve_device

    vc = VirtualClock()
    ticks = {"n": 0}
    # The dispatch times are virtual, so the bandwidth they give is too:
    # the healthy tick is 50 µs on the unknown host's ceiling, scaled to
    # the harness device's own, so it grades at the same roofline fraction
    # on every device.
    peak = (platform_peak_gbps(device_name(resolve_device(_DEVICE)))
            or DEFAULT_COLD_GBPS)
    healthy = 5e-5 * (DEFAULT_COLD_GBPS / peak)

    def slow_first_dispatch(requests, attempts):
        # Dispatch #1 (routed to the resident arm by the cold model)
        # burns 1.0 virtual seconds — achieved GB/s collapses below
        # the misprediction threshold. Every later dispatch runs at the
        # healthy tick.
        ticks["n"] += 1
        vc.advance(1.0 if ticks["n"] == 1 else healthy)

    svc = _service(
        ServicePolicy(
            capacity=32, degradation=_quiet_degradation(),
            router=RouterPolicy(
                assume_available=("resident",),
                misprediction_fraction=0.5, demote_after=1,
                cooldown_seconds=0.05, warm_min_samples=3)),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=slow_first_dispatch)
    p = _problem()
    outs = []
    # One request per drain → one graded dispatch each: slow resident,
    # then three on the demoted arm's torch fallback.
    for k in range(4):
        svc.submit(SolveRequest(request_id=f"r{k}", problem=p))
        outs.extend(svc.drain())
    vc.advance(0.06)  # past the demoted arm's cooldown
    svc.submit(SolveRequest(request_id="probe", problem=p))
    outs.extend(svc.drain())
    st = svc.stats()["router"]
    return _finish("router-mispredict-downshift", seed, {
        "cold_route_chose_model_arm":
            st["chosen"].get("resident", 0) >= 1,
        "slow_arm_drew_misprediction":
            _counter("serve.router.mispredictions") >= 1,
        "demoted_exactly_once":
            _counter("serve.router.demotions") == 1,
        "half_open_reprobe_fired":
            _counter("serve.router.half_opens") >= 1,
        "healthy_probe_recovered":
            _counter("serve.router.recoveries") >= 1
            and not st["demoted_arms"],
        "traffic_spanned_backends": len(st["chosen"]) >= 2
        and st["chosen"].get("torch", 0) >= 1,
        "roofline_measured":
            _counter("obs.roofline.observations") >= 4,
        "all_served": len(outs) == 5
        and all(o.converged for o in outs),
    }, {"chosen": st["chosen"],
        "demoted_arms": st["demoted_arms"],
        "measured_fractions": st["measured_fractions"]})


def _tenant_arm(seed, tenancy, victim_n, aggressor_n, deadline):
    """One arm of the noisy-neighbor experiment: the victim submits
    ``victim_n`` requests and the aggressor floods ``aggressor_n`` into
    the same queue (same seed → same order), every dispatch burning a
    fixed slice of virtual time. Returns (per-tenant outcome lists,
    admission sheds by tenant, service)."""
    from poisson_tpu_torch.serve import (
        ServicePolicy,
        SolveRequest,
    )

    vc = VirtualClock()

    def metered_dispatch(requests, attempts):
        vc.advance(0.05)        # every dispatch costs one queue slice

    svc = _service(
        ServicePolicy(capacity=64, max_batch=1, tenancy=tenancy,
                      degradation=_quiet_degradation()),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=metered_dispatch)
    p = _problem()
    rng = random.Random(seed)
    shed_at_admission = {"victim": [], "aggressor": []}
    # The flood lands first — FIFO puts every aggressor request ahead
    # of the victim, which is exactly the starvation the fair queue
    # must undo.
    plan = ([("aggressor", k) for k in range(aggressor_n)]
            + [("victim", k) for k in range(victim_n)])
    for tenant, k in plan:
        out = svc.submit(SolveRequest(
            request_id=f"{tenant}-{k}", problem=p, tenant=tenant,
            deadline_seconds=deadline, rhs_gate=1.0 + rng.random()))
        if out is not None:
            shed_at_admission[tenant].append(out)
    outs = {"victim": [], "aggressor": []}
    for o in svc.drain():
        outs[str(o.request_id).split("-")[0]].append(o)
    return outs, shed_at_admission, svc


@scenario("tenant-noisy-neighbor", group="tenancy")
def _tenant_noisy_neighbor(seed: int) -> dict:
    """Weighted-fair admission end to end, both arms in one scenario.
    With tenancy ON, an aggressor flooding at 10× its quota share is
    refused at admission — typed ``quota_exceeded`` sheds that burn
    zero compute — and the victim's completed count and p99 stay
    within 10% of its solo baseline. With tenancy OFF, the *same*
    seeded schedule demonstrably starves the victim: FIFO drains the
    flood first and the victim's deadlines expire in queue. All three
    arms share one metrics registry (every arm drains fully, so the
    ledger invariant closes over their sum — and the campaign's
    flight-recorder rail counts every arm's causal traces against it);
    the ``serve.tenant.*`` counters still read as the tenancy-on
    arm's alone, because the off arms have no ledger to tick them."""
    from poisson_tpu_torch.serve import (
        OUTCOME_SHED,
        SHED_QUOTA_EXCEEDED,
        TenancyPolicy,
    )

    victim_n, deadline = 20, 1.2
    # Aggressor bucket = quota_burst × share = 1 token: its fair
    # admission is ONE request, and it floods ten.
    tenancy = TenancyPolicy(shares=(("victim", 20.0), ("aggressor", 1.0)),
                            quota_rate=1e-3, quota_burst=1.0)

    # Arm 1 — solo baseline: the victim alone on the same schedule.
    solo, _, _ = _tenant_arm(seed, None, victim_n, 0, deadline)
    solo_done = [o for o in solo["victim"] if o.converged]
    solo_p99 = float(np.percentile(
        [o.latency_seconds for o in solo_done], 99))

    # Arm 2 — tenancy OFF under the flood: FIFO starves the victim.
    off, _, _ = _tenant_arm(seed, None, victim_n, 10, deadline)
    off_done = [o for o in off["victim"] if o.converged]

    # Arm 3 — tenancy ON, same seeded schedule.
    on, shed, svc = _tenant_arm(seed, tenancy, victim_n, 10, deadline)
    on_done = [o for o in on["victim"] if o.converged]
    on_p99 = float(np.percentile(
        [o.latency_seconds for o in on_done], 99)) if on_done else 1e9
    quota_sheds = shed["aggressor"]
    return _finish("tenant-noisy-neighbor", seed, {
        "solo_baseline_all_served": len(solo_done) == victim_n,
        "off_arm_starves_victim": len(off_done) < victim_n,
        "on_arm_victim_all_served": len(on_done) == victim_n
        and len(on_done) == len(solo_done),
        "on_arm_victim_p99_within_10pct": on_p99 <= 1.10 * solo_p99,
        "aggressor_shed_typed_quota": len(quota_sheds) >= 8
        and all(o.kind == OUTCOME_SHED
                and o.shed_reason == SHED_QUOTA_EXCEEDED
                for o in quota_sheds),
        "quota_sheds_burned_zero_compute": all(
            (o.decomposition or {}).get("compute_s", 1) == 0
            and (o.decomposition or {}).get("dispatches", 1) == 0
            for o in quota_sheds),
        "quota_sheds_counted":
            _counter("serve.tenant.quota_sheds") == len(quota_sheds)
            and _counter("serve.shed.quota_exceeded") == len(quota_sheds),
        "aggressor_admitted_its_share":
            _counter("serve.tenant.dispatches.aggressor") >= 1,
    }, {"solo_p99": solo_p99, "on_p99": on_p99,
        "off_victim_completed": len(off_done),
        "on_victim_completed": len(on_done),
        "aggressor_quota_sheds": len(quota_sheds)})


@scenario("tenant-retry-storm", group="tenancy")
def _tenant_retry_storm(seed: int) -> dict:
    """Per-tenant retry budgets cap requeue amplification. A tenant
    whose every request is poison (batch-killing) spends its retry
    budget and then its retries convert into typed errors instead of
    requeues: total dispatches for the poisoned tenant are bounded by
    ``admitted + retry_budget``, asserted from the emitted metrics
    snapshot. The steady tenant's outcomes are untouched, and co-batch
    taint is still honored ACROSS tenants — a steady member killed as
    the poison's batchmate is requeued isolated and converges. The
    breaker is quieted (it would otherwise shed the poisoned cohort
    before the budget engages — this scenario is about the budget)."""
    from poisson_tpu_torch.serve import (
        BreakerPolicy,
        OUTCOME_ERROR,
        RetryPolicy,
        ServicePolicy,
        SolveRequest,
        TenancyPolicy,
    )
    from poisson_tpu_torch.testing.faults import poison_batch_fault

    retry_budget = 3
    vc = VirtualClock()
    poison_ids = {f"poison-{k}" for k in range(2)}
    svc = _service(
        ServicePolicy(
            capacity=32, max_batch=2,
            retry=RetryPolicy(max_attempts=50, backoff_base=0.01,
                              backoff_cap=0.05),
            breaker=BreakerPolicy(failure_threshold=10**6),
            degradation=_quiet_degradation(),
            # Default retry_refund (1.0): the steady tenant's budget is
            # replenished by its successes, so collateral kills from
            # co-batched poison never exhaust it — while the poison
            # tenant, which never completes anything, earns no refunds
            # and hits the cap.
            tenancy=TenancyPolicy(retry_budget=retry_budget)),
        clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=poison_batch_fault(poison_ids))
    p = _problem()
    rng = random.Random(seed)
    # Interleave so the first batches co-mingle the tenants: the taint
    # seam must isolate across the tenant boundary too. The steady
    # tenant absorbs two collateral kills — within its own budget, and
    # its completions refund the spend (retries paced by successes),
    # so only the tenant that never succeeds runs dry.
    plan = [("poison", 0), ("steady", 0), ("poison", 1),
            ("steady", 1), ("steady", 2), ("steady", 3)]
    for tenant, k in plan:
        svc.submit(SolveRequest(request_id=f"{tenant}-{k}", problem=p,
                                tenant=tenant,
                                rhs_gate=1.0 + rng.random()))
    outs = {o.request_id: o for o in svc.drain()}
    poison_outs = [outs[f"poison-{k}"] for k in range(2)]
    steady_outs = [outs[f"steady-{k}"] for k in range(4)]
    dispatches = _counter("serve.tenant.dispatches.poison")
    admitted = _counter("serve.tenant.admitted.poison")
    return _finish("tenant-retry-storm", seed, {
        "requeue_amplification_capped":
            0 < dispatches <= admitted + retry_budget,
        "budget_exhaustion_typed":
            _counter("serve.tenant.retry_exhausted") >= 1
            and all(o.kind == OUTCOME_ERROR and o.error_type == "transient"
                    for o in poison_outs),
        "exhaustion_audible_in_message": any(
            "retry budget exhausted" in (o.message or "")
            for o in poison_outs),
        "steady_tenant_untouched":
            all(o.converged for o in steady_outs)
            and _counter("serve.tenant.completed.steady") == 4
            and _counter("serve.tenant.errors.steady") == 0,
        "cross_tenant_taint_honored":
            _counter("serve.requeued.isolated") >= 1
            and any(o.attempts > 1 for o in steady_outs),
    }, {"poison_dispatches": dispatches,
        "poison_admitted": admitted,
        "retry_budget": retry_budget,
        "steady_attempts": [o.attempts for o in steady_outs]})


# -- campaign runner ----------------------------------------------------


def run_scenario(name: str, seed: int = 0, device=None) -> dict:
    """Run one scenario from a clean metrics registry on ``device``
    (None: the CUDA card; ``"cpu"``: the CPU); returns its JSON-ready
    report (``report['ok']`` is the verdict)."""
    global _DEVICE
    if name not in _SCENARIOS:
        raise KeyError(
            f"unknown chaos scenario {name!r}; known: "
            f"{', '.join(sorted(_SCENARIOS))}"
        )
    _reset_registries()
    _DEVICE = device
    try:
        return _SCENARIOS[name](seed)
    finally:
        _DEVICE = None


def run_campaign(names=None, seed: int = 0, out_dir=None,
                 device=None) -> dict:
    """Run the named scenarios (default: all, in registration order).
    ``out_dir`` keeps one metrics snapshot (JSON + Prometheus text) per
    scenario plus the campaign report. Deterministic under a fixed seed.
    """
    from poisson_tpu_torch.obs import export

    names = list(names) if names else scenario_names()
    reports = []
    for name in names:
        report = run_scenario(name, seed=seed, device=device)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            snap = report["metrics_snapshot"]
            with open(os.path.join(out_dir,
                                   f"metrics-{name}.json"), "w") as f:
                json.dump(snap, f, sort_keys=True, indent=1, default=str)
            export.write_textfile(
                os.path.join(out_dir, f"metrics-{name}.prom"), snap)
        reports.append(report)
    campaign = {
        "schema": "poisson_tpu.chaos/1",
        "seed": seed,
        "scenarios": [{k: v for k, v in r.items()
                       if k != "metrics_snapshot"} for r in reports],
        "ok": all(r["ok"] for r in reports),
    }
    if out_dir:
        with open(os.path.join(out_dir, "campaign.json"), "w") as f:
            json.dump(campaign, f, sort_keys=True, indent=1, default=str)
    return campaign
