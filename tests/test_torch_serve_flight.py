"""The port's request flight recorder (counterpart of
``tests/test_flight.py``, on the CPU; -m serve): per-request causal traces,
latency decomposition and SLO accounting.

- every admitted request, across both engines and the chaos scenarios,
  yields a complete causal trace from the emitted JSONL (one admit root,
  one typed outcome leaf, no orphan spans);
- the latency decomposition's components sum to the measured wall;
- the JSONL readers keep loading the older flat (v1) lines, and reserved
  key collisions ride the attrs block;
- SLO accounting: good/bad scoring, the histogram through Prometheus
  exposition, multi-window burn rates, the opt-in SLO degradation rung;
- with tracing on the solves are bit for bit unchanged (lane hook,
  golden counts);
- the serve CLI's record carries the p99 exemplar and the slowest
  requests' decompositions.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import flight, metrics
from poisson_tpu_torch.obs.costs import apportion_compute
from poisson_tpu_torch.obs.trace import load_events, merge_trace_dir
from poisson_tpu_torch.testing.chaos import VirtualClock

pytestmark = [pytest.mark.serve, pytest.mark.flight]

PROBLEM = Problem(M=32, N=32)


@pytest.fixture(autouse=True)
def _clean_telemetry():
    obs.shutdown()
    metrics.reset()
    yield
    obs.shutdown()
    metrics.reset()


def _sum_parts(d: dict) -> float:
    return (d["queue_s"] + d["compute_s"] + d["lane_wait_s"]
            + d["backoff_s"] + d["overhead_s"])


def _assert_decomposition(outcome):
    d = outcome.decomposition
    assert d is not None and outcome.trace_id
    assert abs(_sum_parts(d) - d["wall_s"]) <= max(1e-6, 1e-3 * d["wall_s"])
    for key in ("queue_s", "compute_s", "lane_wait_s", "backoff_s"):
        assert d[key] >= 0.0, (key, d)
    assert d["overhead_s"] >= -1e-6, d


# ---------------------------------------------------------------------------
# Recorder unit behavior
# ---------------------------------------------------------------------------


def test_recorder_decomposition_arithmetic():
    vc = VirtualClock()
    fr = flight.FlightRecorder(clock=vc)
    tid = fr.admit("r")
    assert tid
    fr.begin("r", flight.SPAN_QUEUE)
    vc.advance(0.2)
    fr.end("r", flight.SPAN_QUEUE)
    fr.begin("r", flight.SPAN_RESIDENT, dispatch="d1")
    vc.advance(1.0)
    fr.add_step("r", 1.0, 40, 0.6, "d1", k=40)
    fr.end("r", flight.SPAN_RESIDENT)
    fr.begin("r", flight.SPAN_BACKOFF)
    vc.advance(0.3)
    fr.end("r", flight.SPAN_BACKOFF)
    vc.advance(0.1)    # host machinery → overhead
    out = fr.outcome("r", kind="result", type_="converged")
    d = out["decomposition"]
    assert out["trace_id"] == tid
    assert d["queue_s"] == pytest.approx(0.2)
    assert d["compute_s"] == pytest.approx(0.6)
    assert d["lane_wait_s"] == pytest.approx(0.4)
    assert d["backoff_s"] == pytest.approx(0.3)
    assert d["overhead_s"] == pytest.approx(0.1)
    assert d["wall_s"] == pytest.approx(1.6)
    assert d["iterations"] == 40 and d["dispatches"] == 1
    # The trace is popped: a second outcome is a defensive no-op.
    assert fr.outcome("r", "result", "x")["decomposition"] is None


def test_outcome_closes_open_spans():
    """A request shed while queued still gets a complete tree — the
    open queue_wait folds into queue_s at the outcome."""
    vc = VirtualClock()
    fr = flight.FlightRecorder(clock=vc)
    fr.admit("s")
    fr.begin("s", flight.SPAN_QUEUE)
    vc.advance(0.7)
    d = fr.outcome("s", kind="shed", type_="deadline_expired")
    assert d["decomposition"]["queue_s"] == pytest.approx(0.7)
    assert d["decomposition"]["wall_s"] == pytest.approx(0.7)


def test_unknown_request_ids_are_noops():
    fr = flight.FlightRecorder(clock=VirtualClock())
    fr.begin("ghost", flight.SPAN_QUEUE)
    assert fr.end("ghost", flight.SPAN_QUEUE) == 0.0
    fr.add_step("ghost", 1.0, 5, 0.5, "d1")
    fr.point("ghost", "retry")
    assert fr.outcome("ghost", "x", "y")["trace_id"] == ""


def test_apportion_compute_shares():
    shares = apportion_compute(1.0, {"a": 30, "b": 20, "c": 0})
    assert shares["a"] == pytest.approx(0.6)
    assert shares["b"] == pytest.approx(0.4)
    assert shares["c"] == 0.0
    assert sum(shares.values()) == pytest.approx(1.0)
    # No iterations advanced (killed dispatch): nobody gets compute.
    assert apportion_compute(2.0, {"a": 0}) == {"a": 0.0}
    assert apportion_compute(2.0, {}) == {}


# ---------------------------------------------------------------------------
# SLO accounting
# ---------------------------------------------------------------------------


def test_histogram_cumulative_snapshot():
    h = flight.LatencyHistogram(buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 5.0):
        h.observe(v)
    snap = h.snapshot()
    assert snap["le"] == {"0.1": 1, "1": 3, "+Inf": 4}
    assert snap["count"] == 4
    assert snap["sum"] == pytest.approx(6.25)


def test_histogram_prometheus_round_trip():
    from poisson_tpu_torch.obs import export

    h = flight.LatencyHistogram()
    h.observe(0.3)
    h.observe(7.0)
    metrics.gauge("serve.slo.latency_seconds", h.snapshot())
    metrics.inc("serve.slo.good")
    parsed = export.parse_text(export.render())
    key = 'poisson_tpu_serve_slo_latency_seconds_bucket{le="0.5"}'
    assert parsed[key]["value"] == 1.0
    assert parsed[key]["type"] == "histogram"
    assert parsed['poisson_tpu_serve_slo_latency_seconds_bucket'
                  '{le="+Inf"}']["value"] == 2.0
    assert parsed["poisson_tpu_serve_slo_latency_seconds_count"][
        "value"] == 2.0
    assert parsed["poisson_tpu_serve_slo_latency_seconds_sum"][
        "value"] == pytest.approx(7.3)
    assert parsed["poisson_tpu_serve_slo_good"]["type"] == "counter"


def test_slo_tracker_burn_windows_and_budget():
    from poisson_tpu_torch.serve import SLOPolicy

    vc = VirtualClock()
    policy = SLOPolicy(latency_objective_seconds=1.0,
                       availability_target=0.9,
                       burn_windows=(10.0, 100.0))
    tr = flight.SLOTracker(policy, clock=vc)
    assert tr.budget_remaining() == 1.0
    for _ in range(8):
        tr.record(0.5, True)
        vc.advance(1.0)
    tr.record(2.0, False)
    vc.advance(1.0)
    tr.record(2.0, False)
    # Cumulative: 2 bad of 10 against a 0.1 budget → budget gone ×2.
    assert tr.budget_remaining() == pytest.approx(-1.0)
    # Short window (10s) holds the last ~10 samples → burn = 2/10/0.1.
    assert tr.burn_rate(10.0) == pytest.approx(2.0, rel=0.3)
    assert metrics.get("serve.slo.good") == 8
    assert metrics.get("serve.slo.bad") == 2
    snap = metrics.snapshot()["gauges"]
    assert "serve.slo.burn_rate.10s" in snap
    assert "serve.slo.burn_rate.100s" in snap
    assert snap["serve.slo.latency_seconds"]["count"] == 10
    # degrade_on_burn off (default): never asks for a rung.
    assert tr.degrade_level() == 0
    # A policy corner (no windows declared) must be a quiet 0, never an
    # exception out of telemetry into the dispatch loop.
    empty = flight.SLOTracker(
        SLOPolicy(burn_windows=(), degrade_on_burn=True), clock=vc)
    empty.record(0.1, False)
    assert empty.degrade_level() == 0


def test_slo_degrade_level_needs_every_window_burning():
    from poisson_tpu_torch.serve import SLOPolicy

    vc = VirtualClock()
    policy = SLOPolicy(availability_target=0.999,
                       burn_windows=(10.0, 1000.0),
                       degrade_on_burn=True,
                       burn_degrade_thresholds=(2.0, 6.0, 14.0))
    tr = flight.SLOTracker(policy, clock=vc)
    # A long good history, then a fresh burst of bad: the short window
    # burns hard, the long window dilutes it — multi-window rule.
    for _ in range(200):
        tr.record(0.1, True)
        vc.advance(4.0)
    level_calm = tr.degrade_level()
    for _ in range(6):
        tr.record(5.0, False)
        vc.advance(1.0)
    assert level_calm == 0
    # Long window: 6 bad / ~206 → burn ≈ 29; short window: all bad →
    # burn 1000. min ≈ 29 ≥ 14 → deepest rung.
    assert tr.degrade_level() == 3


# ---------------------------------------------------------------------------
# Service integration: decomposition property under both engines
# ---------------------------------------------------------------------------


def _service(scheduling, fault_advance=0.25, **kw):
    from poisson_tpu_torch.serve import DegradationPolicy, ServicePolicy, \
        SolveService

    vc = VirtualClock()
    kw.setdefault("degradation",
                  DegradationPolicy(shrink_padding_at=9.0,
                                    cap_iterations_at=9.0,
                                    downshift_precision_at=9.0))
    svc = SolveService(
        ServicePolicy(scheduling=scheduling, **kw),
        clock=vc, sleep=vc.sleep, seed=0,
        dispatch_fault=(lambda reqs, att: vc.advance(fault_advance))
        if fault_advance else None, device="cpu",
    )
    return svc, vc


@pytest.mark.parametrize("mode", ["drain", "continuous"])
def test_open_loop_decomposition_sums_to_wall(mode):
    """The property the whole decomposition stands on: for EVERY request
    of a seeded open-loop run — arrivals joining work already in flight
    — the components sum to the measured wall within tolerance, under
    both engines."""
    from poisson_tpu_torch.serve import SolveRequest

    svc, vc = _service(mode, max_batch=4, refill_chunk=10, capacity=32)
    rng_gates = [1.0 + i / 11 for i in range(9)]
    for i in range(3):
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                rhs_gate=rng_gates[i], dtype="float32"))
    svc.pump()
    svc.pump()                          # work is mid-flight
    for i in range(3, 9):               # open-loop joiners
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                rhs_gate=rng_gates[i], dtype="float32"))
    svc.drain()
    outs = svc.outcomes()        # incl. any completed by the pumps
    assert len(outs) == 9 and svc.stats()["lost"] == 0
    for o in outs:
        _assert_decomposition(o)
        assert o.decomposition["iterations"] > 0
    if mode == "continuous":
        assert all(o.decomposition["chunk_steps"] >= 2 for o in outs)


def test_chunk_step_compute_shares_sum_to_step_wall():
    """Within one shared chunk step, the members' compute shares sum to
    the step's measured wall — compute is apportioned, never invented."""
    from poisson_tpu_torch.serve import SolveRequest

    svc, vc = _service("continuous", fault_advance=0.3, max_batch=2,
                       refill_chunk=10)
    for i in range(2):
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                rhs_gate=1.0 + i / 10, dtype="float32"))
    outs = svc.drain()
    assert sum(o.decomposition["chunk_steps"] for o in outs) > 0
    # Every step advances the virtual clock by exactly 0.3, and a step's
    # wall is fully apportioned: each member's compute + lane_wait must
    # equal its residency — 0.3 × the chunk steps it rode.
    for o in outs:
        d = o.decomposition
        assert d["compute_s"] + d["lane_wait_s"] == pytest.approx(
            0.3 * d["chunk_steps"])


def test_retry_backoff_is_attributed():
    """A poison-retried request's decomposition shows its backoff; the
    victim's shows the residency it paid on the killed dispatch."""
    from poisson_tpu_torch.serve import RetryPolicy, SolveRequest
    from poisson_tpu_torch.testing.faults import poison_batch_fault

    from poisson_tpu_torch.serve import DegradationPolicy, ServicePolicy, \
        SolveService

    vc = VirtualClock()
    svc = SolveService(
        ServicePolicy(
            retry=RetryPolicy(max_attempts=3, backoff_base=0.01,
                              backoff_cap=0.05),
            degradation=DegradationPolicy(shrink_padding_at=9.0,
                                          cap_iterations_at=9.0,
                                          downshift_precision_at=9.0),
        ),
        clock=vc, sleep=vc.sleep, seed=0,
        dispatch_fault=poison_batch_fault({"poison"}), device="cpu",
    )
    svc.submit(SolveRequest(request_id="poison", problem=PROBLEM))
    svc.submit(SolveRequest(request_id="victim", problem=PROBLEM,
                            rhs_gate=1.1))
    outs = {o.request_id: o for o in svc.drain()}
    _assert_decomposition(outs["poison"])
    _assert_decomposition(outs["victim"])
    assert outs["poison"].kind == "error"
    assert outs["poison"].decomposition["backoff_s"] > 0
    assert outs["victim"].converged


def test_shed_at_admission_has_a_trace():
    from poisson_tpu_torch.serve import ServicePolicy, SolveRequest, \
        SolveService

    vc = VirtualClock()
    svc = SolveService(ServicePolicy(capacity=1), clock=vc,
                       sleep=vc.sleep, seed=0, device="cpu")
    assert svc.submit(SolveRequest(request_id=0, problem=PROBLEM)) is None
    shed = svc.submit(SolveRequest(request_id=1, problem=PROBLEM))
    assert shed is not None and shed.kind == "shed"
    assert shed.trace_id and shed.decomposition is not None
    svc.drain()


def test_slo_driven_degradation_engages_the_ladder():
    """With degrade_on_burn on and the burn over every window, the
    load level rises even though the queue is shallow — the iteration
    cap engages and the downshift is attributed to the SLO."""
    from poisson_tpu_torch.serve import (
        DegradationPolicy,
        RetryPolicy,
        ServicePolicy,
        SLOPolicy,
        SolveRequest,
        SolveService,
    )

    vc = VirtualClock()
    svc = SolveService(
        ServicePolicy(
            capacity=64,                 # queue never near thresholds
            degradation=DegradationPolicy(degraded_iteration_cap=10),
            retry=RetryPolicy(max_attempts=1),
            slo=SLOPolicy(latency_objective_seconds=0.05,
                          availability_target=0.999,
                          burn_windows=(5.0, 50.0),
                          degrade_on_burn=True,
                          burn_degrade_thresholds=(2.0, 6.0, 14.0)),
        ),
        clock=vc, sleep=vc.sleep, seed=0,
        # Every dispatch costs 0.2s — far over the 0.05s objective, so
        # every outcome is SLO-bad and the burn saturates both windows.
        dispatch_fault=lambda reqs, att: vc.advance(0.2), device="cpu",
    )
    for i in range(6):
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                dtype="float32"))
        svc.drain()
        vc.advance(0.1)
    assert metrics.get("serve.slo.bad") >= 1
    assert metrics.get("serve.degraded.slo_driven") >= 1
    assert metrics.get("serve.degraded.iteration_cap") >= 1
    outs = svc.outcomes()
    assert any(o.partial and o.iterations == 10 for o in outs)
    # Off by default: the same load with the default policy never
    # touches the ladder (pinned so chaos determinism cannot drift).
    metrics.reset()
    vc2 = VirtualClock()
    svc2 = SolveService(ServicePolicy(capacity=64), clock=vc2,
                        sleep=vc2.sleep, seed=0,
                        dispatch_fault=lambda r, a: vc2.advance(0.2), device="cpu")
    svc2.submit(SolveRequest(request_id=0, problem=PROBLEM,
                             dtype="float32"))
    svc2.drain()
    assert metrics.get("serve.degraded.slo_driven") == 0


# ---------------------------------------------------------------------------
# JSONL: schema bump, loader tolerance, completeness from the file
# ---------------------------------------------------------------------------


def test_events_attrs_passthrough_and_reserved_keys(tmp_path):
    """The v1 silent-drop bug, fixed: a caller field shadowing a
    reserved envelope key survives in the attrs block, and request
    attribution rides every flight record."""
    rec = obs.configure(trace_dir=str(tmp_path))
    obs.event("flight.outcome", trace_id="t1", request_id="r1",
              kind="result", rank="shadowed")
    obs.finalize()
    records = load_events(str(tmp_path))
    (ev,) = [r for r in records if r["name"] == "flight.outcome"]
    assert ev["schema"] == 2
    assert ev["kind"] == "event"                 # envelope wins flat
    assert ev["attrs"]["kind"] == "result"       # caller field preserved
    assert ev["attrs"]["rank"] == "shadowed"
    assert ev["rank"] == rec.rank                # envelope rank intact
    assert ev["trace_id"] == "t1" and ev["request_id"] == "r1"


def test_load_events_tolerates_v1_lines(tmp_path):
    """Committed older artifact shapes (flat v1 lines) load next to v2
    lines through the same reader."""
    v1_span = {"at_unix": 1.0, "at_mono": 1.0, "rank": 0,
               "kind": "span_end", "name": "solve",
               "seconds": 0.5, "span_path": "solve"}
    v1_event = {"at_unix": 2.0, "at_mono": 2.0, "rank": 0,
                "kind": "event", "name": "solve.report",
                "M": 40, "N": 40, "iterations": 50, "mlups": 100.0}
    v2 = {"schema": 2, "at_unix": 3.0, "at_mono": 3.0, "rank": 0,
          "kind": "event", "name": "flight.admit",
          "attrs": {"trace_id": "t9", "request_id": "r9", "t": 0.0}}
    path = tmp_path / "events-rank0.jsonl"
    path.write_text("\n".join(json.dumps(r)
                              for r in (v1_span, v1_event, v2)) + "\n")
    records = load_events(str(tmp_path))
    assert [r["name"] for r in records] == ["solve", "solve.report",
                                           "flight.admit"]
    assert records[0]["seconds"] == 0.5          # v1 flat access intact
    assert records[1]["iterations"] == 50
    assert records[2]["trace_id"] == "t9"        # v2 flattened
    assert records[2]["attrs"]["trace_id"] == "t9"


def test_merge_trace_dir_tolerates_corrupt_rank_and_keeps_kinds(tmp_path):
    obs.configure(trace_dir=str(tmp_path), rank=0)
    with obs.span("phase", fence=False):
        obs.event("marker", k=1)
    obs.finalize()
    obs.shutdown()
    (tmp_path / "trace-rank7.trace.json").write_text("{torn")
    merged = merge_trace_dir(str(tmp_path))
    other = merged["otherData"]
    assert [s["file"] for s in other["skipped"]] == [
        "trace-rank7.trace.json"]
    # Both event kinds (span X + instant i) survive, tallied.
    assert other["event_kinds"].get("X", 0) >= 1
    assert other["event_kinds"].get("i", 0) >= 1


def test_service_trace_complete_from_jsonl(tmp_path):
    """End to end on the continuous engine: the causal tree is
    reconstructed and validated FROM THE EMITTED FILE, and the timeline
    renders every lifecycle stage."""
    from poisson_tpu_torch.serve import SolveRequest

    obs.configure(trace_dir=str(tmp_path))
    svc, vc = _service("continuous", max_batch=4, refill_chunk=10)
    svc.submit(SolveRequest(request_id="a", problem=PROBLEM,
                            dtype="float32"))
    svc.pump()
    svc.pump()
    svc.submit(SolveRequest(request_id="b", problem=PROBLEM,
                            rhs_gate=1.2, dtype="float32"))
    outs = {o.request_id: o for o in svc.drain()}
    obs.finalize()
    events = load_events(str(tmp_path))
    report = flight.validate_events(events)
    assert report["traces"] == 2
    assert report["complete"], report["problems"]
    tid, recs = flight.find_trace(events, request_id="b")
    assert tid == outs["b"].trace_id
    timeline = flight.render_timeline(recs)
    for needle in ("admit", "queue_wait", "lane_resident", "chunk_step",
                   "outcome result:converged", "decomposition"):
        assert needle in timeline, timeline


@pytest.mark.parametrize("name", [
    "overload-shed", "breaker-trip", "deadline-mid-chunk",
    "poison-requeue", "slow-worker", "queue-burst-degradation",
    "divergence-escalate", "preempt-typed-error",
    "corrupt-checkpoint-resume", "stall-watchdog",
    "refill-poison-splice", "refill-deadline-mid-splice",
    "refill-taint-across-splice", "refill-preempt-occupied",
])
def test_chaos_scenario_traces_are_complete(name, tmp_path):
    """Every one of the 14 chaos scenarios yields a complete,
    orphan-free span tree per admitted request — one admit root,
    exactly one typed outcome leaf, decomposition summing to wall —
    asserted from the emitted JSONL with a clean registry."""
    from poisson_tpu_torch.testing import chaos

    obs.configure(trace_dir=str(tmp_path))
    report = chaos.run_scenario(name, seed=0, device="cpu")
    assert report["ok"], report["checks"]
    obs.finalize()
    events = load_events(str(tmp_path))
    fr = flight.validate_events(events)
    assert fr["complete"], fr["problems"]
    admitted = report["metrics_snapshot"]["counters"].get(
        "serve.admitted", 0)
    assert fr["traces"] == admitted


# ---------------------------------------------------------------------------
# Bit-parity: tracing must never change solver behavior
# ---------------------------------------------------------------------------


def test_lane_boundary_hook_keeps_bit_parity():
    from poisson_tpu_torch.solvers.lanes import LaneBatch

    boundaries = []
    plain = LaneBatch(PROBLEM, bucket=2, dtype="float32", chunk=10, device="cpu")
    hooked = LaneBatch(PROBLEM, bucket=2, dtype="float32", chunk=10,
                       on_boundary=boundaries.append, device="cpu")
    results = {}
    for lb, key in ((plain, "plain"), (hooked, "hooked")):
        lb.splice("m", 1.3)
        for _ in range(20):
            lb.step()
            view = lb.lane_view()[0]
            if view["done"]:
                results[key] = lb.retire(0)
                break
    assert boundaries and boundaries[0] == {
        "step": 1, "active": 1, "idle": 1, "chunk": 10}
    assert results["plain"].iterations == results["hooked"].iterations
    assert np.array_equal(np.asarray(results["plain"].w),
                          np.asarray(results["hooked"].w))


def test_traced_service_keeps_golden_counts(tmp_path):
    """With the recorder configured and flight tracing active, the
    service's answers are the sequential solver's, bit for bit."""
    from poisson_tpu_torch.serve import SolveRequest
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    obs.configure(trace_dir=str(tmp_path))
    svc, _ = _service("continuous", max_batch=2, refill_chunk=15)
    gates = {i: 1.0 + i / 9 for i in range(4)}
    for i, g in gates.items():
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                rhs_gate=g, dtype="float32"))
    outs = {o.request_id: o for o in svc.drain()}
    for i, g in gates.items():
        ref = pcg_solve(PROBLEM, dtype="float32", rhs_gate=g, device="cpu")
        assert outs[i].converged
        assert outs[i].iterations == int(ref.iterations)


def test_deadline_elapsed():
    from poisson_tpu_torch.serve import Deadline

    vc = VirtualClock()
    d = Deadline(1.0, clock=vc)
    vc.advance(0.4)
    assert d.elapsed() == pytest.approx(0.4)
    assert not d.expired()
    vc.advance(1.0)
    assert d.expired() and d.elapsed() == pytest.approx(1.4)
    assert Deadline.never().elapsed() >= 0.0


# ---------------------------------------------------------------------------
# The serve record's flight attribution (in place of the JAX suite's
# bench-sentinel pin: the port's record is the CLI's)
# ---------------------------------------------------------------------------


def test_serve_record_carries_flight_attribution(capsys):
    """The serve record names its p99 exemplar and carries the slowest
    requests with decompositions whose components sum to their wall."""
    from poisson_tpu_torch.cli import main

    assert main(["serve", "40", "40", "--requests", "4", "--vary-rhs",
                 "--json", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ex = rec["p99_exemplar"]
    assert ex["request_id"] in range(4) and ex["trace_id"]
    assert rec["slowest_requests"]
    for row in rec["slowest_requests"]:
        d = row["decomposition"]
        parts = (d["queue_s"] + d["compute_s"] + d["lane_wait_s"]
                 + d["backoff_s"] + d["overhead_s"])
        assert parts == pytest.approx(d["wall_s"], abs=1e-5)


# ---------------------------------------------------------------------------
# CLI: the trace viewer + serve fire-drill attribution
# ---------------------------------------------------------------------------


def test_cli_trace_subcommand_smoke(tmp_path, capsys):
    from poisson_tpu_torch.cli import main

    tdir = str(tmp_path / "tr")
    rc = main(["serve", "--device", "cpu", "40", "40", "--requests", "2", "--vary-rhs",
               "--trace-dir", tdir, "--json"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["p99_exemplar"]["trace_id"]
    assert rec["slowest_requests"][0]["decomposition"] is not None
    assert main(["trace", "1", "--telemetry", tdir]) == 0
    out = capsys.readouterr().out
    assert "admit" in out and "outcome result:converged" in out
    assert "decomposition" in out
    assert main(["trace", "no-such-request", "--telemetry", tdir]) == 1
    capsys.readouterr()
    # JSON mode: raw records for machine consumers.
    assert main(["trace", "1", "--telemetry", tdir, "--json"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert any(r["name"] == "flight.outcome" for r in lines)
    # Both modes fail on a broken tree (an admit with no outcome leaf):
    # automation consuming --json needs the signal most of all.
    broken = tmp_path / "broken"
    broken.mkdir()
    (broken / "events-rank0.jsonl").write_text(json.dumps(
        {"schema": 2, "at_unix": 1.0, "at_mono": 1.0, "rank": 0,
         "kind": "event", "name": "flight.admit",
         "attrs": {"trace_id": "tX", "request_id": "rX", "t": 0.0}},
    ) + "\n")
    for extra in ([], ["--json"]):
        assert main(["trace", "rX", "--telemetry", str(broken)]
                    + extra) == 1
        assert "INCOMPLETE TRACE" in capsys.readouterr().err


def test_forensics_report_renders_flight_section(tmp_path):
    """The port's telemetry renders in the repository's forensics report
    (``benchmarks/summarize_session.py``, stdlib only)."""
    import pathlib
    import subprocess
    import sys as _sys

    from poisson_tpu_torch.cli import main

    tdir = str(tmp_path / "tr")
    assert main(["serve", "40", "40", "--requests", "2", "--vary-rhs",
                 "--trace-dir", tdir, "--json", "--device", "cpu"]) == 0
    proc = subprocess.run(
        [_sys.executable, "benchmarks/summarize_session.py",
         "--telemetry", tdir],
        capture_output=True, text=True,
        cwd=pathlib.Path(__file__).resolve().parents[1],
    )
    assert proc.returncode == 0, proc.stderr
    assert "Flight recorder" in proc.stdout
    assert "Slowest request timeline" in proc.stdout
    assert "SLO:" in proc.stdout
