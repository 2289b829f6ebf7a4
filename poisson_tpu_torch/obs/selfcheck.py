"""Telemetry selfcheck: ``python -m poisson_tpu_torch.obs.selfcheck [--dir D]
[--device cuda|cpu]`` (the counterpart of the JAX package's
``obs/selfcheck.py``, its steps in its order).

A span, counter and stream round trip against a real 40×40 solve (50
iterations, streaming must not move the count), then the profiler
capture, the Prometheus exposition (textfile and a live ``/metrics``
endpoint on localhost) and ``benchmarks.regress`` on a synthetic history
(a fallback classified as such, a 2× slowdown paged). Then, each on a
clean registry: the service and chaos smoke (``overload-shed``), the
continuous engine and ``refill-poison-splice``, the flight recorder (one
request's causal trace read back from the JSONL), the fleet and its
journal (a worker kill, the replay agreeing with the ledger), geometry as
a request, integrity (a verified clean solve, a seeded bit flip detected
and recovered, ``sdc-verified-restart``), multigrid, placement (a device
loss), the port's program-contract gate (step 19), Krylov memory, durable
sessions (a journal replay across a "crash"), forecasting, the router and
roofline model, and tenancy.

Two steps differ from the JAX package's on purpose:

- **Costs (step 6).** JAX holds XLA's ``cost_analysis`` of the compiled
  iteration to ±25% of the analytic model. Eager PyTorch writes every
  intermediate, so the port's counted iteration (``obs.costs``) is held
  to its pinned ratio to the model at 400×600 — 2.684× in fp32, 1.912× in
  fp64 — within 2%.
- **Geometry (step 15).** JAX proves "zero recompiles": the second family
  is a canvas-cache miss and a bucket-executable hit. The port compiles
  nothing; it proves the canvas cache instead: the second mix's members
  are ``geom.cache`` hits, and no canvas is built twice.

Step 19 runs ``poisson_tpu_torch.contracts``: lint and drift clean, the
kernel entries matching; the trace half matching, or (on a machine with
another PyTorch build) every mismatch reported as the environment's.

Every solve runs on ``--device`` (default ``cuda``; without a card the
command exits non-zero unless ``--device cpu`` is given). Exit 0 on
success, 1 with a reason on the first failure. ``--dir`` keeps the
artifacts (default: a temp dir, removed afterwards).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile


def _fail(reason: str) -> int:
    print(f"obs selfcheck FAILED: {reason}", file=sys.stderr)
    return 1


# obs.costs' pinned ratio of the counted eager iteration to the analytic
# bytes model at 400×600 (tests/test_torch_costs.py), and the tolerance.
COST_RATIO = {"float32": 2.684, "float64": 1.912}
COST_GRID = (400, 600)
COST_TOL = 0.02


def run_selfcheck(out_dir: str, device=None) -> int:
    import time

    from poisson_tpu_torch import obs
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.solvers.pcg import pcg_solve
    from poisson_tpu_torch.utils.platform import resolve_device
    from poisson_tpu_torch.utils.timing import count_solve, fence

    dev = resolve_device(device)

    metrics_path = os.path.join(out_dir, "metrics.json")
    prom_path = os.path.join(out_dir, "metrics.prom")
    profile_root = os.path.join(out_dir, "profile")
    rec = obs.configure(trace_dir=out_dir, metrics_path=metrics_path,
                        stream_every=5, prom_path=prom_path,
                        profile_dir=profile_root)
    obs.inc("selfcheck.runs")
    with obs.span("selfcheck", grid="40x40"):
        problem = Problem(M=40, N=40)
        baseline = pcg_solve(problem, device=dev)
        t0 = time.perf_counter()
        with obs.span("selfcheck.solve"):
            streamed = pcg_solve(problem, stream_every=5, device=dev)
        # The report path is the counters' choke point (solves and
        # iterations by stop verdict) — exercise it like the CLI does.
        count_solve(streamed, compile_seconds=0.0,
                    solve_seconds=time.perf_counter() - t0)
        # Performance attribution: the counted eager iteration against
        # the analytic model at the pinned grid, both dtypes (sets the
        # cost.* gauges the exposition check below must carry through).
        from poisson_tpu_torch.obs import costs

        attribution = {
            dtype: costs.measured_iteration_cost(Problem(*COST_GRID),
                                                 dtype=dtype, device=dev)
            for dtype in ("float64", "float32")}
        # Fenced profiler capture of one extra solve (obs.profile).
        from poisson_tpu_torch.obs import profile

        with profile.capture("selfcheck.solve"):
            pcg_solve(problem, device=dev)
            fence(dev)
    obs.event("selfcheck.done", iterations=int(streamed.iterations))
    obs.finalize()

    # 1. Streaming must not perturb the iterate sequence.
    if int(baseline.iterations) != int(streamed.iterations):
        return _fail(
            f"streaming changed the iteration count: "
            f"{int(baseline.iterations)} -> {int(streamed.iterations)}"
        )

    # 2. Chrome trace: loads, and every event has the required keys.
    trace_path = rec.trace_path
    try:
        with open(trace_path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return _fail(f"trace {trace_path} unreadable: {e}")
    events = doc.get("traceEvents")
    if not events:
        return _fail(f"trace {trace_path} has no traceEvents")
    for ev in events:
        for key in ("ph", "ts", "name"):
            if key not in ev:
                return _fail(f"trace event missing {key!r}: {ev}")
    names = {ev["name"] for ev in events}
    if not {"selfcheck", "selfcheck.solve", "selfcheck.done"} <= names:
        return _fail(f"expected spans/events absent from trace: {names}")

    # 3. Event log: every line parses, spans carry fenced durations
    # (normalize_event folds the v2 attrs block flat — the same loader
    # tolerance load_events applies to v1 and v2 lines alike).
    from poisson_tpu_torch.obs.trace import normalize_event

    span_ends = 0
    with open(rec.events_path) as f:
        for line in f:
            recd = normalize_event(json.loads(line))
            for key in ("kind", "name", "at_unix", "at_mono", "rank"):
                if key not in recd:
                    return _fail(f"event record missing {key!r}: {recd}")
            if recd["kind"] == "span_end":
                span_ends += 1
                if "seconds" not in recd:
                    return _fail(f"span_end without seconds: {recd}")
    if span_ends < 2:
        return _fail(f"expected >= 2 span_end records, got {span_ends}")

    # 4. Metrics snapshot: the counters saw the run.
    try:
        with open(metrics_path) as f:
            snap = json.load(f)
    except (OSError, ValueError) as e:
        return _fail(f"metrics {metrics_path} unreadable: {e}")
    counters = snap.get("counters", {})
    if counters.get("selfcheck.runs") != 1:
        return _fail(f"selfcheck.runs counter wrong: {counters}")
    if counters.get("pcg.solves.converged", 0) < 1:
        return _fail(f"solve was not counted: {counters}")

    # 5. Stream curve: samples at the configured stride.
    stream_path = os.path.join(out_dir, f"stream-rank{rec.rank}.jsonl")
    try:
        with open(stream_path) as f:
            samples = [json.loads(line) for line in f if line.strip()]
    except (OSError, ValueError) as e:
        return _fail(f"stream {stream_path} unreadable: {e}")
    if not samples or any(s["k"] % 5 != 0 for s in samples):
        return _fail(f"bad stream samples: {samples[:3]}")

    # 6. Cost attribution: the counted eager iteration sits at its pinned
    # ratio to the analytic model (JAX holds XLA's cost analysis to ±25%
    # of the model; eager PyTorch writes every intermediate, so the port's
    # ratio is pinned instead).
    for dtype, report_ in attribution.items():
        agree = report_.get("model_agreement")
        want = COST_RATIO[dtype]
        if agree is None or abs(agree / want - 1.0) > COST_TOL:
            return _fail(f"counted bytes/iter is {agree}x the analytic "
                         f"model in {dtype} at {COST_GRID[0]}x"
                         f"{COST_GRID[1]}; pinned {want}x within "
                         f"{COST_TOL:.0%}")
    agree = attribution["float32"]["model_agreement"]

    # 7. Profiler capture: the fenced torch.profiler capture produced an
    # artifact tree.
    capture_dir = os.path.join(profile_root, "selfcheck.solve")
    n_profile_files = sum(
        len(files) for _, _, files in os.walk(capture_dir)
    )
    if n_profile_files == 0:
        return _fail(f"profiler capture produced no files in "
                     f"{capture_dir}")

    # 8. Prometheus exposition round trip: the finalize-written textfile
    # parses and carries the counters and cost gauges through.
    from poisson_tpu_torch.obs import export

    try:
        parsed = export.parse_text(open(prom_path).read())
    except (OSError, ValueError) as e:
        return _fail(f"prometheus textfile {prom_path} unreadable: {e}")
    solves = parsed.get("poisson_tpu_pcg_solves_converged")
    if not solves or solves["type"] != "counter" or solves["value"] < 1:
        return _fail(f"exposition lost the solve counter: {solves}")
    if "poisson_tpu_cost_model_agreement" not in parsed:
        return _fail("exposition lost the cost.model_agreement gauge")

    # 9. Live /metrics endpoint serves the same text.
    import urllib.request

    server = export.start_http_server(port=0)
    try:
        url = f"http://127.0.0.1:{server.server_port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
        served = export.parse_text(body)
        if "poisson_tpu_pcg_solves_converged" not in served:
            return _fail("/metrics endpoint missing the solve counter")
    finally:
        export.stop_http_server(server)

    # 10. Regression sentinel end to end on a synthetic history: a
    # platform fallback must classify as such (not page), a genuine 2x
    # slowdown must page.
    import sys as _sys

    _repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    if _repo_root not in _sys.path:
        _sys.path.insert(0, _repo_root)
    try:
        from benchmarks import regress
    except ImportError as e:
        return _fail(f"benchmarks.regress not importable: {e}")

    def _rec(value, platform, fallback=False):
        return regress.record_from_result(
            {"metric": "mlups", "value": value,
             "detail": {"grid": [40, 40], "dtype": "float32",
                        "backend": "fused", "devices": 1,
                        "platform": platform,
                        "platform_fallback": fallback}},
            source=f"selfcheck:{platform}:{value}",
        )
    history = [_rec(24000.0, "gpu"), _rec(23800.0, "gpu"),
               _rec(23900.0, "gpu"), _rec(160.0, "cpu", fallback=True)]
    verdict = regress.evaluate(history)
    if verdict["verdict"] != "ok":
        return _fail(f"sentinel paged on a platform fallback: {verdict}")
    fallback_cls = [v["classification"] for v in verdict["records"]
                    if v["platform"] == "cpu"]
    if fallback_cls != ["platform_fallback"]:
        return _fail(f"fallback misclassified: {fallback_cls}")
    slowed = regress.evaluate(history + [_rec(11900.0, "gpu")])
    if slowed["verdict"] != "regression":
        return _fail(f"sentinel missed a 2x slowdown: {slowed}")

    # 11. Solve service → chaos → metrics export, end to end: one chaos
    # scenario (which RESETS the metrics registry — deliberately last,
    # after every snapshot-dependent check above), its no-lost-request
    # invariant read from the scenario's own metrics snapshot, and the
    # serve.* counters surviving the Prometheus exposition round trip.
    from poisson_tpu_torch.testing import chaos

    report = chaos.run_scenario("overload-shed", seed=0, device=dev)
    if not report["ok"]:
        failed = [k for k, v in report["checks"].items() if not v]
        return _fail(f"chaos scenario overload-shed failed: {failed}")
    if report["invariant"]["lost"] != 0:
        return _fail(f"chaos scenario lost requests: "
                     f"{report['invariant']}")
    serve_text = export.render(report["metrics_snapshot"])
    serve_parsed = export.parse_text(serve_text)
    admitted = serve_parsed.get("poisson_tpu_serve_admitted")
    if (not admitted
            or admitted["value"] != report["invariant"]["admitted"]):
        return _fail(f"exposition lost the serve.admitted counter: "
                     f"{admitted}")
    p99_key = 'poisson_tpu_serve_latency_seconds{quantile="0.99"}'
    if (p99_key not in serve_parsed
            or serve_parsed[p99_key]["type"] != "summary"):
        return _fail("exposition lost the serve latency summary "
                     f"(looked for {p99_key})")

    # 12. Continuous batching, end to end (runs LAST, clean registry):
    # an open-loop drive of the refill engine — a request is two chunks
    # into a lane program when two more arrive and splice into the SAME
    # running executable — then a refill-race chaos scenario, with the
    # serve.refill.* counters surviving the exposition round trip.
    from poisson_tpu_torch.obs import metrics as obs_metrics
    from poisson_tpu_torch.serve import (
        SCHED_CONTINUOUS,
        ServicePolicy,
        SolveRequest,
        SolveService,
    )
    from poisson_tpu_torch.testing.chaos import VirtualClock

    obs_metrics.reset()
    vc = VirtualClock()
    svc = SolveService(
        ServicePolicy(scheduling=SCHED_CONTINUOUS, max_batch=4,
                      refill_chunk=10),
        clock=vc, sleep=vc.sleep, seed=0, device=dev,
    )
    svc.submit(SolveRequest(request_id=0, problem=problem))
    svc.pump()
    svc.pump()                     # request 0 is now mid-flight
    for i in (1, 2):               # open-loop arrivals join it
        svc.submit(SolveRequest(request_id=i, problem=problem,
                                rhs_gate=1.0 + i / 10))
    svc.drain()
    serve_stats = svc.stats()
    if serve_stats["lost"] != 0 or serve_stats["completed"] != 3:
        return _fail(f"continuous engine lost requests: {serve_stats}")
    splices = obs_metrics.get("serve.refill.splices")
    retired = obs_metrics.get("serve.refill.retired_lanes")
    if splices < 3 or retired < 3:
        return _fail(f"refill counters missing the open-loop drive: "
                     f"splices={splices}, retired={retired}")
    refill_report = chaos.run_scenario("refill-poison-splice", seed=0,
                                         device=dev)
    if not refill_report["ok"]:
        failed = [k for k, v in refill_report["checks"].items() if not v]
        return _fail(f"chaos scenario refill-poison-splice failed: "
                     f"{failed}")
    if refill_report["invariant"]["lost"] != 0:
        return _fail(f"refill chaos scenario lost requests: "
                     f"{refill_report['invariant']}")
    refill_parsed = export.parse_text(
        export.render(refill_report["metrics_snapshot"]))
    for prom_name in ("poisson_tpu_serve_refill_splices",
                      "poisson_tpu_serve_refill_retired_lanes"):
        if prom_name not in refill_parsed:
            return _fail(f"exposition lost the {prom_name} counter")

    # 13. Flight recorder + SLOs, end to end (runs LAST, clean
    # registry): an open-loop continuous run with a mid-flight join →
    # one request traced end to end FROM THE JSONL (complete causal
    # tree) → its timeline renders → the live Prometheus exposition
    # carries the serve_slo_* counters and real histogram buckets.
    from poisson_tpu_torch.obs import flight as obs_flight
    from poisson_tpu_torch.obs import trace as obs_trace
    from poisson_tpu_torch.serve.types import SLOPolicy

    obs_metrics.reset()
    vc13 = VirtualClock()
    svc13 = SolveService(
        ServicePolicy(scheduling=SCHED_CONTINUOUS, max_batch=4,
                      refill_chunk=10,
                      slo=SLOPolicy(latency_objective_seconds=5.0)),
        clock=vc13, sleep=vc13.sleep, seed=0, device=dev,
        dispatch_fault=lambda reqs, att: vc13.advance(0.1),
    )
    svc13.submit(SolveRequest(request_id="traced", problem=problem))
    svc13.pump()
    svc13.pump()                   # "traced" is mid-flight
    svc13.submit(SolveRequest(request_id="joiner", problem=problem,
                              rhs_gate=1.1))
    flight_outs = {o.request_id: o for o in svc13.drain()}
    traced = flight_outs["traced"]
    if not traced.trace_id or traced.decomposition is None:
        return _fail(f"outcome carries no flight attribution: {traced}")
    d = traced.decomposition
    parts = (d["queue_s"] + d["compute_s"] + d["lane_wait_s"]
             + d["backoff_s"] + d["overhead_s"])
    if abs(parts - d["wall_s"]) > 1e-4:
        return _fail(f"decomposition does not sum to wall: {d}")
    flight_events = obs_trace.load_events(out_dir)
    tid, trecs = obs_flight.find_trace(flight_events,
                                       trace_id=traced.trace_id)
    if tid is None:
        return _fail(f"trace {traced.trace_id} absent from the JSONL")
    trace_problems = obs_flight.validate_trace(trecs)
    if trace_problems:
        return _fail(f"incomplete causal trace: {trace_problems}")
    timeline = obs_flight.render_timeline(trecs)
    if "admit" not in timeline or "outcome" not in timeline:
        return _fail(f"timeline render incomplete:\n{timeline}")
    slo_parsed = export.parse_text(export.render())
    if "poisson_tpu_serve_slo_good" not in slo_parsed:
        return _fail("exposition lost the serve.slo.good counter")
    bucket_keys = [k for k in slo_parsed
                   if k.startswith(
                       "poisson_tpu_serve_slo_latency_seconds_bucket")]
    if not bucket_keys:
        return _fail("exposition carries no SLO histogram buckets")
    if slo_parsed[bucket_keys[0]]["type"] != "histogram":
        return _fail(f"histogram family mistyped: "
                     f"{slo_parsed[bucket_keys[0]]}")

    # 14. Durable solve fleet (runs LAST, clean registry): a two-worker
    # fleet with a journal takes a worker kill mid-dispatch — the
    # supervisor quarantines it, recovers the in-flight requests onto
    # the survivor, restarts it through warm-up — then the journal
    # replays back to the same ledger and the Prometheus exposition
    # carries the serve_fleet_* counters.
    from poisson_tpu_torch.serve import FleetPolicy, SolveJournal, replay_journal
    from poisson_tpu_torch.testing.faults import worker_kill_fault

    obs_metrics.reset()
    vc14 = VirtualClock()
    journal_path = os.path.join(out_dir, "serve.journal")
    journal = SolveJournal(journal_path, clock=vc14)
    svc14 = SolveService(
        ServicePolicy(
            capacity=16, max_batch=4,
            fleet=FleetPolicy(workers=2, quarantine_seconds=0.02,
                              recovery_backoff=0.02),
        ),
        clock=vc14, sleep=vc14.sleep, seed=0, journal=journal, device=dev,
        worker_fault=worker_kill_fault({0}),
    )
    for i in range(4):
        svc14.submit(SolveRequest(request_id=f"fleet-{i}",
                                  problem=problem, rhs_gate=1.0 + i / 10))
    fleet_outs = svc14.drain()
    journal.close()
    fleet_stats = svc14.stats()
    if fleet_stats["lost"] != 0 or len(fleet_outs) != 4:
        return _fail(f"fleet drill lost requests: {fleet_stats}")
    if not all(o.converged for o in fleet_outs):
        return _fail("fleet drill: recovered requests did not converge")
    quarantines = obs_metrics.get("serve.fleet.quarantines")
    recovered = obs_metrics.get("serve.fleet.recovered_requests")
    if quarantines < 1 or recovered < 1:
        return _fail(f"fleet counters missed the kill: "
                     f"quarantines={quarantines}, recovered={recovered}")
    fleet_replay = replay_journal(journal_path)
    if (len(fleet_replay.outcomes) != 4 or fleet_replay.pending
            or fleet_replay.duplicate_outcomes):
        return _fail(
            f"journal replay disagrees with the ledger: "
            f"{len(fleet_replay.outcomes)} outcomes, "
            f"{len(fleet_replay.pending)} pending, "
            f"dupes {fleet_replay.duplicate_outcomes}")
    fleet_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_serve_fleet_quarantines",
                      "poisson_tpu_serve_fleet_recovered_requests",
                      "poisson_tpu_serve_journal_records"):
        if prom_name not in fleet_parsed:
            return _fail(f"exposition lost the {prom_name} counter")

    # 15. Geometry as a request (clean registry): build a family → a
    # rebuild is a fingerprint-cache hit → two families co-batch in one
    # solve → a second mix of a built family builds no canvas (geom
    # cache hits only; the port compiles nothing, so JAX's "zero
    # recompiles" is "zero canvas rebuilds" here) → the exposition
    # carries the geom_* counters.
    from poisson_tpu_torch.geometry import Ellipse, Rectangle, geometry_setup
    from poisson_tpu_torch.geometry.canvas import reset_geometry_cache
    from poisson_tpu_torch.solvers.batched import (
        reset_bucket_cache,
        solve_batched,
    )

    obs_metrics.reset()
    reset_bucket_cache()
    reset_geometry_cache()
    fam_a = Ellipse(cx=0.1, cy=0.0, rx=0.7, ry=0.4)
    fam_b = Rectangle(-0.6, -0.3, 0.5, 0.3)
    geometry_setup(problem, fam_a, "float32", True, dev)
    geometry_setup(problem, fam_a, "float32", True, dev)   # rebuild → hit
    if obs_metrics.get("geom.cache.hits") != 1 \
            or obs_metrics.get("geom.cache.misses") != 1:
        return _fail(
            f"fingerprint cache arithmetic off: hits="
            f"{obs_metrics.get('geom.cache.hits')}, misses="
            f"{obs_metrics.get('geom.cache.misses')}")
    geo_res = solve_batched(problem, rhs_gates=[1.0, 1.1],
                            geometries=[fam_a, fam_b], device=dev)
    if not bool((geo_res.flag == 1).all()):
        return _fail(f"mixed co-batch solve did not converge: "
                     f"flags {geo_res.flag.tolist()}")
    misses_before = obs_metrics.get("geom.cache.misses")
    hits_before = obs_metrics.get("geom.cache.hits")
    solve_batched(problem, rhs_gates=[1.0, 1.2],
                  geometries=[fam_b, fam_b], device=dev)
    if (obs_metrics.get("geom.cache.misses") != misses_before
            or obs_metrics.get("geom.cache.hits") <= hits_before):
        return _fail(
            f"second geometry mix rebuilt a canvas: misses "
            f"{misses_before} -> {obs_metrics.get('geom.cache.misses')}, "
            f"hits {hits_before} -> {obs_metrics.get('geom.cache.hits')}")
    geom_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_geom_cache_hits",
                      "poisson_tpu_geom_cache_misses"):
        if prom_name not in geom_parsed:
            return _fail(f"exposition lost the {prom_name} counter")
    geom_hits = obs_metrics.get("geom.cache.hits")

    # 16. Numerical integrity (runs LAST of all, clean registry): the
    # silent-data-corruption defense end to end — a clean verified
    # solve detects nothing and keeps the golden count; a seeded
    # exponent bit flip mid-solve is detected by the in-loop drift
    # probe and recovered by a verified restart (no precision burned,
    # no false alarms); a serve-side SDC chaos scenario keeps the
    # ledger invariant; and the integrity_*/serve_integrity_* counters
    # survive the Prometheus exposition round trip.
    import warnings as _warnings

    from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient
    from poisson_tpu_torch.testing.faults import bitflip_per_solve_hook

    obs_metrics.reset()
    clean = pcg_solve_resilient(problem, chunk=10, verify_every=5,
                                device=dev)
    if (int(clean.iterations) != int(baseline.iterations)
            or not clean.restarts == 0):
        return _fail(
            f"verified clean solve drifted from the golden: "
            f"{int(clean.iterations)} iters (golden "
            f"{int(baseline.iterations)}), restarts {clean.restarts}")
    if obs_metrics.get("integrity.detections") != 0 \
            or obs_metrics.get("integrity.false_alarms") != 0:
        return _fail(
            f"clean verified solve raised integrity verdicts: "
            f"detections={obs_metrics.get('integrity.detections')}, "
            f"false_alarms={obs_metrics.get('integrity.false_alarms')}")
    with _warnings.catch_warnings():
        _warnings.simplefilter("ignore", RuntimeWarning)
        flipped = pcg_solve_resilient(
            problem, chunk=10, verify_every=5, device=dev,
            on_chunk=bitflip_per_solve_hook(20, buffer="w", seed=1))
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED as _FC

    if int(flipped.flag) != _FC or not flipped.restarts:
        return _fail(f"bit-flipped solve did not recover: flag "
                     f"{int(flipped.flag)}, restarts {flipped.restarts}")
    detections = obs_metrics.get("integrity.detections")
    vrestarts = obs_metrics.get("integrity.verified_restarts")
    if (detections < 1 or vrestarts < 1
            or obs_metrics.get("integrity.false_alarms") != 0):
        return _fail(
            f"integrity counters missed the flip: detections="
            f"{detections}, verified_restarts={vrestarts}, false_alarms="
            f"{obs_metrics.get('integrity.false_alarms')}")
    sdc_report = chaos.run_scenario("sdc-verified-restart", seed=0,
                                    device=dev)
    if not sdc_report["ok"]:
        failed = [k for k, v in sdc_report["checks"].items() if not v]
        return _fail(f"chaos scenario sdc-verified-restart failed: "
                     f"{failed}")
    integ_parsed = export.parse_text(
        export.render(sdc_report["metrics_snapshot"]))
    for prom_name in ("poisson_tpu_integrity_detections",
                      "poisson_tpu_integrity_verified_restarts",
                      "poisson_tpu_serve_integrity_detections",
                      "poisson_tpu_serve_integrity_suspect_cohorts"):
        if prom_name not in integ_parsed:
            return _fail(f"exposition lost the {prom_name} counter")

    # 17. Multigrid preconditioning (runs LAST, clean registry): the
    # V-cycle preconditioner beats Jacobi's iteration count at two
    # resolutions while converging to the same δ, the second solve of
    # a grid reuses the cached hierarchy, and the mg_* counters
    # survive the Prometheus exposition round trip.
    from poisson_tpu_torch.mg import reset_hierarchy_cache

    obs_metrics.reset()
    reset_hierarchy_cache()
    mg_iters = {}
    for m, n in ((40, 40), (80, 80)):
        pp = Problem(M=m, N=n)
        rj = pcg_solve(pp, device=dev)
        rm = pcg_solve(pp, preconditioner="mg", device=dev)
        if int(rm.flag) != 1 or float(rm.diff) >= pp.delta:
            return _fail(f"mg solve {m}x{n} did not converge: flag "
                         f"{int(rm.flag)}, diff {float(rm.diff):.2e}")
        if int(rm.iterations) * 2 > int(rj.iterations):
            return _fail(
                f"mg iteration win missing at {m}x{n}: mg "
                f"{int(rm.iterations)} vs jacobi {int(rj.iterations)}")
        mg_iters[f"{m}x{n}"] = (int(rj.iterations), int(rm.iterations))
    pcg_solve(Problem(M=40, N=40), preconditioner="mg",
              device=dev)                                # rebuild → hit
    if obs_metrics.get("mg.hierarchy_cache.hits") < 1 \
            or obs_metrics.get("mg.hierarchy_cache.misses") != 2:
        return _fail(
            f"hierarchy cache arithmetic off: hits="
            f"{obs_metrics.get('mg.hierarchy_cache.hits')}, misses="
            f"{obs_metrics.get('mg.hierarchy_cache.misses')}")
    mg_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_mg_solves",
                      "poisson_tpu_mg_hierarchy_cache_hits",
                      "poisson_tpu_mg_hierarchy_cache_misses",
                      "poisson_tpu_mg_levels"):
        if prom_name not in mg_parsed:
            return _fail(f"exposition lost the {prom_name} metric")

    # 18. Device placement & fault domains (runs LAST of all, clean
    # registry): a two-worker fleet bound to two device slots takes a
    # DEVICE loss mid-dispatch — the fault domain is quarantined whole,
    # the in-flight requests recover onto the surviving device, the
    # worker rebinds at restart — and the
    # serve_fleet_device_losses/serve_placement_* counters survive the
    # Prometheus exposition round trip.
    from poisson_tpu_torch.serve import FleetPolicy as _FleetPolicy
    from poisson_tpu_torch.serve import RetryPolicy as _RetryPolicy
    from poisson_tpu_torch.testing.faults import device_loss_fault

    obs_metrics.reset()
    vc18 = VirtualClock()
    holder18 = {}
    svc18 = SolveService(
        ServicePolicy(
            capacity=16, max_batch=4,
            retry=_RetryPolicy(max_attempts=3, backoff_base=0.02,
                               backoff_cap=0.1),
            fleet=_FleetPolicy(workers=2, devices=2,
                               quarantine_seconds=0.02,
                               recovery_backoff=0.02),
        ),
        clock=vc18, sleep=vc18.sleep, seed=0, device=dev,
        worker_fault=device_loss_fault(
            {0}, lambda wid: holder18["svc"].worker_device(wid)),
    )
    holder18["svc"] = svc18
    for i in range(4):
        svc18.submit(SolveRequest(request_id=f"dev-{i}", problem=problem,
                                  rhs_gate=1.0 + i / 10))
    place_outs = svc18.drain()
    place_stats = svc18.stats()
    if place_stats["lost"] != 0 or not all(o.converged
                                          for o in place_outs):
        return _fail(f"device-loss drill lost requests: {place_stats}")
    # Rebinding happens at restart — release the quarantine (the drain
    # can finish on the survivor before the cooldown does) and pump
    # the restart through.
    vc18.advance(1.0)
    svc18.pump()
    place_stats = svc18.stats()
    device_losses = obs_metrics.get("serve.fleet.device_losses")
    rebinds = obs_metrics.get("serve.placement.rebinds")
    if device_losses != 1 or rebinds < 1:
        return _fail(f"placement counters missed the device loss: "
                     f"device_losses={device_losses}, rebinds={rebinds}")
    if place_stats["placement"]["lost"] != [0] \
            or place_stats["placement"]["epoch"] != 2:
        return _fail(f"registry did not record the loss: "
                     f"{place_stats['placement']}")
    place_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_serve_fleet_device_losses",
                      "poisson_tpu_serve_placement_rebinds",
                      "poisson_tpu_serve_placement_epoch"):
        if prom_name not in place_parsed:
            return _fail(f"exposition lost the {prom_name} metric")

    # 19. Program contracts end to end (poisson_tpu_torch.contracts):
    # lint and registry drift over this checkout report no unsuppressed
    # finding, the kernel entries match, every flag-off program is
    # structurally clean and its trace matches the committed ledger — or,
    # under another PyTorch build, every mismatch is reported as the
    # environment's (never counted as a match) — and the contracts.*
    # gauges survive the Prometheus exposition.
    from poisson_tpu_torch.contracts.__main__ import run_contracts

    contracts_report = run_contracts(ledger=True)
    ledger_problems = (contracts_report["ledger"]
                       or {"problems": []})["problems"]
    env_only = [p for p in ledger_problems
                if p["kind"] == "ledger-environment"]
    if (contracts_report["counts"]["findings"] != 0
            or len(env_only) != len(ledger_problems)):
        broken = [f"{f['file']}:{f['line']} [{f['rule']}]"
                  for f in contracts_report["findings"]
                  if not f.get("suppressed")]
        broken += [f"ledger:{p['program']} [{p['kind']}]"
                   for p in ledger_problems
                   if p["kind"] != "ledger-environment"]
        return _fail(f"program contracts broken: {broken}")
    if contracts_report["counts"]["rules"] < 8 \
            or contracts_report["counts"]["ledger_programs"] < 14:
        return _fail(
            f"contracts coverage shrank: "
            f"{contracts_report['counts']['rules']} rules, "
            f"{contracts_report['counts']['ledger_programs']} programs")
    contracts_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_contracts_findings",
                      "poisson_tpu_contracts_rules"):
        if prom_name not in contracts_parsed:
            return _fail(f"exposition lost the {prom_name} metric")
    if (contracts_parsed["poisson_tpu_contracts_findings"]["value"]
            != len(env_only)):
        return _fail("contracts.findings gauge disagrees with the report")
    contracts_state = ("ledger matched" if not env_only else
                       f"{len(env_only)} trace(s) of another environment, "
                       f"reported")

    # 20. Krylov memory end to end (runs LAST, clean registry): a cold
    # solve against a fresh fingerprint harvests a deflation basis
    # (krylov.cache.misses + krylov.harvests), the warm solve of the
    # SAME operator at a different RHS gate converges in strictly fewer
    # iterations off the cached basis (krylov.cache.hits +
    # krylov.warm_solves + iterations_saved), and the krylov_* counters
    # survive the Prometheus exposition round trip.
    from poisson_tpu_torch.krylov import KrylovPolicy
    from poisson_tpu_torch.krylov.recycle import (
        reset_krylov_cache,
        solve_recycled,
    )

    obs_metrics.reset()
    reset_krylov_cache()
    kp20 = KrylovPolicy(deflation=True)
    cold20 = solve_recycled(problem, dtype="float32", policy=kp20,
                            device=dev)
    warm20 = solve_recycled(problem, dtype="float32", policy=kp20,
                            rhs_gate=1.4, device=dev)
    if int(cold20.flag) != 1 or int(warm20.flag) != 1:
        return _fail(f"krylov solves did not converge: cold flag "
                     f"{int(cold20.flag)}, warm flag {int(warm20.flag)}")
    if int(warm20.iterations) >= int(cold20.iterations):
        return _fail(
            f"warm start did not beat cold: warm "
            f"{int(warm20.iterations)} vs cold {int(cold20.iterations)}")
    if (obs_metrics.get("krylov.cache.misses") != 1
            or obs_metrics.get("krylov.cache.hits") != 1
            or obs_metrics.get("krylov.harvests") != 1
            or obs_metrics.get("krylov.warm_solves") != 1):
        return _fail(
            f"krylov cache arithmetic off: "
            f"misses={obs_metrics.get('krylov.cache.misses')}, "
            f"hits={obs_metrics.get('krylov.cache.hits')}, "
            f"harvests={obs_metrics.get('krylov.harvests')}, "
            f"warm={obs_metrics.get('krylov.warm_solves')}")
    saved20 = obs_metrics.get("krylov.iterations_saved")
    if saved20 < 1:
        return _fail(f"krylov.iterations_saved not positive: {saved20}")
    krylov_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_krylov_cache_hits",
                      "poisson_tpu_krylov_cache_misses",
                      "poisson_tpu_krylov_harvests",
                      "poisson_tpu_krylov_warm_solves",
                      "poisson_tpu_krylov_iterations_saved"):
        if prom_name not in krylov_parsed:
            return _fail(f"exposition lost the {prom_name} counter")

    # 21. Durable solver sessions end to end (runs LAST, clean
    # registry): an open session's warm-started steps beat its cold
    # first step, abandoning the process state and replaying the
    # journal re-opens the stream at the exact committed step boundary
    # with the ledger invariant closed across the "crash", and the
    # session_* counters survive the Prometheus exposition round trip.
    from poisson_tpu_torch.serve import SessionHost
    from poisson_tpu_torch.solvers.session import reset_session_cache

    obs_metrics.reset()
    reset_session_cache()
    j21_path = os.path.join(out_dir, "session-selfcheck-journal.bin")
    svc21 = SolveService(ServicePolicy(capacity=16),
                         journal=SolveJournal(j21_path), seed=0,
                         device=dev)
    host21 = SessionHost(svc21)
    sess21 = host21.open("sc", problem, geometry=Ellipse())
    if sess21 is None:
        return _fail("session open was shed on an idle service")
    outs21 = [host21.step(sess21, geometry=Ellipse(cx=5e-4 * k))
              for k in range(3)]
    if not all(o.converged for o in outs21):
        return _fail(f"session steps did not converge: "
                     f"{[o.kind for o in outs21]}")
    warm_hits21 = obs_metrics.get("session.warm.hits")
    if warm_hits21 < 2:
        return _fail(f"warm starts missing: session.warm.hits="
                     f"{warm_hits21} after 3 drifting steps")
    cold_it21 = int(outs21[0].iterations)
    warm_it21 = int(outs21[1].iterations)
    if warm_it21 >= cold_it21:
        return _fail(f"warm step did not beat cold: warm {warm_it21} "
                     f"vs cold {cold_it21} iterations")
    # The "crash": abandon the live service WITHOUT closing the
    # session, then rebuild both halves from the journal — the
    # per-request half (SolveService.recover) and the stream half
    # (SessionHost.recover) — and finish the schedule.
    del svc21, host21, sess21
    svc21b = SolveService.recover(SolveJournal(j21_path),
                                  ServicePolicy(capacity=16), seed=0,
                                  device=dev)
    host21b = SessionHost(svc21b)
    rec21 = host21b.recover()
    sess21b = next((s for s in rec21 if s.session_id == "sc"), None)
    if sess21b is None:
        return _fail("journal replay did not re-open session 'sc'")
    if sess21b.next_step != 3 or sess21b.advanced != 2 \
            or not sess21b.recovered or sess21b.generation != 2:
        return _fail(
            f"recovered session off its committed boundary: next_step="
            f"{sess21b.next_step}, advanced={sess21b.advanced}, "
            f"generation={sess21b.generation}")
    if sess21b.warm is not None:
        return _fail("recovery resurrected a warm iterate from "
                     "unreplayed device state")
    out21 = host21b.step(sess21b, geometry=Ellipse(cx=5e-4 * 3))
    if not out21.converged:
        return _fail(f"post-recovery step did not converge: {out21.kind}")
    close21 = host21b.close(sess21b)
    if obs_metrics.get("session.recovered") != 1 \
            or close21["errors"] != 0:
        return _fail(
            f"recovery accounting off: session.recovered="
            f"{obs_metrics.get('session.recovered')}, close={close21}")
    adm21 = obs_metrics.get("serve.admitted")
    done21 = (obs_metrics.get("serve.completed")
              + obs_metrics.get("serve.errors")
              + obs_metrics.get("serve.shed"))
    if adm21 != 5 or adm21 != done21:
        return _fail(
            f"session ledger did not close across the crash: admitted="
            f"{adm21}, completed+errors+shed={done21}")
    session_parsed = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_session_opens",
                      "poisson_tpu_session_steps",
                      "poisson_tpu_session_warm_hits",
                      "poisson_tpu_session_recovered",
                      "poisson_tpu_session_closes",
                      "poisson_tpu_session_slo_good"):
        if prom_name not in session_parsed:
            return _fail(f"exposition lost the {prom_name} counter")

    # 22. Convergence forecasting end to end (clean registry): the
    # analytic cold model seeds a prediction before any
    # sample exists, a few completed solves calibrate the cohort, a
    # deadline-doomed request sheds typed `predicted_deadline` at
    # admission with ZERO compute burned (counter-asserted), and the
    # forecast counters survive the Prometheus exposition round trip.
    from poisson_tpu_torch.obs.forecast import ForecastModel
    from poisson_tpu_torch.serve import ForecastPolicy

    obs_metrics.reset()
    model22 = ForecastModel()
    fc_cold22 = model22.predict("seed-cohort", M=problem.M, N=problem.N,
                                dtype_bytes=8, scaled=False)
    if not fc_cold22.cold or fc_cold22.iterations_p50 < 1 \
            or fc_cold22.eta_p90_seconds <= 0.0:
        return _fail(f"cold-seed forecast degenerate: {fc_cold22}")
    svc22 = SolveService(
        ServicePolicy(capacity=16, forecast=ForecastPolicy()), seed=0,
        device=dev)
    for k in range(3):
        if svc22.submit(SolveRequest(request_id=f"fc{k}",
                                     problem=problem)) is not None:
            return _fail("forecast warm-up request shed on admission")
    outs22 = svc22.drain()
    if not all(o.converged for o in outs22):
        return _fail(f"forecast warm-up solves did not converge: "
                     f"{[o.kind for o in outs22]}")
    preds22 = obs_metrics.get("obs.forecast.predictions")
    calib22 = obs_metrics.get("obs.forecast.calibration_err_pct")
    if preds22 < 3:
        return _fail(f"forecast feedback missing: "
                     f"obs.forecast.predictions={preds22}")
    if calib22 > 25.0:
        return _fail(f"forecast stayed uncalibrated on repeat traffic: "
                     f"p50 abs error {calib22}% > 25%")
    doomed22 = svc22.submit(SolveRequest(request_id="fc-doom",
                                         problem=problem,
                                         deadline_seconds=1e-9))
    if doomed22 is None or doomed22.kind != "shed" \
            or doomed22.shed_reason != "predicted_deadline":
        return _fail(f"deadline-doomed request was not predict-shed: "
                     f"{doomed22}")
    d22 = doomed22.decomposition or {}
    if d22.get("compute_s", 1) != 0 or d22.get("dispatches", 1) != 0:
        return _fail(f"predicted shed burned compute: {d22}")
    st22 = svc22.stats()
    if st22["lost"] != 0:
        return _fail(f"forecast service lost requests: {st22}")
    parsed22 = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_obs_forecast_predictions",
                      "poisson_tpu_obs_forecast_cold_cohorts",
                      "poisson_tpu_obs_forecast_calibration_err_pct",
                      "poisson_tpu_serve_forecast_admission_checks",
                      "poisson_tpu_serve_shed_predicted_deadline"):
        if prom_name not in parsed22:
            return _fail(f"exposition lost the {prom_name} metric")

    # 23. Backend router + roofline observatory (runs LAST, clean
    # registry, REAL clock so dispatches are measurable): a routed
    # service makes cold decisions — the torch arm on the CPU, where no
    # kernel arm is available, kernel R's arm on a card (JAX's selfcheck
    # sees only xla on its CPU host) — and feeds measured roofline
    # fractions for the arm it chose, the CRC-sealed roofline snapshot survives a
    # round-trip (and a torn snapshot is skipped audibly, leaving the
    # model cold), and the router/roofline counters survive the
    # Prometheus exposition round trip.
    from poisson_tpu_torch.obs.roofline import RooflineModel
    from poisson_tpu_torch.serve import RouterPolicy

    obs_metrics.reset()
    svc23 = SolveService(
        ServicePolicy(capacity=16, router=RouterPolicy()), seed=0,
        device=dev)
    outs23 = []
    # One request per drain → one routed decision per dispatch (a
    # co-batched drain is a single decision).
    for k in range(3):
        if svc23.submit(SolveRequest(request_id=f"rt{k}",
                                     problem=problem)) is not None:
            return _fail("routed request shed on admission")
        outs23.extend(svc23.drain())
    if not all(o.converged for o in outs23):
        return _fail(f"routed solves did not converge: "
                     f"{[o.kind for o in outs23]}")
    st23 = svc23.stats()
    if st23["lost"] != 0 or "router" not in st23:
        return _fail(f"routed service stats degenerate: {st23}")
    decisions23 = obs_metrics.get("serve.router.decisions")
    rl_obs23 = obs_metrics.get("obs.roofline.observations")
    chosen23 = st23["router"]["chosen"]
    arm23 = max(chosen23, key=chosen23.get) if chosen23 else None
    if decisions23 < 3 or arm23 is None or chosen23[arm23] < 3:
        return _fail(f"router made too few decisions: "
                     f"{st23['router']}")
    if rl_obs23 < 1:
        return _fail("no dispatch produced a roofline measurement "
                     "under the real clock")
    frac23 = svc23._roofline.backend_fraction(arm23)
    if frac23 is None or frac23 <= 0.0:
        return _fail(f"measured {arm23} roofline fraction degenerate: "
                     f"{frac23}")
    rl_path23 = os.path.join(out_dir, "roofline23.json")
    if not svc23._roofline.save(rl_path23):
        return _fail("roofline snapshot save failed")
    model23 = RooflineModel()
    if not model23.load(rl_path23):
        return _fail("roofline snapshot load failed")
    frac23b = model23.backend_fraction(arm23)
    # the snapshot stores fractions rounded to 9 decimals
    if frac23b is None or abs(frac23b - frac23) > 1e-8:
        return _fail(f"roofline snapshot round-trip drifted: "
                     f"{frac23} -> {frac23b}")
    with open(rl_path23, "r+") as fh:  # tear the seal
        fh.seek(0)
        fh.write("{torn!")
    torn_model23 = RooflineModel()
    if torn_model23.load(rl_path23):
        return _fail("torn roofline snapshot was accepted")
    if obs_metrics.get("obs.roofline.snapshot.torn") != 1:
        return _fail("torn roofline snapshot was not counted")
    if torn_model23.backend_fraction(arm23) is not None:
        return _fail("torn roofline snapshot leaked samples")
    parsed23 = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_serve_router_decisions",
                      "poisson_tpu_serve_router_cold_decisions",
                      f"poisson_tpu_serve_router_chosen_{arm23}",
                      "poisson_tpu_obs_roofline_observations",
                      "poisson_tpu_obs_roofline_fraction",
                      "poisson_tpu_obs_roofline_snapshot_torn"):
        if prom_name not in parsed23:
            return _fail(f"exposition lost the {prom_name} metric")

    # 24. Tenant isolation & overload fairness (runs LAST of all, clean
    # registry): a token-bucket quota refuses an over-quota tenant at
    # admission (typed quota_exceeded shed, zero compute burned), the
    # deficit-weighted queue serves a late-arriving tenant ahead of a
    # deep FIFO backlog, a poisoned tenant's requeues are capped by its
    # retry budget (dispatches <= admitted + budget, exhaustion a typed
    # error), and the serve_tenant_* counters survive the Prometheus
    # exposition round trip.
    from poisson_tpu_torch.serve import (
        BreakerPolicy,
        RetryPolicy,
        SHED_QUOTA_EXCEEDED,
        TenancyPolicy,
    )

    obs_metrics.reset()
    vc24 = VirtualClock()
    # (a) quota: tenant "b" has bucket 2 and submits 4 — two admitted,
    # two refused with zero compute.
    svc24a = SolveService(
        ServicePolicy(capacity=16,
                      tenancy=TenancyPolicy(quota_rate=1e-3,
                                            quota_burst=2.0)),
        clock=vc24, sleep=vc24.sleep, seed=0, device=dev)
    quota_sheds24 = []
    for k in range(4):
        out = svc24a.submit(SolveRequest(request_id=f"q{k}",
                                         problem=problem, tenant="b"))
        if out is not None:
            quota_sheds24.append(out)
    svc24a.drain()
    if len(quota_sheds24) != 2 or any(
            o.shed_reason != SHED_QUOTA_EXCEEDED for o in quota_sheds24):
        return _fail(f"quota admission wrong: "
                     f"{[o.shed_reason for o in quota_sheds24]}")
    if any((o.decomposition or {}).get("compute_s", 1) != 0
           or (o.decomposition or {}).get("dispatches", 1) != 0
           for o in quota_sheds24):
        return _fail("quota shed burned compute")
    if obs_metrics.get("serve.tenant.quota_sheds") != 2:
        return _fail("quota sheds not counted")
    # (b) DWRR fairness: 6 FIFO-queued "big" requests, then 2 from
    # "small" — the fair queue serves small's first request among the
    # first two dispatches instead of position 7.
    svc24b = SolveService(
        ServicePolicy(capacity=16, max_batch=1,
                      tenancy=TenancyPolicy()),
        clock=vc24, sleep=vc24.sleep, seed=0, device=dev)
    for k in range(6):
        svc24b.submit(SolveRequest(request_id=f"big{k}",
                                   problem=problem, tenant="big"))
    for k in range(2):
        svc24b.submit(SolveRequest(request_id=f"small{k}",
                                   problem=problem, tenant="small"))
    order24 = [o.request_id for o in svc24b.drain()]
    if not any(rid.startswith("small") for rid in order24[:2]):
        return _fail(f"fair queue did not promote the starved tenant: "
                     f"{order24}")
    if obs_metrics.get("serve.tenant.promotions") < 1:
        return _fail("tenant promotions not counted")
    # (c) retry budget: every "poison" dispatch dies; its requeues are
    # budget-capped and the exhaustion is a typed transient error.
    from poisson_tpu_torch.serve.types import TransientDispatchError

    def poison24(requests, attempts):
        if any(str(r.request_id).startswith("p") for r in requests):
            raise TransientDispatchError("selfcheck poison")

    budget24 = 2
    svc24c = SolveService(
        ServicePolicy(
            capacity=16,
            retry=RetryPolicy(max_attempts=50, backoff_base=0.01,
                              backoff_cap=0.05),
            breaker=BreakerPolicy(failure_threshold=10**6),
            tenancy=TenancyPolicy(retry_budget=budget24)),
        clock=vc24, sleep=vc24.sleep, seed=0, device=dev,
        dispatch_fault=poison24)
    svc24c.submit(SolveRequest(request_id="p0", problem=problem,
                               tenant="poison"))
    out24 = svc24c.drain()
    disp24 = obs_metrics.get("serve.tenant.dispatches.poison")
    if not (0 < disp24 <= 1 + budget24):
        return _fail(f"retry amplification uncapped: {disp24} dispatches "
                     f"for 1 admitted + budget {budget24}")
    if (obs_metrics.get("serve.tenant.retry_exhausted") != 1
            or len(out24) != 1 or out24[0].kind != "error"):
        return _fail(f"budget exhaustion not a typed error: {out24}")
    parsed24 = export.parse_text(export.render())
    for prom_name in ("poisson_tpu_serve_tenant_quota_sheds",
                      "poisson_tpu_serve_shed_quota_exceeded",
                      "poisson_tpu_serve_tenant_promotions",
                      "poisson_tpu_serve_tenant_retry_exhausted",
                      "poisson_tpu_serve_tenant_dispatches_poison",
                      "poisson_tpu_serve_tenant_share_b",
                      "poisson_tpu_serve_tenant_retry_tokens_poison"):
        if prom_name not in parsed24:
            return _fail(f"exposition lost the {prom_name} metric")

    print(f"obs selfcheck OK: {len(events)} trace events, {span_ends} "
          f"spans, {len(samples)} stream samples, "
          f"{len(counters)} counters, model agreement {agree:.2f}x, "
          f"{n_profile_files} profile files, {len(parsed)} exposition "
          f"metrics, sentinel ok, chaos overload-shed ok "
          f"({report['invariant']['admitted']} admitted, 0 lost), "
          f"continuous batching ok ({int(splices)} splices, "
          f"refill-poison-splice green), flight recorder ok "
          f"(trace {tid} complete, {len(bucket_keys)} histogram "
          f"buckets), solve fleet ok ({int(quarantines)} quarantine, "
          f"{int(recovered)} recovered, journal replay agrees), "
          f"geometry ok ({int(geom_hits)} canvas-cache hits, mixed "
          f"co-batch, no canvas rebuilt), integrity ok "
          f"({int(detections)} detection -> {int(vrestarts)} verified "
          f"restart, 0 false alarms, sdc-verified-restart green), "
          f"multigrid ok ({', '.join(f'{g}: {j}->{m} it' for g, (j, m) in mg_iters.items())}, "
          f"hierarchy cache hit), placement ok ({int(device_losses)} "
          f"device loss -> {int(rebinds)} rebind, 0 lost), program "
          f"contracts ok ({contracts_report['counts']['rules']} rules, "
          f"{contracts_report['counts']['ledger_programs']} ledger "
          f"programs, 0 findings, {contracts_state}), krylov memory ok "
          f"(cold {int(cold20.iterations)} -> warm "
          f"{int(warm20.iterations)} it, {int(saved20)} saved), "
          f"solver sessions ok (warm {warm_it21} vs cold {cold_it21} "
          f"it, boundary replay closed {int(adm21)}/{int(done21)}), "
          f"forecasting ok ({int(preds22)} predictions, p50 err "
          f"{calib22:.1f}%, predicted-deadline shed with 0 compute), "
          f"backend router ok ({int(decisions23)} decisions, {arm23} "
          f"measured at {frac23:.2g}x peak, snapshot round-trip + "
          f"torn-seal audible), tenant fairness ok "
          f"({len(quota_sheds24)} quota sheds at 0 compute, starved "
          f"tenant promoted, poison capped at {int(disp24)} dispatches) "
          f"({out_dir})")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch.obs.selfcheck",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--dir", default=None, metavar="DIR",
                    help="write (and keep) the artifacts here instead of "
                         "a removed temp dir")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the solves run (default: the card)")
    args = ap.parse_args(argv)
    from poisson_tpu_torch.utils.platform import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        return _fail(str(e))
    if args.dir:
        os.makedirs(args.dir, exist_ok=True)
        return run_selfcheck(args.dir, device)
    with tempfile.TemporaryDirectory(prefix="poisson-obs-") as tmp:
        return run_selfcheck(tmp, device)


if __name__ == "__main__":
    sys.exit(main())
