"""The solve service's subcommands: ``python -m poisson_tpu_torch serve``,
``session``, ``chaos`` and ``trace`` (counterpart of the same subcommands of
``poisson_tpu/cli.py``, with the port's ``--device cuda|cpu``).

``serve`` admits a request load into :class:`~poisson_tpu_torch.serve.
SolveService` and reports the typed-outcome taxonomy; ``session`` runs a
durable solver session (:class:`~poisson_tpu_torch.serve.SessionHost`);
``chaos`` runs the chaos campaign (``testing.chaos``) and validates every
admitted request's flight trace from the emitted JSONL; ``trace`` renders
one request's flight trace from a telemetry directory. The flags, the
records and the exit codes are the JAX CLI's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from poisson_tpu_torch.cli import parse_geometry_arg
from poisson_tpu_torch.config import Problem


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch serve",
        description="Solve-service fire drill (poisson_tpu_torch.serve): "
                    "admit a request load, run the lifecycle loop — bounded "
                    "admission, deadlines, retry/backoff, circuit "
                    "breaking, graceful degradation — and report the "
                    "typed-outcome taxonomy with latency percentiles.",
    )
    p.add_argument("M", type=int, help="grid cells in x (nodes: M+1)")
    p.add_argument("N", type=int, help="grid cells in y (nodes: N+1)")
    p.add_argument("--requests", type=int, default=32, metavar="R",
                   help="requests to submit (default 32)")
    p.add_argument("--capacity", type=int, default=64,
                   help="admission queue bound (default 64; submit more "
                        "than this to watch typed overload shedding)")
    p.add_argument("--max-batch", type=int, default=32,
                   help="members per fused batched dispatch (default 32)")
    p.add_argument("--deadline", type=float, default=None, metavar="S",
                   help="per-request deadline in seconds (chunked "
                        "dispatch; expiry returns a partial result)")
    p.add_argument("--chunk", type=int, default=None,
                   help="iterations between deadline checks on chunked "
                        "dispatches (default 50)")
    p.add_argument("--delta", type=float, default=1e-6,
                   help="convergence threshold (default 1e-6)")
    p.add_argument("--max-iter", type=int, default=None,
                   help="iteration cap (default (M-1)(N-1))")
    p.add_argument("--dtype", choices=("float32", "float64"), default=None,
                   help="state precision (default float64)")
    p.add_argument("--vary-rhs", action="store_true",
                   help="give each request a distinct RHS magnitude")
    p.add_argument("--geometry", metavar="SPEC", action="append",
                   default=None,
                   help="geometry-DSL JSON (inline or @file.json); "
                        "repeatable — requests round-robin across the "
                        "specs, forming a mixed-geometry load whose "
                        "families co-batch per bucket executable "
                        "(fingerprints ride the flight traces)")
    p.add_argument("--preconditioner", choices=("jacobi", "mg"),
                   default="jacobi",
                   help="service-wide default M^-1 "
                        "(ServicePolicy.preconditioner): mg runs every "
                        "request with the geometric V-cycle "
                        "(poisson_tpu_torch.mg) in its own :mg cohort family "
                        "— separate bucket executables, breakers and "
                        "sentinel baselines; the grid must coarsen "
                        "(even M and N)")
    p.add_argument("--continuous", action="store_true",
                   help="continuous-batching scheduling: a lane table "
                        "steps the fused program chunk by chunk, "
                        "retires converged lanes to their outcomes and "
                        "splices queued RHS into the freed lanes of the "
                        "same executable (default: batch-drain)")
    p.add_argument("--refill-chunk", type=int, default=25,
                   help="iterations per lane-table step in --continuous "
                        "mode (default 25)")
    p.add_argument("--forecast", action="store_true",
                   help="convergence observatory "
                        "(ServicePolicy.forecast): ETA every admission "
                        "from the per-cohort streaming model, shed "
                        "predicted-dead deadlines at submit (typed "
                        "predicted_deadline, zero compute burned), "
                        "re-forecast lane occupants at chunk "
                        "boundaries, and feed every completion back "
                        "into calibration; with --journal the model "
                        "snapshot persists beside it and --recover "
                        "warm-loads it")
    p.add_argument("--workers", type=int, default=1, metavar="W",
                   help="solve-fleet workers pulling from the shared "
                        "admission queue (serve.fleet; default 1 — the "
                        "classic single-worker service). Each worker "
                        "owns sticky bucket executables, its own "
                        "breaker cohort, and a heartbeat watchdog")
    p.add_argument("--devices", type=int, default=None, metavar="D",
                   help="bind the fleet's workers round-robin to D "
                        "device fault-domain slots (serve.placement): "
                        "sticky executables compile ON the bound "
                        "device, breaker/integrity cohorts key on it, "
                        "and a device loss quarantines the whole "
                        "domain (default: one slot on the process "
                        "device — the pre-placement fleet). Slots share "
                        "the cards round-robin when D exceeds them")
    p.add_argument("--journal", metavar="PATH", default=None,
                   help="write-ahead request journal (serve.journal): "
                        "every lifecycle transition is CRC-sealed and "
                        "appended here, so a crashed run can be "
                        "replayed with --recover")
    p.add_argument("--recover", action="store_true",
                   help="replay --journal before serving: requests "
                        "that were queued or in flight when the "
                        "previous process died are re-enqueued "
                        "(recovered taint/backoff path) and drained to "
                        "their one typed outcome (--requests 0 runs "
                        "recovery alone)")
    p.add_argument("--verify-every", type=int, default=0, metavar="K",
                   help="always-on in-loop integrity verification for "
                        "every dispatch (ServicePolicy.integrity): "
                        "silent-data-corruption detections become typed "
                        "'integrity' retries with suspect-cohort taint; "
                        "0 (default) arms the probe only defensively, "
                        "after a first detection taints the hardware "
                        "cohort")
    p.add_argument("--verify-tol", type=float, default=None,
                   help="relative drift tolerance for the integrity "
                        "probe (default: dtype-aware)")
    p.add_argument("--seed", type=int, default=0,
                   help="backoff-jitter / load RNG seed (default 0)")
    p.add_argument("--fault-poison", type=int, default=0, metavar="K",
                   help="fault injection: mark the first K requests as "
                        "batch-killing poison (typed transient errors "
                        "after retry isolation)")
    p.add_argument("--kill-worker-at", type=float, default=None,
                   metavar="T",
                   help="fault injection: kill the next dispatching "
                        "worker once T seconds of serving have passed "
                        "(quarantine + recovery + restart, "
                        "serve.fleet.*)")
    p.add_argument("--kill-after", type=int, default=None, metavar="K",
                   help="fault injection: flush telemetry and die with "
                        "exit 75 (no cleanup) once K outcomes exist — "
                        "the crash half of the journal drill; restart "
                        "with --recover against the same --journal")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="write the counters/gauges snapshot here at exit")
    p.add_argument("--prom-out", metavar="PATH", default=None,
                   help="write a Prometheus textfile snapshot here at "
                        "exit (serve.* counters included)")
    p.add_argument("--trace-dir", metavar="DIR", default=None,
                   help="write unified telemetry here — including the "
                        "flight recorder's per-request causal traces "
                        "(view one with `python -m poisson_tpu_torch trace "
                        "REQUEST_ID --telemetry DIR`)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of a table")
    return p


def main_serve(argv) -> int:
    args = build_serve_parser().parse_args(argv)
    if args.requests < (0 if args.recover else 1):
        raise SystemExit(f"--requests must be >= 1, got {args.requests} "
                         "(0 is allowed with --recover: recovery-only)")
    if args.capacity < 1:
        raise SystemExit(f"--capacity must be >= 1, got {args.capacity}")
    if args.workers < 1:
        raise SystemExit(f"--workers must be >= 1, got {args.workers}")
    if args.recover and not args.journal:
        raise SystemExit("--recover needs --journal PATH to replay")
    from poisson_tpu_torch import obs

    if args.metrics_out or args.prom_out or args.trace_dir:
        obs.configure(metrics_path=args.metrics_out,
                      prom_path=args.prom_out,
                      trace_dir=args.trace_dir)
    import random as _random

    from poisson_tpu_torch.serve import (
        OUTCOME_ERROR,
        OUTCOME_RESULT,
        OUTCOME_SHED,
        SCHED_CONTINUOUS,
        SCHED_DRAIN,
        FleetPolicy,
        ForecastPolicy,
        ServicePolicy,
        SolveJournal,
        SolveRequest,
        SolveService,
    )

    problem = Problem(M=args.M, N=args.N, delta=args.delta,
                      max_iter=args.max_iter)
    fault = None
    if args.fault_poison:
        from poisson_tpu_torch.testing.faults import poison_batch_fault

        fault = poison_batch_fault(set(range(args.fault_poison)))
    worker_fault = None
    if args.kill_worker_at is not None:
        from poisson_tpu_torch.testing.faults import kill_worker_at

        t_start = time.monotonic()
        worker_fault = kill_worker_at(
            args.kill_worker_at, lambda: time.monotonic() - t_start)
    if args.verify_every < 0:
        raise SystemExit(f"--verify-every must be >= 0, "
                         f"got {args.verify_every}")
    from poisson_tpu_torch.integrity import IntegrityPolicy

    if args.preconditioner == "mg":
        from poisson_tpu_torch.mg import validate_mg_problem

        try:
            validate_mg_problem(problem)
        except ValueError as e:
            raise SystemExit(f"--preconditioner mg: {e}")
    policy = ServicePolicy(
        capacity=args.capacity, max_batch=args.max_batch,
        default_chunk=args.chunk or 50,
        scheduling=(SCHED_CONTINUOUS if args.continuous
                    else SCHED_DRAIN),
        refill_chunk=args.refill_chunk,
        fleet=FleetPolicy(workers=args.workers, devices=args.devices),
        integrity=IntegrityPolicy(verify_every=args.verify_every,
                                  verify_tol=args.verify_tol),
        preconditioner=args.preconditioner,
        forecast=(ForecastPolicy() if args.forecast else None),
    )
    journal = (SolveJournal(args.journal) if args.journal else None)
    if args.recover:
        svc = SolveService.recover(journal, policy, seed=args.seed,
                                   dispatch_fault=fault,
                                   worker_fault=worker_fault,
                                   device=args.device)
        rec_report = svc.recovery
        print(f"serve: recovered {len(rec_report.pending)} pending "
              f"request(s) from {args.journal} "
              f"({len(rec_report.outcomes)} prior outcome(s), "
              f"{rec_report.torn_records} torn record(s) skipped)",
              file=sys.stderr)
    else:
        svc = SolveService(policy, seed=args.seed, dispatch_fault=fault,
                           worker_fault=worker_fault, journal=journal,
                           device=args.device)
    geo_specs = ([parse_geometry_arg(s) for s in args.geometry]
                 if args.geometry else None)
    rng = _random.Random(args.seed)
    t0 = time.perf_counter()
    for i in range(args.requests):
        svc.submit(SolveRequest(
            request_id=i, problem=problem,
            rhs_gate=(1.0 + rng.random() if args.vary_rhs else 1.0),
            dtype=args.dtype, deadline_seconds=args.deadline,
            chunk=args.chunk,
            geometry=(geo_specs[i % len(geo_specs)] if geo_specs
                      else None),
        ))
    if args.kill_after is not None:
        # The crash half of the journal drill: once K outcomes exist,
        # flush telemetry (the metrics snapshot is the accounting
        # evidence) and die like a preemption — exit 75, no cleanup,
        # queue and lane-resident requests abandoned. The journal is
        # what makes the abandonment recoverable.
        import os as _os

        while svc.pump():
            if len(svc.outcomes()) >= args.kill_after:
                obs.finalize()
                _os._exit(75)
    svc.drain()
    wall = time.perf_counter() - t0
    outs = svc.outcomes()
    stats = svc.stats()
    converged = sum(1 for o in outs
                    if o.kind == OUTCOME_RESULT and o.converged)
    partial = sum(1 for o in outs
                  if o.kind == OUTCOME_RESULT and o.partial)
    from poisson_tpu_torch.obs import metrics as _metrics

    record = {
        "M": problem.M, "N": problem.N, "requests": args.requests,
        "scheduling": svc.policy.scheduling,
        "workers": args.workers,
        **({"preconditioner": args.preconditioner}
           if args.preconditioner != "jacobi" else {}),
        **({"geometry_mix": len(geo_specs),
            "geometries": sorted({g.fingerprint for g in geo_specs})}
           if geo_specs else {}),
        "wall_seconds": round(wall, 4),
        "throughput_rps": round(stats["completed"] / wall, 2) if wall
        else None,
        "completed": stats["completed"], "converged": converged,
        "partial": partial, "errors": stats["errors"],
        "shed": stats["shed"], "lost": stats["lost"],
        "recovered": stats["recovered"],
        "shed_rate": round(stats["shed_rate"], 4),
        "latency_seconds": {k: round(v, 4) for k, v in
                            stats["latency_seconds"].items()},
        "breakers": stats["breakers"],
    }
    if args.verify_every or _metrics.get("serve.integrity.detections"):
        record["integrity"] = {
            "verify_every": args.verify_every,
            "detections": _metrics.get("serve.integrity.detections"),
            "retries": _metrics.get("serve.integrity.retries"),
            "suspect_cohorts": _metrics.get(
                "serve.integrity.suspect_cohorts"),
            "errors": _metrics.get("serve.errors.integrity"),
        }
    if args.forecast:
        calib = (svc._forecast.calibration_err_pct()
                 if svc._forecast is not None else None)
        record["forecast"] = {
            "predictions": _metrics.get("obs.forecast.predictions"),
            "predicted_deadline_sheds": _metrics.get(
                "serve.shed.predicted_deadline"),
            "preempted": _metrics.get("serve.forecast.preempted"),
            "calibration_err_pct": (round(calib, 2)
                                    if calib is not None else None),
        }
    if args.workers > 1 or args.kill_worker_at is not None:
        record["fleet"] = {
            "workers": {str(k): v for k, v in stats["workers"].items()},
            "quarantines": _metrics.get("serve.fleet.quarantines"),
            "restarts": _metrics.get("serve.fleet.restarts"),
            "recovered_requests": _metrics.get(
                "serve.fleet.recovered_requests"),
        }
    # Flight-recorder attribution: the p99 is findable, not just a
    # number — its exemplar trace id names the request that paid it,
    # and the slowest requests ride with their latency decompositions.
    from poisson_tpu_torch.serve import p99_exemplar, slowest_requests

    exemplar = p99_exemplar(outs)
    if exemplar is not None:
        record["p99_exemplar"] = exemplar
    record["slowest_requests"] = slowest_requests(outs)
    obs.event("serve.report", **record)
    obs.finalize()
    if args.json:
        print(json.dumps(record))
        return 0 if stats["lost"] == 0 else 1
    lat = record["latency_seconds"]
    print(f"serve: M={problem.M}, N={problem.N} | {args.requests} requests "
          f"in {wall:.2f} s ({record['throughput_rps']} completed/s)")
    print(f"  outcomes: {stats['completed']} results ({converged} "
          f"converged, {partial} partial) | {stats['errors']} typed "
          f"errors | {stats['shed']} shed | lost {stats['lost']}"
          + (f" | recovered {stats['recovered']}"
             if stats["recovered"] else ""))
    print(f"  latency p50/p95/p99: {lat['p50']}/{lat['p95']}/{lat['p99']} "
          f"s | shed rate {record['shed_rate']:.1%}")
    kinds = {}
    for o in outs:
        key = (o.kind if o.kind != OUTCOME_ERROR
               else f"error:{o.error_type}")
        if o.kind == OUTCOME_SHED:
            key = f"shed:{o.shed_reason}"
        kinds[key] = kinds.get(key, 0) + 1
    print("  taxonomy: " + ", ".join(f"{k}={v}"
                                     for k, v in sorted(kinds.items())))
    if exemplar is not None:
        print(f"  p99 exemplar: request {exemplar['request_id']} "
              f"(trace {exemplar['trace_id']}, "
              f"{exemplar['latency_seconds']} s)"
              + (f" — inspect with `python -m poisson_tpu_torch trace "
                 f"{exemplar['request_id']} --telemetry "
                 f"{args.trace_dir}`" if args.trace_dir else ""))
    return 0 if stats["lost"] == 0 else 1



def build_trace_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch trace",
        description="Flight-recorder viewer (obs.flight): render one "
                    "request's causal timeline — admit, queue wait, "
                    "lane residency with chunk steps, backoff/retries, "
                    "the typed outcome, and the latency decomposition — "
                    "from a telemetry directory's JSONL event log.",
    )
    p.add_argument("request_id",
                   help="request id to trace (the LAST matching trace "
                        "when ids recycled across runs)")
    p.add_argument("--telemetry", required=True, metavar="DIR",
                   help="unified-telemetry directory (--trace-dir "
                        "output; the chaos CLI's out-dir/trace)")
    p.add_argument("--trace-id", default=None,
                   help="disambiguate by exact trace id instead of "
                        "request id")
    p.add_argument("--json", action="store_true",
                   help="emit the trace's raw records as JSON lines")
    return p


def main_trace(argv) -> int:
    args = build_trace_parser().parse_args(argv)
    import os

    from poisson_tpu_torch.obs import flight
    from poisson_tpu_torch.obs.trace import load_events

    if not os.path.isdir(args.telemetry):
        print(f"no telemetry directory at {args.telemetry}",
              file=sys.stderr)
        return 1
    events = load_events(args.telemetry)
    tid, records = flight.find_trace(
        events, request_id=args.request_id, trace_id=args.trace_id)
    if tid is None:
        print(f"no flight trace for "
              f"{'trace id ' + args.trace_id if args.trace_id else 'request ' + args.request_id}"
              f" in {args.telemetry}", file=sys.stderr)
        return 1
    if args.json:
        for rec in records:
            print(json.dumps(rec, default=str))
    else:
        print(flight.render_timeline(records))
    # Both modes fail on a broken tree: --json exists for automation,
    # which needs the incomplete-trace signal MORE than a human does.
    problems = flight.validate_trace(records)
    if problems:
        print("INCOMPLETE TRACE: " + "; ".join(problems),
              file=sys.stderr)
        return 1
    return 0



def build_chaos_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch chaos",
        description="Chaos campaign (poisson_tpu_torch.testing.chaos): named, "
                    "seeded, deterministic fault scenarios over the "
                    "solve service and the chunked solvers, asserting "
                    "the no-lost-request invariant from the emitted "
                    "serve.* metrics snapshot. Exit 0 iff every "
                    "scenario's checks hold.",
    )
    p.add_argument("scenarios", nargs="*", metavar="SCENARIO",
                   help="scenario names to run (see --list)")
    p.add_argument("--all", action="store_true",
                   help="run every registered scenario")
    p.add_argument("--seed", type=int, default=0,
                   help="campaign seed (default 0; same seed → same "
                        "outcomes)")
    p.add_argument("--list", action="store_true",
                   help="list scenario names and exit")
    p.add_argument("--out-dir", metavar="DIR", default=None,
                   help="keep per-scenario metrics snapshots (JSON + "
                        "Prometheus text), the campaign report, and the "
                        "flight-recorder JSONL (trace/ subdir) here")
    p.add_argument("--json", action="store_true",
                   help="print the campaign report as JSON")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p


def main_chaos(argv) -> int:
    args = build_chaos_parser().parse_args(argv)
    from poisson_tpu_torch.testing import chaos

    if args.list:
        # Grouped by subsystem: the flat list outgrew readability at
        # ~20 scenarios. Names stay one-per-line (indented) so shell
        # pipelines (grep/awk) keep working on the name column.
        for group, names in chaos.scenario_groups().items():
            print(f"{group}:")
            for name in names:
                print(f"  {name}")
        return 0
    if args.all and args.scenarios:
        raise SystemExit("give scenario names or --all, not both")
    if not args.all and not args.scenarios:
        raise SystemExit("nothing to run: give scenario names or --all "
                         "(--list shows the catalogue)")
    unknown = [n for n in args.scenarios
               if n not in chaos.scenario_names()]
    if unknown:
        raise SystemExit(
            f"unknown scenario(s) {', '.join(unknown)}; known: "
            f"{', '.join(chaos.scenario_names())}"
        )
    # Flight-recorder acceptance rail: the campaign runs with the JSONL
    # recorder on, and afterwards EVERY admitted request's causal trace
    # is validated from the emitted file — one admit root, one typed
    # outcome leaf, no orphan spans, decomposition summing to wall —
    # not from any in-process state. Incomplete traces fail the run.
    import os as _os
    import tempfile as _tempfile

    from poisson_tpu_torch import obs
    from poisson_tpu_torch.obs import flight as _flight
    from poisson_tpu_torch.obs.trace import load_events as _load_events

    tmp_ctx = None
    if args.out_dir:
        flight_dir = _os.path.join(args.out_dir, "trace")
    else:
        tmp_ctx = _tempfile.TemporaryDirectory(
            prefix="poisson-chaos-flight-")
        flight_dir = tmp_ctx.name
    obs.configure(trace_dir=flight_dir)
    try:
        campaign = chaos.run_campaign(
            args.scenarios or None, seed=args.seed, out_dir=args.out_dir,
            device=args.device)
        obs.finalize()
        flight_events = _load_events(flight_dir)
    finally:
        obs.shutdown()
        if tmp_ctx is not None:
            tmp_ctx.cleanup()
    flight_report = _flight.validate_events(flight_events)
    admitted_total = sum(rep["invariant"]["admitted"]
                         for rep in campaign["scenarios"])
    flight_report["admitted"] = admitted_total
    flight_report["ok"] = (flight_report["complete"]
                           and flight_report["traces"] == admitted_total)
    campaign["flight"] = flight_report
    campaign["ok"] = campaign["ok"] and flight_report["ok"]
    if args.json:
        print(json.dumps(campaign))
        return 0 if campaign["ok"] else 1
    for rep in campaign["scenarios"]:
        mark = "ok " if rep["ok"] else "FAIL"
        inv = rep["invariant"]
        line = (f"{mark} {rep['scenario']:28s} admitted={inv['admitted']:3d}"
                f" lost={inv['lost']}")
        failed = [k for k, v in rep["checks"].items() if not v]
        if failed:
            line += "  failed: " + ", ".join(failed)
        print(line)
    fl = campaign["flight"]
    fl_mark = "ok " if fl["ok"] else "FAIL"
    fl_line = (f"{fl_mark} flight recorder: {fl['traces']} causal "
               f"trace(s) for {fl['admitted']} admitted request(s)")
    if fl["problems"]:
        fl_line += f"  incomplete: {sorted(fl['problems'])}"
    print(fl_line)
    verdict = "ok" if campaign["ok"] else "FAILED"
    print(f"chaos campaign {verdict}: {len(campaign['scenarios'])} "
          f"scenario(s), seed {campaign['seed']}")
    if args.out_dir:
        print(f"per-scenario metrics snapshots in {args.out_dir}",
              file=sys.stderr)
    return 0 if campaign["ok"] else 1



def build_session_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch session",
        description="Durable solver session (serve.session): an ordered "
                    "stream of dependent solves — a moving-ellipse "
                    "Poisson schedule, or implicit-Euler heat stepping "
                    "with --heat — admitted through the service with "
                    "warm starts, full journaling, and --recover replay "
                    "to the exact step boundary.")
    p.add_argument("M", type=int, help="grid height")
    p.add_argument("N", type=int, help="grid width")
    p.add_argument("--steps", type=int, default=10, metavar="K",
                   help="total steps in the stream (default 10); with "
                        "--recover, the schedule resumes at the "
                        "journal's committed boundary and runs to the "
                        "SAME total")
    p.add_argument("--heat", action="store_true",
                   help="implicit-Euler heat stepping (A + I/dt) "
                        "instead of the moving-domain Poisson schedule")
    p.add_argument("--dt", type=float, default=0.01,
                   help="implicit-Euler time step for --heat "
                        "(mass shift m = 1/dt; default 0.01)")
    p.add_argument("--drift", type=float, default=5e-4, metavar="D",
                   help="per-step ellipse center drift of the moving-"
                        "domain schedule (default 5e-4 — inside the "
                        "warm validity bound, so warm starts hold)")
    p.add_argument("--session-id", default="cli", metavar="SID",
                   help="stream identity (default 'cli') — what the "
                        "journal and the recovery key on")
    p.add_argument("--journal", metavar="PATH", default=None,
                   help="write-ahead journal for the stream AND its "
                        "steps (serve.journal)")
    p.add_argument("--recover", action="store_true",
                   help="replay --journal first: re-open the stream at "
                        "its committed step boundary (mid-step work "
                        "re-enqueued COLD by the service's recovery) "
                        "and finish the schedule")
    p.add_argument("--kill-after", type=int, default=None, metavar="K",
                   help="fault injection: die with exit 75 (no cleanup) "
                        "mid-dispatch of step K — after its submit hit "
                        "the journal, before its outcome; restart with "
                        "--recover against the same --journal")
    p.add_argument("--seed", type=int, default=0,
                   help="service RNG seed (default 0)")
    p.add_argument("--metrics-out", metavar="PATH", default=None,
                   help="write the counters/gauges snapshot here at "
                        "exit (the merged-ledger evidence of the "
                        "kill/recover drill)")
    p.add_argument("--trace-dir", metavar="DIR", default=None,
                   help="unified telemetry incl. the session's flight "
                        "trace (one causal tree spanning the stream)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of a table")
    return p


def main_session(argv) -> int:
    args = build_session_parser().parse_args(argv)
    if args.steps < 1:
        raise SystemExit(f"--steps must be >= 1, got {args.steps}")
    if args.recover and not args.journal:
        raise SystemExit("--recover needs --journal PATH to replay")
    if args.kill_after is not None and not args.journal:
        raise SystemExit("--kill-after without --journal would lose the "
                         "stream — the drill needs the journal")
    from poisson_tpu_torch import obs

    if args.metrics_out or args.trace_dir:
        obs.configure(metrics_path=args.metrics_out,
                      trace_dir=args.trace_dir)
    from poisson_tpu_torch.geometry.dsl import Ellipse
    from poisson_tpu_torch.serve import (
        OUTCOME_RESULT,
        SessionHost,
        SolveJournal,
        SolveService,
    )

    problem = Problem(M=args.M, N=args.N)
    m = (1.0 / args.dt) if args.heat else 0.0
    kind = "heat" if args.heat else "poisson"

    def schedule(k: int):
        """Step k's geometry — pure in the step index, so a recovery
        recomputes the schedule from the committed boundary alone."""
        if args.heat:
            return Ellipse()
        return Ellipse(cx=args.drift * k, cy=0.0, rx=1.0, ry=1.0)

    fault = None
    if args.kill_after is not None:
        import os as _os

        kill_at = args.kill_after

        def fault(requests, attempts):
            # Die mid-dispatch of step K: its session_step + submit
            # records are journaled, its outcome is not — the genuine
            # mid-step crash the recovery contract covers.
            for r in requests:
                if (r.session_step is not None
                        and r.session_step >= kill_at):
                    obs.finalize()
                    _os._exit(75)

    journal = SolveJournal(args.journal) if args.journal else None
    t0 = time.perf_counter()
    if args.recover:
        svc = SolveService.recover(journal, seed=args.seed,
                                   dispatch_fault=fault,
                                   device=args.device)
        host = SessionHost(svc)
        recovered = host.recover()
        sess = next((s for s in recovered
                     if s.session_id == args.session_id), None)
        if sess is None:
            print(f"session: no open stream {args.session_id!r} in "
                  f"{args.journal} — nothing to recover",
                  file=sys.stderr)
            return 1
        print(f"session: recovered {sess.session_id!r} at step "
              f"boundary {sess.advanced} (generation "
              f"{sess.generation}); continuing cold", file=sys.stderr)
    else:
        svc = SolveService(seed=args.seed, journal=journal,
                           dispatch_fault=fault, device=args.device)
        host = SessionHost(svc)
        sess = host.open(args.session_id, problem, kind=kind,
                         geometry=schedule(0), mass_shift=m,
                         params={"steps": args.steps,
                                 "drift": args.drift})
        if sess is None:
            print("session: open was shed", file=sys.stderr)
            return 1
    outs = []
    while sess.next_step < args.steps:
        outs.append(host.step(sess, geometry=schedule(sess.next_step)))
    summary = host.close(sess)
    obs.finalize()
    wall = time.perf_counter() - t0
    from poisson_tpu_torch.obs import metrics as _metrics

    stats = svc.stats()
    results = sum(1 for o in outs if o.kind == OUTCOME_RESULT)
    record = {
        "M": problem.M, "N": problem.N, "kind": kind,
        "session_id": sess.session_id,
        "steps": summary["steps"], "errors": summary["errors"],
        "steps_run": len(outs), "results": results,
        "slo_good": summary["slo_good"],
        "generation": sess.generation,
        "warm_hits": _metrics.get("session.warm.hits"),
        "warm_fallbacks": _metrics.get("session.warm.fallbacks"),
        "recovered_requests": stats["recovered"],
        "lost": stats["lost"],
        "wall_seconds": round(wall, 4),
        "trace_id": summary["trace_id"],
    }
    if args.json:
        print(json.dumps(record))
    else:
        print(f"session: {kind} stream {sess.session_id!r} | "
              f"{record['steps_run']} step(s) run to "
              f"{summary['steps']} total in {wall:.2f} s")
        print(f"  warm: {record['warm_hits']} hit(s), "
              f"{record['warm_fallbacks']} fallback(s) | errors "
              f"{summary['errors']} | lost {stats['lost']} | "
              f"SLO {'good' if summary['slo_good'] else 'bad'}")
    return 0 if (stats["lost"] == 0 and summary["errors"] == 0) else 1

