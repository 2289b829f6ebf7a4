"""Benchmark records in ``bench.py``'s shape (counterpart of the repo's
``bench.py``, every mode)::

    python -m poisson_tpu_torch.bench [M N] [--device cuda|cpu] [--out PATH]
        [--batch B | --preconditioner jacobi|mg | --verify-every K |
         --krylov-block B | --session STEPS |
         --serve R [--router] [--arrival-rate L]
                   [--workers W [--devices D] [--kill-worker-at T]
                                [--kill-device-at T]]
                   [--geometry-mix K | --repeat-fingerprint K |
                    --tenants NAME:WEIGHT,...]]

Each run prints one JSON record (and writes it to ``--out``) that
``benchmarks/regress.py`` loads: ``{"metric", "value", "unit", …,
"detail": {…}}`` with the JAX bench's keys. The port's records carry
``platform: "gpu"`` and the port's backend names (``fused``, ``torch``,
``torch_batched``, ``torch_serve``, ``torch_session``), so they land in
cohorts of their own and never judge a TPU record, nor the reverse. The
command line takes ``bench.py``'s options with its rules and refusal
messages (exit 2); ``--device`` (default ``cuda``) is the port's own.

- **Default mode**: the flagship solve (800×1200 unless a grid is given) on
  the backend the CLI's ``auto`` picks on one card for fp32, ``fused``
  (kernels A and B): MLUPS against the reference's stage-4 P100 figures
  (``STAGE4_1GPU_MLUPS``, published by the reference), and the ``costs``
  block (``obs.costs.bench_costs``): the counted plain iteration beside
  the analytic model, and the roofline of the measured run with the fused
  kernels' bytes (``obs.costs.iteration_bytes``).
- ``--batch B``: B fp32 solves of one operator in one ``solve_batched``
  against one ``pcg_solve``, solves per second and the speedup over B
  sequential solves (default grid 400×600).
- ``--preconditioner jacobi|mg``: the Jacobi and MG fp32 plain solves in
  one record, headed by the one asked for (default grid 400×600).
- ``--verify-every K``: the plain fp32 solve without and with the
  integrity probe every K iterations, headed by the verified one (default
  grid 400×600).
- ``--krylov-block B``: the block recurrence against B independent
  members on one clustered batch, ``iteration_cut`` at the same L2 floor.
- ``--session STEPS``: a moving-ellipse ``SessionHost`` stream against
  the same steps solved cold, ``session.steps_per_sec`` (default grid
  300×450).
- ``--serve R``: the service's p99 under fault load (one poison member
  per 16 requests), ``serve.p99_latency``; with ``--arrival-rate L`` one
  seeded Poisson schedule under the drain and the continuous engines,
  ``serve.sustained_solves_per_sec``; ``--workers``, ``--geometry-mix``,
  ``--repeat-fingerprint`` and ``--tenants`` are open-loop variants of
  it (worker and device churn, mixed geometry families, repeats through
  the deflation cache, mixed tenants); ``--router`` labels the plain and
  open-loop runs with the router's decisions.

Timing: the warm-up solve (kernel build and load, canvas setup) is
``first_run_seconds``; then the best of :data:`REPEATS` solves, each fenced
with ``torch.cuda.synchronize()``. The JAX bench's chained K_HI − K_LO
slope cancels a remote TPU's constant fetch latency, which a local card
does not have, so it is not used (``detail.timing`` says so). The
flagship's warm-up count must lie within max(5, golden ÷ 100) of the
golden count (``GOLDEN_ITERS``) or the run fails. There is no fallback:
without a card the command exits non-zero; a failing kernel fails the
run. The serve modes time their open-loop runs on the wall clock after a
warm-up (:func:`_warm_serve_buckets`); ``--krylov-block`` takes the best of
:data:`REPEATS` per arm and ``--session`` times each arm once.

Telemetry is env-driven as in the JAX bench (``obs.configure_from_env``):
``POISSON_TPU_PROFILE_DIR`` captures one extra, untimed solve after the
timed ones.
"""

from __future__ import annotations

import json
import random
import sys
import time
from typing import Optional

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics

# The reference's stage-4 single-GPU (Tesla P100) MLUPS per grid, as its
# publication gives them (BASELINE.md): 989 iterations in 0.83 s at
# 800×1200, 1858 in 4.85 s, 2449 in 13.24 s.
STAGE4_1GPU_MLUPS = {
    (800, 1200): 1141.0,
    (1600, 2400): 1470.0,
    (2400, 3200): 1419.0,
}
# Golden iteration counts: the warm-up gate.
GOLDEN_ITERS = {
    (400, 600): 546, (800, 1200): 989,
    (1600, 2400): 1858, (2400, 3200): 2449,
}
REPEATS = 3
FLAGSHIP = (800, 1200)
MODE_GRID = (400, 600)     # the default grid of the other modes
TIMING = ("best of 3 solves after one warm-up, each fenced with "
          "torch.cuda.synchronize(); no chained K_HI-K_LO slope (that "
          "cancels a remote TPU's fetch latency, which a local card has "
          "not)")
DTYPE = "float32"


def warmup_gate(problem: Problem, iterations: int) -> None:
    """``bench.py``'s golden warm-up gate: a count farther than
    max(5, golden ÷ 100) from the grid's golden count fails the run (fp32
    sum order moves the largest grids' counts by O(0.1%); 1% still catches
    a broken kernel)."""
    golden = GOLDEN_ITERS.get((problem.M, problem.N))
    if golden is not None and abs(iterations - golden) > max(5,
                                                             golden // 100):
        raise RuntimeError(
            f"suspect iterations {iterations} at {problem.M}x{problem.N} "
            f"(golden {golden})")


def _platform(device) -> str:
    return "gpu" if device.type == "cuda" else "cpu"


def best_of(run, device, repeats: int = REPEATS):
    """(best seconds, last result) over ``repeats`` fenced calls."""
    from poisson_tpu_torch.utils.timing import fence

    best, result = None, None
    for _ in range(repeats):
        fence(device)
        t0 = time.perf_counter()
        result = run()
        fence(device)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, result


def _common_detail(problem: Problem, device, backend: str) -> dict:
    from poisson_tpu_torch.utils.platform import device_name

    return {
        "grid": [problem.M, problem.N],
        "dtype": DTYPE,
        "backend": backend,
        "devices": 1,
        "platform": _platform(device),
        "device_kind": device_name(device),
        "platform_fallback": False,
        "timing": TIMING,
    }


def _profile(name: str, run, device) -> None:
    """One extra, untimed run under the profiler when a capture directory
    is configured."""
    from poisson_tpu_torch.obs import profile
    from poisson_tpu_torch.utils.timing import fence

    if profile.enabled():
        with profile.capture(name):
            run()
            fence(device)


def flagship_record(problem: Problem, device) -> dict:
    """The default mode's record: the fused fp32 solve of ``problem`` on
    ``device``, gated, timed and attributed. The partials are summed in
    the default (parallel) layout: ``serial_reduce`` is false."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.analysis import l2_error_host
    from poisson_tpu_torch.obs.costs import bench_costs, iteration_bytes
    from poisson_tpu_torch.ops.fused_cg import fused_cg_solve
    from poisson_tpu_torch.utils.timing import mlups

    backend = "fused"
    run = lambda: fused_cg_solve(problem, device=device)
    with obs.span("bench.warmup_compile", fence=False,
                  grid=f"{problem.M}x{problem.N}"):
        first, result = best_of(run, device, 1)
    warmup_gate(problem, int(result.iterations))
    obs.inc("time.compile_seconds", first)
    with obs.span("bench.timed_solves", fence=False, repeats=REPEATS):
        best, result = best_of(run, device)
    obs.inc("time.execute_seconds", best)
    iters = int(result.iterations)
    value = mlups(problem, iters, best)
    baseline = STAGE4_1GPU_MLUPS.get((problem.M, problem.N))
    detail = _common_detail(problem, device, backend)
    detail.update({
        "iterations": iters,
        "solve_seconds": round(best, 6),
        "first_run_seconds": round(first, 3),
        "final_diff": float(result.diff),
        "l2_error_vs_analytic": l2_error_host(problem, result.w),
        "serial_reduce": False,
    })
    record = {
        "metric": "mlups",
        "value": round(value, 1),
        "unit": "MLUPS",
        "vs_baseline": round(value / baseline, 3) if baseline else None,
        "detail": detail,
    }
    costs = bench_costs(
        problem, dtype=DTYPE, backend=backend, iterations=iters,
        solve_seconds=best, device_kind=detail["device_kind"], devices=1,
        device=device, bytes_per_iter=iteration_bytes(problem, backend))
    if costs:
        record["costs"] = costs
    _profile("bench.solve", run, device)
    obs.gauge("bench.mlups", record["value"])
    obs.gauge("bench.vs_baseline", record["vs_baseline"])
    obs.event("bench.record", **detail, mlups=record["value"])
    return record


def batched_record(problem: Problem, batch: int, device) -> dict:
    """``--batch B``: one ``solve_batched`` of B fp32 members against one
    ``pcg_solve``; iteration parity per member is reported, not
    assumed."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.obs.costs import bench_costs
    from poisson_tpu_torch.solvers.batched import bucket_size, solve_batched
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve

    if batch < 1:
        raise ValueError(f"--batch must be >= 1, got {batch}")
    ones = [1.0] * batch
    run_b = lambda: solve_batched(problem, rhs_gates=ones, dtype=DTYPE,
                                  device=device)
    run_s = lambda: pcg_solve(problem, dtype=DTYPE, rhs_gate=1.0,
                              device=device)
    with obs.span("bench.batched_warmup", fence=False, batch=batch):
        first_b, bat = best_of(run_b, device, 1)
        first_s, seq = best_of(run_s, device, 1)
    obs.inc("time.compile_seconds", first_b + first_s)
    member_iters = [int(k) for k in bat.iterations.tolist()]
    seq_iters = int(seq.iterations)
    match = all(k == seq_iters for k in member_iters)
    if not match:
        print(f"bench: batched per-member iterations {member_iters} != "
              f"sequential {seq_iters}", file=sys.stderr)
    with obs.span("bench.batched_timed", fence=False, batch=batch):
        tb, bat = best_of(run_b, device)
        ts, _ = best_of(run_s, device)
    detail = _common_detail(problem, device, "torch_batched")
    detail.update({
        "batch": batch,
        "bucket": bucket_size(batch),
        "iterations": seq_iters,
        "iterations_match_sequential": match,
        "converged": sum(1 for f in bat.flag.tolist()
                         if int(f) == FLAG_CONVERGED),
        "batch_seconds": round(tb, 6),
        "sequential_solve_seconds": round(ts, 6),
        "first_run_seconds": round(first_b + first_s, 3),
    })
    record = {
        "metric": "batched_solves_per_sec",
        "value": round(batch / tb, 2),
        "unit": "solves/sec",
        "speedup_vs_sequential": round(ts * batch / tb, 3),
        "detail": detail,
    }
    costs = bench_costs(problem, dtype=DTYPE, backend="torch_batched",
                        iterations=seq_iters * batch, solve_seconds=tb,
                        device_kind=detail["device_kind"], device=device)
    if costs:
        record["costs"] = costs
    _profile("bench.batched", run_b, device)
    obs.gauge("bench.batched_solves_per_sec", record["value"])
    obs.gauge("bench.batched_speedup", record["speedup_vs_sequential"])
    obs.event("bench.batched", **detail, solves_per_sec=record["value"],
              speedup=record["speedup_vs_sequential"])
    return record


def verify_record(problem: Problem, verify_every: int, device) -> dict:
    """``--verify-every K``: the plain fp32 solve without and with the
    integrity probe; the value is the verified arm's MLUPS."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.solvers.pcg import pcg_solve, resolve_verify_tol
    from poisson_tpu_torch.utils.timing import mlups

    if verify_every < 1:
        raise ValueError(f"--verify-every must be >= 1, got {verify_every}")
    base_run = lambda: pcg_solve(problem, dtype=DTYPE, device=device)
    ver_run = lambda: pcg_solve(problem, dtype=DTYPE, device=device,
                                verify_every=verify_every)
    with obs.span("bench.verify_warmup", fence=False,
                  verify_every=verify_every):
        first_b, _ = best_of(base_run, device, 1)
        first_v, _ = best_of(ver_run, device, 1)
    obs.inc("time.compile_seconds", first_b + first_v)
    with obs.span("bench.verify_timed", fence=False,
                  verify_every=verify_every):
        base_s, base = best_of(base_run, device)
        ver_s, ver = best_of(ver_run, device)
    base_mlups = mlups(problem, int(base.iterations), base_s)
    ver_mlups = mlups(problem, int(ver.iterations), ver_s)
    overhead = round(max(0.0, 1.0 - ver_mlups / base_mlups), 4)
    detail = _common_detail(problem, device, "torch")
    detail.update({
        "iterations": int(ver.iterations),
        "iterations_baseline": int(base.iterations),
        "solve_seconds": round(ver_s, 6),
        "first_run_seconds": round(first_b + first_v, 3),
        "verify_every": verify_every,
        "verify_overhead": {
            "verify_tol": resolve_verify_tol(None, DTYPE),
            "baseline_mlups": round(base_mlups, 1),
            "verified_mlups": round(ver_mlups, 1),
            "baseline_solve_seconds": round(base_s, 6),
            "verified_solve_seconds": round(ver_s, 6),
            "overhead_fraction": overhead,
            "checks_per_solve": int(ver.iterations) // verify_every,
        },
    })
    obs.gauge("bench.verify_overhead_fraction", overhead)
    obs.event("bench.verify_record", grid=f"{problem.M}x{problem.N}",
              verify_every=verify_every, mlups=round(ver_mlups, 1),
              baseline_mlups=round(base_mlups, 1),
              overhead_fraction=overhead)
    return {"metric": "mlups", "value": round(ver_mlups, 1),
            "unit": "MLUPS", "detail": detail}


def preconditioner_record(problem: Problem, preconditioner: str,
                          device) -> dict:
    """``--preconditioner jacobi|mg``: both plain fp32 arms in one record,
    headed by ``preconditioner``'s."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.mg.hierarchy import (
        DEFAULT_MG,
        validate_mg_problem,
    )
    from poisson_tpu_torch.obs.costs import mg_vcycle_cost
    from poisson_tpu_torch.solvers.pcg import pcg_solve
    from poisson_tpu_torch.utils.timing import mlups

    if preconditioner not in ("jacobi", "mg"):
        raise ValueError(f"--preconditioner takes jacobi or mg, got "
                         f"{preconditioner!r}")
    validate_mg_problem(problem)
    jac_run = lambda: pcg_solve(problem, dtype=DTYPE, device=device)
    mg_run = lambda: pcg_solve(problem, dtype=DTYPE, device=device,
                               preconditioner="mg")
    with obs.span("bench.preconditioner_warmup", fence=False,
                  preconditioner=preconditioner):
        first_j, _ = best_of(jac_run, device, 1)
        first_m, _ = best_of(mg_run, device, 1)   # the hierarchy build too
    obs.inc("time.compile_seconds", first_j + first_m)
    with obs.span("bench.preconditioner_timed", fence=False):
        jac_s, rj = best_of(jac_run, device)
        mg_s, rm = best_of(mg_run, device)
    jac_mlups = mlups(problem, int(rj.iterations), jac_s)
    mg_mlups = mlups(problem, int(rm.iterations), mg_s)
    cycle = mg_vcycle_cost(problem.M, problem.N, 4, DEFAULT_MG)
    mg_head = preconditioner == "mg"
    detail = _common_detail(problem, device, "torch")
    detail.update({
        "iterations": int((rm if mg_head else rj).iterations),
        "solve_seconds": round(mg_s if mg_head else jac_s, 6),
        "first_run_seconds": round(first_j + first_m, 3),
        "preconditioner": preconditioner,
        "preconditioner_ab": {
            "jacobi": {"iterations": int(rj.iterations),
                       "solve_seconds": round(jac_s, 6),
                       "mlups": round(jac_mlups, 1)},
            "mg": {"iterations": int(rm.iterations),
                   "solve_seconds": round(mg_s, 6),
                   "mlups": round(mg_mlups, 1),
                   "levels": cycle["levels"],
                   "coarse_dense": cycle["coarse_dense"],
                   "vcycle_passes_model": round(
                       cycle["passes_fine_equivalent"], 2)},
            "iteration_ratio": round(
                int(rj.iterations) / max(1, int(rm.iterations)), 2),
            "speedup": round(jac_s / mg_s, 2),
        },
    })
    obs.event("bench.preconditioner_record",
              grid=f"{problem.M}x{problem.N}", preconditioner=preconditioner,
              jacobi_iterations=int(rj.iterations),
              mg_iterations=int(rm.iterations),
              speedup=detail["preconditioner_ab"]["speedup"])
    return {"metric": "mlups",
            "value": round(mg_mlups if mg_head else jac_mlups, 1),
            "unit": "MLUPS", "detail": detail}


# -- the service, Krylov-block and session modes ------------------------

SERVE_MAX_BATCH = 4        # the open-loop modes' max_batch
SERVE_REFILL_CHUNK = 50    # ... and their continuous engine's refill chunk
SESSION_GRID = (300, 450)  # the --session mode's default grid
SESSION_DRIFT = 1e-4       # its moving ellipse's cx step


def _quiet_degradation():
    """Degradation thresholds no run reaches: a record that compares
    engines, families or tenants must not have the ladder fire
    differently between its arms."""
    from poisson_tpu_torch.serve import DegradationPolicy

    return DegradationPolicy(shrink_padding_at=9.0, cap_iterations_at=9.0,
                             downshift_precision_at=9.0)


def _serve_retry(max_attempts: int = 2):
    from poisson_tpu_torch.serve import RetryPolicy

    return RetryPolicy(max_attempts=max_attempts, backoff_base=0.01,
                       backoff_cap=0.1)


def _serve_detail(problem: Problem, device, devices: int = 1) -> dict:
    """The identity keys every serve record carries (``bench.py``'s, with
    the port's platform and backend names)."""
    from poisson_tpu_torch.utils.platform import device_name

    return {
        "dtype": DTYPE,
        "backend": "torch_serve",
        "devices": devices,
        "platform": _platform(device),
        "device_kind": device_name(device),
        "platform_fallback": False,
    }


def _warm_serve_buckets(problem: Problem, device, max_batch: int,
                        requests: int, refill_chunk=None, exact_sizes=(),
                        geometry=None, devices=()) -> list:
    """Run every bucket width a serve-mode schedule can form once, outside
    the timers (``bench.py``'s ``_warm_serve_buckets``).

    The JAX bench compiles one executable per bucket here. The port has
    no executable to compile: this warm-up builds the host canvases (and
    ``geometry``'s, for the ``--geometry-mix`` family), fills the card's
    allocator pools and loads the libraries a first solve of each width
    touches, so no timed request pays for them. A zero ``rhs_gate``
    converges at the first iteration, so each width costs one masked
    iteration. ``refill_chunk`` also runs one splice → step → retire
    cycle of the continuous engine's lanes per width; ``exact_sizes``
    adds the padding-shrink step's exact widths to the power-of-two
    ladder; ``devices`` warms each distinct backing device of a
    ``--devices`` fleet. Returns the ladder."""
    from poisson_tpu_torch.solvers.batched import bucket_size, solve_batched
    from poisson_tpu_torch.solvers.lanes import LaneBatch
    from poisson_tpu_torch.utils.timing import fence

    top = bucket_size(min(max_batch, max(1, requests)))
    ladder, b = [], 1
    while b <= top:
        ladder.append(b)
        b *= 2
    ladder = sorted(set(ladder) | {int(s) for s in exact_sizes
                                   if 1 <= int(s) <= max_batch})
    targets = list(dict.fromkeys(devices)) or [device]
    for dev in targets:
        for b in ladder:
            solve_batched(problem, rhs_gates=[0.0] * b, dtype=DTYPE,
                          bucket=b, device=dev,
                          geometries=(None if geometry is None
                                      else [geometry] * b))
            if refill_chunk is not None:
                lanes = LaneBatch(problem, b, dtype=DTYPE,
                                  chunk=refill_chunk,
                                  multi_geometry=geometry is not None,
                                  device=dev)
                lanes.splice("warmup", 0.0, geometry=geometry)
                lanes.step()
                lanes.retire(0)
        fence(dev)
    return ladder


def _poisson_schedule(requests: int, rate: float, seed: int = 0) -> list:
    """A seeded open-loop arrival schedule of ``(t_arrival, request_id,
    rhs_gate)`` at Poisson rate ``rate`` per second: ``bench.py``'s draws,
    so both packages offer the same load for the same seed."""
    rng = random.Random(seed)
    schedule, t = [], 0.0
    for i in range(requests):
        t += rng.expovariate(rate)
        schedule.append((t, i, 1.0 + rng.random()))
    return schedule


def _zipf_families(requests: int, k: int, seed: int = 0) -> list:
    """A Zipf-ish family index per request (rank r with weight 1/(r+1)
    over K families, seeded): the repeat-fingerprint traffic."""
    rng = random.Random(seed)
    weights = [1.0 / (r + 1) for r in range(k)]
    return rng.choices(range(k), weights=weights, k=requests)


def _tenant_draws(spec, requests: int) -> list:
    """The tenant of each request, drawn (seeded) in proportion to the
    spec's weights, as ``bench.py``'s tenant mode draws them."""
    names = [name for name, _ in spec]
    weights = [weight for _, weight in spec]
    return random.Random(1).choices(names, weights=weights, k=requests)


def _geometry_families(k: int) -> list:
    """K deterministic geometry families (``bench.py``'s): one per DSL node
    type first, then parameterized ellipses. Family 0 is the reference
    domain as an explicit spec."""
    from poisson_tpu_torch.geometry import Ellipse, Polygon, Rectangle, Union

    fams = [
        Ellipse(),
        Ellipse(cx=0.15, cy=-0.05, rx=0.6, ry=0.35),
        Rectangle(-0.7, -0.4, 0.5, 0.3),
        Union((Rectangle(-0.85, -0.35, -0.15, 0.25),
               Rectangle(0.1, -0.3, 0.8, 0.3))),
        Polygon(((-0.6, -0.35), (0.6, -0.35), (0.7, 0.0), (0.0, 0.4),
                 (-0.7, 0.05))),
        Rectangle(-0.3, -0.45, 0.35, 0.45),
    ]
    i = 0
    while len(fams) < k:
        fams.append(Ellipse(cx=-0.25 + 0.1 * i, cy=0.0,
                            rx=0.35 + 0.05 * i, ry=0.25 + 0.03 * i))
        i += 1
    return fams[:k]


def _tenant_mix_string(spec) -> str:
    """Canonical ``name:weight`` form of a parsed tenant spec (the cohort
    string: ``a:1,b:4`` and ``a:1.0,b:4.0`` are one experiment)."""
    return ",".join(f"{name}:{weight:g}" for name, weight in spec)


def _drive_open_loop(svc, schedule, problem: Problem, t0=None,
                     geometries=None, tenants=None):
    """Submit ``schedule`` on the wall clock (arrivals never wait for the
    service), pump between arrivals, sleep in small steps until the next
    one is due, then drain. Returns ``(stats, makespan_seconds)``.
    ``geometries`` round-robins arrivals over geometry families,
    ``tenants`` (indexed by request id) stamps each with its tenant."""
    from poisson_tpu_torch.serve import SolveRequest

    if t0 is None:
        t0 = time.perf_counter()
    i = 0
    while True:
        now = time.perf_counter() - t0
        while i < len(schedule) and schedule[i][0] <= now:
            _, rid, gate = schedule[i]
            svc.submit(SolveRequest(
                request_id=rid, problem=problem, rhs_gate=gate,
                dtype=DTYPE,
                geometry=(geometries[rid % len(geometries)]
                          if geometries else None),
                tenant=tenants[rid] if tenants else None))
            i += 1
        if svc.pump():
            continue
        if i >= len(schedule):
            break
        wait = schedule[i][0] - (time.perf_counter() - t0)
        if wait > 0:
            time.sleep(min(wait, 0.005))
    svc.drain()
    return svc.stats(), time.perf_counter() - t0


def _serve_p99_exemplar(svc):
    from poisson_tpu_torch.serve import p99_exemplar

    return p99_exemplar(svc.outcomes())


def _forecast_calibration(svc):
    """The p50 absolute iteration-forecast error (%) of the service's
    forecaster over this run, or None before any observation."""
    model = getattr(svc, "_forecast", None)
    if model is None:
        return None
    err = model.calibration_err_pct()
    return None if err is None else round(err, 2)


def _serve_slowest(svc, n: int = 3):
    from poisson_tpu_torch.serve import slowest_requests

    return slowest_requests(svc.outcomes(), n)


def _router_policy(enabled: bool, device):
    """The serve records' ``RouterPolicy`` (``--router``), or None. Off
    the card the kernel arms are force-listed so the routing state
    machine runs; on the card they are there. Either way the execution
    gate runs every dispatch on the ``torch`` arm
    (``serve.router.executor_backend``), so routing changes labels, never
    latencies."""
    if not enabled:
        return None
    from poisson_tpu_torch.serve import RouterPolicy

    assume = () if device.type == "cuda" else ("resident", "ca")
    return RouterPolicy(assume_available=assume)


def _router_detail(svc):
    """The router's decisions, mispredictions, demotions and measured
    roofline fractions for the record (attribution only: the cohort key
    carries ``routed_backend``)."""
    router = getattr(svc, "_router", None)
    if router is None:
        return None
    detail = router.stats()
    roofline = getattr(svc, "_roofline", None)
    if roofline is not None:
        err = roofline.calibration_err_pct()
        detail["roofline_calibration_err_pct"] = (
            None if err is None else round(err, 2))
    return detail


def serve_record(problem: Problem, requests: int, device,
                 router: bool = False, keep: Optional[dict] = None):
    """``--serve R``: the service's latency under fault load, one poison
    member per 16 requests (``bench.py``'s ``_serve_bench``): the p99 of
    a faulty fleet, retries and isolation included. ``detail.fault_load``
    names the mix. One warm-up campaign runs first, untimed. Returns
    ``(record, ok)``; ``keep`` (a dict) receives the timed service as
    ``keep["service"]``."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.serve import (
        ForecastPolicy,
        ServicePolicy,
        SolveRequest,
        SolveService,
    )
    from poisson_tpu_torch.testing.faults import poison_batch_fault
    from poisson_tpu_torch.utils.timing import fence

    n_poison = max(1, requests // 16)
    fault_load = f"poison{n_poison}"
    policy = ServicePolicy(
        capacity=max(requests, 1), max_batch=32, retry=_serve_retry(),
        forecast=ForecastPolicy(), router=_router_policy(router, device))

    def build():
        return SolveService(policy, seed=0, device=device,
                            dispatch_fault=poison_batch_fault(
                                set(range(n_poison))))

    def load(svc):
        rng = random.Random(0)
        for i in range(requests):
            svc.submit(SolveRequest(request_id=i, problem=problem,
                                    rhs_gate=1.0 + rng.random(),
                                    dtype=DTYPE))
        svc.drain()
        fence(device)
        return svc

    with obs.span("bench.serve_warmup", fence=False, requests=requests):
        t0 = time.perf_counter()
        # The ladder, plus the exact widths the padding-shrink step forms
        # when the burst fills the queue (capacity == requests).
        exact, s = set(), requests
        while s > 0 and (s / policy.capacity
                         >= policy.degradation.shrink_padding_at):
            b = min(s, policy.max_batch)
            exact.add(b)
            s -= b
        _warm_serve_buckets(problem, device, policy.max_batch, requests,
                            exact_sizes=exact)
        load(build())
        first_run = time.perf_counter() - t0
    obs.inc("time.compile_seconds", first_run)
    with obs.span("bench.serve_timed", fence=False, requests=requests):
        t0 = time.perf_counter()
        svc = load(build())
        wall = time.perf_counter() - t0
    if keep is not None:
        keep["service"] = svc
    stats = svc.stats()
    lat = stats["latency_seconds"]
    record = {
        "metric": "serve.p99_latency",
        "value": round(lat["p99"], 4),
        "unit": "seconds",
        "detail": {
            "grid": [problem.M, problem.N],
            "requests": requests,
            "completed": stats["completed"],
            "errors": stats["errors"],
            "shed": stats["shed"],
            "lost": stats["lost"],
            "shed_rate": round(stats["shed_rate"], 4),
            "p50_seconds": round(lat["p50"], 4),
            "p95_seconds": round(lat["p95"], 4),
            "p99_exemplar": _serve_p99_exemplar(svc),
            "slowest_requests": _serve_slowest(svc),
            "forecast_calibration_err_pct": _forecast_calibration(svc),
            "router": _router_detail(svc),
            "routed_backend": "auto" if router else "off",
            "throughput_rps": round(stats["completed"] / wall, 2),
            "wall_seconds": round(wall, 4),
            "first_run_seconds": round(first_run, 2),
            **_serve_detail(problem, device),
            "fault_load": fault_load,
        },
    }
    obs.event("bench.serve", **record["detail"],
              p99_latency=record["value"])
    return record, stats["lost"] == 0


def serve_openloop_record(problem: Problem, requests: int, rate: float,
                          device, router: bool = False,
                          keep: Optional[dict] = None):
    """``--serve R --arrival-rate L``: one seeded Poisson schedule run
    under the batch-drain engine and then the continuous engine, sustained
    solves per second and latency percentiles of each in one record
    (``bench.py``'s ``_serve_openloop_bench``). Returns ``(record, ok)``;
    ``keep`` receives both services (``"drain"``, ``"continuous"``)."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.serve import (
        SCHED_CONTINUOUS,
        SCHED_DRAIN,
        ForecastPolicy,
        ServicePolicy,
        SolveService,
    )

    schedule = _poisson_schedule(requests, rate)

    def run(mode):
        svc = SolveService(ServicePolicy(
            capacity=max(4 * requests, 16), max_batch=SERVE_MAX_BATCH,
            scheduling=mode, refill_chunk=SERVE_REFILL_CHUNK,
            degradation=_quiet_degradation(), retry=_serve_retry(),
            forecast=ForecastPolicy(),
            router=_router_policy(router, device)), seed=0, device=device)
        stats, makespan = _drive_open_loop(svc, schedule, problem)
        if keep is not None:
            keep[mode] = svc
        return stats, makespan, svc

    with obs.span("bench.serve_warmup", fence=False, requests=requests):
        t0 = time.perf_counter()
        warmed = _warm_serve_buckets(problem, device, SERVE_MAX_BATCH,
                                     requests,
                                     refill_chunk=SERVE_REFILL_CHUNK)
        warm_seconds = time.perf_counter() - t0
    obs.inc("time.compile_seconds", warm_seconds)
    with obs.span("bench.serve_openloop", fence=False, mode="drain",
                  requests=requests):
        drain_stats, drain_span, _ = run(SCHED_DRAIN)
    with obs.span("bench.serve_openloop", fence=False, mode="continuous",
                  requests=requests):
        cont_stats, cont_span, cont_svc = run(SCHED_CONTINUOUS)
    sustained = cont_stats["completed"] / cont_span if cont_span else 0.0
    drain_sustained = (drain_stats["completed"] / drain_span
                       if drain_span else 0.0)
    p99 = cont_stats["latency_seconds"]["p99"]
    drain_p99 = drain_stats["latency_seconds"]["p99"]
    record = {
        "metric": "serve.sustained_solves_per_sec",
        "value": round(sustained, 3),
        "unit": "solves/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "requests": requests,
            "arrival_rate": rate,
            "scheduling": "continuous",
            "drain_solves_per_sec": round(drain_sustained, 3),
            "p99_seconds": round(p99, 4),
            "drain_p99_seconds": round(drain_p99, 4),
            "p50_seconds": round(cont_stats["latency_seconds"]["p50"], 4),
            "drain_p50_seconds": round(
                drain_stats["latency_seconds"]["p50"], 4),
            "completed": cont_stats["completed"],
            "errors": cont_stats["errors"],
            "shed": cont_stats["shed"],
            "lost": cont_stats["lost"] + drain_stats["lost"],
            "makespan_seconds": round(cont_span, 4),
            "drain_makespan_seconds": round(drain_span, 4),
            "refill_splices": metrics.get("serve.refill.splices"),
            "idle_lane_steps": metrics.get(
                "serve.refill.idle_lane_steps"),
            "continuous_beats_drain": bool(
                sustained >= drain_sustained and p99 <= drain_p99),
            "p99_exemplar": _serve_p99_exemplar(cont_svc),
            "slowest_requests": _serve_slowest(cont_svc),
            "warmed_buckets": warmed,
            "warmup_seconds": round(warm_seconds, 2),
            "forecast_calibration_err_pct":
                _forecast_calibration(cont_svc),
            "router": _router_detail(cont_svc),
            "routed_backend": "auto" if router else "off",
            **_serve_detail(problem, device),
            "fault_load": "clean",
        },
    }
    obs.gauge("serve.sustained_solves_per_sec", record["value"])
    obs.gauge("serve.drain_solves_per_sec",
              record["detail"]["drain_solves_per_sec"])
    obs.event("bench.serve_openloop", **record["detail"],
              sustained_solves_per_sec=record["value"])
    return record, record["detail"]["lost"] == 0


def serve_fleet_record(problem: Problem, requests: int, workers: int,
                       device, kill_at=None, rate=None, fleet_devices=None,
                       kill_device_at=None, keep: Optional[dict] = None):
    """``--serve R --workers W [--devices D] [--kill-worker-at T]
    [--kill-device-at T]``: sustained solves per second of a W-worker
    fleet on the continuous engine under worker or device churn
    (``bench.py``'s ``_serve_fleet_bench``). ``--devices D`` binds the
    workers round-robin to D fault-domain slots backed by the cards (on
    one card every slot shares it: ``device_topology`` reads
    ``"Dxcuda"``). A kill that never fired is recorded as a clean run.
    ``ok`` holds only when every admitted request has exactly one typed
    outcome. Returns ``(record, ok)``; ``keep`` receives the service."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.serve import (
        SCHED_CONTINUOUS,
        FleetPolicy,
        ForecastPolicy,
        ServicePolicy,
        SolveService,
    )
    from poisson_tpu_torch.serve.placement import default_devices
    from poisson_tpu_torch.testing.faults import (
        compose_faults,
        kill_device_at as device_churn,
        kill_worker_at as churn_fault,
    )

    rate = rate or 50.0
    backing = default_devices(device)
    if fleet_devices is not None and fleet_devices > len(backing):
        print(f"bench: --devices {fleet_devices} > {len(backing)} "
              f"{device.type} device(s); fault-domain slots will "
              "oversubscribe", file=sys.stderr)
    policy = ServicePolicy(
        capacity=max(4 * requests, 16), max_batch=SERVE_MAX_BATCH,
        scheduling=SCHED_CONTINUOUS, refill_chunk=SERVE_REFILL_CHUNK,
        degradation=_quiet_degradation(), retry=_serve_retry(3),
        fleet=FleetPolicy(workers=workers, quarantine_seconds=0.2,
                          recovery_backoff=0.02, devices=fleet_devices),
        forecast=ForecastPolicy())
    schedule = _poisson_schedule(requests, rate)
    warm_devices = ()
    if fleet_devices is not None:
        warm_devices = tuple(backing[i % len(backing)]
                             for i in range(fleet_devices))
    with obs.span("bench.serve_warmup", fence=False, requests=requests):
        t0 = time.perf_counter()
        warmed = _warm_serve_buckets(problem, device, SERVE_MAX_BATCH,
                                     requests,
                                     refill_chunk=SERVE_REFILL_CHUNK,
                                     devices=warm_devices)
        warm_seconds = time.perf_counter() - t0
    obs.inc("time.compile_seconds", warm_seconds)
    # The churn clock starts before the service is built, so a kill at 0
    # fires on the first dispatch.
    t_bench = time.perf_counter()
    bench_clock = lambda: time.perf_counter() - t_bench
    wk_fault = (churn_fault(kill_at, bench_clock)
                if kill_at is not None else None)
    device_fault = (device_churn(kill_device_at, bench_clock)
                    if kill_device_at is not None else None)
    injectors = [f for f in (device_fault, wk_fault) if f is not None]
    worker_fault = (compose_faults(*injectors) if len(injectors) > 1
                    else injectors[0] if injectors else None)
    svc = SolveService(policy, seed=0, worker_fault=worker_fault,
                       device=device)
    if keep is not None:
        keep["service"] = svc
    with obs.span("bench.serve_fleet", fence=False, requests=requests,
                  workers=workers):
        stats, makespan = _drive_open_loop(svc, schedule, problem,
                                           t0=t_bench)
    outcomes = svc.outcomes()
    every_accounted = (stats["lost"] == 0 and stats["pending"] == 0
                       and len(outcomes) == stats["admitted"])
    sustained = stats["completed"] / makespan if makespan else 0.0
    kill_fired = wk_fault is not None and wk_fault.state["kills"] > 0
    device_loss_fired = (device_fault is not None
                         and device_fault.state["losses"] > 0)
    if kill_at is not None and not kill_fired:
        print(f"bench: --kill-worker-at {kill_at:g} never fired "
              f"(makespan {makespan:.3f}s); recording fault_load=clean",
              file=sys.stderr)
    if kill_device_at is not None and not device_loss_fired:
        print(f"bench: --kill-device-at {kill_device_at:g} never fired "
              f"(makespan {makespan:.3f}s); recording fault_load=clean",
              file=sys.stderr)
    loads = []
    if kill_fired:
        loads.append(f"kill_worker@{kill_at:g}")
    if device_loss_fired:
        loads.append(f"kill_device@{kill_device_at:g}")
    detail = _serve_detail(problem, device,
                           fleet_devices if fleet_devices is not None
                           else 1)
    record = {
        "metric": "serve.sustained_solves_per_sec",
        "value": round(sustained, 3),
        "unit": "solves/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "requests": requests,
            "arrival_rate": rate,
            "scheduling": "continuous",
            "workers": workers,
            "kill_worker_at": kill_at,
            "kill_fired": kill_fired,
            "kill_device_at": kill_device_at,
            "device_loss_fired": device_loss_fired,
            "completed": stats["completed"],
            "errors": stats["errors"],
            "shed": stats["shed"],
            "lost": stats["lost"],
            "every_request_accounted": every_accounted,
            "p99_seconds": round(stats["latency_seconds"]["p99"], 4),
            "p50_seconds": round(stats["latency_seconds"]["p50"], 4),
            "makespan_seconds": round(makespan, 4),
            "quarantines": metrics.get("serve.fleet.quarantines"),
            "restarts": metrics.get("serve.fleet.restarts"),
            "recovered_requests": metrics.get(
                "serve.fleet.recovered_requests"),
            "device_losses": metrics.get("serve.fleet.device_losses"),
            "placement_rebinds": metrics.get("serve.placement.rebinds"),
            "sticky_hits": metrics.get("serve.fleet.sticky_hits"),
            "p99_exemplar": _serve_p99_exemplar(svc),
            "slowest_requests": _serve_slowest(svc),
            "warmed_buckets": warmed,
            "warmup_seconds": round(warm_seconds, 2),
            "forecast_calibration_err_pct": _forecast_calibration(svc),
            **detail,
            # The slot count over the backing devices' type ("2xcuda"):
            # only --devices runs carry it, as in bench.py.
            "device_topology": (
                f"{stats['placement']['devices']}x{device.type}"
                if fleet_devices is not None else None),
            "placement": (stats["placement"]
                          if fleet_devices is not None else None),
            "fault_load": "+".join(loads) if loads else "clean",
        },
    }
    obs.gauge("serve.sustained_solves_per_sec", record["value"])
    obs.event("bench.serve_fleet", **{
        k: v for k, v in record["detail"].items()
        if k not in ("p99_exemplar", "slowest_requests", "warmed_buckets",
                     "placement")},
        sustained_solves_per_sec=record["value"])
    return record, every_accounted


def serve_geometry_mix_record(problem: Problem, requests: int, mix: int,
                              device, rate=None):
    """``--serve R --geometry-mix K``: sustained solves per second of an
    open-loop load spread round-robin over K geometry families on the
    continuous engine (``bench.py``'s ``_serve_geometry_mix_bench``);
    every family's canvases are built in the warm-up, as a fingerprint
    cache serving repeat traffic holds them. Returns ``(record, ok)``."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.geometry import geometry_setup
    from poisson_tpu_torch.serve import (
        SCHED_CONTINUOUS,
        ForecastPolicy,
        ServicePolicy,
        SolveService,
    )

    rate = rate or 40.0
    policy = ServicePolicy(
        capacity=max(4 * requests, 16), max_batch=SERVE_MAX_BATCH,
        scheduling=SCHED_CONTINUOUS, refill_chunk=SERVE_REFILL_CHUNK,
        degradation=_quiet_degradation(), retry=_serve_retry(),
        forecast=ForecastPolicy())
    families = _geometry_families(mix)
    schedule = _poisson_schedule(requests, rate)
    with obs.span("bench.serve_warmup", fence=False, requests=requests,
                  geometry_mix=mix):
        t0 = time.perf_counter()
        warmed = _warm_serve_buckets(problem, device, SERVE_MAX_BATCH,
                                     requests,
                                     refill_chunk=SERVE_REFILL_CHUNK,
                                     geometry=families[0])
        for fam in families:
            geometry_setup(problem, fam, DTYPE, True, device)
        warm_seconds = time.perf_counter() - t0
    obs.inc("time.compile_seconds", warm_seconds)
    svc = SolveService(policy, seed=0, device=device)
    with obs.span("bench.serve_geometry_mix", fence=False,
                  requests=requests, geometry_mix=mix):
        stats, makespan = _drive_open_loop(svc, schedule, problem,
                                           geometries=families)
    sustained = stats["completed"] / makespan if makespan else 0.0
    record = {
        "metric": "serve.sustained_solves_per_sec",
        "value": round(sustained, 3),
        "unit": "solves/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "requests": requests,
            "arrival_rate": rate,
            "scheduling": "continuous",
            "geometry_mix": mix,
            "geometry_fingerprints": [f.fingerprint for f in families],
            "completed": stats["completed"],
            "errors": stats["errors"],
            "shed": stats["shed"],
            "lost": stats["lost"],
            "p99_seconds": round(stats["latency_seconds"]["p99"], 4),
            "p50_seconds": round(stats["latency_seconds"]["p50"], 4),
            "makespan_seconds": round(makespan, 4),
            "geom_cache_hits": metrics.get("geom.cache.hits"),
            "geom_cache_misses": metrics.get("geom.cache.misses"),
            "bucket_cache_hits": metrics.get(
                "batched.bucket_cache.hits"),
            "bucket_cache_misses": metrics.get(
                "batched.bucket_cache.misses"),
            "refill_splices": metrics.get("serve.refill.splices"),
            "p99_exemplar": _serve_p99_exemplar(svc),
            "slowest_requests": _serve_slowest(svc),
            "warmed_buckets": warmed,
            "warmup_seconds": round(warm_seconds, 2),
            "forecast_calibration_err_pct": _forecast_calibration(svc),
            **_serve_detail(problem, device),
            "fault_load": "clean",
        },
    }
    obs.gauge("serve.sustained_solves_per_sec", record["value"])
    obs.event("bench.serve_geometry_mix", **{
        k: v for k, v in record["detail"].items()
        if k not in ("p99_exemplar", "slowest_requests", "warmed_buckets")},
        sustained_solves_per_sec=record["value"])
    return record, stats["lost"] == 0


def serve_repeat_fp_record(problem: Problem, requests: int, families: int,
                           device, rate=None,
                           keep: Optional[dict] = None):
    """``--serve R --repeat-fingerprint K``: open-loop traffic over K
    geometry families with Zipf-ish repeats, each request served through
    the fingerprint-keyed deflation cache (``ServicePolicy.krylov``,
    ``bench.py``'s ``_serve_repeat_fp_bench``): a family's first request
    harvests (the cold arm), its repeats start off the basis (the warm
    arm). The arms are told apart by their measured iterations. The
    warm-up builds every family's canvases and runs the harvest and the
    deflated solve once on a family outside the K. Returns ``(record,
    ok)``; ``keep`` receives the service."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.geometry import Ellipse, geometry_setup
    from poisson_tpu_torch.krylov import KrylovPolicy
    from poisson_tpu_torch.krylov.recycle import (
        reset_krylov_cache,
        solve_recycled,
    )
    from poisson_tpu_torch.obs.costs import krylov_deflated_cost
    from poisson_tpu_torch.serve import (
        ForecastPolicy,
        ServicePolicy,
        SolveService,
    )
    from poisson_tpu_torch.serve.service import _percentile

    rate = rate or 10.0
    kp = KrylovPolicy(deflation=True)
    policy = ServicePolicy(
        capacity=max(4 * requests, 16), max_batch=SERVE_MAX_BATCH,
        degradation=_quiet_degradation(), krylov=kp, retry=_serve_retry(),
        forecast=ForecastPolicy())
    fams = _geometry_families(families)
    picks = _zipf_families(requests, families)
    schedule = _poisson_schedule(requests, rate)
    reset_krylov_cache()
    with obs.span("bench.serve_warmup", fence=False, requests=requests,
                  repeat_fingerprint=families):
        t0 = time.perf_counter()
        for fam in fams:
            geometry_setup(problem, fam, DTYPE, True, device)
        warmup_fam = Ellipse(cx=-0.31, cy=0.11, rx=0.41, ry=0.21)
        solve_recycled(problem, dtype=DTYPE, geometry=warmup_fam,
                       policy=kp, device=device)
        solve_recycled(problem, dtype=DTYPE, geometry=warmup_fam,
                       policy=kp, rhs_gate=1.1, device=device)
        warm_seconds = time.perf_counter() - t0
    obs.inc("time.compile_seconds", warm_seconds)
    # The cache counters after the warm-up: the record counts the
    # measured traffic only.
    names = ("krylov.cache.hits", "krylov.cache.misses", "krylov.harvests",
             "krylov.iterations_saved", "krylov.fallbacks")
    base = {name: metrics.get(name) for name in names}
    svc = SolveService(policy, seed=0, device=device)
    if keep is not None:
        keep["service"] = svc
    with obs.span("bench.serve_repeat_fingerprint", fence=False,
                  requests=requests, repeat_fingerprint=families):
        # One family per request (request i takes geometries[i]).
        stats, makespan = _drive_open_loop(
            svc, schedule, problem, geometries=[fams[k] for k in picks])
    lat = {o.request_id: o.latency_seconds for o in svc.outcomes()}
    # The arms from what was measured: a request served off the basis
    # converges in a handful of deflated iterations, a harvest pays the
    # family's full count.
    iters = {o.request_id: o.iterations for o in svc.outcomes()}
    max_it = max(iters.values()) if iters else 0
    warm_ids = {r for r, k in iters.items() if k <= max(5, max_it // 10)}
    cold_ids = set(iters) - warm_ids

    def pcts(ids):
        vals = sorted(lat[r] for r in ids if r in lat)
        if not vals:
            return {"p50": None, "p99": None, "n": 0}
        return {"p50": round(_percentile(vals, 0.50), 4),
                "p99": round(_percentile(vals, 0.99), 4), "n": len(vals)}

    def delta(name):
        return metrics.get(name) - base[name]

    cold_lat, warm_lat = pcts(cold_ids), pcts(warm_ids)
    hits, misses = delta("krylov.cache.hits"), delta("krylov.cache.misses")
    hit_rate = hits / (hits + misses) if (hits + misses) else 0.0
    cost = krylov_deflated_cost(problem.M, problem.N, kp.keep + 1)
    sustained = stats["completed"] / makespan if makespan else 0.0
    record = {
        "metric": "serve.sustained_solves_per_sec",
        "value": round(sustained, 3),
        "unit": "solves/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "requests": requests,
            "arrival_rate": rate,
            "scheduling": "drain",
            "repeat_fingerprint": families,
            "deflation": True,
            "krylov_mode": "independent",
            "completed": stats["completed"],
            "errors": stats["errors"],
            "shed": stats["shed"],
            "lost": stats["lost"],
            "makespan_seconds": round(makespan, 4),
            "cold_requests": len(cold_ids),
            "warm_requests": len(warm_ids),
            "cold_p50_seconds": cold_lat["p50"],
            "cold_p99_seconds": cold_lat["p99"],
            "warm_p50_seconds": warm_lat["p50"],
            "warm_p99_seconds": warm_lat["p99"],
            "krylov_hit_rate": round(hit_rate, 4),
            "krylov_harvests": delta("krylov.harvests"),
            "krylov_iterations_saved": delta("krylov.iterations_saved"),
            "krylov_fallbacks": delta("krylov.fallbacks"),
            "deflated_bytes_per_iter_model": cost["bytes"],
            "p99_exemplar": _serve_p99_exemplar(svc),
            "slowest_requests": _serve_slowest(svc),
            "warmup_seconds": round(warm_seconds, 2),
            "forecast_calibration_err_pct": _forecast_calibration(svc),
            **_serve_detail(problem, device),
            "fault_load": "clean",
        },
    }
    obs.gauge("serve.sustained_solves_per_sec", record["value"])
    for arm, pct in (("cold", cold_lat), ("warm", warm_lat)):
        if pct["p50"] is not None:
            obs.gauge(f"serve.krylov.{arm}_p50_seconds", pct["p50"])
            obs.gauge(f"serve.krylov.{arm}_p99_seconds", pct["p99"])
    obs.event("bench.serve_repeat_fingerprint", **{
        k: v for k, v in record["detail"].items()
        if k not in ("p99_exemplar", "slowest_requests")},
        sustained_solves_per_sec=record["value"])
    return record, stats["lost"] == 0


def serve_tenants_record(problem: Problem, requests: int, spec, device,
                         rate=None):
    """``--serve R --tenants SPEC``: sustained solves per second on the
    continuous engine with tenancy on, arrivals stamped with tenants
    drawn (seeded) by the spec's weights, and each tenant's p99 and shed
    rate (``bench.py``'s ``_serve_tenants_bench``). Returns ``(record,
    ok)``."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.serve import (
        SCHED_CONTINUOUS,
        ForecastPolicy,
        ServicePolicy,
        SolveService,
        TenancyPolicy,
    )
    from poisson_tpu_torch.serve.service import _percentile

    rate = rate or 40.0
    policy = ServicePolicy(
        capacity=max(4 * requests, 16), max_batch=SERVE_MAX_BATCH,
        scheduling=SCHED_CONTINUOUS, refill_chunk=SERVE_REFILL_CHUNK,
        degradation=_quiet_degradation(), retry=_serve_retry(),
        forecast=ForecastPolicy(),
        # Quota off: this measures the fair queue under a share-
        # proportional load, not admission policing.
        tenancy=TenancyPolicy(shares=tuple(spec)))
    mix = _tenant_mix_string(spec)
    schedule = _poisson_schedule(requests, rate)
    tenants = _tenant_draws(spec, requests)
    with obs.span("bench.serve_warmup", fence=False, requests=requests):
        t0 = time.perf_counter()
        warmed = _warm_serve_buckets(problem, device, SERVE_MAX_BATCH,
                                     requests,
                                     refill_chunk=SERVE_REFILL_CHUNK)
        warm_seconds = time.perf_counter() - t0
    obs.inc("time.compile_seconds", warm_seconds)
    svc = SolveService(policy, seed=0, device=device)
    with obs.span("bench.serve_tenants", fence=False, requests=requests,
                  tenant_mix=mix):
        stats, makespan = _drive_open_loop(svc, schedule, problem,
                                           tenants=tenants)
    sustained = stats["completed"] / makespan if makespan else 0.0
    by_tenant = {name: [] for name, _ in spec}
    for o in svc.outcomes():
        by_tenant[tenants[o.request_id]].append(o)
    tenant_detail = {}
    for name, outs in by_tenant.items():
        done = [o for o in outs if o.kind == "result"]
        shed = [o for o in outs if o.kind == "shed"]
        lat = sorted(o.latency_seconds for o in done)
        tenant_detail[name] = {
            "share": dict(spec)[name],
            "assigned": len(outs),
            "completed": len(done),
            "shed": len(shed),
            "shed_rate": round(len(shed) / len(outs), 4) if outs else 0.0,
            "p99_seconds": (round(_percentile(lat, 0.99), 4)
                            if lat else None),
            "p50_seconds": (round(_percentile(lat, 0.50), 4)
                            if lat else None),
        }
    record = {
        "metric": "serve.sustained_solves_per_sec",
        "value": round(sustained, 3),
        "unit": "solves/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "requests": requests,
            "arrival_rate": rate,
            "scheduling": "continuous",
            "completed": stats["completed"],
            "errors": stats["errors"],
            "shed": stats["shed"],
            "lost": stats["lost"],
            "p99_seconds": round(stats["latency_seconds"]["p99"], 4),
            "p50_seconds": round(stats["latency_seconds"]["p50"], 4),
            "makespan_seconds": round(makespan, 4),
            "refill_splices": metrics.get("serve.refill.splices"),
            "tenant_promotions": metrics.get("serve.tenant.promotions"),
            "tenants": tenant_detail,
            "p99_exemplar": _serve_p99_exemplar(svc),
            "slowest_requests": _serve_slowest(svc),
            "warmed_buckets": warmed,
            "warmup_seconds": round(warm_seconds, 2),
            "forecast_calibration_err_pct": _forecast_calibration(svc),
            **_serve_detail(problem, device),
            "tenant_mix": mix,
            "fault_load": "clean",
        },
    }
    obs.gauge("serve.sustained_solves_per_sec", record["value"])
    obs.event("bench.serve_tenants", **{
        k: v for k, v in record["detail"].items()
        if k not in ("p99_exemplar", "slowest_requests", "warmed_buckets")},
        sustained_solves_per_sec=record["value"])
    return record, stats["lost"] == 0


def krylov_block_record(problem: Problem, block_b: int, device):
    """``--krylov-block B``: the independent batched solve and the block
    recurrence (``solve_batched(mode="block")``) on one clustered batch
    (``krylov.block.clustered_ellipse_stack``), in one record
    (``bench.py``'s ``_krylov_block_bench``). ``iteration_cut`` is the
    share of member iterations the block saves (B × block iterations
    against Σ member iterations), held at the same L2 floor against the
    exact solutions. Returns ``(record, ok)``: ok when both arms
    converge."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.krylov.block import (
        block_l2_errors,
        clustered_ellipse_stack,
    )
    from poisson_tpu_torch.obs.costs import krylov_block_cost
    from poisson_tpu_torch.solvers.batched import solve_batched
    from poisson_tpu_torch.utils.platform import device_name

    fs, us, inside = clustered_ellipse_stack(problem, block_b)
    run = lambda mode: (lambda: solve_batched(
        problem, rhs_stack=fs, dtype=DTYPE, mode=mode, device=device))
    with obs.span("bench.krylov_block_warmup", fence=False,
                  batch=block_b):
        first_i, ri = best_of(run("independent"), device, 1)
        first_b, rb = best_of(run("block"), device, 1)
    obs.inc("time.compile_seconds", first_i + first_b)
    with obs.span("bench.krylov_block_timed", fence=False):
        ti, ri = best_of(run("independent"), device)
        tb, rb = best_of(run("block"), device)
    indep_total = int(ri.iterations.sum())
    block_iters = int(rb.max_iterations)
    block_total = block_b * block_iters
    cut = 1.0 - block_total / max(1, indep_total)
    l2_i = block_l2_errors(problem, ri, us, inside)
    l2_b = block_l2_errors(problem, rb, us, inside)
    cost = krylov_block_cost(problem.M, problem.N, block_b, 4)
    record = {
        "metric": "batched_solves_per_sec",
        "value": round(block_b / tb, 3) if tb > 0 else None,
        "unit": "solves/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "batch": block_b,
            "bucket": block_b,
            "dtype": DTYPE,
            "backend": "torch_batched",
            "devices": 1,
            "platform": _platform(device),
            "device_kind": device_name(device),
            "platform_fallback": False,
            "first_run_seconds": round(first_i + first_b, 2),
            "krylov_mode": "block",
            "krylov_block_ab": {
                "independent": {
                    "iterations_total": indep_total,
                    "batch_seconds": round(ti, 4),
                    "l2_max": round(max(l2_i), 6),
                },
                "block": {
                    "iterations": block_iters,
                    "iterations_total": block_total,
                    "batch_seconds": round(tb, 4),
                    "l2_max": round(max(l2_b), 6),
                    "rank_deficient": bool(rb.deficient),
                    "bytes_per_iter_model": cost["bytes"],
                },
                "iteration_cut": round(cut, 4),
                "same_l2_floor": bool(
                    max(l2_b) <= 1.2 * max(l2_i) + 1e-12),
                "speedup": round(ti / tb, 2) if tb > 0 else None,
            },
        },
    }
    obs.event("bench.krylov_block_record", grid=f"{problem.M}x{problem.N}",
              batch=block_b, iterations_independent=indep_total,
              iterations_block=block_total, iteration_cut=round(cut, 4))
    converged = bool((rb.flag == 1).all()) and bool((ri.flag == 1).all())
    return record, converged


def _ellipse_rel_l2(problem: Problem, e, w) -> float:
    """Weighted L2 of (w − u_exact) over the nodes strictly inside the
    ellipse ``e``, relative to ‖u_exact‖ (the quadratic manufactured
    solution: ``bench.py``'s session oracle)."""
    x = (problem.x_min + np.arange(problem.M + 1, dtype=np.float64)
         * problem.h1)[:, None]
    y = (problem.y_min + np.arange(problem.N + 1, dtype=np.float64)
         * problem.h2)[None, :]
    mask = e.contains(x, y, np)
    c = problem.f_val / (2.0 * (1.0 / e.rx ** 2 + 1.0 / e.ry ** 2))
    tx = (x - e.cx) / e.rx
    ty = (y - e.cy) / e.ry
    u = np.where(mask, c * (1.0 - tx * tx - ty * ty), 0.0)
    w64 = (w.detach().cpu().double().numpy() if isinstance(w, torch.Tensor)
           else np.asarray(w, np.float64))
    scale = problem.h1 * problem.h2
    l2 = float(np.sqrt(np.where(mask, (w64 - u) ** 2, 0.0).sum() * scale))
    norm = float(np.sqrt(np.where(mask, u ** 2, 0.0).sum() * scale))
    return l2 / norm if norm > 0 else float("inf")


def session_record(problem: Problem, steps: int, device):
    """``--session STEPS``: one moving-ellipse session (cx moves
    :data:`SESSION_DRIFT` a step) through ``serve.SessionHost`` against
    the same schedule as independent cold ``pcg_solve`` calls
    (``bench.py``'s ``_session_bench``). The canvas cache is emptied
    before each arm, so both pay the per-step geometry build; both are
    held at the same manufactured-solution floor every step. The headline
    is steps per second. Returns ``(record, ok)``: ok when every step
    converged at the floor and no request was lost."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.geometry import Ellipse
    from poisson_tpu_torch.geometry.canvas import reset_geometry_cache
    from poisson_tpu_torch.serve import ServicePolicy, SessionHost, SolveService
    from poisson_tpu_torch.solvers.pcg import pcg_solve, resolve_dtype
    from poisson_tpu_torch.solvers.session import (
        reset_session_cache,
        session_step_solve,
    )
    from poisson_tpu_torch.utils.platform import device_name
    from poisson_tpu_torch.utils.timing import fence

    spec = lambda k: Ellipse(cx=SESSION_DRIFT * k)
    dtype_name = resolve_dtype(None)
    # Warm-up: one cold solve and one warm step on a spec far off the
    # measured schedule, outside the timers.
    with obs.span("bench.session_warmup", fence=False, steps=steps):
        t0 = time.perf_counter()
        r0 = pcg_solve(problem, geometry=Ellipse(cx=-0.3), device=device)
        session_step_solve(problem, geometry=Ellipse(cx=-0.3 + SESSION_DRIFT),
                           warm=r0.w, warm_geometry=Ellipse(cx=-0.3),
                           device=device)
        fence(device)
        compile_secs = time.perf_counter() - t0
    obs.inc("time.compile_seconds", compile_secs)

    reset_geometry_cache()
    cold_results = []
    t0 = time.perf_counter()
    for k in range(steps):
        cold_results.append(pcg_solve(problem, geometry=spec(k),
                                      device=device))
        fence(device)
    cold_secs = time.perf_counter() - t0

    reset_session_cache()
    reset_geometry_cache()
    hits0 = metrics.get("session.warm.hits")
    falls0 = metrics.get("session.warm.fallbacks")
    svc = SolveService(ServicePolicy(capacity=max(16, steps + 2)),
                       device=device)
    host = SessionHost(svc)
    sess = host.open("bench-session", problem, geometry=spec(0))
    if sess is None:
        raise RuntimeError("session open was shed on an idle service")
    sess_outs, sess_sols = [], []
    t0 = time.perf_counter()
    for k in range(steps):
        sess_outs.append(host.step(sess, geometry=spec(k)))
        sess_sols.append(sess.warm)
    sess_secs = time.perf_counter() - t0
    summary = host.close(sess)
    warm_hits = int(metrics.get("session.warm.hits") - hits0)
    fallbacks = int(metrics.get("session.warm.fallbacks") - falls0)

    cold_iters = [int(r.iterations) for r in cold_results]
    sess_iters = [int(o.iterations) for o in sess_outs]
    cold_rels = [_ellipse_rel_l2(problem, spec(k), cold_results[k].w)
                 for k in range(steps)]
    sess_rels = [_ellipse_rel_l2(problem, spec(k), sess_sols[k])
                 for k in range(steps) if sess_sols[k] is not None]
    floor = 1.2 * max(cold_rels) + 1e-12
    l2_ok = len(sess_rels) == steps and all(r <= floor for r in sess_rels)
    converged = (all(int(r.flag) == 1 for r in cold_results)
                 and all(o.converged for o in sess_outs))
    lost = svc.stats()["lost"]
    steps_per_sec = steps / sess_secs if sess_secs > 0 else None
    cold_sps = steps / cold_secs if cold_secs > 0 else None
    speedup = cold_secs / sess_secs if sess_secs > 0 else None
    record = {
        "metric": "session.steps_per_sec",
        "value": round(steps_per_sec, 3) if steps_per_sec else None,
        "unit": "steps/sec",
        "detail": {
            "grid": [problem.M, problem.N],
            "dtype": dtype_name,
            "backend": "torch_session",
            "devices": 1,
            "platform": _platform(device),
            "device_kind": device_name(device),
            "platform_fallback": False,
            "first_run_seconds": round(compile_secs, 2),
            "session": True,
            "warm_start": True,
            "steps": steps,
            "session_ab": {
                "session_seconds": round(sess_secs, 4),
                "cold_seconds": round(cold_secs, 4),
                "cold_solves_per_sec": (round(cold_sps, 3)
                                        if cold_sps else None),
                "speedup": round(speedup, 2) if speedup else None,
                "warm_hit_rate": round(warm_hits / steps, 4),
                "warm_fallbacks": fallbacks,
                "iterations_total": sum(sess_iters),
                "iterations_total_cold": sum(cold_iters),
                "iterations_saved": sum(cold_iters) - sum(sess_iters),
                "l2_rel_max_cold": round(max(cold_rels), 6),
                "l2_rel_max_session": (round(max(sess_rels), 6)
                                       if sess_rels else None),
                "l2_at_floor": l2_ok,
                "slo_good": bool(summary["slo_good"]),
                "lost": lost,
            },
        },
    }
    obs.event("bench.session", grid=[problem.M, problem.N], steps=steps,
              steps_per_sec=record["value"],
              cold_solves_per_sec=record["detail"]["session_ab"][
                  "cold_solves_per_sec"],
              speedup=record["detail"]["session_ab"]["speedup"],
              warm_hit_rate=round(warm_hits / steps, 4),
              iterations_saved=sum(cold_iters) - sum(sess_iters),
              session_beats_cold=bool(speedup and speedup > 1.0))
    obs.gauge("bench.session_steps_per_sec", record["value"] or 0.0)
    obs.gauge("bench.session_speedup",
              record["detail"]["session_ab"]["speedup"] or 0.0)
    return record, converged and l2_ok and lost == 0


USAGE = ("usage: python -m poisson_tpu_torch.bench [--batch B | --serve R "
         "[--arrival-rate L]] [M N] [--device cuda|cpu] [--out PATH]")

# (flag, type, usage line): the valued options, each pulled out of argv
# with bench.py's usage line when its value is missing or malformed.
_VALUED = (
    ("--batch", int, "usage: python -m poisson_tpu_torch.bench [--batch B "
                     "| --serve R] [M N]"),
    ("--verify-every", int, "usage: python -m poisson_tpu_torch.bench "
                            "--verify-every K [M N]"),
    ("--preconditioner", str, "usage: python -m poisson_tpu_torch.bench "
                              "--preconditioner {jacobi,mg} [M N]"),
    ("--serve", int, "usage: python -m poisson_tpu_torch.bench [--batch B "
                     "| --serve R [--arrival-rate L]] [M N]"),
    ("--arrival-rate", float, "usage: python -m poisson_tpu_torch.bench "
                              "--serve R --arrival-rate LAMBDA [M N]"),
    ("--workers", int, "usage: python -m poisson_tpu_torch.bench --serve R "
                       "--workers W [--kill-worker-at T] [M N]"),
    ("--devices", int, "usage: python -m poisson_tpu_torch.bench --serve R "
                       "--workers W --devices D [--kill-device-at T] [M N]"),
    ("--kill-device-at", float, "usage: python -m poisson_tpu_torch.bench "
                                "--serve R --workers W --devices D "
                                "--kill-device-at T [M N]"),
    ("--kill-worker-at", float, "usage: python -m poisson_tpu_torch.bench "
                                "--serve R --workers W --kill-worker-at T "
                                "[M N]"),
    ("--geometry-mix", int, "usage: python -m poisson_tpu_torch.bench "
                            "--serve R --geometry-mix K [--arrival-rate L] "
                            "[M N]"),
    ("--krylov-block", int, "usage: python -m poisson_tpu_torch.bench "
                            "--krylov-block B [M N]"),
    ("--session", int, "usage: python -m poisson_tpu_torch.bench --session "
                       "STEPS [M N]"),
    ("--repeat-fingerprint", int, "usage: python -m poisson_tpu_torch.bench "
                                  "--serve R --repeat-fingerprint K "
                                  "[--arrival-rate L] [M N]"),
    ("--tenants", str, "usage: python -m poisson_tpu_torch.bench --serve R "
                       "--tenants NAME:WEIGHT[,NAME:WEIGHT...] "
                       "[--arrival-rate L] [M N]"),
    ("--device", str, USAGE),
    ("--out", str, USAGE),
)


class _Refused(Exception):
    """A command line ``bench.py`` refuses (exit 2)."""


def parse_args(argv) -> dict:
    """The command line as ``bench.py`` reads it: each option pulled out of
    argv by name, then its rules checked in ``bench.py``'s order with its
    messages. Raises :class:`_Refused` with the message."""
    argv = list(argv)
    opts = {}
    for flag, kind, usage in _VALUED:
        if flag not in argv:
            continue
        i = argv.index(flag)
        try:
            opts[flag] = kind(argv[i + 1])
        except (IndexError, ValueError):
            raise _Refused(usage) from None
        del argv[i:i + 2]
    opts["--router"] = "--router" in argv
    if opts["--router"]:
        argv.remove("--router")
    opts["grid"] = argv
    get = opts.get
    serve, workers = get("--serve"), get("--workers")
    moded = lambda *names: [n for n in names if get(n) is not None]
    if get("--batch") is not None and opts["--batch"] < 1:
        raise _Refused(f"--batch must be >= 1, got {opts['--batch']}")
    if get("--verify-every") is not None and opts["--verify-every"] < 1:
        raise _Refused(f"--verify-every must be >= 1, got "
                       f"{opts['--verify-every']}")
    if (get("--preconditioner") is not None
            and opts["--preconditioner"] not in ("jacobi", "mg")):
        raise _Refused(f"--preconditioner must be jacobi or mg, got "
                       f"{opts['--preconditioner']!r}")
    if serve is not None and serve < 1:
        raise _Refused(f"--serve must be >= 1, got {serve}")
    if get("--arrival-rate") is not None:
        if serve is None:
            raise _Refused("--arrival-rate is a --serve mode option")
        if opts["--arrival-rate"] <= 0:
            raise _Refused(f"--arrival-rate must be > 0, got "
                           f"{opts['--arrival-rate']}")
    if workers is not None:
        if serve is None:
            raise _Refused("--workers is a --serve mode option")
        if workers < 1:
            raise _Refused(f"--workers must be >= 1, got {workers}")
    if get("--devices") is not None:
        if workers is None:
            raise _Refused("--devices is a --serve --workers mode option")
        if opts["--devices"] < 1:
            raise _Refused(f"--devices must be >= 1, got "
                           f"{opts['--devices']}")
    if get("--kill-device-at") is not None:
        if get("--devices") is None or opts["--devices"] < 2:
            raise _Refused("--kill-device-at needs --serve --workers "
                           "--devices D with D >= 2 (losing the only "
                           "device is a total outage, not a churn "
                           "experiment)")
        if opts["--kill-device-at"] < 0:
            raise _Refused(f"--kill-device-at must be >= 0, got "
                           f"{opts['--kill-device-at']}")
    if get("--kill-worker-at") is not None:
        if workers is None:
            raise _Refused("--kill-worker-at is a --serve --workers mode "
                           "option")
        if opts["--kill-worker-at"] < 0:
            raise _Refused(f"--kill-worker-at must be >= 0, got "
                           f"{opts['--kill-worker-at']}")
    if get("--geometry-mix") is not None:
        if serve is None:
            raise _Refused("--geometry-mix is a --serve mode option")
        if workers is not None:
            raise _Refused("--geometry-mix and --workers are separate "
                           "serve experiments; pick one")
        if opts["--geometry-mix"] < 1:
            raise _Refused(f"--geometry-mix must be >= 1, got "
                           f"{opts['--geometry-mix']}")
    if get("--krylov-block") is not None:
        if opts["--krylov-block"] < 2:
            raise _Refused(f"--krylov-block must be >= 2, got "
                           f"{opts['--krylov-block']} (a 1-wide block is "
                           "a plain solve)")
        if moded("--batch", "--serve", "--verify-every",
                 "--preconditioner"):
            raise _Refused("--krylov-block is its own A/B bench mode; drop "
                           "--batch/--serve/--verify-every/"
                           "--preconditioner")
    if get("--session") is not None:
        if opts["--session"] < 2:
            raise _Refused(f"--session must be >= 2, got "
                           f"{opts['--session']} (one step has no warm "
                           "start to measure)")
        if moded("--batch", "--serve", "--verify-every",
                 "--preconditioner", "--krylov-block"):
            raise _Refused("--session is its own A/B bench mode; drop "
                           "--batch/--serve/--verify-every/"
                           "--preconditioner/--krylov-block")
    if get("--repeat-fingerprint") is not None:
        if serve is None:
            raise _Refused("--repeat-fingerprint is a --serve mode option")
        if moded("--workers", "--geometry-mix"):
            raise _Refused("--repeat-fingerprint, --workers, and "
                           "--geometry-mix are separate serve experiments; "
                           "pick one")
        if opts["--repeat-fingerprint"] < 1:
            raise _Refused(f"--repeat-fingerprint must be >= 1, got "
                           f"{opts['--repeat-fingerprint']}")
    if get("--tenants") is not None:
        if serve is None:
            raise _Refused("--tenants is a --serve mode option")
        if moded("--workers", "--geometry-mix", "--repeat-fingerprint"):
            raise _Refused("--tenants, --workers, --geometry-mix, and "
                           "--repeat-fingerprint are separate serve "
                           "experiments; pick one")
        from poisson_tpu_torch.serve import parse_tenant_spec

        try:
            opts["--tenants"] = parse_tenant_spec(opts["--tenants"])
        except ValueError as e:
            raise _Refused(f"--tenants: {e}") from None
    if opts["--router"]:
        if serve is None:
            raise _Refused("--router is a --serve mode option")
        if moded("--workers", "--geometry-mix", "--repeat-fingerprint",
                 "--tenants"):
            raise _Refused("--router rides the plain and open-loop serve "
                           "modes; drop --workers/--geometry-mix/"
                           "--repeat-fingerprint/--tenants")
    if get("--batch") is not None and serve is not None:
        raise _Refused("--batch and --serve are separate bench modes; "
                       "pick one")
    if get("--verify-every") is not None and moded("--batch", "--serve"):
        raise _Refused("--verify-every is its own bench mode; drop "
                       "--batch/--serve")
    if get("--preconditioner") is not None and moded(
            "--batch", "--serve", "--verify-every"):
        raise _Refused("--preconditioner is its own A/B bench mode; drop "
                       "--batch/--serve/--verify-every")
    if get("--device", "cuda") not in ("cuda", "cpu"):
        raise _Refused(f"--device must be cuda or cpu, got "
                       f"{opts['--device']!r}")
    if len(opts["grid"]) not in (0, 2):
        raise _Refused(USAGE)
    try:
        opts["grid"] = [int(x) for x in opts["grid"]]
    except ValueError:
        raise _Refused(USAGE) from None
    return opts


def default_grid(opts) -> tuple:
    """``bench.py``'s default grid of the mode: the session mode's
    300×450, 400×600 for every other mode, the flagship otherwise."""
    if opts.get("--session") is not None:
        return SESSION_GRID
    if any(opts.get(flag) is not None for flag in (
            "--batch", "--serve", "--verify-every", "--preconditioner",
            "--krylov-block")):
        return MODE_GRID
    return FLAGSHIP


def run_mode(opts, problem: Problem, device):
    """The record of the mode ``opts`` asks for, and whether the run
    passed (``bench.py``'s exit rule of that mode)."""
    get = opts.get
    if get("--verify-every") is not None:
        return verify_record(problem, opts["--verify-every"], device), True
    if get("--preconditioner") is not None:
        return preconditioner_record(problem, opts["--preconditioner"],
                                     device), True
    if get("--krylov-block") is not None:
        return krylov_block_record(problem, opts["--krylov-block"], device)
    if get("--session") is not None:
        return session_record(problem, opts["--session"], device)
    if get("--batch") is not None:
        return batched_record(problem, opts["--batch"], device), True
    requests, rate = get("--serve"), get("--arrival-rate")
    if requests is None:
        return flagship_record(problem, device), True
    if get("--repeat-fingerprint") is not None:
        return serve_repeat_fp_record(problem, requests,
                                      opts["--repeat-fingerprint"], device,
                                      rate)
    if get("--geometry-mix") is not None:
        return serve_geometry_mix_record(problem, requests,
                                         opts["--geometry-mix"], device,
                                         rate)
    if get("--workers") is not None:
        return serve_fleet_record(
            problem, requests, opts["--workers"], device,
            kill_at=get("--kill-worker-at"), rate=rate,
            fleet_devices=get("--devices"),
            kill_device_at=get("--kill-device-at"))
    if get("--tenants") is not None:
        return serve_tenants_record(problem, requests, opts["--tenants"],
                                    device, rate)
    if rate is not None:
        return serve_openloop_record(problem, requests, rate, device,
                                     router=opts["--router"])
    return serve_record(problem, requests, device, router=opts["--router"])


def main(argv=None) -> int:
    try:
        opts = parse_args(sys.argv[1:] if argv is None else argv)
    except _Refused as e:
        print(str(e), file=sys.stderr)
        return 2
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.utils.platform import resolve_device

    try:
        device = resolve_device(opts.get("--device", "cuda"))
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    M, N = opts["grid"] or default_grid(opts)
    problem = Problem(M=M, N=N)
    obs.configure_from_env()
    record, ok = run_mode(opts, problem, device)
    obs.finalize()
    line = json.dumps(record)
    if opts.get("--out"):
        with open(opts["--out"], "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
