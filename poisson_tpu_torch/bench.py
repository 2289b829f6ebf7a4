"""Benchmark records in ``bench.py``'s shape (counterpart of the repo's
``bench.py``, its flagship, ``--batch``, ``--preconditioner`` and
``--verify-every`` modes)::

    python -m poisson_tpu_torch.bench [M N] [--batch B |
        --preconditioner jacobi|mg | --verify-every K] [--out PATH]

Each run prints one JSON record (and writes it to ``--out``) that
``benchmarks/regress.py`` loads: ``{"metric", "value", "unit", …,
"detail": {…}}`` with the JAX bench's keys. The port's records carry
``platform: "gpu"`` and the port's backend names (``fused``, ``torch``,
``torch_batched``), so they land in cohorts of their own and never judge a
TPU record, nor the reverse.

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

Timing: the warm-up solve (kernel build and load, canvas setup) is
``first_run_seconds``; then the best of :data:`REPEATS` solves, each fenced
with ``torch.cuda.synchronize()``. The JAX bench's chained K_HI − K_LO
slope cancels a remote TPU's constant fetch latency, which a local card
does not have, so it is not used (``detail.timing`` says so). The
flagship's warm-up count must lie within max(5, golden ÷ 100) of the
golden count (``GOLDEN_ITERS``) or the run fails. There is no fallback:
without a card the command exits non-zero; a failing kernel fails the
run.

Telemetry is env-driven as in the JAX bench (``obs.configure_from_env``):
``POISSON_TPU_PROFILE_DIR`` captures one extra, untimed solve after the
timed ones.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from poisson_tpu_torch.config import Problem

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch.bench",
        description="One bench record of the PyTorch/CUDA port on one "
                    "card, in bench.py's shape.")
    p.add_argument("grid", type=int, nargs="*", metavar="M N",
                   help="grid (default 800 1200; 400 600 for the modes)")
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--batch", type=int, default=None, metavar="B",
                      help="batched throughput: B solves in one dispatch")
    mode.add_argument("--preconditioner", choices=("jacobi", "mg"),
                      default=None,
                      help="Jacobi and MG plain solves in one record")
    mode.add_argument("--verify-every", type=int, default=None,
                      metavar="K", help="integrity-probe overhead")
    p.add_argument("--out", metavar="PATH", default=None,
                   help="also write the record to PATH")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if len(args.grid) not in (0, 2):
        print("usage: python -m poisson_tpu_torch.bench [M N] [--batch B | "
              "--preconditioner jacobi|mg | --verify-every K]",
              file=sys.stderr)
        return 2
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.utils.platform import resolve_device

    try:
        device = resolve_device("cuda")
    except RuntimeError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 1
    moded = (args.batch is not None or args.preconditioner is not None
             or args.verify_every is not None)
    M, N = args.grid or (MODE_GRID if moded else FLAGSHIP)
    problem = Problem(M=M, N=N)
    obs.configure_from_env()
    if args.batch is not None:
        record = batched_record(problem, args.batch, device)
    elif args.preconditioner is not None:
        record = preconditioner_record(problem, args.preconditioner, device)
    elif args.verify_every is not None:
        record = verify_record(problem, args.verify_every, device)
    else:
        record = flagship_record(problem, device)
    obs.finalize()
    line = json.dumps(record)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
