"""Command line: ``python -m poisson_tpu_torch M N`` (the solve subset of
``poisson_tpu/cli.py``).

Backends: ``fused`` is the two-sweep canvas iteration with CUDA kernels A and
B; ``resident`` the whole solve in one launch of kernel R (grids within the
residency budget); ``ca`` the communication-avoiding pair iteration with
kernels C and D — these three are fp32 only, the counterparts of the JAX
CLI's ``pallas``, ``pallas-resident`` and ``pallas-ca``. ``torch`` is the
plain PyTorch solver (fp64 Jacobi-PCG or fp32 on the scaled system);
``auto`` picks ``fused`` for fp32 and ``torch`` for fp64, as the JAX CLI
picks ``pallas`` for fp32 on one accelerator.
"""

from __future__ import annotations

import argparse
import sys

from poisson_tpu_torch.config import Problem

BACKENDS = ("auto", "torch", "fused", "resident", "ca")
FP32_BACKENDS = ("fused", "resident", "ca")

# Canvas passes per fused iteration: kernel A reads z, p, cS, cW, γ and
# writes pn, Ap; kernel B reads p, Ap, sc², w, r and writes w, r.
FUSED_PASSES_PER_ITER = 14


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch",
        description="Fictitious-domain Poisson PCG solve (PyTorch/CUDA port).",
    )
    p.add_argument("M", type=int, nargs="?", default=None,
                   help="grid cells in x (nodes: M+1)")
    p.add_argument("N", type=int, nargs="?", default=None,
                   help="grid cells in y (nodes: N+1)")
    p.add_argument("--M", type=int, default=None, dest="M_opt", metavar="M",
                   help="grid cells in x (same as positional M)")
    p.add_argument("--N", type=int, default=None, dest="N_opt", metavar="N",
                   help="grid cells in y (same as positional N)")
    p.add_argument("--delta", type=float, default=1e-6,
                   help="convergence threshold on ||w(k+1)-w(k)|| "
                        "(default 1e-6)")
    p.add_argument("--max-iter", type=int, default=None,
                   help="iteration cap (default (M-1)(N-1))")
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default="float32", help="state precision (default float32)")
    p.add_argument("--unweighted-norm", action="store_true",
                   help="stage0's unweighted convergence norm")
    p.add_argument("--repeat", type=int, default=1,
                   help="timed solve repetitions after the first; report "
                        "the best")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (default; raises without a card) or cpu, "
                        "which runs the kernels' plain versions")
    p.add_argument("--backend", choices=BACKENDS, default="auto",
                   help="auto: fused for float32, torch for float64; "
                        "resident and ca are the other fp32 paths")
    p.add_argument("--json", action="store_true",
                   help="one JSON line instead of a table")
    return p


def pick_backend(backend: str, dtype: str) -> str:
    if backend == "auto":
        return "fused" if dtype == "float32" else "torch"
    if backend in FP32_BACKENDS and dtype != "float32":
        raise SystemExit(f"--backend {backend} is an fp32 path; use "
                         "--backend torch for float64")
    return backend


def _grid(args) -> None:
    """Reconcile the positional and flag grid forms: exactly one per axis."""
    for axis in ("M", "N"):
        pos, opt = getattr(args, axis), getattr(args, f"{axis}_opt")
        if pos is not None and opt is not None:
            raise SystemExit(f"give {axis} either positionally or as "
                             f"--{axis}, not both")
        if pos is None and opt is None:
            raise SystemExit(f"missing grid size {axis} (positional or "
                             f"--{axis})")
        setattr(args, axis, pos if pos is not None else opt)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    _grid(args)
    if args.repeat < 1:
        raise SystemExit(f"--repeat must be >= 1, got {args.repeat}")
    problem = Problem(M=args.M, N=args.N, delta=args.delta,
                      max_iter=args.max_iter,
                      weighted_norm=not args.unweighted_norm)
    backend = pick_backend(args.backend, args.dtype)

    from poisson_tpu_torch.analysis import l2_error_host
    from poisson_tpu_torch.ops.ca_cg import PASSES_PER_PAIR, ca_cg_solve
    from poisson_tpu_torch.ops.fused_cg import (
        HALO,
        canvas_spec,
        fused_cg_solve,
    )
    from poisson_tpu_torch.ops.resident import (
        refuse_above_budget,
        resident_cg_solve,
    )
    from poisson_tpu_torch.solvers.pcg import (
        FLAG_CONVERGED,
        FLAG_NAMES,
        FLAG_NONE,
        pcg_solve,
    )
    from poisson_tpu_torch.utils.platform import device_name, resolve_device
    from poisson_tpu_torch.utils.timing import PhaseTimer, SolveReport, mlups

    if backend == "resident":
        try:
            refuse_above_budget(problem)
        except ValueError as e:
            raise SystemExit(f"--backend resident: {e}") from None
    device = resolve_device(args.device)
    solvers = {"fused": fused_cg_solve, "resident": resident_cg_solve,
               "ca": ca_cg_solve}
    # Canvas passes per iteration of the streaming paths; the resident solve
    # has no per-iteration device-memory figure (its state stays in L2).
    passes = {"fused": FUSED_PASSES_PER_ITER, "ca": PASSES_PER_PAIR / 2}
    bytes_per_iter = None
    if backend in solvers:
        run = lambda: solvers[backend](problem, device=device)
        # A device rate only from a device run.
        if device.type == "cuda" and backend in passes:
            cv = canvas_spec(problem)
            bytes_per_iter = int(passes[backend] * (cv.rows - 2 * HALO)
                                 * cv.cols * 4)
    else:
        run = lambda: pcg_solve(problem, dtype=args.dtype, device=device)

    timer = PhaseTimer(device)
    with timer.phase("first_solve"):   # builds kernels and canvases
        result = run()
    for i in range(args.repeat):
        with timer.phase(f"solve_{i}"):
            result = run()
    first = timer.times["first_solve"]
    best = min(timer.times[f"solve_{i}"] for i in range(args.repeat))

    iters = int(result.iterations)
    flag = int(result.flag)
    stopped = None if flag in (FLAG_NONE, FLAG_CONVERGED) else FLAG_NAMES[flag]
    report = SolveReport(
        M=problem.M, N=problem.N, iterations=iters, solve_seconds=best,
        first_solve_seconds=first,
        us_per_iter=best / max(1, iters) * 1e6,
        mlups=mlups(problem, iters, best), final_diff=float(result.diff),
        dtype=args.dtype, backend=backend, device=device.type,
        device_kind=device_name(device),
        l2_error=l2_error_host(problem, result.w),
        bytes_per_iter=bytes_per_iter,
        achieved_gbps=(None if bytes_per_iter is None
                       else bytes_per_iter * iters / best / 1e9),
        stopped=stopped,
    )
    print(report.json_line() if args.json else report.table())
    return 0


if __name__ == "__main__":
    sys.exit(main())
