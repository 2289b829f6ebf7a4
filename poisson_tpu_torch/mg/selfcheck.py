"""MG smoke check: ``python -m poisson_tpu_torch.mg.selfcheck --device
cpu|cuda`` (counterpart of ``poisson_tpu/mg/selfcheck.py``).

Three checks, each a one-line verdict, exit 0 iff all pass:

1. **Two-grid convergence factor**: the stationary cycle
   x ← x + B⁻¹(0 − Ax) on the textbook model problem (unit coefficients,
   square domain, h1 = h2) with a depth-2 hierarchy (exact dense coarse
   solve) must contract by < 0.2 per cycle.
2. **Deep V-cycle on the model problem**: the full hierarchy keeps the
   factor < 0.25.
3. **Iteration wall**: ``preconditioner="mg"`` needs at most a third of
   Jacobi's iterations on the reference problem at two resolutions,
   converging to the same δ.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch


def two_grid_factor(M: int, N: int, max_levels: int, cycles: int = 8,
                    dtype: str = "float64", device=None) -> float:
    """Worst per-cycle contraction of the stationary MG iteration on the
    isotropic unit-coefficient model problem, on ``device`` (default
    ``cuda``)."""
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.mg import MGConfig, hierarchy_from_fields, v_cycle
    from poisson_tpu_torch.ops.stencil import apply_A
    from poisson_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(device)
    p = Problem(M=M, N=N, x_min=-1.0, x_max=1.0, y_min=-1.0, y_max=1.0)
    cfg = MGConfig(max_levels=max_levels)
    ones = np.ones((p.M + 1, p.N + 1))
    hier = hierarchy_from_fields(p, ones, ones, dtype, False, cfg, dev)
    a = b = torch.tensor(ones, dtype=getattr(torch, dtype), device=dev)
    rng = np.random.default_rng(0)
    x0 = np.zeros((p.M + 1, p.N + 1))
    x0[1:-1, 1:-1] = rng.standard_normal((p.M - 1, p.N - 1))
    x = torch.tensor(x0, dtype=a.dtype, device=dev)
    prev = float(torch.linalg.norm(x))
    worst = 0.0
    for _ in range(cycles):
        x = x + v_cycle(hier, -apply_A(x, a, b, p.h1, p.h2), p.h1, p.h2,
                        cfg)
        cur = float(torch.linalg.norm(x))
        worst = max(worst, cur / prev)
        prev = cur
    return worst


def run_selfcheck(device=None) -> int:
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    failures = 0

    tg = two_grid_factor(64, 64, max_levels=2, device=device)
    ok = tg < 0.2
    print(f"[{'ok' if ok else 'FAIL'}] two-grid contraction on the "
          f"model problem: {tg:.4f} (< 0.2 required)")
    failures += 0 if ok else 1

    deep = two_grid_factor(64, 64, max_levels=16, device=device)
    ok = deep < 0.25
    print(f"[{'ok' if ok else 'FAIL'}] deep V-cycle contraction on the "
          f"model problem: {deep:.4f} (< 0.25 required)")
    failures += 0 if ok else 1

    for M, N in ((32, 32), (64, 96)):
        p = Problem(M=M, N=N)
        rj = pcg_solve(p, device=device)
        rm = pcg_solve(p, device=device, preconditioner="mg")
        kj, km = int(rj.iterations), int(rm.iterations)
        ok = (int(rm.flag) == 1 and float(rm.diff) < p.delta
              and km * 3 <= kj)
        print(f"[{'ok' if ok else 'FAIL'}] iteration wall {M}x{N}: "
              f"jacobi {kj} -> mg {km} (>=3x fewer, converged, "
              f"flag={int(rm.flag)})")
        failures += 0 if ok else 1

    if failures:
        print(f"mg selfcheck: {failures} check(s) FAILED")
        return 1
    print("mg selfcheck OK")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch.mg.selfcheck",
        description=__doc__.splitlines()[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    return run_selfcheck(args.device)


if __name__ == "__main__":
    sys.exit(main())
