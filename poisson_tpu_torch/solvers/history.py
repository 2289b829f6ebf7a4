"""Fixed-budget diagnostic solve: per-iteration convergence history
(counterpart of ``poisson_tpu/solvers/history.py``).

Runs exactly ``budget`` steps of the shared PCG body and records ‖Δw‖,
ζ = (z, r) and, optionally, the L2(D) error against the analytic solution
at every step — the reference report's L2-error-vs-iteration curve. The
curves are written into preallocated device tensors, one slot per step, so
the loop never syncs with the host. Once the δ-criterion (or a degenerate
direction) fires the state freezes: the curve is flat after convergence
and ``iterations`` matches ``solvers.pcg.pcg_solve``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.models.fictitious_domain import (
    analytic_solution,
    is_in_domain,
)
from poisson_tpu_torch.solvers.pcg import (
    init_state,
    make_pcg_body,
    solve_setup,
)


class HistoryResult(NamedTuple):
    w: torch.Tensor            # final solution, full grid, unscaled
    iterations: torch.Tensor   # iterations until convergence (or budget)
    diffs: torch.Tensor        # ‖w(k+1)−w(k)‖ per step, shape (budget,)
    residual_dots: torch.Tensor  # ζ per step
    l2_errors: Optional[torch.Tensor]  # L2(D) error per step (or None)


def _l2_error_fn(problem: Problem, dtype: torch.dtype, device):
    """w → the L2(D) error against the analytic solution, computed in the
    state's dtype as the JAX package's history computes it."""
    np_dtype = np.dtype(str(dtype).removeprefix("torch."))
    u = analytic_solution(problem, dtype=np_dtype)
    i = np.arange(problem.M + 1).astype(np_dtype)
    j = np.arange(problem.N + 1).astype(np_dtype)
    x = (np_dtype.type(problem.x_min) + i * np_dtype.type(problem.h1))[:, None]
    y = (np_dtype.type(problem.y_min) + j * np_dtype.type(problem.h2))[None, :]
    mask = torch.from_numpy(np.asarray(is_in_domain(x, y))).to(device)
    u = torch.from_numpy(np.asarray(u, np_dtype)).to(device)
    hh = problem.h1 * problem.h2
    return lambda w: torch.sqrt(
        torch.sum(torch.where(mask, (w - u) ** 2, 0.0)) * hh)


def pcg_solve_history(problem: Problem, budget: int, dtype=None,
                      scaled=None, record_error: bool = True,
                      device=None) -> HistoryResult:
    """Run exactly ``budget`` steps (the state freezes once it stops) and
    return the per-step curves, on ``device`` (default ``cuda``)."""
    if budget < 1:
        raise ValueError(f"budget must be >= 1, got {budget}")
    setup = solve_setup(problem, dtype, scaled, device)
    rhs, aux = setup.rhs, setup.aux
    body = make_pcg_body(setup.ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm,
                         h1=problem.h1, h2=problem.h2)
    diffs = rhs.new_empty(budget)
    zrs = rhs.new_empty(budget)
    errs = rhs.new_empty(budget) if record_error else None
    l2_err = (_l2_error_fn(problem, rhs.dtype, rhs.device)
              if record_error else None)
    s = init_state(setup.ops, rhs)
    for step in range(budget):
        s = body(s)                 # a done state passes through frozen
        diffs[step] = s.diff
        zrs[step] = s.zr
        if record_error:
            errs[step] = l2_err(s.w * aux if setup.scaled else s.w)
    w = s.w * aux if setup.scaled else s.w
    return HistoryResult(w=w, iterations=s.k, diffs=diffs,
                         residual_dots=zrs, l2_errors=errs)
