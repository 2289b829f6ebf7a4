"""Solution-quality analysis: the analytic accuracy control (counterpart of
``poisson_tpu/analysis.py``).

The reference's final report controls accuracy against the exact solution
u = (1 − x² − 4y²)/10; the error is measured at nodes strictly inside the
ellipse, where the PDE holds (outside D the fictitious-domain solution is
O(ε)-small but nonzero by design).
"""

from __future__ import annotations

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.models.fictitious_domain import (
    analytic_solution,
    is_in_domain,
)


def _inside_mask(problem: Problem) -> np.ndarray:
    i = np.arange(problem.M + 1)
    j = np.arange(problem.N + 1)
    x = (problem.x_min + i.astype(np.float64) * problem.h1)[:, None]
    y = (problem.y_min + j.astype(np.float64) * problem.h2)[None, :]
    return is_in_domain(x, y)


def l2_error_vs_analytic(problem: Problem, w: torch.Tensor) -> torch.Tensor:
    """Weighted L2 error over nodes strictly inside the ellipse, computed in
    ``w``'s dtype on ``w``'s device (a 0-d tensor)."""
    u = torch.tensor(analytic_solution(problem), dtype=w.dtype,
                     device=w.device)
    mask = torch.tensor(_inside_mask(problem), device=w.device)
    err2 = torch.where(mask, (w - u) ** 2, 0.0)
    return torch.sqrt(torch.sum(err2) * (problem.h1 * problem.h2))


def l2_error_host(problem: Problem, w) -> float:
    """Host-side fp64 variant (numpy), plain float out — the form the
    reports consume. ``w`` may be a tensor on any device or an array."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().numpy()
    w = np.asarray(w, np.float64)
    u = analytic_solution(problem)
    err2 = np.where(_inside_mask(problem), (w - u) ** 2, 0.0)
    return float(np.sqrt(np.sum(err2) * (problem.h1 * problem.h2)))
