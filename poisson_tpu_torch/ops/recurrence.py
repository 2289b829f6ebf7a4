"""The scalar recurrence of one fused CG iteration on the scaled system
(z = r), shared by the fused body (``ops.fused_cg``) and the sharded one
(``parallel.fused_sharded``): plain tensor operations on the device of the
step's scalars. A done state is frozen (α is forced to 0, and k, ζ, β and
diff keep their values); a degenerate direction (⟨Ap, p⟩ ≈ 0) gets α = 0
and stops the loop.
"""

from __future__ import annotations

import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.solvers.pcg import _DENOM_TOL


class Recurrence:
    """The recurrence of ``problem``, its constants (h1·h2, the norm's
    weight, δ) on ``device``."""

    def __init__(self, problem: Problem, device: torch.device):
        f32 = dict(dtype=torch.float32, device=device)
        self.h1h2 = torch.tensor(problem.h1 * problem.h2, **f32)
        self.norm_w = (self.h1h2 if problem.weighted_norm
                       else torch.tensor(1.0, **f32))
        self.delta = torch.tensor(problem.delta, **f32)

    def step_size(self, s, denom_sum):
        """(α, degenerate) of state ``s`` from Σ⟨Ap, p⟩."""
        denom = denom_sum * self.h1h2
        degenerate = torch.abs(denom) < _DENOM_TOL
        alpha = torch.where(degenerate | s.done, 0.0,
                            s.zr / torch.where(degenerate, 1.0, denom))
        return alpha, degenerate

    def close(self, s, alpha, degenerate, diff_sum, zr_sum) -> dict:
        """The fields k, done, ζ, β and diff of the state after ``s``, from
        the step's α and ``degenerate`` and the sums Σ p²·sc² and Σ r²."""
        diff = torch.abs(alpha) * torch.sqrt(diff_sum * self.norm_w)
        zr_new = zr_sum * self.h1h2
        live = ~s.done
        return dict(
            k=s.k + live.to(torch.int32),
            done=s.done | degenerate | (diff < self.delta),
            zr=torch.where(live, zr_new, s.zr),
            beta=torch.where(
                live, zr_new / torch.where(s.zr == 0.0, 1.0, s.zr), s.beta),
            diff=torch.where(live, diff, s.diff),
        )
