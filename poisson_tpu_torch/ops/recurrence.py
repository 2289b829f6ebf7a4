"""The scalar recurrence of one fused CG iteration on the scaled system
(z = r), shared by the fused body (``ops.fused_cg``) and the sharded one
(``parallel.fused_sharded``). A done state is frozen (α is forced to 0,
and k, ζ, β and diff keep their values); a degenerate direction
(⟨Ap, p⟩ ≈ 0) gets α = 0 and stops the loop.

Each half runs on the device of the sums it reads. On a card it is one
launch of a kernel of ``csrc/fused_cg.cu`` (``recurrence_step_kernel``,
``recurrence_close_kernel``), counted as ``ops.launches.recurrence_step``
and ``ops.launches.recurrence_close``; on the CPU it is its plain version
(:meth:`Recurrence.step_size_plain`, :meth:`Recurrence.close_plain`),
plain tensor operations that the kernel repeats one for one, each rounded
alone, so both give the same bits. Either way the results are fresh 0-d
tensors: int32 k, bool ``done`` and ``degenerate``, fp32 α, ζ, β and diff.
"""

from __future__ import annotations

import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops._build import load_kernels
from poisson_tpu_torch.ops.launch import launch
from poisson_tpu_torch.solvers.pcg import _DENOM_TOL


def _pointers(device: torch.device, *operands) -> list:
    """The data pointers of ``operands``, (tensor, dtype) pairs, each one
    element of that dtype on ``device``; anything else raises."""
    ptrs = []
    for t, dtype in operands:
        if t.device != device or t.dtype != dtype or t.numel() != 1:
            raise ValueError(f"a recurrence operand must be one {dtype} "
                             f"element on {device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        ptrs.append(t.data_ptr())
    return ptrs


def _empty(device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty((), dtype=dtype, device=device)


class Recurrence:
    """The recurrence of ``problem``, its constants (h1·h2, the norm's
    weight, δ) as fp32 tensors on ``device`` and, for the kernels, as the
    same fp32 values by value (``values``)."""

    def __init__(self, problem: Problem, device: torch.device):
        h1h2 = torch.tensor(problem.h1 * problem.h2, dtype=torch.float32)
        norm_w = (h1h2 if problem.weighted_norm
                  else torch.tensor(1.0, dtype=torch.float32))
        delta = torch.tensor(problem.delta, dtype=torch.float32)
        self.values = tuple(float(c) for c in (h1h2, norm_w, delta))
        self.h1h2, self.norm_w, self.delta = (
            c.to(device) for c in (h1h2, norm_w, delta))

    def step_size(self, s, denom_sum):
        """(α, degenerate) of state ``s`` from Σ⟨Ap, p⟩."""
        dev = denom_sum.device
        if dev.type != "cuda":
            return self.step_size_plain(s, denom_sum)
        alpha = _empty(dev, torch.float32)
        degenerate = _empty(dev, torch.bool)
        launch(load_kernels("fused_cg"), "fused_cg_recurrence_step",
               "recurrence_step", dev,
               *_pointers(dev, (denom_sum, torch.float32),
                          (s.zr, torch.float32), (s.done, torch.bool),
                          (alpha, torch.float32), (degenerate, torch.bool)),
               self.values[0])
        return alpha, degenerate

    def close(self, s, alpha, degenerate, diff_sum, zr_sum) -> dict:
        """The fields k, done, ζ, β and diff of the state after ``s``, from
        the step's α and ``degenerate`` and the sums Σ p²·sc² and Σ r²."""
        dev = diff_sum.device
        if dev.type != "cuda":
            return self.close_plain(s, alpha, degenerate, diff_sum, zr_sum)
        out = dict(k=_empty(dev, torch.int32), done=_empty(dev, torch.bool),
                   zr=_empty(dev, torch.float32),
                   beta=_empty(dev, torch.float32),
                   diff=_empty(dev, torch.float32))
        f32, i32, b = torch.float32, torch.int32, torch.bool
        launch(load_kernels("fused_cg"), "fused_cg_recurrence_close",
               "recurrence_close", dev,
               *_pointers(dev, (alpha, f32), (degenerate, b),
                          (diff_sum, f32), (zr_sum, f32), (s.k, i32),
                          (s.done, b), (s.zr, f32), (s.beta, f32),
                          (s.diff, f32), (out["k"], i32), (out["done"], b),
                          (out["zr"], f32), (out["beta"], f32),
                          (out["diff"], f32)),
               *self.values)
        return out

    def step_size_plain(self, s, denom_sum):
        """:meth:`step_size` in plain tensor operations, on any device."""
        denom = denom_sum * self.h1h2
        degenerate = torch.abs(denom) < _DENOM_TOL
        alpha = torch.where(degenerate | s.done, 0.0,
                            s.zr / torch.where(degenerate, 1.0, denom))
        return alpha, degenerate

    def close_plain(self, s, alpha, degenerate, diff_sum, zr_sum) -> dict:
        """:meth:`close` in plain tensor operations, on any device."""
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
