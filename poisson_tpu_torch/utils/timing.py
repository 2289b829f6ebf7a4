"""Instrumentation: phase timing and the solve report (counterpart of
``poisson_tpu/utils/timing.py``).

PyTorch returns before the card has finished, so every phase boundary is
fenced with ``torch.cuda.synchronize()`` when the phase ran on a CUDA device;
a host clock without the fence would measure the enqueue, not the work.
Each phase is also an ``obs`` span, so a configured trace directory shows
it on the timeline, and :func:`count_solve` adds a solve to the JAX
package's counters.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import torch

from poisson_tpu_torch.config import Problem


def fence(device) -> None:
    """Wait for every kernel queued on ``device`` (no-op on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Named wall-clock phases, each fenced on ``device`` at its exit and
    recorded as an ``obs`` span of the same name (the fence is the
    timer's, so the span needs none of its own).

    >>> t = PhaseTimer("cpu")
    >>> with t.phase("solve"):
    ...     pass
    >>> sorted(t.times)
    ['solve']
    """

    def __init__(self, device="cuda") -> None:
        self.device = device
        self.times: dict[str, float] = {}

    def phase(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                from poisson_tpu_torch import obs

                fence(timer.device)
                self._span = obs.span(name, fence=False)
                self._span.__enter__()
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                fence(timer.device)
                self._span.__exit__(*exc)
                timer.times[name] = timer.times.get(name, 0.0) + (
                    time.perf_counter() - self._t0
                )

        return _Ctx()


def count_solve(result, compile_seconds: float,
                solve_seconds: float) -> str:
    """Add one reported solve to the counters, as the JAX package's
    ``solve_report`` does: ``pcg.solves.<verdict>`` and
    ``pcg.iterations.<verdict>`` (a batch's worst member's verdict, its
    slowest member's count), ``time.compile_seconds`` and
    ``time.execute_seconds``. Returns the verdict name: ``running`` for a
    solve stopped without one (a cap hit, or a path that tracks none),
    ``untracked`` for a result without a flag."""
    import numpy as np

    from poisson_tpu_torch import obs
    from poisson_tpu_torch.solvers.pcg import (
        FLAG_CONVERGED,
        FLAG_NAMES,
        FLAG_NONE,
        iterations_scalar,
    )

    flag = getattr(result, "flag", None)
    name = "untracked"
    if flag is not None:
        if isinstance(flag, torch.Tensor):
            flag = flag.cpu()
        flags = np.asarray(flag).ravel()
        failures = flags[(flags != FLAG_NONE) & (flags != FLAG_CONVERGED)]
        if failures.size:
            verdict = int(failures.max())
        elif (flags == FLAG_NONE).any():
            verdict = FLAG_NONE
        else:
            verdict = int(flags.max()) if flags.size else FLAG_NONE
        name = ("running" if verdict == FLAG_NONE
                else FLAG_NAMES.get(verdict, str(verdict)))
    obs.inc(f"pcg.solves.{name}")
    obs.inc(f"pcg.iterations.{name}", iterations_scalar(result.iterations))
    obs.inc("time.compile_seconds", max(0.0, compile_seconds))
    obs.inc("time.execute_seconds", max(0.0, solve_seconds))
    return name


def mlups(problem: Problem, iterations: int, seconds: float) -> float:
    """Million lattice-site updates per second: interior·iters/time/1e6."""
    return problem.interior_points * iterations / seconds / 1e6


@dataclasses.dataclass
class SolveReport:
    """One solve's result line, as structured data, with the JAX report's
    fields (``poisson_tpu/utils/timing.py:SolveReport``) beside the port's.

    ``first_solve_seconds`` includes the one-time work of the first call
    (kernel build and load, canvas setup and upload); ``solve_seconds`` is
    the best of the timed repeats that follow, and ``compile_seconds`` the
    first call's extra time over it. ``devices`` counts the cards the solve
    ran on (0 for the native oracle on the host). ``bytes_per_iter_model``
    is the backend's bytes model (``obs.costs.iteration_bytes``; also read
    as ``bytes_per_iter``), ``achieved_gbps`` that model over the measured
    time and ``roofline_fraction`` its share of the device's bandwidth
    ceiling: None where the backend has no model, the run was not on a
    card, or no ceiling is on file."""

    M: int
    N: int
    iterations: int
    solve_seconds: float
    first_solve_seconds: float
    us_per_iter: float
    mlups: float
    final_diff: float
    dtype: str
    backend: str
    device: str
    device_kind: str
    l2_error: Optional[float] = None
    bytes_per_iter_model: Optional[float] = None
    achieved_gbps: Optional[float] = None
    roofline_fraction: Optional[float] = None
    compile_seconds: Optional[float] = None
    devices: int = 1
    # Batched solves: the batch size and each member's count (``iterations``
    # then holds the slowest member's).
    batch: Optional[int] = None
    iterations_per_member: Optional[list] = None
    stopped: Optional[str] = None
    mesh: Optional[tuple[int, int]] = None   # (Px, Py) of a sharded solve
    # Host seconds of an MG solve's level hierarchy, built before the first
    # solve and in neither solve time.
    hierarchy_seconds: Optional[float] = None
    # Recovery provenance of a resilient solve (the JAX report's fields):
    # attempts taken and the (iteration, verdict, action) history.
    restarts: Optional[int] = None
    recovery: Optional[tuple] = None

    @property
    def bytes_per_iter(self) -> Optional[float]:
        return self.bytes_per_iter_model

    def json_line(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    def table(self) -> str:
        rows = [
            f"M={self.M}, N={self.N} | Iter={self.iterations} "
            f"| Time={self.solve_seconds:.4f} s",
            f"  first solve: {self.first_solve_seconds:.2f} s   dtype: "
            f"{self.dtype}   backend: {self.backend} [{self.device_kind}]"
            + (f"   mesh: {self.mesh[0]}x{self.mesh[1]}"
               if self.mesh is not None else ""),
            f"  throughput: {self.mlups:.0f} MLUPS   "
            f"{self.us_per_iter:.1f} us/iter   final ||dw||: "
            f"{self.final_diff:.3e}"
            + (f"   L2 err vs analytic: {self.l2_error:.3e}"
               if self.l2_error is not None else ""),
        ]
        if self.achieved_gbps is not None:
            rows.append(
                f"  attribution: {self.achieved_gbps:.1f} GB/s "
                f"({self.bytes_per_iter_model:.0f} bytes/iter model)"
                + (f" = {self.roofline_fraction:.0%} of roofline"
                   if self.roofline_fraction is not None
                   else " (no bandwidth ceiling on file for this device; "
                        "set POISSON_TPU_PEAK_GBPS)"))
        if self.hierarchy_seconds is not None:
            rows.append(f"  MG hierarchy build: {self.hierarchy_seconds:.2f} s "
                        "(host, before the first solve)")
        if self.restarts:
            detail = "; ".join(
                f"iter {k}: {verdict} -> {action}"
                for k, verdict, action in (self.recovery or ()))
            rows.append(f"  recovered: {self.restarts} restart(s)"
                        + (f" ({detail})" if detail else ""))
        if self.stopped is not None:
            rows.append(f"  WARNING: solve stopped without converging "
                        f"({self.stopped})")
        return "\n".join(rows)
