"""The whole solve in one kernel launch: kernel R, a persistent cooperative
CUDA kernel for Hopper (counterpart of ``poisson_tpu/ops/pallas_resident.py``).

The JAX package keeps the whole solver state in one TensorCore's VMEM and
runs the PCG loop inside one ``pallas_call`` (``_make_resident_kernel``).
Here kernel R runs the same loop in one cooperative launch: a grid of blocks
that stay resident together walks the band, meets at two grid syncs per
iteration, and every block sums the partials in one fixed order, so all of
them hold the same α, β and stop decision (``csrc/resident_cg.cu``). The
host launches once and reads k, diff and ζ at the end. The arithmetic is the
fused path's (difference-form stencil on the scaled system); only the order
of the sums differs, so the counts are the golden ones and the iterates
agree with the plain version to fp32 round-off, not bit for bit.

The canvas is the fused path's full-width single strip, which is the
geometry of ``pallas_resident.resident_canvas``.

Capacity (:func:`fits_resident`). The JAX gate counts 12 canvases against
15 MiB of VMEM, a TPU number. Kernel R keeps 9 canvases live — cS, cW, γ,
sc², w, r, the direction pair p and pn, and Ap — in device memory, and is
fast while they stay in the H100's 50 MB L2. The budget is 40 MB
(``RESIDENT_BUDGET_BYTES``), leaving 10 MB of L2 for the partials and
whatever else the card caches:

    400×600   canvas 416×640   9 × 4 B × 266,240   =   9.6 MB  admitted
    800×1200  canvas 816×1280  9 × 4 B × 1,044,480 =  37.6 MB  admitted
    2400×3200 canvas 2416×3328 9 × 4 B × 8,040,448 = 289.5 MB  refused

It admits every grid the JAX gate admits (40×40, 40×300, 400×600).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops._build import check, load_kernels
from poisson_tpu_torch.ops.fused_cg import (
    HALO,
    Canvas,
    _check_operands,
    _fused_solve,
    _stream,
    build_canvases,
    canvas_spec,
    canvas_to_w64,
    direction_and_stencil_plain,
    fused_update_plain,
    scaled_rhs_canvas,
)
from poisson_tpu_torch.solvers.pcg import CHECK_EVERY, PCGResult

LIVE_CANVASES = 9
RESIDENT_BUDGET_BYTES = 40_000_000


def resident_canvas(problem: Problem) -> Canvas:
    """Single-strip canvas covering the whole interior (the fused path's)."""
    return canvas_spec(problem, bn=0)


def resident_bytes(problem: Problem) -> int:
    """Device bytes of the canvases kernel R keeps live."""
    cv = resident_canvas(problem)
    return LIVE_CANVASES * cv.rows * cv.cols * 4


def fits_resident(problem: Problem) -> bool:
    return resident_bytes(problem) <= RESIDENT_BUDGET_BYTES


def refuse_above_budget(problem: Problem) -> None:
    """Raise ``ValueError``, naming the budget, for a grid that does not
    fit."""
    if not fits_resident(problem):
        raise ValueError(
            f"grid {problem.M}x{problem.N} keeps "
            f"{resident_bytes(problem) / 1e6:.1f} MB live in the resident "
            f"solve, over the {RESIDENT_BUDGET_BYTES / 1e6:.0f} MB residency "
            "budget (of the 50 MB L2); use the fused or the CA solve"
        )


def _direction_and_stencil_plain(cv: Canvas, beta, z, p, cs, cw, g, out):
    pn, ap = out
    return pn, ap, direction_and_stencil_plain(cv, beta, z, p, cs, cw, g,
                                               pn, ap)


def _fused_update_plain(cv: Canvas, alpha, p, ap, sc2, w, r):
    return (w, r, *fused_update_plain(cv, alpha, p, ap, sc2, w, r))


def resident_solve_plain(problem: Problem, cv: Canvas, cs, cw, g, rhs, sc2,
                         check_every: int = CHECK_EVERY):
    """Kernel R's plain version, on any device: the fused iteration driven
    with kernels A's and B's plain versions, whose per-point arithmetic
    kernel R repeats in the same order (only the order of the sums
    differs), to done or the cap. Returns (w canvas, k, diff, ζ)."""
    s = _fused_solve(problem, cv, cs, cw, g, rhs, sc2, check_every,
                     kernels=(_direction_and_stencil_plain,
                              _fused_update_plain))
    return s.w, s.k, s.diff, s.zr


@functools.lru_cache(maxsize=None)
def _grid_blocks(device_index: int) -> int:
    """Kernel R's cooperative grid on this card (SM count × occupancy);
    raises if the card has no cooperative launch."""
    kernels = load_kernels("resident_cg")
    blocks = ctypes.c_int()
    check(kernels, kernels.lib.resident_cg_grid(device_index,
                                                ctypes.byref(blocks)),
          "resident_cg grid query (cooperative launch)")
    return blocks.value


def resident_solve(problem: Problem, cv: Canvas, cs, cw, g, rhs, sc2):
    """Kernel R: the whole solve in one launch. Returns (w canvas, k, diff,
    ζ) as device tensors. On CPU tensors, the plain version."""
    dev = _check_operands(cv, dict(cs=cs, cw=cw, g=g, rhs=rhs, sc2=sc2))
    if dev.type == "cpu":
        return resident_solve_plain(problem, cv, cs, cw, g, rhs, sc2)
    kernels = load_kernels("resident_cg")
    blocks = _grid_blocks(dev.index or 0)
    w, r, p0, p1, ap = (torch.zeros_like(rhs) for _ in range(5))
    part = torch.empty(3 * blocks, dtype=torch.float32, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    diff = torch.empty((), dtype=torch.float32, device=dev)
    zr = torch.empty((), dtype=torch.float32, device=dev)
    h1h2 = problem.h1 * problem.h2
    code = kernels.lib.resident_cg_solve(
        cs.data_ptr(), cw.data_ptr(), g.data_ptr(), rhs.data_ptr(),
        sc2.data_ptr(), w.data_ptr(), r.data_ptr(), p0.data_ptr(),
        p1.data_ptr(), ap.data_ptr(), part.data_ptr(), k.data_ptr(),
        diff.data_ptr(), zr.data_ptr(), h1h2,
        h1h2 if problem.weighted_norm else 1.0, problem.delta,
        problem.iteration_cap, cv.rows, cv.cols, HALO, blocks,
        dev.index or 0, _stream(dev),
    )
    check(kernels, code, "resident_cg cooperative launch")
    resident_solve.launches += 1
    return w, k, diff, zr


resident_solve.launches = 0


def reset_launch_counts() -> None:
    resident_solve.launches = 0


def launch_counts() -> dict:
    return {"resident_solve": resident_solve.launches}


def resident_cg_solve(problem: Problem, device=None,
                      rhs_gate=None) -> PCGResult:
    """Single-device solve with the whole PCG loop in one kernel launch: the
    counterpart of ``poisson_tpu.ops.pallas_resident.resident_cg_solve``,
    with the same counts as the other fp32 paths. Runs on ``cuda`` unless
    ``device='cpu'`` is asked for (plain version). Raises ``ValueError``
    above the residency budget (:func:`fits_resident`)."""
    refuse_above_budget(problem)
    cv, cs, cw, g, rhs, sc2, sc_int = build_canvases(problem, device, bn=0)
    if rhs_gate is not None:
        rhs = rhs * torch.as_tensor(rhs_gate, dtype=rhs.dtype,
                                    device=rhs.device)
    w, k, diff, zr = resident_solve(problem, cv, cs, cw, g, rhs, sc2)
    M, N = problem.M, problem.N
    sol = F.pad(w[HALO : HALO + M - 1, 1:N] * sc_int, (1, 1, 1, 1))
    return PCGResult(w=sol, iterations=k, diff=diff, residual_dot=zr)


def resident_cg_solve_rhs(problem: Problem, rhs_grid64, device=None):
    """Resident solve of ``A w = rhs`` for a caller-supplied RHS grid (fp64
    host array, full (M+1, N+1) shape): each inner solve of mixed-precision
    refinement is one launch (``pallas_resident.resident_cg_solve_rhs``).

    Returns ``(w64, iterations)`` with w accumulated on the host in fp64."""
    refuse_above_budget(problem)
    cv, cs, cw, g, _, sc2, sc_int = build_canvases(problem, device, bn=0)
    rhs = scaled_rhs_canvas(problem, cv, rhs_grid64, cs.device)
    w, k, _, _ = resident_solve(problem, cv, cs, cw, g, rhs, sc2)
    return canvas_to_w64(problem, cv, w, sc_int), int(k)
