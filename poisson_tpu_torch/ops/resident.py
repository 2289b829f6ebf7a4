"""The whole solve in one kernel launch: kernel R, a persistent cooperative
CUDA kernel for Hopper (counterpart of ``poisson_tpu/ops/pallas_resident.py``).

The JAX package keeps the whole solver state in one TensorCore's VMEM and
runs the PCG loop inside one ``pallas_call`` (``_make_resident_kernel``).
Here kernel R runs the same loop in one cooperative launch of one block
per SM (``csrc/resident_cg.cu``). Each block owns a contiguous range of
band rows (:func:`resident_layout`, which the CPU tests check) and keeps
its part of the state on chip for the whole solve: the direction, cS, cW,
γ, sc² and w in shared memory, r and Ap in registers. Only the edge rows of
r and p cross blocks, through a small exchange buffer; the blocks meet
twice per iteration, where each publishes its partials tagged with the
step and waits for everyone's, and every block sums them in one fixed
order, so all of them hold the same α, β and stop decision. The host
launches once and reads k, diff and ζ at the end. The arithmetic is the
fused path's (difference-form stencil on the scaled system); only the order
of the sums differs, so the counts are the golden ones and the iterates
agree with the plain version to fp32 round-off, not bit for bit.

The canvas is the fused path's full-width single strip, which is the
geometry of ``pallas_resident.resident_canvas``.

Capacity (:func:`fits_resident`). The JAX gate counts 12 canvases against
15 MiB of VMEM, a TPU number. The port's gate counts 9 canvases (cS, cW, γ,
sc², w, r, p, pn, Ap) against 40 MB (``RESIDENT_BUDGET_BYTES``), a share of
the H100's 50 MB L2, the home of whatever the on-chip layout cannot hold:

    400×600   canvas 416×640   9 × 4 B × 266,240   =   9.6 MB  admitted
    800×1200  canvas 816×1280  9 × 4 B × 1,044,480 =  37.6 MB  admitted
    2400×3200 canvas 2416×3328 9 × 4 B × 8,040,448 = 289.5 MB  refused

At both admitted grids above the whole state fits on chip (69,120 and
230,400 bytes of shared memory per block, 8 and 20 points per thread in
registers).
It admits every grid the JAX gate admits (40×40, 40×300, 400×600).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops._build import check, load_kernels
from poisson_tpu_torch.ops.launch import launch
from poisson_tpu_torch.ops.fused_cg import (
    HALO,
    Canvas,
    _check_operands,
    _fused_solve,
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

# Kernel R's constants (``csrc/resident_cg.cu``, checked when the library
# loads) and the H100's, for the layout the tests check on the CPU; on the
# card the wrapper queries the SM count and the shared memory.
THREADS = 512        # threads per block
REG_POINTS = 20      # band points per thread held in registers (r, Ap)
FIELDS = ("pn", "cs", "cw", "g", "sc2", "w")   # fields placed, in order
MAX_BLOCKS = 256     # partials one warp gathers
H100_SMS = 132
H100_SMEM_PER_BLOCK = 232_448   # bytes a block may opt in to (227 KB)
SMEM_RESERVE = 1024  # kept back for the kernel's static shared memory


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


class ResidentLayout(NamedTuple):
    """Kernel R's launch geometry on one card (:func:`resident_layout`)."""

    blocks: int          # one per SM (at most MAX_BLOCKS), or one per
                         # band row if fewer
    row0: tuple          # each block's first band row
    nrows: tuple         # each block's band rows
    rmax: int            # the most rows any block owns
    offsets: tuple       # per field of FIELDS: shared offset (floats) >= 0,
                         # or -1 - (offset in the block's spill region)
    smem_bytes: int      # dynamic shared memory per block
    spill_stride: int    # floats of each block's spill region (at least 4)
    exchange: int        # floats of the exchange buffer: blocks x 4 x cols
    points_per_thread: int   # the most band points one thread owns, in
                             # groups of 4 consecutive points
    reg_points: int      # of those, held in registers (the rest in the
                         # r, w and Ap canvases)


def field_floats(rmax: int, cols: int) -> dict:
    """Floats each on-chip field of a block of ``rmax`` rows takes, in the
    order the layout places them: pn with a halo row above and below, cS
    with the row below, then cW, γ, sc² and w."""
    return {"pn": (rmax + 2) * cols, "cs": (rmax + 1) * cols,
            "cw": rmax * cols, "g": rmax * cols, "sc2": rmax * cols,
            "w": rmax * cols}


def resident_layout(cv: Canvas, sms: int = H100_SMS,
                    smem_per_block: int = H100_SMEM_PER_BLOCK
                    ) -> ResidentLayout:
    """Kernel R's geometry on a card of ``sms`` SMs whose blocks may take
    ``smem_per_block`` bytes of shared memory: the band rows split into
    contiguous ranges, one per block, as evenly as they go (the first
    ``band % blocks`` blocks own one row more); the fields placed in
    dynamic shared memory in the order of :func:`field_floats`, each that
    does not fit in the block's spill region of device memory instead. The
    kernel recomputes the same row ranges from the block index."""
    band = cv.rows - 2 * HALO
    blocks = min(sms, band, MAX_BLOCKS)
    base, extra = divmod(band, blocks)
    nrows = tuple(base + (b < extra) for b in range(blocks))
    row0 = tuple(b * base + min(b, extra) for b in range(blocks))
    rmax = max(nrows)
    budget = (smem_per_block - SMEM_RESERVE) // 4
    used = spilled = 0
    offsets = []
    for size in field_floats(rmax, cv.cols).values():
        if used + size <= budget:
            offsets.append(used)
            used += size
        else:
            offsets.append(-1 - spilled)
            spilled += size
    ppt = 4 * -(-rmax * cv.cols // (4 * THREADS))
    return ResidentLayout(
        blocks=blocks, row0=row0, nrows=nrows, rmax=rmax,
        offsets=tuple(offsets), smem_bytes=used * 4,
        spill_stride=max(spilled, 4), exchange=blocks * 4 * cv.cols,
        points_per_thread=ppt, reg_points=min(ppt, REG_POINTS))


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library, checked to use this module's constants."""
    kernels = load_kernels("resident_cg")
    got = [ctypes.c_int() for _ in range(4)]
    kernels.lib.resident_cg_layout(*(ctypes.byref(v) for v in got))
    consts = tuple(v.value for v in got)
    want = (THREADS, REG_POINTS, len(FIELDS), MAX_BLOCKS)
    if consts != want:
        raise RuntimeError(f"{kernels.path.name} has (threads, register "
                           f"points, fields, blocks) {consts}; this module "
                           f"expects {want}")
    return kernels


@functools.lru_cache(maxsize=None)
def card_geometry(device_index: int) -> tuple[int, int]:
    """(SM count, shared memory a block may opt in to) of this card; raises
    if the card has no cooperative launch."""
    kernels = _kernels()
    sms, smem = ctypes.c_int(), ctypes.c_int()
    check(kernels, kernels.lib.resident_cg_device(
        device_index, ctypes.byref(sms), ctypes.byref(smem)),
        "resident_cg device query (cooperative launch)")
    return sms.value, smem.value


def resident_solve(problem: Problem, cv: Canvas, cs, cw, g, rhs, sc2):
    """Kernel R: the whole solve in one launch. Returns (w canvas, k, diff,
    ζ) as device tensors. On CPU tensors, the plain version."""
    dev = _check_operands(cv, dict(cs=cs, cw=cw, g=g, rhs=rhs, sc2=sc2))
    if dev.type == "cpu":
        return resident_solve_plain(problem, cv, cs, cw, g, rhs, sc2)
    kernels = _kernels()
    lay = resident_layout(cv, *card_geometry(dev.index or 0))
    # r and Ap hold only the points past the registers; w is the output.
    w, r, ap = (torch.zeros_like(rhs) for _ in range(3))
    f32 = dict(dtype=torch.float32, device=dev)
    xch = torch.empty(lay.exchange, **f32)
    spill = torch.empty(lay.blocks * lay.spill_stride, **f32)
    # Tagged partials: zeroed, so no slot carries a tag before it is
    # published (the kernel's tags start at 1).
    part = torch.zeros(3 * lay.blocks, dtype=torch.int64, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    diff = torch.empty((), **f32)
    zr = torch.empty((), **f32)
    h1h2 = problem.h1 * problem.h2
    launch(kernels, "resident_cg_solve", "resident_solve", dev,
           cs.data_ptr(), cw.data_ptr(), g.data_ptr(), rhs.data_ptr(),
           sc2.data_ptr(), w.data_ptr(), r.data_ptr(), ap.data_ptr(),
           xch.data_ptr(), spill.data_ptr(), part.data_ptr(), k.data_ptr(),
           diff.data_ptr(), zr.data_ptr(), h1h2,
           h1h2 if problem.weighted_norm else 1.0, problem.delta,
           problem.iteration_cap, cv.rows, cv.cols, HALO, *lay.offsets,
           lay.spill_stride, lay.smem_bytes, lay.blocks)
    return w, k, diff, zr




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
