"""The fused two-sweep PCG iteration on the GPU: kernels A and B in CUDA for
Hopper (counterpart of ``poisson_tpu/ops/pallas_cg.py``).

Each iteration is two sweeps over the canvases:

  kernel A (``direction_and_stencil``), replaces the Pallas kernel
  ``_make_direction_stencil_kernel``:
      pn ← z + β·p on the live row band (0 elsewhere)
      Ap ← Ã·pn in difference form Σ_k c̃_k(pᵢⱼ − p_k) + γᵢⱼ·pᵢⱼ
      per-block partials of ⟨Ap, pn⟩

  kernel B (``fused_update``), replaces the Pallas kernel
  ``_make_update_kernel``:
      w ← w + α·pn;  r ← r − α·Ap   (in place)
      per-block partials of Σ pn²·sc² (the convergence sum) and Σ r² (ζ)

The solver runs on the symmetrically scaled system Ã = D^{-1/2}AD^{-1/2}
(unit diagonal, so z = r and the preconditioner costs nothing), with the
scaling folded into two coefficient canvases cS, cW (c̃N and c̃E are cS and cW
shifted by +1 row and +1 column) and the diagonal residual γ. The difference
form pairs adjacent values in every product, which is what lets fp32
reproduce the fp64 golden iteration counts (see
:func:`diagonal_residual_canvas`).

Canvas layout (the JAX package's, so that tests compare canvases element by
element): interior row ii at canvas row HALO+ii with HALO guard rows above
and below; global column j at canvas column cg+j, columns padded to a
multiple of 128 (which also keeps every row 512-byte aligned for coalesced
loads). On the full-width canvas (cg = 0) the strip height ``bm`` is a TPU
VMEM notion that the GPU kernels ignore: unless a caller asks for one, the
canvas is one strip, as in ``pallas_resident.resident_canvas``. A grid too
wide for a sane full-width strip gets the JAX package's column-blocked
canvas (:func:`canvas_spec`): cg = 128 guard columns on each side and the
content cut into bm-row strips and bn-column blocks, which kernels A′ and
B′ (``csrc/blocked_cg.cu``) sweep tile by tile. Everything outside the
interior is zero, so the kernels need no masks. A shard's canvas holds its
neighbours' values around the points it owns; the sharded solve
(``parallel.fused_sharded``) calls each kernel's sharded form, with a live
band widened past the centre rows and a column mask on the sums.

Each kernel wrapper launches its CUDA kernel for CUDA tensors, counted
(``ops.launch``); for CPU tensors, and only for them, it runs the kernel's
plain PyTorch version (``*_plain``), which repeats its arithmetic in the same
order. The partial sums across blocks are plain tensor code on the
device; the scalar recurrence (α, diff, ζ, β, the stop test;
``ops.recurrence``) is two one-thread kernels on a card and its plain
version elsewhere. α and β reach the kernels through device pointers, and
nothing in the loop reads a value back except ``done`` once every
``check_every`` iterations (``solvers.pcg.drive``). The serial-reduce mode (``serial=True``)
sums each partials vector with kernel S instead (``ops.serial``), in the
order of the JAX package's ``serial=True`` kernels.

Degenerate-direction corner (⟨Ap,pn⟩ ≈ 0): α is forced to 0, w and r keep
their values and the loop stops; the reported ``diff`` is 0, as on the JAX
fused path (``poisson_tpu/ops/pallas_cg.py:60-63``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs.profile import region
from poisson_tpu_torch.ops.launch import launch
from poisson_tpu_torch.ops.recurrence import Recurrence
from poisson_tpu_torch.ops.serial import serial_sum
from poisson_tpu_torch.solvers.checkpoint import (
    _fingerprint,
    load_state,
    run_chunked,
)
from poisson_tpu_torch.solvers.graphs import can_capture, marked
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    FLAG_NONE,
    PCGResult,
    PCGState,
    chunked_advance,
    drive,
    host_fields64,
)
from poisson_tpu_torch.utils.platform import resolve_device

LANE = 128      # canvas columns padded to a multiple of this (512-byte rows)
SUBLANE = 8     # interior rows padded to a multiple of this
HALO = SUBLANE  # guard rows above and below the interior (the JAX layout)
BLOCK = 256     # CUDA threads per block = canvas points per reduction partial
TILE_ROWS = 8   # kernels A′, B′: centre rows per CUDA block
TILE_COLS = 128  # kernels A′, B′: columns per CUDA block (one partial each)

# The JAX package's strip-height rule (``poisson_tpu/ops/pallas_cg.py:91,
# 173-183``), copied so that the same Problem gets the same canvas in both
# packages: a TPU kernel keeps ``buffers`` strips of the canvas width in a
# 12 MB VMEM budget. The GPU kernels have no such budget; here the rule only
# decides when a grid is wide enough to take the column-blocked canvas, and
# how long a run of partials kernel S sums as one TPU grid step.
VMEM_BUDGET = 12 * 2 ** 20
BLOCK_WIDTHS = (4096, 2048, 1024)   # auto-blocking candidates, widest first


class Canvas(NamedTuple):
    """Static geometry of the canvas.

    Full width (``cg == 0``): content column j at canvas column j, one
    strip unless a strip height was asked for. Column-blocked
    (``cg == LANE``): the JAX package's layout for wide grids, content
    column j at canvas column cg + j, the content cut into ``nb`` strips of
    ``bm`` rows and ``ncb`` blocks of ``bn`` columns."""

    bm: int     # interior rows per strip, a multiple of SUBLANE
    nb: int     # number of strips
    rows: int   # nb·bm + 2·HALO
    cols: int   # N+1 padded to LANE; 2·cg + ncb·bn when blocked
    bn: int = 0     # column-block width (0: full width)
    ncb: int = 1    # number of column blocks
    cg: int = 0     # guard columns on each side (LANE when blocked)


def canvas_cols(problem: Problem) -> int:
    return ((problem.N + 1 + LANE - 1) // LANE) * LANE


def strip_height(cols: int, owned_rows: int, buffers: int = 12) -> int:
    """The JAX package's strip height for a canvas of ``cols`` columns over
    ``owned_rows`` interior rows: ``buffers`` strips fill VMEM_BUDGET,
    capped at 128 rows and at the owned rows, floored at SUBLANE."""
    rows = VMEM_BUDGET // (buffers * cols * 4)
    owned_cap = max(SUBLANE, -(-owned_rows // SUBLANE) * SUBLANE)
    rows = min(rows, 128, owned_cap)
    return max(SUBLANE, (rows // SUBLANE) * SUBLANE)


def _width_limited_bm(problem: Problem) -> int:
    """The strip height the budget alone allows at full width."""
    return strip_height(canvas_cols(problem), 128)


def canvas_spec(problem: Problem, bm: int | None = None,
                bn: int | None = None) -> Canvas:
    """The canvas of ``problem``: ``pallas_cg.canvas_spec``'s for every
    ``bn``, and for ``bm`` except one case.

    ``bn``: None picks the column-blocked canvas only when full-width
    strips would degenerate (a budget-limited strip height under 32 rows on
    a very wide grid), with the widest of BLOCK_WIDTHS that keeps 64-row
    strips; 0 forces full width; a multiple of LANE blocks explicitly.
    ``bm``: the strip height, a multiple of SUBLANE; None on the blocked
    canvas is the JAX strip height, and None on the full-width canvas is
    the port's single strip over the whole interior (the JAX package would
    cut it into VMEM-sized strips, which the GPU kernels do not need)."""
    if bn == 0:
        bn = None
    elif bm is None and bn is None and _width_limited_bm(problem) < 4 * SUBLANE:
        owned_cap = max(SUBLANE, -(-(problem.M - 1) // SUBLANE) * SUBLANE)
        target = min(8 * SUBLANE, owned_cap)
        bn = next((c for c in BLOCK_WIDTHS
                   if strip_height(c + 2 * LANE, problem.M - 1) >= target),
                  BLOCK_WIDTHS[-1])
    if bn is not None:
        if bn <= 0 or bn % LANE:
            raise ValueError(f"bn must be a positive multiple of {LANE}, "
                             f"got {bn}")
        ncb = -(-(problem.N + 1) // bn)
        cols = 2 * LANE + ncb * bn
        if bm is None:
            bm = strip_height(bn + 2 * LANE, problem.M - 1)
    else:
        ncb, cols = 1, canvas_cols(problem)
        if bm is None:
            bm = max(SUBLANE, -(-(problem.M - 1) // SUBLANE) * SUBLANE)
    if bm <= 0 or bm % SUBLANE:
        raise ValueError(f"bm must be a positive multiple of {SUBLANE}, "
                         f"got {bm}")
    nb = -(-(problem.M - 1) // bm)
    return Canvas(bm=bm, nb=nb, rows=nb * bm + 2 * HALO, cols=cols,
                  bn=bn or 0, ncb=ncb, cg=LANE if bn else 0)


def content_cols(cv: Canvas) -> slice:
    """The canvas columns the kernels sweep: all of them at full width, the
    column blocks between the guards when blocked."""
    return slice(cv.cg, cv.cols - cv.cg)


def sweep_points(problem: Problem, cv: Canvas) -> int:
    """The points per sweep whose bytes the function needs: the live band
    of the full-width canvas (its padding is a few per cent), and the grid's
    interior on the column-blocked canvas, whose guard columns and the
    padding of its last strip and block are layout, not work."""
    if cv.cg:
        return problem.interior_points
    return (cv.rows - 2 * HALO) * cv.cols


def n_partials(cv: Canvas) -> int:
    """Reduction partials per sum: one per CUDA block over the live band
    (BLOCK points at full width, a TILE_ROWS × TILE_COLS tile when
    blocked)."""
    if cv.cg:
        return cv.nb * cv.bm * cv.ncb * cv.bn // (TILE_ROWS * TILE_COLS)
    return (cv.rows - 2 * HALO) * cv.cols // BLOCK


def serial_run(cv: Canvas, owned_rows: int, buffers: int = 12) -> int:
    """Partials per run of kernel S: the partials of one grid step of the
    JAX package's serial kernel. On the blocked canvas a step is one
    (bm × bn) tile; at full width a strip of ``cv.bm`` rows when the canvas
    has several, else of ``strip_height(cols, owned_rows, buffers)`` rows
    (the strip the JAX package would cut; kernel C holds 16 buffers). Both
    partial layouts at full width put BLOCK points in a partial, row-major,
    so a strip's partials are consecutive."""
    if cv.cg:
        return (cv.bm // TILE_ROWS) * (cv.bn // TILE_COLS)
    rows = cv.bm if cv.nb > 1 else strip_height(cv.cols, owned_rows,
                                                buffers)
    return rows * cv.cols // BLOCK


def scaled_stencil_fields(problem: Problem):
    """Grid-indexed folded-scaling stencil fields (host fp64, numpy).

    Returns (gcs, gcw, sc2, rhs, sc) on the full (M+1, N+1) grid:
        gcs[i, j] = a[i,j]·sc[i,j]·sc[i−1,j]/h1²   (south edge, i ≥ 1)
        gcw[i, j] = b[i,j]·sc[i,j]·sc[i,j−1]/h2²   (west edge,  j ≥ 1)
    with row/column 0 zeroed, sc2 = sc², rhs = b̃ = sc·B, sc = D^{-1/2}
    (zero ring)."""
    a64, b64, rhs64, sc64 = host_fields64(problem, True)
    h1sq, h2sq = problem.h1 ** 2, problem.h2 ** 2
    gcs = np.zeros_like(a64)
    gcs[1:, :] = a64[1:, :] * sc64[1:, :] * sc64[:-1, :] / h1sq
    gcw = np.zeros_like(b64)
    gcw[:, 1:] = b64[:, 1:] * sc64[:, 1:] * sc64[:, :-1] / h2sq
    return gcs, gcw, sc64 * sc64, rhs64, sc64


def diagonal_residual_canvas(cs_canvas: np.ndarray,
                             cw_canvas: np.ndarray) -> np.ndarray:
    """γ = 1 − (c̃N + c̃S + c̃E + c̃W), computed in fp64 from the coefficient
    canvases.

    The scaled operator in difference form, (Ãp)_c = Σ_k c̃_k·(p_c − p_k) +
    γ_c·p_c, equals the canonical ``p_c − Σ c̃_k p_k`` but keeps fp32 rounding
    at the scale of the (small) neighbour differences rather than of |p|.
    γ is 0 where the scaling is locally constant and 1 on padding."""
    cs_next = np.zeros_like(cs_canvas)
    cs_next[:-1] = cs_canvas[1:]
    cw_east = np.zeros_like(cw_canvas)
    cw_east[:, :-1] = cw_canvas[:, 1:]
    return 1.0 - (cs_canvas + cs_next + cw_canvas + cw_east)


@functools.lru_cache(maxsize=4)
def _host_canvases(problem: Problem, cv: Canvas):
    """(cv, cS, cW, γ, b̃, sc², sc_int) as fp64 numpy canvases."""
    M, N = problem.M, problem.N
    gcs, gcw, sc2_64, rhs64, sc64 = scaled_stencil_fields(problem)

    def to_canvas(grid_rows: np.ndarray, col0: int = 0) -> np.ndarray:
        out = np.zeros((cv.rows, cv.cols), np.float64)
        nr, nc = grid_rows.shape
        out[HALO : HALO + nr, cv.cg + col0 : cv.cg + col0 + nc] = grid_rows
        return out

    # Edge coefficients for i = 1..M (row M closes the last interior point's
    # north edge; it is zero anyway since sc[M,:] = 0).
    cs = to_canvas(gcs[1:, :])
    cw = to_canvas(gcw[1:, 1:], col0=1)
    rhs = to_canvas(rhs64[1:M, :])
    sc2 = to_canvas(sc2_64[1:M, :])
    g = diagonal_residual_canvas(cs, cw)
    return cv, cs, cw, g, rhs, sc2, sc64[1:M, 1:N]


class Canvases(NamedTuple):
    """The fp32 canvases of a problem on one device: (rows, cols) canvases
    of the scaled stencil, the right-hand side and sc², and the interior
    scaling block for solution extraction."""

    cv: Canvas
    cs: torch.Tensor
    cw: torch.Tensor
    g: torch.Tensor
    rhs: torch.Tensor
    sc2: torch.Tensor
    sc_int: torch.Tensor


@functools.lru_cache(maxsize=4)
def _device_canvases(problem: Problem, cv: Canvas, device: torch.device):
    """The canvases on ``device``, and the marked fused bodies made on them
    (:func:`_make_fused_body`), which are cached with them."""
    cv, *host = _host_canvases(problem, cv)
    return Canvases(cv, *(torch.tensor(x, dtype=torch.float32, device=device)
                          for x in host)), {}


def build_canvases(problem: Problem, device=None, bm: int | None = None,
                   bn: int | None = None) -> Canvases:
    """Host fp64 setup → fp32 canvases on ``device`` (default ``cuda``), on
    the canvas of ``canvas_spec(problem, bm, bn)``. The tensors are
    cached per (problem, canvas, device) and shared: callers must not
    write to them (the solver copies ``rhs`` before updating r in place);
    ``cuda`` without an index is the current card."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _device_canvases(problem, canvas_spec(problem, bm, bn), dev)[0]


def _canvas_to_full(problem: Problem, cv: Canvas, c) -> np.ndarray:
    """Canvas interior rows → the full (M+1, N+1) grid, numpy (zero ring;
    canvas ring columns are zero by the maskless invariant). Content starts
    at canvas column cv.cg, so the full grid is the same whichever canvas
    held it."""
    M, N = problem.M, problem.N
    c = c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
    full = np.zeros((M + 1, N + 1), c.dtype)
    full[1:M, :] = c[HALO : HALO + M - 1, cv.cg : cv.cg + N + 1]
    return full


def _full_to_canvas(problem: Problem, cv: Canvas, full, device=None):
    """Full (M+1, N+1) grid → canvas tensor on ``device`` (default cuda)."""
    M, N = problem.M, problem.N
    full = np.asarray(full)
    c = np.zeros((cv.rows, cv.cols), full.dtype)
    c[HALO : HALO + M - 1, cv.cg : cv.cg + N + 1] = full[1:M, :]
    return torch.tensor(c, device=resolve_device(device))


# --- kernel wrappers and their plain versions --------------------------------


def _shift_col_plus(u):
    """u[:, j+1] with a zero column shifted in."""
    return F.pad(u[:, 1:], (0, 1))


def _block_partials(x):
    """Per-block sums of a band-shaped tensor, in the kernels' layout: the
    band flattened row-major, BLOCK consecutive points per partial."""
    return x.reshape(-1, BLOCK).sum(dim=1)


def live_band(cv: Canvas, band, widen: int) -> tuple[int, int]:
    """The rows [lo, hi) on which the direction is formed: the centre rows
    by default; a shard widens them by up to ``widen`` rows on each side
    (kernel A by 1, kernel C by 2). Anything else raises."""
    lo, hi = (HALO, cv.rows - HALO) if band is None else (int(band[0]),
                                                           int(band[1]))
    if not (HALO - widen <= lo <= HALO
            and cv.rows - HALO <= hi <= cv.rows - HALO + widen):
        raise ValueError(f"band {(lo, hi)} must hold the centre rows "
                         f"[{HALO}, {cv.rows - HALO}) and reach at most "
                         f"{widen} row(s) past them")
    return lo, hi


def direction_and_stencil_plain(cv: Canvas, beta, z, p, cs, cw, g, pn, ap,
                                band=None, colmask=None):
    """Kernel A's plain version: writes ``pn`` on the live band and ``ap`` on
    the centre rows, and returns the per-block partials of ⟨Ap, pn⟩, each
    product multiplied by ``colmask`` first when one is given.

    The new direction is formed on the live band and framed by zeros, which
    is what the neighbours off the band and beyond the canvas edge read
    (zero rows off the band, zero columns shifted in, no wraparound). A
    shard's band reaches one row past the centre on each side: the
    direction there is its neighbour's edge row, which it stores into pn's
    halo rows for the next iteration (:func:`direction_and_stencil`)."""
    lo, hi = live_band(cv, band, 1)
    centre = slice(HALO, cv.rows - HALO)
    north = slice(HALO + 1, cv.rows - HALO + 1)
    live = z[lo:hi] + beta * p[lo:hi]
    framed = z.new_zeros((cv.rows - 2 * HALO + 2, cv.cols))
    framed[lo - HALO + 1 : hi - HALO + 1] = live
    ring = F.pad(framed, (1, 1))
    c = ring[1:-1, 1:-1]
    cw_c = cw[centre]
    a = (
        cs[north] * (c - ring[2:, 1:-1])
        + cs[centre] * (c - ring[:-2, 1:-1])
        + _shift_col_plus(cw_c) * (c - ring[1:-1, 2:])
        + cw_c * (c - ring[1:-1, :-2])
        + g[centre] * c
    )
    pn[lo:hi] = live
    ap[centre] = a
    prod = a * c
    return _block_partials(prod if colmask is None else prod * colmask)


def fused_update_plain(cv: Canvas, alpha, p, ap, sc2, w, r, colmask=None):
    """Kernel B's plain version: updates the centre rows of ``w`` and ``r``
    in place and returns the per-block partials of Σ p²·sc² and Σ r_new²
    (each r_new² multiplied by ``colmask`` first when one is given)."""
    band = slice(HALO, cv.rows - HALO)
    pb, r_new = p[band], r[band]
    r_new -= alpha * ap[band]
    w[band] += alpha * pb
    rr = r_new * r_new
    return (_block_partials(pb * pb * sc2[band]),
            _block_partials(rr if colmask is None else rr * colmask))


def _tile_partials_blocked(cv: Canvas, x):
    """Per-tile sums of a centre-tile-shaped (nb·bm, ncb·bn) tensor in
    kernels A′ and B′'s order: JAX tile (strip i, column block j), j
    fastest, then the TILE_ROWS × TILE_COLS tiles inside it, row-major."""
    t = x.reshape(cv.nb, cv.bm // TILE_ROWS, TILE_ROWS,
                  cv.ncb, cv.bn // TILE_COLS, TILE_COLS)
    return t.permute(0, 3, 1, 4, 2, 5).sum(dim=(4, 5)).reshape(-1)


def direction_and_stencil_blocked_plain(cv: Canvas, beta, z, p, cs, cw, g,
                                        pn, ap):
    """Kernel A′'s plain version: writes ``pn`` and ``ap`` on the centre
    tiles and returns the per-tile partials of ⟨Ap, pn⟩.

    The direction is formed on the centre rows and the content columns and
    framed by zeros, which is what the neighbours off the band and in the
    guard columns read."""
    rows = slice(HALO, cv.rows - HALO)
    cols = content_cols(cv)
    c0, c1 = cols.start, cols.stop
    framed = z.new_zeros((cv.rows - 2 * HALO + 2, c1 - c0 + 2))
    framed[1:-1, 1:-1] = z[rows, cols] + beta * p[rows, cols]
    c = framed[1:-1, 1:-1]
    a = (
        cs[HALO + 1 : cv.rows - HALO + 1, cols] * (c - framed[2:, 1:-1])
        + cs[rows, cols] * (c - framed[:-2, 1:-1])
        + cw[rows, c0 + 1 : c1 + 1] * (c - framed[1:-1, 2:])
        + cw[rows, cols] * (c - framed[1:-1, :-2])
        + g[rows, cols] * c
    )
    pn[rows, cols] = c
    ap[rows, cols] = a
    return _tile_partials_blocked(cv, a * c)


def fused_update_blocked_plain(cv: Canvas, alpha, p, ap, sc2, w, r):
    """Kernel B′'s plain version: updates the centre tiles of ``w`` and
    ``r`` in place (the guard columns are never swept) and returns the
    per-tile partials of Σ p²·sc² and Σ r_new²."""
    tiles = (slice(HALO, cv.rows - HALO), content_cols(cv))
    pb, r_new = p[tiles], r[tiles]
    r_new -= alpha * ap[tiles]
    w[tiles] += alpha * pb
    return (_tile_partials_blocked(cv, pb * pb * sc2[tiles]),
            _tile_partials_blocked(cv, r_new * r_new))


def _check_operands(cv: Canvas, canvases: dict, scalar=None,
                    scalar_size: int = 1) -> torch.device:
    """The kernels take fp32, contiguous (rows, cols) canvases on one device
    and, where they take one, an fp32 scalar operand of ``scalar_size``
    elements there; anything else raises."""
    first = scalar if scalar is not None else next(iter(canvases.values()))
    dev = first.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if scalar is not None and (scalar.dtype != torch.float32
                               or scalar.numel() != scalar_size
                               or not scalar.is_contiguous()
                               or scalar.device != dev):
        raise ValueError(f"the scalar operand must be {scalar_size} "
                         f"contiguous fp32 element(s) on {dev}")
    if (cv.rows - 2 * HALO) * cv.cols % BLOCK:
        raise ValueError(f"canvas band of {cv} is not a multiple of {BLOCK}")
    for name, t in canvases.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != (cv.rows, cv.cols):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{(cv.rows, cv.cols)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return dev


def check_colmask(cv: Canvas, colmask, dev: torch.device):
    """A column mask is a contiguous fp32 (1, cols) tensor on ``dev``."""
    if colmask is not None and (colmask.dtype != torch.float32
                                or tuple(colmask.shape) != (1, cv.cols)
                                or not colmask.is_contiguous()
                                or colmask.device != dev):
        raise ValueError(f"colmask must be a contiguous fp32 (1, {cv.cols}) "
                         f"tensor on {dev}")
    return None if colmask is None else colmask.data_ptr()


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library, checked to use this module's partial layout."""
    from poisson_tpu_torch.ops._build import load_kernels

    kernels = load_kernels("fused_cg")
    if kernels.lib.fused_cg_block_size() != BLOCK:
        raise RuntimeError(f"{kernels.path.name} reduces over "
                           f"{kernels.lib.fused_cg_block_size()} points per "
                           f"partial; this module expects {BLOCK}")
    return kernels


@functools.lru_cache(maxsize=None)
def _blocked_kernels():
    """The built library of kernels A′ and B′, checked to use this module's
    tile layout."""
    from poisson_tpu_torch.ops._build import load_kernels

    kernels = load_kernels("blocked_cg")
    got = [ctypes.c_int() for _ in range(3)]
    kernels.lib.blocked_cg_layout(*(ctypes.byref(v) for v in got))
    layout = tuple(v.value for v in got)
    if layout != (TILE_ROWS, TILE_COLS, BLOCK):
        raise RuntimeError(f"{kernels.path.name} has layout {layout}; this "
                           f"module expects {(TILE_ROWS, TILE_COLS, BLOCK)}")
    return kernels


def _check_blocked(cv: Canvas, band, colmask) -> None:
    """The column-blocked canvas is single-device: the centre band, no
    column mask. Its tiles must cut the strips and blocks exactly."""
    if colmask is not None or (band is not None and tuple(band) != (
            HALO, cv.rows - HALO)):
        raise ValueError("the column-blocked canvas is single-device only: "
                         "no band past the centre rows, no colmask")
    if cv.bm % TILE_ROWS or cv.bn % TILE_COLS:
        raise ValueError(f"blocked canvas {cv}: bm must be a multiple of "
                         f"{TILE_ROWS} and bn of {TILE_COLS}")


def direction_and_stencil(cv: Canvas, beta, z, p, cs, cw, g, out=None,
                          band=None, colmask=None):
    """Kernel A: returns (pn, Ap, partials of ⟨Ap, pn⟩), one sweep.

    ``out=(pn, ap)`` names the output canvases; they must not alias each
    other, ``p`` or ``z`` (neighbouring threads read p and z while pn is
    written) and their guard rows must be zero — the kernel writes only
    the live band of pn and the centre rows of Ap. Without ``out`` they are
    allocated zeroed.

    The sharded form (``parallel.fused_sharded``), chosen by ``colmask``, a
    (1, cols) fp32 tensor that multiplies each ⟨Ap, pn⟩ product before it
    is summed, and counted with ``_sharded``: ``band`` may widen the
    live band by one row on each side, so the direction is formed on the
    shard's halo rows too and stored there. A widened band without a mask
    raises.

    A column-blocked canvas (``cv.cg > 0``) runs kernel A′, counted with
    ``_blocked``, with its per-tile partials (single-device only);
    its guard columns of pn and Ap are never written."""
    pn, ap = out if out is not None else (torch.zeros_like(z),
                                          torch.zeros_like(z))
    dev = _check_operands(cv, dict(z=z, p=p, cs=cs, cw=cw, g=g, pn=pn,
                                   ap=ap), beta)
    outs = {pn.data_ptr(), ap.data_ptr()}
    if len(outs) < 2 or outs & {p.data_ptr(), z.data_ptr()}:
        raise ValueError("pn and ap must not alias each other, p or z")
    if cv.cg:
        _check_blocked(cv, band, colmask)
        if dev.type == "cpu":
            return pn, ap, direction_and_stencil_blocked_plain(
                cv, beta, z, p, cs, cw, g, pn, ap)
        part = torch.empty(n_partials(cv), dtype=torch.float32, device=dev)
        launch(_blocked_kernels(), "blocked_cg_direction_stencil",
               "direction_and_stencil_blocked", dev,
               beta.data_ptr(), z.data_ptr(), p.data_ptr(), cs.data_ptr(),
               cw.data_ptr(), g.data_ptr(), pn.data_ptr(), ap.data_ptr(),
               part.data_ptr(), cv.rows, cv.cols, HALO, cv.cg, cv.bm, cv.bn,
               cv.nb, cv.ncb)
        return pn, ap, part
    lo, hi = live_band(cv, band, 1)
    mask_ptr = check_colmask(cv, colmask, dev)
    if colmask is None and (lo, hi) != (HALO, cv.rows - HALO):
        raise ValueError("a band past the centre rows is the sharded form: "
                         "it takes a colmask")
    if dev.type == "cpu":
        part = direction_and_stencil_plain(cv, beta, z, p, cs, cw, g, pn, ap,
                                           (lo, hi), colmask)
        return pn, ap, part
    blocks = n_partials(cv)
    part = torch.empty(blocks, dtype=torch.float32, device=dev)
    launch(_kernels(), "fused_cg_direction_stencil",
           "direction_and_stencil" if colmask is None
           else "direction_and_stencil_sharded", dev,
           beta.data_ptr(), z.data_ptr(), p.data_ptr(), cs.data_ptr(),
           cw.data_ptr(), g.data_ptr(), mask_ptr, pn.data_ptr(),
           ap.data_ptr(), part.data_ptr(), cv.rows, cv.cols, HALO, lo, hi,
           blocks)
    return pn, ap, part


def fused_update(cv: Canvas, alpha, p, ap, sc2, w, r, colmask=None):
    """Kernel B: w ← w + α·p and r ← r − α·Ap in place; returns
    (w, r, partials of Σ p²·sc², partials of Σ r²), one sweep. ``colmask``
    (the sharded form, counted with ``_sharded``) multiplies each r²
    before it is summed; Σ p²·sc² needs none, since a shard's sc² is zero
    outside the points it owns. A column-blocked canvas runs kernel B′,
    counted with ``_blocked``, on the centre tiles only. On the card
    the two partials vectors are the rows of one (2, n) buffer, which
    kernel S sums in one launch."""
    dev = _check_operands(cv, dict(p=p, ap=ap, sc2=sc2, w=w, r=r), alpha)
    if cv.cg:
        _check_blocked(cv, None, colmask)
        if dev.type == "cpu":
            return (w, r, *fused_update_blocked_plain(cv, alpha, p, ap, sc2,
                                                      w, r))
        diff_part, zr_part = torch.empty((2, n_partials(cv)),
                                         dtype=torch.float32, device=dev)
        launch(_blocked_kernels(), "blocked_cg_update", "fused_update_blocked",
               dev, alpha.data_ptr(), p.data_ptr(), ap.data_ptr(),
               sc2.data_ptr(), w.data_ptr(), r.data_ptr(),
               diff_part.data_ptr(), zr_part.data_ptr(), cv.cols, HALO, cv.cg,
               cv.bm, cv.bn, cv.nb, cv.ncb)
        return w, r, diff_part, zr_part
    mask_ptr = check_colmask(cv, colmask, dev)
    if dev.type == "cpu":
        diff_part, zr_part = fused_update_plain(cv, alpha, p, ap, sc2, w, r,
                                                colmask)
        return w, r, diff_part, zr_part
    blocks = n_partials(cv)
    diff_part, zr_part = torch.empty((2, blocks), dtype=torch.float32,
                                     device=dev)
    launch(_kernels(), "fused_cg_update",
           "fused_update" if colmask is None else "fused_update_sharded", dev,
           alpha.data_ptr(), p.data_ptr(), ap.data_ptr(), sc2.data_ptr(),
           mask_ptr, w.data_ptr(), r.data_ptr(), diff_part.data_ptr(),
           zr_part.data_ptr(), cv.cols, HALO, blocks)
    return w, r, diff_part, zr_part


KERNEL_WRAPPERS = (direction_and_stencil, fused_update)


# --- the fused solve ----------------------------------------------------------


def partial_sums(parts, run: int | None):
    """The sum of each partials vector in ``parts``: ``torch.sum`` in the
    default layout (``run`` None), kernel S in runs of ``run`` partials in
    the serial-reduce mode (one launch for all of them)."""
    if run is None:
        return tuple(torch.sum(v) for v in parts)
    return tuple(serial_sum(parts, run).unbind())


class _FusedState(NamedTuple):
    k: torch.Tensor      # iterations counted (0-d int32)
    done: torch.Tensor   # converged or degenerate (0-d bool)
    w: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor      # what kernel A forms the direction from: r itself,
                         # except on the first step of a resumed solve
    p: torch.Tensor      # previous direction; β is applied at the top of A
    spare: torch.Tensor  # the other half of p's ping-pong pair
    ap: torch.Tensor     # Ap scratch, rewritten every iteration
    zr: torch.Tensor     # ζ = Σ r² · h1h2 (z = r on the scaled system)
    beta: torch.Tensor
    diff: torch.Tensor


def _fused_init(problem: Problem, cv: Canvas, rhs) -> _FusedState:
    """w=0, r=b̃, p=0 with β=0 (the first sweep then forms p ← z + 0·p = z₀),
    ζ₀ = Σ b̃²·h1h2 in fp32. r is a copy: kernel B updates it in place. p,
    spare and ap start zeroed, so their guard rows and columns stay zero for
    the whole solve."""
    f32 = dict(dtype=torch.float32, device=rhs.device)
    r = rhs.clone()
    return _FusedState(
        k=torch.zeros((), dtype=torch.int32, device=rhs.device),
        done=torch.zeros((), dtype=torch.bool, device=rhs.device),
        w=torch.zeros_like(rhs), r=r, z=r, p=torch.zeros_like(rhs),
        spare=torch.zeros_like(rhs), ap=torch.zeros_like(rhs),
        zr=torch.sum(rhs.to(torch.float32) ** 2)
        * torch.tensor(problem.h1 * problem.h2, **f32),
        beta=torch.zeros((), **f32),
        diff=torch.full((), float("inf"), **f32),
    )


def _make_fused_body(problem: Problem, cv: Canvas, cs, cw, g, sc2,
                     kernels=KERNEL_WRAPPERS, run: int | None = None):
    """One fused iteration (kernels A + B, or A′ + B′ on a blocked canvas)
    as a state→state function. A done state is frozen: α is forced to 0, so
    w and r keep their values, and k, ζ, β and diff keep theirs, which keeps
    the count exact however many iterations run between two reads of
    ``done``. ``kernels`` are the two sweeps, called as
    :func:`direction_and_stencil` and :func:`fused_update` are; ``run``
    selects the serial-reduce mode (:func:`partial_sums`).

    On a card (``solvers.graphs.can_capture``), a body on the canvases
    :func:`build_canvases` caches is marked ``capturable``: ``drive``
    replays each whole block of it as a captured graph. The marked body is
    cached with the canvases, per ``kernels`` and ``run``, so that its
    captured blocks serve every solve on them."""
    make = lambda: _fused_body(problem, cv, cs, cw, g, sc2, kernels, run)
    if not can_capture(cs.device):
        return make()
    cached, bodies = _device_canvases(problem, cv, cs.device)
    if not all(a is b for a, b in zip((cs, cw, g, sc2), (
            cached.cs, cached.cw, cached.g, cached.sc2))):
        return make()
    return marked(bodies, (kernels, run), make)


def _fused_body(problem: Problem, cv: Canvas, cs, cw, g, sc2, kernels,
                run: int | None):
    """The body :func:`_make_fused_body` describes, unmarked."""
    direction_and_stencil_fn, fused_update_fn = kernels
    rec = Recurrence(problem, cs.device)

    def body(s: _FusedState) -> _FusedState:
        pn, ap, denom_part = direction_and_stencil_fn(
            cv, s.beta, s.z, s.p, cs, cw, g, out=(s.spare, s.ap))
        alpha, degenerate = rec.step_size(
            s, partial_sums((denom_part,), run)[0])
        w, r, diff_part, zr_part = fused_update_fn(cv, alpha, pn, ap, sc2,
                                                   s.w, s.r)
        return _FusedState(
            w=w, r=r, z=r, p=pn, spare=s.p, ap=ap,
            **rec.close(s, alpha, degenerate,
                        *partial_sums((diff_part, zr_part), run)))

    return body


def _fused_solve(problem: Problem, cv: Canvas, cs, cw, g, rhs, sc2,
                 check_every: int = CHECK_EVERY,
                 kernels=KERNEL_WRAPPERS, run: int | None = None
                 ) -> _FusedState:
    """The fused solve on given canvases (all on one device)."""
    body = _make_fused_body(problem, cv, cs, cw, g, sc2, kernels, run)
    return drive(body, _fused_init(problem, cv, rhs), problem.iteration_cap,
                 check_every)


def fused_run(problem: Problem, cv: Canvas, serial) -> int | None:
    """Kernel S's run length on ``cv`` when ``serial`` is true, else None
    (the default layout). The port reads no environment variable for it."""
    return serial_run(cv, problem.M - 1) if serial else None


def _solution(problem: Problem, cv: Canvas, w, sc_int):
    """Solution canvas of the scaled system → the full (M+1, N+1) grid
    w = sc·y (zero ring), on w's device."""
    M, N = problem.M, problem.N
    y = w[HALO : HALO + M - 1, cv.cg + 1 : cv.cg + N]
    return F.pad(y * sc_int, (1, 1, 1, 1))


def fused_cg_solve(problem: Problem, device=None,
                   check_every: int = CHECK_EVERY, bm: int | None = None,
                   bn: int | None = None, serial: bool | None = None
                   ) -> PCGResult:
    """Single-device solve on the fused path (fp32, scaled system): the
    counterpart of ``poisson_tpu.ops.pallas_cg.pallas_cg_solve``. Runs on
    ``cuda`` unless ``device='cpu'`` is asked for (plain versions).

    ``bm``/``bn`` choose the canvas (:func:`canvas_spec`; a wide grid
    takes the column-blocked canvas and kernels A′, B′ on its own);
    ``serial`` sums the partials with kernel S (off by default)."""
    cv, cs, cw, g, rhs, sc2, sc_int = build_canvases(problem, device, bm, bn)
    s = _fused_solve(problem, cv, cs, cw, g, rhs, sc2, check_every,
                     run=fused_run(problem, cv, serial))
    return PCGResult(w=_solution(problem, cv, s.w, sc_int), iterations=s.k,
                     diff=s.diff, residual_dot=s.zr)


def scaled_rhs_canvas(problem: Problem, cv: Canvas, rhs_grid64, device):
    """The scaled right-hand side b̃ = sc·rhs of a caller-supplied fp64 grid
    (full (M+1, N+1) shape), as an fp32 canvas on ``device``; the host
    range ``stage.rhs_in`` while a profiler runs."""
    with region("stage.rhs_in"):
        sc64 = host_fields64(problem, True)[3]
        scaled = np.asarray(rhs_grid64, np.float64) * sc64
        return _full_to_canvas(problem, cv, scaled.astype(np.float32), device)


def canvas_to_w64(problem: Problem, cv: Canvas, w, sc_int) -> np.ndarray:
    """Solution canvas of the scaled system → the fp64 host grid
    w = sc·y (zero ring), the product taken in fp64; the host range
    ``stage.w_out`` while a profiler runs."""
    M, N = problem.M, problem.N
    rows, cols = slice(HALO, HALO + M - 1), slice(cv.cg + 1, cv.cg + N)
    with region("stage.w_out"):
        y = w[rows, cols].detach().cpu().numpy()
        w64 = np.zeros(problem.grid_shape, np.float64)
        w64[1:M, 1:N] = y.astype(np.float64) * sc_int.detach().cpu().numpy(
            ).astype(np.float64)
    return w64


def fused_cg_solve_rhs(problem: Problem, rhs_grid64, device=None,
                       check_every: int = CHECK_EVERY, bm: int | None = None,
                       bn: int | None = None, serial: bool | None = None):
    """Fused solve of ``A w = rhs`` for a caller-supplied RHS grid (fp64 host
    array, full (M+1, N+1) shape): the counterpart of
    ``poisson_tpu.ops.pallas_cg.pallas_cg_solve_rhs``, the inner solver of
    mixed-precision refinement (``solvers.refine``). Coefficient canvases
    come from the cache; only the RHS canvas is built per call.

    Returns ``(w64, iterations)`` with w accumulated on the host in fp64."""
    cv, cs, cw, g, _, sc2, sc_int = build_canvases(problem, device, bm, bn)
    rhs = scaled_rhs_canvas(problem, cv, rhs_grid64, cs.device)
    s = _fused_solve(problem, cv, cs, cw, g, rhs, sc2, check_every,
                     run=fused_run(problem, cv, serial))
    return canvas_to_w64(problem, cv, s.w, sc_int), int(s.k)


# --- checkpoint and resume ---------------------------------------------------
#
# The file is the JAX package's portable full-grid PCGState under the
# (float32, scaled) fingerprint (``solvers.checkpoint``), so a fused-path
# file resumes on any canvas (full width or column-blocked), on the CA path,
# on the plain fp32 solve and in the JAX package, and theirs here. The fused
# loop carries the previous direction and a pending β; the file carries the
# direction d = z + β·p the next sweep would form, in the kernel's own two
# roundings.


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def portable_state(*, k, done, w, r, d, zr, diff) -> PCGState:
    """The portable full-grid PCGState of a fused-path solve, as numpy
    arrays of the JAX package's types, from full grids of the solution w,
    the residual r and the direction d the next sweep would form: z := r
    (the scaled system), and the verdict fields the fused solvers do not
    track at their defaults (flag int32 0, best float64 inf, stall int32
    0)."""
    return PCGState(
        k=np.asarray(_host(k), np.int32), done=np.asarray(_host(done), bool),
        w=w, r=r, z=r, p=d,
        zr=np.asarray(_host(zr), np.float32),
        diff=np.asarray(_host(diff), np.float32),
        flag=np.asarray(FLAG_NONE, np.int32), best=np.asarray(np.inf),
        stall=np.asarray(0, np.int32),
    )


def pending_to_pcg_state(problem: Problem, cv: Canvas, *, k, done, sol, r,
                         pend, beta, zr, diff, z=None) -> PCGState:
    """A pending-β solver state (the fused or the CA loop) → the portable
    state (:func:`portable_state`), with d = z + β·pend (z = r unless
    given)."""
    d = (r if z is None else z) + beta * pend
    return portable_state(
        k=k, done=done, w=_canvas_to_full(problem, cv, sol),
        r=_canvas_to_full(problem, cv, r), d=_canvas_to_full(problem, cv, d),
        zr=zr, diff=diff)


def pcg_state_to_pending(problem: Problem, cv: Canvas, state: PCGState,
                         device=None) -> dict:
    """Portable PCGState → canvases on ``device``: the JAX package's
    pending form, pend := d − r with β := 1 (``pallas_cg.py:1044-1060``;
    r + 1·(d − r) is d to one ulp), and the direction ``dir`` = d itself,
    which a resumed fused solve forms its first direction from exactly."""
    d = np.asarray(_host(state.p), np.float32)
    r = np.asarray(_host(state.r), np.float32)
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    return dict(
        k=torch.tensor(np.asarray(_host(state.k)), dtype=torch.int32,
                       device=dev),
        done=torch.tensor(bool(np.asarray(_host(state.done))), device=dev),
        sol=_full_to_canvas(problem, cv,
                            np.asarray(_host(state.w), np.float32), dev),
        r=_full_to_canvas(problem, cv, r, dev),
        pend=_full_to_canvas(problem, cv, d - r, dev),
        dir=_full_to_canvas(problem, cv, d, dev),
        zr=torch.tensor(float(np.asarray(_host(state.zr))), **f32),
        beta=torch.tensor(1.0, **f32),
        diff=torch.tensor(float(np.asarray(_host(state.diff))), **f32),
    )


def _fused_to_pcg_state(problem: Problem, cv: Canvas,
                        s: _FusedState) -> PCGState:
    return pending_to_pcg_state(problem, cv, k=s.k, done=s.done, sol=s.w,
                                r=s.r, pend=s.p, beta=s.beta, zr=s.zr,
                                diff=s.diff, z=s.z)


def _pcg_state_to_fused(problem: Problem, cv: Canvas, state: PCGState,
                        device) -> _FusedState:
    """Portable PCGState → fused state whose first sweep forms the stored
    direction exactly: z := d, p := 0, β := 0 (d + 0·0 = d), so a resumed
    solve continues the one-shot solve bit for bit."""
    f = pcg_state_to_pending(problem, cv, state, device)
    zeros = lambda: torch.zeros_like(f["r"])
    return _FusedState(
        k=f["k"], done=f["done"], w=f["sol"], r=f["r"], z=f["dir"],
        p=zeros(), spare=zeros(), ap=zeros(), zr=f["zr"],
        beta=torch.zeros_like(f["beta"]), diff=f["diff"])


def fused_cg_solve_checkpointed(problem: Problem, checkpoint_path: str,
                                chunk: int = 200, bm: int | None = None,
                                bn: int | None = None,
                                serial: bool | None = None,
                                keep_checkpoint: bool = False,
                                keep_last: int = 2, device=None,
                                check_every: int = CHECK_EVERY
                                ) -> PCGResult:
    """Fused-path solve with the state saved every ``chunk`` iterations and
    resumed from ``checkpoint_path`` when a trustworthy file for this
    problem exists: the counterpart of
    ``pallas_cg.pallas_cg_solve_checkpointed``, with its file format
    (``solvers.checkpoint``). A chunk stops at min(k + chunk, cap) exactly;
    chunking changes no iterate. The file is removed on convergence unless
    ``keep_checkpoint``; a cap-hit keeps it."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cv, cs, cw, g, rhs, sc2, sc_int = build_canvases(problem, device, bm, bn)
    fp = _fingerprint(problem, "float32", True)
    saved = load_state(checkpoint_path, fp, keep_last=keep_last)
    s = (_fused_init(problem, cv, rhs) if saved is None
         else _pcg_state_to_fused(problem, cv, saved, rhs.device))
    body = _make_fused_body(problem, cv, cs, cw, g, sc2,
                            run=fused_run(problem, cv, serial))
    cap = problem.iteration_cap
    s = run_chunked(
        s, advance=chunked_advance(body, chunk, cap, check_every),
        to_portable=lambda st: _fused_to_pcg_state(problem, cv, st),
        path=checkpoint_path, fingerprint=fp, cap=cap,
        keep_checkpoint=keep_checkpoint, keep_last=keep_last,
    )
    return PCGResult(w=_solution(problem, cv, s.w, sc_int), iterations=s.k,
                     diff=s.diff, residual_dot=s.zr)
