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
and below; global column j at canvas column j, columns padded to a multiple
of 128 (which also keeps every row 512-byte aligned for coalesced loads).
The strip height ``bm`` is a TPU VMEM notion that the GPU kernels ignore:
the canvas is one strip, as in ``pallas_resident.resident_canvas``.
Everything outside the interior is zero, so the kernels need no masks. A
shard's canvas holds its neighbours' values around the points it owns; the
sharded solve (``parallel.fused_sharded``) calls each kernel's sharded form,
with a live band widened past the centre rows and a column mask on the sums.

Each kernel wrapper launches its CUDA kernel for CUDA tensors, and counts the
launch in its ``launches`` attribute; for CPU tensors, and only for them, it
runs the kernel's plain PyTorch version (``*_plain``), which repeats its
arithmetic in the same order. The partial sums across blocks, and the scalar
recurrences (α, diff, ζ, β, the stop test), are plain tensor code on the
device: α and β reach the kernels through device pointers, and nothing in
the loop reads a value back except ``done`` once every ``check_every``
iterations (``solvers.pcg.drive``).

Degenerate-direction corner (⟨Ap,pn⟩ ≈ 0): α is forced to 0, w and r keep
their values and the loop stops; the reported ``diff`` is 0, as on the JAX
fused path (``poisson_tpu/ops/pallas_cg.py:60-63``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops._build import check
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGResult,
    _DENOM_TOL,
    drive,
    host_fields64,
)
from poisson_tpu_torch.utils.platform import resolve_device

LANE = 128      # canvas columns padded to a multiple of this (512-byte rows)
SUBLANE = 8     # interior rows padded to a multiple of this
HALO = SUBLANE  # guard rows above and below the interior (the JAX layout)
BLOCK = 256     # CUDA threads per block = canvas points per reduction partial


class Canvas(NamedTuple):
    """Static geometry of the canvas (full width, one strip)."""

    bm: int     # interior rows, padded to SUBLANE (the single strip)
    nb: int     # number of strips (1 here)
    rows: int   # nb·bm + 2·HALO
    cols: int   # N+1 padded to LANE


def canvas_cols(problem: Problem) -> int:
    return ((problem.N + 1 + LANE - 1) // LANE) * LANE


def canvas_spec(problem: Problem) -> Canvas:
    """The full-width single-strip canvas covering the whole interior."""
    bm = max(SUBLANE, -(-(problem.M - 1) // SUBLANE) * SUBLANE)
    return Canvas(bm=bm, nb=1, rows=bm + 2 * HALO, cols=canvas_cols(problem))


def n_partials(cv: Canvas) -> int:
    """Reduction partials per sum: one per CUDA block over the live band."""
    return (cv.rows - 2 * HALO) * cv.cols // BLOCK


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
def _host_canvases(problem: Problem):
    """(cv, cS, cW, γ, b̃, sc², sc_int) as fp64 numpy canvases."""
    cv = canvas_spec(problem)
    M, N = problem.M, problem.N
    gcs, gcw, sc2_64, rhs64, sc64 = scaled_stencil_fields(problem)

    def to_canvas(grid_rows: np.ndarray, col0: int = 0) -> np.ndarray:
        out = np.zeros((cv.rows, cv.cols), np.float64)
        nr, nc = grid_rows.shape
        out[HALO : HALO + nr, col0 : col0 + nc] = grid_rows
        return out

    # Edge coefficients for i = 1..M (row M closes the last interior point's
    # north edge; it is zero anyway since sc[M,:] = 0).
    cs = to_canvas(gcs[1:, :])
    cw = to_canvas(gcw[1:, 1:], col0=1)
    rhs = to_canvas(rhs64[1:M, :])
    sc2 = to_canvas(sc2_64[1:M, :])
    g = diagonal_residual_canvas(cs, cw)
    return cv, cs, cw, g, rhs, sc2, sc64[1:M, 1:N]


@functools.lru_cache(maxsize=4)
def _device_canvases(problem: Problem, device: torch.device):
    cv, *host = _host_canvases(problem)
    return (cv, *(torch.tensor(x, dtype=torch.float32, device=device)
                  for x in host))


def build_canvases(problem: Problem, device=None):
    """Host fp64 setup → fp32 canvases on ``device`` (default ``cuda``).

    Returns (cv, cS, cW, g, rhs, sc2, sc_int): (rows, cols) canvases plus
    the interior scaling block for solution extraction. The tensors are
    cached per (problem, device) and shared: callers must not write to
    them (the solver copies ``rhs`` before updating r in place)."""
    return _device_canvases(problem, resolve_device(device))


def _canvas_to_full(problem: Problem, cv: Canvas, c) -> np.ndarray:
    """Canvas interior rows → the full (M+1, N+1) grid, numpy (zero ring;
    canvas ring columns are zero by the maskless invariant)."""
    M, N = problem.M, problem.N
    c = c.detach().cpu().numpy() if isinstance(c, torch.Tensor) else np.asarray(c)
    full = np.zeros((M + 1, N + 1), c.dtype)
    full[1:M, :] = c[HALO : HALO + M - 1, : N + 1]
    return full


def _full_to_canvas(problem: Problem, cv: Canvas, full, device=None):
    """Full (M+1, N+1) grid → canvas tensor on ``device`` (default cuda)."""
    M, N = problem.M, problem.N
    full = np.asarray(full)
    c = np.zeros((cv.rows, cv.cols), full.dtype)
    c[HALO : HALO + M - 1, : N + 1] = full[1:M, :]
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


def count_launch(wrapper, colmask) -> None:
    """One launch of ``wrapper``'s single-device form, or of its sharded
    (masked) form when a column mask was given."""
    if colmask is None:
        wrapper.launches += 1
    else:
        wrapper.sharded_launches += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


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
    is summed, and counted in ``sharded_launches``: ``band`` may widen the
    live band by one row on each side, so the direction is formed on the
    shard's halo rows too and stored there. A widened band without a mask
    raises."""
    pn, ap = out if out is not None else (torch.zeros_like(z),
                                          torch.zeros_like(z))
    dev = _check_operands(cv, dict(z=z, p=p, cs=cs, cw=cw, g=g, pn=pn,
                                   ap=ap), beta)
    lo, hi = live_band(cv, band, 1)
    mask_ptr = check_colmask(cv, colmask, dev)
    if colmask is None and (lo, hi) != (HALO, cv.rows - HALO):
        raise ValueError("a band past the centre rows is the sharded form: "
                         "it takes a colmask")
    outs = {pn.data_ptr(), ap.data_ptr()}
    if len(outs) < 2 or outs & {p.data_ptr(), z.data_ptr()}:
        raise ValueError("pn and ap must not alias each other, p or z")
    if dev.type == "cpu":
        part = direction_and_stencil_plain(cv, beta, z, p, cs, cw, g, pn, ap,
                                           (lo, hi), colmask)
        return pn, ap, part
    kernels = _kernels()
    blocks = n_partials(cv)
    part = torch.empty(blocks, dtype=torch.float32, device=dev)
    code = kernels.lib.fused_cg_direction_stencil(
        beta.data_ptr(), z.data_ptr(), p.data_ptr(), cs.data_ptr(),
        cw.data_ptr(), g.data_ptr(), mask_ptr, pn.data_ptr(), ap.data_ptr(),
        part.data_ptr(), cv.rows, cv.cols, HALO, lo, hi, blocks,
        dev.index or 0, _stream(dev),
    )
    check(kernels, code, "direction_stencil launch")
    count_launch(direction_and_stencil, colmask)
    return pn, ap, part


direction_and_stencil.launches = 0
direction_and_stencil.sharded_launches = 0


def fused_update(cv: Canvas, alpha, p, ap, sc2, w, r, colmask=None):
    """Kernel B: w ← w + α·p and r ← r − α·Ap in place; returns
    (w, r, partials of Σ p²·sc², partials of Σ r²), one sweep. ``colmask``
    (the sharded form, counted in ``sharded_launches``) multiplies each r²
    before it is summed; Σ p²·sc² needs none, since a shard's sc² is zero
    outside the points it owns."""
    dev = _check_operands(cv, dict(p=p, ap=ap, sc2=sc2, w=w, r=r), alpha)
    mask_ptr = check_colmask(cv, colmask, dev)
    if dev.type == "cpu":
        diff_part, zr_part = fused_update_plain(cv, alpha, p, ap, sc2, w, r,
                                                colmask)
        return w, r, diff_part, zr_part
    kernels = _kernels()
    blocks = n_partials(cv)
    diff_part = torch.empty(blocks, dtype=torch.float32, device=dev)
    zr_part = torch.empty(blocks, dtype=torch.float32, device=dev)
    code = kernels.lib.fused_cg_update(
        alpha.data_ptr(), p.data_ptr(), ap.data_ptr(), sc2.data_ptr(),
        mask_ptr, w.data_ptr(), r.data_ptr(), diff_part.data_ptr(),
        zr_part.data_ptr(), cv.cols, HALO, blocks, dev.index or 0,
        _stream(dev),
    )
    check(kernels, code, "fused_update launch")
    count_launch(fused_update, colmask)
    return w, r, diff_part, zr_part


fused_update.launches = 0
fused_update.sharded_launches = 0

KERNEL_WRAPPERS = (direction_and_stencil, fused_update)


def reset_launch_counts(wrappers=KERNEL_WRAPPERS) -> None:
    for fn in wrappers:
        fn.launches = fn.sharded_launches = 0


def launch_counts(wrappers=KERNEL_WRAPPERS) -> dict:
    """Launches of each wrapper's single-device form, by its name, and of
    its sharded form, by its name with ``_sharded``."""
    counts = {}
    for fn in wrappers:
        counts[fn.__name__] = fn.launches
        counts[f"{fn.__name__}_sharded"] = fn.sharded_launches
    return counts


# --- the fused solve ----------------------------------------------------------


class _FusedState(NamedTuple):
    k: torch.Tensor      # iterations counted (0-d int32)
    done: torch.Tensor   # converged or degenerate (0-d bool)
    w: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor      # previous direction; β is applied at the top of A
    spare: torch.Tensor  # the other half of p's ping-pong pair
    ap: torch.Tensor     # Ap scratch, rewritten every iteration
    zr: torch.Tensor     # ζ = Σ r² · h1h2 (z = r on the scaled system)
    beta: torch.Tensor
    diff: torch.Tensor


def _fused_init(cv: Canvas, rhs) -> _FusedState:
    """w=0, r=b̃, p=0 with β=0 (the first sweep then forms p ← z + 0·p = z₀),
    ζ₀ = Σ b̃² in fp32 (the caller scales it by h1h2). r is a copy: kernel B
    updates it in place. p, spare and ap start zeroed, so their guard rows
    stay zero for the whole solve."""
    f32 = dict(dtype=torch.float32, device=rhs.device)
    return _FusedState(
        k=torch.zeros((), dtype=torch.int32, device=rhs.device),
        done=torch.zeros((), dtype=torch.bool, device=rhs.device),
        w=torch.zeros_like(rhs), r=rhs.clone(), p=torch.zeros_like(rhs),
        spare=torch.zeros_like(rhs), ap=torch.zeros_like(rhs),
        zr=torch.sum(rhs.to(torch.float32) ** 2),
        beta=torch.zeros((), **f32),
        diff=torch.full((), float("inf"), **f32),
    )


def _make_fused_body(problem: Problem, cv: Canvas, cs, cw, g, sc2,
                     kernels=KERNEL_WRAPPERS):
    """One fused iteration (kernels A + B) as a state→state function. A done
    state is frozen: α is forced to 0, so w and r keep their values, and k,
    ζ, β and diff keep theirs, which keeps the count exact however many
    iterations run between two reads of ``done``. ``kernels`` are the two
    sweeps, called as :func:`direction_and_stencil` and :func:`fused_update`
    are."""
    direction_and_stencil_fn, fused_update_fn = kernels
    f32 = dict(dtype=torch.float32, device=cs.device)
    h1h2 = torch.tensor(problem.h1 * problem.h2, **f32)
    norm_w = h1h2 if problem.weighted_norm else torch.tensor(1.0, **f32)
    delta = torch.tensor(problem.delta, **f32)

    def body(s: _FusedState) -> _FusedState:
        pn, ap, denom_part = direction_and_stencil_fn(
            cv, s.beta, s.r, s.p, cs, cw, g, out=(s.spare, s.ap))
        denom = torch.sum(denom_part) * h1h2
        degenerate = torch.abs(denom) < _DENOM_TOL
        alpha = torch.where(degenerate | s.done, 0.0,
                            s.zr / torch.where(degenerate, 1.0, denom))
        w, r, diff_part, zr_part = fused_update_fn(cv, alpha, pn, ap, sc2,
                                                   s.w, s.r)
        diff = torch.abs(alpha) * torch.sqrt(torch.sum(diff_part) * norm_w)
        zr_new = torch.sum(zr_part) * h1h2
        live = ~s.done
        return _FusedState(
            k=s.k + live.to(torch.int32),
            done=s.done | degenerate | (diff < delta),
            w=w, r=r, p=pn, spare=s.p, ap=ap,
            zr=torch.where(live, zr_new, s.zr),
            beta=torch.where(
                live, zr_new / torch.where(s.zr == 0.0, 1.0, s.zr), s.beta),
            diff=torch.where(live, diff, s.diff),
        )

    return body


def _fused_solve(problem: Problem, cv: Canvas, cs, cw, g, rhs, sc2,
                 check_every: int = CHECK_EVERY,
                 kernels=KERNEL_WRAPPERS) -> _FusedState:
    """The fused solve on given canvases (all on one device)."""
    body = _make_fused_body(problem, cv, cs, cw, g, sc2, kernels)
    s = _fused_init(cv, rhs)
    h1h2 = torch.tensor(problem.h1 * problem.h2, dtype=torch.float32,
                        device=rhs.device)
    s = s._replace(zr=s.zr * h1h2)
    return drive(body, s, problem.iteration_cap, check_every)


def fused_cg_solve(problem: Problem, device=None,
                   check_every: int = CHECK_EVERY) -> PCGResult:
    """Single-device solve on the fused path (fp32, scaled system): the
    counterpart of ``poisson_tpu.ops.pallas_cg.pallas_cg_solve``. Runs on
    ``cuda`` unless ``device='cpu'`` is asked for (plain versions)."""
    cv, cs, cw, g, rhs, sc2, sc_int = build_canvases(problem, device)
    s = _fused_solve(problem, cv, cs, cw, g, rhs, sc2, check_every)
    M, N = problem.M, problem.N
    y = s.w[HALO : HALO + M - 1, 1:N]
    w = F.pad(y * sc_int, (1, 1, 1, 1))
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr)


def scaled_rhs_canvas(problem: Problem, cv: Canvas, rhs_grid64, device):
    """The scaled right-hand side b̃ = sc·rhs of a caller-supplied fp64 grid
    (full (M+1, N+1) shape), as an fp32 canvas on ``device``."""
    sc64 = host_fields64(problem, True)[3]
    scaled = np.asarray(rhs_grid64, np.float64) * sc64
    return _full_to_canvas(problem, cv, scaled.astype(np.float32), device)


def canvas_to_w64(problem: Problem, w, sc_int) -> np.ndarray:
    """Solution canvas of the scaled system → the fp64 host grid
    w = sc·y (zero ring), the product taken in fp64."""
    M, N = problem.M, problem.N
    y = w[HALO : HALO + M - 1, 1:N].detach().cpu().numpy().astype(np.float64)
    w64 = np.zeros(problem.grid_shape, np.float64)
    w64[1:M, 1:N] = y * sc_int.detach().cpu().numpy().astype(np.float64)
    return w64


def fused_cg_solve_rhs(problem: Problem, rhs_grid64, device=None,
                       check_every: int = CHECK_EVERY):
    """Fused solve of ``A w = rhs`` for a caller-supplied RHS grid (fp64 host
    array, full (M+1, N+1) shape): the counterpart of
    ``poisson_tpu.ops.pallas_cg.pallas_cg_solve_rhs``, the inner solver of
    mixed-precision refinement (``solvers.refine``). Coefficient canvases
    come from the cache; only the RHS canvas is built per call.

    Returns ``(w64, iterations)`` with w accumulated on the host in fp64."""
    cv, cs, cw, g, _, sc2, sc_int = build_canvases(problem, device)
    rhs = scaled_rhs_canvas(problem, cv, rhs_grid64, cs.device)
    s = _fused_solve(problem, cv, cs, cw, g, rhs, sc2, check_every)
    return canvas_to_w64(problem, s.w, sc_int), int(s.k)
