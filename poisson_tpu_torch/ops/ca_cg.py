"""Communication-avoiding (s=2) CG on the GPU: kernels C and D in CUDA for
Hopper (counterpart of the single-device part of
``poisson_tpu/ops/pallas_ca.py``).

Two CG iterations in two sweeps over the canvases:

  kernel C (``basis_sweep``), replaces the Pallas kernel
  ``_make_basis_kernel``:
      pn ← r + β·p_prev on the live band (0 elsewhere)
      t1 ← Ã pn;  t2 ← Ã t1;  t3 ← Ã r
      12 Gram partials per block, a1 b1 e f g h | wpp wpr wpt wrr wrt wtt

  kernel D (``pair_update``), replaces ``_make_pair_update_kernel``:
      x ← x + c_p·pn + a2·r − a2a1·t1
      r ← r − c_p·t1 + a2a1·t2 − a2·t3     (x and r in place)
      p₁ ← r − α₁·t1 + β₁·pn, or pn when the pair applied one step only
      per-block partials of Σ r'²

The scalar recurrences (``pair_scalars``, ``assemble_pair_state``) are the
JAX package's, as plain tensor code on the device; the coefficients reach
kernel D through a device pointer, and nothing in the loop is read back
except ``done`` once every ``check_every`` pairs (``solvers.pcg.drive``).
A pair stops after its first inner step when that step converged, when the
second is degenerate, or when the cap allows one more iteration only, so
odd counts (989, 2449) come out exact.

Canvas and layout: the fused path's full-width canvas (``ops.fused_cg``),
one strip unless ``bm`` asks for the JAX strip layout; the Pallas drivers'
``parallel`` knob shapes the TPU grid only and is not taken. Kernel C
marches each block down a STRIP_W-column strip of a segment of band rows
(:func:`sweep_geometry`, which sizes the segments to fill the card and
which the CPU tests check); its partials are per (TILE_H × TILE_W) tile of
the band, in :func:`n_tiles` order whatever the segments, kernel D's per
BLOCK consecutive band points, as kernel B's; both put a strip's partials in a
row, which is what the serial-reduce mode (``serial=True``) sums with
kernel S, one run per JAX strip of ``strip_height(cols, M−1, 16)`` rows
(kernel C holds 16 strip buffers on the TPU). The sharded CA solve
(``parallel.ca_sharded``) calls each kernel's sharded form: C with pn formed
two rows past the centre on each side, both with a column mask on the
unweighted sums.

Each wrapper launches its CUDA kernel for CUDA tensors, and counts the launch
in its ``launches`` attribute; for CPU tensors, and only for them, it runs
the kernel's plain PyTorch version, which repeats its arithmetic in the same
order.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops._build import check, load_kernels
from poisson_tpu_torch.ops.fused_cg import (
    BLOCK,
    HALO,
    Canvas,
    _block_partials,
    _check_operands,
    _shift_col_plus,
    _solution,
    build_canvases,
    check_colmask,
    live_band,
    n_partials,
    partial_sums,
    pcg_state_to_pending,
    pending_to_pcg_state,
    serial_run,
)
from poisson_tpu_torch.ops.launch import launch
from poisson_tpu_torch.ops.serial import serial_sum
from poisson_tpu_torch.solvers.checkpoint import (
    _fingerprint,
    load_state,
    run_chunked,
)
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGResult,
    _DENOM_TOL,
    drive,
)

N_GRAM = 12   # a1 b1 e f g h | wpp wpr wpt wrr wrt wtt
TILE_H = 8    # kernel C: band rows per Gram tile (one set of partials)
TILE_W = 32   # kernel C: columns per Gram tile (one warp)
N_COEFS = 8   # kernel D: [c_p, a2, a2a1, α₁, β₁, only1, 0, 0]
STRIP_W = 128  # kernel C: columns per block, which marches down its rows
# The H100's SM count and kernel C's blocks per SM there (30,464 B of
# shared memory and 128 threads each), for the geometry the tests check on
# the CPU; on the card the wrapper queries both.
H100_SMS = 132
SWEEP_BLOCKS_PER_SM = 7

# Canvas passes of one pair: C reads p_prev, r, cS, cW, γ, sc² and writes
# pn, t1, t2, t3; D reads pn, t1, t2, t3, x, r and writes x, r, p₁.
PASSES_PER_PAIR = 19
CA_BUFFERS = 16   # strip buffers kernel C holds on the TPU (its strip height)


def _shift_col_minus(u):
    """u[:, j-1] with a zero column shifted in."""
    return F.pad(u[:, :-1], (1, 0))


def _stencil(pn, cs, cw, g, lo: int, hi: int):
    """Difference-form Ã on canvas rows [lo, hi) (``pallas_ca._stencil``):
    row r of the result is canvas row lo + r, its ±1 row neighbours rows
    lo + r ± 1."""
    c = pn[lo:hi]
    cw_c = cw[lo:hi]
    return (
        cs[lo + 1 : hi + 1] * (c - pn[lo + 1 : hi + 1])
        + cs[lo:hi] * (c - pn[lo - 1 : hi - 1])
        + _shift_col_plus(cw_c) * (c - _shift_col_plus(c))
        + cw_c * (c - _shift_col_minus(c))
        + g[lo:hi] * c
    )


def n_tiles(cv: Canvas) -> int:
    """Kernel C's blocks: the band cut into TILE_H × TILE_W tiles."""
    return (cv.rows - 2 * HALO) // TILE_H * (cv.cols // TILE_W)


class SweepGeometry(NamedTuple):
    """Kernel C's grid: ``strips`` × ``segs`` blocks; block (s, g) owns the
    columns s·STRIP_W + [0, STRIP_W) of the band rows g·seg_h + [0, seg_h)
    (the last segment may be shorter), in whole TILE_H × TILE_W tiles."""

    strips: int
    seg_h: int
    segs: int

    @property
    def blocks(self) -> int:
        return self.strips * self.segs


def sweep_geometry(cv: Canvas, sms: int = H100_SMS,
                   per_sm: int = SWEEP_BLOCKS_PER_SM) -> SweepGeometry:
    """Kernel C's strips and segments on a card of ``sms`` SMs that hold
    ``per_sm`` of its blocks each: the shortest segments (a multiple of
    TILE_H rows) whose grid the card holds at once, so that every shape
    fills the card in one wave. Past its segment a block forms pn on 5
    rows and t1 on 2, little beside the centre rows' t2, t3 and twelve
    warp sums, so short segments cost little."""
    if cv.cols % STRIP_W:
        raise ValueError(f"canvas width {cv.cols} is not a multiple of "
                         f"{STRIP_W}")
    strips = cv.cols // STRIP_W
    tile_rows = (cv.rows - 2 * HALO) // TILE_H
    max_segs = max(1, sms * per_sm // strips)
    seg_tiles = -(-tile_rows // max_segs)
    return SweepGeometry(strips=strips, seg_h=seg_tiles * TILE_H,
                         segs=-(-tile_rows // seg_tiles))


def _tile_partials(x):
    """Per-tile sums of a band-shaped tensor in kernel C's block order (tile
    rows outer, tile columns inner)."""
    rows, cols = x.shape
    return x.reshape(rows // TILE_H, TILE_H, cols // TILE_W, TILE_W).sum(
        dim=(1, 3)).reshape(-1)


def basis_sweep_plain(cv: Canvas, beta, pprev, r, cs, cw, g, sc2,
                      pn, t1, t2, t3, band=None, colmask=None):
    """Kernel C's plain version: writes the centre rows of ``pn``, ``t1``,
    ``t2``, ``t3`` and returns the (tiles, 12) Gram partials, the six
    unweighted products multiplied by ``colmask`` first when one is given.

    pn is formed on the live band (the centre rows, or a shard's band two
    rows wider on each side) and is zero elsewhere; t1 is computed on the
    centre ±1 rows (the rows next to them included, as the Pallas kernel
    does), which is what t2's stencil reads."""
    lo, hi = live_band(cv, band, 2)
    h, hc = HALO, cv.rows - HALO
    centre = slice(h, hc)
    pn_full = torch.zeros_like(r)
    pn_full[lo:hi] = r[lo:hi] + beta * pprev[lo:hi]
    t1_ext = _stencil(pn_full, cs, cw, g, h - 1, hc + 1)
    t1_pad = torch.zeros_like(r)
    t1_pad[h - 1 : hc + 1] = t1_ext
    a = t1_ext[1:-1]
    b = _stencil(t1_pad, cs, cw, g, h, hc)
    c = _stencil(r, cs, cw, g, h, hc)
    p, rc, w2 = pn_full[centre], r[centre], sc2[centre]
    pn[centre], t1[centre], t2[centre], t3[centre] = p, a, b, c
    plain = [p * a, a * a, rc * a, rc * c, a * c, a * b]
    if colmask is not None:
        plain = [x * colmask for x in plain]
    return torch.stack([
        _tile_partials(x) for x in (
            *plain, p * p * w2, p * rc * w2, p * a * w2, rc * rc * w2,
            rc * a * w2, a * a * w2)
    ], dim=1)


def pair_update_plain(cv: Canvas, coefs, pn, t1, t2, t3, x, r, p1,
                      colmask=None):
    """Kernel D's plain version: updates the centre rows of ``x`` and ``r``
    in place, writes those of ``p1`` and returns the per-block partials of
    Σ r'² (each r'² multiplied by ``colmask`` first when one is given). x
    and p₁ use r before its update; p₁ is pn when ``coefs[5]`` (the pair's
    ``only1``) is nonzero."""
    band = slice(HALO, cv.rows - HALO)
    c_p, a2, a2a1, alpha1, beta1, only1 = (coefs[j] for j in range(6))
    pv, a, rv = pn[band], t1[band], r[band]
    r_new = rv - c_p * a + a2a1 * t2[band] - a2 * t3[band]
    x[band] = x[band] + c_p * pv + a2 * rv - a2a1 * a
    p1[band] = torch.where(only1 != 0, pv, rv - alpha1 * a + beta1 * pv)
    r[band] = r_new
    rr = r_new * r_new
    return _block_partials(rr if colmask is None else rr * colmask)


@functools.lru_cache(maxsize=None)
def _kernels():
    """The built library, checked to use this module's partial layouts."""
    kernels = load_kernels("ca_cg")
    got = [ctypes.c_int() for _ in range(4)]
    kernels.lib.ca_cg_layout(*(ctypes.byref(v) for v in got))
    layout = tuple(v.value for v in got)
    if layout != (TILE_H, TILE_W, BLOCK, STRIP_W):
        raise RuntimeError(f"{kernels.path.name} has layout {layout}; this "
                           f"module expects "
                           f"{(TILE_H, TILE_W, BLOCK, STRIP_W)}")
    return kernels


@functools.lru_cache(maxsize=None)
def sweep_card(device_index: int) -> tuple[int, int]:
    """(SM count, kernel C's blocks per SM) on this card."""
    kernels = _kernels()
    sms, per_sm = ctypes.c_int(), ctypes.c_int()
    check(kernels, kernels.lib.ca_cg_sweep_occupancy(
        device_index, ctypes.byref(sms), ctypes.byref(per_sm)),
        "basis_sweep occupancy query")
    if per_sm.value < 1:
        raise RuntimeError("basis_sweep: no block fits on an SM")
    return sms.value, per_sm.value


def _distinct(names: dict, what: str) -> None:
    ptrs = [t.data_ptr() for t in names.values()]
    if len(set(ptrs)) < len(ptrs):
        raise ValueError(f"{', '.join(names)} must not alias ({what})")


def basis_sweep(cv: Canvas, beta, pprev, r, cs, cw, g, sc2, out=None,
                band=None, colmask=None):
    """Kernel C: returns (pn, t1, t2, t3, (tiles, 12) Gram partials), one
    sweep.

    ``out=(pn, t1, t2, t3)`` names the output canvases; they must not alias
    each other, ``pprev`` or ``r`` (neighbouring blocks read those while
    these are written), and their guard rows must be zero — the kernel
    writes only the centre rows. Without ``out`` they are allocated zeroed.

    The sharded form (``parallel.ca_sharded``): ``band`` widens the rows on
    which pn is formed by two on each side, onto the shard's width-2 halo
    ring, and ``colmask``, a (1, cols) fp32 tensor, multiplies the six
    unweighted Gram products before they are summed. A column mask
    launches the kernel's sharded form, counted with ``_sharded``."""
    outs = out if out is not None else tuple(torch.zeros_like(r)
                                             for _ in range(4))
    pn, t1, t2, t3 = outs
    dev = _check_operands(cv, dict(pprev=pprev, r=r, cs=cs, cw=cw, g=g,
                                   sc2=sc2, pn=pn, t1=t1, t2=t2, t3=t3), beta)
    lo, hi = live_band(cv, band, 2)
    mask_ptr = check_colmask(cv, colmask, dev)
    _distinct(dict(pn=pn, t1=t1, t2=t2, t3=t3, pprev=pprev, r=r),
              "the outputs are written while the inputs are read")
    if dev.type == "cpu":
        gram = basis_sweep_plain(cv, beta, pprev, r, cs, cw, g, sc2, *outs,
                                 (lo, hi), colmask)
        return (*outs, gram)
    kernels = _kernels()
    geo = sweep_geometry(cv, *sweep_card(dev.index or 0))
    staged = dict(pprev=pprev, r=r, cs=cs, cw=cw, g=g, sc2=sc2)
    for name, t in staged.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary "
                             "(kernel C copies its rows 16 bytes at a time)")
    gram = torch.empty((n_tiles(cv), N_GRAM), dtype=torch.float32,
                       device=dev)
    launch(kernels, "ca_cg_basis_sweep",
           "basis_sweep" if colmask is None else "basis_sweep_sharded", dev,
           beta.data_ptr(), pprev.data_ptr(), r.data_ptr(), cs.data_ptr(),
           cw.data_ptr(), g.data_ptr(), sc2.data_ptr(), mask_ptr,
           pn.data_ptr(), t1.data_ptr(), t2.data_ptr(), t3.data_ptr(),
           gram.data_ptr(), cv.rows, cv.cols, HALO, lo, hi, geo.seg_h)
    return (*outs, gram)


def pair_update(cv: Canvas, coefs, pn, t1, t2, t3, x, r, out=None,
                colmask=None):
    """Kernel D: x and r updated in place, p₁ written; returns
    (x, r, p1, partials of Σ r'²), one sweep.

    ``coefs`` is the 8-element fp32 row of :func:`pair_scalars`: the JAX
    kernel's row, with ``only1`` added in its spare slot 5. ``out``
    names the p₁ canvas (guard rows zero); it must not alias any operand,
    and x and r must not alias pn, t1, t2, t3. Without ``out`` it is
    allocated zeroed. ``colmask`` (the sharded form, counted with
    ``_sharded``) multiplies each r'² before it is summed."""
    p1 = out if out is not None else torch.zeros_like(r)
    dev = _check_operands(cv, dict(pn=pn, t1=t1, t2=t2, t3=t3, x=x, r=r,
                                   p1=p1), coefs, N_COEFS)
    mask_ptr = check_colmask(cv, colmask, dev)
    _distinct(dict(pn=pn, t1=t1, t2=t2, t3=t3, x=x, r=r, p1=p1),
              "x and r are updated in place, p1 is written")
    if dev.type == "cpu":
        part = pair_update_plain(cv, coefs, pn, t1, t2, t3, x, r, p1,
                                 colmask)
        return x, r, p1, part
    blocks = n_partials(cv)
    part = torch.empty(blocks, dtype=torch.float32, device=dev)
    launch(_kernels(), "ca_cg_pair_update",
           "pair_update" if colmask is None else "pair_update_sharded", dev,
           coefs.data_ptr(), pn.data_ptr(), t1.data_ptr(), t2.data_ptr(),
           t3.data_ptr(), mask_ptr, x.data_ptr(), r.data_ptr(),
           p1.data_ptr(), part.data_ptr(), cv.cols, HALO, blocks)
    return x, r, p1, part




# --- the pair scalars and the solve ------------------------------------------


class _CAState(NamedTuple):
    k: torch.Tensor      # iterations counted (0-d int32)
    done: torch.Tensor   # converged or degenerate (0-d bool)
    x: torch.Tensor
    r: torch.Tensor
    pprev: torch.Tensor  # p₁ of the previous pair; β pending
    rr: torch.Tensor     # ⟨r, r⟩·h1h2
    beta: torch.Tensor   # pending β (applied at the top of kernel C)
    diff: torch.Tensor


class PairDecision(NamedTuple):
    """Everything the pair-update sweep and the state assembly need, from
    one pair's summed Gram vector."""

    coefs: torch.Tensor   # (8,) kernel-D scalar row
    only1: torch.Tensor
    stop1: torch.Tensor
    deg2: torch.Tensor
    short: torch.Tensor   # this pair advanced k by 1, not 2
    rr1: torch.Tensor
    diff1: torch.Tensor
    diff2: torch.Tensor


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def pair_scalars(problem: Problem, rr, k, gsum) -> PairDecision:
    """The α/β/convergence recurrences of one CA pair
    (``pallas_ca.pair_scalars``, in its operation order).

    ``gsum`` is the (12,) Gram vector summed over blocks and scaled by
    h1·h2; ``rr`` = ⟨r, r⟩·h1h2 carried from the previous pair; ``k`` the
    iterations counted so far."""
    dev = gsum.device
    h1h2 = _f32(problem.h1 * problem.h2, dev)
    norm_w = h1h2 if problem.weighted_norm else _f32(1.0, dev)
    delta = _f32(problem.delta, dev)
    a1, b1, e, f, gg, hh = (gsum[j] for j in range(6))
    wpp, wpr, wpt, wrr, wrt, wtt = (gsum[6 + j] for j in range(6))

    deg1 = torch.abs(a1) < _DENOM_TOL
    alpha1 = torch.where(deg1, 0.0, rr / torch.where(deg1, 1.0, a1))
    diff1 = torch.abs(alpha1) * torch.sqrt(
        torch.clamp_min(wpp * norm_w / h1h2, 0.0))
    rr1 = torch.clamp_min(rr - 2 * alpha1 * e + alpha1 * alpha1 * b1, 0.0)
    beta1 = rr1 / torch.where(rr == 0.0, 1.0, rr)
    rAr1 = f - 2 * alpha1 * gg + alpha1 * alpha1 * hh
    pAr1 = e - alpha1 * b1
    p1Ap1 = rAr1 + 2 * beta1 * pAr1 + beta1 * beta1 * a1
    deg2 = torch.abs(p1Ap1) < _DENOM_TOL
    alpha2 = torch.where(deg2, 0.0, rr1 / torch.where(deg2, 1.0, p1Ap1))
    w11 = wrr - 2 * alpha1 * wrt + alpha1 * alpha1 * wtt
    w1p = wpr - alpha1 * wpt
    wp1p1 = w11 + 2 * beta1 * w1p + beta1 * beta1 * wpp
    diff2 = torch.abs(alpha2) * torch.sqrt(
        torch.clamp_min(wp1p1 * norm_w / h1h2, 0.0))

    stop1 = deg1 | (diff1 < delta)
    cap_stop = k + 1 >= problem.iteration_cap
    # Apply only the first inner step when it converged, when the second is
    # degenerate, or when the cap allows exactly one more iteration.
    only1 = stop1 | deg2 | cap_stop
    a2 = torch.where(only1, 0.0, alpha2)
    c_p = alpha1 + a2 * beta1
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    coefs = torch.stack([c_p, a2, a2 * alpha1, alpha1, beta1,
                         only1.to(torch.float32), zero, zero])
    return PairDecision(coefs=coefs, only1=only1, stop1=stop1, deg2=deg2,
                        short=stop1 | cap_stop, rr1=rr1, diff1=diff1,
                        diff2=diff2)


def assemble_pair_state(problem: Problem, s: _CAState, d: PairDecision,
                        x, r, pprev, rr2) -> _CAState:
    """Post-sweep state (``pallas_ca.assemble_pair_state``). When only step
    1 was applied, the next direction material is pn with β = rr₂/rr; a
    degenerate second step counts 2 and reports diff 0, as the two-sweep
    path counts it."""
    rr_prev = torch.where(d.only1, s.rr, d.rr1)
    delta = _f32(problem.delta, rr2.device)
    return _CAState(
        k=s.k + torch.where(d.short, 1, 2).to(torch.int32),
        done=d.stop1 | d.deg2 | ((~d.only1) & (d.diff2 < delta)),
        x=x, r=r, pprev=pprev, rr=rr2,
        beta=rr2 / torch.where(rr_prev == 0.0, 1.0, rr_prev),
        diff=torch.where(d.short, d.diff1,
                         torch.where(d.deg2, 0.0, d.diff2)),
    )


def _ca_init(problem: Problem, cv: Canvas, rhs) -> _CAState:
    """x=0, r=b̃ (a copy: kernel D updates it in place), β=0 (the first
    basis sweep then forms pn ← r₀), rr₀ = Σ b̃²·h1h2."""
    dev = rhs.device
    return _CAState(
        k=torch.zeros((), dtype=torch.int32, device=dev),
        done=torch.zeros((), dtype=torch.bool, device=dev),
        x=torch.zeros_like(rhs), r=rhs.clone(), pprev=torch.zeros_like(rhs),
        rr=torch.sum(rhs.to(torch.float32) ** 2)
        * _f32(problem.h1 * problem.h2, dev),
        beta=torch.zeros((), dtype=torch.float32, device=dev),
        diff=torch.full((), float("inf"), dtype=torch.float32, device=dev),
    )


def gram_sum(gram, run: int | None):
    """The (12,) Gram vector of kernel C's (tiles, 12) partials: summed over
    the tiles, or by kernel S in the serial-reduce mode (one launch for the
    twelve)."""
    return torch.sum(gram, dim=0) if run is None else serial_sum(gram.T, run)


def ca_run(problem: Problem, cv: Canvas, serial) -> int | None:
    """Kernel S's run length on the CA canvas when ``serial`` is true."""
    return serial_run(cv, problem.M - 1, CA_BUFFERS) if serial else None


def _make_ca_body(problem: Problem, cv: Canvas, cs, cw, g, sc2,
                  run: int | None = None):
    """One CA pair (kernels C + D) as a state→state function. A state that
    is done or has reached the cap is frozen: kernel D gets zero
    coefficients, so x and r keep their values, and the rest of the state
    is kept, so the count is exact however many pairs run between two reads
    of ``done`` (``drive`` counts pairs, not iterations). ``run`` selects
    the serial-reduce mode."""
    h1h2 = _f32(problem.h1 * problem.h2, cs.device)
    cap = problem.iteration_cap
    # Kernel outputs, allocated zeroed once: their guard rows stay zero.
    scratch = tuple(torch.zeros_like(cs) for _ in range(4))
    p1_buf = torch.zeros_like(cs)

    def body(s: _CAState) -> _CAState:
        live = (~s.done) & (s.k < cap)
        pn, t1, t2, t3, gram = basis_sweep(cv, s.beta, s.pprev, s.r, cs, cw,
                                           g, sc2, out=scratch)
        gsum = gram_sum(gram, run) * h1h2
        d = pair_scalars(problem, s.rr, s.k, gsum)
        coefs = torch.where(live, d.coefs, 0.0)
        x, r, p1, rr_part = pair_update(cv, coefs, pn, t1, t2, t3, s.x, s.r,
                                        out=p1_buf)
        rr2 = partial_sums((rr_part,), run)[0] * h1h2
        # p₁ is pn when only step 1 was applied (kernel D's only1 slot); its
        # buffer is not pn's, which the next sweep writes while reading it.
        # A frozen state never reads it to any effect (its coefficients are
        # zero).
        new = assemble_pair_state(problem, s, d, x, r, p1, rr2)
        return new._replace(**{
            name: torch.where(live, getattr(new, name), getattr(s, name))
            for name in ("k", "done", "rr", "beta", "diff")})

    return body


def _ca_solve(problem: Problem, cv: Canvas, cs, cw, g, rhs, sc2,
              check_every: int = CHECK_EVERY,
              run: int | None = None) -> _CAState:
    """The CA solve on given canvases (all on one device). A pair advances
    k by at most 2, so (cap + 1) // 2 pairs always reach the cap."""
    body = _make_ca_body(problem, cv, cs, cw, g, sc2, run)
    return drive(body, _ca_init(problem, cv, rhs),
                 (problem.iteration_cap + 1) // 2, check_every)


def ca_cg_solve(problem: Problem, device=None, rhs_gate=None,
                check_every: int = CHECK_EVERY, bm: int | None = None,
                serial: bool | None = None) -> PCGResult:
    """Single-device solve on the communication-avoiding path (fp32, scaled
    system): the counterpart of ``poisson_tpu.ops.pallas_ca.ca_cg_solve``,
    with the same golden counts as the fused path in 19 canvas passes per
    two iterations instead of 28. Runs on ``cuda`` unless ``device='cpu'``
    is asked for (plain versions). ``rhs_gate``, if given, multiplies the
    right-hand side (1.0 leaves the solve bit-identical); ``bm`` is the
    strip height of the full-width canvas; ``serial`` sums the partials
    with kernel S (off by default)."""
    cv, cs, cw, g, rhs, sc2, sc_int = build_canvases(problem, device, bm, 0)
    if rhs_gate is not None:
        rhs = rhs * torch.as_tensor(rhs_gate, dtype=rhs.dtype,
                                    device=rhs.device)
    s = _ca_solve(problem, cv, cs, cw, g, rhs, sc2, check_every,
                  ca_run(problem, cv, serial))
    return PCGResult(w=_solution(problem, cv, s.x, sc_int), iterations=s.k,
                     diff=s.diff, residual_dot=s.rr)


def ca_cg_solve_checkpointed(problem: Problem, checkpoint_path: str,
                             chunk: int = 200, bm: int | None = None,
                             serial: bool | None = None,
                             keep_checkpoint: bool = False,
                             keep_last: int = 2, device=None,
                             check_every: int = CHECK_EVERY) -> PCGResult:
    """CA solve with its state saved every ``chunk`` iterations and resumed
    from ``checkpoint_path``: the counterpart of
    ``pallas_ca.ca_cg_solve_checkpointed``, in the portable format of every
    checkpointed solver (``solvers.checkpoint``), so a CA file resumes on
    the fused path and the other way round. The pending pair (p_prev, β)
    is stored as the direction d = r + β·p_prev and resumed as
    p_prev := d − r, β := 1. A chunk runs pairs until k reaches
    min(k + chunk, cap), so it may overshoot by one iteration; only the
    global cap cuts a pair short."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    cv, cs, cw, g, rhs, sc2, sc_int = build_canvases(problem, device, bm, 0)
    fp = _fingerprint(problem, "float32", True)
    saved = load_state(checkpoint_path, fp, keep_last=keep_last)
    if saved is None:
        s = _ca_init(problem, cv, rhs)
    else:
        f = pcg_state_to_pending(problem, cv, saved, rhs.device)
        s = _CAState(k=f["k"], done=f["done"], x=f["sol"], r=f["r"],
                     pprev=f["pend"], rr=f["zr"], beta=f["beta"],
                     diff=f["diff"])
    body = _make_ca_body(problem, cv, cs, cw, g, sc2,
                         ca_run(problem, cv, serial))
    cap = problem.iteration_cap

    def advance(st: _CAState) -> _CAState:
        # Pairs to reach min(k + chunk, cap): non-final pairs add 2.
        stop_at = min(int(st.k) + chunk, cap)
        return drive(body, st, -(-(stop_at - int(st.k)) // 2), check_every)

    s = run_chunked(
        s, advance=advance,
        to_portable=lambda st: pending_to_pcg_state(
            problem, cv, k=st.k, done=st.done, sol=st.x, r=st.r,
            pend=st.pprev, beta=st.beta, zr=st.rr, diff=st.diff),
        path=checkpoint_path, fingerprint=fp, cap=cap,
        keep_checkpoint=keep_checkpoint, keep_last=keep_last,
    )
    return PCGResult(w=_solution(problem, cv, s.x, sc_int), iterations=s.k,
                     diff=s.diff, residual_dot=s.rr)
