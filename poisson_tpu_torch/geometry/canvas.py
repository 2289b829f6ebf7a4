"""Canvas compiler: GeometrySpec → fictitious-domain coefficient fields
(counterpart of ``poisson_tpu/geometry/canvas.py``).

The solver sees a domain only as the blend canvases ``a``, ``b`` and the
RHS indicator. This module builds them for any :mod:`geometry.dsl` spec
with the reference's blend rule (``models.fictitious_domain._blend``: a
full face → 1, an empty one → 1/ε, a cut one → ℓ/h + (1−ℓ/h)/ε,
ε = max(h1, h2)²):

- **closed-form face lengths** for :class:`Ellipse` (the reference's
  formula with (cx, cy, rx, ry); for the default spec the same bits as
  ``fictitious_domain.build_fields``) and :class:`Rectangle`;
- **face sampling of the level set** for every other family: each face is
  probed at ``samples + 1`` points, whole inside subintervals are counted
  and every sign change is bisected on the spec's ``sdf`` to ~h·2⁻⁴⁴
  (in blocks of faces, on threads unless the spec holds a user callable).

The host half is numpy fp64 in the JAX module's operation order, so every
fp64 array equals the JAX package's bit for bit; ``geometry_setup`` casts
it once to the state's dtype on the device (the fp64 value rounded once,
as ``jnp.asarray(a64, float32)`` rounds it) and caches it by (fingerprint,
grid, dtype, scaled, device), counted as ``geom.cache.{hits,misses}``.
``traced_fields`` is the torch twin of the closed-form bake, through which
autograd reaches the shape parameters (``solvers.adjoint``).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry.dsl import (
    SDF,
    Difference,
    Ellipse,
    GeometrySpec,
    Rectangle,
    _ns,
    parse_geometry,
)
from poisson_tpu_torch.models.fictitious_domain import _blend
from poisson_tpu_torch.ops.stencil import diag_D
from poisson_tpu_torch.utils.platform import resolve_device

# Face sampling: 16 probes classify each face, 44 bisection steps pin each
# boundary crossing to ~h·2e-14. Paid once per fingerprint (cached).
DEFAULT_SAMPLES = 16
DEFAULT_BISECT_ITERS = 44
# Faces per block of the sampler, and the threads the blocks run on (one
# for a spec holding a user callable).
SAMPLE_BLOCK = 1 << 15
SAMPLE_WORKERS = min(8, os.cpu_count() or 1)

_CACHE_CAP = 64
_CACHE: "OrderedDict" = OrderedDict()
# Host fp64 canvases by (fingerprint, grid): the device entries of every
# dtype and scaling, and an MG hierarchy, share one build (a sampled
# family at 800×1200 takes seconds of numpy).
_HOST_CAP = 16
_HOST: "OrderedDict" = OrderedDict()


def reset_geometry_cache() -> None:
    """Forget every cached canvas, device and host (tests; pair it with
    ``obs.metrics.reset()`` so hits and misses stay consistent)."""
    _CACHE.clear()
    _HOST.clear()


def _ellipse_lengths(spec: Ellipse, const, start, end, vertical, xp):
    """Closed-form face ∩ ellipse length: the reference's
    ``cal_seg_len_in_D`` with (cx, cy, rx, ry). The half-width's double
    ``where`` gives sqrt(0) = 0 as a bare root would, but a zero
    derivative where v ≤ 0 instead of 0·inf (the shape gradient)."""

    def _half(v, r):
        pos = v > 0.0
        return r * xp.where(pos, xp.sqrt(xp.where(pos, v, 1.0)), 0.0)

    if vertical:
        t = (const - spec.cx) / spec.rx
        half = _half(1.0 - t * t, spec.ry)
        lo, hi = spec.cy - half, spec.cy + half
    else:
        t = (const - spec.cy) / spec.ry
        half = _half(1.0 - t * t, spec.rx)
        lo, hi = spec.cx - half, spec.cx + half
    return xp.maximum(0.0, xp.minimum(end, hi) - xp.maximum(start, lo))


def _rectangle_lengths(spec: Rectangle, const, start, end, vertical, xp):
    """Closed-form face ∩ box length: the interval clip, where the fixed
    coordinate lies strictly inside the box's other extent."""
    if vertical:
        inside = (const > spec.x0) & (const < spec.x1)
        lo, hi = spec.y0, spec.y1
    else:
        inside = (const > spec.y0) & (const < spec.y1)
        lo, hi = spec.x0, spec.x1
    clip = xp.maximum(0.0, xp.minimum(end, hi) - xp.maximum(start, lo))
    return xp.where(inside, clip, xp.zeros_like(clip))


def closed_form_lengths(spec: GeometrySpec, const, start, end,
                        vertical: bool, xp=None):
    """Exact segment lengths for the families that have them, else None.
    ``xp`` is numpy (default) or ``torch``."""
    xp = _ns(xp)
    if isinstance(spec, Ellipse):
        return _ellipse_lengths(spec, const, start, end, vertical, xp)
    if isinstance(spec, Rectangle):
        return _rectangle_lengths(spec, const, start, end, vertical, xp)
    return None


def _sample_block(sdf_line: Callable, const_flat, start_flat, h: float,
                  samples: int, iters: int):
    """Face sampling of one block of faces: probe each face uniformly,
    count the whole inside subintervals, bisect every sign change."""
    dt = h / samples
    ts = start_flat[:, None] + dt * np.arange(samples + 1)[None, :]
    F = sdf_line(np.broadcast_to(const_flat[:, None], ts.shape), ts)
    inside = F < 0.0
    li, ri = inside[:, :-1], inside[:, 1:]
    lengths = (li & ri).sum(axis=1) * dt
    cross = li != ri
    if cross.any():
        fi, si = np.nonzero(cross)
        lo = ts[fi, si].astype(float)
        hi = ts[fi, si + 1].astype(float)
        c = const_flat[fi]
        lo_inside = li[fi, si]
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            mid_inside = sdf_line(c, mid) < 0.0
            take_lo = mid_inside == lo_inside
            lo = np.where(take_lo, mid, lo)
            hi = np.where(take_lo, hi, mid)
        crossing = 0.5 * (lo + hi)
        contrib = np.where(lo_inside, crossing - ts[fi, si],
                           ts[fi, si + 1] - crossing)
        np.add.at(lengths, fi, contrib)
    return lengths


def _sampled_lengths(sdf_line: Callable, const_flat, start_flat,
                     h: float, samples: int, iters: int, workers: int = 1):
    """Face sampling over ``sdf_line(c, t)``, the level set along the face
    family (c the fixed coordinate, t the running one) over same-shape
    numpy arrays. Features narrower than h/samples can be missed.

    The faces go in blocks of :data:`SAMPLE_BLOCK` (which bounds the
    probes' memory), on ``workers`` threads (numpy releases the GIL). A
    face's length depends on its own probes only, in the same operations
    and order whatever its block, so the result is the one-block result
    bit for bit."""
    n = const_flat.size
    spans = [(lo, min(n, lo + SAMPLE_BLOCK))
             for lo in range(0, n, SAMPLE_BLOCK)]
    run = lambda span: _sample_block(
        sdf_line, const_flat[span[0]:span[1]], start_flat[span[0]:span[1]],
        h, samples, iters)
    if len(spans) == 1:
        return run(spans[0])
    if workers > 1:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return np.concatenate(list(pool.map(run, spans)))
    return np.concatenate([run(span) for span in spans])


def _calls_user_code(spec: GeometrySpec) -> bool:
    """Whether ``spec`` holds a raw :class:`SDF`, whose callable may not
    be safe to call from several threads at once."""
    if isinstance(spec, SDF):
        return True
    children = getattr(spec, "shapes", ())
    if isinstance(spec, Difference):
        children = (spec.shape, spec.hole)
    return any(_calls_user_code(c) for c in children)


def _node_axes(problem: Problem):
    """Node coordinates x (column) and y (row), numpy fp64."""
    i_idx = np.arange(problem.M + 1)
    j_idx = np.arange(problem.N + 1)
    x = (problem.x_min + i_idx.astype(np.float64) * problem.h1)[:, None]
    y = (problem.y_min + j_idx.astype(np.float64) * problem.h2)[None, :]
    return i_idx, j_idx, x, y


def geometry_face_lengths(problem: Problem, spec: GeometrySpec,
                          samples: int = DEFAULT_SAMPLES,
                          bisect_iters: int = DEFAULT_BISECT_ITERS):
    """Face lengths (la, lb) on the full (M+1, N+1) grid, numpy fp64.
    ``la[i, j]`` is the vertical face at (x_i − h1/2, [y_j ∓ h2/2]),
    ``lb`` the horizontal one, as in ``fictitious_domain``."""
    h1, h2 = problem.h1, problem.h2
    _, _, x, y = _node_axes(problem)
    la = closed_form_lengths(spec, x - 0.5 * h1, y - 0.5 * h2,
                             y + 0.5 * h2, True, np)
    lb = closed_form_lengths(spec, y - 0.5 * h2, x - 0.5 * h1,
                             x + 0.5 * h1, False, np)
    shape = (problem.M + 1, problem.N + 1)
    workers = 1 if _calls_user_code(spec) else SAMPLE_WORKERS
    if la is None:
        const = np.broadcast_to(x - 0.5 * h1, shape).ravel()
        start = np.broadcast_to(y - 0.5 * h2, shape).ravel()
        la = _sampled_lengths(
            lambda c, t: spec.sdf(c, t, np), const, start, h2,
            samples, bisect_iters, workers).reshape(shape)
    else:
        la = np.broadcast_to(la, shape)
    if lb is None:
        const = np.broadcast_to(y - 0.5 * h2, shape).ravel()
        start = np.broadcast_to(x - 0.5 * h1, shape).ravel()
        lb = _sampled_lengths(
            lambda c, t: spec.sdf(t, c, np), const, start, h1,
            samples, bisect_iters, workers).reshape(shape)
    else:
        lb = np.broadcast_to(lb, shape)
    return np.asarray(la, np.float64), np.asarray(lb, np.float64)


def build_geometry_fields(problem: Problem, spec,
                          rhs_fn: Optional[Callable] = None,
                          samples: int = DEFAULT_SAMPLES,
                          bisect_iters: int = DEFAULT_BISECT_ITERS):
    """Full-grid (a, b, B) for ``spec``, host numpy fp64: the
    geometry-general ``fictitious_domain.build_fields``. ``rhs_fn(x, y)``
    replaces the constant ``problem.f_val`` forcing (the manufactured
    gate's); the indicator and interior masks apply either way."""
    spec = parse_geometry(spec)
    h1, h2, eps = problem.h1, problem.h2, problem.eps
    la, lb = geometry_face_lengths(problem, spec, samples, bisect_iters)
    a = _blend(la, h2, eps).astype(np.float64)
    b = _blend(lb, h1, eps).astype(np.float64)
    i_idx, j_idx, x, y = _node_axes(problem)
    inside = spec.contains(x, y, np)
    interior = ((i_idx >= 1) & (i_idx <= problem.M - 1))[:, None] & (
        (j_idx >= 1) & (j_idx <= problem.N - 1))[None, :]
    f = (np.float64(problem.f_val) if rhs_fn is None
         else np.asarray(rhs_fn(x, y), np.float64))
    rhs = np.where(inside & interior, f, np.float64(0.0))
    return a, b, rhs


def host_fields(problem: Problem, spec):
    """:func:`build_geometry_fields` of ``spec`` with the constant forcing,
    cached by (fingerprint, grid): shared, read-only arrays."""
    spec = parse_geometry(spec)
    key = (spec.fingerprint, _canvas_key(problem))
    hit = _HOST.get(key)
    if hit is not None:
        _HOST.move_to_end(key)
        return hit
    out = build_geometry_fields(problem, spec)
    for arr in out:
        arr.flags.writeable = False
    _HOST[key] = out
    while len(_HOST) > _HOST_CAP:
        _HOST.popitem(last=False)
    return out


def scaled_operands(a64, b64, rhs64, problem: Problem, scaled: bool):
    """(a, b, rhs_use, aux) fp64 from host canvases, as
    ``solvers.pcg.host_fields64`` derives them: aux is the zero-ring
    embedding of D (unscaled) or of D^{-1/2} (scaled), rhs_use B or
    D^{-1/2}B."""
    d64 = diag_D(a64, b64, problem.h1, problem.h2)
    if not scaled:
        return a64, b64, rhs64, np.pad(d64, 1)
    inv_sqrt_d = 1.0 / np.sqrt(d64)
    return a64, b64, np.pad(rhs64[1:-1, 1:-1] * inv_sqrt_d, 1), np.pad(
        inv_sqrt_d, 1)


def _fields64(problem: Problem, spec: GeometrySpec, scaled: bool):
    """(a, b, rhs_use, aux) fp64 numpy for ``spec``."""
    return scaled_operands(*host_fields(problem, spec), problem, scaled)


def _canvas_key(problem: Problem) -> tuple:
    """The Problem fields the canvases depend on: the stopping knobs
    (delta, max_iter, weighted_norm) are left out, so requests that differ
    only there share canvases."""
    return (problem.M, problem.N, problem.x_min, problem.x_max,
            problem.y_min, problem.y_max, problem.f_val)


def _device_key(dev: torch.device) -> str:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def geometry_setup(problem: Problem, spec, dtype_name: str, scaled: bool,
                   device=None):
    """(a, b, rhs, aux) for ``spec`` as ``dtype_name`` tensors on
    ``device`` (default ``cuda``): the geometry form of
    ``solvers.pcg.solve_setup``'s fields. Each call counts
    ``geom.cache.hits`` or ``geom.cache.misses``; a miss pays the host fp64
    build, the cast and the copy once. The tensors are shared between
    callers: read only."""
    spec = parse_geometry(spec)
    dev = resolve_device(device)
    key = (spec.fingerprint, _canvas_key(problem), dtype_name, bool(scaled),
           _device_key(dev))
    hit = _CACHE.get(key)
    if hit is not None:
        _CACHE.move_to_end(key)
        obs.inc("geom.cache.hits")
        return hit
    obs.inc("geom.cache.misses")
    tdtype = getattr(torch, dtype_name)
    out = tuple(torch.tensor(x, dtype=tdtype, device=dev)
                for x in _fields64(problem, spec, scaled))
    _CACHE[key] = out
    while len(_CACHE) > _CACHE_CAP:
        _CACHE.popitem(last=False)
    return out


def traced_fields(problem: Problem, spec: GeometrySpec,
                  dtype=torch.float64, device=None):
    """(a, b, rhs) built with torch operations, so that autograd flows
    from the spec's tensor parameters through the blend into ``a`` and
    ``b`` (``solvers.adjoint``). Only the closed-form families qualify
    (:class:`Ellipse`, :class:`Rectangle`): the sampled ones come from host
    bisection, which carries no parameter derivative, and raise. ``spec``
    is used as given (normalizing needs plain floats). The RHS indicator
    is piecewise constant in the parameters and carries none. In fp32 the
    half-width's root is the correctly rounded one, as on the host."""
    if not isinstance(spec, (Ellipse, Rectangle)):
        raise ValueError(
            "traced_fields (shape gradients) supports the closed-form "
            "families Ellipse and Rectangle; "
            f"got {type(spec).__name__} — sampled canvases are built by "
            "host-side bisection and carry no parameter derivative")
    dev = resolve_device(device)
    h1, h2, eps = problem.h1, problem.h2, problem.eps
    i_idx = torch.arange(problem.M + 1, device=dev)
    j_idx = torch.arange(problem.N + 1, device=dev)
    x = (problem.x_min + i_idx.to(dtype) * h1)[:, None]
    y = (problem.y_min + j_idx.to(dtype) * h2)[None, :]
    la = closed_form_lengths(spec, x - 0.5 * h1, y - 0.5 * h2,
                             y + 0.5 * h2, True, torch)
    lb = closed_form_lengths(spec, y - 0.5 * h2, x - 0.5 * h1,
                             x + 0.5 * h1, False, torch)
    shape = (problem.M + 1, problem.N + 1)
    a = torch.broadcast_to(_blend(la, h2, eps), shape).to(dtype)
    b = torch.broadcast_to(_blend(lb, h1, eps), shape).to(dtype)
    inside = spec.contains(x, y, torch)
    interior = ((i_idx >= 1) & (i_idx <= problem.M - 1))[:, None] & (
        (j_idx >= 1) & (j_idx <= problem.N - 1))[None, :]
    rhs = torch.where(inside & interior,
                      torch.tensor(problem.f_val, dtype=dtype, device=dev),
                      torch.zeros((), dtype=dtype, device=dev))
    return a, b, torch.broadcast_to(rhs, shape)


def cut_face_mask(a64, b64, eps):
    """Nodes touching a cut face: a blend coefficient strictly between the
    full-face value (1) and the empty-face value (1/eps), with relative
    bounds (an absolute midpoint would drop low-coverage cut faces)."""
    hi = (1.0 / eps) * (1.0 - 1e-9)
    return ((a64 > 1.0 + 1e-9) & (a64 < hi)) | (
        (b64 > 1.0 + 1e-9) & (b64 < hi))


def render_ascii(problem: Problem, spec, width: int = 64,
                 height: int = 24) -> str:
    """A downsampled ASCII preview (``python -m poisson_tpu_torch geometry
    SPEC``): '#' inside, '+' a node touching a cut face, '.' outside."""
    spec = parse_geometry(spec)
    a64, b64, rhs64 = build_geometry_fields(problem, spec)
    cut = cut_face_mask(a64, b64, problem.eps)
    inside = rhs64 != 0.0
    rows = []
    ii = np.linspace(0, problem.M, num=min(width, problem.M + 1),
                     dtype=int)
    jj = np.linspace(0, problem.N, num=min(height, problem.N + 1),
                     dtype=int)
    for j in jj[::-1]:                     # y up, as in a plot
        row = []
        for i in ii:
            if inside[i, j]:
                row.append("#")
            elif cut[i, j]:
                row.append("+")
            else:
                row.append(".")
        rows.append("".join(row))
    return "\n".join(rows)
