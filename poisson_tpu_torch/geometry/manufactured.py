"""Manufactured-solution accuracy gate, per geometry family (counterpart of
``poisson_tpu/geometry/manufactured.py``).

The ellipse has an analytic oracle, u = (1 − x² − 4y²)/10 solving −Δu = 1
on the reference domain. Every other family ships under the same rule:
each case pairs a spec with an exact solution u vanishing on ∂D and the
forcing f = −Δu; the fictitious-domain solve runs against f·1_D, and the
weighted L2 error over the nodes strictly inside D must land at the floor
the penalty method allows (O(√ε·‖u‖), ε = max(h1, h2)²: first order in h).

One case per DSL node type, each a domain with a closed-form solution:

- ``ellipse`` — the reference domain itself;
- ``ellipse-offset`` — a translated, rescaled ellipse (quadratic u);
- ``rectangle`` — closed-form canvases, sine-product u;
- ``polygon`` — the same rectangle as a 4-vertex polygon: the sampler must
  reach the closed form's accuracy;
- ``union`` / ``intersection`` / ``difference`` — composites whose result
  is one rectangle or a disjoint pair, so the sine product still applies
  while the canvases go through the composite level sets;
- ``sdf`` — a raw-callable circle, quadratic u.

:func:`manufactured_error` runs one case end to end, with the Jacobi or
the MG preconditioner, on the port's plain solve.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry.dsl import (
    DEFAULT_ELLIPSE,
    Difference,
    Ellipse,
    GeometrySpec,
    Intersection,
    Polygon,
    Rectangle,
    SDF,
    Union,
)


@dataclasses.dataclass(frozen=True)
class ManufacturedCase:
    """A family's accuracy oracle: exact u inside D (zero outside), and the
    forcing f = −Δu (None: the constant ``problem.f_val``, the standard
    indicator RHS)."""

    name: str
    spec: GeometrySpec
    u: Callable                      # (x, y) -> exact solution
    f: Optional[Callable] = None     # (x, y) -> forcing; None = f_val


def _quad_ellipse(e: Ellipse):
    """u = c·(1 − tx² − ty²) with −Δu = 2c(1/rx² + 1/ry²) ≡ 1."""
    c = 1.0 / (2.0 * (1.0 / e.rx ** 2 + 1.0 / e.ry ** 2))

    def u(x, y):
        tx = (x - e.cx) / e.rx
        ty = (y - e.cy) / e.ry
        return c * (1.0 - tx * tx - ty * ty)

    return u


def _sine_rect(r: Rectangle, c: float = 0.1):
    """u = c·sin(π(x−x0)/Lx)·sin(π(y−y0)/Ly) on the box, with
    f = −Δu = c·π²(1/Lx² + 1/Ly²)·sin·sin."""
    lx, ly = r.x1 - r.x0, r.y1 - r.y0
    k = c * math.pi ** 2 * (1.0 / lx ** 2 + 1.0 / ly ** 2)

    def shape_fn(scale):
        def fn(x, y):
            sx = np.sin(np.pi * (x - r.x0) / lx)
            sy = np.sin(np.pi * (y - r.y0) / ly)
            val = scale * sx * sy
            inside = (x > r.x0) & (x < r.x1) & (y > r.y0) & (y < r.y1)
            return np.where(inside, val, 0.0)
        return fn

    return shape_fn(c), shape_fn(k)


def _sum_fns(*fns):
    def fn(x, y):
        out = fns[0](x, y)
        for g in fns[1:]:
            out = out + g(x, y)
        return out
    return fn


def cases() -> list:
    """One manufactured case per geometry family."""
    out = []

    out.append(ManufacturedCase(
        "ellipse", DEFAULT_ELLIPSE, _quad_ellipse(DEFAULT_ELLIPSE)))

    off = Ellipse(cx=0.15, cy=-0.05, rx=0.6, ry=0.35)
    out.append(ManufacturedCase("ellipse-offset", off, _quad_ellipse(off)))

    rect = Rectangle(-0.7, -0.4, 0.5, 0.3)
    u, f = _sine_rect(rect)
    out.append(ManufacturedCase("rectangle", rect, u, f))

    # The same box as a polygon ring: the sampler against the closed form.
    poly = Polygon(((-0.7, -0.4), (0.5, -0.4), (0.5, 0.3), (-0.7, 0.3)))
    out.append(ManufacturedCase("polygon", poly, u, f))

    r1 = Rectangle(-0.85, -0.35, -0.15, 0.25)
    r2 = Rectangle(0.1, -0.3, 0.8, 0.3)
    u1, f1 = _sine_rect(r1)
    u2, f2 = _sine_rect(r2)
    out.append(ManufacturedCase(
        "union", Union((r1, r2)), _sum_fns(u1, u2), _sum_fns(f1, f2)))

    # Overlapping boxes whose intersection is exactly a rectangle.
    ia = Rectangle(-0.8, -0.45, 0.3, 0.35)
    ib = Rectangle(-0.4, -0.3, 0.7, 0.5)
    ir = Rectangle(-0.4, -0.3, 0.3, 0.35)
    ui, fi = _sine_rect(ir)
    out.append(ManufacturedCase(
        "intersection", Intersection((ia, ib)), ui, fi))

    # A bite across the big box's whole y-extent, so a rectangle remains.
    big = Rectangle(-0.8, -0.4, 0.6, 0.3)
    bite = Rectangle(0.0, -0.5, 0.9, 0.4)
    rem = Rectangle(-0.8, -0.4, 0.0, 0.3)
    ud, fd = _sine_rect(rem)
    out.append(ManufacturedCase(
        "difference", Difference(big, bite), ud, fd))

    r = 0.45
    circle = SDF(lambda x, y: x * x + y * y - r * r, name=f"circle-{r}")

    def u_circ(x, y):
        return 0.25 * (r * r - x * x - y * y)     # −Δu = 1

    out.append(ManufacturedCase("sdf", circle, u_circ))
    return out


def case_by_name(name: str) -> ManufacturedCase:
    for c in cases():
        if c.name == name:
            return c
    raise KeyError(name)


def manufactured_error(case: ManufacturedCase, M: int, N: int,
                       dtype=None, preconditioner: str = "jacobi",
                       krylov=None, device=None) -> dict:
    """Run ``case`` on an M×N grid (on ``device``, default ``cuda``) and
    measure the weighted L2 error over the nodes strictly inside D.

    Returns ``{"case", "l2", "rel", "iterations", "flag"}``; ``rel`` is the
    error relative to ‖u‖, which the per-family floors gate.
    ``preconditioner="mg"`` runs the same oracle through the V-cycle on a
    hierarchy built from exactly the case's canvases. ``krylov`` is
    refused with the ROADMAP item that ports it."""
    from poisson_tpu_torch.geometry.canvas import (
        build_geometry_fields,
        scaled_operands,
    )
    from poisson_tpu_torch.mg.hierarchy import (
        hierarchy_from_fields,
        mg_config_for,
    )
    from poisson_tpu_torch.mg.preconditioner import CHECK_EVERY_MG, mg_ops
    from poisson_tpu_torch.solvers.pcg import (
        not_ported,
        resolve_dtype,
        resolve_scaled,
        run_setup,
        setup_from_fields,
    )
    from poisson_tpu_torch.utils.platform import resolve_device

    if krylov is not None:
        raise not_ported("krylov")
    problem = Problem(M=M, N=N)
    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(None, dtype_name)
    config = mg_config_for(problem, preconditioner)
    a64, b64, rhs64 = build_geometry_fields(problem, case.spec,
                                            rhs_fn=case.f)
    tdtype = getattr(torch, dtype_name)
    fields = [torch.tensor(x, dtype=tdtype, device=dev)
              for x in scaled_operands(a64, b64, rhs64, problem, use_scaled)]
    setup = setup_from_fields(problem, *fields, dtype_name, use_scaled)
    if config is not None:
        hier = hierarchy_from_fields(problem, a64, b64, dtype_name,
                                     use_scaled, config, dev)
        setup = setup._replace(
            ops=mg_ops(problem, fields[0], fields[1], fields[3], hier,
                       config, use_scaled),
            check_every=CHECK_EVERY_MG, preconditioner="mg")
    result = run_setup(problem, setup, setup.rhs)

    i_idx = np.arange(problem.M + 1)
    j_idx = np.arange(problem.N + 1)
    x = (problem.x_min + i_idx.astype(np.float64) * problem.h1)[:, None]
    y = (problem.y_min + j_idx.astype(np.float64) * problem.h2)[None, :]
    mask = case.spec.contains(x, y, np)
    u = np.where(mask, case.u(x, y), 0.0)
    w64 = result.w.detach().cpu().numpy().astype(np.float64)
    werr = np.where(mask, (w64 - u) ** 2, 0.0)
    wnorm = np.where(mask, u ** 2, 0.0)
    scale = problem.h1 * problem.h2
    l2 = float(np.sqrt(werr.sum() * scale))
    norm = float(np.sqrt(wnorm.sum() * scale))
    return {
        "case": case.name,
        "l2": l2,
        "rel": l2 / norm if norm else float("inf"),
        "iterations": int(result.iterations),
        "flag": int(result.flag),
    }
