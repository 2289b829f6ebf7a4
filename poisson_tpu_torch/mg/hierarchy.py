"""Geometric multigrid level hierarchy over the fictitious-domain canvases
(counterpart of ``poisson_tpu/mg/hierarchy.py``).

Jacobi-preconditioned CG pays iterations that grow with resolution (989
at 800×1200, 2449 at 2400×3200). One geometric V-cycle per iteration
(``mg.cycle``) smooths every error frequency on the level where it is
local, so the count stays near-flat in resolution. This module builds the
level data the V-cycle consumes:

- **Level plan** (:func:`plan_levels`): vertex-centred factor-2
  coarsening, (M, N) → (M/2, N/2), while both dimensions stay even and the
  coarser grid stays at or above ``MGConfig.min_size``. 400×600 and
  800×1200 both bottom out at 50×75; 2400×3200 at 75×100.
- **Coefficient coarsening** (:func:`coarsen_a`/:func:`coarsen_b`): a
  coarse face averages the two fine faces it covers in series
  (arithmetically, so the ~1/ε penalty outside the domain stays stiff)
  and the (¼, ½, ¼)-weighted transverse neighbours its doubled length
  spans. Constant fields coarsen exactly to themselves.
- **Coarsest-level solve**: up to ``coarse_dense_limit`` interior unknowns
  the coarsest operator is materialised as a dense matrix and inverted
  once on the host in fp64 (symmetrised, so the V-cycle stays SPD); above
  it the coarsest level runs ``coarse_sweeps`` smoother sweeps instead
  (the ``mg.coarse_dense`` gauge says which).

Everything is derived on the host in numpy fp64, as the JAX package
derives it, so the host arrays equal JAX's bit for bit; they are cast once
to the state's dtype on an explicit device. Device hierarchies are cached
per (problem with ``f_val`` = 1, dtype, scaled, geometry fingerprint,
config, device), counted by ``mg.hierarchy_cache.{hits,misses}``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.stencil import diag_D
from poisson_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass(frozen=True)
class MGConfig:
    """The V-cycle knobs (hashable; its ``repr`` is the JAX package's, so
    it enters checkpoint fingerprints that both packages read).

    pre_smooth/post_smooth: weighted-Jacobi sweeps per level, down- and
        up-leg. Equal counts keep the cycle symmetric, hence an SPD
        preconditioner, which plain CG requires.
    omega: Jacobi damping (0.8, the classic 2D 5-point choice).
    coarse_sweeps: smoother sweeps standing in for the coarsest solve when
        the dense inverse is over its size limit.
    coarse_dense_limit: max interior unknowns for the dense coarsest
        inverse (n² fp64 on the host, one n³ factorisation).
    min_size: stop coarsening when min(M, N)/2 would fall below this.
    max_levels: hierarchy depth cap.
    """

    pre_smooth: int = 2
    post_smooth: int = 2
    omega: float = 0.8
    coarse_sweeps: int = 32
    coarse_dense_limit: int = 4096
    min_size: int = 10
    max_levels: int = 16


DEFAULT_MG = MGConfig()

PRECONDITIONERS = ("jacobi", "mg")


def resolve_preconditioner(preconditioner) -> str:
    """Validate a preconditioner name; None means the default."""
    name = "jacobi" if preconditioner is None else str(preconditioner)
    if name not in PRECONDITIONERS:
        raise ValueError(
            f"unknown preconditioner {preconditioner!r}: expected one of "
            f"{PRECONDITIONERS}"
        )
    return name


def plan_levels(M: int, N: int, config: MGConfig = DEFAULT_MG) -> tuple:
    """The (M_l, N_l) ladder, finest first. Level l+1 exists iff both
    dimensions of level l are even, the halved grid stays at or above
    ``config.min_size`` and the depth cap allows it."""
    levels = [(int(M), int(N))]
    while len(levels) < config.max_levels:
        m, n = levels[-1]
        if m % 2 or n % 2 or min(m, n) // 2 < config.min_size:
            break
        levels.append((m // 2, n // 2))
    return tuple(levels)


def validate_mg_problem(problem: Problem,
                        config: MGConfig = DEFAULT_MG) -> tuple:
    """The level plan for ``problem``, or a ValueError when the grid cannot
    coarsen at all (odd dimensions, or too small): an uncoarsenable
    "multigrid" would silently be an expensive smoother."""
    levels = plan_levels(problem.M, problem.N, config)
    if len(levels) < 2:
        raise ValueError(
            f"preconditioner='mg' needs a grid that coarsens at least "
            f"once: {problem.M}x{problem.N} does not (both M and N must "
            f"be even, with min(M, N) >= {2 * config.min_size}). Use "
            f"preconditioner='jacobi' for this grid."
        )
    return levels


def mg_config_for(problem: Problem, preconditioner,
                  mg_config=None) -> MGConfig | None:
    """None for the Jacobi preconditioner; for ``"mg"``, the cycle config
    (``mg_config`` or the defaults) once ``problem``'s grid is known to
    coarsen. An unknown name raises."""
    if resolve_preconditioner(preconditioner) == "jacobi":
        return None
    config = mg_config or DEFAULT_MG
    validate_mg_problem(problem, config)
    return config


# -- coefficient coarsening (host numpy fp64) ---------------------------


def coarsen_a(a: np.ndarray) -> np.ndarray:
    """Coarsen the x-face coefficient field, fine (M+1, N+1) → coarse
    (M/2+1, N/2+1): the two fine faces 2I−1, 2I in series along x, over
    the transverse fine positions 2J−1, 2J, 2J+1 weighted ¼, ½, ¼. Row 0
    and columns 0 and N_c are never read by the operators and are filled
    by injection."""
    pair = 0.5 * (a[1::2, :] + a[2::2, :])        # series avg, I = 1..Mc
    core = (0.25 * pair[:, 1:-2:2] + 0.5 * pair[:, 2:-1:2]
            + 0.25 * pair[:, 3::2])               # J = 1..Nc-1
    ac = np.ascontiguousarray(a[::2, ::2])        # injection filler
    ac[1:, 1:-1] = core
    return ac


def coarsen_b(b: np.ndarray) -> np.ndarray:
    """Coarsen the y-face coefficient field: :func:`coarsen_a` with the
    axis roles transposed."""
    pair = 0.5 * (b[:, 1::2] + b[:, 2::2])        # series avg, J = 1..Nc
    core = (0.25 * pair[1:-2:2, :] + 0.5 * pair[2:-1:2, :]
            + 0.25 * pair[3::2, :])               # I = 1..Mc-1
    bc = np.ascontiguousarray(b[::2, ::2])
    bc[1:-1, 1:] = core
    return bc


def _dense_operator(a: np.ndarray, b: np.ndarray, h1: float,
                    h2: float) -> np.ndarray:
    """The 5-point operator on the interior as a dense (n, n) fp64 matrix,
    row-major over (i, j) with j fastest: the coarsest level the dense
    inverse factors."""
    M, N = a.shape[0] - 1, a.shape[1] - 1
    mi, nj = M - 1, N - 1
    n = mi * nj
    d = diag_D(a, b, h1, h2)
    A = np.zeros((n, n))
    A[np.arange(n), np.arange(n)] = d.ravel()
    # x-neighbours: (i, j) <-> (i+1, j), coefficient -a[i+1, j]/h1².
    off_x = (-a[2:-1, 1:-1] / (h1 * h1)).ravel()
    rows = np.arange(n - nj)
    A[rows, rows + nj] = off_x
    A[rows + nj, rows] = off_x
    # y-neighbours: (i, j) <-> (i, j+1), coefficient -b[i, j+1]/h2²; the
    # flat offset 1 wraps at row ends, so those links are left out.
    off_y = (-b[1:-1, 2:-1] / (h2 * h2)).ravel(order="C")
    rows_y = (np.arange(mi)[:, None] * nj + np.arange(nj - 1)).ravel()
    A[rows_y, rows_y + 1] = off_y
    A[rows_y + 1, rows_y] = off_y
    return A


class MGLevels(NamedTuple):
    """Level data as tensors on one device.

    levels: one (a, b, dinv) triple per level, finest first: the
        coefficient canvases and the zero-ring-padded inverse Jacobi
        diagonal (the ring keeps smoothed iterates zero on the boundary).
    coarse_inv: the dense coarsest-operator inverse (n, n), or None when
        the coarsest level is over the dense limit (it then runs
        ``coarse_sweeps`` smoother sweeps).
    scinv: √d on the full grid (zero ring), the wrap of the symmetrically
        scaled outer system, or None for unscaled solves.
    """

    levels: tuple
    coarse_inv: object = None
    scinv: object = None


def build_hierarchy64(problem: Problem, a64: np.ndarray, b64: np.ndarray,
                      config: MGConfig = DEFAULT_MG) -> dict:
    """All host fp64 level data for ``problem``'s canvases: per-level
    (a, b, dinv_padded), the dense coarsest inverse when within the size
    limit, and √d for the scaled wrap."""
    dims = validate_mg_problem(problem, config)
    levels = []
    a, b = np.asarray(a64, np.float64), np.asarray(b64, np.float64)
    for lvl, (m, n) in enumerate(dims):
        h1 = (problem.x_max - problem.x_min) / m
        h2 = (problem.y_max - problem.y_min) / n
        d = diag_D(a, b, h1, h2)
        levels.append((a, b, np.pad(1.0 / d, 1)))
        if lvl + 1 < len(dims):
            a, b = coarsen_a(a), coarsen_b(b)
    mc, nc = dims[-1]
    coarse_inv = None
    if (mc - 1) * (nc - 1) <= config.coarse_dense_limit:
        ac, bc, _ = levels[-1]
        h1c = (problem.x_max - problem.x_min) / mc
        h2c = (problem.y_max - problem.y_min) / nc
        inv = np.linalg.inv(_dense_operator(ac, bc, h1c, h2c))
        coarse_inv = 0.5 * (inv + inv.T)   # exactly symmetric: SPD cycle
    d0 = diag_D(np.asarray(a64, np.float64), np.asarray(b64, np.float64),
                problem.h1, problem.h2)
    return {
        "dims": dims,
        "levels": levels,
        "coarse_inv": coarse_inv,
        "scinv": np.pad(np.sqrt(d0), 1),
    }


def levels_to_device(host: dict, dtype_name: str, scaled: bool,
                     device=None) -> MGLevels:
    """Cast host level data (numpy, any precision) once to ``dtype_name``
    tensors on ``device`` (default ``cuda``); ``scinv`` only when
    ``scaled``."""
    dev = resolve_device(device)
    dt = getattr(torch, dtype_name)
    cast = lambda x: torch.tensor(np.asarray(x), dtype=dt, device=dev)
    levels = tuple((cast(a), cast(b), cast(dinv))
                   for a, b, dinv in host["levels"])
    coarse_inv = (None if host["coarse_inv"] is None
                  else cast(host["coarse_inv"]))
    scinv = cast(host["scinv"]) if scaled else None
    return MGLevels(levels=levels, coarse_inv=coarse_inv, scinv=scinv)


# Device hierarchies this process has built, keyed by (problem with
# f_val=1, dtype, scaled, geometry fingerprint, config, device): the blend
# canvases do not depend on f_val, so every RHS magnitude of a domain
# shares one hierarchy, and a hierarchy on one device never serves a solve
# on another.
_HIERARCHIES: dict = {}


def reset_hierarchy_cache() -> None:
    """Forget cached hierarchies (tests; pair with ``obs.metrics.reset()``
    or the hit and miss counts go stale)."""
    _HIERARCHIES.clear()


def _device_key(dev: torch.device) -> str:
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


def device_hierarchy(problem: Problem, dtype_name: str, scaled: bool,
                     geometry=None, config: MGConfig = DEFAULT_MG,
                     device=None) -> MGLevels:
    """The cached hierarchy for ``problem`` (and ``geometry``, a
    ``poisson_tpu_torch.geometry`` spec; None is the reference ellipse) on
    ``device`` (default ``cuda``): the host fp64 build and dense coarsest
    factorisation are paid once per domain, dtype, scaling, config and
    device."""
    dev = resolve_device(device)
    fp = None
    if geometry is not None:
        from poisson_tpu_torch.geometry.dsl import parse_geometry

        geometry = parse_geometry(geometry)
        fp = geometry.fingerprint
    key = (problem.with_(f_val=1.0), dtype_name, bool(scaled), fp, config,
           _device_key(dev))
    cached = _HIERARCHIES.get(key)
    if cached is not None:
        obs.inc("mg.hierarchy_cache.hits")
        return cached
    obs.inc("mg.hierarchy_cache.misses")
    if geometry is None:
        from poisson_tpu_torch.solvers.pcg import host_fields64

        a64, b64, _, _ = host_fields64(problem.with_(f_val=1.0), False)
    else:
        from poisson_tpu_torch.geometry.canvas import host_fields

        a64, b64, _ = host_fields(problem, geometry)
    host = build_hierarchy64(problem, a64, b64, config)
    hier = levels_to_device(host, dtype_name, scaled, dev)
    _HIERARCHIES[key] = hier
    obs.gauge("mg.levels", len(hier.levels))
    obs.gauge("mg.coarse_dense", 1 if hier.coarse_inv is not None else 0)
    obs.event("mg.hierarchy", grid=f"{problem.M}x{problem.N}",
              levels=len(hier.levels),
              coarsest="x".join(map(str, host["dims"][-1])),
              dense_coarse=hier.coarse_inv is not None,
              fingerprint=fp)
    return hier


def hierarchy_from_fields(problem: Problem, a64: np.ndarray,
                          b64: np.ndarray, dtype_name: str, scaled: bool,
                          config: MGConfig = DEFAULT_MG,
                          device=None) -> MGLevels:
    """An uncached hierarchy straight from explicit host canvases (a
    caller that builds its own fields must precondition exactly those)."""
    return levels_to_device(build_hierarchy64(problem, a64, b64, config),
                            dtype_name, scaled, device)
