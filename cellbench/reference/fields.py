"""The ellipse's fictitious-domain fields, frozen in plain NumPy.

The benchmark's own copy of the reference project's setup
(``stage0/Withoutopenmp1.cpp:14-60,106-119``), written from the formulas
and not imported from the program under test, so that a change to the
program's setup cannot move the yardstick:

  - nodes x_i = x_min + i·h1, y_j = y_min + j·h2, i = 0..M, j = 0..N;
  - a[i, j] on the vertical face x = x_i − h1/2, y ∈ [y_j − h2/2, y_j + h2/2],
    b[i, j] on the horizontal face y = y_j − h2/2, x ∈ [x_i − h1/2, x_i + h1/2];
  - with ℓ the face's length inside D = {x² + 4y² < 1} and h its length:
    1 if |ℓ − h| < 1e-9, 1/ε if ℓ < 1e-9, else ℓ/h + (1 − ℓ/h)/ε,
    ε = max(h1, h2)²;
  - B[i, j] = f · 1[(x_i, y_j) ∈ D] on the interior, 0 on the ring.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

FACE_TOL = 1e-9


class Grid(NamedTuple):
    """The box, the grid and the stop rule of one deployment."""

    M: int
    N: int
    x_min: float = -1.0
    x_max: float = 1.0
    y_min: float = -0.6
    y_max: float = 0.6
    f_val: float = 1.0
    delta: float = 1e-6
    weighted_norm: bool = True

    @property
    def h1(self) -> float:
        return (self.x_max - self.x_min) / self.M

    @property
    def h2(self) -> float:
        return (self.y_max - self.y_min) / self.N

    @property
    def eps(self) -> float:
        h = max(self.h1, self.h2)
        return h * h

    @property
    def shape(self) -> tuple[int, int]:
        return (self.M + 1, self.N + 1)


def grid_from_config(config: dict) -> Grid:
    """The Grid a configuration file states (its ``domain`` and ``grid``)."""
    dom = config["domain"]
    return Grid(M=config["grid"]["M"], N=config["grid"]["N"],
                x_min=dom["x_min"], x_max=dom["x_max"],
                y_min=dom["y_min"], y_max=dom["y_max"], f_val=dom["f"],
                delta=config["delta"], weighted_norm=config["weighted_norm"])


def nodes(g: Grid) -> tuple[np.ndarray, np.ndarray]:
    """Node coordinates as a column (x) and a row (y)."""
    x = g.x_min + np.arange(g.M + 1, dtype=np.float64) * g.h1
    y = g.y_min + np.arange(g.N + 1, dtype=np.float64) * g.h2
    return x[:, None], y[None, :]


def _length_inside(half, lo, hi):
    return np.maximum(0.0, np.minimum(hi, half) - np.maximum(lo, -half))


def _blend(length, h, eps):
    frac = length / h
    return np.where(np.abs(length - h) < FACE_TOL, 1.0,
                    np.where(length < FACE_TOL, 1.0 / eps,
                             frac + (1.0 - frac) / eps))


def coefficients(g: Grid) -> tuple[np.ndarray, np.ndarray]:
    """Edge coefficients a, b on the full (M+1, N+1) grid, fp64."""
    x, y = nodes(g)
    xf = x - 0.5 * g.h1                       # vertical faces
    half_y = np.sqrt(np.maximum(0.0, (1.0 - xf * xf) / 4.0))
    la = _length_inside(half_y, y - 0.5 * g.h2, y + 0.5 * g.h2)
    yf = y - 0.5 * g.h2                       # horizontal faces
    half_x = np.sqrt(np.maximum(0.0, 1.0 - 4.0 * yf * yf))
    lb = _length_inside(half_x, x - 0.5 * g.h1, x + 0.5 * g.h1)
    return _blend(la, g.h2, g.eps), _blend(lb, g.h1, g.eps)


def rhs(g: Grid) -> np.ndarray:
    """B = f · 1[node ∈ D] on the interior, zero ring, fp64."""
    x, y = nodes(g)
    out = np.where(x * x + 4.0 * y * y < 1.0, g.f_val, 0.0)
    out[0, :] = out[-1, :] = 0.0
    out[:, 0] = out[:, -1] = 0.0
    return out
