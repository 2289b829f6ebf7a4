"""Problem configuration (counterpart of ``poisson_tpu/config.py``).

The port keeps its own copy so that it imports nothing of the JAX package;
the fields and derived quantities are identical, so a JAX ``Problem``'s
``dataclasses.asdict`` builds the same port ``Problem``
(``poisson_tpu_torch.interop.problem_from_reference``).

The reference bakes these in as compile-time constants and positional argv
(``stage2-mpi/poisson_mpi_decomp.cpp:9-11,470-481``); here they form one frozen
dataclass that every layer takes explicitly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class Problem:
    """2D Poisson problem on the box [x_min,x_max]×[y_min,y_max] with the
    elliptic domain x² + 4y² < 1 embedded by the fictitious-domain method.

    Grid: (M+1)×(N+1) nodes; unknowns live at interior nodes i=1..M-1,
    j=1..N-1 with homogeneous Dirichlet data on the box boundary
    (reference: ``stage0/Withoutopenmp1.cpp:106-119``).
    """

    M: int
    N: int
    x_min: float = -1.0
    x_max: float = 1.0
    y_min: float = -0.6
    y_max: float = 0.6
    f_val: float = 1.0
    delta: float = 1e-6
    max_iter: Optional[int] = None
    # Stage0 checks the unweighted Euclidean norm of w(k+1)-w(k)
    # (``stage0/Withoutopenmp1.cpp:154``); stages 1-4 weight by h1·h2
    # (``stage2-mpi/poisson_mpi_decomp.cpp:440``). Weighted is the default,
    # matching the distributed stages and the published iteration counts.
    weighted_norm: bool = True

    def __post_init__(self) -> None:
        if self.M < 2 or self.N < 2:
            raise ValueError(f"Grid must be at least 2x2, got M={self.M} N={self.N}")

    @property
    def h1(self) -> float:
        return (self.x_max - self.x_min) / self.M

    @property
    def h2(self) -> float:
        return (self.y_max - self.y_min) / self.N

    @property
    def eps(self) -> float:
        """Fictitious-domain penalty: ε = max(h1,h2)²
        (``stage0/Withoutopenmp1.cpp:108``)."""
        h = max(self.h1, self.h2)
        return h * h

    @property
    def iteration_cap(self) -> int:
        """Safety cap (M-1)(N-1), never hit in practice
        (``stage0/Withoutopenmp1.cpp:182``)."""
        if self.max_iter is not None:
            return self.max_iter
        return (self.M - 1) * (self.N - 1)

    @property
    def interior_shape(self) -> tuple[int, int]:
        return (self.M - 1, self.N - 1)

    @property
    def grid_shape(self) -> tuple[int, int]:
        return (self.M + 1, self.N + 1)

    @property
    def interior_points(self) -> int:
        return (self.M - 1) * (self.N - 1)

    def with_(self, **kw) -> "Problem":
        return dataclasses.replace(self, **kw)


FLAGSHIP = Problem(M=800, N=1200)
"""The headline benchmark configuration of the reference (BASELINE.md)."""
