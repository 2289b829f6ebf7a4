"""roofline_share (%; layer: kernels): the least time the card needs for
one iteration's bytes (:mod:`cellbench.costs`) over the device µs an
iteration took. Read only where the working set is far beyond L2; at a
grid whose canvases stay in L2 the HBM bound is no bound."""

from __future__ import annotations

from cellbench.capture import mean_busy_us
from cellbench.costs import iteration_bound_us


def read(cap):
    grid = cap.config["grid"]
    bound = iteration_bound_us(grid["M"], grid["N"], cap.device_kind)
    busy = mean_busy_us(cap)
    if bound is None or cap.iterations <= 0 or busy <= 0:
        return None
    return 100.0 * bound / (busy / cap.iterations)
