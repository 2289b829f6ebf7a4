"""roofline_share_f64 (%; layer: kernels): the least time the card needs
for one fp64 Jacobi-PCG iteration's bytes (:mod:`cellbench.costs_f64`)
over the device µs an iteration took. Read only in the fp64 cell, whose
fields are far beyond L2."""

from __future__ import annotations

from cellbench.capture import mean_busy_us
from cellbench.costs_f64 import iteration_bound_us


def read(cap):
    grid = cap.config["grid"]
    bound = iteration_bound_us(grid["M"], grid["N"], cap.device_kind)
    busy = mean_busy_us(cap)
    if bound is None or cap.iterations <= 0 or busy <= 0:
        return None
    return 100.0 * bound / (busy / cap.iterations)
