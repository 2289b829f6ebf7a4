"""iters_per_solve (iterations; layer: solver entry): the mean count the
window's solves returned."""

from __future__ import annotations


def read(cap):
    counts = cap.solve_iterations
    if not counts:
        return None
    return sum(counts) / len(counts)
