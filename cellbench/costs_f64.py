"""The work one fp64 Jacobi-PCG iteration needs: the yardstick of
``roofline_share_f64``.

The count is of the recurrence, not of any kernel split: each iteration
reads the three operator fields of the unscaled system (a, b and the
Jacobi diagonal D) and the three state vectors (w, r, p), and writes the
three state vectors, each once, in fp64 over the grid's interior
(M−1)(N−1). That is 9 passes. A design that fuses, renames or drops
kernels leaves the count valid; one that holds state across iterations
(an s-step method) does not, and needs the count revised with the
benchmark. The card's peak is :mod:`cellbench.costs`'s table.
"""

from __future__ import annotations

from cellbench.costs import HBM_BYTES_PER_S, interior_points

FIELDS_READ = 3          # a, b, D
STATE_READ = 3           # w, r, p
STATE_WRITTEN = 3
PASSES = FIELDS_READ + STATE_READ + STATE_WRITTEN
FP64_BYTES = 8


def iteration_bytes(M: int, N: int) -> int:
    """Bytes one fp64 iteration must move with its state in device
    memory."""
    return PASSES * FP64_BYTES * interior_points(M, N)


def iteration_bound_us(M: int, N: int, device_kind: str) -> float | None:
    """The least µs the card could take for one iteration's bytes, or None
    for a card the table lacks."""
    peak = HBM_BYTES_PER_S.get(device_kind)
    if peak is None:
        return None
    return iteration_bytes(M, N) / peak * 1e6
