"""The work one CG iteration needs, and the card's peak: the yardstick of
``roofline_share``.

The count is of the recurrence, not of any kernel split: each iteration
reads the four operator fields (cS, cW, γ, sc²) and the three state
vectors (w, r, p), and writes the three state vectors, each once, in fp32
over the grid's interior (M−1)(N−1). That is 10 passes. A design that
fuses, renames or drops kernels leaves the count valid; one that holds
state across iterations (an s-step method) does not, and needs the count
revised with the benchmark.
"""

from __future__ import annotations

FIELDS_READ = 4          # cS, cW, γ, sc²
STATE_READ = 3           # w, r, p
STATE_WRITTEN = 3
PASSES = FIELDS_READ + STATE_READ + STATE_WRITTEN
FP32_BYTES = 4

# Device memory bandwidth by torch.cuda.get_device_name(), bytes/s
# (NVIDIA's data sheets; SXM parts at their full power limit).
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def interior_points(M: int, N: int) -> int:
    return (M - 1) * (N - 1)


def iteration_bytes(M: int, N: int) -> int:
    """Bytes one iteration must move with its state in device memory."""
    return PASSES * FP32_BYTES * interior_points(M, N)


def iteration_bound_us(M: int, N: int, device_kind: str) -> float | None:
    """The least µs the card could take for one iteration's bytes, or None
    for a card the table lacks."""
    peak = HBM_BYTES_PER_S.get(device_kind)
    if peak is None:
        return None
    return iteration_bytes(M, N) / peak * 1e6
