"""device_us_per_iter (us; layer: kernels): µs in which a kernel, copy or
fill ran on a card, over the iterations of the traced slice; on a mesh,
the mean over the cards."""

from __future__ import annotations

from cellbench.capture import mean_busy_us


def read(cap):
    busy = mean_busy_us(cap)
    if cap.iterations <= 0 or busy <= 0:
        return None
    return busy / cap.iterations
