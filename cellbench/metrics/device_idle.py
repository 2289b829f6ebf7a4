"""device_idle (%; layer: device): the share of the traced slice in which
nothing ran on a card; on a mesh, the mean over the cards. The profiler
makes launches dearer, so this reads higher than in an untraced run."""

from __future__ import annotations

from cellbench.capture import mean_busy_us


def read(cap):
    busy = mean_busy_us(cap)
    if cap.window_us <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / cap.window_us)
