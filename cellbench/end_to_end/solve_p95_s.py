"""solve_p95_s (s): the 95th percentile (nearest rank), over every solve of
the window, of the time from when the solve was due (in a closed loop,
when it was sent) to its answer on the host. A failed solve counts as
infinitely late."""

from __future__ import annotations

import math


def read(run):
    lat = sorted(run.latencies)
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
