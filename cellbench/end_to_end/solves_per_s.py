"""solves_per_s (solves/s): solves completed over the time from the
window's start to the end of its last solve. The window runs whole
solves: the last starts before the window's length has passed and runs to
its end, so the rate has no quantisation step and still shows a stall in
that last solve."""

from __future__ import annotations


def read(run):
    done = len(run.latencies) - run.failed
    span = run.t_end - run.t_start
    if done <= 0 or span <= 0:
        return None
    return done / span
