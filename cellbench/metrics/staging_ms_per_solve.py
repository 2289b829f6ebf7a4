"""staging_ms_per_solve (ms; layer: solver entry): host ms inside the
program's ``stage.rhs_in`` and ``stage.w_out`` ranges (the right-hand side
scaled in fp64, put on a canvas and copied up; the solution copied down
and scaled in fp64), clipped to the traced slice, over the solves in it
(the harness's own annotations). Nothing where no such range falls in the
slice: a program without the ranges, or a cell whose right-hand side stays
on the card."""

from __future__ import annotations

from cellbench.capture import ANNOTATION

RANGES = ("stage.rhs_in", "stage.w_out")


def _inside_us(cap, names):
    """µs of the host ranges named ``names`` inside the slice, or None
    where none overlaps it."""
    parts = [min(e.end_us, cap.end_us) - max(e.start_us, cap.start_us)
             for e in cap.events if e.kind == "host" and e.name in names]
    parts = [p for p in parts if p > 0]
    return sum(parts) if parts else None


def read(cap):
    us = _inside_us(cap, RANGES)
    solves = sum(1 for e in cap.events
                 if e.kind == "host" and e.name == ANNOTATION)
    if us is None or solves == 0:
        return None
    return us / 1e3 / solves
