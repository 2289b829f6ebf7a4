"""fields_in_ms_per_solve (ms; layer: solver entry): host ms inside the
program's ``stage.fields_in`` ranges (``solvers.pcg.solve_fields``
copying a, b, the right-hand side and the diagonal up from the host's
fp64 cache, every plain solve), clipped to the traced slice, over the
solves in it (the harness's own annotations), as ``staging_ms_per_solve``
reads its ranges. Nothing where no such range falls in the slice: a
program without the range, or a cell whose entry does not call the plain
setup."""

from __future__ import annotations

from cellbench.capture import ANNOTATION
from cellbench.metrics.staging_ms_per_solve import _inside_us

RANGE = "stage.fields_in"


def read(cap):
    us = _inside_us(cap, (RANGE,))
    solves = sum(1 for e in cap.events
                 if e.kind == "host" and e.name == ANNOTATION)
    if us is None or solves == 0:
        return None
    return us / 1e3 / solves
