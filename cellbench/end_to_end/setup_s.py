"""setup_s (s): from the process's start to the window's: imports, the
card, the kernels' build or load, the seeded inputs, the program's
set-up and one warm solve."""

from __future__ import annotations


def read(run):
    return run.setup_s
