"""Fault drills, one file for each program entry, found by the function a
cell's mix calls (the name after the ``:`` of its ``call``), as every other
part of a cell is found by name (:mod:`cellbench.spec`):

  faults/<function>.py   PLANTS: plant name → ``plant(monkeypatch)``, which
                         plants one fault where <function> produces it

Every entry has ``frozen_step`` (each iteration body returns its state
unchanged) and ``altered_answer`` (the answer scaled by 1.05 at one point
where it is produced); a cell that spans cards brings the exchange drill,
``exchange_skipped`` (the exchange between chips left out). The tests
(``tests/test_cellbench_faults.py``) run each cell on the CPU under each
plant of its entry and see ``correct`` come out false; no run of the
benchmark loads these files.
"""

from __future__ import annotations

from cellbench import spec

REQUIRED = ("frozen_step", "altered_answer")
ACROSS_CARDS = "exchange_skipped"


def entry(cell: spec.Cell) -> str:
    """The function the cell's mix calls: its faults file's name."""
    return cell.traffic["call"].rpartition(":")[2]


def plants(cell: spec.Cell) -> dict:
    """The plants of the cell's entry, from the checkout it was read from."""
    return spec.module("faults", entry(cell), cell.root).PLANTS

