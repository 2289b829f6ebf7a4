"""The comparison that decides ``correct`` fails what it must: the control
(the reference one precision below the configuration's, in the program's
place) and each fault a cell can have, planted in the program's timed path
underneath a whole run. The runs skip the look for a card and run on the
CPU at 40×60; the limits are the cells' own. A sound run passes.

A cell's faults are the plants of its entry (``faults/<function>.py``,
:mod:`cellbench.faults`): a step that returns its state unchanged and an
answer altered where it is produced, for every cell; a cell that spans
cards brings the exchange drill, the exchange between chips left out. No
cell batches, so "half of the batch left out" has no place here.
"""

import copy

import pytest

from cellbench import calibrate, faults, run, spec

SEED = 2 ** 31 + 29
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def entry_plants(workload) -> dict:
    try:
        return faults.plants(spec.load_cell(workload))
    except FileNotFoundError:       # the rule tests below name the file
        return {}


PLANTED = [(w, plant) for w in CELLS for plant in entry_plants(w)]


def small(workload):
    cell = spec.load_cell(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["grid"] = {"M": 40, "N": 60}
    return cell._replace(config=cfg)


def correct(cell, send=None) -> bool:
    result, _, win = run.run_cell(cell, SEED, 0.3, False, kind="cpu",
                                  send=send)
    assert win.kept
    return result["correct"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    assert correct(small(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    assert not correct(small(workload), calibrate.control(small(workload),
                                                           "cpu"))


@pytest.mark.parametrize("workload,plant", PLANTED)
def test_each_planted_fault_is_caught(workload, plant, monkeypatch):
    cell = small(workload)
    faults.plants(cell)[plant](monkeypatch)
    assert not correct(cell)


def lacking(cell, wanted) -> str:
    """What the cell's entry lacks of the plants ``wanted``, naming the
    file to add or to complete; empty where it has them all."""
    where = f"{spec.HERE.name}/faults/{faults.entry(cell)}.py"
    if not (cell.root / where).is_file():
        return f"{cell.name}: add {where} with PLANTS holding {wanted}"
    missing = [p for p in wanted if p not in faults.plants(cell)]
    return f"{cell.name}: {where} lacks {missing} in PLANTS" if missing \
        else ""


@pytest.mark.parametrize("workload", CELLS)
def test_every_entry_has_the_faults_its_cell_needs(workload):
    """Both plants for every cell, and the exchange drill for a cell over
    more than one card; the message names the file to add or complete."""
    cell = spec.load_cell(workload)
    wanted = faults.REQUIRED + ((faults.ACROSS_CARDS,) if cell.chips > 1
                                else ())
    problem = lacking(cell, wanted)
    assert not problem, problem
