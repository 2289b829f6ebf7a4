"""The comparison that decides ``correct`` fails what it must: the control
(the reference one precision below the configuration's, in the program's
place) and each fault a cell can have, planted in the program's timed path
underneath a whole run. The runs skip the look for a card and run on the
CPU at 40×60; the limits are the cells' own. A sound run passes.

A cell's faults: a step that returns its state unchanged; an answer
altered where it is produced. No cell batches and none spans cards, so
"half of the batch left out" and "the exchange between chips left out"
have no place here.
"""

import copy

import numpy as np
import pytest

from cellbench import calibrate, run, spec

SEED = 2 ** 31 + 29
CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


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


def frozen_body(*args, **kwargs):
    return lambda s: s


def altered(w):
    w = w.clone() if hasattr(w, "clone") else np.array(w)
    w[20, 30] *= 1.05
    return w


@pytest.fixture
def produced_altered(monkeypatch):
    """Every entry's answer altered where the program produces it."""
    from poisson_tpu_torch.ops import fused_cg, resident

    to_host, solve = fused_cg.canvas_to_w64, resident.resident_solve
    monkeypatch.setattr(fused_cg, "canvas_to_w64",
                        lambda *a, **k: altered(to_host(*a, **k)))

    def resident_altered(*args, **kwargs):
        w, *rest = solve(*args, **kwargs)
        w = w.clone()
        w[resident.HALO + 20, 30] *= 1.05
        return (w, *rest)

    monkeypatch.setattr(resident, "resident_solve", resident_altered)


@pytest.fixture
def steps_frozen(monkeypatch):
    """Every iteration body returns its state unchanged."""
    from poisson_tpu_torch.ops import fused_cg

    monkeypatch.setattr(fused_cg, "_make_fused_body", frozen_body)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(workload):
    assert correct(small(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    assert not correct(small(workload), calibrate.control(small(workload),
                                                           "cpu"))


@pytest.mark.parametrize("workload", CELLS)
def test_a_step_returning_its_state_unchanged_is_caught(workload,
                                                        steps_frozen):
    assert not correct(small(workload))


@pytest.mark.parametrize("workload", CELLS)
def test_an_answer_altered_where_produced_is_caught(workload,
                                                    produced_altered):
    assert not correct(small(workload))
