"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), their configurations and their metrics. Everything else a
cell needs sits in files of its own under this folder, found by name, so a
later cell is new files plus new entries and no edit:

  configs/<config>.json    the deployment (grid, domain, δ, precision)
  traffic/<traffic>.json   the mix's parameters (:mod:`cellbench.traffic`),
                           which name its loop and its inputs:
  loops/<loop>.py          how solves are sent in the window
  inputs/<input>.py        the seeded inputs and how the entry takes them
  limits/<workload>.json   each compared number's limit (:mod:`cellbench.judge`)
  end_to_end/<metric>.py   an end-to-end metric's reader, ``read(window)``
  metrics/<metric>.py      a per-layer metric's reader, ``read(capture)``
  faults/<function>.py     the fault drills of the entry a mix calls (tests)
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    """One workload of ``BENCHMARK.json`` with its files read."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple      # metric entries of BENCHMARK.json that it reports
    per_layer: tuple
    root: Path = ROOT      # the checkout its files were read from


def benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` of the checkout at ``root``."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def config_file(name: str, bench: dict, root: Path = ROOT) -> Path:
    for c in bench["configs"]:
        if c["name"] == name:
            return root / c["file"]
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic_file(name: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "traffic" / f"{name}.json"


def limits_file(workload: str, root: Path = ROOT) -> Path:
    return root / HERE.name / "limits" / f"{workload}.json"


def reports(metric: dict, workload: str) -> bool:
    """Whether ``workload`` reports ``metric`` (every cell, without a
    ``workloads`` list)."""
    return workload in metric.get("workloads", (workload,))


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    return Cell(
        name=workload,
        chips=int(w["chips"]),
        config=_json(config_file(w["config"], bench, root)),
        traffic=_json(traffic_file(w["traffic"], root)),
        limits=_json(limits_file(workload, root)),
        end_to_end=tuple(m for m in bench["end_to_end"]
                         if reports(m, workload)),
        per_layer=tuple(m for m in bench["per_layer"]
                        if reports(m, workload)),
        root=root,
    )


def module(folder: str, name: str, root: Path = ROOT):
    """``<folder>/<name>.py`` of the harness, loaded by path: a name may
    hold ``.`` or ``-``."""
    path = root / HERE.name / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"cellbench.{folder}.{name.replace('.', '_').replace('-', '_')}",
        path)
    loaded = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(loaded)
    return loaded


def reader(metric: str, folder: str = "metrics"):
    """The ``read`` function of ``<folder>/<metric>.py``: a per-layer
    metric's (``metrics``, reads a capture) or an end-to-end metric's
    (``end_to_end``, reads the window)."""
    return module(folder, metric).read
