"""Nothing the benchmark runs imports JAX or the JAX package: the harness,
every metric reader, every loop, input and traffic file, the program's
entries and every fault drill (each ``faults/*.py``, each plant planted
and taken out again) are loaded in a fresh interpreter that refuses those
imports, and no loaded module's top-level name is one of them (names
compared whole: ``poisson_tpu_torch`` is the program, ``poisson_tpu`` is
not)."""

import subprocess
import sys

from cellbench import spec

SCRIPT = r'''
import importlib.abc, sys
BLOCKED = {"jax", "jaxlib", "flax", "poisson_tpu"}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"refused import of {name}")
        return None

sys.meta_path.insert(0, Refuse())
import cellbench, cellbench.run, cellbench.calibrate
from cellbench import program, spec, traffic
from cellbench.reference.fields import grid_from_config
bench = spec.benchmark()
for m in bench["per_layer"]:
    spec.reader(m["name"], "metrics")
for m in bench["end_to_end"]:
    spec.reader(m["name"], "end_to_end")
for folder in ("loops", "inputs"):
    for path in (spec.HERE / folder).glob("*.py"):
        spec.module(folder, path.stem)
import pytest
for path in (spec.HERE / "faults").glob("*.py"):
    for plant in getattr(spec.module("faults", path.stem), "PLANTS",
                         {}).values():
        with pytest.MonkeyPatch.context() as monkeypatch:
            plant(monkeypatch)
for w in bench["workloads"]:
    cell = spec.load_cell(w["name"])
    cfg = dict(cell.config, grid={"M": 16, "N": 16})
    inputs = traffic.inputs(cell.traffic, grid_from_config(cfg), 1)
    inputs.bind(program.entry(cell.traffic), program.problem(cfg), ["cpu"])
    traffic.loop(cell.traffic)
found = cellbench.run.forbidden_modules()
assert not found, found
assert "poisson_tpu_torch" in sys.modules
print("isolated")
'''


def test_nothing_loads_jax_or_the_jax_package():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("isolated")


def test_the_reference_imports_nothing_of_the_program():
    for path in (spec.HERE / "reference").glob("*.py"):
        text = path.read_text()
        assert "poisson_tpu" not in text.replace("poisson_tpu_torch", "") \
            and "import poisson_tpu_torch" not in text \
            and "from poisson_tpu_torch" not in text, path
