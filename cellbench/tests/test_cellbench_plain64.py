"""The fp64 cell ``ellipse-2400x3200-fp64.plain``: the reference's own
precision, fp64 Jacobi-PCG on the unscaled system through the port's plain
``solvers.pcg.pcg_solve``. It is new files and new entries only; its cost
count and its two readers; a traced CPU run at 40×60 reads the program's
``stage.fields_in`` range; and its limits pass the fp64 program while an
fp32 solve in its place fails them."""

import copy
import json
import shutil

import pytest
import torch

from cellbench import costs_f64, program, run, spec
from cellbench.capture import ANNOTATION, Capture, Event
from cellbench.reference.pcg import Operator, solve

ROOT = spec.ROOT
CELL = "ellipse-2400x3200-fp64.plain"
CONFIG = "ellipse-2400x3200-fp64"
FILES = ("configs/ellipse-2400x3200-fp64.json", "traffic/plain-gate.json",
         f"limits/{CELL}.json", "faults/pcg_solve.py", "costs_f64.py",
         "metrics/fields_in_ms_per_solve.py",
         "metrics/roofline_share_f64.py")
READERS = ("fields_in_ms_per_solve", "roofline_share_f64")
LISTED = ("solves_per_s", "iters_per_solve", "launches_per_iter",
          "device_us_per_iter", "device_idle", "enqueue_us_per_iter",
          "check_us_per_iter")
SEED = 2 ** 31 + 53


def add_plain64_cell(root, source=ROOT) -> None:
    """Add the fp64 cell to the checkout at ``root``, from the checkout at
    ``source``: the files it lacks, and the entries its ``BENCHMARK.json``
    lacks. Where the cell is there already, nothing is added."""
    for name in FILES:
        dest = root / "cellbench" / name
        if not dest.exists():
            shutil.copy(source / "cellbench" / name, dest)
    bench, ours = spec.benchmark(root), spec.benchmark(source)
    if any(w["name"] == CELL for w in bench["workloads"]):
        return
    pick = lambda group, name: next(x for x in ours[group]
                                    if x["name"] == name)
    if all(c["name"] != CONFIG for c in bench["configs"]):
        bench["configs"].append(pick("configs", CONFIG))
    bench["workloads"].append(pick("workloads", CELL))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] in LISTED:
            m["workloads"].append(CELL)
    bench["per_layer"] += [pick("per_layer", name) for name in READERS]
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")


def without_the_cell(root) -> None:
    """A copy of this checkout's harness at ``root`` as it was before the
    cell: its files and entries taken out."""
    shutil.copytree(ROOT / "cellbench", root / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in FILES:
        (root / "cellbench" / name).unlink()
    bench = spec.benchmark()
    bench["configs"] = [c for c in bench["configs"] if c["name"] != CONFIG]
    bench["workloads"] = [w for w in bench["workloads"] if w["name"] != CELL]
    bench["per_layer"] = [m for m in bench["per_layer"]
                          if m["name"] not in READERS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", ()):
            m["workloads"].remove(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1) + "\n")


def small(cell, M=40, N=60):
    cfg = copy.deepcopy(cell.config)
    cfg["grid"] = {"M": M, "N": N}
    return cell._replace(config=cfg)


def test_the_cell_is_new_files_and_entries_only(tmp_path):
    without_the_cell(tmp_path)
    with pytest.raises(KeyError):
        spec.load_cell(CELL, root=tmp_path)
    files = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    add_plain64_cell(tmp_path)
    changed = [p for p, data in files.items() if p.read_bytes() != data]
    assert changed == [tmp_path / "BENCHMARK.json"]
    assert spec.benchmark(tmp_path) == spec.benchmark()
    for name in FILES:
        assert ((tmp_path / "cellbench" / name).read_bytes()
                == (ROOT / "cellbench" / name).read_bytes())
    add_plain64_cell(tmp_path)            # once there, nothing is added
    assert spec.benchmark(tmp_path) == spec.benchmark()


def test_the_cell_loads_as_the_reference_deployment():
    cell = spec.load_cell(CELL)
    assert cell.chips == 1
    cfg = cell.config
    assert (cfg["precision"], cfg["system"]) == ("float64", "unscaled")
    assert cfg["grid"] == {"M": 2400, "N": 3200}
    assert cfg["published"]["iterations"] == 2449
    assert cell.traffic["call"] == "poisson_tpu_torch.solvers.pcg:pcg_solve"
    assert {m["name"] for m in cell.end_to_end} == {"solves_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == set(LISTED[1:] + READERS)
    bench = spec.benchmark()
    (conf,) = [c for c in bench["configs"] if c["name"] == CONFIG]
    assert conf["reduced"] == []
    for name in READERS:
        (m,) = [m for m in bench["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "solves_per_s"


def test_the_fp64_count_is_nine_passes_over_the_interior():
    assert costs_f64.iteration_bytes(2400, 3200) == 552_556_872
    bound = costs_f64.iteration_bound_us(2400, 3200, "NVIDIA H100 80GB HBM3")
    assert bound == pytest.approx(164.9424, rel=1e-5)
    assert costs_f64.iteration_bound_us(2400, 3200, "another card") is None


def canned():
    """Two solves over a 0–1000 µs slice on one card, 8 iterations. The
    first solve's ``stage.fields_in`` starts before the slice, the
    second's ends after it; one lies wholly outside."""
    host = [(ANNOTATION, 0, 480), (ANNOTATION, 500, 1000),
            ("stage.fields_in", -20, 30), ("pcg.drive.enqueue", 40, 470),
            ("stage.fields_in", 960, 1040), ("stage.fields_in", 2000, 2100)]
    ev = [Event(n, "host", -1, float(s), float(t - s)) for n, s, t in host]
    ev += [Event("Memcpy HtoD (Pageable -> Device)", "memcpy", 0, 0.0, 30.0),
           Event("elementwise_kernel", "kernel", 0, 100.0, 300.0),
           Event("reduce_kernel", "kernel", 0, 600.0, 200.0)]
    return Capture(events=tuple(ev), start_us=0.0, end_us=1000.0,
                   cards=(0,), iterations=8, solve_iterations=(4, 4),
                   config={"grid": {"M": 2400, "N": 3200}},
                   device_kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("metric,value", [
    # 30 (clipped at the start) + 40 (clipped at the end) µs, two solves
    ("fields_in_ms_per_solve", (30 + 40) / 1e3 / 2),
    # 530 µs busy over 8 iterations
    ("roofline_share_f64", 100.0 * 164.9424 / (530 / 8)),
])
def test_reader_on_a_canned_capture(metric, value):
    assert spec.reader(metric)(canned()) == pytest.approx(value, rel=1e-5)


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    cap = canned()
    bare = cap._replace(events=tuple(
        e for e in cap.events
        if e.kind == "host" and e.name != "stage.fields_in"))
    assert spec.reader(metric)(bare) is None
    # ranges and device work that all lie outside the slice read as none
    late = cap._replace(start_us=5000.0, end_us=6000.0)
    assert spec.reader(metric)(late) is None


def test_a_traced_cpu_run_reads_the_programs_range():
    result, _, win = run.run_cell(small(spec.load_cell(CELL)), SEED, 0.3,
                                  True, kind="cpu")
    assert result["correct"] is True and win.profiled >= 1
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["fields_in_ms_per_solve"] > 0
    assert got["iters_per_solve"] > 0
    # no card: the device readers find nothing
    assert "roofline_share_f64" not in got


def fp32_entry(inputs):
    cell = small(spec.load_cell(CELL))
    entry = program.entry(cell.traffic)
    return inputs.bind(lambda *a, **k: entry(*a, dtype="float32", **k),
                       program.problem(cell.config), ["cpu"])


def fp32_reference(inputs):
    op = Operator(inputs.grid, "cpu", torch.float32)
    return lambda inp: solve(op, inputs.reference_rhs(inp), 3 * 2449)


def checks(send=None, seed=SEED):
    # a window long enough for the 3 judged solves on a loaded CPU
    result, _, win = run.run_cell(small(spec.load_cell(CELL)), seed, 1.0,
                                  False, kind="cpu", send=send)
    assert len(win.kept) == 3
    return result


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_the_fp64_program_is_within_the_limits(seed):
    result = checks(seed=seed)
    assert result["correct"] is True
    limits = spec.load_cell(CELL).limits
    assert result["checks"]["w_err"]["value"] <= limits["w_err"] / 10


@pytest.mark.parametrize("control", [fp32_entry, fp32_reference])
def test_an_fp32_solve_in_the_programs_place_is_not_correct(control):
    result = checks(control)
    assert result["correct"] is False
    w = result["checks"]["w_err"]
    assert w["value"] > w["limit"]
