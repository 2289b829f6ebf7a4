"""The harness on the CPU: names resolve, the contract's shapes hold, the
readers read a canned capture, and one run's result line has the
contract's keys. ``test_one_short_run_on_the_card`` needs a card."""

import copy
import json
import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from cellbench import (calibrate, capture, costs, faults, run, spec,
                       traffic)
from cellbench.capture import Capture, Event
from cellbench.traffic import Sample
from cellbench.reference.fields import Grid

ROOT = spec.ROOT
BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def small(cell, M=40, N=60):
    cfg = copy.deepcopy(cell.config)
    cfg["grid"] = {"M": M, "N": N}
    return cell._replace(config=cfg)


# --- names and files --------------------------------------------------------


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_cell_resolves_by_name(workload):
    cell = spec.load_cell(workload)
    assert cell.name == workload
    assert cell.config["chips"] == cell.chips
    assert set(cell.limits) >= {"w_err", "k_gap"}
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_each_per_layer_reader_resolves(metric):
    assert callable(spec.reader(metric, "metrics"))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["end_to_end"]])
def test_each_end_to_end_reader_resolves(metric):
    assert callable(spec.reader(metric, "end_to_end"))


@pytest.mark.parametrize("config", BENCH["configs"])
def test_each_config_file_is_its_deployment(config):
    cfg = json.loads((ROOT / config["file"]).read_text())
    assert cfg["name"] == config["name"]
    assert cfg["precision"] == "float32" and cfg["assumed"]
    assert config["file"].startswith(BENCH["paths"][0] + "/")


def test_an_added_config_is_picked_up_without_an_edit(tmp_path):
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = copy.deepcopy(BENCH)
    cfg = json.loads((ROOT / bench["configs"][0]["file"]).read_text())
    cfg.update(name="ellipse-400x600", grid={"M": 400, "N": 600})
    (tmp_path / "cellbench/configs/ellipse-400x600.json").write_text(
        json.dumps(cfg))
    (tmp_path / "cellbench/limits/ellipse-400x600.fused.json").write_text(
        json.dumps({"w_err": 1e-4, "k_gap": 3}))
    bench["configs"].append(dict(bench["configs"][0], name="ellipse-400x600",
                                 file="cellbench/configs/ellipse-400x600.json"))
    bench["workloads"].append(dict(bench["workloads"][0],
                                   name="ellipse-400x600.fused",
                                   config="ellipse-400x600"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("ellipse-400x600.fused", root=tmp_path)
    assert cell.config["grid"] == {"M": 400, "N": 600}
    assert cell.traffic == spec.load_cell(WORKLOADS[0]).traffic


@pytest.mark.parametrize("workload", WORKLOADS)
def test_each_mix_names_a_loop_and_inputs_that_resolve(workload):
    mix = spec.load_cell(workload).traffic
    loop = traffic.loop(mix)
    assert callable(loop.warm) and callable(loop.run)
    inputs = traffic.inputs(mix, Grid(40, 60), 3)
    assert inputs.input(0).index == 0 and callable(inputs.bind)


def test_an_added_loop_and_input_kind_are_picked_up_without_an_edit(
        tmp_path):
    """A mix of a new kind is new files: its loop and inputs modules, its
    traffic file and the cell's entries."""
    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    here = tmp_path / "cellbench"
    (here / "loops/twice.py").write_text(
        "from cellbench.traffic import Window\n"
        "def warm(send, inputs):\n    send(inputs.input(0))\n"
        "def run(send, inputs, seconds, sample, cards, trace, setup_s):\n"
        "    got = [send(inputs.input(i)) for i in range(2)]\n"
        "    for i, (w, k) in enumerate(got):\n"
        "        sample.offer(i, (inputs.input(i), w, k))\n"
        "    return Window(setup_s, 0.0, 1.0, (0.5, 0.5),\n"
        "                  tuple(k for _, k in got), 0, '',\n"
        "                  tuple(sample.kept), 0, ())\n")
    (here / "inputs/doubled.py").write_text(
        (here / "inputs/gate.py").read_text().replace(
            "rhs_gate=inp.gate", "rhs_gate=2 * inp.gate").replace(
            "self.base * inp.gate", "self.base * 2 * inp.gate"))
    mix = dict(spec.load_cell("ellipse-800x1200.resident").traffic,
               loop="twice", input="doubled")
    (here / "traffic/doubled-gate.json").write_text(json.dumps(mix))
    (here / "limits/ellipse-800x1200.doubled.json").write_text(
        (ROOT / "cellbench/limits/ellipse-800x1200.resident.json")
        .read_text())
    bench = copy.deepcopy(BENCH)
    bench["workloads"].append(dict(name="ellipse-800x1200.doubled",
                                   config="ellipse-800x1200",
                                   traffic="doubled-gate", chips=1, why="x"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = small(spec.load_cell("ellipse-800x1200.doubled", root=tmp_path))
    result, _, win = run.run_cell(cell, 5, 0.1, False, kind="cpu")
    assert result["correct"] is True and result["attempted"] == 2
    assert win.kept[0][0].gate * 2 > 1.7

# The four-card mesh cell as a later change would add it: new files and new
# entries only. Kernels A and B sharded over the 2×2 mesh that
# ``choose_process_grid(4)`` gives, r's halos copied between cards.
MESH = "ellipse-2400x3200-mesh2x2.fused"
MESH_FILES = {
    "traffic/mesh-gate.json": json.dumps({
        "loop": "closed", "input": "mesh_gate",
        "call": "poisson_tpu_torch.parallel.fused_sharded"
                ":fused_cg_solve_sharded",
        "gates": [0.9, 1.1], "judged": 3}, indent=1),
    f"limits/{MESH}.json": json.dumps({"w_err": 3e-3, "k_gap": 5}),
    "inputs/mesh_gate.py": '''"""mesh_gate: the gates of ``inputs/gate.py``
(one scalar gate a solve, uniform in ``gates``, from the seed), sent to a
sharded entry over a mesh of the run's devices shaped by the port's own
rule (``make_solver_mesh``: 2x2 over four),
``fn(problem, mesh, rhs_gate=g)``."""

from cellbench import program, spec


class Inputs(spec.module("inputs", "gate").Inputs):
    def bind(self, fn, problem, devices):
        from poisson_tpu_torch.parallel.mesh import make_solver_mesh

        mesh = make_solver_mesh(devices)

        def send(inp):
            return program.answer(fn(problem, mesh, rhs_gate=inp.gate))

        return send
''',
    "faults/fused_cg_solve_sharded.py": '''"""Faults of
``poisson_tpu_torch.parallel.fused_sharded:fused_cg_solve_sharded``: the
sharded body (kernels A and B on every shard) driven by
``solvers.pcg.drive``, r's halo ring copied between shards each
iteration, the answer gathered from the shards' owned points."""


def frozen_step(monkeypatch):
    """Every iteration body returns its state unchanged."""
    from poisson_tpu_torch.parallel import fused_sharded

    monkeypatch.setattr(fused_sharded, "_make_sharded_body",
                        lambda *args, **kwargs: lambda s: s)


def altered_answer(monkeypatch):
    """The gathered answer scaled by 1.05 at one point."""
    from poisson_tpu_torch.parallel import fused_sharded

    gather = fused_sharded.gather_owned

    def altered(*args, **kwargs):
        w = gather(*args, **kwargs).clone()
        w[20, 30] *= 1.05
        return w

    monkeypatch.setattr(fused_sharded, "gather_owned", altered)


def exchange_skipped(monkeypatch):
    """The exchange between chips left out: r's halo ring never copied."""
    from poisson_tpu_torch.parallel import fused_sharded

    monkeypatch.setattr(fused_sharded, "exchange_r_halo",
                        lambda *args, **kwargs: None)


PLANTS = {"frozen_step": frozen_step, "altered_answer": altered_answer,
          "exchange_skipped": exchange_skipped}
''',
}
MESH_METRICS = ("solves_per_s", "iters_per_solve", "launches_per_iter",
                "device_us_per_iter", "device_idle", "enqueue_us_per_iter",
                "check_us_per_iter")


def add_mesh_cell(root: Path) -> None:
    """Add the mesh cell to the checkout at ``root``: the files it lacks,
    and the entries its ``BENCHMARK.json`` lacks. Once the cell is
    committed there is nothing to add, and what the checkout holds runs."""
    here = root / "cellbench"
    for name, text in MESH_FILES.items():
        if not (here / name).exists():
            (here / name).write_text(text)
    path = here / "configs/ellipse-2400x3200-mesh2x2.json"
    if not path.exists():
        cfg = json.loads(
            (here / "configs/ellipse-2400x3200.json").read_text())
        cfg.update(name="ellipse-2400x3200-mesh2x2", source=cfg[
            "source"].replace("1 GPU 2400x3200 (2449 iterations, 13.24 s)",
                              "2 GPU 2400x3200 (2449 iterations, 7.67 s)"),
                   deployment="the largest published grid on a 2x2 mesh "
                              "of four cards",
                   chips=4, mesh={"px": 2, "py": 2},
                   published=dict(cfg["published"], seconds=7.67,
                                  hardware="MPI+CUDA, 2 GPU"))
        cfg["assumed"] = cfg["assumed"] + [
            "the 2x2 process grid of choose_process_grid(4), the "
            "reference's own rule (stage2-mpi/poisson_mpi_decomp.cpp:60-64),"
            " on four cards"]
        path.write_text(json.dumps(cfg, indent=1))
    bench = spec.benchmark(root)
    if all(w["name"] != MESH for w in bench["workloads"]):
        cfg = json.loads(path.read_text())
        if all(c["name"] != cfg["name"] for c in bench["configs"]):
            bench["configs"].append(dict(
                name=cfg["name"], source=cfg["source"],
                file="cellbench/configs/ellipse-2400x3200-mesh2x2.json",
                reduced=[],
                why="the largest published grid sharded 2x2 over four "
                    "cards: the same ellipse, delta and precision, halos "
                    "copied between cards"))
        bench["workloads"].append(dict(
            name=MESH, config=cfg["name"], traffic="mesh-gate", chips=4,
            why="2400x3200 on a 2x2 mesh of four cards, closed loop of one "
                "caller, gates on the card: sharded A and B, halo copies "
                "between cards, mesh sums"))
        for m in bench["end_to_end"] + bench["per_layer"]:
            if m["name"] in MESH_METRICS:
                m["workloads"].append(MESH)
        (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


def test_a_cell_over_four_cards_is_new_files_only(tmp_path):
    """A cell on a new entry over four cards is new files: its
    configuration, mix, inputs, limits and faults. At 40×60 on four CPU
    shards its sound run is correct, and its control and each of its
    plants are not, each with a compared number above its limit. Once the
    cell is committed nothing is added, and the committed cell is run."""
    from poisson_tpu_torch.parallel.mesh import make_solver_mesh

    shutil.copytree(ROOT / "cellbench", tmp_path / "cellbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    files = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    add_mesh_cell(tmp_path)
    changed = [p for p, data in files.items() if p.read_bytes() != data]
    assert set(changed) <= {tmp_path / "BENCHMARK.json"}

    cell = small(spec.load_cell(MESH, root=tmp_path))
    mesh = make_solver_mesh(run.devices(cell, "cpu"))
    assert cell.chips == 4 and (mesh.px, mesh.py) == (2, 2)
    plants = faults.plants(cell)
    assert {"frozen_step", "altered_answer", "exchange_skipped"} <= set(
        plants)

    def result(send=None):
        out, _, win = run.run_cell(cell, 2 ** 31 + 41, 0.3, False,
                                   kind="cpu", send=send)
        assert win.kept and out["device"]["count"] == 4
        return out

    def over(out):
        return [n for n, c in out["checks"].items()
                if c["value"] is not None and c["value"] > c["limit"]]

    assert result()["correct"] is True
    control = result(calibrate.control(cell, "cpu"))
    assert control["correct"] is False and over(control)
    for name, plant in plants.items():
        with pytest.MonkeyPatch.context() as monkeypatch:
            plant(monkeypatch)
            out = result()
        assert out["correct"] is False and over(out), (name, out["checks"])


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    with pytest.raises(FileNotFoundError):
        spec.reader("no_such_metric")


# --- the contract's shapes --------------------------------------------------


def test_benchmark_has_exactly_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"][:3] == ["python3", "-m", "cellbench"]
    assert 1 <= len(BENCH["paths"]) <= 16
    assert all(not p.startswith("/") and ".." not in p
               for p in BENCH["paths"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters():
    names = [c["name"] for c in BENCH["configs"]]
    for w in BENCH["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for c in BENCH["configs"]:
        names += c["reduced"]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({g["name"] for g in group}) == len(group)


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= set(WORKLOADS)
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_roofline_share_is_asked_only_beyond_l2():
    roof = [m for m in BENCH["per_layer"] if m["name"] == "roofline_share"]
    assert all(m["workloads"] == ["ellipse-2400x3200.fused"] for m in roof)


def test_costs_count_ten_fp32_passes_over_the_interior():
    assert costs.iteration_bytes(2400, 3200) == 306_976_040
    bound = costs.iteration_bound_us(2400, 3200, "NVIDIA H100 80GB HBM3")
    assert bound == pytest.approx(91.6346, rel=1e-5)
    assert costs.iteration_bound_us(2400, 3200, "some other card") is None


def test_nothing_is_added_under_the_repos_tests():
    mine = {p.name for p in Path(__file__).parent.glob("*.py")}
    theirs = {p.name for p in (ROOT / "tests").glob("*.py")}
    assert not mine & theirs
    assert all("cellbench" not in p.read_text()
               for p in (ROOT / "tests").glob("*.py"))


# --- traffic ----------------------------------------------------------------


def test_traffic_is_made_from_the_seed():
    cell = spec.load_cell("ellipse-800x1200.fused")
    g = Grid(40, 60)
    a = traffic.inputs(cell.traffic, g, 2 ** 31 + 5)
    b = traffic.inputs(cell.traffic, g, 2 ** 31 + 5)
    c = traffic.inputs(cell.traffic, g, 2 ** 31 + 6)
    assert all((x == y).all() for x, y in zip(a.pool, b.pool))
    assert not (a.pool[0] == c.pool[0]).all()
    assert len({a.input(i).key for i in range(20)}) == cell.traffic["pool"]
    phi = a.pool[1][a.base > 0] - 1.0
    assert abs(phi).max() <= cell.traffic["amplitude"] + 1e-12
    # no mirror symmetry: a flipped grid is another input
    assert not abs(a.pool[0] - a.pool[0][::-1, :]).max() < 1e-3


def test_gates_are_drawn_per_solve_in_range():
    cell = spec.load_cell("ellipse-800x1200.resident")
    s = traffic.inputs(cell.traffic, Grid(40, 60), 12345)
    gates = [s.input(i).gate for i in range(100)]
    lo, hi = cell.traffic["gates"]
    assert all(lo <= x <= hi for x in gates) and len(set(gates)) == 100
    assert (s.reference_rhs(s.input(3)) == s.base * gates[3]).all()


def test_sample_is_uniform_and_seeded():
    picks = []
    for seed in (1, 1, 2):
        smp = Sample(3, seed)
        for i in range(50):
            smp.offer(i, i)
        picks.append(sorted(smp.kept))
    assert picks[0] == picks[1] != picks[2]
    assert len(picks[0]) == 3


# --- readers on a canned capture --------------------------------------------


def canned(cards=(0, 1)):
    ev = [Event(capture.ANNOTATION, "host", -1, 0.0, 1000.0)]
    for c in cards:
        ev += [Event("direction_stencil_kernel", "kernel", c, 100.0, 50.0),
               Event("fused_update_kernel", "kernel", c, 200.0, 50.0),
               Event("Memcpy PtoP (Device -> Device)", "memcpy", c, 300.0,
                     10.0),
               Event("Memcpy DtoH (Device -> Pageable)", "memcpy", c, 900.0,
                     40.0),
               Event("outside the slice", "kernel", c, 5000.0, 10.0)]
    ev += [Event("cudaLaunchKernel", "host", -1, 150.0, 400.0),
           Event("aten::item", "host", -1, 400.0, 20.0)]
    return Capture(events=tuple(ev), start_us=0.0, end_us=1000.0,
                   cards=tuple(cards), iterations=4,
                   solve_iterations=(4, 6),
                   config={"grid": {"M": 2400, "N": 3200}},
                   device_kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("metric,value", [
    ("iters_per_solve", 5.0),
    ("launches_per_iter", 1.0),          # 2 kernels × 2 cards / 4
    ("device_us_per_iter", 37.5),        # 150 µs busy a card / 4
    ("device_idle", 85.0),
    ("roofline_share", 100.0 * 91.6346 / 37.5),
])
def test_reader_on_a_canned_capture(metric, value):
    assert spec.reader(metric)(canned()) == pytest.approx(value, rel=1e-5)


@pytest.mark.parametrize("metric", ["launches_per_iter", "device_us_per_iter",
                                    "device_idle", "roofline_share"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    cap = canned()._replace(events=(canned().events[0],))
    assert spec.reader(metric)(cap) is None


def test_breakdown_names_ops_and_what_the_host_did():
    out = capture.breakdown(canned())
    ops = dict(out["device_ops"])
    assert ops["direction_stencil_kernel"] == pytest.approx(50e-6)
    assert "outside the slice" not in ops
    idle = dict(out["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(850e-6)
    # gaps 0-100, 150-200, 250-300, 310-900, 940-1000 µs on each card;
    # the launch call covers 150-550 with aten::item inside it at 400-420
    assert idle["cudaLaunchKernel"] == pytest.approx(320e-6)
    assert idle["aten::item"] == pytest.approx(20e-6)
    assert idle[capture.UNTRACED] == pytest.approx(510e-6)


def test_trace_file_is_a_chrome_trace(tmp_path):
    import gzip

    capture.write_trace(canned(), tmp_path / "t.json.gz")
    rows = json.load(gzip.open(tmp_path / "t.json.gz"))["traceEvents"]
    assert len(rows) == len(canned().events) and rows[0]["ph"] == "X"


# --- one run ----------------------------------------------------------------


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_has_the_contract_keys(trace):
    cell = small(spec.load_cell("ellipse-800x1200.resident"))
    result, lines, _ = run.run_cell(cell, 2 ** 31 + 11, 0.3, trace,
                                    kind="cpu")
    keys = list(result)
    assert keys[: len(RESULT_KEYS)] == RESULT_KEYS and keys[-1] == "checks"
    assert set(keys) <= set(RESULT_KEYS) | {"breakdown", "checks"}
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(result["metrics"]) <= want
    assert "iters_per_solve" in result["metrics"] if trace \
        else set(result["metrics"]) == want
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert [line.split(":")[0] for line in lines] == ["check w_err",
                                                      "check k_gap"]
    json.dumps(result, allow_nan=False)


def test_a_failed_solve_counts_and_is_not_correct():
    cell = small(spec.load_cell("ellipse-800x1200.fused"))
    calls = []

    def flaky(inputs):
        send = inputs.bind(run.program.entry(cell.traffic),
                           run.program.problem(cell.config), ["cpu"])

        def fails_third(inp):
            calls.append(inp.index)
            if len(calls) > 2:
                raise RuntimeError("lost the card")
            return send(inp)

        return fails_third

    result, _, win = run.run_cell(cell, 7, 5.0, False, kind="cpu", send=flaky)
    assert result["failed"] == 1 and result["correct"] is False
    assert result["attempted"] == 2 and math.isinf(win.latencies[-1])


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "poisson_tpu_torch_fake", object())
    assert "poisson_tpu_torch_fake" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "poisson_tpu.fake", object())
    assert "poisson_tpu.fake" in run.forbidden_modules()


def test_without_a_card_the_command_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    code = run.main(["--workload", WORKLOADS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "CUDA" in out.err


@pytest.mark.card
def test_one_short_run_on_the_card(card, tmp_path):
    env = dict(os.environ, TMPDIR=str(tmp_path))
    out = subprocess.run(
        [sys.executable, "-m", "cellbench", "--workload",
         "ellipse-800x1200.resident", "--seed", str(2 ** 31 + 3),
         "--seconds", "2", "--trace", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
    assert "breakdown" in result
