"""The port's ``--krylov-block`` and ``--session`` bench modes against the
repo's ``bench.py``, on the CPU: the record keys of each mode (read from
``bench.py`` by ``ast``), cohorts of their own in
``benchmarks/regress.py``, the block iteration count within 5% of JAX's
on the same clustered batch, and ``bench.py``'s refusals."""

import ast
import json
from pathlib import Path

import pytest
import torch

import bench as jax_bench
from benchmarks import regress
from poisson_tpu_torch import bench
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = Problem(M=40, N=40)
BLOCK = 4
STEPS = 3


@pytest.fixture(autouse=True)
def _fresh_registry():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    metrics.reset()
    torch.set_num_threads(saved)


def _jax_record_keys(function: str) -> tuple:
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            detail = node.value.values[keys.index("detail")]
            return set(keys), {k.value for k in detail.keys}
    raise AssertionError(f"no record literal in bench.py's {function}")


@pytest.fixture(scope="module")
def records():
    torch.set_num_threads(1)
    return {"_krylov_block_bench": bench.krylov_block_record(SMALL, BLOCK,
                                                             CPU),
            "_session_bench": bench.session_record(SMALL, STEPS, CPU)}


@pytest.mark.parametrize("function", ["_krylov_block_bench",
                                      "_session_bench"])
def test_records_carry_bench_pys_keys(function, records):
    rec, ok = records[function]
    keys, detail = _jax_record_keys(function)
    assert ok
    assert set(rec) == keys and set(rec["detail"]) == detail
    assert rec["detail"]["platform"] == "cpu"
    assert rec["detail"]["platform_fallback"] is False
    json.dumps(rec)


def test_block_record(records):
    rec, _ = records["_krylov_block_bench"]
    assert rec["metric"] == "batched_solves_per_sec"
    det = rec["detail"]
    assert det["krylov_mode"] == "block" and det["backend"] == "torch_batched"
    ab = det["krylov_block_ab"]
    assert ab["block"]["iterations_total"] == BLOCK * ab["block"][
        "iterations"]
    assert ab["iteration_cut"] == pytest.approx(
        1 - ab["block"]["iterations_total"]
        / ab["independent"]["iterations_total"], abs=1e-4)
    assert ab["iteration_cut"] > 0 and ab["same_l2_floor"]


def test_session_record(records):
    rec, _ = records["_session_bench"]
    assert rec["metric"] == "session.steps_per_sec"
    det = rec["detail"]
    assert det["session"] is True and det["warm_start"] is True
    assert det["backend"] == "torch_session" and det["steps"] == STEPS
    ab = det["session_ab"]
    assert ab["lost"] == 0 and ab["l2_at_floor"]
    assert 0.0 <= ab["warm_hit_rate"] <= 1.0


def test_block_count_is_jax_s_within_five_percent(records, capsys):
    import jax

    from poisson_tpu.config import Problem as JaxProblem

    assert jax_bench._krylov_block_bench(
        JaxProblem(M=SMALL.M, N=SMALL.N), BLOCK, jax.devices(), "cpu") == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ours = records["_krylov_block_bench"][0]
    want = theirs["detail"]["krylov_block_ab"]["block"]["iterations"]
    got = ours["detail"]["krylov_block_ab"]["block"]["iterations"]
    assert abs(got - want) <= 0.05 * want
    assert (ours["detail"]["krylov_block_ab"]["independent"]
            ["iterations_total"] == theirs["detail"]["krylov_block_ab"]
            ["independent"]["iterations_total"])


def test_records_land_in_cohorts_of_their_own(records):
    keys = set()
    for rec, _ in records.values():
        loaded = regress.records_from_result(rec, "port")
        assert loaded and loaded[0]["value"] == rec["value"]
        key = regress.cohort_key(regress.record_from_result(rec, "port"))
        keys.add(key)
        plain = json.loads(json.dumps(rec))
        for field in ("krylov_mode", "session", "warm_start"):
            plain["detail"].pop(field, None)
        assert key != regress.cohort_key(
            regress.record_from_result(plain, "port"))
    assert len(keys) == 2


@pytest.mark.parametrize("argv, message", [
    (["--krylov-block", "1"], "--krylov-block must be >= 2"),
    (["--krylov-block", "4", "--batch", "2"],
     "--krylov-block is its own A/B bench mode"),
    (["--session", "1"], "--session must be >= 2"),
    (["--session", "4", "--krylov-block", "4"],
     "--session is its own A/B bench mode"),
    (["--session"], "usage: python -m poisson_tpu_torch.bench --session"),
])
def test_command_line_refusals_are_bench_pys(argv, message, capsys):
    assert bench.main(argv) == 2
    assert message in capsys.readouterr().err


def test_default_grids_are_bench_pys():
    assert bench.default_grid(bench.parse_args(["--session", "4"])) == (
        300, 450)
    assert bench.default_grid(bench.parse_args(["--krylov-block", "4"])) \
        == (400, 600)
    assert bench.default_grid(bench.parse_args(["--serve", "4"])) == (
        400, 600)
    assert bench.default_grid(bench.parse_args([])) == (800, 1200)


def test_command_line_runs_the_block_mode_on_the_cpu(capsys):
    assert bench.main(["--krylov-block", "2", "--device", "cpu", "20",
                       "24"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["detail"]["grid"] == [20, 24]
    assert rec["detail"]["krylov_mode"] == "block"
