"""The port's bench (``poisson_tpu_torch.bench``) against the repo's
``bench.py``, on the CPU.

The record functions take an explicit device; these tests pass ``cpu``,
where the fused path runs its kernels' plain versions. Each record must
carry the keys of the ``bench.py`` record of its mode (read from that
file's source, where each mode builds its ``record`` literal), load in
``benchmarks/regress.py`` and land in a cohort of its own.
"""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks import regress
from poisson_tpu_torch import bench
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = Problem(M=40, N=40)


@pytest.fixture(autouse=True)
def _fresh_registry():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    metrics.reset()
    torch.set_num_threads(saved)


def _jax_record_keys(function: str) -> tuple[set, set]:
    """(record keys, detail keys) of the ``record = {...}`` literal that
    ``bench.py``'s ``function`` builds."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            keys = {k.value for k in node.value.keys}
            detail = node.value.values[[k.value for k in
                                        node.value.keys].index("detail")]
            return keys, {k.value for k in detail.keys}
    raise AssertionError(f"no record literal in bench.py's {function}")


@pytest.fixture(scope="module")
def records():
    """One record of each mode at 40×40 on the CPU."""
    torch.set_num_threads(1)
    return {
        "main": bench.flagship_record(SMALL, CPU),
        "_batched_bench": bench.batched_record(SMALL, 3, CPU),
        "_preconditioner_bench": bench.preconditioner_record(SMALL, "mg",
                                                             CPU),
        "_verify_bench": bench.verify_record(SMALL, 5, CPU),
    }


@pytest.mark.parametrize("function", ["main", "_batched_bench",
                                      "_preconditioner_bench",
                                      "_verify_bench"])
def test_records_carry_bench_pys_fields(function, records):
    rec = records[function]
    keys, detail = _jax_record_keys(function)
    assert keys <= set(rec)
    assert detail <= set(rec["detail"])
    assert rec["detail"]["platform_fallback"] is False
    assert rec["detail"]["platform"] == "cpu"      # it ran where asked
    assert "timing" in rec["detail"]
    json.dumps(rec)


def test_flagship_record(records):
    rec = records["main"]
    assert rec["metric"] == "mlups" and rec["unit"] == "MLUPS"
    det = rec["detail"]
    assert det["backend"] == "fused" and det["iterations"] == 50
    assert det["grid"] == [40, 40] and det["dtype"] == "float32"
    assert det["final_diff"] < 1e-6 and det["l2_error_vs_analytic"] < 1e-2
    assert rec["vs_baseline"] is None              # no published figure
    roof = rec["costs"]["roofline"]
    from poisson_tpu_torch.obs.costs import iteration_bytes

    assert roof["bytes_per_iter_model"] == iteration_bytes(SMALL, "fused")
    assert rec["costs"]["program"] == "torch_iteration_body"


def test_mode_records_count_as_their_solves(records):
    b = records["_batched_bench"]["detail"]
    assert b["iterations"] == 50 and b["iterations_match_sequential"]
    assert b["converged"] == 3 and b["batch"] == 3
    pre = records["_preconditioner_bench"]["detail"]
    assert pre["preconditioner_ab"]["jacobi"]["iterations"] == 50
    assert pre["iterations"] == pre["preconditioner_ab"]["mg"]["iterations"]
    ver = records["_verify_bench"]["detail"]
    assert ver["iterations"] == ver["iterations_baseline"] == 50
    assert ver["verify_overhead"]["checks_per_solve"] == 10


def test_records_land_in_cohorts_of_their_own(records):
    for rec in records.values():
        ours = regress.records_from_result(rec, "port")
        assert len(ours) == 1 and ours[0]["value"] == rec["value"]
        gpu = json.loads(json.dumps(rec))
        gpu["detail"]["platform"] = "gpu"
        for port_rec in (rec, gpu):
            key = regress.cohort_key(
                regress.record_from_result(port_rec, "port"))
            for backend in ("xla", "pallas_fused", "pallas", "xla_batched"):
                for platform in ("tpu", "cpu"):
                    jax_rec = json.loads(json.dumps(rec))
                    jax_rec["detail"].update(backend=backend,
                                             platform=platform)
                    assert key != regress.cohort_key(
                        regress.record_from_result(jax_rec, "jax"))


def test_warmup_gate():
    flagship = Problem(M=800, N=1200)
    bench.warmup_gate(flagship, 989)
    bench.warmup_gate(flagship, 989 + 9)          # max(5, 989 // 100) = 9
    with pytest.raises(RuntimeError, match="suspect iterations"):
        bench.warmup_gate(flagship, 989 + 10)
    with pytest.raises(RuntimeError):
        bench.warmup_gate(Problem(M=400, N=600), 540)
    bench.warmup_gate(SMALL, 1)                   # no golden count: no gate


def test_command_line_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the command would run on it")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "poisson_tpu_torch.bench",
                          "40", "40"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "CUDA" in out.stderr
    assert out.stdout == ""


def test_command_line_refuses_a_partial_grid():
    assert bench.main(["40"]) == 2
