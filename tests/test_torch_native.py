"""Port parity: the fp64 C++ oracle (``poisson_tpu_torch.native``) and the
CLI's ``--backend native`` against ``poisson_tpu.native`` and the JAX CLI,
on the CPU.

The port compiles its own copy of the oracle source, which must stay the
JAX package's byte for byte; with the same compiler and one thread both
libraries give the same bits.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from poisson_tpu import cli as jax_cli
from poisson_tpu import native as jax_native
from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.utils.timing import SolveReport as JaxSolveReport
from poisson_tpu_torch import cli, native
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers.pcg import pcg_solve

ROOT = Path(__file__).resolve().parents[1]
GEOMETRY = '{"type": "ellipse", "rx": 0.7, "ry": 0.4}'


@pytest.fixture(autouse=True)
def _fresh_registry():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    metrics.reset()
    torch.set_num_threads(saved)


def test_oracle_source_is_the_jax_packages_byte_for_byte():
    ours = (ROOT / "poisson_tpu_torch/native/poisson_oracle.cpp").read_bytes()
    theirs = (ROOT / "poisson_tpu/native/poisson_oracle.cpp").read_bytes()
    assert ours == theirs


def test_library_builds_into_the_ports_build_directory():
    path = Path(native.build())
    assert path.parent == ROOT / "poisson_tpu_torch/ops/build"
    assert path.name.startswith("poisson_oracle-") and path.suffix == ".so"
    assert path.exists()


def test_a_cxx_that_cannot_build_gives_way_to_gpp(monkeypatch):
    # A toolchain wrapper in CXX may lack OpenMP's spec file: g++ is next.
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    monkeypatch.setattr(native, "_built", None)
    assert native.compilers() == ["/nonexistent/g++", "g++"]
    assert native.build() == str(native.library_path("g++"))
    monkeypatch.setenv("CXX", "/nonexistent/g++")
    monkeypatch.setattr(native, "_built", None)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match="/nonexistent/g\\+\\+"):
        native.build(force=True)


@pytest.mark.parametrize("M,N,weighted,expected", [
    (10, 10, False, 17), (20, 20, False, 31), (40, 40, False, 61),
    (40, 40, True, 50)])
def test_golden_iterations(M, N, weighted, expected):
    # One thread: exact counts need a fixed reduction order
    # (tests/test_native.py:21-36).
    r = native.native_solve(Problem(M=M, N=N, weighted_norm=weighted),
                            num_threads=1)
    assert r.iterations == expected
    assert r.diff < 1e-6


@pytest.mark.parametrize("M,N", [(40, 40), (400, 600)])
def test_native_solve_is_the_jax_wrappers_bit_for_bit(M, N):
    ours = native.native_solve(Problem(M=M, N=N), num_threads=1)
    theirs = jax_native.native_solve(JaxProblem(M=M, N=N), num_threads=1)
    assert ours.iterations == theirs.iterations
    assert ours.w.tobytes() == theirs.w.tobytes()
    assert ours.diff == theirs.diff
    assert ours.residual_dot == theirs.residual_dot


@pytest.mark.parametrize("M,N,expected", [(40, 40, 50), (400, 600, 546)])
def test_port_fp64_plain_solve_agrees_with_the_oracle(M, N, expected):
    # Tolerance 1e-10: fp64, the two differ only in summation order.
    p = Problem(M=M, N=N)
    oracle = native.native_solve(p, num_threads=1)
    plain = pcg_solve(p, dtype=torch.float64, device="cpu")
    assert oracle.iterations == int(plain.iterations) == expected
    np.testing.assert_allclose(plain.w.numpy(), oracle.w, rtol=0,
                               atol=1e-10)


def test_has_openmp():
    assert native.has_openmp() == jax_native.has_openmp()


def _refusal(main, argv) -> str:
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value.code)


# JAX's refusal words → the port's (its backends, kernels and profiler).
_PORT_WORDS = (
    ("the JAX backends", "the torch and CUDA backends"),
    ("the JAX chunked solvers", "the torch chunked solvers"),
    ("the single-device xla solve", "the single-device torch solve"),
    ("the JAX xla solve body (poisson_tpu.mg)",
     "the torch solve body (poisson_tpu_torch.mg)"),
    ("the fused JAX loop", "the torch solve loop"),
    ("a JAX device trace", "a torch.profiler device trace"),
    ("--bm/--bn/--parallel-grid/--serial-reduce shape the pallas kernels",
     "--bm/--bn/--serial-reduce shape the CUDA kernels"),
)


@pytest.mark.parametrize("flags", [
    ["--checkpoint", "ck.npz"], ["--resilient"], ["--verify-every", "5"],
    ["--fault-nan-at", "3"], ["--heartbeat", "hb.json"],
    ["--geometry", GEOMETRY], ["--preconditioner", "mg"],
    ["--stream-every", "5"], ["--profile", "prof"], ["--bm", "8"],
    ["--bn", "128"], ["--serial-reduce"]],
    ids=lambda f: f[0])
def test_cli_native_refuses_what_the_jax_cli_refuses(flags, tmp_path,
                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["40", "40", "--backend", "native", *flags]
    theirs = _refusal(jax_cli.main, argv)
    for jax_words, port_words in _PORT_WORDS:
        theirs = theirs.replace(jax_words, port_words)
    assert _refusal(cli.main, argv) == theirs
    assert "native" in theirs


def test_cli_native_report_has_the_jax_reports_fields(capsys):
    argv = ["40", "40", "--backend", "native", "--threads", "1", "--json"]
    assert jax_cli.main(argv) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(argv + ["--device", "cuda"]) == 0   # --device: unused
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    fields = {f.name for f in dataclasses.fields(JaxSolveReport)}
    assert fields <= set(ours)
    assert ours["dtype"] == theirs["dtype"] == "float64"
    assert ours["devices"] == theirs["devices"] == 0
    assert ours["backend"] == theirs["backend"] == "native"
    assert ours["iterations"] == theirs["iterations"] == 50
    assert ours["final_diff"] == theirs["final_diff"]
    assert ours["l2_error"] == pytest.approx(theirs["l2_error"], rel=1e-12)
    assert ours["bytes_per_iter_model"] is None
    assert metrics.get("pcg.solves.untracked") == 1


def test_auto_never_picks_native():
    for dtype in ("float32", "float64"):
        assert cli.pick_backend("auto", dtype) != "native"
