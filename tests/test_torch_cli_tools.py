"""The solve command's last two flags in the port, against the JAX CLI on
the CPU: ``--save-solution`` writes the fp64 iterate as JAX's does (equal
to 1e-12 in fp64, bit for bit with the solve it reports), and
``--categories`` prints stage 4's per-op table and is refused where JAX
refuses it."""

import json

import numpy as np
import pytest
import torch

from poisson_tpu_torch import cli
from poisson_tpu_torch.config import Problem


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_save_solution_equals_jax_s_in_fp64(tmp_path, capsys):
    from poisson_tpu import cli as jax_cli

    ours, theirs = tmp_path / "port.npy", tmp_path / "jax.npy"
    assert cli.main(["40", "40", "--dtype", "float64", "--device", "cpu",
                     "--json", "--save-solution", str(ours)]) == 0
    assert jax_cli.main(["40", "40", "--dtype", "float64", "--backend",
                         "xla", "--json", "--save-solution",
                         str(theirs)]) == 0
    a, b = np.load(ours), np.load(theirs)
    assert a.dtype == b.dtype == np.float64 and a.shape == b.shape == (41,
                                                                       41)
    assert np.max(np.abs(a - b)) <= 1e-12
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["iterations"] == json.loads(
        lines[-1])["iterations"] == 50


@pytest.mark.parametrize("backend, dtype", [("fused", "float32"),
                                            ("torch", "float64"),
                                            ("native", "float64")])
def test_save_solution_is_the_solve_s_iterate(backend, dtype, tmp_path,
                                               capsys):
    from poisson_tpu_torch.native import native_solve
    from poisson_tpu_torch.ops.fused_cg import fused_cg_solve
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    path = tmp_path / "w.npy"
    argv = ["40", "40", "--backend", backend, "--dtype", dtype, "--json",
            "--save-solution", str(path)]
    if backend == "native":
        argv += ["--threads", "1"]
    else:
        argv += ["--device", "cpu"]
    assert cli.main(argv) == 0
    capsys.readouterr()
    p = Problem(M=40, N=40)
    if backend == "fused":
        w = fused_cg_solve(p, device="cpu").w
    elif backend == "torch":
        w = pcg_solve(p, dtype=dtype, device="cpu").w
    else:
        w = native_solve(p, num_threads=1).w
    want = (w.double().numpy() if isinstance(w, torch.Tensor)
            else np.asarray(w, np.float64))
    assert np.array_equal(np.load(path), want)


def test_categories_table(capsys):
    assert cli.main(["40", "40", "--device", "cpu", "--categories"]) == 0
    out = capsys.readouterr().out
    assert "reconstructed per-op decomposition" in out
    for row in ("stencil (mat_A)", "preconditioner (mat_D)",
                "dot products x3", "axpy sweeps (w,r,p)",
                "sum (unfused estimate)"):
        assert row in out
    table = cli.categories_table(Problem(M=20, N=24),
                                              "float64", 10,
                                              torch.device("cpu"))
    assert len(table) == 6 and table[0].split()[0] == "op"
    seconds = [float(line.split()[-2]) for line in table[1:5]]
    assert all(s > 0 for s in seconds)
    assert float(table[5].split()[-2]) == pytest.approx(sum(seconds),
                                                         rel=1e-2)


def test_categories_time_a_card_with_cuda_events(monkeypatch):
    from types import SimpleNamespace

    class Event:
        def __init__(self, enable_timing):
            assert enable_timing
            self.at = None

        def record(self):
            self.at = calls["n"]

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return float(end.at - self.at)     # ms: one per call

    calls = {"n": 0}

    def op():
        calls["n"] += 1

    monkeypatch.setattr(torch.cuda, "Event", Event)
    seconds = cli._time_op(op, SimpleNamespace(type="cuda"), 4)
    assert calls["n"] == 5                      # one untimed, four timed
    assert seconds == pytest.approx(1e-3)


@pytest.mark.parametrize("extra", [["--json"], ["--backend", "native"]])
def test_categories_refusals_match_jax_s(extra):
    from poisson_tpu import cli as jax_cli

    with pytest.raises(SystemExit) as theirs:
        jax_cli.main(["40", "40", "--categories", *extra])
    with pytest.raises(SystemExit) as ours:
        cli.main(["40", "40", "--categories", "--device", "cpu", *extra])
    assert str(theirs.value).startswith("--categories")
    assert str(ours.value).startswith("--categories")
    if extra == ["--json"]:
        assert str(ours.value) == str(theirs.value)
    else:
        assert str(ours.value) == str(theirs.value).replace("JAX ops",
                                                            "torch ops")
