"""Port parity: the fixed-budget history solve (``poisson_tpu_torch.solvers.
history``) against ``poisson_tpu.solvers.history``, on the CPU (JAX's
tests/test_history.py on the port, and the curves against JAX's).

Tolerances: at 40×40 fp64 the per-step ``diffs``, ``residual_dots`` and
``l2_errors`` lie within 1e-12 (relative, 1e-15 absolute) of JAX's, with
the same count and the same flat tail after the freeze; the final iterate
equals the port's ``pcg_solve`` bit for bit.
"""

import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.solvers import history as jax_history
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.solvers.history import pcg_solve_history
from poisson_tpu_torch.solvers.pcg import pcg_solve


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def test_history_matches_solver():
    p = Problem(M=40, N=40)
    ref = pcg_solve(p, device="cpu")
    h = pcg_solve_history(p, budget=60, device="cpu")
    assert int(h.iterations) == int(ref.iterations) == 50
    assert torch.equal(h.w, ref.w)
    assert float(h.diffs[-1]) == float(ref.diff)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_history_curves_equal_jax_s(dtype):
    h = pcg_solve_history(Problem(M=40, N=40), budget=60, dtype=dtype,
                          device="cpu")
    want = jax_history.pcg_solve_history(JaxProblem(M=40, N=40), budget=60,
                                         dtype=dtype)
    assert int(h.iterations) == int(want.iterations) == 50
    tol = (dict(rtol=1e-12, atol=1e-15) if dtype == "float64"
           else dict(rtol=1e-4, atol=1e-9))
    for got, ref in ((h.diffs, want.diffs),
                     (h.residual_dots, want.residual_dots),
                     (h.l2_errors, want.l2_errors)):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(h.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-12 if dtype == "float64" else 1e-6)


def test_history_curves_shape_and_freeze():
    p = Problem(M=40, N=40)
    h = pcg_solve_history(p, budget=60, device="cpu")
    k = int(h.iterations)
    assert h.diffs.shape == (60,)
    assert torch.equal(h.diffs[k:], h.diffs[k - 1].expand(60 - k))
    assert torch.equal(h.residual_dots[k:],
                       h.residual_dots[k - 1].expand(60 - k))
    assert float(h.diffs[k - 1]) < p.delta < float(h.diffs[k - 2])


def test_history_error_decreases_to_solver_accuracy():
    h = pcg_solve_history(Problem(M=40, N=40), budget=60, device="cpu")
    errs = h.l2_errors.numpy()
    assert errs[0] / errs[-1] > 10
    assert errs[-1] < 5e-3


def test_history_without_error_recording():
    h = pcg_solve_history(Problem(M=20, N=20), budget=40,
                          record_error=False, device="cpu")
    assert h.l2_errors is None
    assert int(h.iterations) == int(pcg_solve(Problem(M=20, N=20),
                                              device="cpu").iterations)
    with pytest.raises(ValueError, match="budget"):
        pcg_solve_history(Problem(M=20, N=20), budget=0, device="cpu")
