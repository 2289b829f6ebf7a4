"""Port parity: the plain PyTorch PCG solver (``poisson_tpu_torch.solvers.pcg``)
against ``poisson_tpu.solvers.pcg.pcg_solve``, on the CPU.

Golden iteration counts (the reference oracle, tests/test_pcg_golden.py):
10×10→17 and 20×20→31 with the unweighted norm, 40×40→50 and 400×600→546
weighted, in fp64 Jacobi and in fp32 on the scaled system, equal to the JAX
solver's count at the same dtype. Iterates are held to the JAX fp64 solve:
1e-10 in fp64 and 1e-6 in fp32. The fp32 bound is against fp64 and not
against JAX's fp32 iterate, because at 400×600 that iterate itself lies
1.3e-5 from the fp64 solution (XLA's fp32 sums), while the port's lies
2.3e-7 from it (torch's sums are more accurate)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.solvers import pcg

GOLDEN = [
    (10, 10, False, 17),
    (20, 20, False, 31),
    (40, 40, True, 50),
    (400, 600, True, 546),
]
ATOL = {"float64": 1e-10, "float32": 1e-6}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's thread pools oversubscribe the cores (a 4 s solve
    took 300 s so)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("M,N,weighted,expected", GOLDEN)
def test_golden_count_and_iterate_match_jax(M, N, weighted, expected, dtype):
    r = pcg.pcg_solve(Problem(M=M, N=N, weighted_norm=weighted),
                      dtype=dtype, device="cpu")
    ref = JaxProblem(M=M, N=N, weighted_norm=weighted)
    ref64 = jax_pcg_solve(ref, dtype=jnp.float64)
    ref_count = (ref64 if dtype == "float64"
                 else jax_pcg_solve(ref, dtype=jnp.float32)).iterations
    ref_w = ref64.w
    assert int(r.iterations) == int(ref_count) == expected
    assert int(r.flag) == pcg.FLAG_CONVERGED
    assert float(r.diff) < 1e-6
    assert r.w.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(r.w.numpy(), np.asarray(ref_w),
                               rtol=0, atol=ATOL[dtype])


def test_resolve_policy():
    assert pcg.resolve_dtype(None) == "float64"
    assert pcg.resolve_dtype(torch.float32) == "float32"
    assert pcg.resolve_dtype("float64") == "float64"
    with pytest.raises(ValueError):
        pcg.resolve_dtype(torch.float16)
    assert pcg.resolve_scaled(None, "float32") is True
    assert pcg.resolve_scaled(None, "float64") is False
    assert pcg.resolve_scaled(True, "float64") is True


@pytest.mark.parametrize("check_every", [1, 7, 1000])
def test_check_stride_never_moves_the_count(check_every):
    """The done mask freezes the state, so how often the host reads
    ``done`` changes neither the count nor the iterate."""
    p = Problem(M=40, N=40)
    base = pcg.pcg_solve(p, device="cpu", check_every=32)
    r = pcg.pcg_solve(p, device="cpu", check_every=check_every)
    assert int(r.iterations) == int(base.iterations) == 50
    torch.testing.assert_close(r.w, base.w, rtol=0, atol=0)


def test_iteration_cap_is_exact():
    r = pcg.pcg_solve(Problem(M=40, N=40, max_iter=5), device="cpu")
    assert int(r.iterations) == 5
    assert int(r.flag) == pcg.FLAG_NONE


def test_zero_rhs_stops_with_breakdown():
    """ζ = 0 ⇒ the first ⟨Ap, p⟩ is 0 ⇒ the degenerate guard keeps the
    state and stops after one iteration with FLAG_BREAKDOWN, w = 0."""
    p = Problem(M=16, N=16)
    a, b, _, aux = (torch.tensor(x)
                    for x in pcg.host_fields64(p, False))
    ops = pcg.single_device_ops(p, a, b, aux)
    s = pcg.pcg_loop(ops, torch.zeros_like(a), delta=p.delta, max_iter=10,
                     weighted_norm=True, h1=p.h1, h2=p.h2)
    assert int(s.k) == 1 and bool(s.done)
    assert int(s.flag) == pcg.FLAG_BREAKDOWN
    assert (s.w == 0).all()


def test_stagnation_window_stops_a_capped_solve():
    """δ = 0 never converges; with a window of 1 the first iteration whose
    ‖Δw‖ is no new best stops the solve (k = 21 here), long before the
    degenerate guard would (k = 75)."""
    p = Problem(M=40, N=40, delta=0.0)
    a, b, rhs, aux = (torch.tensor(x) for x in pcg.host_fields64(p, False))
    ops = pcg.single_device_ops(p, a, b, aux)
    s = pcg.pcg_loop(ops, rhs, delta=0.0, max_iter=400, weighted_norm=True,
                     h1=p.h1, h2=p.h2, stagnation_window=1)
    assert bool(s.done)
    assert int(s.flag) == pcg.FLAG_STAGNATED
    assert int(s.k) == 21
