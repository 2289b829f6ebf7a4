"""Port parity: mixed-precision refinement (``poisson_tpu_torch.solvers.refine``)
and the fused path's arbitrary-RHS hook against ``poisson_tpu.solvers.refine``
and ``poisson_tpu.ops.pallas_cg.pallas_cg_solve_rhs``, on the CPU.

The host fp64 pieces (fields, operator) are held bit for bit; the inner
solves run the port's plain versions against the Pallas kernels in
interpret mode, with the same count for a given right-hand side, and the
refined solution is held to the fp64 floor (relative scaled residual
1e-10)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops.pallas_cg import pallas_cg_solve_rhs
from poisson_tpu.solvers import refine as jax_refine
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.fused_cg import fused_cg_solve_rhs
from poisson_tpu_torch.solvers import refine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _scaled_rel_residual(p, w):
    a64, b64, rhs64, sc64 = refine._fields(p)
    r = rhs64 - refine.apply_A64_host(p, a64, b64, w)
    return (refine._weighted_norm(p, sc64 * r)
            / refine._weighted_norm(p, sc64 * rhs64))


def test_host_fields_and_operator_equal_jax():
    p, jp = Problem(M=12, N=16), JaxProblem(M=12, N=16)
    got, want = refine._fields(p), jax_refine._fields(jp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    a64, b64, _, _ = got
    w = np.zeros(p.grid_shape)
    w[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((11, 15))
    np.testing.assert_array_equal(
        refine.apply_A64_host(p, a64, b64, w),
        jax_refine.apply_A64_host(jp, a64, b64, w))


def test_fused_solve_rhs_matches_pallas_cg_solve_rhs():
    p = Problem(M=40, N=40)
    rhs = np.random.default_rng(7).standard_normal(p.grid_shape)
    rhs[0], rhs[-1], rhs[:, 0], rhs[:, -1] = 0, 0, 0, 0
    w64, k = fused_cg_solve_rhs(p, rhs, device="cpu")
    want, want_k = pallas_cg_solve_rhs(JaxProblem(M=40, N=40), rhs,
                                       interpret=True)
    assert k == want_k
    assert w64.dtype == np.float64 and w64.shape == p.grid_shape
    np.testing.assert_allclose(w64, want, atol=1e-6)


@pytest.mark.parametrize("backend", ["fused", "resident"])
def test_refinement_reaches_fp64_floor(backend):
    """The grid of tests/test_refine.py: the residual falls to 1e-10 and
    monotonically, the first inner solve is JAX's golden 50-iteration
    solve, with the first residual within 1% of JAX's, and the floor takes
    as many passes as in JAX.

    The later inner counts differ from JAX's (at 40×40 the port's fused
    corrections take 34, 49, 43 iterations, JAX's 46, 53, 60): each
    correction solves for the fp32 error of the iterate before it, which
    depends on the order of the fp32 sums. JAX's own two backends differ
    there too (46, 53, 60 fused against 46, 53, 59 resident)."""
    p = Problem(M=40, N=40)
    res = refine.refined_solve(p, tol=1e-10, backend=backend, device="cpu")
    want = jax_refine.refined_solve(JaxProblem(M=40, N=40), tol=1e-10,
                                    interpret=True, backend=backend)
    assert res.converged and res.relative_residual <= 1e-10
    assert _scaled_rel_residual(p, res.w) <= 1e-10
    assert all(b < a for a, b in zip(res.residual_norms,
                                     res.residual_norms[1:]))
    assert res.refinements >= 1
    assert res.inner_iterations[0] == want.inner_iterations[0] == 50
    assert len(res.inner_iterations) == len(want.inner_iterations)
    np.testing.assert_allclose(res.residual_norms[0], want.residual_norms[0],
                               rtol=1e-2)


def test_refined_matches_tight_fp64_solve():
    p = Problem(M=40, N=40)
    res = refine.refined_solve(p, tol=1e-12, max_refinements=8,
                               device="cpu")
    tight = jax_pcg_solve(dataclasses.replace(JaxProblem(M=40, N=40),
                                              delta=1e-12),
                          dtype=jnp.float64)
    np.testing.assert_allclose(res.w, np.asarray(tight.w), atol=1e-8)


def test_zero_rhs_short_circuits():
    res = refine.refined_solve(Problem(M=16, N=16, f_val=0.0), device="cpu")
    assert (res.w == 0).all() and res.inner_iterations == ()
    assert res.converged


def test_unconverged_is_reported():
    res = refine.refined_solve(Problem(M=40, N=40), tol=1e-14,
                               max_refinements=0, device="cpu")
    assert not res.converged and res.relative_residual > 1e-14


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        refine.refined_solve(Problem(M=16, N=16), backend="ca", device="cpu")
