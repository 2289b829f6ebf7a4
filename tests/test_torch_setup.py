"""Port parity: problem setup (config, fictitious-domain fields, host fp64
setup, analytic control) of ``poisson_tpu_torch`` against ``poisson_tpu``.

Setup is numpy fp64 on the host in both packages, in the same operation
order, so the fields must be bitwise equal."""

import dataclasses

import numpy as np
import pytest
import torch

from poisson_tpu.analysis import l2_error_host as jax_l2_error_host
from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.models import fictitious_domain as jax_fd
from poisson_tpu.solvers.pcg import host_fields64 as jax_host_fields64
from poisson_tpu_torch.analysis import l2_error_host, l2_error_vs_analytic
from poisson_tpu_torch.config import FLAGSHIP, Problem
from poisson_tpu_torch.interop import problem_from_reference
from poisson_tpu_torch.models import fictitious_domain as fd
from poisson_tpu_torch.solvers.pcg import host_fields64

GRIDS = [(10, 10), (40, 40), (400, 600)]


@pytest.mark.parametrize("M,N", GRIDS)
def test_problem_from_reference_keeps_every_field(M, N):
    ref = JaxProblem(M=M, N=N, delta=1e-5, max_iter=77, weighted_norm=False)
    p = problem_from_reference(dataclasses.asdict(ref))
    assert dataclasses.asdict(p) == dataclasses.asdict(ref)
    for prop in ("h1", "h2", "eps", "iteration_cap", "interior_shape",
                 "grid_shape", "interior_points"):
        assert getattr(p, prop) == getattr(ref, prop), prop
    assert (FLAGSHIP.M, FLAGSHIP.N) == (800, 1200)


@pytest.mark.parametrize("M,N", GRIDS)
def test_build_fields_bitwise(M, N):
    got = fd.build_fields(Problem(M=M, N=N), dtype=np.float64)
    want = jax_fd.build_fields(JaxProblem(M=M, N=N), dtype=np.float64,
                               xp=np)
    for g, w in zip(got, want):
        assert g.dtype == np.float64
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("M,N", GRIDS)
def test_host_fields64_bitwise(M, N, scaled):
    got = host_fields64(Problem(M=M, N=N), scaled)
    want = jax_host_fields64(JaxProblem(M=M, N=N), scaled)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert not g.flags.writeable   # cached and shared: read-only


def test_analytic_solution_and_l2_error():
    p, ref = Problem(M=40, N=60), JaxProblem(M=40, N=60)
    np.testing.assert_array_equal(
        fd.analytic_solution(p),
        np.asarray(jax_fd.analytic_solution(ref, dtype=np.float64, xp=np)),
    )
    rng = np.random.default_rng(0)
    w = fd.analytic_solution(p) + 1e-3 * rng.standard_normal(p.grid_shape)
    want = jax_l2_error_host(ref, w)
    assert l2_error_host(p, w) == pytest.approx(want, rel=1e-14)
    got_t = float(l2_error_vs_analytic(p, torch.tensor(w)))
    assert got_t == pytest.approx(want, rel=1e-12)
