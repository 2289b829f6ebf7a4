"""The plain reference: the published counts, and agreement with the
program at a small size on the CPU (only this file imports both)."""

import numpy as np
import pytest
import torch

from cellbench.reference.fields import Grid, coefficients, rhs
from cellbench.reference.pcg import Operator, solve


@pytest.mark.parametrize("M,N,golden", [(40, 40, 50), (400, 600, 546)])
def test_reference_gives_the_golden_counts(M, N, golden):
    g = Grid(M, N)
    w, k = solve(Operator(g, "cpu"), rhs(g))
    assert k == golden
    assert w.shape == g.shape
    assert np.all(w[0] == 0) and np.all(w[:, -1] == 0)


def test_fields_equal_the_programs():
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.models.fictitious_domain import build_fields

    g = Grid(40, 40)
    a, b, B = build_fields(Problem(M=40, N=40))
    ca, cb = coefficients(g)
    np.testing.assert_allclose(ca, a, rtol=1e-15, atol=0)
    np.testing.assert_allclose(cb, b, rtol=1e-15, atol=0)
    np.testing.assert_array_equal(rhs(g), B)


def test_solution_agrees_with_the_programs_fp64_solve():
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    g = Grid(40, 40)
    w, k = solve(Operator(g, "cpu"), rhs(g))
    res = pcg_solve(Problem(M=40, N=40), dtype="float64", device="cpu")
    assert k == int(res.iterations)
    np.testing.assert_allclose(w, res.w.numpy(), rtol=0, atol=1e-12)


def test_reference_solves_a_gated_rhs_as_a_scaled_problem():
    g = Grid(40, 40)
    op = Operator(g, "cpu")
    w1, _ = solve(op, rhs(g))
    w2, _ = solve(op, rhs(g) * 1.05)
    # CG from zero is scale-invariant up to where it stops.
    assert np.max(np.abs(w2 - 1.05 * w1)) / np.max(np.abs(w2)) < 1e-5


def test_bfloat16_control_is_far_from_the_reference():
    g = Grid(40, 40)
    w64, _ = solve(Operator(g, "cpu"), rhs(g))
    w16, _ = solve(Operator(g, "cpu", torch.bfloat16), rhs(g), cap=150)
    assert np.max(np.abs(w16 - w64)) / np.max(np.abs(w64)) > 1e-3
