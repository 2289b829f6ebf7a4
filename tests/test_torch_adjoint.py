"""Port parity: differentiable solves and shape gradients
(``poisson_tpu_torch.solvers.adjoint``) against
``poisson_tpu.solvers.adjoint``, on the CPU.

The same seeded RHS, cotangents and tangents (numpy) go through both
packages. Tolerances: the forward solve within 1e-12 of the fp64
``pcg_solve`` and of JAX's; the VJP within 1e-10 of ``jax.vjp``'s; the
JVP (``torch.autograd.forward_ad``) within 1e-10 of ``jax.jvp``'s;
``shape_gradient`` within 1e-6 (relative) of JAX's and 5e-3 of central
differences (step 1e-5) at JAX's 32×32; forward and reverse mode of the
shape derivative agree to 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.geometry import dsl as jdsl
from poisson_tpu.solvers import adjoint as jax_adjoint
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry import dsl
from poisson_tpu_torch.models.fictitious_domain import build_fields
from poisson_tpu_torch.solvers import adjoint
from poisson_tpu_torch.solvers.pcg import pcg_solve

pytestmark = pytest.mark.geom

CPU = dict(device="cpu")
# Tight δ: gradients are exact to solver tolerance (JAX's test_adjoint).
SMALL = dict(M=20, N=20, delta=1e-12)
SHAPE = dict(M=32, N=32, delta=1e-11)
PARAMS = [0.8, 0.42]


@pytest.fixture(autouse=True)
def _one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _seeded(seed, shape=(21, 21)):
    return np.random.default_rng(seed).standard_normal(shape)


def _jax_solve(rhs):
    return jax_adjoint.differentiable_solve(JaxProblem(**SMALL),
                                            jnp.asarray(rhs))


def _solve(rhs):
    return adjoint.differentiable_solve(Problem(**SMALL), rhs, **CPU)


def test_forward_is_the_fp64_solve():
    p = Problem(**SMALL)
    rhs = build_fields(p)[2]
    w = _solve(rhs)
    np.testing.assert_allclose(w.numpy(), pcg_solve(p, **CPU).w.numpy(),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(w.numpy(), np.asarray(_jax_solve(rhs)),
                               rtol=0, atol=1e-12)


def test_linearity_and_seeded_forward_are_jax_s():
    rhs = build_fields(Problem(**SMALL))[2]
    w1, w2 = _solve(rhs), _solve(2.0 * rhs)
    np.testing.assert_allclose(w2.numpy(), 2.0 * w1.numpy(), rtol=0,
                               atol=1e-9)
    seeded = _seeded(0)
    np.testing.assert_allclose(_solve(seeded).numpy(),
                               np.asarray(_jax_solve(seeded)), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("seed", [1, 2])
def test_vjp_is_jax_s(seed):
    rhs, ct = _seeded(0), _seeded(seed)
    r = torch.tensor(rhs, requires_grad=True)
    (got,) = torch.autograd.grad(_solve(r), r, torch.tensor(ct))
    _, vjp = jax.vjp(_jax_solve, jnp.asarray(rhs))
    (want,) = vjp(jnp.asarray(ct))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)


def test_vjp_is_the_solve_of_the_cotangent():
    """A = Aᵀ: the VJP is the solve itself (JAX's
    test_gradient_is_symmetric_solve)."""
    r = torch.tensor(_seeded(0), requires_grad=True)
    g = torch.zeros(21, 21, dtype=torch.float64)
    g[8, 12] = 1.0
    (back,) = torch.autograd.grad(_solve(r), r, g)
    np.testing.assert_allclose(back.numpy(), _solve(g).numpy(), rtol=0,
                               atol=1e-12)


def test_ring_cotangent_is_ignored():
    r = torch.tensor(_seeded(0), requires_grad=True)
    (g1,) = torch.autograd.grad(
        _solve(r)[0, :].sum() + (_solve(r) ** 2).sum(), r)
    (g2,) = torch.autograd.grad((_solve(r) ** 2).sum(), r)
    np.testing.assert_allclose(g1.numpy(), g2.numpy(), rtol=0, atol=1e-12)
    assert float(g1[0].abs().max()) == 0.0


def test_gradient_matches_finite_differences():
    """dJ/dB for J = Σ w² (JAX's test_gradient_matches_finite_differences
    on the port)."""
    p = Problem(**SMALL)
    rhs = torch.tensor(build_fields(p)[2])
    r = rhs.clone().requires_grad_(True)
    loss = lambda x: (_solve(x) ** 2).sum()
    (g,) = torch.autograd.grad(loss(r), r)
    eps = 1e-4
    for i, j in [(10, 10), (5, 10), (14, 7), (2, 2)]:
        bump = torch.zeros_like(rhs)
        bump[i, j] = eps
        fd = (float(loss(rhs + bump)) - float(loss(rhs - bump))) / (2 * eps)
        assert np.isclose(float(g[i, j]), fd, rtol=1e-4, atol=1e-9), (i, j)


@pytest.mark.parametrize("seed", [3, 4])
def test_jvp_is_jax_s(seed):
    rhs, t = _seeded(0), _seeded(seed)
    with fwAD.dual_level():
        out = _solve(fwAD.make_dual(torch.tensor(rhs), torch.tensor(t)))
        got = fwAD.unpack_dual(out).tangent
    _, want = jax.jvp(_jax_solve, (jnp.asarray(rhs),), (jnp.asarray(t),))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-10)
    np.testing.assert_allclose(got.numpy(), _solve(t).numpy(), rtol=0,
                               atol=1e-12)


# -- shape gradients --------------------------------------------------------


def _shape_loss(p):
    return lambda w: w[1:-1, 1:-1].sum() * p.h1 * p.h2


@pytest.mark.parametrize("family", ["ellipse", "rectangle"])
def test_shape_gradient_is_jax_s(family):
    p, jp = Problem(**SHAPE), JaxProblem(**SHAPE)
    if family == "ellipse":
        make = lambda d, q: d.Ellipse(cx=0.0, cy=0.0, rx=q[0], ry=q[1])
        params = PARAMS
    else:
        make = lambda d, q: d.Rectangle(q[0], q[1], 0.5, 0.3)
        params = [-0.63, -0.27]
    val, grad = adjoint.shape_gradient(p, lambda q: make(dsl, q), params,
                                       _shape_loss(p), **CPU)
    jval, jgrad = jax_adjoint.shape_gradient(
        jp, lambda q: make(jdsl, q), jnp.asarray(params),
        lambda w: jnp.sum(w[1:-1, 1:-1]) * jp.h1 * jp.h2)
    assert float(val) == pytest.approx(float(jval), rel=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad), rtol=1e-6)
    assert np.all(np.abs(grad.numpy()) > 0)


def test_shape_gradient_matches_central_differences():
    """JAX's test_shape_gradient_matches_finite_differences on the port."""
    p = Problem(**SHAPE)
    loss = _shape_loss(p)
    spec_fn = lambda q: dsl.Ellipse(cx=0.0, cy=0.0, rx=q[0], ry=q[1])
    val, grad = adjoint.shape_gradient(p, spec_fn, PARAMS, loss, **CPU)
    assert np.isfinite(float(val)) and torch.isfinite(grad).all()

    def f(q):
        w = adjoint.differentiable_geometry_solve(
            p, spec_fn(torch.tensor(q, dtype=torch.float64)), **CPU)
        return float(loss(w))

    eps = 1e-5
    for k in range(2):
        hi, lo = list(PARAMS), list(PARAMS)
        hi[k] += eps
        lo[k] -= eps
        fd = (f(hi) - f(lo)) / (2 * eps)
        assert float(grad[k]) == pytest.approx(fd, rel=5e-3), (k, fd)


def test_shape_derivative_forward_mode_is_reverse_mode_and_jax_s():
    p, jp = Problem(**SHAPE), JaxProblem(**SHAPE)
    loss = _shape_loss(p)
    _, grad = adjoint.shape_gradient(
        p, lambda q: dsl.Ellipse(0.0, 0.0, q[0], q[1]), PARAMS, loss, **CPU)
    jf = lambda q: jnp.sum(jax_adjoint.differentiable_geometry_solve(
        jp, jdsl.Ellipse(cx=0.0, cy=0.0, rx=q[0], ry=q[1]))[1:-1, 1:-1]
    ) * jp.h1 * jp.h2
    for k in range(2):
        t = torch.zeros(2, dtype=torch.float64)
        t[k] = 1.0
        with fwAD.dual_level():
            q = fwAD.make_dual(torch.tensor(PARAMS, dtype=torch.float64), t)
            w = adjoint.differentiable_geometry_solve(
                p, dsl.Ellipse(0.0, 0.0, q[0], q[1]), **CPU)
            tangent = float(fwAD.unpack_dual(loss(w)).tangent)
        _, want = jax.jvp(jf, (jnp.asarray(PARAMS),),
                          (jnp.asarray(t.numpy()),))
        assert tangent == pytest.approx(float(want), rel=1e-6)
        assert tangent == pytest.approx(float(grad[k]), rel=1e-4)


def test_shape_gradient_takes_a_dict_and_keeps_the_loop_off_the_graph():
    p = Problem(**SHAPE)
    val, grad = adjoint.shape_gradient(
        p, lambda q: dsl.Ellipse(rx=q["rx"], ry=q["ry"]),
        {"rx": 0.8, "ry": 0.42}, _shape_loss(p), **CPU)
    _, want = adjoint.shape_gradient(
        p, lambda q: dsl.Ellipse(0.0, 0.0, q[0], q[1]), PARAMS,
        _shape_loss(p), **CPU)
    assert float(grad["rx"]) == float(want[0])
    assert float(grad["ry"]) == float(want[1])
    # The solve is one node of the graph, whatever its iteration count.
    q = torch.tensor(PARAMS, dtype=torch.float64, requires_grad=True)
    w = adjoint.differentiable_geometry_solve(
        p, dsl.Ellipse(0.0, 0.0, q[0], q[1]), **CPU)
    assert type(w.grad_fn).__name__ == "LinearSolveBackward"


@pytest.mark.parametrize("spec", [
    lambda d: d.Polygon(((0.0, 0.0), (0.4, 0.0), (0.2, 0.3))),
    lambda d: d.Union((d.Ellipse(rx=0.5, ry=0.3),
                       d.Rectangle(-0.2, -0.2, 0.2, 0.2))),
    lambda d: d.SDF(lambda x, y: x * x + y * y - 0.1, name="c")],
    ids=["polygon", "union", "sdf"])
def test_sampled_families_raise_as_jax_s_do(spec):
    with pytest.raises(ValueError, match="closed-form") as want:
        jax_adjoint.differentiable_geometry_solve(JaxProblem(M=16, N=16),
                                                  spec(jdsl))
    with pytest.raises(ValueError, match="closed-form") as got:
        adjoint.differentiable_geometry_solve(Problem(M=16, N=16),
                                              spec(dsl), **CPU)
    assert str(got.value) == str(want.value)
