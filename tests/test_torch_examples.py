"""The port's example twins (``poisson_tpu_torch/examples``) give the JAX
package's numbers on the CPU: the same iteration counts, and the same
descent (losses and moved parameters) where the example optimizes."""

import numpy as np
import pytest
import torch

from poisson_tpu_torch.examples import (
    basic_solve,
    distributed_solve,
    shape_opt,
    source_identification,
)
from poisson_tpu_torch.obs import metrics

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def test_basic_solve_is_jax_s(capsys):
    from poisson_tpu import Problem, pcg_solve

    ours = basic_solve.main(CPU)
    theirs = pcg_solve(Problem(M=400, N=600))
    assert ours["iterations"] == int(theirs.iterations) == 546
    assert ours["diff"] == pytest.approx(float(theirs.diff), rel=1e-9)
    assert "converged in 546 iterations" in capsys.readouterr().out


def test_distributed_solve_is_jax_s(capsys):
    import jax

    from poisson_tpu import Problem
    from poisson_tpu.parallel import make_solver_mesh, pcg_solve_sharded

    ours = distributed_solve.main(CPU)
    mesh = make_solver_mesh()
    theirs = pcg_solve_sharded(Problem(M=400, N=600), mesh)
    assert ours["shards"] == len(jax.devices()) == 8
    assert ours["iterations"] == int(theirs.iterations) == 546
    assert "mesh: 2x4" in capsys.readouterr().out


def test_distributed_solve_says_how_to_run_one_copy_per_process():
    doc = distributed_solve.__doc__
    assert "one copy per process" in doc
    assert "initialize_multihost()" in doc
    assert "not ported yet" not in doc


def test_source_identification_is_jax_s():
    import jax
    import jax.numpy as jnp

    from poisson_tpu import Problem
    from poisson_tpu.models.fictitious_domain import build_fields
    from poisson_tpu.solvers import differentiable_solve

    ours = source_identification.main(CPU)
    problem = Problem(M=40, N=40, delta=1e-10)
    _, _, true_source = build_fields(problem)
    observed = differentiable_solve(problem, true_source)

    def loss(source):
        return jnp.sum((differentiable_solve(problem, source)
                        - observed) ** 2)

    source, theirs = 0.5 * true_source, []
    for _ in range(5):
        value, grad = jax.value_and_grad(loss)(source)
        ainv_g = differentiable_solve(problem, grad)
        t = jnp.sum(grad * grad) / (2 * jnp.sum(ainv_g * ainv_g) + 1e-30)
        source = source - t * grad
        theirs.append(float(value))
    np.testing.assert_allclose(ours["losses"], theirs, rtol=1e-6)


def test_shape_opt_is_jax_s():
    from poisson_tpu import Problem
    from poisson_tpu.geometry import Ellipse
    from poisson_tpu.serve import ServicePolicy, SessionHost, SolveService
    from poisson_tpu.solvers.pcg import pcg_solve

    steps = 4
    ours = shape_opt.main(CPU + ["--steps", str(steps)])
    problem = Problem(M=40, N=40, delta=1e-8)
    target = np.asarray(pcg_solve(problem, geometry=Ellipse(cx=0.12)).w)
    host = SessionHost(SolveService(ServicePolicy(capacity=64)))
    sess = host.open("shape-opt", problem, kind="design", dtype="float64",
                     geometry=Ellipse())
    losses, iterations = [], []
    for _ in range(steps):
        out, loss, _ = host.design_step(sess, target, lr=20.0)
        losses.append(loss)
        iterations.append(int(out.iterations))
    assert ours["iterations"] == iterations
    np.testing.assert_allclose(ours["losses"], losses, rtol=1e-6)
    assert ours["cx"] == pytest.approx(sess.design_params["cx"], abs=1e-6)


@pytest.mark.parametrize("module", [basic_solve, distributed_solve,
                                    shape_opt, source_identification])
def test_examples_default_to_the_card(module, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        module.main([])
