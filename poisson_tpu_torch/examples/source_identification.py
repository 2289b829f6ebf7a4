"""PDE-constrained optimisation with the differentiable solver (the twin of
``examples/source_identification.py``)::

    python -m poisson_tpu_torch.examples.source_identification [--device cpu]

Recover an unknown source term from an observed solution by gradient
descent through the PCG solve (``solvers.adjoint.differentiable_solve``:
each gradient is one adjoint solve, whatever the iteration count), with
an exact line search on the quadratic.
"""

import argparse
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import torch

    from poisson_tpu_torch import Problem
    from poisson_tpu_torch.models.fictitious_domain import build_fields
    from poisson_tpu_torch.solvers.adjoint import differentiable_solve

    from poisson_tpu_torch.utils.platform import resolve_device

    dev = resolve_device(args.device)
    problem = Problem(M=40, N=40, delta=1e-10)
    true_source = torch.tensor(build_fields(problem)[2], device=dev)
    observed = differentiable_solve(problem, true_source, device=dev)

    def loss(source):
        w = differentiable_solve(problem, source, device=dev)
        return torch.sum((w - observed) ** 2)

    source = 0.5 * true_source     # wrong initial guess
    losses = []
    for step in range(5):
        source = source.detach().requires_grad_(True)
        value = loss(source)
        (grad,) = torch.autograd.grad(value, source)
        # Exact line search on the quadratic: t* = |g|² / (2 |A⁻¹g|²).
        ainv_g = differentiable_solve(problem, grad, device=dev)
        t = torch.sum(grad * grad) / (2 * torch.sum(ainv_g * ainv_g) + 1e-30)
        source = source.detach() - t * grad
        losses.append(float(value.detach()))
        print(f"step {step}: loss {losses[-1]:.3e}")
    final = float(loss(source))
    print(f"final loss {final:.3e} (source recovered to solver tolerance)")
    return {"losses": losses, "final": final}


if __name__ == "__main__":
    main(sys.argv[1:])
