"""Minimal usage: solve the reference's 400×600 problem and report (the
twin of ``examples/basic_solve.py``)::

    python -m poisson_tpu_torch.examples.basic_solve [--device cpu]
"""

import argparse
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from poisson_tpu_torch import Problem, pcg_solve
    from poisson_tpu_torch.analysis import l2_error_host

    problem = Problem(M=400, N=600)
    result = pcg_solve(problem, device=args.device)
    iterations = int(result.iterations)
    l2 = l2_error_host(problem, result.w)
    print(f"grid {problem.M}x{problem.N}: converged in {iterations} "
          f"iterations (golden: 546)")
    print(f"final ||dw|| = {float(result.diff):.3e}")
    print(f"L2 error vs analytic u=(1-x^2-4y^2)/10: {l2:.3e}")
    return {"iterations": iterations, "diff": float(result.diff), "l2": l2}


if __name__ == "__main__":
    main(sys.argv[1:])
