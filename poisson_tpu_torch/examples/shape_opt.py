"""Shape optimization as a durable solver session (the twin of
``examples/shape_opt.py``)::

    python -m poisson_tpu_torch.examples.shape_opt [--device cpu]

Recover an unknown domain offset from an observed solution by gradient
descent on the ellipse parameters, driven through the solve service as
one design session: each step is a forward solve and an adjoint solve
(``solvers.adjoint.shape_gradient``), the moved ellipse becomes the
session's next step — warm-started from the previous iterate while the
move stays inside the validity bound — and every transition is a
journaled, recoverable step boundary. 40×40 grid, 12 descent steps.
"""

import argparse
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)

    from poisson_tpu_torch import Problem
    from poisson_tpu_torch.geometry import Ellipse
    from poisson_tpu_torch.obs import metrics
    from poisson_tpu_torch.serve import (
        ServicePolicy,
        SessionHost,
        SolveService,
    )
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    # Tight solver tolerance: the adjoint differentiates through the
    # solve, so solver error is gradient noise — well below the descent's
    # moves, above this grid's Krylov breakdown floor (~1e-9).
    problem = Problem(M=40, N=40, delta=1e-8)
    # The observed solution: the default ellipse moved right by 0.12.
    true_spec = Ellipse(cx=0.12)
    target = pcg_solve(problem, geometry=true_spec,
                       device=args.device).w.cpu().numpy()

    svc = SolveService(ServicePolicy(capacity=64), device=args.device)
    host = SessionHost(svc)
    sess = host.open("shape-opt", problem, kind="design", dtype="float64",
                     geometry=Ellipse(),
                     params={"note": "poisson_tpu_torch.examples.shape_opt"})
    if sess is None:
        raise RuntimeError("design session was shed on an idle service")
    losses, iterations = [], []
    for it in range(args.steps):
        out, loss, _ = host.design_step(sess, target, lr=20.0)
        losses.append(loss)
        iterations.append(int(out.iterations))
        p = sess.design_params
        print(f"step {it}: loss {loss:.3e}  cx {p['cx']:+.4f}  "
              f"({iterations[-1]} iterations)")
    warm_hits = metrics.snapshot()["counters"].get("session.warm.hits", 0)
    summary = host.close(sess)
    err = abs(sess.design_params["cx"] - true_spec.cx)
    print(f"closed: {summary['steps']} steps, "
          f"slo_good={summary['slo_good']}, {warm_hits} warm-started")
    print(f"final loss {losses[-1]:.3e} (from {losses[0]:.3e}), "
          f"center error {err:.4f} (grid cell h1 = {problem.h1:.3f})")
    ok = losses[-1] < 0.25 * losses[0] and err < problem.h1
    if ok:
        print("recovered the domain offset to within one grid cell")
    else:
        print("shape optimization did NOT converge", file=sys.stderr)
    return {"losses": losses, "iterations": iterations,
            "cx": sess.design_params["cx"], "ok": ok}


if __name__ == "__main__":
    sys.exit(0 if main(sys.argv[1:])["ok"] else 1)
