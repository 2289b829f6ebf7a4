"""Batched-path smoke check (counterpart of
``poisson_tpu/solvers/batched_selfcheck.py``)::

    python -m poisson_tpu_torch.solvers.batched_selfcheck [--device cpu]

A small batch with distinct RHS gates must reproduce the sequential solver
bit for bit per member (iterates, flags, counts: the per-member freeze at
work), pad to a pinned bucket invisibly, and count its bucket reuse in
``obs.metrics``. Exit 0 on success, 1 with a reason on the first failure.
"""

from __future__ import annotations

import argparse
import sys


def run_selfcheck(device="cuda") -> int:
    import torch

    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.obs import metrics
    from poisson_tpu_torch.solvers.batched import bucket_size, solve_batched
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve

    def fail(reason: str) -> int:
        print(f"batched selfcheck FAILED: {reason}", file=sys.stderr)
        return 1

    problem = Problem(M=40, N=40)
    gates = (0.25, 1.0, 4.0)
    seq = [pcg_solve(problem, rhs_gate=g, device=device) for g in gates]
    bat = solve_batched(problem, rhs_gates=gates, device=device)

    iters = bat.iterations.tolist()
    if len(iters) != len(gates):
        return fail(f"iterations not per member: {iters}")
    flags = bat.flag.tolist()
    for i, r in enumerate(seq):
        if iters[i] != int(r.iterations):
            return fail(f"member {i}: iterations {iters[i]} != "
                        f"sequential {int(r.iterations)}")
        if flags[i] != int(r.flag):
            return fail(f"member {i}: flag mismatch")
        if not torch.equal(bat.w[i], r.w):
            return fail(f"member {i}: solution not bit-identical")
    if len(set(iters)) < 2:
        return fail("gates did not produce distinct iteration counts — "
                    "the per-member freeze went unexercised")
    if any(f != FLAG_CONVERGED for f in flags):
        return fail("not every member converged")
    if int(bat.max_iterations) != max(int(r.iterations) for r in seq):
        return fail("max_iterations disagrees with the member vector")
    if bucket_size(len(gates)) != 4:
        return fail("bucket ladder changed: 3 members should bucket to 4")
    hits0 = metrics.get("batched.bucket_cache.hits")
    padded = solve_batched(problem, rhs_gates=gates, device=device,
                           bucket=4)                       # same bucket
    if metrics.get("batched.bucket_cache.hits") <= hits0:
        return fail("bucket-cache hit not counted on reuse")
    if padded.iterations.tolist() != iters or not torch.equal(padded.w,
                                                              bat.w):
        return fail("padding to the bucket changed the members")
    print(f"batched selfcheck OK: {len(gates)} members (bucket 4), "
          f"iterations {iters}, all converged bit-identical to sequential")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch.solvers.batched_selfcheck",
        description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    return run_selfcheck(ap.parse_args(argv).device)


if __name__ == "__main__":
    sys.exit(main())
