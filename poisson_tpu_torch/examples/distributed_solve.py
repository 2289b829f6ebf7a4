"""Distributed solve over a device mesh (the stage 2/3/4 workload; the twin
of ``examples/distributed_solve.py``)::

    python -m poisson_tpu_torch.examples.distributed_solve [--device cpu]
        [--shards S]

The port's mesh is single-process: one host thread drives every shard,
and a device may hold several shards (``parallel.make_solver_mesh``). On
the cards the mesh spans every visible card (``--shards`` repeats them);
on the CPU it emulates the JAX example's 8-device host. A mesh over
processes (``torch.distributed``, one process per card) is ROADMAP item
10 and not ported yet, so this example stays on the single-process mesh
until it lands.
"""

import argparse
import sys


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--shards", type=int, default=None,
                    help="mesh size (default: every card; 8 on the CPU)")
    args = ap.parse_args(argv)

    import torch

    from poisson_tpu_torch import Problem
    from poisson_tpu_torch.parallel import (
        make_solver_mesh,
        pcg_solve_sharded,
    )
    from poisson_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    if device.type == "cuda":
        cards = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    else:
        cards = ["cpu"]
    shards = args.shards or (len(cards) if device.type == "cuda" else 8)
    mesh = make_solver_mesh([cards[i % len(cards)] for i in range(shards)])
    problem = Problem(M=400, N=600)
    result = pcg_solve_sharded(problem, mesh)
    out = {"shards": shards, "mesh": (mesh.px, mesh.py),
           "iterations": int(result.iterations),
           "diff": float(result.diff)}
    print(f"devices: {len(cards)}  mesh: {mesh.px}x{mesh.py}")
    print(f"converged in {out['iterations']} iterations (golden: 546), "
          f"||dw|| = {out['diff']:.3e}")
    if device.type == "cuda":
        # The kernel paths over the same mesh: kernels A and B on every
        # shard, and the communication-avoiding pair iteration (C, D).
        from poisson_tpu_torch.parallel import (
            ca_cg_solve_sharded,
            fused_cg_solve_sharded,
        )

        out["fused"] = int(fused_cg_solve_sharded(problem, mesh).iterations)
        print(f"fused kernel path: {out['fused']} iterations")
        out["ca"] = int(ca_cg_solve_sharded(problem, mesh).iterations)
        print(f"CA s=2 path: {out['ca']} iterations")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
