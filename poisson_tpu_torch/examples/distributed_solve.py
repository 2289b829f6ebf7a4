"""Distributed solve over a device mesh (the stage 2/3/4 workload; the twin
of ``examples/distributed_solve.py``)::

    python -m poisson_tpu_torch.examples.distributed_solve [--device cpu]
        [--shards S]

In one process the mesh spans every visible card (``--shards`` repeats
them; a device may hold several shards, ``parallel.make_solver_mesh``); on
the CPU it emulates the JAX example's 8-device host. Over processes, run
one copy per process under a launcher that sets ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``torchrun --nproc-per-node
2 -m poisson_tpu_torch.examples.distributed_solve``): the script calls
``initialize_multihost()`` first (with no cluster in the environment it is
a no-op), each process declares its own card (on the CPU, its share of
``--shards``), and the plain solve runs over the mesh of every process's
shards. NCCL carries it when each process has a card of its own, gloo
otherwise. The one-shot kernel paths (fused, CA) drive their mesh from one
process, so they run only there; over processes their checkpointed
drivers are the entry points.
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
    from poisson_tpu_torch.parallel.multihost import (
        initialize_multihost,
        is_primary,
        world_size,
    )
    from poisson_tpu_torch.utils.platform import resolve_device

    initialize_multihost()
    world = world_size()
    device = resolve_device(args.device)
    if device.type == "cuda":
        cards = ([f"cuda:{torch.cuda.current_device()}"] if world > 1 else
                 [f"cuda:{i}" for i in range(torch.cuda.device_count())])
    else:
        cards = ["cpu"]
    shards = args.shards or (len(cards) * world if device.type == "cuda"
                             else 8)
    mine = max(1, shards // world)
    mesh = make_solver_mesh([cards[i % len(cards)] for i in range(mine)])
    problem = Problem(M=400, N=600)
    result = pcg_solve_sharded(problem, mesh)
    out = {"shards": mesh.size, "mesh": (mesh.px, mesh.py),
           "iterations": int(result.iterations),
           "diff": float(result.diff)}
    if is_primary():
        print(f"devices: {len(cards)}  processes: {world}  "
              f"mesh: {mesh.px}x{mesh.py}")
        print(f"converged in {out['iterations']} iterations (golden: 546), "
              f"||dw|| = {out['diff']:.3e}")
    if device.type == "cuda" and not mesh.multiprocess:
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
