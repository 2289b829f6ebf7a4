"""Sharded solves over a device mesh (counterpart of
``poisson_tpu/parallel``): the mesh (``mesh``), halo exchange and mesh-order
sums (``halo``), the plain sharded solve (``pcg_sharded``) and its
checkpointed form (``checkpoint_sharded``), the sharded fused solve with
kernels A and B (``fused_sharded``) and the sharded CA solve with kernels C
and D (``ca_sharded``), each of the last two also checkpointed, and the
chunk-boundary heartbeat watchdog of the chunked drivers (``watchdog``).
One host thread drives every shard; a device may hold several shards."""

from poisson_tpu_torch.parallel.ca_sharded import (
    ca_cg_solve_sharded,
    ca_cg_solve_sharded_checkpointed,
)
from poisson_tpu_torch.parallel.checkpoint_sharded import (
    pcg_solve_sharded_checkpointed,
)
from poisson_tpu_torch.parallel.fused_sharded import (
    fused_cg_solve_sharded,
    fused_cg_solve_sharded_checkpointed,
)
from poisson_tpu_torch.parallel.mesh import (
    X_AXIS,
    Y_AXIS,
    Mesh,
    choose_process_grid,
    make_solver_mesh,
)
from poisson_tpu_torch.parallel.pcg_sharded import pcg_solve_sharded
from poisson_tpu_torch.parallel.watchdog import SolveTimeout, Watchdog

__all__ = ["Mesh", "SolveTimeout", "Watchdog", "X_AXIS", "Y_AXIS",
           "ca_cg_solve_sharded",
           "ca_cg_solve_sharded_checkpointed", "choose_process_grid",
           "fused_cg_solve_sharded", "fused_cg_solve_sharded_checkpointed",
           "make_solver_mesh", "pcg_solve_sharded",
           "pcg_solve_sharded_checkpointed"]
