"""Sharded solves over a device mesh (counterpart of
``poisson_tpu/parallel``): the mesh (``mesh``), halo exchange and mesh-order
sums (``halo``), the sharded fused solve with kernels A and B
(``fused_sharded``) and the sharded CA solve with kernels C and D
(``ca_sharded``). One host thread drives every shard; a device may hold
several shards."""

from poisson_tpu_torch.parallel.ca_sharded import ca_cg_solve_sharded
from poisson_tpu_torch.parallel.fused_sharded import fused_cg_solve_sharded
from poisson_tpu_torch.parallel.mesh import (
    X_AXIS,
    Y_AXIS,
    Mesh,
    choose_process_grid,
    make_solver_mesh,
)

__all__ = ["Mesh", "X_AXIS", "Y_AXIS", "ca_cg_solve_sharded",
           "choose_process_grid", "fused_cg_solve_sharded",
           "make_solver_mesh"]
