"""Geometric multigrid preconditioning (``preconditioner="mg"``), the
counterpart of ``poisson_tpu/mg``.

Jacobi-preconditioned CG pays iterations that grow with resolution; one
V-cycle per CG iteration over coarsened copies of the same blend canvases
makes the count near-flat in resolution. No kernel of the port runs here:
the cycle is plain PyTorch, as the JAX package's is XLA code, and rides
the plain ``torch`` solve (``solvers.pcg``, ``solvers.batched``,
``solvers.lanes``, ``solvers.checkpoint``).

- ``hierarchy`` — level planning, coefficient coarsening, the dense
  coarsest inverse (host numpy fp64), the per-device hierarchy cache;
- ``cycle`` — full-weighting restriction, bilinear prolongation,
  weighted-Jacobi smoothing, the symmetric V-cycle;
- ``preconditioner`` — the ops bundle (``apply_Dinv`` = one V-cycle) and
  the solve setup every MG solve runs on;
- ``selfcheck`` — ``python -m poisson_tpu_torch.mg.selfcheck``: the
  two-grid contraction (< 0.2 on the model problem) and an MG-vs-Jacobi
  iteration comparison.
"""

from poisson_tpu_torch.mg.cycle import (                      # noqa: F401
    prolong_bilinear,
    restrict_full_weighting,
    smooth_jacobi,
    v_cycle,
)
from poisson_tpu_torch.mg.hierarchy import (                  # noqa: F401
    DEFAULT_MG,
    PRECONDITIONERS,
    MGConfig,
    MGLevels,
    build_hierarchy64,
    coarsen_a,
    coarsen_b,
    device_hierarchy,
    hierarchy_from_fields,
    mg_config_for,
    plan_levels,
    reset_hierarchy_cache,
    resolve_preconditioner,
    validate_mg_problem,
)
from poisson_tpu_torch.mg.preconditioner import (             # noqa: F401
    mg_ops,
    mg_solve_setup,
)
