"""poisson_tpu_torch — the PyTorch and CUDA port of ``poisson_tpu``.

A second package beside the JAX one, which stays the reference: the same
``Problem`` in, the same iteration count out, the iterate within a stated
tolerance. It imports ``torch`` and ``numpy``, never ``jax`` or
``poisson_tpu``.

- ``config``   — ``Problem`` and ``FLAGSHIP``.
- ``models``   — host fp64 setup: fictitious-domain coefficients, RHS,
                 analytic solution.
- ``ops``      — the plain stencil operators (``stencil``); the fused
                 two-sweep canvas iteration with its CUDA kernels A and B,
                 and A′ and B′ on the column-blocked canvas of wide grids
                 (``fused_cg``); the whole solve in one launch of kernel R
                 (``resident``); the communication-avoiding pair iteration
                 with kernels C and D (``ca_cg``); kernel S, the ordered
                 and compensated sum of the serial-reduce mode
                 (``serial``). Sources in ``ops/csrc``.
- ``solvers``  — the plain PyTorch PCG solver (``solvers.pcg``),
                 mixed-precision refinement (``solvers.refine``),
                 checkpointed, chunked solves in the JAX package's file
                 format (``solvers.checkpoint``), batched multi-RHS solves
                 (``solvers.batched``), lane stepping for continuous
                 batching (``solvers.lanes``), the self-healing solve
                 (``solvers.resilient``), the fixed-budget history solve
                 (``solvers.history``) and differentiable solves with
                 shape gradients through an adjoint solve
                 (``solvers.adjoint``).
- ``geometry`` — geometry as data: the spec DSL (ellipses, rectangles,
                 polygons, unions, intersections, differences, raw SDFs),
                 the canvas compiler and its fingerprint cache, and the
                 manufactured-solution gate; ``geometry=`` reaches the
                 plain, MG, chunked, batched, lane and CLI solves.
- ``integrity`` — the in-loop silent-corruption probe (``verify_every``).
- ``testing``  — fault injection: NaNs, bit flips, preemption, corrupt
                 checkpoint files.
- ``mg``       — geometric multigrid preconditioning: the level hierarchy,
                 the V-cycle, and ``preconditioner="mg"`` on the plain,
                 batched, lane and chunked solves (plain PyTorch).
- ``parallel`` — the device mesh, halo exchange and mesh-order sums, the
                 plain sharded solve, and the sharded fused and CA solves,
                 which run the kernels' sharded (banded, masked) forms on
                 every shard; each also checkpointed; the chunk-boundary
                 heartbeat watchdog.
- ``obs``      — spans, counters and streamed convergence in the JAX
                 package's formats.
- ``interop``  — carries the JAX package's problem, canvases, MG levels,
                 batched state and geometry specs across as plain data,
                 for the parity tests.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"`` (a
mesh of CPU devices for the sharded solves); without a card they raise.
``python -m poisson_tpu_torch M N`` is the CLI
(``python -m poisson_tpu_torch solve-batched M N --batch B`` the batched
one, ``python -m poisson_tpu_torch geometry SPEC`` the spec debugger).
"""

from poisson_tpu_torch.config import FLAGSHIP, Problem
from poisson_tpu_torch.ops.ca_cg import ca_cg_solve, ca_cg_solve_checkpointed
from poisson_tpu_torch.ops.fused_cg import (
    fused_cg_solve,
    fused_cg_solve_checkpointed,
)
from poisson_tpu_torch.ops.resident import resident_cg_solve
from poisson_tpu_torch.parallel import (
    ca_cg_solve_sharded,
    ca_cg_solve_sharded_checkpointed,
    fused_cg_solve_sharded,
    fused_cg_solve_sharded_checkpointed,
    make_solver_mesh,
    pcg_solve_sharded,
    pcg_solve_sharded_checkpointed,
)
from poisson_tpu_torch.solvers.batched import solve_batched
from poisson_tpu_torch.solvers.checkpoint import (
    pcg_solve_checkpointed,
    pcg_solve_chunked,
)
from poisson_tpu_torch.solvers.history import pcg_solve_history
from poisson_tpu_torch.solvers.lanes import LaneBatch, LaneResult
from poisson_tpu_torch.solvers.pcg import PCGResult, pcg_solve
from poisson_tpu_torch.solvers.refine import RefineResult, refined_solve
from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient

__version__ = "0.1.0"

__all__ = ["FLAGSHIP", "LaneBatch", "LaneResult", "Problem", "PCGResult",
           "RefineResult", "ca_cg_solve",
           "ca_cg_solve_checkpointed", "ca_cg_solve_sharded",
           "ca_cg_solve_sharded_checkpointed", "fused_cg_solve",
           "fused_cg_solve_checkpointed", "fused_cg_solve_sharded",
           "fused_cg_solve_sharded_checkpointed", "make_solver_mesh",
           "pcg_solve", "pcg_solve_checkpointed", "pcg_solve_chunked",
           "pcg_solve_history", "pcg_solve_resilient",
           "pcg_solve_sharded", "pcg_solve_sharded_checkpointed",
           "refined_solve", "resident_cg_solve", "solve_batched",
           "__version__"]
