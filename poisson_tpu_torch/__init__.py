"""poisson_tpu_torch — the PyTorch and CUDA port of ``poisson_tpu``.

A second package beside the JAX one, which stays the reference: the same
``Problem`` in, the same iteration count out, the iterate within a stated
tolerance. It imports ``torch`` and ``numpy``, never ``jax`` or
``poisson_tpu``.

- ``config``   — ``Problem`` and ``FLAGSHIP``.
- ``models``   — host fp64 setup: fictitious-domain coefficients, RHS,
                 analytic solution.
- ``ops``      — the plain stencil operators (``stencil``) and the fused
                 two-sweep canvas iteration with its CUDA kernels A and B
                 (``fused_cg``, sources in ``ops/csrc``).
- ``solvers``  — the plain PyTorch PCG solver (``solvers.pcg``).
- ``interop``  — carries the JAX package's problem and canvases across as
                 plain data, for the parity tests.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a card they raise. ``python -m poisson_tpu_torch M N`` is the CLI.
"""

from poisson_tpu_torch.config import FLAGSHIP, Problem
from poisson_tpu_torch.ops.fused_cg import fused_cg_solve
from poisson_tpu_torch.solvers.pcg import PCGResult, pcg_solve

__version__ = "0.1.0"

__all__ = ["FLAGSHIP", "Problem", "fused_cg_solve", "pcg_solve", "PCGResult",
           "__version__"]
