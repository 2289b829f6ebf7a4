"""Faults of ``poisson_tpu_torch.ops.resident:resident_cg_solve_rhs``: the
same kernel R as ``resident_cg_solve``, so the same plants
(``faults/resident_cg_solve.py`` of this file's own checkout); the staging
around R changes neither."""

from pathlib import Path

from cellbench import spec

PLANTS = spec.module("faults", "resident_cg_solve",
                     Path(__file__).resolve().parents[2]).PLANTS
