"""MG-preconditioned PCG: the ops bundle and the solve setup (counterpart
of ``poisson_tpu/mg/preconditioner.py``).

The preconditioner seam of every solver is ``PCGOps.apply_Dinv``: the
shared PCG body (``solvers.pcg.make_pcg_body``) sees ``z = M⁻¹r`` only
through it. Multigrid is therefore an ops construction, never a body
change: ``"mg"`` swaps one V-cycle per iteration in for the Jacobi
diagonal, and the Jacobi path keeps its operations and bits.

Scaled wrap: the fp32 path runs CG on Ã = D^{-1/2}·A·D^{-1/2}. The V-cycle
works in w-space on the unscaled operator at every level, so the scaled
preconditioner is the congruence z̃ = √d · V(√d · r̃), SPD whenever V is.

The JAX package jits an MG twin of each solve program (``_solve_mg``,
``_solve_batched_mg``, ``_member_init_mg``, ``_step_lanes_mg``,
``_run_chunk_mg``) so that the Jacobi executables keep their identity.
The port compiles nothing, so its twins are the existing loops run on
the bundle :func:`mg_solve_setup` returns: ``pcg_loop`` (the solve),
``solvers.batched.pcg_loop_batched`` (the batched loop), ``init_state``
(the member init of a lane splice and a chunked solve),
``solvers.batched.step_members`` (the lane step) and ``drive`` (the chunk
advance).
"""

from __future__ import annotations

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.mg.cycle import v_cycle
from poisson_tpu_torch.mg.hierarchy import (
    DEFAULT_MG,
    MGConfig,
    MGLevels,
    device_hierarchy,
)
from poisson_tpu_torch.solvers.pcg import (
    PCGOps,
    SolveSetup,
    scaled_single_device_ops,
    single_device_ops,
    solve_setup,
)


# How often an MG loop reads ``done``: every iteration. A V-cycle is
# hundreds of launches, so the sync is cheap beside it, and the frozen
# steps a 32-step check would run past a stop at 15 iterations would
# double the solve.
CHECK_EVERY_MG = 1


def vcycle_preconditioner(problem: Problem, hier: MGLevels,
                          config: MGConfig = DEFAULT_MG,
                          scaled: bool = True):
    """``r → M⁻¹r`` as one V-cycle (with the √d wrap when ``scaled``)."""
    h1, h2 = problem.h1, problem.h2
    if scaled:
        scinv = hier.scinv
        return lambda rt: scinv * v_cycle(hier, scinv * rt, h1, h2, config)
    return lambda r: v_cycle(hier, r, h1, h2, config)


def mg_ops(problem: Problem, a, b, aux, hier: MGLevels,
           config: MGConfig = DEFAULT_MG, scaled: bool = True,
           members: bool = False) -> PCGOps:
    """The MG-preconditioned ops bundle: the plain bundle (with
    ``members``, the batched one) with ``apply_Dinv`` replaced by one
    V-cycle. Operator, dots and norms are untouched, so the outer CG
    recurrence is the Jacobi one with a stronger M⁻¹."""
    base = (scaled_single_device_ops(problem, a, b, aux, members)
            if scaled else single_device_ops(problem, a, b, aux, members))
    return base._replace(
        apply_Dinv=vcycle_preconditioner(problem, hier, config, scaled))


def mg_solve_setup(problem: Problem, dtype=None, scaled=None, device=None,
                   members: bool = False,
                   config: MGConfig = DEFAULT_MG,
                   geometry=None) -> SolveSetup:
    """``solvers.pcg.solve_setup`` with the V-cycle in ``apply_Dinv``, on
    the cached hierarchy of ``problem`` (and ``geometry``, whose canvases
    both the operator and the hierarchy are built from) on the same
    device."""
    setup = solve_setup(problem, dtype, scaled, device, members,
                        geometry=geometry)
    hier = device_hierarchy(problem, setup.dtype_name, setup.scaled,
                            geometry=geometry, config=config,
                            device=setup.rhs.device)
    return setup._replace(
        ops=setup.ops._replace(apply_Dinv=vcycle_preconditioner(
            problem, hier, config, setup.scaled)),
        check_every=CHECK_EVERY_MG, preconditioner="mg")
