"""Checkpoint and resume for the plain sharded solve (counterpart of
``poisson_tpu/parallel/checkpoint_sharded.py``).

The sharded PCG loop (``parallel.pcg_sharded``) runs as chunks of the
shared body, and at every chunk boundary the CG state, gathered from the
shards' owned interiors, is written in the full-grid ``.npz`` format every
checkpointed solver of both packages writes (``solvers.checkpoint``: the
same keys, dtypes, fingerprint and CRC). So a solve interrupted on one mesh
resumes on another mesh shape, on a single device
(``solvers.checkpoint.pcg_solve_checkpointed``) or in the JAX package, and
theirs here.

Why the owned interiors are the whole state: r and z are masked to the
owned interior every iteration, so their rings stay zero, and p's ring is
refreshed before it is read (the Jacobi loop exchanges p at the top of the
body; the scaled operator exchanges sc·p inside A). w's ring is never read.
Blocks rebuilt with zero rings on resume therefore continue the solve
exactly, and a chunked solve equals its one-shot solve bit for bit (its
chunks carry the in-memory state on).

Over processes (the JAX module's multi-process arm): on a mesh whose
shards several processes hold (``parallel.multihost``), the state is
gathered to every process at a chunk boundary (``gather_interior``), only
the primary writes, and a barrier (:func:`_sync`) orders the write before
any process's later read and the converged run's cleanup before any later
solve. A resume reads the file on every process and scatters each its own
shards. The file is the same, so a file written by several processes
resumes in one, on another mesh or in the JAX package, and theirs here.
``watchdog`` and ``on_chunk`` take any object with the methods
``run_chunked`` calls.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.parallel.mesh import Mesh
from poisson_tpu_torch.parallel.multihost import is_primary, world_size
from poisson_tpu_torch.parallel.pcg_sharded import (
    ShardGeometry,
    gather_interior,
    geometry,
    resolve_mesh,
    scatter_interior,
    sharded_fields,
    sharded_ops,
)
from poisson_tpu_torch.solvers.checkpoint import (
    _fingerprint,
    load_state,
    run_chunked,
)
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGResult,
    PCGState,
    chunked_advance,
    init_state,
    make_pcg_body,
    resolve_dtype,
    resolve_scaled,
)

_FIELDS = ("w", "r", "z", "p")


def _multiprocess() -> bool:
    return world_size() > 1


def _sync(name: str) -> None:
    """Cross-process barrier: orders the primary's file write (or removal)
    before any other process's later read. A no-op in one process; ``name``
    labels the point, as the JAX module's barrier does."""
    if _multiprocess():
        dist.barrier()


def portable_state(problem: Problem, mesh: Mesh, geo: ShardGeometry,
                   state: PCGState) -> PCGState:
    """A sharded state → the portable full-grid state (the owned interiors
    gathered; scalars as they are)."""
    return state._replace(**{
        name: gather_interior(problem, mesh, geo, getattr(state, name))
        for name in _FIELDS})


def pcg_solve_sharded_checkpointed(problem: Problem, mesh: Mesh | None,
                                   checkpoint_path: str, chunk: int = 200,
                                   dtype=None, scaled=None,
                                   keep_checkpoint: bool = False,
                                   keep_last: int = 2,
                                   stagnation_window: int = 0,
                                   watchdog=None, on_chunk=None,
                                   device=None,
                                   check_every: int = CHECK_EVERY
                                   ) -> PCGResult:
    """The plain sharded solve (host setup) with its state written every
    ``chunk`` iterations and resumed from ``checkpoint_path`` when a
    trustworthy file for this problem exists, written by any mesh shape,
    the single-device solver or either package; an older generation is
    used when the newest is corrupt. A converged run removes its files
    unless ``keep_checkpoint``; a cap-hit or a divergence keeps them.
    ``mesh``/``device`` as in ``pcg_solve_sharded``."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    mesh = resolve_mesh(mesh, device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    geo = geometry(problem, mesh)
    fields = sharded_fields(problem, mesh, geo, dtype_name, use_scaled)
    ops = sharded_ops(problem, mesh, geo, fields, use_scaled)
    body = make_pcg_body(ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm, h1=problem.h1,
                         h2=problem.h2, stagnation_window=stagnation_window)
    fp = _fingerprint(problem, dtype_name, use_scaled)
    tdtype = getattr(torch, dtype_name)
    lead = mesh.lead

    saved = load_state(checkpoint_path, fp, keep_last=keep_last)
    if saved is None:
        state = init_state(ops, fields.rhs)
    else:
        state = saved._replace(
            **{name: scatter_interior(problem, mesh, geo,
                                      getattr(saved, name).numpy(), tdtype)
               for name in _FIELDS},
            **{name: getattr(saved, name).to(lead)
               for name in PCGState._fields if name not in _FIELDS})

    def to_portable(s: PCGState) -> PCGState:
        # The gather is the costly part of a sharded checkpoint: its span
        # shows a slow one on the timeline (the JAX module's span).
        with obs.span("checkpoint.gather", fence=False,
                      mesh=f"{mesh.px}x{mesh.py}"):
            return portable_state(problem, mesh, geo, s)

    cap = problem.iteration_cap
    state = run_chunked(
        state,
        advance=chunked_advance(body, chunk, cap, check_every),
        to_portable=to_portable,
        path=checkpoint_path, fingerprint=fp,
        cap=cap, keep_checkpoint=keep_checkpoint, primary=is_primary,
        sync=_sync, keep_last=keep_last, watchdog=watchdog,
        on_chunk=on_chunk)
    w = state.w * fields.aux if use_scaled else state.w
    return PCGResult(w=gather_interior(problem, mesh, geo, w),
                     iterations=state.k, diff=state.diff,
                     residual_dot=state.zr, flag=state.flag)
