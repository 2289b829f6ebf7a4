"""The sharded communication-avoiding (s=2) solve: kernels C and D on every
shard of a device mesh (counterpart of the one-shot solve of
``poisson_tpu/parallel/pallas_ca_sharded.py``).

Per pair of iterations: one basis sweep (kernel C) and one pair update
(kernel D) on each shard, one mesh-wide sum of the 12-entry Gram vector and
one of Σ r'², and two width-2 halo exchanges.

**Width-2 halos, corners included.** The basis sweep applies the stencil
twice: t2 at an owned point reads t1 at ±1, which reads pn at ±2 and at the
(±1, ±1) diagonals. So a shard needs its r and p_prev rings fresh at depth
2 and at the corners. The exchange copies rows first and then columns over
the full canvas height, so the corner blocks arrive in two hops (row
neighbour, then column neighbour). The fused path's r-only exchange does
not carry over to s=2: forming p₁'s ring locally would need t1 there,
which needs pn on a ring that grows by one per pair, so both r and p₁ are
exchanged.

Shard canvas layout: the fused layout (``parallel.fused_sharded``) with a
ring of 2: owned column lj sits at canvas column 2 + lj, with two halo
columns on each side. Kernel C forms pn on a band two rows wider than the
owned rows on each side, so pn is real on the ring; the column mask keeps
the halo columns out of the unweighted Gram sums and of Σ r'², and sc² is
zero outside the owned points, which keeps them out of the weighted ones.

Kernel D writes p₁ = pn itself when a pair applied its first step only, so
the JAX driver's select (``pallas_ca_sharded.py:229``) has no counterpart.

Checkpointed (:func:`ca_cg_solve_sharded_checkpointed`, the counterpart of
``pallas_ca_sharded.ca_cg_solve_sharded_checkpointed``): the pending pair
(p_prev, β) is saved as the direction d = r + β·p_prev in the portable
format and resumed as p_prev := d − r, β := 1, with r's and p_prev's
width-2 rings refreshed once, as the single-device CA driver and the JAX
package resume it. Over processes the checkpointed driver is the entry
point (the ring-2 exchange and the 12-entry Gram sum cross between ranks,
``parallel.halo``); the one-shot :func:`ca_cg_solve_sharded` refuses such
a mesh, as in the JAX package.
"""

from __future__ import annotations

import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.ca_cg import (
    CA_BUFFERS,
    _CAState,
    assemble_pair_state,
    basis_sweep,
    pair_scalars,
    pair_update,
)
from poisson_tpu_torch.ops.fused_cg import HALO
from poisson_tpu_torch.parallel.fused_sharded import (
    ShardCanvases,
    ShardSpec,
    gated_rhs,
    gather_owned,
    owned_sum_of_squares,
    resumed_canvases,
    shard_canvases,
    shard_run,
    shard_spec,
    sharded_portable,
    single_process,
)
from poisson_tpu_torch.parallel.halo import (
    mesh_sum,
    replicate,
    shift_both,
)
from poisson_tpu_torch.parallel.mesh import X_AXIS, Y_AXIS, Mesh
from poisson_tpu_torch.parallel.checkpoint_sharded import _sync
from poisson_tpu_torch.parallel.mesh import make_solver_mesh
from poisson_tpu_torch.parallel.multihost import is_primary
from poisson_tpu_torch.solvers.checkpoint import (
    _fingerprint,
    load_state,
    run_chunked,
)
from poisson_tpu_torch.solvers.pcg import CHECK_EVERY, PCGResult, drive

RING = 2   # halo ring width (the s=2 stencil depth) = first owned column


def ca_shard_spec(problem: Problem, px: int, py: int) -> ShardSpec:
    """The CA shard geometry: ``pallas_ca_sharded.ca_shard_spec``."""
    return shard_spec(problem, px, py, RING)


def exchange_ring2(u, spec: ShardSpec, mesh: Mesh) -> None:
    """Refresh the width-2 halo ring of every shard's canvas, in place: rows
    first, then columns over the full canvas height, so the corner blocks
    arrive in two hops. Mesh-edge shards get zeros, the Dirichlet value."""
    lo, hi = HALO, HALO + spec.m_blk
    c0, c1 = RING, RING + spec.n_blk
    every = slice(None)
    shift_both(u, mesh, X_AXIS, ((slice(hi - RING, hi), every),
                                 (slice(lo - RING, lo), every)),
               ((slice(lo, lo + RING), every),
                (slice(hi, hi + RING), every)))
    shift_both(u, mesh, Y_AXIS, ((every, slice(c1 - RING, c1)),
                                 (every, slice(c0 - RING, c0))),
               ((every, slice(c0, c0 + RING)),
                (every, slice(c1, c1 + RING))))


def _ca_sharded_init(problem: Problem, spec: ShardSpec, mesh: Mesh,
                     canvases: ShardCanvases, rhs) -> _CAState:
    """x=0, r=b̃ (a copy, its 2-ring seeded by the rhs canvas), β=0: the
    first basis sweep forms pn ← r₀, real on the ring. Scalars live on the
    lead device, canvases are per-shard tuples."""
    lead = mesh.lead
    f32 = dict(dtype=torch.float32, device=lead)
    zeros = lambda: tuple(torch.zeros_like(x) for x in rhs)
    return _CAState(
        k=torch.zeros((), dtype=torch.int32, device=lead),
        done=torch.zeros((), dtype=torch.bool, device=lead),
        x=zeros(), r=tuple(x.clone() for x in rhs), pprev=zeros(),
        rr=owned_sum_of_squares(problem, spec, mesh, canvases, rhs),
        beta=torch.zeros((), **f32),
        diff=torch.full((), float("inf"), **f32),
    )


def _make_ca_sharded_body(problem: Problem, spec: ShardSpec, mesh: Mesh,
                          canvases: ShardCanvases, run: int | None = None):
    """One CA pair on every shard as a state→state function
    (``pallas_ca_sharded._make_ca_shard_body``). A state that is done or has
    reached the cap is frozen, as in ``ops.ca_cg._make_ca_body``: kernel D
    gets zero coefficients, so x and r keep their values, and the scalars
    are kept. ``run`` selects the serial-reduce mode."""
    cv = spec.cv
    f = canvases
    cap = problem.iteration_cap
    h1h2 = torch.tensor(problem.h1 * problem.h2, dtype=torch.float32,
                        device=mesh.lead)
    band = (HALO - RING, HALO + spec.m_blk + RING)
    shards = range(len(mesh.local))
    # Kernel outputs, allocated zeroed once: rows past the ring stay zero.
    scratch = [tuple(torch.zeros_like(c) for _ in range(4)) for c in f.cs]
    p1_bufs = tuple(torch.zeros_like(c) for c in f.cs)

    def body(s: _CAState) -> _CAState:
        live = (~s.done) & (s.k < cap)
        betas = replicate(s.beta, mesh)
        swept = [basis_sweep(cv, betas[i], s.pprev[i], s.r[i], f.cs[i],
                             f.cw[i], f.g[i], f.sc2[i], out=scratch[i],
                             band=band, colmask=f.colmask[i])
                 for i in shards]
        gsum = mesh_sum([c[4] for c in swept], mesh, run) * h1h2
        d = pair_scalars(problem, s.rr, s.k, gsum)
        coefs = replicate(torch.where(live, d.coefs, 0.0), mesh)
        parts = [pair_update(cv, coefs[i], *swept[i][:4], s.x[i], s.r[i],
                             out=p1_bufs[i], colmask=f.colmask[i])[3]
                 for i in shards]
        rr2 = mesh_sum(parts, mesh, run) * h1h2
        exchange_ring2(s.r, spec, mesh)
        exchange_ring2(p1_bufs, spec, mesh)
        new = assemble_pair_state(problem, s, d, s.x, s.r, p1_bufs, rr2)
        return new._replace(**{
            name: torch.where(live, getattr(new, name), getattr(s, name))
            for name in ("k", "done", "rr", "beta", "diff")})

    return body


def _ca_sharded_solve(problem: Problem, spec: ShardSpec, mesh: Mesh,
                      canvases: ShardCanvases, rhs,
                      check_every: int = CHECK_EVERY,
                      run: int | None = None) -> _CAState:
    """The sharded CA solve on given shard canvases. A pair advances k by at
    most 2, so (cap + 1) // 2 pairs always reach the cap."""
    body = _make_ca_sharded_body(problem, spec, mesh, canvases, run)
    s = _ca_sharded_init(problem, spec, mesh, canvases, rhs)
    return drive(body, s, (problem.iteration_cap + 1) // 2, check_every)


def ca_cg_solve_sharded(problem: Problem, mesh: Mesh | None = None,
                        rhs_gate=None,
                        check_every: int = CHECK_EVERY,
                        serial: bool | None = None) -> PCGResult:
    """Sharded solve on the communication-avoiding path (fp32, scaled
    system): the counterpart of ``poisson_tpu.parallel.pallas_ca_sharded
    .ca_cg_solve_sharded``, with the same counts as every other path.
    ``mesh`` defaults to every visible card; a mesh of CPU devices runs the
    kernels' plain versions. ``rhs_gate`` and ``serial`` as in
    :func:`~poisson_tpu_torch.parallel.fused_sharded.fused_cg_solve_sharded`.
    One process drives the mesh, as the JAX one-shot solve does: a mesh
    over processes runs on :func:`ca_cg_solve_sharded_checkpointed`."""
    mesh = make_solver_mesh() if mesh is None else mesh
    single_process(mesh, "ca_cg_solve_sharded",
                   "ca_cg_solve_sharded_checkpointed")
    spec, canvases = shard_canvases(problem, mesh, RING)
    s = _ca_sharded_solve(problem, spec, mesh, canvases,
                          gated_rhs(canvases, rhs_gate), check_every,
                          shard_run(problem, spec, mesh, serial, CA_BUFFERS))
    x = gather_owned(problem, spec, mesh, s.x, canvases.sc_int)
    return PCGResult(w=x, iterations=s.k, diff=s.diff, residual_dot=s.rr)


def ca_cg_solve_sharded_checkpointed(problem: Problem, mesh: Mesh | None,
                                     checkpoint_path: str, chunk: int = 200,
                                     serial: bool | None = None,
                                     keep_checkpoint: bool = False,
                                     keep_last: int = 2,
                                     check_every: int = CHECK_EVERY
                                     ) -> PCGResult:
    """The sharded CA solve with its state saved every ``chunk`` iterations
    and resumed from ``checkpoint_path``: the counterpart of
    ``pallas_ca_sharded.ca_cg_solve_sharded_checkpointed``, in the portable
    format, so a CA file resumes on the fused paths and theirs here. A
    chunk runs pairs until k reaches min(k + chunk, cap), so it may
    overshoot by one iteration; only the global cap cuts a pair short, and
    chunking changes no iterate. ``serial`` as in
    :func:`ca_cg_solve_sharded`."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    mesh = make_solver_mesh() if mesh is None else mesh
    spec, canvases = shard_canvases(problem, mesh, RING)
    fp = _fingerprint(problem, "float32", True)
    saved = load_state(checkpoint_path, fp, keep_last=keep_last)
    if saved is None:
        s = _ca_sharded_init(problem, spec, mesh, canvases, canvases.rhs)
    else:
        f = resumed_canvases(problem, spec, mesh, saved, exchange_ring2)
        s = _CAState(k=f["k"], done=f["done"], x=f["w"], r=f["r"],
                     pprev=tuple(d - r for d, r in zip(f["d"], f["r"])),
                     rr=f["zr"], beta=torch.ones_like(f["zr"]),
                     diff=f["diff"])
    body = _make_ca_sharded_body(
        problem, spec, mesh, canvases,
        shard_run(problem, spec, mesh, serial, CA_BUFFERS))
    cap = problem.iteration_cap

    def advance(st: _CAState) -> _CAState:
        # Pairs to reach min(k + chunk, cap): non-final pairs add 2.
        stop_at = min(int(st.k) + chunk, cap)
        return drive(body, st, -(-(stop_at - int(st.k)) // 2), check_every)

    s = run_chunked(
        s, advance=advance,
        to_portable=lambda st: sharded_portable(
            problem, spec, mesh, k=st.k, done=st.done, sol=st.x, r=st.r,
            pend=st.pprev, beta=st.beta, zr=st.rr, diff=st.diff),
        path=checkpoint_path, fingerprint=fp, cap=cap,
        keep_checkpoint=keep_checkpoint, primary=is_primary, sync=_sync,
        keep_last=keep_last)
    x = gather_owned(problem, spec, mesh, s.x, canvases.sc_int)
    return PCGResult(w=x, iterations=s.k, diff=s.diff, residual_dot=s.rr)
