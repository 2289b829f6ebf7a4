"""The sharded fused solve: kernels A and B on every shard of a device mesh,
halos copied between shard canvases, sums taken in mesh order (counterpart of
the one-shot solve of ``poisson_tpu/parallel/pallas_sharded.py``).

This is the reference's last stage, accelerator kernels per rank with halo
exchange and all-reduced scalars (MPI+CUDA,
``stage4-mpi+cuda/poisson_mpi_cuda_f.cu:688-983``), in the JAX package's
design: the halo exchange moves from p to r. Kernel A forms the direction
p ← z + β·p inside its stencil sweep, so a shard whose r and old p are fresh
on its halo ring can form its neighbours' edge values of the new p itself,
and β is the same on every shard. Kernel A's sharded form widens its live
band by one row on each side and stores the direction there, which is the
row its neighbour formed for its own edge, with the same two roundings; so
p's halos stay fresh without ever being exchanged, provided r's halo ring
is refreshed once per iteration (four slice copies per shard). Each
iteration has three mesh-wide sums: ⟨Ap, p⟩, Σ p²·sc² and Σ r².

Shard canvas layout (the JAX package's, with the owned rows rounded up to 8
where JAX rounds them to its strip height; the port's canvas is one strip):

  - the shard (ix, iy) owns m̂ interior rows × n̂ interior columns, with
    m̂ = ⌈(M−1)/Px⌉ rounded up to a multiple of 8 and n̂ = ⌈(N−1)/Py⌉;
  - canvas row HALO+li ↔ global grid row ix·m̂+1+li; canvas column lj ↔
    global grid column iy·n̂+lj, so columns 0 and n̂+1 are the halo columns
    (the CA layout, ``parallel.ca_sharded``, has a ring of 2);
  - the halo columns lie inside the rows the kernels sum over, so their
    sums take a (1, cols) column mask; the halo rows lie outside them;
  - canvas columns past the halo (the padding to 128) are zero in every
    coefficient canvas: on a shard they would otherwise hold a further
    neighbour's data.

Padded rows and columns have zero scaled coefficients and zero right-hand
side, so p, Ap and r stay zero there through every sweep.

Checkpointed (:func:`fused_cg_solve_sharded_checkpointed`, the counterpart
of ``pallas_sharded.pallas_cg_solve_sharded_checkpointed``): every chunk
runs the same step through ``solvers.pcg.drive``, and the state is saved
in the portable full-grid format (``solvers.checkpoint``) gathered from the
shards' owned points, with the direction d = r + β·p the next sweep would
form. A resumed solve scatters w, r and d back with zero rings, refreshes
the rings of r and d once, and forms its first direction from d itself
(z := d, p := 0, β := 0), so it continues the solve that wrote the file
bit for bit; the JAX package resumes as p := d − r, β := 1, one ulp off.

Over processes (``parallel.multihost``) the checkpointed driver is the
entry point, as in the JAX package: each rank launches A and B on its own
shards with the same (spec, colmask), r's halo slices bound for another
rank travel by point-to-point transfer, the three sums all-gather the
per-shard sums (``parallel.halo``), the state is gathered to every rank
and the primary writes it. The one-shot :func:`fused_cg_solve_sharded`
refuses such a mesh.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops.fused_cg import (
    HALO,
    LANE,
    SUBLANE,
    Canvas,
    diagonal_residual_canvas,
    direction_and_stencil,
    fused_update,
    portable_state,
    scaled_stencil_fields,
    serial_run,
)
from poisson_tpu_torch.ops.recurrence import Recurrence
from poisson_tpu_torch.parallel.checkpoint_sharded import _sync
from poisson_tpu_torch.parallel.halo import (
    gather_shards,
    mesh_sum,
    mesh_sums,
    replicate,
    shift_both,
)
from poisson_tpu_torch.parallel.mesh import X_AXIS, Y_AXIS, Mesh, block_size
from poisson_tpu_torch.parallel.mesh import check_mesh, make_solver_mesh
from poisson_tpu_torch.parallel.multihost import is_primary
from poisson_tpu_torch.solvers.checkpoint import (
    _fingerprint,
    load_state,
    run_chunked,
)
from poisson_tpu_torch.solvers.graphs import can_capture, marked
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGResult,
    PCGState,
    chunked_advance,
    drive,
)


class ShardSpec(NamedTuple):
    """Static per-shard canvas geometry."""

    cv: Canvas
    m_blk: int   # owned interior rows per shard (a multiple of SUBLANE)
    n_blk: int   # owned interior cols per shard
    ring: int    # halo ring width: the first owned canvas column


def shard_spec(problem: Problem, px: int, py: int, ring: int = 1
               ) -> ShardSpec:
    """The shard geometry of ``problem`` on a px × py mesh with a halo ring
    of ``ring`` (1 for the fused solve, 2 for the CA solve)."""
    n_blk = block_size(problem.N - 1, py)
    if n_blk < ring:
        raise ValueError(f"{problem.N - 1} interior columns over {py} shards "
                         f"leave fewer than the {ring} a halo ring needs")
    cols = ((n_blk + 2 * ring + LANE - 1) // LANE) * LANE
    m_blk = -(-block_size(problem.M - 1, px) // SUBLANE) * SUBLANE
    cv = Canvas(bm=m_blk, nb=1, rows=m_blk + 2 * HALO, cols=cols)
    return ShardSpec(cv=cv, m_blk=m_blk, n_blk=n_blk, ring=ring)


class ShardCanvases(NamedTuple):
    """Per-shard canvases, each a tuple in mesh order (shard ix·py + iy).

    cs, cw, g, rhs, sc2: (rows, cols); sc_int: (m̂, n̂), the scaling of the
    owned points for extracting the solution; colmask: (1, cols), 1 on the
    owned columns."""

    cs: tuple
    cw: tuple
    g: tuple
    rhs: tuple
    sc2: tuple
    sc_int: tuple
    colmask: tuple


def _stack(field, spec: ShardSpec, px: int, py: int) -> np.ndarray:
    """The (px·py, rows, cols) shard canvases of a full-grid field: canvas
    (row w, col c) of shard (ix, iy) holds grid point (ix·m̂ + w − HALO + 1,
    iy·n̂ + c − ring + 1), zero off the grid, from canvas row HALO − ring
    down; the columns past the halo ring are zero."""
    cv, m_blk, n_blk, ring = spec
    M1, N1 = field.shape
    w0 = HALO - ring
    height = (px - 1) * m_blk + 1 + cv.rows - w0
    width = (py - 1) * n_blk + 1 + cv.cols
    big = np.zeros((max(height, ring + M1), max(width, ring + N1)))
    big[ring : ring + M1, ring : ring + N1] = field
    out = np.zeros((px * py, cv.rows, cv.cols))
    for ix in range(px):
        for iy in range(py):
            r0, c0 = ix * m_blk + 1, iy * n_blk + 1
            out[ix * py + iy, w0:, :] = big[r0 : r0 + cv.rows - w0,
                                            c0 : c0 + cv.cols]
    out[:, :, n_blk + 2 * ring :] = 0.0
    return out


@functools.lru_cache(maxsize=8)
def host_shard_canvases(problem: Problem, spec: ShardSpec, px: int, py: int):
    """Host fp64 setup → stacked shard canvases (numpy): a dict of cs, cw,
    g, rhs, sc2 of shape (px·py, rows, cols), sc_int (px·py, m̂, n̂) and
    colmask (1, cols). The counterpart of ``pallas_sharded._shard_canvases``
    (ring 1) and ``pallas_ca_sharded._ca_shard_canvases`` (ring 2).

    rhs keeps its neighbours' values on the halo ring: that ring seeds r's
    (and through p₀ = r₀, p's) halos at iteration 0. sc² is a weight of the
    sums only and is zeroed outside the owned columns; the CA layout also
    zeroes it outside the owned rows, as its JAX builder does (the fused
    layout's halo rows of sc² lie outside every sum)."""
    gcs, gcw, sc2_64, rhs64, sc64 = scaled_stencil_fields(problem)
    ring, m_blk, n_blk = spec.ring, spec.m_blk, spec.n_blk
    cs = _stack(gcs, spec, px, py)
    cw = _stack(gcw, spec, px, py)
    g = np.stack([diagonal_residual_canvas(cs[s], cw[s])
                  for s in range(px * py)])
    sc2 = _stack(sc2_64, spec, px, py)
    sc2[:, :, :ring] = 0.0
    sc2[:, :, ring + n_blk :] = 0.0
    if ring > 1:
        sc2[:, :HALO] = 0.0
        sc2[:, HALO + m_blk :] = 0.0
    sc_int = np.zeros((px * py, m_blk, n_blk))
    for ix in range(px):
        for iy in range(py):
            blk = sc64[1 + ix * m_blk : 1 + (ix + 1) * m_blk,
                       1 + iy * n_blk : 1 + (iy + 1) * n_blk]
            sc_int[ix * py + iy, : blk.shape[0], : blk.shape[1]] = blk
    colmask = np.zeros((1, spec.cv.cols))
    colmask[0, ring : ring + n_blk] = 1.0
    out = dict(cs=cs, cw=cw, g=g, rhs=_stack(rhs64, spec, px, py), sc2=sc2,
               sc_int=sc_int, colmask=colmask)
    for arr in out.values():
        arr.flags.writeable = False
    return out


def to_shards(arrays: dict, devices, shards=None) -> ShardCanvases:
    """Stacked numpy canvases → per-shard fp32 tensors: shard
    ``shards[i]`` (default: shard i) on ``devices[i]``; the column mask
    goes to every listed shard's device."""
    shards = range(len(devices)) if shards is None else shards

    def split(x):
        return tuple(torch.tensor(np.asarray(x[s]), dtype=torch.float32,
                                  device=d) for s, d in zip(shards, devices))

    mask = np.asarray(arrays["colmask"])
    return ShardCanvases(
        *(split(arrays[k]) for k in ("cs", "cw", "g", "rhs", "sc2",
                                     "sc_int")),
        colmask=tuple(torch.tensor(mask, dtype=torch.float32, device=d)
                      for d in devices))


def shard_canvases(problem: Problem, mesh: Mesh, ring: int = 1):
    """(spec, canvases) of ``problem`` on ``mesh``, one canvas per shard
    this process drives (every shard in one process), cached per (problem,
    mesh, ring) and shared: callers must not write to them."""
    return _shard_canvases(problem, check_mesh(mesh), ring)[:2]


@functools.lru_cache(maxsize=8)
def _shard_canvases(problem: Problem, mesh: Mesh, ring: int):
    """(spec, canvases, the marked sharded bodies made on them), the
    bodies cached with the canvases (:func:`_make_sharded_body`)."""
    spec = shard_spec(problem, mesh.px, mesh.py, ring)
    host = host_shard_canvases(problem, spec, mesh.px, mesh.py)
    return spec, to_shards(host, [mesh.devices[s] for s in mesh.local],
                           mesh.local), {}


def single_process(mesh: Mesh, name: str, instead: str) -> None:
    """Refuse a mesh over processes on a one-shot driver (``name``), as
    the JAX package's one-shot sharded solves are single-process."""
    if mesh.multiprocess:
        raise ValueError(f"{name} drives its mesh from one process; a mesh "
                         f"over processes runs on {instead}")


def gated_rhs(canvases: ShardCanvases, rhs_gate) -> tuple:
    """The shards' right-hand sides, multiplied by ``rhs_gate`` in fp32 if
    one is given (1.0 leaves them bit for bit)."""
    if rhs_gate is None:
        return canvases.rhs
    return tuple(x * torch.as_tensor(rhs_gate, dtype=x.dtype,
                                     device=x.device) for x in canvases.rhs)


def owned_sum_of_squares(problem: Problem, spec: ShardSpec, mesh: Mesh,
                         canvases: ShardCanvases, rhs) -> torch.Tensor:
    """Σ b̃² over the owned points, times h1·h2: ζ₀ of both sharded solves."""
    lo, hi = HALO, HALO + spec.m_blk
    parts = [(c[lo:hi] * c[lo:hi] * m).reshape(-1)
             for c, m in zip(rhs, canvases.colmask)]
    return mesh_sum(parts, mesh) * torch.tensor(
        problem.h1 * problem.h2, dtype=torch.float32, device=mesh.lead)


def gather_owned(problem: Problem, spec: ShardSpec, mesh: Mesh, canvases,
                 sc_int) -> torch.Tensor:
    """Each shard's owned points times its scaling → the full (M+1, N+1)
    solution grid on the lead device (zero ring); on a mesh over
    processes, gathered to every rank."""
    lo, hi = HALO, HALO + spec.m_blk
    c0 = spec.ring
    owned = [u[lo:hi, c0 : c0 + spec.n_blk] * s
             for u, s in zip(canvases, sc_int)]
    if mesh.multiprocess:
        owned = list(gather_shards(owned, mesh))
    rows = [torch.cat([owned[ix * mesh.py + iy].to(mesh.lead)
                       for iy in range(mesh.py)], dim=1)
            for ix in range(mesh.px)]
    w_int = torch.cat(rows, dim=0)
    return F.pad(w_int[: problem.M - 1, : problem.N - 1], (1, 1, 1, 1))


def exchange_r_halo(r, spec: ShardSpec, mesh: Mesh) -> None:
    """Refresh the width-1 halo ring of every shard's r, in place: four
    slice copies (the reference's four MPI messages, but of r, see the
    module doc). Mesh-edge shards get zeros, the Dirichlet value."""
    lo, hi = HALO, HALO + spec.m_blk
    every = slice(None)
    shift_both(r, mesh, X_AXIS, ((hi - 1, every), (lo - 1, every)),
               ((lo, every), (hi, every)))
    shift_both(r, mesh, Y_AXIS, ((every, spec.n_blk), (every, 0)),
               ((every, 1), (every, spec.n_blk + 1)))


class _ShardedState(NamedTuple):
    k: torch.Tensor      # iterations counted (0-d int32, lead device)
    done: torch.Tensor   # converged or degenerate (0-d bool, lead device)
    w: tuple             # per-shard canvases from here to ``ap``
    r: tuple
    z: tuple             # what kernel A forms the direction from: r itself,
                         # except on the first step of a resumed solve
    p: tuple             # previous direction; β is applied at the top of A
    spare: tuple         # the other half of p's ping-pong pair
    ap: tuple
    zr: torch.Tensor     # ζ = Σ r² · h1h2 over the owned points
    beta: torch.Tensor
    diff: torch.Tensor


def _sharded_init(problem: Problem, spec: ShardSpec, mesh: Mesh,
                  canvases: ShardCanvases, rhs) -> _ShardedState:
    """w=0, r=b̃ (a copy, halo ring seeded by the rhs canvas), p=0 with β=0:
    the first sweep forms p ← z + 0·p = r₀, halo rows included."""
    lead = mesh.lead
    f32 = dict(dtype=torch.float32, device=lead)
    zeros = lambda: tuple(torch.zeros_like(x) for x in rhs)
    r = tuple(x.clone() for x in rhs)
    return _ShardedState(
        k=torch.zeros((), dtype=torch.int32, device=lead),
        done=torch.zeros((), dtype=torch.bool, device=lead),
        w=zeros(), r=r, z=r, p=zeros(),
        spare=zeros(), ap=zeros(),
        zr=owned_sum_of_squares(problem, spec, mesh, canvases, rhs),
        beta=torch.zeros((), **f32),
        diff=torch.full((), float("inf"), **f32),
    )


def shard_run(problem: Problem, spec: ShardSpec, mesh: Mesh, serial,
              buffers: int = 12) -> int | None:
    """Kernel S's run length on each shard when ``serial`` is true: the
    partials of one JAX shard strip of ``strip_height(cols, ⌈(M−1)/px⌉,
    buffers)`` rows (``pallas_sharded.py:86``, ``pallas_ca_sharded.py:96``)."""
    if not serial:
        return None
    return serial_run(spec.cv, -(-(problem.M - 1) // mesh.px), buffers)


def _make_sharded_body(problem: Problem, spec: ShardSpec, mesh: Mesh,
                       canvases: ShardCanvases, run: int | None = None):
    """One sharded fused iteration as a state→state function
    (``pallas_sharded._make_shard_body``). A done state is frozen, as in
    ``ops.fused_cg._make_fused_body``: α is forced to 0, so w and r keep
    their values (the halo exchange of an unchanged r changes nothing), and
    k, ζ, β and diff keep theirs. ``run`` selects the serial-reduce mode
    (:func:`~poisson_tpu_torch.parallel.halo.mesh_sum`).

    On a mesh of one process whose every shard's device
    ``solvers.graphs.can_capture``, a body on the canvases
    :func:`shard_canvases` caches is marked ``capturable``: ``drive``
    replays each whole block of it as one captured graph, across every
    card of the mesh, and a replay adds the mesh's traffic counters
    (``parallel.halo``) as the eager block would. The marked body is
    cached with the canvases, per ``run``, so that its captured blocks
    serve every solve on them. A mesh over processes (gloo moves host
    tensors, which no graph can capture) and a mesh of CPU devices run the
    unmarked body."""
    make = lambda: _sharded_body(problem, spec, mesh, canvases, run)
    devices = [mesh.devices[i] for i in mesh.local]
    if mesh.multiprocess or not all(can_capture(d) for d in devices):
        return make()
    _, cached, bodies = _shard_canvases(problem, mesh, spec.ring)
    if canvases is not cached:
        return make()
    return marked(bodies, run, make)


def _sharded_body(problem: Problem, spec: ShardSpec, mesh: Mesh,
                  canvases: ShardCanvases, run: int | None):
    """The body :func:`_make_sharded_body` describes, unmarked."""
    cv = spec.cv
    f = canvases
    rec = Recurrence(problem, mesh.lead)
    band = (HALO - 1, HALO + spec.m_blk + 1)   # owned rows + halo rows
    shards = range(len(mesh.local))

    def body(s: _ShardedState) -> _ShardedState:
        betas = replicate(s.beta, mesh)
        swept = [direction_and_stencil(cv, betas[i], s.z[i], s.p[i], f.cs[i],
                                       f.cw[i], f.g[i],
                                       out=(s.spare[i], s.ap[i]), band=band,
                                       colmask=f.colmask[i])
                 for i in shards]
        alpha, degenerate = rec.step_size(
            s, mesh_sum([part for _, _, part in swept], mesh, run))
        alphas = replicate(alpha, mesh)
        updated = [fused_update(cv, alphas[i], swept[i][0], swept[i][1],
                                f.sc2[i], s.w[i], s.r[i],
                                colmask=f.colmask[i])
                   for i in shards]
        if run is None:
            diff_sum, zr_sum = mesh_sums([[u[2] for u in updated],
                                          [u[3] for u in updated]], mesh)
        else:
            diff_sum, zr_sum = mesh_sum([u[2:] for u in updated], mesh,
                                        run).unbind()
        exchange_r_halo(s.r, spec, mesh)
        return _ShardedState(
            w=s.w, r=s.r, z=s.r, p=tuple(pn for pn, _, _ in swept),
            spare=s.p, ap=s.ap,
            **rec.close(s, alpha, degenerate, diff_sum, zr_sum))

    return body


def _sharded_solve(problem: Problem, spec: ShardSpec, mesh: Mesh,
                   canvases: ShardCanvases, rhs,
                   check_every: int = CHECK_EVERY,
                   run: int | None = None) -> _ShardedState:
    """The sharded fused solve on given shard canvases."""
    body = _make_sharded_body(problem, spec, mesh, canvases, run)
    s = _sharded_init(problem, spec, mesh, canvases, rhs)
    return drive(body, s, problem.iteration_cap, check_every)


def fused_cg_solve_sharded(problem: Problem, mesh: Mesh | None = None,
                           rhs_gate=None,
                           check_every: int = CHECK_EVERY,
                           serial: bool | None = None) -> PCGResult:
    """Sharded solve on the fused path (fp32, scaled system): the
    counterpart of ``poisson_tpu.parallel.pallas_sharded
    .pallas_cg_solve_sharded``. ``mesh`` defaults to every visible card
    (:func:`~poisson_tpu_torch.parallel.mesh.make_solver_mesh`); a mesh of
    CPU devices runs the kernels' plain versions. ``rhs_gate``, if given,
    multiplies the right-hand side (1.0 leaves the solve bit-identical);
    ``serial`` sums each shard's partials with kernel S (off by default).
    One process drives the mesh, as the JAX one-shot solve does: a mesh
    over processes runs on :func:`fused_cg_solve_sharded_checkpointed`."""
    mesh = make_solver_mesh() if mesh is None else mesh
    single_process(mesh, "fused_cg_solve_sharded",
                   "fused_cg_solve_sharded_checkpointed")
    spec, canvases = shard_canvases(problem, mesh, 1)
    s = _sharded_solve(problem, spec, mesh, canvases,
                       gated_rhs(canvases, rhs_gate), check_every,
                       shard_run(problem, spec, mesh, serial))
    w = gather_owned(problem, spec, mesh, s.w, canvases.sc_int)
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr)


# --- checkpoint and resume ---------------------------------------------------


def gather_full(problem: Problem, spec: ShardSpec, mesh: Mesh,
                canvases) -> np.ndarray:
    """Every shard's owned points of ``canvases`` → the full (M+1, N+1)
    grid, numpy (``pallas_sharded._gather_full``; owned column lj at canvas
    column ring + lj); on a mesh over processes, gathered to every rank."""
    M, N = problem.M, problem.N
    full = np.zeros((M + 1, N + 1), np.float32)
    r0, c0 = HALO, spec.ring
    if mesh.multiprocess:
        canvases = gather_shards([c[r0 : r0 + spec.m_blk,
                                    c0 : c0 + spec.n_blk]
                                  for c in canvases], mesh).cpu()
        r0 = c0 = 0
    for s, c in enumerate(canvases):
        ix, iy = divmod(s, mesh.py)
        gi0, gj0 = 1 + ix * spec.m_blk, 1 + iy * spec.n_blk
        nr, nc = min(spec.m_blk, M - gi0), min(spec.n_blk, N - gj0)
        if nr > 0 and nc > 0:
            full[gi0 : gi0 + nr, gj0 : gj0 + nc] = c[
                r0 : r0 + nr, c0 : c0 + nc].cpu().numpy()
    return full


def scatter_canvases(problem: Problem, spec: ShardSpec, mesh: Mesh,
                     full) -> tuple:
    """A full (M+1, N+1) grid → fp32 canvases of the shards this process
    drives, on their devices, owned points only: rings and padding zero
    (``pallas_sharded._scatter_canvases``)."""
    M, N = problem.M, problem.N
    full = np.asarray(full, np.float32)
    out = []
    for s in mesh.local:
        dev = mesh.devices[s]
        ix, iy = divmod(s, mesh.py)
        gi0, gj0 = 1 + ix * spec.m_blk, 1 + iy * spec.n_blk
        nr, nc = min(spec.m_blk, M - gi0), min(spec.n_blk, N - gj0)
        c = np.zeros((spec.cv.rows, spec.cv.cols), np.float32)
        if nr > 0 and nc > 0:
            c[HALO : HALO + nr, spec.ring : spec.ring + nc] = full[
                gi0 : gi0 + nr, gj0 : gj0 + nc]
        out.append(torch.tensor(c, device=dev))
    return tuple(out)


def sharded_portable(problem: Problem, spec: ShardSpec, mesh: Mesh, *, k,
                     done, sol, r, pend, beta, zr, diff,
                     z=None) -> PCGState:
    """A pending-β sharded state → the portable state: d = z + β·pend on
    every shard (z = r unless given), gathered with w and r."""
    d = [(ri if zi is None else zi) + beta.to(ri.device) * pi
         for ri, zi, pi in zip(r, z or [None] * len(r), pend)]
    return portable_state(
        k=k, done=done, w=gather_full(problem, spec, mesh, sol),
        r=gather_full(problem, spec, mesh, r),
        d=gather_full(problem, spec, mesh, d), zr=zr, diff=diff)


def resumed_canvases(problem: Problem, spec: ShardSpec, mesh: Mesh,
                     saved: PCGState, exchange) -> dict:
    """A saved portable state → the shards' w, r and d canvases, with r's
    and d's rings refreshed by ``exchange`` (in place), and its scalars on
    the lead device."""
    lead = mesh.lead
    f32 = dict(dtype=torch.float32, device=lead)
    grid = lambda x: np.asarray(x.numpy(), np.float32)
    r = scatter_canvases(problem, spec, mesh, grid(saved.r))
    d = scatter_canvases(problem, spec, mesh, grid(saved.p))
    exchange(r, spec, mesh)
    exchange(d, spec, mesh)
    return dict(
        k=saved.k.to(dtype=torch.int32, device=lead),
        done=saved.done.to(dtype=torch.bool, device=lead),
        w=scatter_canvases(problem, spec, mesh, grid(saved.w)), r=r, d=d,
        zr=torch.tensor(float(saved.zr), **f32),
        diff=torch.tensor(float(saved.diff), **f32))


def fused_cg_solve_sharded_checkpointed(problem: Problem, mesh: Mesh | None,
                                        checkpoint_path: str,
                                        chunk: int = 200,
                                        serial: bool | None = None,
                                        keep_checkpoint: bool = False,
                                        keep_last: int = 2,
                                        check_every: int = CHECK_EVERY
                                        ) -> PCGResult:
    """The sharded fused solve with its state saved every ``chunk``
    iterations and resumed from ``checkpoint_path`` when a trustworthy file
    for this problem exists: the counterpart of
    ``pallas_sharded.pallas_cg_solve_sharded_checkpointed``, in the file
    format of every checkpointed solver of both packages, so a file written
    on any mesh, on one device or by the JAX package resumes here. A chunk
    stops at min(k + chunk, cap) exactly, so chunking changes no iterate;
    the file is removed on convergence unless ``keep_checkpoint``. ``serial``
    sums the partials with kernel S, as in :func:`fused_cg_solve_sharded`."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    mesh = make_solver_mesh() if mesh is None else mesh
    spec, canvases = shard_canvases(problem, mesh, 1)
    fp = _fingerprint(problem, "float32", True)
    saved = load_state(checkpoint_path, fp, keep_last=keep_last)
    if saved is None:
        s = _sharded_init(problem, spec, mesh, canvases, canvases.rhs)
    else:
        f = resumed_canvases(problem, spec, mesh, saved, exchange_r_halo)
        zeros = lambda: tuple(torch.zeros_like(x) for x in f["r"])
        s = _ShardedState(k=f["k"], done=f["done"], w=f["w"], r=f["r"],
                          z=f["d"], p=zeros(), spare=zeros(), ap=zeros(),
                          zr=f["zr"], beta=torch.zeros_like(f["zr"]),
                          diff=f["diff"])
    body = _make_sharded_body(problem, spec, mesh, canvases,
                              shard_run(problem, spec, mesh, serial))
    cap = problem.iteration_cap
    s = run_chunked(
        s, advance=chunked_advance(body, chunk, cap, check_every),
        to_portable=lambda st: sharded_portable(
            problem, spec, mesh, k=st.k, done=st.done, sol=st.w, r=st.r,
            pend=st.p, beta=st.beta, zr=st.zr, diff=st.diff, z=st.z),
        path=checkpoint_path, fingerprint=fp, cap=cap,
        keep_checkpoint=keep_checkpoint, primary=is_primary, sync=_sync,
        keep_last=keep_last)
    w = gather_owned(problem, spec, mesh, s.w, canvases.sc_int)
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr)
