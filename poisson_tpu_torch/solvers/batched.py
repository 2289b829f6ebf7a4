"""Batched multi-RHS solves: B Poisson problems on one operator, stepped
together (counterpart of ``poisson_tpu/solvers/batched.py``).

The JAX driver ``vmap``s the shared PCG body over a leading batch axis in
one ``while_loop``. Here the batch axis is part of every tensor: the fields
are (B, M+1, N+1) stacks, and every per-member scalar (ζ, α, the verdicts,
k) is a (B, 1, 1) tensor that broadcasts over its member's grid, so the
shared body ``solvers.pcg.make_pcg_body`` runs unchanged over the stack.
Each operation is one launch for the whole batch; the coefficient fields
are read once for all members.

Per-member masking: a member that stops (converged, breakdown, non-finite)
is frozen by the body's own ``done`` select, count included; the host
reads "is every member done" once per ``CHECK_EVERY`` steps
(``solvers.pcg.drive``), and never runs more steps than the cap, so no
member passes it. The lane engine (``solvers.lanes``), whose members start
at different iterations, also freezes each member at its own stop line
(:func:`step_members`).

Bit parity with the sequential solve: each member's sums are the
``torch.sum`` calls of its own solve on its own product
(``ops.stencil.member_sums``), and every other step is elementwise. So
member i reproduces ``pcg_solve(problem, rhs_gate=g_i)`` (or
``pcg_solve(p_i)``) bit for bit: its iterate, count and flag.

Buckets: the JAX package pads a ragged batch with zero right-hand sides to
a bucket of its ladder, so that one compiled executable serves every batch
size up to it. The port compiles nothing, so it runs the batch at its own
size and pads only to a ``bucket`` the caller pins (a zero member stops
with FLAG_BREAKDOWN at iteration 1, ζ₀ = 0 tripping the |(Ap, p)| guard,
and is sliced off). It still counts the bucket in ``obs`` by the JAX
package's cache keys (``batched.bucket_cache.hits``/``.misses``), so those
counters move the same way on the same calls.

``mesh=`` runs the bucket on a mesh of shards
(``parallel.pcg_sharded.solve_batched_sharded``): members stay whole-grid,
the mesh splits the grid, each member's sums are mesh scalars.

``preconditioner="mg"`` runs every member with one V-cycle per
iteration (``poisson_tpu_torch.mg``) on one hierarchy shared by the whole
stack; the cycle is elementwise but for the coarsest matvec, which runs
per member on the solo call's shape (``mg.cycle.coarse_matvec``), so
member i is ``pcg_solve(..., preconditioner="mg")`` bit for bit. MG
buckets are their own family of keys, as in the JAX package. As there,
MG does not co-batch per-member ``geometries`` and has no ``mesh=``
program.

``geometries`` (one ``poisson_tpu_torch.geometry`` spec or None per
member) gives each member its own domain: the canvases a, b and aux become
(B, M+1, N+1) stacks beside the state, and every elementwise step and
member sum reads each member's own, so member i is
``pcg_solve(problem, geometry=g_i, rhs_gate=…)`` bit for bit. A None entry
is the problem's reference ellipse; padding members reuse member 0's
canvases. As in the JAX package, geometries have no ``mesh=`` program and
do not co-batch with MG.

``verify_every`` > 0 arms the integrity probe per member
(``poisson_tpu_torch.integrity``): every member checks the true residual
against its own right-hand side, so a corrupted member stops alone with
FLAG_INTEGRITY and its batchmates run on untouched. As in the JAX package,
the probe has no ``mesh=`` program, and ``solve_batched`` takes no
``stream_every`` (streaming is per-solve telemetry).

Not ported yet, refused with the ROADMAP item that ports it:
``mode="block"`` (Queue 1 item 9).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.mg.hierarchy import (
    mg_config_for,
    resolve_preconditioner,
)
from poisson_tpu_torch.mg.preconditioner import mg_solve_setup
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGOps,
    PCGResult,
    PCGState,
    _select,
    drive,
    gate_rhs,
    host_fields64,
    init_state,
    make_pcg_body,
    not_ported,
    resolve_dtype,
    resolve_scaled,
    resolve_verify_tol,
    setup_from_fields,
    solve_fields,
    solve_setup,
)
from poisson_tpu_torch.utils.platform import resolve_device

# Bucket ladder for padding ragged batch sizes (the JAX package's): powers
# of two up to 256; larger request sets run at their exact size.
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

# The bucket keys this process has counted, as the JAX package keys its
# jit cache ((bucket, problem with f_val=1, dtype, scaled[, mesh])), so
# the hit and miss counters follow a call sequence as JAX's do.
_TRACED: set = set()

def reset_bucket_cache() -> None:
    """Forget which bucket shapes this process has run (pair it with
    ``obs.metrics.reset()`` so hits and misses stay consistent)."""
    _TRACED.clear()


def bucket_size(n: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket ≥ n (n itself beyond the ladder)."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    for b in buckets:
        if n <= b:
            return int(b)
    return int(n)


def pcg_loop_batched(ops: PCGOps, rhs_stack, *, delta: float, max_iter: int,
                     weighted_norm: bool, h1: float, h2: float,
                     stagnation_window: int = 0,
                     check_every: int = CHECK_EVERY, verify_every: int = 0,
                     verify_tol: float = 0.0,
                     preconditioner: str = "jacobi") -> PCGState:
    """Run the shared PCG body over a (B, M+1, N+1) stack until every
    member is done or at the cap. ``ops`` must be a batched bundle (sums as
    (B, 1, 1) member scalars). Every member starts at k = 0 and ``drive``
    runs at most ``max_iter`` steps, so no member passes the cap; a done
    member is frozen by the body. ``verify_every`` > 0 arms the integrity
    probe per member."""
    body = make_pcg_body(ops, delta=delta, weighted_norm=weighted_norm,
                         h1=h1, h2=h2, stagnation_window=stagnation_window,
                         verify_every=verify_every, verify_tol=verify_tol,
                         verify_rhs=rhs_stack if verify_every else None,
                         preconditioner=preconditioner)
    return drive(body, init_state(ops, rhs_stack), max_iter, check_every)


def step_members(body, s: PCGState, stop_at, steps: int,
                 check_every: int = CHECK_EVERY) -> PCGState:
    """Advance every member of ``s`` to at most its own ``stop_at``
    (a (B, 1, 1) tensor), in at most ``steps`` steps: a member already
    done or at its line keeps its old state (the JAX driver's per-member
    select). The host reads whether any member can still advance once
    per ``check_every`` steps."""
    ran = 0
    while ran < steps:
        for _ in range(min(check_every, steps - ran)):
            frozen = s.done | (s.k >= stop_at)
            s = _select(frozen, s, body(s))
        ran += min(check_every, steps - ran)
        if not bool(torch.any(~s.done & (s.k < stop_at))):
            break
    return s


def member_rhs(problem: Problem, f_val: float, scaled: bool, dtype,
               device) -> torch.Tensor:
    """A member's right-hand side for RHS magnitude ``f_val``: the unit
    (f_val = 1) host setup scaled in fp64, then cast once. f·1[D]·D^{-1/2}
    is one fp64 product either way, so these are the bits of
    ``pcg_solve(problem.with_(f_val=f_val))``'s right-hand side."""
    base64 = host_fields64(problem.with_(f_val=1.0), scaled)[2]
    return torch.tensor(base64 * f_val, dtype=dtype).to(device)


def _shared_base(problems: Sequence[Problem]) -> Problem:
    """Every member must share the operator (all fields but ``f_val``);
    returns member 0, the shared base."""
    if not problems:
        raise ValueError("solve_batched needs at least one problem")
    base = problems[0]
    for i, p in enumerate(problems[1:], start=1):
        if p.with_(f_val=base.f_val) != base:
            raise ValueError(
                "batched members must share the operator — every Problem "
                "field except f_val must match member 0; member "
                f"{i} differs: {p} vs {base}")
    return base


def _count_bucket(key: tuple, batch: int, run: int) -> None:
    """Count a call under the JAX package's cache ``key``, its ``batch``
    members and the ``run - batch`` padding members it computes."""
    if key in _TRACED:
        obs.inc("batched.bucket_cache.hits")
    else:
        _TRACED.add(key)
        obs.inc("batched.bucket_cache.misses")
    obs.inc("batched.solves", batch)
    obs.inc("batched.padding_members", run - batch)
    obs.gauge("batched.last_bucket", key[0])


def _refuse_unported(geometries, verify_every, preconditioner, mode,
                     mesh) -> None:
    if mode not in ("independent", "block"):
        raise ValueError(f"unknown mode {mode!r} — expected one of "
                         "('independent', 'block')")
    if mode == "block":
        raise not_ported("block")
    with_geometries = geometries is not None and any(
        g is not None for g in geometries)
    # The JAX package's refusals, in its words.
    if mesh is not None and with_geometries:
        raise ValueError(
            "solve_batched(mesh=) does not carry per-member "
            "geometries yet (stacked canvases need sharded blocks "
            "per member); drop geometries= or dispatch on a single "
            "device")
    if resolve_preconditioner(preconditioner) == "mg":
        if mesh is not None:
            raise ValueError(
                "solve_batched(mesh=) composes with the Jacobi "
                "(symmetric-scaling) body only; preconditioner="
                f"{preconditioner!r} needs a sharded hierarchy — "
                "dispatch MG batches on a single device")
        if with_geometries:
            raise ValueError(
                "preconditioner='mg' does not co-batch per-member "
                "geometries yet (each member would need its own level "
                "hierarchy); dispatch geometry+MG requests solo via "
                "pcg_solve(geometry=..., preconditioner='mg')")
    if mesh is not None and int(verify_every) > 0:
        raise ValueError(
            "solve_batched(mesh=) does not trace the per-member "
            "integrity probe yet; run verify_every=0 on the mesh "
            "or verified buckets on a single device")


def _member_canvases(problems, geo, dtype_name: str, scaled: bool, dev):
    """One (a, b, rhs, aux) per member, each the fields its own
    ``pcg_solve(p_i, geometry=g_i)`` runs on (a None spec is the
    reference ellipse), stacked on a leading member axis."""
    if len(geo) != len(problems):
        raise ValueError(
            f"geometries must have one entry per member: got "
            f"{len(geo)} specs for batch {len(problems)}")
    fields = [solve_fields(p, dtype_name, scaled, dev, g)
              for p, g in zip(problems, geo)]
    return [torch.stack(f) for f in zip(*fields)]


def _member_ids(member_ids, batch: int) -> tuple:
    if member_ids is None:
        return tuple(range(batch))
    origin = tuple(member_ids)
    if len(origin) != batch:
        raise ValueError(f"member_ids must have one id per member: got "
                         f"{len(origin)} ids for batch {batch}")
    return origin


def solve_batched(problems=None, *, rhs_stack=None, rhs_gates=None,
                  dtype=None, scaled=None, mesh=None,
                  buckets: Sequence[int] = DEFAULT_BUCKETS,
                  bucket: Optional[int] = None,
                  member_ids: Optional[Sequence] = None,
                  geometries: Optional[Sequence] = None,
                  verify_every: int = 0, verify_tol=None,
                  preconditioner: str = "jacobi", mg_config=None,
                  mode: str = "independent", device=None) -> PCGResult:
    """Solve a batch of Poisson problems on one operator, stepped together.

    Input forms (exactly one), as in the JAX package:

    - ``solve_batched([p0, p1, …])`` — Problems that share everything but
      ``f_val``; member i reproduces ``pcg_solve(p_i)`` bit for bit;
    - ``solve_batched(p, rhs_gates=[g0, g1, …])`` — one problem, B scalar
      RHS multipliers; member i is ``pcg_solve(p, rhs_gate=g_i)``;
    - ``solve_batched(p, rhs_stack=B)`` — one problem, a (B, M+1, N+1)
      stack of physical right-hand sides (zero Dirichlet ring), mapped to
      the scaled system when ``scaled``.

    The batch runs at its own size B; a pinned ``bucket`` (≥ B) pads it
    with zero members, which stop at iteration 1 and are sliced off. The
    hit and miss counters key on ``bucket``, else on :func:`bucket_size`
    over ``buckets``, as the JAX package's compile cache does.
    Returns a :class:`PCGResult` whose ``w``/``iterations``/``diff``/
    ``residual_dot``/``flag`` carry the batch axis, with ``max_iterations``
    (0-d, the slowest real member's count) and ``origin`` (``member_ids``,
    default 0…B−1, aligned with the batch axis through padding).

    ``dtype``/``scaled`` follow ``pcg_solve``'s precision policy; the solve
    runs on ``device`` (default ``cuda``), or on ``mesh`` (a
    ``parallel.mesh.Mesh``; one of the two). ``preconditioner="mg"`` (with
    ``mg_config``) runs every member with the V-cycle on one shared
    hierarchy; it takes no ``mesh`` and no ``geometries``, as in the JAX
    package. ``verify_every`` > 0 (with ``verify_tol``, default by dtype)
    arms the integrity probe per member, on one device only; clean
    verified members equal their unverified solves bit for bit.
    ``geometries`` (one spec or None per member, the length of the batch)
    gives each member its own domain: member i is
    ``pcg_solve(problem, geometry=g_i, rhs_gate=…)`` bit for bit (with
    the Problems form, ``pcg_solve(p_i, geometry=g_i)``); it takes no
    ``mesh`` and no MG. ``mode="block"`` is refused with the ROADMAP item
    that ports it."""
    _refuse_unported(geometries, verify_every, preconditioner, mode, mesh)
    if mesh is not None and device is not None:
        raise ValueError("give a mesh or a device, not both")
    forms = sum(x is not None for x in (rhs_stack, rhs_gates))
    if problems is None:
        raise ValueError("solve_batched needs problems (a Problem or a "
                         "sequence of Problems)")
    if isinstance(problems, Problem):
        problem = problems
        if forms != 1:
            raise ValueError(
                "with a single Problem, pass exactly one of rhs_gates or "
                "rhs_stack (a sequence of Problems is the third form)")
        member_problems = None
    else:
        if forms != 0:
            raise ValueError(
                "rhs_gates/rhs_stack apply to the single-Problem form; a "
                "sequence of Problems already defines every member's RHS")
        member_problems = list(problems)
        problem = _shared_base(member_problems)

    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    tdtype = getattr(torch, dtype_name)
    dev = mesh.lead if mesh is not None else resolve_device(device)
    # f_val enters only the right-hand sides, so the bucket key (and the
    # operator setup) normalizes it away, as the JAX package's jit key does.
    jit_problem = problem.with_(f_val=1.0)
    config = mg_config_for(problem, preconditioner, mg_config)
    geo = None
    # With MG or a mesh every entry is None (refused otherwise): the
    # default domain, on the plain path.
    if geometries is not None and config is None and mesh is None:
        from poisson_tpu_torch.geometry.dsl import parse_geometry

        geo = [None if g is None else parse_geometry(g) for g in geometries]
    canvases = None
    if mesh is not None or geo is not None:
        setup = None
    elif config is None:
        setup = solve_setup(jit_problem, dtype_name, use_scaled, dev,
                            members=True)
    else:
        setup = mg_solve_setup(jit_problem, dtype_name, use_scaled, dev,
                               members=True, config=config)

    if member_problems is not None:
        if geo is not None:
            canvases = _member_canvases(member_problems, geo, dtype_name,
                                        use_scaled, dev)
            stack = canvases[2]
        else:
            stack = torch.stack([member_rhs(problem, p.f_val, use_scaled,
                                            tdtype, dev)
                                 for p in member_problems])
    elif rhs_gates is not None:
        gates = torch.as_tensor(rhs_gates, dtype=tdtype).reshape(-1)
        if gates.numel() < 1:
            raise ValueError("rhs_gates must have at least one member")
        if geo is not None:
            # Each member's own RHS times its gate: pcg_solve(problem,
            # geometry=g, rhs_gate=gate)'s multiply.
            canvases = _member_canvases([problem] * gates.numel(), geo,
                                        dtype_name, use_scaled, dev)
            stack = canvases[2] * gates.to(dev).reshape(-1, 1, 1)
        else:
            stack = gate_rhs(member_rhs(problem, problem.f_val, use_scaled,
                                        tdtype, dev), gates.to(dev))
    else:
        stack = torch.as_tensor(rhs_stack, dtype=tdtype).to(dev)
        if stack.dim() != 3 or tuple(stack.shape[1:]) != problem.grid_shape:
            raise ValueError(
                f"rhs_stack must be (B, {problem.grid_shape[0]}, "
                f"{problem.grid_shape[1]}), got {tuple(stack.shape)}")
        if geo is not None:
            canvases = _member_canvases([jit_problem] * stack.shape[0], geo,
                                        dtype_name, use_scaled, dev)
        if use_scaled:
            # Physical B → scaled b̃ = D^{-1/2}·B: aux is D^{-1/2} with a
            # zero ring (each member's own with geometries).
            aux = (canvases[3] if canvases is not None else torch.tensor(
                host_fields64(jit_problem, True)[3], dtype=tdtype,
                device=dev))
            stack = stack * aux
    batch = stack.shape[0]
    origin = _member_ids(member_ids, batch)

    size = bucket_size(batch, buckets) if bucket is None else int(bucket)
    if size < batch:
        raise ValueError(f"bucket {size} smaller than batch {batch}")
    run = batch if bucket is None else size
    if run > batch:
        stack = torch.cat([stack, stack.new_zeros(
            (run - batch,) + tuple(stack.shape[1:]))])
    if canvases is not None:
        # Padding members reuse member 0's canvases (their RHS is zero:
        # they stop at iteration 1 whatever the operator).
        a, b, _, aux = (torch.cat([c, c[:1].expand(
            (run - batch,) + tuple(c.shape[1:]))]) for c in canvases)
        setup = setup_from_fields(jit_problem, a, b, None, aux, dtype_name,
                                  use_scaled, members=True)

    verify_every = int(verify_every)
    v_tol = (resolve_verify_tol(verify_tol, dtype_name)
             if verify_every > 0 else 0.0)
    key = (size, jit_problem, dtype_name, use_scaled)
    if geo is not None:
        # Stacked canvases are another operand signature in the JAX
        # package, hence another executable; the fingerprints never enter.
        key += ("geo",)
    if config is not None:
        # MG buckets are their own family, keyed with the cycle config.
        key += (("mg", config),)
        obs.inc("mg.solves", batch)
    if verify_every > 0:
        # The stride is part of the JAX package's executable identity.
        key += (("verify", verify_every, v_tol),)
    if mesh is not None:
        from poisson_tpu_torch.parallel.pcg_sharded import (
            solve_batched_sharded,
        )

        _count_bucket(key + (("mesh", mesh.px, mesh.py),), batch, run)
        result = solve_batched_sharded(jit_problem, mesh, dtype_name,
                                       use_scaled, stack)
    else:
        _count_bucket(key, batch, run)
        s = pcg_loop_batched(
            setup.ops, stack, delta=problem.delta,
            max_iter=problem.iteration_cap,
            weighted_norm=problem.weighted_norm, h1=problem.h1,
            h2=problem.h2, check_every=setup.check_every,
            verify_every=verify_every, verify_tol=v_tol,
            preconditioner=setup.preconditioner)
        w = s.w * setup.aux if use_scaled else s.w
        result = batched_result(w, s)
    return sliced(result, batch, origin)


def batched_result(w, s: PCGState) -> PCGResult:
    """A batched state's result: member scalars as (B,) vectors."""
    k = s.k.reshape(-1)
    return PCGResult(w=w, iterations=k, diff=s.diff.reshape(-1),
                     residual_dot=s.zr.reshape(-1),
                     flag=s.flag.reshape(-1), max_iterations=k.max())


def sliced(result: PCGResult, batch: int, origin: tuple) -> PCGResult:
    """The first ``batch`` members of a bucket's result (padding members
    cut), ``max_iterations`` over those, and their ``origin``."""
    k = result.iterations[:batch]
    return PCGResult(w=result.w[:batch], iterations=k,
                     diff=result.diff[:batch],
                     residual_dot=result.residual_dot[:batch],
                     flag=result.flag[:batch], max_iterations=k.max(),
                     origin=origin)


# Smoke check: ``python -m poisson_tpu_torch.solvers.batched_selfcheck``.
