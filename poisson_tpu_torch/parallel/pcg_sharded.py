"""The plain sharded solve: Jacobi-PCG (fp64) or CG on the scaled system
(fp32) over a mesh of shards (counterpart of
``poisson_tpu/parallel/pcg_sharded.py``, the JAX CLI's ``sharded``
backend).

The JAX module runs the shared PCG body under ``shard_map``: the halo
exchange is a ``ppermute`` per iteration and every reduction a ``psum``.
Here the body is the port's own, ``solvers.pcg.make_pcg_body`` (its flags,
weighted norm, ``best``/``stall``), given a :class:`~poisson_tpu_torch
.solvers.pcg.PCGOps` whose operators act on every shard, whose exchange
refreshes the halo rings (``parallel.halo.exchange_halos``) and whose sums
are ``parallel.halo.mesh_sum``, so every shard's scalar is the same, summed
in mesh order.

**Shards stacked per device.** ``make_pcg_body`` works on one value per
field. A field here is a :class:`DeviceStacks`: one (shards, m̂+2, n̂+2)
tensor per distinct device of the mesh, its shards in mesh order. Its
elementwise arithmetic and ``torch.where`` run once per device, with the
mesh-wide scalars (on the lead device) moved to each; on a mesh whose
shards share one card (chip_smoke.py's 2×2 mesh, every CPU mesh) a field
is one tensor and each operation one launch for every shard.

Shard layout (the JAX module's): the (M−1)×(N−1) interior is padded to
(Px·m̂)×(Py·n̂), m̂ = ⌈(M−1)/Px⌉, n̂ = ⌈(N−1)/Py⌉; shard (ix, iy) holds the
(m̂+2)×(n̂+2) block of global grid rows ix·m̂ … ix·m̂+m̂+1 and columns
iy·n̂ … iy·n̂+n̂+1, its owned interior inside a ring of width 1. Padded and
ring cells are masked out of every operator and every sum.

- **Scaled system** (fp32 by default): the operator exchanges the halo of
  sc·p, then applies A, ·sc and ·mask; D⁻¹ is the identity.
- **Jacobi system** (fp64): D⁻¹ is masked, and the loop's exchange
  refreshes p's halo at the top of every iteration.

**Over processes** (``parallel.multihost``): a rank's DeviceStacks hold
its own shards only (``Mesh.local``), the exchange and the sums cross
between processes (``parallel.halo``), and :func:`gather_interior`
gathers the iterate to every rank, as the JAX module replicates it before
a fetch; the result is the one-process mesh's bit for bit.

Setup: ``setup="host"`` cuts the host fp64 fields
(``solvers.pcg.host_fields64``) into the blocks and casts them once;
``setup="device"`` has every shard build its own coefficient block and
halo ring from the closed-form geometry on its device, in the state's
dtype. The JAX module reaches no Pallas kernel, so neither does this one:
it is plain PyTorch.

**Batched** (:func:`solve_batched_sharded`, the engine of
``solvers.batched.solve_batched(mesh=)``): every shard's part carries a
member axis, (shards, B, m̂+2, n̂+2); the coefficient fields and the mask
broadcast over it, the halo exchange moves every member's ring at once,
and each member's sums are (B, 1, 1) mesh scalars: each shard's block
summed per member, then the shards in mesh order. Counts and flags equal
the unsharded batched solve's; iterates agree to the sums' order, as in
the JAX package.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.models.fictitious_domain import (
    coefficient_fields,
    rhs_field,
    sqrt_rn,
)
from poisson_tpu_torch.ops.stencil import (
    apply_A,
    apply_Dinv,
    diag_D,
    pad_interior,
)
from poisson_tpu_torch.parallel.halo import (
    exchange_halos,
    gather_shards,
    mesh_sum,
)
from poisson_tpu_torch.parallel.mesh import (
    Mesh,
    block_size,
    check_mesh,
    make_solver_mesh,
)
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    PCGOps,
    PCGResult,
    host_fields64,
    pcg_loop,
    resolve_dtype,
    resolve_scaled,
)


class DeviceStacks:
    """One field of every shard: a (shards, …) tensor per distinct device,
    the devices in order of their first shard. Arithmetic, ``torch.where``
    and the ``*_like`` constructors apply per device; a tensor operand on
    another device (a mesh-wide scalar) is moved to each."""

    __slots__ = ("parts",)

    def __init__(self, parts: Sequence[torch.Tensor]):
        self.parts = tuple(parts)

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype

    @property
    def device(self) -> torch.device:
        """The lead device: the one that holds shard 0."""
        return self.parts[0].device

    @staticmethod
    def map(fn, *args):
        """``fn`` applied to each device's part of every DeviceStacks
        argument; other tensors are moved to the part's device."""
        ref = next(a for a in args if isinstance(a, DeviceStacks))

        def pick(a, j, dev):
            if isinstance(a, DeviceStacks):
                return a.parts[j]
            if isinstance(a, torch.Tensor) and a.device != dev:
                return a.to(dev)
            return a

        return DeviceStacks(
            fn(*(pick(a, j, part.device) for a in args))
            for j, part in enumerate(ref.parts))

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        return cls.map(lambda *a: func(*a, **kwargs), *args)

    def __add__(self, other):
        return self.map(torch.add, self, other)

    def __sub__(self, other):
        return self.map(torch.sub, self, other)

    def __mul__(self, other):
        return self.map(torch.mul, self, other)

    __rmul__ = __mul__


class ShardGeometry(NamedTuple):
    """The blocks of a px × py mesh and where this process's shards sit."""

    px: int
    py: int
    m_blk: int
    n_blk: int
    devices: tuple                  # distinct devices, by first shard
    shards: tuple                   # the shard numbers on each device
    slot: tuple                     # local shard → (device part, index)
    local: tuple                    # this process's shards, mesh order


def geometry(problem: Problem, mesh: Mesh) -> ShardGeometry:
    """The blocks of ``problem`` on ``mesh`` and the shards this process
    drives (every shard in one process)."""
    local = check_mesh(mesh).local
    devices, shards = [], []
    for s in local:
        dev = mesh.devices[s]
        if dev not in devices:
            devices.append(dev)
            shards.append([])
        shards[devices.index(dev)].append(s)
    slot = {s: (j, i) for j, group in enumerate(shards)
            for i, s in enumerate(group)}
    return ShardGeometry(
        px=mesh.px, py=mesh.py,
        m_blk=block_size(problem.M - 1, mesh.px),
        n_blk=block_size(problem.N - 1, mesh.py),
        devices=tuple(devices), shards=tuple(tuple(g) for g in shards),
        slot=tuple(slot[s] for s in local), local=local)


def shard_blocks(geo: ShardGeometry, field: DeviceStacks) -> list:
    """Every local shard's (m̂+2, n̂+2) block of ``field``, in mesh order
    (views)."""
    return [field.parts[j][i] for j, i in geo.slot]


def from_blocks(geo: ShardGeometry, blocks) -> DeviceStacks:
    """Per-shard blocks (one per local shard, mesh order) → a field (one
    stack per device)."""
    at = {s: i for i, s in enumerate(geo.local)}
    return DeviceStacks(torch.stack([blocks[at[s]] for s in group])
                        for group in geo.shards)


def _owned_mask(problem: Problem, geo: ShardGeometry, shard: int, dtype,
                device):
    """Shard ``shard``'s owned-interior mask (ring and padding excluded) and
    its global grid indices gi, gj: local index li ↔ global ix·m̂ + li, as
    in the reference's ``fic_reg_local`` (``stage2:…cpp:124-170``)."""
    ix, iy = divmod(shard, geo.py)
    li = torch.arange(geo.m_blk + 2, device=device)
    lj = torch.arange(geo.n_blk + 2, device=device)
    gi, gj = ix * geo.m_blk + li, iy * geo.n_blk + lj
    own_i = (li >= 1) & (li <= geo.m_blk) & (gi >= 1) & (gi <= problem.M - 1)
    own_j = (lj >= 1) & (lj <= geo.n_blk) & (gj >= 1) & (gj <= problem.N - 1)
    return (own_i[:, None] & own_j[None, :]).to(dtype), gi, gj


def _device_local_fields(problem: Problem, geo: ShardGeometry, shard: int,
                         dtype, scaled: bool, device):
    """One shard's (a, b, rhs, aux, mask) built on ``device`` in ``dtype``
    from the closed-form geometry (``setup="device"``); aux is the zero-ring
    embedding of the local D (Jacobi) or D^{-1/2} (scaled). Host blocks
    carry the neighbours' values on that ring, which nothing reads: D⁻¹ is
    taken on the interior, and the ring of sc·p is exchanged."""
    mask, gi, gj = _owned_mask(problem, geo, shard, dtype, device)
    a, b = coefficient_fields(problem, gi, gj, dtype)
    rhs = rhs_field(problem, gi, gj, dtype) * mask
    d = diag_D(a, b, problem.h1, problem.h2)
    if not scaled:
        return a, b, rhs, pad_interior(d), mask
    sc = pad_interior(1.0 / sqrt_rn(d))
    return a, b, rhs * sc, sc, mask


@functools.lru_cache(maxsize=8)
def _host_shard_blocks(problem: Problem, px: int, py: int, m_blk: int,
                       n_blk: int, scaled: bool):
    """The host fp64 fields (``host_fields64``) cut into halo-inclusive
    blocks: numpy arrays (px·py, m̂+2, n̂+2) of a, b, rhs, aux, leading axis
    in mesh order (x-major). Cached and shared: read-only."""
    gm, gn = px * m_blk + 2, py * n_blk + 2

    def blocks(grid):
        full = np.zeros((gm, gn))
        full[: grid.shape[0], : grid.shape[1]] = grid
        out = np.empty((px * py, m_blk + 2, n_blk + 2))
        for ix in range(px):
            for iy in range(py):
                out[ix * py + iy] = full[ix * m_blk : ix * m_blk + m_blk + 2,
                                         iy * n_blk : iy * n_blk + n_blk + 2]
        out.flags.writeable = False
        return out

    return tuple(blocks(f) for f in host_fields64(problem, scaled))


class ShardedFields(NamedTuple):
    """The operands of the sharded solve, one DeviceStacks each."""

    a: DeviceStacks
    b: DeviceStacks
    rhs: DeviceStacks    # masked; scaled by sc on the scaled system
    aux: DeviceStacks    # D or D^{-1/2}, zero ring
    mask: DeviceStacks


def sharded_fields(problem: Problem, mesh: Mesh, geo: ShardGeometry,
                   dtype_name: str, scaled: bool,
                   setup: str = "host") -> ShardedFields:
    tdtype = getattr(torch, dtype_name)
    if setup == "device":
        built = [_device_local_fields(problem, geo, s, tdtype, scaled,
                                      mesh.devices[s]) for s in geo.local]
        return ShardedFields(*(from_blocks(geo, [f[k] for f in built])
                               for k in range(5)))
    if setup != "host":
        raise ValueError(f"setup must be 'host' or 'device', got {setup!r}")
    host = _host_shard_blocks(problem, geo.px, geo.py, geo.m_blk, geo.n_blk,
                              scaled)
    a, b, rhs, aux = (DeviceStacks(
        torch.tensor(arr[list(group)], dtype=tdtype, device=dev)
        for group, dev in zip(geo.shards, geo.devices)) for arr in host)
    mask = from_blocks(geo, [_owned_mask(problem, geo, s, tdtype,
                                         mesh.devices[s])[0]
                             for s in geo.local])
    return ShardedFields(a, b, rhs * mask, aux, mask)


def sharded_ops(problem: Problem, mesh: Mesh, geo: ShardGeometry,
                fields: ShardedFields, scaled: bool,
                members: bool = False) -> PCGOps:
    """The JAX module's ``_sharded_ops``: masked operators, mesh-order sums
    and the halo exchange of the Jacobi loop. ``members``: the fields carry
    a member axis (:func:`member_fields`) and every sum is a (B, 1, 1)
    tensor of member scalars."""
    h1, h2 = problem.h1, problem.h2
    a, b, aux, mask = fields.a, fields.b, fields.aux, fields.mask
    stencil = lambda p: DeviceStacks.map(
        lambda q, aa, bb: apply_A(q, aa, bb, h1, h2), p, a, b)

    def psum(x: DeviceStacks) -> torch.Tensor:
        if members:
            # Each device's shards summed per member at once, then the
            # shards in mesh order on the lead device.
            sums = DeviceStacks(part.sum(dim=(-2, -1), keepdim=True)
                                for part in x.parts)
            if mesh.multiprocess:
                return torch.sum(gather_shards(shard_blocks(geo, sums),
                                               mesh), dim=0)
            return torch.sum(torch.stack(
                [s.to(mesh.lead) for s in shard_blocks(geo, sums)]), dim=0)
        return mesh_sum([blk.reshape(-1) for blk in shard_blocks(geo, x)],
                        mesh)

    def exchange(p: DeviceStacks) -> DeviceStacks:
        q = DeviceStacks(part.clone() for part in p.parts)
        exchange_halos(shard_blocks(geo, q), mesh)
        return q

    def dot(u, v):
        # At least one operand of every loop dot is masked (Ap, z, r), so
        # the plain sum is the owned-interior sum.
        return psum(u * v) * (h1 * h2)

    if scaled:
        sc = aux
        return PCGOps(
            # Neighbours need the *scaled* field sc·p on the ring.
            apply_A=lambda p: stencil(exchange(p * sc)) * sc * mask,
            apply_Dinv=lambda r: r,
            dot=dot,
            sqnorm=lambda u: psum((u * sc) * (u * sc) * mask))
    d_int = DeviceStacks(part[..., 1:-1, 1:-1] for part in aux.parts)
    return PCGOps(
        apply_A=lambda p: stencil(p) * mask,
        apply_Dinv=lambda r: DeviceStacks.map(apply_Dinv, r, d_int) * mask,
        dot=dot,
        sqnorm=lambda u: psum(u * u * mask),
        exchange=exchange)


def gather_interior(problem: Problem, mesh: Mesh, geo: ShardGeometry,
                    field: DeviceStacks) -> torch.Tensor:
    """Every shard's owned interior → the full (…, M+1, N+1) grid on the
    lead device (zero ring and padding cut; a member axis is kept); on a
    mesh over processes, gathered to every rank."""
    if mesh.multiprocess:
        blocks = list(gather_shards([blk[..., 1:-1, 1:-1] for blk in
                                     shard_blocks(geo, field)], mesh))
    else:
        blocks = [blk[..., 1:-1, 1:-1].to(mesh.lead)
                  for blk in shard_blocks(geo, field)]
    rows = [torch.cat(blocks[ix * geo.py : (ix + 1) * geo.py], dim=-1)
            for ix in range(geo.px)]
    w_int = torch.cat(rows, dim=-2)
    return pad_interior(w_int[..., : problem.M - 1, : problem.N - 1])


def scatter_interior(problem: Problem, mesh: Mesh, geo: ShardGeometry,
                     full, dtype) -> DeviceStacks:
    """A full (M+1, N+1) grid (numpy) → every local shard's block, owned
    interior filled and ring zero (the halo-ring invariant of the
    checkpoint format, ``parallel.checkpoint_sharded``)."""
    M, N = problem.M, problem.N
    padded = np.zeros((geo.px * geo.m_blk, geo.py * geo.n_blk))
    padded[: M - 1, : N - 1] = np.asarray(full)[1:M, 1:N]
    blocks = []
    for s in geo.local:
        dev = mesh.devices[s]
        ix, iy = divmod(s, geo.py)
        blk = np.zeros((geo.m_blk + 2, geo.n_blk + 2))
        blk[1:-1, 1:-1] = padded[ix * geo.m_blk : (ix + 1) * geo.m_blk,
                                 iy * geo.n_blk : (iy + 1) * geo.n_blk]
        blocks.append(torch.tensor(blk, dtype=dtype, device=dev))
    return from_blocks(geo, blocks)


def resolve_mesh(mesh: Mesh | None, device=None) -> Mesh:
    """``mesh``, or with none every visible card, or a one-shard mesh on
    ``device`` when one is asked for (``device='cpu'``)."""
    if mesh is not None:
        if device is not None:
            raise ValueError("give a mesh or a device, not both")
        return mesh
    return make_solver_mesh(None if device is None else [device])


def pcg_solve_sharded(problem: Problem, mesh: Mesh | None = None,
                      dtype=None, scaled=None, setup: str = "host",
                      device=None,
                      check_every: int = CHECK_EVERY) -> PCGResult:
    """Distributed plain solve over ``mesh`` (the counterpart of
    ``poisson_tpu.parallel.pcg_sharded.pcg_solve_sharded``): fp64 Jacobi-PCG
    by default, fp32 on the scaled system; any Px × Py, a 1 × 1 mesh being
    the single-device solve. ``mesh`` defaults to every visible card, or to
    one shard on ``device``; ``setup`` is ``"host"`` or ``"device"`` (see
    the module doc)."""
    mesh = resolve_mesh(mesh, device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    geo = geometry(problem, mesh)
    fields = sharded_fields(problem, mesh, geo, dtype_name, use_scaled,
                            setup)
    ops = sharded_ops(problem, mesh, geo, fields, use_scaled)
    s = pcg_loop(ops, fields.rhs, delta=problem.delta,
                 max_iter=problem.iteration_cap,
                 weighted_norm=problem.weighted_norm, h1=problem.h1,
                 h2=problem.h2, check_every=check_every)
    w = s.w * fields.aux if use_scaled else s.w
    return PCGResult(w=gather_interior(problem, mesh, geo, w),
                     iterations=s.k, diff=s.diff, residual_dot=s.zr,
                     flag=s.flag)


def member_fields(fields: ShardedFields) -> ShardedFields:
    """The operator fields with a member axis of 1, (shards, 1, m̂+2,
    n̂+2), to broadcast over a batch; the rhs is left out (None)."""
    widen = lambda f: DeviceStacks(part[:, None] for part in f.parts)
    return ShardedFields(widen(fields.a), widen(fields.b), None,
                         widen(fields.aux), widen(fields.mask))


def shard_rhs_stack(rhs_stack: torch.Tensor, px: int, py: int, m_blk: int,
                    n_blk: int) -> torch.Tensor:
    """A (B, M+1, N+1) stack of full-grid right-hand sides cut into
    halo-inclusive blocks (px·py, B, m̂+2, n̂+2), leading axis in mesh order
    (the JAX module's ``shard_rhs_stack``), on the stack's device."""
    nb, rows, cols = rhs_stack.shape
    full = rhs_stack.new_zeros((nb, px * m_blk + 2, py * n_blk + 2))
    full[:, :rows, :cols] = rhs_stack
    return torch.stack([
        full[:, ix * m_blk : ix * m_blk + m_blk + 2,
             iy * n_blk : iy * n_blk + n_blk + 2]
        for ix in range(px) for iy in range(py)])


def solve_batched_sharded(problem: Problem, mesh: Mesh, dtype_name: str,
                          scaled: bool, rhs_stack: torch.Tensor) -> PCGResult:
    """B right-hand sides solved together on ``mesh`` (host setup): the
    engine of ``solvers.batched.solve_batched(mesh=)``. ``rhs_stack`` is
    the (B, M+1, N+1) stack in the solve's system (scaled by D^{-1/2} when
    ``scaled``), padded already; returns a batched :class:`PCGResult`
    (w gathered to the full grids on the lead device)."""
    from poisson_tpu_torch.solvers.batched import (
        batched_result,
        pcg_loop_batched,
    )

    geo = geometry(problem, mesh)
    fields = member_fields(sharded_fields(problem, mesh, geo, dtype_name,
                                          scaled))
    blocks = shard_rhs_stack(rhs_stack, geo.px, geo.py, geo.m_blk,
                             geo.n_blk)
    rhs = DeviceStacks(blocks[list(group)].to(dev) for group, dev in
                       zip(geo.shards, geo.devices)) * fields.mask
    ops = sharded_ops(problem, mesh, geo, fields, scaled, members=True)
    s = pcg_loop_batched(ops, rhs, delta=problem.delta,
                         max_iter=problem.iteration_cap,
                         weighted_norm=problem.weighted_norm,
                         h1=problem.h1, h2=problem.h2)
    w = s.w * fields.aux if scaled else s.w
    return batched_result(gather_interior(problem, mesh, geo, w), s)
