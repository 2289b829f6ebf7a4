"""Halo exchange and mesh-wide sums between the shards of a :class:`Mesh`
(counterpart of ``poisson_tpu/parallel/halo.py``).

The JAX package shifts slices along a mesh axis with ``lax.ppermute``, whose
zero fill at the mesh edge is the homogeneous Dirichlet value, and sums
scalars with ``lax.psum``. Here one host thread holds every shard's canvas:

- a shift copies each neighbour's slice into this shard's halo slice
  (``Tensor.copy_``; on one card a same-device copy, across cards a peer
  copy ordered on the current streams of both) and writes zeros at the mesh
  edge;
- :func:`mesh_sum` sums each shard's partials on its own device, stacks the
  per-shard sums on the lead device in shard order and sums them there. No
  atomics and no reduction collective, so the result is the same bits on
  every run.

On a mesh over processes (``parallel.multihost``) each rank holds only its
own shards (``Mesh.local``; a per-shard list here has one entry per local
shard, in mesh order):

- a shift copies between the rank's own shards as above, and a slice bound
  for a shard of another rank travels by point-to-point transfer
  (``batch_isend_irecv``: every send and receive of a shift, or of both
  shifts along an axis, :func:`shift_both`, posted before any is awaited,
  matched by the move and the receiving shard's number);
- :func:`mesh_sum` all-gathers the per-shard sums, stacks them in mesh
  order and sums them on every rank with the one-process call, never with
  ``all_reduce``: its order depends on the backend and the world size, and
  every rank must read the same bits of ``done`` and the step scalars, or
  one rank leaves ``drive``'s loop while another waits in a collective.

So a mesh driven by several processes gives the bits one process gives.
Under gloo, which moves host tensors only, a CUDA slice or sum is staged
through host memory, explicitly; under NCCL it moves device to device.

As in the reference, corners are not exchanged diagonally: rows go first
and the columns then span the full height, so the corner values ride along
in two hops (``stage2-mpi/poisson_mpi_decomp.cpp:241-347``).

While a profiler runs, each call is one host range (``obs.profile.region``;
none nested in another of its name): ``mesh.halo`` around a shift (or both
shifts of :func:`shift_both`), ``mesh.sum`` around :func:`mesh_sum` and
:func:`mesh_sums`, ``mesh.replicate`` around :func:`replicate`. Always on,
once a call: ``mesh.halo_copies`` / ``mesh.halo_bytes`` count the slices
this process wrote into its shards' halos from another shard, and their
bytes (zero fills at the mesh edge are not copies); ``mesh.sums`` the sums
taken (a call of :func:`mesh_sum`, or a group of :func:`mesh_sums`);
``mesh.replicas`` the copies :func:`replicate` makes to a device other
than the value's. A block of the sharded body replayed as a captured graph
(``solvers.graphs``) calls none of these functions: it enters no range
(they ran once, inside the capture), and adds to the counters what its
capture counted, so they read what the eager loop would.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from poisson_tpu_torch import obs
from poisson_tpu_torch.obs.profile import region
from poisson_tpu_torch.ops.serial import serial_sum
from poisson_tpu_torch.parallel.mesh import X_AXIS, Y_AXIS, Mesh
from poisson_tpu_torch.parallel.multihost import process_rank


def _neighbour(mesh: Mesh, shard: int, axis: str, step: int):
    """The shard ``step`` places along ``axis`` from ``shard``, or None past
    the mesh edge."""
    ix, iy = divmod(shard, mesh.py)
    if axis == X_AXIS:
        ix += step
    elif axis == Y_AXIS:
        iy += step
    else:
        raise ValueError(f"unknown mesh axis {axis!r}")
    if 0 <= ix < mesh.px and 0 <= iy < mesh.py:
        return ix * mesh.py + iy
    return None


def _staging(device: torch.device) -> torch.device:
    """Where a tensor on ``device`` crosses to another process: the host
    under gloo (host tensors only), the device itself under NCCL."""
    if device.type == "cuda" and dist.get_backend() == "gloo":
        return torch.device("cpu")
    return device


def _staged(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``x`` on ``device`` to send (a host sync when
    it leaves a card)."""
    if x.device != device:
        obs.inc("multihost.staged_copies")
    return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)


def _count_halo(copied) -> None:
    """Count the halo slices ``copied`` (the written views) at once."""
    if copied:
        obs.inc("mesh.halo_copies", len(copied))
        obs.inc("mesh.halo_bytes",
                sum(v.numel() * v.element_size() for v in copied))


def _shift(canvases, mesh: Mesh, axis: str, step: int, src, dst) -> list:
    """One shift on a one-process mesh; the halo slices it copied into."""
    copied = []
    for shard, u in enumerate(canvases):
        n = _neighbour(mesh, shard, axis, step)
        if n is None:
            u[dst].zero_()
        else:
            copied.append(u[dst].copy_(canvases[n][src]))
    return copied


def _shift_across(canvases, mesh: Mesh, axis: str, moves) -> list:
    """Shifts ``moves`` ((step, src, dst) each) along ``axis`` on a mesh
    over processes, in one round of transfers: this rank's ``canvases``
    (one per local shard); a neighbour on another rank sends its slice,
    tagged by the move and the receiving shard. The halo slices written
    from another shard, this rank's or not."""
    local = mesh.local
    rank = process_rank()
    at = {shard: i for i, shard in enumerate(local)}
    sends, recvs, inbound, copied = [], [], [], []
    for m, (step, src, dst) in enumerate(moves):
        for i, shard in enumerate(local):
            u = canvases[i]
            reader = _neighbour(mesh, shard, axis, -step)
            if reader is not None and mesh.owners[reader] != rank:
                buf = _staged(u[src], _staging(u.device))
                sends.append(dist.P2POp(dist.isend, buf,
                                        mesh.owners[reader],
                                        tag=m * mesh.size + reader))
                obs.inc("multihost.sent_bytes",
                        buf.numel() * buf.element_size())
            n = _neighbour(mesh, shard, axis, step)
            if n is None:
                u[dst].zero_()
            elif n in at:
                copied.append(u[dst].copy_(canvases[at[n]][src]))
            else:
                buf = torch.empty(u[dst].shape, dtype=u.dtype,
                                  device=_staging(u.device))
                recvs.append(dist.P2POp(dist.irecv, buf, mesh.owners[n],
                                        tag=m * mesh.size + shard))
                inbound.append((u, dst, buf))
    if sends or recvs:
        for work in dist.batch_isend_irecv(sends + recvs):
            work.wait()
    for u, dst, buf in inbound:
        copied.append(u[dst].copy_(buf))
    return copied


def _shifts(canvases, mesh: Mesh, axis: str, moves) -> None:
    """``moves`` ((step, src, dst) each) along ``axis`` in turn, over
    processes in one round of transfers: one ``mesh.halo`` range, counted
    once."""
    with region("mesh.halo"):
        if mesh.multiprocess:
            copied = _shift_across(canvases, mesh, axis, moves)
        else:
            copied = [v for step, src, dst in moves
                      for v in _shift(canvases, mesh, axis, step, src, dst)]
        _count_halo(copied)


def shift_down(canvases, mesh: Mesh, axis: str, src, dst) -> None:
    """Every shard's ``dst`` slice ← the ``src`` slice of the shard at
    coordinate c−1 along ``axis``; zeros at c = 0. In place; ``src`` and
    ``dst`` must not overlap within a canvas."""
    _shifts(canvases, mesh, axis, ((-1, src, dst),))


def shift_up(canvases, mesh: Mesh, axis: str, src, dst) -> None:
    """Every shard's ``dst`` slice ← the ``src`` slice of the shard at
    coordinate c+1 along ``axis``; zeros at c = size−1."""
    _shifts(canvases, mesh, axis, ((+1, src, dst),))


def shift_both(canvases, mesh: Mesh, axis: str, down, up) -> None:
    """:func:`shift_down` with ``down`` = (src, dst), then :func:`shift_up`
    with ``up``; over processes both in one round of transfers (the two
    read the interior and write disjoint halo slices)."""
    _shifts(canvases, mesh, axis, ((-1, *down), (+1, *up)))


def exchange_halos(blocks, mesh: Mesh) -> None:
    """Refresh the width-1 halo ring of every shard's (m+2, n+2) block, in
    place: the first and last interior rows travel to the row neighbours'
    halo rows, then the first and last interior columns, over the full
    height, to the column neighbours' halo columns. A block may carry
    leading member axes (a batch); the ring is that of its last two."""
    every = slice(None)
    shift_both(blocks, mesh, X_AXIS, ((..., -2, every), (..., 0, every)),
               ((..., 1, every), (..., -1, every)))
    shift_both(blocks, mesh, Y_AXIS, ((..., every, -2), (..., every, 0)),
               ((..., every, 1), (..., every, -1)))


def _shard_sum(part, run):
    if run is None:
        return torch.sum(part, dim=0)
    if isinstance(part, torch.Tensor) and part.dim() == 2:
        return serial_sum(part.T, run)      # kernel C's (tiles, 12) Gram
    return serial_sum(part, run)


def gather_shards(values, mesh: Mesh) -> torch.Tensor:
    """Every shard's value, stacked in mesh order on this rank's lead
    device, from each rank's ``values`` (one per local shard, all of one
    shape and dtype) on a mesh over processes: one ``all_gather``, each
    rank's stack padded to the most shards a rank holds."""
    lead = mesh.lead
    mine = _staged(torch.stack([v.to(lead) for v in values]),
                   _staging(lead))
    held = [mesh.owners.count(r) for r in range(max(mesh.owners) + 1)]
    if len(values) < max(held):
        mine = torch.cat([mine, mine.new_zeros(
            (max(held) - len(values),) + tuple(mine.shape[1:]))])
    every = [torch.empty_like(mine) for _ in held]
    dist.all_gather(every, mine)
    obs.inc("multihost.sent_bytes",
            mine.numel() * mine.element_size() * (len(held) - 1))
    seen = [0] * len(held)
    order = []
    for owner in mesh.owners:
        order.append(every[owner][seen[owner]])
        seen[owner] += 1
    return torch.stack(order).to(lead)


def _sum_shards(partials, mesh: Mesh, run: int | None) -> torch.Tensor:
    if mesh.multiprocess:
        return torch.sum(gather_shards([_shard_sum(p, run) for p in partials],
                                       mesh), dim=0)
    lead = mesh.lead
    per_shard = [_shard_sum(p, run).to(lead) for p in partials]
    return torch.sum(torch.stack(per_shard), dim=0)


def mesh_sum(partials, mesh: Mesh, run: int | None = None) -> torch.Tensor:
    """Σ over shards of Σ over each shard's partials (along dim 0), on the
    lead device, summed in mesh order.

    With ``run`` (the serial-reduce mode) each shard's partials go through
    kernel S on its own device first, as each JAX shard Kahan-sums its
    strips before the ``psum``; a shard's entry may then also be a sequence
    of partials vectors, summed by one launch into a vector of sums. On a
    mesh over processes every rank sums the same stack, so every rank gets
    the same bits, those of one process."""
    with region("mesh.sum"):
        obs.inc("mesh.sums")
        return _sum_shards(partials, mesh, run)


def mesh_sums(groups, mesh: Mesh) -> list:
    """:func:`mesh_sum` of each group of partials; over processes the
    groups' per-shard sums travel in one all-gather, and each is summed
    as :func:`mesh_sum` sums it (a contiguous stack in mesh order)."""
    with region("mesh.sum"):
        obs.inc("mesh.sums", len(groups))
        if not mesh.multiprocess:
            return [_sum_shards(parts, mesh, None) for parts in groups]
        every = gather_shards([torch.stack([torch.sum(p, dim=0)
                                            for p in shard])
                               for shard in zip(*groups)], mesh)
        return [torch.sum(every[:, q].contiguous(), dim=0)
                for q in range(len(groups))]


def replicate(x: torch.Tensor, mesh: Mesh) -> tuple:
    """``x`` on every local shard's device (one copy per distinct
    device)."""
    with region("mesh.replicate"):
        copies: dict = {}
        devices = [mesh.devices[s] for s in mesh.local]
        for d in devices:
            if d not in copies:
                copies[d] = x.to(d)
        moved = sum(d != x.device for d in copies)
        if moved:
            obs.inc("mesh.replicas", moved)
        return tuple(copies[d] for d in devices)
