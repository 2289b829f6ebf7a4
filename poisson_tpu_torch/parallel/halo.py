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
  atomics and no collective library, so the result is the same bits on
  every run.

As in the reference, corners are not exchanged diagonally: rows go first
and the columns then span the full height, so the corner values ride along
in two hops (``stage2-mpi/poisson_mpi_decomp.cpp:241-347``).
"""

from __future__ import annotations

import torch

from poisson_tpu_torch.ops.serial import serial_sum
from poisson_tpu_torch.parallel.mesh import X_AXIS, Y_AXIS, Mesh


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


def _shift(canvases, mesh: Mesh, axis: str, step: int, src, dst) -> None:
    for shard, u in enumerate(canvases):
        n = _neighbour(mesh, shard, axis, step)
        if n is None:
            u[dst].zero_()
        else:
            u[dst].copy_(canvases[n][src])


def shift_down(canvases, mesh: Mesh, axis: str, src, dst) -> None:
    """Every shard's ``dst`` slice ← the ``src`` slice of the shard at
    coordinate c−1 along ``axis``; zeros at c = 0. In place; ``src`` and
    ``dst`` must not overlap within a canvas."""
    _shift(canvases, mesh, axis, -1, src, dst)


def shift_up(canvases, mesh: Mesh, axis: str, src, dst) -> None:
    """Every shard's ``dst`` slice ← the ``src`` slice of the shard at
    coordinate c+1 along ``axis``; zeros at c = size−1."""
    _shift(canvases, mesh, axis, +1, src, dst)


def exchange_halos(blocks, mesh: Mesh) -> None:
    """Refresh the width-1 halo ring of every shard's (m+2, n+2) block, in
    place: the first and last interior rows travel to the row neighbours'
    halo rows, then the first and last interior columns, over the full
    height, to the column neighbours' halo columns. A block may carry
    leading member axes (a batch); the ring is that of its last two."""
    every = slice(None)
    shift_down(blocks, mesh, X_AXIS, (..., -2, every), (..., 0, every))
    shift_up(blocks, mesh, X_AXIS, (..., 1, every), (..., -1, every))
    shift_down(blocks, mesh, Y_AXIS, (..., every, -2), (..., every, 0))
    shift_up(blocks, mesh, Y_AXIS, (..., every, 1), (..., every, -1))


def _shard_sum(part, run):
    if run is None:
        return torch.sum(part, dim=0)
    if isinstance(part, torch.Tensor) and part.dim() == 2:
        return serial_sum(part.T, run)      # kernel C's (tiles, 12) Gram
    return serial_sum(part, run)


def mesh_sum(partials, mesh: Mesh, run: int | None = None) -> torch.Tensor:
    """Σ over shards of Σ over each shard's partials (along dim 0), on the
    lead device, summed in mesh order.

    With ``run`` (the serial-reduce mode) each shard's partials go through
    kernel S on its own device first, as each JAX shard Kahan-sums its
    strips before the ``psum``; a shard's entry may then also be a sequence
    of partials vectors, summed by one launch into a vector of sums."""
    lead = mesh.lead
    per_shard = [_shard_sum(p, run).to(lead) for p in partials]
    return torch.sum(torch.stack(per_shard), dim=0)


def replicate(x: torch.Tensor, mesh: Mesh) -> tuple:
    """``x`` on every shard's device (one copy per distinct device)."""
    copies: dict = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = x.to(d)
    return tuple(copies[d] for d in mesh.devices)
