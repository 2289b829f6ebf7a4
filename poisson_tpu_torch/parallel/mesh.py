"""The solver mesh: a Px×Py process grid of shards, one ``torch.device``
each (counterpart of ``poisson_tpu/parallel/mesh.py``).

The reference factorises its MPI world into a near-square Px×Py grid
(``choose_process_grid``, ``stage2-mpi/poisson_mpi_decomp.cpp:60-64``). The
JAX package lays ``jax.devices()`` onto that grid as a ``Mesh`` with axes
('x', 'y') and drives every shard from one program through ``shard_map``.
A :class:`Mesh` holds one device per shard in x-major order (shard
``ix·py + iy``, the JAX stacking order) and the rank that owns each shard.
In one process every shard is rank 0's and one host thread drives them
all. After ``parallel.multihost.initialize_multihost`` the mesh spans the
process group: each rank declares its own devices, :func:`make_solver_mesh`
all-gathers them, and every rank sees the same mesh, its shards ordered by
rank and then by local index (as ``jax.devices()`` orders by process); a
rank drives only its own shards (:attr:`Mesh.local`). A device may repeat,
so four shards can share one card, as the JAX tests share the CPU among 8
virtual devices; on the CPU every shard sits on ``cpu``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from poisson_tpu_torch.parallel.multihost import process_rank, world_size
from poisson_tpu_torch.utils.platform import resolve_device

X_AXIS = "x"
Y_AXIS = "y"


def choose_process_grid(size: int) -> tuple[int, int]:
    """Near-square factorisation Px·Py = size, Px ≤ Py
    (``stage2-mpi/poisson_mpi_decomp.cpp:60-64``)."""
    px = int(math.isqrt(size))
    while px > 1 and size % px != 0:
        px -= 1
    return px, size // px


def block_size(total_interior: int, parts: int) -> int:
    """Uniform per-shard block: ceil(total/parts). The reference balances
    blocks differing by ≤ 1 (``stage2:…cpp:75-111``); equal shapes per
    shard pad the interior to parts·block, with zero coefficients on the
    padding."""
    return -(-total_interior // parts)


class Mesh(NamedTuple):
    """A px × py grid of shards; ``devices[ix·py + iy]`` holds shard
    (ix, iy), owned by the process of rank ``owners[ix·py + iy]`` (empty
    in one process: every shard is rank 0's). Devices may repeat."""

    px: int
    py: int
    devices: tuple[torch.device, ...]
    owners: tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return self.px * self.py

    @property
    def multiprocess(self) -> bool:
        """True when the shards are spread over several processes."""
        return any(self.owners)

    @property
    def local(self) -> tuple[int, ...]:
        """The shards this process drives, in mesh order: every shard in
        one process."""
        if not self.multiprocess:
            return tuple(range(self.size))
        rank = process_rank()
        return tuple(s for s, o in enumerate(self.owners) if o == rank)

    @property
    def lead(self) -> torch.device:
        """Where the mesh-wide scalars live: this process's first shard's
        device."""
        if not self.multiprocess:
            return self.devices[0]
        return self.devices[self.local[0]]


def check_mesh(mesh: Mesh) -> Mesh:
    """``mesh``, if it spans the process group as it stands. A mesh built
    before ``initialize_multihost`` formed a group of several processes
    would have each process solve alone on every shard: that ordering
    mistake raises, and says what to move."""
    spans = max(mesh.owners, default=0) + 1
    world = world_size()
    if spans == world:
        return mesh
    if spans == 1:
        raise RuntimeError(
            f"this mesh was built before initialize_multihost() formed the "
            f"process group of {world} processes, so each process would "
            "solve alone: build it with make_solver_mesh() after "
            "initialize_multihost()")
    raise RuntimeError(f"this mesh spans {spans} processes, but the process "
                       f"group has {world}")


def _canonical(device) -> torch.device:
    """A resolved device with its index made explicit (``cuda`` → the
    current card), so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _gather_devices(devs: tuple) -> tuple[tuple, tuple]:
    """Every rank's devices, in rank order, and the owner of each: a
    collective, so every rank builds its mesh at the same point."""
    declared: list = [None] * world_size()
    dist.all_gather_object(declared, [str(d) for d in devs])
    if not all(declared):
        raise ValueError("every process must declare at least one device; "
                         f"declared: {declared}")
    return (tuple(torch.device(d) for names in declared for d in names),
            tuple(r for r, names in enumerate(declared) for _ in names))


def make_solver_mesh(devices: Optional[Sequence] = None,
                     grid: Optional[tuple[int, int]] = None) -> Mesh:
    """Mesh over ``devices`` (default: every visible card, as
    ``jax.devices()``; in a process group, this process's current card),
    shaped by :func:`choose_process_grid` unless ``grid`` is given. In a
    process group of several processes ``devices`` are this process's
    shards and the mesh holds every rank's (a collective: every rank calls
    it). Raises when px·py differs from the number of devices, and, as
    every entry point of the port, when a card is asked for and none is
    available."""
    multiprocess = world_size() > 1
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if multiprocess and count:
            devices = [f"cuda:{torch.cuda.current_device()}"]
        else:
            devices = ([f"cuda:{i}" for i in range(count)] if count
                       else [None])      # resolve_device(None) raises
    devs = tuple(_canonical(d) for d in devices)
    owners: tuple = ()
    if multiprocess:
        devs, owners = _gather_devices(devs)
    if grid is None:
        grid = choose_process_grid(len(devs))
    px, py = (int(n) for n in grid)
    if px < 1 or py < 1 or px * py != len(devs):
        raise ValueError(f"grid {(px, py)} != #devices {len(devs)}")
    return Mesh(px=px, py=py, devices=devs, owners=owners)
