"""The solver mesh: a Px×Py process grid of shards, one ``torch.device``
each (counterpart of ``poisson_tpu/parallel/mesh.py``).

The reference factorises its MPI world into a near-square Px×Py grid
(``choose_process_grid``, ``stage2-mpi/poisson_mpi_decomp.cpp:60-64``). The
JAX package lays ``jax.devices()`` onto that grid as a ``Mesh`` with axes
('x', 'y') and drives every shard from one program through ``shard_map``.
The port keeps that single-controller model: a :class:`Mesh` holds one
device per shard in x-major order (shard ``ix·py + iy``, the JAX stacking
order), and one host thread drives every shard. A device may repeat, so
four shards can share one card, as the JAX tests share the CPU among 8
virtual devices; on the CPU every shard sits on ``cpu``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import torch

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
    (ix, iy). Devices may repeat."""

    px: int
    py: int
    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return self.px * self.py

    @property
    def lead(self) -> torch.device:
        """Where the mesh-wide scalars live: the first shard's device."""
        return self.devices[0]


def _canonical(device) -> torch.device:
    """A resolved device with its index made explicit (``cuda`` → the
    current card), so that equal devices compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_solver_mesh(devices: Optional[Sequence] = None,
                     grid: Optional[tuple[int, int]] = None) -> Mesh:
    """Mesh over ``devices`` (default: every visible card, as
    ``jax.devices()``), shaped by :func:`choose_process_grid` unless
    ``grid`` is given. Raises when px·py differs from the number of
    devices, and, as every entry point of the port, when a card is asked
    for and none is available."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([f"cuda:{i}" for i in range(count)] if count
                   else [None])      # resolve_device(None) raises
    devs = tuple(_canonical(d) for d in devices)
    if grid is None:
        grid = choose_process_grid(len(devs))
    px, py = (int(n) for n in grid)
    if px < 1 or py < 1 or px * py != len(devs):
        raise ValueError(f"grid {(px, py)} != #devices {len(devs)}")
    return Mesh(px=px, py=py, devices=devs)
