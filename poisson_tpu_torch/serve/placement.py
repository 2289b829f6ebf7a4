"""Device placement: the registry that binds fleet workers to devices
(counterpart of ``poisson_tpu/serve/placement.py``).

The unit of placement is a **fault domain**: a logical device slot backed
by a ``torch.device``. ``DeviceRegistry()`` enumerates the CUDA cards
(``cuda:0`` … ``cuda:n-1``) and raises without one, the way every entry
point of the port does; a caller that wants the CPU passes CPU devices.
With fewer backing devices than slots the registry *oversubscribes*:
several slots share one card, so the supervision logic (who shares a fate
when slot 3 dies) runs anywhere, while every dispatch lands on its slot's
real backing device.

Topology is versioned: every :meth:`DeviceRegistry.lose` bumps the
**placement epoch**. Journal records carry the epoch and the bound device
id, so ``--recover`` on a *different* topology remaps a pending request
audibly (``serve.placement.remapped`` + a ``placement_remapped`` flight
point) and never resumes onto a device id that is gone. A placement that
cannot be satisfied (a pinned request whose device died, a bind with no
survivors) is a typed :class:`PlacementError`.

The elastic ladder for sharded dispatches lives here too
(:func:`elastic_plan`): mesh shrink → single device → shed, each rung a
``serve.degraded.*`` counter.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.utils.platform import device_name, resolve_device


def default_devices(device=None) -> List[torch.device]:
    """The backing devices for ``device``: every CUDA card for ``None``
    or a bare ``"cuda"`` (raising without one), else the one device
    named (``"cpu"``, ``"cuda:1"``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


class PlacementError(RuntimeError):
    """A placement that cannot be satisfied on the current topology —
    binding a worker with no surviving device, or recovering a request
    pinned to a device id that no longer exists. Typed so callers
    (submit validation, journal recovery) surface it as a loud error
    or a typed outcome instead of wedging on a missing chip."""


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a worker lives: the logical fault-domain slot it is bound
    to, the slot's backing physical device, and the epoch the binding
    was made under (stale epoch ⇒ the topology changed since)."""

    device_id: int            # logical fault-domain slot
    device_kind: str          # backing device's kind (hardware identity)
    epoch: int                # registry epoch at bind time
    device: object = dataclasses.field(compare=False, hash=False,
                                       default=None)  # torch.device

    def label(self) -> str:
        return f"{self.device_kind}:{self.device_id}"


class DeviceRegistry:
    """The fleet's view of its device topology.

    ``count`` logical slots (default: one per physical device) are
    backed round-robin by ``devices`` (default: every CUDA card; raises
    without one).
    ``lose(device_id)`` marks a slot's silicon gone and bumps the
    placement epoch; ``bind`` hands out placements over the survivors
    and raises :class:`PlacementError` when none remain. All counters
    live under ``serve.placement.*`` (see ``obs.metrics``)."""

    def __init__(self, count: Optional[int] = None,
                 devices: Optional[Sequence] = None):
        if devices is None:
            devices = default_devices()
        if not devices:
            raise PlacementError("device registry needs at least one "
                                 "backing device")
        self._backing = list(devices)
        n = int(count) if count is not None else len(self._backing)
        if n < 1:
            raise ValueError(f"device count must be >= 1, got {n}")
        self._slots = [self._backing[i % len(self._backing)]
                       for i in range(n)]
        self._lost: set = set()
        self.epoch = 1
        self._rr = 0
        obs.gauge("serve.placement.devices", n)
        obs.gauge("serve.placement.epoch", self.epoch)

    # -- topology ------------------------------------------------------

    def __len__(self) -> int:
        return len(self._slots)

    def alive(self) -> List[int]:
        return [i for i in range(len(self._slots)) if i not in self._lost]

    def is_alive(self, device_id: int) -> bool:
        return 0 <= int(device_id) < len(self._slots) \
            and int(device_id) not in self._lost

    def device(self, device_id: int):
        """The backing ``torch.device`` of a slot (lost or alive —
        forensics may still want to name the silicon)."""
        return self._slots[int(device_id)]

    def kind(self, device_id: int) -> str:
        return device_name(self._slots[int(device_id)])

    def describe(self) -> dict:
        """JSON-ready topology summary — what the journal's topology
        record and the bench detail carry."""
        return {
            "devices": len(self._slots),
            "alive": len(self.alive()),
            "lost": sorted(self._lost),
            "epoch": self.epoch,
            "kinds": sorted({self.kind(i) for i in range(len(self._slots))}),
        }

    # -- binding -------------------------------------------------------

    def bind(self, worker_id: int) -> Placement:
        """Bind ``worker_id`` to the next surviving slot (round-robin —
        workers spread over the alive topology). Raises
        :class:`PlacementError` with no survivors."""
        alive = self.alive()
        if not alive:
            raise PlacementError(
                f"no surviving device to bind worker {worker_id} "
                f"({len(self._lost)}/{len(self._slots)} lost)")
        slot = alive[self._rr % len(alive)]
        self._rr += 1
        obs.inc("serve.placement.binds")
        return Placement(device_id=slot, device_kind=self.kind(slot),
                         epoch=self.epoch, device=self._slots[slot])

    def remap(self, device_id: Optional[int], worker_id: int = -1
              ) -> Placement:
        """A placement recorded under an older topology, mapped onto
        this one: alive → same slot rebound at the current epoch; gone
        → a surviving slot, counted ``serve.placement.remapped`` (the
        audible never-silently-resume contract)."""
        if device_id is not None and self.is_alive(int(device_id)):
            slot = int(device_id)
            return Placement(device_id=slot, device_kind=self.kind(slot),
                             epoch=self.epoch, device=self._slots[slot])
        placement = self.bind(worker_id)     # raises when none survive
        obs.inc("serve.placement.remapped")
        obs.event("serve.placement.remap", from_device=device_id,
                  to_device=placement.device_id, epoch=self.epoch)
        return placement

    # -- fault domains -------------------------------------------------

    def lose(self, device_id: int) -> bool:
        """Mark a slot's silicon gone. Bumps the placement epoch and
        returns True on the first loss of this slot (idempotent — a
        second report of the same dead device changes nothing)."""
        device_id = int(device_id)
        if not (0 <= device_id < len(self._slots)):
            raise PlacementError(
                f"device id {device_id} outside topology "
                f"0..{len(self._slots) - 1}")
        if device_id in self._lost:
            return False
        self._lost.add(device_id)
        self.epoch += 1
        obs.gauge("serve.placement.epoch", self.epoch)
        obs.gauge("serve.placement.alive", len(self.alive()))
        obs.event("serve.placement.device_lost", device=device_id,
                  kind=self.kind(device_id), epoch=self.epoch,
                  alive=len(self.alive()))
        return True


# -- elastic degradation for sharded dispatches --------------------------

RUNG_MESH = "mesh"
RUNG_SINGLE = "single"
RUNG_SHED = "shed"


def elastic_plan(registry: DeviceRegistry, want_devices: int) -> tuple:
    """Re-plan a sharded dispatch onto the surviving topology — the
    elastic degradation ladder for mesh work, counted like the queue
    ladder:

    - enough survivors for a multi-device mesh → ``("mesh", slots)``
      (shrunk below ``want_devices`` counts
      ``serve.degraded.mesh_shrink``);
    - exactly one survivor → ``("single", slot)`` — the dispatch
      downshifts to the single-device path,
      ``serve.degraded.single_device``;
    - none → ``("shed", None)`` — the work must shed or error, never
      silently run nowhere (``serve.degraded.mesh_shed``).

    The slots are logical fault domains; callers that actually build a
    mesh map them through :meth:`DeviceRegistry.device` (the port's mesh
    allows a device to repeat, ``parallel.mesh.make_solver_mesh``).
    """
    alive = registry.alive()
    want = max(1, int(want_devices))
    if not alive:
        obs.inc("serve.degraded.mesh_shed")
        obs.event("serve.placement.replan", rung=RUNG_SHED, want=want,
                  alive=0)
        return (RUNG_SHED, None)
    if len(alive) == 1:
        if want > 1:
            obs.inc("serve.degraded.single_device")
        obs.event("serve.placement.replan", rung=RUNG_SINGLE, want=want,
                  alive=1)
        return (RUNG_SINGLE, alive[0])
    plan = alive[:want]
    if len(plan) < want:
        obs.inc("serve.degraded.mesh_shrink")
    obs.inc("serve.placement.replans")
    obs.event("serve.placement.replan", rung=RUNG_MESH, want=want,
              alive=len(alive), planned=len(plan))
    return (RUNG_MESH, plan)
