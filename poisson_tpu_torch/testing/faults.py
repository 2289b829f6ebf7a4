"""Fault injection for the resilience and integrity layers, the solver
side and the service side (counterpart of ``poisson_tpu/testing/faults.py``).

- **NaN blow-up**: :func:`inject_nan` pokes a NaN into a solver buffer at a
  chunk boundary; the in-loop verdict (``solvers.pcg``) flags it and the
  resilient driver (``solvers.resilient``) restarts from the last good
  iterate.
- **Silent corruption**: :func:`inject_bitflip` flips one storage bit of a
  buffer, finite and silent; only the integrity probe
  (``poisson_tpu_torch.integrity``) sees it.
- **Checkpoint corruption**: :func:`corrupt_file` flips, truncates or zeroes
  a checkpoint on disk; the loader's CRC catches it and falls back a
  generation.
- **Preemption**: :func:`chunk_hook` raises :class:`PreemptionInjected`
  between chunks; a rerun resumes from the checkpoint.

The element choice and the flipped bits are the JAX package's, in numpy
with ``random.Random(seed)``: a buffer is copied to the host, flipped there
and put back on its tensor's device, so the port corrupts the same element
of the same array as the JAX package.

The service side (the JAX module's second half) injects into the solve
service's seams (``serve.service``): :func:`poison_batch_fault` and
:func:`slow_worker_fault` at ``dispatch_fault``; :func:`worker_kill_fault`,
:func:`worker_hang_fault`, :func:`device_loss_fault`, :func:`host_drop_fault`,
:func:`kill_device_at` and :func:`kill_worker_at` at ``worker_fault``;
:func:`compose_faults` chains injectors of one seam.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Optional

import numpy as np
import torch


class PreemptionInjected(RuntimeError):
    """Raised by the chunk hook to simulate a preempted host at a chunk
    boundary (after that chunk's checkpoint was persisted)."""


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """The faults to inject into one solve.

    nan_at_iteration: poke a NaN into ``nan_buffer`` at the first chunk
        boundary whose iteration count reaches this value (None: never).
    nan_buffer: which state array to poison ('r', 'w', 'p' or 'z').
    preempt_after_chunks: raise PreemptionInjected once this many chunks
        have completed (None: never).
    """

    nan_at_iteration: Optional[int] = None
    nan_buffer: str = "r"
    preempt_after_chunks: Optional[int] = None

    def __post_init__(self):
        if self.nan_buffer not in ("r", "w", "p", "z"):
            raise ValueError(
                f"nan_buffer must be one of r/w/p/z, got {self.nan_buffer!r}"
            )


def _host_copy(value) -> np.ndarray:
    """A writable numpy copy of a buffer (a tensor on any device, or an
    array)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy().copy()
    return np.array(np.asarray(value))


def _like(arr: np.ndarray, original):
    """``arr`` as the original buffer's kind: a tensor on its device, or an
    array."""
    if isinstance(original, torch.Tensor):
        return torch.from_numpy(arr).to(original.device)
    return arr


def inject_nan(state, buffer: str = "r"):
    """Return ``state`` with a NaN written into the middle cell of the named
    buffer — one poisoned value, which the next stencil spreads as a real
    fault would."""
    original = getattr(state, buffer)
    arr = _host_copy(original)
    arr[tuple(d // 2 for d in arr.shape)] = np.nan
    return state._replace(**{buffer: _like(arr, original)})


_FLOAT_BITS = {
    # dtype name → (exponent MSB, next exponent bit, mantissa MSB):
    # the deterministic bit menu for the two corruption classes. An
    # IEEE754 layout fact, not a tunable.
    "float32": (30, 29, 22),
    "float64": (62, 61, 51),
}


def _exponent_gain(values: np.ndarray) -> np.ndarray:
    """For each value, the largest magnitude a single *silent* exponent
    bit up-flip can reach (0 where none exists). A flip multiplies the
    magnitude by 2^(bit value) for each exponent bit currently CLEAR —
    so the reachable corruption depends on the value's exponent
    pattern: an element whose high exponent bits are mostly set can
    only be nudged (×4, ×256 — perturbations CG absorbs), while one
    with a clear high bit can jump tens of orders of magnitude (the
    catastrophic class the integrity probe exists for). 'Silent' keeps
    the same square/reduction margin as :func:`bitflip_element`."""
    exp_msb, _, mant_msb = _FLOAT_BITS[str(values.dtype)]
    uint = {"float32": np.uint32, "float64": np.uint64}[str(values.dtype)]
    n_exp = exp_msb - mant_msb          # exponent field bits usable
    bits = (np.abs(values).view(uint) >> np.uint64(mant_msb)
            if uint is np.uint64
            else np.abs(values).view(uint) >> np.uint32(mant_msb))
    bits = bits.astype(np.uint64)
    limit = float(np.sqrt(np.finfo(values.dtype).max / 1e8))
    best = np.zeros(values.shape, np.float64)
    mags = np.abs(values).astype(np.float64)
    for k in range(n_exp):
        clear = (bits >> np.uint64(k)) & np.uint64(1) == 0
        with np.errstate(over="ignore"):
            grown = np.ldexp(mags, 2 ** k)   # mags · 2^(2^k), inf-safe
        ok = clear & np.isfinite(grown) & (grown <= limit)
        best = np.where(ok & (grown > best), grown, best)
    return best


def _flip_float_bit(value, bit: int):
    """XOR one bit of a float's storage (same dtype back)."""
    arr = np.asarray(value)
    uint = {"float32": np.uint32, "float64": np.uint64}[str(arr.dtype)]
    flipped = arr.view(uint) ^ uint(np.uint64(1) << np.uint64(bit))
    return flipped.view(arr.dtype)


def bitflip_element(value, bit_class: str = "exponent",
                    bit: Optional[int] = None):
    """Flip one storage bit of a float — the SDC primitive. Returns the
    corrupted value, guaranteed finite and different from the input
    (the point of silent corruption is that NOTHING loud happens — a
    NaN/Inf is caught by the PR 1 divergence detector, which is exactly
    the defense this fault model slips past).

    ``bit_class='exponent'`` picks the exponent bit whose flip grows
    the magnitude the MOST while every square/inner product the solver
    forms with it stays finite — the *silent catastrophic* class. The
    two same-family flips it deliberately avoids are loud or benign,
    not silent: flipping past the overflow line turns the next dot
    product into Inf/NaN (the PR 1 rail fires — defense in depth, not
    this layer's case), and a magnitude-DECREASING flip of one buffer
    entry is a perturbation CG itself absorbs. ``bit_class='mantissa'``
    flips the mantissa MSB (a 1.5×-class perturbation — small, silent,
    the hardest kind; detection is best-effort). An explicit ``bit``
    overrides the class entirely (falling back down the exponent field
    if that exact flip lands non-finite)."""
    arr = np.asarray(value)
    name = str(arr.dtype)
    if name not in _FLOAT_BITS:
        raise ValueError(f"bitflip supports float32/float64 buffers, "
                         f"got {name}")
    exp_msb, exp_lsb, mant_msb = _FLOAT_BITS[name]
    if bit is not None:
        # Explicit bit: honor it, falling back down the exponent field
        # only if the exact flip is non-finite.
        for b in [int(bit)] + list(range(exp_msb, mant_msb, -1)):
            flipped = _flip_float_bit(arr, b)
            if np.isfinite(flipped) and flipped != arr:
                return flipped
        raise ValueError(f"no finite bit flip exists for value {arr!r}")
    if bit_class == "mantissa":
        flipped = _flip_float_bit(arr, mant_msb)
        if np.isfinite(flipped) and flipped != arr:
            return flipped
        raise ValueError(f"mantissa flip of {arr!r} is not silent")
    if bit_class != "exponent":
        raise ValueError(
            f"bit_class must be exponent/mantissa, got {bit_class!r}")
    # Squares (norms, dots) are the first thing the solver forms; a
    # margin of ~1e8 over the square keeps grid-sized reductions finite
    # too, so the corruption stays invisible to the NaN rail.
    limit = float(np.sqrt(np.finfo(arr.dtype).max / 1e8))
    best = None
    for b in range(mant_msb + 1, exp_msb + 1):
        flipped = _flip_float_bit(arr, b)
        if not (np.isfinite(flipped) and flipped != arr):
            continue
        mag = abs(float(flipped))
        if mag <= abs(float(arr)) or mag > limit:
            continue
        if best is None or mag > abs(float(best)):
            best = flipped
    if best is not None:
        return best
    # Value too large for any silent up-flip: take the biggest finite
    # change available (a down-flip — still a flipped bit, still SDC).
    for b in range(exp_msb, mant_msb, -1):
        flipped = _flip_float_bit(arr, b)
        if np.isfinite(flipped) and flipped != arr:
            return flipped
    raise ValueError(f"no finite bit flip exists for value {arr!r}")


_BITFLIP_BUFFERS = {
    # Injectable buffer names → the PCGState field the flip lands in.
    # "Ap" is the transient stencil-application corruption: Ap itself is
    # never stored (recomputed every iteration), so its ONLY persistent
    # trace is the entry it wrote into the residual recurrence
    # r ← r − αAp — flipping r's landed entry IS the Ap fault model,
    # and it is exactly what the drift invariant ‖(b − Aw) − r‖ sees.
    "w": "w",
    "r": "r",
    "p": "p",
    "z": "z",
    "Ap": "r",
}


def inject_bitflip(state, buffer: str = "w", member: Optional[int] = None,
                   element: Optional[tuple] = None,
                   bit_class: str = "exponent",
                   bit: Optional[int] = None, seed: int = 0):
    """Return ``state`` with one storage bit flipped in the named buffer
    (finite: the NaN rail must not fire, only the integrity probe can see
    it). ``member`` picks one member of a batched or lane state (the
    leading axis); its batchmates are untouched. ``element`` pins the
    (row, col) node; by default a seeded RNG picks among the top-half
    magnitude interior entries — for the exponent class, among those a
    silent bit can blow up the most (the small ones). ``buffer`` is a
    state field (w/r/p/z) or ``"Ap"``, the stencil-application fault,
    which lands in ``r`` (see ``_BITFLIP_BUFFERS``)."""
    if buffer not in _BITFLIP_BUFFERS:
        raise ValueError(f"bitflip buffer must be one of "
                         f"{sorted(_BITFLIP_BUFFERS)}, got {buffer!r}")
    buffer = _BITFLIP_BUFFERS[buffer]
    original = getattr(state, buffer)
    arr = _host_copy(original)
    target = arr[member] if member is not None else arr
    if element is None:
        interior = np.abs(target[1:-1, 1:-1])
        finite = np.isfinite(interior) & (interior > 0)
        if not finite.any():
            raise ValueError(f"buffer {buffer!r} has no nonzero finite "
                             "interior entry to corrupt")
        cutoff = np.median(interior[finite])
        candidates = finite & (interior >= cutoff)
        if bit_class == "exponent":
            # Choose by the damage a single silent bit can reach: seeded
            # pick among the most-damaging cohort (≥ half the best
            # reachable post-flip delta).
            gain = _exponent_gain(target[1:-1, 1:-1])
            delta = np.where(finite, gain - interior, 0.0)
            best = float(delta.max())
            big = finite & (delta >= 0.5 * best)
            if best > 0 and big.any():
                candidates = big
        rows, cols = np.nonzero(candidates)
        pick = random.Random(seed).randrange(len(rows))
        element = (int(rows[pick]) + 1, int(cols[pick]) + 1)
    i, j = element
    target[i, j] = bitflip_element(target[i, j], bit_class=bit_class,
                                   bit=bit)
    return state._replace(**{buffer: _like(arr, original)})


def bitflip_hook(at_iteration: int, buffer: str = "w",
                 bit_class: str = "exponent", bit: Optional[int] = None,
                 seed: int = 0):
    """Chunk-boundary corruption, once per hook: flip one bit of
    ``buffer`` at the first boundary whose count reaches ``at_iteration``."""
    fired = {"done": False}

    def hook(state, chunks_done: int):
        if not fired["done"] and int(state.k) >= at_iteration:
            fired["done"] = True
            return inject_bitflip(state, buffer, bit_class=bit_class,
                                  bit=bit, seed=seed)
        return None

    return hook


def bitflip_per_solve_hook(at_iteration: int, buffer: str = "w",
                           bit_class: str = "exponent",
                           bit: Optional[int] = None, seed: int = 0):
    """Like :func:`bitflip_hook`, re-armed for every new solve run (a run
    is new when ``chunks_done`` restarts)."""
    state_ = {"armed": True, "last_chunks": 0}

    def hook(state, chunks_done: int):
        if chunks_done <= state_["last_chunks"]:
            state_["armed"] = True
        state_["last_chunks"] = chunks_done
        if state_["armed"] and int(state.k) >= at_iteration:
            state_["armed"] = False
            return inject_bitflip(state, buffer, bit_class=bit_class,
                                  bit=bit, seed=seed)
        return None

    return hook


def bitflip_lane(batch, lane: int, buffer: str = "w",
                 bit_class: str = "exponent", bit: Optional[int] = None,
                 seed: int = 0) -> None:
    """Flip one storage bit of one lane of a running
    :class:`~poisson_tpu_torch.solvers.lanes.LaneBatch` between steps; the
    other lanes' buffers are untouched."""
    batch.state = inject_bitflip(batch.state, buffer, member=lane,
                                 bit_class=bit_class, bit=bit, seed=seed)


def parse_bitflip_spec(spec: str):
    """The CLI's ``--fault-bitflip-at ITER[:buffer[:bit]]`` as
    ``(iteration, buffer, bit)`` (bit None: the exponent class)."""
    parts = str(spec).split(":")
    if len(parts) > 3:
        raise ValueError(
            f"bitflip spec is ITER[:buffer[:bit]], got {spec!r}")
    try:
        iteration = int(parts[0])
    except ValueError:
        raise ValueError(f"bitflip iteration must be an int, got "
                         f"{parts[0]!r}")
    buffer = parts[1] if len(parts) > 1 and parts[1] else "w"
    if buffer not in _BITFLIP_BUFFERS:
        raise ValueError(f"bitflip buffer must be one of "
                         f"{'/'.join(sorted(_BITFLIP_BUFFERS))}, got "
                         f"{buffer!r}")
    bit = None
    if len(parts) > 2 and parts[2]:
        try:
            bit = int(parts[2])
        except ValueError:
            raise ValueError(f"bitflip bit must be an int, got "
                             f"{parts[2]!r}")
    return iteration, buffer, bit


def corrupt_file(path: str, mode: str = "flip") -> None:
    """Damage a file the way storage does: 'flip' XORs the middle byte
    (bit rot only the CRC catches), 'truncate' cuts it to 60% (a torn
    write), 'zero' zeroes a 256-byte block (a bad sector)."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    with open(path, "r+b") as f:
        if mode == "flip":
            f.seek(size // 2)
            byte = f.read(1)
            f.seek(size // 2)
            f.write(bytes([byte[0] ^ 0xFF]))
        elif mode == "truncate":
            f.truncate(max(1, (size * 3) // 5))
        elif mode == "zero":
            f.seek(max(0, size // 2 - 128))
            f.write(b"\x00" * min(256, size))
        else:
            raise ValueError(
                f"mode must be flip/truncate/zero, got {mode!r}"
            )


def chunk_hook(plan: FaultPlan):
    """A :class:`FaultPlan` as the ``on_chunk(state, chunks_done)`` hook of
    ``run_chunked`` and the resilient driver; each fault fires at most once
    per hook."""
    fired = {"nan": False}

    def hook(state, chunks_done: int):
        if (plan.preempt_after_chunks is not None
                and chunks_done >= plan.preempt_after_chunks):
            raise PreemptionInjected(
                f"injected preemption after chunk {chunks_done}"
            )
        if (plan.nan_at_iteration is not None and not fired["nan"]
                and int(state.k) >= plan.nan_at_iteration):
            fired["nan"] = True
            return inject_nan(state, plan.nan_buffer)
        return None

    return hook


def nan_per_solve_hook(at_iteration: int, buffer: str = "r"):
    """Like ``chunk_hook``'s NaN, re-armed for every new solve run (a run
    is new when ``chunks_done`` restarts)."""
    state_ = {"armed": True, "last_chunks": 0}

    def hook(state, chunks_done: int):
        if chunks_done <= state_["last_chunks"]:
            state_["armed"] = True
        state_["last_chunks"] = chunks_done
        if state_["armed"] and int(state.k) >= at_iteration:
            state_["armed"] = False
            return inject_nan(state, buffer)
        return None

    return hook


# -- service-level faults (poisson_tpu_torch.serve dispatch seam) -------


def poison_batch_fault(poison_ids):
    """A *repeated-poison-request* injector for the solve service's
    ``dispatch_fault`` seam: any dispatch whose batch contains one of
    ``poison_ids`` dies whole with :class:`~poisson_tpu_torch.serve.types.\
TransientDispatchError` — the model of a member whose payload crashes the
    device program and takes its batchmates with it. The service's
    requeue isolation (mutual taint) must keep the poison from re-killing
    the same batchmates on retry."""
    poison = set(poison_ids)

    def fault(requests, attempts):
        hit = [r.request_id for r in requests if r.request_id in poison]
        if hit:
            from poisson_tpu_torch.serve.types import TransientDispatchError

            raise TransientDispatchError(
                f"injected device fault (poison member(s) {hit} in a "
                f"batch of {len(requests)})"
            )

    return fault


def slow_worker_fault(seconds: float, sleep):
    """A *slow-worker* injector: every dispatch stalls for ``seconds`` on
    the service's (virtual or real) clock before the solver runs —
    queued deadlines burn down behind it, which is exactly the overload
    pathology deadline-shedding exists for."""

    def fault(requests, attempts):
        sleep(seconds)

    return fault


def compose_faults(*faults):
    """Run several same-seam injectors in order (first raise wins).
    Arity-agnostic: composes ``dispatch_fault`` injectors
    ``(requests, attempts)`` and ``worker_fault`` injectors
    ``(worker_id, requests, attempts)`` alike — mixing seams in one
    composition is a caller bug the signatures surface loudly."""

    def fault(*args):
        for f in faults:
            f(*args)

    return fault


# -- fleet-level faults (poisson_tpu_torch.serve worker seam) ------------


def worker_kill_fault(worker_ids, kills_per_worker: int = 1):
    """A *worker-kill* injector for the service's ``worker_fault`` seam
    (called as ``(worker_id, requests, attempts)``): the named workers
    die with :class:`~poisson_tpu_torch.serve.fleet.WorkerCrashError` on their
    first ``kills_per_worker`` dispatches — the model of a preempted or
    OOM-killed execution engine. The supervisor must quarantine the
    worker, recover its in-flight requests onto the survivors with
    mutual taint, and restart it through warm-up."""
    targets = set(worker_ids)
    kills: dict = {}

    def fault(worker_id, requests, attempts):
        if worker_id in targets and kills.get(worker_id, 0) < kills_per_worker:
            kills[worker_id] = kills.get(worker_id, 0) + 1
            from poisson_tpu_torch.serve.fleet import WorkerCrashError

            raise WorkerCrashError(
                f"injected kill of worker {worker_id} "
                f"(kill {kills[worker_id]}/{kills_per_worker}, "
                f"{len(requests)} request(s) in flight)"
            )

    return fault


def worker_hang_fault(worker_ids, stall_seconds: float, advance,
                      hangs_per_worker: int = 1):
    """A *worker-hang* injector: the named workers wedge mid-dispatch
    for ``stall_seconds`` on the injected clock (``advance`` — a
    ``VirtualClock.advance`` in chaos scenarios) and then surface
    :class:`~poisson_tpu_torch.serve.fleet.WorkerHangError`. Sized past the
    fleet's heartbeat timeout, the stall verdict must land on the
    worker's watchdog (``watchdog.stalls``) before the supervisor
    quarantines and recovers."""
    targets = set(worker_ids)
    hangs: dict = {}

    def fault(worker_id, requests, attempts):
        if worker_id in targets and hangs.get(worker_id, 0) < hangs_per_worker:
            hangs[worker_id] = hangs.get(worker_id, 0) + 1
            advance(stall_seconds)
            from poisson_tpu_torch.serve.fleet import WorkerHangError

            raise WorkerHangError(
                f"worker {worker_id} wedged for {stall_seconds}s "
                f"mid-dispatch (hang {hangs[worker_id]})"
            )

    return fault


def device_loss_fault(device_ids, placement_of, losses_per_device: int = 1):
    """A *device-loss* injector for the service's ``worker_fault`` seam:
    the first ``losses_per_device`` dispatches (or chunk steps — the
    seam fires at both) of any worker bound to one of ``device_ids``
    raise :class:`~poisson_tpu_torch.serve.fleet.DeviceLossError` naming that
    device — the device-unavailable shape of a card dropping off
    the bus. The supervisor must mark the device lost
    (placement epoch bump), quarantine EVERY worker in the fault
    domain, recover their in-flight requests onto survivors with
    mutual taint, and rebind the quarantined workers at restart.

    ``placement_of`` maps a worker id to its bound device id (e.g.
    ``service.worker_device``) — the injector targets silicon, and only
    the placement registry knows who lives on it."""
    targets = {int(d) for d in device_ids}
    losses: dict = {}

    def fault(worker_id, requests, attempts):
        device = placement_of(worker_id)
        if device is None or int(device) not in targets:
            return
        if losses.get(int(device), 0) >= losses_per_device:
            return
        losses[int(device)] = losses.get(int(device), 0) + 1
        from poisson_tpu_torch.serve.fleet import DeviceLossError

        raise DeviceLossError(
            f"injected loss of device {device} under worker "
            f"{worker_id} ({len(requests)} request(s) in flight)",
            device_id=int(device),
        )

    return fault


def host_drop_fault(host_devices, placement_of):
    """A *host-drop* injector: every device of one host vanishes
    together (``host_devices`` — the host's fault-domain slots, e.g.
    a contiguous run of 4 chips). Each doomed device surfaces its own
    :class:`~poisson_tpu_torch.serve.fleet.DeviceLossError` as a worker bound
    to it next dispatches — the honest shape of a host dropping off
    the network: losses arrive as the survivors notice, not as one
    atomic event. The supervisor must drain the whole host's fault
    domains and re-plan onto the surviving hosts."""
    doomed = {int(d) for d in host_devices}
    reported: set = set()

    def fault(worker_id, requests, attempts):
        device = placement_of(worker_id)
        if device is None or int(device) not in doomed:
            return
        if int(device) in reported:
            return
        reported.add(int(device))
        from poisson_tpu_torch.serve.fleet import DeviceLossError

        raise DeviceLossError(
            f"injected host drop: device {device} gone "
            f"({len(reported)}/{len(doomed)} of the host's devices "
            "reported)",
            device_id=int(device),
        )

    return fault


def kill_device_at(at_seconds: float, clock, losses: int = 1):
    """Bench-churn injector (``bench.py --serve --devices D
    --kill-device-at T``): once ``clock()`` passes ``at_seconds``, the
    next ``losses`` dispatching workers lose their BOUND device —
    ``DeviceLossError`` with ``device_id=None``, which the supervisor
    resolves to the dispatching worker's fault domain. Device churn at
    a wall-clock point in an open-loop run, whichever fault domain
    happens to hold the dispatch."""
    state = {"losses": 0}

    def fault(worker_id, requests, attempts):
        if state["losses"] < losses and clock() >= at_seconds:
            state["losses"] += 1
            from poisson_tpu_torch.serve.fleet import DeviceLossError

            raise DeviceLossError(
                f"injected churn: worker {worker_id}'s device lost at "
                f"t={clock():.3f}s (loss {state['losses']}/{losses})"
            )

    # Bench reads this to tell a churned run from one that finished
    # before the loss was due (see kill_worker_at).
    fault.state = state
    return fault


def kill_worker_at(at_seconds: float, clock, kills: int = 1):
    """Bench-churn injector (``bench.py --serve --workers W
    --kill-worker-at T``): once ``clock()`` passes ``at_seconds``, the
    next ``kills`` dispatching workers die — worker churn at a
    wall-clock point in an open-loop run, whichever worker happens to
    hold the dispatch."""
    state = {"kills": 0}

    def fault(worker_id, requests, attempts):
        if state["kills"] < kills and clock() >= at_seconds:
            state["kills"] += 1
            from poisson_tpu_torch.serve.fleet import WorkerCrashError

            raise WorkerCrashError(
                f"injected churn: worker {worker_id} killed at "
                f"t={clock():.3f}s (kill {state['kills']}/{kills})"
            )

    # Callers (bench.py fleet mode) read this to tell a churned run
    # from one that finished before the kill was due — the record must
    # never label clean throughput as a churn experiment.
    fault.state = state
    return fault
