"""Multi-process launch: the port's counterpart of the reference's MPI world
(``poisson_tpu/parallel/multihost.py``).

The reference scales across nodes with ``mpirun`` (SURVEY §2.4); the JAX
package forms its world with ``jax.distributed``. The port forms it with
``torch.distributed``: every process runs the same program, calls
:func:`initialize_multihost` first, then builds its mesh with
``make_solver_mesh`` (which all-gathers every rank's devices, so every rank
sees the same global mesh, its shards ordered by rank and then by local
index, as ``jax.devices()`` orders by process). Each rank then drives only
the shards it owns: halo slices bound for another rank travel by
point-to-point transfer and the mesh-wide sums all-gather the per-shard sums
(``parallel.halo``).

Usage (one copy of the program per process)::

    from poisson_tpu_torch.parallel.multihost import initialize_multihost
    initialize_multihost(coordinator="10.0.0.1:1234", num_processes=2,
                         process_id=rank)        # or env-driven: no args
    mesh = make_solver_mesh(["cuda:0", "cuda:0"])   # this rank's shards
    result = fused_cg_solve_sharded_checkpointed(problem, mesh, "ck.npz")

The transport follows the backend: NCCL when every process on the host can
have a card of its own (``LOCAL_WORLD_SIZE``, else the world size, is at
most the visible cards), gloo otherwise. Gloo moves host tensors only, so
a CUDA halo slice or sum goes through host memory, explicitly; two ranks
sharing one card run under gloo.
"""

from __future__ import annotations

import os
import random
import time
import warnings
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

# Each rendezvous attempt and each collective waits at most this long: a
# dead coordinator surfaces as a transient error the retry loop can act on,
# and a dead peer fails its partners instead of hanging them.
RENDEZVOUS_TIMEOUT = timedelta(seconds=60)

# Coordinator-connection failures that are worth retrying: the coordinator
# races every other process's startup, so early connection refusals and
# timeouts are expected during a launch and are not configuration errors.
_TRANSIENT_MARKERS = (
    "connect", "connection", "timeout", "timed out", "deadline",
    "unavailable", "refused", "temporar", "reset", "barrier",
)


def _is_transient(message: str) -> bool:
    msg = message.lower()
    if "already" in msg or "once" in msg:
        return False            # group formed elsewhere: not a failure
    if "backend" in msg or "before" in msg:
        return False            # ordering mistake: retrying cannot fix it
    return any(marker in msg for marker in _TRANSIENT_MARKERS)


def world_size() -> int:
    """Processes in the group, 1 when none formed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_rank() -> int:
    """This process's rank, 0 when no group formed."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _backend(world: int) -> str:
    """NCCL when every process of this host can have a card of its own,
    gloo otherwise (two ranks on one card: NCCL refuses them)."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available() and torch.cuda.device_count() >= local:
        return "nccl"
    return "gloo"


def _form_group(coordinator: Optional[str], num_processes: Optional[int],
                process_id: Optional[int]) -> None:
    if coordinator is None:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        dist.init_process_group(backend=_backend(world), init_method="env://",
                                timeout=RENDEZVOUS_TIMEOUT)
    else:
        dist.init_process_group(
            backend=_backend(num_processes or 1),
            init_method=f"tcp://{coordinator}", world_size=num_processes,
            rank=process_id, timeout=RENDEZVOUS_TIMEOUT)
    if dist.is_initialized() and dist.get_backend() == "nccl":
        count = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", dist.get_rank() % count)))


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         max_retries: int = 3,
                         backoff_seconds: float = 1.0,
                         jitter: float = 0.5,
                         seed: Optional[int] = None,
                         sleep=time.sleep) -> int:
    """Join (or form) the process group; returns this process's rank.

    With no arguments, relies on the environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, as launchers set them); with
    ``coordinator`` ("host:port"), forms a TCP rendezvous of
    ``num_processes`` processes there, this one being ``process_id``. Call
    it before ``make_solver_mesh``: a mesh built before the group formed
    holds every shard in this process, and a solver handed one while the
    group has more processes raises rather than let each process solve
    alone. Calling again after a successful init, or after a group formed
    elsewhere, or with no cluster in the environment, is a harmless no-op
    (the last returns rank 0).

    Transient failures (coordinator not yet listening, connection timeout)
    are retried ``max_retries`` times with exponential backoff starting at
    ``backoff_seconds``, jittered over ``[1 − jitter, 1]`` by a seeded RNG
    (``seed``; default: ``process_id``, else the pid), so a fleet retrying
    a dead coordinator does not return in lockstep; the JAX package's
    schedule, delay for delay. When the retries are spent, an explicit
    cluster (``coordinator`` given) raises, and an env-driven init degrades
    to a single-process run with a warning. Ordering and configuration
    errors are never retried.
    """
    global _initialized
    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return process_rank()   # a second call, or a group formed elsewhere
    if seed is None:
        seed = process_id if process_id is not None else os.getpid()
    rng = random.Random(seed)
    attempt = 0
    while True:
        try:
            _form_group(coordinator, num_processes, process_id)
        except RuntimeError as e:
            msg = str(e).lower()
            if "already" in msg or "once" in msg:
                pass  # group formed elsewhere: keep it
            elif "backend" in msg or "before" in msg:
                raise RuntimeError(
                    "initialize_multihost() cannot form the process group "
                    f"({e}); an ordering mistake is not retried: call it "
                    "first, before make_solver_mesh() and any collective."
                ) from e
            elif _is_transient(msg) and attempt < max_retries:
                attempt += 1
                # Seeded jitter over [1 − jitter, 1]: never above the
                # exponential envelope, never in lockstep.
                delay = (backoff_seconds * (2.0 ** (attempt - 1))
                         * (1.0 - jitter * rng.random()))
                from poisson_tpu_torch import obs

                obs.inc("multihost.init_retries")
                obs.event("multihost.init_retry", attempt=attempt,
                          max_retries=max_retries, delay_seconds=delay,
                          error=str(e)[:200])
                warnings.warn(
                    f"distributed init failed transiently ({e}); retry "
                    f"{attempt}/{max_retries} in {delay:.1f}s",
                    RuntimeWarning, stacklevel=2)
                sleep(delay)
                continue
            elif coordinator is None and _is_transient(msg):
                # An env-driven cluster that never came up: degrade rather
                # than wedge every process on a dead coordinator.
                from poisson_tpu_torch import obs

                obs.inc("multihost.degraded")
                obs.event("multihost.degraded", retries=max_retries,
                          error=str(e)[:200])
                warnings.warn(
                    f"distributed init still failing after {max_retries} "
                    f"retries ({e}); continuing single-host: this process "
                    "will only see its local devices",
                    RuntimeWarning, stacklevel=2)
            elif coordinator is None and (
                    "coordinator" in msg or "environment" in msg
                    or "detect" in msg):
                pass  # no cluster configured: single-process run
            else:
                raise
        except ValueError:
            if coordinator is not None:
                raise  # explicit-cluster arguments were wrong: surface it
            # No cluster in the environment (no RANK, MASTER_ADDR, ...):
            # a single-process run.
        break
    _initialized = True
    return process_rank()


_initialized = False


def is_primary() -> bool:
    """True on the process that prints and persists results (the
    reference's rank-0 idiom, ``stage2:…cpp:493-498``)."""
    return process_rank() == 0
