"""Counters: the process-wide metrics registry (counterpart of
``poisson_tpu/obs/metrics.py``).

A flat registry of named counters (monotone adds) and gauges (last-set
values), always on: an increment is a dict add under a lock, so the call
sites never ask whether telemetry is configured. Snapshots are written as
JSON by :func:`poisson_tpu_torch.obs.finalize` (to ``--metrics-out`` and/or
``metrics-rank{R}.json`` in the trace directory); per-rank snapshots merge
with :func:`merge` (counters sum across ranks, gauges stay per rank).

The snapshot schema and the counter names are the JAX package's, so a
snapshot written by either package loads with the other's :func:`load_dir`.
The names the port emits:

- ``pcg.solves.<verdict>`` / ``pcg.iterations.<verdict>`` — solves and
  iterations by stop-flag name (``solvers.pcg.FLAG_NAMES``), counted by
  the CLI's report (``utils.timing.count_solve``);
- ``time.compile_seconds`` / ``time.execute_seconds`` — accumulating float
  counters: the first call's extra time (kernel build and load, canvas
  setup) and the timed solves;
- ``checkpoint.writes`` / ``checkpoint.corrupt`` /
  ``checkpoint.crc_failures`` / ``checkpoint.generation_fallbacks`` /
  ``checkpoint.deadline_stops`` — the checkpoint layer
  (``solvers.checkpoint``);
- ``resilient.restarts`` / ``resilient.escalations`` /
  ``resilient.deadline_stops`` and ``integrity.checks`` /
  ``integrity.detections`` / ``integrity.verified_restarts`` /
  ``integrity.false_alarms`` — the self-healing solve
  (``solvers.resilient``) and its integrity probe;
- ``watchdog.beats`` / ``watchdog.stalls`` — the chunk-boundary watchdog
  (``parallel.watchdog``);
- ``batched.solves`` / ``batched.padding_members`` /
  ``batched.bucket_cache.hits`` / ``batched.bucket_cache.misses`` and the
  gauges ``batched.last_bucket`` / ``batched.solves_per_sec`` — the
  multi-RHS driver (``solvers.batched``) and its CLI.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

SCHEMA = "poisson_tpu.obs.metrics/1"
MERGED_SCHEMA = "poisson_tpu.obs.metrics/merged-1"

_LOCK = threading.Lock()
_COUNTERS: dict[str, float] = {}
_GAUGES: dict[str, object] = {}


def inc(name: str, value: float = 1) -> None:
    """Add ``value`` to counter ``name`` (creating it at 0)."""
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + value


def gauge(name: str, value) -> None:
    """Set gauge ``name`` to ``value`` (last write wins)."""
    with _LOCK:
        _GAUGES[name] = value


def get(name: str, default: float = 0) -> float:
    """Current value of counter ``name`` (``default`` when never
    incremented)."""
    with _LOCK:
        return _COUNTERS.get(name, default)


def reset() -> None:
    """Clear the registry (tests; several runs in one process)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()


def snapshot(rank: Optional[int] = None) -> dict:
    """The registry as one JSON-ready dict, stamped with the rank and both
    clocks (wall for cross-host alignment, monotonic for stall math)."""
    if rank is None:
        from poisson_tpu_torch.obs.trace import default_rank

        rank = default_rank()
    with _LOCK:
        return {
            "schema": SCHEMA,
            "rank": rank,
            "pid": os.getpid(),
            "at_unix": time.time(),
            "at_mono": time.monotonic(),
            "counters": dict(_COUNTERS),
            "gauges": dict(_GAUGES),
        }


def write_snapshot(path: str, rank: Optional[int] = None) -> None:
    """Atomically write :func:`snapshot` to ``path``. Best effort: a
    failing metrics disk never takes the solve down with it."""
    snap = snapshot(rank)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(snap, f, sort_keys=True, indent=1, default=str)
        os.replace(tmp, path)
    except OSError:
        try:
            if os.path.exists(tmp):
                os.remove(tmp)
        except OSError:
            pass


def merge(snapshots: list[dict]) -> dict:
    """Merge per-rank snapshots: counters sum; gauges are kept per rank
    under ``gauges_by_rank`` (an aggregate would hide a straggler)."""
    counters: dict[str, float] = {}
    gauges_by_rank: dict[str, dict] = {}
    ranks = []
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        rank = snap.get("rank", "?")
        ranks.append(rank)
        for name, val in (snap.get("counters") or {}).items():
            try:
                counters[name] = counters.get(name, 0) + val
            except TypeError:
                continue
        g = snap.get("gauges") or {}
        if g:
            gauges_by_rank[str(rank)] = dict(g)
    return {
        "schema": MERGED_SCHEMA,
        "ranks": ranks,
        "counters": counters,
        "gauges_by_rank": gauges_by_rank,
    }


def load_dir(trace_dir: str) -> dict:
    """Every ``metrics-rank*.json`` under ``trace_dir``, merged
    (:func:`merge`; no counters when there are none)."""
    snaps = []
    for fname in sorted(os.listdir(trace_dir)):
        if not (fname.startswith("metrics-rank")
                and fname.endswith(".json")):
            continue
        try:
            with open(os.path.join(trace_dir, fname)) as f:
                snaps.append(json.load(f))
        except (OSError, ValueError):
            continue
    return merge(snaps)
