"""Telemetry: spans and counters (counterpart of the core of
``poisson_tpu/obs/__init__.py``).

- **spans** (:mod:`poisson_tpu_torch.obs.trace`) — nestable, fenced timed
  regions, written as Chrome/Perfetto trace JSON and a JSONL event log;
- **counters** (:mod:`poisson_tpu_torch.obs.metrics`) — an always-on
  registry, snapshotted to JSON at :func:`finalize` and merged per rank.

The file formats and the counter and event names are the JAX package's,
so either package reads the other's trace directory and snapshots.

Usage (the CLI wires this from ``--trace-dir``/``--metrics-out``)::

    from poisson_tpu_torch import obs
    obs.configure(trace_dir="tm", metrics_path="m.json")
    with obs.span("solve"):
        result = pcg_solve(problem)
    obs.finalize()

Unconfigured, ``obs.span`` is a null context (no fence), ``obs.event``
drops the record, and counters still count.

Not ported yet: streamed convergence (``obs/stream.py``, with the
resilience layer), and the profiler capture, Prometheus exposition and
HTTP endpoint, flight recorder, cost model, forecast and roofline layers
(ROADMAP Queue 1 item 11).
"""

from __future__ import annotations

import atexit
import contextlib
import os
from typing import Optional

from poisson_tpu_torch.obs import metrics, trace
from poisson_tpu_torch.obs.metrics import gauge, inc
from poisson_tpu_torch.obs.trace import (
    TraceRecorder,
    load_events,
    merge_trace_dir,
    normalize_event,
)

__all__ = ["TraceRecorder", "configure", "configure_from_env", "event",
           "finalize", "gauge", "inc", "load_events", "merge_trace_dir",
           "metrics", "normalize_event", "recent_events",
           "shutdown", "span", "trace"]

_RECORDER: Optional[TraceRecorder] = None
_METRICS_PATH: Optional[str] = None
_ATEXIT_REGISTERED = False


def configure(trace_dir: Optional[str] = None,
              metrics_path: Optional[str] = None,
              rank: Optional[int] = None) -> TraceRecorder:
    """Install the process-wide telemetry configuration.

    ``trace_dir``: spans and events land in ``trace-rank{R}.trace.json``
    and ``events-rank{R}.jsonl`` there, plus ``metrics-rank{R}.json`` at
    finalize. ``metrics_path``: one more counters snapshot file.
    Finalization runs at interpreter exit; call :func:`finalize` earlier
    for deterministic artifact timing."""
    global _RECORDER, _METRICS_PATH, _ATEXIT_REGISTERED
    shutdown()
    _RECORDER = TraceRecorder(trace_dir=trace_dir, rank=rank)
    _METRICS_PATH = metrics_path
    if not _ATEXIT_REGISTERED:
        atexit.register(finalize)
        _ATEXIT_REGISTERED = True
    return _RECORDER


def configure_from_env() -> Optional[TraceRecorder]:
    """Configure from ``POISSON_TPU_TRACE_DIR`` / ``POISSON_TPU_METRICS_OUT``
    (the JAX package's variables), for harnesses whose argv is spoken for.
    No-op (returns None) when neither is set."""
    trace_dir = os.environ.get("POISSON_TPU_TRACE_DIR") or None
    metrics_path = os.environ.get("POISSON_TPU_METRICS_OUT") or None
    if not (trace_dir or metrics_path):
        return None
    return configure(trace_dir=trace_dir, metrics_path=metrics_path)


def span(name: str, fence: bool = True, device=None, **args):
    """A span on the active recorder (fenced on ``device`` at exit, see
    ``trace.device_fence``), or a null context when telemetry is
    unconfigured."""
    if _RECORDER is not None:
        return _RECORDER.span(name, fence=fence, device=device, **args)
    return contextlib.nullcontext()


def event(name: str, **fields) -> None:
    """An instant event on the active recorder (dropped when off)."""
    if _RECORDER is not None:
        _RECORDER.event(name, **fields)


def recent_events() -> list:
    """The last events, newest last; [] when unconfigured."""
    if _RECORDER is not None:
        return _RECORDER.recent_events()
    return []


def finalize() -> None:
    """Flush every artifact: the Chrome trace and the metrics
    snapshot(s). Idempotent; safe with no configuration."""
    rec = _RECORDER
    if rec is not None:
        rec.flush()
        if rec.trace_dir:
            metrics.write_snapshot(
                os.path.join(rec.trace_dir, f"metrics-rank{rec.rank}.json"),
                rank=rec.rank)
    if _METRICS_PATH:
        metrics.write_snapshot(_METRICS_PATH,
                               rank=rec.rank if rec else None)


def shutdown() -> None:
    """Finalize and tear down the configuration (tests; back-to-back runs
    in one process)."""
    global _RECORDER, _METRICS_PATH
    if _RECORDER is not None or _METRICS_PATH:
        finalize()
    rec, _RECORDER = _RECORDER, None
    if rec is not None:
        rec.close()
    _METRICS_PATH = None
