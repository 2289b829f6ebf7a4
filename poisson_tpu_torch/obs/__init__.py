"""Telemetry: spans and counters (counterpart of the core of
``poisson_tpu/obs/__init__.py``).

- **spans** (:mod:`poisson_tpu_torch.obs.trace`) — nestable, fenced timed
  regions, written as Chrome/Perfetto trace JSON and a JSONL event log;
- **counters** (:mod:`poisson_tpu_torch.obs.metrics`) — an always-on
  registry, snapshotted to JSON at :func:`finalize` and merged per rank;
- **streamed convergence** (:mod:`poisson_tpu_torch.obs.stream`) — opt-in
  (k, ‖Δw‖) samples out of a running solve, staged on the device and
  emitted at the loop's checks (off by default; counts stay bit for bit);
- **performance attribution** (:mod:`poisson_tpu_torch.obs.costs`,
  :mod:`poisson_tpu_torch.obs.roofline`) — the analytic stencil model, the
  bytes each backend's kernels move, the counted plain iteration, and
  achieved-vs-roofline fractions on bench records and solve reports;
- **profiler capture** (:mod:`poisson_tpu_torch.obs.profile`) — fenced
  ``torch.profiler`` regions (``profile_dir``, ``POISSON_TPU_PROFILE_DIR``),
  and the port's own unfenced hot-path ranges (``profile.region``: each
  ``drive`` block's enqueue and check, the RHS staging in and out), which
  exist only while a profiler runs and are never recorder events;
- **Prometheus exposition** (:mod:`poisson_tpu_torch.obs.export`) — a
  textfile at finalize (``prom_path``, ``POISSON_TPU_PROM_OUT``) and a live
  ``/metrics`` endpoint (``metrics_port``, ``POISSON_TPU_METRICS_PORT``);
- **forecasts** (:mod:`poisson_tpu_torch.obs.forecast`) — the
  residual-history seam (``history_every``), iteration and ETA estimates,
  and the ``top`` scoreboard.

The file formats and the counter and event names are the JAX package's,
so either package reads the other's trace directory and snapshots.

Usage (the CLI wires this from ``--trace-dir``/``--metrics-out``/
``--stream-every``)::

    from poisson_tpu_torch import obs
    obs.configure(trace_dir="tm", metrics_path="m.json", stream_every=50)
    with obs.span("solve"):
        result = pcg_solve(problem, stream_every=50)
    obs.finalize()

Unconfigured, ``obs.span`` is a null context (no fence), ``obs.event``
drops the record, and counters still count. A plain solve leaves the
recorder unconfigured: its spans are request-level (``serve.dispatch``,
``checkpoint.write``, ``bench.*``), and while a profiler runs each also
enters a profiler range of its own name, so it sits in the device trace
beside the kernels and the hot path's ranges.

The solve service's per-request flight recorder and SLO tracker
(:mod:`poisson_tpu_torch.obs.flight`) ride the same JSONL rails.
"""

from __future__ import annotations

import atexit
import contextlib
import os
import sys
from typing import Optional

from poisson_tpu_torch.obs import metrics, profile, stream, trace
from poisson_tpu_torch.obs.metrics import gauge, inc
from poisson_tpu_torch.obs.trace import (
    TraceRecorder,
    load_events,
    merge_trace_dir,
    normalize_event,
)

__all__ = ["TraceRecorder", "configure", "configure_from_env", "event",
           "finalize", "gauge", "inc", "load_events", "merge_trace_dir",
           "metrics", "normalize_event", "profile", "recent_events",
           "recorder", "shutdown", "span", "stream", "stream_every",
           "trace"]

_RECORDER: Optional[TraceRecorder] = None
_METRICS_PATH: Optional[str] = None
_STREAM_EVERY: int = 0
_PROM_PATH: Optional[str] = None
_HTTP_SERVER = None
_ATEXIT_REGISTERED = False


def configure(trace_dir: Optional[str] = None,
              metrics_path: Optional[str] = None,
              rank: Optional[int] = None,
              stream_every: int = 0,
              stream_live: bool = False,
              profile_dir: Optional[str] = None,
              prom_path: Optional[str] = None,
              metrics_port: Optional[int] = None) -> TraceRecorder:
    """Install the process-wide telemetry configuration.

    ``trace_dir``: spans and events land in ``trace-rank{R}.trace.json``
    and ``events-rank{R}.jsonl`` there, plus ``metrics-rank{R}.json`` at
    finalize. ``metrics_path``: one more counters snapshot file.
    ``stream_every`` > 0 installs a :class:`~poisson_tpu_torch.obs.stream.
    StreamSink` (writing ``stream-rank{R}.jsonl`` in ``trace_dir``, and a
    live progress line on stderr with ``stream_live``); the stride must
    also be passed to the solver, as in the JAX package. ``profile_dir``
    enables :func:`poisson_tpu_torch.obs.profile.capture` regions.
    ``prom_path``: a Prometheus textfile written at finalize.
    ``metrics_port``: a live ``GET /metrics`` endpoint on 127.0.0.1:port
    for the configuration's lifetime (0: the OS picks; the bound port is
    the ``export.http_port`` gauge). Finalization runs at interpreter
    exit; call :func:`finalize` earlier for deterministic artifact
    timing."""
    global _RECORDER, _METRICS_PATH, _STREAM_EVERY, _ATEXIT_REGISTERED
    global _PROM_PATH, _HTTP_SERVER
    shutdown()
    _RECORDER = TraceRecorder(trace_dir=trace_dir, rank=rank)
    _METRICS_PATH = metrics_path
    _STREAM_EVERY = max(0, int(stream_every))
    _PROM_PATH = prom_path
    profile.configure(profile_dir)
    if metrics_port is not None:
        from poisson_tpu_torch.obs import export

        try:
            _HTTP_SERVER = export.start_http_server(metrics_port)
        except (OSError, OverflowError) as e:
            # A taken or out-of-range port: say so, and solve without it.
            print(f"obs: /metrics endpoint unavailable on port "
                  f"{metrics_port}: {e}", file=sys.stderr)
            _HTTP_SERVER = None
    if _STREAM_EVERY > 0:
        path = (os.path.join(trace_dir, f"stream-rank{_RECORDER.rank}.jsonl")
                if trace_dir else None)
        stream.set_sink(stream.StreamSink(path=path, live=stream_live))
    if not _ATEXIT_REGISTERED:
        atexit.register(finalize)
        _ATEXIT_REGISTERED = True
    return _RECORDER


def configure_from_env() -> Optional[TraceRecorder]:
    """Configure from ``POISSON_TPU_TRACE_DIR`` / ``POISSON_TPU_METRICS_OUT``
    / ``POISSON_TPU_STREAM_EVERY`` / ``POISSON_TPU_PROFILE_DIR`` /
    ``POISSON_TPU_PROM_OUT`` / ``POISSON_TPU_METRICS_PORT`` (the JAX
    package's variables), for harnesses whose argv is spoken for. No-op
    (returns None) when none is set."""
    trace_dir = os.environ.get("POISSON_TPU_TRACE_DIR") or None
    metrics_path = os.environ.get("POISSON_TPU_METRICS_OUT") or None
    profile_dir = os.environ.get("POISSON_TPU_PROFILE_DIR") or None
    prom_path = os.environ.get("POISSON_TPU_PROM_OUT") or None
    try:
        every = int(os.environ.get("POISSON_TPU_STREAM_EVERY", "0"))
    except ValueError:
        every = 0
    try:
        raw_port = os.environ.get("POISSON_TPU_METRICS_PORT")
        metrics_port = int(raw_port) if raw_port else None
    except ValueError:
        metrics_port = None
    if not (trace_dir or metrics_path or every > 0 or profile_dir
            or prom_path or metrics_port is not None):
        return None
    return configure(trace_dir=trace_dir, metrics_path=metrics_path,
                     stream_every=every, profile_dir=profile_dir,
                     prom_path=prom_path, metrics_port=metrics_port)


def recorder() -> Optional[TraceRecorder]:
    """The active recorder, or None when telemetry is unconfigured."""
    return _RECORDER


def stream_every() -> int:
    """The configured streaming stride (0 = off), for the solver calls."""
    return _STREAM_EVERY


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
    """Flush every artifact: the Chrome trace, the metrics snapshot(s) and
    the stream sink. Idempotent; safe with no configuration."""
    sink = stream.get_sink()
    if sink is not None:
        sink.finish()
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
    if _PROM_PATH:
        from poisson_tpu_torch.obs import export

        export.write_textfile(_PROM_PATH)


def shutdown() -> None:
    """Finalize and tear down the configuration (tests; back-to-back runs
    in one process)."""
    global _RECORDER, _METRICS_PATH, _STREAM_EVERY, _PROM_PATH, _HTTP_SERVER
    if (_RECORDER is not None or _METRICS_PATH or _PROM_PATH
            or stream.get_sink()):
        finalize()
    rec, _RECORDER = _RECORDER, None
    if rec is not None:
        rec.close()
    stream.set_sink(None)
    if _HTTP_SERVER is not None:
        from poisson_tpu_torch.obs import export

        export.stop_http_server(_HTTP_SERVER)
        _HTTP_SERVER = None
    profile.configure(None)
    _METRICS_PATH = None
    _STREAM_EVERY = 0
    _PROM_PATH = None
