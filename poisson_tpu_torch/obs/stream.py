"""Streamed convergence: per-iteration (k, ‖Δw‖) samples out of a running
solve (counterpart of ``poisson_tpu/obs/stream.py``).

The JAX loop is one device program, so its samples leave through an
unordered ``jax.debug.callback``. The port's loop is eager, and its only
host sync is the read of ``done`` that ``solvers.pcg.drive`` makes once
per ``check_every`` steps. So a streaming body stages its samples instead:

- ``make_pcg_body(..., stream_every=K)`` keeps, per step, references to
  the step's old and new count and its ‖Δw‖ (tensors the step computes
  anyway: no launch is added) in a :class:`StreamTap`;
- at each check ``drive`` calls :meth:`StreamTap.flush`, which copies the
  staged values to the host in one transfer per field and emits every
  sample whose count advanced to a multiple of K — a frozen step (a done
  state the loop runs on to the end of its block) keeps its count and
  emits nothing;
- the host side (:func:`device_tap`, :class:`StreamSink`) is the JAX
  package's: an in-memory curve, an appended ``stream-rank{R}.jsonl`` in
  its format, and an opt-in live progress line on stderr.

Samples come out in order, and ``drive``'s last check flushes the last of
them, so there is nothing left to drain when a loop returns (the JAX
package's ``drain`` waits for callbacks in flight). Off by default: with
``stream_every=0`` the body records nothing and has no tap, so the loop is
the plain one.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Optional

import torch

_LOCK = threading.Lock()
_SINK: Optional["StreamSink"] = None


class StreamSink:
    """Host-side receiver for streamed (k, ‖Δw‖) samples.

    ``path``: append samples as JSONL (None: memory only). ``live``:
    overwrite a one-line progress display on stderr per sample.
    ``min_interval``: floor (seconds) between live repaints; recording is
    never throttled.
    """

    def __init__(self, path: Optional[str] = None, live: bool = False,
                 min_interval: float = 0.1, label: str = "solve"):
        self.path = path
        self.live = live
        self.min_interval = min_interval
        self.label = label
        self.samples: list[tuple[int, float]] = []
        self._file = None
        self._last_paint = 0.0
        self._lock = threading.Lock()

    def emit(self, k: int, diff: float) -> None:
        now = time.monotonic()
        with self._lock:
            self.samples.append((k, diff))
            if self.path is not None:
                try:
                    if self._file is None:
                        d = os.path.dirname(os.path.abspath(self.path))
                        os.makedirs(d, exist_ok=True)
                        self._file = open(self.path, "a")
                    self._file.write(json.dumps(
                        {"k": k, "diff": diff, "at_unix": time.time(),
                         "at_mono": now}) + "\n")
                    self._file.flush()
                except (OSError, ValueError):
                    pass
            paint = self.live and (now - self._last_paint
                                   >= self.min_interval)
            if paint:
                self._last_paint = now
        if paint:
            print(f"\r{self.label}: iter {k}  ||dw|| {diff:.3e}   ",
                  end="", file=sys.stderr, flush=True)

    def finish(self) -> None:
        with self._lock:
            if self._file is not None:
                try:
                    self._file.close()
                except OSError:
                    pass
                self._file = None
        if self.live and self.samples:
            print(file=sys.stderr)      # leave the last progress line


def set_sink(sink: Optional[StreamSink]) -> Optional[StreamSink]:
    """Install the process-wide sink; returns the previous one."""
    global _SINK
    with _LOCK:
        prev, _SINK = _SINK, sink
    return prev


def get_sink() -> Optional[StreamSink]:
    return _SINK


def device_tap(k, diff) -> None:
    """Forward one sample to the active sink; with no sink it is dropped.
    A failing sink never takes the solve down."""
    sink = _SINK
    if sink is not None:
        try:
            sink.emit(int(k), float(diff))
        except Exception:
            pass


def emit_every(stream_every: int, k, diff) -> None:
    """Emit (k, ‖Δw‖) when ``k`` is a multiple of ``stream_every`` (> 0)."""
    if int(k) % stream_every == 0:
        device_tap(k, diff)


class StreamTap:
    """One streaming body's staged samples (see the module docstring),
    handed to ``emit(stream_every, k, diff)``: :func:`emit_every` by
    default, ``obs.forecast.emit_history`` for the forecast's history."""

    def __init__(self, stream_every: int, emit=None):
        if stream_every < 1:
            raise ValueError(f"stream_every must be >= 1, got "
                             f"{stream_every}")
        self.stream_every = int(stream_every)
        self._emit = emit_every if emit is None else emit
        self._staged: list[tuple] = []

    def record(self, k_before, k_after, diff) -> None:
        """Stage one step: its count before and after, and its ‖Δw‖."""
        self._staged.append((k_before, k_after, diff))

    def flush(self) -> None:
        """Emit the staged samples whose count advanced to a multiple of
        ``stream_every``, in order, and clear the stage."""
        staged, self._staged = self._staged, []
        if not staged:
            return
        before, after, diffs = (torch.stack(col).cpu().tolist()
                                for col in zip(*staged))
        for kb, ka, diff in zip(before, after, diffs):
            if ka != kb:
                self._emit(self.stream_every, ka, diff)

