"""Heartbeat watchdog for long chunked solves (counterpart of
``poisson_tpu/parallel/watchdog.py``).

The chunked drivers (``solvers.checkpoint.run_chunked``, the resilient
driver) call :meth:`Watchdog.beat` at every chunk boundary. The watchdog

- writes a small JSON heartbeat (atomic tmp + rename) on every beat, with
  wall (``at_unix``) and monotonic (``at_mono``) timestamps and the JAX
  package's keys, so a supervisor can tell a slow solve from a dead one;
- mirrors every beat and stall into ``obs`` (the ``watchdog.beats`` and
  ``watchdog.stalls`` counters and their events); and
- optionally arms a monitor thread: if no beat lands within ``timeout``
  seconds (monotonic), it writes a diagnostics file beside the heartbeat
  (last progress, elapsed times, the last telemetry events) and calls
  ``on_timeout`` — by default a log line and an interrupt of the main
  thread, which the drivers turn into :class:`SolveTimeout`.

The monitor thread is a daemon and holds no device state. The first beat
lands after the first chunk, which includes the first call's setup: size
``timeout`` generously.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from typing import Callable, Optional

import _thread


class SolveTimeout(RuntimeError):
    """A watchdog timeout fired: no heartbeat within the configured
    window. Carries the diagnostics dict as ``.diagnostics``."""

    def __init__(self, message: str, diagnostics: Optional[dict] = None):
        super().__init__(message)
        self.diagnostics = diagnostics or {}


def _default_on_timeout(diagnostics: dict) -> None:
    print(
        "poisson_tpu_torch watchdog: no heartbeat for "
        f"{diagnostics.get('elapsed_seconds', '?')}s — aborting the solve. "
        f"Diagnostics: {json.dumps(diagnostics, sort_keys=True)}",
        file=sys.stderr, flush=True,
    )
    # Interrupts the main thread at its next opportunity; the chunked
    # drivers convert that interrupt into SolveTimeout (see
    # ``raise_if_fired``) so callers catch a typed abort, not a bare
    # KeyboardInterrupt. A hard-wedged C call may never reach that
    # opportunity; the diagnostics file is already on disk either way,
    # which is what the post-mortem needs.
    _thread.interrupt_main()


class Watchdog:
    """Chunk-boundary heartbeat with optional stall timeout.

    ``heartbeat_path``: JSON heartbeat file, written atomically on every
    beat (None: keep heartbeats in memory only). ``timeout``: seconds
    without a beat before the monitor declares the solve wedged (None: no
    monitor — heartbeat file only). ``on_timeout``: called once with the
    diagnostics dict when the timeout fires (default: log + interrupt the
    main thread). Re-entrant: ``start``/``stop`` nest safely, and the
    object is a context manager.
    """

    def __init__(self, heartbeat_path: Optional[str] = None,
                 timeout: Optional[float] = None,
                 on_timeout: Optional[Callable[[dict], None]] = None,
                 poll_interval: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        if timeout is not None and timeout <= 0:
            raise ValueError(f"timeout must be positive, got {timeout}")
        self.heartbeat_path = heartbeat_path
        self.timeout = timeout
        self.on_timeout = on_timeout or _default_on_timeout
        self.poll_interval = poll_interval or (
            min(timeout / 4, 1.0) if timeout else 1.0
        )
        self._clock = clock
        self._lock = threading.Lock()
        self._last_beat = None
        self._last_beat_wall = None
        self._last_info: dict = {}
        self._beats = 0
        self._fired = False
        self.fired_diagnostics: Optional[dict] = None
        self._stop_event = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._depth = 0

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "Watchdog":
        with self._lock:
            self._depth += 1
            if self._depth > 1:
                return self
            self._fired = False
            self._last_beat = self._clock()
            self._last_beat_wall = time.time()
            self._stop_event.clear()
            if self.timeout is not None:
                self._thread = threading.Thread(
                    target=self._monitor, name="poisson-tpu-torch-watchdog",
                    daemon=True,
                )
                self._thread.start()
        self._write_heartbeat()
        return self

    def stop(self) -> None:
        with self._lock:
            if self._depth == 0:
                return
            self._depth -= 1
            if self._depth > 0:
                return
            self._stop_event.set()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5.0)

    def __enter__(self) -> "Watchdog":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- heartbeat -----------------------------------------------------

    def beat(self, **info) -> None:
        """Record liveness (called at every chunk boundary). ``info`` is
        free-form progress metadata (iteration, residual, …) included in
        the heartbeat file and in any timeout diagnostics. Each beat is
        also a telemetry event (``watchdog.beat`` counter + event with
        wall AND monotonic timestamps), so the unified event log carries
        the same liveness record the heartbeat file does."""
        from poisson_tpu_torch import obs

        with self._lock:
            self._last_beat = self._clock()
            self._last_beat_wall = time.time()
            self._last_info = dict(info)
            self._beats += 1
            beats = self._beats
        self._write_heartbeat()
        obs.inc("watchdog.beats")
        obs.event("watchdog.beat", beats=beats, **info)

    def elapsed_since_beat(self) -> float:
        with self._lock:
            if self._last_beat is None:
                return 0.0
            return self._clock() - self._last_beat

    @property
    def fired(self) -> bool:
        return self._fired

    def check(self) -> Optional[dict]:
        """Synchronous stall check for cooperative supervisors with
        injected clocks (the JAX package's ``serve.fleet``; the solve
        service is not ported): no monitor thread is armed —
        the supervisor itself asks "has this worker beaten within the
        timeout?" after every step. Fires at most once per watchdog
        instance (like the monitor), writing the same diagnostics file
        and counting the same ``watchdog.stalls``; returns the
        diagnostics dict when the stall verdict lands, None otherwise.
        A virtual clock advanced past the timeout mid-step is detected
        exactly like a wall-clock hang — which is what makes the fleet's
        hang drills deterministic."""
        from poisson_tpu_torch import obs

        with self._lock:
            if (self.timeout is None or self._last_beat is None
                    or self._fired):
                return None
            elapsed = self._clock() - self._last_beat
            if elapsed <= self.timeout:
                return None
            self._fired = True
            diag = self._diagnostics(elapsed)
            self.fired_diagnostics = diag
        obs.inc("watchdog.stalls")
        obs.event("watchdog.stall",
                  elapsed_seconds=diag["elapsed_seconds"],
                  timeout_seconds=self.timeout,
                  beats=diag["beats"])
        self._write_diagnostics(diag)
        return diag

    def raise_if_fired(self) -> None:
        """Convert a watchdog-induced main-thread interrupt into the typed
        abort: the chunked drivers call this from their KeyboardInterrupt
        handlers, so a timeout surfaces as SolveTimeout (with diagnostics
        attached) while a genuine Ctrl-C stays a KeyboardInterrupt."""
        if self._fired:
            diag = self.fired_diagnostics or {}
            raise SolveTimeout(
                f"watchdog timeout: no heartbeat within "
                f"{self.timeout}s (last progress: "
                f"{diag.get('last_progress', {})})",
                diagnostics=diag,
            )

    def _write_heartbeat(self) -> None:
        if not self.heartbeat_path:
            return
        # Both clocks: wall for humans/cross-host alignment, monotonic so
        # stall arithmetic survives a host clock jump (NTP step, VM
        # migration) — a jump can neither fake nor mask a stall.
        payload = {
            "at_unix": time.time(),
            "at_mono": time.monotonic(),
            "pid": os.getpid(),
            "beats": self._beats,
            **self._last_info,
        }
        tmp = f"{self.heartbeat_path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, self.heartbeat_path)
        except OSError:
            # A failing heartbeat disk must not take the solve down with it.
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass

    # -- monitor -------------------------------------------------------

    def _diagnostics(self, elapsed: float) -> dict:
        from poisson_tpu_torch import obs

        # elapsed_seconds is MONOTONIC (the default clock): the stall
        # verdict itself cannot be faked or masked by a host clock jump.
        # The wall-clock view is recorded alongside — a large disagreement
        # between the two is itself diagnostic (the clock jumped).
        wall_elapsed = (
            time.time() - self._last_beat_wall
            if self._last_beat_wall is not None else None
        )
        return {
            "elapsed_seconds": round(elapsed, 3),
            "elapsed_wall_seconds": (
                round(wall_elapsed, 3) if wall_elapsed is not None else None
            ),
            "at_unix": time.time(),
            "at_mono": time.monotonic(),
            "timeout_seconds": self.timeout,
            "beats": self._beats,
            "pid": os.getpid(),
            "last_progress": dict(self._last_info),
            # The last N unified-telemetry events (spans, checkpoint
            # writes, restarts, …): what the solve was actually doing
            # when it stopped beating.
            "recent_events": obs.recent_events(),
        }

    def _monitor(self) -> None:
        from poisson_tpu_torch import obs

        while not self._stop_event.wait(self.poll_interval):
            with self._lock:
                elapsed = self._clock() - self._last_beat
                expired = elapsed > self.timeout and not self._fired
                if expired:
                    self._fired = True
                    diag = self._diagnostics(elapsed)
                    self.fired_diagnostics = diag
            if expired:
                obs.inc("watchdog.stalls")
                obs.event("watchdog.stall",
                          elapsed_seconds=diag["elapsed_seconds"],
                          timeout_seconds=self.timeout,
                          beats=diag["beats"])
                self._write_diagnostics(diag)
                self.on_timeout(diag)
                return

    def _write_diagnostics(self, diag: dict) -> None:
        if not self.heartbeat_path:
            return
        path = f"{self.heartbeat_path}.stalled.json"
        try:
            with open(path, "w") as f:
                json.dump(diag, f, sort_keys=True, indent=2)
        except OSError:
            pass
