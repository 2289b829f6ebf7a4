"""Per-request deadlines, propagated into chunked solves (counterpart of
``poisson_tpu/serve/deadline.py``).

A deadline is the request-level contract a serving story needs:
"answer within N seconds, or say you could not" — never "hang until the
batch happens to finish". The chunked solve drivers
(``solvers.checkpoint.run_chunked``, ``solvers.resilient``) accept any
object with ``expired() -> bool`` / ``remaining() -> float|None`` and
check it at every chunk boundary; :class:`Deadline` is the canonical
implementation, clock-injectable so chaos scenarios
(``testing.chaos.VirtualClock``) can expire deadlines deterministically
without wall-clock sleeps.
"""

from __future__ import annotations

import time
from typing import Callable, Optional


class Deadline:
    """A monotonic-clock budget: ``Deadline(2.5)`` expires 2.5 seconds
    after construction. ``seconds=None`` never expires (the explicit
    no-deadline object, so call sites need no None-guards)."""

    __slots__ = ("seconds", "_clock", "_t0", "_expires_at")

    def __init__(self, seconds: Optional[float],
                 clock: Callable[[], float] = time.monotonic):
        if seconds is not None and seconds < 0:
            raise ValueError(f"deadline seconds must be >= 0, got {seconds}")
        self.seconds = seconds
        self._clock = clock
        self._t0 = clock()
        self._expires_at = None if seconds is None else self._t0 + seconds

    @classmethod
    def never(cls) -> "Deadline":
        return cls(None)

    def remaining(self) -> Optional[float]:
        """Seconds left (negative once blown); None for a never-expiring
        deadline."""
        if self._expires_at is None:
            return None
        return self._expires_at - self._clock()

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def elapsed(self) -> float:
        """Seconds since the budget started — what a deadline-flagged
        outcome actually spent, for the flight recorder's timeline
        (``remaining()`` alone cannot say how much of a blown budget the
        request consumed before its verdict)."""
        return max(0.0, self._clock() - self._t0)

    def __repr__(self) -> str:  # readable in chaos reports / diagnostics
        if self._expires_at is None:
            return "Deadline(never)"
        return f"Deadline({self.seconds}s, {self.remaining():+.3f}s left)"
