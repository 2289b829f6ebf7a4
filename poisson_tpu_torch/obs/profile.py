"""Fenced ``torch.profiler`` capture on the span rails (counterpart of
``poisson_tpu/obs/profile.py``).

Configured by ``POISSON_TPU_PROFILE_DIR`` or ``obs.configure(profile_dir=…)``
(the CLI's ``--profile DIR``)::

    from poisson_tpu_torch.obs import profile
    with profile.capture("bench.solve"):
        run()

With no directory configured, ``capture`` is a null context. Configured,
the region runs under ``torch.profiler.profile(activities=[CPU, CUDA])``
(CPU only on a machine without a card), the device is fenced with
``torch.cuda.synchronize()`` before the trace closes, so queued kernels land
inside it, and the Chrome trace is exported to ``<dir>/<name>/trace.json``
(Perfetto opens it). The region is also an ``obs`` span, counted on
``profile.captures`` and announced by a ``profile.capture`` event with the
file's path. A profiler that cannot start or export is counted on
``profile.errors`` with a ``profile.capture_failed`` event; the region
still runs.

Captures are of extra runs, never of timed ones: profiling makes launches
dearer.

The hot path carries unfenced ranges of its own (:func:`region`, the
port's own; the JAX package has no counterpart): ``pcg.drive.enqueue`` and
``pcg.drive.check`` around each block of ``solvers.pcg.drive``,
``stage.rhs_in`` and ``stage.w_out`` around the host staging of
``ops.fused_cg``, ``stage.fields_in`` around the copies up of the plain
solve's fields (``solvers.pcg.solve_fields``), and ``mesh.halo``,
``mesh.sum`` and ``mesh.replicate`` around the halo exchange, the
mesh-order sums and the scalar broadcasts of ``parallel.halo``. A range
exists only while a profiler runs, whichever started it (:func:`capture`,
or a caller's own ``torch.profiler``), and is then a host operator on the
profiler's clock beside the card's activities; it is never an event on
the card, and never a recorder event, so a plain solve leaves the
recorder unconfigured and its logs as the JAX package writes them.
"""

from __future__ import annotations

import contextlib
import os
from typing import Optional

import torch

_PROFILE_DIR: Optional[str] = None

TRACE_FILE = "trace.json"

# A host operator, not a user annotation: ``record_function`` is mirrored
# onto the card as an annotation event and costs ≈ 10 µs a call even with
# no profiler running.
_RANGE = torch._C._profiler._RecordFunctionFast
_profiling = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def region(name: str):
    """An unfenced host range ``name`` while a profiler runs; otherwise one
    shared null context (a check of the profiler's flag, nothing more)."""
    if _profiling():
        return _RANGE(name)
    return _OFF


def configure(profile_dir: Optional[str]) -> None:
    """Install (or clear, with None) the process-wide capture directory."""
    global _PROFILE_DIR
    _PROFILE_DIR = profile_dir or None


def profile_dir() -> Optional[str]:
    """The active capture directory (None: :func:`capture` does nothing)."""
    return _PROFILE_DIR


def configure_from_env() -> None:
    """Adopt ``POISSON_TPU_PROFILE_DIR`` when no directory is configured."""
    if _PROFILE_DIR is None:
        configure(os.environ.get("POISSON_TPU_PROFILE_DIR"))


def enabled() -> bool:
    return _PROFILE_DIR is not None


def _fence() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def capture(name: str, profile_dir: Optional[str] = None):
    """Profile the enclosed region into ``<dir>/<name>/trace.json`` (an
    explicit ``profile_dir`` wins over the configured one; with neither, a
    null context). Yields the capture directory, or None."""
    target = profile_dir or _PROFILE_DIR
    if not target:
        yield None
        return

    from poisson_tpu_torch import obs

    out = os.path.join(target, name.replace("/", "_"))
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities)
        prof.__enter__()
    except Exception as e:   # a profiler that cannot start: run untraced
        obs.inc("profile.errors")
        obs.event("profile.capture_failed", capture=name, dir=out,
                  error=repr(e)[:200])
        yield None
        return
    span = obs.span(f"profile.{name}", fence=False, dir=out)
    span.__enter__()
    try:
        yield out
    finally:
        _fence()    # queued device work lands inside the capture
        span.__exit__(None, None, None)
        prof.__exit__(None, None, None)
        try:
            os.makedirs(out, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out, TRACE_FILE))
        except Exception as e:
            obs.inc("profile.errors")
            obs.event("profile.capture_failed", capture=name, dir=out,
                      error=repr(e)[:200])
        else:
            obs.inc("profile.captures")
            obs.event("profile.capture", capture=name, dir=out)
