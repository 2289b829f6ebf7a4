"""The one path of every kernel launch (kernels A, A′, B, B′, C, D, R and
S, and the two halves of the fused iteration's scalar recurrence):
:func:`launch` calls a library's C entry on the current stream of its
card, checks the code it returns and counts the launch in ``obs.metrics``
as ``ops.launches.<key>``: the wrapper's name, with ``_sharded`` for its
column-masked form and ``_blocked`` for kernels A′, B′ (:data:`FORMS`);
``recurrence_step`` and ``recurrence_close`` for the recurrence. A
block replayed as a captured CUDA graph (``solvers.graphs``) calls no
wrapper: it adds to these counters, as to every other, what its capture
counted.

While a thread captures a block, ``audit.streams`` holds the capture's
streams, and each launch is noted as going to one of them
(``audit.captured``) or to another (``audit.strays``): a capture with a
stray launch is refused (:class:`CaptureRefused`), since the launch ran
once, outside the graph, and no replay would run it.
"""

from __future__ import annotations

import threading

import torch

from poisson_tpu_torch.obs.metrics import get, inc
from poisson_tpu_torch.ops._build import Kernels, check

PREFIX = "ops.launches."
# The forms of each wrapper that launches a kernel: its name's suffixes.
FORMS = {
    "direction_and_stencil": ("", "_sharded", "_blocked"),
    "fused_update": ("", "_sharded", "_blocked"),
    "basis_sweep": ("", "_sharded"),
    "pair_update": ("", "_sharded"),
    "resident_solve": ("",),
    "serial_sum": ("",),
    "recurrence_step": ("",),
    "recurrence_close": ("",),
}

audit = threading.local()


class CaptureRefused(RuntimeError):
    """A capture in which a counted launch went to a stream outside it."""


def launch_stream(device: torch.device) -> int:
    """The stream a counted kernel launch on ``device`` goes to: its
    current stream. While this thread captures a block, the launch is
    noted as going to one of the capture's streams or to another."""
    stream = torch.cuda.current_stream(device).cuda_stream
    streams = getattr(audit, "streams", None)
    if streams is not None:
        if stream in streams:
            audit.captured += 1
        else:
            audit.strays += 1
    return stream


def launch(kernels: Kernels, entry: str, key: str, device: torch.device,
           *args) -> None:
    """Call ``kernels``' C entry ``entry`` with ``args``, then the index of
    ``device`` and the stream the launch goes to (:func:`launch_stream`);
    raise if it returns a CUDA error; count it as ``ops.launches.<key>``."""
    code = getattr(kernels.lib, entry)(*args, device.index or 0,
                                       launch_stream(device))
    check(kernels, code, f"{entry} launch")
    inc(PREFIX + key)


def launch_counts(*wrappers: str) -> dict:
    """The launches counted of each form of ``wrappers`` (of every wrapper
    when none is named), by key."""
    return {name + form: get(PREFIX + name + form)
            for name in wrappers or FORMS for form in FORMS[name]}


def reset_launch_counts() -> None:
    """Every launch counter back to 0."""
    for key, n in launch_counts().items():
        if n:
            inc(PREFIX + key, -n)
