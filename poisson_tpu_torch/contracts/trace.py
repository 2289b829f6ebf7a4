"""Op traces of the port's programs: the counterpart of the JAX package's
``contracts/hlo.py``.

The JAX gate canonicalizes a lowered StableHLO program. An eager PyTorch
program has no lowering: what it *is* is the sequence of aten operations
it dispatches. :class:`OpRecorder` (a ``TorchDispatchMode``, the pattern of
``obs.costs``' counter) records that sequence, one canonical line per op —
the phase it ran in, the op's name, and the dtype and shape of every
tensor it took and gave, never a value or an address — and
:func:`trace_fingerprint` is the sha256 of the lines. Two traces with
equal lines issue the same ops on the same shapes in the same order.

Phases: ``setup`` until a solve driver (``solvers.pcg.drive`` or
``solvers.batched.step_members``) is entered, ``step`` while the driver
runs its step body, ``drive`` for the driver's own work between steps
(its read of ``done``, a stream's flush), ``finish`` after it returns.
:func:`tagged_drivers` sets them by wrapping the drivers wherever the
port's modules bound them.

Markers (:func:`find_forbidden`) are the structural assertions:
``callbacks`` — a host read (``aten::_local_scalar_dense``: ``.item()``,
``float(t)``, ``bool(t)``) inside the step (anywhere, for a program with
no driver); ``collectives`` — a c10d or functional-collective op;
``mg`` — a dense product (``mm``, ``mv``, ``addmm``, ``addmv``, ``bmm``,
``matmul``), which only the V-cycle's coarsest solve issues. A host read
that does not dispatch on a CPU tensor (``.tolist()``, ``.cpu()``) is not
seen here: the lint's ``callback-gate`` rule covers those by source.
"""

from __future__ import annotations

import contextlib
import hashlib
import sys
from typing import Iterable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

CALLBACK_MARKERS = ("aten::_local_scalar_dense",)
COLLECTIVE_MARKERS = ("c10d::", "_c10d_functional::", "all_reduce", "allreduce", "all_gather", "allgather",
                      "reduce_scatter", "all_to_all", "broadcast_")
MG_MARKERS = ("aten::mm", "aten::mv", "aten::addmm", "aten::addmv",
              "aten::bmm", "aten::matmul")

PHASES = ("setup", "step", "drive", "finish")


def _sig(x) -> str:
    if isinstance(x, torch.Tensor):
        dtype = str(x.dtype).removeprefix("torch.")
        return f"{dtype}{list(x.shape)}"
    if isinstance(x, (list, tuple)):
        inner = ",".join(_sig(v) for v in x)
        return f"[{inner}]" if isinstance(x, list) else f"({inner})"
    if x is None:
        return "None"
    return type(x).__name__


def canonical_line(phase: str, func, args, kwargs, out) -> str:
    """One op as ``phase op (inputs) -> (outputs)``: the op's name and each
    argument's dtype and shape (a Python scalar as its type); no value, no
    address, no device."""
    ins = ",".join(_sig(a) for a in args)
    if kwargs:
        ins += ";" + ",".join(f"{k}={_sig(v)}"
                              for k, v in sorted(kwargs.items()))
    return f"{phase} {func.name()} ({ins}) -> {_sig(out)}"


class OpRecorder(TorchDispatchMode):
    """Records every aten op dispatched while it is active as a canonical
    line, under the current :attr:`phase`."""

    def __init__(self):
        super().__init__()
        self.lines: list = []
        self.phase = "setup"

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.lines.append(canonical_line(self.phase, func, args,
                                         kwargs or {}, out))
        return out

    def tag(self, step):
        """``step`` run under the ``step`` phase (its ``flush``, the stream
        tap ``drive`` reads, kept)."""
        def tagged(*a, **kw):
            self.phase = "step"
            try:
                return step(*a, **kw)
            finally:
                self.phase = "drive"

        if hasattr(step, "flush"):
            tagged.flush = step.flush
        return tagged


@contextlib.contextmanager
def tagged_drivers(rec):
    """Wrap ``solvers.pcg.drive`` and ``solvers.batched.step_members`` in
    every loaded module of the port that bound them, so ``rec`` sees the
    phases; restored on exit."""
    from poisson_tpu_torch.solvers import batched, pcg

    real = {"drive": pcg.drive, "step_members": batched.step_members}

    def drive(step, s, *a, **kw):
        rec.phase = "drive"
        try:
            return real["drive"](rec.tag(step), s, *a, **kw)
        finally:
            rec.phase = "finish"

    def step_members(body, s, *a, **kw):
        rec.phase = "drive"
        try:
            return real["step_members"](rec.tag(body), s, *a, **kw)
        finally:
            rec.phase = "finish"

    wrappers = {"drive": drive, "step_members": step_members}
    patched = []
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("poisson_tpu_torch"):
            continue
        for name, fn in real.items():
            if getattr(mod, name, None) is fn:
                setattr(mod, name, wrappers[name])
                patched.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)


def record(fn) -> list:
    """The canonical lines of one call of ``fn`` (drivers tagged)."""
    rec = OpRecorder()
    with tagged_drivers(rec), rec:
        fn()
    return rec.lines


def trace_text(lines: Sequence[str]) -> str:
    return "\n".join(lines) + "\n"


def trace_fingerprint(lines: Sequence[str]) -> str:
    """sha256 of the canonical trace."""
    return hashlib.sha256(trace_text(lines).encode("utf-8")).hexdigest()


def find_forbidden(lines: Sequence[str], markers: Iterable[str],
                   step_only: bool = False) -> list:
    """The markers present in the trace (each once, in order). With
    ``step_only`` and a trace that has a step phase, only the step's ops
    are searched."""
    scope = list(lines)
    if step_only and any(line.startswith("step ") for line in scope):
        scope = [line for line in scope if line.startswith("step ")]
    ops = [line.split(" ", 2)[1] for line in scope]
    return [m for m in markers if any(m in op for op in ops)]


# Marker set → (markers, whether only the step's ops are searched).
MARKER_SETS = {"callbacks": (CALLBACK_MARKERS, True),
               "collectives": (COLLECTIVE_MARKERS, False),
               "mg": (MG_MARKERS, False)}


def structural_violations(lines: Sequence[str], forbid: Iterable[str]) -> list:
    """Every forbidden marker the trace holds, as ``set:marker``."""
    out = []
    for name in forbid:
        markers, step_only = MARKER_SETS[name]
        out += [f"{name}:{m}" for m in find_forbidden(lines, markers,
                                                       step_only)]
    return out
