"""Spans: the timeline of the telemetry subsystem (counterpart of
``poisson_tpu/obs/trace.py``).

One nestable, fenced span API that emits two views of the same record,
in the JAX package's formats, so that either package reads the other's
trace directory:

- ``trace-rank{R}.trace.json`` — Chrome/Perfetto trace-event JSON
  (``{"traceEvents": [{"ph": "X", "ts": …, "dur": …, "name": …,
  "pid": rank, "tid": thread}]}``), ``ts`` in wall-clock microseconds so
  the ranks of a multi-process run merge into one timeline
  (:func:`merge_trace_dir`);
- ``events-rank{R}.jsonl`` — the structured event log (schema 2: the
  envelope ``schema``/``at_unix``/``at_mono``/``rank``/``kind``/``name``
  flat, the caller's fields under ``attrs``), appended and flushed as
  events happen, so a killed run leaves its evidence on disk.

A span's exit fences the device work queued inside it (unless it is
made with ``fence=False``): PyTorch returns before the card has finished,
so the fence is ``torch.cuda.synchronize`` on the span's device (the
current card when none is named and CUDA is in use), and nothing on the
CPU. Without the fence a span would time the enqueue, not the work. The
solve loop and the host staging are not spans: they carry unfenced
profiler ranges (:func:`poisson_tpu_torch.obs.profile.region`), which
record nothing here, so a plain solve leaves the recorder unconfigured.

While a profiler runs, a span also enters a profiler range of its own
name, left after the fence, so request-level spans (``serve.dispatch``,
``checkpoint.write``, ``bench.*``, ``profile.<name>``) sit in the device
trace beside the kernels; ``ts`` is on the profiler's epoch clock too.
With no profiler running nothing changes.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Optional

import torch

from poisson_tpu_torch.obs.profile import region

# JSONL event-log schema version, the JAX package's (v1 lines, caller
# fields flat beside the envelope, still load through normalize_event).
EVENTS_SCHEMA = 2


def device_fence(device=None) -> None:
    """Wait for the work queued on ``device``: ``torch.cuda.synchronize``
    on a CUDA device, nothing on the CPU. ``None`` fences the current card
    only when CUDA is already in use, so a CPU run never starts it."""
    if device is None:
        if not torch.cuda.is_initialized():
            return
        torch.cuda.synchronize()
        return
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def default_rank() -> int:
    """Process index for event attribution: the ``torch.distributed``
    rank when a process group formed, else the ``RANK`` env (launchers set
    it), else 0."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
    except Exception:
        pass
    try:
        return int(os.environ.get("RANK", "0"))
    except ValueError:
        return 0


class _Span:
    """Context manager for one span; created via :meth:`TraceRecorder.span`."""

    __slots__ = ("_rec", "name", "args", "fence", "device", "_range", "_t0",
                 "_wall0", "seconds")

    def __init__(self, rec: "TraceRecorder", name: str, fence: bool, device,
                 args):
        self._rec = rec
        self.name = name
        self.args = args
        self.fence = fence
        self.device = device
        self.seconds: Optional[float] = None

    def __enter__(self) -> "_Span":
        self._rec._push(self.name)
        self._range = region(self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        self._wall0 = time.time()
        self._rec._emit_jsonl("span_begin", self.name, self.args)
        return self

    def __exit__(self, *exc) -> None:
        if self.fence:
            device_fence(self.device)
        self._range.__exit__(None, None, None)
        self.seconds = time.perf_counter() - self._t0
        path = self._rec._pop()
        self._rec._add_trace_event({
            "ph": "X",
            "name": self.name,
            "cat": "span",
            "ts": self._wall0 * 1e6,
            "dur": self.seconds * 1e6,
            "pid": self._rec.rank,
            "tid": threading.get_ident() % 2**31,
            "args": dict(self.args),
        })
        fields = dict(self.args)
        fields["seconds"] = round(self.seconds, 6)
        fields["span_path"] = path
        if exc and exc[0] is not None:
            fields["error"] = getattr(exc[0], "__name__", str(exc[0]))
        self._rec._emit_jsonl("span_end", self.name, fields)


class TraceRecorder:
    """One process's recorder: spans, instant events, a ring of recent
    events, and the two output files of the module docstring.
    ``trace_dir=None`` records in memory only."""

    def __init__(self, trace_dir: Optional[str] = None,
                 rank: Optional[int] = None, recent: int = 64):
        self.trace_dir = trace_dir
        self.rank = default_rank() if rank is None else int(rank)
        self._trace_events: list[dict] = []
        self._recent = collections.deque(maxlen=recent)
        self._lock = threading.Lock()
        self._stack = threading.local()
        self._jsonl = None
        self._closed = False
        if trace_dir:
            os.makedirs(trace_dir, exist_ok=True)

    # -- span nesting (per thread) -------------------------------------

    def _push(self, name: str) -> None:
        stack = getattr(self._stack, "names", None)
        if stack is None:
            stack = self._stack.names = []
        stack.append(name)

    def _pop(self) -> str:
        stack = getattr(self._stack, "names", [])
        path = "/".join(stack)
        if stack:
            stack.pop()
        return path

    # -- public API ----------------------------------------------------

    def span(self, name: str, fence: bool = True, device=None,
             **args) -> _Span:
        """Nestable timed region. ``fence=True`` (default) synchronizes
        ``device`` at exit (:func:`device_fence`), so the duration covers
        the work queued inside. ``device`` is not recorded."""
        return _Span(self, name, fence, device, args)

    def event(self, name: str, **fields) -> None:
        """Instant event: a point on the timeline plus a JSONL record."""
        self._add_trace_event({
            "ph": "i",
            "name": name,
            "cat": "event",
            "s": "p",
            "ts": time.time() * 1e6,
            "pid": self.rank,
            "tid": threading.get_ident() % 2**31,
            "args": dict(fields),
        })
        self._emit_jsonl("event", name, fields)

    def recent_events(self) -> list[dict]:
        """The last records (newest last), normalized."""
        with self._lock:
            return [dict(e) for e in self._recent]

    @property
    def events_path(self) -> Optional[str]:
        if not self.trace_dir:
            return None
        return os.path.join(self.trace_dir, f"events-rank{self.rank}.jsonl")

    @property
    def trace_path(self) -> Optional[str]:
        if not self.trace_dir:
            return None
        return os.path.join(self.trace_dir,
                            f"trace-rank{self.rank}.trace.json")

    def trace_events(self) -> list[dict]:
        with self._lock:
            return [dict(e) for e in self._trace_events]

    def flush(self) -> None:
        """Write the Chrome trace file (atomic replace) with everything
        recorded so far; the JSONL log is already on disk."""
        path = self.trace_path
        if not path:
            return
        with self._lock:
            payload = {
                "traceEvents": list(self._trace_events),
                "displayTimeUnit": "ms",
                "otherData": {"rank": self.rank, "pid": os.getpid(),
                              "tool": "poisson_tpu_torch.obs"},
            }
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, default=str)
            os.replace(tmp, path)
        except OSError:
            try:
                if os.path.exists(tmp):
                    os.remove(tmp)
            except OSError:
                pass

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self.flush()
        with self._lock:
            if self._jsonl is not None:
                try:
                    self._jsonl.close()
                except OSError:
                    pass
                self._jsonl = None

    # -- internals -----------------------------------------------------

    def _add_trace_event(self, ev: dict) -> None:
        with self._lock:
            if not self._closed:
                self._trace_events.append(ev)

    def _emit_jsonl(self, kind: str, name: str, fields: dict) -> None:
        rec = {
            "schema": EVENTS_SCHEMA,
            "at_unix": time.time(),
            "at_mono": time.monotonic(),
            "rank": self.rank,
            "kind": kind,
            "name": name,
            "attrs": dict(fields),
        }
        with self._lock:
            if self._closed:
                return
            self._recent.append(normalize_event(rec))
            path = self.events_path
            if path is None:
                return
            try:
                if self._jsonl is None:
                    self._jsonl = open(path, "a")
                self._jsonl.write(json.dumps(rec, default=str) + "\n")
                self._jsonl.flush()
            except (OSError, ValueError, TypeError):
                pass


# -- reading and merging -------------------------------------------------


def normalize_event(rec: dict) -> dict:
    """One JSONL record in the readable shape, whichever schema wrote it:
    v2's ``attrs`` merged flat where they do not collide with the envelope,
    and kept whole under ``attrs``; v1 records pass through."""
    attrs = rec.get("attrs")
    if not isinstance(attrs, dict):
        return rec
    out = {k: v for k, v in attrs.items() if k not in rec}
    out.update(rec)
    out["attrs"] = attrs
    return out


def load_events(trace_dir: str) -> list[dict]:
    """Every rank's JSONL records under ``trace_dir``, normalized, merged
    and sorted by wall time (a torn last line of a killed process is
    skipped)."""
    records = []
    for fname in sorted(os.listdir(trace_dir)):
        if not (fname.startswith("events-rank") and fname.endswith(".jsonl")):
            continue
        with open(os.path.join(trace_dir, fname)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    records.append(normalize_event(json.loads(line)))
                except ValueError:
                    continue
    records.sort(key=lambda r: r.get("at_unix", 0.0))
    return records


def merge_trace_dir(trace_dir: str,
                    out_path: Optional[str] = None) -> dict:
    """Every rank's Chrome trace under ``trace_dir`` merged into one
    document (ranks stay separate rows by ``pid``), with the per-kind tally
    in ``otherData.event_kinds`` and unreadable rank files listed under
    ``otherData.skipped``. Writes ``trace-merged.trace.json`` unless
    ``out_path`` is given."""
    merged: list[dict] = []
    ranks = []
    skipped = []
    for fname in sorted(os.listdir(trace_dir)):
        if not (fname.startswith("trace-rank")
                and fname.endswith(".trace.json")):
            continue
        try:
            with open(os.path.join(trace_dir, fname)) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            skipped.append({"file": fname, "error": str(e)[:200]})
            continue
        merged.extend(doc.get("traceEvents", []))
        ranks.append(doc.get("otherData", {}).get("rank"))
    merged.sort(key=lambda e: e.get("ts", 0.0))
    kinds: dict = {}
    for ev in merged:
        ph = str(ev.get("ph", "?"))
        kinds[ph] = kinds.get(ph, 0) + 1
    doc = {"traceEvents": merged, "displayTimeUnit": "ms",
           "otherData": {"ranks": ranks, "tool": "poisson_tpu_torch.obs",
                         "event_kinds": kinds, "skipped": skipped}}
    if out_path is None:
        out_path = os.path.join(trace_dir, "trace-merged.trace.json")
    with open(out_path, "w") as f:
        json.dump(doc, f)
    return doc
