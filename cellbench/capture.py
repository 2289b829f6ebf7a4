"""A ``torch.profiler`` capture of a slice of the window, reduced to plain
events that the per-layer readers (``metrics/``) and the breakdown read.

The traced run profiles whole solves from the window's start until at
least ``MIN_SLICE_S`` seconds and one solve have passed. Each solve is
wrapped in a ``cellbench.solve`` annotation (the benchmark's own span, not
the program's), whose ends bound the slice on the profiler's clock.
"""

from __future__ import annotations

import gzip
import heapq
import json
from collections import defaultdict
from typing import NamedTuple

MIN_SLICE_S = 2.0
ANNOTATION = "cellbench.solve"
DEVICE_KINDS = ("kernel", "memcpy", "memset")
UNTRACED = "host (no traced call)"
TOP = 10
NAME_CHARS = 96

_ACTIVITY = {"kernel": "kernel", "gpu_memcpy": "memcpy",
             "gpu_memset": "memset"}


class Event(NamedTuple):
    name: str
    kind: str        # "kernel", "memcpy", "memset" on a card; "host" on the CPU
    device: int      # the card's index; -1 on the host
    start_us: float
    dur_us: float

    @property
    def end_us(self) -> float:
        return self.start_us + self.dur_us


class Capture(NamedTuple):
    """What one traced slice holds, with what the readers need beside it."""

    events: tuple            # Event, every kind
    start_us: float          # the slice: first captured solve's start …
    end_us: float            # … to the last one's end
    cards: tuple             # the cards the run uses
    iterations: int          # iterations the captured solves returned
    solve_iterations: tuple  # iterations of every solve of the window
    config: dict
    device_kind: str         # torch.cuda.get_device_name()

    @property
    def window_us(self) -> float:
        return self.end_us - self.start_us


def _kind(activity: str, name: str) -> str:
    if activity in _ACTIVITY:
        return _ACTIVITY[activity]
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def sync(cards) -> None:
    """Wait until every card used is idle."""
    import torch

    for c in cards:
        torch.cuda.synchronize(c)


def start(cards):
    """A started profiler: the host, and the cards where there are any."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cards:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop(prof, cards) -> tuple:
    """Stop the profiler once the cards are idle; its events."""
    sync(cards)
    prof.stop()
    return tuple(events_from(prof))


def events_from(prof) -> list[Event]:
    """The profiler's events as plain :class:`Event` s."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        dt = e.device_type()
        if dt == DeviceType.CUDA:
            if e.name() == ANNOTATION:    # the annotation's span on the card
                continue
            activity = getattr(e, "activity_type", None)
            kind = _kind(activity() if activity else "", e.name())
            dev = e.device_index()
        elif dt == DeviceType.CPU:
            kind, dev = "host", -1
        else:
            continue
        out.append(Event(e.name(), kind, dev, e.start_ns() / 1e3,
                         e.duration_ns() / 1e3))
    return out


def solve_bounds(events) -> tuple[float, float]:
    """(start, end) of the captured solves, from their annotations."""
    marks = [e for e in events if e.kind == "host" and e.name == ANNOTATION]
    if not marks:
        raise ValueError(f"no {ANNOTATION} annotation in the capture")
    return min(e.start_us for e in marks), max(e.end_us for e in marks)


def on_card(cap: Capture, card: int):
    """Events of one card inside the slice."""
    return [e for e in cap.events if e.device == card
            and e.kind in DEVICE_KINDS
            and e.end_us > cap.start_us and e.start_us < cap.end_us]


def busy_intervals(cap: Capture, card: int) -> list[tuple[float, float]]:
    """The union of the card's operations inside the slice, as disjoint
    (start, end) intervals, clipped to the slice."""
    spans = sorted((max(e.start_us, cap.start_us), min(e.end_us, cap.end_us))
                   for e in on_card(cap, card))
    merged: list[list[float]] = []
    for s, t in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return [(s, t) for s, t in merged]


def busy_us(cap: Capture, card: int) -> float:
    return sum(t - s for s, t in busy_intervals(cap, card))


def mean_busy_us(cap: Capture) -> float:
    """Device-busy µs in the slice, averaged over the cards used (0 with
    no card)."""
    if not cap.cards:
        return 0.0
    return sum(busy_us(cap, c) for c in cap.cards) / len(cap.cards)


def idle_gaps(cap: Capture, card: int) -> list[tuple[float, float]]:
    """The slice's stretches with nothing running on ``card``."""
    gaps, at = [], cap.start_us
    for s, t in busy_intervals(cap, card):
        if s > at:
            gaps.append((at, s))
        at = max(at, t)
    if cap.end_us > at:
        gaps.append((at, cap.end_us))
    return gaps


def _host_doing(host, gaps) -> dict:
    """Idle µs by what the host was doing: each stretch of a gap goes to
    the innermost host event covering it (the benchmark's own annotation
    left out); a stretch no host event covers is the host's own untraced
    work (NumPy, Python)."""
    host = sorted(host)
    doing: dict[str, float] = defaultdict(float)
    live: list[tuple[float, float, str]] = []   # (end, start, name)
    i = 0
    for g0, g1 in sorted(gaps):
        while i < len(host) and host[i][0] < g1:
            s, t, name = host[i]
            heapq.heappush(live, (t, s, name))
            i += 1
        while live and live[0][0] <= g0:
            heapq.heappop(live)
        cover = [(s, t, name) for t, s, name in live if s < g1]
        cuts = sorted({g0, g1, *(min(max(x, g0), g1)
                                for s, t, _ in cover for x in (s, t))})
        for a, b in zip(cuts, cuts[1:]):
            inner = [(t - s, name) for s, t, name in cover
                     if s <= a and t >= b]
            doing[min(inner)[1] if inner else UNTRACED] += b - a
    return doing


def breakdown(cap: Capture) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing, both in seconds averaged over the cards."""
    n = len(cap.cards)
    ops: dict[str, float] = defaultdict(float)
    for c in cap.cards:
        for e in on_card(cap, c):
            ops[e.name[:NAME_CHARS]] += e.dur_us / 1e6 / n
    host = [(e.start_us, e.end_us, e.name[:NAME_CHARS]) for e in cap.events
            if e.kind == "host" and e.name != ANNOTATION]
    idle: dict[str, float] = defaultdict(float)
    for c in cap.cards:
        for name, us in _host_doing(host, idle_gaps(cap, c)).items():
            idle[name] += us / 1e6 / n
    top = lambda d: [[k, v] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def write_trace(cap: Capture, path) -> None:
    """The slice's events as a gzipped Chrome trace (Perfetto opens it)."""
    rows = [{"name": e.name, "cat": e.kind, "ph": "X", "ts": e.start_us,
             "dur": e.dur_us, "pid": "host" if e.device < 0 else
             f"card {e.device}", "tid": 0 if e.kind == "host" else e.kind}
            for e in cap.events]
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": rows}, f)
