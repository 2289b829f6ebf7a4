"""Blocks of :func:`solvers.pcg.drive` replayed as captured CUDA graphs.

On the card one fused step (``ops.fused_cg``) is two hand-written kernels
and some thirty small torch operations. Queueing them from Python costs the
host about a millisecond a step, many times what the card spends on them,
so the host, not the card, sets the pace of the loop. A step that carries a
:class:`Capturable` mark has each block of ``check_every`` steps captured
once as a ``torch.cuda.CUDAGraph`` and replayed, one launch a block; the
host still reads ``done`` between two replays, as the plain loop does.
``ops.fused_cg`` marks its body on a device that :func:`can_capture` only,
so on the CPU, and for every unmarked step, ``drive`` runs its plain loop.

The graph reads and writes one static state (:class:`Block`). The steps
inside it are the eager steps: the same kernels, arguments and order, so
the iterate and the count are the eager loop's bit for bit. Its last
operations copy the block's new scalars back into the static ones, so one
replay follows another with nothing on the host between them. A state
enters the static tensors by device copies, and only where its fields
alias each other as the static ones do (a fused state's ``z`` is ``r``);
any other state runs eagerly until it does. ``drive`` hands back a state
that owns its tensors, copied out of the static ones.

The mark holds its step's blocks, one per ``check_every``; the step's
constant tensors, which the graph reads, live as long as the mark does.
A block is captured on its state's device, and only once an eager block
of its step has run, so lazy set-up (a library's load, a kernel's
attributes) never happens inside a capture. One thread at a time replays
a block: another that finds it held runs the eager loop.

Counters (``obs.metrics``): ``pcg.drive.graph_captures``,
``pcg.drive.graph_replays`` and ``pcg.drive.eager_steps`` (steps of a
marked step run eagerly). A replay calls no kernel wrapper, so it adds to
the wrappers' launch counters the launches counted while its block was
captured. Those are measured: each counted launch asks for its stream
through :func:`launch_stream`, and a capture in which one went to another
stream than the capture's is refused.
"""

from __future__ import annotations

import threading

import torch

from poisson_tpu_torch.obs.metrics import inc

# The launch counters a kernel wrapper may carry (``ops.fused_cg``).
LAUNCH_COUNTERS = ("launches", "sharded_launches", "blocked_launches")

# The capture in progress on this thread: its stream, and the counted
# launches that went to it (``captured``) and to another (``strays``).
_audit = threading.local()


def can_capture(device: torch.device) -> bool:
    """Whether a step on ``device`` may be replayed as a captured graph."""
    return device.type == "cuda"


def launch_stream(device: torch.device) -> int:
    """The stream a counted kernel launch on ``device`` goes to: its
    current stream. While this thread captures a block, the launch is
    noted as going to the capture's stream or to another."""
    stream = torch.cuda.current_stream(device).cuda_stream
    capture = getattr(_audit, "stream", None)
    if capture is not None:
        if stream == capture:
            _audit.captured += 1
        else:
            _audit.strays += 1
    return stream


class Capturable:
    """The mark a step carries (as its ``capturable`` attribute) when its
    blocks may be replayed as a captured graph: the kernel wrappers whose
    launch counters a replay adds to, and the step's blocks."""

    def __init__(self, wrappers: tuple):
        self.wrappers = wrappers
        self.blocks: dict = {}    # check_every -> Block

    def block(self, n: int) -> Block:
        block = self.blocks.get(n)
        if block is None:
            block = self.blocks.setdefault(n, Block(self.wrappers, n))
        return block


def _aliasing(fields) -> tuple:
    """For each field, the first field holding the same memory."""
    ptrs = [t.data_ptr() for t in fields]
    return tuple(ptrs.index(p) for p in ptrs)


def _copied(fields, ptrs=None) -> list:
    """``fields`` with each tensor (each in ``ptrs``, where given) replaced
    by a copy, fields that share memory sharing their copy."""
    copies: dict = {}
    out = []
    for t in fields:
        p = t.data_ptr()
        if ptrs is not None and p not in ptrs:
            out.append(t)
            continue
        if p not in copies:
            copies[p] = t.clone()
        out.append(copies[p])
    return out


def _counts(wrappers) -> dict:
    return {(fn, name): getattr(fn, name) for fn in wrappers
            for name in LAUNCH_COUNTERS if hasattr(fn, name)}


class Block:
    """One block of ``n`` steps of a marked step: its static state, its
    replay and the launches a replay makes."""

    def __init__(self, wrappers, n: int):
        self.wrappers, self.n = wrappers, n
        self.lock = threading.Lock()
        self.warm = False     # an eager block of this step has run
        self.broken = False   # the block cannot be replayed: never again
        self.state = None     # the static state the replay reads and writes
        self.replay = None
        self.launches = ()    # (wrapper, counter, launches a replay makes)

    def _capture(self, fn, device: torch.device):
        """``fn`` captured on a stream of ``device``; returns its replay.
        Refused where a counted launch went to another stream than the
        capture's: the graph would miss work that ``fn`` ran."""
        graph = torch.cuda.CUDAGraph()
        _audit.strays = _audit.captured = 0
        try:
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    _audit.stream = stream.cuda_stream
                    fn()
        finally:
            _audit.stream = None
        if _audit.strays:
            raise RuntimeError(
                f"capture of a {self.n}-step block on {device}: "
                f"{_audit.captured} counted kernel launches went to the "
                f"capture's stream and {_audit.strays} to another")

        def replay():
            with torch.cuda.device(device):
                graph.replay()

        return replay

    def _build(self, step, s) -> None:
        """Capture the block from a copy of ``s``, which becomes the static
        state. A block that ends on another arrangement of the static
        tensors than it starts from (an odd ``n`` swaps the fused
        direction's two canvases) cannot be chained: it is marked broken."""
        self.state = type(s)(*_copied(s))
        chained = []

        def block():
            out = self.state
            for _ in range(self.n):
                out = step(out)
            chained.append(_write_back(out, self.state))

        before = _counts(self.wrappers)
        try:
            replay = self._capture(block, s.done.device)
        finally:
            after = _counts(self.wrappers)
            for (fn, name), value in before.items():
                setattr(fn, name, value)
        if not all(chained):
            self.broken, self.state = True, None
            return
        self.launches = tuple((fn, name, after[fn, name] - value)
                              for (fn, name), value in before.items()
                              if after[fn, name] != value)
        self.replay = replay
        inc("pcg.drive.graph_captures")

    def _load(self, s) -> bool:
        """Copy ``s`` into the static state where its fields alias as the
        static ones do and none of them is a static tensor."""
        fields, static = list(s), list(self.state)
        if _aliasing(fields) != _aliasing(static):
            return False
        ptrs = {t.data_ptr() for t in static}
        if any(t.data_ptr() in ptrs or t.shape != u.shape
               or t.dtype != u.dtype or t.device != u.device
               for t, u in zip(fields, static)):
            return False
        for i, j in enumerate(_aliasing(static)):
            if i == j:
                static[i].copy_(fields[i])
        return True

    def advance(self, step, s):
        """``s`` advanced one block by a replay (captured first, on the
        block's first use), or None where the block cannot replay it."""
        if not self.warm or self.broken:
            return None
        if self.replay is None:
            self._build(step, s)
            if self.broken:
                return None
        elif s is not self.state and not self._load(s):
            return None
        self.replay()
        for fn, name, k in self.launches:
            setattr(fn, name, getattr(fn, name) + k)
        inc("pcg.drive.graph_replays")
        return self.state

    def own(self, s):
        """``s`` with every static tensor in it replaced by a copy."""
        if self.state is None:
            return s
        return type(s)(*_copied(s, {t.data_ptr() for t in self.state}))


def _write_back(out, static) -> bool:
    """Copy each field of ``out`` that is a new tensor into its static
    field; False where a field is another field's static tensor."""
    ptrs = {t.data_ptr() for t in static}
    for t, u in zip(out, static):
        if t.data_ptr() == u.data_ptr():
            continue
        if t.data_ptr() in ptrs:
            return False
        u.copy_(t)
    return True


class Claim:
    """A drive call's use of a marked step's block: ``held`` while it holds
    the block's lock, which it keeps to its end."""

    def __init__(self, step, check_every: int):
        self.block = step.capturable.block(check_every)
        self.held = self.block.lock.acquire(blocking=False)

    def advance(self, step, s, n: int):
        """``s`` advanced ``n`` steps: by a replay where the claim holds
        the block and ``n`` is its length, else eagerly."""
        if self.held and n == self.block.n:
            out = self.block.advance(step, s)
            if out is not None:
                return out
        for _ in range(n):
            s = step(s)
        inc("pcg.drive.eager_steps", n)
        if self.held:
            self.block.warm = True
        return s

    def finish(self, s):
        """The final state, owning its tensors."""
        return self.block.own(s) if self.held else s

    def release(self) -> None:
        if self.held:
            self.block.lock.release()


def claim(step, check_every: int) -> Claim | None:
    """The claim of a marked ``step``'s block of ``check_every`` steps,
    held unless another thread holds it; None for an unmarked step."""
    if getattr(step, "capturable", None) is None:
        return None
    return Claim(step, check_every)
