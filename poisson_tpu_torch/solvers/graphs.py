"""Blocks of :func:`solvers.pcg.drive` replayed as captured CUDA graphs.

On the card one fused step (``ops.fused_cg``) is a handful of kernel
launches and small torch operations. Queueing them from Python costs the
host about a millisecond a step, many times what the card spends on them,
so the host, not the card, sets the pace of the loop. A step that carries a
:class:`Capturable` mark has each block of ``check_every`` steps captured
once as a ``torch.cuda.CUDAGraph`` and replayed, one launch a block; the
host still reads ``done`` between two replays, as the plain loop does.
``ops.fused_cg`` and ``parallel.fused_sharded`` mark their bodies on
devices that :func:`can_capture` only, so on the CPU, and for every
unmarked step, ``drive`` runs its plain loop.

The graph reads and writes one static state (:class:`Block`). The steps
inside it are the eager steps: the same kernels, arguments and order, so
the iterate and the count are the eager loop's bit for bit. Its last
operations copy the block's new scalars back into the static ones, so one
replay follows another with nothing on the host between them. A state
enters the static tensors by device copies, and only where its fields
alias each other as the static ones do (a fused state's ``z`` is ``r``);
any other state runs eagerly until it does. ``drive`` hands back a state
that owns its tensors, copied out of the static ones. A field may be a
tuple of tensors (a sharded state's canvases, one a shard): the state's
tensors are its fields' in turn.

A state whose tensors all live on one device is captured on a stream of
that device. One whose tensors span several cards (a mesh's shards) is
captured as one graph across them: on a stream of the card that holds
``done``, with each other card's current stream a side stream forked from
it and joined back at the end, and each other card's allocations routed to
a pool of its own, kept with the block, so that no memory the graph uses
goes back to that card's general cache while the graph lives. A replay of
such a block waits for each card's current stream and makes each wait for
it, as the eager steps on those streams would.

The mark holds its step's blocks, one per ``check_every``; the step's
constant tensors, which the graph reads, live as long as the mark does.
A block is captured only once an eager block of its step has run, so lazy
set-up (a library's load, a kernel's attributes, peer access between
cards) never happens inside a capture. A capture on several cards that
fails as a capture (:func:`_capture_failed`: refused, or an error CUDA
or PyTorch raises for work a stream capture cannot hold) leaves its
block broken: the step runs eagerly from then on. Any other error, and
any failure of a capture on one device, propagates out of ``drive``. One
thread at a time replays a block: another that finds it held runs the
eager loop.

Counters (``obs.metrics``): ``pcg.drive.graph_captures``,
``pcg.drive.graph_replays``, ``pcg.drive.multi_card_replays`` (replays of
a block across several cards) and ``pcg.drive.eager_steps`` (steps of a
marked step run eagerly). A replay calls no kernel wrapper and no Python
of the step, so it adds to every ``obs.metrics`` counter what the
capturing thread added to it while capturing (``obs.metrics.tally``): the
kernels' launches (``ops.launches.*``) and a mesh's traffic
(``parallel.halo``). The launches are audited: a capture in which a
counted launch went to a stream outside the capture is refused
(``ops.launch.CaptureRefused``).
"""

from __future__ import annotations

import contextlib
import threading
import warnings

import torch

from poisson_tpu_torch.obs.metrics import inc, tally
from poisson_tpu_torch.ops.launch import CaptureRefused, audit


def can_capture(device: torch.device) -> bool:
    """Whether a step on ``device`` may be replayed as a captured graph."""
    return device.type == "cuda"


def _capture_failed(e: BaseException) -> bool:
    """Whether ``e`` is a capture's own failure: a refused capture, or an
    error raised for work a stream capture cannot hold (CUDA's and
    PyTorch's messages for these all name the capture)."""
    return isinstance(e, CaptureRefused) or (
        isinstance(e, RuntimeError) and "captur" in str(e).lower())


class Capturable:
    """The mark a step carries (as its ``capturable`` attribute) when its
    blocks may be replayed as a captured graph: the step's blocks."""

    def __init__(self):
        self.blocks: dict = {}    # check_every -> Block

    def block(self, n: int) -> Block:
        block = self.blocks.get(n)
        if block is None:
            block = self.blocks.setdefault(n, Block(n))
        return block


def marked(bodies: dict, key, make):
    """The body cached in ``bodies`` under ``key``, else ``make()``'s,
    marked :class:`Capturable` and cached there: a cache kept with the
    canvases the body runs on, so that its captured blocks serve every
    solve on them."""
    body = bodies.get(key)
    if body is None:
        body = make()
        body.capturable = Capturable()
        body = bodies.setdefault(key, body)
    return body


def _tensors(s) -> list:
    """The tensors of state ``s``, field by field, a tuple field's in
    turn."""
    out = []
    for field in s:
        if isinstance(field, tuple):
            out.extend(field)
        else:
            out.append(field)
    return out


def _like(s, tensors):
    """A state of ``s``'s type and shape holding ``tensors``, in the order
    :func:`_tensors` lists ``s``'s."""
    it = iter(tensors)
    return type(s)(*(tuple(next(it) for _ in field)
                     if isinstance(field, tuple) else next(it)
                     for field in s))


def _aliasing(fields) -> tuple:
    """For each tensor, the first one holding the same memory."""
    ptrs = [t.data_ptr() for t in fields]
    return tuple(ptrs.index(p) for p in ptrs)


def _copied(fields, ptrs=None) -> list:
    """``fields`` with each tensor (each in ``ptrs``, where given) replaced
    by a copy, tensors that share memory sharing their copy."""
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


@contextlib.contextmanager
def _across(stream, sides, pools):
    """Inside a capture on ``stream``: each of ``sides`` (a stream of
    another card) made its card's current stream, forked from ``stream``,
    its card's allocations on this thread routed to its pool of ``pools``;
    at the end the cards' streams are restored, the current card too, and
    each side joined back to ``stream``. Nothing on one card."""
    if not sides:
        yield
        return
    device = torch.cuda.current_device()
    before = [torch.cuda.current_stream(side.device) for side in sides]
    with contextlib.ExitStack() as routed:
        for side, pool in zip(sides, pools):
            side.wait_stream(stream)
            routed.enter_context(torch.cuda.use_mem_pool(pool, side.device))
        try:
            for side in sides:
                torch.cuda.set_stream(side)
            torch.cuda.set_device(device)   # a launch may have moved it
            yield
        finally:
            for prev in before:
                torch.cuda.set_stream(prev)
            torch.cuda.set_device(device)
            for side in sides:
                stream.wait_stream(side)


def _other_devices(s, device: torch.device) -> list:
    """The devices of state ``s``'s tensors other than ``device``."""
    return list(dict.fromkeys(t.device for t in _tensors(s)
                              if t.device != device))


def _pool(device: torch.device):
    with torch.cuda.device(device):
        return torch.cuda.MemPool()


class Block:
    """One block of ``n`` steps of a marked step: its static state, its
    replay and the counts a replay adds."""

    def __init__(self, n: int):
        self.n = n
        self.lock = threading.Lock()
        self.warm = False     # an eager block of this step has run
        self.broken = False   # the block cannot be replayed: never again
        self.state = None     # the static state the replay reads and writes
        self.replay = None
        self.pools = ()       # a pool for each card past the first
        self.added = ()       # (counter, what a replay adds to it)

    def _capture(self, fn, device: torch.device, others=()):
        """``fn`` captured on a stream of ``device``, and of each card in
        ``others`` (its allocations routed to a new pool, kept in
        ``pools``); returns its replay. Refused where a counted launch went
        to a stream outside the capture: the graph would miss work that
        ``fn`` ran."""
        graph = torch.cuda.CUDAGraph()
        self.pools = tuple(_pool(d) for d in others)
        audit.strays = audit.captured = 0
        try:
            with torch.cuda.device(device):
                stream = torch.cuda.Stream(device)
                sides = [torch.cuda.Stream(d) for d in others]
                with torch.cuda.graph(graph, stream=stream,
                                      capture_error_mode="thread_local"):
                    audit.streams = {s.cuda_stream for s in (stream, *sides)}
                    with _across(stream, sides, self.pools):
                        fn()
        finally:
            audit.streams = None
        if audit.strays:
            raise CaptureRefused(
                f"capture of a {self.n}-step block on {device}: "
                f"{audit.captured} counted kernel launches went to the "
                f"capture's streams and {audit.strays} to another")
        if not others:
            def replay():
                with torch.cuda.device(device):
                    graph.replay()

            return replay
        ready = [torch.cuda.Event() for _ in others]
        finished = torch.cuda.Event()

        def replay():
            with torch.cuda.device(device):
                lead = torch.cuda.current_stream(device)
                for d, event in zip(others, ready):
                    event.record(torch.cuda.current_stream(d))
                    lead.wait_event(event)
                graph.replay()
                finished.record(lead)
                for d in others:
                    torch.cuda.current_stream(d).wait_event(finished)

        return replay

    def _build(self, step, s) -> None:
        """Capture the block from a copy of ``s``, which becomes the static
        state. A block that ends on another arrangement of the static
        tensors than it starts from (an odd ``n`` swaps the fused
        direction's two canvases), or whose capture on several cards fails
        as a capture, is marked broken."""
        self.state = _like(s, _copied(_tensors(s)))
        device = s.done.device
        others = _other_devices(s, device)
        chained = []

        def block():
            out = self.state
            for _ in range(self.n):
                out = step(out)
            chained.append(_write_back(_tensors(out),
                                       _tensors(self.state)))

        try:
            with tally() as added:
                replay = self._capture(block, device, others)
        except Exception as e:
            if not others or not _capture_failed(e):
                raise
            warnings.warn(f"a {self.n}-step block on {device} runs "
                          f"eagerly: its capture failed ({e})",
                          RuntimeWarning, stacklevel=2)
            chained.append(False)
            if device.type == "cuda":
                # A launch that strayed ran outside the graph, on the
                # static state: let it end before that state is dropped.
                for d in (device, *others):
                    torch.cuda.synchronize(d)
        finally:
            for name, value in added.items():
                if value:
                    inc(name, -value)
        if not all(chained):
            self.broken, self.state, self.pools = True, None, ()
            return
        self.added = tuple((name, v) for name, v in added.items() if v)
        self.replay = replay
        inc("pcg.drive.graph_captures")

    def _load(self, s) -> bool:
        """Copy ``s`` into the static state where its tensors alias as the
        static ones do and none of them is a static tensor."""
        fields, static = _tensors(s), _tensors(self.state)
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
        for name, value in self.added:
            inc(name, value)
        inc("pcg.drive.graph_replays")
        if self.pools:
            inc("pcg.drive.multi_card_replays")
        return self.state

    def own(self, s):
        """``s`` with every static tensor in it replaced by a copy."""
        if self.state is None:
            return s
        static = {t.data_ptr() for t in _tensors(self.state)}
        return _like(s, _copied(_tensors(s), static))


def _write_back(out, static) -> bool:
    """Copy each tensor of ``out`` that is a new one into its static
    tensor; False where it is another field's static tensor."""
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
