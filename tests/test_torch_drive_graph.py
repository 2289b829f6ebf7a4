"""``solvers.pcg.drive`` replaying captured blocks (``solvers.graphs``).

On the CPU there is no CUDA graph: a fake capture stands in for it, which,
as a capture does, leaves the static state as it found it, and whose replay
runs the captured steps. With it the tests pin how ``drive`` splits a solve
into replayed blocks and eager steps, what it counts, and that a marked
fused body gives the eager loop's bits. The tests marked ``card`` compare
the captured solve with the eager loop on a CUDA card and skip without
one. This file imports no JAX, so that the card's tests run where JAX is
not installed::

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_drive_graph.py
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import sys
import threading
import types
from typing import NamedTuple

import pytest
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.ops import _build, fused_cg, launch, resident
from poisson_tpu_torch.solvers import graphs
from poisson_tpu_torch.solvers.pcg import drive

COUNTERS = ("pcg.drive.graph_captures", "pcg.drive.graph_replays",
            "pcg.drive.eager_steps")
FLAGSHIP = Problem(M=800, N=1200)


def counters() -> dict:
    return {name.rsplit(".", 1)[1]: metrics.get(name) for name in COUNTERS}


def moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in counters().items()}


def fake_capture(self, fn, device, others=()):
    """A capture that runs nothing, as on the card: ``fn`` runs once, so
    that the block's shape is found and its counts taken, and the static
    state is put back. The replay runs ``fn`` with the ``obs.metrics``
    counters, launches included, left as they were, as a graph's replay
    calls no wrapper and no Python of the step."""
    static = graphs._tensors(self.state)
    saved = [t.clone() for t in static]
    fn()
    for t, v in zip(static, saved):
        t.copy_(v)

    def replay():
        with metrics.tally() as counted:
            fn()
        for name, value in counted.items():
            metrics.inc(name, -value)

    return replay


@pytest.fixture(autouse=True)
def fresh_canvases():
    """No canvases, and so no marked body or captured block, carried from
    one test to the next."""
    fused_cg._device_canvases.cache_clear()
    yield
    fused_cg._device_canvases.cache_clear()


@pytest.fixture
def fake_graphs(monkeypatch):
    monkeypatch.setattr(graphs.Block, "_capture", fake_capture)


# --- a counting step ---------------------------------------------------------


class Toy(NamedTuple):
    k: torch.Tensor
    done: torch.Tensor
    x: torch.Tensor
    z: torch.Tensor     # x itself, except in a state not yet in shape


def toy_state(z_is_x: bool = True) -> Toy:
    x = torch.zeros(4)
    return Toy(k=torch.zeros((), dtype=torch.int32),
               done=torch.zeros((), dtype=torch.bool), x=x,
               z=x if z_is_x else torch.ones(4))


_toys = itertools.count()


def launches(step) -> int:
    """The launches a toy step counted, on its own counter."""
    return metrics.get(step.counter)


def toy_step(stop: int, mark: bool = True):
    """k += 1 and x = z + 1 until k reaches ``stop``, a frozen state after;
    one launch a step, counted on the step's own ``obs.metrics`` counter,
    one tap a block."""
    def step(s: Toy) -> Toy:
        metrics.inc(step.counter)
        live = ~s.done
        k = s.k + live.to(torch.int32)
        x = torch.where(live, s.z + 1, s.x)
        return Toy(k=k, done=s.done | (k >= stop), x=x, z=x)

    def flush():
        step.flushes += 1

    step.counter = f"test.toy_launches.{next(_toys)}"
    step.flushes, step.flush = 0, flush
    if mark:
        step.capturable = graphs.Capturable()
    return step


@pytest.fixture
def done_reads(monkeypatch):
    """The reads of ``done``: ``drive``'s calls of ``torch.all``."""
    calls = []
    real = torch.all

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(torch, "all", counted)
    return calls


def test_blocks_replay_and_the_tail_runs_eagerly(fake_graphs, done_reads):
    step = toy_step(stop=10 ** 6)
    before = counters()
    s = drive(step, toy_state(), cap=100, check_every=32)
    # First sight: one eager block, then a capture and two replays, and an
    # eager tail of 100 mod 32 = 4 steps; one read of done and one flush a
    # block.
    assert int(s.k) == 100 and torch.equal(s.x, torch.full((4,), 100.0))
    assert moved(before) == {"graph_captures": 1, "graph_replays": 2,
                             "eager_steps": 36}
    assert len(done_reads) == 4 and step.flushes == 4
    assert launches(step) == 100
    # The block is cached: a new state replays from its first step.
    before = counters()
    t = drive(step, toy_state(), cap=100, check_every=32)
    assert int(t.k) == 100
    assert moved(before) == {"graph_captures": 0, "graph_replays": 3,
                             "eager_steps": 4}
    assert len(done_reads) == 8 and step.flushes == 8
    assert launches(step) == 200


def test_a_done_state_stops_at_the_block_that_saw_it(fake_graphs,
                                                     done_reads):
    step = toy_step(stop=40)
    before = counters()
    s = drive(step, toy_state(), cap=1000, check_every=32)
    assert int(s.k) == 40 and bool(s.done)
    assert moved(before) == {"graph_captures": 1, "graph_replays": 1,
                             "eager_steps": 32}
    assert len(done_reads) == 2 and launches(step) == 64


def test_a_state_out_of_shape_runs_eagerly_until_it_fits(fake_graphs):
    step = toy_step(stop=10 ** 6)
    drive(step, toy_state(), cap=64, check_every=32)       # captured
    before = counters()
    # z is not x: the first block runs eagerly, which makes z x again.
    s = drive(step, toy_state(z_is_x=False), cap=96, check_every=32)
    assert moved(before) == {"graph_captures": 0, "graph_replays": 2,
                             "eager_steps": 32}
    assert int(s.k) == 96 and torch.equal(s.x, torch.full((4,), 97.0))


def test_the_returned_state_owns_its_tensors(fake_graphs):
    step = toy_step(stop=10 ** 6)
    first = drive(step, toy_state(), cap=64, check_every=32)
    kept = first.x.clone()
    second = drive(step, toy_state(), cap=96, check_every=32)
    static = {t.data_ptr() for t in step.capturable.blocks[32].state}
    for s in (first, second):
        assert not {t.data_ptr() for t in s} & static
        assert s.z is s.x
    assert torch.equal(first.x, kept)
    assert int(second.k) == 96


class Swap(NamedTuple):
    k: torch.Tensor
    done: torch.Tensor
    p: torch.Tensor
    spare: torch.Tensor


class Handle(NamedTuple):
    cuda_stream: int


def test_a_capture_whose_launches_miss_its_stream_is_refused(monkeypatch):
    """A counted launch to another stream than the capture's (that of a
    card other than the one captured on, say) runs once, outside the
    graph, and its replays would miss it: such a capture is refused. One
    with no counted launch (kernel R's plain version) is not."""
    for name, fake in (("CUDAGraph", lambda: None),
                       ("device", lambda d: contextlib.nullcontext()),
                       ("Stream", lambda d: Handle(1)),
                       ("graph", lambda *a, **kw: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    current = {}
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: Handle(current[d]))
    dev = torch.device("cuda", 1)
    block = graphs.Block(32)
    counted = lambda: launch.launch_stream(dev)
    current[dev] = 1                    # the capture's stream
    assert callable(block._capture(counted, dev))
    current[dev] = 2                    # the card's own stream
    with pytest.raises(launch.CaptureRefused,
                       match="0 counted .* and 1 to another"):
        block._capture(counted, dev)
    assert callable(block._capture(lambda: None, dev))
    assert launch.launch_stream(dev) == 2   # outside a capture: no note
    assert launch.audit.streams is None


def test_a_block_that_swaps_its_canvases_is_never_replayed(fake_graphs):
    """An odd block ends with the two canvases swapped, which no replay
    can chain: every step runs eagerly, and right."""
    def step(s: Swap) -> Swap:
        s.spare.copy_(s.p + 1)
        return Swap(k=s.k + 1, done=s.done, p=s.spare, spare=s.p)

    step.capturable = graphs.Capturable()
    start = lambda: Swap(torch.zeros((), dtype=torch.int32),
                         torch.zeros((), dtype=torch.bool), torch.zeros(3),
                         torch.zeros(3))
    before = counters()
    for _ in range(2):
        s = drive(step, start(), cap=9, check_every=3)
        assert int(s.k) == 9 and torch.equal(s.p, torch.full((3,), 9.0))
    assert moved(before) == {"graph_captures": 0, "graph_replays": 0,
                             "eager_steps": 18}


CAPTURE_ERRORS = {
    "cuda": RuntimeError("CUDA error: operation not permitted when stream "
                         "is capturing"),
    "invalidated": RuntimeError("CUDA error: operation failed due to a "
                                "previous error during capture"),
    "refused": launch.CaptureRefused("capture of a 32-step block: 0 counted "
                                     "kernel launches went to the capture's "
                                     "streams and 1 to another"),
}


def failing_capture(monkeypatch, error, cards: int):
    """Captures of a state that spans ``cards`` cards, each raising
    ``error``; returns the devices each attempt was made on."""
    attempts = []

    def failing(self, fn, device, others=()):
        attempts.append((device, *others))
        raise error

    monkeypatch.setattr(graphs.Block, "_capture", failing)
    monkeypatch.setattr(graphs, "_other_devices", lambda s, device: [
        torch.device("cuda", i) for i in range(1, cards)])
    return attempts


def test_a_capture_that_fails_leaves_the_block_to_the_eager_loop(
        monkeypatch):
    """A capture across several cards that fails as a capture (each error
    of ``CAPTURE_ERRORS``) marks its block broken: the solve goes on
    eagerly, counted as such, and ends right; no later solve tries to
    capture it again."""
    for error in CAPTURE_ERRORS.values():
        attempts = failing_capture(monkeypatch, error, cards=4)
        step = toy_step(stop=10 ** 6)
        before = counters()
        for _ in range(2):
            with pytest.warns(RuntimeWarning, match="capture failed") \
                    if not attempts else contextlib.nullcontext():
                s = drive(step, toy_state(), cap=100, check_every=32)
            assert int(s.k) == 100
            assert torch.equal(s.x, torch.full((4,), 100.0))
        assert moved(before) == {"graph_captures": 0, "graph_replays": 0,
                                 "eager_steps": 200}
        assert len(attempts) == 1 and len(attempts[0]) == 4
        block = step.capturable.blocks[32]
        assert block.broken and block.state is None
        assert launches(step) == 200


@pytest.mark.parametrize("cards, error", [
    *((1, e) for e in CAPTURE_ERRORS.values()),
    (4, RuntimeError("index 7 is out of bounds for dimension 0")),
    (4, ValueError("a fault in the step's own Python")),
], ids=[*(f"one-device-{k}" for k in CAPTURE_ERRORS), "cards-runtime",
        "cards-value"])
def test_any_other_failed_capture_propagates(monkeypatch, cards, error):
    """A capture on one device that fails, as before several cards could
    be captured, and one across cards that fails for another reason than
    the capture (a fault in the step, which its eager loop would meet
    too) raise out of ``drive``: the block is not marked broken, and
    nothing runs eagerly in the fault's place."""
    attempts = failing_capture(monkeypatch, error, cards)
    step = toy_step(stop=10 ** 6)
    before = counters()
    with pytest.raises(type(error), match=str(error)[:12]):
        drive(step, toy_state(), cap=100, check_every=32)
    assert len(attempts) == 1 and len(attempts[0]) == cards
    assert moved(before) == {"graph_captures": 0, "graph_replays": 0,
                             "eager_steps": 32}
    assert not step.capturable.blocks[32].broken


def test_a_replay_adds_what_the_capturing_thread_counted(monkeypatch):
    """A replay adds to each ``obs.metrics`` counter what its capture added
    on the capturing thread, and nothing that another thread added while
    the capture ran: the counter reads what the eager loop and the other
    thread added, once each."""
    name = "test.toy_steps"

    def beside_another_thread(self, fn, device, others=()):
        other = threading.Thread(target=metrics.inc, args=(name, 1000))
        other.start()
        other.join()
        return fake_capture(self, fn, device, others)

    monkeypatch.setattr(graphs.Block, "_capture", beside_another_thread)
    inner = toy_step(stop=10 ** 6)

    def step(s):
        metrics.inc(name)
        return inner(s)

    step.capturable = inner.capturable
    start = metrics.get(name)
    before = counters()
    s = drive(step, toy_state(), cap=100, check_every=32)
    assert int(s.k) == 100
    assert moved(before) == {"graph_captures": 1, "graph_replays": 2,
                             "eager_steps": 36}
    assert metrics.get(name) - start == 100 + 1000


def test_a_replay_re_adds_its_captured_launches_through_tally_alone(
        fake_graphs, monkeypatch):
    """A launch through ``ops.launch`` counts on ``ops.launches.<key>``:
    the capture of a block takes its launches back and each replay adds
    them again, as every other counter, by the capture's tally. The count
    reads the eager loop's, and the block keeps no launch count of its
    own."""
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d: Handle(1))
    calls = []
    lib = types.SimpleNamespace(toy_launch=lambda *a: calls.append(a) or 0)
    kernels = _build.Kernels(name="toy", lib=lib, path=None,
                             build_seconds=0.0, log="")
    inner = toy_step(stop=10 ** 6)

    def step(s):
        launch.launch(kernels, "toy_launch", "serial_sum",
                      torch.device("cpu"), 7)
        return inner(s)

    step.capturable = graphs.Capturable()
    launch.reset_launch_counts()
    s = drive(step, toy_state(), cap=100, check_every=32)
    assert int(s.k) == 100
    # The eager block, the capture, two replays run by the fake, the tail.
    assert len(calls) == 32 + 32 + 2 * 32 + 4
    assert calls[0] == (7, 0, 1)      # the arguments, the card, the stream
    assert launch.launch_counts() == {**dict.fromkeys(launch.launch_counts(),
                                                      0), "serial_sum": 100}
    block = step.capturable.blocks[32]
    assert ("ops.launches.serial_sum", 32) in block.added
    assert not any("launch" in name for name in vars(block))


def test_an_unmarked_step_runs_the_plain_loop(fake_graphs, done_reads):
    step = toy_step(stop=10 ** 6, mark=False)
    before = counters()
    s = drive(step, toy_state(), cap=100, check_every=32)
    assert int(s.k) == 100 and s.z is s.x
    assert moved(before) == dict.fromkeys(before, 0)
    assert len(done_reads) == 4 and step.flushes == 4
    assert launches(step) == 100


def test_threads_never_replay_one_block_at_once(fake_graphs):
    """Threads driving one marked step: one holds the block, the others
    run eagerly; every solve ends right."""
    step = toy_step(stop=10 ** 6)
    drive(step, toy_state(), cap=64, check_every=32)
    results, errors = [], []

    def work():
        try:
            for _ in range(4):
                s = drive(step, toy_state(), cap=100, check_every=32)
                results.append((int(s.k), s.x.tolist()))
        except Exception as e:          # pragma: no cover - reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        before = counters()
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert not errors
    assert results == [(100, [100.0] * 4)] * 32
    got = moved(before)
    assert got["graph_captures"] == 0
    assert got["graph_replays"] * 32 + got["eager_steps"] == 32 * 100


# --- the fused body ----------------------------------------------------------


def test_the_fused_body_is_marked_on_a_card_only():
    p = Problem(M=40, N=40)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, "cpu")
    body = fused_cg._make_fused_body(p, cv, cs, cw, g, sc2)
    assert not hasattr(body, "capturable")
    before = counters()
    r = fused_cg.fused_cg_solve(p, device="cpu")
    assert int(r.iterations) == 50
    assert moved(before) == dict.fromkeys(before, 0)
    assert fused_cg._device_canvases(p, cv, cs.device)[1] == {}


@pytest.fixture
def marked(monkeypatch, fake_graphs):
    """``use(True)``: fused bodies on the CPU marked and cached as on a
    card, and captured by the fake."""
    def use(on: bool):
        monkeypatch.setattr(fused_cg, "can_capture", lambda device: on)

    return use


def test_the_marked_body_is_cached_with_its_canvases(marked):
    p = Problem(M=40, N=40)
    marked(True)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, "cpu")
    body = fused_cg._make_fused_body(p, cv, cs, cw, g, sc2)
    assert isinstance(body.capturable, graphs.Capturable)
    assert fused_cg._make_fused_body(p, cv, cs, cw, g, sc2) is body
    run = fused_cg.fused_run(p, cv, True)
    serial_body = fused_cg._make_fused_body(p, cv, cs, cw, g, sc2, run=run)
    assert serial_body is not body and serial_body.capturable
    # Canvases the cache does not hold: an unmarked body of their own.
    other = fused_cg._make_fused_body(p, cv, cs.clone(), cw, g, sc2)
    assert other is not body and not hasattr(other, "capturable")
    # One capture serves the solves of new right-hand sides.
    before = counters()
    for a in (1.0, 0.95, 1.05):
        s = fused_cg._fused_solve(p, cv, cs, cw, g, rhs * a, sc2, 8)
        assert int(s.k) == 50
    got = moved(before)
    assert got["graph_captures"] == 1 and got["graph_replays"] >= 12


@pytest.mark.parametrize("M, N, kw", [(40, 40, {}),
                                      (40, 40, {"serial": True}),
                                      (40, 300, {"bn": 128})])
def test_a_marked_fused_solve_is_the_eager_solve(marked, M, N, kw):
    p = Problem(M=M, N=N)
    eager = fused_cg.fused_cg_solve(p, device="cpu", check_every=8, **kw)
    marked(True)
    before = counters()
    got = fused_cg.fused_cg_solve(p, device="cpu", check_every=8, **kw)
    assert int(got.iterations) == int(eager.iterations)
    assert torch.equal(got.w, eager.w) and torch.equal(got.diff, eager.diff)
    assert moved(before)["graph_replays"] >= 1


def test_marked_chunks_and_a_resume_are_the_one_shot_solve(marked,
                                                           tmp_path):
    """Chunks of 45 steps in blocks of 8, and a resumed file whose first
    state has z != r: the one-shot eager solve's bits."""
    p = Problem(M=40, N=40)
    one = fused_cg.fused_cg_solve(p, device="cpu")
    marked(True)
    path = str(tmp_path / "ck.npz")
    chunked = fused_cg.fused_cg_solve_checkpointed(
        p, path, chunk=45, device="cpu", check_every=8)
    part = fused_cg.fused_cg_solve_checkpointed(
        dataclasses.replace(p, max_iter=23), path, chunk=45, device="cpu",
        keep_checkpoint=True, check_every=8)
    assert int(part.iterations) == 23
    before = counters()
    resumed = fused_cg.fused_cg_solve_checkpointed(
        p, path, chunk=45, device="cpu", check_every=8)
    for r in (chunked, resumed):
        assert int(r.iterations) == int(one.iterations) == 50
        assert torch.equal(r.w, one.w)
    got = moved(before)
    assert got["graph_replays"] >= 1 and got["eager_steps"] >= 8


def test_the_resident_plain_solve_runs_the_marked_body(marked):
    p = Problem(M=40, N=40)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, "cpu")
    eager = resident.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2, 8)
    marked(True)
    got = resident.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, eager))


# --- on the card -------------------------------------------------------------


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the captured blocks run on a "
                    "card only")
    return torch.device("cuda", 0)


@pytest.fixture
def eager_loop(monkeypatch):
    """``use(True)``: every fused body unmarked, so ``drive`` runs today's
    eager loop on the card; ``use(False)``: the bodies as they are."""
    def use(on: bool):
        monkeypatch.setattr(fused_cg, "can_capture",
                            lambda device: not on and device.type == "cuda")

    return use


def driven_steps(k: int, cap: int, every: int = 32) -> int:
    return min(cap, -(-k // every) * every)


@pytest.mark.card
def test_card_a_solve_on_the_second_card_is_captured_there(card,
                                                         eager_loop):
    """A solve on a card that is not the current one: the block is
    captured and replayed on its own card, bit for bit with the eager
    loop there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("fewer than two CUDA cards visible: a solve on a card "
                    "other than the current one needs a second card")
    dev = torch.device("cuda", 1)
    assert torch.cuda.current_device() == 0
    eager_loop(True)
    eager = fused_cg.fused_cg_solve(FLAGSHIP, device=dev)
    eager_loop(False)
    fused_cg.fused_cg_solve(FLAGSHIP, device=dev)        # captures
    before = counters()
    got = fused_cg.fused_cg_solve(FLAGSHIP, device=dev)
    steps = driven_steps(int(got.iterations), FLAGSHIP.iteration_cap)
    assert int(got.iterations) == int(eager.iterations) == 989
    assert got.w.device == dev and torch.equal(got.w, eager.w)
    assert moved(before) == {"graph_captures": 0,
                             "graph_replays": steps // 32,
                             "eager_steps": 0}


@pytest.mark.card
def test_card_body_is_marked(card):
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(FLAGSHIP, card)
    body = fused_cg._make_fused_body(FLAGSHIP, cv, cs, cw, g, sc2)
    assert isinstance(body.capturable, graphs.Capturable)


@pytest.mark.card
@pytest.mark.parametrize("kw", [{}, {"serial": True}, {"bn": 256}],
                         ids=["full-width", "serial", "blocked"])
def test_card_captured_solve_is_the_eager_solve(card, eager_loop, kw):
    eager_loop(True)
    eager = fused_cg.fused_cg_solve(FLAGSHIP, device=card, **kw)
    eager_loop(False)
    fused_cg.fused_cg_solve(FLAGSHIP, device=card, **kw)     # captures
    launch.reset_launch_counts()
    before = counters()
    got = fused_cg.fused_cg_solve(FLAGSHIP, device=card, **kw)
    k = int(got.iterations)
    assert k == int(eager.iterations) == 989
    assert torch.equal(got.w, eager.w)
    steps = driven_steps(k, FLAGSHIP.iteration_cap)
    assert moved(before) == {"graph_captures": 0,
                             "graph_replays": steps // 32,
                             "eager_steps": 0}
    counts = launch.launch_counts("direction_and_stencil", "fused_update")
    form = "_blocked" if "bn" in kw else ""
    assert counts[f"direction_and_stencil{form}"] == steps
    assert counts[f"fused_update{form}"] == steps
    assert sum(counts.values()) == 2 * steps
    assert launch.launch_counts("serial_sum") == {
        "serial_sum": 2 * steps if kw.get("serial") else 0}


@pytest.mark.card
def test_card_checkpointed_chunks_of_45(card, eager_loop, tmp_path):
    eager_loop(True)
    one = fused_cg.fused_cg_solve(FLAGSHIP, device=card)
    eager_loop(False)
    path = str(tmp_path / "ck.npz")
    chunked = fused_cg.fused_cg_solve_checkpointed(FLAGSHIP, path, chunk=45,
                                                   device=card)
    fused_cg.fused_cg_solve_checkpointed(
        dataclasses.replace(FLAGSHIP, max_iter=300), path, chunk=45,
        device=card, keep_checkpoint=True)
    resumed = fused_cg.fused_cg_solve_checkpointed(FLAGSHIP, path, chunk=45,
                                                   device=card)
    for r in (chunked, resumed):
        assert int(r.iterations) == 989
        assert torch.equal(r.w, one.w)


@pytest.mark.card
def test_card_one_capture_serves_new_right_hand_sides(card, eager_loop):
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(FLAGSHIP, card)
    gates = (1.0, 0.95, 1.05)
    eager_loop(True)
    eager = [fused_cg._fused_solve(FLAGSHIP, cv, cs, cw, g, rhs * a, sc2)
             for a in gates]
    eager_loop(False)
    before = counters()
    got = []
    for a in gates:
        s = fused_cg._fused_solve(FLAGSHIP, cv, cs, cw, g, rhs * a, sc2)
        got.append((s, s.w.clone()))
    assert moved(before)["graph_captures"] == 1
    for (s, kept), e in zip(got, eager):
        assert int(s.k) == int(e.k)
        assert torch.equal(s.w, e.w)
        assert torch.equal(s.w, kept)     # no later solve wrote into it


@pytest.mark.card
def test_card_resident_plain_solve_is_the_eager_one(card, eager_loop):
    p = Problem(M=400, N=600)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, card)
    eager_loop(True)
    eager = resident.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2)
    eager_loop(False)
    before = counters()
    got = resident.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2)
    assert int(got[1]) == int(eager[1]) == 546
    assert all(torch.equal(a, b) for a, b in zip(got, eager))
    assert moved(before)["graph_replays"] >= 1
