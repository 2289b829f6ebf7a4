"""The sharded fused body (``parallel.fused_sharded``) replayed in captured
blocks (``solvers.graphs``).

On the CPU the fake capture of ``test_torch_drive_graph.py`` stands in for
a CUDA graph: it leaves the static state as it found it, and its replay
runs the captured steps with the launch and mesh counters left as they
were. With it the tests pin how the helpers carry a state whose fields
are tuples of per-shard canvases, and which meshes mark their body. The
tests marked ``card`` compare a replayed mesh solve with the eager one on
CUDA cards (one card holding the whole 2x2 mesh, and every visible card)
and skip without them. This file imports no JAX::

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_mesh_graph.py
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.ops import fused_cg, serial
from poisson_tpu_torch.parallel import fused_sharded as fs
from poisson_tpu_torch.parallel.mesh import Mesh, make_solver_mesh
from poisson_tpu_torch.solvers import graphs
from poisson_tpu_torch.solvers.pcg import drive
from test_torch_drive_graph import fake_capture

MESH_COUNTERS = ("mesh.halo_copies", "mesh.halo_bytes", "mesh.sums",
                 "mesh.replicas")
COUNTERS = ("pcg.drive.graph_captures", "pcg.drive.graph_replays",
            "pcg.drive.multi_card_replays", "pcg.drive.eager_steps",
            *MESH_COUNTERS)
P = Problem(M=40, N=60)


def counters() -> dict:
    return {name: metrics.get(name) for name in COUNTERS}


def moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in counters().items()}


@pytest.fixture(autouse=True)
def fresh_canvases():
    """No shard canvases, and so no marked body or captured block, carried
    from one test to the next."""
    fs._shard_canvases.cache_clear()
    yield
    fs._shard_canvases.cache_clear()


@pytest.fixture
def marked(monkeypatch):
    """Sharded bodies on CPU shards marked and cached as on cards, and
    captured by the fake."""
    monkeypatch.setattr(graphs.Block, "_capture", fake_capture)
    monkeypatch.setattr(fs, "can_capture", lambda device: True)


def cpu_mesh(px: int = 2, py: int = 2) -> Mesh:
    return make_solver_mesh(["cpu"] * (px * py), grid=(px, py))


def solve(mesh, check_every: int = 8, gate=1.03, **kw):
    return fs.fused_cg_solve_sharded(P, mesh, rhs_gate=gate,
                                     check_every=check_every, **kw)


def same(a, b) -> bool:
    """Two results equal bit for bit: the answer, the count, diff, ζ."""
    return (int(a.iterations) == int(b.iterations)
            and all(torch.equal(x, y) for x, y in (
                (a.w, b.w), (a.diff, b.diff),
                (a.residual_dot, b.residual_dot))))


def block_of(mesh, n: int = 8, run=None):
    spec, canvases = fs.shard_canvases(P, mesh, 1)
    body = fs._make_sharded_body(P, spec, mesh, canvases, run)
    return body, body.capturable.block(n)


# --- on the CPU --------------------------------------------------------------


def test_a_cpu_mesh_runs_the_unmarked_body():
    mesh = cpu_mesh()
    spec, canvases = fs.shard_canvases(P, mesh, 1)
    assert not hasattr(fs._make_sharded_body(P, spec, mesh, canvases),
                       "capturable")
    before = counters()
    assert int(solve(mesh).iterations) > 0
    got = moved(before)
    assert got["pcg.drive.graph_replays"] == 0
    assert got["pcg.drive.eager_steps"] == 0    # not even counted as such
    assert fs._shard_canvases(P, mesh, 1)[2] == {}


def test_a_mesh_over_processes_runs_the_unmarked_body(monkeypatch):
    """Over processes the halos and sums go through gloo's host tensors,
    which no graph captures: unmarked, whatever its devices allow."""
    monkeypatch.setattr(fs, "can_capture", lambda device: True)
    mesh = Mesh(px=2, py=2, devices=(torch.device("cpu"),) * 4,
                owners=(0, 0, 1, 1))
    assert mesh.multiprocess
    spec = fs.shard_spec(P, 2, 2)
    canvases = fs.to_shards(fs.host_shard_canvases(P, spec, 2, 2),
                            [torch.device("cpu")] * 4)
    body = fs._make_sharded_body(P, spec, mesh, canvases)
    assert not hasattr(body, "capturable")


def test_the_marked_body_is_cached_with_its_canvases(marked):
    mesh = cpu_mesh()
    spec, canvases = fs.shard_canvases(P, mesh, 1)
    body = fs._make_sharded_body(P, spec, mesh, canvases)
    assert isinstance(body.capturable, graphs.Capturable)
    assert body.capturable.wrappers == (fused_cg.direction_and_stencil,
                                        fused_cg.fused_update,
                                        serial.serial_sum)
    assert fs._make_sharded_body(P, spec, mesh, canvases) is body
    run = fs.shard_run(P, spec, mesh, True)
    serial_body = fs._make_sharded_body(P, spec, mesh, canvases, run)
    assert serial_body is not body and serial_body.capturable
    # Canvases the cache does not hold: an unmarked body of their own.
    other = fs._make_sharded_body(P, spec, mesh, canvases._replace(
        cs=tuple(c.clone() for c in canvases.cs)))
    assert other is not body and not hasattr(other, "capturable")
    # One capture serves every gate.
    before = counters()
    for gate in (1.0, 0.95, 1.05):
        assert int(solve(mesh, gate=gate).iterations) > 0
    got = moved(before)
    assert got["pcg.drive.graph_captures"] == 1
    assert got["pcg.drive.graph_replays"] >= 6


@pytest.mark.parametrize("grid, serial_sums", [((2, 2), None),
                                               ((2, 2), True),
                                               ((1, 3), None)])
def test_a_marked_mesh_solve_is_the_eager_solve(marked, monkeypatch, grid,
                                                serial_sums):
    """Replayed blocks give the eager loop's bits and its mesh counts:
    the counts of a replay are those its capture took back."""
    mesh = cpu_mesh(*grid)
    with monkeypatch.context() as m:
        m.setattr(fs, "can_capture", lambda device: False)
        before = counters()
        eager = solve(mesh, serial=serial_sums)
        eager_counts = moved(before)
    before = counters()
    got = solve(mesh, serial=serial_sums)
    counts = moved(before)
    assert same(got, eager)
    assert counts["pcg.drive.graph_captures"] == 1
    assert counts["pcg.drive.graph_replays"] >= 1
    assert counts["pcg.drive.multi_card_replays"] == 0   # one device
    for name in MESH_COUNTERS:
        assert counts[name] == eager_counts[name], name


def test_the_static_state_keeps_z_as_r_on_every_shard(marked):
    mesh = cpu_mesh()
    _, block = block_of(mesh)
    out = solve(mesh)
    assert int(out.iterations) > 0 and block.replay is not None
    st = block.state
    assert len(st.r) == 4
    assert all(z is r for z, r in zip(st.z, st.r))
    assert graphs._aliasing(graphs._tensors(st)) != tuple(
        range(len(graphs._tensors(st))))


def test_an_odd_block_of_the_mesh_is_never_replayed(marked):
    """An odd block ends with p and spare swapped on every shard, which
    no replay can chain: every step runs eagerly, and right."""
    mesh = cpu_mesh()
    with pytest.MonkeyPatch.context() as m:
        m.setattr(fs, "can_capture", lambda device: False)
        eager = solve(mesh, check_every=3)
    before = counters()
    for _ in range(2):
        assert same(solve(mesh, check_every=3), eager)
    got = moved(before)
    assert got["pcg.drive.graph_captures"] == 0
    assert got["pcg.drive.graph_replays"] == 0
    _, block = block_of(mesh, 3)
    assert block.broken and block.state is None


def test_an_even_block_chains_from_one_replay_to_the_next(marked):
    mesh = cpu_mesh()
    before = counters()
    solve(mesh, check_every=2)
    got = moved(before)
    _, block = block_of(mesh, 2)
    assert not block.broken and block.replay is not None
    assert got["pcg.drive.graph_replays"] >= 10


def _state(mesh):
    spec, canvases = fs.shard_canvases(P, mesh, 1)
    return fs._sharded_init(P, spec, mesh, canvases, canvases.rhs)


def test_load_refuses_a_state_that_aliases_the_static_tensors(marked):
    mesh = cpu_mesh()
    body, block = block_of(mesh)
    drive(body, _state(mesh), 64, 8)
    st = block.state
    fresh = block.own(st)
    assert block._load(fresh)
    # One shard's w is a static canvas: refused, as is a state whose z
    # is not r on one shard.
    assert not block._load(fresh._replace(w=(st.w[0], *fresh.w[1:])))
    assert not block._load(fresh._replace(
        z=(fresh.z[0].clone(), *fresh.z[1:])))
    assert not block._load(fresh._replace(k=st.k))


def test_own_hands_back_tensors_that_share_no_memory_with_the_static_state(
        marked):
    mesh = cpu_mesh()
    body, block = block_of(mesh)
    first = drive(body, _state(mesh), 64, 8)
    kept = [w.clone() for w in first.w]
    second = drive(body, _state(mesh), 96, 8)
    static = {t.data_ptr() for t in graphs._tensors(block.state)}
    for s in (first, second):
        assert not {t.data_ptr() for t in graphs._tensors(s)} & static
        assert all(z is r for z, r in zip(s.z, s.r))
    assert all(torch.equal(a, b) for a, b in zip(first.w, kept))


def test_the_flat_helpers_round_trip_a_sharded_state():
    mesh = cpu_mesh()
    s = _state(mesh)
    flat = graphs._tensors(s)
    assert len(flat) == 5 + 6 * 4     # k, done, zr, β, diff; six fields
    back = graphs._like(s, flat)
    assert type(back) is type(s)
    assert all(a is b for a, b in zip(graphs._tensors(back), flat))
    assert all(isinstance(f, tuple) == isinstance(g, tuple)
               for f, g in zip(back, s))


# --- on the card -------------------------------------------------------------


FLAGSHIP = Problem(M=800, N=1200)


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the captured blocks run on a "
                    "card only")
    current = torch.cuda.current_device()
    yield torch.device("cuda", 0)
    # Each kernel launch makes its shard's card current: put it back, so
    # that a later test finds the card it started on.
    torch.cuda.set_device(current)


def card_mesh(where: str) -> Mesh:
    """The 2x2 mesh on one card, or a mesh over every visible card."""
    if where == "one-card":
        return make_solver_mesh(["cuda:0"] * 4, grid=(2, 2))
    if torch.cuda.device_count() < 2:
        pytest.skip("fewer than two CUDA cards visible: a mesh across "
                    "cards needs two")
    return make_solver_mesh()


@pytest.fixture
def eager_mesh(monkeypatch):
    """``use(True)``: every sharded body unmarked, so ``drive`` runs the
    eager loop; ``use(False)``: the bodies as they are."""
    def use(on: bool):
        monkeypatch.setattr(fs, "can_capture",
                            lambda device: not on and device.type == "cuda")

    return use


def reset_launches() -> None:
    fused_cg.reset_launch_counts()
    serial.reset_launch_counts()


def launches() -> dict:
    return {**fused_cg.launch_counts(), **serial.launch_counts()}


def run_counted(mesh, gate, **kw):
    reset_launches()
    before = counters()
    out = fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=gate, **kw)
    return out, launches(), moved(before)


@pytest.mark.card
@pytest.mark.parametrize("where", ["one-card", "every-card"])
@pytest.mark.parametrize("serial_sums", [None, True],
                         ids=["default", "serial"])
def test_card_replayed_mesh_solve_is_the_eager_solve(card, eager_mesh,
                                                     where, serial_sums):
    mesh = card_mesh(where)
    cards = len(set(mesh.devices))
    eager_mesh(True)
    eager, eager_launches, eager_counts = run_counted(
        mesh, None, serial=serial_sums)
    eager_mesh(False)
    warm, warm_launches, warm_counts = run_counted(mesh, 0.97,
                                                   serial=serial_sums)
    got, got_launches, got_counts = run_counted(mesh, None,
                                                serial=serial_sums)
    k = int(got.iterations)
    assert k == int(eager.iterations) == 989
    assert same(got, eager)
    assert warm_counts["pcg.drive.graph_captures"] == 1
    assert got_counts["pcg.drive.graph_captures"] == 0
    steps = -(-k // 32) * 32
    assert got_counts["pcg.drive.graph_replays"] == steps // 32
    assert got_counts["pcg.drive.eager_steps"] == 0
    assert got_counts["pcg.drive.multi_card_replays"] == (
        steps // 32 if cards > 1 else 0)
    # The same kernels and the same traffic an iteration as the eager loop.
    assert got_launches == eager_launches
    for name in MESH_COUNTERS:
        assert got_counts[name] == eager_counts[name], name
    px, py = mesh.px, mesh.py
    assert got_counts["mesh.halo_copies"] == 2 * steps * (
        (px - 1) * py + (py - 1) * px)
    assert got_counts["mesh.sums"] == (2 if serial_sums else 3) * steps + 1
    assert got_counts["mesh.replicas"] == 2 * steps * (cards - 1)


@pytest.mark.card
@pytest.mark.parametrize("where", ["one-card", "every-card"])
def test_card_a_stray_launch_is_refused_and_the_solve_stays_right(
        card, eager_mesh, monkeypatch, where):
    """A counted launch sent, during the capture, to a stream outside it
    runs once, outside the graph: the capture is refused. Across cards the
    block is left broken and the solve ends right on the eager loop; on
    one card the refusal raises out of the solve, as the one-card fused
    body's does."""
    mesh = card_mesh(where)
    eager_mesh(True)
    eager = fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=1.03)
    eager_mesh(False)
    real = fused_cg.launch_stream
    # High priority: never one of the pooled streams a capture takes.
    outside = {d: torch.cuda.Stream(d, priority=-1)
               for d in set(mesh.devices)}

    def astray(device):
        if getattr(graphs._audit, "streams", None) is None:
            return real(device)
        with torch.cuda.stream(outside[device]):
            return real(device)

    monkeypatch.setattr(fused_cg, "launch_stream", astray)
    before = counters()
    if where == "one-card":
        with pytest.raises(graphs.CaptureRefused, match="to another"):
            fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=1.03)
        torch.cuda.synchronize()
        counts = moved(before)
        assert counts["pcg.drive.graph_captures"] == 0
        assert counts["pcg.drive.graph_replays"] == 0
        return
    with pytest.warns(RuntimeWarning, match="capture failed"):
        got = fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=1.03)
    torch.cuda.synchronize()
    assert same(got, eager)
    counts = moved(before)
    assert counts["pcg.drive.graph_captures"] == 0
    assert counts["pcg.drive.graph_replays"] == 0


@pytest.mark.card
@pytest.mark.parametrize("where", ["one-card", "every-card"])
def test_card_replays_survive_eager_allocations_on_every_card(
        card, eager_mesh, where):
    """Replay, then allocate and write on every card eagerly, then replay
    again: no memory the graph uses went back to a card's general cache,
    so the eager tensors keep their values and the answer its bits."""
    mesh = card_mesh(where)
    eager_mesh(True)
    eager = fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=1.03)
    eager_mesh(False)
    fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=0.97)   # captures
    first = fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=1.03)
    torch.cuda.empty_cache()
    junk = [torch.full((n,), 7.0, device=d)
            for d in dict.fromkeys(mesh.devices)
            for n in (1, 7, 129, 1000, 4096, 1 << 16, 1 << 20)]
    before = counters()
    again = fs.fused_cg_solve_sharded(FLAGSHIP, mesh, rhs_gate=1.03)
    assert moved(before)["pcg.drive.graph_replays"] >= 1
    torch.cuda.synchronize()
    assert same(first, eager) and same(again, eager)
    assert all(bool(torch.all(t == 7.0)) for t in junk)


@pytest.mark.card
@pytest.mark.parametrize("where", ["one-card", "every-card"])
def test_card_checkpointed_mesh_chunks_are_the_one_shot_solve(
        card, eager_mesh, tmp_path, where):
    """Chunks of 200 steps (six replayed blocks and an eager tail of 8),
    and a solve resumed from a file whose first state has z != r: the
    eager one-shot solve's bits."""
    mesh = card_mesh(where)
    eager_mesh(True)
    one = fs.fused_cg_solve_sharded(FLAGSHIP, mesh)
    eager_mesh(False)
    path = str(tmp_path / "ck.npz")
    chunked = fs.fused_cg_solve_sharded_checkpointed(FLAGSHIP, mesh, path,
                                                     chunk=200)
    fs.fused_cg_solve_sharded_checkpointed(
        dataclasses.replace(FLAGSHIP, max_iter=300), mesh, path, chunk=200,
        keep_checkpoint=True)
    before = counters()
    resumed = fs.fused_cg_solve_sharded_checkpointed(FLAGSHIP, mesh, path,
                                                     chunk=200)
    for r in (chunked, resumed):
        assert int(r.iterations) == int(one.iterations) == 989
        assert torch.equal(r.w, one.w)
    assert moved(before)["pcg.drive.graph_replays"] >= 1
