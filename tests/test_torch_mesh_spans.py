"""The mesh's profiler ranges and counters (``parallel.halo``) on the CPU:
a profiled 2×2 solve holds ``mesh.halo``, ``mesh.sum`` and
``mesh.replicate`` ranges, none nested in another of its own name; the
counters match what the shard spec says the exchange and the sums move;
and the ranges change no answer.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.parallel import halo
from poisson_tpu_torch.parallel.fused_sharded import (fused_cg_solve_sharded,
                                                      shard_spec)
from poisson_tpu_torch.parallel.mesh import Mesh, make_solver_mesh

RANGES = ("mesh.halo", "mesh.sum", "mesh.replicate")
COUNTERS = ("mesh.halo_copies", "mesh.halo_bytes", "mesh.sums",
            "mesh.replicas")
P = Problem(M=40, N=60)


@pytest.fixture(autouse=True)
def _quiet_telemetry():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.shutdown()
    obs.metrics.reset()
    yield
    obs.shutdown()
    obs.metrics.reset()
    torch.set_num_threads(saved)


def _cpu_mesh(px, py):
    return make_solver_mesh(["cpu"] * (px * py), grid=(px, py))


def _solve(mesh, check_every=32):
    out = fused_cg_solve_sharded(P, mesh, rhs_gate=1.03,
                                 check_every=check_every)
    return out.w, int(out.iterations)


def _profiled(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, list(prof.profiler.kineto_results.events())


def test_a_profiled_mesh_solve_holds_each_range_unnested():
    (_, k), events = _profiled(lambda: _solve(_cpu_mesh(2, 2), 1))
    for name in RANGES:
        spans = sorted((e.start_ns(), e.end_ns()) for e in events
                       if e.name() == name)
        assert spans, name
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:])), name
    count = lambda name: sum(1 for e in events if e.name() == name)
    # a step: two exchanges (rows, then columns), α's sum and the pair of
    # sums after B, β and α replicated; ζ₀ is one more sum
    assert count("mesh.halo") == 2 * k
    assert count("mesh.sum") == 2 * k + 1
    assert count("mesh.replicate") == 2 * k
    assert not any(e.is_user_annotation() for e in events
                   if e.name() in RANGES)


@pytest.mark.parametrize("grid", [(2, 2), (1, 1)])
def test_the_counters_are_what_the_shard_spec_moves(grid):
    """With ``check_every`` 1 the body runs once an iteration. Each step
    shifts r's owned edge rows (a canvas row each) and columns (the
    canvas's full height) to every neighbour: a shard with a neighbour
    below or above along an axis receives one slice from each."""
    px, py = grid
    _, k = _solve(_cpu_mesh(px, py), 1)
    cv = shard_spec(P, px, py).cv
    row_copies = 2 * (px - 1) * py     # received across the x boundaries
    col_copies = 2 * (py - 1) * px
    assert obs.metrics.get("mesh.halo_copies") == k * (row_copies
                                                       + col_copies)
    assert obs.metrics.get("mesh.halo_bytes") == k * 4 * (
        row_copies * cv.cols + col_copies * cv.rows)
    assert obs.metrics.get("mesh.sums") == 3 * k + 1
    # every shard of a CPU mesh is on the CPU: nothing to replicate
    assert obs.metrics.get("mesh.replicas") == 0
    if grid == (1, 1):
        assert all(obs.metrics.get(n) == 0 for n in
                   ("mesh.halo_copies", "mesh.halo_bytes", "mesh.replicas"))


def test_replicate_counts_the_copies_to_other_devices():
    mesh = Mesh(px=1, py=3, devices=(torch.device("cpu"),
                                      torch.device("meta"),
                                      torch.device("meta")))
    x = torch.tensor(2.0)
    copies = halo.replicate(x, mesh)
    assert copies[0] is x and copies[1] is copies[2]
    assert copies[1].device.type == "meta"
    assert obs.metrics.get("mesh.replicas") == 1


def test_shift_down_and_up_are_one_range_each_and_count_their_copies():
    mesh = _cpu_mesh(2, 1)
    u = [torch.arange(12.0).reshape(3, 4) + 100 * s for s in range(2)]
    _, events = _profiled(lambda: (halo.shift_down(u, mesh, "x", 1, 0),
                                   halo.shift_up(u, mesh, "x", 1, 2)))
    assert sum(1 for e in events if e.name() == "mesh.halo") == 2
    assert obs.metrics.get("mesh.halo_copies") == 2
    assert obs.metrics.get("mesh.halo_bytes") == 2 * 4 * 4
    assert torch.equal(u[1][0], torch.arange(4.0, 8.0))
    assert torch.equal(u[0][2], torch.arange(104.0, 108.0))


def test_mesh_sums_is_one_range_and_counts_each_group():
    mesh = _cpu_mesh(2, 2)
    groups = [[torch.ones(3) * s for s in range(4)],
              [torch.ones(2) * (s + 1) for s in range(4)]]
    out, events = _profiled(lambda: halo.mesh_sums(groups, mesh))
    assert [float(x) for x in out] == [18.0, 20.0]
    assert sum(1 for e in events if e.name() == "mesh.sum") == 1
    assert obs.metrics.get("mesh.sums") == 2


def test_the_mesh_solve_is_bit_for_bit_with_and_without_a_profiler():
    mesh = _cpu_mesh(2, 2)
    w0, k0 = _solve(mesh)
    (w1, k1), _ = _profiled(lambda: _solve(mesh))
    assert k0 == k1
    assert torch.equal(w0, w1)
