"""The hot path's profiler ranges (``obs.profile.region``) on the CPU: what
a ``torch.profiler`` capture of a solve holds, that the ranges never reach
the recorder or the card, that they change no answer, and that a
recorder span under a running profiler lands on the profiler's clock.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import profile as obs_profile
from poisson_tpu_torch.ops.fused_cg import fused_cg_solve_rhs, host_fields64
from poisson_tpu_torch.ops.resident import resident_cg_solve_rhs
from poisson_tpu_torch.solvers.pcg import CHECK_EVERY, drive

ENQUEUE, CHECK = "pcg.drive.enqueue", "pcg.drive.check"
RHS_IN, W_OUT = "stage.rhs_in", "stage.w_out"
ENTRIES = {"fused": fused_cg_solve_rhs, "resident": resident_cg_solve_rhs}


@pytest.fixture(autouse=True)
def _quiet_telemetry():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    obs.shutdown()
    yield
    obs.shutdown()
    torch.set_num_threads(saved)


def _problem_and_rhs(seed=3):
    p = Problem(M=40, N=60)
    rhs64 = host_fields64(p, True)[2]
    noise = np.random.default_rng(seed).standard_normal(p.grid_shape)
    return p, rhs64 * (1.0 + 0.1 * noise)


def _profiled(fn):
    """``fn()`` under a CPU profiler started with ``.start()``; its result
    and the capture's host events."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, list(prof.profiler.kineto_results.events())


def _count(events, name):
    return sum(1 for e in events if e.name() == name)


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_a_profiled_solve_holds_its_ranges(entry):
    p, rhs = _problem_and_rhs()
    (w, k), events = _profiled(lambda: ENTRIES[entry](p, rhs, device="cpu"))
    assert k > CHECK_EVERY
    # On the CPU kernel R's plain version is driven like the fused loop;
    # on a card R is one launch and makes neither range.
    blocks = math.ceil(k / CHECK_EVERY)
    assert _count(events, ENQUEUE) == blocks
    assert _count(events, CHECK) == blocks
    assert _count(events, RHS_IN) == 1 and _count(events, W_OUT) == 1


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_no_range_is_a_user_annotation(entry):
    p, rhs = _problem_and_rhs()
    _, events = _profiled(lambda: ENTRIES[entry](p, rhs, device="cpu"))
    ours = [e for e in events if e.name() in (ENQUEUE, CHECK, RHS_IN, W_OUT)]
    assert ours
    assert not any(e.is_user_annotation() for e in events)


def test_ranges_nest_the_steps_and_the_read_of_done():
    """Each block's steps fall inside its enqueue range, and the read of
    ``done`` inside the check range that follows."""
    p, rhs = _problem_and_rhs()
    _, events = _profiled(lambda: fused_cg_solve_rhs(p, rhs, device="cpu"))
    enq = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.name() == ENQUEUE)
    chk = sorted((e.start_ns(), e.end_ns()) for e in events
                 if e.name() == CHECK)
    for (s0, s1), (c0, c1) in zip(enq, chk):
        assert s1 <= c0 <= c1
    reads = [e for e in events if e.name() == "aten::all"]
    assert reads and all(any(c0 <= e.start_ns() and e.end_ns() <= c1
                             for c0, c1 in chk) for e in reads)


@pytest.mark.parametrize("cap,done_at,blocks", [
    (70, None, 3),     # capped: 32 + 32 + 6 steps
    (500, 40, 2),      # done inside the second block
    (500, 32, 1),      # done on the block's last step
])
def test_drive_makes_one_pair_of_ranges_a_block(cap, done_at, blocks):
    class S(tuple):
        @property
        def done(self):
            return self[1]

    def step(s):
        k = s[0] + 1
        return S((k, torch.tensor(done_at is not None and k >= done_at)))

    s0 = S((0, torch.tensor(False)))
    _, events = _profiled(lambda: drive(step, s0, cap))
    assert _count(events, ENQUEUE) == blocks
    assert _count(events, CHECK) == blocks


@pytest.mark.parametrize("entry", sorted(ENTRIES))
def test_answers_are_bit_for_bit_with_and_without_a_profiler(entry):
    p, rhs = _problem_and_rhs(seed=11)
    w0, k0 = ENTRIES[entry](p, rhs, device="cpu")
    (w1, k1), _ = _profiled(lambda: ENTRIES[entry](p, rhs, device="cpu"))
    assert k0 == k1
    assert np.array_equal(w0, w1)


@pytest.mark.parametrize("profiled", [False, True])
def test_a_solve_leaves_the_recorder_untouched(profiled):
    p, rhs = _problem_and_rhs()
    solve = lambda: fused_cg_solve_rhs(p, rhs, device="cpu")
    run = (lambda: _profiled(solve)) if profiled else solve
    run()
    assert obs.recorder() is None and obs.recent_events() == []
    rec = obs.configure()
    run()
    assert rec.recent_events() == [] and rec.trace_events() == []


def test_region_is_one_shared_null_context_with_no_profiler():
    a, b = obs_profile.region(ENQUEUE), obs_profile.region(RHS_IN)
    assert a is b
    with a:
        pass
    (c, d), _ = _profiled(lambda: (obs_profile.region(ENQUEUE),
                                   obs_profile.region(ENQUEUE)))
    assert c is not a and c is not d


@pytest.mark.parametrize("fence", [False, True])
def test_a_recorder_span_joins_the_profilers_clock(fence):
    rec = obs.configure()

    def spans():
        with obs.span("bench.solve", fence=fence, device="cpu"):
            torch.ones(8).sum()

    _, events = _profiled(spans)
    ranges = [e for e in events if e.name() == "bench.solve"]
    assert len(ranges) == 1 and not ranges[0].is_user_annotation()
    (ev,) = [e for e in rec.trace_events() if e["name"] == "bench.solve"]
    assert abs(ev["ts"] - ranges[0].start_ns() / 1e3) < 1000.0
    assert ranges[0].duration_ns() / 1e3 <= ev["dur"] + 1000.0
    # the span's records are the recorder's own, unchanged in shape
    kinds = [e["kind"] for e in rec.recent_events()]
    assert kinds == ["span_begin", "span_end"]

