"""The plain solve's set-up range and counters (``solvers.pcg.solve_fields``)
on the CPU at 40×60: a profiled ``pcg_solve`` holds exactly one
``stage.fields_in`` range, none nested in another of its name, and an
unprofiled one enters none; ``pcg.setup.fields_in`` and
``pcg.setup.fields_in_bytes`` count the call and the bytes of the four
fields copied up in the state's precision; a geometry's canvases are
counted by ``geom.cache.*`` instead; and the range changes no answer.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import profile as obs_profile
from poisson_tpu_torch.solvers import pcg

RANGE = "stage.fields_in"
P = Problem(M=40, N=60)
FIELD_POINTS = 41 * 61


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


def _solve(**kwargs):
    out = pcg.pcg_solve(P, rhs_gate=1.03, device="cpu", **kwargs)
    return out.w, int(out.iterations)


def _profiled(fn):
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    return out, list(prof.profiler.kineto_results.events())


def test_a_profiled_plain_solve_holds_one_fields_in_range_unnested():
    (_, k), events = _profiled(_solve)
    spans = sorted((e.start_ns(), e.end_ns()) for e in events
                   if e.name() == RANGE)
    assert len(spans) == 1
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    # the range holds the copies up, and the loop runs after it
    (start, end), = spans
    enqueues = [e.start_ns() for e in events
                if e.name() == "pcg.drive.enqueue"]
    assert enqueues and min(enqueues) >= end > start
    assert k == 68
    assert not any(e.is_user_annotation() for e in events
                   if e.name() == RANGE)


def test_an_unprofiled_plain_solve_enters_no_range(monkeypatch):
    """With no profiler running, every ``stage.fields_in`` region the
    solve asks for is the shared null context: no range is opened."""
    asked = []

    def spy(name):
        ctx = obs_profile.region(name)
        asked.append((name, ctx))
        return ctx

    monkeypatch.setattr(pcg, "region", spy)
    _solve()
    fields_in = [ctx for name, ctx in asked if name == RANGE]
    assert len(fields_in) == 1
    assert all(ctx is obs_profile._OFF for ctx in fields_in)


@pytest.mark.parametrize("dtype,size", [("float64", 8), ("float32", 4)])
def test_the_counters_are_one_call_and_the_bytes_of_four_fields(dtype,
                                                                size):
    _solve(dtype=dtype)
    assert obs.metrics.get("pcg.setup.fields_in") == 1
    assert obs.metrics.get("pcg.setup.fields_in_bytes") == (
        4 * FIELD_POINTS * size)
    _solve(dtype=dtype)
    assert obs.metrics.get("pcg.setup.fields_in") == 2


def test_a_geometry_solve_counts_its_canvases_not_the_fields_in():
    spec = {"type": "ellipse", "rx": 0.7, "ry": 0.4}
    pcg.pcg_solve(P, device="cpu", geometry=spec)
    assert obs.metrics.get("pcg.setup.fields_in") == 0
    assert obs.metrics.get("pcg.setup.fields_in_bytes") == 0
    assert (obs.metrics.get("geom.cache.misses")
            + obs.metrics.get("geom.cache.hits")) >= 1


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_the_plain_solve_is_bit_for_bit_with_and_without_a_profiler(dtype):
    w0, k0 = _solve(dtype=dtype)
    (w1, k1), _ = _profiled(lambda: _solve(dtype=dtype))
    assert k0 == k1
    assert torch.equal(w0, w1)
