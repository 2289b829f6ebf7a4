"""Port parity: lane stepping (``poisson_tpu_torch.solvers.lanes``) against
``poisson_tpu.solvers.lanes``, on the CPU.

The cases follow the reference's (``tests/test_refill.py:38-115``): any
seeded retire/splice interleaving keeps every member's identity, and each
retired member equals its solo ``pcg_solve`` bit for bit in the port. The
same schedule driven through both packages side by side gives the same
counts and flags at every step; the iterates of the port's members lie
within 1e-6 of JAX's fp64 solo solves (fp32 state). A lane table carried
across packages mid-flight (``interop.batched_state_*``) finishes with the
counts of the one that stayed.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import lanes as jax_lanes
from poisson_tpu.solvers.pcg import PCGState as JaxState
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch import interop
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.solvers.lanes import LaneBatch
from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve

PROBLEM, JAX_PROBLEM = Problem(M=32, N=32), JaxProblem(M=32, N=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
    jax_metrics.reset()


def _lanes(**kw):
    return LaneBatch(PROBLEM, device="cpu", **kw)


def _retire_done(lb, results):
    for view in lb.lane_view():
        if view["member_id"] is not None and view["done"]:
            res = lb.retire(view["lane"])
            assert res.member_id == view["member_id"]
            results[res.member_id] = res


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_interleaving_matches_jax_and_solo_solves(seed):
    """One seeded schedule of splices (whenever a lane is free, with
    random reluctance) and retires (whenever a lane is done), driven
    through both packages in step: the lane views agree at every step, no
    member sits in two lanes, every retired result carries its id, and
    each equals the port's solo solve bit for bit."""
    rng = random.Random(seed)
    gates = {f"req-{i}": 1.0 + i / 7 for i in range(8)}
    chunk = rng.choice([3, 7, 11])
    lb = _lanes(bucket=3, dtype="float32", chunk=chunk)
    jlb = jax_lanes.LaneBatch(JAX_PROBLEM, bucket=3, dtype=jnp.float32,
                              chunk=chunk)
    queue = list(gates)
    results, jresults = {}, {}
    for _ in range(2000):
        if len(results) == len(gates):
            break
        _retire_done(lb, results)
        _retire_done(jlb, jresults)
        while queue and lb.free_lanes() and rng.random() < 0.7:
            mid = queue.pop(0)
            assert lb.splice(mid, gates[mid]) == jlb.splice(mid, gates[mid])
        occupied = [m for m in lb.origin if m is not None]
        assert len(occupied) == len(set(occupied))
        assert lb.step() == jlb.step()
        view = [{k: v[k] for k in ("member_id", "k", "done", "flag")}
                for v in lb.lane_view()]
        assert view == [{k: v[k] for k in ("member_id", "k", "done",
                                             "flag")}
                        for v in jlb.lane_view()]
    assert len(results) == len(gates), "schedule did not drain"
    for mid, res in results.items():
        solo = pcg_solve(PROBLEM, dtype="float32", rhs_gate=gates[mid],
                         device="cpu")
        assert res.iterations == int(solo.iterations) \
            == jresults[mid].iterations
        assert res.flag == int(solo.flag) == FLAG_CONVERGED
        assert torch.equal(res.w, solo.w), f"member {mid} drifted"
        ref64 = jax_pcg_solve(JAX_PROBLEM, dtype=jnp.float64,
                              rhs_gate=gates[mid])
        np.testing.assert_allclose(res.w.double().numpy(),
                                   np.asarray(ref64.w), rtol=0, atol=1e-6)


def test_mid_flight_splice_does_not_perturb_the_resident_member():
    lb = _lanes(bucket=2, dtype="float32", chunk=10)
    lb.splice("early", 1.0)
    lb.step()
    lb.step()                       # "early" is 20 iterations in
    lb.splice("late", 1.5)
    results = {}
    for _ in range(50):
        lb.step()
        _retire_done(lb, results)
        if not lb.occupied():
            break
    for mid, gate in (("early", 1.0), ("late", 1.5)):
        ref = pcg_solve(PROBLEM, dtype="float32", rhs_gate=gate,
                        device="cpu")
        assert results[mid].iterations == int(ref.iterations)
        assert torch.equal(results[mid].w, ref.w)


def test_step_budget_is_per_lane_not_global():
    lb = _lanes(bucket=2, dtype="float32", chunk=10)
    lb.splice("a", 1.0)
    lb.step()
    lb.splice("b", 1.2)
    lb.step()
    view = {v["member_id"]: v for v in lb.lane_view()}
    assert view["a"]["k"] == 20
    assert view["b"]["k"] == 10


def test_lane_occupancy_errors():
    lb = _lanes(bucket=2, dtype="float32")
    lb.splice("a", 1.0, lane=0)
    with pytest.raises(ValueError, match="already occupies"):
        lb.splice("a", 1.0)
    with pytest.raises(ValueError, match="ACTIVE"):
        lb.splice("b", 1.0, lane=0)
    with pytest.raises(ValueError, match="None"):
        lb.splice(None, 1.0)
    lb.splice("b", 1.0)
    with pytest.raises(ValueError, match="no EMPTY lane"):
        lb.splice("c", 1.0)
    lb.retire(0)
    with pytest.raises(ValueError, match="already EMPTY"):
        lb.retire(0)
    assert lb.free_lanes() == [0] and lb.active_lanes() == [1]


def test_empty_table_does_not_step_and_steps_are_counted():
    lb = _lanes(bucket=3, dtype="float32", chunk=5)
    assert lb.step() == {"active": 0, "idle": 3} and lb.steps == 0
    lb.splice("a", 1.0)
    assert lb.step() == {"active": 1, "idle": 2}
    assert lb.steps == 1 and lb.idle_lane_steps == 2
    views = lb.lane_view()
    assert [v["k"] for v in views] == [5, 0, 0]
    assert [v["done"] for v in views] == [False, True, True]


def _drain(lb, results):
    for _ in range(500):
        if not lb.occupied():
            return
        lb.step()
        _retire_done(lb, results)
    raise AssertionError("lanes did not drain")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_state_carried_across_packages_finishes_with_the_same_counts(dtype):
    """A lane table run two chunks in JAX, carried to the port and
    finished there, gives the counts of the table finished in JAX; and
    the reverse, port first, then JAX."""
    gates = {"a": 1.0, "b": 2.5, "c": 0.5}
    jdt = getattr(jnp, dtype)

    def jax_table():
        t = jax_lanes.LaneBatch(JAX_PROBLEM, bucket=4, dtype=jdt, chunk=9)
        for mid, g in gates.items():
            t.splice(mid, g)
        return t

    stayed, carried = jax_table(), jax_table()
    for t in (stayed, carried):
        t.step()
        t.step()
    port = _lanes(bucket=4, dtype=dtype, chunk=9)
    port.state = interop.batched_state_from_reference(
        carried.state._asdict(), device="cpu")
    port.origin = list(carried.origin)
    assert [v["k"] for v in port.lane_view()] == [18, 18, 18, 0]
    want, got = {}, {}
    _drain(stayed, want)
    _drain(port, got)
    assert {m: r.iterations for m, r in got.items()} == \
        {m: r.iterations for m, r in want.items()}
    assert {r.flag for r in got.values()} == {FLAG_CONVERGED}

    # The reverse: the port first, JAX to finish.
    first = _lanes(bucket=4, dtype=dtype, chunk=9)
    for mid, g in gates.items():
        first.splice(mid, g)
    first.step()
    first.step()
    back = jax_table()
    back.state = JaxState(**{k: jnp.asarray(v) for k, v in
                             interop.batched_state_to_reference(
                                 first.state).items()})
    back.origin = list(first.origin)
    finished = {}
    _drain(back, finished)
    assert {m: r.iterations for m, r in finished.items()} == \
        {m: r.iterations for m, r in want.items()}


@pytest.mark.parametrize("kwargs,item", [
    # MG lanes carry no per-lane geometries, in the JAX package's words.
    (dict(preconditioner="mg", verify_every=5, multi_geometry=True),
     "geometries"),
], ids=["mg"])
def test_unported_options_are_refused_with_their_item(kwargs, item):
    with pytest.raises(ValueError, match=item):
        _lanes(bucket=2, **kwargs)
    if "multi_geometry" in kwargs:
        # A single-geometry table refuses a geometry splice, as JAX's
        # does (poisson_tpu/solvers/lanes.py:432-435).
        with pytest.raises(ValueError, match="built single-geometry; "
                           "construct it with multi_geometry=True"):
            _lanes(bucket=2).splice("a", 1.0, geometry={"type": "ellipse"})
