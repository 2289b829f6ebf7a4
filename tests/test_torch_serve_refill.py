"""The port's continuous batching (counterpart of ``tests/test_refill.py``,
on the CPU; -m serve): lane-identity conservation, splice bit parity, and
the refill engine's ledger guarantees.

Any interleaving of retire/splice over a seeded schedule keeps the
``PCGResult.origin`` → request-id mapping exact and every member's iterate
bit-identical to an unrefilled solve of the same member.
"""

from __future__ import annotations

import random

import numpy as np
import pytest

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers.lanes import LaneBatch
from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve

pytestmark = pytest.mark.serve

PROBLEM = Problem(M=32, N=32)


@pytest.fixture(autouse=True)
def _fresh_registry():
    yield
    metrics.reset()


# -- solver layer: LaneBatch ------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_any_retire_splice_interleaving_is_bit_exact(seed):
    """Property-style: a seeded random schedule of splices (whenever a
    lane is free, with random reluctance) and retires (whenever a lane
    is done) over a 3-lane program must (a) never let two lanes carry
    the same member, (b) attribute every retired result to the exact
    member id spliced, and (c) reproduce the sequential solver's
    iterates bit-for-bit for EVERY member, no matter where in another
    member's flight it was spliced in."""
    rng = random.Random(seed)
    gates = {f"req-{i}": 1.0 + i / 7 for i in range(8)}
    golden = {mid: pcg_solve(PROBLEM, dtype="float32", rhs_gate=g, device="cpu")
              for mid, g in gates.items()}
    lb = LaneBatch(PROBLEM, bucket=3, dtype="float32",
                   chunk=rng.choice([3, 7, 11]), device="cpu")
    queue = list(gates)
    results = {}
    for _ in range(2000):
        if len(results) == len(gates):
            break
        for view in lb.lane_view():
            if view["member_id"] is not None and view["done"]:
                res = lb.retire(view["lane"])
                assert res.member_id == view["member_id"]
                results[res.member_id] = res
        while queue and lb.free_lanes() and rng.random() < 0.7:
            lb.splice(queue[0], gates[queue.pop(0)])
        occupied = [m for m in lb.origin if m is not None]
        assert len(occupied) == len(set(occupied))
        lb.step()
    assert len(results) == len(gates), "schedule did not drain"
    for mid, res in results.items():
        ref = golden[mid]
        assert res.iterations == int(ref.iterations), mid
        assert res.flag == int(ref.flag) == FLAG_CONVERGED, mid
        assert np.array_equal(np.asarray(res.w), np.asarray(ref.w)), (
            f"member {mid} drifted from its unrefilled solve")


def test_mid_flight_splice_does_not_perturb_the_resident_member():
    """The core splice soundness claim, isolated: a member 2 chunks deep
    when another splices in next to it finishes bit-identical to its
    solo solve — and so does the late joiner."""
    lb = LaneBatch(PROBLEM, bucket=2, dtype="float32", chunk=10, device="cpu")
    lb.splice("early", 1.0)
    lb.step()
    lb.step()                       # "early" is 20 iterations in
    lb.splice("late", 1.5)
    results = {}
    for _ in range(50):
        lb.step()
        for view in lb.lane_view():
            if view["member_id"] is not None and view["done"]:
                res = lb.retire(view["lane"])
                results[res.member_id] = res
        if not lb.occupied():
            break
    for mid, gate in (("early", 1.0), ("late", 1.5)):
        ref = pcg_solve(PROBLEM, dtype="float32", rhs_gate=gate, device="cpu")
        assert results[mid].iterations == int(ref.iterations)
        assert np.array_equal(np.asarray(results[mid].w),
                              np.asarray(ref.w))


def test_step_budget_is_per_lane_not_global():
    """A freshly spliced lane gets its own ``chunk`` iterations even
    when its neighbours are deep into theirs: stop_at is relative to
    each lane's carried k."""
    lb = LaneBatch(PROBLEM, bucket=2, dtype="float32", chunk=10, device="cpu")
    lb.splice("a", 1.0)
    lb.step()
    lb.splice("b", 1.2)
    lb.step()
    view = {v["member_id"]: v for v in lb.lane_view()}
    assert view["a"]["k"] == 20
    assert view["b"]["k"] == 10


def test_lane_occupancy_errors():
    lb = LaneBatch(PROBLEM, bucket=2, dtype="float32", device="cpu")
    lb.splice("a", 1.0, lane=0)
    with pytest.raises(ValueError, match="already occupies"):
        lb.splice("a", 1.0)
    with pytest.raises(ValueError, match="ACTIVE"):
        lb.splice("b", 1.0, lane=0)
    with pytest.raises(ValueError, match="EMPTY lane"):
        lb.splice(None, 1.0)
    with pytest.raises(ValueError, match="already EMPTY"):
        lb.retire(1)
    lb.splice("b", 1.0)
    with pytest.raises(ValueError, match="no EMPTY lane"):
        lb.splice("c", 1.0)
    with pytest.raises(ValueError):
        LaneBatch(PROBLEM, bucket=0, device="cpu")
    with pytest.raises(ValueError):
        LaneBatch(PROBLEM, bucket=2, chunk=0, device="cpu")


# -- service layer: the continuous engine ------------------------------


def _quiet():
    from poisson_tpu_torch.serve import DegradationPolicy

    return DegradationPolicy(shrink_padding_at=9.0, cap_iterations_at=9.0,
                             downshift_precision_at=9.0)


def _service(scheduling, **kw):
    from poisson_tpu_torch.serve import ServicePolicy, SolveService
    from poisson_tpu_torch.testing.chaos import VirtualClock

    vc = VirtualClock()
    kw.setdefault("degradation", _quiet())
    svc = SolveService(
        ServicePolicy(scheduling=scheduling, **kw),
        clock=vc, sleep=vc.sleep, seed=0, device="cpu",
    )
    return svc, vc


def test_continuous_and_drain_agree_on_outcomes():
    """Same six requests through both engines: identical converged set
    and identical per-request iteration counts — scheduling must change
    wall-clock shape, never answers."""
    from poisson_tpu_torch.serve import SCHED_CONTINUOUS, SCHED_DRAIN, SolveRequest

    per_mode = {}
    for mode in (SCHED_DRAIN, SCHED_CONTINUOUS):
        svc, _ = _service(mode, max_batch=4, refill_chunk=10)
        for i in range(6):
            svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                    rhs_gate=1.0 + i / 10,
                                    dtype="float32"))
        outs = svc.drain()
        assert svc.stats()["lost"] == 0
        per_mode[mode] = {o.request_id: (o.converged, o.iterations)
                          for o in outs}
    assert per_mode[SCHED_DRAIN] == per_mode[SCHED_CONTINUOUS]
    assert all(c for c, _ in per_mode[SCHED_CONTINUOUS].values())


def test_open_loop_arrival_joins_mid_flight():
    """The pump() seam: request 0 is two chunks deep when 1 and 2 are
    submitted — they must splice into the running program (no new table)
    and every ledger entry must close."""
    from poisson_tpu_torch.serve import SCHED_CONTINUOUS, SolveRequest

    svc, _ = _service(SCHED_CONTINUOUS, max_batch=4, refill_chunk=10)
    svc.submit(SolveRequest(request_id=0, problem=PROBLEM,
                            dtype="float32"))
    svc.pump()
    svc.pump()
    table = svc._table
    assert table is not None and table.occupied()
    for i in (1, 2):
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                rhs_gate=1.0 + i / 10, dtype="float32"))
    outs = svc.drain()
    assert svc._table is table or svc._table is None  # no rebuild race
    assert sorted(o.request_id for o in outs) == [0, 1, 2]
    assert all(o.converged for o in outs)
    assert metrics.get("serve.refill.splices") == 3
    assert metrics.get("serve.refill.retired_lanes") == 3
    assert svc.stats()["lost"] == 0


def test_continuous_iterations_match_solo_solves():
    """Identity + trajectory conservation at the service level: each
    outcome's iteration count equals the sequential solve of the same
    rhs_gate, after riding lanes through refills."""
    from poisson_tpu_torch.serve import SCHED_CONTINUOUS, SolveRequest

    gates = {i: 1.0 + i / 9 for i in range(7)}
    svc, _ = _service(SCHED_CONTINUOUS, max_batch=2, refill_chunk=15)
    for i, g in gates.items():
        svc.submit(SolveRequest(request_id=i, problem=PROBLEM,
                                rhs_gate=g, dtype="float32"))
    outs = {o.request_id: o for o in svc.drain()}
    for i, g in gates.items():
        ref = pcg_solve(PROBLEM, dtype="float32", rhs_gate=g, device="cpu")
        assert outs[i].converged
        assert outs[i].iterations == int(ref.iterations)


def test_ledger_is_honest_mid_flight():
    """stats() between pump() calls — the documented open-loop reading —
    must count a lane-resident request as pending, never as lost."""
    from poisson_tpu_torch.serve import SCHED_CONTINUOUS, SolveRequest

    svc, _ = _service(SCHED_CONTINUOUS, max_batch=2, refill_chunk=10)
    svc.submit(SolveRequest(request_id="r", problem=PROBLEM,
                            dtype="float32"))
    svc.pump()                      # "r" is in a lane, mid-flight
    s = svc.stats()
    assert s["pending"] == 1
    assert s["lost"] == 0
    svc.drain()
    s = svc.stats()
    assert s["pending"] == 0 and s["lost"] == 0 and s["completed"] == 1


def test_scheduling_policy_validation():
    from poisson_tpu_torch.serve import ServicePolicy, SolveService

    with pytest.raises(ValueError, match="scheduling"):
        SolveService(ServicePolicy(scheduling="sometimes"), device="cpu")
    with pytest.raises(ValueError, match="refill_chunk"):
        SolveService(ServicePolicy(refill_chunk=0), device="cpu")


# -- the serve CLI's continuous engine ---------------------------------
# (In place of the JAX suite's bench-sentinel direction pins: the port
# has no bench serve mode yet, so its records are the CLI's.)


def _cli_record(capsys, *extra):
    import json

    from poisson_tpu_torch.cli import main

    rc = main(["serve", "40", "40", "--requests", "6", "--vary-rhs",
               "--json", "--device", "cpu", *extra])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_continuous_cli_record_carries_scheduling(capsys):
    rc, rec = _cli_record(capsys, "--continuous", "--refill-chunk", "10",
                          "--max-batch", "2")
    assert rc == 0
    assert rec["scheduling"] == "continuous"
    assert rec["completed"] == rec["converged"] == 6 and rec["lost"] == 0


def test_refill_counters_reach_the_prometheus_textfile(tmp_path, capsys):
    from poisson_tpu_torch.obs import export

    prom = tmp_path / "serve.prom"
    rc, _ = _cli_record(capsys, "--continuous", "--refill-chunk", "10",
                        "--max-batch", "2", "--prom-out", str(prom))
    assert rc == 0
    parsed = export.parse_text(prom.read_text())
    assert parsed["poisson_tpu_serve_refill_splices"]["value"] >= 6
    assert parsed["poisson_tpu_serve_refill_retired_lanes"]["value"] == 6


def test_continuous_and_drain_agree_per_request(capsys):
    """Both engines give every request the iterations of its own solve:
    refill changes scheduling, never a member's trajectory."""
    from poisson_tpu_torch.serve import (SCHED_CONTINUOUS, SCHED_DRAIN,
                                         ServicePolicy, SolveRequest,
                                         SolveService)

    iters = {}
    for sched in (SCHED_DRAIN, SCHED_CONTINUOUS):
        svc = SolveService(ServicePolicy(scheduling=sched, max_batch=4,
                                         refill_chunk=10), device="cpu")
        for i in range(5):
            svc.submit(SolveRequest(request_id=i, problem=Problem(M=40, N=40),
                                    rhs_gate=1.0 + i / 5))
        iters[sched] = {o.request_id: o.iterations for o in svc.drain()}
    assert iters[SCHED_DRAIN] == iters[SCHED_CONTINUOUS]
    solo = {i: int(pcg_solve(Problem(M=40, N=40), rhs_gate=1.0 + i / 5,
                             device="cpu").iterations) for i in range(5)}
    assert iters[SCHED_DRAIN] == solo
