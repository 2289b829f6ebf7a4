"""Device placement & fault domains: the port's counterpart of
``tests/test_placement.py``.

Four rails under test, on CPU meshes (the port's mesh may repeat a
device, so an 8-shard mesh over the one CPU device stands in for the JAX
suite's virtual 8-device mesh):

1. **Batch×mesh composition** — ``solve_batched(mesh=)`` runs B RHS as
   ONE sharded dispatch and reproduces the unsharded batched driver's
   per-member iteration counts and stop flags exactly, with iterates
   agreeing to reduction-order ULPs (shard-local sums associate
   differently than one full-grid sum). The ``mesh=None`` path keeps
   its golden counts and equals the sequential solves bit for bit.
2. **Placement registry** — worker→device binding, fault-domain
   bookkeeping, epoch versioning, the elastic re-plan ladder.
3. **Device-loss supervision** — a lost device quarantines its whole
   fault domain, recovery lands on survivors, restart rebinds.
4. **Topology-aware recovery** — journal replay across a topology
   change remaps audibly (``placement_remapped`` flight point +
   counter) and types the unmappable, never wedges.
"""

import numpy as np
import pytest
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics as obs_metrics
from poisson_tpu_torch.parallel.mesh import make_solver_mesh
from poisson_tpu_torch.solvers.batched import (
    reset_bucket_cache,
    solve_batched,
)
from poisson_tpu_torch.testing.chaos import VirtualClock

pytestmark = [pytest.mark.serve, pytest.mark.placement]


@pytest.fixture(autouse=True)
def _clean_registries():
    obs_metrics.reset()
    reset_bucket_cache()
    yield


def _problem():
    return Problem(M=40, N=40)


# -- batch×mesh composition ---------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solve_batched_mesh_parity(dtype):
    """The acceptance pin: a forced-host 8-device mesh reproduces the
    unsharded batched per-member iteration counts and flags EXACTLY;
    iterates agree to the documented ULP tolerance (reduction-order
    differences only)."""
    p = _problem()
    mesh = make_solver_mesh(["cpu"] * 8, (2, 4))
    assert mesh.px * mesh.py == 8
    gates = [1.0, 1.1, 1.3, 0.7]
    ref = solve_batched(p, rhs_gates=gates, dtype=dtype, device="cpu")
    got = solve_batched(p, rhs_gates=gates, dtype=dtype, mesh=mesh)
    assert np.array_equal(np.asarray(got.iterations),
                          np.asarray(ref.iterations))
    assert np.array_equal(np.asarray(got.flag), np.asarray(ref.flag))
    atol = 1e-12 if dtype == "float64" else 1e-5
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(ref.w),
                               atol=atol)


def test_solve_batched_mesh_rhs_stack_and_bucket_cache():
    """The explicit rhs_stack form composes too, padding rides the
    same bucket ladder, and mesh buckets form their OWN bucket-cache
    key family (a sharded executable never claims single-device
    reuse)."""
    p = _problem()
    mesh = make_solver_mesh(["cpu"] * 8, (2, 4))
    rng = np.random.default_rng(0)
    stack = np.zeros((3, p.M + 1, p.N + 1))
    stack[:, 1:-1, 1:-1] = rng.normal(size=(3, p.M - 1, p.N - 1))
    ref = solve_batched(p, rhs_stack=stack, device="cpu")
    misses_before = obs_metrics.get("batched.bucket_cache.misses")
    got = solve_batched(p, rhs_stack=stack, mesh=mesh)
    assert obs_metrics.get("batched.bucket_cache.misses") \
        == misses_before + 1            # its own executable family
    got2 = solve_batched(p, rhs_stack=stack, mesh=mesh)
    assert obs_metrics.get("batched.bucket_cache.hits") >= 1
    assert np.array_equal(np.asarray(got.iterations),
                          np.asarray(ref.iterations))
    assert got.w.shape == (3, p.M + 1, p.N + 1)      # padding sliced
    assert np.array_equal(np.asarray(got.w), np.asarray(got2.w))


def test_mesh_none_path_untouched():
    """The flag-off contract: mesh=None is the single-device batched
    driver — golden counts, and every member bit for bit its sequential
    solve (the port's stand-in for the JAX suite's program pin)."""
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    p = _problem()
    res = solve_batched(p, rhs_gates=[1.0, 1.1], device="cpu")
    assert np.asarray(res.iterations).tolist() == [50, 50]
    for i, g in enumerate((1.0, 1.1)):
        solo = pcg_solve(p, rhs_gate=g, device="cpu")
        assert torch.equal(res.w[i], solo.w)


# -- registry / elastic ladder ------------------------------------------


def test_registry_binding_loss_and_remap():
    from poisson_tpu_torch.serve import DeviceRegistry, PlacementError

    reg = DeviceRegistry(count=4, devices=[torch.device("cpu")])
    placements = [reg.bind(i) for i in range(6)]   # wraps round-robin
    assert [pl.device_id for pl in placements] == [0, 1, 2, 3, 0, 1]
    assert all(pl.epoch == 1 for pl in placements)
    assert reg.lose(2) and not reg.lose(2)         # idempotent
    assert reg.epoch == 2 and reg.alive() == [0, 1, 3]
    remapped = reg.remap(2)                        # dead -> survivor
    assert remapped.device_id in (0, 1, 3)
    assert obs_metrics.get("serve.placement.remapped") == 1
    same = reg.remap(1)                            # alive -> same slot
    assert same.device_id == 1 and same.epoch == 2
    assert obs_metrics.get("serve.placement.remapped") == 1
    for d in (0, 1, 3):
        reg.lose(d)
    with pytest.raises(PlacementError):
        reg.bind(0)


def test_elastic_plan_ladder():
    from poisson_tpu_torch.serve import (
        RUNG_MESH,
        RUNG_SHED,
        RUNG_SINGLE,
        DeviceRegistry,
        elastic_plan,
    )

    reg = DeviceRegistry(count=4, devices=[torch.device("cpu")])
    assert elastic_plan(reg, 4) == (RUNG_MESH, [0, 1, 2, 3])
    reg.lose(1)
    rung, plan = elastic_plan(reg, 4)
    assert rung == RUNG_MESH and plan == [0, 2, 3]
    assert obs_metrics.get("serve.degraded.mesh_shrink") == 1
    reg.lose(0)
    reg.lose(3)
    assert elastic_plan(reg, 4) == (RUNG_SINGLE, 2)
    assert obs_metrics.get("serve.degraded.single_device") == 1
    reg.lose(2)
    assert elastic_plan(reg, 4) == (RUNG_SHED, None)
    assert obs_metrics.get("serve.degraded.mesh_shed") == 1


# -- fleet supervision across device loss -------------------------------


def _fleet_policy(**kw):
    from poisson_tpu_torch.serve import (
        DegradationPolicy,
        FleetPolicy,
        RetryPolicy,
        ServicePolicy,
    )

    quiet = DegradationPolicy(shrink_padding_at=9.0,
                              cap_iterations_at=9.0,
                              downshift_precision_at=9.0)
    fleet = FleetPolicy(workers=kw.pop("workers", 2),
                        devices=kw.pop("devices", 2),
                        quarantine_seconds=0.02,
                        recovery_backoff=0.02)
    return ServicePolicy(
        capacity=16, max_batch=4, degradation=quiet, fleet=fleet,
        retry=RetryPolicy(max_attempts=3, backoff_base=0.02,
                          backoff_cap=0.1), **kw)


def test_device_loss_quarantines_fault_domain_and_rebinds():
    """Two workers SHARE a device (oversubscribed fault domain): one
    DeviceLossError must quarantine both — the domain dies whole — and
    both must rebind to the surviving device at restart."""
    from poisson_tpu_torch.serve import SolveRequest, SolveService
    from poisson_tpu_torch.testing.faults import device_loss_fault

    vc = VirtualClock()
    holder = {}
    # 3 workers over 2 devices: workers 0 and 2 share device 0.
    svc = SolveService(
        _fleet_policy(workers=3, devices=2),
        clock=vc, sleep=vc.sleep, seed=0,
        worker_fault=device_loss_fault(
            {0}, lambda wid: holder["svc"].worker_device(wid)), device="cpu")
    holder["svc"] = svc
    assert [svc.worker_device(i) for i in range(3)] == [0, 1, 0]
    p = _problem()
    for i in range(4):
        svc.submit(SolveRequest(request_id=i, problem=p,
                                rhs_gate=1.0 + i / 10))
    outs = svc.drain()
    stats = svc.stats()
    assert stats["lost"] == 0 and all(o.converged for o in outs)
    assert obs_metrics.get("serve.fleet.device_losses") == 1
    # BOTH cohabitants of device 0 were quarantined by the one loss.
    assert obs_metrics.get("serve.fleet.quarantines") == 2
    assert stats["placement"]["lost"] == [0]
    # Rebinding happens at RESTART: release the quarantines (the drain
    # may finish on the survivor before the cooldown does) and let the
    # pump run the restarts.
    vc.advance(1.0)
    svc.pump()
    stats = svc.stats()
    assert set(stats["placement"]["bindings"].values()) == {1}
    assert obs_metrics.get("serve.placement.rebinds") == 2


def test_hw_cohort_keys_on_device():
    """SDC suspicion indicts the PART: the hardware cohort carries the
    dispatching worker's (device_kind, device_id), so suspicion on one
    device never arms defensive verification on another."""
    from poisson_tpu_torch.serve import SolveService

    svc = SolveService(_fleet_policy(workers=2, devices=2), device="cpu")
    svc._active_worker = svc._pool.workers[0]
    c0 = svc._hw_cohort()
    svc._active_worker = svc._pool.workers[1]
    c1 = svc._hw_cohort()
    svc._active_worker = None
    assert c0 != c1 and c0[2] == 0 and c1[2] == 1
    svc._suspect_hw.add(c0)
    svc._active_worker = svc._pool.workers[1]
    assert svc._hw_cohort() not in svc._suspect_hw


def test_pinned_request_runs_on_its_device_or_types():
    from poisson_tpu_torch.serve import SolveRequest, SolveService

    vc = VirtualClock()
    svc = SolveService(_fleet_policy(workers=2, devices=2),
                       clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    p = _problem()
    svc.submit(SolveRequest(request_id="on1", problem=p, device_id=1))
    (out,) = svc.drain()
    assert out.converged
    with pytest.raises(ValueError, match="outside the fleet topology"):
        svc.submit(SolveRequest(request_id="bad", problem=p,
                                device_id=9))
    # Alive but unstaffed: the pin could never be served — a caller
    # bug, loud at admission.
    svc_small = SolveService(_fleet_policy(workers=1, devices=2),
                             clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    with pytest.raises(ValueError, match="no worker bound"):
        svc_small.submit(SolveRequest(request_id="unstaffed", problem=p,
                                      device_id=1))
    svc._registry.lose(1)
    svc.submit(SolveRequest(request_id="ghost", problem=p, device_id=1))
    (ghost,) = svc.drain()
    assert ghost.kind == "error" and ghost.error_type == "placement"


# -- journal recovery across a topology change --------------------------


def test_recover_on_smaller_topology(tmp_path):
    """Kill with work in flight on an 8-slot topology, --recover on a
    4-slot one: the invariant closes, remapped requests carry a
    ``placement_remapped`` flight point on the JSONL rails, and an
    unmappable pin is a typed error, not a wedge."""
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.obs import trace as obs_trace
    from poisson_tpu_torch.serve import (
        SCHED_CONTINUOUS,
        SolveJournal,
        SolveRequest,
        SolveService,
        replay_journal,
    )

    trace_dir = str(tmp_path / "flight")
    obs.configure(trace_dir=trace_dir)
    try:
        p = _problem()
        path = str(tmp_path / "serve.journal")
        vc = VirtualClock()
        # Workers 4..5 land on devices 4..5 — slots a 4-device recovery
        # topology will NOT have.
        policy_a = _fleet_policy(workers=6, devices=8,
                                 scheduling=SCHED_CONTINUOUS,
                                 refill_chunk=10)
        journal_a = SolveJournal(path, clock=vc)
        svc_a = SolveService(policy_a, clock=vc, sleep=vc.sleep, seed=0,
                             journal=journal_a, device="cpu")
        # Pin work onto the high slots so its journal placement records
        # name devices the recovery topology lacks.
        svc_a.submit(SolveRequest(request_id="high", problem=p,
                                  device_id=5, chunk=10))
        svc_a.submit(SolveRequest(request_id="low", problem=p,
                                  rhs_gate=1.1))
        svc_a.pump()                       # "high" dispatches on dev 5
        # Wait — chunked solo dispatch runs to completion in one pump;
        # instead leave lane work resident: pump only once more so
        # "low" splices but does not finish.
        svc_a.pump()
        svc_a.submit(SolveRequest(request_id="pin5", problem=p,
                                  device_id=5))
        journal_a.close()                  # crash
        replay = replay_journal(path)
        pend = {pr.request.request_id: pr for pr in replay.pending}
        assert "pin5" in pend
        policy_b = _fleet_policy(workers=2, devices=4,
                                 scheduling=SCHED_CONTINUOUS,
                                 refill_chunk=10)
        journal_b = SolveJournal(path, clock=vc)
        svc_b = SolveService.recover(journal_b, policy_b, clock=vc,
                                     sleep=vc.sleep, seed=0, device="cpu")
        svc_b.drain()
        outs = {o.request_id: o for o in svc_b.outcomes()}
        stats = svc_b.stats()
        journal_b.close()
        assert stats["lost"] == 0
        assert outs["pin5"].kind == "error"
        assert outs["pin5"].error_type == "placement"
        assert "does not exist on this topology" in outs["pin5"].message
        # Any request the journal shows in flight on a dead slot was
        # remapped audibly.
        in_flight_high = [pr for pr in replay.pending
                          if pr.in_flight and pr.device_id is not None
                          and pr.device_id >= 4]
        assert obs_metrics.get("serve.placement.remapped") \
            == len(in_flight_high)
        final = replay_journal(path)
        assert not final.pending and not final.duplicate_outcomes
    finally:
        obs.finalize()
    if obs_metrics.get("serve.placement.remapped"):
        events = obs_trace.load_events(trace_dir)
        points = [e for e in events
                  if e.get("name") == "flight.point"
                  and e.get("point") == "placement_remapped"]
        assert points, "placement_remapped flight point missing from " \
                       "the JSONL rails"


def test_journal_records_carry_placement_epoch(tmp_path):
    from poisson_tpu_torch.serve import (
        SolveJournal,
        SolveRequest,
        SolveService,
        replay_journal,
    )

    vc = VirtualClock()
    path = str(tmp_path / "epoch.journal")
    journal = SolveJournal(path, clock=vc)
    svc = SolveService(_fleet_policy(workers=2, devices=2),
                       clock=vc, sleep=vc.sleep, seed=0, journal=journal, device="cpu")
    p = _problem()
    svc.submit(SolveRequest(request_id="e0", problem=p))
    svc.drain()
    journal.close()
    import json

    kinds = {}
    with open(path) as fh:
        for line in fh:
            rec = json.loads(line)
            kinds.setdefault(rec["kind"], []).append(rec)
    assert kinds["topology"][0]["devices"] == 2
    assert kinds["topology"][0]["epoch"] == 1
    assert kinds["dispatch"][0]["epoch"] == 1
    assert kinds["dispatch"][0]["device"] in (0, 1)
    replay = replay_journal(path)
    assert replay.topology["devices"] == 2


# -- CLI plumbing --------------------------------------------------------


def test_fleet_cli_survives_a_worker_kill(capsys):
    """The serve CLI over a 2-slot topology with a worker killed at
    t=0 (the port has no ``bench.py --serve`` yet; its fleet record is
    the CLI's): zero lost requests, and the fleet block counts the
    quarantine and the recovered requests (the restart waits out a
    real-time cooldown the drain may finish inside)."""
    import json

    from poisson_tpu_torch.cli import main

    rc = main(["serve", "40", "40", "--requests", "6", "--workers", "2",
               "--devices", "2", "--kill-worker-at", "0", "--json",
               "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0
    assert rec["lost"] == 0 and rec["completed"] == 6
    assert rec["workers"] == 2
    fleet = rec["fleet"]
    assert fleet["quarantines"] == 1
    assert fleet["recovered_requests"] >= 1
