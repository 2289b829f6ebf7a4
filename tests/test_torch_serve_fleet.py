"""The port's durable solve fleet (counterpart of ``tests/test_fleet.py``,
on the CPU; -m serve): supervised workers, the crash-safe request journal,
and recovery that keeps the ledger invariant.

Worker faults (kill, hang, repeated poison) come through the service's
``worker_fault`` seam under a virtual clock. Journal tests read replay
truth from the file (CRC-sealed records, torn tails skipped audibly, one
outcome per request across a crash), including a real subprocess
kill/restart drill (exit 75) whose invariant is read from the two emitted
``serve.*`` snapshots.
"""

import json
import os
import subprocess
import sys

import pytest

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.serve import (
    ERROR_INTERNAL,
    ERROR_TRANSIENT,
    FleetPolicy,
    OUTCOME_ERROR,
    RetryPolicy,
    SCHED_CONTINUOUS,
    DegradationPolicy,
    ServicePolicy,
    SolveJournal,
    SolveRequest,
    SolveService,
    WORKER_DEAD,
    WORKER_RUNNING,
    replay_journal,
)
from poisson_tpu_torch.testing.chaos import VirtualClock
from poisson_tpu_torch.testing.faults import (
    worker_hang_fault,
    worker_kill_fault,
)

pytestmark = [pytest.mark.serve, pytest.mark.fleet]

P40 = Problem(M=40, N=40)          # converges in 50 iterations (golden)


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def _quiet():
    return DegradationPolicy(shrink_padding_at=9.0, cap_iterations_at=9.0,
                             downshift_precision_at=9.0)


def _fleet_service(workers=2, *, scheduling="drain", worker_fault=None,
                   journal=None, fleet_kw=None, **policy_kw):
    vc = VirtualClock()
    policy_kw.setdefault("capacity", 16)
    policy_kw.setdefault("max_batch", 4)
    policy_kw.setdefault("degradation", _quiet())
    policy_kw.setdefault(
        "retry", RetryPolicy(max_attempts=3, backoff_base=0.05,
                             backoff_cap=0.1))
    fk = {"workers": workers, "quarantine_seconds": 0.02,
          "recovery_backoff": 0.05}
    fk.update(fleet_kw or {})
    svc = SolveService(
        ServicePolicy(scheduling=scheduling, fleet=FleetPolicy(**fk),
                      **policy_kw),
        clock=vc, sleep=vc.sleep, seed=0, worker_fault=worker_fault,
        journal=journal, device="cpu",
    )
    return svc, vc


# -- worker lifecycle ----------------------------------------------------


def test_worker_kill_mid_dispatch_recovers_to_survivors():
    svc, _ = _fleet_service(worker_fault=worker_kill_fault({0}))
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"r{i}", problem=P40,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    assert all(o.converged and o.attempts == 2 for o in outs.values())
    assert metrics.get("serve.fleet.quarantines") == 1
    assert metrics.get("serve.fleet.recovered_requests") == 4
    # Mutual taint: the four recovered requests never co-batch again,
    # so the survivors ran them as four separate dispatches.
    assert metrics.get("serve.requeued.isolated") == 4
    assert svc.stats()["lost"] == 0


def test_killed_worker_restarts_through_warmup_and_serves_again():
    svc, vc = _fleet_service(worker_fault=worker_kill_fault({0}))
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"a{i}", problem=P40,
                                rhs_gate=1.0 + i / 10))
    svc.drain()
    assert metrics.get("serve.fleet.restarts") >= 1
    assert metrics.get("serve.fleet.warmup_solves") >= 1
    assert all(s == WORKER_RUNNING
               for s in svc.stats()["workers"].values())
    # The restarted worker takes traffic again (kill budget spent).
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"b{i}", problem=P40,
                                rhs_gate=1.2 + i / 10))
    outs = svc.drain()
    assert all(o.converged and o.attempts == 1 for o in outs)


def test_worker_kill_in_continuous_mode_recovers_lane_occupants():
    svc, _ = _fleet_service(scheduling=SCHED_CONTINUOUS, max_batch=2,
                            refill_chunk=10,
                            worker_fault=worker_kill_fault({0}))
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"l{i}", problem=P40,
                                rhs_gate=1.0 + i / 10))
    outs = {o.request_id: o for o in svc.drain()}
    assert len(outs) == 3 and all(o.converged for o in outs.values())
    assert metrics.get("serve.fleet.quarantines") == 1
    assert metrics.get("serve.fleet.recovered_requests") >= 1
    assert svc.stats()["lost"] == 0


def test_worker_hang_is_caught_by_the_heartbeat_watchdog():
    svc, vc = _fleet_service(fleet_kw={"heartbeat_timeout": 0.2})
    # The hang needs the service's own clock, so it is wired post-hoc.
    svc._worker_fault = worker_hang_fault({0}, 0.5, vc.advance)
    for i in range(3):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                rhs_gate=1.0 + i / 10))
    outs = svc.drain()
    assert all(o.converged for o in outs)
    assert metrics.get("watchdog.stalls") >= 1
    assert metrics.get("serve.fleet.hangs") >= 1
    assert metrics.get("serve.fleet.quarantines") == 1
    assert svc.stats()["lost"] == 0


def test_slow_but_returning_step_is_quarantined_post_hoc():
    """A step that overruns the heartbeat timeout but RETURNS must
    still draw a stall verdict: its outcomes stand, but the worker is
    quarantined before taking more traffic (the post-step check
    measures from the start-of-step beat — completion must not reset
    the baseline)."""
    svc, vc = _fleet_service(fleet_kw={"heartbeat_timeout": 0.2})
    slow = {"armed": True}

    def crawl(requests, attempts):
        if slow["armed"]:
            slow["armed"] = False
            vc.advance(5.0)          # way past the 0.2s heartbeat

    svc._dispatch_fault = crawl
    for i in range(2):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                rhs_gate=1.0 + i / 10))
    outs = svc.drain()
    assert all(o.converged and o.attempts == 1 for o in outs)
    assert metrics.get("watchdog.stalls") >= 1
    assert metrics.get("serve.fleet.hangs") >= 1
    assert metrics.get("serve.fleet.quarantines") == 1
    assert svc.stats()["lost"] == 0


def test_str_colliding_ids_stay_distinct_without_recovery():
    """int 1 and string \"1\" are different request ids outside
    recovery — the journal's str-spelling guard must not conflate
    them in a journal-less service."""
    vc = VirtualClock()
    svc = SolveService(ServicePolicy(degradation=_quiet()),
                       clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    svc.submit(SolveRequest(request_id=1, problem=P40))
    svc.submit(SolveRequest(request_id="1", problem=P40, rhs_gate=1.1))
    outs = svc.drain()
    assert len(outs) == 2 and all(o.converged for o in outs)
    assert metrics.get("serve.admitted") == 2


def test_restart_budget_exhaustion_kills_the_worker_for_good():
    svc, _ = _fleet_service(
        worker_fault=worker_kill_fault({0}, kills_per_worker=99),
        fleet_kw={"max_restarts": 1})
    for i in range(6):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                rhs_gate=1.0 + i / 10))
    outs = svc.drain()
    assert all(o.converged for o in outs)        # survivors carried it
    assert svc.stats()["workers"][0] == WORKER_DEAD
    assert metrics.get("serve.fleet.worker_deaths") == 1
    assert svc.stats()["lost"] == 0


def test_total_fleet_loss_fails_pending_with_typed_internal_errors():
    svc, _ = _fleet_service(
        workers=2,
        worker_fault=worker_kill_fault({0, 1}, kills_per_worker=99),
        fleet_kw={"max_restarts": 0})
    for i in range(3):
        svc.submit(SolveRequest(request_id=i, problem=P40))
    outs = svc.drain()
    assert len(outs) == 3
    assert all(o.kind == OUTCOME_ERROR for o in outs)
    # The first batch dies with the workers (transient after retries);
    # whatever was still queued when the fleet died is failed internal.
    assert {o.error_type for o in outs} <= {ERROR_TRANSIENT,
                                            ERROR_INTERNAL}
    assert svc.stats()["lost"] == 0 and svc.stats()["pending"] == 0


def test_sticky_routing_prefers_the_worker_with_the_executable():
    svc, _ = _fleet_service(workers=2)
    for i in range(8):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                rhs_gate=1.0 + i / 10))
        svc.drain()
    # After the first dispatch gave one worker the cohort, later heads
    # route to it: hits dominate once sticky state exists.
    assert metrics.get("serve.fleet.sticky_hits") >= 1


def test_single_worker_fleet_is_the_classic_service():
    svc, _ = _fleet_service(workers=1)
    for i in range(3):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                rhs_gate=1.0 + i / 10))
    outs = svc.drain()
    assert all(o.converged and o.attempts == 1 for o in outs)
    assert metrics.get("serve.fleet.quarantines") == 0
    assert svc.stats()["breakers"]                 # cohort-keyed, no @w
    assert all("@" not in k for k in svc.stats()["breakers"])


# -- idempotent submission (dedup) --------------------------------------


def test_dedup_returns_original_outcome_and_never_double_admits():
    vc = VirtualClock()
    svc = SolveService(ServicePolicy(dedup=True, degradation=_quiet()),
                       clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    assert svc.submit(SolveRequest(request_id="x", problem=P40)) is None
    assert svc.submit(SolveRequest(request_id="x", problem=P40)) is None
    (out,) = svc.drain()
    dup = svc.submit(SolveRequest(request_id="x", problem=P40))
    assert dup is out and dup.converged
    assert metrics.get("serve.dedup.hits") == 2
    assert metrics.get("serve.admitted") == 1
    assert svc.stats()["lost"] == 0


def test_dedup_off_keeps_the_loud_value_error():
    vc = VirtualClock()
    svc = SolveService(ServicePolicy(degradation=_quiet()),
                       clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    svc.submit(SolveRequest(request_id="x", problem=P40))
    with pytest.raises(ValueError, match="duplicate request_id"):
        svc.submit(SolveRequest(request_id="x", problem=P40))


# -- the write-ahead journal --------------------------------------------


def test_journal_records_are_crc_sealed_and_replay_to_the_ledger(tmp_path):
    path = str(tmp_path / "serve.journal")
    vc = VirtualClock()
    journal = SolveJournal(path, clock=vc)
    svc = SolveService(ServicePolicy(degradation=_quiet()),
                       clock=vc, sleep=vc.sleep, seed=0, journal=journal, device="cpu")
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"j{i}", problem=P40,
                                rhs_gate=1.0 + i / 10))
    svc.drain()
    journal.close()
    import zlib

    for line in open(path).read().splitlines():
        rec = json.loads(line)
        crc = rec.pop("crc32")
        blob = json.dumps(rec, sort_keys=True, default=str)
        assert zlib.crc32(blob.encode()) & 0xFFFFFFFF == crc
    replay = replay_journal(path)
    assert replay.submitted == 3
    assert sorted(replay.outcomes) == ["j0", "j1", "j2"]
    assert not replay.pending and not replay.duplicate_outcomes
    assert replay.lost == 0


def test_replay_reconstructs_pending_with_taint_and_attempts(tmp_path):
    path = str(tmp_path / "serve.journal")
    vc = VirtualClock()
    journal = SolveJournal(path, clock=vc)
    svc = SolveService(
        ServicePolicy(scheduling=SCHED_CONTINUOUS, max_batch=2,
                      refill_chunk=10, degradation=_quiet()),
        clock=vc, sleep=vc.sleep, seed=0, journal=journal, device="cpu")
    for i in range(2):
        svc.submit(SolveRequest(request_id=f"p{i}", problem=P40,
                                rhs_gate=1.0 + i / 10,
                                deadline_seconds=3600.0))
    svc.pump()                       # both lane-resident, mid-flight
    journal.close()                  # crash
    replay = replay_journal(path)
    assert len(replay.pending) == 2
    for pend in replay.pending:
        assert pend.in_flight and pend.attempts == 1
        assert pend.request.problem == P40
        assert pend.request.deadline_seconds == 3600.0
    taints = {p.request.request_id: p.taint for p in replay.pending}
    assert taints["p0"] == {"p1"} and taints["p1"] == {"p0"}


def test_recovered_requests_drain_without_double_admission(tmp_path):
    path = str(tmp_path / "serve.journal")
    vc = VirtualClock()
    policy = ServicePolicy(scheduling=SCHED_CONTINUOUS, max_batch=2,
                           refill_chunk=10, degradation=_quiet())
    journal_a = SolveJournal(path, clock=vc)
    svc_a = SolveService(policy, clock=vc, sleep=vc.sleep, seed=0,
                         journal=journal_a, device="cpu")
    for i in range(4):
        svc_a.submit(SolveRequest(request_id=f"c{i}", problem=P40,
                                  rhs_gate=1.0 + i / 10))
    while len(svc_a.outcomes()) < 2:
        svc_a.pump()
    journal_a.close()                # crash with 2 done, 2 in flight
    journal_b = SolveJournal(path, clock=vc)
    svc_b = SolveService.recover(journal_b, policy, clock=vc,
                                 sleep=vc.sleep, seed=0, device="cpu")
    assert svc_b.recovery.submitted == 4
    assert len(svc_b.recovery.pending) == 2
    outs = svc_b.drain()
    journal_b.close()
    assert len(outs) == 2 and all(o.converged for o in outs)
    stats = svc_b.stats()
    assert stats["recovered"] == 2 and stats["lost"] == 0
    # Merged-counter invariant across the "crash": one registry played
    # both processes, so admitted(4) == completed(4), recovered NOT
    # re-admitted.
    assert metrics.get("serve.admitted") == 4
    assert metrics.get("serve.completed") == 4
    assert metrics.get("serve.recovered") == 2
    final = replay_journal(path)
    assert sorted(final.outcomes) == [f"c{i}" for i in range(4)]
    assert not final.duplicate_outcomes and not final.pending


def test_requeue_taint_survives_replay(tmp_path):
    """Mutual taint established BEFORE a crash (a poisoned batch
    requeued into backoff) must survive the replay — never-co-batch-
    again is forever, not per-process."""
    from poisson_tpu_torch.testing.faults import poison_batch_fault

    path = str(tmp_path / "serve.journal")
    vc = VirtualClock()
    journal = SolveJournal(path, clock=vc)
    svc = SolveService(
        ServicePolicy(degradation=_quiet(),
                      retry=RetryPolicy(max_attempts=3)),
        clock=vc, sleep=vc.sleep, seed=0, journal=journal,
        dispatch_fault=poison_batch_fault({"p"}), device="cpu")
    svc.submit(SolveRequest(request_id="p", problem=P40))
    svc.submit(SolveRequest(request_id="q", problem=P40, rhs_gate=1.1))
    svc.pump()                       # batch dies; both back off tainted
    journal.close()                  # crash during backoff
    replay = replay_journal(path)
    taints = {pend.request.request_id: pend.taint
              for pend in replay.pending}
    assert taints == {"p": {"q"}, "q": {"p"}}


def test_recovered_ids_guard_resubmission_of_the_original_type(tmp_path):
    """The journal stringifies ids: a client retrying with the original
    (int) id after recovery must still hit the dedup guard — never a
    double admission."""
    path = str(tmp_path / "serve.journal")
    vc = VirtualClock()
    journal_a = SolveJournal(path, clock=vc)
    svc_a = SolveService(ServicePolicy(degradation=_quiet()),
                         clock=vc, sleep=vc.sleep, seed=0,
                         journal=journal_a, device="cpu")
    svc_a.submit(SolveRequest(request_id=7, problem=P40))
    journal_a.close()                # crash with 7 still queued
    journal_b = SolveJournal(path, clock=vc)
    svc_b = SolveService.recover(
        journal_b, ServicePolicy(dedup=True, degradation=_quiet()),
        clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    assert svc_b.submit(SolveRequest(request_id=7, problem=P40)) is None
    assert metrics.get("serve.dedup.hits") == 1
    assert metrics.get("serve.admitted") == 1    # the original only
    outs = svc_b.drain()
    journal_b.close()
    assert len(outs) == 1 and outs[0].converged
    assert svc_b.stats()["lost"] == 0


def test_torn_tail_and_crc_corruption_are_skipped_audibly(tmp_path):
    path = str(tmp_path / "serve.journal")
    vc = VirtualClock()
    journal = SolveJournal(path, clock=vc)
    svc = SolveService(ServicePolicy(degradation=_quiet()),
                       clock=vc, sleep=vc.sleep, seed=0, journal=journal, device="cpu")
    svc.submit(SolveRequest(request_id="torn", problem=P40))
    journal.close()                  # crash before any dispatch
    with open(path, "a") as fh:
        # A sealed-looking outcome with a WRONG crc: must not mark the
        # request terminated. Then a half-written line.
        fh.write('{"kind": "outcome", "outcome": "result", '
                 '"request_id": "torn", "seq": 9, "t": 1.0, '
                 '"crc32": 1}\n')
        fh.write('{"seq": 10, "ki')
    replay = replay_journal(path)
    assert replay.torn_records == 2
    assert len(replay.torn_detail) == 2
    assert not replay.outcomes       # the fake outcome was not trusted
    assert [p.request.request_id for p in replay.pending] == ["torn"]
    assert metrics.get("serve.journal.torn_records") >= 2
    # The invariant still closes: recover and drain.
    journal_b = SolveJournal(path, clock=vc)
    svc_b = SolveService.recover(
        journal_b, ServicePolicy(degradation=_quiet()),
        clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    (out,) = svc_b.drain()
    journal_b.close()
    assert out.converged and svc_b.stats()["lost"] == 0


def test_crash_restart_subprocess_drill(tmp_path):
    """Kill ``python -m poisson_tpu_torch serve`` mid-run (exit 75), restart
    against the journal: the invariant closes across the boundary from
    the two emitted metrics snapshots, zero lost, zero duplicated."""
    journal = str(tmp_path / "serve.journal")
    a_metrics = str(tmp_path / "a.json")
    b_metrics = str(tmp_path / "b.json")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    base = [sys.executable, "-m", "poisson_tpu_torch", "serve", "--device", "cpu", "40", "40",
            "--continuous", "--refill-chunk", "10", "--max-batch", "2",
            "--journal", journal, "--seed", "0"]
    a = subprocess.run(base + ["--requests", "6", "--kill-after", "2",
                               "--metrics-out", a_metrics],
                       capture_output=True, text=True, timeout=240,
                       env=env)
    assert a.returncode == 75, a.stderr[-500:]
    b = subprocess.run(base + ["--requests", "0", "--recover",
                               "--json", "--metrics-out", b_metrics],
                       capture_output=True, text=True, timeout=240,
                       env=env)
    assert b.returncode == 0, b.stderr[-500:]
    record = json.loads(b.stdout.strip().splitlines()[-1])
    assert record["lost"] == 0 and record["recovered"] > 0
    ca = json.load(open(a_metrics))["counters"]
    cb = json.load(open(b_metrics))["counters"]

    def terminated(c):
        return (c.get("serve.completed", 0) + c.get("serve.errors", 0)
                + c.get("serve.shed", 0))

    admitted = ca.get("serve.admitted", 0) + cb.get("serve.admitted", 0)
    assert admitted == 6
    assert terminated(ca) + terminated(cb) == 6
    assert cb.get("serve.recovered") == 6 - terminated(ca)
    final = replay_journal(journal)
    assert sorted(final.outcomes) == [str(i) for i in range(6)]
    assert not final.duplicate_outcomes and not final.pending


# -- the fleet record ----------------------------------------------------
# (In place of the JAX suite's bench-sentinel cohort pin: the port has
# no bench serve mode yet, so its fleet record is the CLI's.)


def test_fleet_cli_record_carries_worker_states(capsys):
    from poisson_tpu_torch.cli import main

    rc = main(["serve", "40", "40", "--requests", "6", "--workers", "3",
               "--json", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and rec["lost"] == 0
    assert rec["workers"] == 3
    assert rec["fleet"]["workers"] == {"0": "running", "1": "running",
                                       "2": "running"}
    assert rec["fleet"]["quarantines"] == 0


# -- flight-recorder attribution ----------------------------------------


def test_recovery_points_and_worker_attrs_ride_the_flight_trace(tmp_path):
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.obs import flight
    from poisson_tpu_torch.obs.trace import load_events

    obs.configure(trace_dir=str(tmp_path))
    svc, _ = _fleet_service(worker_fault=worker_kill_fault({0}))
    svc.submit(SolveRequest(request_id="traced", problem=P40))
    (out,) = svc.drain()
    obs.finalize()
    events = load_events(str(tmp_path))
    tid, recs = flight.find_trace(events, request_id="traced")
    assert tid == out.trace_id
    assert not flight.validate_trace(recs)
    points = {flight._field(r, "point") for r in recs
              if r.get("name") == "flight.point"}
    assert {"quarantine", "recovered"} <= points
    resident = [r for r in recs if r.get("name") == "flight.span"
                and flight._field(r, "span") == "lane_resident"]
    assert resident and all(
        flight._field(r, "worker") is not None for r in resident)
    timeline = flight.render_timeline(recs)
    assert "recovered" in timeline and "quarantine" in timeline
    assert "worker=" in timeline
