"""Solve-service lifecycle in the port (counterpart of
``tests/test_serve.py``, on the CPU; -m serve): admission, deadlines,
retry/backoff, circuit breaking, graceful degradation.

Every test drives the port's solvers on tiny grids through the
single-threaded service loop with an injected virtual clock: deadlines,
backoff and breaker cooldowns are a pure function of the clock and the
seed.
"""

import json

import numpy as np
import pytest

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.serve import (
    CLOSED,
    Deadline,
    HALF_OPEN,
    OPEN,
    BreakerPolicy,
    CircuitBreaker,
    DegradationPolicy,
    OUTCOME_ERROR,
    OUTCOME_RESULT,
    OUTCOME_SHED,
    RetryPolicy,
    ServicePolicy,
    SolveRequest,
    SolveService,
    TransientDispatchError,
)
from poisson_tpu_torch.testing.chaos import VirtualClock

pytestmark = pytest.mark.serve

P40 = Problem(M=40, N=40)          # converges in 50 iterations (golden)


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def _service(policy=None, **kw):
    vc = VirtualClock()
    svc = SolveService(policy or ServicePolicy(), clock=vc,
                       sleep=vc.sleep, **kw, device="cpu")
    return svc, vc


def _quiet_degradation():
    return DegradationPolicy(shrink_padding_at=9.0, cap_iterations_at=9.0,
                             downshift_precision_at=9.0)


# -- typed outcomes & the ledger ---------------------------------------


def test_every_request_gets_exactly_one_typed_outcome():
    svc, _ = _service()
    for i in range(5):
        assert svc.submit(SolveRequest(request_id=i, problem=P40,
                                       rhs_gate=1.0 + i / 10)) is None
    outs = svc.drain()
    assert sorted(o.request_id for o in outs) == list(range(5))
    assert all(o.kind == OUTCOME_RESULT and o.converged for o in outs)
    stats = svc.stats()
    assert stats["lost"] == 0 and stats["pending"] == 0
    assert metrics.get("serve.admitted") == 5
    assert metrics.get("serve.completed") == 5


def test_duplicate_request_id_rejected():
    svc, _ = _service()
    svc.submit(SolveRequest(request_id="a", problem=P40))
    with pytest.raises(ValueError, match="duplicate request_id"):
        svc.submit(SolveRequest(request_id="a", problem=P40))


def test_bounded_admission_sheds_typed():
    svc, _ = _service(ServicePolicy(capacity=2))
    assert svc.submit(SolveRequest(request_id=0, problem=P40)) is None
    assert svc.submit(SolveRequest(request_id=1, problem=P40)) is None
    shed = svc.submit(SolveRequest(request_id=2, problem=P40))
    assert shed is not None and shed.kind == OUTCOME_SHED
    assert shed.shed_reason == "queue_full"
    svc.drain()
    s = svc.stats()
    # The shed request is in the ledger: admitted and terminated.
    assert s["admitted"] == 3 and s["shed"] == 1 and s["lost"] == 0


# -- circuit breaker ----------------------------------------------------


def test_breaker_trip_half_open_close_transitions():
    vc = VirtualClock()
    br = CircuitBreaker(BreakerPolicy(failure_threshold=3,
                                      cooldown_seconds=10.0,
                                      half_open_probes=1),
                        clock=vc, cohort="t")
    assert br.state == CLOSED and br.allow()
    br.record_failure()
    br.record_failure()
    assert br.state == CLOSED          # below threshold
    br.record_failure()
    assert br.state == OPEN and not br.allow()
    assert metrics.get("serve.breaker.trips") == 1
    vc.advance(9.9)
    assert not br.allow()              # still cooling down
    vc.advance(0.2)
    assert br.state == HALF_OPEN
    assert br.allow()                  # the probe slot
    assert not br.allow()              # only one probe
    br.record_success()
    assert br.state == CLOSED and br.allow()
    assert metrics.get("serve.breaker.half_opens") == 1
    assert metrics.get("serve.breaker.closes") == 1


def test_breaker_reopens_on_failed_probe():
    vc = VirtualClock()
    br = CircuitBreaker(BreakerPolicy(failure_threshold=2,
                                      cooldown_seconds=5.0),
                        clock=vc, cohort="t")
    br.record_failure()
    br.record_failure()
    vc.advance(5.1)
    assert br.allow()                  # probe
    br.record_failure()                # probe failed
    assert br.state == OPEN
    assert metrics.get("serve.breaker.trips") == 2


def test_success_resets_consecutive_failure_count():
    br = CircuitBreaker(BreakerPolicy(failure_threshold=2), cohort="t")
    br.record_failure()
    br.record_success()
    br.record_failure()
    assert br.state == CLOSED          # never two consecutive


def test_open_breaker_sheds_requests_typed():
    fail = {"on": True}

    def fault(requests, attempts):
        if fail["on"]:
            raise TransientDispatchError("outage")

    svc, vc = _service(
        ServicePolicy(retry=RetryPolicy(max_attempts=1),
                      breaker=BreakerPolicy(failure_threshold=2,
                                            cooldown_seconds=3.0),
                      degradation=_quiet_degradation()),
        dispatch_fault=fault,
    )
    for i in range(2):
        svc.submit(SolveRequest(request_id=i, problem=P40))
        svc.drain()                    # two consecutive typed errors
    svc.submit(SolveRequest(request_id=2, problem=P40))
    (shed,) = svc.drain()
    assert shed.kind == OUTCOME_SHED and shed.shed_reason == "breaker_open"
    fail["on"] = False
    vc.advance(3.1)
    svc.submit(SolveRequest(request_id=3, problem=P40))
    (probe,) = svc.drain()
    assert probe.converged
    assert svc.stats()["breakers"]["40x40:auto:torch"] == CLOSED


# -- deadlines ----------------------------------------------------------


def test_deadline_object_semantics():
    vc = VirtualClock()
    d = Deadline(2.0, clock=vc)
    assert not d.expired() and d.remaining() == pytest.approx(2.0)
    vc.advance(2.5)
    assert d.expired() and d.remaining() == pytest.approx(-0.5)
    assert not Deadline.never().expired()
    assert Deadline.never().remaining() is None
    with pytest.raises(ValueError):
        Deadline(-1.0)


def test_deadline_expiry_mid_chunk_returns_partial_flagged_result():
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
    from poisson_tpu_torch.solvers.pcg import FLAG_DEADLINE

    vc = VirtualClock()

    def tick(state, chunks_done):
        vc.advance(0.4)
        return None

    res = pcg_solve_chunked(P40, chunk=5, deadline=Deadline(1.0, clock=vc),
                            on_chunk=tick, device="cpu")
    assert int(res.flag) == FLAG_DEADLINE
    assert 0 < int(res.iterations) < 50        # partial, not a hang
    assert bool(np.isfinite(np.asarray(res.w)).all())
    assert metrics.get("checkpoint.deadline_stops") == 1


def test_deadline_never_masks_a_failure_verdict():
    """A solve that DIVERGED keeps its honest verdict even when the
    deadline has also lapsed during the failing chunk: stamping
    FLAG_DEADLINE over nonfinite would hand the poisoned iterate out as
    a usable partial result and skip the service's retry/escalation
    path. A NaN RHS dies inside chunk 1; the ticking clock makes the
    deadline expire across that same chunk."""
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
    from poisson_tpu_torch.solvers.pcg import FLAG_NONFINITE

    t = {"now": 0.0}

    def ticking_clock():               # every observation costs 0.6 s
        t["now"] += 0.6
        return t["now"]

    res = pcg_solve_chunked(P40, chunk=5, rhs_gate=float("nan"),
                            deadline=Deadline(1.0, clock=ticking_clock), device="cpu")
    assert int(res.flag) == FLAG_NONFINITE


def test_deadline_never_overrides_convergence():
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED

    vc = VirtualClock()
    # Expires only after the solve would already have converged.
    res = pcg_solve_chunked(P40, chunk=100,
                            deadline=Deadline(1e9, clock=vc), device="cpu")
    assert int(res.flag) == FLAG_CONVERGED
    assert int(res.iterations) == 50


def test_deadline_stopped_checkpoint_resumes_clean(tmp_path):
    """FLAG_DEADLINE is host-stamped provenance on the RESULT only: the
    persisted state keeps its in-loop verdict, so a rerun with a fresh
    budget resumes from the partial iterate and converges to the golden
    sequence."""
    from poisson_tpu_torch.solvers.checkpoint import (
        pcg_solve_checkpointed,
        pcg_solve_chunked,
    )
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, FLAG_DEADLINE

    path = str(tmp_path / "ck.npz")
    vc = VirtualClock()

    def tick(state, chunks_done):
        vc.advance(1.0)
        return None

    partial = pcg_solve_checkpointed(P40, path, chunk=10,
                                     deadline=Deadline(1.5, clock=vc),
                                     on_chunk=tick, device="cpu")
    assert int(partial.flag) == FLAG_DEADLINE
    assert 0 < int(partial.iterations) < 50
    resumed = pcg_solve_checkpointed(P40, path, chunk=10, device="cpu")
    assert int(resumed.flag) == FLAG_CONVERGED
    golden = pcg_solve_chunked(P40, chunk=10, device="cpu")
    assert int(resumed.iterations) == int(golden.iterations) == 50
    np.testing.assert_array_equal(np.asarray(resumed.w),
                                  np.asarray(golden.w))


def test_resilient_deadline_bounds_recovery():
    from poisson_tpu_torch.solvers.pcg import FLAG_DEADLINE
    from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient

    vc = VirtualClock()
    vc.advance(0.0)
    res = pcg_solve_resilient(P40, chunk=10,
                              deadline=Deadline(0.0, clock=vc), device="cpu")
    assert int(res.flag) == FLAG_DEADLINE
    assert int(res.iterations) == 0            # refused to start a chunk
    assert metrics.get("resilient.deadline_stops") == 1


def test_deadline_vs_watchdog_interaction():
    """The two guards answer different questions and must not cross:
    a mid-chunk STALL trips the watchdog (liveness) while a generous
    deadline stays quiet; and a deadline stop beats like a healthy solve
    (the watchdog must NOT fire on a deadline-bounded run)."""
    import time as _time

    from poisson_tpu_torch.parallel.watchdog import Watchdog
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
    from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, FLAG_DEADLINE

    # Stall → watchdog fires, deadline quiet.
    fired = []
    wd = Watchdog(timeout=0.15, poll_interval=0.03,
                  on_timeout=fired.append)
    stalled = {"done": False}

    def stall_once(state, chunks_done):
        if not stalled["done"]:
            stalled["done"] = True
            _time.sleep(0.4)
        return None

    res = pcg_solve_chunked(P40, chunk=10, watchdog=wd,
                            on_chunk=stall_once, deadline=Deadline(3600.0), device="cpu")
    assert wd.fired and len(fired) == 1
    assert int(res.flag) == FLAG_CONVERGED     # stall ≠ budget overrun

    # Deadline stop → watchdog quiet (beats kept landing at boundaries).
    vc = VirtualClock()

    def tick(state, chunks_done):
        vc.advance(1.0)
        return None

    wd2 = Watchdog(timeout=30.0, poll_interval=0.05,
                   on_timeout=lambda d: pytest.fail("watchdog misfired"))
    res2 = pcg_solve_chunked(P40, chunk=10, watchdog=wd2,
                             deadline=Deadline(1.5, clock=vc),
                             on_chunk=tick, device="cpu")
    assert int(res2.flag) == FLAG_DEADLINE
    assert not wd2.fired


def test_service_sheds_requests_whose_deadline_died_in_queue():
    from poisson_tpu_torch.testing.faults import slow_worker_fault

    vc = VirtualClock()
    svc = SolveService(
        ServicePolicy(degradation=_quiet_degradation()),
        clock=vc, sleep=vc.sleep,
        dispatch_fault=None, device="cpu",
    )
    # Manually burn the clock between submits via a slow dispatch.
    svc._dispatch_fault = slow_worker_fault(2.0, vc.sleep)
    for i in range(3):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                deadline_seconds=1.0))
    outs = {o.request_id: o for o in svc.drain()}
    assert outs[0].kind == OUTCOME_RESULT      # dispatched at t=0
    assert outs[1].kind == OUTCOME_SHED        # t=2.0 > deadline
    assert outs[2].kind == OUTCOME_SHED
    assert metrics.get("serve.shed.deadline_expired") == 2


# -- retry / backoff / requeue isolation --------------------------------


def test_backoff_is_seeded_exponential_with_jitter():
    policy = ServicePolicy(retry=RetryPolicy(max_attempts=9,
                                             backoff_base=0.1,
                                             backoff_cap=1.0, jitter=0.5))
    a = SolveService(policy, seed=7, device="cpu")
    b = SolveService(policy, seed=7, device="cpu")
    c = SolveService(policy, seed=8, device="cpu")
    da = [a._backoff_delay(n) for n in range(1, 6)]
    db = [b._backoff_delay(n) for n in range(1, 6)]
    dc = [c._backoff_delay(n) for n in range(1, 6)]
    assert da == db                    # same seed → same jitter
    assert da != dc                    # different seed → different jitter
    for n, d in enumerate(da, start=1):
        base = min(0.1 * 2 ** (n - 1), 1.0)
        assert base * 0.5 <= d <= base # jittered down, capped


def test_poison_member_is_isolated_on_requeue():
    from poisson_tpu_torch.testing.faults import poison_batch_fault

    svc, _ = _service(
        ServicePolicy(retry=RetryPolicy(max_attempts=3,
                                        backoff_base=0.01,
                                        backoff_cap=0.05),
                      degradation=_quiet_degradation()),
        dispatch_fault=poison_batch_fault({"poison"}),
    )
    svc.submit(SolveRequest(request_id="poison", problem=P40))
    for i in range(3):
        svc.submit(SolveRequest(request_id=i, problem=P40))
    outs = {o.request_id: o for o in svc.drain()}
    assert outs["poison"].kind == OUTCOME_ERROR
    assert outs["poison"].error_type == "transient"
    assert outs["poison"].attempts == 3
    assert all(outs[i].converged for i in range(3))
    assert metrics.get("serve.requeued.isolated") >= 3
    assert svc.stats()["lost"] == 0


def test_internal_errors_are_typed_and_never_retried():
    def fault(requests, attempts):
        raise RuntimeError("unexpected bug")

    svc, _ = _service(dispatch_fault=fault)
    svc.submit(SolveRequest(request_id=0, problem=P40))
    (out,) = svc.drain()
    assert out.kind == OUTCOME_ERROR and out.error_type == "internal"
    assert out.attempts == 1
    assert metrics.get("serve.retries") == 0


# -- graceful degradation ----------------------------------------------


def test_degradation_ladder_engages_and_is_audible():
    svc, _ = _service(ServicePolicy(
        capacity=12, max_batch=4,
        degradation=DegradationPolicy(shrink_padding_at=0.5,
                                      cap_iterations_at=0.75,
                                      degraded_iteration_cap=10,
                                      downshift_precision_at=0.9)))
    for i in range(11):
        svc.submit(SolveRequest(request_id=i, problem=P40))
    outs = svc.drain()
    partial = [o for o in outs if o.partial]
    # Peak load: one level-3 batch of 4 → capped at 10 iterations.
    assert len(partial) == 4
    assert all(o.flag == "cap_hit" and o.iterations == 10
               for o in partial)
    assert [o.converged for o in outs].count(True) == 7
    assert metrics.get("serve.degraded.padding") >= 2
    assert metrics.get("serve.degraded.iteration_cap") >= 1
    assert metrics.get("serve.degraded.precision") >= 1
    assert svc.stats()["lost"] == 0


# -- batched origin identity (requeue seam) -----------------------------


def test_solve_batched_origin_rides_through_padding():
    from poisson_tpu_torch.solvers.batched import solve_batched

    res = solve_batched(P40, rhs_gates=[1.0, 1.1, 1.2],
                        member_ids=("r-a", "r-b", "r-c"), device="cpu")
    assert res.origin == ("r-a", "r-b", "r-c")
    assert res.w.shape[0] == 3                 # padding sliced off
    # Default identity mapping.
    assert solve_batched(P40, rhs_gates=[1.0, 1.0], device="cpu").origin == (0, 1)
    with pytest.raises(ValueError, match="one id per member"):
        solve_batched(P40, rhs_gates=[1.0, 1.0], member_ids=("only",), device="cpu")


# -- exposition ---------------------------------------------------------


def test_latency_percentiles_export_as_prometheus_summary():
    from poisson_tpu_torch.obs import export

    svc, _ = _service()
    svc.submit(SolveRequest(request_id=0, problem=P40))
    svc.drain()
    text = export.render()
    parsed = export.parse_text(text)
    for q in ("0.5", "0.95", "0.99"):
        key = f'poisson_tpu_serve_latency_seconds{{quantile="{q}"}}'
        assert key in parsed, text
        assert parsed[key]["type"] == "summary"
    assert parsed["poisson_tpu_serve_admitted"]["value"] == 1


# -- CLI ----------------------------------------------------------------


def test_serve_cli_json(capsys):
    from poisson_tpu_torch.cli import main

    assert main(["serve", "--device", "cpu", "40", "40", "--requests", "6", "--vary-rhs",
                 "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["completed"] == 6 and rec["lost"] == 0
    assert set(rec["latency_seconds"]) == {"p50", "p95", "p99"}


def test_serve_cli_fault_drill_table(capsys):
    from poisson_tpu_torch.cli import main

    assert main(["serve", "--device", "cpu", "40", "40", "--requests", "6",
                 "--fault-poison", "1"]) == 0
    out = capsys.readouterr().out
    assert "typed errors" in out and "taxonomy:" in out
    assert "error:transient=1" in out
