"""The port's durable solver sessions (counterpart of
``tests/test_session.py``, on the CPU; -m serve).

- the cold step path is the plain solve, bit for bit;
- a valid warm start cuts iterations; a stale one (family change, drift
  past the bound, nonsense residual) falls back cold audibly;
- every step transition is journaled, so a recovery replays to the
  committed step boundary with the ledger closed and no warm iterate;
- one causal flight tree per session, complete from the emitted JSONL;
- implicit-Euler heat steps contract to the Poisson steady state;
- the seeded session chaos scenarios hold their invariants;
- the session CLI's moving-domain and heat streams.
"""

import numpy as np
import pytest
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry import Ellipse, Rectangle
from poisson_tpu_torch.obs import flight, metrics
from poisson_tpu_torch.obs.trace import load_events
from poisson_tpu_torch.serve import (
    OUTCOME_RESULT,
    ServicePolicy,
    SessionHost,
    SessionPolicy,
    SolveJournal,
    SolveRequest,
    SolveService,
    replay_sessions,
)
from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve
from poisson_tpu_torch.solvers.session import (
    reset_session_cache,
    session_step_solve,
    warm_validity,
)
from poisson_tpu_torch.testing import chaos

pytestmark = [pytest.mark.serve, pytest.mark.session]

P32 = Problem(M=32, N=32)


@pytest.fixture(autouse=True)
def _fresh_registries():
    obs.shutdown()
    metrics.reset()
    reset_session_cache()
    yield
    obs.shutdown()
    metrics.reset()
    reset_session_cache()


def _host(policy=None, session=None, **kw):
    svc = SolveService(policy or ServicePolicy(capacity=32,
                                               session=session
                                               or SessionPolicy()), **kw, device="cpu")
    return SessionHost(svc), svc


# -- cold-path bit-discipline ------------------------------------------


def test_cold_session_path_is_the_historical_solve_byte_identical():
    """What makes warm starts safe to ship: a session step with no
    (valid) warm iterate IS the historical jacobi solve — the same
    iterate bit for bit and the same count (the port's stand-in for the
    JAX suite's program-fingerprint pin) — while a valid warm start runs a
    different trajectory."""
    p = Problem(M=40, N=40)
    hist = pcg_solve(p, dtype="float64", device="cpu")
    cold, info = session_step_solve(p, dtype="float64", device="cpu")
    assert not info["warm_used"]
    assert int(cold.iterations) == int(hist.iterations) == 50
    assert torch.equal(cold.w, hist.w)
    warm, winfo = session_step_solve(p, dtype="float64", warm=hist.w,
                                     device="cpu")
    assert winfo["warm_used"]
    assert int(warm.iterations) < int(hist.iterations)


# -- warm-start gate ----------------------------------------------------


def test_warm_validity_reasons():
    e = Ellipse(cx=0.1)
    assert warm_validity(e, Ellipse(cx=0.1)) == (True, "")
    assert warm_validity(e, Ellipse(cx=0.12)) == (True, "")
    ok, why = warm_validity(e, Ellipse(cx=0.9))
    assert not ok and why == "drift"
    ok, why = warm_validity(Rectangle(x0=-0.5, y0=-0.3, x1=0.5, y1=0.3), e)
    assert not ok and why == "family"
    ok, why = warm_validity(None, e)
    assert not ok and why == "family"


def test_valid_warm_start_cuts_iterations_and_counts_hits():
    spec = Ellipse()
    cold, info = session_step_solve(P32, geometry=spec, device="cpu")
    assert not info["warm_used"] and int(cold.flag) == FLAG_CONVERGED
    w = np.asarray(cold.w)
    warm, info = session_step_solve(
        P32, geometry=Ellipse(cx=5e-4), warm=w, warm_geometry=spec, device="cpu")
    assert info["warm_used"] and info["fallback"] == ""
    assert int(warm.flag) == FLAG_CONVERGED
    assert int(warm.iterations) < int(cold.iterations)
    assert metrics.get("session.warm.hits") == 1
    assert metrics.get("session.warm.fallbacks") == 0
    # warm and cold agree to solver tolerance on the same domain
    again, _ = session_step_solve(P32, geometry=spec, warm=w,
                                  warm_geometry=spec, device="cpu")
    assert np.allclose(np.asarray(again.w), w, atol=1e-5)


@pytest.mark.parametrize("stale, reason", [
    (dict(warm_geometry=Ellipse(cx=0.9)), "drift"),
    (dict(warm_geometry=Rectangle(x0=-0.5, y0=-0.3, x1=0.5, y1=0.3)),
     "family"),
    (dict(warm_geometry=Ellipse(), garbage=True), "residual"),
])
def test_stale_warm_start_falls_back_cold_audibly(stale, reason):
    spec = Ellipse()
    cold, _ = session_step_solve(P32, geometry=spec, device="cpu")
    w = np.asarray(cold.w)
    if stale.pop("garbage", False):
        # a checkerboard at 1e12: in-bounds drift, absurd residual
        i, j = np.indices(w.shape)
        w = np.where((i + j) % 2 == 0, 1e12, -1e12).astype(w.dtype)
    before = metrics.get("session.warm.fallbacks")
    result, info = session_step_solve(P32, geometry=spec, warm=w,
                                      **stale, device="cpu")
    assert not info["warm_used"] and info["fallback"] == reason
    # the fallback solve still answers
    assert int(result.flag) == FLAG_CONVERGED
    assert metrics.get("session.warm.fallbacks") == before + 1
    # a deliberately cold step (no warm offered) is NOT a fallback
    session_step_solve(P32, geometry=spec, device="cpu")
    assert metrics.get("session.warm.fallbacks") == before + 1


# -- the hosted stream --------------------------------------------------


def test_session_stream_warm_chain_through_the_service():
    host, svc = _host()
    sess = host.open("stream", P32, geometry=Ellipse())
    assert sess is not None
    outs = [host.step(sess, geometry=Ellipse(cx=5e-4 * k))
            for k in range(4)]
    assert all(o.kind == OUTCOME_RESULT for o in outs)
    assert metrics.get("session.warm.hits") >= 3
    assert int(outs[-1].iterations) < int(outs[0].iterations)
    summary = host.close(sess)
    assert summary["errors"] == 0 and summary["steps"] == 4
    # ledger invariant: session root + 4 steps, all typed
    snap = metrics.snapshot()["counters"]
    admitted = snap.get("serve.admitted", 0)
    done = (snap.get("serve.completed", 0) + snap.get("serve.errors", 0)
            + snap.get("serve.shed", 0))
    assert admitted == 5 and done == admitted


def test_new_sessions_shed_before_steps_of_inflight_ones():
    host, svc = _host(session=SessionPolicy(max_sessions=1))
    first = host.open("first", P32, geometry=Ellipse())
    assert first is not None
    second = host.open("second", P32, geometry=Ellipse())
    assert second is None  # shed, typed, audible
    assert metrics.get("serve.session.shed_opens") == 1
    # the in-flight stream keeps stepping
    out = host.step(first, geometry=Ellipse())
    assert out.kind == OUTCOME_RESULT
    host.close(first)


def test_session_fields_require_session_semantics_at_admission():
    svc = SolveService(ServicePolicy(capacity=8), device="cpu")
    with pytest.raises(ValueError, match="require session_id"):
        svc.submit(SolveRequest(request_id="r", problem=P32,
                                warm_start=np.zeros((33, 33))))
    with pytest.raises(ValueError, match="require session_id"):
        svc.submit(SolveRequest(request_id="r", problem=P32,
                                mass_shift=2.0))
    with pytest.raises(ValueError, match="fused jacobi session"):
        svc.submit(SolveRequest(request_id="r", problem=P32,
                                session_id="s", session_step=0,
                                preconditioner="mg"))
    with pytest.raises(ValueError, match="drop chunk"):
        svc.submit(SolveRequest(request_id="r", problem=P32,
                                session_id="s", session_step=0,
                                chunk=16))


# -- implicit-Euler heat stream -----------------------------------------


def test_heat_steps_contract_to_the_poisson_steady_state():
    spec = Ellipse()
    steady = np.asarray(pcg_solve(P32, geometry=spec, device="cpu").w)
    host, svc = _host()
    sess = host.open("heat", P32, kind="heat", mass_shift=1.0,
                     geometry=spec)
    errs = []
    for _ in range(6):
        out = host.step(sess)
        assert out.kind == OUTCOME_RESULT
        errs.append(float(np.linalg.norm(
            np.asarray(sess.warm) - steady)))
    host.close(sess)
    # monotone contraction onto the steady state, and close by the end
    assert all(b < a for a, b in zip(errs, errs[1:]))
    assert errs[-1] < 2e-2 * errs[0]


# -- journal replay & crash recovery ------------------------------------


def test_recovery_replays_to_the_committed_step_boundary(tmp_path):
    jpath = str(tmp_path / "session.journal")
    host, svc = _host(
        policy=ServicePolicy(capacity=32, session=SessionPolicy()),
        journal=SolveJournal(jpath), seed=0)
    sess = host.open("crashy", P32, geometry=Ellipse())
    for k in range(3):
        out = host.step(sess, geometry=Ellipse(cx=5e-4 * k))
        assert out.kind == OUTCOME_RESULT
    del host, svc  # the "crash": process memory (warm iterate) is gone

    rep = replay_sessions(jpath)["crashy"]
    # steps_submitted is the highest step INDEX the journal saw
    assert rep.last_advanced == 2 and rep.steps_submitted == 2
    assert not rep.closed

    svc2 = SolveService.recover(SolveJournal(jpath),
                                ServicePolicy(capacity=32), seed=0, device="cpu")
    host2 = SessionHost(svc2)
    recovered = host2.recover()
    assert [s.session_id for s in recovered] == ["crashy"]
    s2 = recovered[0]
    assert s2.next_step == 3          # continue AFTER the boundary
    assert s2.generation == 2
    assert s2.warm is None            # never resumed from dead state
    assert metrics.get("session.recovered") == 1
    before = metrics.get("session.warm.fallbacks")
    out = host2.step(s2, geometry=Ellipse(cx=5e-4 * 3))
    assert out.kind == OUTCOME_RESULT
    # the first post-recovery step ran COLD (no warm was offered, so
    # no fallback was counted either — cold by construction, not gate)
    assert metrics.get("session.warm.fallbacks") == before
    summary = host2.close(s2)
    assert summary["errors"] == 0 and summary["steps"] == 4


def test_second_crash_bumps_the_generation_again(tmp_path):
    jpath = str(tmp_path / "session.journal")
    host, svc = _host(
        policy=ServicePolicy(capacity=32, session=SessionPolicy()),
        journal=SolveJournal(jpath), seed=0)
    sess = host.open("twice", P32, geometry=Ellipse())
    host.step(sess)
    del host, svc
    svc2 = SolveService.recover(SolveJournal(jpath),
                                ServicePolicy(capacity=32), seed=0, device="cpu")
    h2 = SessionHost(svc2)
    (s2,) = h2.recover()
    h2.step(s2)
    del h2, svc2
    svc3 = SolveService.recover(SolveJournal(jpath),
                                ServicePolicy(capacity=32), seed=0, device="cpu")
    h3 = SessionHost(svc3)
    (s3,) = h3.recover()
    assert s3.generation == 3 and s3.next_step == 2
    out = h3.step(s3)
    assert out.kind == OUTCOME_RESULT
    h3.close(s3)


# -- one causal tree per session ----------------------------------------


def test_session_flight_trace_is_one_complete_tree(tmp_path):
    obs.configure(trace_dir=str(tmp_path))
    host, svc = _host()
    sess = host.open("traced", P32, geometry=Ellipse())
    for k in range(3):
        host.step(sess, geometry=Ellipse(cx=5e-4 * k))
    summary = host.close(sess)
    obs.finalize()
    events = load_events(str(tmp_path))
    report = flight.validate_events(events)
    assert report["complete"], report["problems"]
    tid, recs = flight.find_trace(events, trace_id=summary["trace_id"])
    assert tid is not None
    assert flight.validate_trace(recs) == []
    points = [r for r in recs
              if r.get("point") == flight.POINT_SESSION_STEP]
    assert [p.get("step") for p in points] == [0, 1, 2]
    assert summary["decomposition"]["wall_s"] >= 0.0


# -- chaos invariants ---------------------------------------------------


def test_session_chaos_scenarios_are_registered():
    names = chaos.scenario_names()
    for required in ("session-kill-recover-subprocess",
                     "session-stale-warm-start",
                     "session-device-loss-reroute"):
        assert required in names


def test_chaos_stale_warm_start_invariants():
    report = chaos.run_scenario("session-stale-warm-start", seed=0, device="cpu")
    assert report["ok"], report
    assert report["invariant"]["lost"] == 0


def test_chaos_device_loss_reroute_invariants():
    report = chaos.run_scenario("session-device-loss-reroute", seed=0, device="cpu")
    assert report["ok"], report
    assert report["invariant"]["lost"] == 0


# -- the session CLI ----------------------------------------------------
# (In place of the JAX suite's bench-sentinel cohort pins: the port has
# no bench session mode yet, so its session record is the CLI's.)


def _session_cli(capsys, *extra):
    import json

    from poisson_tpu_torch.cli import main

    rc = main(["session", "40", "40", "--steps", "4", "--json",
               "--device", "cpu", *extra])
    return rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_session_cli_moving_domain_stream(capsys):
    """The moving-domain stream: every step a result, the drifts inside
    the warm bound warm-start, nothing lost."""
    rc, rec = _session_cli(capsys)
    assert rc == 0
    assert rec["kind"] == "poisson" and rec["steps_run"] == 4
    assert rec["results"] == 4 and rec["errors"] == 0 and rec["lost"] == 0
    assert rec["warm_hits"] >= 1 and rec["warm_fallbacks"] == 0


def test_session_cli_heat_stream(capsys):
    """The implicit-Euler heat stream through the same CLI."""
    rc, rec = _session_cli(capsys, "--heat", "--dt", "0.05")
    assert rc == 0
    assert rec["kind"] == "heat" and rec["results"] == 4
    assert rec["lost"] == 0 and rec["slo_good"] in (True, False)
