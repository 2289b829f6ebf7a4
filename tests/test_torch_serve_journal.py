"""State carried across the packages (on the CPU; -m serve): the solve
service's journal directory (the write-ahead journal and the forecast and
roofline snapshots beside it) is the state one package's service hands the
other's.

- A directory the JAX service wrote, crashed mid-run, recovers in the
  port's ``SolveService.recover`` to JAX's own recovery: the same pending
  ids, the same prior outcomes, the same finished outcomes.
- A journal the port wrote replays in JAX's ``replay_journal`` to the
  port's ``JournalReplay``, and the other way round; likewise
  ``replay_sessions`` for a session stream.
"""

import dataclasses
import importlib
import json
import shutil

import jax
import pytest

pytestmark = pytest.mark.serve

FIELDS = ("request_id", "kind", "flag", "converged", "partial",
          "iterations", "restarts", "attempts", "latency_seconds",
          "error_type", "shed_reason", "decomposition")
REQUEST_FIELDS = ("request_id", "rhs_gate", "dtype", "deadline_seconds",
                  "chunk", "tenant", "device_id", "session_id",
                  "session_step", "mass_shift")


def _pkg(pkg):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return (mod("serve"), mod("testing.chaos"), mod("config").Problem,
            mod("obs.metrics"), mod("serve.journal"))


def _kw(pkg):
    return {"device": "cpu"} if pkg == "poisson_tpu_torch" else {}


def _policy(serve):
    return serve.ServicePolicy(
        capacity=32, max_batch=2, scheduling="continuous", refill_chunk=10,
        degradation=serve.DegradationPolicy(
            shrink_padding_at=9.0, cap_iterations_at=9.0,
            downshift_precision_at=9.0),
        forecast=serve.ForecastPolicy())


def _crash(pkg, path, n=7, pumps=8):
    """Admit n requests into ``pkg``'s journaled service, run ``pumps``
    steps of its loop (each dispatch takes 10 ms on the virtual clock, so
    the roofline measures it) and abandon the process state."""
    serve, chaos, Problem, metrics, _ = _pkg(pkg)
    metrics.reset()
    vc = chaos.VirtualClock()
    svc = serve.SolveService(
        _policy(serve), clock=vc, sleep=vc.sleep, seed=0,
        journal=serve.SolveJournal(path, clock=vc),
        dispatch_fault=lambda reqs, attempts: vc.advance(0.01), **_kw(pkg))
    for i in range(n):
        svc.submit(serve.SolveRequest(request_id=i, problem=Problem(M=40, N=40),
                                      rhs_gate=1.0 + i / n))
    for _ in range(pumps):
        svc.pump()
    return vc()


def _recover(pkg, path, t0):
    """``pkg``'s recovery of the journal at ``path``: (pending ids, prior
    outcomes, finished outcomes, snapshot loads)."""
    serve, chaos, _, metrics, _ = _pkg(pkg)
    metrics.reset()
    vc = chaos.VirtualClock(start=t0)
    svc = serve.SolveService.recover(
        serve.SolveJournal(path, clock=vc), _policy(serve), clock=vc,
        sleep=vc.sleep, seed=0, **_kw(pkg))
    pending = [str(p.request.request_id) for p in svc.recovery.pending]
    prior = {str(k): o.kind for k, o in svc._prior_outcomes.items()}
    svc.drain()
    finished = [tuple(getattr(o, f) for f in FIELDS)
                for o in svc.outcomes()]
    loads = (metrics.get("obs.forecast.snapshot.loads"),
             metrics.get("obs.roofline.snapshot.loads"))
    assert svc.stats()["lost"] == 0
    return pending, prior, finished, loads


def _normal(replay):
    """A JournalReplay as plain data (the two packages' SolveRequest
    classes differ; their fields do not)."""
    out = {f.name: getattr(replay, f.name)
           for f in dataclasses.fields(replay) if f.name != "pending"}
    out["pending"] = [
        {**{f.name: getattr(p, f.name) for f in dataclasses.fields(p)
            if f.name != "request"},
         "request": {k: getattr(p.request, k) for k in REQUEST_FIELDS},
         "problem": repr(p.request.problem)}
        for p in replay.pending]
    return out


def test_jax_journal_dir_recovers_in_the_port(tmp_path):
    assert jax.config.jax_enable_x64   # the JAX suite's environment
    path = str(tmp_path / "jax" / "serve.journal")
    (tmp_path / "jax").mkdir()
    t0 = _crash("poisson_tpu", path)
    copy = tmp_path / "copy"
    shutil.copytree(tmp_path / "jax", copy)
    names = sorted(p.name for p in copy.iterdir())
    assert len(names) == 3   # the journal and the two snapshots
    ref = _recover("poisson_tpu", path, t0)
    got = _recover("poisson_tpu_torch", str(copy / "serve.journal"), t0)
    pending, prior, finished, loads = got
    assert pending and prior               # a real mid-run crash
    assert pending == ref[0]
    assert prior == ref[1]
    assert finished == ref[2]
    assert loads == ref[3] == (1, 1)       # both snapshots warm-loaded


@pytest.mark.parametrize("writer,reader", [
    ("poisson_tpu_torch", "poisson_tpu"),
    ("poisson_tpu", "poisson_tpu_torch"),
])
def test_journal_replays_the_same_in_both_packages(tmp_path, writer,
                                                   reader):
    path = str(tmp_path / "serve.journal")
    _crash(writer, path)
    mine = _pkg(writer)[4].replay_journal(path)
    theirs = _pkg(reader)[4].replay_journal(path)
    assert mine.pending and mine.outcomes
    assert _normal(theirs) == _normal(mine)


def test_both_packages_write_the_same_journal(tmp_path):
    """The same crashed run writes the same records in both packages,
    line for line: only the trace ids (process-unique) and the seals that
    cover them differ."""
    a, b = str(tmp_path / "a.journal"), str(tmp_path / "b.journal")
    _crash("poisson_tpu", a)
    _crash("poisson_tpu_torch", b)

    def records(path):
        out = []
        for line in open(path):
            rec = json.loads(line)
            rec.pop("trace_id", None)
            if "trace_id" in line:
                rec.pop("crc32")
            out.append(rec)
        return out

    ref, got = records(a), records(b)
    assert len(got) == len(ref) > 8
    assert got == ref
    assert got[0]["kind"] == "topology" and got[0]["kinds"] == ["cpu"]


def _session_journal(pkg, path, steps=4, run=3):
    serve, chaos, Problem, metrics, _ = _pkg(pkg)
    from_dsl = importlib.import_module(f"{pkg}.geometry.dsl")
    metrics.reset()
    vc = chaos.VirtualClock()
    svc = serve.SolveService(clock=vc, sleep=vc.sleep, seed=0,
                             journal=serve.SolveJournal(path, clock=vc),
                             **_kw(pkg))
    host = serve.SessionHost(svc)
    sess = host.open("s", Problem(M=40, N=40), kind="poisson",
                     geometry=from_dsl.Ellipse(), params={"steps": steps})
    for k in range(run):
        host.step(sess, geometry=from_dsl.Ellipse(cx=5e-4 * (k + 1)))


@pytest.mark.parametrize("writer,reader", [
    ("poisson_tpu_torch", "poisson_tpu"),
    ("poisson_tpu", "poisson_tpu_torch"),
])
def test_session_journal_replays_the_same_in_both_packages(tmp_path,
                                                           writer, reader):
    path = str(tmp_path / "session.journal")
    _session_journal(writer, path)
    mine = _pkg(writer)[4].replay_sessions(path)
    theirs = _pkg(reader)[4].replay_sessions(path)
    assert list(mine) == ["s"] and mine["s"].last_advanced == 2
    assert {k: dataclasses.asdict(v) for k, v in theirs.items()} \
        == {k: dataclasses.asdict(v) for k, v in mine.items()}
    # and the request-level replay of the same file
    assert _normal(_pkg(reader)[4].replay_journal(path)) \
        == _normal(_pkg(writer)[4].replay_journal(path))


@pytest.mark.parametrize("scheduling", ["drain", "continuous"])
def test_port_flight_trace_loads_in_the_jax_reader(tmp_path, scheduling):
    """The flight recorder's JSONL is the JAX package's: a trace
    directory the port's service wrote validates in JAX's reader, one
    complete causal trace per admitted request."""
    from poisson_tpu.obs import flight as jax_flight
    from poisson_tpu.obs.trace import load_events as jax_load_events
    from poisson_tpu_torch import obs

    serve, chaos, Problem, metrics, _ = _pkg("poisson_tpu_torch")
    metrics.reset()
    obs.configure(trace_dir=str(tmp_path))
    try:
        vc = chaos.VirtualClock()
        svc = serve.SolveService(
            serve.ServicePolicy(max_batch=2, scheduling=scheduling,
                                refill_chunk=10),
            clock=vc, sleep=vc.sleep, device="cpu")
        for i in range(5):
            svc.submit(serve.SolveRequest(request_id=i,
                                          problem=Problem(M=40, N=40),
                                          rhs_gate=1.0 + i / 5))
        svc.drain()
        obs.finalize()
    finally:
        obs.shutdown()
    report = jax_flight.validate_events(jax_load_events(str(tmp_path)))
    assert report["complete"] and report["traces"] == 5
    tid, records = jax_flight.find_trace(jax_load_events(str(tmp_path)),
                                         request_id="3")
    assert tid is not None and not jax_flight.validate_trace(records)
