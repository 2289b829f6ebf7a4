"""Port parity: the heartbeat watchdog (``poisson_tpu_torch.parallel.
watchdog``) against ``poisson_tpu.parallel.watchdog`` (JAX's
tests/test_watchdog.py:25-112 on the port), on the CPU.

The heartbeat file, the stall diagnostics and ``SolveTimeout`` carry the
JAX package's keys; the chunked and resilient solves beat once per chunk,
with the JAX drivers' progress keys.
"""

import json
import os
import time

import pytest

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.parallel import watchdog as jax_watchdog
from poisson_tpu.solvers import resilient as jax_resilient
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.parallel.watchdog import SolveTimeout, Watchdog
from poisson_tpu_torch.solvers.checkpoint import pcg_solve_checkpointed
from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient


@pytest.fixture(autouse=True)
def _fresh():
    metrics.reset()
    yield
    metrics.reset()


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return predicate()


@pytest.mark.parametrize("package", ["port", "jax"])
def test_heartbeat_file_written_atomically(tmp_path, package):
    cls = Watchdog if package == "port" else jax_watchdog.Watchdog
    hb = str(tmp_path / "hb.json")
    wd = cls(heartbeat_path=hb)
    with wd:
        wd.beat(k=42, diff=1e-3)
        payload = json.loads(open(hb).read())
    assert payload["k"] == 42
    assert payload["beats"] == 1
    assert payload["pid"] == os.getpid()
    assert [f for f in os.listdir(tmp_path) if ".tmp" in f] == []


def test_heartbeat_keys_equal_jax_s(tmp_path):
    payloads = []
    for cls in (Watchdog, jax_watchdog.Watchdog):
        hb = str(tmp_path / f"{cls.__module__}.json")
        with cls(heartbeat_path=hb) as wd:
            wd.beat(k=7, diff=0.5, dtype="float32", restarts=0)
        payloads.append(json.loads(open(hb).read()))
    assert set(payloads[0]) == set(payloads[1])
    assert {k: payloads[0][k] for k in ("beats", "k", "diff", "dtype",
                                         "restarts", "pid")} == \
        {k: payloads[1][k] for k in ("beats", "k", "diff", "dtype",
                                      "restarts", "pid")}
    assert metrics.get("watchdog.beats") == 1


def test_regular_beats_keep_the_monitor_quiet():
    fired = []
    wd = Watchdog(timeout=0.3, poll_interval=0.05, on_timeout=fired.append)
    with wd:
        for _ in range(8):
            time.sleep(0.05)
            wd.beat()
    assert not wd.fired
    assert fired == []


def test_stall_fires_timeout_with_jax_s_diagnostics(tmp_path):
    diags = []
    for cls in (Watchdog, jax_watchdog.Watchdog):
        hb = str(tmp_path / f"{cls.__module__}.json")
        fired = []
        wd = cls(heartbeat_path=hb, timeout=0.15, poll_interval=0.03,
                 on_timeout=fired.append)
        with wd:
            wd.beat(k=7, diff=0.5)
            assert _wait_for(lambda: wd.fired)
        diag = fired[0]
        assert diag["timeout_seconds"] == 0.15
        assert diag["elapsed_seconds"] >= 0.15
        assert diag["last_progress"] == {"k": 7, "diff": 0.5}
        stalled = json.loads(open(hb + ".stalled.json").read())
        assert stalled["last_progress"]["k"] == 7
        diags.append(diag)
    assert set(diags[0]) == set(diags[1])
    assert metrics.get("watchdog.stalls") == 1


def test_timeout_fires_once_and_stop_joins():
    fired = []
    wd = Watchdog(timeout=0.1, poll_interval=0.02, on_timeout=fired.append)
    wd.start()
    assert _wait_for(lambda: wd.fired)
    time.sleep(0.15)
    wd.stop()
    assert len(fired) == 1


def test_raise_if_fired_converts_to_solve_timeout():
    wd = Watchdog(timeout=0.1, poll_interval=0.02, on_timeout=lambda d: None)
    wd.raise_if_fired()
    with wd:
        assert _wait_for(lambda: wd.fired)
    with pytest.raises(SolveTimeout) as exc_info:
        wd.raise_if_fired()
    assert exc_info.value.diagnostics["timeout_seconds"] == 0.1
    jax_wd = jax_watchdog.Watchdog(timeout=0.1, poll_interval=0.02,
                                   on_timeout=lambda d: None)
    with jax_wd:
        assert _wait_for(lambda: jax_wd.fired)
    with pytest.raises(jax_watchdog.SolveTimeout) as jax_info:
        jax_wd.raise_if_fired()
    assert str(exc_info.value).split("(")[0] == \
        str(jax_info.value).split("(")[0]


def test_check_fires_once_on_an_injected_clock(tmp_path):
    now = {"t": 0.0}
    wd = Watchdog(heartbeat_path=str(tmp_path / "hb.json"), timeout=1.0,
                  clock=lambda: now["t"])
    wd._last_beat = 0.0
    assert wd.check() is None
    now["t"] = 2.0
    diag = wd.check()
    assert diag["elapsed_seconds"] == 2.0 and wd.check() is None


def test_watchdog_wired_into_chunked_solver(tmp_path):
    hb = str(tmp_path / "hb.json")
    fired = []
    wd = Watchdog(heartbeat_path=hb, timeout=300.0, on_timeout=fired.append)
    res = pcg_solve_checkpointed(Problem(M=40, N=40),
                                 str(tmp_path / "ck.npz"), chunk=10,
                                 watchdog=wd, device="cpu")
    assert int(res.iterations) == 50
    assert fired == []
    payload = json.loads(open(hb).read())
    assert payload["beats"] >= 5
    assert payload["k"] == 50
    assert wd._thread is None


def test_resilient_beats_carry_jax_s_progress_keys(tmp_path):
    beats = []
    for name, solve, problem, cls, extra in (
            ("port", pcg_solve_resilient, Problem(M=40, N=40), Watchdog,
             {"device": "cpu"}),
            ("jax", jax_resilient.pcg_solve_resilient,
             JaxProblem(M=40, N=40), jax_watchdog.Watchdog, {})):
        hb = str(tmp_path / f"{name}.json")
        res = solve(problem, chunk=10, watchdog=cls(heartbeat_path=hb),
                    **extra)
        beats.append((int(res.iterations), json.loads(open(hb).read())))
    (k, port), (jax_k, jax) = beats
    assert k == jax_k == port["k"] == jax["k"] == 50
    assert set(port) == set(jax)
    assert port["beats"] == jax["beats"] == 5
    assert port["dtype"] == jax["dtype"] and port["restarts"] == 0


def test_stalled_resilient_solve_raises_solve_timeout(tmp_path):
    """The default on_timeout interrupts the main thread; the resilient
    driver turns the interrupt into SolveTimeout with the diagnostics."""
    hb = str(tmp_path / "hb.json")
    wd = Watchdog(heartbeat_path=hb, timeout=0.3, poll_interval=0.02)
    with pytest.raises(SolveTimeout) as exc_info:
        pcg_solve_resilient(Problem(M=40, N=40), chunk=10, watchdog=wd,
                            device="cpu",
                            on_chunk=lambda s, n: time.sleep(2.0))
    diag = exc_info.value.diagnostics
    assert diag["timeout_seconds"] == 0.3
    assert diag["last_progress"]["k"] == 10
    assert os.path.exists(hb + ".stalled.json")
