"""Port parity: ``poisson_tpu_torch.parallel.multihost.initialize_multihost``
against the JAX package's, on the CPU.

The first cases are the twins of ``TestMultihostRetry``
(``tests/test_watchdog.py``) and of ``tests/test_multihost.py``'s
single-process cases, with ``torch.distributed.init_process_group``
monkeypatched (no real cluster): transient failures are retried with the
JAX package's seeded, jittered backoff (the same delays for the same seed,
checked against JAX's function with ``jax.distributed.initialize``
monkeypatched), an env-driven init that never connects degrades to one
process, an explicit cluster that never connects raises, and ordering
errors are not retried. The last case forms a real two-process group: a
mesh built before the group formed is refused by the solvers.
"""

import os
import pathlib
import socket
import subprocess
import sys
import warnings

import jax
import pytest
import torch.distributed as dist

import poisson_tpu.parallel.multihost as jax_mh
import poisson_tpu_torch.parallel.multihost as mh
from poisson_tpu_torch.obs import metrics

_ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def multihost(monkeypatch):
    monkeypatch.setattr(mh, "_initialized", False)
    return mh


def _flaky(fail_times: int, message: str, calls: dict):
    def init(**kw):
        calls["n"] += 1
        calls["kw"] = kw
        if calls["n"] <= fail_times:
            raise RuntimeError(message)
    return init


def _schedule(module, monkeypatch, seed, fail_times=2, **kw):
    """The delays ``module.initialize_multihost`` sleeps through when its
    init fails ``fail_times`` times with a connection error."""
    calls = {"n": 0}
    init = _flaky(fail_times, "connection refused by coordinator", calls)
    if module is mh:
        monkeypatch.setattr(dist, "init_process_group", init)
    else:
        monkeypatch.setattr(jax.distributed, "initialize", init)
    monkeypatch.setattr(module, "_initialized", False)
    naps = []
    with pytest.warns(RuntimeWarning, match="retry"):
        rank = module.initialize_multihost(sleep=naps.append, seed=seed,
                                           **kw)
    assert rank == 0
    assert calls["n"] == fail_times + 1
    return naps


def test_transient_failure_retries_then_succeeds(multihost, monkeypatch):
    before = metrics.get("multihost.init_retries")
    naps = _schedule(mh, monkeypatch, seed=0, backoff_seconds=0.1)
    assert metrics.get("multihost.init_retries") == before + 2
    # Exponential backoff with seeded jitter over [1 - jitter, 1].
    assert len(naps) == 2
    for delay, envelope in zip(naps, (0.1, 0.2)):
        assert envelope * 0.5 <= delay <= envelope
    assert _schedule(mh, monkeypatch, seed=0, backoff_seconds=0.1) == naps
    assert _schedule(mh, monkeypatch, seed=1, backoff_seconds=0.1) != naps


@pytest.mark.parametrize("seed,fail_times,kw", [
    (0, 2, {"backoff_seconds": 0.1}),
    (7, 3, {}),
    (12345, 3, {"backoff_seconds": 0.5, "jitter": 0.25}),
])
def test_retry_schedule_equals_jax(monkeypatch, seed, fail_times, kw):
    port = _schedule(mh, monkeypatch, seed, fail_times, **kw)
    ref = _schedule(jax_mh, monkeypatch, seed, fail_times, **kw)
    assert port == ref


def test_env_driven_exhaustion_degrades_to_single_host(multihost,
                                                       monkeypatch):
    def always_down(**kw):
        raise RuntimeError("deadline exceeded connecting to coordinator")

    before = metrics.get("multihost.degraded")
    monkeypatch.setattr(dist, "init_process_group", always_down)
    with pytest.warns(RuntimeWarning, match="single-host"):
        rank = multihost.initialize_multihost(
            max_retries=2, backoff_seconds=0.01, sleep=lambda s: None)
    assert rank == 0
    assert metrics.get("multihost.degraded") == before + 1


def test_explicit_cluster_exhaustion_raises(multihost, monkeypatch):
    def always_down(**kw):
        raise RuntimeError("connection timed out")

    monkeypatch.setattr(dist, "init_process_group", always_down)
    with pytest.raises(RuntimeError, match="timed out"), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore")
        multihost.initialize_multihost(
            coordinator="10.0.0.1:1234", num_processes=4, process_id=1,
            max_retries=1, backoff_seconds=0.01, sleep=lambda s: None)


def test_config_errors_do_not_retry(multihost, monkeypatch):
    calls = {"n": 0}

    def bad_order(**kw):
        calls["n"] += 1
        raise RuntimeError("the process group must be formed before any "
                           "backend is used")

    monkeypatch.setattr(dist, "init_process_group", bad_order)
    with pytest.raises(RuntimeError, match="ordering mistake is not "
                                           "retried"):
        multihost.initialize_multihost()
    assert calls["n"] == 1


def test_explicit_cluster_arguments(multihost, monkeypatch):
    """A coordinator forms a TCP rendezvous with a bounded timeout; with
    no card the backend is gloo."""
    calls = {"n": 0}
    monkeypatch.setattr(dist, "init_process_group", _flaky(0, "", calls))
    assert multihost.initialize_multihost(
        coordinator="127.0.0.1:29511", num_processes=2, process_id=1) == 0
    assert calls["kw"] == {"backend": "gloo",
                           "init_method": "tcp://127.0.0.1:29511",
                           "world_size": 2, "rank": 1,
                           "timeout": mh.RENDEZVOUS_TIMEOUT}
    # The documented no-op on a second call: init is not called again.
    assert multihost.initialize_multihost() == 0
    assert calls["n"] == 1


def test_no_cluster_is_a_quiet_single_process_run(multihost, monkeypatch):
    """No cluster in the environment: rank 0, no warning, primary."""
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert multihost.initialize_multihost() == 0
    assert multihost.is_primary()
    assert not dist.is_initialized()
    assert multihost.initialize_multihost() == 0


def test_group_formed_elsewhere_is_kept(multihost, monkeypatch):
    def never(**kw):
        raise AssertionError("init_process_group called again")

    monkeypatch.setattr(dist, "init_process_group", never)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a, **k: 3)
    assert multihost.initialize_multihost() == 3
    assert not multihost.is_primary()


@pytest.mark.parametrize("message", [
    "connection refused by coordinator", "Connection reset by peer",
    "deadline exceeded", "timed out after 60000ms", "service unavailable",
    "temporary failure in name resolution", "barrier timeout",
    "already initialized", "can only be called once",
    "must be called before any backend", "invalid rank 5",
])
def test_transient_markers_equal_jax(message):
    assert mh._is_transient(message) == jax_mh._is_transient(message)


_LATE = """
import sys, torch
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.parallel import (
    fused_cg_solve_sharded_checkpointed, make_solver_mesh, pcg_solve_sharded)
from poisson_tpu_torch.parallel.multihost import initialize_multihost

early = make_solver_mesh(["cpu"] * 2)       # before the group formed
rank = initialize_multihost(coordinator=sys.argv[1], num_processes=2,
                            process_id=int(sys.argv[2]))
for solve in (lambda: pcg_solve_sharded(Problem(M=8, N=8), early),
              lambda: fused_cg_solve_sharded_checkpointed(
                  Problem(M=8, N=8), early, sys.argv[3] + str(rank))):
    try:
        solve()
    except RuntimeError as e:
        assert "built before initialize_multihost()" in str(e), str(e)
    else:
        raise SystemExit("a mesh built before the group was accepted")
assert "jax" not in sys.modules
print(f"RANK{rank}_DIAG_OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_mesh_built_before_the_group_is_diagnosed(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(_ROOT), OMP_NUM_THREADS="1")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LATE, coord, str(r), str(tmp_path / "ck")],
        cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120))
    finally:
        for proc in procs:
            proc.kill()
    for rank, (proc, (out, err)) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0, err[-3000:]
        assert f"RANK{rank}_DIAG_OK" in out, (out, err[-1000:])
