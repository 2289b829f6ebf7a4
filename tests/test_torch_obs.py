"""Port parity: the obs core (``poisson_tpu_torch.obs``: counters, spans,
events) against ``poisson_tpu.obs``, on the CPU.

A trace directory or snapshot written by either package loads with the
other's readers (``metrics.load_dir``, ``trace.load_events``,
``merge_trace_dir``), and the counters, events and spans that the JAX
package emits on the paths the port has (checkpoints, the CLI's report,
``PhaseTimer``) come out of the port by the same names and, on the same
calls, with the same values.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu import obs as jax_obs
from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.obs import trace as jax_trace
from poisson_tpu.solvers import checkpoint as jax_checkpoint
from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics, trace
from poisson_tpu_torch.parallel.checkpoint_sharded import (
    pcg_solve_sharded_checkpointed,
)
from poisson_tpu_torch.parallel.mesh import make_solver_mesh
from poisson_tpu_torch.solvers import checkpoint
from poisson_tpu_torch.utils.timing import PhaseTimer, count_solve

ROOT = Path(__file__).resolve().parents[1]
CHECKPOINT_COUNTERS = ("checkpoint.writes", "checkpoint.corrupt",
                       "checkpoint.crc_failures",
                       "checkpoint.generation_fallbacks",
                       "checkpoint.deadline_stops")


@pytest.fixture(autouse=True)
def _fresh_registries():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    for reg in (metrics, jax_metrics):
        reg.reset()
    yield
    obs.shutdown()
    jax_obs.shutdown()
    for reg in (metrics, jax_metrics):
        reg.reset()
    torch.set_num_threads(saved)


def test_counters_gauges_and_snapshot():
    obs.inc("a.b")
    obs.inc("a.b", 2.5)
    obs.gauge("g", 7)
    assert metrics.get("a.b") == 3.5 and metrics.get("missing") == 0
    snap = metrics.snapshot(rank=3)
    assert snap["schema"] == jax_metrics.snapshot()["schema"]
    assert set(snap) == set(jax_metrics.snapshot())
    assert snap["counters"] == {"a.b": 3.5} and snap["gauges"] == {"g": 7}
    merged = metrics.merge([snap, dict(snap, rank=4)])
    assert merged["counters"] == {"a.b": 7.0}
    assert set(merged["gauges_by_rank"]) == {"3", "4"}
    assert merged == jax_metrics.merge([snap, dict(snap, rank=4)])
    metrics.reset()
    assert metrics.get("a.b") == 0


def _write_dir(package, path, rank):
    package.configure(trace_dir=str(path), rank=rank)
    package.metrics.inc("checkpoint.writes", 2)
    package.metrics.gauge("batched.last_bucket", 8)
    with package.span("outer", fence=False, kind="collides"):
        with package.span("inner", tag=1):
            package.event("solve.report", iterations=50, rank="mine")
    package.shutdown()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_trace_dir_loads_with_the_other_package_s_readers(writer,
                                                            tmp_path):
    _write_dir(obs if writer == "port" else jax_obs, tmp_path, rank=0)
    _write_dir(jax_obs if writer == "port" else obs, tmp_path, rank=1)
    for m, t in ((metrics, trace), (jax_metrics, jax_trace)):
        merged = m.load_dir(str(tmp_path))
        assert merged["counters"] == {"checkpoint.writes": 4}
        assert merged["ranks"] == [0, 1]
        assert merged["gauges_by_rank"]["0"] == {"batched.last_bucket": 8}
        events = t.load_events(str(tmp_path))
        names = [(e["kind"], e["name"], e["rank"]) for e in events]
        for rank in (0, 1):
            for rec in (("span_begin", "outer", rank),
                        ("span_end", "inner", rank),
                        ("event", "solve.report", rank)):
                assert rec in names
        report = [e for e in events if e["name"] == "solve.report"]
        assert {e["attrs"]["rank"] for e in report} == {"mine"}
        assert {e["iterations"] for e in report} == {50}
        inner = [e for e in events if e["kind"] == "span_end"
                 and e["name"] == "inner"]
        assert {e["span_path"] for e in inner} == {"outer/inner"}
        doc = t.merge_trace_dir(str(tmp_path),
                                str(tmp_path / f"merged-{t.__name__}.json"))
        assert doc["otherData"]["event_kinds"] == {"X": 4, "i": 2}
        assert sorted(doc["otherData"]["ranks"]) == [0, 1]


def test_v1_event_lines_and_torn_tails_load(tmp_path):
    v1 = {"at_unix": 1.0, "at_mono": 1.0, "rank": 0, "kind": "event",
          "name": "old", "k": 3}
    with open(tmp_path / "events-rank0.jsonl", "w") as f:
        f.write(json.dumps(v1) + "\n" + '{"torn": ')
    events = trace.load_events(str(tmp_path))
    assert events == [v1] == jax_trace.load_events(str(tmp_path))
    rec = {"schema": 2, "name": "n", "kind": "event", "attrs": {"kind": "x",
                                                              "k": 1}}
    assert trace.normalize_event(rec) == jax_trace.normalize_event(rec)


def test_unconfigured_spans_and_events_are_no_ops():
    with obs.span("nothing"):
        pass
    obs.event("dropped")
    assert obs.recent_events() == []
    obs.finalize()


def test_span_fences_its_device_and_records_seconds(tmp_path):
    rec = obs.configure(trace_dir=str(tmp_path), rank=0)
    with obs.span("cpu work", device="cpu") as s:
        torch.ones(4).sum()
    with obs.span("default device"):
        pass
    assert s.seconds >= 0
    ends = [e for e in obs.recent_events() if e["kind"] == "span_end"]
    assert [e["name"] for e in ends] == ["cpu work", "default device"]
    assert [e["name"] for e in rec.trace_events()] == ["cpu work",
                                                      "default device"]
    trace.device_fence("cpu")          # nothing to wait for on the CPU


def test_configure_from_env(tmp_path, monkeypatch):
    monkeypatch.delenv("POISSON_TPU_TRACE_DIR", raising=False)
    monkeypatch.delenv("POISSON_TPU_METRICS_OUT", raising=False)
    assert obs.configure_from_env() is None
    monkeypatch.setenv("POISSON_TPU_METRICS_OUT", str(tmp_path / "m.json"))
    assert obs.configure_from_env() is not None
    obs.inc("x")
    obs.finalize()
    snap = json.loads((tmp_path / "m.json").read_text())
    assert snap["counters"] == {"x": 1}


def _checkpoint_counters(registry):
    return {name: registry.get(name) for name in CHECKPOINT_COUNTERS}


def _corrupt_drill(solve, path):
    """Writes, then a truncated newest file (corrupt + fallback), then a
    payload that fails its CRC, each resumed by ``solve``."""
    solve(path, keep=True)
    with open(path, "r+b") as f:
        f.truncate(100)
    solve(path, keep=True)
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["w"] = arrays["w"] + 1.0
    np.savez(path.removesuffix(".npz"), **arrays)
    solve(path, keep=True)


def test_checkpoint_counters_match_jax_on_the_same_drill(tmp_path):
    p, jp = Problem(M=40, N=40), JaxProblem(M=40, N=40)

    def port(path, keep):
        checkpoint.pcg_solve_checkpointed(p, path, chunk=20, keep_last=2,
                                          dtype="float64", device="cpu",
                                          keep_checkpoint=keep)

    def ref(path, keep):
        jax_checkpoint.pcg_solve_checkpointed(jp, path, chunk=20,
                                              keep_last=2,
                                              dtype=jnp.float64,
                                              keep_checkpoint=keep)

    with pytest.warns(RuntimeWarning):
        _corrupt_drill(port, str(tmp_path / "port.npz"))
    with pytest.warns(RuntimeWarning):
        _corrupt_drill(ref, str(tmp_path / "jax.npz"))
    got = _checkpoint_counters(metrics)
    assert got == _checkpoint_counters(jax_metrics)
    assert got["checkpoint.writes"] > 0
    assert got["checkpoint.corrupt"] >= 1
    assert got["checkpoint.crc_failures"] >= 1
    assert got["checkpoint.generation_fallbacks"] >= 1


class _Expired:
    def expired(self) -> bool:
        return True


def test_deadline_stop_is_counted_with_its_event(tmp_path):
    obs.configure(trace_dir=str(tmp_path), rank=0)
    r = checkpoint.pcg_solve_chunked(Problem(M=40, N=40), chunk=10,
                                     deadline=_Expired(), device="cpu")
    assert int(r.iterations) == 0
    assert metrics.get("checkpoint.deadline_stops") == 1
    stop = [e for e in obs.recent_events()
            if e["name"] == "checkpoint.deadline_stop"]
    assert stop and stop[0]["k"] == 0 and stop[0]["chunks"] == 0


def test_checkpoint_write_and_gather_spans(tmp_path):
    obs.configure(trace_dir=str(tmp_path / "tm"), rank=0)
    mesh = make_solver_mesh(["cpu"] * 4, grid=(2, 2))
    r = pcg_solve_sharded_checkpointed(Problem(M=40, N=40), mesh,
                                       str(tmp_path / "s.npz"), chunk=20,
                                       keep_checkpoint=True)
    assert int(r.iterations) == 50
    obs.shutdown()
    events = trace.load_events(str(tmp_path / "tm"))
    ends = [e for e in events if e["kind"] == "span_end"]
    gathers = [e for e in ends if e["name"] == "checkpoint.gather"]
    writes = [e for e in ends if e["name"] == "checkpoint.write"]
    assert len(gathers) == len(writes) == 3     # chunks 20, 40, 50
    assert {e["mesh"] for e in gathers} == {"2x2"}
    assert {e["span_path"] for e in writes} == {"checkpoint.write"}
    written = [e for e in events if e["kind"] == "event"
               and e["name"] == "checkpoint.write"]
    assert [e["k"] for e in written] == [20, 40, 50]
    assert metrics.get("checkpoint.writes") == 3


def test_phase_timer_phases_are_spans(tmp_path):
    obs.configure(trace_dir=str(tmp_path), rank=0)
    timer = PhaseTimer("cpu")
    with timer.phase("first_solve"):
        pass
    with timer.phase("first_solve"):
        pass
    assert set(timer.times) == {"first_solve"}
    ends = [e for e in obs.recent_events() if e["kind"] == "span_end"]
    assert [e["name"] for e in ends] == ["first_solve", "first_solve"]


@pytest.mark.parametrize("flags,name", [
    ([1, 1, 1], "converged"), ([1, 0, 1], "running"),
    ([1, 2, 0, 3], "nonfinite"), (1, "converged"), (0, "running"),
], ids=["converged", "capped", "worst_failure", "scalar", "untracked_flag"])
def test_count_solve_names_the_verdict_as_jax_does(flags, name):
    from poisson_tpu_torch.solvers.pcg import PCGResult

    k = torch.tensor([5, 9, 7, 3][: len(flags)] if isinstance(flags, list)
                     else 9)
    r = PCGResult(w=None, iterations=k, diff=None, residual_dot=None,
                  flag=torch.tensor(flags))
    assert count_solve(r, compile_seconds=0.5, solve_seconds=0.25) == name
    assert metrics.get(f"pcg.solves.{name}") == 1
    assert metrics.get(f"pcg.iterations.{name}") == 9
    assert metrics.get("time.compile_seconds") == 0.5
    assert metrics.get("time.execute_seconds") == 0.25


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_cli_report_counters_and_events_match_jax(tmp_path):
    """The same fp64 solve through both CLIs: the same solve counters,
    a ``solve.report`` event in each trace directory, and each loads with
    the other package's reader."""
    runs = {"port": ["poisson_tpu_torch", "--backend", "torch",
                     "--device", "cpu"],
            "jax": ["poisson_tpu", "--backend", "xla"]}
    for tag, (module, *extra) in runs.items():
        out = subprocess.run(
            [sys.executable, "-m", module, "40", "40", "--dtype", "float64",
             "--json", "--trace-dir", str(tmp_path / tag), "--metrics-out",
             str(tmp_path / f"{tag}.json"), *extra],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=300)
        assert out.returncode == 0, out.stderr
    snaps = {tag: json.loads((tmp_path / f"{tag}.json").read_text())
             for tag in runs}
    for tag, snap in snaps.items():
        assert snap["counters"]["pcg.solves.converged"] == 1, tag
        assert snap["counters"]["pcg.iterations.converged"] == 50, tag
        assert "time.execute_seconds" in snap["counters"]
        assert "time.compile_seconds" in snap["counters"]
    for tag in runs:
        for reader in (trace, jax_trace):
            names = {e["name"] for e in
                     reader.load_events(str(tmp_path / tag))}
            assert "solve.report" in names
        for reader in (metrics, jax_metrics):
            merged = reader.load_dir(str(tmp_path / tag))
            assert merged["counters"]["pcg.solves.converged"] == 1


# -- streamed convergence (obs.stream) ------------------------------------


def _jax_stream(run):
    from poisson_tpu.obs import stream as jax_stream

    sink = jax_stream.StreamSink()
    jax_stream.set_sink(sink)
    try:
        res = run()
        jax_stream.drain()
    finally:
        jax_stream.set_sink(None)
    return res, sink.samples


def _port_stream(run):
    sink = obs.stream.StreamSink()
    obs.stream.set_sink(sink)
    try:
        res = run()
    finally:
        obs.stream.set_sink(None)
    return res, sink.samples


def test_stream_samples_equal_jax_s_and_keep_the_bits():
    """``stream_every=7`` at 40×40 fp64: JAX's k set (7 … 49), each ‖Δw‖
    within 1e-12 of JAX's, in order, and the iterate and count of the
    unstreamed solve bit for bit."""
    from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    p = Problem(M=40, N=40)
    plain = pcg_solve(p, device="cpu")
    res, got = _port_stream(lambda: pcg_solve(p, device="cpu",
                                              stream_every=7))
    _, want = _jax_stream(lambda: jax_pcg_solve(JaxProblem(M=40, N=40),
                                                stream_every=7))
    assert [k for k, _ in got] == sorted(k for k, _ in want) == list(
        range(7, 50, 7))
    np.testing.assert_allclose([d for _, d in got],
                               [d for _, d in sorted(want)], rtol=1e-12)
    assert int(res.iterations) == int(plain.iterations) == 50
    assert torch.equal(res.w, plain.w)


def test_stream_without_a_sink_drops_samples():
    from poisson_tpu_torch.solvers.pcg import pcg_solve

    assert obs.stream.get_sink() is None
    res = pcg_solve(Problem(M=40, N=40), device="cpu", stream_every=7)
    assert int(res.iterations) == 50


@pytest.mark.parametrize("driver", ["resilient", "chunked", "checkpointed"])
def test_streamed_chunked_solves_keep_counts_and_emit_each_k_once(
        tmp_path, driver):
    """The chunked drivers stream through the same body: a chunk boundary
    and the frozen steps after the stop emit nothing twice, and the
    samples are JAX's resilient solve's (JAX's streamed resilient case)."""
    from poisson_tpu.solvers.resilient import (
        pcg_solve_resilient as jax_resilient,
    )
    from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient

    p = Problem(M=40, N=40)
    run = {
        "resilient": lambda: pcg_solve_resilient(p, chunk=10,
                                                 stream_every=5,
                                                 device="cpu"),
        "chunked": lambda: checkpoint.pcg_solve_chunked(
            p, chunk=10, stream_every=5, device="cpu"),
        "checkpointed": lambda: checkpoint.pcg_solve_checkpointed(
            p, str(tmp_path / "ck.npz"), chunk=10, stream_every=5,
            device="cpu"),
    }[driver]
    res, got = _port_stream(run)
    _, want = _jax_stream(lambda: jax_resilient(JaxProblem(M=40, N=40),
                                                chunk=10, stream_every=5))
    assert int(res.iterations) == 50
    assert [k for k, _ in got] == sorted(k for k, _ in want) == list(
        range(5, 51, 5))
    np.testing.assert_allclose([d for _, d in got],
                               [d for _, d in sorted(want)], rtol=1e-12)


def test_configured_stream_file_loads_with_the_jax_readers(tmp_path,
                                                          monkeypatch):
    """``obs.configure(stream_every=)`` writes ``stream-rank0.jsonl`` in
    the JAX package's format: the forensics loader of
    ``benchmarks/summarize_session.py`` reads it, and
    ``POISSON_TPU_STREAM_EVERY`` configures the stride from the env."""
    import importlib.util

    from poisson_tpu_torch.solvers.pcg import pcg_solve

    tdir = tmp_path / "tr"
    obs.configure(trace_dir=str(tdir), stream_every=10)
    assert obs.stream_every() == 10
    pcg_solve(Problem(M=40, N=40), device="cpu",
              stream_every=obs.stream_every())
    obs.finalize()
    spec = importlib.util.spec_from_file_location(
        "summarize_session", ROOT / "benchmarks" / "summarize_session.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    _, _, _, streams = mod._load_telemetry(tdir)
    assert [r["k"] for r in streams["0"]] == [10, 20, 30, 40, 50]
    assert all(set(r) >= {"k", "diff", "at_unix", "at_mono"}
               for r in streams["0"])
    obs.shutdown()
    assert obs.stream.get_sink() is None and obs.stream_every() == 0
    monkeypatch.setenv("POISSON_TPU_STREAM_EVERY", "25")
    monkeypatch.delenv("POISSON_TPU_TRACE_DIR", raising=False)
    monkeypatch.delenv("POISSON_TPU_METRICS_OUT", raising=False)
    assert obs.configure_from_env() is not None
    assert obs.stream_every() == 25 and obs.stream.get_sink() is not None
