"""Port parity: Prometheus exposition (``poisson_tpu_torch.obs.export``),
the telemetry facade's new sinks and the profiler capture
(``obs.profile``) against ``poisson_tpu.obs``, on the CPU.

The same registry renders to the same text in both packages, byte for
byte, and each package's ``parse_text`` reads the other's.
"""

import json
import os
import urllib.error
import urllib.request

import pytest
import torch

from poisson_tpu import obs as jax_obs
from poisson_tpu.obs import export as jax_export
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu_torch import obs
from poisson_tpu_torch.obs import export, metrics, profile
from poisson_tpu_torch.obs.forecast import LatencyHistogram


@pytest.fixture(autouse=True)
def _fresh_registries():
    for reg in (metrics, jax_metrics):
        reg.reset()
    yield
    obs.shutdown()
    jax_obs.shutdown()
    for reg in (metrics, jax_metrics):
        reg.reset()


def _feed(reg):
    """The same counters and gauges, every shape the exposition knows."""
    reg.inc("pcg.solves.converged")
    reg.inc("pcg.iterations.converged", 989)
    reg.inc("time.execute_seconds", 0.3286)
    reg.inc("1starts.with-a digit")
    reg.gauge("roofline.fraction", 0.0512)
    reg.gauge("bench.ok", True)
    reg.gauge("serve.latency_seconds",
              {"p50": 0.01, "p95": 0.02, "p99": 0.05, "p99.9": 0.08})
    hist = LatencyHistogram((1.0, 2.0, 5.0))
    for v in (0.5, 1.5, 7.0, 2.0):
        hist.observe(v)
    reg.gauge("obs.forecast.calibration_pct", hist.snapshot())
    reg.gauge("device.kind", "NVIDIA H100 80GB HBM3")
    reg.gauge("odd.dict", {"a": 1})


def test_render_equals_the_jax_packages_byte_for_byte():
    _feed(metrics)
    _feed(jax_metrics)
    ours, theirs = export.render(), jax_export.render()
    assert ours == theirs
    assert "# TYPE poisson_tpu_serve_latency_seconds summary" in ours
    assert "# TYPE poisson_tpu_obs_forecast_calibration_pct histogram" in ours
    assert "# skipped non-numeric gauge 'device.kind'" in ours
    snap = metrics.snapshot()
    assert export.render(snap) == jax_export.render(snap)


def test_each_package_parses_the_others_text():
    _feed(metrics)
    _feed(jax_metrics)
    ours, theirs = export.render(), jax_export.render()
    assert export.parse_text(theirs) == jax_export.parse_text(ours)
    parsed = export.parse_text(ours)
    assert parsed["poisson_tpu_pcg_iterations_converged"] == {
        "type": "counter", "value": 989.0}
    assert parsed['poisson_tpu_serve_latency_seconds{quantile="0.999"}'][
        "value"] == 0.08
    assert parsed['poisson_tpu_obs_forecast_calibration_pct_bucket'
                  '{le="+Inf"}'] == {"type": "histogram", "value": 4.0}
    assert export.metric_name("1starts.with-a digit") == (
        jax_export.metric_name("1starts.with-a digit"))


def test_textfile_is_written_atomically(tmp_path):
    _feed(metrics)
    path = tmp_path / "sub" / "metrics.prom"
    export.write_textfile(str(path))
    assert path.read_text() == export.render()
    assert os.listdir(path.parent) == ["metrics.prom"]   # no tmp left
    # An unwritable target is swallowed (telemetry never kills a solve).
    blocker = tmp_path / "file"
    blocker.write_text("x")
    export.write_textfile(str(blocker / "metrics.prom"))
    assert blocker.read_text() == "x"


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def test_http_endpoint_serves_metrics_on_loopback():
    _feed(metrics)
    server = export.start_http_server(0)
    try:
        port = server.server_port
        assert server.server_address[0] == "127.0.0.1"
        assert metrics.snapshot()["gauges"]["export.http_port"] == port
        body = _get(f"http://127.0.0.1:{port}/metrics")
        assert export.parse_text(body)[
            "poisson_tpu_pcg_solves_converged"]["value"] == 1.0
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://127.0.0.1:{port}/other")
    finally:
        export.stop_http_server(server)
    export.stop_http_server(None)


def test_configure_serves_and_writes_the_textfile(tmp_path):
    prom = tmp_path / "run.prom"
    obs.configure(prom_path=str(prom), metrics_port=0)
    obs.inc("pcg.solves.converged")
    port = metrics.snapshot()["gauges"]["export.http_port"]
    live = export.parse_text(_get(f"http://127.0.0.1:{port}/metrics"))
    assert live["poisson_tpu_pcg_solves_converged"]["value"] == 1.0
    obs.shutdown()                     # finalize: the textfile, then stop
    parsed = export.parse_text(prom.read_text())
    assert parsed["poisson_tpu_pcg_solves_converged"]["value"] == 1.0
    with pytest.raises(OSError):
        _get(f"http://127.0.0.1:{port}/metrics")


def test_configure_from_env_adopts_the_jax_variables(tmp_path, monkeypatch):
    for var in ("POISSON_TPU_TRACE_DIR", "POISSON_TPU_METRICS_OUT",
                "POISSON_TPU_STREAM_EVERY"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("POISSON_TPU_PROFILE_DIR", str(tmp_path / "prof"))
    monkeypatch.setenv("POISSON_TPU_PROM_OUT", str(tmp_path / "m.prom"))
    monkeypatch.setenv("POISSON_TPU_METRICS_PORT", "0")
    assert obs.configure_from_env() is not None
    assert profile.profile_dir() == str(tmp_path / "prof")
    assert "export.http_port" in metrics.snapshot()["gauges"]
    obs.shutdown()
    assert (tmp_path / "m.prom").exists()
    assert profile.profile_dir() is None


def test_bad_metrics_port_is_said_and_survived(capsys):
    obs.configure(metrics_port=70000)
    assert "endpoint unavailable" in capsys.readouterr().err


def test_capture_is_a_null_context_unconfigured():
    profile.configure(None)
    with profile.capture("x") as out:
        torch.ones(4).sum()
    assert out is None
    assert metrics.get("profile.captures") == 0


def test_capture_writes_a_trace_counter_and_event(tmp_path):
    obs.configure(trace_dir=str(tmp_path / "tm"),
                  profile_dir=str(tmp_path / "prof"))
    with profile.capture("bench/solve") as out:
        torch.arange(1000.0).pow(2).sum()
    assert out == str(tmp_path / "prof" / "bench_solve")
    trace = json.loads((tmp_path / "prof" / "bench_solve"
                        / profile.TRACE_FILE).read_text())
    assert trace["traceEvents"]
    assert metrics.get("profile.captures") == 1
    obs.finalize()
    events = obs.load_events(str(tmp_path / "tm"))
    names = [e.get("name") for e in events]
    assert "profile.capture" in names
    assert "profile.bench/solve" in names          # the capture's span


def test_cli_writes_the_textfile_and_the_capture(tmp_path, capsys):
    from poisson_tpu_torch import cli

    prom, prof = tmp_path / "run.prom", tmp_path / "prof"
    assert cli.main(["40", "40", "--device", "cpu", "--json", "--prom-out",
                     str(prom), "--profile", str(prof)]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["iterations"] == 50 and rec["backend"] == "fused"
    assert rec["bytes_per_iter_model"] > 0     # the fused kernels' bytes
    assert rec["achieved_gbps"] is None        # no device rate from a CPU
    assert rec["roofline_fraction"] is None
    assert (prof / "cli.solve" / profile.TRACE_FILE).exists()
    parsed = export.parse_text(prom.read_text())
    assert parsed["poisson_tpu_pcg_solves_running"]["value"] == 1.0
    assert parsed["poisson_tpu_profile_captures"]["value"] == 1.0


def test_cli_solve_batched_captures_one_extra_solve(tmp_path, capsys):
    from poisson_tpu_torch import cli

    prof = tmp_path / "prof"
    assert cli.main(["solve-batched", "40", "40", "--batch", "2",
                     "--device", "cpu", "--json", "--profile",
                     str(prof)]) == 0
    assert json.loads(capsys.readouterr().out)["max_iterations"] == 50
    assert (prof / "solve_batched" / profile.TRACE_FILE).exists()
    assert metrics.get("profile.captures") == 1
