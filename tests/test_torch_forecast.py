"""Port parity: the convergence observatory (``poisson_tpu_torch.obs.forecast``),
the ``history_every`` seam and the CLI's ``top`` against
``poisson_tpu.obs.forecast``, on the CPU.

The estimators and the model are the JAX package's stdlib code and must
give the same numbers on the same samples; the snapshots are one format.
The history seam must leave the solve bit for bit and give JAX's
(k, ‖Δw‖) samples (fp64, 1e-12).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu import cli as jax_cli
from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.obs import export as jax_export
from poisson_tpu.obs import forecast as jax_forecast
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import checkpoint as jax_checkpoint
from poisson_tpu.solvers import pcg as jax_pcg
from poisson_tpu_torch import cli
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import export, forecast, metrics
from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
from poisson_tpu_torch.solvers.pcg import pcg_solve

DIFF_TOL = 1e-12


@pytest.fixture(autouse=True)
def _fresh_registries():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    for reg in (metrics, jax_metrics):
        reg.reset()
    prev = (forecast.set_history(None), jax_forecast.set_history(None))
    yield
    forecast.set_history(prev[0])
    jax_forecast.set_history(prev[1])
    for reg in (metrics, jax_metrics):
        reg.reset()
    torch.set_num_threads(saved)


def _samples(seed, n=40):
    rng = np.random.default_rng(seed)
    ks = np.sort(rng.choice(np.arange(1, 2000), n, replace=False))
    diffs = np.exp(-0.01 * ks + 0.3 * rng.standard_normal(n))
    return [(int(k), float(d)) for k, d in zip(ks, diffs)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimators_equal_the_jax_packages(seed):
    samples = _samples(seed)
    for cut in (0, 1, 2, 10, len(samples)):
        part = samples[:cut]
        assert (forecast.log_residual_slope(part)
                == jax_forecast.log_residual_slope(part))
    slope = forecast.log_residual_slope(samples)
    for diff, delta, s in ((1e-2, 1e-6, slope), (1e-7, 1e-6, slope),
                           (1e-2, 1e-6, None), (1e-2, 1e-6, 0.1),
                           (0.0, 1e-6, slope), (1e-2, 0.0, slope)):
        assert (forecast.remaining_iterations(diff, delta, s)
                == jax_forecast.remaining_iterations(diff, delta, s))
    for done, total in ((5, 10), (20, 10), (3, 0), (-1, 4)):
        assert (forecast.progress_fraction(done, total)
                == jax_forecast.progress_fraction(done, total))
    for M, N in ((40, 40), (800, 1200), (2400, 3200)):
        assert forecast.cold_iterations(M, N) == (
            jax_forecast.cold_iterations(M, N))
        for kind in ("TPU v5 lite", "TPU v4", None):
            for db, sc in ((4, True), (8, False)):
                assert forecast.cold_seconds_per_iteration(
                    M, N, dtype_bytes=db, scaled=sc, device_kind=kind) == (
                    jax_forecast.cold_seconds_per_iteration(
                        M, N, dtype_bytes=db, scaled=sc, device_kind=kind))


def _feed_models(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = forecast.ForecastModel(), jax_forecast.ForecastModel()
    cohorts = ["a|800x1200", "b|400x600", "c|40x40"]
    for _ in range(60):
        c = cohorts[int(rng.integers(3))]
        iters = int(rng.integers(40, 1100))
        secs = float(rng.uniform(0.0, 0.5))
        kw = dict(M=800, N=1200, dtype_bytes=4, device_kind="TPU v4")
        assert (dataclasses.asdict(ours.predict(c, **kw))
                == dataclasses.asdict(theirs.predict(c, **kw)))
        assert ours.observe(c, iters, secs, **kw) == (
            theirs.observe(c, iters, secs, **kw))
    return ours, theirs


def test_forecast_model_equals_the_jax_packages():
    ours, theirs = _feed_models(0)
    assert ours.cohorts() == theirs.cohorts()
    assert ours.calibration_err_pct() == theirs.calibration_err_pct()
    assert (metrics.snapshot()["counters"]
            == jax_metrics.snapshot()["counters"])
    assert metrics.snapshot()["gauges"] == jax_metrics.snapshot()["gauges"]


def test_snapshots_load_across_the_packages(tmp_path):
    ours, theirs = _feed_models(1)
    assert ours.save(str(tmp_path / "port.json"))
    assert theirs.save(str(tmp_path / "jax.json"))
    assert ((tmp_path / "port.json").read_text()
            == (tmp_path / "jax.json").read_text())
    into_jax, into_port = (jax_forecast.ForecastModel(),
                           forecast.ForecastModel())
    assert into_jax.load(str(tmp_path / "port.json"))
    assert into_port.load(str(tmp_path / "jax.json"))
    # The snapshot rounds seconds per iteration to 12 digits, in both.
    assert into_jax.cohorts() == into_port.cohorts()
    for key, rec in ours.cohorts().items():
        loaded = into_port.cohorts()[key]
        assert loaded["samples"] == rec["samples"]
        assert loaded["iterations_p50"] == rec["iterations_p50"]
        assert loaded["seconds_per_iteration"] == pytest.approx(
            rec["seconds_per_iteration"], abs=1e-12)
    assert into_port.calibration_err_pct() == (
        into_jax.calibration_err_pct()) == pytest.approx(
        ours.calibration_err_pct(), abs=1e-6)     # errors kept to 6 digits


def test_torn_snapshot_is_audible_and_missing_is_silent(tmp_path):
    ours, _ = _feed_models(2)
    path = tmp_path / "f.json"
    ours.save(str(path))
    path.write_text(path.read_text().replace('"iterations"', '"iterationz"'))
    fresh = forecast.ForecastModel()
    assert not fresh.load(str(path))
    assert metrics.get("obs.forecast.snapshot.torn") == 1
    assert fresh.cohorts() == {}
    assert not fresh.load(str(tmp_path / "absent.json"))
    assert metrics.get("obs.forecast.snapshot.torn") == 1


def _registry(reg):
    """A registry shaped like a live service's, on both packages' names."""
    for name, v in (("serve.queue_depth", 3), ("serve.dispatches", 12),
                    ("serve.breaker.trips", 1), ("serve.slo.good", 40),
                    ("obs.forecast.predictions", 9),
                    ("obs.forecast.cold_cohorts", 2),
                    ("serve.router.chosen.fused", 7),
                    ("serve.router.chosen.torch", 5),
                    ("geom.cache.hits", 3), ("geom.cache.misses", 1),
                    ("serve.shed.predicted_deadline", 1)):
        reg.inc(name, v)
    for name, v in (("serve.load_level", 1), ("serve.shed_rate", 0.125),
                    ("serve.slo.burn_rate.5m", 2.5),
                    ("serve.slo.budget_remaining", 0.75),
                    ("obs.forecast.calibration_err_pct", 4.25),
                    ("obs.roofline.fraction.fused", 0.0512),
                    ("obs.roofline.calibration_err_pct", 12.5),
                    ("serve.tenant.share.alpha", 1.0),
                    ("serve.tenant.quota_tokens.alpha", 3.5),
                    ("serve.tenant.retry_tokens.alpha", -1.0)):
        reg.gauge(name, v)


def test_scoreboard_equals_the_jax_packages():
    _registry(metrics)
    _registry(jax_metrics)
    for snap in (metrics.snapshot(), jax_metrics.snapshot()):
        for shape in (snap, export.parse_text(export.render(snap))):
            ours = forecast.build_scoreboard(shape)
            assert ours == jax_forecast.build_scoreboard(shape)
            assert forecast.render_scoreboard(ours) == (
                jax_forecast.render_scoreboard(ours))
    assert "frac=0.051" in forecast.render_scoreboard(
        forecast.build_scoreboard(metrics.snapshot()))


@pytest.mark.parametrize("source", ["--metrics-dir", "--textfile"])
@pytest.mark.parametrize("as_json", [False, True])
def test_top_prints_what_the_jax_top_prints(source, as_json, tmp_path,
                                            capsys):
    _registry(metrics)
    (tmp_path / "metrics-rank0.json").write_text(
        json.dumps(metrics.snapshot(rank=0)))
    export.write_textfile(str(tmp_path / "m.prom"))
    arg = str(tmp_path if source == "--metrics-dir" else tmp_path / "m.prom")
    argv = [source, arg] + (["--json"] if as_json else [])
    assert jax_cli._main_top(argv) == 0
    theirs = capsys.readouterr().out
    assert cli.main(["top", *argv]) == 0
    assert capsys.readouterr().out == theirs


def test_top_source_validation(tmp_path, capsys):
    assert cli.main(["top", "--json"]) == 2
    assert cli.main(["top", "--metrics-dir", str(tmp_path), "--textfile",
                     "x.prom"]) == 2
    assert cli.main(["top", "--textfile", str(tmp_path / "absent.prom")]) == 1
    capsys.readouterr()


def _jax_history(M, N, every):
    buf = jax_forecast.HistoryBuffer(maxlen=4096)
    jax_forecast.set_history(buf)
    try:
        r = jax_pcg.pcg_solve(JaxProblem(M=M, N=N), dtype=jnp.float64,
                              history_every=every)
        jax.effects_barrier()
    finally:
        jax_forecast.set_history(None)
    return int(r.iterations), sorted(buf.samples)


@pytest.mark.parametrize("M,N,every", [(40, 40, 7), (400, 600, 50)])
def test_history_every_is_bit_for_bit_and_gives_jax_samples(M, N, every):
    p = Problem(M=M, N=N)
    buf = forecast.HistoryBuffer(maxlen=4096)
    forecast.set_history(buf)
    on = pcg_solve(p, dtype=torch.float64, device="cpu",
                   history_every=every)
    forecast.set_history(None)
    off = pcg_solve(p, dtype=torch.float64, device="cpu")
    assert int(on.iterations) == int(off.iterations)
    assert torch.equal(on.w, off.w) and torch.equal(on.diff, off.diff)
    jax_iters, jax_samples = _jax_history(M, N, every)
    ours = list(buf.samples)
    assert int(on.iterations) == jax_iters
    assert [k for k, _ in ours] == [k for k, _ in jax_samples] == list(
        range(every, jax_iters + 1, every))
    np.testing.assert_allclose([d for _, d in ours],
                               [d for _, d in jax_samples],
                               rtol=0, atol=DIFF_TOL)
    assert buf.slope() == pytest.approx(
        jax_forecast.log_residual_slope(jax_samples), rel=1e-9)


def test_history_every_refuses_mg_as_jax_does():
    with pytest.raises(ValueError) as ours:
        pcg_solve(Problem(M=40, N=40), device="cpu", history_every=5,
                  preconditioner="mg")
    with pytest.raises(ValueError) as theirs:
        jax_pcg.pcg_solve(JaxProblem(M=40, N=40), history_every=5,
                          preconditioner="mg")
    assert str(ours.value) == str(theirs.value)


def test_chunked_history_taps_the_jax_chunk_boundaries():
    buf, jbuf = forecast.HistoryBuffer(), jax_forecast.HistoryBuffer()
    forecast.set_history(buf)
    r = pcg_solve_chunked(Problem(M=40, N=40), chunk=16,
                          dtype=torch.float64, device="cpu", history=True)
    jax_forecast.set_history(jbuf)
    jr = jax_checkpoint.pcg_solve_chunked(JaxProblem(M=40, N=40), chunk=16,
                                          dtype=jnp.float64, history=True)
    assert int(r.iterations) == int(jr.iterations) == 50
    assert [k for k, _ in buf.samples] == [k for k, _ in jbuf.samples] == [
        16, 32, 48, 50]
    np.testing.assert_allclose([d for _, d in buf.samples],
                               [d for _, d in jbuf.samples], rtol=0,
                               atol=DIFF_TOL)
    forecast.set_history(None)
    plain = pcg_solve_chunked(Problem(M=40, N=40), chunk=16,
                              dtype=torch.float64, device="cpu")
    assert torch.equal(plain.w, r.w)
