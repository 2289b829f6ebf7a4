"""Port parity: the roofline observatory (``poisson_tpu_torch.obs.roofline``)
against ``poisson_tpu.obs.roofline``, on the CPU.

The same observations give the same grades, cohorts and calibration in
both packages, the snapshot is one format, and the port's kernel backends
are priced with their kernels' bytes (``obs.costs.iteration_bytes``).
"""

import dataclasses

import numpy as np
import pytest

from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.obs import roofline as jax_roofline
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import costs, metrics, roofline


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    monkeypatch.delenv("POISSON_TPU_PEAK_GBPS", raising=False)
    for reg in (metrics, jax_metrics):
        reg.reset()
    yield
    for reg in (metrics, jax_metrics):
        reg.reset()


def _observations(seed, n=80):
    """A seeded stream of dispatches on the backends both packages name
    alike (``sharded``, the resident kernel under each package's name) or
    with an explicit pass model."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        M, N = [(40, 40), (400, 600), (800, 1200)][int(rng.integers(3))]
        kind = ["TPU v5 lite", "TPU v4", None][int(rng.integers(3))]
        which = int(rng.integers(3))
        out.append(dict(
            backend=("sharded", "resident", "sharded")[which],
            jax_backend=("sharded", "pallas-resident", "sharded")[which],
            passes_override=(None, None, float(rng.uniform(2, 20)))[which],
            M=M, N=N, batch=int(rng.integers(1, 5)),
            dtype_bytes=int(rng.choice([4, 8])),
            preconditioner=["jacobi", "mg", None][int(rng.integers(3))],
            verify_every=int(rng.choice([0, 5])), device_kind=kind,
            iterations=int(rng.integers(0, 1000)),
            seconds=float(rng.choice([0.0, rng.uniform(1e-3, 1.0)]))))
    return out


def _feed(seed):
    ours, theirs = roofline.RooflineModel(), jax_roofline.RooflineModel()
    for obs_kw in _observations(seed):
        kw = dict(obs_kw)
        jax_backend = kw.pop("jax_backend")
        a = ours.observe(**kw)
        kw["backend"] = jax_backend
        b = theirs.observe(**kw)
        assert (a is None) == (b is None)
        if a is not None:
            da, db = dataclasses.asdict(a), dataclasses.asdict(b)
            if obs_kw["backend"] == "resident":
                da["cohort"] = da["cohort"].replace("resident",
                                                    "pallas-resident")
                da["backend"] = db["backend"]
            assert da == db
    return ours, theirs


@pytest.mark.parametrize("seed", [0, 1])
def test_same_observations_give_the_same_model(seed):
    ours, theirs = _feed(seed)
    assert ours.calibration_err_pct() == theirs.calibration_err_pct()
    assert ours.backend_fraction("sharded") == (
        theirs.backend_fraction("sharded"))
    renamed = {k.replace("resident", "pallas-resident"): v
               for k, v in ours.cohorts().items()}
    assert renamed == theirs.cohorts()
    for key in theirs.cohorts():
        port_key = key.replace("pallas-resident", "resident")
        assert ours.expected_fraction(port_key) == (
            theirs.expected_fraction(key))
    assert ours.expected_fraction("never|seen") == (
        theirs.expected_fraction("never|seen"))
    assert (metrics.snapshot()["counters"]
            == jax_metrics.snapshot()["counters"])


def test_snapshots_load_across_the_packages(tmp_path):
    ours, theirs = _feed(2)
    assert ours.save(str(tmp_path / "port.json"))
    assert theirs.save(str(tmp_path / "jax.json"))
    into_jax, into_port = (jax_roofline.RooflineModel(),
                           roofline.RooflineModel())
    assert into_jax.load(str(tmp_path / "port.json"))
    assert into_port.load(str(tmp_path / "jax.json"))
    # The names differ only for the resident kernel.
    assert into_port.cohorts() == theirs.cohorts() == {
        k.replace("resident", "pallas-resident"): v
        for k, v in into_jax.cohorts().items()}
    assert into_jax.calibration_err_pct() == (
        into_port.calibration_err_pct())
    assert metrics.get("obs.roofline.snapshot.loads") == 1
    assert jax_metrics.get("obs.roofline.snapshot.loads") == 1


def test_torn_snapshot_is_audible_and_missing_is_silent(tmp_path):
    ours, _ = _feed(3)
    path = tmp_path / "r.json"
    ours.save(str(path))
    path.write_text(path.read_text()[:-5])
    fresh = roofline.RooflineModel()
    assert not fresh.load(str(path))
    assert metrics.get("obs.roofline.snapshot.torn") == 1
    assert not fresh.load(str(tmp_path / "absent.json"))
    assert metrics.get("obs.roofline.snapshot.torn") == 1
    assert fresh.cohorts() == {}


@pytest.mark.parametrize("M,N", [(40, 40), (800, 1200)])
@pytest.mark.parametrize("dtype_bytes", [4, 8])
def test_effective_passes_maps_the_ports_backends(M, N, dtype_bytes):
    grid = costs.grid_points(M, N) * dtype_bytes
    for backend in ("fused", "ca", "fused-sharded", "ca-sharded"):
        assert roofline.effective_passes(backend, None, M, N,
                                         dtype_bytes) == (
            costs.iteration_bytes(Problem(M=M, N=N), backend,
                                  dtype_bytes=dtype_bytes) / grid)
    assert roofline.effective_passes("native", None, M, N) is None
    assert roofline.effective_passes("fused") is None   # needs the grid
    for pre in (None, "mg"):
        assert roofline.effective_passes("sharded", pre, M, N,
                                         dtype_bytes) == (
            jax_roofline.effective_passes("sharded", pre, M, N, dtype_bytes))
        assert roofline.effective_passes("resident", pre, M, N,
                                         dtype_bytes) == (
            jax_roofline.effective_passes("pallas-resident", pre, M, N,
                                          dtype_bytes))
    assert roofline.effective_passes("torch", None, M, N, dtype_bytes) == (
        jax_roofline.effective_passes("xla", None, M, N, dtype_bytes))


def test_a_fused_dispatch_is_graded_with_the_kernels_bytes():
    model = roofline.RooflineModel()
    sample = model.observe(backend="fused", M=800, N=1200, dtype_bytes=4,
                           device_kind="NVIDIA H100 80GB HBM3",
                           iterations=989, seconds=0.33)
    want = (costs.iteration_bytes(Problem(M=800, N=1200), "fused") * 989
            / 0.33 / 1e9)
    assert sample.achieved_gbps == pytest.approx(want, rel=1e-6)
    assert sample.fraction == pytest.approx(want / 3350.0, rel=1e-6)
    assert sample.cold and sample.expected_fraction == (
        roofline.DEFAULT_COLD_FRACTION)
    assert metrics.snapshot()["gauges"]["obs.roofline.fraction.fused"] == (
        round(sample.fraction, 6))
