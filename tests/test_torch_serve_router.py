"""The port's roofline observatory and backend router (counterpart of
``tests/test_router.py``, on the CPU; -m serve).

Under test: the measured-attribution arithmetic (``obs.roofline``), the
cold analytic routing table — kernel R's fit, not the JAX package's
VMEM rule — and the warm-evidence argmin (``serve.router``), the misprediction
sentinel lifecycle (event → demotion → cooldown → half-open re-probe →
recovery) under a :class:`VirtualClock`, the closed execution gate
(``executor_backend`` is ``"torch"`` for every arm), router-off cohort
strings, and the ``top`` scoreboard's Backends pane from a live snapshot
and from the Prometheus round trip.
"""

import json
import os
import sys

import pytest

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import export, forecast, metrics
from poisson_tpu_torch.obs.roofline import (
    DEFAULT_COLD_FRACTION,
    RESIDENT_EFFECTIVE_PASSES,
    RooflineModel,
    effective_passes,
    roofline_cohort,
    snapshot_path,
)
from poisson_tpu_torch.obs.costs import EFFECTIVE_PASSES, grid_points
from poisson_tpu_torch.serve import (
    RouterPolicy,
    ServicePolicy,
    SolveRequest,
    SolveService,
)
from poisson_tpu_torch.serve.router import (
    BACKEND_CA,
    BACKEND_RESIDENT,
    BACKEND_TORCH,
    BackendRouter,
    analytic_choice,
    available_backends,
    executor_backend,
    fits_resident_bytes,
)
from poisson_tpu_torch.testing.chaos import VirtualClock

sys.path.insert(0, str(__import__("pathlib").Path(
    __file__).resolve().parents[1]))

pytestmark = [pytest.mark.serve, pytest.mark.router]

P40 = Problem(M=40, N=40)


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def _observe(model, backend="torch", M=40, N=40, seconds=1e-3,
             iterations=100, **kw):
    return model.observe(backend=backend, M=M, N=N, seconds=seconds,
                         iterations=iterations, **kw)


# -- measured attribution arithmetic -------------------------------------


def test_achieved_fraction_matches_bytes_model(monkeypatch):
    """fraction = passes·points·bytes·iters / seconds / peak — checked
    against a hand computation with a pinned env peak."""
    monkeypatch.setenv("POISSON_TPU_PEAK_GBPS", "100")
    model = RooflineModel()
    s = _observe(model, backend="torch", M=40, N=40, seconds=1e-3,
                 iterations=100, dtype_bytes=8, device_kind="tpu v5e")
    want_bytes = EFFECTIVE_PASSES["torch"] * grid_points(40, 40) * 8 * 100
    want_gbps = want_bytes / 1e-3 / 1e9
    assert s is not None
    assert s.achieved_gbps == pytest.approx(want_gbps, rel=1e-3)
    assert s.peak_gbps == 100.0
    assert s.fraction == pytest.approx(want_gbps / 100.0, rel=1e-3)
    # the first sample is graded against the analytic prior
    assert s.cold and s.expected_fraction == DEFAULT_COLD_FRACTION
    assert metrics.get("obs.roofline.observations") == 1
    assert metrics.get("obs.roofline.cold_cohorts") == 1


def test_unmeasurable_dispatch_is_skipped_not_sampled():
    model = RooflineModel()
    assert _observe(model, seconds=0.0) is None      # VirtualClock
    assert _observe(model, iterations=0) is None
    assert _observe(model, backend="nonesuch") is None  # no model
    assert metrics.get("obs.roofline.skipped") == 3
    assert metrics.get("obs.roofline.observations") == 0


def test_cohort_warms_and_expectation_tracks_p50():
    model = RooflineModel()
    for k in range(5):
        s = _observe(model, seconds=1e-3)
    assert not s.cold and s.samples == 4
    cohort = roofline_cohort("torch", 40, 40, 1, 8, None, 0, None)
    expected, cold, n = model.expected_fraction(cohort)
    assert not cold and n == 5
    # identical dispatches → p50 equals the per-sample fraction and
    # the calibration error collapses to ~0 on repeats
    assert expected == pytest.approx(s.fraction, rel=1e-9)
    assert model.calibration_err_pct() == pytest.approx(0.0, abs=1e-6)


def test_effective_passes_table():
    assert effective_passes("torch") == EFFECTIVE_PASSES["torch"]
    assert effective_passes("resident") \
        == RESIDENT_EFFECTIVE_PASSES
    assert effective_passes("nonesuch") is None
    # MG adds the V-cycle's fine-equivalent traffic on top
    plain = effective_passes("torch", None, 64, 64, 8)
    mg = effective_passes("torch", "mg", 64, 64, 8)
    assert mg > plain


def test_snapshot_roundtrip_and_torn_audibility(tmp_path):
    model = RooflineModel()
    for _ in range(3):
        _observe(model, seconds=1e-3)
    path = snapshot_path(str(tmp_path / "serve.journal"))
    assert model.save(path)
    loaded = RooflineModel()
    assert loaded.load(path)
    assert loaded.backend_fraction("torch") \
        == model.backend_fraction("torch")
    assert metrics.get("obs.roofline.snapshot.saves") == 1
    assert metrics.get("obs.roofline.snapshot.loads") == 1
    # tear the seal: the torn snapshot is counted and the model stays
    # cold — never trusted
    blob = json.loads(open(path).read())
    blob["crc32"] ^= 1
    open(path, "w").write(json.dumps(blob))
    torn = RooflineModel()
    assert not torn.load(path)
    assert torn.backend_fraction("torch") is None
    assert metrics.get("obs.roofline.snapshot.torn") == 1
    # a missing snapshot is silent (cold start, not an incident)
    fresh = RooflineModel()
    assert not fresh.load(str(tmp_path / "absent.json"))
    assert metrics.get("obs.roofline.snapshot.torn") == 1


# -- the cold analytic routing table -------------------------------------


def test_available_backends_gate_on_device_kind():
    assert available_backends(None) == (BACKEND_TORCH,)
    assert available_backends("cpu") == (BACKEND_TORCH,)
    # the kernel arms are offered on a CUDA kind (the card's name), not
    # on a TPU kind: the port's kernels are CUDA kernels
    assert set(available_backends("NVIDIA H100 80GB HBM3")) \
        == {BACKEND_TORCH, BACKEND_RESIDENT, BACKEND_CA}
    assert available_backends("TPU v5e") == (BACKEND_TORCH,)
    assert set(available_backends("cpu",
                                  assume=(BACKEND_RESIDENT,))) \
        == {BACKEND_TORCH, BACKEND_RESIDENT}


def test_analytic_choice_table():
    arms = (BACKEND_TORCH, BACKEND_RESIDENT, BACKEND_CA)
    # a small grid kernel R admits → the resident kernel (both rules)
    assert fits_resident_bytes(40, 40)
    assert analytic_choice(40, 40, 8, arms) == BACKEND_RESIDENT
    # 800×800 and 800×1200: the JAX rule (12 fp32 arrays in 15 MiB of
    # VMEM) sends them to its floor arm; kernel R's rule (9 fp32
    # canvases in 40 MB, ops/resident.py) admits them — 816×1280
    # canvases are 37.6 MB — so the port routes them resident.
    assert fits_resident_bytes(800, 800)
    assert analytic_choice(800, 800, 8, arms) == BACKEND_RESIDENT
    assert fits_resident_bytes(800, 1200)
    assert analytic_choice(800, 1200, 4, arms) == BACKEND_RESIDENT
    # past kernel R's budget and below the CA plateau → torch
    assert not fits_resident_bytes(1600, 2400)
    assert analytic_choice(1600, 2400, 8, arms) == BACKEND_TORCH
    # on the HBM plateau → communication-avoiding kernel
    assert analytic_choice(4000, 4000, 8, arms) == BACKEND_CA
    # candidates constrain the choice: a torch-only part routes torch
    assert analytic_choice(40, 40, 8, (BACKEND_TORCH,)) == BACKEND_TORCH


def test_executor_gate_pins_every_arm_to_torch():
    """The JAX package's gate, kept closed: whatever arm the router
    names, execution runs the plain torch solve — routing changes
    attribution, never numerics."""
    for arm in (BACKEND_TORCH, BACKEND_RESIDENT, BACKEND_CA):
        assert executor_backend(arm) == "torch"


# -- the sentinel lifecycle ----------------------------------------------


def _router(vc, **overrides):
    kw = dict(assume_available=(BACKEND_RESIDENT,),
              misprediction_fraction=0.5, demote_after=1,
              cooldown_seconds=0.05, warm_min_samples=3)
    kw.update(overrides)
    return BackendRouter(RouterPolicy(**kw), RooflineModel(),
                         clock=vc)


def test_misprediction_demotes_then_half_open_recovers():
    vc = VirtualClock()
    router = _router(vc)
    # Cold route on a grid kernel R admits picks the resident arm
    d1 = router.route(M=40, N=40, dtype_bytes=8)
    assert d1.backend == BACKEND_RESIDENT and d1.cold
    # A slow measured dispatch lands far below the predicted fraction
    vc.advance(1.0)
    slow = router.roofline.observe(
        backend=BACKEND_RESIDENT, M=40, N=40, iterations=50,
        seconds=1.0)
    router.grade(d1, slow)
    assert metrics.get("serve.router.mispredictions") == 1
    assert metrics.get("serve.router.demotions") == 1
    assert router.demoted_arms() == (f"{BACKEND_RESIDENT}:0",)
    # While demoted, traffic downshifts to the torch floor
    d2 = router.route(M=40, N=40, dtype_bytes=8)
    assert d2.backend == BACKEND_TORCH
    good2 = router.roofline.observe(
        backend=BACKEND_TORCH, M=40, N=40, iterations=50, seconds=5e-5)
    router.grade(d2, good2)
    # Past the cooldown the arm half-opens: one probe, graded against
    # the cold prior, and a healthy measurement recovers it
    vc.advance(0.06)
    d3 = router.route(M=40, N=40, dtype_bytes=8)
    assert d3.backend == BACKEND_RESIDENT
    assert metrics.get("serve.router.half_opens") == 1
    probe = router.roofline.observe(
        backend=BACKEND_RESIDENT, M=40, N=40, iterations=50,
        seconds=5e-5)
    router.grade(d3, probe)
    assert metrics.get("serve.router.recoveries") == 1
    assert router.demoted_arms() == ()
    st = router.stats()
    assert st["chosen"][BACKEND_RESIDENT] == 2
    assert st["chosen"][BACKEND_TORCH] == 1


def test_failed_probe_redemotes_without_counting_twice():
    vc = VirtualClock()
    router = _router(vc)
    d1 = router.route(M=40, N=40, dtype_bytes=8)
    vc.advance(1.0)
    router.grade(d1, router.roofline.observe(
        backend=BACKEND_RESIDENT, M=40, N=40, iterations=50,
        seconds=1.0))
    vc.advance(0.06)
    d2 = router.route(M=40, N=40, dtype_bytes=8)
    assert d2.backend == BACKEND_RESIDENT      # the half-open probe
    vc.advance(1.0)
    router.grade(d2, router.roofline.observe(
        backend=BACKEND_RESIDENT, M=40, N=40, iterations=50,
        seconds=1.0))
    assert metrics.get("serve.router.demotions") == 2
    assert metrics.get("serve.router.recoveries") == 0
    assert router.demoted_arms() == (f"{BACKEND_RESIDENT}:0",)


def test_warm_evidence_argmin_prefers_measured_fast_arm():
    vc = VirtualClock()
    router = _router(vc, warm_min_samples=2)
    # Warm the torch cohort with healthy evidence
    for _ in range(3):
        router.roofline.observe(backend=BACKEND_TORCH, M=800, N=800,
                                iterations=50, seconds=5e-3)
    d = router.route(M=800, N=800, dtype_bytes=8)
    # warm torch evidence outranks the resident arm's cold prior
    assert d.backend == BACKEND_TORCH and not d.cold
    assert metrics.get("serve.router.warm_decisions") == 1


def test_backend_downshift_rung_forces_the_floor():
    vc = VirtualClock()
    router = _router(vc, downshift_at=0.5)
    d = router.route(M=40, N=40, dtype_bytes=8, queue_fraction=0.9)
    assert d.backend == BACKEND_TORCH and d.forced_xla
    assert metrics.get("serve.degraded.backend_downshift") == 1
    calm = router.route(M=40, N=40, dtype_bytes=8, queue_fraction=0.1)
    assert calm.backend == BACKEND_RESIDENT and not calm.forced_xla


def test_torch_floor_arm_never_demotes():
    vc = VirtualClock()
    router = _router(vc, assume_available=())
    for _ in range(4):
        d = router.route(M=40, N=40, dtype_bytes=8)
        assert d.backend == BACKEND_TORCH
        vc.advance(1.0)
        router.grade(d, router.roofline.observe(
            backend=BACKEND_TORCH, M=40, N=40, iterations=50,
            seconds=1.0))
    # only the FIRST slow dispatch mispredicts (graded against the
    # cold prior); after that the cohort's expectation has absorbed
    # reality, so a consistently-slow part stops alarming — and the
    # floor arm never demotes regardless
    assert metrics.get("serve.router.mispredictions") == 1
    assert metrics.get("serve.router.demotions") == 0
    assert router.demoted_arms() == ()


def test_fixed_backend_policy_short_circuits():
    vc = VirtualClock()
    router = _router(vc, backend=BACKEND_TORCH)
    d = router.route(M=40, N=40, dtype_bytes=8)
    assert d.backend == BACKEND_TORCH
    # a fixed arm the part doesn't offer falls back to the floor
    router2 = _router(vc, backend=BACKEND_CA, assume_available=())
    assert router2.route(M=40, N=40, dtype_bytes=8).backend \
        == BACKEND_TORCH


# -- the service seam ----------------------------------------------------


def test_router_off_by_default_byte_compat():
    """ServicePolicy().router is None, the historical cohort string is
    unchanged, stats() has no router block, and no router counters
    tick — the default path is indistinguishable from a router-less
    service."""
    assert ServicePolicy().router is None
    svc = SolveService(device="cpu")
    svc.submit(SolveRequest(request_id=0, problem=P40))
    assert svc._cohort(svc._queue[0].request) == "40x40:auto:torch"
    outs = svc.drain()
    assert all(o.converged for o in outs)
    st = svc.stats()
    assert "router" not in st and st["lost"] == 0
    assert metrics.get("serve.router.decisions") == 0


def test_routed_service_splits_cohort_and_serves_all():
    vc = VirtualClock()
    svc = SolveService(
        ServicePolicy(capacity=16, router=RouterPolicy(
            assume_available=(BACKEND_RESIDENT,))),
        clock=vc, sleep=vc.sleep, seed=0, device="cpu")
    svc.submit(SolveRequest(request_id=0, problem=P40))
    # the routed arm is IN the breaker cohort: a melting-down routed
    # backend trips its own breaker, not the torch floor's
    assert svc._cohort(svc._queue[0].request) \
        == f"40x40:auto:{BACKEND_RESIDENT}"
    outs = svc.drain()
    assert all(o.converged for o in outs)
    st = svc.stats()
    assert st["lost"] == 0
    assert st["router"]["decisions"] == 1
    assert st["router"]["chosen"] == {BACKEND_RESIDENT: 1}


def test_routed_mixed_run_spans_backends_zero_lost():
    """The acceptance shape: a router-on run under an injected slow
    backend draws misprediction + demotion + recovery, spans ≥2
    distinct backends, and loses nothing (the chaos scenario asserts
    the same end to end; this is the in-suite pin)."""
    from poisson_tpu_torch.testing import chaos

    report = chaos.run_scenario("router-mispredict-downshift", seed=0, device="cpu")
    assert report["ok"], report
    assert report["checks"]["traffic_spanned_backends"]
    assert report["checks"]["healthy_probe_recovered"]
    assert report["checks"]["no_lost_requests"]


def test_journal_snapshot_warm_loads_on_recover(tmp_path):
    from poisson_tpu_torch.serve import SolveJournal

    jpath = str(tmp_path / "serve.journal")
    vc0 = VirtualClock()
    svc = SolveService(ServicePolicy(capacity=16),
                       clock=vc0, sleep=vc0.sleep,
                       journal=SolveJournal(jpath, clock=vc0),
                       dispatch_fault=lambda reqs, att: vc0.advance(
                           1e-3), device="cpu")
    for i in range(3):
        svc.submit(SolveRequest(request_id=f"w{i}", problem=P40))
    svc.drain()
    assert os.path.exists(snapshot_path(jpath))
    vc = VirtualClock()
    revived = SolveService.recover(SolveJournal(jpath, clock=vc),
                                   ServicePolicy(capacity=16),
                                   clock=vc, sleep=vc.sleep, device="cpu")
    assert revived._roofline.backend_fraction("torch") is not None


# -- routed cohorts ----------------------------------------------------
# (In place of the JAX suite's bench-sentinel cohort pin: the port has
# no bench serve mode yet.)


def test_routed_cohort_carries_the_arm():
    """A routed service labels its cohorts with the chosen arm, while
    the gate keeps every dispatch on the torch solve: each non-floor
    choice is one executor fallback."""
    vc = VirtualClock()
    svc = SolveService(
        ServicePolicy(capacity=8, router=RouterPolicy(
            assume_available=(BACKEND_RESIDENT,))),
        clock=vc, sleep=vc.sleep, device="cpu")
    svc.submit(SolveRequest(request_id=0, problem=P40))
    assert svc._cohort(svc._queue[0].request) == "40x40:auto:resident"
    outs = svc.drain()
    assert outs[0].converged and outs[0].iterations == 50
    assert metrics.get("serve.router.chosen.resident") == 1
    assert metrics.get("serve.router.executor_fallbacks") == 1


# -- the scoreboard ------------------------------------------------------


def test_scoreboard_backends_pane_agrees_across_sources():
    vc = VirtualClock()
    router = _router(vc)
    d = router.route(M=40, N=40, dtype_bytes=8)
    vc.advance(1.0)
    router.grade(d, router.roofline.observe(
        backend=BACKEND_RESIDENT, M=40, N=40, iterations=50,
        seconds=1.0))
    router.route(M=40, N=40, dtype_bytes=8)
    snap = metrics.snapshot()
    live = forecast.build_scoreboard(snap)
    wire = forecast.build_scoreboard(export.parse_text(
        export.render(snap)))
    assert live["backends"] == wire["backends"]
    assert live["backends"]["decisions"] == 2
    assert live["backends"]["mispredictions"] == 1
    assert live["backends"]["chosen"]
    text = forecast.render_scoreboard(live)
    assert "backends" in text and "mispred" in text
    # pre-router snapshots still render (dark pane, no crash)
    old = dict(live)
    old.pop("backends", None)
    assert forecast.render_scoreboard(old)
