"""Port parity: session steps (``poisson_tpu_torch.solvers.session``: the
warm gate, warm and cold Poisson steps, implicit-Euler heat steps, the
shifted setup and the design step) against ``poisson_tpu.solvers.session``,
on the CPU.

Tolerances: ``warm_drift``/``warm_validity`` values and reasons, the
fallback reasons and every ``session.*`` counter equal JAX's; the cold
step equals the port's ``pcg_solve`` bit for bit; the fp64 shifted setup
equals JAX's bit for bit (both are the same host numpy fp64); counts equal
JAX's, with fp64 iterates within 1e-10; the design step's params, loss and
gradients within 1e-6 relative of JAX's.
"""

import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.geometry import Ellipse as JaxEllipse
from poisson_tpu.geometry import Rectangle as JaxRectangle
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import session as jax_session
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry.dsl import Ellipse, Rectangle
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers import session
from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve

CPU = dict(device="cpu")
P32, JP32 = Problem(32, 32), JaxProblem(32, 32)


def _reset():
    for reset in (metrics.reset, jax_metrics.reset,
                  session.reset_session_cache,
                  jax_session.reset_session_cache):
        reset()


@pytest.fixture(autouse=True)
def _fresh():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset()
    yield
    _reset()
    torch.set_num_threads(saved)


def _same_session_counters():
    names = sorted({n for n in list(metrics.snapshot()["counters"])
                    + list(jax_metrics.snapshot()["counters"])
                    if n.startswith("session.")})
    assert names
    for n in names:
        assert metrics.get(n) == jax_metrics.get(n), n


# (port spec, JAX spec) pairs; None is the reference ellipse.
_SPECS = {
    "none": (None, None),
    "default": (Ellipse(), JaxEllipse()),
    "cx0.1": (Ellipse(cx=0.1), JaxEllipse(cx=0.1)),
    "cx0.12": (Ellipse(cx=0.12), JaxEllipse(cx=0.12)),
    "cx0.9": (Ellipse(cx=0.9), JaxEllipse(cx=0.9)),
    "ry0.47": (Ellipse(ry=0.47), JaxEllipse(ry=0.47)),
    "rect": (Rectangle(x0=-0.5, y0=-0.3, x1=0.5, y1=0.3),
             JaxRectangle(x0=-0.5, y0=-0.3, x1=0.5, y1=0.3)),
}
_PAIRS = [("cx0.1", "cx0.1"), ("cx0.1", "cx0.12"), ("cx0.1", "cx0.9"),
          ("rect", "cx0.1"), ("none", "cx0.1"), ("none", "none"),
          ("default", "ry0.47"), ("rect", "rect")]


@pytest.mark.parametrize("prev,cur", _PAIRS,
                         ids=[f"{a}-{b}" for a, b in _PAIRS])
def test_warm_drift_and_validity_are_jax_s(prev, cur):
    (mp, jp), (mc, jc) = _SPECS[prev], _SPECS[cur]
    assert session.warm_drift(mp, mc) == jax_session.warm_drift(jp, jc)
    assert session.warm_validity(mp, mc) == jax_session.warm_validity(jp, jc)
    assert session.warm_validity(mp, mc, 0.5) == jax_session.warm_validity(
        jp, jc, 0.5)
    assert session.DEFAULT_DRIFT_BOUND == jax_session.DEFAULT_DRIFT_BOUND
    assert (session.DEFAULT_RESIDUAL_FACTOR
            == jax_session.DEFAULT_RESIDUAL_FACTOR)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_cold_step_is_pcg_solve_bit_for_bit(dtype):
    got, info = session.session_step_solve(P32, dtype=dtype,
                                           geometry=Ellipse(), **CPU)
    want = pcg_solve(P32, dtype=dtype, geometry=Ellipse(), **CPU)
    assert info == {"warm_used": False, "fallback": "none"}
    assert torch.equal(got.w, want.w)
    assert int(got.iterations) == int(want.iterations)
    jax_got, _ = jax_session.session_step_solve(JP32, dtype=dtype,
                                                geometry=JaxEllipse())
    assert int(got.iterations) == int(jax_got.iterations)
    assert metrics.get("session.warm.fallbacks") == 0


def test_valid_warm_start_cuts_iterations_as_jax_s():
    cold, _ = session.session_step_solve(P32, geometry=Ellipse(), **CPU)
    jcold, _ = jax_session.session_step_solve(JP32, geometry=JaxEllipse())
    warm, info = session.session_step_solve(
        P32, geometry=Ellipse(cx=5e-4), warm=cold.w.numpy(),
        warm_geometry=Ellipse(), **CPU)
    jwarm, jinfo = jax_session.session_step_solve(
        JP32, geometry=JaxEllipse(cx=5e-4), warm=np.asarray(jcold.w),
        warm_geometry=JaxEllipse())
    assert info == jinfo == {"warm_used": True, "fallback": ""}
    assert int(warm.flag) == FLAG_CONVERGED
    assert int(warm.iterations) < int(cold.iterations)
    assert int(warm.iterations) == int(jwarm.iterations)
    np.testing.assert_allclose(warm.w.numpy(), np.asarray(jwarm.w), rtol=0,
                               atol=1e-10)
    again, _ = session.session_step_solve(P32, geometry=Ellipse(),
                                          warm=cold.w, warm_geometry=Ellipse(),
                                          **CPU)
    assert torch.allclose(again.w, cold.w, atol=1e-5)
    assert metrics.get("session.warm.hits") == 2
    assert jax_metrics.get("session.warm.hits") == 1


@pytest.mark.parametrize("stale,reason", [
    ("cx0.9", "drift"), ("rect", "family"), ("garbage", "residual")])
def test_stale_warm_start_falls_back_cold_audibly(stale, reason):
    cold, _ = session.session_step_solve(P32, geometry=Ellipse(), **CPU)
    jcold, _ = jax_session.session_step_solve(JP32, geometry=JaxEllipse())
    w, jw = cold.w.numpy(), np.asarray(jcold.w)
    if stale == "garbage":
        # A checkerboard at 1e12: in-bounds drift, absurd residual.
        i, j = np.indices(w.shape)
        w = jw = np.where((i + j) % 2 == 0, 1e12, -1e12)
        prev, jprev = Ellipse(), JaxEllipse()
    else:
        prev, jprev = _SPECS[stale]
    got, info = session.session_step_solve(P32, geometry=Ellipse(), warm=w,
                                           warm_geometry=prev, **CPU)
    want, jinfo = jax_session.session_step_solve(
        JP32, geometry=JaxEllipse(), warm=jw, warm_geometry=jprev)
    assert info == jinfo == {"warm_used": False, "fallback": reason}
    assert int(got.flag) == FLAG_CONVERGED
    assert torch.equal(got.w, cold.w)          # the cold path, bit for bit
    session.session_step_solve(P32, geometry=Ellipse(), **CPU)
    jax_session.session_step_solve(JP32, geometry=JaxEllipse())
    assert metrics.get("session.warm.fallbacks") == 1
    _same_session_counters()


def test_shape_mismatch_falls_back():
    got, info = session.session_step_solve(
        P32, warm=np.zeros((5, 5)), warm_geometry=None, **CPU)
    assert info == {"warm_used": False, "fallback": "shape"}
    assert int(got.flag) == FLAG_CONVERGED


@pytest.mark.parametrize("geometry", [None, "cx0.1"])
@pytest.mark.parametrize("dtype,scaled", [("float64", False),
                                          ("float64", True),
                                          ("float32", True)])
def test_shifted_setup_is_jax_s_bit_for_bit(geometry, dtype, scaled):
    spec, jspec = _SPECS["none" if geometry is None else geometry]
    got = session.shifted_setup(P32, spec, dtype, scaled, 2.5, **CPU)
    want = jax_session.shifted_setup(JP32, jspec, dtype, scaled, 2.5)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert session.shifted_setup(P32, spec, dtype, scaled, 2.5,
                                 **CPU) is got
    jax_session.shifted_setup(JP32, jspec, dtype, scaled, 2.5)
    _same_session_counters()


def test_heat_step_cold_and_warm_are_jax_s():
    kw = dict(mass_shift=1.0, rhs_gate=1.0)
    cold, info = session.session_step_solve(P32, geometry=Ellipse(), **kw,
                                            **CPU)
    jcold, _ = jax_session.session_step_solve(JP32, geometry=JaxEllipse(),
                                              **kw)
    assert int(cold.iterations) == int(jcold.iterations)
    np.testing.assert_allclose(cold.w.numpy(), np.asarray(jcold.w), rtol=0,
                               atol=1e-10)
    warm, info = session.session_step_solve(
        P32, geometry=Ellipse(), warm=cold.w, warm_geometry=Ellipse(),
        u_prev=cold.w, **kw, **CPU)
    jwarm, jinfo = jax_session.session_step_solve(
        JP32, geometry=JaxEllipse(), warm=np.asarray(jcold.w),
        warm_geometry=JaxEllipse(), u_prev=np.asarray(jcold.w), **kw)
    assert info == jinfo == {"warm_used": True, "fallback": ""}
    assert int(warm.iterations) == int(jwarm.iterations)
    np.testing.assert_allclose(warm.w.numpy(), np.asarray(jwarm.w), rtol=0,
                               atol=1e-10)
    _same_session_counters()


def test_heat_steps_contract_to_the_poisson_steady_state():
    """Six implicit-Euler steps, each from the last (as the JAX service
    drives them: the previous iterate is uⁿ and the warm start), contract
    monotonically onto the Poisson solution."""
    steady = pcg_solve(P32, geometry=Ellipse(), **CPU).w
    u, errs = None, []
    for _ in range(6):
        r, info = session.session_step_solve(
            P32, geometry=Ellipse(), mass_shift=1.0, rhs_gate=1.0, warm=u,
            warm_geometry=Ellipse() if u is not None else None, u_prev=u,
            **CPU)
        assert int(r.flag) == FLAG_CONVERGED
        assert info["warm_used"] == (u is not None)
        u = r.w
        errs.append(float(torch.linalg.norm(u - steady)))
    assert all(b < a for a, b in zip(errs, errs[1:]))
    assert errs[-1] < 2e-2 * errs[0]


def test_negative_mass_shift_refused():
    with pytest.raises(ValueError, match="mass_shift must be >= 0"):
        session.session_step_solve(P32, mass_shift=-1.0, **CPU)


def test_design_step_is_jax_s():
    params = {"cx": 0.05, "cy": 0.02, "rx": 0.8, "ry": 0.45}
    target = pcg_solve(P32, **CPU).w.numpy()
    new, loss, grads = session.design_step(P32, params, target, 0.1,
                                           dtype="float64", **CPU)
    jnew, jloss, jgrads = jax_session.design_step(JP32, params, target, 0.1,
                                                  dtype="float64")
    assert set(new) == set(jnew) == set(params)
    for k in params:
        assert new[k] == pytest.approx(jnew[k], rel=1e-6)
        assert grads[k] == pytest.approx(jgrads[k], rel=1e-6)
        assert grads[k] != 0.0
    assert loss == pytest.approx(jloss, rel=1e-6)
    _same_session_counters()
