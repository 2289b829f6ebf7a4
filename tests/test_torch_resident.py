"""Port parity: the resident solve (``poisson_tpu_torch.ops.resident``)
against ``poisson_tpu.ops.pallas_resident``, on the CPU.

The JAX kernel runs in interpret mode, as tests/test_pallas_resident.py runs
it; the port's wrapper runs kernel R's plain version, because the tensors lie
on the CPU. Counts equal the JAX resident solve's; iterates lie within 1e-6
of the JAX fp64 solve (the JAX fp32 iterates are the less accurate side,
ROADMAP Queue 3), or of the port's fused solve where the fp64 oracle stops
elsewhere (the unweighted norm)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_cg, pallas_resident
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import canvases_from_reference
from poisson_tpu_torch.ops import fused_cg, launch, resident


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("M,N", [(40, 40), (40, 300)],
                         ids=["40x40", "40x300_lane_padding"])
def test_resident_matches_jax_resident_cg_solve(M, N):
    """40×300: 301 columns padded to 384, which must stay inert in the
    whole-band sums."""
    r = resident.resident_cg_solve(Problem(M=M, N=N), device="cpu")
    ref = pallas_resident.resident_cg_solve(JaxProblem(M=M, N=N),
                                            interpret=True)
    assert int(r.iterations) == int(ref.iterations)
    assert float(r.diff) < 1e-6
    if (M, N) == (40, 40):
        assert int(r.iterations) == 50
    w64 = jax_pcg_solve(JaxProblem(M=M, N=N), dtype=jnp.float64).w
    np.testing.assert_allclose(r.w.numpy(), np.asarray(w64), atol=1e-6)


def test_unweighted_norm_matches_jax():
    r = resident.resident_cg_solve(Problem(M=40, N=40, weighted_norm=False),
                                   device="cpu")
    ref = pallas_resident.resident_cg_solve(
        JaxProblem(M=40, N=40, weighted_norm=False), interpret=True)
    fused = fused_cg.fused_cg_solve(Problem(M=40, N=40, weighted_norm=False),
                                    device="cpu")
    assert int(r.iterations) == int(ref.iterations) == int(fused.iterations)
    np.testing.assert_allclose(r.w.numpy(), fused.w.numpy(), atol=1e-6)


def test_golden_400x600():
    r = resident.resident_cg_solve(Problem(M=400, N=600), device="cpu")
    assert int(r.iterations) == 546
    assert float(r.diff) < 1e-6
    w64 = jax_pcg_solve(JaxProblem(M=400, N=600), dtype=jnp.float64).w
    np.testing.assert_allclose(r.w.numpy(), np.asarray(w64), atol=1e-6)


def test_iteration_cap_truncates():
    p = dict(M=40, N=40, delta=1e-30, max_iter=12)
    r = resident.resident_cg_solve(Problem(**p), device="cpu")
    ref = pallas_resident.resident_cg_solve(JaxProblem(**p), interpret=True)
    assert int(r.iterations) == int(ref.iterations) == 12
    np.testing.assert_allclose(r.w.numpy(), np.asarray(ref.w), atol=1e-6)


@pytest.mark.parametrize("M,N", [(40, 40), (40, 300), (56, 56), (200, 300),
                                 (100, 1000), (400, 600), (400, 640)])
def test_gate_admits_every_grid_jax_admits(M, N):
    assert pallas_resident.fits_resident(JaxProblem(M=M, N=N))
    assert resident.fits_resident(Problem(M=M, N=N))


def test_gate_budget_and_refusal():
    """9 canvases against 40 MB: 800×1200 (37.6 MB) is admitted here though
    not by the TPU's VMEM gate; 2400×3200 (289.5 MB) is refused, naming
    the budget, before anything is built."""
    assert not pallas_resident.fits_resident(JaxProblem(M=800, N=1200))
    assert resident.fits_resident(Problem(M=800, N=1200))
    assert resident.resident_bytes(Problem(M=800, N=1200)) == 37_601_280
    big = Problem(M=2400, N=3200)
    assert not resident.fits_resident(big)
    with pytest.raises(ValueError, match="40 MB residency budget"):
        resident.resident_cg_solve(big, device="cpu")
    with pytest.raises(ValueError, match="budget"):
        resident.resident_cg_solve_rhs(big, np.zeros(big.grid_shape),
                                       device="cpu")


def test_rhs_gate_is_bit_exact():
    p = Problem(M=40, N=40)
    a = resident.resident_cg_solve(p, device="cpu")
    b = resident.resident_cg_solve(p, device="cpu", rhs_gate=1.0)
    assert int(a.iterations) == int(b.iterations)
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_solve_rhs_matches_jax():
    """An arbitrary RHS grid through both packages' resident hooks."""
    p = Problem(M=40, N=40)
    rhs = np.random.default_rng(5).standard_normal(p.grid_shape)
    rhs[0], rhs[-1], rhs[:, 0], rhs[:, -1] = 0, 0, 0, 0
    w64, k = resident.resident_cg_solve_rhs(p, rhs, device="cpu")
    want, want_k = pallas_resident.resident_cg_solve_rhs(
        JaxProblem(M=40, N=40), rhs, interpret=True)
    assert k == want_k
    np.testing.assert_allclose(w64, want, atol=1e-6)


def test_resident_on_reference_canvases():
    """Driven on the JAX canvases carried across, the same count."""
    p = Problem(M=40, N=40)
    cv = fused_cg.canvas_spec(p)
    ref = pallas_cg.build_canvases(JaxProblem(M=40, N=40), cv.bm, "float32",
                                   0)
    cv, cs, cw, g, rhs, sc2, _ = canvases_from_reference(
        ref[0]._asdict(), *ref[1:], device="cpu")
    _, k, diff, _ = resident.resident_solve(p, cv, cs, cw, g, rhs, sc2)
    assert int(k) == 50 and float(diff) < 1e-6


def test_done_state_is_frozen():
    """Iterations after the stop change neither count nor iterate."""
    p = Problem(M=40, N=40)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, device="cpu")
    a = resident.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2,
                                      check_every=1)
    b = resident.resident_solve_plain(p, cv, cs, cw, g, rhs, sc2,
                                      check_every=500)
    assert int(a[1]) == int(b[1]) == 50
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_zero_rhs_stops_cleanly():
    """ζ = 0 ⇒ ⟨Ap, pn⟩ = 0 ⇒ α forced to 0: one iteration, w = 0, diff 0
    (``pallas_resident.py:123-134``)."""
    p = Problem(M=16, N=16, max_iter=5)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, device="cpu")
    w, k, diff, _ = resident.resident_solve(p, cv, cs, cw, g,
                                            torch.zeros_like(rhs), sc2)
    assert int(k) == 1 and float(diff) == 0.0 and (w == 0).all()


def test_cpu_solve_launches_no_kernel():
    launch.reset_launch_counts()
    resident.resident_cg_solve(Problem(M=24, N=24), device="cpu")
    assert launch.launch_counts("resident_solve") == {"resident_solve": 0}
