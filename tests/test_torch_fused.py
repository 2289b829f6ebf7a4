"""Port parity: the fused canvas path (``poisson_tpu_torch.ops.fused_cg``)
against ``poisson_tpu.ops.pallas_cg``, on the CPU.

Both packages get the same canvases (the JAX ``build_canvases`` arrays,
carried across by ``poisson_tpu_torch.interop``) and the same seeded inputs.
The JAX kernels run in interpret mode, as tests/test_pallas.py runs them;
the port's wrappers run their plain versions, because the tensors lie on the
CPU. The port's canvas is one strip, so the JAX canvas is built at the same
strip height (``bm = cv.bm``) to share the geometry.

Tolerances: kernel outputs atol 1e-6 on the live band (the JAX outputs'
guard rows are unwritten) and partial sums rtol 1e-5 (fp32, the sums taken
in another order). Solves give the same count as ``pallas_cg_solve``, with
iterates within 1e-6 of the JAX fp64 solve: at 80×120 the Pallas iterate
itself lies 1.27e-6 from the fp64 solution (XLA's fp32 sums), the port's
5.8e-8."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_cg
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import canvases_from_reference
from poisson_tpu_torch.ops import fused_cg
from poisson_tpu_torch.ops.fused_cg import HALO

KERNEL_GRIDS = [(24, 40), (80, 120)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's thread pools oversubscribe the cores (a 4 s solve
    took 300 s so)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _reference(M, N):
    """JAX canvases at the port's geometry, and the same carried across."""
    cv = fused_cg.canvas_spec(Problem(M=M, N=N))
    ref = pallas_cg.build_canvases(JaxProblem(M=M, N=N), cv.bm, "float32", 0)
    port = canvases_from_reference(ref[0]._asdict(), *ref[1:], device="cpu")
    return ref, port


def _interior_random(cv, M, N, rng):
    x = np.zeros((cv.rows, cv.cols), np.float32)
    x[HALO : HALO + M - 1, 1:N] = rng.standard_normal((M - 1, N - 1))
    return x


@pytest.mark.parametrize("M,N", KERNEL_GRIDS)
def test_canvases_equal_jax_build_canvases(M, N):
    p = Problem(M=M, N=N)
    cv, *got = fused_cg.build_canvases(p, device="cpu")
    ref = pallas_cg.build_canvases(JaxProblem(M=M, N=N), cv.bm, "float32", 0)
    assert (cv.rows, cv.cols) == (ref[0].rows, ref[0].cols)
    assert cv.nb == ref[0].nb == 1
    for g, w in zip(got, ref[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("M,N", KERNEL_GRIDS)
def test_direction_and_stencil_matches_jax_kernel(M, N):
    (jcv, jcs, jcw, jg, *_), (cv, cs, cw, g, *_) = _reference(M, N)
    rng = np.random.default_rng(M)
    z = _interior_random(cv, M, N, rng)
    p = _interior_random(cv, M, N, rng)
    beta = np.float32(0.37)
    want_pn, want_ap, want_part = pallas_cg.direction_and_stencil(
        jcv, jnp.full((1, 1), beta), jnp.asarray(z), jnp.asarray(p),
        jcs, jcw, jg, interpret=True)
    pn, ap, part = fused_cg.direction_and_stencil(
        cv, torch.tensor(beta), torch.tensor(z), torch.tensor(p), cs, cw, g)
    band = slice(HALO, cv.rows - HALO)
    np.testing.assert_allclose(pn[band].numpy(), np.asarray(want_pn)[band],
                               atol=1e-6)
    np.testing.assert_allclose(ap[band].numpy(), np.asarray(want_ap)[band],
                               atol=1e-6)
    assert (pn[:HALO] == 0).all() and (ap[cv.rows - HALO :] == 0).all()
    assert part.shape == (fused_cg.n_partials(cv),)
    np.testing.assert_allclose(float(part.sum()), float(want_part.sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("M,N", KERNEL_GRIDS)
def test_fused_update_matches_jax_kernel(M, N):
    (jcv, *_, jsc2, _), (cv, *_, sc2, _) = _reference(M, N)
    rng = np.random.default_rng(N)
    p, ap, w, r = (_interior_random(cv, M, N, rng) for _ in range(4))
    alpha = np.float32(0.21)
    want = pallas_cg.fused_update(
        jcv, jnp.full((1, 1), alpha), jnp.asarray(p), jnp.asarray(ap), jsc2,
        jnp.asarray(w), jnp.asarray(r), interpret=True)
    w_t, r_t = torch.tensor(w), torch.tensor(r)
    got = fused_cg.fused_update(cv, torch.tensor(alpha), torch.tensor(p),
                                torch.tensor(ap), sc2, w_t, r_t)
    assert got[0] is w_t and got[1] is r_t          # updated in place
    np.testing.assert_allclose(w_t.numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(r_t.numpy(), np.asarray(want[1]), atol=1e-6)
    for g, wp in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(g.sum()), float(wp.sum()),
                                   rtol=1e-5)


@pytest.mark.parametrize("M,N", [(40, 40), (80, 120)])
def test_fused_solve_matches_pallas_cg_solve(M, N):
    r = fused_cg.fused_cg_solve(Problem(M=M, N=N), device="cpu")
    ref = pallas_cg.pallas_cg_solve(JaxProblem(M=M, N=N), interpret=True)
    assert int(r.iterations) == int(ref.iterations)
    w64 = jax_pcg_solve(JaxProblem(M=M, N=N), dtype=jnp.float64).w
    np.testing.assert_allclose(r.w.numpy(), np.asarray(w64), atol=1e-6)


def test_fused_solve_on_reference_canvases():
    """The solve driven on the JAX canvases carried across gives the same
    count as on the port's own."""
    M, N = 40, 40
    _, (cv, cs, cw, g, rhs, sc2, _) = _reference(M, N)
    s = fused_cg._fused_solve(Problem(M=M, N=N), cv, cs, cw, g, rhs, sc2)
    assert int(s.k) == 50 and bool(s.done)


@pytest.mark.parametrize("M,N,expected", [(400, 600, 546), (800, 1200, 989)])
def test_fused_golden_counts_on_cpu(M, N, expected):
    r = fused_cg.fused_cg_solve(Problem(M=M, N=N), device="cpu")
    assert int(r.iterations) == expected
    assert float(r.diff) < 1e-6


def test_zero_rhs_stops_cleanly():
    """ζ = 0 ⇒ the first ⟨Ap, pn⟩ is 0 ⇒ α is forced to 0: one iteration,
    w = 0 and diff reported as 0 (the JAX fused path's corner)."""
    p = Problem(M=16, N=16, max_iter=5)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, device="cpu")
    s = fused_cg._fused_solve(p, cv, cs, cw, g, torch.zeros_like(rhs), sc2)
    assert int(s.k) == 1 and bool(s.done)
    assert (s.w == 0).all() and float(s.diff) == 0.0


def test_done_state_is_frozen():
    """Iterations after the stop change neither count nor iterate."""
    p = Problem(M=40, N=40)
    a = fused_cg.fused_cg_solve(p, device="cpu", check_every=1)
    b = fused_cg.fused_cg_solve(p, device="cpu", check_every=500)
    assert int(a.iterations) == int(b.iterations) == 50
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_canvas_grid_round_trip_matches_jax():
    p, jp = Problem(M=24, N=40), JaxProblem(M=24, N=40)
    cv = fused_cg.canvas_spec(p)
    jcv = pallas_cg.canvas_spec(jp, cv.bm, 0)
    full = np.random.default_rng(3).standard_normal(p.grid_shape)
    full[0], full[-1], full[:, 0], full[:, -1] = 0, 0, 0, 0
    c = fused_cg._full_to_canvas(p, cv, full, device="cpu")
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(pallas_cg._full_to_canvas(jp, jcv, full)))
    np.testing.assert_array_equal(fused_cg._canvas_to_full(p, cv, c), full)


def test_wrappers_reject_what_the_kernels_do_not_take():
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(
        Problem(M=24, N=40), device="cpu")
    beta = torch.zeros(())
    z = rhs.clone()
    with pytest.raises(ValueError, match="float32"):
        fused_cg.direction_and_stencil(cv, beta, z.double(), z, cs, cw, g)
    with pytest.raises(ValueError, match="alias"):
        fused_cg.direction_and_stencil(cv, beta, z, z, cs, cw, g,
                                       out=(z, torch.zeros_like(z)))
    with pytest.raises(ValueError, match="shape"):
        fused_cg.fused_update(cv, beta, z[:-1], z, sc2, z.clone(), z.clone())
    with pytest.raises(ValueError, match="scalar"):
        fused_cg.fused_update(cv, beta.double(), z, z, sc2, z.clone(),
                              z.clone())
