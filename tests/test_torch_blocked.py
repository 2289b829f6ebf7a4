"""Port parity: the column-blocked fused path (kernels A′ and B′ of
``poisson_tpu_torch.ops.fused_cg``) against ``poisson_tpu.ops.pallas_cg``,
on the CPU.

Both packages get the same canvases and the same seeded inputs; the JAX
kernels run in interpret mode, as tests/test_pallas.py runs them, and the
port's wrappers run their plain versions, because the tensors lie on the
CPU.

Tolerances: canvases are compared bit for bit. Kernel fields atol 1e-6 on
the centre tiles (the JAX outputs' guard regions are unwritten), partial
sums rtol 1e-5 (fp32, summed in another order). Blocked solves give the JAX
blocked solve's count, with iterates within 1e-6 of the JAX fp64 solve (the
fused path's tolerance, tests/test_torch_fused.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_cg
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import canvases_from_reference
from poisson_tpu_torch.ops import fused_cg, launch
from poisson_tpu_torch.ops.fused_cg import HALO
from poisson_tpu_torch.solvers.refine import refined_solve


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


# (M, N, bm, bn): the port's canvas_spec equals the JAX one for each. On
# the full-width canvas with bm=None the port keeps one strip, where the
# JAX package cuts VMEM-sized strips: there the JAX canvas is asked for at
# the port's strip height, and its columns must agree with the JAX default.
SPEC_CASES = [
    (64, 20000, None, None),    # auto-blocks: bn 2048
    (64, 20000, 8, None),       # an explicit bm keeps full width
    (64, 20000, None, 1024),
    (64, 20000, None, 0),
    (2400, 3200, None, None),   # wide enough for full width
    (16, 40, None, None),
    (1024, 16384, None, None),  # the card's wide probe: bn 2048, ncb 9
]


@pytest.mark.parametrize("M,N,bm,bn", SPEC_CASES)
def test_canvas_spec_equals_jax(M, N, bm, bn):
    cv = fused_cg.canvas_spec(Problem(M=M, N=N), bm, bn)
    jp = JaxProblem(M=M, N=N)
    full_width_default = bm is None and not cv.cg
    want = pallas_cg.canvas_spec(jp, cv.bm if full_width_default else bm, bn)
    assert cv._asdict() == want._asdict()
    assert cv.cols == pallas_cg.canvas_spec(jp, bm, bn).cols
    if (M, N) == (1024, 16384):
        assert (cv.bn, cv.ncb, cv.rows, cv.cols) == (2048, 9, 1136, 18688)


def test_canvas_spec_rejects_what_jax_rejects():
    p = Problem(M=40, N=300)
    with pytest.raises(ValueError, match="bn"):
        fused_cg.canvas_spec(p, bn=100)
    with pytest.raises(ValueError, match="bm"):
        fused_cg.canvas_spec(p, bm=12, bn=128)


@pytest.mark.parametrize("M,N,bn", [(1024, 16384, None), (1024, 16384, 0),
                                    (2400, 3200, 1024)])
def test_sweep_points_count_the_interior_of_a_blocked_canvas(M, N, bn):
    """The bytes model of a sweep: the band at full width; on the blocked
    canvas the grid's interior, not the guard columns or block padding."""
    p = Problem(M=M, N=N)
    cv = fused_cg.canvas_spec(p, bn=bn)
    swept = (cv.rows - 2 * HALO) * (cv.cols - 2 * cv.cg)
    got = fused_cg.sweep_points(p, cv)
    if cv.cg:
        assert got == (M - 1) * (N - 1) < swept
    else:
        assert got == swept


@pytest.mark.parametrize("M,N,bm,bn", [(40, 300, None, 128),
                                       (80, 300, 16, 256)])
def test_blocked_canvases_equal_jax_build_canvases(M, N, bm, bn):
    cv, *got = fused_cg.build_canvases(Problem(M=M, N=N), "cpu", bm, bn)
    ref = pallas_cg.build_canvases(JaxProblem(M=M, N=N), bm, "float32", bn)
    assert cv._asdict() == ref[0]._asdict() and cv.cg == 128
    for g, w in zip(got, ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _blocked_reference(M, N, bm, bn):
    ref = pallas_cg.build_canvases(JaxProblem(M=M, N=N), bm, "float32", bn)
    port = canvases_from_reference(ref[0]._asdict(), *ref[1:], device="cpu")
    return ref, port


def _content_random(cv, M, N, rng):
    """Seeded values on the interior, zero elsewhere (the canvas
    invariant), at content columns cg + 1 .. cg + N − 1."""
    x = np.zeros((cv.rows, cv.cols), np.float32)
    x[HALO : HALO + M - 1, cv.cg + 1 : cv.cg + N] = rng.standard_normal(
        (M - 1, N - 1))
    return x


def _tiles(cv):
    return (slice(HALO, cv.rows - HALO), slice(cv.cg, cv.cols - cv.cg))


BLOCKED_KERNEL_CASES = [(40, 300, 16, 128), (80, 300, None, 256)]


@pytest.mark.parametrize("M,N,bm,bn", BLOCKED_KERNEL_CASES)
def test_blocked_direction_and_stencil_matches_jax_kernel(M, N, bm, bn):
    (jcv, jcs, jcw, jg, *_), (cv, cs, cw, g, *_) = _blocked_reference(
        M, N, bm, bn)
    rng = np.random.default_rng(M + N)
    z, p = (_content_random(cv, M, N, rng) for _ in range(2))
    beta = np.float32(0.37)
    want_pn, want_ap, want_part = pallas_cg.direction_and_stencil(
        jcv, jnp.full((1, 1), beta), jnp.asarray(z), jnp.asarray(p),
        jcs, jcw, jg, interpret=True)
    pn, ap, part = fused_cg.direction_and_stencil(
        cv, torch.tensor(beta), torch.tensor(z), torch.tensor(p), cs, cw, g)
    t = _tiles(cv)
    np.testing.assert_allclose(pn[t].numpy(), np.asarray(want_pn)[t],
                               atol=1e-6)
    np.testing.assert_allclose(ap[t].numpy(), np.asarray(want_ap)[t],
                               atol=1e-6)
    # Guard columns and rows are never written.
    assert (pn[:, : cv.cg] == 0).all() and (ap[:, cv.cols - cv.cg :] == 0).all()
    assert (pn[:HALO] == 0).all()
    assert part.shape == (fused_cg.n_partials(cv),)
    assert np.asarray(want_part).shape == (cv.nb, cv.ncb)
    np.testing.assert_allclose(float(part.sum()), float(want_part.sum()),
                               rtol=1e-5)
    # Partials come in the Pallas grid's order: each JAX tile's are a run.
    run = fused_cg.serial_run(cv, M - 1)
    np.testing.assert_allclose(
        part.reshape(-1, run).sum(dim=1).numpy(),
        np.asarray(want_part).reshape(-1), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("M,N,bm,bn", BLOCKED_KERNEL_CASES)
def test_blocked_fused_update_matches_jax_kernel(M, N, bm, bn):
    (jcv, *_, jsc2, _), (cv, *_, sc2, _) = _blocked_reference(M, N, bm, bn)
    rng = np.random.default_rng(M * N)
    p, ap, w, r = (_content_random(cv, M, N, rng) for _ in range(4))
    alpha = np.float32(0.21)
    want = pallas_cg.fused_update(
        jcv, jnp.full((1, 1), alpha), jnp.asarray(p), jnp.asarray(ap), jsc2,
        jnp.asarray(w), jnp.asarray(r), interpret=True)
    w_t, r_t = torch.tensor(w), torch.tensor(r)
    got = fused_cg.fused_update(cv, torch.tensor(alpha), torch.tensor(p),
                                torch.tensor(ap), sc2, w_t, r_t)
    assert got[0] is w_t and got[1] is r_t          # updated in place
    t = _tiles(cv)
    np.testing.assert_allclose(w_t[t].numpy(), np.asarray(want[0])[t],
                               atol=1e-6)
    np.testing.assert_allclose(r_t[t].numpy(), np.asarray(want[1])[t],
                               atol=1e-6)
    for gp, wp in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(gp.sum()), float(wp.sum()),
                                   rtol=1e-5)


def test_blocked_kernels_count_their_own_form_and_refuse_a_mask():
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(
        Problem(M=24, N=300), "cpu", None, 128)
    launch.reset_launch_counts()
    beta = torch.zeros(())
    z = rhs.clone()
    fused_cg.direction_and_stencil(cv, beta, z, torch.zeros_like(z), cs, cw,
                                   g)
    assert not any(launch.launch_counts().values())   # CPU: plain only
    with pytest.raises(ValueError, match="single-device"):
        fused_cg.direction_and_stencil(cv, beta, z, torch.zeros_like(z), cs,
                                       cw, g,
                                       colmask=torch.ones((1, cv.cols)))
    with pytest.raises(ValueError, match="single-device"):
        fused_cg.fused_update(cv, beta, z, z, sc2, z.clone(), z.clone(),
                              colmask=torch.ones((1, cv.cols)))


@pytest.mark.parametrize("M,N,bm,bn", [(40, 40, 16, 128), (40, 300, 16, 128),
                                       (80, 300, None, 256)])
def test_blocked_solve_matches_pallas_cg_solve(M, N, bm, bn):
    r = fused_cg.fused_cg_solve(Problem(M=M, N=N), device="cpu", bm=bm,
                                bn=bn)
    ref = pallas_cg.pallas_cg_solve(JaxProblem(M=M, N=N), bm=bm, bn=bn,
                                    interpret=True)
    assert int(r.iterations) == int(ref.iterations)
    if (M, N) == (40, 40):
        assert int(r.iterations) == 50
    w64 = jax_pcg_solve(JaxProblem(M=M, N=N), dtype=jnp.float64).w
    np.testing.assert_allclose(r.w.numpy(), np.asarray(w64), atol=1e-6)


def test_blocked_solve_on_reference_canvases():
    """The JAX blocked canvases carried across drive the same solve."""
    M, N = 40, 300
    _, (cv, cs, cw, g, rhs, sc2, _) = _blocked_reference(M, N, 16, 128)
    s = fused_cg._fused_solve(Problem(M=M, N=N), cv, cs, cw, g, rhs, sc2)
    own = fused_cg.fused_cg_solve(Problem(M=M, N=N), device="cpu", bm=16,
                                  bn=128)
    assert int(s.k) == int(own.iterations) and bool(s.done)


def test_blocked_grid_round_trip_matches_jax():
    p, jp = Problem(M=24, N=300), JaxProblem(M=24, N=300)
    cv = fused_cg.canvas_spec(p, bn=128)
    jcv = pallas_cg.canvas_spec(jp, bn=128)
    full = np.random.default_rng(5).standard_normal(p.grid_shape)
    full[0], full[-1], full[:, 0], full[:, -1] = 0, 0, 0, 0
    c = fused_cg._full_to_canvas(p, cv, full, device="cpu")
    np.testing.assert_array_equal(
        c.numpy(), np.asarray(pallas_cg._full_to_canvas(jp, jcv, full)))
    np.testing.assert_array_equal(fused_cg._canvas_to_full(p, cv, c), full)


def test_refined_solve_on_the_blocked_canvas():
    """The CPU refinement path with bn: the inner solves run on the
    column-blocked canvas, the first one as the blocked solve, and the
    residual falls to the fp64 floor, as with full-width inner solves."""
    p = Problem(M=40, N=300)
    got = refined_solve(p, tol=1e-10, device="cpu", bn=128)
    flat = refined_solve(p, tol=1e-10, device="cpu", bn=0)
    one = fused_cg.fused_cg_solve(p, device="cpu", bn=128)
    assert got.converged and got.relative_residual <= 1e-10
    assert got.inner_iterations[0] == int(one.iterations)
    np.testing.assert_allclose(got.w, flat.w, atol=1e-9)
    with pytest.raises(ValueError, match="resident"):
        refined_solve(p, device="cpu", backend="resident", bn=128)
