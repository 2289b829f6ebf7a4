"""Port parity: the communication-avoiding path (``poisson_tpu_torch.ops.ca_cg``)
against ``poisson_tpu.ops.pallas_ca``, on the CPU.

Both packages get the same canvases (the JAX ``build_canvases`` arrays at the
port's single-strip height, carried across by ``poisson_tpu_torch.interop``)
and the same seeded inputs. The JAX kernels run in interpret mode, as
tests/test_pallas_ca.py runs them; the port's wrappers run their plain
versions, because the tensors lie on the CPU.

Tolerances: kernel fields atol 1e-6 on the live band (fp32, the same
operations in the same order; the JAX outputs' guard rows are unwritten);
partial sums rtol 1e-5 of the largest Gram entry (fp32, summed in another
order; some entries are sums of terms of both signs, so their own relative
error says nothing); the pair scalars rtol 1e-6 (the same fp32 operations
on the same Gram vector), their flags exactly. Solves give the same count
as ``ca_cg_solve``, with iterates within 1e-6 of the JAX fp64 solve (the
JAX fp32 iterates are the less accurate side, ROADMAP Queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_ca, pallas_cg
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import canvases_from_reference
from poisson_tpu_torch.ops import ca_cg, fused_cg, launch
from poisson_tpu_torch.ops.fused_cg import HALO

KERNEL_GRIDS = [(24, 40), (80, 120)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
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
def test_basis_sweep_matches_jax_kernel(M, N):
    (jcv, jcs, jcw, jg, _, jsc2, _), (cv, cs, cw, g, _, sc2, _) = \
        _reference(M, N)
    rng = np.random.default_rng(M)
    pprev = _interior_random(cv, M, N, rng)
    r = _interior_random(cv, M, N, rng)
    beta = np.float32(0.37)
    want = pallas_ca.basis_sweep(
        jcv, jnp.full((1, 1), beta), jnp.asarray(pprev), jnp.asarray(r),
        jcs, jcw, jg, jsc2, interpret=True)
    got = ca_cg.basis_sweep(cv, torch.tensor(beta), torch.tensor(pprev),
                            torch.tensor(r), cs, cw, g, sc2)
    band = slice(HALO, cv.rows - HALO)
    for field, ref in zip(got[:4], want[:4]):
        np.testing.assert_allclose(field[band].numpy(),
                                   np.asarray(ref)[band], atol=1e-6)
        assert (field[:HALO] == 0).all() and (field[cv.rows - HALO :] == 0
                                              ).all()
    gram = got[4]
    assert gram.shape == (ca_cg.n_tiles(cv), ca_cg.N_GRAM)
    want_sum = np.asarray(want[4], np.float64).sum(axis=0)
    np.testing.assert_allclose(gram.double().sum(dim=0).numpy(), want_sum,
                               rtol=0, atol=1e-5 * np.abs(want_sum).max())


@pytest.mark.parametrize("M,N", KERNEL_GRIDS)
def test_pair_update_matches_jax_kernel(M, N):
    (jcv, *_), (cv, *_) = _reference(M, N)
    rng = np.random.default_rng(N)
    pn, t1, t2, t3, x, r = (_interior_random(cv, M, N, rng)
                            for _ in range(6))
    coefs = np.array([0.31, 0.22, 0.07, 0.25, 0.15, 0, 0, 0], np.float32)
    want = pallas_ca.pair_update(
        jcv, jnp.asarray(coefs).reshape(1, 8), *(jnp.asarray(a) for a in
                                                 (pn, t1, t2, t3, x, r)),
        interpret=True)
    x_t, r_t = torch.tensor(x), torch.tensor(r)
    got = ca_cg.pair_update(cv, torch.tensor(coefs), *(torch.tensor(a) for a
                                                       in (pn, t1, t2, t3)),
                            x_t, r_t)
    assert got[0] is x_t and got[1] is r_t          # updated in place
    band = slice(HALO, cv.rows - HALO)
    for field, ref in zip(got[:3], want[:3]):
        np.testing.assert_allclose(field[band].numpy(),
                                   np.asarray(ref)[band], atol=1e-6)
    assert (got[2][:HALO] == 0).all()
    np.testing.assert_allclose(float(got[3].sum()), float(want[3].sum()),
                               rtol=1e-5)


@pytest.mark.parametrize("M,N", KERNEL_GRIDS)
def test_pair_update_only1_writes_pn(M, N):
    """With only1 set (coefs[5]), p₁ is pn bit for bit, as the JAX driver's
    select makes it, and x, r and the partials are those of the same row
    without it."""
    _, (cv, *_) = _reference(M, N)
    rng = np.random.default_rng(M + N)
    pn, t1, t2, t3, x, r = (torch.tensor(_interior_random(cv, M, N, rng))
                            for _ in range(6))
    row = [0.31, 0.0, 0.0, 0.25, 0.15, 0.0, 0.0, 0.0]
    flagged = torch.tensor(row[:5] + [1.0, 0.0, 0.0])
    plain = ca_cg.pair_update(cv, torch.tensor(row), pn, t1, t2, t3,
                              x.clone(), r.clone())
    got = ca_cg.pair_update(cv, flagged, pn, t1, t2, t3, x.clone(),
                            r.clone())
    assert torch.equal(got[2], pn)
    for a, b in zip(got[:2] + got[3:], plain[:2] + plain[3:]):
        assert torch.equal(a, b)


def _gram_cases():
    """(name, gram, rr, k) on the 40×40 problem: a real first pair, and the
    corners — a degenerate first step (a1 = 0), a degenerate second step
    (⟨p₁,Ãp₁⟩ = rAr₁ + 2β₁pAr₁ + β₁²a1 = −2 + 0 + 2 = 0), and a pair that
    starts one iteration below the cap."""
    p = Problem(M=40, N=40)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, device="cpu")
    zeros = torch.zeros_like(rhs)
    *_, gram = ca_cg.basis_sweep(cv, torch.zeros(()), zeros, rhs, cs, cw, g,
                                 sc2)
    real = (gram.sum(dim=0) * (p.h1 * p.h2)).numpy()
    rr = float(torch.sum(rhs ** 2) * (p.h1 * p.h2))
    deg1 = real.copy()
    deg1[0] = 0.0
    deg2 = np.zeros(12, np.float32)
    deg2[0], deg2[3], deg2[6] = 2.0, -2.0, 1.0
    return [("real", real, rr, 0), ("deg1", deg1, rr, 0),
            ("deg2", deg2, 1.0, 0), ("cap_stop", real, rr,
                                     p.iteration_cap - 1)]


@pytest.mark.parametrize("case", _gram_cases(), ids=lambda c: c[0])
def test_pair_scalars_match_jax(case):
    name, gram, rr, k = case
    d = ca_cg.pair_scalars(Problem(M=40, N=40), torch.tensor(rr,
                                                             dtype=torch.float32),
                           torch.tensor(k, dtype=torch.int32),
                           torch.tensor(gram, dtype=torch.float32))
    want = pallas_ca.pair_scalars(JaxProblem(M=40, N=40), jnp.float32(rr),
                                  jnp.int32(k), jnp.asarray(gram,
                                                            jnp.float32),
                                  jnp.float32)
    # The port's row is JAX's with only1 in spare slot 5 (kernel D then
    # writes p₁ = pn, which the JAX driver selects over the canvas).
    want_coefs = np.asarray(want.coefs).reshape(8)
    assert (want_coefs[5:] == 0).all()
    np.testing.assert_allclose(d.coefs[:5].numpy(), want_coefs[:5],
                               rtol=1e-6)
    assert d.coefs[5:].tolist() == [float(bool(want.only1)), 0.0, 0.0]
    for field in ("only1", "stop1", "deg2", "short"):
        assert bool(getattr(d, field)) == bool(getattr(want, field)), field
    for field in ("rr1", "diff1", "diff2"):
        np.testing.assert_allclose(float(getattr(d, field)),
                                   float(getattr(want, field)), rtol=1e-6)
    expect = {"real": (False, False), "deg1": (True, False),
              "deg2": (False, True), "cap_stop": (False, False)}[name]
    assert (bool(d.stop1), bool(d.deg2)) == expect
    assert bool(d.only1) == (name != "real")


@pytest.mark.parametrize("M,N,expected", [(40, 40, 50), (56, 56, 69),
                                          (80, 120, None)])
def test_ca_solve_matches_jax_ca_cg_solve(M, N, expected):
    """56×56 stops after an odd count (69): the last pair applies its first
    step only."""
    r = ca_cg.ca_cg_solve(Problem(M=M, N=N), device="cpu")
    ref = pallas_ca.ca_cg_solve(JaxProblem(M=M, N=N), interpret=True)
    assert int(r.iterations) == int(ref.iterations)
    if expected is not None:
        assert int(r.iterations) == expected
    assert float(r.diff) < 1e-6
    w64 = jax_pcg_solve(JaxProblem(M=M, N=N), dtype=jnp.float64).w
    np.testing.assert_allclose(r.w.numpy(), np.asarray(w64), atol=1e-6)


@pytest.mark.parametrize("cap", [5, 6])
def test_ca_cap_truncates_exactly(cap):
    r = ca_cg.ca_cg_solve(Problem(M=40, N=40, max_iter=cap), device="cpu")
    ref = pallas_ca.ca_cg_solve(JaxProblem(M=40, N=40, max_iter=cap),
                                interpret=True)
    fused = fused_cg.fused_cg_solve(Problem(M=40, N=40, max_iter=cap),
                                    device="cpu")
    assert int(r.iterations) == int(ref.iterations) == cap
    np.testing.assert_allclose(r.w.numpy(), np.asarray(ref.w), atol=2e-6)
    np.testing.assert_allclose(r.w.numpy(), fused.w.numpy(), atol=2e-6)


@pytest.mark.parametrize("M,N,expected", [(400, 600, 546), (800, 1200, 989)])
def test_ca_golden_counts_on_cpu(M, N, expected):
    r = ca_cg.ca_cg_solve(Problem(M=M, N=N), device="cpu")
    assert int(r.iterations) == expected
    assert float(r.diff) < 1e-6


def test_ca_solve_on_reference_canvases():
    """Driven on the JAX canvases carried across, the same count."""
    _, (cv, cs, cw, g, rhs, sc2, _) = _reference(40, 40)
    s = ca_cg._ca_solve(Problem(M=40, N=40), cv, cs, cw, g, rhs, sc2)
    assert int(s.k) == 50 and bool(s.done)


def test_zero_rhs_stops_cleanly():
    p = Problem(M=16, N=16, max_iter=5)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(p, device="cpu")
    s = ca_cg._ca_solve(p, cv, cs, cw, g, torch.zeros_like(rhs), sc2)
    assert bool(s.done) and int(s.k) <= 2
    assert torch.isfinite(s.x).all() and (s.x == 0).all()


def test_rhs_gate_is_bit_exact():
    p = Problem(M=40, N=40)
    a = ca_cg.ca_cg_solve(p, device="cpu")
    b = ca_cg.ca_cg_solve(p, device="cpu", rhs_gate=1.0)
    assert int(a.iterations) == int(b.iterations) == 50
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_done_state_is_frozen():
    """Pairs run after the stop change neither count nor iterate."""
    p = Problem(M=40, N=40)
    a = ca_cg.ca_cg_solve(p, device="cpu", check_every=1)
    b = ca_cg.ca_cg_solve(p, device="cpu", check_every=500)
    assert int(a.iterations) == int(b.iterations) == 50
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_cpu_solve_launches_no_kernel():
    launch.reset_launch_counts()
    ca_cg.ca_cg_solve(Problem(M=24, N=24), device="cpu")
    assert launch.launch_counts("basis_sweep", "pair_update") == {
        "basis_sweep": 0, "pair_update": 0, "basis_sweep_sharded": 0,
        "pair_update_sharded": 0}


def test_wrappers_reject_what_the_kernels_do_not_take():
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(
        Problem(M=24, N=40), device="cpu")
    beta = torch.zeros(())
    r = rhs.clone()
    outs = tuple(torch.zeros_like(r) for _ in range(4))
    with pytest.raises(ValueError, match="alias"):
        ca_cg.basis_sweep(cv, beta, r, r, cs, cw, g, sc2,
                          out=(r, *outs[1:]))
    with pytest.raises(ValueError, match="scalar"):
        ca_cg.pair_update(cv, torch.zeros(5), *outs, r.clone(), r.clone())
    with pytest.raises(ValueError, match="alias"):
        ca_cg.pair_update(cv, torch.zeros(8), *outs, outs[0], r.clone())
    with pytest.raises(ValueError, match="float32"):
        ca_cg.basis_sweep(cv, beta, r.double(), r, cs, cw, g, sc2)
