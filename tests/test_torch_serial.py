"""Port parity: the serial-reduce mode (kernel S of
``poisson_tpu_torch.ops.serial`` and ``serial=True`` on every fused path)
against ``poisson_tpu``'s ``serial=True`` kernels, on the CPU.

The JAX kernels run in interpret mode, as tests/test_pallas.py runs them;
the port's wrappers run their plain versions, because the tensors lie on
the CPU.

Tolerances: ``serial_sum_plain`` equals a numpy fp32 replay of kernel S's
order bit for bit, and a float64 Kahan sum over the same runs to 1e-6
relative (fp32 rounding of a few thousand terms). A serial partial sum is
within 1e-5 relative of the JAX serial kernel's (1, 1) Kahan cell (fp32,
another order inside each strip). Serial counts equal the JAX package's
exactly; the serial iterate is within 5e-6 of the default one, the
tolerance of tests/test_pallas.py's serial test."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_ca, pallas_cg
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import canvases_from_reference
from poisson_tpu_torch.ops import ca_cg, fused_cg, launch, serial
from poisson_tpu_torch.ops.fused_cg import HALO
from poisson_tpu_torch.parallel import ca_sharded, fused_sharded, mesh


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _replay_fp32(x: np.ndarray, run: int) -> np.float32:
    """Kernel S's order in numpy fp32, one scalar at a time: lane l of a
    warp adds partials l, l + 32, … of a run; the shuffle tree (offsets
    16 … 1) combines the lanes; the run sums go through Kahan's loop."""
    f = np.float32
    total, comp = f(0), f(0)
    for start in range(0, len(x), run):
        seg = x[start : start + run]
        lanes = [f(0)] * 32
        for k, v in enumerate(seg):
            lanes[k % 32] = f(lanes[k % 32] + v)
        off = 16
        while off:
            lanes = [f(lanes[i] + lanes[i + off]) if i < off else lanes[i]
                     for i in range(32)]
            off //= 2
        y = f(lanes[0] - comp)
        t = f(total + y)
        comp = f(f(t - total) - y)
        total = t
    return total


def _kahan64(x: np.ndarray, run: int) -> float:
    """Float64 reference: each run summed exactly, the run sums added with
    Kahan compensation."""
    total, comp = 0.0, 0.0
    for start in range(0, len(x), run):
        y = math.fsum(map(float, x[start : start + run])) - comp
        t = total + y
        comp = (t - total) - y
        total = t
    return total


SUM_CASES = [(1, 1000, 40), (3, 4000, 640), (2, 1037, 100), (1, 31, 64),
             (12, 520, 65)]


@pytest.mark.parametrize("nvec,n,run", SUM_CASES)
def test_serial_sum_plain_replays_kernel_order(nvec, n, run):
    rng = np.random.default_rng(n + run)
    # Mixed signs and magnitudes, as ⟨Ap, pn⟩ partials have.
    x = (rng.standard_normal((nvec, n))
         * np.exp(rng.uniform(-6, 6, (nvec, n)))).astype(np.float32)
    got = serial.serial_sum(torch.tensor(x), run)
    assert got.shape == (nvec,)
    for v in range(nvec):
        assert got[v].numpy().tobytes() == _replay_fp32(x[v], run).tobytes()
        want = _kahan64(x[v], run)
        scale = np.abs(x[v]).astype(np.float64).sum()
        assert abs(float(got[v]) - want) <= 1e-6 * scale


def test_serial_sum_takes_every_partials_form():
    rng = np.random.default_rng(7)
    buf = torch.tensor(rng.standard_normal((2, 300)).astype(np.float32))
    both = serial.serial_sum(buf, 50)
    # Rows of one buffer (kernel B's two vectors), a lone vector, and a
    # transposed (tiles, 12) Gram block all give the same bits.
    rows = serial.serial_sum(tuple(buf.unbind()), 50)
    assert torch.equal(rows, both)
    assert torch.equal(serial.serial_sum(buf[1], 50), both[1])
    gram = torch.tensor(rng.standard_normal((300, 12)).astype(np.float32))
    assert torch.equal(serial.serial_sum(gram.T, 50),
                       serial.serial_sum(gram.T.contiguous(), 50))
    assert serial.serial_sum(buf[0], 50).dim() == 0
    with pytest.raises(ValueError, match="float32"):
        serial.serial_sum(buf.double(), 50)
    with pytest.raises(ValueError, match="run"):
        serial.serial_sum(buf, 0)


# Problems whose JAX canvases have several strips (or tiles), so the
# serial chain is longer than one link.
RUN_CASES = [(300, 40, None), (800, 1200, None), (2400, 3200, None),
             (64, 20000, None), (40, 300, 128)]


@pytest.mark.parametrize("M,N,bn", RUN_CASES)
def test_serial_runs_are_the_jax_grid_steps(M, N, bn):
    """One run of kernel S per grid step of the JAX serial kernel: strips
    of the fused canvas (tiles when blocked), strips of the CA canvas."""
    p, jp = Problem(M=M, N=N), JaxProblem(M=M, N=N)
    cv = fused_cg.canvas_spec(p, bn=bn)
    jcv = pallas_cg.canvas_spec(jp, bn=bn)
    runs = -(-fused_cg.n_partials(cv) // fused_cg.serial_run(cv, M - 1))
    assert runs == jcv.nb * jcv.ncb
    if not cv.cg:
        ccv = fused_cg.canvas_spec(p, bn=0)
        crun = fused_cg.serial_run(ccv, M - 1, ca_cg.CA_BUFFERS)
        jca = pallas_cg.canvas_spec(jp, pallas_ca.pick_bm_ca(jp), 0)
        assert -(-fused_cg.n_partials(ccv) // crun) == jca.nb


@pytest.mark.parametrize("M,N,bm,bn", [(300, 40, 128, None),
                                       (40, 300, 16, 128)])
def test_serial_partial_sum_matches_jax_serial_kernel(M, N, bm, bn):
    ref = pallas_cg.build_canvases(JaxProblem(M=M, N=N), bm, "float32", bn)
    jcv, jcs, jcw, jg = ref[:4]
    cv, cs, cw, g, *_ = canvases_from_reference(ref[0]._asdict(), *ref[1:],
                                                device="cpu")
    rng = np.random.default_rng(M * 3 + N)
    z, p = (np.zeros((cv.rows, cv.cols), np.float32) for _ in range(2))
    for x in (z, p):
        x[HALO : HALO + M - 1, cv.cg + 1 : cv.cg + N] = rng.standard_normal(
            (M - 1, N - 1))
    beta = np.float32(0.37)
    want = pallas_cg.direction_and_stencil(
        jcv, jnp.full((1, 1), beta), jnp.asarray(z), jnp.asarray(p), jcs, jcw,
        jg, interpret=True, serial=True)[2]
    assert np.asarray(want).shape == (1, 1)
    part = fused_cg.direction_and_stencil(
        cv, torch.tensor(beta), torch.tensor(z), torch.tensor(p), cs, cw,
        g)[2]
    got = serial.serial_sum(part, fused_cg.serial_run(cv, M - 1))
    np.testing.assert_allclose(float(got), float(np.asarray(want)[0, 0]),
                               rtol=1e-5)


SOLVE_CASES = {
    "fused": (lambda p: fused_cg.fused_cg_solve(p, device="cpu", serial=True),
              lambda p: fused_cg.fused_cg_solve(p, device="cpu"),
              lambda jp: pallas_cg.pallas_cg_solve(jp, serial=True,
                                                   interpret=True)),
    "blocked": (lambda p: fused_cg.fused_cg_solve(p, device="cpu", bm=16,
                                                  bn=128, serial=True),
                lambda p: fused_cg.fused_cg_solve(p, device="cpu", bm=16,
                                                  bn=128),
                lambda jp: pallas_cg.pallas_cg_solve(jp, bm=16, bn=128,
                                                     serial=True,
                                                     interpret=True)),
    "ca": (lambda p: ca_cg.ca_cg_solve(p, device="cpu", serial=True),
           lambda p: ca_cg.ca_cg_solve(p, device="cpu"),
           lambda jp: pallas_ca.ca_cg_solve(jp, serial=True, interpret=True)),
}


@pytest.mark.parametrize("path", sorted(SOLVE_CASES))
def test_serial_solve_counts_equal_jax(path):
    serial_solve, default_solve, jax_solve = SOLVE_CASES[path]
    p = Problem(M=40, N=40)
    got = serial_solve(p)
    want = jax_solve(JaxProblem(M=40, N=40))
    assert int(got.iterations) == int(want.iterations) == 50
    base = default_solve(p)
    np.testing.assert_allclose(got.w.numpy(), base.w.numpy(), rtol=0,
                               atol=5e-6)


@pytest.mark.parametrize("path", ["fused-sharded", "ca-sharded"])
def test_serial_sharded_counts_on_a_cpu_mesh(path):
    """Each shard's partials go through kernel S before the mesh-order
    sum; on a 2×2 CPU mesh the count is the JAX package's 50."""
    solve = {"fused-sharded": fused_sharded.fused_cg_solve_sharded,
             "ca-sharded": ca_sharded.ca_cg_solve_sharded}[path]
    m = mesh.make_solver_mesh(["cpu"] * 4, grid=(2, 2))
    p = Problem(M=40, N=40)
    got = solve(p, m, serial=True)
    base = solve(p, m)
    assert int(got.iterations) == int(base.iterations) == 50
    np.testing.assert_allclose(got.w.numpy(), base.w.numpy(), rtol=0,
                               atol=5e-6)


def test_serial_mode_counts_no_kernel_launch_on_the_cpu():
    launch.reset_launch_counts()
    fused_cg.fused_cg_solve(Problem(M=24, N=24), device="cpu", serial=True)
    assert launch.launch_counts("serial_sum") == {"serial_sum": 0}
