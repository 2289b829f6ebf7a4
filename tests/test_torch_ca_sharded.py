"""Port parity: the sharded communication-avoiding solve
(``poisson_tpu_torch.parallel.ca_sharded``) against
``poisson_tpu.parallel.pallas_ca_sharded``, on the CPU.

As tests/test_torch_sharded.py: the JAX side runs with bm=8, so the shard
canvases (a halo ring of 2 here) compare element by element; the JAX kernels
run in interpret mode and its exchanges under ``shard_map`` on the 8-device
CPU mesh; the port's shards sit on the CPU and run the plain versions.

Tolerances: canvases and the width-2 exchange bitwise; kernel fields atol
1e-6 on the centre rows; the summed Gram vector atol 1e-5 of its largest
entry (some entries are sums of terms of both signs, so their own relative
error says nothing), Σ r'² rtol 1e-5. Solves give JAX's sharded count and
the port's single-device CA count, iterates within 1e-6 of the JAX fp64
solve.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_ca
from poisson_tpu.parallel import mesh as jax_mesh
from poisson_tpu.parallel import pallas_ca_sharded
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu.utils.compat import shard_map
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import shard_canvases_from_reference
from poisson_tpu_torch.ops import ca_cg, launch
from poisson_tpu_torch.ops.fused_cg import HALO
from poisson_tpu_torch.parallel import ca_sharded, fused_sharded, mesh

ROOT = Path(__file__).resolve().parents[1]
CANVAS_CASES = [(40, 40, (2, 2)), (37, 29, (2, 4)), (24, 24, (1, 4))]
SOLVE_CASES = [(40, 40, (1, 1)), (40, 40, (1, 2)), (40, 40, (2, 2)),
               (40, 40, (2, 4)), (37, 29, (2, 4)), (24, 24, (1, 4)),
               (24, 24, (4, 1))]
GOLDEN = {(40, 40): 50, (37, 29): 39, (24, 24): 31}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cpu_mesh(grid):
    return mesh.make_solver_mesh(["cpu"] * (grid[0] * grid[1]), grid=grid)


def _jax_mesh(grid):
    return jax_mesh.make_solver_mesh(jax.devices()[: grid[0] * grid[1]],
                                     grid=grid)


@functools.lru_cache(maxsize=None)
def _fp64_oracle(M, N):
    return np.asarray(jax_pcg_solve(JaxProblem(M=M, N=N),
                                    dtype=jnp.float64).w)


def _reference(M, N, grid):
    """The JAX CA shard spec and stacked canvases (bm=8), and the port's."""
    px, py = grid
    jspec = pallas_ca_sharded.ca_shard_spec(JaxProblem(M=M, N=N), px, py,
                                            bm=8)
    ref = pallas_ca_sharded._ca_shard_canvases(JaxProblem(M=M, N=N), px, py,
                                               jspec, "float32")
    spec, port = fused_sharded.shard_canvases(Problem(M=M, N=N),
                                              _cpu_mesh(grid), ca_sharded.RING)
    return jspec, ref, spec, port


@pytest.mark.parametrize("M,N,grid", CANVAS_CASES)
def test_ca_shard_canvases_match_jax(M, N, grid):
    jspec, ref, spec, port = _reference(M, N, grid)
    assert spec == ca_sharded.ca_shard_spec(Problem(M=M, N=N), *grid)
    assert (spec.cv.rows, spec.cv.cols, spec.m_blk, spec.n_blk) == (
        jspec.cv.rows, jspec.cv.cols, jspec.m_blk, jspec.n_blk)
    host = fused_sharded.host_shard_canvases(Problem(M=M, N=N), spec, *grid)
    for name, want in zip(fused_sharded.ShardCanvases._fields, ref):
        want = np.asarray(want)
        np.testing.assert_array_equal(host[name].astype(np.float32), want,
                                      err_msg=name)
        if name != "colmask":
            np.testing.assert_array_equal(
                np.stack([t.numpy() for t in getattr(port, name)]), want,
                err_msg=name)


@pytest.mark.parametrize("M,N,grid", CANVAS_CASES)
def test_exchange_ring2_matches_jax(M, N, grid):
    jspec, _, spec, _ = _reference(M, N, grid)
    px, py = grid
    rng = np.random.default_rng(M * N + 1)
    stacked = rng.standard_normal((px * py, spec.cv.rows, spec.cv.cols)
                                  ).astype(np.float32)
    axes = P((jax_mesh.X_AXIS, jax_mesh.Y_AXIS))
    run = shard_map(
        lambda u: pallas_ca_sharded._exchange_ring2(u[0], jspec, px, py)[None],
        mesh=_jax_mesh(grid), in_specs=axes, out_specs=axes, check_vma=False)
    want = np.asarray(jax.jit(run)(jnp.asarray(stacked)))
    u = [torch.tensor(x) for x in stacked]
    ca_sharded.exchange_ring2(u, spec, _cpu_mesh(grid))
    np.testing.assert_array_equal(np.stack([t.numpy() for t in u]), want)


@pytest.mark.parametrize("M,N,grid", CANVAS_CASES)
def test_sharded_kernels_c_d_match_pallas(M, N, grid):
    """The masked forms of kernels C (band widened by 2 rows) and D, on a
    shard's real coefficient canvases and inputs that are nonzero on every
    row and column, the halo ring included."""
    jspec, ref, spec, port = _reference(M, N, grid)
    jcs, jcw, jg, _, jsc2, _, jmask = ref
    s = 0
    cv = spec.cv
    band = (HALO - 2, HALO + spec.m_blk + 2)
    rng = np.random.default_rng(M + 2 * N)
    pprev, r, x, r2 = (rng.standard_normal((cv.rows, cv.cols))
                       .astype(np.float32) for _ in range(4))
    beta = np.float32(0.37)
    want = pallas_ca.basis_sweep(
        jspec.cv, jnp.full((1, 1), beta), jnp.asarray(pprev), jnp.asarray(r),
        jcs[s], jcw[s], jg[s], jsc2[s], interpret=True, band=band,
        colmask=jmask)
    mask = port.colmask[s]
    got = ca_cg.basis_sweep(cv, torch.tensor(beta), torch.tensor(pprev),
                            torch.tensor(r), port.cs[s], port.cw[s],
                            port.g[s], port.sc2[s], band=band, colmask=mask)
    centre = slice(HALO, cv.rows - HALO)
    for field, ref_field in zip(got[:4], want[:4]):
        np.testing.assert_allclose(field[centre].numpy(),
                                   np.asarray(ref_field)[centre], atol=1e-6)
    want_sum = np.asarray(want[4], np.float64).sum(axis=0)
    np.testing.assert_allclose(got[4].double().sum(dim=0).numpy(), want_sum,
                               rtol=0, atol=1e-5 * np.abs(want_sum).max())
    if grid[0] > 1:   # shard 0 has a row neighbour below
        narrow = ca_cg.basis_sweep(cv, torch.tensor(beta),
                                   torch.tensor(pprev), torch.tensor(r),
                                   port.cs[s], port.cw[s], port.g[s],
                                   port.sc2[s], colmask=mask)
        assert not torch.equal(narrow[2], got[2])   # the ring reaches t2

    coefs = np.array([0.31, 0.22, 0.07, 0.25, 0.15, 0, 0, 0], np.float32)
    want = pallas_ca.pair_update(
        jspec.cv, jnp.asarray(coefs).reshape(1, 8), *want[:4],
        jnp.asarray(x), jnp.asarray(r2), interpret=True, colmask=jmask)
    x_t, r_t = torch.tensor(x), torch.tensor(r2)
    upd = ca_cg.pair_update(cv, torch.tensor(coefs), *got[:4], x_t, r_t,
                            colmask=mask)
    assert upd[0] is x_t and upd[1] is r_t
    for field, ref_field in zip(upd[:3], want[:3]):
        np.testing.assert_allclose(field[centre].numpy(),
                                   np.asarray(ref_field)[centre], atol=1e-6)
    np.testing.assert_allclose(float(upd[3].double().sum()),
                               float(np.asarray(want[3]).sum()), rtol=1e-5)


@pytest.mark.parametrize("M,N,grid", SOLVE_CASES)
def test_ca_sharded_solve_matches_jax(M, N, grid):
    got = ca_sharded.ca_cg_solve_sharded(Problem(M=M, N=N), _cpu_mesh(grid))
    want = pallas_ca_sharded.ca_cg_solve_sharded(JaxProblem(M=M, N=N),
                                                 _jax_mesh(grid), bm=8)
    single = ca_cg.ca_cg_solve(Problem(M=M, N=N), device="cpu")
    assert int(got.iterations) == int(want.iterations) == \
        int(single.iterations) == GOLDEN[(M, N)]
    assert float(got.diff) < 1e-6
    np.testing.assert_allclose(got.w.numpy(), _fp64_oracle(M, N), atol=1e-6)


@pytest.mark.parametrize("cap", [5, 6])
def test_ca_sharded_cap_truncates_exactly(cap):
    p = Problem(M=40, N=40, max_iter=cap)
    got = ca_sharded.ca_cg_solve_sharded(p, _cpu_mesh((2, 2)))
    want = pallas_ca_sharded.ca_cg_solve_sharded(
        JaxProblem(M=40, N=40, max_iter=cap), _jax_mesh((2, 2)), bm=8)
    single = ca_cg.ca_cg_solve(p, device="cpu")
    assert int(got.iterations) == int(want.iterations) == cap
    np.testing.assert_allclose(got.w.numpy(), single.w.numpy(), atol=2e-6)


def test_ca_solve_on_reference_canvases():
    """Driven on the JAX shard canvases carried across, the same count."""
    _, ref, spec, _ = _reference(37, 29, (2, 4))
    m = _cpu_mesh((2, 4))
    canvases = shard_canvases_from_reference(*ref, devices=m.devices)
    s = ca_sharded._ca_sharded_solve(Problem(M=37, N=29), spec, m, canvases,
                                     canvases.rhs)
    assert int(s.k) == 39 and bool(s.done)


def test_rhs_gate_is_bit_exact():
    p, m = Problem(M=40, N=40), _cpu_mesh((2, 2))
    a = ca_sharded.ca_cg_solve_sharded(p, m)
    b = ca_sharded.ca_cg_solve_sharded(p, m, rhs_gate=1.0)
    assert int(a.iterations) == int(b.iterations) == 50
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_done_state_is_frozen():
    p, m = Problem(M=24, N=24), _cpu_mesh((2, 2))
    a = ca_sharded.ca_cg_solve_sharded(p, m, check_every=1)
    b = ca_sharded.ca_cg_solve_sharded(p, m, check_every=500)
    assert int(a.iterations) == int(b.iterations) == 31
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_cpu_ca_sharded_solve_launches_no_kernel():
    launch.reset_launch_counts()
    ca_sharded.ca_cg_solve_sharded(Problem(M=24, N=24), _cpu_mesh((2, 1)))
    assert not any(launch.launch_counts("basis_sweep",
                                        "pair_update").values())


def test_ring_needs_two_owned_columns():
    with pytest.raises(ValueError, match="halo ring"):
        ca_sharded.ca_shard_spec(Problem(M=24, N=8), 1, 7)


def test_cli_ca_sharded_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "poisson_tpu_torch", "40", "40", "--backend",
         "ca-sharded", "--mesh", "2x2", "--device", "cpu", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["iterations"] == 50 and rec["mesh"] == [2, 2]
    assert rec["backend"] == "ca-sharded" and rec["stopped"] is None
