"""Port parity: the mesh, the halo exchange and the sharded fused solve
(``poisson_tpu_torch.parallel``) against ``poisson_tpu.parallel``, on the CPU.

The JAX side runs with strip height bm=8, so both packages round a shard's
owned rows up to 8 and the shard canvases compare element by element. The
JAX kernels run in interpret mode and its exchanges under ``shard_map`` on
the 8-device CPU mesh (tests/conftest.py); every shard of the port sits on
the CPU, where its wrappers run their plain versions.

Tolerances: shard canvases and halo exchanges bitwise (the same fp64 setup
rounded once to fp32; copies); kernel fields atol 1e-6 on the centre rows
(fp32, the same operations in the same order), pn's halo rows bitwise
against the JAX driver's fix-up r + β·p (two roundings), partial sums rtol
1e-5 (fp32, summed in another order). Solves give JAX's sharded count and
the port's single-device count, with iterates within 1e-6 of the JAX fp64
solve (the JAX fp32 iterates are the less accurate side, ROADMAP Queue 3).
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_cg
from poisson_tpu.parallel import halo as jax_halo
from poisson_tpu.parallel import mesh as jax_mesh
from poisson_tpu.parallel import pallas_sharded
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu.utils.compat import shard_map
from poisson_tpu_torch import cli
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.interop import shard_canvases_from_reference
from poisson_tpu_torch.ops import fused_cg, launch
from poisson_tpu_torch.ops.fused_cg import HALO
from poisson_tpu_torch.parallel import fused_sharded, halo, mesh

ROOT = Path(__file__).resolve().parents[1]
CANVAS_CASES = [(40, 40, (2, 2)), (37, 29, (2, 4)), (24, 24, (1, 4))]
SOLVE_CASES = [(40, 40, (1, 1)), (40, 40, (1, 2)), (40, 40, (2, 2)),
               (40, 40, (2, 4)), (37, 29, (2, 4)), (24, 24, (1, 4))]
GOLDEN = {(40, 40): 50, (37, 29): 39, (24, 24): 31}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at
    once, and torch's thread pools oversubscribe the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cpu_mesh(grid):
    return mesh.make_solver_mesh(["cpu"] * (grid[0] * grid[1]), grid=grid)


def _jax_mesh(grid):
    return jax_mesh.make_solver_mesh(jax.devices()[: grid[0] * grid[1]],
                                     grid=grid)


def _under_shard_map(fn, stacked, grid):
    """``fn`` on each shard's canvas of ``stacked`` under ``shard_map``."""
    spec = P((jax_mesh.X_AXIS, jax_mesh.Y_AXIS))
    run = shard_map(lambda u: fn(u[0])[None], mesh=_jax_mesh(grid),
                    in_specs=spec, out_specs=spec, check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(stacked)))


@functools.lru_cache(maxsize=None)
def _fp64_oracle(M, N):
    return np.asarray(jax_pcg_solve(JaxProblem(M=M, N=N),
                                    dtype=jnp.float64).w)


def _reference(M, N, grid):
    """The JAX shard spec and stacked canvases (bm=8), and the port's."""
    px, py = grid
    jspec = pallas_sharded.shard_spec(JaxProblem(M=M, N=N), px, py, bm=8)
    ref = pallas_sharded._shard_canvases(JaxProblem(M=M, N=N), px, py,
                                         jspec, "float32")
    spec, port = fused_sharded.shard_canvases(Problem(M=M, N=N),
                                              _cpu_mesh(grid), 1)
    return jspec, ref, spec, port


def test_choose_process_grid_matches_jax():
    for size in range(1, 17):
        assert mesh.choose_process_grid(size) == \
            jax_mesh.choose_process_grid(size)
        assert mesh.block_size(size * 7 + 3, size) == \
            jax_mesh.block_size(size * 7 + 3, size)


def test_make_solver_mesh(monkeypatch):
    m = mesh.make_solver_mesh(["cpu"] * 8, grid=(2, 4))
    assert (m.px, m.py, m.size) == (2, 4, 8)
    assert m.devices == (torch.device("cpu"),) * 8 and m.lead.type == "cpu"
    assert mesh.make_solver_mesh(["cpu"] * 6)[:2] == (2, 3)
    with pytest.raises(ValueError, match="#devices"):
        mesh.make_solver_mesh(["cpu"] * 4, grid=(2, 3))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh.make_solver_mesh()


@pytest.mark.parametrize("M,N,grid", CANVAS_CASES)
def test_shard_canvases_match_jax(M, N, grid):
    jspec, ref, spec, port = _reference(M, N, grid)
    assert (spec.cv.rows, spec.cv.cols, spec.m_blk, spec.n_blk) == (
        jspec.cv.rows, jspec.cv.cols, jspec.m_blk, jspec.n_blk)
    for name, want in zip(fused_sharded.ShardCanvases._fields, ref):
        want = np.asarray(want)
        got = getattr(port, name)
        if name == "colmask":
            for t in got:
                np.testing.assert_array_equal(t.numpy(), want)
            continue
        np.testing.assert_array_equal(np.stack([t.numpy() for t in got]),
                                      want, err_msg=name)


@pytest.mark.parametrize("M,N,grid", CANVAS_CASES)
def test_exchange_r_halo_matches_jax(M, N, grid):
    jspec, _, spec, _ = _reference(M, N, grid)
    px, py = grid
    rng = np.random.default_rng(M * N)
    stacked = rng.standard_normal((px * py, spec.cv.rows, spec.cv.cols)
                                  ).astype(np.float32)
    want = _under_shard_map(
        lambda u: pallas_sharded._exchange_r_halo(u, jspec, px, py),
        stacked, grid)
    r = [torch.tensor(x) for x in stacked]
    fused_sharded.exchange_r_halo(r, spec, _cpu_mesh(grid))
    np.testing.assert_array_equal(np.stack([t.numpy() for t in r]), want)


@pytest.mark.parametrize("grid", [(2, 2), (2, 4), (4, 1)])
def test_exchange_halos_matches_jax(grid):
    px, py = grid
    rng = np.random.default_rng(px * 10 + py)
    stacked = rng.standard_normal((px * py, 7, 9)).astype(np.float32)
    want = _under_shard_map(lambda u: jax_halo.exchange_halos(u, px, py),
                            stacked, grid)
    blocks = [torch.tensor(x) for x in stacked]
    halo.exchange_halos(blocks, _cpu_mesh(grid))
    np.testing.assert_array_equal(np.stack([t.numpy() for t in blocks]),
                                  want)


def test_mesh_sum_is_in_mesh_order():
    m = _cpu_mesh((2, 2))
    parts = [torch.tensor([1e8, 1.0]), torch.tensor([-1e8]),
             torch.tensor([0.5, 0.25]), torch.tensor([2.0])]
    got = halo.mesh_sum(parts, m)
    want = torch.sum(torch.stack([torch.sum(p) for p in parts]))
    assert torch.equal(got, want)
    grams = [torch.arange(24.0).reshape(2, 12) * (s + 1) for s in range(4)]
    torch.testing.assert_close(halo.mesh_sum(grams, m),
                               torch.arange(12.0) * 20 + 120, rtol=0, atol=0)


def _random_canvas(rng, cv):
    return rng.standard_normal((cv.rows, cv.cols)).astype(np.float32)


@pytest.mark.parametrize("M,N,grid", CANVAS_CASES)
def test_sharded_kernels_a_b_match_pallas(M, N, grid):
    """The masked, banded forms of kernels A and B, on a shard's real
    coefficient canvases and inputs that are nonzero on every row and
    column, halo rows and columns included."""
    jspec, ref, spec, port = _reference(M, N, grid)
    jcs, jcw, jg, _, jsc2, _, jmask = ref
    s = grid[0] * grid[1] - 1                  # the last shard
    cv = spec.cv
    band = (HALO - 1, HALO + spec.m_blk + 1)
    rng = np.random.default_rng(M + N)
    z, p, w, r = (_random_canvas(rng, cv) for _ in range(4))
    beta, alpha = np.float32(0.37), np.float32(0.21)
    want_pn, want_ap, want_part = pallas_cg.direction_and_stencil(
        jspec.cv, jnp.full((1, 1), beta), jnp.asarray(z), jnp.asarray(p),
        jcs[s], jcw[s], jg[s], interpret=True, band=band, colmask=jmask)
    mask = port.colmask[s]
    pn, ap, part = fused_cg.direction_and_stencil(
        cv, torch.tensor(beta), torch.tensor(z), torch.tensor(p), port.cs[s],
        port.cw[s], port.g[s], band=band, colmask=mask)
    centre = slice(HALO, cv.rows - HALO)
    np.testing.assert_allclose(pn[centre].numpy(),
                               np.asarray(want_pn)[centre], atol=1e-6)
    np.testing.assert_allclose(ap[centre].numpy(),
                               np.asarray(want_ap)[centre], atol=1e-6)
    # pn's halo rows: the JAX shard body's fix-up, bit for bit.
    for row in (band[0], band[1] - 1):
        np.testing.assert_array_equal(pn[row].numpy(),
                                      z[row] + beta * p[row])
    assert (pn[: band[0]] == 0).all() and (pn[band[1] :] == 0).all()
    np.testing.assert_allclose(float(part.double().sum()),
                               float(np.asarray(want_part).sum()), rtol=1e-5)
    unmasked = fused_cg.direction_and_stencil(
        cv, torch.tensor(beta), torch.tensor(z), torch.tensor(p), port.cs[s],
        port.cw[s], port.g[s], band=band, colmask=torch.ones_like(mask))[2]
    assert abs(float(unmasked.sum() - part.sum())) > 1e-3   # the mask bites

    w_t, r_t = torch.tensor(w), torch.tensor(r)
    want = pallas_cg.fused_update(
        jspec.cv, jnp.full((1, 1), alpha), want_pn, want_ap, jsc2[s],
        jnp.asarray(w), jnp.asarray(r), interpret=True, colmask=jmask)
    got = fused_cg.fused_update(cv, torch.tensor(alpha), pn, ap, port.sc2[s],
                                w_t, r_t, colmask=mask)
    assert got[0] is w_t and got[1] is r_t
    for field, ref_field in zip(got[:2], want[:2]):
        np.testing.assert_allclose(field[centre].numpy(),
                                   np.asarray(ref_field)[centre], atol=1e-6)
    for mine, theirs in zip(got[2:], want[2:]):
        np.testing.assert_allclose(float(mine.double().sum()),
                                   float(np.asarray(theirs).sum()),
                                   rtol=1e-5)


def test_kernel_wrappers_reject_bad_band_or_mask():
    _, _, spec, port = _reference(40, 40, (2, 2))
    cv = spec.cv
    z = torch.zeros(cv.rows, cv.cols)
    args = (cv, torch.zeros(()), z, z.clone(), port.cs[0], port.cw[0],
            port.g[0])
    with pytest.raises(ValueError, match="band"):
        fused_cg.direction_and_stencil(*args, band=(HALO - 2, cv.rows))
    with pytest.raises(ValueError, match="band"):
        fused_cg.direction_and_stencil(*args, band=(HALO + 1,
                                                    cv.rows - HALO))
    with pytest.raises(ValueError, match="colmask"):
        fused_cg.direction_and_stencil(*args, colmask=torch.ones(cv.cols))
    with pytest.raises(ValueError, match="sharded form"):
        fused_cg.direction_and_stencil(*args, band=(HALO - 1,
                                                    cv.rows - HALO + 1))
    with pytest.raises(ValueError, match="colmask"):
        fused_cg.fused_update(cv, torch.zeros(()), z, z, port.sc2[0],
                              z.clone(), z.clone(),
                              colmask=port.colmask[0].double())


@pytest.mark.parametrize("M,N,grid", SOLVE_CASES)
def test_sharded_solve_matches_jax(M, N, grid):
    got = fused_sharded.fused_cg_solve_sharded(Problem(M=M, N=N),
                                               _cpu_mesh(grid))
    want = pallas_sharded.pallas_cg_solve_sharded(JaxProblem(M=M, N=N),
                                                  _jax_mesh(grid), bm=8)
    single = fused_cg.fused_cg_solve(Problem(M=M, N=N), device="cpu")
    assert int(got.iterations) == int(want.iterations) == \
        int(single.iterations) == GOLDEN[(M, N)]
    assert float(got.diff) < 1e-6
    np.testing.assert_allclose(got.w.numpy(), _fp64_oracle(M, N), atol=1e-6)


def test_solve_on_reference_canvases():
    """Driven on the JAX shard canvases carried across, the same count."""
    jspec, ref, spec, _ = _reference(40, 40, (2, 2))
    m = _cpu_mesh((2, 2))
    canvases = shard_canvases_from_reference(*ref, devices=m.devices)
    s = fused_sharded._sharded_solve(Problem(M=40, N=40), spec, m, canvases,
                                     canvases.rhs)
    assert int(s.k) == 50 and bool(s.done)


def test_rhs_gate_is_bit_exact():
    p, m = Problem(M=40, N=40), _cpu_mesh((2, 2))
    a = fused_sharded.fused_cg_solve_sharded(p, m)
    b = fused_sharded.fused_cg_solve_sharded(p, m, rhs_gate=1.0)
    assert int(a.iterations) == int(b.iterations) == 50
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_done_state_is_frozen():
    """Iterations run after the stop change neither count nor iterate."""
    p, m = Problem(M=24, N=24), _cpu_mesh((2, 2))
    a = fused_sharded.fused_cg_solve_sharded(p, m, check_every=1)
    b = fused_sharded.fused_cg_solve_sharded(p, m, check_every=500)
    assert int(a.iterations) == int(b.iterations) == 31
    torch.testing.assert_close(a.w, b.w, rtol=0, atol=0)


def test_cpu_sharded_solve_launches_no_kernel():
    launch.reset_launch_counts()
    fused_sharded.fused_cg_solve_sharded(Problem(M=24, N=24),
                                         _cpu_mesh((1, 2)))
    assert not any(launch.launch_counts("direction_and_stencil",
                                        "fused_update").values())


def test_cli_mesh_choice():
    assert cli.pick_backend("auto", "float32", 1, None) == "fused"
    assert cli.pick_backend("auto", "float32", 2, None) == "fused-sharded"
    assert cli.pick_backend("auto", "float32", 1, (2, 2)) == "fused-sharded"
    assert cli.pick_backend("auto", "float64", 4, None) == "sharded"
    assert cli.pick_backend("auto", "float64", 1, None) == "torch"
    with pytest.raises(SystemExit, match="fp32 path"):
        cli.pick_backend("fused-sharded", "float64", 1, None)
    with pytest.raises(SystemExit, match="--mesh"):
        cli.pick_backend("fused", "float32", 1, (2, 2))
    args = SimpleNamespace(mesh=(2, 2), device="cuda")
    with pytest.raises(SystemExit, match="needs 4 cards; 1 visible"):
        cli.build_mesh(args, 1)
    m = cli.build_mesh(SimpleNamespace(mesh=None, device="cpu"), 1)
    assert (m.px, m.py) == (1, 1)


def test_cli_fused_sharded_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "poisson_tpu_torch", "40", "40", "--backend",
         "fused-sharded", "--mesh", "2x2", "--device", "cpu", "--json"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["iterations"] == 50 and rec["mesh"] == [2, 2]
    assert rec["backend"] == "fused-sharded" and rec["stopped"] is None
    assert rec["achieved_gbps"] is None    # no device rate from a CPU run
