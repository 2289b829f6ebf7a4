"""Port parity: the checkpointed sharded solves
(``poisson_tpu_torch.parallel.checkpoint_sharded`` and the fused and CA
``*_sharded_checkpointed`` drivers) against the JAX package's, on the CPU.

The first six cases are ``tests/test_checkpoint_sharded.py``'s, on the
port's plain sharded driver: a chunked solve equals its one-shot solve, a
capped run resumes on the mesh, the fp32 path, and the file carries across
mesh shapes and between a mesh and one device. Two more carry a cap-hit
file from one package to the other. The fused and CA sharded drivers run
their kernels' plain versions (every shard on the CPU); the JAX drivers
run theirs in interpret mode, as tests/test_pallas.py runs them.

Tolerances: a chunked solve equals its one-shot solve bit for bit (the loop
bodies freeze a done state and a chunk stops at min(k + chunk, cap)); a
resumed fp64 solve gives the one-shot count, iterate within 1e-12 on the
same mesh and 1e-9 across meshes and packages (another reduction order,
the JAX test's tolerances); the fused and CA drivers give the JAX
drivers' counts exactly.
"""

import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.parallel import mesh as jax_mesh
from poisson_tpu.parallel import pallas_ca_sharded, pallas_sharded
from poisson_tpu.parallel import checkpoint_sharded as jax_ck_sharded
from poisson_tpu.parallel import pcg_sharded as jax_pcg_sharded
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops import fused_cg
from poisson_tpu_torch.parallel import (
    ca_sharded,
    checkpoint_sharded,
    fused_sharded,
    mesh,
    pcg_sharded,
)
from poisson_tpu_torch.solvers import checkpoint
from poisson_tpu_torch.solvers.pcg import pcg_solve

P40 = Problem(M=40, N=40)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cpu_mesh(grid=(2, 4)):
    return mesh.make_solver_mesh(["cpu"] * (grid[0] * grid[1]), grid=grid)


def _jax_mesh(grid=(2, 4)):
    return jax_mesh.make_solver_mesh(jax.devices()[: grid[0] * grid[1]],
                                     grid=grid)


def _capped(problem, cap):
    return dataclasses.replace(problem, max_iter=cap)


# --- the plain sharded driver: tests/test_checkpoint_sharded.py's cases ----


def test_chunked_equals_oneshot_sharded(tmp_path):
    m = _cpu_mesh()
    ref = pcg_sharded.pcg_solve_sharded(P40, m)
    got = checkpoint_sharded.pcg_solve_sharded_checkpointed(
        P40, m, str(tmp_path / "ck.npz"), chunk=7)
    assert int(got.iterations) == int(ref.iterations) == 50
    assert int(got.flag) == int(ref.flag) == 1
    assert torch.equal(got.w, ref.w)
    assert not (tmp_path / "ck.npz").exists()   # converged: cleaned up


def test_kill_and_resume_on_mesh(tmp_path):
    m = _cpu_mesh()
    path = str(tmp_path / "ck.npz")
    part = checkpoint_sharded.pcg_solve_sharded_checkpointed(
        _capped(P40, 20), m, path, chunk=10)
    assert int(part.iterations) == 20 and os.path.exists(path)
    ref = pcg_sharded.pcg_solve_sharded(P40, m)
    got = checkpoint_sharded.pcg_solve_sharded_checkpointed(P40, m, path,
                                                            chunk=10)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.w.numpy(), ref.w.numpy(), rtol=0,
                               atol=1e-12)
    assert not os.path.exists(path)


def test_chunked_fp32_scaled_path(tmp_path):
    m = _cpu_mesh()
    ref = pcg_sharded.pcg_solve_sharded(P40, m, dtype=torch.float32)
    got = checkpoint_sharded.pcg_solve_sharded_checkpointed(
        P40, m, str(tmp_path / "ck.npz"), chunk=13, dtype=torch.float32)
    assert int(got.iterations) == int(ref.iterations)
    assert torch.equal(got.w, ref.w)


def test_checkpoint_portable_across_mesh_shapes(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint_sharded.pcg_solve_sharded_checkpointed(
        _capped(P40, 20), _cpu_mesh((2, 4)), path, chunk=10)
    m = _cpu_mesh((4, 2))
    ref = pcg_sharded.pcg_solve_sharded(P40, m)
    got = checkpoint_sharded.pcg_solve_sharded_checkpointed(P40, m, path,
                                                            chunk=10)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.w.numpy(), ref.w.numpy(), rtol=0,
                               atol=1e-9)


def test_checkpoint_portable_mesh_to_single_device(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint_sharded.pcg_solve_sharded_checkpointed(
        _capped(P40, 15), _cpu_mesh(), path, chunk=5)
    ref = pcg_solve(P40, device="cpu")
    got = checkpoint.pcg_solve_checkpointed(P40, path, chunk=50,
                                            device="cpu")
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.w.numpy(), ref.w.numpy(), rtol=0,
                               atol=1e-9)


def test_checkpoint_portable_single_device_to_mesh(tmp_path):
    path = str(tmp_path / "ck.npz")
    checkpoint.pcg_solve_checkpointed(_capped(P40, 15), path, chunk=5,
                                      device="cpu")
    m = _cpu_mesh()
    ref = pcg_sharded.pcg_solve_sharded(P40, m)
    got = checkpoint_sharded.pcg_solve_sharded_checkpointed(P40, m, path,
                                                            chunk=50)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.w.numpy(), ref.w.numpy(), rtol=0,
                               atol=1e-9)


# --- across packages --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_oneshot():
    r = jax_pcg_sharded.pcg_solve_sharded(JaxProblem(M=40, N=40),
                                          _jax_mesh())
    return int(r.iterations), np.asarray(r.w)


def test_jax_sharded_file_resumes_in_the_port(tmp_path):
    path = str(tmp_path / "ck.npz")
    part = jax_ck_sharded.pcg_solve_sharded_checkpointed(
        JaxProblem(M=40, N=40, max_iter=20), _jax_mesh(), path, chunk=10)
    assert int(part.iterations) == 20 and os.path.exists(path)
    got = checkpoint_sharded.pcg_solve_sharded_checkpointed(
        P40, _cpu_mesh(), path, chunk=10)
    k, w = _jax_oneshot()
    assert int(got.iterations) == k
    np.testing.assert_allclose(got.w.numpy(), w, rtol=0, atol=1e-9)


def test_port_sharded_file_resumes_in_jax(tmp_path):
    path = str(tmp_path / "ck.npz")
    part = checkpoint_sharded.pcg_solve_sharded_checkpointed(
        _capped(P40, 20), _cpu_mesh(), path, chunk=10)
    assert int(part.iterations) == 20 and os.path.exists(path)
    got = jax_ck_sharded.pcg_solve_sharded_checkpointed(
        JaxProblem(M=40, N=40), _jax_mesh(), path, chunk=10)
    k, w = _jax_oneshot()
    assert int(got.iterations) == k
    np.testing.assert_allclose(np.asarray(got.w), w, rtol=0, atol=1e-9)


# --- the fused and CA sharded drivers ----------------------------------------

DRIVERS = {
    "fused": (fused_sharded.fused_cg_solve_sharded,
              fused_sharded.fused_cg_solve_sharded_checkpointed,
              pallas_sharded.pallas_cg_solve_sharded_checkpointed),
    "ca": (ca_sharded.ca_cg_solve_sharded,
           ca_sharded.ca_cg_solve_sharded_checkpointed,
           pallas_ca_sharded.ca_cg_solve_sharded_checkpointed),
}
KERNEL_CASES = [(d, s) for d in DRIVERS for s in (False, True)]
KERNEL_IDS = [f"{d}-{'serial' if s else 'tree'}" for d, s in KERNEL_CASES]


@pytest.mark.parametrize("driver,serial", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernel_driver_chunked_equals_oneshot(tmp_path, driver, serial):
    one, chunked, _ = DRIVERS[driver]
    m = _cpu_mesh((2, 2))
    ref = one(P40, m, serial=serial)
    got = chunked(P40, m, str(tmp_path / "ck.npz"), chunk=7, serial=serial)
    assert int(got.iterations) == int(ref.iterations) == 50
    assert torch.equal(got.w, ref.w)
    assert not (tmp_path / "ck.npz").exists()


@functools.lru_cache(maxsize=None)
def _jax_kernel_driver(driver, serial, cap, path):
    r = DRIVERS[driver][2](JaxProblem(M=40, N=40, max_iter=cap),
                           _jax_mesh((2, 2)), path, chunk=10, serial=serial,
                           interpret=True)
    return int(r.iterations)


@pytest.mark.parametrize("driver,serial", KERNEL_CASES, ids=KERNEL_IDS)
def test_kernel_driver_resumes_with_the_jax_count(tmp_path, driver, serial):
    """A capped run, then a resumed one: the port's counts equal the JAX
    driver's, capped and resumed the same way in interpret mode."""
    one, chunked, _ = DRIVERS[driver]
    m = _cpu_mesh((2, 2))
    path = str(tmp_path / "ck.npz")
    part = chunked(_capped(P40, 20), m, path, chunk=10, serial=serial)
    assert os.path.exists(path)
    got = chunked(P40, m, path, chunk=10, serial=serial)
    jpath = str(tmp_path / "jax.npz")
    assert int(part.iterations) == _jax_kernel_driver(driver, serial, 20,
                                                      jpath)
    assert int(got.iterations) == _jax_kernel_driver(driver, serial, None,
                                                     jpath)
    assert int(got.iterations) == int(one(P40, m, serial=serial).iterations)


def test_fused_resume_continues_bit_for_bit(tmp_path):
    """The fused driver resumes its own file from the stored direction
    itself (z := d, β := 0): the resumed solve is the one-shot solve."""
    m = _cpu_mesh((2, 2))
    path = str(tmp_path / "ck.npz")
    fused_sharded.fused_cg_solve_sharded_checkpointed(_capped(P40, 20), m,
                                                      path, chunk=10)
    got = fused_sharded.fused_cg_solve_sharded_checkpointed(P40, m, path,
                                                            chunk=10)
    assert torch.equal(got.w, fused_sharded.fused_cg_solve_sharded(P40, m).w)


@pytest.mark.parametrize("driver", list(DRIVERS))
def test_single_device_fused_file_resumes_on_the_mesh(tmp_path, driver):
    path = str(tmp_path / "ck.npz")
    part = fused_cg.fused_cg_solve_checkpointed(_capped(P40, 20), path,
                                                chunk=10, device="cpu")
    assert int(part.iterations) == 20
    got = DRIVERS[driver][1](P40, _cpu_mesh((2, 2)), path, chunk=10)
    assert int(got.iterations) == 50


def test_kernel_drivers_write_the_jax_file(tmp_path):
    """A capped sharded fused file holds the JAX package's keys, types and
    fingerprint, and the JAX single-device fused solve resumes it."""
    from poisson_tpu.ops import pallas_cg
    from poisson_tpu.solvers import checkpoint as jck

    path = str(tmp_path / "ck.npz")
    fused_sharded.fused_cg_solve_sharded_checkpointed(
        _capped(P40, 20), _cpu_mesh((2, 2)), path, chunk=10)
    fp = jck._fingerprint(JaxProblem(M=40, N=40), "float32", True)
    state = jck.load_state(path, fp)
    assert state is not None and int(state.k) == 20
    with np.load(path) as raw:   # the fused writers' types, as JAX's
        assert {k: (raw[k].dtype.name, raw[k].shape) for k in
                ("k", "done", "zr", "diff", "best")} == {
            "k": ("int32", ()), "done": ("bool", ()), "zr": ("float32", ()),
            "diff": ("float32", ()), "best": ("float64", ())}
    got = pallas_cg.pallas_cg_solve_checkpointed(JaxProblem(M=40, N=40),
                                                 path, chunk=10,
                                                 interpret=True)
    assert int(got.iterations) == 50
