"""Port parity: the plain sharded solve (``poisson_tpu_torch.parallel
.pcg_sharded``) against ``poisson_tpu.parallel.pcg_sharded``, on the CPU.

The JAX solves run under ``shard_map`` on the 8-device CPU mesh
(tests/conftest.py), on the same mesh shapes as the port's, whose shards
all sit on the CPU. These are the reference's cases
(``tests/test_distributed.py:34-86``) held against the JAX sharded solve
itself.

Tolerances: the count and the stop flag equal JAX's sharded solve on the
same mesh, and lie within ±1 of the single-device solve (the reduction
order differs between mesh shapes, as the JAX test allows); the fp64
iterate within 1e-10 of JAX's sharded iterate; the fp32 iterate within
1e-5 of the fp64 solve (``tests/test_precision.py``'s fp32 tolerance).

Size limit of the fp32 ``setup="device"`` parity: the JAX module builds
its fp32 fields inside ``shard_map``, where XLA:CPU fuses the closed form,
and the fused fp32 arithmetic differs from the same closed form run op by
op (in 96,541 of a's 241,001 values at 400×600). The port evaluates it op
by op with IEEE rounding, equal bit for bit to JAX's eager closed form
(tested below at 400×600). At 40×40 both packages give 50 iterations; at
400×600 the port gives 548 and JAX 529, because the cut-face blend
``(1 - frac) / eps`` turns those last-bit differences into coefficients
that differ in their third digit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.parallel import mesh as jax_mesh
from poisson_tpu.parallel import pcg_sharded as jax_pcg_sharded
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.parallel import mesh, pcg_sharded
from poisson_tpu_torch.parallel.pcg_sharded import DeviceStacks

MESHES = [(1, 1), (1, 2), (2, 2), (2, 4), (1, 4)]
DTYPES = ["float64", "float32"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _cpu_mesh(grid):
    return mesh.make_solver_mesh(["cpu"] * (grid[0] * grid[1]), grid=grid)


@functools.lru_cache(maxsize=None)
def _jax_sharded(M, N, grid, dtype, setup, weighted=True):
    m = jax_mesh.make_solver_mesh(jax.devices()[: grid[0] * grid[1]],
                                  grid=grid)
    r = jax_pcg_sharded.pcg_solve_sharded(
        JaxProblem(M=M, N=N, weighted_norm=weighted), m,
        dtype=getattr(jnp, dtype), setup=setup)
    return int(r.iterations), int(r.flag), np.asarray(r.w, np.float64)


@functools.lru_cache(maxsize=None)
def _jax_single(M, N, weighted=True):
    r = jax_pcg_solve(JaxProblem(M=M, N=N, weighted_norm=weighted),
                      dtype=jnp.float64)
    return int(r.iterations), np.asarray(r.w)


def _check(M, N, grid, dtype, setup, weighted=True):
    got = pcg_sharded.pcg_solve_sharded(
        Problem(M=M, N=N, weighted_norm=weighted), _cpu_mesh(grid),
        dtype=getattr(torch, dtype), setup=setup)
    k, flag, w = _jax_sharded(M, N, grid, dtype, setup, weighted)
    k1, w64 = _jax_single(M, N, weighted)
    assert (int(got.iterations), int(got.flag)) == (k, flag)
    assert abs(int(got.iterations) - k1) <= 1
    if dtype == "float64":
        np.testing.assert_allclose(got.w.numpy(), w, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(got.w.double().numpy(), w64, rtol=0,
                                   atol=1e-5)
    return got


@pytest.mark.parametrize("setup", ["host", "device"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grid", MESHES, ids=[f"{a}x{b}" for a, b in MESHES])
def test_sharded_matches_jax(grid, dtype, setup):
    _check(40, 40, grid, dtype, setup)


@pytest.mark.parametrize("dtype", DTYPES)
def test_uneven_grid_on_2x4(dtype):
    """Grid dims not divisible by the mesh: padding and masking exact."""
    _check(37, 29, (2, 4), dtype, "host")


@pytest.mark.parametrize("M,N,weighted,golden", [
    (10, 10, False, 17), (20, 20, False, 31), (40, 40, True, 50)])
def test_fp64_goldens_on_2x2(M, N, weighted, golden):
    got = _check(M, N, (2, 2), "float64", "host", weighted)
    assert int(got.iterations) == golden and int(got.flag) == 1


def test_explicit_1d_mesh_at_24x24():
    """A 1×4 decomposition: the zero fill of the mesh edge on one axis
    (``tests/test_distributed.py``'s 1-D case)."""
    _check(24, 24, (1, 4), "float64", "host")


def _shard_index(geo, s):
    ix, iy = divmod(s, geo.py)
    li, lj = np.arange(geo.m_blk + 2), np.arange(geo.n_blk + 2)
    return li, lj, ix * geo.m_blk + li, iy * geo.n_blk + lj


def test_device_setup_builds_the_host_fields():
    """fp64: every shard's block built on its device equals the host fp64
    blocks bit for bit on every point of the grid (the padding past the
    grid is masked out of every operator), and aux on the owned interior
    (device setup leaves its ring zero, as the JAX module's does: the ring
    of sc·p is exchanged before it is read)."""
    p, grid = Problem(M=37, N=29), (2, 4)
    m = _cpu_mesh(grid)
    geo = pcg_sharded.geometry(p, m)
    for scaled in (False, True):
        host = pcg_sharded.sharded_fields(p, m, geo, "float64", scaled,
                                          "host")
        dev = pcg_sharded.sharded_fields(p, m, geo, "float64", scaled,
                                         "device")
        for name in ("a", "b", "rhs", "aux", "mask"):
            for s, (h, d) in enumerate(zip(
                    pcg_sharded.shard_blocks(geo, getattr(host, name)),
                    pcg_sharded.shard_blocks(geo, getattr(dev, name)))):
                li, lj, gi, gj = _shard_index(geo, s)
                rows, cols = gi <= p.M, gj <= p.N
                if name == "aux":
                    rows &= (li >= 1) & (li <= geo.m_blk) & (gi < p.M)
                    cols &= (lj >= 1) & (lj <= geo.n_blk) & (gj < p.N)
                inside = np.ix_(rows, cols)
                np.testing.assert_array_equal(
                    d.numpy()[inside], h.numpy()[inside],
                    err_msg=f"{name} shard {s} scaled={scaled}")


def test_device_setup_fp32_is_the_jax_closed_form():
    """fp32: a shard's coefficients and right-hand side are the JAX
    module's closed form evaluated in fp32 at the shard's global indices
    (``coefficient_fields``/``rhs_field`` with ``xp=jnp``, op by op), bit
    for bit: the fp32 cut-face blend differs from the fp64 host fields by
    up to 2e-4, in both packages."""
    from poisson_tpu.models import fictitious_domain as jfd

    p, grid = Problem(M=37, N=29), (2, 4)
    jp = JaxProblem(M=37, N=29)
    m = _cpu_mesh(grid)
    geo = pcg_sharded.geometry(p, m)
    dev = pcg_sharded.sharded_fields(p, m, geo, "float32", True, "device")
    blocks = {name: pcg_sharded.shard_blocks(geo, getattr(dev, name))
              for name in ("a", "b", "rhs", "mask")}
    for s in range(m.size):
        _, _, gi, gj = _shard_index(geo, s)
        ja, jb = jfd.coefficient_fields(jp, jnp.asarray(gi), jnp.asarray(gj),
                                        jnp.float32)
        jr = jfd.rhs_field(jp, jnp.asarray(gi), jnp.asarray(gj), jnp.float32)
        np.testing.assert_array_equal(blocks["a"][s].numpy(), np.asarray(ja))
        np.testing.assert_array_equal(blocks["b"][s].numpy(), np.asarray(jb))
        # rhs on the scaled system is b̃ = B·sc: its support is B's.
        assert np.array_equal(blocks["rhs"][s].numpy() != 0,
                              (np.asarray(jr) * blocks["mask"][s].numpy())
                              != 0)


def test_fp32_closed_form_is_ieee_at_400x600():
    """The fp32 closed form and D^{-1/2} at 400×600 equal the JAX package's
    op-by-op evaluation bit for bit. torch's CPU fp32 ``sqrt`` is not
    correctly rounded on every input; an ulp there became a cut-face
    coefficient 976 ulps away, so the port rounds an fp64 root once
    (``fictitious_domain.sqrt_rn``)."""
    from poisson_tpu.models import fictitious_domain as jfd
    from poisson_tpu.ops.stencil import diag_D as jax_diag_D
    from poisson_tpu_torch.models import fictitious_domain as tfd
    from poisson_tpu_torch.ops.stencil import diag_D

    p, jp = Problem(M=400, N=600), JaxProblem(M=400, N=600)
    gi, gj = np.arange(p.M + 1), np.arange(p.N + 1)
    ja, jb = jfd.coefficient_fields(jp, jnp.asarray(gi), jnp.asarray(gj),
                                    jnp.float32)
    jr = jfd.rhs_field(jp, jnp.asarray(gi), jnp.asarray(gj), jnp.float32)
    jsc = 1.0 / jnp.sqrt(jax_diag_D(ja, jb, jp.h1, jp.h2))
    ta, tb = tfd.coefficient_fields(p, torch.as_tensor(gi),
                                    torch.as_tensor(gj), torch.float32)
    tr = tfd.rhs_field(p, torch.as_tensor(gi), torch.as_tensor(gj),
                       torch.float32)
    tsc = 1.0 / tfd.sqrt_rn(diag_D(ta, tb, p.h1, p.h2))
    for name, j, t in (("a", ja, ta), ("b", jb, tb), ("rhs", jr, tr),
                       ("sc", jsc, tsc)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)


def test_device_stacks_stack_shards_per_device():
    """A field is one (shards, …) stack per device; its blocks come back in
    mesh order, and arithmetic and torch.where apply per stack with
    mesh-wide scalars."""
    p, grid = Problem(M=24, N=24), (2, 2)
    m = _cpu_mesh(grid)
    geo = pcg_sharded.geometry(p, m)
    assert geo.shards == ((0, 1, 2, 3),) and geo.slot[3] == (0, 3)
    blocks = [torch.full((3, 4), float(s)) for s in range(4)]
    f = pcg_sharded.from_blocks(geo, blocks)
    assert [float(b[0, 0]) for b in pcg_sharded.shard_blocks(geo, f)] == \
        [0.0, 1.0, 2.0, 3.0]
    g = torch.where(torch.tensor(True), f * torch.tensor(2.0) + f, f)
    assert isinstance(g, DeviceStacks) and g.dtype == torch.float32
    assert torch.equal(g.parts[0], 3 * f.parts[0])
    assert torch.zeros_like(f).parts[0].abs().sum() == 0


def test_default_mesh_runs_on_cuda_and_device_cpu_on_one_shard(monkeypatch):
    r = pcg_sharded.pcg_solve_sharded(Problem(M=24, N=24), device="cpu")
    assert int(r.iterations) == _jax_single(24, 24)[0]
    with pytest.raises(ValueError, match="mesh or a device"):
        pcg_sharded.pcg_solve_sharded(Problem(M=24, N=24),
                                      _cpu_mesh((1, 1)), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcg_sharded.pcg_solve_sharded(Problem(M=24, N=24))


@pytest.mark.parametrize("setup", ["host", "device"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_device_stacks_solve_as_one(dtype, setup):
    """The multi-device arm of DeviceStacks: a 2×4 mesh whose shards
    alternate between two devices (``cpu`` and ``cpu:0``, distinct to the
    mesh, so every field is two stacks and every mesh-wide scalar is moved
    to the second) gives the one-device mesh's count and iterate bit for
    bit."""
    cpu, cpu0 = torch.device("cpu"), torch.device("cpu", 0)
    p = Problem(M=37, N=29)
    two = mesh.Mesh(px=2, py=4, devices=(cpu, cpu0) * 4)
    geo = pcg_sharded.geometry(p, two)
    assert geo.devices == (cpu, cpu0)
    assert geo.shards == ((0, 2, 4, 6), (1, 3, 5, 7))
    got = pcg_sharded.pcg_solve_sharded(p, two, dtype=getattr(torch, dtype),
                                        setup=setup)
    one = pcg_sharded.pcg_solve_sharded(p, _cpu_mesh((2, 4)),
                                        dtype=getattr(torch, dtype),
                                        setup=setup)
    assert (int(got.iterations), int(got.flag)) == \
        (int(one.iterations), int(one.flag))
    assert torch.equal(got.w, one.w)


def test_device_stacks_move_scalars_to_each_device():
    """A part on another device (``meta``) gets the lead device's scalars
    moved to it; each part keeps its device through arithmetic and
    torch.where."""
    m = mesh.Mesh(px=1, py=2, devices=(torch.device("cpu"),
                                       torch.device("meta")))
    geo = pcg_sharded.geometry(Problem(M=24, N=24), m)
    f = pcg_sharded.from_blocks(geo, [torch.ones(3, 4),
                                      torch.ones(3, 4, device="meta")])
    g = torch.where(torch.tensor(True), f * torch.tensor(2.0) + f, f)
    assert [part.device.type for part in g.parts] == ["cpu", "meta"]
    assert torch.equal(g.parts[0], torch.full((1, 3, 4), 3.0))
    assert [b.device.type for b in pcg_sharded.shard_blocks(geo, g)] == \
        ["cpu", "meta"]
