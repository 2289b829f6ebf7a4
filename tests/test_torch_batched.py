"""Port parity: batched multi-RHS solves (``poisson_tpu_torch.solvers
.batched``, its mesh form in ``parallel.pcg_sharded`` and the
``solve-batched`` CLI) against ``poisson_tpu.solvers.batched``, on the CPU.

Tolerances (the ROADMAP's rule): per-member counts and stop flags equal
JAX's ``solve_batched`` on the same inputs; fp64 iterates within 1e-10 of
JAX's; fp32 iterates within 1e-6 of JAX's fp64 solve of the same members.
Inside the port, member i of a batch equals its sequential
``pcg_solve`` bit for bit (each member's sums are its own solve's
``torch.sum`` calls, ``ops.stencil.member_sums``), and on a mesh the counts
and flags equal the unsharded batch's with fp64 iterates within 1e-10.
"""

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

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.parallel import mesh as jax_mesh
from poisson_tpu.solvers import batched as jax_batched
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.ops.stencil import member_sums
from poisson_tpu_torch.parallel.mesh import make_solver_mesh
from poisson_tpu_torch.solvers import batched, batched_selfcheck
from poisson_tpu_torch.solvers.pcg import (
    FLAG_BREAKDOWN,
    FLAG_CONVERGED,
    pcg_solve,
)

ROOT = Path(__file__).resolve().parents[1]
GATES = (0.25, 1.0, 4.0, 1.5, 0.75)
ATOL = {"float64": 1e-10, "float32": 1e-6}


@pytest.fixture(autouse=True)
def _fresh_state():
    """One intra-op thread (several workers share the cores), and the
    bucket caches and counters of both packages cleared around each test,
    so the counter cases see only their own calls."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    for reset in (batched.reset_bucket_cache, metrics.reset,
                  jax_batched.reset_bucket_cache, jax_metrics.reset):
        reset()
    yield
    for reset in (batched.reset_bucket_cache, metrics.reset,
                  jax_batched.reset_bucket_cache, jax_metrics.reset):
        reset()
    torch.set_num_threads(saved)


def _stack(M, N, members, seed=0):
    """Seeded physical right-hand sides with a zero Dirichlet ring: the
    problem's indicator RHS times a member factor in [0.5, 2) plus a
    smooth seeded bump, so members converge at different counts."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, np.pi, M + 1)[:, None]
    y = np.linspace(0.0, np.pi, N + 1)[None, :]
    out = np.zeros((members, M + 1, N + 1))
    for i in range(members):
        fx, fy = rng.integers(1, 4, size=2)
        out[i] = (0.5 + 1.5 * rng.random()) * np.sin(fx * x) * np.sin(fy * y)
    out[:, 0, :] = out[:, -1, :] = out[:, :, 0] = out[:, :, -1] = 0.0
    return out


def _inputs(form, M=40, N=40):
    """(port args, JAX args) of one input form."""
    if form == "problems":
        fvals = (1.0, 0.5, 2.0, 3.0)
        return (([Problem(M=M, N=N, f_val=f) for f in fvals],), {},
                ([JaxProblem(M=M, N=N, f_val=f) for f in fvals],), {})
    if form == "gates":
        return ((Problem(M=M, N=N),), dict(rhs_gates=GATES),
                (JaxProblem(M=M, N=N),), dict(rhs_gates=GATES))
    stack = _stack(M, N, 4)
    return ((Problem(M=M, N=N),), dict(rhs_stack=stack),
            (JaxProblem(M=M, N=N),), dict(rhs_stack=stack))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("form", ["problems", "gates", "stack"])
def test_member_counts_flags_and_iterates_match_jax(form, dtype):
    args, kw, jargs, jkw = _inputs(form)
    got = batched.solve_batched(*args, dtype=dtype, device="cpu", **kw)
    ref = jax_batched.solve_batched(*jargs, dtype=getattr(jnp, dtype),
                                    **jkw)
    ref64 = (ref if dtype == "float64" else jax_batched.solve_batched(
        *jargs, dtype=jnp.float64, **jkw))
    assert got.iterations.tolist() == np.asarray(ref.iterations).tolist()
    assert got.flag.tolist() == np.asarray(ref.flag).tolist()
    assert set(got.flag.tolist()) == {FLAG_CONVERGED}
    assert len(set(got.iterations.tolist())) >= 2   # the freeze is used
    assert int(got.max_iterations) == int(ref.max_iterations)
    assert got.w.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.w.double().numpy(), np.asarray(ref64.w),
                               rtol=0, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_member_is_its_sequential_solve_bit_for_bit(dtype):
    p = Problem(M=40, N=40)
    bat = batched.solve_batched(p, rhs_gates=GATES, dtype=dtype,
                                device="cpu")
    for i, g in enumerate(GATES):
        seq = pcg_solve(p, dtype=dtype, rhs_gate=g, device="cpu")
        assert int(bat.iterations[i]) == int(seq.iterations)
        assert int(bat.flag[i]) == int(seq.flag)
        assert torch.equal(bat.w[i], seq.w)
        assert torch.equal(bat.diff[i], seq.diff)
    fvals = (1.0, 0.5, 2.0)
    bat = batched.solve_batched([p.with_(f_val=f) for f in fvals],
                                dtype=dtype, device="cpu")
    for i, f in enumerate(fvals):
        seq = pcg_solve(p.with_(f_val=f), dtype=dtype, device="cpu")
        assert int(bat.iterations[i]) == int(seq.iterations)
        assert torch.equal(bat.w[i], seq.w)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("batch", [1, 3, 8])
def test_member_sums_are_each_members_own_sum(batch, dtype):
    """Members above torch's 32768-element grain, summed on four threads,
    where the thread split of one sum depends on how many outputs it has:
    every member's sum has the bits of its own unbatched one, for the
    products the ops bundle forms (u·v, and (u·sc)² in the scaled ops)."""
    torch.set_num_threads(4)
    rng = np.random.default_rng(batch)
    u, v = (torch.tensor(rng.standard_normal((batch, 213, 309)),
                         dtype=getattr(torch, dtype))[:, 1:-1, 1:-1]
            for _ in range(2))
    dots = member_sums(torch.mul, u, v)
    squares = member_sums(torch.pow, u, 2)
    assert dots.shape == squares.shape == (batch, 1, 1)
    for i in range(batch):
        assert torch.equal(dots[i, 0, 0],
                           torch.sum(u[i] * v[i], dim=(-2, -1)))
        assert torch.equal(squares[i, 0, 0],
                           torch.sum(u[i] ** 2, dim=(-2, -1)))


def test_padding_is_invisible_and_origin_holds():
    p = Problem(M=40, N=40)
    ids = ("req-a", "req-b", "req-c")
    runs = {size: batched.solve_batched(p, rhs_gates=GATES[:3],
                                        member_ids=ids, bucket=size,
                                        dtype="float32", device="cpu")
            for size in (None, 3, 8)}
    for r in runs.values():
        assert r.origin == ids
        assert r.w.shape == (3, 41, 41)
        assert torch.equal(r.w, runs[3].w)
        assert r.iterations.tolist() == runs[3].iterations.tolist()
        assert int(r.max_iterations) == max(r.iterations.tolist())
    # Only a pinned bucket pads: the port has no compiled shape to reuse.
    assert metrics.get("batched.padding_members") == 0 + 0 + (8 - 3)
    assert metrics.get("batched.solves") == 9
    # A zero right-hand side, what a padding member is, stops at
    # iteration 1 with FLAG_BREAKDOWN.
    z = batched.solve_batched(p, rhs_gates=(1.0, 0.0), device="cpu")
    assert z.iterations.tolist()[1] == 1
    assert z.flag.tolist() == [FLAG_CONVERGED, FLAG_BREAKDOWN]
    assert z.origin == (0, 1)


def _counters(registry):
    return {name: registry.get(name) for name in (
        "batched.bucket_cache.hits", "batched.bucket_cache.misses",
        "batched.solves", "batched.padding_members")}


def test_bucket_counters_follow_jax_on_the_same_calls():
    calls = [
        (dict(M=40, N=40), dict(rhs_gates=(1.0, 2.0, 3.0))),     # miss, 4
        (dict(M=40, N=40), dict(rhs_gates=(1.0, 2.0, 3.0, 4.0))),  # hit
        (dict(M=40, N=40, f_val=2.0), dict(rhs_gates=(1.0,) * 4)),  # hit
        (dict(M=40, N=40), dict(rhs_gates=(1.0,) * 5)),          # miss, 8
        (dict(M=40, N=40), dict(rhs_gates=(1.0, 2.0), bucket=8)),  # hit
        (dict(M=40, N=40), dict(rhs_gates=(1.0,), dtype="float64")),
        (dict(M=30, N=40), dict(rhs_gates=(1.0,), dtype="float64")),
        (dict(M=30, N=40), dict(rhs_gates=(2.0,), dtype="float64")),
    ]
    for fields, kw in calls:
        dtype = kw.pop("dtype", "float32")
        batched.solve_batched(Problem(**fields), dtype=dtype, device="cpu",
                              **kw)
        jax_batched.solve_batched(JaxProblem(**fields),
                                  dtype=getattr(jnp, dtype), **kw)
    got, ref = _counters(metrics), _counters(jax_metrics)
    # JAX pads every ragged call to its bucket (1 + 0 + 0 + 3 + 6 members);
    # the port pads only the call that pins one.
    assert ref.pop("batched.padding_members") == 10
    assert got.pop("batched.padding_members") == 6
    assert got == ref
    assert got["batched.bucket_cache.hits"] == 4
    assert got["batched.bucket_cache.misses"] == 4


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("grid", [(1, 2), (2, 2)])
def test_mesh_counts_match_jax_and_the_unsharded_batch(grid, dtype):
    p, jp = Problem(M=40, N=40), JaxProblem(M=40, N=40)
    mesh = make_solver_mesh(["cpu"] * (grid[0] * grid[1]), grid=grid)
    jmesh = jax_mesh.make_solver_mesh(jax.devices()[: grid[0] * grid[1]],
                                      grid=grid)
    got = batched.solve_batched(p, rhs_gates=GATES, dtype=dtype, mesh=mesh,
                                member_ids="abcde")
    ref = jax_batched.solve_batched(jp, rhs_gates=GATES,
                                    dtype=getattr(jnp, dtype), mesh=jmesh)
    flat = batched.solve_batched(p, rhs_gates=GATES, dtype=dtype,
                                 device="cpu")
    assert got.iterations.tolist() == np.asarray(ref.iterations).tolist()
    assert got.iterations.tolist() == flat.iterations.tolist()
    assert got.flag.tolist() == np.asarray(ref.flag).tolist()
    assert got.flag.tolist() == flat.flag.tolist()
    assert got.origin == tuple("abcde")
    atol = ATOL[dtype] if dtype == "float64" else 1e-6
    np.testing.assert_allclose(got.w.numpy(), flat.w.numpy(), rtol=0,
                               atol=atol)
    if dtype == "float64":
        np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), rtol=0,
                                   atol=1e-10)
    # Mesh buckets are their own family of keys, as in the JAX package.
    assert metrics.get("batched.bucket_cache.misses") == 2


def test_mesh_rhs_stack_matches_the_unsharded_batch():
    p = Problem(M=40, N=40)
    stack = _stack(40, 40, 3, seed=1)
    got = batched.solve_batched(p, rhs_stack=stack,
                                mesh=make_solver_mesh(["cpu"] * 4,
                                                      grid=(2, 2)))
    flat = batched.solve_batched(p, rhs_stack=stack, device="cpu")
    assert got.iterations.tolist() == flat.iterations.tolist()
    np.testing.assert_allclose(got.w.numpy(), flat.w.numpy(), rtol=0,
                               atol=1e-10)


@pytest.mark.parametrize("kwargs,item", [
    # The probe is ported; the JAX package has no mesh program for it.
    (dict(verify_every=5, mesh="2x2"), "integrity probe yet"),
    (dict(preconditioner="mg", verify_every=5, mesh="2x2"),
     "dispatch MG batches on a single device"),
    (dict(mode="block"), "item 9"),
], ids=["verify_every", "mg", "block"])
def test_unported_options_are_refused_with_their_item(kwargs, item):
    if kwargs.get("mesh"):
        kwargs["mesh"] = make_solver_mesh(["cpu"] * 4, grid=(2, 2))
    with pytest.raises(ValueError, match=item):
        batched.solve_batched(Problem(M=40, N=40), rhs_gates=(1.0,),
                              device="cpu", **kwargs)


@pytest.mark.parametrize("kwargs,message", [
    (dict(rhs_gates=(1.0,), rhs_stack=np.zeros((1, 41, 41))),
     "exactly one"),
    (dict(), "exactly one"),
    (dict(rhs_gates=(1.0, 2.0), member_ids=("a",)), "one id per member"),
    (dict(rhs_gates=(1.0,) * 5, bucket=4), "smaller than batch"),
    (dict(rhs_stack=np.zeros((2, 40, 41))), "rhs_stack must be"),
    (dict(rhs_gates=(1.0,), mode="other"), "unknown mode"),
], ids=["two_forms", "no_form", "member_ids", "bucket", "stack_shape",
        "mode"])
def test_input_errors(kwargs, message):
    with pytest.raises(ValueError, match=message):
        batched.solve_batched(Problem(M=40, N=40), device="cpu", **kwargs)


def test_members_must_share_the_operator():
    with pytest.raises(ValueError, match="share the operator"):
        batched.solve_batched([Problem(M=40, N=40), Problem(M=40, N=41)],
                              device="cpu")


@pytest.mark.parametrize("n,bucket", [(1, 1), (3, 4), (16, 16), (17, 32),
                                      (256, 256), (300, 300)])
def test_bucket_ladder_is_jax_s(n, bucket):
    assert batched.bucket_size(n) == jax_batched.bucket_size(n) == bucket
    assert batched.DEFAULT_BUCKETS == jax_batched.DEFAULT_BUCKETS


def test_selfcheck_passes_on_the_cpu(capsys):
    assert batched_selfcheck.main(["--device", "cpu"]) == 0
    assert "batched selfcheck OK" in capsys.readouterr().out


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _cli(module, *args):
    out = subprocess.run([sys.executable, "-m", module, "solve-batched",
                          *args], cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cli_json_has_the_jax_keys_and_counts():
    args = ("40", "40", "--batch", "4", "--vary-rhs", "--json",
            "--compare-sequential")
    got = _cli("poisson_tpu_torch", *args, "--device", "cpu")
    ref = _cli("poisson_tpu", *args)
    assert set(got) == set(ref)
    for key in ("M", "N", "batch", "bucket", "dtype", "max_iterations",
                "iterations", "converged", "flags",
                "iterations_match_sequential"):
        assert got[key] == ref[key], key
    assert got["iterations_match_sequential"] is True


@pytest.mark.parametrize("flag,item", [
    # The probe is ported: what stays refused is the JAX CLI's refusals.
    (["--verify-every", "-1"], "verify-every must be >= 0"),
    (["--verify-tol", "1e-3"], "pass --verify-every K to arm it"),
    (["--preconditioner", "mg", "--verify-every", "5", "--mesh", "2x2"],
     "sharded hierarchy"),
], ids=["verify_every", "verify_tol", "mg"])
def test_cli_refuses_unported_flags_with_their_item(flag, item):
    from poisson_tpu_torch.cli import main

    with pytest.raises(SystemExit, match=item):
        main(["solve-batched", "40", "40", "--batch", "2", "--device",
              "cpu", *flag])


def test_cli_mesh_run_matches_sequential(capsys):
    from poisson_tpu_torch import obs
    from poisson_tpu_torch.cli import main

    try:
        assert main(["solve-batched", "40", "40", "--batch", "5",
                     "--vary-rhs", "--mesh", "2x2", "--device", "cpu",
                     "--compare-sequential", "--json"]) == 0
    finally:
        obs.shutdown()
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["iterations"] == [50, 50, 51, 51, 51]
    assert rec["bucket"] == 8
    assert rec["iterations_match_sequential"] is True
