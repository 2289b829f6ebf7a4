"""Port parity: geometric multigrid preconditioning
(``poisson_tpu_torch.mg`` and ``preconditioner="mg"`` through the plain,
batched, lane, chunked and CLI solves) against ``poisson_tpu.mg``, on the
CPU.

Tolerances: the level plan, the refusals and the host fp64 hierarchy
(dense coarsest inverse included) equal JAX's exactly; one V-cycle on the
same seeded residual under the same hierarchy (carried across by
``interop.mg_levels_from_reference``) within 1e-12 relative in fp64 and
1e-5 in fp32 (the coarsest matvec adds in another order); MG solves give
JAX's counts and flags in fp64 and fp32 (8 / 11 / 12 / 14 at 40×40 /
80×120 / 200×300 / 400×600), fp64 iterates within 1e-10 of JAX's and fp32
ones within 1e-5 of JAX's fp64 solve. Inside the port, batched and lane
members equal their solo MG solves bit for bit, and a chunked MG solve
its one-shot solve.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu import mg as jax_mg
from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.mg import selfcheck as jax_selfcheck
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import batched as jax_batched
from poisson_tpu.solvers import checkpoint as jax_ck
from poisson_tpu.solvers import lanes as jax_lanes
from poisson_tpu.solvers.pcg import host_fields64 as jax_host_fields64
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch import interop, mg
from poisson_tpu_torch.cli import main as cli_main
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.mg import selfcheck
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers import batched
from poisson_tpu_torch.solvers import checkpoint as ck
from poisson_tpu_torch.solvers.lanes import LaneBatch
from poisson_tpu_torch.solvers.pcg import (
    FLAG_CONVERGED,
    host_fields64,
    pcg_solve,
)

COUNTS = {(40, 40): 8, (80, 120): 11, (200, 300): 12, (400, 600): 14}


@pytest.fixture(autouse=True)
def _fresh_state():
    """One intra-op thread (several workers share the cores), and the
    bucket caches and counters of both packages cleared around each test;
    the hierarchy caches stay (a build is paid once per process)."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    resets = (batched.reset_bucket_cache, metrics.reset,
              jax_batched.reset_bucket_cache, jax_metrics.reset)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()
    torch.set_num_threads(saved)


@functools.cache
def _jax_mg(M, N, dtype):
    """JAX's MG solve, once per process: (iterations, flag, iterate)."""
    r = jax_pcg_solve(JaxProblem(M=M, N=N), dtype=dtype,
                      preconditioner="mg")
    return int(r.iterations), int(r.flag), np.asarray(r.w)


# -- level planning, refusals, the host hierarchy -----------------------


@pytest.mark.parametrize("M,N", [
    (400, 600), (800, 1200), (2400, 3200), (3200, 4800), (40, 40),
    (80, 120), (20, 20), (22, 20), (18, 18), (10, 10), (33, 33), (41, 40),
    (40, 41), (1, 1), (64, 96)])
def test_plan_and_validation_are_jax_s(M, N):
    assert mg.plan_levels(M, N) == jax_mg.plan_levels(M, N)
    try:
        want = jax_mg.validate_mg_problem(JaxProblem(M=M, N=N))
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mg.validate_mg_problem(Problem(M=M, N=N))
        assert str(got.value) == str(e)
    else:
        assert mg.validate_mg_problem(Problem(M=M, N=N)) == want


def test_plan_with_a_config_is_jax_s():
    for kw in (dict(max_levels=2), dict(min_size=4), dict(min_size=50)):
        assert (mg.plan_levels(800, 1200, mg.MGConfig(**kw))
                == jax_mg.plan_levels(800, 1200, jax_mg.MGConfig(**kw)))


def test_config_prints_as_jax_s():
    assert repr(mg.DEFAULT_MG) == repr(jax_mg.DEFAULT_MG)
    cfg = dict(pre_smooth=1, post_smooth=1, omega=0.7, coarse_sweeps=8)
    assert repr(mg.MGConfig(**cfg)) == repr(jax_mg.MGConfig(**cfg))
    assert mg.PRECONDITIONERS == jax_mg.PRECONDITIONERS
    with pytest.raises(ValueError, match="unknown preconditioner"):
        mg.resolve_preconditioner("amg")


@pytest.mark.parametrize("M,N", [(80, 120), (200, 300)])
def test_host_hierarchy_is_jax_s_bit_for_bit(M, N):
    a, b, _, _ = host_fields64(Problem(M=M, N=N), False)
    ja, jb, _, _ = jax_host_fields64(JaxProblem(M=M, N=N), False)
    got = mg.build_hierarchy64(Problem(M=M, N=N), a, b)
    want = jax_mg.build_hierarchy64(JaxProblem(M=M, N=N), np.asarray(ja),
                                    np.asarray(jb))
    assert got["dims"] == want["dims"]
    assert len(got["levels"]) == len(want["levels"])
    for mine, theirs in zip(got["levels"], want["levels"]):
        for x, y in zip(mine, theirs):
            np.testing.assert_array_equal(x, y)
    assert got["coarse_inv"] is not None
    np.testing.assert_array_equal(got["coarse_inv"], want["coarse_inv"])
    np.testing.assert_array_equal(got["scinv"], want["scinv"])


def test_coarsening_is_jax_s_on_seeded_fields():
    rng = np.random.default_rng(3)
    a, b = rng.random((65, 97)), rng.random((65, 97))
    np.testing.assert_array_equal(mg.coarsen_a(a), jax_mg.coarsen_a(a))
    np.testing.assert_array_equal(mg.coarsen_b(b), jax_mg.coarsen_b(b))
    np.testing.assert_array_equal(mg.coarsen_a(np.full((65, 97), 3.5)), 3.5)


# -- the cycle ----------------------------------------------------------


@pytest.mark.parametrize("dtype,dense", [
    ("float64", True), ("float32", True), ("float64", False),
    ("float32", False)])
def test_v_cycle_matches_jax_under_the_same_hierarchy(dtype, dense):
    """One V-cycle of a seeded residual, JAX's hierarchy carried across:
    ≤ 1e-12 relative in fp64, ≤ 1e-5 in fp32; with the dense coarsest
    inverse and with the smoother sweeps that stand in for it."""
    M, N = 80, 120
    jcfg = jax_mg.MGConfig() if dense else jax_mg.MGConfig(
        coarse_dense_limit=0)
    cfg = mg.MGConfig(**jcfg.__dict__)
    jp = JaxProblem(M=M, N=N)
    a, b, _, _ = jax_host_fields64(jp, False)
    jh = jax_mg.hierarchy_from_fields(jp, np.asarray(a), np.asarray(b),
                                      dtype, False, jcfg)
    assert (jh.coarse_inv is not None) == dense
    hier = interop.mg_levels_from_reference(
        [[np.asarray(x) for x in level] for level in jh.levels],
        None if jh.coarse_inv is None else np.asarray(jh.coarse_inv),
        device="cpu")
    r = np.zeros((M + 1, N + 1))
    r[1:-1, 1:-1] = np.random.default_rng(0).standard_normal((M - 1, N - 1))
    want = np.asarray(jax_mg.v_cycle(jh, jnp.asarray(r, dtype), jp.h1,
                                     jp.h2, jcfg), np.float64)
    p = Problem(M=M, N=N)
    got = mg.v_cycle(hier, torch.tensor(r, dtype=getattr(torch, dtype)),
                     p.h1, p.h2, cfg).double().numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= (1e-12 if dtype == "float64" else 1e-5), rel
    assert not got[0].any() and not got[-1].any()
    assert not got[:, 0].any() and not got[:, -1].any()


def test_mg_ops_is_the_setup_s_bundle():
    """``mg_ops`` over explicit fields applies the V-cycle the MG setup's
    bundle does, scaled and unscaled."""
    p = Problem(M=40, N=40)
    for dtype, scaled in (("float64", False), ("float32", True)):
        setup = mg.mg_solve_setup(p, dtype, scaled, "cpu")
        a, b, _, _ = (torch.tensor(x, dtype=getattr(torch, dtype))
                      for x in host_fields64(p, scaled))
        hier = mg.device_hierarchy(p, dtype, scaled, device="cpu")
        ops = mg.mg_ops(p, a, b, setup.aux, hier, scaled=scaled)
        assert torch.equal(ops.apply_Dinv(setup.rhs),
                           setup.ops.apply_Dinv(setup.rhs))
        assert torch.equal(ops.apply_A(setup.rhs),
                           setup.ops.apply_A(setup.rhs))
        assert setup.check_every == 1


def test_v_cycle_member_equals_its_solo_cycle():
    p = Problem(M=64, N=64)
    hier = mg.device_hierarchy(p, "float32", False, device="cpu")
    assert hier.coarse_inv is not None
    r = torch.tensor(host_fields64(p, False)[2], dtype=torch.float32)
    stack = torch.stack([r, r * 1.3, r * 0.2])
    cycle = lambda x: mg.v_cycle(hier, x, p.h1, p.h2)
    got = cycle(stack)
    for i, g in enumerate((1.0, 1.3, 0.2)):
        assert torch.equal(got[i], cycle(r * g))


def test_transfers_match_jax():
    rng = np.random.default_rng(1)
    e = np.zeros((2, 21, 31))
    e[:, 1:-1, 1:-1] = rng.standard_normal((2, 19, 29))
    np.testing.assert_array_equal(
        mg.prolong_bilinear(torch.tensor(e)).numpy(),
        np.asarray(jax_mg.prolong_bilinear(jnp.asarray(e))))
    f = np.asarray(mg.prolong_bilinear(torch.tensor(e)))
    np.testing.assert_allclose(
        mg.restrict_full_weighting(torch.tensor(f)).numpy(),
        np.asarray(jax_mg.restrict_full_weighting(jnp.asarray(f))),
        rtol=0, atol=1e-15)


@pytest.mark.parametrize("max_levels,bound", [(2, 0.2), (16, 0.25)])
def test_two_grid_factor_is_jax_s_and_under_its_bound(max_levels, bound):
    got = selfcheck.two_grid_factor(64, 64, max_levels, device="cpu")
    want = jax_selfcheck.two_grid_factor(64, 64, max_levels)
    assert got < bound
    assert abs(got - want) <= 1e-10


def test_selfcheck_passes_on_the_cpu(capsys):
    assert selfcheck.main(["--device", "cpu"]) == 0
    assert "mg selfcheck OK" in capsys.readouterr().out


# -- solves -------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("M,N", list(COUNTS))
def test_mg_solve_matches_jax(M, N, dtype):
    got = pcg_solve(Problem(M=M, N=N), dtype=dtype, device="cpu",
                    preconditioner="mg")
    k, flag, w = _jax_mg(M, N, dtype)
    assert (int(got.iterations), int(got.flag)) == (k, flag) \
        == (COUNTS[M, N], FLAG_CONVERGED)
    if dtype == "float64":
        np.testing.assert_allclose(got.w.numpy(), w, rtol=0, atol=1e-10)
    else:
        np.testing.assert_allclose(got.w.double().numpy(),
                                   _jax_mg(M, N, "float64")[2], rtol=0,
                                   atol=1e-5)


def test_mg_solves_the_jacobi_problem_and_honours_the_gate():
    p = Problem(M=64, N=96)
    rj = pcg_solve(p, device="cpu")
    rm = pcg_solve(p, device="cpu", preconditioner="mg")
    assert int(rm.flag) == FLAG_CONVERGED and float(rm.diff) < p.delta
    assert int(rm.iterations) * 3 <= int(rj.iterations)
    np.testing.assert_allclose(rm.w.numpy(), rj.w.numpy(), atol=5e-5)
    gated = pcg_solve(p, device="cpu", preconditioner="mg", rhs_gate=2.0)
    jg = jax_pcg_solve(JaxProblem(M=64, N=96), dtype="float64",
                       preconditioner="mg", rhs_gate=2.0)
    assert int(gated.iterations) == int(jg.iterations)
    np.testing.assert_allclose(gated.w.numpy(), np.asarray(jg.w), rtol=0,
                               atol=1e-10)


def test_mg_iterate_lies_nearer_the_solution_than_jacobi_s():
    """The δ = 1e-6 Jacobi and MG iterates lie apart by the same gap in
    both packages (to 1e-10), and the MG iterate within 5e-5 (the JAX
    package's tolerance between the two) of a Jacobi solve converged to
    δ = 1e-10, nearer to it than the δ = 1e-6 Jacobi iterate."""
    p = Problem(M=200, N=300)
    mg_w = pcg_solve(p, dtype="float64", device="cpu",
                     preconditioner="mg").w.numpy()
    jac = pcg_solve(p, dtype="float64", device="cpu").w.numpy()
    jax_jac = np.asarray(jax_pcg_solve(JaxProblem(M=200, N=300),
                                       dtype="float64").w)
    gap = np.abs(mg_w - jac).max()
    jax_gap = np.abs(_jax_mg(200, 300, "float64")[2] - jax_jac).max()
    assert abs(gap - jax_gap) <= 1e-10
    tight = pcg_solve(p.with_(delta=1e-10), dtype="float64",
                      device="cpu").w.numpy()
    assert np.abs(mg_w - tight).max() <= 5e-5
    assert np.abs(mg_w - tight).max() < np.abs(jac - tight).max()


@pytest.mark.parametrize("kwargs,message", [
    (dict(preconditioner="amg"), "unknown preconditioner"),
    (dict(preconditioner="mg", problem=Problem(M=33, N=33)), "coarsens"),
    (dict(preconditioner="mg", problem=Problem(M=10, N=10)), "coarsens"),
])
def test_mg_solve_refuses_what_jax_refuses(kwargs, message):
    problem = kwargs.pop("problem", Problem(M=20, N=20))
    with pytest.raises(ValueError, match=message):
        pcg_solve(problem, device="cpu", **kwargs)


def test_hierarchy_cache_counters_are_jax_s():
    mg.reset_hierarchy_cache()
    jax_mg.reset_hierarchy_cache()
    p, jp = Problem(M=40, N=40), JaxProblem(M=40, N=40)
    for q, jq in ((p, jp), (p, jp), (p.with_(f_val=2.0), jp.with_(f_val=2.0))):
        mg.device_hierarchy(q, "float32", True, device="cpu")
        jax_mg.device_hierarchy(jq, "float32", True)
    pcg_solve(p, dtype="float32", device="cpu", preconditioner="mg")
    jax_pcg_solve(jp, dtype="float32", preconditioner="mg")
    for name in ("mg.hierarchy_cache.misses", "mg.hierarchy_cache.hits",
                 "mg.solves"):
        assert metrics.get(name) == jax_metrics.get(name), name
    assert metrics.get("mg.hierarchy_cache.misses") == 1
    assert metrics.get("mg.hierarchy_cache.hits") == 3
    gauges = metrics.snapshot()["gauges"]
    jax_gauges = jax_metrics.snapshot()["gauges"]
    for name in ("mg.levels", "mg.coarse_dense"):
        assert gauges[name] == jax_gauges[name], name
    assert (gauges["mg.levels"], gauges["mg.coarse_dense"]) == (3, 1)
    # Another dtype is another hierarchy.
    mg.device_hierarchy(p, "float64", False, device="cpu")
    assert metrics.get("mg.hierarchy_cache.misses") == 2


# -- batched and lanes --------------------------------------------------


def test_batched_mg_members_equal_their_solo_solves_and_count_as_jax():
    """JAX's call sequence (tests/test_mg.py:265-295): an MG batch, the
    Jacobi batch of the same bucket (another family: two misses), the MG
    bucket again (a hit). Members equal their solo MG solves bit for bit,
    and their counts and flags are JAX's."""
    p, jp = Problem(M=64, N=64), JaxProblem(M=64, N=64)
    gates = [1.0, 1.3, 0.7]
    solo = [pcg_solve(p, dtype="float32", device="cpu", preconditioner="mg",
                      rhs_gate=g) for g in gates]
    got = batched.solve_batched(p, rhs_gates=gates, dtype="float32",
                                preconditioner="mg", device="cpu")
    want = jax_batched.solve_batched(jp, rhs_gates=gates, dtype="float32",
                                     preconditioner="mg")
    assert got.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert got.flag.tolist() == np.asarray(want.flag).tolist()
    for i, s in enumerate(solo):
        assert int(got.iterations[i]) == int(s.iterations)
        assert int(got.flag[i]) == int(s.flag) == FLAG_CONVERGED
        assert torch.equal(got.w[i], s.w)
    for solve, prob in ((batched.solve_batched, p),
                        (jax_batched.solve_batched, jp)):
        kw = dict(device="cpu") if prob is p else {}
        solve(prob, rhs_gates=gates, dtype="float32", **kw)
        solve(prob, rhs_gates=[2.0, 0.5, 1.1], dtype="float32",
              preconditioner="mg", **kw)
    for name in ("batched.bucket_cache.misses", "batched.bucket_cache.hits",
                 "batched.solves"):
        assert metrics.get(name) == jax_metrics.get(name), name
    # Two MG batches of three in both, and the port's three solo solves.
    assert metrics.get("mg.solves") == jax_metrics.get("mg.solves") + 3 == 9
    assert metrics.get("batched.bucket_cache.misses") == 2
    assert metrics.get("batched.bucket_cache.hits") == 1


@pytest.mark.parametrize("form", ["problems", "rhs_stack", "bucket"])
def test_batched_mg_forms_equal_the_solo_solves(form):
    p = Problem(M=40, N=40)
    fvals = (1.0, 2.5)
    if form == "problems":
        got = batched.solve_batched([p.with_(f_val=f) for f in fvals],
                                    dtype="float64", preconditioner="mg",
                                    device="cpu")
        solo = [pcg_solve(p.with_(f_val=f), dtype="float64", device="cpu",
                          preconditioner="mg") for f in fvals]
    elif form == "rhs_stack":
        rhs = host_fields64(p, False)[2]
        got = batched.solve_batched(p, rhs_stack=np.stack([rhs, 2 * rhs]),
                                    dtype="float64", preconditioner="mg",
                                    device="cpu")
        solo = [pcg_solve(p, dtype="float64", device="cpu",
                          preconditioner="mg", rhs_gate=g) for g in (1, 2)]
    else:
        got = batched.solve_batched(p, rhs_gates=fvals, dtype="float32",
                                    bucket=4, preconditioner="mg",
                                    device="cpu")
        solo = [pcg_solve(p, dtype="float32", device="cpu",
                          preconditioner="mg", rhs_gate=g) for g in fvals]
    for i, s in enumerate(solo):
        assert int(got.iterations[i]) == int(s.iterations)
        assert int(got.flag[i]) == int(s.flag) == FLAG_CONVERGED
        assert torch.equal(got.w[i], s.w)


@pytest.mark.parametrize("kwargs,message", [
    (dict(mesh="2x2"), "dispatch MG batches on a single device"),
    (dict(geometries=[{"kind": "ellipse"}]), "co-batch"),
    # MG verifies on one device (the probe is ported), not on a mesh.
    (dict(verify_every=5, mesh="2x2"),
     "dispatch MG batches on a single device"),
], ids=["mesh", "geometries", "verify_every"])
def test_batched_mg_refuses_where_jax_refuses(kwargs, message):
    if kwargs.get("mesh"):
        from poisson_tpu_torch.parallel.mesh import make_solver_mesh

        kwargs["mesh"] = make_solver_mesh(["cpu"] * 4, grid=(2, 2))
    with pytest.raises(ValueError, match=message):
        batched.solve_batched(Problem(M=40, N=40), rhs_gates=(1.0,),
                              preconditioner="mg", **kwargs)


def test_lanes_mg_splice_step_retire_match_jax_and_solo():
    """JAX's lane case (tests/test_mg.py:298-322) in both packages: every
    retired member has JAX's count and flag and its solo MG solve's
    iterate, bit for bit."""
    gates = {"a": 1.0, "b": 1.3}
    results = {}
    for name, table in (
            ("port", LaneBatch(Problem(M=64, N=64), 2, dtype="float32",
                               chunk=3, preconditioner="mg", device="cpu")),
            ("jax", jax_lanes.LaneBatch(JaxProblem(M=64, N=64), 2,
                                        dtype="float32", chunk=3,
                                        preconditioner="mg"))):
        table.splice("a", gates["a"])
        table.step()                   # "b" joins a running table
        table.splice("b", gates["b"])
        done = {}
        while table.occupied():
            for v in table.lane_view():
                if v["member_id"] is not None and v["done"]:
                    res = table.retire(v["lane"])
                    done[res.member_id] = res
            if table.occupied():
                table.step()
        results[name] = done
    assert metrics.get("mg.solves") == jax_metrics.get("mg.solves") == 2
    for mid, g in gates.items():
        mine, theirs = results["port"][mid], results["jax"][mid]
        assert (mine.iterations, mine.flag) == (theirs.iterations,
                                                theirs.flag)
        assert mine.flag == FLAG_CONVERGED
        solo = pcg_solve(Problem(M=64, N=64), dtype="float32", device="cpu",
                         preconditioner="mg", rhs_gate=g)
        assert mine.iterations == int(solo.iterations)
        assert torch.equal(mine.w, solo.w)


def test_lanes_mg_refuses_multi_geometry_as_jax_does():
    for make in (lambda: LaneBatch(Problem(M=64, N=64), 2, device="cpu",
                                   preconditioner="mg", multi_geometry=True),
                 lambda: jax_lanes.LaneBatch(JaxProblem(M=64, N=64), 2,
                                             preconditioner="mg",
                                             multi_geometry=True)):
        with pytest.raises(ValueError, match="per-lane"):
            make()


# -- chunked and checkpointed -------------------------------------------


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_chunked_and_checkpointed_mg_equal_the_one_shot_solve(dtype,
                                                              tmp_path):
    p = Problem(M=64, N=64)
    one = pcg_solve(p, dtype=dtype, device="cpu", preconditioner="mg")
    chunked = ck.pcg_solve_chunked(p, chunk=3, dtype=dtype, device="cpu",
                                   preconditioner="mg")
    assert torch.equal(chunked.w, one.w)
    assert int(chunked.iterations) == int(one.iterations)
    path = str(tmp_path / "mg.npz")
    capped = ck.pcg_solve_checkpointed(p.with_(max_iter=4), path, chunk=2,
                                       dtype=dtype, device="cpu",
                                       preconditioner="mg")
    assert int(capped.iterations) == 4
    resumed = ck.pcg_solve_checkpointed(p, path, chunk=2, dtype=dtype,
                                        device="cpu", preconditioner="mg")
    assert torch.equal(resumed.w, one.w)
    assert int(resumed.iterations) == int(one.iterations)


@pytest.mark.parametrize("dtype,scaled", [("float64", False),
                                          ("float32", True)])
@pytest.mark.parametrize("config", [None, dict(omega=0.7, pre_smooth=1)])
def test_fingerprint_is_jax_s(dtype, scaled, config):
    p, jp = Problem(M=40, N=60, delta=1e-7), JaxProblem(M=40, N=60,
                                                        delta=1e-7)
    cfg = None if config is None else mg.MGConfig(**config)
    jcfg = None if config is None else jax_mg.MGConfig(**config)
    for pre in ("jacobi", "mg"):
        assert (ck._fingerprint(p, dtype, scaled, pre, cfg)
                == jax_ck._fingerprint(jp, dtype, scaled, pre, jcfg))
    assert ck._fingerprint(p, dtype, scaled) == ck._fingerprint(
        p, dtype, scaled, "jacobi", cfg)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_mg_checkpoint_crosses_packages(writer, dtype, tmp_path):
    """A capped MG file written by one package resumes in the other to
    JAX's one-shot count; a Jacobi resume of it is refused."""
    path = str(tmp_path / "mg.npz")
    capped, jcapped = Problem(M=40, N=40, max_iter=4), JaxProblem(
        M=40, N=40, max_iter=4)
    write = (lambda: jax_ck.pcg_solve_checkpointed(
                jcapped, path, chunk=2, dtype=dtype, preconditioner="mg"))\
        if writer == "jax" else (lambda: ck.pcg_solve_checkpointed(
            capped, path, chunk=2, dtype=dtype, device="cpu",
            preconditioner="mg"))
    assert int(write().iterations) == 4
    if writer == "jax":
        with pytest.raises(ValueError, match="different problem"):
            ck.pcg_solve_checkpointed(Problem(M=40, N=40), path, chunk=2,
                                      dtype=dtype, device="cpu")
        got = ck.pcg_solve_checkpointed(Problem(M=40, N=40), path, chunk=2,
                                        dtype=dtype, device="cpu",
                                        preconditioner="mg")
    else:
        got = jax_ck.pcg_solve_checkpointed(JaxProblem(M=40, N=40), path,
                                            chunk=2, dtype=dtype,
                                            preconditioner="mg")
    assert int(got.iterations) == _jax_mg(40, 40, dtype)[0] == 8
    assert int(got.flag) == FLAG_CONVERGED


# -- the CLI ------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_cli_mg_solve_picks_torch(dtype, capsys):
    import json

    assert cli_main(["40", "40", "--preconditioner", "mg", "--device", "cpu",
                     "--dtype", dtype, "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["iterations"] == 8 and rec["backend"] == "torch"
    assert rec["stopped"] is None and rec["hierarchy_seconds"] >= 0


@pytest.mark.parametrize("extra", [
    ["--backend", "fused"], ["--backend", "resident"], ["--backend", "ca"],
    ["--backend", "fused-sharded"], ["--backend", "ca-sharded"],
    ["--backend", "sharded"], ["--mesh", "2x2"]],
    ids=["fused", "resident", "ca", "fused-sharded", "ca-sharded", "sharded",
         "auto_mesh"])
def test_cli_kernel_and_sharded_backends_refuse_mg(extra):
    with pytest.raises(SystemExit, match="no MG program yet"):
        cli_main(["40", "40", "--preconditioner", "mg", "--device", "cpu",
                  *extra])


def test_cli_uncoarsenable_grid_exits_with_the_validation_message():
    with pytest.raises(SystemExit, match="coarsens at least once"):
        cli_main(["41", "40", "--preconditioner", "mg", "--device", "cpu"])
    with pytest.raises(SystemExit, match="coarsens at least once"):
        cli_main(["solve-batched", "41", "40", "--batch", "2",
                  "--preconditioner", "mg", "--device", "cpu"])


def test_cli_mg_checkpointed_solve(tmp_path, capsys):
    import json

    path = str(tmp_path / "ck.npz")
    assert cli_main(["40", "40", "--preconditioner", "mg", "--device", "cpu",
                     "--checkpoint", path, "--chunk", "3", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["iterations"] == 8 and rec["backend"] == "torch"


def test_cli_solve_batched_mg_matches_sequential(capsys):
    import json

    assert cli_main(["solve-batched", "40", "40", "--batch", "3",
                     "--vary-rhs", "--preconditioner", "mg", "--device",
                     "cpu", "--json", "--compare-sequential"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["preconditioner"] == "mg"
    assert rec["iterations_match_sequential"] is True
    want = jax_batched.solve_batched(JaxProblem(M=40, N=40),
                                     rhs_gates=[1.0, 4 / 3, 5 / 3],
                                     dtype="float32", preconditioner="mg")
    assert rec["iterations"] == np.asarray(want.iterations).tolist()


@pytest.mark.parametrize("extra,message", [
    (["--mesh", "2x2"], "drop --mesh"),
    # A valid spec: the CLI parses --geometry first, as the JAX CLI does.
    (["--geometry", '{"type": "ellipse", "rx": 0.7}'], "co-batch"),
], ids=["mesh", "geometry"])
def test_cli_solve_batched_mg_refusals(extra, message):
    with pytest.raises(SystemExit, match=message):
        cli_main(["solve-batched", "40", "40", "--batch", "2",
                  "--preconditioner", "mg", "--device", "cpu", *extra])
