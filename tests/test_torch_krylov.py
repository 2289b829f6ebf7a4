"""Port parity: Krylov memory (``poisson_tpu_torch.krylov``: the policy,
block CG through ``solve_batched(mode="block")``, deflation recycling, and
``manufactured_error(krylov=)``) against ``poisson_tpu.krylov``, on the
CPU.

Tolerances: policy messages, ``clustered_ellipse_stack``, every
``krylov.*`` counter, the bucket keys and the basis width equal JAX's
exactly; the harvest's cold iterate equals the port's own ``pcg_solve`` bit
for bit. Block counts: fp64 per-member counts equal JAX's; fp32 ones within
3 per member and the clustered batch's block total within 2% of JAX's (the
B×B eigendecompositions run in LAPACK in both packages, but the fp32 block
products sum in another order, which moves a first crossing of δ by an
iteration or two). fp64 block iterates within 1e-8 of JAX's. The
manufactured gate: flags, cold counts and basis widths equal JAX's; ``rel``
under JAX's floors (``tests/test_krylov.py``), within 1e-8 of JAX's in
fp64 and within 5% of it in fp32. In fp32 the gate's block is rank 1 (three
rescalings of one forcing), whose noise columns and first crossings follow
the sum order (counts differ by up to 34 of 199, ``rel`` by up to 1.8%,
the worst seen on the CPU), and its warm solve is one step from a Galerkin
start through E⁻¹ with cond up to 1e10, which fp32 rounding moves by up to
3% of ``rel``. Warm fp64 counts equal JAX's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.geometry import Ellipse as JaxEllipse
from poisson_tpu.geometry import Rectangle as JaxRectangle
from poisson_tpu.geometry import manufactured as jax_manufactured
from poisson_tpu.krylov import KrylovPolicy as JaxPolicy
from poisson_tpu.krylov import block as jax_block
from poisson_tpu.krylov import recycle as jax_recycle
from poisson_tpu.krylov import resolve_krylov as jax_resolve
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import batched as jax_batched
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry import manufactured
from poisson_tpu_torch.geometry.dsl import Ellipse, Rectangle
from poisson_tpu_torch.krylov import (
    KRYLOV_BLOCK,
    KRYLOV_INDEPENDENT,
    KrylovPolicy,
    block,
    recycle,
    resolve_krylov,
)
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers import batched
from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(device="cpu")
DEFL, BLK = KrylovPolicy(deflation=True), KrylovPolicy(mode="block")
JDEFL, JBLK = JaxPolicy(deflation=True), JaxPolicy(mode="block")

# JAX's per-family relative-L2 floors for the Krylov modes at 100x150
# fp32 (tests/test_krylov.py:55-64).
FAMILY_FLOORS = {
    "ellipse": 0.038,
    "ellipse-offset": 0.065,
    "rectangle": 0.024,
    "polygon": 0.024,
    "union": 0.059,
    "intersection": 0.023,
    "difference": 0.020,
    "sdf": 0.071,
}
BLOCK_FP32_MEMBER_ALLOWANCE = 3     # iterations, per member
BLOCK_FP32_TOTAL_ALLOWANCE = 0.02   # of JAX's block total
GATE_FP32_REL = 0.05                # manufactured rel vs JAX's, relative


def _reset():
    for reset in (metrics.reset, jax_metrics.reset,
                  batched.reset_bucket_cache, jax_batched.reset_bucket_cache,
                  recycle.reset_krylov_cache,
                  jax_recycle.reset_krylov_cache):
        reset()


@pytest.fixture(autouse=True)
def _fresh():
    """One intra-op thread (several workers share the cores) and clean
    caches and counters in both packages around each test."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    _reset()
    yield
    _reset()
    torch.set_num_threads(saved)


def _krylov_counters() -> dict:
    names = sorted({n for n in list(metrics.snapshot()["counters"])
                    + list(jax_metrics.snapshot()["counters"])
                    if n.startswith("krylov.")})
    return {n: (metrics.get(n), jax_metrics.get(n)) for n in names}


def _same_counters(*prefixes):
    got = _krylov_counters()
    assert got, "no krylov counter moved"
    for name, (mine, theirs) in got.items():
        assert mine == theirs, (name, mine, theirs)
    for prefix in prefixes:
        assert any(n.startswith(prefix) for n in got), prefix


# -- policy ---------------------------------------------------------------


def test_resolve_krylov_defaults_equal_jax():
    assert resolve_krylov(None) == KrylovPolicy(**vars(jax_resolve(None)))
    assert resolve_krylov(None).mode == KRYLOV_INDEPENDENT
    assert not resolve_krylov(None).deflation
    assert (KRYLOV_INDEPENDENT, KRYLOV_BLOCK) == ("independent", "block")


@pytest.mark.parametrize("kwargs", [
    dict(mode="blockish"),
    dict(mode="block", deflation=True),
    dict(deflation=True, harvest=4, keep=8),
    dict(deflation=True, keep=0),
    dict(deflation=True, budget_bytes=0),
], ids=["mode", "block_deflation", "harvest", "keep", "budget"])
def test_resolve_krylov_rejections_are_jax_s(kwargs):
    with pytest.raises(ValueError) as mine:
        resolve_krylov(KrylovPolicy(**kwargs))
    with pytest.raises(ValueError) as theirs:
        jax_resolve(JaxPolicy(**kwargs))
    assert str(mine.value) == str(theirs.value)


# -- block CG -------------------------------------------------------------


def test_clustered_ellipse_stack_is_jax_s_bit_for_bit():
    mine = block.clustered_ellipse_stack(Problem(160, 240), 8)
    theirs = jax_block.clustered_ellipse_stack(JaxProblem(160, 240), 8)
    for got, want in zip(mine, theirs):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_rank_deficient_batch_degrades_as_jax_s(dtype):
    """Pure rescalings, an exactly rank-1 block: every member converges at
    about the single-solve rate with the deficiency detected."""
    gates = [1.0, 1.4, 0.7]
    solo = int(pcg_solve(Problem(60, 60), dtype=dtype, **CPU).iterations)
    r = batched.solve_batched(Problem(60, 60), rhs_gates=gates, dtype=dtype,
                              mode="block", **CPU)
    j = jax_batched.solve_batched(JaxProblem(60, 60), rhs_gates=gates,
                                  dtype=dtype, mode="block")
    assert (r.flag.numpy() == FLAG_CONVERGED).all()
    assert bool(r.deficient) and bool(np.asarray(j.deficient))
    assert int(r.max_iterations) <= solo + 5
    got, want = r.iterations.tolist(), np.asarray(j.iterations).tolist()
    if dtype == "float64":
        assert got == want
        np.testing.assert_allclose(r.w.numpy(), np.asarray(j.w), rtol=0,
                                   atol=1e-8)
    else:
        assert all(abs(g - w) <= BLOCK_FP32_MEMBER_ALLOWANCE
                   for g, w in zip(got, want)), (got, want)
    assert r.origin == (0, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_block_cuts_total_iterations_on_clustered_batch(dtype):
    """JAX's headline lever at test scale: ≥ 15% fewer total iterations
    than the independent batch, each member at the same L2 floor against
    its exact solution; the block total is JAX's within the allowance."""
    p, B = Problem(160, 240), 8
    fs, us, inside = block.clustered_ellipse_stack(p, B)
    ri = batched.solve_batched(p, rhs_stack=fs, dtype=dtype, **CPU)
    rb = batched.solve_batched(p, rhs_stack=fs, dtype=dtype, mode="block",
                               **CPU)
    jb = jax_batched.solve_batched(JaxProblem(160, 240), rhs_stack=fs,
                                   dtype=dtype, mode="block")
    assert (rb.flag.numpy() == FLAG_CONVERGED).all()
    indep_total = int(ri.iterations.sum())
    block_total = B * int(rb.max_iterations)
    assert 1.0 - block_total / indep_total >= 0.15, (indep_total,
                                                     block_total)
    l2_i = block.block_l2_errors(p, ri, us, inside)
    l2_b = block.block_l2_errors(p, rb, us, inside)
    assert max(l2_b) <= 1.2 * max(l2_i) + 1e-12
    jax_total = B * int(np.asarray(jb.max_iterations))
    if dtype == "float64":
        assert rb.iterations.tolist() == np.asarray(jb.iterations).tolist()
        np.testing.assert_allclose(rb.w.numpy(), np.asarray(jb.w), rtol=0,
                                   atol=1e-8)
    else:
        assert abs(block_total - jax_total) <= (BLOCK_FP32_TOTAL_ALLOWANCE
                                                * jax_total)
    assert metrics.get("krylov.block.solves") == B


def test_mode_independent_is_the_historical_call():
    p = Problem(40, 40)
    a = batched.solve_batched(p, rhs_gates=[1.0, 1.3], **CPU)
    b = batched.solve_batched(p, rhs_gates=[1.0, 1.3], mode="independent",
                              **CPU)
    assert torch.equal(a.w, b.w)
    assert a.iterations.tolist() == b.iterations.tolist()
    assert a.deficient is None and b.deficient is None
    assert pcg_solve(p, **CPU).deficient is None


@pytest.mark.parametrize("kwargs", [
    dict(mode="blk"),
    dict(mode="block", mesh=object()),
    dict(mode="block", verify_every=5),
    dict(mode="block", preconditioner="mg"),
    dict(mode="block", bucket=8),
    dict(mode="block", geometries="mixed"),
], ids=["mode", "mesh", "verify", "mg", "bucket", "geometries"])
def test_block_refusals_are_jax_s(kwargs):
    if kwargs.get("geometries") == "mixed":
        mine = dict(kwargs, geometries=[Ellipse(0.1, 0.0, 0.5, 0.3),
                                        Rectangle(-0.5, -0.3, 0.5, 0.3)])
        theirs = dict(kwargs,
                      geometries=[JaxEllipse(0.1, 0.0, 0.5, 0.3),
                                  JaxRectangle(-0.5, -0.3, 0.5, 0.3)])
    else:
        mine = theirs = kwargs
    with pytest.raises(ValueError) as got:
        batched.solve_batched(Problem(40, 40), rhs_gates=[1.0, 1.1],
                              **mine, **({} if "mesh" in mine else CPU))
    with pytest.raises(ValueError) as want:
        jax_batched.solve_batched(JaxProblem(40, 40), rhs_gates=[1.0, 1.1],
                                  **theirs)
    assert str(got.value) == str(want.value)


def test_block_shared_geometry_and_bucket_key_family():
    """A fingerprint-uniform geometry block runs on the shared canvases,
    and block dispatches are their own family of bucket keys: the
    counters move as JAX's do on the same calls."""
    calls = [dict(), dict(mode="block", geo=True),
             dict(mode="block", geo=True), dict(mode="block")]
    for kw in calls:
        geo = kw.pop("geo", False)
        r = batched.solve_batched(
            Problem(40, 40), rhs_gates=[1.0, 1.2], dtype="float32",
            geometries=[Ellipse(0.1, 0.0, 0.5, 0.3)] * 2 if geo else None,
            **kw, **CPU)
        jax_batched.solve_batched(
            JaxProblem(40, 40), rhs_gates=[1.0, 1.2], dtype="float32",
            geometries=[JaxEllipse(0.1, 0.0, 0.5, 0.3)] * 2 if geo
            else None, **kw)
        assert (r.flag.numpy() == FLAG_CONVERGED).all()
    for name in ("batched.bucket_cache.misses", "batched.bucket_cache.hits",
                 "batched.solves", "krylov.block.solves"):
        assert metrics.get(name) == jax_metrics.get(name), name
    assert metrics.get("batched.bucket_cache.misses") == 3
    assert metrics.get("krylov.block.solves") == 6


# -- the manufactured gate -----------------------------------------------


@pytest.mark.parametrize("name", sorted(FAMILY_FLOORS))
def test_block_gate_per_family_is_jax_s(name):
    got = manufactured.manufactured_error(manufactured.case_by_name(name),
                                          100, 150, dtype="float32",
                                          krylov=BLK, **CPU)
    want = jax_manufactured.manufactured_error(
        jax_manufactured.case_by_name(name), 100, 150, dtype="float32",
        krylov=JBLK)
    assert set(got) == set(want)
    assert got["flags"] == want["flags"] == [1, 1, 1], (got, want)
    assert got["rel"] <= FAMILY_FLOORS[name]
    assert abs(got["rel"] - want["rel"]) <= GATE_FP32_REL * want["rel"], (
        got, want)
    assert got["deficient"] == want["deficient"]


@pytest.mark.parametrize("name", sorted(FAMILY_FLOORS))
def test_deflation_gate_per_family_is_jax_s(name):
    got = manufactured.manufactured_error(manufactured.case_by_name(name),
                                          100, 150, dtype="float32",
                                          krylov=DEFL, **CPU)
    want = jax_manufactured.manufactured_error(
        jax_manufactured.case_by_name(name), 100, 150, dtype="float32",
        krylov=JDEFL)
    assert set(got) == set(want)
    assert got["flag"] == want["flag"] == 1
    assert got["rel"] <= FAMILY_FLOORS[name]
    assert abs(got["rel"] - want["rel"]) <= GATE_FP32_REL * want["rel"], (
        got, want)
    assert got["iterations"] < got["cold_iterations"]
    assert got["cold_iterations"] == want["cold_iterations"]
    assert got["basis_vectors"] == want["basis_vectors"]


@pytest.mark.parametrize("name", ["ellipse", "polygon"])
@pytest.mark.parametrize("mode", ["block", "deflation"])
def test_krylov_gate_fp64_is_jax_s(name, mode):
    mine, theirs = (BLK, JBLK) if mode == "block" else (DEFL, JDEFL)
    got = manufactured.manufactured_error(manufactured.case_by_name(name),
                                          100, 150, dtype="float64",
                                          krylov=mine, **CPU)
    want = jax_manufactured.manufactured_error(
        jax_manufactured.case_by_name(name), 100, 150, dtype="float64",
        krylov=theirs)
    assert abs(got["rel"] - want["rel"]) <= 1e-8, (got, want)
    assert got["iterations"] == want["iterations"]


# -- deflation recycling ---------------------------------------------------


def _both(args, policy=DEFL, ellipse=None, **kw):
    """The same recycled solve in both packages (``ellipse``: the fields
    of an ``Ellipse`` geometry)."""
    mine, theirs = dict(kw), dict(kw)
    if ellipse is not None:
        mine["geometry"] = Ellipse(*ellipse)
        theirs["geometry"] = JaxEllipse(*ellipse)
    got = recycle.solve_recycled(Problem(*args), policy=policy, **mine,
                                 **CPU)
    want = jax_recycle.solve_recycled(JaxProblem(*args),
                                      policy=JaxPolicy(**vars(policy)),
                                      **theirs)
    return got, want


def test_recycle_warm_beats_cold_and_counts_as_jax():
    cold, _ = _both((60, 60), dtype="float32")
    warm, _ = _both((60, 60), dtype="float32", rhs_gate=1.5)
    assert int(cold.flag) == int(warm.flag) == FLAG_CONVERGED
    assert int(warm.iterations) < int(cold.iterations)
    assert metrics.get("krylov.cache.misses") == 1
    assert metrics.get("krylov.cache.hits") == 1
    assert metrics.get("krylov.iterations_saved") >= 1
    _same_counters("krylov.harvests", "krylov.warm_solves")


def test_recycle_dtype_change_misses():
    p = Problem(40, 40)
    recycle.solve_recycled(p, dtype="float32", policy=DEFL, **CPU)
    assert recycle.has_basis(p, dtype="float32", policy=DEFL, **CPU)
    assert not recycle.has_basis(p, dtype="float64", policy=DEFL, **CPU)
    recycle.solve_recycled(p, dtype="float64", policy=DEFL, **CPU)
    assert metrics.get("krylov.cache.misses") == 2
    assert metrics.get("krylov.cache.hits") == 0


def test_recycle_eviction_respects_byte_budget():
    tiny = KrylovPolicy(deflation=True, harvest=16, keep=4, budget_bytes=1)
    _both((40, 40), dtype="float32", policy=tiny)
    _both((40, 40), dtype="float32", policy=tiny,
          ellipse=(0.1, 0.0, 0.5, 0.3))
    assert metrics.get("krylov.cache.evictions") >= 1
    assert recycle.cache_stats()["entries"] == 1
    assert recycle.cache_stats() == jax_recycle.cache_stats()
    _same_counters("krylov.cache.evictions")


def test_recycle_poisoned_basis_falls_back_never_wrong():
    cold, _ = _both((60, 60), dtype="float32")
    assert recycle.poison_basis() == 1 == jax_recycle.poison_basis()
    again, _ = _both((60, 60), dtype="float32", rhs_gate=0.8)
    assert int(again.flag) == FLAG_CONVERGED
    assert torch.isfinite(again.w).all()
    assert metrics.get("krylov.fallbacks") == 1
    assert metrics.get("krylov.cache.invalidations") == 1
    warm, _ = _both((60, 60), dtype="float32", rhs_gate=1.2)
    assert int(warm.iterations) < int(cold.iterations)
    _same_counters("krylov.fallbacks", "krylov.cache.invalidations")


def test_recycle_invalidate_selectors():
    p = Problem(40, 40)
    g = Ellipse(cx=0.1, cy=0.0, rx=0.5, ry=0.3)
    recycle.solve_recycled(p, dtype="float32", policy=DEFL,
                           hw=("torch", "cpu", 0), **CPU)
    recycle.solve_recycled(p, dtype="float32", policy=DEFL, geometry=g,
                           hw=("torch", "cpu", 1), **CPU)
    assert recycle.cache_stats()["entries"] == 2
    assert recycle.invalidate(hw=("torch", "cpu", 1), reason="test") == 1
    assert recycle.has_basis(p, dtype="float32", policy=DEFL, **CPU)
    assert not recycle.has_basis(p, dtype="float32", policy=DEFL,
                                 geometry=g, **CPU)
    assert recycle.invalidate(fingerprint="default", reason="test") == 1
    assert recycle.cache_stats()["entries"] == 0
    assert metrics.get("krylov.cache.invalidations") == 2
    recycle.solve_recycled(p, dtype="float32", policy=DEFL, **CPU)
    assert recycle.invalidate(all_entries=True, reason="recovery") == 1


def test_recycle_unconverged_solve_never_caches():
    r, j = _both((60, 60, 5), dtype="float32")   # max_iter 5
    assert int(r.flag) != FLAG_CONVERGED and int(j.flag) != FLAG_CONVERGED
    assert metrics.get("krylov.harvests") == 0
    assert recycle.cache_stats()["entries"] == 0
    _same_counters("krylov.cache.misses")


def test_recycle_validation_is_jax_s():
    p, jp = Problem(40, 40), JaxProblem(40, 40)
    for kwargs in (dict(policy=KrylovPolicy()),
                   dict(policy=DEFL, preconditioner="mg")):
        with pytest.raises(ValueError) as got:
            recycle.solve_recycled(p, **kwargs, **CPU)
        jkw = dict(kwargs, policy=JaxPolicy(**vars(kwargs["policy"])))
        with pytest.raises(ValueError) as want:
            jax_recycle.solve_recycled(jp, **jkw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="jacobi"):
        manufactured.manufactured_error(manufactured.case_by_name("ellipse"),
                                        40, 60, krylov=DEFL,
                                        preconditioner="mg", **CPU)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_harvest_cold_iterate_is_pcg_solve_bit_for_bit(dtype):
    """The ring write adds no arithmetic to the body: the harvesting cold
    solve is the port's ``pcg_solve`` bit for bit, count and flag."""
    p = Problem(60, 60)
    got = recycle.solve_recycled(p, dtype=dtype, policy=DEFL, **CPU)
    want = pcg_solve(p, dtype=dtype, **CPU)
    assert torch.equal(got.w, want.w)
    assert int(got.iterations) == int(want.iterations)
    assert int(got.flag) == int(want.flag) == FLAG_CONVERGED


@pytest.mark.parametrize("gate", [1.5, 0.8])
def test_recycle_fp64_warm_counts_and_basis_width_are_jax_s(gate):
    cold, jcold = _both((60, 60), dtype="float64")
    warm, jwarm = _both((60, 60), dtype="float64", rhs_gate=gate)
    assert int(cold.iterations) == int(jcold.iterations)
    assert int(warm.iterations) == int(jwarm.iterations)
    (entry,) = recycle._CACHE.values()
    (jentry,) = jax_recycle._CACHE.values()
    assert entry.W.shape[0] == jentry.W.shape[0]
    np.testing.assert_allclose(warm.w.numpy(), np.asarray(jwarm.w), rtol=0,
                               atol=1e-10)
    _same_counters("krylov.warm_solves")


def test_recycle_warm_on_a_geometry_and_gated_rhs():
    fields = (0.1, 0.0, 0.5, 0.3)
    _both((60, 60), dtype="float64", ellipse=fields)
    warm, jwarm = _both((60, 60), dtype="float64", ellipse=fields,
                        rhs_gate=2.0)
    assert int(warm.iterations) == int(jwarm.iterations)
    assert recycle.has_basis(Problem(60, 60), dtype="float64",
                             geometry=Ellipse(*fields), **CPU)
    _same_counters("krylov.cache.hits")


# -- the card's goldens -----------------------------------------------------


@pytest.mark.slow
def test_chip_smoke_krylov_goldens_are_jax_s():
    """The JAX values ``chip_smoke.py``'s Krylov phase holds the card to,
    recomputed from the JAX package on the CPU (minutes: the 800x1200 block
    batch)."""
    import warnings

    from poisson_tpu.krylov.block import clustered_ellipse_stack
    from poisson_tpu.solvers import resilient as jax_resilient
    from poisson_tpu.solvers import session as jax_session
    from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    M, N = cs.KRY_RECYCLE64
    cold = jax_recycle.solve_recycled(JaxProblem(M, N), dtype="float64")
    warm = jax_recycle.solve_recycled(JaxProblem(M, N), dtype="float64",
                                      rhs_gate=cs.KRY_WARM_GATE)
    assert (int(cold.iterations),
            int(warm.iterations)) == cs.KRY_RECYCLE64_JAX
    heat = JaxProblem(*cs.KRY_HEAT)
    steady = np.asarray(jax_pcg(heat, geometry=JaxEllipse()).w)
    u, counts, errs = None, [], []
    for _ in range(cs.KRY_HEAT_STEPS):
        r, _ = jax_session.session_step_solve(
            heat, geometry=JaxEllipse(), mass_shift=1.0, rhs_gate=1.0,
            warm=u, warm_geometry=None if u is None else JaxEllipse(),
            u_prev=u)
        u = np.asarray(r.w)
        counts.append(int(r.iterations))
        errs.append(float(np.linalg.norm(u - steady)))
    assert tuple(counts) == cs.KRY_HEAT_JAX_ITERATIONS
    assert tuple(errs) == cs.KRY_HEAT_JAX_ERRORS
    M, N = cs.KRY_DESIGN
    tgt = np.asarray(jax_pcg(JaxProblem(M, N), dtype="float64").w)
    new, loss, grads = jax_session.design_step(
        JaxProblem(M, N), dict(cs.KRY_DESIGN_PARAMS), tgt, cs.KRY_DESIGN_LR,
        dtype="float64")
    assert new == cs.KRY_DESIGN_JAX_PARAMS and loss == cs.KRY_DESIGN_JAX_LOSS
    M, N = cs.KRY_BF16
    b = jax_pcg(JaxProblem(M, N), dtype="bfloat16")
    assert int(b.iterations) == cs.KRY_BF16_JAX_ITERATIONS
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        rr = jax_resilient.pcg_solve_resilient(JaxProblem(M, N),
                                               dtype="bfloat16")
    assert [list(h) for h in rr.recovery_history] == [
        list(h) for h in cs.KRY_BF16_JAX_HISTORY]
    flagship = JaxProblem(*cs.KRY_FLAGSHIP)
    cold, _ = jax_session.session_step_solve(flagship, dtype="float32",
                                             geometry=JaxEllipse())
    _, info = jax_session.session_step_solve(
        flagship, dtype="float32", geometry=JaxEllipse(cx=5e-4),
        warm=np.asarray(cold.w), warm_geometry=JaxEllipse())
    assert info == {"warm_used": False, "fallback": "residual"}
    cold64, _ = jax_session.session_step_solve(flagship, dtype="float64",
                                               geometry=JaxEllipse())
    warm, info = jax_session.session_step_solve(
        flagship, dtype="float64", geometry=JaxEllipse(),
        warm=np.asarray(cold64.w), warm_geometry=JaxEllipse(),
        rhs_gate=cs.KRY_SESSION_GATE)
    ref = jax_pcg(flagship, dtype="float64", geometry=JaxEllipse(),
                  rhs_gate=cs.KRY_SESSION_GATE)
    gap = float(np.abs(np.asarray(warm.w, np.float64)
                       - np.asarray(ref.w, np.float64)).max())
    assert info["warm_used"]
    assert (int(warm.iterations), gap) == cs.KRY_SESSION_JAX
    fs, _, _ = clustered_ellipse_stack(flagship, cs.KRY_BLOCK_B)
    rb = jax_batched.solve_batched(flagship, rhs_stack=fs, dtype="float32",
                                   mode="block")
    assert int(np.asarray(rb.max_iterations)) == cs.KRY_BLOCK_JAX_MAX
    rd = jax_batched.solve_batched(flagship,
                                   rhs_gates=list(cs.KRY_DEFICIENT_GATES),
                                   dtype="float32", mode="block")
    assert int(np.asarray(rd.max_iterations)) == cs.KRY_DEFICIENT_JAX_MAX
    assert bool(np.asarray(rd.deficient))
