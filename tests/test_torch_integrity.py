"""Port parity: the integrity layer (``poisson_tpu_torch.integrity``, the
bitflip injectors of ``poisson_tpu_torch.testing.faults`` and the probe in
the PCG body) against ``poisson_tpu.integrity`` and
``poisson_tpu.testing.faults``, on the CPU, on the JAX tests' problems
(48×72 for integrity, 32×32 for batches and lanes).

Tolerances: the injectors are numpy code in both packages, so the flipped
values and the chosen element are equal bit for bit; the probe's norms on
one seeded fp64 state agree to 1e-12 relative with the same booleans; a
clean verified solve equals the port's unverified solve bit for bit
(count, flag, iterate); with the probe and the stream off, one body call
dispatches the parent body's exact op sequence.
"""

import types
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.integrity import probe as jax_probe
from poisson_tpu.solvers import pcg as jax_pcg
from poisson_tpu.testing import faults as jax_faults
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.integrity import probe
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers import pcg
from poisson_tpu_torch.solvers.batched import solve_batched
from poisson_tpu_torch.solvers.lanes import LaneBatch
from poisson_tpu_torch.solvers.resilient import pcg_solve_resilient
from poisson_tpu_torch.testing import faults

PROBLEM = Problem(M=48, N=72)
SEED = 20260917


@pytest.fixture(autouse=True)
def _fresh():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    metrics.reset()
    torch.set_num_threads(saved)


def _setup(problem=PROBLEM, dtype="float64", members=False):
    return pcg.solve_setup(problem, dtype, None, "cpu", members=members)


def _run(setup, problem, n):
    body = pcg.make_pcg_body(setup.ops, delta=problem.delta,
                             weighted_norm=problem.weighted_norm,
                             h1=problem.h1, h2=problem.h2)
    s = pcg.init_state(setup.ops, setup.rhs)
    for _ in range(n):
        s = body(s)
    return s


def _jax_state(state):
    return jax_pcg.PCGState(*(jnp.asarray(t.numpy()) for t in state))


def _bits(x):
    a = np.asarray(x)
    return a.view({4: np.uint32, 8: np.uint64}[a.dtype.itemsize])


# -- the injectors (numpy-exact) -----------------------------------------


@pytest.mark.parametrize("value", [1.0, -3.7e-5, 2.2e-11, 0.125, 6.0e4])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bitflip_element_equals_jax(value, dtype):
    """Every form — the exponent class, the mantissa class and an explicit
    bit — flips the same bit as the JAX package's injector."""
    v = dtype(value)
    mant, exp_bit = (22, 23) if dtype is np.float32 else (51, 52)
    forms = [dict(bit_class="exponent"), dict(bit_class="mantissa"),
             dict(bit=exp_bit), dict(bit=mant)]
    for kw in forms:
        got = faults.bitflip_element(v, **kw)
        want = jax_faults.bitflip_element(v, **kw)
        assert _bits(got) == _bits(want), (value, kw)
        assert np.isfinite(got) and got != v
    for bad in (dict(bit_class="nope"),):
        with pytest.raises(ValueError):
            faults.bitflip_element(v, **bad)
    with pytest.raises(ValueError):
        faults.bitflip_element(np.float16(1.0))


@pytest.mark.parametrize("buffer", ["w", "r", "p", "z", "Ap"])
@pytest.mark.parametrize("bit_class", ["exponent", "mantissa"])
def test_inject_bitflip_picks_jax_s_element(buffer, bit_class):
    """On the same numpy state the seeded injector corrupts the same
    element by the same bit as the JAX package's, for two seeds, and
    touches nothing else."""
    s = _run(_setup(), PROBLEM, 20)
    js = _jax_state(s)
    field = faults._BITFLIP_BUFFERS[buffer]
    for seed in (0, 3):
        got = faults.inject_bitflip(s, buffer, bit_class=bit_class,
                                    seed=seed)
        want = jax_faults.inject_bitflip(js, buffer, bit_class=bit_class,
                                         seed=seed)
        g = getattr(got, field)
        assert isinstance(g, torch.Tensor) and g.device == s.w.device
        assert np.array_equal(_bits(g.numpy()),
                              _bits(np.asarray(getattr(want, field))))
        assert np.count_nonzero(g.numpy() != getattr(s, field).numpy()) == 1
        for other in ("w", "r", "p", "z"):
            if other != field:
                assert torch.equal(getattr(got, other), getattr(s, other))


def test_inject_bitflip_member_and_element_forms_equal_jax():
    """``member=`` corrupts one member of a stacked state only; a pinned
    ``element`` is honoured; both as in the JAX package."""
    State = types.SimpleNamespace
    w = np.outer(np.arange(3.0) + 1.0, np.ones(36)).reshape(3, 6, 6)

    def make(arr):
        state = State(w=arr.copy())
        state._replace = lambda **kw: State(**{**vars(state), **kw})
        return state

    got = faults.inject_bitflip(make(w), "w", member=1, seed=0)
    want = jax_faults.inject_bitflip(make(w), "w", member=1, seed=0)
    assert np.array_equal(np.asarray(got.w), np.asarray(want.w))
    delta = np.asarray(got.w) - w
    assert np.count_nonzero(delta[1]) == 1
    assert not delta[0].any() and not delta[2].any()
    s = _run(_setup(), PROBLEM, 12)
    got = faults.inject_bitflip(s, "r", element=(7, 9))
    want = jax_faults.inject_bitflip(_jax_state(s), "r", element=(7, 9))
    assert np.array_equal(got.r.numpy(), np.asarray(want.r))
    assert got.r[7, 9] != s.r[7, 9]


@pytest.mark.parametrize("spec", ["100", "50:r", "50:Ap:29", "7::", "7:z:",
                                  "x", "10:q", "10:w:z", "1:2:3:4"])
def test_parse_bitflip_spec_equals_jax(spec):
    try:
        want = jax_faults.parse_bitflip_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            faults.parse_bitflip_spec(spec)
        assert str(got.value) == str(e)
    else:
        assert faults.parse_bitflip_spec(spec) == want


def test_nan_and_corrupt_file_equal_jax(tmp_path):
    s = _run(_setup(), PROBLEM, 5)
    for buffer in ("r", "w", "p", "z"):
        got = faults.inject_nan(s, buffer)
        want = jax_faults.inject_nan(_jax_state(s), buffer)
        assert np.array_equal(getattr(got, buffer).numpy(),
                              np.asarray(getattr(want, buffer)),
                              equal_nan=True)
    for mode in ("flip", "truncate", "zero"):
        a, b = tmp_path / f"a{mode}", tmp_path / f"b{mode}"
        payload = bytes(range(256)) * 8
        a.write_bytes(payload)
        b.write_bytes(payload)
        faults.corrupt_file(str(a), mode)
        jax_faults.corrupt_file(str(b), mode)
        assert a.read_bytes() == b.read_bytes() != payload


# -- the invariants (probe) ----------------------------------------------


def _seeded(setup):
    """A seeded fp64 state: random w and a residual near b − Aw."""
    rng = np.random.default_rng(SEED)
    shape = PROBLEM.grid_shape
    w = np.zeros(shape)
    w[1:-1, 1:-1] = rng.standard_normal((shape[0] - 2, shape[1] - 2)) * 0.01
    w_t = torch.from_numpy(w)
    r = (setup.rhs - setup.ops.apply_A(w_t)).numpy()
    r[1:-1, 1:-1] += rng.standard_normal(r[1:-1, 1:-1].shape) * 1e-9
    return w, r


def test_probe_values_and_verdicts_equal_jax():
    setup = _setup()
    a, b, rhs, aux = jax_pcg.host_setup(JaxProblem(M=48, N=72), "float64",
                                        False)
    jops = jax_pcg.single_device_ops(JaxProblem(M=48, N=72), a, b, aux)
    w, r = _seeded(setup)
    wt, rt = torch.from_numpy(w), torch.from_numpy(r)
    got = probe.residual_drift(setup.ops, wt, rt, setup.rhs)
    want = jax_probe.residual_drift(jops, jnp.asarray(w), jnp.asarray(r),
                                    rhs)
    for g, x in zip(got, want):
        np.testing.assert_allclose(float(g), float(x), rtol=1e-12)
    drift_rel = float(np.sqrt(float(got[0]) / float(got[1])))
    for tol in (drift_rel * 0.5, drift_rel * 2.0, 1e-6, 1e-3):
        assert bool(probe.drift_exceeds(setup.ops, wt, rt, setup.rhs,
                                        tol)) == bool(
            jax_probe.drift_exceeds(jops, jnp.asarray(w), jnp.asarray(r),
                                    rhs, tol))
        gc, gd = probe.recheck_state(setup.ops, wt, rt, setup.rhs, tol)
        jc, jd = jax_probe.recheck_state(jops, jnp.asarray(w),
                                         jnp.asarray(r), rhs, tol)
        assert gc == jc
        np.testing.assert_allclose(gd, jd, rtol=1e-12)
    colsum = probe.abft_colsum(setup.ops, setup.rhs)
    jcolsum = jax_probe.abft_colsum(jops, rhs)
    np.testing.assert_allclose(colsum.numpy(), np.asarray(jcolsum),
                               rtol=1e-12, atol=1e-12 * float(
                                   np.abs(np.asarray(jcolsum)).max()))
    p = wt * 3.0 + 0.5 * rt
    Ap = setup.ops.apply_A(p)
    bad = Ap.clone()
    bad[7, 9] += 1e-3 * float(Ap.abs().max()) + 1e-6
    for ap, expect in ((Ap, False), (bad, True)):
        got_v = bool(probe.abft_drift_exceeds(colsum, p, ap, 1e-9))
        want_v = bool(jax_probe.abft_drift_exceeds(
            jcolsum, jnp.asarray(p.numpy()), jnp.asarray(ap.numpy()), 1e-9))
        assert got_v == want_v == expect


def test_nonfinite_drift_is_a_verdict():
    setup = _setup()
    s = _run(setup, PROBLEM, 10)
    blown = torch.full_like(s.w, float("inf"))
    assert bool(probe.drift_exceeds(setup.ops, blown, s.r, setup.rhs, 1e-6))
    assert probe.recheck_state(setup.ops, blown, s.r, setup.rhs, 1e-6)[0]


def test_defaults_equal_jax():
    for name in ("float64", "float32", "bfloat16", "float16"):
        assert probe.default_verify_tol(name) == \
            jax_probe.default_verify_tol(name)
    assert probe.default_verify_tol(torch.float32) == 2e-5
    for pre in ("jacobi", "mg"):
        assert probe.default_verify_jump(pre) == \
            jax_probe.default_verify_jump(pre)
        assert probe.default_verify_collapse(pre) == \
            jax_probe.default_verify_collapse(pre)
    assert probe.DEFAULT_VERIFY_COLLAPSE_MG > 28.6 > \
        probe.DEFAULT_VERIFY_COLLAPSE
    for dtype in ("float32", "float64"):
        assert pcg.resolve_verify_tol(None, dtype) == \
            jax_pcg.resolve_verify_tol(None, dtype)
        assert pcg.resolve_verify_tol(3e-4, dtype) == 3e-4
    assert pcg.FLAG_INTEGRITY == jax_pcg.FLAG_INTEGRITY
    assert pcg.FLAG_NAMES == jax_pcg.FLAG_NAMES


# -- clean goldens verified, bit for bit ---------------------------------


@pytest.mark.parametrize(
    "M,N,weighted,expected",
    [(10, 10, False, 17), (20, 20, False, 31), (40, 40, True, 50)])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_clean_goldens_verified_bit_for_bit(M, N, weighted, expected, dtype):
    p = Problem(M=M, N=N, weighted_norm=weighted)
    plain = pcg.pcg_solve(p, dtype=dtype, device="cpu")
    ver = pcg.pcg_solve(p, dtype=dtype, device="cpu", verify_every=5)
    assert int(ver.flag) == pcg.FLAG_CONVERGED
    assert int(ver.iterations) == int(plain.iterations) == expected
    assert torch.equal(ver.w, plain.w) and torch.equal(ver.diff, plain.diff)
    abft = pcg.pcg_solve(p, dtype=dtype, device="cpu", verify_every=5,
                         verify_abft=True)
    assert torch.equal(abft.w, plain.w)


# -- off means off: the parent body's ops --------------------------------


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _parent_body(ops, *, delta, weighted_norm, h1, h2, stagnation_window=0):
    """The iteration body of the parent commit, copied verbatim."""
    from poisson_tpu_torch.solvers.pcg import (
        _DENOM_TOL,
        FLAG_BREAKDOWN,
        FLAG_CONVERGED,
        FLAG_NONE,
        FLAG_NONFINITE,
        FLAG_STAGNATED,
        PCGState,
        _select,
    )

    def body(s: PCGState) -> PCGState:
        p = ops.exchange(s.p)
        Ap = ops.apply_A(p)
        denom = ops.dot(Ap, p)
        degenerate = denom.abs() < _DENOM_TOL
        alpha = s.zr / torch.where(degenerate, 1.0, denom)

        dw = alpha * p
        w_new = s.w + dw
        r_new = s.r - alpha * Ap
        sq = ops.sqnorm(dw)
        diff = torch.sqrt(sq * (h1 * h2)) if weighted_norm else torch.sqrt(sq)

        z_new = ops.apply_Dinv(r_new)
        zr_new = ops.dot(z_new, r_new)
        converged = diff < delta
        beta = zr_new / torch.where(s.zr == 0.0, 1.0, s.zr)
        p_new = z_new + beta * p

        nonfinite = ~(torch.isfinite(diff) & torch.isfinite(zr_new))
        improved = diff < s.best
        best_new = torch.minimum(s.best, diff)
        stall_new = torch.where(improved, 0, s.stall + 1).to(torch.int32)
        if stagnation_window > 0:
            stagnated = (~converged) & (stall_new >= stagnation_window)
        else:
            stagnated = torch.zeros_like(converged)
        flag = torch.where(
            nonfinite, FLAG_NONFINITE,
            torch.where(converged, FLAG_CONVERGED,
                        torch.where(stagnated, FLAG_STAGNATED, FLAG_NONE)),
        ).to(torch.int32)
        stop = degenerate | converged | nonfinite | stagnated

        k = s.k + (~s.done).to(torch.int32)
        done = s.done | stop
        flag = torch.where(
            s.done, s.flag,
            torch.where(degenerate, FLAG_BREAKDOWN, flag).to(torch.int32))
        candidate = PCGState(
            k=k, done=done, w=w_new, r=r_new, z=z_new, p=p_new,
            zr=zr_new, diff=diff, flag=flag, best=best_new, stall=stall_new,
        )
        kept = s._replace(k=k, done=done, flag=flag)
        return _select(s.done | degenerate, kept, candidate)

    return body


@pytest.mark.parametrize("case", ["float32", "float64", "members", "mg",
                                  "stagnation"])
def test_off_means_off_same_ops_as_the_parent(case):
    """With ``verify_every=0`` and ``stream_every=0`` one body call
    dispatches exactly the parent body's ops, in its order, with equal
    results (fp32 scaled, fp64 unscaled, a batched bundle, MG, and with
    the stagnation window armed)."""
    p = Problem(M=40, N=40)
    if case == "mg":
        from poisson_tpu_torch.mg.preconditioner import mg_solve_setup

        setup = mg_solve_setup(p, "float32", None, "cpu")
        rhs = setup.rhs
    elif case == "members":
        setup = _setup(p, "float32", members=True)
        rhs = torch.stack([setup.rhs, setup.rhs * 1.5])
    else:
        setup = _setup(p, "float32" if case != "float64" else "float64")
        rhs = setup.rhs
    window = 3 if case == "stagnation" else 0
    kw = dict(delta=p.delta, weighted_norm=p.weighted_norm, h1=p.h1,
              h2=p.h2, stagnation_window=window)
    s = pcg.init_state(setup.ops, rhs)
    for _ in range(3):
        s = pcg.make_pcg_body(setup.ops, **kw)(s)
    runs = []
    for body in (_parent_body(setup.ops, **kw),
                 pcg.make_pcg_body(setup.ops, verify_every=0,
                                   stream_every=0, **kw)):
        with _Ops() as seen:
            out = body(s)
        runs.append((seen.ops, out))
    assert runs[0][0] == runs[1][0]
    assert len(runs[0][0]) > 50
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)


# -- the campaign: seeded flips across buffers, iterations, dtypes -------

# The JAX package's campaign (tests/test_integrity.py:202-233): the fp32
# search-direction rows start at 25 (earlier flips are bounded harm).
_CAMPAIGN = {
    "float32": {"w": (10, 40), "r": (10, 40), "p": (25, 40),
                "Ap": (10, 40)},
    "float64": {"w": (10, 40), "r": (10, 40), "p": (10, 40),
                "Ap": (10, 40)},
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_seeded_bitflip_campaign_detects_and_recovers(dtype):
    for buffer, ats in _CAMPAIGN[dtype].items():
        for at in ats:
            for seed in (0, 1):
                metrics.reset()
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", RuntimeWarning)
                    res = pcg_solve_resilient(
                        PROBLEM, dtype=dtype, chunk=5, verify_every=5,
                        device="cpu",
                        on_chunk=faults.bitflip_per_solve_hook(
                            at, buffer=buffer, seed=seed))
                tag = (dtype, buffer, at, seed)
                assert metrics.get("integrity.detections") >= 1, tag
                assert metrics.get("integrity.verified_restarts") >= 1, tag
                assert metrics.get("integrity.false_alarms") == 0, tag
                assert metrics.get("resilient.escalations") == 0, tag
                assert int(res.flag) == pcg.FLAG_CONVERGED, tag
                assert res.restarts >= 1, tag


def test_early_f32_direction_flip_is_bounded_harm():
    golden = pcg_solve_resilient(PROBLEM, dtype="float32", chunk=5,
                                 device="cpu")
    for seed in (0, 1):
        metrics.reset()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res = pcg_solve_resilient(
                PROBLEM, dtype="float32", chunk=5, verify_every=5,
                device="cpu", on_chunk=faults.bitflip_per_solve_hook(
                    10, buffer="p", seed=seed))
        assert int(res.flag) == pcg.FLAG_CONVERGED
        assert metrics.get("integrity.false_alarms") == 0
        err = float((res.w - golden.w).abs().max())
        assert err < 1e-3 * float(golden.w.abs().max()), (seed, err)


def test_mantissa_flip_never_false_alarms_the_recovery():
    for buffer in ("w", "r"):
        metrics.reset()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            res = pcg_solve_resilient(
                PROBLEM, dtype="float64", chunk=5, verify_every=5,
                device="cpu", on_chunk=faults.bitflip_per_solve_hook(
                    20, buffer=buffer, bit_class="mantissa", seed=0))
        assert int(res.flag) == pcg.FLAG_CONVERGED
        assert metrics.get("integrity.false_alarms") == 0


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_clean_resilient_verified_zero_verdicts(dtype):
    base = pcg_solve_resilient(PROBLEM, dtype=dtype, chunk=10, device="cpu")
    metrics.reset()
    ver = pcg_solve_resilient(PROBLEM, dtype=dtype, chunk=10,
                              verify_every=5, device="cpu")
    assert int(ver.iterations) == int(base.iterations)
    assert torch.equal(ver.w, base.w)
    assert ver.restarts == 0
    assert metrics.get("integrity.detections") == 0
    assert metrics.get("integrity.false_alarms") == 0
    assert metrics.get("integrity.checks") >= 1


# -- per member: one corrupted lane, its batchmates untouched ------------


def test_masked_per_member_detection_in_a_running_bucket():
    """JAX's drill (tests/test_integrity.py:414-443): a flip in one lane
    stops that lane with FLAG_INTEGRITY within a stride; the others
    converge with their solo (and JAX's) counts."""
    prob = Problem(M=32, N=32)
    gates = {"victim": 1.0, "inn-0": 1.1, "inn-1": 1.2}
    solo = {mid: pcg.pcg_solve(prob, dtype="float32", rhs_gate=g,
                               verify_every=5, device="cpu")
            for mid, g in gates.items()}
    jax_solo = {mid: jax_pcg.pcg_solve(JaxProblem(M=32, N=32),
                                       dtype="float32", rhs_gate=g,
                                       verify_every=5)
                for mid, g in gates.items()}
    lb = LaneBatch(prob, bucket=4, dtype="float32", chunk=10,
                   verify_every=5, device="cpu")
    lanes = {mid: lb.splice(mid, rhs_gate=g) for mid, g in gates.items()}
    lb.step()
    faults.bitflip_lane(lb, lanes["victim"], buffer="w", seed=0)
    for _ in range(60):
        if all(v["done"] for v in lb.lane_view()
               if v["member_id"] is not None):
            break
        lb.step()
    out = {v["member_id"]: v for v in lb.lane_view()
           if v["member_id"] is not None}
    assert out["victim"]["flag"] == pcg.FLAG_INTEGRITY
    assert out["victim"]["k"] <= 10 + 5
    for mid in ("inn-0", "inn-1"):
        assert out[mid]["flag"] == pcg.FLAG_CONVERGED
        assert out[mid]["k"] == int(solo[mid].iterations) == int(
            jax_solo[mid].iterations), mid
    res = lb.retire(lanes["victim"])
    assert res.flag == pcg.FLAG_INTEGRITY and res.member_id == "victim"


def test_batched_verified_clean_matches_unverified_and_jax():
    from poisson_tpu.solvers.batched import solve_batched as jax_batched

    prob = Problem(M=32, N=32)
    gates = [1.0, 1.3, 0.8]
    base = solve_batched(prob, rhs_gates=gates, dtype="float32",
                         device="cpu")
    ver = solve_batched(prob, rhs_gates=gates, dtype="float32",
                        verify_every=5, device="cpu")
    want = jax_batched(JaxProblem(M=32, N=32), rhs_gates=gates,
                       dtype="float32", verify_every=5)
    assert ver.iterations.tolist() == base.iterations.tolist() == [
        int(k) for k in want.iterations]
    assert all(int(f) == pcg.FLAG_CONVERGED for f in ver.flag)
    assert torch.equal(ver.w, base.w)


def test_batched_member_bitflip_stops_only_that_member():
    """A stacked state corrupted in one member (``member=``) and stepped
    on by the verified batched body: that member alone stops with
    FLAG_INTEGRITY; the others finish with their unverified counts."""
    prob = Problem(M=32, N=32)
    setup = _setup(prob, "float32", members=True)
    stack = pcg.gate_rhs(setup.rhs, torch.tensor([1.0, 1.3, 0.8]))
    kw = dict(delta=prob.delta, weighted_norm=prob.weighted_norm,
              h1=prob.h1, h2=prob.h2)
    body = pcg.make_pcg_body(
        setup.ops, verify_every=5, verify_rhs=stack,
        verify_tol=pcg.resolve_verify_tol(None, "float32"), **kw)
    s = pcg.drive(body, pcg.init_state(setup.ops, stack), 10, 10)
    s = faults.inject_bitflip(s, "r", member=1, seed=0)
    s = pcg.drive(body, s, prob.iteration_cap, 32)
    clean = solve_batched(prob, rhs_gates=[1.0, 1.3, 0.8], dtype="float32",
                          device="cpu")
    flags = s.flag.reshape(-1).tolist()
    assert flags[1] == pcg.FLAG_INTEGRITY and int(s.k[1]) <= 15
    assert flags[0] == flags[2] == pcg.FLAG_CONVERGED
    assert [int(s.k[0]), int(s.k[2])] == [int(clean.iterations[0]),
                                         int(clean.iterations[2])]


# -- MG: the preconditioner-calibrated guards ----------------------------


def test_mg_verified_clean_solve_no_false_alarms():
    """JAX's case (tests/test_mg.py:406-416): the worst measured clean
    collapse grid keeps its unverified count with no verdict."""
    p = Problem(M=100, N=150)
    plain = pcg.pcg_solve(p, dtype="float32", preconditioner="mg",
                          device="cpu")
    ver = pcg.pcg_solve(p, dtype="float32", preconditioner="mg",
                        verify_every=3, device="cpu")
    assert int(ver.flag) == pcg.FLAG_CONVERGED
    assert int(ver.iterations) == int(plain.iterations)
    assert torch.equal(ver.w, plain.w)
    with pytest.raises(ValueError, match="jacobi path only"):
        pcg.pcg_solve(p, dtype="float32", preconditioner="mg",
                      verify_every=3, verify_abft=True, device="cpu")


def test_mg_resilient_detects_bitflip_and_recovers():
    """JAX's ``test_mg_resilient_detects_bitflip_and_recovers``
    (tests/test_mg.py)."""
    p = Problem(M=64, N=64)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        r = pcg_solve_resilient(
            p, chunk=2, verify_every=1, preconditioner="mg", device="cpu",
            on_chunk=faults.bitflip_per_solve_hook(4, buffer="w", seed=1))
    assert int(r.flag) == pcg.FLAG_CONVERGED
    assert r.restarts >= 1
    assert metrics.get("integrity.detections") >= 1
    assert metrics.get("integrity.verified_restarts") >= 1
    assert metrics.get("resilient.escalations") == 0
