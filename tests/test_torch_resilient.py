"""Port parity: the self-healing solve (``poisson_tpu_torch.solvers.
resilient``) and the CLI's resilience flags against
``poisson_tpu.solvers.resilient`` and the JAX CLI, on the CPU, on the JAX
tests' 40×40 problem.

Tolerances: on every drill here the (iteration, verdict, action) history,
the warnings' texts, the restart count, the diagnostics and the final
count equal JAX's — in fp64 and, on these drills, in fp32 too (the
drills' NaN lands in the middle cell in both packages and the detection
iterations are the chunk boundaries, so no count gap arises); fp64
iterates lie within 1e-10 of JAX's, fp32 within 1e-6. Checkpoints cross
both packages at an escalated rung.
"""

import json
import os
import shutil
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import resilient as jax_resilient
from poisson_tpu.testing import faults as jax_faults
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.solvers import resilient
from poisson_tpu_torch.solvers.pcg import FLAG_CONVERGED, pcg_solve
from poisson_tpu_torch.testing import faults

ROOT = Path(__file__).resolve().parents[1]
P = Problem(M=40, N=40)
JP = JaxProblem(M=40, N=40)
ATOL = {"float64": 1e-10, "float32": 1e-6}
COUNTERS = ("resilient.restarts", "resilient.escalations",
            "resilient.deadline_stops", "integrity.checks",
            "integrity.detections", "integrity.false_alarms",
            "integrity.verified_restarts")


@pytest.fixture(autouse=True)
def _fresh():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    jax_metrics.reset()
    yield
    metrics.reset()
    jax_metrics.reset()
    torch.set_num_threads(saved)


def _both(port_kwargs, jax_kwargs, **shared):
    """Run the port's and JAX's resilient solves; returns (port result,
    port warnings, JAX result, JAX warnings)."""
    out = []
    for solve, kw, extra in ((resilient.pcg_solve_resilient, port_kwargs,
                              {"device": "cpu"}),
                             (jax_resilient.pcg_solve_resilient,
                              jax_kwargs, {})):
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            res = solve(**shared, **kw, **extra)
        out += [res, [str(w.message) for w in seen]]
    return out


def _same_result(a, b, dtype):
    assert int(a.iterations) == int(b.iterations)
    assert int(a.flag) == int(b.flag)
    assert a.restarts == b.restarts
    assert a.recovery_history == tuple(b.recovery_history)
    np.testing.assert_allclose(a.w.numpy(), np.asarray(b.w), rtol=0,
                               atol=ATOL[dtype])


def _same_counters():
    assert {k: metrics.get(k) for k in COUNTERS} == \
        {k: jax_metrics.get(k) for k in COUNTERS}


def test_converging_solve_keeps_its_count_and_jax_s_iterate():
    a, wa, b, wb = _both({"problem": P}, {"problem": JP}, chunk=10)
    _same_result(a, b, "float64")
    assert int(a.iterations) == 50 and a.restarts == 0 and wa == wb == []
    assert torch.equal(a.w, pcg_solve(P, device="cpu").w)
    _same_counters()


@pytest.mark.parametrize("buffer", ["r", "w"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_nan_injection_recovers_as_jax_does(buffer, dtype):
    a, wa, b, wb = _both(
        {"problem": P, "on_chunk": faults.chunk_hook(faults.FaultPlan(
            nan_at_iteration=15, nan_buffer=buffer))},
        {"problem": JP, "on_chunk": jax_faults.chunk_hook(
            jax_faults.FaultPlan(nan_at_iteration=15, nan_buffer=buffer))},
        chunk=10, dtype=dtype)
    _same_result(a, b, dtype)
    assert wa == wb and any("restart@" in m for m in wa)
    assert int(a.flag) == FLAG_CONVERGED and float(a.diff) < P.delta
    _same_counters()


def _two_nans(inject):
    count = {"n": 0}

    def hook(state, chunks_done):
        if count["n"] < 2 and int(state.k) >= 10:
            count["n"] += 1
            return inject(state)
        return None

    return hook


def test_escalation_to_float64_matches_jax_s_warnings():
    a, wa, b, wb = _both({"problem": P, "on_chunk": _two_nans(
                             faults.inject_nan)},
                         {"problem": JP, "on_chunk": _two_nans(
                             jax_faults.inject_nan)},
                         chunk=10, dtype="float32")
    _same_result(a, b, "float64")
    assert wa == wb
    assert any("restart@float32" in m for m in wa)
    assert any("escalate->float64" in m for m in wa)
    assert a.w.dtype == torch.float64
    _same_counters()
    assert metrics.get("resilient.escalations") == 1


def test_budget_exhaustion_diagnostics_equal_jax():
    got = want = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(resilient.DivergenceError) as e:
            resilient.pcg_solve_resilient(
                P, chunk=10, device="cpu",
                on_chunk=lambda s, c: faults.inject_nan(s),
                policy=resilient.RecoveryPolicy(max_restarts=2,
                                                escalate=False))
        got = e.value.diagnostics
        with pytest.raises(jax_resilient.DivergenceError) as e:
            jax_resilient.pcg_solve_resilient(
                JP, chunk=10, on_chunk=lambda s, c: jax_faults.inject_nan(s),
                policy=jax_resilient.RecoveryPolicy(max_restarts=2,
                                                    escalate=False))
        want = e.value.diagnostics
    assert set(got) == set(want)
    for key in ("problem", "verdict", "iteration", "dtype", "restarts",
                "history"):
        assert got[key] == want[key], key
    assert got["verdict"] == "nonfinite" and got["restarts"] == 3
    assert len(got["history"]) == 2
    np.testing.assert_allclose(got["diff"], want["diff"], rtol=1e-10)


def test_ladder_and_policy_equal_jax():
    assert resilient._LADDER == jax_resilient._LADDER
    assert resilient._rungs_above("float32") == ["float64"]
    assert resilient._rungs_above("float64") == []
    assert resilient._rungs_above("bfloat16") == ["float32", "float64"]
    assert resilient.RecoveryPolicy() == resilient.RecoveryPolicy(
        **vars(jax_resilient.RecoveryPolicy()))
    # The ladder's first rung runs: a bf16 resilient solve is JAX's, its
    # count and every bit of its iterate (the port rounds where XLA does).
    got = resilient.pcg_solve_resilient(P, dtype="bfloat16", device="cpu")
    want = jax_resilient.pcg_solve_resilient(JP, dtype="bfloat16")
    assert got.w.dtype == torch.bfloat16
    assert int(got.flag) == int(want.flag) == FLAG_CONVERGED
    assert int(got.iterations) == int(want.iterations)
    assert got.recovery_history == want.recovery_history == ()
    np.testing.assert_array_equal(got.w.float().numpy(),
                                  np.asarray(want.w, np.float32))


@pytest.mark.parametrize("grid", [(40, 40), (400, 600)])
def test_bfloat16_plain_solve_is_jax_s(grid):
    """Fault 4: the plain bf16 solve rounds where XLA does (every op in
    bf16, products summed unrounded in fp32, Python constants weakly typed
    to bf16), so it gives JAX's count (61 and 859 on the CPU) and flag,
    and lies as far from the fp64 solve as JAX's does (1.9e-3, 1.57e-2).
    The count may move with a sum order that flips one bf16 rounding: the
    allowance is 2%; the distance is held to 2x JAX's."""
    from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve

    got = pcg_solve(Problem(*grid), dtype="bfloat16", device="cpu")
    want = jax_pcg_solve(JaxProblem(*grid), dtype="bfloat16")
    ref = pcg_solve(Problem(*grid), dtype="float64", device="cpu").w.numpy()
    assert got.w.dtype == torch.bfloat16
    assert int(got.flag) == int(want.flag) == FLAG_CONVERGED
    assert abs(int(got.iterations) - int(want.iterations)) <= 0.02 * int(
        want.iterations)
    gap = np.abs(got.w.double().numpy() - ref).max()
    jax_gap = np.abs(np.asarray(want.w, np.float64) - ref).max()
    assert gap <= 2 * jax_gap


def test_kernel_backends_refuse_bfloat16():
    """The kernel backends take fp32 only, and say so for bf16 as for fp64;
    both CLIs keep the JAX package's --dtype choices (bf16 is API only)."""
    from poisson_tpu.cli import main as jax_cli_main
    from poisson_tpu_torch import cli
    from poisson_tpu_torch.ops import fused_cg

    cv, *_ = fused_cg.build_canvases(Problem(M=40, N=40), "cpu")
    z = torch.zeros((cv.rows, cv.cols), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="must be float32, got "
                                         "torch.bfloat16"):
        fused_cg.fused_update(cv, torch.zeros(1), z, z, z, z, z)
    for main in (cli.main, jax_cli_main):
        with pytest.raises(SystemExit) as e:
            main(["40", "40", "--dtype", "bfloat16"])
        assert e.value.code == 2


def test_bfloat16_resilient_escalates_as_jax_does():
    """Fault 4's reference: at 400x600 the bf16 solve stagnates twice with
    the default policy and finishes in fp32, as the JAX package's does:
    the same history, count and final dtype (on the CPU: 1750, with
    ((724, stagnated, restart@bfloat16), (1224, stagnated,
    escalate->float32)))."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = resilient.pcg_solve_resilient(Problem(400, 600),
                                            dtype="bfloat16", device="cpu")
        want = jax_resilient.pcg_solve_resilient(JaxProblem(400, 600),
                                                 dtype="bfloat16")
    assert [h[1:] for h in got.recovery_history] == [
        h[1:] for h in want.recovery_history] == [
        ("stagnated", "restart@bfloat16"),
        ("stagnated", "escalate->float32")]
    assert got.w.dtype == torch.float32
    assert int(got.flag) == int(want.flag) == FLAG_CONVERGED
    # Counts: equal on this drill (bf16 rounds at XLA's points); a sum
    # order that flips one bf16 rounding may move a bf16 count, so the
    # allowance is 2% (see CHANGES.md).
    for g, w in zip(got.recovery_history, want.recovery_history):
        assert abs(g[0] - w[0]) <= 0.02 * w[0]
    assert abs(int(got.iterations) - int(want.iterations)) <= 0.02 * int(
        want.iterations)


def _escalate_then_preempt(inject, preempted):
    """Two NaNs at fp32 (so the solve escalates), then a preemption at the
    first fp64 boundary, whose checkpoint is already written."""
    nans = _two_nans(inject)

    def hook(state, chunks_done):
        if str(state.w.dtype).endswith("float64"):
            raise preempted("injected preemption after escalation")
        return nans(state, chunks_done)

    return hook


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_preempted_escalated_checkpoint_resumes_in_the_other(tmp_path,
                                                              writer):
    """A resilient run preempted after its f32→f64 escalation leaves an
    fp64 newest generation; the other package resumes from it at that
    rung, to the count and iterate of the writer's own resume."""
    path = str(tmp_path / "ck.npz")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if writer == "jax":
            with pytest.raises(jax_faults.PreemptionInjected):
                jax_resilient.pcg_solve_resilient(
                    JP, dtype="float32", chunk=10, checkpoint_path=path,
                    on_chunk=_escalate_then_preempt(
                        jax_faults.inject_nan, jax_faults.PreemptionInjected))
        else:
            with pytest.raises(faults.PreemptionInjected):
                resilient.pcg_solve_resilient(
                    P, dtype="float32", chunk=10, checkpoint_path=path,
                    device="cpu", on_chunk=_escalate_then_preempt(
                        faults.inject_nan, faults.PreemptionInjected))
    copy = str(tmp_path / "copy.npz")
    for suffix in ("", ".1"):
        shutil.copy(path + suffix, copy + suffix)
    state, rung = resilient._load_any_rung(path, P, "float32", True, 2)
    assert rung == "float64" and int(state.k) == 30
    a = resilient.pcg_solve_resilient(P, dtype="float32", chunk=10,
                                      checkpoint_path=path, device="cpu")
    b = jax_resilient.pcg_solve_resilient(JP, dtype="float32", chunk=10,
                                          checkpoint_path=copy)
    assert a.w.dtype == torch.float64 and np.asarray(b.w).dtype == np.float64
    assert int(a.iterations) == int(b.iterations)
    assert int(a.flag) == int(b.flag) == FLAG_CONVERGED
    np.testing.assert_allclose(a.w.numpy(), np.asarray(b.w), rtol=0,
                               atol=1e-10)
    assert not os.path.exists(path) and not os.path.exists(copy)


def test_corrupt_newest_generation_falls_back(tmp_path):
    """JAX writes two generations and is preempted; the newest is
    corrupted; the port falls back to the older one and finishes with the
    uninterrupted solve's count and JAX's iterate."""
    path = str(tmp_path / "ck.npz")
    with pytest.raises(jax_faults.PreemptionInjected):
        jax_resilient.pcg_solve_resilient(
            JP, chunk=10, checkpoint_path=path,
            on_chunk=jax_faults.chunk_hook(jax_faults.FaultPlan(
                preempt_after_chunks=3)))
    assert os.path.exists(path) and os.path.exists(path + ".1")
    faults.corrupt_file(path, "flip")
    with pytest.warns(RuntimeWarning, match="previous checkpoint"):
        a = resilient.pcg_solve_resilient(P, chunk=10, checkpoint_path=path,
                                          device="cpu")
    ref = jax_resilient.pcg_solve_resilient(JP, chunk=10)
    assert int(a.iterations) == int(ref.iterations) == 50
    np.testing.assert_allclose(a.w.numpy(), np.asarray(ref.w), rtol=0,
                               atol=1e-10)


def test_resilient_resumes_across_its_own_preemption(tmp_path):
    path = str(tmp_path / "ck.npz")
    with pytest.raises(faults.PreemptionInjected):
        resilient.pcg_solve_resilient(
            P, chunk=10, checkpoint_path=path, device="cpu",
            on_chunk=faults.chunk_hook(faults.FaultPlan(
                preempt_after_chunks=2)))
    res = resilient.pcg_solve_resilient(P, chunk=10, checkpoint_path=path,
                                        device="cpu")
    ref = pcg_solve(P, device="cpu")
    assert int(res.iterations) == int(ref.iterations) == 50
    assert torch.equal(res.w, ref.w)


def test_deadline_stops_before_a_chunk():
    class Expired:
        def __init__(self, after):
            self.calls, self.after = 0, after

        def expired(self):
            self.calls += 1
            return self.calls > self.after

    a = resilient.pcg_solve_resilient(P, chunk=10, deadline=Expired(2),
                                      device="cpu")
    b = jax_resilient.pcg_solve_resilient(JP, chunk=10,
                                          deadline=Expired(2))
    assert int(a.flag) == int(b.flag) == 5
    assert int(a.iterations) == int(b.iterations) == 20
    _same_counters()


def test_mg_chunked_and_resilient_bitwise_vs_one_shot():
    """JAX's case (tests/test_mg.py:343-356) on the port."""
    from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked

    p = Problem(M=64, N=64)
    one = pcg_solve(p, dtype="float32", preconditioner="mg", device="cpu")
    ch = pcg_solve_chunked(p, chunk=3, dtype="float32",
                           preconditioner="mg", device="cpu")
    assert torch.equal(ch.w, one.w)
    assert int(ch.iterations) == int(one.iterations)
    rs = resilient.pcg_solve_resilient(p, chunk=4, dtype="float32",
                                       preconditioner="mg", device="cpu")
    assert torch.equal(rs.w, one.w)
    assert rs.restarts == 0
    assert metrics.get("mg.solves") == 3


# -- the CLI --------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _port_cli(capsys, *args):
    from poisson_tpu_torch.cli import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    return rc, (json.loads(out.strip().splitlines()[-1])
                if rc == 0 and "--json" in args else out)


def _jax_cli(capsys, *args):
    from poisson_tpu.cli import main

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        rc = main(list(args))
    out = capsys.readouterr().out
    return rc, (json.loads(out.strip().splitlines()[-1])
                if rc == 0 and "--json" in args else out)


def test_cli_nan_drill_matches_the_jax_cli_subprocess(capsys):
    args = ["40", "40", "--resilient", "--fault-nan-at", "15", "--chunk",
            "10", "--json"]
    out = subprocess.run([sys.executable, "-m", "poisson_tpu", *args,
                          "--backend", "xla"], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    want = json.loads(out.stdout.strip().splitlines()[-1])
    rc, got = _port_cli(capsys, *args)
    assert rc == 0 and got["backend"] == "torch"
    for key in ("iterations", "stopped", "restarts", "recovery"):
        assert got[key] == want[key], key
    assert got["restarts"] == 1
    assert got["recovery"] == [[21, "nonfinite", "restart@float32"]]


def test_cli_bitflip_drill_matches_the_jax_cli(capsys):
    args = ["40", "40", "--resilient", "--verify-every", "5",
            "--fault-bitflip-at", "20", "--json"]
    rc, got = _port_cli(capsys, *args)
    jrc, want = _jax_cli(capsys, *args, "--backend", "xla")
    assert rc == jrc == 0
    for key in ("iterations", "stopped", "restarts", "recovery"):
        assert got[key] == want[key], key
    assert got["recovery"][0][1:] == ["integrity", "verified-restart@20"]


def test_cli_preempt_exits_75_then_resumes(tmp_path, capsys):
    ck, jck = str(tmp_path / "ck.npz"), str(tmp_path / "jck.npz")
    common = ["40", "40", "--chunk", "10", "--json"]
    rc, _ = _port_cli(capsys, *common, "--backend", "torch", "--checkpoint",
                      ck, "--fault-preempt-after", "2")
    jrc, _ = _jax_cli(capsys, *common, "--backend", "xla", "--checkpoint",
                      jck, "--fault-preempt-after", "2")
    assert rc == jrc == 75
    assert os.path.exists(ck) and os.path.exists(jck)
    rc, got = _port_cli(capsys, *common, "--backend", "torch",
                        "--checkpoint", ck)
    jrc, want = _jax_cli(capsys, *common, "--backend", "xla",
                         "--checkpoint", jck)
    assert rc == jrc == 0
    assert got["iterations"] == want["iterations"]
    assert got["stopped"] is None and not os.path.exists(ck)


def test_cli_corrupt_checkpoint_falls_back(tmp_path, capsys):
    ck = str(tmp_path / "ck.npz")
    common = ["40", "40", "--backend", "torch", "--checkpoint", ck,
              "--chunk", "10", "--json"]
    assert _port_cli(capsys, *common, "--fault-preempt-after", "2")[0] == 75
    rc, got = _port_cli(capsys, *common, "--fault-corrupt-checkpoint", "flip")
    assert rc == 0 and got["stopped"] is None and got["iterations"] == 50


def test_cli_watchdog_heartbeat(tmp_path, capsys):
    hb = str(tmp_path / "hb.json")
    rc, got = _port_cli(capsys, "40", "40", "--resilient", "--chunk", "10",
                        "--heartbeat", hb, "--watchdog-timeout", "300",
                        "--json")
    assert rc == 0
    beat = json.load(open(hb))
    assert beat["k"] == got["iterations"]
    assert set(beat) == {"at_unix", "at_mono", "pid", "beats", "k", "diff",
                         "dtype", "restarts"}


# Each guard: the JAX CLI's args (xla), the port's (torch), a fragment of
# the refusal both print.
_GUARDS = [
    (["--fault-nan-at", "5"], "chunk boundaries", "xla", "torch"),
    (["--keep-last", "3"], "retention", "xla", "torch"),
    (["--resilient"], "drives the single-device", "sharded", "sharded"),
    (["--verify-every", "5"], "integrity probe", "sharded", "sharded"),
    (["--heartbeat", "hb.json"], "--heartbeat/--watchdog-timeout",
     "xla", "torch"),
    (["--stream-every", "5"], "stream-every", "sharded", "sharded"),
    (["--stagnation-window", "10"], "in-loop-detecting", "xla", "torch"),
    (["--fault-bitflip-at", "5"], "single-device drivers", "xla", "torch"),
    (["--verify-tol", "1e-3"], "to arm it", "xla", "torch"),
    (["--fault-corrupt-checkpoint", "flip"], "pass --checkpoint PATH",
     "xla", "torch"),
    (["--verify-every", "-1"], "must be >= 0", "xla", "torch"),
    (["--fault-bitflip-at", "10:q"], "bitflip buffer", "xla", "torch"),
    (["--stream-every", "-2"], "must be >= 0", "xla", "torch"),
]


@pytest.mark.parametrize("flags,fragment,jax_backend,port_backend",
                         _GUARDS, ids=[g[1] for g in _GUARDS])
def test_cli_guards_refuse_in_jax_s_words(flags, fragment, jax_backend,
                                         port_backend):
    from poisson_tpu.cli import main as jax_main
    from poisson_tpu_torch.cli import main

    with pytest.raises(SystemExit, match=fragment):
        jax_main(["40", "40", "--backend", jax_backend, *flags])
    with pytest.raises(SystemExit, match=fragment):
        main(["40", "40", "--backend", port_backend, "--device", "cpu",
              *flags])


def test_cli_auto_picks_torch_for_resilient():
    from poisson_tpu_torch.cli import pick_backend

    assert pick_backend("auto", "float32", 1, resilient=True) == "torch"
    assert pick_backend("auto", "float32", 4, resilient=True) == "torch"
    assert pick_backend("auto", "float32", 1) == "fused"
