"""The fused iteration's scalar recurrence (``ops.recurrence``).

On a card each half of it is one launch of a one-thread kernel of
``ops/csrc/fused_cg.cu``, which must give the bits of its plain version,
the torch operations it replaced; on the CPU the plain version runs and
nothing is launched. The tests marked ``card`` hold the kernels against
the plain version on the card, state by state and over whole solves, and
skip without a card. This file imports no JAX, so that they run where JAX
is not installed::

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_recurrence.py
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops import fused_cg, launch
from poisson_tpu_torch.ops.recurrence import Recurrence
from poisson_tpu_torch.parallel import fused_sharded as fs
from poisson_tpu_torch.parallel.mesh import make_solver_mesh
from poisson_tpu_torch.solvers.pcg import _DENOM_TOL, CHECK_EVERY

KEYS = ("recurrence_step", "recurrence_close")
SOURCE = (Path(fused_cg.__file__).resolve().parent / "csrc" / "fused_cg.cu")
FLAGSHIP = Problem(M=800, N=1200)
# The golden counts of the whole solves.
GRIDS = {(40, 40): 50, (400, 600): 546, (800, 1200): 989}
FORMS = ("full-width", "blocked", "serial", "sharded")


class State(NamedTuple):
    """The scalar fields of a solver state the recurrence reads."""

    k: torch.Tensor
    done: torch.Tensor
    zr: torch.Tensor
    beta: torch.Tensor
    diff: torch.Tensor


def state(k, done, zr, beta, diff, device) -> State:
    return State(
        k=torch.tensor(k, dtype=torch.int32, device=device),
        done=torch.tensor(done, device=device),
        zr=torch.tensor(zr, dtype=torch.float32, device=device),
        beta=torch.tensor(beta, dtype=torch.float32, device=device),
        diff=torch.tensor(diff, dtype=torch.float32, device=device))


def f32(x: float) -> float:
    return float(np.float32(x))


def nudged(x: float, ulps: int) -> float:
    """``x`` in fp32 moved by ``ulps`` units in the last place."""
    v = np.float32(x)
    step = np.float32(np.inf if ulps > 0 else -np.inf)
    for _ in range(abs(ulps)):
        v = np.nextafter(v, step)
    return float(v)


def bits(t: torch.Tensor):
    """A 0-d tensor's value as its bits (fp32: the int32 pattern; NaN as
    one value, since no value of these sweeps is a NaN)."""
    t = t.detach().cpu()
    if t.dtype == torch.float32:
        return "nan" if bool(torch.isnan(t)) else int(t.view(torch.int32))
    return t.item()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def launched() -> dict:
    return launch.launch_counts(*KEYS)


def driven_steps(k: int, cap: int) -> int:
    return min(cap, -(-k // CHECK_EVERY) * CHECK_EVERY)


# --- on the CPU ---------------------------------------------------------------


def solve_state(problem: Problem, form: str, device):
    """The state a whole solve of ``form`` ends in: a fused state, or a
    sharded one on a 2×2 mesh of ``device``."""
    if form == "sharded":
        mesh = make_solver_mesh([device] * 4, grid=(2, 2))
        spec, canvases = fs.shard_canvases(problem, mesh, 1)
        return fs._sharded_solve(problem, spec, mesh, canvases,
                                 canvases.rhs)
    bn = {"blocked": 128 if problem.N < 256 else 256}.get(form)
    cv, cs, cw, g, rhs, sc2, _ = fused_cg.build_canvases(problem, device,
                                                         bn=bn)
    return fused_cg._fused_solve(
        problem, cv, cs, cw, g, rhs, sc2,
        run=fused_cg.fused_run(problem, cv, form == "serial"))


@pytest.mark.parametrize("form", FORMS)
def test_the_cpu_path_counts_no_recurrence_launch(form):
    launch.reset_launch_counts()
    s = solve_state(Problem(M=40, N=40), form, "cpu")
    assert int(s.k) == 50
    assert launched() == dict.fromkeys(KEYS, 0)


@pytest.mark.parametrize("weighted", [True, False])
def test_the_kernels_take_the_plain_versions_constants(weighted):
    """The constants go to the kernels by value as the very fp32 values
    the plain version's tensors hold."""
    p = Problem(M=400, N=600, weighted_norm=weighted)
    rec = Recurrence(p, torch.device("cpu"))
    held = (rec.h1h2, rec.norm_w, rec.delta)
    assert all(t.dtype == torch.float32 and t.dim() == 0 for t in held)
    assert rec.values == tuple(t.item() for t in held)
    assert rec.values == (f32(p.h1 * p.h2),
                          f32(p.h1 * p.h2) if weighted else 1.0,
                          f32(p.delta))


def test_the_guard_is_compared_in_fp32_as_torch_compares_it():
    """torch compares an fp32 tensor with the Python float ``_DENOM_TOL``
    as with that float rounded to fp32, which is the kernel's
    ``kDenomTol``: the same verdict at and around the boundary."""
    code = SOURCE.read_text()
    tol = re.search(r"constexpr float kDenomTol = ([0-9.e+-]+)f;", code)
    assert tol and f32(float(tol.group(1))) == f32(_DENOM_TOL)
    edge = f32(_DENOM_TOL)
    for u in range(-3, 4):
        for sign in (1.0, -1.0):
            x = sign * nudged(edge, u)
            t = torch.tensor(x, dtype=torch.float32)
            fp32 = bool(np.abs(np.float32(x)) < np.float32(_DENOM_TOL))
            assert bool(torch.abs(t) < _DENOM_TOL) == fp32, x


def test_the_cpu_dispatch_is_the_plain_version():
    launch.reset_launch_counts()
    rec = Recurrence(FLAGSHIP, torch.device("cpu"))
    s = state(2, False, 3.0, 0.9, 1e-2, torch.device("cpu"))
    denom = torch.tensor(1.5e6)
    alpha, deg = rec.step_size(s, denom)
    want = rec.step_size_plain(s, denom)
    assert (bits(alpha), bits(deg)) == (bits(want[0]), bits(want[1]))
    got = rec.close(s, alpha, deg, torch.tensor(1e-3), torch.tensor(2.0))
    plain = rec.close_plain(s, alpha, deg, torch.tensor(1e-3),
                            torch.tensor(2.0))
    assert {k: bits(v) for k, v in got.items()} == {
        k: bits(v) for k, v in plain.items()}
    assert launched() == dict.fromkeys(KEYS, 0)


# --- on the card --------------------------------------------------------------


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: the recurrence kernels run on a "
                    "card only")
    return torch.device("cuda", 0)


@pytest.fixture
def fresh_bodies():
    """No canvases, and so no marked body or captured block, carried into
    or out of a test."""
    fused_cg._device_canvases.cache_clear()
    fs._shard_canvases.cache_clear()
    yield
    fused_cg._device_canvases.cache_clear()
    fs._shard_canvases.cache_clear()


def step_cases(h1h2: float) -> list:
    """(Σ⟨Ap, p⟩, ζ, done) of states to hold the step against: live and
    done, zero, negative and boundary denominators, ζ = 0 and near fp32's
    extremes."""
    edge = f32(f32(_DENOM_TOL) / h1h2)
    cases = [(1.5e6, 2.0, False), (1.5e6, 2.0, True), (0.0, 2.0, False),
             (-0.0, 2.0, False), (0.0, 2.0, True), (-1.5e6, 2.0, False),
             (1.5e6, 0.0, False), (1.5e6, -0.0, False),
             (3.0e38, 2.0, False), (-3.0e38, 3.0e38, False),
             (float("inf"), 2.0, False), (1.0e-3, 3.0e38, False),
             (1.0e30, 1.0e-38, False), (0.5, 1.0e-45, False),
             (1.0e-30, 1.0e-45, False)]
    for u in range(-4, 5):
        for sign in (1.0, -1.0):
            cases.append((sign * nudged(edge, u), 1.0, False))
            cases.append((sign * nudged(edge, u), 1.0, True))
    return cases


def close_cases(norm_w: float, delta: float) -> list:
    """(α, degenerate, Σ p²·sc², Σ r², k, done, ζ, β, diff) of steps to
    hold the close against: live and done, degenerate, ζ = 0 (β's guard),
    the step on which diff crosses δ, diff = inf on the first step, α and
    ζ near fp32's extremes."""
    cases = [(0.5, False, 1e-3, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (0.5, False, 1e-3, 2.0, 7, True, 3.0, 0.9, 1e-2),
             (0.0, True, 1e-3, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (0.0, True, 1e-3, 2.0, 7, True, 3.0, 0.9, 1e-2),
             (0.5, False, 1e-3, 2.0, 7, False, 0.0, 0.9, 1e-2),
             (0.5, False, 1e-3, 2.0, 7, False, -0.0, 0.9, 1e-2),
             (0.5, False, 1e-3, 0.0, 7, False, 0.0, 0.9, 1e-2),
             (0.5, False, 1e-3, 2.0, 0, False, 3.0, 0.0,
              float("inf")),
             (0.5, False, 1e-3, 2.0, 0, True, 3.0, 0.0, float("inf")),
             (-0.5, False, 1e-3, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (3.0e38, False, 1e-3, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (-3.0e38, False, 1e30, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (1.0e-38, False, 1e-3, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (-1.0e-45, False, 1e-3, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (0.5, False, 0.0, 2.0, 7, False, 3.0, 0.9, 1e-2),
             (0.5, False, 1e-3, 3.0e38, 7, False, 1.0e-38, 0.9, 1e-2),
             (0.5, False, 1e-3, 1.0e-45, 7, False, 3.0e38, 0.9, 1e-2),
             (0.5, False, 1e-3, 2.0, 2 ** 31 - 2, False, 3.0, 0.9, 1e-2)]
    edge = f32(f32(delta * delta) / norm_w)
    for u in range(-6, 7):
        cases.append((1.0, False, nudged(edge, u), 2.0, 40, False, 3.0,
                      0.9, 2e-6))
    return cases


@pytest.mark.card
@pytest.mark.parametrize("weighted", [True, False])
def test_card_step_is_its_plain_version_bit_for_bit(card, weighted):
    rec = Recurrence(Problem(M=800, N=1200, weighted_norm=weighted), card)
    launch.reset_launch_counts()
    verdicts = set()
    cases = step_cases(rec.values[0])
    for denom, zr, done in cases:
        s = state(3, done, zr, 0.5, 1e-3, card)
        d = torch.tensor(denom, dtype=torch.float32, device=card)
        got = rec.step_size(s, d)
        want = rec.step_size_plain(s, d)
        assert [t.dtype for t in got] == [torch.float32, torch.bool]
        assert all(t.dim() == 0 and t.device == card for t in got)
        assert [bits(t) for t in got] == [bits(t) for t in want], (
            denom, zr, done)
        verdicts.add(bool(want[1]))
    assert verdicts == {True, False}      # the sweep crosses the guard
    assert launched() == {"recurrence_step": len(cases),
                          "recurrence_close": 0}


@pytest.mark.card
@pytest.mark.parametrize("weighted", [True, False])
def test_card_close_is_its_plain_version_bit_for_bit(card, weighted):
    rec = Recurrence(Problem(M=800, N=1200, weighted_norm=weighted), card)
    launch.reset_launch_counts()
    crossed = set()
    cases = close_cases(*rec.values[1:])
    dtypes = dict(k=torch.int32, done=torch.bool, zr=torch.float32,
                  beta=torch.float32, diff=torch.float32)
    for alpha, deg, diff_sum, zr_sum, k, done, zr, beta, diff in cases:
        s = state(k, done, zr, beta, diff, card)
        args = (torch.tensor(alpha, dtype=torch.float32, device=card),
                torch.tensor(deg, device=card),
                torch.tensor(diff_sum, dtype=torch.float32, device=card),
                torch.tensor(zr_sum, dtype=torch.float32, device=card))
        got = rec.close(s, *args)
        want = rec.close_plain(s, *args)
        assert {k_: v.dtype for k_, v in got.items()} == dtypes
        assert {k_: bits(v) for k_, v in got.items()} == {
            k_: bits(v) for k_, v in want.items()}, (alpha, deg, diff_sum)
        if (alpha, k) == (1.0, 40):
            crossed.add(bool(want["done"]))
    assert crossed == {True, False}       # the sweep crosses δ
    assert launched() == {"recurrence_step": 0,
                          "recurrence_close": len(cases)}


@pytest.mark.card
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("grid", list(GRIDS), ids=lambda g: "x".join(
    map(str, g)))
def test_card_whole_solves_are_the_plain_recurrences_bit_for_bit(
        card, fresh_bodies, monkeypatch, grid, form):
    """A whole solve with the kernels against the same solve with the
    torch operations of the plain version, both on the card (each block
    captured and replayed): w, k, ζ, β and diff bit for bit, the golden
    count, and one launch of each kernel a driven step."""
    p = Problem(M=grid[0], N=grid[1])
    launch.reset_launch_counts()
    got = solve_state(p, form, card)
    counted = launched()
    with monkeypatch.context() as m:
        m.setattr(Recurrence, "step_size", Recurrence.step_size_plain)
        m.setattr(Recurrence, "close", Recurrence.close_plain)
        fused_cg._device_canvases.cache_clear()
        fs._shard_canvases.cache_clear()
        launch.reset_launch_counts()
        want = solve_state(p, form, card)
        assert launched() == dict.fromkeys(KEYS, 0)
    k = int(got.k)
    assert k == int(want.k) == GRIDS[grid]
    steps = driven_steps(k, p.iteration_cap)
    assert counted == dict.fromkeys(KEYS, steps)
    for name in ("k", "done", "zr", "beta", "diff"):
        assert same_bits(getattr(got, name), getattr(want, name)), name
    ws = got.w if isinstance(got.w, tuple) else (got.w,)
    wants = want.w if isinstance(want.w, tuple) else (want.w,)
    assert all(same_bits(a, b) for a, b in zip(ws, wants))
