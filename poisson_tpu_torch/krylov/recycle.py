"""Solver memory: deflation-basis harvest, cache and warm-started solves
(counterpart of ``poisson_tpu/krylov/recycle.py``).

A fleet re-solves the same operator over and over (``geom.cache.hits``
shows the families repeat); this module gives the canvas cache a second
tier, spectral memory.

Harvest (a cache miss, :func:`solve_recycled`): the cold solve runs the
shared PCG body and records the first ``harvest`` normalized residual
directions ``v_k = z_k/√(z_k, r_k)`` (the Lanczos basis the recurrence
already produces) into a ring. The ring write adds no arithmetic to the
body, so the cold iterate is ``pcg_solve``'s bit for bit. On convergence a
host fp64 Rayleigh–Ritz projection over the window yields ``keep``
approximate smallest eigenvectors, and the basis

    W = [ŵ, ritz_1 … ritz_keep]        (ŵ the converged solution's direction)

is cached with its image AW and the inverted coupling E⁻¹ = (WᵀAW)⁻¹, keyed
by (fingerprint, grid box, dtype, scaled, preconditioner, harvest, keep,
device).

Warm solve (a hit): the iterate starts from the Galerkin solution in
span(W), ``x₀ = W E⁻¹ Wᵀb`` (with ŵ in the basis this alone solves a pure
rescaling of the right-hand side), and every search direction is kept
A-orthogonal to W by composing the projector ``H = I − W E⁻¹ (AW)ᵀ`` into
the preconditioner seam (``apply_Dinv → H·M⁻¹``, ``PCGOps._replace``, the
seam MG uses). The body is ``make_pcg_body`` and the start
``restart_state``, unchanged, so every verdict is inherited.

Never a wrong answer: the deflated recurrence keeps the true residual of
the true operator, so a stale or corrupt basis can only slow the solve or
trip a verdict. A warm solve that does not converge falls back to a cold
solve audibly (``krylov.fallbacks`` and a ``krylov.fallback`` event),
dropping the basis. The cache is process-local; :func:`invalidate` drops
entries by fingerprint, harvesting cohort or all at once.

Counters and events are the JAX package's: ``krylov.cache.{hits,misses,
evictions,invalidations}``, ``krylov.harvests``, ``krylov.warm_solves``,
``krylov.iterations_saved``, ``krylov.fallbacks``; ``krylov.fallback`` and
``krylov.invalidate``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry.dsl import fingerprint_of, parse_geometry
from poisson_tpu_torch.krylov import KrylovPolicy, resolve_krylov
from poisson_tpu_torch.solvers.pcg import (
    CHECK_EVERY,
    FLAG_CONVERGED,
    FLAG_NAMES,
    PCGResult,
    drive,
    gate_rhs,
    init_state,
    make_pcg_body,
    resolve_dtype,
    resolve_scaled,
    restart_state,
    scaled_single_device_ops,
    single_device_ops,
    solve_fields,
)
from poisson_tpu_torch.utils.platform import resolve_device

# Guard against a zero ζ in the snapshot normalization (a converged or
# degenerate residual): the recorded direction is then zero and the
# Rayleigh–Ritz filter drops it.
_ZR_FLOOR = 1e-30

# E = WᵀAW conditioning ceiling: trailing Ritz columns are dropped until
# the host fp64 inversion is trustworthy.
_E_COND_MAX = 1e10


class BasisEntry:
    """One cached deflation basis (device tensors and host metadata)."""

    __slots__ = ("W", "AW", "Einv", "nbytes", "cold_iterations", "hw",
                 "fingerprint")

    def __init__(self, W, AW, Einv, cold_iterations: int, hw,
                 fingerprint: str):
        self.W = W
        self.AW = AW
        self.Einv = Einv
        self.nbytes = int(W.nbytes + AW.nbytes + Einv.nbytes)
        self.cold_iterations = int(cold_iterations)
        self.hw = hw                    # hardware cohort that harvested
        self.fingerprint = fingerprint


_CACHE: "OrderedDict[tuple, BasisEntry]" = OrderedDict()


def reset_krylov_cache() -> None:
    """Forget every cached basis (pair it with ``obs.metrics.reset()`` so
    the ``krylov.cache.*`` counters stay consistent with the cache)."""
    _CACHE.clear()


def cache_stats() -> dict:
    """Host-side view of the basis cache (entries, bytes, fingerprints)."""
    return {
        "entries": len(_CACHE),
        "bytes": sum(e.nbytes for e in _CACHE.values()),
        "fingerprints": sorted({e.fingerprint for e in _CACHE.values()}),
    }


def _operator_key(problem: Problem) -> tuple:
    """The Problem fields the operator depends on (not ``f_val``: the RHS
    magnitude rides the Galerkin start's coefficient, linearly)."""
    return (problem.M, problem.N, problem.x_min, problem.x_max,
            problem.y_min, problem.y_max)


def basis_key(problem: Problem, dtype_name: str, scaled: bool,
              fingerprint: str, preconditioner: str,
              kp: KrylovPolicy, device) -> tuple:
    """The cache key: the JAX package's, and the device the basis lives
    on (``cuda`` and ``cuda:<current>`` are one device)."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return (fingerprint, _operator_key(problem), dtype_name,
            bool(scaled), preconditioner, kp.harvest, kp.keep, str(dev))


def has_basis(problem: Problem, dtype=None, scaled=None, geometry=None,
              policy: Optional[KrylovPolicy] = None,
              preconditioner: str = "jacobi", device=None) -> bool:
    """Whether a warm basis exists for this operator (no counter moves)."""
    kp = policy or KrylovPolicy(deflation=True)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    spec = parse_geometry(geometry) if geometry is not None else None
    return basis_key(problem, dtype_name, use_scaled, fingerprint_of(spec),
                     preconditioner, kp, resolve_device(device)) in _CACHE


def invalidate(fingerprint: Optional[str] = None, hw=None,
               reason: str = "", all_entries: bool = False) -> int:
    """Drop cached bases, audibly: by geometry ``fingerprint``, by
    harvesting cohort ``hw``, or ``all_entries``. Returns the number
    dropped; counts ``krylov.cache.invalidations`` per entry and emits one
    ``krylov.invalidate`` event."""
    doomed = [k for k, e in _CACHE.items()
              if all_entries
              or (fingerprint is not None and e.fingerprint == fingerprint)
              or (hw is not None and e.hw == hw)]
    for k in doomed:
        del _CACHE[k]
    if doomed:
        obs.inc("krylov.cache.invalidations", len(doomed))
        obs.event("krylov.invalidate", dropped=len(doomed),
                  reason=reason or "unspecified",
                  fingerprint=str(fingerprint), hw=str(hw))
    return len(doomed)


def poison_basis(fingerprint: Optional[str] = None) -> int:
    """Fault-injection seam: overwrite cached bases with NaNs (silent
    staleness). A poisoned basis gives a non-finite first iterate, which
    the verdict catches and the warm path falls back from. Returns the
    entries poisoned."""
    n = 0
    for entry in _CACHE.values():
        if fingerprint is None or entry.fingerprint == fingerprint:
            entry.W = entry.W * float("nan")
            n += 1
    return n


def _evict_over_budget(budget_bytes: int) -> None:
    total = sum(e.nbytes for e in _CACHE.values())
    while total > budget_bytes and len(_CACHE) > 1:
        _, old = _CACHE.popitem(last=False)
        total -= old.nbytes
        obs.inc("krylov.cache.evictions")


def _ops(problem: Problem, scaled: bool, a, b, aux):
    return (scaled_single_device_ops(problem, a, b, aux) if scaled
            else single_device_ops(problem, a, b, aux))


def _flat(u):
    """A stack (k, M+1, N+1) as (k, n) rows: a view. Every stack here has
    a zero ring, so a product of rows is the interior's inner product."""
    return u.reshape(u.shape[0], -1)


def _solve_harvest(problem: Problem, scaled: bool, m: int, a, b, rhs, aux):
    """The cold solve with the snapshot ring: before step i (i < m) the
    Lanczos direction ``z/√max(ζ, 1e-30)`` goes to slot i, unless the state
    is done (``drive`` runs frozen steps up to its next read; a live
    state's k is i at step i). The step itself is ``make_pcg_body``'s,
    so the iterate is ``pcg_solve``'s bit for bit. Returns (result,
    y-space final iterate, the (m, M+1, N+1) ring)."""
    ops = _ops(problem, scaled, a, b, aux)
    body = make_pcg_body(ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm,
                         h1=problem.h1, h2=problem.h2)
    V = rhs.new_zeros((m,) + tuple(rhs.shape))
    taken = [0]

    def step(s):
        i = taken[0]
        if i < m:
            nrm = torch.sqrt(torch.clamp(s.zr, min=_ZR_FLOOR))
            V[i] = torch.where(s.done, V[i], s.z / nrm)
            taken[0] = i + 1
        return body(s)

    s = drive(step, init_state(ops, rhs), problem.iteration_cap,
              CHECK_EVERY)
    w = s.w * aux if scaled else s.w
    return (PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr,
                      flag=s.flag), s.w, V)


def _apply_stack(problem: Problem, scaled: bool, a, b, aux, V):
    """A applied to a (k, M+1, N+1) stack, one broadcast stencil."""
    ops = _ops(problem, scaled, a, b, aux)
    return ops.apply_A(ops.exchange(V))


def _deflated_ops(problem: Problem, scaled: bool, a, b, aux, W, AW, Einv):
    """The ops bundle with the deflation projector in the preconditioner
    seam: ``apply_Dinv → H·M⁻¹``, ``H = I − W E⁻¹ (AW)ᵀ`` (weighted
    dots), so every search direction stays A-orthogonal to span(W)."""
    ops = _ops(problem, scaled, a, b, aux)
    h1h2 = problem.h1 * problem.h2
    Wf, AWf = _flat(W), _flat(AW)

    def deflate(z):
        d = h1h2 * (AWf @ z.reshape(-1))
        return z - (Wf.T @ (Einv @ d)).reshape(z.shape)

    return ops._replace(apply_Dinv=lambda r: deflate(ops.apply_Dinv(r)))


def _solve_deflated(problem: Problem, scaled: bool, a, b, rhs, aux, W, AW,
                    Einv) -> PCGResult:
    """The warm solve: the Galerkin start ``x₀ = W E⁻¹ (Wᵀb)`` and the
    deflated body to convergence (``restart_state`` + ``make_pcg_body``
    over the deflated ops)."""
    ops = _deflated_ops(problem, scaled, a, b, aux, W, AW, Einv)
    Wf = _flat(W)
    d0 = problem.h1 * problem.h2 * (Wf @ rhs.reshape(-1))
    x0 = (Wf.T @ (Einv @ d0)).reshape(rhs.shape)
    body = make_pcg_body(ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm,
                         h1=problem.h1, h2=problem.h2)
    s = drive(body, restart_state(ops, rhs, x0), problem.iteration_cap,
              CHECK_EVERY)
    w = s.w * aux if scaled else s.w
    return PCGResult(w=w, iterations=s.k, diff=s.diff, residual_dot=s.zr,
                     flag=s.flag)


def _host_gram(U, V, h1h2: float) -> np.ndarray:
    """h1·h2·UᵀV in the stacks' type on their device, then fp64 on the
    host (the JAX package's order)."""
    return (h1h2 * (_flat(U) @ _flat(V).T)).double().cpu().numpy()


def build_basis(problem: Problem, scaled: bool, a, b, aux, y_w, V,
                iterations: int, kp: KrylovPolicy):
    """Rayleigh–Ritz over the snapshot window and the solution direction →
    (W, AW, Einv) tensors, or None when the window is unusable.

    The small eigenproblems run in fp64 numpy on the host (the JAX
    package's code): the generalized form ``H y = θ G y`` absorbs the
    recorded directions' loss of orthogonality, and trailing Ritz columns
    are dropped until E = WᵀAW inverts with cond under ``_E_COND_MAX``."""
    h1h2 = problem.h1 * problem.h2
    n = min(int(iterations), kp.harvest)
    if n < 1:
        return None
    V = V[:n]
    AV = _apply_stack(problem, scaled, a, b, aux, V)
    G = _host_gram(V, V, h1h2)
    H = _host_gram(V, AV, h1h2)
    H = 0.5 * (H + H.T)
    sG, Q = np.linalg.eigh(0.5 * (G + G.T))
    good = sG > max(float(sG.max()) * 1e-8, 1e-12)
    if not good.any():
        return None
    Bred = Q[:, good] / np.sqrt(sG[good])
    theta, U = np.linalg.eigh(Bred.T @ H @ Bred)
    keep = min(kp.keep, int(good.sum()))
    combo = Bred @ U[:, np.argsort(theta)[:keep]]      # n × keep

    sqn = float(h1h2 * torch.sum(y_w[1:-1, 1:-1] ** 2))
    if not np.isfinite(sqn) or sqn <= 0.0:
        return None
    w_dir = (y_w.double() / math.sqrt(sqn)).to(V.dtype)
    C = torch.tensor(combo, dtype=V.dtype, device=V.device)
    ritz = (C.T @ _flat(V)).reshape((keep,) + tuple(V.shape[1:]))
    W = torch.cat([w_dir[None], ritz])
    AW = _apply_stack(problem, scaled, a, b, aux, W)
    E = _host_gram(W, AW, h1h2)
    E = 0.5 * (E + E.T)
    # Shrink until the coupling matrix inverts trustworthily (the solution
    # direction, the warm start, is never dropped).
    cols = E.shape[0]
    while cols > 1 and np.linalg.cond(E[:cols, :cols]) > _E_COND_MAX:
        cols -= 1
    if not np.all(np.isfinite(E[:cols, :cols])):
        return None
    Einv = torch.tensor(np.linalg.inv(E[:cols, :cols]), dtype=V.dtype,
                        device=V.device)
    if cols < W.shape[0]:
        W, AW = W[:cols].clone(), AW[:cols].clone()
    return W, AW, Einv


def solve_recycled(problem: Problem, dtype=None, scaled=None,
                   rhs_gate=None, geometry=None,
                   policy: Optional[KrylovPolicy] = None,
                   preconditioner: str = "jacobi", hw=None,
                   device=None) -> PCGResult:
    """Single solve with fingerprint-keyed solver memory, on ``device``
    (default ``cuda``).

    A hit runs the warm deflated solve (``krylov.cache.hits``,
    ``krylov.warm_solves``; the family's cold count minus the warm count
    lands on ``krylov.iterations_saved``); a warm solve that does not
    converge falls back to a cold solve audibly (``krylov.fallbacks``),
    dropping the basis. A miss runs the harvesting cold solve and, when it
    converges, caches its basis (``krylov.cache.misses``,
    ``krylov.harvests``), LRU-evicted over ``policy.budget_bytes``
    (``krylov.cache.evictions``). ``hw`` tags the entry with the harvesting
    cohort for :func:`invalidate`. ``rhs_gate`` scales the RHS as
    ``pcg_solve``'s does; the key leaves the magnitude out."""
    kp = resolve_krylov(policy or KrylovPolicy(deflation=True))
    if not kp.deflation:
        raise ValueError("solve_recycled needs a deflation-enabled "
                         "KrylovPolicy (deflation=True)")
    if preconditioner not in (None, "jacobi"):
        raise ValueError(
            "solver memory composes with the jacobi (symmetric-scaling) "
            f"body only; preconditioner={preconditioner!r} has no "
            "deflated program yet — run it without deflation")
    dev = resolve_device(device)
    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    spec = parse_geometry(geometry) if geometry is not None else None
    a, b, rhs, aux = solve_fields(problem, dtype_name, use_scaled, dev, spec)
    if rhs_gate is not None:
        rhs = gate_rhs(rhs, rhs_gate)
    fp = fingerprint_of(spec)
    key = basis_key(problem, dtype_name, use_scaled, fp, "jacobi", kp, dev)

    entry = _CACHE.get(key)
    if entry is not None:
        _CACHE.move_to_end(key)
        obs.inc("krylov.cache.hits")
        result = _solve_deflated(problem, use_scaled, a, b, rhs, aux,
                                 entry.W, entry.AW, entry.Einv)
        flag = int(result.flag)
        if flag == FLAG_CONVERGED:
            obs.inc("krylov.warm_solves")
            obs.inc("krylov.iterations_saved",
                    entry.cold_iterations - int(result.iterations))
            return result
        # A stale, poisoned or unlucky basis: fall back to a cold solve,
        # audibly; the basis is dropped and rebuilt below if that
        # converges.
        obs.inc("krylov.fallbacks")
        obs.event("krylov.fallback", fingerprint=fp,
                  verdict=FLAG_NAMES.get(flag, str(flag)),
                  iterations=int(result.iterations))
        invalidate(fingerprint=fp,
                   reason=f"warm-solve-{FLAG_NAMES.get(flag, flag)}")
    else:
        obs.inc("krylov.cache.misses")

    result, y_w, V = _solve_harvest(problem, use_scaled, kp.harvest,
                                    a, b, rhs, aux)
    if int(result.flag) == FLAG_CONVERGED:
        basis = build_basis(problem, use_scaled, a, b, aux, y_w, V,
                            int(result.iterations), kp)
        if basis is not None:
            W, AW, Einv = basis
            _CACHE[key] = BasisEntry(W, AW, Einv, int(result.iterations),
                                     hw, fp)
            obs.inc("krylov.harvests")
            _evict_over_budget(kp.budget_bytes)
    return result
