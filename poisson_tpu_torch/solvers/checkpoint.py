"""Checkpoint and resume for long solves (counterpart of
``poisson_tpu/solvers/checkpoint.py``).

A checkpointed solve runs as chunks of its loop; after each chunk the
portable full-grid CG state (w, r, z, p, ζ, k and the verdict fields) is
written to one ``.npz`` file, and a restart for the same problem resumes
from the last chunk boundary. Chunking changes no iterate: the loop bodies
freeze a done state and a chunk stops at min(k + chunk, cap).

The file is the JAX package's, byte for byte in its payload: the same keys
(``_STATE_KEYS``), the same dtypes and 0-d shapes (k int32, done bool, zr
and diff in the state's type, flag and stall int32; the fused solvers write
best as float64 inf), the same problem fingerprint string and the same
CRC32 over the payload. So a file written by either package resumes in the
other, on any canvas and any path that shares its fingerprint.

Hardening, as in the JAX package:

- writes are atomic (tmp + ``os.replace``) and CRC-sealed, so a truncated
  or bit-flipped file is detected, never resumed;
- ``keep_last`` generations are kept as ``path``, ``path.1``, …, and the
  loader falls back through them when the newest is corrupt or was written
  for another problem;
- a state whose verdict is FLAG_NONFINITE is never written.

- a state whose verdict is FLAG_INTEGRITY (the integrity probe's) is never
  written either: the CRC would seal its corrupt buffers.

Telemetry, by the JAX package's names (``obs``): the counters
``checkpoint.writes``, ``checkpoint.corrupt``, ``checkpoint.crc_failures``,
``checkpoint.generation_fallbacks`` and ``checkpoint.deadline_stops``, an
event beside each, and the ``checkpoint.write`` span around a write. The
``watchdog`` hook of :func:`run_chunked` takes a
``parallel.watchdog.Watchdog`` (or any object with its methods), and the
chunked solves take the stream and the integrity probe
(``stream_every``, ``verify_every``, ``verify_tol``). ``history=True``
feeds each chunk boundary's (k, ‖Δw‖) to the forecast residual-history
sink (``obs.forecast``), host side only, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
import os
import warnings
import zlib
from typing import Optional

import numpy as np
import torch

from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.mg.hierarchy import DEFAULT_MG, mg_config_for
from poisson_tpu_torch.mg.preconditioner import mg_solve_setup
from poisson_tpu_torch.solvers.pcg import (
    FLAG_CONVERGED,
    FLAG_DEADLINE,
    FLAG_INTEGRITY,
    FLAG_NONE,
    FLAG_NONFINITE,
    PCGResult,
    PCGState,
    chunked_advance,
    gate_rhs,
    init_state,
    make_pcg_body,
    resolve_verify_tol,
    solve_setup,
)

_STATE_KEYS = ("k", "done", "w", "r", "z", "p", "zr", "diff",
               "flag", "best", "stall")
# Verdict fields absent from older files resume as a clean slate.
_OPTIONAL_DEFAULTS = {"flag": np.int32(0), "best": np.inf,
                      "stall": np.int32(0)}


class CorruptCheckpointError(RuntimeError):
    """The checkpoint file exists but cannot be trusted: unreadable npz,
    missing payload keys, or CRC mismatch."""


def _fingerprint(problem: Problem, dtype_name: str, scaled: bool,
                 preconditioner: str = "jacobi", mg_config=None) -> str:
    """The problem's identity, the JAX package's string: every field but
    ``max_iter`` (a capped run may resume with a larger budget), the
    state's type name and the scaling; for a preconditioner other than
    Jacobi also its name and the cycle config (z and p are M⁻¹-derived, so
    a state never resumes under another M⁻¹). The Jacobi string is the
    one files have always carried."""
    fields = {
        f.name: getattr(problem, f.name)
        for f in dataclasses.fields(problem)
        if f.name != "max_iter"
    }
    if preconditioner not in (None, "jacobi"):
        return repr((sorted(fields.items()), dtype_name, scaled,
                     preconditioner, mg_config or DEFAULT_MG))
    return repr((sorted(fields.items()), dtype_name, scaled))


def _host(x) -> np.ndarray:
    """A state field as a numpy array; a bfloat16 one as its 2-byte words
    (numpy has no bfloat16), the ``V2`` records the JAX package's files
    hold for it."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view("V2")
        return x.numpy()
    return np.asarray(x)


def _tensor(arr) -> torch.Tensor:
    """The inverse of :func:`_host`: a ``V2`` array back to bfloat16."""
    arr = np.array(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _state_flag(state) -> Optional[int]:
    """Termination verdict of a solver state, or None for the fused and CA
    states, which track none."""
    flag = getattr(state, "flag", None)
    return None if flag is None else int(flag)


def _converged(state) -> bool:
    """True only for a converged stop: a breakdown, divergence or
    stagnation also sets ``done`` but keeps its checkpoint."""
    if not bool(state.done):
        return False
    flag = _state_flag(state)
    return True if flag is None else flag == FLAG_CONVERGED


def run_chunked(state, *, advance, to_portable, path: Optional[str],
                fingerprint: str, cap: int, keep_checkpoint: bool,
                primary=None, sync=None,
                keep_last: int = 2, watchdog=None, on_chunk=None,
                deadline=None, history: bool = False):
    """The chunked driver loop shared by the checkpointed solvers: advance
    until done or ``cap``, persist ``to_portable(state)`` after every chunk,
    and remove a converged run's files (a cap-hit keeps them).
    ``path=None`` runs the same loop without persistence.

    ``primary`` (``() -> bool``) and ``sync`` (``(name) -> None``) gate the
    write and the removal to one process and order them against the other
    processes' later reads, on a mesh over processes
    (``parallel.checkpoint_sharded``): ``to_portable`` runs on every
    process (it gathers), the primary writes, and ``sync`` is called after
    each write and after the cleanup. They default to one process.

    ``state`` exposes ``.done`` and ``.k``; ``advance(state)`` runs one
    chunk. Hooks: ``deadline`` (``expired() -> bool``) stops the loop
    before a chunk once it has expired; ``watchdog`` (``start()``,
    ``beat(k=, diff=)``, ``stop()``, ``raise_if_fired()``) is beaten at
    every chunk boundary; ``on_chunk(state, chunks_done)`` runs after each
    chunk is persisted and may return a replacement state; ``history``
    taps each boundary's (k, ‖Δw‖) into ``obs.forecast.history_tap``."""
    primary = primary if primary is not None else (lambda: True)
    sync = sync if sync is not None else (lambda name: None)
    if watchdog is not None:
        watchdog.start()
    chunks_done = 0
    try:
        while (not bool(state.done)) and int(state.k) < cap:
            if deadline is not None and deadline.expired():
                # The last persisted generation is the partial answer.
                obs.inc("checkpoint.deadline_stops")
                obs.event("checkpoint.deadline_stop", k=int(state.k),
                          chunks=chunks_done)
                break
            state = advance(state)
            chunks_done += 1
            if watchdog is not None:
                watchdog.beat(k=int(state.k), diff=float(state.diff))
            if history:
                from poisson_tpu_torch.obs.forecast import history_tap

                history_tap(int(state.k), float(state.diff))
            if _state_flag(state) in (FLAG_NONFINITE, FLAG_INTEGRITY):
                # Never overwrite the last good generation with NaNs or
                # with silently corrupted buffers.
                break
            if _converged(state) and not keep_checkpoint:
                break   # the file would be removed below: skip the write
            if path:
                portable = to_portable(state)   # a collective over processes
                if primary():
                    save_state(path, portable, fingerprint,
                               keep_last=keep_last)
                sync("poisson_ckpt_save")       # the write before any read
            if on_chunk is not None:
                replacement = on_chunk(state, chunks_done)
                state = state if replacement is None else replacement
    except KeyboardInterrupt:
        if watchdog is not None:
            watchdog.raise_if_fired()
        raise
    finally:
        if watchdog is not None:
            watchdog.stop()
    if path and _converged(state) and not keep_checkpoint and primary():
        remove_generations(path, keep_last)
    sync("poisson_ckpt_done")   # the removal before any later solve
    return state


def checkpoint_generations(path: str, keep_last: int = 2) -> list:
    """Candidate checkpoint paths, newest first: ``path``, ``path.1``, …"""
    keep_last = max(1, int(keep_last))
    return [path] + [f"{path}.{i}" for i in range(1, keep_last)]


def remove_generations(path: str, keep_last: int = 2) -> None:
    """Delete every retained generation (a converged solve's cleanup)."""
    for candidate in checkpoint_generations(path, keep_last):
        if os.path.exists(candidate):
            os.remove(candidate)


def _payload_crc(fingerprint: str, arrays: dict) -> int:
    """CRC32 over the fingerprint and, in key order, each array's key,
    dtype string, shape string and bytes (the JAX package's rule; a bf16
    field, held as ``V2`` records, is named ``bfloat16`` as JAX names it
    when it writes one)."""
    crc = zlib.crc32(fingerprint.encode())
    for key in sorted(arrays):
        a = np.ascontiguousarray(arrays[key])
        dtype = "bfloat16" if a.dtype.kind == "V" else str(a.dtype)
        crc = zlib.crc32(key.encode(), crc)
        crc = zlib.crc32(dtype.encode(), crc)
        crc = zlib.crc32(str(a.shape).encode(), crc)
        crc = zlib.crc32(a, crc)
    return crc & 0xFFFFFFFF


def save_state(path: str, state: PCGState, fingerprint: str,
               keep_last: int = 2) -> None:
    """Atomically persist ``state`` (tensors or arrays, on any device):
    write a tmp file sealed with the payload CRC, rotate the older
    generations (``path`` → ``path.1`` → …, ``keep_last`` in all), then
    ``os.replace`` it into place."""
    arrays = {key: _host(val) for key, val in zip(_STATE_KEYS, state)}
    tmp = f"{path}.{os.getpid()}.tmp.npz"   # savez appends .npz otherwise
    try:
        with obs.span("checkpoint.write", fence=False, path=path):
            np.savez(tmp, fingerprint=np.asarray(fingerprint),
                     crc32=np.uint32(_payload_crc(fingerprint, arrays)),
                     **arrays)
            generations = checkpoint_generations(path, keep_last)
            for older, newer in zip(reversed(generations[1:]),
                                    reversed(generations[:-1])):
                if os.path.exists(newer):
                    os.replace(newer, older)
            os.replace(tmp, path)
        obs.inc("checkpoint.writes")
        obs.event("checkpoint.write", path=path, k=int(arrays["k"]))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read_state(path: str, fingerprint: str) -> PCGState:
    """Read and verify one checkpoint file into a PCGState of CPU tensors
    (k, flag, stall int32; done bool; zr, diff, best in the arrays' type).
    Raises CorruptCheckpointError for anything untrustworthy and ValueError
    for a fingerprint mismatch."""
    try:
        with np.load(path) as data:
            if "fingerprint" not in data:
                raise CorruptCheckpointError(
                    f"checkpoint {path} has no fingerprint record")
            saved = str(data["fingerprint"])
            vals = {}
            for key in _STATE_KEYS:
                if key in data:
                    vals[key] = data[key]
                elif key in _OPTIONAL_DEFAULTS:
                    vals[key] = np.asarray(_OPTIONAL_DEFAULTS[key])
                else:
                    raise CorruptCheckpointError(
                        f"checkpoint {path} is missing state array {key!r}")
            stored_crc = int(data["crc32"]) if "crc32" in data else None
    except CorruptCheckpointError:
        raise
    except Exception as e:
        # A truncated zip surfaces as ValueError/OSError, a flipped npy
        # header as SyntaxError and more: anything raised while parsing.
        obs.inc("checkpoint.corrupt")
        obs.event("checkpoint.corrupt", path=path, error=type(e).__name__)
        raise CorruptCheckpointError(
            f"checkpoint {path} is unreadable: {type(e).__name__}: {e}"
        ) from e
    if saved != fingerprint:
        raise ValueError(
            f"checkpoint {path} was written for a different problem "
            f"configuration:\n  saved:     {saved}\n  requested: "
            f"{fingerprint}")
    if stored_crc is not None:
        actual = _payload_crc(saved, vals)
        if actual != stored_crc:
            obs.inc("checkpoint.crc_failures")
            obs.event("checkpoint.crc_failure", path=path,
                      stored=f"{stored_crc:#010x}", payload=f"{actual:#010x}")
            raise CorruptCheckpointError(
                f"checkpoint {path} failed its integrity check (stored CRC32 "
                f"{stored_crc:#010x}, payload {actual:#010x})")
    arrays = {key: _tensor(vals[key]) for key in ("w", "r", "z", "p")}
    dtype = arrays["w"].dtype
    scalar = lambda key, dt: _tensor(vals[key]).to(dt)
    return PCGState(
        k=scalar("k", torch.int32), done=torch.tensor(bool(vals["done"])),
        **arrays, zr=scalar("zr", dtype), diff=scalar("diff", dtype),
        flag=scalar("flag", torch.int32), best=scalar("best", dtype),
        stall=scalar("stall", torch.int32))


def load_state_any(path: str, fingerprints, keep_last: int = 2,
                   ) -> Optional[tuple[PCGState, int]]:
    """Walk the generations newest first, and within each the given
    ``fingerprints`` in order. Returns ``(state, index of the matching
    fingerprint)``, or None if no generation exists or all are corrupt
    (with a warning). A corrupt or mismatched newest generation falls back
    to ``path.1``, … with a warning; a mismatch with nothing older to load
    raises."""
    fingerprints = list(fingerprints)
    mismatch: Optional[ValueError] = None
    existed = 0
    for candidate in checkpoint_generations(path, keep_last):
        if not os.path.exists(candidate):
            continue
        existed += 1
        for index, fingerprint in enumerate(fingerprints):
            try:
                state = _read_state(candidate, fingerprint)
            except CorruptCheckpointError as e:
                warnings.warn(f"{e} — falling back to the previous "
                              "checkpoint generation", RuntimeWarning,
                              stacklevel=3)
                break
            except ValueError as e:
                mismatch = mismatch or e
                continue
            if candidate != path:
                obs.inc("checkpoint.generation_fallbacks")
                obs.event("checkpoint.generation_fallback", path=candidate)
                warnings.warn(f"resuming from older checkpoint generation "
                              f"{candidate} (newest was corrupt or "
                              "mismatched)", RuntimeWarning, stacklevel=3)
            return state, index
    if mismatch is not None:
        raise mismatch
    if existed:
        warnings.warn(f"all {existed} checkpoint generation(s) at {path} are "
                      "corrupt; starting the solve from iteration zero",
                      RuntimeWarning, stacklevel=3)
    return None


def load_state(path: str, fingerprint: str,
               keep_last: int = 2) -> Optional[PCGState]:
    """The newest trustworthy saved state for ``fingerprint``, or None (see
    :func:`load_state_any`)."""
    found = load_state_any(path, [fingerprint], keep_last)
    return None if found is None else found[0]


def _deadline_flag(state, deadline):
    """The state's verdict, or FLAG_DEADLINE when a still-running solve
    stopped because its deadline expired. Result only, never persisted."""
    if (deadline is not None and deadline.expired()
            and _state_flag(state) in (None, FLAG_NONE)):
        return torch.tensor(FLAG_DEADLINE, dtype=torch.int32)
    return state.flag


def _chunked(problem: Problem, chunk: int, dtype, scaled, device,
             check_every: Optional[int], stagnation_window: int,
             preconditioner: str = "jacobi", mg_config=None,
             stream_every: int = 0, verify_every: int = 0,
             verify_tol=None, geometry=None, rhs_gate=None):
    """(setup, advance, init) of the plain solve's chunk loop, the seam of
    every chunked driver (JAX's ``_chunk_ops_advance``): a chunk runs
    min(chunk, cap − k) steps of the body, which freezes a done state. With
    ``preconditioner="mg"`` the body carries the V-cycle. ``stream_every``
    streams from the body; ``verify_every`` arms the integrity probe with
    ``verify_tol`` (None: the dtype's default), and only then does the
    body read the RHS. ``geometry`` swaps the reference ellipse's fields
    for a spec's canvases (and, with MG, its hierarchy). ``rhs_gate``
    scales the RHS after setup, as ``pcg_solve`` does; the returned
    setup carries the gated RHS. ``init`` builds the start state, so that
    the resilient driver can rebuild a rung."""
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    config = mg_config_for(problem, preconditioner, mg_config)
    if config is None:
        setup = solve_setup(problem, dtype, scaled, device,
                            geometry=geometry)
    else:
        setup = mg_solve_setup(problem, dtype, scaled, device, config=config,
                               geometry=geometry)
    if rhs_gate is not None:
        setup = setup._replace(rhs=gate_rhs(setup.rhs, rhs_gate))
    verify_every = int(verify_every)
    tol = (resolve_verify_tol(verify_tol, setup.dtype_name)
           if verify_every > 0 else 0.0)
    body = make_pcg_body(setup.ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm, h1=problem.h1,
                         h2=problem.h2, stagnation_window=stagnation_window,
                         stream_every=int(stream_every),
                         verify_every=verify_every, verify_tol=tol,
                         verify_rhs=setup.rhs if verify_every > 0 else None,
                         preconditioner=setup.preconditioner)
    cap = problem.iteration_cap
    if check_every is None:
        check_every = setup.check_every
    return (setup, chunked_advance(body, chunk, cap, check_every),
            lambda: init_state(setup.ops, setup.rhs))


def _result(setup, state, deadline) -> PCGResult:
    w = state.w * setup.aux if setup.scaled else state.w
    return PCGResult(w=w, iterations=state.k, diff=state.diff,
                     residual_dot=state.zr,
                     flag=_deadline_flag(state, deadline))


def pcg_solve_checkpointed(problem: Problem, checkpoint_path: str,
                           chunk: int = 200, dtype=None, scaled=None,
                           keep_checkpoint: bool = False, keep_last: int = 2,
                           stagnation_window: int = 0, watchdog=None,
                           on_chunk=None, deadline=None, device=None,
                           check_every: Optional[int] = None,
                           preconditioner: str = "jacobi",
                           mg_config=None, stream_every: int = 0,
                           verify_every: int = 0,
                           verify_tol=None) -> PCGResult:
    """The plain solve (``solvers.pcg``) with its state written every
    ``chunk`` iterations and resumed from ``checkpoint_path`` when a
    trustworthy file for this problem exists. Converged runs remove their
    files unless ``keep_checkpoint``; a cap-hit or a divergence keeps them.
    The chunked solve equals the one-shot ``pcg_solve`` bit for bit, with
    either ``preconditioner`` (an MG file carries the cycle config in its
    fingerprint, so it never resumes under Jacobi, nor the reverse).
    ``stream_every``, ``verify_every`` and ``verify_tol`` are
    ``pcg_solve``'s; a FLAG_INTEGRITY stop is never persisted."""
    setup, advance, init = _chunked(problem, chunk, dtype, scaled, device,
                                    check_every, stagnation_window,
                                    preconditioner, mg_config, stream_every,
                                    verify_every, verify_tol)
    if setup.preconditioner != "jacobi":
        obs.inc("mg.solves")    # one driver call is one MG solve
    fp = _fingerprint(problem, setup.dtype_name, setup.scaled,
                      preconditioner, mg_config)
    saved = load_state(checkpoint_path, fp, keep_last=keep_last)
    if saved is None:
        state = init()
    else:
        state = PCGState(*(v.to(setup.rhs.device) for v in saved))
    state = run_chunked(
        state, advance=advance, to_portable=lambda s: s,
        path=checkpoint_path, fingerprint=fp, cap=problem.iteration_cap,
        keep_checkpoint=keep_checkpoint, keep_last=keep_last,
        watchdog=watchdog, on_chunk=on_chunk, deadline=deadline)
    return _result(setup, state, deadline)


def pcg_solve_chunked(problem: Problem, chunk: int = 100, dtype=None,
                      scaled=None, stagnation_window: int = 0,
                      watchdog=None, on_chunk=None, deadline=None,
                      device=None, check_every: Optional[int] = None,
                      preconditioner: str = "jacobi", mg_config=None,
                      stream_every: int = 0, verify_every: int = 0,
                      verify_tol=None, geometry=None,
                      rhs_gate=None, history: bool = False) -> PCGResult:
    """The same chunk loop without persistence: a solve that can be
    stopped at a chunk boundary by its ``deadline`` (FLAG_DEADLINE on the
    result), with the one-shot iterates when it converges (either
    ``preconditioner``). ``stream_every``, ``verify_every``,
    ``verify_tol``, ``geometry`` and ``rhs_gate`` are ``pcg_solve``'s: a
    geometry or gated solve chunked equals its one-shot solve bit for bit
    (the probe checks the gated RHS). (The checkpointed driver takes no
    geometry, as in the JAX package.) ``history`` taps each chunk boundary
    into the forecast history sink (see :func:`run_chunked`)."""
    setup, advance, init = _chunked(problem, chunk, dtype, scaled, device,
                                    check_every, stagnation_window,
                                    preconditioner, mg_config, stream_every,
                                    verify_every, verify_tol, geometry,
                                    rhs_gate)
    if setup.preconditioner != "jacobi":
        obs.inc("mg.solves")    # one driver call is one MG solve
    state = run_chunked(
        init(), advance=advance, to_portable=lambda s: s, path=None,
        fingerprint="", cap=problem.iteration_cap, keep_checkpoint=False,
        watchdog=watchdog, on_chunk=on_chunk, deadline=deadline,
        history=history)
    return _result(setup, state, deadline)
