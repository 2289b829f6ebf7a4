"""The program ledger: a registry of the port's flag-off programs and of
its CUDA kernels (the counterpart of the JAX package's
``contracts/manifest.py``).

Every opt-in subsystem keeps one promise: *off means off* — with its flag
at the default the program is the historical one, with no host read in
the step, no collective and no multigrid product. Each
:class:`ProgramSpec` names one such program by the JAX ledger's name,
runs the port's counterpart at ``Problem(20, 24)`` on the CPU for one
``drive`` block (``max_iter`` = ``CHECK_EVERY``) under an op recorder
(``contracts.trace``), fingerprints the canonical trace and checks its
structure against the committed ``ledger.json``.

Each :class:`KernelSpec` covers one CUDA source of ``ops/csrc/``: its
fingerprint hashes the source bytes, the ``nvcc`` command and arch flags
of ``ops/_build.py`` and the launch configuration read off the source
(every ``__global__``'s launch bounds, the constants they name and every
launch site). It depends on no installed package, so it must match
everywhere: a changed source is always a problem until the ledger is
updated.

A trace fingerprint depends on the PyTorch build (the aten ops an
operator decomposes into). The ledger records ``torch.__version__`` and
the platform the traces ran on; a mismatch where the environment differs
too is reported as ``ledger-environment``, never as a match.

Also here: the registry-drift allowlists (``ATTRIBUTION_ONLY_DETAIL``,
``POLICY_COVERAGE_EXEMPT``), every exemption with its reason.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

from poisson_tpu_torch.contracts.trace import (
    record,
    structural_violations,
    trace_fingerprint,
    trace_text,
)

LEDGER_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "ledger.json")
LEDGER_SCHEMA = "poisson_tpu_torch.contracts.ledger/1"


@dataclass(frozen=True)
class ProgramSpec:
    """One flag-off program under ledger protection. ``build`` sets the
    program up (outside the recorder) and returns the zero-argument call
    that is recorded; ``forbid`` names marker sets of
    ``contracts.trace``."""

    name: str
    description: str
    forbid: Tuple[str, ...]
    build: Callable[[], Callable[[], object]]


# -- program builders: 20×24, one drive block, on the CPU ---------------

def _problem():
    from poisson_tpu_torch.config import Problem
    from poisson_tpu_torch.solvers.pcg import CHECK_EVERY

    return Problem(M=20, N=24, max_iter=CHECK_EVERY)


def _setup(dtype_name: str, scaled: bool, members: bool = False):
    from poisson_tpu_torch.solvers.pcg import solve_setup

    return solve_setup(_problem(), dtype_name, scaled, "cpu",
                       members=members)


def _fields():
    from poisson_tpu_torch.solvers.pcg import solve_fields

    return solve_fields(_problem(), "float64", False, "cpu")


def _build_solve(dtype_name: str, scaled: bool, history_every: int = 0):
    from poisson_tpu_torch.solvers.pcg import run_setup

    p, setup = _problem(), _setup(dtype_name, scaled)
    return lambda: run_setup(p, setup, setup.rhs,
                             history_every=history_every)


def _build_solve_jacobi_f64():
    return _build_solve("float64", False)


def _build_solve_scaled_f32():
    return _build_solve("float32", True)


def _build_solve_history_f64():
    """``history_every=5``: the forecast seam's opt-in program (host
    reads legal at ``drive``'s flush; collectives and MG still not)."""
    return _build_solve("float64", False, history_every=5)


def _batched_stack():
    import torch

    rhs = _setup("float64", False).rhs
    return torch.stack([rhs, rhs * 1.1])


def _build_batched_mesh_none():
    from poisson_tpu_torch.solvers.batched import solve_batched

    p, stack = _problem(), _batched_stack()
    return lambda: solve_batched(p, rhs_stack=stack, dtype="float64",
                                 device="cpu")


def _build_batched_mode_independent():
    """``solve_batched(mode="independent")``, the Krylov flag-off default,
    through the entry point's branch: its trace must equal
    ``batched.mesh_none_f64``'s."""
    from poisson_tpu_torch.krylov import (
        KRYLOV_INDEPENDENT,
        KrylovPolicy,
        resolve_krylov,
    )
    from poisson_tpu_torch.solvers.batched import solve_batched

    if (resolve_krylov(None).mode != KRYLOV_INDEPENDENT
            or KrylovPolicy().mode != KRYLOV_INDEPENDENT):
        raise AssertionError("the Krylov default is no longer the "
                             "independent mode")
    p, stack = _problem(), _batched_stack()
    return lambda: solve_batched(p, rhs_stack=stack, dtype="float64",
                                 device="cpu", mode=KRYLOV_INDEPENDENT)


def _lanes():
    from poisson_tpu_torch.solvers.lanes import LaneBatch

    return LaneBatch(_problem(), 2, dtype="float64", chunk=25, device="cpu")


def _build_lanes_step_geometry_off():
    lanes = _lanes()
    lanes.splice("m0", 1.0)
    lanes.splice("m1", 1.1)
    return lanes.step


def _build_member_init():
    lanes = _lanes()
    return lambda: lanes.splice("m0", 1.0)


def _build_chunk_verify_off():
    from poisson_tpu_torch.solvers.checkpoint import _chunked

    _, advance, init = _chunked(_problem(), 50, "float64", False, "cpu",
                                None, 0)
    state = init()
    return lambda: advance(state)


def _build_stencil_apply_A():
    import torch

    from poisson_tpu_torch.ops.stencil import apply_A

    p = _problem()
    a, b, _, _ = _fields()
    w = torch.zeros(p.grid_shape, dtype=torch.float64)
    return lambda: apply_A(w, a, b, p.h1, p.h2)


def _build_session_step_cold():
    """A session's cold Poisson step: ``session_step_solve`` with no warm
    iterate calls ``pcg_solve``, whose loop is ``run_setup`` on the plain
    setup, so the trace must equal ``solve.jacobi_f64``'s."""
    return _build_solve("float64", False)


def _build_session_warm_f64():
    import torch

    from poisson_tpu_torch.solvers.session import _solve_warm

    p = _problem()
    a, b, rhs, aux = _fields()
    w0 = torch.zeros(p.grid_shape, dtype=torch.float64)
    return lambda: _solve_warm(p, False, a, b, rhs, aux, w0)


def _build_session_heat(warm: bool):
    import torch

    from poisson_tpu_torch.solvers.session import (
        _solve_shifted,
        shifted_setup,
    )

    p = _problem()
    a, b, rhs0, aux = shifted_setup(p, None, "float64", False, 0.5, "cpu")
    m = torch.tensor(0.5, dtype=torch.float64)
    u = torch.zeros(p.grid_shape, dtype=torch.float64)
    return lambda: _solve_shifted(p, False, warm, a, b, rhs0, aux, m, u, u)


def _build_session_heat_cold():
    return _build_session_heat(False)


def _build_session_heat_warm():
    return _build_session_heat(True)


def _build_serve_routed_default():
    """What a router-enabled service runs: every arm's executor is the
    ``torch`` solve (the gate is closed, as JAX's maps every arm to
    ``xla``), so the trace must equal ``solve.jacobi_f64``'s. If the gate
    opens this is no longer the flag-off program and the pin must be
    revisited on purpose."""
    from poisson_tpu_torch.serve.router import BACKEND_TORCH, executor_backend

    for arm in ("torch", "resident", "ca"):
        if executor_backend(arm) != BACKEND_TORCH:
            raise AssertionError(
                f"executor_backend({arm!r}) no longer gates to torch — "
                "the routed default program is not the flag-off program "
                "any more")
    return _build_solve("float64", False)


_ALL_OFF = ("callbacks", "collectives", "mg")

PROGRAMS: Tuple[ProgramSpec, ...] = (
    ProgramSpec("solve.jacobi_f64",
                "pcg_solve's loop (jacobi, stream/verify/history off, fp64 "
                "unscaled): the flag-off program every golden count rests "
                "on", _ALL_OFF, _build_solve_jacobi_f64),
    ProgramSpec("solve.scaled_f32",
                "pcg_solve's scaled fp32 loop, all flags off",
                _ALL_OFF, _build_solve_scaled_f32),
    ProgramSpec("solve.history_f64",
                "pcg_solve with history_every=5 — the forecast seam's "
                "opt-in program (host reads legal at drive's flush; "
                "collectives/mg still forbidden)",
                ("collectives", "mg"), _build_solve_history_f64),
    ProgramSpec("batched.mesh_none_f64",
                "solve_batched with mesh=None — the single-device batch "
                "(no collective ever)", _ALL_OFF, _build_batched_mesh_none),
    ProgramSpec("lanes.step_geometry_off",
                "LaneBatch.step, geometry/verify off — the continuous "
                "engine's flag-off lane step", _ALL_OFF,
                _build_lanes_step_geometry_off),
    ProgramSpec("chunk.verify_off",
                "one chunk of the chunked drivers' advance, stream/verify "
                "off", _ALL_OFF, _build_chunk_verify_off),
    ProgramSpec("lanes.member_init",
                "LaneBatch.splice — the member init every spliced member "
                "runs", _ALL_OFF, _build_member_init),
    ProgramSpec("batched.mode_independent_f64",
                "solve_batched mode='independent' (the Krylov flag-off "
                "default) — fingerprint equals batched.mesh_none_f64",
                _ALL_OFF, _build_batched_mode_independent),
    ProgramSpec("stencil.apply_A_unbatched",
                "the unbatched 5-point stencil application (2D)",
                _ALL_OFF, _build_stencil_apply_A),
    ProgramSpec("session.step_cold_f64",
                "a session's cold Poisson step — fingerprint equals "
                "solve.jacobi_f64", _ALL_OFF, _build_session_step_cold),
    ProgramSpec("session.warm_f64",
                "the warm-started session step (restart_state from the "
                "previous iterate; the same flag-off body)",
                _ALL_OFF, _build_session_warm_f64),
    ProgramSpec("session.heat_cold_f64",
                "one implicit-Euler heat step (A + m·I), zero start",
                _ALL_OFF, _build_session_heat_cold),
    ProgramSpec("session.heat_warm_f64",
                "the warm implicit-Euler heat step (restart from the "
                "previous time level)", _ALL_OFF, _build_session_heat_warm),
    ProgramSpec("serve.routed_default_f64",
                "what a router-enabled service runs: every arm gates to "
                "the torch executor, so the trace equals "
                "solve.jacobi_f64's — the router changes attribution, "
                "never numerics", _ALL_OFF, _build_serve_routed_default),
)

# Pairs whose fingerprints must be equal (JAX's ledger asserts the same
# equalities in its tests).
EQUAL_PROGRAMS = (("session.step_cold_f64", "solve.jacobi_f64"),
                  ("serve.routed_default_f64", "solve.jacobi_f64"),
                  ("batched.mode_independent_f64", "batched.mesh_none_f64"))


# -- the CUDA sources ---------------------------------------------------

@dataclass(frozen=True)
class KernelSpec:
    """One CUDA source of ``ops/csrc`` and the kernels it holds."""

    name: str
    kernels: str


KERNEL_SOURCES: Tuple[KernelSpec, ...] = (
    KernelSpec("fused_cg", "A, B and their sharded forms; the recurrence's "
               "two halves"),
    KernelSpec("ca_cg", "C, D and their sharded forms"),
    KernelSpec("resident_cg", "R"),
    KernelSpec("blocked_cg", "A′, B′"),
    KernelSpec("serial_sum", "S"),
)

_COMMENT_RE = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_CONST_RE = re.compile(r"constexpr\s+[\w ]+?\s+(k\w+)\s*=\s*([^;]+);")
_GLOBAL_RE = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\(([^)]*)\)\s+)?(\w+)\s*\(")
_TRIPLE_RE = re.compile(r"(\w+)\s*<<<([^>]*)>>>")
_COOP_RE = re.compile(r"cudaLaunchCooperativeKernel\s*\(([^;]*)\);", re.S)
_EX_RE = re.compile(r"cudaLaunchKernelEx\s*\(([^;]*)\);", re.S)
_CFG_RE = re.compile(r"\b((?:cfg|attr\[\d+\])\.[\w.]+)\s*=\s*([^;]+);")


def _squash(text: str) -> str:
    return " ".join(text.split())


def launch_configuration(source: str) -> dict:
    """The launch configuration a CUDA source states: its ``k*``
    constants, each ``__global__``'s launch bounds, and every launch site
    (``<<<…>>>``, cooperative and ``cudaLaunchKernelEx`` with its
    ``cfg``/``attr`` settings), as written (comments dropped)."""
    code = _COMMENT_RE.sub("", source)
    return {
        "constants": {name: _squash(expr)
                      for name, expr in _CONST_RE.findall(code)},
        "globals": {name: _squash(bounds or "")
                    for bounds, name in _GLOBAL_RE.findall(code)},
        "launches": (
            [f"{name}<<<{_squash(cfg)}>>>"
             for name, cfg in _TRIPLE_RE.findall(code)]
            + [f"cooperative({_squash(args)})"
               for args in _COOP_RE.findall(code)]
            + [f"ex({_squash(args)})" for args in _EX_RE.findall(code)]
            + [f"{lhs} = {_squash(rhs)}"
               for lhs, rhs in _CFG_RE.findall(code)]),
    }


def nvcc_command(name: str) -> list:
    """The build command of ``ops/_build.py`` for source ``name``, with
    the paths as the repo names them (no machine's paths)."""
    from poisson_tpu_torch.ops._build import NVCC_FLAGS

    return ["nvcc", *NVCC_FLAGS, "-o", f"ops/build/{name}-<hash>.so",
            f"ops/csrc/{name}.cu"]


def kernel_entry(spec: KernelSpec, csrc: Optional[str] = None) -> dict:
    """The ledger entry of one CUDA source: the sha256 of its bytes, the
    build command and its launch configuration, each hashed alone and
    together."""
    from poisson_tpu_torch.ops._build import CSRC

    path = os.path.join(csrc or str(CSRC), f"{spec.name}.cu")
    with open(path, "rb") as f:
        data = f.read()
    launch = launch_configuration(data.decode("utf-8"))
    command = nvcc_command(spec.name)
    parts = {
        "source_sha256": hashlib.sha256(data).hexdigest(),
        "nvcc": command,
        "launch": launch,
    }
    blob = json.dumps(parts, sort_keys=True).encode("utf-8")
    return {
        "fingerprint": hashlib.sha256(blob).hexdigest(),
        "source_sha256": parts["source_sha256"],
        "nvcc_sha256": hashlib.sha256(
            json.dumps(command).encode("utf-8")).hexdigest(),
        "launch_sha256": hashlib.sha256(json.dumps(
            launch, sort_keys=True).encode("utf-8")).hexdigest(),
        "kernels": spec.kernels,
        "globals": sorted(launch["globals"]),
    }


def _environment() -> dict:
    import torch

    return {"torch_version": torch.__version__, "platform": "cpu"}


def record_program(spec: ProgramSpec) -> list:
    """The canonical trace lines of one registered program."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)   # one op sequence whatever the host
    try:
        return record(spec.build())
    finally:
        torch.set_num_threads(threads)


def load_ledger(path: Optional[str] = None) -> Optional[dict]:
    try:
        with open(path or LEDGER_PATH) as f:
            ledger = json.load(f)
    except (OSError, ValueError):
        return None
    return ledger if isinstance(ledger, dict) else None


def run_ledger_check(update: bool = False, path: Optional[str] = None,
                     csrc: Optional[str] = None,
                     programs: Tuple[ProgramSpec, ...] = PROGRAMS) -> dict:
    """Record every registered program and hash every CUDA source, and
    check them against the committed ledger. Returns a report whose
    ``problems`` (each ``{kind, program, message}``) is empty when the
    contract holds. ``update=True`` rewrites the ledger from this tree;
    structural violations and programs that fail to run are never
    written. ``programs`` (default: the registry) and ``csrc`` (the CUDA
    sources' directory) are the tests' seams."""
    path = path or LEDGER_PATH
    env = _environment()
    ledger = load_ledger(path)
    problems: list = []
    entries: dict = {}
    kernels: dict = {}
    if ledger is None and not update:
        problems.append({
            "kind": "ledger-absent", "program": "*",
            "message": (f"committed ledger missing or unreadable at "
                        f"{path} — restore it from version control, or "
                        f"mint a reviewed one with --update-ledger")})
    committed_env = {k: (ledger or {}).get(k) for k in env}
    env_differs = ledger is not None and committed_env != env
    for spec in programs:
        try:
            lines = record_program(spec)
        except Exception as e:   # a program that no longer runs is drift
            problems.append({"kind": "trace-error", "program": spec.name,
                             "message": f"entry point failed: {e!r}"})
            continue
        bad = structural_violations(lines, spec.forbid)
        if bad:
            problems.append({
                "kind": "trace-structure", "program": spec.name,
                "message": (f"forbidden op(s) {bad} in the flag-off "
                            f"program — never ledgerable")})
        fp = trace_fingerprint(lines)
        entries[spec.name] = {
            "fingerprint": fp,
            "ops": len(lines),
            "canonical_bytes": len(trace_text(lines)),
            "forbid": list(spec.forbid),
            "description": spec.description,
        }
        if update or ledger is None:
            continue
        committed = (ledger.get("entries") or {}).get(spec.name)
        if committed is None:
            problems.append({
                "kind": "ledger-missing", "program": spec.name,
                "message": ("program is registered but absent from the "
                            "committed ledger — run --update-ledger and "
                            "commit")})
        elif committed.get("fingerprint") != fp:
            if env_differs:
                problems.append({
                    "kind": "ledger-environment", "program": spec.name,
                    "message": (
                        f"trace differs and so does the environment: "
                        f"ledger {committed_env} vs current {env} — not "
                        f"confirmed; re-run where the ledger was minted "
                        f"before judging")})
            else:
                problems.append({
                    "kind": "ledger-drift", "program": spec.name,
                    "message": (
                        f"flag-off trace changed: committed "
                        f"{committed.get('fingerprint', '?')[:16]}…, "
                        f"current {fp[:16]}… — an intentional change "
                        f"needs --update-ledger + review; anything else "
                        f"is the drift this gate exists for")})
    for a, b in EQUAL_PROGRAMS:
        if a in entries and b in entries and (
                entries[a]["fingerprint"] != entries[b]["fingerprint"]):
            problems.append({
                "kind": "trace-equality", "program": a,
                "message": f"must trace exactly as {b} and does not"})
    for spec in KERNEL_SOURCES:
        name = f"kernels.{spec.name}"
        try:
            kernels[name] = kernel_entry(spec, csrc)
        except OSError as e:
            problems.append({"kind": "kernel-source", "program": name,
                             "message": f"CUDA source unreadable: {e}"})
            continue
        if update or ledger is None:
            continue
        committed = (ledger.get("kernels") or {}).get(name)
        if committed is None:
            problems.append({
                "kind": "ledger-missing", "program": name,
                "message": "kernel source absent from the committed "
                           "ledger — run --update-ledger and commit"})
        elif committed.get("fingerprint") != kernels[name]["fingerprint"]:
            changed = [part for part in ("source", "nvcc", "launch")
                       if committed.get(f"{part}_sha256")
                       != kernels[name][f"{part}_sha256"]]
            problems.append({
                "kind": "kernel-drift", "program": name,
                "message": (f"the kernel's {'/'.join(changed) or 'entry'} "
                            f"changed — rebuild and re-verify it on the "
                            f"card against its plain version, then "
                            f"--update-ledger")})
    registered = {s.name for s in PROGRAMS} | {s.name for s in programs} | {
        f"kernels.{s.name}" for s in KERNEL_SOURCES}
    stale = (set((ledger or {}).get("entries") or {})
             | set((ledger or {}).get("kernels") or {})) - registered
    for name in sorted(stale):
        problems.append({"kind": "ledger-stale", "program": name,
                         "message": "ledger entry has no registered "
                                    "program — remove it via "
                                    "--update-ledger"})
    report = {
        "schema": "poisson_tpu_torch.contracts.ledger-check/1",
        "ledger": path,
        "environment": env,
        "programs": len(programs),
        "kernels": len(KERNEL_SOURCES),
        "entries": entries,
        "kernel_entries": kernels,
        "problems": problems,
        "updated": False,
    }
    never = ("trace-structure", "trace-error", "trace-equality",
             "kernel-source")
    if update and not any(p["kind"] in never for p in problems):
        with open(path, "w") as f:
            json.dump({"schema": LEDGER_SCHEMA, **env, "entries": entries,
                       "kernels": kernels}, f, indent=1, sort_keys=True)
            f.write("\n")
        report["updated"] = True
        report["problems"] = [p for p in problems if p["kind"] in never]
    return report


# -- registry-drift allowlists (reason strings required) ---------------

# Detail keys of the port's bench that are attribution or diagnosis
# payload, not experiment identity — everything else a bench mode emits
# must join benchmarks/regress.py's cohort key (see contracts.drift).
# bench.py's list, plus the port's "timing".
ATTRIBUTION_ONLY_DETAIL = {
    # measurement payload & derived readings
    "iterations": "the measured quantity, not identity",
    "iterations_match_sequential": "parity verdict on the measurement",
    "converged": "outcome tally of the measurement",
    "batch_seconds": "raw timing payload",
    "sequential_solve_seconds": "raw timing payload",
    "first_run_seconds": "compile-time payload",
    "solve_seconds": "raw timing payload",
    "warmup_seconds": "compile-time payload",
    "makespan_seconds": "raw timing payload",
    "p50_seconds": "latency payload (p99 is the record's own metric)",
    "p99_seconds": "latency payload",
    "forecast_calibration_err_pct":
        "measured forecaster error, not identity — records_from_result "
        "lifts it into its own obs.forecast.calibration_err_pct "
        "sentinel record (lower-is-better), it never splits the "
        "primary record's cohort",
    "verify_overhead": "the A/B delta is the record's payload",
    "preconditioner_ab": "both-arm A/B payload (cohort key carries "
                         "detail.preconditioner)",
    # request-mix tallies (outcomes, not offered-load identity)
    "requests": "offered count; arrival_rate is the identity",
    "completed": "outcome tally",
    "errors": "outcome tally",
    "shed": "outcome tally",
    "lost": "invariant check (bench exits 1 when nonzero)",
    "quarantines": "churn outcome tally",
    "device_losses": "churn outcome tally",
    "placement_rebinds": "churn outcome tally",
    "kill_fired": "whether the injected fault actually fired (fault_"
                  "load is relabeled clean when it did not)",
    "kill_worker_at": "fault timing detail under fault_load",
    "kill_device_at": "fault timing detail under fault_load",
    "scheduling": "engine name is carried by the metric itself "
                  "(sustained vs drain gauges)",
    "batch": "solve_batched pads to detail.bucket; grid+bucket are "
             "the executable identity",
    "bucket": "executable width, derivable from batch; grid is the "
              "cohort axis",
    "geometry_fingerprints": "operand identity, never cohort identity "
                             "(the PR 9 invariant)",
    "geom_cache_hits": "cache telemetry snapshot",
    "geom_cache_misses": "cache telemetry snapshot",
    "bucket_cache_hits": "cache telemetry snapshot",
    "bucket_cache_misses": "cache telemetry snapshot",
    "refill_splices": "refill telemetry snapshot",
    "warmed_buckets": "warm-up inventory",
    "device_kind": "device_topology/devices carry the cohort "
                   "topology; kind is diagnosis",
    "placement": "registry snapshot payload",
    "p99_exemplar": "flight-recorder trace id (pinned attribution-only "
                    "by tests/test_flight.py)",
    "slowest_requests": "flight-recorder decompositions (pinned "
                        "attribution-only by tests/test_flight.py)",
    # A/B second-arm payload: the record's value/cohort is the
    # continuous arm; the drain arm rides along for the comparison.
    "continuous_beats_drain": "A/B verdict over both arms",
    "drain_solves_per_sec": "drain-arm payload (its own gauge exists)",
    "drain_p50_seconds": "drain-arm latency payload",
    "drain_p99_seconds": "drain-arm latency payload",
    "drain_makespan_seconds": "drain-arm timing payload",
    "idle_lane_steps": "refill telemetry snapshot",
    # fleet-churn outcome tallies and invariant verdicts
    "device_loss_fired": "whether the injected loss actually fired "
                         "(fault_load relabels clean when not)",
    "every_request_accounted": "ledger-invariant verdict (bench exits "
                               "1 when false)",
    "recovered_requests": "churn outcome tally",
    "restarts": "churn outcome tally",
    "sticky_hits": "routing telemetry snapshot",
    # single-solve / verify-A/B measurement payload
    "final_diff": "convergence payload of the measurement",
    "l2_error_vs_analytic": "accuracy payload of the measurement",
    "serial_reduce": "timing-methodology note",
    "timing": "timing-methodology note (best of fenced solves, no "
              "chained slope)",
    "iterations_baseline": "unverified-arm payload of the A/B record",
    # Krylov-memory A/B and repeat-fingerprint payload (cohort key
    # carries detail.krylov_mode / detail.deflation /
    # detail.repeat_fingerprint)
    "krylov_block_ab": "both-arm A/B payload (cohort key carries "
                       "detail.krylov_mode)",
    "cold_requests": "arm-size tally of the one run",
    "warm_requests": "arm-size tally of the one run",
    "cold_p50_seconds": "cold-arm latency payload (the record's value "
                        "is the run's sustained throughput)",
    "cold_p99_seconds": "cold-arm latency payload",
    "warm_p50_seconds": "warm-arm latency payload",
    "warm_p99_seconds": "warm-arm latency payload",
    "krylov_hit_rate": "basis-cache telemetry snapshot",
    "krylov_harvests": "basis-cache telemetry snapshot",
    "krylov_iterations_saved": "basis-cache telemetry snapshot",
    "krylov_fallbacks": "basis-cache telemetry snapshot",
    "deflated_bytes_per_iter_model": "analytic cost-model reading "
                                     "(obs.costs.krylov_deflated_cost)",
    # durable-session A/B payload (cohort key carries detail.session /
    # detail.warm_start; detail.steps is run length, not identity —
    # steps/sec already normalizes by it)
    "steps": "run length; the per-step rate is the record's value",
    "session_ab": "both-arm A/B payload (cohort key carries "
                  "detail.session and detail.warm_start)",
    # backend-router attribution (cohort split rides on
    # detail.routed_backend, which regress.py lifts into the key)
    "router": "decision-mix / sentinel / measured-fraction / roofline-"
              "calibration snapshot; detail.routed_backend is the "
              "cohort discriminator regress.py lifts",
    # serve-mode latency/throughput payload beside the record's value
    "p95_seconds": "latency payload",
    "shed_rate": "outcome-rate payload (its own gauge exists)",
    "throughput_rps": "derived reading of the same run",
    "wall_seconds": "raw timing payload",
    # mixed-tenant attribution (cohort split rides on
    # detail.tenant_mix, which regress.py lifts into the key)
    "tenants": "per-tenant p99/shed-rate/share attribution block; "
               "detail.tenant_mix is the cohort discriminator "
               "regress.py lifts",
    "tenant_promotions": "fair-queue telemetry snapshot",
}

# ServicePolicy/FleetPolicy fields a chaos scenario of the port need not
# exercise, each with its reason (the JAX package's two). Everything else
# must appear in a scenario (kwarg or attribute) of testing/chaos.py.
POLICY_COVERAGE_EXEMPT = {
    "ServicePolicy.slo": "SLO accounting is scored by the flight "
                         "recorder over ordinary outcomes; burn-driven "
                         "degradation is opt-in and covered by "
                         "tests/test_torch_serve_flight.py, deliberately "
                         "not by the deterministic chaos campaign "
                         "(default OFF keeps scenario outcomes "
                         "seed-stable)",
    "ServicePolicy.preconditioner": "the MG service default changes "
                                    "numerics, not failure handling; the "
                                    "MG solves it dispatches are held by "
                                    "tests/test_torch_mg.py",
}
