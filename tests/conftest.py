"""Test harness configuration.

The reference had no tests and validated on a real cluster (SURVEY §4); here
every distributed path is exercised on a virtual 8-device CPU mesh via
``--xla_force_host_platform_device_count`` — set before JAX import, which is
why this lives at the top of conftest.
"""

import os
import sys

# The package is run from a checkout, not installed: make the suite
# cwd-independent by ensuring the repo root is importable.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# fp64 for bit-parity with the reference oracle.
jax.config.update("jax_enable_x64", True)
# Some environments register remote-accelerator PJRT plugins that override
# jax_platforms at import time (and may hang at init if the remote side is
# unreachable); force the CPU backend for tests regardless.
jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running solve (large grids)")
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
    config.addinivalue_line(
        "markers",
        "xslow: minutes-long solve (largest grids); skipped unless "
        "RUN_XSLOW=1 or selected with -m xslow",
    )
    config.addinivalue_line(
        "markers",
        "faults: fault-injection suite for the resilience layer "
        "(CPU-fast; runs in tier-1, selectable with -m faults)",
    )
    config.addinivalue_line(
        "markers",
        "obs: unified-telemetry suite (spans/counters/streaming; "
        "CPU-fast; runs in tier-1, selectable with -m obs)",
    )
    config.addinivalue_line(
        "markers",
        "batched: batched multi-RHS driver suite (batch-vs-sequential "
        "bit-parity, bucketing, CLI/bench throughput mode; CPU-fast; "
        "runs in tier-1, selectable with -m batched)",
    )
    config.addinivalue_line(
        "markers",
        "perf_obs: performance attribution & regression sentinel suite "
        "(cost model vs cost_analysis, Prometheus exposition, regress.py "
        "verdicts; CPU-fast; runs in tier-1, selectable with -m perf_obs)",
    )
    config.addinivalue_line(
        "markers",
        "serve: solve-service & chaos-campaign suite (admission/"
        "deadline/retry/breaker/degradation lifecycle, seeded "
        "deterministic chaos scenarios, the no-lost-request invariant; "
        "CPU-fast; runs in tier-1, selectable with -m serve)",
    )
    config.addinivalue_line(
        "markers",
        "flight: request flight-recorder suite (per-request causal "
        "traces, latency decomposition summing to wall, SLO "
        "accounting/burn rates/histogram exposition, the trace CLI; "
        "CPU-fast; runs in tier-1, selectable with -m flight)",
    )
    config.addinivalue_line(
        "markers",
        "fleet: durable solve fleet suite (supervised workers — "
        "kill/hang/quarantine/restart, CRC-sealed request journal, "
        "torn-tail replay, crash-restart recovery preserving the "
        "ledger invariant; CPU-fast; runs in tier-1, selectable with "
        "-m fleet)",
    )
    config.addinivalue_line(
        "markers",
        "geom: geometry-as-a-request suite (DSL normalization/"
        "fingerprints, canvas compilation incl. ellipse bit-parity "
        "with the reference setup, manufactured-solution accuracy "
        "gates per family, mixed-geometry co-batching parity, shape "
        "gradients; CPU-fast; runs in tier-1, selectable with "
        "-m geom)",
    )
    config.addinivalue_line(
        "markers",
        "integrity: numerical-integrity / silent-data-corruption suite "
        "(seeded bit-flip campaign across buffers and precisions, "
        "zero-false-alarm pins on clean goldens, byte-identical-HLO "
        "pin for verify_every=0, per-member masking, SDC chaos "
        "scenarios, sentinel cohort pins; CPU-fast; runs in tier-1, "
        "selectable with -m integrity)",
    )
    config.addinivalue_line(
        "markers",
        "placement: device-placement & fault-domain suite (worker→"
        "device binding on the virtual 8-device mesh, batch×mesh "
        "solve_batched(mesh=) parity, device-loss quarantine/rebind, "
        "elastic mesh-shrink ladder, journal recovery across a "
        "topology change; CPU-fast; runs in tier-1, selectable with "
        "-m placement)",
    )
    config.addinivalue_line(
        "markers",
        "contracts: program-contract checker suite (trace-safety lint "
        "rules with positive/suppressed fixtures, HLO identity ledger "
        "round-trip incl. mutated-program detection, registry drift "
        "checks, the `python -m poisson_tpu.contracts` gate; CPU-fast; "
        "runs in tier-1, selectable with -m contracts)",
    )
    config.addinivalue_line(
        "markers",
        "krylov: Krylov-memory suite (block-CG batched mode incl. the "
        "default-path byte pin and rank-deficiency handling, "
        "deflation-basis harvest/cache/warm-start, per-family L2 "
        "floors, serve cohort splits, stale-basis chaos, sentinel "
        "pins; CPU-fast; runs in tier-1, selectable with -m krylov)",
    )
    config.addinivalue_line(
        "markers",
        "session: durable solver-session suite (journal replay to the "
        "committed step boundary, cold-path HLO pin vs the historical "
        "solve, stale-warm audible fallback, heat/design stepping, "
        "one-tree-per-session flight traces, session chaos "
        "invariants, sentinel cohort pins; CPU-fast; runs in tier-1, "
        "selectable with -m session)",
    )
    config.addinivalue_line(
        "markers",
        "mg: geometric-multigrid preconditioning suite "
        "(default-jacobi-path HLO/golden pins, two-grid convergence "
        "factor, V-cycle apply bit-parity under vmap, per-family "
        "manufactured L2 floors, batched/lane/chunked parity, "
        "iteration ~flatness across resolutions, serve cohort split, "
        "sentinel cohort/direction pins; CPU-fast; runs in tier-1, "
        "selectable with -m mg)",
    )
    config.addinivalue_line(
        "markers",
        "forecast: convergence-observatory suite (estimator "
        "arithmetic, snapshot CRC round-trip + torn-file audibility, "
        "history-flag-off HLO byte-pin + golden counts, "
        "predicted-deadline typed-shed ledger invariant under both "
        "engines, re-forecast preemption, calibration bound, "
        "scoreboard dual-source render, sentinel direction pins; "
        "CPU-fast; runs in tier-1, selectable with -m forecast)",
    )
    config.addinivalue_line(
        "markers",
        "router: backend-router & roofline-observatory suite (achieved-"
        "GB/s attribution arithmetic, snapshot CRC round-trip + torn "
        "audibility, analytic cold routing table, misprediction → "
        "demotion → half-open → recovery lifecycle, default-off cohort "
        "byte-compat, routed-backend regress cohort split, scoreboard "
        "dual-source render; CPU-fast; runs in tier-1, selectable "
        "with -m router)",
    )
    config.addinivalue_line(
        "markers",
        "tenancy: tenant-isolation & overload-fairness suite "
        "(default-off byte-compat pin, token-bucket quota arithmetic + "
        "zero-compute typed sheds, DWRR share convergence under both "
        "engines, retry-budget exhaustion typed error, tenant identity "
        "surviving journal replay/--recover with budgets "
        "reconstructed, per-tenant SLO burn, tenant_mix regress cohort "
        "pins, tenant-spec CLI validation; CPU-fast; runs in tier-1, "
        "selectable with -m tenancy)",
    )


def pytest_collection_modifyitems(config, items):
    markexpr = config.getoption("-m", default="")
    if "xslow" in markexpr or os.environ.get("RUN_XSLOW") == "1":
        return
    # slow tests run by default (they are the golden-count regressions);
    # xslow (the 1600×2400 / 2400×3200 goldens, ~2-3 min each) only on demand.
    skip = pytest.mark.skip(reason="xslow: set RUN_XSLOW=1 or -m xslow")
    for item in items:
        if "xslow" in item.keywords:
            item.add_marker(skip)
