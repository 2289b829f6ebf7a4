"""Reference goldens for ``chip_smoke.py``'s resilience drills.

Runs the JAX package's resilient driver on the CPU through the drills that
``chip_smoke.py`` runs on the port (the same problems, dtypes, chunks,
fault hooks and recovery policies) and prints one JSON object: for each
drill its ``(iteration, verdict, action)`` history, its iteration count,
and, where it converges, the largest pointwise gap to the clean solve
(``max_diff_vs_clean``) and its L2 error against the analytic solution
(``l2_error``, beside the clean solve's ``l2_error_clean``). These are the
``RES_*_HISTORY``, ``RES_*_JAX_ITERATIONS`` and ``RES_*_MAX_DIFF``
constants of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python -m benchmarks.resilience_goldens

One process, about 1 GiB; a few minutes on a CPU. The bitflip drill
injects into w and r only: the package maps the ``Ap`` buffer onto r
(``testing/faults.py``'s ``_BITFLIP_BUFFERS``), so an ``Ap`` flip with the
same seed is the r drill exactly.
"""

from __future__ import annotations

import json
import warnings

import jax
import numpy as np

# The ladder's float64 rung exists only with x64 on (as the tests run).
jax.config.update("jax_enable_x64", True)

from poisson_tpu.analysis import l2_error_host
from poisson_tpu.config import Problem
from poisson_tpu.solvers.pcg import pcg_solve
from poisson_tpu.solvers.resilient import (
    DivergenceError,
    RecoveryPolicy,
    pcg_solve_resilient,
)
from poisson_tpu.testing import faults

FLAGSHIP = (800, 1200)
NAN_AT, CHUNK = 300, 200               # chip_smoke.py's RES_NAN_AT, RES_CHUNK
FLIP_AT, FLIP_VERIFY = 100, 5          # RES_FLIP_AT, RES_FLIP_VERIFY
ESCALATE, ESCALATE_AT = (400, 600), 100  # RES_ESCALATE, RES_ESCALATE_AT
WINDOWS = (200, 0)                     # the default stagnation window, off


def _record(problem, clean_w, run) -> dict:
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        try:
            res = run()
        except DivergenceError as e:
            return {"history": [list(h) for h in e.diagnostics["history"]],
                    "converged": False}
    w = np.asarray(res.w, np.float64)
    return {
        "history": [list(h) for h in res.recovery_history],
        "converged": int(res.flag) == 1,
        "iterations": int(res.iterations),
        "restarts": int(res.restarts),
        "max_diff_vs_clean": float(np.abs(w - clean_w).max()),
        "l2_error": l2_error_host(problem, res.w),
    }


def main() -> None:
    p = Problem(*FLAGSHIP)
    clean = pcg_solve(p, dtype="float32")
    clean_w = np.asarray(clean.w, np.float64)
    out = {"clean": {"iterations": int(clean.iterations),
                     "l2_error_clean": l2_error_host(p, clean.w)}}
    for window in WINDOWS:
        policy = RecoveryPolicy(stagnation_window=window)
        out[f"nan window {window}"] = _record(
            p, clean_w, lambda: pcg_solve_resilient(
                p, dtype="float32", chunk=CHUNK, policy=policy,
                on_chunk=faults.chunk_hook(
                    faults.FaultPlan(nan_at_iteration=NAN_AT))))
        for buffer in ("w", "r"):
            out[f"bitflip {buffer} window {window}"] = _record(
                p, clean_w, lambda: pcg_solve_resilient(
                    p, dtype="float32", chunk=min(CHUNK, FLIP_AT),
                    verify_every=FLIP_VERIFY, policy=policy,
                    on_chunk=faults.bitflip_hook(FLIP_AT, buffer=buffer)))

    small = Problem(*ESCALATE)
    fired = {"n": 0}

    def two_nans(state, chunks_done):
        if fired["n"] < 2 and int(state.k) >= ESCALATE_AT:
            fired["n"] += 1
            return faults.inject_nan(state)
        return None

    small_clean = np.asarray(pcg_solve(small, dtype="float32").w, np.float64)
    out["escalation 400x600"] = _record(
        small, small_clean, lambda: pcg_solve_resilient(
            small, dtype="float32", chunk=ESCALATE_AT, on_chunk=two_nans,
            policy=RecoveryPolicy(stagnation_window=0)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
