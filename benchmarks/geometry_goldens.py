"""Reference goldens for ``chip_smoke.py``'s geometry phase.

Runs the JAX package on the CPU (x64 on) through the geometry solves that
``chip_smoke.py`` runs on the port, and prints one JSON object: for each
family of ``geometry.manufactured.cases()`` the fp64 and fp32
``pcg_solve(geometry=spec)`` iteration count and stop flag at 800×1200
(the flagship grid), the fp64 MG count of ``ellipse-offset`` there, and
the shape gradient of ``tests/test_geometry_dsl.py``'s objective
(δ = 1e-11) at 400×600 and at that test's 32×32. These are the
``GEOM_*`` constants of ``chip_smoke.py``.

    JAX_PLATFORMS=cpu python -m benchmarks.geometry_goldens

One process, about 5 GiB at its peak (the sampled canvases' probes at
800×1200); a few minutes on a CPU.
"""

from __future__ import annotations

import json
import time

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from poisson_tpu.config import Problem  # noqa: E402
from poisson_tpu.geometry.dsl import Ellipse  # noqa: E402
from poisson_tpu.geometry.manufactured import case_by_name, cases  # noqa: E402
from poisson_tpu.solvers.adjoint import shape_gradient  # noqa: E402
from poisson_tpu.solvers.pcg import pcg_solve  # noqa: E402

FLAGSHIP = (800, 1200)
MG_CASE = "ellipse-offset"            # chip_smoke.py's GEOM_MG_CASE
ADJOINTS = ((400, 600), (32, 32))     # GEOM_ADJOINT, GEOM_ADJOINT_SMALL
ADJOINT_DELTA = 1e-11
ADJOINT_PARAMS = (0.8, 0.42)          # Ellipse(rx, ry)


def main() -> None:
    started = time.perf_counter()
    p = Problem(*FLAGSHIP)
    out = {"grid": list(FLAGSHIP), "families": {}}
    for case in cases():
        row = {}
        for dtype in ("float64", "float32"):
            r = pcg_solve(p, dtype=dtype, geometry=case.spec)
            row[dtype] = {"iterations": int(r.iterations),
                          "flag": int(r.flag)}
        out["families"][case.name] = row
        print(f"# {case.name}: {row}", flush=True)
    mg = pcg_solve(p, dtype="float64", geometry=case_by_name(MG_CASE).spec,
                   preconditioner="mg")
    out["mg"] = {"case": MG_CASE, "iterations": int(mg.iterations),
                 "flag": int(mg.flag)}
    out["adjoint"] = []
    for grid in ADJOINTS:
        pa = Problem(*grid, delta=ADJOINT_DELTA)
        loss = lambda w: jnp.sum(w[1:-1, 1:-1]) * pa.h1 * pa.h2
        val, grad = shape_gradient(
            pa, lambda q: Ellipse(cx=0.0, cy=0.0, rx=q[0], ry=q[1]),
            jnp.asarray(ADJOINT_PARAMS), loss)
        out["adjoint"].append({
            "grid": list(grid), "delta": ADJOINT_DELTA,
            "params": list(ADJOINT_PARAMS), "loss": float(val),
            "grad": [float(g) for g in grad]})
    out["seconds"] = time.perf_counter() - started
    print(json.dumps(out))


if __name__ == "__main__":
    main()
