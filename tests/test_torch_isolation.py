"""The port stands alone: ``poisson_tpu_torch`` imports neither ``jax`` nor
``poisson_tpu``, runs on the card unless asked for the CPU, and launches no
kernel for CPU tensors."""

import ast
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import poisson_tpu_torch
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry import canvas, dsl, manufactured
from poisson_tpu_torch.mg import hierarchy as mg_hierarchy
from poisson_tpu_torch.mg import selfcheck as mg_selfcheck
from poisson_tpu_torch.ops import ca_cg, fused_cg, launch, resident
from poisson_tpu_torch.parallel import (
    ca_sharded,
    checkpoint_sharded,
    fused_sharded,
    mesh,
    pcg_sharded,
)
from poisson_tpu_torch.cli import main as cli_main
from poisson_tpu_torch import bench as bench_main
from poisson_tpu_torch.obs import selfcheck as obs_selfcheck
from poisson_tpu_torch.krylov import KrylovPolicy, recycle
from poisson_tpu_torch import serve
from poisson_tpu_torch.testing import chaos
from poisson_tpu_torch.solvers import (
    adjoint,
    batched,
    batched_selfcheck,
    checkpoint,
    history,
    lanes,
    pcg,
    refine,
    resilient,
    session,
)

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "poisson_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "poisson_tpu")

_BLOCKED_IMPORT = """
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {forbidden!r}:
            raise ImportError('blocked: ' + name)
        return None

for name in list(sys.modules):
    if name.split('.')[0] in {forbidden!r}:
        del sys.modules[name]
sys.meta_path.insert(0, Block())
import poisson_tpu_torch
for mod in pkgutil.walk_packages(poisson_tpu_torch.__path__,
                                 'poisson_tpu_torch.'):
    if not mod.name.endswith('__main__'):
        importlib.import_module(mod.name)
assert not any(n.split('.')[0] in {forbidden!r} for n in sys.modules)
print('ok')
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"   # several test workers share the cores
    return env


def test_imports_with_jax_and_reference_unimportable():
    code = _BLOCKED_IMPORT.format(forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


_BLOCKED_MULTIHOST = """
import os, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in {forbidden!r}:
            raise ImportError('blocked: ' + name)
        return None

sys.meta_path.insert(0, Block())
for name in ('RANK', 'WORLD_SIZE', 'MASTER_ADDR', 'MASTER_PORT'):
    os.environ.pop(name, None)
from poisson_tpu_torch.parallel.multihost import initialize_multihost
from poisson_tpu_torch.parallel.multihost import is_primary
assert initialize_multihost() == 0 and is_primary()
assert not any(n.split('.')[0] in {forbidden!r} for n in sys.modules)
print('ok')
"""


def test_multihost_imports_and_runs_with_jax_unimportable():
    """``parallel/multihost.py`` (the process-group launch) imports and
    runs its no-cluster path with ``jax`` and ``poisson_tpu`` blocked."""
    code = _BLOCKED_MULTIHOST.format(forbidden=FORBIDDEN)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_no_module_imports_jax_or_the_reference():
    offenders = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in FORBIDDEN]
    assert not offenders
    modules = [m.name for m in pkgutil.walk_packages(
        poisson_tpu_torch.__path__, "poisson_tpu_torch.")]
    for name in ("ops.fused_cg", "ops.resident", "ops.ca_cg", "ops.serial",
                 "ops.launch", "ops.recurrence",
                 "solvers.refine", "solvers.checkpoint", "parallel.mesh",
                 "parallel.halo", "parallel.fused_sharded",
                 "parallel.ca_sharded", "parallel.pcg_sharded",
                 "parallel.checkpoint_sharded", "parallel.multihost",
                 "obs", "obs.metrics",
                 "obs.trace", "solvers.batched", "solvers.lanes",
                 "solvers.batched_selfcheck", "mg", "mg.hierarchy",
                 "mg.cycle", "mg.preconditioner", "mg.selfcheck",
                 "integrity", "integrity.probe", "testing",
                 "testing.faults", "solvers.resilient", "solvers.history",
                 "parallel.watchdog", "obs.stream", "geometry",
                 "geometry.dsl", "geometry.canvas", "geometry.manufactured",
                 "solvers.adjoint", "krylov", "krylov.block",
                 "krylov.recycle", "solvers.session", "obs.costs",
                 "obs.roofline", "obs.profile", "obs.export",
                 "obs.forecast", "native", "bench", "serve",
                 "serve.breaker", "serve.deadline", "serve.fleet",
                 "serve.journal", "serve.placement", "serve.refill",
                 "serve.router", "serve.service", "serve.session",
                 "serve.tenancy", "serve.types", "obs.flight",
                 "testing.chaos", "cli_serve", "contracts",
                 "contracts.lint", "contracts.drift", "contracts.trace",
                 "contracts.manifest", "obs.selfcheck", "examples",
                 "examples.basic_solve", "examples.distributed_solve",
                 "examples.shape_opt", "examples.source_identification"):
        assert f"poisson_tpu_torch.{name}" in modules


@pytest.mark.parametrize("entry", [
    lambda: fused_cg.fused_cg_solve(Problem(M=10, N=10)),
    lambda: pcg.pcg_solve(Problem(M=10, N=10)),
    lambda: fused_cg.build_canvases(Problem(M=10, N=10)),
    lambda: resident.resident_cg_solve(Problem(M=10, N=10)),
    lambda: ca_cg.ca_cg_solve(Problem(M=10, N=10)),
    lambda: refine.refined_solve(Problem(M=10, N=10)),
    lambda: mesh.make_solver_mesh(),
    lambda: fused_sharded.fused_cg_solve_sharded(Problem(M=10, N=10)),
    lambda: ca_sharded.ca_cg_solve_sharded(Problem(M=10, N=10)),
    lambda: fused_cg.fused_cg_solve_checkpointed(Problem(M=10, N=10),
                                                 "unused.npz"),
    lambda: ca_cg.ca_cg_solve_checkpointed(Problem(M=10, N=10), "unused.npz"),
    lambda: checkpoint.pcg_solve_checkpointed(Problem(M=10, N=10),
                                              "unused.npz"),
    lambda: pcg_sharded.pcg_solve_sharded(Problem(M=10, N=10)),
    lambda: checkpoint_sharded.pcg_solve_sharded_checkpointed(
        Problem(M=10, N=10), None, "unused.npz"),
    lambda: fused_sharded.fused_cg_solve_sharded_checkpointed(
        Problem(M=10, N=10), None, "unused.npz"),
    lambda: ca_sharded.ca_cg_solve_sharded_checkpointed(
        Problem(M=10, N=10), None, "unused.npz"),
    lambda: batched.solve_batched(Problem(M=10, N=10), rhs_gates=[1.0]),
    lambda: lanes.LaneBatch(Problem(M=10, N=10), 2),
    lambda: batched_selfcheck.run_selfcheck(),
    lambda: pcg.pcg_solve(Problem(M=20, N=20), preconditioner="mg"),
    lambda: batched.solve_batched(Problem(M=20, N=20), rhs_gates=[1.0],
                                  preconditioner="mg"),
    lambda: lanes.LaneBatch(Problem(M=20, N=20), 2, preconditioner="mg"),
    lambda: checkpoint.pcg_solve_chunked(Problem(M=20, N=20),
                                         preconditioner="mg"),
    lambda: mg_hierarchy.device_hierarchy(Problem(M=20, N=20), "float32",
                                          True),
    lambda: mg_selfcheck.run_selfcheck(),
    lambda: resilient.pcg_solve_resilient(Problem(M=10, N=10)),
    lambda: history.pcg_solve_history(Problem(M=10, N=10), 5),
    lambda: pcg.pcg_solve(Problem(M=10, N=10), verify_every=5,
                          stream_every=5),
    lambda: batched.solve_batched(Problem(M=10, N=10), rhs_gates=[1.0],
                                  verify_every=5),
    lambda: lanes.LaneBatch(Problem(M=10, N=10), 2, verify_every=5),
    lambda: pcg.pcg_solve(Problem(M=10, N=10),
                          geometry={"type": "ellipse", "rx": 0.7}),
    lambda: batched.solve_batched(Problem(M=10, N=10), rhs_gates=[1.0],
                                  geometries=[{"type": "ellipse"}]),
    lambda: lanes.LaneBatch(Problem(M=10, N=10), 2, multi_geometry=True),
    lambda: checkpoint.pcg_solve_chunked(Problem(M=10, N=10),
                                         geometry={"type": "ellipse"}),
    lambda: canvas.geometry_setup(Problem(M=10, N=10), {"type": "ellipse"},
                                  "float32", True),
    lambda: manufactured.manufactured_error(manufactured.cases()[0], 10,
                                            10),
    lambda: adjoint.differentiable_solve(Problem(M=10, N=10),
                                         torch.zeros(11, 11)),
    lambda: adjoint.shape_gradient(
        Problem(M=10, N=10), lambda q: dsl.Ellipse(rx=q[0], ry=q[1]),
        [0.8, 0.42], lambda w: w.sum()),
    lambda: batched.solve_batched(Problem(M=10, N=10), rhs_gates=[1.0, 2.0],
                                  mode="block"),
    lambda: recycle.solve_recycled(Problem(M=10, N=10)),
    lambda: recycle.has_basis(Problem(M=10, N=10)),
    lambda: manufactured.manufactured_error(
        manufactured.cases()[0], 10, 10, krylov=KrylovPolicy(mode="block")),
    lambda: session.session_step_solve(Problem(M=10, N=10)),
    lambda: session.session_step_solve(Problem(M=10, N=10), mass_shift=1.0),
    lambda: session.shifted_setup(Problem(M=10, N=10), None, "float64",
                                  False, 1.0),
    lambda: session.design_step(
        Problem(M=10, N=10), {"cx": 0.0, "cy": 0.0, "rx": 0.8, "ry": 0.4},
        torch.zeros(11, 11), 0.1),
    lambda: checkpoint.pcg_solve_chunked(Problem(M=10, N=10), rhs_gate=0.5),
    lambda: pcg.pcg_solve(Problem(M=10, N=10), dtype="bfloat16"),
    lambda: serve.SolveService(),
    lambda: serve.SolveService.recover(serve.SolveJournal(os.devnull)),
    lambda: serve.DeviceRegistry(),
    lambda: serve.WorkerPool(serve.FleetPolicy(workers=2)),
    lambda: serve.SessionHost(serve.SolveService()),
    lambda: chaos.run_scenario("overload-shed"),
    lambda: cli_main(["serve", "10", "10", "--requests", "1"]),
    lambda: cli_main(["session", "10", "10", "--steps", "1"]),
    lambda: cli_main(["chaos", "overload-shed"]),
    lambda: obs_selfcheck.run_selfcheck("unused"),
    lambda: cli_main(["10", "10", "--categories", "--save-solution",
                      "unused.npy"]),
    lambda: bench_main.run_mode(bench_main.parse_args(["--serve", "1"]),
                                Problem(M=10, N=10), None),
], ids=["fused_cg_solve", "pcg_solve", "build_canvases", "resident_cg_solve",
        "ca_cg_solve", "refined_solve", "make_solver_mesh",
        "fused_cg_solve_sharded", "ca_cg_solve_sharded",
        "fused_cg_solve_checkpointed", "ca_cg_solve_checkpointed",
        "pcg_solve_checkpointed", "pcg_solve_sharded",
        "pcg_solve_sharded_checkpointed",
        "fused_cg_solve_sharded_checkpointed",
        "ca_cg_solve_sharded_checkpointed", "solve_batched", "LaneBatch",
        "batched_selfcheck", "pcg_solve_mg", "solve_batched_mg",
        "LaneBatch_mg", "pcg_solve_chunked_mg", "device_hierarchy",
        "mg_selfcheck", "pcg_solve_resilient", "pcg_solve_history",
        "pcg_solve_verified", "solve_batched_verified",
        "LaneBatch_verified", "pcg_solve_geometry", "solve_batched_geometries",
        "LaneBatch_multi_geometry", "pcg_solve_chunked_geometry",
        "geometry_setup", "manufactured_error", "differentiable_solve",
        "shape_gradient", "solve_batched_block", "solve_recycled",
        "has_basis", "manufactured_error_krylov", "session_step_solve",
        "session_step_solve_heat", "shifted_setup", "design_step",
        "pcg_solve_chunked_rhs_gate", "pcg_solve_bfloat16", "SolveService",
        "SolveService_recover", "DeviceRegistry", "WorkerPool",
        "SessionHost", "chaos_run_scenario", "cli_serve", "cli_session",
        "cli_chaos", "obs_selfcheck", "cli_categories_save_solution",
        "bench_serve_mode"])
def test_entry_points_default_to_cuda_and_raise_without_it(entry,
                                                           monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_cpu_solve_launches_no_kernel():
    launch.reset_launch_counts()
    for solve in (fused_cg.fused_cg_solve, ca_cg.ca_cg_solve,
                  resident.resident_cg_solve):
        assert int(solve(Problem(M=40, N=40), device="cpu").iterations) == 50
    for kwargs in (dict(bn=128), dict(serial=True)):
        r = fused_cg.fused_cg_solve(Problem(M=40, N=40), device="cpu",
                                    **kwargs)
        assert int(r.iterations) == 50
    assert launch.launch_counts("direction_and_stencil", "fused_update") == {
        "direction_and_stencil": 0, "direction_and_stencil_sharded": 0,
        "direction_and_stencil_blocked": 0,
        "fused_update": 0, "fused_update_sharded": 0,
        "fused_update_blocked": 0}
    assert launch.launch_counts("basis_sweep", "pair_update") == {
        "basis_sweep": 0, "pair_update": 0, "basis_sweep_sharded": 0,
        "pair_update_sharded": 0}
    assert launch.launch_counts("resident_solve") == {"resident_solve": 0}
    assert launch.launch_counts("serial_sum") == {"serial_sum": 0}


@pytest.mark.parametrize("extra,backend", [
    ([], "fused"),
    (["--dtype", "float64"], "torch"),
    (["--backend", "resident"], "resident"),
    (["--backend", "ca"], "ca"),
    (["--backend", "sharded", "--mesh", "2x2", "--dtype", "float64"],
     "sharded"),
])
def test_cli_solves_on_cpu(extra, backend):
    out = subprocess.run(
        [sys.executable, "-m", "poisson_tpu_torch", "40", "40",
         "--device", "cpu", "--json", *extra],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["iterations"] == 50
    assert rec["backend"] == backend
    assert rec["device_kind"] == "cpu"
    assert rec["stopped"] is None
    assert rec["l2_error"] < 5e-3
    assert rec["achieved_gbps"] is None    # no device rate from a CPU run


@pytest.mark.parametrize("args,message", [
    (["40", "40", "--backend", "ca", "--dtype", "float64"], "fp32 path"),
    (["40", "40", "--backend", "resident", "--dtype", "float64"],
     "fp32 path"),
    (["2400", "3200", "--backend", "resident"], "40 MB residency budget"),
], ids=["ca_fp64", "resident_fp64", "resident_over_budget"])
def test_cli_refuses_what_a_backend_does_not_take(args, message):
    out = subprocess.run(
        [sys.executable, "-m", "poisson_tpu_torch", *args, "--device", "cpu"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert message in out.stderr
