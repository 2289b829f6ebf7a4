"""Port parity: the sharded solves on a mesh split over two processes
(``poisson_tpu_torch.parallel.multihost``), on the CPU, as
``tests/test_multihost.py`` runs the JAX package's.

Two processes, each holding four ``cpu`` shards, form a gloo process group
on a free localhost port and make the 2×4 mesh (rank 0 owns the row ix = 0)
at 40×40. Each runs, in a subprocess that imports no ``jax``: the
cross-process halo exchanges and mesh sums on seeded random blocks; fp64
``pcg_solve_sharded(setup="device")``; ``pcg_solve_sharded_checkpointed``
capped at 20 and resumed to 50; the fused and CA checkpointed drivers (the
kernels' plain versions) capped and resumed, and chunked in the serial
mode; a batched solve on the mesh; a resume from a file the JAX package
wrote; and the one-shot fused and CA drivers, which refuse the mesh. The
parent holds what they return against:

- the port's 2×4 mesh driven by one process: bit for bit (every shift is a
  copy and every sum the one-process sum of the same per-shard sums);
- the JAX package's 8-device mesh (``tests/conftest.py``): the same counts
  and flags, iterates within 1e-10 in fp64 and 1e-6 in fp32 (another
  reduction order; the fp32 tolerance of the sharded parity tests).

A two-rank file resumes in the JAX package and the JAX file on two ranks;
a rank that dies makes its peer fail within the timeout; the ranks'
``--trace-dir`` files merge into one timeline with pids 0 and 1.
"""

import dataclasses
import functools
import json
import os
import pathlib
import shutil
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.parallel import checkpoint_sharded as jax_ck_sharded
from poisson_tpu.parallel import mesh as jax_mesh
from poisson_tpu.parallel import pallas_ca_sharded, pallas_sharded
from poisson_tpu.parallel import pcg_sharded as jax_pcg_sharded
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import merge_trace_dir
from poisson_tpu_torch.parallel import (
    ca_sharded,
    checkpoint_sharded,
    fused_sharded,
    halo,
    make_solver_mesh,
    pcg_sharded,
)
from poisson_tpu_torch.solvers.batched import solve_batched

_ROOT = pathlib.Path(__file__).resolve().parents[1]
P40 = Problem(M=40, N=40)
CAP = 20
CHUNK = 10
GATES = (1.0, 1.5)
RUN = 8               # kernel S's run in the mesh_sum units
FP64_TOL = 1e-10      # port vs JAX, fp64 (another reduction order)
FP32_TOL = 1e-6       # port vs JAX, fp32
TIMEOUT = 240         # seconds a rank may take; killed after

_COMMON = """
import json, os, shutil, sys
import numpy as np
import torch

torch.set_num_threads(1)
coordinator, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
from poisson_tpu_torch.parallel.multihost import (initialize_multihost,
                                                  is_primary)
assert initialize_multihost(coordinator=coordinator, num_processes=2,
                            process_id=rank) == rank
from poisson_tpu_torch.parallel import make_solver_mesh
mesh = make_solver_mesh(["cpu"] * 4)
"""

_WORKER = (f"CAP, CHUNK, GATES, RUN = {CAP}, {CHUNK}, {GATES!r}, {RUN}\n"
           + _COMMON + """
from poisson_tpu_torch import obs
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.parallel import (
    ca_cg_solve_sharded, ca_cg_solve_sharded_checkpointed,
    fused_cg_solve_sharded, fused_cg_solve_sharded_checkpointed,
    pcg_solve_sharded, pcg_solve_sharded_checkpointed)
from poisson_tpu_torch.parallel import ca_sharded, fused_sharded, halo
from poisson_tpu_torch.solvers.batched import solve_batched

obs.configure(trace_dir=os.path.join(out, "trace"))
assert initialize_multihost() == rank          # the documented no-op
assert is_primary() == (rank == 0)
info = {"owners": list(mesh.owners), "local": list(mesh.local),
        "grid": [mesh.px, mesh.py]}
res = {}
units = np.load(os.path.join(out, "units.npz"))
blocks = [torch.tensor(units["blocks"][s]) for s in mesh.local]
halo.exchange_halos(blocks, mesh)
res["halos"] = np.stack([b.numpy() for b in blocks])
spec = fused_sharded.shard_spec(Problem(M=40, N=40), 2, 4, ring=2)
ring2 = [torch.tensor(units["ring2"][s]) for s in mesh.local]
ca_sharded.exchange_ring2(ring2, spec, mesh)
res["ring2"] = np.stack([c.numpy() for c in ring2])
parts = [torch.tensor(units["partials"][s]) for s in mesh.local]
grams = [torch.tensor(units["grams"][s]) for s in mesh.local]
res["sum_plain"] = halo.mesh_sum(parts, mesh).numpy()
res["sum_serial"] = halo.mesh_sum(parts, mesh, RUN).numpy()
res["sum_gram"] = halo.mesh_sum(grams, mesh, RUN).numpy()

p = Problem(M=40, N=40)
capped = p.with_(max_iter=CAP)
with obs.span("pcg_sharded"):
    r = pcg_solve_sharded(p, mesh, dtype=torch.float64, setup="device")
res["pcg"], info["pcg"] = r.w.numpy(), [int(r.iterations), int(r.flag)]

ck = os.path.join(out, "plain.npz")
a = pcg_solve_sharded_checkpointed(capped, mesh, ck, chunk=CHUNK,
                                   dtype=torch.float64)
info["plain_capped"] = [int(a.iterations), os.path.exists(ck)]
if is_primary():
    shutil.copy(ck, os.path.join(out, "port_capped.npz"))
b = pcg_solve_sharded_checkpointed(p, mesh, ck, chunk=CHUNK,
                                   dtype=torch.float64)
res["plain"] = b.w.numpy()
info["plain"] = [int(b.iterations), int(b.flag), os.path.exists(ck)]

jck = os.path.join(out, "jax_resume.npz")
if is_primary():
    shutil.copy(os.path.join(out, "jax_capped.npz"), jck)
torch.distributed.barrier()
c = pcg_solve_sharded_checkpointed(p, mesh, jck, chunk=CHUNK,
                                   dtype=torch.float64)
res["from_jax"] = c.w.numpy()
info["from_jax"] = [int(c.iterations), int(c.flag)]

for name, solve in (("fused", fused_cg_solve_sharded_checkpointed),
                    ("ca", ca_cg_solve_sharded_checkpointed)):
    f = os.path.join(out, name + ".npz")
    a = solve(capped, mesh, f, chunk=CHUNK)
    kept = os.path.exists(f)
    b = solve(p, mesh, f, chunk=CHUNK)
    s = solve(p, mesh, f + ".serial", chunk=CHUNK, serial=True)
    res[name], res[name + "_serial"] = b.w.numpy(), s.w.numpy()
    info[name] = [int(a.iterations), kept, int(b.iterations),
                  float(b.diff), int(s.iterations), os.path.exists(f)]

batch = solve_batched(p, rhs_gates=GATES, mesh=mesh, dtype=torch.float64)
res["batched"] = batch.w.numpy()
info["batched"] = [int(k) for k in batch.iterations]

refused = []
for solve in (fused_cg_solve_sharded, ca_cg_solve_sharded):
    try:
        solve(p, mesh)
    except ValueError as e:
        refused.append(str(e))
info["refused"] = refused
info["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib", "poisson_tpu")
                           for m in sys.modules)
obs.finalize()
np.savez(os.path.join(out, f"rank{rank}.npz"), **res)
with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
    json.dump(info, fh)
print(f"RANK{rank}_OK", flush=True)
""")

_DYING = _COMMON + """
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.parallel import pcg_solve_sharded

if rank == 1:
    os._exit(3)                  # dies holding its shards
pcg_solve_sharded(Problem(M=40, N=40), mesh, dtype=torch.float64)
print("RANK0_SOLVED_ALONE", flush=True)
"""


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(script: str, out) -> list:
    """Two ranks of ``script``: (returncode, stdout, stderr, seconds) each.
    Every rank has TIMEOUT seconds and is killed afterwards."""
    env = dict(os.environ, PYTHONPATH=str(_ROOT), OMP_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    coord = f"127.0.0.1:{_free_port()}"
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, coord, str(r), str(out)], cwd=_ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    results = []
    try:
        for proc in procs:
            out_s, err_s = proc.communicate(timeout=TIMEOUT)
            results.append((proc.returncode, out_s, err_s,
                            time.perf_counter() - t0))
    finally:
        for proc in procs:
            proc.kill()
    return results


def _jax_mesh():
    return jax_mesh.make_solver_mesh(jax.devices()[:8], grid=(2, 4))


def _cpu_mesh():
    return make_solver_mesh(["cpu"] * 8, grid=(2, 4))


def _units():
    """Seeded random shard blocks (all 8 shards), the same in every
    process: halo blocks, ring-2 canvases, partials and Gram partials."""
    rng = np.random.default_rng(15)
    cv = fused_sharded.shard_spec(P40, 2, 4, ring=2).cv
    return dict(
        blocks=rng.standard_normal((8, 6, 7)),
        ring2=rng.standard_normal((8, cv.rows, cv.cols)).astype(np.float32),
        partials=rng.standard_normal((8, 37)).astype(np.float32),
        grams=rng.standard_normal((8, 5, 12)).astype(np.float32))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The two-rank run: its output directory, each rank's arrays and
    report."""
    out = tmp_path_factory.mktemp("two_ranks")
    np.savez(out / "units.npz", **_units())
    # The JAX package's capped fp64 file, for the ranks to resume.
    jax_ck_sharded.pcg_solve_sharded_checkpointed(
        JaxProblem(M=40, N=40, max_iter=CAP), _jax_mesh(),
        str(out / "jax_capped.npz"), chunk=CHUNK, dtype="float64",
        keep_checkpoint=True)
    runs = _launch(_WORKER, out)
    for rank, (rc, out_s, err_s, _) in enumerate(runs):
        assert rc == 0, f"rank {rank} rc={rc}:\n{err_s[-3000:]}"
        assert f"RANK{rank}_OK" in out_s, (out_s, err_s[-1000:])
    arrays = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    reports = [json.loads((out / f"rank{r}.json").read_text())
               for r in range(2)]
    return out, arrays, reports


@functools.lru_cache(maxsize=None)
def _one_process() -> dict:
    """The same calls on the 2×4 mesh driven by this one process."""
    m = _cpu_mesh()
    work = pathlib.Path(os.environ.get("TMPDIR", "/tmp")) / (
        f"one_process_{os.getpid()}")
    work.mkdir(parents=True, exist_ok=True)
    try:
        units = _units()
        blocks = [torch.tensor(b) for b in units["blocks"]]
        halo.exchange_halos(blocks, m)
        spec = fused_sharded.shard_spec(P40, 2, 4, ring=2)
        ring2 = [torch.tensor(c) for c in units["ring2"]]
        ca_sharded.exchange_ring2(ring2, spec, m)
        parts = [torch.tensor(x) for x in units["partials"]]
        grams = [torch.tensor(x) for x in units["grams"]]
        ref = dict(halos=np.stack([b.numpy() for b in blocks]),
                   ring2=np.stack([c.numpy() for c in ring2]),
                   sum_plain=halo.mesh_sum(parts, m).numpy(),
                   sum_serial=halo.mesh_sum(parts, m, RUN).numpy(),
                   sum_gram=halo.mesh_sum(grams, m, RUN).numpy())
        ref["pcg"] = pcg_sharded.pcg_solve_sharded(
            P40, m, dtype=torch.float64, setup="device").w.numpy()
        capped = dataclasses.replace(P40, max_iter=CAP)
        ck = str(work / "plain.npz")
        checkpoint_sharded.pcg_solve_sharded_checkpointed(
            capped, m, ck, chunk=CHUNK, dtype=torch.float64)
        ref["plain"] = checkpoint_sharded.pcg_solve_sharded_checkpointed(
            P40, m, ck, chunk=CHUNK, dtype=torch.float64).w.numpy()
        for name, solve in (
                ("fused", fused_sharded.fused_cg_solve_sharded_checkpointed),
                ("ca", ca_sharded.ca_cg_solve_sharded_checkpointed)):
            f = str(work / f"{name}.npz")
            solve(capped, m, f, chunk=CHUNK)
            ref[name] = solve(P40, m, f, chunk=CHUNK).w.numpy()
            ref[name + "_serial"] = solve(P40, m, f + ".serial", chunk=CHUNK,
                                          serial=True).w.numpy()
        ref["batched"] = solve_batched(P40, rhs_gates=GATES, mesh=m,
                                       dtype=torch.float64).w.numpy()
        return ref
    finally:
        shutil.rmtree(work, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _jax_solve(name: str):
    p, m = JaxProblem(M=40, N=40), _jax_mesh()
    if name == "pcg":
        return jax_pcg_sharded.pcg_solve_sharded(p, m, dtype="float64",
                                                 setup="device")
    if name == "fused":
        return pallas_sharded.pallas_cg_solve_sharded(p, m)
    return pallas_ca_sharded.ca_cg_solve_sharded(p, m)


def test_two_ranks_make_the_global_mesh(two_ranks):
    _, _, reports = two_ranks
    for rank, rep in enumerate(reports):
        assert rep["grid"] == [2, 4]
        assert rep["owners"] == [0, 0, 0, 0, 1, 1, 1, 1]
        assert rep["local"] == list(range(4 * rank, 4 * rank + 4))
        assert not rep["jax_imported"]


@pytest.mark.parametrize("key", ["halos", "ring2"])
def test_cross_process_exchange_equals_one_process(two_ranks, key):
    """exchange_halos and exchange_ring2 across the process boundary, on
    seeded random blocks, corners included: each rank's shards bit for bit
    with the same shards exchanged by one process."""
    _, arrays, reports = two_ranks
    ref = _one_process()[key]
    for arr, rep in zip(arrays, reports):
        np.testing.assert_array_equal(arr[key], ref[rep["local"]])


@pytest.mark.parametrize("key", ["sum_plain", "sum_serial", "sum_gram"])
def test_cross_process_mesh_sum_equals_one_process(two_ranks, key):
    """mesh_sum with run=None and with kernel S's run (plain version),
    also on (tiles, 12) Gram partials: the same bits on both ranks as in
    one process."""
    _, arrays, _ = two_ranks
    for arr in arrays:
        np.testing.assert_array_equal(arr[key], _one_process()[key])


def test_pcg_device_fp64(two_ranks):
    _, arrays, reports = two_ranks
    want = _jax_solve("pcg")
    for arr, rep in zip(arrays, reports):
        assert rep["pcg"] == [50, int(want.flag)] == [50, 1]
        np.testing.assert_array_equal(arr["pcg"], _one_process()["pcg"])
        np.testing.assert_allclose(arr["pcg"], np.asarray(want.w),
                                   rtol=0, atol=FP64_TOL)


def test_checkpointed_plain_capped_then_resumed(two_ranks):
    """Capped at 20 (the file kept on every rank's view), resumed to 50,
    the converged run's file removed by the primary before either rank
    returned."""
    _, arrays, reports = two_ranks
    want = _jax_solve("pcg")
    for arr, rep in zip(arrays, reports):
        assert rep["plain_capped"] == [CAP, True]
        assert rep["plain"] == [50, 1, False]
        np.testing.assert_array_equal(arr["plain"], _one_process()["plain"])
        np.testing.assert_allclose(arr["plain"], np.asarray(want.w),
                                   rtol=0, atol=FP64_TOL)


@pytest.mark.parametrize("name", ["fused", "ca"])
def test_kernel_drivers_capped_then_resumed(two_ranks, name):
    """The fused (A, B sharded) and CA (C, D sharded) checkpointed drivers
    through the kernels' plain versions: capped, resumed to JAX's count,
    bit for bit with one process; within 1e-6 of JAX's one-shot iterate."""
    _, arrays, reports = two_ranks
    want = _jax_solve(name)
    for arr, rep in zip(arrays, reports):
        capped, kept, k, diff, k_serial, left = rep[name]
        assert (capped, kept, left) == (CAP, True, False)
        assert k == k_serial == int(want.iterations) == 50
        assert diff < 1e-6
        np.testing.assert_array_equal(arr[name], _one_process()[name])
        np.testing.assert_allclose(arr[name], np.asarray(want.w), rtol=0,
                                   atol=FP32_TOL)


@pytest.mark.parametrize("name", ["fused_serial", "ca_serial"])
def test_serial_mode_over_processes(two_ranks, name):
    _, arrays, _ = two_ranks
    for arr in arrays:
        np.testing.assert_array_equal(arr[name], _one_process()[name])


def test_batched_over_processes(two_ranks):
    _, arrays, reports = two_ranks
    for arr, rep in zip(arrays, reports):
        assert len(rep["batched"]) == len(GATES)
        np.testing.assert_array_equal(arr["batched"],
                                      _one_process()["batched"])


def test_two_rank_file_resumes_in_jax(two_ranks):
    out, _, _ = two_ranks
    path = str(out / "port_to_jax.npz")
    shutil.copy(out / "port_capped.npz", path)
    got = jax_ck_sharded.pcg_solve_sharded_checkpointed(
        JaxProblem(M=40, N=40), _jax_mesh(), path, chunk=CHUNK,
        dtype="float64")
    assert int(got.iterations) == 50
    np.testing.assert_allclose(np.asarray(got.w), _one_process()["plain"],
                               rtol=0, atol=FP64_TOL)


def test_jax_file_resumes_on_two_ranks(two_ranks):
    _, arrays, reports = two_ranks
    for arr, rep in zip(arrays, reports):
        assert rep["from_jax"] == [50, 1]
        np.testing.assert_allclose(arr["from_jax"], _one_process()["plain"],
                                   rtol=0, atol=FP64_TOL)


def test_one_shot_kernel_drivers_refuse_the_mesh(two_ranks):
    _, _, reports = two_ranks
    for rep in reports:
        fused, ca = rep["refused"]
        assert "fused_cg_solve_sharded_checkpointed" in fused
        assert "ca_cg_solve_sharded_checkpointed" in ca


def test_two_rank_trace_dir_merges_into_one_timeline(two_ranks):
    out, _, _ = two_ranks
    doc = merge_trace_dir(str(out / "trace"), str(out / "merged.json"))
    assert sorted(doc["otherData"]["ranks"]) == [0, 1]
    spans = [ev for ev in doc["traceEvents"]
             if ev.get("name") == "pcg_sharded"]
    assert sorted(ev["pid"] for ev in spans) == [0, 1]


def test_a_dead_rank_fails_its_peer(tmp_path):
    """Rank 1 exits holding its shards: rank 0's first transfer fails
    within the timeout instead of hanging."""
    (rc0, out0, err0, sec0), (rc1, _, _, _) = _launch(_DYING, tmp_path)
    assert rc1 == 3
    assert rc0 != 0 and "RANK0_SOLVED_ALONE" not in out0, err0[-2000:]
    assert sec0 < TIMEOUT
