"""Port parity: checkpointed and chunked solves
(``poisson_tpu_torch.solvers.checkpoint`` and the fused and CA
``*_checkpointed`` drivers) against ``poisson_tpu.solvers.checkpoint`` and
the Pallas checkpointed drivers, on the CPU.

A checkpoint file is the same file in both packages: the same keys,
dtypes, 0-d shapes, fingerprint string and CRC32. The tests write files
with one package and read or resume them with the other (the JAX kernels
in interpret mode, as tests/test_pallas.py runs them).

Tolerances: a chunked solve equals its one-shot solve bit for bit (the
loops freeze a done state and a chunk stops at min(k + chunk, cap)); a
solve resumed in the other package gives the other package's one-shot
count exactly, with an iterate within 1e-6 of its one-shot iterate (the
JAX resume forms the direction as r + 1·(d − r), one ulp from d)."""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.ops import pallas_cg
from poisson_tpu.solvers import checkpoint as jck
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch import cli
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.ops import ca_cg, fused_cg
from poisson_tpu_torch.solvers import checkpoint as ck
from poisson_tpu_torch.solvers.pcg import pcg_solve


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


FP_CASES = [((40, 40), "float32", True), ((800, 1200), "float64", False),
            ((40, 300), "float32", False)]


@pytest.mark.parametrize("shape,dtype_name,scaled", FP_CASES)
def test_fingerprint_is_the_jax_string(shape, dtype_name, scaled):
    M, N = shape
    p = Problem(M=M, N=N, max_iter=17)
    jp = JaxProblem(M=M, N=N, max_iter=99)    # max_iter is not identity
    assert (ck._fingerprint(p, dtype_name, scaled)
            == jck._fingerprint(jp, dtype_name, scaled))


def _capped_fused_file(path, M=40, N=40, cap=20):
    """A fused-path checkpoint of a solve capped at ``cap`` iterations."""
    p = Problem(M=M, N=N, max_iter=cap)
    r = fused_cg.fused_cg_solve_checkpointed(p, path, chunk=7, device="cpu")
    assert int(r.iterations) == cap and os.path.exists(path)
    return p


def test_port_file_passes_the_jax_reader(tmp_path):
    path = str(tmp_path / "ck.npz")
    p = _capped_fused_file(path)
    fp = ck._fingerprint(p, "float32", True)
    got = jck._read_state(path, fp)           # CRC checked inside
    mine = ck._read_state(path, fp)
    assert int(got.k) == int(mine.k) == 20
    for key in ("w", "r", "z", "p", "zr", "diff"):
        np.testing.assert_array_equal(np.asarray(getattr(got, key)),
                                      getattr(mine, key).numpy())
    with np.load(path) as data:
        for key, dtype in (("k", np.int32), ("done", np.bool_),
                           ("zr", np.float32), ("diff", np.float32),
                           ("flag", np.int32), ("best", np.float64),
                           ("stall", np.int32)):
            assert data[key].dtype == dtype and data[key].shape == ()
        assert data["w"].shape == p.grid_shape
        assert int(data["crc32"]) == jck._payload_crc(
            fp, {k: data[k] for k in jck._STATE_KEYS})


def test_jax_file_passes_the_port_reader(tmp_path):
    path = str(tmp_path / "ck.npz")
    jp = JaxProblem(M=40, N=40, max_iter=20)
    r = pallas_cg.pallas_cg_solve_checkpointed(jp, path, chunk=7,
                                               interpret=True)
    assert int(r.iterations) == 20
    fp = ck._fingerprint(Problem(M=40, N=40), "float32", True)
    state = ck._read_state(path, fp)
    want = jck._read_state(path, fp)
    assert state.k.dtype == torch.int32 and int(state.k) == 20
    assert state.zr.dtype == torch.float32 and state.zr.dim() == 0
    np.testing.assert_array_equal(state.p.numpy(), np.asarray(want.p))


def test_plain_solve_files_cross_both_ways(tmp_path):
    """The plain fp64 solve's file (unscaled fingerprint) crosses too."""
    p, jp = Problem(M=40, N=40, max_iter=15), JaxProblem(M=40, N=40,
                                                         max_iter=15)
    fp = ck._fingerprint(p, "float64", False)
    mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    ck.pcg_solve_checkpointed(p, mine, chunk=5, dtype=torch.float64,
                              device="cpu")
    jck.pcg_solve_checkpointed(jp, theirs, chunk=5, dtype=jnp.float64)
    a, b = jck._read_state(mine, fp), ck._read_state(theirs, fp)
    assert int(a.k) == int(b.k) == 15
    np.testing.assert_allclose(np.asarray(a.w), b.w.numpy(), atol=1e-12)


def _corrupt(path, how):
    data = bytearray(open(path, "rb").read())
    if how == "truncate":
        data = data[: len(data) // 2]
    else:
        data[len(data) // 2] ^= 0x40
    open(path, "wb").write(bytes(data))


@pytest.mark.parametrize("how", ["truncate", "bitflip"])
def test_corrupt_newest_generation_falls_back(tmp_path, how):
    path = str(tmp_path / "ck.npz")
    p = _capped_fused_file(path)            # chunks of 7: k 7, 14, 20
    assert os.path.exists(path + ".1")
    _corrupt(path, how)
    fp = ck._fingerprint(p, "float32", True)
    with pytest.warns(RuntimeWarning, match="generation"):
        state = ck.load_state(path, fp)
    assert int(state.k) == 14               # the older generation
    with pytest.raises(ck.CorruptCheckpointError):
        ck._read_state(path, fp)


def test_mismatched_fingerprint_raises(tmp_path):
    path = str(tmp_path / "ck.npz")
    _capped_fused_file(path)
    os.remove(path + ".1")
    other = ck._fingerprint(Problem(M=40, N=41), "float32", True)
    with pytest.raises(ValueError, match="different problem"):
        ck.load_state(path, other)


def test_fused_chunks_equal_the_one_shot_solve(tmp_path):
    p = Problem(M=40, N=40)
    one = fused_cg.fused_cg_solve(p, device="cpu")
    path = str(tmp_path / "ck.npz")
    chunked = fused_cg.fused_cg_solve_checkpointed(p, path, chunk=7,
                                                   device="cpu")
    assert int(chunked.iterations) == int(one.iterations) == 50
    assert torch.equal(chunked.w, one.w)
    assert not os.path.exists(path)        # removed on convergence
    # Capped, then resumed with the full budget: the same bits.
    _capped_fused_file(path, cap=23)
    resumed = fused_cg.fused_cg_solve_checkpointed(p, path, chunk=7,
                                                   device="cpu")
    assert int(resumed.iterations) == 50
    assert torch.equal(resumed.w, one.w)


def test_jax_blocked_write_resumes_on_the_port_full_width(tmp_path):
    M, N = 40, 300
    path = str(tmp_path / "ck.npz")
    capped = JaxProblem(M=M, N=N, max_iter=20)
    part = pallas_cg.pallas_cg_solve_checkpointed(capped, path, chunk=7,
                                                  bn=256, interpret=True)
    assert int(part.iterations) == 20
    got = fused_cg.fused_cg_solve_checkpointed(Problem(M=M, N=N), path,
                                               chunk=7, bn=0, device="cpu")
    ref = pallas_cg.pallas_cg_solve(JaxProblem(M=M, N=N), bn=0,
                                    interpret=True)
    assert int(got.iterations) == int(ref.iterations)
    np.testing.assert_allclose(got.w.numpy(), np.asarray(ref.w), atol=1e-6)


def test_port_write_resumes_in_jax(tmp_path):
    M, N = 40, 300
    path = str(tmp_path / "ck.npz")
    part = fused_cg.fused_cg_solve_checkpointed(
        Problem(M=M, N=N, max_iter=20), path, chunk=7, bn=128, device="cpu")
    assert int(part.iterations) == 20
    got = pallas_cg.pallas_cg_solve_checkpointed(JaxProblem(M=M, N=N), path,
                                                 chunk=7, bn=0,
                                                 interpret=True)
    one = fused_cg.fused_cg_solve(Problem(M=M, N=N), device="cpu")
    assert int(got.iterations) == int(one.iterations)
    np.testing.assert_allclose(np.asarray(got.w), one.w.numpy(), atol=1e-6)


def test_ca_checkpoint_resumes_on_the_fused_path(tmp_path):
    p = Problem(M=40, N=40)
    path = str(tmp_path / "ck.npz")
    part = ca_cg.ca_cg_solve_checkpointed(dataclasses.replace(p, max_iter=21),
                                          path, chunk=6, device="cpu")
    assert int(part.iterations) == 21
    got = fused_cg.fused_cg_solve_checkpointed(p, path, chunk=6,
                                               device="cpu")
    one = fused_cg.fused_cg_solve(p, device="cpu")
    assert int(got.iterations) == int(one.iterations) == 50
    np.testing.assert_allclose(got.w.numpy(), one.w.numpy(), atol=1e-6)
    # And the CA chunks themselves reach the one-shot CA solve's count.
    ca_full = ca_cg.ca_cg_solve_checkpointed(p, path + ".ca", chunk=6,
                                             device="cpu")
    assert int(ca_full.iterations) == int(ca_cg.ca_cg_solve(
        p, device="cpu").iterations)


def test_chunked_plain_solve_equals_one_shot():
    p = Problem(M=40, N=40)
    one = pcg_solve(p, dtype=torch.float64, device="cpu")
    chunked = ck.pcg_solve_chunked(p, chunk=7, dtype=torch.float64,
                                   device="cpu")
    assert int(chunked.iterations) == int(one.iterations) == 50
    assert torch.equal(chunked.w, one.w)
    want = jax_pcg_solve(JaxProblem(M=40, N=40), dtype=jnp.float64).w
    np.testing.assert_allclose(one.w.numpy(), np.asarray(want), atol=1e-12)


def test_checkpointed_plain_solve_equals_one_shot(tmp_path):
    p = Problem(M=40, N=40)
    path = str(tmp_path / "ck.npz")
    ck.pcg_solve_checkpointed(dataclasses.replace(p, max_iter=12), path,
                              chunk=7, dtype=torch.float64, device="cpu")
    got = ck.pcg_solve_checkpointed(p, path, chunk=7, dtype=torch.float64,
                                    device="cpu")
    one = pcg_solve(p, dtype=torch.float64, device="cpu")
    assert int(got.iterations) == 50 and torch.equal(got.w, one.w)
    assert not os.path.exists(path) and not os.path.exists(path + ".1")


class _Deadline:
    def __init__(self, after: int):
        self.calls, self.after = 0, after

    def expired(self) -> bool:
        self.calls += 1
        return self.calls > self.after


def test_run_chunked_hooks():
    """A duck-typed deadline stops the loop at a chunk boundary (flag
    "deadline" on the result); on_chunk sees every chunk; a watchdog is
    started, beaten per chunk and stopped."""
    events = []

    class Watchdog:
        def start(self):
            events.append("start")

        def beat(self, k, diff):
            events.append(("beat", k))

        def stop(self):
            events.append("stop")

        def raise_if_fired(self):
            pass

    seen = []
    r = ck.pcg_solve_chunked(Problem(M=40, N=40), chunk=10,
                             dtype=torch.float64, device="cpu",
                             deadline=_Deadline(2), watchdog=Watchdog(),
                             on_chunk=lambda s, n: seen.append(int(s.k)))
    assert int(r.iterations) == 20 and int(r.flag) == 5   # FLAG_DEADLINE
    assert seen == [10, 20]
    assert events == ["start", ("beat", 10), ("beat", 20), "stop"]


def _cli(argv, capsys):
    assert cli.main([*argv, "--device", "cpu", "--json"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("backend", ["fused", "ca", "torch"])
def test_cli_checkpoint_kept_on_cap_and_removed_on_convergence(
        tmp_path, capsys, backend):
    path = str(tmp_path / "ck.npz")
    extra = ["--backend", backend, "--checkpoint", path, "--chunk", "8"]
    if backend == "torch":
        extra += ["--dtype", "float64"]
    rec = _cli(["40", "40", "--max-iter", "20", *extra], capsys)
    assert rec["iterations"] == 20 and os.path.exists(path)
    rec = _cli(["40", "40", *extra], capsys)
    assert rec["iterations"] == 50 and rec["stopped"] is None
    assert not os.path.exists(path)


def test_cli_blocked_and_serial_flags(capsys):
    rec = _cli(["40", "300", "--bn", "128", "--serial-reduce"], capsys)
    ref = pallas_cg.pallas_cg_solve(JaxProblem(M=40, N=300), bn=128,
                                    serial=True, interpret=True)
    assert rec["iterations"] == int(ref.iterations)


@pytest.mark.parametrize("argv,message", [
    (["--backend", "resident", "--checkpoint", "x.npz"], "one kernel launch"),
    (["--backend", "ca", "--bn", "128"], "--bn"),
    (["--backend", "resident", "--serial-reduce"], "--serial-reduce"),
    (["--bn", "100"], "multiple of 128"),
], ids=["resident", "bn_ca", "serial_resident", "bn_not_lane"])
def test_cli_refuses_what_a_backend_does_not_take(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["40", "40", "--device", "cpu", *argv])


@functools.lru_cache(maxsize=None)
def _jax_sharded_count(dtype_name):
    import jax
    from poisson_tpu.parallel import make_solver_mesh, pcg_solve_sharded

    mesh = make_solver_mesh(jax.devices()[:4], grid=(2, 2))
    r = pcg_solve_sharded(JaxProblem(M=40, N=40), mesh,
                          dtype=getattr(jnp, dtype_name))
    return int(r.iterations)


@pytest.mark.parametrize("argv,backend,dtype", [
    (["--mesh", "2x2", "--checkpoint", "{ck}"], "fused-sharded", "float32"),
    (["--mesh", "2x2", "--dtype", "float64"], "sharded", "float64"),
    (["--backend", "sharded", "--mesh", "2x2"], "sharded", "float32"),
    (["--backend", "sharded", "--mesh", "2x2", "--setup", "device"],
     "sharded", "float32"),
    (["--backend", "sharded", "--mesh", "2x2", "--dtype", "float64",
      "--checkpoint", "{ck}", "--chunk", "7"], "sharded", "float64"),
    (["--backend", "ca-sharded", "--mesh", "2x2", "--checkpoint", "{ck}",
      "--serial-reduce"], "ca-sharded", "float32"),
], ids=["auto_mesh_checkpoint", "auto_mesh_fp64", "sharded",
        "sharded_device_setup", "sharded_checkpoint", "ca_sharded_checkpoint"])
def test_cli_mesh_solves_the_jax_cli_runs(tmp_path, capsys, argv, backend,
                                          dtype):
    """The JAX CLI's mesh runs (``poisson_tpu/cli.py:359-375``, 514-523):
    ``auto`` with a mesh and a checkpoint, or a mesh in fp64, and the
    sharded backends with a checkpoint; each gives the JAX sharded count
    and removes its converged checkpoint."""
    ck = str(tmp_path / "ck.npz")
    rec = _cli([a.format(ck=ck) for a in ["40", "40", *argv]], capsys)
    assert rec["backend"] == backend and rec["dtype"] == dtype
    assert rec["iterations"] == _jax_sharded_count(dtype) == 50
    assert rec["stopped"] is None and rec["mesh"] == [2, 2]
    assert not os.path.exists(ck)


@pytest.mark.parametrize("argv,message", [
    (["--backend", "fused-sharded", "--setup", "device"], "--setup device"),
    (["--backend", "sharded", "--setup", "device", "--checkpoint", "x.npz"],
     "gathers state on the host"),
], ids=["fused_sharded_device_setup", "sharded_checkpoint_device_setup"])
def test_cli_refuses_what_the_jax_cli_refuses(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli.main(["40", "40", "--device", "cpu", "--mesh", "2x2", *argv])


# JAX backend → the port's, with the card in the TPU's place.
_JAX_NAMES = {"pallas-sharded": "fused-sharded", "sharded": "sharded",
              "xla": "torch", "pallas": "fused"}
PICK_CASES = [(dtype, visible, mesh, checkpoint, setup)
              for dtype in ("float32", "float64") for visible in (1, 4)
              for mesh in (None, (2, 2)) for checkpoint in (None, "x.npz")
              for setup in ("host", "device")]
# The cases above keep the ids they had before geometry joined them; the
# geometry cases (``--geometry`` given) follow with their own.
_GEOMETRY = '{"type": "ellipse", "rx": 0.7, "ry": 0.4}'
PICK_PARAMS = [
    pytest.param(*case, None, id="-".join(
        [str(case[0]), str(case[1]),
         "None" if case[2] is None else f"mesh{i}", str(case[3]), case[4]]))
    for i, case in enumerate(PICK_CASES)] + [
    pytest.param(*case, _GEOMETRY, id="geometry-" + "-".join(
        [str(case[0]), str(case[1]), "None" if case[2] is None else "mesh",
         str(case[3]), case[4]]))
    for case in PICK_CASES[::3]]


@pytest.mark.parametrize("dtype,visible,mesh,checkpoint,setup,geometry",
                         PICK_PARAMS)
def test_pick_backend_is_the_jax_choice(monkeypatch, dtype, visible, mesh,
                                        checkpoint, setup, geometry):
    """``auto`` resolves as the JAX CLI's ``_pick_backend`` does on a host
    of ``visible`` TPU chips, each JAX backend mapped to its port (with a
    ``--geometry``, to the plain solve)."""
    import types

    import jax
    from poisson_tpu import cli as jax_cli

    chip = types.SimpleNamespace(platform="tpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [chip] * visible)
    args = types.SimpleNamespace(
        backend="auto", resilient=False, geometry=geometry,
        preconditioner="jacobi", mesh=mesh, dtype=dtype, setup=setup,
        checkpoint=checkpoint)
    want = _JAX_NAMES[jax_cli._pick_backend(args)]
    assert cli.pick_backend("auto", dtype, visible, mesh, checkpoint,
                            setup, geometry=geometry) == want
