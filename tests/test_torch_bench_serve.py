"""The port's bench serve modes (``poisson_tpu_torch.bench --serve …``)
against the repo's ``bench.py``, on the CPU at 40×40.

Each mode's record must carry the keys of ``bench.py``'s record literal
for that mode (read by ``ast``), load in ``benchmarks/regress.py`` and
land in a cohort of its own; the seeded traffic (arrival schedule, Zipf
families, geometry families, tenant draws) must be ``bench.py``'s for the
same seed; and the requests of ``--serve`` and of a fleet that loses a
device at t = 0 must finish with JAX's iteration counts and flags, request
by request.
"""

import ast
import json
from pathlib import Path

import pytest
import torch

import bench as jax_bench
from benchmarks import regress
from poisson_tpu_torch import bench
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
SMALL = Problem(M=40, N=40)
TENANTS = (("a", 1.0), ("b", 4.0))


@pytest.fixture(autouse=True)
def _fresh_registry():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    metrics.reset()
    torch.set_num_threads(saved)


def _jax_record_keys(function: str) -> tuple:
    """(record keys, detail keys) of the ``record = {...}`` literal that
    ``bench.py``'s ``function`` builds."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "record"
                        for t in node.targets)):
            keys = [k.value for k in node.value.keys]
            detail = node.value.values[keys.index("detail")]
            return set(keys), {k.value for k in detail.keys}
    raise AssertionError(f"no record literal in bench.py's {function}")


@pytest.fixture(scope="module")
def records():
    """One record of each serve mode at 40×40 on the CPU, with its
    verdict."""
    torch.set_num_threads(1)
    metrics.reset()
    return {
        "_serve_bench": bench.serve_record(SMALL, 8, CPU),
        "_serve_openloop_bench": bench.serve_openloop_record(
            SMALL, 8, 80.0, CPU),
        "_serve_fleet_bench": bench.serve_fleet_record(
            SMALL, 8, 2, CPU, fleet_devices=2, kill_device_at=0.0),
        "_serve_geometry_mix_bench": bench.serve_geometry_mix_record(
            SMALL, 6, 3, CPU),
        "_serve_repeat_fp_bench": bench.serve_repeat_fp_record(
            SMALL, 6, 3, CPU, rate=80.0),
        "_serve_tenants_bench": bench.serve_tenants_record(
            SMALL, 6, TENANTS, CPU),
    }


MODES = ["_serve_bench", "_serve_openloop_bench", "_serve_fleet_bench",
         "_serve_geometry_mix_bench", "_serve_repeat_fp_bench",
         "_serve_tenants_bench"]


@pytest.mark.parametrize("function", MODES)
def test_records_carry_bench_pys_keys(function, records):
    rec, ok = records[function]
    keys, detail = _jax_record_keys(function)
    assert set(rec) == keys
    assert set(rec["detail"]) == detail
    assert ok and rec["detail"]["lost"] == 0
    assert rec["detail"]["platform"] == "cpu"       # it ran where asked
    assert rec["detail"]["backend"] == "torch_serve"
    assert rec["detail"]["platform_fallback"] is False
    json.dumps(rec)


def test_fault_load_and_open_loop_records(records):
    rec, _ = records["_serve_bench"]
    assert rec["metric"] == "serve.p99_latency" and rec["unit"] == "seconds"
    det = rec["detail"]
    assert det["fault_load"] == "poison1"
    assert det["completed"] + det["errors"] == 8 and det["errors"] <= 1
    assert det["routed_backend"] == "off" and det["router"] is None
    rec, _ = records["_serve_openloop_bench"]
    det = rec["detail"]
    assert rec["metric"] == "serve.sustained_solves_per_sec"
    assert det["arrival_rate"] == 80.0 and det["completed"] == 8
    assert det["warmed_buckets"] == [1, 2, 4]


def test_fleet_record_survives_the_device_loss(records):
    det = records["_serve_fleet_bench"][0]["detail"]
    assert det["every_request_accounted"] and det["device_loss_fired"]
    assert det["device_topology"] == "2xcpu" and det["devices"] == 2
    assert det["fault_load"] == "kill_device@0"
    assert det["device_losses"] == 1


def test_mix_repeat_and_tenant_records(records):
    det = records["_serve_geometry_mix_bench"][0]["detail"]
    assert det["geometry_mix"] == 3 and det["completed"] == 6
    assert det["geometry_fingerprints"] == [
        f.fingerprint for f in jax_bench._geometry_families(3)]
    det = records["_serve_repeat_fp_bench"][0]["detail"]
    assert det["repeat_fingerprint"] == 3 and det["deflation"] is True
    assert det["krylov_hit_rate"] > 0 and det["warm_requests"] > 0
    det = records["_serve_tenants_bench"][0]["detail"]
    assert det["tenant_mix"] == "a:1,b:4"
    assert set(det["tenants"]) == {"a", "b"}
    assert sum(t["assigned"] for t in det["tenants"].values()) == 6


def test_records_land_in_cohorts_of_their_own(records):
    keys = set()
    for rec, _ in records.values():
        loaded = regress.records_from_result(rec, "port")
        assert loaded and loaded[0]["value"] == rec["value"]
        key = regress.cohort_key(regress.record_from_result(rec, "port"))
        keys.add(key)
        for backend in ("xla_serve", "xla"):
            for platform in ("tpu", "cpu"):
                jax_rec = json.loads(json.dumps(rec))
                jax_rec["detail"].update(backend=backend, platform=platform)
                assert key != regress.cohort_key(
                    regress.record_from_result(jax_rec, "jax"))
    assert len(keys) == len(records)


@pytest.mark.parametrize("field, values", [
    ("arrival_rate", (4.0, 80.0)),
    ("workers", (1, 2)),
    ("device_topology", ("2xcuda", "4xcuda")),
    ("tenant_mix", ("a:1,b:4", "a:1,b:2")),
    ("fault_load", ("clean", "kill_device@1")),
])
def test_cohorts_split_on_experiment_identity(records, field, values):
    rec = json.loads(json.dumps(records["_serve_fleet_bench"][0]))
    found = set()
    for value in values:
        rec["detail"][field] = value
        found.add(regress.cohort_key(regress.record_from_result(rec, "p")))
    assert len(found) == len(values)


@pytest.mark.parametrize("seed", [0, 3])
def test_seeded_traffic_is_bench_pys(seed):
    assert (bench._poisson_schedule(40, 4.0, seed)
            == jax_bench._poisson_schedule(40, 4.0, seed))
    assert (bench._zipf_families(40, 5, seed)
            == jax_bench._zipf_families(40, 5, seed))


def test_tenant_draws_and_families_are_bench_pys():
    import random

    names = [n for n, _ in TENANTS]
    weights = [w for _, w in TENANTS]
    assert bench._tenant_draws(TENANTS, 50) == random.Random(1).choices(
        names, weights=weights, k=50)
    ours = bench._geometry_families(9)
    theirs = jax_bench._geometry_families(9)
    assert [f.fingerprint for f in ours] == [f.fingerprint for f in theirs]
    assert bench._tenant_mix_string(TENANTS) == \
        jax_bench._tenant_mix_string(TENANTS)


def _float64(serve_pkg, monkeypatch):
    """Every SolveRequest the bench builds runs in fp64."""
    real = serve_pkg.SolveRequest

    def request(**kw):
        kw["dtype"] = "float64"
        return real(**kw)

    monkeypatch.setattr(serve_pkg, "SolveRequest", request)


def _jax_services(monkeypatch):
    """Capture the services ``bench.py``'s modes build."""
    import poisson_tpu.serve as jax_serve

    built = []
    real = jax_serve.SolveService

    def service(*a, **kw):
        built.append(real(*a, **kw))
        return built[-1]

    monkeypatch.setattr(jax_serve, "SolveService", service)
    _float64(jax_serve, monkeypatch)
    return built


def _jax_small():
    from poisson_tpu.config import Problem as JaxProblem

    return JaxProblem(M=SMALL.M, N=SMALL.N)


def _per_request(svc) -> dict:
    return {o.request_id: (o.kind, o.iterations, o.flag, o.converged,
                           o.shed_reason, o.error_type)
            for o in svc.outcomes()}


def test_serve_requests_equal_jax_s_in_fp64(monkeypatch, capsys):
    import jax

    import poisson_tpu_torch.serve as port_serve

    built = _jax_services(monkeypatch)
    assert jax_bench._serve_bench(_jax_small(), 8, jax.devices(),
                                  "cpu") == 0
    capsys.readouterr()
    _float64(port_serve, monkeypatch)
    keep = {}
    rec, ok = bench.serve_record(SMALL, 8, CPU, keep=keep)
    ours, theirs = _per_request(keep["service"]), _per_request(built[-1])
    assert ok and ours == theirs and len(ours) == 8
    assert sum(k == "result" for k, *_ in ours.values()) >= 7


def test_fleet_device_loss_requests_equal_jax_s_in_fp64(monkeypatch, capsys):
    import jax

    import poisson_tpu_torch.serve as port_serve

    built = _jax_services(monkeypatch)
    assert jax_bench._serve_fleet_bench(
        _jax_small(), 8, 2, None, None, jax.devices(), "cpu", fleet_devices=2,
        kill_device_at=0.0) == 0
    capsys.readouterr()
    _float64(port_serve, monkeypatch)
    keep = {}
    rec, ok = bench.serve_fleet_record(SMALL, 8, 2, CPU, fleet_devices=2,
                                       kill_device_at=0.0, keep=keep)
    ours, theirs = _per_request(keep["service"]), _per_request(built[-1])
    assert ok and rec["detail"]["device_loss_fired"]
    assert ours == theirs and len(ours) == 8


def test_open_loop_engines_agree_request_by_request():
    keep = {}
    bench.serve_openloop_record(SMALL, 8, 80.0, CPU, keep=keep)
    drain = {o.request_id: (o.iterations, o.flag)
             for o in keep["drain"].outcomes()}
    cont = {o.request_id: (o.iterations, o.flag)
            for o in keep["continuous"].outcomes()}
    assert drain == cont and len(drain) == 8


@pytest.mark.parametrize("argv, message", [
    (["--serve", "0"], "--serve must be >= 1"),
    (["--arrival-rate", "4"], "--arrival-rate is a --serve mode option"),
    (["--serve", "8", "--arrival-rate", "0"], "--arrival-rate must be > 0"),
    (["--workers", "2"], "--workers is a --serve mode option"),
    (["--serve", "8", "--workers", "2", "--devices", "1",
      "--kill-device-at", "1"], "--kill-device-at needs"),
    (["--serve", "8", "--kill-worker-at", "1"],
     "--kill-worker-at is a --serve --workers mode option"),
    (["--serve", "8", "--workers", "2", "--geometry-mix", "3"],
     "--geometry-mix and --workers are separate"),
    (["--serve", "8", "--geometry-mix", "2", "--repeat-fingerprint", "2"],
     "--repeat-fingerprint, --workers, and --geometry-mix"),
    (["--serve", "8", "--tenants", "a:x"], "--tenants: "),
    (["--serve", "8", "--tenants", "a:1", "--router"],
     "--router rides the plain and open-loop serve modes"),
    (["--router"], "--router is a --serve mode option"),
    (["--batch", "4", "--serve", "8"], "--batch and --serve are separate"),
    (["--serve", "x"], "usage: python -m poisson_tpu_torch.bench"),
])
def test_command_line_refusals_are_bench_pys(argv, message, capsys):
    assert bench.main(argv) == 2
    assert message in capsys.readouterr().err


def test_command_line_runs_a_serve_mode_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert bench.main(["--serve", "4", "--router", "--device", "cpu",
                       "--out", str(out), "40", "40"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec == json.loads(out.read_text())
    assert rec["detail"]["routed_backend"] == "auto"
    assert rec["detail"]["router"]["decisions"] >= 1
