"""The port's program-contract gate (``poisson_tpu_torch.contracts``), the
counterpart of ``tests/test_contracts.py``:

- every lint rule fires on a fixture and is silenced by a reasoned
  suppression (synthetic sources through ``lint_source``); the
  ``static-default`` rule's jit half is exempt in writing;
- the tree lints clean and its registries do not drift;
- the program ledger holds and bites: the committed ledger matches this
  tree, a mutated flag-off program is caught (a host read in the step
  structurally, an extra op by fingerprint), a changed CUDA source is
  caught, an absent or corrupt ledger fails the gate, an environment
  mismatch is reported as such, and ``--update-ledger`` then a recheck is
  stable;
- the gate exits 0 on this tree.
"""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from poisson_tpu_torch.contracts import manifest, trace
from poisson_tpu_torch.contracts.lint import (
    RULES,
    STATIC_DEFAULT_EXEMPTION,
    documented_metric_names,
    lint_source,
    repo_root,
    run_lint,
)

ROOT = repo_root()
PCG = "poisson_tpu_torch/solvers/pcg.py"
SPECS = {s.name: s for s in manifest.PROGRAMS}


def _rules(findings, suppressed=None):
    return sorted({f.rule for f in findings
                   if suppressed is None or f.suppressed == suppressed})


# -- lint rules: a firing and a suppressed fixture each -------------------


@pytest.mark.parametrize("read", ["float(s.diff)", "s.k.item()",
                                  "s.w.cpu()", "s.flag.tolist()",
                                  "bool(torch.all(s.done))",
                                  "torch.cuda.synchronize()"])
def test_callback_gate_fires_on_host_reads_in_a_step_body(read):
    bad = ("import torch\n"
           "def make_pcg_body(ops):\n"
           "    def body(s):\n"
           f"        x = {read}\n"
           "        return s\n"
           "    return body\n")
    assert "callback-gate" in _rules(lint_source(PCG, bad),
                                     suppressed=False)


def test_callback_gate_gates_suppresses_and_spares_drivers():
    gated = ("def make_pcg_body(ops, stream_every):\n"
             "    def body(s):\n"
             "        if stream_every > 0:\n"
             "            print(float(s.diff))\n"
             "        return s\n"
             "    return body\n")
    assert not lint_source(PCG, gated)
    local = ("def loop(s, cap):\n"
             "    def step(s):\n"
             "        s.k.item()\n"
             "        return s\n"
             "    return drive(step, s, cap)\n")
    assert _rules(lint_source(PCG, local)) == ["callback-gate"]
    # the driver's own read of done is the sanctioned site
    driver = ("import torch\n"
              "def drive(step, s, cap):\n"
              "    while not bool(torch.all(s.done)):\n"
              "        s = step(s)\n"
              "    return s\n")
    assert not lint_source(PCG, driver)
    # so is the stream sink
    assert not lint_source("poisson_tpu_torch/obs/stream.py", local)
    sup = local.replace(
        "        s.k.item()\n",
        "        # contracts: allow=callback-gate -- a block step waits anyway\n"
        "        s.k.item()\n")
    found = lint_source(PCG, sup)
    assert _rules(found, suppressed=True) == ["callback-gate"]
    assert found[0].reason == "a block step waits anyway"


def test_traced_branch_fires_and_suppresses():
    bad = ("def make_block_step(ops, cap):\n"
           "    def step(s):\n"
           "        if s.done.all():\n"
           "            return s\n"
           "        return ops.apply(s)\n"
           "    return step\n")
    assert "traced-branch" in _rules(lint_source(PCG, bad),
                                     suppressed=False)
    ok = bad.replace("if s.done.all():", "if cap > 0:")
    assert not lint_source(PCG, ok)
    identity = bad.replace("if s.done.all():", "if s is None:")
    assert not lint_source(PCG, identity)
    loop = bad.replace("if s.done.all():\n            return s\n",
                       "while s.k < 3:\n            s = ops.apply(s)\n")
    assert "traced-branch" in _rules(lint_source(PCG, loop))
    sup = bad.replace(
        "        if s.done.all():",
        "        # contracts: allow=traced-branch -- test fixture\n"
        "        if s.done.all():")
    assert _rules(lint_source(PCG, sup), suppressed=False) == []


def test_static_default_fires_and_suppresses():
    bad = "def g(acc={}, x=None):\n    return acc\n"
    assert _rules(lint_source(PCG, bad)) == ["static-default"]
    assert not lint_source(PCG, bad.replace("acc={}", "acc=()"))
    policy = "def g(p=RetryPolicy()):\n    return p\n"
    assert not lint_source(PCG, policy)
    kwonly = "def g(*, acc=[]):\n    return acc\n"
    found = lint_source(PCG, kwonly)
    assert [f.rule for f in found] == ["static-default"]
    assert "acc" in found[0].message
    sup = bad.replace("def g(acc={}, x=None):",
                      "def g(acc={}, x=None):  "
                      "# contracts: allow=static-default -- test fixture")
    assert not _rules(lint_source(PCG, sup), suppressed=False)
    # out of solver scope the rule does not look
    assert not lint_source("poisson_tpu_torch/serve/service.py", bad)


def test_static_default_jit_half_is_exempt_in_writing():
    # JAX's rule also checks jax.jit static-arg defaults; the port has no
    # such compile cache, so that half is a written exemption.
    assert "jit static-arg defaults" in STATIC_DEFAULT_EXEMPTION
    from poisson_tpu_torch.contracts import lint

    assert "STATIC_DEFAULT_EXEMPTION" in lint.__doc__


def test_wallclock_and_rng_fire_and_scope():
    bad = ("import time, random\n"
           "import numpy as np\n"
           "def setup():\n"
           "    t0 = time.time()\n"
           "    jitter = random.random()\n"
           "    noise = np.random.normal()\n"
           "    return t0 + jitter + noise\n")
    assert _rules(lint_source(PCG, bad), suppressed=False) == ["rng",
                                                               "wallclock"]
    assert not lint_source("poisson_tpu_torch/serve/service.py", bad)
    seeded = ("import numpy as np, random\n"
              "def setup(seed):\n"
              "    return (np.random.default_rng(seed).normal(),\n"
              "            random.Random(seed).random())\n")
    assert not lint_source(PCG, seeded)
    assert not lint_source("poisson_tpu_torch/parallel/watchdog.py", bad)
    sup = bad.replace("    t0 = time.time()\n",
                      "    t0 = time.time()  # contracts: allow=wallclock "
                      "-- build timing\n")
    assert _rules(lint_source(PCG, sup), suppressed=False) == ["rng"]


def test_counter_doc_fires_against_catalogue():
    ctx = {"metric_names": documented_metric_names(
        '"""Counters:\n'
        "- ``pcg.solves.<verdict>`` and ``serve.shed.{a,b}`` and\n"
        "  ``plain.counter``.\n"
        '"""\n'), "flight_kinds": set()}
    src = ("from poisson_tpu_torch import obs\n"
           "def f(tag):\n"
           "    obs.inc('plain.counter')\n"
           "    obs.inc('serve.shed.a')\n"
           "    obs.inc(f'pcg.solves.{tag}')\n"
           "    obs.inc('rogue.counter')\n")
    found = lint_source("poisson_tpu_torch/serve/service.py", src, ctx)
    assert [f.rule for f in found] == ["counter-doc"]
    assert "rogue.counter" in found[0].message
    sup = src.replace("    obs.inc('rogue.counter')\n",
                      "    # contracts: allow=counter-doc -- migration\n"
                      "    obs.inc('rogue.counter')\n")
    assert not _rules(lint_source("poisson_tpu_torch/serve/service.py",
                                  sup, ctx), suppressed=False)


def test_flight_kind_fires_against_declared_kinds():
    ctx = {"metric_names": (set(), set()),
           "flight_kinds": {"queue_wait", "retry"}}
    src = ("def f(self, rid):\n"
           "    self._flight.begin(rid, 'queue_wait')\n"
           "    self._flight.point(rid, 'undeclared_kind')\n")
    found = lint_source("poisson_tpu_torch/serve/service.py", src, ctx)
    assert [f.rule for f in found] == ["flight-kind"]
    sup = src.replace("    self._flight.point(rid, 'undeclared_kind')\n",
                      "    # contracts: allow=flight-kind -- fixture\n"
                      "    self._flight.point(rid, 'undeclared_kind')\n")
    assert not _rules(lint_source("poisson_tpu_torch/serve/service.py",
                                  sup, ctx), suppressed=False)


def test_chaos_registry_fires_for_unregistered_scenario():
    src = ("@scenario('reg')\n"
           "def _registered(seed):\n"
           "    return {}\n"
           "def _forgotten(seed):\n"
           "    return {}\n")
    found = lint_source("poisson_tpu_torch/testing/chaos.py", src)
    assert [f.rule for f in found] == ["chaos-registry"]
    assert not lint_source("poisson_tpu_torch/serve/service.py", src)
    sup = src.replace("def _forgotten(seed):",
                      "# contracts: allow=chaos-registry -- helper\n"
                      "def _forgotten(seed):")
    assert not _rules(lint_source("poisson_tpu_torch/testing/chaos.py",
                                  sup), suppressed=False)


def test_fingerprint_key_fires_in_key_builders():
    src = ("def dispatch(problem, spec, size, dtype_name):\n"
           "    key = (size, problem, dtype_name, spec.fingerprint)\n"
           "    return key\n")
    found = lint_source("poisson_tpu_torch/solvers/batched.py", src)
    assert [f.rule for f in found] == ["fingerprint-key"]
    assert not lint_source("poisson_tpu_torch/solvers/batched.py",
                           src.replace(", spec.fingerprint", ", 'geo'"))
    sup = src.replace("    key = (",
                      "    # contracts: allow=fingerprint-key -- fixture\n"
                      "    key = (")
    assert not _rules(lint_source("poisson_tpu_torch/solvers/batched.py",
                                  sup), suppressed=False)


def test_suppression_without_reason_is_a_finding():
    src = ("import time\n"
           "def setup():\n"
           "    # contracts: allow=wallclock\n"
           "    return time.time()\n")
    found = lint_source(PCG, src)
    assert _rules(found, suppressed=False) == ["suppression-reason"]
    doc = '"""Docs.\n\nExample: # contracts: allow=wallclock\n"""\n'
    assert not lint_source(PCG, doc)


def test_every_rule_has_a_fixture_here():
    src = open(__file__).read()
    assert len(RULES) == 10
    for rule in RULES:
        assert rule in src, f"rule {rule} has no fixture in this file"


# -- the tree --------------------------------------------------------------


def test_tree_lint_is_clean():
    rep = run_lint(ROOT)
    active = [f for f in rep["findings"] if not f["suppressed"]]
    assert active == [], "\n".join(
        f"{f['file']}:{f['line']}: [{f['rule']}] {f['message']}"
        for f in active)
    assert all(f["reason"] for f in rep["findings"])


def test_tree_drift_is_clean():
    from poisson_tpu_torch.contracts.drift import run_drift

    rep = run_drift(ROOT)
    assert rep["findings"] == [], rep["findings"]


def test_drift_bites_on_an_unlisted_detail_key_and_a_stale_exemption():
    from poisson_tpu_torch.contracts.drift import (
        check_bench_cohort,
        check_policy_coverage,
    )

    bench = ('def r():\n    return {"detail": {"grid": 1, '
             '"new_axis": 2}}\n')
    regress = ("def record_from_result(r):\n    det = r\n"
               "    return det.get('grid')\n")
    found = check_bench_cohort(bench, regress, {"gone": "why"})
    assert sorted(f.rule for f in found) == ["attribution-stale",
                                             "bench-detail-cohort"]
    types = ("class ServicePolicy:\n    capacity: int = 1\n"
             "    knob: int = 0\n")
    found = check_policy_coverage(types, "f(capacity=1)\n", {})
    assert [f.rule for f in found] == ["policy-chaos-coverage"]
    assert not check_policy_coverage(types, "f(capacity=1)\n",
                                     {"ServicePolicy.knob": "why"})


# -- the program ledger ----------------------------------------------------


def test_traces_are_canonical_and_repeatable():
    spec = SPECS["stencil.apply_A_unbatched"]
    a = manifest.record_program(spec)
    assert a == manifest.record_program(spec)
    assert all(line.split(" ", 1)[0] in trace.PHASES for line in a)
    assert not any("0x" in line for line in a)       # no address
    steps = manifest.record_program(SPECS["solve.jacobi_f64"])
    assert {line.split(" ", 1)[0] for line in steps} >= {"step", "drive"}
    assert any("_local_scalar_dense" in line for line in steps
               if line.startswith("drive "))         # drive's done read


def test_markers():
    lines = ["step aten::add.Tensor (float64[3]) -> float64[3]",
             "drive aten::_local_scalar_dense (bool[]) -> bool",
             "step _c10d_functional::all_reduce (float64[3]) -> x",
             "setup aten::mm (float64[2, 2]) -> float64[2, 2]"]
    assert trace.structural_violations(lines, ("callbacks",)) == []
    assert trace.structural_violations(
        lines, ("collectives", "mg")) == [
            "collectives:_c10d_functional::", "collectives:all_reduce",
            "mg:aten::mm"]
    bad = lines + ["step aten::_local_scalar_dense (float64[]) -> float"]
    assert trace.structural_violations(bad, ("callbacks",)) == [
        "callbacks:aten::_local_scalar_dense"]


def test_committed_ledger_matches_and_pairs_are_equal():
    led = manifest.load_ledger()
    assert led["schema"] == manifest.LEDGER_SCHEMA
    assert set(led["entries"]) == set(SPECS)
    assert set(led["kernels"]) == {f"kernels.{k.name}"
                                   for k in manifest.KERNEL_SOURCES}
    for a, b in manifest.EQUAL_PROGRAMS:
        assert led["entries"][a]["fingerprint"] == \
            led["entries"][b]["fingerprint"]
    for name, entry in led["kernels"].items():
        assert entry == manifest.kernel_entry(
            next(k for k in manifest.KERNEL_SOURCES
                 if f"kernels.{k.name}" == name))


def test_kernel_launch_configuration_is_read_off_the_source():
    spec = next(k for k in manifest.KERNEL_SOURCES if k.name == "fused_cg")
    launch = manifest.kernel_entry(spec)
    assert set(launch["globals"]) == {
        "direction_stencil_kernel", "direction_stencil_sharded",
        "fused_update_kernel", "fused_update_sharded",
        "recurrence_step_kernel", "recurrence_close_kernel"}
    src = (Path(ROOT) / "poisson_tpu_torch/ops/csrc/fused_cg.cu").read_text()
    cfg = manifest.launch_configuration(src)
    assert cfg["constants"]["kBlock"] == "256"
    assert cfg["globals"]["fused_update_kernel"] == "kBlock"
    assert "fused_update_kernel<<<blocks, kBlock, 0, stream>>>" in \
        cfg["launches"]
    assert cfg["globals"]["recurrence_close_kernel"] == "1"
    assert "recurrence_step_kernel<<<1, 1, 0, stream>>>" in cfg["launches"]
    assert manifest.nvcc_command("fused_cg")[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in manifest.nvcc_command(
        "fused_cg")


def _mutate_step(monkeypatch, extra):
    """Every plain PCG step also runs ``extra(state)``."""
    from poisson_tpu_torch.solvers import pcg

    real = pcg.make_pcg_member_body

    def mutated(*a, **kw):
        member = real(*a, **kw)

        def body(s, vrhs=None):
            extra(s)
            return member(s, vrhs)

        return body

    monkeypatch.setattr(pcg, "make_pcg_member_body", mutated)


def test_a_host_read_in_a_flag_off_step_is_caught(monkeypatch):
    _mutate_step(monkeypatch, lambda s: float(s.diff))
    rep = manifest.run_ledger_check(programs=(SPECS["solve.jacobi_f64"],))
    kinds = {p["kind"] for p in rep["problems"]}
    assert kinds == {"trace-structure", "ledger-drift"}
    assert "callbacks:aten::_local_scalar_dense" in json.dumps(
        rep["problems"])


def test_an_extra_op_in_a_flag_off_step_is_caught(monkeypatch):
    _mutate_step(monkeypatch, lambda s: s.w.clone())
    rep = manifest.run_ledger_check(programs=(SPECS["solve.scaled_f32"],))
    assert [p["kind"] for p in rep["problems"]] == ["ledger-drift"]


def test_a_changed_cuda_source_is_caught(tmp_path):
    from poisson_tpu_torch.ops._build import CSRC

    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    path = csrc / "ca_cg.cu"
    path.write_text(path.read_text().replace(
        "constexpr int kThreads = 256;", "constexpr int kThreads = 128;"))
    rep = manifest.run_ledger_check(programs=(), csrc=str(csrc))
    assert [(p["kind"], p["program"]) for p in rep["problems"]] == [
        ("kernel-drift", "kernels.ca_cg")]
    assert "source/launch" in rep["problems"][0]["message"]


@pytest.mark.parametrize("content", [None, "{torn", "[]"])
def test_an_absent_or_corrupt_ledger_fails(tmp_path, content):
    path = tmp_path / "ledger.json"
    if content is not None:
        path.write_text(content)
    rep = manifest.run_ledger_check(path=str(path), programs=())
    assert [p["kind"] for p in rep["problems"]] == ["ledger-absent"]


def test_another_environment_is_reported_not_confirmed(tmp_path):
    led = manifest.load_ledger()
    led["torch_version"] = "0.0.0-other"
    name = "stencil.apply_A_unbatched"
    led["entries"][name]["fingerprint"] = "0" * 64
    path = tmp_path / "ledger.json"
    path.write_text(json.dumps(led))
    rep = manifest.run_ledger_check(path=str(path), programs=(SPECS[name],))
    assert [(p["kind"], p["program"]) for p in rep["problems"]] == [
        ("ledger-environment", name)]


def test_update_then_recheck_is_stable(tmp_path):
    path = str(tmp_path / "ledger.json")
    specs = (SPECS["stencil.apply_A_unbatched"], SPECS["lanes.member_init"])
    first = manifest.run_ledger_check(update=True, path=path,
                                      programs=specs)
    assert first["updated"] and first["problems"] == []
    again = manifest.run_ledger_check(path=path, programs=specs)
    assert again["problems"] == [] and not again["updated"]
    assert again["entries"] == first["entries"]
    # an entry of no registered program is stale
    led = json.loads(Path(path).read_text())
    led["entries"]["solve.retired"] = led["entries"][specs[0].name]
    Path(path).write_text(json.dumps(led))
    stale = manifest.run_ledger_check(path=path, programs=specs)
    assert [(p["kind"], p["program"]) for p in stale["problems"]] == [
        ("ledger-stale", "solve.retired")]


def test_gate_exits_zero_on_this_tree():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", "poisson_tpu_torch.contracts",
                          "--json"], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    report = json.loads(out.stdout)
    assert report["ok"] and report["schema"] == "poisson_tpu_torch.contracts/1"
    assert report["counts"]["ledger_programs"] == len(manifest.PROGRAMS)
    assert report["ledger"]["kernels"] == 5
    assert report["counts"]["rules"] == 14


def test_lint_only_runs_no_program(capsys):
    from poisson_tpu_torch.contracts.__main__ import main, run_contracts

    report = run_contracts(ledger=False)
    assert report["ok"] and report["ledger"] is None
    assert main(["--lint-only", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["ledger"] is None
