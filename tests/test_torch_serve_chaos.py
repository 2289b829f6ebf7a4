"""The port's chaos campaign (counterpart of ``tests/test_chaos.py``, on
the CPU; -m serve): every named scenario runs green, deterministically,
with the no-lost-request invariant read from the emitted serve.* metrics
snapshot; the campaign CLI.
"""

import json

import pytest

from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.testing import chaos

pytestmark = pytest.mark.serve

# The acceptance matrix: the campaign must exercise each of these
# survival properties in at least one scenario.
REQUIRED = ("breaker-trip", "deadline-mid-chunk", "poison-requeue",
            "overload-shed")


@pytest.fixture(autouse=True)
def _fresh_registry():
    yield
    metrics.reset()


def test_required_scenarios_registered():
    names = chaos.scenario_names()
    for required in REQUIRED:
        assert required in names


@pytest.mark.parametrize("name", chaos.scenario_names())
def test_scenario_green_with_invariant(name):
    report = chaos.run_scenario(name, seed=0, device="cpu")
    assert report["ok"], report["checks"]
    # The invariant is read from the scenario's own metrics snapshot —
    # the emitted counters, not the service's in-memory ledger.
    snap = report["metrics_snapshot"]["counters"]
    admitted = snap.get("serve.admitted", 0)
    terminated = (snap.get("serve.completed", 0)
                  + snap.get("serve.errors", 0)
                  + snap.get("serve.shed", 0))
    assert admitted - terminated == 0
    assert report["invariant"]["lost"] == 0


def test_campaign_is_deterministic_under_a_seed():
    def fingerprint(campaign):
        return json.dumps(
            [{k: v for k, v in s.items() if k != "detail"}
             for s in campaign["scenarios"]],
            sort_keys=True, default=str,
        )

    a = chaos.run_campaign(["poison-requeue", "breaker-trip"], seed=3, device="cpu")
    b = chaos.run_campaign(["poison-requeue", "breaker-trip"], seed=3, device="cpu")
    assert a["ok"] and fingerprint(a) == fingerprint(b)


def test_campaign_writes_per_scenario_artifacts(tmp_path):
    out = tmp_path / "chaos"
    campaign = chaos.run_campaign(["overload-shed"], seed=0,
                                  out_dir=str(out), device="cpu")
    assert campaign["ok"]
    snap = json.loads((out / "metrics-overload-shed.json").read_text())
    assert snap["counters"]["serve.admitted"] == 14
    # Prometheus text of the same snapshot, parseable with the serve
    # counters intact.
    from poisson_tpu_torch.obs import export

    parsed = export.parse_text(
        (out / "metrics-overload-shed.prom").read_text())
    assert parsed["poisson_tpu_serve_admitted"]["value"] == 14
    report = json.loads((out / "campaign.json").read_text())
    assert report["ok"] and len(report["scenarios"]) == 1


def test_unknown_scenario_raises():
    with pytest.raises(KeyError, match="unknown chaos scenario"):
        chaos.run_scenario("no-such-scenario", device="cpu")


def test_virtual_clock():
    vc = chaos.VirtualClock(start=5.0)
    assert vc() == 5.0
    vc.sleep(2.0)
    vc.advance(1.0)
    assert vc.now() == 8.0
    vc.sleep(-1.0)                     # sleeping never rewinds time
    assert vc.now() == 8.0


# -- CLI ----------------------------------------------------------------


def test_chaos_cli_list(capsys):
    from poisson_tpu_torch.cli import main

    assert main(["chaos", "--device", "cpu", "--list"]) == 0
    out = capsys.readouterr().out.split()
    for required in REQUIRED:
        assert required in out


def test_chaos_cli_named_scenario(capsys):
    from poisson_tpu_torch.cli import main

    assert main(["chaos", "--device", "cpu", "overload-shed", "--seed", "0"]) == 0
    out = capsys.readouterr().out
    assert "ok  overload-shed" in out
    assert "chaos campaign ok" in out


def test_chaos_cli_json_verdict(capsys):
    from poisson_tpu_torch.cli import main

    assert main(["chaos", "--device", "cpu", "poison-requeue", "--json"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["ok"] and rec["scenarios"][0]["invariant"]["lost"] == 0


def test_chaos_cli_rejects_bad_usage():
    from poisson_tpu_torch.cli import main

    with pytest.raises(SystemExit):
        main(["chaos"])                         # nothing to run
    with pytest.raises(SystemExit):
        main(["chaos", "--device", "cpu", "--all", "overload-shed"])   # both forms
    with pytest.raises(SystemExit):
        main(["chaos", "--device", "cpu", "no-such-scenario"])
