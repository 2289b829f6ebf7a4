"""The port's telemetry selfcheck (``python -m
poisson_tpu_torch.obs.selfcheck``): its round trip exits 0 on the CPU,
keeps its artifacts with ``--dir``, and exits non-zero without a card
unless asked for the CPU."""

import json
import os

import pytest
import torch

from poisson_tpu_torch.obs import metrics, selfcheck


@pytest.fixture(autouse=True)
def _isolated():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    metrics.reset()
    yield
    from poisson_tpu_torch import obs

    obs.shutdown()
    metrics.reset()
    torch.set_num_threads(saved)


def test_selfcheck_round_trip_exits_zero(tmp_path, capsys):
    assert selfcheck.main(["--dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "obs selfcheck OK" in out
    for part in ("chaos overload-shed ok", "program contracts ok",
                 "ledger matched", "tenant fairness ok",
                 "geometry ok", "model agreement 2.68x"):
        assert part in out
    names = set(os.listdir(tmp_path))
    assert {"metrics.json", "metrics.prom", "profile"} <= names
    with open(tmp_path / "metrics.json") as f:
        assert json.load(f)["counters"]["selfcheck.runs"] == 1


def test_cost_ratios_are_the_pinned_ones():
    src = open(os.path.join(os.path.dirname(__file__),
                            "test_torch_costs.py")).read()
    for dtype, ratio in selfcheck.COST_RATIO.items():
        assert f'("{dtype}", {ratio})' in src
    assert selfcheck.COST_GRID == (400, 600)


def test_without_a_card_it_exits_nonzero(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert selfcheck.main([]) == 1
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="CUDA"):
        selfcheck.run_selfcheck("unused")
