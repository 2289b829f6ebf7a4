"""Chaos parity with the JAX package, second part (on the CPU; -m serve):
the journal, geometry, placement, krylov, forecast and router groups (see
``test_torch_serve_chaos_parity.py``)."""

import pytest

from test_torch_serve_chaos_parity import check_parity, scenarios

pytestmark = pytest.mark.serve

GROUPS = ("journal", "geometry", "placement", "krylov", "forecast",
          "router")


@pytest.mark.parametrize("name", scenarios(GROUPS))
def test_scenario_matches_jax(name):
    check_parity(name)
