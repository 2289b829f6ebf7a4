"""Chaos parity with the JAX package, third part (on the CPU; -m serve):
the session and tenancy groups (see ``test_torch_serve_chaos_parity.py``)."""

import pytest

from test_torch_serve_chaos_parity import check_parity, scenarios

pytestmark = pytest.mark.serve

GROUPS = ("session", "tenancy")


@pytest.mark.parametrize("name", scenarios(GROUPS))
def test_scenario_matches_jax(name):
    check_parity(name)
