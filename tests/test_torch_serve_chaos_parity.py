"""Chaos parity with the JAX package (on the CPU; -m serve): every
scenario of the campaign runs in both packages at seed 0; both are green
with nothing lost, and their ``serve_counters`` are equal once the JAX arm
names are mapped to the port's (``serve.router.JAX_ARM_NAMES``).

The campaign is split over three files by scenario group (each file is one
worker under ``--dist loadfile``): this one holds the service, solver,
refill, fleet and integrity groups and the comparison the other two
import.

No counter is left out of the comparison. The real-time ones stay equal
because every service scenario runs on a ``VirtualClock``
(``serve.backoff_seconds`` is seeded jitter on that clock), and the two
subprocess drills keep their children's counters in their ``detail``,
which is compared field by field instead.
"""

import jax
import pytest

from poisson_tpu.testing import chaos as jax_chaos
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.serve.router import JAX_ARM_NAMES
from poisson_tpu_torch.testing import chaos

pytestmark = pytest.mark.serve

# Counters excluded from the comparison, by name, with the reason: none.
EXCLUDED = {}

# The subprocess drills' detail fields read from the children's
# snapshots and the journal (the stderr tails differ by package name).
DRILL_DETAIL = ("phase_a_rc", "phase_b_rc", "admitted", "terminated",
                "terminated_before_kill", "recovered")

GROUPS = ("service", "solver-recovery", "refill", "fleet", "integrity")


def port_name(name: str) -> str:
    """A JAX counter name with its arm segment renamed to the port's."""
    for jax_arm, arm in JAX_ARM_NAMES.items():
        name = name.replace(f".{jax_arm}", f".{arm}")
        name = name.replace(f":{jax_arm}", f":{arm}")
    return name


def scenarios(groups):
    found = chaos.scenario_groups()
    return [name for g in groups for name in found[g]]


def check_parity(name: str) -> None:
    assert jax.config.jax_enable_x64   # the JAX suite's environment
    ref = jax_chaos.run_scenario(name, seed=0)
    metrics.reset()
    got = chaos.run_scenario(name, seed=0, device="cpu")
    assert ref["ok"], ref["checks"]
    assert got["ok"], got["checks"]
    assert ref["invariant"]["lost"] == got["invariant"]["lost"] == 0
    # the port's invariant from its own snapshot
    snap = got["metrics_snapshot"]["counters"]
    assert snap.get("serve.admitted", 0) == (
        snap.get("serve.completed", 0) + snap.get("serve.errors", 0)
        + snap.get("serve.shed", 0))
    want = {port_name(k): v for k, v in ref["serve_counters"].items()
            if k not in EXCLUDED}
    have = {k: v for k, v in got["serve_counters"].items()
            if k not in EXCLUDED}
    assert have == want
    assert got["invariant"] == ref["invariant"]
    if "phase_a_rc" in ref["detail"]:
        for key in DRILL_DETAIL:
            assert got["detail"][key] == ref["detail"][key], key


@pytest.mark.parametrize("name", scenarios(GROUPS))
def test_scenario_matches_jax(name):
    check_parity(name)


def test_every_scenario_is_compared_once():
    """The three parity files cover the campaign, each group once, and
    the port registers JAX's scenarios under JAX's names and groups."""
    from test_torch_serve_chaos_parity_journal import \
        GROUPS as JOURNAL_GROUPS
    from test_torch_serve_chaos_parity_session import \
        GROUPS as SESSION_GROUPS

    covered = GROUPS + JOURNAL_GROUPS + SESSION_GROUPS
    assert sorted(covered) == sorted(chaos.scenario_groups())
    assert chaos.scenario_groups() == jax_chaos.scenario_groups()
