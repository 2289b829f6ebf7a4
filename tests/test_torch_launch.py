"""The one launch path of the kernel wrappers (``ops.launch``), held by a
scan of ``poisson_tpu_torch/ops/``: every C entry that launches a kernel is
called through ``launch``, under a key the launch counters know, and no
other module keeps a launch count of its own or picks a launch's stream;
and the launch gates of ``chip_smoke.py`` cover their whole phase. This
file imports no JAX."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest
import torch

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.ops import _build, fused_cg, launch

OPS = Path(launch.__file__).resolve().parent
ROOT = OPS.parents[1]
MODULES = sorted(OPS.glob("*.py"))
# C entries that query a library or a card and launch nothing.
QUERIES = ("_layout", "_occupancy", "_device", "_threads", "_block_size",
           "_error_string")


def trees():
    return [(path.name, ast.parse(path.read_text())) for path in MODULES]


def strings(node) -> set:
    """The string constants in ``node`` (a key may be chosen by a
    conditional expression)."""
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def launches() -> list:
    """(module, entry, keys) of every call of ``launch`` under ``ops``."""
    out = []
    for name, tree in trees():
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "launch"):
                entry, key = node.args[1], node.args[2]
                assert isinstance(entry, ast.Constant), name
                out.append((name, entry.value, strings(key)))
    return out


def test_every_kernel_entry_is_launched_through_the_one_helper():
    entries = {symbol for table in _build.ENTRIES.values()
               for symbol in table if not symbol.endswith(QUERIES)}
    called = {entry for _, entry, _ in launches()}
    assert called == entries
    keys = set(launch.launch_counts())
    for name, entry, used in launches():
        assert used and used <= keys, (name, entry, used)


def test_the_recurrence_kernels_launch_through_the_helper():
    """The scalar recurrence's two kernels have a key each, of one form,
    and ``ops/recurrence.py`` launches each C entry under its own key."""
    assert launch.FORMS["recurrence_step"] == ("",)
    assert launch.FORMS["recurrence_close"] == ("",)
    assert {"fused_cg_recurrence_step", "fused_cg_recurrence_close"} <= set(
        _build.ENTRIES["fused_cg"])
    ours = [(entry, used) for name, entry, used in launches()
            if name == "recurrence.py"]
    assert sorted(ours) == [("fused_cg_recurrence_close",
                             {"recurrence_close"}),
                            ("fused_cg_recurrence_step",
                             {"recurrence_step"})]


@pytest.mark.card
def test_card_a_replayed_block_re_adds_one_recurrence_launch_a_step():
    """On a card a replayed block of the fused body adds one launch of
    each recurrence kernel a step, as the eager steps count them."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card visible: blocks are captured on a card "
                    "only")
    card = torch.device("cuda", 0)
    p = Problem(M=400, N=600)
    fused_cg.fused_cg_solve(p, device=card)          # captures its block
    launch.reset_launch_counts()
    names = ("graph_replays", "eager_steps")
    before = {n: metrics.get(f"pcg.drive.{n}") for n in names}
    r = fused_cg.fused_cg_solve(p, device=card)
    moved = {n: metrics.get(f"pcg.drive.{n}") - before[n] for n in names}
    steps = -(-int(r.iterations) // 32) * 32
    assert int(r.iterations) == 546
    assert moved == {"graph_replays": steps // 32, "eager_steps": 0}
    assert launch.launch_counts("recurrence_step", "recurrence_close") == {
        "recurrence_step": steps, "recurrence_close": steps}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.name)
def test_no_module_calls_a_launch_entry_outside_the_helper(path):
    """A call of ``<library>.lib.<entry>`` is a query, never a launch."""
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Attribute)
                and node.func.value.attr == "lib"):
            assert node.func.attr.endswith(QUERIES), (path.name,
                                                      node.func.attr)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.name)
def test_no_module_keeps_a_launch_count_or_picks_a_stream(path):
    """No attribute ``*launches`` is set, and the launch stream is
    ``ops.launch``'s alone: no other module names it."""
    source = path.read_text()
    for node in ast.walk(ast.parse(source)):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AugAssign)
                   else [])
        for t in targets:
            assert not (isinstance(t, ast.Attribute)
                        and t.attr.endswith("launches")), (path.name, t.attr)
    if path.name != "launch.py":
        assert "launch_stream" not in source, path.name


def test_the_view_reads_and_resets_the_registry():
    launch.reset_launch_counts()
    metrics.inc("ops.launches.fused_update_sharded", 3)
    metrics.inc("ops.launches.serial_sum")
    assert launch.launch_counts("fused_update", "serial_sum") == {
        "fused_update": 0, "fused_update_sharded": 3,
        "fused_update_blocked": 0, "serial_sum": 1}
    assert sum(launch.launch_counts().values()) == 4
    launch.reset_launch_counts()
    assert not any(launch.launch_counts().values())
    assert metrics.get("ops.launches.fused_update_sharded") == 0


def test_a_launch_before_a_phase_clears_the_registry_still_fails_its_gate():
    """A phase of the smoke may call ``metrics.reset()``, which clears the
    launch counters too; the installed gate carries what the clear drops,
    so a launch made before it still counts against the phase."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    clear = metrics.reset
    with chip_smoke.LaunchGate() as gate:
        gate.reset()
        metrics.inc("ops.launches.fused_update")       # a launch ...
        metrics.reset()                                # ... then the clear
        assert launch.launch_counts("fused_update")["fused_update"] == 0
        assert gate.counts("fused_update")["fused_update"] == 1
        with pytest.raises(SystemExit):
            gate.expect("a phase that launches nothing", {})
        metrics.inc("ops.launches.serial_sum")
        gate.expect("the phase", {"fused_update": 1, "serial_sum": 1})
        gate.reset()
        gate.expect("the next phase", {})
    assert metrics.reset is clear
