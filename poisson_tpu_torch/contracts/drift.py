"""Registry drift detection: the cross-file halves of the contract (the
counterpart of the JAX package's ``contracts/drift.py``).

1. **bench detail ↔ regress cohort key.** Every ``detail.*`` key a mode
   of the port's bench (``poisson_tpu_torch/bench.py``) emits is either
   experiment identity — lifted by ``benchmarks/regress.py``'s
   ``record_from_result`` into the cohort key, so records are compared
   like for like — or attribution payload, listed in
   ``contracts.manifest.ATTRIBUTION_ONLY_DETAIL`` with a reason. A key in
   neither set is a new dispatch dimension whose records would judge the
   wrong baseline. The port builds its details three ways, and all three
   are read: ``"detail": {...}`` literals, ``detail.update({...})``, and
   the dict literals the ``_*_detail`` helpers return.

2. **policy fields ↔ chaos coverage.** Every ``ServicePolicy``/
   ``FleetPolicy`` field of the port's ``serve/types.py`` is exercised by
   a scenario of its ``testing/chaos.py`` (a keyword argument or an
   attribute) or carries a written exemption in
   ``POLICY_COVERAGE_EXEMPT``.

Both are stdlib ``ast`` over source text, reported as
:class:`~poisson_tpu_torch.contracts.lint.Finding` rows.
"""

from __future__ import annotations

import ast
import os
from dataclasses import asdict
from typing import Optional

from poisson_tpu_torch.contracts.lint import Finding, repo_root
from poisson_tpu_torch.contracts.manifest import (
    ATTRIBUTION_ONLY_DETAIL,
    POLICY_COVERAGE_EXEMPT,
)

BENCH = "poisson_tpu_torch/bench.py"
REGRESS = "benchmarks/regress.py"
TYPES = "poisson_tpu_torch/serve/types.py"
CHAOS = "poisson_tpu_torch/testing/chaos.py"

# Detail keys regress.py reads outside the det.get() pattern.
_ENVELOPE_KEYS = {"platform_fallback"}


def _literal_keys(node: ast.Dict, keys: dict) -> None:
    for k in node.keys:
        if isinstance(k, ast.Constant) and isinstance(k.value, str):
            keys.setdefault(k.value, k.lineno)


def bench_detail_keys(bench_source: str) -> dict:
    """Every literal key the bench's records put in ``detail``, mapped to
    the first line it appears on."""
    keys: dict = {}
    tree = ast.parse(bench_source)
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (isinstance(k, ast.Constant) and k.value == "detail"
                        and isinstance(v, ast.Dict)):
                    _literal_keys(v, keys)
        elif (isinstance(node, ast.Call)
              and isinstance(node.func, ast.Attribute)
              and node.func.attr == "update"
              and isinstance(node.func.value, ast.Name)
              and node.func.value.id == "detail"):
            for arg in node.args:
                if isinstance(arg, ast.Dict):
                    _literal_keys(arg, keys)
        elif (isinstance(node, ast.FunctionDef)
              and node.name.endswith("_detail")):
            for stmt in ast.walk(node):
                if (isinstance(stmt, ast.Return)
                        and isinstance(stmt.value, ast.Dict)):
                    _literal_keys(stmt.value, keys)
    return keys


def cohort_detail_fields(regress_source: str) -> set:
    """The detail fields ``record_from_result`` lifts into the sentinel
    record, read off its ``det.get("...")`` calls."""
    fields: set = set(_ENVELOPE_KEYS)
    for node in ast.walk(ast.parse(regress_source)):
        if (isinstance(node, ast.FunctionDef)
                and node.name == "record_from_result"):
            for call in ast.walk(node):
                if (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr == "get"
                        and isinstance(call.func.value, ast.Name)
                        and call.func.value.id == "det"
                        and call.args
                        and isinstance(call.args[0], ast.Constant)):
                    fields.add(call.args[0].value)
    return fields


def check_bench_cohort(bench_source: str, regress_source: str,
                       attribution_only: Optional[dict] = None) -> list:
    """Findings for detail keys that neither join the cohort key nor
    carry an attribution-only exemption, and for stale exemptions."""
    allow = (ATTRIBUTION_ONLY_DETAIL if attribution_only is None
             else attribution_only)
    cohort = cohort_detail_fields(regress_source)
    detail_keys = bench_detail_keys(bench_source)
    findings = []
    for key, line in sorted(detail_keys.items()):
        if key in cohort or key in allow:
            continue
        findings.append(Finding(
            rule="bench-detail-cohort", file=BENCH, line=line, col=0,
            message=(
                f"detail key '{key}' is neither lifted into the "
                f"regress.py cohort key (record_from_result) nor listed "
                f"attribution-only in contracts.manifest."
                f"ATTRIBUTION_ONLY_DETAIL — a new dispatch dimension must "
                f"split cohorts, payload must be declared payload")))
    for key in sorted(set(allow) - set(detail_keys)):
        findings.append(Finding(
            rule="attribution-stale", file=BENCH, line=1, col=0,
            message=(f"ATTRIBUTION_ONLY_DETAIL entry '{key}' matches no "
                     f"detail key any bench mode emits — remove the stale "
                     f"exemption from contracts.manifest")))
    return findings


def policy_fields(types_source: str) -> dict:
    """{'ServicePolicy.capacity': lineno, ...} for the dataclass fields of
    ServicePolicy and FleetPolicy."""
    out: dict = {}
    for node in ast.parse(types_source).body:
        if not (isinstance(node, ast.ClassDef)
                and node.name in ("ServicePolicy", "FleetPolicy")):
            continue
        for stmt in node.body:
            if (isinstance(stmt, ast.AnnAssign)
                    and isinstance(stmt.target, ast.Name)):
                out[f"{node.name}.{stmt.target.id}"] = stmt.lineno
    return out


def chaos_exercised_names(chaos_source: str) -> set:
    """Every keyword-argument and attribute name in the chaos module: the
    (deliberately generous) evidence that a field is exercised."""
    names: set = set()
    for node in ast.walk(ast.parse(chaos_source)):
        if isinstance(node, ast.Call):
            names.update(kw.arg for kw in node.keywords if kw.arg)
        elif isinstance(node, ast.Attribute):
            names.add(node.attr)
    return names


def check_policy_coverage(types_source: str, chaos_source: str,
                          exempt: Optional[dict] = None) -> list:
    """Findings for policy fields no scenario exercises and no exemption
    explains, and for stale exemptions."""
    exempt = POLICY_COVERAGE_EXEMPT if exempt is None else exempt
    exercised = chaos_exercised_names(chaos_source)
    fields = policy_fields(types_source)
    findings = []
    for qualified, line in sorted(fields.items()):
        if qualified.split(".", 1)[1] in exercised or qualified in exempt:
            continue
        findings.append(Finding(
            rule="policy-chaos-coverage", file=TYPES, line=line, col=0,
            message=(
                f"{qualified} is never exercised by any chaos scenario "
                f"(no kwarg/attribute use in testing/chaos.py) and has no "
                f"exemption in contracts.manifest.POLICY_COVERAGE_EXEMPT — "
                f"a failure-handling knob needs a deterministic drill or "
                f"a written reason")))
    for qualified in sorted(set(exempt) - set(fields)):
        findings.append(Finding(
            rule="exemption-stale", file=TYPES, line=1, col=0,
            message=(f"POLICY_COVERAGE_EXEMPT entry '{qualified}' matches "
                     f"no ServicePolicy/FleetPolicy field — remove the "
                     f"stale exemption from contracts.manifest")))
    return findings


def run_drift(root: Optional[str] = None) -> dict:
    """Both cross-file checks over the tree; a report shaped as
    :func:`poisson_tpu_torch.contracts.lint.run_lint`'s."""
    root = os.path.abspath(root or repo_root())
    findings = []

    def read(rel):
        """Source text, or None with a finding: a check whose inputs
        vanished fails loudly, never passes."""
        try:
            with open(os.path.join(root, rel)) as f:
                return f.read()
        except OSError as e:
            findings.append(Finding(
                rule="drift-source-missing", file=rel, line=1, col=0,
                message=(f"cross-file drift check cannot read its source "
                         f"({e}) — wrong --root, or a checked file moved "
                         f"without updating contracts.drift")))
            return None

    bench_src, regress_src = read(BENCH), read(REGRESS)
    if bench_src is not None and regress_src is not None:
        findings.extend(check_bench_cohort(bench_src, regress_src))
    types_src, chaos_src = read(TYPES), read(CHAOS)
    if types_src is not None and chaos_src is not None:
        findings.extend(check_policy_coverage(types_src, chaos_src))
    return {
        "schema": "poisson_tpu_torch.contracts.drift/1",
        "root": root,
        "checks": ["bench-detail-cohort", "attribution-stale",
                   "policy-chaos-coverage", "exemption-stale"],
        "findings": [asdict(f) for f in findings],
        "counts": {"findings": len(findings)},
    }
