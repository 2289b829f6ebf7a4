"""``python -m poisson_tpu_torch.contracts`` — the port's program-contract
gate (the JAX package's ``poisson_tpu_torch.contracts`` command, same flags and
report shape).

Runs, in order:

1. the source lint (``contracts.lint`` — stdlib only),
2. registry drift detection (``contracts.drift`` — stdlib only),
3. the program ledger check (``contracts.manifest`` — runs every
   registered flag-off program on the CPU under an op recorder, hashes
   every CUDA source with its build command and launch configuration, and
   compares fingerprints and structural markers with the committed
   ``ledger.json``).

Exit 0 iff no unsuppressed finding and no ledger problem. Flags:

``--json``            machine-readable combined report on stdout
``--update-ledger``   rewrite ``ledger.json`` from the current tree
                      (after an intentional, reviewed change);
                      structural violations still fail — a host read in
                      a flag-off step is never ledgerable
``--lint-only``       skip the ledger (no program runs — the fast
                      pre-commit path)
``--root DIR``        lint/drift a different checkout root

The run also stamps ``contracts.findings`` / ``contracts.suppressed`` /
``contracts.rules`` gauges into the metrics registry, so an embedding
caller (``obs.selfcheck``) surfaces drift through the Prometheus
exposition.
"""

from __future__ import annotations

import argparse
import json
import sys


def run_contracts(root=None, *, ledger: bool = True,
                  update_ledger: bool = False) -> dict:
    """The combined check as a library call; returns the report dict
    (``report["ok"]`` is the exit-0 condition). Stamps the
    ``contracts.*`` gauges as a side effect."""
    from poisson_tpu_torch.contracts.drift import run_drift
    from poisson_tpu_torch.contracts.lint import run_lint

    lint = run_lint(root)
    drift = run_drift(root)
    findings = lint["findings"] + drift["findings"]
    active = [f for f in findings if not f.get("suppressed")]
    suppressed = [f for f in findings if f.get("suppressed")]
    report = {
        "schema": "poisson_tpu_torch.contracts/1",
        "rules": lint["rules"] + drift["checks"],
        "files": lint["files"],
        "findings": findings,
        "ledger": None,
        "counts": {
            "rules": len(lint["rules"]) + len(drift["checks"]),
            "findings": len(active),
            "suppressed": len(suppressed),
            "ledger_problems": 0,
            "ledger_programs": 0,
        },
    }
    if ledger:
        from poisson_tpu_torch.contracts.manifest import run_ledger_check

        led = run_ledger_check(update=update_ledger)
        report["ledger"] = {k: led[k] for k in
                            ("environment", "programs", "kernels",
                             "problems", "updated", "ledger")}
        report["counts"]["ledger_problems"] = len(led["problems"])
        report["counts"]["ledger_programs"] = led["programs"]
    report["ok"] = (report["counts"]["findings"] == 0
                    and report["counts"]["ledger_problems"] == 0)
    try:  # gauge stamping is telemetry, never the gate itself
        from poisson_tpu_torch.obs import metrics

        metrics.gauge("contracts.findings",
                      report["counts"]["findings"]
                      + report["counts"]["ledger_problems"])
        metrics.gauge("contracts.suppressed",
                      report["counts"]["suppressed"])
        metrics.gauge("contracts.rules", report["counts"]["rules"])
    except Exception:
        pass
    return report


def _render_human(report: dict) -> None:
    for f in report["findings"]:
        mark = (f" (suppressed: {f.get('reason')})"
                if f.get("suppressed") else "")
        print(f"{f['file']}:{f['line']}:{f['col']}: [{f['rule']}] "
              f"{f['message']}{mark}")
    led = report.get("ledger")
    if led:
        for p in led["problems"]:
            print(f"ledger:{p['program']}: [{p['kind']}] {p['message']}")
        state = ("updated" if led["updated"] else
                 f"{led['programs']} programs checked")
        print(f"ledger: {state} ({led['ledger']})")
    c = report["counts"]
    verdict = "OK" if report["ok"] else "FAILED"
    print(f"contracts {verdict}: {c['rules']} rules over "
          f"{report['files']} files — {c['findings']} finding(s), "
          f"{c['suppressed']} suppressed, "
          f"{c['ledger_problems']} ledger problem(s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m poisson_tpu_torch.contracts",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--json", action="store_true",
                    help="machine-readable combined report on stdout")
    ap.add_argument("--update-ledger", action="store_true",
                    help="rewrite ledger.json from the current tree "
                         "(reviewed intentional changes only)")
    ap.add_argument("--lint-only", action="store_true",
                    help="lint + drift only; skip the program ledger")
    ap.add_argument("--root", default=None,
                    help="checkout root to lint (default: this one)")
    args = ap.parse_args(argv)
    report = run_contracts(args.root, ledger=not args.lint_only,
                           update_ledger=args.update_ledger)
    if args.json:
        print(json.dumps(report, indent=1, sort_keys=True))
    else:
        _render_human(report)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
