"""Readings that the limits in ``limits/<workload>.json`` are set from.

    python -m cellbench.calibrate --workload <name> --seeds 12 \
        --control-seeds 3 --seconds 3 --first-seed <n> [--control-cap 3]

In one process, on the card: short windows of the program on ``--seeds``
seeds (the lower readings), then the control on ``--control-seeds`` seeds
(the upper readings). The control is the plain reference put in the
program's place and computed one precision below the configuration's:
bfloat16 for its float32 (no matrix product runs, so TF32 does not
apply), stopped at ``--control-cap`` times the published count if it has
not converged by then (with 1, its answer at the program's own count).
Prints one JSON line per run and a summary. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from cellbench import judge, run, spec
from cellbench.reference.pcg import Operator, solve

LOWER = {"float32": torch.bfloat16}
CAP_FACTOR = 3


def control(cell: spec.Cell, device: str, cap_factor: float = CAP_FACTOR):
    """``inputs -> send``: the reference in the program's place, one
    precision below, fed the run's inputs."""
    dtype = LOWER[cell.config["precision"]]
    cap = int(cap_factor * cell.config["published"]["iterations"])

    def bind(inputs):
        op = Operator(inputs.grid, device, dtype)
        return lambda inp: solve(op, inputs.reference_rhs(inp), cap)

    return bind


def reading(cell, seed, seconds, side, cap_factor=CAP_FACTOR) -> dict:
    send = control(cell, "cuda:0", cap_factor) if side == "control" \
        else None
    result, _, win = run.run_cell(cell, seed, seconds, False, send=send,
                                  log=sys.stderr)
    out = {"side": side, "seed": seed, "correct": result["correct"],
           "attempted": result["attempted"],
           "iterations": [min(win.iterations, default=0),
                          max(win.iterations, default=0)]}
    out.update({n: c["value"] for n, c in result["checks"].items()})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m cellbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--first-seed", type=int, default=2 ** 31 + 101)
    p.add_argument("--control-cap", type=float, default=CAP_FACTOR)
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    rows = []
    for side, count in (("program", args.seeds),
                        ("control", args.control_seeds)):
        for i in range(count):
            row = reading(cell, args.first_seed + i, args.seconds, side,
                          args.control_cap)
            rows.append(row)
            print(json.dumps(row), flush=True)
    summary = {}
    for n in judge.NUMBERS:
        summary[n] = {
            "lower": max((r[n] for r in rows if r["side"] == "program"),
                         default=None),
            "upper": min((r[n] for r in rows if r["side"] == "control"),
                         default=None),
            "limit": cell.limits[n]}
    print(json.dumps({"workload": cell.name, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
