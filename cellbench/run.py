"""One run of one cell: ``python -m cellbench --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.

Set-up makes the seeded inputs, resolves the program's entry and warms it
as the mix's loop does (the first run in a checkout builds the kernels
there). The window is the mix's loop (``loops/<loop>.py``) for
``--seconds``. ``--trace 1`` profiles a slice of the window and reports
the per-layer metrics instead of the end-to-end ones. After the window a
seeded sample of the answers is held against the plain reference. The
last line of standard output is the result; the last lines of standard
error are the compared numbers beside their limits.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import tempfile
import time
from pathlib import Path

from cellbench import capture, judge, program, spec, traffic
from cellbench.reference.fields import grid_from_config

FORBIDDEN = ("jax", "jaxlib", "flax", "poisson_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared whole (``poisson_tpu_torch`` is not ``poisson_tpu``)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def devices(cell: spec.Cell, kind: str) -> list[str]:
    """The devices a run uses, one per chip the cell asks for."""
    if kind == "cpu":
        return ["cpu"] * cell.chips
    return [f"cuda:{i}" for i in range(cell.chips)]


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             kind: str = "cuda", send=None, t0: float | None = None,
             log=sys.stderr) -> tuple[dict, list[str], traffic.Window]:
    """Run ``cell`` once on ``kind`` ("cuda", or "cpu" in the tests, which
    skip the look for a card). ``send(inputs)`` gives a ``send(input) ->
    (w, k)`` in place of the program's entry (the control and the fault
    drills). Returns the result, the lines that print each compared number
    beside its limit, and the window."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    marks = [("start of run", time.perf_counter())]
    grid = grid_from_config(cell.config)
    inputs = traffic.inputs(cell.traffic, grid, seed, cell.root)
    loop = traffic.loop(cell.traffic, cell.root)
    marks.append(("inputs", time.perf_counter()))
    used = devices(cell, kind)
    send = send(inputs) if send else inputs.bind(
        program.entry(cell.traffic), program.problem(cell.config), used)
    cards = list(range(cell.chips)) if kind == "cuda" else []
    marks.append(("entry", time.perf_counter()))
    loop.warm(send, inputs)
    capture.sync(cards)
    marks.append(("warm solve", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    print(f"setup: {setup_s:.3f} s (" + ", ".join(
        f"{name} at {t - t0:.3f}" for name, t in marks) + ")", file=log)

    win = loop.run(send, inputs, seconds,
                   traffic.Sample(cell.traffic["judged"], seed), cards, trace,
                   setup_s)
    peak = max((torch.cuda.max_memory_allocated(c) for c in cards),
               default=0)
    device = {"platform": "gpu" if cards else "cpu",
              "kind": torch.cuda.get_device_name(cards[0]) if cards
              else "cpu",
              "count": len(used), "memory_peak_bytes": int(peak)}

    metrics, extra = {}, {}
    if trace and win.profiled:
        start, end = capture.solve_bounds(win.events)
        cap = capture.Capture(
            events=win.events, start_us=start, end_us=end,
            cards=tuple(cards), iterations=sum(win.iterations[: win.profiled]),
            solve_iterations=win.iterations, config=cell.config,
            device_kind=device["kind"])
        chosen, folder, subject = cell.per_layer, "metrics", cap
        if cards:
            device["busy_s"] = capture.mean_busy_us(cap) / 1e6
            extra["breakdown"] = capture.breakdown(cap)
        device["window_s"] = cap.window_us / 1e6
        path = Path(tempfile.gettempdir()) / "cellbench"
        path.mkdir(parents=True, exist_ok=True)
        path = path / f"{cell.name}.seed{seed}.trace.json.gz"
        capture.write_trace(cap, path)
        print(f"trace: {path} ({win.profiled} solves, "
              f"{cap.iterations} iterations)", file=log)
    elif not trace:
        chosen, folder, subject = cell.end_to_end, "end_to_end", win
    else:                          # the first solve failed: nothing traced
        chosen, subject = (), None
    for m in chosen:
        value = spec.reader(m["name"], folder)(subject)
        if value is not None and math.isfinite(value):
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    gc.collect()
    if cards:
        torch.cuda.empty_cache()
    ref_device = f"cuda:{cards[0]}" if cards else "cpu"
    t_ref = time.perf_counter()
    reference = judge.reference_answers(grid, inputs,
                                        [inp for inp, _, _ in win.kept],
                                        ref_device)
    numbers = judge.compare(win.kept, reference) if win.kept else \
        {n: math.nan for n in judge.NUMBERS}
    check = judge.checks(numbers, cell.limits)
    lat = sorted(win.latencies)
    print(f"window: {len(win.latencies)} solves in "
          f"{win.t_end - win.t_start:.3f} s (latency p5 "
          f"{lat[len(lat) // 20]:.4f}, p50 {lat[len(lat) // 2]:.4f}, max "
          f"{lat[-1]:.4f} s); reference: {len(reference)} solves in "
          f"{time.perf_counter() - t_ref:.3f} s", file=log)
    if win.error:
        print(f"failed solve: {win.error}", file=log)
    result = {
        "correct": win.failed == 0 and judge.passed(check),
        "attempted": len(win.latencies),
        "failed": win.failed,
        "metrics": metrics,
        "device": device,
        **extra,
        "checks": check,
    }
    lines = [f"check {name}: {c['value']!r} limit {c['limit']!r}"
             for name, c in check.items()]
    return result, lines, win


def parse(argv):
    p = argparse.ArgumentParser(prog="python -m cellbench",
                                description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    cell = spec.load_cell(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); "
              f"{have} available", file=sys.stderr)
        return 2
    result, lines, _ = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), t0=t0)
    found = forbidden_modules()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result))
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    return 0
