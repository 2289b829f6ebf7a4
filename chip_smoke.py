#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases, each of which fails the run (non-zero exit, no result line):

1. the card's name and power limit (``nvidia-smi``);
2. build of the CUDA kernels from ``poisson_tpu_torch/ops/csrc`` for
   ``sm_90a``, with its time and ``ptxas`` report;
3. each kernel against its plain PyTorch version on the card, on the same
   seeded canvases with nonzero β and α, at 800×1200 (the flagship) and at
   2400×3200 (the largest published grid): max abs error of pn, Ap, w, r
   (tolerance 1e-6; the kernels repeat the plain arithmetic in the same
   order, so 0 is expected) and relative error of every partial sum
   (tolerance 1e-5; only the summation order differs);
4. the main path, ``fused_cg_solve``, with every launch count set to 0 just
   before it: a warm-up and three timed solves at 800×1200 and one at
   2400×3200, before any profiler session. 800×1200 must give 989
   iterations with diff < 1e-6 and an iterate within 1e-5 of the plain fp64
   ``pcg_solve`` on the card (the fp32 tolerance of
   tests/test_precision.py); 2400×3200 must give 2449 ± 1 (the fp32
   allowance of tests/test_pcg_golden.py); the counts read just after must
   show both kernels launched at least once per iteration;
5. the kernels' times (profiler device time per launch; the plain
   versions by CUDA events) and a profile of one flagship solve;
6. a ``kernels`` JSON line, then the ``ok`` JSON line last.

Without a CUDA device, or run outside a checkout (no ``poisson_tpu_torch``
beside it), it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

FIELD_TOL = 1e-6     # max abs error of pn, Ap, w, r against the plain version
SUM_TOL = 1e-5       # relative error of each partial sum
ITERATE_TOL = 1e-5   # fused fp32 iterate vs plain fp64 solve
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOPS_PER_S = 67e12    # H100 SXM fp32 outside the tensor cores
# Flops per live point: A forms z + βp at 5 points (10), the stencil (13) and
# its dot (2); B two axpys (4), p²sc² (2), r² (1) and two sums (2).
FLOPS_PER_POINT = {"direction_stencil": 25, "fused_update": 9}
REPLACES = {
    "direction_stencil": "poisson_tpu/ops/pallas_cg.py:733",
    "fused_update": "poisson_tpu/ops/pallas_cg.py:805",
}
SOURCE = "poisson_tpu_torch/ops/csrc/fused_cg.cu"
GRIDS = [(800, 1200), (2400, 3200)]
REPEATS = 3          # timed flagship solves after the warm-up; best reported


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)


def events_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events around the burst."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_kernels(fn):
    """Run ``fn`` under torch.profiler; returns ({kernel name: (count,
    total device µs)}, wall seconds), or (None, wall) when the profiler
    recorded no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        n, tot = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (n + 1, tot + us)
    return (kernels or None), wall


def kernel_device_ms(fn, reps: int, symbol: str):
    """Device ms per launch of the kernel whose name contains ``symbol``,
    from the profiler over ``reps`` calls; None if it saw no such kernel."""
    def burst():
        for _ in range(reps):
            fn()

    kernels, _ = profile_kernels(burst)
    if not kernels:
        return None
    hits = [(n, us) for name, (n, us) in kernels.items() if symbol in name]
    if not hits:
        return None
    n = sum(h[0] for h in hits)
    return sum(h[1] for h in hits) / n / 1e3


def check_kernels(M: int, N: int, fc, results: dict):
    """Phase 3 at one grid: kernels vs plain versions. Returns the function
    that times them, which runs after the main path so that no profiler
    session precedes the timed solves."""
    from poisson_tpu_torch.config import Problem

    problem = Problem(M=M, N=N)
    cv, cs, cw, g, rhs, sc2, _ = fc.build_canvases(problem, "cuda")
    rng = np.random.default_rng(M)

    def interior_random():
        x = np.zeros((cv.rows, cv.cols), np.float32)
        x[fc.HALO : fc.HALO + M - 1, 1:N] = rng.standard_normal((M - 1, N - 1))
        return torch.tensor(x, device="cuda")

    z, p, w0, r0 = (interior_random() for _ in range(4))
    beta = torch.tensor(0.37, dtype=torch.float32, device="cuda")
    alpha = torch.tensor(0.21, dtype=torch.float32, device="cuda")
    band_points = (cv.rows - 2 * fc.HALO) * cv.cols
    tag = f"{M}x{N}"

    # Kernel A against its plain version, on the same inputs.
    pn_k, ap_k, part_k = fc.direction_and_stencil(cv, beta, z, p, cs, cw, g)
    pn_p, ap_p = torch.zeros_like(z), torch.zeros_like(z)
    part_p = fc.direction_and_stencil_plain(cv, beta, z, p, cs, cw, g,
                                            pn_p, ap_p)
    torch.cuda.synchronize()
    a_err = max(float((pn_k - pn_p).abs().max()),
                float((ap_k - ap_p).abs().max()))
    a_rel = abs(float(part_k.sum()) - float(part_p.sum())) / abs(
        float(part_p.sum()))

    # Kernel B against its plain version (w, r are updated in place).
    w_k, r_k, w_p, r_p = w0.clone(), r0.clone(), w0.clone(), r0.clone()
    _, _, d_k, z_k = fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k)
    d_p, z_p = fc.fused_update_plain(cv, alpha, pn_k, ap_k, sc2, w_p, r_p)
    torch.cuda.synchronize()
    b_err = max(float((w_k - w_p).abs().max()),
                float((r_k - r_p).abs().max()))
    b_rel = max(abs(float(k.sum()) - float(q.sum())) / abs(float(q.sum()))
                for k, q in ((d_k, d_p), (z_k, z_p)))
    for name, err, rel in (("direction_stencil", a_err, a_rel),
                           ("fused_update", b_err, b_rel)):
        print(f"kernel {name} {tag}: max_abs_err={err!r} (tol {FIELD_TOL}) "
              f"partial_sum_rel_err={rel!r} (tol {SUM_TOL})", flush=True)
        check(err <= FIELD_TOL, f"{name} {tag}: max abs error {err}")
        check(rel <= SUM_TOL, f"{name} {tag}: partial-sum error {rel}")

    # Times: device time per launch from the profiler (the wrapper's host
    # cost cannot hide it), CUDA events over a burst as the fallback; the
    # plain versions by events. Inputs stay resident between launches, as
    # in the solve loop.
    errors = {"direction_stencil": a_err, "fused_update": b_err}
    for name, err in errors.items():
        rec = results.setdefault(name, {"max_abs_err": 0.0})
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
    reps = 200
    run_a = lambda: fc.direction_and_stencil(cv, beta, z, p, cs, cw, g,
                                             out=(pn_k, ap_k))
    run_b = lambda: fc.fused_update(cv, alpha, pn_k, ap_k, sc2, w_k, r_k)
    plain_a = lambda: fc.direction_and_stencil_plain(cv, beta, z, p, cs, cw,
                                                     g, pn_p, ap_p)
    plain_b = lambda: fc.fused_update_plain(cv, alpha, pn_k, ap_k, sc2, w_p,
                                            r_p)

    def time_them() -> None:
        for name, run, plain in (("direction_stencil", run_a, plain_a),
                                 ("fused_update", run_b, plain_b)):
            ev_ms = events_ms(run, reps)
            dev_ms = kernel_device_ms(run, reps, name + "_kernel")
            plain_ms = events_ms(plain, 20)
            nbytes = 7 * band_points * 4
            bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            bound_ops_ms = (FLOPS_PER_POINT[name] * band_points
                            / FP32_FLOPS_PER_S * 1e3)
            results[name][tag] = rec = {
                "ms": dev_ms if dev_ms is not None else ev_ms,
                "timing": "profiler" if dev_ms is not None else "cuda_events",
                "events_ms": ev_ms,
                "plain_ms": plain_ms,
                "bytes": nbytes,
                "bound_ms": max(bound_bytes_ms, bound_ops_ms),
                "bound_by": ("bytes" if bound_bytes_ms >= bound_ops_ms
                             else "operations"),
            }
            print(f"time {name} {tag}: {json.dumps(rec)}", flush=True)
        torch.cuda.synchronize()

    return time_them


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from poisson_tpu_torch.analysis import l2_error_host
        from poisson_tpu_torch.config import FLAGSHIP, Problem
        from poisson_tpu_torch.ops import _build, fused_cg as fc
        from poisson_tpu_torch.solvers.pcg import pcg_solve
    except ImportError as e:
        fail(f"cannot import the port (run from a checkout): {e}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}", flush=True)

    t0 = time.perf_counter()
    kernels = _build.load_kernels()
    wall = time.perf_counter() - t0
    print(f"build: {kernels.path.name} for sm_90a from {SOURCE}: nvcc "
          f"{kernels.build_seconds:.2f} s, build+load {wall:.2f} s", flush=True)
    for line in kernels.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}", flush=True)

    results: dict = {}
    timers = [check_kernels(M, N, fc, results) for M, N in GRIDS]

    # The main path. Counts are zeroed just before it and read just after.
    big = Problem(M=2400, N=3200)
    fc.build_canvases(big, "cuda")          # set-up, outside the timed solve
    fc.reset_launch_counts()
    fused = fc.fused_cg_solve(FLAGSHIP)     # warm-up solve
    flag_times = []
    for _ in range(REPEATS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused = fc.fused_cg_solve(FLAGSHIP)
        torch.cuda.synchronize()
        flag_times.append(time.perf_counter() - t0)
    flag_s = min(flag_times)
    t0 = time.perf_counter()
    big_r = fc.fused_cg_solve(big)
    torch.cuda.synchronize()
    big_s = time.perf_counter() - t0
    counts = fc.launch_counts()

    iters = int(fused.iterations)
    diff = float(fused.diff)
    check(iters == 989, f"800x1200: {iters} iterations, expected 989")
    check(diff < 1e-6, f"800x1200: diff {diff} not below 1e-6")
    w64 = pcg_solve(FLAGSHIP, dtype=torch.float64, device="cuda")
    check(int(w64.iterations) == 989,
          f"plain fp64 solve: {int(w64.iterations)} iterations")
    gap = float((fused.w.double() - w64.w).abs().max())
    check(gap <= ITERATE_TOL, f"800x1200: iterate {gap} from fp64 solve")
    l2 = l2_error_host(FLAGSHIP, fused.w)
    check(np.isfinite(l2) and l2 < 1e-3, f"800x1200: L2 error {l2}")
    cv = fc.canvas_spec(FLAGSHIP)
    bytes_per_iter = 14 * (cv.rows - 2 * fc.HALO) * cv.cols * 4
    print("solve 800x1200: " + json.dumps({
        "iterations": iters, "diff": diff, "l2_error": l2,
        "max_diff_vs_fp64": gap, "seconds": flag_s,
        "seconds_each": flag_times,
        "us_per_iter": flag_s / iters * 1e6,
        "mlups": FLAGSHIP.interior_points * iters / flag_s / 1e6,
        "achieved_gbps": bytes_per_iter * iters / flag_s / 1e9,
    }), flush=True)

    big_iters = int(big_r.iterations)
    check(abs(big_iters - 2449) <= 1,
          f"2400x3200: {big_iters} iterations, expected 2449 +- 1")
    check(float(big_r.diff) < 1e-6, f"2400x3200: diff {float(big_r.diff)}")
    big_l2 = l2_error_host(big, big_r.w)
    check(np.isfinite(big_l2), "2400x3200: non-finite iterate")
    bcv = fc.canvas_spec(big)
    big_bytes = 14 * (bcv.rows - 2 * fc.HALO) * bcv.cols * 4
    print("solve 2400x3200: " + json.dumps({
        "iterations": big_iters, "diff": float(big_r.diff),
        "l2_error": big_l2, "seconds": big_s,
        "us_per_iter": big_s / big_iters * 1e6,
        "mlups": big.interior_points * big_iters / big_s / 1e6,
        "achieved_gbps": big_bytes * big_iters / big_s / 1e9,
    }), flush=True)

    total_iters = (1 + REPEATS) * iters + big_iters
    for name, n in counts.items():
        check(n >= total_iters, f"{name}: {n} launches on the main path, "
                                f"fewer than the {total_iters} iterations")
    print(f"launches on the main path: {json.dumps(counts)} for "
          f"{total_iters} iterations", flush=True)

    for time_them in timers:
        time_them()

    # Where one flagship solve's time goes: device time by kernel against
    # the host's wall clock (profiled, so the wall includes its overhead).
    prof, prof_wall = profile_kernels(lambda: fc.fused_cg_solve(FLAGSHIP))
    if prof is None:
        print("profile 800x1200: the profiler recorded no device activity",
              flush=True)
    else:
        busy_us = sum(us for _, us in prof.values())
        top = sorted(prof.items(), key=lambda kv: -kv[1][1])[:8]
        print("profile 800x1200: " + json.dumps({
            "wall_s": prof_wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / prof_wall,
            "launches_per_iter": sum(n for n, _ in prof.values()) / iters,
            "top_kernels": [{"name": k[:80], "count": n, "us": us}
                            for k, (n, us) in top],
        }), flush=True)

    wrapper = {"direction_stencil": "direction_and_stencil",
               "fused_update": "fused_update"}
    line = []
    for name in ("direction_stencil", "fused_update"):
        rec = results[name]
        flag, large = rec["800x1200"], rec["2400x3200"]
        line.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name],
            "launches": counts[wrapper[name]],
            "max_abs_err": rec["max_abs_err"],
            "ms": flag["ms"], "plain_ms": flag["plain_ms"],
            "bound_ms": flag["bound_ms"], "bound_by": flag["bound_by"],
            "library_ms": None,
            "timing": flag["timing"],
            "ms_2400x3200": large["ms"],
            "plain_ms_2400x3200": large["plain_ms"],
            "bound_ms_2400x3200": large["bound_ms"],
        })
    check(not any(m.split(".")[0] in ("jax", "jaxlib", "poisson_tpu")
                  for m in sys.modules), "the JAX package was imported")
    print(f"nvidia-smi: {card}", flush=True)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
