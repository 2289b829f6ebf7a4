"""Performance attribution: what a solve should cost, and what it does
(counterpart of ``poisson_tpu/obs/costs.py``).

Three layers, as in the JAX package:

- **the analytic stencil model** (:func:`analytic_iteration_cost`,
  :func:`mg_vcycle_cost`, :func:`krylov_block_cost`,
  :func:`krylov_deflated_cost`): the JAX package's closed forms, with its
  constants and arithmetic, so both packages give the same numbers for the
  same grid and dtype;
- **the counted program** (:func:`measured_iteration_cost`): the JAX
  package reads XLA's ``cost_analysis`` off one compiled iteration body.
  The port has no compiler, so it counts its real program instead: a
  ``TorchDispatchMode`` sums every aten op's operand and result bytes (and
  its elementwise operations) over one iteration of the plain body
  (``solvers.pcg``). Eager PyTorch writes every intermediate out, where
  XLA fuses them, so the count sits well above the analytic model; its
  ratio is pinned by ``tests/test_torch_costs.py``;
- **roofline attribution** (:func:`roofline_summary`): the bytes each
  backend must move per iteration, times measured iterations over measured
  seconds, as a fraction of the card's bandwidth.

The bytes model of the port's own backends (:func:`iteration_bytes`) counts
what their kernels move, each input read once and each output written once
(``KERNEL_PASSES``): kernels A + B over the canvas's band (A′ + B′ over the
grid's interior on a column-blocked canvas) for ``fused``, (C + D) / 2 for
``ca``, the sum over the shards' bands for the kernel-sharded backends.
``chip_smoke.py`` reads its per-kernel bytes from the same table. The
``resident`` solve keeps its state on chip and the ``native`` oracle runs
on the host, so neither has a figure; the plain ``torch`` and ``sharded``
solves take the JAX package's ``xla`` model, 8 passes of the grid.

Everything here is advisory: :func:`bench_costs` returns None instead of
raising, and ``POISSON_TPU_COST_ANALYSIS=0`` turns it off.
"""

from __future__ import annotations

import os
from typing import Optional

from poisson_tpu_torch.obs import metrics

# -- the analytic model (the JAX package's, constant for constant) -------
#
# Units: one "pass" = (M+1)·(N+1)·dtype_bytes. The tallies count HLO
# operand and result traffic of the JAX package's fused loop body
# (poisson_tpu/obs/costs.py:47-87).
_SCALED_BYTES_TERMS = {
    "stencil_apply": 5 + 2 + 2 + 2 + 1,
    "denominator_dot": 2,
    "state_update": 5 + 2,
    "z_propagation": 2,
    "p_update": 3,
    "loop_overhead": 7,
}
_UNSCALED_BYTES_TERMS = {
    "stencil_apply": 5 + 2 + 2 + 1,
    "denominator_dot": 2,
    "state_update": 4 + 2,
    "preconditioner": 4,
    "zeta_dot": 2,
    "p_update": 3,
    "loop_overhead": 20,
}
_SCALED_FLOPS_PER_POINT = 34.0
_UNSCALED_FLOPS_PER_POINT = 54.0


def grid_points(M: int, N: int) -> int:
    """Full-grid points (M+1)·(N+1), the footprint a pass is quoted in."""
    return (M + 1) * (N + 1)


def analytic_iteration_cost(M: int, N: int, dtype_bytes: int = 4,
                            scaled: bool = True) -> dict:
    """Closed-form bytes and FLOPs of one PCG iteration on an (M, N) grid:
    ``{"flops", "bytes", "passes", "flops_per_point", "terms"}``."""
    terms = dict(_SCALED_BYTES_TERMS if scaled else _UNSCALED_BYTES_TERMS)
    passes = float(sum(terms.values()))
    fpp = _SCALED_FLOPS_PER_POINT if scaled else _UNSCALED_FLOPS_PER_POINT
    pts = grid_points(M, N)
    return {
        "flops": fpp * pts,
        "bytes": passes * pts * dtype_bytes,
        "passes": passes,
        "flops_per_point": fpp,
        "terms": terms,
    }


def apportion_compute(span_seconds: float, member_iterations: dict) -> dict:
    """Split one shared span's wall across its members by iteration count;
    members that advanced no iteration get 0.0, and the shares sum to
    ``span_seconds``."""
    total = sum(max(0, int(k)) for k in member_iterations.values())
    if total <= 0:
        return {mid: 0.0 for mid in member_iterations}
    return {mid: span_seconds * max(0, int(k)) / total
            for mid, k in member_iterations.items()}


def mg_vcycle_cost(M: int, N: int, dtype_bytes: int = 4,
                   config=None, scaled: bool = True) -> dict:
    """Analytic traffic of one geometric V-cycle (``poisson_tpu_torch.mg``)
    in the units of :func:`analytic_iteration_cost`, with the JAX package's
    per-level tallies (smoothing 15 passes a sweep, 3 for the first from
    zero, residual 12, restriction 1.25, prolongation 2.25; the coarsest
    level a dense matvec or ``coarse_sweeps`` sweeps; 4 more fine passes
    for the scaled system's wrap). Returns ``{"bytes", "flops",
    "passes_fine_equivalent", "levels", "coarse_dense", "terms"}`` and sets
    the ``cost.mg.*`` gauges."""
    from poisson_tpu_torch.mg.hierarchy import DEFAULT_MG, plan_levels

    cfg = config or DEFAULT_MG
    dims = plan_levels(M, N, cfg)
    pts0 = grid_points(M, N)
    sweep, first_sweep, residual, restrict, prolong = 15.0, 3.0, 12.0, 1.25, 2.25
    per_level = (first_sweep + (cfg.pre_smooth - 1) * sweep
                 if cfg.pre_smooth > 0 else 0.0)
    per_level += residual + restrict + prolong + cfg.post_smooth * sweep
    bytes_total = 0.0
    flops_total = 0.0
    for m, n in dims[:-1]:
        pts = grid_points(m, n)
        bytes_total += per_level * pts * dtype_bytes
        sweeps = cfg.pre_smooth + cfg.post_smooth
        flops_total += (13.0 * sweeps + 12.0) * pts
    mc, nc = dims[-1]
    n_int = (mc - 1) * (nc - 1)
    coarse_dense = n_int <= cfg.coarse_dense_limit
    if coarse_dense:
        bytes_total += float(n_int) * n_int * dtype_bytes
        flops_total += 2.0 * n_int * n_int
    else:
        pts = grid_points(mc, nc)
        bytes_total += cfg.coarse_sweeps * sweep * pts * dtype_bytes
        flops_total += 13.0 * cfg.coarse_sweeps * pts
    if scaled:
        bytes_total += 4.0 * pts0 * dtype_bytes
    report = {
        "bytes": bytes_total,
        "flops": flops_total,
        "passes_fine_equivalent": bytes_total / (pts0 * dtype_bytes),
        "levels": len(dims),
        "coarse_dense": coarse_dense,
        "terms": {
            "per_level_passes": per_level,
            "coarsest": f"{mc}x{nc}",
            "coarse_dense_bytes": (float(n_int) * n_int * dtype_bytes
                                   if coarse_dense else 0.0),
        },
    }
    metrics.gauge("cost.mg.bytes_per_cycle", bytes_total)
    metrics.gauge("cost.mg.flops_per_cycle", flops_total)
    metrics.gauge("cost.mg.passes", report["passes_fine_equivalent"])
    return report


def krylov_block_cost(M: int, N: int, B: int, dtype_bytes: int = 4,
                      scaled: bool = True) -> dict:
    """Analytic traffic of one block-CG iteration over B right-hand sides
    (``krylov.block``): B member iterations plus 12·B coupling passes (three
    Gram products, three recombinations) and the B×B solves' flops. Sets
    the ``cost.krylov.block_*`` gauges."""
    base = analytic_iteration_cost(M, N, dtype_bytes, scaled)
    pts = grid_points(M, N)
    coupling_passes = 12.0 * B
    bytes_total = B * base["bytes"] + coupling_passes * pts * dtype_bytes
    flops = (B * base["flops"]
             + 3.0 * (2.0 * B * B) * pts
             + 3.0 * (2.0 * B * B) * pts
             + 30.0 * B ** 3)
    report = {
        "bytes": bytes_total,
        "flops": flops,
        "bytes_per_member_iteration": bytes_total / B,
        "passes_per_member": bytes_total / (B * pts * dtype_bytes),
        "coupling_passes": coupling_passes,
    }
    metrics.gauge("cost.krylov.block_bytes_per_iter", bytes_total)
    metrics.gauge("cost.krylov.block_flops_per_iter", flops)
    metrics.gauge("cost.krylov.block_passes_per_member",
                  report["passes_per_member"])
    return report


def krylov_deflated_cost(M: int, N: int, k: int, dtype_bytes: int = 4,
                         scaled: bool = True) -> dict:
    """Analytic traffic of one deflated-CG iteration with a k-vector basis
    (``krylov.recycle``): the plain iteration plus 2k basis passes. Sets the
    ``cost.krylov.deflated_*`` gauges."""
    base = analytic_iteration_cost(M, N, dtype_bytes, scaled)
    pts = grid_points(M, N)
    basis_passes = 2.0 * k
    bytes_total = base["bytes"] + basis_passes * pts * dtype_bytes
    flops = base["flops"] + 2.0 * (2.0 * k) * pts + 2.0 * k * k
    report = {
        "bytes": bytes_total,
        "flops": flops,
        "passes": bytes_total / (pts * dtype_bytes),
        "basis_passes": basis_passes,
    }
    metrics.gauge("cost.krylov.deflated_bytes_per_iter", bytes_total)
    metrics.gauge("cost.krylov.deflated_flops_per_iter", flops)
    metrics.gauge("cost.krylov.deflated_passes", report["passes"])
    return report


# -- the port's kernels: bytes each must move ----------------------------

# Per launch: (canvases over the band it must read once or write once,
# canvas rows it must also move past the band). A reads z, p, cS, cW, γ
# and writes pn, Ap; B reads p, Ap, sc², w, r and writes w, r; C reads
# p_prev, r, cS, cW, γ, sc² and writes pn, t1, t2, t3; D reads pn, t1, t2,
# t3, x, r and writes x, r, p₁. The sharded forms also move rows past the
# band: A reads z and p on the two halo rows and writes pn there (6) and
# reads the column mask (1); C reads p_prev and r on its four ring rows
# (8), cS on three rows past the centre and cW and γ on two (7), and the
# mask (1); B and D read the mask (1). A′ and B′ move A's and B's canvases
# over the grid's interior. R, one launch per solve, reads cS, cW, γ, the
# RHS and sc² once and writes w once: its state never streams, so its
# backend has no bytes per iteration.
KERNEL_PASSES = {
    "direction_stencil": (7, 0),
    "fused_update": (7, 0),
    "basis_sweep": (10, 0),
    "pair_update": (9, 0),
    "direction_stencil_sharded": (7, 7),
    "fused_update_sharded": (7, 1),
    "basis_sweep_sharded": (10, 16),
    "pair_update_sharded": (9, 1),
    "direction_stencil_blocked": (7, 0),
    "fused_update_blocked": (7, 0),
    "resident_solve": (6, 0),
}

# The kernels of one iteration of each kernel backend, and the launches of
# each per iteration (the CA pair iteration runs C and D once per two).
BACKEND_KERNELS = {
    "fused": (("direction_stencil", 1.0), ("fused_update", 1.0)),
    "fused-blocked": (("direction_stencil_blocked", 1.0),
                      ("fused_update_blocked", 1.0)),
    "ca": (("basis_sweep", 0.5), ("pair_update", 0.5)),
    "fused-sharded": (("direction_stencil_sharded", 1.0),
                      ("fused_update_sharded", 1.0)),
    "ca-sharded": (("basis_sweep_sharded", 0.5),
                   ("pair_update_sharded", 0.5)),
}

# Grid passes per iteration of the plain solves (the JAX package's ``xla``
# model, its measured fusion break-even) and of their batched form.
EFFECTIVE_PASSES = {
    "torch": 8.0,
    "sharded": 8.0,
    "torch_batched": 8.0,
}

def kernel_bytes(name: str, points: int, cols: int = 0,
                 dtype_bytes: int = 4) -> int:
    """Bytes one launch of kernel ``name`` must move over ``points`` band
    points on a canvas of ``cols`` columns."""
    passes, extra_rows = KERNEL_PASSES[name]
    return (passes * points + extra_rows * cols) * dtype_bytes


def iteration_bytes(problem, backend: str, bm: Optional[int] = None,
                    bn: Optional[int] = None, mesh_shape=None,
                    dtype_bytes: int = 4) -> Optional[float]:
    """Bytes one iteration of ``backend`` must move on ``problem``'s grid
    (``bm``/``bn`` the fused or CA canvas, ``mesh_shape`` (px, py) the
    sharded backends' mesh). None for ``resident`` (its state stays on
    chip), ``native`` (it runs on the host) and unknown backends."""
    if backend in EFFECTIVE_PASSES:
        return (EFFECTIVE_PASSES[backend]
                * grid_points(problem.M, problem.N) * dtype_bytes)
    if backend in ("fused", "ca"):
        from poisson_tpu_torch.ops.fused_cg import canvas_spec, sweep_points

        cv = canvas_spec(problem, bm, bn if backend == "fused" else 0)
        points, shards, cols = sweep_points(problem, cv), 1, cv.cols
        if backend == "fused" and cv.cg:
            backend = "fused-blocked"
    elif backend in ("fused-sharded", "ca-sharded"):
        from poisson_tpu_torch.parallel.fused_sharded import shard_spec

        px, py = mesh_shape or (1, 1)
        spec = shard_spec(problem, px, py,
                          1 if backend == "fused-sharded" else 2)
        points, shards, cols = spec.m_blk * spec.cv.cols, px * py, spec.cv.cols
    else:
        return None
    return shards * sum(per * kernel_bytes(name, points, cols, dtype_bytes)
                        for name, per in BACKEND_KERNELS[backend])


# -- the counted program ------------------------------------------------

# Ops that move no data of their own: views, and the metadata of a result.
_FREE_OPS = ("aten::detach", "aten::alias", "aten::lift_fresh",
             "aten::_to_copy")


def _count_one_call(fn) -> dict:
    """Run ``fn()`` under a ``TorchDispatchMode`` that counts every aten
    op's operand and result bytes and its elementwise operations (the
    largest operand's element count). Views count nothing: they move no
    data."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    tally = {"bytes": 0, "flops": 0, "ops": 0}

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.is_view or func.name() in _FREE_OPS:
                return out
            tensors = [t for t in tree_leaves((args, kwargs, out))
                       if isinstance(t, torch.Tensor)]
            tally["ops"] += 1
            tally["bytes"] += sum(t.numel() * t.element_size()
                                  for t in tensors)
            tally["flops"] += max((t.numel() for t in tensors), default=0)
            return out

    with Counter():
        fn()
    return tally


def program_memory(device) -> Optional[int]:
    """Peak device memory allocated on ``device`` since its peak was last
    reset (``torch.cuda.max_memory_allocated``); None on the CPU."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    return int(torch.cuda.max_memory_allocated(dev))


def measured_iteration_cost(problem, dtype=None, scaled=None,
                            device=None) -> dict:
    """Count one iteration of the plain PCG body (``solvers.pcg``) on
    ``device`` (default ``cuda``) and report it beside the analytic model.
    The body runs once from the start state; setup is not counted. Sets the
    ``cost.*`` gauges the JAX package sets. ``model_agreement`` is the
    counted/model bytes ratio: eager PyTorch writes every intermediate, so
    it sits above 1 (``tests/test_torch_costs.py`` pins it).
    ``peak_memory_bytes`` is what the setup and the iteration add to the
    card's allocated memory at their peak (the peak is reset first, and
    what the process already held is left out); None on the CPU."""
    import torch

    from poisson_tpu_torch.solvers.pcg import (
        init_state,
        make_pcg_body,
        resolve_dtype,
        resolve_scaled,
        solve_setup,
    )
    from poisson_tpu_torch.utils.platform import resolve_device

    dtype_name = resolve_dtype(dtype)
    use_scaled = resolve_scaled(scaled, dtype_name)
    dev = resolve_device(device)
    held = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    setup = solve_setup(problem, dtype_name, use_scaled, dev)
    body = make_pcg_body(setup.ops, delta=problem.delta,
                         weighted_norm=problem.weighted_norm,
                         h1=problem.h1, h2=problem.h2)
    state = init_state(setup.ops, setup.rhs)
    counted = _count_one_call(lambda: body(state))
    model = analytic_iteration_cost(problem.M, problem.N,
                                    setup.rhs.element_size(), use_scaled)
    report = {
        "program": "torch_iteration_body",
        "grid": [problem.M, problem.N],
        "dtype": dtype_name,
        "scaled": use_scaled,
        "counted_ops_per_iter": counted["ops"],
        "counted_flops_per_iter": counted["flops"],
        "counted_bytes_per_iter": counted["bytes"],
        "model_flops_per_iter": model["flops"],
        "model_bytes_per_iter": model["bytes"],
        "model_passes": model["passes"],
        "model_agreement": counted["bytes"] / model["bytes"],
        "peak_memory_bytes": (None if dev.type != "cuda"
                              else program_memory(dev) - held),
    }
    for key in ("counted_flops_per_iter", "counted_bytes_per_iter",
                "model_flops_per_iter", "model_bytes_per_iter",
                "model_agreement", "peak_memory_bytes"):
        if report[key] is not None:
            metrics.gauge(f"cost.{key}", report[key])
    return report


# -- roofline attribution -----------------------------------------------

# Peak HBM bandwidth per device, GB/s, matched by substring against the
# device's name (``torch.cuda.get_device_name``, or a libtpu device kind),
# the more specific strings first. NVIDIA's data sheets: H100 NVL 3.9 TB/s,
# H100 PCIe 2.0 TB/s, H100 SXM (80GB HBM3) 3.35 TB/s. The TPU rows are the
# JAX package's. POISSON_TPU_PEAK_GBPS overrides.
PEAK_GBPS_BY_DEVICE = (
    ("h100 nvl", 3900.0),
    ("h100 pcie", 2000.0),
    ("h100 sxm", 3350.0),
    ("h100 80gb hbm3", 3350.0),
    ("v5 lite", 820.0),
    ("v5litepod", 820.0),
    ("v5e", 820.0),
    ("v5p", 2765.0),
    ("v6e", 1640.0),
    ("v6 lite", 1640.0),
    ("v4", 1228.0),
    ("v3", 900.0),
    ("v2", 700.0),
)


def platform_peak_gbps(device_kind: Optional[str]) -> Optional[float]:
    """Bandwidth ceiling for a device name (None when unknown);
    ``POISSON_TPU_PEAK_GBPS`` wins when set."""
    env = os.environ.get("POISSON_TPU_PEAK_GBPS")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if not device_kind:
        return None
    kind = str(device_kind).lower()
    for sub, gbps in PEAK_GBPS_BY_DEVICE:
        if sub in kind:
            return gbps
    return None


def roofline_summary(problem, backend: Optional[str], dtype_bytes: int,
                     iterations: int, solve_seconds: float,
                     device_kind: Optional[str] = None,
                     devices: int = 1,
                     passes_override: Optional[float] = None,
                     bytes_per_iter: Optional[float] = None) -> dict:
    """Achieved-vs-roofline attribution of one measured solve: the bytes an
    iteration must move × iterations / seconds, per device, over the
    device's ceiling. ``bytes_per_iter`` (from :func:`iteration_bytes`)
    takes the place of the pass model for the kernel backends, whose
    canvases are not the grid; otherwise the pass model is
    ``passes_override`` or :data:`EFFECTIVE_PASSES`, as in the JAX package.
    Sets the ``roofline.*`` gauges."""
    grid_bytes = grid_points(problem.M, problem.N) * dtype_bytes
    if bytes_per_iter is not None:
        passes = bytes_per_iter / grid_bytes
    else:
        passes = (passes_override if passes_override is not None
                  else EFFECTIVE_PASSES.get(backend or ""))
    peak = platform_peak_gbps(device_kind)
    achieved = None
    if passes and solve_seconds and solve_seconds > 0 and iterations:
        achieved = (passes * grid_bytes * iterations
                    / solve_seconds / max(1, devices) / 1e9)
    fraction = (achieved / peak) if (achieved and peak) else None
    report = {
        "passes_model": passes,
        "bytes_per_iter_model": (
            (bytes_per_iter if bytes_per_iter is not None
             else passes * grid_bytes) if passes else None
        ),
        "achieved_gbps": round(achieved, 2) if achieved else None,
        "peak_gbps": peak,
        "fraction": round(fraction, 4) if fraction else None,
    }
    for key in ("achieved_gbps", "peak_gbps", "fraction"):
        if report[key] is not None:
            metrics.gauge(f"roofline.{key}", report[key])
    return report


def bench_costs(problem, dtype=None, backend: Optional[str] = None,
                iterations: Optional[int] = None,
                solve_seconds: Optional[float] = None,
                device_kind: Optional[str] = None, devices: int = 1,
                device=None,
                bytes_per_iter: Optional[float] = None) -> Optional[dict]:
    """The cost block a bench record carries: the counted plain iteration
    beside the analytic model (:func:`measured_iteration_cost`, on
    ``device``) and the roofline of the measured run. The anchor is the
    plain body every backend is held against; the kernel backends'
    bytes come from ``bytes_per_iter``. ``POISSON_TPU_COST_ANALYSIS=0``
    disables the block; any internal failure returns None (the block is
    advisory)."""
    if os.environ.get("POISSON_TPU_COST_ANALYSIS", "1") == "0":
        return None
    try:
        import torch

        from poisson_tpu_torch.solvers.pcg import resolve_dtype

        dtype_name = resolve_dtype(dtype)
        block = measured_iteration_cost(problem, dtype=dtype_name,
                                        device=device)
        if iterations and solve_seconds:
            block["roofline"] = roofline_summary(
                problem, backend, getattr(torch, dtype_name).itemsize,
                iterations, solve_seconds, device_kind, devices,
                bytes_per_iter=bytes_per_iter)
        return block
    except Exception:
        return None
