"""Port parity: the cost layer (``poisson_tpu_torch.obs.costs``) against
``poisson_tpu.obs.costs`` on the CPU, and the port's own bytes model.

The analytic functions are the JAX package's arithmetic and must give the
same numbers exactly. The bytes model of the port's backends must equal
the sum of their kernels' bytes, computed as ``chip_smoke.py`` computes
them (``PERF.md`` §6: inputs read once, outputs written once over the
band). The counted plain iteration (a ``TorchDispatchMode`` over one
iteration of the eager body) sits above the analytic model, because eager
PyTorch writes every intermediate out where XLA fuses them; its ratio is
pinned here.
"""

import pytest
import torch

from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.obs import costs as jax_costs
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import costs, metrics
from poisson_tpu_torch.ops import fused_cg
from poisson_tpu_torch.parallel.fused_sharded import shard_spec

GRIDS = [(40, 40), (400, 600), (800, 1200), (2400, 3200)]
TPU_KINDS = ["TPU v5 lite", "TPU v5e", "TPU v5p", "TPU v6e", "TPU v4",
             "TPU v3", "TPU v2", "cpu", "", None, "Some Unknown Part"]


@pytest.fixture(autouse=True)
def _fresh_registries(monkeypatch):
    monkeypatch.delenv("POISSON_TPU_PEAK_GBPS", raising=False)
    monkeypatch.delenv("POISSON_TPU_COST_ANALYSIS", raising=False)
    for reg in (metrics, jax_metrics):
        reg.reset()
    yield
    for reg in (metrics, jax_metrics):
        reg.reset()


@pytest.mark.parametrize("M,N", GRIDS)
@pytest.mark.parametrize("dtype_bytes", [2, 4, 8])
@pytest.mark.parametrize("scaled", [True, False])
def test_analytic_models_equal_the_jax_packages(M, N, dtype_bytes, scaled):
    assert costs.grid_points(M, N) == jax_costs.grid_points(M, N)
    assert (costs.analytic_iteration_cost(M, N, dtype_bytes, scaled)
            == jax_costs.analytic_iteration_cost(M, N, dtype_bytes, scaled))
    for B in (1, 4, 16):
        assert (costs.krylov_block_cost(M, N, B, dtype_bytes, scaled)
                == jax_costs.krylov_block_cost(M, N, B, dtype_bytes,
                                               scaled))
    for k in (1, 9):
        assert (costs.krylov_deflated_cost(M, N, k, dtype_bytes, scaled)
                == jax_costs.krylov_deflated_cost(M, N, k, dtype_bytes,
                                                  scaled))
    assert (costs.mg_vcycle_cost(M, N, dtype_bytes, scaled=scaled)
            == jax_costs.mg_vcycle_cost(M, N, dtype_bytes, scaled=scaled))
    # The gauges the JAX functions set, by name and value.
    ours = metrics.snapshot()["gauges"]
    theirs = jax_metrics.snapshot()["gauges"]
    assert ours == theirs


def test_apportion_compute_equals_the_jax_packages():
    for shares in ({"a": 3, "b": 1, "c": 0}, {"x": 0}, {}, {"a": -2, "b": 5}):
        assert (costs.apportion_compute(0.37, shares)
                == jax_costs.apportion_compute(0.37, shares))


@pytest.mark.parametrize("kind", TPU_KINDS)
def test_platform_peak_on_tpu_strings_equals_the_jax_packages(kind):
    assert costs.platform_peak_gbps(kind) == jax_costs.platform_peak_gbps(kind)


def test_peak_override_equals_the_jax_packages(monkeypatch):
    monkeypatch.setenv("POISSON_TPU_PEAK_GBPS", "1234.5")
    assert (costs.platform_peak_gbps("NVIDIA H100 80GB HBM3")
            == jax_costs.platform_peak_gbps("TPU v4") == 1234.5)


@pytest.mark.parametrize("kind,gbps", [
    ("NVIDIA H100 80GB HBM3", 3350.0), ("NVIDIA H100 SXM5 80GB", 3350.0),
    ("NVIDIA H100 PCIe", 2000.0), ("NVIDIA H100 NVL", 3900.0),
    ("NVIDIA A100-SXM4-80GB", None)])
def test_h100_rows(kind, gbps):
    assert costs.platform_peak_gbps(kind) == gbps


@pytest.mark.parametrize("M,N", GRIDS)
@pytest.mark.parametrize("kind", ["TPU v5 lite", "TPU v4", None])
@pytest.mark.parametrize("override", [None, 11.25])
def test_roofline_summary_equals_the_jax_packages(M, N, kind, override):
    # The plain solve is the JAX package's ``xla``; ``sharded`` is named
    # alike in both.
    for port_backend, jax_backend in (("torch", "xla"),
                                      ("sharded", "sharded")):
        for devices in (1, 4):
            ours = costs.roofline_summary(
                Problem(M=M, N=N), port_backend, 4, 989, 0.37, kind,
                devices, passes_override=override)
            theirs = jax_costs.roofline_summary(
                JaxProblem(M=M, N=N), jax_backend, 4, 989, 0.37, kind,
                devices, passes_override=override)
            assert ours == theirs
    assert metrics.snapshot()["gauges"] == jax_metrics.snapshot()["gauges"]


def _smoke_bytes(name, points, cols=0):
    """A kernel's bytes per launch as chip_smoke.py's table gives them
    (KERNELS: passes over the band, extra rows of the sharded forms)."""
    passes, extra = {"A": (7, 0), "B": (7, 0), "C": (10, 0), "D": (9, 0),
                     "A_sh": (7, 7), "B_sh": (7, 1), "C_sh": (10, 16),
                     "D_sh": (9, 1)}[name]
    return (passes * points + extra * cols) * 4


@pytest.mark.parametrize("M,N", GRIDS)
def test_bytes_model_is_the_kernels_bytes(M, N):
    p = Problem(M=M, N=N)
    cv = fused_cg.canvas_spec(p)
    band = (cv.rows - 2 * fused_cg.HALO) * cv.cols
    assert costs.iteration_bytes(p, "fused") == (
        _smoke_bytes("A", band) + _smoke_bytes("B", band))
    assert costs.iteration_bytes(p, "ca") == (
        _smoke_bytes("C", band) + _smoke_bytes("D", band)) / 2
    for px, py in ((1, 1), (2, 2), (1, 4)):
        spec, cspec = shard_spec(p, px, py, 1), shard_spec(p, px, py, 2)
        pts, cpts = spec.m_blk * spec.cv.cols, cspec.m_blk * cspec.cv.cols
        assert costs.iteration_bytes(p, "fused-sharded",
                                     mesh_shape=(px, py)) == px * py * (
            _smoke_bytes("A_sh", pts, spec.cv.cols)
            + _smoke_bytes("B_sh", pts, spec.cv.cols))
        assert costs.iteration_bytes(p, "ca-sharded",
                                     mesh_shape=(px, py)) == px * py * (
            _smoke_bytes("C_sh", cpts, cspec.cv.cols)
            + _smoke_bytes("D_sh", cpts, cspec.cv.cols)) / 2
    for backend in ("resident", "native"):
        assert costs.iteration_bytes(p, backend) is None
    for backend in ("torch", "sharded"):
        assert costs.iteration_bytes(p, backend, dtype_bytes=8) == (
            8.0 * costs.grid_points(M, N) * 8)


@pytest.mark.parametrize("M,N,bn", [(2400, 3200, 1024), (1024, 16384, None),
                                    (800, 1200, 256)])
def test_blocked_bytes_count_the_grid_interior(M, N, bn):
    # A′ and B′ move A's and B's canvases over the grid's interior
    # (fused_cg.sweep_points), not the padded canvas they sweep.
    p = Problem(M=M, N=N)
    assert fused_cg.canvas_spec(p, bn=bn).cg
    assert costs.iteration_bytes(p, "fused", bn=bn) == (
        _smoke_bytes("A", p.interior_points)
        + _smoke_bytes("B", p.interior_points))


def test_bytes_model_matches_the_smokes_published_figures():
    # PERF.md §6, chip_smoke.py's "bytes moved": A and B 28.67 MB each at
    # 800×1200; the sharded forms 7.186 and 7.171 MB a shard on the 2×2 cut.
    p = Problem(M=800, N=1200)
    assert costs.iteration_bytes(p, "fused") == 2 * 28_672_000
    spec = shard_spec(p, 2, 2, 1)
    pts = spec.m_blk * spec.cv.cols
    assert costs.kernel_bytes("direction_stencil_sharded", pts,
                              spec.cv.cols) == pytest.approx(7.186e6,
                                                             rel=1e-3)
    assert costs.kernel_bytes("fused_update_sharded", pts,
                              spec.cv.cols) == pytest.approx(7.171e6,
                                                             rel=1e-3)


# Counted bytes of one eager iteration over the analytic model's, at
# 400×600: fp32 scaled 2.684 (85 aten ops), fp64 Jacobi 1.912 (89 ops),
# from this counter on the CPU. Eager PyTorch writes out every
# intermediate (α·p, the five stencil terms, each ``where`` of the frozen-
# state select) that XLA keeps in registers, so the two models need not
# agree to the JAX package's ±25%. Tolerance 2%: the ratio moves only if
# the body or PyTorch's op decomposition changes.
@pytest.mark.parametrize("dtype,ratio", [("float32", 2.684),
                                         ("float64", 1.912)])
def test_counted_iteration_is_pinned_against_the_model(dtype, ratio):
    rep = costs.measured_iteration_cost(Problem(M=400, N=600), dtype,
                                        device="cpu")
    assert rep["program"] == "torch_iteration_body"
    assert rep["model_agreement"] == pytest.approx(ratio, rel=0.02)
    assert rep["counted_bytes_per_iter"] == pytest.approx(
        ratio * rep["model_bytes_per_iter"], rel=0.02)
    assert rep["counted_flops_per_iter"] > 0
    assert rep["peak_memory_bytes"] is None          # no card: no figure
    assert metrics.snapshot()["gauges"]["cost.model_agreement"] == (
        rep["model_agreement"])


def test_bench_costs_block_and_its_off_switch(monkeypatch):
    p = Problem(M=40, N=40)
    block = costs.bench_costs(p, "float32", "fused", iterations=50,
                              solve_seconds=0.01, device_kind="cpu",
                              device="cpu",
                              bytes_per_iter=costs.iteration_bytes(p,
                                                                   "fused"))
    assert block["roofline"]["bytes_per_iter_model"] == (
        costs.iteration_bytes(p, "fused"))
    assert block["roofline"]["fraction"] is None     # no ceiling for a CPU
    monkeypatch.setenv("POISSON_TPU_COST_ANALYSIS", "0")
    assert costs.bench_costs(p, "float32", "fused", 50, 0.01,
                             device="cpu") is None


def test_bench_costs_failure_is_none_not_a_raise():
    # An unknown dtype makes the counted iteration fail: the block is
    # advisory, so the record just lacks it.
    assert costs.bench_costs(Problem(M=40, N=40), "int8", "torch", 5, 0.1,
                             device="cpu") is None
