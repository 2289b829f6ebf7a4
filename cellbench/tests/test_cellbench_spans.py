"""The readers of the program's own host ranges (``enqueue_us_per_iter``,
``check_us_per_iter``, ``staging_ms_per_solve``) on a canned capture, the
breakdown naming an idle stretch by the range that covers it, and one
traced run on the CPU reporting them."""

import copy

import pytest

from cellbench import capture, run, spec
from cellbench.capture import Capture, Event

ENQ, CHK = "pcg.drive.enqueue", "pcg.drive.check"
RHS_IN, W_OUT = "stage.rhs_in", "stage.w_out"
SPAN_METRICS = ("enqueue_us_per_iter", "check_us_per_iter",
                "staging_ms_per_solve")


def small(cell, M=40, N=60):
    cfg = copy.deepcopy(cell.config)
    cfg["grid"] = {"M": M, "N": N}
    return cell._replace(config=cfg)


def canned():
    """Two solves over a 0–1000 µs slice on one card. The first solve's
    ``stage.rhs_in`` starts before the slice, the last ``stage.w_out``
    ends after it, and one enqueue falls wholly outside."""
    host = [(capture.ANNOTATION, 0, 500), (capture.ANNOTATION, 520, 1000),
            (RHS_IN, -20, 30), (ENQ, 40, 240), ("cudaLaunchKernel", 90, 100),
            (CHK, 240, 260), (ENQ, 300, 420), (CHK, 420, 480),
            (W_OUT, 480, 495), (RHS_IN, 520, 560), (ENQ, 560, 900),
            (CHK, 900, 950), (W_OUT, 950, 1030), (ENQ, 2000, 2100)]
    ev = [Event(n, "host", -1, float(s), float(t - s)) for n, s, t in host]
    ev += [Event("direction_stencil_kernel", "kernel", 0, 100.0, 50.0),
           Event("fused_update_kernel", "kernel", 0, 600.0, 50.0)]
    return Capture(events=tuple(ev), start_us=0.0, end_us=1000.0,
                   cards=(0,), iterations=10, solve_iterations=(4, 6),
                   config={"grid": {"M": 800, "N": 1200}},
                   device_kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("metric,value", [
    ("enqueue_us_per_iter", (200 + 120 + 340) / 10),
    ("check_us_per_iter", (20 + 60 + 50) / 10),
    # 30 (clipped at the start) + 15 + 40 + 50 (clipped at the end) µs
    ("staging_ms_per_solve", (30 + 15 + 40 + 50) / 1e3 / 2),
])
def test_span_reader_on_a_canned_capture(metric, value):
    assert spec.reader(metric)(canned()) == pytest.approx(value, rel=1e-9)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_a_span_reader_with_no_range_returns_nothing(metric):
    cap = canned()
    bare = cap._replace(events=tuple(
        e for e in cap.events if e.kind != "host"
        or e.name in (capture.ANNOTATION, "cudaLaunchKernel")))
    assert spec.reader(metric)(bare) is None
    # ranges that all lie outside the slice read as none too
    late = cap._replace(start_us=5000.0, end_us=6000.0)
    assert spec.reader(metric)(late) is None


def test_breakdown_names_idle_time_inside_a_range_by_the_range():
    idle = dict(capture.breakdown(canned())["idle_gaps"])
    # card idle 0-100, 150-600, 650-1000 µs; each stretch goes to the
    # innermost range over it (the launch call inside the first enqueue)
    assert idle[ENQ] == pytest.approx((50 + 90 + 120 + 40 + 250) / 1e6)
    assert idle[CHK] == pytest.approx((20 + 60 + 50) / 1e6)
    assert idle[RHS_IN] == pytest.approx((30 + 40) / 1e6)
    assert idle[W_OUT] == pytest.approx((15 + 50) / 1e6)
    assert idle["cudaLaunchKernel"] == pytest.approx(10 / 1e6)
    assert idle[capture.UNTRACED] == pytest.approx((10 + 40 + 25) / 1e6)
    assert sum(idle.values()) == pytest.approx(900 / 1e6)


@pytest.mark.parametrize("workload", ["ellipse-800x1200.fused",
                                      "ellipse-800x1200.resident-rhs"])
def test_a_traced_run_reports_the_span_metrics_its_cell_lists(workload):
    cell = small(spec.load_cell(workload))
    listed = {m["name"] for m in cell.per_layer} & set(SPAN_METRICS)
    result, _, _ = run.run_cell(cell, 2 ** 31 + 17, 0.3, True, kind="cpu")
    assert result["correct"] is True
    got = {k: v["value"] for k, v in result["metrics"].items()
           if k in SPAN_METRICS}
    assert set(got) == listed and all(v > 0 for v in got.values())


def test_the_gated_cell_lists_no_span_metric():
    cell = spec.load_cell("ellipse-800x1200.resident")
    assert not {m["name"] for m in cell.per_layer} & set(SPAN_METRICS)
