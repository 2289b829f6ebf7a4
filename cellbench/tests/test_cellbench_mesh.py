"""The mesh cell's readers (``halo_us_per_iter``, ``mesh_sum_us_per_iter``,
``peer_copy_us_per_iter``) on a canned capture of two cards, and nothing
where the ranges or the copies between cards are absent."""

import pytest

from cellbench import capture, spec
from cellbench.capture import Capture, Event

HALO, SUM, REP = "mesh.halo", "mesh.sum", "mesh.replicate"
PTOP = "Memcpy PtoP (Device -> Device)"
READERS = ("halo_us_per_iter", "mesh_sum_us_per_iter",
           "peer_copy_us_per_iter")


def canned():
    """One 0–1000 µs slice of 4 iterations on cards 0 and 1. The first
    halo range starts before the slice, one sum range ends after it, one
    replicate range lies wholly outside; on card 0 two peer copies overlap
    and one starts before the slice, on card 1 one copy runs beside a
    kernel."""
    host = [(capture.ANNOTATION, 0, 1000), ("pcg.drive.enqueue", 0, 990),
            (HALO, -30, 50), (HALO, 300, 380), (SUM, 100, 160),
            (REP, 200, 210), (SUM, 600, 700), (REP, 720, 725),
            (SUM, 980, 1040), (REP, 1500, 1600)]
    ev = [Event(n, "host", -1, float(s), float(t - s)) for n, s, t in host]
    dev = [(PTOP, 0, -10, 20), (PTOP, 0, 400, 450), (PTOP, 0, 430, 470),
           ("direction_stencil_sharded", 0, 500, 600),
           (PTOP, 1, 410, 440), ("direction_stencil_sharded", 1, 440, 540),
           ("Memcpy DtoH (Device -> Pageable)", 1, 900, 950)]
    ev += [Event(n, "kernel" if n[0] == "d" else "memcpy", c, float(s),
                 float(t - s)) for n, c, s, t in dev]
    return Capture(events=tuple(ev), start_us=0.0, end_us=1000.0,
                   cards=(0, 1), iterations=4, solve_iterations=(4,),
                   config={"grid": {"M": 2400, "N": 3200}},
                   device_kind="NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("metric,value", [
    # 50 (clipped at the start) + 80 µs
    ("halo_us_per_iter", (50 + 80) / 4),
    # sums 60 + 100 + 20 (clipped at the end), replicas 10 + 5 µs
    ("mesh_sum_us_per_iter", (60 + 100 + 20 + 10 + 5) / 4),
    # card 0: 20 (clipped) + the union 400–470; card 1: 30; the mean
    ("peer_copy_us_per_iter", ((20 + 70) + 30) / 2 / 4),
])
def test_mesh_reader_on_a_canned_capture(metric, value):
    assert spec.reader(metric)(canned()) == pytest.approx(value, rel=1e-9)


@pytest.mark.parametrize("metric", READERS)
def test_a_mesh_reader_with_nothing_to_read_returns_nothing(metric):
    cap = canned()
    bare = cap._replace(events=tuple(
        e for e in cap.events if e.name not in (HALO, SUM, REP, PTOP)))
    assert spec.reader(metric)(bare) is None
    # ranges and copies that all lie outside the slice read as none too
    late = cap._replace(start_us=5000.0, end_us=6000.0)
    assert spec.reader(metric)(late) is None


def test_the_peer_copies_of_one_card_are_read_as_a_mean_over_the_cards():
    cap = canned()
    one = cap._replace(events=tuple(e for e in cap.events
                                    if e.device in (-1, 1)))
    assert spec.reader("peer_copy_us_per_iter")(one) == pytest.approx(
        30 / 2 / 4)
    assert spec.reader("peer_copy_us_per_iter")(
        one._replace(cards=())) is None


@pytest.mark.parametrize("metric", READERS)
def test_only_the_mesh_cell_lists_the_mesh_readers(metric):
    (entry,) = [m for m in spec.benchmark()["per_layer"]
                if m["name"] == metric]
    assert entry["workloads"] == ["ellipse-2400x3200-mesh2x2.fused"]
    assert entry["layer"] == "mesh (parallel.halo)"
    assert entry["moves"] == "solves_per_s"


def test_a_traced_cpu_run_of_the_mesh_cell_reads_the_programs_ranges():
    """At 40×60 on four CPU shards the program's own ranges are read; the
    copies between cards need cards, so that reader finds nothing."""
    import copy

    from cellbench import run

    cell = spec.load_cell("ellipse-2400x3200-mesh2x2.fused")
    cfg = copy.deepcopy(cell.config)
    cfg["grid"] = {"M": 40, "N": 60}
    result, _, _ = run.run_cell(cell._replace(config=cfg), 2 ** 31 + 43,
                                0.3, True, kind="cpu")
    assert result["correct"] is True
    got = {k: v["value"] for k, v in result["metrics"].items()
           if k in READERS}
    assert set(got) == {"halo_us_per_iter", "mesh_sum_us_per_iter"}
    assert all(v > 0 for v in got.values())
