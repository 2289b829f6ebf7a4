"""Port parity: geometry as data (``poisson_tpu_torch.geometry`` and
``geometry=`` through the plain, MG, chunked, batched, lane and CLI
solves) against ``poisson_tpu.geometry``, on the CPU.

Tolerances: fingerprints, canonical JSON, parse errors, the fp64 host
canvases (every family, a square and a non-square grid, five seeded
random polygons), the MG hierarchy built from them and the ``geometry``
subcommand's JSON equal JAX's exactly; ``pcg_solve(geometry=)`` gives
JAX's count and flag, the fp64 iterate within 1e-10 of JAX's and the fp32
one (JAX's fp32 count) within 1e-6 of JAX's fp64 iterate; manufactured
``rel`` within 1e-10 of JAX's and under JAX's floors. Inside the port the
mixed batch, the multi-geometry lanes, the verified, streamed and chunked
geometry solves equal their solo or one-shot solves bit for bit.
"""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from poisson_tpu import geometry as jgeo
from poisson_tpu.cli import main as jax_cli_main
from poisson_tpu.config import Problem as JaxProblem
from poisson_tpu.geometry import canvas as jax_canvas
from poisson_tpu.geometry import dsl as jdsl
from poisson_tpu.geometry import manufactured as jax_manufactured
from poisson_tpu.mg import hierarchy as jax_hierarchy
from poisson_tpu.obs import metrics as jax_metrics
from poisson_tpu.solvers import batched as jax_batched
from poisson_tpu.solvers.pcg import pcg_solve as jax_pcg_solve
from poisson_tpu_torch import geometry as geo
from poisson_tpu_torch import interop
from poisson_tpu_torch.cli import main as cli_main
from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.geometry import canvas, dsl, manufactured
from poisson_tpu_torch.mg import hierarchy as mg_hierarchy
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.parallel.mesh import make_solver_mesh
from poisson_tpu_torch.solvers import batched
from poisson_tpu_torch.solvers.checkpoint import pcg_solve_chunked
from poisson_tpu_torch.solvers.lanes import LaneBatch
from poisson_tpu_torch.solvers.pcg import host_fields64, pcg_solve

pytestmark = pytest.mark.geom

CPU = dict(device="cpu")
CASES = [c.name for c in manufactured.cases()]
# JAX's floors (tests/test_geometry_dsl.py:246-255).
FLOOR_REL = {"ellipse": 6e-2, "ellipse-offset": 1e-1, "rectangle": 6e-2,
             "polygon": 6e-2, "union": 7e-2, "intersection": 1e-1,
             "difference": 5e-2, "sdf": 1.5e-1}


@pytest.fixture(autouse=True)
def _fresh_state():
    """One intra-op thread (several workers share the cores), and the
    caches and counters of both packages cleared around each test."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    resets = (metrics.reset, canvas.reset_geometry_cache,
              batched.reset_bucket_cache, jax_metrics.reset,
              jax_canvas.reset_geometry_cache, jax_batched.reset_bucket_cache)
    for reset in resets:
        reset()
    yield
    for reset in resets:
        reset()
    torch.set_num_threads(saved)


def _specs(d):
    """One spec of every family and nesting, built with the DSL module
    ``d`` (either package's), so both sides construct the same values."""
    a = d.Ellipse(cx=0.1, rx=0.5, ry=0.3)
    b = d.Rectangle(-0.5, -0.3, 0.5, 0.3)
    c = d.Ellipse(cx=-0.2, rx=0.4, ry=0.2)
    tri = d.Polygon(((0.0, 0.0), (0.6, 0.0), (0.3, 0.4)))
    return {
        "ellipse-default": d.DEFAULT_ELLIPSE,
        "ellipse": a,
        "rectangle": b,
        "rectangle-ints": d.Rectangle(-1, 0, 1, 1),
        "polygon": tri,
        "polygon-cw": d.Polygon(((0.3, 0.4), (0.6, 0.0), (0.0, 0.0))),
        "union": d.Union((a, b, c)),
        "union-nested": d.Union((b, d.Union((c, a)))),
        "union-dup": d.Union((a, a)),
        "intersection": d.Intersection((d.Ellipse(rx=0.6, ry=0.4), b)),
        "difference": d.Difference(d.Ellipse(rx=0.7, ry=0.4),
                                   d.Rectangle(-0.2, -0.1, 0.2, 0.1)),
        "composite": d.Difference(d.Union((a, tri)),
                                   d.Intersection((b, c))),
        "sdf": d.SDF(lambda x, y: x * x + y * y - 0.16, name="circle-0.4"),
    }


def _pair(name):
    """(port spec, JAX spec) of one manufactured case."""
    return (manufactured.case_by_name(name).spec,
            jax_manufactured.case_by_name(name).spec)


# -- the DSL: fingerprints, canonical JSON, normalization, parsing -------


@pytest.mark.parametrize("name", sorted(_specs(dsl)))
def test_fingerprint_and_canonical_json_are_jax_s(name):
    mine, theirs = _specs(dsl)[name], _specs(jdsl)[name]
    assert mine.to_json() == theirs.to_json()
    assert mine.fingerprint == theirs.fingerprint
    assert dsl.fingerprint_of(mine) == jdsl.fingerprint_of(theirs)
    if name != "sdf":
        # Either package parses the other's JSON to the same fingerprint.
        assert dsl.parse_geometry(theirs.to_json()).fingerprint == \
            theirs.fingerprint
        assert jdsl.parse_geometry(mine.to_json()).fingerprint == \
            mine.fingerprint
        assert interop.spec_from_reference(theirs) == mine.normalize()
        assert jdsl.parse_geometry(
            interop.spec_to_reference(mine)).fingerprint == mine.fingerprint
    else:
        assert interop.spec_from_reference(theirs).fingerprint == \
            mine.fingerprint
        with pytest.raises(ValueError, match="callable"):
            interop.spec_to_reference(mine)


@pytest.mark.parametrize("case", [
    "union_permuted", "union_nested", "union_member_set",
    "polygon_rotated", "polygon_reversed", "rectangle_corners",
    "rectangle_round_trip", "sdf_name", "default"])
def test_normalization_is_jax_s(case):
    """JAX's normalization cases (tests/test_geometry_dsl.py:58-140), in
    both packages: the same equalities and the same fingerprints."""

    def fingerprints(d):
        a = d.Ellipse(cx=0.1, rx=0.5, ry=0.3)
        b = d.Rectangle(-0.5, -0.3, 0.5, 0.3)
        c = d.Ellipse(cx=-0.2, rx=0.4, ry=0.2)
        ring = ((0.0, 0.0), (0.6, 0.0), (0.6, 0.4), (0.0, 0.4))
        specs = {
            "union_permuted": [d.Union((a, b, c)), d.Union((c, a, b))],
            "union_nested": [d.Union((a, b, c)),
                             d.Union((b, d.Union((c, a))))],
            "union_member_set": [d.Union((a, b)), d.Union((a, b, c))],
            "polygon_rotated": [d.Polygon(ring),
                                d.Polygon(ring[2:] + ring[:2])],
            "polygon_reversed": [d.Polygon(ring), d.Polygon(ring[::-1])],
            "rectangle_corners": [b, b.normalize()],
            "rectangle_round_trip": [b, d.parse_geometry(b.to_json())],
            "sdf_name": [d.SDF(lambda x, y: x + y - 0.1, name="s"),
                         d.SDF(lambda x, y: 0.0 * x, name="s")],
            "default": [d.DEFAULT_ELLIPSE, d.Ellipse(0, 0, 1, 0.5)],
        }[case]
        return [s.fingerprint for s in specs]

    mine, theirs = fingerprints(dsl), fingerprints(jdsl)
    assert mine == theirs
    assert (mine[0] == mine[1]) == (case != "union_member_set")


@pytest.mark.parametrize("make", [
    lambda d: d.parse_geometry({"type": "torus"}),
    lambda d: d.parse_geometry({"type": "rect", "x0": 0}),
    lambda d: d.parse_geometry("{not json"),
    lambda d: d.parse_geometry({"type": "ellipse", "Rx": 1.0}),
    lambda d: d.parse_geometry({"rx": 1.0}),
    lambda d: d.parse_geometry({"type": "polygon",
                                "vertices": [[0, 0], [1]]}),
    lambda d: d.parse_geometry({"type": "polygon",
                                "vertices": [[0, 0], [1, 0]]}),
    lambda d: d.parse_geometry({"type": "sdf", "name": "c"}),
    lambda d: d.Ellipse(rx=-1.0),
    lambda d: d.Rectangle(0.5, 0.0, -0.5, 0.3),
    lambda d: d.SDF(lambda x, y: x + y),
    lambda d: d.Union(()),
], ids=["unknown_type", "missing_field", "bad_json", "unknown_field",
        "no_type", "bad_vertex", "two_vertices", "sdf_json",
        "negative_radius", "reversed_rectangle", "sdf_no_name",
        "empty_union"])
def test_parse_errors_are_jax_s(make):
    with pytest.raises(Exception) as theirs:
        make(jdsl)
    with pytest.raises(Exception) as mine:
        make(dsl)
    assert type(mine.value) is type(theirs.value)
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("name", sorted(_specs(dsl)))
def test_contains_and_sdf_take_torch_tensors(name):
    spec = _specs(dsl)[name]
    rng = np.random.default_rng(5)
    x, y = rng.uniform(-1, 1, (7, 1)), rng.uniform(-0.6, 0.6, (1, 9))
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    if name == "sdf":
        # A raw SDF calls its own callable, whatever the namespace.
        tx, ty = x, y
    got_in = spec.contains(tx, ty, torch)
    got_sdf = spec.sdf(tx, ty, torch)
    np.testing.assert_array_equal(np.asarray(got_in),
                                  spec.contains(x, y, np))
    np.testing.assert_allclose(np.asarray(got_sdf), spec.sdf(x, y, np),
                               rtol=0, atol=1e-15)


# -- canvases --------------------------------------------------------------


@pytest.mark.parametrize("grid", [(64, 64), (48, 72)])
@pytest.mark.parametrize("name", CASES)
def test_host_canvases_are_jax_s_bit_for_bit(name, grid):
    mine, theirs = _pair(name)
    got = geo.build_geometry_fields(Problem(*grid), mine)
    want = jgeo.build_geometry_fields(JaxProblem(*grid), theirs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.float64


@pytest.mark.parametrize("workers", [1, 3])
@pytest.mark.parametrize("name", ["polygon", "union", "sdf"])
def test_blocked_sampling_is_the_one_block_result(name, workers,
                                                  monkeypatch):
    """The sampler's blocks (and threads) change no bit: small blocks at
    64x64 give JAX's canvases, which sample every face in one block."""
    monkeypatch.setattr(canvas, "SAMPLE_BLOCK", 701)
    monkeypatch.setattr(canvas, "SAMPLE_WORKERS", workers)
    mine, theirs = _pair(name)
    got = geo.build_geometry_fields(Problem(64, 64), mine)
    want = jgeo.build_geometry_fields(JaxProblem(64, 64), theirs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("grid", [(40, 40), (17, 23)])
def test_default_ellipse_canvases_are_the_reference_fields(grid):
    p = Problem(*grid)
    got = geo.build_geometry_fields(p, geo.DEFAULT_ELLIPSE)
    for g, w in zip(got, host_fields64(p, False)[:3]):
        np.testing.assert_array_equal(g, w)
    for scaled in (False, True):
        for g, w in zip(canvas._fields64(p, geo.DEFAULT_ELLIPSE, scaled),
                        host_fields64(p, scaled)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("dtype,scaled", [("float64", False),
                                          ("float32", True)])
def test_device_canvases_are_the_fp64_arrays_rounded_once(dtype, scaled):
    """geometry_setup is JAX's fp64 arrays cast once (jnp.asarray), and
    counts hits and misses as JAX's cache does."""
    p = Problem(M=24, N=24)
    spec = dsl.Ellipse(cx=0.1, rx=0.6, ry=0.35)
    got = geo.geometry_setup(p, spec, dtype, scaled, **CPU)
    want = jgeo.geometry_setup(JaxProblem(M=24, N=24),
                               jdsl.Ellipse(cx=0.1, rx=0.6, ry=0.35),
                               dtype, scaled)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dtype) and g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # The JAX package's cache sequence (tests/test_geometry_dsl.py:184-199).
    twin = dsl.parse_geometry(spec.to_json())
    for d, mod, q, s, t, other in (
            (geo, dsl, p, spec, twin, CPU),
            (jgeo, jdsl, JaxProblem(M=24, N=24),
             jdsl.Ellipse(cx=0.1, rx=0.6, ry=0.35),
             jdsl.parse_geometry(spec.to_json()), {})):
        d.geometry_setup(q, t, dtype, scaled, **other)
        d.geometry_setup(q.with_(delta=1e-9), s, dtype, scaled, **other)
        d.geometry_setup(q, mod.Ellipse(cx=0.2, rx=0.6, ry=0.35), dtype,
                         scaled, **other)
    for name in ("geom.cache.hits", "geom.cache.misses"):
        assert metrics.get(name) == jax_metrics.get(name), name
    assert metrics.get("geom.cache.misses") == 2


@pytest.mark.parametrize("spec", [
    lambda d: d.Ellipse(cx=0.1, cy=-0.05, rx=0.7, ry=0.4),
    lambda d: d.DEFAULT_ELLIPSE,
    lambda d: d.Rectangle(-0.6, -0.3, 0.5, 0.35)],
    ids=["ellipse", "default", "rectangle"])
def test_traced_fields_are_the_host_canvases(spec):
    """The differentiable torch bake gives the host fp64 canvases, and
    JAX's traced ones, bit for bit."""
    p = Problem(M=40, N=56)
    got = canvas.traced_fields(p, spec(dsl), torch.float64, **CPU)
    host = geo.build_geometry_fields(p, spec(dsl))
    theirs = jax_canvas.traced_fields(JaxProblem(M=40, N=56), spec(jdsl),
                                      jnp.float64)
    for g, h, t in zip(got, host, theirs):
        np.testing.assert_array_equal(g.numpy(), h)
        np.testing.assert_array_equal(g.numpy(), np.asarray(t))


@pytest.mark.parametrize("name", ["polygon", "union", "sdf"])
def test_traced_fields_refuse_sampled_families(name):
    with pytest.raises(ValueError, match="closed-form"):
        canvas.traced_fields(Problem(M=16, N=16), _pair(name)[0], **CPU)


def test_render_and_cut_mask_are_jax_s():
    for name in ("ellipse-offset", "polygon", "difference"):
        mine, theirs = _pair(name)
        assert geo.render_ascii(Problem(M=64, N=48), mine, 40, 12) == \
            jgeo.render_ascii(JaxProblem(M=64, N=48), theirs, 40, 12)


# -- solves ----------------------------------------------------------------


@functools.cache
def _jax_solve(name, M, N, dtype, **kw):
    r = jax_pcg_solve(JaxProblem(M=M, N=N), dtype=dtype,
                      geometry=_pair(name)[1], **kw)
    return int(r.iterations), int(r.flag), np.asarray(r.w)


@pytest.mark.parametrize("name", CASES)
def test_solve_counts_and_iterates_are_jax_s(name):
    spec = _pair(name)[0]
    k64, f64, w64 = _jax_solve(name, 64, 64, "float64")
    got = pcg_solve(Problem(M=64, N=64), geometry=spec, **CPU)
    assert (int(got.iterations), int(got.flag)) == (k64, f64)
    assert f64 == 1
    np.testing.assert_allclose(got.w.numpy(), w64, rtol=0, atol=1e-10)
    k32, f32, _ = _jax_solve(name, 64, 64, "float32")
    got = pcg_solve(Problem(M=64, N=64), dtype="float32", geometry=spec,
                    **CPU)
    assert (int(got.iterations), int(got.flag)) == (k32, f32)
    np.testing.assert_allclose(got.w.numpy(), w64, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_default_spec_is_the_no_geometry_solve_bit_for_bit(dtype):
    p = Problem(M=40, N=40)
    plain = pcg_solve(p, dtype=dtype, **CPU)
    for spec in (geo.DEFAULT_ELLIPSE, {"type": "ellipse"},
                 '{"type": "ellipse", "rx": 1, "ry": 0.5}'):
        got = pcg_solve(p, dtype=dtype, geometry=spec, **CPU)
        assert int(got.iterations) == int(plain.iterations) == 50
        assert torch.equal(got.w, plain.w)


@pytest.mark.parametrize("kw", [
    dict(rhs_gate=1.3), dict(verify_every=7), dict(verify_every=1),
    dict(stream_every=10)], ids=["gate", "verify_7", "verify_1", "stream"])
def test_options_compose_with_geometry(kw):
    """Each option gives JAX's count with a geometry; the probe and the
    stream leave the iterate of the plain geometry solve bit for bit."""
    name = "difference"
    spec = _pair(name)[0]
    p = Problem(M=48, N=48)
    r = jax_pcg_solve(JaxProblem(M=48, N=48), geometry=_pair(name)[1],
                      **kw)
    got = pcg_solve(p, geometry=spec, **kw, **CPU)
    assert (int(got.iterations), int(got.flag)) == (int(r.iterations),
                                                    int(r.flag))
    np.testing.assert_allclose(got.w.numpy(), np.asarray(r.w), rtol=0,
                               atol=1e-10)
    if "rhs_gate" not in kw:
        plain = pcg_solve(p, geometry=spec, **CPU)
        assert torch.equal(got.w, plain.w)


@pytest.mark.parametrize("name,dtype", [
    ("ellipse-offset", "float64"), ("polygon", "float64"),
    ("sdf", "float32")])
def test_chunked_geometry_solve_is_the_one_shot_solve(name, dtype):
    spec = _pair(name)[0]
    p = Problem(M=48, N=48)
    one = pcg_solve(p, dtype=dtype, geometry=spec, **CPU)
    for chunk in (7, 50):
        got = pcg_solve_chunked(p, chunk=chunk, dtype=dtype, geometry=spec,
                                **CPU)
        assert int(got.iterations) == int(one.iterations)
        assert int(got.flag) == int(one.flag) == 1
        assert torch.equal(got.w, one.w)
    mg = pcg_solve(p, dtype=dtype, geometry=spec, preconditioner="mg",
                   **CPU)
    got = pcg_solve_chunked(p, chunk=3, dtype=dtype, geometry=spec,
                            preconditioner="mg", **CPU)
    assert int(got.iterations) == int(mg.iterations)
    assert torch.equal(got.w, mg.w)


# -- the manufactured-solution gate ----------------------------------------


@pytest.mark.parametrize("name", CASES)
def test_manufactured_error_is_jax_s_and_at_the_floor(name):
    got = manufactured.manufactured_error(manufactured.case_by_name(name),
                                          64, 64, **CPU)
    want = jax_manufactured.manufactured_error(
        jax_manufactured.case_by_name(name), 64, 64)
    assert (got["iterations"], got["flag"]) == (want["iterations"],
                                                want["flag"])
    assert got["flag"] == 1
    assert abs(got["rel"] - want["rel"]) <= 1e-10
    assert abs(got["l2"] - want["l2"]) <= 1e-10
    assert got["rel"] <= FLOOR_REL[name]


@pytest.mark.parametrize("name", ["ellipse", "ellipse-offset", "sdf"])
def test_manufactured_error_shrinks_under_refinement(name):
    """JAX's refinement check (tests/test_geometry_dsl.py:266-281) on the
    smooth-boundary families."""
    case = manufactured.case_by_name(name)
    coarse = manufactured.manufactured_error(case, 48, 48, **CPU)
    fine = manufactured.manufactured_error(case, 96, 96, **CPU)
    assert fine["rel"] < 0.8 * coarse["rel"], (coarse, fine)


@pytest.mark.parametrize("name", ["ellipse-offset", "union"])
def test_manufactured_error_under_mg_is_jax_s(name):
    got = manufactured.manufactured_error(manufactured.case_by_name(name),
                                          64, 64, preconditioner="mg",
                                          **CPU)
    want = jax_manufactured.manufactured_error(
        jax_manufactured.case_by_name(name), 64, 64, preconditioner="mg")
    assert got["iterations"] == want["iterations"]
    assert abs(got["rel"] - want["rel"]) <= 1e-10
    assert got["rel"] <= FLOOR_REL[name]


def test_manufactured_error_refuses_krylov():
    """The Krylov gate is ported; as in the JAX package it runs the jacobi
    body only, and refuses MG in its words."""
    from poisson_tpu_torch.krylov import KrylovPolicy

    with pytest.raises(ValueError, match="jacobi"):
        manufactured.manufactured_error(manufactured.cases()[0], 16, 16,
                                        krylov=KrylovPolicy(mode="block"),
                                        preconditioner="mg", **CPU)


# -- multigrid with a geometry ----------------------------------------------


def test_mg_hierarchy_with_a_geometry_is_jax_s():
    name = "ellipse-offset"
    mine, theirs = _pair(name)
    p, jp = Problem(M=64, N=96), JaxProblem(M=64, N=96)
    got = mg_hierarchy.device_hierarchy(p, "float64", True, geometry=mine,
                                        **CPU)
    want = jax_hierarchy.device_hierarchy(jp, "float64", True,
                                          geometry=theirs)
    assert len(got.levels) == len(want.levels)
    for mine_level, their_level in zip(got.levels, want.levels):
        for x, y in zip(mine_level, their_level):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    np.testing.assert_array_equal(got.coarse_inv.numpy(),
                                  np.asarray(want.coarse_inv))
    np.testing.assert_array_equal(got.scinv.numpy(), np.asarray(want.scinv))
    # Keyed on the fingerprint: an equal spec hits, the ellipse misses.
    mg_hierarchy.device_hierarchy(p, "float64", True,
                                  geometry=json.loads(mine.to_json()), **CPU)
    hits = metrics.get("mg.hierarchy_cache.hits")
    mg_hierarchy.device_hierarchy(p, "float64", True, **CPU)
    assert metrics.get("mg.hierarchy_cache.hits") == hits


@pytest.mark.parametrize("name", ["ellipse-offset", "rectangle", "sdf"])
def test_mg_geometry_solve_counts_are_jax_s(name):
    k, f, w = _jax_solve(name, 64, 64, "float64", preconditioner="mg")
    got = pcg_solve(Problem(M=64, N=64), geometry=_pair(name)[0],
                    preconditioner="mg", **CPU)
    assert (int(got.iterations), int(got.flag)) == (k, f) and f == 1
    np.testing.assert_allclose(got.w.numpy(), w, rtol=0, atol=1e-10)


# -- the mixed batch ---------------------------------------------------------


def _mixed(d):
    return [None, d.Ellipse(cx=0.1, rx=0.7, ry=0.4),
            d.Rectangle(-0.6, -0.3, 0.5, 0.3),
            d.SDF(lambda x, y: x * x + y * y - 0.2, name="circ-test"),
            d.Polygon(((-0.5, -0.3), (0.6, -0.2), (0.1, 0.4)))]


@pytest.mark.parametrize("dtype,bucket", [("float64", None),
                                          ("float32", 8)])
def test_mixed_batch_members_are_their_solo_solves(dtype, bucket):
    """JAX's co-batching test (tests/test_geometry_dsl.py:284-298) with the
    port's solves: every member bit for bit its solo solve; counts and
    flags JAX's batch's."""
    p = Problem(M=40, N=40)
    gates = [1.0, 1.1, 0.9, 1.3, 0.7]
    res = batched.solve_batched(p, rhs_gates=gates, geometries=_mixed(dsl),
                                dtype=dtype, bucket=bucket, **CPU)
    want = jax_batched.solve_batched(JaxProblem(M=40, N=40),
                                     rhs_gates=gates,
                                     geometries=_mixed(jdsl), dtype=dtype)
    assert res.iterations.tolist() == np.asarray(want.iterations).tolist()
    assert res.flag.tolist() == np.asarray(want.flag).tolist()
    for i, (g, gate) in enumerate(zip(_mixed(dsl), gates)):
        solo = pcg_solve(p, dtype=dtype, geometry=g, rhs_gate=gate, **CPU)
        assert int(res.iterations[i]) == int(solo.iterations), i
        assert torch.equal(res.w[i], solo.w), i


@pytest.mark.parametrize("form", ["problems", "rhs_stack"])
def test_other_batch_forms_take_geometries(form):
    p = Problem(M=32, N=32)
    specs = _mixed(dsl)[:3]
    if form == "problems":
        members = [p.with_(f_val=v) for v in (1.0, 2.0, 0.5)]
        res = batched.solve_batched(members, geometries=specs,
                                    dtype="float32", **CPU)
        solos = [pcg_solve(m, dtype="float32", geometry=g, **CPU)
                 for m, g in zip(members, specs)]
    else:
        stack = np.stack([geo.build_geometry_fields(p, g)[2] if g else
                          host_fields64(p, False)[2] for g in specs]) * 1.5
        res = batched.solve_batched(p, rhs_stack=stack, geometries=specs,
                                    dtype="float64", **CPU)
        solos = [pcg_solve(p, geometry=g, rhs_gate=1.5, **CPU)
                 for g in specs]
    for i, solo in enumerate(solos):
        assert int(res.iterations[i]) == int(solo.iterations)
        torch.testing.assert_close(res.w[i], solo.w, rtol=0, atol=0)


def test_bucket_counters_follow_jax_s():
    """A second family on the same grid is a canvas miss and a bucket hit,
    in both packages (tests/test_geometry_dsl.py:301-324)."""
    for d, solve, q, kw in (
            (dsl, batched.solve_batched, Problem(M=24, N=24), CPU),
            (jdsl, jax_batched.solve_batched, JaxProblem(M=24, N=24), {})):
        fam_a = d.Ellipse(cx=0.0, rx=0.8, ry=0.45)
        fam_b = d.Rectangle(-0.5, -0.4, 0.7, 0.35)
        solve(q, rhs_gates=[1.0] * 3, geometries=[fam_a] * 3, **kw)
        solve(q, rhs_gates=[1.0] * 3, geometries=[fam_b] * 3, **kw)
        solve(q, rhs_gates=[1.0] * 3, geometries=[None] * 3, **kw)
        solve(q, rhs_gates=[1.0] * 3, **kw)
    for name in ("batched.bucket_cache.hits", "batched.bucket_cache.misses",
                 "geom.cache.hits", "geom.cache.misses"):
        assert metrics.get(name) == jax_metrics.get(name), name
    assert metrics.get("geom.cache.misses") == 2


def test_all_none_geometries_are_the_classic_batch():
    p = Problem(M=24, N=24)
    classic = batched.solve_batched(p, rhs_gates=[1.0, 1.3], **CPU)
    got = batched.solve_batched(p, rhs_gates=[1.0, 1.3],
                                geometries=[None, None], **CPU)
    assert torch.equal(got.w, classic.w)
    assert got.iterations.tolist() == classic.iterations.tolist()


@pytest.mark.parametrize("kwargs", [
    dict(geometries=[{"type": "ellipse", "rx": 0.6, "ry": 0.4}]),
    dict(geometries=[{"type": "rect", "x0": -0.5, "y0": -0.3,
                      "x1": 0.5, "y1": 0.3}] * 2, mesh=True),
    dict(geometries=[{"type": "ellipse", "rx": 0.6, "ry": 0.4}] * 2,
         preconditioner="mg"),
], ids=["length", "mesh", "mg"])
def test_batch_refusals_are_jax_s(kwargs):
    """What the JAX package refuses with geometries, in its words."""
    mine = dict(kwargs)
    theirs = dict(kwargs)
    if mine.pop("mesh", None):
        mine["mesh"] = make_solver_mesh(["cpu"] * 4, grid=(2, 2))
        import jax

        from poisson_tpu.parallel.mesh import make_solver_mesh as jax_mesh

        theirs["mesh"] = jax_mesh(jax.devices()[:4], grid=(2, 2))
    else:
        mine.update(CPU)
    with pytest.raises(ValueError) as want:
        jax_batched.solve_batched(JaxProblem(M=40, N=40),
                                  rhs_gates=(1.0, 1.0), **theirs)
    with pytest.raises(ValueError) as got:
        batched.solve_batched(Problem(M=40, N=40), rhs_gates=(1.0, 1.0),
                              **mine)
    assert str(got.value) == str(want.value)


# -- multi-geometry lanes ---------------------------------------------------


def _drain(lanes):
    for _ in range(60):
        lanes.step()
        if all(v["done"] or v["member_id"] is None
               for v in lanes.lane_view()):
            return
    raise AssertionError("lanes did not drain")


@pytest.mark.parametrize("dtype,verify_every", [
    ("float64", 0), ("float32", 0), ("float32", 5)])
def test_multi_geometry_lanes_splice_and_retire_bit_for_bit(dtype,
                                                            verify_every):
    """JAX's lane test (tests/test_geometry_dsl.py:347-378) with the port's
    solves: each retired lane is its solo solve bit for bit, including a
    new family spliced into a freed lane in place."""
    p = Problem(M=32, N=32)
    lanes = LaneBatch(p, 3, chunk=10, multi_geometry=True, dtype=dtype,
                      verify_every=verify_every, **CPU)
    g_a = dsl.Ellipse(cx=0.1, rx=0.7, ry=0.4)
    g_s = dsl.SDF(lambda x, y: x * x + y * y - 0.2, name="circ-test")
    lanes.splice("default", 1.0)
    lanes.splice("ell-a", 1.2, geometry=g_a)
    lanes.splice("sdf", 0.8, geometry=g_s)
    _drain(lanes)
    results = {m: lanes.retire(i) for i, m in enumerate(list(lanes.origin))}
    g_b = {"type": "rect", "x0": -0.5, "y0": -0.3, "x1": 0.6, "y1": 0.35}
    lanes.splice("rect-b", 1.0, geometry=g_b, lane=1)
    lanes.splice("default-2", 0.5)
    _drain(lanes)
    for lane in lanes.active_lanes():
        res = lanes.retire(lane)
        results[res.member_id] = res
    solos = {"default": (None, 1.0), "ell-a": (g_a, 1.2),
             "sdf": (g_s, 0.8), "rect-b": (g_b, 1.0),
             "default-2": (None, 0.5)}
    for member, (g, gate) in solos.items():
        solo = pcg_solve(p, dtype=dtype, geometry=g, rhs_gate=gate, **CPU)
        assert results[member].iterations == int(solo.iterations), member
        assert results[member].flag == int(solo.flag) == 1
        assert torch.equal(results[member].w, solo.w), member
    assert results["rect-b"].lane == 1


def test_lane_refusals_are_jax_s():
    p = Problem(M=16, N=16)
    with pytest.raises(ValueError) as want:
        from poisson_tpu.solvers.lanes import LaneBatch as JaxLanes

        JaxLanes(JaxProblem(M=16, N=16), 1, chunk=5).splice(
            "m", 1.0, geometry=jdsl.DEFAULT_ELLIPSE)
    with pytest.raises(ValueError) as got:
        LaneBatch(p, 1, chunk=5, **CPU).splice("m", 1.0,
                                                geometry=dsl.DEFAULT_ELLIPSE)
    assert str(got.value) == str(want.value)
    assert "multi_geometry" in str(got.value)


# -- seeded random polygons (tests/test_geometry_dsl.py:500-555) ----------


def _random_polygons(d, n=5):
    rng = np.random.RandomState(20260804)
    out = []
    for _ in range(n):
        k = int(rng.randint(3, 8))
        cx = float(rng.uniform(-0.25, 0.25))
        cy = float(rng.uniform(-0.12, 0.12))
        ang = np.sort(rng.uniform(0.0, 2 * np.pi, size=k))
        rad = rng.uniform(0.18, 0.42, size=k)
        out.append(d.Polygon(tuple(
            (float(cx + r * np.cos(a)), float(cy + 0.55 * r * np.sin(a)))
            for a, r in zip(ang, rad))))
    return out


@pytest.mark.parametrize("index", range(5))
def test_random_polygon_canvases_and_solve_are_jax_s(index):
    mine = _random_polygons(dsl)[index]
    theirs = _random_polygons(jdsl)[index]
    assert mine.fingerprint == theirs.fingerprint
    p, jp = Problem(M=48, N=48), JaxProblem(M=48, N=48)
    got = geo.build_geometry_fields(p, mine)
    for g, w in zip(got, jgeo.build_geometry_fields(jp, theirs)):
        np.testing.assert_array_equal(g, np.asarray(w))
    a, b, _ = got
    assert min(a.min(), b.min()) >= 1.0 - 1e-12
    assert max(a.max(), b.max()) <= 1.0 / p.eps + 1e-9
    res = pcg_solve(p, geometry=mine, **CPU)
    want = jax_pcg_solve(jp, geometry=theirs)
    assert (int(res.iterations), int(res.flag)) == (int(want.iterations),
                                                    int(want.flag))
    assert int(res.flag) == 1
    np.testing.assert_allclose(res.w.numpy(), np.asarray(want.w), rtol=0,
                               atol=1e-10)


# -- the CLI -----------------------------------------------------------------

RECT = '{"type": "rect", "x0": -0.5, "y0": -0.3, "x1": 0.5, "y1": 0.3}'
ELL = '{"type": "ellipse", "rx": 0.7, "ry": 0.4}'


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("argv", [
    [ELL, "--json"], [RECT, "--json", "--M", "40", "--N", "56"],
    ['{"type": "difference", "shape": ' + ELL + ', "hole": ' + RECT + '}',
     "--json", "--M", "32"]], ids=["ellipse", "rect_40x56", "difference"])
def test_geometry_subcommand_json_is_jax_s(argv, capsys):
    assert jax_cli_main(["geometry", *argv]) == 0
    want = _last_json(capsys)
    assert cli_main(["geometry", *argv]) == 0
    assert _last_json(capsys) == want


def test_geometry_subcommand_renders_and_reads_files(tmp_path, capsys):
    path = tmp_path / "spec.json"
    path.write_text(ELL)
    assert cli_main(["geometry", f"@{path}", "--height", "8"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("fingerprint: g") and "#" in out
    assert jax_cli_main(["geometry", f"@{path}", "--height", "8"]) == 0
    assert capsys.readouterr().out == out


@pytest.mark.parametrize("extra", [[], ["--dtype", "float64"],
                                   ["--preconditioner", "mg"]],
                         ids=["fp32", "fp64", "mg"])
def test_cli_geometry_solve_counts_are_jax_s(extra, capsys):
    argv = ["40", "40", "--geometry", RECT, "--json", *extra]
    assert jax_cli_main(argv) == 0
    want = _last_json(capsys)
    assert cli_main([*argv, "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert got["backend"] == "torch"
    assert got["iterations"] == want["iterations"]
    assert got["stopped"] is None and want["stopped"] is None
    assert got["l2_error"] is None and want["l2_error"] is None


def test_cli_solve_batched_geometry_is_jax_s(capsys):
    argv = ["solve-batched", "40", "40", "--batch", "5", "--vary-rhs",
            "--json", "--compare-sequential", "--geometry", ELL,
            "--geometry", RECT]
    assert jax_cli_main(argv) == 0
    want = _last_json(capsys)
    assert cli_main([*argv, "--device", "cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want)
    for key in ("iterations", "max_iterations", "flags", "geometry_mix",
                "geometries", "iterations_match_sequential"):
        assert got[key] == want[key], key
    assert got["iterations_match_sequential"] is True


@pytest.mark.parametrize("argv,message", [
    (["--backend", "fused"], "drives the single-device torch solve"),
    (["--backend", "sharded", "--mesh", "2x2"],
     "drives the single-device torch solve"),
    (["--checkpoint", "x.npz"], "ellipse-only"),
    (["--resilient"], "ellipse-only"),
    (["--mesh", "2x2"], "drop --mesh"),
    (["--geometry", '{"type": "torus"}'], "unknown geometry type"),
], ids=["fused", "sharded", "checkpoint", "resilient", "mesh", "bad_spec"])
def test_cli_refuses_what_the_jax_cli_refuses(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli_main(["40", "40", "--device", "cpu", "--geometry", RECT, *argv])


@pytest.mark.parametrize("argv,message", [
    (["--preconditioner", "mg"], "does not co-batch --geometry"),
    (["--mesh", "2x2"], "drop --mesh"),
], ids=["mg", "mesh"])
def test_cli_batched_refusals(argv, message):
    with pytest.raises(SystemExit, match=message):
        cli_main(["solve-batched", "40", "40", "--batch", "2", "--device",
                  "cpu", "--geometry", RECT, *argv])
