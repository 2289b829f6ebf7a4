"""Request-level parity with the JAX package (on the CPU; -m serve).

Seeded request streams go through the JAX package's ``SolveService`` and
the port's, each on its own package's ``VirtualClock``; the outcomes must
be equal field by field in completion order. Covered: drain and continuous
scheduling, deadlines expiring mid-chunk, poison requeue, a tenant mix,
the forecaster, and fp64 and fp32.

In fp64 the final update norms agree to 1e-10 relative. In fp32 both
packages' norms lie under δ, and their agreement is not asserted: the JAX
package's fp32 iterates are the less accurate side (its XLA:CPU
reductions round differently from the port's), so only each side's
convergence is a property of the service.
"""

import importlib

import jax
import numpy as np
import pytest

pytestmark = pytest.mark.serve

FIELDS = ("request_id", "kind", "flag", "converged", "partial",
          "iterations", "restarts", "attempts", "latency_seconds",
          "error_type", "shed_reason", "decomposition")


def _stream(seed: int, n: int, *, deadline_every: int = 0,
            tenants=()):
    """n requests from a numpy seed: gates in [1, 2), every
    ``deadline_every``-th request chunked under a deadline, tenants
    round-robin."""
    rng = np.random.default_rng(seed)
    gates = 1.0 + rng.random(n)
    out = []
    for i in range(n):
        req = {"request_id": i, "rhs_gate": float(gates[i])}
        if deadline_every and i % deadline_every == 0:
            req.update(deadline_seconds=0.25, chunk=10)
        if tenants:
            req["tenant"] = tenants[i % len(tenants)]
        out.append(req)
    return out


def _run(pkg: str, stream, *, dtype=None, scheduling="drain",
         poison=(), tenancy=None, forecast=False, chunk_seconds=0.0,
         seed=0):
    """Drive ``stream`` through ``pkg``'s service; its outcomes in
    completion order."""
    serve = importlib.import_module(f"{pkg}.serve")
    chaos = importlib.import_module(f"{pkg}.testing.chaos")
    faults = importlib.import_module(f"{pkg}.testing.faults")
    Problem = importlib.import_module(f"{pkg}.config").Problem
    metrics = importlib.import_module(f"{pkg}.obs.metrics")
    batched = importlib.import_module(f"{pkg}.solvers.batched")
    metrics.reset()
    batched.reset_bucket_cache()
    vc = chaos.VirtualClock()

    def tick(state, chunks_done):
        vc.advance(chunk_seconds)

    policy = serve.ServicePolicy(
        capacity=64, max_batch=4, scheduling=scheduling, refill_chunk=10,
        degradation=serve.DegradationPolicy(
            shrink_padding_at=9.0, cap_iterations_at=9.0,
            downshift_precision_at=9.0),
        retry=serve.RetryPolicy(max_attempts=3, backoff_base=0.02,
                                backoff_cap=0.1),
        tenancy=(serve.TenancyPolicy(**tenancy) if tenancy else None),
        forecast=(serve.ForecastPolicy() if forecast else None))
    kw = {"device": "cpu"} if pkg == "poisson_tpu_torch" else {}
    svc = serve.SolveService(
        policy, clock=vc, sleep=vc.sleep, seed=seed,
        dispatch_fault=(faults.poison_batch_fault(set(poison))
                        if poison else None), **kw)
    p = Problem(M=40, N=40)
    for req in stream:
        on_chunk = tick if req.get("chunk") and chunk_seconds else None
        svc.submit(serve.SolveRequest(problem=p, dtype=dtype,
                                      on_chunk=on_chunk, **req))
    svc.drain()
    stats = svc.stats()
    assert stats["lost"] == 0
    return svc.outcomes()


def _compare(stream, dtype, **kw):
    assert jax.config.jax_enable_x64   # the JAX suite's environment
    ref = _run("poisson_tpu", stream, dtype=dtype, **kw)
    got = _run("poisson_tpu_torch", stream, dtype=dtype, **kw)
    assert len(got) == len(ref) == len(stream)
    for r, g in zip(ref, got):
        for field in FIELDS:
            assert getattr(g, field) == getattr(r, field), \
                (r.request_id, field)
        if r.diff is None:
            assert g.diff is None
        elif dtype == "float32":
            if r.converged:
                assert r.diff < 1e-6 and g.diff < 1e-6
        else:
            assert g.diff == pytest.approx(r.diff, rel=1e-10)
    return got


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("scheduling", ["drain", "continuous"])
def test_streams_match_jax(scheduling, dtype):
    outs = _compare(_stream(1, 11), dtype, scheduling=scheduling)
    assert all(o.converged for o in outs)


@pytest.mark.parametrize("scheduling", ["drain", "continuous"])
def test_deadlines_mid_chunk_match_jax(scheduling):
    outs = _compare(_stream(2, 8, deadline_every=3), None,
                    scheduling=scheduling, chunk_seconds=0.1)
    partial = [o for o in outs if o.partial]
    assert partial and all(o.flag == "deadline" for o in partial)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_poison_requeue_matches_jax(dtype):
    outs = _compare(_stream(3, 7), dtype, poison=(2,))
    kinds = {o.request_id: (o.kind, o.error_type) for o in outs}
    assert kinds[2] == ("error", "transient")
    assert all(o.converged for o in outs if o.request_id != 2)


@pytest.mark.parametrize("scheduling", ["drain", "continuous"])
def test_tenant_mix_matches_jax(scheduling):
    tenancy = {"shares": (("a", 1.0), ("b", 3.0)), "quota_rate": 0.5,
               "quota_burst": 2.0}
    outs = _compare(_stream(4, 12, tenants=("a", "b", "b")), None,
                    scheduling=scheduling, tenancy=tenancy)
    assert any(o.shed_reason == "quota_exceeded" for o in outs)


def test_forecaster_on_matches_jax():
    from poisson_tpu_torch.obs import metrics

    _compare(_stream(5, 9, deadline_every=2), None, forecast=True,
             chunk_seconds=0.05)
    assert metrics.get("obs.forecast.predictions") > 0
