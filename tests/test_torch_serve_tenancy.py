"""The port's tenant isolation and overload fairness (counterpart of
``tests/test_tenancy.py``, on the CPU; -m serve).

Under test: the ledger arithmetic (``serve.tenancy`` — token-bucket quota
refill under a :class:`VirtualClock`, weighted round-robin deficit
counters, retry budgets), the service seam (over-quota submits shed typed
``quota_exceeded`` at zero compute, the dispatch-head mix converges to the
share vector under both engines, budget exhaustion becomes a typed
error), durability (tenant identity and spent budgets survive a journal
replay), the tenancy-off cohort strings and counters, per-tenant dispatch
accounting, and the two tenant chaos scenarios.
"""

import os

import pytest

from poisson_tpu_torch.config import Problem
from poisson_tpu_torch.obs import metrics
from poisson_tpu_torch.serve import (
    BreakerPolicy,
    DegradationPolicy,
    OUTCOME_ERROR,
    OUTCOME_RESULT,
    OUTCOME_SHED,
    RetryPolicy,
    SHED_QUOTA_EXCEEDED,
    ServicePolicy,
    SolveJournal,
    SolveRequest,
    SolveService,
    TenancyPolicy,
    TransientDispatchError,
    parse_tenant_spec,
)
from poisson_tpu_torch.serve.tenancy import DEFAULT_TENANT, TenantLedger
from poisson_tpu_torch.testing.chaos import VirtualClock

pytestmark = [pytest.mark.serve, pytest.mark.tenancy]

P40 = Problem(M=40, N=40)


@pytest.fixture(autouse=True)
def _fresh_registry():
    metrics.reset()
    yield
    metrics.reset()


def _quiet_degradation():
    return DegradationPolicy(shrink_padding_at=9.0, cap_iterations_at=9.0,
                             downshift_precision_at=9.0)


def _service(policy, **kw):
    vc = VirtualClock()
    svc = SolveService(policy, clock=vc, sleep=vc.sleep, **kw, device="cpu")
    return svc, vc


# -- the ledger arithmetic -----------------------------------------------


def test_quota_bucket_refill_and_burst_cap():
    vc = VirtualClock()
    ledger = TenantLedger(
        TenancyPolicy(shares=(("b", 2.0),), quota_rate=1.0,
                      quota_burst=2.0),
        clock=vc)
    # buckets start full: burst × share tokens
    assert ledger.state("b").tokens == 4.0
    for _ in range(4):
        assert ledger.admit("b")
    assert not ledger.admit("b")           # dry
    # refill at rate × share: 1 s buys 2 tokens for share-2 tenant b
    vc.advance(1.0)
    assert ledger.admit("b") and ledger.admit("b")
    assert not ledger.admit("b")
    # refill caps at burst × share — idling forever buys one burst, not
    # an unbounded backlog of tokens
    vc.advance(1e6)
    ledger.admit("b")
    assert ledger.state("b").tokens == pytest.approx(3.0)
    # unnamed tenants run at default_share; quota_rate=0 would disable
    # the quota entirely (covered by the default-off service pin)
    assert ledger.share_of("anon") == 1.0
    assert ledger.resolve(None) == DEFAULT_TENANT


def test_dwrr_pick_converges_to_share_vector():
    vc = VirtualClock()
    ledger = TenantLedger(TenancyPolicy(shares=(("a", 1.0), ("b", 3.0))),
                          clock=vc)
    picks = [ledger.pick(("a", "b")) for _ in range(400)]
    assert picks.count("b") == 300 and picks.count("a") == 100
    # work-conserving: a lone backlogged tenant always wins
    assert ledger.pick(("a",)) == "a"


def test_retry_budget_spend_refund_and_crash_recharge():
    vc = VirtualClock()
    ledger = TenantLedger(TenancyPolicy(retry_budget=2), clock=vc)
    assert ledger.spend_retry("p") and ledger.spend_retry("p")
    assert not ledger.spend_retry("p")     # exhausted
    # only completions replenish, capped at the budget
    ledger.credit_success("p")
    assert ledger.spend_retry("p")
    for _ in range(9):
        ledger.credit_success("p")
    assert ledger.state("p").retry_tokens == 2.0
    # journal replay re-charges journaled attempts, floored at zero
    ledger.charge_attempts("p", 99)
    assert ledger.state("p").retry_tokens == 0.0
    assert not ledger.spend_retry("p")


def test_ledger_rejects_bad_policy():
    vc = VirtualClock()
    for bad in (TenancyPolicy(default_share=0.0),
                TenancyPolicy(quota_rate=-1.0),
                TenancyPolicy(quota_burst=0.0),
                TenancyPolicy(retry_budget=-1),
                TenancyPolicy(shares=(("a", 0.0),))):
        with pytest.raises(ValueError):
            TenantLedger(bad, clock=vc)


# -- CLI spec parsing ----------------------------------------------------


def test_parse_tenant_spec_accepts_weights_and_bare_names():
    assert parse_tenant_spec("a:1,b:4") == (("a", 1.0), ("b", 4.0))
    # a bare name is share 1.0; whitespace is cosmetic
    assert parse_tenant_spec(" a , b:2.5 ") == (("a", 1.0), ("b", 2.5))


def test_parse_tenant_spec_loud_on_garbage():
    for spec, fragment in (("", "empty"),
                           ("a:1,,b:2", "empty tenant entry"),
                           (":3", "name missing"),
                           ("a:x", "non-numeric"),
                           ("a:0", "non-positive"),
                           ("a:-1", "non-positive"),
                           ("a:1,a:2", "duplicate")):
        with pytest.raises(ValueError, match=fragment):
            parse_tenant_spec(spec)


# -- default-off byte-compat --------------------------------------------


def test_tenancy_off_by_default_byte_compat():
    """ServicePolicy().tenancy is None, the historical cohort string is
    unchanged, stats() has no tenants block, no serve.tenant.* counter
    ticks, and a tenant= tag on the request is inert metadata — the
    default path is indistinguishable from a tenancy-less service."""
    assert ServicePolicy().tenancy is None
    svc = SolveService(device="cpu")
    svc.submit(SolveRequest(request_id=0, problem=P40, tenant="loud"))
    assert svc._cohort(svc._queue[0].request) == "40x40:auto:torch"
    outs = svc.drain()
    assert all(o.converged for o in outs)
    st = svc.stats()
    assert "tenants" not in st and st["lost"] == 0
    assert metrics.get("serve.tenant.promotions") == 0
    assert metrics.get("serve.tenant.admitted.loud") == 0
    assert metrics.get("serve.tenant.quota_sheds") == 0


# -- the service seam: quota sheds ---------------------------------------


def test_over_quota_submit_sheds_typed_at_zero_compute():
    svc, _ = _service(ServicePolicy(
        capacity=16,
        tenancy=TenancyPolicy(quota_rate=1e-3, quota_burst=1.0)))
    assert svc.submit(SolveRequest(request_id="h0", problem=P40,
                                   tenant="hog")) is None
    shed = svc.submit(SolveRequest(request_id="h1", problem=P40,
                                   tenant="hog"))
    assert shed is not None and shed.kind == OUTCOME_SHED
    assert shed.shed_reason == SHED_QUOTA_EXCEEDED
    assert "hog" in shed.message and "quota" in shed.message
    # the shed burned zero compute: no dispatch, no solve seconds
    dec = shed.decomposition or {}
    assert dec.get("compute_s", 1) == 0
    assert dec.get("dispatches", 1) == 0
    # another tenant's bucket is untouched by hog's exhaustion
    assert svc.submit(SolveRequest(request_id="q0", problem=P40,
                                   tenant="quiet")) is None
    svc.drain()
    st = svc.stats()
    # ledger invariant closes through the same _shed path as queue_full
    assert st["admitted"] == 3 and st["shed"] == 1 and st["lost"] == 0
    assert metrics.get("serve.tenant.quota_sheds") == 1
    assert metrics.get(f"serve.shed.{SHED_QUOTA_EXCEEDED}") == 1
    assert metrics.get("serve.tenant.admitted.hog") == 2
    assert metrics.get("serve.tenant.shed.hog") == 1
    assert metrics.get("serve.tenant.completed.quiet") == 1


# -- the service seam: weighted-fair draining ----------------------------


def _dispatch_order(policy):
    """Drain 4 a-requests submitted ahead of 4 b-requests and return
    the tenant of each dispatch head in order."""
    order = []

    def spy(requests, attempts):
        order.extend(r.tenant for r in requests)

    svc, _ = _service(policy, dispatch_fault=spy)
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"a{i}", problem=P40,
                                tenant="a"))
    for i in range(4):
        svc.submit(SolveRequest(request_id=f"b{i}", problem=P40,
                                tenant="b"))
    outs = svc.drain()
    assert len(outs) == 8 and all(o.kind == OUTCOME_RESULT for o in outs)
    assert svc.stats()["lost"] == 0
    return order


def test_dwrr_reorders_dispatch_heads_by_share_drain_engine():
    order = _dispatch_order(ServicePolicy(
        capacity=16, max_batch=1,
        tenancy=TenancyPolicy(shares=(("a", 1.0), ("b", 3.0)))))
    # every a arrived before every b, yet the first scheduling window
    # serves b 3:1 — shares reorder across tenants (FIFO within one)
    assert order[:4].count("b") == 3
    assert [r for r in order if r == "a"] == ["a"] * 4
    assert metrics.get("serve.tenant.promotions") >= 1
    assert metrics.get("serve.tenant.dispatches.b") == 4


def test_dwrr_reorders_dispatch_heads_continuous_engine():
    from poisson_tpu_torch.serve import SCHED_CONTINUOUS

    order = _dispatch_order(ServicePolicy(
        capacity=16, max_batch=1, scheduling=SCHED_CONTINUOUS,
        tenancy=TenancyPolicy(shares=(("a", 1.0), ("b", 3.0)))))
    # same fairness contract under the continuous-refill engine: the
    # late-arriving heavy tenant overtakes the FIFO backlog
    assert order[:4].count("b") >= 2
    assert sorted(set(order)) == ["a", "b"]
    assert metrics.get("serve.tenant.promotions") >= 1


# -- the service seam: retry budgets -------------------------------------


def test_retry_budget_exhaustion_converts_requeue_to_typed_error():
    budget = 2

    def poison(requests, attempts):
        if any(str(r.request_id).startswith("p") for r in requests):
            raise TransientDispatchError("injected outage")

    svc, _ = _service(
        ServicePolicy(
            capacity=16, max_batch=1,
            retry=RetryPolicy(max_attempts=50, backoff_base=0.01,
                              backoff_cap=0.05),
            # the breaker must not shed the poisoned cohort first — this
            # test isolates the budget rail
            breaker=BreakerPolicy(failure_threshold=10**6),
            degradation=_quiet_degradation(),
            tenancy=TenancyPolicy(retry_budget=budget)),
        dispatch_fault=poison)
    svc.submit(SolveRequest(request_id="p0", problem=P40, tenant="poison"))
    svc.submit(SolveRequest(request_id="s0", problem=P40, tenant="steady"))
    outs = {o.request_id: o for o in svc.drain()}
    # amplification cap: 1 admission + budget requeues, then typed error
    assert metrics.get("serve.tenant.dispatches.poison") == 1 + budget
    bad = outs["p0"]
    assert bad.kind == OUTCOME_ERROR
    assert "retry budget exhausted" in bad.message
    assert metrics.get("serve.tenant.retry_exhausted") == 1
    assert metrics.get("serve.tenant.retries.poison") == budget
    # the steady tenant is untouched: converged, budget never spent
    assert outs["s0"].kind == OUTCOME_RESULT and outs["s0"].converged
    assert metrics.get("serve.tenant.retries.steady") == 0
    assert svc.stats()["lost"] == 0


# -- durability: the journal replay boundary -----------------------------


def test_tenant_and_spent_budget_survive_journal_recover(tmp_path):
    budget = 3
    jpath = str(tmp_path / "serve.journal")
    tenancy = TenancyPolicy(retry_budget=budget)
    vc0 = VirtualClock()

    def poison(requests, attempts):
        vc0.advance(1e-3)
        if any(str(r.request_id).startswith("p") for r in requests):
            raise TransientDispatchError("injected outage")

    svc = SolveService(
        ServicePolicy(capacity=16, max_batch=1,
                      retry=RetryPolicy(max_attempts=50,
                                        backoff_base=0.01,
                                        backoff_cap=0.05),
                      breaker=BreakerPolicy(failure_threshold=10**6),
                      degradation=_quiet_degradation(),
                      tenancy=tenancy),
        clock=vc0, sleep=vc0.sleep,
        journal=SolveJournal(jpath, clock=vc0),
        dispatch_fault=poison, device="cpu")
    svc.submit(SolveRequest(request_id="p0", problem=P40, tenant="poison"))
    svc.submit(SolveRequest(request_id="s0", problem=P40, tenant="steady"))
    # pump mid-storm (few enough rounds that the budget is spent but
    # not yet exhausted), then "crash" (abandon without draining)
    for _ in range(3):
        svc.pump()
    attempts = metrics.get("serve.tenant.dispatches.poison")
    assert attempts >= 2
    assert os.path.exists(jpath)

    metrics.reset()
    vc = VirtualClock()
    revived = SolveService.recover(
        SolveJournal(jpath, clock=vc),
        ServicePolicy(capacity=16, max_batch=1,
                      retry=RetryPolicy(max_attempts=50,
                                        backoff_base=0.01,
                                        backoff_cap=0.05),
                      breaker=BreakerPolicy(failure_threshold=10**6),
                      degradation=_quiet_degradation(),
                      tenancy=tenancy),
        clock=vc, sleep=vc.sleep, device="cpu")
    # tenant identity rode the journal: the recovered entry knows who
    # it belongs to (s0 completed before the crash — its outcome was
    # replayed, not re-enqueued), and the poisoned tenant's journaled
    # attempts beyond the first were re-charged — crashing mid-storm
    # does not reset the amplification cap
    pend = {str(e.request.request_id): e.request.tenant
            for e in list(revived._queue) + revived._delayed}
    assert pend == {"p0": "poison"}
    assert revived._tenancy.state("poison").retry_tokens \
        == max(0.0, budget - (attempts - 1))
    # the fault died with the old process: the revived service drains
    # clean and attributes the completion to its tenant
    outs = revived.drain()
    assert [str(o.request_id) for o in outs] == ["p0"]
    assert outs[0].kind == OUTCOME_RESULT and outs[0].converged
    assert metrics.get("serve.tenant.completed.poison") == 1
    assert revived.stats()["lost"] == 0


# -- per-tenant SLO burn & the stats surface -----------------------------


def test_per_tenant_slo_burn_and_stats_block():
    svc, _ = _service(ServicePolicy(
        capacity=16, tenancy=TenancyPolicy(shares=(("a", 2.0),))))
    svc.submit(SolveRequest(request_id="a0", problem=P40, tenant="a"))
    svc.submit(SolveRequest(request_id="b0", problem=P40, tenant="b"))
    svc.drain()
    # one SLO surface per tenant, prefixed so the global serve.slo.*
    # counters stay exactly the fleet-wide totals (no double counting)
    assert metrics.get("serve.tenant.slo.a.good") == 1
    assert metrics.get("serve.tenant.slo.b.good") == 1
    assert metrics.get("serve.slo.good") == 2
    snap = metrics.snapshot()
    gauges = snap.get("gauges", snap)
    assert "serve.tenant.share.a" in str(sorted(gauges))
    st = svc.stats()["tenants"]
    assert st["a"]["share"] == 2.0 and st["b"]["share"] == 1.0
    assert st["a"]["slo_budget_remaining"] <= 1.0
    # retry budgeting on by default: tokens visible, full
    assert st["a"]["retry_tokens"] == float(
        TenancyPolicy().retry_budget)


# -- per-tenant accounting ------------------------------------------------
# (In place of the JAX suite's bench-sentinel cohort pin: the port has
# no bench serve mode yet.)


def test_tenant_dispatches_sum_to_batch_members():
    """Every dispatched member is attributed to exactly one tenant: the
    per-tenant dispatch counters sum to the service's batch members."""
    svc, _ = _service(ServicePolicy(
        capacity=32, max_batch=4, degradation=_quiet_degradation(),
        tenancy=TenancyPolicy(shares=(("a", 1.0), ("b", 4.0)))))
    for i in range(10):
        svc.submit(SolveRequest(request_id=i, problem=P40,
                                tenant=("a" if i % 2 else "b")))
    outs = svc.drain()
    assert len(outs) == 10 and all(o.converged for o in outs)
    per_tenant = (metrics.get("serve.tenant.dispatches.a")
                  + metrics.get("serve.tenant.dispatches.b"))
    assert per_tenant == metrics.get("serve.batch_members") == 10


# -- chaos pins ----------------------------------------------------------


def test_noisy_neighbor_chaos_isolates_the_victim():
    """The acceptance shape: under a 10x aggressor flood the victim's
    completed count and p99 hold within 10% of its solo baseline with
    tenancy on, starvation is demonstrated with tenancy off, and the
    aggressor's overflow sheds typed at zero compute (the chaos
    scenario asserts the same end to end; this is the in-suite pin)."""
    from poisson_tpu_torch.testing import chaos

    report = chaos.run_scenario("tenant-noisy-neighbor", seed=0, device="cpu")
    assert report["ok"], report
    assert report["checks"]["off_arm_starves_victim"]
    assert report["checks"]["on_arm_victim_all_served"]
    assert report["checks"]["on_arm_victim_p99_within_10pct"]
    assert report["checks"]["quota_sheds_burned_zero_compute"]
    assert report["checks"]["no_lost_requests"]


def test_retry_storm_chaos_caps_amplification():
    from poisson_tpu_torch.testing import chaos

    report = chaos.run_scenario("tenant-retry-storm", seed=0, device="cpu")
    assert report["ok"], report
    assert report["checks"]["requeue_amplification_capped"]
    assert report["checks"]["budget_exhaustion_typed"]
    assert report["checks"]["steady_tenant_untouched"]
    assert report["checks"]["no_lost_requests"]
