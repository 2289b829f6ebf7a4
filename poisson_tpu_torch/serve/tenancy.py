"""Tenant isolation & overload fairness for the solve service
(counterpart of ``poisson_tpu/serve/tenancy.py``).

The serve layer has per-request rails (deadlines, breakers, the
degradation ladder, journaled recovery) but — before this module — no
notion of *who* a request belongs to: admission was strict FIFO, so a
single hot client could starve the rest of the fleet while its
divergence-class retries amplified load exactly when the system was
most stressed.  This module supplies the three isolation mechanisms
(Dean & Barroso 2013, "The Tail at Scale" — PAPERS.md), all off by
default (``ServicePolicy.tenancy = None`` is byte-compatible with the
historical FIFO service):

**Admission quotas** — a token bucket per tenant, refilled at
``quota_rate × share`` admissions/second up to ``quota_burst × share``
tokens.  An over-quota submit burns zero compute: it sheds with the
typed reason ``quota_exceeded`` through the same ``_shed`` path as
``queue_full``, so the ledger invariant
``admitted − (completed + errors + shed) == 0`` closes unchanged.

**Weighted-fair draining** — both engines (drain and continuous
refill) promote the next dispatch head by *tenant share* rather than
arrival order, via smooth weighted round-robin: each scheduling round
every backlogged tenant's deficit counter grows by its share, the
largest counter wins the head, and the winner pays the round's total
back.  Over any window the dispatch mix converges to the share vector
regardless of arrival interleaving.  The lane-table refill applies the
same shares as a per-bucket lane cap so one tenant cannot monopolize a
bucket executable's lanes while another has eligible work waiting
(work-conserving: with no competing tenant the cap is void).

**Retry budgets** — retries spend from a per-tenant budget that only
successes replenish.  A poisoned tenant (every dispatch faulting)
exhausts the budget after ``retry_budget`` requeues and every later
retry converts into a typed error instead of a requeue, bounding its
total dispatch count by ``admitted + retry_budget`` — a retry storm
can no longer multiply load on a degraded fleet.

The ledger is deliberately clock-injected and pure-Python (no JAX):
it must be consultable from the admission path at nanosecond-scale
cost and replayable deterministically under the chaos campaign's
``VirtualClock``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

# The share assumed for any tenant not named in ``TenancyPolicy.shares``
# (and for requests with ``tenant=None`` when tenancy is on, which are
# pooled under this pseudo-tenant so anonymous traffic is itself one
# bounded client rather than an unpoliced side channel).
DEFAULT_TENANT = "default"


@dataclasses.dataclass(frozen=True)
class TenancyPolicy:
    """Per-tenant isolation knobs (``ServicePolicy.tenancy``).

    ``shares`` are relative weights — ``(("a", 1.0), ("b", 4.0))``
    gives tenant b 4× tenant a's dispatch bandwidth and quota rate.
    Tenants absent from the table get ``default_share``.  With
    ``quota_rate == 0`` the admission quota is off (fair draining and
    retry budgets still apply); with ``retry_budget is None`` retry
    budgeting is off.
    """

    # Relative weights per tenant name; unnamed tenants get
    # ``default_share``.  A tuple-of-pairs (not a dict) so the policy
    # stays hashable/frozen like every other serve policy.
    shares: Tuple[Tuple[str, float], ...] = ()
    default_share: float = 1.0
    # Token-bucket admission quota: tokens/second per unit share.
    # 0.0 disables the quota entirely.
    quota_rate: float = 0.0
    # Bucket capacity (burst) per unit share; buckets start full.
    quota_burst: float = 8.0
    # Retry tokens per tenant; each requeue spends one, each completed
    # solve refunds ``retry_refund`` (capped at the budget).  ``None``
    # disables budgeting (historical unbounded-retry behavior).
    retry_budget: Optional[int] = 8
    retry_refund: float = 1.0
    # When True, the queue-pressure degradation ladder applies its full
    # rung only to the offending tenant (largest backlog/share ratio);
    # every other tenant runs one rung gentler.
    isolate_degradation: bool = True


def parse_tenant_spec(spec: str) -> Tuple[Tuple[str, float], ...]:
    """Parse a ``name:weight,name:weight`` share spec (bench/CLI).

    Loud on garbage: empty names, non-numeric or non-positive weights,
    and duplicate names all raise ``ValueError`` naming the offending
    fragment — a typo'd tenant mix must never silently become a
    different experiment.
    """
    shares = []
    seen = set()
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            raise ValueError(f"empty tenant entry in spec {spec!r}")
        name, sep, weight_s = part.partition(":")
        name = name.strip()
        if not name:
            raise ValueError(f"tenant name missing in {part!r} (spec {spec!r})")
        if name in seen:
            raise ValueError(f"duplicate tenant {name!r} in spec {spec!r}")
        seen.add(name)
        if not sep:
            weight = 1.0
        else:
            try:
                weight = float(weight_s)
            except ValueError:
                raise ValueError(
                    f"tenant {name!r} has non-numeric weight {weight_s!r} "
                    f"(spec {spec!r})"
                ) from None
        if not weight > 0.0:
            raise ValueError(
                f"tenant {name!r} has non-positive weight {weight} "
                f"(spec {spec!r})"
            )
        shares.append((name, weight))
    if not shares:
        raise ValueError(f"empty tenant spec {spec!r}")
    return tuple(shares)


class _TenantState:
    """Mutable per-tenant ledger row (internal to ``TenantLedger``)."""

    __slots__ = ("name", "share", "tokens", "last_refill", "deficit",
                 "retry_tokens")

    def __init__(self, name: str, share: float, tokens: float,
                 now: float, retry_tokens: float):
        self.name = name
        self.share = share
        self.tokens = tokens          # admission-quota bucket
        self.last_refill = now
        self.deficit = 0.0            # smooth-WRR deficit counter
        self.retry_tokens = retry_tokens


class TenantLedger:
    """Clock-injected per-tenant state: quota buckets, deficit-weighted
    round-robin counters, and retry budgets.

    One instance lives on the service (built iff
    ``ServicePolicy.tenancy`` is set); the chaos campaign drives it
    through a ``VirtualClock`` so every decision is deterministic.
    """

    def __init__(self, policy: TenancyPolicy, clock) -> None:
        if policy.default_share <= 0.0:
            raise ValueError("TenancyPolicy.default_share must be > 0")
        if policy.quota_rate < 0.0:
            raise ValueError("TenancyPolicy.quota_rate must be >= 0")
        if policy.quota_burst <= 0.0:
            raise ValueError("TenancyPolicy.quota_burst must be > 0")
        if policy.retry_budget is not None and policy.retry_budget < 0:
            raise ValueError("TenancyPolicy.retry_budget must be >= 0")
        for name, share in policy.shares:
            if not share > 0.0:
                raise ValueError(
                    f"TenancyPolicy share for tenant {name!r} must be > 0, "
                    f"got {share}")
        self.policy = policy
        self._clock = clock
        self._shares: Dict[str, float] = dict(policy.shares)
        self._tenants: Dict[str, _TenantState] = {}

    # -- identity -------------------------------------------------------

    def resolve(self, tenant: Optional[str]) -> str:
        """Map a request's (possibly absent) tenant to a ledger key."""
        return str(tenant) if tenant else DEFAULT_TENANT

    def share_of(self, tenant: str) -> float:
        return self._shares.get(tenant, self.policy.default_share)

    def state(self, tenant: str) -> _TenantState:
        st = self._tenants.get(tenant)
        if st is None:
            share = self.share_of(tenant)
            budget = self.policy.retry_budget
            st = _TenantState(
                tenant, share,
                # quota bucket starts full: a new tenant gets its burst.
                tokens=self.policy.quota_burst * share,
                now=float(self._clock()),
                retry_tokens=float(budget) if budget is not None else 0.0,
            )
            self._tenants[tenant] = st
        return st

    # -- admission quota ------------------------------------------------

    def admit(self, tenant: str) -> bool:
        """Spend one quota token; False ⇒ shed ``quota_exceeded``."""
        st = self.state(tenant)
        if self.policy.quota_rate <= 0.0:
            return True
        now = float(self._clock())
        cap = self.policy.quota_burst * st.share
        if now > st.last_refill:
            st.tokens = min(
                cap,
                st.tokens + (now - st.last_refill)
                * self.policy.quota_rate * st.share)
        st.last_refill = now
        if st.tokens >= 1.0:
            st.tokens -= 1.0
            return True
        return False

    # -- weighted-fair head selection -----------------------------------

    def pick(self, backlogged: Sequence[str]) -> str:
        """Smooth weighted round-robin over the tenants with backlog.

        Every candidate's deficit counter grows by its share; the
        largest counter wins and repays the round's total share, so
        the long-run pick frequency of tenant *t* converges to
        ``share_t / Σ shares`` over the backlogged set.  Ties break to
        the lexicographically-first tenant (callers pass a sorted
        sequence) for determinism under a fixed seed.
        """
        best: Optional[_TenantState] = None
        total = 0.0
        for name in backlogged:
            st = self.state(name)
            st.deficit += st.share
            total += st.share
            if best is None or st.deficit > best.deficit:
                best = st
        assert best is not None, "pick() needs a non-empty backlog"
        best.deficit -= total
        return best.name

    # -- retry budgets --------------------------------------------------

    def spend_retry(self, tenant: str) -> bool:
        """Spend one retry token; False ⇒ the retry becomes a typed
        error instead of a requeue (budget exhausted)."""
        if self.policy.retry_budget is None:
            return True
        st = self.state(tenant)
        if st.retry_tokens >= 1.0:
            st.retry_tokens -= 1.0
            return True
        return False

    def credit_success(self, tenant: str) -> None:
        """A completed solve refunds retry tokens (capped at budget)."""
        if self.policy.retry_budget is None:
            return
        st = self.state(tenant)
        st.retry_tokens = min(float(self.policy.retry_budget),
                              st.retry_tokens + self.policy.retry_refund)

    def charge_attempts(self, tenant: str, attempts: int) -> None:
        """Recovery replay: re-charge journaled dispatch attempts so a
        poisoned tenant cannot reset its amplification cap by crashing
        the process mid-storm."""
        if self.policy.retry_budget is None or attempts <= 0:
            return
        st = self.state(tenant)
        st.retry_tokens = max(0.0, st.retry_tokens - float(attempts))

    # -- degradation offender -------------------------------------------

    def offender(self, backlog: Dict[str, int]) -> Optional[str]:
        """The tenant whose backlog most exceeds its share — the one
        the degradation ladder downshifts first.  None when fewer than
        two tenants are backlogged (nobody to spare)."""
        if len(backlog) < 2:
            return None
        best_name, best_ratio = None, -1.0
        for name in sorted(backlog):
            ratio = backlog[name] / self.share_of(name)
            if ratio > best_ratio:
                best_name, best_ratio = name, ratio
        return best_name

    # -- introspection --------------------------------------------------

    def tenants(self) -> Tuple[str, ...]:
        return tuple(sorted(self._tenants))

    def describe(self) -> Dict[str, Dict[str, float]]:
        """Stats/gauge snapshot: one row per tenant the ledger has
        seen, JSON-ready."""
        out: Dict[str, Dict[str, float]] = {}
        budget = self.policy.retry_budget
        for name in sorted(self._tenants):
            st = self._tenants[name]
            out[name] = {
                "share": float(st.share),
                "quota_tokens": round(float(st.tokens), 6),
                "retry_tokens": (round(float(st.retry_tokens), 6)
                                 if budget is not None else -1.0),
            }
        return out
