"""Multi-tenant serving: quotas, weighted fair queuing, priority classes
(port of ``paddle_tpu.serving.tenancy``).

The noisy-neighbor isolation layer over the continuous-batching
scheduler: every request carries a tenant name, and a
:class:`TenantRegistry` attached to the scheduler turns the global FIFO
admission into **weighted fair queuing over token budgets**:

- **token-bucket rate limits**: each tenant may carry a
  :class:`TokenBucket` (``rate_tokens_per_s`` + ``burst_tokens``,
  lazily refilled on the scheduler's injected clock). A submit whose
  prompt+budget cost overdraws the bucket sheds with a typed
  ``RejectedError(reason="tenant_rate", tenant=..., retry_after_s=...)``
  whose hint is exactly the bucket's refill time for the deficit, so a
  client that honours it is admitted.
- **page-pool quotas**: ``max_resident_pages`` caps the KV pages a
  tenant may hold across its running requests (its queued work WAITS,
  it is never shed for it); ``max_concurrent`` caps live requests
  (excess sheds ``tenant_quota``); ``guaranteed_pages`` is the floor
  below which cross-tenant preemption may never push a tenant.
- **virtual-time fair queuing**: each tenant's virtual time advances by
  ``tokens / weight`` for every prefill and decode token it consumes;
  admission picks the eligible tenant with the LOWEST virtual time, and
  a tenant returning from idle re-enters at the global virtual clock
  (no banked credit).
- **priority classes**: under page pressure the scheduler's
  ``_pick_victim`` prefers the lowest-priority tenant with the most
  pages above its floor, youngest request first, through the usual
  recompute eviction (preempted output resumes identical).

Everything here is host-side scheduler state: a tenant name never
reaches the engine or a kernel. All clock reads are injected ``now``
values.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence

__all__ = ["DEFAULT_TENANT", "TokenBucket", "Tenant", "TenantRegistry",
           "TenantSLOView"]

DEFAULT_TENANT = "default"


class TokenBucket:
    """Lazily-refilled token bucket on caller-supplied timestamps.

    ``try_take(n, now)`` either debits ``n`` tokens and returns
    ``(True, 0.0)``, or leaves the bucket untouched and returns
    ``(False, retry_after_s)`` where the hint is the exact refill time
    for the deficit (``(n - level) / rate``) — the ``retry_after_s`` a
    shed client should honor. Size ``burst`` to at least the largest
    single-request cost (prompt + max_new_tokens): a request costing
    more than ``burst`` can never clear the bucket.
    """

    def __init__(self, rate_per_s: float, burst: float):
        if rate_per_s <= 0 or burst <= 0:
            raise ValueError(
                f"token bucket needs positive rate/burst, got "
                f"rate={rate_per_s} burst={burst}")
        self.rate = float(rate_per_s)
        self.burst = float(burst)
        self.level = float(burst)     # starts full: bursts admit cold
        self._t_last: Optional[float] = None

    def _refill(self, now: float) -> None:
        if self._t_last is None:
            self._t_last = now
        elif now > self._t_last:
            self.level = min(self.burst,
                             self.level + (now - self._t_last) * self.rate)
            self._t_last = now

    def peek(self, now: float) -> float:
        """Tokens available at ``now`` (refills as a side effect)."""
        self._refill(now)
        return self.level

    def try_take(self, n: float, now: float):
        self._refill(now)
        if n <= self.level:
            self.level -= n
            return True, 0.0
        return False, (n - self.level) / self.rate


@dataclasses.dataclass
class Tenant:
    """One tenant's policy + runtime accounting (registry-owned).

    ``weight`` is the WFQ share (2.0 vs 1.0 converges to a 2:1 token
    split under contention); ``priority`` orders preemption victims
    (HIGHER survives longer). All limits default open — a bare
    ``Tenant(name)`` behaves exactly like pre-tenancy traffic.
    """
    name: str
    weight: float = 1.0
    priority: int = 0
    rate_tokens_per_s: Optional[float] = None
    burst_tokens: Optional[float] = None      # default: 2x rate
    max_resident_pages: Optional[int] = None  # KV page quota ceiling
    guaranteed_pages: int = 0                 # never preempted below
    max_concurrent: Optional[int] = None      # live (waiting+running) cap
    # -- runtime (registry-owned) -------------------------------------------
    vtime: float = 0.0
    bucket: Optional[TokenBucket] = dataclasses.field(
        default=None, repr=False)
    admitted: int = 0
    tokens: int = 0                           # vtime-charged tokens
    preemptions: int = 0                      # times this tenant was evicted
    preempted_cross: int = 0                  # ... by ANOTHER tenant's growth
    rejected: Dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"tenant {self.name!r}: weight must be > 0")
        if self.guaranteed_pages < 0:
            raise ValueError(
                f"tenant {self.name!r}: guaranteed_pages must be >= 0")
        if (self.max_resident_pages is not None
                and self.max_resident_pages < self.guaranteed_pages):
            raise ValueError(
                f"tenant {self.name!r}: max_resident_pages "
                f"{self.max_resident_pages} below guaranteed_pages "
                f"{self.guaranteed_pages}")
        if self.rate_tokens_per_s is not None and self.bucket is None:
            self.bucket = TokenBucket(
                self.rate_tokens_per_s,
                self.burst_tokens or 2.0 * self.rate_tokens_per_s)

    def rejected_total(self) -> int:
        return sum(self.rejected.values())


class TenantRegistry:
    """The tenancy control plane one scheduler consults: tenant lookup,
    virtual-time accounting, and per-tenant counters. ``resolve`` maps
    ``None`` to the built-in ``default`` tenant and auto-registers
    unknown names open-by-default (``strict=True`` raises instead —
    production fronts that pre-register every tenant want the typo to
    fail loudly, not mint a fresh unlimited tenant).

    One registry per scheduler: virtual time and bucket levels are
    per-admission-queue state (share one across schedulers and every
    replica would double-charge the same budgets).
    """

    def __init__(self, tenants: Sequence[Tenant] = (),
                 strict: bool = False):
        self.tenants: Dict[str, Tenant] = {}
        self.strict = bool(strict)
        self.vclock = 0.0            # global virtual clock (idle re-entry)
        # keyed SLO view: the owning scheduler attaches one when its own
        # SLO plane is on (None = per-tenant SLIs disabled)
        self.slo: Optional[TenantSLOView] = None
        for t in tenants:
            self.register(t)
        if DEFAULT_TENANT not in self.tenants:
            self.register(Tenant(DEFAULT_TENANT))

    def register(self, tenant: Tenant) -> Tenant:
        if tenant.name in self.tenants:
            raise ValueError(f"duplicate tenant {tenant.name!r}")
        self.tenants[tenant.name] = tenant
        return tenant

    def get(self, name: str) -> Optional[Tenant]:
        return self.tenants.get(name)

    def resolve(self, name: Optional[str]) -> Tenant:
        t = self.tenants.get(name or DEFAULT_TENANT)
        if t is None:
            if self.strict:
                raise KeyError(f"unknown tenant {name!r} "
                               "(strict registry)")
            t = self.register(Tenant(name))
        return t

    # -- virtual-time fair queuing ------------------------------------------

    def note_pick(self, name: Optional[str]) -> None:
        """Admission picked this tenant: advance the global virtual
        clock to its account, so a tenant returning from idle re-enters
        at 'now' in virtual time instead of spending banked credit."""
        t = self.resolve(name)
        if t.vtime > self.vclock:
            self.vclock = t.vtime

    def charge(self, name: Optional[str], tokens: int) -> None:
        """Bill ``tokens`` consumed (prefill context or committed decode
        tokens) to the tenant's virtual-time account at ``1/weight``
        per token."""
        t = self.resolve(name)
        if t.vtime < self.vclock:
            t.vtime = self.vclock
        t.vtime += tokens / t.weight
        t.tokens += int(tokens)

    # -- counters ------------------------------------------------------------

    def on_admit(self, name: Optional[str]) -> None:
        self.resolve(name).admitted += 1

    def on_reject(self, name: Optional[str], reason: str) -> None:
        t = self.resolve(name)
        t.rejected[reason] = t.rejected.get(reason, 0) + 1

    def on_preempt(self, name: Optional[str], cross: bool) -> None:
        t = self.resolve(name)
        t.preemptions += 1
        if cross:
            t.preempted_cross += 1

    # -- validation / introspection -----------------------------------------

    def validate(self, pool_capacity: int, max_pages_per_seq: int) -> None:
        """Reject floor configurations that could deadlock admission:
        if every guaranteed floor were fully occupied there must still
        be room for one maximal request, or an allocation could exhaust
        the pool with no preemptible victim anywhere."""
        floors = sum(t.guaranteed_pages for t in self.tenants.values())
        if floors and floors + max_pages_per_seq > pool_capacity:
            raise ValueError(
                f"guaranteed_pages floors sum to {floors} but the pool "
                f"holds {pool_capacity} pages and one request may need "
                f"{max_pages_per_seq}: floors + max_pages_per_seq must "
                "fit the pool")

    def snapshot(self) -> Dict[str, dict]:
        """Per-tenant accounting card (drills, benches, debugging)."""
        out = {}
        for name, t in sorted(self.tenants.items()):
            out[name] = {
                "weight": t.weight, "priority": t.priority,
                "vtime": round(t.vtime, 3),
                "admitted": t.admitted, "tokens": t.tokens,
                "rejected": dict(t.rejected),
                "preemptions": t.preemptions,
                "preempted_cross": t.preempted_cross,
                "bucket_level": (round(t.bucket.level, 3)
                                 if t.bucket is not None else None),
            }
        return out


class TenantSLOView:
    """Keyed :class:`~..observability.slo.SLOTracker` view: one tracker
    per tenant, lazily created, all sharing the scheduler's clock and
    one SLO config set — per-tenant TTFT/ITL SLIs and burn-rate alerts,
    so noisy-neighbor damage is observable per victim, not just in the
    global aggregate. Feeds ``/slo?tenant=<name>``."""

    def __init__(self, configs=None,
                 clock: Callable[[], float] = time.monotonic,
                 eval_interval_s: float = 1.0):
        self._configs = configs
        self._clock = clock
        self._eval_interval_s = float(eval_interval_s)
        self.trackers: Dict[str, object] = {}

    def for_tenant(self, name: str):
        tr = self.trackers.get(name)
        if tr is None:
            from ..observability.slo import SLOTracker
            tr = SLOTracker(self._configs, clock=self._clock,
                            eval_interval_s=self._eval_interval_s)
            self.trackers[name] = tr
        return tr

    def maybe_evaluate(self) -> None:
        for tr in self.trackers.values():
            tr.maybe_evaluate()

    def firing_count(self) -> int:
        return sum(tr.firing_count() for tr in self.trackers.values())

    def snapshot_for(self, name: str) -> dict:
        """The ``/slo?tenant=<name>`` document. Unknown tenants answer
        with ``known: false`` rather than 404 — a dashboard polling a
        tenant that has not sent traffic yet is not an error."""
        tr = self.trackers.get(name)
        if tr is None:
            return {"tenant": name, "known": False}
        return {"tenant": name, "known": True, **tr.snapshot()}

    def snapshot(self) -> Dict[str, dict]:
        return {name: tr.snapshot()
                for name, tr in sorted(self.trackers.items())}
