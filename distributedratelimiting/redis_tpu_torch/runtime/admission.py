"""Token-denominated, priority-aware admission — the LLM-serving policy
layer, ported from the JAX package's ``runtime/admission.py``.

The machinery below this module counts permits; LLM gateways limit by
token budget with heavy-tailed cost per request: a 4K-token completion must
cost 4096 times a 1-token probe, a tenant's keys share one budget, and
under pressure the right traffic sheds first. This module makes that the
admission plane:

- **Weighted-cost acquire** — every lane carries a ``count`` end to end;
  budgets, envelopes and velocity all count tokens.
- **Hierarchical tenant → key budgets** — the key's bucket and its
  tenant's bucket decide together, in one launch of the two-level kernel on
  the card (:func:`~..ops.cuda_kernels.acquire_hierarchical`), granted iff
  both admit, both debited or neither. Over the wire it is ``OP_ACQUIRE_H``
  and the ``BULK_KIND_HBUCKET`` bulk kind; tenant budgets are plain bucket
  configs.
- **Priority classes** — interactive / batch / scavenger with a shed order,
  applied wherever a bounded envelope serves instead of the store
  (:func:`shed_allows`, the one shared gate).
- **Token velocity** — per-tenant tokens/s as an exponentially decayed rate
  (:class:`TokenVelocity`), exported through ``OP_STATS``.
- **Streaming reservations** — ``AdmissionPolicy.reserve`` admits an
  estimated cost and ``settle`` reconciles the actual one through the
  store's reservation ledger (:mod:`~.reservations`); the policy keeps its
  own :class:`~.reservations.EstimatePrior` for reserves sent without an
  estimate.

Contract: a hierarchical decision changes state
both-or-neither — a denied request leaves both buckets exactly as a
refill-only touch would. In-batch duplicate demand serializes
conservatively on BOTH axes (an earlier row's demand reserves ahead on
its key and, when child-admitted, on its tenant, even if ultimately
denied), identical to the flat bulk paths' documented posture: exact
on serial stores and whenever the in-call demand fits.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Mapping

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
)
from distributedratelimiting.redis_tpu_torch.runtime.reservations import (
    EstimatePrior,
    ReserveResult,
)

__all__ = [
    "PRIORITY_INTERACTIVE", "PRIORITY_BATCH", "PRIORITY_SCAVENGER",
    "PRIORITY_NAMES", "BATCH_ENVELOPE_RESERVE", "priority_name",
    "shed_allows", "TenantBudget", "TokenVelocity", "AdmissionPolicy",
]

#: Priority classes, shed-order ascending: the HIGHEST value sheds
#: first. The wire carries the value as one byte on the tenant
#: extension (wire.py ``_HIER_TAIL``); plain (non-hierarchical) frames
#: default to interactive — unchanged behavior for every existing
#: caller.
PRIORITY_INTERACTIVE = 0
PRIORITY_BATCH = 1
PRIORITY_SCAVENGER = 2

PRIORITY_NAMES = ("interactive", "batch", "scavenger")

#: Fraction of an envelope's budget reserved for interactive traffic:
#: batch admits only while the post-grant balance stays above
#: ``budget × BATCH_ENVELOPE_RESERVE`` — the envelope's last half is
#: spent on interactive alone. Scavenger never touches an envelope.
BATCH_ENVELOPE_RESERVE = 0.5


def priority_name(priority: int) -> str:
    if 0 <= priority < len(PRIORITY_NAMES):
        return PRIORITY_NAMES[priority]
    return f"priority{priority}"


def shed_allows(priority: int, tokens: float, count: int,
                budget: float) -> bool:
    """THE envelope shed gate — one formula for every bounded-envelope
    serving site (drain windows, parked handoffs, degraded fallback),
    so the documented shed order can never drift between them:

    - **scavenger** is shed outright: envelope serving exists to keep a
      bounded epsilon of availability through an outage/handoff, and
      that epsilon is not spent on best-effort traffic (probes
      included — a scavenger probe during degraded serving answers
      "no").
    - **batch** admits only while the post-grant balance stays above
      ``budget × BATCH_ENVELOPE_RESERVE`` — it cannot consume the
      reserved half.
    - **interactive** (and anything unclassified below batch) gets the
      plain ``tokens >= count`` envelope rule.

    ``tokens`` is the envelope's refilled balance, ``budget`` its full
    size (``headroom_budget(cap, fraction)``). Callers debit on True
    exactly as before."""
    if count < 0:
        return False
    if priority >= PRIORITY_SCAVENGER:
        return False
    if priority >= PRIORITY_BATCH:
        return tokens - count >= budget * BATCH_ENVELOPE_RESERVE
    return tokens >= count


class TenantBudget:
    """One tenant's token budget: a plain bucket config (capacity in
    tokens, refill in tokens/sec) under the tenant's id, checkpointed like
    any other bucket state."""

    __slots__ = ("tenant", "capacity", "fill_rate_per_sec")

    def __init__(self, tenant: str, capacity: float,
                 fill_rate_per_sec: float) -> None:
        if not tenant:
            raise ValueError("tenant id must be non-empty")
        if not math.isfinite(capacity) or capacity <= 0:
            raise ValueError(f"tenant capacity must be > 0: {capacity}")
        if not math.isfinite(fill_rate_per_sec) or fill_rate_per_sec < 0:
            raise ValueError(
                f"tenant fill rate must be >= 0: {fill_rate_per_sec}")
        self.tenant = tenant
        self.capacity = float(capacity)
        self.fill_rate_per_sec = float(fill_rate_per_sec)

    def config(self) -> tuple[float, float]:
        return self.capacity, self.fill_rate_per_sec

    def __repr__(self) -> str:
        return (f"TenantBudget({self.tenant!r}, {self.capacity}, "
                f"{self.fill_rate_per_sec}/s)")


class TokenVelocity:
    """Per-tenant tokens/sec — the signal autoscalers and the resharder
    consume (TokenScale's observation: token *velocity*, not request
    rate, is what predicts LLM-serving load).

    Estimator: an exponentially decayed token sum per tenant —
    ``S ← S·exp(−Δt/τ) + cost`` on every observation — read as
    ``rate = S/τ``. Under a steady feed of r tokens/sec, S converges to
    ``r·τ``, so the readout converges to r; after the feed stops, the
    estimate decays to zero with time constant τ. One dict entry and
    two floats per tenant, deterministic under an injected clock (the
    seeded soaks), bounded tenant cardinality (smallest sum evicts
    first — a tenant hot enough to matter re-enters immediately)."""

    __slots__ = ("tau_s", "max_tenants", "_clock", "_state",
                 "observed_tokens", "_totals")

    def __init__(self, tau_s: float = 10.0, max_tenants: int = 512,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if tau_s <= 0:
            raise ValueError("tau_s must be positive")
        self.tau_s = float(tau_s)
        self.max_tenants = max_tenants
        self._clock = clock
        self._state: dict[str, tuple[float, float]] = {}  # S, last_t
        #: Lifetime admitted tokens observed (all tenants) — the
        #: cheap absolute counter beside the rate gauge.
        self.observed_tokens = 0.0
        # Per-tenant lifetime admitted tokens — the MONOTONIC companion
        # of the decayed rate, for consumers that derive their own
        # windowed rates from counter deltas instead of trusting a
        # wall-clock-decayed gauge (the controller's determinism
        # contract: same traffic schedule ⇒ same deltas, regardless of
        # when the scrape lands). Evicted together with the rate state;
        # delta consumers tolerate the reset (CounterDeltas).
        self._totals: dict[str, float] = {}

    def observe(self, tenant: str, cost: float) -> None:
        """Fold ``cost`` admitted tokens for ``tenant`` into the rate."""
        if cost <= 0:
            return
        now = self._clock()
        self.observed_tokens += cost
        entry = self._state.get(tenant)
        if entry is None:
            if len(self._state) >= self.max_tenants:
                victim = min(self._state, key=lambda t: self._state[t][0])
                del self._state[victim]
                self._totals.pop(victim, None)
            self._state[tenant] = (float(cost), now)
            self._totals[tenant] = self._totals.get(tenant, 0.0) + cost
            return
        s, last = entry
        s = s * math.exp(-(now - last) / self.tau_s) + cost
        self._state[tenant] = (s, now)
        self._totals[tenant] = self._totals.get(tenant, 0.0) + cost

    def rate(self, tenant: str) -> float:
        """Current tokens/sec estimate for one tenant (0.0 unknown)."""
        entry = self._state.get(tenant)
        if entry is None:
            return 0.0
        s, last = entry
        return s * math.exp(-(self._clock() - last) / self.tau_s) \
            / self.tau_s

    def rates(self) -> dict[str, float]:
        """``{tenant: tokens_per_sec}`` for every tracked tenant,
        decay-corrected to now."""
        now = self._clock()
        return {t: s * math.exp(-(now - last) / self.tau_s) / self.tau_s
                for t, (s, last) in self._state.items()}

    def totals(self) -> dict[str, float]:
        """Per-tenant lifetime admitted tokens (monotonic while the
        tenant stays tracked) — the delta-of-counters feed."""
        return dict(self._totals)

    def snapshot(self) -> dict:
        """JSON-shaped summary for OP_STATS embedding."""
        rates = self.rates()
        return {
            "tau_s": self.tau_s,
            "observed_tokens": self.observed_tokens,
            "tenants": {t: round(r, 6)
                        for t, r in sorted(rates.items(),
                                           key=lambda kv: -kv[1])},
            # Monotonic per-tenant counters beside the decayed gauges:
            # rate derivation that must be scrape-time independent
            # (runtime/controller.py) diffs these instead.
            "admitted": {t: self._totals[t]
                         for t in sorted(self._totals)},
        }


class AdmissionPolicy:
    """The client-side admission façade: tenant budgets + priorities +
    velocity over any :class:`~.runtime.store.BucketStore`.

    One instance binds a store, a default child (per-key) bucket
    config, and a set of :class:`TenantBudget` rows; ``acquire`` is
    then the LLM-gateway entry point::

        policy = AdmissionPolicy(store, key_config=(4096.0, 64.0))
        policy.set_tenant(TenantBudget("tenant:acme", 1e6, 5e4))
        res = await policy.acquire("tenant:acme", "user:42", cost=812,
                                   priority=PRIORITY_BATCH)

    Decisions go through the store's hierarchical lane (grant iff both
    the key's bucket and the tenant's budget admit — on remote/cluster
    stores that is the ``OP_ACQUIRE_H`` wire op, priority stamped on
    the frame). Granted costs feed the local :class:`TokenVelocity`.

    ``shed_level`` is the operator brownout knob: priorities at/above
    it are denied locally without touching the store (e.g.
    ``set_shed_level(PRIORITY_SCAVENGER)`` during an incident sheds
    scavenger fleet-wide at the edge). ``None`` (default) sheds
    nothing."""

    def __init__(self, store, *, key_config: tuple[float, float],
                 tenants: "Mapping[str, TenantBudget] | None" = None,
                 velocity_tau_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.store = store
        self.key_config = (float(key_config[0]), float(key_config[1]))
        self._tenants: dict[str, TenantBudget] = dict(tenants or {})
        self.velocity = TokenVelocity(velocity_tau_s, clock=clock)
        # Streaming reservations: this gateway's own estimate prior (fed
        # by settles) and its rid sequence.
        self.prior = EstimatePrior()
        self._rid_seq = 0
        self.shed_level: "int | None" = None
        # Visible counters (stats()).
        self.decisions = 0
        self.granted = 0
        self.admitted_tokens = 0.0
        self.shed = 0
        self.reserves = 0
        self.reserved_tokens = 0.0
        self.settles = 0
        self.settled_tokens = 0.0
        # Retry-aware admission: first-attempt vs retry traffic per
        # tenant, and the retry-shed switch. Under retry-shed, attempts >= 1
        # are denied locally BEFORE the store (retries shed before any
        # priority class: a retry burns budget a first attempt could
        # have used for useful work).
        self.retry_shed = False
        self.first_attempts = 0
        self.retry_attempts = 0
        self.retries_shed = 0
        self._first_by_tenant: dict[str, int] = {}
        self._retry_by_tenant: dict[str, int] = {}

    # -- tenant budget management (live-mutable) -----------------------------
    def set_tenant(self, budget: TenantBudget) -> None:
        """Install/replace a tenant's budget for FUTURE local calls. This
        changes only which config this client sends: balances accumulated
        under the old config stay in the old config's table."""
        self._tenants[budget.tenant] = budget

    def tenant(self, tenant: str) -> TenantBudget:
        b = self._tenants.get(tenant)
        if b is None:
            raise KeyError(f"no budget configured for tenant {tenant!r}")
        return b

    def tenants(self) -> dict[str, TenantBudget]:
        return dict(self._tenants)

    def set_shed_level(self, level: "int | None") -> None:
        self.shed_level = level

    def set_retry_shed(self, enabled: bool) -> None:
        """Arm/disarm the retry-shed rung: while armed, calls stamped
        ``attempt >= 1`` are denied locally without touching the store
        (before the priority ladder)."""
        self.retry_shed = bool(enabled)

    def _note_attempt(self, tenant: str, attempt: int) -> None:
        if attempt:
            self.retry_attempts += 1
            self._retry_by_tenant[tenant] = \
                self._retry_by_tenant.get(tenant, 0) + 1
        else:
            self.first_attempts += 1
            self._first_by_tenant[tenant] = \
                self._first_by_tenant.get(tenant, 0) + 1

    # -- admission -----------------------------------------------------------
    async def acquire(self, tenant: str, key: str, cost: int = 1,
                      priority: int = PRIORITY_INTERACTIVE,
                      attempt: int = 0):
        """One weighted-cost hierarchical admission decision.
        ``attempt`` fingerprints retries (0 = first attempt): tracked
        per tenant, and denied locally while retry-shed is armed."""
        from distributedratelimiting.redis_tpu_torch.runtime.store import (
            AcquireResult,
        )

        self.decisions += 1
        self._note_attempt(tenant, attempt)
        if self.retry_shed and attempt:
            self.retries_shed += 1
            self.shed += 1
            return AcquireResult(False, 0.0)
        if self.shed_level is not None and priority >= self.shed_level:
            self.shed += 1
            return AcquireResult(False, 0.0)
        budget = self.tenant(tenant)
        cap, rate = self.key_config
        res = await self.store.acquire_hierarchical(
            tenant, key, int(cost), budget.capacity,
            budget.fill_rate_per_sec, cap, rate, priority=priority)
        if res.granted:
            self.granted += 1
            self.admitted_tokens += cost
            self.velocity.observe(tenant, float(cost))
        return res

    def acquire_blocking(self, tenant: str, key: str, cost: int = 1,
                         priority: int = PRIORITY_INTERACTIVE,
                         attempt: int = 0):
        from distributedratelimiting.redis_tpu_torch.runtime.store import (
            AcquireResult,
        )

        self.decisions += 1
        self._note_attempt(tenant, attempt)
        if self.retry_shed and attempt:
            self.retries_shed += 1
            self.shed += 1
            return AcquireResult(False, 0.0)
        if self.shed_level is not None and priority >= self.shed_level:
            self.shed += 1
            return AcquireResult(False, 0.0)
        budget = self.tenant(tenant)
        cap, rate = self.key_config
        res = self.store.acquire_hierarchical_blocking(
            tenant, key, int(cost), budget.capacity,
            budget.fill_rate_per_sec, cap, rate, priority=priority)
        if res.granted:
            self.granted += 1
            self.admitted_tokens += cost
            self.velocity.observe(tenant, float(cost))
        return res

    # -- streaming reservations (runtime/reservations.py) --------------------
    def next_rid(self, tenant: str) -> str:
        """A per-gateway reservation id: tenant-scoped + monotonic.
        Unique across gateways only when each gateway's ids carry a
        distinct prefix — callers with several gateways pass their own
        rids instead (the seeded tests do, for determinism)."""
        self._rid_seq += 1
        return f"{tenant}#{id(self) & 0xFFFFFF:x}#{self._rid_seq}"

    async def reserve(self, tenant: str, key: str, *,
                      estimate: "float | None" = None,
                      priority: int = PRIORITY_INTERACTIVE,
                      rid: "str | None" = None,
                      ttl_s: "float | None" = None,
                      attempt: int = 0,
                      deadline_s: "float | None" = None):
        """Phase 1 of a streaming request: admit an ESTIMATED cost and
        hold it against the tenant → key budgets. With no ``estimate``
        the gateway's own prior supplies one (interactive → p99,
        batch/scavenger → mean — the server-side prior applies the same
        rule when the estimate is omitted on the wire). Returns the
        store's ReserveResult; pass the rid (yours or :meth:`next_rid`'s)
        to :meth:`settle` when the stream ends."""
        self.decisions += 1
        self._note_attempt(tenant, attempt)
        if self.retry_shed and attempt:
            self.retries_shed += 1
            self.shed += 1
            return ReserveResult(False, 0.0, 0.0, 0.0)
        if self.shed_level is not None and priority >= self.shed_level:
            self.shed += 1
            return ReserveResult(False, 0.0, 0.0, 0.0)
        budget = self.tenant(tenant)
        cap, rate = self.key_config
        if estimate is None:
            estimate = self.prior.estimate(tenant, priority)
        res = await self.store.reserve(
            rid if rid is not None else self.next_rid(tenant),
            tenant, key, estimate, budget.capacity,
            budget.fill_rate_per_sec, cap, rate, priority=priority,
            ttl_s=ttl_s, attempt=attempt, deadline_s=deadline_s)
        if res.granted:
            self.granted += 1
            self.reserves += 1
            self.reserved_tokens += res.reserved
        return res

    async def settle(self, rid: str, tenant: str, actual: float, *,
                     priority: int = PRIORITY_INTERACTIVE):
        """Phase 3: reconcile the actual cost. Feeds the gateway's
        velocity (at the TRUE spend) and its estimate prior."""
        res = await self.store.settle(rid, tenant, actual)
        if res.outcome in ("settled", "fallback", "expired"):
            self.settles += 1
            self.settled_tokens += actual
            self.admitted_tokens += actual
            if actual > 0:
                self.velocity.observe(tenant, float(actual))
            self.prior.observe(tenant, priority, float(actual))
        return res

    def envelope_budget(self, tenant: str, *,
                        fraction: float = 0.5) -> float:
        """The tenant's fair-share envelope size — the epsilon term a
        degraded/drain window can add on top of the budget (the same
        ``headroom_budget`` formula every envelope uses)."""
        return headroom_budget(self.tenant(tenant).capacity,
                               fraction=fraction, min_budget=1.0)

    def stats(self) -> dict:
        return {
            "decisions": self.decisions,
            "granted": self.granted,
            "admitted_tokens": self.admitted_tokens,
            "shed": self.shed,
            "reserves": self.reserves,
            "reserved_tokens": self.reserved_tokens,
            "settles": self.settles,
            "settled_tokens": self.settled_tokens,
            "shed_level": self.shed_level,
            "retry_shed": self.retry_shed,
            "first_attempts": self.first_attempts,
            "retry_attempts": self.retry_attempts,
            "retries_shed": self.retries_shed,
            "first_attempts_by_tenant": {
                t: self._first_by_tenant[t]
                for t in sorted(self._first_by_tenant)},
            "retry_attempts_by_tenant": {
                t: self._retry_by_tenant[t]
                for t in sorted(self._retry_by_tenant)},
            "tenants": {t: list(b.config())
                        for t, b in sorted(self._tenants.items())},
            "token_velocity": self.velocity.snapshot(),
        }
