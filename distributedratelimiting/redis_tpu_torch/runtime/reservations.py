"""Estimate-reserve-settle — the streaming reservation lane, ported whole
from the JAX package's ``runtime/reservations.py``.

Weighted-cost admission meters a request by its token cost, but a real LLM
gateway does not *know* the cost at admission time: the output length is
unknown until generation ends — exactly the gap "Token-Budget-Aware Pool
Routing" and "TokenScale" (PAPERS.md) identify between admission-time
budgeting and actual token spend. This module closes it with a three-phase
protocol over the hierarchical (tenant → key) budget machinery:

1. **reserve** — admit an *estimated* cost against the tenant → key
   budgets (the same grant-iff-both-levels ``acquire_hierarchical``
   decision every metered request takes; on a card store one launch of
   the two-level kernel), and hold a TTL'd reservation in a bounded
   server-side ledger. When the caller supplies no estimate, a
   per-``(tenant, priority)`` prior learned from settled actuals supplies
   one: interactive reserves the prior's p99 (a tail overrun on an
   interactive stream must be rare), batch and scavenger reserve the mean
   (throughput traffic amortizes its own variance).
2. **stream** — the tokens flow; the reservation is the budget hold.
3. **settle** — reconcile the *actual* cost. Over-estimates refund
   through the saturating negative-debit lane (``debit_many`` with a
   negative amount — the refund primitive; the capacity clamp on the next
   refill bounds any transient overshoot, so a refund can only
   under-credit, the safe direction). Under-estimates debit the extra
   through the same saturating kernel; whatever the tenant bucket cannot
   cover becomes **per-tenant debt** that the next ``reserve`` must pay
   down — through the same ``debit_many`` primitive — before new
   admission. On a card store each ``debit_many`` is one launch of the
   debit kernel.

**Idempotency** (docs/DESIGN.md §18): both halves key on the caller's
reservation id. A retried ``reserve`` of a granted id returns the
recorded decision without a second debit; a retried ``settle`` of a
settled id is a counted no-op replaying the recorded result. That makes
``OP_RESERVE``/``OP_SETTLE`` application-idempotent — post-send-retry-
safe in the at-most-once contract.

**TTL** — a client that dies mid-stream leaves its reservation behind;
on expiry the ledger auto-settles it *at the estimate* (delta zero: the
hold simply becomes the spend — conservative, no refund is owed to a
caller that never reported), counted and flight-recorded. Expiry is
piggybacked on every ledger touch (and the stats scrape), so it needs
no background task and stays deterministic under an injected clock.

**Why debt is per-tenant, not per-key** — the tenant budget is the
contract being enforced (the paper's hierarchical composition); child
keys are ephemeral routing identities a client can mint freely, so
per-key debt would be trivially evaded by rotating keys while the
tenant's real overdraft went untracked.

The migration rows (``export_rows``, ``drop_rids``, ``restore_rows``)
and the ``liveconfig`` and ``flight_recorder`` hooks are here as in the
JAX package. The server sets both: ``flight_recorder`` to its
observability plane's, and ``liveconfig`` to its
:class:`~.liveconfig.ConfigState`, so a settle of a hold made under a
retired config refunds into the table the rebase carried its balance into
(:meth:`ReservationLedger._cfg`, counted ``rehomed``). The migration rows
ride the placement plane's pull and push (:mod:`~.placement`, the store's
``export_entries``). ``stats(reset=True)`` on a server never
touches the ledger (the monotonic-counter contract)."""

from __future__ import annotations

import asyncio
import heapq
import json
import math
import time
from collections import OrderedDict
from typing import Callable, NamedTuple

from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LatencyHistogram,
)

__all__ = [
    "ReserveResult", "SettleResult", "EstimatePrior",
    "ReservationLedger", "DEFAULT_TTL_S", "DEFAULT_ESTIMATE",
    "fallback_charge",
    "ROUTE_PREFIX", "route_message", "parse_route",
]

#: Default reservation TTL: generous for an LLM stream (minutes-long
#: generations pass ``ttl_s`` explicitly), short enough that a crashed
#: client's hold stops distorting the budget within one operator glance.
DEFAULT_TTL_S = 30.0

#: When neither the caller nor the prior has an estimate (a brand-new
#: tenant's first request), reserve this many tokens. Deliberately
#: modest: the first settle seeds the prior, so the blind window is one
#: request per (tenant, priority).
DEFAULT_ESTIMATE = 64.0


# -- route-to-pool redirect (budget-aware pool routing, DESIGN.md §24) -------

#: Marker prefix of the OP_RESERVE "route-to-pool" redirect reply — a
#: routable RESP_ERROR whose message carries the overflow pool's config
#: as JSON. The MOVED posture: an error to peers that do not speak it
#: (they surface it and fall back), a chase-once redirect to peers that
#: do (remote.reserve re-sends ONCE against the named pool and marks
#: the result ``routed=True``).
ROUTE_PREFIX = "route-to-pool "


def route_message(pool: str, ta: float, tb: float,
                  priority: int) -> str:
    """Encode the redirect reply body: the overflow pool's name, its
    tenant-level config ``(ta, tb)`` and the priority class the routed
    request is demoted to (batch — it left the interactive pool)."""
    return ROUTE_PREFIX + json.dumps(
        {"pool": pool, "ta": float(ta), "tb": float(tb),
         "priority": int(priority)},
        ensure_ascii=True, sort_keys=True)


def parse_route(message: str) -> "dict | None":
    """Parse a redirect out of a relayed error message, or ``None``
    when the error is not a route-to-pool reply (the client treats it
    as the plain error it is). Tolerant of relay prefixes — the marker
    is searched, not anchored — but strict about the JSON body: a
    mangled redirect is a plain error, never a half-parsed route."""
    idx = message.find(ROUTE_PREFIX)
    if idx < 0:
        return None
    try:
        obj = json.loads(message[idx + len(ROUTE_PREFIX):])
    except ValueError:
        return None
    if not isinstance(obj, dict) or "pool" not in obj \
            or "ta" not in obj or "tb" not in obj:
        return None
    return obj


def fallback_charge(estimate: "float | None") -> int:
    """The charge for reserve paths with NO ledger or prior in reach
    (the old-peer flat fallback, the cluster's degraded-envelope
    fallback): the caller's estimate when given, else
    :data:`DEFAULT_ESTIMATE` — the same floor the ledger itself
    applies, so a degraded path can never admit a typical stream for a
    1-token charge (that would be over-admission exactly where the
    docstrings promise the conservative direction)."""
    if estimate and estimate > 0:
        return max(1, int(math.ceil(float(estimate))))
    return int(DEFAULT_ESTIMATE)


class ReserveResult(NamedTuple):
    granted: bool
    #: Tokens actually held (the charge — the settle's baseline).
    reserved: float
    #: Binding level's post-decision balance estimate (0.0 on deny).
    remaining: float
    #: The tenant's unsettled debt AFTER this reserve's pay-down pass.
    debt: float
    #: True when this answer replayed a recorded decision (retry dedup).
    duplicate: bool = False
    #: True when an old peer forced the flat acquire-at-estimate path.
    fallback: bool = False
    #: True when the grant came from a route-to-pool redirect chase
    #: (the request was admitted in the OVERFLOW pool, not the one the
    #: caller named — docs/DESIGN.md §24).
    routed: bool = False
    #: The pool (tenant-bucket key) a routed grant landed in — the
    #: settle must target this name, not the original tenant (the
    #: ledger hold lives under the pool's budget).
    pool: "str | None" = None


class SettleResult(NamedTuple):
    #: "settled" | "duplicate" | "unknown" | "expired" | "fallback".
    outcome: str
    #: actual − reserved (the estimate error this settle reconciled).
    delta: float
    #: Tokens credited back (over-estimate refund actually issued).
    refunded: float
    #: The tenant's unsettled debt after this settle.
    debt: float


class EstimatePrior:
    """Per-``(tenant, priority)`` cost prior, learned from settled
    actuals. Bounded two ways: at most ``max_groups`` (tenant, priority)
    rings (oldest-touched evicted first), each keeping the newest
    ``window`` samples. Interactive estimates read the ring's p99;
    batch/scavenger read the mean (module docstring). A priority with
    no samples falls back to the tenant's other priorities' merged
    samples before giving up — a tenant's batch history is a better
    prior for its first interactive request than a global constant."""

    def __init__(self, window: int = 128, max_groups: int = 1024) -> None:
        if window < 1 or max_groups < 1:
            raise ValueError("window and max_groups must be >= 1")
        self.window = window
        self.max_groups = max_groups
        self._rings: "OrderedDict[tuple[str, int], list[float]]" = \
            OrderedDict()

    def observe(self, tenant: str, priority: int, actual: float) -> None:
        if actual <= 0 or not math.isfinite(actual):
            return
        key = (tenant, int(priority))
        ring = self._rings.get(key)
        if ring is None:
            if len(self._rings) >= self.max_groups:
                self._rings.popitem(last=False)
            ring = self._rings[key] = []
        else:
            self._rings.move_to_end(key)
        ring.append(float(actual))
        if len(ring) > self.window:
            del ring[: len(ring) - self.window]

    def _samples(self, tenant: str, priority: int) -> "list[float]":
        ring = self._rings.get((tenant, int(priority)))
        if ring:
            return ring
        merged: list[float] = []
        for (t, _p), r in self._rings.items():
            if t == tenant:
                merged.extend(r)
        return merged

    def estimate(self, tenant: str, priority: int) -> "float | None":
        """The reserve amount this prior recommends, or ``None`` when
        it has never seen the tenant settle. Interactive → p99 of the
        window; everything else → mean."""
        samples = self._samples(tenant, priority)
        if not samples:
            return None
        if int(priority) == 0:  # admission.PRIORITY_INTERACTIVE
            ordered = sorted(samples)
            idx = min(len(ordered) - 1,
                      int(math.ceil(0.99 * len(ordered))) - 1)
            return ordered[max(idx, 0)]
        return sum(samples) / len(samples)

    def __len__(self) -> int:
        return len(self._rings)


class _Reservation:
    __slots__ = ("rid", "tenant", "key", "reserved", "a", "b", "ta",
                 "tb", "priority", "expires_at", "remaining",
                 "deadline_at")

    def __init__(self, rid: str, tenant: str, key: str, reserved: float,
                 a: float, b: float, ta: float, tb: float,
                 priority: int, expires_at: float,
                 remaining: float,
                 deadline_at: "float | None" = None) -> None:
        self.rid = rid
        self.tenant = tenant
        self.key = key
        self.reserved = reserved
        self.a = a
        self.b = b
        self.ta = ta
        self.tb = tb
        self.priority = priority
        self.expires_at = expires_at
        self.remaining = remaining
        #: Ledger-clock instant the CLIENT's propagated budget runs out
        #: (None when the reserve carried no deadline). Settles after it
        #: are useless work — the goodput sensor's raw signal.
        self.deadline_at = deadline_at


class ReservationLedger:
    """The server-side reservation state for ONE store (module
    docstring). Bounded everywhere: ``max_entries`` outstanding holds
    (overflow reserves are DENIED, loudly counted — availability of the
    metered path over unbounded ledger growth), ``max_settled`` retry-
    dedup records (oldest evicted), the prior's own caps. One asyncio
    lock serializes reserve/settle bodies — their dedup checks span
    store awaits, the placement ``_control_lock`` posture."""

    def __init__(self, store, *, max_entries: int = 65536,
                 default_ttl_s: float = DEFAULT_TTL_S,
                 default_estimate: float = DEFAULT_ESTIMATE,
                 max_settled: int = 8192,
                 clock: Callable[[], float] = time.monotonic,
                 flight_recorder=None, velocity=None,
                 liveconfig=None) -> None:
        if max_entries < 1 or max_settled < 1:
            raise ValueError("ledger bounds must be >= 1")
        if default_ttl_s <= 0:
            raise ValueError("default_ttl_s must be positive")
        self._store = store
        self.max_entries = max_entries
        self.default_ttl_s = float(default_ttl_s)
        self.default_estimate = float(default_estimate)
        self.max_settled = max_settled
        self._clock = clock
        self.flight_recorder = flight_recorder
        #: Optional TokenVelocity: settles feed it at the ACTUAL cost —
        #: the true spend, which is what the velocity signal promises
        #: (the reserve-time estimate is covered by the outstanding
        #: gauge instead, closing the sensing gap the module docstring
        #: names).
        self.velocity = velocity
        #: Optional liveconfig.ConfigState: settle-time config
        #: translation (lazy re-home through committed rules).
        self.liveconfig = liveconfig
        self._entries: dict[str, _Reservation] = {}
        #: (expires_at, rid) min-heap; entries validate lazily (a
        #: settled rid's heap row is simply skipped).
        self._expiry: list[tuple[float, str]] = []
        #: rid → recorded SettleResult fields (retry dedup).
        self._settled: "OrderedDict[str, SettleResult]" = OrderedDict()
        self._debts: dict[str, float] = {}
        #: tenant → outstanding reserved tokens (maintained O(1)).
        self._outstanding: dict[str, float] = {}
        #: Holds of the settles in flight: dropped from their entry, their
        #: settled/refund/overage flows not recorded yet. Counted as
        #: outstanding, so the flow identity closes at every await of a
        #: settle (the conservation auditor ticks between them).
        self._settling = 0.0
        self.prior = EstimatePrior()
        self._lock = asyncio.Lock()
        # Visible counters (OP_STATS "reservations" + drl_reservation_*).
        # MONOTONIC — never cleared by stats(reset=True) (the
        # monotonic-counter contract; test-pinned).
        self.reserves = 0
        self.reserve_denied = 0
        self.reserve_duplicates = 0
        self.ledger_full_denials = 0
        self.debt_denials = 0
        self.settles = 0
        self.settle_duplicates = 0
        self.settle_unknown = 0
        self.ttl_expired = 0
        self.refunds = 0
        self.refunded_tokens = 0.0
        self.debts_created = 0
        self.debt_tokens_created = 0.0
        self.debt_tokens_collected = 0.0
        self.rehomed = 0
        self.aborted_imports = 0
        self.reserved_tokens_total = 0.0
        self.settled_tokens_total = 0.0
        # Movement counters closing the conservation identity the audit
        # plane checks every tick (runtime/audit.py, DESIGN.md §22):
        #   reserved + restored_in + extra_debited ==
        #   settled + refunded + exported_out + dropped + forfeited
        #   + outstanding
        # Each names one flow across the ledger boundary that the
        # pre-existing counters above do not witness; without them the
        # identity only closes cluster-wide (migration flows cancel),
        # not per node — and per node is where the auditor runs.
        #: Settle-time overage debits (actual > reserved): tokens that
        #: entered the settled total without ever being held.
        self.extra_debited_tokens = 0.0
        #: Holds shipped out via migration export (placement pull).
        self.exported_tokens_out = 0.0
        #: Holds adopted via migration import / abort restore.
        self.restored_tokens_in = 0.0
        #: Holds dropped unsettled by a migration abort (drop_rids).
        self.dropped_tokens = 0.0
        #: Unspent holds a store without a negative-debit lane could
        #: not credit back — under-admission, counted so the identity
        #: still closes.
        self.forfeited_tokens = 0.0
        # Goodput plane (docs/DESIGN.md §24): first-attempt vs retry
        # admission, and how grants relate to their clients' propagated
        # deadlines — the controller's goodput sensor reads these.
        #: Grants whose reserve carried attempt == 0 (or no counter).
        self.first_attempt_grants = 0
        #: Grants whose reserve carried attempt >= 1 — tokens handed to
        #: retry traffic, the storm's amplification signal.
        self.retry_grants = 0
        #: Reserve calls (granted or not) stamped attempt >= 1.
        self.retry_reserves = 0
        #: Settles that landed AT OR BEFORE the recorded deadline —
        #: useful work, the goodput numerator's ledger half.
        self.settled_in_deadline = 0
        #: Settles that landed AFTER the recorded deadline: the client
        #: was already gone — granted-but-useless work.
        self.settled_late = 0
        #: TTL-expired entries whose deadline had passed: grants that
        #: burned their hold with no settle inside the client's budget.
        self.deadline_expired_grants = 0
        #: Settle-error magnitudes, log-1.25 bucketed. The histogram
        #: class buckets from 1e-6, so values record at ``tokens × 1e-6``
        #: — quantiles read back ×1e6 (refund_p99_tokens et al).
        self.refund_hist = LatencyHistogram()
        self.debt_hist = LatencyHistogram()

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> bool:
        """True once the ledger has ever seen traffic (gates the
        OP_STATS section so unused servers keep their old shape)."""
        return bool(self.reserves or self.settles or self._entries
                    or self._debts)

    def outstanding_count(self) -> int:
        return len(self._entries)

    def outstanding_tokens(self) -> float:
        """Tokens held: the outstanding reserves' holds, and those of the
        settles still in flight (see :meth:`settle`)."""
        return sum(self._outstanding.values()) + self._settling

    def outstanding_by_tenant(self) -> dict[str, float]:
        return dict(self._outstanding)

    def debts(self) -> dict[str, float]:
        return dict(self._debts)

    # -- config re-homing (OP_CONFIG rebase) ---------------------------------
    def _cfg(self, a: float, b: float) -> tuple[float, float]:
        """Translate a possibly-retired bucket config through the
        committed forwarding rules to its fixpoint — the lazy half of
        the OP_CONFIG rebase: the commit already re-homed the BALANCES
        through the rebase debit (liveconfig), so a settle's refund or
        extra debit must land in the table they moved to. Counted when
        a translation actually applies."""
        lc = self.liveconfig
        if lc is None or not lc.active:
            return a, b
        seen: set[tuple[float, float]] = set()
        pair = (float(a), float(b))
        while pair not in seen:
            seen.add(pair)
            fwd = lc.forward("bucket", pair[0], pair[1])
            if fwd is None:
                break
            pair = (float(fwd[0]), float(fwd[1]))
        if pair != (float(a), float(b)):
            self.rehomed += 1
        return pair

    # -- TTL expiry (sync: an expiry applies NO store adjustment) ------------
    def expire(self, now: "float | None" = None) -> int:
        """Auto-settle every expired reservation at its estimate.
        Delta zero by construction — the hold becomes the spend, no
        store call needed — so this is synchronous and piggybacks on
        every ledger touch plus the stats scrape. Returns the number
        expired."""
        now = self._clock() if now is None else now
        n = 0
        while self._expiry and self._expiry[0][0] <= now:
            _, rid = heapq.heappop(self._expiry)
            entry = self._entries.get(rid)
            if entry is None or entry.expires_at > now:
                continue  # settled already, or TTL extended — stale row
            self._drop_entry(entry)
            result = SettleResult("expired", 0.0, 0.0,
                                  self._debts.get(entry.tenant, 0.0))
            self._record_settled(rid, result)
            self.ttl_expired += 1
            if entry.deadline_at is not None and now > entry.deadline_at:
                self.deadline_expired_grants += 1
            self.settles += 1
            self.settled_tokens_total += entry.reserved
            if self.velocity is not None and entry.reserved > 0:
                self.velocity.observe(entry.tenant, entry.reserved)
            if self.flight_recorder is not None:
                self.flight_recorder.record(
                    "reservation", event="ttl_expired", rid=rid,
                    tenant=entry.tenant, reserved=entry.reserved)
            n += 1
        return n

    def _drop_entry(self, entry: _Reservation) -> None:
        self._entries.pop(entry.rid, None)
        out = self._outstanding.get(entry.tenant, 0.0) - entry.reserved
        if out <= 1e-9:
            self._outstanding.pop(entry.tenant, None)
        else:
            self._outstanding[entry.tenant] = out

    def _add_entry(self, entry: _Reservation) -> None:
        self._entries[entry.rid] = entry
        self._outstanding[entry.tenant] = \
            self._outstanding.get(entry.tenant, 0.0) + entry.reserved
        heapq.heappush(self._expiry, (entry.expires_at, entry.rid))

    def _record_settled(self, rid: str, result: SettleResult) -> None:
        self._settled[rid] = result
        while len(self._settled) > self.max_settled:
            self._settled.popitem(last=False)

    # -- reserve -------------------------------------------------------------
    async def reserve(self, rid: str, tenant: str, key: str,
                      estimate: "float | None",
                      tenant_capacity: float,
                      tenant_fill_rate_per_sec: float,
                      capacity: float, fill_rate_per_sec: float, *,
                      priority: int = 0,
                      ttl_s: "float | None" = None,
                      attempt: int = 0,
                      deadline_s: "float | None" = None) -> ReserveResult:
        """One admission-at-estimate decision + ledger hold (module
        docstring). Outstanding tenant debt is paid down FIRST through
        the saturating ``debit_many``; debt the budget cannot cover yet
        denies the reserve (the tenant is over budget — the same answer
        its empty bucket would give, reported honestly as debt).
        ``attempt`` fingerprints retries (0 = first attempt — the
        retry-stable rid plus the wire attempt tail); ``deadline_s`` is
        the client's remaining budget, recorded so the settle can be
        judged useful-or-late (the goodput sensor's input)."""
        if not rid:
            raise ValueError("reservation id must be non-empty")
        async with self._lock:
            now = self._clock()
            self.expire(now)
            dup = self._duplicate_reserve(rid, tenant)
            if dup is not None:
                return dup
            self.reserves += 1
            if attempt:
                self.retry_reserves += 1
            debt = self._debts.get(tenant, 0.0)
            ta, tb = self._cfg(tenant_capacity, tenant_fill_rate_per_sec)
            a, b = self._cfg(capacity, fill_rate_per_sec)
            if debt >= 1.0:
                debt = await self._collect_debt(tenant, debt, ta, tb)
                if debt >= 1.0:
                    # The budget could not even cover the existing debt:
                    # new admission would deepen the overdraft.
                    self.debt_denials += 1
                    self.reserve_denied += 1
                    return ReserveResult(False, 0.0, 0.0, debt)
            est = float(estimate) if estimate and estimate > 0 else None
            if est is None:
                est = self.prior.estimate(tenant, priority)
            if est is None:
                est = self.default_estimate
            charge = max(1, int(math.ceil(est)))
            if len(self._entries) >= self.max_entries:
                # Bounded ledger: deny loudly rather than grow without
                # limit (a reserve flood that never settles is exactly
                # the shape the TTL + this cap exist for).
                self.ledger_full_denials += 1
                self.reserve_denied += 1
                if self.flight_recorder is not None:
                    self.flight_recorder.record(
                        "reservation", event="ledger_full", rid=rid,
                        tenant=tenant, entries=len(self._entries))
                return ReserveResult(False, 0.0, 0.0, debt)
            res = await self._store.acquire_hierarchical(
                tenant, key, charge, ta, tb, a, b, priority=priority)
            if not res.granted:
                self.reserve_denied += 1
                return ReserveResult(False, 0.0, res.remaining, debt)
            ttl = self.default_ttl_s if ttl_s is None else float(ttl_s)
            self._add_entry(_Reservation(
                rid, tenant, key, float(charge), a, b, ta, tb,
                int(priority), now + ttl, res.remaining,
                (now + float(deadline_s)) if deadline_s is not None
                and deadline_s > 0 else None))
            self.reserved_tokens_total += charge
            if attempt:
                self.retry_grants += 1
            else:
                self.first_attempt_grants += 1
            return ReserveResult(True, float(charge), res.remaining,
                                 debt)

    def _duplicate_reserve(self, rid: str,
                           tenant: str) -> "ReserveResult | None":
        entry = self._entries.get(rid)
        if entry is not None:
            self.reserve_duplicates += 1
            return ReserveResult(True, entry.reserved, entry.remaining,
                                 self._debts.get(tenant, 0.0),
                                 duplicate=True)
        settled = self._settled.get(rid)
        if settled is not None:
            # A reserve retry that arrives AFTER its settle (or TTL):
            # the original was granted (only grants enter the ledger) —
            # answer granted without a second debit. The recorded delta
            # reconstructs the reserved amount where known.
            self.reserve_duplicates += 1
            return ReserveResult(True, 0.0, 0.0,
                                 self._debts.get(tenant, 0.0),
                                 duplicate=True)
        return None

    async def _collect_debt(self, tenant: str, debt: float,
                            ta: float, tb: float) -> float:
        """Pay tenant debt down through the saturating debit; the
        shortfall (tokens the bucket did not hold yet) stays owed."""
        debit = getattr(self._store, "debit_many", None)
        if not callable(debit):
            return debt  # no reconciliation lane: debt persists, deny
        _remaining, shortfall = await debit([tenant], [debt], ta, tb)
        left = float(shortfall[0])
        collected = debt - left
        if collected > 0:
            self.debt_tokens_collected += collected
        if left <= 1e-9:
            self._debts.pop(tenant, None)
            return 0.0
        self._debts[tenant] = left
        return left

    # -- settle --------------------------------------------------------------
    async def settle(self, rid: str, tenant: str,
                     actual: float) -> SettleResult:
        """Reconcile one reservation's actual cost (module docstring).
        Idempotent by rid: a duplicate replays the recorded result with
        ``outcome="duplicate"`` and zero side effects; an unknown rid
        (never reserved here, TTL'd out of the dedup window, or
        reserved through an old-peer fallback) is a counted no-op —
        the conservative direction, the hold was never refunded."""
        if actual < 0 or not math.isfinite(actual):
            raise ValueError("settle actual must be finite and >= 0")
        async with self._lock:
            now = self._clock()
            self.expire(now)
            recorded = self._settled.get(rid)
            if recorded is not None:
                self.settle_duplicates += 1
                return recorded._replace(outcome="duplicate")
            entry = self._entries.get(rid)
            if entry is None:
                self.settle_unknown += 1
                return SettleResult("unknown", 0.0, 0.0,
                                    self._debts.get(tenant, 0.0))
            self._drop_entry(entry)
            if entry.deadline_at is not None:
                if now > entry.deadline_at:
                    self.settled_late += 1
                else:
                    self.settled_in_deadline += 1
            self._settling += entry.reserved
            try:
                result = await self._settle_entry(entry, float(actual))
            finally:
                # Same step as _settle_entry's last bookkeeping: no await
                # lies between them.
                self._settling -= entry.reserved
            self._record_settled(rid, result)
            return result

    async def _settle_entry(self, entry: _Reservation,
                            actual: float) -> SettleResult:
        delta = actual - entry.reserved
        refunded = 0.0
        debit = getattr(self._store, "debit_many", None)
        # Settle-time config translation: a commit between reserve and
        # settle moved the balances — follow them (module docstring).
        ta, tb = self._cfg(entry.ta, entry.tb)
        a, b = self._cfg(entry.a, entry.b)
        if delta < 0.0:
            # Over-estimate: credit the unspent hold back to BOTH
            # levels through the saturating negative-debit lane — the
            # EXACT delta, fractions included (skipping sub-token
            # residue would drift the settled-vs-balance accounting
            # without bound over many streams). The next refill's
            # capacity clamp bounds any overshoot — the refund can
            # only under-credit (the refund contract).
            refund = -delta
            if callable(debit):
                await debit([entry.key], [-refund], a, b)
                await debit([entry.tenant], [-refund], ta, tb)
                refunded = refund
                self.refunds += 1
                self.refunded_tokens += refund
                self.refund_hist.record(refund * 1e-6)
            else:
                # No negative-debit lane: the hold cannot be credited
                # back. Under-admission (the safe direction), but it
                # must be WITNESSED or the conservation identity reads
                # it as a leak.
                self.forfeited_tokens += refund
        elif delta > 0.0:
            # Under-estimate: charge the overage now. Child shortfall
            # saturates silently (the key bucket can at worst sit at
            # zero); the TENANT shortfall is the real overdraft and
            # becomes debt the next reserve must cover.
            if callable(debit):
                await debit([entry.key], [delta], a, b)
                _rem, short = await debit([entry.tenant], [delta],
                                          ta, tb)
                owed = float(short[0])
            else:
                owed = delta  # no debit lane: carry the whole overage
            if owed > 1e-9:
                self._debts[entry.tenant] = \
                    self._debts.get(entry.tenant, 0.0) + owed
                self.debts_created += 1
                self.debt_tokens_created += owed
            # The overage is an INFLOW across the ledger boundary
            # (settled will exceed the hold by exactly this much) —
            # witnessed whether the debit lane existed or the tenant
            # shortfall became debt.
            self.extra_debited_tokens += delta
            self.debt_hist.record(delta * 1e-6)
        self.settles += 1
        self.settled_tokens_total += actual
        self.prior.observe(entry.tenant, entry.priority, actual)
        if self.velocity is not None and actual > 0:
            self.velocity.observe(entry.tenant, actual)
        if self.flight_recorder is not None and abs(delta) >= 1.0:
            self.flight_recorder.record(
                "reservation", event="settle", rid=entry.rid,
                tenant=entry.tenant, reserved=entry.reserved,
                actual=actual, refunded=refunded,
                debt=self._debts.get(entry.tenant, 0.0))
        return SettleResult("settled", delta, refunded,
                            self._debts.get(entry.tenant, 0.0))

    # -- migration export/import (placement entry sections) ------------------
    def export_rows(self, keep: Callable[[str], bool],
                    tag: "str | None" = None) -> tuple[list, list]:
        """Remove and return the ledger rows whose TENANT ``keep``
        selects — the MIGRATE_PULL half. Reservation rows carry the
        remaining TTL (ages, never absolute times: the two processes'
        clocks never compare — invariant 1); debt rows are
        ``[tenant, amount, tag]`` — ``tag`` names the export episode
        (the pull's target epoch) so a re-delivery dedups: reservation
        rows have their rid for that, but a debt restored on abort and
        re-exported by the same-epoch retry would otherwise DOUBLE at
        the new owner (whose copy of attempt 1's chunk already
        landed). The caller stashes what it got for a possible abort
        restore (:meth:`restore_rows`)."""
        now = self._clock()
        res_rows = []
        for entry in [e for e in self._entries.values()
                      if keep(e.tenant)]:
            self._drop_entry(entry)
            self.exported_tokens_out += entry.reserved
            res_rows.append([entry.tenant, entry.rid, entry.key,
                             entry.reserved, entry.a, entry.b,
                             entry.ta, entry.tb, entry.priority,
                             max(0.1, entry.expires_at - now)])
        debt_rows = [[t, amt, tag] for t, amt in self._debts.items()
                     if keep(t)]
        for t, _amt, _tag in debt_rows:
            del self._debts[t]
        return res_rows, debt_rows

    def drop_rids(self, rids) -> int:
        """Remove outstanding entries for ``rids`` without settling —
        the destination half of a migration ABORT (placement.py
        ``_abort``): rows this node imported for the aborted epoch go
        back out, because the source's stash restore (or the retry's
        re-export) is each rid's single surviving home. Settled
        records stay (a dedup answer is still correct); unknown rids
        are skipped. Counted, returns the number dropped."""
        n = 0
        for rid in rids:
            entry = self._entries.get(str(rid))
            if entry is not None:
                self._drop_entry(entry)
                self.dropped_tokens += entry.reserved
                n += 1
        self.aborted_imports += n
        return n

    #: Seen (tag, tenant) debt deliveries kept for dedup (bounded).
    _DEBT_SEEN_CAP = 4096

    def restore_rows(self, res_rows, debt_rows) -> int:
        """Adopt exported rows — the abort-restore AND the new owner's
        MIGRATE_PUSH import (both sides re-anchor the TTL against their
        own clock). A rid already present (a duplicate push chunk that
        slipped past the batch dedup, or an abort racing a late push)
        keeps the FIRST copy — re-adding would double the outstanding
        gauge. A TAGGED debt row applies once per (tag, tenant) —
        attempt 2 of an aborted migration re-ships the restored debt
        under attempt 1's tag, and the owner that already holds it
        skips the copy; untagged rows (legacy peers) merge additively.
        Returns rows adopted."""
        now = self._clock()
        n = 0
        for row in res_rows or ():
            # Row layout (placement.py _EMPTY_ENTRIES note): tenant
            # FIRST — it is the routing identity split_entries keys on.
            tenant, rid, key, reserved, a, b, ta, tb, prio, ttl = row
            if rid in self._entries or rid in self._settled:
                continue
            self._add_entry(_Reservation(
                str(rid), str(tenant), str(key), float(reserved),
                float(a), float(b), float(ta), float(tb), int(prio),
                now + float(ttl), 0.0))
            self.restored_tokens_in += float(reserved)
            n += 1
        seen = getattr(self, "_debt_seen", None)
        if seen is None:
            seen = self._debt_seen = OrderedDict()
        for row in debt_rows or ():
            tenant, amt = str(row[0]), float(row[1])
            tag = row[2] if len(row) > 2 else None
            if amt <= 0:
                continue
            if tag is not None:
                if (tag, tenant) in seen:
                    continue
                seen[(tag, tenant)] = True
                while len(seen) > self._DEBT_SEEN_CAP:
                    seen.popitem(last=False)
            self._debts[tenant] = self._debts.get(tenant, 0.0) + amt
            n += 1
        return n

    # -- conservation (runtime/audit.py, DESIGN.md §22) ----------------------
    def conservation(self) -> dict:
        """The ledger's flow identity, closed per node: every token
        that crossed INTO the ledger boundary (a reserve hold, an
        adopted migration row, a settle-time overage debit) must be
        findable on the way OUT (settled spend, refund, export, abort
        drop, forfeit) or still held (outstanding). ``residue`` is
        inflow − outflow — zero up to f64 noise, ANY sign of drift is
        a ledger bug (there is no ε term here; estimate error shows up
        as refunds/debts, both witnessed flows)."""
        inflow = (self.reserved_tokens_total + self.restored_tokens_in
                  + self.extra_debited_tokens)
        outflow = (self.settled_tokens_total + self.refunded_tokens
                   + self.exported_tokens_out + self.dropped_tokens
                   + self.forfeited_tokens + self.outstanding_tokens())
        return {
            "inflow": inflow,
            "outflow": outflow,
            "residue": inflow - outflow,
            "reserved": self.reserved_tokens_total,
            "restored_in": self.restored_tokens_in,
            "extra_debited": self.extra_debited_tokens,
            "settled": self.settled_tokens_total,
            "refunded": self.refunded_tokens,
            "exported_out": self.exported_tokens_out,
            "dropped": self.dropped_tokens,
            "forfeited": self.forfeited_tokens,
            "outstanding": self.outstanding_tokens(),
        }

    # -- stats ---------------------------------------------------------------
    def numeric_stats(self) -> dict:
        """Flat numeric dict for ``register_numeric_dict`` — the
        ``drl_reservation_*`` families."""
        return {
            "reserves": self.reserves,
            "reserve_denied": self.reserve_denied,
            "reserve_duplicates": self.reserve_duplicates,
            "ledger_full_denials": self.ledger_full_denials,
            "debt_denials": self.debt_denials,
            "settles": self.settles,
            "settle_duplicates": self.settle_duplicates,
            "settle_unknown": self.settle_unknown,
            "ttl_expired": self.ttl_expired,
            "refunds": self.refunds,
            "refunded_tokens": self.refunded_tokens,
            "debts_created": self.debts_created,
            "debt_tokens_created": self.debt_tokens_created,
            "debt_tokens_collected": self.debt_tokens_collected,
            "rehomed": self.rehomed,
            "aborted_imports": self.aborted_imports,
            "reserved_tokens_total": self.reserved_tokens_total,
            "settled_tokens_total": self.settled_tokens_total,
            "extra_debited_tokens": self.extra_debited_tokens,
            "exported_tokens_out": self.exported_tokens_out,
            "restored_tokens_in": self.restored_tokens_in,
            "dropped_tokens": self.dropped_tokens,
            "forfeited_tokens": self.forfeited_tokens,
            "outstanding": float(len(self._entries)),
            "outstanding_tokens": self.outstanding_tokens(),
            "debt_tokens": sum(self._debts.values()),
            "first_attempt_grants": self.first_attempt_grants,
            "retry_grants": self.retry_grants,
            "retry_reserves": self.retry_reserves,
            "settled_in_deadline": self.settled_in_deadline,
            "settled_late": self.settled_late,
            "deadline_expired_grants": self.deadline_expired_grants,
        }

    def stats(self) -> dict:
        """JSON-shaped summary for OP_STATS embedding (piggybacks one
        expiry pass so a scraped-but-idle server still expires)."""
        self.expire()
        out = self.numeric_stats()
        out["debts"] = {t: round(v, 3)
                        for t, v in sorted(self._debts.items())}
        out["outstanding_by_tenant"] = {
            t: round(v, 3)
            for t, v in sorted(self._outstanding.items())}
        # Settle-error quantiles, read back in TOKENS (recorded ×1e-6).
        for name, hist in (("refund", self.refund_hist),
                           ("debt", self.debt_hist)):
            if hist.total:
                out[f"{name}_p50_tokens"] = round(hist.p50 * 1e6, 1)
                out[f"{name}_p99_tokens"] = round(hist.p99 * 1e6, 1)
        return out
