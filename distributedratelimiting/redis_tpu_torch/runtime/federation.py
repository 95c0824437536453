"""Global quota federation — the WAN lease ledger, ported whole from the
JAX package's ``runtime/federation.py`` with its names and ``__all__``
(docs/OPERATIONS.md §16, DESIGN.md §20).

The ApproximateTokenBucket posture — decide locally at full speed,
reconcile with the authority asynchronously, bound the error — lifted one
level above the cluster, to global tenant budgets that span regions:

- One **home** region hosts a :class:`FederationLedger` over its ordinary
  store (``store.federation_ledger()``: the global tenant budget is a
  plain bucket in the home's store) that leases **slices** of each global
  tenant budget to regional clusters.
- A **slice is a live-mutable bucket config** ``(slice_cap,
  slice_rate)``: the region serves the tenant from it with the existing
  data plane (on a card store the flush kernels, ``acquire_packed`` /
  ``acquire_grouped``), and every slice change is an ordinary
  ``OP_CONFIG`` commit (:func:`slice_applier`) whose rebase runs through
  ``debit_many`` (``debit_packed``); in-flight regional clients chase one
  routable "config moved" error.
- Regions **renew** asynchronously over the WAN (``OP_FED_RENEW``),
  reporting their *monotonic* admitted-token total and current demand;
  the home charges the delta against the global bucket through the
  saturating ``debit_many`` lane (one ``debit_packed`` launch on a card
  store) and re-sizes slices demand-proportionally.

**When the WAN link fails:**

- Lease TTLs are measured in **monotonic local time** on BOTH ends and
  no absolute timestamp crosses the wire (``ttl_s`` is relative), so WAN
  clock skew can neither extend nor prematurely kill a lease. ``expire``
  reads ``self._clock`` only, statement for statement JAX's; the
  clock-skew tests (the ``utils/faults.py`` seam) pin it.
- A region partitioned from the home serves its current slice until the
  lease expires, then **degrades to a fair-share envelope**: the slice
  config is rewritten (the same ``OP_CONFIG`` lane) to
  ``headroom_budget(slice_cap, fraction)`` refilled at ``fraction ×
  slice_rate``. Never unlimited, never hard-down.
- The home **treats an unreachable region's slice as fully spent**: an
  expired lease's unreported entitlement is charged to the global bucket
  (:meth:`FederationLedger._conservative_charge`), so Σ regional admits
  ≤ global cap + ε(RTT, lease_len) holds through the partition.
- **Heal reconciles through the settle lane**: the region's next contact
  reports its true total; the home refunds the over-charge through the
  saturating negative debit and turns any overdraft into per-(tenant,
  region) **debt** a new lease must pay down first.

**Idempotency:** ``lease`` replays a granted lease id's recorded grant;
``reclaim`` replays a recorded reclaim (at most one refund per lease);
``renew`` is absorbing — monotonic totals make a replayed report a zero
delta, and slice changes carry an epoch the region adopts only forward.

**The ε(RTT, lease_len) bound:** over a window of length T, Σ regional
admits ≤ global_cap + global_rate × T + ε, with ε from
:func:`federation_epsilon`: per region, one renew period of report
staleness at the slice rate plus, past lease expiry, the degraded
envelope's burst and refill.

Lease state **rides the checkpoint chain**: :mod:`~.checkpoint` snapshots
an active ledger's exported state beside the bucket tables (the
``"federation"`` section) — TTLs export as remaining ages and re-anchor
against the restarted process's monotonic clock, so a home restart resumes
every lease, never extended.

One difference from the JAX module: ``export_state`` also carries the
cover identity's left side (``"conservation": {"accounted": charged −
refunded}``) and ``restore_state`` resumes from it. The charge counters are
per process while the regions' reported totals ride the chain, so in JAX a
home restarted between a partition's conservative charge and its heal
reads the heal's refund against no charge: a negative residue, a false
federation breach in the audit. Each package reads the other's state (JAX
ignores the section; a state without it resumes at zero, JAX's reading)."""

from __future__ import annotations

import asyncio
import math
import time
from collections import OrderedDict
from typing import Callable, Mapping

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
)
from distributedratelimiting.redis_tpu_torch.utils import faults, log

__all__ = [
    "FederationLedger", "RegionFederation", "Lease",
    "DEFAULT_LEASE_TTL_S", "DEFAULT_ENVELOPE_FRACTION",
    "DEFAULT_MIN_SHARE", "degraded_config", "federation_epsilon",
    "slice_applier",
]

#: Default lease term. Short enough that a partitioned region degrades
#: to its envelope within one operator glance; long enough that a WAN
#: renew every ``renew_fraction × ttl`` is control-plane cadence, not
#: data-plane load.
DEFAULT_LEASE_TTL_S = 10.0

#: Fair-share fraction of the degraded envelope — the SAME default as
#: the placement handoff envelope and the cluster's breaker-quarantine
#: fallback (one confidence-policy family, DESIGN.md §12/§20).
DEFAULT_ENVELOPE_FRACTION = 0.5

#: Smallest slice share a live region is ever squeezed to by the
#: demand-proportional sizing — a quiet region keeps a floor, so a
#: demand spike elsewhere can never zero it out (never hard-down).
DEFAULT_MIN_SHARE = 0.05

#: A slice resize below this relative change is suppressed — config
#: churn hysteresis: every resize is an OP_CONFIG mutation the region's
#: clients chase, so jittering demand must not thrash the gates.
DEFAULT_RESIZE_THRESHOLD = 0.2


def degraded_config(slice_cap: float, slice_rate: float,
                    fraction: float = DEFAULT_ENVELOPE_FRACTION
                    ) -> tuple[float, float]:
    """The partition-expiry envelope as a BUCKET CONFIG: a
    ``headroom_budget(slice_cap, fraction)`` burst (floored at one
    token — never hard-down) refilled at ``fraction × slice_rate`` —
    :func:`placement.envelope_step`'s exact arithmetic expressed as
    the ``(cap, rate)`` operands the existing data plane already
    serves, so degrading is just one more live config mutation."""
    cap = headroom_budget(slice_cap, fraction=fraction, min_budget=1.0)
    return (max(1.0, cap), max(0.0, slice_rate) * fraction)


def federation_epsilon(n_regions: int, slice_cap: float,
                       slice_rate: float, renew_period_s: float,
                       partition_s: float = 0.0,
                       fraction: float = DEFAULT_ENVELOPE_FRACTION
                       ) -> float:
    """Worst-case over-admission of the federated bound past
    ``global_cap + global_rate × T`` (module docstring; DESIGN.md §20
    derives it term by term): per region, one renew period of report
    staleness at the slice rate — the WAN edition of the tier-0
    sync-staleness term, with the RTT inside ``renew_period_s`` — plus,
    for a partition of length ``partition_s`` past lease expiry, the
    degraded envelope's burst and refill."""
    staleness = slice_rate * renew_period_s
    envelope = 0.0
    if partition_s > 0.0:
        env_cap, env_rate = degraded_config(slice_cap, slice_rate,
                                            fraction)
        envelope = env_cap + env_rate * partition_s
    return n_regions * (staleness + envelope)


class Lease:
    """One outstanding slice lease at the home ledger."""

    __slots__ = ("lease_id", "tenant", "region", "epoch", "share",
                 "slice_cap", "slice_rate", "expires_mono",
                 "last_report_mono", "reported_total", "demand",
                 "ttl_s")

    def __init__(self, lease_id: str, tenant: str, region: str,
                 epoch: int, share: float, slice_cap: float,
                 slice_rate: float, expires_mono: float,
                 last_report_mono: float, reported_total: float,
                 demand: float, ttl_s: float) -> None:
        self.lease_id = lease_id
        self.tenant = tenant
        self.region = region
        self.epoch = epoch
        self.share = share
        self.slice_cap = slice_cap
        self.slice_rate = slice_rate
        self.expires_mono = expires_mono
        self.last_report_mono = last_report_mono
        self.reported_total = reported_total
        self.demand = demand
        self.ttl_s = ttl_s

    def slice(self) -> tuple[float, float]:
        return (self.slice_cap, self.slice_rate)

    def to_row(self, now: float) -> dict:
        """Checkpoint row — ages, never absolute times (the two
        processes' clocks never compare; invariant 1)."""
        return {
            "lease_id": self.lease_id, "tenant": self.tenant,
            "region": self.region, "epoch": self.epoch,
            "share": self.share, "slice_cap": self.slice_cap,
            "slice_rate": self.slice_rate,
            "expires_in": max(0.0, self.expires_mono - now),
            "reported_in": max(0.0, now - self.last_report_mono),
            "reported_total": self.reported_total,
            "demand": self.demand, "ttl_s": self.ttl_s,
        }

    @classmethod
    def from_row(cls, row: Mapping, now: float) -> "Lease":
        return cls(str(row["lease_id"]), str(row["tenant"]),
                   str(row["region"]), int(row["epoch"]),
                   float(row["share"]), float(row["slice_cap"]),
                   float(row["slice_rate"]),
                   now + float(row.get("expires_in", 0.0)),
                   now - float(row.get("reported_in", 0.0)),
                   float(row.get("reported_total", 0.0)),
                   float(row.get("demand", 0.0)),
                   float(row.get("ttl_s", DEFAULT_LEASE_TTL_S)))


class _TenantPool:
    """One global tenant budget's federation state at the home."""

    __slots__ = ("cap", "rate", "leases", "epoch_seq")

    def __init__(self, cap: float, rate: float) -> None:
        self.cap = cap
        self.rate = rate
        self.leases: "dict[str, Lease]" = {}   # region → lease
        self.epoch_seq = 0

    def free_share(self, exclude: "str | None" = None) -> float:
        used = sum(l.share for r, l in self.leases.items()
                   if r != exclude)
        return max(0.0, 1.0 - used)


class FederationLedger:
    """The home side of the federation (module docstring): grants,
    renews, expires, and reclaims slice leases of global tenant
    budgets, charging reported (and conservatively presumed) spends
    against the home store's ordinary per-tenant buckets through the
    saturating ``debit_many`` lane. One asyncio lock serializes the
    control bodies (their dedup probes span store awaits — the
    placement ``_control_lock`` posture); :meth:`expire` is synchronous
    and piggybacks on every touch plus the stats scrape, keyed on the
    MONOTONIC clock only."""

    #: Bounded idempotency records (the reservations `_settled` cap
    #: posture): recorded grants by lease_id and recorded reclaims.
    _GRANTS_CAP = 4096
    _RECLAIMS_CAP = 4096

    def __init__(self, store, *,
                 default_ttl_s: float = DEFAULT_LEASE_TTL_S,
                 min_share: float = DEFAULT_MIN_SHARE,
                 resize_threshold: float = DEFAULT_RESIZE_THRESHOLD,
                 initial_share_fraction: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 flight_recorder=None, velocity=None) -> None:
        if default_ttl_s <= 0:
            raise ValueError("default_ttl_s must be positive")
        if not 0.0 < min_share <= 1.0:
            raise ValueError("min_share must be in (0, 1]")
        if not 0.0 < initial_share_fraction <= 1.0:
            raise ValueError("initial_share_fraction must be in (0, 1]")
        self._store = store
        self.default_ttl_s = float(default_ttl_s)
        self.min_share = float(min_share)
        self.resize_threshold = float(resize_threshold)
        #: A NEW lease takes at most this fraction of the currently
        #: free pool: the first region to arrive must not grab the
        #: whole budget (later joiners would be denied until its next
        #: renew shrank it) — renews then converge every region to its
        #: demand-proportional share, which is where lending/borrowing
        #: actually happens.
        self.initial_share_fraction = float(initial_share_fraction)
        #: MONOTONIC lease clock — THE clock every expiry decision
        #: reads. ``wall`` exists for human-facing stats timestamps
        #: only and must never reach a TTL comparison (the clock-skew
        #: tests in tests/test_torch_federation.py pin it on both
        #: packages).
        self._clock = clock
        self._wall = wall
        self.flight_recorder = flight_recorder
        #: Optional TokenVelocity: reported regional spends feed it, so
        #: the home's drl_token_velocity reflects GLOBAL per-tenant
        #: spend across every region.
        self.velocity = velocity
        self._pools: "dict[str, _TenantPool]" = {}
        self._grants: "OrderedDict[str, dict]" = OrderedDict()
        self._reclaimed: "OrderedDict[str, dict]" = OrderedDict()
        #: Expired leases pending heal, by lease_id: the conservative
        #: charge stays reconcilable until the region reports its true
        #: total (bounded; oldest forfeited — their over-charge is
        #: never refunded, the conservative direction).
        self._expired: "OrderedDict[str, dict]" = OrderedDict()
        #: (tenant, region) → highest reported monotonic total. THE
        #: baseline that makes renew deltas correct ACROSS lease
        #: generations: a fresh lease after a heal (or a replacement)
        #: continues the region's counter instead of restarting at
        #: zero — restarting would re-charge everything the heal
        #: already reconciled (soak-caught double count). Rides the
        #: checkpoint with the leases.
        self._region_totals: "OrderedDict[tuple, float]" = OrderedDict()
        self._debts: "dict[tuple[str, str], float]" = {}
        self._lock = asyncio.Lock()
        # Visible counters (OP_STATS "federation" + drl_federation_*).
        # MONOTONIC — never cleared by stats(reset=True).
        self.leases_granted = 0
        self.lease_duplicates = 0
        self.lease_denied = 0
        self.renews = 0
        self.renew_unknown = 0
        self.resizes = 0
        self.reclaims = 0
        self.reclaim_duplicates = 0
        self.reclaim_unknown = 0
        self.leases_expired = 0
        self.heals = 0
        self.charged_tokens = 0.0
        self.conservative_tokens = 0.0
        self.refunded_tokens = 0.0
        self.debts_created = 0
        self.debt_tokens_created = 0.0
        self.debt_tokens_collected = 0.0
        self.restores = 0
        #: What the cover identity's left side held before the last
        #: restore (charged − refunded, carried in the checkpoint's
        #: ``conservation`` section): the counters above are per process,
        #: the regions' reported totals ride the chain.
        self._accounted_base = 0.0

    # -- introspection -------------------------------------------------------
    @property
    def active(self) -> bool:
        """True once the ledger has ever seen federation traffic
        (gates the OP_STATS section and the checkpoint section, so
        non-home servers keep their old shapes byte for byte)."""
        return bool(self._pools or self._grants or self._reclaimed
                    or self._debts)

    def outstanding_leases(self) -> int:
        return sum(len(p.leases) for p in self._pools.values())

    def shares(self) -> "list[tuple[str, str, float]]":
        """``(tenant, region, share)`` rows — the slice-utilization
        surface behind ``drl_federation_slice_share``."""
        return [(t, r, l.share)
                for t, p in sorted(self._pools.items())
                for r, l in sorted(p.leases.items())]

    def debts(self) -> "dict[tuple[str, str], float]":
        return dict(self._debts)

    def _set_region_total(self, tenant: str, region: str,
                          total: float) -> None:
        key = (tenant, region)
        cur = self._region_totals.get(key, 0.0)
        self._region_totals[key] = max(cur, float(total))
        self._region_totals.move_to_end(key)
        while len(self._region_totals) > self._GRANTS_CAP:
            self._region_totals.popitem(last=False)

    # -- store charging ------------------------------------------------------
    async def _charge(self, tenant: str, region: str, amount: float,
                      cap: float, rate: float) -> float:
        """Debit ``amount`` reported (or presumed) regional spend from
        the global tenant bucket; the part the bucket cannot cover
        becomes per-(tenant, region) debt. Returns the shortfall."""
        if amount <= 0:
            return 0.0
        self.charged_tokens += amount
        debit = getattr(self._store, "debit_many", None)
        if not callable(debit):   # pragma: no cover — every store has it
            return 0.0
        _rem, short = await debit([tenant], [amount], cap, rate)
        owed = float(short[0])
        if owed > 1e-9:
            key = (tenant, region)
            self._debts[key] = self._debts.get(key, 0.0) + owed
            self.debts_created += 1
            self.debt_tokens_created += owed
        return owed

    async def _refund(self, tenant: str, amount: float, cap: float,
                      rate: float) -> None:
        """Credit back an over-charge through the saturating
        negative-debit lane — the capacity clamp bounds any overshoot,
        so a refund can only under-credit (the PR-13 contract)."""
        if amount <= 0:
            return
        debit = getattr(self._store, "debit_many", None)
        if callable(debit):
            await debit([tenant], [-amount], cap, rate)
        self.refunded_tokens += amount

    async def _collect_debt(self, tenant: str, region: str,
                            cap: float, rate: float) -> float:
        """Pay down (tenant, region) debt from the global bucket; the
        remainder stays owed and blocks a new lease (the reservations
        debt-denial posture)."""
        key = (tenant, region)
        debt = self._debts.get(key, 0.0)
        if debt < 1.0:
            return debt
        debit = getattr(self._store, "debit_many", None)
        if not callable(debit):   # pragma: no cover
            return debt
        _rem, short = await debit([tenant], [debt], cap, rate)
        left = float(short[0])
        collected = debt - left
        if collected > 0:
            self.debt_tokens_collected += collected
        if left <= 1e-9:
            self._debts.pop(key, None)
            return 0.0
        self._debts[key] = left
        return left

    # -- monotonic expiry (sync; piggybacked on every touch) -----------------
    def _conservative_charge(self, lease: Lease) -> float:
        """What an unreachable region COULD have admitted since its
        last report: the full slice burst plus the slice rate over the
        unreported window — the fully-spent presumption the module
        docstring promises. An upper bound by construction, so heal's
        refund (conservative − true) is never negative."""
        window = max(0.0, lease.expires_mono - lease.last_report_mono)
        return lease.slice_cap + lease.slice_rate * window

    def expire(self, now: "float | None" = None) -> int:
        """Expire every lease whose TTL elapsed on the home's
        MONOTONIC clock (``self._clock`` — never ``self._wall``: a
        skewed wall clock must neither extend nor prematurely kill a
        lease). The expired lease's share returns to the pool and its
        conservative charge is recorded for the heal path; the store
        debit itself happens lazily at heal/stats time so this stays
        synchronous (the reservations ``expire`` posture). Returns the
        number expired."""
        now = self._clock() if now is None else now
        n = 0
        for tenant, pool in list(self._pools.items()):
            for region, lease in list(pool.leases.items()):
                if lease.expires_mono > now:
                    continue
                del pool.leases[region]
                charge = self._conservative_charge(lease)
                self.conservative_tokens += charge
                self._expired[lease.lease_id] = {
                    "tenant": tenant, "region": region,
                    "charge": charge, "charged": False,
                    "reported_total": lease.reported_total,
                    "cap": pool.cap, "rate": pool.rate,
                    "share": lease.share,
                }
                while len(self._expired) > self._RECLAIMS_CAP:
                    self._expired.popitem(last=False)
                self.leases_expired += 1
                n += 1
                if self.flight_recorder is not None:
                    self.flight_recorder.record(
                        "federation", event="lease_expired",
                        tenant=tenant, region=region,
                        lease_id=lease.lease_id,
                        conservative_charge=charge)
        return n

    async def _settle_expired(self) -> None:
        """Apply any pending conservative charges to the store (the
        async half of :meth:`expire`). Iterates a SNAPSHOT — the
        lock-free ``stats()`` → ``expire()`` path may insert/evict
        records while a charge awaits — and marks ``charged`` only
        AFTER the debit lands: a checkpoint cut at the await must
        never record a charge the bucket never saw (a restore would
        then refund it at heal — minting tokens), and a failed debit
        retries at the next touch (a double-applied retry at worst
        over-charges — the conservative direction)."""
        for rec in list(self._expired.values()):
            if rec["charged"]:
                continue
            await self._charge(rec["tenant"], rec["region"],
                               rec["charge"], rec["cap"], rec["rate"])
            rec["charged"] = True

    # -- demand-proportional slice sizing ------------------------------------
    def _target_share(self, pool: _TenantPool, region: str,
                      demand: float) -> float:
        """The requester's demand-proportional share. Only the
        REQUESTER's slice is resized at its own lease/renew — an
        absent region's slice is never shrunk in absentia (it may be
        partitioned and still serving from it; two-party consent, the
        conservative posture). Growth comes from the free pool."""
        demands = {r: max(0.0, l.demand)
                   for r, l in pool.leases.items()}
        demands[region] = max(0.0, demand)
        total = sum(demands.values())
        if total <= 0:
            target = 1.0 / max(1, len(demands))
        else:
            target = demands[region] / total
        target = max(self.min_share, target)
        if region not in pool.leases:
            return min(target, pool.free_share(exclude=region))
        # Growth is GRADUAL: one renew may borrow at most
        # initial_share_fraction of the free pool — a lone region
        # converges toward the whole budget geometrically instead of
        # grabbing it in one step, so a joining region always finds
        # room (shrinks apply in full — lending is immediate).
        current = pool.leases[region].share
        return min(target,
                   current + pool.free_share()
                   * self.initial_share_fraction)

    def _slice_of(self, pool: _TenantPool, share: float
                  ) -> tuple[float, float]:
        cap = max(1.0, math.floor(pool.cap * share))
        return (cap, pool.rate * share)

    # -- lease ---------------------------------------------------------------
    def _duplicate_lease(self, lease_id: str) -> "dict | None":
        """Recorded-grant replay — the OP_RESERVE duplicate-rid
        posture: a WAN retry of a granted lease must not re-size or
        re-debit anything."""
        return self._grants.get(lease_id)

    async def lease(self, req: Mapping) -> dict:
        """One OP_FED_LEASE body (wire.py documents the fields)."""
        region = str(req.get("region") or "")
        lease_id = str(req.get("lease_id") or "")
        tenant = str(req.get("tenant") or "")
        if not region or not lease_id or not tenant:
            raise ValueError(
                "fed lease requires region, lease_id, and tenant")
        cap = float(req.get("global_cap", 0.0))
        rate = float(req.get("global_rate", 0.0))
        if not math.isfinite(cap) or cap <= 0 or not math.isfinite(rate):
            raise ValueError("fed lease requires a finite global_cap "
                             "> 0 and a finite global_rate")
        demand = float(req.get("demand", 0.0))
        ttl = float(req.get("ttl_s") or self.default_ttl_s)
        async with self._lock:
            now = self._clock()
            self.expire(now)
            await self._settle_expired()
            dup = self._duplicate_lease(lease_id)
            if dup is not None:
                self.lease_duplicates += 1
                return dict(dup, duplicate=True)
            pool = self._pools.get(tenant)
            if pool is None:
                pool = self._pools[tenant] = _TenantPool(cap, rate)
            elif (pool.cap, pool.rate) != (cap, rate):
                raise ValueError(
                    f"global config mismatch for tenant {tenant!r}: "
                    f"ledger holds ({pool.cap}, {pool.rate}), lease "
                    f"asked ({cap}, {rate}) — one global truth per "
                    "tenant")
            debt = await self._collect_debt(tenant, region, cap, rate)
            if debt >= 1.0:
                self.lease_denied += 1
                return {"granted": False, "lease_id": lease_id,
                        "debt": debt, "duplicate": False}
            old = pool.leases.get(region)
            if old is not None:
                # A replacement lease (the region re-leased with a
                # fresh id while the home still held its old one —
                # heal raced the home expiry, or a region restarted):
                # the old lease's share returns, and the region's
                # monotonic-total BASELINE carries over — its next
                # renew's delta then covers the old lease's unreported
                # window exactly (charging conservatively here would
                # double-count it against that report; the new lease's
                # own expiry conservatism covers a region that
                # vanishes again).
                del pool.leases[region]
                self._set_region_total(tenant, region,
                                       old.reported_total)
            share = self._target_share(pool, region, demand)
            free = pool.free_share(exclude=region)
            # New-lease fairness: take at most initial_share_fraction
            # of the free pool (floored at min_share) — renews
            # converge everyone to demand-proportional from there.
            share = min(share, free,
                        max(self.min_share,
                            free * self.initial_share_fraction))
            if share < self.min_share:
                self.lease_denied += 1
                return {"granted": False, "lease_id": lease_id,
                        "debt": debt, "duplicate": False}
            pool.epoch_seq += 1
            slice_cap, slice_rate = self._slice_of(pool, share)
            # The report baseline CONTINUES the region's monotonic
            # counter across lease generations (see _region_totals).
            # When the ledger holds NO baseline for the pair (first
            # contact, or a bounded-LRU eviction of a long-idle
            # pair), the request's own reported total seeds it — a
            # zero seed would re-charge the region's whole lifetime
            # counter at its first renew (review-caught). A HELD
            # baseline always wins over the request: the gap between
            # them is unreported spend the next renew must charge.
            stored = self._region_totals.get((tenant, region))
            baseline = (float(req.get("total", 0.0))
                        if stored is None else stored)
            lease = Lease(lease_id, tenant, region, pool.epoch_seq,
                          share, slice_cap, slice_rate, now + ttl,
                          now, baseline, demand, ttl)
            pool.leases[region] = lease
            self.leases_granted += 1
            reply = {"granted": True, "lease_id": lease_id,
                     "epoch": lease.epoch, "share": share,
                     "slice": [slice_cap, slice_rate], "ttl_s": ttl,
                     "debt": debt, "duplicate": False}
            self._grants[lease_id] = reply
            while len(self._grants) > self._GRANTS_CAP:
                self._grants.popitem(last=False)
            if self.flight_recorder is not None:
                self.flight_recorder.record(
                    "federation", event="lease_granted", tenant=tenant,
                    region=region, lease_id=lease_id,
                    epoch=lease.epoch, share=round(share, 4),
                    slice_cap=slice_cap)
            return reply

    # -- renew ---------------------------------------------------------------
    async def renew(self, req: Mapping) -> dict:
        """One OP_FED_RENEW body: extend the lease TTL on the home's
        monotonic clock, charge the reported spend DELTA (monotonic
        totals — a replayed renew is a zero delta, which is the op's
        idempotency), update demand, and re-size the slice when the
        demand-proportional target moved past the resize threshold
        (new epoch; the region adopts it forward-only). A renew for an
        EXPIRED lease is the heal path: the true total reconciles the
        conservative charge (refund the difference, saturating) and
        the region is told to take a fresh lease."""
        region = str(req.get("region") or "")
        lease_id = str(req.get("lease_id") or "")
        tenant = str(req.get("tenant") or "")
        total = float(req.get("total", 0.0))
        demand = float(req.get("demand", 0.0))
        if not lease_id:
            raise ValueError("fed renew requires lease_id")
        async with self._lock:
            now = self._clock()
            self.expire(now)
            await self._settle_expired()
            pool = self._pools.get(tenant)
            lease = (pool.leases.get(region)
                     if pool is not None else None)
            if lease is None or lease.lease_id != lease_id:
                healed = await self._heal(lease_id, total)
                if healed is not None:
                    return healed
                self.renew_unknown += 1
                return {"outcome": "unknown", "charged": 0.0,
                        "refunded": 0.0, "debt": 0.0}
            self.renews += 1
            delta = max(0.0, total - lease.reported_total)
            # Charge BEFORE advancing the report baseline: if the
            # debit raises (device error, cancelled dispatch), the
            # baseline is unmoved and the region's retry re-charges
            # the same delta — advancing first would make the
            # absorbing retry's delta zero and lose the spend from
            # the global record entirely (review-caught). A debit
            # that executed before the raise double-charges on retry
            # at worst: over-charge, the conservative direction.
            owed = await self._charge(tenant, region, delta,
                                      pool.cap, pool.rate)
            lease.reported_total = max(lease.reported_total, total)
            self._set_region_total(tenant, region,
                                   lease.reported_total)
            lease.last_report_mono = now
            lease.expires_mono = now + lease.ttl_s
            lease.demand = demand
            if delta > 0 and self.velocity is not None:
                self.velocity.observe(tenant, delta)
            resized = self._maybe_resize(pool, lease, demand)
            reply = {"outcome": "ok", "epoch": lease.epoch,
                     "slice": [lease.slice_cap, lease.slice_rate],
                     "ttl_s": lease.ttl_s, "charged": delta,
                     "refunded": 0.0, "debt": owed,
                     "resized": resized}
            return reply

    def _maybe_resize(self, pool: _TenantPool, lease: Lease,
                      demand: float) -> bool:
        target = self._target_share(pool, lease.region, demand)
        current = lease.share
        if current > 0 and abs(target - current) / current \
                < self.resize_threshold:
            return False
        lease.share = target
        lease.slice_cap, lease.slice_rate = self._slice_of(pool,
                                                           target)
        pool.epoch_seq += 1
        lease.epoch = pool.epoch_seq
        self.resizes += 1
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                "federation", event="lease_resized",
                tenant=lease.tenant, region=lease.region,
                lease_id=lease.lease_id, epoch=lease.epoch,
                share=round(target, 4), slice_cap=lease.slice_cap)
        return True

    async def _heal(self, lease_id: str, total: float
                    ) -> "dict | None":
        """Reconcile a late report against an expired lease's
        conservative charge (module docstring). Applies AT MOST once
        per lease — the record is popped — and the refund is
        ``conservative − true_unreported``, never negative (the charge
        was an upper bound); a true spend past the charge becomes
        debt through the ordinary charge lane."""
        rec = self._expired.pop(lease_id, None)
        if rec is None:
            return None
        self.heals += 1
        true_delta = max(0.0, total - rec["reported_total"])
        refund = max(0.0, rec["charge"] - true_delta)
        extra = max(0.0, true_delta - rec["charge"])
        was_charged = bool(rec["charged"])
        if not rec["charged"]:
            # Expiry recorded but its charge never reached the store
            # (heal won the race): charge the TRUE delta directly.
            owed = await self._charge(rec["tenant"], rec["region"],
                                      true_delta, rec["cap"],
                                      rec["rate"])
            rec["charged"] = True
            refund = 0.0
        else:
            # The over-charge cancels any DEBT the conservative charge
            # created first (the charge and its debt are one event —
            # refunding the bucket while the debt stood would both
            # block the region's next lease AND credit tokens back);
            # only the remainder is a bucket credit.
            key = (rec["tenant"], rec["region"])
            owed_now = self._debts.get(key, 0.0)
            cancel = min(refund, owed_now)
            if cancel > 0:
                left = owed_now - cancel
                if left <= 1e-9:
                    self._debts.pop(key, None)
                else:
                    self._debts[key] = left
                self.debt_tokens_collected += cancel
                self.refunded_tokens += cancel
                refund -= cancel
            await self._refund(rec["tenant"], refund, rec["cap"],
                               rec["rate"])
            owed = self._debts.get(key, 0.0)
            if extra > 0:
                owed = await self._charge(rec["tenant"], rec["region"],
                                          extra, rec["cap"],
                                          rec["rate"])
        # Baseline advances LAST: if a charge/refund above raised, the
        # stale baseline re-charges an already-conservatively-charged
        # window at worst — over-charge, the conservative direction.
        self._set_region_total(rec["tenant"], rec["region"],
                               max(total, rec["reported_total"]))
        total_refund = max(0.0, rec["charge"] - true_delta) \
            if was_charged else 0.0
        if true_delta > 0 and self.velocity is not None:
            self.velocity.observe(rec["tenant"], true_delta)
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                "federation", event="heal", tenant=rec["tenant"],
                region=rec["region"], lease_id=lease_id,
                refunded=total_refund, debt=owed)
        return {"outcome": "expired", "charged": true_delta,
                "refunded": total_refund, "debt": owed}

    # -- reclaim -------------------------------------------------------------
    async def reclaim(self, req: Mapping) -> dict:
        """One OP_FED_RECLAIM body: the region returns its slice.
        Idempotent by lease id — a duplicate replays the recorded
        result with zero side effects (no second share free, no
        second charge or refund): the at-most-once audit
        tests/test_federation.py pins."""
        region = str(req.get("region") or "")
        lease_id = str(req.get("lease_id") or "")
        tenant = str(req.get("tenant") or "")
        total = float(req.get("total", 0.0))
        if not lease_id:
            raise ValueError("fed reclaim requires lease_id")
        async with self._lock:
            now = self._clock()
            self.expire(now)
            await self._settle_expired()
            recorded = self._reclaimed.get(lease_id)
            if recorded is not None:
                self.reclaim_duplicates += 1
                return dict(recorded, outcome="duplicate")
            pool = self._pools.get(tenant)
            lease = (pool.leases.get(region)
                     if pool is not None else None)
            if lease is None or lease.lease_id != lease_id:
                healed = await self._heal(lease_id, total)
                if healed is not None:
                    reply = dict(healed, outcome="reclaimed")
                    self._record_reclaim(lease_id, reply)
                    self.reclaims += 1
                    return reply
                self.reclaim_unknown += 1
                return {"outcome": "unknown", "charged": 0.0,
                        "refunded": 0.0, "debt": 0.0}
            delta = max(0.0, total - lease.reported_total)
            # Charge FIRST — before the lease leaves the pool and
            # before the baseline advance (the renew ordering
            # contract): a failed debit leaves the lease intact and
            # the retry re-charges instead of answering "unknown"
            # with the spend lost from the global record.
            owed = await self._charge(tenant, region, delta,
                                      pool.cap, pool.rate)
            del pool.leases[region]
            self._set_region_total(tenant, region,
                                   max(total, lease.reported_total))
            if delta > 0 and self.velocity is not None:
                self.velocity.observe(tenant, delta)
            self.reclaims += 1
            reply = {"outcome": "reclaimed", "charged": delta,
                     "refunded": 0.0, "debt": owed}
            self._record_reclaim(lease_id, reply)
            if self.flight_recorder is not None:
                self.flight_recorder.record(
                    "federation", event="reclaim", tenant=tenant,
                    region=region, lease_id=lease_id, charged=delta)
            return reply

    def _record_reclaim(self, lease_id: str, reply: dict) -> None:
        self._reclaimed[lease_id] = reply
        while len(self._reclaimed) > self._RECLAIMS_CAP:
            self._reclaimed.popitem(last=False)

    # -- checkpoint ride (runtime/checkpoint.py) -----------------------------
    def export_state(self) -> dict:
        """JSON-shaped lease state for the v4 checkpoint chain. TTLs
        export as remaining AGES against the ledger's monotonic clock
        — a restore re-anchors them, so a restart can only SHORTEN a
        lease's remaining term (conservative, never extended)."""
        now = self._clock()
        return {
            "pools": {
                t: {"cap": p.cap, "rate": p.rate,
                    "epoch_seq": p.epoch_seq,
                    "leases": [l.to_row(now)
                               for _r, l in sorted(p.leases.items())]}
                for t, p in sorted(self._pools.items())},
            "grants": dict(self._grants),
            "reclaimed": dict(self._reclaimed),
            "expired": {k: dict(v)
                        for k, v in self._expired.items()},
            "debts": [[t, r, amt]
                      for (t, r), amt in sorted(self._debts.items())],
            "region_totals": [
                [t, r, v]
                for (t, r), v in sorted(self._region_totals.items())],
            "conservation": {"accounted": self._accounted_base
                             + self.charged_tokens - self.refunded_tokens},
        }

    def restore_state(self, state: Mapping) -> None:
        """Adopt a checkpointed lease state (the restart lane). The
        restored process re-anchors every TTL against ITS monotonic
        clock; idempotency records ride along so a post-restart WAN
        retry still dedups."""
        now = self._clock()
        self._pools = {}
        for tenant, pdata in (state.get("pools") or {}).items():
            pool = _TenantPool(float(pdata["cap"]),
                               float(pdata["rate"]))
            pool.epoch_seq = int(pdata.get("epoch_seq", 0))
            for row in pdata.get("leases", ()):
                lease = Lease.from_row(row, now)
                pool.leases[lease.region] = lease
            self._pools[str(tenant)] = pool
        self._grants = OrderedDict(
            (str(k), dict(v))
            for k, v in (state.get("grants") or {}).items())
        self._reclaimed = OrderedDict(
            (str(k), dict(v))
            for k, v in (state.get("reclaimed") or {}).items())
        self._expired = OrderedDict(
            (str(k), dict(v))
            for k, v in (state.get("expired") or {}).items())
        self._debts = {(str(t), str(r)): float(amt)
                       for t, r, amt in (state.get("debts") or ())}
        self._region_totals = OrderedDict(
            ((str(t), str(r)), float(v))
            for t, r, v in (state.get("region_totals") or ()))
        # The identity's left side resumes where the checkpoint left it;
        # a state without the section (a JAX ledger's) resumes at zero.
        carried = float((state.get("conservation") or {})
                        .get("accounted", 0.0))
        self._accounted_base = carried - (self.charged_tokens
                                          - self.refunded_tokens)
        self.restores += 1

    # -- conservation (runtime/audit.py, DESIGN.md §22) ----------------------
    def conservation(self) -> dict:
        """The home's cover identity: everything the ledger has charged
        (or stands committed to charge — expired leases whose
        conservative debit hasn't landed yet), net of heal refunds,
        must COVER the regions' reported admissions:

            charged + pending_conservative − refunded  ≥  Σ reported

        ``residue`` is the left side minus the right. Positive residue
        is the documented conservative slack (fully-spent presumption,
        forfeited evictions) — tolerated by design. NEGATIVE residue
        means regions admitted tokens the global budget never paid
        for: global over-admission, the breach the audit plane pages
        on. The ε terms here are the conservative charges: budget =
        what every live lease could presume at expiry plus what
        already presumed, used = the presumed (pending) part — the
        ``source="federation"`` utilization gauge."""
        pending = sum(rec["charge"] for rec in self._expired.values()
                      if not rec["charged"])
        accounted = (self._accounted_base + self.charged_tokens + pending
                     - self.refunded_tokens)
        admitted = sum(self._region_totals.values())
        live_budget = sum(self._conservative_charge(lease)
                          for pool in self._pools.values()
                          for lease in pool.leases.values())
        return {
            "accounted": accounted,
            "admitted": admitted,
            "residue": accounted - admitted,
            "charged": self.charged_tokens,
            "pending_conservative": pending,
            "refunded": self.refunded_tokens,
            "epsilon_used": pending,
            "epsilon_budget": pending + live_budget,
        }

    # -- stats ---------------------------------------------------------------
    def numeric_stats(self) -> dict:
        """Flat numeric dict for ``register_numeric_dict`` — the
        ``drl_federation_*`` families."""
        return {
            "leases_granted": self.leases_granted,
            "lease_duplicates": self.lease_duplicates,
            "lease_denied": self.lease_denied,
            "renews": self.renews,
            "renew_unknown": self.renew_unknown,
            "resizes": self.resizes,
            "reclaims": self.reclaims,
            "reclaim_duplicates": self.reclaim_duplicates,
            "reclaim_unknown": self.reclaim_unknown,
            "leases_expired": self.leases_expired,
            "heals": self.heals,
            "charged_tokens": self.charged_tokens,
            "conservative_tokens": self.conservative_tokens,
            "refunded_tokens": self.refunded_tokens,
            "debts_created": self.debts_created,
            "debt_tokens_created": self.debt_tokens_created,
            "debt_tokens_collected": self.debt_tokens_collected,
            "restores": self.restores,
            "outstanding_leases": float(self.outstanding_leases()),
            "debt_tokens": sum(self._debts.values()),
        }

    def stats(self) -> dict:
        """JSON-shaped summary for OP_STATS embedding (piggybacks one
        expiry pass, so a scraped-but-idle home still expires)."""
        self.expire()
        out = self.numeric_stats()
        out["tenants"] = {
            t: {"cap": p.cap, "rate": p.rate,
                "leases": {r: {"lease_id": l.lease_id,
                               "epoch": l.epoch,
                               "share": round(l.share, 4),
                               "slice": [l.slice_cap, l.slice_rate],
                               "reported_total": l.reported_total,
                               "demand": l.demand}
                           for r, l in sorted(p.leases.items())}}
            for t, p in sorted(self._pools.items())}
        out["debts"] = {f"{t}/{r}": round(v, 3)
                        for (t, r), v in sorted(self._debts.items())}
        return out


# ===========================================================================
# Region side
# ===========================================================================

class _TenantLease:
    """One tenant's lease as the region knows it."""

    __slots__ = ("lease_id", "epoch", "slice_cap", "slice_rate",
                 "applied", "expires_mono", "renew_due_mono",
                 "degraded", "ttl_s")

    def __init__(self) -> None:
        self.lease_id: "str | None" = None
        self.epoch = 0
        self.slice_cap = 0.0
        self.slice_rate = 0.0
        #: The config currently live on the regional data plane
        #: (slice or degraded envelope) — the OP_CONFIG rule's `old`.
        self.applied: "tuple[float, float] | None" = None
        self.expires_mono = 0.0
        self.renew_due_mono = 0.0
        self.degraded = False
        self.ttl_s = DEFAULT_LEASE_TTL_S


def slice_applier(target):
    """An ``apply_slice(tenant, old_cfg, new_cfg)`` callback over the
    existing live-config machinery: a :class:`~.cluster.
    ClusterBucketStore` applies through ``mutate_config`` (two-phase
    across the fleet under the membership lock), a single node through
    ``config_announce`` (prepare + commit at the node's next version)
    — either way the slice change IS an ordinary OP_CONFIG mutation
    whose stale traffic chases one routable "config moved" error."""
    async def apply(tenant: str, old, new) -> None:
        del tenant  # the config operands are the identity on the wire
        if old is None or tuple(old) == tuple(new):
            return
        mutate = getattr(target, "mutate_config", None)
        if callable(mutate):
            await mutate("bucket", tuple(old), tuple(new))
            return
        announce = getattr(target, "config_announce", None)
        if callable(announce):
            fetch = getattr(target, "config_fetch", None)
            version = 0
            if callable(fetch):
                version = int((await fetch()).get("version", 0))
            rule = {"kind": "bucket", "old": list(old),
                    "new": list(new)}
            await announce({"prepare": rule, "version": version + 1})
            await announce({"commit": version + 1})
            return
        raise TypeError(
            "slice_applier target supports neither mutate_config nor "
            "config_announce")
    return apply


class RegionFederation:
    """The region side of the federation: holds one lease per tenant,
    renews on a deterministic cadence, applies slice changes through
    the OP_CONFIG lane, and — the robustness core — degrades to the
    fair-share envelope config when a lease expires unrenewed (module
    docstring). Drive it with :meth:`tick` (the controller's
    ``federation`` actuator does; soaks call it directly — cadence is
    an operational concern, not a semantic one)."""

    def __init__(self, region: str, home, *,
                 tenants: "Mapping[str, tuple[float, float]]",
                 apply_slice=None,
                 admitted_total: "Callable[[str], float] | None" = None,
                 demand: "Callable[[str], float] | None" = None,
                 ttl_s: float = DEFAULT_LEASE_TTL_S,
                 renew_fraction: float = 0.5,
                 envelope_fraction: float = DEFAULT_ENVELOPE_FRACTION,
                 clock: Callable[[], float] = time.monotonic,
                 wall: Callable[[], float] = time.time,
                 flight_recorder=None,
                 lease_id_factory: "Callable[[], str] | None" = None
                 ) -> None:
        if not tenants:
            raise ValueError("RegionFederation needs >= 1 tenant")
        if ttl_s <= 0 or not 0.0 < renew_fraction < 1.0:
            raise ValueError("ttl_s must be positive and "
                             "renew_fraction in (0, 1)")
        self.region = region
        #: The home handle: anything with async ``fed_lease`` /
        #: ``fed_renew`` / ``fed_reclaim`` — a RemoteBucketStore over
        #: the WAN, or a FederationLedger directly (in-process tests).
        self.home = home
        self.tenants = {str(t): (float(c), float(r))
                        for t, (c, r) in tenants.items()}
        self._apply_slice = apply_slice
        self._admitted_total = admitted_total or (lambda _t: 0.0)
        self._demand = demand or (lambda _t: 0.0)
        self.ttl_s = float(ttl_s)
        self.renew_fraction = float(renew_fraction)
        self.envelope_fraction = float(envelope_fraction)
        #: MONOTONIC lease clock — region-side expiry reads ONLY this
        #: (the no-skew-extension contract's other half). ``wall`` is
        #: for stats timestamps.
        self._clock = clock
        self._wall = wall
        self.flight_recorder = flight_recorder
        self._ids = lease_id_factory or self._default_ids()
        self._leases: "dict[str, _TenantLease]" = {
            t: _TenantLease() for t in self.tenants}
        # Visible counters (OP_STATS "federation_region" +
        # drl_federation_region_*). MONOTONIC.
        self.leases_acquired = 0
        self.lease_failures = 0
        self.renews = 0
        self.renew_failures = 0
        self.partition_errors = 0
        self.degraded_entries = 0
        self.heals = 0
        self.slice_updates = 0
        self.stale_slice_replies = 0
        self.reclaims = 0
        self.fed_fallbacks = 0

    def _default_ids(self) -> Callable[[], str]:
        seq = [0]

        def make() -> str:
            seq[0] += 1
            return f"{self.region}:{seq[0]}"
        return make

    # -- introspection -------------------------------------------------------
    def slice(self, tenant: str) -> "tuple[float, float] | None":
        """The config the region currently serves ``tenant`` from
        (slice, or the degraded envelope config mid-partition);
        ``None`` before the first lease."""
        lease = self._leases[tenant]
        return lease.applied

    def degraded(self, tenant: str) -> bool:
        return self._leases[tenant].degraded

    @property
    def any_degraded(self) -> bool:
        return any(l.degraded for l in self._leases.values())

    def renew_due(self, now: "float | None" = None) -> bool:
        """True when any tenant's renew (or first lease) is due — the
        controller's actuator condition."""
        now = self._clock() if now is None else now
        return any(l.lease_id is None or now >= l.renew_due_mono
                   for l in self._leases.values())

    # -- the drive -----------------------------------------------------------
    async def tick(self, demands: "Mapping[str, float] | None" = None,
                   now: "float | None" = None) -> dict:
        """One federation round for every tenant: lease when missing,
        renew when due, degrade when expired — in that priority order
        per tenant, one WAN call each. ``demands`` (per-tenant
        tokens/sec — the controller passes its velocity-delta rates)
        overrides the constructor's demand callable for this round.
        Partition failures are COUNTED and absorbed: the region keeps
        serving from its applied config; expiry is what degrades it,
        never an RPC error (never hard-down)."""
        now = self._clock() if now is None else now
        summary = {"renewed": 0, "leased": 0, "degraded": 0,
                   "healed": 0, "errors": 0}
        for tenant, lease in self._leases.items():
            demand = (float(demands[tenant])
                      if demands and tenant in demands
                      else float(self._demand(tenant)))
            # 1. Degrade on local monotonic expiry FIRST: renewals may
            # be failing precisely because the WAN is down.
            if (lease.lease_id is not None and not lease.degraded
                    and now >= lease.expires_mono):
                await self._degrade(tenant, lease)
                summary["degraded"] += 1
            if lease.lease_id is None:
                ok = await self._lease(tenant, lease, demand, now)
                summary["leased" if ok else "errors"] += 1
                continue
            if now >= lease.renew_due_mono or lease.degraded:
                ok, healed = await self._renew(tenant, lease, demand,
                                               now)
                if ok:
                    summary["renewed"] += 1
                    if healed:
                        summary["healed"] += 1
                else:
                    summary["errors"] += 1
        return summary

    async def _call_home(self, method: str, payload: dict):
        """One WAN control call through the chaos seam. The
        ``federation.renew`` / ``federation.lease`` /
        ``federation.reclaim`` seams are where the soak injects
        resets, delays, and blackholes — a fault here is a partition
        symptom the caller counts and absorbs."""
        seam_name = {"fed_lease": "federation.lease",
                     "fed_renew": "federation.renew",
                     "fed_reclaim": "federation.reclaim"}[method]
        await faults.seam(seam_name)
        fn = getattr(self.home, method, None)
        if fn is None:
            # A FederationLedger passed directly (in-process home).
            direct = {"fed_lease": "lease", "fed_renew": "renew",
                      "fed_reclaim": "reclaim"}[method]
            fn = getattr(self.home, direct)
        return await fn(payload)

    async def _lease(self, tenant: str, lease: _TenantLease,
                     demand: float, now: float) -> bool:
        cap, rate = self.tenants[tenant]
        lease_id = self._ids()
        try:
            reply = await self._call_home("fed_lease", {
                "region": self.region, "lease_id": lease_id,
                "tenant": tenant, "demand": demand,
                # The region's monotonic admitted total seeds the
                # home's report baseline for this lease generation.
                "total": float(self._admitted_total(tenant)),
                "global_cap": cap, "global_rate": rate,
                "ttl_s": self.ttl_s})
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self.lease_failures += 1
            self.partition_errors += 1
            log.error_evaluating_kernel(exc)
            return False
        if reply.get("fallback"):
            self.fed_fallbacks += 1
            return False
        if not reply.get("granted"):
            self.lease_failures += 1
            return False
        was_degraded = lease.degraded
        lease.lease_id = lease_id
        lease.ttl_s = float(reply.get("ttl_s", self.ttl_s))
        lease.degraded = False   # BEFORE adoption: the fresh slice
        self._arm(lease, now)    # must replace a degraded envelope
        await self._adopt(tenant, lease, int(reply.get("epoch", 1)),
                          reply.get("slice") or [1.0, 0.0])
        self.leases_acquired += 1
        if was_degraded:
            self.heals += 1
            if self.flight_recorder is not None:
                self.flight_recorder.record(
                    "federation", event="region_healed",
                    region=self.region, tenant=tenant,
                    lease_id=lease_id)
        return True

    async def _renew(self, tenant: str, lease: _TenantLease,
                     demand: float, now: float
                     ) -> "tuple[bool, bool]":
        total = float(self._admitted_total(tenant))
        try:
            reply = await self._call_home("fed_renew", {
                "region": self.region, "lease_id": lease.lease_id,
                "tenant": tenant, "total": total, "demand": demand})
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            self.renew_failures += 1
            self.partition_errors += 1
            log.error_evaluating_kernel(exc)
            return False, False
        if reply.get("fallback"):
            self.fed_fallbacks += 1
            return False, False
        outcome = reply.get("outcome")
        if outcome == "ok":
            self.renews += 1
            lease.ttl_s = float(reply.get("ttl_s", lease.ttl_s))
            self._arm(lease, now)
            await self._adopt(tenant, lease,
                              int(reply.get("epoch", 0)),
                              reply.get("slice")
                              or [lease.slice_cap, lease.slice_rate])
            healed = lease.degraded
            if healed:
                # The home still held the lease (region-side expiry
                # fired first): re-apply the slice over the envelope.
                lease.degraded = False
                self.heals += 1
                await self._apply(tenant, lease,
                                  (lease.slice_cap, lease.slice_rate))
            return True, healed
        # "expired"/"unknown": the home already reconciled (heal) or
        # never knew us — drop the lease; the next tick re-leases with
        # a FRESH id (lease ids are single-use, the rid posture).
        lease.lease_id = None
        return True, outcome == "expired"

    def _arm(self, lease: _TenantLease, now: float) -> None:
        """Reset the lease windows from the MONOTONIC clock only: the
        next renew at ``renew_fraction × ttl``, expiry at ``ttl``."""
        lease.expires_mono = now + lease.ttl_s
        lease.renew_due_mono = now + lease.ttl_s * self.renew_fraction

    async def _adopt(self, tenant: str, lease: _TenantLease,
                     epoch: int, new_slice) -> None:
        """Adopt a slice reply FORWARD-ONLY: a stale (out-of-order WAN
        retry) reply carrying an older epoch must not roll the applied
        config back — the OP_CONFIG version discipline."""
        if epoch <= lease.epoch:
            if epoch < lease.epoch:
                self.stale_slice_replies += 1
            return
        lease.epoch = epoch
        new_cfg = (float(new_slice[0]), float(new_slice[1]))
        lease.slice_cap, lease.slice_rate = new_cfg
        if not lease.degraded:
            await self._apply(tenant, lease, new_cfg)

    async def _apply(self, tenant: str, lease: _TenantLease,
                     new_cfg: "tuple[float, float]") -> None:
        old = lease.applied
        if old == new_cfg:
            return
        if self._apply_slice is not None:
            try:
                await self._apply_slice(tenant, old, new_cfg)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # A failed mutation leaves the OLD config serving —
                # bounded (it was a granted slice or its envelope),
                # counted, retried at the next adoption.
                self.renew_failures += 1
                log.error_evaluating_kernel(exc)
                return
        lease.applied = new_cfg
        self.slice_updates += 1

    async def _degrade(self, tenant: str, lease: _TenantLease) -> None:
        """Lease expired with the home unreachable: rewrite the
        tenant's config to the fair-share envelope — bounded local
        serving, the breaker-quarantine posture. The slice identity
        (lease_id/epoch) is kept so the eventual heal reconciles."""
        env = degraded_config(lease.slice_cap, lease.slice_rate,
                              self.envelope_fraction)
        lease.degraded = True
        self.degraded_entries += 1
        await self._apply(tenant, lease, env)
        if self.flight_recorder is not None:
            self.flight_recorder.record(
                "federation", event="region_degraded",
                region=self.region, tenant=tenant,
                lease_id=lease.lease_id, envelope_cap=env[0],
                envelope_rate=env[1])

    async def reclaim_all(self) -> int:
        """Graceful shutdown: return every slice to the pool (reports
        the final totals; idempotent server-side, so a retry after an
        ambiguous failure is safe). Returns leases reclaimed."""
        n = 0
        for tenant, lease in self._leases.items():
            if lease.lease_id is None:
                continue
            try:
                reply = await self._call_home("fed_reclaim", {
                    "region": self.region, "lease_id": lease.lease_id,
                    "tenant": tenant,
                    "total": float(self._admitted_total(tenant))})
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                self.partition_errors += 1
                log.error_evaluating_kernel(exc)
                continue
            if reply.get("outcome") in ("reclaimed", "duplicate"):
                lease.lease_id = None
                self.reclaims += 1
                n += 1
        return n

    # -- stats ---------------------------------------------------------------
    def numeric_stats(self) -> dict:
        """Flat numeric dict for ``register_numeric_dict`` — the
        ``drl_federation_region_*`` families (partition/degraded
        counters the satellite contract names)."""
        return {
            "leases_acquired": self.leases_acquired,
            "lease_failures": self.lease_failures,
            "renews": self.renews,
            "renew_failures": self.renew_failures,
            "partition_errors": self.partition_errors,
            "degraded_entries": self.degraded_entries,
            "heals": self.heals,
            "slice_updates": self.slice_updates,
            "stale_slice_replies": self.stale_slice_replies,
            "reclaims": self.reclaims,
            "fed_fallbacks": self.fed_fallbacks,
            "degraded_now": float(sum(
                1 for l in self._leases.values() if l.degraded)),
            "leases_held": float(sum(
                1 for l in self._leases.values()
                if l.lease_id is not None)),
        }

    def stats(self) -> dict:
        out = self.numeric_stats()
        out["region"] = self.region
        out["tenants"] = {
            t: {"lease_id": l.lease_id, "epoch": l.epoch,
                "slice": [l.slice_cap, l.slice_rate],
                "applied": list(l.applied) if l.applied else None,
                "degraded": l.degraded}
            for t, l in sorted(self._leases.items())}
        return out
