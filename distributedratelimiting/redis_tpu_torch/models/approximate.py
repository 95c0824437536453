"""Approximate token-bucket limiter — the flagship two-level algorithm.

Capability mirror of ``RedisApproximateTokenBucketRateLimiter``
(``ApproximateTokenBucket/RedisApproximateTokenBucketRateLimiter.cs``), the
reference's headline design (SURVEY.md §2 #3, invariant 6):

- **Decisions are local** — zero store traffic on the hot path
  (``AcquireCore`` ``:84-113``): a lock-guarded local throttle score
  against the fair-share availability formula
  ``max(0, ceil((token_limit − global_score) / instance_count) − local_score)``
  (``:37``).
- **A periodic sync** pushes the harvested local score into the store's
  decaying global counter and pulls back ``(global_score, period_ewma)``
  (``Refresh``/``RefreshAsync`` ``:397-508``). The EWMA of observed
  inter-sync intervals yields the membership-free instance-count estimate
  (``:443``) — clients joining/leaving reshapes everyone's share within
  ~O(period) with no membership protocol (SURVEY.md §5.3d).
- **Degraded mode**: sync failures are logged and skipped; the limiter
  keeps serving from the last-known global score — availability over
  accuracy (``:419-428,437-449``, invariant 9).
- **Queueing**: full waiter semantics (cumulative-permit queue limit,
  oldest/newest-first, eviction, cancellation, dispose-fails-waiters) via
  :class:`~.runtime.queueing.WaiterQueue` — with the reference's
  cancelled-waiter double-count defect fixed by construction.

Staleness bound: decisions may over-admit by at most what peers consume
within one ``replenishment_period_s`` — identical to the reference's bound.
"""

from __future__ import annotations

import asyncio
import math
import time

import numpy as np

from distributedratelimiting.redis_tpu_torch.models.base import (
    FAILED_LEASE,
    SUCCESSFUL_LEASE,
    MetadataName,
    RateLimitLease,
    RateLimiter,
    check_permits,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    ApproximateTokenBucketOptions,
)
from distributedratelimiting.redis_tpu_torch.ops.bucket_math import TICKS_PER_SECOND
from distributedratelimiting.redis_tpu_torch.runtime.queueing import (
    QueueProcessingOrder,
    WaiterQueue,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    BucketStore,
    BulkAcquireResult,
)
from distributedratelimiting.redis_tpu_torch.utils import log
from distributedratelimiting.redis_tpu_torch.utils.metrics import LimiterMetrics

__all__ = [
    "ApproximateTokenBucketRateLimiter",
    "headroom_budget",
    "overadmit_epsilon",
]


# -- shared local-replica policy (this limiter + the tier-0 edge cache) ----
#
# The native front-end's tier-0 admission cache (native/frontend.cc) is
# this file's algorithm re-hosted below the wire: local decisions against
# a replicated envelope, reconciled by an async sync. Both layers size
# their local confidence with the same two formulas so the documented
# over-admission bound holds everywhere it is quoted (docs/OPERATIONS.md
# "Tier-0 approximate admission"; the C mirror is ``t0_budget_of`` in
# native/frontend.cc — keep the three in sync).

def headroom_budget(available: float, *, fraction: float = 0.5,
                    min_budget: float = 64.0,
                    max_budget: float = float(1 << 20)) -> float:
    """Confident local admission budget carved from an observed
    availability: ``floor(min(available × fraction, max_budget))``, or 0
    when that falls below ``min_budget`` (too little headroom to be worth
    — or safe — deciding locally; the caller must fall through to the
    authoritative path)."""
    b = min(available * fraction, max_budget)
    return float(math.floor(b)) if b >= min_budget else 0.0


def overadmit_epsilon(budget: float, fill_rate_per_sec: float,
                      sync_period_s: float) -> float:
    """Worst-case over-admission of a local replica admitting against a
    budget refreshed every ``sync_period_s``: one budget of grants may be
    outstanding (harvested but not yet debited) while a second budget is
    admitted against the stale envelope, plus whatever the authority
    refills during one sync period — ``2·budget + fill_rate·period``.
    This is the epsilon the tier-0 differential test audits, and (with
    ``budget = 0``) the classic staleness bound of this limiter: peers'
    consumption within one replenishment period."""
    return 2.0 * budget + fill_rate_per_sec * sync_period_s


class ApproximateTokenBucketRateLimiter(RateLimiter):
    def __init__(self, options: ApproximateTokenBucketOptions,
                 store: BucketStore) -> None:
        self.options = options
        self.store = store
        self.metrics = LimiterMetrics()
        self._local_score = 0.0       # ≙ _localThrottleScore
        self._global_score = 0.0      # ≙ _globalThrottleScore
        self._instance_count = 1      # ≙ _instanceCountEstimate
        self._consumed_total = 0.0    # lifetime consumption (diagnostics)
        self._queue = WaiterQueue(options.queue_limit,
                                  options.queue_processing_order)
        self._idle_since: float | None = time.monotonic()
        self._refresh_task: asyncio.Task | None = None
        self._refresh_running = False
        self._last_refresh_mono = time.monotonic()
        self._disposed = False

    # -- availability (the formula, :37) -----------------------------------
    @property
    def available_tokens(self) -> float:
        share = math.ceil(
            (self.options.token_limit - self._global_score)
            / max(1, self._instance_count)
        )
        return max(0.0, share - self._local_score)

    # -- hot path ----------------------------------------------------------
    def _check_permits(self, permits: int) -> None:
        check_permits(permits, self.options.token_limit)  # ≙ :87-90
        if self._disposed:
            raise RuntimeError("limiter is disposed")

    def _try_lease(self, permits: int) -> bool:
        """≙ ``TryLeaseUnsynchronized`` (``:185-214``): grant only when
        permits are available AND no waiter would be overtaken (queue empty,
        or NEWEST_FIRST where overtaking is the policy, ``:202``)."""
        if self.available_tokens >= permits and (
            len(self._queue) == 0
            or self.options.queue_processing_order
            is QueueProcessingOrder.NEWEST_FIRST
        ):
            self._consume(permits)
            return True
        return False

    def _consume(self, permits: float) -> None:
        self._local_score += permits
        self._consumed_total += permits
        if permits > 0:
            self._idle_since = None

    def _failed_lease(self, permits: int) -> RateLimitLease:
        """Failed lease with corrected ``retry_after`` (deficit / rate —
        the reference multiplies, ``:393-394``, a known defect)."""
        deficit = permits - self.available_tokens
        rate = self.options.fill_rate_per_second
        return RateLimitLease(False, {
            MetadataName.RETRY_AFTER: max(0.0, deficit / rate),
        })

    def acquire(self, permits: int = 1) -> RateLimitLease:
        """≙ ``AcquireCore`` (``:84-113``) — purely local, no store I/O on
        the decision itself. The reference arms its sync ``Timer`` in the
        constructor (``:77``); a Python limiter may live entirely outside an
        event loop, so the sync path self-paces: if no refresh task exists
        and a replenishment period has elapsed, one inline blocking sync
        runs here (amortized — once per period, not per call)."""
        self._check_permits(permits)
        self._maybe_refresh_inline()
        if permits == 0:
            # Zero-permit probe (:93-102).
            ok = self.available_tokens > 0
            self.metrics.record_decision(ok)
            return SUCCESSFUL_LEASE if ok else self._failed_lease(0)
        if self._try_lease(permits):
            self.metrics.record_decision(True)
            return SUCCESSFUL_LEASE
        self.metrics.record_decision(False)
        return self._failed_lease(permits)

    def acquire_many(self, permits) -> BulkAcquireResult:
        """Vectorized local bulk admission: decide a whole batch of permit
        requests against this bucket in ONE numpy pass — no per-request
        Python on the hot loop. Decisions use the same conservative
        in-batch serialization as the device bulk paths: earlier requests'
        demand reserves ahead of later ones within the call (cumulative
        prefix vs the availability at call start), so over-admission is
        impossible and the result equals a sequential replay whenever all
        in-call requests fit. Zero-count probes grant while any
        availability remains at their position. Skipped when waiters are
        queued under OLDEST_FIRST (bulk callers must not overtake parked
        requests — the same gate as ``_try_lease``)."""
        counts = np.asarray(permits, np.int64)
        if counts.size and (counts.min() < 0
                            or counts.max() > self.options.token_limit):
            self._check_permits(int(counts.min()))
            self._check_permits(int(counts.max()))
        if self._disposed:
            raise RuntimeError("limiter is disposed")
        self._maybe_refresh_inline()
        n = counts.size
        avail0 = self.available_tokens
        if len(self._queue) > 0 and (
                self.options.queue_processing_order
                is QueueProcessingOrder.OLDEST_FIRST):
            # Demand must not overtake parked waiters — but probes consume
            # nothing, so they mirror acquire(0): granted while tokens
            # remain (nothing else in the call is granted, so no prefix).
            granted = (counts == 0) & (avail0 > 0)
            remaining = np.full(n, max(avail0, 0.0), np.float32)
            self.metrics.record_bulk(n, int(granted.sum()))
            return BulkAcquireResult(granted, remaining)
        cum = np.cumsum(counts)
        before = cum - counts
        granted = np.where(counts > 0, cum <= avail0, avail0 - before > 0)
        total = int(counts[granted & (counts > 0)].sum()) if n else 0
        if total:
            self._consume(total)
        remaining = np.maximum(avail0 - cum, 0.0).astype(np.float32)
        self.metrics.record_bulk(n, int(granted.sum()))
        return BulkAcquireResult(granted, remaining)

    async def acquire_async(self, permits: int = 1) -> RateLimitLease:
        """≙ ``WaitAsyncCore`` (``:116-183``): fast path, then park."""
        self._check_permits(permits)
        self._ensure_refresh_task()
        if permits == 0:
            ok = self.available_tokens > 0
            self.metrics.record_decision(ok)
            return SUCCESSFUL_LEASE if ok else self._failed_lease(0)
        if self._try_lease(permits):
            self.metrics.record_decision(True)
            return SUCCESSFUL_LEASE
        # Queue handling (:139-181).
        future, evicted = self._queue.try_enqueue(permits)
        for victim in evicted:
            self.metrics.evicted += 1
            victim.future.set_result(self._failed_lease(victim.count))
        if future is None:
            self.metrics.record_decision(False)
            return self._failed_lease(permits)
        self.metrics.queued += 1
        try:
            lease = await future
        except asyncio.CancelledError:
            self.metrics.cancelled += 1
            raise
        self.metrics.record_decision(lease.is_acquired)
        return lease

    # -- background sync (the only distributed communication) --------------
    def _maybe_refresh_inline(self) -> None:
        """Loop-less callers get a blocking refresh once per period; callers
        on an event loop get the background task instead."""
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            self._ensure_refresh_task()
            return
        if (self._refresh_task is None
                and time.monotonic() - self._last_refresh_mono
                >= self.options.replenishment_period_s):
            self.refresh_blocking()

    def refresh_blocking(self) -> None:
        """Synchronous sync round for non-async deployments; same semantics
        as :meth:`refresh` minus the waiter-queue drain (waiters only exist
        on an event loop)."""
        if self._refresh_running:
            return
        self._refresh_running = True
        try:
            harvested, self._local_score = self._local_score, 0.0
            try:
                res = self.store.sync_counter_blocking(
                    self.options.instance_name, harvested,
                    self.options.fill_rate_per_second,
                )
            except Exception as exc:  # degraded mode
                log.error_evaluating_kernel(exc)
                self.metrics.sync_failures += 1
                self._local_score += harvested
                return
            self._apply_sync_result(res)
        finally:
            self._last_refresh_mono = time.monotonic()
            self._refresh_running = False

    def _apply_sync_result(self, res) -> None:
        self._global_score = res.global_score
        # Membership-free instance estimate (:440-443).
        period_ticks = self.options.replenishment_period_s * TICKS_PER_SECOND
        self._instance_count = max(
            1, round(period_ticks / max(res.period_ewma_ticks, 1.0))
        )
        self.metrics.syncs += 1
        if self._consumed_total == 0 and self._idle_since is None:
            self._idle_since = time.monotonic()

    def _ensure_refresh_task(self) -> None:
        if self._refresh_task is None or self._refresh_task.done():
            if not self._disposed:
                self._refresh_task = asyncio.get_running_loop().create_task(
                    self._refresh_loop()
                )

    async def _refresh_loop(self) -> None:
        period = self.options.replenishment_period_s
        while not self._disposed:
            await asyncio.sleep(period)
            await self.refresh()

    async def refresh(self) -> None:
        """One sync round (≙ ``Refresh``→``RefreshAsync``, ``:397-508``).
        Public so tests and manual callers can step it deterministically."""
        if self._refresh_running:  # timer re-entrancy guard (:402-409)
            return
        self._refresh_running = True
        try:
            t0 = time.perf_counter()
            # Harvest local consumption (:430-435).
            harvested, self._local_score = self._local_score, 0.0
            try:
                res = await self.store.sync_counter(
                    self.options.instance_name, harvested,
                    self.options.fill_rate_per_second,
                )
            except Exception as exc:  # degraded mode (:419-428,437-449)
                log.error_evaluating_kernel(exc)
                self.metrics.sync_failures += 1
                self._local_score += harvested  # restore for next sync
                return
            self._apply_sync_result(res)
            self.metrics.last_sync_lag_s = time.perf_counter() - t0
            # Drain parked waiters while tokens are available (:453-501).
            self._queue.drain(self._drain_grant, lambda: SUCCESSFUL_LEASE)
        finally:
            self._last_refresh_mono = time.monotonic()
            self._refresh_running = False

    def _drain_grant(self, count: int) -> bool:
        if self.available_tokens >= count:
            self._consume(count)
            return True
        return False

    # -- contract ----------------------------------------------------------
    def available_permits(self) -> int:
        return int(self.available_tokens)

    @property
    def idle_duration(self) -> float | None:
        if self._idle_since is None:
            return None
        return time.monotonic() - self._idle_since

    async def aclose(self) -> None:
        """Dispose (≙ ``:274-300``): stop the timer, fail queued waiters."""
        if self._disposed:
            return
        self._disposed = True
        if self._refresh_task is not None:
            self._refresh_task.cancel()
            try:
                await self._refresh_task
            except (asyncio.CancelledError, Exception):
                pass
            self._refresh_task = None
        self._queue.fail_all(lambda: FAILED_LEASE)

    def stats(self) -> dict:
        """≙ the ``ToString()`` diagnostic dump (``:510-513``)."""
        return {
            "consumed_total": self._consumed_total,
            "local_score": self._local_score,
            "global_score": self._global_score,
            "instance_count_estimate": self._instance_count,
            "available_tokens": self.available_tokens,
            "queue_count": self._queue.queue_count,
            # The documented staleness bound, via the shared formula.
            "staleness_epsilon": overadmit_epsilon(
                0.0, self.options.fill_rate_per_second,
                self.options.replenishment_period_s),
            **self.metrics.snapshot(),
        }

    def __str__(self) -> str:
        return (
            f"ApproximateTokenBucketRateLimiter(consumed={self._consumed_total}, "
            f"available={self.available_tokens}, "
            f"peers≈{self._instance_count})"
        )
