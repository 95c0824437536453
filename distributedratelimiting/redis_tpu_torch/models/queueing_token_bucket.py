"""Queueing + exact hybrid limiter — the reference's unfinished roadmap item.

The reference ships an entire limiter class commented out
(``TokenBucketWithQueue/RedisTokenBucketRateLimiter.cs:6-549``): a merge of
the exact limiter's store-round-trip grants with the approximate limiter's
waiter queue + periodic refresh machinery. It references undeclared fields
and would not compile — SURVEY.md §2 #14 calls its *intent* ("the roadmap's
queueing + exact-bucket hybrid") the thing worth carrying forward. This is
that limiter, finished:

- Every grant is an **exact** decision against the shared store bucket
  (one micro-batched kernel launch, ≙ one Lua round-trip,
  ``TokenBucket/RedisTokenBucketRateLimiter.cs:176-239``) — no local fair
  share, no staleness.
- An acquire the store declines **parks on the waiter queue** (cumulative
  permit accounting, oldest/newest-first, eviction, cancellation — the
  exact semantics of SURVEY.md §2 #5).
- A **periodic refresh** retries the queue head against the store and
  drains while grants succeed — the analogue of the approximate limiter's
  drain loop (``RedisApproximateTokenBucketRateLimiter.cs:462-501``), but
  each drain grant is a real store round-trip, not a local estimate.
- Degraded mode: a refresh whose store traffic fails is logged and skipped;
  waiters stay parked for the next round (invariant 9).
"""

from __future__ import annotations

import asyncio
import math
import time

from distributedratelimiting.redis_tpu_torch.models.base import (
    FAILED_LEASE,
    SUCCESSFUL_LEASE,
    MetadataName,
    RateLimitLease,
    RateLimiter,
    check_permits,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    QueueingTokenBucketOptions,
)
from distributedratelimiting.redis_tpu_torch.runtime.queueing import (
    QueueProcessingOrder,
    WaiterQueue,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils import log
from distributedratelimiting.redis_tpu_torch.utils.metrics import LimiterMetrics

__all__ = ["QueueingTokenBucketRateLimiter"]


class QueueingTokenBucketRateLimiter(RateLimiter):
    def __init__(self, options: QueueingTokenBucketOptions,
                 store: BucketStore) -> None:
        self.options = options
        self.store = store
        self.metrics = LimiterMetrics()
        self._estimated_remaining: float | None = None
        self._queue = WaiterQueue(options.queue_limit,
                                  options.queue_processing_order)
        self._idle_since: float | None = time.monotonic()
        self._refresh_task: asyncio.Task | None = None
        self._refresh_running = False
        self._store_reachable = False  # any store round-trip this round?
        self._disposed = False

    # -- helpers -----------------------------------------------------------
    def _check_permits(self, permits: int) -> None:
        check_permits(permits, self.options.token_limit)
        if self._disposed:
            raise RuntimeError("limiter is disposed")

    def _failed_lease(self, permits: int) -> RateLimitLease:
        remaining = self._estimated_remaining or 0.0
        deficit = permits - remaining
        rate = self.options.fill_rate_per_second
        return RateLimitLease(False, {
            MetadataName.RETRY_AFTER: max(0.0, deficit / rate),
        })

    async def _store_acquire(self, count: int) -> bool:
        t0 = time.perf_counter()
        res = await self.store.acquire(
            self.options.instance_name, count, self.options.token_limit,
            self.options.fill_rate_per_second,
        )
        self.metrics.acquire_latency.record(time.perf_counter() - t0)
        self._estimated_remaining = res.remaining
        self._store_reachable = True
        return res.granted

    # -- contract ----------------------------------------------------------
    def acquire(self, permits: int = 1) -> RateLimitLease:
        """Synchronous exact attempt; never queues (the contract's sync
        path). The reference's exact sync ``Acquire`` silently always failed
        (``RedisTokenBucketRateLimiter.cs:53-56``, known defect); this one
        performs a real blocking store decision."""
        self._check_permits(permits)
        if permits == 0:
            return (SUCCESSFUL_LEASE if self.available_permits() > 0
                    else self._failed_lease(0))
        t0 = time.perf_counter()
        res = self.store.acquire_blocking(
            self.options.instance_name, permits, self.options.token_limit,
            self.options.fill_rate_per_second,
        )
        self._estimated_remaining = res.remaining
        self.metrics.record_decision(res.granted, time.perf_counter() - t0)
        if res.granted:
            self._idle_since = None
        return SUCCESSFUL_LEASE if res.granted else self._failed_lease(permits)

    async def acquire_async(self, permits: int = 1) -> RateLimitLease:
        """Exact store round-trip; on decline, park on the waiter queue to
        be drained by the periodic refresh."""
        self._check_permits(permits)
        self._ensure_refresh_task()
        if permits == 0:
            return (SUCCESSFUL_LEASE if self.available_permits() > 0
                    else self._failed_lease(0))
        # Waiters must not be overtaken under OLDEST_FIRST (same grant gate
        # as the approximate limiter's TryLeaseUnsynchronized, `:202`).
        overtaking_ok = (
            len(self._queue) == 0
            or self.options.queue_processing_order
            is QueueProcessingOrder.NEWEST_FIRST
        )
        if overtaking_ok:
            try:
                granted = await self._store_acquire(permits)
            except Exception as exc:  # degraded mode: store unreachable
                log.could_not_connect_to_store(exc)
                self.metrics.sync_failures += 1
                granted = False
            if granted:
                self.metrics.record_decision(True)
                self._idle_since = None
                return SUCCESSFUL_LEASE
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
        if lease.is_acquired:
            self._idle_since = None
        return lease

    # -- background refresh -------------------------------------------------
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
        """One drain round: retry the queue head against the store, release
        waiters while grants succeed. Public so tests and manual callers can
        step it deterministically (no wall-clock dependence)."""
        if self._refresh_running:  # timer re-entrancy guard
            return
        self._refresh_running = True
        try:
            t0 = time.perf_counter()
            self._store_reachable = False
            await self._queue.drain_async(
                self._try_drain_grant, lambda: SUCCESSFUL_LEASE
            )
            # A "sync" is a round whose store traffic succeeded (matching
            # the approximate limiter, which counts only successful syncs);
            # failed rounds show up in sync_failures, empty rounds nowhere.
            if self._store_reachable:
                self.metrics.syncs += 1
                self.metrics.last_sync_lag_s = time.perf_counter() - t0
        finally:
            self._refresh_running = False

    async def _try_drain_grant(self, count: int) -> bool:
        try:
            return await self._store_acquire(count)
        except Exception as exc:  # degraded: keep waiters for next round
            log.could_not_connect_to_store(exc)
            self.metrics.sync_failures += 1
            return False

    # -- contract (introspection / lifecycle) -------------------------------
    def available_permits(self) -> int:
        if self._estimated_remaining is None:
            return int(self.store.peek_blocking(
                self.options.instance_name, self.options.token_limit,
                self.options.fill_rate_per_second,
            ))
        return int(math.floor(self._estimated_remaining))

    @property
    def idle_duration(self) -> float | None:
        if self._idle_since is None:
            return None
        return time.monotonic() - self._idle_since

    async def aclose(self) -> None:
        """Dispose: stop the refresh loop, fail all parked waiters."""
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
        return {
            "estimated_remaining": self._estimated_remaining,
            "queue_count": self._queue.queue_count,
            **self.metrics.snapshot(),
        }

    def __str__(self) -> str:
        return (
            f"QueueingTokenBucketRateLimiter(bucket={self.options.instance_name!r}, "
            f"estimated_remaining={self._estimated_remaining}, "
            f"queued_permits={self._queue.queue_count})"
        )
