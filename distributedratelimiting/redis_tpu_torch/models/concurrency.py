"""Distributed concurrency limiter — held permits, returned on dispose.

The port of the JAX package's ``models/concurrency.py``. The
``System.Threading.RateLimiting`` family also defines ``ConcurrencyLimiter``,
whose leases hold permits for the work's duration and return them on
``Dispose`` — the opposite of token-bucket cost, which is consumed
(``models/base.py``). Here the active count lives in the shared store
(:meth:`~..runtime.store.BucketStore.concurrency_acquire` /
:meth:`~..runtime.store.BucketStore.concurrency_release`: the semaphore
table of a ``DeviceBucketStore``, whose batches run as the ``sema_packed``
kernel on the card, or an ``OP_SEMA`` frame through a
``RemoteBucketStore``), so N hosts share one ``permit_limit``.

Queueing follows the family contract (cumulative-permit ``queue_limit``,
oldest/newest-first, eviction, cancellation, dispose fails waiters) through
the shared :class:`~..runtime.queueing.WaiterQueue`. Every release drains
the waiters: it offers the freed permits to the queue head before anyone
else sees them.
"""

from __future__ import annotations

import asyncio
import time

from distributedratelimiting.redis_tpu_torch.models.base import (
    FAILED_LEASE,
    RateLimitLease,
    RateLimiter,
    check_permits,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    ConcurrencyLimiterOptions,
)
from distributedratelimiting.redis_tpu_torch.runtime.queueing import (
    QueueProcessingOrder,
    WaiterQueue,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils import log
from distributedratelimiting.redis_tpu_torch.utils.metrics import LimiterMetrics

__all__ = ["ConcurrencyLease", "ConcurrencyLimiter"]


class ConcurrencyLease(RateLimitLease):
    """A lease that HOLDS permits: ``dispose``/``__exit__`` returns them to
    the shared store (sync), ``release_async`` from event-loop code."""

    __slots__ = ("_limiter", "_count", "_released")

    def __init__(self, limiter: "ConcurrencyLimiter", count: int) -> None:
        super().__init__(True)
        self._limiter = limiter
        self._count = count
        self._released = False

    def dispose(self) -> None:
        if self._released:
            return  # idempotent — double-dispose must not over-release
        self._released = True
        self._limiter._release_blocking(self._count)

    async def release_async(self) -> None:
        if self._released:
            return
        self._released = True
        await self._limiter._release(self._count)

    async def __aenter__(self) -> "ConcurrencyLease":
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.release_async()


class ConcurrencyLimiter(RateLimiter):
    """≙ ``System.Threading.RateLimiting.ConcurrencyLimiter``, with the
    active count in the shared store (one logical semaphore per
    ``instance_name`` across every host sharing the store)."""

    def __init__(self, options: ConcurrencyLimiterOptions,
                 store: BucketStore) -> None:
        self.options = options
        self.store = store
        self.metrics = LimiterMetrics()
        self._queue = WaiterQueue(options.queue_limit,
                                  options.queue_processing_order)
        self._idle_since: float | None = time.monotonic()
        self._disposed = False
        self._draining = False
        self._drain_again = False
        self._retry_task: asyncio.Task | None = None
        self._drain_tasks: set[asyncio.Task] = set()  # strong refs

    def _check_permits(self, permits: int) -> None:
        check_permits(permits, self.options.permit_limit)
        if self._disposed:
            raise RuntimeError("limiter is disposed")

    def _lease(self, count: int) -> ConcurrencyLease:
        self._idle_since = None
        self.metrics.record_decision(True)
        return ConcurrencyLease(self, count)

    def _failed(self) -> RateLimitLease:
        self.metrics.record_decision(False)
        return FAILED_LEASE

    # -- acquire -----------------------------------------------------------
    def acquire(self, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:  # zero-permit probe
            ok = self.available_permits() > 0
            self.metrics.record_decision(ok)
            return ConcurrencyLease(self, 0) if ok else FAILED_LEASE
        # Same queue-fairness gate as the async path (≙ the family's
        # TryLeaseUnsynchronized queue check): a sync caller must not
        # overtake parked OLDEST_FIRST waiters.
        if (len(self._queue)
                and self.options.queue_processing_order
                is QueueProcessingOrder.OLDEST_FIRST):
            return self._failed()
        res = self.store.concurrency_acquire_blocking(
            self.options.instance_name, permits, self.options.permit_limit)
        return self._lease(permits) if res.granted else self._failed()

    async def acquire_async(self, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            # Async read-only probe — never blocks the event loop.
            res = await self.store.concurrency_acquire(
                self.options.instance_name, 0, self.options.permit_limit)
            ok = self.options.permit_limit - int(res.remaining) > 0
            self.metrics.record_decision(ok)
            return ConcurrencyLease(self, 0) if ok else FAILED_LEASE
        # Fast path only when no waiter would be overtaken (the family's
        # queue-fairness gate, ≙ TryLeaseUnsynchronized's queue check).
        if (len(self._queue) == 0
                or self.options.queue_processing_order
                is QueueProcessingOrder.NEWEST_FIRST):
            # Shield the store round-trip: a cancel that lands mid-flight
            # must not leak permits the store already granted. The op runs
            # to completion; if it granted, the permits go straight back.
            acq = asyncio.ensure_future(self.store.concurrency_acquire(
                self.options.instance_name, permits,
                self.options.permit_limit))
            try:
                res = await asyncio.shield(acq)
            except asyncio.CancelledError:
                self.metrics.cancelled += 1
                # Track a wrapper that awaits the in-flight store op AND its
                # compensating release as ONE drain task: if only the
                # release (created later by a done-callback) were tracked,
                # an aclose() racing the still-in-flight acquire would find
                # nothing to await and the granted permits would strand in
                # the SHARED store.
                cleanup = acq.get_loop().create_task(
                    self._await_release_if_granted(acq, permits))
                self._drain_tasks.add(cleanup)
                cleanup.add_done_callback(self._drain_tasks.discard)
                raise
            if res.granted:
                return self._lease(permits)
        future, evicted = self._queue.try_enqueue(permits)
        for victim in evicted:
            self.metrics.evicted += 1
            victim.future.set_result(FAILED_LEASE)
        if future is None:
            return self._failed()
        self.metrics.queued += 1
        self._ensure_retry_task()
        try:
            lease = await future
        except asyncio.CancelledError:
            self.metrics.cancelled += 1
            # The drain may have granted to this waiter already (future
            # resolved with a held lease, awaiting task cancelled before
            # resuming) — release those permits or they leak forever:
            # sweep_semas never reclaims slots with active > 0.
            if future.done() and not future.cancelled():
                granted = future.result()
                if isinstance(granted, ConcurrencyLease) and granted.is_acquired:
                    self._spawn_release(granted)
            raise
        self.metrics.record_decision(lease.is_acquired)
        return lease

    async def _await_release_if_granted(self, acq: asyncio.Task,
                                        permits: int) -> None:
        """Cleanup for a cancelled-but-shielded store acquire: wait for the
        store's verdict; if it granted, return the permits."""
        try:
            res = await acq
        except (asyncio.CancelledError, Exception):
            return  # acquire never granted — nothing to return
        if res.granted:
            await self.store.concurrency_release(
                self.options.instance_name, permits)

    def _spawn_release(self, lease: ConcurrencyLease) -> None:
        task = asyncio.get_running_loop().create_task(lease.release_async())
        self._drain_tasks.add(task)
        task.add_done_callback(self._drain_tasks.discard)

    def _ensure_retry_task(self) -> None:
        """Parked waiters re-probe the store every ``retry_period_s`` —
        the only way permits released by a DIFFERENT instance sharing the
        semaphore reach local waiters (store-mediated coordination only,
        like everything else in this family). Stops when the queue empties."""
        if self._retry_task is not None and not self._retry_task.done():
            return

        async def loop() -> None:
            while not self._disposed and len(self._queue):
                await asyncio.sleep(self.options.retry_period_s)
                try:
                    await self._drain()
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    # Degraded mode: store unreachable — keep polling, the
                    # waiters outlive the outage (invariant 9's posture).
                    log.error_evaluating_kernel(exc)

        self._retry_task = asyncio.get_running_loop().create_task(loop())

    # -- release + waiter drain --------------------------------------------
    async def _release(self, count: int) -> None:
        await self.store.concurrency_release(
            self.options.instance_name, count)
        await self._drain()
        self._mark_idle_if_unused()

    def _release_blocking(self, count: int) -> None:
        self.store.concurrency_release_blocking(
            self.options.instance_name, count)
        # Waiters only exist on an event loop; schedule a drain if one is
        # running (dispose from sync code on a loop-less thread has no
        # waiters to serve by construction).
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            pass
        else:
            task = loop.create_task(self._drain_logged())
            # asyncio keeps only weak task refs — an unreferenced drain
            # could be collected mid-await and strand the queue head.
            self._drain_tasks.add(task)
            task.add_done_callback(self._drain_tasks.discard)
        self._mark_idle_if_unused()

    async def _drain_logged(self) -> None:
        try:
            await self._drain()
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # degraded mode: waiters wait for retry
            log.error_evaluating_kernel(exc)

    async def _drain(self) -> None:
        """Hand freed permits to parked waiters, oldest/newest-first.
        Single-flight: concurrent releases coalesce onto the running drain
        (which restarts if a release arrived while it ran)."""
        if self._draining:
            self._drain_again = True
            return
        self._draining = True
        try:
            while not self._disposed:
                head = self._queue.peek_next()
                if head is None:
                    if self._drain_again:
                        self._drain_again = False
                        continue
                    break
                res = await self.store.concurrency_acquire(
                    self.options.instance_name, head.count,
                    self.options.permit_limit)
                if not res.granted:
                    if self._drain_again:
                        self._drain_again = False
                        continue
                    break
                # Re-confirm the waiter we acquired for is still next —
                # it may have been cancelled (or the queue failed) during
                # the store round-trip. Held permits are returnable, so
                # the mismatch case releases instead of stranding them
                # (the token-bucket drain can't do this; its cost is
                # consumed — drain_async's documented loss).
                if self._queue.peek_next() is not head or head.future.done():
                    await self.store.concurrency_release(
                        self.options.instance_name, head.count)
                    continue
                self._queue.pop_next()
                self._idle_since = None  # a held lease makes us non-idle
                head.future.set_result(ConcurrencyLease(self, head.count))
        finally:
            self._draining = False

    def _mark_idle_if_unused(self) -> None:
        if self._idle_since is None and len(self._queue) == 0:
            self._idle_since = time.monotonic()

    # -- contract ----------------------------------------------------------
    def available_permits(self) -> int:
        res = self.store.concurrency_acquire_blocking(
            self.options.instance_name, 0, self.options.permit_limit)
        return max(0, self.options.permit_limit - int(res.remaining))

    @property
    def idle_duration(self) -> float | None:
        if self._idle_since is None:
            return None
        return time.monotonic() - self._idle_since

    async def aclose(self) -> None:
        if self._disposed:
            return
        self._disposed = True
        if self._retry_task is not None:
            self._retry_task.cancel()
            try:
                await self._retry_task
            except (asyncio.CancelledError, Exception):
                pass
            self._retry_task = None
        self._queue.fail_all(lambda: FAILED_LEASE)
        # In-flight drain/compensating-release tasks must complete before
        # shutdown — dropping one with the loop would strand permits in
        # the SHARED store (other instances' capacity, not just ours).
        if self._drain_tasks:
            await asyncio.gather(*list(self._drain_tasks),
                                 return_exceptions=True)

    def stats(self) -> dict:
        return {
            "queue_count": self._queue.queue_count,
            **self.metrics.snapshot(),
        }
