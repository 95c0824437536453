"""Partitioned (per-key) window limiter — the keyed window façade.

The window counterpart of :class:`~.partitioned.PartitionedRateLimiter`: one
independent sliding or fixed window per resource, partition key
``instance_name + ":" + str(resource)``, every partition sharing one window
table, so concurrent acquires coalesce into one kernel launch and whole key
arrays decide in one ``acquire_many`` call (BASELINE config 4's serving
shape).
"""

from __future__ import annotations

import time
from typing import Callable

from distributedratelimiting.redis_tpu_torch.models.base import (
    SUCCESSFUL_LEASE,
    MetadataName,
    RateLimitLease,
    bulk_permit_counts,
    check_permits,
    sliding_retry_after,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    FixedWindowOptions,
    SlidingWindowOptions,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LimiterMetrics,
)

__all__ = ["PartitionedWindowRateLimiter"]


class PartitionedWindowRateLimiter:
    """Per-resource window limiting with shared options:
    :class:`SlidingWindowOptions` for the interpolated sliding window,
    :class:`FixedWindowOptions` for boundary-reset fixed windows."""

    def __init__(
        self,
        options: "SlidingWindowOptions | FixedWindowOptions",
        store: BucketStore,
        partition_key: Callable[[object], str] = str,
    ) -> None:
        self.options = options
        self.store = store
        self.partition_key = partition_key
        self.fixed = isinstance(options, FixedWindowOptions)
        self.metrics = LimiterMetrics()

    def _key(self, resource: object) -> str:
        return f"{self.options.instance_name}:{self.partition_key(resource)}"

    def _check_permits(self, permits: int) -> None:
        check_permits(permits, self.options.permit_limit)

    def _retry_after(self, permits: int, remaining: float) -> float:
        if self.fixed:
            # Counts release only at the boundary: one full window.
            return self.options.window_s
        return sliding_retry_after(permits, remaining,
                                   self.options.permit_limit,
                                   self.options.window_s)

    def _lease(self, granted: bool, remaining: float, permits: int,
               latency_s: float) -> RateLimitLease:
        self.metrics.record_decision(granted, latency_s)
        if granted:
            return SUCCESSFUL_LEASE
        return RateLimitLease(False, {
            MetadataName.RETRY_AFTER: self._retry_after(permits, remaining),
        })

    def _store_op(self, blocking: bool):
        if self.fixed:
            return (self.store.fixed_window_acquire_blocking if blocking
                    else self.store.fixed_window_acquire)
        return (self.store.window_acquire_blocking if blocking
                else self.store.window_acquire)

    def acquire(self, resource: object, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            return SUCCESSFUL_LEASE
        t0 = time.perf_counter()
        res = self._store_op(blocking=True)(
            self._key(resource), permits, self.options.permit_limit,
            self.options.window_s)
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    async def acquire_async(self, resource: object,
                            permits: int = 1) -> RateLimitLease:
        """Micro-batched: concurrent calls across partitions share one
        kernel launch."""
        self._check_permits(permits)
        if permits == 0:
            return SUCCESSFUL_LEASE
        t0 = time.perf_counter()
        res = await self._store_op(blocking=False)(
            self._key(resource), permits, self.options.permit_limit,
            self.options.window_s)
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    # -- bulk path ---------------------------------------------------------
    def _bulk_args(self, resources, permits):
        counts = bulk_permit_counts(resources, permits,
                                    self.options.permit_limit)
        return [self._key(r) for r in resources], counts

    async def acquire_many(self, resources, permits=1, *,
                           with_remaining: bool = True):
        """Decide many partitions' windows in ONE call (one await, no
        per-request futures). Returns a :class:`~.store.BulkAcquireResult`."""
        keys, counts = self._bulk_args(resources, permits)
        t0 = time.perf_counter()
        res = await self.store.window_acquire_many(
            keys, counts, self.options.permit_limit, self.options.window_s,
            fixed=self.fixed, with_remaining=with_remaining)
        self.metrics.record_bulk(len(res), res.granted_count,
                                 time.perf_counter() - t0)
        return res

    def acquire_many_blocking(self, resources, permits=1, *,
                              with_remaining: bool = True):
        keys, counts = self._bulk_args(resources, permits)
        t0 = time.perf_counter()
        res = self.store.window_acquire_many_blocking(
            keys, counts, self.options.permit_limit, self.options.window_s,
            fixed=self.fixed, with_remaining=with_remaining)
        self.metrics.record_bulk(len(res), res.granted_count,
                                 time.perf_counter() - t0)
        return res

    async def aclose(self) -> None:
        pass
