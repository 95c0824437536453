"""Partitioned (per-key) rate limiter — the batched keyed façade.

The reference sketched this and never shipped it: the entire
``PartitionedRedisTokenBucketRateLimiter`` is commented out
(``TokenBucket/PartitionedRedisTokenBucketRateLimiter.cs:6-213``, dead
component #13), its README naming request batching as the missing piece
(``README.md:7``). This completes the intent the batched way:

- partition key = ``instance_name + separator + str(resource)`` — exactly
  the reference's key-concatenation scheme (``:42``), one independent
  bucket per partition (keys never interact; SURVEY.md §5.7);
- every partition of one limiter shares a single homogeneous-config device
  table, so concurrent ``acquire`` calls across *all* partitions coalesce
  into one kernel launch — the batching the reference never built.
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
)
from distributedratelimiting.redis_tpu_torch.models.options import TokenBucketOptions
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils.metrics import LimiterMetrics

__all__ = ["PartitionedRateLimiter"]


class PartitionedRateLimiter:
    """≙ ``PartitionedRateLimiter<TResource>``: acquire against a resource,
    each resource getting its own token bucket with shared options."""

    def __init__(
        self,
        options: TokenBucketOptions,
        store: BucketStore,
        partition_key: Callable[[object], str] = str,
    ) -> None:
        self.options = options
        self.store = store
        self.partition_key = partition_key
        self.metrics = LimiterMetrics()
        # Lazily-bound per-config hot path (store.acquire_submitter):
        # created on first acquire_async so construction stays device-free.
        self._submit = None

    def _key(self, resource: object) -> str:
        # Key concatenation, one store bucket per partition (dead ref :42).
        return f"{self.options.instance_name}:{self.partition_key(resource)}"

    def _check_permits(self, permits: int) -> None:
        check_permits(permits, self.options.token_limit)

    def _lease(self, granted: bool, remaining: float, permits: int,
               latency_s: float) -> RateLimitLease:
        self.metrics.record_decision(granted, latency_s)
        if granted:
            return SUCCESSFUL_LEASE
        deficit = permits - remaining
        return RateLimitLease(False, {
            MetadataName.RETRY_AFTER: max(
                0.0, deficit / self.options.fill_rate_per_second
            ),
        })

    def acquire(self, resource: object, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            return SUCCESSFUL_LEASE
        t0 = time.perf_counter()
        res = self.store.acquire_blocking(
            self._key(resource), permits, self.options.token_limit,
            self.options.fill_rate_per_second,
        )
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    async def acquire_async(self, resource: object,
                            permits: int = 1) -> RateLimitLease:
        """Micro-batched: concurrent calls across partitions share one
        kernel launch."""
        self._check_permits(permits)
        if permits == 0:
            return SUCCESSFUL_LEASE
        submit = self._submit
        if submit is None:
            submit = self._submit = self.store.acquire_submitter(
                self.options.token_limit, self.options.fill_rate_per_second)
            await self.store.connect()
        t0 = time.perf_counter()
        res = await submit(self._key(resource), permits)
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    # -- bulk path ---------------------------------------------------------
    def _bulk_args(self, resources, permits):
        counts = bulk_permit_counts(resources, permits,
                                    self.options.token_limit)
        return [self._key(r) for r in resources], counts

    def _record_bulk(self, res, counts, t0: float) -> None:
        # Zero-permit probes are granted at the STORE layer on every bulk
        # path (BucketStore._grant_probes / the per-request kernel), so the
        # limiter needs no patch-up here.
        self.metrics.record_bulk(len(res), res.granted_count,
                                 time.perf_counter() - t0)

    async def acquire_many(self, resources: list, permits=1, *,
                           with_remaining: bool = True):
        """Decide many partitions in ONE call — a single await, no
        per-request futures (the bulk serving surface; per-request
        ``acquire_async`` remains for latency-sensitive single decisions).
        ``permits`` is an int applied to all, or a per-resource sequence;
        ``with_remaining=False`` skips remaining estimates (verdict-only
        fast path). Returns :class:`~.store.BulkAcquireResult`."""
        keys, counts = self._bulk_args(resources, permits)
        t0 = time.perf_counter()
        res = await self.store.acquire_many(
            keys, counts, self.options.token_limit,
            self.options.fill_rate_per_second,
            with_remaining=with_remaining)
        self._record_bulk(res, counts, t0)
        return res

    def acquire_many_blocking(self, resources: list, permits=1, *,
                              with_remaining: bool = True):
        keys, counts = self._bulk_args(resources, permits)
        t0 = time.perf_counter()
        res = self.store.acquire_many_blocking(
            keys, counts, self.options.token_limit,
            self.options.fill_rate_per_second,
            with_remaining=with_remaining)
        self._record_bulk(res, counts, t0)
        return res

    def available_permits(self, resource: object) -> int:
        return int(self.store.peek_blocking(
            self._key(resource), self.options.token_limit,
            self.options.fill_rate_per_second,
        ))

    def get_statistics(self, resource: object) -> "RateLimiterStatistics":
        """Point-in-time snapshot for one resource (≙ the modern .NET
        ``PartitionedRateLimiter<TResource>.GetStatistics(resource)``).
        Available permits are per-resource (a read-only peek); lease
        counters are limiter-wide — partitions here share one device
        table rather than owning one ``RateLimiter`` each, so per-
        partition lease history isn't tracked (documented deviation).
        Never queues, so ``current_queued_count`` is structurally 0."""
        from distributedratelimiting.redis_tpu_torch.models.base import (
            RateLimiterStatistics,
        )

        return RateLimiterStatistics(
            current_available_permits=self.available_permits(resource),
            total_successful_leases=self.metrics.grants,
            total_failed_leases=self.metrics.denials,
            current_queued_count=0,
        )

    async def aclose(self) -> None:
        pass
