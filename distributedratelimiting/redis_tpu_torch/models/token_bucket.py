"""Exact token-bucket limiter: every decision is a store round-trip.

Capability mirror of ``RedisTokenBucketRateLimiter``
(``TokenBucket/RedisTokenBucketRateLimiter.cs``): one limiter instance =
one named bucket in the shared store; every acquire executes the atomic
refill-and-decrement kernel against that bucket (``WaitAsyncCore`` →
``ScriptEvaluateAsync``, ``:58-82``). What the reference paid one Redis RTT
for, this pays one micro-batched kernel launch for — concurrent acquires
across all limiters and partitions sharing a :class:`DeviceBucketStore`
ride the same launch.

Deliberate departures (SURVEY.md §2 defects):
- sync ``acquire`` performs a real blocking decision instead of silently
  always failing (``:53-56``).
- failed leases carry corrected ``retry_after`` metadata
  (``deficit / fill_rate``).
"""

from __future__ import annotations

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
from distributedratelimiting.redis_tpu_torch.models.options import TokenBucketOptions
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils.metrics import LimiterMetrics

__all__ = ["TokenBucketRateLimiter"]


class TokenBucketRateLimiter(RateLimiter):
    def __init__(self, options: TokenBucketOptions, store: BucketStore) -> None:
        self.options = options
        self.store = store
        self.metrics = LimiterMetrics()
        # ≙ _estimatedRemainingPermits cache (:48-51,67,73): refreshed from
        # every decision's reply, served by available_permits().
        self._estimated_remaining: float | None = None
        self._idle_since: float | None = time.monotonic()

    # -- helpers -----------------------------------------------------------
    def _check_permits(self, permits: int) -> None:
        # ≙ throw-if-over-limit (:87-90 in the approximate variant).
        check_permits(permits, self.options.token_limit)

    def _lease(self, granted: bool, remaining: float, permits: int,
               latency_s: float | None = None) -> RateLimitLease:
        self._estimated_remaining = remaining
        self.metrics.record_decision(granted, latency_s)
        if granted:
            if permits > 0:
                self._idle_since = None
            return SUCCESSFUL_LEASE
        deficit = permits - remaining
        rate = self.options.fill_rate_per_second
        # Corrected retry math: deficit / rate (reference defect inverted it).
        return RateLimitLease(False, {
            MetadataName.RETRY_AFTER: max(0.0, deficit / rate),
        })

    # -- contract ----------------------------------------------------------
    def acquire(self, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            # Zero-permit probe: succeeds iff tokens are currently available.
            return SUCCESSFUL_LEASE if self.available_permits() > 0 else FAILED_LEASE
        t0 = time.perf_counter()
        res = self.store.acquire_blocking(
            self.options.instance_name, permits, self.options.token_limit,
            self.options.fill_rate_per_second,
        )
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    async def acquire_async(self, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            return SUCCESSFUL_LEASE if self.available_permits() > 0 else FAILED_LEASE
        t0 = time.perf_counter()
        res = await self.store.acquire(
            self.options.instance_name, permits, self.options.token_limit,
            self.options.fill_rate_per_second,
        )
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

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
        """The limiter does not own the (shared) store; nothing to stop."""

    def __str__(self) -> str:
        return (
            f"TokenBucketRateLimiter(bucket={self.options.instance_name!r}, "
            f"estimated_remaining={self._estimated_remaining})"
        )
