"""Sliding-window counter limiter (BASELINE config 4).

The standard two-counter interpolated sliding window: a key's consumption
over the trailing window is estimated as ``curr + prev * (1 - frac)``, from
the counts of the current and the previous fixed windows. Decisions run
store-side with the token bucket's atomicity, time authority and
init-on-miss (on the card: ``ops/cuda_kernels.window_*``).
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
    sliding_retry_after,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    SlidingWindowOptions,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LimiterMetrics,
)

__all__ = ["SlidingWindowRateLimiter"]


class SlidingWindowRateLimiter(RateLimiter):
    def __init__(self, options: SlidingWindowOptions,
                 store: BucketStore) -> None:
        self.options = options
        self.store = store
        self.metrics = LimiterMetrics()
        self._estimated_remaining: float | None = None
        self._idle_since: float | None = time.monotonic()

    def _check_permits(self, permits: int) -> None:
        check_permits(permits, self.options.permit_limit)

    def _lease(self, granted: bool, remaining: float, permits: int,
               latency_s: float | None = None) -> RateLimitLease:
        self._estimated_remaining = remaining
        self.metrics.record_decision(granted, latency_s)
        if granted:
            if permits > 0:
                self._idle_since = None
            return SUCCESSFUL_LEASE
        return RateLimitLease(False, {
            MetadataName.RETRY_AFTER: self._retry_after(permits, remaining),
        })

    def _retry_after(self, permits: int, remaining: float) -> float:
        """See :func:`~.base.sliding_retry_after`; the fixed-window subclass
        overrides it with the full-window bound."""
        return sliding_retry_after(permits, remaining,
                                   self.options.permit_limit,
                                   self.options.window_s)

    # Store-call hooks: the fixed-window subclass overrides only these.
    def _store_acquire_blocking(self, permits: int):
        return self.store.window_acquire_blocking(
            self.options.instance_name, permits, self.options.permit_limit,
            self.options.window_s)

    async def _store_acquire(self, permits: int):
        return await self.store.window_acquire(
            self.options.instance_name, permits, self.options.permit_limit,
            self.options.window_s)

    def acquire(self, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            return (SUCCESSFUL_LEASE if self.available_permits() > 0
                    else FAILED_LEASE)
        t0 = time.perf_counter()
        res = self._store_acquire_blocking(permits)
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    async def acquire_async(self, permits: int = 1) -> RateLimitLease:
        self._check_permits(permits)
        if permits == 0:
            return (SUCCESSFUL_LEASE if self.available_permits() > 0
                    else FAILED_LEASE)
        t0 = time.perf_counter()
        res = await self._store_acquire(permits)
        return self._lease(res.granted, res.remaining, permits,
                           time.perf_counter() - t0)

    def available_permits(self) -> int:
        if self._estimated_remaining is None:
            return self.options.permit_limit
        return int(math.floor(self._estimated_remaining))

    @property
    def idle_duration(self) -> float | None:
        if self._idle_since is None:
            return None
        return time.monotonic() - self._idle_since

    async def aclose(self) -> None:
        pass
