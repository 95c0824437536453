"""Fixed-window counter limiter (``FixedWindowRateLimiter`` of
``System.Threading.RateLimiting``).

Consumption counts against the window holding ``now`` only and resets at
every window boundary (the 2× boundary burst the sliding window smooths).
Everything but the store call is the sliding limiter's: the same window
table, atomicity, time authority and sweeps, with the kernels' trailing-window
interpolation off.
"""

from __future__ import annotations

from distributedratelimiting.redis_tpu_torch.models.options import (
    FixedWindowOptions,
)
from distributedratelimiting.redis_tpu_torch.models.sliding_window import (
    SlidingWindowRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore

__all__ = ["FixedWindowRateLimiter"]


class FixedWindowRateLimiter(SlidingWindowRateLimiter):
    def __init__(self, options: FixedWindowOptions,
                 store: BucketStore) -> None:
        super().__init__(options, store)  # type: ignore[arg-type]

    def _store_acquire_blocking(self, permits: int):
        return self.store.fixed_window_acquire_blocking(
            self.options.instance_name, permits, self.options.permit_limit,
            self.options.window_s)

    async def _store_acquire(self, permits: int):
        return await self.store.fixed_window_acquire(
            self.options.instance_name, permits, self.options.permit_limit,
            self.options.window_s)

    def _retry_after(self, permits: int, remaining: float) -> float:
        # Counts release only at the boundary, whose phase lives with the
        # store: the sure bound is one full window.
        return self.options.window_s
