"""Time authority.

Invariant 1 (SURVEY.md §2): the *store* is the single source of truth for
time; clients never supply timestamps. In the reference the Lua kernel calls
Redis ``TIME`` (``TokenBucket/RedisTokenBucketRateLimiter.cs:202-203``). Here
the store's host runtime stamps each kernel launch with ONE monotonic tick
value, so every key in a batch observes the same consistent clock.

``ManualClock`` is the injectable fake used by tests — the kernel math is
deterministic given injected time, which is what makes the L0 layer unit
testable (SURVEY.md §4 implication (a)).
"""

from __future__ import annotations

import time

from distributedratelimiting.redis_tpu_torch.ops.bucket_math import TICKS_PER_SECOND

__all__ = ["Clock", "MonotonicClock", "ManualClock", "TICKS_PER_SECOND"]


class Clock:
    """Abstract tick source. One tick = 1/1024 s."""

    def now_ticks(self) -> int:
        raise NotImplementedError

    def now_seconds(self) -> float:
        return self.now_ticks() / TICKS_PER_SECOND

    def rebase(self, offset_ticks: int) -> None:
        """Shift the epoch forward so ``now_ticks`` shrinks by
        ``offset_ticks`` — paired with the store's ``rebase_*_epoch``
        kernels to keep int32 tick time far from overflow."""
        raise NotImplementedError


class MonotonicClock(Clock):
    """Monotonic wall-clock ticks since construction.

    Monotonicity means the clock-regression clamp
    (``bucket_math.elapsed_ticks``) only ever engages across *store*
    restarts (epoch reset ≙ Redis failover), exactly the scenario the
    reference designed the clamp for
    (``RedisTokenBucketRateLimiter.cs:177-180``).
    """

    def __init__(self) -> None:
        self._epoch = time.monotonic()

    def now_ticks(self) -> int:
        return int((time.monotonic() - self._epoch) * TICKS_PER_SECOND)

    def rebase(self, offset_ticks: int) -> None:
        """Advance the epoch by ``offset_ticks`` so ``now_ticks`` shrinks by
        the same amount. The store calls this together with the
        ``rebase_*_epoch`` kernels before int32 tick time (~24 days) can
        overflow; elapsed values are invariant under the joint shift."""
        self._epoch += offset_ticks / TICKS_PER_SECOND


class ManualClock(Clock):
    """Deterministic test clock; advanced explicitly, may be set backwards
    to exercise the regression clamp."""

    def __init__(self, start_ticks: int = 0) -> None:
        self._ticks = start_ticks

    def now_ticks(self) -> int:
        return self._ticks

    def advance_ticks(self, ticks: int) -> None:
        self._ticks += ticks

    def advance_seconds(self, seconds: float) -> None:
        self._ticks += int(seconds * TICKS_PER_SECOND)

    def set_ticks(self, ticks: int) -> None:
        self._ticks = ticks

    def rebase(self, offset_ticks: int) -> None:
        self._ticks -= offset_ticks
