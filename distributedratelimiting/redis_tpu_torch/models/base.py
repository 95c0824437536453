"""The ``RateLimiter`` abstract contract and lease types.

A Python translation of the abstract surface the reference implements from
the ``System.Threading.RateLimiting`` package (SURVEY.md §2 invariant 7):

=====================  ====================================
.NET                   here
=====================  ====================================
``Acquire(int)``       ``acquire(permits)`` (sync)
``WaitAsync(int, ct)`` ``await acquire_async(permits)``
``GetAvailablePermits````available_permits()``
``IdleDuration``       ``idle_duration`` (seconds or None)
``Dispose/DisposeAsync````close()`` / ``await aclose()``
``RateLimitLease``     :class:`RateLimitLease`
``MetadataName``       :class:`MetadataName`
=====================  ====================================

Contract points preserved: zero-permit probe semantics, ``ValueError`` when
``permits`` exceeds the configured maximum, disposal fails queued waiters,
failed leases may carry ``retry_after`` metadata. Lease ``dispose`` does NOT
return permits — token-bucket cost is consumed, not held (the reference's
lease classes have no Dispose override; SURVEY.md §2 #9).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Any, Iterable

__all__ = ["MetadataName", "RateLimitLease", "RateLimiter",
           "check_permits", "sliding_retry_after",
           "bulk_permit_counts"]


class MetadataName:
    """Well-known lease metadata keys (≙ ``MetadataName.RetryAfter``,
    ``RedisApproximateTokenBucketRateLimiter.cs:575-585``)."""

    RETRY_AFTER = "RETRY_AFTER"  # seconds (float)
    REASON = "REASON"            # str


class RateLimitLease:
    """Result of an acquire. Shared metadata-free success/failure singletons
    keep the hot path allocation-free, as in the reference
    (``RedisTokenBucketRateLimiter.cs:9-10``)."""

    __slots__ = ("_acquired", "_metadata")

    def __init__(self, acquired: bool, metadata: dict[str, Any] | None = None):
        self._acquired = acquired
        self._metadata = metadata

    @property
    def is_acquired(self) -> bool:
        return self._acquired

    @property
    def metadata_names(self) -> Iterable[str]:
        return tuple(self._metadata) if self._metadata else ()

    def try_get_metadata(self, name: str) -> tuple[bool, Any]:
        if self._metadata and name in self._metadata:
            return True, self._metadata[name]
        return False, None

    @property
    def retry_after(self) -> float | None:
        """Convenience accessor for ``MetadataName.RETRY_AFTER`` seconds."""
        ok, val = self.try_get_metadata(MetadataName.RETRY_AFTER)
        return val if ok else None

    def dispose(self) -> None:
        """No-op: token-bucket cost is consumed, never returned."""

    def __enter__(self) -> "RateLimitLease":
        return self

    def __exit__(self, *exc: object) -> None:
        self.dispose()

    def __bool__(self) -> bool:
        return self._acquired

    def __repr__(self) -> str:
        return f"RateLimitLease(acquired={self._acquired})"


#: Allocation-free shared leases for the metadata-free cases.
SUCCESSFUL_LEASE = RateLimitLease(True)
FAILED_LEASE = RateLimitLease(False)


@dataclass(frozen=True)
class RateLimiterStatistics:
    """≙ ``System.Threading.RateLimiting.RateLimiterStatistics``."""

    current_available_permits: int
    total_successful_leases: int
    total_failed_leases: int
    current_queued_count: int


class RateLimiter(abc.ABC):
    """Abstract rate limiter (≙ ``System.Threading.RateLimiting.RateLimiter``)."""

    @abc.abstractmethod
    def acquire(self, permits: int = 1) -> RateLimitLease:
        """Synchronous attempt; never queues. Zero permits = probe."""

    @abc.abstractmethod
    async def acquire_async(self, permits: int = 1) -> RateLimitLease:
        """Asynchronous acquire; may park on the waiter queue (if the
        limiter has one). Cancellation of the awaiting task unwinds queue
        accounting. Zero permits = probe."""

    @abc.abstractmethod
    def available_permits(self) -> int:
        """Best-effort estimate (≙ ``GetAvailablePermits``; explicitly an
        estimate in the reference, ``RedisTokenBucketRateLimiter.cs:48-51``)."""

    @property
    @abc.abstractmethod
    def idle_duration(self) -> float | None:
        """Seconds since the limiter last had consumption in flight, or
        ``None`` if active (≙ ``IdleDuration``, ``…cs:33-34,503-506``)."""

    def get_statistics(self) -> "RateLimiterStatistics":
        """Point-in-time snapshot (≙ the modern .NET
        ``RateLimiter.GetStatistics()``, which post-dates the reference's
        preview dependency — parity-plus): available permits, lifetime
        successful/failed leases, and the current queued count. Backed by
        the limiter's :class:`~..utils.metrics.LimiterMetrics` (every
        concrete family records decisions there) and the waiter queue
        when the family has one."""
        metrics = getattr(self, "metrics", None)
        queue = getattr(self, "_queue", None)
        return RateLimiterStatistics(
            current_available_permits=self.available_permits(),
            total_successful_leases=(metrics.grants if metrics else 0),
            total_failed_leases=(metrics.denials if metrics else 0),
            # Queued PERMITS, not parked waiters: the .NET
            # ``CurrentQueuedCount`` sums permit counts (the reference's
            # accounting does too, ``RedisTokenBucketRateLimiter.cs:129``
            # ``_queueCount += permitCount``) — a waiter parked for 5
            # permits must report 5, which ``WaiterQueue.queue_count``
            # already tracks.
            current_queued_count=(queue.queue_count
                                  if queue is not None
                                  and hasattr(queue, "queue_count")
                                  else 0),
        )

    @abc.abstractmethod
    async def aclose(self) -> None:
        """Dispose: stop background work, fail queued waiters."""

    def close(self) -> None:
        """Synchronous dispose for non-async contexts."""
        import asyncio

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            asyncio.run(self.aclose())
        else:
            loop.create_task(self.aclose())

    async def __aenter__(self) -> "RateLimiter":
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.aclose()


def check_permits(permits: int, limit: int | float) -> None:
    """Shared argument gate (every limiter family): non-negative, and never
    more than the configured limit — the reference throws the same way
    (``RedisApproximateTokenBucketRateLimiter.cs:87-90``)."""
    if permits < 0:
        raise ValueError("permits must be >= 0")
    if permits > limit:
        raise ValueError(
            f"permits ({permits}) cannot exceed the configured limit "
            f"({limit})"
        )


def sliding_retry_after(permits: int, remaining: float, limit: float,
                        window_s: float) -> float:
    """Earliest time a denied sliding-window request could succeed. The
    interpolated window releases the previous window's count linearly as
    it slides, at most ``limit / window_s`` permits/sec — so covering the
    deficit needs at least ``deficit / limit × window`` seconds (exact
    when the previous window was full; optimistic otherwise), and one full
    window always suffices. Single source of truth for every sliding
    limiter (the fixed-window family returns the full window: counts
    release only at the boundary, whose phase lives with the store)."""
    deficit = permits - remaining
    return min(window_s, max(0.0, deficit / limit * window_s))


def bulk_permit_counts(resources, permits, limit: int | float) -> list[int]:
    """Normalize a bulk call's ``permits`` (int applied to all, or a
    per-resource sequence) into validated per-request counts."""
    if isinstance(permits, int):
        counts = [permits] * len(resources)
    else:
        counts = [int(p) for p in permits]
        if len(counts) != len(resources):
            raise ValueError("permits must be an int or match resources")
    for c in counts:
        check_permits(c, limit)
    return counts
