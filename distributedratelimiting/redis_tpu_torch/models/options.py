"""Options dataclasses — the configuration layer.

Frozen dataclasses with fail-fast validation and derived values computed
once: the token-bucket family (exact, queueing, approximate), the window
family (fixed, sliding) and the concurrency (held-permit) limiter.

- ``replenishment_period_s`` must be **> 0** — a zero period would make the
  fill rate infinite.
- Validation lives in ``__post_init__`` so an invalid options object cannot
  exist.
"""

from __future__ import annotations

from dataclasses import dataclass

from distributedratelimiting.redis_tpu_torch.runtime.queueing import (
    QueueProcessingOrder,
)

__all__ = [
    "TokenBucketOptions",
    "ApproximateTokenBucketOptions",
    "QueueingTokenBucketOptions",
    "FixedWindowOptions",
    "SlidingWindowOptions",
    "ConcurrencyLimiterOptions",
]


@dataclass(frozen=True)
class TokenBucketOptions:
    """Exact token bucket (≙ ``RedisTokenBucketRateLimiterOptions``).

    ``instance_name`` is the bucket key in the shared store — limiter
    instances on any number of hosts that share a store and an instance
    name share one bucket.
    """

    token_limit: int = 100
    tokens_per_period: int = 1
    replenishment_period_s: float = 1.0
    instance_name: str = "rate-limiter"

    def __post_init__(self) -> None:
        if self.token_limit <= 0:
            raise ValueError("token_limit must be > 0")
        if self.tokens_per_period <= 0:
            raise ValueError("tokens_per_period must be > 0")
        if self.replenishment_period_s <= 0:
            raise ValueError(
                "replenishment_period_s must be > 0 (a zero period would "
                "make the fill rate infinite)"
            )

    @property
    def fill_rate_per_second(self) -> float:
        """Derived ``FillRatePerSecond``."""
        return self.tokens_per_period / self.replenishment_period_s


@dataclass(frozen=True)
class QueueingTokenBucketOptions(TokenBucketOptions):
    """Queueing + exact hybrid options (≙ the reference's orphaned
    ``RedisQueueingTokenBucketRateLimiterOptions``; here the hybrid is live,
    see :class:`~.queueing_token_bucket.QueueingTokenBucketRateLimiter`).
    Also the base for every queueing-capable options family, so queueing
    validation lives in exactly one place."""

    queue_limit: int = 0
    queue_processing_order: QueueProcessingOrder = QueueProcessingOrder.OLDEST_FIRST

    def __post_init__(self) -> None:
        super().__post_init__()
        if self.queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")


@dataclass(frozen=True)
class ApproximateTokenBucketOptions(QueueingTokenBucketOptions):
    """Approximate two-level limiter options
    (≙ ``RedisApproximateTokenBucketRateLimiterOptions`` — the same
    queueing surface, inherited from :class:`QueueingTokenBucketOptions`)."""


@dataclass(frozen=True)
class ConcurrencyLimiterOptions:
    """Concurrency (held-permit) limiter options (≙
    ``ConcurrencyLimiterOptions`` of ``System.Threading.RateLimiting``);
    ``instance_name`` keys one shared semaphore across every host sharing
    the store."""

    permit_limit: int = 10
    queue_limit: int = 0
    queue_processing_order: QueueProcessingOrder = QueueProcessingOrder.OLDEST_FIRST
    instance_name: str = "rate-limiter"
    #: How often parked waiters re-probe the shared store. Local releases
    #: drain at once; the poll serves permits freed by OTHER instances
    #: sharing the semaphore (no cross-instance signal exists).
    retry_period_s: float = 0.05

    def __post_init__(self) -> None:
        if self.permit_limit <= 0:
            raise ValueError("permit_limit must be > 0")
        if self.queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")
        if self.retry_period_s <= 0:
            raise ValueError("retry_period_s must be > 0")


@dataclass(frozen=True)
class FixedWindowOptions:
    """Fixed-window counter limiter options (≙
    ``FixedWindowRateLimiterOptions`` of ``System.Threading.RateLimiting``)."""

    permit_limit: int = 100
    window_s: float = 1.0
    instance_name: str = "rate-limiter"

    def __post_init__(self) -> None:
        if self.permit_limit <= 0:
            raise ValueError("permit_limit must be > 0")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")


@dataclass(frozen=True)
class SlidingWindowOptions:
    """Sliding-window counter limiter options (BASELINE config 4)."""

    permit_limit: int = 100
    window_s: float = 1.0
    instance_name: str = "rate-limiter"

    def __post_init__(self) -> None:
        if self.permit_limit <= 0:
            raise ValueError("permit_limit must be > 0")
        if self.window_s <= 0:
            raise ValueError("window_s must be > 0")
