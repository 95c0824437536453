"""Options dataclasses — the configuration layer.

Frozen dataclasses with fail-fast validation and derived values computed
once. Only the exact token bucket's options are ported so far.

- ``replenishment_period_s`` must be **> 0** — a zero period would make the
  fill rate infinite.
- Validation lives in ``__post_init__`` so an invalid options object cannot
  exist.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["TokenBucketOptions"]


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
