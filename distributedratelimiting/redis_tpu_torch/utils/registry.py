"""Service registry — the DI/composition layer, ported from the JAX
package's ``utils/registry.py``.

The Python form of ``ServiceCollectionExtensions``: each ``add_tpu_*``
helper registers an options-configured limiter of this package as a lazily
constructed singleton under the ``"rate_limiter"`` service name, as the
reference registers each concrete limiter under the ``RateLimiter`` service
type — except that a second limiter under the same name raises instead of
making resolution ambiguous. The store is passed in or resolved from the
registry's ``"bucket_store"`` service. (The helpers keep the JAX package's
``add_tpu_*`` names, so a caller switches packages by its import alone.)
"""

from __future__ import annotations

from typing import Any, Callable

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    ApproximateTokenBucketRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.concurrency import (
    ConcurrencyLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.fixed_window import (
    FixedWindowRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    ApproximateTokenBucketOptions,
    ConcurrencyLimiterOptions,
    FixedWindowOptions,
    QueueingTokenBucketOptions,
    SlidingWindowOptions,
    TokenBucketOptions,
)
from distributedratelimiting.redis_tpu_torch.models.queueing_token_bucket import (
    QueueingTokenBucketRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.sliding_window import (
    SlidingWindowRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.token_bucket import (
    TokenBucketRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore

__all__ = [
    "ServiceRegistry",
    "RATE_LIMITER",
    "add_tpu_token_bucket_rate_limiter",
    "add_tpu_approximate_token_bucket_rate_limiter",
    "add_tpu_queueing_token_bucket_rate_limiter",
    "add_tpu_sliding_window_rate_limiter",
    "add_tpu_partitioned_window_rate_limiter",
    "add_tpu_concurrency_limiter",
    "add_tpu_fixed_window_rate_limiter",
]

RATE_LIMITER = "rate_limiter"
BUCKET_STORE = "bucket_store"


class ServiceRegistry:
    """Minimal singleton container: ``add_singleton(name, factory)`` +
    ``resolve(name)`` with lazy construction (the reference's limiters are
    likewise constructed on first resolve, SURVEY.md §3.4)."""

    def __init__(self) -> None:
        self._factories: dict[str, Callable[["ServiceRegistry"], Any]] = {}
        self._instances: dict[str, Any] = {}

    def add_singleton(self, name: str,
                      factory: Callable[["ServiceRegistry"], Any]) -> None:
        if name in self._factories:
            raise ValueError(
                f"service {name!r} is already registered — use a distinct "
                "name per limiter (the reference allowed this collision and "
                "made resolution ambiguous)"
            )
        self._factories[name] = factory

    def resolve(self, name: str) -> Any:
        if name not in self._instances:
            if name not in self._factories:
                raise KeyError(f"no service registered under {name!r}")
            self._instances[name] = self._factories[name](self)
        return self._instances[name]

    def __contains__(self, name: str) -> bool:
        return name in self._factories


def _store_of(registry: ServiceRegistry, store: BucketStore | None) -> BucketStore:
    return store if store is not None else registry.resolve(BUCKET_STORE)


def add_tpu_token_bucket_rate_limiter(
    registry: ServiceRegistry,
    configure: Callable[[], TokenBucketOptions],
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    """≙ ``AddRedisTokenBucketRateLimiter`` (``ServiceCollectionExtensions.cs:10-17``)."""
    registry.add_singleton(
        service_name,
        lambda reg: TokenBucketRateLimiter(configure(), _store_of(reg, store)),
    )


def add_tpu_approximate_token_bucket_rate_limiter(
    registry: ServiceRegistry,
    configure: Callable[[], ApproximateTokenBucketOptions],
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    """≙ ``AddRedisApproximateTokenBucketRateLimiter`` (``:19-26``)."""
    registry.add_singleton(
        service_name,
        lambda reg: ApproximateTokenBucketRateLimiter(
            configure(), _store_of(reg, store)
        ),
    )


def add_tpu_queueing_token_bucket_rate_limiter(
    registry: ServiceRegistry,
    configure: Callable[[], QueueingTokenBucketOptions],
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    """Registers the finished queueing+exact hybrid (the reference's dead
    component #14 had no DI method; its options class was orphaned)."""
    registry.add_singleton(
        service_name,
        lambda reg: QueueingTokenBucketRateLimiter(
            configure(), _store_of(reg, store)
        ),
    )


def add_tpu_concurrency_limiter(
    registry: ServiceRegistry,
    configure: Callable[[], ConcurrencyLimiterOptions],
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    """Registers the distributed concurrency (held-permit) limiter — the
    ``System.Threading.RateLimiting`` family member the reference never
    distributed."""
    registry.add_singleton(
        service_name,
        lambda reg: ConcurrencyLimiter(configure(), _store_of(reg, store)),
    )


def add_tpu_fixed_window_rate_limiter(
    registry: ServiceRegistry,
    configure: Callable[[], FixedWindowOptions],
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    registry.add_singleton(
        service_name,
        lambda reg: FixedWindowRateLimiter(configure(), _store_of(reg, store)),
    )


def add_tpu_sliding_window_rate_limiter(
    registry: ServiceRegistry,
    configure: Callable[[], SlidingWindowOptions],
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    registry.add_singleton(
        service_name,
        lambda reg: SlidingWindowRateLimiter(configure(), _store_of(reg, store)),
    )


def add_tpu_partitioned_window_rate_limiter(
    registry: ServiceRegistry,
    configure: "Callable[[], SlidingWindowOptions | FixedWindowOptions]",
    *,
    store: BucketStore | None = None,
    service_name: str = RATE_LIMITER,
) -> None:
    """Keyed window façade: one window per resource (sliding by default;
    pass :class:`FixedWindowOptions` for boundary-reset semantics)."""
    from distributedratelimiting.redis_tpu_torch.models.partitioned_window import (
        PartitionedWindowRateLimiter,
    )

    registry.add_singleton(
        service_name,
        lambda reg: PartitionedWindowRateLimiter(configure(),
                                                 _store_of(reg, store)),
    )
