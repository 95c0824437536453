"""Distributed rate limiting on PyTorch and CUDA — the port of
:mod:`distributedratelimiting.redis_tpu` to an NVIDIA Hopper GPU.

The token-bucket family (``TokenBucketRateLimiter``,
``PartitionedRateLimiter``, ``ApproximateTokenBucketRateLimiter``,
``QueueingTokenBucketRateLimiter``), the window family
(``SlidingWindowRateLimiter``, ``FixedWindowRateLimiter``,
``PartitionedWindowRateLimiter``) and the ``ConcurrencyLimiter`` over a
``DeviceBucketStore`` whose per-key state, windows, semaphores and decaying
global counters live on the card and whose decisions, counter syncs,
two-level (tenant → key) admissions, tier-0 debits and TTL sweeps run as
hand-written CUDA kernels (``ops/cuda_kernels.py``, sources in ``csrc/``).
``runtime.admission.AdmissionPolicy`` is the token-denominated gateway
façade over the two-level lane, and ``ServiceRegistry`` with the
``add_tpu_*`` helpers is the DI layer. Keys resolve to slots
through the native key directory (``native/directory.cc``);
``FingerprintBucketStore`` keeps the bucket and window tiers' directory on
the card instead (64-bit key fingerprints found or claimed in the kernel);
``MeshBucketStore`` shards the bucket and window tiers by key over a mesh
of shards with a two-level global tier (``parallel/``). A
``BucketStoreServer`` serves such a store over TCP, byte-compatible with
the JAX package's server, and ``RemoteBucketStore`` is its client: limiters
on other hosts share one card through it. ``InProcessBucketStore`` is the
serial pure-Python store with the same semantics (the differential oracle
and the kernel-free serving backing), used only where a caller names it.
Module and
class names follow the JAX package so each counterpart is easy to find.
This package imports PyTorch and numpy only.
"""

__version__ = "0.1.0"

from distributedratelimiting.redis_tpu_torch.models.base import (
    MetadataName,
    RateLimiter,
    RateLimiterStatistics,
    RateLimitLease,
)
from distributedratelimiting.redis_tpu_torch.models.approximate import (
    ApproximateTokenBucketRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.concurrency import (
    ConcurrencyLease,
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
from distributedratelimiting.redis_tpu_torch.models.partitioned import (
    PartitionedRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.partitioned_window import (
    PartitionedWindowRateLimiter,
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
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    TICKS_PER_SECOND,
    ManualClock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.queueing import (
    QueueProcessingOrder,
)
from distributedratelimiting.redis_tpu_torch.runtime.remote import (
    RemoteBucketStore,
    StoreTimeoutError,
)
from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
    FingerprintBucketStore,
)
from distributedratelimiting.redis_tpu_torch.parallel.mesh_store import (
    MeshBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime.server import (
    BucketStoreServer,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    BulkAcquireResult,
    DeviceBucketStore,
    InProcessBucketStore,
    SyncResult,
)
from distributedratelimiting.redis_tpu_torch.utils.registry import (
    ServiceRegistry,
    add_tpu_approximate_token_bucket_rate_limiter,
    add_tpu_concurrency_limiter,
    add_tpu_fixed_window_rate_limiter,
    add_tpu_queueing_token_bucket_rate_limiter,
    add_tpu_sliding_window_rate_limiter,
    add_tpu_token_bucket_rate_limiter,
)

__all__ = [
    "MetadataName",
    "RateLimitLease",
    "RateLimiterStatistics",
    "RateLimiter",
    "TokenBucketOptions",
    "ApproximateTokenBucketOptions",
    "QueueingTokenBucketOptions",
    "SlidingWindowOptions",
    "FixedWindowOptions",
    "ConcurrencyLimiterOptions",
    "TokenBucketRateLimiter",
    "ApproximateTokenBucketRateLimiter",
    "QueueingTokenBucketRateLimiter",
    "SlidingWindowRateLimiter",
    "FixedWindowRateLimiter",
    "ConcurrencyLimiter",
    "ConcurrencyLease",
    "PartitionedRateLimiter",
    "PartitionedWindowRateLimiter",
    "AcquireResult",
    "BulkAcquireResult",
    "SyncResult",
    "BucketStore",
    "BucketStoreServer",
    "DeviceBucketStore",
    "FingerprintBucketStore",
    "InProcessBucketStore",
    "MeshBucketStore",
    "RemoteBucketStore",
    "StoreTimeoutError",
    "ManualClock",
    "MonotonicClock",
    "TICKS_PER_SECOND",
    "QueueProcessingOrder",
    "ServiceRegistry",
    "add_tpu_token_bucket_rate_limiter",
    "add_tpu_approximate_token_bucket_rate_limiter",
    "add_tpu_queueing_token_bucket_rate_limiter",
    "add_tpu_sliding_window_rate_limiter",
    "add_tpu_fixed_window_rate_limiter",
    "add_tpu_concurrency_limiter",
    "__version__",
]
