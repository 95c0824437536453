"""Distributed rate limiting on PyTorch and CUDA — the port of
:mod:`distributedratelimiting.redis_tpu` to an NVIDIA Hopper GPU.

The token-bucket family (``TokenBucketRateLimiter``,
``PartitionedRateLimiter``, ``ApproximateTokenBucketRateLimiter``,
``QueueingTokenBucketRateLimiter``) and the window family
(``SlidingWindowRateLimiter``, ``FixedWindowRateLimiter``,
``PartitionedWindowRateLimiter``) over a ``DeviceBucketStore`` whose
per-key state, windows and decaying global counters live on the card and
whose decisions, counter syncs and TTL sweeps run as hand-written CUDA
kernels (``ops/cuda_kernels.py``, sources in ``csrc/``). Keys resolve to slots
through the native key directory (``native/directory.cc``). A
``BucketStoreServer`` serves such a store over TCP, byte-compatible with
the JAX package's server, and ``RemoteBucketStore`` is its client: limiters
on other hosts share one card through it. Module and
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
from distributedratelimiting.redis_tpu_torch.models.fixed_window import (
    FixedWindowRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.models.options import (
    ApproximateTokenBucketOptions,
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
from distributedratelimiting.redis_tpu_torch.runtime.server import (
    BucketStoreServer,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    BulkAcquireResult,
    DeviceBucketStore,
    SyncResult,
)
