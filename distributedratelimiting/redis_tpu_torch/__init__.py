"""Distributed rate limiting on PyTorch and CUDA — the port of
:mod:`distributedratelimiting.redis_tpu` to an NVIDIA Hopper GPU.

The exact token-bucket serving path: limiters (``TokenBucketRateLimiter``,
``PartitionedRateLimiter``) over a ``DeviceBucketStore`` whose per-key state
lives on the card and whose decisions and TTL sweeps run as hand-written
CUDA kernels (``ops/cuda_kernels.py``, sources in ``csrc/``). Module and
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
from distributedratelimiting.redis_tpu_torch.models.options import (
    TokenBucketOptions,
)
from distributedratelimiting.redis_tpu_torch.models.partitioned import (
    PartitionedRateLimiter,
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
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    BulkAcquireResult,
    DeviceBucketStore,
)
