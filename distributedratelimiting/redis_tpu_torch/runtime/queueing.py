"""Waiter-queue vocabulary. Only :class:`QueueProcessingOrder` is ported so
far (the options layer names it); the waiter queue itself comes with the
queueing limiter families."""

from __future__ import annotations

import enum

__all__ = ["QueueProcessingOrder"]


class QueueProcessingOrder(enum.Enum):
    """≙ ``System.Threading.RateLimiting.QueueProcessingOrder``."""

    OLDEST_FIRST = "oldest_first"
    NEWEST_FIRST = "newest_first"
