"""Waiter-queue machinery for async acquires that can't be served instantly.

Semantics cloned (behavior, not code) from the reference's queue logic —
itself a faithful clone of .NET's in-memory ``TokenBucketRateLimiter``
(SURVEY.md §2 #5, ``RedisApproximateTokenBucketRateLimiter.cs:139-183,
462-501,515-557``):

- ``queue_limit`` is counted in **cumulative permits**, not waiter count
  (``:178``).
- ``OLDEST_FIRST``: a newcomer that would overflow the queue is rejected
  (``:159-163``). ``NEWEST_FIRST``: oldest entries are evicted (failed) to
  make room for the newcomer (``:143-158``).
- Waiters park on futures (≙ ``TaskCompletionSource``, ``:515-529``).
- Cancellation unwinds the queue accounting (``CancelQueueState``,
  ``:531-557``). The reference's drain loop *double-counts* consumption for
  waiters found cancelled after speculative grant (``:486-492`` — known
  defect, SURVEY.md §2); here cancelled waiters are detected before any
  consumption is applied, so the accounting bug cannot occur by
  construction (regression-tested).
- Disposal fails all queued waiters; they never hang (``:291-298``).
"""

from __future__ import annotations

import asyncio
import enum
from typing import Callable, Iterable

from distributedratelimiting.redis_tpu_torch.utils.deque import Deque

__all__ = ["QueueProcessingOrder", "Registration", "WaiterQueue"]


class QueueProcessingOrder(enum.Enum):
    """≙ ``System.Threading.RateLimiting.QueueProcessingOrder``."""

    OLDEST_FIRST = "oldest_first"
    NEWEST_FIRST = "newest_first"


class Registration:
    """One parked waiter (≙ ``RequestRegistration`` struct ``:515-529``)."""

    __slots__ = ("count", "future")

    def __init__(self, count: int, future: asyncio.Future) -> None:
        self.count = count
        self.future = future


class WaiterQueue:
    """Permit-counted waiter queue. Single-threaded (event loop) use."""

    def __init__(self, queue_limit: int,
                 order: QueueProcessingOrder = QueueProcessingOrder.OLDEST_FIRST
                 ) -> None:
        if queue_limit < 0:
            raise ValueError("queue_limit must be >= 0")
        self.queue_limit = queue_limit
        self.order = order
        self._deque: Deque[Registration] = Deque()
        self._queue_count = 0  # cumulative permits queued
        # Set by fail_all: once the queue has been failed (disposal), a
        # drain_async waiter returning from its in-flight round-trip must
        # be settled with this factory, never re-parked.
        self._fail_factory: Callable[[], object] | None = None

    def __len__(self) -> int:
        return len(self._deque)

    @property
    def queue_count(self) -> int:
        return self._queue_count

    def try_enqueue(self, count: int
                    ) -> tuple[asyncio.Future | None, list[Registration]]:
        """Park a waiter for ``count`` permits.

        Returns ``(future, evicted)``. ``future is None`` ⇒ the request was
        rejected (queue full under OLDEST_FIRST, or ``count`` alone exceeds
        the whole queue_limit). ``evicted`` holds NEWEST_FIRST victims the
        caller must complete with failed leases.
        """
        evicted: list[Registration] = []
        if count > self.queue_limit:
            return None, evicted
        if self._queue_count + count > self.queue_limit:
            if self.order is QueueProcessingOrder.OLDEST_FIRST:
                return None, evicted  # reject the newcomer (:159-163)
            # NEWEST_FIRST: evict oldest entries until the newcomer fits
            # (:143-158).
            while self._deque.count and self._queue_count + count > self.queue_limit:
                victim = self._deque.dequeue_head()
                self._queue_count -= victim.count
                if not victim.future.done():
                    evicted.append(victim)
        loop = asyncio.get_running_loop()
        reg = Registration(count, loop.create_future())
        self._deque.enqueue_tail(reg)
        self._queue_count += count
        # Cancellation unwinds accounting immediately (corrected semantics:
        # detect-before-consume, so no double count is possible).
        reg.future.add_done_callback(
            lambda fut, reg=reg: self._on_done(reg, fut)
        )
        return reg.future, evicted

    def _on_done(self, reg: Registration, fut: asyncio.Future) -> None:
        if fut.cancelled():
            if self._deque.remove(reg):
                self._queue_count -= reg.count

    def drain(self, try_grant: Callable[[int], bool],
              make_lease: Callable[[], object]) -> int:
        """Release waiters while permits are available (the refresh drain
        loop, ``:462-501``). ``try_grant(count)`` must atomically consume
        ``count`` permits or decline; granted waiters get
        ``make_lease()``.

        Returns the number of waiters granted. Cancelled waiters are
        discarded *before* any grant is attempted — the accounting defect
        in the reference cannot arise.
        """
        granted = 0
        while self._deque.count:
            newest = self.order is QueueProcessingOrder.NEWEST_FIRST
            reg = self._deque.peek_tail() if newest else self._deque.peek_head()
            if reg.future.done():  # cancelled while parked
                (self._deque.dequeue_tail if newest else self._deque.dequeue_head)()
                self._queue_count -= reg.count
                continue
            if not try_grant(reg.count):
                break
            (self._deque.dequeue_tail if newest else self._deque.dequeue_head)()
            self._queue_count -= reg.count
            reg.future.set_result(make_lease())
            granted += 1
        return granted

    async def drain_async(self, try_grant, make_lease: Callable[[], object]
                          ) -> int:
        """Async drain for limiters whose grants are store round-trips (the
        queueing+exact hybrid, the intent of the reference's dead
        ``TokenBucketWithQueue/RedisTokenBucketRateLimiter.cs``):
        ``await try_grant(count)`` consumes from the shared store or
        declines. Cancelled waiters are discarded before any store traffic.

        The waiter under grant is **dequeued before the await** (and
        re-queued at the same end on decline), so nothing else — NEWEST_FIRST
        eviction, cancellation callbacks, a concurrent ``fail_all`` — can
        settle it while its store round-trip is in flight; ``_queue_count``
        still includes it, so queue-limit accounting is unchanged. The one
        unavoidable hazard: a waiter cancelled in the window between the
        store grant and completion has its cost consumed (token-bucket cost
        is not returnable); the drain proceeds normally."""
        granted = 0
        while self._deque.count:
            newest = self.order is QueueProcessingOrder.NEWEST_FIRST
            reg = self._deque.peek_tail() if newest else self._deque.peek_head()
            if reg.future.done():  # cancelled while parked
                (self._deque.dequeue_tail if newest else self._deque.dequeue_head)()
                self._queue_count -= reg.count
                continue
            # Take ownership for the duration of the store round-trip.
            (self._deque.dequeue_tail if newest else self._deque.dequeue_head)()
            try:
                ok = await try_grant(reg.count)
            except BaseException:
                # Drain task cancelled (disposal) or grant raised: hand the
                # waiter back so dispose's fail_all can settle it — a
                # checked-out registration must never be stranded unsettled.
                # If fail_all already ran, settle directly instead.
                if self._fail_factory is not None:
                    self._queue_count -= reg.count
                    if not reg.future.done():
                        reg.future.set_result(self._fail_factory())
                else:
                    (self._deque.enqueue_tail if newest
                     else self._deque.enqueue_head)(reg)
                raise
            if reg.future.done():  # cancelled mid-flight (callback saw it
                self._queue_count -= reg.count  # gone; unwind here instead)
                if ok:
                    continue  # grant consumed with no lease — documented loss
                break
            if self._fail_factory is not None:
                # fail_all ran while the round-trip was in flight; it
                # couldn't see this checked-out waiter, so settle it here —
                # re-parking would strand it in a disposed queue forever.
                self._queue_count -= reg.count
                reg.future.set_result(
                    make_lease() if ok else self._fail_factory())
                if ok:
                    granted += 1
                break
            if ok:
                self._queue_count -= reg.count
                reg.future.set_result(make_lease())
                granted += 1
            else:
                # Put it back where it came from; it keeps its turn.
                (self._deque.enqueue_tail if newest
                 else self._deque.enqueue_head)(reg)
                break
        return granted

    def peek_next(self) -> Registration | None:
        """Order-aware live head: discards cancelled entries (unwinding
        their permit accounting) and returns the next waiter WITHOUT
        removing it, or ``None``. For drains whose grant is an await and
        whose cost is returnable (the concurrency limiter): the caller
        acquires for the peeked waiter, then re-peeks to confirm it is
        still next before popping — if not (cancelled mid-flight), the
        caller returns the permits instead of stranding them."""
        while self._deque.count:
            newest = self.order is QueueProcessingOrder.NEWEST_FIRST
            reg = self._deque.peek_tail() if newest else self._deque.peek_head()
            if reg.future.done():
                (self._deque.dequeue_tail if newest
                 else self._deque.dequeue_head)()
                self._queue_count -= reg.count
                continue
            return reg
        return None

    def pop_next(self) -> Registration | None:
        """Remove and return the next live waiter (see :meth:`peek_next`),
        unwinding its permit accounting."""
        reg = self.peek_next()
        if reg is not None:
            newest = self.order is QueueProcessingOrder.NEWEST_FIRST
            (self._deque.dequeue_tail if newest
             else self._deque.dequeue_head)()
            self._queue_count -= reg.count
        return reg

    def fail_all(self, make_lease: Callable[[], object]) -> int:
        """Disposal path: every parked waiter completes with a failed lease
        (``:291-298``), drained in queue-processing order. Also marks the
        queue failed so a waiter checked out by an in-flight
        :meth:`drain_async` settles on return instead of re-parking."""
        self._fail_factory = make_lease
        failed = 0
        while self._deque.count:
            newest = self.order is QueueProcessingOrder.NEWEST_FIRST
            reg = (self._deque.dequeue_tail if newest else self._deque.dequeue_head)()
            self._queue_count -= reg.count
            if not reg.future.done():
                reg.future.set_result(make_lease())
                failed += 1
        return failed

    def __iter__(self) -> Iterable[Registration]:
        return iter(self._deque)
