"""Asyncio micro-batcher: amortizes kernel-launch cost over concurrent calls.

The reference pays one network round-trip per ``WaitAsync``
(``RedisTokenBucketRateLimiter.cs:63``) and its README names request
batching as the missing piece (``README.md:7``). Here batching is the core
of the design (SURVEY.md §7 L2): concurrent ``acquire`` calls are collected
into a flush — closed when it reaches ``max_batch`` or when the oldest
entry has waited ``max_delay_s`` — and one kernel launch decides the whole
batch. Device transfer/blocking happens on an executor thread so the event
loop keeps accumulating the next flush while the previous one is in flight;
``max_inflight`` bounds the pipeline depth. Result readbacks of distinct
flushes may overlap without affecting per-batch semantics: kernels
themselves still execute serially in submission order on one device stream.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable, Generic, Sequence, TypeVar

from distributedratelimiting.redis_tpu_torch.utils import tracing

TReq = TypeVar("TReq")
TRes = TypeVar("TRes")

#: The process-global tracer, bound once: configure() mutates the same
#: instance, and the submit hot path pays one attribute read, not a
#: function call, to learn tracing is off.
_TRACER = tracing.get_tracer()

__all__ = ["MicroBatcher"]


class MicroBatcher(Generic[TReq, TRes]):
    def __init__(
        self,
        flush_fn: Callable[[Sequence[TReq]], Awaitable[Sequence[TRes]]],
        *,
        max_batch: int = 4096,
        max_delay_s: float = 200e-6,
        max_inflight: int = 8,
        flush_latency=None,
        queue_latency=None,
    ) -> None:
        if max_batch <= 0:
            raise ValueError("max_batch must be positive")
        self._flush_fn = flush_fn
        self._max_batch = max_batch
        self._max_delay_s = max_delay_s
        # Optional LatencyHistogram: wall time of each flush_fn await
        # (dispatch + kernel + readback) — the device-side share of the
        # serving-latency decomposition.
        self._flush_latency = flush_latency
        # Optional LatencyHistogram: enqueue → flush dispatch, recorded
        # once per flush for the OLDEST member (the conservative envelope
        # of queue wait — per-member records would cost a hist insert per
        # request on the hot path; the oldest member's wait bounds them
        # all and is what drives the p99).
        self._queue_latency = queue_latency
        # (request, future, enqueue_stamp, trace_ctx). The trace ctx is
        # None on every untraced request — captured only because the
        # flush runs in its own task, where the submitter's context
        # variable does not follow.
        self._pending: list[tuple[TReq, asyncio.Future, float,
                                  "tracing.TraceContext | None"]] = []
        self._timer: asyncio.TimerHandle | None = None
        self._inflight = asyncio.Semaphore(max_inflight)
        self._tasks: set[asyncio.Task] = set()  # strong refs to in-flight flushes
        self._closed = False

    @property
    def pending_count(self) -> int:
        return len(self._pending)

    async def submit(self, request: TReq) -> TRes:
        """Enqueue one request; resolves with its per-request result."""
        if self._closed:
            raise RuntimeError("batcher is closed")
        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        # The enqueue stamp is one perf_counter read (~60ns) on a path
        # already paying a future + list append; it is what makes the
        # queue stage a measured histogram instead of an inference. The
        # ambient-trace capture costs one contextvar read and is None on
        # the untraced path.
        self._pending.append((request, fut, time.perf_counter(),
                              tracing.current_context()
                              if _TRACER.enabled else None))
        if len(self._pending) >= self._max_batch:
            self._start_flush(loop)
        elif self._timer is None:
            # Flush-on-idle: with no flush in flight there is nothing to
            # overlap the wait with — delay only adds latency (and the
            # loop's timer granularity inflates a µs deadline to ~1ms).
            # call_later(0) still runs after this loop pass, so every
            # same-pass submitter joins the batch. The deadline proper
            # applies only while the pipeline is busy, where in-flight
            # flushes provide the batching back-pressure it exists for.
            delay = 0.0 if not self._tasks else self._max_delay_s
            self._timer = loop.call_later(delay, self._start_flush, loop)
        return await fut

    def _start_flush(self, loop: asyncio.AbstractEventLoop) -> None:
        # Loop-thread-only by design: reached from submit() (a coroutine
        # on `loop`) or from the call_later timer it arms (loop thread by
        # definition) — never from a foreign thread.
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        if not self._pending:
            return
        batch = self._pending[: self._max_batch]
        del self._pending[: len(batch)]
        # drl-check: ok(task-off-loop) loop-thread-only (see above)
        task = loop.create_task(self._run_flush(batch))
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        # Anything past max_batch re-arms the deadline.
        if self._pending and self._timer is None:
            # drl-check: ok(task-off-loop) loop-thread-only (see above)
            self._timer = loop.call_later(
                self._max_delay_s, self._start_flush, loop
            )

    async def _run_flush(self,
                         batch: list[tuple[TReq, asyncio.Future, float,
                                           "tracing.TraceContext | None"]]
                         ) -> None:
        async with self._inflight:
            requests = [r for r, _, _, _ in batch]
            t0 = time.perf_counter()
            if self._queue_latency is not None:
                # batch[0] is the oldest submitter: its wait envelopes
                # every other member's (arrival order is append order).
                self._queue_latency.record(t0 - batch[0][2])
            # The flush is SHARED: one span, parented on the first traced
            # member (the elected trace); every other traced member's
            # queue span carries flush_span_id so its trace still names
            # the flush it rode. Queue spans are recorded at flush time
            # (enqueue stamp -> dispatch) — no per-request cost beyond
            # the ctx capture in submit().
            elected, elected_enq = next(
                ((c, t) for _, _, t, c in batch if c is not None),
                (None, t0))
            tracer = _TRACER
            fspan = (tracer.start_span("batch.flush", parent=elected,
                                       attrs={"n": len(batch)})
                     if elected is not None else tracing._NULL_SPAN)
            if elected is not None:
                fid = (f"{fspan.context.span_id:016x}"
                       if fspan.context is not None else None)
                for _, _, t_enq, ctx in batch:
                    if ctx is not None:
                        tracer.record_span(
                            "batch.queue", ctx, t_enq, t0,
                            attrs=None if fid is None
                            else {"flush_span_id": fid})
                if self._queue_latency is not None:
                    # The exemplar pairs the elected member's OWN wait
                    # with its trace id — the sample above (oldest
                    # member's envelope) may belong to a different,
                    # untraced request.
                    self._queue_latency.exemplar(t0 - elected_enq,
                                                 elected.trace_id)
            trace_id = None if elected is None else elected.trace_id
            try:
                with fspan:
                    results = await self._flush_fn(requests)
            except BaseException as exc:  # noqa: BLE001 — fan the failure out
                for _, fut, _, _ in batch:
                    if not fut.done():
                        fut.set_exception(exc)
                return
            dt = time.perf_counter() - t0
            if self._flush_latency is not None:
                self._flush_latency.record(dt, trace_id=trace_id)
            for (_, fut, _, _), res in zip(batch, results):
                if not fut.done():  # caller may have cancelled while queued
                    fut.set_result(res)

    async def flush_now(self) -> None:
        """Force-flush pending requests and wait for every in-flight flush
        to complete — a shutdown drain must not strand submitters on
        futures whose flush task dies with the loop."""
        loop = asyncio.get_running_loop()
        while self._pending:
            self._start_flush(loop)
            await asyncio.sleep(0)
        while self._tasks:
            tasks = list(self._tasks)
            await asyncio.gather(*tasks, return_exceptions=True)
            # Remove the awaited tasks ourselves: their done-callback
            # discards are only QUEUED on the loop, and awaiting a gather
            # whose children are all already finished does not yield — so
            # `while self._tasks` alone livelocks (measured: a tight
            # never-suspending spin) when aclose runs before the callbacks
            # get a loop pass.
            self._tasks.difference_update(tasks)

    async def aclose(self) -> None:
        self._closed = True
        await self.flush_now()
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
