"""Remote store client — the framework's ``ConnectionMultiplexer``.

The core of the JAX package's ``runtime/remote.py``:
:class:`RemoteBucketStore` lets limiter instances on any host share one
:class:`~.server.BucketStoreServer` (of either package — the wire is the
same) the way the reference's limiters share one Redis:

- **Config precedence** ``connection_factory > address > url``; the
  factory seam is also the tests' injection point.
- **Lazy, double-checked connect**; a failed dial is logged and arms a
  jittered exponential reconnect backoff, and the next use redials.
- **Multiplexed pipelining**: one TCP connection carries any number of
  in-flight requests tagged with sequence ids; a background reader
  resolves them in completion order.
- **At-most-once retries**: a failure before a frame could have been sent
  (the connect phase) retries any op; after that only the ops in
  :data:`_IDEMPOTENT_OPS` retry. Timeouts (:class:`StoreTimeoutError`) and
  server-answered errors never retry.
- **Client-side frame coalescing** (``coalesce_requests``, default on):
  concurrent single-key acquires against one bucket config share
  ``ACQUIRE_MANY`` frames (a MicroBatcher on the I/O loop), so a server is
  loaded by its clients' flush rate, not their request rate. Decisions then
  take bulk semantics: same-key requests in one flush serialize
  conservatively (an earlier request's demand reserves ahead of later ones
  even when it is denied). ``coalesce_requests=False`` sends one
  ``OP_ACQUIRE`` frame per request.
- **Time stays with the store.** The wire carries no client timestamps;
  all refill arithmetic runs against the server's clock.

All socket I/O runs on a dedicated background event loop thread, so one
client serves both ``async`` callers (from any event loop) and blocking
callers (from any thread).

Not ported yet: the live-config chase ("config moved" errors surface as
:class:`wire.RemoteStoreError`), and the window, semaphore, hierarchical,
reservation, federation, placement, config, metrics, traces and audit
methods, which raise ``NotImplementedError`` as the port's ``BucketStore``
does.
"""

from __future__ import annotations

import asyncio
import random
import threading
from typing import Awaitable, Callable, Sequence

import numpy as np

from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    Clock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    BulkAcquireResult,
    SyncResult,
    _not_ported,
)
from distributedratelimiting.redis_tpu_torch.utils import log, tracing
from distributedratelimiting.redis_tpu_torch.utils.resilience import (
    RetryPolicy,
)
from distributedratelimiting.redis_tpu_torch.utils.tracing import (
    Profiler,
    ProfilingSession,
)

__all__ = ["RemoteBucketStore", "StoreTimeoutError"]

ConnectionFactory = Callable[
    [], Awaitable[tuple[asyncio.StreamReader, asyncio.StreamWriter]]
]


class StoreTimeoutError(asyncio.TimeoutError):
    """The store did not answer within the request timeout.

    Typed so callers can tell "the STORE went quiet" apart from their own
    ``asyncio.wait_for`` deadlines (it still subclasses
    :class:`asyncio.TimeoutError`). Never retried by the client: the frame
    was sent, and whether it was executed is unknowable — the at-most-once
    contract forbids replaying it."""


#: Ops safe to retry even after their frame may have reached the wire:
#: executing them twice changes no admission state. Everything else
#: retries only on provably-never-sent failures (the connect phase). The
#: classification covers every ``wire.OP_*``, as the JAX client's does.
_IDEMPOTENT_OPS = frozenset((
    wire.OP_PEEK, wire.OP_PING, wire.OP_METRICS, wire.OP_PLACEMENT,
    wire.OP_PLACEMENT_ANNOUNCE, wire.OP_MIGRATE_PULL,
    wire.OP_MIGRATE_PUSH, wire.OP_CONFIG, wire.OP_RESERVE, wire.OP_SETTLE,
    wire.OP_FED_LEASE, wire.OP_FED_RENEW, wire.OP_FED_RECLAIM,
    wire.OP_AUDIT))

#: The NOT-idempotent half: admission ops double-debit on replay; HELLO
#: re-auth mid-stream is a protocol error; STATS/TRACES flags mutate
#: measurement windows; SAVE re-queues a device pull; ACQUIRE_MANY is the
#: bulk admission lane (its retry surface is connect-phase only).
_NON_IDEMPOTENT_OPS = frozenset((
    wire.OP_ACQUIRE, wire.OP_WINDOW, wire.OP_FWINDOW, wire.OP_SEMA,
    wire.OP_SYNC, wire.OP_HELLO, wire.OP_SAVE, wire.OP_STATS,
    wire.OP_TRACES, wire.OP_ACQUIRE_MANY, wire.OP_ACQUIRE_H))


class RemoteBucketStore(BucketStore):
    """Client for a :class:`BucketStoreServer`.

    Exactly one of ``connection_factory``, ``address``, or ``url`` must be
    given (the highest-precedence one wins if several are)::

        store = RemoteBucketStore(address=("gpu-host", 6380))
        store = RemoteBucketStore(url="gpu-host:6380")
        store = RemoteBucketStore(connection_factory=my_open_fn)  # tests
    """

    def __init__(
        self,
        *,
        connection_factory: ConnectionFactory | None = None,
        address: tuple[str, int] | None = None,
        url: str | None = None,
        request_timeout_s: float = 30.0,
        clock: Clock | None = None,
        profiling_session: Callable[[], ProfilingSession | None] | None = None,
        auth_token: str | None = None,
        coalesce_requests: bool = True,
        coalesce_max_batch: int = 512,
        coalesce_max_delay_s: float = 200e-6,
        retry_policy: "RetryPolicy | None" = RetryPolicy(),
        reconnect_backoff_base_s: float = 0.05,
        reconnect_backoff_max_s: float = 5.0,
        propagate_deadlines: bool = False,
        resilience_seed: int | None = None,
    ) -> None:
        if connection_factory is None and address is None and url is None:
            raise ValueError(
                "one of connection_factory, address, or url is required"
            )
        self._factory = connection_factory
        if address is None and url is not None:
            host, _, port = url.rpartition(":")
            address = (host or "127.0.0.1", int(port))
        self._address = address
        self._request_timeout_s = request_timeout_s
        # Shared secret presented in a HELLO as the first frame after
        # connect (≙ the AUTH in a Redis Configuration string).
        self._auth_token = auth_token
        # The client clock only satisfies the BucketStore interface; the
        # SERVER is the time authority.
        self.clock = clock or MonotonicClock()
        # Each profiled command is one wire round trip to the server.
        self.profiler = Profiler(profiling_session)
        # When the process-global tracer samples a request, the client
        # span's context rides the frame as the trace tail. Latched off
        # for the connection the first time an old server answers a
        # stamped frame with its routable "unknown op" error.
        self._peer_traces = True

        # Bounded, jittered retries (at-most-once for admission; see the
        # module doc). retry_policy=None disables them.
        self._retry_policy = retry_policy
        # Reconnect backoff: after a failed dial, further dials fail fast
        # until the (jittered, exponentially growing) window passes — a
        # dead server costs each client one dial per window, not one per
        # request.
        self._backoff_base_s = reconnect_backoff_base_s
        self._backoff_max_s = reconnect_backoff_max_s
        self._backoff_until = 0.0          # I/O-loop time()
        self._connect_failures = 0
        # Deadline propagation: stamp every scalar request with this call's
        # remaining budget so a backlogged server sheds expired work.
        # Latched off per connection on the first "unknown op" answer from
        # a pre-deadline peer.
        self._propagate_deadlines = propagate_deadlines
        self._peer_deadlines = True
        # Attempt propagation: re-sends carry a saturating attempt counter.
        # Same old-peer posture as the deadline tail, latched on its own.
        self._peer_attempts = True
        # Seedable rng (jitter): deterministic under test.
        self._rng = random.Random(resilience_seed)
        self._retries = 0
        self._timeouts = 0

        self._coalesce = coalesce_requests
        self._coalesce_max_batch = coalesce_max_batch
        self._coalesce_max_delay_s = coalesce_max_delay_s
        self._acquire_batchers: dict = {}  # (cap, rate) → MicroBatcher

        self._io_loop: asyncio.AbstractEventLoop | None = None
        self._io_thread: threading.Thread | None = None
        self._thread_gate = threading.Lock()

        # Connection state — touched only from the I/O loop.
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._reader_task: asyncio.Task | None = None
        self._connect_gate: asyncio.Lock | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._seq = 0
        self._closed = False

    # -- background I/O loop ------------------------------------------------
    def _ensure_loop_locked(self) -> asyncio.AbstractEventLoop:
        # _thread_gate held by the caller.
        if self._closed:
            # Post-close use must fail fast, not resurrect a loop thread
            # that nothing would ever stop.
            raise ConnectionError("store client is closed")
        if self._io_loop is None:
            loop = asyncio.new_event_loop()
            ready = threading.Event()

            def run() -> None:
                asyncio.set_event_loop(loop)
                self._connect_gate = asyncio.Lock()
                ready.set()
                loop.run_forever()
                # aclose stopped the loop with _closed latched. A task
                # still here (suspended in a retry backoff, or enqueued
                # behind the stop) would leave its caller waiting forever
                # on a future nothing resolves: cancel what remains and
                # let the cancellations deliver.
                for _ in range(8):
                    loop.run_until_complete(asyncio.sleep(0))
                    leftovers = asyncio.all_tasks(loop)
                    if not leftovers:
                        break
                    for task in leftovers:
                        task.cancel()
                    loop.run_until_complete(asyncio.gather(
                        *leftovers, return_exceptions=True))

            t = threading.Thread(
                target=run, name="remote-bucket-store-io", daemon=True
            )
            t.start()
            ready.wait()
            self._io_loop = loop
            self._io_thread = t
        return self._io_loop

    def _submit(self, coro) -> "asyncio.Future":
        # Under the gate aclose takes to latch _closed: a submission either
        # sees _closed (fast-fail) or lands in the loop's queue BEFORE
        # aclose's shutdown and stop callbacks — never behind the stop.
        with self._thread_gate:
            try:
                loop = self._ensure_loop_locked()
            except Exception:
                coro.close()  # never awaited otherwise (post-close
                raise         # fast-fail)
            return asyncio.run_coroutine_threadsafe(coro, loop)

    async def _await_on_io(self, coro):
        fut = self._submit(coro)
        try:
            return await asyncio.wrap_future(fut)
        except asyncio.CancelledError:
            # The I/O loop's shutdown drain cancels work it abandoned:
            # surface that as the typed post-close error, not a bare
            # cancellation. A caller-driven cancel re-raises untouched.
            if self._closed and fut.cancelled():
                raise ConnectionError(
                    "store client is closed") from None
            raise

    # -- connection lifecycle (on the I/O loop) -----------------------------
    async def connect(self) -> None:
        """Idempotent lazy connect; public so callers can front-load the
        dial, but every request path calls it anyway."""
        await self._await_on_io(self._connect_io())

    def _dial_failed(self, exc: Exception) -> None:
        """Bookkeeping for a failed dial/handshake: log it and arm the
        jittered exponential reconnect-backoff window."""
        self._connect_failures += 1
        delay = min(self._backoff_max_s,
                    self._backoff_base_s
                    * 2.0 ** (self._connect_failures - 1))
        delay *= 0.5 + 0.5 * self._rng.random()  # jitter: [½, 1]×
        assert self._io_loop is not None
        self._backoff_until = self._io_loop.time() + delay
        log.could_not_connect_to_store(exc)

    async def _connect_io(self) -> None:
        if self._writer is not None:
            return
        assert self._connect_gate is not None
        async with self._connect_gate:  # double-checked
            if self._writer is not None or self._closed:
                return
            now = asyncio.get_running_loop().time()
            if now < self._backoff_until:
                # Fail fast inside the backoff window instead of hammering
                # a dead peer.
                raise ConnectionError(
                    f"reconnect backing off for another "
                    f"{self._backoff_until - now:.2f}s "
                    f"({self._connect_failures} failed dials)")
            try:
                if self._factory is not None:
                    reader, writer = await self._factory()
                else:
                    assert self._address is not None
                    reader, writer = await asyncio.open_connection(
                        self._address[0], self._address[1]
                    )
            except Exception as exc:
                self._dial_failed(exc)
                raise
            reader_task = asyncio.ensure_future(self._read_loop(reader))
            if self._auth_token is not None:
                # HELLO completes before the connection is published — no
                # other request can slip ahead of the auth handshake
                # (requests gate on self._writer, still None here).
                self._seq = (self._seq + 1) & 0xFFFFFFFF
                seq = self._seq
                fut: asyncio.Future = asyncio.get_running_loop().create_future()
                self._pending[seq] = fut
                try:
                    wire.write_frame(writer, wire.encode_request(
                        seq, wire.OP_HELLO, self._auth_token))
                    await writer.drain()
                    await asyncio.wait_for(fut, self._request_timeout_s)
                except Exception as exc:
                    self._pending.pop(seq, None)
                    reader_task.cancel()
                    writer.close()
                    self._dial_failed(exc)
                    raise
            self._connect_failures = 0
            self._backoff_until = 0.0
            self._reader, self._writer = reader, writer
            self._reader_task = reader_task

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        # A protocol-level failure (e.g. version mismatch) is a better
        # reason to hand in-flight futures than a generic lost connection.
        reason: Exception = ConnectionError("connection to store lost")
        try:
            while True:
                body = await wire.read_frame(reader)
                if body is None:
                    break
                seq, kind, vals = wire.decode_response(body)
                fut = self._pending.pop(seq, None)
                if fut is None or fut.done():
                    continue
                if kind == wire.RESP_ERROR:
                    fut.set_exception(wire.RemoteStoreError(vals[0]))
                else:
                    fut.set_result(vals)
        except Exception as exc:
            log.error_evaluating_kernel(exc)
            if isinstance(exc, wire.RemoteStoreError):
                reason = exc
        finally:
            self._drop_connection(reason)

    def _drop_connection(self, exc: Exception) -> None:
        """Fail all in-flight requests; the next use reconnects."""
        if self._writer is not None:
            self._writer.close()
        reader_task = self._reader_task
        if (reader_task is not None
                and reader_task is not asyncio.current_task()):
            reader_task.cancel()
        self._reader = self._writer = None
        self._reader_task = None
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(exc)

    # -- request path (on the I/O loop) -------------------------------------
    async def _request_io(self, op: int, key: str, count: int,
                          a: float, b: float,
                          parent: "tracing.TraceContext | None" = None,
                          timeout_s: "float | None" = None) -> tuple:
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            with self.profiler.span(wire.op_name(op), 1):
                return await self._request_io_unprofiled(
                    op, key, count, a, b, timeout_s=timeout_s)
        # The trace starts here (the client wire layer): `parent` is the
        # caller-side ambient context, captured before hopping onto the
        # I/O loop where contextvars do not follow.
        span = tracer.start_span(f"client.{wire.op_name(op)}",
                                 parent=parent)
        with span, self.profiler.span(wire.op_name(op), 1):
            trace = span.context if self._peer_traces else None
            try:
                vals = await self._request_io_unprofiled(
                    op, key, count, a, b, trace, timeout_s=timeout_s)
            except wire.RemoteStoreError as exc:
                if trace is not None and "unknown op" in str(exc):
                    # Old peer: it routed an error but does not speak the
                    # trace tail. Latch stamping off and retry bare — once
                    # per connection lifetime, not per request.
                    self._peer_traces = False
                    span.set_attr("trace_tail", "unsupported_peer")
                    try:
                        vals = await self._request_io_unprofiled(
                            op, key, count, a, b, None,
                            timeout_s=timeout_s)
                    except wire.RemoteStoreError as exc2:
                        if "unknown op" in str(exc2):
                            # The bare re-send was rejected too: the base
                            # op is what the peer does not speak — undo
                            # the latch before surfacing.
                            self._peer_traces = True
                        raise
                else:
                    raise
            if vals and vals[0] is False:
                span.set_status("denied")
            return vals

    async def _request_io_unprofiled(self, op: int, key: str, count: int,
                                     a: float, b: float,
                                     trace=None, *,
                                     timeout_s: "float | None" = None
                                     ) -> tuple:
        """Send one request with the at-most-once retry contract: a
        failure in the CONNECT phase provably never sent this request's
        frame, so any op may retry it; once :meth:`_send_once` is entered
        the frame may have reached the server, and only
        :data:`_IDEMPOTENT_OPS` may retry. Timeouts and server-answered
        errors never retry."""
        timeout = (self._request_timeout_s if timeout_s is None
                   else timeout_s)
        policy = self._retry_policy
        attempt = 0
        latched_here = False
        attempt_latched_here = False
        while True:
            sent = False
            ddl = (timeout if (self._propagate_deadlines
                               and self._peer_deadlines) else None)
            # Attempt tail: stamped only on re-sends, so first attempts
            # stay byte-identical to pre-attempt frames.
            atl = attempt if (attempt and self._peer_attempts) else 0
            try:
                await self._connect_io()
                sent = True  # past here the frame may be on the wire
                return await self._send_once(op, key, count, a, b,
                                             trace, ddl, timeout,
                                             attempt=atl)
            except wire.RemoteStoreError as exc:
                if atl and "unknown op" in str(exc):
                    # Pre-attempt peer: it routed an error without
                    # executing, so re-sending is NOT a replay. The
                    # attempt tail sheds first, on its own latch.
                    self._peer_attempts = False
                    attempt_latched_here = True
                    continue
                if ddl is not None and "unknown op" in str(exc):
                    # Pre-deadline peer: same posture.
                    self._peer_deadlines = False
                    latched_here = True
                    continue
                if ((latched_here or attempt_latched_here)
                        and "unknown op" in str(exc)):
                    # The bare re-send was rejected too: the base op is
                    # what the peer does not speak — undo the latches.
                    if latched_here:
                        self._peer_deadlines = True
                    if attempt_latched_here:
                        self._peer_attempts = True
                raise  # the server answered: definitive, never retried
            except (StoreTimeoutError, asyncio.CancelledError):
                raise
            except Exception:
                attempt += 1
                retryable = not sent or op in _IDEMPOTENT_OPS
                if (policy is None or not retryable or self._closed
                        or attempt >= policy.max_attempts):
                    raise
                await self._retry_sleep(attempt)

    async def _send_once(self, op: int, key: str, count: int,
                         a: float, b: float, trace,
                         deadline_s: "float | None",
                         timeout: float, *, attempt: int = 0) -> tuple:
        if self._writer is None or self._io_loop is None:
            raise ConnectionError("store client is closed")
        self._seq = (self._seq + 1) & 0xFFFFFFFF
        seq = self._seq
        fut: asyncio.Future = self._io_loop.create_future()
        self._pending[seq] = fut
        try:
            try:
                wire.write_frame(
                    self._writer,
                    wire.encode_request(seq, op, key, count, a, b,
                                        trace=trace,
                                        deadline_s=deadline_s,
                                        attempt=attempt),
                )
                # Drain only under real buffer pressure.
                if (self._writer.transport.get_write_buffer_size()
                        > 256 * 1024):
                    await self._writer.drain()
            except Exception as exc:
                self._drop_connection(
                    exc if isinstance(exc, ConnectionError)
                    else ConnectionError(str(exc))
                )
                raise
            try:
                return await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                self._timeouts += 1
                raise StoreTimeoutError(
                    f"store gave no reply within {timeout}s "
                    f"(op {wire.op_name(op)})") from None
        finally:
            # Timeout / cancellation must not leak the future.
            self._pending.pop(seq, None)

    async def _request(self, op: int, key: str = "", count: int = 0,
                       a: float = 0.0, b: float = 0.0,
                       timeout_s: "float | None" = None) -> tuple:
        # Capture the ambient trace context on the CALLER's side — the
        # coroutine body runs on the I/O loop thread.
        return await self._await_on_io(self._request_io(
            op, key, count, a, b, tracing.current_context(), timeout_s))

    def _blocking_timeout(self, timeout_s: "float | None" = None) -> float:
        """Grace timeout for a blocking ``.result()`` wait: the request
        timeout plus the retry policy's worst-case backoff, plus one second
        of slack (the inner wait_for fires first by design)."""
        t = self._request_timeout_s if timeout_s is None else timeout_s
        if self._retry_policy is not None:
            t += self._retry_policy.max_total_delay_s()
        return t + 1.0

    def _request_blocking(self, op: int, key: str = "", count: int = 0,
                          a: float = 0.0, b: float = 0.0,
                          timeout_s: "float | None" = None) -> tuple:
        return self._submit(self._request_io(
            op, key, count, a, b, tracing.current_context(),
            timeout_s)).result(self._blocking_timeout(timeout_s))

    async def _retry_sleep(self, attempt: int) -> None:
        """One retry's backoff: the policy's jittered delay, stretched to
        at least the reconnect-backoff window's remainder. Counts the
        retry."""
        self._retries += 1
        delay = self._retry_policy.delay_s(attempt, self._rng)
        remaining = (self._backoff_until
                     - asyncio.get_running_loop().time())
        if remaining > 0:
            delay = max(delay, remaining)
        await asyncio.sleep(delay)

    async def _connect_with_retry(self) -> None:
        """Connect with the retry policy: a dial failure provably sent
        nothing, so retrying it is safe for every op (the bulk lane's
        retry surface — post-send bulk failures never retry)."""
        policy = self._retry_policy
        attempt = 0
        while True:
            try:
                return await self._connect_io()
            except asyncio.CancelledError:
                raise
            except Exception:
                attempt += 1
                if (policy is None or self._closed
                        or attempt >= policy.max_attempts):
                    raise
                await self._retry_sleep(attempt)

    # -- bulk path (OP_ACQUIRE_MANY) ----------------------------------------
    async def _bulk_io(self, blob: bytes, offsets: np.ndarray,
                       klens: np.ndarray, counts_np: np.ndarray,
                       spans: list[tuple[int, int]], capacity: float,
                       fill_rate: float, with_remaining: bool,
                       profile: bool = True,
                       parent: "tracing.TraceContext | None" = None,
                       timeout_s: "float | None" = None) -> list[tuple]:
        """Send every chunk of one bulk call pipelined on the connection,
        then await all replies: one wire round trip (per ~MAX_FRAME of
        keys) carries thousands of decisions. Chunks after the first are
        flagged chained, so the server decides them in order.

        Tracing: one ``client.acquire_many`` span covers the whole call;
        every chunk carries its context as the bulk trace tail (an old
        server ignores it by construction)."""
        tracer = tracing.get_tracer()
        tspan = (tracer.start_span("client.acquire_many", parent=parent,
                                   attrs={"rows": int(len(klens))})
                 if tracer.enabled else tracing._NULL_SPAN)
        timeout = (self._request_timeout_s if timeout_s is None
                   else timeout_s)
        with tspan, self.profiler.span("acquire_many", len(klens),
                                       enabled=profile):
            trace = tspan.context if self._peer_traces else None
            await self._connect_with_retry()
            if self._writer is None or self._io_loop is None:
                raise ConnectionError("store client is closed")
            futs: list[tuple[int, asyncio.Future]] = []
            try:
                try:
                    for i, (start, end) in enumerate(spans):
                        self._seq = (self._seq + 1) & 0xFFFFFFFF
                        seq = self._seq
                        fut: asyncio.Future = self._io_loop.create_future()
                        self._pending[seq] = fut
                        futs.append((seq, fut))
                        wire.write_frame(
                            self._writer, wire.encode_bulk_request_span(
                                seq, blob, offsets, klens, counts_np,
                                start, end, capacity, fill_rate,
                                with_remaining=with_remaining,
                                chained=(i > 0), trace=trace))
                    await self._writer.drain()
                except Exception as exc:
                    self._drop_connection(
                        exc if isinstance(exc, ConnectionError)
                        else ConnectionError(str(exc)))
                    raise
                try:
                    return await asyncio.wait_for(
                        asyncio.gather(*(f for _, f in futs)), timeout)
                except asyncio.TimeoutError:
                    self._timeouts += 1
                    raise StoreTimeoutError(
                        f"store gave no bulk reply within {timeout}s "
                        f"({len(klens)} rows)") from None
            finally:
                for seq, _ in futs:
                    self._pending.pop(seq, None)

    @staticmethod
    def _bulk_prepare(keys: Sequence[str], counts: Sequence[int]):
        """Whole-call key prep: ONE join + ONE encode for the all-ascii
        case, per-key encode only when non-ascii keys are present. Returns
        ``(blob, offsets, klens, counts_np, spans)`` — chunks encode by
        slicing the blob (:func:`wire.encode_bulk_request_span`)."""
        n = len(keys)
        counts_np = np.asarray(counts, np.uint32)
        joined = "".join(keys)
        if joined.isascii():  # char lens ARE byte lens: one encode
            blob = joined.encode("ascii")
            klens = np.fromiter(map(len, keys), np.int64, n)
        else:
            key_blobs = [k.encode("utf-8", "surrogateescape")
                         for k in keys]
            klens = np.fromiter(map(len, key_blobs), np.int64, n)
            blob = b"".join(key_blobs)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(klens, out=offsets[1:])
        return (blob, offsets, klens, counts_np,
                wire.bulk_chunk_spans(klens))

    @staticmethod
    def _bulk_assemble(chunks: list[tuple],
                       with_remaining: bool) -> BulkAcquireResult:
        if len(chunks) == 1:
            granted, remaining = chunks[0]
        else:
            granted = np.concatenate([c[0] for c in chunks])
            remaining = (np.concatenate([c[1] for c in chunks])
                         if with_remaining else None)
        return BulkAcquireResult(granted, remaining)

    @staticmethod
    def _bulk_empty(with_remaining: bool) -> BulkAcquireResult:
        return BulkAcquireResult(
            np.zeros((0,), bool),
            np.zeros((0,), np.float32) if with_remaining else None)

    async def acquire_many(self, keys: Sequence[str], counts: Sequence[int],
                           capacity: float, fill_rate_per_sec: float, *,
                           with_remaining: bool = True,
                           timeout_s: "float | None" = None
                           ) -> BulkAcquireResult:
        """One bulk round trip: prepare → chunked pipelined frames on the
        I/O loop → reassemble. Duplicate keys decide in request order,
        across chunk boundaries too."""
        if len(keys) == 0:
            return self._bulk_empty(with_remaining)
        blob, offsets, klens, counts_np, spans = self._bulk_prepare(
            keys, counts)
        chunks = await self._await_on_io(self._bulk_io(
            blob, offsets, klens, counts_np, spans, capacity,
            fill_rate_per_sec, with_remaining,
            parent=tracing.current_context(), timeout_s=timeout_s))
        return self._bulk_assemble(chunks, with_remaining)

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], capacity: float,
                              fill_rate_per_sec: float, *,
                              with_remaining: bool = True,
                              timeout_s: "float | None" = None
                              ) -> BulkAcquireResult:
        if len(keys) == 0:
            return self._bulk_empty(with_remaining)
        blob, offsets, klens, counts_np, spans = self._bulk_prepare(
            keys, counts)
        chunks = self._submit(self._bulk_io(
            blob, offsets, klens, counts_np, spans, capacity,
            fill_rate_per_sec, with_remaining,
            parent=tracing.current_context(),
            timeout_s=timeout_s)).result(self._blocking_timeout(timeout_s))
        return self._bulk_assemble(chunks, with_remaining)

    # -- client-side frame coalescing ---------------------------------------
    #: Cap on distinct (capacity, fill_rate) coalescing batchers: configs
    #: are per-call floats, so an unbounded map would leak under dynamic
    #: per-tenant rates. Overflow configs use per-request frames.
    _MAX_ACQUIRE_BATCHERS = 64

    def _acquire_batcher(self, capacity: float, fill_rate_per_sec: float):
        """Per-config MicroBatcher living on the I/O loop (only ever
        touched from it): a flush becomes ONE ACQUIRE_MANY frame. Returns
        ``None`` once the config cap is hit."""
        from distributedratelimiting.redis_tpu_torch.runtime.batcher import (
            MicroBatcher,
        )

        key = (float(capacity), float(fill_rate_per_sec))
        batcher = self._acquire_batchers.get(key)
        if batcher is None:
            if (self._closed
                    or len(self._acquire_batchers)
                    >= self._MAX_ACQUIRE_BATCHERS):
                return None

            async def flush(reqs):
                keys = [k for k, _ in reqs]
                counts = [c for _, c in reqs]
                blob, offsets, klens, counts_np, spans = (
                    self._bulk_prepare(keys, counts))
                # profile=False: every request in this flush records its
                # own 'acquire' span already.
                chunks = await self._bulk_io(
                    blob, offsets, klens, counts_np, spans, capacity,
                    fill_rate_per_sec, True, profile=False)
                res = self._bulk_assemble(chunks, True)
                return [AcquireResult(bool(res.granted[i]),
                                      float(res.remaining[i]))
                        for i in range(len(reqs))]

            batcher = MicroBatcher(
                flush, max_batch=self._coalesce_max_batch,
                max_delay_s=self._coalesce_max_delay_s,
                max_inflight=8,
            )
            self._acquire_batchers[key] = batcher
        return batcher

    async def _acquire_coalesced_io(self, key: str, count: int,
                                    capacity: float,
                                    fill_rate_per_sec: float,
                                    parent: "tracing.TraceContext | None"
                                    = None) -> AcquireResult:
        batcher = self._acquire_batcher(capacity, fill_rate_per_sec)
        if batcher is None:  # config cap hit: per-request framing
            granted, remaining = await self._request_io(
                wire.OP_ACQUIRE, key, count, capacity, fill_rate_per_sec,
                parent)
            return AcquireResult(granted, remaining)
        # The span covers submit → flush → wire round trip → fan-out (the
        # latency this caller observed); the batcher captures its trace
        # context as the member context.
        tracer = tracing.get_tracer()
        tspan = (tracer.start_span("client.acquire", parent=parent)
                 if tracer.enabled else tracing._NULL_SPAN)
        with tspan, self.profiler.span(wire.op_name(wire.OP_ACQUIRE), 1):
            res = await batcher.submit((key, count))
            if not res.granted:
                tspan.set_status("denied")
            return res

    # -- BucketStore API ----------------------------------------------------
    # ``timeout_s`` overrides ``request_timeout_s`` for ONE call. A
    # per-call timeout bypasses frame coalescing — the shared flush cannot
    # honor one member's tighter deadline.
    async def acquire(self, key: str, count: int, capacity: float,
                      fill_rate_per_sec: float, *,
                      timeout_s: "float | None" = None) -> AcquireResult:
        if self._coalesce and timeout_s is None:
            return await self._await_on_io(self._acquire_coalesced_io(
                key, count, capacity, fill_rate_per_sec,
                tracing.current_context()))
        granted, remaining = await self._request(
            wire.OP_ACQUIRE, key, count, capacity, fill_rate_per_sec,
            timeout_s=timeout_s)
        return AcquireResult(granted, remaining)

    def acquire_blocking(self, key: str, count: int, capacity: float,
                         fill_rate_per_sec: float, *,
                         timeout_s: "float | None" = None) -> AcquireResult:
        if self._coalesce and timeout_s is None:
            return self._submit(self._acquire_coalesced_io(
                key, count, capacity, fill_rate_per_sec,
                tracing.current_context())).result(
                self._blocking_timeout())
        granted, remaining = self._request_blocking(
            wire.OP_ACQUIRE, key, count, capacity, fill_rate_per_sec,
            timeout_s=timeout_s)
        return AcquireResult(granted, remaining)

    def peek_blocking(self, key: str, capacity: float,
                      fill_rate_per_sec: float) -> float:
        (value,) = self._request_blocking(wire.OP_PEEK, key, 0, capacity,
                                          fill_rate_per_sec)
        return value

    async def sync_counter(self, key: str, local_count: float,
                           decay_rate_per_sec: float, *,
                           timeout_s: "float | None" = None) -> SyncResult:
        score, ewma = await self._request(
            wire.OP_SYNC, key, 0, local_count, decay_rate_per_sec,
            timeout_s=timeout_s)
        return SyncResult(score, ewma)

    def sync_counter_blocking(self, key: str, local_count: float,
                              decay_rate_per_sec: float, *,
                              timeout_s: "float | None" = None
                              ) -> SyncResult:
        score, ewma = self._request_blocking(
            wire.OP_SYNC, key, 0, local_count, decay_rate_per_sec,
            timeout_s=timeout_s)
        return SyncResult(score, ewma)

    async def ping(self, *, timeout_s: "float | None" = None) -> None:
        await self._request(wire.OP_PING, timeout_s=timeout_s)

    def resilience_stats(self) -> dict:
        """Client-side resilience counters: retries issued, request
        timeouts, consecutive dial failures, and whether the reconnect
        backoff window is currently open."""
        loop = self._io_loop
        backing_off = (loop is not None
                       and self._backoff_until > loop.time())
        return {
            "retries": self._retries,
            "timeouts": self._timeouts,
            "connect_failures": self._connect_failures,
            "backing_off": backing_off,
        }

    async def save(self) -> None:
        """Ask the server to checkpoint its store to its configured path
        (≙ Redis ``BGSAVE``). Raises :class:`wire.RemoteStoreError` if the
        server has no snapshot path."""
        await self._request(wire.OP_SAVE)

    async def stats(self, reset: bool = False,
                    dump_flight: bool = False) -> dict:
        """Server + store metrics as a dict. ``reset=True`` asks the server
        to start a fresh serving/stage-latency window after the snapshot;
        ``dump_flight=True`` asks a JAX server for a flight-recorder dump."""
        import json

        flags = ((wire.STATS_FLAG_RESET if reset else 0)
                 | (wire.STATS_FLAG_FLIGHT_DUMP if dump_flight else 0))
        (text,) = await self._request(wire.OP_STATS, count=flags)
        return json.loads(text)

    # -- lifecycle ----------------------------------------------------------
    async def aclose(self) -> None:
        if self._closed:
            return
        with self._thread_gate:
            # Under the submit gate: every concurrent _submit either
            # already enqueued (ahead of the stop below) or fails fast.
            self._closed = True
        loop = self._io_loop
        if loop is None:
            return

        async def shutdown() -> None:
            self._drop_connection(ConnectionError("store client closed"))
            # Drain coalescing batchers AFTER the drop: their flushes hit
            # the closed connection and fail every parked waiter cleanly.
            for b in list(self._acquire_batchers.values()):
                await b.aclose()

        await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
            shutdown(), loop))
        loop.call_soon_threadsafe(loop.stop)
        if self._io_thread is not None:
            # to_thread: a 5 s worst-case join must not stall the caller's
            # event loop.
            await asyncio.to_thread(self._io_thread.join, 5.0)
        # Close only a stopped loop: if the join timed out the I/O thread
        # still runs it — leak it instead (daemon thread).
        if self._io_thread is None or not self._io_thread.is_alive():
            loop.close()
        self._io_loop = None

    def snapshot(self) -> dict:
        raise NotImplementedError(
            "snapshot/restore runs on the server's store — durable state "
            "lives with the store, clients are stateless"
        )

    def restore(self, snap: dict) -> None:
        raise NotImplementedError(
            "snapshot/restore runs on the server's store — durable state "
            "lives with the store, clients are stateless"
        )


# The JAX client's other lanes: metrics/traces/audit exports, placement and
# live-config control, and federation. (Windows, semaphores, hierarchical
# admission and reservations raise through BucketStore already.)
for _name in ("metrics", "traces", "audit", "placement_fetch",
              "placement_announce", "migrate_pull", "migrate_push",
              "config_fetch", "config_announce", "fed_lease", "fed_renew",
              "fed_reclaim"):
    setattr(RemoteBucketStore, _name, _not_ported(_name))
