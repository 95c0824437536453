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

Windows travel as ``OP_WINDOW`` / ``OP_FWINDOW`` frames (one per request)
and, in bulk, as ``ACQUIRE_MANY`` frames of the window kinds. Semaphore
ops are one ``OP_SEMA`` frame each. Two-level (tenant → key) admission is
one ``OP_ACQUIRE_H`` frame per request and, in bulk, one set of
``BULK_KIND_HBUCKET`` frames per tenant; against a server that does not
speak the tenant extension ("unknown op" / "unknown bulk kind") the client
latches, once, to flat child-only admission and counts every such decision
(``resilience_stats()["hier_fallbacks"]``).

Streaming reservations are one ``OP_RESERVE`` / ``OP_SETTLE`` frame each,
the ledger living server-side; against a server that answers "unknown op"
the client latches, once, to charging the estimate through the two-level
lane (``resilience_stats()["reserve_fallbacks"]``), and a "route-to-pool"
redirect is chased once (``reserves_routed``).

The observability plane reads over the wire: ``metrics()`` (``OP_METRICS``,
OpenMetrics text), ``traces()`` (``OP_TRACES``, Chrome-trace JSON) and
``audit()`` (``OP_AUDIT``); the placement control plane
``placement_fetch()``, ``placement_announce()``, ``migrate_pull()`` and
``migrate_push()`` (a coordinator's calls, :mod:`~.placement`). The chaos
seams of :mod:`..utils.faults` sit at the dial (``client.connect``, and the
wrapped transport's ``client.read`` / ``client.write``) and before each
retry (``client.retry``).

Live config (:mod:`~.liveconfig`): every keyed lane (scalar, PEEK, bulk,
window bulk, two-level on both levels, ``reserve``) translates its config
through the rules it learned, and on a routable ``config moved`` error
learns the rule and re-sends once with the new operands (the server
answered without touching the store, so the re-send is not a replay);
``config_fetch()`` and ``config_announce()`` are a coordinator's calls.

A ``placement moved`` error surfaces here as :class:`wire.RemoteStoreError`:
its chase lives in the cluster, as in JAX (:mod:`~.cluster`:
``ClusterBucketStore._routed``, ``peek_blocking``, the submitter and the
bulk fan-out refetch the map and re-route once).

The federation lane (``fed_lease`` / ``fed_renew`` / ``fed_reclaim``, one
``OP_FED_*`` JSON frame each) is a region's WAN link to its home ledger
(:mod:`~.federation`). Against a home that answers "unknown op" it latches
off once and answers ``{"fallback": True}``, which the region treats as a
partition.
"""

from __future__ import annotations

import asyncio
import json
import random
import threading
from typing import Awaitable, Callable, Sequence

import numpy as np

from distributedratelimiting.redis_tpu_torch.runtime import (
    liveconfig,
    reservations,
    wire,
)
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    Clock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    BulkAcquireResult,
    SyncResult,
    check_hierarchical_args,
)
from distributedratelimiting.redis_tpu_torch.utils import (
    faults,
    log,
    tracing,
)
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
        # Live-config translations learned from "config moved" errors: a
        # call carrying a retired (a, b) chases one routable error, then
        # every later call translates up front. {(kind, a, b) → (a, b)}.
        self._config_fwd: dict[tuple, tuple[float, float]] = {}

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
        # Old-peer latch of the tenant extension (OP_ACQUIRE_H / HBUCKET):
        # after the first "unknown op", hierarchical calls go flat.
        self._peer_hier = True
        self._hier_fallbacks = 0
        # Reservation-lane latch (OP_RESERVE/OP_SETTLE): an old server
        # answers "unknown op"; reserves then charge the estimate through
        # the two-level lane and settles are client-side no-ops.
        self._peer_reserve = True
        self._reserve_fallbacks = 0
        # OP_RESERVE route-to-pool redirects chased (once each).
        self._reserves_routed = 0
        # Federation-lane latch (OP_FED_LEASE/RENEW/RECLAIM): an old home
        # answers the routable unknown-op error — latch off once per
        # connection lifetime; the region then treats federation as
        # partitioned (keep serving the current slice, degrade to the
        # envelope at expiry — never unlimited, never hard-down).
        self._peer_fed = True
        self._fed_fallbacks = 0

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
                if faults._INJECTOR is not None:  # chaos seam; no-op in prod
                    await faults._INJECTOR.on_event("client.connect")
                if self._factory is not None:
                    reader, writer = await self._factory()
                else:
                    assert self._address is not None
                    reader, writer = await asyncio.open_connection(
                        self._address[0], self._address[1]
                    )
                if faults._INJECTOR is not None:
                    reader, writer = faults._INJECTOR.wrap_connection(
                        reader, writer)
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
                          timeout_s: "float | None" = None,
                          hier=None) -> tuple:
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            with self.profiler.span(wire.op_name(op), 1, annotate=False):
                return await self._request_io_unprofiled(
                    op, key, count, a, b, timeout_s=timeout_s, hier=hier)
        # The trace starts here (the client wire layer): `parent` is the
        # caller-side ambient context, captured before hopping onto the
        # I/O loop where contextvars do not follow.
        span = tracer.start_span(f"client.{wire.op_name(op)}",
                                 parent=parent)
        with span, self.profiler.span(wire.op_name(op), 1,
                                      annotate=False):
            trace = span.context if self._peer_traces else None
            try:
                vals = await self._request_io_unprofiled(
                    op, key, count, a, b, trace, timeout_s=timeout_s,
                    hier=hier)
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
                            timeout_s=timeout_s, hier=hier)
                    except wire.RemoteStoreError as exc2:
                        if "unknown op" in str(exc2):
                            # The bare re-send was rejected too: the base
                            # op is what the peer does not speak (OP_ACQUIRE_H
                            # against an old server) — undo the latch before
                            # surfacing.
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
                                     timeout_s: "float | None" = None,
                                     hier=None) -> tuple:
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
                                             attempt=atl, hier=hier)
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
                         timeout: float, *, attempt: int = 0,
                         hier=None) -> tuple:
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
                                        attempt=attempt, hier=hier),
                )
                # Drain only under real buffer pressure.
                if (self._writer.transport.get_write_buffer_size()
                        > 256 * 1024):
                    await self._writer.drain()
            except Exception as exc:
                # This request raises here: its own future must not be
                # failed by the drop below and left unretrieved.
                self._pending.pop(seq, None)
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
                       timeout_s: "float | None" = None,
                       hier=None) -> tuple:
        # Capture the ambient trace context on the CALLER's side — the
        # coroutine body runs on the I/O loop thread.
        return await self._await_on_io(self._request_io(
            op, key, count, a, b, tracing.current_context(), timeout_s,
            hier))

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
                          timeout_s: "float | None" = None,
                          hier=None) -> tuple:
        return self._submit(self._request_io(
            op, key, count, a, b, tracing.current_context(),
            timeout_s, hier)).result(self._blocking_timeout(timeout_s))

    async def _retry_sleep(self, attempt: int) -> None:
        """One retry's backoff: the policy's jittered delay, stretched to
        at least the reconnect-backoff window's remainder. Counts the
        retry."""
        self._retries += 1
        if faults._INJECTOR is not None:  # chaos seam; no-op in prod
            await faults._INJECTOR.on_event("client.retry")
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
                       timeout_s: "float | None" = None,
                       kind: int = wire.BULK_KIND_BUCKET,
                       hier=None) -> list[tuple]:
        """Send every chunk of one bulk call pipelined on the connection,
        then await all replies: one wire round trip (per ~MAX_FRAME of
        keys) carries thousands of decisions. Chunks after the first are
        flagged chained, so the server decides them in order. ``kind``
        selects the server's table tier (bucket, window, fixed window).

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
                                       annotate=False, enabled=profile):
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
                                with_remaining=with_remaining, kind=kind,
                                chained=(i > 0), trace=trace, hier=hier))
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
    def _bulk_prepare(keys: Sequence[str], counts: Sequence[int],
                      budget: "int | None" = None):
        """Whole-call key prep: ONE join + ONE encode for the all-ascii
        case, per-key encode only when non-ascii keys are present. Returns
        ``(blob, offsets, klens, counts_np, spans)`` — chunks encode by
        slicing the blob (:func:`wire.encode_bulk_request_span`), each
        within ``budget`` bytes (default the wire's chunk budget)."""
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
                wire.bulk_chunk_spans(klens, budget))

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

    async def _bulk_call(self, keys, counts, a: float, b: float,
                         with_remaining: bool, kind: int,
                         timeout_s: "float | None" = None
                         ) -> BulkAcquireResult:
        """One bulk round trip (any table kind): prepare → chunked
        pipelined frames on the I/O loop → reassemble. Duplicate keys
        decide in request order, across chunk boundaries too."""
        if len(keys) == 0:
            return self._bulk_empty(with_remaining)
        blob, offsets, klens, counts_np, spans = self._bulk_prepare(
            keys, counts)
        chunks = await self._await_on_io(self._bulk_io(
            blob, offsets, klens, counts_np, spans, a, b, with_remaining,
            parent=tracing.current_context(), timeout_s=timeout_s,
            kind=kind))
        return self._bulk_assemble(chunks, with_remaining)

    def _bulk_call_blocking(self, keys, counts, a: float, b: float,
                            with_remaining: bool, kind: int,
                            timeout_s: "float | None" = None
                            ) -> BulkAcquireResult:
        if len(keys) == 0:
            return self._bulk_empty(with_remaining)
        blob, offsets, klens, counts_np, spans = self._bulk_prepare(
            keys, counts)
        chunks = self._submit(self._bulk_io(
            blob, offsets, klens, counts_np, spans, a, b, with_remaining,
            parent=tracing.current_context(), timeout_s=timeout_s,
            kind=kind)).result(self._blocking_timeout(timeout_s))
        return self._bulk_assemble(chunks, with_remaining)

    async def acquire_many(self, keys: Sequence[str], counts: Sequence[int],
                           capacity: float, fill_rate_per_sec: float, *,
                           with_remaining: bool = True,
                           timeout_s: "float | None" = None
                           ) -> BulkAcquireResult:
        # One config-moved chase, like the scalar lanes: the server answers
        # a retired config frame-level without applying any row, so the
        # translated re-send is not a replay.
        return await self._chase_config(
            "bucket", capacity, fill_rate_per_sec,
            lambda a, b: self._bulk_call(keys, counts, a, b, with_remaining,
                                         wire.BULK_KIND_BUCKET, timeout_s))

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], capacity: float,
                              fill_rate_per_sec: float, *,
                              with_remaining: bool = True,
                              timeout_s: "float | None" = None
                              ) -> BulkAcquireResult:
        return self._chase_config_blocking(
            "bucket", capacity, fill_rate_per_sec,
            lambda a, b: self._bulk_call_blocking(
                keys, counts, a, b, with_remaining, wire.BULK_KIND_BUCKET,
                timeout_s))

    async def window_acquire_many(self, keys: Sequence[str],
                                  counts: Sequence[int], limit: float,
                                  window_sec: float, *, fixed: bool = False,
                                  with_remaining: bool = True
                                  ) -> BulkAcquireResult:
        """Bulk windows over the wire: the ACQUIRE_MANY framing with the
        table-kind flag selecting the server's window tier."""
        kind = wire.BULK_KIND_FWINDOW if fixed else wire.BULK_KIND_WINDOW
        return await self._chase_config(
            liveconfig.BULK_KINDS[kind], limit, window_sec,
            lambda a, b: self._bulk_call(keys, counts, a, b, with_remaining,
                                         kind))

    def window_acquire_many_blocking(self, keys: Sequence[str],
                                     counts: Sequence[int], limit: float,
                                     window_sec: float, *,
                                     fixed: bool = False,
                                     with_remaining: bool = True
                                     ) -> BulkAcquireResult:
        kind = wire.BULK_KIND_FWINDOW if fixed else wire.BULK_KIND_WINDOW
        return self._chase_config_blocking(
            liveconfig.BULK_KINDS[kind], limit, window_sec,
            lambda a, b: self._bulk_call_blocking(
                keys, counts, a, b, with_remaining, kind))

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
        with tspan, self.profiler.span(wire.op_name(wire.OP_ACQUIRE), 1,
                                       annotate=False):
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
        return await self._chase_config(
            "bucket", capacity, fill_rate_per_sec,
            lambda a, b: self._acquire_once(key, count, a, b, timeout_s))

    async def _acquire_once(self, key: str, count: int, capacity: float,
                            fill_rate_per_sec: float,
                            timeout_s: "float | None") -> AcquireResult:
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
        return self._chase_config_blocking(
            "bucket", capacity, fill_rate_per_sec,
            lambda a, b: self._acquire_once_blocking(key, count, a, b,
                                                     timeout_s))

    def _acquire_once_blocking(self, key: str, count: int,
                               capacity: float, fill_rate_per_sec: float,
                               timeout_s: "float | None") -> AcquireResult:
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
        (value,) = self._chase_config_blocking(
            "bucket", capacity, fill_rate_per_sec,
            lambda a, b: self._request_blocking(wire.OP_PEEK, key, 0, a, b))
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

    async def window_acquire(self, key: str, count: int, limit: float,
                             window_sec: float) -> AcquireResult:
        return await self._keyed_admission(wire.OP_WINDOW, "window", key,
                                           count, limit, window_sec)

    def window_acquire_blocking(self, key: str, count: int, limit: float,
                                window_sec: float) -> AcquireResult:
        return self._keyed_admission_blocking(wire.OP_WINDOW, "window", key,
                                              count, limit, window_sec)

    async def fixed_window_acquire(self, key: str, count: int, limit: float,
                                   window_sec: float) -> AcquireResult:
        return await self._keyed_admission(wire.OP_FWINDOW, "fwindow", key,
                                           count, limit, window_sec)

    def fixed_window_acquire_blocking(self, key: str, count: int,
                                      limit: float,
                                      window_sec: float) -> AcquireResult:
        return self._keyed_admission_blocking(wire.OP_FWINDOW, "fwindow",
                                              key, count, limit, window_sec)

    # -- live-config forwarding (runtime/liveconfig.py) ----------------------
    def _fwd_config(self, kind: str, a: float, b: float
                    ) -> tuple[float, float]:
        """Translate a possibly-retired config through the learned rules.
        Cycle-safe: a reverted mutation can leave a stale entry whose
        target maps back, and the walk stops at the first revisit, which is
        the serving config. The steady state is one empty-dict test."""
        fwd = self._config_fwd
        if not fwd:
            return a, b
        key = (kind, float(a), float(b))
        seen = set()
        while key not in seen:
            seen.add(key)
            nxt = fwd.get(key)
            if nxt is None:
                break
            key = (kind, nxt[0], nxt[1])
        return key[1], key[2]

    def _learn_config(self, exc: Exception, kind: str
                      ) -> "tuple[float, float] | None":
        """If ``exc`` is the routable "config moved" error of ``kind``,
        record the rule and return the (transitively resolved) operands to
        retry with; ``None`` for any other error."""
        parsed = liveconfig.parse_moved(str(exc))
        if parsed is None:
            return None
        pkind, old, new, _version = parsed
        if pkind != kind or old == new:
            return None
        self._config_fwd[(pkind, old[0], old[1])] = new
        # A rule old→new contradicts a cached new→old (a revert retired
        # it): evict it, or the walk would bounce between the pair.
        if self._config_fwd.get((pkind, new[0], new[1])) == old:
            del self._config_fwd[(pkind, new[0], new[1])]
        return self._fwd_config(pkind, new[0], new[1])

    async def _chase_config(self, kind: str, a: float, b: float, call):
        """The live-config contract every keyed lane shares: translate up
        front through the learned rules, and on a "config moved" error
        learn the rule and re-send once with the new operands. ``call(a,
        b)`` awaits the wire op."""
        a, b = self._fwd_config(kind, a, b)
        try:
            return await call(a, b)
        except wire.RemoteStoreError as exc:
            fwd = self._learn_config(exc, kind)
            if fwd is None:
                raise
            return await call(fwd[0], fwd[1])

    def _chase_config_blocking(self, kind: str, a: float, b: float,
                               call):
        a, b = self._fwd_config(kind, a, b)
        try:
            return call(a, b)
        except wire.RemoteStoreError as exc:
            fwd = self._learn_config(exc, kind)
            if fwd is None:
                raise
            return call(fwd[0], fwd[1])

    async def _chase_hier(self, tcap: float, trate: float, cap: float,
                          rate: float, call):
        """The two-level edition of :meth:`_chase_config`: both levels
        translate through the learned "bucket" rules up front, and a moved
        error on either level learns its rule and re-sends — at most two
        chases, one a level. ``call(ta, tb, a, b)`` awaits the wire op."""
        for attempt in range(3):
            a, b = self._fwd_config("bucket", cap, rate)
            ta, tb = self._fwd_config("bucket", tcap, trate)
            try:
                return await call(ta, tb, a, b)
            except wire.RemoteStoreError as exc:
                if (attempt >= 2
                        or self._learn_config(exc, "bucket") is None):
                    raise

    def _chase_hier_blocking(self, tcap: float, trate: float, cap: float,
                             rate: float, call):
        for attempt in range(3):
            a, b = self._fwd_config("bucket", cap, rate)
            ta, tb = self._fwd_config("bucket", tcap, trate)
            try:
                return call(ta, tb, a, b)
            except wire.RemoteStoreError as exc:
                if (attempt >= 2
                        or self._learn_config(exc, "bucket") is None):
                    raise

    async def _keyed_admission(self, op: int, kind: str, key: str,
                               count: int, a: float, b: float
                               ) -> AcquireResult:
        granted, remaining = await self._chase_config(
            kind, a, b, lambda a2, b2: self._request(op, key, count, a2, b2))
        return AcquireResult(granted, remaining)

    def _keyed_admission_blocking(self, op: int, kind: str, key: str,
                                  count: int, a: float, b: float
                                  ) -> AcquireResult:
        granted, remaining = self._chase_config_blocking(
            kind, a, b,
            lambda a2, b2: self._request_blocking(op, key, count, a2, b2))
        return AcquireResult(granted, remaining)

    # -- concurrency semaphore (OP_SEMA) ------------------------------------
    async def concurrency_acquire(self, key: str, count: int,
                                  limit: int) -> AcquireResult:
        granted, active = await self._request(
            wire.OP_SEMA, key, count, float(limit), 0.0)
        return AcquireResult(granted, active)

    def concurrency_acquire_blocking(self, key: str, count: int,
                                     limit: int) -> AcquireResult:
        granted, active = self._request_blocking(
            wire.OP_SEMA, key, count, float(limit), 0.0)
        return AcquireResult(granted, active)

    async def concurrency_release(self, key: str, count: int) -> None:
        await self._request(wire.OP_SEMA, key, -count, 0.0, 0.0)

    def concurrency_release_blocking(self, key: str, count: int) -> None:
        self._request_blocking(wire.OP_SEMA, key, -count, 0.0, 0.0)

    # -- hierarchical tenant → key admission (OP_ACQUIRE_H / HBUCKET) -------
    def _note_hier_fallback(self) -> None:
        """Old-peer latch: log the degradation once per client (the tenant
        level goes unenforced against this server), count every fallback
        decision."""
        if self._peer_hier:
            self._peer_hier = False
            log.error_evaluating_kernel(RuntimeError(
                "server does not speak the tenant extension "
                "(OP_ACQUIRE_H/HBUCKET); hierarchical calls fall back "
                "to FLAT child-only admission — tenant budgets are NOT "
                "enforced against this peer"))
        self._hier_fallbacks += 1

    @staticmethod
    def _hier_unsupported(exc: Exception) -> bool:
        msg = str(exc)
        return "unknown op" in msg or "unknown bulk kind" in msg

    async def acquire_hierarchical(self, tenant: str, key: str, count: int,
                                   tenant_capacity: float,
                                   tenant_fill_rate_per_sec: float,
                                   capacity: float,
                                   fill_rate_per_sec: float, *,
                                   priority: int = 0,
                                   timeout_s: "float | None" = None
                                   ) -> AcquireResult:
        """Two-level admission as ONE ``OP_ACQUIRE_H`` frame, decided
        server-side in one store call; ``priority`` rides the tenant
        extension."""
        check_hierarchical_args(count, tenant_capacity,
                                tenant_fill_rate_per_sec, capacity,
                                fill_rate_per_sec)
        if self._peer_hier:

            async def call(ta, tb, a, b):
                granted, remaining = await self._request(
                    wire.OP_ACQUIRE_H, key, count, a, b,
                    timeout_s=timeout_s, hier=(tenant, ta, tb, priority))
                return AcquireResult(granted, remaining)

            try:
                return await self._chase_hier(
                    tenant_capacity, tenant_fill_rate_per_sec, capacity,
                    fill_rate_per_sec, call)
            except wire.RemoteStoreError as exc:
                if not self._hier_unsupported(exc):
                    raise
                self._note_hier_fallback()
        else:
            self._hier_fallbacks += 1
        return await self.acquire(key, count, capacity, fill_rate_per_sec,
                                  timeout_s=timeout_s)

    def acquire_hierarchical_blocking(self, tenant: str, key: str,
                                      count: int, tenant_capacity: float,
                                      tenant_fill_rate_per_sec: float,
                                      capacity: float,
                                      fill_rate_per_sec: float, *,
                                      priority: int = 0,
                                      timeout_s: "float | None" = None
                                      ) -> AcquireResult:
        check_hierarchical_args(count, tenant_capacity,
                                tenant_fill_rate_per_sec, capacity,
                                fill_rate_per_sec)
        if self._peer_hier:

            def call(ta, tb, a, b):
                granted, remaining = self._request_blocking(
                    wire.OP_ACQUIRE_H, key, count, a, b,
                    timeout_s=timeout_s, hier=(tenant, ta, tb, priority))
                return AcquireResult(granted, remaining)

            try:
                return self._chase_hier_blocking(
                    tenant_capacity, tenant_fill_rate_per_sec, capacity,
                    fill_rate_per_sec, call)
            except wire.RemoteStoreError as exc:
                if not self._hier_unsupported(exc):
                    raise
                self._note_hier_fallback()
        else:
            self._hier_fallbacks += 1
        return self.acquire_blocking(key, count, capacity, fill_rate_per_sec,
                                     timeout_s=timeout_s)

    @staticmethod
    def _hier_tail_budget(tenant: str) -> int:
        """Chunk budget of HBUCKET frames: the tenant extension rides every
        chunk, so the spans leave room for it under the frame limit."""
        tlen = len(tenant.encode("utf-8", "surrogateescape"))
        return wire.BULK_CHUNK_BUDGET - (2 + tlen + wire.HIER_TAIL_LEN)

    async def acquire_hierarchical_many(self, tenants, keys, counts,
                                        tenant_capacity: float,
                                        tenant_fill_rate_per_sec: float,
                                        capacity: float,
                                        fill_rate_per_sec: float, *,
                                        with_remaining: bool = True,
                                        priority: int = 0,
                                        timeout_s: "float | None" = None
                                        ) -> BulkAcquireResult:
        """Bulk two-level admission over the wire: rows group by tenant
        (one set of HBUCKET frames per distinct tenant, all in flight
        together), results scatter back in row order."""
        n = len(keys)
        counts_np = np.asarray(counts, np.int64)
        check_hierarchical_args(int(counts_np.min(initial=0)),
                                tenant_capacity, tenant_fill_rate_per_sec,
                                capacity, fill_rate_per_sec)
        if n == 0:
            return self._bulk_empty(with_remaining)
        if not self._peer_hier:
            self._hier_fallbacks += 1
            return await self.acquire_many(
                keys, counts, capacity, fill_rate_per_sec,
                with_remaining=with_remaining, timeout_s=timeout_s)
        by_tenant: dict[str, list[int]] = {}
        for i, t in enumerate(tenants):
            by_tenant.setdefault(t, []).append(i)
        parent = tracing.current_context()

        async def one_tenant(tenant: str, idx: list[int]):
            sub_keys = [keys[i] for i in idx]
            sub_counts = counts_np[idx]
            if self._peer_hier:

                async def call(ta, tb, a, b):
                    blob, offsets, klens, c_np, spans = self._bulk_prepare(
                        sub_keys, sub_counts, self._hier_tail_budget(tenant))
                    chunks = await self._await_on_io(self._bulk_io(
                        blob, offsets, klens, c_np, spans, a, b,
                        with_remaining, parent=parent, timeout_s=timeout_s,
                        kind=wire.BULK_KIND_HBUCKET,
                        hier=(tenant, ta, tb, priority)))
                    return self._bulk_assemble(chunks, with_remaining)

                try:
                    return await self._chase_hier(
                        tenant_capacity, tenant_fill_rate_per_sec, capacity,
                        fill_rate_per_sec, call)
                except wire.RemoteStoreError as exc:
                    if not self._hier_unsupported(exc):
                        raise
                    self._note_hier_fallback()
            else:  # latched mid-call by a sibling tenant's frames
                self._hier_fallbacks += 1
            return await self.acquire_many(
                sub_keys, sub_counts, capacity, fill_rate_per_sec,
                with_remaining=with_remaining, timeout_s=timeout_s)

        groups = list(by_tenant.items())
        results = await asyncio.gather(
            *(one_tenant(t, idx) for t, idx in groups))
        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32) if with_remaining else None
        for (_, idx), res in zip(groups, results):
            granted[idx] = res.granted
            if remaining is not None:
                remaining[idx] = res.remaining
        return BulkAcquireResult(granted, remaining)

    # -- estimate-reserve-settle (OP_RESERVE / OP_SETTLE) --------------------
    #: The ledger lives SERVER-side; None (not a method) so a
    #: ``callable(...)`` probe (the server's, fronting this client) mints
    #: no local ledger nothing would serve.
    reservation_ledger = None

    def _note_reserve_fallback(self) -> None:
        if self._peer_reserve:
            self._peer_reserve = False
            log.error_evaluating_kernel(RuntimeError(
                "server does not speak the reservation lane "
                "(OP_RESERVE/OP_SETTLE); reserve falls back to plain "
                "acquire_hierarchical at the estimate — over-estimate "
                "refunds are NOT issued against this peer"))
        self._reserve_fallbacks += 1

    async def _reserve_fallback(self, tenant: str, key: str,
                                estimate: "float | None",
                                tenant_capacity: float,
                                tenant_fill_rate_per_sec: float,
                                capacity: float,
                                fill_rate_per_sec: float,
                                priority: int,
                                timeout_s: "float | None"):
        """Old-peer path: charge the estimate through the hierarchical
        lane (which itself degrades to flat child-only admission against
        even older peers). No hold exists anywhere — the later settle is
        a client-side no-op."""
        charge = reservations.fallback_charge(estimate)
        res = await self.acquire_hierarchical(
            tenant, key, charge, tenant_capacity,
            tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
            priority=priority, timeout_s=timeout_s)
        return reservations.ReserveResult(
            res.granted, float(charge) if res.granted else 0.0,
            res.remaining, 0.0, fallback=True)

    async def reserve(self, rid: str, tenant: str, key: str,
                      estimate: "float | None",
                      tenant_capacity: float,
                      tenant_fill_rate_per_sec: float,
                      capacity: float, fill_rate_per_sec: float, *,
                      priority: int = 0,
                      ttl_s: "float | None" = None,
                      timeout_s: "float | None" = None,
                      attempt: int = 0,
                      deadline_s: "float | None" = None):
        """One ``OP_RESERVE`` frame: admission at the estimate + a TTL'd
        server-side hold (:mod:`~.reservations`). Both config levels
        translate through the learned live-config rules up front (the
        ``_chase_hier`` contract); post-send retries are safe — the server
        dedups by ``rid``.

        ``attempt``/``deadline_s`` ride as JSON fields (not binary tails —
        old servers ignore unknown keys, so no latch). A "route-to-pool"
        answer (budget-aware pool routing) is chased ONCE: the re-send
        carries the redirect's pool config and the result reports
        ``routed=True``."""
        if not self._peer_reserve:
            self._reserve_fallbacks += 1
            return await self._reserve_fallback(
                tenant, key, estimate, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority, timeout_s)

        async def call(ta, tb, a, b, *, _tenant=tenant,
                       _priority=int(priority), _route=True):
            payload: dict = {"rid": rid, "tenant": _tenant, "key": key,
                             "a": a, "b": b, "ta": ta, "tb": tb,
                             "priority": _priority}
            if estimate is not None:
                payload["estimate"] = float(estimate)
            if ttl_s is not None:
                payload["ttl_s"] = float(ttl_s)
            if attempt:
                payload["attempt"] = int(attempt)
            if deadline_s is not None:
                payload["deadline_s"] = float(deadline_s)
            try:
                (text,) = await self._request(
                    wire.OP_RESERVE, json.dumps(payload),
                    timeout_s=timeout_s)
            except wire.RemoteStoreError as exc:
                route = (reservations.parse_route(str(exc))
                         if _route else None)
                if route is None:
                    raise
                # Chase the redirect once: re-send against the pool the
                # server named — the POOL is the tenant-bucket key, so
                # the hold lands in the pool's own budget, not the
                # exhausted interactive one. A second redirect surfaces
                # as the error — no routing loops.
                self._reserves_routed += 1
                pool_name = str(route["pool"])
                routed = await call(
                    float(route["ta"]), float(route["tb"]), a, b,
                    _tenant=pool_name,
                    _priority=int(route.get("priority", _priority)),
                    _route=False)
                return routed._replace(routed=True, pool=pool_name)
            d = json.loads(text)
            return reservations.ReserveResult(
                bool(d.get("granted")), float(d.get("reserved", 0.0)),
                float(d.get("remaining", 0.0)), float(d.get("debt", 0.0)),
                bool(d.get("duplicate", False)))

        try:
            return await self._chase_hier(
                tenant_capacity, tenant_fill_rate_per_sec, capacity,
                fill_rate_per_sec, call)
        except wire.RemoteStoreError as exc:
            if "unknown op" not in str(exc):
                raise
            self._note_reserve_fallback()
            return await self._reserve_fallback(
                tenant, key, estimate, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority, timeout_s)

    async def settle(self, rid: str, tenant: str, actual: float, *,
                     timeout_s: "float | None" = None):
        """One ``OP_SETTLE`` frame (idempotent by rid — post-send-retry-
        safe). Against a latched old peer this is a counted client-side
        no-op: the fallback reserve charged the estimate outright, and
        there is no server-side hold to reconcile."""
        if not self._peer_reserve:
            self._reserve_fallbacks += 1
            return reservations.SettleResult("fallback", 0.0, 0.0, 0.0)
        try:
            (text,) = await self._request(
                wire.OP_SETTLE,
                json.dumps({"rid": rid, "tenant": tenant,
                            "actual": float(actual)}),
                timeout_s=timeout_s)
        except wire.RemoteStoreError as exc:
            if "unknown op" not in str(exc):
                raise
            self._note_reserve_fallback()
            return reservations.SettleResult("fallback", 0.0, 0.0, 0.0)
        d = json.loads(text)
        return reservations.SettleResult(
            str(d.get("outcome", "settled")), float(d.get("delta", 0.0)),
            float(d.get("refunded", 0.0)), float(d.get("debt", 0.0)))

    # -- global quota federation (OP_FED_LEASE / RENEW / RECLAIM) ------------
    #: The ledger lives at the HOME; None (not a method) for the same
    #: reason as reservation_ledger — a ``callable(...)`` probe must skip
    #: this client, not mint a local ledger nothing serves.
    federation_ledger = None

    def _note_fed_fallback(self) -> None:
        if self._peer_fed:
            self._peer_fed = False
            log.error_evaluating_kernel(RuntimeError(
                "home does not speak the federation lane "
                "(OP_FED_LEASE/RENEW/RECLAIM); the region keeps "
                "serving from its current slice and degrades to its "
                "fair-share envelope at lease expiry — federation "
                "unavailability is treated as a partition"))
        self._fed_fallbacks += 1

    async def _fed_call(self, op: int, payload: dict,
                        timeout_s: "float | None") -> dict:
        """One federation control frame (JSON text; post-send-retry-safe
        — see _IDEMPOTENT_OPS). Against a latched old home this returns
        ``{"fallback": True}``: the region treats it as a partition
        symptom (keep serving, degrade at expiry) — the conservative
        direction, never unlimited."""
        if not self._peer_fed:
            self._fed_fallbacks += 1
            return {"fallback": True}
        try:
            (text,) = await self._request(op, json.dumps(payload),
                                          timeout_s=timeout_s)
        except wire.RemoteStoreError as exc:
            if "unknown op" not in str(exc):
                raise
            self._note_fed_fallback()
            return {"fallback": True}
        return json.loads(text)

    async def fed_lease(self, payload: dict, *,
                        timeout_s: "float | None" = None) -> dict:
        """Request (or idempotently re-request) a slice lease from the
        home federation ledger (``OP_FED_LEASE``; wire.py documents the
        payload and reply fields)."""
        return await self._fed_call(wire.OP_FED_LEASE, payload, timeout_s)

    async def fed_renew(self, payload: dict, *,
                        timeout_s: "float | None" = None) -> dict:
        """Renew a lease: report the region's monotonic admitted total
        and demand, extend the TTL, adopt any slice resize
        (``OP_FED_RENEW``; absorbing — replay-safe)."""
        return await self._fed_call(wire.OP_FED_RENEW, payload, timeout_s)

    async def fed_reclaim(self, payload: dict, *,
                          timeout_s: "float | None" = None) -> dict:
        """Return a slice to the pool (``OP_FED_RECLAIM``; idempotent by
        lease id — a duplicate replays the recorded result)."""
        return await self._fed_call(wire.OP_FED_RECLAIM, payload,
                                    timeout_s)

    async def ping(self, *, timeout_s: "float | None" = None) -> None:
        await self._request(wire.OP_PING, timeout_s=timeout_s)

    def resilience_stats(self) -> dict:
        """Client-side resilience counters: retries issued, request
        timeouts, consecutive dial failures, whether the reconnect backoff
        window is currently open, the hierarchical decisions that fell
        back to flat admission against an old peer, the reservation calls
        that fell back (``reserve_fallbacks``) and the route-to-pool
        redirects chased (``reserves_routed``)."""
        loop = self._io_loop
        backing_off = (loop is not None
                       and self._backoff_until > loop.time())
        return {
            "retries": self._retries,
            "timeouts": self._timeouts,
            "connect_failures": self._connect_failures,
            "backing_off": backing_off,
            "hier_fallbacks": self._hier_fallbacks,
            "reserve_fallbacks": self._reserve_fallbacks,
            "reserves_routed": self._reserves_routed,
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
        ``dump_flight=True`` asks the server for a flight-recorder dump
        first (its path lands in the payload's ``flight_recorder``)."""
        flags = ((wire.STATS_FLAG_RESET if reset else 0)
                 | (wire.STATS_FLAG_FLIGHT_DUMP if dump_flight else 0))
        (text,) = await self._request(wire.OP_STATS, count=flags)
        return json.loads(text)

    async def metrics(self) -> str:
        """The server's OpenMetrics text exposition (``OP_METRICS``) — the
        same bytes its HTTP ``/metrics`` endpoint serves."""
        (text,) = await self._request(wire.OP_METRICS)
        return text

    # -- placement / migration control plane (runtime/placement.py) ---------
    async def placement_fetch(self, *,
                              timeout_s: "float | None" = None) -> dict:
        """The node's adopted placement map and handoff state
        (``OP_PLACEMENT``); ``{"epoch": -1, …}`` from a node no coordinator
        has announced to yet."""
        (text,) = await self._request(wire.OP_PLACEMENT,
                                      timeout_s=timeout_s)
        return json.loads(text)

    async def placement_announce(self, payload: dict, *,
                                 timeout_s: "float | None" = None) -> int:
        """Announce a placement map (``{"map": …, "node_id": j}``) or an
        abort (``{"abort_epoch": e}``) to the node; returns the node's
        adopted epoch. A stale epoch answers :class:`wire.RemoteStoreError`."""
        (epoch,) = await self._request(
            wire.OP_PLACEMENT_ANNOUNCE, json.dumps(payload),
            timeout_s=timeout_s)
        return int(epoch)

    async def migrate_pull(self, req: dict, *,
                           timeout_s: "float | None" = None) -> dict:
        """Export and park state on the old owner for a pending epoch
        (``OP_MIGRATE_PULL``; idempotent per target epoch; a large export
        pages, ``req["page"]`` naming the page)."""
        (text,) = await self._request(wire.OP_MIGRATE_PULL,
                                      json.dumps(req), timeout_s=timeout_s)
        return json.loads(text)

    async def migrate_push(self, req: dict, *,
                           timeout_s: "float | None" = None) -> int:
        """Apply one handoff batch on the new owner (``OP_MIGRATE_PUSH``;
        exactly once per ``(target_epoch, batch)``). Returns the rows
        applied (0 for a deduplicated re-delivery)."""
        (applied,) = await self._request(wire.OP_MIGRATE_PUSH,
                                         json.dumps(req),
                                         timeout_s=timeout_s)
        return int(applied)

    # -- live-config control plane (runtime/liveconfig.py) --------------------
    async def config_fetch(self, *,
                           timeout_s: "float | None" = None) -> dict:
        """The node's committed live-config state (``OP_CONFIG`` with an
        empty payload): ``{"version": v, "rules": […]}``, ``{"version": 0,
        "rules": []}`` from a node no mutation has reached."""
        (text,) = await self._request(wire.OP_CONFIG, "{}",
                                      timeout_s=timeout_s)
        return json.loads(text)

    async def config_announce(self, payload: dict, *,
                              timeout_s: "float | None" = None) -> int:
        """One step of a live config mutation on the node: ``{"prepare":
        rule, "version": v}``, ``{"commit": v}``, ``{"abort": v}`` or
        ``{"adopt": snapshot}`` (each idempotent at its version). Returns
        the node's committed version; a stale version surfaces as
        :class:`wire.RemoteStoreError`."""
        (version,) = await self._request(
            wire.OP_CONFIG, json.dumps(payload), timeout_s=timeout_s)
        return int(version)

    async def traces(self, drain: bool = False) -> dict:
        """The server's kept traces as Chrome-trace-event JSON
        (``OP_TRACES``) — the payload of its HTTP ``/traces`` endpoint.
        ``drain=True`` empties the server's buffer after export
        (size-capped at MAX_FRAME; the newest traces win)."""
        (text,) = await self._request(wire.OP_TRACES,
                                      count=1 if drain else 0)
        return json.loads(text)

    async def audit(self, bundles: int = 0) -> dict:
        """The server's conservation-audit snapshot (``OP_AUDIT``):
        identity residues, ε-budget utilization per source, the burn-rate
        watchdog's state and alert log. ``bundles=N`` ships the newest N
        black-box incident bundles along, as ``GET /audit?bundles=N``
        does."""
        payload = json.dumps({"bundles": bundles}) if bundles else ""
        (text,) = await self._request(wire.OP_AUDIT, payload)
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
