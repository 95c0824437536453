"""The store server — the framework's "Redis process", on the GPU.

The core of the JAX package's ``runtime/server.py``:
:class:`BucketStoreServer` fronts a :class:`~.store.BucketStore` (typically
the card-resident :class:`~.store.DeviceBucketStore`) with an asyncio TCP
listener speaking the :mod:`~.wire` protocol, byte for byte as the JAX
server does — a client of either package talks to it. Every concurrent
request from every connection funnels into the store's micro-batcher, so N
clients × M in-flight requests coalesce into single kernel launches. Each
request is served as its own task and answers in completion order (the seq
id matches replies to requests); bulk continuation chunks chain per
connection so duplicate keys across a chunk boundary decide in chunk order.

Served: ``OP_ACQUIRE``, ``OP_WINDOW``, ``OP_FWINDOW``, ``OP_SEMA``
(semaphore acquire, probe and release), ``OP_ACQUIRE_H`` (two-level tenant
→ key admission), ``OP_ACQUIRE_MANY`` (bucket, window, fixed-window and
hierarchical-bucket kinds; keys resolve straight from the frame's bytes
through ``wire.KeyBlob``), ``OP_RESERVE`` / ``OP_SETTLE`` (the
estimate-reserve-settle lane, through the store's one
:class:`~.reservations.ReservationLedger`), ``OP_PEEK``, ``OP_SYNC``,
``OP_PING``, ``OP_SAVE`` (a full file, or with ``snapshot_incremental`` a
v4 delta against the previous save), ``OP_STATS`` and the ``OP_HELLO`` auth
handshake, with the trace, deadline and attempt tails (deadline-expired
work is shed unexecuted). Granted hierarchical costs and settled actuals
feed a per-tenant :class:`~.admission.TokenVelocity` (``OP_STATS``
``token_velocity``). The JAX server's live-config, drain-envelope,
placement, retry-shed, doomed-work, overflow-pool and heavy-hitter gates
on the hierarchical and reservation lanes are not ported (nor those
subsystems). An op the JAX server serves but this one does not yet
(placement, live config, federation, metrics, traces, audit) answers a
routable error that names it as not served — never the "unknown op" /
"unknown bulk kind" text, which a JAX client reads as an old peer and
silently falls back from.

Run it with ``python -m distributedratelimiting.redis_tpu_torch.runtime.server``
(a ``DeviceBucketStore`` on ``cuda`` unless ``--device cpu`` is given, or the
serial ``InProcessBucketStore`` with ``--backend inprocess``).
"""

from __future__ import annotations

import asyncio
import hmac
import json
import time

import numpy as np

from distributedratelimiting.redis_tpu_torch.runtime import admission, wire
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils import log, tracing
from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LatencyHistogram,
)

__all__ = ["BucketStoreServer", "main"]

#: Ops the JAX server serves that this one does not yet. Each answers a
#: routable error that never reads as "unknown op" (see the module doc).
_UNPORTED_OPS = frozenset((
    wire.OP_METRICS, wire.OP_TRACES, wire.OP_PLACEMENT,
    wire.OP_PLACEMENT_ANNOUNCE, wire.OP_MIGRATE_PULL, wire.OP_MIGRATE_PUSH,
    wire.OP_CONFIG, wire.OP_FED_LEASE, wire.OP_FED_RENEW, wire.OP_FED_RECLAIM,
    wire.OP_AUDIT))
#: Bulk kinds the JAX server serves that this one does not yet: none.
_UNPORTED_BULK_KINDS: dict[int, str] = {}


def _not_served(what: str) -> str:
    return (f"{what} is not served by this server yet (the PyTorch store "
            "server has not ported it)")


def _recover_seq(body: bytes) -> int:
    """Best-effort seq extraction from a frame body ([version][u32 seq]…)
    so even a malformed frame gets a *routable* error reply — a reply with
    the wrong seq would strand the client's future for its whole timeout."""
    return int.from_bytes(body[1:5], "little") if len(body) >= 5 else 0


class BucketStoreServer:
    """Serve a :class:`BucketStore` over TCP.

    Usage::

        server = BucketStoreServer(DeviceBucketStore(), host="0.0.0.0", port=6380)
        await server.start()
        ...
        await server.aclose()
    """

    def __init__(self, store: BucketStore, *, host: str = "127.0.0.1",
                 port: int = 0, snapshot_path: str | None = None,
                 auth_token: str | None = None,
                 tracing_config: "bool | dict | None" = None,
                 snapshot_incremental: bool = False) -> None:
        self.store = store
        self.host = host
        self.port = port
        # Server-configured checkpoint destination for OP_SAVE (≙ Redis
        # BGSAVE writing its configured dump file — clients never supply
        # paths, so the wire cannot be used to write arbitrary files).
        self.snapshot_path = snapshot_path
        # Incremental checkpoints: OP_SAVE then writes a v4 delta against
        # the previous save instead of a full v3 file; the chain owns base
        # retention, integrity chaining and compaction (checkpoint.py).
        self._snapshot_chain = None
        if snapshot_incremental and snapshot_path is not None:
            from distributedratelimiting.redis_tpu_torch.runtime import (
                checkpoint,
            )

            self._snapshot_chain = checkpoint.SnapshotChain(snapshot_path)
            dirty = getattr(store, "enable_dirty_tracking", None)
            if callable(dirty):
                dirty()  # arm the store's dirty accounting (OP_STATS)
        # Shared-secret auth: when set, a connection's first frame must be
        # a HELLO carrying this token.
        self.auth_token = auth_token
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._save_task: asyncio.Task | None = None
        self.connections_served = 0
        self.requests_served = 0
        # Requests dropped unexecuted because their client-stamped deadline
        # (wire DEADLINE_FLAG tail) expired while the frame sat in this
        # server's own queueing.
        self.requests_shed = 0
        #: Frames that arrived stamped attempt >= 1 (wire ATTEMPT_FLAG
        #: tail / bulk deadline tail): retries reaching this server.
        self.retry_attempts_seen = 0
        # Serving latency: request read (arrival) → result ready, the
        # latency the server is accountable for (OP_STATS serving_p50_ms /
        # serving_p99_ms); the reply stage is result ready → reply handed
        # to the transport.
        self.serving_latency = LatencyHistogram()
        self.reply_latency = LatencyHistogram()
        # Per-tenant tokens/s of the hierarchical lanes' GRANTED costs
        # (OP_STATS "token_velocity"); None turns the feed off.
        self.token_velocity: "admission.TokenVelocity | None" = (
            admission.TokenVelocity())
        # The estimate-reserve-settle ledger: the STORE-attached one, so a
        # store re-fronted by a new server keeps its holds and debts;
        # wired to this server's velocity (settles feed it the actual
        # spend). A client store (no ledger of its own) serves no
        # reservations.
        if callable(getattr(store, "reservation_ledger", None)):
            self.reservations = store.reservation_ledger()
            self.reservations.velocity = self.token_velocity
        else:
            self.reservations = None
        # Tracing rides the process-global tracer: True enables it with
        # defaults, a dict passes knobs through, None leaves it as is.
        if tracing_config is not None:
            if isinstance(tracing_config, dict):
                tracing.configure(**tracing_config)
            else:
                tracing.configure(enabled=bool(tracing_config))
        self.tracer = tracing.get_tracer()

    async def start(self) -> tuple[str, int]:
        """Bind and listen; returns the bound ``(host, port)`` (port 0 in
        the constructor picks a free one)."""
        await self.store.connect()
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port
        )
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        return self.host, self.port

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self.connections_served += 1
        write_lock = asyncio.Lock()
        request_tasks: set[asyncio.Task] = set()
        # Bulk frames chain per connection: a chunked acquire_many arrives
        # as several ACQUIRE_MANY frames whose duplicate keys must decide
        # in chunk order — independent tasks could race chunk 2 past chunk
        # 1. Non-bulk ops stay fully concurrent.
        bulk_tail: asyncio.Task | None = None
        authed = self.auth_token is None
        conn_task = asyncio.current_task()
        if conn_task is not None:
            self._conn_tasks.add(conn_task)
            conn_task.add_done_callback(self._conn_tasks.discard)
        try:
            while True:
                body = await wire.read_frame(reader)
                if body is None:
                    break
                # Frame-read time is the arrival stamp: deadline shedding
                # and serving latency both measure from the moment the
                # bytes were in hand.
                t_read = time.perf_counter()
                # Version + auth are connection-level gates, checked in
                # order here (not in per-request tasks, which complete out
                # of order): a bad frame gets one best-effort error reply,
                # then the connection drops.
                if body and body[0] != wire.PROTOCOL_VERSION:
                    await self._reply(writer, write_lock, wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR,
                        f"protocol version mismatch: peer speaks "
                        f"v{body[0]}, server speaks "
                        f"v{wire.PROTOCOL_VERSION}"))
                    break
                op = body[5] if len(body) >= 6 else 0
                if op == wire.OP_HELLO:
                    try:
                        seq, _, token, _, _, _ = wire.decode_request(body)
                    except Exception:  # malformed HELLO: routable error, drop
                        await self._reply(writer, write_lock,
                                          wire.encode_response(
                                              _recover_seq(body),
                                              wire.RESP_ERROR,
                                              "malformed HELLO frame"))
                        break
                    if self.auth_token is not None and not hmac.compare_digest(
                            token.encode("utf-8", "surrogateescape"),
                            self.auth_token.encode("utf-8",
                                                   "surrogateescape")):
                        await self._reply(writer, write_lock,
                                          wire.encode_response(
                                              seq, wire.RESP_ERROR,
                                              "authentication failed"))
                        break
                    authed = True
                    await self._reply(writer, write_lock,
                                      wire.encode_response(
                                          seq, wire.RESP_EMPTY))
                    continue
                if not authed:
                    await self._reply(writer, write_lock, wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR,
                        "authentication required: send HELLO first"))
                    break
                if op == wire.OP_ACQUIRE_MANY:
                    # Only continuation chunks chain; independent bulk
                    # frames — every client-coalesced flush included —
                    # pipeline freely.
                    after = (bulk_tail if wire.bulk_request_chained(body)
                             else None)
                    task = asyncio.ensure_future(self._serve_request(
                        body, writer, write_lock, after=after,
                        arrival_s=t_read))
                    bulk_tail = task
                else:
                    task = asyncio.ensure_future(self._serve_request(
                        body, writer, write_lock, arrival_s=t_read))
                request_tasks.add(task)
                task.add_done_callback(request_tasks.discard)
        except wire.RemoteStoreError as exc:
            log.error_evaluating_kernel(exc)  # protocol-broken peer: drop
        finally:
            for t in request_tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    #: Only await drain once the transport's buffer passes this: past the
    #: mark, drain applies backpressure against a slow-reading client.
    _DRAIN_HIGH_WATER = 256 * 1024

    async def _reply(self, writer: asyncio.StreamWriter,
                     write_lock: asyncio.Lock, resp: bytes) -> None:
        # The lock keeps concurrent request tasks' frames from
        # interleaving; a vanished client just drops the reply (its
        # futures die with the socket).
        async with write_lock:
            try:
                wire.write_frame(writer, resp)
                if (writer.transport.get_write_buffer_size()
                        > self._DRAIN_HIGH_WATER):
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _serve_request(self, body: bytes, writer: asyncio.StreamWriter,
                             write_lock: asyncio.Lock,
                             after: "asyncio.Task | None" = None,
                             arrival_s: "float | None" = None) -> None:
        t_arrival = time.perf_counter() if arrival_s is None else arrival_s
        if after is not None:
            # Per-connection bulk ordering (see _serve_connection). The
            # predecessor's own failure was already replied there.
            await asyncio.gather(after, return_exceptions=True)
        resp = await self.handle_frame_body(body, arrival_s=t_arrival)
        self.requests_served += 1
        t_ready = time.perf_counter()
        self.serving_latency.record(t_ready - t_arrival)
        await self._reply(writer, write_lock, resp)
        self.reply_latency.record(time.perf_counter() - t_ready)

    async def handle_frame_body(self, body: bytes,
                                arrival_s: "float | None" = None) -> bytes:
        """Serve one frame body and return the encoded reply. Store and
        decode failures come back as routable RESP_ERROR frames, never as
        raises (except cancellation), so one bad request can never take a
        connection down with it.

        Trace-stamped frames (scalar op flag / bulk flags bit 4) are
        stripped here and served inside a ``server.<op>`` span parented on
        the client's context; the span's status is read from the encoded
        reply (denied decision / error). Deadline-stamped frames are
        stripped next: when this server's own queueing already consumed
        the client's budget, the request is SHED — a routable "deadline
        exceeded" error, the store untouched. Attempt-stamped retries are
        counted."""
        tctx = None
        deadline_s = None
        attempt = 0
        flagged_op = None
        if (len(body) >= 6 and body[5] & (wire.TRACE_FLAG
                                          | wire.DEADLINE_FLAG
                                          | wire.ATTEMPT_FLAG)):
            # Remember the raw flagged byte: if the residual frame fails
            # strict decode after the strips below, it was never a flagged
            # <op> — answer the "unknown op" an old server gives the byte
            # as sent, not a misparse of whatever op the masked bits spell.
            flagged_op = body[5]
        if len(body) >= 6:
            if body[5] & wire.TRACE_FLAG:
                try:
                    body, tctx = wire.strip_trace(body)
                except wire.RemoteStoreError as exc:
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR, repr(exc))
            if body[5] & wire.DEADLINE_FLAG:
                try:
                    body, deadline_s = wire.strip_deadline(body)
                except wire.RemoteStoreError as exc:
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR, repr(exc))
            if body[5] & wire.ATTEMPT_FLAG:
                try:
                    body, attempt = wire.strip_attempt(body)
                except wire.RemoteStoreError as exc:
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR, repr(exc))
            if body[5] == wire.OP_ACQUIRE_MANY:
                tctx = wire.bulk_trace_tail(body)
                # The bulk lane's deadline + attempt ride one payload tail
                # (flags bit 5), honored through the same gate below.
                btail = wire.bulk_deadline_tail(body)
                if btail is not None:
                    deadline_s, attempt = btail
        if attempt:
            self.retry_attempts_seen += 1
        if deadline_s is not None and arrival_s is not None:
            waited = time.perf_counter() - arrival_s
            if waited > deadline_s:
                self.requests_shed += 1
                return wire.encode_response(
                    _recover_seq(body), wire.RESP_ERROR,
                    f"deadline exceeded: request waited "
                    f"{waited * 1e3:.1f}ms against a "
                    f"{deadline_s * 1e3:.1f}ms budget (shed unexecuted)")
        if tctx is None or not self.tracer.enabled:
            return await self._handle_frame_inner(body,
                                                  flagged_op=flagged_op)
        op = body[5] if len(body) >= 6 else 0
        with self.tracer.start_span(
                f"server.{wire.op_name(op)}", parent=tctx) as span:
            resp = await self._handle_frame_inner(body,
                                                  flagged_op=flagged_op)
            kind = resp[9] if len(resp) >= 10 else 0
            if kind == wire.RESP_ERROR:
                span.set_status("error")
            elif (kind == wire.RESP_DECISION and len(resp) >= 11
                    and resp[10] == 0):
                span.set_status("denied")
            elif kind == wire.RESP_BULK and len(resp) >= 15:
                # Bulk reply: [u8 flags][u32 n][granted bits…] at offset
                # 10. Any denied row marks the span.
                n = int.from_bytes(resp[11:15], "little")
                nbits = (n + 7) // 8
                granted = sum(bin(b).count("1")
                              for b in resp[15:15 + nbits])
                if granted < n:
                    span.set_status("denied")
                    span.set_attr("denied_rows", n - granted)
        return resp

    async def _handle_frame_inner(self, body: bytes, *,
                                  flagged_op: "int | None" = None) -> bytes:
        seq = _recover_seq(body)
        try:
            if len(body) >= 6 and body[5] == wire.OP_ACQUIRE_MANY:
                # as_view: keys stay a KeyBlob over the frame bytes — the
                # device store's native directory resolves them without a
                # Python string per key. One frame = one store bulk call.
                seq, keys, counts, a, b, with_rem, kind = (
                    wire.decode_bulk_request(body, as_view=True))
                if kind in _UNPORTED_BULK_KINDS:
                    return wire.encode_response(
                        seq, wire.RESP_ERROR, _not_served(
                            f"bulk kind {kind} "
                            f"({_UNPORTED_BULK_KINDS[kind]})"))
                if kind == wire.BULK_KIND_HBUCKET:
                    return await self._serve_bulk_hier(
                        seq, body, keys, counts, a, b, with_rem)
                if kind == wire.BULK_KIND_BUCKET:
                    res = await self.store.acquire_many(
                        keys, counts, a, b, with_remaining=with_rem)
                else:
                    res = await self.store.window_acquire_many(
                        keys, counts, a, b,
                        fixed=(kind == wire.BULK_KIND_FWINDOW),
                        with_remaining=with_rem)
                return wire.encode_bulk_response(seq, res.granted,
                                                 res.remaining)
            if len(body) >= 6 and body[5] == wire.OP_ACQUIRE_H:
                return await self._serve_hierarchical(body)
            try:
                seq, op, key, count, a, b = wire.decode_request(body)
            except wire.RemoteStoreError:
                raise  # already routable ("unknown op N", truncated, ...)
            except Exception as exc:
                if flagged_op is not None:
                    # The tails were stripped off a flagged op byte whose
                    # masked bits spell a real op, but the residual payload
                    # is not that op's shape: reject the byte as sent.
                    raise wire.RemoteStoreError(
                        f"unknown op {flagged_op}") from exc
                raise
            if op in _UNPORTED_OPS:
                resp = wire.encode_response(
                    seq, wire.RESP_ERROR, _not_served(wire.op_name(op)))
            elif op == wire.OP_ACQUIRE:
                res = await self.store.acquire(key, count, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_DECISION, res.granted, res.remaining)
            elif op == wire.OP_WINDOW:
                res = await self.store.window_acquire(key, count, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_DECISION, res.granted, res.remaining)
            elif op == wire.OP_FWINDOW:
                res = await self.store.fixed_window_acquire(key, count, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_DECISION, res.granted, res.remaining)
            elif op == wire.OP_SEMA:
                # count >= 0 acquires (0 probes) against the limit in a;
                # a negative count releases.
                if count >= 0:
                    res = await self.store.concurrency_acquire(key, count,
                                                               int(a))
                    resp = wire.encode_response(
                        seq, wire.RESP_DECISION, res.granted, res.remaining)
                else:
                    await self.store.concurrency_release(key, -count)
                    resp = wire.encode_response(seq, wire.RESP_DECISION,
                                                True, 0.0)
            elif op == wire.OP_PEEK:
                # peek_blocking can wait on the store lock and a device
                # readback — off-loop, so one PEEK never stalls the other
                # connections' traffic.
                value = await asyncio.to_thread(
                    self.store.peek_blocking, key, a, b)
                resp = wire.encode_response(seq, wire.RESP_VALUE, value)
            elif op == wire.OP_SYNC:
                res = await self.store.sync_counter(key, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_PAIR, res.global_score,
                    res.period_ewma_ticks)
            elif op == wire.OP_RESERVE:
                resp = await self._serve_reserve(seq, json.loads(key))
            elif op == wire.OP_SETTLE:
                resp = await self._serve_settle(seq, json.loads(key))
            elif op == wire.OP_PING:
                resp = wire.encode_response(seq, wire.RESP_EMPTY)
            elif op == wire.OP_SAVE:
                if self.snapshot_path is None:
                    resp = wire.encode_response(
                        seq, wire.RESP_ERROR,
                        "server has no --snapshot-path configured")
                else:
                    await self._save()
                    resp = wire.encode_response(seq, wire.RESP_EMPTY)
            elif op == wire.OP_STATS:
                resp = wire.encode_response(
                    seq, wire.RESP_TEXT, self._stats_json())
                if count & wire.STATS_FLAG_RESET:
                    # Start a fresh measurement window (serving + every
                    # stage histogram).
                    self.serving_latency.reset()
                    self.reply_latency.reset()
                    metrics = getattr(self.store, "metrics", None)
                    if metrics is not None:
                        metrics.flush_latency.reset()
                        metrics.queue_latency.reset()
            else:  # HELLO past the connection gate
                resp = wire.encode_response(
                    seq, wire.RESP_ERROR, f"unknown op {op}")
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # relay (with the recovered seq), never
            log.error_evaluating_kernel(exc)  # kill the connection
            resp = wire.encode_response(seq, wire.RESP_ERROR, repr(exc))
        return resp

    async def _serve_hierarchical(self, body: bytes) -> bytes:
        """One ``OP_ACQUIRE_H`` frame: two-level tenant → key weighted-cost
        admission, one store call (one launch on a card store)."""
        seq, key, count, a, b, tenant, ta, tb, priority = (
            wire.decode_hierarchical_request(body))
        res = await self.store.acquire_hierarchical(
            tenant, key, count, ta, tb, a, b, priority=priority)
        if res.granted and count > 0 and self.token_velocity is not None:
            self.token_velocity.observe(tenant, float(count))
        return wire.encode_response(seq, wire.RESP_DECISION, res.granted,
                                    res.remaining)

    async def _serve_bulk_hier(self, seq: int, body: bytes, keys, counts,
                               a: float, b: float, with_rem: bool) -> bytes:
        """One ``BULK_KIND_HBUCKET`` frame: one tenant's rows (the tenant
        extension rides the frame's tail) decided two-level in one store
        call."""
        tenant, ta, tb, priority = wire.bulk_hier_tail(body)
        counts_np = np.asarray(counts, np.int64)
        res = await self.store.acquire_hierarchical_many(
            [tenant] * len(keys), keys, counts_np, ta, tb, a, b,
            with_remaining=with_rem, priority=priority)
        if self.token_velocity is not None:
            admitted = int(counts_np[np.asarray(res.granted, bool)].sum())
            if admitted > 0:
                self.token_velocity.observe(tenant, float(admitted))
        return wire.encode_bulk_response(seq, res.granted, res.remaining)

    # -- estimate-reserve-settle (runtime/reservations.py) --------------------
    async def _serve_reserve(self, seq: int, req: dict) -> bytes:
        """One ``OP_RESERVE`` frame: admission at the estimate + a TTL'd
        ledger hold, the same JSON reply as the JAX server's. The decision
        is the store's two-level one (one launch on a card store)."""
        rid = str(req.get("rid") or "")
        tenant = str(req.get("tenant") or "")
        key = str(req.get("key") or "")
        if not rid or not tenant or not key:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "reserve requires rid, tenant, and key")
        estimate = req.get("estimate")
        a, b = float(req.get("a", 0.0)), float(req.get("b", 0.0))
        ta, tb = float(req.get("ta", 0.0)), float(req.get("tb", 0.0))
        priority = int(req.get("priority", 0))
        ttl_s = req.get("ttl_s")
        attempt = int(req.get("attempt", 0) or 0)
        try:
            deadline_s = (float(req["deadline_s"])
                          if req.get("deadline_s") is not None else None)
        except (TypeError, ValueError):
            deadline_s = None
        # Not ported here, as the subsystems behind them are not: the
        # live-config gate on both levels, the drain envelope, and the
        # placement MOVED / envelope answers keyed on the tenant.
        led = self.reservations
        if led is None:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "this server has no reservation ledger")
        if attempt:
            self.retry_attempts_seen += 1
        # Not ported here: the retry-shed and doomed-work answers, the
        # overflow-pool route-to-pool redirect and the heavy-hitter offer.
        res = await led.reserve(rid, tenant, key, estimate, ta, tb,
                                a, b, priority=priority, ttl_s=ttl_s,
                                attempt=attempt, deadline_s=deadline_s)
        return wire.encode_response(seq, wire.RESP_TEXT, json.dumps(
            {"granted": res.granted, "reserved": res.reserved,
             "remaining": res.remaining, "debt": res.debt,
             "duplicate": res.duplicate}))

    async def _serve_settle(self, seq: int, req: dict) -> bytes:
        """One ``OP_SETTLE`` frame: reconcile a reservation's actual cost
        (idempotent by rid: a retry replays the recorded result)."""
        rid = str(req.get("rid") or "")
        tenant = str(req.get("tenant") or "")
        if not rid or not tenant:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "settle requires rid and tenant")
        try:
            actual = float(req.get("actual", 0.0))
        except (TypeError, ValueError):
            return wire.encode_response(seq, wire.RESP_ERROR,
                                        "settle actual must be a number")
        # Not ported here: the drain relay to a successor and the
        # placement deferral / MOVED answers.
        if self.reservations is None:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "this server has no reservation ledger")
        res = await self.reservations.settle(rid, tenant, actual)
        return wire.encode_response(seq, wire.RESP_TEXT,
                                    json.dumps(res._asdict()))

    async def _save(self) -> None:
        """Checkpoint the store to the configured path off-loop: through
        the delta chain when the server holds one (it compacts into a full
        base on its own thresholds), else a full file. Concurrent SAVEs
        piggyback on the one in flight (BGSAVE semantics) instead of
        queueing redundant state pulls; a chain's links therefore never
        interleave."""
        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )

        if self._save_task is None or self._save_task.done():
            if self._snapshot_chain is not None:
                self._save_task = asyncio.ensure_future(asyncio.to_thread(
                    self._snapshot_chain.save, self.store))
            else:
                self._save_task = asyncio.ensure_future(asyncio.to_thread(
                    checkpoint.save_snapshot, self.store,
                    self.snapshot_path))
        await asyncio.shield(self._save_task)

    def _stats_json(self) -> str:
        """OP_STATS body: the JAX server's asyncio-path keys."""
        payload = {
            "connections_served": self.connections_served,
            "requests_served": self.requests_served,
            "serving_p50_ms": self.serving_latency.p50 * 1e3,
            "serving_p99_ms": self.serving_latency.p99 * 1e3,
            "serving_samples": self.serving_latency.total,
            "requests_shed": self.requests_shed,
            # The destructive-reset tripwire: the serving histogram counts
            # its resets, whoever triggered them.
            "stats_resets": self.serving_latency.resets,
        }
        metrics = getattr(self.store, "metrics", None)
        if metrics is not None:
            payload["store"] = metrics.snapshot()
        # Per-stage decomposition: serving ≈ queue + flush + reply.
        stages: dict = {}
        for name, hist in (("queue", getattr(metrics, "queue_latency", None)),
                           ("flush", getattr(metrics, "flush_latency", None)),
                           ("reply", self.reply_latency)):
            if hist is not None and hist.total:
                stages[name] = {"p50_ms": hist.p50 * 1e3,
                                "p99_ms": hist.p99 * 1e3,
                                "samples": hist.total}
        if stages:
            payload["stages"] = stages
        if (self.token_velocity is not None
                and self.token_velocity.observed_tokens > 0):
            payload["token_velocity"] = self.token_velocity.snapshot()
        if self.reservations is not None and self.reservations.active:
            # stats() piggybacks one TTL-expiry pass — a scraped-but-idle
            # server still auto-settles dead clients' holds.
            payload["reservations"] = self.reservations.stats()
        if self.retry_attempts_seen:
            payload["retry"] = {"attempts_seen": self.retry_attempts_seen}
        if self._snapshot_chain is not None:
            payload["snapshot_chain"] = self._snapshot_chain.stats()
            dirty = getattr(self.store, "dirty_stats", None)
            if callable(dirty):
                payload["snapshot_chain"]["dirty"] = dirty()
        return json.dumps(payload)

    async def aclose(self) -> None:
        if self._server is not None:
            self._server.close()
        # Cancel live connection handlers BEFORE wait_closed(): since
        # Python 3.12 wait_closed() waits for handler tasks too, so a
        # server with connected clients would deadlock shutdown.
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*list(self._conn_tasks),
                                 return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "BucketStoreServer":
        await self.start()
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.aclose()


def main(argv: list[str] | None = None) -> None:
    """Run a store server from the console — the process that plays the
    Redis role on the GPU host::

        python -m distributedratelimiting.redis_tpu_torch.runtime.server --port 6380

    SIGTERM or SIGINT closes it cleanly (after a final checkpoint when
    ``--snapshot-path`` is set, through the delta chain with
    ``--snapshot-incremental``) and the process exits 0."""
    import argparse

    parser = argparse.ArgumentParser(description="GPU bucket-store server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6380)
    parser.add_argument("--backend", choices=("device", "inprocess"),
                        default="device",
                        help="device = DeviceBucketStore (the card's "
                        "tables and kernels); inprocess = the serial "
                        "pure-Python InProcessBucketStore (the kernel-free "
                        "baseline and test backing)")
    parser.add_argument("--slots", type=int, default=2**17,
                        help="slots per bucket table")
    parser.add_argument("--device", default="cuda",
                        help="device of the store's tables: cuda (default; "
                        "the hand-written kernels) or cpu (their plain "
                        "PyTorch versions)")
    parser.add_argument("--snapshot-path", default=None,
                        help="checkpoint file for OP_SAVE (≙ Redis BGSAVE "
                        "dump path); if it exists at startup the store "
                        "restores from it (any .delta.* chain beside it is "
                        "applied too), and SIGTERM writes a final one")
    parser.add_argument("--snapshot-incremental", action="store_true",
                        help="OP_SAVE writes v4 delta checkpoints against "
                        "the previous save instead of full files (base + "
                        "bounded chain + compaction); requires "
                        "--snapshot-path")
    parser.add_argument("--sweep-period", type=float, default=0.0,
                        help="active TTL-expiry period in seconds "
                        "(0 = on-demand sweeps only)")
    parser.add_argument("--auth-token", default=None,
                        help="shared secret; when set, clients must HELLO "
                        "with it before any other op (≙ Redis AUTH)")
    parser.add_argument("--trace", action="store_true",
                        help="enable distributed tracing: sampled requests "
                        "record span trees (client wire, server dispatch, "
                        "batcher, kernel launch)")
    parser.add_argument("--trace-sample", type=float, default=0.01,
                        help="head-sampling rate: fraction of new traces "
                        "recorded at all")
    parser.add_argument("--trace-latency-ms", type=float, default=50.0,
                        help="tail-sampling latency threshold: traces with "
                        "any span at/above this are always kept")
    parser.add_argument("--trace-buffer", type=int, default=256,
                        help="bounded in-memory kept-trace buffer (oldest "
                        "evicted first)")
    args = parser.parse_args(argv)
    if args.snapshot_incremental and not args.snapshot_path:
        parser.error("--snapshot-incremental requires --snapshot-path "
                     "(there is no chain without a base file)")

    async def serve() -> None:
        import signal

        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )
        from distributedratelimiting.redis_tpu_torch.runtime.store import (
            DeviceBucketStore,
            InProcessBucketStore,
        )

        if args.backend == "inprocess":
            store: BucketStore = InProcessBucketStore()
        else:
            store = DeviceBucketStore(n_slots=args.slots, device=args.device)
        if args.snapshot_path:
            import os

            if os.path.exists(args.snapshot_path):
                try:
                    # Chain-aware: applies any .delta.* files beside the
                    # base (exactly load_snapshot when there are none).
                    deltas = checkpoint.load_snapshot_chain(
                        store, args.snapshot_path)
                except checkpoint.SnapshotCorruptError as exc:
                    # Init-on-miss: a torn snapshot or a broken chain
                    # (SnapshotChainError) must not keep the store down —
                    # serve fresh (state self-heals) and say so.
                    print(f"WARNING: ignoring corrupt snapshot: {exc}\n"
                          "starting with empty state (init-on-miss)",
                          flush=True)
                else:
                    print(f"restored snapshot from {args.snapshot_path}"
                          + (f" (+{deltas} deltas)" if deltas else ""),
                          flush=True)
        if args.sweep_period > 0 and hasattr(store, "start_sweeper"):
            store.start_sweeper(args.sweep_period)
        server = BucketStoreServer(
            store, host=args.host, port=args.port,
            snapshot_path=args.snapshot_path, auth_token=args.auth_token,
            tracing_config={
                "enabled": True,
                "sample_rate": args.trace_sample,
                "latency_threshold_s": args.trace_latency_ms / 1e3,
                "max_traces": args.trace_buffer,
            } if args.trace else None,
            snapshot_incremental=args.snapshot_incremental)
        host, port = await server.start()
        print(f"bucket-store server listening on {host}:{port}", flush=True)
        term = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, term.set)
        try:
            await term.wait()
            print("SIGTERM: shutting down", flush=True)
            await server.aclose()
            if args.snapshot_path:
                # A planned restart keeps its state: the final checkpoint
                # is what the next process restores.
                await server._save()
                print(f"final checkpoint written to {args.snapshot_path}",
                      flush=True)
        finally:
            await server.aclose()  # a no-op after the close above
            await store.aclose()
        print("shutdown complete", flush=True)

    asyncio.run(serve())


if __name__ == "__main__":
    main()
