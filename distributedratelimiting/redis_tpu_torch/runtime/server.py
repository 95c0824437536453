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

Served: ``OP_ACQUIRE``, ``OP_ACQUIRE_MANY`` (bucket kind; keys resolve
straight from the frame's bytes through ``wire.KeyBlob``), ``OP_PEEK``,
``OP_SYNC``, ``OP_PING``, ``OP_SAVE``, ``OP_STATS`` and the ``OP_HELLO``
auth handshake, with the trace, deadline and attempt tails (deadline-expired
work is shed unexecuted). An op the JAX server serves but this one does not
yet (windows, semaphores, hierarchical, reservations, placement, live
config, federation, metrics, traces, audit) answers a routable error that
names it as not served — never the "unknown op" / "unknown bulk kind" text,
which a JAX client reads as an old peer and silently falls back from.

Run it with ``python -m distributedratelimiting.redis_tpu_torch.runtime.server``
(on ``cuda`` unless ``--device cpu`` is given).
"""

from __future__ import annotations

import asyncio
import hmac
import time

from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils import log, tracing
from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LatencyHistogram,
)

__all__ = ["BucketStoreServer", "main"]

#: Ops the JAX server serves that this one does not yet. Each answers a
#: routable error that never reads as "unknown op" (see the module doc).
_UNPORTED_OPS = frozenset((
    wire.OP_WINDOW, wire.OP_SEMA, wire.OP_FWINDOW, wire.OP_METRICS,
    wire.OP_TRACES, wire.OP_PLACEMENT, wire.OP_PLACEMENT_ANNOUNCE,
    wire.OP_MIGRATE_PULL, wire.OP_MIGRATE_PUSH, wire.OP_CONFIG,
    wire.OP_ACQUIRE_H, wire.OP_RESERVE, wire.OP_SETTLE, wire.OP_FED_LEASE,
    wire.OP_FED_RENEW, wire.OP_FED_RECLAIM, wire.OP_AUDIT))
_UNPORTED_BULK_KINDS = {wire.BULK_KIND_WINDOW: "window",
                        wire.BULK_KIND_FWINDOW: "fixed window",
                        wire.BULK_KIND_HBUCKET: "hierarchical bucket"}


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
                 tracing_config: "bool | dict | None" = None) -> None:
        self.store = store
        self.host = host
        self.port = port
        # Server-configured checkpoint destination for OP_SAVE (≙ Redis
        # BGSAVE writing its configured dump file — clients never supply
        # paths, so the wire cannot be used to write arbitrary files).
        self.snapshot_path = snapshot_path
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
                if kind != wire.BULK_KIND_BUCKET:
                    return wire.encode_response(
                        seq, wire.RESP_ERROR, _not_served(
                            f"bulk kind {kind} "
                            f"({_UNPORTED_BULK_KINDS[kind]})"))
                res = await self.store.acquire_many(
                    keys, counts, a, b, with_remaining=with_rem)
                return wire.encode_bulk_response(seq, res.granted,
                                                 res.remaining)
            if len(body) >= 6 and body[5] == wire.OP_ACQUIRE_H:
                # Strict decode first (a malformed frame answers its
                # routable decode error), then the not-served answer.
                seq = wire.decode_hierarchical_request(body)[0]
                return wire.encode_response(
                    seq, wire.RESP_ERROR,
                    _not_served(wire.op_name(wire.OP_ACQUIRE_H)))
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

    async def _save(self) -> None:
        """Checkpoint the store to the configured path off-loop.
        Concurrent SAVEs piggyback on the one in flight (BGSAVE semantics)
        instead of queueing redundant full-state pulls."""
        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )

        if self._save_task is None or self._save_task.done():
            self._save_task = asyncio.ensure_future(asyncio.to_thread(
                checkpoint.save_snapshot, self.store, self.snapshot_path))
        await asyncio.shield(self._save_task)

    def _stats_json(self) -> str:
        """OP_STATS body: the JAX server's asyncio-path keys."""
        import json

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
        if self.retry_attempts_seen:
            payload["retry"] = {"attempts_seen": self.retry_attempts_seen}
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
    ``--snapshot-path`` is set) and the process exits 0."""
    import argparse

    parser = argparse.ArgumentParser(description="GPU bucket-store server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6380)
    parser.add_argument("--slots", type=int, default=2**17,
                        help="slots per bucket table")
    parser.add_argument("--device", default="cuda",
                        help="device of the store's tables: cuda (default; "
                        "the hand-written kernels) or cpu (their plain "
                        "PyTorch versions)")
    parser.add_argument("--snapshot-path", default=None,
                        help="checkpoint file for OP_SAVE (≙ Redis BGSAVE "
                        "dump path); if it exists at startup the store "
                        "restores from it, and SIGTERM writes a final one")
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

    async def serve() -> None:
        import signal

        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )
        from distributedratelimiting.redis_tpu_torch.runtime.store import (
            DeviceBucketStore,
        )

        store = DeviceBucketStore(n_slots=args.slots, device=args.device)
        if args.snapshot_path:
            import os

            if os.path.exists(args.snapshot_path):
                try:
                    checkpoint.load_snapshot(store, args.snapshot_path)
                except checkpoint.SnapshotCorruptError as exc:
                    # Init-on-miss: a torn snapshot must not keep the store
                    # down — serve fresh (state self-heals) and say so.
                    print(f"WARNING: ignoring corrupt snapshot: {exc}\n"
                          "starting with empty state (init-on-miss)",
                          flush=True)
                else:
                    print(f"restored snapshot from {args.snapshot_path}",
                          flush=True)
        if args.sweep_period > 0:
            store.start_sweeper(args.sweep_period)
        server = BucketStoreServer(
            store, host=args.host, port=args.port,
            snapshot_path=args.snapshot_path, auth_token=args.auth_token,
            tracing_config={
                "enabled": True,
                "sample_rate": args.trace_sample,
                "latency_threshold_s": args.trace_latency_ms / 1e3,
                "max_traces": args.trace_buffer,
            } if args.trace else None)
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
