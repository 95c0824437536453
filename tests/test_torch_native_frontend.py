"""The port's native serving front-end (``native/frontend.cc`` through
``redis_tpu_torch/runtime/native_frontend.py``) on the CPU.

The JAX package's ``tests/test_native_frontend.py`` cases that need only
ported state, each on the port's serial store and on its card store run on
the CPU (``DeviceBucketStore(device="cpu")``, the kernels' plain versions),
through the unmodified port client, the live-config gate on the batch
lane included (a retired config's rows answer "config moved" byte for
byte as the port's asyncio lane and the JAX package's native lane do),
and the port's cluster over native servers. Added: the loader's
content-hashed build, a failed build raising, the modules importing with
no JAX, the two packages' library copies keeping separate state, knobs and
CLI checks, and a seeded differential against the JAX package's native
server on one ManualClock schedule, reply bytes and every key's peek
compared exactly (tier-0 off). Every wait is a condition under a deadline.
"""

from __future__ import annotations

import asyncio
import json
import os
import pathlib
import struct
import subprocess
import sys
import time

import numpy as np
import pytest

from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.clock import ManualClock
from distributedratelimiting.redis_tpu_torch.runtime.remote import (
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime.server import (
    BucketStoreServer,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    DeviceBucketStore,
    InProcessBucketStore,
)
from distributedratelimiting.redis_tpu_torch.utils import native

ROOT = pathlib.Path(__file__).resolve().parents[1]
BACKINGS = ("inprocess", "device")
#: Each test's deadline, seconds.
DEADLINE_S = 60.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def _store(backing: str, clock=None):
    if backing == "inprocess":
        return InProcessBucketStore(clock=clock)
    return DeviceBucketStore(device="cpu", n_slots=1 << 12,
                             counter_slots=256, clock=clock)


async def _with_server(fn, backing="inprocess", **server_kw):
    store = _store(backing)
    try:
        async with BucketStoreServer(store, native_frontend=True,
                                     **server_kw) as srv:
            await fn(srv)
    finally:
        await store.aclose()


def _client(srv, **kw) -> RemoteBucketStore:
    kw.setdefault("coalesce_requests", False)
    return RemoteBucketStore(address=(srv.host, srv.port), **kw)


async def until(pred, timeout_s: float = 10.0, every_s: float = 0.01):
    """Wait for ``pred()`` (sync or async) to hold, under a deadline."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if asyncio.iscoroutine(got):
            got = await got
        if got:
            return got
        if time.monotonic() > deadline:
            raise AssertionError("condition not reached before the deadline")
        await asyncio.sleep(every_s)


# -- the per-request lane ---------------------------------------------------

@pytest.mark.parametrize("backing", BACKINGS)
def test_per_request_acquire_and_refill_semantics(backing):
    async def body(srv):
        store = _client(srv)
        try:
            r = await store.acquire("k", 4, 10.0, 1.0)
            assert r.granted and r.remaining == pytest.approx(6.0, abs=1e-2)
            assert not (await store.acquire("k", 7, 10.0, 1.0)).granted
            assert (await store.acquire("k", 6, 10.0, 1.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_window_ops_route_by_op_byte(backing):
    async def body(srv):
        store = _client(srv)
        try:
            w = await store.window_acquire("w", 2, 5.0, 60.0)
            assert w.granted and w.remaining == pytest.approx(3.0)
            assert (await store.fixed_window_acquire("f", 5, 5.0,
                                                     60.0)).granted
            assert not (await store.fixed_window_acquire("f", 1, 5.0,
                                                         60.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_concurrent_burst_batches_with_exact_grants(backing):
    """64 concurrent acquires on one 40-token bucket: the C batcher
    coalesces them and exactly 40 grant."""
    async def body(srv):
        store = _client(srv)
        try:
            res = await asyncio.gather(
                *(store.acquire("hot", 1, 40.0, 1e-9) for _ in range(64)))
            assert sum(r.granted for r in res) == 40
            st = await store.stats()
            assert st["native_frontend"] is True
            assert 1 <= st["batches_flushed"] <= 64 + st["requests_served"]
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_mixed_configs_one_batch(backing):
    async def body(srv):
        store = _client(srv)
        try:
            small = [store.acquire(f"s{i}", 1, 1.0, 1e-9) for i in range(8)]
            big = [store.acquire("b", 1, 100.0, 1e-9) for _ in range(8)]
            res = await asyncio.gather(*small, *big)
            assert all(r.granted for r in res)
            assert not (await store.acquire("s0", 1, 1.0, 1e-9)).granted
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_bulk_lane_and_stats(backing):
    async def body(srv):
        store = _client(srv, coalesce_requests=True)
        try:
            keys = [f"u{i % 10}" for i in range(1000)]
            res = await store.acquire_many(keys, [1] * 1000, 30.0, 1e-9)
            assert int(res.granted.sum()) == 10 * 30
            st = await store.stats()
            assert st["requests_served"] >= 1
            assert st["native_bulk"]["rows"] == 1000
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_ping_and_peek_and_sync_passthrough(backing):
    async def body(srv):
        store = _client(srv)
        try:
            await store.ping()
            await store.acquire("p", 3, 10.0, 1.0)
            # peek blocks its caller; the server shares this loop.
            avail = await asyncio.to_thread(store.peek_blocking, "p", 10.0,
                                            1.0)
            assert avail == pytest.approx(7.0, abs=1e-2)
            res = await store.sync_counter("c", 5.0, 1.0)
            assert res.global_score == pytest.approx(5.0)
        finally:
            await store.aclose()

    run(_with_server(body, backing))


def test_auth_required_flow():
    async def ok(srv):
        store = _client(srv, auth_token="sekrit")
        try:
            assert (await store.acquire("k", 1, 10.0, 1.0)).granted
        finally:
            await store.aclose()

    async def bad(srv):
        store = _client(srv, auth_token="wrong")
        try:
            with pytest.raises(wire.RemoteStoreError):
                await store.acquire("k", 1, 10.0, 1.0)
        finally:
            await store.aclose()

    async def unauthed(srv):
        store = _client(srv, request_timeout_s=2.0)
        try:
            with pytest.raises((wire.RemoteStoreError, TimeoutError,
                                ConnectionError)):
                await store.acquire("k", 1, 10.0, 1.0)
        finally:
            await store.aclose()

    for fn in (ok, bad, unauthed):
        run(_with_server(fn, auth_token="sekrit"))


@pytest.mark.parametrize("backing", BACKINGS)
def test_concurrency_semaphore_batched_natively(backing):
    async def body(srv):
        store = _client(srv)
        try:
            res = await asyncio.gather(
                *(store.concurrency_acquire("gpu", 1, 10)
                  for _ in range(30)))
            assert sum(r.granted for r in res) == 10
            await asyncio.gather(
                *(store.concurrency_release("gpu", 1) for _ in range(4)))
            r = await store.concurrency_acquire("gpu", 4, 10)
            assert r.granted and r.remaining == pytest.approx(10.0)
            assert not (await store.concurrency_acquire("gpu", 1,
                                                        10)).granted
        finally:
            await store.aclose()

    run(_with_server(body, backing))


def test_hello_pipelined_with_request_in_one_segment():
    async def body(srv):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(wire.encode_request(1, wire.OP_HELLO, "sekrit")
                     + wire.encode_request(2, wire.OP_ACQUIRE, "k", 1, 10.0,
                                           1.0))
        await writer.drain()
        by_seq = {}
        for _ in range(2):
            seq, kind, vals = wire.decode_response(
                await asyncio.wait_for(wire.read_frame(reader), 10))
            by_seq[seq] = (kind, vals)
        assert by_seq[1][0] == wire.RESP_EMPTY
        assert by_seq[2][0] == wire.RESP_DECISION and by_seq[2][1][0] is True
        writer.close()

    run(_with_server(body, auth_token="sekrit"))


def test_loadgen_terminates_against_auth_server():
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        native_loadgen,
    )

    async def body(srv):
        replies, granted, _el = await asyncio.wait_for(
            asyncio.to_thread(native_loadgen, srv.host, srv.port, conns=2,
                              depth=4, reqs_per_conn=100), 30)
        assert granted == 0 and replies < 200

    run(_with_server(body, auth_token="sekrit"))


def test_malformed_frames_get_error_reply_then_close():
    async def body(srv):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        bad = bytes([9]) + struct.pack("<I", 7) + bytes([wire.OP_PING])
        writer.write(struct.pack("<I", len(bad)) + bad)
        await writer.drain()
        _, kind, vals = wire.decode_response(await wire.read_frame(reader))
        assert kind == wire.RESP_ERROR and "version" in vals[0]
        assert await reader.read(1) == b""
        writer.close()
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(struct.pack("<I", wire.MAX_FRAME + 1))
        await writer.drain()
        _, kind, _vals = wire.decode_response(await wire.read_frame(reader))
        assert kind == wire.RESP_ERROR
        writer.close()

    run(_with_server(body))


@pytest.mark.parametrize("backing", BACKINGS)
def test_zero_count_probe(backing):
    async def body(srv):
        store = _client(srv)
        try:
            assert (await store.acquire("z", 0, 5.0, 1.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body, backing))


def test_latency_histogram_and_reset():
    async def body(srv):
        store = _client(srv)
        try:
            for i in range(50):
                await store.acquire(f"h{i}", 1, 10.0, 1.0)
            st = await store.stats(reset=True)
            assert st["serving_samples"] >= 50 and st["serving_p99_ms"] > 0
            assert set(st["stages"]) >= {"native_queue", "native_exec"}
            assert (await store.stats())["serving_samples"] < 50
        finally:
            await store.aclose()

    run(_with_server(body))


@pytest.mark.parametrize("backing", BACKINGS)
def test_native_loadgen_smoke(backing):
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        native_loadgen,
    )

    async def body(srv):
        replies, granted, elapsed = await asyncio.to_thread(
            native_loadgen, srv.host, srv.port, conns=2, depth=8,
            reqs_per_conn=500)
        assert replies == granted == 1000 and elapsed > 0

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_chained_bulk_chunks_keep_order(backing, monkeypatch):
    """A chunked acquire_many whose duplicate keys span chunk boundaries
    decides in request order."""
    monkeypatch.setattr(wire, "BULK_CHUNK_BUDGET", 4096)

    async def body(srv):
        store = _client(srv, coalesce_requests=True)
        try:
            keys = [f"dup{i % 3}" for i in range(2000)]
            res = await store.acquire_many(keys, [1] * 2000, 100.0, 1e-9)
            g = np.asarray(res.granted)
            assert int(g.sum()) == 300
            for m in range(3):
                idx = np.arange(2000) % 3 == m
                assert g[idx][:100].all() and not g[idx][100:].any()
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_invalid_utf8_key_does_not_wedge_the_pump(backing):
    async def body(srv):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        bad_key = b"k\x80\xffbad"
        payload = (struct.pack("<H", len(bad_key)) + bad_key
                   + struct.pack("<idd", 1, 10.0, 1.0))
        body_bytes = (bytes([wire.PROTOCOL_VERSION]) + struct.pack("<I", 5)
                      + bytes([wire.OP_ACQUIRE]) + payload)
        writer.write(struct.pack("<I", len(body_bytes)) + body_bytes)
        await writer.drain()
        seq, kind, vals = wire.decode_response(
            await asyncio.wait_for(wire.read_frame(reader), 10))
        assert seq == 5 and kind == wire.RESP_DECISION and vals[0] is True
        writer.close()
        store = _client(srv)
        try:
            assert (await store.acquire("fine", 1, 10.0, 1.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body, backing))


def test_shutdown_with_inflight_batch_is_clean():
    """aclose while a batch's store call is in flight drains the task
    before freeing the C handle (the use-after-free guard)."""
    started = asyncio.Event

    class SlowStore(InProcessBucketStore):
        entered = None

        async def acquire_many(self, *a, **kw):
            self.entered.set()
            await asyncio.sleep(0.3)
            return await super().acquire_many(*a, **kw)

    async def body():
        backing = SlowStore()
        backing.entered = started()
        srv = BucketStoreServer(backing, native_frontend=True)
        await srv.start()
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(wire.encode_request(1, wire.OP_ACQUIRE, "k", 1, 10.0,
                                         1.0))
        await writer.drain()
        await asyncio.wait_for(backing.entered.wait(), 10)
        await srv.aclose()  # drains the batch, then frees
        assert srv._native is None
        writer.close()

    run(body())


def test_hostname_resolves_for_native_listener():
    async def body():
        srv = BucketStoreServer(InProcessBucketStore(), host="localhost",
                                native_frontend=True)
        await srv.start()
        try:
            store = RemoteBucketStore(address=("127.0.0.1", srv.port),
                                      coalesce_requests=False)
            try:
                assert (await store.acquire("k", 1, 10.0, 1.0)).granted
            finally:
                await store.aclose()
        finally:
            await srv.aclose()

    run(body())


def test_approximate_limiter_converges_through_native_frontend():
    """Two approximate limiters on separate clients share one decaying
    counter (OP_SYNC rides the passthrough lane) and converge."""
    from distributedratelimiting.redis_tpu_torch.models.approximate import (
        ApproximateTokenBucketRateLimiter,
    )
    from distributedratelimiting.redis_tpu_torch.models.options import (
        ApproximateTokenBucketOptions,
    )

    async def body(srv):
        stores = [_client(srv, coalesce_requests=True) for _ in range(2)]
        lims = [ApproximateTokenBucketRateLimiter(
            ApproximateTokenBucketOptions(token_limit=100,
                                          tokens_per_period=10,
                                          instance_name="global"), s)
            for s in stores]
        try:
            for lim in lims:
                for _ in range(30):
                    lim._try_lease(1)
            for lim in lims:
                await lim.refresh()
            assert sum(lim._global_score for lim in lims) >= 60
            assert all(lim.available_tokens < 100 - 30 for lim in lims)
        finally:
            for lim in lims:
                await lim.aclose()
            for s in stores:
                await s.aclose()

    run(_with_server(body))


def test_clean_shutdown_with_live_connection():
    async def body():
        srv = BucketStoreServer(InProcessBucketStore(), native_frontend=True)
        await srv.start()
        store = RemoteBucketStore(address=(srv.host, srv.port),
                                  coalesce_requests=False)
        assert (await store.acquire("k", 1, 10.0, 1.0)).granted
        await srv.aclose()  # the client still connected
        await store.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_pipelined_sema_acquire_release_keeps_order(backing):
    """An acquire → release pair of one key pipelined into one batch
    decides in arrival order (grouping them by config would leak the
    permit)."""
    async def body(srv):
        reader, writer = await asyncio.open_connection(srv.host, srv.port)
        writer.write(wire.encode_request(1, wire.OP_SEMA, "gpu", 1, 10.0, 0.0)
                     + wire.encode_request(2, wire.OP_SEMA, "gpu", -1, 0.0,
                                           0.0))
        await writer.drain()
        for _ in range(2):
            _seq, kind, vals = wire.decode_response(
                await asyncio.wait_for(wire.read_frame(reader), 10))
            assert kind == wire.RESP_DECISION and vals[0] is True
        writer.close()
        store = _client(srv)
        try:
            r = await store.concurrency_acquire("gpu", 0, 10)
            assert r.granted and r.remaining == pytest.approx(0.0)
        finally:
            await store.aclose()

    run(_with_server(body, backing))


def test_connection_churn_leaks_nothing():
    def count_fds() -> int:
        return len(os.listdir("/proc/self/fd"))

    async def body(srv):
        before = count_fds()
        for i in range(300):
            reader, writer = await asyncio.open_connection(srv.host,
                                                           srv.port)
            writer.write(wire.encode_request(1, wire.OP_ACQUIRE, f"churn{i}",
                                             1, 10.0, 1.0))
            await writer.drain()
            assert await asyncio.wait_for(wire.read_frame(reader), 10)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass
        await until(lambda: count_fds() <= before + 8)
        store = _client(srv)
        try:
            st = await store.stats()
            assert st["connections_served"] >= 300
            assert (await store.acquire("post-churn", 1, 10.0, 1.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body))


@pytest.mark.parametrize("backing", BACKINGS)
def test_native_loadgen_op_sweep(backing):
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        native_loadgen,
    )

    async def body(srv):
        for op in ("acquire", "window", "fixed_window", "sema"):
            replies, granted, _el = await asyncio.to_thread(
                native_loadgen, srv.host, srv.port, conns=2, depth=8,
                reqs_per_conn=300, keyspace=50, capacity=1e9, fill_rate=1e5,
                op=op)
            assert replies == granted == 600, op

    run(_with_server(body, backing))


def test_loadgen_rejects_unknown_op():
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        native_loadgen,
    )

    with pytest.raises(ValueError, match="unknown loadgen op"):
        native_loadgen("127.0.0.1", 1, op="nope")


@pytest.mark.parametrize("backing", BACKINGS)
def test_cluster_over_native_servers(backing):
    """JAX ``test_cluster_over_native_servers`` on the port: a
    ``ClusterBucketStore`` sharding keys across two native-fronted servers
    — bulk split/merge rides the passthrough lane, per-key capacity is
    sticky to its owning node, and stats fan out per node."""
    from distributedratelimiting.redis_tpu_torch.runtime.cluster import (
        ClusterBucketStore,
    )

    async def body():
        servers = [BucketStoreServer(_store(backing), native_frontend=True)
                   for _ in range(2)]
        for s in servers:
            await s.start()
        cluster = ClusterBucketStore(
            addresses=[(s.host, s.port) for s in servers])
        try:
            keys = [f"ck{i}" for i in range(200)]
            res = await cluster.acquire_many(keys, [1] * 200, 3.0, 1e-9)
            assert res.granted.all()
            # Capacity is sticky per key regardless of which node owns it.
            res2 = await cluster.acquire_many(keys * 2, [2] * 400, 3.0,
                                              1e-9)
            g = np.asarray(res2.granted)
            assert int(g.sum()) == 200  # each key grants once more (1+2=3)
            st = await cluster.stats()
            assert len(st["nodes"]) == 2
            assert all(n.get("native_frontend") for n in st["nodes"])
            # Both nodes took a share of the keys.
            routes = cluster.placement.route(keys)
            assert set(routes.tolist()) == {0, 1}
        finally:
            await cluster.aclose()
            for s in servers:
                await s.aclose()
                await s.store.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_save_checkpoint_through_native_server(backing, tmp_path):
    """OP_SAVE rides the passthrough lane; a fresh store restores it."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint

    path = str(tmp_path / "native.ckpt")

    async def body():
        backing_store = _store(backing)
        srv = BucketStoreServer(backing_store, native_frontend=True,
                                snapshot_path=path)
        await srv.start()
        store = RemoteBucketStore(address=(srv.host, srv.port),
                                  coalesce_requests=False)
        try:
            await store.acquire("persist", 4, 10.0, 1e-9)
            await store.save()
        finally:
            await store.aclose()
            await srv.aclose()
            await backing_store.aclose()
        restored = _store(backing)
        checkpoint.load_snapshot(restored, path)
        assert not (await restored.acquire("persist", 7, 10.0,
                                           1e-9)).granted
        assert (await restored.acquire("persist", 6, 10.0, 1e-9)).granted
        await restored.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_federation_ops_ride_the_passthrough_lane(backing):
    """OP_FED_LEASE / RENEW / RECLAIM reach the home's ledger through the
    native front-end's passthrough lane: the replies equal those of an
    asyncio server over the same store kind, and the ledger's counters
    and the ``drl_federation_*`` families show the frames."""
    class Mono:
        t = 0.0

        def __call__(self):
            return self.t

    lease = {"region": "r0", "lease_id": "L1", "tenant": "g",
             "demand": 2.0, "global_cap": 600.0, "global_rate": 0.0}
    renew = {"region": "r0", "lease_id": "L1", "tenant": "g",
             "total": 25.0, "demand": 2.0}

    async def flow(native_frontend):
        store = _store(backing)
        mono = Mono()
        store.federation_ledger(clock=mono, default_ttl_s=6.0)
        srv = BucketStoreServer(store, native_frontend=native_frontend)
        await srv.start()
        cli = _client(srv)
        try:
            out = [await cli.fed_lease(lease), await cli.fed_lease(lease),
                   await cli.fed_renew(renew)]
            mono.t = 2.0
            out += [await cli.fed_renew(dict(renew, total=30.0)),
                    await cli.fed_reclaim(dict(renew, total=40.0)),
                    await cli.fed_reclaim(dict(renew, total=40.0)),
                    await cli.fed_renew(dict(renew, lease_id="L9"))]
            with pytest.raises(wire.RemoteStoreError, match="global_cap"):
                await cli.fed_lease(dict(lease, lease_id="L3",
                                         global_cap=0.0))
            text = await cli.metrics()
            return out, srv.federation.numeric_stats(), text
        finally:
            await cli.aclose()
            await srv.aclose()
            await store.aclose()

    async def body():
        return await flow(True), await flow(False)

    (got, stats, text), (want, want_stats, _) = run(body())
    assert got == want and stats == want_stats
    assert got[0]["granted"] and got[1]["duplicate"]
    assert [r["outcome"] for r in got[2:]] == [
        "ok", "ok", "reclaimed", "duplicate", "unknown"]
    assert stats["leases_granted"] == 1 and stats["renews"] == 2
    assert stats["charged_tokens"] == 40.0
    assert "drl_federation_reclaims_total 1" in text


def test_native_batching_knobs_configurable():
    """max_batch=1 forces one flush a request: the knob reaches C."""
    async def body():
        srv = BucketStoreServer(InProcessBucketStore(), native_frontend=True,
                                native_max_batch=1, native_deadline_us=50)
        await srv.start()
        store = RemoteBucketStore(address=(srv.host, srv.port),
                                  coalesce_requests=False)
        try:
            await asyncio.gather(*(store.acquire(f"knob{i}", 1, 10.0, 1.0)
                                   for i in range(20)))
            assert (await store.stats())["batches_flushed"] >= 20
        finally:
            await store.aclose()
            await srv.aclose()

    run(body())


@pytest.mark.parametrize("kw", [{"native_max_batch": 0},
                                {"native_deadline_us": 0},
                                {"native_shards": 0}])
def test_native_knobs_fail_fast(kw):
    with pytest.raises(ValueError):
        BucketStoreServer(InProcessBucketStore(), native_frontend=True, **kw)


def test_tier0_without_native_frontend_warns(caplog):
    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_tier0=True) as srv:
            assert srv._native is None
            store = _client(srv)
            try:
                assert (await store.acquire("k", 1, 10.0, 1.0)).granted
            finally:
                await store.aclose()

    with caplog.at_level("WARNING"):
        run(body())
    assert "tier-0 admission cache only exists inside" in caplog.text


# -- distributed tracing through the native lanes ----------------------------

from distributedratelimiting.redis_tpu_torch.utils import tracing  # noqa: E402


@pytest.fixture
def tracer():
    tr = tracing.configure(enabled=True, sample_rate=1.0, keep_rate=1.0,
                           latency_threshold_s=10.0)
    tr.reset()
    yield tr
    tracing.configure(enabled=False)
    tr.reset()


def test_traced_acquire_through_native_batch_lane(tracer):
    async def body(srv):
        store = _client(srv)
        try:
            assert not (await store.acquire("tracee", 50, 5.0, 1.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body))
    traces = [t for t in tracer.traces()
              if any(s["status"] == "denied" for s in t["spans"])]
    assert traces, tracer.traces()
    spans = traces[0]["spans"]
    fe = next(s for s in spans if s["name"] == "fe.batch")
    client = next(s for s in spans if s["name"] == "client.acquire")
    assert fe["parent_id"] == client["span_id"] and fe["status"] == "denied"


def test_traced_tier0_local_decision_still_traces(tracer):
    from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
        Tier0Config,
    )

    def t0_spans():
        return [s for t in tracer.traces() for s in t["spans"]
                if s["name"] == "fe.tier0"]

    async def body():
        async with BucketStoreServer(
                InProcessBucketStore(), native_frontend=True,
                native_tier0=Tier0Config(sync_interval_s=0.01,
                                         min_budget=8.0)) as srv:
            store = _client(srv)
            try:
                for _ in range(200):
                    assert (await store.acquire("hot", 1, 1000.0,
                                                1e-9)).granted
                assert (await store.stats())["tier0"]["hits"] >= 100
                await until(t0_spans)  # the sync pump's harvest rounds
            finally:
                await store.aclose()

    run(body())
    spans = t0_spans()
    assert all(s["attrs"]["local"] for s in spans)
    assert any(s["status"] == "ok" for s in spans)
    linked = 0
    for t in tracer.traces():
        ids = {s["span_id"] for s in t["spans"]}
        linked += sum(1 for s in t["spans"]
                      if s["name"] == "fe.tier0" and s["parent_id"] in ids)
    assert linked > 0


# -- the loader --------------------------------------------------------------

def test_library_builds_under_a_content_hash():
    """The front-end builds from native/frontend.cc into the port's own
    build/ directory under a hash of its source, never native/build/."""
    lib = native.load_frontend_lib()
    path = native.frontend_lib_path()
    assert path.parent == native.BUILD_DIR and path.exists()
    assert path.name.startswith("libfrontend-") and path.suffix == ".so"
    assert native.FRONTEND_SOURCE == ROOT / "native" / "frontend.cc"
    import hashlib

    h = hashlib.sha256(native.FRONTEND_SOURCE.read_bytes())
    h.update(b"")
    assert h.hexdigest()[:12] in path.name
    assert lib._name == str(path)
    assert native.load_frontend_lib() is lib  # loaded once


def test_failed_build_raises_and_native_frontend_does_not_fall_back(
        tmp_path, monkeypatch):
    """A front-end that cannot build makes load_frontend_lib raise with
    g++'s error, and a server asked for native_frontend=True raises
    instead of serving on asyncio. DRL_TPU_NO_NATIVE does not turn the
    front-end off either."""
    broken = tmp_path / "frontend.cc"
    broken.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "FRONTEND_SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ exited"):
        native.load_frontend_lib()

    async def body():
        srv = BucketStoreServer(InProcessBucketStore(), native_frontend=True)
        with pytest.raises(RuntimeError, match="frontend.cc"):
            await srv.start()
        assert srv._native is None and srv._server is None

    run(body())


def test_no_native_env_does_not_disable_the_frontend(monkeypatch):
    monkeypatch.setenv("DRL_TPU_NO_NATIVE", "1")

    async def body(srv):
        assert srv._native is not None
        store = _client(srv)
        try:
            assert (await store.acquire("k", 1, 10.0, 1.0)).granted
        finally:
            await store.aclose()

    run(_with_server(body))


def test_new_modules_import_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import distributedratelimiting.redis_tpu_torch.runtime."
            "native_frontend as nf\n"
            "import distributedratelimiting.redis_tpu_torch.runtime.server\n"
            "import distributedratelimiting.redis_tpu_torch.runtime.audit\n"
            "import distributedratelimiting.redis_tpu_torch.utils.native\n"
            "import distributedratelimiting.redis_tpu_torch.bench\n"
            "assert not any(m.startswith('distributedratelimiting."
            "redis_tpu.') for m in sys.modules)\n"
            "print(nf.uring_probe()[1] != '')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "True"


def test_two_packages_library_copies_keep_separate_state():
    """The JAX package's native/build/_frontend.so and the port's build
    load side by side (ctypes' RTLD_LOCAL): two servers in one process
    count their own requests."""
    from distributedratelimiting.redis_tpu.runtime.server import (
        BucketStoreServer as JaxServer,
    )
    from distributedratelimiting.redis_tpu.runtime.store import (
        InProcessBucketStore as JaxInProcess,
    )
    from distributedratelimiting.redis_tpu.utils.native import (
        load_frontend_lib as jax_load,
    )

    assert jax_load()._name != native.load_frontend_lib()._name

    async def body():
        async with JaxServer(JaxInProcess(), native_frontend=True) as js, \
                BucketStoreServer(InProcessBucketStore(),
                                  native_frontend=True) as ps:
            assert js._native is not None and ps._native is not None
            cp = _client(ps)
            try:
                for i in range(7):
                    assert (await cp.acquire(f"k{i}", 1, 10.0, 1.0)).granted
                assert ps._native.counts()[0] == 7
                assert js._native.counts()[0] == 0
            finally:
                await cp.aclose()

    run(body())


@pytest.mark.parametrize("argv,why", [
    (["--fe-tier0"], "--fe-tier0 requires --native-frontend"),
    (["--fe-shards", "2"], "--fe-shards requires --native-frontend"),
    (["--fe-uring", "on"], "--fe-uring requires --native-frontend"),
])
def test_cli_native_flags_require_native_frontend(argv, why, capsys):
    from distributedratelimiting.redis_tpu_torch.runtime.server import main

    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2
    assert why in capsys.readouterr().err


def test_cli_serves_natively_and_exits_on_sigterm():
    """``--native-frontend --fe-tier0 --fe-shards 2 --device cpu``: the
    console server serves over the C front-end and exits 0 on SIGTERM."""
    import signal

    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributedratelimiting.redis_tpu_torch.runtime.server",
         "--device", "cpu", "--port", "0", "--slots", "4096",
         "--native-frontend", "--fe-tier0", "--fe-shards", "2"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, proc.stderr.read()
        host, port = line.strip().rsplit(" ", 1)[1].rsplit(":", 1)

        async def body():
            store = RemoteBucketStore(address=(host, int(port)),
                                      coalesce_requests=False)
            try:
                assert (await store.acquire("k", 1, 10.0, 1.0)).granted
                st = await store.stats()
                assert st["native_frontend"] and st["fe_shards"] == 2
                assert "tier0" in st
            finally:
                await store.aclose()

        run(body())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# -- the differential against the JAX package's native server ----------------

def _frames(rng, n: int, windows: bool) -> list:
    """Seeded steps ``(frames, advance_ticks)``: ACQUIRE (probes too),
    FWINDOW, SEMA acquire then release on one key, PEEK, HELLO, PING,
    chained ACQUIRE_MANY chunks, WINDOW when ``windows``; a malformed bulk
    frame last. The bucket rate is dyadic per tick, so the card store's
    refill is exact on both packages."""
    steps = []
    seq = 1
    keys = [f"d{i}" for i in range(6)]
    kinds = 8 if windows else 7
    for _ in range(n):
        kind = int(rng.integers(0, kinds))
        key = keys[int(rng.integers(0, len(keys)))]
        tick = int(rng.integers(0, 3)) * 64
        if kind == 0:
            fr = [wire.encode_request(seq, wire.OP_ACQUIRE, key,
                                      int(rng.integers(0, 4)), 6.0, 4.0)]
        elif kind == 1:
            fr = [wire.encode_request(seq, wire.OP_FWINDOW, key,
                                      int(rng.integers(0, 3)), 5.0, 0.5)]
        elif kind == 2:
            fr = [wire.encode_request(seq, wire.OP_SEMA, "s" + key, 1, 3.0),
                  wire.encode_request(seq + 1, wire.OP_SEMA, "s" + key, -1,
                                      0.0)]
        elif kind == 3:
            fr = [wire.encode_request(seq, wire.OP_PEEK, key, 0, 6.0, 4.0)]
        elif kind == 4:
            fr = [wire.encode_request(seq, wire.OP_HELLO, "")]
        elif kind == 5:
            fr = [wire.encode_request(seq, wire.OP_PING)]
        elif kind == 6:
            ks = [keys[int(i)].encode() for i in rng.integers(0, 6, 10)]
            fr = [wire.encode_bulk_request(seq, ks[:5], np.ones(5), 6.0,
                                           4.0),
                  wire.encode_bulk_request(seq + 1, ks[5:], np.ones(5), 6.0,
                                           4.0, chained=True)]
        else:
            fr = [wire.encode_request(seq, wire.OP_WINDOW, key, 1, 4.0, 1.0)]
        seq += len(fr)
        steps.append((fr, tick))
    bad = wire.encode_bulk_request(seq, [b"d0", b"d1"], np.ones(2), 6.0,
                                   4.0)[4:-4]
    steps.append(([struct.pack("<I", len(bad)) + bad], 0))
    return steps


async def _replay(addr, steps, clock) -> list:
    reader, writer = await asyncio.open_connection(*addr)
    out = []
    try:
        for frames, tick in steps:
            clock.advance_ticks(tick)
            writer.write(b"".join(frames))
            await writer.drain()
            got = [await asyncio.wait_for(wire.read_frame(reader), 10)
                   for _ in frames]
            out.extend(sorted(got, key=lambda b: b[1:5]))
    finally:
        writer.close()
    return out


def _peeks(keys) -> list:
    return [wire.encode_request(10_000 + i, wire.OP_PEEK, k, 0, 6.0, 4.0)
            for i, k in enumerate(keys)]


@pytest.mark.parametrize("backing,seed,windows", [
    ("inprocess", 3, True), ("inprocess", 17, True),
    ("device", 3, False), ("device", 17, False)])
def test_native_servers_answer_like_the_jax_package(backing, seed,
                                                    windows):
    """The same seeded frames to a JAX native server (over the JAX
    package's store on the CPU) and to the port's native server (over the
    port's store, ``device="cpu"`` for the card store), each on its own
    ManualClock advanced in lockstep, tier-0 off: every reply byte and
    every key's peek equal. The card-store arm leaves out sliding windows
    (XLA on the CPU fuses their estimate into an FMA; the port rounds each
    operation — ROADMAP's divergences)."""
    from distributedratelimiting.redis_tpu.runtime import store as jstore
    from distributedratelimiting.redis_tpu.runtime.clock import (
        ManualClock as JaxClock,
    )
    from distributedratelimiting.redis_tpu.runtime.server import (
        BucketStoreServer as JaxServer,
    )

    async def body():
        jclock, pclock = JaxClock(1 << 20), ManualClock(1 << 20)
        if backing == "inprocess":
            js = jstore.InProcessBucketStore(clock=jclock)
        else:
            js = jstore.DeviceBucketStore(n_slots=1 << 12,
                                          counter_slots=256, max_batch=64,
                                          clock=jclock)
        ps = _store(backing, pclock)
        steps = _frames(np.random.default_rng(seed), 150, windows)
        steps.append((_peeks([f"d{i}" for i in range(6)]), 0))
        try:
            async with JaxServer(js, native_frontend=True) as jsrv, \
                    BucketStoreServer(ps, native_frontend=True) as psrv:
                want = await _replay((jsrv.host, jsrv.port), steps, jclock)
                got = await _replay((psrv.host, psrv.port), steps, pclock)
        finally:
            await js.aclose()
            await ps.aclose()
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a == b, (i, wire.decode_response(a),
                            wire.decode_response(b))

    run(body())


# -- the live-config gate on the batch lane ---------------------------------

@pytest.mark.parametrize("backing", BACKINGS)
def test_config_moved_gate_on_native_batch_lane(backing):
    """JAX ``test_native_frontend.py::test_config_moved_gate_on_native_batch_
    lane``: a per-request frame carrying a retired (kind, a, b) answers the
    routable "config moved" error from the C batch lane (``fe_send`` and
    the row-skip sentinel), the store untouched for that row; the client
    chases once and translates every later call (one moved error in all,
    bucket and window kinds alike), the balance carried exactly."""
    async def body(srv):
        store = _client(srv)
        try:
            for _ in range(30):
                await store.acquire("k", 1, 100.0, 0.0)
            await store.config_announce({"prepare": {
                "kind": "bucket", "old": [100.0, 0.0],
                "new": [50.0, 0.0]}, "version": 1})
            await store.config_announce({"commit": 1})
            r = await store.acquire("k", 0, 100.0, 0.0)
            assert r.remaining == 20.0  # 50 − 30 spent
            r = await store.acquire("k", 20, 100.0, 0.0)
            assert r.granted and r.remaining == 0.0
            assert not (await store.acquire("k", 1, 100.0, 0.0)).granted
            st = await store.stats()
            assert st["config"]["moved_errors"] == 1
            await store.window_acquire("w", 3, 10.0, 100.0)
            await store.config_announce({"prepare": {
                "kind": "window", "old": [10.0, 100.0],
                "new": [4.0, 100.0]}, "version": 2})
            await store.config_announce({"commit": 2})
            r = await store.window_acquire("w", 1, 10.0, 100.0)
            assert r.granted  # 3 of 4 replayed + 1 = at the limit
            assert not (await store.window_acquire("w", 1, 10.0,
                                                   100.0)).granted
            st = await store.stats()
            assert st["config"]["moved_errors"] == 2
            assert st["config"]["rebased_rows"] == 2
        finally:
            await store.aclose()

    run(_with_server(body, backing))


@pytest.mark.parametrize("backing", BACKINGS)
def test_config_moved_rows_byte_equal_to_the_jax_native_lane(backing):
    """The same pipelined per-request frames — rows of a retired bucket,
    window and fixed-window config mixed with current ones and SEMA rows —
    answer byte for byte alike from the port's native batch lane, its
    asyncio lane and the JAX package's native lane, after the same
    OP_CONFIG mutations on equal stores and lockstep clocks."""
    from distributedratelimiting.redis_tpu.runtime import store as jstore
    from distributedratelimiting.redis_tpu.runtime.clock import (
        ManualClock as JaxClock,
    )
    from distributedratelimiting.redis_tpu.runtime.server import (
        BucketStoreServer as JaxServer,
    )

    rules = [("bucket", [10.0, 1.0], [6.0, 1.0]),
             ("window", [20.0, 1.0], [12.0, 1.0]),
             ("fwindow", [20.0, 1.0], [9.0, 1.0])]
    rng = np.random.default_rng(7)
    setup, frames = [], []
    for i, op in enumerate((wire.OP_ACQUIRE, wire.OP_WINDOW,
                            wire.OP_FWINDOW)):
        for k in range(6):
            a = 10.0 if op == wire.OP_ACQUIRE else 20.0
            setup.append(wire.encode_request(10 + 6 * i + k, op, f"g{k}",
                                             int(rng.integers(1, 5)), a,
                                             1.0))
    for n, (kind, old, new) in enumerate(rules):
        setup.append(wire.encode_request(100 + n, wire.OP_CONFIG, json.dumps(
            {"prepare": {"kind": kind, "old": old, "new": new},
             "version": n + 1})))
        setup.append(wire.encode_request(200 + n, wire.OP_CONFIG, json.dumps(
            {"commit": n + 1})))
    combos = []
    for op, old, new in ((wire.OP_ACQUIRE, (10.0, 1.0), (6.0, 1.0)),
                         (wire.OP_WINDOW, (20.0, 1.0), (12.0, 1.0)),
                         (wire.OP_FWINDOW, (20.0, 1.0), (9.0, 1.0))):
        for k in range(6):
            combos += [(op, f"g{k}", old), (op, f"g{k}", new)]
    combos += [(wire.OP_SEMA, f"s{k}", (5.0, 0.0)) for k in range(4)]
    for n, i in enumerate(rng.permutation(len(combos)).tolist()):
        op, key, (a, b) = combos[i]
        frames.append(wire.encode_request(1000 + n, op, key,
                                          int(rng.integers(0, 3)), a, b))

    async def replay(addr):
        reader, writer = await asyncio.open_connection(*addr)
        try:
            out = {}
            for f in setup:  # one at a time: each answered before the next
                writer.write(f)
                await writer.drain()
                body = await asyncio.wait_for(wire.read_frame(reader), 10.0)
                out[int.from_bytes(body[1:5], "little")] = body
            for f in frames:
                writer.write(f)
            await writer.drain()
            for _ in frames:
                body = await asyncio.wait_for(wire.read_frame(reader), 10.0)
                out[int.from_bytes(body[1:5], "little")] = body
            return out
        finally:
            writer.close()

    async def body():
        js = (jstore.InProcessBucketStore(clock=JaxClock(1 << 20))
              if backing == "inprocess" else
              jstore.DeviceBucketStore(n_slots=1 << 12, counter_slots=256,
                                       max_batch=64,
                                       clock=JaxClock(1 << 20)))
        ps = [_store(backing, ManualClock(1 << 20)) for _ in range(2)]
        try:
            async with JaxServer(js, native_frontend=True) as jsrv, \
                    BucketStoreServer(ps[0], native_frontend=True) as nsrv, \
                    BucketStoreServer(ps[1]) as asrv:
                got = [await replay((s.host, s.port))
                       for s in (nsrv, asrv, jsrv)]
                stats = [s.liveconfig.stats() for s in (nsrv, asrv, jsrv)]
        finally:
            await js.aclose()
            for s in ps:
                await s.aclose()
        assert got[0] == got[1] == got[2]
        text = b"".join(got[0].values())
        assert text.count(b"config moved") == 18
        assert stats[0] == stats[1] == stats[2]
        assert stats[0]["moved_errors"] == 18

    run(body())
