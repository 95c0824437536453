"""The port's native bulk lane (``OP_ACQUIRE_MANY`` decided in C, the
residue in ``NativeFrontend._serve_bulk``) and the native-against-asyncio
parity fuzz, on the CPU.

The JAX package's ``tests/test_native_bulk.py`` cases (tier-0 bulk rows
decided locally and reconciled, the bulk epsilon, the C hot-key feed into
the sketch, the gauges in OpenMetrics, the passthrough fall-through, the
``native_bulk=False`` knob, windows and verdict-only frames) and
``tests/test_native_parity_fuzz.py``'s byte-level fuzz between the port's
native and asyncio servers over equal stores on lockstep ManualClocks (the
placement arm is in ``tests/test_torch_reshard.py``; the live-config arm,
a retired config's frame-level "config moved", is
``test_bulk_config_gated_rows_byte_identical`` here). The card store runs on the CPU
(``DeviceBucketStore(device="cpu")``).
"""

from __future__ import annotations

import asyncio
import json
import struct
import time

import numpy as np
import pytest

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
    overadmit_epsilon,
)
from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.clock import ManualClock
from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (
    Tier0Config,
)
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
from distributedratelimiting.redis_tpu_torch.utils.native import (
    load_frontend_lib,
)

BACKINGS = ("inprocess", "device")
DEADLINE_S = 60.0
_URING_OK = bool(load_frontend_lib().fe_uring_available())
_URING_SKIP = pytest.mark.skipif(
    not _URING_OK, reason="io_uring unavailable on this host (kernel or "
    "seccomp): the uring parity arm has no ring to run on")


def _uring_arm(*vals):
    return pytest.param(*vals, marks=_URING_SKIP)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def _store(backing: str, clock=None):
    if backing == "inprocess":
        return InProcessBucketStore(clock=clock)
    return DeviceBucketStore(device="cpu", n_slots=1 << 12,
                             counter_slots=256, max_batch=64, clock=clock)


async def until(pred, timeout_s: float = 10.0, every_s: float = 0.01):
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


async def _roundtrip_raw(host, port, frames: "list[bytes]") -> list[bytes]:
    reader, writer = await asyncio.open_connection(host, port)
    try:
        writer.write(b"".join(frames))
        await writer.drain()
        out = []
        for _ in frames:
            hdr = await asyncio.wait_for(reader.readexactly(4), 10.0)
            (ln,) = struct.unpack("<I", hdr)
            out.append(hdr + await asyncio.wait_for(reader.readexactly(ln),
                                                    10.0))
        return out
    finally:
        writer.close()


async def _serving(backing, **kw):
    store = _store(backing)
    srv = BucketStoreServer(store, native_frontend=True, **kw)
    await srv.start()
    return store, srv


@pytest.mark.parametrize("backing", BACKINGS)
def test_bulk_rows_decide_locally_and_reconcile(backing):
    """Hot bulk rows decide in C and the sync pump debits the store: the
    balance drops by the locally granted amount."""
    capacity, fill = 100000.0, 1e-9

    async def body():
        backing_store, srv = await _serving(
            backing, native_tier0=Tier0Config(sync_interval_s=0.01))
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            keys = [f"hot{i % 4}" for i in range(256)]
            for _ in range(5):
                res = await store.acquire_many(keys, [1] * 256, capacity,
                                               fill)
                assert res.granted.all()
            st = await store.stats()
            bulk = st["native_bulk"]
            assert bulk["frames"] == 5 and bulk["rows"] == 5 * 256
            assert bulk["rows_local"] > 0 and bulk["frames_local"] > 0
            assert bulk["permits_local"] == bulk["rows_local"]
            assert st["tier0"]["hits"] >= bulk["rows_local"] * 0.5

            async def reconciled():
                bal = await asyncio.to_thread(store.peek_blocking, "hot0",
                                              capacity, fill)
                return abs(bal - (capacity - 5 * 64)) <= 1.0

            await until(reconciled)
        finally:
            await store.aclose()
            await srv.aclose()
            await backing_store.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_bulk_tier0_overadmit_bounded(backing):
    """Per key, granted ≤ the device-only oracle + the scalar lane's
    epsilon (one envelope, not two)."""
    capacity, fill = 200.0, 1e-9
    cfg = Tier0Config(sync_interval_s=0.005)
    budget = headroom_budget(capacity, fraction=cfg.budget_fraction,
                             min_budget=cfg.min_budget,
                             max_budget=cfg.max_budget)
    assert budget > 0
    epsilon = overadmit_epsilon(budget, fill, cfg.sync_interval_s)
    n_keys, per_frame, frames = 4, 30, 20

    async def body():
        backing_store, srv = await _serving(backing, native_tier0=cfg)
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            keys = [f"h{i}" for i in range(n_keys)]
            frame_keys = [keys[i % n_keys]
                          for i in range(n_keys * per_frame)]
            counts = [1] * len(frame_keys)
            admitted = {k: 0 for k in keys}
            results = await asyncio.gather(
                *(store.acquire_many(frame_keys, counts, capacity, fill)
                  for _ in range(frames)))
            for res in results:
                for k, g in zip(frame_keys, res.granted):
                    admitted[k] += bool(g)
            for k in keys:
                assert admitted[k] <= capacity + epsilon
                assert admitted[k] >= capacity * 0.9
            for attempt in range(20):  # not vacuous
                if (await store.stats())["native_bulk"]["rows_local"]:
                    break
                fresh = [f"f{attempt}-{i % n_keys}"
                         for i in range(n_keys * per_frame)]
                for _ in range(3):
                    await store.acquire_many(fresh, counts, capacity, fill)
            assert (await store.stats())["native_bulk"]["rows_local"] > 0
        finally:
            await store.aclose()
            await srv.aclose()
            await backing_store.aclose()

    run(body())


def test_bulk_hot_keys_feed_the_sketch():
    """C aggregates each frame's top keys and the harvest task offers them
    to the server's heavy-hitter sketch."""
    async def body():
        backing_store, srv = await _serving("inprocess")
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            rng = np.random.default_rng(11)
            for _ in range(6):
                pool = ["whale-a", "whale-b"] * 40 + [
                    f"c{rng.integers(0, 5000)}" for _ in range(200)]
                await store.acquire_many(pool, [1] * len(pool), 1e9, 1e9)

            def surfaced():
                top = [k for k, _c, _e in srv.heavy_hitters.top()]
                return "whale-a" in top and "whale-b" in top

            await until(surfaced)
            assert (await store.stats())["native_bulk"]["frames"] >= 6
        finally:
            await store.aclose()
            await srv.aclose()

    run(body())


def test_bulk_gauges_in_openmetrics():
    async def body():
        backing_store, srv = await _serving("inprocess", native_tier0=True)
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            await store.acquire_many(["a", "b"], [1, 1], 10.0, 1.0)
            text = srv.registry.render()
            for family in ("drl_native_bulk_frames_total",
                           "drl_native_bulk_rows_residue_total",
                           "drl_tier0_hits_total", "drl_batches_flushed",
                           "drl_native_frontend 1"):
                assert family in text, family
        finally:
            await store.aclose()
            await srv.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_fall_through_cases_unchanged(backing):
    """SAVE without a snapshot path and an unknown op answer byte for byte
    as the asyncio server does: Python stays their authority."""
    async def body():
        stores = [_store(backing), _store(backing)]
        servers = [BucketStoreServer(stores[0]),
                   BucketStoreServer(stores[1], native_frontend=True)]
        for s in servers:
            await s.start()
        try:
            save = wire.encode_request(3, wire.OP_SAVE)
            unknown = bytearray(wire.encode_request(4, wire.OP_ACQUIRE, "k",
                                                    1, 1.0, 1.0))
            unknown[9] = 99
            replies = [await _roundtrip_raw(s.host, s.port,
                                            [save, bytes(unknown)])
                       for s in servers]
            assert replies[0] == replies[1]
            assert b"snapshot-path" in replies[0][0]
            assert b"unknown op" in replies[0][1]
        finally:
            for s in servers:
                await s.aclose()
            for st in stores:
                await st.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_no_fe_bulk_knob_keeps_passthrough(backing):
    async def body():
        backing_store, srv = await _serving(backing, native_bulk=False)
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            res = await store.acquire_many([f"u{i % 10}" for i in range(100)],
                                           [1] * 100, 30.0, 1e-9)
            assert int(res.granted.sum()) == 100
            assert "native_bulk" not in await store.stats()
        finally:
            await store.aclose()
            await srv.aclose()
            await backing_store.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_bulk_without_remaining_and_window_kinds(backing):
    async def body():
        backing_store, srv = await _serving(backing, native_tier0=True)
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            res = await store.acquire_many(["a", "b", "a"], [1, 1, 1], 1e6,
                                           1e6, with_remaining=False)
            assert res.granted.all() and res.remaining is None
            res = await store.window_acquire_many(
                [f"w{i % 3}" for i in range(30)], [1] * 30, 5.0, 60.0)
            assert int(res.granted.sum()) == 15
            assert (await store.stats())["native_bulk"]["frames"] == 2
        finally:
            await store.aclose()
            await srv.aclose()
            await backing_store.aclose()

    run(body())


def test_whole_residue_reaches_the_store_as_a_key_blob():
    """A frame with no tier-0 row reaches the store's acquire_many as a
    zero-copy KeyBlob; its counts are the lane's own copy, not the C
    job's memory."""
    seen = []

    class Spy(DeviceBucketStore):
        async def acquire_many(self, keys, counts, *a, **kw):
            seen.append((type(keys).__name__, counts.flags.owndata))
            return await super().acquire_many(keys, counts, *a, **kw)

    async def body():
        backing_store = Spy(device="cpu", n_slots=1 << 12, max_batch=64)
        srv = BucketStoreServer(backing_store, native_frontend=True)
        await srv.start()
        store = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            res = await store.acquire_many([f"z{i}" for i in range(500)],
                                           [1] * 500, 50.0, 1.0)
            assert res.granted.all()
            np.testing.assert_allclose(res.remaining, 49.0, atol=1e-2)
        finally:
            await store.aclose()
            await srv.aclose()
            await backing_store.aclose()

    run(body())
    assert seen and seen[0] == ("KeyBlob", True)


# -- the parity fuzz: the port's native lane against its asyncio lane --------

async def _start_pair(backing="inprocess", tier0=False, shards=1,
                      uring=None):
    clocks = [ManualClock(), ManualClock()]
    stores = [_store(backing, clocks[0]), _store(backing, clocks[1])]
    servers = [BucketStoreServer(stores[0]),
               BucketStoreServer(stores[1], native_frontend=True,
                                 native_tier0=tier0, native_shards=shards,
                                 native_uring=uring)]
    for s in servers:
        await s.start()
    if uring in ("on", "sqpoll"):
        assert servers[1]._native.uring_shards == servers[1]._native.n_shards
    conns = [await asyncio.open_connection(s.host, s.port) for s in servers]
    return clocks, stores, servers, conns


async def _close_pair(stores, servers, conns):
    for _r, w in conns:
        w.close()
    for s in servers:
        await s.aclose()
    for st in stores:
        await st.aclose()


async def _read_reply(conn) -> bytes:
    r, _w = conn
    hdr = await asyncio.wait_for(r.readexactly(4), 10.0)
    (ln,) = struct.unpack("<I", hdr)
    return hdr + await asyncio.wait_for(r.readexactly(ln), 10.0)


async def _roundtrip(conn, frame: bytes) -> bytes:
    conn[1].write(frame)
    await conn[1].drain()
    return await _read_reply(conn)


def _random_bulk_frame(rng, seq: int) -> bytes:
    """Random key blobs (duplicates and non-UTF-8 bytes), counts with
    probes and heavy rows, every kind, both remaining modes, a trace tail
    on some."""
    nk = int(rng.integers(1, 28))
    pool = [b"k%d" % rng.integers(0, 8) for _ in range(nk)]
    if rng.random() < 0.25:
        pool[0] = bytes(rng.integers(0, 256, int(rng.integers(1, 12)),
                                     dtype=np.uint8).tolist())
    counts = rng.integers(0, 4, nk)
    if rng.random() < 0.3:
        heavy = rng.integers(0, nk + 1)
        counts[:heavy] = rng.integers(1, 3000, heavy)
    trace = None
    if rng.random() < 0.3:
        trace = tuple(int(rng.integers(1, 1 << 62)) for _ in range(3)) + (1,)
    return wire.encode_bulk_request(
        seq, pool, counts, 10.0, 1.0, with_remaining=bool(rng.integers(0, 2)),
        kind=int(rng.integers(0, 3)), trace=trace)


def _truncated(rng, frame: bytes, most: int) -> bytes:
    cut = int(rng.integers(1, most))
    body = frame[4:]
    if len(body) > cut + 7:
        body = body[:-cut]
    return struct.pack("<I", len(body)) + body


@pytest.mark.parametrize("backing,seed,tier0,shards,uring", [
    ("inprocess", 5, False, 1, None), ("inprocess", 29, False, 1, None),
    ("inprocess", 5, True, 1, None), ("inprocess", 5, False, 4, None),
    ("inprocess", 29, True, 4, None), ("device", 5, False, 1, None),
    ("device", 29, True, 4, None),
    _uring_arm("inprocess", 5, False, 4, "on"),
    _uring_arm("inprocess", 29, True, 4, "on"),
    _uring_arm("device", 5, True, 1, "sqpoll")])
def test_bulk_frames_reply_byte_identical(backing, seed, tier0, shards,
                                          uring):
    """Randomized ACQUIRE_MANY frames — duplicates, probes, hostile keys,
    trace tails, every kind, chained pairs (a malformed head among them),
    malformed frames — answer byte for byte alike from the native bulk lane
    and the asyncio server. Tier-0 armed at capacity 10, below the
    confidence gate, stays invisible; any shard count, either transport."""
    async def main():
        clocks, stores, servers, conns = await _start_pair(
            backing, tier0=tier0, shards=shards, uring=uring)
        rng = np.random.default_rng(seed)
        try:
            for step in range(120):
                frame = _random_bulk_frame(rng, step)
                roll = rng.random()
                if roll < 0.1:
                    frame = _truncated(rng, frame, 8)
                    replies = [await _roundtrip(cn, frame) for cn in conns]
                    assert replies[0] == replies[1], step
                elif roll < 0.25:
                    if rng.random() < 0.3:
                        frame = _truncated(rng, frame, 6)
                    f2 = wire.encode_bulk_request(
                        10000 + step, [b"c0", b"c1", b"c0"], [1, 1, 1],
                        10.0, 1.0, chained=True)
                    for cn in conns:
                        cn[1].write(frame + f2)
                        await cn[1].drain()
                    r1 = [await _read_reply(cn) for cn in conns]
                    r2 = [await _read_reply(cn) for cn in conns]
                    assert r1[0] == r1[1] and r2[0] == r2[1], step
                else:
                    replies = [await _roundtrip(cn, frame) for cn in conns]
                    assert replies[0] == replies[1], step
                if rng.random() < 0.2:
                    dt = float(rng.uniform(0.0, 2.0))
                    for c in clocks:
                        c.advance_seconds(dt)
        finally:
            await _close_pair(stores, servers, conns)

    run(main())


@pytest.mark.parametrize("backing,uring", [
    ("inprocess", None), ("device", None), _uring_arm("inprocess", "on")])
def test_bulk_config_gated_rows_byte_identical(backing, uring):
    """The config half of JAX ``test_native_parity_fuzz.py::
    test_bulk_gated_rows_byte_identical``: after the same OP_CONFIG
    mutation on both servers (retire (50, 1) -> (80, 2), then a window
    rule), a bulk frame of a retired config answers the same frame-level
    "config moved" from both lanes (the native one through ``fe_send`` and
    ``fe_bulk_discard``) and current-config frames decide alike — on
    either transport."""
    async def main():
        _clocks, stores, servers, conns = await _start_pair(backing,
                                                            uring=uring)
        try:
            for seq, payload in ((900, {"prepare": {
                    "kind": "bucket", "old": [50.0, 1.0],
                    "new": [80.0, 2.0]}, "version": 1}),
                    (901, {"commit": 1}),
                    (902, {"prepare": {"kind": "window",
                                       "old": [20.0, 1.0],
                                       "new": [12.0, 1.0]}, "version": 2}),
                    (903, {"commit": 2})):
                frame = wire.encode_request(seq, wire.OP_CONFIG,
                                            key=json.dumps(payload))
                rs = [await _roundtrip(cn, frame) for cn in conns]
                assert rs[0] == rs[1]
            for seq, kind, a, b, moved in (
                    (7, wire.BULK_KIND_BUCKET, 50.0, 1.0, True),
                    (8, wire.BULK_KIND_BUCKET, 80.0, 2.0, False),
                    (9, wire.BULK_KIND_WINDOW, 20.0, 1.0, True),
                    (10, wire.BULK_KIND_FWINDOW, 20.0, 1.0, False),
                    (11, wire.BULK_KIND_WINDOW, 12.0, 1.0, False)):
                frame = wire.encode_bulk_request(
                    seq, [b"a", b"b", b"a"], [1, 2, 1], a, b, kind=kind)
                rs = [await _roundtrip(cn, frame) for cn in conns]
                assert rs[0] == rs[1], seq
                if moved:
                    assert b"config moved" in rs[0], rs[0]
                else:
                    assert rs[0][9] == wire.RESP_BULK, rs[0]
            stats = [s.liveconfig.stats() for s in servers]
            assert stats[0] == stats[1] and stats[0]["moved_errors"] == 2
        finally:
            await _close_pair(stores, servers, conns)

    run(main())


@pytest.mark.parametrize("backing,seed,tier0,shards,uring", [
    ("inprocess", 11, False, 1, None), ("inprocess", 23, False, 1, None),
    ("inprocess", 47, True, 1, None), ("inprocess", 23, False, 4, None),
    ("inprocess", 11, True, 4, None), ("device", 11, False, 1, None),
    ("device", 47, True, 4, None),
    _uring_arm("inprocess", 23, False, 4, "on"),
    _uring_arm("device", 11, True, 4, "on"),
    _uring_arm("inprocess", 47, False, 1, "sqpoll")])
def test_native_and_asyncio_servers_answer_identically(backing, seed, tier0,
                                                       shards, uring):
    """A seeded mix of every client op (buckets, windows, fixed windows,
    semaphores and releases, bulk, counter syncs, two-level acquires,
    pings) through two port clients, one per server, clocks in lockstep:
    the same grants and remainings, and the same request counts."""
    async def main():
        clocks, stores, servers, _conns = await _start_pair(
            backing, tier0=tier0, shards=shards, uring=uring)
        clients = [RemoteBucketStore(address=(s.host, s.port),
                                     coalesce_requests=False)
                   for s in servers]
        rng = np.random.default_rng(seed)
        try:
            for step in range(200):
                op = int(rng.integers(0, 9))
                key = f"k{rng.integers(0, 6)}"
                count = (int(rng.integers(0, 4)) if rng.random() < 0.7
                         else int(rng.integers(1, 10)))
                if op == 0:
                    rs = [await c.acquire(key, count, 10.0, 1.0)
                          for c in clients]
                elif op == 1:
                    rs = [await c.window_acquire(key, count, 8.0, 30.0)
                          for c in clients]
                elif op == 2:
                    rs = [await c.fixed_window_acquire(key, count, 8.0, 30.0)
                          for c in clients]
                elif op == 3:
                    rs = [await c.concurrency_acquire(key, count, 5)
                          for c in clients]
                elif op == 4:
                    for c in clients:
                        await c.concurrency_release(key, count + 1)
                    continue
                elif op == 5:
                    nk = int(rng.integers(1, 25))
                    keys = [f"k{rng.integers(0, 6)}" for _ in range(nk)]
                    counts = [int(x) for x in rng.integers(0, 4, nk)]
                    rs = [await c.acquire_many(keys, counts, 10.0, 1.0)
                          for c in clients]
                    assert (rs[0].granted == rs[1].granted).all(), step
                    np.testing.assert_array_equal(rs[0].remaining,
                                                  rs[1].remaining)
                    continue
                elif op == 6:
                    rs = [await c.sync_counter(key, float(count), 1.0)
                          for c in clients]
                    assert rs[0] == rs[1], step
                    continue
                elif op == 7:
                    tenant = f"t{rng.integers(0, 3)}"
                    rs = [await c.acquire_hierarchical(
                        tenant, key, count, 30.0, 1.0, 10.0, 1.0)
                        for c in clients]
                else:
                    for c in clients:
                        await c.ping()
                    dt = float(rng.uniform(0.0, 2.0))
                    for c in clocks:
                        c.advance_seconds(dt)
                    continue
                assert rs[0].granted == rs[1].granted, step
                assert rs[0].remaining == rs[1].remaining, step
            stats = [await c.stats() for c in clients]
            assert stats[0]["requests_served"] == stats[1]["requests_served"]
        finally:
            for c in clients:
                await c.aclose()
            await _close_pair(stores, servers, _conns)

    run(main())
