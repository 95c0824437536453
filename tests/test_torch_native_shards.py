"""The port's multi-shard native front-end and its io_uring transport, on
the CPU.

The JAX package's ``tests/test_native_shards.py`` and
``tests/test_native_uring.py`` cases that need only ported state: N shards
on one port with the merged gauges the sum of the per-shard rows, the
shard handle's bounds, the flat epsilon envelope with the tier-0 budget
split across shards (on epoll and on the ring), the bulk load generator's
own accounting; the io_uring probe, the kill switch, a seccomp-denied ring
falling back per shard with its reason, epoll by default, the ring engaged
and cheaper in syscalls, chained-chunk order under multishot recv's
rechunking, and the retired-config fan-out under bulk load (tier-0's
retire sweeps every shard's slice) on epoll and on the ring. The JAX
package's stale-binary fallbacks have no counterpart: the
port builds the library from the source it ships, so the whole ABI is
always there. Each case runs on the port's serial store, the ring cases
skip on a host whose kernel refuses io_uring.
"""

from __future__ import annotations

import asyncio
import json
import struct
import time

import pytest

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
    overadmit_epsilon,
)
from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (
    Tier0Config,
    native_bulk_loadgen,
    native_loadgen,
    uring_probe,
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

_LIB = load_frontend_lib()
DEADLINE_S = 60.0
_URING_OK = bool(_LIB.fe_uring_available())
needs_ring = pytest.mark.skipif(
    not _URING_OK, reason="io_uring unavailable on this host (kernel, "
    "seccomp or io_uring_disabled): the live-ring case has no ring")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


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


@pytest.mark.parametrize("backing", ["inprocess", "device"])
def test_multishard_serves_one_port_and_stats_merge(backing):
    """4 shards accept on ONE port, every request is answered, and the
    merged gauges are the sum of the per-shard rows."""
    async def body():
        st_ = (InProcessBucketStore() if backing == "inprocess" else
               DeviceBucketStore(device="cpu", n_slots=1 << 12))
        try:
            async with BucketStoreServer(st_, native_frontend=True,
                                         native_shards=4) as srv:
                assert srv._native.n_shards == 4
                replies, _g, _el = await asyncio.to_thread(
                    native_loadgen, srv.host, srv.port, conns=32, depth=8,
                    reqs_per_conn=100, keyspace=8)
                assert replies == 32 * 100
                store = RemoteBucketStore(address=(srv.host, srv.port))
                try:
                    res = await store.acquire_many(
                        [f"k{i % 8}" for i in range(64)], [1] * 64, 1e7, 1e7)
                    assert res.granted.all()
                    st = await store.stats()
                    assert st["fe_shards"] == 4
                    shards = st["shards"]
                    assert len(shards) == 4
                    for k in ("requests_served", "connections_served",
                              "batches_flushed"):
                        assert sum(s[k] for s in shards) == st[k], k
                    assert sum(s["native_bulk"]["rows"] for s in shards) == \
                        st["native_bulk"]["rows"]
                    assert sum(1 for s in shards
                               if s["connections_served"] > 0) >= 2
                    text = srv.registry.render()
                    assert "drl_native_fe_shards 4" in text
                finally:
                    await store.aclose()
        finally:
            await st_.aclose()

    run(body())


def test_shard_handle_bounds_and_single_shard_breakdown():
    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True,
                                     native_shards=1) as srv:
            h = srv._native._h
            assert _LIB.fe_shard_count(h) == 1
            assert _LIB.fe_shard(h, 0)
            assert not _LIB.fe_shard(h, 1) and not _LIB.fe_shard(h, -1)
            assert srv._native.shard_stats() is None
            store = RemoteBucketStore(address=(srv.host, srv.port))
            try:
                await store.acquire("a", 1, 10.0, 1.0)
                st = await store.stats()
                assert "shards" not in st and "fe_shards" not in st
            finally:
                await store.aclose()

    run(body())


@pytest.mark.parametrize("uring", [None, pytest.param("on", marks=needs_ring)])
def test_multishard_overadmit_bounded_by_flat_envelope(uring):
    """4 shards deciding from split budget shares keep each key's summed
    over-admission inside the SAME flat epsilon as one shard, on either
    transport."""
    capacity, fill = 400.0, 1e-9
    cfg = Tier0Config(sync_interval_s=0.005, min_budget=8.0)
    budget = headroom_budget(capacity, fraction=cfg.budget_fraction,
                             min_budget=cfg.min_budget,
                             max_budget=cfg.max_budget)
    assert budget / 4 >= cfg.min_budget
    epsilon = overadmit_epsilon(budget, fill, cfg.sync_interval_s)
    n_keys, per_frame, frames, n_conns = 4, 25, 8, 4

    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True, native_tier0=cfg,
                                     native_shards=4,
                                     native_uring=uring) as srv:
            if uring:
                assert srv._native.uring_shards == 4
            stores = [RemoteBucketStore(address=(srv.host, srv.port))
                      for _ in range(n_conns)]
            try:
                keys = [f"h{i}" for i in range(n_keys)]
                frame_keys = [keys[i % n_keys]
                              for i in range(n_keys * per_frame)]
                admitted = {k: 0 for k in keys}
                results = await asyncio.gather(
                    *(st.acquire_many(frame_keys, [1] * len(frame_keys),
                                      capacity, fill)
                      for st in stores for _ in range(frames)))
                for res in results:
                    for k, g in zip(frame_keys, res.granted):
                        admitted[k] += bool(g)
                for k in keys:
                    assert admitted[k] <= capacity + epsilon
                    assert admitted[k] >= capacity * 0.9
            finally:
                for st in stores:
                    await st.aclose()

    run(body())


def test_bulk_loadgen_counts_are_consistent():
    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True, native_tier0=True,
                                     native_shards=2) as srv:
            frames, rows, granted, el = await asyncio.to_thread(
                native_bulk_loadgen, srv.host, srv.port, conns=4, depth=2,
                frames_per_conn=25, rows_per_frame=512, keyspace=16)
            assert frames == 100 and rows == frames * 512
            assert granted == rows and el > 0
            store = RemoteBucketStore(address=(srv.host, srv.port))
            try:
                st = await store.stats()
                assert st["native_bulk"]["rows"] == rows
                t0 = st["tier0"]
                # The per-slice ε witness sums to the merged one.
                assert sum(s["tier0"]["grant_tokens"]
                           for s in st["shards"]) == t0["grant_tokens"]
                # Bulk rows only: every local grant is a bulk permit.
                assert t0["grant_tokens"] == st["native_bulk"][
                    "permits_local"] > 0
            finally:
                await store.aclose()

    run(body())



# -- live config: the retire fans out to every shard -------------------------

async def _retire_fans_out(store, uring) -> None:
    """JAX ``test_native_shards.py::test_retire_fans_out_to_every_shard``
    (and its io_uring twin): a live OP_CONFIG mutation under multi-shard
    bulk load. Once the sync pump retires the old config no shard may still
    answer old-config frames from a live replica — ``fe_t0_retire`` sweeps
    every shard's slice in one critical section."""
    old_cap, old_rate = 100000.0, 1e-9
    new_cap, new_rate = 120000.0, 2e-9
    cfg = Tier0Config(sync_interval_s=0.005, min_budget=8.0)
    ring = uring is not None
    async with BucketStoreServer(store, native_frontend=True,
                                 native_tier0=cfg, native_shards=4,
                                 native_uring=uring) as srv:
        if ring:
            assert srv._native.uring_shards == 4
        # Hot old-config bulk traffic over many connections, so replicas
        # install across several shards' slices.
        await asyncio.to_thread(
            native_bulk_loadgen, srv.host, srv.port, conns=16, depth=4,
            frames_per_conn=40, rows_per_frame=256, keyspace=8,
            capacity=old_cap, fill_rate=old_rate, uring=ring)
        client = RemoteBucketStore(address=(srv.host, srv.port))
        try:
            st = await client.stats()
            hosting = [s["shard"] for s in st["shards"]
                       if s["tier0"]["entries"] > 0]
            assert len(hosting) >= 2, hosting
            # Mutate while loadgen traffic is still in flight.
            load = asyncio.create_task(asyncio.to_thread(
                native_bulk_loadgen, srv.host, srv.port, conns=8, depth=2,
                frames_per_conn=40, rows_per_frame=256, keyspace=8,
                capacity=old_cap, fill_rate=old_rate, uring=ring))
            for payload in ({"prepare": {"kind": "bucket",
                                         "old": [old_cap, old_rate],
                                         "new": [new_cap, new_rate]},
                             "version": 1},
                            {"commit": 1}):
                frame = wire.encode_request(900, wire.OP_CONFIG,
                                            key=json.dumps(payload))
                reply = (await _roundtrip_raw(srv.host, srv.port,
                                              [frame]))[0]
                assert reply[9] != wire.RESP_ERROR, reply
            await load
            # The pump retires a config when it harvests a grant of it:
            # where the load ended before the commit, old-config frames
            # (served from the replicas' last-acked headroom, the tier-0
            # epsilon) give it one.
            m = srv._native.t0_metrics
            deadline = time.monotonic() + 10.0
            while m.retired_config_rows < 1:
                assert time.monotonic() < deadline, "the pump never retired"
                await _roundtrip_raw(srv.host, srv.port, [
                    wire.encode_bulk_request(6, [b"b0", b"b1"], [1, 1],
                                             old_cap, old_rate)])
                await asyncio.sleep(cfg.sync_interval_s)
            await asyncio.sleep(cfg.sync_interval_s * 10)
            # Every connection (each on a kernel-chosen shard) answers an
            # old-config frame with the routable moved error, and decides
            # a new-config frame normally.
            for _ in range(16):
                frame = wire.encode_bulk_request(
                    7, [b"b0", b"b1"], [1, 1], old_cap, old_rate)
                reply = (await _roundtrip_raw(srv.host, srv.port,
                                              [frame]))[0]
                assert reply[9] == wire.RESP_ERROR, reply
                assert b"config moved" in reply, reply
                frame = wire.encode_bulk_request(
                    8, [b"b0", b"b1"], [1, 1], new_cap, new_rate)
                reply = (await _roundtrip_raw(srv.host, srv.port,
                                              [frame]))[0]
                assert reply[9] == wire.RESP_BULK, reply
        finally:
            await client.aclose()


@pytest.mark.parametrize("backing", ["inprocess", "device"])
def test_retire_fans_out_to_every_shard(backing):
    store = (InProcessBucketStore() if backing == "inprocess"
             else DeviceBucketStore(device="cpu", n_slots=1 << 12))
    run(_retire_fans_out(store, None))


@needs_ring
def test_retire_fans_out_under_uring_bulk_load():
    """The io_uring twin: the retire sweep is transport-independent state,
    and the ring's queued sends must not reorder the terminal error/grant
    split."""
    run(_retire_fans_out(InProcessBucketStore(), "on"))


# -- the io_uring transport --------------------------------------------------

async def _serves_normally(srv, transport_visible: bool) -> dict:
    """Scalar and bulk traffic decide correctly; OP_STATS carries
    ``fe_transport`` exactly when io_uring was asked for."""
    store = RemoteBucketStore(address=(srv.host, srv.port))
    try:
        assert (await store.acquire("fb", 1, 10.0, 1.0)).granted
        many = await store.acquire_many([f"k{i % 4}" for i in range(16)],
                                        [1] * 16, 1e7, 1e7)
        assert many.granted.all()
        st = await store.stats()
        assert ("fe_transport" in st) == transport_visible, st.keys()
        return st
    finally:
        await store.aclose()


def test_probe_reports_availability_with_reason():
    ok, reason = uring_probe()
    assert isinstance(ok, bool) and reason
    if ok:
        assert "io_uring available" in reason


def test_kill_switch_forces_epoll(monkeypatch):
    monkeypatch.setenv("DRL_TPU_NO_URING", "1")

    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True, native_shards=2,
                                     native_uring="on") as srv:
            assert srv._native.uring_shards == 0
            ts = srv._native.transport_stats()
            assert ts["uring_shards"] == 0 and ts["fallbacks"] == 2
            assert all("DRL_TPU_NO_URING" in r
                       for r in ts["fallback_reasons"].values())
            st = await _serves_normally(srv, transport_visible=True)
            assert st["fe_transport"]["fallbacks"] == 2

    run(body())


def test_seccomp_denied_falls_back_per_shard(monkeypatch, caplog):
    """A ring denied with EPERM (the C side's simulated seccomp hook takes
    the same path as a kernel without the syscall) degrades every shard to
    epoll, each shard's reason logged and reported; the probe says so; the
    uring load generator falls back to its syscall client."""
    monkeypatch.delenv("DRL_TPU_NO_URING", raising=False)
    monkeypatch.setenv("DRL_TPU_URING_FAKE_DENY", "1")
    ok, reason = uring_probe()
    assert not ok and "EPERM" in reason and "seccomp" in reason

    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True, native_shards=2,
                                     native_uring="sqpoll") as srv:
            assert srv._native.uring_shards == 0
            assert set(srv._native.uring_reasons()) == {0, 1}
            ts = srv._native.transport_stats()
            assert ts["fallbacks"] == 2 and ts["mode"] == "uring+sqpoll"
            assert all("EPERM" in r for r in ts["fallback_reasons"].values())
            await _serves_normally(srv, transport_visible=True)
            f, r, _g, _el = await asyncio.to_thread(
                native_bulk_loadgen, srv.host, srv.port, conns=2, depth=2,
                frames_per_conn=10, rows_per_frame=32, keyspace=4,
                uring=True)
            assert f == 20 and r == 20 * 32

    with caplog.at_level("WARNING"):
        run(body())
    assert caplog.text.count("fell back to epoll") == 2


@pytest.mark.parametrize("spelling,mode", [
    (None, 0), ("off", 0), ("on", 1), ("uring", 1), ("sqpoll", 2), (2, 2),
    (True, 1), (False, 0)])
def test_uring_knob_spellings(spelling, mode, monkeypatch):
    from distributedratelimiting.redis_tpu_torch.runtime import (
        native_frontend,
    )

    monkeypatch.delenv("DRL_TPU_URING", raising=False)
    assert native_frontend._resolve_uring_mode(spelling) == mode


def test_uring_knob_rejects_unknown_spellings(monkeypatch):
    from distributedratelimiting.redis_tpu_torch.runtime import (
        native_frontend,
    )

    with pytest.raises(ValueError):
        native_frontend._resolve_uring_mode("fast")
    with pytest.raises(ValueError):
        native_frontend._resolve_uring_mode(7)
    monkeypatch.setenv("DRL_TPU_URING", "sqpoll")
    assert native_frontend._resolve_uring_mode(None) == 2


def test_epoll_default_untouched_by_uring_abi(monkeypatch):
    monkeypatch.delenv("DRL_TPU_URING", raising=False)

    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True,
                                     native_shards=2) as srv:
            assert srv._native.uring_shards == 0
            ts = srv._native.transport_stats()
            assert ts["mode"] == "epoll" and ts["uring_shards"] == 0
            await _serves_normally(srv, transport_visible=False)

    run(body())


@needs_ring
def test_uring_shards_actually_on_ring():
    """The ring engages: every shard on it, the ring counters move, and
    the data-plane syscalls fall below epoll's on the same load."""
    async def run_one(uring):
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True, native_tier0=True,
                                     native_shards=2,
                                     native_uring=uring) as srv:
            assert srv._native.uring_shards == (2 if uring else 0)
            f, r, g, _el = await asyncio.to_thread(
                native_bulk_loadgen, srv.host, srv.port, conns=32, depth=4,
                frames_per_conn=25, rows_per_frame=64, keyspace=8,
                uring=bool(uring))
            assert f == 800 and r == 800 * 64 and g == r
            return srv._native.transport_stats()

    async def body():
        epoll = await run_one(None)
        ring = await run_one("on")
        assert ring["uring_shards"] == 2 and ring["sqes_submitted"] > 0
        assert ring["cqes_seen"] >= 800
        assert epoll["enters"] == 0 and epoll["cqes_seen"] == 0
        assert ring["io_syscalls"] < epoll["io_syscalls"], (ring, epoll)

    run(body())


@needs_ring
def test_chained_chunk_order_under_multishot_recv():
    """Frames dribbled a few bytes at a time arrive as many recv CQEs; a
    chained successor still decides after its predecessor, a malformed
    predecessor's error first."""
    async def body():
        async with BucketStoreServer(InProcessBucketStore(),
                                     native_frontend=True, native_shards=1,
                                     native_uring="on") as srv:
            assert srv._native.uring_shards == 1
            reader, writer = await asyncio.open_connection(srv.host,
                                                           srv.port)
            try:
                async def dribble(blob: bytes, step: int):
                    for i in range(0, len(blob), step):
                        writer.write(blob[i:i + step])
                        await writer.drain()
                        await asyncio.sleep(0)

                async def read_reply() -> bytes:
                    hdr = await asyncio.wait_for(reader.readexactly(4), 10)
                    (ln,) = struct.unpack("<I", hdr)
                    return hdr + await asyncio.wait_for(
                        reader.readexactly(ln), 10)

                f1 = wire.encode_bulk_request(1, [b"a", b"b", b"a"],
                                              [1, 1, 1], 100.0, 1.0)
                f2 = wire.encode_bulk_request(2, [b"a", b"c"], [1, 1], 100.0,
                                              1.0, chained=True)
                await dribble(f1 + f2, 5)
                r1, r2 = await read_reply(), await read_reply()
                assert r1[5:9] == struct.pack("<I", 1)
                assert r1[9] == wire.RESP_BULK
                assert r2[5:9] == struct.pack("<I", 2)
                bad = f1[4:-3]
                bad = struct.pack("<I", len(bad)) + bad
                f3 = wire.encode_bulk_request(3, [b"d"], [1], 100.0, 1.0,
                                              chained=True)
                await dribble(bad + f3, 7)
                e1, e2 = await read_reply(), await read_reply()
                assert e1[9] == wire.RESP_ERROR
                assert e2[5:9] == struct.pack("<I", 3)
                assert e2[9] == wire.RESP_BULK
                frames = [wire.encode_bulk_request(100 + i,
                                                   [b"p%d" % (i % 3)], [1],
                                                   100.0, 1.0)
                          for i in range(32)]
                writer.write(b"".join(frames))
                await writer.drain()
                for i in range(32):
                    assert (await read_reply())[5:9] == struct.pack(
                        "<I", 100 + i), i
            finally:
                writer.close()

    run(body())
