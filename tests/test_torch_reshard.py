"""Placement and live migration over the wire: the port's server and client
against the JAX package's, on the CPU.

- **Pairings.** A port or JAX server behind a port or JAX client answers
  the four placement control ops (``OP_PLACEMENT``, ``OP_PLACEMENT_ANNOUNCE``,
  ``OP_MIGRATE_PULL``, ``OP_MIGRATE_PUSH``), the routable MOVED, the handoff
  envelope and deferral, ``OP_STATS``' ``placement`` section and the
  ``drl_placement_*`` families of ``OP_METRICS`` alike (placement clocks
  injected and frozen, so envelopes compare exactly).
- **A coordinator of either package.** JAX's or the port's
  ``ClusterBucketStore(addresses=...)`` coordinates three port servers,
  beside the same coordinator over three
  JAX servers, on one seeded trace: a join (``add_node``), a drain aborted
  by a fault on the servers' ``server.migrate`` seam and retried. Epochs,
  every key's balance and the admitted totals are equal.
- **The native lanes.** The placement half of JAX
  ``test_native_parity_fuzz.py::test_bulk_gated_rows_byte_identical``
  against a port native server, and the batch lane's MOVED, envelope and
  deferral rows, byte for byte against the asyncio lane's.
- **Reservations** (JAX ``tests/test_reservations.py:312``, ``:516``,
  ``:574``): holds exported with the pull, deferred mid-handoff, MOVED on
  the old owner and settled on the new; an abort brings them home.
"""

from __future__ import annotations

import asyncio
import json
import struct

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime import placement as jpl
from distributedratelimiting.redis_tpu.runtime import wire as jw
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.cluster import (
    ClusterBucketStore as JCluster,
)
from distributedratelimiting.redis_tpu.runtime.cluster import (
    PlacementError as JPlacementError,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JDevice,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JSerial,
)
from distributedratelimiting.redis_tpu.utils import faults as jfaults
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    ClusterBucketStore,
    DeviceBucketStore,
    InProcessBucketStore,
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
)
from distributedratelimiting.redis_tpu_torch.runtime import placement as ppl
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw
from distributedratelimiting.redis_tpu_torch.runtime.cluster import (
    PlacementError,
)
from distributedratelimiting.redis_tpu_torch.utils import faults as pfaults

torch.set_num_threads(1)

START = 1_000_000
LIMIT_S = 120
_FILL = 1e-9
_CHILD_CAP, _CHILD_RATE = 1e6, 1e-9


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _store(kind: str, backing: str, clock):
    if kind == "port":
        return (InProcessBucketStore(clock=clock) if backing == "serial"
                else DeviceBucketStore(device="cpu", clock=clock,
                                       n_slots=1024))
    return (JSerial(clock=clock) if backing == "serial"
            else JDevice(clock=clock, n_slots=1024))


def _server(kind: str, store, frozen, **kw):
    """A server of either package with its placement state on the frozen
    clock (envelopes refill nothing, windows never expire)."""
    if kind == "port":
        srv = BucketStoreServer(store, **kw)
        srv.placement = ppl.NodePlacementState(clock=frozen)
    else:
        srv = JServer(store, **kw)
        srv.placement = jpl.NodePlacementState(clock=frozen)
    return srv


def _client(kind: str, srv, **kw):
    cls = RemoteBucketStore if kind == "port" else JRemote
    return cls(address=(srv.host, srv.port), **kw)


# -- the four pairings ---------------------------------------------------------

async def _pairing(server_kind: str, client_kind: str, backing: str) -> list:
    clock = (ManualClock if server_kind == "port" else JClock)(START)
    store = _store(server_kind, backing, clock)
    srv = _server(server_kind, store, lambda: 50.0)
    await srv.start()
    cli = _client(client_kind, srv, coalesce_requests=False)
    m0 = ppl.PlacementMap.initial(2)
    keys = [f"k{i}" for i in range(64)]
    own = [k for k in keys if m0.node_of(k) == 0]
    other = [k for k in keys if m0.node_of(k) == 1]
    out = []

    async def outcome(coro):
        try:
            got = await coro
        except Exception as exc:  # noqa: BLE001
            return ("error", type(exc).__name__, str(exc))
        return ("ok", got)

    try:
        out.append(await cli.placement_fetch())
        out.append(await outcome(cli.migrate_pull({"target_epoch": 1})))
        out.append(await cli.placement_announce(
            {"map": m0.to_dict(), "node_id": 0}))
        res = await cli.acquire_many(own, [2] * len(own), 10.0, 1.0)
        out.append((res.granted.tolist(), res.remaining.tolist()))
        out.append(await outcome(cli.acquire_many(own[:3] + other[:1],
                                                  [1] * 4, 10.0, 1.0)))
        out.append(await outcome(cli.acquire(other[0], 1, 10.0, 1.0)))
        out.append(await outcome(cli.sync_counter(other[1], 1.0, 1.0)))
        await cli.sync_counter(own[0], 3.0, 1.0)
        await cli.window_acquire(own[1], 4, 20.0, 1.0)
        await cli.concurrency_acquire(own[2], 1, 3)
        parked = m0.slot_of(own[0])
        req = {"target_epoch": 1, "slots": [parked], "window_s": 30.0}
        pulled = await cli.migrate_pull(req)
        out.append(pulled)
        out.append(await cli.migrate_pull(req))  # the cached export
        out.append(await cli.placement_fetch())
        in_slot = [k for k in own if m0.slot_of(k) == parked]
        for k in in_slot:
            out.append(await outcome(cli.acquire(k, 3, 10.0, 1.0)))
            out.append(await outcome(cli.window_acquire(k, 2, 20.0, 1.0)))
            out.append(await outcome(cli.concurrency_acquire(k, 1, 3)))
        res = await cli.acquire_many(in_slot * 2 + own[:2],
                                     [1] * (2 * len(in_slot) + 2), 10.0,
                                     1.0)
        out.append((res.granted.tolist(), res.remaining.tolist()))
        push = {"target_epoch": 1, "batch": 3,
                "entries": {"buckets": [["incoming", 10.0, 1.0, 4.0, 0]]}}
        out.append(await cli.migrate_push(push))
        out.append(await cli.migrate_push(push))
        out.append(await outcome(cli.placement_announce(
            {"map": ppl.PlacementMap(0, [1, 0] * 2).to_dict(),
             "node_id": 0})))
        stats = await cli.stats()
        out.append(stats["placement"])
        text = await cli.metrics()
        out.append([line for line in text.splitlines()
                    if "drl_placement_" in line])
        out.append(await cli.placement_announce({"abort_epoch": 1}))
        out.append(await cli.placement_fetch())
        res = await cli.acquire_many(in_slot, [0] * len(in_slot), 10.0,
                                     1.0)
        out.append((res.granted.tolist(), res.remaining.tolist()))
        m1 = m0.with_assignments({parked: 1})
        out.append(await cli.placement_announce(
            {"map": m1.to_dict(), "node_id": 0}))
        out.append(await outcome(cli.acquire(in_slot[0], 1, 10.0, 1.0)))
        out.append((await cli.stats())["placement"])
    finally:
        await cli.aclose()
        await srv.aclose()
        await store.aclose()
    return out


@pytest.mark.parametrize("backing", ["serial", "device"])
def test_four_pairings_answer_alike(backing):
    results = {(s, c): run(_pairing(s, c, backing))
               for s in ("port", "jax") for c in ("port", "jax")}
    ref = results[("jax", "jax")]
    for pair, got in results.items():
        assert len(got) == len(ref), pair
        for i, (a, b) in enumerate(zip(got, ref)):
            assert a == b, (pair, i, a, b)
    text = json.dumps(ref, default=str)
    assert "placement moved" in text
    assert "placement handoff in progress" in text
    assert "drl_placement_moved_errors" in text
    assert ref[0]["epoch"] == -1


# -- a JAX coordinator over port servers ---------------------------------------

async def _cluster(kind: str, backing: str, seed: int,
                   coordinator: str = "jax") -> dict:
    rng = np.random.default_rng(seed)
    clock = (ManualClock if kind == "port" else JClock)(START)
    stores = [_store(kind, backing, clock) for _ in range(3)]
    servers = [_server(kind, s, lambda: 50.0) for s in stores]
    for s in servers:
        await s.start()
    addrs = [(s.host, s.port) for s in servers]
    Cluster, Error = ((JCluster, JPlacementError) if coordinator == "jax"
                      else (ClusterBucketStore, PlacementError))
    cluster = Cluster(addresses=addrs[:2], coalesce_requests=False,
                      request_timeout_s=10.0, retry_policy=None,
                      handoff_window_s=60.0)
    faults = pfaults if kind == "port" else jfaults
    keys = [f"c{i}" for i in range(80)]
    out = {"admitted": 0}
    try:
        async def traffic(n):
            for i in rng.integers(0, len(keys), n).tolist():
                r = await cluster.acquire(keys[i], int(rng.integers(1, 4)),
                                          12.0, 1.0)
                out["admitted"] += int(r.granted)
            await cluster.window_acquire("w-key", 2, 20.0, 1.0)
            await cluster.sync_counter("c-key", 2.0, 1.0)

        await traffic(150)
        out["join"] = await cluster.add_node(address=addrs[2])
        await traffic(100)
        faults.install(faults.FaultInjector(seed, {
            "server.migrate": (faults.FaultRule("error", after=2,
                                                probability=1.0),)}))
        try:
            with pytest.raises(Error):
                await cluster.drain_node(1)
        finally:
            faults.uninstall()
        out["abort_epoch"] = cluster.placement.epoch
        await traffic(50)
        out["drain"] = await cluster.drain_node(1)
        await traffic(100)
        out["epochs"] = [(await c.placement_fetch())["epoch"]
                         for c in cluster.nodes]
        out["balances"] = [
            (await cluster.acquire(k, 0, 12.0, 1.0)).remaining
            for k in keys]
        out["stats"] = [s.placement.stats() for s in servers]
        out["log"] = [(e["type"], e.get("from_epoch"), e["target_epoch"])
                      for e in cluster.migration_log]
    finally:
        await cluster.aclose()
        for s in servers:
            await s.aclose()
        for s in stores:
            await s.aclose()
    return out


@pytest.mark.parametrize("coordinator", ["jax", "port"])
@pytest.mark.parametrize("backing", ["serial", "device"])
def test_jax_coordinator_over_port_servers(backing, coordinator):
    """Either package's coordinator over port servers and over JAX
    servers; every run equals JAX's coordinator over JAX servers."""
    got = {kind: run(_cluster(kind, backing, 5, coordinator))
           for kind in ("port", "jax")}
    if coordinator == "port":
        assert got["jax"] == run(_cluster("jax", backing, 5, "jax"))
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["join"] == 2 and port["abort_epoch"] == 1
    assert port["drain"] == 2 and port["epochs"] == [2, 2, 2]
    assert [e[0] for e in port["log"]] == ["commit", "abort", "commit"]
    assert port["stats"][2]["rows_imported"] > 0
    assert port["stats"][1]["aborts"] == 1


# -- the native lanes ----------------------------------------------------------

async def _read_reply(conn) -> bytes:
    r, _w = conn
    hdr = await asyncio.wait_for(r.readexactly(4), 10.0)
    (ln,) = struct.unpack("<I", hdr)
    return hdr + await asyncio.wait_for(r.readexactly(ln), 10.0)


async def _roundtrip(conn, frame: bytes) -> bytes:
    conn[1].write(frame)
    await conn[1].drain()
    return await _read_reply(conn)


async def _pipeline(conn, frames) -> dict:
    """Send ``frames`` back to back; the replies by seq."""
    for f in frames:
        conn[1].write(f)
    await conn[1].drain()
    out = {}
    for _ in frames:
        body = await _read_reply(conn)
        out[int.from_bytes(body[5:9], "little")] = body
    return out


async def _native_pair(backing: str):
    """An asyncio and a native port server over equal stores on lockstep
    ManualClocks, their placement clocks frozen."""
    clocks = [ManualClock(START), ManualClock(START)]
    stores = [_store("port", backing, c) for c in clocks]
    servers = [_server("port", stores[0], lambda: 50.0),
               _server("port", stores[1], lambda: 50.0,
                       native_frontend=True)]
    for s in servers:
        await s.start()
    conns = [await asyncio.open_connection(s.host, s.port) for s in servers]
    return stores, servers, conns


async def _close(stores, servers, conns):
    for _r, w in conns:
        w.close()
    for s in servers:
        await s.aclose()
    for s in stores:
        await s.aclose()


@pytest.mark.parametrize("backing", ["serial", "device"])
def test_bulk_gated_rows_byte_identical(backing):
    """The placement half of JAX's parity case: a map where half the slots
    belong to node 1 — frames touching them answer the frame-level MOVED
    error, the rest decide normally, byte for byte on both lanes."""
    async def main():
        stores, servers, conns = await _native_pair(backing)
        try:
            ann = {"map": {"epoch": 1, "n_slots": 16,
                           "slot_owner": [0, 1] * 8, "overrides": {}},
                   "node_id": 0}
            frame = pw.encode_request(901, pw.OP_PLACEMENT_ANNOUNCE,
                                      key=json.dumps(ann))
            rs = [await _roundtrip(cn, frame) for cn in conns]
            assert rs[0] == rs[1]
            rng = np.random.default_rng(3)
            saw_moved = saw_bulk = False
            for step in range(40):
                nk = int(rng.integers(1, 12))
                pool = [b"m%d" % rng.integers(0, 64) for _ in range(nk)]
                frame = pw.encode_bulk_request(
                    1000 + step, pool, np.ones(nk, np.int64), 80.0, 2.0)
                rs = [await _roundtrip(cn, frame) for cn in conns]
                assert rs[0] == rs[1], step
                if b"placement moved" in rs[0]:
                    saw_moved = True
                elif rs[0][9] == pw.RESP_BULK:
                    saw_bulk = True
            assert saw_moved and saw_bulk
        finally:
            await _close(stores, servers, conns)

    run(main())


@pytest.mark.parametrize("backing", ["serial", "device"])
def test_native_lanes_gate_parked_and_moved_rows(backing):
    """A slot parked by a pull on both servers: per-request frames on
    parked, moved and owned keys (pipelined, so the C batcher groups them;
    each (key, op) once) answer byte for byte alike — moved rows MOVED
    and parked SEMA rows the deferral through ``fe_send`` and the
    row-skip sentinel, parked admissions from the envelope — then gated
    bulk frames (parked rows from the envelope, a moved row the frame's
    MOVED) alike."""
    async def main():
        stores, servers, conns = await _native_pair(backing)
        try:
            m = ppl.PlacementMap(1, [0, 1] * 8)
            keys = [f"g{i}" for i in range(160)]
            own = [k for k in keys if m.node_of(k) == 0]
            slot = m.slot_of(own[0])
            parked = [k for k in own if m.slot_of(k) == slot]
            served = [k for k in own if m.slot_of(k) != slot]
            moved = [k for k in keys if m.node_of(k) == 1]
            for st in stores:
                await st.acquire_many(own, [2] * len(own), 10.0, 1.0)
                await st.concurrency_acquire_many(own, [1] * len(own), 5)
            setup = [pw.encode_request(1, pw.OP_PLACEMENT_ANNOUNCE, json.dumps(
                {"map": m.to_dict(), "node_id": 0})),
                pw.encode_request(2, pw.OP_MIGRATE_PULL, json.dumps(
                    {"target_epoch": 2, "slots": [slot], "window_s": 30.0}))]
            for f in setup:
                rs = [await _roundtrip(cn, f) for cn in conns]
                assert rs[0] == rs[1]
            rng = np.random.default_rng(11)
            ops = (pw.OP_ACQUIRE, pw.OP_WINDOW, pw.OP_FWINDOW, pw.OP_SEMA)
            combos = [(k, op) for pool in (parked, moved[:12], served[:12])
                      for k in pool for op in ops]
            frames = []
            for n, i in enumerate(rng.permutation(len(combos)).tolist()):
                k, op = combos[i]
                count = (-1 if op == pw.OP_SEMA and n % 3 == 0
                         else int(rng.integers(0, 3)))
                a, b = ((5.0, 0.0) if op == pw.OP_SEMA else (10.0, 1.0)
                        if op == pw.OP_ACQUIRE else (20.0, 1.0))
                frames.append(pw.encode_request(100 + n, op, k, count, a, b))
            got = [await _pipeline(cn, frames) for cn in conns]
            assert got[0] == got[1]
            text = b"".join(got[0].values())
            assert b"placement moved" in text
            assert b"placement handoff in progress" in text
            bulk = [parked + served[:5], parked * 3, served[:4] + moved[:1]]
            for n, ks in enumerate(bulk):
                frame = pw.encode_bulk_request(
                    900 + n, [k.encode() for k in ks],
                    np.ones(len(ks), np.int64), 10.0, 1.0)
                rs = [await _roundtrip(cn, frame) for cn in conns]
                assert rs[0] == rs[1], n
            assert b"placement moved" in rs[0]
            stats = [s.placement.stats() for s in servers]
            assert stats[0] == stats[1]
            assert stats[0]["envelope_decisions"] > 0
            assert stats[0]["handoff_deferrals"] > 0
        finally:
            await _close(stores, servers, conns)

    run(main())


# -- reservations across a migration -------------------------------------------

@pytest.mark.parametrize("server_kind,client_kind",
                         [("port", "port"), ("port", "jax"),
                          ("jax", "port")])
def test_migration_moves_ledger_and_reroutes_settles(server_kind,
                                                     client_kind):
    """JAX ``test_reservations.py:516``: the hold rides the pull, a settle
    defers mid-handoff, MOVED on the old owner after the commit, settled
    on the new owner with the refund landing in its store."""
    async def main():
        clock = (ManualClock if server_kind == "port" else JClock)(START)
        stores = [_store(server_kind, "serial", clock) for _ in range(2)]
        servers = [_server(server_kind, s, lambda: 50.0) for s in stores]
        for s in servers:
            await s.start()
        c1, c2 = (_client(client_kind, s, coalesce_requests=False)
                  for s in servers)
        errors = (pw.RemoteStoreError if client_kind == "port"
                  else jw.RemoteStoreError)
        try:
            m0 = ppl.PlacementMap.initial(2)
            tenant = next(f"t{i}" for i in range(64)
                          if m0.node_of(f"t{i}") == 0)
            await c1.placement_announce({"map": m0.to_dict(), "node_id": 0})
            await c2.placement_announce({"map": m0.to_dict(), "node_id": 1})
            r = await c1.reserve("m1", tenant, "k", 100, 1000.0, _FILL,
                                 _CHILD_CAP, _CHILD_RATE)
            assert r.granted
            pulled = await c1.migrate_pull({"target_epoch": 1,
                                            "keys": [tenant],
                                            "window_s": 30.0})
            assert len(pulled["entries"]["reservations"]) == 1
            assert servers[0].reservations.outstanding_count() == 0
            with pytest.raises(errors, match="handoff in progress"):
                await c1.settle("m1", tenant, 40.0)
            applied = await c2.migrate_push({"target_epoch": 1, "batch": 1,
                                             "entries": pulled["entries"]})
            assert applied >= 1
            assert servers[1].reservations.outstanding_count() == 1
            m1 = m0.with_assignments(set_overrides={tenant: 1})
            await c1.placement_announce({"map": m1.to_dict(), "node_id": 0})
            await c2.placement_announce({"map": m1.to_dict(), "node_id": 1})
            with pytest.raises(errors, match="placement moved"):
                await c1.settle("m1", tenant, 40.0)
            with pytest.raises(errors, match="placement moved"):
                await c1.reserve("m2", tenant, "k", 5, 1000.0, _FILL,
                                 _CHILD_CAP, _CHILD_RATE)
            s = await c2.settle("m1", tenant, 40.0)
            assert s.outcome == "settled" and s.refunded == 60.0
            # 900 after the hold, one envelope (500) kept by the old
            # owner, 400 shipped; the refund of 60 lands here.
            assert stores[1].peek_blocking(tenant, 1000.0, _FILL) == 460.0
        finally:
            await c1.aclose()
            await c2.aclose()
            for s in servers:
                await s.aclose()

    run(main())


@pytest.mark.parametrize("server_kind", ["port", "jax"])
def test_migration_abort_restores_ledger(server_kind):
    """JAX ``test_reservations.py:574``: an abort brings the exported hold
    home; the settle reconciles locally. A reserve on the parked tenant
    serves from the envelope and takes no ledger entry."""
    async def main():
        clock = (ManualClock if server_kind == "port" else JClock)(START)
        store = _store(server_kind, "serial", clock)
        srv = _server(server_kind, store, lambda: 50.0)
        await srv.start()
        c1 = _client("port", srv, coalesce_requests=False)
        try:
            m0 = ppl.PlacementMap.initial(1)
            await c1.placement_announce({"map": m0.to_dict(), "node_id": 0})
            await c1.reserve("a1", "t0", "k", 100, 1000.0, _FILL,
                             _CHILD_CAP, _CHILD_RATE)
            await c1.migrate_pull({"target_epoch": 1, "keys": ["t0"],
                                   "window_s": 30.0})
            assert srv.reservations.outstanding_count() == 0
            env = await c1.reserve("a2", "t0", "k", 7, 1000.0, _FILL,
                                   _CHILD_CAP, _CHILD_RATE)
            assert env.granted and env.reserved == 7.0
            assert srv.reservations.outstanding_count() == 0
            await c1.placement_announce({"abort_epoch": 1})
            assert srv.reservations.outstanding_count() == 1
            s = await c1.settle("a1", "t0", 60.0)
            assert s.outcome == "settled" and s.refunded == 40.0
            s = await c1.settle("a2", "t0", 7.0)
            assert s.outcome == "unknown"
        finally:
            await c1.aclose()
            await srv.aclose()

    run(main())


def test_chunk_entries_sizes_reservation_rows():
    """JAX ``test_reservations.py:312``: a reservation row is sized by all
    its string fields, so long child keys page under MAX_FRAME, as JAX's
    pages them."""
    long_key = "k" * 60_000
    rows = [["t", f"rid{i}", long_key, 10.0, 1e6, 1e-9, 1e3, 1e-9, 0,
             30.0] for i in range(40)]
    got = ppl.chunk_entries({"reservations": rows})
    assert got == jpl.chunk_entries({"reservations": rows})
    assert len(got) > 1
    assert all(len(json.dumps(c)) < 800_000 for c in got)


def test_envelope_grants_bounded_by_budget():
    """The dual-ownership split on a port server: a pull debits the
    source to one envelope and ships the rest; old (envelope) + new
    (imported) admit at most the balance plus one envelope."""
    async def main():
        clock = ManualClock(START)
        stores = [DeviceBucketStore(device="cpu", clock=clock, n_slots=256)
                  for _ in range(2)]
        servers = [_server("port", s, lambda: 50.0) for s in stores]
        for s in servers:
            await s.start()
        clis = [_client("port", s, coalesce_requests=False)
                for s in servers]
        try:
            m0 = ppl.PlacementMap.initial(1)
            await clis[0].placement_announce({"map": m0.to_dict(),
                                              "node_id": 0})
            await clis[0].acquire("hot", 3, 40.0, 0.0)  # 37 left
            m1 = m0.with_assignments(set_overrides={"hot": 1})
            await clis[1].placement_announce({"map": m1.to_dict(),
                                              "node_id": 1})
            out = await clis[0].migrate_pull({"target_epoch": 1,
                                              "keys": ["hot"],
                                              "window_s": 30.0})
            await clis[1].migrate_push({"target_epoch": 1, "batch": 0,
                                        "entries": out["entries"]})
            old = sum([(await clis[0].acquire("hot", 1, 40.0, 0.0)).granted
                       for _ in range(60)])
            new = sum([(await clis[1].acquire("hot", 1, 40.0, 0.0)).granted
                       for _ in range(60)])
            budget = headroom_budget(40.0, fraction=0.5, min_budget=1.0)
            assert old == budget and new == 37 - budget
            assert stores[0].peek_blocking("hot", 40.0, 0.0) == budget
            assert servers[0].placement.envelope_decisions == 60
            assert servers[0].auditor.tick() is not None
            assert servers[0].auditor.epsilon_used["envelope"] > 0
        finally:
            for c in clis:
                await c.aclose()
            for s in servers:
                await s.aclose()

    run(main())


# -- checkpoints carry the epoch -----------------------------------------------

def test_save_stamps_the_epoch_and_the_console_holds_it(tmp_path):
    """``OP_SAVE`` stamps the adopted epoch, as a JAX server's does (each
    package loads the other's file held to it); the console's
    ``--expect-placement-epoch`` refuses another epoch's file at startup
    (init-on-miss, with the warning)."""
    import os
    import subprocess
    import sys
    import threading

    from distributedratelimiting.redis_tpu.runtime import checkpoint as jcp
    from distributedratelimiting.redis_tpu_torch.runtime import (
        checkpoint as pcp,
    )

    paths = {kind: str(tmp_path / f"{kind}.snap") for kind in ("port",
                                                              "jax")}

    async def save(kind):
        clock = (ManualClock if kind == "port" else JClock)(START)
        store = _store(kind, "serial", clock)
        srv = _server(kind, store, lambda: 50.0, snapshot_path=paths[kind])
        await srv.start()
        cli = _client("port", srv)
        try:
            m = ppl.PlacementMap.initial(2).with_assignments(
                {0: 1}).with_assignments({1: 0}).with_assignments({})
            await cli.placement_announce({"map": m.to_dict(), "node_id": 0})
            own = [f"s{i}" for i in range(40) if m.node_of(f"s{i}") == 0]
            await cli.acquire_many(own, [3] * len(own), 10.0, 1.0)
            await cli.save()
        finally:
            await cli.aclose()
            await srv.aclose()

    for kind in paths:
        run(save(kind))
    for kind, path in paths.items():
        for cp in (pcp, jcp):
            store = _store("port" if cp is pcp else "jax", "serial",
                           (ManualClock if cp is pcp else JClock)(START))
            cp.load_snapshot(store, path, expected_placement_epoch=3)
            with pytest.raises(cp.PlacementMismatchError):
                cp.load_snapshot(store, path, expected_placement_epoch=4)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributedratelimiting.redis_tpu_torch.runtime.server",
         "--port", "0", "--backend", "inprocess", "--snapshot-path",
         paths["port"], "--expect-placement-epoch", "4"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        env=dict(os.environ, PYTHONPATH=root), cwd=root)
    # A child that never prints must not hang the test: killed at 120 s,
    # its readline returns "".
    guard = threading.Timer(120.0, proc.kill)
    guard.start()
    try:
        first = proc.stdout.readline()
        assert first.startswith("WARNING: ignoring corrupt snapshot"), first
        assert "placement epoch 3" in first
    finally:
        guard.cancel()
        proc.kill()
        proc.wait(timeout=30)
