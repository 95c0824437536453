"""The port's drain-and-handoff shutdown (``BucketStoreServer.shutdown``,
the drain gate on every lane, the settle relay and ``--drain-to``) against
the JAX package's, on the CPU.

Each scenario is written once and run on both packages with the same
numpy-seeded inputs: a JAX server pair over ``InProcessBucketStore``, and a
port pair over ``DeviceBucketStore(device="cpu")`` and over the port's
``InProcessBucketStore``, every store on one frozen ManualClock.

- Twins of JAX ``tests/test_upgrade.py:425-597``, the six shutdown cases:
  the summaries, the successor's state key by key, the source's residual
  and the grants served from the envelope are equal.
- A seeded differential drain (20 seeds): buckets at three configs,
  sliding and fixed windows, counters, semaphores, open holds, a tenant
  debt and (most seeds) a committed config; during the drain a raw frame
  of every lane reaches the source. Summaries, states, ledgers, config
  payloads and every reply's bytes are equal, and so are they when the
  fleets are crossed (a port source into a JAX successor, and the reverse).
- One gate test per lane (scalar, bulk, two-level, two-level bulk,
  reserve, settle relay, the native bulk lane): the same frames against a
  draining port server and a draining JAX server answer byte for byte
  alike.
- The console: SIGTERM with ``--drain-to`` ships the state to the successor
  process.
- The JAX scenarios that drain: the LLM soak's drain phase
  (``tests/test_llm_admission.py:421-445``), the reservation streaming
  soak (``tests/test_reservations.py:820``) and ``TestRollingRestartSoak``
  (``tests/test_upgrade.py:665-678``) with JAX's or the port's
  ``ClusterBucketStore`` coordinating port servers.

The envelope refills on its own clock (``time.monotonic``), so where grants
and ``remaining`` are compared the scenarios freeze it (``_frozen_envelope``)
and ask from inside the drain (``_Hooked``: after the first push lands),
which makes the window's traffic deterministic. Tolerance, as
``tests/test_torch_placement.py`` uses for the same export: bucket and
window state exact (frozen clock, whole numbers), counters within 2
float32 ulps.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.models.approximate import (
    headroom_budget as jheadroom,
)
from distributedratelimiting.redis_tpu.runtime import checkpoint as jck
from distributedratelimiting.redis_tpu.runtime import placement as jpl
from distributedratelimiting.redis_tpu.runtime import wire as jwire
from distributedratelimiting.redis_tpu.runtime.admission import (
    PRIORITY_BATCH,
    PRIORITY_INTERACTIVE,
    PRIORITY_SCAVENGER,
)
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.cluster import (
    ClusterBucketStore as JCluster,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    StoreTimeoutError as JTimeout,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
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
    StoreTimeoutError,
)
from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
)
from distributedratelimiting.redis_tpu_torch.runtime import checkpoint as pck
from distributedratelimiting.redis_tpu_torch.runtime import placement as ppl
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw
from distributedratelimiting.redis_tpu_torch.utils import faults as pfaults

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = 1_000_000
LIMIT_S = 60.0

PORT = types.SimpleNamespace(
    name="port", pl=ppl, ck=pck, faults=pfaults, Clock=ManualClock,
    Serial=InProcessBucketStore, Server=BucketStoreServer,
    Remote=RemoteBucketStore, headroom=headroom_budget,
    device=lambda clock: DeviceBucketStore(device="cpu", clock=clock,
                                           n_slots=512, max_batch=64))
JAX = types.SimpleNamespace(
    name="jax", pl=jpl, ck=jck, faults=jfaults, Clock=JClock,
    Serial=JSerial, Server=JServer, Remote=JRemote, headroom=jheadroom,
    device=None)
PKGS = (PORT, JAX)
#: The port's backings; the JAX pair runs over its serial store.
BACKINGS = ("serial", "device")


def run(coro, limit_s: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit_s))


def _store(pk, backing: str, clock):
    if backing == "serial":
        return pk.Serial(clock=clock)
    return pk.device(clock)


def _ulps(a: float, b: float, n: int = 2) -> bool:
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) <= n * float(
        np.spacing(max(abs(a), abs(b), np.float32(1e-30))))


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    jfaults.uninstall()
    pfaults.uninstall()


@pytest.fixture
def _frozen_envelope(monkeypatch):
    """Both packages' shutdown envelopes on a frozen clock, so a window
    envelope (refilled at limit / window_s) answers the same ``remaining``
    in both runs."""
    for pk in PKGS:
        base = pk.pl._FairShareEnvelope

        class Frozen(base):
            def __init__(self, fraction, clock=None):
                super().__init__(fraction, clock=lambda: 0.0)

        monkeypatch.setattr(pk.pl, "_FairShareEnvelope", Frozen)


class _Hooked:
    """A successor store whose first ``migrate_push`` runs ``hook`` after it
    lands: traffic sent from the hook reaches the source while its drain
    gate is on and the successor already holds the first chunk."""

    def __init__(self, inner, hook):
        self._inner = inner
        self._hook = hook
        self.pushes = 0

    def __getattr__(self, name):
        return getattr(self._inner, name)

    async def migrate_push(self, req):
        n = await self._inner.migrate_push(req)
        self.pushes += 1
        if self.pushes == 1:
            await self._hook()
        return n


async def _one(conn, frame: bytes) -> bytes:
    """One frame on a raw connection, its reply body."""
    reader, writer = conn
    writer.write(frame)
    await writer.drain()
    return await asyncio.wait_for(pw.read_frame(reader), 30.0)


def _state(pk, store) -> dict:
    """A store's state as its export, rows sorted, ages dropped (the
    frozen clock makes them all 0)."""
    e = pk.pl._export_from_store(store, lambda _k: True)
    return {
        "buckets": sorted((k, float(c), float(r), float(t))
                          for k, c, r, t, _age in e.get("buckets", ())),
        "windows": sorted((k, float(lim), int(wt), int(i), float(p),
                           float(cu), int(bh))
                          for k, lim, wt, i, p, cu, bh
                          in e.get("windows", ())),
        "counters": sorted((k, float(v))
                           for k, v, _p, _a in e.get("counters", ())),
        "semas": sorted((k, int(a)) for k, a in e.get("semas", ())),
    }


def _states_equal(a: dict, b: dict) -> None:
    assert a["buckets"] == b["buckets"]
    assert a["windows"] == b["windows"]
    assert a["semas"] == b["semas"]
    assert [k for k, _ in a["counters"]] == [k for k, _ in b["counters"]]
    for (_, va), (_, vb) in zip(a["counters"], b["counters"]):
        assert _ulps(va, vb), (va, vb)


def _ledger(srv) -> list:
    led = srv.reservations
    return [sorted((e.rid, e.tenant, e.key, e.reserved, e.a, e.b, e.ta,
                    e.tb, e.priority) for e in led._entries.values()),
            sorted(led._settled), dict(sorted(led.debts().items()))]


async def _pair(pk, backing, clock, **kw):
    """A started source and successor server over two stores."""
    stores = [_store(pk, backing, clock), _store(pk, backing, clock)]
    servers = [pk.Server(stores[0], **kw), pk.Server(stores[1])]
    for s in servers:
        await s.start()
    return stores, servers


async def _close(clients, servers, stores):
    for c in clients:
        await c.aclose()
    for s in servers:
        await s.aclose()
    for s in stores:
        await s.aclose()


# -- twins of the six shutdown cases ------------------------------------------

async def _ships(pk, backing):
    """JAX ``test_shutdown_ships_state_to_successor_exactly``."""
    (ob, nb), (old, new) = await _pair(pk, backing, pk.Clock(START))
    c = pk.Remote(address=(old.host, old.port), coalesce_requests=False)
    succ = pk.Remote(address=(new.host, new.port), coalesce_requests=False)
    try:
        for _ in range(30):
            await c.acquire("k", 1, 100.0, 0.0)
        summary = await old.shutdown(successor=succ, window_s=0.05)
        return [summary, _state(pk, nb), ob.peek_blocking("k", 100.0, 0.0),
                await old.shutdown(successor=succ)]
    finally:
        await _close([c, succ], [old, new], [ob, nb])


@pytest.mark.parametrize("backing", BACKINGS)
def test_shutdown_ships_state_to_successor_exactly(backing):
    port, jax = run(_ships(PORT, backing)), run(_ships(JAX, "serial"))
    assert port[0] == jax[0] and port[0]["shipped_rows"] == 1
    _states_equal(port[1], jax[1])
    # shipped balance = 70 remaining − 50 envelope withheld
    assert port[1]["buckets"] == [("k", 100.0, 0.0, 20.0)]
    # the old store was debited for the shipped amount
    assert port[2] == jax[2] == 50.0
    assert port[3] == jax[3] == {"already": True}


async def _envelope(pk, backing):
    """JAX ``test_shutdown_serves_envelope_during_drain_window``, with the
    straggler traffic sent from inside the drain (deterministic) and the
    window's length held."""
    (ob, nb), (old, new) = await _pair(pk, backing, pk.Clock(START))
    c = pk.Remote(address=(old.host, old.port), coalesce_requests=False,
                  request_timeout_s=5.0)
    succ = pk.Remote(address=(new.host, new.port), coalesce_requests=False)
    asks = []

    async def stragglers():
        for _ in range(15):
            r = await c.acquire("k", 1, 20.0, 0.0)
            asks.append((r.granted, r.remaining))
        res = await c.acquire_many(["k", "k2", "k2"], [1, 4, 9], 20.0, 0.0)
        asks.append((list(res.granted), list(res.remaining)))

    try:
        await c.acquire("k", 10, 20.0, 0.0)
        t = time.monotonic()
        summary = await old.shutdown(successor=_Hooked(succ, stragglers),
                                     window_s=0.3)
        lingered = time.monotonic() - t >= 0.3
        return [summary, asks, _state(pk, nb), lingered]
    finally:
        await _close([c, succ], [old, new], [ob, nb])


@pytest.mark.parametrize("backing", BACKINGS)
def test_shutdown_serves_envelope_during_drain_window(backing):
    port, jax = run(_envelope(PORT, backing)), run(_envelope(JAX, "serial"))
    assert port[0] == jax[0] and port[1] == jax[1]
    _states_equal(port[2], jax[2])
    assert port[3] and jax[3]
    # 15 scalar asks and one bulk frame of 3 rows
    assert port[0]["envelope_decisions"] == 18
    budget = headroom_budget(20.0, fraction=0.5, min_budget=1.0)
    served = sum(g for g, _ in port[1][:15])
    assert served == budget  # the envelope is the withheld budget, capped
    assert port[1][15][0] == [False, True, False]
    # shipped: 10 remaining − 10 withheld
    assert port[2]["buckets"] == [("k", 20.0, 0.0, 0.0)]


async def _final_checkpoint(pk, backing, tmp_path):
    """JAX ``test_shutdown_without_successor_writes_final_checkpoint``."""
    path = str(tmp_path / f"{pk.name}-final.bin")
    clock = pk.Clock(START)
    back = _store(pk, backing, clock)
    srv = pk.Server(back, snapshot_path=path)
    await srv.start()
    c = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        for _ in range(40):
            await c.acquire("k", 1, 100.0, 0.0)
    finally:
        await c.aclose()
    summary = await srv.shutdown()
    fresh = _store(pk, backing, clock)
    pk.ck.load_snapshot_chain(fresh, path)
    out = [summary["checkpoint"] == path, sorted(summary),
           fresh.peek_blocking("k", 100.0, 0.0), _state(pk, fresh)]
    await back.aclose()
    await fresh.aclose()
    return out


@pytest.mark.parametrize("backing", BACKINGS)
def test_shutdown_without_successor_writes_final_checkpoint(backing,
                                                            tmp_path):
    port = run(_final_checkpoint(PORT, backing, tmp_path))
    jax = run(_final_checkpoint(JAX, "serial", tmp_path))
    assert port[:3] == jax[:3] == [True, ["checkpoint", "shipped_rows"],
                                   60.0]
    _states_equal(port[3], jax[3])


async def _chain(pk, backing, tmp_path):
    """JAX ``test_shutdown_checkpoint_uses_incremental_chain``."""
    path = str(tmp_path / f"{pk.name}-snap.bin")
    clock = pk.Clock(START)
    back = _store(pk, backing, clock)
    srv = pk.Server(back, snapshot_path=path, snapshot_incremental=True)
    await srv.start()
    c = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        for i in range(64):
            await c.acquire(f"k{i}", 1, 100.0, 0.0)
        await c.save()  # base
        await c.acquire("k0", 5, 100.0, 0.0)
        await c.save()  # delta 1
        st = await c.stats()
    finally:
        await c.aclose()
    summary = await srv.shutdown()  # the final save through the chain
    fresh = _store(pk, backing, clock)
    deltas = pk.ck.load_snapshot_chain(fresh, path)
    out = [st["snapshot_chain"]["delta_saves"] >= 1,
           st["snapshot_chain"]["dirty"]["total"] >= 64,
           bool(summary["checkpoint"]), deltas,
           fresh.peek_blocking("k0", 100.0, 0.0),
           fresh.peek_blocking("k63", 100.0, 0.0), _state(pk, fresh)]
    await back.aclose()
    await fresh.aclose()
    return out


@pytest.mark.parametrize("backing", BACKINGS)
def test_shutdown_checkpoint_uses_incremental_chain(backing, tmp_path):
    port = run(_chain(PORT, backing, tmp_path))
    jax = run(_chain(JAX, "serial", tmp_path))
    assert port[:6] == jax[:6] == [True, True, True, 2, 94.0, 99.0]
    _states_equal(port[6], jax[6])


def _dead(pk):
    return pk.Remote(address=("127.0.0.1", 1), coalesce_requests=False,
                     request_timeout_s=0.3, retry_policy=None)


async def _fallback(pk, backing, tmp_path):
    """JAX ``test_failed_drain_falls_back_to_final_checkpoint``."""
    path = str(tmp_path / f"{pk.name}-fallback.bin")
    clock = pk.Clock(START)
    back = _store(pk, backing, clock)
    srv = pk.Server(back, snapshot_path=path)
    await srv.start()
    c = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        for _ in range(30):
            await c.acquire("k", 1, 100.0, 0.0)
    finally:
        await c.aclose()
    dead = _dead(pk)
    try:
        summary = await srv.shutdown(successor=dead, window_s=0.05)
    finally:
        await dead.aclose()
    fresh = _store(pk, backing, clock)
    pk.ck.load_snapshot_chain(fresh, path)
    out = [summary["checkpoint"] == path, sorted(summary),
           summary["shipped_rows"], summary["drain_error"].split("(")[0],
           fresh.peek_blocking("k", 100.0, 0.0), _state(pk, fresh),
           _state(pk, back), srv._drain_envelope is None]
    await back.aclose()
    await fresh.aclose()
    return out


@pytest.mark.parametrize("backing", BACKINGS)
def test_failed_drain_falls_back_to_final_checkpoint(backing, tmp_path):
    port = run(_fallback(PORT, backing, tmp_path))
    jax = run(_fallback(JAX, "serial", tmp_path))
    assert port[:5] == jax[:5]
    assert port[:3] == [True, ["checkpoint", "drain_error", "shipped_rows"],
                        0]
    # the balance survived, debited by the shipped amount (conservative:
    # never a fresh full budget)
    assert port[4] == 50.0
    _states_equal(port[5], jax[5])
    _states_equal(port[5], port[6])  # the checkpoint is the debited source
    assert port[7] and jax[7]


async def _retry(pk, backing):
    """JAX ``test_failed_drain_without_snapshot_is_retryable``."""
    (ob, nb), (old, new) = await _pair(pk, backing, pk.Clock(START))
    c = pk.Remote(address=(old.host, old.port), coalesce_requests=False)
    out = []
    try:
        for _ in range(30):
            await c.acquire("k", 1, 100.0, 0.0)
        dead = _dead(pk)
        try:
            await old.shutdown(successor=dead, window_s=0.05)
        except Exception as exc:  # noqa: BLE001
            out.append(type(exc).__name__)
        else:
            out.append(None)
        finally:
            await dead.aclose()
        # the failed drain disarms the envelope: the server serves from
        # the (debited) store again
        out.append(old._drain_envelope is None)
        r = await c.acquire("k", 0, 100.0, 0.0)
        out.append((r.granted, r.remaining))
        succ = pk.Remote(address=(new.host, new.port),
                         coalesce_requests=False)
        try:
            summary = await old.shutdown(successor=succ, window_s=0.05)
        finally:
            await succ.aclose()
        out += [summary, _state(pk, nb)]
        return out
    finally:
        await _close([c], [old, new], [ob, nb])


@pytest.mark.parametrize("backing", BACKINGS)
def test_failed_drain_without_snapshot_is_retryable(backing):
    port, jax = run(_retry(PORT, backing)), run(_retry(JAX, "serial"))
    assert port[:4] == jax[:4]
    assert port[0] is not None and port[1]
    assert port[2] == (True, 50.0)  # post-debit residual = the envelope
    assert port[3].get("already") is None and port[3]["shipped_rows"] == 1
    _states_equal(port[4], jax[4])
    # the retry ships the residual less a second envelope (half the
    # capacity, not of the balance): max(0, 50 − 50)
    assert port[4]["buckets"] == [("k", 100.0, 0.0, 0.0)]


async def _no_push(pk, backing):
    """A successor without ``migrate_push`` (a store handed over in
    process) takes the export through ``placement.import_entries``."""
    clock = pk.Clock(START)
    ob, nb = _store(pk, backing, clock), _store(pk, backing, clock)
    old = pk.Server(ob)
    await old.start()
    c = pk.Remote(address=(old.host, old.port), coalesce_requests=False)
    try:
        for i in range(12):
            await c.acquire(f"k{i}", i + 1, 30.0, 0.0)
        await c.window_acquire("w", 7, 20.0, 60.0)
        summary = await old.shutdown(successor=nb, window_s=0.0)
        return [summary, _state(pk, nb), _state(pk, ob)]
    finally:
        await _close([c], [old], [ob, nb])


@pytest.mark.parametrize("backing", BACKINGS)
def test_shutdown_into_a_store_uses_the_import_lane(backing):
    port, jax = run(_no_push(PORT, backing)), run(_no_push(JAX, "serial"))
    assert port[0] == jax[0] and port[0]["shipped_rows"] == 13
    _states_equal(port[1], jax[1])
    _states_equal(port[2], jax[2])


# -- the seeded differential drain ----------------------------------------------

BUCKET_CFGS = ((10.0, 0.0), (20.0, 0.0), (16.0, 0.25))
RETIRED, REPLACEMENT = (10.0, 0.0), (6.0, 0.0)
WINDOW = (12.0, 60.0)
TENANT = (200.0, 0.0)
HOLD_KEY = (50.0, 0.0)
DEBT_TENANT = (30.0, 0.0)


def _load_plan(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    nb = int(rng.integers(20, 41))
    bkeys = [f"b{i}" for i in range(nb)]
    cfg = [BUCKET_CFGS[int(rng.integers(0, 3))] for _ in bkeys]
    spend = [int(rng.integers(0, int(c[0]) + 1)) for c in cfg]
    nw = int(rng.integers(4, 10))
    return {
        "bkeys": bkeys, "cfg": cfg, "spend": spend,
        "wkeys": [f"w{i}" for i in range(nw)],
        "wcount": rng.integers(1, 13, nw).tolist(),
        "fcount": rng.integers(1, 13, nw).tolist(),
        "counters": [(f"c{i}", float(rng.integers(1, 50)))
                     for i in range(int(rng.integers(2, 7)))],
        "semas": [(f"s{i}", int(rng.integers(1, 6)))
                  for i in range(int(rng.integers(2, 7)))],
        "holds": [(f"r{i}", f"t{i % 2}", f"h{i}", float(rng.integers(5, 21)))
                  for i in range(int(rng.integers(3, 6)))],
        "commit": bool(rng.random() < 0.8),
        "asks": rng.integers(1, 4, 8).tolist(),
    }


def _drain_frames(plan: dict) -> list:
    """One raw frame of every lane, sent to the draining source one at a
    time."""
    enc = pw.encode_request
    bkeys, cfg = plan["bkeys"], plan["cfg"]
    live = [(k, c) for k, c in zip(bkeys, cfg) if c != RETIRED]
    frames = []
    for i, n in enumerate(plan["asks"]):  # scalar admission, repeats
        k, c = live[i % 3]
        frames.append(enc(100 + i, pw.OP_ACQUIRE, k, n, *c))
    frames += [
        enc(120, pw.OP_ACQUIRE, bkeys[0], 1, *RETIRED),  # a retired config
        enc(121, pw.OP_WINDOW, plan["wkeys"][0], 2, *WINDOW),
        enc(122, pw.OP_FWINDOW, plan["wkeys"][1], 3, *WINDOW),
        enc(123, pw.OP_SEMA, plan["semas"][0][0], 1, 5.0, 0.0),
        enc(124, pw.OP_SEMA, plan["semas"][0][0], -1, 5.0, 0.0),
        enc(125, pw.OP_PEEK, live[0][0], 0, *live[0][1]),
        enc(126, pw.OP_SYNC, plan["counters"][0][0], 0, 1.0, 0.0),
        pw.encode_bulk_request(127, [k.encode() for k, _ in live[:6]],
                               np.array([1, 2, 3, 1, 2, 3]), *live[0][1]),
        pw.encode_bulk_request(128, [k.encode() for k in plan["wkeys"]],
                               np.ones(len(plan["wkeys"])), *WINDOW,
                               kind=pw.BULK_KIND_WINDOW),
        pw.encode_bulk_request(129, [b"x", b"x"], np.array([3, 9]),
                               *RETIRED),  # a retired bulk config
        enc(130, pw.OP_ACQUIRE_H, "h0", 4, *HOLD_KEY,
            hier=("t0", *TENANT, PRIORITY_INTERACTIVE)),
        enc(131, pw.OP_ACQUIRE_H, "h1", -1, *HOLD_KEY,
            hier=("t0", *TENANT, PRIORITY_INTERACTIVE)),
        pw.encode_bulk_request(132, [b"h2", b"h3", b"h2"],
                               np.array([2, 5, 80]), *HOLD_KEY,
                               kind=pw.BULK_KIND_HBUCKET,
                               hier=("t1", *TENANT, PRIORITY_BATCH)),
        enc(133, pw.OP_RESERVE, json.dumps(
            {"rid": "rx", "tenant": "t1", "key": "hx", "estimate": 7,
             "a": HOLD_KEY[0], "b": HOLD_KEY[1], "ta": TENANT[0],
             "tb": TENANT[1], "priority": 0})),
        enc(134, pw.OP_SETTLE, json.dumps(
            {"rid": plan["holds"][0][0], "tenant": plan["holds"][0][1],
             "actual": 3.0})),
        enc(135, pw.OP_SETTLE, json.dumps(
            {"rid": "nope", "tenant": "t0", "actual": 1.0})),
    ]
    return frames


async def _diff(src_pk, src_backing, dst_pk, dst_backing, seed):
    """One seeded drain from a ``src_pk`` server into a ``dst_pk`` server:
    the summary, the successor's state, ledger and config payload, every
    reply's bytes during the drain, and the source's residual."""
    plan = _load_plan(seed)
    src_b = _store(src_pk, src_backing, src_pk.Clock(START))
    dst_b = _store(dst_pk, dst_backing, dst_pk.Clock(START))
    src, dst = src_pk.Server(src_b), dst_pk.Server(dst_b)
    await src.start()
    await dst.start()
    c = src_pk.Remote(address=(src.host, src.port), coalesce_requests=False)
    succ = src_pk.Remote(address=(dst.host, dst.port),
                         coalesce_requests=False)
    conn = await asyncio.open_connection(src.host, src.port)
    replies = []

    async def during():
        for frame in _drain_frames(plan):
            replies.append(await _one(conn, frame))

    try:
        for cfg in BUCKET_CFGS:
            ks = [k for k, c_ in zip(plan["bkeys"], plan["cfg"]) if c_ == cfg]
            ns = [n for n, c_ in zip(plan["spend"], plan["cfg"]) if c_ == cfg]
            if ks:
                await c.acquire_many(ks, ns, *cfg)
        await c.window_acquire_many(plan["wkeys"], plan["wcount"], *WINDOW)
        await c.window_acquire_many(plan["wkeys"], plan["fcount"], *WINDOW,
                                    fixed=True)
        for key, value in plan["counters"]:
            await c.sync_counter(key, value, 0.0)
        for key, n in plan["semas"]:
            await c.concurrency_acquire(key, n, 5)
        for rid, tenant, key, est in plan["holds"]:
            r = await c.reserve(rid, tenant, key, est, *TENANT, *HOLD_KEY,
                                ttl_s=3600.0)
            assert r.granted
        await c.reserve("rd", "td", "hd", 10, *DEBT_TENANT, *HOLD_KEY,
                        ttl_s=3600.0)
        s = await c.settle("rd", "td", 50.0)  # 40 more than the 20 left
        assert s.debt == 20.0
        if plan["commit"]:
            await c.config_announce({"prepare": {
                "kind": "bucket", "old": list(RETIRED),
                "new": list(REPLACEMENT)}, "version": 1})
            await c.config_announce({"commit": 1})
        summary = await src.shutdown(successor=_Hooked(succ, during),
                                     window_s=0.0)
        return [summary, _state(dst_pk, dst_b), _ledger(dst),
                dst.liveconfig.snapshot_payload(), replies,
                _state(src_pk, src_b)]
    finally:
        conn[1].close()
        await _close([c, succ], [src, dst], [src_b, dst_b])


_JAX_DIFF: dict = {}


def _jax_diff(seed: int) -> list:
    if seed not in _JAX_DIFF:
        _JAX_DIFF[seed] = run(_diff(JAX, "serial", JAX, "serial", seed))
    return _JAX_DIFF[seed]


def _diff_equal(got: list, want: list) -> None:
    assert got[0] == want[0]
    _states_equal(got[1], want[1])
    assert got[2] == want[2] and got[3] == want[3]
    assert len(got[4]) == len(want[4])
    for g, w in zip(got[4], want[4]):
        assert g == w, (pw.decode_response(g), pw.decode_response(w))
    _states_equal(got[5], want[5])


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("seed", range(20))
def test_seeded_differential_drain(seed, backing, _frozen_envelope):
    got = run(_diff(PORT, backing, PORT, backing, seed))
    want = _jax_diff(seed)
    _diff_equal(got, want)
    summary, state, ledger = got[0], got[1], got[2]
    assert summary["envelope_decisions"] > 0
    assert ("config_version" in summary) == _load_plan(seed)["commit"]
    # every hold shipped; the settled one landed at the successor
    plan = _load_plan(seed)
    assert plan["holds"][0][0] in ledger[1]
    assert {h[0] for h in plan["holds"][1:]} <= {e[0] for e in ledger[0]}
    assert ledger[2] == {"td": 20.0}
    assert summary["shipped_rows"] >= len(state["buckets"])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
@pytest.mark.parametrize("seed", range(0, 20, 4))
def test_crossed_fleets_drain(seed, direction, _frozen_envelope):
    """A port source drains into a JAX successor, and a JAX source into a
    port successor (``DeviceBucketStore(device="cpu")``): the outcome is
    the straight JAX fleet's."""
    if direction == "port_to_jax":
        got = run(_diff(PORT, "device", JAX, "serial", seed))
    else:
        got = run(_diff(JAX, "serial", PORT, "device", seed))
    _diff_equal(got, _jax_diff(seed))


# -- one gate test per lane -------------------------------------------------------

async def _armed(pk, backing, frames, native: bool = False):
    """The frames' reply bytes from a server whose drain is armed (the
    state ``_shutdown_body`` sets before the source debit), its successor a
    live server whose ledger holds the hold ``g1``."""
    clock = pk.Clock(START)
    back, dst_b = _store(pk, backing, clock), _store(pk, backing, clock)
    srv = pk.Server(back, native_frontend=native)
    dst = pk.Server(dst_b)
    await srv.start()
    await dst.start()
    c = pk.Remote(address=(dst.host, dst.port), coalesce_requests=False)
    conn = await asyncio.open_connection(srv.host, srv.port)
    try:
        await c.reserve("g1", "gt", "gk", 9, *TENANT, *HOLD_KEY,
                        ttl_s=3600.0)
        srv._drain_envelope = pk.pl._FairShareEnvelope(
            0.5, clock=lambda: 0.0)
        srv._drain_successor = c
        out = [await _one(conn, f) for f in frames]
        return out, srv._drain_envelope.decisions
    finally:
        srv._drain_envelope = None
        srv._drain_successor = None
        conn[1].close()
        await _close([c], [srv, dst], [back, dst_b])


LANES = {
    "scalar": [pw.encode_request(1, pw.OP_ACQUIRE, "a", n, 9.0, 0.0)
               for n in (2, 2, 1, 3)]
    + [pw.encode_request(2, pw.OP_WINDOW, "w", 4, *WINDOW),
       pw.encode_request(3, pw.OP_FWINDOW, "w", 7, *WINDOW),
       pw.encode_request(4, pw.OP_SEMA, "s", 1, 3.0, 0.0),
       pw.encode_request(5, pw.OP_PEEK, "a", 0, 9.0, 0.0),
       pw.encode_request(6, pw.OP_SYNC, "c", 0, 2.0, 0.0)],
    "bulk": [pw.encode_bulk_request(7, [b"a", b"b", b"a", b"a"],
                                    np.array([1, 3, 2, 2]), 9.0, 0.0),
             pw.encode_bulk_request(8, [b"w", b"v"], np.array([5, 1]),
                                    *WINDOW, kind=pw.BULK_KIND_FWINDOW),
             pw.encode_bulk_request(9, [b"a", b"b"], np.array([1, 1]), 9.0,
                                    0.0, with_remaining=False)],
    "two_level": [pw.encode_request(10, pw.OP_ACQUIRE_H, "k", n, 40.0, 0.0,
                                    hier=("t", 12.0, 0.0, prio))
                  for n, prio in ((3, 0), (3, 2), (2, 1), (4, 0), (-1, 0))],
    "two_level_bulk": [pw.encode_bulk_request(
        11, [b"k", b"j", b"k"], np.array([2, 3, 4]), 40.0, 0.0,
        kind=pw.BULK_KIND_HBUCKET, hier=("t", 12.0, 0.0, p))
        for p in (0, 1, 2)],
    "reserve": [pw.encode_request(12, pw.OP_RESERVE, json.dumps(
        {"rid": f"q{i}", "tenant": "t", "key": "k", "estimate": est,
         "a": 40.0, "b": 0.0, "ta": 12.0, "tb": 0.0, "priority": prio}))
        for i, (est, prio) in enumerate(((4, 0), (None, 0), (3, 1),
                                         (2, 2), (9, 0)))],
    "settle_relay": [pw.encode_request(13, pw.OP_SETTLE, json.dumps(
        {"rid": rid, "tenant": t, "actual": a}))
        for rid, t, a in (("g1", "gt", 4.0), ("g1", "gt", 4.0),
                          ("nope", "gt", 1.0))],
}


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("lane", sorted(LANES))
def test_drain_gate_replies_match_jax(lane, backing):
    """Each lane's frames against a draining port server and a draining
    JAX server: the replies are equal byte for byte (envelope decisions,
    the deferral, the relayed settles), and so are the envelope's decision
    counts."""
    port = run(_armed(PORT, backing, LANES[lane]))
    jax = run(_armed(JAX, "serial", LANES[lane]))
    assert port == jax
    kinds = [pw.decode_response(r)[1] for r in port[0]]
    if lane == "settle_relay":
        outcomes = [json.loads(pw.decode_response(r)[2][0])["outcome"]
                    for r in port[0]]
        assert outcomes == ["settled", "duplicate", "unknown"]
        assert port[1] == 0
    else:
        assert port[1] > 0
    if lane == "scalar":
        # admission from the envelope; SEMA, PEEK, SYNC answer the deferral
        assert kinds[:6] == [pw.RESP_DECISION] * 6
        errs = [pw.decode_response(r)[2][0] for r in port[0][6:]]
        assert all(e.startswith(ppl.HANDOFF_DEFERRAL_PREFIX) for e in errs)


def test_settle_relay_failure_answers_the_deferral():
    """A relay to a successor that cannot be reached answers the handoff
    deferral, byte-equal to JAX's."""
    async def body(pk):
        clock = pk.Clock(START)
        back = pk.Serial(clock=clock)
        srv = pk.Server(back)
        await srv.start()
        dead = _dead(pk)
        conn = await asyncio.open_connection(srv.host, srv.port)
        try:
            srv._drain_envelope = pk.pl._FairShareEnvelope(0.5)
            srv._drain_successor = dead
            return await _one(conn, LANES["settle_relay"][0])
        finally:
            srv._drain_envelope = None
            conn[1].close()
            await _close([dead], [srv], [back])

    port, jax = run(body(PORT)), run(body(JAX))
    assert port == jax
    assert "settle relay to the drain successor failed" in \
        pw.decode_response(port)[2][0]


@pytest.mark.parametrize("backing", BACKINGS)
def test_native_bulk_lane_drain_gate_matches_jax(backing):
    """The native bulk lane (``NativeFrontend._serve_bulk``) while the
    server drains: every row from the shutdown envelope, the C job
    discarded, the replies byte-equal to the JAX asyncio server's and the
    port's asyncio lane's."""
    frames = (LANES["bulk"]
              + [pw.encode_bulk_request(20, [b"z"] * 6, np.ones(6), 4.0,
                                        0.0)])
    native = run(_armed(PORT, backing, frames, native=True))
    asyncio_lane = run(_armed(PORT, backing, frames))
    jax = run(_armed(JAX, "serial", frames))
    assert native == asyncio_lane == jax
    _seq, kind, (granted, _rem) = pw.decode_response(native[0][3])
    assert kind == pw.RESP_BULK
    assert list(granted) == [True, True, False, False, False, False]


# -- the console ------------------------------------------------------------------

CHILD_LINE_S = 120.0
CHILD_EXIT_S = 60.0


def _console(*args):
    """The console server as a child, its stdout read on a thread of its
    own so every wait is bounded."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributedratelimiting.redis_tpu_torch.runtime.server",
         "--port", "0", *args],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=ROOT)
    proc.err_file = err
    proc.lines = queue.Queue()

    def pump():
        for line in proc.stdout:
            proc.lines.put(line)
        proc.lines.put(None)

    proc.pump = threading.Thread(target=pump, daemon=True)
    proc.pump.start()
    return proc


def _address(proc):
    try:
        line = proc.lines.get(timeout=CHILD_LINE_S)
    except queue.Empty:
        raise AssertionError("no listening line from the console") from None
    assert line and line.startswith("bucket-store server listening on "), (
        line, proc.err_file.seek(0) or proc.err_file.read())
    host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)
    return host, int(port)


def _stop(proc) -> str:
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=CHILD_EXIT_S) == 0, (
        proc.err_file.seek(0) or proc.err_file.read())
    proc.pump.join(timeout=CHILD_EXIT_S)
    out = []
    while not proc.lines.empty():
        line = proc.lines.get_nowait()
        if line is not None:
            out.append(line)
    return "".join(out)


def _kill(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=CHILD_EXIT_S)
    proc.err_file.close()


@pytest.mark.parametrize("backend", ["inprocess", "device"])
def test_sigterm_drains_to_the_successor(backend):
    """``--drain-to HOST:PORT``: SIGTERM ships the source's state through
    the migration lane to the successor process, prints the summary, and
    the successor serves the shipped balances; a JAX client reads them."""
    args = ["--backend", backend]
    if backend == "device":
        args += ["--device", "cpu", "--slots", "1024"]
    succ = _console(*args)
    src = None
    try:
        succ_addr = _address(succ)
        src = _console(*args, "--drain-to", "%s:%d" % succ_addr)
        src_addr = _address(src)

        async def load():
            cli = JRemote(address=src_addr, coalesce_requests=False)
            try:
                for i in range(20):
                    await cli.acquire(f"k{i}", i % 10, 10.0, 0.0)
            finally:
                await cli.aclose()

        run(load())
        out = _stop(src)
        assert "SIGTERM: drain-and-handoff shutdown → " in out
        assert "shutdown complete: {'shipped_rows': 20" in out, out

        async def read():
            cli = JRemote(address=succ_addr, coalesce_requests=False)
            try:
                return [(await cli.acquire(f"k{i}", 0, 10.0, 0.0)).remaining
                        for i in range(20)]
            finally:
                await cli.aclose()

        # shipped = (10 − spent) − the 5-token envelope, floored at 0
        assert run(read()) == [max(0.0, 5.0 - i % 10) for i in range(20)]
        assert "shutdown complete: {'shipped_rows': 0" in _stop(succ)
    finally:
        if src is not None:
            _kill(src)
        _kill(succ)


# -- the JAX scenarios that drain ----------------------------------------------

_LLM_TENANTS = {"tenant:a": 6000.0, "tenant:b": 4000.0,
                "tenant:noisy": 3000.0}
_LLM_FILL = 1e-9
_LLM_CHILD = (100_000.0, 1e-9)


def _llm_rows(seed: int, n_rows: int = 900):
    """JAX ``tests/test_llm_admission.py::_soak_schedule``."""
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        r = rng.random()
        if r < 0.5:
            tenant, prio = "tenant:noisy", PRIORITY_SCAVENGER
        elif r < 0.8:
            tenant = "tenant:a"
            prio = (PRIORITY_INTERACTIVE if rng.random() < 0.8
                    else PRIORITY_BATCH)
        else:
            tenant = "tenant:b"
            prio = (PRIORITY_BATCH if rng.random() < 0.7
                    else PRIORITY_INTERACTIVE)
        key = f"{tenant}/u{rng.zipf(1.5) % 40}"
        cost = int(min(max(rng.lognormal(3.0, 1.3), 1.0), 2000.0))
        rows.append((tenant, key, cost, prio, rng.random() < 0.25))
    return rows


async def _llm_drive(store, rows) -> list:
    out = []
    i = 0
    while i < len(rows):
        tenant, key, cost, prio, bulk = rows[i]
        if bulk:
            j, ks, cs = i, [], []
            while (j < len(rows) and rows[j][0] == tenant
                   and rows[j][4] and j - i < 8):
                ks.append(rows[j][1])
                cs.append(rows[j][2])
                j += 1
            res = await store.acquire_hierarchical_many(
                [tenant] * len(ks), ks, cs, _LLM_TENANTS[tenant], _LLM_FILL,
                *_LLM_CHILD, priority=prio)
            out.extend(bool(g) for g in res.granted)
            i = j
        else:
            r = await store.acquire_hierarchical(
                tenant, key, cost, _LLM_TENANTS[tenant], _LLM_FILL,
                *_LLM_CHILD, priority=prio)
            out.append(r.granted)
            i += 1
    return out


async def _llm_drain(pk):
    """JAX ``tests/test_llm_admission.py:421-445``: envelope serving in a
    drain window sheds scavenger first, spends on interactive, and stays
    within the tenant's envelope. Returns the outcomes by priority, the
    admitted tokens and the successor's tenant balance."""
    rows = _llm_rows(20260804)
    clock = pk.Clock(START)
    (sb, db), (src, dst) = await _pair(pk, "serial", clock)
    store = pk.Remote(address=(src.host, src.port), coalesce_requests=False)
    successor = pk.Remote(address=(dst.host, dst.port),
                          coalesce_requests=False)
    outcomes = {0: [], 1: [], 2: []}
    admitted = [0.0]

    async def window():
        for i in range(90):
            prio = (PRIORITY_INTERACTIVE, PRIORITY_BATCH,
                    PRIORITY_SCAVENGER)[i % 3]
            r = await store.acquire_hierarchical(
                "tenant:a", f"tenant:a/e{i % 6}", 40,
                _LLM_TENANTS["tenant:a"], _LLM_FILL, *_LLM_CHILD,
                priority=prio)
            outcomes[prio].append(bool(r.granted))
            if r.granted:
                admitted[0] += 40

    try:
        pre = await _llm_drive(store, rows[:120])
        summary = await src.shutdown(_Hooked(successor, window),
                                     window_s=0.0)
        tenant_bal = db.peek_blocking("tenant:a", _LLM_TENANTS["tenant:a"],
                                      _LLM_FILL)
        return [pre, outcomes, admitted[0], summary["envelope_decisions"],
                tenant_bal]
    finally:
        await _close([store, successor], [src, dst], [sb, db])


def test_llm_drain_window_sheds_scavenger_first(_frozen_envelope):
    port, jax = run(_llm_drain(PORT)), run(_llm_drain(JAX))
    assert port[:4] == jax[:4]
    assert _ulps(port[4], jax[4])
    outcomes = port[1]
    assert not any(outcomes[PRIORITY_SCAVENGER])
    assert any(outcomes[PRIORITY_INTERACTIVE])
    assert (sum(outcomes[PRIORITY_INTERACTIVE])
            >= sum(outcomes[PRIORITY_BATCH]))
    env_budget = headroom_budget(_LLM_TENANTS["tenant:a"], fraction=0.5,
                                 min_budget=1.0)
    assert port[2] <= env_budget


# The reservation streaming soak (JAX tests/test_reservations.py:642-840).

_RES_TENANTS = {"tenant:a": 3_000.0, "tenant:b": 2_000.0}
_RES_NEW_A = 2_400.0
_RES_FILL = 1e-9
_RES_CHILD = (1e6, 1e-9)


def _chaos_rules(pk):
    FaultRule = pk.faults.FaultRule
    return {
        "client.connect": (
            FaultRule("reset", probability=0.08),
            FaultRule("delay", probability=0.2, delay_s=0.001,
                      jitter_s=0.002)),
        "server.dispatch": (
            FaultRule("delay", probability=0.05, delay_s=0.002,
                      jitter_s=0.002),),
    }


def _res_rows(seed: int, n_rows: int = 220):
    rng = np.random.default_rng(seed)
    rows = []
    for _ in range(n_rows):
        tenant = "tenant:a" if rng.random() < 0.6 else "tenant:b"
        key = f"{tenant}/u{rng.zipf(1.5) % 30}"
        actual = float(min(max(rng.lognormal(3.2, 1.1), 1.0), 2000.0))
        estimate = float(max(actual * rng.lognormal(0.0, 0.55), 1.0))
        prio = int(rng.random() < 0.3)
        dies = rng.random() < 0.05
        rows.append((tenant, key, actual, estimate, prio, dies))
    return rows


async def _res_soak(pk, seed: int) -> dict:
    """JAX ``_soak_once``: reserve/settle under wire chaos, a live config
    mutation, then a drain mid-stream whose settles relay; the audit."""
    rows = _res_rows(seed)
    inj = pk.faults.FaultInjector(seed, _chaos_rules(pk))
    pk.faults.install(inj)
    ba = pk.Serial(clock=pk.Clock())
    bb = pk.Serial(clock=pk.Clock())
    srv_a, srv_b = pk.Server(ba), pk.Server(bb)
    await srv_a.start()
    await srv_b.start()
    client = pk.Remote(address=(srv_a.host, srv_a.port),
                       coalesce_requests=False, resilience_seed=seed)
    successor = pk.Remote(address=(srv_b.host, srv_b.port),
                          coalesce_requests=False, resilience_seed=seed + 1)
    grants, dead, settled_rids, open_rids = [], [], [], []
    settled = {t: 0.0 for t in _RES_TENANTS}
    relayed = [0]

    async def drive(rows_slice, offset, hold=()):
        for j, (tenant, key, actual, est, prio, dies) in \
                enumerate(rows_slice):
            i = offset + j
            rid = f"r{i}"
            r = await client.reserve(rid, tenant, key, est,
                                     _RES_TENANTS[tenant], _RES_FILL,
                                     *_RES_CHILD, priority=prio)
            grants.append(bool(r.granted))
            if not r.granted:
                continue
            if dies:
                dead.append((rid, tenant))
                continue
            if i in hold:
                open_rids.append((rid, tenant, actual))
                continue
            s = await client.settle(rid, tenant, actual)
            if s.outcome == "settled":
                settled[tenant] += actual
                settled_rids.append((rid, tenant))

    try:
        await drive(rows[:120], 0, hold=set(range(105, 120)))
        led = srv_a.reservations
        for tenant, cap in _RES_TENANTS.items():
            entry = ba._buckets.get((tenant, cap, _RES_FILL))
            balance = entry[0] if entry is not None else cap
            rhs = (led.outstanding_by_tenant().get(tenant, 0.0)
                   + settled[tenant] - led.debts().get(tenant, 0.0))
            assert cap - balance == pytest.approx(rhs, abs=1e-3), tenant
        await client.config_announce({
            "prepare": {"kind": "bucket",
                        "old": [_RES_TENANTS["tenant:a"], _RES_FILL],
                        "new": [_RES_NEW_A, _RES_FILL]}, "version": 1})
        await client.config_announce({"commit": 1})
        for rid, tenant, actual in list(open_rids):
            if int(rid[1:]) < 110:
                continue
            s = await client.settle(rid, tenant, actual)
            if s.outcome == "settled":
                settled[tenant] += actual
                settled_rids.append((rid, tenant))
            open_rids.remove((rid, tenant, actual))
        await drive(rows[120:170], 120)
        still_open = list(open_rids)
        assert still_open, "the schedule lost its drain-open holds"

        async def relay():
            # Two outstanding holds settle THROUGH the draining server;
            # the relay reaches the successor's migrated ledger.
            for rid, tenant, actual in still_open[:2]:
                assert rid in srv_b.reservations._entries, rid
                s = await client.settle(rid, tenant, actual)
                if s.outcome == "settled":
                    settled[tenant] += actual
                    settled_rids.append((rid, tenant))
                    relayed[0] += 1

        await srv_a.shutdown(_Hooked(successor, relay), window_s=0.2)
        assert relayed[0] == 2
        for rid, tenant, actual in still_open[2:]:
            if rid in srv_b.reservations._entries:
                s = await successor.settle(rid, tenant, actual)
                if s.outcome == "settled":
                    settled[tenant] += actual
                    settled_rids.append((rid, tenant))
        led_b = srv_b.reservations
        refunded_before = led_b.refunded_tokens + led.refunded_tokens
        for rid, tenant in settled_rids[:20]:
            target = led_b if rid in led_b._settled else led
            s = await target.settle(rid, tenant, 99999.0)
            assert s.outcome == "duplicate", rid
        assert led_b.refunded_tokens + led.refunded_tokens == \
            pytest.approx(refunded_before)
        migrated_dead = [rid for rid, _t in dead if rid in led_b._entries]
        if migrated_dead:
            led_b._clock = (lambda base=led_b._clock: base() + 1e6)
            assert led_b.expire() >= len(migrated_dead)
            for rid in migrated_dead:
                assert rid not in led_b._entries
        for tenant, cap in _RES_TENANTS.items():
            env = pk.headroom(cap, fraction=0.5, min_budget=1.0)
            debt = (led.debts().get(tenant, 0.0)
                    + led_b.debts().get(tenant, 0.0))
            assert settled[tenant] - debt <= cap + env + 1e-6, tenant
        return {
            "grants": grants, "settled": dict(settled),
            "reserves": led.reserves + led_b.reserves,
            "settles": led.settles + led_b.settles,
            "refunded": round(led.refunded_tokens + led_b.refunded_tokens,
                              3),
            "debt_created": round(led.debt_tokens_created
                                  + led_b.debt_tokens_created, 3),
            "rehomed": led.rehomed + led_b.rehomed,
            "relayed": relayed[0], "expired": led_b.ttl_expired,
        }
    finally:
        pk.faults.uninstall()
        await _close([client, successor], [srv_a, srv_b], [ba, bb])


def test_reservation_streaming_soak_drains_like_jax():
    """JAX ``test_reservation_streaming_soak`` on port servers (the relay
    sent from inside the drain): the same grants and ledger accounting as
    the JAX run of the seed, and the port's second run equal to its first
    (determinism)."""
    seed = 20260804
    port = run(_res_soak(PORT, seed), 120.0)
    assert any(port["grants"]) and not all(port["grants"])
    assert port["refunded"] > 0 and port["settles"] > 0
    assert port["rehomed"] >= 1 and port["relayed"] == 2
    assert run(_res_soak(PORT, seed), 120.0) == port
    assert run(_res_soak(JAX, seed), 120.0) == port


class _RecordingSerial(InProcessBucketStore):
    """The port's serial store stamping every authoritative admission:
    envelope decisions never reach a store."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.admissions: list = []

    async def acquire(self, key, count, capacity, fill_rate_per_sec):
        res = await super().acquire(key, count, capacity, fill_rate_per_sec)
        self.admissions.append((key, bool(res.granted and count > 0)))
        return res


@pytest.mark.parametrize("coordinator", ["jax", "port"])
def test_rolling_restart_soak_over_port_servers(coordinator):
    """JAX ``TestRollingRestartSoak``, its nodes port servers under either
    package's ``ClusterBucketStore``: every node drains to a successor
    process one at a time under wire chaos and live traffic, a limit
    mutates mid-roll; no unique-key acquire is admitted twice over the
    stores' own records, the hot key stays within its cap plus one
    envelope a restart. The coordinator's package owns the client seams,
    so its injector's realized schedule is the one held to its preview."""
    seed = 20260803
    pk = JAX if coordinator == "jax" else PORT
    Cluster = JCluster if coordinator == "jax" else ClusterBucketStore
    rules = _chaos_rules(pk)

    async def main():
        jinj = jfaults.FaultInjector(seed, _chaos_rules(JAX))
        pinj = pfaults.FaultInjector(seed, _chaos_rules(PORT))
        jfaults.install(jinj)
        pfaults.install(pinj)
        inj = jinj if coordinator == "jax" else pinj
        cap_hot, new_cap = 40.0, 24.0
        generations = [[_RecordingSerial()] for _ in range(3)]
        servers = [BucketStoreServer(g[0]) for g in generations]
        for s in servers:
            await s.start()
        cluster = Cluster(
            addresses=[(s.host, s.port) for s in servers],
            coalesce_requests=False, request_timeout_s=1.0,
            reconnect_backoff_base_s=0.004, resilience_seed=seed)
        net = (ConnectionError, OSError, JTimeout, jwire.RemoteStoreError,
               StoreTimeoutError, pw.RemoteStoreError)
        tally = {"hot": 0, "cold_ok": 0, "cold_n": 0, "shipped": 0}
        stop = asyncio.Event()

        async def drive():
            i = 0
            while not stop.is_set():
                i += 1
                for key, cap, rate, name in (
                        ("hot", cap_hot, 1e-9, "hot"),
                        (f"u{i}", 1.0, 1e-9, None),
                        (f"cold{i % 16}", 1e6, 1.0, "cold_ok")):
                    if name == "cold_ok":
                        tally["cold_n"] += 1
                    try:
                        r = await cluster.acquire(key, 1, cap, rate)
                        if name is not None:
                            tally[name] += bool(r.granted)
                    except Exception as exc:  # noqa: BLE001
                        if not isinstance(exc, net):
                            raise
                await asyncio.sleep(0)

        async def roll(j):
            new_back = _RecordingSerial()
            new_srv = BucketStoreServer(new_back)
            await new_srv.start()
            succ = RemoteBucketStore(address=(new_srv.host, new_srv.port),
                                     coalesce_requests=False)
            try:
                summary = await servers[j].shutdown(successor=succ,
                                                    window_s=0.25)
            finally:
                await succ.aclose()
            tally["shipped"] += summary["shipped_rows"]
            generations[j].append(new_back)
            servers[j] = new_srv
            await cluster.replace_node(j, address=(new_srv.host,
                                                   new_srv.port))

        async def upgrade():
            await asyncio.sleep(0.15)
            await roll(0)
            await asyncio.sleep(0.10)
            assert await cluster.mutate_config(
                "bucket", (cap_hot, 1e-9), (new_cap, 1e-9)) == 1
            await asyncio.sleep(0.10)
            await roll(1)
            await asyncio.sleep(0.10)
            await roll(2)
            await asyncio.sleep(0.15)
            stop.set()

        traffic = asyncio.ensure_future(drive())
        try:
            await asyncio.wait_for(upgrade(), 60.0)
            await traffic
        finally:
            traffic.cancel()
            await asyncio.gather(traffic, return_exceptions=True)
        try:
            assert all(len(g) == 2 for g in generations)
            assert tally["shipped"] >= 1
            assert cluster.config_mutations == 1
            assert all(s.liveconfig.version == 1 for s in servers)
            assert sum(s.liveconfig.moved_errors for s in servers) >= 1
            grants: dict = {}
            for gen in generations:
                for store in gen:
                    for key, granted in store.admissions:
                        if granted and key.startswith("u"):
                            grants[key] = grants.get(key, 0) + 1
            assert {k: n for k, n in grants.items() if n > 1} == {}
            assert len(grants) >= 50, "the audit must not be vacuous"
            budget = headroom_budget(cap_hot, fraction=0.5, min_budget=1.0)
            assert tally["hot"] <= cap_hot + budget * 3, tally
            assert tally["hot"] >= 10
            assert tally["cold_ok"] >= tally["cold_n"] * 0.5
            for node in cluster.nodes:
                assert node._pending == {}
            for seam in rules:
                realized = [e for e in inj.events if e.seam == seam]
                assert realized == inj.schedule_preview(
                    seam, inj.occurrence_count(seam))
        finally:
            jfaults.uninstall()
            pfaults.uninstall()
            await cluster.aclose()
            for s in servers:
                await s.aclose()

    run(main(), 120.0)
