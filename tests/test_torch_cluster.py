"""The port's ``ClusterBucketStore`` against the JAX package's, on the CPU.

Each scenario is written once and run twice: the port's cluster over port
servers (their stores the serial store or ``DeviceBucketStore(device=
"cpu")``, the kernels' plain versions) and JAX's cluster over JAX servers
over the matching JAX store, on one seeded stream. Grants, counts, routes,
breaker transitions, epochs, every ``remaining`` and every balance are
compared at tolerance 0 (rate 1 token/s on whole-tick clocks: every
balance is a whole number, so both packages' float32 rules agree exactly).

- **Routing, bulk split and merge, roll-ups.** ``node_index_of`` and the
  placement route; ``acquire_many`` / ``window_acquire_many`` /
  ``acquire_hierarchical_many`` fanned out over three nodes; every keyed
  single op, reserve/settle and the blocking peek; ``stats()``'
  cluster-level sections and per-node totals; the cluster's own
  OpenMetrics families byte for byte, and ``cluster_metrics()``'s summed
  series equal to the sum of its per-node series.
- **An outage.** One node's server stops (its store kept): unit asks on
  its keys against an injected ``breaker_clock``, ``deny`` and degraded
  bulk rows, the breaker's transitions (flight frames and the
  ``drl_cluster_breaker_state`` gauge), a restart on the same port, the
  probe that re-closes the breaker and the rejoin debit, after which every
  such key's balance is its pre-outage balance less its degraded grants.
- **Membership.** ``add_node``, ``split_hot_key``, ``drain_node``,
  ``rejoin_node``, ``rebalance``, ``mutate_config`` and ``split_hot_keys``
  over in-process nodes (``stores=``) and over servers; ``migration_log``
  compared field by field, its timestamps left out.
- **The MOVED chase.** A second client holding epoch 0: each keyed lane
  (single op, blocking peek, submitter, bulk fan-out) chases one
  ``placement moved`` and lands on the new owner.
- Construction errors, snapshot and restore, and the two resilience
  pieces alone (``CircuitBreaker``, the degraded keyspace) on seeded
  streams.
"""

from __future__ import annotations

import asyncio
import json
import types

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime import cluster as jcl
from distributedratelimiting.redis_tpu.runtime import liveconfig as jlc
from distributedratelimiting.redis_tpu.runtime import placement as jpl
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
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
from distributedratelimiting.redis_tpu.utils import metrics as jmetrics
from distributedratelimiting.redis_tpu.utils import resilience as jres
from distributedratelimiting.redis_tpu.utils.flight_recorder import (
    FlightRecorder as JFlight,
)
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    ClusterBucketStore,
    DeviceBucketStore,
    InProcessBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
)
from distributedratelimiting.redis_tpu_torch.runtime import cluster as pcl
from distributedratelimiting.redis_tpu_torch.runtime import liveconfig as plc
from distributedratelimiting.redis_tpu_torch.runtime import placement as ppl
from distributedratelimiting.redis_tpu_torch.utils import metrics as pmetrics
from distributedratelimiting.redis_tpu_torch.utils import resilience as pres
from distributedratelimiting.redis_tpu_torch.utils.flight_recorder import (
    FlightRecorder,
)

torch.set_num_threads(1)

START = 1_000_000
LIMIT_S = 90.0
CAP, RATE = 10.0, 1.0

PORT = types.SimpleNamespace(
    name="port", cl=pcl, pl=ppl, lc=plc, res=pres, metrics=pmetrics,
    Cluster=ClusterBucketStore, Server=BucketStoreServer,
    Serial=InProcessBucketStore, Clock=ManualClock, Flight=FlightRecorder,
    device=lambda clock: DeviceBucketStore(device="cpu", clock=clock,
                                           n_slots=1024, counter_slots=256))
JAX = types.SimpleNamespace(
    name="jax", cl=jcl, pl=jpl, lc=jlc, res=jres, metrics=jmetrics,
    Cluster=jcl.ClusterBucketStore, Server=JServer, Serial=JSerial,
    Clock=JClock, Flight=JFlight,
    device=lambda clock: JDevice(clock=clock, n_slots=1024))
PKGS = (PORT, JAX)
BACKINGS = ("serial", "device")


def run(coro, limit_s: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit_s))


def _store(pk, backing: str, clock):
    return pk.Serial(clock=clock) if backing == "serial" else pk.device(clock)


def _server(pk, store, **kw):
    """A server whose placement state sits on a frozen clock, so handoff
    envelopes refill nothing and windows never expire mid-scenario."""
    srv = pk.Server(store, **kw)
    srv.placement = pk.pl.NodePlacementState(clock=lambda: 50.0)
    return srv


async def _fleet(pk, backing, n, clock):
    stores = [_store(pk, backing, clock) for _ in range(n)]
    servers = [_server(pk, s) for s in stores]
    for s in servers:
        await s.start()
    return stores, servers


async def _close(cluster, servers, stores):
    await cluster.aclose()
    for s in servers:
        await s.aclose()
    for s in stores:
        await s.aclose()


def _outcome(res):
    return (bool(res.granted), float(res.remaining))


def _bulk(res):
    return (np.asarray(res.granted).tolist(),
            None if res.remaining is None
            else np.asarray(res.remaining, np.float32).tolist())


def _families(text: str, prefix: str) -> str:
    """The lines of one family prefix, in order (a stable slice of an
    exposition whose other families carry per-process values)."""
    return "\n".join(ln for ln in text.splitlines()
                     if ln.split(" ", 1)[0].split("{")[0].startswith(prefix)
                     or ln.startswith(f"# TYPE {prefix}")
                     or ln.startswith(f"# HELP {prefix}"))


# -- routing, bulk split and merge, roll-ups ----------------------------------

async def _traffic(pk, backing: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    clock = pk.Clock(START)
    stores, servers = await _fleet(pk, backing, 3, clock)
    cluster = pk.Cluster(addresses=[(s.host, s.port) for s in servers],
                         coalesce_requests=False, request_timeout_s=20.0,
                         retry_policy=None)
    keys = [f"k{i}" for i in range(150)]
    out: dict = {}
    try:
        out["routes"] = cluster.placement.route(keys).tolist()
        out["index"] = [cluster.node_index_of(k) for k in keys]
        assert out["routes"] == out["index"]
        rows = [keys[i] for i in rng.integers(0, len(keys), 400)]
        counts = rng.integers(1, 4, 400)
        out["bulk"] = _bulk(await cluster.acquire_many(rows, counts, CAP,
                                                       RATE))
        clock.advance_seconds(2.0)
        rows2 = [keys[i] for i in rng.integers(0, len(keys), 300)]
        out["bulk_bits"] = _bulk(await cluster.acquire_many(
            rows2, rng.integers(1, 4, 300), CAP, RATE,
            with_remaining=False))
        wkeys = [f"w{i}" for i in rng.integers(0, 40, 200)]
        for fixed in (False, True):
            out[f"windows_{fixed}"] = _bulk(await cluster.window_acquire_many(
                wkeys, [1] * len(wkeys), 4.0, 2.0, fixed=fixed))
        tenants = [f"t{i}" for i in rng.integers(0, 5, 200)]
        hkeys = [f"{t}/u{i}" for t, i in zip(tenants,
                                             rng.integers(0, 6, 200))]
        out["hier"] = _bulk(await cluster.acquire_hierarchical_many(
            tenants, hkeys, rng.integers(1, 4, 200), 40.0, RATE, CAP, RATE))
        singles = []
        for step in range(60):
            k = keys[int(rng.integers(0, len(keys)))]
            op = step % 6
            if op == 0:
                r = _outcome(await cluster.acquire(k, int(rng.integers(0, 4)),
                                                   CAP, RATE))
            elif op == 1:
                r = _outcome(await cluster.window_acquire(f"w{step % 7}", 1,
                                                          4.0, 2.0))
            elif op == 2:
                r = _outcome(await cluster.fixed_window_acquire(
                    f"f{step % 5}", 1, 3.0, 2.0))
            elif op == 3:
                s = await cluster.sync_counter(f"c{step % 4}", 2.0, 1.0)
                r = (float(s.global_score),)
            elif op == 4:
                r = _outcome(await cluster.concurrency_acquire(
                    f"s{step % 3}", 1, 2))
                await cluster.concurrency_release(f"s{(step + 1) % 3}", 1)
            else:
                r = _outcome(await cluster.acquire_hierarchical(
                    "t9", f"t9/u{step % 4}", 2, 30.0, RATE, CAP, RATE))
            singles.append(r)
            if step % 10 == 9:
                clock.advance_seconds(1.0)
        out["singles"] = singles
        resv = []
        for i in range(6):
            rr = await cluster.reserve(f"r{i}", "t1", f"t1/q{i % 2}", 5.0,
                                       100.0, RATE, 50.0, RATE)
            resv.append((bool(rr.granted), float(rr.reserved)))
            st = await cluster.settle(f"r{i}", "t1", float(i))
            resv.append(str(getattr(st, "outcome", st)))
        out["reserve"] = resv
        out["peeks"] = [await asyncio.to_thread(cluster.peek_blocking, k,
                                                CAP, RATE)
                        for k in keys[:24]]
        sub = cluster.acquire_submitter(CAP, RATE)
        out["submit"] = [_outcome(await sub(k, 1)) for k in keys[:12]]
        st = await cluster.stats()
        out["stats"] = {k: st[k] for k in ("n_nodes", "resilience",
                                           "placement", "config")}
        served = [n["requests_served"] for n in st["nodes"]]
        assert st["total"]["requests_served"] == sum(served)
        out["served"] = served
        text = await cluster.cluster_metrics()
        _types, samples = pk.metrics.parse_openmetrics(text)
        per_node = [v for name, labels, v in samples
                    if name == "drl_requests_served_total"
                    and dict(labels).get("node") is not None]
        total = [v for name, labels, v in samples
                 if name == "drl_requests_served_total"
                 and dict(labels).get("node") is None]
        assert len(per_node) == 3 and total == [sum(per_node)]
        out["metrics_served"] = per_node
        out["own_metrics"] = cluster.metrics_registry().render()
        out["cluster_families"] = _families(text, "drl_cluster_")
    finally:
        await _close(cluster, servers, stores)
    return out


@pytest.mark.parametrize("backing", BACKINGS)
def test_routing_bulk_and_rollups_match_jax(backing):
    mine = run(_traffic(PORT, backing, 7))
    theirs = run(_traffic(JAX, backing, 7))
    assert set(mine) == set(theirs)
    for k in mine:
        assert mine[k] == theirs[k], k
    assert any(mine["bulk"][0]) and not all(mine["bulk"][0])
    assert set(mine["routes"]) == {0, 1, 2}


# -- an outage: breakers, deny/degraded rows, the rejoin debit -----------------

async def _outage(pk, backing: str, degraded: bool, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    clock = pk.Clock(START)
    stores, servers = await _fleet(pk, backing, 3, clock)
    addrs = [(s.host, s.port) for s in servers]
    bt = [0.0]
    fr = pk.Flight(256)
    cluster = pk.Cluster(
        addresses=addrs, coalesce_requests=False, request_timeout_s=5.0,
        retry_policy=None, reconnect_backoff_base_s=0.001,
        reconnect_backoff_max_s=0.05,
        breaker=pk.res.BreakerConfig(failure_threshold=3,
                                     recovery_timeout_s=5.0),
        breaker_clock=lambda: bt[0], degraded_fallback=degraded,
        partial_failures="deny", flight_recorder=fr)
    if cluster._degraded is not None:
        cluster._degraded._clock = lambda: 0.0  # a frozen envelope
    keys = [f"o{i}" for i in range(90)]
    out: dict = {}
    try:
        pre = rng.integers(1, 4, len(keys))
        await cluster.acquire_many(keys, pre, CAP, RATE)
        on1 = [k for k in keys if cluster.node_index_of(k) == 1]
        others = [k for k in keys if cluster.node_index_of(k) != 1]
        await servers[1].aclose()
        asks = []
        for k in on1[:12]:
            for _ in range(int(rng.integers(1, 4))):
                try:
                    asks.append(_outcome(await cluster.acquire(k, 1, CAP,
                                                               RATE)))
                except pk.cl.NodeUnavailableError:
                    asks.append("shed")
                except Exception:  # noqa: BLE001
                    asks.append("error")
        out["asks"] = asks
        out["bulk"] = _bulk(await cluster.acquire_many(
            keys, [1] * len(keys), CAP, RATE))
        out["metrics_open"] = _families(cluster.metrics_registry().render(),
                                        "drl_cluster_")
        out["resilience_open"] = (await cluster.stats())["resilience"]
        out["shed"], out["degraded"] = (cluster.shed,
                                        cluster.degraded_decisions)
        # Restart over the same store on the same port.
        servers[1] = _server(pk, stores[1], port=addrs[1][1])
        await servers[1].start()
        # The node's client dials again once its reconnect backoff ends.
        for _ in range(500):
            if not cluster.nodes[1].resilience_stats()["backing_off"]:
                break
            await asyncio.sleep(0.01)
        bt[0] += 6.0
        # The probe's own reading races the background rejoin debit (in
        # either package): only its grant is compared.
        out["probe"] = bool((await cluster.acquire(on1[0], 0, CAP,
                                                   RATE)).granted)
        # The rejoin debit runs in the background on the cluster's loop.
        for _ in range(1000):
            if not cluster._bg_tasks:
                break
            await asyncio.sleep(0.01)
        out["rejoin_debits"] = cluster.rejoin_debits
        out["balances"] = [float((await cluster.acquire(k, 0, CAP,
                                                        RATE)).remaining)
                           for k in keys]
        out["on1"] = on1
        out["others"] = others
        out["pre"] = pre.tolist()
        out["transitions"] = [(f["node"], f["old"], f["new"])
                              for f in fr.frames(kind="breaker")]
        out["metrics_closed"] = _families(
            cluster.metrics_registry().render(), "drl_cluster_")
    finally:
        await _close(cluster, servers, stores)
    return out


@pytest.mark.parametrize("degraded", [True, False])
@pytest.mark.parametrize("backing", BACKINGS)
def test_outage_breaker_and_rejoin_match_jax(backing, degraded):
    mine = run(_outage(PORT, backing, degraded, 11))
    theirs = run(_outage(JAX, backing, degraded, 11))
    for k in mine:
        assert mine[k] == theirs[k], k
    # The breaker opened after its threshold and one probe re-closed it.
    assert mine["transitions"] == [(1, "closed", "open"),
                                   (1, "open", "half_open"),
                                   (1, "half_open", "closed")]
    assert 'drl_cluster_breaker_state{node="1"} 2' in mine["metrics_open"]
    assert 'drl_cluster_breaker_state{node="1"} 0' in mine["metrics_closed"]
    keys = [f"o{i}" for i in range(90)]
    pre = dict(zip(keys, mine["pre"]))
    granted, remaining = mine["bulk"]
    idx = {k: i for i, k in enumerate(keys)}
    # Nodes 0 and 2 decide exactly; node 1's rows follow deny/degraded.
    for k in mine["others"]:
        assert granted[idx[k]] and remaining[idx[k]] == CAP - pre[k] - 1
    if not degraded:
        assert all(not granted[idx[k]] and remaining[idx[k]] == 0.0
                   for k in mine["on1"])
        assert "shed" in mine["asks"] and mine["rejoin_debits"] == 0
        for k in mine["on1"]:
            assert mine["balances"][idx[k]] == CAP - pre[k]
        return
    # Degraded: each key admits at most its envelope budget, and the
    # rejoin debit charged the node for every degraded grant. The ask
    # schedule replays from the seed to attribute each ask to its key.
    assert all(r not in ("shed", "error") for r in mine["asks"])
    budget = headroom_budget(CAP, fraction=0.5, min_budget=1.0)
    rng = np.random.default_rng(11)
    rng.integers(1, 4, len(keys))
    grants = {k: int(granted[idx[k]]) for k in mine["on1"]}
    pos = 0
    for k in mine["on1"][:12]:
        n = int(rng.integers(1, 4))
        grants[k] += sum(1 for r in mine["asks"][pos:pos + n] if r[0])
        pos += n
    assert pos == len(mine["asks"]) and sum(grants.values()) > 0
    for k in mine["on1"]:
        assert grants[k] <= budget
        assert mine["balances"][idx[k]] == max(0.0, CAP - pre[k]
                                               - grants[k])
    assert mine["rejoin_debits"] == sum(1 for v in grants.values() if v)


# -- membership: join, split, drain, rejoin, rebalance, mutate -----------------

def _log(cluster) -> list:
    return [{k: v for k, v in e.items() if k not in ("t_start", "t_end")}
            for e in cluster.migration_log]


async def _membership(pk, lane: str, backing: str, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    clock = pk.Clock(START)
    if lane == "stores":
        stores = [_store(pk, backing, clock) for _ in range(4)]
        servers = []
        cluster = pk.Cluster(stores=stores[:3])
        fourth = {"store": stores[3]}
    else:
        stores, servers = await _fleet(pk, backing, 4, clock)
        addrs = [(s.host, s.port) for s in servers]
        cluster = pk.Cluster(addresses=addrs[:3], coalesce_requests=False,
                             request_timeout_s=20.0, retry_policy=None,
                             handoff_window_s=60.0)
        fourth = {"address": addrs[3]}
    keys = [f"m{i}" for i in range(100)]
    out: dict = {}

    async def traffic(n):
        got = []
        for i in rng.integers(0, len(keys), n).tolist():
            r = await cluster.acquire(keys[i], int(rng.integers(1, 3)),
                                      12.0, RATE)
            got.append(_outcome(r))
        got.append(_outcome(await cluster.window_acquire("mw", 1, 6.0, 4.0)))
        return got

    async def balances():
        return [float((await cluster.acquire(k, 0, 12.0, RATE)).remaining)
                for k in keys]

    try:
        out["t0"] = await traffic(120)
        out["join"] = await cluster.add_node(**fourth)
        out["b_join"] = await balances()
        out["t1"] = await traffic(60)
        out["split"] = await cluster.split_hot_key("m3")
        out["split_owner"] = cluster.node_index_of("m3")
        out["drain"] = await cluster.drain_node(1)
        out["b_drain"] = await balances()
        out["rejoin"] = await cluster.rejoin_node(1)
        out["rebalance"] = await cluster.rebalance()
        out["t2"] = await traffic(60)
        out["version"] = await cluster.mutate_config(
            "bucket", (12.0, RATE), (20.0, RATE))
        out["t3"] = await traffic(40)
        out["b_config"] = [float((await cluster.acquire(k, 0, 20.0,
                                                        RATE)).remaining)
                           for k in keys]
        if lane == "remote":
            for _ in range(30):
                await cluster.acquire("hot-one", 3, 1e6, RATE)
            out["split_keys"] = await cluster.split_hot_keys(top_n=1)
        out["log"] = _log(cluster)
        out["routes"] = cluster.placement.route(keys).tolist()
        out["overrides"] = dict(cluster.placement.overrides)
        st = await cluster.stats()
        out["stats"] = {k: st[k] for k in ("placement", "config")}
        out["counters"] = (cluster.migrations, cluster.migration_aborts,
                           cluster.config_mutations, cluster.config_aborts,
                           cluster.config_rebased_rows)
    finally:
        await _close(cluster, servers, stores)
    return out


@pytest.mark.parametrize("lane", ["stores", "remote"])
@pytest.mark.parametrize("backing", BACKINGS)
def test_membership_and_migration_log_match_jax(lane, backing):
    mine = run(_membership(PORT, lane, backing, 3))
    theirs = run(_membership(JAX, lane, backing, 3))
    assert set(mine) == set(theirs)
    for k in mine:
        if k == "log":
            assert len(mine[k]) == len(theirs[k])
            for a, b in zip(mine[k], theirs[k]):
                assert a == b
        else:
            assert mine[k] == theirs[k], k
    assert mine["join"] == 3 and mine["version"] == 1
    assert [e["type"] for e in mine["log"]][:4] == ["commit"] * 4
    assert mine["log"][-1]["type"] == ("commit" if lane == "remote"
                                       else "config_commit")
    if lane == "remote":
        assert mine["split_keys"] == ["hot-one"]


# -- the MOVED chase on every keyed lane ---------------------------------------

async def _chase(pk, backing: str) -> dict:
    clock = pk.Clock(START)
    stores, servers = await _fleet(pk, backing, 4, clock)
    addrs = [(s.host, s.port) for s in servers]
    kw = dict(coalesce_requests=False, request_timeout_s=20.0,
              retry_policy=None, handoff_window_s=60.0)
    coord = pk.Cluster(addresses=addrs[:3], **kw)
    stale_map = pk.pl.PlacementMap.initial(3)
    stale = pk.Cluster(addresses=addrs, placement=stale_map,
                       partial_failures="deny", **kw)
    refreshes = [0]
    real = stale.refresh_placement

    async def counted():
        refreshes[0] += 1
        return await real()

    stale.refresh_placement = counted
    keys = [f"v{i}" for i in range(160)]
    out: dict = {}
    try:
        await coord.acquire_many(keys, [2] * len(keys), CAP, RATE)
        await coord.add_node(address=addrs[3])
        moved = [k for k in keys
                 if coord.node_index_of(k) != stale_map.node_of(k)]
        out["n_moved"] = len(moved)
        single = []
        for k in moved[:10]:
            stale.placement = stale_map
            refreshes[0] = 0
            r = await stale.acquire(k, 1, CAP, RATE)
            single.append((_outcome(r), refreshes[0],
                           stale.node_index_of(k) == coord.node_index_of(k)))
        out["single"] = single
        peeks = []
        for k in moved[10:16]:
            stale.placement = stale_map
            peeks.append(await asyncio.to_thread(stale.peek_blocking, k,
                                                 CAP, RATE))
        out["peeks"] = peeks
        stale.placement = stale_map
        sub = stale.acquire_submitter(CAP, RATE)
        out["submit"] = [_outcome(await sub(k, 1)) for k in moved[16:22]]
        stale.placement = stale_map
        first = await stale.acquire_many(moved[22:40], [1] * 18, CAP, RATE)
        out["bulk_first"] = _bulk(first)
        for _ in range(300):
            if stale.placement.epoch == coord.placement.epoch:
                break
            await asyncio.sleep(0.01)
        out["bulk_epoch"] = stale.placement.epoch
        out["bulk_again"] = _bulk(await stale.acquire_many(
            moved[22:40], [1] * 18, CAP, RATE))
        out["landed"] = [float((await coord.acquire(k, 0, CAP,
                                                    RATE)).remaining)
                         for k in moved[:40]]
    finally:
        await stale.aclose()
        await _close(coord, servers, stores)
    return out


@pytest.mark.parametrize("backing", BACKINGS)
def test_moved_chase_matches_jax(backing):
    mine = run(_chase(PORT, backing))
    theirs = run(_chase(JAX, backing))
    assert mine == theirs
    assert mine["n_moved"] >= 40
    # The pull kept one envelope on the old owner and shipped the rest:
    # the new owner holds 8 − 5 = 3 tokens of a key that spent 2.
    shipped = CAP - 2 - headroom_budget(CAP, fraction=0.5, min_budget=1.0)
    assert shipped == 3.0
    # Each single op chased once and landed on its new owner.
    assert all(r == ((True, shipped - 1), 1, True) for r in mine["single"])
    assert mine["peeks"] == [shipped] * 6
    assert mine["submit"] == [(True, shipped - 1)] * 6
    # The stale bulk frame's moved rows were denied (the ``deny``
    # contract) and refreshed in the background; the next call landed.
    assert mine["bulk_epoch"] == 1
    assert all(mine["bulk_again"][0])


# -- construction, checkpoint, the resilience pieces ---------------------------

def _config_error(pk, **kw) -> str:
    try:
        pk.Cluster(**kw)
    except ValueError as exc:
        return str(exc)
    return "no error"


@pytest.mark.parametrize("case", [
    {}, {"stores": []}, {"urls": ["h1:1"], "partial_failures": "ignore"},
    {"urls": ["h1:1"], "degraded_fallback": True, "degraded_fraction": 0.0},
])
def test_construction_errors_match_jax(case):
    assert _config_error(PORT, **case) == _config_error(JAX, **case) \
        != "no error"


def test_urls_and_addresses_build_remote_nodes():
    for kw in ({"urls": ["h1:1234", "h2:1234"]},
               {"addresses": [("h1", 1), ("h2", 2), ("h3", 3)]}):
        c = ClusterBucketStore(**kw)
        assert c.n_nodes == len(next(iter(kw.values())))
        assert all(type(n).__module__.endswith("redis_tpu_torch.runtime."
                                               "remote") for n in c.nodes)


async def _checkpoint(pk, backing) -> dict:
    clock = pk.Clock(START)
    nodes = [_store(pk, backing, clock) for _ in range(3)]
    cluster = pk.Cluster(stores=nodes)
    keys = [f"s{i}" for i in range(40)]
    await cluster.acquire_many(keys, [2] * 40, CAP, RATE)
    snap = cluster.snapshot()
    fresh_nodes = [_store(pk, backing, clock) for _ in range(3)]
    fresh = pk.Cluster(stores=fresh_nodes)
    fresh.restore(snap)
    res = await fresh.acquire_many(keys, [9] * 40, CAP, RATE)
    other = pk.Cluster(stores=[_store(pk, backing, clock)
                               for _ in range(2)])
    try:
        other.restore(snap)
        err = "none"
    except ValueError as exc:
        err = str(exc)
    for c in (cluster, fresh, other):
        await c.aclose()
    return {"after": _bulk(res), "err": err, "cluster": snap["cluster"],
            "n": snap["n_nodes"]}


@pytest.mark.parametrize("backing", BACKINGS)
def test_snapshot_restore_matches_jax(backing):
    mine = run(_checkpoint(PORT, backing))
    assert mine == run(_checkpoint(JAX, backing))
    assert not any(mine["after"][0]) and "n_nodes=2" in mine["err"]


def _breaker_trace(pk, seed: int) -> list:
    rng = np.random.default_rng(seed)
    now = [0.0]
    seen = []
    br = pk.res.CircuitBreaker(
        pk.res.BreakerConfig(failure_threshold=3, recovery_timeout_s=1.0,
                             half_open_successes=2),
        clock=lambda: now[0],
        on_transition=lambda old, new: seen.append((old, new)))
    out = []
    for _ in range(300):
        op = int(rng.integers(0, 5))
        if op == 0:
            out.append(br.allow())
        elif op == 1:
            br.record_failure()
        elif op == 2:
            br.record_success()
        elif op == 3:
            now[0] += float(rng.uniform(0.0, 0.8))
        else:
            br.release_probe() if rng.random() < 0.5 else \
                out.append(br.quarantined())
        out.append((br.state, br.state_gauge(), br.snapshot()))
    return out + seen


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_circuit_breaker_matches_jax(seed):
    mine, theirs = _breaker_trace(PORT, seed), _breaker_trace(JAX, seed)
    assert mine == theirs
    assert ("closed", "open") in mine and ("half_open", "closed") in mine


def _degraded_trace(pk, seed: int) -> list:
    rng = np.random.default_rng(seed)
    now = [0.0]
    dk = pk.cl._DegradedKeyspace(0.5, clock=lambda: now[0])
    out = []
    for _ in range(400):
        node = int(rng.integers(0, 3))
        key = f"d{int(rng.integers(0, 12))}"
        kind = ("bucket", "window", "fwindow")[int(rng.integers(0, 3))]
        r = dk.acquire(node, key, int(rng.integers(0, 4)), 10.0, 2.0, kind,
                       int(rng.integers(0, 3)))
        out.append((bool(r.granted), float(r.remaining)))
        now[0] += float(rng.uniform(0.0, 0.3))
        if rng.random() < 0.02:
            out.append(sorted(dk.drain_node(node)))
    out.append(len(dk))
    return out


@pytest.mark.parametrize("seed", [4, 5])
def test_degraded_keyspace_matches_jax(seed):
    assert _degraded_trace(PORT, seed) == _degraded_trace(JAX, seed)


def test_cluster_module_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "import distributedratelimiting.redis_tpu_torch.runtime.cluster "
            "as c, distributedratelimiting.redis_tpu_torch.runtime."
            "controller as k; "
            "assert not any(m.startswith('distributedratelimiting.redis_tpu.')"
            " for m in sys.modules); print(json.dumps(c.__all__))")
    out = subprocess.run([sys.executable, "-c", "import json; " + code],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == jcl.__all__


def _flaky(pk):
    """An in-process node of ``pk`` whose ops fail on demand and which
    counts its acquires in flight."""

    class Flaky(pk.Serial):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.fail = False
            self.inflight = self.max_inflight = 0

        async def acquire(self, *a, **kw):
            if self.fail:
                raise ConnectionError("injected node outage")
            self.inflight += 1
            self.max_inflight = max(self.max_inflight, self.inflight)
            try:
                await asyncio.sleep(0)
                return await super().acquire(*a, **kw)
            finally:
                self.inflight -= 1

    return Flaky


async def _rejoin_concurrency(pk) -> dict:
    clock = pk.Clock(START)
    nodes = [_flaky(pk)(clock=clock) for _ in range(2)]
    bt = [0.0]
    cluster = pk.Cluster(stores=nodes, breaker=pk.res.BreakerConfig(
        failure_threshold=2, recovery_timeout_s=5.0),
        breaker_clock=lambda: bt[0], degraded_fallback=True)
    cluster._degraded._clock = lambda: 0.0
    keys = [k for k in (f"r{i}" for i in range(400))
            if cluster.node_index_of(k) == 1][:120]
    for k in keys:
        await cluster.acquire(k, 2, CAP, RATE)
    nodes[1].fail = True
    grants = [(await cluster.acquire(k, 1, CAP, RATE)).granted
              for k in keys for _ in range(3)]
    nodes[1].fail = False
    bt[0] += 6.0
    await cluster.acquire(keys[0], 0, CAP, RATE)
    for _ in range(500):
        if not cluster._bg_tasks:
            break
        await asyncio.sleep(0.01)
    out = {"grants": grants, "debits": cluster.rejoin_debits,
           "balances": [float((await cluster.acquire(k, 0, CAP,
                                                     RATE)).remaining)
                        for k in keys],
           "max_inflight": nodes[1].max_inflight}
    await cluster.aclose()
    return out


def test_rejoin_debit_drains_rows_concurrently_to_jax_state():
    """The port drains a rejoin's degraded-grant rows concurrently (each
    row its own bucket), where JAX drains them one by one: the balances
    and the debit count are JAX's."""
    mine = run(_rejoin_concurrency(PORT))
    theirs = run(_rejoin_concurrency(JAX))
    assert mine["max_inflight"] > 1 and theirs["max_inflight"] == 1
    del mine["max_inflight"], theirs["max_inflight"]
    assert mine == theirs
    assert mine["debits"] == 120
    assert set(mine["balances"]) == {CAP - 2 - 3}
