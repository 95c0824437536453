"""Tier-0 on the port: the C replica table of ``native/frontend.cc`` and the
sync pump of ``redis_tpu_torch/runtime/native_frontend.py``, over the
port's serial store and its card store run on the CPU.

The JAX package's ``tests/test_tier0.py`` cases: the budget and epsilon
formulas (held to the JAX package's), the stores' ``debit_many``, a hot key
served locally and reconciled, the over-admission bound against a
device-only oracle (on the JAX package's native server too: exact equality
cannot hold there, as a sync round's timing decides which rows tier-0
serves locally), token-weighted costs, the install gate, an outage served
from the last envelope and reconciled after, a store without
``debit_many``, small buckets kept exact, and the failure streak tripping
the flight recorder. Every wait is a condition under a deadline, never a
fixed sleep.
"""

from __future__ import annotations

import asyncio
import time

import numpy as np
import pytest

from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
    overadmit_epsilon,
)
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
    BucketStore,
    DeviceBucketStore,
    InProcessBucketStore,
)

BACKINGS = ("inprocess", "device")
DEADLINE_S = 60.0


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def _store(backing: str):
    if backing == "inprocess":
        return InProcessBucketStore()
    return DeviceBucketStore(device="cpu", n_slots=1 << 12,
                             counter_slots=256, max_batch=64)


def _cfg(**kw) -> Tier0Config:
    kw.setdefault("min_budget", 8.0)
    kw.setdefault("sync_interval_s", 0.01)
    kw.setdefault("max_stale_s", 10.0)
    return Tier0Config(**kw)


async def until(pred, timeout_s: float = 10.0, every_s: float = 0.005):
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


async def _balance(store, key, cap, rate) -> float:
    return float(await asyncio.to_thread(store.peek_blocking, key, cap, rate))


def _client(srv) -> RemoteBucketStore:
    return RemoteBucketStore(address=(srv.host, srv.port),
                             coalesce_requests=False)


# -- the policy formulas (the C mirror is t0_budget_of) ----------------------

@pytest.mark.parametrize("avail,kw", [
    (1000.0, {"fraction": 0.5, "min_budget": 64.0}),
    (100.0, {"fraction": 0.5, "min_budget": 64.0}),
    (1e12, {"fraction": 0.5, "min_budget": 64.0, "max_budget": 1024.0}),
    (20_000.0, {}), (129.9, {"fraction": 0.5})])
def test_headroom_budget_policy(avail, kw):
    from distributedratelimiting.redis_tpu.models.approximate import (
        headroom_budget as jax_budget,
    )

    assert headroom_budget(avail, **kw) == jax_budget(avail, **kw)
    assert headroom_budget(1000.0, fraction=0.5, min_budget=64.0) == 500.0
    assert headroom_budget(100.0, fraction=0.5, min_budget=64.0) == 0.0


def test_overadmit_epsilon_formula():
    from distributedratelimiting.redis_tpu.models.approximate import (
        overadmit_epsilon as jax_eps,
    )

    assert overadmit_epsilon(50.0, 0.0, 0.01) == 100.0
    assert overadmit_epsilon(0.0, 10.0, 0.5) == pytest.approx(5.0)
    assert overadmit_epsilon(1e4, 1e-9, 0.01) == jax_eps(1e4, 1e-9, 0.01)


# -- the stores' reconciliation entry point ----------------------------------

@pytest.mark.parametrize("backing", BACKINGS)
def test_debit_many_saturates_and_reports_shortfall(backing):
    async def body():
        store = _store(backing)
        try:
            await store.acquire("k", 10, 100.0, 1e-9)  # 90 left
            remaining, shortfall = await store.debit_many(
                ["k", "fresh"], [50.0, 120.0], 100.0, 1e-9)
            assert remaining[0] == pytest.approx(40.0)
            assert shortfall[0] == 0.0
            assert remaining[1] == pytest.approx(0.0)
            assert shortfall[1] == pytest.approx(20.0)
            # The debit is authoritative: the exact path sees it.
            assert not (await store.acquire("k", 41, 100.0, 1e-9)).granted
            assert (await store.acquire("k", 40, 100.0, 1e-9)).granted
        finally:
            await store.aclose()

    run(body())


def test_sync_counters_many_one_launch_matches_singles():
    async def body():
        bulk, serial = _store("device"), _store("device")
        try:
            keys = [f"c{i}" for i in range(5)]
            counts = [float(i + 1) for i in range(5)]
            scores, _ = await bulk.sync_counters_many(keys, counts, 1.0)
            singles = [await serial.sync_counter(k, c, 1.0)
                       for k, c in zip(keys, counts)]
            np.testing.assert_allclose(
                scores, [s.global_score for s in singles], rtol=1e-6)
            scores2, _ = await bulk.sync_counters_many(keys, counts, 1.0)
            assert (np.asarray(scores2) >= np.asarray(scores) - 1e-3).all()
        finally:
            await bulk.aclose()
            await serial.aclose()

    run(body())


def test_base_store_debit_many_is_feature_detectable():
    class Bare(InProcessBucketStore):
        debit_many = BucketStore.debit_many

    async def body():
        with pytest.raises(NotImplementedError):
            await Bare().debit_many(["k"], [1.0], 10.0, 1.0)

    run(body())


# -- tier-0 through the native server ----------------------------------------

@pytest.mark.parametrize("backing", BACKINGS)
def test_tier0_hot_key_serves_locally_and_reconciles(backing):
    async def body():
        backing_store = _store(backing)
        debits = []
        real = backing_store.debit_many

        async def counted(keys, amounts, cap, rate):
            debits.append(len(keys))
            return await real(keys, amounts, cap, rate)

        backing_store.debit_many = counted
        try:
            async with BucketStoreServer(backing_store, native_frontend=True,
                                         native_tier0=_cfg()) as srv:
                store = _client(srv)
                try:
                    grants = 0
                    for _ in range(300):
                        grants += (await store.acquire("hot", 1, 1000.0,
                                                       1e-9)).granted
                    assert grants == 300
                    t0 = (await store.stats())["tier0"]
                    assert t0["installs"] >= 1 and t0["hits"] >= 250
                    # Reconciled exactly: every local grant debited.
                    await until(lambda: _reconciled(backing_store, grants))
                    t0 = (await store.stats())["tier0"]
                    assert t0["syncs"] >= 1 and t0["overadmit_total"] == 0.0
                    # One debit_many a sync round and config: one key here.
                    assert debits and set(debits) == {1}
                finally:
                    await store.aclose()
        finally:
            await backing_store.aclose()

    async def _reconciled(st, grants):
        return abs(await _balance(st, "hot", 1000.0, 1e-9)
                   - (1000.0 - grants)) <= 1.0

    run(body())


def _jax_server_and_store():
    from distributedratelimiting.redis_tpu.runtime.native_frontend import (
        Tier0Config as JaxTier0,
    )
    from distributedratelimiting.redis_tpu.runtime.remote import (
        RemoteBucketStore as JaxRemote,
    )
    from distributedratelimiting.redis_tpu.runtime.server import (
        BucketStoreServer as JaxServer,
    )
    from distributedratelimiting.redis_tpu.runtime.store import (
        InProcessBucketStore as JaxInProcess,
    )

    return JaxServer, JaxInProcess, JaxRemote, JaxTier0


@pytest.mark.parametrize("pkg", ["port-inprocess", "port-device", "jax"])
def test_tier0_overadmit_bounded_vs_device_only_oracle(pkg):
    """Per key, admitted ≤ the device-only oracle + the documented epsilon,
    on the port's server and on the JAX package's (fill ~0 makes the
    oracle exactly ``capacity`` a key, whatever the interleaving)."""
    capacity, fill = 100.0, 1e-9
    per_key, n_keys = 600, 4
    kw = {"sync_interval_s": 0.005, "budget_fraction": 0.5,
          "min_budget": 8.0, "max_stale_s": 10.0}
    cfg = Tier0Config(**kw)
    budget = headroom_budget(capacity, fraction=cfg.budget_fraction,
                             min_budget=cfg.min_budget,
                             max_budget=cfg.max_budget)
    assert budget > 0
    epsilon = overadmit_epsilon(budget, fill, cfg.sync_interval_s)
    if pkg == "jax":
        Server, Store, Remote, T0 = _jax_server_and_store()
        backing, tier0 = Store(), T0(**kw)
    else:
        Server, Remote = BucketStoreServer, RemoteBucketStore
        backing, tier0 = _store(pkg.split("-")[1]), cfg

    async def body():
        try:
            async with Server(backing, native_frontend=True,
                              native_tier0=tier0) as srv:
                store = Remote(address=(srv.host, srv.port),
                               coalesce_requests=False)
                try:
                    keys = [f"h{i}" for i in range(n_keys)]
                    trace = [keys[i % n_keys]
                             for i in range(n_keys * per_key)]
                    res = await asyncio.gather(
                        *(store.acquire(k, 1, capacity, fill)
                          for k in trace))
                    admitted = {k: 0 for k in keys}
                    for k, r in zip(trace, res):
                        admitted[k] += bool(r.granted)
                    for k in keys:
                        assert admitted[k] <= capacity + epsilon, (
                            k, admitted[k], epsilon)
                        assert admitted[k] >= int(capacity) * 0.9
                    # Not vacuous: tier-0 served some rows (fresh keys if
                    # the storm drained the originals before a replica
                    # installed).
                    for attempt in range(20):
                        if (await store.stats())["tier0"]["hits"] > 0:
                            break
                        for _ in range(20):
                            await store.acquire(f"heal{attempt}", 1,
                                                capacity, fill)
                    assert (await store.stats())["tier0"]["hits"] > 0
                finally:
                    await store.aclose()
        finally:
            await backing.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_tier0_weighted_cost_overadmit_bounded(backing):
    """Token-denominated: per key, admitted TOKENS ≤ the oracle's tokens +
    epsilon, with mixed costs; the store's balance equals capacity −
    admitted once the pump has drained."""
    capacity, fill = 4096.0, 1e-9
    n_keys, per_key = 3, 220
    cfg = _cfg(sync_interval_s=0.005)
    budget = headroom_budget(capacity, fraction=cfg.budget_fraction,
                             min_budget=cfg.min_budget,
                             max_budget=cfg.max_budget)
    epsilon = overadmit_epsilon(budget, fill, cfg.sync_interval_s)

    async def body():
        backing_store = _store(backing)
        try:
            async with BucketStoreServer(backing_store, native_frontend=True,
                                         native_tier0=cfg) as srv:
                store = _client(srv)
                try:
                    rng = np.random.default_rng(10)
                    keys = [f"w{i}" for i in range(n_keys)]
                    trace = [(keys[i % n_keys], int(rng.choice((4, 16, 64))))
                             for i in range(n_keys * per_key)]
                    res = await asyncio.gather(
                        *(store.acquire(k, c, capacity, fill)
                          for k, c in trace))
                    admitted = {k: 0 for k in keys}
                    for (k, c), r in zip(trace, res):
                        admitted[k] += c if r.granted else 0
                    for k in keys:
                        assert admitted[k] <= capacity + epsilon
                        assert admitted[k] >= (capacity - 64) * 0.9
                    st = await store.stats()
                    assert st["tier0"]["installs"] >= 1

                    async def drained():
                        if (await store.stats())["tier0"]["carry_keys"]:
                            return False
                        for k in keys:
                            bal = await _balance(backing_store, k, capacity,
                                                 fill)
                            if abs(bal - max(0.0, capacity - admitted[k])) \
                                    > epsilon:
                                return False
                        return True

                    await until(drained)
                finally:
                    await store.aclose()
        finally:
            await backing_store.aclose()

    run(body())


@pytest.mark.parametrize("backing", BACKINGS)
def test_tier0_install_requires_cost_headroom(backing):
    """A replica whose budget cannot cover one request of its seeding cost
    is never installed; unit traffic on a fresh key still installs."""
    async def body():
        backing_store = _store(backing)
        try:
            async with BucketStoreServer(backing_store, native_frontend=True,
                                         native_tier0=_cfg()) as srv:
                store = _client(srv)
                try:
                    r1 = await store.acquire("big", 600, 1000.0, 1e-9)
                    assert r1.granted
                    assert r1.remaining == pytest.approx(400.0, abs=1e-2)
                    assert not (await store.acquire("big", 600, 1000.0,
                                                    1e-9)).granted
                    t0 = (await store.stats())["tier0"]
                    assert t0["installs"] == 0 and t0["hits"] == 0
                    for _ in range(3):
                        await store.acquire("small", 1, 1000.0, 1e-9)
                    assert (await store.stats())["tier0"]["installs"] >= 1
                finally:
                    await store.aclose()
        finally:
            await backing_store.aclose()

    run(body())


class _OutageStore(InProcessBucketStore):
    """A store whose admission and debit paths fail on demand (a device
    outage, as the front-end sees it)."""

    def __init__(self):
        super().__init__()
        self.fail = False

    def _check(self):
        if self.fail:
            raise RuntimeError("simulated device outage")

    async def acquire_many(self, *a, **kw):
        self._check()
        return await super().acquire_many(*a, **kw)

    async def debit_many(self, *a, **kw):
        self._check()
        return await super().debit_many(*a, **kw)


def test_tier0_serves_through_outage_and_reconciles_after():
    async def body():
        backing = _OutageStore()
        async with BucketStoreServer(backing, native_frontend=True,
                                     native_tier0=_cfg(
                                         sync_interval_s=0.02)) as srv:
            store = _client(srv)
            try:
                warm = 0
                for _ in range(50):
                    warm += (await store.acquire("hot", 1, 10000.0,
                                                 1e-9)).granted
                assert warm == 50
                await until(lambda: srv._native.t0_metrics.syncs >= 1)
                backing.fail = True
                outage = 0
                for _ in range(200):
                    outage += (await store.acquire("hot", 1, 10000.0,
                                                   1e-9)).granted
                assert outage == 200  # served from the last envelope
                await until(lambda: srv._native.t0_metrics.sync_failures
                            >= 1)
                syncs = srv._native.t0_metrics.syncs
                backing.fail = False
                await until(lambda: srv._native.t0_metrics.syncs > syncs
                            and not srv._native._t0_carry)
                # Every grant, warm and outage, reconciled: nothing dropped.
                tokens, _ = backing._buckets[("hot", 10000.0, 1e-9)]
                assert tokens == pytest.approx(10000.0 - warm - outage,
                                               abs=1.0)
            finally:
                await store.aclose()

    run(body())


def test_tier0_disabled_for_store_without_debit_many(caplog):
    class NoDebit(InProcessBucketStore):
        debit_many = BucketStore.debit_many

    async def body():
        async with BucketStoreServer(NoDebit(), native_frontend=True,
                                     native_tier0=_cfg()) as srv:
            store = _client(srv)
            try:
                assert (await store.acquire("k", 1, 1000.0, 1e-9)).granted
                assert "tier0" not in await store.stats()
            finally:
                await store.aclose()

    with caplog.at_level("WARNING"):
        run(body())
    assert "no debit_many" in caplog.text


@pytest.mark.parametrize("backing", BACKINGS)
def test_tier0_small_buckets_keep_exact_semantics(backing):
    """Capacity below the confidence gate: every decision stays exact."""
    async def body():
        backing_store = _store(backing)
        try:
            async with BucketStoreServer(
                    backing_store, native_frontend=True,
                    native_tier0=_cfg(min_budget=64.0)) as srv:
                store = _client(srv)
                try:
                    r = await store.acquire("k", 4, 10.0, 1e-9)
                    assert r.granted
                    assert r.remaining == pytest.approx(6.0, abs=1e-3)
                    assert not (await store.acquire("k", 7, 10.0,
                                                    1e-9)).granted
                    assert (await store.acquire("k", 6, 10.0, 1e-9)).granted
                    t0 = (await store.stats())["tier0"]
                    assert t0["installs"] == 0 and t0["hits"] == 0
                finally:
                    await store.aclose()
        finally:
            await backing_store.aclose()

    run(body())


def test_tier0_streak_trips_flight_recorder_and_clears(tmp_path):
    """T0_STREAK_DUMP failed sync rounds in a row dump the flight recorder;
    one good round clears the streak and drains the carried rows."""
    async def body():
        backing = _OutageStore()
        async with BucketStoreServer(backing, native_frontend=True,
                                     native_tier0=_cfg(sync_interval_s=0.02),
                                     flight_dir=str(tmp_path)) as srv:
            store = _client(srv)
            fe = srv._native
            try:
                warm = 0
                for _ in range(50):
                    warm += (await store.acquire("hot", 1, 10000.0,
                                                 1e-9)).granted
                await until(lambda: fe.t0_metrics.syncs >= 1)
                backing.fail = True
                for _ in range(50):
                    await store.acquire("hot", 1, 10000.0, 1e-9)
                await until(lambda: fe._t0_fail_streak >= fe.T0_STREAK_DUMP)
                snap = srv.flight_recorder.snapshot()
                assert snap["dumps_written"] >= 1
                assert "t0_sync_streak" in snap["last_dump_path"]
                t0 = (await store.stats())["tier0"]
                assert t0["carry_keys"] >= 1
                assert t0["sync_failures"] >= fe.T0_STREAK_DUMP
                frames = srv.flight_recorder.frames(kind="t0_sync")
                assert frames and frames[-1]["failures"] >= 1
                backing.fail = False
                await until(lambda: fe._t0_fail_streak == 0
                            and not fe._t0_carry)
                tokens, _ = backing._buckets[("hot", 10000.0, 1e-9)]
                assert tokens <= 10000.0 - warm
            finally:
                await store.aclose()

    run(body())


def test_tier0_pump_debits_every_config_each_round():
    """Two (capacity, rate) configs hot at once: each round debits each
    config in one ``debit_many`` call, and both reconcile exactly."""
    async def body():
        backing = InProcessBucketStore()
        calls = []
        real = backing.debit_many

        async def counted(keys, amounts, cap, rate):
            calls.append((cap, len(keys)))
            return await real(keys, amounts, cap, rate)

        backing.debit_many = counted
        async with BucketStoreServer(backing, native_frontend=True,
                                     native_tier0=_cfg()) as srv:
            store = _client(srv)
            try:
                for i in range(200):
                    for cap in (1000.0, 2000.0):
                        assert (await store.acquire(f"a{i % 3}", 1, cap,
                                                    1e-9)).granted

                def reconciled():
                    total = sum(
                        backing._buckets[(f"a{j}", cap, 1e-9)][0]
                        for j in range(3) for cap in (1000.0, 2000.0))
                    return abs(total - (3000.0 * 3 - 400)) <= 1.0

                await until(reconciled)
                assert {cap for cap, _ in calls} == {1000.0, 2000.0}
                assert all(n <= 3 for _, n in calls)
            finally:
                await store.aclose()

    run(body())


def test_t0_retire_kills_replicas_and_returns_their_grants():
    """``_t0_retire`` (the live-config lane's ABI call, ``fe_t0_retire``):
    one locked call kills every replica of a (capacity, rate) and returns
    the grants no harvest took yet; the key then decides on the store."""
    async def body():
        backing = InProcessBucketStore()
        cfg = _cfg(sync_interval_s=30.0)  # no harvest during the test
        async with BucketStoreServer(backing, native_frontend=True,
                                     native_tier0=cfg,
                                     native_shards=2) as srv:
            store = _client(srv)
            fe = srv._native
            try:
                for _ in range(100):
                    assert (await store.acquire("r", 1, 1000.0,
                                                1e-9)).granted
                hits = (await store.stats())["tier0"]["hits"]
                assert hits > 0
                got = fe._t0_retire(1000.0, 1e-9)
                assert {k for k, _ in got} == {"r"}
                assert sum(a for _, a in got) == hits
                assert fe._t0_retire(1000.0, 1e-9) == []
                # Exact on the store from here: the local grants were
                # never debited, so the store still holds them.
                assert (await store.acquire("r", 1, 1000.0, 1e-9)).granted
                assert (await store.stats())["tier0"]["hits"] == hits
            finally:
                await store.aclose()

    run(body())


# -- live config: a retired config's replicas ---------------------------------

@pytest.mark.parametrize("backing", BACKINGS)
def test_tier0_retired_config_reroutes_debits_and_stops_serving(backing):
    """JAX ``tests/test_upgrade.py:858``: a config mutation retiring a
    tier-0-hosted (cap, rate). The sync pump retires the C replicas
    (``_t0_retire``) and debits the harvested grants through the
    REPLACEMENT config's table, so within a sync interval the C lane stops
    admitting against the dead table and a stale frame falls through to the
    batch lane's routable "config moved"; the new table accounts for every
    grant, before and after the commit."""
    async def body():
        store = _store(backing)
        try:
            async with BucketStoreServer(
                    store, native_frontend=True,
                    native_tier0=_cfg(sync_interval_s=0.02)) as srv:
                c = _client(srv)
                try:
                    for _ in range(200):
                        assert (await c.acquire("hot", 1, 1000.0,
                                                1e-9)).granted
                    await until(lambda: srv._native.t0_metrics.syncs >= 1)
                    st = await c.stats()
                    assert st["tier0"]["installs"] >= 1
                    await c.config_announce({"prepare": {
                        "kind": "bucket", "old": [1000.0, 1e-9],
                        "new": [500.0, 1e-9]}, "version": 1})
                    await c.config_announce({"commit": 1})
                    # Right after the commit a stale frame may still be
                    # served from the replica's last-acked headroom: the
                    # one-sync-interval epsilon.
                    for _ in range(100):
                        assert (await c.acquire("hot", 1, 1000.0,
                                                1e-9)).granted
                    m = srv._native.t0_metrics
                    await until(lambda: m.retired_config_rows >= 1
                                and not srv._native._t0_carry)
                    r = await c.acquire("hot", 1, 1000.0, 1e-9)
                    assert r.granted
                    st = await c.stats()
                    assert st["config"]["moved_errors"] >= 1
                    assert st["tier0"]["retired_config_rows"] >= 1
                    # Every grant (~301) reaches the new table, saturating:
                    # the retired replica's through the retire, those a
                    # replica of the new config served through its syncs.
                    async def settled():
                        bal = await _balance(store, "hot", 500.0, 1e-9)
                        return bal <= 500.0 - 301.0 + 16.0

                    await until(settled)
                    bal = await _balance(store, "hot", 500.0, 1e-9)
                    assert bal == pytest.approx(500.0 - 301.0, abs=16.0)
                finally:
                    await c.aclose()
        finally:
            await store.aclose()

    run(body())
