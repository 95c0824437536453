"""The port's live config (``runtime/liveconfig.py``, ``OP_CONFIG``, the
"config moved" gates and the client's chase) against the JAX package's, on
the CPU.

Every case runs the same seeded inputs through both packages and holds the
port to JAX's answers:

- the unit surface: ``ConfigRule`` validation (errors and texts equal), the
  moved message (bytes equal) and its parse, and seeded streams of prepare,
  commit, abort, adopt and malformed frames on ``ConfigState`` (every
  result or error, ``stats()``, the fetch payload and the gate equal);
  JAX's ``tests/test_upgrade.py:76-296`` twins (two-phase idempotence,
  abort, chain compression, revert, the bucket and window rebase, the
  floored window carry, under-admission only);
- the wire (JAX ``:299-380``): fetch, mutate and gate, the bulk lane's
  frame-level chase, the revert's convergence, two-level frames and
  reserves with a retired level, each on both packages' serial store and
  ``DeviceBucketStore(device="cpu")``, the replies, ``stats()``, rules and
  balances equal; a JAX client chasing a port server's moved error once
  and a port client a JAX server's; the moved replies' bytes equal;
- JAX's ``ClusterBucketStore.mutate_config`` over two port servers beside
  two JAX servers (versions and balances equal), and its clean abort on an
  injected prepare fault;
- the stores a rebase cannot enumerate (the fingerprint and mesh stores):
  the same ``ConfigError``, the version advanced, the keys born full;
- a settle of a hold made before a commit refunding into the new table
  (JAX ``tests/test_reservations.py::test_config_rebase_rehomes_settles``).

Tolerance: exact on a frozen clock (buckets at rate 0 or a whole-number
state), window remainders within 1.5 float32 ulps (XLA on the CPU contracts
the sliding estimate into an FMA; the port never does).

One deliberate divergence is pinned: the window replay runs concurrently,
in flushes of many rows on the card store where JAX launches a row at a
time (the state after is equal).
"""

from __future__ import annotations

import asyncio
import json
import logging
import types

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.parallel.mesh import (
    create_mesh as jcreate_mesh,
)
from distributedratelimiting.redis_tpu.parallel.mesh_store import (
    MeshBucketStore as JMesh,
)
from distributedratelimiting.redis_tpu.runtime import fp_store as jfs
from distributedratelimiting.redis_tpu.runtime import liveconfig as jlc
from distributedratelimiting.redis_tpu.runtime import placement as jpl
from distributedratelimiting.redis_tpu.runtime import remote as jremote
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.cluster import (
    ClusterBucketStore,
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
    DeviceBucketStore,
    FingerprintBucketStore,
    InProcessBucketStore,
    ManualClock,
    MeshBucketStore,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh
from distributedratelimiting.redis_tpu_torch.runtime import liveconfig as plc
from distributedratelimiting.redis_tpu_torch.runtime import placement as ppl
from distributedratelimiting.redis_tpu_torch.runtime import remote as premote
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw

torch.set_num_threads(1)

START = 1_000_000
LIMIT_S = 60.0

PORT = types.SimpleNamespace(
    name="port", lc=plc, pl=ppl, Clock=ManualClock, Serial=InProcessBucketStore,
    device=lambda clock: DeviceBucketStore(device="cpu", clock=clock,
                                           n_slots=512, max_batch=64),
    Server=BucketStoreServer, Remote=RemoteBucketStore)
JAX = types.SimpleNamespace(
    name="jax", lc=jlc, pl=jpl, Clock=JClock, Serial=JSerial,
    device=lambda clock: JDevice(clock=clock, n_slots=512, max_batch=64),
    Server=JServer, Remote=JRemote)
PKGS = (PORT, JAX)
BACKINGS = ("serial", "device")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _store(pk, backing: str, clock=None):
    clock = clock or pk.Clock(START)
    return pk.Serial(clock=clock) if backing == "serial" else pk.device(clock)


def _both(scenario, *args):
    """``scenario(pk, *args)`` on the port and on JAX; both outputs."""
    return run(scenario(PORT, *args)), run(scenario(JAX, *args))


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001
        return (type(exc).__name__, str(exc))


async def _aoutcome(coro):
    try:
        return ("ok", await coro)
    except Exception as exc:  # noqa: BLE001
        return (type(exc).__name__, str(exc))


def _ulps(a: float, b: float, n: float = 1.5) -> bool:
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) <= n * float(
        np.spacing(max(abs(a), abs(b), np.float32(1e-30))))


@pytest.fixture(autouse=True)
def _no_leaked_injector():
    yield
    jfaults.uninstall()


# -- the unit surface -----------------------------------------------------------

BAD_RULES = [("nope", (1.0, 1.0), (2.0, 1.0)),
             ("bucket", (1.0, 1.0), (1.0, 1.0)),
             ("bucket", (0.0, 1.0), (2.0, 1.0)),
             ("window", (float("nan"), 1.0), (2.0, 1.0)),
             ("fwindow", (3.0, float("inf")), (2.0, 1.0)),
             ("bucket", (5.0, 1.0), (-1.0, 1.0))]


@pytest.mark.parametrize("kind,old,new", BAD_RULES)
def test_config_rule_validation_matches_jax(kind, old, new):
    got = [_outcome(lambda pk=pk: pk.lc.ConfigRule(kind, old, new))
           for pk in PKGS]
    assert got[0] == got[1] and got[0][0] == "ConfigError"


def test_config_rule_round_trip_and_repr():
    for pk in PKGS:
        r = pk.lc.ConfigRule("bucket", (100, 1), (50, 1))
        assert pk.lc.ConfigRule.from_dict(r.to_dict()) == r
    pr = plc.ConfigRule("window", (10, 5), (4, 5))
    jr = jlc.ConfigRule("window", (10, 5), (4, 5))
    assert (pr.to_dict(), repr(pr)) == (jr.to_dict(), repr(jr))
    assert plc.__all__ == jlc.__all__
    assert (plc.CONFIG_MOVED_PREFIX, plc.KINDS) == (jlc.CONFIG_MOVED_PREFIX,
                                                    jlc.KINDS)
    assert plc.OP_KINDS == jlc.OP_KINDS and plc.BULK_KINDS == jlc.BULK_KINDS


@pytest.mark.parametrize("seed", range(3))
def test_moved_message_bytes_and_parse_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        kind = plc.KINDS[int(rng.integers(0, 3))]
        old = (float(rng.integers(1, 1000)) / 8, float(rng.random() * 50))
        new = (float(rng.integers(1, 1000)) / 8, float(rng.random() * 50))
        v = int(rng.integers(1, 10**6))
        msg = plc.moved_message(kind, old, new, v)
        assert msg == jlc.moved_message(kind, old, new, v)
        assert msg.startswith(plc.CONFIG_MOVED_PREFIX)
        wrapped = f"RemoteStoreError({msg!r})"
        for text in (msg, wrapped):
            assert plc.parse_moved(text) == jlc.parse_moved(text)
        assert plc.parse_moved(msg) == (kind, old, new, v)
    for junk in ("some other error", plc.CONFIG_MOVED_PREFIX + ": {broken",
                 plc.CONFIG_MOVED_PREFIX + ': {"kind": "bucket"}',
                 plc.CONFIG_MOVED_PREFIX + ': {"old": [1], "new": [2, 3], '
                 '"kind": "x", "version": 1}'):
        assert plc.parse_moved(junk) is None
        assert jlc.parse_moved(junk) is None


#: The configs a seeded stream's rules draw from: few, so that chains,
#: reverts and conflicting prepares happen.
_POOL = [(100.0, 0.0), (50.0, 0.0), (25.0, 0.0), (10.0, 1.0)]


def _stream(seed: int, n: int = 60) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        roll = rng.random()
        v = int(rng.integers(0, 8))
        if roll < 0.4:
            kind = plc.KINDS[int(rng.integers(0, 3))]
            i, j = rng.choice(len(_POOL), 2, replace=False)
            out.append({"prepare": {"kind": kind, "old": list(_POOL[i]),
                                    "new": list(_POOL[j])}, "version": v})
        elif roll < 0.75:
            out.append({"commit": v})
        elif roll < 0.85:
            out.append({"abort": v})
        elif roll < 0.92:
            i, j = rng.choice(len(_POOL), 2, replace=False)
            out.append({"adopt": {"version": v, "rules": [
                {"kind": "bucket", "old": list(_POOL[i]),
                 "new": list(_POOL[j]), "version": v}]}})
        elif roll < 0.96:
            out.append({})
        else:
            out.append({"bogus": v})
    return out


@pytest.mark.parametrize("seed", range(4))
def test_config_state_seeded_stream_matches_jax(seed):
    """Every frame's result or error, ``stats()``, the fetch payload and
    the gate on every pool config, equal step by step."""
    async def scenario(pk):
        st = pk.lc.ConfigState()
        store = pk.Serial(clock=pk.Clock(START))
        trace = []
        for payload in _stream(seed):
            got = await _aoutcome(st.announce(payload, store))
            trace.append((got, st.stats(), st.snapshot_payload(),
                          [st.forward(k, *c) for k in pk.lc.KINDS
                           for c in _POOL]))
        return trace

    port, jax = _both(scenario)
    assert port == jax
    assert any(t[0][0] == "StaleConfigError" for t in port)
    assert any(t[1]["commits"] for t in port)


async def _two_phase(pk):
    st = pk.lc.ConfigState()
    store = pk.Serial()
    rule = pk.lc.ConfigRule("bucket", (100.0, 0.0), (50.0, 0.0))
    other = pk.lc.ConfigRule("bucket", (100.0, 0.0), (25.0, 0.0))
    out = [st.active]
    out.append(await st.announce({"prepare": rule.to_dict(), "version": 1},
                                 store))
    out.append(st.active)
    await st.announce({"prepare": rule.to_dict(), "version": 1}, store)
    out.append(await _aoutcome(st.announce(
        {"prepare": other.to_dict(), "version": 1}, store)))
    out.append(await st.announce({"commit": 1}, store))
    out.append((st.active, st.commits))
    out.append(await st.announce({"commit": 1}, store))
    out.append(st.commits)
    out.append(await _aoutcome(st.announce(
        {"prepare": other.to_dict(), "version": 1}, store)))
    out.append((st.forward("bucket", 100.0, 0.0),
                st.forward("bucket", 50.0, 0.0)))
    out.append(await _aoutcome(st.announce({"commit": 5}, store)))
    out.append(st.stats())
    return out


def test_config_state_two_phase_idempotent():
    port, jax = _both(_two_phase)
    assert port == jax
    assert port[0] is False and port[1] == 0 and port[2] is False
    assert port[3][0] == "StaleConfigError"
    assert port[4] == 1 and port[5] == (True, 1)
    assert port[6] == 1 and port[7] == 1  # no second rebase
    assert port[8][0] == "StaleConfigError"
    assert port[9] == ((50.0, 0.0, 1), None)
    assert port[10][0] == "ConfigError"


async def _abort(pk):
    st = pk.lc.ConfigState()
    store = pk.Serial()
    rule = pk.lc.ConfigRule("bucket", (10.0, 1.0), (5.0, 1.0))
    await st.announce({"prepare": rule.to_dict(), "version": 1}, store)
    await st.announce({"abort": 1}, store)
    return (st.aborts, st.active,
            await _aoutcome(st.announce({"commit": 1}, store)), st.stats())


def test_config_state_abort_drops_staged_rule():
    port, jax = _both(_abort)
    assert port == jax
    assert port[0] == 1 and not port[1] and port[2][0] == "ConfigError"


async def _chain(pk, revert: bool):
    st = pk.lc.ConfigState()
    store = pk.Serial()
    a, b, c = (100.0, 0.0), (50.0, 0.0), (25.0, 0.0)
    await st.announce({"prepare": pk.lc.ConfigRule(
        "bucket", a, b).to_dict(), "version": 1}, store)
    await st.announce({"commit": 1}, store)
    third = a if revert else c
    await st.announce({"prepare": pk.lc.ConfigRule(
        "bucket", b, third).to_dict(), "version": 2}, store)
    await st.announce({"commit": 2}, store)
    return (st.forward("bucket", *a), st.forward("bucket", *b),
            st.snapshot_payload())


@pytest.mark.parametrize("revert", [False, True])
def test_config_chain_compression_and_revert(revert):
    """A→B then B→C makes A→C (one chase); a revert B→A deletes A's rule
    instead of forwarding A to itself."""
    port, jax = _both(_chain, revert)
    assert port == jax
    if revert:
        assert port[0] is None and port[1] == (100.0, 0.0, 2)
    else:
        assert port[0] == port[1] == (25.0, 0.0, 2)


# -- the rebase ----------------------------------------------------------------

def _traffic(seed: int):
    rng = np.random.default_rng(seed)
    keys = [f"k{i}" for i in range(120)]
    spends = rng.integers(0, 121, len(keys))  # some past the new cap
    wkeys = [f"w{i}" for i in range(60)]
    wcounts = rng.integers(0, 11, len(wkeys))
    return keys, spends, wkeys, wcounts


async def _rebase(pk, backing, seed):
    keys, spends, wkeys, wcounts = _traffic(seed)
    store = _store(pk, backing)
    try:
        for k, s in zip(keys, spends):
            if s:
                await store.acquire(k, int(min(s, 100)), 100.0, 0.0)
        for k, c in zip(wkeys, wcounts):
            if c:
                await store.window_acquire(k, int(c), 10.0, 1000.0)
                await store.fixed_window_acquire(k, int(c), 10.0, 1000.0)
        st = pk.lc.ConfigState()
        for v, (kind, old, new) in enumerate((
                ("bucket", (100.0, 0.0), (50.0, 0.0)),
                ("window", (10.0, 1000.0), (5.0, 1000.0)),
                ("fwindow", (10.0, 1000.0), (7.0, 1000.0))), start=1):
            await st.announce({"prepare": {"kind": kind, "old": list(old),
                                           "new": list(new)},
                               "version": v}, store)
            await st.announce({"commit": v}, store)
        balances = [store.peek_blocking(k, 50.0, 0.0) for k in keys]
        sliding = await store.window_acquire_many(wkeys, [0] * len(wkeys),
                                                  5.0, 1000.0)
        fixed = await store.window_acquire_many(wkeys, [0] * len(wkeys),
                                                7.0, 1000.0, fixed=True)
        return (balances, np.asarray(sliding.remaining).tolist(),
                np.asarray(fixed.remaining).tolist(), st.stats())
    finally:
        await store.aclose()


@pytest.mark.parametrize("backing", BACKINGS)
@pytest.mark.parametrize("seed", range(2))
def test_rebase_carries_spent_budget_buckets_and_windows(backing, seed):
    """Buckets land at ``new_cap − spent`` (saturating at 0), windows at
    their floored current count clamped to the new limit, on both
    packages' stores; ``rebased_rows`` counts the retired config's rows."""
    port, jax = _both(_rebase, backing, seed)
    keys, spends, wkeys, wcounts = _traffic(seed)
    want = [max(0.0, 50.0 - min(float(s), 100.0)) for s in spends]
    assert port[0] == jax[0] == want
    assert all(_ulps(a, b) for a, b in zip(port[1], jax[1]))
    assert port[2] == jax[2]
    assert port[1] == [5.0 - min(float(c), 5.0) for c in wcounts]
    assert port[2] == [7.0 - min(float(c), 7.0) for c in wcounts]
    assert port[3] == jax[3]
    assert port[3]["rebased_rows"] == (int((spends > 0).sum())
                                       + 2 * int((wcounts > 0).sum()))


async def _revert_windows(pk, backing):
    counts = np.arange(1, 51)
    keys = [f"v{i}" for i in range(len(counts))]
    store = _store(pk, backing)
    try:
        await store.window_acquire_many(keys, counts, 50.0, 60.0,
                                        fixed=True)
        st = pk.lc.ConfigState()
        for v, (old, new) in enumerate((((50.0, 60.0), (20.0, 60.0)),
                                        ((20.0, 60.0), (50.0, 60.0))),
                                       start=1):
            await st.announce({"prepare": {"kind": "fwindow",
                                           "old": list(old),
                                           "new": list(new)},
                               "version": v}, store)
            await st.announce({"commit": v}, store)
        res = await store.window_acquire_many(
            keys, np.zeros(len(keys), np.int64), 50.0, 60.0, fixed=True)
        return (np.asarray(res.remaining).tolist(), st.snapshot_payload(),
                st.stats())
    finally:
        await store.aclose()


@pytest.mark.parametrize("backing", BACKINGS)
def test_window_revert_replays_onto_the_original_table(backing):
    """A revert carries each window's count back onto the original table,
    which still holds its own: granted where the sum stays within the
    limit, else nothing recorded (the chip path's oracle)."""
    port, jax = _both(_revert_windows, backing)
    assert port == jax
    counts = np.arange(1, 51)
    carried = np.minimum(counts, 20)
    total = np.where(counts + carried <= 50, counts + carried, counts)
    assert port[0] == (50.0 - total).tolist()
    assert [r["old"] for r in port[1]["rules"]] == [[20.0, 60.0]]


async def _floors(pk):
    store = pk.Serial()
    wt = int(1000.0 * 1024)
    idx = store.clock.now_ticks() // wt
    # A fractional current count (an envelope pre-charge) under limit 11.
    store._windows[("w", 11.0, wt, True)] = (0.0, 10.2, idx)
    st = pk.lc.ConfigState()
    await st.announce({"prepare": pk.lc.ConfigRule(
        "window", (11.0, 1000.0), (10.5, 1000.0)).to_dict(), "version": 1},
        store)
    await st.announce({"commit": 1}, store)
    r = await store.window_acquire("w", 1, 10.5, 1000.0)
    return (r.granted, r.remaining, store._windows.get(
        ("w", 10.5, wt, True)))


def test_window_rebase_floors_fractional_carry():
    port, jax = _both(_floors)
    assert port == jax
    assert port[0] is False  # floor(10.2) = 10 carried, 0.5 left


async def _under_admit(pk, backing):
    store = _store(pk, backing)
    try:
        await store.acquire("k", 90, 100.0, 0.0)
        st = pk.lc.ConfigState()
        await st.announce({"prepare": pk.lc.ConfigRule(
            "bucket", (100.0, 0.0), (20.0, 0.0)).to_dict(), "version": 1},
            store)
        await st.announce({"commit": 1}, store)
        return store.peek_blocking("k", 20.0, 0.0)
    finally:
        await store.aclose()


@pytest.mark.parametrize("backing", BACKINGS)
def test_rebase_can_only_under_admit(backing):
    port, jax = _both(_under_admit, backing)
    assert port == jax == 0.0


@pytest.mark.parametrize("backing", ["serial", "device", "fp"])
def test_rebase_enumeration_equals_jax_extraction(backing):
    """The rebase's enumeration, ``extract_entries`` of the store's
    snapshot taken off the loop, gives JAX's entries for the serial and
    card stores and raises JAX's error for the fingerprint store; the
    store's ``export_entries`` (the placement lane) gives the same."""
    def store_of(pk):
        if backing == "fp":
            return (FingerprintBucketStore(device="cpu", n_slots=1024,
                                           clock=ManualClock(START))
                    if pk is PORT else
                    jfs.FingerprintBucketStore(n_slots=1024,
                                               clock=JClock(START)))
        return _store(pk, backing)

    async def scenario(pk):
        store = store_of(pk)
        try:
            await store.acquire_many([f"a{i}" for i in range(40)],
                                     list(range(40)), 50.0, 0.0)
            await store.window_acquire_many([f"b{i}" for i in range(20)],
                                            [3] * 20, 10.0, 5.0)
            snap = await asyncio.to_thread(store.snapshot)
            got = _outcome(lambda: pk.pl.extract_entries(snap,
                                                         lambda _k: True))
            if pk is PORT:
                assert got == _outcome(lambda: store.export_entries(
                    lambda _k: True))
            if got[0] == "ok":
                got = ("ok", {k: sorted(v) for k, v in got[1].items()})
            return got
        finally:
            await store.aclose()

    port, jax = _both(scenario)
    assert port == jax
    assert port[0] == ("KeyError" if backing == "fp" else "ok")


def _fp_or_mesh(pk, kind: str):
    if kind == "fp":
        return (FingerprintBucketStore(device="cpu", n_slots=1024,
                                       clock=ManualClock(START))
                if pk is PORT else
                jfs.FingerprintBucketStore(n_slots=1024, clock=JClock(START)))
    return (MeshBucketStore(Mesh(["cpu"] * 8), per_shard_slots=32,
                            clock=ManualClock(START))
            if pk is PORT else
            JMesh(jcreate_mesh(8), per_shard_slots=32, clock=JClock(START)))


@pytest.mark.parametrize("kind", ["fp", "mesh"])
def test_rebase_outcome_of_fp_and_mesh_stores_equals_jax(kind, caplog):
    """A store whose snapshot cannot enumerate keys: ``_rebase_state``
    raises the same ``ConfigError`` on both packages; inside a commit it is
    logged, the version advances and the keys are born full on the new
    config (init-on-miss)."""
    async def scenario(pk):
        store = _fp_or_mesh(pk, kind)
        try:
            await store.acquire_many(["a", "b", "c"], [3, 1, 2], 10.0, 0.0)
            rule = pk.lc.ConfigRule("bucket", (10.0, 0.0), (6.0, 0.0))
            direct = await _aoutcome(pk.lc._rebase_state(store, rule))
            st = pk.lc.ConfigState()
            await st.announce({"prepare": rule.to_dict(), "version": 1},
                              store)
            version = await st.announce({"commit": 1}, store)
            return (direct[0], version, st.stats(),
                    [store.peek_blocking(k, 6.0, 0.0) for k in "abc"])
        finally:
            await store.aclose()

    with caplog.at_level(logging.ERROR):
        port, jax = _both(scenario)
    assert port == jax
    assert port[0] == "ConfigError" and port[1] == 1
    assert port[2]["commits"] == 1 and port[2]["rebased_rows"] == 0
    assert port[3] == [6.0, 6.0, 6.0]
    assert any("Error executing store kernel" in r.getMessage()
               for r in caplog.records)


def test_concurrent_window_replay_ends_in_jax_state():
    """The window replay runs its rows concurrently: on the port's card
    store they are decided in flushes of many rows (JAX: one acquire a
    key), and the tables after the commit hold the same windows."""
    n = 300
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 9, n)
    keys = [f"r{i}" for i in range(n)]

    async def scenario(pk):
        store = pk.device(pk.Clock(START))
        try:
            for fixed in (False, True):
                await store.window_acquire_many(keys, counts, 8.0, 2.0,
                                                fixed=fixed)
            st = pk.lc.ConfigState()
            for v, kind in enumerate(("window", "fwindow"), start=1):
                await st.announce({"prepare": {
                    "kind": kind, "old": [8.0, 2.0], "new": [6.0, 4.0]},
                    "version": v}, store)
                before = store.metrics.launches
                await st.announce({"commit": v}, store)
            launches = store.metrics.launches - before
            rows = jpl.extract_entries(store.snapshot(), lambda _k: True)[
                "windows"] if pk is JAX else ppl.extract_entries(
                store.snapshot(), lambda _k: True)["windows"]
            new = sorted(r for r in rows if r[1] == 6.0)
            return new, launches, st.stats()
        finally:
            await store.aclose()

    port, jax = _both(scenario)
    assert port[0] == jax[0]
    assert len(port[0]) == 2 * n
    assert sorted(r[5] for r in port[0]) == sorted(
        2 * [float(min(c, 6)) for c in counts])
    assert port[2] == jax[2] and port[2]["rebased_rows"] == 2 * n
    # One fixed-window commit: the port replays its n rows in flushes of
    # up to max_batch (64) rows; JAX launches once a row.
    assert port[1] <= -(-n // 64) + 2 < jax[1]


# -- the wire --------------------------------------------------------------------

async def _served(pk, backing, fn, **server_kw):
    store = _store(pk, backing)
    srv = pk.Server(store, **server_kw)
    await srv.start()
    cli = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        return await fn(srv, cli, store)
    finally:
        await cli.aclose()
        await srv.aclose()
        await store.aclose()


async def _fetch_mutate_gate(pk, backing):
    async def fn(srv, c, store):
        out = [await c.config_fetch()]
        for _ in range(30):
            await c.acquire("k", 1, 100.0, 0.0)
        rule = {"kind": "bucket", "old": [100.0, 0.0], "new": [50.0, 0.0]}
        out.append(await c.config_announce({"prepare": rule, "version": 1}))
        out.append(await c.config_announce({"commit": 1}))
        out.append(await c.config_fetch())
        out.append(tuple(await c.acquire("k", 0, 100.0, 0.0)))
        out.append(tuple(await c.acquire("k", 5, 100.0, 0.0)))
        out.append((await c.stats())["config"])
        out.append(await asyncio.to_thread(c.peek_blocking, "k", 100.0, 0.0))
        out.append(await _aoutcome(c.config_announce(
            {"prepare": rule, "version": 1})))
        out.append((await c.stats())["config"])
        return out

    return await _served(pk, backing, fn)


@pytest.mark.parametrize("backing", BACKINGS)
def test_op_config_fetch_mutate_and_gate_over_wire(backing):
    port, jax = _both(_fetch_mutate_gate, backing)
    assert port == jax
    assert port[0] == {"version": 0, "rules": []}
    assert port[1] == 0 and port[2] == 1
    assert port[3]["version"] == 1 and port[3]["rules"][0]["new"] == [50.0,
                                                                      0.0]
    assert port[4] == (True, 20.0)  # 50 − 30 spent, one chase
    assert port[5][0] and port[6]["moved_errors"] == 1
    assert port[7] == 15.0  # PEEK redirects through the learned rule
    assert port[8][0] == "RemoteStoreError" and "stale config" in port[8][1]
    assert port[9]["stale_announces"] == 1


async def _bulk_chase(pk, backing):
    async def fn(srv, c, store):
        await c.config_announce({"prepare": {
            "kind": "bucket", "old": [100.0, 0.0], "new": [50.0, 0.0]},
            "version": 1})
        await c.config_announce({"commit": 1})
        keys = [f"b{i}" for i in range(64)]
        out = []
        res = await c.acquire_many(keys, [1] * 64, 100.0, 0.0)
        out.append(np.asarray(res.granted).tolist())
        out.append(store.peek_blocking("b0", 50.0, 0.0))
        out.append((await c.stats())["config"]["moved_errors"])
        res = await c.acquire_many(keys, [1] * 64, 100.0, 0.0)
        out.append(np.asarray(res.remaining).tolist())
        out.append((await c.stats())["config"]["moved_errors"])
        await c.config_announce({"prepare": {
            "kind": "window", "old": [10.0, 100.0], "new": [4.0, 100.0]},
            "version": 2})
        await c.config_announce({"commit": 2})
        res = await c.window_acquire_many(keys[:8], [1] * 8, 10.0, 100.0)
        out.append(np.asarray(res.granted).tolist())
        res = await c.window_acquire_many(["b0"], [4], 10.0, 100.0)
        out.append(np.asarray(res.granted).tolist())
        res = await asyncio.to_thread(c.acquire_many_blocking, keys[:4],
                                      [1] * 4, 100.0, 0.0)
        out.append(np.asarray(res.remaining).tolist())
        out.append((await c.stats())["config"])
        return out

    return await _served(pk, backing, fn)


@pytest.mark.parametrize("backing", BACKINGS)
def test_bulk_lane_chases_config_moved_frame_level(backing):
    port, jax = _both(_bulk_chase, backing)
    assert port == jax
    assert all(port[0]) and port[1] == 49.0 and port[2] == 1
    assert port[4] == 1  # the translation is cached
    assert all(port[5]) and not any(port[6])
    assert port[8]["moved_errors"] == 2


async def _revert(pk, backing):
    async def fn(srv, c, store):
        out = []
        await c.acquire("k", 30, 100.0, 0.0)
        await c.config_announce({"prepare": {
            "kind": "bucket", "old": [100.0, 0.0], "new": [50.0, 0.0]},
            "version": 1})
        await c.config_announce({"commit": 1})
        out.append(tuple(await c.acquire("k", 0, 100.0, 0.0)))
        await c.config_announce({"prepare": {
            "kind": "bucket", "old": [50.0, 0.0], "new": [100.0, 0.0]},
            "version": 2})
        await c.config_announce({"commit": 2})
        out.append(tuple(await c.acquire("k", 0, 100.0, 0.0)))
        moved = (await c.stats())["config"]["moved_errors"]
        for _ in range(5):
            await c.acquire("k", 0, 100.0, 0.0)
        out.append((moved, (await c.stats())["config"]))
        out.append(store.peek_blocking("k", 100.0, 0.0))
        return out

    return await _served(pk, backing, fn)


@pytest.mark.parametrize("backing", BACKINGS)
def test_revert_mutation_converges_stale_clients(backing):
    port, jax = _both(_revert, backing)
    assert port == jax
    assert port[0] == (True, 20.0) and port[1][0]
    assert port[2][0] == port[2][1]["moved_errors"] == 2


async def _hier_and_reserve(pk, backing):
    """Two-level frames, two-level bulk and a reserve with each level
    retired in turn: one chase a level, then translated."""
    async def fn(srv, c, store):
        out = []
        t_old, t_new = (1000.0, 0.0), (600.0, 0.0)
        k_old, k_new = (100.0, 0.0), (40.0, 0.0)
        await c.acquire_hierarchical("t", "k", 10, *t_old, *k_old)
        for v, (old, new) in enumerate(((t_old, t_new), (k_old, k_new)),
                                       start=1):
            await c.config_announce({"prepare": {
                "kind": "bucket", "old": list(old), "new": list(new)},
                "version": v})
            await c.config_announce({"commit": v})
        out.append(tuple(await c.acquire_hierarchical("t", "k", 5, *t_old,
                                                      *k_old)))
        res = await c.acquire_hierarchical_many(
            ["t", "u"], ["k", "k2"], [1, 2], *t_old, *k_old)
        out.append((np.asarray(res.granted).tolist(),
                    np.asarray(res.remaining).tolist()))
        r = await c.reserve("r1", "t", "k3", 30.0, *t_old, *k_old)
        out.append(tuple(r))
        out.append([store.peek_blocking(k, *cfg) for k, cfg in (
            ("t", t_new), ("k", k_new), ("u", t_new), ("k3", k_new))])
        out.append((await c.stats())["config"])
        return out

    return await _served(pk, backing, fn)


@pytest.mark.parametrize("backing", BACKINGS)
def test_two_level_and_reserve_chase_both_levels(backing):
    port, jax = _both(_hier_and_reserve, backing)
    assert port == jax
    assert port[0][0] and port[2][0]
    # The tenant's rebase carried its 10 spent; then 5, 1 and the hold 30.
    assert port[3][0] == 600.0 - 10 - 5 - 1 - 30
    assert port[4]["moved_errors"] == 2


def test_op_config_is_post_send_retry_safe_classified():
    for mod in (premote, jremote):
        assert pw.OP_CONFIG in mod._IDEMPOTENT_OPS
        assert pw.OP_CONFIG not in mod._NON_IDEMPOTENT_OPS


@pytest.mark.parametrize("client", ["port", "jax"])
def test_cross_package_client_chases_once(client):
    """A JAX client chases a port server's "config moved" once, and a port
    client a JAX server's; the balances land on the new table alike."""
    async def scenario(srv_pk):
        cli_pk = PORT if client == "port" else JAX

        async def fn(srv, _c, store):
            c = cli_pk.Remote(address=(srv.host, srv.port),
                              coalesce_requests=False)
            try:
                for _ in range(30):
                    await c.acquire("k", 1, 100.0, 0.0)
                await c.config_announce({"prepare": {
                    "kind": "bucket", "old": [100.0, 0.0],
                    "new": [50.0, 0.0]}, "version": 1})
                await c.config_announce({"commit": 1})
                out = [tuple(await c.acquire("k", 5, 100.0, 0.0))]
                res = await c.acquire_many(["k", "x"], [1, 1], 100.0, 0.0)
                out.append(np.asarray(res.remaining).tolist())
                out.append(tuple(await c.window_acquire("w", 1, 9.0, 1.0)))
                out.append((await c.stats())["config"]["moved_errors"])
                out.append(await c.config_fetch())
                return out
            finally:
                await c.aclose()

        return await _served(srv_pk, "serial", fn)

    port, jax = _both(scenario)
    assert port == jax
    assert port[0] == (True, 15.0) and port[1] == [14.0, 49.0]
    assert port[3] == 1


def test_moved_replies_are_byte_equal_to_jax():
    """The same raw frames (scalar, PEEK, bulk, window bulk, two-level,
    two-level bulk, reserve, each carrying a retired config) answer the
    same bytes from both servers."""
    frames = [pw.encode_request(1, pw.OP_CONFIG, json.dumps(
        {"prepare": {"kind": "bucket", "old": [9.0, 1.0],
                     "new": [4.0, 1.0]}, "version": 1})),
              pw.encode_request(2, pw.OP_CONFIG, json.dumps({"commit": 1})),
              pw.encode_request(3, pw.OP_CONFIG, json.dumps(
                  {"prepare": {"kind": "window", "old": [7.0, 2.0],
                               "new": [3.0, 2.0]}, "version": 2})),
              pw.encode_request(4, pw.OP_CONFIG, json.dumps({"commit": 2})),
              pw.encode_request(5, pw.OP_ACQUIRE, "k", 1, 9.0, 1.0),
              pw.encode_request(6, pw.OP_PEEK, "k", 0, 9.0, 1.0),
              pw.encode_request(7, pw.OP_WINDOW, "k", 1, 7.0, 2.0),
              pw.encode_request(8, pw.OP_FWINDOW, "k", 1, 7.0, 2.0),
              pw.encode_bulk_request(9, [b"a", b"b"], np.ones(2, np.int64),
                                     9.0, 1.0),
              pw.encode_bulk_request(10, [b"a"], np.ones(1, np.int64), 7.0,
                                     2.0, kind=pw.BULK_KIND_WINDOW),
              pw.encode_request(11, pw.OP_ACQUIRE_H, "k", 1, 5.0, 1.0,
                                hier=("t", 9.0, 1.0, 0)),
              pw.encode_request(12, pw.OP_ACQUIRE_H, "k", 1, 9.0, 1.0,
                                hier=("t", 20.0, 1.0, 0)),
              pw.encode_request(13, pw.OP_RESERVE, json.dumps(
                  {"rid": "r", "tenant": "t", "key": "k", "estimate": 2.0,
                   "a": 5.0, "b": 1.0, "ta": 9.0, "tb": 1.0})),
              pw.encode_request(14, pw.OP_CONFIG, "{}"),
              pw.encode_request(15, pw.OP_STATS)]

    async def scenario(pk):
        async def fn(srv, _c, store):
            reader, writer = await asyncio.open_connection(srv.host,
                                                           srv.port)
            try:
                out = {}
                for f in frames:
                    writer.write(f)
                    await writer.drain()
                    body = await asyncio.wait_for(pw.read_frame(reader), 10)
                    out[int.from_bytes(body[1:5], "little")] = body
                return out
            finally:
                writer.close()

        return await _served(pk, "serial", fn)

    port, jax = _both(scenario)
    stats = [json.loads(pw.decode_response(r[15])[2][0]) for r in (port,
                                                                   jax)]
    assert stats[0]["config"] == stats[1]["config"]
    assert stats[0]["config"]["moved_errors"] == 8
    for seq in range(1, 15):
        assert port[seq] == jax[seq], (seq, pw.decode_response(port[seq]),
                                       pw.decode_response(jax[seq]))
    assert all(b"config moved" in port[s] for s in range(5, 14)
               if s != 8)


def test_config_families_render_like_jax():
    """``OP_STATS``' ``config`` section and the ``drl_config_*`` families
    after the same mutation and moved answers."""
    async def scenario(pk):
        async def fn(srv, c, store):
            await c.config_announce({"prepare": {
                "kind": "bucket", "old": [9.0, 1.0], "new": [4.0, 1.0]},
                "version": 1})
            await c.config_announce({"commit": 1})
            await c.config_announce({"prepare": {
                "kind": "bucket", "old": [3.0, 1.0], "new": [2.0, 1.0]},
                "version": 2})
            await c.config_announce({"abort": 2})
            await c.acquire("k", 1, 9.0, 1.0)
            text = await c.metrics()
            lines = [ln for ln in text.splitlines() if "drl_config_" in ln]
            return (await c.stats())["config"], lines

        return await _served(pk, "serial", fn)

    port, jax = _both(scenario)
    assert port == jax
    assert port[0]["aborts"] == 1 and port[0]["moved_errors"] == 1
    assert any(ln.startswith("drl_config_commits_total") for ln in port[1])


# -- the cluster coordinator ------------------------------------------------------

async def _cluster(pk, fault: bool):
    backings = [pk.Serial(clock=pk.Clock(START)) for _ in range(2)]
    servers = [pk.Server(b) for b in backings]
    for s in servers:
        await s.start()
    cluster = ClusterBucketStore(
        addresses=[(s.host, s.port) for s in servers],
        coalesce_requests=False, request_timeout_s=5.0, retry_policy=None)
    out = []
    try:
        keys = [f"c{i}" for i in range(40)]
        for i, k in enumerate(keys):
            await cluster.acquire(k, i % 7 + 1, 100.0, 0.0)
        if fault:
            jfaults.install(jfaults.FaultInjector(3, {
                "cluster.config": (jfaults.FaultRule("error",
                                                     probability=1.0),)}))
            out.append(await _aoutcome(cluster.mutate_config(
                "bucket", (100.0, 0.0), (50.0, 0.0))))
            out.append((cluster.config_aborts,
                        cluster.migration_log[-1]["type"]))
            jfaults.uninstall()
            out.append([(s.liveconfig.active, s.liveconfig.version)
                        for s in servers])
            out.append(tuple(await cluster.acquire("c0", 0, 100.0, 0.0)))
        out.append(await cluster.mutate_config("bucket", (100.0, 0.0),
                                               (50.0, 0.0)))
        out.append(await cluster.mutate_config("bucket", (50.0, 0.0),
                                               (30.0, 0.0)))
        out.append([s.liveconfig.stats() for s in servers])
        out.append([[b.peek_blocking(k, 30.0, 0.0) for k in keys]
                    for b in backings])
        out.append([tuple(await cluster.acquire(k, 1, 100.0, 0.0))
                    for k in keys[:8]])
        return out
    finally:
        jfaults.uninstall()
        await cluster.aclose()
        for s in servers:
            await s.aclose()


@pytest.mark.parametrize("fault", [False, True])
def test_jax_cluster_mutates_port_servers_like_jax_servers(fault):
    """JAX's ``ClusterBucketStore.mutate_config`` over two port servers and
    over two JAX servers: the same versions, stats and balances; with a
    prepare fault injected, the same clean abort (nothing committed
    anywhere), then the same mutation commits."""
    port, jax = _both(_cluster, fault)
    assert port == jax
    if fault:
        assert port[0][0] == "ConfigError"
        assert port[1] == (1, "config_abort")
        assert port[2] == [(False, 0), (False, 0)]
        assert port[3][0]
    versions = port[-5:-3]
    assert versions == [1, 2]
    bal = port[-2]
    spent = [i % 7 + 1 for i in range(40)]
    merged = [min(a, b) for a, b in zip(*bal)]  # the other node: full
    assert merged == [30.0 - s for s in spent]


# -- reservations across a commit ---------------------------------------------------

async def _rehome(pk, backing):
    fill, child = 1e-9, (1e6, 1e-9)

    async def fn(srv, st, store):
        r = await st.reserve("c1", "t", "k", 100, 1000.0, fill, *child)
        out = [r.granted]
        out.append(await st.config_announce({
            "prepare": {"kind": "bucket", "old": [1000.0, fill],
                        "new": [600.0, fill]}, "version": 1}))
        out.append(await st.config_announce({"commit": 1}))
        out.append(store.peek_blocking("t", 600.0, fill))
        s = await st.settle("c1", "t", 30.0)
        out.append((s.outcome, s.refunded))
        out.append(store.peek_blocking("t", 600.0, fill))
        out.append(srv.reservations.rehomed)
        return out

    return await _served(pk, backing, fn)


@pytest.mark.parametrize("backing", BACKINGS)
def test_config_rebase_rehomes_settles(backing):
    """JAX ``tests/test_reservations.py:478``: a hold reserved before a
    commit and settled after it refunds into the NEW table (the ledger's
    lazy re-home through the forwarding rules), counted ``rehomed``."""
    port, jax = _both(_rehome, backing)
    assert port == jax
    assert port[:3] == [True, 0, 1]
    assert port[3] == pytest.approx(500.0)
    assert port[4] == ("settled", 70.0)
    assert port[5] == pytest.approx(570.0)
    assert port[6] >= 1
