"""The port's placement plane (``runtime/placement.py``) against the JAX
package's, on the CPU.

Every case runs the same seeded inputs through both packages and holds the
port to JAX's answers:

- the map: ``PlacementMap`` routing (``route``, ``node_of``, overrides),
  ``rebalance_moves``, ``with_assignments``, the JSON codec (bytes equal),
  and the errors;
- the entry lanes: ``extract_entries`` of the serial store and of the card
  store (``DeviceBucketStore(device="cpu")``) after the same traffic on a
  ManualClock, ``debit_export``, ``split_entries``, ``chunk_entries``
  (row and byte budgets) and ``merge_entries``;
- the generic import into both packages' card stores (every key peeked:
  bucket balances exact on the frozen clock, counters within 2 float32
  ulps — XLA on the CPU contracts the decay into an FMA, the port never
  does) and the exact merge into both serial stores;
- ``NodePlacementState``: seeded sequences of announce, gate, bulk_gate,
  pull (pages), push, re-push, abort and window expiry on an injected clock
  (verdicts, MOVED strings, ``stats()`` and the pulled pages equal);
- the export outcome of the fingerprint and mesh stores (a mesh snapshot
  has neither ``tables`` nor ``buckets``: both raise the same
  ``ValueError``).

Three deliberate divergences are pinned: the generic lane replays a
section's windows, counters and semaphores concurrently (flushes of many
rows, where JAX launches a row at a time; the state after is equal), a
push page's debit pads to a power of two >= 8 rows (JAX: 64), which moves
``rows_processed`` and not the state, and a pull parks its slots before
its export (JAX after it), so a moved key serves from the envelope while
the export runs.
"""

from __future__ import annotations

import asyncio
import json
import threading
import types
import zlib

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
from distributedratelimiting.redis_tpu.runtime import placement as jpl
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JDevice,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JSerial,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    FingerprintBucketStore,
    InProcessBucketStore,
    ManualClock,
    MeshBucketStore,
)
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh
from distributedratelimiting.redis_tpu_torch.runtime import placement as ppl

torch.set_num_threads(1)

START = 1_000_000
LIMIT_S = 120

JAX = types.SimpleNamespace(
    name="jax", pl=jpl, Clock=JClock, Serial=JSerial,
    device=lambda clock: JDevice(clock=clock, n_slots=512))
PORT = types.SimpleNamespace(
    name="port", pl=ppl, Clock=ManualClock, Serial=InProcessBucketStore,
    device=lambda clock: DeviceBucketStore(device="cpu", clock=clock,
                                           n_slots=512))
PKGS = (JAX, PORT)

KEYS = ["hot", "alpha", "beta", "k" * 40, "\udc80bytes", "zeta", "t:9",
        "ключ"]


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _keys(rng, n: int) -> list:
    return KEYS + [f"u{int(i)}" for i in rng.integers(0, 10**6, n)]


def _ulps(a: float, b: float, n: int = 2) -> bool:
    a, b = np.float32(a), np.float32(b)
    return abs(float(a) - float(b)) <= n * float(
        np.spacing(max(abs(a), abs(b), np.float32(1e-30))))


# -- the map ------------------------------------------------------------------

@pytest.mark.parametrize("n_nodes", [1, 2, 3, 5, 8])
def test_initial_routes_as_crc32_modulus(n_nodes):
    rng = np.random.default_rng(n_nodes)
    keys = _keys(rng, 300)
    pm, jm = (p.pl.PlacementMap.initial(n_nodes) for p in (PORT, JAX))
    want = [zlib.crc32(k.encode("utf-8", "surrogateescape")) % n_nodes
            for k in keys]
    assert pm.route(keys).tolist() == want
    assert jm.route(keys).tolist() == want
    assert [pm.node_of(k) for k in keys] == want
    assert pm.to_json() == jm.to_json()


@pytest.mark.parametrize("seed", range(4))
def test_map_evolution_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 6))
    keys = _keys(rng, 400)
    per_node = int(rng.integers(4, 17)) if seed % 2 else 16
    maps = {p.name: p.pl.PlacementMap.initial(n, slots_per_node=per_node)
            for p in PKGS}
    # One seeded plan, applied to both: joins, drains, hot-key overrides.
    plans = []
    active = list(range(n))
    for _step in range(4):
        if rng.random() < 0.5 or len(active) < 2:
            active.append(max(active) + 1)
        else:
            active.remove(int(rng.choice(active)))
        pins = {str(k): int(rng.choice(active))
                for k in rng.choice(keys, 3, replace=False)}
        drops = ([str(rng.choice(list(plans[-1][1])))]
                 if plans and plans[-1][1] else [])
        plans.append((sorted(active), pins, drops))
    for active, pins, drops in plans:
        out = {}
        for p in PKGS:
            m = maps[p.name]
            moves = m.rebalance_moves(active)
            nxt = m.with_assignments(moves, set_overrides=pins,
                                     drop_overrides=drops)
            out[p.name] = (moves, nxt.to_json(), nxt.route(keys).tolist(),
                           [nxt.node_of(k) for k in keys],
                           nxt.owned_slots(active[0]).tolist(),
                           nxt.slot_counts(max(active) + 1).tolist(),
                           sorted(nxt.nodes_in_use()),
                           nxt.override_slots().tolist(), repr(nxt),
                           nxt.rebalance_moves(active))
            maps[p.name] = nxt
        assert out["port"] == out["jax"]
        assert out["port"][-1] == {}  # balanced after its own plan
        back = PORT.pl.PlacementMap.from_json(out["port"][1])
        assert back == maps["port"] and back.to_json() == out["jax"][1]


def test_map_errors_match_jax():
    def outcome(fn):
        try:
            fn()
        except Exception as exc:  # noqa: BLE001
            return type(exc).__name__, str(exc)
        return None

    for p_fn in (
            lambda p: p.pl.PlacementMap(0, []),
            lambda p: p.pl.PlacementMap.initial(0),
            lambda p: p.pl.PlacementMap.initial(2).with_assignments({64: 1}),
            lambda p: p.pl.PlacementMap.initial(2).rebalance_moves([]),
            lambda p: p.pl.PlacementMap.from_dict(
                {"epoch": 1, "n_slots": 3, "slot_owner": [0, 1]})):
        got = [outcome(lambda: p_fn(p)) for p in PKGS]
        assert got[0] == got[1] and got[0] is not None


# -- the entry lanes ----------------------------------------------------------

async def _traffic(store, clock, seed: int) -> None:
    """A seeded mix on one store: two bucket configs, sliding and fixed
    windows, counters, semaphores; whole ticks between the steps."""
    rng = np.random.default_rng(seed)
    keys = _keys(rng, 120)
    for step in range(3):
        ks = [keys[i] for i in rng.integers(0, len(keys), 200)]
        await store.acquire_many(ks, rng.integers(0, 4, 200).tolist(),
                                 12.0, 2.0)
        await store.acquire_many(ks[:50], [1] * 50, 6.0, 0.5)
        wk = [keys[i] for i in rng.integers(0, len(keys), 60)]
        await store.window_acquire_many(wk, rng.integers(1, 3, 60).tolist(),
                                        20.0, 1.0)
        await store.window_acquire_many(wk[:20], [2] * 20, 9.0, 2.0,
                                        fixed=True)
        for k in keys[:12]:
            await store.sync_counter(k, float(rng.integers(1, 9)), 4.0)
        for k in keys[:10]:
            await store.concurrency_acquire(k, int(rng.integers(1, 3)), 5)
        clock.advance_seconds(0.25 * (step + 1))


def _stores(kind: str) -> dict:
    out = {}
    for p in PKGS:
        clock = p.Clock(START)
        store = p.Serial(clock=clock) if kind == "serial" else p.device(clock)
        out[p.name] = (store, clock)
    return out


def _assert_entries(got: dict, want: dict) -> None:
    """Two exports equal row for row (rows sorted by key): exact but a
    counter's decayed value, within 2 float32 ulps."""
    assert set(got) == set(want)
    for section in want:
        g = sorted(got[section], key=repr)
        w = sorted(want[section], key=repr)
        assert len(g) == len(w), section
        for rg, rw in zip(g, w):
            if section == "counters":  # value and period EWMA decay
                assert rg[0] == rw[0] and rg[3] == rw[3], (rg, rw)
                assert _ulps(rg[1], rw[1]) and _ulps(rg[2], rw[2]), (rg, rw)
            else:
                assert rg == rw, (section, rg, rw)


def _keep(n_slots: int, slots, keys=None):
    return {p.name: p.pl.keep_predicate(n_slots, {}, frozenset(slots),
                                        keys) for p in PKGS}


@pytest.mark.parametrize("kind", ["serial", "device"])
def test_extract_entries_matches_jax(kind):
    stores = _stores(kind)
    for name, (store, clock) in stores.items():
        run(_traffic(store, clock, 7))
    keep = _keep(16, {1, 3, 4, 9, 15}, frozenset({"hot"}))
    got = {name: s.export_entries(keep[name])
           for name, (s, _c) in stores.items()}
    _assert_entries(got["port"], got["jax"])
    assert all(got["port"][k] for k in ("buckets", "windows", "counters",
                                        "semas"))
    # The predicate: "hot" by name, the rest by slot.
    slots = {1, 3, 4, 9, 15}
    for row in got["port"]["buckets"]:
        assert row[0] == "hot" or ppl.PlacementMap.initial(1, 16).slot_of(
            row[0]) in slots
    # The card store's snapshot schema through the module function too.
    snap = stores["port"][0].snapshot()
    _assert_entries(ppl.extract_entries(snap, keep["port"]), got["port"])


def test_extract_rejects_unknown_schema_as_jax():
    msgs = []
    for p in PKGS:
        with pytest.raises(ValueError) as exc:
            p.pl.extract_entries({"now_ticks": 0}, lambda k: True)
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("fraction", [0.5, 0.25])
def test_debit_split_chunk_merge_match_jax(monkeypatch, fraction):
    store, clock = _stores("serial")["port"]
    run(_traffic(store, clock, 11))
    long_keys = ["L" * 5000 + str(i) for i in range(12)] + [
        "\udc80" * 900 + "x"]
    run(store.acquire_many(long_keys, [1] * len(long_keys), 12.0, 2.0))
    entries = store.export_entries(lambda k: True)
    entries["reservations"] = [["t1", "r1", "k1", 4.0, 9.0, 1.0, 20.0, 2.0,
                                0, 3.5]]
    entries["debts"] = [["t1", 2.5, "epoch:3"]]
    for p in PKGS:
        monkeypatch.setattr(p.pl, "_CHUNK_BYTE_BUDGET", 20_000)
    target = PORT.pl.PlacementMap.initial(3)
    jtarget = JAX.pl.PlacementMap.initial(3)
    out = {}
    for p, m in ((PORT, target), (JAX, jtarget)):
        debited = p.pl.debit_export(entries, fraction)
        split = p.pl.split_entries(debited, m.node_of)
        chunks = {dst: p.pl.chunk_entries(sub, max_rows=17)
                  for dst, sub in split.items()}
        merged = {}
        for dst, cs in chunks.items():
            acc = {}
            for c in cs:
                acc = p.pl.merge_entries(acc, c)
            merged[dst] = acc
        out[p.name] = (debited, split, chunks, merged,
                       p.pl.entry_count(debited),
                       p.pl.chunk_entries({}),
                       [len(json.dumps(c)) for cs in chunks.values()
                        for c in cs])
    assert out["port"] == out["jax"]
    debited, split, chunks, merged = out["port"][:4]
    assert merged == split
    assert max(out["port"][-1]) < 1 << 20  # every page fits MAX_FRAME
    assert any(len(cs) > 2 for cs in chunks.values())


async def _import(store, entries):
    return await (JAX if isinstance(store, JDevice) else PORT).pl.\
        import_entries(store, entries)


def test_generic_import_matches_jax():
    """Entries from a seeded export land in fresh card stores of both
    packages through the generic lane: buckets through the debit (exact on
    the frozen clock), windows, counters and semaphores replayed."""
    src, clock = _stores("serial")["port"]
    run(_traffic(src, clock, 23))
    entries = ppl.debit_export(src.export_entries(lambda k: True), 0.5)
    assert all(entries[s] for s in ("buckets", "windows", "counters",
                                    "semas"))
    fresh = {p.name: p.device(p.Clock(START)) for p in PKGS}
    counts = {name: run(_import(s, entries)) for name, s in fresh.items()}
    assert counts["port"] == counts["jax"] == ppl.entry_count(entries)
    for key, cap, rate, tokens, _age in entries["buckets"]:
        got = [fresh[n].peek_blocking(key, cap, rate) for n in ("port",
                                                                  "jax")]
        # A peek reads the balance floored.
        assert got[0] == got[1] == np.floor(tokens), (key, got, tokens)
    exports = {n: s.export_entries(lambda k: True)
               for n, s in fresh.items()}
    _assert_entries(exports["port"], exports["jax"])
    landed = {(r[0], r[1], r[2]): r[3] for r in exports["port"]["buckets"]}
    for key, cap, rate, tokens, _age in entries["buckets"]:
        assert landed[(key, cap, rate)] == np.float32(tokens)
    # The generic lane's rules: a current window replays ceil(curr), a
    # fresh counter adopts the value, a semaphore its held permits.
    windows = {(r[0], r[1], r[2], r[3]): r for r in exports["port"]["windows"]}
    for key, limit, wt, interp, _prev, curr, behind in entries["windows"]:
        if behind == 0 and curr > 0:
            assert windows[(key, limit, wt, interp)][5] == np.ceil(curr)
    values = {r[0]: r[1] for r in exports["port"]["counters"]}
    for key, value, _p, _a in entries["counters"]:
        assert _ulps(values[key], value)
    assert sorted(exports["port"]["semas"]) == sorted(entries["semas"])


def test_generic_replay_is_concurrent():
    """The deliberate divergence: a section's rows replay concurrently, so
    a card store decides 200 windows in a few flushes where JAX's
    row-by-row replay launches once a row — and ends in the same state."""
    entries = {"windows": [[f"w{i}", 50.0, 1024, 1, 0.0, float(1 + i % 7),
                            0] for i in range(200)]}
    fresh = {p.name: p.device(p.Clock(START)) for p in PKGS}
    before = {n: s.metrics.snapshot()["launches"] for n, s in fresh.items()}
    for s in fresh.values():
        run(_import(s, entries))
    launches = {n: s.metrics.snapshot()["launches"] - before[n]
                for n, s in fresh.items()}
    assert launches["jax"] == 200
    assert launches["port"] < 20
    exports = {n: s.export_entries(lambda k: True)
               for n, s in fresh.items()}
    _assert_entries(exports["port"], exports["jax"])


def test_push_debit_pads_to_a_power_of_two():
    """The other divergence: one push page of 10 bucket rows is one debit
    launch of 16 rows on the port's card store (JAX pads to 64); the state
    is equal."""
    entries = {"buckets": [[f"b{i}", 12.0, 2.0, float(i), 0]
                           for i in range(10)]}
    fresh = {p.name: p.device(p.Clock(START)) for p in PKGS}
    before = {n: s.metrics.snapshot()["rows_processed"]
              for n, s in fresh.items()}
    for name, s in fresh.items():
        ps = (PORT if name == "port" else JAX).pl.NodePlacementState()
        assert run(ps.push({"target_epoch": 1, "batch": 0,
                            "entries": entries}, s)) == 10
    rows = {n: s.metrics.snapshot()["rows_processed"] - before[n]
            for n, s in fresh.items()}
    assert rows == {"port": 16, "jax": 64}
    for i in range(10):
        got = [fresh[n].peek_blocking(f"b{i}", 12.0, 2.0)
               for n in ("port", "jax")]
        assert got == [float(i), float(i)]


def test_exact_merge_matches_jax():
    """The serial store's exact merge lane: pre-existing local state on
    some keys, then the same entries imported twice (a re-pushed batch):
    conservative on every collision, equal to JAX's."""
    src, clock = _stores("serial")["port"]
    run(_traffic(src, clock, 31))
    entries = ppl.debit_export(src.export_entries(lambda k: True), 0.5)
    snaps = {}
    for p in PKGS:
        dst = p.Serial(clock=p.Clock(START + 512))
        run(_traffic(dst, dst.clock, 32))
        n1 = run(p.pl.import_entries(dst, entries))
        n2 = run(p.pl.import_entries(dst, entries))
        snaps[p.name] = (n1, n2, dst.snapshot())
    assert snaps["port"][:2] == snaps["jax"][:2]
    got, want = snaps["port"][2], snaps["jax"][2]
    assert got["buckets"] == want["buckets"]
    assert got["windows"] == want["windows"]
    assert got["semas"] == want["semas"]
    assert got["counters"].keys() == want["counters"].keys()
    for k, (v, per, ts) in want["counters"].items():
        gv, gper, gts = got["counters"][k]
        assert _ulps(gv, v) and (gper, gts) == (per, ts)


# -- NodePlacementState -------------------------------------------------------

def _verdict(v):
    """A gate verdict in comparable form (a handoff by its target epoch)."""
    if v is None:
        return None
    what, info = v
    return (what, info.target_epoch if what == "envelope" else int(info))


def _bulk(v):
    if v is None:
        return None
    serve, env, moved = v
    return (serve.tolist(), [(i, h.target_epoch) for i, h in env],
            moved.tolist())


async def _node_sequence(p, backing: str, seed: int) -> list:
    """A seeded life of one node: announce, gates, a paged pull, pushes
    and re-pushes, envelope serving, abort, a late pull after expiry, the
    abort announce, commit. Everything observable, in order."""
    rng = np.random.default_rng(seed)
    now = [100.0]
    clock = p.Clock(START)
    store = (p.Serial(clock=clock) if backing == "serial"
             else p.device(clock))
    ps = p.pl.NodePlacementState(clock=lambda: now[0])
    keys = _keys(rng, 150)
    await store.acquire_many(keys, rng.integers(1, 5, len(keys)).tolist(),
                             20.0, 1.0)
    await store.window_acquire_many(keys[:40], [2] * 40, 30.0, 1.0)
    await store.sync_counter(keys[0], 5.0, 1.0)
    await store.concurrency_acquire(keys[1], 2, 4)
    led = store.reservation_ledger()
    led._clock = lambda: now[0]  # the TTLs on the injected clock too
    res = await led.reserve("rid-1", keys[2], keys[3], 4.0, 50.0, 1.0,
                            20.0, 1.0)
    log = [res.granted]

    def expect(exc_type, fn):
        try:
            fn()
        except exc_type as exc:
            return (type(exc).__name__, str(exc))
        raise AssertionError("no error")

    async def aexpect(exc_type, coro):
        try:
            await coro
        except exc_type as exc:
            return (type(exc).__name__, str(exc))
        raise AssertionError("no error")

    m0 = p.pl.PlacementMap.initial(2)
    log.append(await aexpect(p.pl.PlacementError, ps.pull(
        {"target_epoch": 1}, store)))
    log.append(ps.announce({"map": m0.to_dict(), "node_id": 0}))
    log.append(ps.announce({"map": m0.to_dict(), "node_id": 0}))
    log.append([_verdict(ps.gate(k)) for k in keys])
    log.append(_bulk(ps.bulk_gate(keys)))
    own = [k for k in keys if m0.node_of(k) == 0]
    log.append(_bulk(ps.bulk_gate(own)))
    pins = {keys[4]: 1, keys[5]: 0}
    m1 = m0.with_assignments({0: 1, 2: 1}, set_overrides=pins)
    slots = sorted(int(s) for s in rng.choice(m0.owned_slots(0), 4,
                                              replace=False))
    req = {"target_epoch": 1, "slots": slots, "keys": [keys[5]],
           "window_s": 5.0}
    out = await ps.pull(req, store)
    pages = [out]
    for page in range(1, out["pages"]):
        pages.append(await ps.pull({**req, "page": page}, store))
    log.append([(o["pages"], o["cached"], o["target_epoch"],
                 json.dumps(o["entries"], sort_keys=True)) for o in pages])
    log.append(await aexpect(p.pl.PlacementError, ps.pull(
        {**req, "page": out["pages"]}, store)))
    log.append(ps.snapshot_payload())
    log.append([_verdict(ps.gate(k)) for k in keys])
    log.append(_bulk(ps.bulk_gate(keys)))
    env = [v for v in (ps.gate(k) for k in keys) if v and v[0] ==
           "envelope"]
    assert env
    h = env[0][1]
    log.append([ps.envelope_acquire(h, k, int(c), 20.0, 1.0, "bucket",
                                    int(pr))
                for k, c, pr in zip(keys[:30], rng.integers(0, 4, 30),
                                    rng.integers(0, 3, 30))])
    log.append([ps.envelope_acquire(h, k, 3, 30.0, 1.0, "window")
                for k in keys[:10]])
    now[0] += 1.0
    log.append([ps.envelope_acquire(h, keys[0], 1, 20.0, 1.0, "bucket")
                for _ in range(3)])
    log.append([ps.moved_message(k, 1) for k in keys[:3]])
    # Pushes: exactly once per (epoch, batch), re-applied after an abort.
    push = {"target_epoch": 2, "batch": 5,
            "entries": {"buckets": [["pushed", 20.0, 1.0, 7.0, 0]],
                        "reservations": [["ten", "rid-9", "kk", 3.0, 50.0,
                                          1.0, 20.0, 1.0, 0, 30.0]]}}
    log.append(await ps.push(push, store))
    log.append(await ps.push(push, store))
    log.append(ps.announce({"abort_epoch": 2}))
    log.append(await ps.push(push, store))
    log.append(store.peek_blocking("pushed", 20.0, 1.0))
    # A conflicting twin at the adopted epoch, and a stale one.
    twin = p.pl.PlacementMap(0, m0.slot_owner[::-1].copy())
    log.append(expect(p.pl.StalePlacementError, lambda: ps.announce(
        {"map": twin.to_dict(), "node_id": 0})))
    # Window expiry: the gate auto-aborts, a late pull is refused until the
    # coordinator's abort announce re-arms the epoch.
    now[0] += 10.0
    log.append([_verdict(ps.gate(k)) for k in keys])
    log.append(await aexpect(p.pl.PlacementError, ps.pull(req, store)))
    log.append(ps.announce({"abort_epoch": 1}))
    out = await ps.pull(req, store)
    log.append((out["cached"], out["pages"]))
    log.append(ps.announce({"map": m1.to_dict(), "node_id": 0}))
    log.append([_verdict(ps.gate(k)) for k in keys])
    log.append(_bulk(ps.bulk_gate(keys)))
    log.append(expect(p.pl.StalePlacementError, lambda: ps.announce(
        {"map": m0.to_dict(), "node_id": 0})))
    log.append(ps.stats())
    log.append(sorted(led.export_rows(lambda k: True)[0]))
    return log


@pytest.mark.parametrize("backing", ["serial", "device"])
@pytest.mark.parametrize("seed", [0, 1])
def test_node_state_sequence_matches_jax(monkeypatch, backing, seed):
    for p in PKGS:
        monkeypatch.setattr(p.pl, "_CHUNK_BYTE_BUDGET", 1_200)
    got = {p.name: run(_node_sequence(p, backing, seed)) for p in PKGS}
    assert len(got["port"]) == len(got["jax"])
    for i, (a, b) in enumerate(zip(got["port"], got["jax"])):
        assert a == b, i
    stats = got["port"][-2]
    assert stats["pulls"] == 2 and stats["aborts"] == 1
    assert stats["expired_aborts"] == 1 and stats["pushes_duplicate"] == 1
    assert got["port"][6] is None  # every owned row served
    assert len(got["port"][7]) > 1  # the pull paged


def test_concurrent_pull_debits_the_source_once():
    """A post-send retry racing the original pull waits on the control
    lock and hits the cache: the card store is debited one envelope."""
    clock = ManualClock(START)
    store = DeviceBucketStore(device="cpu", clock=clock, n_slots=256)
    run(store.acquire("hot", 2, 40.0, 0.0))
    ps = ppl.NodePlacementState()
    m = ppl.PlacementMap.initial(1)
    ps.announce({"map": m.to_dict(), "node_id": 0})
    req = {"target_epoch": 1, "slots": [m.slot_of("hot")], "window_s": 30}

    async def both():
        return await asyncio.gather(ps.pull(req, store), ps.pull(req, store))

    a, b = run(both())
    assert sorted([a["cached"], b["cached"]]) == [False, True]
    assert ps.pulls == 1
    budget = ppl.headroom_budget(40.0, fraction=0.5, min_budget=1.0)
    assert store.peek_blocking("hot", 40.0, 0.0) == budget
    assert a["entries"]["buckets"] == [["hot", 40.0, 0.0, 38.0 - budget, 0]]


class _HeldExport:
    """A store whose export waits until ``release`` is set: the gap that a
    large store's export leaves while the event loop goes on serving."""

    def __init__(self, store) -> None:
        self.store = store
        self.entered = threading.Event()
        self.release = threading.Event()

    def export_entries(self, keep):
        self.entered.set()
        self.release.wait(LIMIT_S)
        return self.store.export_entries(keep)

    def __getattr__(self, name):
        return getattr(self.store, name)


async def _pull_with_gap(p, during):
    """A pull of the slot of ``hot`` (38 of 40 tokens, no refill) whose
    export is held open while ``during(ps, now)`` runs on the loop; returns
    ``(ps, store, during's result, the pull's reply or its error)``."""
    now = [100.0]
    store = p.device(p.Clock(START))
    await store.acquire("hot", 2, 40.0, 0.0)
    ps = p.pl.NodePlacementState(clock=lambda: now[0])
    m = p.pl.PlacementMap.initial(1)
    ps.announce({"map": m.to_dict(), "node_id": 0})
    held = _HeldExport(store)
    task = asyncio.ensure_future(ps.pull(
        {"target_epoch": 1, "slots": [m.slot_of("hot")], "window_s": 5.0},
        held))
    await asyncio.to_thread(held.entered.wait, LIMIT_S)
    seen = during(ps, now)
    held.release.set()
    try:
        out = await task
    except p.pl.PlacementError as exc:
        out = exc
    return ps, store, seen, out


def test_pull_parks_before_its_export():
    """A deliberate divergence: the port parks the pulled slots before the
    export (JAX after it). Inside the export's gap a moved key serves from
    the envelope on the port, and the handoff window does not run yet;
    JAX's gate still serves it from the full store balance, which ships as
    well. Old + new stays within the balance plus one envelope."""
    budget = ppl.headroom_budget(40.0, fraction=0.5, min_budget=1.0)

    def gap(ps, now):
        verdict = ps.gate("hot")
        grants = 0
        if verdict is not None:
            now[0] += 60.0  # longer than the window: it has not opened
            grants = sum(ps.envelope_acquire(verdict[1], "hot", 1, 40.0,
                                             0.0, "bucket")[0]
                         for _ in range(40))
        return _verdict(verdict), grants

    _, _, (jax_verdict, _), _ = run(_pull_with_gap(JAX, gap))
    assert jax_verdict is None
    ps, store, (verdict, old), out = run(_pull_with_gap(PORT, gap))
    assert verdict == ("envelope", 1)
    assert old == budget
    (row,) = out["entries"]["buckets"]
    assert row[:4] == ["hot", 40.0, 0.0, 38.0 - budget]
    assert old + row[3] <= 38.0 + budget
    assert store.peek_blocking("hot", 40.0, 0.0) == budget
    assert _verdict(ps.gate("hot")) == ("envelope", 1)  # window 5 s from now
    assert ps.stats()["expired_aborts"] == 0


def test_abort_during_the_export_leaves_the_source_whole():
    """An abort announced while the export runs drops the parked handoff:
    the pull answers an error, nothing is debited, and the key serves from
    the source's store again."""
    def gap(ps, now):
        ps.announce({"abort_epoch": 1})
        return _verdict(ps.gate("hot"))

    ps, store, verdict, out = run(_pull_with_gap(PORT, gap))
    assert verdict is None
    assert isinstance(out, ppl.PlacementError)
    assert "aborted during its export" in str(out)
    assert store.peek_blocking("hot", 40.0, 0.0) == 38.0
    assert ps.stats()["pulls"] == 0 and ps.snapshot_payload()[
        "parked_slots"] == []


# -- the fingerprint and mesh stores -------------------------------------------

def _outcome(store, keep):
    try:
        return ("entries", store.export_entries(keep))
    except Exception as exc:  # noqa: BLE001
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("traffic", ["buckets", "counters only"])
def test_fp_store_export_matches_jax(traffic):
    """The fingerprint store exports exactly as JAX's does: its bucket
    tables have no key directory, so a store holding buckets raises JAX's
    ``KeyError``; its counters and semaphores (host directories) export."""
    stores = {"port": FingerprintBucketStore(device="cpu", n_slots=1024,
                                             clock=ManualClock(START)),
              "jax": jfs.FingerprintBucketStore(n_slots=1024,
                                                clock=JClock(START))}

    async def fill(st):
        if traffic == "buckets":
            await st.acquire_many(["a", "b"], [1, 2], 10.0, 1.0)
        await st.sync_counter("c", 3.0, 1.0)
        await st.concurrency_acquire("s", 1, 5)

    for st in stores.values():
        run(fill(st))
    got = {n: _outcome(s, lambda k: True) for n, s in stores.items()}
    assert got["port"] == got["jax"]
    assert got["port"][0] == ("KeyError" if traffic == "buckets"
                              else "entries")


def test_mesh_store_export_matches_jax():
    """A mesh snapshot has neither ``tables`` nor ``buckets``: both
    packages' ``export_entries`` raise the same ``ValueError``."""
    pstore = MeshBucketStore(Mesh(["cpu"] * 8), per_shard_slots=32,
                             clock=ManualClock(START))
    jstore = JMesh(jcreate_mesh(8), per_shard_slots=32, clock=JClock(START))
    for st in (pstore, jstore):
        run(st.acquire_many(["a", "b", "c"], [1, 1, 1], 10.0, 1.0))
    got = [_outcome(s, lambda k: True) for s in (pstore, jstore)]
    assert got[0] == got[1] and got[0][0] == "ValueError"
    assert "unrecognized snapshot schema" in got[0][1]
