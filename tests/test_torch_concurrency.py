"""The port's semaphores against the JAX package's: the plain kernels, the
store, ``ConcurrencyLimiter``, checkpoints and ``OP_SEMA`` on the wire.

Inputs come from numpy seeds and go through both packages. Tolerance:
none. Semaphore counts are whole numbers: ``sema_batch_packed``'s replies
and every state field (``active``, ``last_ts``, ``exists``),
``sweep_semas``' mask and ``rebase_sema_epoch``'s timestamps must be equal
bit for bit (the port's same-slot prefixes are int64 sums, JAX's float32
sums of whole numbers below 2^24: the same values). Store traces — scalar
acquires, probes and releases, unknown keys, the bulk lane with the
mixed-sign hazard route, free-list exhaustion (sweep, then grow), the idle
sweep, an epoch rebase, snapshots and checkpoint files both ways — must
give identical results, and so must the limiter scenarios (leases,
``available_permits``, queue counts, ``stats()`` less wall-clock fields)
and the four client/server pairings of ``OP_SEMA``.
"""

import asyncio
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.models.concurrency import (
    ConcurrencyLimiter as JLimiter,
)
from distributedratelimiting.redis_tpu.models.options import (
    ConcurrencyLimiterOptions as JOptions,
)
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.runtime import checkpoint as jcp
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.queueing import (
    QueueProcessingOrder as JOrder,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    ConcurrencyLease,
    ConcurrencyLimiter,
    ConcurrencyLimiterOptions,
    DeviceBucketStore,
    ManualClock,
    QueueProcessingOrder,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime import checkpoint as pcp

torch.set_num_threads(1)

TTL = 86400 * 1024
LIMIT_S = 20.0


def w(coro):
    return asyncio.wait_for(coro, LIMIT_S)


# -- plain kernels ------------------------------------------------------------

def _sema_inputs(seed, n, b, now=50_000):
    rng = np.random.default_rng(seed)
    state = (rng.integers(0, 6, n).astype(np.int32),
             rng.integers(now - 3000, now + 50, n).astype(np.int32),
             rng.random(n) < 0.6)
    slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
    slots[rng.random(b) < 0.05] = -1
    slots[rng.random(b) < 0.03] = n + 3
    packed = np.stack([slots, rng.integers(-2, 4, b).astype(np.int32),
                       rng.integers(0, 9, b).astype(np.int32),
                       np.full(b, now, np.int32)])
    return state, packed


def _jsema(arrays):
    return JK.SemaState(*(jnp.asarray(a) for a in arrays))


def _psema(arrays):
    return K.SemaState(*(torch.tensor(a) for a in arrays))


def _assert_state(jstate, pstate):
    for j, p in zip(jstate, pstate):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("b", [8, 256])
def test_sema_batch_plain_matches_jax(seed, b):
    """Duplicates (acquires, releases and probes of one slot in one batch),
    padding, out-of-range slots, limits below the held count."""
    state, packed = _sema_inputs(seed, 64, b)
    jstate, jout = JK.sema_batch_packed(_jsema(state), jnp.asarray(packed))
    pstate = _psema(state)
    pout = ck.sema_packed(pstate, torch.from_numpy(packed))  # CPU: plain
    np.testing.assert_array_equal(np.asarray(jout), pout.numpy())
    _assert_state(jstate, pstate)
    assert 0 < float(pout[0].sum()) < b


def test_sema_probe_neither_allocates_nor_refreshes():
    state = (np.array([0, 2], np.int32), np.array([10, 20], np.int32),
             np.array([False, True]))
    packed = np.array([[0, 1], [0, 0], [5, 5], [99, 99]], np.int32)
    jstate, jout = JK.sema_batch_packed(_jsema(state), jnp.asarray(packed))
    pstate = _psema(state)
    _, pout = K.sema_batch_packed(pstate, torch.from_numpy(packed))
    np.testing.assert_array_equal(np.asarray(jout), pout.numpy())
    _assert_state(jstate, pstate)
    assert pstate.exists.tolist() == [False, True]
    assert pstate.last_ts.tolist() == [10, 20]
    assert pout[1].tolist() == [0.0, 2.0]


@pytest.mark.parametrize("now", [TTL - 1, TTL + 40_000, 3 * TTL, -5])
def test_sweep_semas_plain_matches_jax(now):
    rng = np.random.default_rng(now & 0xFFFF)
    n = 3000
    state = (rng.integers(-1, 3, n).astype(np.int32),
             rng.integers(0, 2 * TTL, n).astype(np.int32),
             rng.random(n) < 0.5)
    jstate, jmask = JK.sweep_semas(_jsema(state), jnp.int32(now))
    pstate = _psema(state)
    mask, tiles = ck.sweep_semas(pstate, now)
    np.testing.assert_array_equal(np.asarray(jmask), mask.numpy().astype(bool))
    assert int(tiles.sum()) == int(np.asarray(jmask).sum())
    _assert_state(jstate, pstate)
    assert not (mask.numpy().astype(bool) & (state[0] > 0)).any()


@pytest.mark.parametrize("offset", [0, 700, 2**29])
def test_rebase_sema_epoch_matches_jax(offset):
    state, _ = _sema_inputs(offset, 500, 8, now=2**29 + 4000)
    jstate = JK.rebase_sema_epoch(_jsema(state), jnp.int32(offset))
    pstate = K.rebase_sema_epoch(_psema(state), offset)
    _assert_state(jstate, pstate)


# -- store traces ---------------------------------------------------------------

def _stores(**kw):
    kw.setdefault("counter_slots", 8)
    kw.setdefault("n_slots", 64)
    return (DeviceBucketStore(device="cpu", clock=ManualClock(1000), **kw),
            JStore(clock=JClock(1000), **kw))


async def _sema_trace(store):
    out = []
    for i in range(7):
        out.append(tuple(await store.concurrency_acquire("s", 1, 5)))
    await store.concurrency_release("s", 2)
    out.append(tuple(await store.concurrency_acquire("s", 0, 5)))
    out.append(store.concurrency_acquire_blocking("s", 2, 5))
    store.concurrency_release_blocking("s", 9)  # over-release clamps
    out.append(store.concurrency_acquire_blocking("s", 0, 5))
    # Unknown keys: a release and a probe allocate nothing.
    await store.concurrency_release("ghost", 1)
    out.append(tuple(await store.concurrency_acquire("ghost", 0, 5)))
    out.append(store._sema_dir.lookup("ghost"))
    # Bulk: duplicates, per-row limits, unknown-key release, and the
    # mixed-sign hazard route (key "m": an acquire and releases).
    r = await store.concurrency_acquire_many(
        ["a", "b", "a", "m", "m", "c", "a", "ghost", "m", "d"],
        [2, 1, 3, 2, -1, 0, -1, -1, 3, 0],
        [4, 4, 4, 5, 5, 4, 4, 4, 5, 1])
    out.append((r.granted.tolist(), r.remaining.tolist()))
    r = await store.concurrency_acquire_many(["a", "a", "b"], [1, 1, 1], 4)
    out.append((r.granted.tolist(), r.remaining.tolist()))
    # Exhaustion: 8 slots, 12 more keys — the zero-held slots of a day ago
    # are swept, then the table doubles.
    for k in ("a", "b", "m"):
        await store.concurrency_release(k, 9)
    store.clock.advance_seconds(86_401)
    r = await store.concurrency_acquire_many([f"n{i}" for i in range(12)],
                                             [1] * 12, 3)
    out.append((r.granted.tolist(), r.remaining.tolist(),
                int(store._semas.active.shape[0]),
                sorted(store._sema_dir.to_dict())))
    store.clock.advance_seconds(86_401)
    store.concurrency_release_blocking("n0", 1)
    store.sweep_all()
    out.append((store.metrics.slots_evicted,
                sorted(store._sema_dir.to_dict())))
    return out


def test_store_semaphores_match_jax():
    port, jax_ = _stores()
    got = asyncio.run(_sema_trace(port))
    want = asyncio.run(_sema_trace(jax_))
    assert got == want
    assert got[11] is None  # the ghost key never took a slot
    # The hazard route ran "m"'s rows one at a time: 2, then -1, then
    # 1 + 3 <= 5 — the release cannot swallow the granted acquire.
    assert got[12][0][3:5] == [True, True] and got[12][0][8] is True
    assert got[12][1][8] == 4.0
    for st in (port, jax_):
        for name, arr in st.snapshot()["semas"].items():
            np.testing.assert_array_equal(
                arr, jax_.snapshot()["semas"][name])


def test_sema_epoch_rebase_in_store_matches_jax():
    clocks = (ManualClock(2**20), JClock(2**20))
    stores = (DeviceBucketStore(device="cpu", clock=clocks[0],
                                rebase_threshold_ticks=2**21),
              JStore(clock=clocks[1], rebase_threshold_ticks=2**21))
    got = []
    for st, clock in zip(stores, clocks):
        st.concurrency_acquire_blocking("held", 2, 3)
        st.concurrency_acquire_blocking("idle", 1, 3)
        st.concurrency_release_blocking("idle", 1)
        clock.advance_ticks(2**21)  # past the threshold: the next op rebases
        res = [st.concurrency_acquire_blocking("held", 1, 3)]
        clock.advance_ticks(TTL - 2**21)
        st.sweep_all()
        res.append(sorted(st._sema_dir.to_dict()))
        res.append(np.asarray(st.snapshot()["semas"]["last_ts"]).tolist())
        got.append(res)
    assert got[0] == got[1]
    assert got[0][1] == ["held"]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_sema_snapshot_and_checkpoint_both_ways(tmp_path, direction):
    src_port = direction == "port_to_jax"
    src = (DeviceBucketStore(device="cpu", clock=ManualClock(5_000),
                             counter_slots=16) if src_port else
           JStore(clock=JClock(5_000), counter_slots=16))
    for i in range(6):
        src.concurrency_acquire_blocking(f"k{i}", i % 4, 4)
    src.concurrency_release_blocking("k3", 3)  # held 0, live: sweepable
    path = str(tmp_path / "semas.pkl")
    (pcp if src_port else jcp).save_snapshot(src, path)
    snap = src.snapshot()
    for how in ("snapshot", "file"):
        dst = (JStore(clock=JClock(700_000), counter_slots=16) if src_port
               else DeviceBucketStore(device="cpu",
                                      clock=ManualClock(700_000),
                                      counter_slots=16))
        if how == "snapshot":
            dst.restore(snap)
        else:
            (jcp if src_port else pcp).load_snapshot(dst, path)
        probes = [tuple(dst.concurrency_acquire_blocking(f"k{i}", 0, 4))
                  for i in range(6)]
        assert probes == [(True, float(i % 4)) if i != 3 else (True, 0.0)
                          for i in range(6)]
        assert not dst.concurrency_acquire_blocking("k2", 3, 4).granted
        dst.clock.advance_seconds(86_400)
        dst.sweep_all()
        # Only the zero-held slots expire a day after their last touch.
        assert sorted(dst._sema_dir.to_dict()) == ["k1", "k2", "k5"]


def test_pre_semaphore_checkpoint_still_loads():
    src = JStore(clock=JClock(5_000))
    src.acquire_blocking("b", 2, 5.0, 1.0)
    snap = src.snapshot()
    del snap["semas"], snap["sema_dir"]
    dst = DeviceBucketStore(device="cpu", clock=ManualClock(5_000))
    dst.concurrency_acquire_blocking("held", 1, 2)
    dst.restore(snap)
    assert dst.peek_blocking("b", 5.0, 1.0) == 3.0
    assert dst.concurrency_acquire_blocking("held", 0, 2) == (True, 1.0)


# -- the limiter ------------------------------------------------------------------

class _PortStore(DeviceBucketStore):
    def __init__(self, clock, **kw):
        super().__init__(device="cpu", clock=clock, **kw)


PORT = SimpleNamespace(Store=_PortStore, Clock=ManualClock,
                       Limiter=ConcurrencyLimiter,
                       Options=ConcurrencyLimiterOptions,
                       Order=QueueProcessingOrder)
JAX = SimpleNamespace(Store=JStore, Clock=JClock, Limiter=JLimiter,
                      Options=JOptions, Order=JOrder)
KITS = pytest.mark.parametrize("kit", [PORT, JAX], ids=["port", "jax"])

_WALL = ("acquire_p50_s", "acquire_p99_s", "last_sync_lag_s")


def _stats(lim) -> dict:
    return {k: v for k, v in lim.stats().items() if k not in _WALL}


async def _parked(lim, n):
    deadline = time.monotonic() + LIMIT_S
    while len(lim._queue) < n:
        assert time.monotonic() < deadline, "waiter never parked"
        await asyncio.sleep(0.001)


async def _until(cond, what):
    """Wait for ``cond()``: a fixed sleep can be too short under load."""
    deadline = time.monotonic() + LIMIT_S
    while not cond():
        assert time.monotonic() < deadline, what
        await asyncio.sleep(0.001)


async def _finished(tasks, n):
    """Wait until n of ``tasks`` are done: under load a rejected acquire can
    still be finishing after the queue has filled."""
    deadline = time.monotonic() + LIMIT_S
    while sum(t.done() for t in tasks) < n:
        assert time.monotonic() < deadline, "tasks never finished"
        await asyncio.sleep(0.001)


async def limiter_cap5(kit, store):
    """permit_limit 5 and 32 concurrent acquires: exactly 5 leases, the
    queued waiters drained by releases and failed by dispose; a second
    limiter with the same instance_name shares the semaphore."""
    opts = kit.Options(permit_limit=5, queue_limit=8,
                       instance_name="shared", retry_period_s=0.01)
    lim, twin = kit.Limiter(opts, store), kit.Limiter(opts, store)
    log = []
    tasks = [asyncio.ensure_future(lim.acquire_async(1)) for _ in range(32)]
    await _parked(lim, 8)
    await _finished(tasks, 24)  # 5 leases and 19 rejected past the queue
    done = [t for t in tasks if t.done()]
    leases = [t.result() for t in done]
    log.append(sorted(bool(x) for x in leases))
    held = [x for x in leases if x.is_acquired]
    assert len(held) == 5 and len(done) == 24
    log.append((lim.available_permits(), twin.available_permits()))
    assert not twin.acquire(1).is_acquired  # shared: the twin sees 5 held
    held[0].dispose()
    held[0].dispose()  # idempotent
    await held[1].release_async()
    await asyncio.sleep(0.05)
    log.append(sum(t.done() and bool(t.result()) for t in tasks))
    log.append(_stats(lim))
    await lim.aclose()
    rest = await asyncio.gather(*tasks)
    log.append(sum(map(bool, rest)))
    assert sum(map(bool, rest)) == 7  # 5 + the two waiters the releases fed
    with pytest.raises(RuntimeError, match="disposed"):
        lim.acquire(1)
    for lease in rest:
        if lease.is_acquired:
            lease.dispose()
    log.append(twin.available_permits())
    await twin.aclose()
    return log


async def limiter_contract(kit, store):
    """Probes, the over-limit error, the context manager, newest-first
    eviction and a cancelled waiter."""
    lim = kit.Limiter(kit.Options(
        permit_limit=3, queue_limit=3, instance_name="c",
        queue_processing_order=kit.Order.NEWEST_FIRST), store)
    log = [bool(lim.acquire(0)), lim.idle_duration is not None]
    with pytest.raises(ValueError):
        lim.acquire(4)
    with lim.acquire(2) as lease:
        log.append((bool(lease), lim.available_permits(),
                    lim.idle_duration is None))
    log.append(lim.available_permits())
    big = lim.acquire(3)
    first = asyncio.ensure_future(lim.acquire_async(1))
    second = asyncio.ensure_future(lim.acquire_async(2))
    await _parked(lim, 2)
    third = asyncio.ensure_future(lim.acquire_async(1))  # evicts `first`
    await _until(first.done, "the evicted waiter never finished")
    log.append((first.done() and not first.result().is_acquired,
                len(lim._queue)))
    third.cancel()
    await _until(lambda: len(lim._queue) == 1,
                 "the cancelled waiter never left the queue")
    big.dispose()
    got = await w(second)
    log += [bool(got), bool(await w(lim.acquire_async(0))),
            _stats(lim)]
    got.dispose()
    await lim.aclose()
    return log


@pytest.mark.parametrize("scenario", [limiter_cap5, limiter_contract])
def test_limiter_matches_jax(scenario):
    logs = []
    for kit in (PORT, JAX):
        async def main(kit=kit):
            store = kit.Store(clock=kit.Clock(1000), counter_slots=32)
            return await scenario(kit, store)
        logs.append(asyncio.run(main()))
    assert logs[0] == logs[1]


def test_options_validate_as_jax():
    for kw in ({"permit_limit": 0}, {"queue_limit": -1},
               {"retry_period_s": 0.0}):
        with pytest.raises(ValueError):
            ConcurrencyLimiterOptions(**kw)
        with pytest.raises(ValueError):
            JOptions(**kw)
    assert (ConcurrencyLimiterOptions().permit_limit
            == JOptions().permit_limit == 10)
    assert isinstance(ConcurrencyLimiter(ConcurrencyLimiterOptions(),
                                         _PortStore(clock=ManualClock())
                                         ).acquire(1), ConcurrencyLease)


# -- OP_SEMA on the wire ----------------------------------------------------------

async def _wire_sema(server_kind, client_kind):
    if server_kind == "port":
        store = DeviceBucketStore(device="cpu", clock=ManualClock(1000),
                                  counter_slots=16)
        srv = BucketStoreServer(store)
    else:
        store = JStore(clock=JClock(1000), counter_slots=16)
        srv = JServer(store)
    host, port = await w(srv.start())
    cli = (RemoteBucketStore if client_kind == "port" else JRemote)(
        address=(host, port))
    try:
        res = await w(asyncio.gather(*(cli.concurrency_acquire("s", 1, 5)
                                       for _ in range(32))))
        out = [sorted(tuple(r) for r in res)]
        await w(cli.concurrency_release("s", 2))
        out.append(tuple(await w(cli.concurrency_acquire("s", 0, 5))))
        out.append(tuple(await asyncio.to_thread(
            cli.concurrency_acquire_blocking, "s", 3, 5)))
        await asyncio.to_thread(cli.concurrency_release_blocking, "s", 1)
        await w(cli.concurrency_release("ghost", 1))
        out.append(tuple(await w(cli.concurrency_acquire("ghost", 0, 5))))
        lim = (ConcurrencyLimiter if client_kind == "port" else JLimiter)(
            (ConcurrencyLimiterOptions if client_kind == "port"
             else JOptions)(permit_limit=2, instance_name="wire"), cli)
        leases = [await w(lim.acquire_async(1)) for _ in range(3)]
        out.append([bool(x) for x in leases])
        await w(leases[0].release_async())
        out.append(await asyncio.to_thread(lim.available_permits))
        await w(lim.aclose())
        out.append(store._sema_dir.lookup("ghost"))
        return out
    finally:
        await w(cli.aclose())
        await w(srv.aclose())
        await store.aclose()


def test_op_sema_four_pairings():
    got = {(s, c): asyncio.run(_wire_sema(s, c))
           for s in ("port", "jax") for c in ("port", "jax")}
    want = got[("jax", "jax")]
    assert all(v == want for v in got.values()), got
    assert want[0].count((True, 5.0)) == 1 and sum(
        g for g, _ in want[0]) == 5
    assert want[-1] is None
