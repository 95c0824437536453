"""The port's approximate and queueing token-bucket limiters against the JAX
package's, each scenario run once on either side.

Every scenario below is written once against a "kit" (store, clock,
limiter and options classes) and driven through the port's
``DeviceBucketStore(device="cpu")`` and through the JAX
``DeviceBucketStore``, on ManualClocks. What each side observes — leases,
``available_permits``, queue counts and ``stats()`` (less the wall-clock
latency fields) — must be identical, and the scenario asserts the
reference semantics itself, as ``tests/test_limiters.py``,
``tests/test_queueing.py`` and ``tests/test_queueing_limiter.py`` do. The
waiter queue and the options are also checked on their own.
"""

import asyncio
import time
from types import SimpleNamespace

import pytest
import torch

from distributedratelimiting.redis_tpu.models.approximate import (
    ApproximateTokenBucketRateLimiter as JApprox,
)
from distributedratelimiting.redis_tpu.models.options import (
    ApproximateTokenBucketOptions as JApproxOpts,
)
from distributedratelimiting.redis_tpu.models.options import (
    QueueingTokenBucketOptions as JQueueOpts,
)
from distributedratelimiting.redis_tpu.models.queueing_token_bucket import (
    QueueingTokenBucketRateLimiter as JQueueing,
)
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.queueing import (
    QueueProcessingOrder as JOrder,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    ApproximateTokenBucketOptions,
    ApproximateTokenBucketRateLimiter,
    DeviceBucketStore,
    ManualClock,
    QueueingTokenBucketOptions,
    QueueingTokenBucketRateLimiter,
    QueueProcessingOrder,
)
from distributedratelimiting.redis_tpu_torch.models.approximate import (
    headroom_budget,
    overadmit_epsilon,
)
from distributedratelimiting.redis_tpu_torch.runtime.queueing import (
    WaiterQueue,
)

# Small tensors: one intra-op thread, so that parallel test workers keep
# their cores.
torch.set_num_threads(1)


class _PortStore(DeviceBucketStore):
    def __init__(self, clock, **kw):
        super().__init__(device="cpu", clock=clock, **kw)


PORT = SimpleNamespace(Store=_PortStore, Clock=ManualClock,
                       Approx=ApproximateTokenBucketRateLimiter,
                       ApproxOpts=ApproximateTokenBucketOptions,
                       Queueing=QueueingTokenBucketRateLimiter,
                       QueueOpts=QueueingTokenBucketOptions,
                       Order=QueueProcessingOrder)
JAX = SimpleNamespace(Store=JStore, Clock=JClock, Approx=JApprox,
                      ApproxOpts=JApproxOpts, Queueing=JQueueing,
                      QueueOpts=JQueueOpts, Order=JOrder)

#: stats() fields read from the wall clock, which no two runs share.
_WALL = ("acquire_p50_s", "acquire_p99_s", "last_sync_lag_s")


def _stats(lim) -> dict:
    return {k: v for k, v in lim.stats().items() if k not in _WALL}


def _approx(kit, store, **kw):
    kw.setdefault("token_limit", 100)
    kw.setdefault("tokens_per_period", 10)
    kw.setdefault("replenishment_period_s", 1.0)
    return kit.Approx(kit.ApproxOpts(**kw), store)


def _queueing(kit, store, **kw):
    opts = dict(token_limit=5, tokens_per_period=5,
                replenishment_period_s=1.0, queue_limit=10,
                instance_name="q-bucket")
    opts.update(kw)
    return kit.Queueing(kit.QueueOpts(**opts), store)


async def _parked(lim=None, n=0):
    """Let parked waiters settle; with a limiter, until its queue holds
    ``n`` waiters (a store round-trip may come first)."""
    await asyncio.sleep(0.01)
    deadline = time.monotonic() + 30
    while lim is not None and len(lim._queue) < n:
        assert time.monotonic() < deadline, "waiter never parked"
        await asyncio.sleep(0.001)


# -- approximate limiter scenarios ------------------------------------------

async def approx_push_pull(kit, store, clock):
    lim = _approx(kit, store)
    log = [bool(lim.acquire(1)) for _ in range(101)]
    clock.advance_seconds(1.0)
    await lim.refresh()
    assert lim._global_score == 100.0 and lim._local_score == 0.0
    log += [lim.available_permits(), _stats(lim)]
    clock.advance_seconds(3.0)
    await lim.refresh()  # 100 decays by 30 → 70
    log += [lim.available_permits(), _stats(lim)]
    assert log[:101] == [True] * 100 + [False]
    assert lim.available_permits() == 30
    await lim.aclose()
    return log


async def approx_degraded_mode(kit, store, clock):
    lim = _approx(kit, store)

    async def failing_sync(*a, **kw):
        raise ConnectionError("store down")

    good = store.sync_counter
    for _ in range(30):
        lim.acquire(1)
    store.sync_counter = failing_sync
    await lim.refresh()
    # The failed sync is counted; local consumption is kept, not lost.
    assert lim.metrics.sync_failures == 1 and lim._local_score == 30.0
    log = [bool(lim.acquire(1)), _stats(lim)]
    store.sync_counter = good
    clock.advance_seconds(0.5)
    await lim.refresh()
    log.append(_stats(lim))
    await lim.aclose()
    return log


async def approx_queue_drain(kit, store, clock, order):
    lim = _approx(kit, store, token_limit=10, tokens_per_period=10,
                  queue_limit=8, queue_processing_order=order)
    log = [bool(await lim.acquire_async(1)) for _ in range(10)]
    w1 = asyncio.ensure_future(lim.acquire_async(5))
    await _parked()
    w2 = asyncio.ensure_future(lim.acquire_async(3))
    await _parked()
    # 5 + 3 fill the queue: OLDEST_FIRST rejects a third waiter,
    # NEWEST_FIRST evicts the oldest to make room.
    w3 = asyncio.ensure_future(lim.acquire_async(2))
    await _parked()
    log.append([w.done() for w in (w1, w2, w3)])
    clock.advance_seconds(2.0)
    await lim.refresh()  # push 10: score 10
    clock.advance_seconds(2.0)
    await lim.refresh()  # decays to 0: waiters drain
    for w in (w1, w2, w3):
        lease = await asyncio.wait_for(w, 1.0)
        log.append(bool(lease))
    log.append(_stats(lim))
    await lim.aclose()
    if order is kit.Order.OLDEST_FIRST:
        assert log[10:14] == [[False, False, True], True, True, False]
    else:
        assert log[10][0] and not log[11] and lim.metrics.evicted == 1
    return log


async def approx_dispose_and_cancel(kit, store, clock):
    lim = _approx(kit, store, token_limit=5, queue_limit=5)
    for _ in range(5):
        await lim.acquire_async(1)
    w1 = asyncio.ensure_future(lim.acquire_async(5))
    await _parked()
    log = [lim._queue.queue_count]
    w1.cancel()
    await _parked()
    log.append(lim._queue.queue_count)
    w2 = asyncio.ensure_future(lim.acquire_async(3))
    await _parked()
    await lim.aclose()
    lease = await asyncio.wait_for(w2, 1.0)
    log += [bool(lease), _stats(lim)]
    assert log[:3] == [5, 0, False] and lim.metrics.cancelled == 1
    return log


async def approx_instance_estimate(kit, store, clock):
    """Eight clients sharing one ``instance_name`` sync at a staggered
    cadence: each estimates 8 peers, and greedy admission stays within the
    shared limit plus the documented staleness bound."""
    n, limit, rate = 8, 100, 10
    clients = [_approx(kit, store, token_limit=limit, tokens_per_period=rate,
                       instance_name="fleet") for _ in range(n)]
    for _ in range(6):
        for c in clients:
            clock.advance_seconds(1.0 / n)
            await c.refresh()
    log = [c._instance_count for c in clients]
    assert log == [n] * n
    per_period = []
    for _ in range(12):
        grants = 0
        for c in clients:
            while c.acquire(1).is_acquired:
                grants += 1
            clock.advance_seconds(1.0 / n)
            await c.refresh()
        per_period.append(grants)
    log += [per_period, _stats(clients[0])]
    assert per_period[0] <= limit + overadmit_epsilon(0.0, rate, 1.0)
    assert sum(per_period[-6:]) / 6 <= rate * 1.5
    for c in clients:
        await c.aclose()
    return log


async def approx_bulk(kit, store, clock):
    opts = dict(token_limit=20, tokens_per_period=1,
                replenishment_period_s=1000.0, queue_limit=5)
    a, b = _approx(kit, store, **opts), _approx(kit, store, **opts)
    counts = [3, 5, 2, 8, 1, 4, 2]
    res = a.acquire_many(counts)
    seq = [bool(b.acquire(c)) for c in counts]
    assert res.granted.tolist() == seq and a._local_score == b._local_score
    c = _approx(kit, store, **dict(opts, token_limit=10))
    probe = c.acquire_many([6, 7, 2, 0])
    assert probe.granted.tolist() == [True, False, False, False]
    log = [res.granted.tolist(), res.remaining.tolist(),
           probe.granted.tolist(), c._local_score]
    d = _approx(kit, store, **dict(opts, token_limit=5))
    d.acquire(5)
    waiter = asyncio.ensure_future(d.acquire_async(1))
    await _parked()
    gated = d.acquire_many([1, 1, 0])
    log.append(gated.granted.tolist())
    assert not gated.granted.any()  # no overtaking the parked waiter
    with pytest.raises(ValueError):
        d.acquire_many([1, 6])
    waiter.cancel()
    for lim in (a, b, c, d):
        await lim.aclose()
    return log


APPROX = {"push_pull": approx_push_pull, "degraded": approx_degraded_mode,
          "dispose_cancel": approx_dispose_and_cancel,
          "instance_estimate": approx_instance_estimate, "bulk": approx_bulk}


def _run_both(scenario, *args, **store_kw):
    logs = []
    for kit in (PORT, JAX):
        clock = kit.Clock(5_000)
        store = kit.Store(clock=clock, **store_kw)

        async def main():
            try:
                return await scenario(kit, store, clock,
                                      *(a(kit) for a in args))
            finally:
                await store.aclose()

        logs.append(asyncio.run(main()))
    return logs


@pytest.mark.parametrize("name", sorted(APPROX))
def test_approximate_limiter_matches_jax(name):
    got, want = _run_both(APPROX[name], counter_slots=16)
    assert got == want


@pytest.mark.parametrize("order", ["OLDEST_FIRST", "NEWEST_FIRST"])
def test_approximate_queue_matches_jax(order):
    got, want = _run_both(approx_queue_drain,
                          lambda kit: getattr(kit.Order, order))
    assert got == want


def test_sync_only_refresh_matches_jax():
    """A limiter used only through the sync API (no event loop) syncs and
    harvests once a period, inline."""
    logs = []
    for kit in (PORT, JAX):
        clock = kit.Clock(5_000)
        store = kit.Store(clock=clock)
        lim = _approx(kit, store, token_limit=10, tokens_per_period=10,
                      replenishment_period_s=0.05)
        log = [bool(lim.acquire(1)) for _ in range(11)]
        time.sleep(0.06)
        clock.advance_seconds(1.0)
        lim.acquire(0)  # the probe runs the inline refresh
        time.sleep(0.06)
        clock.advance_seconds(1.0)
        log += [bool(lim.acquire(1)), lim.metrics.syncs >= 2,
                lim._global_score]
        assert log[:11] == [True] * 10 + [False] and log[11:13] == [True] * 2
        logs.append(log)
    assert logs[0] == logs[1]


# -- queueing + exact hybrid scenarios --------------------------------------

async def queueing_exact(kit, store, clock):
    a, b = _queueing(kit, store), _queueing(kit, store)
    log = [bool(a.acquire(5)), bool(b.acquire(1))]
    with pytest.raises(ValueError):
        a.acquire(6)
    clock.advance_seconds(1.0)
    log += [bool(await a.acquire_async(3)), a.available_permits(),
            _stats(a), _stats(b)]
    assert log[:4] == [True, False, True, 2]
    await a.aclose()
    await b.aclose()
    return log


async def queueing_park_and_drain(kit, store, clock, order):
    lim = _queueing(kit, store, queue_limit=4, queue_processing_order=order)
    log = [bool(await lim.acquire_async(5))]
    w1 = asyncio.ensure_future(lim.acquire_async(2))
    await _parked(lim, 1)
    w2 = asyncio.ensure_future(lim.acquire_async(2))
    await _parked(lim, 2)
    w3 = asyncio.ensure_future(lim.acquire_async(1))  # overflows the queue
    await _parked()
    while order is kit.Order.OLDEST_FIRST and not w3.done():
        await asyncio.sleep(0.001)  # the rejection follows a store denial
    await _parked(lim, 2)
    log.append([w.done() for w in (w1, w2, w3)])
    clock.advance_seconds(1.0)  # 5 tokens: the queue drains in its order
    await lim.refresh()
    for w in (w1, w2, w3):
        log.append(bool(await asyncio.wait_for(w, 1.0)))
    log += [lim.available_permits(), _stats(lim)]
    await lim.aclose()
    return log


async def queueing_cancel_and_dispose(kit, store, clock):
    lim = _queueing(kit, store)
    assert (await lim.acquire_async(5)).is_acquired
    w1 = asyncio.ensure_future(lim.acquire_async(2))
    await _parked(lim, 1)
    w1.cancel()
    with pytest.raises(asyncio.CancelledError):
        await w1
    w2 = asyncio.ensure_future(lim.acquire_async(2))
    await _parked(lim, 1)
    clock.advance_seconds(1.0)
    await lim.refresh()
    log = [bool(await w2), lim.metrics.cancelled]
    assert log == [True, 1]
    w3 = asyncio.ensure_future(lim.acquire_async(5))
    await _parked(lim, 1)
    await lim.aclose()
    log += [bool(await w3), _stats(lim)]
    return log


async def queueing_degraded(kit, store, clock):
    good = store.acquire

    async def failing_acquire(*a, **kw):
        raise ConnectionError("store down")

    lim = _queueing(kit, store)
    store.acquire = failing_acquire
    w = asyncio.ensure_future(lim.acquire_async(1))
    await _parked(lim, 1)
    log = [w.done(), lim.metrics.sync_failures]
    await lim.refresh()  # still down: the waiter stays parked
    log += [w.done(), lim.metrics.sync_failures]
    store.acquire = good
    await lim.refresh()
    log += [bool(await w), _stats(lim)]
    assert log[:5] == [False, 1, False, 2, True]
    await lim.aclose()
    return log


QUEUEING = {"exact": queueing_exact, "cancel_dispose":
            queueing_cancel_and_dispose, "degraded": queueing_degraded}


@pytest.mark.parametrize("name", sorted(QUEUEING))
def test_queueing_limiter_matches_jax(name):
    got, want = _run_both(QUEUEING[name])
    assert got == want


@pytest.mark.parametrize("order", ["OLDEST_FIRST", "NEWEST_FIRST"])
def test_queueing_limiter_queue_matches_jax(order):
    got, want = _run_both(queueing_park_and_drain,
                          lambda kit: getattr(kit.Order, order))
    assert got == want
    if order == "OLDEST_FIRST":  # w3 rejected at once; w1, w2 drain
        assert got[1] == [False, False, True] and got[2:5] == [True, True,
                                                              False]
    else:  # w3 evicts w1; w3 and w2 drain, newest first
        assert got[1] == [True, False, False] and got[2:5] == [False, True,
                                                              True]


# -- the waiter queue and the options on their own ---------------------------

def test_waiter_queue_accounting_and_orders():
    async def main():
        out = []
        for order in QueueProcessingOrder:
            q = WaiterQueue(5, order)
            f1, _ = q.try_enqueue(3)
            f2, _ = q.try_enqueue(2)
            f3, evicted = q.try_enqueue(2)  # overflows
            out.append((q.queue_count, f3 is None, len(evicted)))
            f2.cancel()
            await asyncio.sleep(0)
            out.append(q.queue_count)
            granted = q.drain(lambda c: True, lambda: "lease")
            out.append((granted, q.queue_count, f1.done()))
            assert q.fail_all(lambda: "failed") == 0
        return out

    assert asyncio.run(main()) == [
        (5, True, 0), 3, (1, 0, True),     # OLDEST_FIRST rejects the newcomer
        (4, False, 1), 2, (1, 0, False)]   # NEWEST_FIRST evicts f1 for f3


def test_options_validate_like_jax():
    for kit in (PORT, JAX):
        with pytest.raises(ValueError):
            kit.ApproxOpts(queue_limit=-1)
        with pytest.raises(ValueError):
            kit.QueueOpts(replenishment_period_s=0.0)
        opts = kit.ApproxOpts(tokens_per_period=10,
                              replenishment_period_s=4.0)
        assert opts.fill_rate_per_second == 2.5
    assert isinstance(ApproximateTokenBucketOptions(),
                      QueueingTokenBucketOptions)
    assert headroom_budget(100.0) == 0.0 and headroom_budget(1000.0) == 500.0
    assert overadmit_epsilon(64.0, 10.0, 0.5) == 133.0
