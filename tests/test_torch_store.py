"""The port's serving path end to end against the JAX package's.

One seeded trace — bursts, refills on a ManualClock, duplicate keys inside
one flush, a cap-5 bucket hit by 32 one-permit asks, free-list exhaustion
that forces a TTL sweep, a bulk ``acquire_many`` — is driven through
``PartitionedRateLimiter`` over the port's ``DeviceBucketStore(device="cpu")``
and over the JAX ``DeviceBucketStore``. Grant sequences and
``available_permits`` must be identical; bulk ``remaining`` agrees within
atol 1e-4 (float order of duplicate consumption).
"""

import asyncio
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.models.options import (
    TokenBucketOptions as JOptions,
)
from distributedratelimiting.redis_tpu.models.partitioned import (
    PartitionedRateLimiter as JPartitioned,
)
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    ManualClock,
    PartitionedRateLimiter,
    TokenBucketOptions,
    TokenBucketRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as tbm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

# Small tensors: one intra-op thread, so that parallel test workers keep
# their cores.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = dict(token_limit=10, tokens_per_period=5, replenishment_period_s=1.0,
            instance_name="api")
CAP5 = dict(token_limit=5, tokens_per_period=1, replenishment_period_s=1.0,
            instance_name="cap5")


def _port(clock, **kw):
    return DeviceBucketStore(device="cpu", clock=clock, **kw)


def _jax(clock, **kw):
    return JStore(clock=clock, **kw)


async def _drive(store, clock, opts_cls, limiter_cls, seed, rounds=12):
    """The seeded trace; returns everything observable about it."""
    rng = np.random.default_rng(seed)
    lim = limiter_cls(opts_cls(**OPTS), store)
    cap5 = limiter_cls(opts_cls(**CAP5), store)
    log = []
    for r in range(rounds):
        # A burst: Zipf-hot keys (duplicates within one flush) plus a fresh
        # cold key per request, so distinct keys outrun the 64-slot table.
        hot = (rng.zipf(1.5, 48) - 1) % 12
        keys = [f"h{h}" for h in hot] + [f"c{r}-{i}" for i in range(24)]
        permits = rng.integers(1, 4, len(keys)).tolist()
        order = rng.permutation(len(keys))
        leases = await asyncio.gather(*(
            lim.acquire_async(keys[i], permits[i]) for i in order))
        log.append([bool(x) for x in leases])
        log.append([lim.available_permits(f"h{h}") for h in range(6)])
        if r % 4 == 1:
            # cap-5 bucket, 32 concurrent one-permit asks → exactly 5 grants
            leases = await asyncio.gather(*(
                cap5.acquire_async(f"hot{r}") for _ in range(32)))
            log.append(sum(bool(x) for x in leases))
        # Refill a little, and now and then idle past every TTL (2 s) so the
        # next allocation's sweep can reclaim slots.
        clock.advance_ticks(int(rng.integers(100, 700)) if r % 3
                            else 3 * 1024)
    res = await lim.acquire_many([f"h{h}" for h in range(12)] * 3
                                 + [f"bulk{i}" for i in range(40)],
                                 permits=2)
    log.append(res.granted.tolist())
    log.append(np.round(res.remaining, 4).tolist())
    # Mostly distinct keys: grouping does not pay, the scanned lane runs
    # (verdict-only, so grants come back bit-packed).
    res = await lim.acquire_many([f"h{h}" for h in range(6)] * 2
                                 + [f"scan{i}" for i in range(150)],
                                 permits=3, with_remaining=False)
    log.append(res.granted.tolist())
    return log


def _run(make_store, clock, opts_cls, limiter_cls, seed):
    store = make_store(clock, n_slots=64, max_batch=128)

    async def main():
        try:
            return await _drive(store, clock, opts_cls, limiter_cls, seed)
        finally:
            await store.aclose()

    return asyncio.run(main()), store


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_trace_matches_jax_store(seed):
    got, port = _run(_port, ManualClock(10_000), TokenBucketOptions,
                     PartitionedRateLimiter, seed)
    want, _ = _run(_jax, JClock(10_000), JOptions, JPartitioned, seed)
    assert got == want
    cap5 = [x for x in got if isinstance(x, int)]
    assert cap5 == [5] * len(cap5) and cap5
    # The trace exhausted the free-list: sweeps ran and reclaimed slots.
    assert port.metrics.sweeps > 0 and port.metrics.slots_evicted > 0
    assert port.metrics.rows_coalesced > 0  # duplicates rode grouped rows


def test_jax_snapshot_restores_into_port():
    jclock = JClock(5_000)
    jstore = _jax(jclock, n_slots=64, max_batch=128)
    asyncio.run(_drive(jstore, jclock, JOptions, JPartitioned, 3, rounds=3))
    snap = jstore.snapshot()
    # The port restores into a clock at another epoch: timestamps shift.
    port = _port(ManualClock(900_000), n_slots=64, max_batch=128)
    port.restore(snap)
    got = asyncio.run(_drive(port, port.clock, TokenBucketOptions,
                             PartitionedRateLimiter, 4, rounds=3))
    want = asyncio.run(_drive(jstore, jclock, JOptions, JPartitioned, 4,
                              rounds=3))
    assert got == want


def test_restore_refuses_live_window_state():
    """Nothing live is refused any more: window tables restore since the
    windows were ported (their parity with JAX is
    tests/test_torch_window.py's), and a JAX snapshot that holds live
    semaphores beside window tables restores them, held permits and idle
    timestamps included (the semaphores' own parity is
    tests/test_torch_concurrency.py's)."""
    port = _port(ManualClock(0))
    port.window_acquire_blocking("w", 2, 5.0, 1.0)
    wsnap = port.snapshot()
    fresh = _port(ManualClock(0))
    fresh.restore(wsnap)
    assert fresh.window_acquire_blocking("w", 3, 5.0, 1.0).granted
    assert not fresh.window_acquire_blocking("w", 1, 5.0, 1.0).granted
    jclock = JClock(5_000)
    jstore = _jax(jclock, counter_slots=64)
    jstore.window_acquire_blocking("w", 2, 5.0, 1.0)
    assert jstore.concurrency_acquire_blocking("sema", 3, 4).granted
    assert jstore.concurrency_acquire_blocking("idle", 1, 4).granted
    jstore.concurrency_release_blocking("idle", 1)
    jsnap = jstore.snapshot()
    assert int(np.count_nonzero(jsnap["semas"]["exists"])) == 2
    restored = _port(ManualClock(900_000), counter_slots=64)
    restored.restore(jsnap)
    assert restored.concurrency_acquire_blocking("sema", 0, 4) == (True, 3.0)
    assert not restored.concurrency_acquire_blocking("sema", 2, 4).granted
    assert restored.concurrency_acquire_blocking("sema", 1, 4) == (True, 4.0)
    assert restored.window_acquire_blocking("w", 3, 5.0, 1.0).granted
    assert not restored.window_acquire_blocking("w", 1, 5.0, 1.0).granted
    # The idle slot's timestamp shifted with the clock: it sweeps a day
    # after its last touch, the held one never.
    restored.clock.advance_seconds(86_400)
    restored.sweep_all()
    assert restored._sema_dir.lookup("idle") is None
    assert restored._sema_dir.lookup("sema") is not None


def test_blocking_and_single_bucket_paths():
    store = _port(ManualClock(0))
    lim = TokenBucketRateLimiter(TokenBucketOptions(token_limit=3), store)
    assert [bool(lim.acquire()) for _ in range(4)] == [True] * 3 + [False]
    assert lim.available_permits() == 0
    store.clock.advance_seconds(1.0)
    assert bool(lim.acquire())
    assert store.peek_blocking("nobody", 3.0, 1.0) == 3.0


def test_unported_methods_raise():
    """Nothing of the storage seam is left unported: the migration export
    equals the JAX store's on the same traffic (it raised before the
    placement plane was ported), and the reservation lane, the
    semaphores, two-level admission and the debit work."""
    store = _port(ManualClock(0))
    jstore = _jax(JClock(0))

    async def traffic(st):
        await st.acquire_many(["a", "b", "a", "c"], [1, 2, 3, 4], 10.0, 2.0)
        await st.window_acquire("w", 3, 10.0, 1.0)
        await st.sync_counter("n", 4.0, 1.0)
        await st.concurrency_acquire("s", 2, 5)

    asyncio.run(traffic(store))
    asyncio.run(traffic(jstore))

    def keep(k):
        return k != "c"

    assert store.export_entries(keep) == jstore.export_entries(keep)
    assert sorted(r[0] for r in store.export_entries(keep)["buckets"]) == [
        "a", "b"]

    async def lane():
        r = await store.reserve("r1", "t", "k", 2.0, 9.0, 1.0, 5.0, 1.0)
        s = await store.settle("r1", "t", 1.0)
        return r, s

    r, s = asyncio.run(lane())
    assert r.granted and r.reserved == 2.0
    assert tuple(s) == ("settled", -1.0, 1.0, 0.0)
    assert store.peek_blocking("t", 9.0, 1.0) == 8.0
    assert store.peek_blocking("k", 5.0, 1.0) == 4.0
    assert store.concurrency_acquire_blocking("k", 1, 5) == (True, 1.0)
    assert store.acquire_hierarchical_blocking(
        "t", "k", 1, 9.0, 1.0, 5.0, 1.0).granted


def test_default_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DeviceBucketStore()


def test_card_store_refuses_batches_the_scan_kernel_cannot_hold(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="max_batch 4097"):
        DeviceBucketStore(max_batch=ck.FLUSH_MAX_BATCH + 1)
    DeviceBucketStore(max_batch=ck.FLUSH_MAX_BATCH)  # touches no device yet


def test_port_serves_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import asyncio\n"
        "from distributedratelimiting.redis_tpu_torch import *\n"
        "st = DeviceBucketStore(device='cpu', clock=ManualClock(0))\n"
        "lim = PartitionedRateLimiter(TokenBucketOptions(token_limit=5), st)\n"
        "async def main():\n"
        "    ls = await asyncio.gather(*(lim.acquire_async('k')\n"
        "                                for _ in range(8)))\n"
        "    await st.aclose()\n"
        "    return sum(map(bool, ls))\n"
        "print(asyncio.run(main()))\n"
        "print(any(m == 'jax' or m.startswith(('jax.', 'distributedratelimiting.redis_tpu.'))\n"
        "          for m in sys.modules if sys.modules[m] is not None))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["5", "False"]


@pytest.mark.parametrize("with_remaining", [True, False])
@pytest.mark.parametrize("max_count", [3, 300])
def test_bulk_chunk_is_one_scan_wrapper_call(monkeypatch, max_count,
                                             with_remaining):
    """The scanned bulk lane hands each chunk's whole operand to the scan
    wrapper in one call (fused u8 for counts ≤ 255, else i32[2, K, B]) and
    computes no duplicate prefix itself; the last chunk, of one batch, is
    one flush of its 10 rows padded to 16 (``i32[4, 16]``)."""
    calls = []

    def scan(state, operand, nows_k, capacity, rate, *, with_remaining):
        calls.append((operand.dtype, tuple(operand.shape), tuple(nows_k.shape),
                      with_remaining))
        k, b = (operand.shape[:2] if operand.dtype == torch.uint8
                else operand.shape[1:])
        if with_remaining:
            return torch.ones((k, 2, b))
        return torch.full((k, b // 8), 255, dtype=torch.uint8)

    def flush(state, packed, capacity, rate):
        calls.append((packed.dtype, tuple(packed.shape)))
        return torch.ones((2, packed.shape[1]))

    def no_prefix(*args, **kwargs):
        raise AssertionError("the bulk lane computed a duplicate prefix")

    monkeypatch.setattr(ck, "acquire_scan_packed", scan)
    monkeypatch.setattr(ck, "acquire_packed", flush)
    monkeypatch.setattr(tbm, "duplicate_prefix", no_prefix)
    store = _port(ManualClock(0), n_slots=2**14, max_batch=64,
                  coalesce_duplicates=False)
    n = 2 * 32 * 64 + 10  # two K = 32 chunks and a one-batch tail
    counts = np.random.default_rng(0).integers(1, max_count + 1, n)
    res = store.acquire_many_blocking([f"k{i}" for i in range(n)], counts,
                                      10.0, 1.0,
                                      with_remaining=with_remaining)
    assert res.granted.all() and len(res) == n
    fused = max_count <= 255
    dtype = torch.uint8 if fused else torch.int32
    assert calls == [
        (dtype, (k, 64, 5) if fused else (2, k, 64), (k,), with_remaining)
        for k in (32, 32)] + [(torch.int32, (4, 16))]


# -- decaying counters -------------------------------------------------------

async def _counter_trace(store, clock, seed):
    """Seeded syncs through all three entry points. Keys outrun the 8-slot
    counter table: exhaustion sweeps (after idle spells past the 86400 s TTL)
    and grows it. Returns every reply and the counter directory."""
    rng = np.random.default_rng(seed)
    log = []
    for r in range(14):
        keys = [f"c{int(k)}" for k in (rng.zipf(1.4, 6) - 1) % 24]
        counts = np.round(rng.uniform(0, 20, len(keys)), 2).tolist()
        if r % 3 == 0:
            scores, periods = await store.sync_counters_many(
                keys, counts, 5.0)
            log.append((scores.tolist(), periods.tolist()))
        elif r % 3 == 1:
            for k, c in zip(keys, counts):
                log.append(tuple(await store.sync_counter(k, c, 5.0)))
        else:
            for k, c in zip(keys, counts):
                log.append(tuple(store.sync_counter_blocking(k, c, 5.0)))
        clock.advance_ticks(int(rng.integers(50, 3000)))
        if r % 5 == 4:
            clock.advance_seconds(86_401)  # every counter idles past its TTL
    return log, store._counter_dir.to_dict()


def _flat(log):
    out = []
    for entry in log:
        for x in entry:
            out.extend(x if isinstance(x, list) else [x])
    return np.array(out)


def _assert_replies(got, want):
    """Within 1e-4, or a few float32 ulps of a large period EWMA: XLA on
    the CPU may fuse the EWMA's multiply and add, where the port rounds each
    (periods reach ~2e8 ticks after days idle, where an ulp is 16; the EWMA
    carries an ulp into later syncs at a weight of 0.8 each, so at most
    five)."""
    np.testing.assert_allclose(_flat(got), _flat(want), atol=1e-4,
                               rtol=1e-6)


def _run_counters(store, clock, seed):
    async def main():
        try:
            return await _counter_trace(store, clock, seed)
        finally:
            await store.aclose()

    return asyncio.run(main())


@pytest.mark.parametrize("seed", [0, 1])
def test_counter_trace_matches_jax_store(seed):
    pclock, jclock = ManualClock(7_000), JClock(7_000)
    port = _port(pclock, counter_slots=8)
    (got, got_dir) = _run_counters(port, pclock, seed)
    (want, want_dir) = _run_counters(_jax(jclock, counter_slots=8), jclock,
                                     seed)
    assert got_dir == want_dir
    assert len(got) == len(want)
    _assert_replies(got, want)
    # The trace exhausted the table: sweeps ran, evicted, and it grew.
    assert port.metrics.sweeps > 0 and port.metrics.slots_evicted > 0
    assert port._counters.value.shape[0] > 8


def test_counter_sync_decay_and_one_launch_fleet():
    """Mirrors the JAX store's decay check, and the fleet sync against
    per-key syncs."""
    clock = ManualClock(0)
    store = _port(clock, counter_slots=64)

    async def main():
        clock.advance_seconds(1.0)
        assert (await store.sync_counter("bucket", 30.0, 10.0)).global_score \
            == 30.0
        clock.advance_seconds(2.0)
        res = await store.sync_counter("bucket", 5.0, 10.0)
        assert res.global_score == 15.0  # 30 decayed by 2 s × 10/s, + 5
        keys = [f"c{i}" for i in range(5)]
        counts = [float(i + 1) for i in range(5)]
        scores, periods = await store.sync_counters_many(keys, counts, 1.0)
        assert scores.dtype == np.float64 and scores.tolist() == counts
        serial = _port(clock, counter_slots=64)
        singles = [serial.sync_counter_blocking(k, c, 1.0)
                   for k, c in zip(keys, counts)]
        assert scores.tolist() == [s.global_score for s in singles]
        assert periods.tolist() == [s.period_ewma_ticks for s in singles]
        # Duplicates in one fleet sync: each reply is its own count on the
        # shared decayed value; the adds accumulate.
        scores, _ = await store.sync_counters_many(["d", "d", "d"],
                                                   [1.0, 2.0, 4.0], 1.0)
        assert scores.tolist() == [1.0, 2.0, 4.0]
        assert store.sync_counter_blocking("d", 0.0, 1.0).global_score == 7.0
        await store.aclose()

    asyncio.run(main())


def test_jax_counter_snapshot_restores_into_port():
    jclock = JClock(5_000)
    jstore = _jax(jclock, counter_slots=8)
    _run_counters(jstore, jclock, 3)
    snap = jstore.snapshot()
    live = [k for k, slot in snap["counter_dir"].items()
            if snap["counters"]["exists"][slot]]
    assert live
    # Restored at the snapshot's tick, the port continues identically.
    port = _port(ManualClock(snap["now_ticks"]), counter_slots=8)
    port.restore(snap)
    assert port._counter_dir.to_dict() == snap["counter_dir"]
    # Restored into another clock epoch, elapsed time is kept: a live
    # counter decays and averages exactly as it does at the snapshot's tick.
    other = _port(ManualClock(900_000), counter_slots=8)
    other.restore(snap)
    for st in (port, other):
        st.clock.advance_ticks(1000)
    assert [tuple(other.sync_counter_blocking(k, 0.0, 5.0)) for k in live] \
        == [tuple(port.sync_counter_blocking(k, 0.0, 5.0)) for k in live]
    jclock.advance_ticks(1000)
    for k in live:
        jstore.sync_counter_blocking(k, 0.0, 5.0)
    (got, got_dir) = _run_counters(port, port.clock, 4)
    (want, want_dir) = _run_counters(jstore, jclock, 4)
    assert got_dir == want_dir
    _assert_replies(got, want)
    # The port's own snapshot carries the counters in the JAX schema, and
    # the JAX store takes it back.
    back = port.snapshot()
    assert set(back["counters"]) == {"value", "period", "last_ts", "exists"}
    j2 = _jax(JClock(back["now_ticks"]), counter_slots=8)
    j2.restore(back)
    assert j2._counter_dir.to_dict() == back["counter_dir"]
    np.testing.assert_array_equal(np.asarray(j2._counters.value),
                                  back["counters"]["value"])


def test_counter_epoch_rebase_keeps_elapsed_time():
    clock = ManualClock(2**30 - 2048)
    store = _port(clock, counter_slots=8)
    store.sync_counter_blocking("k", 50.0, 10.0)
    clock.advance_seconds(2.0)  # reaches 2^30: the next sync rebases first
    res = store.sync_counter_blocking("k", 0.0, 10.0)
    assert clock.now_ticks() == 2**29
    assert res.global_score == 30.0  # 50 decayed by 2 s × 10/s
    assert int(store._counters.last_ts[0]) == 2**29
