"""The port's fingerprint store (``runtime/fp_store.py``) against the JAX
package's, on the CPU.

- The JAX package's ``tests/test_fp_store.py`` (``TestTableInvariants``,
  ``TestFingerprintStore``), ``tests/test_reservations.py:328`` and
  ``:361`` and ``tests/test_server_ops.py:130``, on the port's classes
  (``device="cpu"``: the plain versions decide).
- A seeded differential against the JAX ``FingerprintBucketStore`` on
  ManualClocks: flushes, bulks with and without remaining, debits with
  refunds, peeks, sweeps through clock jumps and growth forced by small
  tables, for buckets and both windows. Tolerance: grants, resolve counts
  (``fp_unresolved``), growths and peeks equal; bucket remaining and debit
  replies equal (whole amounts); window remaining within 1.5 float32 ulps of
  the limit (XLA on the CPU contracts the sliding estimate into an FMA; the
  port never does). The plain resolve keeps XLA's last-claimant rule, so
  the tables are equal cell for cell, under window pressure too.
- Snapshots across the packages both ways, a v1 (wrapping) snapshot, and
  the cross-type restores' errors (JAX's type and text).
- The store's ``pregrows`` and ``fp_unresolved`` counters, in
  ``StoreMetrics`` and on ``/metrics``, as a JAX server renders them.

Every wait is a condition under a deadline.
"""

import asyncio
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime import fp_store as jfs
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
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
from distributedratelimiting.redis_tpu.utils import metrics as jmetrics
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    DeviceBucketStore,
    FingerprintBucketStore,
    InProcessBucketStore,
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
    fingerprints,
)
from distributedratelimiting.redis_tpu_torch.utils import metrics as pmetrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120
_FILL = 1e-9


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def FpStore(**kw):
    return FingerprintBucketStore(device="cpu", **kw)


def Device(**kw):
    return DeviceBucketStore(device="cpu", **kw)


# -- the JAX package's TestTableInvariants -------------------------------------

def test_churn_preserves_uniqueness_and_findability():
    """Random claim/expire/re-claim churn: every live fingerprint holds
    exactly one cell, in its key's window, and every live key resolves."""
    rng = np.random.default_rng(17)
    clock = ManualClock()
    store = FpStore(n_slots=256, clock=clock, probe_window=8)
    table = store._table(5.0, 1.0)
    pool = [f"c{i}" for i in range(120)]

    async def churn():
        for _ in range(6):
            batch = [pool[j] for j in rng.integers(0, len(pool), 80)]
            await store.acquire_many(batch, [1] * 80, 5.0, 1.0)
            clock.advance_seconds(float(rng.choice([0.5, 2.0, 3600.0])))
            store.sweep_all()
        fp = table.fp.numpy().view(np.uint32)
        n_live = F.check_table_np(fp, table.probe_window)
        live = fp[(fp != 0).any(1)]
        out = F.fp_resolve(table.fp.clone(), torch.from_numpy(
            live.view(np.int32)), torch.ones(n_live, dtype=torch.bool),
            probe_window=table.probe_window, rounds=1)
        assert out.resolved.all()
        assert len(np.unique(out.slots.numpy())) == n_live
        await store.aclose()

    run(churn())


# -- the JAX package's TestFingerprintStore ------------------------------------

def test_capacity_enforced_async_path():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        got = [(await store.acquire("k", 1, 3.0, 1.0)).granted
               for _ in range(5)]
        assert got == [True] * 3 + [False] * 2
        await store.aclose()

    run(main())


def test_refill_over_time():
    async def main():
        clock = ManualClock()
        store = FpStore(n_slots=256, clock=clock)
        for _ in range(3):
            assert (await store.acquire("k", 1, 3.0, 1.0)).granted
        assert not (await store.acquire("k", 1, 3.0, 1.0)).granted
        clock.advance_seconds(2.0)
        assert (await store.acquire("k", 2, 3.0, 1.0)).granted
        await store.aclose()

    run(main())


@pytest.mark.parametrize("with_remaining", [True, False])
def test_bulk_matches_host_directory_store(with_remaining):
    """Same decision rule, another directory: the fingerprint store decides
    as the host-directory store, the conservative in-batch duplicate rule
    included; the verdict-only path (bit planes) grants as the f32 one."""
    async def main():
        clock = ManualClock()
        store = FpStore(n_slots=1024, clock=clock)
        full = FpStore(n_slots=1024, clock=clock)
        oracle = Device(n_slots=1024, clock=clock)
        rng = np.random.default_rng(7 if with_remaining else 11)
        keys = [f"k{i}" for i in rng.integers(0, 40, 300)]
        counts = rng.integers(0, 4, 300).tolist()
        got = await store.acquire_many(keys, counts, 5.0, 1.0,
                                       with_remaining=with_remaining)
        ref = await full.acquire_many(keys, counts, 5.0, 1.0)
        want = await oracle.acquire_many(keys, counts, 5.0, 1.0,
                                         with_remaining=with_remaining)
        np.testing.assert_array_equal(got.granted, want.granted)
        np.testing.assert_array_equal(got.granted, ref.granted)
        if with_remaining:
            np.testing.assert_allclose(got.remaining, want.remaining,
                                       atol=1e-4)
        else:
            assert got.remaining is None
        for s in (store, full, oracle):
            await s.aclose()

    run(main())


def test_bulk_negative_count_stays_valid_row():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        res = await store.acquire_many(["neg", "pos"], [-1, 1], 5.0, 0.0)
        assert bool(res.granted[0]) and bool(res.granted[1])
        res2 = await store.acquire_many(["neg", "neg"], [5, 1], 5.0, 0.0,
                                        with_remaining=False)
        assert bool(res2.granted[0]) and not bool(res2.granted[1])
        await store.aclose()

    run(main())


def test_bulk_verdict_only_odd_max_batch():
    """max_batch not divisible by 8 takes the f32 result, not bit planes."""
    async def main():
        clock = ManualClock()
        store = FpStore(n_slots=1024, max_batch=60, clock=clock)
        oracle = Device(n_slots=1024, clock=clock)
        rng = np.random.default_rng(13)
        keys = [f"k{i}" for i in range(150)]
        counts = rng.integers(0, 4, 150).tolist()
        got = await store.acquire_many(keys, counts, 5.0, 1.0,
                                       with_remaining=False)
        want = await oracle.acquire_many(keys, counts, 5.0, 1.0,
                                         with_remaining=False)
        assert got.remaining is None
        np.testing.assert_array_equal(got.granted, want.granted)
        await store.aclose()
        await oracle.aclose()

    run(main())


def test_bulk_distinct_keys_match_exact_oracle():
    async def main():
        clock = ManualClock()
        store = FpStore(n_slots=1024, clock=clock)
        oracle = InProcessBucketStore(clock=clock)
        rng = np.random.default_rng(11)
        keys = [f"k{i}" for i in range(300)]
        counts = rng.integers(0, 7, 300).tolist()
        got = await store.acquire_many(keys, counts, 5.0, 1.0)
        want = await oracle.acquire_many(keys, counts, 5.0, 1.0)
        np.testing.assert_array_equal(got.granted, want.granted)
        np.testing.assert_allclose(got.remaining, want.remaining, atol=1e-4)
        await store.aclose()

    run(main())


def test_bulk_duplicate_serialization():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        res = await store.acquire_many(["hot"] * 8, [1] * 8, 5.0, 0.0)
        assert list(res.granted) == [True] * 5 + [False] * 3
        await store.aclose()

    run(main())


def test_peek_and_blocking():
    store = FpStore(n_slots=256, clock=ManualClock())
    assert store.peek_blocking("fresh", 9.0, 1.0) == 9.0
    r = store.acquire_blocking("fresh", 4, 9.0, 1.0)
    assert r.granted and r.remaining == pytest.approx(5.0)
    assert store.peek_blocking("fresh", 9.0, 1.0) == 5.0
    run(store.aclose())


def test_pressure_grows_table_and_keeps_state():
    async def main():
        store = FpStore(n_slots=64, clock=ManualClock(), probe_window=8)
        table = store._table(5.0, 0.0)
        assert (await store.acquire("marker", 2, 5.0, 0.0)).granted
        keys = [f"f{i}" for i in range(200)]
        await store.acquire_many(keys, [1] * 200, 5.0, 0.0)
        assert store.metrics.fp_unresolved > 0
        assert store.metrics.pregrows >= 1
        assert table.n_slots >= 128
        assert store.peek_blocking("marker", 5.0, 0.0) == 3.0
        for _ in range(3):
            res = await store.acquire_many(keys, [1] * 200, 5.0, 0.0)
            if res.granted.all():
                break
        assert res.granted.all()
        assert table.n_slots >= 256
        await store.aclose()

    run(main())


def test_snapshot_restore_roundtrip():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        for i in range(10):
            await store.acquire(f"k{i}", 2, 5.0, 1.0)
        fresh = FpStore(n_slots=256, clock=ManualClock())
        fresh.restore(store.snapshot())
        res = await fresh.acquire_many([f"k{i}" for i in range(10)],
                                       [4] * 10, 5.0, 1.0)
        assert not res.granted.any()
        await store.aclose()
        await fresh.aclose()

    run(main())


def _legacy_keys(m, n):
    """``m`` keys whose old (wrapping) bases in an ``n``-slot table are
    distinct."""
    keys, bases = [], set()
    i = 0
    while len(keys) < m:
        k = f"legacy{i}"
        fp = fingerprints([k])
        b = int((((fp[:, 0] * np.uint32(0x9E3779B1)) ^ fp[:, 1])
                 % np.uint32(n))[0])
        if b not in bases:
            keys.append(k)
            bases.add(b)
        i += 1
    return keys


def _legacy_table(keys, n):
    """A v1 (wrapping, no ``placement``) bucket table: each key at its old
    base ``h mod n``, tokens = its index."""
    fps = fingerprints(keys)
    base_old = ((fps[:, 0] * np.uint32(0x9E3779B1)) ^ fps[:, 1]) % np.uint32(n)
    fp_tab = np.zeros((n, 2), np.uint32)
    tokens = np.zeros((n,), np.float32)
    exists = np.zeros((n,), bool)
    for i, b in enumerate(base_old):
        assert not fp_tab[b].any(), "test keys must not collide"
        fp_tab[b] = fps[i]
        tokens[b] = float(i)
        exists[b] = True
    return {"fp": fp_tab, "probe_window": 16, "tokens": tokens,
            "last_ts": np.zeros((n,), np.int32), "exists": exists}


def test_restore_replaces_legacy_wrapping_placement():
    async def main():
        keys = [f"legacy{i}" for i in range(20)]
        store = FpStore(n_slots=256, clock=ManualClock())
        store.acquire_blocking("warm", 1, 100.0, 0.0)
        snap = store.snapshot()
        snap["tables"] = {next(iter(snap["tables"])):
                          _legacy_table(keys, 256)}
        store.restore(snap)
        for i, k in enumerate(keys):
            assert store.peek_blocking(k, 100.0, 0.0) == float(i), k
        await store.aclose()

    run(main())


def test_restore_adopts_snapshot_probe_window():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock(), probe_window=16)
        for i in range(40):
            await store.acquire(f"k{i}", 2, 5.0, 0.0)
        narrow = FpStore(n_slots=256, clock=ManualClock(), probe_window=4)
        narrow.restore(store.snapshot())
        assert narrow._table(5.0, 0.0).probe_window == 16
        res = await narrow.acquire_many([f"k{i}" for i in range(40)],
                                        [4] * 40, 5.0, 0.0)
        assert not res.granted.any()
        await store.aclose()
        await narrow.aclose()

    run(main())


def test_cross_type_restore_rejected_with_jax_errors():
    """Both directions raise the JAX package's ValueError with its text,
    for buckets and windows."""
    async def main():
        errors = []
        for Host, Fp, clock in ((Device, FpStore, ManualClock),
                                (JDevice, jfs.FingerprintBucketStore,
                                 JClock)):
            got = []
            host = Host(n_slots=256, clock=clock())
            await host.acquire("k", 1, 5.0, 1.0)
            await host.window_acquire("w", 1, 5.0, 1.0)
            fp = Fp(n_slots=256, clock=clock())
            await fp.acquire("k", 1, 5.0, 1.0)
            await fp.window_acquire("w", 1, 5.0, 1.0)
            for snap, dst in ((host.snapshot(), Fp), (fp.snapshot(), Host)):
                for part in ("tables", "wtables"):
                    other = "wtables" if part == "tables" else "tables"
                    s = dict(snap, **{other: {}})
                    with pytest.raises(ValueError) as exc:
                        dst(n_slots=256, clock=clock()).restore(s)
                    got.append(str(exc.value))
            errors.append(got)
            await host.aclose()
            await fp.aclose()
        assert errors[0] == errors[1]
        assert "host key directory" in errors[0][0]
        assert "fingerprint" in errors[0][2]

    run(main())


def test_aux_tiers_inherited():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        assert (await store.window_acquire("w", 1, 3.0, 10.0)).granted
        r = await store.sync_counter("c", 5.0, 0.0)
        assert r.global_score == pytest.approx(5.0)
        assert (await store.concurrency_acquire("s", 1, 2)).granted
        await store.concurrency_release("s", 1)
        await store.aclose()

    run(main())


def test_window_tier_uses_fingerprint_directory():
    async def main():
        clock = ManualClock()
        store = FpStore(n_slots=256, clock=clock)
        got = [(await store.window_acquire("w", 1, 3.0, 10.0)).granted
               for _ in range(5)]
        assert got == [True] * 3 + [False] * 2
        wt = store._wtable(3.0, 10.0)
        assert not hasattr(wt, "dir")
        assert int((wt.fp != 0).any(1).sum()) == 1
        clock.advance_seconds(15.0)
        assert (await store.window_acquire("w", 1, 3.0, 10.0)).granted
        await store.aclose()

    run(main())


@pytest.mark.parametrize("with_remaining", [True, False])
def test_window_bulk_matches_host_directory_store(with_remaining):
    async def main():
        clock = ManualClock()
        rng = np.random.default_rng(5 if with_remaining else 17)
        keys = [f"w{i}" for i in rng.integers(0, 50, 300)]
        counts = rng.integers(0, 3, 300).tolist()
        for fixed in (False, True):
            store = FpStore(n_slots=1024, clock=clock)
            full = FpStore(n_slots=1024, clock=clock)
            oracle = Device(n_slots=1024, clock=clock)
            got = await store.window_acquire_many(
                keys, counts, 4.0, 10.0, fixed=fixed,
                with_remaining=with_remaining)
            ref = await full.window_acquire_many(keys, counts, 4.0, 10.0,
                                                 fixed=fixed)
            want = await oracle.window_acquire_many(
                keys, counts, 4.0, 10.0, fixed=fixed,
                with_remaining=with_remaining)
            np.testing.assert_array_equal(got.granted, want.granted)
            np.testing.assert_array_equal(got.granted, ref.granted)
            if with_remaining:
                np.testing.assert_allclose(got.remaining, want.remaining,
                                           atol=1e-4)
            for s in (store, full, oracle):
                await s.aclose()

    run(main())


def test_window_growth_preserves_state():
    async def main():
        store = FpStore(n_slots=64, clock=ManualClock(), probe_window=8)
        wt = store._wtable(5.0, 60.0)
        assert (await store.window_acquire_many(["wm"], [4], 5.0,
                                                60.0)).granted.all()
        keys = [f"wf{i}" for i in range(200)]
        for _ in range(4):
            res = await store.window_acquire_many(keys, [1] * 200, 5.0, 60.0)
            if res.granted.all():
                break
        assert res.granted.all() and wt.n_slots >= 256
        r2 = await store.window_acquire_many(["wm"], [2], 5.0, 60.0)
        assert not r2.granted.any()
        await store.aclose()

    run(main())


def test_window_snapshot_roundtrip_and_cross_type():
    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        await store.window_acquire("w", 3, 5.0, 60.0)
        snap = store.snapshot()
        fresh = FpStore(n_slots=256, clock=ManualClock())
        fresh.restore(snap)
        assert not (await fresh.window_acquire("w", 3, 5.0, 60.0)).granted
        with pytest.raises(ValueError, match="fingerprint"):
            Device(n_slots=256, clock=ManualClock()).restore(snap)
        await store.aclose()
        await fresh.aclose()

    run(main())


def test_concurrent_mixed_traffic_with_growth():
    """Async flushes, blocking bulk calls from threads and growth pressure
    on one table: launches hold the store lock, nothing is lost, and a
    cap-10 key with no refill grants exactly 10."""
    async def main():
        store = FpStore(n_slots=128, clock=ManualClock(), probe_window=8)
        errors = []

        def bulk_worker(w):
            try:
                keys = [f"b{w}-{i}" for i in range(150)]
                for _ in range(3):
                    store.acquire_many_blocking(keys, [1] * 150, 5.0, 0.0)
            except Exception as exc:  # noqa: BLE001 — reported below
                errors.append(exc)

        threads = [threading.Thread(target=bulk_worker, args=(w,))
                   for w in range(3)]
        for t in threads:
            t.start()
        granted_hot = 0
        for _ in range(40):
            granted_hot += int((await store.acquire("hot", 1, 10.0,
                                                    0.0)).granted)
        for t in threads:
            await asyncio.to_thread(t.join, LIMIT_S)
            assert not t.is_alive()
        assert not errors, errors
        assert granted_hot == 10
        assert store._table(5.0, 0.0).n_slots > 128
        await store.aclose()

    run(main())


def test_limiter_integration():
    from distributedratelimiting.redis_tpu_torch.models.options import (
        TokenBucketOptions,
    )
    from distributedratelimiting.redis_tpu_torch.models.token_bucket import (
        TokenBucketRateLimiter,
    )

    async def main():
        store = FpStore(n_slots=256, clock=ManualClock())
        limiter = TokenBucketRateLimiter(
            TokenBucketOptions(token_limit=3, tokens_per_period=1,
                               instance_name="api"), store)
        got = [(await limiter.acquire_async(1)).is_acquired
               for _ in range(5)]
        assert got == [True] * 3 + [False] * 2
        await store.aclose()

    run(main())


# -- tests/test_reservations.py:328 and :361 -----------------------------------

def test_fp_store_debit_many_direct_including_refund():
    async def body():
        st = FpStore(n_slots=256)
        await st.connect()
        await st.acquire("k1", 40, 100.0, _FILL)
        rem, short = await st.debit_many(["k1"], [30.0], 100.0, _FILL)
        assert rem[0] == pytest.approx(30.0) and short[0] == 0.0
        rem, short = await st.debit_many(["k1"], [500.0], 100.0, _FILL)
        assert rem[0] == 0.0 and short[0] == pytest.approx(470.0)
        rem, short = await st.debit_many(["k1"], [-25.0], 100.0, _FILL)
        assert rem[0] == pytest.approx(25.0) and short[0] == 0.0
        rem, short = await st.debit_many(["fresh"], [10.0], 100.0, _FILL)
        assert rem[0] == pytest.approx(90.0) and short[0] == 0.0
        await st.aclose()

    run(body())


def test_fp_store_hier_deny_refund_regression():
    """The base compose on the fingerprint store: parent granted, child
    denied, the parent refunded through ``debit_many``."""
    async def body():
        st = FpStore(n_slots=256)
        await st.connect()
        r = await st.acquire_hierarchical("tenantA", "kk", 50, 500.0, _FILL,
                                          20.0, _FILL)
        assert not r.granted
        assert st.peek_blocking("tenantA", 500.0, _FILL) == pytest.approx(
            500.0)
        many = await st.acquire_hierarchical_many(
            ["tenantA"] * 3, ["a", "b", "a"], [15, 15, 15], 500.0, _FILL,
            20.0, _FILL)
        assert many.granted.tolist() == [True, True, False]
        assert st.peek_blocking("tenantA", 500.0, _FILL) == pytest.approx(
            470.0)
        await st.aclose()

    run(body())


# -- tests/test_server_ops.py:130 ------------------------------------------------

def _readline(proc, limit=LIMIT_S):
    out = []
    t = threading.Thread(target=lambda: out.append(proc.stdout.readline()),
                         daemon=True)
    t.start()
    t.join(limit)
    assert out, "the console server printed nothing in time"
    return out[0]


def test_server_cli_fp_directory():
    """``--directory fp`` from the console: buckets, windows and a bulk
    call decided from fingerprints over TCP."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m",
         "distributedratelimiting.redis_tpu_torch.runtime.server",
         "--directory", "fp", "--device", "cpu", "--port", "0",
         "--slots", "256"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True)
    try:
        m = re.search(r"listening on (\S+):(\d+)", _readline(proc))
        assert m
        host, port = m.group(1), int(m.group(2))

        async def drive():
            client = RemoteBucketStore(address=(host, port))
            try:
                got = [(await client.acquire("k", 1, 3.0, 0.0)).granted
                       for _ in range(5)]
                assert got == [True] * 3 + [False] * 2
                assert (await client.window_acquire("w", 2, 3.0,
                                                    10.0)).granted
                res = await client.acquire_many(
                    [f"b{i}" for i in range(32)], [1] * 32, 5.0, 1.0)
                assert res.granted.all()
                stats = await client.stats()
                assert "fp_unresolved" in stats["store"]
            finally:
                await client.aclose()

        run(drive())
    finally:
        proc.terminate()
        proc.wait(timeout=30)


# -- the seeded differential against the JAX store -------------------------------

START = 100_000


async def _traffic(store, seed, kind):
    """One seeded schedule; returns every answer and the store's counters.
    ``kind``: bucket, sliding or fixed."""
    rng = np.random.default_rng(seed)
    pool = [f"u{seed}-{i}" for i in range(700)]
    out = []

    def bulk(keys, counts, with_remaining):
        if kind == "bucket":
            return store.acquire_many(keys, counts, 6.0, 2.0,
                                      with_remaining=with_remaining)
        return store.window_acquire_many(keys, counts, 6.0, 2.0,
                                         fixed=kind == "fixed",
                                         with_remaining=with_remaining)

    def one(key, count):
        if kind == "bucket":
            return store.acquire(key, count, 6.0, 2.0)
        if kind == "fixed":
            return store.fixed_window_acquire(key, count, 6.0, 2.0)
        return store.window_acquire(key, count, 6.0, 2.0)

    for step in range(8):
        keys = [pool[i] for i in
                np.minimum(rng.zipf(1.3, 400) - 1, len(pool) - 1)]
        counts = rng.integers(0, 4, 400).tolist()
        r = await bulk(keys, counts, True)
        out += [r.granted, r.remaining]
        r = await bulk(keys[:200], counts[:200], False)
        out.append(r.granted)
        rs = await asyncio.gather(*(one(k, c) for k, c in
                                    zip(keys[:40], counts[:40])))
        out += [np.array([x.granted for x in rs]),
                np.array([x.remaining for x in rs], np.float32)]
        if kind == "bucket":
            amounts = rng.integers(-2, 4, 30).astype(float).tolist()
            out += list(await store.debit_many(keys[:30], amounts, 6.0, 2.0))
            out.append(np.array([store.peek_blocking(k, 6.0, 2.0)
                                 for k in keys[:30]]))
        jump = [0.1, 1.0, 5.0, 3600.0][step % 4]
        store.clock.advance_seconds(jump)
        if step % 3 == 2:
            store.sweep_all()
    m = store.metrics
    counters = (m.pregrows, m.fp_unresolved, m.sweeps, m.slots_evicted)
    await store.aclose()
    return out, counters


@pytest.mark.parametrize("kind", ["bucket", "sliding", "fixed"])
@pytest.mark.parametrize("seed,n_slots", [(1, 4096), (2, 128), (3, 64)])
def test_seeded_differential_against_jax(kind, seed, n_slots):
    """The port's store and the JAX store on one schedule: growth forced by
    the small tables, sweeps through clock jumps."""
    mine = run(_traffic(FpStore(n_slots=n_slots, clock=ManualClock(START),
                                probe_window=16), seed, kind))
    theirs = run(_traffic(jfs.FingerprintBucketStore(
        n_slots=n_slots, clock=JClock(START), probe_window=16,
        max_batch=4096), seed, kind))
    assert mine[1][:2] == theirs[1][:2]
    assert mine[1][3] == theirs[1][3]
    if n_slots < 4096:
        assert mine[1][0] >= 1  # grew
    tol = np.spacing(np.float32(6.0)) * 1.5 if kind == "sliding" else 0
    for i, (a, b) in enumerate(zip(mine[0], theirs[0])):
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype == bool:
            np.testing.assert_array_equal(a, b, f"answer {i}")
        else:
            np.testing.assert_allclose(a.astype(np.float64),
                                       b.astype(np.float64), rtol=0,
                                       atol=tol, err_msg=f"answer {i}")


# -- snapshots across the packages ------------------------------------------------

async def _populate(store):
    rng = np.random.default_rng(9)
    keys = [f"s{i}" for i in range(300)]
    await store.acquire_many(keys, rng.integers(0, 5, 300).tolist(), 6.0,
                             2.0)
    await store.window_acquire_many(keys[:100], [2] * 100, 6.0, 2.0)
    await store.window_acquire_many(keys[:100], [3] * 100, 6.0, 2.0,
                                    fixed=True)
    return keys


def _peeks(store, keys):
    return [store.peek_blocking(k, 6.0, 2.0) for k in keys]


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_snapshot_crosses_packages(direction):
    """A JAX fingerprint snapshot restores into the port and the port's into
    JAX: tables and fp cells equal, every peek and every next decision
    equal."""
    async def main():
        if direction == "jax_to_port":
            src = jfs.FingerprintBucketStore(n_slots=512, clock=JClock(START),
                                             max_batch=4096)
            dst = FpStore(n_slots=64, clock=ManualClock(START + 77))
        else:
            src = FpStore(n_slots=512, clock=ManualClock(START))
            dst = jfs.FingerprintBucketStore(n_slots=64,
                                             clock=JClock(START + 77),
                                             max_batch=4096)
        keys = await _populate(src)
        snap = src.snapshot()
        dst.restore(snap)
        back = dst.snapshot()
        for part in ("tables", "wtables"):
            assert back[part].keys() == snap[part].keys()
            for key in snap[part]:
                a, b = snap[part][key], back[part][key]
                assert b["placement"] == 2 and b["probe_window"] == 16
                np.testing.assert_array_equal(np.asarray(b["fp"]),
                                              np.asarray(a["fp"]))
                assert np.asarray(b["fp"]).dtype == np.uint32
        # A restore re-aligns timestamps to the new clock: both stores stand
        # at the snapshot's instant.
        assert _peeks(dst, keys) == _peeks(src, keys)
        for s in (src, dst):
            s.clock.advance_ticks(500)
        a = await src.acquire_many(keys, [2] * 300, 6.0, 2.0)
        b = await dst.acquire_many(keys, [2] * 300, 6.0, 2.0)
        np.testing.assert_array_equal(a.granted, b.granted)
        np.testing.assert_array_equal(a.remaining, b.remaining)
        w1 = await src.window_acquire_many(keys[:100], [1] * 100, 6.0, 2.0)
        w2 = await dst.window_acquire_many(keys[:100], [1] * 100, 6.0, 2.0)
        np.testing.assert_array_equal(w1.granted, w2.granted)
        await src.aclose()
        await dst.aclose()

    run(main())


def test_v1_snapshot_replaced_as_jax_does():
    """A v1 (wrapping) snapshot re-placed through the migrate kernel: the
    port's table equals the JAX store's cell for cell."""
    keys = _legacy_keys(60, 256)

    async def main(store):
        store.acquire_blocking("warm", 1, 100.0, 0.0)
        snap = store.snapshot()
        snap["tables"] = {next(iter(snap["tables"])):
                          _legacy_table(keys, 256)}
        store.restore(snap)
        peeks = [store.peek_blocking(k, 100.0, 0.0) for k in keys]
        fp = np.asarray(store.snapshot()["tables"][(100.0, 0.0)]["fp"])
        await store.aclose()
        return peeks, fp

    mine = run(main(FpStore(n_slots=256, clock=ManualClock(START))))
    theirs = run(main(jfs.FingerprintBucketStore(n_slots=256,
                                                 clock=JClock(START))))
    assert mine[0] == theirs[0] == [float(i) for i in range(60)]
    np.testing.assert_array_equal(mine[1], theirs[1])


# -- growth: one device pass over the old table -----------------------------------
def _h_keys(rng, hs):
    """Fingerprints whose placement hash ``(lo * MIX) ^ hi`` is each of
    ``hs``: keys that share a window at a chosen table size."""
    lo = rng.integers(1, 2**32, len(hs), dtype=np.uint64).astype(np.uint32)
    hi = np.asarray(hs, np.uint32) ^ (lo * np.uint32(F.MIX))
    return np.stack([lo, hi], 1)


def _old_table(rng, n, keys, kind):
    """A table of ``n`` cells holding ``keys`` at random cells (growth reads
    live cells wherever they lie) with random state on them."""
    fp = np.zeros((n, 2), np.uint32)
    cells = rng.permutation(n)[:len(keys)]
    fp[cells] = keys
    live = (fp != 0).any(1)
    if kind == "bucket":
        cols = [rng.uniform(0, 6, n).astype(np.float32),
                rng.integers(START - 3000, START, n).astype(np.int32),
                rng.random(n) < 0.8]
    else:
        cols = [rng.integers(0, 4, n).astype(np.float32),
                rng.integers(0, 4, n).astype(np.float32),
                rng.integers(90, 98, n).astype(np.int32),
                rng.random(n) < 0.8]
    for c in cols:
        c[~live] = 0
    return fp, cols


def _install(jtable, ptable, fp, cols):
    """The same old table in a JAX store's table and the port's."""
    import jax.numpy as jnp

    jtable.fp = jnp.asarray(fp)
    jtable.state = type(jtable.state)(*(jnp.asarray(c) for c in cols))
    jtable.n_slots = len(fp)
    ptable.fp = torch.from_numpy(fp.view(np.int32).copy())
    ptable.state = type(ptable.state)(*(torch.from_numpy(c.copy())
                                        for c in cols))
    ptable.n_slots = len(fp)


def _tables(kind, n, max_batch):
    j = jfs.FingerprintBucketStore(n_slots=n, clock=JClock(START),
                                   probe_window=16, max_batch=max_batch)
    p = FpStore(n_slots=n, clock=ManualClock(START), probe_window=16,
                max_batch=max_batch)
    if kind == "bucket":
        return j, p, j._table(6.0, 2.0), p._table(6.0, 2.0)
    return j, p, j._wtable(6.0, 2.0), p._wtable(6.0, 2.0)


@pytest.mark.parametrize("kind", ["bucket", "window"])
@pytest.mark.parametrize("full", [False, True])
def test_growth_matches_jax_rehash(kind, full):
    """A store's growth (``_grow``: the table form's passes, the plain
    version's chunks of ``max_batch``) against the JAX store's ``_rehash``
    on the same old table: the new size, ``pregrows``, the cells slot for
    slot and every state column. ``full``: 17 keys share one 16-cell window
    at the doubled size, so JAX's rule doubles again (512 → 1024), and the
    port must too."""
    rng = np.random.default_rng(7 + full)
    keys = _fps_np(rng, 150)
    if full:
        hs = 5 + 497 * rng.permutation(np.arange(1, 4000))[:17]
        keys = np.concatenate([keys, _h_keys(rng, hs)])
    fp, cols = _old_table(rng, 256, keys, kind)
    j, p, jt, pt = _tables(kind, 256, 64)
    _install(jt, pt, fp, cols)
    jt._grow()
    pt._grow()
    assert pt.n_slots == jt.n_slots == (1024 if full else 512)
    assert p.metrics.pregrows == j.metrics.pregrows == 1
    np.testing.assert_array_equal(pt.fp.numpy().view(np.uint32),
                                  np.asarray(jt.fp))
    for name, a, b in zip(pt.state._fields, pt.state, jt.state):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
    assert F.check_table_np(pt.fp.numpy().view(np.uint32), 16) == len(keys)
    run(j.aclose())
    run(p.aclose())


def _fps_np(rng, m):
    return np.unique(rng.integers(1, 2**32, (m, 2), dtype=np.uint64).astype(
        np.uint32), axis=0)


def test_growth_fails_loudly_as_jax_after_four_doublings():
    """17 keys of one placement hash share a window at every size: both
    stores raise the same error after four doublings and keep the old
    table."""
    rng = np.random.default_rng(9)
    keys = np.concatenate([_fps_np(rng, 40), _h_keys(rng, [12345] * 17)])
    fp, cols = _old_table(rng, 256, keys, "bucket")
    j, p, jt, pt = _tables("bucket", 256, 64)
    _install(jt, pt, fp, cols)
    errors = []
    for t in (jt, pt):
        with pytest.raises(RuntimeError) as e:
            t._grow()
        errors.append(str(e.value))
    assert errors[0] == errors[1] == ("fingerprint rehash cannot place 1 "
                                      "entries even at 4096 slots")
    assert pt.n_slots == 256 and p.metrics.pregrows == 0
    np.testing.assert_array_equal(pt.fp.numpy().view(np.uint32), fp)
    run(j.aclose())
    run(p.aclose())


@pytest.mark.parametrize("kind", ["bucket", "window"])
def test_growth_reads_no_table_back(kind, monkeypatch):
    """Growth, from traffic that fills a small table, and a v1 snapshot's
    re-placement read nothing back larger than a scalar (``_to_host``), and
    each growth pass is one ``fp_migrate_table`` call, not one a chunk."""
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
    from distributedratelimiting.redis_tpu_torch.runtime import fp_store

    sizes, passes, grows = [], [], []
    real_host, real_pass = fp_store._to_host, ck.fp_migrate_table
    real_grow = fp_store._FpTable._grow

    def host(t):
        if grows and grows[-1] == "in":
            sizes.append(t.numel())
        return real_host(t)

    def one_pass(*a, **kw):
        passes.append(kw.get("source") is None)
        return real_pass(*a, **kw)

    def grow(self):
        grows.append("in")
        try:
            real_grow(self)
        finally:
            grows.append("out")

    monkeypatch.setattr(fp_store, "_to_host", host)
    monkeypatch.setattr(ck, "fp_migrate_table", one_pass)
    monkeypatch.setattr(fp_store._FpTable, "_grow", grow)
    store = FpStore(n_slots=256, clock=ManualClock(START), max_batch=64)
    keys = [f"k{i}" for i in range(900)]

    async def fill():
        for i in range(0, len(keys), 300):
            part = keys[i:i + 300]
            for _ in range(4):
                if kind == "bucket":
                    r = await store.acquire_many(part, [1] * len(part), 6.0,
                                                 2.0)
                else:
                    r = await store.window_acquire_many(
                        part, [1] * len(part), 6.0, 2.0)
                part = [k for k, g in zip(part, r.granted) if not g]
                if not part:
                    break
    run(fill())
    n_grows = grows.count("in")
    assert n_grows >= 1 and store.metrics.pregrows == n_grows
    assert all(n <= 1 for n in sizes)
    # Each attempt (a doubling may need another) is a whole-table pass and
    # at most a pass or two of its leftovers, never a pass a chunk.
    attempts = passes.count(True)
    assert n_grows <= attempts and len(passes) <= 3 * attempts
    # A v1 snapshot's re-placement: the same pass, nothing read back.
    table = (store._table(6.0, 2.0) if kind == "bucket"
             else store._wtable(6.0, 2.0))
    snap = table.to_snap()
    snap["placement"] = 1
    del passes[:]
    grows.append("in")
    table.load_snap(snap, 0)
    grows.append("out")
    assert passes and passes[0] and not any(passes[1:])
    assert all(n <= 1 for n in sizes)
    run(store.aclose())


# -- the store's growth and pressure counters -------------------------------------

def test_store_metrics_carry_pregrows_and_fp_unresolved_as_jax():
    """``StoreMetrics.snapshot()``'s keys are the JAX package's, in its
    order, but ``pallas_sweep_failures`` (the port has no Pallas sweep);
    an fp store counts its growths and unresolved rows as JAX's does."""
    mine = list(pmetrics.StoreMetrics().snapshot())
    theirs = [k for k in jmetrics.StoreMetrics().snapshot()
              if k != "pallas_sweep_failures"]
    assert mine == theirs


def test_server_renders_fp_counters_as_jax():
    """The two packages' servers over their fingerprint stores, one
    schedule that forces growth: the ``drl_store_pregrows`` and
    ``drl_store_fp_unresolved`` lines are equal byte for byte."""
    async def serve(srv, Remote):
        await srv.start()
        cli = Remote(address=(srv.host, srv.port), coalesce_requests=False)
        try:
            await cli.acquire_many([f"g{i}" for i in range(300)], [1] * 300,
                                   5.0, 1.0)
            text = await cli.metrics()
        finally:
            await cli.aclose()
            await srv.aclose()
        return [line for line in text.splitlines()
                if "pregrows" in line or "fp_unresolved" in line]

    mine = run(serve(BucketStoreServer(FpStore(
        n_slots=64, clock=ManualClock(START), probe_window=8), audit=False),
        RemoteBucketStore))
    theirs = run(serve(JServer(jfs.FingerprintBucketStore(
        n_slots=64, clock=JClock(START), probe_window=8), audit=False),
        JRemote))
    assert mine == theirs
    assert any(re.match(r"drl_store_pregrows_total [1-9]", line)
               for line in mine), mine


def test_incremental_chain_over_fp_store(tmp_path):
    """The v4 delta chain over a fingerprint store: dirty rows counted
    between saves, a base and a delta restored into a fresh store, every
    peek equal."""
    from distributedratelimiting.redis_tpu_torch.runtime import checkpoint

    async def main():
        st = FpStore(n_slots=4096, clock=ManualClock(START))
        st.enable_dirty_tracking()
        keys = [f"c{i}" for i in range(500)]
        await st.acquire_many(keys, [1] * 500, 5.0, 1.0)
        await st.window_acquire_many(keys[:100], [2] * 100, 6.0, 2.0)
        chain = checkpoint.SnapshotChain(str(tmp_path / "snap.pkl"))
        chain.save(st)
        assert st.dirty_stats()["dirty"] == 0
        await st.acquire_many(keys[:20], [2] * 20, 5.0, 1.0)
        assert st.dirty_stats()["dirty"] == 20
        assert chain.save(st).endswith(".delta.1")
        fresh = FpStore(n_slots=64, clock=ManualClock(START))
        assert checkpoint.load_snapshot_chain(
            fresh, str(tmp_path / "snap.pkl")) == 1
        peeks = [st.peek_blocking(k, 5.0, 1.0) for k in keys]
        assert [fresh.peek_blocking(k, 5.0, 1.0) for k in keys] == peeks
        assert min(peeks) < 5.0
        a = await st.window_acquire_many(keys[:100], [4] * 100, 6.0, 2.0)
        b = await fresh.window_acquire_many(keys[:100], [4] * 100, 6.0, 2.0)
        np.testing.assert_array_equal(a.granted, b.granted)
        await st.aclose()
        await fresh.aclose()

    run(main())
