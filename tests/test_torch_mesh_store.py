"""The port's ``MeshBucketStore`` (``redis_tpu_torch/parallel/mesh_store.py``)
on a mesh of 8 x ``cpu``, against the JAX package's on its 8 virtual CPU
devices.

- The JAX file ``tests/test_mesh_store.py``'s surface, class by class: the
  bucket tier, the star topology over the wire (the port's server, and a
  JAX client against it), the coordinated rebase, the read-only peek, the
  combined metrics, the aux-only rebase, the fp directory, the cadence
  plumbing, the aux tiers' cardinality, the legacy aux-window snapshot.
- A seeded differential of the whole store surface against JAX's
  ``MeshBucketStore`` (buckets, windows sliding and fixed, counters,
  semaphores, peeks, bulks, sweeps), host and fp directories, then a
  snapshot restored into the other package. Grants and peeks equal;
  remaining and counter scores within 1e-6 relative (windows 1.5 ulps of
  the limit).
- The console server with ``--backend mesh --sync-cadence launch``, parsed
  and served on the CPU; a mesh server's ``OP_STATS`` carries the tiers.
- Methods JAX's mesh store does not define answer as JAX's do.
"""

import asyncio
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.parallel.mesh import (
    create_mesh as jcreate_mesh,
)
from distributedratelimiting.redis_tpu.parallel.mesh_store import (
    MeshBucketStore as JMesh,
)
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu_torch import (
    ApproximateTokenBucketOptions,
    ApproximateTokenBucketRateLimiter,
    BucketStoreServer,
    ManualClock,
    MeshBucketStore,
    PartitionedRateLimiter,
    RemoteBucketStore,
    TokenBucketOptions,
)
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT_S = 120
S = 8


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def mesh8():
    return Mesh(["cpu"] * S)


@pytest.fixture
def store():
    return MeshBucketStore(mesh8(), per_shard_slots=32, clock=ManualClock(),
                           max_batch=64, max_delay_s=2e-3)


def test_legacy_aux_window_snapshot_migrates_to_sharded_tier():
    async def main():
        legacy = MeshBucketStore(mesh8(), clock=ManualClock(),
                                 per_shard_slots=16)
        await legacy.connect()
        legacy._aux.window_acquire_blocking("w", 3, 3.0, 1.0)
        snap = legacy.snapshot()
        snap.pop("windows", None)
        assert snap["aux"]["wtables"]
        await legacy.aclose()
        fresh = MeshBucketStore(mesh8(), clock=ManualClock(),
                                per_shard_slots=16)
        await fresh.connect()
        fresh.restore(snap)
        assert not fresh.window_acquire_blocking("w", 1, 3.0, 1.0).granted
        assert not fresh._aux._wtables
        await fresh.aclose()

    run(main())


def test_legacy_aux_windows_refused_by_the_fp_directory():
    legacy = MeshBucketStore(mesh8(), clock=ManualClock(), per_shard_slots=16)
    legacy._aux.window_acquire_blocking("w", 3, 3.0, 1.0)
    snap = legacy.snapshot()
    snap.pop("windows", None)
    fresh = MeshBucketStore(mesh8(), clock=ManualClock(), per_shard_slots=16,
                            directory="fp")
    with pytest.raises(ValueError, match="legacy snapshot"):
        fresh.restore(snap)


class TestBucketTier:
    def test_blocking_semantics_match_reference(self, store):
        clock = store.clock
        for _ in range(5):
            assert store.acquire_blocking("k", 1, 5.0, 1.0).granted
        assert not store.acquire_blocking("k", 1, 5.0, 1.0).granted
        clock.advance_seconds(2.0)
        assert store.acquire_blocking("k", 2, 5.0, 1.0).granted
        assert store.peek_blocking("k", 5.0, 1.0) == 0.0

    def test_async_micro_batched_across_shards(self, store):
        async def main():
            results = await asyncio.gather(*(
                store.acquire(f"key-{i}", 1, 100.0, 1.0) for i in range(48)))
            assert all(r.granted for r in results)
            dup = await asyncio.gather(*(
                store.acquire("hot", 1, 3.0, 0.1) for _ in range(8)))
            assert sum(r.granted for r in dup) == 3
            await store.aclose()

        run(main())

    def test_two_level_global_tier_visible(self, store):
        store.acquire_blocking("a", 2, 100.0, 1.0)
        store.acquire_blocking("b", 3, 100.0, 1.0)
        assert store._sharded(100.0, 1.0).global_score == 5.0

    def test_aux_families_share_the_clock(self, store):
        clock = store.clock
        assert store.window_acquire_blocking("w", 3, 3.0, 1.0).granted
        assert not store.window_acquire_blocking("w", 1, 3.0, 1.0).granted
        assert store.concurrency_acquire_blocking("s", 2, 2).granted
        store.concurrency_release_blocking("s", 2)
        assert store.sync_counter_blocking("g", 4.0, 1.0).global_score == 4.0
        clock.advance_seconds(2.0)
        assert store.sync_counter_blocking("g", 0.0, 1.0).global_score == \
            pytest.approx(2.0, abs=0.01)

    def test_snapshot_restore_roundtrip(self, store):
        store.acquire_blocking("k", 4, 10.0, 1.0)
        store.window_acquire_blocking("w", 2, 5.0, 1.0)
        other = MeshBucketStore(mesh8(), per_shard_slots=32,
                                clock=ManualClock(), max_batch=64)
        other.restore(store.snapshot())
        assert other.acquire_blocking("k", 6, 10.0, 1.0).granted
        assert not other.acquire_blocking("k", 1, 10.0, 1.0).granted
        assert other.window_acquire_blocking("w", 3, 5.0, 1.0).granted
        assert not other.window_acquire_blocking("w", 1, 5.0, 1.0).granted


class TestStarTopologyOverMesh:
    def test_remote_clients_share_the_mesh(self, store):
        async def main():
            async with BucketStoreServer(store) as srv:
                a = RemoteBucketStore(address=(srv.host, srv.port))
                b = RemoteBucketStore(address=(srv.host, srv.port))
                opts = TokenBucketOptions(token_limit=4, tokens_per_period=1,
                                          instance_name="api")
                lim_a = PartitionedRateLimiter(opts, a)
                lim_b = PartitionedRateLimiter(opts, b)
                try:
                    r = [await lim_a.acquire_async("u1"),
                         await lim_b.acquire_async("u1"),
                         await lim_a.acquire_async("u1"),
                         await lim_b.acquire_async("u1")]
                    assert all(x.is_acquired for x in r)
                    assert not (await lim_a.acquire_async("u1")).is_acquired
                    assert not (await lim_b.acquire_async("u1")).is_acquired
                    ap = ApproximateTokenBucketRateLimiter(
                        ApproximateTokenBucketOptions(
                            token_limit=100, tokens_per_period=10,
                            instance_name="approx"), a)
                    assert (await ap.acquire_async(1)).is_acquired
                    await ap.refresh()
                    assert ap.stats()["syncs"] == 1
                    await ap.aclose()
                    stats = await a.stats()
                    tiers = stats["store"]["tiers"]
                    assert any(k.startswith("bucket[") for k in tiers)
                finally:
                    await a.aclose()
                    await b.aclose()

        run(main())

    def test_jax_client_bulks_over_the_mesh(self, store):
        async def main():
            async with BucketStoreServer(store) as srv:
                cli = JRemote(address=(srv.host, srv.port))
                try:
                    keys = [f"b{i % 70}" for i in range(300)]
                    res = await cli.acquire_many(keys, [1] * 300, 3.0, 1e-6)
                    assert int(np.asarray(res.granted).sum()) == 210
                    wres = await cli.window_acquire_many(
                        keys, [1] * 300, 2.0, 5.0)
                    assert int(np.asarray(wres.granted).sum()) == 140
                finally:
                    await cli.aclose()

        run(main())


class TestCoordinatedRebase:
    def test_all_tiers_rebase_together(self):
        clock = ManualClock(start_ticks=2**30 - 2048)
        store = MeshBucketStore(mesh8(), per_shard_slots=32, clock=clock,
                                max_batch=64)
        store.acquire_blocking("a", 5, 5.0, 1.0)
        store.acquire_blocking("b", 3, 30.0, 2.0)
        store.window_acquire_blocking("w", 3, 3.0, 1.0)
        store.sync_counter_blocking("g", 10.0, 1.0)
        clock.advance_seconds(4.0)
        store.acquire_blocking("trigger", 1, 5.0, 1.0)
        assert clock.now_ticks() < 2**30
        assert store.acquire_blocking("a", 4, 5.0, 1.0).granted
        assert not store.acquire_blocking("a", 1, 5.0, 1.0).granted
        assert store.acquire_blocking("b", 30, 30.0, 2.0).granted
        assert store.window_acquire_blocking("w", 3, 3.0, 1.0).granted
        assert store.sync_counter_blocking("g", 0.0, 1.0).global_score == \
            pytest.approx(6.0, abs=0.05)


class TestMeshPeekReadOnly:
    def test_peek_never_allocates(self, store):
        assert store.peek_blocking("ghost", 5.0, 1.0) == 5.0
        assert "ghost" not in store._sharded(5.0, 1.0).directory
        store.acquire_blocking("real", 2, 5.0, 1.0)
        assert store.peek_blocking("real", 5.0, 1.0) == 3.0
        assert store.peek_blocking("real", 5.0, 1.0) == 3.0


class TestMeshMetrics:
    def test_stats_cover_the_bucket_tiers(self, store):
        store.acquire_blocking("k", 1, 10.0, 1.0)
        store.window_acquire_blocking("w", 1, 5.0, 1.0)
        snap = store.metrics.snapshot()
        assert snap["launches"] >= 2
        assert any(k.startswith("bucket[") for k in snap["tiers"])
        assert any(k.startswith("window[") for k in snap["tiers"])
        # The latency histograms the server reads are the aux store's.
        assert store.metrics.flush_latency is store._aux.metrics.flush_latency

    def test_tiers_match_jax_mesh_store(self):
        jstore = JMesh(jcreate_mesh(S), per_shard_slots=32, clock=JClock(),
                       max_batch=64)
        pstore = MeshBucketStore(mesh8(), per_shard_slots=32,
                                 clock=ManualClock(), max_batch=64)
        for s in (jstore, pstore):
            s.acquire_blocking("k", 1, 10.0, 1.0)
            s.acquire_many_blocking([f"m{i}" for i in range(30)], [1] * 30,
                                    10.0, 1.0)
            s.window_acquire_blocking("w", 1, 5.0, 1.0)
        j, p = jstore.metrics.snapshot(), pstore.metrics.snapshot()
        assert sorted(j["tiers"]) == sorted(p["tiers"])
        for name in j["tiers"]:
            assert p["tiers"][name]["rows_valid"] == \
                j["tiers"][name]["rows_valid"]


class TestAuxOnlyRebase:
    def test_window_only_workload_still_rebases(self):
        clock = ManualClock(start_ticks=2**30 - 2048)
        store = MeshBucketStore(mesh8(), per_shard_slots=32, clock=clock,
                                max_batch=64)
        store.window_acquire_blocking("w", 3, 3.0, 1.0)
        clock.advance_seconds(4.0)
        store.window_acquire_blocking("w", 1, 3.0, 1.0)
        assert clock.now_ticks() < 2**30
        assert store.window_acquire_blocking("w", 2, 3.0, 1.0).granted


class TestFpDirectoryMesh:
    def test_mesh_store_with_fp_directory(self):
        from distributedratelimiting.redis_tpu_torch.parallel.fp_sharded \
            import ShardedFpDeviceStore, ShardedFpWindowStore

        async def main():
            clock = ManualClock()
            store = MeshBucketStore(mesh8(), per_shard_slots=256, clock=clock,
                                    directory="fp")
            got = [(await store.acquire("k", 1, 3.0, 1.0)).granted
                   for _ in range(5)]
            assert got == [True] * 3 + [False] * 2
            clock.advance_seconds(2.0)
            assert (await store.acquire("k", 2, 3.0, 1.0)).granted
            assert isinstance(store._shards[(3.0, 1.0)],
                              ShardedFpDeviceStore)
            res = await store.acquire_many([f"b{i}" for i in range(64)],
                                           [1] * 64, 5.0, 1.0)
            assert res.granted.all()
            assert (await store.window_acquire("w", 2, 3.0, 10.0)).granted
            assert not (await store.window_acquire("w", 2, 3.0, 10.0)).granted
            assert any(isinstance(w, ShardedFpWindowStore)
                       for w in store._windows.values())
            assert store.peek_blocking("ghost", 9.0, 1.0) == 9.0
            r = await store.sync_counter("c", 5.0, 0.0)
            assert r.global_score == pytest.approx(5.0)
            snap = store.snapshot()
            fresh = MeshBucketStore(mesh8(), per_shard_slots=256,
                                    clock=ManualClock(), directory="fp")
            fresh.restore(snap)
            assert not (await fresh.acquire("k", 3, 3.0, 1.0)).granted
            await store.aclose()
            await fresh.aclose()

        run(main())

    def test_bad_directory_rejected(self):
        with pytest.raises(ValueError, match="directory"):
            MeshBucketStore(mesh8(), directory="cuckoo")


class TestSyncCadencePlumbing:
    def test_option_reaches_sharded_tiers(self):
        async def main():
            store = MeshBucketStore(mesh8(), per_shard_slots=32,
                                    clock=ManualClock(),
                                    sync_cadence="launch")
            await store.connect()
            assert (await store.acquire("k", 1, 5.0, 1.0)).granted
            assert store._shards[(5.0, 1.0)].sync_cadence == "launch"
            res = await store.acquire_many([f"b{i}" for i in range(64)],
                                           [1] * 64, 9.0, 1.0)
            assert res.granted.all()
            assert store._shards[(9.0, 1.0)].sync_cadence == "launch"
            await store.aclose()

        run(main())

    def test_invalid_cadence_rejected(self):
        with pytest.raises(ValueError, match="sync_cadence"):
            MeshBucketStore(mesh8(), sync_cadence="yearly")


class TestMeshAuxCardinality:
    def test_counters_and_semas_grow_past_16k_keys(self):
        store = MeshBucketStore(mesh8(), per_shard_slots=16,
                                clock=ManualClock())
        n = 17_000
        for i in range(n):
            assert store.sync_counter_blocking(f"c{i}", 1.0,
                                               0.5).global_score >= 1.0
        assert store._aux._counters.value.shape[0] > 16384
        for i in range(n):
            assert store.concurrency_acquire_blocking(f"s{i}", 1, 2).granted
        assert store._aux._semas.active.shape[0] > 16384
        assert store.concurrency_acquire_blocking("s0", 1, 2).granted
        assert not store.concurrency_acquire_blocking("s0", 1, 2).granted
        assert store.sync_counter_blocking("c0", 0.0, 0.5).global_score > 0


class TestUndefinedMethods:
    def test_answers_as_jax_mesh_store(self, store):
        """What JAX's mesh store leaves to the ``BucketStore`` defaults
        answers the same way here."""
        jstore = JMesh(jcreate_mesh(S), per_shard_slots=32, clock=JClock())
        for s in (store, jstore):
            with pytest.raises(NotImplementedError, match="debit_many"):
                run(s.debit_many(["k"], [1.0], 5.0, 1.0))
        assert run(store.sync_counters_many(["a", "a", "b"], [1.0, 2.0, 3.0],
                                            0.0))[0].tolist() == \
            run(jstore.sync_counters_many(["a", "a", "b"], [1.0, 2.0, 3.0],
                                          0.0))[0].tolist()


# -- a seeded differential against JAX's MeshBucketStore -------------------------
@pytest.mark.parametrize("directory", ["host", "fp"])
@pytest.mark.parametrize("cadence", ["batch", "launch"])
def test_mesh_store_matches_jax(directory, cadence):
    rng = np.random.default_rng(5 + (directory == "fp") + 2 * (
        cadence == "launch"))
    jc, pc = JClock(start_ticks=7_000), ManualClock(start_ticks=7_000)
    kw = dict(per_shard_slots=32, max_batch=64, directory=directory,
              sync_cadence=cadence)
    jstore = JMesh(jcreate_mesh(S), clock=jc, **kw)
    pstore = MeshBucketStore(mesh8(), clock=pc, **kw)
    keys = [f"u{i}" for i in range(60)]
    wtol = 1.5 * float(np.spacing(np.float32(6.0)))
    for step in range(12):
        d = int(rng.integers(0, 1500))
        jc.advance_ticks(d)
        pc.advance_ticks(d)
        m = int(rng.integers(1, 40))
        ks = [keys[i] for i in rng.integers(0, len(keys), m)]
        cs = [int(c) for c in rng.integers(0, 4, m)]
        op = step % 6
        if op == 0:
            got = [pstore.acquire_blocking(k, c, 8.0, 2.0)
                   for k, c in zip(ks[:6], cs)]
            want = [jstore.acquire_blocking(k, c, 8.0, 2.0)
                    for k, c in zip(ks[:6], cs)]
            assert got == want
        elif op == 1:
            a = pstore.acquire_many_blocking(ks, cs, 8.0, 2.0)
            b = jstore.acquire_many_blocking(ks, cs, 8.0, 2.0)
            np.testing.assert_array_equal(a.granted, b.granted)
            np.testing.assert_allclose(a.remaining, b.remaining, rtol=1e-6)
        elif op in (2, 3):
            fixed = op == 3
            a = pstore.window_acquire_many_blocking(ks, cs, 6.0, 1.0,
                                                    fixed=fixed)
            b = jstore.window_acquire_many_blocking(ks, cs, 6.0, 1.0,
                                                    fixed=fixed)
            np.testing.assert_array_equal(a.granted, b.granted)
            np.testing.assert_allclose(a.remaining, b.remaining, atol=wtol)
        elif op == 4:
            for k, c in zip(ks[:5], cs):
                assert pstore.sync_counter_blocking(k, float(c), 0.5) == \
                    pytest.approx(jstore.sync_counter_blocking(
                        k, float(c), 0.5), rel=1e-6)
                assert pstore.concurrency_acquire_blocking(k, 1, 2) == \
                    jstore.concurrency_acquire_blocking(k, 1, 2)
        else:
            pstore.sweep_all()
            jstore.sweep_all()
        for k in ks[:4] + ["never"]:
            assert pstore.peek_blocking(k, 8.0, 2.0) == \
                jstore.peek_blocking(k, 8.0, 2.0)
        assert abs(pstore._sharded(8.0, 2.0).global_score
                   - jstore._sharded(8.0, 2.0).global_score) <= 1e-3
    # Each package's snapshot restores into the other's fresh store.
    jnew = JMesh(jcreate_mesh(S), clock=JClock(start_ticks=pc.now_ticks()),
                 **kw)
    pnew = MeshBucketStore(mesh8(), clock=ManualClock(
        start_ticks=jc.now_ticks()), **kw)
    jnew.restore(pstore.snapshot())
    pnew.restore(jstore.snapshot())
    for k in keys:
        assert pnew.peek_blocking(k, 8.0, 2.0) == jnew.peek_blocking(
            k, 8.0, 2.0) == pstore.peek_blocking(k, 8.0, 2.0)
    a = pnew.window_acquire_many_blocking(keys, [1] * 60, 6.0, 1.0)
    b = jnew.window_acquire_many_blocking(keys, [1] * 60, 6.0, 1.0)
    np.testing.assert_array_equal(a.granted, b.granted)


# -- the console server --------------------------------------------------------------
def _console(*args):
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

    threading.Thread(target=pump, daemon=True).start()
    return proc


def _stderr(proc) -> str:
    proc.err_file.seek(0)
    return proc.err_file.read()


def test_console_serves_the_mesh_backend():
    proc = _console("--backend", "mesh", "--sync-cadence", "launch",
                    "--device", "cpu", "--slots", "256")
    try:
        line = proc.lines.get(timeout=LIMIT_S)
        assert line and line.startswith("bucket-store server listening on "), (
            line, _stderr(proc))
        host, port = line.rsplit(" ", 1)[1].strip().rsplit(":", 1)

        async def main():
            cli = RemoteBucketStore(address=(host, int(port)))
            try:
                res = await cli.acquire_many([f"c{i}" for i in range(100)],
                                             [2] * 100, 5.0, 1e-6)
                assert res.granted.all()
                r = await asyncio.gather(*(cli.acquire("hot", 1, 3.0, 1e-6)
                                           for _ in range(8)))
                assert sum(x.granted for x in r) == 3
                stats = await cli.stats()
                tiers = stats["store"]["tiers"]
                assert tiers["bucket[cap=5.0,rate=1e-06]"]["rows_valid"] == 100
            finally:
                await cli.aclose()

        run(main())
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, _stderr(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.err_file.close()


def test_console_mesh_backend_needs_a_card_by_default():
    """Without ``--device cpu`` the mesh is every visible card: on a host
    with none the server exits with the mesh's error."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    proc = _console("--backend", "mesh")
    try:
        assert proc.wait(timeout=LIMIT_S) != 0
        assert "only 0 present" in _stderr(proc)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.err_file.close()
