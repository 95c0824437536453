"""The port's incremental checkpoints: the v4 delta chain and dirty tracking.

The JAX package's chain cases (``tests/test_checkpoint.py``) on the port's
``SnapshotChain`` / ``load_snapshot_chain`` over the port's stores (the
serial ``InProcessBucketStore``, and ``DeviceBucketStore(device="cpu")`` for
the sparse-delta size bar), then chains that cross packages both ways —
the JAX package writes a base and deltas and the port loads them, and the
reverse — for the serial and the device stores, with the restored snapshot
equal array for array and key for key. Dirty tracking is held to the slots
each launch resolved.
"""

import asyncio
import os
import pickle

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.runtime import checkpoint as jcp
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JDevice,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JInProcess,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    InProcessBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.runtime import checkpoint as cp
from distributedratelimiting.redis_tpu_torch.runtime.checkpoint import (
    PlacementMismatchError,
    SnapshotChain,
    SnapshotChainError,
    SnapshotCorruptError,
    load_snapshot_chain,
    save_snapshot,
)


def _chain_store(clock, n=0):
    s = InProcessBucketStore(clock=clock)
    for i in range(n):
        s.acquire_blocking(f"k{i}", 1, 100.0, 0.0)
    return s


def _device(clock, n_slots=64, max_batch=64):
    return DeviceBucketStore(n_slots=n_slots, counter_slots=8, clock=clock,
                             max_batch=max_batch, device="cpu")


def _jdevice(clock, n_slots=64, max_batch=64):
    return JDevice(n_slots=n_slots, counter_slots=8, clock=clock,
                   max_batch=max_batch)


def assert_snap_equal(a, b, where="snapshot"):
    """Two snapshots equal key for key, arrays in dtype and value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (
            where, set(a) ^ set(b) if isinstance(b, dict) else type(b))
        for k in a:
            assert_snap_equal(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b and type(a) is type(b), (where, a, b)


# -- the JAX chain cases, on the port -----------------------------------------

def test_chain_roundtrip_preserves_decisions(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 8)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    assert chain.save(s) == path  # first save is the base
    s.acquire_blocking("k0", 50, 100.0, 0.0)
    p1 = chain.save(s)
    assert p1 == path + ".delta.1"
    s.acquire_blocking("k1", 99, 100.0, 0.0)
    assert chain.save(s) == path + ".delta.2"

    s2 = InProcessBucketStore(clock=clock)
    assert load_snapshot_chain(s2, path) == 2
    # exact balances survive base + 2 deltas
    assert s2.peek_blocking("k0", 100.0, 0.0) == 49.0
    assert s2.peek_blocking("k1", 100.0, 0.0) == 0.0
    assert s2.peek_blocking("k7", 100.0, 0.0) == 99.0
    assert chain.stats() == {"chain_len": 2, "full_saves": 1,
                             "delta_saves": 2,
                             "last_delta_bytes": chain.last_delta_bytes,
                             "base_bytes": chain.stats()["base_bytes"]}
    assert 0 < chain.last_delta_bytes < chain.stats()["base_bytes"]


def test_chain_loader_without_deltas_is_plain_load(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 3)
    path = str(tmp_path / "snap.bin")
    save_snapshot(s, path)
    s2 = InProcessBucketStore(clock=clock)
    assert load_snapshot_chain(s2, path) == 0
    assert s2.peek_blocking("k1", 100.0, 0.0) == 99.0


def test_sparse_delta_is_10x_smaller_than_full(tmp_path):
    """A table with <1% dirty slots checkpoints >= 10x smaller
    incrementally than the full v3 snapshot, on the device store, whose slot
    arrays are what full saves re-serialize every time."""
    clock = ManualClock()
    dev = _device(clock, n_slots=4096, max_batch=256)
    keys = [f"k{i}" for i in range(2000)]
    dev.acquire_many_blocking(keys, [1] * len(keys), 100.0, 0.0)
    dev.enable_dirty_tracking()
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path)
    chain.save(dev)
    base_size = os.path.getsize(path)
    # touch <1% of the table
    dirty = [f"k{i}" for i in range(10)]
    dev.acquire_many_blocking(dirty, [5] * len(dirty), 100.0, 0.0)
    stats = dev.dirty_stats()
    assert stats == {"dirty": 10, "total": 4096}  # the touched slots
    p1 = chain.save(dev)
    delta_size = os.path.getsize(p1)
    assert delta_size * 10 <= base_size, (delta_size, base_size)

    dev2 = _device(clock, n_slots=4096, max_batch=256)
    assert load_snapshot_chain(dev2, path) == 1
    assert dev2.peek_blocking("k3", 100.0, 0.0) == 94.0
    assert dev2.peek_blocking("k100", 100.0, 0.0) == 99.0
    assert_snap_equal(dev2.snapshot(), dev.snapshot())


def test_chain_truncated_delta_raises_typed(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s)
    s.acquire_blocking("k0", 9, 100.0, 0.0)
    p1 = chain.save(s)
    data = open(p1, "rb").read()
    with open(p1, "wb") as f:
        f.write(data[: len(data) // 2])
    with pytest.raises(SnapshotChainError):
        load_snapshot_chain(InProcessBucketStore(), path)
    assert issubclass(SnapshotChainError, SnapshotCorruptError)


def test_chain_missing_base_raises_typed(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s)
    s.acquire_blocking("k0", 9, 100.0, 0.0)
    chain.save(s)
    os.unlink(path)  # the base vanishes; the deltas dangle
    with pytest.raises(SnapshotChainError, match="missing"):
        load_snapshot_chain(InProcessBucketStore(), path)
    for q in os.listdir(tmp_path):
        os.unlink(tmp_path / q)
    with pytest.raises(FileNotFoundError):  # no chain at all: plain OSError
        load_snapshot_chain(InProcessBucketStore(), path)


def test_chain_foreign_base_refused(tmp_path):
    """Stale deltas beside a base they do not belong to must not replay —
    base_crc is the chain's identity."""
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s)
    s.acquire_blocking("k0", 9, 100.0, 0.0)
    chain.save(s)
    # an operator copies in a different base file, bypassing the save
    # lanes (which would have retired the chain)
    s.acquire_blocking("k1", 5, 100.0, 0.0)
    other = str(tmp_path / "other.bin")
    save_snapshot(s, other)
    os.replace(other, path)
    with pytest.raises(SnapshotChainError, match="different base"):
        load_snapshot_chain(InProcessBucketStore(), path)


def test_plain_full_save_retires_the_chain(tmp_path):
    """A full save_snapshot over a chained path removes the .delta.* links,
    so the next chain-aware load takes the new base alone."""
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s)
    s.acquire_blocking("k0", 9, 100.0, 0.0)
    chain.save(s)
    s.acquire_blocking("k1", 5, 100.0, 0.0)
    save_snapshot(s, path)  # plain full save, chain manager not used
    assert [q for q in os.listdir(tmp_path) if ".delta." in q] == []
    s2 = InProcessBucketStore(clock=clock)
    assert load_snapshot_chain(s2, path) == 0
    assert s2.peek_blocking("k1", 100.0, 0.0) == 94.0


def test_compaction_crash_window_keeps_old_base_loadable(tmp_path,
                                                         monkeypatch):
    """Compaction unlinks the old links BEFORE it replaces the base: a crash
    between the two restores the OLD base's save point, never nothing."""
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0, max_chain=1)
    chain.save(s)
    s.acquire_blocking("k0", 9, 100.0, 0.0)
    chain.save(s)
    s.acquire_blocking("k1", 5, 100.0, 0.0)

    def disk_gone(*a):
        raise OSError("disk gone")

    # crash INSIDE the compacting full save, after the old chain was
    # retired but before the new base lands
    with monkeypatch.context() as m:
        m.setattr(cp, "_atomic_write", disk_gone)
        with pytest.raises(OSError):
            chain.save(s)  # max_chain exceeded → compaction path
    s2 = InProcessBucketStore(clock=clock)
    assert load_snapshot_chain(s2, path) == 0
    assert s2.peek_blocking("k3", 100.0, 0.0) == 99.0


def test_chain_crc_bad_middle_link_raises_typed(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s)
    for i in range(3):
        s.acquire_blocking(f"k{i}", 3, 100.0, 0.0)
        chain.save(s)
    p2 = path + ".delta.2"
    data = bytearray(open(p2, "rb").read())
    data[len(data) * 3 // 4] ^= 0x10
    with open(p2, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(SnapshotChainError, match="checksum"):
        load_snapshot_chain(InProcessBucketStore(), path)


def test_chain_missing_middle_link_raises_typed(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s)
    for i in range(3):
        s.acquire_blocking(f"k{i}", 3, 100.0, 0.0)
        chain.save(s)
    os.unlink(path + ".delta.1")
    with pytest.raises(SnapshotChainError, match="missing link"):
        load_snapshot_chain(InProcessBucketStore(), path)


def test_chain_placement_epoch_mismatch_raises_typed(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s, placement_epoch=3)
    s.acquire_blocking("k0", 3, 100.0, 0.0)
    chain.save(s, placement_epoch=3)
    # matching epoch loads clean
    assert load_snapshot_chain(InProcessBucketStore(clock=clock), path,
                               expected_placement_epoch=3) == 1
    with pytest.raises(PlacementMismatchError):
        load_snapshot_chain(InProcessBucketStore(), path,
                            expected_placement_epoch=5)


def test_chain_epoch_change_compacts_to_fresh_base(tmp_path):
    """A chain is single-epoch: a save under a new placement epoch becomes a
    full base, not a mixed-epoch link."""
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=10.0)
    chain.save(s, placement_epoch=1)
    s.acquire_blocking("k0", 3, 100.0, 0.0)
    chain.save(s, placement_epoch=1)
    s.acquire_blocking("k1", 3, 100.0, 0.0)
    p = chain.save(s, placement_epoch=2)  # epoch moved → full save
    assert p == path
    assert [q for q in os.listdir(tmp_path) if ".delta." in q] == []
    assert load_snapshot_chain(InProcessBucketStore(clock=clock), path,
                               expected_placement_epoch=2) == 0


def test_chain_compacts_at_max_length(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, max_chain=2, compact_ratio=10.0)
    chain.save(s)
    for i in range(2):
        s.acquire_blocking(f"k{i}", 2, 100.0, 0.0)
        assert chain.save(s) == path + f".delta.{i + 1}"
    s.acquire_blocking("k2", 2, 100.0, 0.0)
    assert chain.save(s) == path  # chain full → compact to fresh base
    assert [q for q in os.listdir(tmp_path) if ".delta." in q] == []
    assert chain.stats()["full_saves"] == 2
    s2 = InProcessBucketStore(clock=clock)
    assert load_snapshot_chain(s2, path) == 0
    assert s2.peek_blocking("k2", 100.0, 0.0) == 97.0


def test_a_delta_past_the_compact_ratio_becomes_a_base(tmp_path):
    clock = ManualClock()
    s = _chain_store(clock, 4)
    path = str(tmp_path / "snap.bin")
    chain = SnapshotChain(path, compact_ratio=0.5)
    chain.save(s)
    for i in range(4):  # rewrite every entry: the delta is the whole state
        s.acquire_blocking(f"k{i}", 7, 100.0, 0.0)
    assert chain.save(s) == path
    assert chain.stats()["full_saves"] == 2
    assert chain.stats()["delta_saves"] == 0


def test_diff_and_apply_node_grammar():
    base = {"a": np.arange(6, dtype=np.int32), "d": {"x": 1, "y": 2},
            "s": "same", "gone": 1.5}
    curr = {"a": np.r_[np.arange(6, dtype=np.int32), [7, 8]].astype(np.int32),
            "d": {"x": 1, "z": 3}, "s": "same", "new": (1, "t")}
    curr["a"][2] = 9
    delta = cp.diff_snapshot(base, curr)
    assert delta["t"] == "dict" and sorted(delta["del"]) == ["gone"]
    node = delta["set"]["a"]
    assert node["t"] == "arr" and node["idx"].tolist() == [2, 6, 7]
    assert "s" not in delta["set"]
    assert_snap_equal(cp.apply_snapshot_delta(base, delta), curr)
    assert cp.diff_snapshot(curr, curr) == {}
    assert cp.apply_snapshot_delta(curr, {}) is curr
    with pytest.raises(SnapshotChainError):
        cp.apply_snapshot_delta({"a": 1}, {"t": "dict", "del": [],
                                           "set": {"a": {"t": "arr", "n": 1,
                                                         "idx": [0],
                                                         "val": [1]}}})


def test_the_diff_against_a_snapshot_copy_sees_every_change():
    """``to_snap`` copies each array: the chain keeps the previous snapshot
    as its diff base, and a view of the live tensor would make every later
    delta empty."""
    clock = ManualClock()
    dev = _device(clock)
    dev.acquire_blocking("a", 1, 10.0, 1.0)
    before = dev.snapshot()
    dev.acquire_blocking("a", 4, 10.0, 1.0)
    delta = cp.diff_snapshot(before, dev.snapshot())
    assert delta["set"]["tables"]["set"][(10.0, 1.0)]["set"]["tokens"]


# -- chains across packages ---------------------------------------------------

def _drive(store, clock, step: int) -> None:
    """One seeded round of traffic on either package's store."""
    rng = np.random.default_rng(step)
    keys = [f"k{int(i)}" for i in rng.integers(0, 40, 24)]
    store.acquire_many_blocking(keys, [int(c) for c in
                                       rng.integers(0, 3, 24)], 10.0, 2.0)
    store.window_acquire_many_blocking(keys[:8], [1] * 8, 6.0, 1.0,
                                       fixed=bool(step % 2))
    store.sync_counter_blocking(f"c{step % 3}", float(step), 1.0)
    store.concurrency_acquire_blocking(f"s{step % 4}", 1, 3)
    asyncio.run(store.debit_many(list(dict.fromkeys(keys))[:4],
                                 [1.0, 0.5, 2.0, -1.0][:len(
                                     list(dict.fromkeys(keys))[:4])],
                                 10.0, 2.0))
    clock.advance_ticks(300 + 17 * step)


KINDS = {
    "inprocess": (lambda c: InProcessBucketStore(clock=c),
                  lambda c: JInProcess(clock=c)),
    "device": (lambda c: _device(c), lambda c: _jdevice(c)),
}


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_chain_loads_into_the_other_package(tmp_path, kind, writer):
    """A base plus three deltas written by one package loads into the other
    package's store of the same kind: the restored snapshot equals the
    writer's, array for array and key for key, and the two stores then
    decide alike."""
    make_port, make_jax = KINDS[kind]
    start = 40_000
    path = str(tmp_path / "snap.bin")
    if writer == "port":
        clock = ManualClock(start)
        src, chain, load = (make_port(clock),
                                SnapshotChain(path, compact_ratio=10.0),
                            jcp.load_snapshot_chain)
        dst_clock = JClock(start)
        dst = make_jax(dst_clock)
    else:
        clock = JClock(start)
        src, chain, load = (make_jax(clock),
                                jcp.SnapshotChain(path, compact_ratio=10.0),
                            load_snapshot_chain)
        dst_clock = ManualClock(start)
        dst = make_port(dst_clock)
    for step in range(4):
        _drive(src, clock, step)
        chain.save(src)
    assert chain.stats()["delta_saves"] == 3
    dst_clock.advance_ticks(clock.now_ticks() - start)
    assert load(dst, path) == 3
    assert_snap_equal(dst.snapshot(), src.snapshot())
    # No class of either package rides a link: each unpickles from
    # builtins and numpy alone.
    for q in sorted(os.listdir(tmp_path)):
        with open(tmp_path / q, "rb") as f:
            payload = pickle.load(f)
        body = payload.get("delta_pickle", payload.get("snapshot_pickle"))
        assert b"distributedratelimiting" not in body
    a = src.acquire_many_blocking(["k1", "k2", "new"], [3, 9, 1], 10.0, 2.0)
    b = dst.acquire_many_blocking(["k1", "k2", "new"], [3, 9, 1], 10.0, 2.0)
    assert a.granted.tolist() == b.granted.tolist()
    np.testing.assert_allclose(a.remaining, b.remaining, atol=1e-4, rtol=0)


# -- dirty tracking on the device store ---------------------------------------

def test_dirty_tracking_counts_the_resolved_slots():
    clock = ManualClock()
    dev = _device(clock, n_slots=256)
    dev.acquire_blocking("early", 1, 10.0, 1.0)  # before tracking: not counted
    assert dev.dirty_stats() == {"dirty": 0, "total": 256}
    dev.enable_dirty_tracking()
    dev.acquire_many_blocking([f"k{i}" for i in range(40)] + ["k0"],
                              [1] * 41, 10.0, 1.0)
    dev.window_acquire_many_blocking(["w0", "w1"], [1, 1], 5.0, 1.0)
    asyncio.run(dev.acquire_hierarchical_many(["t0", "t0"], ["h0", "h1"],
                                              [1, 1], 50.0, 5.0, 10.0, 1.0))
    asyncio.run(dev.debit_many(["k1", "d0"], [1.0, 1.0], 10.0, 1.0))
    dev.sync_counter_blocking("c", 1.0, 1.0)            # counters: untracked
    dev.concurrency_acquire_blocking("s", 1, 2)         # semaphores: untracked
    dev.peek_blocking("k2", 10.0, 1.0)                  # a read resolves nothing
    # 40 keys + 2 window slots + 2 two-level keys + the tenant + 1 new debit
    # key (k1 already counted); tables made after arming are armed too (the
    # window table and the tenant's; the two-level keys share (10, 1)).
    assert dev.dirty_stats() == {"dirty": 46, "total": 256 * 3}
    dev.mark_snapshot_base()
    assert dev.dirty_stats()["dirty"] == 0
    asyncio.run(dev.acquire("k3", 1, 10.0, 1.0))        # the batcher's flush
    assert dev.dirty_stats()["dirty"] == 1
    clock.advance_seconds(86_400)
    dev.sweep_all()                                     # a sweep resolves none
    assert dev.dirty_stats()["dirty"] == 1
    asyncio.run(dev.aclose())


def test_dirty_tracking_is_off_by_default():
    dev = _device(ManualClock())
    dev.acquire_blocking("a", 1, 10.0, 1.0)
    assert all(t.dirty_slots is None for t in dev._tables.values())
    dev.mark_snapshot_base()  # a no-op while off
    assert dev.dirty_stats() == {"dirty": 0, "total": 64}
