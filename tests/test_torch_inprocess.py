"""The port's ``InProcessBucketStore`` against the JAX package's.

Both serial stores do the same Python float arithmetic, so the tolerance is
0: one seeded op stream (numpy rng) runs on each store, each on a
ManualClock of its own, and every field of every result — and the
snapshot after the stream — must be equal. The streams mix the scalar and
bulk token-bucket paths (direct and through a subclass that overrides
``acquire``), sliding and fixed windows, peeks, the saturating debit, the
two-level core, counter syncs, semaphores, ``import_entries``' conservative
merge, snapshot/restore across a clock shift, dirty accounting, and
reserve/settle through each store's ledger.
"""

import asyncio

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    InProcessBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.runtime import store as pstore

KEYS = [f"k{i}" for i in range(7)]
TENANTS = [f"t{i}" for i in range(3)]
BUCKETS = [(10.0, 2.0), (5.0, 0.5), (7.0, 1.3)]
WINDOWS = [(6.0, 1.0), (4.0, 0.5)]
HIER = ((20.0, 3.0), (10.0, 2.0))  # (tenant cfg, key cfg)
DECAYS = [2.0, 0.7]


def _ops(seed: int, n: int = 400) -> list[tuple]:
    """A seeded op stream, the same for both packages."""
    rng = np.random.default_rng(seed)

    def key():
        return KEYS[int(rng.integers(0, len(KEYS)))]

    def keys(m):
        return [key() for _ in range(m)]

    ops: list[tuple] = []
    rid = 0
    reserved: list[tuple] = []
    for _ in range(n):
        r = int(rng.integers(0, 22))
        b = BUCKETS[int(rng.integers(0, len(BUCKETS)))]
        wcfg = WINDOWS[int(rng.integers(0, len(WINDOWS)))]
        fixed = bool(rng.random() < 0.5)
        m = int(rng.integers(1, 12))
        if r == 0:
            ops.append(("acquire", key(), int(rng.integers(0, 5)), *b))
        elif r == 1:
            ops.append(("acquire_blocking", key(), int(rng.integers(0, 5)),
                        *b))
        elif r == 2:
            ops.append(("acquire_many", keys(m),
                        [int(c) for c in rng.integers(0, 4, m)], *b,
                        bool(rng.random() < 0.7)))
        elif r == 3:
            ops.append(("acquire_many_blocking", keys(m),
                        [int(c) for c in rng.integers(0, 4, m)], *b, True))
        elif r == 4:
            ops.append(("window", key(), int(rng.integers(0, 4)), *wcfg,
                        fixed, bool(rng.random() < 0.5)))
        elif r == 5:
            ops.append(("window_many", keys(m),
                        [int(c) for c in rng.integers(0, 3, m)], *wcfg,
                        fixed, bool(rng.random() < 0.7)))
        elif r == 6:
            ops.append(("peek", key(), *b))
        elif r == 7:
            ks = list(dict.fromkeys(keys(m)))  # pre-aggregated per key
            ops.append(("debit", ks,
                        [float(a) for a in rng.integers(-3, 9, len(ks))
                         * 0.5], *b))
        elif r == 8:
            ops.append(("hier", TENANTS[int(rng.integers(0, 3))], key(),
                        int(rng.integers(0, 6)), bool(rng.random() < 0.5)))
        elif r == 9:
            ops.append(("hier_many",
                        [TENANTS[int(t)] for t in rng.integers(0, 3, m)],
                        keys(m), [int(c) for c in rng.integers(0, 5, m)],
                        bool(rng.random() < 0.5)))
        elif r == 10:
            ops.append(("sync", key(), float(rng.integers(0, 20)),
                        DECAYS[int(rng.integers(0, 2))],
                        bool(rng.random() < 0.5)))
        elif r == 11:
            ops.append(("sync_many", keys(m),
                        [float(c) for c in rng.integers(0, 9, m)],
                        DECAYS[int(rng.integers(0, 2))]))
        elif r == 12:
            ops.append(("sema_acquire", key(), int(rng.integers(0, 3)), 4,
                        bool(rng.random() < 0.5)))
        elif r == 13:
            ops.append(("sema_release", key(), int(rng.integers(1, 3)),
                        bool(rng.random() < 0.5)))
        elif r == 14:
            ops.append(("sema_many", keys(m),
                        [int(d) for d in rng.integers(-2, 3, m)],
                        [int(x) for x in rng.integers(1, 5, m)]))
        elif r == 15:
            ops.append(("import", {
                "buckets": [(key(), *b, float(rng.integers(0, 10)),
                             int(rng.integers(0, 3000)))],
                "windows": [(key(), wcfg[0], int(wcfg[1] * 1024),
                             not fixed, float(rng.integers(0, 3)),
                             float(rng.integers(0, 3)),
                             int(rng.integers(0, 3)))],
                "counters": [(key(), float(rng.integers(0, 30)),
                              float(rng.integers(0, 500)),
                              int(rng.integers(0, 2000)))],
                "semas": [(key(), int(rng.integers(0, 4)))]}))
        elif r == 16:
            ops.append(("restore", int(rng.integers(-4000, 90_000))))
        elif r == 17:
            ops.append(("dirty", bool(rng.random() < 0.3)))
        elif r == 18:
            rid += 1
            est = (None if rng.random() < 0.3
                   else float(rng.integers(1, 8)))
            t = TENANTS[int(rng.integers(0, 3))]
            ops.append(("reserve", f"r{rid}", t, key(), est))
            reserved.append((f"r{rid}", t))
        elif r == 19 and reserved:
            rr, t = reserved.pop(int(rng.integers(0, len(reserved))))
            ops.append(("settle", rr, t, float(rng.integers(0, 10))))
        elif r == 20:
            ops.append(("ledger_time", float(rng.random() * 40)))
        ops.append(("advance", int(rng.integers(0, 3))
                    * int(rng.integers(1, 900))))
    return ops


def _bulk(res) -> tuple:
    return (np.asarray(res.granted).tolist(),
            None if res.remaining is None
            else np.asarray(res.remaining).tolist())


async def _run(store, clock_cls, ops: list[tuple]) -> tuple[list, dict]:
    """Apply ``ops`` to ``store``; returns every op's normalised result and
    the final snapshot. ``restore`` moves the state into a new store of the
    same class on a clock shifted from the old one."""
    ledger_t = [0.0]
    store.reservation_ledger(clock=lambda: ledger_t[0])
    out: list = []
    for op in ops:
        kind, *a = op
        s = store
        if kind == "acquire":
            r = await s.acquire(*a)
        elif kind == "acquire_blocking":
            r = s.acquire_blocking(*a)
        elif kind == "acquire_many":
            r = _bulk(await s.acquire_many(*a[:4], with_remaining=a[4]))
        elif kind == "acquire_many_blocking":
            r = _bulk(s.acquire_many_blocking(*a[:4], with_remaining=a[4]))
        elif kind == "window":
            k, c, lim, ws, fixed, blocking = a
            if blocking:
                fn = (s.fixed_window_acquire_blocking if fixed
                      else s.window_acquire_blocking)
                r = fn(k, c, lim, ws)
            else:
                fn = s.fixed_window_acquire if fixed else s.window_acquire
                r = await fn(k, c, lim, ws)
        elif kind == "window_many":
            r = _bulk(await s.window_acquire_many(
                *a[:4], fixed=a[4], with_remaining=a[5]))
        elif kind == "peek":
            r = s.peek_blocking(*a)
        elif kind == "debit":
            rem, short = await s.debit_many(*a)
            r = (rem.tolist(), short.tolist())
        elif kind == "hier":
            t, k, c, blocking = a
            args = (t, k, c, *HIER[0], *HIER[1])
            r = (s.acquire_hierarchical_blocking(*args) if blocking
                 else await s.acquire_hierarchical(*args))
        elif kind == "hier_many":
            ts, ks, cs, blocking = a
            args = (ts, ks, cs, *HIER[0], *HIER[1])
            r = _bulk(s.acquire_hierarchical_many_blocking(*args)
                      if blocking else
                      await s.acquire_hierarchical_many(*args))
        elif kind == "sync":
            k, local, decay, blocking = a
            r = (s.sync_counter_blocking(k, local, decay) if blocking
                 else await s.sync_counter(k, local, decay))
        elif kind == "sync_many":
            v, p = await s.sync_counters_many(*a)
            r = (v.tolist(), p.tolist())
        elif kind == "sema_acquire":
            k, c, lim, blocking = a
            r = (s.concurrency_acquire_blocking(k, c, lim) if blocking
                 else await s.concurrency_acquire(k, c, lim))
        elif kind == "sema_release":
            k, c, blocking = a
            r = (s.concurrency_release_blocking(k, c) if blocking
                 else await s.concurrency_release(k, c))
        elif kind == "sema_many":
            r = _bulk(await s.concurrency_acquire_many(*a))
        elif kind == "import":
            r = await s.import_entries(a[0])
        elif kind == "restore":
            snap = s.snapshot()
            clock = clock_cls(max(0, s.clock.now_ticks() + a[0]))
            store = type(s)(clock=clock)
            led = s.reservation_ledger()
            store._reservations = led  # the ledger is the server's state
            led._store = store
            if s._dirty is not None:
                store.enable_dirty_tracking()
            store.restore(snap)
            r = store.snapshot()
        elif kind == "dirty":
            if s._dirty is None:
                s.enable_dirty_tracking()
            r = s.dirty_stats()
            if a[0]:
                s.mark_snapshot_base()
        elif kind == "reserve":
            rid, t, k, est = a
            r = tuple(await s.reserve(rid, t, k, est, *HIER[0], *HIER[1]))
        elif kind == "settle":
            r = tuple(await s.settle(*a))
        elif kind == "ledger_time":
            ledger_t[0] += a[0]
            r = None
        elif kind == "advance":
            s.clock.advance_ticks(a[0])
            r = s.clock.now_ticks()
        else:  # pragma: no cover — the generator's kinds only
            raise AssertionError(kind)
        if isinstance(r, tuple) and hasattr(r, "_fields"):
            r = tuple(r)
        out.append((kind, r))
    return out, store.snapshot()


class _Intercepting:
    """A subclass overriding ``acquire`` — the bulk path must then await it
    per key (the 'direct' test names the port's class)."""
    seen = 0

    async def acquire(self, key, count, capacity, fill_rate_per_sec):
        type(self).seen += 1
        return await super().acquire(key, count, capacity, fill_rate_per_sec)


class PortIntercepting(_Intercepting, InProcessBucketStore):
    pass


class JaxIntercepting(_Intercepting, JStore):
    pass


@pytest.mark.parametrize("seed", range(6))
def test_op_streams_equal_the_jax_serial_store(seed):
    ops = _ops(seed)
    start = int(np.random.default_rng(seed + 100).integers(0, 50_000))
    got = asyncio.run(_run(InProcessBucketStore(clock=ManualClock(start)),
                           ManualClock, ops))
    want = asyncio.run(_run(JStore(clock=JClock(start)), JClock, ops))
    for i, (g, w_) in enumerate(zip(got[0], want[0])):
        assert g == w_, f"seed={seed} op {i} {ops[i][:3]}"
    assert got[1] == want[1]
    kinds = {k for k, _ in got[0]}
    assert {"acquire_many", "restore", "import", "reserve",
            "dirty"} <= kinds


@pytest.mark.parametrize("seed", [7, 8])
def test_an_overriding_subclass_sees_every_bulk_key(seed):
    ops = [op for op in _ops(seed, 200)
           if op[0] in ("acquire_many", "acquire", "advance")]
    PortIntercepting.seen = JaxIntercepting.seen = 0
    got = asyncio.run(_run(PortIntercepting(clock=ManualClock()),
                           ManualClock, ops))
    want = asyncio.run(_run(JaxIntercepting(clock=JClock()), JClock, ops))
    assert got == want
    n_bulk_keys = sum(len(op[1]) for op in ops if op[0] == "acquire_many")
    n_scalar = sum(op[0] == "acquire" for op in ops)
    assert PortIntercepting.seen == JaxIntercepting.seen \
        == n_bulk_keys + n_scalar
    assert InProcessBucketStore.acquire is pstore.InProcessBucketStore.acquire


def test_restore_normalises_three_tuple_window_keys_and_shifts():
    """A snapshot from before the fixed window carries 3-tuple window keys
    (sliding); both packages normalise them to the 4-tuple and shift the
    stored timestamps and window indices by the clock epoch."""
    snap = {"now_ticks": 5000,
            "buckets": {("a", 10.0, 2.0): (3.5, 4000)},
            "counters": {"c": (7.0, 120.0, 4500)},
            "windows": {("w", 6.0, 1024): (2.0, 1.0, 4),
                        ("f", 4.0, 512, False): (0.0, 3.0, 9)},
            "semas": {"s": 2}}
    for shift in (-3000, 0, 70_000):
        port = InProcessBucketStore(clock=ManualClock(5000 + shift))
        jax_ = JStore(clock=JClock(5000 + shift))
        port.restore(snap)
        jax_.restore(snap)
        assert port.snapshot() == jax_.snapshot()
        assert ("w", 6.0, 1024, True) in port.snapshot()["windows"]
        assert port.snapshot()["buckets"][("a", 10.0, 2.0)] == (
            3.5, 4000 + shift)
    # A snapshot without now_ticks restores as same-process.
    old = {k: v for k, v in snap.items() if k != "now_ticks"}
    port = InProcessBucketStore(clock=ManualClock(99))
    port.restore(old)
    assert port.snapshot()["counters"]["c"] == (7.0, 120.0, 4500)


def test_dirty_stats_count_every_written_entry():
    st = InProcessBucketStore(clock=ManualClock())
    assert st.dirty_stats() == {"dirty": 0, "total": 0}
    st.enable_dirty_tracking()
    st.acquire_blocking("a", 1, 5.0, 1.0)
    st.acquire_many_blocking(["a", "b", "c"], [1, 1, 1], 5.0, 1.0)
    st.window_acquire_blocking("w", 1, 4.0, 1.0)
    st.sync_counter_blocking("c", 1.0, 1.0)
    st.concurrency_acquire_blocking("s", 1, 3)
    st.concurrency_acquire_blocking("probe", 0, 3)  # a probe writes nothing
    assert st.dirty_stats() == {"dirty": 6, "total": 6}
    st.mark_snapshot_base()
    assert st.dirty_stats() == {"dirty": 0, "total": 6}
    st.peek_blocking("a", 5.0, 1.0)  # a read is not a write
    st.concurrency_release_blocking("unknown", 1)
    assert st.dirty_stats()["dirty"] == 0
    st.acquire_blocking("d", 1, 5.0, 1.0)
    assert st.dirty_stats() == {"dirty": 1, "total": 7}


def test_import_entries_merges_conservatively():
    st = InProcessBucketStore(clock=ManualClock(10_000))
    st.acquire_blocking("a", 4, 10.0, 1.0)           # 6 tokens left
    st.window_acquire_blocking("w", 2, 6.0, 1.0)     # idx 9, curr 2
    st.sync_counter_blocking("c", 5.0, 1.0)
    st.concurrency_acquire_blocking("s", 2, 4)
    entries = {"buckets": [("a", 10.0, 1.0, 8.0, 0), ("b", 10.0, 1.0, 3.0, 0)],
               "windows": [("w", 6.0, 1024, True, 1.0, 5.0, 0)],
               "counters": [("c", 2.0, 9.0, 0)],
               "semas": [("s", 1)]}
    assert asyncio.run(st.import_entries(entries)) == 5
    snap = st.snapshot()
    assert snap["buckets"][("a", 10.0, 1.0)][0] == 6.0   # the smaller
    assert snap["buckets"][("b", 10.0, 1.0)][0] == 3.0
    assert snap["windows"][("w", 6.0, 1024, True)] == (1.0, 6.0, 9)  # clamp
    assert snap["counters"]["c"][0] == 5.0               # the larger
    assert snap["semas"]["s"] == 2
