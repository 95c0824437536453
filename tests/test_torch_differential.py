"""The JAX package's randomized differential tests on the port: the port's
``DeviceBucketStore(device="cpu")`` (the kernels' plain versions) against
the port's serial ``InProcessBucketStore``.

The serial store implements the reference semantics as straight-line Python
(one "script" per op). The device store must make IDENTICAL decisions on
any operation trace — random keys, counts, clock advances, bucket configs —
at the JAX suite's tolerances (grants equal, ``remaining`` within 1e-3,
counter syncs within 1e-4 relative) and with its seeds. Left out with the
modules they need: the fingerprint directory's arm of the bulk case (the
fingerprint store, ROADMAP Queue A 12) and the native bulk lane of the
weighted-cost parity case (the native front-end, Queue A 6).
"""

import functools

import numpy as np
import pytest

from distributedratelimiting.redis_tpu_torch.runtime import store as pstore
from distributedratelimiting.redis_tpu_torch.runtime.clock import ManualClock
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    InProcessBucketStore,
)

#: The store under test: the port's device store on the CPU.
DeviceBucketStore = functools.partial(pstore.DeviceBucketStore, device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_bucket_decisions_match_serial_reference(seed):
    rng = np.random.default_rng(seed)
    clock_a = ManualClock()
    clock_b = ManualClock()
    dev = DeviceBucketStore(n_slots=32, counter_slots=8, clock=clock_a,
                            max_batch=64)
    ref = InProcessBucketStore(clock=clock_b)
    configs = [(10.0, 2.0), (5.0, 0.5)]
    keys = [f"k{i}" for i in range(6)]

    for step in range(120):
        key = keys[rng.integers(0, len(keys))]
        count = int(rng.integers(0, 4))
        cap, rate = configs[rng.integers(0, len(configs))]
        a = dev.acquire_blocking(key, count, cap, rate)
        b = ref.acquire_blocking(key, count, cap, rate)
        assert a.granted == b.granted, (
            f"seed={seed} step={step} key={key} count={count} "
            f"cap={cap} rate={rate}: device={a} reference={b}"
        )
        assert a.remaining == pytest.approx(b.remaining, abs=1e-3)
        if rng.random() < 0.3:
            dt = float(rng.random() * 3.0)
            clock_a.advance_seconds(dt)
            clock_b.advance_seconds(dt)


@pytest.mark.parametrize("seed", [10, 11])
def test_window_decisions_match_serial_reference(seed):
    rng = np.random.default_rng(seed)
    clock_a = ManualClock()
    clock_b = ManualClock()
    dev = DeviceBucketStore(n_slots=32, counter_slots=8, clock=clock_a,
                            max_batch=64)
    ref = InProcessBucketStore(clock=clock_b)
    keys = [f"w{i}" for i in range(4)]

    for step in range(100):
        key = keys[rng.integers(0, len(keys))]
        count = int(rng.integers(1, 3))
        a = dev.window_acquire_blocking(key, count, 6.0, 1.0)
        b = ref.window_acquire_blocking(key, count, 6.0, 1.0)
        assert a.granted == b.granted, (
            f"seed={seed} step={step} key={key} count={count}: "
            f"device={a} reference={b}"
        )
        if rng.random() < 0.4:
            dt = float(rng.random() * 1.5)
            clock_a.advance_seconds(dt)
            clock_b.advance_seconds(dt)


@pytest.mark.parametrize("seed", [20, 21])
def test_counter_sync_matches_serial_reference(seed):
    rng = np.random.default_rng(seed)
    clock_a = ManualClock()
    clock_b = ManualClock()
    dev = DeviceBucketStore(n_slots=32, counter_slots=8, clock=clock_a,
                            max_batch=64)
    ref = InProcessBucketStore(clock=clock_b)

    for step in range(60):
        key = f"c{rng.integers(0, 3)}"
        local = float(rng.integers(0, 20))
        a = dev.sync_counter_blocking(key, local, 2.0)
        b = ref.sync_counter_blocking(key, local, 2.0)
        assert a.global_score == pytest.approx(b.global_score, rel=1e-4), (
            f"seed={seed} step={step} key={key} local={local}"
        )
        assert a.period_ewma_ticks == pytest.approx(
            b.period_ewma_ticks, rel=1e-4)
        dt = float(rng.random() * 2.0)
        clock_a.advance_seconds(dt)
        clock_b.advance_seconds(dt)


def test_batched_duplicates_match_serialized_singles():
    """One batch containing duplicates must decide exactly like the same
    requests arriving one-by-one (invariant 3 at batch granularity)."""
    import asyncio

    rng = np.random.default_rng(42)
    for trial in range(4):
        reqs = [(f"d{rng.integers(0, 3)}", int(rng.integers(1, 3)))
                for _ in range(12)]

        clock_a = ManualClock()
        dev = DeviceBucketStore(n_slots=16, counter_slots=8, clock=clock_a,
                                max_batch=16, max_delay_s=5e-3)

        async def batched():
            return await asyncio.gather(*(
                dev.acquire(k, c, 8.0, 1.0) for k, c in reqs
            ))

        batched_res = asyncio.run(batched())

        ref = InProcessBucketStore(clock=ManualClock())
        serial_res = [ref.acquire_blocking(k, c, 8.0, 1.0) for k, c in reqs]
        assert [r.granted for r in batched_res] == \
            [r.granted for r in serial_res], f"trial={trial} reqs={reqs}"


@pytest.mark.parametrize("seed", [20, 21])
@pytest.mark.parametrize("directory", ["host"])
def test_bulk_paths_match_serial_reference(seed, directory):
    """Differential fuzz of the BULK surfaces (buckets + sliding/fixed
    windows, grouped coalescing on), over the host key directory (the
    JAX suite's "fp" arm waits for the fingerprint store): duplicate-free
    random bulk calls must decide identically to a serial per-request
    replay. Time advances between calls exercise refill/rollover inside
    the bulk kernels; the randomized ``with_remaining`` flag exercises both
    result encodings (f32 and bit-packed verdicts), and ``remaining`` is
    asserted against the reference whenever present."""
    rng = np.random.default_rng(seed)
    clock_a = ManualClock()
    clock_b = ManualClock()
    cls = DeviceBucketStore
    dev = cls(n_slots=256, counter_slots=8, clock=clock_a,
              max_batch=16)  # forces multi-chunk dispatches
    ref = InProcessBucketStore(clock=clock_b)
    keys = [f"k{i}" for i in range(40)]

    for step in range(25):
        picked = rng.choice(len(keys), size=24, replace=False)
        sub = [keys[i] for i in picked]
        counts = [int(c) for c in rng.integers(0, 4, size=24)]
        family = step % 3
        wr = bool(rng.random() < 0.5)
        if family == 0:
            got = dev.acquire_many_blocking(sub, counts, 8.0, 2.0,
                                            with_remaining=wr)
            want = [ref.acquire_blocking(k, c, 8.0, 2.0)
                    for k, c in zip(sub, counts)]
        elif family == 1:
            got = dev.window_acquire_many_blocking(sub, counts, 6.0, 1.0,
                                                   with_remaining=wr)
            want = [ref.window_acquire_blocking(k, c, 6.0, 1.0)
                    for k, c in zip(sub, counts)]
        else:
            got = dev.window_acquire_many_blocking(sub, counts, 6.0, 1.0,
                                                   fixed=True,
                                                   with_remaining=wr)
            want = [ref.fixed_window_acquire_blocking(k, c, 6.0, 1.0)
                    for k, c in zip(sub, counts)]
        for i, (w, k, c) in enumerate(zip(want, sub, counts)):
            assert bool(got.granted[i]) == w.granted, (
                f"seed={seed} step={step} family={family} wr={wr} "
                f"dir={directory} key={k} count={c}: "
                f"device={bool(got.granted[i])} reference={w}")
            if wr:
                assert got.remaining[i] == pytest.approx(w.remaining,
                                                         abs=1e-3), (
                    f"seed={seed} step={step} family={family} "
                    f"dir={directory} key={k}: remaining "
                    f"{got.remaining[i]} != {w.remaining}")
        if rng.random() < 0.5:
            dt = float(rng.random() * 2.0)
            clock_a.advance_seconds(dt)
            clock_b.advance_seconds(dt)


@pytest.mark.parametrize("seed", [30, 31])
def test_bulk_duplicates_conserve_and_order(seed):
    """With in-call duplicates (Zipf-ish) and randomized N-token costs,
    the bulk paths must never over-admit a key beyond its
    capacity/limit IN TOKENS, and grants within one call land on the
    EARLIEST occurrences (request-order serialization), with random
    N-token costs (weighted-cost parity)."""
    rng = np.random.default_rng(seed)
    clock = ManualClock()
    dev = DeviceBucketStore(n_slots=64, counter_slots=8, clock=clock,
                            max_batch=16)
    cap = 9.0
    for step in range(10):
        n = 40
        # Uniform cost PER KEY each step (mixed per-key costs void the
        # order property across chunk boundaries: a denied big-cost
        # row's reservation dies with its launch, and a later cheap row
        # can legitimately fit the residue).
        cost_of = {f"h{i}": int(rng.integers(1, 4)) for i in range(6)}
        keys = [f"h{rng.zipf(1.3) % 6}" for _ in range(n)]
        counts = [cost_of[k] for k in keys]
        res = dev.acquire_many_blocking(keys, counts, cap, 0.0)
        granted_per: dict[str, int] = {}
        last_granted_rank: dict[str, int] = {}
        occurrence: dict[str, int] = {}
        for k, c, g in zip(keys, counts, res.granted):
            rank = occurrence.get(k, 0)
            occurrence[k] = rank + 1
            if g:
                granted_per[k] = granted_per.get(k, 0) + c
                # Order: a grant may not follow a denial of the same key
                # within the call (conservative serialization means a
                # denied row's demand still reserves ahead, so once any
                # row of a key denies, every later row must too).
                assert last_granted_rank.get(k, rank - 1) == rank - 1, (
                    f"seed={seed} step={step} key={k}: grant after denial")
                last_granted_rank[k] = rank
        clock.advance_seconds(10.0)  # full refill between steps
        assert all(v <= cap for v in granted_per.values())


@pytest.mark.parametrize("seed", [40, 41])
def test_hierarchical_matches_serial_reference(seed):
    """Differential for the fused two-level kernel
    (acquire_hierarchical_packed): with DISTINCT tenants and keys per
    call the device decisions must be bit-identical to the serial
    reference (InProcessBucketStore._hier_core) — grant, remaining
    (min of the binding constraints), refill across time advances, and
    the both-or-neither refund contract."""
    rng = np.random.default_rng(seed)
    clock_a = ManualClock()
    clock_b = ManualClock()
    dev = DeviceBucketStore(n_slots=64, counter_slots=8, clock=clock_a,
                            max_batch=8)
    ref = InProcessBucketStore(clock=clock_b)

    async def run():
        for step in range(30):
            perm = rng.permutation(12)
            tenants = [f"t{i}" for i in perm[:6]]
            keys = [f"k{i}" for i in perm[:6]]
            counts = [int(c) for c in rng.integers(0, 6, 6)]
            a = await dev.acquire_hierarchical_many(
                tenants, keys, counts, 15.0, 1.0, 9.0, 2.0)
            b = await ref.acquire_hierarchical_many(
                tenants, keys, counts, 15.0, 1.0, 9.0, 2.0)
            for i in range(6):
                assert bool(a.granted[i]) == bool(b.granted[i]), (
                    f"seed={seed} step={step} row={i} "
                    f"tenant={tenants[i]} key={keys[i]} "
                    f"count={counts[i]}: device={a[i]} reference={b[i]}")
                assert a.remaining[i] == pytest.approx(b.remaining[i],
                                                       abs=1e-3)
            if rng.random() < 0.5:
                dt = float(rng.random() * 2.0)
                clock_a.advance_seconds(dt)
                clock_b.advance_seconds(dt)
        await dev.aclose()

    import asyncio

    asyncio.run(run())


def test_weighted_cost_parity_across_lanes():
    """ONE seeded schedule of N-token acquires must produce IDENTICAL
    grant/deny sequences through the serving lanes — InProcess direct,
    remote scalar (OP_ACQUIRE) and asyncio bulk (OP_ACQUIRE_MANY) — each
    against its own
    fresh in-memory backing on a never-advancing clock (decisions are
    then a pure function of the schedule)."""
    import asyncio

    from distributedratelimiting.redis_tpu_torch.runtime.remote import (
        RemoteBucketStore,
    )
    from distributedratelimiting.redis_tpu_torch.runtime.server import (
        BucketStoreServer,
    )

    rng = np.random.default_rng(7)
    cap, rate = 1024.0, 1e-9
    n = 160
    keys = [f"u{rng.zipf(1.4) % 12}" for _ in range(n)]
    # Heavy-tailed token costs (the LLM shape): clamp into the capacity.
    costs = np.minimum(
        np.maximum(rng.lognormal(4.0, 1.2, n).astype(np.int64), 1),
        3000)

    async def lane_inprocess():
        st = InProcessBucketStore(clock=ManualClock())
        return [
            (await st.acquire(k, int(c), cap, rate)).granted
            for k, c in zip(keys, costs)]

    async def lane_remote_scalar():
        backing = InProcessBucketStore(clock=ManualClock())
        async with BucketStoreServer(backing) as srv:
            store = RemoteBucketStore(address=(srv.host, srv.port),
                                      coalesce_requests=False)
            try:
                return [
                    (await store.acquire(k, int(c), cap, rate)).granted
                    for k, c in zip(keys, costs)]
            finally:
                await store.aclose()

    async def lane_bulk():
        backing = InProcessBucketStore(clock=ManualClock())
        async with BucketStoreServer(backing) as srv:
            store = RemoteBucketStore(address=(srv.host, srv.port),
                                      coalesce_requests=False)
            try:
                out: list[bool] = []
                # Several frames, sequential — in-frame duplicates ride
                # the same serial backing, so decisions stay exact.
                for s in range(0, n, 40):
                    res = await store.acquire_many(
                        keys[s:s + 40], costs[s:s + 40], cap, rate)
                    out.extend(bool(g) for g in res.granted)
                return out
            finally:
                await store.aclose()

    async def main():
        lanes = {
            "inprocess": await lane_inprocess(),
            "remote_scalar": await lane_remote_scalar(),
            "asyncio_bulk": await lane_bulk(),
        }
        want = lanes["inprocess"]
        assert any(want) and not all(want)  # schedule crosses the edge
        for name, got in lanes.items():
            if got is None:
                continue
            assert got == want, (
                f"lane {name} diverged at row "
                f"{next(i for i, (x, y) in enumerate(zip(got, want)) if x != y)}")

    asyncio.run(main())
