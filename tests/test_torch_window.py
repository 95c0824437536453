"""The port's sliding and fixed windows against the JAX package's.

The same numpy-seeded inputs go through the JAX function and the port's at
every layer: the ``bucket_math`` window functions, the plain window kernels
(flush, grouped, the scan lanes, sweep, rebase), ``DeviceBucketStore`` on a
ManualClock through the three limiter models, snapshots and checkpoint files
in both directions, and the wire (both packages' servers and clients).

Tolerances, and why:

- Window indices, ``exists``, masks, ``prev_count`` and ``curr_count``
  (whole-number counts, exact in float32 below 2^24) are equal, and so is
  every fixed-window result (its estimate is ``curr`` alone).
- The sliding estimate ``curr + prev * (1 - frac)``: XLA on the CPU
  contracts the product and the sum into one fused multiply-add (one
  rounding); the port rounds each, as its CUDA kernel does with
  ``-fmad=false``. The two differ by at most 1.5 ulps of the estimate:
  :data:`EST_ULPS` = 2 ulps. A grant could flip only for a row whose
  ``estimate + prefix + count`` lies within that tolerance of the limit;
  the tests count those rows, and grants must be identical on every other
  row (the seeded inputs here have none).
- A sliding ``remaining = max(((limit - est) - prefix) - consumed, 0)``
  carries the estimate's difference through three subtractions of values up
  to twice the limit: :data:`REM_ULPS` = 8 ulps of the limit.
"""

import asyncio
import os

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.models.fixed_window import (
    FixedWindowRateLimiter as JFixed,
)
from distributedratelimiting.redis_tpu.models.options import (
    FixedWindowOptions as JFixedOptions,
)
from distributedratelimiting.redis_tpu.models.options import (
    SlidingWindowOptions as JSlidingOptions,
)
from distributedratelimiting.redis_tpu.models.partitioned_window import (
    PartitionedWindowRateLimiter as JPartitioned,
)
from distributedratelimiting.redis_tpu.models.sliding_window import (
    SlidingWindowRateLimiter as JSliding,
)
from distributedratelimiting.redis_tpu.ops import bucket_math as jbm
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.runtime import checkpoint as jcp
from distributedratelimiting.redis_tpu.runtime import wire as jw
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
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    DeviceBucketStore,
    FixedWindowOptions,
    FixedWindowRateLimiter,
    ManualClock,
    PartitionedWindowRateLimiter,
    RemoteBucketStore,
    SlidingWindowOptions,
    SlidingWindowRateLimiter,
)
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime import checkpoint as pcp
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw

torch.set_num_threads(1)

#: Ulps of the estimate between the port's two roundings and XLA's FMA.
EST_ULPS = 2
#: Ulps of the limit between the port's and JAX's sliding ``remaining``.
REM_ULPS = 8
#: A hang fails fast instead of eating the suite's time limit.
LIMIT_S = 20.0
#: Ticks of the bucket_math and kernel cases: 2^10 (the ticks of one
#: second), a round number, and a prime.
WINDOWS = (1024, 1000, 7919)


def w(coro, limit=LIMIT_S):
    return asyncio.wait_for(coro, limit)


def _np(x):
    return np.asarray(x)


def _est_tol(est):
    return EST_ULPS * np.spacing(np.abs(np.asarray(est, np.float32)))


def _rem_tol(limit):
    return REM_ULPS * float(np.spacing(np.float32(limit)))


def _window_inputs(seed, n, window, now):
    """Indices around ``now``'s window — current, one and two behind, one
    ahead (a clock behind the store) — and some far off on either side,
    whose ``idx * window`` and index differences wrap as int32; counts
    whole and fractional; a fifth of the slots missing."""
    rng = np.random.default_rng(seed)
    cur = now // window
    idx = cur + rng.choice([-3, -2, -1, 0, 0, 0, 1], n).astype(np.int64)
    far = rng.random(n) < 0.1
    idx[far] = rng.integers(-2**31, 2**31 - 1, int(far.sum()))
    idx = np.clip(idx, -2**31, 2**31 - 1).astype(np.int32)
    prev = rng.integers(0, 40, n).astype(np.float32)
    curr = rng.integers(0, 40, n).astype(np.float32)
    frac_rows = rng.random(n) < 0.3
    prev[frac_rows] += rng.random(int(frac_rows.sum())).astype(np.float32)
    exists = rng.random(n) < 0.8
    return prev, curr, idx, exists


# -- bucket_math --------------------------------------------------------------

CASES = [(wt, now) for wt in WINDOWS
         for now in (123_456, -5_001, 2**31 - 1)]


@pytest.mark.parametrize("window,now", CASES)
def test_window_advance_matches_jax(window, now):
    prev, curr, idx, exists = _window_inputs(1, 4096, window, now)
    got = bm.sliding_window_advance(
        torch.from_numpy(prev), torch.from_numpy(curr),
        torch.from_numpy(idx), torch.from_numpy(exists), now, window)
    want = jbm.sliding_window_advance(prev, curr, idx, exists, np.int32(now),
                                      np.int32(window))
    for g, wnt in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(wnt))
    # The clock-regression clamp kept every index ahead of now.
    ahead = exists & (idx > now // window)
    np.testing.assert_array_equal(got[2].numpy()[ahead], idx[ahead])


@pytest.mark.parametrize("window,now", CASES)
def test_window_estimate_matches_jax(window, now):
    """Within EST_ULPS of XLA's fused result; with ``idx`` not advanced
    first, ``rem`` is negative (clipped to 0) or wraps past 2^31 (clipped to
    1), and both agree."""
    prev, curr, idx, _ = _window_inputs(2, 4096, window, now)
    got = bm.sliding_window_estimate(
        torch.from_numpy(prev), torch.from_numpy(curr),
        torch.from_numpy(idx), now, window).numpy()
    want = _np(jbm.sliding_window_estimate(prev, curr, idx, np.int32(now),
                                           np.int32(window)))
    assert np.all(np.abs(got - want) <= _est_tol(want))
    # A wrapped in-window remainder: the port wraps as int32 does.
    rem = (np.int64(now) - idx.astype(np.int64) * window + 2**31) % 2**32 \
        - 2**31
    frac = np.clip(rem.astype(np.float32) / np.float32(window), 0, 1)
    np.testing.assert_array_equal(got, curr + prev * (np.float32(1) - frac))


@pytest.mark.parametrize("window,now", CASES)
def test_window_acquire_matches_jax(window, now):
    prev, curr, idx, exists = _window_inputs(3, 4096, window, now)
    counts = np.random.default_rng(4).integers(0, 20, 4096).astype(np.int32)
    limit = 50.0
    got = bm.sliding_window_acquire(
        torch.from_numpy(prev), torch.from_numpy(curr),
        torch.from_numpy(idx), torch.from_numpy(exists), now,
        torch.from_numpy(counts), limit, window)
    want = jbm.sliding_window_acquire(prev, curr, idx, exists, np.int32(now),
                                      counts, np.float32(limit),
                                      np.int32(window))
    np.testing.assert_array_equal(got[0].numpy(), _np(want[0]))
    np.testing.assert_array_equal(got[2].numpy(), _np(want[2]))
    # Rows whose grant the estimate's rounding could flip — the two
    # estimates differ and lie within the tolerance of the limit: none here.
    p2, c2, i2 = (t.numpy() for t in bm.sliding_window_advance(
        torch.from_numpy(prev), torch.from_numpy(curr),
        torch.from_numpy(idx), torch.from_numpy(exists), now, window))
    est = bm.sliding_window_estimate(torch.from_numpy(p2),
                                     torch.from_numpy(c2),
                                     torch.from_numpy(i2), now,
                                     window).numpy()
    est_j = _np(jbm.sliding_window_estimate(p2, c2, i2, np.int32(now),
                                            np.int32(window)))
    near = (np.abs(limit - (est + counts)) <= _est_tol(est)) & (est != est_j)
    assert int(near.sum()) == 0
    np.testing.assert_array_equal(got[3].numpy(), _np(want[3]))
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    assert 0 < int(got[3].sum()) < 4096


def test_window_index_is_a_floor():
    for now, wt in ((-1, 1000), (-1000, 1000), (-1001, 1000), (999, 1000),
                    (-(2**31), 7919), (2**31 - 1, 3)):
        assert int(bm.window_index(now, wt)) == now // wt
        assert int(bm.window_index(now, wt)) == int(
            np.floor_divide(np.int32(now), np.int32(wt)))


# -- plain kernels ------------------------------------------------------------

N = 256
B = 128


def _states(seed, window, now, n=N):
    """The same window table for both packages."""
    rng = np.random.default_rng(seed)
    idx = (now // window + rng.choice([-2, -1, 0, 0, 1], n)).astype(np.int32)
    arrays = (rng.integers(0, 12, n).astype(np.float32),
              rng.integers(0, 12, n).astype(np.float32), idx,
              rng.random(n) < 0.7)
    port = K.WindowState(*(torch.from_numpy(a.copy()) for a in arrays))
    jax_ = JK.WindowState(*(np.array(a) for a in arrays))
    return port, jax_


def _assert_state_equal(port, jax_state):
    for name in K.WindowState._fields:
        np.testing.assert_array_equal(getattr(port, name).numpy(),
                                      _np(getattr(jax_state, name)),
                                      err_msg=name)


def _assert_results(got, want, limit, interpolate):
    """Row 0 (grants) equal; row 1 (remaining) equal for a fixed window,
    within REM_ULPS of the limit for a sliding one."""
    got, want = got.numpy(), _np(want)
    np.testing.assert_array_equal(got[..., 0, :] if got.ndim == 3
                                  else got[0],
                                  want[..., 0, :] if want.ndim == 3
                                  else want[0])
    rem_g = got[:, 1] if got.ndim == 3 else got[1]
    rem_w = want[:, 1] if want.ndim == 3 else want[1]
    if interpolate:
        np.testing.assert_allclose(rem_g, rem_w, rtol=0,
                                   atol=_rem_tol(limit))
    else:
        np.testing.assert_array_equal(rem_g, rem_w)


def _flush_operand(seed, rows, now, b=B, n=N):
    """Zipf slots (duplicates), padding and out-of-range rows; the host
    prefix of the store's ``_build_packed``; group sizes for the grouped
    rule."""
    from distributedratelimiting.redis_tpu_torch.runtime.store import (
        _duplicate_prefix_host,
    )

    rng = np.random.default_rng(seed)
    slots = np.minimum(rng.zipf(1.3, b) - 1, n - 1).astype(np.int32)
    slots[rng.random(b) < 0.08] = -1
    slots[rng.random(b) < 0.04] = n + 5
    counts = rng.integers(0, 4, b).astype(np.int32)
    sizes = rng.integers(1, 5, b).astype(np.int32)
    demand = counts * sizes if rows == 5 else counts
    prefix = np.zeros(b, np.int64)
    valid = (slots >= 0) & (slots < n)
    prefix[valid] = _duplicate_prefix_host(slots[valid], demand[valid])
    out = [slots, counts, np.full(b, now, np.int32),
           prefix.astype(np.int32), sizes]
    return np.stack(out[:rows])


@pytest.mark.parametrize("interpolate", [True, False])
@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("window", [1000, 7919])
def test_window_flush_matches_jax(grouped, interpolate, window):
    now = 3 * window + 377
    port, jst = _states(5, window, now)
    op = _flush_operand(6, 5 if grouped else 4, now)
    limit = 9.0
    if grouped:
        _, got = K.window_acquire_batch_packed_grouped(
            port, torch.from_numpy(op), limit, window,
            interpolate=interpolate)
        jst, want = JK.window_acquire_batch_packed_grouped(
            jst, op, np.float32(limit), np.int32(window),
            interpolate=interpolate)
    else:
        _, got = K.window_acquire_batch_packed(
            port, torch.from_numpy(op), limit, window,
            interpolate=interpolate)
        jst, want = JK.window_acquire_batch_packed(
            jst, op, np.float32(limit), np.int32(window),
            interpolate=interpolate)
    _assert_results(got, want, limit, interpolate)
    _assert_state_equal(port, jst)
    assert 0 < float(got[0].sum())
    # The wrapper on a CPU table is the plain version, and counts nothing.
    port2, _ = _states(5, window, now)
    before = dict(ck.launches)
    fn = ck.window_grouped if grouped else ck.window_packed
    np.testing.assert_array_equal(
        fn(port2, torch.from_numpy(op), limit, window,
           interpolate=interpolate).numpy(), got.numpy())
    assert ck.launches == before


def _scan_operand(seed, k, b=B, n=N, big=False):
    rng = np.random.default_rng(seed)
    slots = np.minimum(rng.zipf(1.3, (k, b)) - 1, n - 1).astype(np.int32)
    slots[rng.random((k, b)) < 0.05] = -1
    counts = rng.integers(0, 1000 if big else 4, (k, b))
    return slots, counts


@pytest.mark.parametrize("lane,interpolate", [
    (lane, interpolate) for lane in ("fused_packed", "fused_bits", "i32")
    for interpolate in (True, False)] + [("compact", True)])  # sliding only
def test_window_scan_lanes_match_jax(lane, interpolate):
    window, k = 1000, 4
    nows = np.array([4_100, 4_700, 5_200, 6_900], np.int32)
    port, jst = _states(7, window, int(nows[0]))
    slots, counts = _scan_operand(8, k, big=lane == "i32")
    limit = 3000.0 if lane == "i32" else 9.0
    lim, wt = np.float32(limit), np.int32(window)
    if lane in ("fused_packed", "fused_bits"):
        fused = K.pack_compact5(slots, counts.astype(np.uint8))
        pfn = getattr(K, f"window_acquire_scan_{lane}")
        jfn = getattr(JK, f"window_acquire_scan_{lane}")
        _, got = pfn(port, torch.from_numpy(fused), torch.from_numpy(nows),
                     limit, window, interpolate=interpolate)
        jst, want = jfn(jst, fused, nows, lim, wt, interpolate=interpolate)
        if lane == "fused_bits":
            np.testing.assert_array_equal(got.numpy(), _np(want))
        else:
            _assert_results(got, want, limit, interpolate)
    else:
        c = counts.astype(np.int32 if lane == "i32" else np.uint8)
        if lane == "i32":
            _, g, r = K.window_acquire_scan(
                port, torch.from_numpy(slots), torch.from_numpy(c),
                torch.from_numpy(slots >= 0), torch.from_numpy(nows), limit,
                window, interpolate=interpolate)
            jst, jg, jr = JK.window_acquire_scan(
                jst, slots, c, slots >= 0, nows, lim, wt,
                interpolate=interpolate)
        else:
            _, g, r = K.window_acquire_scan_compact(
                port, torch.from_numpy(slots), torch.from_numpy(c),
                torch.from_numpy(nows), limit, window)
            jst, jg, jr = JK.window_acquire_scan_compact(
                jst, slots, c, nows, lim, wt)
        got = torch.stack([g.float(), r], dim=1)
        want = np.stack([_np(jg).astype(np.float32), _np(jr)], axis=1)
        _assert_results(got, want, limit, interpolate)
    _assert_state_equal(port, jst)


@pytest.mark.parametrize("fused", [True, False])
def test_window_scan_wrapper_on_cpu_is_the_plain_version(fused):
    """``ck.window_scan_packed`` on a CPU table: the plain lanes, both
    result forms, no launch counted."""
    window, k = 1000, 4
    nows = torch.tensor([4_100, 4_700, 5_200, 6_900], dtype=torch.int32)
    slots, counts = _scan_operand(9, k, big=not fused)
    if fused:
        op = torch.from_numpy(K.pack_compact5(slots, counts.astype(np.uint8)))
    else:
        op = torch.from_numpy(np.stack([slots, counts.astype(np.int32)]))
    before = dict(ck.launches)
    outs = []
    for with_rem in (True, False):
        port, _ = _states(10, window, 4_100)
        outs.append(ck.window_scan_packed(port, op, nows, 9.0, window,
                                          with_remaining=with_rem))
    assert ck.launches == before
    assert outs[0].shape == (k, 2, B) and outs[1].shape == (k, B // 8)
    np.testing.assert_array_equal(
        outs[1].numpy(), K.pack_grant_bits(outs[0][:, 0] > 0.5).numpy())


@pytest.mark.parametrize("now", [50_000, -3_001, 2**31 - 1])
def test_sweep_windows_matches_jax(now):
    window, n = 1000, 20_000
    rng = np.random.default_rng(11)
    idx = (now // window - rng.integers(-1, 5, n)).astype(np.int64)
    far = rng.random(n) < 0.05
    idx[far] = rng.integers(-2**31, 2**31 - 1, int(far.sum()))
    arrays = (np.zeros(n, np.float32), np.zeros(n, np.float32),
              np.clip(idx, -2**31, 2**31 - 1).astype(np.int32),
              rng.random(n) < 0.5)
    port = K.WindowState(*(torch.from_numpy(a.copy()) for a in arrays))
    jst = JK.WindowState(*(np.array(a) for a in arrays))
    _, got = K.sweep_windows(port, now, window)
    jst, want = JK.sweep_windows(jst, np.int32(now), np.int32(window))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    _assert_state_equal(port, jst)
    # The wrapper: the same mask, and one count per TILE slots.
    port = K.WindowState(*(torch.from_numpy(a.copy()) for a in arrays))
    mask, tiles = ck.sweep_windows(port, now, window)
    np.testing.assert_array_equal(mask.numpy().astype(bool), _np(want))
    assert int(tiles.sum()) == int(_np(want).sum()) > 0


@pytest.mark.parametrize("offset", [0, 7, 2**20])
def test_rebase_window_epoch_matches_jax(offset):
    port, jst = _states(12, 1000, 2**21)
    K.rebase_window_epoch(port, offset)
    jst = JK.rebase_window_epoch(jst, np.int32(offset))
    _assert_state_equal(port, jst)


# -- the store through the limiter models -------------------------------------

START = 1_000_000


def _stores(n_slots=64, start=START):
    port = DeviceBucketStore(device="cpu", clock=ManualClock(start),
                             n_slots=n_slots, max_batch=128)
    jax_ = JStore(clock=JClock(start), n_slots=n_slots, max_batch=128)
    return port, jax_


def _limiters(store, port: bool):
    sw, fw, pw_ = ((SlidingWindowRateLimiter, FixedWindowRateLimiter,
                    PartitionedWindowRateLimiter) if port
                   else (JSliding, JFixed, JPartitioned))
    so, fo = ((SlidingWindowOptions, FixedWindowOptions) if port
              else (JSlidingOptions, JFixedOptions))
    return {
        "sliding": sw(so(permit_limit=5, window_s=1.0, instance_name="s"),
                      store),
        "fixed": fw(fo(permit_limit=4, window_s=0.75, instance_name="f"),
                    store),
        "part": pw_(so(permit_limit=6, window_s=1.3, instance_name="p"),
                    store),
        "partf": pw_(fo(permit_limit=3, window_s=0.5, instance_name="q"),
                     store),
    }


def _lease(lease):
    return (lease.is_acquired, lease.retry_after)


async def _store_trace(store, port: bool, seed: int, rounds: int = 6,
                       first: int = 0):
    """One seeded trace over the four limiters; returns what they
    observed. Fractional clock advances (the sliding estimate's fraction),
    bursts inside one flush, bulk calls with duplicates, and more distinct
    keys than the 64-slot tables hold (sweeps and doublings)."""
    rng = np.random.default_rng(seed)
    lims = _limiters(store, port)
    out = []
    for r in range(first, first + rounds):
        # Now and then an idle stretch: the next sweep evicts.
        idle = 2.0 if rng.random() < 0.3 else 0.0
        store.clock.advance_seconds(idle + float(rng.uniform(0.05, 0.7)))
        rec = {}
        rec["blocking"] = [_lease(lims["sliding"].acquire(int(p)))
                           for p in rng.integers(0, 3, 4)]
        rec["available"] = lims["sliding"].available_permits()
        leases = await w(asyncio.gather(*(
            lims["fixed"].acquire_async(1) for _ in range(7))))
        rec["fixed"] = sorted(_lease(x) for x in leases)
        hot = [f"h{i}" for i in (rng.zipf(1.5, 30) - 1) % 6]
        per_key = {h: 1 + (int(h[1:]) % 2) for h in set(hot)}
        leases = await w(asyncio.gather(*(
            lims["part"].acquire_async(h, per_key[h]) for h in hot)))
        by_key = {}
        for h, x in zip(hot, leases):
            by_key.setdefault(h, []).append(x.is_acquired)
        rec["part"] = {h: sorted(v) for h, v in by_key.items()}
        keys = [f"b{i}" for i in rng.integers(0, 40, 90)] + [f"n{r}-{i}"
                                                            for i in range(30)]
        res = await w(lims["part"].acquire_many(
            keys, [int(c) for c in rng.integers(0, 3, len(keys))]))
        rec["bulk"] = (res.granted.tolist(), res.remaining.copy())
        res = lims["partf"].acquire_many_blocking(
            keys[::-1], 1, with_remaining=False)
        rec["bulkf"] = res.granted.tolist()
        if r % 2:
            store.sweep_all()
        out.append(rec)
    return out


def _assert_traces_agree(got, want, limit_of_bulk=6.0):
    assert len(got) == len(want)
    for g, wnt in zip(got, want):
        assert [x[0] for x in g["blocking"]] == [x[0] for x in wnt["blocking"]]
        for (_, a), (_, b) in zip(g["blocking"], wnt["blocking"]):
            assert (a is None) == (b is None)
            if a is not None:  # retry_after = deficit / limit * window
                assert abs(a - b) <= 1e-5
        assert g["available"] == wnt["available"]
        assert g["fixed"] == wnt["fixed"]
        assert g["part"] == wnt["part"]
        assert g["bulk"][0] == wnt["bulk"][0]
        np.testing.assert_allclose(g["bulk"][1], wnt["bulk"][1], rtol=0,
                                   atol=_rem_tol(limit_of_bulk))
        assert g["bulkf"] == wnt["bulkf"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_store_trace_matches_jax(seed):
    port, jax_ = _stores()
    got = asyncio.run(_store_trace(port, True, seed))
    want = asyncio.run(_store_trace(jax_, False, seed))
    _assert_traces_agree(got, want)
    # The tables swept and grew alike.
    assert sorted(port._wtables) == sorted(jax_._wtables)
    for key, t in port._wtables.items():
        assert t.n_slots == jax_._wtables[key].n_slots
    assert port.metrics.slots_evicted == jax_.metrics.slots_evicted > 0


@pytest.mark.parametrize("fixed", [False, True])
def test_cap5_burst_and_readmission(fixed):
    """32 one-permit asks inside one window grant exactly 5; a window later
    (sliding: two, once the previous count has slid out) all 5 again."""
    for store in _stores():
        op = store.fixed_window_acquire if fixed else store.window_acquire

        async def burst():
            res = await w(asyncio.gather(*(op("five", 1, 5.0, 1.0)
                                           for _ in range(32))))
            return sum(r.granted for r in res)

        assert asyncio.run(burst()) == 5
        store.clock.advance_seconds(1.0 if fixed else 2.0)
        assert asyncio.run(burst()) == 5


@pytest.mark.parametrize("fixed", [False, True])
def test_bulk_counts_past_a_byte_take_the_i32_lane(fixed):
    port, jax_ = _stores()
    keys = [f"k{i % 50}" for i in range(300)]
    counts = np.random.default_rng(13).integers(0, 700, 300)
    got = port.window_acquire_many_blocking(keys, counts, 2000.0, 1.0,
                                            fixed=fixed)
    want = jax_.window_acquire_many_blocking(keys, counts, 2000.0, 1.0,
                                             fixed=fixed)
    np.testing.assert_array_equal(got.granted, want.granted)
    np.testing.assert_allclose(got.remaining, want.remaining, rtol=0,
                               atol=_rem_tol(2000.0))
    assert 0 < got.granted_count < 300


def test_sweep_evicts_windows_two_behind_and_rebase_shifts_them():
    port, jax_ = _stores(n_slots=256)
    for store in (port, jax_):
        store.window_acquire_many_blocking([f"a{i}" for i in range(100)],
                                           [1] * 100, 5.0, 1.0)
        store.clock.advance_seconds(1.0)
        store.window_acquire_many_blocking([f"b{i}" for i in range(50)],
                                           [1] * 50, 5.0, 1.0)
        store.clock.advance_seconds(1.0)
        store.sweep_all()  # a* are two windows behind, b* one
        assert store.metrics.slots_evicted == 100
        store.force_rebase(10_000)
    _assert_state_equal(port._wtables[(5.0, 1024, False)].state,
                        jax_._wtables[(5.0, 1024, False)].state)


# -- snapshots and checkpoint files -------------------------------------------

@pytest.mark.parametrize("source", ["jax", "port"])
@pytest.mark.parametrize("start", [START + 7_777, 5_000])  # older, younger
def test_snapshot_restores_alike_in_both_packages(source, start):
    """A snapshot of either package's store restored into both packages'
    stores on one clock (``start`` below the snapshot's: a negative shift,
    floor-divided into whole windows), then one continuation trace:
    identical grants."""
    port, jax_ = _stores()
    src, is_port = (port, True) if source == "port" else (jax_, False)
    asyncio.run(_store_trace(src, is_port, 4, rounds=3))
    snap = src.snapshot()
    assert snap["wtables"]
    p2, j2 = _stores(start=start)
    p2.restore(snap)
    j2.restore(snap)
    assert sorted(p2._wtables) == sorted(j2._wtables)
    for key, t in p2._wtables.items():
        _assert_state_equal(t.state, j2._wtables[key].state)
    got = asyncio.run(_store_trace(p2, True, 5, rounds=3, first=3))
    want = asyncio.run(_store_trace(j2, False, 5, rounds=3, first=3))
    _assert_traces_agree(got, want)


def test_legacy_two_tuple_window_keys_restore_as_sliding():
    _, jax_ = _stores()
    asyncio.run(_store_trace(jax_, False, 6, rounds=2))
    snap = jax_.snapshot()
    snap["wtables"] = {k[:2]: v for k, v in snap["wtables"].items()
                       if not k[2]}
    p2, j2 = _stores(start=START - 3_000)
    p2.restore(snap)
    j2.restore(snap)
    assert sorted(p2._wtables) == sorted(j2._wtables)
    assert all(not k[2] for k in p2._wtables)
    for key, t in p2._wtables.items():
        _assert_state_equal(t.state, j2._wtables[key].state)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_files_carry_windows_both_ways(tmp_path, writer):
    port, jax_ = _stores()
    src = port if writer == "port" else jax_
    asyncio.run(_store_trace(src, writer == "port", 7, rounds=2))
    path = str(tmp_path / "snap.pkl")
    (pcp if writer == "port" else jcp).save_snapshot(src, path)
    p2, j2 = _stores(start=START + 100)
    pcp.load_snapshot(p2, path)
    jcp.load_snapshot(j2, path)
    for key, t in p2._wtables.items():
        _assert_state_equal(t.state, j2._wtables[key].state)
        for name in ("prev_count", "curr_count", "exists"):
            np.testing.assert_array_equal(
                _np(getattr(t.state, name)),
                _np(getattr(src._wtables[key].state, name)))
    got = asyncio.run(_store_trace(p2, True, 8, rounds=2, first=2))
    want = asyncio.run(_store_trace(j2, False, 8, rounds=2, first=2))
    _assert_traces_agree(got, want)


# -- the wire -----------------------------------------------------------------

class _Server:
    """One store server of either package with its ManualClock."""

    def __init__(self, kind: str) -> None:
        if kind == "port":
            self.clock = ManualClock(START)
            self.store = DeviceBucketStore(device="cpu", clock=self.clock,
                                           n_slots=256)
            self.server = BucketStoreServer(self.store)
        else:
            self.clock = JClock(START)
            self.store = JStore(clock=self.clock, n_slots=256)
            self.server = JServer(self.store, observability=False,
                                  audit=False)

    async def __aenter__(self):
        await self.server.start()
        return self

    async def __aexit__(self, *exc):
        await self.server.aclose()
        await self.store.aclose()

    @property
    def address(self):
        return (self.server.host, self.server.port)


async def _wire_trace(srv, client_kind, seed):
    """Scalar OP_WINDOW / OP_FWINDOW requests (concurrent, fixed count per
    key) and window bulk frames. The clock moves by quarter windows, so every
    estimate is a multiple of 1/4: exact in both packages."""
    rng = np.random.default_rng(seed)
    cls = RemoteBucketStore if client_kind == "port" else JRemote
    cli = cls(address=srv.address, coalesce_requests=False)
    keys = [f"w{i}" for i in range(6)]
    per_key = {k: 1 + i % 3 for i, k in enumerate(keys)}
    out = {"scalar": [], "bulk": []}
    try:
        for rnd in range(5):
            for fixed in (False, True):
                op = cli.fixed_window_acquire if fixed else cli.window_acquire
                ks = [keys[i] for i in (rng.zipf(1.4, 30) - 1) % len(keys)]
                res = await w(asyncio.gather(*(
                    op(k, per_key[k], 6.0, 1.0) for k in ks)))
                by_key = {}
                for k, r in zip(ks, res):
                    by_key.setdefault(k, []).append(
                        (r.granted, r.remaining if r.granted else -1.0))
                out["scalar"].append({k: sorted(v)
                                      for k, v in by_key.items()})
            for fixed in (False, True):
                dup = f"dup{rnd}{fixed}"
                bkeys = [dup] + [f"b{i}" for i in
                                 rng.integers(0, 30, 58)] + [dup]
                counts = [1] + rng.integers(0, 3, 58).tolist() + [3]
                res = await w(cli.window_acquire_many(
                    bkeys, counts, 3.0, 1.0, fixed=fixed))
                out["bulk"].append((res.granted.tolist(),
                                    res.remaining.tolist()))
                # Chunk order: the first "dup" grants, the last is denied.
                assert res.granted[0] and not res.granted[-1]
                res = await w(cli.window_acquire_many(
                    bkeys[::-1], counts[::-1], 3.0, 1.0, fixed=fixed,
                    with_remaining=False))
                out["bulk"].append((res.granted.tolist(), None))
            srv.clock.advance_seconds(0.25 * int(rng.integers(1, 4)))
        # Cap-5 × 32 over the wire → exactly 5, sliding and fixed.
        for fixed in (False, True):
            op = cli.fixed_window_acquire if fixed else cli.window_acquire
            res = await w(asyncio.gather(*(op(f"five{fixed}", 1, 5.0, 1.0)
                                           for _ in range(32))))
            out[f"five{fixed}"] = sum(r.granted for r in res)
            assert out[f"five{fixed}"] == 5
        out["blocking"] = [
            await w(asyncio.to_thread(cli.window_acquire_blocking, "bl", 2,
                                      3.0, 1.0)),
            await w(asyncio.to_thread(cli.fixed_window_acquire_blocking,
                                      "bl", 2, 3.0, 1.0)),
            (await w(asyncio.to_thread(
                cli.window_acquire_many_blocking, ["x", "x", "y"],
                [2, 2, 1], 3.0, 1.0))).granted.tolist()]
    finally:
        await cli.aclose()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_window_wire_four_pairings_agree(monkeypatch, seed):
    # Small chunks: one bulk call crosses several chained frames, with the
    # duplicate key on both sides of a boundary.
    monkeypatch.setattr(pw, "BULK_CHUNK_BUDGET", 96)
    monkeypatch.setattr(jw, "BULK_CHUNK_BUDGET", 96)
    assert len(pw.bulk_chunk_spans(np.full(60, 3))) > 3

    async def run(server_kind, client_kind):
        async with _Server(server_kind) as srv:
            return await _wire_trace(srv, client_kind, seed)

    results = {(s, c): asyncio.run(run(s, c))
               for s in ("port", "jax") for c in ("port", "jax")}
    ref = results[("jax", "jax")]
    for pair, got in results.items():
        assert got == ref, pair


def test_port_server_serves_window_frames_byte_for_byte():
    """Raw OP_WINDOW, OP_FWINDOW and window-kind ACQUIRE_MANY frames: the
    port's server answers exactly as the JAX server does."""
    frames = [jw.encode_request(1, jw.OP_WINDOW, "k", 2, 3.0, 1.0),
              jw.encode_request(2, jw.OP_FWINDOW, "k", 2, 3.0, 1.0),
              jw.encode_request(3, jw.OP_WINDOW, "k", 2, 3.0, 1.0),
              jw.encode_bulk_request(4, [b"a", b"b", b"a"], [2, 1, 2], 3.0,
                                     1.0, kind=jw.BULK_KIND_WINDOW),
              jw.encode_bulk_request(5, [b"a", b"b", b"a"], [2, 1, 2], 3.0,
                                     1.0, kind=jw.BULK_KIND_FWINDOW,
                                     with_remaining=False)]

    async def replies(kind):
        async with _Server(kind) as srv:
            reader, writer = await asyncio.open_connection(*srv.address)
            out = {}
            for f in frames:  # one at a time: replies in a fixed order
                writer.write(f)
                await writer.drain()
                body = await w(pw.read_frame(reader))
                out[int.from_bytes(body[1:5], "little")] = body
            writer.close()
            return out

    got = asyncio.run(replies("port"))
    want = asyncio.run(replies("jax"))
    assert got == want
    seq, kind, vals = pw.decode_response(got[3])
    assert kind == pw.RESP_DECISION and vals[0] is False


def test_window_modules_import_no_jax():
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys; sys.modules['jax'] = None; "
            "import distributedratelimiting.redis_tpu_torch as p; "
            "from distributedratelimiting.redis_tpu_torch.models import "
            "sliding_window, fixed_window, partitioned_window; "
            "assert not any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('distributedratelimiting.redis_tpu.') "
            "for m in sys.modules if sys.modules[m] is not None)")
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   env={**os.environ, "PYTHONPATH": root})
