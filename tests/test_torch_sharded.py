"""The port's key-sharded tables (``redis_tpu_torch/parallel/``) against the
JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices ``tests/conftest.py`` sets; the port
on a ``Mesh`` of 8 x ``cpu`` (every shard in one shard-major table, the
kernels' plain versions deciding). Both get the same seeded numpy inputs and
the same ``ManualClock`` schedule.

- Routing: ``route_keys`` equals ``zlib.crc32(key) % n`` for lists and
  ``KeyBlob``\\ s, surrogate-escaped keys included.
- The global tier: the plain ``global_tier`` against JAX's
  ``global_tier_update`` after the psum (the per-batch totals summed in
  float64, exact here), both cadences, seeded ``[S, K, B]`` grants and
  counts and clock jumps (one going back). Whole counts and totals below
  2^24 make every sum exact; the counter's value and period then agree
  within 2 float32 ulps of the largest operand (XLA on the CPU may contract
  a multiply-add into an FMA; the port rounds each operation: ROADMAP's
  deliberate divergences).
- Every step builder of ``sharded_store.py`` on seeded batches with
  repeated slots, padding, invalid rows and out-of-range slots: grants
  equal, remaining within 1e-6 relative, the state after the step equal
  (tokens within 1e-6 relative), the counter as above.
- The stores, ``ShardedDeviceStore`` and ``ShardedWindowStore`` (sliding
  and fixed), against their JAX twins over a seeded mixed schedule (scalar
  batches, bulks with repeats, zero-permit probes, peeks, sweeps, growth,
  forced rebases, both cadences), then a snapshot restored into a fresh
  store of the OTHER package: per key, grants and peeks equal, remaining
  within 1e-6 relative (windows: 1.5 ulps of the limit, the single-table
  window tolerance), ``global_score`` within the tier's tolerance.
- The JAX file ``tests/test_sharded.py``'s surface, class by class, on the
  port.
"""

import zlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.parallel import sharded_store as J
from distributedratelimiting.redis_tpu.parallel.mesh import (
    SHARD_AXIS as JAXIS,
    create_mesh as jcreate_mesh,
)
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.ops.bucket_math import (
    TICKS_PER_SECOND,
)
from distributedratelimiting.redis_tpu_torch.parallel import sharded_store as P
from distributedratelimiting.redis_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
)
from distributedratelimiting.redis_tpu_torch.runtime.clock import ManualClock
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    InProcessBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime.wire import KeyBlob

S = 8
RTOL = 1e-6


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= S, "conftest must provide 8 virtual devices"
    return jcreate_mesh(S)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(["cpu"] * S)


@pytest.fixture
def clock():
    return ManualClock()


def _ulps_close(a, b, *operands, ulps=2.0) -> bool:
    big = max([abs(float(x)) for x in (a, b, *operands)] + [1e-30])
    return abs(float(a) - float(b)) <= ulps * float(np.spacing(np.float32(big)))


# -- the mesh ---------------------------------------------------------------------
def test_mesh_has_8_shards(mesh):
    assert mesh.n_shards == S and len(mesh.devices) == S
    assert mesh.device == torch.device("cpu")


def test_mesh_over_several_devices_raises():
    with pytest.raises(ValueError, match="A 16"):
        Mesh(["cpu", "meta"])
    with pytest.raises(ValueError, match="at least one shard"):
        Mesh([])


def test_create_mesh_raises_without_enough_cards():
    present = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(ValueError, match="only"):
        create_mesh(present + 1)


# -- routing ------------------------------------------------------------------------
def _blob(keys):
    raw = [k.encode("utf-8", "surrogateescape") for k in keys]
    offsets = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(b) for b in raw], out=offsets[1:])
    return KeyBlob(b"".join(raw), offsets)


ROUTE_KEYS = ([f"key-{i}" for i in range(500)]
              + ["ключ-🔑", "", "x" * 300, "\udcff\udc80odd"])


@pytest.mark.parametrize("n", [1, 3, 8, 13])
def test_route_keys_matches_crc32(n):
    want = [zlib.crc32(k.encode("utf-8", "surrogateescape")) % n
            for k in ROUTE_KEYS]
    assert P.route_keys(ROUTE_KEYS, n).tolist() == want
    assert P.route_keys(_blob(ROUTE_KEYS), n).tolist() == want
    assert P.route_keys(tuple(ROUTE_KEYS), n).tolist() == want
    assert [P.shard_of_key(k, n) for k in ROUTE_KEYS] == want
    assert J.route_keys(ROUTE_KEYS, n).tolist() == want


def test_routing_is_stable_and_spread():
    shards = [P.shard_of_key(f"key-{i}", S) for i in range(1000)]
    assert shards == [P.shard_of_key(f"key-{i}", S) for i in range(1000)]
    assert np.bincount(shards, minlength=S).min() > 50


# -- the global tier ------------------------------------------------------------------
def _jcounter(v, p, ts, ex):
    return J.GlobalCounter(value=jnp.float32(v), period=jnp.float32(p),
                           last_ts=jnp.int32(ts), exists=jnp.asarray(ex))


@pytest.mark.parametrize("cadence", ["batch", "launch"])
@pytest.mark.parametrize("seed", range(6))
def test_global_tier_matches_jax_psum(seed, cadence):
    rng = np.random.default_rng(100 + seed)
    k = int(rng.choice([1, 3, 8]))
    b = int(rng.choice([8, 16, 64]))
    counts = rng.integers(0, 1000, (S, k, b)).astype(np.int32)
    grants = rng.random((S, k, b)) < 0.6
    counts[~(rng.random((S, k, b)) < 0.9)] = 0  # padding rows count 0
    start = int(rng.integers(1000, 50_000))
    jumps = rng.integers(0, 3000, k)
    jumps[rng.random(k) < 0.2] = 0
    nows = (start + np.cumsum(jumps)).astype(np.int32)
    if k > 2:
        nows[1] = nows[0] - 7  # the clock going back: the elapsed clamp
    rate = float(rng.choice([0.37, 1.0 / 1024, 0.0, 5.5]))
    fresh = seed % 2 == 0
    v0, p0, ts0 = ((0.0, 0.0, 0) if fresh
                   else (float(rng.integers(0, 10_000)), 731.25, start - 500))
    # JAX: per-shard consumed, psum, the recurrence.
    totals = (counts.astype(np.float64) * grants).sum(axis=(0, 2))
    g = _jcounter(v0, p0, ts0, not fresh)
    steps = (list(zip(totals, nows)) if cadence == "batch"
             else [(totals.sum(), nows[-1])])
    for total, now in steps:
        g = J.global_tier_update(g, jnp.float32(total), jnp.int32(now),
                                 jnp.float32(rate))
    # The port: one decision's result over all shards' rows.
    out = torch.zeros((k, 2, S * b))
    out[:, 0] = torch.from_numpy(P._rows(torch.from_numpy(grants)).numpy()
                                 .astype(np.float32))
    pc = K.init_global_counter()
    pc.value.fill_(v0)
    pc.period.fill_(p0)
    pc.last_ts.fill_(ts0)
    pc.exists.fill_(not fresh)
    K.global_tier(out, P._rows(torch.from_numpy(counts)), torch.from_numpy(
        nows), pc, rate, cadence)
    assert int(pc.last_ts) == int(g.last_ts) and bool(pc.exists)
    big = max(v0, float(totals.sum()), float(nows.max()) * rate)
    assert _ulps_close(pc.value, g.value, big), (float(pc.value),
                                                 float(g.value))
    assert _ulps_close(pc.period, g.period, p0, float(nows.max())), (
        float(pc.period), float(g.period))


def test_global_tier_update_is_jaxs():
    g = _jcounter(10.0, 100.0, 50, True)
    pg = K.GlobalCounter(torch.tensor(10.0), torch.tensor(100.0),
                         torch.tensor(50, dtype=torch.int32),
                         torch.tensor(True))
    for total, now, rate in [(3.0, 80, 0.25), (0.0, 70, 1.0), (7.0, 2000, 0.0)]:
        g = J.global_tier_update(g, jnp.float32(total), jnp.int32(now),
                                 jnp.float32(rate))
        pg = P.global_tier_update(pg, total, now, rate)
        assert float(pg.value) == float(g.value)
        assert _ulps_close(pg.period, g.period, 2000.0)
        assert int(pg.last_ts) == int(g.last_ts) and bool(pg.exists)


def test_global_tier_rejects_unknown_cadence():
    with pytest.raises(ValueError, match="sync_cadence"):
        K.global_tier(torch.zeros((1, 2, 8)),
                      torch.zeros((1, 8), dtype=torch.int32),
                      torch.zeros((1,), dtype=torch.int32),
                      K.init_global_counter(), 0.0, "hourly")


# -- the step builders ------------------------------------------------------------------
PER = 16


def _jstate(jmesh, n):
    sh = NamedSharding(jmesh, JP(JAXIS))
    return JK.BucketState(
        tokens=jax.device_put(jnp.zeros((n,), jnp.float32), sh),
        last_ts=jax.device_put(jnp.zeros((n,), jnp.int32), sh),
        exists=jax.device_put(jnp.zeros((n,), bool), sh))


def _jcounter_on(jmesh):
    return jax.device_put(J.init_global_counter(),
                          NamedSharding(jmesh, JP()))


def _batch(rng, k, b, max_count=4):
    """Seeded ``[S, K, B]`` batch: repeated slots, padding (invalid rows),
    out-of-range slots."""
    slots = rng.integers(0, PER, (S, k, b)).astype(np.int32)
    slots[rng.random((S, k, b)) < 0.05] = PER + 3  # out of the shard
    counts = rng.integers(0, max_count, (S, k, b)).astype(np.int32)
    valid = rng.random((S, k, b)) < 0.85
    return slots, counts, valid


def _same_state(pst, jst):
    np.testing.assert_allclose(pst.tokens.numpy(), np.asarray(jst.tokens),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_array_equal(pst.last_ts.numpy(), np.asarray(jst.last_ts))
    np.testing.assert_array_equal(pst.exists.numpy(), np.asarray(jst.exists))


@pytest.mark.parametrize("dup", [True, False])
def test_sharded_acquire_step_matches_jax(jmesh, mesh, dup):
    rng = np.random.default_rng(7)
    jstep = J.make_sharded_acquire_step(jmesh, handle_duplicates=dup)
    pstep = P.make_sharded_acquire_step(mesh, handle_duplicates=dup)
    jst = _jstate(jmesh, S * PER)
    pst = K.init_bucket_state(S * PER)
    for i in range(4):
        slots, counts, valid = _batch(rng, 1, 8)
        now = 5_000 + 700 * i
        jst, jg, jr = jstep(jst, slots[:, 0], counts[:, 0], valid[:, 0],
                            jnp.int32(now), jnp.float32(6.0),
                            jnp.float32(0.01))
        pst, pg, pr = pstep(pst, slots[:, 0], counts[:, 0], valid[:, 0],
                            now, 6.0, 0.01)
        np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=RTOL,
                                   atol=1e-6)
        _same_state(pst, jst)


def test_two_level_step_matches_jax(jmesh, mesh):
    rng = np.random.default_rng(11)
    jstep = J.make_two_level_step(jmesh)
    pstep = P.make_two_level_step(mesh)
    jst, jg = _jstate(jmesh, S * PER), _jcounter_on(jmesh)
    pst, pg = K.init_bucket_state(S * PER), K.init_global_counter()
    for i in range(5):
        slots, counts, valid = _batch(rng, 1, 16)
        now = 3_000 + 517 * i
        jst, jgr, jrem, jg = jstep(
            jst, slots[:, 0], counts[:, 0], valid[:, 0], jnp.int32(now),
            jnp.float32(5.0), jnp.float32(0.02), jg, jnp.float32(0.3))
        pst, pgr, prem, pg = pstep(pst, slots[:, 0], counts[:, 0],
                                   valid[:, 0], now, 5.0, 0.02, pg, 0.3)
        np.testing.assert_array_equal(pgr.numpy(), np.asarray(jgr))
        np.testing.assert_allclose(prem.numpy(), np.asarray(jrem),
                                   rtol=RTOL, atol=1e-6)
        _same_state(pst, jst)
        assert _ulps_close(pg.value, jg.value, 5.0 * S * 16)
        assert _ulps_close(pg.period, jg.period, now)


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("dup", [True, False])
def test_two_level_scan_steps_match_jax(jmesh, mesh, deferred, dup):
    rng = np.random.default_rng(23 + deferred + 2 * dup)
    jf = (J.make_two_level_scan_step_deferred if deferred
          else J.make_two_level_scan_step)
    pf = (P.make_two_level_scan_step_deferred if deferred
          else P.make_two_level_scan_step)
    jstep, pstep = jf(jmesh, handle_duplicates=dup), pf(
        mesh, handle_duplicates=dup)
    jst, jg = _jstate(jmesh, S * PER), _jcounter_on(jmesh)
    pst, pg = K.init_bucket_state(S * PER), K.init_global_counter()
    t = 1_000
    for _ in range(3):
        k = int(rng.choice([1, 3, 8]))
        slots, counts, valid = _batch(rng, k, 8)
        nows = (t + np.cumsum(rng.integers(0, 400, k))).astype(np.int32)
        t = int(nows[-1])
        jst, jgr, jrem, jg = jstep(
            jst, slots, counts, valid, jnp.asarray(nows), jnp.float32(4.0),
            jnp.float32(0.25), jg, jnp.float32(0.125))
        pst, pgr, prem, pg = pstep(pst, slots, counts, valid, nows, 4.0,
                                   0.25, pg, 0.125)
        np.testing.assert_array_equal(pgr.numpy(), np.asarray(jgr))
        np.testing.assert_allclose(prem.numpy(), np.asarray(jrem),
                                   rtol=RTOL, atol=1e-6)
        _same_state(pst, jst)
        assert _ulps_close(pg.value, jg.value, 4.0 * S * 8 * k)
        assert _ulps_close(pg.period, jg.period, t)


@pytest.mark.parametrize("interpolate", [True, False])
def test_window_scan_step_matches_jax(jmesh, mesh, interpolate):
    rng = np.random.default_rng(31 + interpolate)
    jstep = J.make_sharded_window_scan_step(jmesh, interpolate=interpolate)
    pstep = P.make_sharded_window_scan_step(mesh, interpolate=interpolate)
    sh = NamedSharding(jmesh, JP(JAXIS))
    init = JK.init_window_state(S * PER)
    jst = JK.WindowState(*(jax.device_put(a, sh) for a in init))
    pst = K.init_window_state(S * PER)
    t = 2_048
    limit, wt = 7.0, 1024
    for _ in range(4):
        k = int(rng.choice([1, 2, 4]))
        slots, counts, valid = _batch(rng, k, 8, max_count=3)
        nows = (t + np.cumsum(rng.integers(0, 600, k))).astype(np.int32)
        t = int(nows[-1])
        jst, jgr, jrem = jstep(jst, slots, counts, valid, jnp.asarray(nows),
                               jnp.float32(limit), jnp.int32(wt))
        pst, pgr, prem = pstep(pst, slots, counts, valid, nows, limit, wt)
        np.testing.assert_array_equal(pgr.numpy(), np.asarray(jgr))
        np.testing.assert_allclose(prem.numpy(), np.asarray(jrem),
                                   atol=1.5 * float(np.spacing(
                                       np.float32(limit))))
        for f in ("prev_count", "curr_count", "window_idx", "exists"):
            np.testing.assert_array_equal(getattr(pst, f).numpy(),
                                          np.asarray(getattr(jst, f)))


def test_window_step_without_duplicates_is_not_ported(mesh):
    with pytest.raises(NotImplementedError, match="handle_duplicates"):
        P.make_sharded_window_scan_step(mesh, handle_duplicates=False)


# -- the stores against their JAX twins ---------------------------------------------------
def _compare_results(got, want, *, atol=0.0):
    g_granted = np.array([r.granted for r in got])
    w_granted = np.array([r.granted for r in want])
    np.testing.assert_array_equal(g_granted, w_granted)
    np.testing.assert_allclose([r.remaining for r in got],
                               [r.remaining for r in want], rtol=RTOL,
                               atol=max(atol, 1e-6))


def _bucket_schedule(jstore, pstore, jclock, pclock, rng, keys, *,
                     cap, tier_tol):
    """The seeded mixed schedule on both stores: scalar batches, bulks with
    repeats and zero-permit probes, peeks, sweeps and clock jumps."""
    for step in range(14):
        d = int(rng.integers(0, 2 * TICKS_PER_SECOND))
        if step == 9:
            d = 3600 * TICKS_PER_SECOND  # every bucket refills: sweeps free
        jclock.advance_ticks(d)
        pclock.advance_ticks(d)
        op = step % 4
        m = int(rng.integers(1, 48))
        ks = [keys[i] for i in rng.integers(0, len(keys), m)]
        cs = [int(c) for c in rng.integers(0, 5, m)]
        if op == 0:
            _compare_results(pstore.acquire_batch_blocking(list(zip(ks, cs))),
                             jstore.acquire_batch_blocking(list(zip(ks, cs))))
        elif op in (1, 2):
            wr = op == 1
            a = pstore.acquire_many_blocking(ks, cs, with_remaining=wr)
            b = jstore.acquire_many_blocking(ks, cs, with_remaining=wr)
            np.testing.assert_array_equal(a.granted, b.granted)
            if wr:
                np.testing.assert_allclose(a.remaining, b.remaining,
                                           rtol=RTOL, atol=1e-6)
            else:
                assert a.remaining is None
        else:
            assert pstore.sweep() == jstore.sweep()
        for k in ks[:4] + ["never-seen"]:
            assert pstore.peek_blocking(k) == jstore.peek_blocking(k)
        assert _ulps_close(pstore.global_score, jstore.global_score,
                           tier_tol)
        assert pstore.per_shard == jstore.per_shard
    _same_keys(pstore, jstore)


def _same_keys(pstore, jstore):
    """The same keys on the same shards. Which local slot a key holds is
    not a contract: the fused C resolve (the port, whose directory library
    is built with Python.h) and the split one allocate in different
    orders (JAX's ``test_fused_and_split_resolve_agree``)."""
    pd, jd = pstore.directory, jstore.directory
    assert {k: v[0] for k, v in pd.items()} == {k: v[0] for k, v in jd.items()}


@pytest.mark.parametrize("cadence", ["batch", "launch"])
@pytest.mark.parametrize("seed", range(3))
def test_sharded_store_matches_jax(jmesh, mesh, seed, cadence):
    rng = np.random.default_rng(40 + seed)
    jclock, pclock = JClock(start_ticks=9_000), ManualClock(start_ticks=9_000)
    kw = dict(per_shard_slots=4, sync_cadence=cadence)
    jstore = J.ShardedDeviceStore(jmesh, 12.0, 3.0, clock=jclock, **kw)
    pstore = P.ShardedDeviceStore(mesh, 12.0, 3.0, clock=pclock, **kw)
    keys = [f"k{i}" for i in range(90)]
    _bucket_schedule(jstore, pstore, jclock, pclock, rng, keys, cap=12.0,
                     tier_tol=4.0 * 48 * 14)
    assert pstore.per_shard > 4  # growth happened
    # A forced rebase of both, then more traffic.
    for s, c in ((jstore, jclock), (pstore, pclock)):
        s.force_rebase(5_000)
        c.rebase(5_000)
    _bucket_schedule(jstore, pstore, jclock, pclock, rng, keys, cap=12.0,
                     tier_tol=4.0 * 48 * 28)
    # Snapshots restore into a fresh store of the OTHER package.
    for src, dst, dclock in (
            (jstore, P.ShardedDeviceStore(mesh, 12.0, 3.0,
                                          clock=ManualClock(start_ticks=77),
                                          per_shard_slots=4), None),
            (pstore, J.ShardedDeviceStore(jmesh, 12.0, 3.0,
                                          clock=JClock(start_ticks=77),
                                          per_shard_slots=4), None)):
        dst.restore(src.snapshot())
        assert dst.per_shard == src.per_shard
        assert dst.directory == src.directory
        for k in keys:
            assert dst.peek_blocking(k) == pstore.peek_blocking(k)
        assert _ulps_close(dst.global_score, src.global_score, 1.0)


def _window_schedule(jstore, pstore, jclock, pclock, rng, keys, limit):
    tol = 1.5 * float(np.spacing(np.float32(limit)))
    for step in range(12):
        d = int(rng.integers(0, TICKS_PER_SECOND))
        if step == 8:
            d = 5 * TICKS_PER_SECOND  # two whole windows idle: sweeps free
        jclock.advance_ticks(d)
        pclock.advance_ticks(d)
        m = int(rng.integers(1, 40))
        ks = [keys[i] for i in rng.integers(0, len(keys), m)]
        cs = [int(c) for c in rng.integers(0, 4, m)]
        if step % 3 == 2:
            assert pstore.sweep() == jstore.sweep()
        if step % 2:
            _compare_results(pstore.acquire_batch_blocking(list(zip(ks, cs))),
                             jstore.acquire_batch_blocking(list(zip(ks, cs))),
                             atol=tol)
        else:
            a = pstore.acquire_many_blocking(ks, cs)
            b = jstore.acquire_many_blocking(ks, cs)
            np.testing.assert_array_equal(a.granted, b.granted)
            np.testing.assert_allclose(a.remaining, b.remaining, atol=tol)
        assert pstore.per_shard == jstore.per_shard
    _same_keys(pstore, jstore)


@pytest.mark.parametrize("fixed", [False, True])
def test_sharded_window_store_matches_jax(jmesh, mesh, fixed):
    rng = np.random.default_rng(60 + fixed)
    jclock, pclock = JClock(start_ticks=4_096), ManualClock(start_ticks=4_096)
    jstore = J.ShardedWindowStore(jmesh, limit=6.0, window_sec=1.0,
                                  fixed=fixed, per_shard_slots=4,
                                  clock=jclock)
    pstore = P.ShardedWindowStore(mesh, limit=6.0, window_sec=1.0,
                                  fixed=fixed, per_shard_slots=4,
                                  clock=pclock)
    keys = [f"w{i}" for i in range(70)]
    _window_schedule(jstore, pstore, jclock, pclock, rng, keys, 6.0)
    assert pstore.per_shard > 4
    for s, c in ((jstore, jclock), (pstore, pclock)):
        s.force_rebase(3 * TICKS_PER_SECOND + 5)
        c.rebase(3 * TICKS_PER_SECOND + 5)
    _window_schedule(jstore, pstore, jclock, pclock, rng, keys, 6.0)
    # Cross-package restores, then the same next decisions.
    jnew = J.ShardedWindowStore(jmesh, limit=6.0, window_sec=1.0,
                                fixed=fixed, per_shard_slots=4,
                                clock=JClock(start_ticks=pclock.now_ticks()))
    pnew = P.ShardedWindowStore(mesh, limit=6.0, window_sec=1.0,
                                fixed=fixed, per_shard_slots=4,
                                clock=ManualClock(
                                    start_ticks=jclock.now_ticks()))
    jnew.restore(pstore.snapshot())
    pnew.restore(jstore.snapshot())
    a = pnew.acquire_many_blocking(keys, [1] * len(keys))
    b = jnew.acquire_many_blocking(keys, [1] * len(keys))
    np.testing.assert_array_equal(a.granted, b.granted)


# -- the JAX file's surface (tests/test_sharded.py) on the port ------------------------
def test_sharded_agrees_with_serial(mesh, clock):
    rng = np.random.default_rng(0)
    sharded = P.ShardedDeviceStore(mesh, 20.0, 8.0, per_shard_slots=64,
                                   clock=clock)
    ref = InProcessBucketStore(clock=clock)
    for _ in range(15):
        clock.advance_ticks(int(rng.integers(0, TICKS_PER_SECOND)))
        keys = [f"k{i}" for i in rng.choice(40, size=24, replace=False)]
        counts = [int(c) for c in rng.integers(0, 6, size=24)]
        got = sharded.acquire_batch_blocking(list(zip(keys, counts)))
        want = [ref.acquire_blocking(k, c, 20.0, 8.0)
                for k, c in zip(keys, counts)]
        for g, w in zip(got, want):
            assert g.granted == w.granted
            assert abs(g.remaining - w.remaining) < 1e-2


def test_global_tier_sums_all_shards(mesh, clock):
    sharded = P.ShardedDeviceStore(mesh, 10.0, 0.0, per_shard_slots=16,
                                   clock=clock)
    results = sharded.acquire_batch_blocking([(f"k{i}", 2) for i in range(32)],
                                             decay_rate_per_sec=0.0)
    assert all(r.granted for r in results)
    assert sharded.global_score == 64.0


def test_global_tier_decays(mesh, clock):
    sharded = P.ShardedDeviceStore(mesh, 10.0, 0.0, per_shard_slots=16,
                                   clock=clock)
    sharded.acquire_batch_blocking([("a", 4)], decay_rate_per_sec=2.0)
    assert sharded.global_score == 4.0
    clock.advance_seconds(1.0)
    sharded.acquire_batch_blocking([("b", 0)], decay_rate_per_sec=2.0)
    assert abs(sharded.global_score - 2.0) < 1e-3


def test_per_key_independence_across_shards(mesh, clock):
    sharded = P.ShardedDeviceStore(mesh, 5.0, 0.0, per_shard_slots=16,
                                   clock=clock)
    reqs = [(f"k{i}", 5) for i in range(16)]
    assert all(r.granted for r in sharded.acquire_batch_blocking(reqs))
    assert not any(r.granted for r in sharded.acquire_batch_blocking(reqs))


def test_sweep_reclaims_across_shards(mesh, clock):
    sharded = P.ShardedDeviceStore(mesh, 10.0, 10.0, per_shard_slots=8,
                                   clock=clock)
    sharded.acquire_batch_blocking([(f"k{i}", 1) for i in range(20)])
    assert len(sharded.directory) == 20
    clock.advance_seconds(5.0)
    assert sharded.sweep() == 20
    assert len(sharded.directory) == 0


def test_duplicate_keys_in_one_batch_never_over_admit(mesh, clock):
    sharded = P.ShardedDeviceStore(mesh, 5.0, 0.0, per_shard_slots=16,
                                   clock=clock)
    results = sharded.acquire_batch_blocking([("hot", 1)] * 12)
    assert sum(r.granted for r in results) == 5


def test_shard_overflow_grows_and_keeps_serving(mesh, clock):
    tiny = P.ShardedDeviceStore(mesh, 10.0, 5.0, per_shard_slots=2,
                                clock=clock)
    res = tiny.acquire_batch_blocking([(f"x{i}", 1) for i in range(64)])
    assert all(r.granted for r in res)
    assert tiny.per_shard > 2 and tiny.metrics.pregrows > 0
    assert len(tiny.directory) == 64
    res2 = tiny.acquire_batch_blocking([(f"x{i}", 10) for i in range(64)])
    assert not any(r.granted for r in res2)
    res3 = tiny.acquire_batch_blocking([(f"y{i}", 1) for i in range(32)])
    assert all(r.granted for r in res3)


def test_growth_preserves_balances_exactly(mesh, clock):
    store = P.ShardedDeviceStore(mesh, 100.0, 0.0, per_shard_slots=4,
                                 clock=clock)
    store.acquire_batch_blocking([("a", 30), ("b", 7)])
    before = {k: store.peek_blocking(k) for k in ("a", "b")}
    store._grow()
    after = {k: store.peek_blocking(k) for k in ("a", "b")}
    assert before == after == {"a": 70.0, "b": 93.0}


class TestShardedBulk:
    def test_bulk_agrees_with_serial(self, mesh, clock):
        rng = np.random.default_rng(0)
        sharded = P.ShardedDeviceStore(mesh, 20.0, 8.0, per_shard_slots=64,
                                       clock=clock)
        ref = InProcessBucketStore(clock=clock)
        for _ in range(5):
            clock.advance_ticks(int(rng.integers(0, TICKS_PER_SECOND)))
            keys = [f"k{i}" for i in rng.choice(60, size=40, replace=False)]
            counts = [int(c) for c in rng.integers(0, 6, size=40)]
            got = sharded.acquire_many_blocking(keys, counts)
            want = [ref.acquire_blocking(k, c, 20.0, 8.0)
                    for k, c in zip(keys, counts)]
            for g, w in zip(got, want):
                assert g.granted == w.granted
                assert abs(g.remaining - w.remaining) < 1e-2

    def test_bulk_multi_chunk_when_shard_load_exceeds_width(self, mesh,
                                                            clock):
        sharded = P.ShardedDeviceStore(mesh, 1e9, 0.0, per_shard_slots=2048,
                                       clock=clock)
        sharded._BULK_B = 8
        n = 4096
        res = sharded.acquire_many_blocking([f"bk{i}" for i in range(n)],
                                            [1] * n, with_remaining=False)
        assert res.remaining is None and res.granted.all()
        assert sharded.metrics.launches > 1

    def test_bulk_chunks_fit_the_cards_decision(self, mesh):
        """A chunk's batch holds at most SCAN_MAX_BATCH rows of all shards
        and a launch SCAN_MAX_ROWS (the card's scan), on the CPU too."""
        store = P.ShardedDeviceStore(mesh, 5.0, 1.0, per_shard_slots=16)
        from distributedratelimiting.redis_tpu_torch.ops import (
            cuda_kernels as ck,
        )

        for rows in (1, 9, 700, 1024, 5000, 100_000):
            b, max_k = store._chunk_geometry(rows)
            assert S * b <= ck.SCAN_MAX_BATCH
            assert max_k * S * b <= ck.SCAN_MAX_ROWS
        assert store._chunk_geometry(5000) == (1024, 16)
        assert store._chunk_geometry(9) == (16, 32)

    def test_bulk_duplicates_never_over_admit(self, mesh, clock):
        sharded = P.ShardedDeviceStore(mesh, 5.0, 0.0, per_shard_slots=16,
                                       clock=clock)
        res = sharded.acquire_many_blocking(["hot"] * 12, [1] * 12)
        assert int(res.granted.sum()) == 5

    def test_bulk_zero_count_probe_granted(self, mesh, clock):
        sharded = P.ShardedDeviceStore(mesh, 3.0, 0.0, per_shard_slots=16,
                                       clock=clock)
        res = sharded.acquire_many_blocking(["p"] * 5, [3, 3, 0, 1, 0])
        assert res.granted.tolist() == [True, False, True, False, True]

    def test_bulk_feeds_global_tier(self, mesh, clock):
        sharded = P.ShardedDeviceStore(mesh, 10.0, 0.0, per_shard_slots=16,
                                       clock=clock)
        res = sharded.acquire_many_blocking(
            [f"g{i}" for i in range(32)], [2] * 32, decay_rate_per_sec=0.0)
        assert res.granted.all()
        assert sharded.global_score == 64.0


class TestShardedWindowStore:
    def test_agrees_with_serial_sliding_window(self, mesh, clock):
        rng = np.random.default_rng(0)
        ws = P.ShardedWindowStore(mesh, limit=10.0, window_sec=1.0,
                                  per_shard_slots=32, clock=clock)
        ref = InProcessBucketStore(clock=clock)
        for _ in range(8):
            clock.advance_ticks(int(rng.integers(0, TICKS_PER_SECOND // 2)))
            keys = [f"w{i}" for i in rng.choice(30, size=20, replace=False)]
            counts = [int(c) for c in rng.integers(0, 4, size=20)]
            got = ws.acquire_many_blocking(keys, counts)
            want = [ref.window_acquire_blocking(k, c, 10.0, 1.0)
                    for k, c in zip(keys, counts)]
            for g, w in zip(got, want):
                assert g.granted == w.granted

    def test_fixed_window_semantics(self, mesh, clock):
        ws = P.ShardedWindowStore(mesh, limit=3.0, window_sec=1.0,
                                  fixed=True, per_shard_slots=16,
                                  clock=clock)
        res = ws.acquire_many_blocking(["f"] * 4, [1] * 4)
        assert res.granted.tolist() == [True, True, True, False]
        clock.advance_seconds(1.0)
        assert ws.acquire_many_blocking(["f"], [3]).granted[0]

    def test_growth_and_sweep(self, mesh, clock):
        ws = P.ShardedWindowStore(mesh, limit=5.0, window_sec=1.0,
                                  per_shard_slots=2, clock=clock)
        res = ws.acquire_many_blocking([f"wk{i}" for i in range(64)],
                                       [1] * 64)
        assert res.granted.all() and ws.per_shard > 2
        clock.advance_seconds(3.0)
        assert ws.sweep() == 64
        assert len(ws.directory) == 0

    def test_standalone_clock_overflow_rebases(self, mesh):
        clock = ManualClock(start_ticks=2**30 - 10)
        ws = P.ShardedWindowStore(mesh, limit=5.0, window_sec=1.0,
                                  per_shard_slots=16, clock=clock)
        assert ws.acquire_many_blocking(["o"], [5]).granted[0]
        clock.advance_ticks(100)
        assert not ws.acquire_many_blocking(["o"], [1]).granted[0]
        assert clock.now_ticks() < 2**30

    def test_snapshot_restore_across_epochs(self, mesh):
        a = P.ShardedWindowStore(mesh, limit=4.0, window_sec=1.0,
                                 per_shard_slots=16,
                                 clock=ManualClock(
                                     start_ticks=5 * TICKS_PER_SECOND))
        a.acquire_many_blocking(["s"], [4])
        b = P.ShardedWindowStore(mesh, limit=4.0, window_sec=1.0,
                                 per_shard_slots=16,
                                 clock=ManualClock(
                                     start_ticks=TICKS_PER_SECOND))
        b.restore(a.snapshot())
        assert not b.acquire_many_blocking(["s"], [1]).granted[0]

    def test_without_duplicate_serialization_is_not_ported(self, mesh):
        with pytest.raises(NotImplementedError):
            P.ShardedWindowStore(mesh, limit=4.0, window_sec=1.0,
                                 handle_duplicates=False)


def test_fused_and_split_resolve_agree(mesh, clock):
    a = P.ShardedDeviceStore(mesh, 10.0, 1.0, per_shard_slots=4, clock=clock)
    b = P.ShardedDeviceStore(mesh, 10.0, 1.0, per_shard_slots=4, clock=clock)
    b._resolve_batch_fused = lambda keys: None  # force the split path
    keys = [f"rk{i}" for i in range(96)] + ["rk0", "rk5"]
    sa, la = a._resolve_batch(list(keys))
    sb, lb = b._resolve_batch(list(keys))
    np.testing.assert_array_equal(sa, sb)
    assert a.per_shard == b.per_shard
    for sh, lo, store in ((sa, la, a), (sb, lb, b)):
        assert lo[96] == lo[0] and sh[96] == sh[0]
        assert lo[97] == lo[5] and sh[97] == sh[5]
        for i in (0, 7, 42, 95):
            assert store.dirs[sh[i]].lookup(keys[i]) == lo[i]
        sh2, lo2 = store._resolve_batch(list(keys))
        np.testing.assert_array_equal(sh, sh2)
        np.testing.assert_array_equal(lo, lo2)


def test_mesh_bulk_accepts_keyblob(mesh):
    store = P.ShardedDeviceStore(mesh, 4.0, 1e-9, per_shard_slots=64)
    keys = [f"zb{i % 50}" for i in range(400)]
    res = store.acquire_many_blocking(_blob(keys), [1] * 400)
    assert int(res.granted.sum()) == 200
    assert int(store.acquire_many_blocking(keys, [1] * 400).granted.sum()) == 0


def test_fused_blob_resolve_matches_list_resolve(mesh):
    a = P.ShardedDeviceStore(mesh, 10.0, 1.0, per_shard_slots=64)
    b = P.ShardedDeviceStore(mesh, 10.0, 1.0, per_shard_slots=64)
    keys = [f"fz{i % 60}" for i in range(200)]
    keys.append(b"\xff\x80odd".decode("utf-8", "surrogateescape"))
    with a._lock, b._lock:
        sh_v, lo_v = a._resolve_batch(_blob(keys))
        sh_l, lo_l = b._resolve_batch(list(keys))
    assert (sh_v == sh_l).all() and (lo_v == lo_l).all()


class TestShardedSnapshotRestore:
    def test_roundtrip_across_clock_epochs(self, mesh):
        s1 = P.ShardedDeviceStore(mesh, capacity=10.0, fill_rate_per_sec=1.0,
                                  per_shard_slots=16,
                                  clock=ManualClock(start_ticks=300_000))
        s1.acquire_batch_blocking([("k0", 10), ("k1", 4)])
        c2 = ManualClock(start_ticks=50)
        s2 = P.ShardedDeviceStore(mesh, capacity=10.0, fill_rate_per_sec=1.0,
                                  per_shard_slots=16, clock=c2)
        s2.restore(s1.snapshot())
        r0, r1 = s2.acquire_batch_blocking([("k0", 5), ("k1", 6)])
        assert not r0.granted and r1.granted
        c2.advance_seconds(5.0)
        assert s2.acquire_batch_blocking([("k0", 5)])[0].granted

    def test_shard_count_mismatch_rejected(self, mesh):
        a = P.ShardedDeviceStore(Mesh(["cpu"] * 4), capacity=5.0,
                                 fill_rate_per_sec=1.0, per_shard_slots=16)
        b = P.ShardedDeviceStore(mesh, capacity=5.0, fill_rate_per_sec=1.0,
                                 per_shard_slots=16)
        with pytest.raises(ValueError, match="geometry"):
            b.restore(a.snapshot())

    def test_post_growth_snapshot_restores_into_fresh_store(self, mesh):
        a = P.ShardedDeviceStore(mesh, capacity=10.0, fill_rate_per_sec=0.0,
                                 per_shard_slots=2, clock=ManualClock())
        a.acquire_batch_blocking([(f"k{i}", 7) for i in range(64)])
        assert a.per_shard > 2
        b = P.ShardedDeviceStore(mesh, capacity=10.0, fill_rate_per_sec=0.0,
                                 per_shard_slots=2, clock=ManualClock())
        b.restore(a.snapshot())
        assert b.per_shard == a.per_shard
        r0, r1 = b.acquire_batch_blocking([("k0", 3), ("k1", 4)])
        assert r0.granted and not r1.granted
        res = b.acquire_batch_blocking(
            [(f"fresh{i}", 1) for i in range(8 * b.per_shard * S // 4)])
        assert all(r.granted for r in res)

    def test_config_mismatch_rejected(self, mesh):
        a = P.ShardedDeviceStore(mesh, capacity=10.0, fill_rate_per_sec=1.0,
                                 per_shard_slots=16)
        b = P.ShardedDeviceStore(mesh, capacity=100.0, fill_rate_per_sec=50.0,
                                 per_shard_slots=16)
        with pytest.raises(ValueError, match="config"):
            b.restore(a.snapshot())


class TestSyncCadenceOption:
    def test_launch_cadence_matches_batch(self, mesh):
        keys = [f"c{i}" for i in range(200)]
        outs = {}
        for cadence in ("batch", "launch"):
            store = P.ShardedDeviceStore(mesh, capacity=5.0,
                                         fill_rate_per_sec=0.0,
                                         per_shard_slots=64,
                                         clock=ManualClock(),
                                         sync_cadence=cadence)
            res = store.acquire_many_blocking(keys, [2] * len(keys))
            outs[cadence] = (np.asarray(res.granted), store.global_score)
        np.testing.assert_array_equal(outs["batch"][0], outs["launch"][0])
        assert outs["batch"][1] == outs["launch"][1] == 400.0

    def test_invalid_cadence_rejected(self, mesh):
        with pytest.raises(ValueError, match="sync_cadence"):
            P.ShardedDeviceStore(mesh, capacity=5.0, fill_rate_per_sec=1.0,
                                 per_shard_slots=16, sync_cadence="never")


def test_large_scalar_batch_is_consecutive_batches(mesh, clock):
    """A scalar batch of more rows than one decision batch holds
    (SCAN_MAX_BATCH) is decided as consecutive batches, one launch each."""
    from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck

    store = P.ShardedDeviceStore(mesh, 1e6, 0.0, per_shard_slots=2048,
                                 clock=clock)
    n = ck.SCAN_MAX_BATCH + 100
    res = store.acquire_batch_blocking([(f"s{i}", 1) for i in range(n)])
    assert all(r.granted for r in res)
    assert store.metrics.launches == 2
    assert store.global_score == float(n)
