"""The port's mesh-sharded fingerprint tables (``parallel/fp_sharded.py``)
against the JAX package's, on the CPU.

JAX runs on the 8 virtual CPU devices of ``tests/conftest.py``; the port on
a ``Mesh`` of 8 x ``cpu``, its fingerprint table one shard-major table of 8
shard regions (``ops/fp_directory.py``'s ``n_shards``), the plain versions
deciding.

- The shard regions: the plain resolve with ``n_shards`` places each key in
  region ``lo % n_shards`` exactly where JAX's per-shard table places it,
  cell for cell (the plain versions keep JAX's last-claimant rule), and
  ``n_shards = 1`` is the one-table placement.
- Every step builder (scan with both cadences, window scan sliding and
  fixed, migrate, peek) on seeded ``[S, K, B]`` batches with repeated keys,
  zero counts and padding: results equal (remaining within 1e-6 relative,
  window remaining within 1.5 ulps of the limit), tables equal cell for cell
  and state equal (``find_np`` by key too), the counter within 2 ulps.
- The stores, ``ShardedFpDeviceStore`` (both cadences) and
  ``ShardedFpWindowStore`` (sliding and fixed), against their JAX twins over
  a seeded schedule with repeats, probes, peeks, sweeps and growth, then a
  snapshot restored into the OTHER package.
- The JAX file ``tests/test_fp_sharded.py``'s surface on the port.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as JP

from distributedratelimiting.redis_tpu.ops import fp_directory as JF
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.parallel import fp_sharded as JS
from distributedratelimiting.redis_tpu.parallel import sharded_store as JSS
from distributedratelimiting.redis_tpu.parallel.mesh import (
    SHARD_AXIS as JAXIS,
    create_mesh as jcreate_mesh,
)
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.parallel import fp_sharded as PS
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh
from distributedratelimiting.redis_tpu_torch.runtime.clock import ManualClock
from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
    FingerprintBucketStore,
    fingerprints,
)

S = 8
L = 8
PER = 64
RTOL = 1e-6


@pytest.fixture(scope="module")
def jmesh():
    return jcreate_mesh(S)


@pytest.fixture(scope="module")
def mesh():
    return Mesh(["cpu"] * S)


def _routed(rng, m, s_n=S):
    """``m`` distinct nonzero fingerprints per shard, routed (lo % S = s):
    ``u32[S, m, 2]``."""
    fps = rng.integers(1, 2**32, (s_n * m * 4, 2), dtype=np.uint64).astype(
        np.uint32)
    fps = np.unique(fps, axis=0)
    rng.shuffle(fps)
    out = np.zeros((s_n, m, 2), np.uint32)
    for s in range(s_n):
        sel = fps[fps[:, 0] % s_n == s][:m]
        assert len(sel) == m
        out[s] = sel
    return out


def _fused(rng, keys, k, b, *, max_count=4, pad=0.1):
    """``u32[S, K, B, 3]``: each shard's rows drawn from its own keys (with
    repeats), zero counts, padding rows."""
    s_n, m, _ = keys.shape
    fused = np.zeros((s_n, k, b, 3), np.uint32)
    idx = rng.integers(0, m, (s_n, k, b))
    for s in range(s_n):
        fused[s, ..., :2] = keys[s][idx[s]]
    fused[..., 2] = rng.integers(0, max_count, (s_n, k, b)).astype(np.uint32)
    fused[rng.random((s_n, k, b)) < pad, 2] = np.uint32(0xFFFFFFFF)
    return fused


def _jput(jmesh, arr, spec):
    return jax.device_put(jnp.asarray(arr), NamedSharding(jmesh, spec))


def _jtables(jmesh, window=False):
    n = S * PER
    fp = _jput(jmesh, JF.init_fp_table(n), JP(JAXIS, None))
    init = JK.init_window_state(n) if window else JK.init_bucket_state(n)
    st = type(init)(*(_jput(jmesh, a, JP(JAXIS)) for a in init))
    return fp, st


def _ptables(window=False):
    n = S * PER
    init = K.init_window_state(n) if window else K.init_bucket_state(n)
    return F.init_fp_table(n), init


def _same_tables(pfp, pst, jfp, jst, *, atol=0.0):
    np.testing.assert_array_equal(pfp.numpy().view(np.uint32),
                                  np.asarray(jfp))
    for f in pst._fields:
        want = np.asarray(getattr(jst, f))
        got = getattr(pst, f).numpy()
        if got.dtype == np.float32:
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol)
        else:
            np.testing.assert_array_equal(got, want)


# -- the shard regions ----------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_shard_regions_place_as_jax_per_shard_tables(seed):
    """Region s of the port's one table equals JAX's table of shard s after
    the same rows (claims, repeats, window pressure), cell for cell."""
    rng = np.random.default_rng(seed)
    keys = _routed(rng, 40)
    per = 32  # 40 keys a shard into 32 cells: pressure, unresolved rows
    fp = F.init_fp_table(S * per)
    rows = keys[:, rng.integers(0, 40, 48)]  # [S, 48, 2] with repeats
    valid = rng.random((S, 48)) < 0.9
    out = F.fp_resolve(fp, torch.from_numpy(rows.reshape(-1, 2).view(
        np.int32)), torch.from_numpy(valid.reshape(-1)), probe_window=L,
        rounds=4, n_shards=S)
    slots = out.slots.numpy().reshape(S, 48)
    for s in range(S):
        jfp = JF.init_fp_table(per)
        jfp, jslots, jres = JF.fp_resolve_core(
            jfp, jnp.asarray(rows[s]), jnp.asarray(valid[s]),
            probe_window=L, rounds=4)
        np.testing.assert_array_equal(
            fp.numpy().view(np.uint32)[s * per:(s + 1) * per],
            np.asarray(jfp))
        np.testing.assert_array_equal(
            out.resolved.numpy().reshape(S, 48)[s], np.asarray(jres))
        js = np.asarray(jslots)
        np.testing.assert_array_equal(
            np.where(js >= 0, js + s * per, -1)[valid[s]],
            slots[s][valid[s]])
    assert F.check_table_np(fp.numpy().view(np.uint32), L, S) > 0
    live = keys.reshape(-1, 2)
    found = F.find_np(fp.numpy().view(np.uint32), live, L, S)
    assert ((found < 0) | (found // per == live[:, 0] % S)).all()


def test_one_shard_is_the_one_table_placement():
    rng = np.random.default_rng(5)
    fps = rng.integers(1, 2**32, (300, 2), dtype=np.uint64).astype(np.uint32)
    n = 4096
    np.testing.assert_array_equal(F.base_index_np(fps, n, 16, 1),
                                  F.base_index_np(fps, n, 16))
    a, b = F.init_fp_table(n), F.init_fp_table(n)
    kp = torch.from_numpy(fps.view(np.int32))
    valid = torch.ones(300, dtype=torch.bool)
    ra = F.fp_resolve(a, kp, valid, probe_window=16, rounds=4)
    rb = F.fp_resolve(b, kp, valid, probe_window=16, rounds=4, n_shards=1)
    assert torch.equal(a, b) and torch.equal(ra.slots, rb.slots)


def test_shard_regions_must_split_the_table():
    with pytest.raises(ValueError, match="shard regions"):
        F.fp_resolve(F.init_fp_table(100), torch.ones((1, 2), dtype=torch.int32),
                     torch.ones(1, dtype=torch.bool), probe_window=4,
                     rounds=1, n_shards=8)
    with pytest.raises(ValueError, match="probe_window"):
        F.fp_resolve(F.init_fp_table(64), torch.ones((1, 2), dtype=torch.int32),
                     torch.ones(1, dtype=torch.bool), probe_window=16,
                     rounds=1, n_shards=8)


# -- the step builders ---------------------------------------------------------------
@pytest.mark.parametrize("cadence", ["batch", "launch"])
def test_fp_scan_step_matches_jax(jmesh, mesh, cadence):
    rng = np.random.default_rng(3 if cadence == "batch" else 4)
    keys = _routed(rng, 24)
    jstep = JS.make_sharded_fp_scan_step(jmesh, probe_window=L,
                                         sync_cadence=cadence)
    pstep = PS.make_sharded_fp_scan_step(mesh, probe_window=L,
                                         sync_cadence=cadence)
    jfp, jst = _jtables(jmesh)
    jg = jax.device_put(JSS.init_global_counter(), NamedSharding(jmesh, JP()))
    pfp, pst = _ptables()
    pg = K.init_global_counter()
    t = 4_000
    for _ in range(4):
        k = int(rng.choice([1, 2, 4]))
        fused = _fused(rng, keys, k, 8)
        nows = (t + np.cumsum(rng.integers(0, 500, k))).astype(np.int32)
        t = int(nows[-1])
        jfp, jst, jout, jg = jstep(jfp, jst, jnp.asarray(fused),
                                   jnp.asarray(nows), jnp.float32(6.0),
                                   jnp.float32(0.02), jg, jnp.float32(0.5))
        pfp, pst, pout, pg = pstep(pfp, pst, fused, nows, 6.0, 0.02, pg, 0.5)
        np.testing.assert_array_equal(pout[:, :, 0].numpy(),
                                      np.asarray(jout)[:, :, 0])
        np.testing.assert_allclose(pout[:, :, 1].numpy(),
                                   np.asarray(jout)[:, :, 1], rtol=RTOL,
                                   atol=1e-6)
        _same_tables(pfp, pst, jfp, jst, atol=1e-6)
        spacing = float(np.spacing(np.float32(max(float(jg.value), t))))
        assert abs(float(pg.value) - float(jg.value)) <= 2 * spacing
        assert abs(float(pg.period) - float(jg.period)) <= 2 * spacing


@pytest.mark.parametrize("interpolate", [True, False])
def test_fp_window_scan_step_matches_jax(jmesh, mesh, interpolate):
    rng = np.random.default_rng(8 + interpolate)
    keys = _routed(rng, 20)
    jstep = JS.make_sharded_fp_window_scan_step(jmesh, probe_window=L,
                                                interpolate=interpolate)
    pstep = PS.make_sharded_fp_window_scan_step(mesh, probe_window=L,
                                                interpolate=interpolate)
    jfp, jst = _jtables(jmesh, window=True)
    pfp, pst = _ptables(window=True)
    t, limit = 3_000, 5.0
    for _ in range(4):
        k = int(rng.choice([1, 2, 4]))
        fused = _fused(rng, keys, k, 8, max_count=3)
        nows = (t + np.cumsum(rng.integers(0, 700, k))).astype(np.int32)
        t = int(nows[-1])
        jfp, jst, jout = jstep(jfp, jst, jnp.asarray(fused),
                               jnp.asarray(nows), jnp.float32(limit),
                               jnp.int32(1024))
        pfp, pst, pout = pstep(pfp, pst, fused, nows, limit, 1024)
        np.testing.assert_array_equal(pout[:, :, 0].numpy(),
                                      np.asarray(jout)[:, :, 0])
        np.testing.assert_allclose(
            pout[:, :, 1].numpy(), np.asarray(jout)[:, :, 1],
            atol=1.5 * float(np.spacing(np.float32(limit))))
        _same_tables(pfp, pst, jfp, jst)


def test_fp_migrate_and_peek_steps_match_jax(jmesh, mesh):
    rng = np.random.default_rng(12)
    keys = _routed(rng, 16)
    b = 16
    kpair = np.zeros((S, b, 2), np.uint32)
    kpair[:, :16] = keys
    tokens = rng.random((S, b)).astype(np.float32) * 5
    last_ts = rng.integers(0, 1000, (S, b)).astype(np.int32)
    exists = rng.random((S, b)) < 0.8
    valid = rng.random((S, b)) < 0.9
    jmig = JS.make_sharded_fp_migrate_step(jmesh, probe_window=L)
    pmig = PS.make_sharded_fp_migrate_step(mesh, probe_window=L)
    jfp, jst = _jtables(jmesh)
    pfp, pst = _ptables()
    jfp, jst, jplaced = jmig(jfp, jst, jnp.asarray(kpair), jnp.asarray(tokens),
                             jnp.asarray(last_ts), jnp.asarray(exists),
                             jnp.asarray(valid))
    pfp, pst, pplaced = pmig(pfp, pst, kpair, tokens, last_ts, exists, valid)
    np.testing.assert_array_equal(pplaced.numpy(), np.asarray(jplaced))
    _same_tables(pfp, pst, jfp, jst)
    jpeek = JS._make_sharded_fp_peek_step(jmesh, probe_window=L)
    ppeek = PS._make_sharded_fp_peek_step(mesh, probe_window=L)
    ghost = _routed(np.random.default_rng(99), 4)
    probe = np.concatenate([kpair[:, :12], ghost], axis=1)
    pvalid = np.ones((S, 16), bool)
    pvalid[:, 3] = False
    jest = jpeek(jfp, jst, jnp.asarray(probe), jnp.asarray(pvalid),
                 jnp.int32(1500), jnp.float32(5.0), jnp.float32(0.002))
    pest = ppeek(pfp, pst, probe, pvalid, 1500, 5.0, 0.002)
    np.testing.assert_array_equal(pest.numpy(), np.asarray(jest))


def test_fp_steps_without_duplicates_are_not_ported(mesh):
    with pytest.raises(NotImplementedError):
        PS.make_sharded_fp_scan_step(mesh, handle_duplicates=False)
    with pytest.raises(NotImplementedError):
        PS.make_sharded_fp_window_scan_step(mesh, handle_duplicates=False)
    with pytest.raises(ValueError, match="sync_cadence"):
        PS.make_sharded_fp_scan_step(mesh, sync_cadence="hourly")


# -- the stores against their JAX twins -------------------------------------------
def _pair(jmesh, mesh, cls_j, cls_p, **kw):
    jc, pc = JClock(start_ticks=8_000), ManualClock(start_ticks=8_000)
    return cls_j(jmesh, clock=jc, **kw), cls_p(mesh, clock=pc, **kw), jc, pc


def _fp_schedule(jstore, pstore, jc, pc, rng, keys, *, window, tol):
    for step in range(10):
        d = int(rng.integers(0, 1500))
        if step == 6:
            d = 7200 * 1024  # buckets refill and windows idle: sweeps free
        jc.advance_ticks(d)
        pc.advance_ticks(d)
        if step == 5:  # a forced epoch rebase of both, with their clocks
            for store, clock in ((jstore, jc), (pstore, pc)):
                store.force_rebase(4_000)
                clock.rebase(4_000)
        m = int(rng.integers(1, 120))
        ks = [keys[i] for i in rng.integers(0, len(keys), m)]
        cs = [int(c) for c in rng.integers(0, 4, m)]
        if step % 5 == 2:  # the mesh store's per-request flush surface
            got = pstore.acquire_batch_blocking(list(zip(ks, cs)))
            want = jstore.acquire_batch_blocking(list(zip(ks, cs)))
            assert [r.granted for r in got] == [r.granted for r in want]
            np.testing.assert_allclose([r.remaining for r in got],
                                       [r.remaining for r in want],
                                       rtol=RTOL, atol=tol)
            continue
        wr = step % 3 != 1
        a = pstore.acquire_many_blocking(ks, cs, with_remaining=wr)
        b = jstore.acquire_many_blocking(ks, cs, with_remaining=wr)
        np.testing.assert_array_equal(a.granted, b.granted)
        if wr:
            np.testing.assert_allclose(a.remaining, b.remaining, rtol=RTOL,
                                       atol=tol)
        if step % 4 == 3:
            assert pstore.sweep() == jstore.sweep()
        if not window:
            for k in ks[:3] + ["ghost-key"]:
                assert pstore.peek_blocking(k) == jstore.peek_blocking(k)
            assert abs(pstore.global_score - jstore.global_score) <= 1e-3
        assert pstore.fp_unresolved == jstore.fp_unresolved
        assert pstore.grows == jstore.grows
        assert pstore.per_shard_slots == jstore.per_shard_slots
        np.testing.assert_array_equal(_to_u32(pstore.fp),
                                      np.asarray(jstore.fp))


def _to_u32(fp):
    return fp.numpy().view(np.uint32)


@pytest.mark.parametrize("cadence", ["batch", "launch"])
def test_fp_store_matches_jax(jmesh, mesh, cadence):
    rng = np.random.default_rng(20 + (cadence == "launch"))
    jstore, pstore, jc, pc = _pair(
        jmesh, mesh, JS.ShardedFpDeviceStore, PS.ShardedFpDeviceStore,
        capacity=6.0, fill_rate_per_sec=2.0, per_shard_slots=16, batch=16,
        probe_window=8, decay_rate_per_sec=1.0, sync_cadence=cadence)
    keys = [f"f{i}" for i in range(160)]
    _fp_schedule(jstore, pstore, jc, pc, rng, keys, window=False, tol=1e-6)
    assert pstore.grows >= 1  # growth through the migrate kernel ran
    # Snapshots restore into a fresh store of the OTHER package.
    for src, dst in (
            (jstore, PS.ShardedFpDeviceStore(
                mesh, capacity=6.0, fill_rate_per_sec=2.0,
                per_shard_slots=16, batch=16, probe_window=8,
                clock=ManualClock(start_ticks=99))),
            (pstore, JS.ShardedFpDeviceStore(
                jmesh, capacity=6.0, fill_rate_per_sec=2.0,
                per_shard_slots=16, batch=16, probe_window=8,
                clock=JClock(start_ticks=99)))):
        dst.restore(src.snapshot())
        assert dst.per_shard_slots == src.per_shard_slots
        for k in keys[:40]:
            assert dst.peek_blocking(k) == pstore.peek_blocking(k)
        assert abs(dst.global_score - src.global_score) <= 1e-3


@pytest.mark.parametrize("fixed", [False, True])
def test_fp_window_store_matches_jax(jmesh, mesh, fixed):
    rng = np.random.default_rng(30 + fixed)
    jstore, pstore, jc, pc = _pair(
        jmesh, mesh, JS.ShardedFpWindowStore, PS.ShardedFpWindowStore,
        limit=5.0, window_sec=1.0, fixed=fixed, per_shard_slots=16,
        batch=16, probe_window=8)
    keys = [f"w{i}" for i in range(160)]
    _fp_schedule(jstore, pstore, jc, pc, rng, keys, window=True,
                 tol=1.5 * float(np.spacing(np.float32(5.0))))
    jnew = JS.ShardedFpWindowStore(jmesh, limit=5.0, window_sec=1.0,
                                   fixed=fixed, per_shard_slots=16, batch=16,
                                   probe_window=8,
                                   clock=JClock(start_ticks=pc.now_ticks()))
    pnew = PS.ShardedFpWindowStore(mesh, limit=5.0, window_sec=1.0,
                                   fixed=fixed, per_shard_slots=16, batch=16,
                                   probe_window=8,
                                   clock=ManualClock(
                                       start_ticks=jc.now_ticks()))
    jnew.restore(pstore.snapshot())
    pnew.restore(jstore.snapshot())
    a = pnew.acquire_many_blocking(keys, [1] * len(keys))
    b = jnew.acquire_many_blocking(keys, [1] * len(keys))
    np.testing.assert_array_equal(a.granted, b.granted)


# -- the JAX file's surface (tests/test_fp_sharded.py) on the port -------------------
def make_store(mesh, **kw):
    kw.setdefault("capacity", 5.0)
    kw.setdefault("fill_rate_per_sec", 0.0)
    kw.setdefault("per_shard_slots", 256)
    kw.setdefault("batch", 32)
    kw.setdefault("clock", ManualClock())
    return PS.ShardedFpDeviceStore(mesh, **kw)


class TestShardedFp:
    def test_fresh_keys_grant_across_shards(self, mesh):
        store = make_store(mesh)
        res = store.acquire_many_blocking([f"k{i}" for i in range(200)],
                                          [1] * 200)
        assert res.granted.all() and store.fp_unresolved == 0
        fp = store.fp.numpy().reshape(S, -1, 2)
        assert ((fp != 0).any(-1).sum(axis=1) > 0).all()

    def test_keys_live_in_their_route_region(self, mesh):
        store = make_store(mesh)
        keys = [f"r{i}" for i in range(300)]
        store.acquire_many_blocking(keys, [1] * 300)
        fps = fingerprints(keys)
        cells = F.find_np(_to_u32(store.fp), fps, store.probe_window, S)
        assert (cells >= 0).all()
        assert (cells // 256 == fps[:, 0] % S).all()
        F.check_table_np(_to_u32(store.fp), store.probe_window, S)

    def test_capacity_enforced_across_calls(self, mesh):
        store = make_store(mesh)
        assert list(store.acquire_many_blocking(["a", "b"], [3, 5]).granted) \
            == [True, True]
        assert list(store.acquire_many_blocking(["a", "b"], [3, 1]).granted) \
            == [False, False]

    def test_in_call_duplicates_serialize(self, mesh):
        store = make_store(mesh)
        res = store.acquire_many_blocking(["dup"] * 8, [1] * 8)
        assert list(res.granted) == [True] * 5 + [False] * 3

    def test_global_counter_sees_all_shards(self, mesh):
        store = make_store(mesh)
        res = store.acquire_many_blocking([f"g{i}" for i in range(100)],
                                          [2] * 100)
        assert res.granted.all()
        assert store.global_score == pytest.approx(200.0)

    def test_matches_single_chip_fp_store(self, mesh):
        clock = ManualClock()
        store = make_store(mesh, clock=clock)
        single = FingerprintBucketStore(n_slots=1 << 12, clock=clock,
                                        device="cpu")
        rng = np.random.default_rng(3)
        keys = [f"k{i}" for i in range(300)]
        counts = rng.integers(0, 7, 300).tolist()
        got = store.acquire_many_blocking(keys, counts)
        want = single.acquire_many_blocking(keys, counts, 5.0, 0.0)
        np.testing.assert_array_equal(got.granted, want.granted)
        np.testing.assert_allclose(got.remaining, want.remaining, atol=1e-4)
        asyncio.run(single.aclose())

    def test_refill_over_time(self, mesh):
        clock = ManualClock()
        store = make_store(mesh, fill_rate_per_sec=1.0, clock=clock)
        assert store.acquire_many_blocking(["r"], [5]).granted.all()
        assert not store.acquire_many_blocking(["r"], [1]).granted.any()
        clock.advance_seconds(3.0)
        assert store.acquire_many_blocking(["r"], [3]).granted.all()

    def test_window_pressure_denied_and_counted(self, mesh):
        store = make_store(mesh, per_shard_slots=8, probe_window=4)
        res = store.acquire_many_blocking([f"p{i}" for i in range(400)],
                                          [1] * 400)
        assert store.fp_unresolved > 0
        assert int(res.granted.sum()) < 400

    def test_pressure_grows_all_shards_and_keeps_state(self, mesh):
        store = make_store(mesh, per_shard_slots=16, probe_window=8)
        assert store.acquire_many_blocking(["marker"], [2]).granted.all()
        keys = [f"g{i}" for i in range(600)]
        for _ in range(5):
            res = store.acquire_many_blocking(keys, [1] * 600)
            if res.granted.all():
                break
        assert res.granted.all()
        assert store.grows >= 1 and store.per_shard_slots >= 32
        assert not store.acquire_many_blocking(["marker"], [4]).granted.any()

    def test_sweep_frees_expired(self, mesh):
        clock = ManualClock()
        store = make_store(mesh, fill_rate_per_sec=1.0, clock=clock)
        store.acquire_many_blocking([f"s{i}" for i in range(50)], [1] * 50)
        clock.advance_seconds(3600.0)
        assert store.sweep() == 50

    def test_zero_permit_probe_granted(self, mesh):
        store = make_store(mesh)
        store.acquire_many_blocking(["z"], [5])
        res = store.acquire_many_blocking(["z", "z"], [0, 1])
        assert bool(res.granted[0]) and not bool(res.granted[1])

    def test_peek_is_read_only(self, mesh):
        store = make_store(mesh, fill_rate_per_sec=1.0)
        assert store.peek_blocking("ghost") == 5.0
        assert store._occupancy() == 0
        store.acquire_many_blocking(["real"], [2])
        assert store.peek_blocking("real") == 3.0
        assert store._occupancy() == 1

    def test_window_store_sliding_and_fixed(self, mesh):
        clock = ManualClock()
        store = PS.ShardedFpWindowStore(mesh, limit=3.0, window_sec=10.0,
                                        per_shard_slots=256, batch=32,
                                        clock=clock)
        keys = [f"w{i}" for i in range(40)]
        assert store.acquire_many_blocking(keys, [2] * 40).granted.all()
        assert not store.acquire_many_blocking(keys, [2] * 40).granted.any()
        single = FingerprintBucketStore(n_slots=1 << 12, clock=clock,
                                        device="cpu")
        rng = np.random.default_rng(23)
        dkeys = [f"d{i}" for i in rng.integers(0, 60, 200)]
        counts = rng.integers(0, 3, 200).tolist()
        got = store.acquire_many_blocking(dkeys, counts)
        want = single.window_acquire_many_blocking(dkeys, counts, 3.0, 10.0)
        np.testing.assert_array_equal(got.granted, want.granted)
        clock.advance_seconds(25.0)
        assert store.acquire_many_blocking(["w0"], [3]).granted.all()
        fstore = PS.ShardedFpWindowStore(mesh, limit=3.0, window_sec=10.0,
                                         fixed=True, per_shard_slots=256,
                                         batch=32, clock=clock)
        assert fstore.acquire_many_blocking(["f"], [3]).granted.all()
        clock.advance_seconds(10.5)
        assert fstore.acquire_many_blocking(["f"], [3]).granted.all()
        with pytest.raises(NotImplementedError):
            fstore.peek_blocking("f")
        asyncio.run(single.aclose())

    def test_window_store_growth(self, mesh):
        store = PS.ShardedFpWindowStore(mesh, limit=5.0, window_sec=60.0,
                                        per_shard_slots=16, batch=32,
                                        probe_window=8, clock=ManualClock())
        assert store.acquire_many_blocking(["wm"], [4]).granted.all()
        keys = [f"wg{i}" for i in range(600)]
        for _ in range(5):
            res = store.acquire_many_blocking(keys, [1] * 600)
            if res.granted.all():
                break
        assert res.granted.all() and store.grows >= 1
        assert not store.acquire_many_blocking(["wm"], [2]).granted.any()

    def test_verdict_only(self, mesh):
        store = make_store(mesh)
        res = store.acquire_many_blocking(["v1", "v2"], [1, 99],
                                          with_remaining=False)
        assert list(res.granted) == [True, False]
        assert res.remaining is None

    def test_batch_must_fit_one_decision_batch(self, mesh):
        with pytest.raises(ValueError, match="decision batch"):
            make_store(mesh, batch=2048)


class TestShardedFpCheckpoint:
    def test_snapshot_restore_roundtrip(self, mesh):
        store = make_store(mesh)
        keys = [f"r{i}" for i in range(60)]
        store.acquire_many_blocking(keys, [3] * 60)
        other = make_store(mesh)
        other.restore(store.snapshot())
        assert not other.acquire_many_blocking(
            keys, [3] * 60, with_remaining=False).granted.any()
        assert other.acquire_many_blocking(
            keys, [2] * 60, with_remaining=False).granted.all()

    def test_restore_replaces_legacy_placement(self, mesh):
        store = make_store(mesh)
        keys = [f"lg{i}" for i in range(60)]
        store.acquire_many_blocking(keys, [5] * 60)
        snap = store.snapshot()
        snap.pop("placement")
        fp = np.array(snap["fp"])
        per = snap["per_shard"]
        cols = {f: np.array(snap[f]) for f in ("tokens", "last_ts", "exists")}
        fp_sh = fp.reshape(S, per, 2)
        cols_sh = {f: a.reshape(S, per) for f, a in cols.items()}
        new_fp = np.zeros_like(fp_sh)
        new_cols = {f: np.zeros_like(a) for f, a in cols_sh.items()}
        for s in range(S):
            for i in np.nonzero((fp_sh[s] != 0).any(-1))[0]:
                pair = fp_sh[s][i]
                h = np.uint32((int(pair[0]) * 0x9E3779B1) & 0xFFFFFFFF) ^ pair[1]
                b = int(h % np.uint32(per))  # the v1 wrapping base
                assert not new_fp[s][b].any(), "collision in test data"
                new_fp[s][b] = pair
                for f in new_cols:
                    new_cols[f][s][b] = cols_sh[f][s][i]
        snap["fp"] = new_fp.reshape(fp.shape)
        for f, a in new_cols.items():
            snap[f] = a.reshape(cols[f].shape)
        other = make_store(mesh)
        other.restore(snap)
        assert not other.acquire_many_blocking(
            keys, [1] * 60, with_remaining=False).granted.any()

    def test_host_directory_snapshot_rejected(self, mesh):
        from distributedratelimiting.redis_tpu_torch.parallel.sharded_store \
            import ShardedDeviceStore

        host = ShardedDeviceStore(mesh, 5.0, 0.0, per_shard_slots=16)
        with pytest.raises(ValueError, match="host key directory"):
            make_store(mesh).restore(host.snapshot())
        with pytest.raises(ValueError, match="shard count"):
            make_store(mesh).restore(make_store(Mesh(["cpu"] * 4)).snapshot())


class TestFpSyncCadence:
    def test_launch_cadence_matches_batch(self, mesh):
        keys = [f"c{i}" for i in range(150)]
        outs = {}
        for cadence in ("batch", "launch"):
            store = make_store(mesh, sync_cadence=cadence)
            res = store.acquire_many_blocking(keys, [2] * len(keys))
            outs[cadence] = (np.asarray(res.granted), store.global_score)
        np.testing.assert_array_equal(outs["batch"][0], outs["launch"][0])
        assert outs["batch"][1] == outs["launch"][1] == 300.0

    def test_invalid_cadence_rejected(self, mesh):
        with pytest.raises(ValueError, match="sync_cadence"):
            make_store(mesh, sync_cadence="hourly")
