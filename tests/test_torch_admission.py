"""The port's two-level (tenant → key) admission and tier-0 debit against the
JAX package's: the plain kernels, the store, ``AdmissionPolicy``, the DI
registry, the exports, and ``OP_ACQUIRE_H`` / ``BULK_KIND_HBUCKET`` on the
wire.

Inputs come from numpy seeds and go through both packages. Tolerances:

- ``acquire_hierarchical_packed``: grants, ``last_ts`` and ``exists`` of
  both tables equal; remaining and tokens within atol 1e-4 (XLA on the CPU
  may contract the refill's multiply-add into an FMA, the port never does;
  and duplicates' consumption adds in another order).
- ``debit_batch_packed``: within atol 1e-4 on arbitrary inputs for the same
  reasons; equal bit for bit where every refill is exact (whole balances,
  missing slots) and the amounts are whole numbers, duplicates included.
- ``bucket_math.duplicate_prefix_float`` (the port's float prefix: the
  earlier amounts of a slot added one at a time, each add rounded to
  float32) against JAX's tree-ordered scan: equal for whole and dyadic
  amounts; for arbitrary amounts within k float32 spacings of the largest
  partial sum for k earlier terms. The sequential order is checked exactly
  against a float32 loop.
- Store traces, ``AdmissionPolicy`` (grants, remaining, ``stats()``), the
  registry and the four client/server pairings on the wire: identical
  results.
"""

import asyncio
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distributedratelimiting.redis_tpu as jpkg
import distributedratelimiting.redis_tpu_torch as ppkg
from distributedratelimiting.redis_tpu.ops import bucket_math as jbm
from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.runtime import admission as jadm
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
    BucketStore as JBase,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu.utils import registry as jreg
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    DeviceBucketStore,
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime import admission as padm
from distributedratelimiting.redis_tpu_torch.runtime import server as pserver
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    BucketStore as PBase,
)
from distributedratelimiting.redis_tpu_torch.utils import registry as preg

torch.set_num_threads(1)

ATOL = 1e-4
LIMIT_S = 20.0
#: Names of the JAX package's exports whose modules are not ported yet.
UNPORTED_EXPORTS: set = set()


def w(coro):
    return asyncio.wait_for(coro, LIMIT_S)


# -- plain kernels --------------------------------------------------------------

def _bucket(rng, n, cap, now=50_000):
    return (rng.uniform(0, cap, n).astype(np.float32),
            rng.integers(now - 3000, now + 50, n).astype(np.int32),
            rng.random(n) < 0.6)


def _jb(arrays):
    return JK.BucketState(*(jnp.asarray(a) for a in arrays))


def _pb(arrays):
    return K.BucketState(*(torch.tensor(a) for a in arrays))


def _close_state(jstate, pstate):
    np.testing.assert_allclose(np.asarray(jstate.tokens), pstate.tokens,
                               atol=ATOL, rtol=0)
    np.testing.assert_array_equal(np.asarray(jstate.last_ts), pstate.last_ts)
    np.testing.assert_array_equal(np.asarray(jstate.exists), pstate.exists)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("b", [8, 300])
def test_hierarchical_plain_matches_jax(seed, b):
    """Zipf keys and tenants (long same-tenant segments), zero costs,
    padding in either slot, out-of-range slots in either table; both levels
    bind somewhere."""
    rng = np.random.default_rng(seed)
    child, parent = _bucket(rng, 128, 30.0), _bucket(rng, 8, 120.0)
    cs = np.minimum(rng.zipf(1.4, b) - 1, 131).astype(np.int32)
    ps = (rng.zipf(1.2, b) % 10 - 1).astype(np.int32)
    costs = rng.integers(0, 9, b).astype(np.int32)
    packed = np.stack([cs, costs, np.full(b, 50_500, np.int32), ps])
    args = (30.0, 0.01, 120.0, 0.03)
    jc, jp, jout = JK.acquire_hierarchical_packed(
        _jb(child), _jb(parent), jnp.asarray(packed),
        *(jnp.float32(a) for a in args))
    pc, pp = _pb(child), _pb(parent)
    pout = ck.acquire_hierarchical(pc, pp, torch.from_numpy(packed), *args)
    jout = np.asarray(jout)
    np.testing.assert_array_equal(jout[0], pout[0].numpy())
    np.testing.assert_allclose(jout[1], pout[1].numpy(), atol=ATOL, rtol=0)
    _close_state(jc, pc)
    _close_state(jp, pp)
    if b > 8:
        assert 0 < jout[0].sum() < b


def _debit_packed(slots, amounts, now=50_000):
    return np.stack([slots, amounts.astype(np.float32).view(np.int32),
                     np.full(len(slots), now, np.int32)])


@pytest.mark.parametrize("seed", range(5))
def test_debit_plain_matches_jax(seed):
    """Duplicates, fractional and negative amounts (credits), padding and
    out-of-range slots; JAX's i32[3, B] operand on both sides."""
    rng = np.random.default_rng(seed)
    state = _bucket(rng, 64, 20.0)
    b = 200
    slots = np.minimum(rng.zipf(1.3, b) - 1, 70).astype(np.int32)
    slots[rng.random(b) < 0.05] = -1
    amounts = (rng.integers(-40, 120, b) / 8).astype(np.float32)
    packed = _debit_packed(slots, amounts)
    js, jout = JK.debit_batch_packed(_jb(state), jnp.asarray(packed),
                                     jnp.float32(20.0), jnp.float32(0.01))
    ps = _pb(state)
    pout = ck.debit_packed(ps, torch.from_numpy(packed), 20.0, 0.01)
    np.testing.assert_allclose(np.asarray(jout), pout.numpy(), atol=ATOL,
                               rtol=0)
    _close_state(js, ps)
    assert (pout[1].numpy() > 0).any()  # some shortfall


def test_debit_whole_number_duplicates_exact():
    """Whole balances, a whole refill (rate · elapsed whole) and whole
    amounts: every partial sum is exact in float32, so the two packages
    agree bit for bit on repeated slots (debits and credits)."""
    rng = np.random.default_rng(7)
    n, b = 64, 512
    state = (rng.integers(0, 50, n).astype(np.float32),
             (50_000 - 1024 * rng.integers(0, 3, n)).astype(np.int32),
             rng.random(n) < 0.7)
    slots = np.minimum(rng.zipf(1.2, b) - 1, n - 1).astype(np.int32)
    amounts = rng.integers(-6, 15, b).astype(np.float32)
    packed = _debit_packed(slots, amounts)
    js, jout = JK.debit_batch_packed(_jb(state), jnp.asarray(packed),
                                     jnp.float32(60.0),
                                     jnp.float32(2 / 1024))
    ps = _pb(state)
    _, pout = K.debit_batch_packed(ps, torch.from_numpy(packed), 60.0,
                                   2 / 1024)
    np.testing.assert_array_equal(np.asarray(jout), pout.numpy())
    for j, p in zip(js, ps):
        np.testing.assert_array_equal(np.asarray(j), p.numpy())
    assert np.bincount(slots).max() > 20


@pytest.mark.parametrize("kind", ["whole", "dyadic", "arbitrary"])
def test_float_prefix_order_and_tolerance(kind):
    rng = np.random.default_rng(3)
    b = 400
    slots = np.minimum(rng.zipf(1.3, b) - 1, 20).astype(np.int32)
    slots[rng.random(b) < 0.05] = -1
    if kind == "whole":
        amounts = rng.integers(-50, 400, b).astype(np.float32)
    elif kind == "dyadic":
        amounts = (rng.integers(-50, 400, b) / 16).astype(np.float32)
    else:
        amounts = rng.uniform(-3, 17, b).astype(np.float32)
    valid = slots >= 0
    got = bm.duplicate_prefix_float(torch.from_numpy(slots),
                                    torch.from_numpy(amounts),
                                    torch.from_numpy(valid)).numpy()
    # The stated order: one float32 add at a time, in request order.
    run = {}
    want = np.zeros(b, np.float32)
    for i in range(b):
        s = int(slots[i])
        want[i] = run.get(s, np.float32(0))
        if valid[i]:
            run[s] = np.float32(want[i] + amounts[i])
    np.testing.assert_array_equal(got, want)
    jax_ = np.asarray(jbm.duplicate_prefix(jnp.asarray(slots),
                                           jnp.asarray(amounts),
                                           jnp.asarray(valid)))
    if kind != "arbitrary":
        np.testing.assert_array_equal(got, jax_)
        return
    k = np.zeros(b)
    seen = {}
    for i in range(b):
        k[i] = seen.get(int(slots[i]), 0)
        seen[int(slots[i])] = k[i] + valid[i]
    mag = np.cumsum(np.abs(amounts)).astype(np.float32)[-1]
    tol = np.maximum(k, 1) * np.spacing(mag)
    assert (np.abs(got.astype(np.float64) - jax_) <= tol).all()


# -- store traces -----------------------------------------------------------------

def _stores(**kw):
    kw.setdefault("n_slots", 64)
    kw.setdefault("max_batch", 16)
    return (DeviceBucketStore(device="cpu", clock=ManualClock(10_000), **kw),
            JStore(clock=JClock(10_000), **kw))


async def _hier_trace(store):
    rng = np.random.default_rng(11)
    tenants = [f"t{t % 5}" for t in rng.zipf(1.2, 100)]
    keys = [f"k{int(k) % 30}" for k in rng.zipf(1.5, 100)]
    costs = rng.integers(0, 9, 100)
    cfg = (40.0, 4.0, 12.0, 2.0)  # tenant (cap, rate), key (cap, rate)
    out = []
    r = await store.acquire_hierarchical_many(tenants, keys, costs, *cfg)
    out.append((r.granted.tolist(), np.round(r.remaining, 3).tolist()))
    store.clock.advance_seconds(0.5)
    r = store.acquire_hierarchical_many_blocking(tenants[:40], keys[:40],
                                                 costs[:40], *cfg,
                                                 with_remaining=False)
    out.append((r.granted.tolist(), r.remaining))
    store.clock.advance_seconds(3.0)
    for i in range(20):
        res = await store.acquire_hierarchical(tenants[i], keys[i],
                                               int(costs[i]), *cfg)
        out.append((res.granted, round(res.remaining, 3)))
        res = store.acquire_hierarchical_blocking("t9", "solo", 5, *cfg)
        out.append((res.granted, round(res.remaining, 3)))
    for args in ((-1, *cfg), (1, 12.0, 2.0, 12.0, 2.0)):
        with pytest.raises(ValueError):
            await store.acquire_hierarchical("t", "k", *args)
    out.append([round(store.peek_blocking(k, 12.0, 2.0), 3)
                for k in ("k0", "k1", "solo")])
    out.append([round(store.peek_blocking(t, 40.0, 4.0), 3)
                for t in ("t0", "t1", "t9")])
    return out


def test_store_hierarchical_matches_jax():
    port, jax_ = _stores()
    got = asyncio.run(_hier_trace(port))
    want = asyncio.run(_hier_trace(jax_))
    assert got == want
    assert 0 < sum(got[0][0]) < 100  # both levels bind in the first call


async def _debit_trace(store):
    out = []
    store.acquire_many_blocking([f"k{i}" for i in range(10)], [3] * 10,
                                20.0, 1.0)
    rem, short = await store.debit_many(
        [f"k{i}" for i in range(12)],
        [0.5 * i for i in range(10)] + [25.0, -2.25], 20.0, 1.0)
    out.append((rem.tolist(), short.tolist()))
    # A refund (negative amounts) credits without the capacity clamp.
    store.clock.advance_seconds(0.25)
    rem, short = await store.debit_many(["k0", "k9", "k3", "k3"],
                                        [-4.0, -1.5, 2.0, 1.0], 20.0, 1.0)
    out.append((rem.tolist(), short.tolist()))
    out.append([store.peek_blocking(f"k{i}", 20.0, 1.0) for i in range(12)])
    return out


def test_store_debit_matches_jax():
    port, jax_ = _stores()
    got = asyncio.run(_debit_trace(port))
    want = asyncio.run(_debit_trace(jax_))
    assert got == want
    assert got[0][1][10] == 5.0  # 25 against a fresh 20: shortfall 5


async def _compose_trace(store, base):
    """The base class's compose (parent, then child, parent refund through
    debit_many on a child deny), driven on a device store."""
    out = []
    for key, cost in (("a", 5), ("a", 5), ("a", 5), ("b", 8), ("c", 0)):
        res = await base.acquire_hierarchical(store, "t", key, cost, 20.0,
                                              1.0, 12.0, 1.0)
        out.append((res.granted, res.remaining))
    out.append(store.peek_blocking("t", 20.0, 1.0))
    res = base.acquire_hierarchical_blocking(store, "t", "a", 1, 20.0, 1.0,
                                             12.0, 1.0)
    out.append((res.granted, res.remaining))
    return out


def test_base_class_compose_matches_jax():
    port, jax_ = _stores()
    got = asyncio.run(_compose_trace(port, PBase))
    want = asyncio.run(_compose_trace(jax_, JBase))
    assert got == want
    # The third "a" fails at the key and its tenant debit is refunded, so
    # "b"'s 8 tokens still fit the tenant: 20 - 5 - 5 - 8 = 2.
    assert got[2][0] is False and got[3][0] is True and got[5] == 2.0


# -- AdmissionPolicy, helpers, registry, exports ------------------------------------

class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


async def _policy_trace(adm, store):
    clock = _Clock()
    pol = adm.AdmissionPolicy(store, key_config=(500.0, 50.0),
                              velocity_tau_s=5.0, clock=clock)
    pol.set_tenant(adm.TenantBudget("acme", 1000.0, 100.0))
    pol.set_tenant(adm.TenantBudget("beta", 300.0, 10.0))
    out = []
    rng = np.random.default_rng(5)
    for i in range(60):
        t = "acme" if i % 3 else "beta"
        res = await pol.acquire(t, f"u{i % 7}", int(rng.integers(1, 90)),
                                priority=i % 3, attempt=int(i % 11 == 0))
        out.append(tuple(res))
        clock.t += 0.1
        store.clock.advance_seconds(0.05)
    pol.set_shed_level(adm.PRIORITY_SCAVENGER)
    out.append(tuple(await pol.acquire("acme", "u1", 1,
                                       priority=adm.PRIORITY_SCAVENGER)))
    pol.set_retry_shed(True)
    out.append(tuple(await pol.acquire("acme", "u1", 1, attempt=2)))
    pol.set_shed_level(None)
    pol.set_retry_shed(False)
    out.append(tuple(pol.acquire_blocking("beta", "u2", 3)))
    with pytest.raises(KeyError):
        await pol.acquire("nobody", "u", 1)
    out.append(pol.envelope_budget("acme"))
    out.append(pol.stats())
    out.append(sorted(pol.tenants()))
    return out


def test_admission_policy_matches_jax():
    port, jax_ = _stores(max_batch=64)
    got = asyncio.run(_policy_trace(padm, port))
    want = asyncio.run(_policy_trace(jadm, jax_))
    assert got == want
    stats = got[-2]
    assert stats["shed"] == 2 and stats["retries_shed"] == 1
    assert 0 < stats["granted"] < stats["decisions"]


def test_admission_helpers_match_jax():
    for prio in range(4):
        assert padm.priority_name(prio) == jadm.priority_name(prio)
        for tokens in (0.0, 10.0, 49.0, 50.0, 60.0, 100.0):
            for count in (-1, 0, 1, 10, 50):
                assert (padm.shed_allows(prio, tokens, count, 100.0)
                        == jadm.shed_allows(prio, tokens, count, 100.0))
    for bad in (("", 1.0, 1.0), ("t", 0.0, 1.0), ("t", math.inf, 1.0),
                ("t", 1.0, -1.0)):
        with pytest.raises(ValueError):
            padm.TenantBudget(*bad)
        with pytest.raises(ValueError):
            jadm.TenantBudget(*bad)
    snaps = []
    for adm in (padm, jadm):
        clock = _Clock()
        tv = adm.TokenVelocity(tau_s=2.0, max_tenants=3, clock=clock)
        for i in range(12):
            tv.observe(f"t{i % 5}", float(1 + i))
            tv.observe("neg", -1.0)
            clock.t += 0.3
        snaps.append((tv.snapshot(), tv.rate("t4"), tv.totals()))
    assert snaps[0] == snaps[1]
    assert padm.BATCH_ENVELOPE_RESERVE == jadm.BATCH_ENVELOPE_RESERVE


def test_registry_matches_jax():
    helpers = ["token_bucket_rate_limiter",
               "approximate_token_bucket_rate_limiter",
               "queueing_token_bucket_rate_limiter",
               "sliding_window_rate_limiter",
               "partitioned_window_rate_limiter", "concurrency_limiter",
               "fixed_window_rate_limiter"]
    opts = {"token_bucket_rate_limiter": "TokenBucketOptions",
            "approximate_token_bucket_rate_limiter":
                "ApproximateTokenBucketOptions",
            "queueing_token_bucket_rate_limiter":
                "QueueingTokenBucketOptions",
            "sliding_window_rate_limiter": "SlidingWindowOptions",
            "partitioned_window_rate_limiter": "FixedWindowOptions",
            "concurrency_limiter": "ConcurrencyLimiterOptions",
            "fixed_window_rate_limiter": "FixedWindowOptions"}
    resolved = {}
    for pkg, reg, store in (
            (ppkg, preg, DeviceBucketStore(device="cpu",
                                           clock=ManualClock())),
            (jpkg, jreg, JStore(clock=JClock()))):
        r = reg.ServiceRegistry()
        r.add_singleton(reg.BUCKET_STORE, lambda _, s=store: s)
        for h in helpers:
            getattr(reg, f"add_tpu_{h}")(
                r, lambda h=h: getattr(pkg, opts[h])(instance_name=h),
                service_name=h)
        with pytest.raises(ValueError, match="already registered"):
            reg.add_tpu_concurrency_limiter(
                r, pkg.ConcurrencyLimiterOptions,
                service_name="concurrency_limiter")
        with pytest.raises(KeyError):
            r.resolve("missing")
        lims = {h: r.resolve(h) for h in helpers}
        assert all(r.resolve(h) is lims[h] for h in helpers)  # singletons
        assert all(lim.store is store for lim in lims.values()
                   if hasattr(lim, "store"))
        assert "concurrency_limiter" in r and "nope" not in r
        resolved[pkg.__name__] = {h: type(lim).__name__
                                  for h, lim in lims.items()}
        lease = lims["concurrency_limiter"].acquire(1)
        assert lease.is_acquired
        lease.dispose()
    assert resolved[ppkg.__name__] == resolved[jpkg.__name__]
    assert sorted(preg.__all__) == sorted(jreg.__all__)


def test_port_exports_every_ported_jax_name():
    """The port exports each name of the JAX package's ``__all__`` but the
    listed ones, whose modules are still to port."""
    missing = {n for n in jpkg.__all__ if not hasattr(ppkg, n)}
    assert missing == UNPORTED_EXPORTS
    assert set(jpkg.__all__) - UNPORTED_EXPORTS <= set(ppkg.__all__)
    for name in ("ConcurrencyLimiter", "ConcurrencyLimiterOptions",
                 "ConcurrencyLease", "ServiceRegistry",
                 "add_tpu_concurrency_limiter"):
        assert getattr(ppkg, name).__module__.startswith(ppkg.__name__)


# -- the wire ---------------------------------------------------------------------

async def _wire_hier(server_kind, client_kind):
    if server_kind == "port":
        store = DeviceBucketStore(device="cpu", clock=ManualClock(10_000),
                                  n_slots=128, max_batch=32)
        srv = BucketStoreServer(store)
    else:
        store = JStore(clock=JClock(10_000), n_slots=128, max_batch=32)
        srv = JServer(store)
    host, port = await w(srv.start())
    cli = (RemoteBucketStore if client_kind == "port" else JRemote)(
        address=(host, port))
    rng = np.random.default_rng(21)
    tenants = [f"t{t % 4}" for t in rng.zipf(1.2, 120)]
    keys = [f"k{int(k) % 25}" for k in rng.zipf(1.5, 120)]
    costs = rng.integers(0, 9, 120)
    cfg = (60.0, 5.0, 14.0, 2.0)
    out = []
    try:
        for i in range(30):  # one OP_ACQUIRE_H frame per request
            res = await w(cli.acquire_hierarchical(
                tenants[i], keys[i], int(costs[i]), *cfg, priority=i % 3))
            out.append((res.granted, round(res.remaining, 3)))
        res = await asyncio.to_thread(cli.acquire_hierarchical_blocking,
                                      "t0", "k1", 2, *cfg)
        out.append(tuple(res))
        r = await w(cli.acquire_hierarchical_many(tenants[30:], keys[30:],
                                                  costs[30:], *cfg))
        out.append((r.granted.tolist(), np.round(r.remaining, 3).tolist()))
        r = await w(cli.acquire_hierarchical_many([], [], [], *cfg))
        out.append(len(r))
        with pytest.raises(ValueError):
            await cli.acquire_hierarchical("t", "k", 1, 14.0, 2.0, 14.0, 2.0)
        out.append(cli.resilience_stats()["hier_fallbacks"])
        stats = await w(cli.stats())
        out.append(sorted(stats.get("token_velocity", {}).get("admitted",
                                                               {})))
        return out
    finally:
        await w(cli.aclose())
        await w(srv.aclose())
        await store.aclose()


def test_hierarchical_four_pairings():
    got = {(s, c): asyncio.run(_wire_hier(s, c))
           for s in ("port", "jax") for c in ("port", "jax")}
    want = got[("jax", "jax")]
    assert all(v == want for v in got.values()), got
    granted = [g for g, _ in want[:30]] + want[31][0]
    assert 0 < sum(granted) < len(granted)
    assert want[-2] == 0  # no flat fallback against either server
    assert want[-1] == ["t0", "t1", "t2", "t3"]


def test_port_server_serves_the_hierarchical_bulk_kind():
    # Every op and bulk kind is served since the federation lane was
    # ported: the tables of unserved ops are gone, and the dispatch names
    # OP_ACQUIRE_H and the hierarchical bulk kind.
    assert not hasattr(pserver, "_UNPORTED_BULK_KINDS")
    assert not hasattr(pserver, "_UNPORTED_OPS")
    import inspect
    src = inspect.getsource(pserver.BucketStoreServer._handle_frame_inner)
    assert "wire.OP_ACQUIRE_H" in src and "BULK_KIND_HBUCKET" in src


@pytest.mark.parametrize("old", ["op", "bulk"])
def test_port_client_latches_flat_fallback_on_an_old_peer(old):
    """A server that does not speak the tenant extension answers "unknown
    op" (or "unknown bulk kind"): the client latches once, decides flat
    against the key's bucket alone and counts every fallback."""
    async def main():
        store = DeviceBucketStore(device="cpu", clock=ManualClock(10_000))
        srv = BucketStoreServer(store)
        real = srv.handle_frame_body

        async def old_peer(body, arrival_s=None):
            if old == "op" and len(body) >= 6 and (
                    body[5] & 0x3F) == pw.OP_ACQUIRE_H:
                return pw.encode_response(pserver._recover_seq(body),
                                          pw.RESP_ERROR, "unknown op 19")
            if (old == "bulk" and len(body) >= 6
                    and body[5] == pw.OP_ACQUIRE_MANY):
                seq, *_, kind = pw.decode_bulk_request(body)
                if kind == pw.BULK_KIND_HBUCKET:
                    return pw.encode_response(seq, pw.RESP_ERROR,
                                              "unknown bulk kind 3")
            return await real(body, arrival_s=arrival_s)

        srv.handle_frame_body = old_peer
        host, port = await w(srv.start())
        cli = RemoteBucketStore(address=(host, port),
                                coalesce_requests=False)
        try:
            if old == "op":
                r = await w(cli.acquire_hierarchical("t", "k", 30, 100.0,
                                                     1e-9, 60.0, 1e-9))
                assert r.granted and r.remaining == 30.0
            else:
                r = await w(cli.acquire_hierarchical_many(
                    ["t", "t"], ["k", "k"], [20, 20], 100.0, 1e-9, 60.0,
                    1e-9))
                assert r.granted.tolist() == [True, True]
            assert cli.resilience_stats()["hier_fallbacks"] == 1
            assert not cli._peer_hier
            # The tenant's bucket was never touched (unenforced).
            assert store.peek_blocking("t", 100.0, 1e-9) == 100.0
            await w(cli.acquire_hierarchical("t", "k2", 1, 100.0, 1e-9,
                                             60.0, 1e-9))
            assert cli.resilience_stats()["hier_fallbacks"] == 2
        finally:
            await w(cli.aclose())
            await w(srv.aclose())
            await store.aclose()

    asyncio.run(main())


def test_admission_modules_and_chip_smoke_import_no_jax():
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import distributedratelimiting.redis_tpu_torch\n"
        "import distributedratelimiting.redis_tpu_torch.runtime.admission\n"
        "import distributedratelimiting.redis_tpu_torch.models.concurrency\n"
        "import distributedratelimiting.redis_tpu_torch.utils.registry\n"
        "import importlib.util as u\n"
        "spec = u.spec_from_file_location('chip_smoke', 'chip_smoke.py')\n"
        "spec.loader.exec_module(u.module_from_spec(spec))\n"
        "print(any(m == 'jax' or m.startswith(('jax.', "
        "'distributedratelimiting.redis_tpu.'))\n"
        "          for m in sys.modules if sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]
    text = open(os.path.join(root, "chip_smoke.py")).read()
    assert "import jax" not in text and "from jax" not in text
    assert "redis_tpu import" not in text
    assert "redis_tpu." not in text.replace("redis_tpu/", "")
