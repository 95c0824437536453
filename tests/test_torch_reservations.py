"""The port's estimate-reserve-settle lane against the JAX package's.

Each scenario is written once and run on both packages: the JAX
``ReservationLedger`` over the JAX ``DeviceBucketStore`` (on the CPU), and
the port's over ``DeviceBucketStore(device="cpu")``, each on a ManualClock
(the stores' time) and an injected ledger clock (TTLs). Balances are read
through ``peek_blocking`` on both stores. Tolerances:

- Whole-number schedules (the LLM workload's costs; estimates ceiled to a
  whole charge): every ``ReserveResult`` / ``SettleResult`` field, every
  counter of ``numeric_stats()`` and every debt equal; balances within 2
  float32 spacings of the bucket's capacity (XLA on the CPU may contract
  the refill's multiply-add into an FMA, the port never does).
- The fractional-``actual`` schedule (100 rows, a refill rate with no exact
  float32 ticks): grants, outcomes and integer counters equal; every float
  field, balance and debt within ``FRACTION_ATOL`` (8 float32 spacings of
  the tenant capacity).

Cases of ``tests/test_reservations.py`` that need modules the port has not
ported wait with them: ``:312`` (placement's entry chunks), ``:516`` and
``:574`` (migration). ``:820`` (the streaming soak: its drain, chaos and
OP_CONFIG) is in ``tests/test_torch_drain.py``; ``:328`` and ``:361`` (the
fingerprint store) are in
``tests/test_torch_fp_store.py``, ``:478`` (a settle after a live config
rebase) in ``tests/test_torch_liveconfig.py``.

The wire: the four server/client pairings on one scenario (reserve,
settle, duplicates, unknown rids, the server-side prior, ``OP_STATS``'s
``reservations`` section and its immunity to ``stats(reset=True)``), the
port client's chase of a JAX server's route-to-pool redirect, and the port
client's old-peer latch.
"""

import asyncio
import types

import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.runtime import admission as jadm
from distributedratelimiting.redis_tpu.runtime import reservations as jres
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
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime import admission as padm
from distributedratelimiting.redis_tpu_torch.runtime import reservations as pres
from distributedratelimiting.redis_tpu_torch.runtime import server as pserver
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw

torch.set_num_threads(1)

START = 1_000_000
LIMIT_S = 20.0
_FILL = 1e-9
_CHILD_CAP, _CHILD_RATE = 1e6, 1e-9
#: The fractional schedule's tolerance: 8 float32 spacings of its tenant
#: capacity (300 tokens).
FRACTION_ATOL = 8 * float(np.spacing(np.float32(300.0)))


def w(coro, limit=LIMIT_S):
    return asyncio.wait_for(coro, limit)


PACKAGES = {
    "port": types.SimpleNamespace(
        name="port", res=pres, adm=padm, Clock=ManualClock,
        store=lambda clock, **kw: DeviceBucketStore(
            device="cpu", clock=clock, **kw)),
    "jax": types.SimpleNamespace(
        name="jax", res=jres, adm=jadm, Clock=JClock,
        store=lambda clock, **kw: JStore(clock=clock, **kw)),
}


def _both(scenario, *args):
    """Run ``scenario(pkg, *args)`` on both packages; return both outputs."""
    return (asyncio.run(scenario(PACKAGES["port"], *args)),
            asyncio.run(scenario(PACKAGES["jax"], *args)))


def _store(pk, **kw):
    kw.setdefault("n_slots", 64)
    kw.setdefault("max_batch", 16)
    return pk.store(pk.Clock(START), **kw)


def _ledger(pk, store, **kw):
    t = [0.0]
    return pk.res.ReservationLedger(store, clock=lambda: t[0], **kw), t


def _peek(store, key, cap, rate):
    return float(store.peek_blocking(key, cap, rate))


def _spacings(cap) -> float:
    return float(np.spacing(np.float32(cap)))


# -- EstimatePrior (tests/test_reservations.py:59, :71) ---------------------

def _prior_trace(res):
    out = []
    p = res.EstimatePrior(window=200)
    for v in range(1, 101):
        p.observe("t", 0, float(v))
        p.observe("t", 1, float(v))
    out += [p.estimate("t", 0), p.estimate("t", 1), p.estimate("t", 2),
            p.estimate("nobody", 0)]
    q = res.EstimatePrior(window=4, max_groups=2)
    for v in (1.0, 2.0, 3.0, 4.0, 100.0):
        q.observe("a", 0, v)
    out.append(q.estimate("a", 1))
    q.observe("b", 0, 5.0)
    q.observe("c", 0, 7.0)  # evicts the oldest-touched group
    out.append(len(q))
    q.observe("a", 0, -1.0)
    q.observe("a", 0, float("nan"))
    out += [q.estimate("a", 0), q.estimate("b", 0), q.estimate("c", 2)]
    for bad in ((0, 1), (1, 0)):
        with pytest.raises(ValueError):
            res.EstimatePrior(*bad)
    return out


def test_prior_p99_mean_and_bounds_match_jax():
    got, want = _prior_trace(pres), _prior_trace(jres)
    assert got == want
    assert got[:4] == [99.0, 50.5, 50.5, None]
    assert got[4] == pytest.approx((2 + 3 + 4 + 100) / 4)
    assert got[5] == 2 and got[6] is None  # "a" was evicted


# -- ledger unit surface ----------------------------------------------------

async def _refund_and_debt(pk):
    """tests/test_reservations.py:93."""
    st = _store(pk)
    led, _t = _ledger(pk, st)
    out = []
    r = await led.reserve("r1", "t", "k", 100, 1000.0, _FILL,
                          _CHILD_CAP, _CHILD_RATE)
    out += [tuple(r), led.outstanding_tokens(), led.outstanding_by_tenant()]
    s = await led.settle("r1", "t", 40.0)
    out += [tuple(s), _peek(st, "t", 1000.0, _FILL),
            _peek(st, "k", _CHILD_CAP, _CHILD_RATE), led.outstanding_tokens()]
    r2 = await led.reserve("r2", "t", "k", 100, 1000.0, _FILL,
                           _CHILD_CAP, _CHILD_RATE)
    s2 = await led.settle("r2", "t", 1500.0)
    out += [tuple(r2), tuple(s2), _peek(st, "t", 1000.0, _FILL)]
    r3 = await led.reserve("r3", "t", "k", 10, 1000.0, _FILL,
                           _CHILD_CAP, _CHILD_RATE)
    out += [tuple(r3), led.debt_denials, led.numeric_stats(),
            led.conservation(), led.stats()]
    await st.aclose()
    return out


def test_ledger_refund_and_debt_match_jax():
    got, want = _both(_refund_and_debt)
    assert got == want
    r, _, by_tenant, s, t_bal, k_bal, out_after = got[:7]
    assert r[0] and r[1] == 100.0 and by_tenant == {"t": 100.0}
    # Over-estimate: the refund lands in BOTH levels.
    assert s == ("settled", -60.0, 60.0, 0.0)
    assert t_bal == 960.0 and k_bal == _CHILD_CAP - 40.0
    assert out_after == 0.0
    # Under-estimate past the whole budget: the uncovered part is debt.
    assert got[8][:2] == ("settled", 1400.0) and got[8][3] == 540.0
    assert got[9] == 0.0
    # The next reserve must cover the debt first — empty budget: denied.
    assert not got[10][0] and got[10][3] == 540.0 and got[11] == 1
    assert got[13]["residue"] == 0.0


async def _debt_collected_once(pk):
    """tests/test_reservations.py:128: the debt is paid down once from a
    refilled budget, then the reserve admits."""
    st = _store(pk)
    led, _t = _ledger(pk, st)
    out = []
    await led.reserve("r1", "t", "k", 100, 1000.0, 50.0,
                      _CHILD_CAP, _CHILD_RATE)
    out.append(tuple(await led.settle("r1", "t", 1500.0)))
    out.append(led.debts())
    st.clock.advance_seconds(120.0)  # refills the tenant bucket fully
    out.append(tuple(await led.reserve("r2", "t", "k", 10, 1000.0, 50.0,
                                       _CHILD_CAP, _CHILD_RATE)))
    out += [led.debts(), led.debt_tokens_collected,
            _peek(st, "t", 1000.0, 50.0)]
    # A second reserve finds no debt to collect.
    out.append(tuple(await led.reserve("r3", "t", "k", 10, 1000.0, 50.0,
                                       _CHILD_CAP, _CHILD_RATE)))
    out += [led.debt_tokens_collected, _peek(st, "t", 1000.0, 50.0)]
    await st.aclose()
    return out


def test_ledger_debt_collected_once_matches_jax():
    got, want = _both(_debt_collected_once)
    assert got == want
    assert got[1]["t"] == 500.0
    assert got[2][0] and got[2][3] == 0.0 and got[3] == {}
    assert got[4] == 500.0 and got[5] == 1000.0 - 500.0 - 10.0
    assert got[6][0] and got[7] == 500.0 and got[8] == 480.0


async def _idempotency(pk):
    """tests/test_reservations.py:149."""
    st = _store(pk)
    led, _t = _ledger(pk, st)
    out = []
    for args in (("r1", "t", "k", 100), ("r1", "t", "k", 100)):
        out.append(tuple(await led.reserve(*args, 1000.0, _FILL,
                                           _CHILD_CAP, _CHILD_RATE)))
    out.append(_peek(st, "t", 1000.0, _FILL))
    out.append(tuple(await led.settle("r1", "t", 30.0)))
    out.append(tuple(await led.settle("r1", "t", 30.0)))
    out.append(_peek(st, "t", 1000.0, _FILL))
    out.append(tuple(await led.settle("ghost", "t", 10.0)))
    out.append(tuple(await led.reserve("r1", "t", "k", 100, 1000.0, _FILL,
                                       _CHILD_CAP, _CHILD_RATE)))
    out += [_peek(st, "t", 1000.0, _FILL), led.numeric_stats()]
    with pytest.raises(ValueError):
        await led.reserve("", "t", "k", 1, 1000.0, _FILL, _CHILD_CAP,
                          _CHILD_RATE)
    for bad in (-1.0, float("nan")):
        with pytest.raises(ValueError):
            await led.settle("r1", "t", bad)
    await st.aclose()
    return out


def test_ledger_idempotency_under_retry_matches_jax():
    got, want = _both(_idempotency)
    assert got == want
    assert got[1][0] and got[1][4]  # the retry is a duplicate grant
    assert got[2] == 900.0  # the tenant balance moved exactly once
    assert got[3][0] == "settled" and got[4][0] == "duplicate"
    assert got[4][1:] == got[3][1:]
    assert got[5] == 970.0  # zero double refunds
    assert got[6][0] == "unknown"
    assert got[7][0] and got[7][4] and got[8] == 970.0
    stats = got[9]
    assert stats["settle_unknown"] == 1 and stats["reserve_duplicates"] == 2


class _Recorder:
    def __init__(self):
        self.frames = []

    def record(self, kind, **fields):
        self.frames.append(dict(kind=kind, **fields))


async def _ttl(pk):
    """tests/test_reservations.py:180: an unsettled hold auto-settles at
    its estimate on the ledger's clock; a late settle replays it."""
    st = _store(pk)
    led, t = _ledger(pk, st, default_ttl_s=5.0)
    led.flight_recorder = rec = _Recorder()
    await led.reserve("r1", "t", "k", 100, 1000.0, _FILL,
                      _CHILD_CAP, _CHILD_RATE, deadline_s=2.0)
    await led.reserve("r2", "t", "k", 50, 1000.0, _FILL,
                      _CHILD_CAP, _CHILD_RATE, ttl_s=60.0)
    t[0] = 6.0
    out = [led.expire(), led.ttl_expired, led.outstanding_by_tenant(),
           _peek(st, "t", 1000.0, _FILL), list(rec.frames)]
    out.append(tuple(await led.settle("r1", "t", 40.0)))
    out += [_peek(st, "t", 1000.0, _FILL), led.numeric_stats()]
    t[0] = 70.0
    out += [led.stats()["ttl_expired"], led.outstanding_count()]
    await st.aclose()
    return out


def test_ledger_ttl_auto_settles_at_estimate_matches_jax():
    got, want = _both(_ttl)
    assert got == want
    assert got[0] == 1 and got[1] == 1  # r1 only; r2's explicit TTL holds
    assert got[2] == {"t": 50.0}
    assert got[3] == 850.0  # the hold became the spend: no refund
    assert got[4] == [{"kind": "reservation", "event": "ttl_expired",
                       "rid": "r1", "tenant": "t", "reserved": 100.0}]
    assert got[5][0] == "duplicate" and got[6] == 850.0
    assert got[7]["deadline_expired_grants"] == 1
    assert got[8] == 2 and got[9] == 0  # the stats scrape expires r2


async def _bounded(pk):
    """tests/test_reservations.py:212."""
    st = _store(pk)
    led, _t = _ledger(pk, st, max_entries=2)
    out = [tuple(await led.reserve(f"r{i}", "t", "k", 1, 1000.0, _FILL,
                                   _CHILD_CAP, _CHILD_RATE))
           for i in range(3)]
    out += [led.ledger_full_denials, _peek(st, "t", 1000.0, _FILL)]
    for bad in ({"max_entries": 0}, {"max_settled": 0},
                {"default_ttl_s": 0.0}):
        with pytest.raises(ValueError):
            pk.res.ReservationLedger(st, **bad)
    await st.aclose()
    return out


def test_ledger_bounded_denies_loudly_matches_jax():
    got, want = _both(_bounded)
    assert got == want
    assert got[0][0] and got[1][0] and not got[2][0]
    assert got[3] == 1 and got[4] == 998.0


def _debt_dedup_trace(pk):
    """tests/test_reservations.py:230, ledger-level: a debt restored on
    abort and re-exported under the same tag applies once at the new
    owner; reservation rows move with their TTL and dedup by rid."""
    led_src, ts = _ledger(pk, None)
    led_dst, td = _ledger(pk, None)
    out = []
    led_src._debts["t"] = 500.0
    led_src._add_entry(pk.res._Reservation(
        "h1", "t", "k", 30.0, 9.0, 1.0, 90.0, 2.0, 1, 10.0, 4.0))
    led_src.reserved_tokens_total += 30.0
    ts[0], td[0] = 4.0, 100.0
    res1, debts1 = led_src.export_rows(lambda _t: True, tag="epoch:7")
    out += [res1, debts1, led_src.debts(), led_src.outstanding_tokens()]
    out.append(led_dst.restore_rows(res1, debts1))
    out += [led_dst.debts(), led_dst.outstanding_by_tenant()]
    out.append(led_src.restore_rows(res1, debts1))
    res2, debts2 = led_src.export_rows(lambda _t: True, tag="epoch:7")
    out.append(led_dst.restore_rows(res2, debts2))
    out.append(led_dst.debts())
    led_src._debts["t"] = 100.0
    _res3, debts3 = led_src.export_rows(lambda _t: True, tag="epoch:9")
    led_dst.restore_rows([], debts3)
    out.append(led_dst.debts())
    out += [led_dst.drop_rids(["h1", "nope"]), led_dst.aborted_imports,
            led_dst.outstanding_tokens(), led_src.conservation(),
            led_dst.conservation()]
    return out


def test_debt_rows_dedup_on_abort_retry_matches_jax():
    got = _debt_dedup_trace(PACKAGES["port"])
    want = _debt_dedup_trace(PACKAGES["jax"])
    assert got == want
    assert got[0] == [["t", "h1", "k", 30.0, 9.0, 1.0, 90.0, 2.0, 1, 6.0]]
    assert got[5] == {"t": 500.0} and got[6] == {"t": 30.0}
    assert got[9] == {"t": 500.0}  # not 1000
    assert got[10] == {"t": 600.0}  # a later episode merges
    assert got[11] == 1 and got[13] == 0.0
    assert got[14]["residue"] == 0.0 and got[15]["residue"] == 0.0


def test_fallback_charge_and_route_messages_match_jax():
    for est in (None, 0, -3.0, 0.4, 1.0, 12.3, 64.0, 1e6 + 0.5):
        assert pres.fallback_charge(est) == jres.fallback_charge(est)
    assert pres.fallback_charge(None) == int(pres.DEFAULT_ESTIMATE) == 64
    assert pres.fallback_charge(12.3) == 13
    assert (pres.DEFAULT_TTL_S, pres.DEFAULT_ESTIMATE, pres.ROUTE_PREFIX) \
        == (jres.DEFAULT_TTL_S, jres.DEFAULT_ESTIMATE, jres.ROUTE_PREFIX)
    msg = pres.route_message("pool:batch", 5e5, 1e3, 1)
    assert msg == jres.route_message("pool:batch", 5e5, 1e3, 1)
    for text in (msg, "relay: " + msg, "plain error",
                 pres.ROUTE_PREFIX + "{not json",
                 pres.ROUTE_PREFIX + '{"pool": "p"}',
                 pres.ROUTE_PREFIX + "[1, 2]"):
        assert pres.parse_route(text) == jres.parse_route(text)
    assert pres.parse_route("relay: " + msg) == {
        "pool": "pool:batch", "ta": 5e5, "tb": 1e3, "priority": 1}
    assert pres.parse_route(pres.ROUTE_PREFIX + "{not json") is None
    assert set(pres.__all__) == set(jres.__all__) | {"DEFAULT_ESTIMATE"}


# -- seeded differentials ---------------------------------------------------

def _llm_workload(seed: int, n_rows: int):
    """``benchmarks/llm_workload.py``'s ``gen_workload``, copied: 64
    tenants Zipf(1.2), keys ``t{t}/u{zipf(1.5) % 200}``, costs
    LogNormal(4.0, 1.3) clamped to [1, 8192], priorities 60/30/10."""
    rng = np.random.default_rng(seed)
    t_idx = rng.zipf(1.2, n_rows) % 64
    costs = np.minimum(np.maximum(rng.lognormal(4.0, 1.3, n_rows), 1.0),
                       8192).astype(np.int64)
    u = rng.random(n_rows)
    prios = np.where(u < 0.6, 0, np.where(u < 0.9, 1, 2)).astype(np.int8)
    keys = [f"t{t}/u{rng.zipf(1.5) % 200}" for t in t_idx]
    tenants = [f"tenant:{t}" for t in t_idx]
    return tenants, keys, costs, prios


#: The differential's budgets: the tenant binds (the Zipf head runs out,
#: so denials, debt and its collection all happen); refill rates are whole
#: tokens a tick, advanced one tick a row.
DIFF_TENANT = (20_000.0, 2048.0)
DIFF_KEY = (6_000.0, 1024.0)


async def _llm_differential(pk, n, estimates_seed, fractional):
    tenants, keys, costs, prios = _llm_workload(9, n)
    rng = np.random.default_rng(estimates_seed)
    estimates = np.maximum(costs * rng.lognormal(0.0, 0.55, n), 1.0)
    if fractional:
        actuals = costs * rng.uniform(0.3, 1.9, n)
        tcap, trate = 300.0, 1000.0 / 3.0
        kcap, krate = 1500.0, 100.0 / 3.0
    else:
        actuals = costs.astype(np.float64)
        tcap, trate = DIFF_TENANT
        kcap, krate = DIFF_KEY
    st = _store(pk, n_slots=4096, max_batch=64)
    led = st.reservation_ledger()
    rows = []
    for i in range(n):
        st.clock.advance_ticks(1)
        r = await led.reserve(f"r{i}", tenants[i], keys[i],
                              float(estimates[i]), tcap, trate, kcap, krate,
                              priority=int(prios[i]))
        s = None
        if r.granted:
            s = await led.settle(f"r{i}", tenants[i], float(actuals[i]))
        rows.append((tuple(r), None if s is None else tuple(s)))
    balances = {t: _peek(st, t, tcap, trate) for t in sorted(set(tenants))}
    balances.update({k: _peek(st, k, kcap, krate) for k in sorted(set(keys))})
    out = (rows, led.numeric_stats(), led.debts(), balances,
           led.conservation())
    await st.aclose()
    return out


def test_llm_differential_whole_numbers_matches_jax():
    """2,000 LLM-workload rows reserved at LogNormal(0, 0.55) estimates
    and settled at their whole-number costs, on both packages' stores:
    results, counters and debts equal; balances within 2 float32 spacings
    of their bucket's capacity."""
    (rows, stats, debts, bal, cons), want = _both(
        _llm_differential, 2000, 0x5E771E, False)
    assert rows == want[0]
    assert stats == want[1]
    assert debts == want[2]
    assert bal.keys() == want[3].keys()
    for k, v in bal.items():
        cap = DIFF_TENANT[0] if k.startswith("tenant:") else DIFF_KEY[0]
        assert abs(v - want[3][k]) <= 2 * _spacings(cap), k
    assert cons == want[4]
    granted = sum(r[0][0] for r in rows)
    assert 0 < granted < len(rows)  # the tenant budget binds
    assert stats["refunds"] > 0 and stats["debts_created"] > 0
    assert stats["debt_denials"] > 0 and stats["debt_tokens_collected"] > 0
    assert abs(cons["residue"]) < 1e-6


def test_llm_differential_fractional_actuals_within_tolerance():
    """100 rows settled at fractional actuals against refill rates with no
    exact float32 tick: grants, outcomes and integer counters equal; float
    fields, balances and debts within ``FRACTION_ATOL``."""
    got, want = _both(_llm_differential, 100, 7, True)
    for (gr, gs), (wr, ws) in zip(got[0], want[0], strict=True):
        assert gr[0] == wr[0] and gr[4:] == wr[4:]
        np.testing.assert_allclose(gr[1:4], wr[1:4], atol=FRACTION_ATOL,
                                   rtol=0)
        assert (gs is None) == (ws is None)
        if gs is not None:
            assert gs[0] == ws[0]
            np.testing.assert_allclose(gs[1:], ws[1:], atol=FRACTION_ATOL,
                                       rtol=0)
    for name, v in got[1].items():
        if isinstance(v, int):
            assert v == want[1][name], name
        else:
            assert v == pytest.approx(want[1][name], abs=FRACTION_ATOL), name
    assert got[2].keys() == want[2].keys()
    for t, v in got[2].items():
        assert v == pytest.approx(want[2][t], abs=FRACTION_ATOL)
    for k, v in got[3].items():
        assert v == pytest.approx(want[3][k], abs=FRACTION_ATOL), k
    assert got[1]["refunds"] > 0 and got[1]["debts_created"] > 0


# -- the store seam and AdmissionPolicy -------------------------------------

async def _store_seam(pk):
    st = _store(pk)
    led = st.reservation_ledger(default_ttl_s=7.0)
    out = [st.reservation_ledger() is led, led.default_ttl_s]
    out.append(tuple(await st.reserve("s1", "t", "k", 12.5, 100.0, _FILL,
                                      50.0, _FILL, priority=1, attempt=1)))
    out.append(tuple(await st.settle("s1", "t", 4.0)))
    out.append(tuple(await st.reserve("s2", "t", "k", 60.0, 100.0, _FILL,
                                      50.0, _FILL)))
    # The child denied the reserve: the fused decision debited neither
    # level, so there is nothing to refund.
    out += [_peek(st, "t", 100.0, _FILL), _peek(st, "k", 50.0, _FILL),
            led.numeric_stats()]
    await st.aclose()
    return out


def test_store_reserve_and_settle_match_jax():
    got, want = _both(_store_seam)
    assert got == want
    assert got[0] and got[1] == 7.0
    assert got[2][:2] == (True, 13.0) and got[3][:3] == ("settled", -9.0, 9.0)
    assert not got[4][0]
    assert got[5] == 96.0 and got[6] == 46.0
    assert got[7]["retry_grants"] == 1 and got[7]["retry_reserves"] == 1


class _PolicyClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


async def _policy_trace(pk):
    st = _store(pk, max_batch=64)
    clock = _PolicyClock()
    pol = pk.adm.AdmissionPolicy(st, key_config=(500.0, 50.0),
                                 velocity_tau_s=5.0, clock=clock)
    pol.set_tenant(pk.adm.TenantBudget("acme", 1000.0, 100.0))
    pol.set_tenant(pk.adm.TenantBudget("beta", 300.0, 10.0))
    out = []
    rng = np.random.default_rng(17)
    for i in range(40):
        t = "acme" if i % 3 else "beta"
        est = None if i % 4 == 0 else float(rng.integers(5, 80))
        r = await pol.reserve(t, f"u{i % 5}", estimate=est, priority=i % 3,
                              rid=f"p{i}", attempt=int(i % 13 == 12))
        out.append(tuple(r))
        if r.granted:
            s = await pol.settle(f"p{i}", t, float(rng.integers(1, 90)),
                                 priority=i % 3)
            out.append(tuple(s))
        clock.t += 0.1
        st.clock.advance_seconds(0.05)
    pol.set_shed_level(pk.adm.PRIORITY_SCAVENGER)
    out.append(tuple(await pol.reserve("acme", "u1", estimate=3.0,
                                       priority=pk.adm.PRIORITY_SCAVENGER,
                                       rid="shed")))
    pol.set_retry_shed(True)
    out.append(tuple(await pol.reserve("acme", "u1", estimate=3.0,
                                       rid="retry", attempt=1)))
    pol.set_shed_level(None)
    pol.set_retry_shed(False)
    out.append(tuple(await pol.settle("never", "acme", 5.0)))
    with pytest.raises(KeyError):
        await pol.reserve("nobody", "u", estimate=1.0, rid="x")
    rid = pol.next_rid("acme")
    out.append(rid.split("#")[::2])
    out.append(tuple(await pol.reserve("acme", "u2", rid=rid)))
    out += [pol.prior.estimate("acme", 0), pol.prior.estimate("beta", 1),
            pol.stats(), st.reservation_ledger().numeric_stats()]
    await st.aclose()
    return out


def test_admission_policy_reservation_lane_matches_jax():
    got, want = _both(_policy_trace)
    assert got == want
    stats = got[-2]
    # Every grant but the last (the next_rid one) was settled.
    assert 0 < stats["reserves"] < 40
    assert stats["settles"] == stats["reserves"] - 1
    assert stats["shed"] == 2 and stats["retries_shed"] == 1
    assert stats["token_velocity"]["admitted"]
    assert got[-6] == ["acme", "1"]  # next_rid: tenant#<gateway>#seq
    assert got[-7][0] == "unknown"


# -- the wire ---------------------------------------------------------------

class _Server:
    def __init__(self, kind, **kw):
        self.kind = kind
        if kind == "port":
            self.store = DeviceBucketStore(device="cpu", n_slots=128,
                                           max_batch=32,
                                           clock=ManualClock(START))
            self.server = BucketStoreServer(self.store, **kw)
        else:
            self.store = JStore(n_slots=128, max_batch=32,
                                clock=JClock(START))
            self.server = JServer(self.store, **kw)

    async def __aenter__(self):
        await w(self.server.start())
        return self

    async def __aexit__(self, *exc):
        await w(self.server.aclose())
        await self.store.aclose()

    @property
    def address(self):
        return (self.server.host, self.server.port)


async def _wire_pairing(server_kind, client_kind):
    async with _Server(server_kind) as srv:
        cli = (RemoteBucketStore if client_kind == "port" else JRemote)(
            address=srv.address, coalesce_requests=False)
        out = []
        try:
            r = await w(cli.reserve("w1", "t", "k", 100, 1000.0, _FILL,
                                    _CHILD_CAP, _CHILD_RATE))
            out.append(tuple(r))
            out.append(tuple(await w(cli.reserve(
                "w1", "t", "k", 100, 1000.0, _FILL, _CHILD_CAP,
                _CHILD_RATE))))
            out.append(tuple(await w(cli.settle("w1", "t", 25.0))))
            out.append(tuple(await w(cli.settle("w1", "t", 25.0))))
            out.append(tuple(await w(cli.settle("ghost", "t", 5.0))))
            # No estimate on the wire: the server-side prior (the tenant's
            # settled 25.0, interactive p99) sizes the charge.
            out.append(tuple(await w(cli.reserve(
                "w2", "t", "k", None, 1000.0, _FILL, _CHILD_CAP,
                _CHILD_RATE, ttl_s=300.0, attempt=1, deadline_s=5.0))))
            # An under-estimate past the budget becomes debt.
            out.append(tuple(await w(cli.reserve(
                "w3", "t", "k2", 10, 1000.0, _FILL, _CHILD_CAP,
                _CHILD_RATE, priority=1))))
            out.append(tuple(await w(cli.settle("w3", "t", 2000.0))))
            out.append(tuple(await w(cli.reserve(
                "w4", "t", "k", 10, 1000.0, _FILL, _CHILD_CAP,
                _CHILD_RATE))))
            with pytest.raises(Exception, match="requires rid"):
                await w(cli.reserve("", "t", "k", 1, 1000.0, _FILL,
                                    _CHILD_CAP, _CHILD_RATE))
            led = srv.server.reservations
            before = dict(led.numeric_stats())
            stats = await w(cli.stats(reset=True))
            after = led.numeric_stats()
            section = stats["reservations"]
            out.append(after == before)
            out.append({k: section[k] for k in before})
            out.append((section["debts"], section["outstanding_by_tenant"]))
            out.append(led.outstanding_tokens())
            out.append(sorted(stats["token_velocity"]["admitted"]))
            out.append([_peek(srv.store, "t", 1000.0, _FILL),
                        _peek(srv.store, "k", _CHILD_CAP, _CHILD_RATE),
                        _peek(srv.store, "k2", _CHILD_CAP, _CHILD_RATE)])
            rs = cli.resilience_stats()
            out.append((rs["reserve_fallbacks"], rs["reserves_routed"],
                        cli._peer_reserve))
            return out
        finally:
            await w(cli.aclose())


def test_wire_reserve_settle_four_pairings():
    got = {(s, c): asyncio.run(_wire_pairing(s, c))
           for s in ("port", "jax") for c in ("port", "jax")}
    want = got[("jax", "jax")]
    assert all(v == want for v in got.values()), got
    assert want[0][:2] == (True, 100.0) and want[1][4]  # a duplicate
    assert want[2] == ("settled", -75.0, 75.0, 0.0)
    assert want[3][0] == "duplicate" and want[4][0] == "unknown"
    assert want[5][:2] == (True, 25.0)  # the server-side prior
    assert want[7][0] == "settled" and want[7][3] > 0  # debt
    assert not want[8][0] and want[8][3] == want[7][3]
    assert want[9] is True  # stats(reset=True) never touches the ledger
    assert want[10]["reserves"] == 4 and want[10]["settle_duplicates"] == 1
    assert want[12] == 25.0
    assert want[13] == ["t"]  # settles feed the server's velocity
    assert want[15] == (0, 0, True)  # served: no fallback latch


def test_port_server_serves_the_reservation_ops():
    # Every op is served since the federation lane was ported: the table
    # of unserved ops is gone, and the dispatch names both ops.
    assert not hasattr(pserver, "_UNPORTED_OPS")
    import inspect
    src = inspect.getsource(pserver.BucketStoreServer._handle_frame_inner)
    assert "wire.OP_RESERVE" in src and "wire.OP_SETTLE" in src


def test_port_client_chases_a_jax_servers_route_to_pool_redirect():
    """A JAX server built with ``overflow_pool=`` redirects an interactive
    reserve whose estimate cannot fit the tenant's budget inside its
    deadline; the port client re-sends once against the named pool, as
    the JAX client does, and the result reads ``routed=True``."""
    pool = {"pool": "pool:batch", "ta": 1e6, "tb": 1e3, "priority": 1}

    async def main(client_kind):
        async with _Server("jax", overflow_pool=pool) as srv:
            cli = (RemoteBucketStore if client_kind == "port" else JRemote)(
                address=srv.address, coalesce_requests=False)
            try:
                r = await w(cli.reserve("o1", "t", "k", 500, 100.0, 10.0,
                                        _CHILD_CAP, _CHILD_RATE,
                                        deadline_s=0.01))
                s = await w(cli.settle("o1", r.pool, 400.0))
                fits = await w(cli.reserve("o2", "t", "k", 50, 100.0, 10.0,
                                           _CHILD_CAP, _CHILD_RATE,
                                           deadline_s=0.01))
                return (tuple(r), tuple(s), tuple(fits),
                        cli.resilience_stats()["reserves_routed"],
                        _peek(srv.store, "pool:batch", 1e6, 1e3),
                        _peek(srv.store, "t", 100.0, 10.0))
            finally:
                await w(cli.aclose())

    got, want = asyncio.run(main("port")), asyncio.run(main("jax"))
    assert got == want
    r, s, fits, routed, pool_bal, t_bal = got
    assert r[0] and r[1] == 500.0 and r[6] is True and r[7] == "pool:batch"
    assert s == ("settled", -100.0, 100.0, 0.0)
    assert fits[0] and not fits[6]
    assert routed == 1 and pool_bal == 1e6 - 400.0 and t_bal == 50.0


@pytest.mark.parametrize("estimate", [100, None])
def test_port_client_latches_on_a_server_without_the_lane(estimate):
    """tests/test_reservations.py:427 and :279: a server that answers the
    reservation ops with "unknown op" makes the client latch once, charge
    ``fallback_charge(estimate)`` through the two-level lane, and answer
    settles client-side — counted."""
    async def main():
        store = DeviceBucketStore(device="cpu", clock=ManualClock(START))
        srv = BucketStoreServer(store)
        real = srv.handle_frame_body

        async def old_peer(body, arrival_s=None):
            if len(body) >= 6 and (body[5] & 0x3F) in (pw.OP_RESERVE,
                                                       pw.OP_SETTLE):
                return pw.encode_response(pserver._recover_seq(body),
                                          pw.RESP_ERROR,
                                          f"unknown op {body[5] & 0x3F}")
            return await real(body, arrival_s=arrival_s)

        srv.handle_frame_body = old_peer
        await w(srv.start())
        cli = RemoteBucketStore(address=(srv.host, srv.port),
                                coalesce_requests=False)
        try:
            r = await w(cli.reserve("f1", "t", "k", estimate, 1000.0,
                                    _FILL, _CHILD_CAP, _CHILD_RATE))
            charge = pres.fallback_charge(estimate)
            assert r.granted and r.fallback and r.reserved == charge
            assert not cli._peer_reserve
            assert cli.resilience_stats()["reserve_fallbacks"] == 1
            # The charge went through the two-level lane outright.
            assert _peek(store, "t", 1000.0, _FILL) == 1000.0 - charge
            assert _peek(store, "k", _CHILD_CAP, _CHILD_RATE) == \
                _CHILD_CAP - charge
            s = await w(cli.settle("f1", "t", 10.0))
            assert tuple(s) == ("fallback", 0.0, 0.0, 0.0)
            r2 = await w(cli.reserve("f2", "t", "k", estimate, 1000.0,
                                     _FILL, _CHILD_CAP, _CHILD_RATE))
            assert r2.fallback
            assert cli.resilience_stats()["reserve_fallbacks"] == 3
            assert _peek(store, "t", 1000.0, _FILL) == 1000.0 - 2 * charge
            assert not srv.reservations.active  # the ledger never served
        finally:
            await w(cli.aclose())
            await w(srv.aclose())
            await store.aclose()

    asyncio.run(main())


def test_client_store_serves_no_local_ledger():
    assert RemoteBucketStore.reservation_ledger is None
    srv = BucketStoreServer(RemoteBucketStore(address=("127.0.0.1", 1)))
    assert srv.reservations is None


def test_reservations_module_imports_no_jax():
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import distributedratelimiting.redis_tpu_torch.runtime."
        "reservations\n"
        "print(any(m == 'jax' or m.startswith(('jax.', "
        "'distributedratelimiting.redis_tpu.'))\n"
        "          for m in sys.modules if sys.modules[m] is not None))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=root,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False"]
