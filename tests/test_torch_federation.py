"""The port's global quota federation against the JAX package's, on the CPU.

Each scenario of ``tests/test_federation.py`` is written once and run on
both packages: the JAX ``FederationLedger`` / ``RegionFederation`` over the
JAX ``InProcessBucketStore`` and servers, and the port's over its
``InProcessBucketStore`` and over ``DeviceBucketStore(device="cpu")`` (the
card store's code on its plain kernels: the home's charges go through
``debit_many``, the ``debit_packed`` path). Every lease, renew and reclaim
reply, every ledger and agent counter, and every balance is held to JAX's.

Tolerance: exact on ids, epochs, flags, outcomes, counts, events and grants
(``_same`` compares every non-float exactly); within 1e-6 relative on
token fields, where a float32 debit stands between (every schedule here is
whole tokens on a rate-0 or whole-rate budget, so they agree exactly in
practice). A float field equals an int of the same value: JAX's ledger
keeps ``math.floor``'s int as a slice cap until a checkpoint row turns it
into a float, on either package.

Beyond the JAX file: the unit formulas over a seeded grid; the crossings —
a JAX region agent leasing from a port home server and a port agent from a
JAX home, a port home's checkpoint chain loaded by JAX's
``load_snapshot_chain`` and the reverse (equal ``export_state()``), and a
JAX ledger's ``export_state()`` restored into the port's ledger (equal
replies after); ``slice_applier`` over a port ``ClusterBucketStore``
(``mutate_config``) and over one port ``RemoteBucketStore``
(``config_announce``); and the 3-region soak, whose summary (grants,
events, ledger counters, agent counters, flight frames, shares) equals
JAX's for the same seed, with the home over the serial store and over the
CPU card store.
"""

from __future__ import annotations

import asyncio
import math
import os
import time as _time
import types

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.runtime import checkpoint as jcp
from distributedratelimiting.redis_tpu.runtime import controller as jctl
from distributedratelimiting.redis_tpu.runtime import federation as jfed
from distributedratelimiting.redis_tpu.runtime import server as jserver
from distributedratelimiting.redis_tpu.runtime import wire as jw
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JInProcess,
)
from distributedratelimiting.redis_tpu.utils import faults as jfaults
from distributedratelimiting.redis_tpu.utils.flight_recorder import (
    FlightRecorder as JFlight,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    InProcessBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.runtime import checkpoint as pcp
from distributedratelimiting.redis_tpu_torch.runtime import controller as pctl
from distributedratelimiting.redis_tpu_torch.runtime import federation as pfed
from distributedratelimiting.redis_tpu_torch.runtime import server as pserver
from distributedratelimiting.redis_tpu_torch.runtime import wire as pw
from distributedratelimiting.redis_tpu_torch.runtime.cluster import (
    ClusterBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime.remote import (
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.utils import faults as pfaults
from distributedratelimiting.redis_tpu_torch.utils.flight_recorder import (
    FlightRecorder,
)

SEED = int(os.environ.get("DRL_FEDERATION_SEED", "20260804"))

TENANT = "tenant:g"
G_CAP, G_RATE = 600.0, 0.0     # pure-burst global budget: exact audits
TTL = 6.0
#: Relative tolerance on token fields where a float32 debit stands between.
TOKEN_RTOL = 1e-6
LIMIT_S = 60.0


def _port_store(kind: str):
    if kind == "inprocess":
        return InProcessBucketStore(clock=ManualClock())
    return DeviceBucketStore(device="cpu", n_slots=1024, clock=ManualClock())


PORT = types.SimpleNamespace(
    name="port", fed=pfed, cp=pcp, wire=pw, ctl=pctl, faults=pfaults,
    server=pserver, Flight=FlightRecorder, Server=pserver.BucketStoreServer,
    Remote=RemoteBucketStore, store=_port_store)
JAX = types.SimpleNamespace(
    name="jax", fed=jfed, cp=jcp, wire=jw, ctl=jctl, faults=jfaults,
    server=jserver, Flight=JFlight, Server=jserver.BucketStoreServer,
    Remote=JRemote, store=lambda _kind: JInProcess(clock=JClock()))
#: The port's store kinds; the JAX side always runs its serial store.
KINDS = ("inprocess", "device")


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT_S))


def _same(got, want, path="") -> None:
    """Field by field: floats within ``TOKEN_RTOL`` relative, everything
    else (ids, epochs, flags, outcomes, counts) exactly."""
    numbers = (int, float)
    if (isinstance(want, float) or isinstance(got, float)) \
            and isinstance(got, numbers) and isinstance(want, numbers) \
            and not isinstance(got, bool) and not isinstance(want, bool):
        assert math.isclose(got, want, rel_tol=TOKEN_RTOL,
                            abs_tol=TOKEN_RTOL), (path, got, want)
        return
    assert type(got) is type(want), (path, got, want)
    if isinstance(want, dict):
        assert list(got) == list(want), (path, list(got), list(want))
        for k in want:
            _same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{path}[{i}]")
    else:
        assert got == want, (path, got, want)


def _both(scenario, kind, *args):
    """``scenario(pk, kind, *args)`` on the port (store ``kind``) and on
    JAX; asserts the two records equal field by field, returns the
    port's."""
    mine = run(scenario(PORT, kind, *args))
    theirs = run(scenario(JAX, kind, *args))
    _same(mine, theirs)
    return mine


class Mono:
    """Manual monotonic clock (float seconds) for lease TTLs."""

    def __init__(self, t: float = 0.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def _ledger(pk, kind, **kw):
    store = pk.store(kind)
    mono = kw.pop("mono", None) or Mono()
    led = store.federation_ledger(clock=mono, default_ttl_s=TTL, **kw)
    return store, led, mono


def _jax_view(state: dict) -> dict:
    """A ledger's ``export_state()`` less the port's ``conservation``
    section (the one field JAX's lacks; see
    :func:`test_conservation_survives_a_restart_between_charge_and_heal`)."""
    return {k: v for k, v in state.items() if k != "conservation"}


def _balance(store, key=TENANT, cap=G_CAP, rate=G_RATE) -> float:
    return float(store.peek_blocking(key, cap, rate))


def _lease_req(region, lease_id, demand=1.0, **kw):
    return dict({"region": region, "lease_id": lease_id, "tenant": TENANT,
                 "demand": demand, "global_cap": G_CAP,
                 "global_rate": G_RATE}, **kw)


def _renew_req(region, lease_id, total, demand=1.0):
    return {"region": region, "lease_id": lease_id, "tenant": TENANT,
            "total": total, "demand": demand}


# -- the unit formulas -------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_degraded_config_and_epsilon_over_a_seeded_grid(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        cap = float(rng.choice([0.0, 1.0, float(rng.integers(0, 10**6)),
                                float(rng.uniform(0, 500))]))
        rate = float(rng.choice([0.0, float(rng.uniform(0, 1e4))]))
        frac = float(rng.choice([0.5, float(rng.uniform(0.01, 1.0))]))
        n = int(rng.integers(1, 9))
        period = float(rng.uniform(0, 30))
        part = float(rng.choice([0.0, float(rng.uniform(0, 120))]))
        got = pfed.degraded_config(cap, rate, frac)
        assert got == jfed.degraded_config(cap, rate, frac)
        assert got[0] >= 1.0 and got[1] >= 0.0   # never hard-down
        assert pfed.federation_epsilon(n, cap, rate, period, part, frac) \
            == jfed.federation_epsilon(n, cap, rate, period, part, frac)
    # JAX's unit pins, on the port.
    assert pfed.degraded_config(200.0, 10.0) == (100.0, 5.0)
    assert pfed.degraded_config(1.0, 0.0) == (1.0, 0.0)
    assert pfed.degraded_config(0.0, 0.0)[0] >= 1.0
    e1 = pfed.federation_epsilon(3, 200.0, 10.0, 3.0)
    e2 = pfed.federation_epsilon(3, 200.0, 10.0, 3.0, partition_s=12.0)
    assert 0 < e1 < e2
    assert pfed.__all__ == jfed.__all__
    for name in ("DEFAULT_LEASE_TTL_S", "DEFAULT_ENVELOPE_FRACTION",
                 "DEFAULT_MIN_SHARE", "DEFAULT_RESIZE_THRESHOLD"):
        assert getattr(pfed, name) == getattr(jfed, name)


# -- the ledger's unit surface (tests/test_federation.py:109-232) ------------

async def _cycle(pk, kind):
    store, led, mono = _ledger(pk, kind)
    out = [await led.lease(_lease_req("r0", "L1", 4.0))]
    out.append(await led.renew(_renew_req("r0", "L1", 40.0, 4.0)))
    out.append(_balance(store))
    out.append(await led.renew(_renew_req("r0", "L1", 40.0, 4.0)))
    out.append(_balance(store))
    out.append(await led.reclaim(dict(_renew_req("r0", "L1", 55.0))))
    out += [led.outstanding_leases(), _balance(store), led.numeric_stats()]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_lease_renew_reclaim_cycle_exact_accounting(kind):
    r, n1, b1, n2, b2, rc, outstanding, b3, _stats = _both(_cycle, kind)
    assert r["granted"] and r["epoch"] == 1
    assert r["share"] == pytest.approx(0.5)   # at most half the free pool
    assert r["slice"][0] == 300.0
    assert n1["outcome"] == "ok" and n1["charged"] == 40.0
    assert b1 == G_CAP - 40.0
    assert n2["charged"] == 0.0 and b2 == G_CAP - 40.0   # absorbing
    assert rc["outcome"] == "reclaimed" and rc["charged"] == 15.0
    assert outstanding == 0 and b3 == G_CAP - 55.0


async def _lease_idem(pk, kind):
    store, led, mono = _ledger(pk, kind)
    r1 = await led.lease(_lease_req("r0", "L1"))
    r2 = await led.lease(_lease_req("r0", "L1"))
    return [r1, r2, led.leases_granted, led.lease_duplicates,
            led.outstanding_leases()]


@pytest.mark.parametrize("kind", KINDS)
def test_lease_idempotent_by_lease_id(kind):
    r1, r2, granted, dups, outstanding = _both(_lease_idem, kind)
    assert r2["duplicate"] and r2["epoch"] == r1["epoch"]
    assert r2["slice"] == r1["slice"]
    assert granted == 1 and dups == 1 and outstanding == 1


async def _reclaim_audit(pk, kind):
    store, led, mono = _ledger(pk, kind)
    out = [await led.lease(_lease_req("r0", "L1"))]
    out.append(await led.reclaim(_renew_req("r0", "L1", 30.0)))
    out.append(_balance(store))
    out.append(await led.reclaim(_renew_req("r0", "L1", 30.0)))
    out += [_balance(store), led.reclaims, led.reclaim_duplicates]
    # Heal-path edition: expire a second lease conservatively, then
    # reclaim it twice — one refund, the duplicate replays.
    out.append(await led.lease(_lease_req("r0", "L2")))
    mono.advance(TTL + 0.1)
    out.append(led.expire())
    out.append(await led.reclaim(_renew_req("r0", "L2", 10.0)))
    out.append(_balance(store))
    out.append(await led.reclaim(_renew_req("r0", "L2", 10.0)))
    out += [_balance(store), led.numeric_stats()]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_reclaim_retry_at_most_once_audit(kind):
    (_l1, rc1, bal1, rc2, bal2, reclaims, dups, _l2, expired, h1, bal3,
     h2, bal4, _stats) = _both(_reclaim_audit, kind)
    assert rc1["outcome"] == "reclaimed" and rc2["outcome"] == "duplicate"
    assert rc2["charged"] == rc1["charged"]
    assert bal2 == bal1                     # zero side effects
    assert reclaims == 1 and dups == 1
    assert expired == 1
    assert h1["outcome"] == "reclaimed" and h1["refunded"] > 0
    assert h2["outcome"] == "duplicate"
    assert bal4 == bal3                     # at-most-once refund


async def _conservative(pk, kind):
    # resize_threshold huge: the slice stays put, so the conservative
    # charge's arithmetic is exact by inspection.
    store, led, mono = _ledger(pk, kind, resize_threshold=1e9)
    r = await led.lease(_lease_req("r2", "L1"))
    await led.renew(_renew_req("r2", "L1", 20.0))
    mono.advance(TTL + 1.0)                 # partition past the TTL
    expired = led.expire()
    await led._settle_expired()
    charged = _balance(store)
    h = await led.renew(_renew_req("r2", "L1", 50.0))
    return [r, expired, charged, h, _balance(store), led.heals,
            led.numeric_stats(), led.conservation()]


@pytest.mark.parametrize("kind", KINDS)
def test_home_expiry_conservative_then_heal_refunds_exactly(kind):
    r, expired, charged, h, healed, heals, _stats, _cons = _both(
        _conservative, kind)
    slice_cap = r["slice"][0]
    assert expired == 1
    assert charged == G_CAP - 20.0 - slice_cap   # presumed fully spent
    assert h["outcome"] == "expired"
    assert h["refunded"] == slice_cap - 30.0
    assert healed == G_CAP - 50.0
    assert heals == 1


# -- lease TTL under injected clock skew (tests/test_federation.py:236) -------

async def _skew(pk, kind):
    inj = pk.faults.FaultInjector(SEED, {"federation.renew": (
        pk.faults.FaultRule(kind=pk.faults.CLOCK_SKEW, skew_s=3600.0),)})
    skew = inj.clock_skew("federation.renew")
    wall = pk.faults.SkewedClock(
        type("W", (), {"now": staticmethod(_time.time)})(), skew)
    store = pk.store(kind)
    mono = Mono()
    led = store.federation_ledger(clock=mono, wall=wall.now,
                                  default_ttl_s=TTL)
    out = [skew, await led.lease(_lease_req("r0", "L1"))]
    # +1h of wall skew, zero monotonic elapse: nothing may expire.
    out += [led.expire(), led.outstanding_leases()]
    mono.advance(TTL * 0.5)
    out.append(await led.renew(_renew_req("r0", "L1", 0.0)))
    # The TTL re-armed on monotonic time: half a TTL on, still held
    # whatever the wall says.
    mono.advance(TTL * 0.9)
    out += [led.expire(), led.outstanding_leases()]
    mono.advance(TTL * 0.2)                 # past the re-armed TTL
    out += [led.expire(), led.outstanding_leases()]
    # Region side: wall skew alone never degrades, monotonic expiry does.
    agent_mono = Mono()
    agent = pk.fed.RegionFederation(
        "r0", led, tenants={TENANT: (G_CAP, G_RATE)}, ttl_s=TTL,
        clock=agent_mono, wall=wall.now)
    await agent.tick()
    out += [agent.leases_acquired, agent.degraded(TENANT)]
    await agent.tick()
    out.append(agent.degraded(TENANT))
    agent_mono.advance(TTL + 0.1)
    out.append(await agent.tick())
    out += [agent.degraded_entries, agent.numeric_stats()]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_lease_ttl_immune_to_clock_skew(kind):
    """The port's ``faults`` clock-skew seam on the renew path: expiry is
    keyed on MONOTONIC time on both ends — a skewed wall clock neither
    extends nor prematurely kills a lease (JAX's ``fed-no-skew-extension``
    contract, pinned here for the port)."""
    (skew, _lease, exp0, held0, renew, exp1, held1, exp2, held2, acquired,
     deg0, deg1, summary, entries, _stats) = _both(_skew, kind)
    assert skew == 3600.0
    assert exp0 == 0 and held0 == 1
    assert renew["outcome"] == "ok"
    assert exp1 == 0 and held1 == 1
    assert exp2 == 1 and held2 == 0
    assert acquired == 1 and not deg0 and not deg1
    assert summary["degraded"] == 1 and entries == 1


def test_expire_reads_the_monotonic_clock_only():
    """``expire`` never reads the wall clock: a wall that raises, and one a
    day ahead, change nothing; only the monotonic clock expires."""
    def boom():
        raise AssertionError("the wall clock reached a TTL decision")

    for wall in (boom, lambda: _time.time() + 86400.0):
        store = InProcessBucketStore(clock=ManualClock())
        mono = Mono()
        led = store.federation_ledger(clock=mono, wall=wall,
                                      default_ttl_s=TTL)
        run(led.lease(_lease_req("r0", "L1")))
        mono.advance(TTL - 0.01)
        assert led.expire() == 0
        assert led.stats()["outstanding_leases"] == 1.0
        mono.advance(0.02)
        assert led.expire() == 1


# -- the region agent: partition → envelope → heal (:297) ---------------------

async def _degrade(pk, kind):
    store, led, home_mono = _ledger(pk, kind)
    mono = Mono()
    applied: list = []

    async def apply_slice(tenant, old, new):
        applied.append([old, new])

    agent = pk.fed.RegionFederation(
        "r1", led, tenants={TENANT: (G_CAP, G_RATE)},
        apply_slice=apply_slice, ttl_s=TTL, clock=mono)
    await agent.tick()
    slice_cfg = agent.slice(TENANT)
    broken = agent.home

    class _Down:
        async def lease(self, _p):
            raise ConnectionResetError("wan down")
        fed_lease = fed_renew = fed_reclaim = None

        async def renew(self, _p):
            raise ConnectionResetError("wan down")

        async def reclaim(self, _p):
            raise ConnectionResetError("wan down")

    agent.home = _Down()
    mono.advance(TTL * 0.6)
    await agent.tick()                       # renew due → fails, counted
    out = [slice_cfg, agent.renew_failures, agent.partition_errors,
           agent.degraded(TENANT)]
    mono.advance(TTL)
    await agent.tick()                       # past expiry → degrade
    out += [agent.degraded(TENANT), agent.slice(TENANT)]
    home_mono.advance(2 * TTL + 1.0)
    agent.home = broken
    out.append(await agent.tick())           # renew → "expired" → drop
    out.append(await agent.tick())           # fresh lease → heal
    out += [agent.degraded(TENANT), agent.heals, agent.slice(TENANT),
            applied, agent.stats(), led.numeric_stats()]
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_region_partition_degrades_to_envelope_then_heals(kind):
    (slice_cfg, renew_failures, partition_errors, deg0, deg1, env, _t1,
     _t2, deg2, heals, healed_cfg, applied, _stats, _led) = _both(
        _degrade, kind)
    assert slice_cfg is not None
    assert renew_failures >= 1 and partition_errors >= 1
    assert not deg0                          # still inside the lease
    assert deg1 and env == pfed.degraded_config(*slice_cfg)
    assert 1.0 <= env[0] <= slice_cfg[0]     # never hard-down, unlimited
    assert not deg2 and heals >= 1
    assert healed_cfg[0] >= env[0]
    assert tuple(applied[-1][1]) == healed_cfg


# -- the wire end to end, metrics and flight frames (:354) --------------------

async def _wire(pk, kind):
    backing = pk.store(kind)
    mono = Mono()
    backing.federation_ledger(clock=mono, default_ttl_s=TTL)
    srv = pk.Server(backing)
    await srv.start()
    st = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    out = []
    try:
        out.append(await st.fed_lease(_lease_req("r0", "W1", 2.0)))
        out.append(await st.fed_renew(_renew_req("r0", "W1", 25.0, 2.0)))
        before = dict(srv.federation.numeric_stats())
        stats = await st.stats(reset=True)
        out.append(stats["federation"])
        out.append(srv.federation.numeric_stats() == before)
        text = await st.metrics()
        out.append([ln for ln in text.splitlines()
                    if "drl_federation" in ln])
        agent = pk.fed.RegionFederation(
            "rX", st, tenants={TENANT: (G_CAP, G_RATE)}, ttl_s=TTL,
            clock=Mono())
        srv.federation_agent = agent
        text = await st.metrics()
        out.append([ln for ln in text.splitlines()
                    if "drl_federation_region" in ln])
        out.append((await st.stats())["federation_region"])
        out.append([{k: v for k, v in f.items()
                     if k not in ("t", "seq", "mono", "wall")}
                    for f in srv.flight_recorder.frames(kind="federation")])
        out.append(await st.fed_reclaim(_renew_req("r0", "W1", 25.0)))
        out.append(await st.fed_reclaim(_renew_req("r0", "W1", 25.0)))
        return out
    finally:
        await st.aclose()
        await srv.aclose()
        await backing.aclose()


@pytest.mark.parametrize("kind", KINDS)
def test_wire_federation_end_to_end_with_metrics_and_flight(kind):
    (r, n, fed, untouched, lines, region_lines, region, frames, rc,
     rc2) = _both(_wire, kind)
    assert r["granted"] and r["slice"][0] == 300.0
    assert n["outcome"] == "ok" and n["charged"] == 25.0
    assert fed["leases_granted"] == 1 and fed["renews"] == 1
    assert fed["tenants"][TENANT]["leases"]["r0"]["reported_total"] == 25.0
    assert untouched                         # reset never clears them
    assert "drl_federation_leases_granted_total 1" in lines
    assert any(ln.startswith(
        f'drl_federation_slice_share{{tenant="{TENANT}",region="r0"}}')
        for ln in lines)
    assert "drl_federation_region_renews_total 0" in region_lines
    assert region["region"] == "rX"
    assert any(f["event"] == "lease_granted" for f in frames)
    assert rc["outcome"] == "reclaimed" and rc2["outcome"] == "duplicate"


@pytest.mark.parametrize("pairing", ["port-jax", "jax-port"])
def test_wire_federation_across_packages(pairing):
    """A port client against a JAX home server and a JAX client against a
    port home server answer as the same-package pairings do."""
    client_pk, server_pk = (PORT, JAX) if pairing == "port-jax" \
        else (JAX, PORT)

    async def scenario(clients, servers):
        backing = servers.store("inprocess")
        mono = Mono()
        backing.federation_ledger(clock=mono, default_ttl_s=TTL)
        srv = servers.Server(backing)
        await srv.start()
        st = clients.Remote(address=(srv.host, srv.port),
                            coalesce_requests=False)
        try:
            out = [await st.fed_lease(_lease_req("r0", "X1", 2.0)),
                   await st.fed_lease(_lease_req("r0", "X1", 2.0)),
                   await st.fed_renew(_renew_req("r0", "X1", 25.0, 2.0))]
            mono.advance(TTL + 1.0)
            out += [await st.fed_renew(_renew_req("r0", "X1", 40.0, 2.0)),
                    await st.fed_lease(_lease_req("r0", "X2", 2.0)),
                    await st.fed_reclaim(_renew_req("r0", "X2", 50.0)),
                    await st.fed_reclaim(_renew_req("r0", "X2", 50.0)),
                    await st.fed_renew(_renew_req("r0", "nope", 1.0))]
            with pytest.raises(Exception, match="global_cap"):
                await st.fed_lease(_lease_req("r0", "X3", global_cap=-1.0))
            out += [srv.federation.numeric_stats(), _balance(backing),
                    st._peer_fed, st._fed_fallbacks]
            return out
        finally:
            await st.aclose()
            await srv.aclose()
            await backing.aclose()

    crossed = run(scenario(client_pk, server_pk))
    _same(crossed, run(scenario(server_pk, server_pk)))
    _same(crossed, run(scenario(client_pk, client_pk)))
    assert crossed[3]["outcome"] == "expired" and crossed[4]["granted"]
    assert crossed[6]["outcome"] == "duplicate"
    assert crossed[-2] is True and crossed[-1] == 0


@pytest.mark.parametrize("pairing", ["jax-agent-port-home",
                                     "port-agent-jax-home"])
def test_region_agent_leases_across_packages(pairing):
    """A JAX ``RegionFederation`` (over a JAX client) leasing from a port
    home server, and a port agent (over a port client) leasing from a JAX
    home server: leases, renews with a demand shift, a partition past the
    TTL (degrade), the heal and the reclaim answer as the same-package
    pairings do — the agents' counters and slices, the home ledger's
    counters and the global balance."""
    agent_pk, home_pk = (JAX, PORT) if pairing.startswith("jax") \
        else (PORT, JAX)
    tenants = {TENANT: (G_CAP, G_RATE), "tenant:h": (900.0, 3.0)}

    async def scenario(agents, homes):
        backing = homes.store("inprocess")
        home_mono = Mono()
        backing.federation_ledger(clock=home_mono, default_ttl_s=TTL)
        srv = homes.Server(backing)
        await srv.start()
        st = agents.Remote(address=(srv.host, srv.port),
                           coalesce_requests=False)
        mono, admitted, applied = Mono(), {"n": 0.0}, []

        async def apply_slice(tenant, old, new):
            applied.append([tenant, old, list(new)])

        agent = agents.fed.RegionFederation(
            "rx", st, tenants=tenants, apply_slice=apply_slice,
            admitted_total=lambda _t: admitted["n"], ttl_s=TTL, clock=mono)
        out = []
        try:
            for rnd in range(14):
                mono.advance(1.0)
                home_mono.advance(1.0)
                admitted["n"] += 3.0
                if rnd == 6:
                    agent.home = _DownHomeAgent()
                if rnd == 12:
                    agent.home = st
                out.append(await agent.tick(
                    demands={t: 8.0 if rnd >= 3 else 2.0 for t in tenants}))
            out += [await agent.reclaim_all(), agent.numeric_stats(),
                    {t: agent.slice(t) for t in tenants}, applied,
                    srv.federation.numeric_stats(), _balance(backing)]
            return out
        finally:
            await st.aclose()
            await srv.aclose()
            await backing.aclose()

    crossed = run(scenario(agent_pk, home_pk))
    _same(crossed, run(scenario(agent_pk, agent_pk)))
    _same(crossed, run(scenario(home_pk, home_pk)))
    stats = crossed[-5]
    assert stats["leases_acquired"] >= 2 and stats["degraded_entries"] >= 1
    assert stats["heals"] >= 1 and crossed[-6] == 2


class _DownHomeAgent:
    """A partitioned home for either package's agent."""

    async def fed_lease(self, _p, **_kw):
        raise ConnectionResetError("partitioned")

    fed_renew = fed_reclaim = fed_lease


# -- the old-home latch (:413) -------------------------------------------------

async def _old_home(pk, kind):
    backing = pk.store(kind)
    srv = pk.Server(backing)
    real = srv.handle_frame_body

    async def old_peer(body, arrival_s=None):
        if len(body) >= 6 and (body[5] & 0x3F) in (
                pk.wire.OP_FED_LEASE, pk.wire.OP_FED_RENEW,
                pk.wire.OP_FED_RECLAIM):
            return pk.wire.encode_response(
                pk.server._recover_seq(body), pk.wire.RESP_ERROR,
                f"unknown op {body[5] & 0x3F}")
        return await real(body, arrival_s=arrival_s)

    srv.handle_frame_body = old_peer
    await srv.start()
    st = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        out = [await st.fed_lease(_lease_req("r0", "F1"))]
        out.append(st._peer_fed)
        out.append(await st.fed_renew(_renew_req("r0", "F1", 0.0)))
        out.append(st._fed_fallbacks)
        agent = pk.fed.RegionFederation(
            "r0", st, tenants={TENANT: (G_CAP, G_RATE)}, ttl_s=TTL,
            clock=Mono())
        await agent.tick()
        out += [agent.fed_fallbacks, agent.slice(TENANT),
                await st.fed_reclaim(_renew_req("r0", "F1", 0.0)),
                st._fed_fallbacks]
        return out
    finally:
        await st.aclose()
        await srv.aclose()
        await backing.aclose()


@pytest.mark.parametrize("kind", KINDS)
def test_old_home_latches_partition_posture(kind):
    """A home that answers "unknown op": the client latches once and every
    federation call answers ``{"fallback": True}``; the agent counts it
    and stays un-leased."""
    lease, peer, renew, fallbacks, agent_fb, sl, reclaim, after = _both(
        _old_home, kind)
    assert lease == {"fallback": True} and peer is False
    assert renew == {"fallback": True} and fallbacks == 2
    assert agent_fb == 1 and sl is None
    assert reclaim == {"fallback": True} and after == 4


# -- lease state rides the checkpoint chain (:471) ----------------------------

async def _chain(pk, kind, tmp_path):
    path = str(tmp_path / f"home-{pk.name}-{kind}.ckpt")
    store, led, mono = _ledger(pk, kind)
    # A base of a few hundred ordinary buckets: the lease churn is a
    # small delta, not a compaction.
    for i in range(400):
        await store.acquire(f"pad:{i}", 1, 50.0, 0.0)
    await led.lease(_lease_req("r0", "C1"))
    await led.renew(_renew_req("r0", "C1", 12.0))
    chain = pk.cp.SnapshotChain(path)
    chain.save(store)
    await led.renew(_renew_req("r0", "C1", 30.0))
    delta_path = chain.save(store)
    store2 = pk.store(kind)
    mono2 = Mono(1000.0)
    led2 = store2.federation_ledger(clock=mono2, default_ttl_s=TTL)
    applied = pk.cp.load_snapshot_chain(store2, path)
    lease = led2._pools[TENANT].leases["r0"]
    out = [delta_path.endswith(".delta.1"), applied, led2.restores,
           led2.outstanding_leases(), lease.lease_id, lease.reported_total,
           lease.expires_mono - mono2(), _balance(store2),
           _jax_view(led2.export_state())]
    out.append(await led2.lease(_lease_req("r0", "C1")))
    mono2.advance(TTL + 0.1)
    out.append(led2.expire())
    await store.aclose()
    await store2.aclose()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_lease_state_rides_checkpoint_chain(kind, tmp_path):
    (is_delta, applied, restores, outstanding, lease_id, reported, ttl_left,
     balance, _state, dup, expired) = _both(_chain, kind, tmp_path)
    assert is_delta and applied == 1 and restores == 1
    assert outstanding == 1 and lease_id == "C1" and reported == 30.0
    assert 0.0 < ttl_left <= TTL             # never extended by a restart
    assert balance == G_CAP - 30.0
    assert dup["duplicate"]                  # the grant records rode along
    assert expired == 1


def test_store_without_an_active_ledger_keeps_its_snapshot_bytes(tmp_path):
    """A store whose ledger never saw traffic (or has none) writes the
    same checkpoint bytes as before the attachment lane."""
    import pickle

    for make_ledger in (False, True):
        store = InProcessBucketStore(clock=ManualClock())
        run(store.acquire("k", 3, 10.0, 0.0))
        if make_ledger:
            store.federation_ledger(clock=Mono())
        path = str(tmp_path / f"plain-{make_ledger}.ckpt")
        pcp.save_snapshot(store, path)
        with open(path, "rb") as f:
            payload = pickle.load(f)
        assert "federation" not in payload.get("snapshot", payload)
        assert pickle.dumps(pcp._snapshot_with_attachments(store)) == \
            pickle.dumps(store.snapshot())


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_chain_crosses_packages_with_equal_lease_state(writer, tmp_path):
    """A port home's chain (base and delta) loaded by JAX's
    ``load_snapshot_chain``, and a JAX home's by the port's: the restored
    ledgers export equal state and answer the same requests alike."""
    src, dst = (PORT, JAX) if writer == "port" else (JAX, PORT)
    path = str(tmp_path / "home.ckpt")

    async def write():
        store, led, mono = _ledger(src, "inprocess")
        for i in range(300):
            await store.acquire(f"pad:{i}", 1, 50.0, 0.0)
        for r in ("r0", "r1", "r2"):
            await led.lease(_lease_req(r, f"{r}:1", 2.0))
        mono.advance(1.0)
        await led.renew(_renew_req("r0", "r0:1", 17.0, 5.0))
        await led.reclaim(_renew_req("r1", "r1:1", 9.0))
        chain = src.cp.SnapshotChain(path)
        chain.save(store)
        mono.advance(TTL - 0.5)              # r2 expires, r0 renews
        await led.renew(_renew_req("r0", "r0:1", 31.0, 6.0))
        assert chain.save(store).endswith(".delta.1")
        return _jax_view(led.export_state())

    async def read(pk):
        store = pk.store("inprocess")
        led = store.federation_ledger(clock=Mono(TTL + 0.5),
                                      default_ttl_s=TTL)
        applied = pk.cp.load_snapshot_chain(store, path)
        state = _jax_view(led.export_state())
        replies = [await led.lease(_lease_req("r0", "r0:1", 6.0)),
                   await led.renew(_renew_req("r2", "r2:1", 4.0)),
                   await led.reclaim(_renew_req("r1", "r1:1", 9.0)),
                   await led.lease(_lease_req("r1", "r1:2", 1.0))]
        return [applied, state, replies, led.numeric_stats(),
                _balance(store)]

    written = run(write())
    mine, theirs = run(read(dst)), run(read(src))
    _same(mine, theirs)
    assert mine[0] == 1
    assert mine[1]["grants"] == written["grants"]
    assert mine[1]["region_totals"] == written["region_totals"]
    assert [r["lease_id"] for p in mine[1]["pools"].values()
            for r in p["leases"]] == ["r0:1"]
    assert mine[2][0]["duplicate"] and mine[2][1]["outcome"] == "expired"
    assert mine[2][2]["outcome"] == "duplicate"


@pytest.mark.parametrize("kind", KINDS)
def test_jax_ledger_state_restores_into_the_port(kind):
    """``export_state()`` of a JAX ledger mid-flight (leases, a resize, an
    expiry pending heal, a debt) restored into the port's ledger: the two
    answer the same requests with equal replies, counters and balances."""
    async def drive(led, mono, phase):
        out = []
        if phase == 0:
            for i, r in enumerate(("r0", "r1", "r2")):
                out.append(await led.lease(_lease_req(r, f"{r}:1", 1.0 + i)))
            mono.advance(2.0)
            out.append(await led.renew(_renew_req("r0", "r0:1", 250.0,
                                                  12.0)))
            out.append(await led.renew(_renew_req("r1", "r1:1", 40.0, 1.0)))
            mono.advance(TTL - 1.0)          # r2 expires unrenewed
            led.expire()
            return out
        out.append(await led.renew(_renew_req("r2", "r2:1", 300.0)))
        out.append(await led.lease(_lease_req("r2", "r2:2", 3.0)))
        out.append(await led.renew(_renew_req("r0", "r0:1", 260.0, 2.0)))
        mono.advance(TTL + 1.0)
        out.append(await led.renew(_renew_req("r1", "r1:1", 41.0)))
        out.append(await led.lease(_lease_req("r1", "r1:2", 1.0)))
        out.append(await led.reclaim(_renew_req("r0", "r0:1", 270.0)))
        return out

    async def scenario():
        jstore, jled, jmono = _ledger(JAX, "inprocess")
        await drive(jled, jmono, 0)
        state = jled.export_state()
        # The lease state crosses through export_state / restore_state
        # (the checkpoint's attachment lane); the home's global bucket
        # is brought to JAX's balance through the debit lane.
        pstore = _port_store(kind)
        pmono = Mono(jmono.t)
        pled = pstore.federation_ledger(clock=pmono, default_ttl_s=TTL)
        pcp._restore_with_attachments(
            pstore, dict(pstore.snapshot(), federation=state))
        await pstore.debit_many([TENANT], [G_CAP - _balance(jstore)],
                                G_CAP, G_RATE)
        _same(_jax_view(pled.export_state()), state)
        before = jled.numeric_stats()
        mine = await drive(pled, pmono, 1)
        theirs = await drive(jled, jmono, 1)
        # Counters are per process (a restore starts them at zero): the
        # port's equal JAX's growth over the same requests; the levels
        # (outstanding leases, debt) are equal outright.
        after = jled.numeric_stats()
        grown = {k: (v if k in ("outstanding_leases", "debt_tokens")
                     else v - before[k]) for k, v in after.items()}
        return (mine, pled.numeric_stats(), _balance(pstore),
                pled.debts()), (theirs, grown, _balance(jstore),
                                jled.debts())

    (mine, mstats, mbal, mdebts), (theirs, tstats, tbal, tdebts) = run(
        scenario())
    _same(mine, theirs)
    assert mstats["restores"] == 1 and tstats["restores"] == 0
    _same(dict(mstats, restores=0), tstats)
    _same(mbal, tbal)
    _same(mdebts, tdebts)
    assert mine[0]["outcome"] == "expired"


def test_conservation_survives_a_restart_between_charge_and_heal():
    """The port's one divergence from JAX's ledger: ``export_state``
    carries the cover identity's left side. A home restarted after a
    partition's conservative charge and before its heal keeps a
    non-negative residue on the port; JAX's, whose charge counters start
    at zero in the new process, reads the heal's refund against no charge
    (a negative residue: its auditor's federation breach)."""
    async def scenario(pk):
        store, led, mono = _ledger(pk, "inprocess", resize_threshold=1e9)
        await led.lease(_lease_req("r0", "A"))
        await led.lease(_lease_req("r2", "B"))
        await led.renew(_renew_req("r2", "B", 20.0))
        await led.renew(_renew_req("r0", "A", 15.0))
        mono.advance(TTL - 1.0)
        await led.renew(_renew_req("r0", "A", 25.0))
        mono.advance(2.0)                     # B expires, A holds
        await led.renew(_renew_req("r0", "A", 30.0))   # settles B's charge
        before = led.conservation()
        snap = pk.cp._snapshot_with_attachments(store)
        store2 = pk.store("inprocess")
        led2 = store2.federation_ledger(clock=mono, default_ttl_s=TTL)
        pk.cp._restore_with_attachments(store2, snap)
        healed = await led2.renew(_renew_req("r2", "B", 40.0))
        return before, led2.conservation(), healed, snap["federation"]

    mine = run(scenario(PORT))
    theirs = run(scenario(JAX))
    _same(mine[0], theirs[0])                 # equal before the restart
    _same(mine[2], theirs[2])                 # the heal answers alike
    assert mine[2]["outcome"] == "expired" and mine[2]["refunded"] > 0
    assert mine[0]["residue"] >= 0.0
    assert mine[1]["residue"] >= -1e-9        # the port: still covered
    assert theirs[1]["residue"] < 0.0         # JAX: a false breach
    assert _jax_view(mine[3]) == theirs[3]
    assert mine[3]["conservation"]["accounted"] == \
        mine[0]["accounted"] - mine[0]["pending_conservative"]


# -- the controller actuator (:542) --------------------------------------------

class _FakeCluster:
    """A fixed node-stats stream (the real scrape shape), no actuators."""

    def __init__(self, tenant_rate: float = 5.0) -> None:
        self.total = 0.0
        self.tenant_rate = tenant_rate
        self.degraded = 0.0

    async def stats(self) -> dict:
        self.total += self.tenant_rate
        return {"nodes": [{
            "requests_served": int(self.total),
            "token_velocity": {"admitted": {TENANT: self.total}},
            "federation_region": {"degraded_now": self.degraded},
        }], "resilience": {}, "placement": {}}


async def _controller(pk, kind):
    store, led, home_mono = _ledger(pk, kind)

    def make(dry_run: bool, prefix: str):
        mono = Mono()
        agent = pk.fed.RegionFederation(
            "r0", led, tenants={TENANT: (G_CAP, G_RATE)}, ttl_s=TTL,
            clock=mono,
            lease_id_factory=iter(f"{prefix}{i}" for i in range(100))
            .__next__)
        cfg = pk.ctl.ControllerConfig(federation_renew_ticks=3,
                                      cooldown_ticks=0, dry_run=dry_run)
        return agent, mono, pk.ctl.Controller(
            _FakeCluster(), config=cfg, federation=agent,
            flight_recorder=pk.Flight(64))

    live_agent, live_mono, live = make(False, "K")
    dry_agent, dry_mono, dry = make(True, "D")
    live_records, dry_records = [], []
    for _ in range(9):
        live_mono.advance(2.0)
        dry_mono.advance(2.0)
        live_records += await live.tick()
        dry_records += await dry.tick()

    def strip(records):
        return [{k: v for k, v in r.items() if k != "t"} for r in records]

    frames = live.flight_recorder.frames(kind="controller")
    return [strip(live_records), strip(dry_records),
            live_agent.leases_acquired, live_agent.renews,
            dry_agent.leases_acquired, dry_agent.renews,
            led._pools[TENANT].leases["r0"].demand,
            [f["action"] for f in frames], live.numeric_stats()]


@pytest.mark.parametrize("kind", KINDS)
def test_controller_federation_actuator_cadence_and_dry_run_parity(kind):
    (live_records, dry_records, live_leases, live_renews, dry_leases,
     dry_renews, demand, frame_actions, stats) = _both(_controller, kind)
    fed_live = [r for r in live_records if r["action"] == "federation"]
    fed_dry = [r for r in dry_records if r["action"] == "federation"]
    assert len(fed_live) == 3 and len(fed_dry) == 3   # ticks 3, 6, 9
    assert [(r["tick"], r["action"]) for r in fed_live] == \
        [(r["tick"], r["action"]) for r in fed_dry]
    assert all(r["outcome"] == "dry_run" for r in fed_dry)
    assert all(r["outcome"] == "executed" for r in fed_live)
    assert live_leases == 1 and live_renews >= 1
    assert dry_leases == 0 and dry_renews == 0
    assert demand > 0     # the controller's velocity-delta rate
    assert "federation" in frame_actions
    assert stats["fed_degraded"] == 0.0


# -- slice_applier over the live-config lane -----------------------------------

async def _applier(pk_name, target_kind):
    """Slice changes through ``slice_applier``: over a port
    ``ClusterBucketStore`` of two port servers (``mutate_config``) or over
    one port ``RemoteBucketStore`` (``config_announce``). A client that
    keeps sending the first slice's operands chases each change."""
    backings = [InProcessBucketStore(clock=ManualClock())
                for _ in range(2 if target_kind == "cluster" else 1)]
    servers = [pserver.BucketStoreServer(b) for b in backings]
    for s in servers:
        await s.start()
    addrs = [(s.host, s.port) for s in servers]
    if target_kind == "cluster":
        target = ClusterBucketStore(addresses=addrs, coalesce_requests=False,
                                    request_timeout_s=5.0)
        client = ClusterBucketStore(addresses=addrs, coalesce_requests=False,
                                    request_timeout_s=5.0)
    else:
        target = RemoteBucketStore(address=addrs[0], coalesce_requests=False)
        client = RemoteBucketStore(address=addrs[0], coalesce_requests=False)
    apply = pfed.slice_applier(target)
    out = []
    try:
        first = (300.0, 0.0)
        out.append([(await client.acquire(TENANT, 1, *first)).granted
                    for _ in range(5)])
        await apply(TENANT, None, first)          # first slice: no rule
        await apply(TENANT, first, first)         # unchanged: no rule
        out.append([s.liveconfig.version for s in servers])
        await apply(TENANT, first, (120.0, 0.0))
        out.append([s.liveconfig.version for s in servers])
        res = [await client.acquire(TENANT, 1, *first) for _ in range(3)]
        out.append([r.granted for r in res])
        await apply(TENANT, (120.0, 0.0), (8.0, 0.0))
        res = [await client.acquire(TENANT, 1, *first) for _ in range(6)]
        out.append([r.granted for r in res])
        out.append([s.liveconfig.version for s in servers])
        out.append(sorted(float(b.peek_blocking(TENANT, 8.0, 0.0))
                          for b in backings))
        with pytest.raises(TypeError):
            await pfed.slice_applier(object())(TENANT, first, (1.0, 0.0))
        return out
    finally:
        await client.aclose()
        await target.aclose()
        for s in servers:
            await s.aclose()


@pytest.mark.parametrize("target_kind", ["cluster", "remote"])
def test_slice_applier_applies_through_live_config(target_kind):
    out = run(_applier("port", target_kind))
    n = 2 if target_kind == "cluster" else 1
    assert out[0] == [True] * 5
    assert out[1] == [0] * n and out[2] == [1] * n
    assert out[3] == [True] * 3
    assert out[5] == [2] * n
    # The 8-token slice: 120 spent down to 112 by 5 + 3 asks on one node,
    # rebased to 8 - 8 = 0 there; the fresh asks are denied.
    assert out[4] == [False] * 6
    assert out[6][0] == 0.0


# ===========================================================================
# The seeded 3-region soak (tests/test_federation.py:596-935)
# ===========================================================================

N_ROUNDS = 26
PARTITION_AT, RESTART_AT, HEAL_AT = 8, 14, 20
REGIONS = ("r0", "r1", "r2")


def _chaos_rules(pk):
    F = pk.faults
    return {
        "federation.renew": (
            F.FaultRule(kind=F.DELAY, probability=0.2, delay_s=0.001),
            F.FaultRule(kind=F.ERROR, probability=0.08),
            F.FaultRule(kind=F.RESET, probability=0.05),
        ),
        "federation.lease": (
            F.FaultRule(kind=F.DELAY, probability=0.2, delay_s=0.001),
            F.FaultRule(kind=F.ERROR, probability=0.1),
        ),
        "server.federation": (
            F.FaultRule(kind=F.DELAY, probability=0.1, delay_s=0.001),
        ),
    }


def _soak_schedule(seed: int):
    """Per-round, per-region request counts and the demand schedule (r0
    heats up at round 4 — the lend/borrow arm). JAX's, draw for draw."""
    rng = np.random.default_rng(seed)
    rounds = []
    for i in range(N_ROUNDS):
        counts = {r: int(rng.integers(0, 5)) for r in REGIONS}
        if i >= HEAL_AT:
            counts["r2"] = int(rng.integers(0, 3))
        demands = {"r0": 8.0 if i >= 4 else 4.0,
                   "r1": 2.0 if i >= 4 else 4.0, "r2": 4.0}
        rounds.append((counts, demands))
    return rounds


class _Region:
    """One region: a wire server, a traffic client that learns slice
    changes through the OP_CONFIG chase, and the federation agent."""

    def __init__(self, pk, name: str, seed: int) -> None:
        self.pk = pk
        self.name = name
        self.mono = Mono()
        self.backing = pk.store("inprocess")
        self.server = pk.Server(self.backing)
        self.admitted = 0
        self.denied = 0
        self.grants: list[int] = []
        self.client = None
        self.config_client = None
        self.agent = None
        self.first_cfg = None
        self.partition_admits = 0
        self.seed = seed

    async def start(self, home_client) -> None:
        pk = self.pk
        await self.server.start()
        addr = (self.server.host, self.server.port)
        self.client = pk.Remote(address=addr, coalesce_requests=False,
                                resilience_seed=self.seed)
        self.config_client = pk.Remote(address=addr,
                                       coalesce_requests=False,
                                       resilience_seed=self.seed + 7)
        inner = pk.fed.slice_applier(self.config_client)
        self.cfg_history: list[tuple] = []

        async def apply(tenant, old, new):
            self.cfg_history.append(tuple(new))
            await inner(tenant, old, new)

        seq = [0]

        def ids() -> str:
            seq[0] += 1
            return f"{self.name}:L{seq[0]}"

        self.agent = pk.fed.RegionFederation(
            self.name, home_client, tenants={TENANT: (G_CAP, G_RATE)},
            apply_slice=apply, admitted_total=lambda _t: float(self.admitted),
            ttl_s=TTL, clock=self.mono, lease_id_factory=ids)

    async def drive(self, n: int, partitioned: bool) -> None:
        cfg = self.agent.slice(TENANT)
        if cfg is None:
            return
        if self.first_cfg is None:
            self.first_cfg = cfg
        for _ in range(n):
            res = await self.client.acquire(TENANT, 1, self.first_cfg[0],
                                            self.first_cfg[1])
            if res.granted:
                self.admitted += 1
                if partitioned:
                    self.partition_admits += 1
            else:
                self.denied += 1
            self.grants.append(int(res.granted))

    async def aclose(self) -> None:
        for c in (self.client, self.config_client):
            if c is not None:
                await c.aclose()
        await self.server.aclose()
        await self.backing.aclose()


class _DownHome:
    """The full partition: every WAN call from the region dies."""

    async def fed_lease(self, _p, **_kw):
        raise ConnectionResetError("partitioned")

    fed_renew = fed_lease
    fed_reclaim = fed_lease


async def _soak_once(pk, home_kind: str, seed: int, tmp_path) -> dict:
    rounds = _soak_schedule(seed)
    pk.faults.install(pk.faults.FaultInjector(seed, _chaos_rules(pk)))
    tmp_path.mkdir(parents=True, exist_ok=True)
    ckpt_path = str(tmp_path / f"home-{seed}.ckpt")
    chain = pk.cp.SnapshotChain(ckpt_path)
    home_mono = Mono()
    home_backing = pk.store(home_kind)
    home_backing.federation_ledger(clock=home_mono, default_ttl_s=TTL)
    home_srv = pk.Server(home_backing)
    await home_srv.start()

    def home_client(s):
        return pk.Remote(address=(home_srv.host, home_srv.port),
                         coalesce_requests=False, resilience_seed=s)

    regions = {n: _Region(pk, n, seed + i * 13)
               for i, n in enumerate(REGIONS)}
    home_clients = {}
    for i, (n, reg) in enumerate(regions.items()):
        home_clients[n] = home_client(seed + 100 + i)
        await reg.start(home_clients[n])
    events: list[str] = []
    epsilon_budget = 0.0
    counter_base: dict[str, float] = {}
    try:
        for rnd, (counts, demands) in enumerate(rounds):
            home_mono.advance(1.0)
            for reg in regions.values():
                reg.mono.advance(1.0)
            if rnd == PARTITION_AT:
                r2 = regions["r2"]
                r2.agent.home = _DownHome()
                epsilon_budget += 2 * pk.fed.degraded_config(
                    *r2.agent.slice(TENANT))[0]
                events.append("partition:r2")
            if rnd == RESTART_AT:
                for k, v in home_backing._federation.numeric_stats() \
                        .items():
                    counter_base[k] = counter_base.get(k, 0.0) + v
                chain.save(home_backing)
                await home_srv.aclose()
                for c in home_clients.values():
                    await c.aclose()
                await home_backing.aclose()
                new_backing = pk.store(home_kind)
                new_backing.federation_ledger(clock=home_mono,
                                              default_ttl_s=TTL)
                applied = pk.cp.load_snapshot_chain(new_backing, ckpt_path)
                new_srv = pk.Server(new_backing)
                await new_srv.start()
                home_backing, home_srv = new_backing, new_srv
                for i, (n, reg) in enumerate(regions.items()):
                    home_clients[n] = pk.Remote(
                        address=(home_srv.host, home_srv.port),
                        coalesce_requests=False,
                        resilience_seed=seed + 200 + i)
                    if n != "r2":
                        reg.agent.home = home_clients[n]
                led = home_backing._federation
                events.append(f"restart:leases={led.outstanding_leases()}"
                              f",deltas={applied}")
                held = regions["r0"].agent._leases[TENANT].lease_id
                if held is not None:
                    r = await home_clients["r0"].fed_lease({
                        "region": "r0", "lease_id": held, "tenant": TENANT,
                        "demand": demands["r0"], "global_cap": G_CAP,
                        "global_rate": G_RATE})
                    assert r.get("duplicate"), r
            if rnd == HEAL_AT:
                regions["r2"].agent.home = home_clients["r2"]
                events.append("heal:r2")
            for n, reg in regions.items():
                summary = await reg.agent.tick(demands={TENANT: demands[n]})
                if summary["degraded"]:
                    events.append(f"degraded:{n}@{rnd}")
                if summary["healed"] or (n == "r2" and summary["leased"]
                                         and rnd >= HEAL_AT):
                    events.append(f"healed:{n}@{rnd}")
                partitioned = n == "r2" and PARTITION_AT <= rnd < HEAL_AT
                await reg.drive(counts[n], partitioned)
            if rnd % 4 == 1:
                chain.save(home_backing)
        for reg in regions.values():
            await reg.agent.reclaim_all()

        led = home_backing._federation
        r2 = regions["r2"]
        # The differential audit, from the stores' own records (JAX's).
        assert r2.partition_admits <= r2.first_cfg[0] + epsilon_budget
        assert r2.agent.degraded_entries >= 1
        total_admitted = sum(r.admitted for r in regions.values())
        home_spent = G_CAP - _balance(home_backing)
        home_debt = sum(led.debts().values())
        assert math.isclose(home_spent + home_debt, total_admitted,
                            abs_tol=1e-6)
        assert total_admitted <= G_CAP + epsilon_budget
        for n in ("r0", "r1"):
            reg = regions[n]
            cfg = reg.agent.slice(TENANT) or reg.first_cfg
            if cfg is None or reg.agent.degraded_entries > 0:
                continue
            spent = cfg[0] - _balance(reg.backing, TENANT, cfg[0], cfg[1])
            assert spent >= min(reg.admitted, cfg[0]) - 1e-6, n
            if len(set(reg.cfg_history)) == len(reg.cfg_history):
                assert math.isclose(spent, reg.admitted, abs_tol=1e-6), n
        shares = {r: s for t, r, s in led.shares() if t == TENANT}
        return {
            "grants": {n: regions[n].grants for n in REGIONS},
            "admitted": {n: regions[n].admitted for n in REGIONS},
            "denied": {n: regions[n].denied for n in REGIONS},
            "events": events,
            "ledger": {k: v + counter_base.get(k, 0.0)
                       for k, v in led.numeric_stats().items()
                       if k != "outstanding_leases"},
            "agents": {n: regions[n].agent.numeric_stats()
                       for n in REGIONS},
            "cfg_history": {n: regions[n].cfg_history for n in REGIONS},
            "fed_frames": [f["event"] for f in
                           (home_srv.flight_recorder.frames(
                               kind="federation") or [])],
            "shares": shares,
            "epsilon_budget": epsilon_budget,
            "home_balance": _balance(home_backing),
        }
    finally:
        pk.faults.uninstall()
        for reg in regions.values():
            await reg.aclose()
        for c in home_clients.values():
            await c.aclose()
        await home_srv.aclose()
        await home_backing.aclose()


@pytest.mark.parametrize("home_kind", KINDS)
def test_federation_soak_3region_equals_jax(home_kind, tmp_path):
    """THE acceptance soak, on the port with the home over ``home_kind``:
    its summary equals JAX's for the same seed, twice over (the same seed
    reproduces it bit for bit), and JAX's non-vacuity checks hold."""
    s1 = run(_soak_once(PORT, home_kind, SEED, tmp_path / "a"))
    s2 = run(_soak_once(PORT, home_kind, SEED, tmp_path / "b"))
    theirs = run(_soak_once(JAX, "inprocess", SEED, tmp_path / "j"))
    _same(s1, s2)
    if home_kind == "device":
        # The card store's snapshot is its slot tables, so its chain
        # holds more delta links before a compaction than the serial
        # store's: the restart event's link count is the store's, not the
        # federation's. Everything else must be equal.
        def links(s):
            return [e.split(",deltas=")[0] for e in s["events"]]
        assert any(",deltas=" in e for e in s1["events"])
        s1, theirs = dict(s1, events=links(s1)), dict(theirs,
                                                      events=links(theirs))
    _same(s1, theirs)
    assert all(s1["admitted"][n] > 0 for n in REGIONS)
    assert any(e.startswith("degraded:r2") for e in s1["events"])
    assert any(e.startswith("healed:r2") for e in s1["events"])
    assert any(e.startswith("restart:") for e in s1["events"])
    assert s1["ledger"]["leases_expired"] >= 1
    assert s1["ledger"]["heals"] >= 1
    assert s1["ledger"]["conservative_tokens"] > 0
    assert s1["ledger"]["resizes"] >= 1
    assert s1["agents"]["r2"]["partition_errors"] > 0
    assert (s1["agents"]["r0"]["partition_errors"]
            + s1["agents"]["r1"]["partition_errors"]) > 0
    # Lend/borrow: r0 (hot) ends with a larger share than r1.
    assert s1["shares"] == {} or \
        s1["shares"].get("r0", 1.0) >= s1["shares"].get("r1", 0.0)


def test_soak_seeds_differ_but_each_matches_jax(tmp_path):
    """A second seed: a different schedule, still equal to JAX's."""
    seed = SEED + 1
    mine = run(_soak_once(PORT, "inprocess", seed, tmp_path / "p"))
    theirs = run(_soak_once(JAX, "inprocess", seed, tmp_path / "j"))
    _same(mine, theirs)
    base = run(_soak_once(PORT, "inprocess", SEED, tmp_path / "b"))
    assert mine["grants"] != base["grants"] or \
        mine["events"] != base["events"]


def test_port_federation_imports_no_jax():
    import subprocess
    import sys

    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['distributedratelimiting.redis_tpu'] = None; "
            "import distributedratelimiting.redis_tpu_torch.runtime."
            "federation as f; print(len(f.__all__))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == str(len(jfed.__all__))
