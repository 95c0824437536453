"""The port's conservation audit plane, held to the JAX package.

- ``utils/slo.py``: the burn-rate watchdog's alert log, counters and
  snapshot equal to JAX's on one seeded sample stream (tolerance 0: the
  stream is whole numbers and both packages do the same float arithmetic
  in the same order).
- ``runtime/audit.py`` on the port's server, over a CPU ``DeviceBucketStore``
  (the card store's code on its plain kernels): clean traffic with
  legitimate denies gives no breach and no alert; the seeded leak soak of
  ``tests/test_audit.py`` (an ``audit.leak`` fault flips denies into
  granted replies with no store debit) gives one incident bundle within
  three ticks, whose schedule — detection tick, alert log, bundle identity,
  residues and witness deltas — equals the JAX server's on the same seed;
  the same seed gives the same schedule twice; ``OP_AUDIT``, ``GET /audit``
  and the ``drl_audit_*`` families serve it.
"""

from __future__ import annotations

import asyncio
import json
import os

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.runtime.audit import (
    AuditConfig as JAuditConfig,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JInProcess,
)
from distributedratelimiting.redis_tpu.utils import faults as jfaults
from distributedratelimiting.redis_tpu.utils import tracing as jtracing
from distributedratelimiting.redis_tpu.utils.slo import (
    BurnRateWatchdog as JWatchdog,
)
from distributedratelimiting.redis_tpu.utils.slo import SLOConfig as JSLO
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    DeviceBucketStore,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime.audit import (
    EPSILON_SOURCES,
    AuditConfig,
)
from distributedratelimiting.redis_tpu_torch.utils import faults, tracing
from distributedratelimiting.redis_tpu_torch.utils.flight_recorder import (
    FlightRecorder,
)
from distributedratelimiting.redis_tpu_torch.utils.slo import (
    SLO_SERIES,
    BurnRateWatchdog,
    SLOConfig,
)

SEED = int(os.environ.get("DRL_AUDIT_SEED", "20260803"))
LIMIT_S = 30.0


def _wd_cfg(mod):
    """Small windows, every dimension armed (JAX's unit-test windows)."""
    return mod(overadmit_ratio=1e-3, latency_slo_s=0.25, shed_ratio=0.05,
               goodput_floor_rps=100.0, fast_ticks=2, slow_ticks=6,
               burn_fast=10.0, burn_slow=5.0, trip_streak=1,
               clear_streak=2, tick_s=1.0)


def _sample_stream(seed: int, n: int = 120) -> list[dict]:
    """Cumulative counter samples, seeded: steady traffic with bursts of
    over-admission, shedding, slow requests and a goodput collapse."""
    rng = np.random.default_rng(seed)
    cum = {"requests": 0.0, "shed": 0.0, "admitted_tokens": 0.0,
           "overadmitted_tokens": 0.0, "latency_total": 0.0,
           "latency_bad": 0.0}
    out = []
    for i in range(n):
        phase = (i // 15) % 4
        reqs = 0.0 if phase == 3 and i % 30 > 20 else float(
            rng.integers(150, 400))
        cum["requests"] += reqs
        cum["admitted_tokens"] += float(rng.integers(100, 1000))
        if phase == 1:
            cum["overadmitted_tokens"] += float(rng.integers(0, 40))
        if phase == 2:
            cum["shed"] += float(rng.integers(0, reqs // 4 + 1))
        cum["latency_total"] += reqs
        if phase == 3 and rng.random() < 0.5:
            cum["latency_bad"] += float(rng.integers(0, reqs // 5 + 1))
        out.append(dict(cum))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_watchdog_alert_log_matches_jax(seed):
    fr = FlightRecorder(capacity=256)
    mine = BurnRateWatchdog(_wd_cfg(SLOConfig), flight_recorder=fr)
    theirs = JWatchdog(_wd_cfg(JSLO))
    got_alerts, want_alerts = [], []
    for sample in _sample_stream(seed):
        got_alerts.append(mine.tick(sample))
        want_alerts.append(theirs.tick(sample))
    assert got_alerts == want_alerts
    assert list(mine.alert_log) == list(theirs.alert_log)
    assert mine.snapshot() == theirs.snapshot()
    assert mine.numeric_stats() == theirs.numeric_stats()
    assert mine.trips > 0 and mine.clears > 0  # the stream exercises both
    # Each alert is also an "slo" flight frame.
    assert len(fr.frames(kind="slo")) == mine.alerts
    assert "drl_audit_overadmitted_tokens" in SLO_SERIES


async def _drain_audit_task(srv) -> None:
    """Cancel the wall-clock pacer so the test owns every tick."""
    if srv._audit_task is not None:
        srv._audit_task.cancel()
        try:
            await srv._audit_task
        except asyncio.CancelledError:
            pass
        srv._audit_task = None


async def _http_get(host: str, port: int, path: str) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(f"GET {path} HTTP/1.1\r\nHost: t\r\n\r\n".encode())
    await writer.drain()
    data = await asyncio.wait_for(reader.read(), LIMIT_S)
    writer.close()
    head, _, body = data.partition(b"\r\n\r\n")
    return int(head.split()[1]), body


def test_clean_traffic_gives_no_breach():
    """Traffic with legitimate denies (a cap-5 key asked 32 times), a
    reservation flow and the background pacer at 0.05 s: no breach, no
    alert, over 20 and more ticks; the surfaces serve the clean state."""

    async def main():
        srv = BucketStoreServer(
            DeviceBucketStore(device="cpu", n_slots=1024), metrics_port=0,
            audit=AuditConfig(tick_s=0.05))
        await srv.start()
        st = RemoteBucketStore(address=(srv.host, srv.port),
                               coalesce_requests=False)
        try:
            res = await asyncio.wait_for(asyncio.gather(*(
                st.acquire("five", 1, 5.0, 1e-9) for _ in range(32))),
                LIMIT_S)
            assert sum(r.granted for r in res) == 5
            for i in range(40):
                await asyncio.wait_for(st.acquire(f"k{i % 7}", 1, 1e6, 1e6),
                                       LIMIT_S)
            await asyncio.wait_for(st.reserve(
                "r1", "t", "k", 10.0, 1e6, 0.0, 1e5, 0.0), LIMIT_S)
            await asyncio.wait_for(st.settle("r1", "t", 25.0), LIMIT_S)
            while srv.auditor.ticks < 20:
                await asyncio.sleep(0.05)
            stats = srv.auditor.numeric_stats()
            assert stats["breaches"] == 0 and stats["tick_failures"] == 0
            assert stats["bundles_assembled"] == 0
            assert srv.auditor.watchdog.alerts == 0
            assert srv.auditor.residues["reply_witness"] == 0.0
            for s in EPSILON_SOURCES:
                assert srv.auditor.epsilon_used[s] == 0.0
            snap = await asyncio.wait_for(st.audit(), LIMIT_S)
            assert snap["enabled"] and snap["bundle_ids"] == []
            assert snap["slo"]["tripped"] == []
            text = await asyncio.wait_for(st.metrics(), LIMIT_S)
            assert "drl_audit_breaches_total 0" in text
            assert "drl_slo_trips_total 0" in text
            assert 'drl_epsilon_budget_used_ratio{source="tier0"} 0' in text
            status, body = await _http_get(srv.host, srv.metrics_port,
                                           "/audit?bundles=2")
            assert status == 200 and json.loads(body)["bundles"] == []
            return srv.audit_replied_tokens, srv.audit_witnessed_tokens
        finally:
            await st.aclose()
            await srv.aclose()

    replied, witnessed = asyncio.run(main())
    assert replied == witnessed == 5.0 + 40.0


def test_audit_false_is_a_true_ablation():
    async def main():
        srv = BucketStoreServer(DeviceBucketStore(device="cpu", n_slots=256),
                                audit=False)
        await srv.start()
        st = RemoteBucketStore(address=(srv.host, srv.port),
                               coalesce_requests=False)
        try:
            assert srv.auditor is None and srv._audit_task is None
            assert await asyncio.wait_for(st.audit(), LIMIT_S) == {
                "enabled": False}
            assert "audit" not in await asyncio.wait_for(st.stats(),
                                                         LIMIT_S)
        finally:
            await st.aclose()
            await srv.aclose()

    asyncio.run(main())


def _soak_cfg(audit_cls, slo_cls):
    """Tight windows: "within three ticks" is a real detection bound."""
    return audit_cls(slo=slo_cls(fast_ticks=2, slow_ticks=6,
                                 trip_streak=1, clear_streak=2))


async def _leak_soak(seed: int, jax: bool) -> dict:
    """The JAX package's seeded leak episode (``tests/test_audit.py``), on
    either package's server. Returns the observable schedule."""
    if jax:
        trc, flt, Server, Remote = jtracing, jfaults, JServer, JRemote
        store = JInProcess()
        cfg = _soak_cfg(JAuditConfig, JSLO)
    else:
        trc, flt, Server, Remote = tracing, faults, BucketStoreServer, \
            RemoteBucketStore
        store = DeviceBucketStore(device="cpu", n_slots=1024)
        cfg = _soak_cfg(AuditConfig, SLOConfig)
    trc.configure(enabled=True, sample_rate=1.0, keep_rate=1.0,
                  latency_threshold_s=10.0)
    trc.get_tracer().reset()
    srv = Server(store, port=0, audit=cfg)
    await srv.start()
    await _drain_audit_task(srv)
    st = Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        for i in range(30):
            await asyncio.wait_for(st.acquire(f"warm{i % 5}", 1, 1e6, 1e6),
                                   LIMIT_S)
        for _ in range(3):
            out = srv.auditor.tick()
            assert out["breaches"] == [] and out["alerts"] == []
        inj = flt.FaultInjector(seed, {"audit.leak": (
            flt.FaultRule(kind="error", probability=1.0),)})
        flt.install(inj)
        try:
            for _ in range(30):
                await asyncio.wait_for(st.acquire("hot", 50, 100.0, 0.0),
                                       LIMIT_S)
        finally:
            flt.uninstall()
        assert inj.events, "the leak seam never fired"
        detect_tick = None
        for _ in range(3):
            out = srv.auditor.tick()
            if out["breaches"]:
                detect_tick = out["tick"]
                assert out["breaches"] == ["reply_witness"]
                assert out["residues"]["reply_witness"] > 0.0
                break
        assert detect_tick is not None, "leak not detected in 3 ticks"
        for _ in range(4):
            srv.auditor.tick()
        assert srv.auditor.bundles_assembled == 1
        (bundle,) = srv.auditor.bundles
        assert bundle["reasons"][0] == "conservation:reply_witness"
        w = bundle["witness_deltas"]
        assert w["replied_tokens_delta"] > w["witnessed_tokens_delta"]
        assert len(bundle["trace_ids"]) >= 1
        kept = {t.get("trace_id") for t in srv.tracer.traces()}
        assert set(bundle["trace_ids"]) & kept
        assert bundle["flight_frames"], "no correlated flight frames"
        snap = await asyncio.wait_for(st.audit(bundles=4), LIMIT_S)
        assert [b["id"] for b in snap["bundles"]] == [bundle["id"]]
        return {
            "detect_tick": detect_tick,
            "injected": len(inj.events),
            "alert_log": list(srv.auditor.watchdog.alert_log),
            "bundle": {"id": bundle["id"], "tick": bundle["tick"],
                       "reasons": bundle["reasons"],
                       "residues": bundle["residues"],
                       "witness_deltas": bundle["witness_deltas"]},
            "overadmitted_tokens": srv.auditor.overadmitted_tokens,
        }
    finally:
        await st.aclose()
        await srv.aclose()
        trc.configure(enabled=False)
        trc.get_tracer().reset()


def test_injected_leak_one_bundle_within_three_ticks_as_jax():
    mine = asyncio.run(_leak_soak(SEED, jax=False))
    theirs = asyncio.run(_leak_soak(SEED, jax=True))
    assert mine["detect_tick"] <= 3 + 3  # 3 warm-up ticks + 3 allowed
    assert mine["bundle"]["id"] == "bundle-0000"
    # The leak flips 28 denies (100 tokens, rate 0: 2 grants of 50).
    assert mine["injected"] == 28
    assert json.dumps(mine, sort_keys=True) == json.dumps(theirs,
                                                          sort_keys=True)


def test_same_seed_identical_alert_schedule():
    a = asyncio.run(_leak_soak(SEED, jax=False))
    b = asyncio.run(_leak_soak(SEED, jax=False))
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


class _FixedNative:
    """Stand-in counters for a server's native front-end: the C side's
    tier-0 and bulk gauges at fixed values, so the port's and the JAX
    package's auditors read the same inputs."""

    def __init__(self, grant, over, slices, permits, requests):
        self.grant, self.over = grant, over
        self.slices, self.permits, self.requests = slices, permits, requests

    def tier0_stats(self):
        return {"grant_tokens": self.grant, "overadmit_total": self.over}

    def bulk_stats(self):
        return {"permits_local": self.permits}

    def t0_eps_tokens(self):
        return list(self.slices)

    def counts(self):
        return (self.requests, 3, 7)

    def stage_histograms(self):
        return {}


@pytest.mark.parametrize("steps", [
    [(100.0, 2.0, (75.0, 25.0), 10.0, 40)],
    [(100.0, 0.0, (50.0, 50.0), 0.0, 10), (400.0, 30.0, (300.0, 100.0),
                                           64.0, 90)],
    [(0.0, 0.0, (0.0,), 0.0, 0), (1e4, 1.0, (1e4,), 5.0, 12)]])
def test_tier0_and_shard_epsilon_identity_as_jax(steps):
    """The auditor's tier-0 / per-shard ε (JAX ``audit.py:238-261``): the
    tier-0 share is overadmit_total over epsilon_fraction x the locally
    granted tokens, the shard share the hottest slice's part of them;
    realized over-admission is added by its delta. Fed the same native
    counters tick by tick, the port's auditor equals the JAX package's."""
    def ticks(server, native):
        out = []
        for grant, over, slices, permits, requests in steps:
            native.grant, native.over, native.slices = grant, over, slices
            native.permits, native.requests = permits, requests
            server.auditor.tick()
            a = server.auditor
            out.append((dict(a.epsilon_used), a.overadmitted_tokens,
                        a.numeric_stats()))
        return out

    port = BucketStoreServer(DeviceBucketStore(device="cpu", n_slots=256))
    port._native = _FixedNative(*steps[0])
    jax = JServer(JInProcess())
    jax._native = _FixedNative(*steps[0])
    got, want = ticks(port, port._native), ticks(jax, jax._native)
    assert got == want
    last = got[-1][0]
    grant, over, slices = steps[-1][:3]
    assert last["tier0"] == (min(1.0, over / (0.05 * grant)) if grant
                             else 0.0)
    if sum(slices):
        assert last["shard"] == max(slices) / sum(slices)
    port._native = jax._native = None
