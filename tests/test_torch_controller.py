"""The port's ``Controller`` against the JAX package's, on the CPU.

- **The unit surface, both packages.** Every scripted-feed scenario of
  JAX's ``tests/test_controller.py`` (hysteresis and cooldown edges, the
  budget, dry-run parity, partial scrapes, shed with no targets,
  breaker-driven drain and rejoin, split and rebalance decisions) and of
  ``tests/test_storm.py:187-238`` (the retry-storm rung arming and
  releasing both gates, its absolute-rate floor, its dry-run parity), run
  tick by tick through both packages' controllers over one inert fake
  cluster: after every tick the action records (their wall-clock ``t``
  aside), the streaks, cooldowns, budget, drain sets, shed level, storm
  posture, the numeric stats and every actuator call are equal.
- **The soak's sensor sequence.** The seeded diurnal plus flash-crowd
  schedule of ``tests/test_controller.py`` driven over a three-node port
  fleet (port cluster, servers, gateway) and over a JAX fleet: the
  scraped ``Sensors`` are equal tick by tick, as are the action schedule,
  the grants and the shed levels. The port fleet's ``Sensors`` sequence
  then goes to both packages' ``decide`` (and to a dry-run port twin):
  equal intents and equal state after each tick.
- ``ControllerConfig``'s validation, the server's ``controller`` families,
  OP_STATS section and the auditor's incident bundle (its
  ``controller_actions``), and the console's ``--controller`` flags parsed
  and armed. The federation actuator's cadence and dry-run parity are in
  ``tests/test_torch_federation.py``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import math
import os
import queue
import signal
import subprocess
import sys
import tempfile
import threading
import types

import numpy as np
import pytest

from distributedratelimiting.redis_tpu.runtime import admission as jadm
from distributedratelimiting.redis_tpu.runtime import controller as jctl
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.audit import (
    AuditConfig as JAuditConfig,
)
from distributedratelimiting.redis_tpu.runtime.cluster import (
    ClusterBucketStore as JCluster,
)
from distributedratelimiting.redis_tpu.runtime.remote import (
    RemoteBucketStore as JRemote,
)
from distributedratelimiting.redis_tpu.runtime.server import (
    BucketStoreServer as JServer,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    InProcessBucketStore as JSerial,
)
from distributedratelimiting.redis_tpu.utils import faults as jfaults
from distributedratelimiting.redis_tpu.utils import tracing as jtracing
from distributedratelimiting.redis_tpu.utils.flight_recorder import (
    FlightRecorder as JFlight,
)
from distributedratelimiting.redis_tpu.utils.slo import SLOConfig as JSLO
from distributedratelimiting.redis_tpu_torch import (
    BucketStoreServer,
    ClusterBucketStore,
    InProcessBucketStore,
    ManualClock,
    RemoteBucketStore,
)
from distributedratelimiting.redis_tpu_torch.runtime import admission as padm
from distributedratelimiting.redis_tpu_torch.runtime import controller as pctl
from distributedratelimiting.redis_tpu_torch.runtime import server as pserver
from distributedratelimiting.redis_tpu_torch.runtime.audit import AuditConfig
from distributedratelimiting.redis_tpu_torch.utils import faults as pfaults
from distributedratelimiting.redis_tpu_torch.utils import tracing as ptracing
from distributedratelimiting.redis_tpu_torch.utils.flight_recorder import (
    FlightRecorder,
)
from distributedratelimiting.redis_tpu_torch.utils.slo import SLOConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED = 20260804
LIMIT_S = 60.0

PORT = types.SimpleNamespace(
    name="port", ctl=pctl, adm=padm, faults=pfaults, tracing=ptracing,
    Cluster=ClusterBucketStore, Server=BucketStoreServer,
    Serial=InProcessBucketStore, Clock=ManualClock, Flight=FlightRecorder,
    Remote=RemoteBucketStore, Audit=AuditConfig, SLO=SLOConfig)
JAX = types.SimpleNamespace(
    name="jax", ctl=jctl, adm=jadm, faults=jfaults, tracing=jtracing,
    Cluster=JCluster, Server=JServer, Serial=JSerial, Clock=JClock,
    Flight=JFlight, Remote=JRemote, Audit=JAuditConfig, SLO=JSLO)

BATCH, SCAVENGER = padm.PRIORITY_BATCH, padm.PRIORITY_SCAVENGER
INTERACTIVE = padm.PRIORITY_INTERACTIVE
assert (BATCH, SCAVENGER, INTERACTIVE) == (
    jadm.PRIORITY_BATCH, jadm.PRIORITY_SCAVENGER, jadm.PRIORITY_INTERACTIVE)


def run(coro, limit_s: float = LIMIT_S):
    return asyncio.run(asyncio.wait_for(coro, limit_s))


# -- the inert fake cluster and scripted feeds (JAX's unit harness) ------------

class FakeCluster:
    """Inert actuator surface + scripted sensor feed. Actuators record but
    never mutate the feed, so one feed drives both packages alike."""

    def __init__(self, feed, overrides=None):
        self.feed = [dict(st) for st in feed]
        self.calls: list[tuple] = []
        self.placement = types.SimpleNamespace(overrides=dict(overrides or {}))
        self.flight_recorder = None

    async def stats(self):
        return (self.feed.pop(0) if self.feed
                else {"nodes": [], "resilience": {}, "placement": {}})

    async def split_hot_keys(self, top_n=1, min_count=0.0):
        self.calls.append(("split", top_n))
        return ["k/hot"]

    async def rebalance(self, reason=""):
        self.calls.append(("rebalance", reason))
        return 1

    async def drain_node(self, j):
        self.calls.append(("drain", j))
        return 1

    async def rejoin_node(self, j):
        self.calls.append(("rejoin", j))
        return 1


class Target:
    """A shed target exposing the shed level and both storm actuators."""

    def __init__(self, storm: bool = True):
        self.calls: list = []
        if storm:
            self.set_retry_shed = lambda on: self.calls.append(
                ("retry", bool(on)))
            self.set_doomed_gate = lambda on: self.calls.append(
                ("doomed", bool(on)))

    def set_shed_level(self, level):
        self.calls.append(("level", level))


def _tick_stats(*, reqs=(100, 100), admitted=None, hot=None,
                breakers=None, slot_counts=None, drained=()):
    nodes = []
    for j, r in enumerate(reqs):
        ns: dict = {"requests_served": r}
        if j == 0:
            if admitted is not None:
                ns["token_velocity"] = {"admitted": dict(admitted)}
            if hot is not None:
                ns["hot_keys"] = {"top": [
                    {"key": k, "count": c, "error": 0.0}
                    for k, c in hot.items()]}
        nodes.append(ns)
    out = {"nodes": nodes, "resilience": {}, "placement": {
        "slot_counts": list(slot_counts or [8] * len(reqs)),
        "drained": list(drained)}}
    if breakers is not None:
        out["resilience"]["breakers"] = [{"state": s} for s in breakers]
    return out


def _pressure_feed(n, tokens_per_tick, hot_per_tick=0.0):
    feed = []
    admitted = hot = 0.0
    for i in range(n + 1):
        feed.append(_tick_stats(
            reqs=(100 * (i + 1), 100 * (i + 1)),
            admitted={"acme": admitted},
            hot={"k/hot": hot, "k/cold": 10.0 * (i + 1)}))
        admitted += tokens_per_tick
        hot += hot_per_tick
    return feed


def _with_outstanding(feed, tokens):
    for st in feed:
        st["nodes"][0]["reservations"] = {"outstanding_tokens": tokens}
    return feed


def _middle_band():
    feed, admitted = [], 0.0
    for i in range(12):
        feed.append(_tick_stats(admitted={"acme": admitted}))
        admitted += 500.0 if i % 2 == 0 else 300.0
    return feed


def _partial_scrape():
    def both(a0, a1):
        return {"nodes": [
            {"requests_served": 100,
             "token_velocity": {"admitted": {"acme": a0}}},
            {"requests_served": 100,
             "token_velocity": {"admitted": {"acme": a1}}}],
            "resilience": {}, "placement": {"slot_counts": [8, 8],
                                            "drained": []}}
    base = 1_000_000.0
    return [both(base, base), both(base + 100, base + 100),
            {"nodes": [{}, {"requests_served": 100, "token_velocity": {
                "admitted": {"acme": base + 200}}}],
             "resilience": {}, "placement": {"slot_counts": [8, 8],
                                             "drained": []}},
            both(base + 300, base + 300), both(base + 400, base + 400)]


def _breakers():
    return ([_tick_stats(breakers=["closed", "open"]) for _ in range(5)]
            + [_tick_stats(breakers=["closed", "closed"]) for _ in range(6)])


def _storm_feed(storm_ticks, calm_ticks):
    feed, reqs, attempts = [], 100, 0.0
    for i in range(1 + storm_ticks + calm_ticks):
        feed.append({"nodes": [{"requests_served": reqs,
                                "retry": {"attempts_seen": attempts}},
                               {"requests_served": reqs}],
                     "resilience": {},
                     "placement": {"slot_counts": [8, 8], "drained": []}})
        reqs += 100
        if i < 1 + storm_ticks:
            attempts += 150.0
    return feed


def _rate_floor():
    feed, reqs, attempts = [], 1, 0.0
    for _ in range(7):
        feed.append({"nodes": [{"requests_served": reqs,
                                "retry": {"attempts_seen": attempts}}],
                     "resilience": {},
                     "placement": {"slot_counts": [8], "drained": []}})
        reqs += 1
        attempts += 0.5
    return feed


_UNIT = dict(tick_s=1.0, token_rate_capacity=400.0, shed_high=0.9,
             shed_low=0.6, shed_raise_ticks=2, shed_lower_ticks=2,
             split_share=0.3, split_min_tokens=50.0, split_streak_ticks=2,
             cooldown_ticks=2, budget_actions=8, budget_window_ticks=50)
_MEMBERSHIP = dict(_UNIT, token_rate_capacity=None,
                   drain_after_open_ticks=3, cooldown_ticks=0)
_STORM = dict(tick_s=1.0, cooldown_ticks=1)

#: name → (feed factory, config kwargs, ticks, shed target kind, overrides)
SCENARIOS = {
    "shed_hysteresis": (lambda: _pressure_feed(10, 500.0), _UNIT, 3, None,
                        None),
    "reservation_calm": (lambda: _pressure_feed(6, 200.0),
                         dict(_UNIT, reservation_horizon_s=10.0), 6, None,
                         None),
    "reservation_pressure": (
        lambda: _with_outstanding(_pressure_feed(6, 200.0), 2000.0),
        dict(_UNIT, reservation_horizon_s=10.0), 3, "shed", None),
    "reservation_dry": (
        lambda: _with_outstanding(_pressure_feed(6, 200.0), 2000.0),
        dict(_UNIT, reservation_horizon_s=10.0, dry_run=True), 3, "shed",
        None),
    "middle_band": (_middle_band, _UNIT, 12, None, None),
    "shed_ladder": (lambda: (_pressure_feed(14, 500.0)
                             + _pressure_feed(14, 100.0)[1:]),
                    _UNIT, 29, None, None),
    "cooldown": (lambda: _pressure_feed(20, 500.0),
                 dict(_UNIT, cooldown_ticks=3, shed_raise_ticks=1), 6, None,
                 None),
    "budget": (lambda: _pressure_feed(12, 500.0, hot_per_tick=400.0),
               dict(_UNIT, token_rate_capacity=None, cooldown_ticks=0,
                    split_streak_ticks=1, budget_actions=2,
                    budget_window_ticks=6), 12, None, None),
    "dry_run_live": (lambda: (_pressure_feed(10, 500.0, hot_per_tick=400.0)
                              + _pressure_feed(10, 100.0)[1:]),
                     _UNIT, 20, "shed", None),
    "dry_run": (lambda: (_pressure_feed(10, 500.0, hot_per_tick=400.0)
                         + _pressure_feed(10, 100.0)[1:]),
                dict(_UNIT, dry_run=True), 20, "shed", None),
    "partial_scrape": (_partial_scrape, dict(_UNIT, shed_raise_ticks=1), 5,
                       None, None),
    "shed_noop": (lambda: _pressure_feed(6, 500.0), _UNIT, 4, None, None),
    "breaker_drain_rejoin": (_breakers, _MEMBERSHIP, 11, None, None),
    "breaker_dry": (_breakers, dict(_MEMBERSHIP, dry_run=True), 11, None,
                    None),
    "split": (lambda: _pressure_feed(8, 500.0, hot_per_tick=400.0),
              dict(_UNIT, token_rate_capacity=None), 8, None, None),
    "split_override": (lambda: _pressure_feed(8, 500.0, hot_per_tick=400.0),
                       dict(_UNIT, token_rate_capacity=None), 8, None,
                       {"k/hot": 1}),
    "rebalance": (lambda: [_tick_stats(slot_counts=[14, 2])
                           for _ in range(6)],
                  dict(_UNIT, token_rate_capacity=None), 6, None, None),
    "storm_arm_release": (lambda: _storm_feed(4, 5), _STORM, 10, "storm",
                          None),
    "storm_rate_floor": (_rate_floor, dict(tick_s=1.0), 7, "storm", None),
    "storm_dry": (lambda: _storm_feed(4, 5), dict(_STORM, dry_run=True), 10,
                  "storm", None),
    "storm_gateway_only": (lambda: _storm_feed(4, 5), _STORM, 10, "shed",
                           None),
}


def _state(ctrl) -> dict:
    return {
        "streaks": dict(ctrl._streaks), "cooldowns": dict(ctrl._cooldowns),
        "budget": list(ctrl._budget_ticks),
        "open": dict(ctrl._open_streak), "closed": dict(ctrl._closed_streak),
        "auto_drained": sorted(ctrl.auto_drained),
        "shed_level": ctrl.shed_level, "retry_shed_on": ctrl.retry_shed_on,
        "numeric": ctrl.numeric_stats(), "series": ctrl.action_series(),
    }


def _records(records) -> list:
    return [{k: v for k, v in r.items() if k != "t"} for r in records]


async def _drive(pk, name: str) -> list:
    feed, cfg, ticks, target, overrides = SCENARIOS[name]
    fake = FakeCluster(feed(), overrides)
    tgt = (Target(storm=True) if target == "storm"
           else Target(storm=False) if target == "shed" else None)
    ctrl = pk.ctl.Controller(fake, config=pk.ctl.ControllerConfig(**cfg),
                             shed_targets=[tgt] if tgt else ())
    trace = []
    for _ in range(ticks):
        recs = await ctrl.tick()
        trace.append((_records(recs), _state(ctrl)))
    trace.append((fake.calls, tgt.calls if tgt else None,
                  _records(ctrl.actions), ctrl.stats()["actions_total"]))
    return trace


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_unit_scenarios_tick_for_tick_as_jax(name):
    mine = run(_drive(PORT, name))
    theirs = run(_drive(JAX, name))
    assert len(mine) == len(theirs)
    for i, (a, b) in enumerate(zip(mine, theirs)):
        assert a == b, (name, i)


def test_unit_scenarios_hold_jax_expectations():
    """The JAX unit tests' own assertions, on the port's traces."""
    def actions(name):
        return run(_drive(PORT, name))[-1]

    calls, _, acts, _ = actions("shed_hysteresis")
    assert [a["action"] for a in acts] == ["shed_raise"]
    _, levels, acts, _ = actions("reservation_dry")
    assert levels == [] and acts[0]["outcome"] == "dry_run"
    _, _, acts, _ = actions("middle_band")
    assert acts == []
    _, _, acts, _ = actions("shed_ladder")
    assert [(a["action"], a["target"]) for a in acts] == [
        ("shed_raise", SCAVENGER), ("shed_raise", BATCH),
        ("shed_lower", SCAVENGER), ("shed_lower", None)]
    _, _, acts, _ = actions("cooldown")
    assert [a["tick"] for a in acts] == [2, 6]
    calls, _, acts, _ = actions("budget")
    assert len([c for c in calls if c[0] == "split"]) > 2
    assert any(a["outcome"] == "budget_exhausted" for a in acts)
    calls, _, acts, _ = actions("breaker_drain_rejoin")
    assert calls == [("drain", 1), ("rejoin", 1)]
    calls, _, acts, _ = actions("breaker_dry")
    assert calls == [] and [a["action"] for a in acts] == ["drain", "rejoin"]
    calls, _, acts, _ = actions("split_override")
    assert calls == []
    _, tcalls, acts, _ = actions("storm_arm_release")
    assert [c for c in tcalls if c[0] != "level"] == [
        ("retry", True), ("doomed", True), ("retry", False),
        ("doomed", False)]
    _, tcalls, acts, _ = actions("storm_rate_floor")
    assert acts == [] and tcalls == []
    _, tcalls, acts, _ = actions("storm_dry")
    assert tcalls == [] and [a["action"] for a in acts] == [
        "retry_shed_on", "retry_shed_off"]
    # A bare gateway target has no storm gates: the rung decides, "noop".
    _, tcalls, acts, _ = actions("storm_gateway_only")
    assert tcalls == [] and {a["outcome"] for a in acts} == {"noop"}


# -- config validation, the surfaces ------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(shed_high=0.5, shed_low=0.5), dict(tick_s=0.0),
    dict(shed_floor=INTERACTIVE), dict(budget_actions=0),
    dict(token_rate_capacity=-1.0), dict(retry_storm_low=0.6,
                                         retry_storm_high=0.5),
    dict(cooldown_ticks=-1), dict(reservation_horizon_s=0.0),
    dict(federation_renew_ticks=0), dict(retry_storm_lower_ticks=0),
])
def test_config_validation_as_jax(kw):
    with pytest.raises(ValueError) as mine:
        pctl.ControllerConfig(**kw)
    with pytest.raises(ValueError) as theirs:
        jctl.ControllerConfig(**kw)
    assert str(mine.value) == str(theirs.value)


def test_config_defaults_and_sensor_series_as_jax():
    assert dataclasses.asdict(pctl.ControllerConfig()) == \
        dataclasses.asdict(jctl.ControllerConfig())
    assert pctl.SENSOR_SERIES == jctl.SENSOR_SERIES
    assert pctl.__all__ == jctl.__all__
    assert [f.name for f in dataclasses.fields(pctl.Sensors)] == \
        [f.name for f in dataclasses.fields(jctl.Sensors)]


def test_tick_seam_fault_fails_the_tick_as_jax():
    async def once(pk):
        fr = pk.Flight(16)
        ctrl = pk.ctl.Controller(FakeCluster(_pressure_feed(4, 500.0)),
                                 config=pk.ctl.ControllerConfig(**_UNIT),
                                 flight_recorder=fr)
        pk.faults.install(pk.faults.FaultInjector(1, {
            "controller.tick": (pk.faults.FaultRule(
                "error", probability=1.0, max_faults=2),)}))
        try:
            out = [await ctrl.tick() for _ in range(3)]
        finally:
            pk.faults.uninstall()
        return (out[:2], ctrl.tick_failures, ctrl.ticks,
                [f["outcome"] for f in fr.frames(kind="controller")])

    mine, theirs = run(once(PORT)), run(once(JAX))
    assert mine == theirs and mine[1:3] == (2, 1)


async def _served(pk) -> dict:
    """A server hosting a controller over a fake feed: its OP_STATS
    section, its controller families, and an incident bundle (an injected
    leak, as the audit tests inject it) carrying the controller's recent
    actions."""
    pk.tracing.configure(enabled=True, sample_rate=1.0, keep_rate=1.0,
                         latency_threshold_s=10.0)
    pk.tracing.get_tracer().reset()
    cfg = pk.Audit(slo=pk.SLO(fast_ticks=2, slow_ticks=6, trip_streak=1,
                              clear_streak=2))
    srv = pk.Server(pk.Serial(clock=pk.Clock(1000)), audit=cfg)
    await srv.start()
    if srv._audit_task is not None:
        srv._audit_task.cancel()
        await asyncio.gather(srv._audit_task, return_exceptions=True)
    ctrl = pk.ctl.Controller(
        FakeCluster(_pressure_feed(6, 500.0, hot_per_tick=400.0)),
        config=pk.ctl.ControllerConfig(**_UNIT),
        flight_recorder=srv.flight_recorder)
    srv.controller = ctrl
    cli = pk.Remote(address=(srv.host, srv.port), coalesce_requests=False)
    try:
        for _ in range(6):
            await ctrl.tick()
        st = await cli.stats()
        text = await cli.metrics()
        for i in range(10):
            await cli.acquire(f"warm{i % 3}", 1, 1e6, 1e6)
        for _ in range(3):
            srv.auditor.tick()
        pk.faults.install(pk.faults.FaultInjector(SEED, {"audit.leak": (
            pk.faults.FaultRule(kind="error", probability=1.0),)}))
        try:
            for _ in range(10):
                await cli.acquire("hot", 50, 100.0, 0.0)
        finally:
            pk.faults.uninstall()
        for _ in range(7):
            srv.auditor.tick()
        bundle = srv.auditor.bundles[0] if srv.auditor.bundles else {}
    finally:
        await cli.aclose()
        await srv.aclose()
        pk.tracing.configure(enabled=False)
        pk.tracing.get_tracer().reset()
    section = dict(st["controller"])
    section["actions"] = _records(section["actions"])
    return {
        "section": section,
        "families": "\n".join(ln for ln in text.splitlines()
                              if "drl_controller" in ln),
        "bundle_actions": _records(bundle.get("controller_actions", [])),
        "own": _records(ctrl.actions),
    }


def test_server_hosts_the_controller_as_jax():
    mine, theirs = run(_served(PORT)), run(_served(JAX))
    assert mine == theirs
    assert mine["section"]["ticks"] == 6 and mine["own"]
    assert "drl_controller_ticks_total 6" in mine["families"]
    assert 'drl_controller_actions_total{action="split",' in \
        mine["families"]
    # The incident bundle carries the controller's recent actions.
    assert mine["bundle_actions"] == mine["own"]


# -- the soak's sensor sequence ------------------------------------------------

_TENANTS = {"tenant:a": 50_000.0, "tenant:b": 30_000.0,
            "tenant:noisy": 60_000.0}
_FILL = 1e-9
_CHILD_CAP, _CHILD_RATE = 100_000.0, 1e-9
_FLAT_CAP, _FLAT_RATE = 20_000.0, 1e-9
_FLAT_KEY = "flash/hot"
_N_TICKS = 36
_FLASH = range(12, 24)
_SOAK_CFG = dict(tick_s=1.0, token_rate_capacity=800.0, shed_high=0.9,
                 shed_low=0.6, shed_raise_ticks=2, shed_lower_ticks=2,
                 split_share=0.2, split_min_tokens=100.0,
                 split_streak_ticks=2, cooldown_ticks=2, budget_actions=12,
                 budget_window_ticks=100)


def _soak_schedule(seed: int):
    """JAX ``tests/test_controller.py``'s schedule, row for row."""
    rng = np.random.default_rng(seed)
    ticks = []
    for t in range(_N_TICKS):
        rows = []
        n_a = 3 + int(round(2 * math.sin(2 * math.pi * t / _N_TICKS)))
        for _ in range(max(1, n_a)):
            cost = int(min(max(rng.lognormal(3.0, 0.8), 1.0), 200.0))
            prio = INTERACTIVE if rng.random() < 0.7 else BATCH
            rows.append(("hier", "tenant:a",
                         f"tenant:a/u{rng.integers(20)}", cost, prio))
        for _ in range(2):
            cost = int(min(max(rng.lognormal(3.0, 0.8), 1.0), 200.0))
            prio = BATCH if rng.random() < 0.6 else INTERACTIVE
            rows.append(("hier", "tenant:b",
                         f"tenant:b/u{rng.integers(10)}", cost, prio))
        if t in _FLASH:
            for i in range(6):
                rows.append(("hier", "tenant:noisy", f"tenant:noisy/h{i % 3}",
                             int(100 + rng.integers(50)), INTERACTIVE))
            for _ in range(4):
                rows.append(("hier", "tenant:noisy",
                             f"tenant:noisy/s{rng.integers(4)}",
                             int(60 + rng.integers(40)), SCAVENGER))
            for _ in range(8):
                rows.append(("flat", None, _FLAT_KEY, 60, INTERACTIVE))
        else:
            rows.append(("hier", "tenant:noisy",
                         f"tenant:noisy/u{rng.integers(6)}",
                         int(20 + rng.integers(20)), INTERACTIVE))
        ticks.append(rows)
    return ticks


async def _soak(pk, seed: int) -> dict:
    schedule = _soak_schedule(seed)
    backings = [pk.Serial(clock=pk.Clock()) for _ in range(3)]
    servers = [pk.Server(b) for b in backings]
    for s in servers:
        await s.start()
    fr = pk.Flight(512)
    cluster = pk.Cluster(addresses=[(s.host, s.port) for s in servers],
                         coalesce_requests=False, flight_recorder=fr)
    policy = pk.adm.AdmissionPolicy(cluster,
                                    key_config=(_CHILD_CAP, _CHILD_RATE))
    for tenant, cap in _TENANTS.items():
        policy.set_tenant(pk.adm.TenantBudget(tenant, cap, _FILL))
    ctrl = pk.ctl.Controller(cluster,
                             config=pk.ctl.ControllerConfig(**_SOAK_CFG),
                             shed_targets=[policy], flight_recorder=fr)
    sensors = []
    scrape = ctrl.scrape

    async def recorded():
        s = await scrape()
        sensors.append(s)
        return s

    ctrl.scrape = recorded
    outcomes, shed_at = [], []
    try:
        for t, rows in enumerate(schedule):
            shed_at.append(ctrl.shed_level)
            for lane, tenant, key, cost, prio in rows:
                if lane == "hier":
                    r = await policy.acquire(tenant, key, cost,
                                             priority=prio)
                else:
                    r = await cluster.acquire(key, cost, _FLAT_CAP,
                                              _FLAT_RATE)
                outcomes.append((t, lane, prio, cost, bool(r.granted)))
            for b in backings:
                b.clock.advance_seconds(1.0)
            await ctrl.tick()
    finally:
        await cluster.aclose()
        for s, b in zip(servers, backings):
            await s.aclose()
            await b.aclose()
    return {"sensors": sensors, "outcomes": outcomes, "shed_at": shed_at,
            "actions": _records(ctrl.actions),
            "overrides": dict(cluster.placement.overrides),
            "log": [(e["type"], e["reason"]) for e in cluster.migration_log]}


def _sensor_dict(s) -> dict:
    d = dataclasses.asdict(s)
    d["override_keys"] = sorted(d["override_keys"])
    return d


@pytest.fixture(scope="module")
def soaks():
    return {pk.name: run(_soak(pk, SEED), 120.0) for pk in (PORT, JAX)}


def test_soak_sensors_and_schedule_equal_jax(soaks):
    mine, theirs = soaks["port"], soaks["jax"]
    assert len(mine["sensors"]) == len(theirs["sensors"]) == _N_TICKS
    for i, (a, b) in enumerate(zip(mine["sensors"], theirs["sensors"])):
        assert _sensor_dict(a) == _sensor_dict(b), i
    for k in ("outcomes", "shed_at", "actions", "overrides", "log"):
        assert mine[k] == theirs[k], k
    # Non-vacuous: the controller alone split the flat key and walked the
    # shed ladder up and back.
    assert _FLAT_KEY in mine["overrides"]
    kinds = [a["action"] for a in mine["actions"]]
    assert "split" in kinds and "shed_raise" in kinds
    assert "shed_lower" in kinds


def _decide_trace(pk, sensors, dry_run: bool = False) -> list:
    ctrl = pk.ctl.Controller(FakeCluster([]), config=pk.ctl.ControllerConfig(
        **dict(_SOAK_CFG, dry_run=dry_run)))
    out = []
    for s in sensors:
        ctrl._tick = s.tick
        sen = pk.ctl.Sensors(**{f.name: getattr(s, f.name)
                                for f in dataclasses.fields(s)})
        intents = ctrl.decide(sen)
        out.append((intents, _state(ctrl)))
    return out


def test_decide_on_the_soak_sensors_equals_jax_and_dry_run(soaks):
    sensors = soaks["port"]["sensors"]
    mine = _decide_trace(PORT, sensors)
    theirs = _decide_trace(JAX, sensors)
    dry = _decide_trace(PORT, sensors, dry_run=True)
    assert mine == theirs
    for (a, sa), (b, sb) in zip(mine, dry):
        assert a == b
        sa, sb = dict(sa), dict(sb)
        assert sa.pop("numeric")["dry_run"] == 0
        assert sb.pop("numeric")["dry_run"] == 1
        assert sa == sb
    assert sum(len(i) for i, _ in mine) >= 4


# -- the console's --controller flags -------------------------------------------

@pytest.mark.parametrize("argv,message", [
    (["--controller-dry-run"], "require --controller"),
    (["--controller-token-rate", "5"], "require --controller"),
    (["--controller", "h:1", "--controller-token-rate", "-1"],
     "must be positive"),
])
def test_console_refuses_bad_controller_flags(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        pserver.main(["--device", "cpu", "--port", "0", *argv])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def test_console_arms_the_controller():
    """``--controller`` over a one-node port fleet: the console prints its
    reconciling line, its OP_STATS carries the controller section (dry
    run, ticking, the fleet scraped), its /metrics the controller
    families; SIGTERM stops the loop and exits 0."""
    async def fleet_up():
        srv = BucketStoreServer(InProcessBucketStore())
        await srv.start()
        return srv

    loop = asyncio.new_event_loop()
    node = loop.run_until_complete(fleet_up())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    env = dict(os.environ, PYTHONPATH=ROOT)
    err = tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen(
        [sys.executable, "-m",
         "distributedratelimiting.redis_tpu_torch.runtime.server",
         "--backend", "inprocess", "--port", "0", "--metrics-port", "0",
         "--controller", f"{node.host}:{node.port}",
         "--controller-tick-ms", "50", "--controller-dry-run",
         "--controller-token-rate", "1000"],
        stdout=subprocess.PIPE, stderr=err, text=True, env=env, cwd=ROOT)
    lines: "queue.Queue[str | None]" = queue.Queue()

    def pump():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=pump, daemon=True).start()

    def readline() -> str:
        line = lines.get(timeout=120.0)
        assert line is not None, err.seek(0) or err.read()
        return line

    try:
        listening = readline()
        assert listening.startswith("bucket-store server listening on ")
        host, port = listening.rsplit(" ", 1)[1].strip().rsplit(":", 1)
        assert readline().startswith("metrics exposition on ")
        assert readline().strip() == \
            "controller reconciling 1 node(s) every 50 ms [dry-run]"

        async def probe():
            cli = RemoteBucketStore(address=(host, int(port)))
            try:
                for _ in range(200):
                    st = await cli.stats()
                    if st.get("controller", {}).get("ticks", 0) >= 3:
                        break
                    await asyncio.sleep(0.05)
                return st, await cli.metrics()
            finally:
                await cli.aclose()

        st, text = asyncio.run(asyncio.wait_for(probe(), 60.0))
        ctl = st["controller"]
        assert ctl["ticks"] >= 3 and ctl["dry_run"] == 1
        assert ctl["tick_failures"] == 0
        assert "drl_controller_ticks_total" in text
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60.0) == 0, err.seek(0) or err.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30.0)
        err.close()
        asyncio.run_coroutine_threadsafe(node.aclose(), loop).result(30.0)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30.0)
