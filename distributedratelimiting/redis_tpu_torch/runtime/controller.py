"""Autonomous control plane — the reconciliation loop over a cluster, on
the port.

The JAX package's ``runtime/controller.py`` with its names and
``__all__``. Every actuator is a method an operator could call by hand:
``add_node`` / ``drain_node`` / ``rejoin_node`` / ``rebalance`` /
``split_hot_keys`` on :class:`~.cluster.ClusterBucketStore`, the
``shed_level`` brownout knob on the admission gateway, and the retry-shed
and doomed-work gates on a server. Every sensor is a counter the servers
already publish: per-tenant token velocity and its monotonic ``admitted``
totals, the cost-weighted heavy-hitter sketch, breaker state, retry and
goodput counters. :class:`Controller` is the loop. On each tick it:

1. **Scrapes** the fleet's own observability plane —
   ``ClusterBucketStore.stats()``, the OP_STATS fan-out carrying the same
   counters the OpenMetrics families render (the series it subscribes to
   are :data:`SENSOR_SERIES`).
2. **Derives rates from monotonic counter deltas**
   (:class:`~..utils.metrics.CounterDeltas`) — never ``reset=True``, so
   the operator's measurement windows stay intact and the derived rates
   are a pure function of the traffic schedule.
3. **Decides** through per-actuator hysteresis (a threshold must hold for
   N consecutive ticks), per-actuator cooldowns and a global rolling
   actuation budget; a decision starved by the budget is logged (outcome
   ``budget_exhausted``), never silently dropped.
4. **Actuates** through the cluster's ``_membership_lock``-serialized
   paths: ``split_hot_keys`` for hot-cost keys, ``rebalance`` on slot
   imbalance, ``drain_node``/``rejoin_node`` on sustained breaker state,
   the retry-storm rung (``set_retry_shed`` + ``set_doomed_gate`` on its
   targets), and the shed ladder (``None → scavenger → batch``, never
   interactive).

Every decision lands as a flight-recorder frame (``kind="controller"``), a
bounded action-log entry (:attr:`Controller.actions`, newest 512), log
event 6 and the ``drl_controller_*`` families. ``dry_run=True`` decides
identically (streaks, cooldowns, budget and the decided shed level evolve
as live) but executes nothing.

**Determinism.** ``decide`` consumes only the sensor snapshot and the
controller's own state; ticks are counted, not clocked; there is no
randomness, so a seeded traffic schedule gives the same action schedule
bit for bit. The ``controller.tick`` fault seam fails a tick loudly.

With ``federation=`` a region's :class:`~.federation.RegionFederation`,
the ``federation`` actuator drives its WAN round on the
``federation_renew_ticks`` cadence (and off-cadence while a slice serves
its degraded envelope), as the JAX loop does.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable, Sequence

from distributedratelimiting.redis_tpu_torch.runtime.admission import (
    PRIORITY_BATCH,
    PRIORITY_SCAVENGER,
)
from distributedratelimiting.redis_tpu_torch.utils import faults, log
from distributedratelimiting.redis_tpu_torch.utils.metrics import CounterDeltas

__all__ = ["Controller", "ControllerConfig", "SENSOR_SERIES"]

#: The controller's sensor contract: every OpenMetrics series name the
#: reconciliation loop subscribes to (through the OP_STATS fan-out that
#: carries the same counters). drl-check's ``metric-name`` rule holds
#: each of these to a registration site in the registry that emits it —
#: a rename on the emitting side is a failed ``make check``, not a
#: silently blinded sensor.
SENSOR_SERIES = (
    "drl_requests_served",        # server.py — per-node load (rate via deltas)
    "drl_admitted_tokens",        # server.py — fleet token-pressure numerator
    "drl_token_velocity",         # server.py — per-tenant decayed tokens/sec
    "drl_hot_key_count",          # server.py — cost-weighted top-K sketch
    "drl_requests_shed",          # server.py — shed feedback
    "drl_reservations_outstanding",  # server.py — unsettled reserved tokens
    "drl_cluster_breaker_state",  # cluster.py — membership health
    "drl_cluster_node_errors",    # cluster.py — node failure counters
    "drl_federation_outstanding_leases",  # server.py — home lease count
    "drl_federation_region_degraded_now",  # server.py — slices serving
    # their degraded envelope (the partition symptom the federation
    # actuator reacts to between its cadence renews)
    "drl_audit_breaches",         # server.py — conservation-identity
    # violations observed by the audit plane (runtime/audit.py)
    "drl_slo_alerts",             # server.py — burn-rate watchdog
    # trip/clear transitions (utils/slo.py)
    "drl_retry_attempts_seen",    # server.py — attempt-tail-stamped
    # admissions (the retry-storm numerator; docs/DESIGN.md §24)
    "drl_goodput_settled_in_deadline",  # server.py — settles inside
    # the propagated deadline (the goodput numerator)
    "drl_goodput_deadline_expired_grants",  # server.py — grants whose
    # deadline passed before settle: admitted-but-doomed work, the
    # sensor that arms the doomed-work gate
)


@dataclass(frozen=True)
class ControllerConfig:
    """Knobs of one reconciliation loop (docs/OPERATIONS.md §13).

    Thresholds come in (high, low) pairs with distinct raise/release
    streak lengths — classic hysteresis, so a signal hovering AT a
    threshold can never flap the actuator. ``cooldown_ticks`` then
    spaces consecutive firings of the same actuator, and the global
    rolling budget (``budget_actions`` per ``budget_window_ticks``)
    bounds total actuation no matter how many actuators want to move.
    """

    #: Reconciliation cadence. Every rate below is a per-second value
    #: derived as ``counter_delta / tick_s``.
    tick_s: float = 0.5

    # -- shed ladder (token pressure → edge brownout) -----------------------
    #: Sustainable fleet admitted-tokens/sec. ``None`` disarms the shed
    #: actuator (the controller then only observes token velocity).
    token_rate_capacity: "float | None" = None
    #: Pressure (= token rate / capacity) at/above which the ladder
    #: steps UP one level after ``shed_raise_ticks`` consecutive ticks.
    shed_high: float = 0.9
    #: Pressure at/below which the ladder steps DOWN after
    #: ``shed_lower_ticks`` consecutive ticks. Must sit strictly below
    #: ``shed_high`` — the gap IS the hysteresis band.
    shed_low: float = 0.6
    shed_raise_ticks: int = 2
    shed_lower_ticks: int = 3
    #: Deepest shed level the controller may reach (priorities at/above
    #: the level shed). PRIORITY_BATCH sheds batch + scavenger;
    #: interactive traffic is NEVER shed autonomously.
    shed_floor: int = PRIORITY_BATCH
    #: Outstanding-reservation horizon: reserved-but-unsettled tokens
    #: (the ``drl_reservations_outstanding`` gauge, summed fleet-wide)
    #: are load that WILL land — fold them into the shed pressure as a
    #: prospective rate, ``outstanding / horizon`` tokens/sec (they are
    #: expected to settle within about one horizon — the reservation
    #: TTL's scale). This is what lets a brownout start BEFORE a wave
    #: of admitted-but-still-streaming requests hits the settled-token
    #: rate. The existing shed hysteresis (raise/lower streaks + the
    #: shed_low/shed_high dead band) guards the combined signal.
    reservation_horizon_s: float = 10.0

    # -- hot-cost key splitting (sketch-fed) --------------------------------
    #: One key's share of the fleet's per-tick admitted-token delta
    #: at/above which it is a split candidate.
    split_share: float = 0.35
    #: Absolute per-tick token-delta floor — idle fleets where one key
    #: is 100% of nothing must not split.
    split_min_tokens: float = 1.0
    split_streak_ticks: int = 2

    # -- slot rebalance -----------------------------------------------------
    #: Slot-count spread over active nodes, ``(max − min) / mean``,
    #: at/above which a rebalance is proposed.
    rebalance_imbalance: float = 0.25
    rebalance_streak_ticks: int = 2

    # -- membership (breaker-driven) ----------------------------------------
    #: Consecutive ticks a node's breaker must be OPEN before the
    #: controller drains it, and CLOSED again before it rejoins one the
    #: controller itself drained (it never rejoins operator drains).
    drain_after_open_ticks: int = 3

    # -- federation (WAN lease agent) ---------------------------------------
    #: Cadence, in ticks, of the federation actuator when a region
    #: agent is attached: every N ticks the controller drives one
    #: ``RegionFederation.tick`` with its per-tenant velocity-delta
    #: rates as the demand report — the demand-proportional slice
    #: sizing signal ("TokenScale"). A degraded slice (partition
    #: symptom in the drl_federation_region_* sensors) fires the
    #: actuator off-cadence, hysteresis-guarded like every other.
    federation_renew_ticks: int = 4
    federation_degraded_streak_ticks: int = 2

    # -- retry-storm defense (goodput under overload) -----------------------
    #: Retries' share of the fleet request rate at/above which the
    #: retry-storm rung arms the retry-shed + doomed-work gates after
    #: ``retry_storm_raise_ticks`` consecutive ticks. This rung sits
    #: BEFORE the priority shed ladder: retries and doomed work shed
    #: before any priority class browns out (docs/DESIGN.md §24).
    retry_storm_high: float = 0.5
    #: Share at/below which the gates release after
    #: ``retry_storm_lower_ticks`` ticks. Must sit strictly below
    #: ``retry_storm_high`` — the gap is the hysteresis band.
    retry_storm_low: float = 0.1
    retry_storm_raise_ticks: int = 2
    retry_storm_lower_ticks: int = 3
    #: Absolute retry-rate floor (attempts/sec): an idle fleet where
    #: one of two requests is a retry must not arm the defense.
    retry_storm_min_rate: float = 1.0

    # -- flap guards ---------------------------------------------------------
    #: Ticks after an actuator fires before the SAME actuator may fire
    #: again (per action kind).
    cooldown_ticks: int = 4
    #: Global rolling actuation budget: at most this many decided
    #: actions per ``budget_window_ticks`` window. Exhaustion is logged
    #: per starved decision, never silent.
    budget_actions: int = 8
    budget_window_ticks: int = 60

    #: Decide identically, execute nothing (log-only rollout posture).
    dry_run: bool = False

    def __post_init__(self) -> None:
        if self.tick_s <= 0:
            raise ValueError("tick_s must be positive")
        if self.token_rate_capacity is not None \
                and self.token_rate_capacity <= 0:
            raise ValueError("token_rate_capacity must be positive")
        if not self.shed_low < self.shed_high:
            raise ValueError("shed_low must sit strictly below shed_high "
                             "(the gap is the hysteresis band)")
        if not self.retry_storm_low < self.retry_storm_high:
            raise ValueError("retry_storm_low must sit strictly below "
                             "retry_storm_high (the gap is the "
                             "hysteresis band)")
        for name in ("shed_raise_ticks", "shed_lower_ticks",
                     "split_streak_ticks", "rebalance_streak_ticks",
                     "drain_after_open_ticks", "budget_actions",
                     "budget_window_ticks", "federation_renew_ticks",
                     "federation_degraded_streak_ticks",
                     "retry_storm_raise_ticks",
                     "retry_storm_lower_ticks"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if self.cooldown_ticks < 0:
            raise ValueError("cooldown_ticks must be >= 0")
        if self.reservation_horizon_s <= 0:
            raise ValueError("reservation_horizon_s must be positive")
        if self.shed_floor < PRIORITY_BATCH:
            raise ValueError("shed_floor below PRIORITY_BATCH would shed "
                             "interactive traffic autonomously — refused")


@dataclass
class Sensors:
    """One tick's derived sensor snapshot — everything ``decide``
    consumes, already rate-form (per-second via counter deltas)."""

    tick: int
    #: requests/sec per node index (0.0 for nodes without stats).
    node_rates: "list[float]"
    active_nodes: "list[int]"
    #: breaker state string per node ("closed" when no breaker plane).
    breaker_states: "list[str]"
    slot_counts: "list[int]"
    #: keys currently pinned by placement overrides.
    override_keys: "set[str]"
    #: fleet admitted tokens/sec (delta of the monotonic totals).
    token_rate: float
    #: per-tenant admitted tokens/sec (delta of per-tenant totals).
    tenant_rates: "dict[str, float]"
    #: fleet-aggregated per-key admitted-token delta THIS tick,
    #: descending — the sketch-fed hot-cost ranking.
    hot_key_deltas: "list[tuple[str, float]]"
    #: fleet-summed outstanding reserved tokens (reserve issued, settle
    #: pending — a LEVEL gauge, not a counter delta: the holds
    #: themselves are the prospective load).
    outstanding_tokens: float = 0.0
    #: federation sensors (LEVEL gauges): outstanding leases at any
    #: home in the fleet, and slices currently serving their degraded
    #: envelope at any region agent — the partition symptom.
    fed_outstanding: float = 0.0
    fed_degraded: float = 0.0
    #: Audit-plane sensors (cumulative fleet sums, zero when no node
    #: carries an auditor — the pre-audit soak schedules stay bit-for-
    #: bit): conservation breaches observed and watchdog alerts.
    audit_breaches: float = 0.0
    slo_alerts: float = 0.0
    #: Goodput-plane sensors (rates via counter deltas; zero on fleets
    #: with no attempt/deadline-stamped traffic, so pre-storm soak
    #: schedules stay bit-for-bit): attempt-tail-stamped admissions/sec
    #: and doomed-work/sec (deadline-expired grants + late settles).
    retry_rate: float = 0.0
    doomed_rate: float = 0.0

    @property
    def skew(self) -> float:
        """Max/mean per-node request rate over active nodes (1.0 when
        idle or single-node) — the load-imbalance gauge."""
        rates = [self.node_rates[j] for j in self.active_nodes
                 if j < len(self.node_rates)]
        if not rates:
            return 1.0
        mean = sum(rates) / len(rates)
        return max(rates) / mean if mean > 0 else 1.0

    @property
    def slot_spread(self) -> float:
        """(max − min)/mean slot ownership over active nodes."""
        counts = [self.slot_counts[j] for j in self.active_nodes
                  if j < len(self.slot_counts)]
        if not counts:
            return 0.0
        mean = sum(counts) / len(counts)
        return (max(counts) - min(counts)) / mean if mean > 0 else 0.0


class Controller:
    """The reconciliation loop (module docstring). One instance binds a
    :class:`~.cluster.ClusterBucketStore` (the actuator surface AND the
    sensor plane), zero or more shed targets (objects with
    ``set_shed_level`` — :class:`~.admission.AdmissionPolicy`), and a
    config. Drive it with :meth:`run` (wall-clock cadence) or call
    :meth:`tick` directly (the seeded soaks' deterministic drive)."""

    _ACTIONS_CAP = 512  # migration_log posture: newest events win

    def __init__(self, cluster, *,
                 config: "ControllerConfig | None" = None,
                 shed_targets: Sequence = (),
                 federation=None,
                 flight_recorder=None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cluster = cluster
        self.config = config or ControllerConfig()
        self._shed_targets = list(shed_targets)
        #: Optional :class:`~.federation.RegionFederation`: when
        #: attached, the ``federation`` actuator drives its WAN
        #: lease/renew round (demand = the velocity-delta tenant rates)
        #: on the ``federation_renew_ticks`` cadence.
        self.federation = federation
        self.flight_recorder = (flight_recorder
                                if flight_recorder is not None
                                else getattr(cluster, "flight_recorder",
                                             None))
        self._clock = clock
        # Sensor state: one delta window per counter, owned by THIS
        # consumer (CounterDeltas — the destructive-reset contract).
        self._deltas = CounterDeltas()
        # Decision state (all of it evolves identically in dry-run —
        # the dry-run parity contract).
        self._tick = 0
        self._streaks: dict[str, int] = {}      # gate name → consecutive
        self._cooldowns: dict[str, int] = {}    # action kind → next ok tick
        self._budget_ticks: list[int] = []      # decided-action ticks
        self._open_streak: dict[int, int] = {}  # node → consecutive OPEN
        self._closed_streak: dict[int, int] = {}
        #: Nodes THIS controller drained (only these may auto-rejoin).
        self.auto_drained: set[int] = set()
        #: The decided shed level (None = shed nothing). Pushed to shed
        #: targets only when live; the decided value itself evolves in
        #: dry-run too, so the decision stream stays comparable.
        self.shed_level: "int | None" = None
        #: Retry-storm defense posture (decided here, pushed to shed
        #: targets' set_retry_shed/set_doomed_gate when live; evolves
        #: identically in dry-run — the parity contract).
        self.retry_shed_on = False
        # Audit surface.
        self.actions: list[dict] = []
        self.actions_recorded = 0
        self.ticks = 0
        self.tick_failures = 0
        self.scrape_errors = 0
        self.actuation_errors = 0
        self._actions_by_outcome: dict[tuple[str, str], int] = {}
        self.last_pressure = 0.0
        self.last_skew = 1.0
        self.last_token_rate = 0.0
        self.last_outstanding = 0.0
        self.last_fed_degraded = 0.0
        self.last_fed_outstanding = 0.0
        self.last_audit_breaches = 0.0
        self.last_slo_alerts = 0.0
        self.last_retry_ratio = 0.0
        self.last_doomed_rate = 0.0
        self._stop = asyncio.Event()
        # Announce on the audit surfaces that can splice us in
        # (cluster.stats() "controller" section, cluster_metrics()).
        try:
            cluster.controller = self
        except AttributeError:
            pass

    # -- sensing -------------------------------------------------------------
    async def scrape(self) -> Sensors:
        """One OP_STATS fan-out turned into rate-form sensors. Never
        resets server windows; all rates are this consumer's own
        counter deltas over ``tick_s``.

        Deltas are taken PER NODE and then summed — never the other
        way around. A fleet-summed counter is not monotonic: a node
        missing from one scrape (timeout → ``{}`` in the fan-out, the
        cluster's down-node posture) would drop the sum, and the
        reset convention would then report the entire remaining sum as
        one tick's "increase" — a phantom pressure spike that could
        shed real traffic during a mere sensor-plane blip. Per-node
        windows confine a node's outage to that node's contribution:
        an unobserved counter simply doesn't advance its window, and
        recovery folds the gap into one wide (true) delta."""
        cfg = self.config
        st = await self.cluster.stats()
        nodes = st.get("nodes", [])
        node_rates = []
        tenant_rates: dict[str, float] = {}
        hot_totals: dict[str, float] = {}
        outstanding = 0.0
        fed_outstanding = fed_degraded = 0.0
        audit_breaches = slo_alerts = 0.0
        retry_rate = doomed_rate = 0.0
        for j, ns in enumerate(nodes):
            if not ns:
                node_rates.append(0.0)
                continue
            node_rates.append(self._deltas.rate(
                f"node{j}/requests", ns.get("requests_served", 0),
                cfg.tick_s))
            # Outstanding reservations are a level, summed as-is (an
            # unobserved node contributes nothing — conservative: its
            # holds neither spike nor mask the fleet pressure).
            outstanding += float((ns.get("reservations") or {})
                                 .get("outstanding_tokens", 0.0))
            # Federation levels: home lease count + region degraded
            # slices (the partition symptom the actuator reacts to).
            fed_outstanding += float((ns.get("federation") or {})
                                     .get("outstanding_leases", 0.0))
            fed_degraded += float((ns.get("federation_region") or {})
                                  .get("degraded_now", 0.0))
            # Audit plane (cumulative counters summed as levels — the
            # controller only watches for growth; a node without an
            # auditor contributes zero, so pre-audit soaks replay
            # unchanged).
            au = ns.get("audit") or {}
            audit_breaches += float(au.get("breaches", 0.0))
            slo_alerts += float((au.get("slo") or {}).get("alerts", 0.0))
            # Goodput plane (docs/DESIGN.md §24): both sections are
            # emitted only once stamped traffic exists — absent means
            # zeros, and the per-node delta windows simply don't
            # advance. Deadline-expired grants + late settles sum into
            # one monotonic doomed-work counter per node.
            rt = ns.get("retry") or {}
            retry_rate += self._deltas.rate(
                f"node{j}/retry_attempts",
                float(rt.get("attempts_seen", 0.0)), cfg.tick_s)
            gp = ns.get("goodput") or {}
            doomed_rate += self._deltas.rate(
                f"node{j}/goodput_doomed",
                float(gp.get("deadline_expired_grants", 0.0))
                + float(gp.get("settled_late", 0.0)), cfg.tick_s)
            tv = ns.get("token_velocity") or {}
            for tenant, total in (tv.get("admitted") or {}).items():
                tenant_rates[tenant] = tenant_rates.get(tenant, 0.0) \
                    + self._deltas.rate(f"node{j}/tenant/{tenant}",
                                        float(total), cfg.tick_s)
            for row in (ns.get("hot_keys") or {}).get("top", ()):
                key = row["key"]
                hot_totals[key] = hot_totals.get(key, 0.0) \
                    + self._deltas.delta(f"node{j}/hot/{key}",
                                         float(row["count"]))
        token_rate = sum(tenant_rates.values())
        hot_deltas = sorted(hot_totals.items(), key=lambda kv: -kv[1])
        resil = st.get("resilience", {})
        breakers = resil.get("breakers")
        n_nodes = len(nodes)
        if breakers:
            breaker_states = [b.get("state", "closed") for b in breakers]
        else:
            breaker_states = ["closed"] * n_nodes
        placement = st.get("placement", {})
        drained = set(placement.get("drained", ()))
        active = [j for j in range(n_nodes) if j not in drained]
        overrides = set(getattr(getattr(self.cluster, "placement", None),
                                "overrides", {}) or {})
        return Sensors(
            tick=self._tick,
            node_rates=node_rates,
            active_nodes=active,
            breaker_states=breaker_states,
            slot_counts=list(placement.get("slot_counts",
                                           [0] * n_nodes)),
            override_keys=overrides,
            token_rate=token_rate,
            tenant_rates=tenant_rates,
            hot_key_deltas=hot_deltas,
            outstanding_tokens=outstanding,
            fed_outstanding=fed_outstanding,
            fed_degraded=fed_degraded,
            audit_breaches=audit_breaches,
            slo_alerts=slo_alerts,
            retry_rate=retry_rate,
            doomed_rate=doomed_rate,
        )

    # -- flap guards ---------------------------------------------------------
    def _streak(self, name: str, condition: bool) -> int:
        """Advance/reset a named hysteresis streak; returns its length."""
        n = self._streaks.get(name, 0) + 1 if condition else 0
        self._streaks[name] = n
        return n

    def _gate(self, kind: str) -> "str | None":
        """Cooldown + budget gate for an actuator that wants to fire.
        Returns None (clear to decide) or the blocking outcome. Both
        guards consume state identically in dry-run (parity)."""
        if self._cooldowns.get(kind, -1) > self._tick:
            return "cooldown"
        window_start = self._tick - self.config.budget_window_ticks
        self._budget_ticks = [t for t in self._budget_ticks
                              if t > window_start]
        if len(self._budget_ticks) >= self.config.budget_actions:
            return "budget_exhausted"
        return None

    def _commit_gate(self, kind: str) -> None:
        """A decision fired: start its cooldown, spend the budget."""
        self._cooldowns[kind] = self._tick + self.config.cooldown_ticks \
            + 1
        self._budget_ticks.append(self._tick)

    def budget_remaining(self) -> int:
        window_start = self._tick - self.config.budget_window_ticks
        spent = sum(1 for t in self._budget_ticks if t > window_start)
        return max(0, self.config.budget_actions - spent)

    # -- deciding ------------------------------------------------------------
    def decide(self, sensors: Sensors) -> list[dict]:
        """The pure policy half: sensor snapshot + controller state →
        intents. Every intent carries ``action``/``target``/``reason``;
        a flap-guard-starved one carries its blocking ``outcome``
        pre-set (``cooldown`` never logs — it is the steady state of
        hysteresis — but ``budget_exhausted`` does: a starved loop must
        be visible). Identical in dry-run by construction."""
        cfg = self.config
        intents: list[dict] = []
        self.last_skew = sensors.skew
        self.last_token_rate = sensors.token_rate
        self.last_fed_degraded = sensors.fed_degraded
        self.last_fed_outstanding = sensors.fed_outstanding
        self.last_audit_breaches = sensors.audit_breaches
        self.last_slo_alerts = sensors.slo_alerts

        def want(kind: str, target, reason: str, **extra) -> bool:
            """Returns True when the intent passed every gate (it WILL
            be executed in live mode) — callers key their own decision
            state off this, so that state evolves identically in
            dry-run (the parity contract)."""
            gate = self._gate(kind)
            if gate == "cooldown":
                return False  # waiting out a cooldown is not an event
            intent = {"action": kind, "target": target, "reason": reason,
                      **extra}
            if gate is not None:
                # Starved (budget): logged but not executed — and the
                # cooldown starts anyway, so a stalled loop reports
                # once per cooldown window, not once per tick.
                intent["outcome"] = gate
                self._cooldowns[kind] = self._tick \
                    + cfg.cooldown_ticks + 1
            else:
                self._commit_gate(kind)
            intents.append(intent)
            return gate is None

        # 1. Membership: sustained breaker OPEN → drain; recovery of a
        # node WE drained → rejoin. Consecutive-tick streaks per node.
        for j, state in enumerate(sensors.breaker_states):
            is_open = state == "open"
            self._open_streak[j] = (self._open_streak.get(j, 0) + 1
                                    if is_open else 0)
            self._closed_streak[j] = (self._closed_streak.get(j, 0) + 1
                                      if state == "closed" else 0)
            if (is_open and j in sensors.active_nodes
                    and len(sensors.active_nodes) > 1
                    and j not in self.auto_drained
                    and self._open_streak[j] >= cfg.drain_after_open_ticks):
                # auto_drained is DECISION state (it gates re-drain and
                # the rejoin path), so it mutates here — dry-run's
                # membership stream must match live's. A live drain
                # that then fails (outcome "error") stays marked: the
                # decision was made; retrying it for free would be a
                # flap-amplifier exactly when the fleet is sick, and
                # the later rejoin of a never-drained node is a no-op.
                if want("drain", j,
                        f"breaker open {self._open_streak[j]} ticks"):
                    self.auto_drained.add(j)
            elif (j in self.auto_drained
                    and self._closed_streak[j]
                    >= cfg.drain_after_open_ticks):
                if want("rejoin", j,
                        f"breaker closed {self._closed_streak[j]} ticks "
                        "after an autonomous drain"):
                    self.auto_drained.discard(j)

        # 2. Hot-COST split: one key's share of this tick's admitted
        # tokens, sustained. Only meaningful with somewhere to split to.
        split_cond = False
        if sensors.hot_key_deltas and len(sensors.active_nodes) > 1:
            key, delta = sensors.hot_key_deltas[0]
            total = sum(d for _, d in sensors.hot_key_deltas)
            share = delta / total if total > 0 else 0.0
            split_cond = (delta >= cfg.split_min_tokens
                          and share >= cfg.split_share
                          and key not in sensors.override_keys)
            if self._streak("split", split_cond) >= cfg.split_streak_ticks:
                want("split", key,
                     f"key carries {share:.0%} of admitted tokens "
                     f"({delta:.0f}/tick)", share=round(share, 4))
                self._streaks["split"] = 0
        else:
            self._streak("split", False)

        # 3. Slot rebalance on sustained ownership imbalance.
        spread = sensors.slot_spread
        if self._streak("rebalance",
                        spread >= cfg.rebalance_imbalance
                        and len(sensors.active_nodes) > 1) \
                >= cfg.rebalance_streak_ticks:
            want("rebalance", None,
                 f"slot spread {spread:.2f} over active nodes",
                 spread=round(spread, 4))
            self._streaks["rebalance"] = 0

        # 4. Federation: when a region agent is attached, drive its
        # WAN renew round on the tick cadence — the controller's
        # velocity-delta rates ARE the demand report the home's
        # demand-proportional slice sizing consumes — and off-cadence
        # when a slice is serving its degraded envelope (partition
        # symptom, hysteresis-guarded: a one-scrape blip never fires).
        if self.federation is not None:
            self._last_tenant_rates = dict(sensors.tenant_rates)
            due = self._tick % cfg.federation_renew_ticks == 0
            deg = self._streak("fed_degraded",
                               sensors.fed_degraded > 0)
            if due:
                want("federation", None,
                     f"renew cadence (every "
                     f"{cfg.federation_renew_ticks} ticks)")
            elif deg >= cfg.federation_degraded_streak_ticks:
                want("federation", None,
                     f"{sensors.fed_degraded:.0f} slice(s) degraded "
                     f"{deg} ticks — attempting heal")
                self._streaks["fed_degraded"] = 0
        else:
            self._streak("fed_degraded", False)

        # 5. Retry-storm defense — the rung BEFORE the priority shed
        # ladder (docs/DESIGN.md §24): when retries become a sustained
        # share of the fleet request rate, arm the retry-shed and
        # doomed-work gates so duplicate and unmeetable work sheds
        # before any priority class browns out. Hysteresis-guarded
        # like every rung; the decided posture evolves in dry-run too.
        request_rate = sum(sensors.node_rates)
        ratio = (sensors.retry_rate / request_rate
                 if request_rate > 0 else 0.0)
        self.last_retry_ratio = ratio
        self.last_doomed_rate = sensors.doomed_rate
        hi_r = self._streak(
            "retry_high",
            ratio >= cfg.retry_storm_high
            and sensors.retry_rate >= cfg.retry_storm_min_rate)
        lo_r = self._streak("retry_low", ratio <= cfg.retry_storm_low)
        if hi_r >= cfg.retry_storm_raise_ticks and not self.retry_shed_on:
            if want("retry_shed_on", None,
                    f"retries are {ratio:.0%} of the fleet request "
                    f"rate ({sensors.retry_rate:.1f}/s; doomed work "
                    f"{sensors.doomed_rate:.1f}/s)",
                    ratio=round(ratio, 4)):
                self.retry_shed_on = True
            self._streaks["retry_high"] = 0
        elif lo_r >= cfg.retry_storm_lower_ticks and self.retry_shed_on:
            if want("retry_shed_off", None,
                    f"retry share {ratio:.0%} ≤ {cfg.retry_storm_low}",
                    ratio=round(ratio, 4)):
                self.retry_shed_on = False
            self._streaks["retry_low"] = 0

        # 6. Shed ladder from token-velocity pressure PLUS outstanding-
        # reservation pressure: reserved-but-unsettled tokens are load
        # that WILL land, folded in as a prospective rate over the
        # reservation horizon — brownouts start before a wave of
        # still-streaming requests reaches the settled-token rate. The
        # decided level evolves here (dry-run included); execution only
        # pushes it to the attached gateways.
        self.last_outstanding = sensors.outstanding_tokens
        if cfg.token_rate_capacity:
            prospective = (sensors.outstanding_tokens
                           / cfg.reservation_horizon_s)
            pressure = ((sensors.token_rate + prospective)
                        / cfg.token_rate_capacity)
            self.last_pressure = pressure
            hi = self._streak("shed_high", pressure >= cfg.shed_high)
            lo = self._streak("shed_low", pressure <= cfg.shed_low)
            if hi >= cfg.shed_raise_ticks:
                nxt = (PRIORITY_SCAVENGER if self.shed_level is None
                       else self.shed_level - 1)
                if self.shed_level is None or nxt >= cfg.shed_floor:
                    top = max(sensors.tenant_rates.items(),
                              key=lambda kv: kv[1],
                              default=(None, 0.0))
                    if want("shed_raise", nxt,
                            f"token pressure {pressure:.2f} ≥ "
                            f"{cfg.shed_high} (hottest tenant: "
                            f"{top[0]})",
                            pressure=round(pressure, 4)):
                        self.shed_level = nxt
                self._streaks["shed_high"] = 0
            elif lo >= cfg.shed_lower_ticks and self.shed_level is not None:
                nxt = (None if self.shed_level >= PRIORITY_SCAVENGER
                       else self.shed_level + 1)
                if want("shed_lower", nxt,
                        f"token pressure {pressure:.2f} ≤ {cfg.shed_low}",
                        pressure=round(pressure, 4)):
                    self.shed_level = nxt
                self._streaks["shed_low"] = 0
        return intents

    # -- actuating -----------------------------------------------------------
    async def _execute(self, intent: dict) -> str:
        """Run one intent through the real actuator paths (all of them
        health-gated and serialized under the cluster's
        ``_membership_lock`` where membership is involved). Returns the
        outcome string."""
        if self.config.dry_run:
            return "dry_run"
        kind, target = intent["action"], intent["target"]
        try:
            if kind == "split":
                # Sketch-fed: split_hot_keys re-ranks from the fleet's
                # own heavy-hitter sketch and pins the winner — the
                # sensed candidate rides along in the record for audit.
                keys = await self.cluster.split_hot_keys(top_n=1)
                intent["split_keys"] = keys
                return "executed" if keys else "noop"
            if kind == "rebalance":
                await self.cluster.rebalance(reason="controller")
                return "executed"
            if kind == "drain":
                await self.cluster.drain_node(target)
                return "executed"
            if kind == "rejoin":
                await self.cluster.rejoin_node(target)
                return "executed"
            if kind == "federation":
                if self.federation is None:   # pragma: no cover
                    return "noop"             # decide() gates on it
                summary = await self.federation.tick(
                    demands=getattr(self, "_last_tenant_rates", None))
                intent["summary"] = summary
                if summary.get("errors") and not (
                        summary.get("renewed") or summary.get("leased")):
                    # Every WAN call failed: a partition symptom, not
                    # an actuator error — counted on the agent, and
                    # the outcome says so for the audit trail.
                    return "partitioned"
                return "executed"
            if kind in ("shed_raise", "shed_lower"):
                if not self._shed_targets:
                    # No gateway to actuate: the decided level still
                    # evolves (and is scrapeable), but claiming
                    # "executed" would put a brownout in the audit
                    # trail that never reached any admission edge.
                    return "noop"
                for policy in self._shed_targets:
                    policy.set_shed_level(target)
                return "executed"
            if kind in ("retry_shed_on", "retry_shed_off"):
                if not self._shed_targets:
                    return "noop"  # same posture as the shed ladder
                on = kind == "retry_shed_on"
                hit = False
                for policy in self._shed_targets:
                    # Both gates arm together: duplicate work (retries)
                    # and unmeetable work (doomed deadlines) shed as
                    # one defense. getattr-probed — a bare
                    # AdmissionPolicy target has the retry gate only,
                    # a server target has both.
                    for meth in ("set_retry_shed", "set_doomed_gate"):
                        fn = getattr(policy, meth, None)
                        if callable(fn):
                            fn(on)
                            hit = True
                return "executed" if hit else "noop"
            return "noop"  # unknown intent kinds are inert, visibly
        except asyncio.CancelledError:
            raise
        except Exception as exc:
            # Routed, not swallowed: counted here, carried on the action
            # record (flight frame + log event 6 + actions_total series).
            self.actuation_errors += 1
            intent["error"] = repr(exc)
            return "error"

    def _log_action(self, record: dict) -> None:
        self.actions.append(record)
        if len(self.actions) > self._ACTIONS_CAP:
            del self.actions[: -self._ACTIONS_CAP]
        self.actions_recorded += 1
        key = (record["action"], record["outcome"])
        self._actions_by_outcome[key] = \
            self._actions_by_outcome.get(key, 0) + 1
        if self.flight_recorder is not None:
            self.flight_recorder.record("controller", **record)
        log.controller_action(record)

    # -- the loop ------------------------------------------------------------
    async def tick(self) -> list[dict]:
        """One reconciliation round: seam → scrape → decide → actuate →
        audit. Returns this tick's action records (gated ones
        included). A faulted or failed tick counts + records a frame
        and decides nothing — the next tick re-derives from fresh
        deltas, so a lost round costs one window, never drift."""
        self._tick += 1
        try:
            await faults.seam("controller.tick")
            sensors = await self.scrape()
        except asyncio.CancelledError:
            raise
        except faults.BlackholeFault:
            self.tick_failures += 1
            if self.flight_recorder is not None:
                self.flight_recorder.record("controller", tick=self._tick,
                                            action="tick",
                                            outcome="blackhole")
            return []
        except Exception as exc:
            self.tick_failures += 1
            self.scrape_errors += 1
            if self.flight_recorder is not None:
                self.flight_recorder.record(
                    "controller", tick=self._tick, action="tick",
                    outcome="fault", error=repr(exc))
            return []
        intents = self.decide(sensors)
        records: list[dict] = []
        for intent in intents:
            outcome = intent.pop("outcome", None)
            if outcome is None:
                outcome = await self._execute(intent)
            record = {"tick": self._tick, "t": self._clock(),
                      "outcome": outcome, **intent}
            self._log_action(record)
            records.append(record)
        self.ticks += 1
        return records

    async def run(self) -> None:
        """Tick on the configured wall-clock cadence until
        :meth:`stop`. The soaks drive :meth:`tick` directly instead —
        cadence is an operational concern, not a semantic one."""
        self._stop.clear()
        while not self._stop.is_set():
            await self.tick()
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.config.tick_s)
            except asyncio.TimeoutError:
                continue

    def stop(self) -> None:
        self._stop.set()

    # -- audit surfaces ------------------------------------------------------
    def numeric_stats(self) -> dict:
        """Flat numeric dict for ``register_numeric_dict`` — the
        ``drl_controller_*`` gauge/counter families."""
        return {
            "ticks": self.ticks,
            "tick_failures": self.tick_failures,
            "actions_recorded": self.actions_recorded,
            "actuation_errors": self.actuation_errors,
            "shed_level": -1 if self.shed_level is None
            else self.shed_level,
            "pressure": self.last_pressure,
            "skew": self.last_skew,
            "token_rate": self.last_token_rate,
            "outstanding_tokens": self.last_outstanding,
            "fed_degraded": self.last_fed_degraded,
            "fed_outstanding_leases": self.last_fed_outstanding,
            "audit_breaches_seen": self.last_audit_breaches,
            "slo_alerts_seen": self.last_slo_alerts,
            "retry_ratio": self.last_retry_ratio,
            "doomed_rate": self.last_doomed_rate,
            "retry_shed_on": int(self.retry_shed_on),
            "budget_remaining": self.budget_remaining(),
            "dry_run": int(self.config.dry_run),
            "auto_drained": len(self.auto_drained),
        }

    def action_series(self) -> list[tuple[dict, float]]:
        """``drl_controller_actions_total{action=,outcome=}`` series."""
        return [({"action": a, "outcome": o}, float(n))
                for (a, o), n in sorted(self._actions_by_outcome.items())]

    def register_metrics(self, reg) -> None:
        """Splice the controller families into an existing registry
        (the server's or the cluster's). Callables read live state, so
        registering before the first tick costs nothing."""
        reg.register_numeric_dict(
            "controller", "autonomous control plane",
            self.numeric_stats,
            counters={"ticks", "tick_failures", "actions_recorded",
                      "actuation_errors"})
        reg.labeled_counters(
            "controller_actions",
            "Controller decisions by action and outcome",
            self.action_series)

    def metrics_registry(self):
        from distributedratelimiting.redis_tpu_torch.utils.metrics import (
            MetricsRegistry,
        )

        reg = MetricsRegistry()
        self.register_metrics(reg)
        return reg

    def stats(self) -> dict:
        """JSON-shaped audit summary for OP_STATS embedding (the full
        bounded action log lives on :attr:`actions`; stats carries the
        newest 50)."""
        return {
            **self.numeric_stats(),
            "scrape_errors": self.scrape_errors,
            "actions_total": {f"{a}:{o}": n for (a, o), n
                              in sorted(self._actions_by_outcome.items())},
            "actions": self.actions[-50:],
        }
