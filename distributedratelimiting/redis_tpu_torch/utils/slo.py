"""Multi-window SLO burn-rate watchdog — the alerting half of the
conservation audit plane (runtime/audit.py).

The JAX package's ``utils/slo.py``, backend-free and kept whole: the same
sample stream gives both packages the same alert log.

"When Two is Worse Than One" (PAPERS.md) is the cautionary tale this
module exists for: a drift regime nobody is told about becomes
metastable collapse. The watchdog turns the monotonic counter plane
into typed alerts using the classic multi-window burn-rate method: for
each service-level objective it tracks a FAST and a SLOW window over
the same error ratio and trips only when BOTH burn faster than the
budget allows — the fast window gives detection latency, the slow
window suppresses one-tick blips (the zero-false-alarm posture the
seeded soaks pin).

Delta-based by contract: every input is a cumulative monotonic counter
sampled once per tick; windows are differences of ring entries, never
``reset=True`` (the destructive-reset contract, utils/metrics.py).
Ticks are COUNTED, not clocked — driven by a seeded schedule the alert
log is a pure function of the sample stream, which is what makes
"same seed ⇒ identical alert schedule" a testable property.

Watched dimensions (the OPERATIONS.md §18 window table):

========== ============================== ==========================
slo        error ratio (windowed)         default objective
========== ============================== ==========================
overadmit  overadmitted / admitted tokens 1e-3 of admitted tokens
latency    samples above p99 SLO / total  1% above 0.25 s (CPU
                                          stand-in; tighten to the
                                          2 ms north star on the card)
shed       requests_shed / requests       5% of requests
goodput    served rate below floor        disarmed (``None``)
========== ============================== ==========================

:data:`SLO_SERIES` declares every OpenMetrics series the watchdog's
sample stream is derived from — drl-check's ``metric-name`` rule holds
each entry to a live registration site, exactly as it does for the
controller's ``SENSOR_SERIES``, so a rename on the emitting side fails
``make check`` instead of silently blinding the watchdog.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Callable, Mapping

__all__ = ["SLO_SERIES", "SLOConfig", "BurnRateWatchdog"]

#: Every OpenMetrics series the watchdog's tick samples are derived
#: from (through the same counters the families render). drl-check's
#: ``metric-name`` rule resolves each against a registration site —
#: file:line on both sides — so the sensor plane cannot drift.
SLO_SERIES = (
    "drl_requests_served",      # server.py — goodput / shed denominator
    "drl_requests_shed",        # server.py — shed-rate numerator
    "drl_admitted_tokens",      # server.py — over-admission denominator
    "drl_serving_latency_seconds",   # server.py — the p99 latency SLI
    "drl_audit_overadmitted_tokens",  # server.py audit family — the
    # conservation ledger's realized over-admission (runtime/audit.py)
    "drl_epsilon_budget_used_ratio",  # server.py — per-source ε
    # utilization gauges the runbook's symptom table starts from
    "drl_goodput_settled_in_deadline",  # server.py — deadline-true
    # goodput (settles inside the client's propagated deadline): the
    # refinement of the served-rate floor the overload runbook reads
    # during a retry storm (docs/DESIGN.md §24, OPERATIONS.md §20) —
    # served-rate can look healthy while every grant settles late
)

#: The watchdog's dimensions, in a fixed order (the alert log's
#: deterministic iteration order).
_DIMENSIONS = ("overadmit", "latency", "shed", "goodput")


@dataclass(frozen=True)
class SLOConfig:
    """Knobs of one burn-rate watchdog (docs/OPERATIONS.md §18).

    Objectives set to ``None`` disarm their dimension. Windows are in
    TICKS (the caller owns the tick cadence); the burn thresholds are
    the SRE-standard pair — a trip needs the fast window burning hard
    AND the slow window confirming it is not a blip.
    """

    #: Error-budget objectives. ``overadmit_ratio`` is the tolerated
    #: over-admitted fraction of admitted tokens (the Σ-of-ε contract:
    #: realized drift beyond the documented ε budgets is an incident).
    overadmit_ratio: "float | None" = 1e-3
    #: Latency SLO: at most ``latency_bad_fraction`` of requests may
    #: exceed ``latency_slo_s``. The default threshold is the CPU
    #: stand-in's generous envelope — card deployments tighten it to
    #: the <2 ms north star (the runbook's knob table).
    latency_slo_s: "float | None" = 0.25
    latency_bad_fraction: float = 0.01
    #: Shed SLO: tolerated fraction of requests dropped unexecuted
    #: (deadline-expired in server queueing).
    shed_ratio: "float | None" = 0.05
    #: Goodput floor in requests/sec; trips when the served rate sits
    #: below it in both windows. Disarmed by default — it needs a
    #: deployment-specific number. Arms itself only after the rate has
    #: first REACHED the floor (a warming-up server is not an outage).
    goodput_floor_rps: "float | None" = None

    #: Window pair, in ticks. fast ≪ slow by construction.
    fast_ticks: int = 6
    slow_ticks: int = 60
    #: Burn-rate thresholds: windowed error ratio ÷ objective must
    #: exceed BOTH for a trip (14.4/6 ≙ the 1h/6h page pair scaled to
    #: tick cadence).
    burn_fast: float = 14.4
    burn_slow: float = 6.0
    #: Hysteresis streaks (the controller's raise/release posture): a
    #: condition must hold ``trip_streak`` consecutive ticks to trip
    #: and clear for ``clear_streak`` to untrip.
    trip_streak: int = 1
    clear_streak: int = 3
    #: Nominal tick seconds — used ONLY to turn the goodput window
    #: delta into a rate; never consulted for expiry or alert logic.
    tick_s: float = 0.5

    def __post_init__(self) -> None:
        if self.fast_ticks <= 0 or self.slow_ticks < self.fast_ticks:
            raise ValueError("need 0 < fast_ticks <= slow_ticks")
        if self.trip_streak <= 0 or self.clear_streak <= 0:
            raise ValueError("streaks must be positive")


class _DimState:
    __slots__ = ("tripped", "hot", "cold", "burn_fast", "burn_slow")

    def __init__(self) -> None:
        self.tripped = False
        self.hot = 0      # consecutive ticks over both thresholds
        self.cold = 0     # consecutive ticks under both
        self.burn_fast = 0.0
        self.burn_slow = 0.0


class BurnRateWatchdog:
    """Multi-window burn-rate alerting over a cumulative sample stream.

    :meth:`tick` consumes one flat mapping of CUMULATIVE counters —
    ``requests``, ``shed``, ``admitted_tokens``, ``overadmitted_tokens``,
    ``latency_total`` (histogram samples) and ``latency_bad`` (samples
    above the latency SLO, derived from the same cumulative buckets) —
    and returns the alerts emitted this tick. Alerts also land as
    ``kind="slo"`` flight-recorder frames and in the bounded
    :attr:`alert_log` (the deterministic schedule the seeded soak
    compares bit for bit); ``on_trip`` fires once per trip transition
    (the incident-bundle hook)."""

    _LOG_CAP = 256

    def __init__(self, cfg: "SLOConfig | None" = None, *,
                 flight_recorder=None,
                 on_trip: "Callable[[str, dict], None] | None" = None
                 ) -> None:
        self.cfg = cfg or SLOConfig()
        self.flight_recorder = flight_recorder
        self.on_trip = on_trip
        self.ticks = 0
        self.alerts = 0
        self.trips = 0
        self.clears = 0
        self._ring: deque[dict] = deque(maxlen=self.cfg.slow_ticks + 1)
        self._dims = {d: _DimState() for d in _DIMENSIONS}
        #: True once goodput has ever reached its floor (arming latch).
        self._goodput_armed = False
        self.alert_log: deque[dict] = deque(maxlen=self._LOG_CAP)

    # -- window math ---------------------------------------------------------
    def _delta(self, key: str, ticks: int) -> float:
        ring = self._ring
        newest = ring[-1]
        oldest = ring[max(0, len(ring) - 1 - ticks)]
        return max(0.0, float(newest.get(key, 0.0))
                   - float(oldest.get(key, 0.0)))

    def _ratio_burn(self, num: str, den: str, budget: float,
                    ticks: int) -> float:
        dd = self._delta(den, ticks)
        if dd <= 0.0:
            return 0.0
        return (self._delta(num, ticks) / dd) / budget

    # -- tick ----------------------------------------------------------------
    def tick(self, sample: Mapping[str, float]) -> list[dict]:
        """Consume one cumulative sample; returns this tick's alerts."""
        self.ticks += 1
        self._ring.append(dict(sample))
        cfg = self.cfg
        burns: dict[str, tuple[float, float]] = {}
        if cfg.overadmit_ratio is not None:
            burns["overadmit"] = (
                self._ratio_burn("overadmitted_tokens", "admitted_tokens",
                                 cfg.overadmit_ratio, cfg.fast_ticks),
                self._ratio_burn("overadmitted_tokens", "admitted_tokens",
                                 cfg.overadmit_ratio, cfg.slow_ticks))
        if cfg.latency_slo_s is not None:
            burns["latency"] = (
                self._ratio_burn("latency_bad", "latency_total",
                                 cfg.latency_bad_fraction, cfg.fast_ticks),
                self._ratio_burn("latency_bad", "latency_total",
                                 cfg.latency_bad_fraction, cfg.slow_ticks))
        if cfg.shed_ratio is not None:
            burns["shed"] = (
                self._ratio_burn("shed", "requests", cfg.shed_ratio,
                                 cfg.fast_ticks),
                self._ratio_burn("shed", "requests", cfg.shed_ratio,
                                 cfg.slow_ticks))
        if cfg.goodput_floor_rps is not None:
            burns["goodput"] = self._goodput_burns()
        out: list[dict] = []
        for dim, (fast, slow) in burns.items():
            st = self._dims[dim]
            st.burn_fast, st.burn_slow = fast, slow
            over = fast >= cfg.burn_fast and slow >= cfg.burn_slow
            alert = self._advance(dim, st, over)
            if alert is not None:
                out.append(alert)
        return out

    def _goodput_burns(self) -> tuple[float, float]:
        """Goodput burns: served rate below the floor reads as burn
        ``floor / rate`` (≥ thresholds once rate collapses), gated by
        the arming latch so a warming-up server never alarms."""
        cfg = self.cfg
        burns = []
        for ticks in (cfg.fast_ticks, cfg.slow_ticks):
            window = min(ticks, max(1, len(self._ring) - 1))
            rate = self._delta("requests", ticks) / (window * cfg.tick_s)
            if not self._goodput_armed:
                if rate >= cfg.goodput_floor_rps:
                    self._goodput_armed = True
                burns.append(0.0)
            elif rate <= 0.0:
                burns.append(max(cfg.burn_fast, cfg.burn_slow))
            else:
                burn = cfg.goodput_floor_rps / rate
                # Map "rate at/above floor" to zero burn so hysteresis
                # clears cleanly.
                burns.append(burn if burn > 1.0 else 0.0)
        return burns[0], burns[1]

    def _advance(self, dim: str, st: _DimState,
                 over: bool) -> "dict | None":
        cfg = self.cfg
        if over:
            st.hot += 1
            st.cold = 0
        else:
            st.cold += 1
            st.hot = 0
        if not st.tripped and st.hot >= cfg.trip_streak:
            st.tripped = True
            self.trips += 1
            return self._emit(dim, st, "trip")
        if st.tripped and st.cold >= cfg.clear_streak:
            st.tripped = False
            self.clears += 1
            return self._emit(dim, st, "clear")
        return None

    def _emit(self, dim: str, st: _DimState, state: str) -> dict:
        alert = {
            "tick": self.ticks,
            "slo": dim,
            "state": state,
            "burn_fast": round(st.burn_fast, 6),
            "burn_slow": round(st.burn_slow, 6),
            "window_fast_ticks": self.cfg.fast_ticks,
            "window_slow_ticks": self.cfg.slow_ticks,
        }
        self.alerts += 1
        self.alert_log.append(alert)
        if self.flight_recorder is not None:
            self.flight_recorder.record("slo", **alert)
        if state == "trip" and self.on_trip is not None:
            self.on_trip(dim, alert)
        return alert

    # -- introspection -------------------------------------------------------
    def tripped(self) -> list[str]:
        return [d for d in _DIMENSIONS if self._dims[d].tripped]

    def numeric_stats(self) -> dict:
        """Flat numeric dict for ``register_numeric_dict`` — the
        ``drl_slo_*`` families."""
        out = {
            "ticks": self.ticks,
            "alerts": self.alerts,
            "trips": self.trips,
            "clears": self.clears,
            "tripped_now": float(len(self.tripped())),
        }
        for dim in _DIMENSIONS:
            st = self._dims[dim]
            out[f"burn_fast_{dim}"] = round(st.burn_fast, 6)
            out[f"burn_slow_{dim}"] = round(st.burn_slow, 6)
        return out

    def snapshot(self) -> dict:
        """JSON-shaped status for OP_AUDIT / OP_STATS embedding."""
        out = self.numeric_stats()
        out["tripped"] = self.tripped()
        out["alert_log"] = list(self.alert_log)[-32:]
        return out
