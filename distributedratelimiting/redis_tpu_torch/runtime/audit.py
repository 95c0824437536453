"""Conservation audit plane — the continuous ε-ledger (DESIGN.md §22).

The JAX package's ``runtime/audit.py`` on the port's server. The
federation cover identity reads the home's store-attached ledger once it
is active (a server that is no home reads nothing). The envelope ε
reads the placement handoffs' envelope decisions alone, as JAX's does: a
drain window's envelope decisions are reported by the shutdown's summary,
not counted here.
The tier-0 / per-shard ε reads the native front-end when it serves.

The framework's correctness story is a stack of documented ε terms:
the tier-0 cache may over-admit ``overadmit_epsilon(...)`` per key
between syncs, a drain/handoff window serves from a bounded fair-share
envelope, the reservation ledger converts estimate error into refunds
or debts, and a federation home that loses a region charges the
conservative worst case. Every one of those bounds lives in a
different subsystem — and "When Two is Worse Than One" (PAPERS.md) is
what happens when the composition drifts and nobody is watching the
sum. This module watches the sum.

:class:`ConservationAuditor` folds the monotonic counter plane into
explicit conservation identities once per tick:

* **reply/witness** — tokens the server TOLD clients it granted vs
  tokens the store ACTUALLY debited (two adjacent counters at the
  scalar decision site). Any positive residue is a token leak — there
  is no ε term that excuses it.
* **reservation** — the ledger's flow identity (reservations.py
  ``conservation()``): reserved + restored-in + extra-debited ==
  settled + refunded + exported-out + dropped + outstanding, exact to
  float noise per node.
* **federation** — home-side charges (+ conservative pending charges
  for expired-unsettled leases) must cover Σ regional reported
  admissions (federation.py ``conservation()``). A NEGATIVE residue
  is global over-admission; positive residue is the documented
  conservative direction and is tolerated.

Everything is DELTA-based via :class:`~..utils.metrics.CounterDeltas`
(the auditor is one more registered consumer of the shared counter
plane — never ``reset=True``), so it composes with scrapers and the
controller without coordination. Realized over-admission accumulates
into ``overadmitted_tokens`` — the SLI numerator the
:class:`~..utils.slo.BurnRateWatchdog` burns against — and ε-budget
utilization per source renders as
``drl_epsilon_budget_used_ratio{source=...}``.

On a conservation breach or a watchdog trip the auditor assembles ONE
black-box incident bundle per episode (hysteresis de-dups the case
where the leak trips both the ledger and the SLO): correlated flight
frames (``kind in ("audit", "slo", "controller")``), the kept traces
matching histogram exemplar trace-ids, the controller's recent action
log, and the raw witnessing counter deltas — a single JSON artifact a
human can read AFTER the incident, which is the whole point of a
black box. Served via ``OP_AUDIT`` / ``GET /audit``.

Determinism contract: ticks are counted, not clocked (the background
task merely calls :meth:`tick`; seeded soaks drive it directly), and
bundles carry no wall-clock-derived identity — same seed, same
schedule, bit for bit.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque

from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    CounterDeltas,
    LatencyHistogram,
)
from distributedratelimiting.redis_tpu_torch.utils.slo import (
    BurnRateWatchdog,
    SLOConfig,
)

__all__ = ["AuditConfig", "ConservationAuditor"]

#: ε sources the utilization gauges are labelled with, fixed order.
EPSILON_SOURCES = ("tier0", "shard", "envelope", "federation")


@dataclasses.dataclass(frozen=True)
class AuditConfig:
    """Knobs of one conservation auditor (docs/OPERATIONS.md §18)."""

    #: Background tick cadence, seconds. Alert LOGIC never reads the
    #: clock — this only paces the asyncio task.
    tick_s: float = 0.5
    #: Absolute slack per identity before a residue reads as a breach
    #: (float noise across f64 token sums; scaled by flow volume).
    tolerance_tokens: float = 1e-6
    #: Tier-0/shard ε budget as a fraction of locally granted tokens —
    #: the audit-side mirror of the headroom fraction the sync pump
    #: hands the cache (utilization 1.0 = drift consumed the whole
    #: documented allowance).
    epsilon_fraction: float = 0.05
    #: Bounded black-box storage: newest ``bundle_cap`` bundles held.
    bundle_cap: int = 8
    #: Per-bundle windows over the correlated evidence streams.
    frame_window: int = 64
    action_window: int = 32
    trace_window: int = 16
    #: Breach hysteresis: this many consecutive clean ticks end an
    #: episode (a flapping identity still yields one bundle).
    clear_ticks: int = 2
    #: The embedded burn-rate watchdog's knobs.
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)


def _bad_latency_samples(hist: "LatencyHistogram | None",
                         slo_s: float) -> tuple[float, float]:
    """(total, above-SLO) CUMULATIVE sample counts from a latency
    histogram — bucket-resolution (a bucket straddling the SLO counts
    as good: the conservative-by-one-bucket direction), delta'd by the
    watchdog's ring, never reset."""
    if hist is None or not hist.total:
        return 0.0, 0.0
    good = 0
    for count, upper in zip(hist.counts,
                            LatencyHistogram.bucket_upper_bounds()):
        if upper <= slo_s:
            good += count
    return float(hist.total), float(hist.total - good)


class ConservationAuditor:
    """Continuous ε-ledger + SLO watchdog over one server's counter
    plane. Attached by :class:`~.server.BucketStoreServer` (the
    ``audit=`` constructor knob); drives itself from a background task
    in wall-clock deployments and is driven tick-by-tick in seeded
    soaks."""

    def __init__(self, server, cfg: "AuditConfig | None" = None) -> None:
        self.server = server
        self.cfg = cfg or AuditConfig()
        self.ticks = 0
        self.tick_failures = 0
        #: Total breach OBSERVATIONS (one per violated identity per
        #: tick) — the ``drl_audit_breaches`` counter the controller
        #: scrapes.
        self.breaches = 0
        #: Cumulative realized over-admission in tokens: leak residues
        #: + tier-0 drift + federation under-charge growth. The
        #: over-admission SLI numerator.
        self.overadmitted_tokens = 0.0
        self.bundles_assembled = 0
        self.bundles: deque[dict] = deque(maxlen=self.cfg.bundle_cap)
        #: Current ε-budget utilization per source (the
        #: ``drl_epsilon_budget_used_ratio`` gauge values).
        self.epsilon_used = {s: 0.0 for s in EPSILON_SOURCES}
        #: Last tick's residues per identity (0.0 = conserved).
        self.residues: dict[str, float] = {}
        self.watchdog = BurnRateWatchdog(
            self.cfg.slo, flight_recorder=server.flight_recorder,
            on_trip=self._on_slo_trip)
        self._deltas = CounterDeltas()
        # Anchor the delta windows NOW (the counters are zero at server
        # construction): CounterDeltas treats a key's first observation
        # as the baseline, so without this a leak that happens entirely
        # before the first tick would be swallowed into the anchor.
        self._deltas.delta("replied", server.audit_replied_tokens)
        self._deltas.delta("witnessed", server.audit_witnessed_tokens)
        self._deltas.delta("t0_overadmit", 0.0)
        self._fed_under_prev = 0.0
        self._breach_active = False
        self._breach_cold = 0
        self._episode_active = False
        self._pending_reasons: list[str] = []
        self._pending_witness: dict = {}
        self._task = None

    # -- lifecycle -----------------------------------------------------------
    async def run(self) -> None:
        """Background pacer: one :meth:`tick` per ``tick_s``. Failures
        count (``tick_failures``) instead of killing the task — a
        broken auditor must never take serving down with it."""
        import asyncio

        while True:
            await asyncio.sleep(self.cfg.tick_s)
            try:
                self.tick()
            except asyncio.CancelledError:  # pragma: no cover
                raise
            except Exception:
                self.tick_failures += 1

    # -- the ledger tick -----------------------------------------------------
    def tick(self) -> dict:
        """Fold the counter plane into the conservation identities,
        update ε gauges, feed the watchdog, and (on a NEW episode)
        assemble the incident bundle. Returns this tick's summary."""
        self.ticks += 1
        srv = self.server
        self._pending_reasons = []
        breaches: list[str] = []
        residues: dict[str, float] = {}
        witness: dict[str, float] = {}

        # 1. reply/witness identity (the scalar decision site).
        d_rep = self._deltas.delta("replied", srv.audit_replied_tokens)
        d_wit = self._deltas.delta("witnessed", srv.audit_witnessed_tokens)
        leak = d_rep - d_wit
        residues["reply_witness"] = leak
        witness["replied_tokens_delta"] = d_rep
        witness["witnessed_tokens_delta"] = d_wit
        if leak > self.cfg.tolerance_tokens:
            self.overadmitted_tokens += leak
            breaches.append("reply_witness")

        # 2. reservation flow identity.
        led = srv.reservations
        if led is not None and led.active:
            rc = led.conservation()
            res = rc["residue"]
            residues["reservation"] = res
            # Scale tolerance with flow volume: 1e9 tokens of exact f64
            # arithmetic still accumulates representation noise.
            tol = self.cfg.tolerance_tokens * max(1.0, rc["inflow"])
            if abs(res) > tol:
                breaches.append("reservation")
                witness["reservation_conservation"] = rc

        # 3. federation cover identity (negative residue = global
        # over-admission; positive = documented conservative slack).
        fed = srv.federation
        if fed is not None and fed.active:
            fc = fed.conservation()
            res = fc["residue"]
            residues["federation"] = res
            tol = self.cfg.tolerance_tokens * max(1.0, fc["accounted"])
            if res < -tol:
                breaches.append("federation")
                witness["federation_conservation"] = fc
            under = max(0.0, -res)
            self.overadmitted_tokens += max(
                0.0, under - self._fed_under_prev)
            self._fed_under_prev = under
            budget = fc.get("epsilon_budget", 0.0)
            self.epsilon_used["federation"] = (
                min(1.0, fc.get("epsilon_used", 0.0) / budget)
                if budget > 0 else 0.0)

        # 4. tier-0 / per-shard ε utilization (the native front-end's C
        # counters, witnessed slice-side through fe_t0_eps).
        native = srv._native
        admitted = srv.audit_witnessed_tokens
        if native is not None:
            t0 = native.tier0_stats() or {}
            grant = float(t0.get("grant_tokens", 0.0))
            over = float(t0.get("overadmit_total", 0.0))
            admitted += grant
            bulk = native.bulk_stats() or {}
            admitted += float(bulk.get("permits_local", 0.0))
            self.overadmitted_tokens += self._deltas.delta(
                "t0_overadmit", over)
            budget = self.cfg.epsilon_fraction * grant
            self.epsilon_used["tier0"] = (min(1.0, over / budget)
                                          if budget > 0 else 0.0)
            slices = native.t0_eps_tokens()
            if slices and sum(slices) > 0:
                # The hottest slice's share of the local grants: the
                # per-shard slice bound is consumed fastest by the hottest
                # slice (1/n_shards balanced, 1.0 one slice takes all).
                self.epsilon_used["shard"] = max(slices) / sum(slices)
        # 5. envelope ε: the share of admissions served from placement
        # handoffs' fair-share envelopes (their envelope_decisions), as
        # JAX's auditor counts it; a drain window's decisions are not in
        # it. A share-of-traffic proxy, since the envelopes' token bounds
        # are enforced at grant time.
        requests = max(1.0, float(self._requests_served()))
        env = 0.0
        if srv.placement.active:
            env += float(srv.placement.stats().get(
                "envelope_decisions", 0.0))
        self.epsilon_used["envelope"] = min(1.0, env / requests)

        # -- breach bookkeeping / episode hysteresis --
        self.residues = residues
        if breaches:
            self.breaches += len(breaches)
            self._breach_active = True
            self._breach_cold = 0
            fr = srv.flight_recorder
            if fr is not None:
                fr.record("audit", event="conservation_breach",
                          tick=self.ticks, sources=list(breaches),
                          residues={k: round(v, 9)
                                    for k, v in residues.items()},
                          witness=witness)
            self._pending_reasons.extend(
                f"conservation:{b}" for b in breaches)
        elif self._breach_active:
            self._breach_cold += 1
            if self._breach_cold >= self.cfg.clear_ticks:
                self._breach_active = False

        # -- SLO watchdog --
        hist = srv.serving_latency
        slo_s = self.cfg.slo.latency_slo_s
        lat_total, lat_bad = _bad_latency_samples(
            hist, slo_s if slo_s is not None else float("inf"))
        sample = {
            "requests": float(self._requests_served()),
            "shed": float(srv.requests_shed),
            "admitted_tokens": float(admitted),
            "overadmitted_tokens": self.overadmitted_tokens,
            "latency_total": lat_total,
            "latency_bad": lat_bad,
        }
        alerts = self.watchdog.tick(sample)

        # -- one bundle per episode --
        self._pending_witness = witness
        if self._pending_reasons and not self._episode_active:
            self._assemble_bundle(self._pending_reasons, witness)
        self._episode_active = (self._breach_active
                                or bool(self.watchdog.tripped()))
        return {"tick": self.ticks, "breaches": breaches,
                "alerts": alerts, "residues": residues}

    def _requests_served(self) -> int:
        srv = self.server
        if srv._native is not None:
            return int(srv._native.counts()[0])
        return srv.requests_served

    def _on_slo_trip(self, dim: str, alert: dict) -> None:
        # Queued, not assembled inline: the episode gate at the end of
        # tick() de-dups a leak that trips both the ledger AND the SLO
        # into the single bundle the black-box contract promises.
        self._pending_reasons.append(f"slo:{dim}")

    # -- black-box incident bundles ------------------------------------------
    def _exemplar_trace_ids(self) -> list[str]:
        """Trace ids pinned by the latency histograms' exemplars — the
        correlation keys from the metrics plane into the kept traces."""
        srv = self.server
        hists: list = [srv.serving_latency, srv.reply_latency]
        metrics = getattr(srv.store, "metrics", None)
        hists.append(getattr(metrics, "queue_latency", None))
        hists.append(getattr(metrics, "flush_latency", None))
        if srv._native is not None:
            hists.extend(srv._native.stage_histograms().values())
        ids: list[str] = []
        for h in hists:
            ex = getattr(h, "exemplars", None)
            if ex:
                ids.extend(tid for tid, _, _ in ex.values())
        # De-dup preserving order (deterministic under a fixed schedule).
        return list(dict.fromkeys(ids))

    def _assemble_bundle(self, reasons: list[str], witness: dict) -> dict:
        srv = self.server
        fr = srv.flight_recorder
        frames = (fr.frames(kind=("audit", "slo", "controller"))
                  [-self.cfg.frame_window:] if fr is not None else [])
        ids = self._exemplar_trace_ids()
        kept = {t.get("trace_id"): t for t in srv.tracer.traces()}
        traces = [kept[i] for i in ids if i in kept][:self.cfg.trace_window]
        actions = (list(srv.controller.actions)[-self.cfg.action_window:]
                   if srv.controller is not None else [])
        bundle = {
            # Counter-derived id: no wall clock, no randomness — the
            # seeded-soak determinism contract.
            "id": f"bundle-{self.bundles_assembled:04d}",
            "tick": self.ticks,
            "reasons": list(reasons),
            "residues": {k: round(v, 9) for k, v in self.residues.items()},
            "witness_deltas": witness,
            "epsilon_budget_used_ratio": dict(self.epsilon_used),
            "overadmitted_tokens": self.overadmitted_tokens,
            "slo": self.watchdog.snapshot(),
            "flight_frames": frames,
            "trace_ids": ids[:self.cfg.trace_window],
            "traces": traces,
            "controller_actions": actions,
        }
        self.bundles.append(bundle)
        self.bundles_assembled += 1
        if fr is not None:
            fr.record("audit", event="incident_bundle",
                      bundle_id=bundle["id"], reasons=list(reasons))
            # The on-disk black box, when the recorder has a home for
            # dumps: one JSON artifact per bundle, newest-id-named so a
            # post-mortem can ls its way to the incident.
            if fr.dump_dir:
                try:
                    path = os.path.join(fr.dump_dir,
                                        f"{bundle['id']}.json")
                    with open(path, "w", encoding="utf-8") as f:
                        json.dump(bundle, f, default=repr)
                except OSError:  # pragma: no cover — best-effort disk
                    pass
        return bundle

    # -- exposition ----------------------------------------------------------
    def numeric_stats(self) -> dict:
        """Flat numeric dict for ``register_numeric_dict`` — the
        ``drl_audit_*`` families (``overadmitted_tokens`` here is the
        ``drl_audit_overadmitted_tokens`` series SLO_SERIES pins)."""
        out = {
            "ticks": self.ticks,
            "tick_failures": self.tick_failures,
            "breaches": self.breaches,
            "overadmitted_tokens": self.overadmitted_tokens,
            "bundles_assembled": self.bundles_assembled,
            "bundles_held": float(len(self.bundles)),
            "episode_active": float(self._episode_active),
        }
        for source, ratio in self.epsilon_used.items():
            out[f"epsilon_used_{source}"] = round(ratio, 6)
        return out

    def epsilon_series(self) -> list[tuple[dict, float]]:
        """Labelled samples for ``drl_epsilon_budget_used_ratio``."""
        return [({"source": s}, self.epsilon_used[s])
                for s in EPSILON_SOURCES]

    def snapshot(self) -> dict:
        """JSON-shaped status for OP_AUDIT / OP_STATS / GET /audit."""
        out = self.numeric_stats()
        out["residues"] = {k: round(v, 9)
                           for k, v in self.residues.items()}
        out["epsilon_budget_used_ratio"] = dict(self.epsilon_used)
        out["slo"] = self.watchdog.snapshot()
        out["bundle_ids"] = [b["id"] for b in self.bundles]
        return out
