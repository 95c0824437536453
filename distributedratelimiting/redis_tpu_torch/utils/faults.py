"""Deterministic fault injection — the chaos plane's hand on the wire.

The JAX package's ``utils/faults.py``, kept whole (one schedule drives
either package: the same seeds give the same events, and
``DRL_TPU_FAULTS_CONFIG`` is read by both), plus one seam of the port's
own, ``store.flush``.

A seeded :class:`FaultInjector` decides, per *seam occurrence*, whether
to inject one of the classic distributed failure modes: connection
reset, delay/jitter, partial frame, stall, blackhole (request vanishes,
no reply), injected error, clock skew. Seams are named call sites the
runtime consults when — and only when — an injector is installed:

- ``client.connect`` — :meth:`RemoteBucketStore._connect_io` before the
  dial (a fault here is *provably before anything was sent*, the case
  the at-most-once retry contract may replay; docs/DESIGN.md §11).
- ``client.read`` / ``client.write`` — the wrapped client transport
  (per frame read / write).
- ``server.dispatch`` — :meth:`BucketStoreServer._serve_request` before
  the frame is served.
- ``client.retry`` — :meth:`RemoteBucketStore._retry_sleep` before the
  client re-sends a timed-out/failed request (per retry occurrence,
  never on first attempts). A DELAY rule here stretches the client's
  backoff; a RESET/ERROR rule abandons the retry — the storm soak's
  lever for shaping multiplicative retry traffic deterministically
  (see :func:`storm_schedule` for the shared storm model).
- ``store.flush`` — one micro-batch flush of a card store's table
  (:meth:`~..runtime.store._PackedLaunchMixin._flush`, before the launch):
  an ERROR/RESET here fails that flush — every request in it gets the
  error, and the store's flush observer records the failure and fires
  the flight recorder's ``flush_error`` dump (the degraded-mode entry).
- ``t0.sync`` — one tier-0 reconciliation round in
  :meth:`NativeFrontend._t0_sync_loop` (a fault fails the round; rows
  carry, the degraded streak advances).
- ``server.migrate`` — a MIGRATE_PULL/PUSH dispatch on the serving node
  (:meth:`BucketStoreServer._handle_frame_inner`): a fault here fails
  one handoff step — the coordinator's abort path must fire.
- ``server.config`` — an OP_CONFIG prepare/commit/abort/adopt on the
  serving node (:meth:`BucketStoreServer._handle_frame_inner`; a fetch
  does not pass it): a fault fails that step, and a failed prepare makes
  the coordinator abort the mutation everywhere.
- ``cluster.migrate`` — one membership-change step on the coordinator
  (:meth:`ClusterBucketStore._apply_placement`: health gate, pull, each
  push batch, each commit announce): the membership-change seam the
  reshard soak drives.
- ``controller.tick`` — one reconciliation round of the autonomous
  control plane (:meth:`Controller.tick`, runtime/controller.py): a
  fault fails the whole tick loudly (counted, flight-recorder frame,
  no decisions that round) — the controller soak's proof that a flaky
  sensor plane degrades the loop to inaction, never to flapping.
- ``federation.lease`` / ``federation.renew`` / ``federation.reclaim``
  — one WAN control call from a regional federation agent to the home
  ledger (:meth:`RegionFederation._call_home`,
  runtime/federation.py): a fault here IS a partition symptom — the
  region counts it and keeps serving from its current slice, and only
  monotonic lease expiry degrades it to the envelope.
- ``server.federation`` — an OP_FED_LEASE/RENEW/RECLAIM dispatch at
  the home (:meth:`BucketStoreServer._handle_frame_inner`): a fault
  fails one control frame; the ops are post-send-retry-safe, so the
  region's retry dedups.
- ``audit.leak`` — the scalar OP_ACQUIRE decision site
  (:meth:`BucketStoreServer._handle_frame_inner`, asyncio lane): an
  injected fault flips one DENY into a granted reply WITHOUT the store
  debit — a deliberate token leak between the server's reply/witness
  counters. Unlike every other seam this one injects a *correctness*
  bug, not a failure: it exists so the conservation audit soak
  (runtime/audit.py, tests/test_audit.py) can prove the ε-ledger
  detects exactly this class of drift within its detection budget.
  Consulted through the sync :meth:`FaultInjector.decide` (the hot
  path cannot await); any rule kind fires it.
- clock skew (``CLOCK_SKEW`` rules on any seam, read via
  :meth:`FaultInjector.clock_skew` / :class:`SkewedClock`) — the
  federation tests wrap the WALL clocks on both ends with it and pin
  that lease lifetimes never move: TTLs are monotonic-local by
  contract.

**Determinism.** Each seam owns its own ``random.Random`` seeded from
``(seed, seam)`` and its own occurrence counter, and every occurrence
draws exactly ``len(rules)`` uniforms — so the fault schedule is a pure
function of per-seam occurrence index, independent of task interleaving
across seams. :meth:`schedule_preview` replays that pure function
without touching live state; the chaos soak asserts the realized
:attr:`events` log equals the preview (same seed ⇒ same schedule).

**Zero-cost when off.** Production code guards every seam with
``faults._INJECTOR is not None`` — one module-global read. Nothing else
of this module runs unless an injector is installed explicitly
(:func:`install`) or via the ``DRL_TPU_FAULTS_CONFIG`` env var (a JSON
file: ``{"seed": 7, "rules": {"server.dispatch": [{"kind": "delay",
"probability": 0.1, "delay_s": 0.05}]}}``).
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass, field, replace
from typing import Mapping, Sequence

__all__ = [
    "FaultRule", "FaultEvent", "FaultInjector", "FaultInjectedError",
    "BlackholeFault", "SkewedClock", "install", "uninstall",
    "get_injector", "seam", "storm_schedule", "StormEvent",
    "RESET", "DELAY", "PARTIAL_FRAME", "STALL", "BLACKHOLE", "ERROR",
    "CLOCK_SKEW",
]

# Fault kinds. RESET raises ConnectionResetError at the seam; DELAY
# sleeps delay_s (+ uniform jitter_s) then proceeds; PARTIAL_FRAME
# (write seam) emits a prefix of the frame then breaks the connection;
# STALL sleeps delay_s then proceeds (distinguished from DELAY only by
# intent: use it with delays past the request timeout); BLACKHOLE
# swallows the event — a write goes nowhere, a dispatch never replies;
# ERROR raises FaultInjectedError (served as a routable store error);
# CLOCK_SKEW contributes skew_s to SkewedClock readers.
RESET = "reset"
DELAY = "delay"
PARTIAL_FRAME = "partial_frame"
STALL = "stall"
BLACKHOLE = "blackhole"
ERROR = "error"
CLOCK_SKEW = "clock_skew"

_KINDS = frozenset({RESET, DELAY, PARTIAL_FRAME, STALL, BLACKHOLE,
                    ERROR, CLOCK_SKEW})


class FaultInjectedError(RuntimeError):
    """An injected (non-transport) failure — served like a store error."""


class BlackholeFault(Exception):
    """Injected blackhole: the event must produce NO observable effect
    (no reply, no write). Seams catch this specifically."""


@dataclass(frozen=True)
class FaultRule:
    """One injection rule on one seam.

    Eligibility is by per-seam occurrence index: ``after <= i < until``
    (``until=None`` = forever) — occurrence windows, not wall clock,
    keep the schedule deterministic under arbitrary interleaving.
    ``probability`` is the per-occurrence chance within the window;
    ``max_faults`` caps the rule's total firings.
    """

    kind: str
    probability: float = 1.0
    after: int = 0
    until: int | None = None
    delay_s: float = 0.0
    jitter_s: float = 0.0
    skew_s: float = 0.0
    max_faults: int | None = None

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError("probability must be in [0, 1]")


@dataclass(frozen=True)
class FaultEvent:
    """One realized injection — the unit of the reproducible schedule."""

    seam: str
    occurrence: int
    kind: str
    delay_s: float = 0.0


@dataclass
class _SeamState:
    rng: random.Random
    count: int = 0
    fired: dict[int, int] = field(default_factory=dict)  # rule idx → fires


class FaultInjector:
    """Seeded, schedule-deterministic fault source (module docstring)."""

    def __init__(self, seed: int = 0,
                 rules: "Mapping[str, Sequence[FaultRule]] | None" = None
                 ) -> None:
        self.seed = seed
        self._rules: dict[str, tuple[FaultRule, ...]] = {
            seam: tuple(rs) for seam, rs in (rules or {}).items()}
        self._seams: dict[str, _SeamState] = {}
        #: Realized injections, in per-seam occurrence order.
        self.events: list[FaultEvent] = []

    @staticmethod
    def _seam_rng(seed: int, seam: str) -> random.Random:
        return random.Random(f"{seed}/{seam}")

    def _seam(self, seam: str) -> _SeamState:
        st = self._seams.get(seam)
        if st is None:
            st = self._seams[seam] = _SeamState(
                self._seam_rng(self.seed, seam))
        return st

    @staticmethod
    def _decide_one(rules: "tuple[FaultRule, ...]", st: _SeamState
                    ) -> "tuple[int, FaultRule, float] | None":
        """One occurrence's decision: draws exactly ``len(rules)``
        uniforms (+1 for jitter on a firing delay rule), so the rng
        stream position is a pure function of the occurrence index."""
        i = st.count
        st.count += 1
        hit: "tuple[int, FaultRule, float] | None" = None
        for r_idx, rule in enumerate(rules):
            u = st.rng.random()
            if hit is not None:
                continue  # stream length stays fixed; first hit wins
            if i < rule.after or (rule.until is not None
                                  and i >= rule.until):
                continue
            if (rule.max_faults is not None
                    and st.fired.get(r_idx, 0) >= rule.max_faults):
                continue
            if u < rule.probability:
                delay = rule.delay_s
                if rule.jitter_s:
                    delay += st.rng.random() * rule.jitter_s
                hit = (r_idx, rule, delay)
        return hit

    def decide(self, seam: str) -> "FaultEvent | None":
        """Advance ``seam`` by one occurrence; the injected event, if
        any, is appended to :attr:`events` and returned."""
        rules = self._rules.get(seam)
        if not rules:
            return None
        st = self._seam(seam)
        occurrence = st.count
        hit = self._decide_one(rules, st)
        if hit is None:
            return None
        r_idx, rule, delay = hit
        st.fired[r_idx] = st.fired.get(r_idx, 0) + 1
        ev = FaultEvent(seam, occurrence, rule.kind, delay)
        self.events.append(ev)
        return ev

    def occurrence_count(self, seam: str) -> int:
        """How many occurrences ``seam`` has seen (for comparing the
        realized :attr:`events` against :meth:`schedule_preview`)."""
        st = self._seams.get(seam)
        return 0 if st is None else st.count

    def schedule_preview(self, seam: str, n: int) -> list["FaultEvent"]:
        """The first ``n`` occurrences' decisions for ``seam``, computed
        on a FRESH rng — live state untouched. Equal to what a live run
        realizes (the determinism contract the soak asserts)."""
        rules = self._rules.get(seam, ())
        st = _SeamState(self._seam_rng(self.seed, seam))
        out: list[FaultEvent] = []
        for _ in range(n):
            occurrence = st.count
            hit = self._decide_one(tuple(rules), st)
            if hit is not None:
                r_idx, rule, delay = hit
                st.fired[r_idx] = st.fired.get(r_idx, 0) + 1
                out.append(FaultEvent(seam, occurrence, rule.kind, delay))
        return out

    # -- seam application ---------------------------------------------------
    async def on_event(self, seam: str) -> None:
        """Async seam hook: sleep for DELAY/STALL, raise for
        RESET/ERROR/BLACKHOLE, no-op otherwise."""
        ev = self.decide(seam)
        if ev is None:
            return
        import asyncio

        if ev.kind in (DELAY, STALL):
            await asyncio.sleep(ev.delay_s)
        elif ev.kind == RESET:
            raise ConnectionResetError(
                f"injected connection reset ({seam}#{ev.occurrence})")
        elif ev.kind == ERROR:
            raise FaultInjectedError(
                f"injected fault ({seam}#{ev.occurrence})")
        elif ev.kind == BLACKHOLE:
            raise BlackholeFault(seam)
        # PARTIAL_FRAME / CLOCK_SKEW are transport/clock-specific; on a
        # generic seam they are recorded but act as no-ops.

    def wrap_connection(self, reader, writer):
        """Client-transport seam: wrap an asyncio stream pair so every
        frame read/write consults ``client.read`` / ``client.write``."""
        return _FaultyReader(reader, self), _FaultyWriter(writer, self)

    def clock_skew(self, seam: str = "clock") -> float:
        """Total skew contributed by the seam's CLOCK_SKEW rules (static
        — derived from the rule set, not the occurrence stream)."""
        return sum(r.skew_s for r in self._rules.get(seam, ())
                   if r.kind == CLOCK_SKEW)

    def with_seed(self, seed: int) -> "FaultInjector":
        """A fresh injector with the same rules under another seed."""
        return FaultInjector(seed, {s: tuple(replace(r) for r in rs)
                                    for s, rs in self._rules.items()})


class _FaultyReader:
    """StreamReader proxy injecting on each ``readexactly`` (the only
    read the wire layer performs)."""

    def __init__(self, inner, injector: FaultInjector) -> None:
        self._inner = inner
        self._inj = injector

    async def readexactly(self, n: int) -> bytes:
        import asyncio

        ev = self._inj.decide("client.read")
        if ev is not None:
            if ev.kind in (DELAY, STALL):
                await asyncio.sleep(ev.delay_s)
            elif ev.kind == RESET:
                raise ConnectionResetError(
                    f"injected read reset (#{ev.occurrence})")
            elif ev.kind == BLACKHOLE:
                # Nothing ever arrives: hold the read until the caller's
                # timeout (or cancellation on teardown) fires.
                await asyncio.sleep(ev.delay_s or 3600.0)
                raise ConnectionResetError(
                    f"injected read blackhole (#{ev.occurrence})")
        return await self._inner.readexactly(n)

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _FaultyWriter:
    """StreamWriter proxy injecting on each ``write``. ``transport``,
    ``drain``, ``close`` … forward to the real writer."""

    def __init__(self, inner, injector: FaultInjector) -> None:
        self._inner = inner
        self._inj = injector
        self._broken = False

    def write(self, data: bytes) -> None:
        if self._broken:
            raise ConnectionResetError("connection broken by injected "
                                       "partial frame")
        ev = self._inj.decide("client.write")
        if ev is None:
            self._inner.write(data)
            return
        if ev.kind == RESET:
            self._inner.close()
            raise ConnectionResetError(
                f"injected write reset (#{ev.occurrence})")
        if ev.kind == PARTIAL_FRAME:
            # A torn frame: the peer sees a prefix, then EOF — its frame
            # reader must treat the truncation as a clean drop, never a
            # misparse.
            self._inner.write(data[: max(1, len(data) // 2)])
            self._inner.close()
            self._broken = True
            raise ConnectionResetError(
                f"injected partial frame (#{ev.occurrence})")
        if ev.kind == BLACKHOLE:
            return  # swallowed: sent-nowhere, the reply never comes
        self._inner.write(data)  # DELAY et al. are read-side concerns

    def __getattr__(self, name):
        return getattr(self._inner, name)


class SkewedClock:
    """A :class:`~..runtime.clock.Clock` running ``skew_s`` ahead of its
    base — the clock-skew fault. Wrapping a CLIENT's clock must change
    nothing (the store is the time authority, invariant 1); wrapping a
    node's store clock models divergent per-node time."""

    def __init__(self, base, skew_s: float) -> None:
        self._base = base
        self.skew_s = skew_s

    def now(self) -> float:
        return self._base.now() + self.skew_s

    def __getattr__(self, name):
        return getattr(self._base, name)


# -- process-global installation (the seams' gate) --------------------------

_INJECTOR: "FaultInjector | None" = None


def get_injector() -> "FaultInjector | None":
    return _INJECTOR


def install(injector: "FaultInjector | None"
            ) -> "FaultInjector | None":
    """Install (or, with ``None``, clear) the process-global injector;
    returns the previous one so tests can restore it."""
    global _INJECTOR
    previous, _INJECTOR = _INJECTOR, injector
    return previous


def uninstall() -> None:
    install(None)


async def seam(name: str) -> None:
    """Consult the installed injector at a named seam — the cold-path
    convenience (control-plane call sites); hot paths keep the inline
    ``faults._INJECTOR is not None`` guard instead of paying a call."""
    if _INJECTOR is not None:
        await _INJECTOR.on_event(name)


# -- the shared retry-storm model (docs/DESIGN.md §24) -----------------------

@dataclass(frozen=True)
class StormEvent:
    """One client attempt in a seeded retry storm: the unit the storm
    soak (tests/test_storm.py) and future chaos tests replay. ``rid``
    is the retry-STABLE request identity (all attempts of one logical
    request share it — the reservation-lane fingerprint);
    ``deadline_s`` is the remaining client budget at send time, which
    DECAYS across retries: the doomed-work gate's input."""

    rid: str
    tenant: str
    priority: int
    attempt: int       # 0 = first attempt, k = k-th retry
    t_s: float         # send offset from storm start, seconds
    deadline_s: float  # remaining end-to-end budget at send time
    cost: int


def storm_schedule(seed: int, *, n_requests: int = 200,
                   tenants: "Sequence[str]" = ("tenant-a", "tenant-b"),
                   priorities: "Sequence[int]" = (0, 0, 1, 2),
                   client_timeout_s: float = 0.05,
                   deadline_s: float = 0.2,
                   max_retries: int = 3,
                   backoff_mult: float = 2.0,
                   arrival_span_s: float = 1.0,
                   cost_range: "tuple[int, int]" = (1, 4),
                   ) -> list[StormEvent]:
    """The seeded timeout-then-retry schedule: ``n_requests`` logical
    requests arrive uniformly over ``arrival_span_s``; each attempt
    that the client gives up on (its ``client_timeout_s`` elapses,
    multiplied by ``backoff_mult`` per retry) spawns the next attempt
    under the SAME rid with the remaining deadline budget decayed by
    the wait — the multiplicative-retry regime of "When Two is Worse
    Than One". Attempts whose budget is already spent are never sent
    (the client is dead by then). Pure function of ``seed`` + kwargs:
    same seed ⇒ byte-for-byte the same event list, the chaos-test
    determinism contract. Returned sorted by send time."""
    rng = random.Random(f"{seed}/storm")
    events: list[StormEvent] = []
    for i in range(n_requests):
        t0 = rng.random() * arrival_span_s
        tenant = tenants[i % len(tenants)]
        priority = priorities[i % len(priorities)]
        cost = rng.randint(*cost_range)
        rid = f"storm-{seed}-{i}"
        t, timeout = t0, client_timeout_s
        for attempt in range(max_retries + 1):
            remaining = deadline_s - (t - t0)
            if remaining <= 0.0:
                break
            events.append(StormEvent(rid, tenant, priority, attempt,
                                     round(t, 9), round(remaining, 9),
                                     cost))
            t += timeout
            timeout *= backoff_mult
    events.sort(key=lambda e: (e.t_s, e.rid, e.attempt))
    return events


def _maybe_install_from_env() -> None:
    path = os.environ.get("DRL_TPU_FAULTS_CONFIG")
    if not path:
        return
    with open(path, encoding="utf-8") as f:
        cfg = json.load(f)
    rules = {seam: tuple(FaultRule(**r) for r in rs)
             for seam, rs in cfg.get("rules", {}).items()}
    install(FaultInjector(int(cfg.get("seed", 0)), rules))


_maybe_install_from_env()
