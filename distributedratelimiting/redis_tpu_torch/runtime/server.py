"""The store server — the framework's "Redis process", on the GPU.

The core of the JAX package's ``runtime/server.py``:
:class:`BucketStoreServer` fronts a :class:`~.store.BucketStore` (typically
the card-resident :class:`~.store.DeviceBucketStore`) with an asyncio TCP
listener speaking the :mod:`~.wire` protocol, byte for byte as the JAX
server does — a client of either package talks to it. Every concurrent
request from every connection funnels into the store's micro-batcher, so N
clients × M in-flight requests coalesce into single kernel launches. Each
request is served as its own task and answers in completion order (the seq
id matches replies to requests); bulk continuation chunks chain per
connection so duplicate keys across a chunk boundary decide in chunk order.

Served: ``OP_ACQUIRE``, ``OP_WINDOW``, ``OP_FWINDOW``, ``OP_SEMA``
(semaphore acquire, probe and release), ``OP_ACQUIRE_H`` (two-level tenant
→ key admission), ``OP_ACQUIRE_MANY`` (bucket, window, fixed-window and
hierarchical-bucket kinds; keys resolve straight from the frame's bytes
through ``wire.KeyBlob``), ``OP_RESERVE`` / ``OP_SETTLE`` (the
estimate-reserve-settle lane, through the store's one
:class:`~.reservations.ReservationLedger`), ``OP_PEEK``, ``OP_SYNC``,
``OP_PING``, ``OP_SAVE`` (a full file, or with ``snapshot_incremental`` a
v4 delta against the previous save; either stamped with the adopted
placement epoch), ``OP_STATS``, the placement and migration control ops
(``OP_PLACEMENT``, ``OP_PLACEMENT_ANNOUNCE``, ``OP_MIGRATE_PULL``,
``OP_MIGRATE_PUSH``; :mod:`~.placement`) and the ``OP_HELLO`` auth
handshake, with the trace, deadline and attempt tails (deadline-expired
work is shed unexecuted). Granted hierarchical costs and settled actuals
feed a per-tenant :class:`~.admission.TokenVelocity` (``OP_STATS``
``token_velocity``).

The observability and overload plane (``observability=True``, the
default): a space-saving heavy-hitter sketch fed by every admission lane,
weighted in tokens (``OP_STATS`` ``hot_keys``); a flight recorder fed one
frame per store flush, reservation event, audit breach and SLO alert, which
dumps itself to JSONL on a flush failure (the store's degraded-mode entry)
or on request; the OpenMetrics registry behind ``OP_METRICS`` and the HTTP
listener (``metrics_port``: ``/metrics``, ``/flight``, ``/audit``,
``/traces``); the tracer's Chrome-trace export behind ``OP_TRACES``; the
conservation auditor and its burn-rate watchdog behind ``OP_AUDIT``
(:mod:`~.audit`). Two overload gates, disarmed until their setters arm
them: the doomed-work gate denies deadline-stamped work that the current
p99 serving latency says cannot finish in its budget, the retry-shed gate
denies retry-stamped frames; ``overflow_pool`` redirects an interactive
reserve whose estimate the tenant's balance cannot cover in its deadline
to the named pool. The chaos seams of :mod:`..utils.faults` sit at
dispatch (``server.dispatch``) and at the scalar decision site
(``audit.leak``). The plane's per-request hooks are host bookkeeping: none
touches the card; a scrape may read it.

The native front-end (``native_frontend=True``, :mod:`~.native_frontend`):
the C++ loop of ``native/frontend.cc`` owns the sockets — epoll or io_uring
shards on one port — batches the per-request ACQUIRE / WINDOW / FWINDOW /
SEMA frames and decides well-formed ACQUIRE_MANY frames in C, and hands
Python one store call per flush; every other frame reaches
:meth:`BucketStoreServer.handle_frame_body` through its passthrough lane.
``native_tier0`` adds the tier-0 admission cache, reconciled through the
store's ``debit_many``. The library is built from the checkout at first
use; when it cannot build, ``start()`` raises — there is no fallback to the
asyncio listener.

The placement gate (:class:`~.placement.NodePlacementState`, dormant until
a coordinator announces a map) checks every keyed admission, PEEK and SYNC
frame, each bulk frame, and the tenant of every two-level, reserve and
settle frame: a key another node owns answers the routable ``placement
moved`` error, a key parked mid-handoff serves from the handoff's
fair-share envelope (or answers the transient handoff deferral where there
is no envelope value). The live-config gate (:class:`~.liveconfig.
ConfigState`, dormant until a rule commits through ``OP_CONFIG``) runs
before it, in the JAX server's order: a keyed ACQUIRE, WINDOW, FWINDOW or
PEEK frame, a bulk frame, or either level of a two-level, two-level bulk
or reserve frame that carries a retired config answers the routable
``config moved`` error, the store untouched.

Drain-and-handoff shutdown (:meth:`BucketStoreServer.shutdown`, the JAX
server's, step for step): the whole store is exported off the loop, the
ledger's holds and debts ride along, and the drain gate goes on before the
source debit (``placement.debit_source(..., keep_envelope=True)``: one
``debit_packed`` launch a config on a card store). From then until the
server closes, every admission lane after the config gate (scalar, bulk,
two-level, two-level bulk, reserve, and the native bulk lane) serves from
the bounded fair-share envelope the export withheld, any other gated op
answers the handoff deferral, and ``OP_SETTLE`` relays to the successor.
The export lands on the successor in ``MIGRATE_PUSH`` chunks, the committed
config rules follow as an ``adopt``, and the server lingers for the rest of
the window. Without a successor (or when the drain fails) the state goes to
the final checkpoint. The console's ``--drain-to HOST:PORT`` drains on
SIGTERM.

Every op of the wire is served, the federation lane too: a home's
``OP_FED_LEASE`` / ``OP_FED_RENEW`` / ``OP_FED_RECLAIM`` reach the
store-attached :class:`~.federation.FederationLedger` (created by the first
frame, or configured before ``start`` with ``store.federation_ledger(...)``),
and a region's :class:`~.federation.RegionFederation` assigned to
``federation_agent`` rides ``OP_STATS`` and the
``drl_federation_region_*`` families.

Run it with ``python -m distributedratelimiting.redis_tpu_torch.runtime.server``
(a ``DeviceBucketStore`` on ``cuda`` unless ``--device cpu`` is given, a
``MeshBucketStore`` over every visible card with ``--backend mesh`` and
``--sync-cadence batch|launch``, or the serial ``InProcessBucketStore`` with
``--backend inprocess``). A mesh server's ``OP_STATS`` carries each sharded
tier's counters under ``store.tiers``.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import time

import numpy as np

from distributedratelimiting.redis_tpu_torch.runtime import (
    admission,
    liveconfig,
    placement,
    reservations,
    wire,
)
from distributedratelimiting.redis_tpu_torch.runtime.audit import (
    AuditConfig,
    ConservationAuditor,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils import faults, log, tracing
from distributedratelimiting.redis_tpu_torch.utils.flight_recorder import (
    FlightRecorder,
)
from distributedratelimiting.redis_tpu_torch.utils.heavy_hitters import (
    HeavyHitters,
)
from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LatencyHistogram,
    MetricsRegistry,
)

__all__ = ["BucketStoreServer", "main"]

#: Scalar keyed admission ops fed to the heavy-hitter sketch. A module
#: constant: an inline tuple would rebuild from four global lookups on
#: every request.
_HOT_KEYED_OPS = frozenset(
    (wire.OP_ACQUIRE, wire.OP_WINDOW, wire.OP_FWINDOW, wire.OP_SEMA))
#: Keyed ops the placement gate checks once a map is adopted. Admission
#: ops on a parked (mid-handoff) key serve from the handoff's fair-share
#: envelope; everything else gated answers the routable moved error.
_PLACEMENT_GATED_OPS = frozenset(
    (wire.OP_ACQUIRE, wire.OP_WINDOW, wire.OP_FWINDOW, wire.OP_SEMA,
     wire.OP_PEEK, wire.OP_SYNC))

#: The deferral a draining server answers for a gated op the envelope has
#: no value for (PEEK, SYNC, SEMA, a release), byte for byte the JAX
#: server's.
_DRAINING = (f"{placement.HANDOFF_DEFERRAL_PREFIX}: server is draining to "
             "its successor; retry shortly")


def _recover_seq(body: bytes) -> int:
    """Best-effort seq extraction from a frame body ([version][u32 seq]…)
    so even a malformed frame gets a *routable* error reply — a reply with
    the wrong seq would strand the client's future for its whole timeout."""
    return int.from_bytes(body[1:5], "little") if len(body) >= 5 else 0


class BucketStoreServer:
    """Serve a :class:`BucketStore` over TCP.

    Usage::

        server = BucketStoreServer(DeviceBucketStore(), host="0.0.0.0", port=6380)
        await server.start()
        ...
        await server.aclose()
    """

    def __init__(self, store: BucketStore, *, host: str = "127.0.0.1",
                 port: int = 0, snapshot_path: str | None = None,
                 auth_token: str | None = None,
                 native_frontend: bool = False,
                 native_max_batch: int = 4096,
                 native_deadline_us: int = 300,
                 native_tier0=False,
                 native_bulk: bool = True,
                 native_shards: int = 1,
                 native_pin_shards: bool = False,
                 native_uring: "str | bool | int | None" = None,
                 metrics_port: int | None = None,
                 observability: bool = True,
                 heavy_hitters_k: int = 64,
                 flight_dir: str | None = None,
                 flight_capacity: int = 512,
                 tracing_config: "bool | dict | None" = None,
                 audit: "bool | AuditConfig | None" = None,
                 snapshot_incremental: bool = False,
                 overflow_pool: "dict | None" = None) -> None:
        self.store = store
        self.host = host
        self.port = port
        # The native front-end (native/frontend.cc): the C++ loop owns the
        # sockets and hands per-request micro-batches to Python once per
        # flush. Its batcher's knobs fail fast, as MicroBatcher's do —
        # fe_start would coerce a nonpositive value to its default.
        self.native_frontend = native_frontend
        if native_max_batch <= 0:
            raise ValueError("native_max_batch must be positive")
        if native_deadline_us <= 0:
            raise ValueError("native_deadline_us must be positive")
        self.native_max_batch = native_max_batch
        self.native_deadline_us = native_deadline_us
        #: Tier-0 admission cache (native front-end only): False/None off,
        #: True for defaults, or a native_frontend.Tier0Config.
        self.native_tier0 = native_tier0
        #: The native bulk lane: ACQUIRE_MANY frames parse, tier-0-decide
        #: and encode RESP_BULK in C; only the residue reaches Python.
        self.native_bulk = native_bulk
        if native_shards < 1:
            raise ValueError("native_shards must be >= 1")
        #: Epoll (or io_uring) shards accepting on SO_REUSEPORT listeners
        #: bound to one port.
        self.native_shards = native_shards
        self.native_pin_shards = native_pin_shards
        #: io_uring data plane: None defers to DRL_TPU_URING (off when
        #: unset); "on" / "sqpoll" opt in; a shard the kernel refuses a
        #: ring serves on epoll and reports why.
        self.native_uring = native_uring
        self._native = None
        # Server-configured checkpoint destination for OP_SAVE (≙ Redis
        # BGSAVE writing its configured dump file — clients never supply
        # paths, so the wire cannot be used to write arbitrary files).
        self.snapshot_path = snapshot_path
        # Incremental checkpoints: OP_SAVE then writes a v4 delta against
        # the previous save instead of a full v3 file; the chain owns base
        # retention, integrity chaining and compaction (checkpoint.py).
        self._snapshot_chain = None
        if snapshot_incremental and snapshot_path is not None:
            from distributedratelimiting.redis_tpu_torch.runtime import (
                checkpoint,
            )

            self._snapshot_chain = checkpoint.SnapshotChain(snapshot_path)
            dirty = getattr(store, "enable_dirty_tracking", None)
            if callable(dirty):
                dirty()  # arm the store's dirty accounting (OP_STATS)
        # Shared-secret auth: when set, a connection's first frame must be
        # a HELLO carrying this token.
        self.auth_token = auth_token
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()
        self._save_task: asyncio.Task | None = None
        self.connections_served = 0
        self.requests_served = 0
        # Requests dropped unexecuted because their client-stamped deadline
        # (wire DEADLINE_FLAG tail) expired while the frame sat in this
        # server's own queueing.
        self.requests_shed = 0
        # Goodput under overload: the two gates are DISARMED by default
        # (an operator, or the controller's retry-storm rung, arms them);
        # a healthy server's serving path is the ungated one.
        #: Requests denied by the doomed-work gate: their propagated
        #: deadline cannot be met given the current p99 serving latency.
        self.requests_doomed = 0
        #: Frames that arrived stamped attempt >= 1 (wire ATTEMPT_FLAG
        #: tail / bulk deadline tail): retries reaching this server.
        self.retry_attempts_seen = 0
        #: Retry-stamped frames denied while retry-shed was armed.
        self.retries_shed = 0
        #: OP_RESERVE requests answered with a route-to-pool redirect.
        self.reserves_routed = 0
        #: Armed: deny attempt >= 1 frames before the store is touched.
        self.retry_shed_enabled = False
        #: Armed: deny deadline-stamped work that current p99 says cannot
        #: finish inside its budget.
        self.doomed_gate_enabled = False
        #: Budget-aware routing: ``{"pool", "ta", "tb", "priority"}`` naming
        #: the pool OP_RESERVE redirects doomed-at-admit interactive
        #: requests to (None disables routing).
        self.overflow_pool = dict(overflow_pool) if overflow_pool else None
        # Serving latency: request read (arrival) → result ready, the
        # latency the server is accountable for (OP_STATS serving_p50_ms /
        # serving_p99_ms); the reply stage is result ready → reply handed
        # to the transport.
        self.serving_latency = LatencyHistogram()
        self.reply_latency = LatencyHistogram()
        # The observability plane: heavy-hitter key telemetry, the flight
        # recorder, per-tenant token velocity and the OpenMetrics registry
        # behind OP_METRICS and /metrics. Pull-only; observability=False
        # is the ablation the bench's serving_metrics_overhead compares
        # against.
        self.observability = observability
        self.heavy_hitters = (HeavyHitters(heavy_hitters_k)
                              if observability and heavy_hitters_k > 0
                              else None)
        # Per-tenant tokens/s of the hierarchical lanes' GRANTED costs
        # (OP_STATS "token_velocity", drl_token_velocity{tenant=…}).
        self.token_velocity: "admission.TokenVelocity | None" = (
            admission.TokenVelocity() if observability else None)
        self.flight_recorder = (FlightRecorder(flight_capacity,
                                               dump_dir=flight_dir)
                                if observability else None)
        self.metrics_port = metrics_port
        self._metrics_server: asyncio.AbstractServer | None = None
        self._registry: MetricsRegistry | None = None
        # The live-config half: the committed forwarding rules behind
        # OP_CONFIG. Dormant until the first rule commits.
        self.liveconfig = liveconfig.ConfigState()
        # The estimate-reserve-settle ledger: the STORE-attached one, so a
        # store re-fronted by a new server keeps its holds and debts;
        # (re)wired to THIS server's plane (settles feed the velocity the
        # actual spend, reserve events land in the flight recorder, a
        # settle of a hold made under a retired config lands on the table
        # the rebase carried its balance into). A client store (no ledger
        # of its own) serves no reservations.
        if callable(getattr(store, "reservation_ledger", None)):
            self.reservations = store.reservation_ledger()
            self.reservations.velocity = self.token_velocity
            self.reservations.flight_recorder = self.flight_recorder
            self.reservations.liveconfig = self.liveconfig
        else:
            self.reservations = None
        #: Region-side federation agent, when this process hosts one (an
        #: embedder or the controller wiring assigns it): its
        #: partition/degraded counters ride OP_STATS and the
        #: drl_federation_region_* families.
        self.federation_agent = None
        # The elastic-membership half: the epoch-versioned placement map and
        # the handoff state. Dormant (one attribute read a request) until a
        # coordinator announces a map (OP_PLACEMENT_ANNOUNCE).
        self.placement = placement.NodePlacementState()
        # Drain-and-handoff shutdown (shutdown()): while a drain is in
        # flight, admission ops serve from this bounded fair-share envelope
        # instead of the (already exported) store.
        self._drain_envelope: "placement._FairShareEnvelope | None" = None
        #: Successor handle while a drain window is open: OP_SETTLE is
        #: relayed there (the ledger entries shipped with the export).
        self._drain_successor = None
        self._drain_deadline = 0.0
        self._shutdown_done = False
        #: Autonomous control plane, when this process hosts one (the
        #: ``--controller`` CLI or an embedder assigns it): its audit
        #: surface rides OP_STATS, /flight (shared flight recorder), and
        #: the drl_controller_* families.
        self.controller = None
        # Tracing rides the process-global tracer: True enables it with
        # defaults, a dict passes knobs through, None leaves it as is.
        if tracing_config is not None:
            if isinstance(tracing_config, dict):
                tracing.configure(**tracing_config)
            else:
                tracing.configure(enabled=bool(tracing_config))
        self.tracer = tracing.get_tracer()
        # Conservation audit plane (runtime/audit.py): the witness pair is
        # the reply/witness identity's raw material — tokens this server
        # TOLD clients it granted vs tokens the store actually debited,
        # incremented adjacently at the scalar decision site. Monotonic
        # Python floats, never reset.
        self.audit_replied_tokens = 0.0
        self.audit_witnessed_tokens = 0.0
        # audit=None follows the observability switch; an AuditConfig
        # passes knobs through; False is the ablation the bench's
        # audit_overhead section compares against.
        if audit is None:
            audit = observability
        self.auditor = (ConservationAuditor(
            self, audit if isinstance(audit, AuditConfig) else None)
            if audit else None)
        self._audit_task: "asyncio.Task | None" = None

    def set_retry_shed(self, enabled: bool) -> None:
        """Arm/disarm the server-side retry-shed gate (the same name
        :meth:`AdmissionPolicy.set_retry_shed` answers on the gateway
        side)."""
        self.retry_shed_enabled = bool(enabled)

    def set_doomed_gate(self, enabled: bool) -> None:
        """Arm/disarm the doomed-work gate: deadline-stamped requests whose
        budget cannot be met given the current p99 serving latency are
        denied at admit instead of granted tokens they will burn
        uselessly."""
        self.doomed_gate_enabled = bool(enabled)

    async def start(self) -> tuple[str, int]:
        """Bind and listen; returns the bound ``(host, port)`` (port 0 in
        the constructor picks a free one)."""
        await self.store.connect()
        metrics = getattr(self.store, "metrics", None)
        if (self.flight_recorder is not None and metrics is not None
                and hasattr(metrics, "flight_recorder")):
            # The store's flush observer feeds the ring (one frame per
            # flush) and fires the degraded-entry auto-dump on a flush
            # error — see DeviceBucketStore._flush_observer.
            metrics.flight_recorder = self.flight_recorder
        if self.auditor is not None and self._audit_task is None:
            # The ε-ledger's pacer, ticking before the listener binds.
            self._audit_task = asyncio.create_task(self.auditor.run())
        if self.native_frontend:
            from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
                NativeFrontend,
            )

            # No fallback to the asyncio listener: a library that cannot
            # build, or a port that cannot bind, raises here (after the
            # audit pacer is stopped again).
            try:
                self._native = NativeFrontend(
                    self, host=self.host, port=self.port,
                    max_batch=self.native_max_batch,
                    deadline_us=self.native_deadline_us,
                    tier0=self.native_tier0, bulk=self.native_bulk,
                    shards=self.native_shards,
                    pin_shards=self.native_pin_shards,
                    uring=self.native_uring)
            except BaseException:
                await self.aclose()
                raise
            self.port = self._native.port
            await self._start_metrics_http()
            return self.host, self.port
        if self.native_tier0:
            import logging

            logging.getLogger(__name__).warning(
                "native_tier0 is set but native_frontend is off — the "
                "tier-0 admission cache only exists inside the native "
                "front-end and is NOT active")
        self._server = await asyncio.start_server(
            self._serve_connection, self.host, self.port
        )
        sock = self._server.sockets[0]
        self.host, self.port = sock.getsockname()[:2]
        await self._start_metrics_http()
        return self.host, self.port

    # -- /metrics HTTP exposition -------------------------------------------
    async def _start_metrics_http(self) -> None:
        """Bind the stdlib-asyncio HTTP listener when ``metrics_port`` is
        set (0 = ephemeral; the bound port lands back in
        ``self.metrics_port``)."""
        if self.metrics_port is None:
            return
        self._metrics_server = await asyncio.start_server(
            self._serve_metrics_http, self.host, self.metrics_port)
        self.metrics_port = (
            self._metrics_server.sockets[0].getsockname()[1])

    #: Content type served when the scraper did NOT Accept openmetrics:
    #: the Prometheus text 0.0.4 format (same sample lines, exemplar
    #: annotations suppressed — they are an OpenMetrics-only construct).
    PLAIN_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

    async def _serve_metrics_http(self, reader: asyncio.StreamReader,
                                  writer: asyncio.StreamWriter) -> None:
        """Minimal one-shot HTTP/1.1 responder: GET /metrics → the
        exposition (content negotiated on ``Accept:`` — scrapers asking for
        ``application/openmetrics-text`` get OpenMetrics with exemplars,
        everyone else Prometheus text 0.0.4); GET /flight → a
        (rate-limited) flight-recorder dump, answering its path; GET
        /audit[?bundles=N] → the conservation snapshot; GET
        /traces[?drain=1] → Chrome-trace-event JSON of the kept traces.
        It exists so ``curl``/Prometheus reach the plane with zero
        dependencies."""
        from urllib.parse import parse_qs

        try:
            request_line = await asyncio.wait_for(reader.readline(), 10.0)
            parts = request_line.split()
            path = parts[1].decode("latin-1") if len(parts) >= 2 else "/"
            accept = ""
            while True:  # drain headers (Accept drives negotiation)
                line = await asyncio.wait_for(reader.readline(), 10.0)
                if line in (b"\r\n", b"\n", b""):
                    break
                if line[:7].lower() == b"accept:":
                    accept = line[7:].decode("latin-1", "replace").strip()
            route, _, query = path.partition("?")
            if route in ("/metrics", "/"):
                openmetrics = "application/openmetrics-text" in accept
                body = self.registry.render(
                    exemplars=openmetrics).encode("utf-8")
                status = "200 OK"
                ctype = (MetricsRegistry.CONTENT_TYPE if openmetrics
                         else self.PLAIN_CONTENT_TYPE)
            elif route == "/traces":
                # A proper parameter parse: the drain is destructive, so
                # ?nodrain=1 or ?drain=10 must not trigger it.
                drain = parse_qs(query).get("drain", ["0"])[-1] == "1"
                body = self.tracer.export_chrome_json(
                    drain=drain).encode("utf-8")
                status, ctype = "200 OK", "application/json"
            elif route == "/flight" and self.flight_recorder is not None:
                # Rate-limited on purpose: this listener carries no auth
                # (unlike OP_STATS behind HELLO), so an unthrottled dump
                # would let any peer that reaches the port fill the disk.
                dump_path = self.flight_recorder.auto_dump("http_trigger")
                body = json.dumps({"dumped": dump_path,
                                   "suppressed": dump_path is None}
                                  ).encode()
                status, ctype = "200 OK", "application/json"
            elif route == "/audit":
                try:
                    n = int(parse_qs(query).get("bundles", ["0"])[-1])
                except ValueError:
                    n = 0
                body = self._audit_json({"bundles": n}).encode("utf-8")
                status, ctype = "200 OK", "application/json"
            else:
                body, status, ctype = (b"not found\n", "404 Not Found",
                                       "text/plain")
            writer.write(
                (f"HTTP/1.1 {status}\r\nContent-Type: {ctype}\r\n"
                 f"Content-Length: {len(body)}\r\n"
                 f"Connection: close\r\n\r\n").encode("latin-1") + body)
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionResetError,
                BrokenPipeError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    @property
    def registry(self) -> MetricsRegistry:
        """The server's OpenMetrics registry (built lazily — families read
        live counters through callables, so construction order does not
        matter)."""
        if self._registry is None:
            self._registry = self._build_registry()
        return self._registry

    def _goodput_numeric_stats(self) -> "dict[str, float]":
        """drl_goodput_* family: deadline outcomes from the reservation
        ledger plus the server-side doomed/route gate work. Always renders
        (zeros before any deadline-stamped traffic)."""
        led = self.reservations
        return {
            "settled_in_deadline": (led.settled_in_deadline
                                    if led is not None else 0),
            "settled_late": led.settled_late if led is not None else 0,
            "deadline_expired_grants": (led.deadline_expired_grants
                                        if led is not None else 0),
            "first_attempt_grants": (led.first_attempt_grants
                                     if led is not None else 0),
            "requests_doomed": self.requests_doomed,
            "reserves_routed": self.reserves_routed,
            "doomed_gate_enabled": 1.0 if self.doomed_gate_enabled
            else 0.0,
        }

    def _retry_numeric_stats(self) -> "dict[str, float]":
        """drl_retry_* family: attempt-tail observations and the
        retry-shed gate (scalar + reserve lanes)."""
        led = self.reservations
        return {
            "attempts_seen": self.retry_attempts_seen,
            "shed": self.retries_shed,
            "grants": led.retry_grants if led is not None else 0,
            "reserves": led.retry_reserves if led is not None else 0,
            "shed_enabled": 1.0 if self.retry_shed_enabled else 0.0,
        }

    def _build_registry(self) -> MetricsRegistry:
        """The JAX server's families, in its order and with its names and
        help text."""
        reg = MetricsRegistry()
        reg.counter("connections_served", "Accepted TCP connections",
                    lambda: (self._native.counts()[1]
                             if self._native is not None
                             else self.connections_served))
        reg.counter("requests_served", "Requests answered on any lane",
                    lambda: (self._native.counts()[0]
                             if self._native is not None
                             else self.requests_served))
        reg.counter("batches_flushed",
                    "Native front-end micro-batches handed to Python",
                    lambda: (self._native.counts()[2]
                             if self._native is not None else 0))
        reg.counter("requests_shed",
                    "Requests dropped unexecuted: client deadline "
                    "expired in server queueing",
                    lambda: self.requests_shed)
        reg.gauge("native_fe_shards", "native front-end epoll shard "
                  "count (0 = asyncio path)",
                  lambda: (float(self._native.n_shards)
                           if self._native is not None else 0.0))
        reg.gauge("native_frontend", "1 when the C front-end owns the "
                  "sockets", lambda: 1.0 if self._native is not None
                  else 0.0)
        reg.gauge("native_fe_uring_shards", "native front-end shards "
                  "serving on the io_uring transport (0 = epoll or "
                  "asyncio path)",
                  lambda: (float(self._native.uring_shards)
                           if self._native is not None else 0.0))
        reg.histogram("serving_latency_seconds",
                      "Request arrival to result ready",
                      lambda: (self._native.latency_histogram()
                               if self._native is not None
                               else self.serving_latency))
        # Per-stage decomposition: serving ≈ queue + flush + reply on the
        # asyncio path; the native path adds its C-measured queue/exec
        # split. One family, one label.
        metrics = getattr(self.store, "metrics", None)
        reg.histogram("stage_latency_seconds",
                      "Per-stage share of the serving span",
                      lambda: getattr(metrics, "queue_latency", None),
                      labels={"stage": "queue"})
        reg.histogram("stage_latency_seconds",
                      "Per-stage share of the serving span",
                      lambda: getattr(metrics, "flush_latency", None),
                      labels={"stage": "flush"})
        reg.histogram("stage_latency_seconds",
                      "Per-stage share of the serving span",
                      lambda: self.reply_latency,
                      labels={"stage": "reply"})
        for stage in ("native_queue", "native_exec"):
            reg.histogram(
                "stage_latency_seconds",
                "Per-stage share of the serving span",
                lambda s=stage: (self._native.stage_histograms().get(s)
                                 if self._native is not None else None),
                labels={"stage": stage})
        reg.register_numeric_dict(
            "store", "store metrics",
            lambda: metrics.snapshot() if metrics is not None else None,
            counters={"launches", "rows_processed", "rows_valid", "sweeps",
                      "slots_evicted", "rows_coalesced", "pregrows",
                      "fp_unresolved"})
        reg.register_numeric_dict(
            "tier0", "tier-0 admission cache",
            lambda: (self._native.tier0_stats()
                     if self._native is not None else None),
            counters={"hits", "local_denies", "misses", "installs",
                      "evictions", "syncs", "sync_failures",
                      "keys_synced"})
        reg.register_numeric_dict(
            "native_bulk", "native bulk admission lane",
            lambda: (self._native.bulk_stats()
                     if self._native is not None else None),
            counters={"frames", "frames_local", "rows", "rows_local",
                      "rows_residue", "permits_local",
                      "hot_ring_dropped"})
        if self.heavy_hitters is not None:
            hh = self.heavy_hitters
            reg.gauge("hot_keys_offered",
                      "Total admission weight offered to the top-K sketch",
                      lambda: hh.offered)
            reg.labeled_gauges(
                "hot_key_count",
                "Top-K admission weight per key (space-saving sketch; "
                "count may overshoot by at most hot_key_error)",
                lambda: [({"key": k}, c) for k, c, _ in hh.top()])
            reg.labeled_gauges(
                "hot_key_error",
                "Space-saving overcount bound per tracked key",
                lambda: [({"key": k}, e) for k, _, e in hh.top()])
        if self.token_velocity is not None:
            tv = self.token_velocity
            reg.counter("admitted_tokens",
                        "Tokens admitted through the hierarchical "
                        "(tenant-budgeted) lanes",
                        lambda: tv.observed_tokens)
            reg.labeled_gauges(
                "token_velocity",
                "Per-tenant admitted tokens/sec (exponentially decayed "
                "rate, tau=token_velocity tau_s) — the autoscaling / "
                "resharding signal",
                lambda: [({"tenant": t}, r)
                         for t, r in tv.rates().items()])
        if self.reservations is not None:
            led = self.reservations
            reg.labeled_gauges(
                "reservations_outstanding",
                "Outstanding reserved tokens per tenant (reserve "
                "issued, settle pending) — the unsettled-load signal "
                "the controller's shed ladder folds into its pressure "
                "sensor",
                lambda: [({"tenant": t}, v)
                         for t, v in led.outstanding_by_tenant()
                         .items()])
            reg.labeled_gauges(
                "reservation_debt",
                "Per-tenant unsettled under-estimate debt (tokens the "
                "budget must cover before the next reserve admits)",
                lambda: [({"tenant": t}, v)
                         for t, v in led.debts().items()])
            reg.register_numeric_dict(
                "reservation", "estimate-reserve-settle ledger",
                lambda: (led.numeric_stats() if led.active else None),
                counters={"reserves", "reserve_denied",
                          "reserve_duplicates", "ledger_full_denials",
                          "debt_denials", "settles",
                          "settle_duplicates", "settle_unknown",
                          "ttl_expired", "refunds", "refunded_tokens",
                          "debts_created", "debt_tokens_created",
                          "debt_tokens_collected", "rehomed",
                          "reserved_tokens_total",
                          "settled_tokens_total",
                          "extra_debited_tokens",
                          "exported_tokens_out", "restored_tokens_in",
                          "dropped_tokens", "forfeited_tokens"})
            # Settle-error magnitude histograms, recorded at tokens x 1e-6
            # (bucket bounds read as micro-tokens).
            reg.histogram("reservation_refund_tokens",
                          "Over-estimate refund magnitudes "
                          "(bucket unit: tokens x 1e-6)",
                          lambda: led.refund_hist)
            reg.histogram("reservation_debt_tokens",
                          "Under-estimate overage magnitudes "
                          "(bucket unit: tokens x 1e-6)",
                          lambda: led.debt_hist)
        # Goodput under overload: drl_goodput_* folds the ledger's
        # deadline outcomes with the doomed/route gates; drl_retry_* the
        # retry-storm posture. Both render with the gates disarmed, so a
        # storm can be watched building before anyone arms them.
        reg.register_numeric_dict(
            "goodput", "goodput sensor (deadline-outcome ledger + "
            "doomed-work and pool-routing gates)",
            lambda: self._goodput_numeric_stats(),
            counters={"settled_in_deadline", "settled_late",
                      "deadline_expired_grants", "first_attempt_grants",
                      "requests_doomed", "reserves_routed"})
        reg.register_numeric_dict(
            "retry", "retry-storm defense (attempt-tail admissions "
            "and the retry-shed gate)",
            lambda: self._retry_numeric_stats(),
            counters={"attempts_seen", "shed", "grants", "reserves"})
        # Global quota federation (runtime/federation.py). Read
        # dynamically: the home ledger materializes on the first OP_FED_*
        # frame and the region agent is attached by an embedder — both may
        # postdate the first scrape.
        reg.register_numeric_dict(
            "federation", "WAN federation ledger (home side)",
            lambda: (self.federation.numeric_stats()
                     if self.federation is not None
                     and self.federation.active else None),
            counters={"leases_granted", "lease_duplicates",
                      "lease_denied", "renews", "renew_unknown",
                      "resizes", "reclaims", "reclaim_duplicates",
                      "reclaim_unknown", "leases_expired", "heals",
                      "charged_tokens", "conservative_tokens",
                      "refunded_tokens", "debts_created",
                      "debt_tokens_created", "debt_tokens_collected",
                      "restores"})
        reg.labeled_gauges(
            "federation_slice_share",
            "Leased share of each global tenant budget per region "
            "(slice utilization — Σ over regions <= 1 per tenant)",
            lambda: ([({"tenant": t, "region": r}, s)
                      for t, r, s in self.federation.shares()]
                     if self.federation is not None else []))
        reg.register_numeric_dict(
            "federation_region",
            "WAN federation agent (region side): partition/degraded "
            "counters",
            lambda: (self.federation_agent.numeric_stats()
                     if self.federation_agent is not None else None),
            counters={"leases_acquired", "lease_failures", "renews",
                      "renew_failures", "partition_errors",
                      "degraded_entries", "heals", "slice_updates",
                      "stale_slice_replies", "reclaims",
                      "fed_fallbacks"})
        if self.flight_recorder is not None:
            reg.register_numeric_dict(
                "flight", "flight recorder",
                self.flight_recorder.snapshot,
                counters={"frames_recorded", "dumps_written",
                          "dumps_suppressed"})
        reg.register_numeric_dict(
            "placement", "placement/migration state",
            lambda: (self.placement.stats()
                     if self.placement.active else None),
            counters={"moved_errors", "envelope_decisions",
                      "handoff_deferrals", "pulls", "pushes_applied",
                      "pushes_duplicate", "rows_imported", "aborts",
                      "expired_aborts", "announces", "stale_announces"})
        reg.register_numeric_dict(
            "config", "live-config mutation state",
            lambda: (self.liveconfig.stats()
                     if (self.liveconfig.active
                         or self.liveconfig.version) else None),
            counters={"moved_errors", "commits", "aborts",
                      "stale_announces", "rebased_rows"})
        reg.register_numeric_dict(
            "snapshot_chain", "incremental checkpoint chain",
            lambda: (self._snapshot_chain.stats()
                     if self._snapshot_chain is not None else None),
            counters={"full_saves", "delta_saves"})
        reg.register_numeric_dict(
            "trace", "distributed tracer",
            lambda: (self.tracer.snapshot()
                     if self.tracer.enabled else None),
            counters={"spans_recorded", "traces_kept", "traces_dropped",
                      "traces_evicted"})
        # Autonomous control plane (read dynamically: the CLI attaches the
        # controller after start(), which may be after the first scrape
        # built this registry — a None controller renders nothing).
        reg.register_numeric_dict(
            "controller", "autonomous control plane",
            lambda: (self.controller.numeric_stats()
                     if self.controller is not None else None),
            counters={"ticks", "tick_failures", "actions_recorded",
                      "actuation_errors"})
        reg.labeled_counters(
            "controller_actions",
            "Controller decisions by action and outcome",
            lambda: (self.controller.action_series()
                     if self.controller is not None else []))
        # Conservation audit plane: drl_audit_overadmitted_tokens is the
        # SLI numerator utils/slo.py's SLO_SERIES names.
        reg.register_numeric_dict(
            "audit", "conservation audit plane (epsilon ledger)",
            lambda: (self.auditor.numeric_stats()
                     if self.auditor is not None else None),
            counters={"ticks", "tick_failures", "breaches",
                      "overadmitted_tokens", "bundles_assembled"})
        reg.register_numeric_dict(
            "slo", "multi-window burn-rate watchdog (utils/slo.py)",
            lambda: (self.auditor.watchdog.numeric_stats()
                     if self.auditor is not None else None),
            counters={"ticks", "alerts", "trips", "clears"})
        reg.labeled_gauges(
            "epsilon_budget_used_ratio",
            "Fraction of each documented epsilon allowance consumed "
            "(source=tier0|shard|envelope|federation; 1.0 = realized "
            "drift ate the whole budget — see DESIGN.md §22)",
            lambda: (self.auditor.epsilon_series()
                     if self.auditor is not None else []))
        reg.counter("stats_resets",
                    "Destructive serving-window resets, any trigger "
                    "(the shared-window tripwire, utils/metrics.py)",
                    lambda: self.serving_latency.resets)
        return reg

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        self.connections_served += 1
        write_lock = asyncio.Lock()
        request_tasks: set[asyncio.Task] = set()
        # Bulk frames chain per connection: a chunked acquire_many arrives
        # as several ACQUIRE_MANY frames whose duplicate keys must decide
        # in chunk order — independent tasks could race chunk 2 past chunk
        # 1. Non-bulk ops stay fully concurrent.
        bulk_tail: asyncio.Task | None = None
        authed = self.auth_token is None
        conn_task = asyncio.current_task()
        if conn_task is not None:
            self._conn_tasks.add(conn_task)
            conn_task.add_done_callback(self._conn_tasks.discard)
        try:
            while True:
                body = await wire.read_frame(reader)
                if body is None:
                    break
                # Frame-read time is the arrival stamp: deadline shedding
                # and serving latency both measure from the moment the
                # bytes were in hand.
                t_read = time.perf_counter()
                # Version + auth are connection-level gates, checked in
                # order here (not in per-request tasks, which complete out
                # of order): a bad frame gets one best-effort error reply,
                # then the connection drops.
                if body and body[0] != wire.PROTOCOL_VERSION:
                    await self._reply(writer, write_lock, wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR,
                        f"protocol version mismatch: peer speaks "
                        f"v{body[0]}, server speaks "
                        f"v{wire.PROTOCOL_VERSION}"))
                    break
                op = body[5] if len(body) >= 6 else 0
                if op == wire.OP_HELLO:
                    try:
                        seq, _, token, _, _, _ = wire.decode_request(body)
                    except Exception:  # malformed HELLO: routable error, drop
                        await self._reply(writer, write_lock,
                                          wire.encode_response(
                                              _recover_seq(body),
                                              wire.RESP_ERROR,
                                              "malformed HELLO frame"))
                        break
                    if self.auth_token is not None and not hmac.compare_digest(
                            token.encode("utf-8", "surrogateescape"),
                            self.auth_token.encode("utf-8",
                                                   "surrogateescape")):
                        await self._reply(writer, write_lock,
                                          wire.encode_response(
                                              seq, wire.RESP_ERROR,
                                              "authentication failed"))
                        break
                    authed = True
                    await self._reply(writer, write_lock,
                                      wire.encode_response(
                                          seq, wire.RESP_EMPTY))
                    continue
                if not authed:
                    await self._reply(writer, write_lock, wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR,
                        "authentication required: send HELLO first"))
                    break
                if op == wire.OP_ACQUIRE_MANY:
                    # Only continuation chunks chain; independent bulk
                    # frames — every client-coalesced flush included —
                    # pipeline freely.
                    after = (bulk_tail if wire.bulk_request_chained(body)
                             else None)
                    task = asyncio.ensure_future(self._serve_request(
                        body, writer, write_lock, after=after,
                        arrival_s=t_read))
                    bulk_tail = task
                else:
                    task = asyncio.ensure_future(self._serve_request(
                        body, writer, write_lock, arrival_s=t_read))
                request_tasks.add(task)
                task.add_done_callback(request_tasks.discard)
        except wire.RemoteStoreError as exc:
            log.error_evaluating_kernel(exc)  # protocol-broken peer: drop
        finally:
            for t in request_tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    #: Only await drain once the transport's buffer passes this: past the
    #: mark, drain applies backpressure against a slow-reading client.
    _DRAIN_HIGH_WATER = 256 * 1024

    async def _reply(self, writer: asyncio.StreamWriter,
                     write_lock: asyncio.Lock, resp: bytes) -> None:
        # The lock keeps concurrent request tasks' frames from
        # interleaving; a vanished client just drops the reply (its
        # futures die with the socket).
        async with write_lock:
            try:
                wire.write_frame(writer, resp)
                if (writer.transport.get_write_buffer_size()
                        > self._DRAIN_HIGH_WATER):
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _serve_request(self, body: bytes, writer: asyncio.StreamWriter,
                             write_lock: asyncio.Lock,
                             after: "asyncio.Task | None" = None,
                             arrival_s: "float | None" = None) -> None:
        t_arrival = time.perf_counter() if arrival_s is None else arrival_s
        if after is not None:
            # Per-connection bulk ordering (see _serve_connection). The
            # predecessor's own failure was already replied there.
            await asyncio.gather(after, return_exceptions=True)
        if faults._INJECTOR is not None:  # chaos seam; no-op in prod
            try:
                await faults._INJECTOR.on_event("server.dispatch")
            except faults.BlackholeFault:
                return  # no reply: the client's timeout owns this one
            except Exception as exc:
                await self._reply(writer, write_lock, wire.encode_response(
                    _recover_seq(body), wire.RESP_ERROR, repr(exc)))
                return
        resp = await self.handle_frame_body(body, arrival_s=t_arrival)
        self.requests_served += 1
        t_ready = time.perf_counter()
        self.serving_latency.record(t_ready - t_arrival)
        await self._reply(writer, write_lock, resp)
        self.reply_latency.record(time.perf_counter() - t_ready)

    async def handle_frame_body(self, body: bytes,
                                arrival_s: "float | None" = None) -> bytes:
        """Serve one frame body and return the encoded reply. Store and
        decode failures come back as routable RESP_ERROR frames, never as
        raises (except cancellation), so one bad request can never take a
        connection down with it.

        Trace-stamped frames (scalar op flag / bulk flags bit 4) are
        stripped here and served inside a ``server.<op>`` span parented on
        the client's context; the span's status is read from the encoded
        reply (denied decision / error). Deadline-stamped frames are
        stripped next: when this server's own queueing already consumed
        the client's budget, the request is SHED — a routable "deadline
        exceeded" error, the store untouched. Then the two overload gates,
        when armed: the doomed-work gate denies deadline-stamped work whose
        remaining budget cannot cover the current p99 serving latency, the
        retry-shed gate denies attempt-stamped retries — each a routable
        error, the store untouched. Attempt-stamped retries are counted."""
        tctx = None
        deadline_s = None
        attempt = 0
        flagged_op = None
        if (len(body) >= 6 and body[5] & (wire.TRACE_FLAG
                                          | wire.DEADLINE_FLAG
                                          | wire.ATTEMPT_FLAG)):
            # Remember the raw flagged byte: if the residual frame fails
            # strict decode after the strips below, it was never a flagged
            # <op> — answer the "unknown op" an old server gives the byte
            # as sent, not a misparse of whatever op the masked bits spell.
            flagged_op = body[5]
        if len(body) >= 6:
            if body[5] & wire.TRACE_FLAG:
                try:
                    body, tctx = wire.strip_trace(body)
                except wire.RemoteStoreError as exc:
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR, repr(exc))
            if body[5] & wire.DEADLINE_FLAG:
                try:
                    body, deadline_s = wire.strip_deadline(body)
                except wire.RemoteStoreError as exc:
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR, repr(exc))
            if body[5] & wire.ATTEMPT_FLAG:
                try:
                    body, attempt = wire.strip_attempt(body)
                except wire.RemoteStoreError as exc:
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR, repr(exc))
            if body[5] == wire.OP_ACQUIRE_MANY:
                tctx = wire.bulk_trace_tail(body)
                # The bulk lane's deadline + attempt ride one payload tail
                # (flags bit 5), honored through the same gate below.
                btail = wire.bulk_deadline_tail(body)
                if btail is not None:
                    deadline_s, attempt = btail
        if attempt:
            self.retry_attempts_seen += 1
        if deadline_s is not None and arrival_s is not None:
            waited = time.perf_counter() - arrival_s
            if waited > deadline_s:
                self.requests_shed += 1
                return wire.encode_response(
                    _recover_seq(body), wire.RESP_ERROR,
                    f"deadline exceeded: request waited "
                    f"{waited * 1e3:.1f}ms against a "
                    f"{deadline_s * 1e3:.1f}ms budget (shed unexecuted)")
            if self.doomed_gate_enabled:
                # Doomed-work gate: the remaining budget cannot cover this
                # server's current p99 serving latency — deny at admit,
                # store untouched, instead of granting tokens the client
                # will never collect.
                p99 = (self.serving_latency.p99
                       if self.serving_latency.total else 0.0)
                if waited + p99 > deadline_s:
                    self.requests_doomed += 1
                    self.requests_shed += 1
                    return wire.encode_response(
                        _recover_seq(body), wire.RESP_ERROR,
                        f"doomed: {deadline_s * 1e3:.1f}ms budget "
                        f"cannot cover p99 {p99 * 1e3:.1f}ms at admit "
                        "(shed unexecuted)")
        if attempt and self.retry_shed_enabled:
            # Retry-shed gate: retries shed FIRST, before any priority
            # class — a granted retry burns budget a first attempt could
            # have turned into goodput.
            self.retries_shed += 1
            self.requests_shed += 1
            return wire.encode_response(
                _recover_seq(body), wire.RESP_ERROR,
                f"retry shed: attempt {attempt} denied while the "
                "retry-storm defense is armed")
        if tctx is None or not self.tracer.enabled:
            return await self._handle_frame_inner(body,
                                                  flagged_op=flagged_op)
        op = body[5] if len(body) >= 6 else 0
        with self.tracer.start_span(
                f"server.{wire.op_name(op)}", parent=tctx) as span:
            resp = await self._handle_frame_inner(body,
                                                  flagged_op=flagged_op)
            kind = resp[9] if len(resp) >= 10 else 0
            if kind == wire.RESP_ERROR:
                span.set_status("error")
            elif (kind == wire.RESP_DECISION and len(resp) >= 11
                    and resp[10] == 0):
                span.set_status("denied")
            elif kind == wire.RESP_BULK and len(resp) >= 15:
                # Bulk reply: [u8 flags][u32 n][granted bits…] at offset
                # 10. Any denied row marks the span.
                n = int.from_bytes(resp[11:15], "little")
                nbits = (n + 7) // 8
                granted = sum(bin(b).count("1")
                              for b in resp[15:15 + nbits])
                if granted < n:
                    span.set_status("denied")
                    span.set_attr("denied_rows", n - granted)
            if span.context is not None:
                # Exemplar on the serving histogram: the span's own
                # duration is (within µs) this request's serving stage —
                # the jump from a histogram bucket to the exported trace
                # that filled it.
                self.serving_latency.exemplar(
                    time.perf_counter() - span.start_s,
                    span.context.trace_id)
        return resp

    async def _handle_frame_inner(self, body: bytes, *,
                                  flagged_op: "int | None" = None) -> bytes:
        seq = _recover_seq(body)
        try:
            if len(body) >= 6 and body[5] == wire.OP_ACQUIRE_MANY:
                # as_view: keys stay a KeyBlob over the frame bytes — the
                # device store's native directory resolves them without a
                # Python string per key. One frame = one store bulk call.
                seq, keys, counts, a, b, with_rem, kind = (
                    wire.decode_bulk_request(body, as_view=True))
                if kind == wire.BULK_KIND_HBUCKET:
                    return await self._serve_bulk_hier(
                        seq, body, keys, counts, a, b, with_rem)
                if self.liveconfig.active:
                    # Frame-level config gate: one (kind, a, b) decides the
                    # whole frame. A retired config answers the routable
                    # moved error (no row applied); the client re-sends the
                    # frame with the new operands.
                    ckind = liveconfig.BULK_KINDS.get(kind)
                    fwd = (self.liveconfig.forward(ckind, a, b)
                           if ckind is not None else None)
                    if fwd is not None:
                        return wire.encode_response(
                            seq, wire.RESP_ERROR,
                            self.liveconfig.moved(ckind, a, b, fwd))
                env = self._drain_envelope
                if env is not None:
                    return self._serve_bulk_draining(
                        seq, keys, counts, a, b, with_rem, kind, env)
                gate = (self.placement.bulk_gate(keys)
                        if self.placement.active else None)
                if gate is not None and gate[2].any():
                    # Misrouted rows answer a FRAME-level moved error (no
                    # row applied): the client refreshes its map and sends
                    # the whole frame again.
                    return wire.encode_response(
                        seq, wire.RESP_ERROR, self._bulk_moved(keys, gate))
                self._offer_bulk_hot(keys, counts)
                if gate is not None:
                    res = await self._serve_bulk_gated(
                        keys, counts, a, b, with_rem, kind, gate)
                else:
                    res = await self._bulk_store_call(keys, counts, a, b,
                                                      kind, with_rem)
                return wire.encode_bulk_response(seq, res.granted,
                                                 res.remaining)
            if len(body) >= 6 and body[5] == wire.OP_ACQUIRE_H:
                return await self._serve_hierarchical(body)
            try:
                seq, op, key, count, a, b = wire.decode_request(body)
            except wire.RemoteStoreError:
                raise  # already routable ("unknown op N", truncated, ...)
            except Exception as exc:
                if flagged_op is not None:
                    # The tails were stripped off a flagged op byte whose
                    # masked bits spell a real op, but the residual payload
                    # is not that op's shape: reject the byte as sent.
                    raise wire.RemoteStoreError(
                        f"unknown op {flagged_op}") from exc
                raise
            ckind = (liveconfig.OP_KINDS.get(op)
                     if self.liveconfig.active else None)
            if ckind is not None:
                fwd = self.liveconfig.forward(ckind, a, b)
                if fwd is not None:
                    # Retired config: the routable moved error, the store
                    # untouched; the client re-sends once with the new
                    # operands and caches the translation. OP_KINDS is the
                    # one op → kind table (the native batch lane and the
                    # client use it too).
                    return wire.encode_response(
                        seq, wire.RESP_ERROR,
                        self.liveconfig.moved(ckind, a, b, fwd))
            env = self._drain_envelope
            if env is not None and op in _PLACEMENT_GATED_OPS:
                ekind = placement.ENVELOPE_KIND.get(op)
                if ekind is not None and count >= 0:
                    # Draining: the store's balances already shipped to the
                    # successor; admission serves the bounded fair-share
                    # envelope the export withheld, as a parked key does
                    # mid-handoff.
                    granted, remaining = env.acquire(key, count, a, b,
                                                     ekind)
                    return wire.encode_response(
                        seq, wire.RESP_DECISION, granted, remaining)
                return wire.encode_response(
                    seq, wire.RESP_ERROR, _DRAINING)
            if self.placement.active and op in _PLACEMENT_GATED_OPS:
                verdict = self.placement.gate(key)
                if verdict is not None:
                    return self._gated_reply(seq, op, key, count, a, b,
                                             verdict)
            hh = self.heavy_hitters
            if hh is not None and count > 0 and op in _HOT_KEYED_OPS:
                # Hot-key telemetry, scalar lane: count > 0 gates out SEMA
                # releases (signed delta < 0) and zero-permit probes —
                # neither is admission demand. Unit-weight requests (the
                # common shape) stage through the buffered feed: one list
                # append here, the sketch merge amortized.
                if count > 1:
                    hh.offer(key, count)
                else:
                    hh.offer_buffered(key)
            if op == wire.OP_ACQUIRE:
                res = await self.store.acquire(key, count, a, b)
                granted = res.granted
                if granted:
                    # Witnessed: the store ACTUALLY debited this grant.
                    self.audit_witnessed_tokens += count
                if faults._INJECTOR is not None and not granted:
                    # audit.leak (utils/faults.py): flip a deny into a
                    # grant WITHOUT the store debit — a deliberate token
                    # leak between the two witness counters, so a seeded
                    # soak can prove the conservation auditor catches it.
                    if faults._INJECTOR.decide("audit.leak") is not None:
                        granted = True
                if granted:
                    # Replied: what the CLIENT was told.
                    self.audit_replied_tokens += count
                resp = wire.encode_response(
                    seq, wire.RESP_DECISION, granted, res.remaining)
            elif op == wire.OP_WINDOW:
                res = await self.store.window_acquire(key, count, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_DECISION, res.granted, res.remaining)
            elif op == wire.OP_FWINDOW:
                res = await self.store.fixed_window_acquire(key, count, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_DECISION, res.granted, res.remaining)
            elif op == wire.OP_SEMA:
                # count >= 0 acquires (0 probes) against the limit in a;
                # a negative count releases.
                if count >= 0:
                    res = await self.store.concurrency_acquire(key, count,
                                                               int(a))
                    resp = wire.encode_response(
                        seq, wire.RESP_DECISION, res.granted, res.remaining)
                else:
                    await self.store.concurrency_release(key, -count)
                    resp = wire.encode_response(seq, wire.RESP_DECISION,
                                                True, 0.0)
            elif op == wire.OP_PEEK:
                # peek_blocking can wait on the store lock and a device
                # readback — off-loop, so one PEEK never stalls the other
                # connections' traffic.
                value = await asyncio.to_thread(
                    self.store.peek_blocking, key, a, b)
                resp = wire.encode_response(seq, wire.RESP_VALUE, value)
            elif op == wire.OP_SYNC:
                res = await self.store.sync_counter(key, a, b)
                resp = wire.encode_response(
                    seq, wire.RESP_PAIR, res.global_score,
                    res.period_ewma_ticks)
            elif op == wire.OP_RESERVE:
                resp = await self._serve_reserve(seq, json.loads(key))
            elif op == wire.OP_SETTLE:
                resp = await self._serve_settle(seq, json.loads(key))
            elif op in (wire.OP_FED_LEASE, wire.OP_FED_RENEW,
                        wire.OP_FED_RECLAIM):
                await faults.seam("server.federation")
                resp = await self._serve_federation(seq, op,
                                                    json.loads(key))
            elif op == wire.OP_PING:
                resp = wire.encode_response(seq, wire.RESP_EMPTY)
            elif op == wire.OP_SAVE:
                if self.snapshot_path is None:
                    resp = wire.encode_response(
                        seq, wire.RESP_ERROR,
                        "server has no --snapshot-path configured")
                else:
                    await self._save()
                    resp = wire.encode_response(seq, wire.RESP_EMPTY)
            elif op == wire.OP_STATS:
                if (count & wire.STATS_FLAG_FLIGHT_DUMP
                        and self.flight_recorder is not None):
                    # Explicit operator trigger: dump BEFORE the snapshot
                    # so the payload carries the fresh path.
                    self.flight_recorder.dump("stats_trigger")
                resp = wire.encode_response(
                    seq, wire.RESP_TEXT, self._stats_json())
                if count & wire.STATS_FLAG_RESET:
                    # Start a fresh measurement window (serving + every
                    # stage histogram, both halves of the stack).
                    if self._native is not None:
                        self._native.reset_latency()
                    self.serving_latency.reset()
                    self.reply_latency.reset()
                    metrics = getattr(self.store, "metrics", None)
                    if metrics is not None:
                        metrics.flush_latency.reset()
                        metrics.queue_latency.reset()
            elif op == wire.OP_METRICS:
                resp = wire.encode_response(
                    seq, wire.RESP_TEXT, self.registry.render())
            elif op == wire.OP_TRACES:
                # Chrome-trace JSON capped under MAX_FRAME (newest traces
                # win); flag bit 0 drains the buffer after export.
                resp = wire.encode_response(
                    seq, wire.RESP_TEXT, self.tracer.export_chrome_json(
                        max_bytes=wire.MAX_FRAME - 256,
                        drain=bool(count & 1)))
            elif op == wire.OP_AUDIT:
                resp = wire.encode_response(
                    seq, wire.RESP_TEXT,
                    self._audit_json(json.loads(key) if key else {}))
            elif op == wire.OP_PLACEMENT:
                resp = wire.encode_response(
                    seq, wire.RESP_TEXT,
                    json.dumps(self.placement.snapshot_payload()))
            elif op == wire.OP_PLACEMENT_ANNOUNCE:
                epoch = self.placement.announce(json.loads(key))
                if self._native is not None and self.native_tier0:
                    # The C tier-0 cache decides hot keys without the gate;
                    # its epsilon bound still holds, but a membership
                    # change deserves the operator's eye.
                    import logging

                    logging.getLogger(__name__).warning(
                        "placement epoch %d adopted with the tier-0 "
                        "cache enabled: tier-0 keeps deciding hot keys "
                        "until their budgets drain", epoch)
                resp = wire.encode_response(seq, wire.RESP_VALUE,
                                            float(epoch))
            elif op == wire.OP_MIGRATE_PULL:
                await faults.seam("server.migrate")
                out = await self.placement.pull(json.loads(key), self.store)
                resp = wire.encode_response(seq, wire.RESP_TEXT,
                                            json.dumps(out))
            elif op == wire.OP_MIGRATE_PUSH:
                await faults.seam("server.migrate")
                applied = await self.placement.push(json.loads(key),
                                                    self.store)
                resp = wire.encode_response(seq, wire.RESP_VALUE,
                                            float(applied))
            elif op == wire.OP_CONFIG:
                # An empty payload fetches the committed rules; any other
                # is one step of a two-phase mutation.
                payload = json.loads(key)
                if not payload:
                    resp = wire.encode_response(
                        seq, wire.RESP_TEXT, json.dumps(
                            self.liveconfig.snapshot_payload()))
                else:
                    await faults.seam("server.config")
                    version = await self.liveconfig.announce(payload,
                                                             self.store)
                    resp = wire.encode_response(seq, wire.RESP_VALUE,
                                                float(version))
            else:  # HELLO past the connection gate
                resp = wire.encode_response(
                    seq, wire.RESP_ERROR, f"unknown op {op}")
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # relay (with the recovered seq), never
            log.error_evaluating_kernel(exc)  # kill the connection
            resp = wire.encode_response(seq, wire.RESP_ERROR, repr(exc))
        return resp

    # -- the placement gate (runtime/placement.py) ----------------------------
    def _gated_reply(self, seq: int, op: int, key: str, count: int,
                     a: float, b: float, verdict: tuple) -> bytes:
        """The reply to a scalar frame the placement gate stopped: a parked
        key's admission serves from its handoff envelope; a parked PEEK,
        SYNC, SEMA or release answers the transient handoff deferral (a
        MOVED would name this node and send the client in a circle); a key
        another node owns answers the routable moved error."""
        what, info = verdict
        if what == "envelope":
            ekind = placement.ENVELOPE_KIND.get(op)
            if ekind is not None and count >= 0:
                granted, remaining = self.placement.envelope_acquire(
                    info, key, count, a, b, ekind)
                return wire.encode_response(seq, wire.RESP_DECISION,
                                            granted, remaining)
            return wire.encode_response(
                seq, wire.RESP_ERROR, self.placement.deferral_message(info))
        return wire.encode_response(
            seq, wire.RESP_ERROR, self.placement.moved_message(key, info))

    def _bulk_moved(self, keys, gate) -> str:
        """The frame-level moved error of a bulk frame with misrouted rows:
        it names the first one's owner."""
        key = keys[int(np.nonzero(gate[2])[0][0])]
        return self.placement.moved_message(
            key, int(self.placement.pmap.node_of(key)))

    async def _bulk_store_call(self, keys, counts, a: float, b: float,
                               kind: int, with_rem: bool):
        """The store call of one bulk frame's rows, by kind; the native
        lane's residue takes it too."""
        if kind == wire.BULK_KIND_BUCKET:
            return await self.store.acquire_many(keys, counts, a, b,
                                                 with_remaining=with_rem)
        return await self.store.window_acquire_many(
            keys, counts, a, b, fixed=(kind == wire.BULK_KIND_FWINDOW),
            with_remaining=with_rem)

    async def _serve_bulk_gated(self, keys, counts, a: float, b: float,
                                with_rem: bool, kind: int, gate):
        """One bulk frame under an adopted map with a parked row and no
        misrouted one (:func:`~.placement.serve_gated_bulk`). Row order is
        kept."""
        from distributedratelimiting.redis_tpu_torch.runtime.store import (
            BulkAcquireResult,
        )

        n = len(keys)
        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32) if with_rem else None
        await placement.serve_gated_bulk(
            self.placement, gate, keys, counts, np.arange(n), a, b, kind,
            lambda ks, cs: self._bulk_store_call(ks, cs, a, b, kind,
                                                 with_rem),
            granted, remaining)
        return BulkAcquireResult(granted, remaining)

    def _serve_bulk_draining(self, seq: int, keys, counts, a: float,
                             b: float, with_rem: bool, kind: int,
                             env) -> bytes:
        """One bulk frame while the drain is in flight: every row serves
        from the shutdown envelope (the store's balances already shipped to
        the successor), in row order. The native bulk lane answers with
        this too, so the two lanes' replies are equal byte for byte."""
        ekind = placement.BULK_ENVELOPE_KIND[kind]
        n = len(keys)
        counts_np = np.asarray(counts, np.int64)
        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32) if with_rem else None
        for i in range(n):
            g, rem = env.acquire(keys[i], int(counts_np[i]), a, b, ekind)
            granted[i] = g
            if remaining is not None:
                remaining[i] = rem
        return wire.encode_bulk_response(seq, granted, remaining)

    def _hier_config_gate(self, seq: int, a: float, b: float,
                          ta: float, tb: float) -> "bytes | None":
        """Both levels of a two-level frame gate on the live-config rules:
        a retired child config and a retired parent (tenant) config each
        answer the routable moved error (the client learns the rule of
        whichever level moved and re-sends; both are "bucket" rules)."""
        if not self.liveconfig.active:
            return None
        for pa, pb in ((a, b), (ta, tb)):
            fwd = self.liveconfig.forward("bucket", pa, pb)
            if fwd is not None:
                return wire.encode_response(
                    seq, wire.RESP_ERROR,
                    self.liveconfig.moved("bucket", pa, pb, fwd))
        return None

    @staticmethod
    def _hier_envelope(env_acquire, tenant: str, key: str, count: int,
                       a: float, b: float, ta: float, tb: float,
                       priority: int) -> tuple[bool, float]:
        """Two-level envelope serving for a parked tenant: the child's
        envelope, then the tenant's, granted iff both (a child debit on a
        tenant deny stays debited: the conservative direction). The
        priority shed order applies at both levels
        (:func:`~.admission.shed_allows`)."""
        g1, r1 = env_acquire(key, count, a, b, "bucket", priority)
        if not g1:
            return False, r1
        g2, r2 = env_acquire(tenant, count, ta, tb, "bucket", priority)
        return g2, min(r1, r2)

    def _tenant_envelope(self, handoff):
        """The envelope acquire of one parked tenant's handoff, in the
        shape :meth:`_hier_envelope` calls."""
        return (lambda k, c, pa, pb, kind, prio:
                self.placement.envelope_acquire(handoff, k, c, pa, pb,
                                                kind, prio))

    def _tenant_deferral(self, seq: int, handoff) -> bytes:
        return wire.encode_response(
            seq, wire.RESP_ERROR,
            self.placement.deferral_message(handoff, "tenant"))

    async def _serve_hierarchical(self, body: bytes) -> bytes:
        """One ``OP_ACQUIRE_H`` frame: two-level tenant → key weighted-cost
        admission, one store call (one launch on a card store). The
        placement gate keys on the TENANT: two-level traffic routes by
        tenant (the parent bucket lives whole on one node)."""
        seq, key, count, a, b, tenant, ta, tb, priority = (
            wire.decode_hierarchical_request(body))
        gate_resp = self._hier_config_gate(seq, a, b, ta, tb)
        if gate_resp is not None:
            return gate_resp
        env = self._drain_envelope
        if env is not None:
            if count >= 0:
                granted, remaining = self._hier_envelope(
                    env.acquire, tenant, key, count, a, b, ta, tb, priority)
                return wire.encode_response(
                    seq, wire.RESP_DECISION, granted, remaining)
            return wire.encode_response(seq, wire.RESP_ERROR, _DRAINING)
        if self.placement.active:
            verdict = self.placement.gate(tenant)
            if verdict is not None:
                what, info = verdict
                if what == "envelope" and count >= 0:
                    granted, remaining = self._hier_envelope(
                        self._tenant_envelope(info), tenant, key, count,
                        a, b, ta, tb, priority)
                    return wire.encode_response(
                        seq, wire.RESP_DECISION, granted, remaining)
                if what == "envelope":
                    return self._tenant_deferral(seq, info)
                return wire.encode_response(
                    seq, wire.RESP_ERROR,
                    self.placement.moved_message(tenant, info))
        hh = self.heavy_hitters
        if hh is not None and count > 0:
            # Cost-weighted: an N-token admission weighs N in the sketch,
            # so hot-COST keys surface as split candidates.
            if count > 1:
                hh.offer(key, count)
            else:
                hh.offer_buffered(key)
        res = await self.store.acquire_hierarchical(
            tenant, key, count, ta, tb, a, b, priority=priority)
        if res.granted and count > 0 and self.token_velocity is not None:
            self.token_velocity.observe(tenant, float(count))
        return wire.encode_response(seq, wire.RESP_DECISION, res.granted,
                                    res.remaining)

    async def _serve_bulk_hier(self, seq: int, body: bytes, keys, counts,
                               a: float, b: float, with_rem: bool) -> bytes:
        """One ``BULK_KIND_HBUCKET`` frame: one tenant's rows (the tenant
        extension rides the frame's tail) decided two-level in one store
        call."""
        tenant, ta, tb, priority = wire.bulk_hier_tail(body)
        gate_resp = self._hier_config_gate(seq, a, b, ta, tb)
        if gate_resp is not None:
            return gate_resp
        counts_np = np.asarray(counts, np.int64)
        env_acquire = None
        if self._drain_envelope is not None:
            # Draining: every row serves from the shutdown envelope.
            env_acquire = self._drain_envelope.acquire
        elif self.placement.active:
            # Frame-level, keyed on the tenant (the frame's routing
            # identity): a moved tenant answers MOVED, a parked one serves
            # every row from its handoff envelope.
            verdict = self.placement.gate(tenant)
            if verdict is not None:
                what, info = verdict
                if what != "envelope":
                    return wire.encode_response(
                        seq, wire.RESP_ERROR,
                        self.placement.moved_message(tenant, info))
                env_acquire = self._tenant_envelope(info)
        if env_acquire is not None:
            n = len(keys)
            granted = np.zeros(n, bool)
            remaining = np.zeros(n, np.float32) if with_rem else None
            for i in range(n):
                g, rem = self._hier_envelope(
                    env_acquire, tenant, keys[i], int(counts_np[i]),
                    a, b, ta, tb, priority)
                granted[i] = g
                if remaining is not None:
                    remaining[i] = rem
            return wire.encode_bulk_response(seq, granted, remaining)
        self._offer_bulk_hot(keys, counts_np)
        res = await self.store.acquire_hierarchical_many(
            [tenant] * len(keys), keys, counts_np, ta, tb, a, b,
            with_remaining=with_rem, priority=priority)
        if self.token_velocity is not None:
            admitted = int(counts_np[np.asarray(res.granted, bool)].sum())
            if admitted > 0:
                self.token_velocity.observe(tenant, float(admitted))
        return wire.encode_bulk_response(seq, res.granted, res.remaining)

    def _offer_bulk_hot(self, keys, counts) -> None:
        """Cost-weighted heavy-hitter feed for the bulk lane: ``offer_blob``
        aggregates straight off the frame's byte blob (a bounded sample and
        a top-K merge, no string per key), weighted in tokens."""
        hh = self.heavy_hitters
        if hh is None:
            return
        if isinstance(keys, wire.KeyBlob):
            hh.offer_blob(keys.blob, keys.offsets, counts)
        else:
            hh.offer_many(keys, np.asarray(counts, np.float64))

    # -- estimate-reserve-settle (runtime/reservations.py) --------------------
    async def _serve_reserve(self, seq: int, req: dict) -> bytes:
        """One ``OP_RESERVE`` frame: admission at the estimate + a TTL'd
        ledger hold, the same JSON reply as the JAX server's. The decision
        is the store's two-level one (one launch on a card store)."""
        rid = str(req.get("rid") or "")
        tenant = str(req.get("tenant") or "")
        key = str(req.get("key") or "")
        if not rid or not tenant or not key:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "reserve requires rid, tenant, and key")
        estimate = req.get("estimate")
        a, b = float(req.get("a", 0.0)), float(req.get("b", 0.0))
        ta, tb = float(req.get("ta", 0.0)), float(req.get("tb", 0.0))
        priority = int(req.get("priority", 0))
        ttl_s = req.get("ttl_s")
        attempt = int(req.get("attempt", 0) or 0)
        try:
            deadline_s = (float(req["deadline_s"])
                          if req.get("deadline_s") is not None else None)
        except (TypeError, ValueError):
            deadline_s = None
        gate_resp = self._hier_config_gate(seq, a, b, ta, tb)
        if gate_resp is not None:
            return gate_resp
        led = self.reservations
        est = float(estimate) if estimate else None
        if est is None and led is not None:
            est = led.prior.estimate(tenant, priority)
            if est is None:
                est = led.default_estimate
        # fallback_charge floors an estimate-less charge at the ledger's
        # DEFAULT_ESTIMATE (the charge the sketch, the envelope and the
        # pool route see).
        charge = reservations.fallback_charge(est)

        def envelope_reply(env_acquire) -> bytes:
            # An envelope-served reserve takes NO ledger entry: its settle
            # answers the counted "unknown" no-op, so the hold is never
            # refunded (conservative).
            granted, remaining = self._hier_envelope(
                env_acquire, tenant, key, charge, a, b, ta, tb, priority)
            return wire.encode_response(seq, wire.RESP_TEXT, json.dumps(
                {"granted": bool(granted),
                 "reserved": float(charge) if granted else 0.0,
                 "remaining": float(remaining), "debt": 0.0,
                 "envelope": True}))

        if self._drain_envelope is not None:
            return envelope_reply(self._drain_envelope.acquire)
        if self.placement.active:
            # Keyed on the TENANT (reservations route with the two-level
            # traffic they budget).
            verdict = self.placement.gate(tenant)
            if verdict is not None:
                what, info = verdict
                if what != "envelope":
                    return wire.encode_response(
                        seq, wire.RESP_ERROR,
                        self.placement.moved_message(tenant, info))
                return envelope_reply(self._tenant_envelope(info))
        if led is None:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "this server has no reservation ledger")
        if attempt:
            self.retry_attempts_seen += 1
            if self.retry_shed_enabled:
                # The reservation lane's retry-shed answer is a plain deny
                # (granted False) — terminal to the client, the posture a
                # storm needs; a routable error would invite another retry.
                self.retries_shed += 1
                self.requests_shed += 1
                return wire.encode_response(
                    seq, wire.RESP_TEXT, json.dumps(
                        {"granted": False, "reserved": 0.0,
                         "remaining": 0.0, "debt": 0.0,
                         "duplicate": False, "shed": "retry"}))
        if self.doomed_gate_enabled and deadline_s is not None:
            p99 = (self.serving_latency.p99
                   if self.serving_latency.total else 0.0)
            if p99 > deadline_s:
                self.requests_doomed += 1
                self.requests_shed += 1
                return wire.encode_response(
                    seq, wire.RESP_TEXT, json.dumps(
                        {"granted": False, "reserved": 0.0,
                         "remaining": 0.0, "debt": 0.0,
                         "duplicate": False, "shed": "doomed"}))
        pool = self.overflow_pool
        if (pool is not None and deadline_s is not None
                and priority == admission.PRIORITY_INTERACTIVE):
            # Budget-aware pool routing: when the estimate will not fit
            # the interactive pool's remaining tenant budget inside the
            # client's deadline, answer the routable route-to-pool
            # redirect (the client chases it once) — never a grant the
            # budget cannot honor in time. The peek reads the card (one
            # slot) on a card store.
            peek = getattr(self.store, "peek_blocking", None)
            balance = None
            if callable(peek):
                try:
                    balance = peek(tenant, ta, tb)
                except Exception:  # drl-check: ok(swallowed-exception)
                    # — a backing without a sync peek lane degrades to
                    # routing-off; the reserve itself still runs and is
                    # the visible outcome.
                    balance = None
            if (balance is not None
                    and charge > balance + tb * max(0.0, deadline_s)):
                self.reserves_routed += 1
                return wire.encode_response(
                    seq, wire.RESP_ERROR,
                    reservations.route_message(
                        str(pool.get("pool", "overflow")),
                        float(pool.get("ta", ta)),
                        float(pool.get("tb", tb)),
                        int(pool.get("priority",
                                     admission.PRIORITY_BATCH))))
        hh = self.heavy_hitters
        if hh is not None and charge > 1:
            hh.offer(key, charge)
        res = await led.reserve(rid, tenant, key, estimate, ta, tb,
                                a, b, priority=priority, ttl_s=ttl_s,
                                attempt=attempt, deadline_s=deadline_s)
        return wire.encode_response(seq, wire.RESP_TEXT, json.dumps(
            {"granted": res.granted, "reserved": res.reserved,
             "remaining": res.remaining, "debt": res.debt,
             "duplicate": res.duplicate}))

    # -- global quota federation dispatch (runtime/federation.py) ------------
    @property
    def federation(self):
        """The store-attached home ledger, or ``None`` until the first
        federation frame creates it (non-home servers never pay for one) —
        read dynamically so the registry and stats callables see it the
        moment it exists."""
        return getattr(self.store, "_federation", None)

    def _fed_ledger(self):
        """Get-or-create the home ledger, wired into THIS server's
        observability plane (the reservations re-wire posture: a store
        re-fronted by a new server must see the new plane)."""
        led = self.store.federation_ledger()
        led.flight_recorder = self.flight_recorder
        led.velocity = self.token_velocity
        return led

    async def _serve_federation(self, seq: int, op: int,
                                req: dict) -> bytes:
        """One federation control frame at the home: lease / renew /
        reclaim against the store-attached :class:`~.federation.
        FederationLedger`. All three are post-send-retry-safe (lease and
        reclaim replay recorded results, renew is absorbing) — validation
        failures answer the routable error, the ledger untouched."""
        led = self._fed_ledger()
        if op == wire.OP_FED_LEASE:
            out = await led.lease(req)
        elif op == wire.OP_FED_RENEW:
            out = await led.renew(req)
        else:
            out = await led.reclaim(req)
        return wire.encode_response(seq, wire.RESP_TEXT, json.dumps(out))

    async def _serve_settle(self, seq: int, req: dict) -> bytes:
        """One ``OP_SETTLE`` frame: reconcile a reservation's actual cost
        (idempotent by rid: a retry replays the recorded result)."""
        rid = str(req.get("rid") or "")
        tenant = str(req.get("tenant") or "")
        if not rid or not tenant:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "settle requires rid and tenant")
        try:
            actual = float(req.get("actual", 0.0))
        except (TypeError, ValueError):
            return wire.encode_response(seq, wire.RESP_ERROR,
                                        "settle actual must be a number")
        successor = self._drain_successor
        if self._drain_envelope is not None and successor is not None:
            # Draining: the ledger's entries shipped with the export, so the
            # settle relays to the successor (idempotent by rid: a duplicated
            # relay is safe). A failed relay answers the deferral; the
            # client's retry lands after the LB switch.
            try:
                res = await successor.settle(rid, tenant, actual)
            except Exception as exc:
                log.error_evaluating_kernel(exc)
                return wire.encode_response(
                    seq, wire.RESP_ERROR,
                    f"{placement.HANDOFF_DEFERRAL_PREFIX}: settle relay to "
                    "the drain successor failed; retry")
            return wire.encode_response(seq, wire.RESP_TEXT,
                                        json.dumps(res._asdict()))
        if self.placement.active:
            verdict = self.placement.gate(tenant)
            if verdict is not None:
                what, info = verdict
                if what == "envelope":
                    # Parked mid-handoff: the ledger rows already left with
                    # the export; the retry lands on the new owner after
                    # the commit (a settle is retry-safe).
                    return self._tenant_deferral(seq, info)
                return wire.encode_response(
                    seq, wire.RESP_ERROR,
                    self.placement.moved_message(tenant, info))
        if self.reservations is None:
            return wire.encode_response(
                seq, wire.RESP_ERROR,
                "this server has no reservation ledger")
        res = await self.reservations.settle(rid, tenant, actual)
        return wire.encode_response(seq, wire.RESP_TEXT,
                                    json.dumps(res._asdict()))

    async def _save(self) -> None:
        """Checkpoint the store to the configured path off-loop: through
        the delta chain when the server holds one (it compacts into a full
        base on its own thresholds), else a full file. Concurrent SAVEs
        piggyback on the one in flight (BGSAVE semantics) instead of
        queueing redundant state pulls; a chain's links therefore never
        interleave."""
        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )

        if self._save_task is None or self._save_task.done():
            # Placement-versioned: a rejoining node restoring this file can
            # be held to the cluster's current epoch.
            epoch = (self.placement.epoch if self.placement.active
                     else None)
            if self._snapshot_chain is not None:
                self._save_task = asyncio.ensure_future(asyncio.to_thread(
                    self._snapshot_chain.save, self.store, epoch))
            else:
                self._save_task = asyncio.ensure_future(asyncio.to_thread(
                    checkpoint.save_snapshot, self.store,
                    self.snapshot_path, placement_epoch=epoch))
        await asyncio.shield(self._save_task)

    # -- drain-and-handoff shutdown ---------------------------------------------
    async def shutdown(self, successor=None, *, window_s: float = 2.0,
                       envelope_fraction: float =
                       placement.DEFAULT_ENVELOPE_FRACTION) -> dict:
        """Planned shutdown that ships state instead of wiping it.

        With a ``successor`` store (any :class:`~.store.BucketStore`,
        typically a :class:`~.remote.RemoteBucketStore` at the new process)
        this reuses the migration handoff lane end to end: the whole
        keyspace is exported with the fair-share envelope withheld, the
        local store is charged for the shipped amount
        (:func:`placement.debit_source`, so the dual-ownership bound holds
        while this process lingers), in-flight and late admission traffic
        serves from the withheld envelope for at most ``window_s``, and the
        remainder lands on the successor through the ``MIGRATE_PUSH`` import
        lane (batch-deduped: a retried push cannot apply twice).

        With no successor the final state goes to the configured snapshot
        path (through the incremental chain when one is armed). Returns a
        summary dict; idempotent once complete. A failed drain falls back
        to the final checkpoint when a snapshot path is set (the summary
        carries ``drain_error``), else re-opens for a retry and raises."""
        if self._shutdown_done:
            return {"already": True}
        self._shutdown_done = True
        # An OP_SAVE still writing must finish first: a concurrent final
        # save would interleave the chain's delta links.
        if self._save_task is not None and not self._save_task.done():
            try:
                await asyncio.shield(self._save_task)
            # The save's own OP_SAVE caller already saw this failure.
            # drl-check: ok(swallowed-exception)
            except Exception:
                pass
        try:
            return await self._shutdown_body(successor, window_s,
                                             envelope_fraction)
        except asyncio.CancelledError:
            self._shutdown_done = False
            self._drain_envelope = None
            self._drain_successor = None
            raise
        except Exception as exc:
            # Resume authoritative serving from the (possibly debited)
            # store, the migration-abort posture: the residual IS the
            # envelope, so un-gating under-admits at worst. Exported holds
            # stay gone from the local ledger (which chunks landed is
            # unknowable); their settles answer the counted "unknown".
            self._drain_envelope = None
            self._drain_successor = None
            if successor is not None and self.snapshot_path is not None:
                # The shipped-but-unreceived balance must not evaporate:
                # the final checkpoint is its home, the restarted process
                # restores it.
                try:
                    path = await self._final_checkpoint()
                except Exception as save_exc:
                    log.error_evaluating_kernel(save_exc)
                else:
                    log.error_evaluating_kernel(exc)
                    await self.aclose()
                    return {"shipped_rows": 0, "checkpoint": path,
                            "drain_error": repr(exc)}
            self._shutdown_done = False  # retryable: nothing landed
            raise

    async def _final_checkpoint(self) -> str:
        """The final save, off the loop: through the chain when one is
        armed, else a full file; stamped with the adopted placement
        epoch."""
        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )

        epoch = self.placement.epoch if self.placement.active else None
        if self._snapshot_chain is not None:
            return await asyncio.to_thread(self._snapshot_chain.save,
                                           self.store, epoch)
        await asyncio.to_thread(checkpoint.save_snapshot, self.store,
                                self.snapshot_path, placement_epoch=epoch)
        return self.snapshot_path

    async def _shutdown_body(self, successor, window_s: float,
                             envelope_fraction: float) -> dict:
        out: dict = {"shipped_rows": 0, "checkpoint": None}
        if successor is not None:
            env = placement._FairShareEnvelope(envelope_fraction)
            # A card store's export takes seconds: off the loop, so the
            # other connections are served meanwhile.
            entries = await asyncio.to_thread(
                placement._export_from_store, self.store, lambda _k: True)
            export = placement.debit_export(entries, envelope_fraction)
            target_epoch = (self.placement.epoch + 1
                            if self.placement.active else 1)
            # Outstanding holds and tenant debts ship with the state: their
            # settles relay to the successor during the window and must
            # find the entries there. The tag dedups a re-delivered debt.
            led = self.reservations
            if led is not None:
                res_rows, debt_rows = led.export_rows(
                    lambda _t: True, tag=f"drain:{target_epoch}")
                if res_rows or debt_rows:
                    export = dict(export)
                    export["reservations"] = res_rows
                    export["debts"] = debt_rows
            # Gate on BEFORE the source debit lands: from here until aclose
            # admission serves only the envelope the export withheld, so no
            # late request spends a balance the successor receives.
            self._drain_envelope = env
            self._drain_successor = successor
            self._drain_deadline = time.monotonic() + window_s
            await placement.debit_source(self.store, entries,
                                         envelope_fraction,
                                         keep_envelope=True)
            push = getattr(successor, "migrate_push", None)
            rows = 0
            for bid, chunk in enumerate(placement.chunk_entries(export)):
                if callable(push):
                    rows += await push({"target_epoch": target_epoch,
                                        # Namespaced like the cluster's
                                        # per-source batch ids: a drain's
                                        # pushes never collide with a
                                        # concurrent migration's.
                                        "batch": (0xD << 24) | bid,
                                        "entries": chunk})
                else:
                    rows += await placement.import_entries(successor,
                                                           chunk)
            if self.liveconfig.active:
                # The gates ride along: a successor serving the rebased
                # state without the forwarding rules would re-open every
                # retired config init-on-miss. Adopt is idempotent and
                # version-monotonic.
                ann = getattr(successor, "config_announce", None)
                if callable(ann):
                    try:
                        await ann({"adopt":
                                   self.liveconfig.snapshot_payload()})
                        out["config_version"] = self.liveconfig.version
                    except Exception as exc:
                        log.error_evaluating_kernel(exc)
                        out["config_forward_error"] = repr(exc)
            out["shipped_rows"] = rows
            # Linger for the rest of the window serving the envelope:
            # in-flight and stale-mapped clients get bounded answers, not
            # connection resets.
            linger = self._drain_deadline - time.monotonic()
            if linger > 0:
                await asyncio.sleep(linger)
            out["envelope_decisions"] = env.decisions
        elif self.snapshot_path is not None:
            out["checkpoint"] = await self._final_checkpoint()
        await self.aclose()
        return out

    def _stats_json(self) -> str:
        """OP_STATS body: the JAX server's keys (with the native front-end,
        its C-measured serving histogram and counters, tier-0, the bulk
        lane, the shards and, when io_uring was asked for, the
        transport)."""
        if self._native is not None:
            # The C front-end owns the sockets and the serving histogram
            # (arrival → completion, measured in C); passthrough ops served
            # here count into its requests_served through fe_send.
            hist = self._native.latency_histogram()
            requests, connections, batches = self._native.counts()
            payload = {
                "connections_served": connections,
                "requests_served": requests,
                "serving_p50_ms": hist.p50 * 1e3,
                "serving_p99_ms": hist.p99 * 1e3,
                "serving_samples": hist.total,
                "native_frontend": True,
                "batches_flushed": batches,
            }
            tier0 = self._native.tier0_stats()
            if tier0 is not None:
                payload["tier0"] = tier0
            bulk = self._native.bulk_stats()
            if bulk is not None:
                payload["native_bulk"] = bulk
            shards = self._native.shard_stats()
            if shards is not None:
                # Per-shard rows beside the merged gauges above, which stay
                # the whole-node sums.
                payload["fe_shards"] = len(shards)
                payload["shards"] = shards
            transport = self._native.transport_stats()
            if transport is not None and transport["mode"] != "epoll":
                # Only when uring was asked for: the epoll lane's OP_STATS
                # shape is the JAX server's, transport-blind.
                payload["fe_transport"] = transport
        else:
            payload = {
                "connections_served": self.connections_served,
                "requests_served": self.requests_served,
                "serving_p50_ms": self.serving_latency.p50 * 1e3,
                "serving_p99_ms": self.serving_latency.p99 * 1e3,
                "serving_samples": self.serving_latency.total,
            }
        payload["requests_shed"] = self.requests_shed
        # The destructive-reset tripwire: the serving histogram counts its
        # resets, whoever triggered them.
        payload["stats_resets"] = self.serving_latency.resets
        metrics = getattr(self.store, "metrics", None)
        if metrics is not None:
            payload["store"] = metrics.snapshot()
        # Per-stage decomposition: serving ≈ queue + flush + reply.
        stages: dict = {}
        hists = [("queue", getattr(metrics, "queue_latency", None)),
                 ("flush", getattr(metrics, "flush_latency", None)),
                 ("reply", self.reply_latency)]
        if self._native is not None:
            hists += list(self._native.stage_histograms().items())
        for name, hist in hists:
            if hist is not None and hist.total:
                stages[name] = {"p50_ms": hist.p50 * 1e3,
                                "p99_ms": hist.p99 * 1e3,
                                "samples": hist.total}
        if stages:
            payload["stages"] = stages
        if self.placement.active:
            payload["placement"] = self.placement.stats()
        if self.liveconfig.active or self.liveconfig.version:
            payload["config"] = self.liveconfig.stats()
        if self._snapshot_chain is not None:
            payload["snapshot_chain"] = self._snapshot_chain.stats()
            dirty = getattr(self.store, "dirty_stats", None)
            if callable(dirty):
                payload["snapshot_chain"]["dirty"] = dirty()
        if self.heavy_hitters is not None:
            payload["hot_keys"] = self.heavy_hitters.snapshot()
        if (self.token_velocity is not None
                and self.token_velocity.observed_tokens > 0):
            payload["token_velocity"] = self.token_velocity.snapshot()
        if self.reservations is not None and self.reservations.active:
            # stats() piggybacks one TTL-expiry pass — a scraped-but-idle
            # server still auto-settles dead clients' holds.
            payload["reservations"] = self.reservations.stats()
        # Goodput under overload: emitted once deadline/attempt-stamped
        # traffic or a gate has left a mark (or a gate is armed), so the
        # idle OP_STATS shape is untouched.
        goodput = self._goodput_numeric_stats()
        retry = self._retry_numeric_stats()
        if any(goodput.values()) or self.doomed_gate_enabled:
            payload["goodput"] = goodput
        if any(retry.values()) or self.retry_shed_enabled:
            payload["retry"] = retry
        if self.federation is not None and self.federation.active:
            # stats() piggybacks one monotonic-expiry pass — a
            # scraped-but-idle home still expires unrenewed leases.
            payload["federation"] = self.federation.stats()
        if self.federation_agent is not None:
            payload["federation_region"] = self.federation_agent.stats()
        if self.flight_recorder is not None:
            payload["flight_recorder"] = self.flight_recorder.snapshot()
        if self.tracer.enabled:
            payload["tracing"] = self.tracer.snapshot()
        if self.controller is not None:
            payload["controller"] = self.controller.stats()
        if self.auditor is not None:
            payload["audit"] = self.auditor.snapshot()
        return json.dumps(payload)

    def _audit_json(self, req: "dict | None" = None) -> str:
        """OP_AUDIT / ``GET /audit`` body: the conservation snapshot, plus
        the newest ``req["bundles"]`` black-box incident bundles when asked
        (bundles carry whole flight/trace windows — heavy, so they ship
        only on request)."""
        out: dict = {"enabled": self.auditor is not None}
        if self.auditor is not None:
            out.update(self.auditor.snapshot())
            n = int((req or {}).get("bundles", 0) or 0)
            if n > 0:
                out["bundles"] = list(self.auditor.bundles)[-n:]
        return json.dumps(out, default=repr)

    async def aclose(self) -> None:
        if self._audit_task is not None:
            self._audit_task.cancel()
            try:
                await self._audit_task
            except asyncio.CancelledError:
                pass
            self._audit_task = None
        if self._metrics_server is not None:
            self._metrics_server.close()
            await self._metrics_server.wait_closed()
            self._metrics_server = None
        if self._native is not None:
            await self._native.aclose()
            self._native = None
            return
        if self._server is not None:
            self._server.close()
        # Cancel live connection handlers BEFORE wait_closed(): since
        # Python 3.12 wait_closed() waits for handler tasks too, so a
        # server with connected clients would deadlock shutdown.
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*list(self._conn_tasks),
                                 return_exceptions=True)
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "BucketStoreServer":
        await self.start()
        return self

    async def __aexit__(self, *exc: object) -> None:
        await self.aclose()


def main(argv: list[str] | None = None) -> None:
    """Run a store server from the console — the process that plays the
    Redis role on the GPU host::

        python -m distributedratelimiting.redis_tpu_torch.runtime.server --port 6380

    SIGTERM or SIGINT is a planned shutdown (:meth:`BucketStoreServer.
    shutdown`): with ``--drain-to HOST:PORT`` the state ships to the
    successor server there; without it a final checkpoint goes to
    ``--snapshot-path`` when one is set (through the delta chain with
    ``--snapshot-incremental``). The process then exits 0."""
    import argparse

    parser = argparse.ArgumentParser(description="GPU bucket-store server")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6380)
    parser.add_argument("--backend", choices=("device", "mesh", "inprocess"),
                        default="device",
                        help="device = DeviceBucketStore (the card's "
                        "tables and kernels); mesh = MeshBucketStore, "
                        "key-sharded over a mesh of every visible card "
                        "(with --device cpu, one CPU shard); inprocess = "
                        "the serial pure-Python InProcessBucketStore (the "
                        "kernel-free baseline and test backing)")
    parser.add_argument("--slots", type=int, default=2**17,
                        help="slots per bucket table (device backend) or "
                        "per shard (mesh backend)")
    parser.add_argument("--directory", choices=("host", "fp"),
                        default="host",
                        help="key-directory home for the device and mesh "
                        "backends: host = native C++ host table (default); "
                        "fp = device-resident fingerprint directory "
                        "(in-kernel probe/insert — see docs/OPERATIONS.md "
                        "§2)")
    parser.add_argument("--sync-cadence", choices=("batch", "launch"),
                        default="batch",
                        help="global-tier cadence of the mesh backend's "
                        "sharded bucket tiers: batch = one recurrence a "
                        "scanned batch; launch = one a launch (counter "
                        "staleness bounded by one launch's span)")
    parser.add_argument("--device", default="cuda",
                        help="device of the store's tables: cuda (default; "
                        "the hand-written kernels) or cpu (their plain "
                        "PyTorch versions)")
    parser.add_argument("--snapshot-path", default=None,
                        help="checkpoint file for OP_SAVE (≙ Redis BGSAVE "
                        "dump path); if it exists at startup the store "
                        "restores from it (any .delta.* chain beside it is "
                        "applied too), and SIGTERM writes a final one")
    parser.add_argument("--snapshot-incremental", action="store_true",
                        help="OP_SAVE writes v4 delta checkpoints against "
                        "the previous save instead of full files (base + "
                        "bounded chain + compaction); requires "
                        "--snapshot-path")
    parser.add_argument("--drain-to", default=None, metavar="HOST:PORT",
                        help="on SIGTERM, ship the whole keyspace's state "
                        "to the successor server at this address through "
                        "the migration handoff lane before exiting "
                        "(drain-and-handoff shutdown); without it SIGTERM "
                        "writes a final checkpoint to --snapshot-path when "
                        "one is configured")
    parser.add_argument("--sweep-period", type=float, default=0.0,
                        help="active TTL-expiry period in seconds "
                        "(0 = on-demand sweeps only)")
    parser.add_argument("--expect-placement-epoch", type=int, default=None,
                        help="refuse a startup snapshot whose recorded "
                        "placement epoch differs (typed mismatch → "
                        "init-on-miss): a node rejoining a resharded "
                        "cluster must not serve key memberships from a "
                        "retired epoch")
    parser.add_argument("--auth-token", default=None,
                        help="shared secret; when set, clients must HELLO "
                        "with it before any other op (≙ Redis AUTH)")
    parser.add_argument("--native-frontend", action="store_true",
                        help="serve sockets from the C++ front-end "
                        "(native/frontend.cc, built at first use into the "
                        "package's build/ directory): per-request frames "
                        "batch in C and reach Python once per flush. The "
                        "server exits with an error if the library cannot "
                        "build; it never falls back to the asyncio "
                        "listener")
    parser.add_argument("--fe-max-batch", type=int, default=4096,
                        help="native front-end: max per-request frames per "
                        "micro-batch flush")
    parser.add_argument("--fe-deadline-us", type=int, default=300,
                        help="native front-end: flush deadline for the "
                        "oldest pending request, microseconds")
    parser.add_argument("--fe-tier0", action="store_true",
                        help="native front-end: enable the tier-0 "
                        "admission cache — hot ACQUIRE keys with confident "
                        "headroom decide in the C loop and reconcile "
                        "through the store's debit_many; over-admission "
                        "bounded by overadmit_epsilon")
    parser.add_argument("--fe-tier0-sync-ms", type=float, default=20.0,
                        help="tier-0 sync pump cadence, milliseconds")
    parser.add_argument("--fe-tier0-min-budget", type=float, default=64.0,
                        help="tier-0: smallest local budget worth hosting; "
                        "smaller buckets stay exact")
    parser.add_argument("--fe-tier0-fraction", type=float, default=0.5,
                        help="tier-0: fraction of the last-synced balance "
                        "granted as local headroom")
    parser.add_argument("--fe-shards", type=int, default=1,
                        help="native front-end: number of epoll shards "
                        "accepting on SO_REUSEPORT listeners bound to the "
                        "one port (1 = a single listener)")
    parser.add_argument("--fe-pin-shards", action="store_true",
                        help="native front-end: pin shard i's IO thread to "
                        "CPU i mod nproc")
    parser.add_argument("--fe-uring", default=None,
                        choices=["off", "on", "sqpoll"],
                        help="native front-end transport: 'on' serves each "
                        "shard's IO from an io_uring ring, 'sqpoll' adds a "
                        "kernel submission poller. Default defers to "
                        "DRL_TPU_URING (off when unset); a shard the "
                        "kernel or seccomp refuses a ring serves on epoll "
                        "and logs why")
    parser.add_argument("--no-uring", action="store_true",
                        help="force the epoll transport regardless of "
                        "--fe-uring / DRL_TPU_URING (as DRL_TPU_NO_URING=1)")
    parser.add_argument("--no-fe-bulk", action="store_true",
                        help="disable the native bulk lane: ACQUIRE_MANY "
                        "frames go to the Python passthrough lane instead "
                        "of parsing, tier-0-deciding and encoding RESP_BULK "
                        "in C")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve the OpenMetrics exposition over HTTP "
                        "on this port (GET /metrics, /flight, /audit, "
                        "/traces; 0 picks a free port). The same text is "
                        "always available on the wire as OP_METRICS.")
    parser.add_argument("--flight-dir", default=None,
                        help="flight-recorder dump directory (default "
                        "$DRL_TPU_FLIGHT_DIR or the system tempdir)")
    parser.add_argument("--no-observability", action="store_true",
                        help="disable the observability plane (heavy-"
                        "hitter telemetry, flight recorder, token "
                        "velocity, conservation audit); stage latency "
                        "stamps and OP_STATS remain")
    parser.add_argument("--trace", action="store_true",
                        help="enable distributed tracing: sampled requests "
                        "record span trees (client wire, server dispatch, "
                        "batcher, kernel launch), exported as Perfetto-"
                        "loadable JSON on GET /traces and OP_TRACES")
    parser.add_argument("--trace-sample", type=float, default=0.01,
                        help="head-sampling rate: fraction of new traces "
                        "recorded at all")
    parser.add_argument("--trace-latency-ms", type=float, default=50.0,
                        help="tail-sampling latency threshold: traces with "
                        "any span at/above this are always kept")
    parser.add_argument("--trace-buffer", type=int, default=256,
                        help="bounded in-memory kept-trace buffer (oldest "
                        "evicted first)")
    parser.add_argument("--controller", default=None,
                        metavar="HOST:PORT[,HOST:PORT...]",
                        help="arm the autonomous control plane: run the "
                        "reconciliation loop (runtime/controller.py) "
                        "inside this server process over the given fleet "
                        "(comma-separated store addresses — include this "
                        "node's own to reconcile it). The controller "
                        "scrapes the fleet's OP_STATS plane every tick, "
                        "derives rates from counter deltas (never "
                        "reset=True), and splits hot-cost keys, "
                        "rebalances, drains/rejoins breaker-dead nodes, "
                        "and steps the shed ladder; every action is a "
                        "flight-recorder frame and drl_controller_* "
                        "series")
    parser.add_argument("--controller-tick-ms", type=float, default=500.0,
                        help="controller reconciliation cadence")
    parser.add_argument("--controller-dry-run", action="store_true",
                        help="controller decides and logs intended "
                        "actions without executing them")
    parser.add_argument("--controller-token-rate", type=float,
                        default=None,
                        help="sustainable fleet admitted-tokens/sec for "
                        "the controller's shed ladder (unset disarms the "
                        "shed actuator; membership/split actuators stay "
                        "armed). Shed actuation needs admission gateways "
                        "(AdmissionPolicy shed_targets), which live "
                        "client-side: a server-embedded controller "
                        "records shed decisions as outcome=noop and "
                        "exports the decided level for gateways to poll")
    args = parser.parse_args(argv)
    if args.fe_tier0 and not args.native_frontend:
        parser.error("--fe-tier0 requires --native-frontend (the tier-0 "
                     "admission cache lives inside the C front-end)")
    if args.fe_shards != 1 and not args.native_frontend:
        parser.error("--fe-shards requires --native-frontend (the epoll "
                     "shards ARE the C front-end)")
    if args.fe_uring in ("on", "sqpoll") and not args.native_frontend:
        parser.error("--fe-uring requires --native-frontend (the uring "
                     "transport lives under the C front-end's shards)")
    if args.no_uring:
        args.fe_uring = "off"
    if args.snapshot_incremental and not args.snapshot_path:
        parser.error("--snapshot-incremental requires --snapshot-path "
                     "(there is no chain without a base file)")
    if (args.controller_dry_run or args.controller_token_rate
            is not None) and not args.controller:
        parser.error("--controller-dry-run/--controller-token-rate "
                     "require --controller (there is no loop to "
                     "configure)")
    if args.controller_token_rate is not None \
            and args.controller_token_rate <= 0:
        parser.error("--controller-token-rate must be positive")

    async def serve() -> None:
        import signal

        from distributedratelimiting.redis_tpu_torch.runtime import (
            checkpoint,
        )
        from distributedratelimiting.redis_tpu_torch.runtime.store import (
            DeviceBucketStore,
            InProcessBucketStore,
        )

        if args.backend == "inprocess":
            store: BucketStore = InProcessBucketStore()
        elif args.backend == "mesh":
            from distributedratelimiting.redis_tpu_torch.parallel.mesh import (  # noqa: E501
                Mesh,
                create_mesh,
            )
            from distributedratelimiting.redis_tpu_torch.parallel.mesh_store import (  # noqa: E501
                MeshBucketStore,
            )

            # Every visible card; an explicit device (cpu, cuda:i) is a
            # mesh of one shard there.
            mesh = (create_mesh() if args.device == "cuda"
                    else Mesh([args.device]))
            store = MeshBucketStore(mesh, per_shard_slots=args.slots,
                                    directory=args.directory,
                                    sync_cadence=args.sync_cadence)
        elif args.directory == "fp":
            from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (  # noqa: E501
                FingerprintBucketStore,
            )

            store = FingerprintBucketStore(n_slots=args.slots,
                                           device=args.device)
        else:
            store = DeviceBucketStore(n_slots=args.slots, device=args.device)
        if args.snapshot_path:
            import os

            if os.path.exists(args.snapshot_path):
                try:
                    # Chain-aware: applies any .delta.* files beside the
                    # base (exactly load_snapshot when there are none).
                    deltas = checkpoint.load_snapshot_chain(
                        store, args.snapshot_path,
                        expected_placement_epoch=(
                            args.expect_placement_epoch))
                except checkpoint.SnapshotCorruptError as exc:
                    # Init-on-miss: a torn snapshot or a broken chain
                    # (SnapshotChainError) must not keep the store down —
                    # serve fresh (state self-heals) and say so.
                    print(f"WARNING: ignoring corrupt snapshot: {exc}\n"
                          "starting with empty state (init-on-miss)",
                          flush=True)
                else:
                    print(f"restored snapshot from {args.snapshot_path}"
                          + (f" (+{deltas} deltas)" if deltas else ""),
                          flush=True)
        if args.sweep_period > 0 and hasattr(store, "start_sweeper"):
            store.start_sweeper(args.sweep_period)
        native_tier0 = False
        if args.fe_tier0:
            from distributedratelimiting.redis_tpu_torch.runtime.native_frontend import (  # noqa: E501
                Tier0Config,
            )

            native_tier0 = Tier0Config(
                sync_interval_s=args.fe_tier0_sync_ms / 1e3,
                min_budget=args.fe_tier0_min_budget,
                budget_fraction=args.fe_tier0_fraction)
        server = BucketStoreServer(
            store, host=args.host, port=args.port,
            snapshot_path=args.snapshot_path, auth_token=args.auth_token,
            native_frontend=args.native_frontend,
            native_max_batch=args.fe_max_batch,
            native_deadline_us=args.fe_deadline_us,
            native_tier0=native_tier0,
            native_bulk=not args.no_fe_bulk,
            native_shards=args.fe_shards,
            native_pin_shards=args.fe_pin_shards,
            native_uring=args.fe_uring,
            metrics_port=args.metrics_port,
            observability=not args.no_observability,
            flight_dir=args.flight_dir,
            tracing_config={
                "enabled": True,
                "sample_rate": args.trace_sample,
                "latency_threshold_s": args.trace_latency_ms / 1e3,
                "max_traces": args.trace_buffer,
            } if args.trace else None,
            snapshot_incremental=args.snapshot_incremental)
        host, port = await server.start()
        print(f"bucket-store server listening on {host}:{port}", flush=True)
        if server.metrics_port is not None:
            print(f"metrics exposition on "
                  f"http://{host}:{server.metrics_port}/metrics",
                  flush=True)
        controller_task = None
        controller_cluster = None
        if args.controller:
            from distributedratelimiting.redis_tpu_torch.runtime.cluster import (  # noqa: E501
                ClusterBucketStore,
            )
            from distributedratelimiting.redis_tpu_torch.runtime.controller import (  # noqa: E501
                Controller,
                ControllerConfig,
            )

            urls = [u.strip() for u in args.controller.split(",")
                    if u.strip()]
            controller_cluster = ClusterBucketStore(
                urls=urls, breaker=True, auth_token=args.auth_token,
                flight_recorder=server.flight_recorder)
            server.controller = Controller(
                controller_cluster,
                config=ControllerConfig(
                    tick_s=args.controller_tick_ms / 1e3,
                    dry_run=args.controller_dry_run,
                    token_rate_capacity=args.controller_token_rate),
                flight_recorder=server.flight_recorder)
            controller_task = asyncio.ensure_future(
                server.controller.run())
            print(f"controller reconciling {len(urls)} node(s) every "
                  f"{args.controller_tick_ms:g} ms"
                  + (" [dry-run]" if args.controller_dry_run else ""),
                  flush=True)
        term = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, term.set)
        try:
            await term.wait()
            successor = None
            if args.drain_to:
                from distributedratelimiting.redis_tpu_torch.runtime.remote import (  # noqa: E501
                    RemoteBucketStore,
                )

                successor = RemoteBucketStore(url=args.drain_to,
                                              auth_token=args.auth_token)
            print("SIGTERM: drain-and-handoff shutdown"
                  + (f" → {args.drain_to}" if args.drain_to else ""),
                  flush=True)
            # A planned restart keeps its state: shipped to the successor,
            # or in the final checkpoint the next process restores.
            try:
                summary = await server.shutdown(successor)
            finally:
                if successor is not None:
                    await successor.aclose()
            if summary.get("checkpoint"):
                print(f"final checkpoint written to {summary['checkpoint']}",
                      flush=True)
            print(f"shutdown complete: {summary}", flush=True)
        finally:
            if controller_task is not None:
                server.controller.stop()
                controller_task.cancel()
                await asyncio.gather(controller_task,
                                     return_exceptions=True)
            if controller_cluster is not None:
                await controller_cluster.aclose()
            await server.aclose()  # a no-op after the shutdown's close
            await store.aclose()

    asyncio.run(serve())


if __name__ == "__main__":
    main()
