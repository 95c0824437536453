"""Cluster store — client-side key sharding across N store servers, on
the port.

The JAX package's ``runtime/cluster.py`` with its names and ``__all__``.
N independent store servers (:class:`~.server.BucketStoreServer` over a
card store, or in-process stores) each own the keys the **epoch-versioned
placement map** (:class:`~.placement.PlacementMap`) routes to them: the
stable crc32 picks a fixed *slot*, the map assigns slots (plus per-key
hot-split overrides) to nodes, and each node is the time authority for the
keys it owns. :meth:`~ClusterBucketStore.add_node` /
:meth:`~ClusterBucketStore.drain_node` /
:meth:`~ClusterBucketStore.split_hot_key` migrate slots and their state
through the MIGRATE_PULL/PUSH handoff (placement.py); the epoch-0 map
routes bit-identically to ``crc32 % N``. A node answering the routable
``placement moved`` error makes the client refetch the map and re-route
once — the MOVED chase of every keyed lane (:meth:`_routed`, the blocking
peek, the submitter, and the bulk fan-out's background refresh).

Semantics carried over from the single-node client:

- **Per-key semantics are exactly single-node semantics.** A key's
  requests always land on the same node, and bulk splitting is
  order-stable per node, so duplicate-key serialization and
  store-as-time-authority hold per key. There is no cross-key ordering
  guarantee across nodes.
- **Degraded mode is per node**: a node failure affects only the keys it
  owns. Single-key ops surface the error to the caller. Bulk ops choose
  via ``partial_failures``: ``"raise"`` (default — all-or-error) or
  ``"deny"`` (failed nodes' rows come back denied with ``remaining ==
  0``).
- The **global decaying counter** of the approximate algorithm is itself
  just a key (``sync_counter(key=instance_name)``), so it routes to one
  node.

Per-node **circuit breakers** (``breaker=``,
:class:`~..utils.resilience.BreakerConfig`) shed a quarantined node's
keyspace fast (:class:`NodeUnavailableError`); after the recovery window
ONE request probes the node with ``ping`` and a success re-closes it.
``degraded_fallback=True`` serves a quarantined node's admission traffic
from a client-local fair-share envelope (``headroom_budget(capacity,
fraction=degraded_fraction)`` tokens refilled at ``fraction ×
fill_rate``, :func:`~.placement.envelope_step`); on rejoin the envelope's
grants are debited against the node's authoritative buckets
(:meth:`~ClusterBucketStore._rejoin_debit`). Node failures are log event
3 and ``cluster_node_errors``; breaker transitions are event 4,
flight-recorder frames and the ``drl_cluster_breaker_state`` gauge.

No kernel of its own: every decision runs on the owning node's store
(on a card store, its hand kernels).
"""

from __future__ import annotations

import asyncio
import math
import threading
import time
from typing import Callable, Mapping, Sequence

import numpy as np

from distributedratelimiting.redis_tpu_torch.runtime import placement as placement_mod
from distributedratelimiting.redis_tpu_torch.runtime import wire
from distributedratelimiting.redis_tpu_torch.runtime.clock import Clock, MonotonicClock
from distributedratelimiting.redis_tpu_torch.runtime.placement import (
    MOVED_ERROR_PREFIX,
    PlacementError,
    PlacementMap,
)
from distributedratelimiting.redis_tpu_torch.runtime.remote import RemoteBucketStore
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    BulkAcquireResult,
    SyncResult,
)
from distributedratelimiting.redis_tpu_torch.utils import faults, log, tracing
from distributedratelimiting.redis_tpu_torch.utils.resilience import (
    BreakerConfig,
    CircuitBreaker,
)

__all__ = ["ClusterBucketStore", "NodeUnavailableError", "PlacementError"]


class NodeUnavailableError(ConnectionError):
    """The key's owning node is quarantined (circuit open) and no
    degraded fallback is configured — shed fast, by design."""


class _DegradedKeyspace:
    """Client-local fair-share admission for keys whose owning node is
    quarantined.

    Each ``(node, key, config)`` serves from a conservative local
    envelope: ``headroom_budget(capacity, fraction)`` tokens refilled at
    ``fraction × fill_rate`` — the same confidence policy the
    approximate limiter and the tier-0 edge cache use, re-hosted at the
    cluster edge (models/approximate.py's shared-formula discipline).
    Windows degrade as token buckets with ``(limit, limit/window)``.
    State is per-client; on rejoin the envelope's GRANTS are drained
    (``drain_node``) and debited against the authoritative node's
    buckets — closing the unaccounted over-admission window the
    discard-on-rejoin posture left open (a grant served locally during
    the outage now costs the real bucket, so the post-rejoin admission
    total stays inside the same epsilon bound as the outage itself).
    """

    #: Bounded memory under hostile key cardinality: oldest-inserted
    #: entries evict first (a re-touched key re-inserts at full budget —
    #: conservative only in the over-admission direction by one budget,
    #: which the epsilon bound already charges for).
    _MAX_KEYS = 1 << 16

    #: Grants-ledger eviction batch: at the 2×_MAX_KEYS cap, the
    #: smallest _EVICT_BATCH debts are shed in one heap pass instead of
    #: one min() scan per insert (the next scan is this many inserts
    #: away, so the amortized per-insert cost is ~O(log batch)).
    _EVICT_BATCH = 1 << 12

    def __init__(self, fraction: float = 0.5,
                 clock: Callable[[], float] = time.monotonic) -> None:
        if not 0.0 < fraction <= 1.0:
            raise ValueError("degraded_fraction must be in (0, 1]")
        self._fraction = fraction
        self._clock = clock
        self._buckets: dict[tuple, tuple[float, float]] = {}
        #: Grants served per ``(node, key, kind, a, b)`` during the
        #: CURRENT outage — the rejoin-debit ledger (``drain_node``).
        self._grants: dict[tuple, float] = {}

    def acquire(self, node: int, key: str, count: int, capacity: float,
                fill_rate_per_sec: float,
                kind: str = "bucket",
                priority: int = 0) -> AcquireResult:
        now = self._clock()
        k = (node, key, kind, float(capacity), float(fill_rate_per_sec))
        entry = self._buckets.get(k)
        if entry is None:
            if len(self._buckets) >= self._MAX_KEYS:
                # Evict the BUCKET only: its grants ledger row survives
                # (bounded separately below) so the rejoin debit still
                # charges every grant the outage served — eviction must
                # not reopen the unaccounted-over-admission window.
                del self._buckets[next(iter(self._buckets))]
            if len(self._grants) >= 2 * self._MAX_KEYS:
                # Ledger cap under truly hostile cardinality: shed the
                # SMALLEST debts (least unaccounted admission) in one
                # amortized batch — a per-insert min() scan of 128K
                # entries would turn the degraded fallback into an O(n)
                # hotspot on exactly the path meant to keep serving
                # while a node is down. One heap pass per _EVICT_BATCH
                # inserts ≈ O(log batch) per insert.
                import heapq

                for gk, _ in heapq.nsmallest(
                        self._EVICT_BATCH, self._grants.items(),
                        key=lambda kv: kv[1]):
                    del self._grants[gk]
        # The shared envelope formula (placement.envelope_step): the
        # epsilon bound's two halves must never drift apart. Priority
        # routes through the one shed gate — scavenger is never served
        # from a degraded envelope, batch can't spend its reserve.
        granted, tokens = placement_mod.envelope_step(
            entry, now, count, capacity, fill_rate_per_sec,
            self._fraction, priority)
        if granted and count > 0:
            self._grants[k] = self._grants.get(k, 0.0) + count
        self._buckets[k] = (tokens, now)
        return AcquireResult(granted, max(tokens, 0.0))

    def drain_node(self, node: int) -> list[tuple[str, str, float,
                                                  float, float]]:
        """Rejoin: collect the outage's grants as ``(key, kind, a, b,
        count)`` debit rows and clear the node's degraded state — the
        caller charges them to the authoritative buckets."""
        out = [(k[1], k[2], k[3], k[4], granted)
               for k, granted in self._grants.items() if k[0] == node]
        self.clear_node(node)
        return out

    def clear_node(self, node: int) -> None:
        for k in [k for k in self._buckets if k[0] == node]:
            del self._buckets[k]
        for k in [k for k in self._grants if k[0] == node]:
            del self._grants[k]

    def __len__(self) -> int:
        return len(self._buckets)


class ClusterBucketStore(BucketStore):
    """Key-sharded façade over N :class:`BucketStore` nodes.

    Exactly one of ``stores``, ``addresses``, or ``urls`` must be given
    (highest-precedence one wins — the same config ladder as
    :class:`RemoteBucketStore`, lifted to lists)::

        store = ClusterBucketStore(addresses=[("gpu-a", 6380), ("gpu-b", 6380)])
        store = ClusterBucketStore(urls=["gpu-a:6380", "gpu-b:6380"])
        store = ClusterBucketStore(stores=[node_a, node_b])   # tests / mixed

    ``remote_kwargs`` (auth token, timeouts, coalescing knobs …) pass
    through to each constructed :class:`RemoteBucketStore` when addresses
    or urls are given.

    Resilience knobs (all off by default — behavior is then exactly the
    pre-chaos-plane cluster): ``breaker`` arms per-node circuit
    breakers, ``degraded_fallback`` serves quarantined keyspaces from
    the local fair-share envelope, ``flight_recorder`` receives breaker
    and node-error frames. Breaker state mutates under the GIL from
    whichever loop carries the request — transitions are coarse
    (per-node, per-failure) and tolerate that by construction.
    """

    def __init__(
        self,
        *,
        stores: Sequence[BucketStore] | None = None,
        addresses: Sequence[tuple[str, int]] | None = None,
        urls: Sequence[str] | None = None,
        partial_failures: str = "raise",
        clock: Clock | None = None,
        breaker: "BreakerConfig | bool | None" = None,
        breaker_clock: Callable[[], float] = time.monotonic,
        degraded_fallback: bool = False,
        degraded_fraction: float = 0.5,
        probe_timeout_s: float = 1.0,
        flight_recorder=None,
        placement: "PlacementMap | None" = None,
        slots_per_node: int = placement_mod.DEFAULT_SLOTS_PER_NODE,
        handoff_window_s: float = 2.0,
        **remote_kwargs,
    ) -> None:
        if stores is not None:
            nodes = list(stores)
        elif addresses is not None:
            nodes = [RemoteBucketStore(address=a, **remote_kwargs)
                     for a in addresses]
        elif urls is not None:
            nodes = [RemoteBucketStore(url=u, **remote_kwargs) for u in urls]
        else:
            raise ValueError("one of stores, addresses, or urls is required")
        if not nodes:
            raise ValueError("cluster needs at least one node")
        if partial_failures not in ("raise", "deny"):
            raise ValueError("partial_failures must be 'raise' or 'deny'")
        self.nodes: list[BucketStore] = nodes
        self.n_nodes = len(nodes)
        self._remote_kwargs = dict(remote_kwargs)
        self._partial_failures = partial_failures
        # Epoch-versioned keyspace ownership (placement.py). The default
        # initial map routes bit-identically to the legacy crc32 % N, so
        # a never-reshaped cluster behaves exactly as before.
        self.placement = placement or PlacementMap.initial(
            self.n_nodes, slots_per_node)
        self._handoff_window_s = handoff_window_s
        #: Nodes currently drained out of the slot table (still in
        #: ``nodes`` — indices are stable identities; rejoin_node folds
        #: them back in).
        self.drained: set[int] = set()
        #: Committed/aborted membership changes, in order — the reshard
        #: soak's differential-audit source of truth (each event carries
        #: the moved slots/keys plus the handoff window's [t_start,
        #: t_end] in time.monotonic()). Bounded like every other ledger
        #: here: a long-lived cluster resharding periodically keeps the
        #: newest _MIGRATION_LOG_CAP events.
        self.migration_log: list[dict] = []
        self.migrations = 0
        self.migration_aborts = 0
        #: Live config mutations driven by this coordinator
        #: (mutate_config; docs/OPERATIONS.md §10).
        self.config_mutations = 0
        self.config_aborts = 0
        self.config_rebased_rows = 0
        #: Degraded-envelope grants debited against rejoining nodes'
        #: authoritative buckets (the rejoin-reconcile satellite).
        self.rejoin_debits = 0
        self._announced = False
        #: The autonomous control plane, when one is reconciling this
        #: cluster (runtime/controller.py assigns itself here) — its
        #: audit surface rides stats() and cluster_metrics() so the
        #: loop's decisions are visible wherever the fleet's are.
        self.controller = None
        # Membership ops serialize on this coordinator: two concurrent
        # reshapes would read the same epoch, build conflicting targets,
        # and cross-wire the per-epoch pull/push ledgers (the server
        # side has _control_lock; this is the coordinator's half).
        self._membership_lock = asyncio.Lock()
        self._bg_tasks: set[asyncio.Task] = set()
        # Local clock satisfies the BucketStore interface (diagnostics
        # only); each NODE is the time authority for the keys it owns.
        self.clock = clock or MonotonicClock()

        # -- chaos plane ---------------------------------------------------
        self.flight_recorder = flight_recorder
        self._degraded = (_DegradedKeyspace(degraded_fraction)
                          if degraded_fallback else None)
        self._breaker_clock = breaker_clock
        if breaker:
            self._breaker_config = breaker if isinstance(
                breaker, BreakerConfig) else BreakerConfig()
            self._breakers: "list[CircuitBreaker] | None" = [
                self._make_breaker(j, self._breaker_config, breaker_clock)
                for j in range(self.n_nodes)]
        else:
            self._breaker_config = BreakerConfig()
            self._breakers = None
        self._probe_timeout_s = probe_timeout_s
        #: Per-node store-operation failures (satellite: partitions are
        #: visible — every increment pairs with log event id 3).
        self.node_errors = [0] * self.n_nodes
        #: Requests failed fast against quarantined nodes (no fallback).
        self.shed = 0
        #: Decisions served by the local degraded fallback.
        self.degraded_decisions = 0
        self._registry = None

        # Background loop for the blocking surface (same pattern as
        # RemoteBucketStore): lets blocking callers fan out to all nodes
        # concurrently from any thread, loop or no loop.
        self._io_loop: asyncio.AbstractEventLoop | None = None
        self._io_thread: threading.Thread | None = None
        self._thread_gate = threading.Lock()
        self._closed = False

    @property
    def _resilient(self) -> bool:
        return self._breakers is not None or self._degraded is not None

    def _make_breaker(self, j: int, config: BreakerConfig,
                      clock: Callable[[], float]) -> CircuitBreaker:
        def on_transition(old: str, new: str) -> None:
            log.breaker_transition(j, old, new)
            if self.flight_recorder is not None:
                self.flight_recorder.record("breaker", node=j, old=old,
                                            new=new)
                if new == CircuitBreaker.OPEN:
                    self.flight_recorder.auto_dump("breaker_open",
                                                   {"node": j})
            if new == CircuitBreaker.CLOSED and self._degraded is not None:
                # Rejoin: the authoritative node rules again. The
                # outage's envelope GRANTS are debited against its
                # buckets (best-effort, async) instead of silently
                # discarded — otherwise every degraded grant would be
                # over-admission the authoritative state never heard of.
                grants = self._degraded.drain_node(j)
                if grants:
                    self._spawn(self._rejoin_debit(j, grants))

        return CircuitBreaker(config, clock=clock,
                              on_transition=on_transition)

    # -- background work ---------------------------------------------------
    def _spawn(self, coro) -> None:
        """Run a coroutine in the background, always on the cluster's
        OWN I/O loop (a breaker transition can fire on any caller's
        loop — cancelling foreign-loop tasks from aclose would not be
        thread-safe). Tracked as concurrent futures, whose ``cancel`` is
        thread-safe from wherever aclose runs."""
        if self._closed:
            coro.close()
            return
        fut = asyncio.run_coroutine_threadsafe(coro, self._ensure_loop())
        self._bg_tasks.add(fut)
        fut.add_done_callback(self._bg_tasks.discard)

    #: Degraded-grant rows debited at once on a rejoin.
    _REJOIN_CONCURRENCY = 1024

    async def _rejoin_debit(self, j: int,
                            grants: "list[tuple[str, str, float, float, float]]"
                            ) -> None:
        """Charge a rejoined node's buckets for the grants its degraded
        envelope served. Saturating by construction
        (:func:`placement.saturating_drain`): the bucket lands at (or
        near) empty, never negative, and a failure just leaves the grant
        unreconciled (bounded by the envelope budget).

        JAX drains the rows one after another; here up to
        :attr:`_REJOIN_CONCURRENCY` rows drain at once. Each row is its own
        bucket (one ledger entry a key and configuration), so the state
        after is the same, and a card node decides the rows in flushes
        instead of one launch and one round trip a row."""
        node = self.nodes[j]

        async def one(key: str, kind: str, a: float, b: float,
                      count: float) -> None:
            n = int(math.ceil(count))
            if n <= 0:
                return
            try:
                if kind in ("window", "fwindow"):
                    window_sec = a / b if b > 0 else 1.0
                    op = (node.fixed_window_acquire if kind == "fwindow"
                          else node.window_acquire)
                    await placement_mod.saturating_drain(
                        lambda m: op(key, m, a, window_sec), n)
                else:
                    await placement_mod.saturating_drain(
                        lambda m: node.acquire(key, m, a, b), n)
                self.rejoin_debits += 1
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                # The node just rejoined; if it flaps again the breaker
                # owns it — the unreconciled grant stays inside the
                # envelope bound. Visible, not silent.
                self._note_scrape_error(j, exc)

        for pos in range(0, len(grants), self._REJOIN_CONCURRENCY):
            await asyncio.gather(*(
                one(*row)
                for row in grants[pos:pos + self._REJOIN_CONCURRENCY]))

    # -- routing -----------------------------------------------------------
    def node_index_of(self, key: str) -> int:
        """Index of the node that owns ``key`` under the current
        placement epoch — THE routing truth; every lane (scalar, bulk,
        blocking, submitter) and every external consumer (examples,
        benchmarks) goes through the map, never a modulus."""
        return int(self.placement.node_of(key))

    def node_of(self, key: str) -> BucketStore:
        """The node that owns ``key`` under the current placement epoch
        (every client holding the same epoch routes identically)."""
        return self.nodes[self.node_index_of(key)]

    # -- failure bookkeeping -------------------------------------------------
    def _note_node_error(self, j: int, exc: BaseException) -> None:
        """Every SERVING-path node failure funnels here: counter +
        structured log (event id 3) + breaker failure + flight-recorder
        frame. Nothing is silently swallowed (the old ``except: pass``
        posture). Diagnostics scrapes use :meth:`_note_scrape_error`
        instead — a failed scrape is visible but must not advance the
        breaker that gates admission traffic."""
        self._note_scrape_error(j, exc)
        if self._breakers is not None:
            self._breakers[j].record_failure()
        if self.flight_recorder is not None:
            self.flight_recorder.record("node_error", node=j,
                                        error=repr(exc))

    def _note_scrape_error(self, j: int, exc: BaseException) -> None:
        """Counter + log for a failed metrics/stats scrape (no breaker,
        no flight frame — see :meth:`_note_node_error`)."""
        self.node_errors[j] += 1
        log.cluster_node_error(j, exc)

    def _shed_or_fallback(self, j: int, fallback):
        """The quarantined-node decision: serve the degraded fallback
        when configured, else shed fast with a typed error."""
        if fallback is None or self._degraded is None:
            self.shed += 1
            raise NodeUnavailableError(
                f"cluster node {j} is quarantined (circuit open)")
        self.degraded_decisions += 1
        return fallback()

    async def _ping_node(self, j: int) -> bool:
        """Await node ``j``'s ping surface under the probe timeout.
        Returns False when the node has none (in-process nodes whose
        liveness is settled elsewhere); ping failures propagate."""
        ping = getattr(self.nodes[j], "ping", None)
        if not callable(ping):
            return False
        try:
            coro = ping(timeout_s=self._probe_timeout_s)
        except TypeError:  # in-process nodes: plain ping()
            coro = ping()
        await coro
        return True

    async def _probe(self, j: int) -> bool:
        """Half-open health probe: ping the node (nodes without a ping
        surface let the real request itself settle the probe). Returns
        whether the node may be used for the request that won the
        probe slot."""
        assert self._breakers is not None
        try:
            if not await self._ping_node(j):
                return True
        except asyncio.CancelledError:
            # Cancellation is no verdict on the node: free the slot so
            # the next caller probes instead of rejecting forever.
            self._breakers[j].release_probe()
            raise
        except Exception as exc:
            self._note_node_error(j, exc)  # records the breaker failure
            return False                   # → back to OPEN
        self._breakers[j].record_success()
        return True

    async def _guarded_call(self, j: int, call, fallback=None):
        """Run one node operation under the node's breaker: OPEN sheds
        (or serves the fallback), HALF_OPEN probes first, failures are
        noted (counter + log + breaker) and — when a fallback exists —
        absorbed into a degraded decision instead of an error."""
        br = self._breakers[j] if self._breakers is not None else None
        if br is not None:
            verdict = br.allow()
            if verdict == "probe" and not await self._probe(j):
                verdict = "reject"
            if verdict == "reject":
                return self._shed_or_fallback(j, fallback)
        try:
            res = await call()
        except asyncio.CancelledError:
            if br is not None:
                # The probe-winning request may be the one cancelled (a
                # ping-less node settles via the real call): free the
                # slot — no-op otherwise.
                br.release_probe()
            raise
        except Exception as exc:
            if (isinstance(exc, wire.RemoteStoreError)
                    and (MOVED_ERROR_PREFIX in str(exc)
                         or placement_mod.HANDOFF_DEFERRAL_PREFIX
                         in str(exc))):
                # Stale routing or a parked-key deferral mid-handoff:
                # the node is HEALTHY — no breaker advance, no degraded
                # absorption. _routed chases a move; a deferral clears
                # within one handoff window (a breaker trip here would
                # quarantine the node's whole keyspace as a side effect
                # of a routine migration).
                if br is not None:
                    br.record_success()
                raise
            self._note_node_error(j, exc)
            if fallback is not None and self._degraded is not None:
                self.degraded_decisions += 1
                return fallback()
            raise
        if br is not None:
            br.record_success()
        return res

    async def _routed(self, key: str, make_call, make_fallback=None):
        """Route ``key`` through the placement map, run the op under the
        node's breaker, and chase at most one placement move: a node
        answering the routable ``placement moved`` error means this
        client's map is stale — refetch and re-route once, then let the
        error surface (a second move mid-call is indistinguishable from
        a flapping coordinator)."""
        for attempt in (0, 1):
            j = self.node_index_of(key)
            try:
                if not self._resilient:
                    return await make_call(j)
                return await self._guarded_call(
                    j, lambda: make_call(j),
                    fallback=(None if make_fallback is None
                              else lambda: make_fallback(j)))
            except wire.RemoteStoreError as exc:
                if attempt == 0 and MOVED_ERROR_PREFIX in str(exc):
                    await self.refresh_placement()
                    if self.node_index_of(key) != j:
                        continue
                raise

    # -- blocking-surface plumbing ------------------------------------------
    def _ensure_loop(self) -> asyncio.AbstractEventLoop:
        loop = self._io_loop
        if loop is not None:
            return loop
        with self._thread_gate:
            if self._io_loop is None:
                loop = asyncio.new_event_loop()
                ready = threading.Event()

                def run() -> None:
                    asyncio.set_event_loop(loop)
                    ready.set()
                    loop.run_forever()

                t = threading.Thread(target=run, name="cluster-store-io",
                                     daemon=True)
                t.start()
                ready.wait()
                self._io_loop = loop
                self._io_thread = t
        return self._io_loop

    def _blocking(self, coro):
        return asyncio.run_coroutine_threadsafe(
            coro, self._ensure_loop()).result()

    # -- lifecycle ----------------------------------------------------------
    async def connect(self) -> None:
        """Eagerly connect every node (each node also lazily connects on
        first use, the reference's posture — this is for fail-fast setups)."""
        await asyncio.gather(*(n.connect() for n in self.nodes))

    async def aclose(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Background work (rejoin debits, placement refreshes) must not
        # outlive the clients it would call through. These are
        # concurrent futures on OUR I/O loop: cancel is thread-safe,
        # and anything already running dies with the loop teardown
        # below (never the caller's loop).
        for f in list(self._bg_tasks):
            f.cancel()
        # return_exceptions: one node's failed close must not skip the
        # others or leak the I/O loop thread below.
        outs = await asyncio.gather(*(n.aclose() for n in self.nodes),
                                    return_exceptions=True)
        loop = self._io_loop
        if loop is not None:
            loop.call_soon_threadsafe(loop.stop)
            if self._io_thread is not None:
                # to_thread: a 5s worst-case join must not stall the
                # CALLER's event loop (drl-check async-blocking).
                await asyncio.to_thread(self._io_thread.join, 5.0)
            # Close only a stopped loop: if the join timed out the loop
            # thread is still running, and loop.close() would raise
            # RuntimeError here — masking any node-close exception
            # collected above (the daemon thread dies with the process).
            if self._io_thread is None or not self._io_thread.is_alive():
                loop.close()
            self._io_loop = None
        for out in outs:
            if isinstance(out, BaseException):
                raise out

    # -- elastic membership / live migration (docs/OPERATIONS.md §9) --------
    @property
    def active_nodes(self) -> list[int]:
        """Node indices currently eligible to own slots (not drained)."""
        return [j for j in range(self.n_nodes) if j not in self.drained]

    async def refresh_placement(self) -> int:
        """Adopt the highest placement epoch any reachable node reports
        (the client half of the MOVED-redirect loop). A map naming node
        indices this client has no transport for is ignored — this
        client's topology must be extended (``add_node``) first."""
        async def one(j: int, node: BucketStore) -> "dict | None":
            fetch = getattr(node, "placement_fetch", None)
            if not callable(fetch):
                return None
            if self._breakers is not None \
                    and self._breakers[j].quarantined():
                return None  # don't stall a refresh behind a dead node
            try:
                return await fetch(timeout_s=self._probe_timeout_s)
            except Exception as exc:
                self._note_scrape_error(j, exc)
                return None

        # Concurrent fan-out: a stale-mapped caller's MOVED chase waits
        # one probe timeout, not one per node.
        payloads = await asyncio.gather(*(one(j, n) for j, n in
                                          enumerate(self.nodes)))
        best = self.placement
        for payload in payloads:
            if payload is None:
                continue
            if payload.get("epoch", -1) > best.epoch and "map" in payload:
                candidate = PlacementMap.from_dict(payload["map"])
                if max(candidate.nodes_in_use(), default=0) < self.n_nodes:
                    best = candidate
        self.placement = best
        return best.epoch

    async def _health_gate(self, j: int) -> None:
        """A node must prove liveness before taking ownership (the
        health-gated-membership posture): its breaker must not be open,
        and its ping must answer inside the probe timeout."""
        if self._breakers is not None and self._breakers[j].quarantined():
            raise PlacementError(
                f"node {j} is quarantined (circuit open); it cannot "
                "take ownership")
        try:
            await self._ping_node(j)
        except Exception as exc:
            if self._breakers is not None:
                self._breakers[j].record_failure()
            raise PlacementError(
                f"node {j} failed its health probe: {exc!r}") from exc

    async def _announce_to(self, j: int, payload: dict,
                           strict: bool) -> None:
        node = self.nodes[j]
        ann = getattr(node, "placement_announce", None)
        if not callable(ann):
            return  # in-process node: client-side routing only
        try:
            await ann(payload)
        except Exception as exc:
            self._note_scrape_error(j, exc)
            if strict:
                raise

    def _keep_for(self, slots: "set[int]", keys: "set[str]"):
        # One shared selection rule with the server-side pull — the two
        # lanes diverging here is exactly the drive-caught class of bug.
        return placement_mod.keep_predicate(
            self.placement.n_slots, self.placement.overrides, slots, keys)

    async def _pull_from(self, src: int, slots: "list[int]",
                         keys: "list[str]", target_epoch: int
                         ) -> "dict | None":
        """One source's export: the wire pull for remote nodes (parks +
        debits server-side), a direct snapshot extract for in-process
        ones. ``None`` = the source is unreachable — the dead-leave
        case: its state is lost and the new owners serve init-on-miss
        (the reference's wiped-state posture, now scoped to one node)."""
        node = self.nodes[src]
        req = {"target_epoch": target_epoch,
               "window_s": self._handoff_window_s}
        if slots:
            req["slots"] = slots
        if keys:
            req["keys"] = keys
        pull = getattr(node, "migrate_pull", None)
        try:
            if callable(pull):
                out = await pull(req)
                entries = out.get("entries") or {}
                # Paged reply: a big export chunks server-side so every
                # frame fits MAX_FRAME; pages 1..N-1 come from the
                # handoff cache (idempotent — retries included).
                for page in range(1, int(out.get("pages", 1))):
                    more = await pull({**req, "page": page})
                    entries = placement_mod.merge_entries(
                        entries, more.get("entries") or {})
                return entries
            if hasattr(node, "snapshot"):
                # In-process lane: balances ship EXACTLY (no envelope —
                # there is no server-side park to serve one from), and
                # the source is drained of the shipped amount in the
                # same breath so a task interleaving between this pull
                # and the commit cannot spend a balance the new owner
                # already received (the remote lane's debit_source
                # contract, keep_envelope=False).
                # to_thread mirrors the server-side pull: a device
                # store's snapshot() pulls whole slot arrays to host —
                # run it off-loop so the export never stalls the
                # coordinator's serving path.
                entries = await asyncio.to_thread(
                    placement_mod._export_from_store,
                    node, self._keep_for(set(slots), set(keys)))
                await placement_mod.debit_source(
                    node, entries,
                    placement_mod.DEFAULT_ENVELOPE_FRACTION,
                    keep_envelope=False)
                return entries
        except (ConnectionError, OSError, asyncio.TimeoutError,
                NodeUnavailableError) as exc:
            self._note_node_error(src, exc)
            # Ambiguity guard: a timed-out/reset pull may still have
            # EXECUTED (parking + debiting the source). Declaring state
            # lost is only sound when the node is actually dead — so
            # probe it. Alive ⇒ abort the migration instead (the parked
            # state unparks on the abort announce, or self-heals at
            # window expiry); truly dead ⇒ init-on-miss is all there is.
            try:
                alive = await self._ping_node(src)
            except asyncio.CancelledError:
                raise
            # The probe failing IS the verdict (node dead ⇒ state
            # genuinely lost); the pull failure was counted above.
            # drl-check: ok(swallowed-exception)
            except Exception:
                alive = False
            if alive:
                raise PlacementError(
                    f"pull from node {src} failed ({exc!r}) but the "
                    "node is alive — aborting rather than guessing "
                    "its state was lost") from exc
            return None
        return {}

    async def _apply_placement(self, target: PlacementMap,
                               moves: "Mapping[int, int]",
                               moved_keys: "Mapping[str, int] | None" = None,
                               reason: str = "rebalance") -> None:
        """One membership change, end to end: health-gate the new
        owners, pull (park + debit) from the old ones, push the state
        batches, then commit by announcing the target epoch — new owners
        first, old owners last, so at every instant each key has at
        least one node willing to serve it (authoritatively, or from the
        old owner's bounded envelope). Any pre-commit failure aborts
        cleanly back to the old epoch (the parked state unparks); the
        soak asserts every migration lands in exactly one of those two
        states. Callers hold ``_membership_lock``."""
        moved_keys = dict(moved_keys or {})
        src_of_slot = {int(s): int(self.placement.slot_owner[s])
                       for s in moves}
        key_src = {k: self.node_index_of(k) for k in moved_keys}
        dsts = set(moves.values()) | set(moved_keys.values())
        # A node may be both (slots in, slots out on one rebalance).
        srcs = set(src_of_slot.values()) | set(key_src.values())
        event = {
            "type": "migrate", "reason": reason,
            "from_epoch": self.placement.epoch,
            "target_epoch": target.epoch,
            "moves": {int(s): int(d) for s, d in moves.items()},
            "keys": {k: int(d) for k, d in moved_keys.items()},
            "t_start": time.monotonic(),
        }
        try:
            # Inside the try: an injected fault here must take the abort
            # path (typed PlacementError, bookkeeping, callers' drained-
            # set rollback), not escape as a raw FaultInjectedError.
            await faults.seam("cluster.migrate")
            for j in sorted(dsts):
                await self._health_gate(j)
            if not self._announced:
                # Bootstrap: nodes must hold the CURRENT map before any
                # pull (the gate and slot arithmetic need it). Strict
                # only for destinations — a DEAD source is the
                # unplanned-leave case, and its pull below degrades to
                # state-lost rather than blocking the drain.
                for j in range(self.n_nodes):
                    await self._announce_to(
                        j, {"map": self.placement.to_dict(),
                            "node_id": j},
                        strict=(j in dsts))
                self._announced = True
            pulls: dict[int, dict] = {}
            lost: list[int] = []
            for src in sorted(srcs):
                slots = [s for s, owner in src_of_slot.items()
                         if owner == src]
                keys = [k for k, owner in key_src.items()
                        if owner == src]
                if not slots and not keys:
                    continue
                await faults.seam("cluster.migrate")
                entries = await self._pull_from(src, slots, keys,
                                                target.epoch)
                if entries is None:
                    lost.append(src)
                elif placement_mod.entry_count(entries):
                    pulls[src] = entries
            if lost:
                event["state_lost_from"] = lost
            for src, entries in pulls.items():
                per_dst = placement_mod.split_entries(entries,
                                                      target.node_of)
                for dst, sub in sorted(per_dst.items()):
                    if dst == src:
                        continue  # state already lives there
                    node = self.nodes[dst]
                    push = getattr(node, "migrate_push", None)
                    for bid, chunk in enumerate(
                            placement_mod.chunk_entries(sub)):
                        await faults.seam("cluster.migrate")
                        if callable(push):
                            # Batch ids are the receiver's exactly-once
                            # dedup unit — namespace them by SOURCE so
                            # two sources' chunk 0 never collide.
                            await push({"target_epoch": target.epoch,
                                        "batch": (src << 20) | bid,
                                        "entries": chunk})
                        else:
                            await placement_mod.import_entries(node,
                                                               chunk)
        except Exception as exc:
            # Clean abort to the old epoch: unpark every pulled source
            # AND clear every destination's push ledger for the dead
            # target epoch — a retried migration reuses it, and stale
            # dedup entries would silently drop the retry's batches.
            for j in sorted(srcs | dsts):
                await self._announce_to(
                    j, {"abort_epoch": target.epoch}, strict=False)
            event.update(type="abort", error=repr(exc),
                         t_end=time.monotonic())
            self.migration_aborts += 1
            self._log_migration(event)
            if isinstance(exc, PlacementError):
                raise
            raise PlacementError(
                f"migration to epoch {target.epoch} aborted: "
                f"{exc!r}") from exc
        # Commit: destinations adopt first (they start serving the
        # moment a client learns the epoch), sources last (their parked
        # state drops and 'moved' answers take over), bystanders after.
        order = (sorted(dsts) + [j for j in sorted(srcs)
                                 if j not in dsts]
                 + [j for j in range(self.n_nodes)
                    if j not in dsts and j not in srcs])
        commit_errors = 0
        for j in order:
            try:
                await faults.seam("cluster.migrate")
                await self._announce_to(
                    j, {"map": target.to_dict(), "node_id": j},
                    strict=False)
            except Exception as exc:
                # Past the point of no return (state batches applied):
                # the commit presses on. A straggler node keeps the old
                # epoch until it answers a request with 'placement
                # moved' or the next announce reaches it; visible here,
                # in the event record, and in the node-error counter.
                commit_errors += 1
                self._note_scrape_error(j, exc)
        self.placement = target
        self.migrations += 1
        event.update(type="commit", t_end=time.monotonic(),
                     commit_errors=commit_errors)
        self._log_migration(event)

    _MIGRATION_LOG_CAP = 512

    def _log_migration(self, event: dict) -> None:
        self.migration_log.append(event)
        if len(self.migration_log) > self._MIGRATION_LOG_CAP:
            del self.migration_log[: -self._MIGRATION_LOG_CAP]
        log.cluster_migration(event)

    async def rebalance(self, reason: str = "rebalance") -> int:
        """Even slot ownership over the active nodes, migrating state
        along. No-op (same epoch) when already balanced."""
        async with self._membership_lock:
            return await self._rebalance_locked(reason)

    async def _rebalance_locked(self, reason: str) -> int:
        if not self._announced:
            # A fresh coordinator may be attaching to an already-
            # resharded fleet: adopt the fleet's highest epoch BEFORE
            # computing a target, or the bootstrap announce below would
            # push a stale map (and the destinations would rightly
            # refuse it as stale, wedging every membership op until
            # someone called refresh_placement by hand).
            await self.refresh_placement()
        active = self.active_nodes
        moves = self.placement.rebalance_moves(active)
        # Overrides pinned to a drained node follow the rebalance too.
        stranded = {k: j for k, j in self.placement.overrides.items()
                    if j not in active}
        if not moves and not stranded:
            return self.placement.epoch
        counts = self.placement.slot_counts(self.n_nodes)
        moved_keys = {k: min(active, key=lambda a: counts[a])
                      for k in stranded}
        target = self.placement.with_assignments(
            moves, set_overrides=moved_keys or None)
        await self._apply_placement(target, moves, moved_keys, reason)
        return target.epoch

    async def add_node(self, store: "BucketStore | None" = None, *,
                       address: "tuple[str, int] | None" = None,
                       url: "str | None" = None,
                       rebalance: bool = True) -> int:
        """Join: append a node (same config ladder as the constructor),
        health-gate it, and — unless ``rebalance=False`` — migrate an
        even share of slots (with their state) onto it. Returns the new
        node's index. Node indices are stable identities: the list only
        ever appends."""
        if store is not None:
            node: BucketStore = store
        elif address is not None:
            node = RemoteBucketStore(address=address,
                                     **self._remote_kwargs)
        elif url is not None:
            node = RemoteBucketStore(url=url, **self._remote_kwargs)
        else:
            raise ValueError("one of store, address, or url is required")
        async with self._membership_lock:
            j = self.n_nodes
            self.nodes.append(node)
            self.n_nodes += 1
            self.node_errors.append(0)
            if self._breakers is not None:
                self._breakers.append(self._make_breaker(
                    j, self._breaker_config, self._breaker_clock))
            self._registry = None  # per-node families re-enumerate lazily
            try:
                await self._health_gate(j)
            except PlacementError:
                self.drained.add(j)  # joined but unfit: owns nothing yet
                raise
            if rebalance:
                await self._rebalance_locked(reason=f"join:{j}")
            return j

    async def drain_node(self, j: int) -> int:
        """Planned leave: migrate node ``j``'s slots (and their state)
        to the survivors, then stop routing to it. The node object stays
        in ``nodes`` — indices are identities — and ``rejoin_node``
        folds it back in."""
        if not 0 <= j < self.n_nodes:
            raise ValueError(f"no node {j}")
        async with self._membership_lock:
            if len(self.active_nodes) <= 1 and j in self.active_nodes:
                raise PlacementError(
                    "cannot drain the last active node")
            self.drained.add(j)
            try:
                return await self._rebalance_locked(reason=f"drain:{j}")
            except PlacementError:
                self.drained.discard(j)  # the drain never happened
                raise

    async def rejoin_node(self, j: int) -> int:
        """Fold a drained node back into the slot table (health-gated),
        migrating an even share of slots back onto it."""
        async with self._membership_lock:
            if j not in self.drained:
                return self.placement.epoch
            await self._health_gate(j)
            self.drained.discard(j)
            try:
                return await self._rebalance_locked(reason=f"rejoin:{j}")
            except PlacementError:
                self.drained.add(j)
                raise

    async def replace_node(self, j: int, *,
                           address: "tuple[str, int] | None" = None,
                           store: "BucketStore | None" = None) -> None:
        """The rolling-restart "LB switch": swap node ``j``'s transport
        for its restarted successor. The INDEX — the placement identity
        — keeps its slots, so no map change and no migration happens
        here; the state itself rode the drain-and-handoff shutdown
        (``BucketStoreServer.shutdown(successor=…)``) or the restarted
        process's checkpoint restore (docs/OPERATIONS.md §10). The
        successor is health-gated before it takes the slot (its breaker
        is rebuilt closed); on a failed gate the old transport stays —
        a botched restart must not unseat a still-working node."""
        if not 0 <= j < self.n_nodes:
            raise ValueError(f"no node {j}")
        if (address is None) == (store is None):
            raise ValueError("exactly one of address= / store= required")
        new = store if store is not None else RemoteBucketStore(
            address=address, **self._remote_kwargs)
        async with self._membership_lock:
            old = self.nodes[j]
            self.nodes[j] = new
            try:
                await self._health_gate(j)
            except PlacementError:
                self.nodes[j] = old
                aclose = getattr(new, "aclose", None)
                if callable(aclose) and store is None:
                    await aclose()
                raise
            if self._breakers is not None:
                # Fresh breaker, born closed: the restart gap's failures
                # belong to the RETIRED transport, not the successor.
                self._breakers[j] = self._make_breaker(
                    j, self._breaker_config, self._breaker_clock)
            await self._replay_config_to(j)
        aclose = getattr(old, "aclose", None)
        if callable(aclose):
            try:
                await aclose()
            except Exception as exc:
                self._note_scrape_error(j, exc)

    async def _replay_config_to(self, j: int) -> None:
        """Hand a (re)joining node the fleet's committed live-config
        rules (the restart-survival half of mutate_config): fetch the
        highest-version snapshot any OTHER node holds and adopt it onto
        node ``j``. Idempotent and version-monotonic server-side, so a
        duplicate replay is a no-op; a node restored from its
        predecessor's drain already adopted the same rules there."""
        ann = getattr(self.nodes[j], "config_announce", None)
        if not callable(ann):
            return
        best: "dict | None" = None
        for i, node in enumerate(self.nodes):
            if i == j:
                continue
            fetch = getattr(node, "config_fetch", None)
            if not callable(fetch):
                continue
            try:
                payload = await fetch(timeout_s=self._probe_timeout_s)
            except Exception as exc:
                self._note_scrape_error(i, exc)
                continue
            if best is None or int(payload.get("version", 0)) > \
                    int(best.get("version", 0)):
                best = payload
        if best and int(best.get("version", 0)) > 0:
            try:
                await ann({"adopt": best})
            except Exception as exc:
                # Visible, not fatal: the node serves; a stale gate is
                # re-replayed by the next membership op or mutation.
                self._note_scrape_error(j, exc)

    async def split_hot_key(self, key: str,
                            target: "int | None" = None) -> int:
        """Hot-shard split: pin one key to its own node via a placement
        override, migrating its state along — the heavy-hitter sketch's
        top-K is the feed (:meth:`split_hot_keys`). Returns the node the
        key now lives on."""
        async with self._membership_lock:
            if not self._announced:
                await self.refresh_placement()  # see _rebalance_locked
            src = self.node_index_of(key)
            if target is None:
                counts = self.placement.slot_counts(self.n_nodes)
                candidates = [j for j in self.active_nodes if j != src]
                if not candidates:
                    return src  # nowhere to split to
                target = min(candidates, key=lambda a: int(counts[a]))
            if target == src:
                return src
            if target in self.drained:
                raise PlacementError(f"node {target} is drained")
            new_map = self.placement.with_assignments(
                set_overrides={key: target})
            await self._apply_placement(new_map, {}, {key: target},
                                        reason=f"hot-split:{key!r}")
            return target

    async def split_hot_keys(self, top_n: int = 1,
                             min_count: float = 0.0) -> list[str]:
        """Consult every node's heavy-hitter sketch (OP_STATS
        ``hot_keys``) and split the fleet-wide top ``top_n`` keys that
        are not already overrides. Returns the keys split.

        Sketch offers are COST-weighted on every lane (an N-token
        admission weighs N — utils/heavy_hitters.py), so the ranking
        here is admitted TOKENS, not request count: a key taking few
        huge-cost requests is as much a split candidate as one taking
        many small ones, and ``min_count`` is a token threshold. The
        per-tenant tokens/sec companion signal is OP_STATS
        ``token_velocity`` / ``drl_token_velocity``."""
        scores: dict[str, float] = {}
        st = await self.stats()
        for node_stats in st["nodes"]:
            for row in (node_stats.get("hot_keys") or {}).get("top", ()):
                scores[row["key"]] = scores.get(row["key"], 0.0) \
                    + float(row["count"])
        ranked = sorted(scores.items(), key=lambda kv: -kv[1])
        split: list[str] = []
        for key, count in ranked:
            if len(split) >= top_n:
                break
            if count < min_count or key in self.placement.overrides:
                continue
            await self.split_hot_key(key)
            # split_hot_key no-ops when there is nowhere to split to
            # (single active node): only report keys actually pinned,
            # or automation would claim an isolation that never
            # happened — and re-claim it on every invocation.
            if key in self.placement.overrides:
                split.append(key)
        return split

    # -- live config mutation (docs/OPERATIONS.md §10) -----------------------
    async def mutate_config(self, kind: str,
                            old: "tuple[float, float]",
                            new: "tuple[float, float]") -> int:
        """Cluster-wide live limit mutation: rewrite every node's
        ``(kind, old) → new`` config in place — balances carried through
        the epoch-rebase (runtime/liveconfig.py) — with no restart.

        Two-phase under the coordinator lock, the placement plane's
        discipline: **prepare** stages the rule on every node (pure
        validation — any failure aborts the whole mutation cleanly back
        to the old version, nothing served differently anywhere), then
        **commit** flips the gates in node order (first node → rest;
        from each node's flip, its stale traffic chases one routable
        "config moved" error onto the new config). The target version
        adopts the fleet's highest committed version + 1, so a fresh
        coordinator attaching to an already-mutated fleet can't go
        backwards — and a re-sent prepare/commit is idempotent at its
        version, making the whole op post-send-retry-safe
        (``_IDEMPOTENT_OPS``).

        In-process nodes (no wire, no gate) rebase directly at their
        commit position; their callers see the new config the moment
        this returns. Returns the committed config version."""
        from distributedratelimiting.redis_tpu_torch.runtime import liveconfig

        rule = liveconfig.ConfigRule(kind, tuple(old), tuple(new))
        async with self._membership_lock:
            # Adopt the fleet's highest committed version (reachable
            # nodes only — a dead node catches up via re-prepare when
            # the operator re-runs the mutation after its restart).
            best = 0
            for j, node in enumerate(self.nodes):
                fetch = getattr(node, "config_fetch", None)
                if not callable(fetch):
                    continue
                try:
                    payload = await fetch(
                        timeout_s=self._probe_timeout_s)
                    best = max(best, int(payload.get("version", 0)))
                except Exception as exc:
                    self._note_scrape_error(j, exc)
            version = best + 1
            event = {"type": "config", "kind": kind,
                     "old": list(rule.old), "new": list(rule.new),
                     "version": version, "t_start": time.monotonic()}
            wired = [j for j, n in enumerate(self.nodes)
                     if callable(getattr(n, "config_announce", None))]
            try:
                await faults.seam("cluster.config")
                # Phase 1 — prepare everywhere, strictly: a node that
                # cannot stage the rule vetoes the mutation while the
                # old config still serves everywhere.
                for j in wired:
                    await self.nodes[j].config_announce(
                        {"prepare": rule.to_dict(), "version": version})
            except Exception as exc:
                for j in wired:
                    try:
                        await self.nodes[j].config_announce(
                            {"abort": version})
                    except Exception as abort_exc:
                        self._note_scrape_error(j, abort_exc)
                event.update(type="config_abort", error=repr(exc),
                             t_end=time.monotonic())
                self.config_aborts += 1
                self._log_migration(event)
                if isinstance(exc, liveconfig.ConfigError):
                    raise
                raise liveconfig.ConfigError(
                    f"config mutation to version {version} aborted: "
                    f"{exc!r}") from exc
            # Phase 2 — commit, first node → rest. Past the first
            # successful flip the mutation presses on (a straggler keeps
            # serving the old table until the operator re-runs the
            # mutation — visible in the event record, never silent).
            commit_errors = 0
            for j in wired:
                try:
                    await self.nodes[j].config_announce(
                        {"commit": version})
                except Exception as exc:
                    commit_errors += 1
                    self._note_scrape_error(j, exc)
            for j, node in enumerate(self.nodes):
                if j in wired:
                    continue
                try:
                    self.config_rebased_rows += \
                        await liveconfig._rebase_state(node, rule)
                except asyncio.CancelledError:
                    raise
                except Exception as exc:
                    # Past the point of no return (wired nodes already
                    # committed): ANY rebase failure — not just the
                    # typed enumeration one — degrades to init-on-miss
                    # for this node's keys, counted + logged, never an
                    # exception out of a mutation the fleet committed.
                    commit_errors += 1
                    self._note_scrape_error(j, exc)
            self.config_mutations += 1
            event.update(type="config_commit", t_end=time.monotonic(),
                         commit_errors=commit_errors)
            self._log_migration(event)
            return version

    # -- single-key ops: route, guard, forward -------------------------------
    async def acquire(self, key: str, count: int, capacity: float,
                      fill_rate_per_sec: float) -> AcquireResult:
        return await self._routed(
            key,
            lambda j: self.nodes[j].acquire(key, count, capacity,
                                            fill_rate_per_sec),
            lambda j: self._degraded.acquire(
                j, key, count, capacity, fill_rate_per_sec, "bucket"))

    def acquire_blocking(self, key: str, count: int, capacity: float,
                         fill_rate_per_sec: float) -> AcquireResult:
        if self._resilient:
            return self._blocking(self.acquire(key, count, capacity,
                                               fill_rate_per_sec))
        return self.node_of(key).acquire_blocking(key, count, capacity,
                                                  fill_rate_per_sec)

    # -- hierarchical tenant → key admission (runtime/admission.py) ----------
    def _degraded_hier(self, j: int, tenant: str, key: str, count: int,
                       tcap: float, trate: float, cap: float,
                       rate: float, priority: int) -> AcquireResult:
        """Two-level degraded fallback for a quarantined tenant node:
        tenant envelope then key envelope, grant iff both, priority
        shed order applied at both levels via the shared gate (a
        tenant-envelope debit on a key deny stays debited — envelope
        over-conservatism, the safe direction)."""
        par = self._degraded.acquire(j, tenant, count, tcap, trate,
                                     "bucket", priority)
        if not par.granted:
            return AcquireResult(False, par.remaining)
        ch = self._degraded.acquire(j, key, count, cap, rate,
                                    "bucket", priority)
        return AcquireResult(ch.granted,
                             min(par.remaining, ch.remaining))

    async def acquire_hierarchical(self, tenant: str, key: str,
                                   count: int, tenant_capacity: float,
                                   tenant_fill_rate_per_sec: float,
                                   capacity: float,
                                   fill_rate_per_sec: float, *,
                                   priority: int = 0) -> AcquireResult:
        """Routed by TENANT, not key: the parent tenant bucket must
        live whole on one node (a per-node split would multiply the
        tenant's budget by the node count), so a tenant's hierarchical
        admission — and its keys' child buckets — all land on the
        tenant's owner under the placement map. The degraded fallback
        honors the priority shed order (scavenger sheds first)."""
        return await self._routed(
            tenant,
            lambda j: self.nodes[j].acquire_hierarchical(
                tenant, key, count, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority),
            lambda j: self._degraded_hier(
                j, tenant, key, count, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority))

    def acquire_hierarchical_blocking(self, tenant: str, key: str,
                                      count: int,
                                      tenant_capacity: float,
                                      tenant_fill_rate_per_sec: float,
                                      capacity: float,
                                      fill_rate_per_sec: float, *,
                                      priority: int = 0) -> AcquireResult:
        if self._resilient:
            return self._blocking(self.acquire_hierarchical(
                tenant, key, count, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority))
        return self.node_of(tenant).acquire_hierarchical_blocking(
            tenant, key, count, tenant_capacity,
            tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
            priority=priority)

    async def acquire_hierarchical_many(self, tenants, keys, counts,
                                        tenant_capacity: float,
                                        tenant_fill_rate_per_sec: float,
                                        capacity: float,
                                        fill_rate_per_sec: float, *,
                                        with_remaining: bool = True,
                                        priority: int = 0
                                        ) -> "BulkAcquireResult":
        """Bulk hierarchical: rows fan out BY TENANT (each tenant's
        group is one node's call — see :meth:`acquire_hierarchical`),
        results scatter back in row order. Quarantined groups serve the
        two-level degraded envelope row-by-row."""
        n = len(keys)
        granted = np.zeros(n, bool)
        remaining = (np.zeros(n, np.float32) if with_remaining
                     else None)
        counts_np = np.asarray(counts, np.int64)
        by_tenant: dict[str, list[int]] = {}
        for i, t in enumerate(tenants):
            by_tenant.setdefault(t, []).append(i)

        async def one_tenant(tenant: str, idx: list[int]):
            sub_keys = [keys[i] for i in idx]
            sub_counts = counts_np[idx]

            def fallback(j):
                g = np.zeros(len(sub_keys), bool)
                r = np.zeros(len(sub_keys), np.float32)
                for i2, (k, c) in enumerate(zip(sub_keys, sub_counts)):
                    res = self._degraded_hier(
                        j, tenant, k, int(c), tenant_capacity,
                        tenant_fill_rate_per_sec, capacity,
                        fill_rate_per_sec, priority)
                    g[i2] = res.granted
                    r[i2] = res.remaining
                return BulkAcquireResult(g, r)

            return await self._routed(
                tenant,
                lambda j: self.nodes[j].acquire_hierarchical_many(
                    [tenant] * len(sub_keys), sub_keys, sub_counts,
                    tenant_capacity, tenant_fill_rate_per_sec,
                    capacity, fill_rate_per_sec,
                    with_remaining=with_remaining, priority=priority),
                fallback)

        # Tenant groups fan out concurrently (the flat bulk lane's
        # posture): one call's wall clock is the slowest node, not the
        # sum over tenants. Distinct tenants' decisions are independent.
        groups = list(by_tenant.items())
        results = await asyncio.gather(
            *(one_tenant(t, idx) for t, idx in groups))
        for (_t, idx), res in zip(groups, results):
            granted[idx] = res.granted
            if remaining is not None and res.remaining is not None:
                remaining[idx] = res.remaining
        return BulkAcquireResult(granted, remaining)

    # -- estimate-reserve-settle (runtime/reservations.py) -------------------
    async def reserve(self, rid: str, tenant: str, key: str,
                      estimate: "float | None",
                      tenant_capacity: float,
                      tenant_fill_rate_per_sec: float,
                      capacity: float, fill_rate_per_sec: float, *,
                      priority: int = 0,
                      ttl_s: "float | None" = None,
                      attempt: int = 0,
                      deadline_s: "float | None" = None):
        """Routed by TENANT like every hierarchical lane (the ledger
        entry must live with the tenant's owner so its settle finds
        it). The degraded fallback admits the estimate through the
        two-level envelope — bounded availability with NO hold (the
        quarantined owner's ledger is unreachable); the eventual
        settle answers the counted "unknown" no-op, conservative."""
        from distributedratelimiting.redis_tpu_torch.runtime.reservations import (
            ReserveResult,
            fallback_charge,
        )

        charge = fallback_charge(estimate)

        def fallback(j):
            res = self._degraded_hier(
                j, tenant, key, charge, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority)
            return ReserveResult(res.granted,
                                 float(charge) if res.granted else 0.0,
                                 res.remaining, 0.0, fallback=True)

        return await self._routed(
            tenant,
            lambda j: self.nodes[j].reserve(
                rid, tenant, key, estimate, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority, ttl_s=ttl_s, attempt=attempt,
                deadline_s=deadline_s),
            fallback)

    async def settle(self, rid: str, tenant: str, actual: float):
        """Settle routes to the tenant's owner (one MOVED chase like
        every keyed lane — the op is idempotent by rid, so the re-send
        after a placement refresh is safe). No degraded fallback: a
        settle against a quarantined owner surfaces the typed
        unavailability and the caller retries after rejoin — the TTL
        auto-settle bounds how long an unreachable ledger can hold."""
        return await self._routed(
            tenant,
            lambda j: self.nodes[j].settle(rid, tenant, actual))

    def peek_blocking(self, key: str, capacity: float,
                      fill_rate_per_sec: float) -> float:
        # No degraded value exists for a peek — it reports the
        # AUTHORITATIVE balance; a quarantined node surfaces the typed
        # shed error instead of a made-up number.
        for attempt in (0, 1):
            j = self.node_index_of(key)
            if self._breakers is not None \
                    and self._breakers[j].quarantined():
                self.shed += 1
                raise NodeUnavailableError(
                    f"cluster node {j} is quarantined (circuit open)")
            try:
                return self.nodes[j].peek_blocking(key, capacity,
                                                   fill_rate_per_sec)
            except wire.RemoteStoreError as exc:
                # Same one-MOVED chase as every other keyed lane: a
                # balance monitor doing only peeks must still converge
                # a stale map after a migration.
                if attempt == 0 and MOVED_ERROR_PREFIX in str(exc):
                    self._blocking(self.refresh_placement())
                    if self.node_index_of(key) != j:
                        continue
                raise

    def acquire_submitter(self, capacity: float, fill_rate_per_sec: float):
        if self._resilient:
            # The guarded path costs a route + breaker check per
            # request; resilience was asked for explicitly.
            async def submit(key: str, count: int) -> AcquireResult:
                return await self.acquire(key, count, capacity,
                                          fill_rate_per_sec)

            return submit
        # Hoist per-node submitters once; per request only the route
        # runs. A node that joins after the hoist gets its submitter
        # lazily — the list only ever appends (indices are stable).
        subs = [n.acquire_submitter(capacity, fill_rate_per_sec)
                for n in self.nodes]

        async def submit(key: str, count: int) -> AcquireResult:
            # Same one-MOVED chase as _routed: the fast lane must still
            # converge a stale map, or every call for a migrated key
            # fails forever. The refresh costs only on the error path.
            for attempt in (0, 1):
                j = self.node_index_of(key)
                while j >= len(subs):
                    subs.append(self.nodes[len(subs)].acquire_submitter(
                        capacity, fill_rate_per_sec))
                try:
                    return await subs[j](key, count)
                except wire.RemoteStoreError as exc:
                    if attempt == 0 and MOVED_ERROR_PREFIX in str(exc):
                        await self.refresh_placement()
                        if self.node_index_of(key) != j:
                            continue
                    raise

        return submit

    async def sync_counter(self, key: str, local_count: float,
                           decay_rate_per_sec: float) -> SyncResult:
        # No fallback on purpose: the approximate limiter OWNS its
        # degraded mode (keep serving from the last-known global score);
        # it needs the error, not a made-up sync result.
        return await self._routed(
            key, lambda j: self.nodes[j].sync_counter(
                key, local_count, decay_rate_per_sec))

    def sync_counter_blocking(self, key: str, local_count: float,
                              decay_rate_per_sec: float) -> SyncResult:
        if self._resilient:
            return self._blocking(self.sync_counter(key, local_count,
                                                    decay_rate_per_sec))
        return self.node_of(key).sync_counter_blocking(key, local_count,
                                                       decay_rate_per_sec)

    async def window_acquire(self, key: str, count: int, limit: float,
                             window_sec: float) -> AcquireResult:
        return await self._routed(
            key,
            lambda j: self.nodes[j].window_acquire(key, count, limit,
                                                   window_sec),
            lambda j: self._degraded.acquire(
                j, key, count, limit, limit / window_sec, "window"))

    def window_acquire_blocking(self, key: str, count: int, limit: float,
                                window_sec: float) -> AcquireResult:
        if self._resilient:
            return self._blocking(self.window_acquire(key, count, limit,
                                                      window_sec))
        return self.node_of(key).window_acquire_blocking(key, count, limit,
                                                         window_sec)

    async def fixed_window_acquire(self, key: str, count: int, limit: float,
                                   window_sec: float) -> AcquireResult:
        return await self._routed(
            key,
            lambda j: self.nodes[j].fixed_window_acquire(
                key, count, limit, window_sec),
            lambda j: self._degraded.acquire(
                j, key, count, limit, limit / window_sec, "fwindow"))

    def fixed_window_acquire_blocking(self, key: str, count: int,
                                      limit: float,
                                      window_sec: float) -> AcquireResult:
        if self._resilient:
            return self._blocking(self.fixed_window_acquire(
                key, count, limit, window_sec))
        return self.node_of(key).fixed_window_acquire_blocking(
            key, count, limit, window_sec)

    async def concurrency_acquire(self, key: str, count: int,
                                  limit: int) -> AcquireResult:
        # Semaphores are strict: a made-up degraded grant could exceed
        # the concurrency limit the moment the node returns. Deny.
        return await self._routed(
            key,
            lambda j: self.nodes[j].concurrency_acquire(key, count,
                                                        limit),
            lambda j: AcquireResult(False, 0.0))

    def concurrency_acquire_blocking(self, key: str, count: int,
                                     limit: int) -> AcquireResult:
        if self._resilient:
            return self._blocking(self.concurrency_acquire(key, count,
                                                           limit))
        return self.node_of(key).concurrency_acquire_blocking(key, count,
                                                              limit)

    async def concurrency_release(self, key: str, count: int) -> None:
        # A release against a quarantined node is absorbed (None): the
        # node's semaphore state resets with it anyway (init-on-miss).
        await self._routed(
            key, lambda j: self.nodes[j].concurrency_release(key, count),
            lambda j: None)

    def concurrency_release_blocking(self, key: str, count: int) -> None:
        if self._resilient:
            self._blocking(self.concurrency_release(key, count))
            return
        self.node_of(key).concurrency_release_blocking(key, count)

    # -- bulk ops: split by route, fan out, merge ---------------------------
    def _split(self, keys: Sequence[str]):
        """Group a bulk call by owning node, order-stably.

        Returns ``(order, bounds, keys_list)`` where ``order`` is a stable
        permutation grouping requests by node and ``bounds[j]:bounds[j+1]``
        slices node ``j``'s group. Stability keeps each node's sub-batch in
        arrival order, so per-node duplicate serialization is exactly the
        single-node bulk semantics.
        """
        keys = keys if isinstance(keys, list) else list(keys)
        # One native crc32 pass over the slot table, then the placement
        # take — the map (not a modulus) is the routing truth.
        routes = self.placement.route(keys)
        order = np.argsort(routes, kind="stable")
        bounds = np.searchsorted(routes[order],
                                 np.arange(self.n_nodes + 1))
        return order, bounds, keys

    def _bulk_degraded(self, j: int, sub_keys, sub_counts,
                       degraded_row) -> BulkAcquireResult:
        """Serve one node's bulk rows from the degraded fallback (a
        Python loop — this is the outage path, not the hot path)."""
        n = len(sub_keys)
        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32)
        for i, (k, c) in enumerate(zip(sub_keys, sub_counts)):
            res = degraded_row(j, k, int(c))
            granted[i] = res.granted
            remaining[i] = res.remaining
        self.degraded_decisions += n
        return BulkAcquireResult(granted, remaining)

    def _bulk_reject(self, j: int, sub_keys, sub_counts, degraded_row
                     ) -> "BulkAcquireResult | None":
        """A quarantined node's bulk group: degraded rows when possible,
        else the partial_failures contract ('deny' → None, rows stay
        denied; 'raise' → typed shed error)."""
        if degraded_row is not None and self._degraded is not None:
            return self._bulk_degraded(j, sub_keys, sub_counts,
                                       degraded_row)
        self.shed += len(sub_keys)
        if self._partial_failures == "raise":
            raise NodeUnavailableError(
                f"cluster node {j} is quarantined (circuit open)")
        return None

    async def _bulk_fan_out(self, keys, counts, call, with_remaining: bool,
                            degraded_row=None) -> BulkAcquireResult:
        n = len(keys)
        if n == 0:
            return BulkAcquireResult(
                np.zeros(0, bool),
                np.zeros(0, np.float32) if with_remaining else None)
        counts_np = np.asarray(counts, np.int64)
        if self.n_nodes == 1 and not self._resilient:
            return await call(self.nodes[0], keys, counts_np)
        order, bounds, keys = self._split(keys)

        tracer = tracing.get_tracer()
        live = [(j, int(bounds[j]), int(bounds[j + 1]))
                for j in range(self.n_nodes) if bounds[j] < bounds[j + 1]]
        # The whole fan-out is one span (a new root when the caller has
        # none, subject to the head-sampling coin): the per-node
        # children parent on it EXPLICITLY — if the coin fails here,
        # the nodes must not re-flip it N times and litter the buffer
        # with unrooted single-node traces.
        fspan = (tracer.start_span("cluster.fan_out",
                                   attrs={"nodes": len(live),
                                          "rows": int(n)})
                 if tracer.enabled else tracing._NULL_SPAN)
        fctx = fspan.context

        async def node_call(j: int, lo: int, hi: int):
            idx = order[lo:hi]
            sub_keys = [keys[i] for i in idx]
            sub_counts = counts_np[idx]
            # One child span per node: the fan-out share of a traced bulk
            # call decomposes into which node was slow.
            nspan = (tracer.start_span("cluster.node", parent=fctx,
                                       attrs={"node": j,
                                              "rows": int(hi - lo)})
                     if fctx is not None else tracing._NULL_SPAN)
            with nspan:
                br = (self._breakers[j] if self._breakers is not None
                      else None)
                if br is not None:
                    verdict = br.allow()
                    if verdict == "probe" and not await self._probe(j):
                        verdict = "reject"
                    if verdict == "reject":
                        nspan.set_status("degraded")
                        nspan.set_attr("breaker", br.state)
                        return self._bulk_reject(j, sub_keys, sub_counts,
                                                 degraded_row)
                try:
                    out = await call(self.nodes[j], sub_keys, sub_counts)
                except asyncio.CancelledError:
                    if br is not None:
                        br.release_probe()  # no-op unless we held it
                    raise
                except Exception as exc:
                    if (isinstance(exc, wire.RemoteStoreError)
                            and MOVED_ERROR_PREFIX in str(exc)):
                        # Stale map, not node failure: the node is
                        # HEALTHY — settle a half-open probe as a
                        # success (the scalar lane's rule; leaking the
                        # probe slot would quarantine the keyspace for a
                        # recovery window per stale bulk frame); refresh
                        # in the background so the NEXT call re-routes,
                        # and this frame's rows follow the
                        # partial_failures contract.
                        if br is not None:
                            br.record_success()
                        self._spawn(self.refresh_placement())
                        nspan.set_status("degraded")
                        if self._partial_failures == "raise":
                            raise
                        return None  # rows stay denied
                    self._note_node_error(j, exc)
                    nspan.set_status("degraded")
                    if degraded_row is not None \
                            and self._degraded is not None:
                        return self._bulk_degraded(j, sub_keys,
                                                   sub_counts,
                                                   degraded_row)
                    if self._partial_failures == "raise":
                        raise
                    return None  # rows stay denied
                if br is not None:
                    br.record_success()
                return out

        with fspan:
            outs = await asyncio.gather(*(node_call(*t) for t in live))

        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32) if with_remaining else None
        for (j, lo, hi), out in zip(live, outs):
            if out is None:
                continue
            idx = order[lo:hi]
            granted[idx] = out.granted
            if remaining is not None and out.remaining is not None:
                remaining[idx] = out.remaining
        return BulkAcquireResult(granted, remaining)

    async def acquire_many(self, keys: Sequence[str], counts: Sequence[int],
                           capacity: float, fill_rate_per_sec: float, *,
                           with_remaining: bool = True) -> BulkAcquireResult:
        async def call(node, sub_keys, sub_counts):
            return await node.acquire_many(
                sub_keys, sub_counts, capacity, fill_rate_per_sec,
                with_remaining=with_remaining)

        degraded_row = (
            (lambda j, k, c: self._degraded.acquire(
                j, k, c, capacity, fill_rate_per_sec, "bucket"))
            if self._degraded is not None else None)
        return await self._bulk_fan_out(keys, counts, call, with_remaining,
                                        degraded_row)

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], capacity: float,
                              fill_rate_per_sec: float, *,
                              with_remaining: bool = True
                              ) -> BulkAcquireResult:
        return self._blocking(self.acquire_many(
            keys, counts, capacity, fill_rate_per_sec,
            with_remaining=with_remaining))

    async def window_acquire_many(self, keys: Sequence[str],
                                  counts: Sequence[int], limit: float,
                                  window_sec: float, *, fixed: bool = False,
                                  with_remaining: bool = True
                                  ) -> BulkAcquireResult:
        async def call(node, sub_keys, sub_counts):
            return await node.window_acquire_many(
                sub_keys, sub_counts, limit, window_sec, fixed=fixed,
                with_remaining=with_remaining)

        degraded_row = (
            (lambda j, k, c: self._degraded.acquire(
                j, k, c, limit, limit / window_sec,
                "fwindow" if fixed else "window"))
            if self._degraded is not None else None)
        return await self._bulk_fan_out(keys, counts, call, with_remaining,
                                        degraded_row)

    def window_acquire_many_blocking(self, keys: Sequence[str],
                                     counts: Sequence[int], limit: float,
                                     window_sec: float, *,
                                     fixed: bool = False,
                                     with_remaining: bool = True
                                     ) -> BulkAcquireResult:
        return self._blocking(self.window_acquire_many(
            keys, counts, limit, window_sec, fixed=fixed,
            with_remaining=with_remaining))

    # -- ops fan-out ---------------------------------------------------------
    async def ping(self) -> None:
        await asyncio.gather(*(n.ping() for n in self.nodes
                               if hasattr(n, "ping")))

    async def save(self) -> None:
        """Checkpoint every node that supports it (≙ cluster-wide BGSAVE)."""
        await asyncio.gather(*(n.save() for n in self.nodes
                               if hasattr(n, "save")))

    # -- metrics -------------------------------------------------------------
    def metrics_registry(self):
        """The cluster client's own OpenMetrics families: per-node error
        counters and breaker state, shed / degraded decision counters,
        and the wire clients' retry/timeout sums. Appended to the fleet
        scrape by :meth:`cluster_metrics`."""
        from distributedratelimiting.redis_tpu_torch.utils.metrics import (
            MetricsRegistry,
        )

        if self._registry is not None:
            return self._registry
        reg = MetricsRegistry()
        for j in range(self.n_nodes):
            reg.counter("cluster_node_errors",
                        "Store-operation failures per cluster node",
                        lambda j=j: self.node_errors[j],
                        labels={"node": str(j)})
        if self._breakers is not None:
            for j, br in enumerate(self._breakers):
                reg.gauge("cluster_breaker_state",
                          "Circuit state per node: 0 closed, 1 "
                          "half-open, 2 open",
                          br.state_gauge, labels={"node": str(j)})
                reg.counter("cluster_breaker_opens",
                            "Times the node's circuit tripped open",
                            lambda b=br: b.opens,
                            labels={"node": str(j)})
                reg.counter("cluster_breaker_probes",
                            "Half-open probes admitted",
                            lambda b=br: b.probes,
                            labels={"node": str(j)})
        reg.counter("cluster_shed",
                    "Requests failed fast against quarantined nodes",
                    lambda: self.shed)
        reg.counter("cluster_degraded_decisions",
                    "Decisions served by the local fair-share fallback",
                    lambda: self.degraded_decisions)
        reg.gauge("cluster_degraded_keys",
                  "Keys currently held by the degraded fallback",
                  lambda: (len(self._degraded)
                           if self._degraded is not None else 0))
        reg.gauge("cluster_placement_epoch",
                  "Adopted placement map epoch",
                  lambda: float(self.placement.epoch))
        reg.counter("cluster_migrations",
                    "Committed membership migrations",
                    lambda: self.migrations)
        reg.counter("cluster_migration_aborts",
                    "Migrations cleanly aborted to the old epoch",
                    lambda: self.migration_aborts)
        reg.counter("cluster_rejoin_debits",
                    "Degraded-envelope grants debited on node rejoin",
                    lambda: self.rejoin_debits)
        reg.counter("cluster_config_mutations",
                    "Committed live config mutations",
                    lambda: self.config_mutations)
        reg.counter("cluster_config_aborts",
                    "Config mutations cleanly aborted to the old version",
                    lambda: self.config_aborts)
        reg.counter("cluster_client_retries",
                    "Wire-client retries, summed over nodes",
                    lambda: self._sum_node_stat("retries"))
        reg.counter("cluster_client_timeouts",
                    "Wire-client request timeouts, summed over nodes",
                    lambda: self._sum_node_stat("timeouts"))
        # The autonomous controller's families, read dynamically so a
        # controller attached after the first scrape still renders (a
        # None controller renders nothing — register_numeric_dict and
        # the dynamic counter family both skip empty readers).
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
        self._registry = reg
        return reg

    def _sum_node_stat(self, key: str) -> int:
        total = 0
        for n in self.nodes:
            stats_fn = getattr(n, "resilience_stats", None)
            if callable(stats_fn):
                total += stats_fn().get(key, 0)
        return total

    async def cluster_metrics(self) -> str:
        """Fleet-wide OpenMetrics exposition: scrape every node's
        ``OP_METRICS`` text and merge — each sample re-emitted per node
        with a ``node="<j>"`` label (positional, same convention as
        :meth:`stats`) plus an aggregated summed series without it, so
        one scrape answers both "what is the fleet doing" and "which
        node is the outlier". Nodes without a metrics surface (bare
        in-process stores in tests) contribute nothing rather than
        failing the scrape. The cluster client's own resilience families
        (breakers, shed, retries) are appended after the merge."""
        from distributedratelimiting.redis_tpu_torch.utils.metrics import (
            aggregate_openmetrics,
        )

        async def one(j: int, n: BucketStore) -> str:
            # callable check: on device stores `metrics` is the
            # StoreMetrics ATTRIBUTE, not the remote scrape method.
            if not callable(getattr(n, "metrics", None)):
                return ""
            try:
                return await n.metrics()
            except Exception as exc:  # a down node must not kill the
                # fleet scrape — but it must be SEEN, not swallowed.
                self._note_scrape_error(j, exc)
                return ""

        texts = await asyncio.gather(*(one(j, n)
                                       for j, n in enumerate(self.nodes)))
        merged = aggregate_openmetrics(texts)
        own = self.metrics_registry().render()
        # Both are complete expositions; splice ours before the EOF
        # terminator (families stay contiguous — each side emits its
        # own distinct family names).
        eof = "# EOF\n"
        if merged.endswith(eof):
            merged = merged[:-len(eof)]
        return merged + own

    def cluster_metrics_blocking(self) -> str:
        return self._blocking(self.cluster_metrics())

    async def stats(self) -> dict:
        """Per-node stats plus cluster-level sums of the numeric metrics.
        ``nodes[j]`` is positionally node ``j``'s stats (``{}`` for nodes
        without a stats surface) — consumers correlate by index. The
        ``resilience`` section carries breaker snapshots and the chaos
        counters."""

        async def one(j: int, n: BucketStore) -> dict:
            if not hasattr(n, "stats"):
                return {}
            try:
                return await n.stats()
            except Exception as exc:
                # A down node must not kill the fleet stats — an ops
                # surface that dies DURING the outage it should be
                # describing. Visible (event 3 + counter), not silent.
                self._note_scrape_error(j, exc)
                return {}

        per_node = await asyncio.gather(*(one(j, n)
                                          for j, n in
                                          enumerate(self.nodes)))
        total: dict = {}
        for s in per_node:
            for k, v in s.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    total[k] = total.get(k, 0) + v
        out = {"n_nodes": self.n_nodes, "nodes": list(per_node),
               "total": total}
        resilience: dict = {
            "node_errors": list(self.node_errors),
            "shed": self.shed,
            "degraded_decisions": self.degraded_decisions,
            "rejoin_debits": self.rejoin_debits,
        }
        if self._breakers is not None:
            resilience["breakers"] = [b.snapshot() for b in self._breakers]
        if self._degraded is not None:
            resilience["degraded_keys"] = len(self._degraded)
        out["resilience"] = resilience
        out["placement"] = {
            "epoch": self.placement.epoch,
            "n_slots": self.placement.n_slots,
            "slot_counts": self.placement.slot_counts(
                self.n_nodes).tolist(),
            "overrides": len(self.placement.overrides),
            "drained": sorted(self.drained),
            "migrations": self.migrations,
            "migration_aborts": self.migration_aborts,
        }
        out["config"] = {
            "mutations": self.config_mutations,
            "aborts": self.config_aborts,
            "rebased_rows": self.config_rebased_rows,
        }
        if self.controller is not None:
            out["controller"] = self.controller.stats()
        return out

    async def audit(self, bundles: int = 0) -> dict:
        """Fleet conservation-audit view (the :meth:`stats` posture):
        ``nodes[j]`` is node ``j``'s OP_AUDIT snapshot positionally
        (``{}`` where the node has no audit surface — down, or audit
        disabled), ``total`` sums the numeric fields, and the fleet
        roll-ups a watch console starts from ride at the top:
        ``breaches``, ``alerts``, ``bundles_assembled``."""

        async def one(j: int, n: BucketStore) -> dict:
            if not hasattr(n, "audit"):
                return {}
            try:
                return await n.audit(bundles=bundles)
            except Exception as exc:
                self._note_scrape_error(j, exc)
                return {}

        per_node = await asyncio.gather(*(one(j, n)
                                          for j, n in
                                          enumerate(self.nodes)))
        total: dict = {}
        for s in per_node:
            for k, v in s.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    total[k] = total.get(k, 0) + v
        return {"n_nodes": self.n_nodes, "nodes": list(per_node),
                "total": total,
                "breaches": total.get("breaches", 0),
                "bundles_assembled": total.get("bundles_assembled", 0)}

    # -- checkpoint ----------------------------------------------------------
    def snapshot(self) -> dict:
        """Cluster checkpoint = each node's snapshot, keyed by position.
        Remote nodes raise by design (state lives with the server — use
        :meth:`save` for server-side checkpoints); in-process nodes
        snapshot locally."""
        return {"cluster": True, "n_nodes": self.n_nodes,
                "nodes": [n.snapshot() for n in self.nodes]}

    def restore(self, snap: dict) -> None:
        if not snap.get("cluster") or snap.get("n_nodes") != self.n_nodes:
            raise ValueError(
                "snapshot is not a cluster snapshot for this topology "
                f"(need n_nodes={self.n_nodes})")
        for node, sub in zip(self.nodes, snap["nodes"]):
            node.restore(sub)
