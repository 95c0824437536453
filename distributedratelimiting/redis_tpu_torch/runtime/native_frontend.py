"""Python half of the native serving front-end (``native/frontend.cc``).

The JAX package's ``runtime/native_frontend.py`` on the port's server and
store. The C++ side owns the sockets: epoll (or io_uring) IO threads
accept connections, parse the v4 wire protocol, answer PING themselves,
accumulate the per-request ACQUIRE / WINDOW / FWINDOW / SEMA frames into
micro-batches (a timerfd deadline, flush-on-idle and a max-batch cap, the
policy of :class:`~.batcher.MicroBatcher`), and encode and write every
reply. This module is the *decision* half: one pump thread per shard
blocks in ``fe_wait`` (GIL released) and hands each batch to the server's
asyncio loop as ONE store bulk call, so Python pays per flush, not per
request. Three lanes reach Python:

- the **batch lane** (:meth:`NativeFrontend._serve_batch`): SEMA rows go
  as one ``concurrency_acquire_many`` in arrival order, the bucket and
  window rows as one ``acquire_many`` / ``window_acquire_many`` per
  distinct (op, a, b) — one call for the common single-config batch;
- the **bulk lane** (:meth:`NativeFrontend._serve_bulk`): well-formed
  ``OP_ACQUIRE_MANY`` frames parse, tier-0-decide their hot rows and encode
  ``RESP_BULK`` in C; only the residue rows cross here, as one zero-copy
  :class:`~.wire.KeyBlob` over the C job's memory;
- the **passthrough lane**: every other op (HELLO, PEEK, SYNC, STATS,
  SAVE, …) and malformed bulk frames, served by the server's own
  :meth:`~.server.BucketStoreServer.handle_frame_body`.

On a card store every one of those store calls is one of the port's hand
kernels: ``acquire_packed`` / ``acquire_grouped``, ``window_packed`` /
``window_grouped``, ``sema_packed``, and ``acquire_scan`` for a residue
past one batch. Tier-0 (:class:`Tier0Config`) decides hot ACQUIRE keys
inside the C loop from a replica table; its sync pump
(:meth:`NativeFrontend._t0_sync_loop`) drains the local grants into the
store with ``debit_many`` (the card's ``debit_packed``) and acks the fresh
balances back.

The live-config gate (:meth:`NativeFrontend._config_gate` and
:meth:`NativeFrontend._gated`, the server's
:class:`~.liveconfig.ConfigState`) and the placement gate
(:meth:`NativeFrontend._placement_gate`, the server's
:class:`~.placement.NodePlacementState`) hold both lanes to the server's
rules as the asyncio lanes are held, config first. On the batch lane a row
of a retired (kind, a, b) answers ``config moved``, a moved row MOVED and a
parked SEMA or release row the handoff deferral, each through ``fe_send``
with the ``kRowSkip`` sentinel telling ``fe_complete`` the row is answered,
and a parked admission row serves from its handoff envelope; one
``forward()`` probe a distinct (op, a, b) of the batch. On the bulk lane a
frame of a retired config answers one frame-level ``config moved`` and a
frame with a moved row one frame-level MOVED, each through ``fe_send`` and
``fe_bulk_discard``, and parked rows serve from their envelopes. Tier-0's
sync pump retires the C replicas of a retired bucket config
(``fe_t0_retire``) and debits their grants through the replacement
config's table. While the server drains (:meth:`~.server.
BucketStoreServer.shutdown`), a bulk frame past the config gate answers
the server's ``_serve_bulk_draining`` reply (every row from the shutdown
envelope, byte for byte the asyncio lane's) and its C job is discarded.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import socket
import threading
import time
from dataclasses import dataclass

import numpy as np

from distributedratelimiting.redis_tpu_torch.runtime import (
    liveconfig,
    placement,
    wire,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import BucketStore
from distributedratelimiting.redis_tpu_torch.utils import faults, log, tracing
from distributedratelimiting.redis_tpu_torch.utils.metrics import (
    LatencyHistogram,
    Tier0Metrics,
)
from distributedratelimiting.redis_tpu_torch.utils.native import (
    URING_OFF,
    URING_ON,
    URING_SQPOLL,
    load_frontend_lib,
)

__all__ = ["NativeFrontend", "Tier0Config", "native_loadgen",
           "native_bulk_loadgen", "uring_probe"]

logger = logging.getLogger(__name__)

#: Accepted spellings of the uring knob (constructor param, env var, CLI)
#: → ``fe_start_sharded2`` transport mode. The C side accepts the same
#: strings in ``DRL_TPU_URING``.
_URING_SPELLINGS = {
    "": URING_OFF, "0": URING_OFF, "off": URING_OFF,
    "1": URING_ON, "on": URING_ON, "uring": URING_ON,
    "2": URING_SQPOLL, "sqpoll": URING_SQPOLL,
}


def _resolve_uring_mode(uring: "str | bool | int | None") -> int:
    """Constructor/CLI knob → transport mode. ``None`` defers to the
    ``DRL_TPU_URING`` env var (off when unset)."""
    if uring is None:
        uring = os.environ.get("DRL_TPU_URING", "")
    if isinstance(uring, bool):
        return URING_ON if uring else URING_OFF
    if isinstance(uring, int):
        if uring not in (URING_OFF, URING_ON, URING_SQPOLL):
            raise ValueError(f"unknown uring mode {uring!r}")
        return uring
    key = str(uring).strip().lower()
    if key not in _URING_SPELLINGS:
        raise ValueError(
            f"unknown uring mode {uring!r}; use off/on/sqpoll")
    return _URING_SPELLINGS[key]


def uring_probe() -> tuple[bool, str]:
    """Runtime io_uring availability: ``(available, reason)``. The reason
    is readable either way: the feature level verified, or the refusing
    syscall or gate."""
    lib = load_frontend_lib()
    buf = ctypes.create_string_buffer(256)
    ok = lib.fe_uring_probe(buf, len(buf))
    return bool(ok), buf.value.decode("utf-8", "replace")


@dataclass(frozen=True)
class Tier0Config:
    """Knobs of the front-end's tier-0 admission cache. The budget policy
    mirrors :func:`~..models.approximate.headroom_budget`; the over-admission
    bound per key is ``overadmit_epsilon(headroom_budget(capacity, ...),
    fill_rate, sync_interval_s)``."""

    #: Replica table slots PER SHARD SLICE (rounded up to a power of two;
    #: any shard can see any key, so each slice is full-size).
    slots: int = 4096
    #: Fraction of the last-synced balance granted as local headroom.
    budget_fraction: float = 0.5
    #: Below this budget a key is not hosted locally (small buckets keep
    #: exact per-request semantics).
    min_budget: float = 64.0
    #: Budget ceiling (bounds epsilon for huge-capacity buckets).
    max_budget: float = float(1 << 20)
    #: Sync pump cadence: how often local grants drain into the store.
    sync_interval_s: float = 0.02
    #: Max age of the envelope a local decision may be served from: during
    #: a store outage, how long tier-0 keeps answering from its last
    #: envelope instead of stalling behind the dead store.
    max_stale_s: float = 2.0
    #: Idle replica eviction.
    ttl_s: float = 30.0


_OP_BUCKET = wire.OP_ACQUIRE
_OP_WINDOW = wire.OP_WINDOW
_OP_FWINDOW = wire.OP_FWINDOW
_OP_SEMA = wire.OP_SEMA

#: ``fe_complete``'s per-row sentinel (``kRowSkip`` in ``frontend.cc``): the
#: row was already answered through ``fe_send`` (a placement MOVED or
#: handoff deferral).
_ROW_SKIP = 2

#: The batch record ``np.unique`` groups on: one group per (op, a, b).
_GROUP_DTYPE = np.dtype([("op", np.uint8), ("a", np.float64),
                         ("b", np.float64)])


class NativeFrontend:
    """Own the C++ listener for a :class:`~.server.BucketStoreServer`.

    Constructed inside ``server.start()`` on the running loop;
    ``aclose()`` (from ``server.aclose()``) stops the IO threads, fails the
    pumps out of their waits, drains the loop tasks that still hold the C
    handle, and only then frees it.
    """

    def __init__(self, server, *, host: str, port: int,
                 max_batch: int = 4096, deadline_us: int = 300,
                 tier0: "Tier0Config | bool | None" = None,
                 bulk: bool = True, shards: int = 1,
                 pin_shards: bool = False,
                 uring: "str | bool | int | None" = None) -> None:
        lib = load_frontend_lib()  # raises with g++'s error: no fallback
        self._lib = lib
        self._server = server
        self._loop = asyncio.get_running_loop()
        # The C side binds numeric IPv4 only: resolve names here so
        # --host localhost works as it does on the asyncio listener.
        try:
            infos = socket.getaddrinfo(host, port, socket.AF_INET,
                                       socket.SOCK_STREAM)
            numeric_host = infos[0][4][0]
        except socket.gaierror as exc:
            raise OSError(
                f"native front-end cannot resolve {host!r} as IPv4: {exc}"
            ) from exc
        # N shards accept on SO_REUSEPORT listeners bound to ONE port, each
        # with its own IO thread, connection table and pump thread; the
        # tier-0 replica table is partitioned by key hash.
        shards = max(1, int(shards))
        # io_uring swaps each shard's data plane under the same reply
        # bytes. A shard whose ring the kernel denies serves on epoll and
        # says why (logged here, OP_STATS fe_transport).
        mode = _resolve_uring_mode(uring)
        self.uring_mode = mode
        self._h = lib.fe_start_sharded2(
            numeric_host.encode(), port, max_batch, deadline_us,
            1 if server.auth_token is not None else 0, shards,
            1 if pin_shards else 0, mode)
        if not self._h:
            raise OSError(f"native front-end failed to bind {host}:{port}")
        self.n_shards = int(lib.fe_shard_count(self._h))
        self.uring_shards = int(lib.fe_uring_shards(self._h))
        if mode != URING_OFF and self.uring_shards < self.n_shards:
            for i, reason in self.uring_reasons().items():
                logger.warning("io_uring requested but shard %d fell back "
                               "to epoll: %s", i, reason)
        self.port = lib.fe_port(self._h)
        self.host = host
        self._stopping = False
        # Per-shard sub-handles: every fe_* call a pump or serve task makes
        # goes through the shard its work arrived on (conn ids, batch ids
        # and bulk job ids are all per shard).
        self._shards = [int(lib.fe_shard(self._h, i))
                        for i in range(self.n_shards)]
        # Per-(shard, connection) tail task for chained ACQUIRE_MANY chunks
        # on the passthrough lane: the request-order contract the asyncio
        # server keeps (its per-connection bulk tail). Entries drop when
        # their task is still the tail at completion.
        self._bulk_tails: dict[tuple[int, int], asyncio.Task] = {}
        # Loop tasks still holding the C handle: aclose drains them BETWEEN
        # fe_stop (no new work) and fe_free (handle invalid) — a straggler
        # batch completing after fe_free would call fe_complete through a
        # dangling pointer.
        self._loop_tasks: set[asyncio.Task] = set()
        # Tier-0: decisions served from the C replica table; this side runs
        # the sync pump (harvest → bulk debit → ack).
        self._tier0: Tier0Config | None = None
        self._t0_task: asyncio.Task | None = None
        self.t0_metrics = Tier0Metrics()
        #: Consecutive failed sync rounds (0 while healthy); a streak trips
        #: the flight recorder.
        self._t0_fail_streak = 0
        #: Drained-but-unreconciled amounts surviving a failed sync round,
        #: carried into the next round, never dropped.
        self._t0_carry: dict[tuple[str, float, float], float] = {}
        if tier0:
            self._tier0_setup(
                tier0 if isinstance(tier0, Tier0Config) else Tier0Config())
        # The native bulk lane: armed on every shard by one call (the C
        # side fans out), so a frame never races a half-armed shard mix.
        self._bulk_native = bool(bulk)
        self._hot_task: asyncio.Task | None = None
        if self._bulk_native:
            hh = getattr(server, "heavy_hitters", None)
            lib.fe_bulk_configure(self._h, 1, 1, 1 if hh is not None else 0)
            if hh is not None:
                # Bulk keys never become Python strings, so the C side
                # keeps a per-frame top-K ring and this task offers the
                # survivors to the sketch.
                self._hot_task = asyncio.get_running_loop().create_task(
                    self._hot_harvest_loop())
        self._pumps = [
            threading.Thread(target=self._pump_loop, args=(sh,),
                             daemon=True, name=f"native-frontend-pump-{i}")
            for i, sh in enumerate(self._shards)
        ]
        for p in self._pumps:
            p.start()

    def _tier0_setup(self, cfg: Tier0Config) -> None:
        store = self._server.store
        if type(store).debit_many is BucketStore.debit_many:
            # No reconciliation entry point on this store: local grants
            # could never drain back, so the envelope would be a lie.
            logger.warning(
                "tier-0 requested but %s has no debit_many "
                "reconciliation path; serving without tier-0",
                type(store).__name__)
            return
        slots = self._lib.fe_t0_configure(
            self._h, int(cfg.slots), float(cfg.budget_fraction),
            float(cfg.min_budget), float(cfg.max_budget),
            max(1, int(cfg.max_stale_s * 1e3)),
            max(1, int(cfg.ttl_s * 1e3)))
        self._tier0 = cfg
        # Harvest buffers, allocated once: a full table of max-length
        # (256 B) keys drains in one round.
        self._t0_blob = ctypes.create_string_buffer(slots * 256)
        self._t0_klens = np.zeros(slots, np.int32)
        self._t0_amounts = np.zeros(slots, np.float64)
        self._t0_caps = np.zeros(slots, np.float64)
        self._t0_rates = np.zeros(slots, np.float64)
        self._t0_task = asyncio.get_running_loop().create_task(
            self._t0_sync_loop())

    def _track_task(self, coro) -> asyncio.Task:
        """Start ``coro`` as a loop task tracked for shutdown draining.
        Loop-thread only: the pump threads reach it through
        ``call_soon_threadsafe`` (:meth:`_track`)."""
        # drl-check: ok(task-off-loop)
        task = asyncio.ensure_future(coro)
        self._loop_tasks.add(task)
        task.add_done_callback(self._loop_tasks.discard)
        return task

    def _track(self, coro) -> None:
        """Schedule ``coro`` on the loop from a pump thread, tracked."""
        self._loop.call_soon_threadsafe(self._track_task, coro)

    # -- the row gates -------------------------------------------------------

    def _placement_gate(self, keys):
        """Keyspace ownership on the batch and bulk lanes: the server's
        :meth:`~.placement.NodePlacementState.bulk_gate` over the rows
        (``None`` while no map is adopted, or when every row is owned and
        unparked), else ``(serve_mask, envelope_rows, moved_mask)``."""
        ps = self._server.placement
        return ps.bulk_gate(keys) if ps.active else None

    def _config_gate(self, ops: np.ndarray, a_arr: np.ndarray,
                     b_arr: np.ndarray) -> "list | None":
        """Retired configs on the batch lane: ``None`` while no rule has
        committed or no row is of a retired config, else ``[(row, (kind,
        a, b), fwd)]`` for the rows that answer "config moved". One
        ``forward()`` probe a distinct (op, a, b) of the batch (numpy
        grouping: a mutated fleet keeps its rules, so this path must not
        pay a Python loop a row); ``liveconfig.OP_KINDS`` is the one
        op → kind table."""
        lc = self._server.liveconfig
        n = len(ops)
        if not lc.active or not n:
            return None
        rec = np.empty(n, _GROUP_DTYPE)
        rec["op"], rec["a"], rec["b"] = ops, a_arr, b_arr
        uniq, inverse = np.unique(rec, return_inverse=True)
        inverse = inverse.reshape(-1)
        rows = []
        for gi, u in enumerate(uniq):
            kind = liveconfig.OP_KINDS.get(int(u["op"]))
            if kind is None:
                continue
            pk = (kind, float(u["a"]), float(u["b"]))
            fwd = lc.forward(*pk)
            if fwd is not None:
                rows.extend((int(i), pk, fwd)
                            for i in np.nonzero(inverse == gi)[0])
        return rows or None

    def _gated(self, kind: int, a: float, b: float) -> "str | None":
        """The frame-level live-config gate of the bulk lane: the routable
        "config moved" text (byte for byte the asyncio lane's) when the
        frame's (kind, a, b) is retired, else ``None``."""
        lc = self._server.liveconfig
        ckind = liveconfig.BULK_KINDS.get(kind)
        if not lc.active or ckind is None:
            return None
        fwd = lc.forward(ckind, a, b)
        return None if fwd is None else lc.moved(ckind, a, b, fwd)

    # -- pump threads --------------------------------------------------------

    def _pump_loop(self, sh: int) -> None:
        """One shard's pump: blocks in fe_wait (GIL released) on the SHARD
        handle and dispatches that shard's work onto the loop."""
        lib = self._lib
        while not self._stopping:
            kind = lib.fe_wait(sh, 200)
            if kind == -1:
                break
            try:
                if kind == 1:
                    self._dispatch_batch(sh)
                elif kind == 2:
                    self._dispatch_passthrough(sh)
                elif kind == 3:
                    self._dispatch_bulk(sh)
            except Exception as exc:  # noqa: BLE001 — every connection on
                # this shard depends on the pump: it survives any bad batch
                # or frame (the items get error replies where possible).
                log.error_evaluating_kernel(exc)
                try:
                    if kind == 1:
                        lib.fe_fail(sh, lib.fe_batch_id(sh),
                                    repr(exc)[:200].encode())
                    elif kind == 3:
                        lib.fe_bulk_fail(sh, lib.fe_bulk_id(sh),
                                         repr(exc)[:200].encode())
                # the failure above was already logged; the fail call
                # itself dying adds nothing
                # drl-check: ok(swallowed-exception)
                except Exception:  # noqa: BLE001
                    pass

    def _dispatch_batch(self, sh: int) -> None:
        lib, h, c = self._lib, sh, ctypes
        bid = lib.fe_batch_id(h)
        n = lib.fe_batch_n(h)
        if n <= 0:
            return
        kb = lib.fe_batch_key_bytes(h)
        blob = ctypes.create_string_buffer(max(int(kb), 1))
        klens = np.empty(n, np.int32)
        counts = np.empty(n, np.int32)
        ops = np.empty(n, np.uint8)
        seqs = np.empty(n, np.uint32)
        conn_ids = np.empty(n, np.uint64)
        a_arr = np.empty(n, np.float64)
        b_arr = np.empty(n, np.float64)
        lib.fe_batch_copy(
            h, blob,
            klens.ctypes.data_as(c.POINTER(c.c_int32)),
            counts.ctypes.data_as(c.POINTER(c.c_int32)),
            ops.ctypes.data_as(c.POINTER(c.c_uint8)),
            seqs.ctypes.data_as(c.POINTER(c.c_uint32)),
            conn_ids.ctypes.data_as(c.POINTER(c.c_uint64)),
            a_arr.ctypes.data_as(c.POINTER(c.c_double)),
            b_arr.ctypes.data_as(c.POINTER(c.c_double)))
        # Decode keys off-loop (the pump idles while the loop runs store
        # calls). surrogateescape: a key of invalid UTF-8 still maps 1:1 to
        # a stable str, so it rate-limits under its own identity instead of
        # poisoning its batch.
        keys = wire.decode_key_blob(blob.raw[:int(kb)], klens,
                                    errors="surrogateescape")
        traces = None
        if tracing.get_tracer().enabled and lib.fe_batch_traced_n(h) > 0:
            # Trace contexts ride as parallel arrays (flag bit 0 marks the
            # traced rows); the traced_n gate keeps an untraced batch at
            # one C call.
            tr_hi = np.zeros(n, np.uint64)
            tr_lo = np.zeros(n, np.uint64)
            tr_par = np.zeros(n, np.uint64)
            tr_fl = np.zeros(n, np.uint8)
            lib.fe_batch_traces(
                h, tr_hi.ctypes.data_as(c.POINTER(c.c_uint64)),
                tr_lo.ctypes.data_as(c.POINTER(c.c_uint64)),
                tr_par.ctypes.data_as(c.POINTER(c.c_uint64)),
                tr_fl.ctypes.data_as(c.POINTER(c.c_uint8)))
            traces = (tr_hi, tr_lo, tr_par, tr_fl)
        self._track(self._serve_batch(sh, bid, keys, counts, ops, a_arr,
                                      b_arr, traces, seqs, conn_ids))

    def _dispatch_passthrough(self, sh: int) -> None:
        lib = self._lib
        conn_id = lib.fe_pt_conn(sh)
        ln = lib.fe_pt_len(sh)
        buf = ctypes.create_string_buffer(max(ln, 1))
        lib.fe_pt_copy(sh, buf)
        self._track(self._serve_passthrough(sh, int(conn_id), buf.raw[:ln]))

    def _dispatch_bulk(self, sh: int) -> None:
        """Hand one bulk residue job to the loop. The key blob and offsets
        are ZERO-COPY views into the C job (valid until fe_bulk_complete,
        discard or fail erases it, which only :meth:`_serve_bulk` does,
        after its last read); the counts and the residue index are copied
        here, so nothing the C side owns is ever the source of a copy to
        the card."""
        lib, h, c = self._lib, sh, ctypes
        u = np.zeros(11, np.uint64)
        f = np.zeros(2, np.float64)
        lib.fe_bulk_meta(h, u.ctypes.data_as(c.POINTER(c.c_uint64)),
                         f.ctypes.data_as(c.POINTER(c.c_double)))
        jid = int(u[0])
        if jid == 0:
            return
        n, blob_len, res_n = int(u[4]), int(u[5]), int(u[6])
        ptrs = np.zeros(4, np.uint64)
        lib.fe_bulk_ptrs(h, ptrs.ctypes.data_as(c.POINTER(c.c_uint64)))
        # A (c_char × len) view passes wherever the KeyBlob contract needs
        # it: dir_resolve_batch takes it as its c_char_p, and slicing yields
        # bytes for the serial stores' per-key decode.
        blob = ((c.c_char * blob_len).from_address(int(ptrs[0]))
                if blob_len else b"")
        offsets = np.ctypeslib.as_array(
            c.cast(int(ptrs[1]), c.POINTER(c.c_int64)), (n + 1,))
        counts = np.ctypeslib.as_array(
            c.cast(int(ptrs[2]), c.POINTER(c.c_int64)), (n,)).copy()
        residue = np.ctypeslib.as_array(
            c.cast(int(ptrs[3]), c.POINTER(c.c_int32)), (res_n,)).copy()
        tctx = None
        if int(u[10]) & 1 and tracing.get_tracer().enabled:
            tctx = tracing.TraceContext(int(u[7]), int(u[8]), int(u[9]),
                                        1 if int(u[10]) & 2 else 0)
        self._track(self._serve_bulk(
            sh, jid, int(u[1]), int(u[2]), int(u[3]), float(f[0]),
            float(f[1]), wire.KeyBlob(blob, offsets), counts, residue,
            tctx))

    # -- loop-side serving ---------------------------------------------------

    def _offer_batch_hot(self, keys: list, counts: np.ndarray) -> None:
        """Cost-weighted heavy-hitter feed of one batch: an N-token acquire
        weighs N. Rows with count <= 0 (SEMA releases and probes) are not
        admission demand."""
        hh = getattr(self._server, "heavy_hitters", None)
        if hh is None:
            return
        if (counts <= 0).any():
            mask = counts > 0
            hh.offer_many([k for k, keep in zip(keys, mask) if keep],
                          counts[mask])
        elif int(counts.max(initial=0)) <= 1:
            hh.offer_many(keys)  # all-unit: the Counter fast path
        else:
            hh.offer_many(keys, counts)

    @staticmethod
    def _batch_groups(ops: np.ndarray, a_arr: np.ndarray,
                      b_arr: np.ndarray) -> list:
        """``(op, a, b, rows)`` groups of one batch, ``rows`` None for the
        whole batch. SEMA rows go as ONE group in arrival order with per-row
        limits: grouping them by (a, b) would run releases (a = 0) apart
        from acquires (a = limit), reordering a pipelined same-key
        acquire → release pair and leaking a held permit."""
        n = len(ops)
        sema_mask = ops == _OP_SEMA
        groups: list = []
        if sema_mask.any():
            groups.append((_OP_SEMA, 0.0, 0.0, np.nonzero(sema_mask)[0]))
        rest = np.nonzero(~sema_mask)[0]
        if n and len(rest) == n and ((ops == ops[0]).all()
                                     and (a_arr == a_arr[0]).all()
                                     and (b_arr == b_arr[0]).all()):
            # Single-config fast path: one limiter config per fleet is the
            # common shape. One bulk call.
            return [(int(ops[0]), float(a_arr[0]), float(b_arr[0]), None)]
        if len(rest):
            rec = np.empty(len(rest), _GROUP_DTYPE)
            rec["op"], rec["a"], rec["b"] = ops[rest], a_arr[rest], \
                b_arr[rest]
            uniq, inverse = np.unique(rec, return_inverse=True)
            inverse = inverse.reshape(-1)
            groups.extend((int(u["op"]), float(u["a"]), float(u["b"]),
                           rest[np.nonzero(inverse == gi)[0]])
                          for gi, u in enumerate(uniq))
        return groups

    async def _serve_batch(self, sh: int, bid: int, keys: list[str],
                           counts: np.ndarray, ops: np.ndarray,
                           a_arr: np.ndarray, b_arr: np.ndarray,
                           traces=None, seqs: "np.ndarray | None" = None,
                           conn_ids: "np.ndarray | None" = None) -> None:
        n = len(keys)
        t_start = time.perf_counter()
        store = self._server.store
        full = None
        try:
            self._offer_batch_hot(keys, counts)
            pgate = self._placement_gate(keys)
            cmoved = self._config_gate(ops, a_arr, b_arr)
            if pgate is not None or cmoved is not None:
                # Only the rows of a current config that this node owns
                # unparked reach the store; the rest are answered below,
                # after the store calls.
                full = (n, keys, counts, ops, a_arr, b_arr)
                serve_mask = (pgate[0].copy() if pgate is not None
                              else np.ones(n, bool))
                for i, _pk, _fwd in cmoved or ():
                    serve_mask[i] = False
                serve_idx = np.nonzero(serve_mask)[0]
                keys = [keys[int(i)] for i in serve_idx]
                counts, ops = counts[serve_idx], ops[serve_idx]
                a_arr, b_arr = a_arr[serve_idx], b_arr[serve_idx]
                n = len(keys)
            granted = np.zeros(n, np.uint8)
            remaining = np.zeros(n, np.float64)
            # Elected dispatch span (first traced row): the store's spans
            # of this batch's bulk calls nest under it.
            espan = tracing._NULL_SPAN
            if traces is not None:
                tr_hi, tr_lo, tr_par, tr_fl = traces
                idxs = np.nonzero(tr_fl & 1)[0]
                tracer = tracing.get_tracer()
                if len(idxs) and tracer.enabled:
                    i0 = int(idxs[0])
                    espan = tracer.start_span(
                        "fe.dispatch",
                        parent=tracing.TraceContext(
                            int(tr_hi[i0]), int(tr_lo[i0]),
                            int(tr_par[i0]), 1 if tr_fl[i0] & 2 else 0),
                        attrs={"n": n})
            with espan:
                for op, a, b, idx in self._batch_groups(ops, a_arr, b_arr):
                    if idx is None:
                        gkeys, gcounts = keys, counts
                    else:
                        gkeys = [keys[i] for i in idx.tolist()]
                        gcounts = counts[idx]
                    if op == _OP_BUCKET:
                        res = await store.acquire_many(
                            gkeys, gcounts, a, b, with_remaining=True)
                    elif op == _OP_SEMA:
                        # Signed deltas; each row's a carries its permit
                        # limit (a release wires a = 0, ignored per row).
                        res = await store.concurrency_acquire_many(
                            gkeys, gcounts, a_arr[idx].astype(np.int64))
                    else:
                        res = await store.window_acquire_many(
                            gkeys, gcounts, a, b,
                            fixed=(op == _OP_FWINDOW), with_remaining=True)
                    g = np.asarray(res.granted, np.uint8)
                    r = (np.zeros(len(gkeys), np.float64)
                         if res.remaining is None
                         else np.asarray(res.remaining, np.float64))
                    if idx is None:
                        granted, remaining = g, r
                    else:
                        granted[idx] = g
                        remaining[idx] = r
            if full is not None:
                n, keys, counts, ops, a_arr, b_arr = full
                granted, remaining = self._gated_rows(
                    sh, pgate, cmoved, serve_idx, granted, remaining, keys,
                    counts, ops, a_arr, b_arr, seqs, conn_ids)
            if traces is not None:
                self._record_batch_spans(traces, granted, ops, t_start)
            c = ctypes
            self._lib.fe_complete(
                sh, bid,
                np.ascontiguousarray(granted).ctypes.data_as(
                    c.POINTER(c.c_uint8)),
                np.ascontiguousarray(remaining).ctypes.data_as(
                    c.POINTER(c.c_double)))
        except Exception as exc:  # noqa: BLE001 — every request must get
            log.error_evaluating_kernel(exc)  # a routable error reply
            if traces is not None:
                self._record_batch_spans(
                    traces, None, ops if full is None else full[3], t_start)
            self._lib.fe_fail(sh, bid, repr(exc)[:200].encode())

    def _gated_rows(self, sh: int, pgate, cmoved, serve_idx: np.ndarray,
                    granted: np.ndarray, remaining: np.ndarray, keys,
                    counts, ops, a_arr, b_arr, seqs, conn_ids) -> tuple:
        """The whole batch's verdicts once the served rows are decided: a
        row of a retired config answers "config moved" first; then a
        parked admission row decides from its handoff envelope (after the
        store's rows, as the asyncio lane's gated bulk does), a parked SEMA
        or release row answers the handoff deferral and a moved row the
        routable MOVED. Each answer is sent here through ``fe_send`` and
        its row marked :data:`_ROW_SKIP` for ``fe_complete``."""
        n = len(keys)
        g_full = np.zeros(n, np.uint8)
        r_full = np.zeros(n, np.float64)
        g_full[serve_idx] = granted
        r_full[serve_idx] = remaining
        lc = self._server.liveconfig
        for i, pk, fwd in cmoved or ():
            # The store never saw this row, so the client's translated
            # re-send is not a replay.
            self._send(sh, int(conn_ids[i]), wire.encode_response(
                int(seqs[i]), wire.RESP_ERROR, lc.moved(*pk, fwd)))
            g_full[i] = _ROW_SKIP
        if pgate is None:
            return g_full, r_full
        ps = self._server.placement
        for i, handoff in pgate[1]:
            if g_full[i] == _ROW_SKIP:
                continue  # answered "config moved"
            ekind = placement.ENVELOPE_KIND.get(int(ops[i]))
            if ekind is not None and counts[i] >= 0:
                g_full[i], r_full[i] = ps.envelope_acquire(
                    handoff, keys[i], int(counts[i]), float(a_arr[i]),
                    float(b_arr[i]), ekind)
            else:
                # No envelope value: a denial would eat a permit release
                # (leaking the migrated semaphore's held permits).
                self._send(sh, int(conn_ids[i]), wire.encode_response(
                    int(seqs[i]), wire.RESP_ERROR,
                    ps.deferral_message(handoff)))
                g_full[i] = _ROW_SKIP
        for i in np.nonzero(pgate[2])[0].tolist():
            if g_full[i] == _ROW_SKIP:
                continue  # answered "config moved"
            # bulk_gate already counted these moved rows.
            self._send(sh, int(conn_ids[i]), wire.encode_response(
                int(seqs[i]), wire.RESP_ERROR, ps.moved_message(
                    keys[i], int(ps.pmap.node_of(keys[i])))))
            g_full[i] = _ROW_SKIP
        return g_full, r_full

    def _record_batch_spans(self, traces, granted, ops: np.ndarray,
                            t_start: float) -> None:
        """One ``fe.batch`` span per traced row of a native micro-batch,
        parented on the row's wire context. ``granted=None`` marks the
        whole batch errored."""
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            return
        tr_hi, tr_lo, tr_par, tr_fl = traces
        t_end = time.perf_counter()
        for i in np.nonzero(tr_fl & 1)[0].tolist():
            ctx = tracing.TraceContext(int(tr_hi[i]), int(tr_lo[i]),
                                       int(tr_par[i]),
                                       1 if tr_fl[i] & 2 else 0)
            if granted is None or granted[i] == _ROW_SKIP:
                # The whole batch failed, or the row was answered with a
                # placement error (MOVED, handoff deferral).
                status = "error"
            else:
                status = "ok" if granted[i] else "denied"
            tracer.record_span(
                "fe.batch", ctx, t_start, t_end, status=status,
                attrs={"op": wire.op_name(int(ops[i]))})

    async def _serve_bulk(self, sh: int, jid: int, conn_id: int, seq: int,
                          flags: int, a: float, b: float,
                          keys: "wire.KeyBlob", counts: np.ndarray,
                          residue: np.ndarray, tctx=None) -> None:
        """Loop half of the native bulk lane: decide the residue rows the C
        side could not (cold keys, windows, probes) with the same store
        entry the asyncio server's ACQUIRE_MANY branch calls, then
        ``fe_bulk_complete`` merges the verdicts and encodes RESP_BULK in C.
        The placement gate runs as the asyncio lane's does: a frame with a
        moved row answers the frame-level MOVED through ``fe_send`` and
        ``fe_bulk_discard`` (no row applied); parked rows serve from their
        handoff envelopes after the store's rows. Rows tier-0 already
        granted in a frame that then meets a gate stay debited through the
        sync lane (the tier-0 epsilon). The key blob is C memory: the store
        resolves it to slots before its first await (the card store's bulk
        plan), and the job stays alive until ``fe_bulk_complete`` /
        ``fe_bulk_fail`` / ``fe_bulk_discard`` below."""
        lib = self._lib
        n = len(keys)
        try:
            with_rem = bool(flags & wire._FLAG_WITH_REMAINING)
            kind = (flags & wire._KIND_MASK) >> wire._KIND_SHIFT
            moved = self._gated(kind, a, b)
            if moved is not None:
                # A retired config: the frame-level routable moved error,
                # byte for byte the asyncio gate's (no residue row applied,
                # so the translated re-send is not a replay).
                self._send(sh, conn_id, wire.encode_response(
                    seq, wire.RESP_ERROR, moved))
                lib.fe_bulk_discard(sh, jid)
                return
            env = self._server._drain_envelope
            if env is not None:
                # Draining: every row from the shutdown envelope (config
                # gate first, then the drain, then placement: the asyncio
                # lane's order), the C job discarded.
                self._send(sh, conn_id, self._server._serve_bulk_draining(
                    seq, keys, counts, a, b, with_rem, kind, env))
                lib.fe_bulk_discard(sh, jid)
                return
            gate = self._placement_gate(keys)
            if gate is not None and gate[2].any():
                self._send(sh, conn_id, wire.encode_response(
                    seq, wire.RESP_ERROR,
                    self._server._bulk_moved(keys, gate)))
                lib.fe_bulk_discard(sh, jid)
                return
            rn = len(residue)
            granted = np.zeros(rn, np.uint8)
            remaining = np.zeros(rn, np.float64)
            espan = tracing._NULL_SPAN
            if tctx is not None:
                tracer = tracing.get_tracer()
                if tracer.enabled:
                    espan = tracer.start_span(
                        "fe.bulk", parent=tctx,
                        attrs={"n": n, "residue": rn})
            with espan:
                if gate is None:
                    # A whole-frame residue keeps the zero-copy KeyBlob
                    # (the tier-0-cold and window-kind shape); a partial
                    # residue decodes only its own minority.
                    sub_keys = (keys if rn == n
                                else [keys[int(i)] for i in residue])
                    sub_counts = counts if rn == n else counts[residue]
                    res = await self._server._bulk_store_call(
                        sub_keys, sub_counts, a, b, kind, with_rem)
                    granted = np.asarray(res.granted, np.uint8)
                    if res.remaining is not None:
                        remaining = np.asarray(res.remaining, np.float64)
                else:
                    # The residue's owned rows in one store call, then
                    # its parked rows from their envelopes.
                    await placement.serve_gated_bulk(
                        self._server.placement, gate, keys, counts,
                        residue, a, b, kind,
                        lambda ks, cs: self._server._bulk_store_call(
                            ks, cs, a, b, kind, with_rem),
                        granted, remaining)
            c = ctypes
            lib.fe_bulk_complete(
                sh, jid,
                np.ascontiguousarray(granted).ctypes.data_as(
                    c.POINTER(c.c_uint8)),
                np.ascontiguousarray(remaining).ctypes.data_as(
                    c.POINTER(c.c_double)))
        except Exception as exc:  # noqa: BLE001 — every frame must get
            log.error_evaluating_kernel(exc)  # a routable error reply
            lib.fe_bulk_fail(sh, jid, repr(exc)[:200].encode())

    async def _serve_passthrough(self, sh: int, conn_id: int,
                                 body: bytes) -> None:
        try:
            op = body[5] if len(body) >= 6 else 0
            if op == wire.OP_HELLO:
                await self._serve_hello(sh, conn_id, body)
                return
            if op != wire.OP_ACQUIRE_MANY:
                await self._serve_passthrough_inner(sh, conn_id, body)
                return
            # Only MALFORMED bulk frames (or any bulk frame with the bulk
            # lane off) come here. They run as tasks of their own, so a
            # long store call cannot stall the pump's other passthrough
            # work; chained chunks order behind the connection's tail.
            prev = (self._bulk_tails.get((sh, conn_id))
                    if wire.bulk_request_chained(body) else None)
            task = self._track_task(
                self._serve_passthrough_inner(sh, conn_id, body,
                                              after=prev))
            self._bulk_tails[(sh, conn_id)] = task

            def _clear(t, key=(sh, conn_id)):
                if self._bulk_tails.get(key) is t:
                    del self._bulk_tails[key]

            task.add_done_callback(_clear)
        except Exception as exc:  # noqa: BLE001
            log.error_evaluating_kernel(exc)

    async def _serve_passthrough_inner(self, sh: int, conn_id: int,
                                       body: bytes,
                                       after: "asyncio.Task | None" = None
                                       ) -> None:
        if after is not None:
            await asyncio.gather(after, return_exceptions=True)
        resp = await self._server.handle_frame_body(body)
        self._send(sh, conn_id, resp)

    async def _serve_hello(self, sh: int, conn_id: int, body: bytes) -> None:
        import hmac

        try:
            seq, _, token, _, _, _ = wire.decode_request(body)
        except Exception:
            self._send(sh, conn_id, wire.encode_response(
                0, wire.RESP_ERROR, "malformed HELLO frame"))
            self._lib.fe_close_conn(sh, conn_id)
            return
        auth_token = self._server.auth_token
        # surrogateescape on both sides, as the asyncio listener compares:
        # a token of invalid UTF-8 fails cleanly instead of raising.
        if auth_token is not None and not hmac.compare_digest(
                token.encode("utf-8", "surrogateescape"),
                auth_token.encode("utf-8", "surrogateescape")):
            self._send(sh, conn_id, wire.encode_response(
                seq, wire.RESP_ERROR, "authentication failed"))
            self._lib.fe_close_conn(sh, conn_id)
            return
        self._lib.fe_set_authed(sh, conn_id, 1)
        self._send(sh, conn_id, wire.encode_response(seq, wire.RESP_EMPTY))

    def _send(self, sh: int, conn_id: int, resp: bytes) -> None:
        self._lib.fe_send(sh, conn_id, resp, len(resp))

    # -- tier-0 sync pump ----------------------------------------------------

    def _t0_harvest(self) -> dict[tuple[str, float, float], float]:
        """Drain accumulated local grants out of the C replica table:
        ``{(key, capacity, rate): amount}``."""
        c = ctypes
        blob, klens = self._t0_blob, self._t0_klens
        amounts, caps, rates = (self._t0_amounts, self._t0_caps,
                                self._t0_rates)
        n = self._lib.fe_t0_harvest(
            self._h, blob, len(blob),
            klens.ctypes.data_as(c.POINTER(c.c_int32)),
            amounts.ctypes.data_as(c.POINTER(c.c_double)),
            caps.ctypes.data_as(c.POINTER(c.c_double)),
            rates.ctypes.data_as(c.POINTER(c.c_double)), len(klens))
        if n <= 0:
            return {}
        # string_at copies only the used prefix of the buffer.
        used = ctypes.string_at(blob, int(klens[:n].sum()))
        keys = wire.decode_key_blob(used, klens[:n],
                                    errors="surrogateescape")
        # SUM duplicate idents: with N shards each hosts its own replica
        # slice, so one harvest can return a key once per shard — debited
        # once, acked back into every slice (fe_t0_ack fans out).
        out: dict[tuple[str, float, float], float] = {}
        for i, k in enumerate(keys):
            ident = (k, float(caps[i]), float(rates[i]))
            out[ident] = out.get(ident, 0.0) + float(amounts[i])
        return out

    def _t0_retire(self, cap: float, rate: float) -> list[tuple[str, float]]:
        """Kill every C replica of one retired (cap, rate) config and return
        its un-harvested ``(key, amount)`` grants, in one locked call, so
        no grant slips between a harvest and the kill."""
        c = ctypes
        blob, klens, amounts = self._t0_blob, self._t0_klens, \
            self._t0_amounts
        n = self._lib.fe_t0_retire(
            self._h, cap, rate, blob, len(blob),
            klens.ctypes.data_as(c.POINTER(c.c_int32)),
            amounts.ctypes.data_as(c.POINTER(c.c_double)), len(klens))
        if n <= 0:
            return []
        used = ctypes.string_at(blob, int(klens[:n].sum()))
        keys = wire.decode_key_blob(used, klens[:n],
                                    errors="surrogateescape")
        return [(k, float(amounts[i])) for i, k in enumerate(keys)]

    def _t0_ack(self, keys: list[str], cap: float, rate: float,
                remaining: np.ndarray) -> None:
        c = ctypes
        n = len(keys)
        kb = [k.encode("utf-8", "surrogateescape") for k in keys]
        klens = np.fromiter((len(b) for b in kb), np.int32, n)
        caps = np.full(n, cap, np.float64)
        rates = np.full(n, rate, np.float64)
        rem = np.ascontiguousarray(remaining, np.float64)
        self._lib.fe_t0_ack(
            self._h, b"".join(kb),
            klens.ctypes.data_as(c.POINTER(c.c_int32)),
            caps.ctypes.data_as(c.POINTER(c.c_double)),
            rates.ctypes.data_as(c.POINTER(c.c_double)),
            rem.ctypes.data_as(c.POINTER(c.c_double)), n)

    async def _t0_sync_loop(self) -> None:
        """Reconciliation pump: every ``sync_interval_s``, harvest each
        replica's local grants, debit them from the store in one
        ``debit_many`` per (capacity, rate) config — one ``debit_packed``
        launch on a card store — and ack the fresh balances back into the
        replica table (which re-sizes every key's budget). A failed round
        carries its amounts into the next instead of dropping them; the C
        side meanwhile serves within each key's last-acked envelope."""
        cfg = self._tier0
        assert cfg is not None
        store = self._server.store
        recorder = getattr(self._server, "flight_recorder", None)
        hh = getattr(self._server, "heavy_hitters", None)
        while True:
            await asyncio.sleep(cfg.sync_interval_s)
            self._harvest_tier0_traces()
            # Everything harvested was already zeroed out of the C table:
            # until it is debited it exists ONLY in `merged`, so every exit
            # path — a failed config, an unexpected error, cancellation
            # mid-await (aclose) — routes the remainder back into the carry
            # dict in the finally; successful groups pop themselves first.
            merged = self._t0_carry
            self._t0_carry = {}
            round_failures = 0
            round_keys = 0
            round_shortfall = 0.0
            try:
                for ident, amount in self._t0_harvest().items():
                    merged[ident] = merged.get(ident, 0.0) + amount
                    if hh is not None:
                        # The keys the pump drains ARE the tier-0 hot set.
                        hh.offer(ident[0], amount)
                if not merged:
                    self._t0_fail_streak = 0
                    continue
                if faults._INJECTOR is not None:  # chaos seam: fails the
                    # round; the rows re-carry through the finally
                    await faults._INJECTOR.on_event("t0.sync")
                by_cfg: dict[tuple[float, float], list] = {}
                for (key, cap, rate), amount in merged.items():
                    by_cfg.setdefault((cap, rate), []).append((key, amount))
                lc = self._server.liveconfig
                for (cap, rate), rows in by_cfg.items():
                    # A retired config (a mutation committed since these
                    # replicas were installed): kill its C replicas with
                    # _t0_retire, one locked call that also returns the
                    # grants admitted since the harvest, and debit every
                    # grant through the replacement config's table, the
                    # one the rebase carried the balances into. Dead
                    # replicas make later stale frames fall through to the
                    # batch lane's "config moved"; the over-admission is
                    # bounded by one sync interval's headroom.
                    fwd = (lc.forward("bucket", cap, rate)
                           if lc.active else None)
                    if fwd is not None:
                        for key, amount in self._t0_retire(cap, rate):
                            ident = (key, cap, rate)
                            merged[ident] = merged.get(ident, 0.0) + amount
                        rows = [(k, a) for (k, c2, r2), a in merged.items()
                                if (c2, r2) == (cap, rate)]
                    keys = [k for k, _ in rows]
                    amounts = [a for _, a in rows]
                    dcap, drate = (cap, rate) if fwd is None else fwd[:2]
                    try:
                        remaining, shortfall = await store.debit_many(
                            keys, amounts, dcap, drate)
                    except asyncio.CancelledError:
                        raise
                    except Exception as exc:  # degraded: rows stay in
                        # `merged` and re-carry through the finally
                        log.error_evaluating_kernel(exc)
                        self.t0_metrics.sync_failures += 1
                        round_failures += 1
                        continue
                    if fwd is not None:
                        # No ack: the retired replicas are dead.
                        self.t0_metrics.retired_config_rows += len(keys)
                    else:
                        self._t0_ack(keys, cap, rate, remaining)
                    self.t0_metrics.record_sync(len(keys), shortfall,
                                                time.monotonic())
                    round_keys += len(keys)
                    round_shortfall += float(np.sum(shortfall))
                    for k in keys:
                        merged.pop((k, cap, rate), None)
            except asyncio.CancelledError:
                raise
            except Exception as exc:  # the pump outlives any bad round
                log.error_evaluating_kernel(exc)
                self.t0_metrics.sync_failures += 1
                round_failures += 1
            finally:
                for ident, amount in merged.items():
                    if amount > 0.0:
                        self._t0_carry[ident] = (
                            self._t0_carry.get(ident, 0.0) + amount)
                self._t0_record_round(recorder, round_keys,
                                      round_shortfall, round_failures)

    def _harvest_tier0_traces(self) -> None:
        """Drain the C ring of traced tier-0 local decisions into the
        tracer, one completed ``fe.tier0`` span each: a request that never
        left the C loop still contributes its hop. Start and duration were
        stamped in C on CLOCK_MONOTONIC, the epoch ``perf_counter`` reads."""
        tracer = tracing.get_tracer()
        if not tracer.enabled:
            return
        buf = np.zeros(6 * 256, np.uint64)
        while True:
            got = self._lib.fe_trace_harvest(
                self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                256)
            if got <= 0:
                return
            recs = buf[:6 * got].reshape(got, 6)
            for hi, lo, parent, start_ns, dur_ns, meta in recs.tolist():
                ctx = tracing.TraceContext(int(hi), int(lo), int(parent),
                                           1 if int(meta) & 2 else 0)
                tracer.record_span(
                    "fe.tier0", ctx, start_ns * 1e-9,
                    (start_ns + dur_ns) * 1e-9,
                    status="ok" if int(meta) & 0x100 else "denied",
                    attrs={"op": wire.op_name((int(meta) >> 16) & 0xFF),
                           "local": True})
            if got < 256:
                return

    #: Cadence of the bulk lane's hot-key harvest (C ring → sketch). The
    #: ring is bounded (oldest drop), so a slower drain costs tail
    #: fidelity, never memory.
    _HOT_HARVEST_S = 0.5

    async def _hot_harvest_loop(self) -> None:
        """Drain the C bulk lane's per-frame top-K ring into the server's
        heavy-hitter sketch (bulk keys never become Python strings)."""
        hh = self._server.heavy_hitters
        blob = ctypes.create_string_buffer(256 * 256)
        klens = np.zeros(256, np.int32)
        weights = np.zeros(256, np.float64)
        c = ctypes
        while True:
            await asyncio.sleep(self._HOT_HARVEST_S)
            while True:
                got = self._lib.fe_hot_harvest(
                    self._h, blob, len(blob),
                    klens.ctypes.data_as(c.POINTER(c.c_int32)),
                    weights.ctypes.data_as(c.POINTER(c.c_double)), 256)
                if got <= 0:
                    break
                used = ctypes.string_at(blob, int(klens[:got].sum()))
                keys = wire.decode_key_blob(used, klens[:got],
                                            errors="surrogateescape")
                for k, w in zip(keys, weights[:got].tolist()):
                    hh.offer(k, w)
                if got < 256:
                    break

    # -- stats ---------------------------------------------------------------

    def bulk_stats(self) -> dict | None:
        """C-side native-bulk gauges (``None`` when the lane is off).
        ``rows_local`` are per-row tier-0 decisions made without leaving C;
        ``permits_local`` is the granted amount the sync pump debits."""
        if not self._bulk_native:
            return None
        counts = (ctypes.c_longlong * 7)()
        self._lib.fe_bulk_counts(self._h, counts)
        (frames, frames_local, rows, rows_local, rows_residue,
         permits_local, hot_dropped) = (int(v) for v in counts)
        return {
            "frames": frames,
            "frames_local": frames_local,
            "rows": rows,
            "rows_local": rows_local,
            "rows_residue": rows_residue,
            "permits_local": permits_local,
            "hot_ring_dropped": hot_dropped,
        }

    #: Consecutive failed sync rounds that count as a degraded-mode streak
    #: and trip the flight recorder.
    T0_STREAK_DUMP = 3

    def _t0_record_round(self, recorder, n_keys: int, shortfall: float,
                         failures: int) -> None:
        """Per-sync flight-recorder frame, and a dump on entry into a
        failure streak of :data:`T0_STREAK_DUMP` rounds."""
        if failures:
            self._t0_fail_streak += 1
        else:
            self._t0_fail_streak = 0
        if recorder is None:
            return
        recorder.record("t0_sync", keys=n_keys, shortfall=shortfall,
                        failures=failures, streak=self._t0_fail_streak,
                        carry_keys=len(self._t0_carry))
        if self._t0_fail_streak == self.T0_STREAK_DUMP:
            recorder.auto_dump(
                "t0_sync_streak",
                {"streak": self._t0_fail_streak,
                 "carry_keys": len(self._t0_carry)})

    def tier0_stats(self) -> dict | None:
        """Merged C and pump-side tier-0 gauges (``None`` when disabled)."""
        if self._tier0 is None:
            return None
        counts = (ctypes.c_longlong * 6)()
        self._lib.fe_t0_counts(self._h, counts)
        hits, denies, misses, installs, evictions, entries = (
            int(v) for v in counts)
        eligible = hits + denies + misses
        out = {
            "hits": hits,
            "local_denies": denies,
            "misses": misses,
            "hit_rate": (hits + denies) / eligible if eligible else 0.0,
            "installs": installs,
            "evictions": evictions,
            "entries": entries,
            "carry_keys": len(self._t0_carry),
            **self.t0_metrics.snapshot(time.monotonic()),
        }
        # The C-side ε witness: cumulative locally granted tokens summed
        # over the slices — the audit plane's tier-0 "admitted" side.
        out["grant_tokens"] = sum(self.t0_eps_tokens())
        return out

    def t0_eps_tokens(self) -> "list[float] | None":
        """Per-slice cumulative locally granted tokens (``fe_t0_eps``);
        ``None`` when tier-0 is off."""
        if self._tier0 is None:
            return None
        buf = (ctypes.c_double * max(1, self.n_shards))()
        n = self._lib.fe_t0_eps(self._h, buf, len(buf))
        return [float(buf[i]) for i in range(int(n))]

    def shard_stats(self) -> "list[dict] | None":
        """Per-shard breakdown of the serving, tier-0 and bulk gauges
        (``None`` single-shard). The top-level gauges are the whole-node
        sums over the same state, so ``sum(shards[*].x) == merged x``."""
        if self.n_shards <= 1:
            return None
        c = ctypes
        out: list[dict] = []
        for i, sh in enumerate(self._shards):
            req, conns, batches = c.c_longlong(), c.c_longlong(), \
                c.c_longlong()
            self._lib.fe_counts(sh, c.byref(req), c.byref(conns),
                                c.byref(batches))
            row: dict = {"shard": i, "requests_served": req.value,
                         "connections_served": conns.value,
                         "batches_flushed": batches.value}
            if self._tier0 is not None:
                t0 = (c.c_longlong * 6)()
                self._lib.fe_t0_counts(sh, t0)
                row["tier0"] = {
                    "hits": int(t0[0]), "local_denies": int(t0[1]),
                    "misses": int(t0[2]), "installs": int(t0[3]),
                    "evictions": int(t0[4]), "entries": int(t0[5]),
                }
                eps = (c.c_double * 1)()
                if self._lib.fe_t0_eps(sh, eps, 1) == 1:
                    row["tier0"]["grant_tokens"] = float(eps[0])
            if self._bulk_native:
                bk = (c.c_longlong * 7)()
                self._lib.fe_bulk_counts(sh, bk)
                row["native_bulk"] = {
                    "frames": int(bk[0]), "frames_local": int(bk[1]),
                    "rows": int(bk[2]), "rows_local": int(bk[3]),
                    "rows_residue": int(bk[4]),
                    "permits_local": int(bk[5]),
                }
            out.append(row)
        return out

    def uring_reasons(self) -> dict[int, str]:
        """``{shard: reason}`` of every shard serving on epoll although
        io_uring was requested (empty when none fell back)."""
        if self.uring_mode == URING_OFF:
            return {}
        buf = ctypes.create_string_buffer(256)
        out = {}
        for i in range(self.n_shards):
            if self._lib.fe_uring_reason(self._h, i, buf, len(buf)) == 0:
                out[i] = (buf.value.decode("utf-8", "replace")
                          or "no reason recorded")
        return out

    def transport_stats(self) -> dict | None:
        """Transport gauges: shard counts by transport, ring counters
        (enter syscalls, SQEs submitted, CQEs reaped), the data-plane
        syscall counter both transports keep, and the per-shard fallback
        reasons when uring was requested but a shard serves on epoll."""
        if self._h is None:
            return None
        counts = (ctypes.c_longlong * 8)()
        self._lib.fe_uring_counts(self._h, counts)
        out = {
            "mode": {URING_OFF: "epoll", URING_ON: "uring",
                     URING_SQPOLL: "uring+sqpoll"}[self.uring_mode],
            "uring_shards": int(counts[0]),
            "sqpoll_shards": int(counts[1]),
            "enters": int(counts[2]),
            "sqes_submitted": int(counts[3]),
            "cqes_seen": int(counts[4]),
            "io_syscalls": int(counts[5]),
            "fallbacks": int(counts[6]),
        }
        if out["fallbacks"]:
            reasons = self.uring_reasons()
            if reasons:
                out["fallback_reasons"] = reasons
        return out

    def counts(self) -> tuple[int, int, int]:
        """``(requests_served, connections_served, batches_flushed)`` in
        one locked C call."""
        c = ctypes
        req, conns, batches = c.c_longlong(), c.c_longlong(), c.c_longlong()
        self._lib.fe_counts(self._h, c.byref(req), c.byref(conns),
                            c.byref(batches))
        return req.value, conns.value, batches.value

    def latency_histogram(self) -> LatencyHistogram:
        """The C serving histogram (arrival → completion) in the shared
        class: the same 82 log-1.25 buckets, so quantiles read alike."""
        return self._stage_histogram(0)

    def _stage_histogram(self, stage: int) -> LatencyHistogram:
        counts = np.zeros(LatencyHistogram.N_BUCKETS, np.uint64)
        sum_s = ctypes.c_double()
        total = self._lib.fe_stage_hist(
            self._h, stage,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.byref(sum_s))
        hist = LatencyHistogram()
        hist.counts = [int(x) for x in counts]
        hist.total = int(total)
        hist.sum_s = float(sum_s.value)
        return hist

    def stage_histograms(self) -> "dict[str, LatencyHistogram]":
        """The C side's split of the serving span: ``native_queue`` (frame
        parsed → batch cut) and ``native_exec`` (batch cut → completion:
        Python dispatch, the store and the kernel)."""
        return {"native_queue": self._stage_histogram(1),
                "native_exec": self._stage_histogram(2)}

    def reset_latency(self) -> None:
        self._lib.fe_hist_reset(self._h)  # the stage histograms with it

    # -- lifecycle -----------------------------------------------------------

    async def aclose(self) -> None:
        if self._stopping:
            return
        self._stopping = True
        # Order matters: (0) stop the tier-0 sync pump and the hot-key
        # harvest — both read the C handle; (1) fe_stop joins the IO
        # threads — no new frames; (2) the pumps see -1 from fe_wait and
        # exit — no new loop tasks; (3) drain the loop tasks still in
        # flight, whose fe_complete / fe_send calls need the handle alive
        # (the sockets are gone, so the replies fall into the void); only
        # then (4) free the handle.
        for attr in ("_t0_task", "_hot_task"):
            task = getattr(self, attr)
            if task is not None:
                task.cancel()
                try:
                    await task
                except (asyncio.CancelledError, Exception):  # noqa: BLE001
                    pass
                setattr(self, attr, None)
        await asyncio.to_thread(self._lib.fe_stop, self._h)
        for pump in self._pumps:
            await asyncio.to_thread(pump.join, 5.0)
        while self._loop_tasks:
            # A loop, not one gather: a bulk passthrough parent can spawn
            # its child after the snapshot was taken.
            await asyncio.gather(*list(self._loop_tasks),
                                 return_exceptions=True)
        if any(pump.is_alive() for pump in self._pumps):
            # A pump blew past the join timeout and may still be inside
            # fe_wait holding the handle: freeing now would be a
            # use-after-free on its next C call. Leak the handle instead
            # (one struct; the sockets are closed) and say so.
            logger.error(
                "native front-end pump thread still alive after 5s; "
                "leaking the C handle instead of freeing under it")
            self._h = None
            return
        self._lib.fe_free(self._h)
        self._h = None


#: Ops the load generator drives (all share the keyed-request frame layout;
#: (a, b) mean (capacity, rate) / (limit, window_s) / (limit, -)).
_LOADGEN_OPS = {
    "acquire": wire.OP_ACQUIRE,
    "window": wire.OP_WINDOW,
    "fixed_window": wire.OP_FWINDOW,
    "sema": wire.OP_SEMA,
}


def native_loadgen(host: str, port: int, *, conns: int = 4, depth: int = 32,
                   reqs_per_conn: int = 10000, keyspace: int = 1000,
                   capacity: float = 1e7, fill_rate: float = 1e7,
                   op: str = "acquire") -> tuple[int, int, float]:
    """Closed-loop native measurement client: ``conns`` connections each
    keeping ``depth`` pipelined requests of ``op`` in flight, in C (one
    epoll thread), so a Python client's per-request scheduling does not
    bound the measurement. Returns ``(replies, granted, elapsed_s)``.
    Blocks its caller: from async code, run it in a thread."""
    if op not in _LOADGEN_OPS:
        raise ValueError(f"unknown loadgen op {op!r}; choose from "
                         f"{sorted(_LOADGEN_OPS)}")
    lib = load_frontend_lib()
    c = ctypes
    elapsed, replies, granted = c.c_double(), c.c_longlong(), c.c_longlong()
    rc = lib.fe_loadgen(host.encode(), port, conns, depth, reqs_per_conn,
                        keyspace, capacity, fill_rate, _LOADGEN_OPS[op],
                        c.byref(elapsed), c.byref(replies),
                        c.byref(granted))
    if rc != 0:
        raise OSError("native loadgen failed to connect")
    return replies.value, granted.value, elapsed.value


def native_bulk_loadgen(host: str, port: int, *, conns: int = 8,
                        depth: int = 4, frames_per_conn: int = 200,
                        rows_per_frame: int = 4096, keyspace: int = 64,
                        capacity: float = 1e8, fill_rate: float = 1e8,
                        uring: bool = False
                        ) -> tuple[int, int, int, float]:
    """Closed-loop native BULK measurement client: ``conns`` connections
    each keeping ``depth`` pipelined ``OP_ACQUIRE_MANY`` frames of
    ``rows_per_frame`` rows in flight, frames built and replies counted in
    C (``fe_lg_bulk``). Returns ``(frames, rows, granted_rows,
    elapsed_s)``. ``uring=True`` drives the frames through the loadgen's
    own submission ring (``fe_lg_bulk_uring``); where the host has no ring
    it says so and runs the syscall client."""
    lib = load_frontend_lib()
    c = ctypes
    elapsed = c.c_double()
    frames, rows, granted = c.c_longlong(), c.c_longlong(), c.c_longlong()
    if uring:
        rc = lib.fe_lg_bulk_uring(
            host.encode(), port, conns, depth, frames_per_conn,
            rows_per_frame, keyspace, capacity, fill_rate,
            c.byref(elapsed), c.byref(frames), c.byref(rows),
            c.byref(granted))
        if rc == 0:
            return frames.value, rows.value, granted.value, elapsed.value
        if rc != -2:
            raise OSError("native uring bulk loadgen failed to connect")
        logger.warning("uring bulk loadgen requested but no ring is "
                       "available on this host; using the syscall client")
    rc = lib.fe_lg_bulk(host.encode(), port, conns, depth, frames_per_conn,
                        rows_per_frame, keyspace, capacity, fill_rate,
                        c.byref(elapsed), c.byref(frames), c.byref(rows),
                        c.byref(granted))
    if rc != 0:
        raise OSError("native bulk loadgen failed to connect")
    return frames.value, rows.value, granted.value, elapsed.value
