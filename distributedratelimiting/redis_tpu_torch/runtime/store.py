"""The bucket store — where rate-limit state lives and decisions execute.

The JAX package's ``runtime/store.py`` on PyTorch:

- :class:`BucketStore` — the storage seam (abstract). The bucket, counter,
  window (sliding and fixed) and semaphore methods are the contract; the
  two-level (tenant → key) admission methods default to a sequential
  compose; ``debit_many`` is for stores that host tier-0 replicas;
  ``reserve`` and ``settle`` go through the store's one
  :class:`~.reservations.ReservationLedger`; ``export_entries`` is the
  live-migration export (:mod:`~.placement`), the snapshot filtered by
  key.
- :class:`InProcessBucketStore` — the serial, pure-Python store with the
  same semantics, one "script" per request and no batching, in Python
  floats: the differential oracle of the device store and the bench's
  kernel-free backing. Only a caller who names it gets it; nothing
  constructs it in place of a :class:`DeviceBucketStore`.
- :class:`DeviceBucketStore` — per-key bucket state lives on the device
  as SoA tensors, one table per bucket configuration ``(capacity,
  fill_rate)``; ``acquire`` calls are micro-batched into one packed
  ``i32[4|5, B]`` operand, one kernel launch and one ``f32[2, B]`` readback.
  The approximate bucket's global counters live in one counter table; a
  sync (one limiter's, or a whole fleet's through ``sync_counters_many``)
  is one ``i32[3, B]`` operand, one launch and one ``f32[2, B]`` readback.
  Window limiters (sliding, and fixed with no interpolation) live in one
  window table per ``(limit, window_ticks, fixed)`` with the same operands,
  batching and bulk lane. Concurrency semaphores live in one semaphore
  table (``i32[4, B]`` operand, one launch a call or a 4096-row chunk);
  two-level admission decides a key's bucket and its tenant's bucket in one
  launch per ``max_batch`` rows; the tier-0 debit is one launch for all its
  rows. The store's clock stamps every launch. Tables grow by doubling and
  reclaim slots with TTL sweeps; every table resolves keys through the
  native key directory when it builds. The store builds its tables from
  ``_TABLE_CLS`` / ``_WTABLE_CLS``; the fingerprint store
  (:mod:`.fp_store`) swaps in tables whose directory lives on the card.
  With ``enable_dirty_tracking`` the
  tables count the slots they resolve between two checkpoint saves (host
  bookkeeping for the incremental chain's gauge, :mod:`.checkpoint`).

The store runs on ``cuda`` by default, where every decision, sync and sweep
goes through the hand-written kernels of :mod:`..ops.cuda_kernels`. It runs on
the CPU only when the caller passes ``device="cpu"`` (the kernels' plain
versions then decide); with no GPU and no such request, construction
raises. State tensors are updated in place (the JAX store donated them).
"""

from __future__ import annotations

import abc
import asyncio
import threading
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime.batcher import MicroBatcher
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    Clock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.directory import (
    make_directory,
)
from distributedratelimiting.redis_tpu_torch.utils import faults, log
from distributedratelimiting.redis_tpu_torch.utils.metrics import StoreMetrics
from distributedratelimiting.redis_tpu_torch.utils.tracing import (
    Profiler,
    ProfilingSession,
)

__all__ = [
    "AcquireResult",
    "BulkAcquireResult",
    "BucketStore",
    "DeviceBucketStore",
    "InProcessBucketStore",
    "SyncResult",
    "check_hierarchical_args",
]


def check_hierarchical_args(count: int, tenant_capacity: float,
                            tenant_fill_rate_per_sec: float,
                            capacity: float,
                            fill_rate_per_sec: float) -> None:
    """The one validation of every hierarchical lane (in process, client,
    server): costs are non-negative (a negative cost would mint tokens
    through the refund), and the tenant and key configs differ (identical
    ``(capacity, fill_rate)`` would alias both levels into one table — a
    flat limiter spelled twice, not a hierarchy)."""
    if count < 0:
        raise ValueError("hierarchical acquire cost must be >= 0")
    if (float(tenant_capacity), float(tenant_fill_rate_per_sec)) == \
            (float(capacity), float(fill_rate_per_sec)):
        raise ValueError(
            "hierarchical acquire requires distinct tenant and key "
            "configs (identical (capacity, fill_rate) would alias the "
            "two levels into one table)")

# Host tick value at which the store rebases its epoch (≪ int32 max), and
# how much history the new epoch keeps (2^29 ticks, ~6 days).
_REBASE_THRESHOLD_TICKS = 2**30
_REBASE_MARGIN_TICKS = 2**29


def _shift_ts(ts, shift: int) -> np.ndarray:
    """Re-align stored tick timestamps to a new clock epoch: widen to
    int64, shift, and saturate back into int32 range."""
    shifted = np.asarray(ts).astype(np.int64) + shift
    return np.clip(shifted, -(2**31) + 1, 2**31 - 1).astype(np.int32)


class AcquireResult(NamedTuple):
    granted: bool
    remaining: float  # post-decision token estimate (≙ Lua reply new_v)


class BulkAcquireResult:
    """Vectorized decision results: numpy arrays, not per-request objects."""

    __slots__ = ("granted", "remaining")

    def __init__(self, granted: np.ndarray,
                 remaining: np.ndarray | None) -> None:
        self.granted = granted        # bool[n]
        # f32[n]; None when the caller opted out (``with_remaining=False``,
        # the verdict-only path — 1 bit/decision comes back).
        self.remaining = remaining

    def __len__(self) -> int:
        return len(self.granted)

    def __getitem__(self, i: int) -> AcquireResult:
        r = 0.0 if self.remaining is None else float(self.remaining[i])
        return AcquireResult(bool(self.granted[i]), r)

    def __iter__(self):
        for i in range(len(self.granted)):
            yield self[i]

    @property
    def granted_count(self) -> int:
        return int(np.count_nonzero(self.granted))


class SyncResult(NamedTuple):
    global_score: float
    period_ewma_ticks: float


class _AcquireReq(NamedTuple):
    key: str
    count: int


class BucketStore(abc.ABC):
    """Abstract store. All rate arguments are per-second; conversion to
    per-tick happens at the store boundary."""

    clock: Clock

    @abc.abstractmethod
    async def connect(self) -> None:
        """Idempotent lazy init (≙ ``ConnectAsync``)."""

    # -- exact token bucket ------------------------------------------------
    @abc.abstractmethod
    async def acquire(self, key: str, count: int, capacity: float,
                      fill_rate_per_sec: float) -> AcquireResult: ...

    @abc.abstractmethod
    def acquire_blocking(self, key: str, count: int, capacity: float,
                         fill_rate_per_sec: float) -> AcquireResult:
        """Synchronous single-request path (a real, blocking decision)."""

    @abc.abstractmethod
    def peek_blocking(self, key: str, capacity: float,
                      fill_rate_per_sec: float) -> float:
        """Read-only availability estimate (``GetAvailablePermits``)."""

    def acquire_submitter(self, capacity: float, fill_rate_per_sec: float):
        """Per-request hot-path factory: an async ``(key, count) →
        AcquireResult`` bound to one bucket config. Default: a thin binding
        over :meth:`acquire`."""
        async def submit(key: str, count: int) -> AcquireResult:
            return await self.acquire(key, count, capacity,
                                      fill_rate_per_sec)

        return submit

    # -- bulk token bucket (one call, many keys) ---------------------------
    async def acquire_many(self, keys: Sequence[str], counts: Sequence[int],
                           capacity: float, fill_rate_per_sec: float, *,
                           with_remaining: bool = True) -> BulkAcquireResult:
        """Decide ``len(keys)`` requests in one call. Duplicate keys
        serialize in request order (conservatively on batched stores: an
        earlier same-key request's demand reserves ahead of later ones even
        if it is denied). Default: a gather over the per-key path."""
        results = await asyncio.gather(
            *(self.acquire(k, int(c), capacity, fill_rate_per_sec)
              for k, c in zip(keys, counts)))
        return BulkAcquireResult(
            np.fromiter((r.granted for r in results), bool, len(results)),
            np.fromiter((r.remaining for r in results), np.float32,
                        len(results)) if with_remaining else None)

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], capacity: float,
                              fill_rate_per_sec: float, *,
                              with_remaining: bool = True) -> BulkAcquireResult:
        results = [self.acquire_blocking(k, int(c), capacity,
                                         fill_rate_per_sec)
                   for k, c in zip(keys, counts)]
        return BulkAcquireResult(
            np.fromiter((r.granted for r in results), bool, len(results)),
            np.fromiter((r.remaining for r in results), np.float32,
                        len(results)) if with_remaining else None)

    # -- bulk windows (one call, many keys) --------------------------------
    async def window_acquire_many(self, keys: Sequence[str],
                                  counts: Sequence[int], limit: float,
                                  window_sec: float, *, fixed: bool = False,
                                  with_remaining: bool = True
                                  ) -> BulkAcquireResult:
        """Vectorized window acquire (sliding by default, ``fixed=True`` for
        fixed windows), with the in-call duplicate conservatism and probe
        semantics of :meth:`acquire_many`. Default: a gather over the
        per-key path; :class:`DeviceBucketStore` overrides it with scanned
        whole-array launches."""
        op = (self.fixed_window_acquire if fixed else self.window_acquire)
        results = await asyncio.gather(
            *(op(k, int(c), limit, window_sec)
              for k, c in zip(keys, counts)))
        return BulkAcquireResult(
            np.fromiter((r.granted for r in results), bool, len(results)),
            np.fromiter((r.remaining for r in results), np.float32,
                        len(results)) if with_remaining else None)

    def window_acquire_many_blocking(self, keys: Sequence[str],
                                     counts: Sequence[int], limit: float,
                                     window_sec: float, *,
                                     fixed: bool = False,
                                     with_remaining: bool = True
                                     ) -> BulkAcquireResult:
        op = (self.fixed_window_acquire_blocking if fixed
              else self.window_acquire_blocking)
        results = [op(k, int(c), limit, window_sec)
                   for k, c in zip(keys, counts)]
        return BulkAcquireResult(
            np.fromiter((r.granted for r in results), bool, len(results)),
            np.fromiter((r.remaining for r in results), np.float32,
                        len(results)) if with_remaining else None)

    # -- hierarchical tenant → key admission (runtime/admission.py) --------
    async def acquire_hierarchical(self, tenant: str, key: str, count: int,
                                   tenant_capacity: float,
                                   tenant_fill_rate_per_sec: float,
                                   capacity: float,
                                   fill_rate_per_sec: float, *,
                                   priority: int = 0) -> AcquireResult:
        """Two-level weighted-cost admission: granted iff BOTH the key's
        ``(capacity, fill_rate)`` bucket and its tenant's
        ``(tenant_capacity, tenant_fill_rate)`` bucket admit ``count``
        tokens, both debited or neither. ``remaining`` is ``min(child,
        parent)``. ``priority`` (``admission.PRIORITY_*``) never changes a
        decision here; wire stores stamp it on the frame.

        Default: parent then child, with a refund of the parent through
        :meth:`debit_many` (a negative amount) on a child deny where the
        store has that lane — under-admission only, never over.
        :class:`DeviceBucketStore` decides both levels in one launch;
        ``RemoteBucketStore`` sends one ``OP_ACQUIRE_H`` frame."""
        check_hierarchical_args(count, tenant_capacity,
                                tenant_fill_rate_per_sec, capacity,
                                fill_rate_per_sec)
        parent = await self.acquire(tenant, count, tenant_capacity,
                                    tenant_fill_rate_per_sec)
        if not parent.granted:
            return AcquireResult(False, parent.remaining)
        child = await self.acquire(key, count, capacity, fill_rate_per_sec)
        if child.granted:
            return AcquireResult(True, min(child.remaining,
                                           parent.remaining))
        if count > 0 and type(self).debit_many is not BucketStore.debit_many:
            # The refund can only under-credit: the next refill's capacity
            # clamp bounds a transient overshoot.
            await self.debit_many([tenant], [-float(count)],
                                  tenant_capacity, tenant_fill_rate_per_sec)
        return AcquireResult(False, child.remaining)

    def acquire_hierarchical_blocking(self, tenant: str, key: str,
                                      count: int, tenant_capacity: float,
                                      tenant_fill_rate_per_sec: float,
                                      capacity: float,
                                      fill_rate_per_sec: float, *,
                                      priority: int = 0) -> AcquireResult:
        """Blocking compose. It has no refund lane: a child deny leaves the
        parent debited (under-admission only)."""
        check_hierarchical_args(count, tenant_capacity,
                                tenant_fill_rate_per_sec, capacity,
                                fill_rate_per_sec)
        parent = self.acquire_blocking(tenant, count, tenant_capacity,
                                       tenant_fill_rate_per_sec)
        if not parent.granted:
            return AcquireResult(False, parent.remaining)
        child = self.acquire_blocking(key, count, capacity,
                                      fill_rate_per_sec)
        if child.granted:
            return AcquireResult(True, min(child.remaining,
                                           parent.remaining))
        return AcquireResult(False, child.remaining)

    async def acquire_hierarchical_many(self, tenants: Sequence[str],
                                        keys: Sequence[str],
                                        counts: Sequence[int],
                                        tenant_capacity: float,
                                        tenant_fill_rate_per_sec: float,
                                        capacity: float,
                                        fill_rate_per_sec: float, *,
                                        with_remaining: bool = True,
                                        priority: int = 0
                                        ) -> BulkAcquireResult:
        """Row ``i`` decides ``counts[i]`` tokens for ``(tenants[i],
        keys[i])``; same-key and same-tenant rows serialize in request
        order (conservatively on batched stores, on both axes). Default: a
        loop over :meth:`acquire_hierarchical`."""
        n = len(keys)
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32) if with_remaining else None
        for i in range(n):
            r = await self.acquire_hierarchical(
                tenants[i], keys[i], int(counts[i]), tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority)
            granted[i] = r.granted
            if remaining is not None:
                remaining[i] = r.remaining
        return BulkAcquireResult(granted, remaining)

    def acquire_hierarchical_many_blocking(self, tenants: Sequence[str],
                                           keys: Sequence[str],
                                           counts: Sequence[int],
                                           tenant_capacity: float,
                                           tenant_fill_rate_per_sec: float,
                                           capacity: float,
                                           fill_rate_per_sec: float, *,
                                           with_remaining: bool = True,
                                           priority: int = 0
                                           ) -> BulkAcquireResult:
        n = len(keys)
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32) if with_remaining else None
        for i in range(n):
            r = self.acquire_hierarchical_blocking(
                tenants[i], keys[i], int(counts[i]), tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority)
            granted[i] = r.granted
            if remaining is not None:
                remaining[i] = r.remaining
        return BulkAcquireResult(granted, remaining)

    # -- estimate-reserve-settle (runtime/reservations.py) -----------------
    def reservation_ledger(self, **kwargs):
        """Get-or-create this store's :class:`~.reservations.
        ReservationLedger` — ONE ledger per store, shared by every consumer
        (the server's OP_RESERVE/OP_SETTLE dispatch, in-process callers),
        so a hold taken by one is settled by another. ``kwargs`` configure
        the ledger on FIRST creation only; later callers get the existing
        instance. The ledger's ``asyncio.Lock`` binds to the first event
        loop that uses it: drive one store's ledger from one loop."""
        led = getattr(self, "_reservations", None)
        if led is None:
            from distributedratelimiting.redis_tpu_torch.runtime import (
                reservations,
            )

            led = self._reservations = reservations.ReservationLedger(
                self, **kwargs)
        return led

    async def reserve(self, rid: str, tenant: str, key: str,
                      estimate: "float | None",
                      tenant_capacity: float,
                      tenant_fill_rate_per_sec: float,
                      capacity: float, fill_rate_per_sec: float, *,
                      priority: int = 0,
                      ttl_s: "float | None" = None,
                      attempt: int = 0,
                      deadline_s: "float | None" = None):
        """Admit an ESTIMATED cost against the tenant → key budgets and
        hold a TTL'd reservation (:mod:`~.reservations` — the streaming
        lane for costs unknown until generation ends). Default: the
        store-attached ledger, whose decision is this store's
        :meth:`acquire_hierarchical` (one two-level launch on a card
        store, both levels debited or neither); ``RemoteBucketStore``
        overrides with one ``OP_RESERVE`` frame so the ledger lives
        server-side. ``attempt``/``deadline_s`` feed the ledger's
        retry and settle-vs-deadline counters."""
        return await self.reservation_ledger().reserve(
            rid, tenant, key, estimate, tenant_capacity,
            tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
            priority=priority, ttl_s=ttl_s, attempt=attempt,
            deadline_s=deadline_s)

    async def settle(self, rid: str, tenant: str, actual: float):
        """Reconcile a reservation's actual cost: refund over-estimates
        through the saturating negative-debit lane, carry under-estimates
        as per-tenant debt (idempotent by rid — see
        :meth:`~.reservations.ReservationLedger.settle`)."""
        return await self.reservation_ledger().settle(rid, tenant, actual)

    # -- tier-0 reconciliation --------------------------------------------
    async def debit_many(self, keys: Sequence[str],
                         amounts: Sequence[float], capacity: float,
                         fill_rate_per_sec: float
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Saturating bulk debit — drain permits an edge cache already
        granted out of the authoritative bucket table (refill, then
        subtract clamped at zero; a negative amount credits). Returns
        ``(remaining f64[n], shortfall f64[n])``: each key's post-debit
        balance and the part of its amount that found no tokens. Callers
        pre-aggregate per key. Stores that host no tier-0 replicas keep
        this default, which raises."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support tier-0 replica "
            "reconciliation (debit_many)")

    # -- sliding window ----------------------------------------------------
    @abc.abstractmethod
    async def window_acquire(self, key: str, count: int, limit: float,
                             window_sec: float) -> AcquireResult: ...

    @abc.abstractmethod
    def window_acquire_blocking(self, key: str, count: int, limit: float,
                                window_sec: float) -> AcquireResult: ...

    # -- fixed window (current-window count only, no interpolation) --------
    @abc.abstractmethod
    async def fixed_window_acquire(self, key: str, count: int, limit: float,
                                   window_sec: float) -> AcquireResult: ...

    @abc.abstractmethod
    def fixed_window_acquire_blocking(self, key: str, count: int,
                                      limit: float,
                                      window_sec: float) -> AcquireResult: ...

    # -- decaying global counter (the approximate bucket's shared tier) ----
    @abc.abstractmethod
    async def sync_counter(self, key: str, local_count: float,
                           decay_rate_per_sec: float) -> SyncResult: ...

    @abc.abstractmethod
    def sync_counter_blocking(self, key: str, local_count: float,
                              decay_rate_per_sec: float) -> SyncResult: ...

    async def sync_counters_many(self, keys: Sequence[str],
                                 local_counts: Sequence[float],
                                 decay_rate_per_sec: float
                                 ) -> tuple[np.ndarray, np.ndarray]:
        """Bulk decaying-counter sync — for a host running many
        approximate-limiter replicas, or an edge tier reconciling a whole
        key table, in one call instead of one :meth:`sync_counter` per key.
        Returns ``(global_scores f64[n], period_ewmas f64[n])`` row for row
        with ``keys``. Default: a sequential loop (same-key rows keep
        request order); :class:`DeviceBucketStore` overrides it with ONE
        kernel launch for the whole fleet."""
        scores = np.empty(len(keys), np.float64)
        periods = np.empty(len(keys), np.float64)
        for i, (k, c) in enumerate(zip(keys, local_counts)):
            res = await self.sync_counter(k, float(c), decay_rate_per_sec)
            scores[i] = res.global_score
            periods[i] = res.period_ewma_ticks
        return scores, periods

    # -- concurrency semaphore (held permits, returned on lease dispose) ---
    @abc.abstractmethod
    async def concurrency_acquire(self, key: str, count: int,
                                  limit: int) -> AcquireResult:
        """Atomically add ``count`` held permits iff ``active + count <=
        limit``; ``remaining`` is the post-op active count. ``count == 0``
        is a probe."""

    @abc.abstractmethod
    def concurrency_acquire_blocking(self, key: str, count: int,
                                     limit: int) -> AcquireResult: ...

    @abc.abstractmethod
    async def concurrency_release(self, key: str, count: int) -> None:
        """Return ``count`` held permits (clamped at zero held)."""

    @abc.abstractmethod
    def concurrency_release_blocking(self, key: str, count: int) -> None: ...

    async def concurrency_acquire_many(self, keys: Sequence[str],
                                       deltas: Sequence[int],
                                       limit: "int | Sequence[int]"
                                       ) -> BulkAcquireResult:
        """Signed semaphore ops in one call: +n acquires (all-or-nothing
        against the row's limit), -n releases (always, clamped at zero
        held), 0 probes; ``limit`` is a scalar or one per row. Same-key rows
        serialize in request order (acquire admission conservatively on
        batched stores). Rows: ``granted`` (releases True) and
        ``remaining``, the row's post-op active count (0.0 for releases,
        as the scalar wire reply). Default: an in-order loop over the
        per-key path."""
        n = len(keys)
        limits = self._sema_limits(limit, n)
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32)
        for i, (k, d) in enumerate(zip(keys, deltas)):
            d = int(d)
            if d >= 0:
                r = await self.concurrency_acquire(k, d, int(limits[i]))
                granted[i] = r.granted
                remaining[i] = r.remaining
            else:
                await self.concurrency_release(k, -d)
                granted[i] = True
                remaining[i] = 0.0
        return BulkAcquireResult(granted, remaining)

    @staticmethod
    def _sema_limits(limit, n: int) -> np.ndarray:
        """Broadcast a scalar-or-per-row ``limit`` to ``i64[n]``."""
        arr = np.asarray(limit, np.int64)
        if arr.ndim == 0:
            return np.full(n, int(arr), np.int64)
        if arr.shape != (n,):
            raise ValueError(
                f"limit must be a scalar or one per row: got shape "
                f"{arr.shape} for {n} rows")
        return arr

    # -- lifecycle / ops ---------------------------------------------------
    @abc.abstractmethod
    async def aclose(self) -> None: ...

    @abc.abstractmethod
    def snapshot(self) -> dict:
        """Host-side checkpoint of all live state."""

    @abc.abstractmethod
    def restore(self, snap: dict) -> None: ...

    def export_entries(self, keep) -> dict:
        """Normalized per-key state for the keys ``keep`` selects — the
        live-migration handoff unit (:mod:`~.placement`): this store's
        :meth:`snapshot` (under the store lock, read back after every
        launch before it) filtered through the schema-aware extractor.
        The matching import is :func:`placement.import_entries`, whose
        generic lane replays buckets through ``debit_many``."""
        from distributedratelimiting.redis_tpu_torch.runtime import placement

        return placement.extract_entries(self.snapshot(), keep)


def _not_ported(name: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}.{name} is not ported to the PyTorch "
            "package yet")

    method.__name__ = name
    return method



def start_periodic_sweeper(sweep_all: Callable[[], None],
                           period_s: float) -> "asyncio.Task":
    """The active-expiry loop: runs ``sweep_all`` off-loop every
    ``period_s``; a transient device error must not silently end active
    expiry for the store's lifetime — log and retry next period."""

    async def loop() -> None:
        while True:
            await asyncio.sleep(period_s)
            try:
                # Device passes block; keep the event loop responsive.
                await asyncio.to_thread(sweep_all)
            except asyncio.CancelledError:
                raise
            except Exception as exc:
                log.error_evaluating_kernel(exc)

    return asyncio.get_running_loop().create_task(loop())


def _rate_per_tick(rate_per_sec: float) -> float:
    return rate_per_sec / bm.TICKS_PER_SECOND


def _grant_zero_probes(granted: np.ndarray, counts_np: np.ndarray) -> None:
    """Zero-permit probes always grant — the kernel's conservative in-batch
    prefix could deny one riding beside denied same-key demand."""
    if (counts_np == 0).any():
        granted[counts_np == 0] = True


def _pad_size(n: int, floor: int = 64) -> int:
    """Pad a batch to a power of two ≥ ``floor``."""
    size = floor
    while size < n:
        size *= 2
    return size


def _duplicate_prefix_host(slots: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Exact per-request prefix of earlier same-slot demand, computed on the
    host in int64 (stable sort + segmented cumsum). Shipping it with the
    batch lets the decision kernel skip any in-kernel sort."""
    order = np.argsort(slots, kind="stable")
    s_sorted = slots[order]
    c_sorted = counts[order].astype(np.int64)
    csum = np.cumsum(c_sorted)
    seg_start = np.r_[True, s_sorted[1:] != s_sorted[:-1]]
    base = np.maximum.accumulate(np.where(seg_start, csum - c_sorted, 0))
    prefix = np.empty_like(csum)
    prefix[order] = csum - c_sorted - base
    return prefix


def _build_packed(reqs: Sequence[_AcquireReq], slots: Sequence[int], b: int,
                  now: int) -> np.ndarray:
    """ONE padded i32[4, b] operand per launch — row 0 slots (-1 = padding),
    row 1 counts, row 2 the batch timestamp, row 3 the host-computed
    same-slot demand prefix (saturated to int32)."""
    packed = np.full((4, b), -1, np.int32)
    packed[1] = 0
    packed[3] = 0
    n = len(reqs)
    packed[0, :n] = slots
    packed[1, :n] = [r.count for r in reqs]
    packed[2] = now
    if n != len(set(slots)):
        packed[3, :n] = np.minimum(
            _duplicate_prefix_host(packed[0, :n], packed[1, :n]), 2**31 - 1
        )
    return packed


def _resolve_with_reclaim(directory, keys: list[str], sweep, grow, *,
                          min_free: int = 0) -> np.ndarray:
    """Batch key→slot resolution: on free-list exhaustion mid-batch, sweep
    expired slots (pinning the ones already resolved for this batch), grow
    if still dry (or if the sweep reclaimed only ``min_free`` slots or
    fewer), re-resolve. Already-allocated keys are idempotent lookups and
    each dry iteration doubles capacity, so the loop terminates."""
    slots = directory.resolve_batch(keys)
    while (slots < 0).any():
        pinned = {int(s) for s in slots[slots >= 0]}
        sweep(pinned)
        if directory.free_count <= min_free:
            grow()
        slots = directory.resolve_batch(keys)
    return slots


def _to_host(t: torch.Tensor) -> np.ndarray:
    """One device→host readback (a no-op view for a CPU tensor)."""
    return t.cpu().numpy()


class _PackedLaunchMixin:
    """Flush machinery for tables whose ``_launch`` returns the packed
    ``f32[2, B]`` result (row 0 grants, row 1 remaining): the readback
    convention plus same-key coalescing. Duplicate keys in one flush
    collapse to one launch row per ``(key, count)`` group via the table's
    ``_launch_grouped``, verdicts fanned back out in arrival order —
    bit-identical to the per-row conservative serialization; keys whose
    in-flush counts are mixed become per-row entries with exact cumulative
    prefixes. Also the slot plumbing every table shares: its directory,
    batcher, resolution with reclaim, eviction and doubling."""

    #: Dirty-slot accounting for incremental checkpoints: ``None`` (one
    #: ``is not None`` check a resolve) until the owning store's
    #: ``enable_dirty_tracking()`` arms it with a set. Every slot a launch
    #: resolves lands here (slightly over-inclusive: a denied request still
    #: refreshes its slot's refill timestamp, so resolved ≈ written), giving
    #: OP_STATS the dirty/total ratio that predicts the next delta's size.
    #: The delta itself is a structural diff, not this set: a missed site
    #: can only misreport the gauge, never corrupt a checkpoint.
    dirty_slots: "set[int] | None" = None

    # -- slot management ---------------------------------------------------
    def _init_slots(self, store: "DeviceBucketStore", state,
                    n_slots: int) -> None:
        self.store = store
        self.state = state
        self.n_slots = n_slots
        self.dir = make_directory(n_slots)
        self.batcher: MicroBatcher[_AcquireReq, AcquireResult] = MicroBatcher(
            self._flush,
            max_batch=store.max_batch,
            max_delay_s=store.max_delay_s,
            max_inflight=store.max_inflight,
            flush_latency=store.metrics.flush_latency,
            queue_latency=store.metrics.queue_latency,
            flush_observer=store._flush_observer,
        )

    def resolve_slots(self, keys: list[str]) -> np.ndarray:
        """Batch key→slot resolution (the host hot path); every decision,
        bulk, two-level and debit launch of a table resolves here."""
        slots = _resolve_with_reclaim(self.dir, keys, self._sweep, self._grow,
                                      min_free=self.n_slots // 16)
        if self.dirty_slots is not None:
            self.dirty_slots.update(slots.tolist())
        return slots

    def arm_dirty(self) -> None:
        """Arm the dirty accounting (idempotent): the exact host-resolved
        slot set."""
        if self.dirty_slots is None:
            self.dirty_slots = set()

    def clear_dirty(self) -> None:
        if self.dirty_slots is not None:
            self.dirty_slots.clear()

    def dirty_count(self) -> int:
        return len(self.dirty_slots) if self.dirty_slots is not None else 0

    def _evict(self, mask: torch.Tensor, counts: torch.Tensor,
               pinned: set[int] | None) -> None:
        """Return a sweep's expired slots to the directory's free list, all
        but ``pinned``; its per-tile expired counts let a sweep that freed
        nothing finish after reading T ints instead of the N-byte mask."""
        if int(_to_host(counts).sum()) > 0:
            dead = np.nonzero(_to_host(mask))[0].astype(np.int32)
            if pinned:
                dead = dead[~np.isin(dead, np.fromiter(pinned, np.int32,
                                                       len(pinned)))]
            self.store.metrics.slots_evicted += self.dir.remove_slots(dead)
        self.store.metrics.sweeps += 1

    def _grow(self) -> None:
        """Double the table (a new allocation: old state copied, new half
        empty)."""
        old_n = self.n_slots
        grown = type(self.state)(*(t.new_zeros(2 * old_n)
                                   for t in self.state))
        for dst, src in zip(grown, self.state):
            dst[:old_n] = src
        self.state = grown
        self.dir.add_slots(old_n, 2 * old_n)
        self.n_slots = 2 * old_n

    async def _flush(self, reqs: Sequence[_AcquireReq]) -> list[AcquireResult]:
        if faults._INJECTOR is not None:  # chaos seam; no-op in prod
            await faults._INJECTOR.on_event("store.flush")
        groups = (self._coalesce(reqs)
                  if self.store.coalesce_duplicates else None)
        loop = asyncio.get_running_loop()
        # Block for the readback on an executor thread so the event loop
        # keeps accumulating the next flush.
        if groups is None:
            out = self._launch(reqs)
            out_np = await loop.run_in_executor(None, _to_host, out)
            return [
                AcquireResult(bool(out_np[0, i] > 0.5), float(out_np[1, i]))
                for i in range(len(reqs))
            ]
        out = self._dispatch_grouped(groups)
        out_np = await loop.run_in_executor(None, _to_host, out)
        results: list[AcquireResult | None] = [None] * len(reqs)
        for g, (_, count, _, members, _) in enumerate(groups):
            n_granted = int(out_np[0, g])
            # Each member's per-row remaining view, from the group result:
            # avail = post-consumption remaining + consumed.
            avail = float(out_np[1, g]) + n_granted * count
            for j, idx in enumerate(members):
                granted = j < n_granted
                results[idx] = AcquireResult(
                    granted,
                    max(avail - j * count - (count if granted else 0), 0.0))
        return results  # type: ignore[return-value]

    @staticmethod
    def _coalesce(reqs: Sequence[_AcquireReq]):
        """Group requests for the grouped kernel; ``None`` when there are
        no duplicates (one row per request)."""
        by_key: dict[str, list[int]] = {}
        for i, r in enumerate(reqs):
            by_key.setdefault(r.key, []).append(i)
        if len(by_key) == len(reqs):
            return None
        # (key, count, n, member_indices, prefix)
        groups: list[tuple[str, int, int, list[int], int]] = []
        for key, members in by_key.items():
            counts = {reqs[i].count for i in members}
            if len(counts) == 1:
                groups.append((key, counts.pop(), len(members), members, 0))
            else:
                pref = 0
                for i in members:
                    # Saturate: a huge cumulative prefix must under-admit,
                    # not overflow the i32 operand.
                    groups.append((key, reqs[i].count, 1, [i],
                                   min(pref, 2**31 - 1)))
                    pref += reqs[i].count
        return groups

    def _dispatch_grouped(self, groups):
        """Pack groups into the i32[5, B] operand and launch the grouped
        kernel."""
        with self.store.profiler.span("acquire_batch_grouped",
                                      len(groups)), self.store._lock:
            slots = self.resolve_slots([g[0] for g in groups])
            b = _pad_size(len(groups), floor=8)
            now = self.store.now_ticks_checked()
            packed = np.full((5, b), -1, np.int32)
            packed[1] = 0
            packed[3] = 0
            packed[4] = 0
            n = len(groups)
            packed[0, :n] = slots
            packed[1, :n] = [g[1] for g in groups]
            packed[2] = now
            packed[3, :n] = [g[4] for g in groups]
            packed[4, :n] = [g[2] for g in groups]
            out = self._launch_grouped(self._upload(packed))
            n_reqs = sum(g[2] for g in groups)
            self.store.metrics.record_launch(b, n)
            self.store.metrics.rows_coalesced += n_reqs - n
            return out

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host→device copy of an operand."""
        return torch.from_numpy(arr).to(self.store.device)

    def _launch(self, reqs: Sequence[_AcquireReq]) -> torch.Tensor:
        """Build the padded operand and launch one decision (the table's
        ``_launch_packed``). The whole read-modify-write of the table runs
        under the store lock: the blocking path may be called from any
        thread while the event loop flushes batches."""
        with self.store.profiler.span(self._FLUSH_SPAN, len(reqs)), \
                self.store._lock:
            slots = self.resolve_slots([r.key for r in reqs])
            # Padded to its rows (a power of two >= 8): the kernel's launch
            # is sized by them; the JAX store pads to max_batch for one
            # compiled program.
            b = _pad_size(len(reqs), floor=8)
            now = self.store.now_ticks_checked()
            packed = _build_packed(reqs, slots, b, now)
            out = self._launch_packed(self._upload(packed))
            self.store.metrics.record_launch(b, len(reqs))
            return out

    def to_snap(self) -> dict:
        """The checkpoint form, the JAX store's numpy schema: the directory
        and one array per state field."""
        return {"directory": self.dir.to_dict(),
                **{name: _to_host(t).copy()
                   for name, t in zip(self.state._fields, self.state)}}

    def acquire_blocking(self, key: str, count: int) -> AcquireResult:
        out_np = _to_host(self._launch([_AcquireReq(key, count)]))
        return AcquireResult(bool(out_np[0, 0] > 0.5), float(out_np[1, 0]))

    # -- bulk machinery (acquire_many) -------------------------------------
    #: Max scanned batches per bulk dispatch; K is chosen per call from
    #: {1, 2, 4, …, 32}.
    _BULK_MAX_K = 32
    #: The profiler span of one bulk call.
    _BULK_SPAN = "acquire_many"

    def _launch_many(self, slots: np.ndarray, counts_np: np.ndarray,
                     with_remaining: bool = True) -> list[tuple]:
        """Dispatch a whole resolved slot array as scanned launches;
        returns per-dispatch device results (no readback — callers overlap
        it). Counts that fit a byte ride the fused 5-bytes/decision operand;
        larger counts travel as one ``i32[2, K, B]`` operand (slots, then
        counts). A chunk of one batch is a flush instead. The caller holds
        the store lock."""
        n = len(slots)
        b = self.store.max_batch
        outs: list[tuple] = []
        compact = n > 0 and int(counts_np.max(initial=0)) <= 0xFF
        now = self.store.now_ticks_checked()
        pos = 0
        while pos < n:
            rows = -(-(n - pos) // b)  # ceil
            k = 1
            while k < rows and k < self._BULK_MAX_K:
                k *= 2
            take = min(k * b, n - pos)
            # One batch: a flush of its rows, not a scan of max_batch rows
            # (on the H100 the faster route at every width from 8 to 4,096
            # rows: PERF.md §6, chip_smoke.py --scan-bench).
            out = (self._bulk_flush(slots[pos:pos + take],
                                    counts_np[pos:pos + take], now)
                   if k == 1 else None)
            if out is not None:
                outs.append((out, take))
                self.store.metrics.record_launch(out.shape[-1], take)
                pos += take
                continue
            s = np.full((k * b,), -1, np.int32)
            s[:take] = slots[pos:pos + take]
            c = np.zeros((k * b,), np.uint8 if compact else np.int32)
            c[:take] = np.minimum(counts_np[pos:pos + take], 2**31 - 1)
            nows = np.full((k,), now, np.int32)
            out = self._launch_scan_chunk(
                s.reshape(k, b), c.reshape(k, b), nows, compact,
                with_remaining)
            outs.append((out, take))
            self.store.metrics.record_launch(k * b, take)
            pos += take
        return outs

    def _bulk_flush(self, slots: np.ndarray, counts_np: np.ndarray,
                    now: int) -> torch.Tensor | None:
        """One batch of the bulk lane decided by the table's flush
        (``_launch_packed``): ONE ``i32[4, b]`` operand, ``b`` the rows
        padded to a power of two >= 8, built in one vectorised pass — slots,
        counts saturated to 2^31 - 1, the tick, and the host's same-slot
        prefix (saturated) only where a slot repeats, as
        :func:`_build_packed`. The scan's K = 1 rule is the flush's (JAX
        decides both with ``acquire_core``). Returns ``f32[1, 2, b]``, or
        ``None`` when a prefix passes 2^31: saturated, it would round to
        another float32 than the scan's int64 prefix, so the caller scans."""
        m = len(slots)
        packed = np.zeros((4, _pad_size(m, floor=8)), np.int32)
        packed[0] = -1
        packed[0, :m] = slots
        counts = np.minimum(counts_np, 2**31 - 1)
        packed[1, :m] = counts
        packed[2] = now
        if len(np.unique(slots)) != m:
            prefix = _duplicate_prefix_host(slots, counts)
            if prefix.max() > 2**31:
                return None
            packed[3, :m] = np.minimum(prefix, 2**31 - 1)
        return self._launch_packed(self._upload(packed))[None]

    @staticmethod
    def _gather_bulk(outs: list[tuple], n: int,
                     with_remaining: bool = True) -> BulkAcquireResult:
        granted = np.empty((n,), bool)
        remaining = np.empty((n,), np.float32) if with_remaining else None
        pos = 0
        for out, take in outs:
            out_np = _to_host(out)             # one readback per dispatch
            if out_np.dtype == np.uint8:       # bit-packed grants
                bits = np.unpackbits(out_np.reshape(-1), bitorder="little")
                granted[pos:pos + take] = bits[:take].astype(bool)
            else:                              # f32[K, 2, B]
                granted[pos:pos + take] = (
                    out_np[:, 0, :].reshape(-1)[:take] > 0.5)
                if remaining is not None:
                    remaining[pos:pos + take] = (
                        out_np[:, 1, :].reshape(-1)[:take])
            pos += take
        return BulkAcquireResult(granted, remaining)

    @staticmethod
    def _grant_probes(res: BulkAcquireResult,
                      counts_np: np.ndarray) -> BulkAcquireResult:
        _grant_zero_probes(res.granted, counts_np)
        return res

    @staticmethod
    def _bulk_groups(slots: np.ndarray, counts_np: np.ndarray):
        """Slot-grouped view of a bulk call for duplicate coalescing, or
        ``None`` when it wouldn't pay (<25% of rows saved) or a key's
        counts are mixed. Request order is preserved within each slot's
        segment, so group decisions equal the per-row serialization."""
        n = len(slots)
        order = np.argsort(slots, kind="stable")
        s_sorted = slots[order]
        seg_start = np.r_[True, s_sorted[1:] != s_sorted[:-1]]
        n_groups = int(seg_start.sum())
        if n_groups * 4 > n * 3:
            return None
        starts = np.nonzero(seg_start)[0]
        lengths = np.diff(np.r_[starts, n])
        c_sorted = counts_np[order]
        first_c = c_sorted[starts]
        if not np.array_equal(c_sorted, np.repeat(first_c, lengths)):
            return None
        seg_id = np.cumsum(seg_start) - 1
        rank = np.arange(n) - starts[seg_id]
        return order, seg_id, rank, starts, lengths, first_c

    def _launch_many_grouped(self, slots: np.ndarray,
                             counts_np: np.ndarray, with_remaining: bool):
        """Coalesced bulk dispatch of a resolved slot array: one
        grouped-kernel row per ``(key, count)`` group. Returns a readback
        closure, or ``None`` when grouping doesn't pay (the caller takes the
        scan path). The caller holds the store lock."""
        n = len(slots)
        g = self._bulk_groups(slots, counts_np)
        if g is None:
            return None
        order, seg_id, rank, starts, lengths, first_c = g
        gslots = slots[order][starts]
        gcounts = np.minimum(first_c, 2**31 - 1).astype(np.int32)
        b = self.store.max_batch
        now = self.store.now_ticks_checked()
        outs: list[tuple] = []
        for pos in range(0, len(gslots), b):
            m = min(b, len(gslots) - pos)
            # Full chunks of max_batch groups; the last padded to its rows.
            packed = np.full((5, min(b, _pad_size(m, floor=8))), -1, np.int32)
            packed[1] = 0
            packed[3] = 0  # one group per slot per call ⇒ prefix 0
            packed[4] = 0
            packed[0, :m] = gslots[pos:pos + m]
            packed[1, :m] = gcounts[pos:pos + m]
            packed[2] = now
            packed[4, :m] = np.minimum(lengths[pos:pos + m], 2**31 - 1)
            out = self._launch_grouped(self._upload(packed))
            outs.append((out, m))
            self.store.metrics.record_launch(packed.shape[1], m)
        self.store.metrics.rows_coalesced += n - len(gslots)

        def gather() -> BulkAcquireResult:
            n_g = np.empty(len(gslots), np.float32)
            rem_g = np.empty(len(gslots), np.float32)
            pos = 0
            for out, m in outs:
                out_np = _to_host(out)  # one readback per dispatch
                n_g[pos:pos + m] = out_np[0, :m]
                rem_g[pos:pos + m] = out_np[1, :m]
                pos += m
            granted_sorted = rank < n_g[seg_id]
            granted = np.empty(n, bool)
            granted[order] = granted_sorted
            remaining = None
            if with_remaining:
                c = first_c[seg_id].astype(np.float32)
                avail = rem_g[seg_id] + n_g[seg_id] * c
                rem_sorted = np.maximum(
                    avail - rank * c - np.where(granted_sorted, c, 0.0), 0.0)
                remaining = np.empty(n, np.float32)
                remaining[order] = rem_sorted.astype(np.float32)
            return BulkAcquireResult(granted, remaining)

        return gather

    def _bulk_plan(self, keys: Sequence[str], counts_np: np.ndarray,
                   with_remaining: bool):
        """Resolve the keys once, then choose and dispatch the bulk
        strategy; returns the readback closure. ``keys`` may be a
        ``wire.KeyBlob`` (the server's bulk lane), which the native
        directory resolves without building a string per key. Resolution and dispatch
        share one hold of the store lock, so no sweep can hand a resolved
        slot to another key in between. (The JAX store resolves a second
        time when grouping does not pay; here the slots are reused.)"""
        n = len(keys)
        with self.store.profiler.span(self._BULK_SPAN, n), self.store._lock:
            slots = self.resolve_slots(keys)
            if self.store.coalesce_duplicates and n:
                gather = self._launch_many_grouped(slots, counts_np,
                                                   with_remaining)
                if gather is not None:
                    return gather
            outs = self._launch_many(slots, counts_np, with_remaining)
        return lambda: self._gather_bulk(outs, n, with_remaining)

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], *,
                              with_remaining: bool = True) -> BulkAcquireResult:
        counts_np = np.asarray(counts, np.int64)
        gather = self._bulk_plan(keys, counts_np, with_remaining)
        return self._grant_probes(gather(), counts_np)

    async def acquire_many(self, keys: Sequence[str],
                           counts: Sequence[int], *,
                           with_remaining: bool = True) -> BulkAcquireResult:
        counts_np = np.asarray(counts, np.int64)
        gather = self._bulk_plan(keys, counts_np, with_remaining)
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(None, gather)
        return self._grant_probes(res, counts_np)


class _DeviceTable(_PackedLaunchMixin):
    """One homogeneous-config bucket table: device tensors + host directory."""

    def __init__(self, store: "DeviceBucketStore", capacity: float,
                 fill_rate_per_sec: float, n_slots: int) -> None:
        self.capacity = float(capacity)
        self.fill_rate_per_sec = float(fill_rate_per_sec)
        self.rate_per_tick = _rate_per_tick(fill_rate_per_sec)
        self._init_slots(store, K.init_bucket_state(n_slots, store.device),
                         n_slots)

    # -- slot management ---------------------------------------------------
    def _sweep(self, pinned: set[int] | None = None) -> None:
        """Reclaim slots whose buckets have sat full-refilled past TTL, in
        one sweep-kernel pass.

        ``pinned`` slots (already resolved for the in-flight batch) are not
        returned to the free-list — a sweep triggered mid-batch must not
        hand a slot an earlier request of the same batch is about to touch
        to another key. Their ``exists`` is cleared all the same, which only
        means init-on-miss to a full bucket: an expired bucket is full."""
        with self.store.profiler.span("sweep", self.n_slots):
            self._sweep_locked(pinned)

    def _sweep_locked(self, pinned: set[int] | None = None) -> None:
        mask, counts = ck.sweep_expired(self.state,
                                        self.store.clock.now_ticks(),
                                        self.capacity, self.rate_per_tick)
        self._evict(mask, counts, pinned)

    # -- decision paths ----------------------------------------------------
    _FLUSH_SPAN = "acquire_batch"

    def _launch_packed(self, packed: torch.Tensor) -> torch.Tensor:
        return ck.acquire_packed(self.state, packed, self.capacity,
                                 self.rate_per_tick)

    def _launch_grouped(self, packed: torch.Tensor) -> torch.Tensor:
        return ck.acquire_grouped(self.state, packed, self.capacity,
                                  self.rate_per_tick)

    def _launch_scan_chunk(self, s: np.ndarray, c: np.ndarray,
                           nows: np.ndarray, compact: bool,
                           with_remaining: bool) -> torch.Tensor:
        """One chunk's scanned dispatch, one operand upload and one kernel
        launch: ``f32[K, 2, B]``, or bit-packed grants ``u8[K, B/8]`` for a
        verdict-only call."""
        b = s.shape[1]
        operand = K.pack_compact5(s, c) if compact else np.stack([s, c])
        return ck.acquire_scan_packed(
            self.state, self._upload(operand), self._upload(nows),
            self.capacity, self.rate_per_tick,
            with_remaining=with_remaining or b % 8 != 0)

    def _debit_launch(self, keys: Sequence[str],
                      amounts: Sequence[float]) -> torch.Tensor:
        """One saturating-debit launch for all rows (tier-0
        reconciliation): ``i32[4, B]`` operand, ``B`` padded to a power of
        two ≥ 8 (a small debit takes the kernel's one-warp path), the
        float32 amounts bitcast into row 1 (exact) and, where
        a slot repeats, the float32 same-slot prefix of earlier amounts
        bitcast into row 3 (:func:`bm.duplicate_prefix_float`, one add at a
        time in request order). Returns ``f32[2, B]`` (post-debit balance,
        shortfall). Resolve and launch share one hold of the store lock."""
        n = len(keys)
        with self.store.profiler.span("debit_batch", n), self.store._lock:
            slots = self.resolve_slots(list(keys))
            b = _pad_size(n, floor=8)
            now = self.store.now_ticks_checked()
            amounts_np = np.asarray(amounts, np.float32)
            packed = np.full((4, b), -1, np.int32)
            packed[1] = 0
            packed[3] = 0
            packed[0, :n] = slots
            packed[1, :n] = amounts_np.view(np.int32)
            packed[2] = now
            if n != len(np.unique(slots)):
                prefix = bm.duplicate_prefix_float(
                    torch.from_numpy(slots), torch.from_numpy(amounts_np),
                    torch.ones(n, dtype=torch.bool))
                packed[3, :n] = prefix.numpy().view(np.int32)
            out = ck.debit_packed(self.state, self._upload(packed),
                                  self.capacity, self.rate_per_tick)
            self.store.metrics.record_launch(b, n)
            return out

    def peek_blocking(self, key: str) -> float:
        with self.store._lock:
            slot = self.dir.lookup(key)
            if slot is None:
                return float(np.floor(self.capacity))
            packed = _build_packed([_AcquireReq(key, 0)], [slot],
                                   _pad_size(1),
                                   self.store.now_ticks_checked())
            est = K.peek_batch_packed(self.state, self._upload(packed),
                                      self.capacity, self.rate_per_tick)
        return float(_to_host(est)[0])

    def rebase(self, offset: int) -> None:
        K.rebase_bucket_epoch(self.state, offset)

    # -- checkpoint form (the JAX store's numpy schema) --------------------
    def load_snap(self, data: dict, shift: int) -> None:
        if "directory" not in data:
            raise ValueError(
                "checkpoint's bucket tables use the device-resident "
                "fingerprint directory — restore into a "
                "FingerprintBucketStore")
        # Adopt the snapshot's size: tables grow independently at runtime.
        dev = self.store.device
        self.n_slots = len(data["tokens"])
        self.state = K.BucketState(
            tokens=torch.tensor(np.asarray(data["tokens"], np.float32),
                                device=dev),
            last_ts=torch.tensor(_shift_ts(data["last_ts"], shift),
                                 device=dev),
            exists=torch.tensor(np.asarray(data["exists"], bool),
                                device=dev),
        )
        self.dir.load(data["directory"], self.n_slots)


class _DeviceWindowTable(_PackedLaunchMixin):
    """One homogeneous-config window table: sliding by default, ``fixed=True``
    for the fixed window (no trailing-window interpolation) over the same
    state, batching and sweeps."""

    def __init__(self, store: "DeviceBucketStore", limit: float,
                 window_ticks: int, n_slots: int, *,
                 fixed: bool = False) -> None:
        if int(window_ticks) < 1:
            raise ValueError(f"a window must last at least one tick (1/"
                             f"{bm.TICKS_PER_SECOND} s), got {window_ticks} "
                             "ticks")
        self.limit = float(limit)
        self.fixed = fixed
        self.window_ticks = int(window_ticks)
        self._init_slots(store, K.init_window_state(n_slots, store.device),
                         n_slots)

    def _sweep(self, pinned: set[int] | None = None) -> None:
        """Reclaim slots two whole windows idle (:meth:`_DeviceTable._sweep`
        explains ``pinned``)."""
        with self.store.profiler.span("sweep_windows", self.n_slots):
            self._sweep_locked(pinned)

    def _sweep_locked(self, pinned: set[int] | None = None) -> None:
        mask, counts = ck.sweep_windows(self.state,
                                        self.store.clock.now_ticks(),
                                        self.window_ticks)
        self._evict(mask, counts, pinned)

    def rebase(self, offset_ticks: int) -> None:
        """Shift live indices back by the whole windows of ``offset_ticks``;
        the remainder skews one boundary by less than a window, once a
        rebase (~6 days)."""
        K.rebase_window_epoch(self.state, offset_ticks // self.window_ticks)

    # -- decision paths ----------------------------------------------------
    _FLUSH_SPAN = "window_acquire_batch"
    _BULK_SPAN = "window_acquire_many"

    def _launch_packed(self, packed: torch.Tensor) -> torch.Tensor:
        return ck.window_packed(self.state, packed, self.limit,
                                self.window_ticks, interpolate=not self.fixed)

    def _launch_grouped(self, packed: torch.Tensor) -> torch.Tensor:
        return ck.window_grouped(self.state, packed, self.limit,
                                 self.window_ticks,
                                 interpolate=not self.fixed)

    def _launch_scan_chunk(self, s: np.ndarray, c: np.ndarray,
                           nows: np.ndarray, compact: bool,
                           with_remaining: bool) -> torch.Tensor:
        """One chunk's scanned dispatch: one operand upload, one launch."""
        b = s.shape[1]
        operand = K.pack_compact5(s, c) if compact else np.stack([s, c])
        return ck.window_scan_packed(
            self.state, self._upload(operand), self._upload(nows),
            self.limit, self.window_ticks, interpolate=not self.fixed,
            with_remaining=with_remaining or b % 8 != 0)

    # -- checkpoint form (the JAX store's numpy schema) --------------------
    def load_snap(self, data: dict, shift: int) -> None:
        """Adopt a snapshot's table, its indices shifted by the whole
        windows of ``shift`` (a floor: a restore into a younger clock shifts
        back)."""
        if "directory" not in data:
            raise ValueError(
                "checkpoint's window tables use the device-resident "
                "fingerprint directory — restore into a "
                "FingerprintBucketStore")
        dev = self.store.device
        self.n_slots = len(data["prev_count"])
        self.state = K.WindowState(
            prev_count=torch.tensor(np.asarray(data["prev_count"],
                                               np.float32), device=dev),
            curr_count=torch.tensor(np.asarray(data["curr_count"],
                                               np.float32), device=dev),
            window_idx=torch.tensor(
                _shift_ts(data["window_idx"], shift // self.window_ticks),
                device=dev),
            exists=torch.tensor(np.asarray(data["exists"], bool),
                                device=dev),
        )
        self.dir.load(data["directory"], self.n_slots)


class DeviceBucketStore(BucketStore):
    """Device-resident store: tensor tables + micro-batched kernel launches.

    ``device`` defaults to ``"cuda"``; ``"cpu"`` runs the kernels' plain
    versions and must be asked for — with no GPU, the default raises."""

    def __init__(
        self,
        *,
        n_slots: int = 2**17,
        counter_slots: int = 2**14,
        clock: Clock | None = None,
        max_batch: int = 4096,
        max_delay_s: float = 200e-6,
        max_inflight: int = 8,
        coalesce_duplicates: bool = True,
        profiling_session: Callable[[], ProfilingSession | None] | None = None,
        rebase_threshold_ticks: int = _REBASE_THRESHOLD_TICKS,
        device: "str | torch.device" = "cuda",
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeviceBucketStore: no CUDA device is available; pass "
                    "device='cpu' to run the plain PyTorch versions on the "
                    "CPU")
            if max_batch > ck.FLUSH_MAX_BATCH:
                raise ValueError(
                    f"max_batch {max_batch} > {ck.FLUSH_MAX_BATCH}: a card "
                    "store's flushes, one-batch bulk chunks included, hold "
                    "a slot's rows in one thread block")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.clock = clock or MonotonicClock()
        self.profiler = Profiler(profiling_session,
                                 nvtx=self.device.type == "cuda")
        # Flush-level same-key coalescing (False = every request is its own
        # launch row, serialized by the host prefix).
        self.coalesce_duplicates = coalesce_duplicates
        self.n_slots_default = n_slots
        self.counter_slots = counter_slots
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_inflight = max_inflight
        self.metrics = StoreMetrics()
        self._tables: dict[tuple[float, float], _DeviceTable] = {}
        self._wtables: dict[tuple[float, int, bool], _DeviceWindowTable] = {}
        # The counter table is allocated at first use, as bucket tables are:
        # construction touches no device.
        self._counter_state: K.CounterState | None = None
        self._counter_dir = make_directory(counter_slots)
        # The semaphore table, sized like the counter table and allocated
        # at first use too.
        self._sema_state: K.SemaState | None = None
        self._sema_dir = make_directory(counter_slots)
        self._lock = threading.RLock()  # directory/slot allocation guard
        self._rebase_threshold = rebase_threshold_ticks
        self._connected = False
        self._connect_gate = asyncio.Lock()
        self._sweeper_task: asyncio.Task | None = None
        # Dirty-slot accounting (incremental checkpoints; see
        # enable_dirty_tracking): off by default, no serving cost.
        self._dirty_tracking = False

    # -- connection lifecycle (lazy, idempotent) ---------------------------
    async def connect(self) -> None:
        if self._connected:
            return
        async with self._connect_gate:
            if self._connected:
                return
            # Touch the device so a broken one fails here, not on the first
            # hot-path acquire.
            torch.zeros((8,), device=self.device).sum().item()
            self._connected = True

    def _flush_observer(self, n: int, wall_s: float,
                        error: str | None,
                        trace_id: str | None = None) -> None:
        """Per-flush flight-recorder feed (MicroBatcher ``flush_observer``).
        One attribute check per flush when no recorder is attached; a
        flush FAILURE is the store's degraded-mode entry, so it also fires
        a rate-limited auto-dump — the outage window's lead-in frames land
        on disk while they still exist. ``trace_id`` (the flush's elected
        trace, when any member was sampled) stamps the frame so a flight
        dump cross-references its exported trace. Host bookkeeping only:
        it never touches the card."""
        rec = self.metrics.flight_recorder
        if rec is None:
            return
        rec.record("flush", n=n, wall_ms=round(wall_s * 1e3, 3),
                   error=error, trace_id=trace_id)
        if error is not None:
            rec.auto_dump("flush_error", {"error": error,
                                          "trace_id": trace_id})

    def now_ticks_checked(self) -> int:
        """Read the store clock; rebase every table's epoch before int32
        tick time can overflow (~24 days of uptime)."""
        now = self.clock.now_ticks()
        if now >= self._rebase_threshold:
            with self._lock:
                now = self.clock.now_ticks()
                if now >= self._rebase_threshold:
                    offset = now - _REBASE_MARGIN_TICKS
                    self.force_rebase(offset)
                    self.clock.rebase(offset)
                    now = self.clock.now_ticks()
        return now

    def force_rebase(self, offset: int) -> None:
        """Shift every table's stored timestamps by ``-offset`` without
        touching the clock."""
        with self._lock:
            for t in (*self._tables.values(), *self._wtables.values()):
                t.rebase(offset)
            if self._counter_state is not None:
                K.rebase_counter_epoch(self._counter_state, offset)
            if self._sema_state is not None:
                K.rebase_sema_epoch(self._sema_state, offset)

    # -- table routing -----------------------------------------------------
    # Subclasses swap the constructed table classes (the fingerprint store
    # substitutes its device-directory tables) without copying the keying
    # or locking below.
    _TABLE_CLS: type = None  # type: ignore[assignment]  # set after class
    _WTABLE_CLS: type = None  # type: ignore[assignment]

    def _table(self, capacity: float, fill_rate_per_sec: float) -> _DeviceTable:
        key = (float(capacity), float(fill_rate_per_sec))
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                table = self._TABLE_CLS(self, capacity, fill_rate_per_sec,
                                        self.n_slots_default)
                if self._dirty_tracking:
                    table.arm_dirty()
                self._tables[key] = table
            return table

    def _wtable(self, limit: float, window_sec: float,
                fixed: bool = False) -> _DeviceWindowTable:
        wt = int(window_sec * bm.TICKS_PER_SECOND)
        key = (float(limit), wt, fixed)
        with self._lock:
            table = self._wtables.get(key)
            if table is None:
                table = self._WTABLE_CLS(self, limit, wt,
                                         self.n_slots_default, fixed=fixed)
                if self._dirty_tracking:
                    table.arm_dirty()
                self._wtables[key] = table
            return table

    # -- exact bucket ------------------------------------------------------
    async def acquire(self, key: str, count: int, capacity: float,
                      fill_rate_per_sec: float) -> AcquireResult:
        await self.connect()
        table = self._table(capacity, fill_rate_per_sec)
        return await table.batcher.submit(_AcquireReq(key, count))

    def acquire_submitter(self, capacity: float, fill_rate_per_sec: float):
        """Hot-path binding: resolve the table ONCE; each call is then one
        ``MicroBatcher.submit``."""
        submit = self._table(capacity, fill_rate_per_sec).batcher.submit

        async def fast(key: str, count: int) -> AcquireResult:
            return await submit(_AcquireReq(key, count))

        return fast

    def acquire_blocking(self, key: str, count: int, capacity: float,
                         fill_rate_per_sec: float) -> AcquireResult:
        return self._table(capacity, fill_rate_per_sec).acquire_blocking(
            key, count)

    async def acquire_many(self, keys: Sequence[str], counts: Sequence[int],
                           capacity: float, fill_rate_per_sec: float, *,
                           with_remaining: bool = True) -> BulkAcquireResult:
        """Bulk path: the whole array rides scanned kernel launches — no
        per-request futures, one await per call."""
        await self.connect()
        table = self._table(capacity, fill_rate_per_sec)
        return await table.acquire_many(keys, counts,
                                        with_remaining=with_remaining)

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], capacity: float,
                              fill_rate_per_sec: float, *,
                              with_remaining: bool = True) -> BulkAcquireResult:
        return self._table(capacity, fill_rate_per_sec).acquire_many_blocking(
            keys, counts, with_remaining=with_remaining)

    def peek_blocking(self, key: str, capacity: float,
                      fill_rate_per_sec: float) -> float:
        return self._table(capacity, fill_rate_per_sec).peek_blocking(key)

    # -- sliding and fixed windows -----------------------------------------
    async def window_acquire(self, key: str, count: int, limit: float,
                             window_sec: float) -> AcquireResult:
        await self.connect()
        table = self._wtable(limit, window_sec)
        return await table.batcher.submit(_AcquireReq(key, count))

    def window_acquire_blocking(self, key: str, count: int, limit: float,
                                window_sec: float) -> AcquireResult:
        return self._wtable(limit, window_sec).acquire_blocking(key, count)

    async def fixed_window_acquire(self, key: str, count: int, limit: float,
                                   window_sec: float) -> AcquireResult:
        await self.connect()
        table = self._wtable(limit, window_sec, fixed=True)
        return await table.batcher.submit(_AcquireReq(key, count))

    def fixed_window_acquire_blocking(self, key: str, count: int,
                                      limit: float,
                                      window_sec: float) -> AcquireResult:
        return self._wtable(limit, window_sec,
                            fixed=True).acquire_blocking(key, count)

    async def window_acquire_many(self, keys: Sequence[str],
                                  counts: Sequence[int], limit: float,
                                  window_sec: float, *, fixed: bool = False,
                                  with_remaining: bool = True
                                  ) -> BulkAcquireResult:
        """Bulk path of a window table: scanned kernel launches, one await
        per call."""
        await self.connect()
        table = self._wtable(limit, window_sec, fixed)
        return await table.acquire_many(keys, counts,
                                        with_remaining=with_remaining)

    def window_acquire_many_blocking(self, keys: Sequence[str],
                                     counts: Sequence[int], limit: float,
                                     window_sec: float, *,
                                     fixed: bool = False,
                                     with_remaining: bool = True
                                     ) -> BulkAcquireResult:
        return self._wtable(limit, window_sec, fixed).acquire_many_blocking(
            keys, counts, with_remaining=with_remaining)

    # -- decaying counter -------------------------------------------------
    @property
    def _counters(self) -> K.CounterState:
        if self._counter_state is None:
            self._counter_state = K.init_counter_state(self.counter_slots,
                                                       self.device)
        return self._counter_state

    def _sweep_counters(self) -> None:
        with self.profiler.span("sweep_counters",
                                self._counters.value.shape[0]):
            self._sweep_counters_locked()

    def _sweep_counters_locked(self) -> None:
        mask, counts = ck.sweep_counters(self._counters,
                                         self.clock.now_ticks())
        if int(_to_host(counts).sum()) > 0:
            dead = np.nonzero(_to_host(mask))[0].astype(np.int32)
            self.metrics.slots_evicted += self._counter_dir.remove_slots(dead)
        self.metrics.sweeps += 1

    def _grow_counters(self) -> None:
        """Double the counter table (old state copied, new half empty)."""
        old_n = self._counters.value.shape[0]
        grown = K.init_counter_state(old_n * 2, self.device)
        for dst, src in zip(grown, self._counters):
            dst[:old_n] = src
        self._counter_state = grown
        self._counter_dir.add_slots(old_n, old_n * 2)

    def _sync_dispatch(self, key: str, local_count: float,
                       decay_rate_per_sec: float) -> torch.Tensor:
        return self._sync_dispatch_many([key], [local_count],
                                        decay_rate_per_sec)

    def _sync_dispatch_many(self, keys: Sequence[str],
                            local_counts: Sequence[float],
                            decay_rate_per_sec: float) -> torch.Tensor:
        """ONE counter-sync launch for a whole fleet of counters — the
        device half of :meth:`sync_counters_many` (and, with one row, of
        :meth:`sync_counter`). Resolution and launch share one hold of the
        store lock (the JAX store takes it twice)."""
        n = len(keys)
        with self.profiler.span("sync_counter", n), self._lock:
            # On exhaustion: a sweep (pinning nothing, as in the JAX store:
            # the batch is re-resolved whole before the launch), then a
            # doubling if the sweep freed nothing.
            slots = _resolve_with_reclaim(
                self._counter_dir, list(keys),
                lambda pinned: self._sweep_counters(), self._grow_counters)
            b = _pad_size(n, floor=8)
            packed = np.full((3, b), -1, np.int32)
            packed[1] = 0
            packed[0, :n] = slots
            # Float local counts travel bitcast in the int32 row (exact).
            packed[1, :n] = np.asarray(local_counts,
                                       np.float32).view(np.int32)
            packed[2] = self.now_ticks_checked()
            return ck.sync_counters(
                self._counters, torch.from_numpy(packed).to(self.device),
                _rate_per_tick(decay_rate_per_sec))

    async def sync_counter(self, key: str, local_count: float,
                           decay_rate_per_sec: float) -> SyncResult:
        """One decaying-counter sync (the approximate limiter's periodic
        sync script)."""
        await self.connect()
        out = self._sync_dispatch(key, local_count, decay_rate_per_sec)
        loop = asyncio.get_running_loop()
        out_np = await loop.run_in_executor(None, _to_host, out)
        return SyncResult(float(out_np[0, 0]), float(out_np[1, 0]))

    def sync_counter_blocking(self, key: str, local_count: float,
                              decay_rate_per_sec: float) -> SyncResult:
        """Synchronous sync for loop-less callers (the approximate limiter's
        inline refresh)."""
        out_np = _to_host(self._sync_dispatch(key, local_count,
                                              decay_rate_per_sec))
        return SyncResult(float(out_np[0, 0]), float(out_np[1, 0]))

    async def sync_counters_many(self, keys: Sequence[str],
                                 local_counts: Sequence[float],
                                 decay_rate_per_sec: float
                                 ) -> tuple[np.ndarray, np.ndarray]:
        """Bulk replica sync: the whole fleet's local counts land in ONE
        launch against the counter table. Duplicate keys' adds accumulate,
        but each duplicate's EWMA sees the same previous sync: pre-aggregate
        per key for exact EWMAs."""
        await self.connect()
        n = len(keys)
        out = self._sync_dispatch_many(keys, local_counts,
                                       decay_rate_per_sec)
        loop = asyncio.get_running_loop()
        out_np = await loop.run_in_executor(None, _to_host, out)
        return (out_np[0, :n].astype(np.float64),
                out_np[1, :n].astype(np.float64))

    # -- tier-0 debit -----------------------------------------------------
    async def debit_many(self, keys: Sequence[str],
                         amounts: Sequence[float], capacity: float,
                         fill_rate_per_sec: float
                         ) -> tuple[np.ndarray, np.ndarray]:
        """Tier-0 reconciliation against the ``(capacity, fill_rate)``
        bucket table: ONE saturating-debit launch for all rows (see
        :func:`~..ops.kernels.debit_batch_packed`)."""
        await self.connect()
        n = len(keys)
        out = self._table(capacity, fill_rate_per_sec)._debit_launch(
            keys, amounts)
        loop = asyncio.get_running_loop()
        out_np = await loop.run_in_executor(None, _to_host, out)
        return (out_np[0, :n].astype(np.float64),
                out_np[1, :n].astype(np.float64))

    # -- hierarchical tenant → key admission (one launch per chunk) --------
    def _hier_dispatch(self, tenants: Sequence[str], keys: Sequence[str],
                       counts_np: np.ndarray, tcap: float, trate: float,
                       cap: float, rate: float) -> list[tuple]:
        """Decide hierarchical rows with the two-level kernel: the key's
        bucket table and the tenant's decide together, one launch per
        ``max_batch`` rows (chunks in request order, so duplicates across
        chunks serialize), each padded only to a power of two ≥ 8, as
        :meth:`_sema_launch` pads (a one-row request launches 8 rows, which
        the kernel decides in one warp). Returns the per-chunk device
        results; no readback."""
        check_hierarchical_args(int(counts_np.min(initial=0)), tcap, trate,
                                cap, rate)
        n = len(keys)
        ctable = self._table(cap, rate)
        ptable = self._table(tcap, trate)
        outs: list[tuple] = []
        with self.profiler.span("acquire_hierarchical", n), self._lock:
            # A server's KeyBlob resolves from the frame's bytes as it is.
            cslots = ctable.resolve_slots(
                keys if hasattr(keys, "blob") else list(keys))
            pslots = ptable.resolve_slots(list(tenants))
            now = self.now_ticks_checked()
            for pos in range(0, n, self.max_batch):
                take = min(self.max_batch, n - pos)
                b = _pad_size(take, floor=8)
                packed = np.full((4, b), -1, np.int32)
                packed[1] = 0
                packed[0, :take] = cslots[pos:pos + take]
                packed[1, :take] = np.minimum(counts_np[pos:pos + take],
                                              2**31 - 1)
                packed[2] = now
                packed[3, :take] = pslots[pos:pos + take]
                out = ck.acquire_hierarchical(
                    ctable.state, ptable.state, ctable._upload(packed),
                    ctable.capacity, ctable.rate_per_tick, ptable.capacity,
                    ptable.rate_per_tick)
                outs.append((out, take))
                self.metrics.record_launch(b, take)
        return outs

    @staticmethod
    def _hier_gather(outs: list[tuple], n: int,
                     with_remaining: bool) -> BulkAcquireResult:
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32) if with_remaining else None
        pos = 0
        for out, take in outs:
            out_np = _to_host(out)  # one readback per chunk
            granted[pos:pos + take] = out_np[0, :take] > 0.5
            if remaining is not None:
                remaining[pos:pos + take] = out_np[1, :take]
            pos += take
        return BulkAcquireResult(granted, remaining)

    def _hier_fused_supported(self) -> bool:
        """The two-level kernel needs host-resolved slots; fingerprint
        tables place on the device, so the fingerprint store keeps the base
        compose (parent, then child, the parent refunded through its
        ``debit_many`` on a child deny)."""
        return getattr(self._TABLE_CLS, "resolve_slots", None) is not None

    async def acquire_hierarchical(self, tenant, key, count,
                                   tenant_capacity, tenant_fill_rate_per_sec,
                                   capacity, fill_rate_per_sec, *,
                                   priority=0) -> AcquireResult:
        if not self._hier_fused_supported():
            await self.connect()
            return await super().acquire_hierarchical(
                tenant, key, count, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority)
        res = await self.acquire_hierarchical_many(
            [tenant], [key], [int(count)], tenant_capacity,
            tenant_fill_rate_per_sec, capacity, fill_rate_per_sec)
        return res[0]

    def acquire_hierarchical_blocking(self, tenant, key, count,
                                      tenant_capacity,
                                      tenant_fill_rate_per_sec, capacity,
                                      fill_rate_per_sec, *,
                                      priority=0) -> AcquireResult:
        if not self._hier_fused_supported():
            return super().acquire_hierarchical_blocking(
                tenant, key, count, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                priority=priority)
        return self.acquire_hierarchical_many_blocking(
            [tenant], [key], [int(count)], tenant_capacity,
            tenant_fill_rate_per_sec, capacity, fill_rate_per_sec)[0]

    async def acquire_hierarchical_many(self, tenants, keys, counts,
                                        tenant_capacity,
                                        tenant_fill_rate_per_sec, capacity,
                                        fill_rate_per_sec, *,
                                        with_remaining: bool = True,
                                        priority: int = 0
                                        ) -> BulkAcquireResult:
        await self.connect()
        if not self._hier_fused_supported():
            return await BucketStore.acquire_hierarchical_many(
                self, tenants, keys, counts, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                with_remaining=with_remaining, priority=priority)
        counts_np = np.asarray(counts, np.int64)
        outs = self._hier_dispatch(tenants, keys, counts_np, tenant_capacity,
                                   tenant_fill_rate_per_sec, capacity,
                                   fill_rate_per_sec)
        loop = asyncio.get_running_loop()
        res = await loop.run_in_executor(
            None, self._hier_gather, outs, len(keys), with_remaining)
        _grant_zero_probes(res.granted, counts_np)
        return res

    def acquire_hierarchical_many_blocking(self, tenants, keys, counts,
                                           tenant_capacity,
                                           tenant_fill_rate_per_sec,
                                           capacity, fill_rate_per_sec, *,
                                           with_remaining: bool = True,
                                           priority: int = 0
                                           ) -> BulkAcquireResult:
        if not self._hier_fused_supported():
            return BucketStore.acquire_hierarchical_many_blocking(
                self, tenants, keys, counts, tenant_capacity,
                tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
                with_remaining=with_remaining, priority=priority)
        counts_np = np.asarray(counts, np.int64)
        outs = self._hier_dispatch(tenants, keys, counts_np, tenant_capacity,
                                   tenant_fill_rate_per_sec, capacity,
                                   fill_rate_per_sec)
        res = self._hier_gather(outs, len(keys), with_remaining)
        _grant_zero_probes(res.granted, counts_np)
        return res

    # -- concurrency semaphore ---------------------------------------------
    @property
    def _semas(self) -> K.SemaState:
        if self._sema_state is None:
            self._sema_state = K.init_sema_state(self.counter_slots,
                                                 self.device)
        return self._sema_state

    def _sweep_semas(self) -> None:
        """Evict idle semaphore slots (none held, untouched for 86400 s)."""
        with self.profiler.span("sweep_semas", self._semas.active.shape[0]):
            mask, counts = ck.sweep_semas(self._semas,
                                          self.clock.now_ticks())
            if int(_to_host(counts).sum()) > 0:
                dead = np.nonzero(_to_host(mask))[0].astype(np.int32)
                self.metrics.slots_evicted += self._sema_dir.remove_slots(
                    dead)
            self.metrics.sweeps += 1

    def _grow_semas(self) -> None:
        """Double the semaphore table (old state copied, new half empty)."""
        old_n = self._semas.active.shape[0]
        grown = K.init_sema_state(old_n * 2, self.device)
        for dst, src in zip(grown, self._semas):
            dst[:old_n] = src
        self._sema_state = grown
        self._sema_dir.add_slots(old_n, old_n * 2)

    def _resolve_semas(self, keys: list[str]) -> np.ndarray:
        """Resolve-with-allocate for acquire rows: on exhaustion a sweep,
        then a doubling if it freed nothing (the batch is re-resolved whole
        before the launch, so nothing needs pinning)."""
        return _resolve_with_reclaim(self._sema_dir, keys,
                                     lambda pinned: self._sweep_semas(),
                                     self._grow_semas)

    def _sema_launch(self, slots, deltas, limits) -> torch.Tensor:
        """One ``sema_packed`` launch of ``len(slots)`` rows, padded to a
        power of two ≥ 8 (the caller holds the store lock)."""
        n = len(slots)
        b = _pad_size(n, floor=8)
        packed = np.full((4, b), -1, np.int32)
        packed[1] = 0
        packed[2] = 0
        packed[0, :n] = slots
        packed[1, :n] = deltas
        packed[2, :n] = limits
        packed[3] = self.now_ticks_checked()
        return ck.sema_packed(self._semas,
                              torch.from_numpy(packed).to(self.device))

    def _sema_dispatch(self, key: str, delta: int,
                       limit: int) -> "torch.Tensor | None":
        """One semaphore op (one launch). A probe or a release looks the key
        up without allocating: an unknown key holds nothing, and ``None``
        comes back without a launch."""
        with self.profiler.span("sema"), self._lock:
            if delta <= 0:
                slot = self._sema_dir.lookup(key)
                if slot is None:
                    return None
            else:
                slot = int(self._resolve_semas([key])[0])
            return self._sema_launch([slot], [delta], [limit])

    async def concurrency_acquire(self, key: str, count: int,
                                  limit: int) -> AcquireResult:
        await self.connect()
        out = self._sema_dispatch(key, count, limit)
        if out is None:  # probe of an unknown key: zero permits held
            return AcquireResult(True, 0.0)
        loop = asyncio.get_running_loop()
        out_np = await loop.run_in_executor(None, _to_host, out)
        return AcquireResult(bool(out_np[0, 0] > 0.5), float(out_np[1, 0]))

    def concurrency_acquire_blocking(self, key: str, count: int,
                                     limit: int) -> AcquireResult:
        out = self._sema_dispatch(key, count, limit)
        if out is None:
            return AcquireResult(True, 0.0)
        out_np = _to_host(out)
        return AcquireResult(bool(out_np[0, 0] > 0.5), float(out_np[1, 0]))

    async def concurrency_release(self, key: str, count: int) -> None:
        out = self._sema_dispatch(key, -count, 0)
        if out is not None:  # an unknown key has nothing to release
            loop = asyncio.get_running_loop()
            await loop.run_in_executor(None, _to_host, out)

    def concurrency_release_blocking(self, key: str, count: int) -> None:
        out = self._sema_dispatch(key, -count, 0)
        if out is not None:
            _to_host(out)

    async def concurrency_acquire_many(self, keys, deltas, limit
                                       ) -> BulkAcquireResult:
        """Bulk semaphore ops: one ``sema_packed`` launch per 4096-row chunk,
        chunks in request order. Acquire rows resolve with allocation;
        probe and release rows only look up — an unknown key answers
        ``(True, 0.0)`` on the host and never allocates.

        A slot whose rows mix a release with any other row runs those rows
        one op at a time instead: the kernel clamps a slot's net delta at
        zero, so an over-release could otherwise swallow a granted
        acquire's permit. (The hazard is found on the resolved slots; the
        JAX store finds it on the keys, which names the same rows.)"""
        await self.connect()
        n = len(keys)
        deltas_np = np.asarray(deltas, np.int64)
        limits_np = self._sema_limits(limit, n)
        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32)
        slots = np.full(n, -1, np.int64)
        acq_idx = np.nonzero(deltas_np > 0)[0]
        outs = []
        with self.profiler.span("sema_bulk", n), self._lock:
            if len(acq_idx):
                slots[acq_idx] = self._resolve_semas(
                    [keys[i] for i in acq_idx.tolist()])
            for i in np.nonzero(deltas_np <= 0)[0].tolist():
                s = self._sema_dir.lookup(keys[i])
                slots[i] = -1 if s is None else s
            known = slots >= 0
            granted[~known] = True  # unknown-key probe or release: a no-op
            hazard = np.zeros(n, bool)
            if (known & (deltas_np < 0)).any():
                _, inv, cnt = np.unique(slots[known], return_inverse=True,
                                        return_counts=True)
                released = np.zeros(len(cnt), bool)
                released[inv[deltas_np[known] < 0]] = True
                hazard[known] = released[inv] & (cnt[inv] > 1)
            batch = np.nonzero(known & ~hazard)[0]
            for s0 in range(0, len(batch), ck.SEMA_MAX_BATCH):
                sub = batch[s0:s0 + ck.SEMA_MAX_BATCH]
                outs.append((sub, self._sema_launch(
                    slots[sub], deltas_np[sub], limits_np[sub])))
            for i in np.nonzero(known & hazard)[0].tolist():
                d = int(deltas_np[i])
                # As the scalar entry points: acquires and probes carry the
                # row's limit, releases 0.
                out = self._sema_dispatch(keys[i], d,
                                          int(limits_np[i]) if d >= 0 else 0)
                if out is None:
                    # The key vanished since the lookup (an acquire row's
                    # resolve swept its zero-held slot): a no-op, as on the
                    # scalar path.
                    granted[i] = True
                else:
                    outs.append((np.array([i]), out))
        loop = asyncio.get_running_loop()
        host = await loop.run_in_executor(
            None, lambda: [_to_host(o) for _, o in outs])
        for (sub, _), out_np in zip(outs, host):
            m = len(sub)
            granted[sub] = out_np[0, :m] > 0.5
            remaining[sub] = np.where(deltas_np[sub] < 0, 0.0, out_np[1, :m])
        return BulkAcquireResult(granted, remaining)

    # -- TTL maintenance ---------------------------------------------------
    def sweep_all(self) -> None:
        """One TTL-eviction pass over every bucket and window table, the
        counter table and (once allocated) the semaphore table — the active
        expiry pass, so an idle store's memory shrinks without waiting for
        the next allocation to force a sweep."""
        with self._lock:
            for t in (*self._tables.values(), *self._wtables.values()):
                t._sweep()
            self._sweep_counters()
            if self._sema_state is not None:
                self._sweep_semas()

    def start_sweeper(self, period_s: float = 30.0) -> None:
        """Start the periodic active-expiry task on the running event loop
        (idempotent). Stops in :meth:`aclose`."""
        if self._sweeper_task is not None and not self._sweeper_task.done():
            return
        self._sweeper_task = start_periodic_sweeper(self.sweep_all, period_s)

    # -- lifecycle / ops ---------------------------------------------------
    async def aclose(self) -> None:
        # The sweeper first: it must not start a pass over tables whose
        # batchers are closing.
        if self._sweeper_task is not None:
            self._sweeper_task.cancel()
            try:
                await self._sweeper_task
            except (asyncio.CancelledError, Exception):
                pass  # a failed sweeper must not abort batcher cleanup
            self._sweeper_task = None
        for t in (*self._tables.values(), *self._wtables.values()):
            await t.batcher.aclose()

    # -- dirty accounting (incremental checkpoints, runtime/checkpoint.py) --
    def enable_dirty_tracking(self) -> None:
        """Arm per-table dirty accounting: between two saves every slot a
        launch resolves is counted, so OP_STATS can report the dirty/total
        ratio that predicts the next delta's size. Observability only: the
        delta itself is a structural diff, correct with or without this.
        The counter and semaphore tables stay untracked, as in the JAX
        store: a handful of fixed arrays beside the key tables."""
        with self._lock:
            self._dirty_tracking = True
            for t in (*self._tables.values(), *self._wtables.values()):
                t.arm_dirty()

    def mark_snapshot_base(self) -> None:
        """Start a fresh dirty window (the checkpoint chain calls it at
        every save: the window is save to save)."""
        with self._lock:
            for t in (*self._tables.values(), *self._wtables.values()):
                t.clear_dirty()

    def dirty_stats(self) -> dict:
        with self._lock:
            dirty = total = 0
            for t in (*self._tables.values(), *self._wtables.values()):
                dirty += t.dirty_count()
                total += t.n_slots
            return {"dirty": dirty, "total": total}

    def snapshot(self) -> dict:
        """Pull all live state to the host, in the JAX store's schema.
        ``now_ticks`` is captured so a restore into another process (fresh
        clock epoch) can re-align every timestamp."""
        with self._lock:
            c = self._counters
            sm = self._semas
            return {
                "now_ticks": self.clock.now_ticks(),
                "tables": {key: t.to_snap()
                           for key, t in self._tables.items()},
                "wtables": {key: t.to_snap()
                            for key, t in self._wtables.items()},
                "counter_dir": self._counter_dir.to_dict(),
                "counters": {
                    "value": _to_host(c.value).copy(),
                    "period": _to_host(c.period).copy(),
                    "last_ts": _to_host(c.last_ts).copy(),
                    "exists": _to_host(c.exists).copy(),
                },
                "sema_dir": self._sema_dir.to_dict(),
                "semas": {
                    "active": _to_host(sm.active).copy(),
                    "last_ts": _to_host(sm.last_ts).copy(),
                    "exists": _to_host(sm.exists).copy(),
                },
            }

    def restore(self, snap: dict) -> None:
        """Restore a checkpoint — this store's own or one the JAX
        ``DeviceBucketStore.snapshot()`` wrote — re-aligning timestamps to
        this process's clock epoch (shift by ``now_here − now_at_snapshot``;
        window indices by its whole windows). A checkpoint from before the
        semaphores (no ``semas`` section) leaves the semaphore table as it
        is."""
        with self._lock:
            shift = int(self.clock.now_ticks()) - int(snap["now_ticks"])
            for (cap, rate), data in snap["tables"].items():
                self._table(cap, rate).load_snap(data, shift)
            for wkey, data in (snap.get("wtables") or {}).items():
                # Snapshots from before the fixed window carry (limit,
                # window_ticks) keys: sliding windows.
                limit, wt = wkey[0], wkey[1]
                fixed = bool(wkey[2]) if len(wkey) > 2 else False
                self._wtable(limit, wt / bm.TICKS_PER_SECOND,
                             fixed).load_snap(data, shift)
            c = snap.get("counters")
            if c is not None:
                dev = self.device
                self._counter_state = K.CounterState(
                    value=torch.tensor(np.asarray(c["value"], np.float32),
                                       device=dev),
                    period=torch.tensor(np.asarray(c["period"], np.float32),
                                        device=dev),
                    last_ts=torch.tensor(_shift_ts(c["last_ts"], shift),
                                         device=dev),
                    exists=torch.tensor(np.asarray(c["exists"], bool),
                                        device=dev),
                )
                self._counter_dir.load(snap["counter_dir"],
                                       len(c["value"]))
            sm = snap.get("semas")
            if sm is not None:
                dev = self.device
                self._sema_state = K.SemaState(
                    active=torch.tensor(np.asarray(sm["active"], np.int32),
                                        device=dev),
                    last_ts=torch.tensor(_shift_ts(sm["last_ts"], shift),
                                         device=dev),
                    exists=torch.tensor(np.asarray(sm["exists"], bool),
                                        device=dev),
                )
                self._sema_dir.load(snap["sema_dir"], len(sm["active"]))


DeviceBucketStore._TABLE_CLS = _DeviceTable
DeviceBucketStore._WTABLE_CLS = _DeviceWindowTable


class InProcessBucketStore(BucketStore):
    """Pure-Python store with the device store's semantics, executed
    serially per request — the differential oracle, the test fake and the
    Redis-class CPU baseline (one 'script' per op, no batching). Its
    arithmetic is Python floats, as the JAX package's is, so the two
    packages' serial stores agree field for field. A named store only:
    nothing constructs it in place of a :class:`DeviceBucketStore`."""

    def __init__(self, clock: Clock | None = None) -> None:
        self.clock = clock or MonotonicClock()
        self._buckets: dict[tuple, tuple[float, int]] = {}   # (tokens, ts)
        self._counters: dict[str, tuple[float, float, int]] = {}  # (v, p, ts)
        self._windows: dict[tuple, tuple[float, float, int]] = {}
        self._semas: dict[str, int] = {}                     # active permits
        self._connected = False
        # Dirty-key accounting for incremental checkpoints — None (one
        # check per write) until armed.
        self._dirty: "set | None" = None

    async def connect(self) -> None:
        self._connected = True

    def _acquire_core(self, key, count, capacity, rate_per_sec) -> AcquireResult:
        now = self.clock.now_ticks()
        rate = _rate_per_tick(rate_per_sec)
        bkey = (key, float(capacity), float(rate_per_sec))
        entry = self._buckets.get(bkey)
        if entry is None:
            refilled = float(capacity)
        else:
            tokens, ts = entry
            refilled = min(float(capacity), tokens + max(0, now - ts) * rate)
        granted = refilled >= count
        self._buckets[bkey] = (refilled - (count if granted else 0), now)
        if self._dirty is not None:
            self._dirty.add(bkey)
        return AcquireResult(granted, self._buckets[bkey][0])

    async def acquire(self, key, count, capacity, fill_rate_per_sec):
        await self.connect()
        return self._acquire_core(key, count, capacity, fill_rate_per_sec)

    def acquire_blocking(self, key, count, capacity, fill_rate_per_sec):
        return self._acquire_core(key, count, capacity, fill_rate_per_sec)

    async def acquire_many(self, keys, counts, capacity, fill_rate_per_sec,
                           *, with_remaining: bool = True):
        """Serial-core bulk: one in-order pass over the batch with NO
        task-per-key (the base class's gather spends ~10µs/key on task
        scheduling — measurable when this store backs the native front-end
        as the zero-cost-kernel stand-in). Still awaits ``self.acquire``
        per key: the per-key method stays the single override point for
        test fakes and subclasses, and awaiting a non-suspending
        coroutine costs no loop round trip."""
        await self.connect()
        n = len(keys)
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32) if with_remaining else None
        # Direct-core loop only when per-key acquire is NOT overridden:
        # subclasses/test fakes that intercept acquire() must see every
        # bulk key too (a coroutine frame per key costs ~20% on the
        # native-front-end stand-in, so the unsubclassed store skips it).
        direct = type(self).acquire is InProcessBucketStore.acquire
        for i, (k, c) in enumerate(zip(keys, counts)):
            r = (self._acquire_core(k, int(c), capacity, fill_rate_per_sec)
                 if direct else
                 await self.acquire(k, int(c), capacity, fill_rate_per_sec))
            granted[i] = r.granted
            if remaining is not None:
                remaining[i] = r.remaining
        return BulkAcquireResult(granted, remaining)

    async def window_acquire_many(self, keys, counts, limit, window_sec, *,
                                  fixed: bool = False,
                                  with_remaining: bool = True):
        await self.connect()
        op = (self.fixed_window_acquire if fixed else self.window_acquire)
        n = len(keys)
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32) if with_remaining else None
        for i, (k, c) in enumerate(zip(keys, counts)):
            r = await op(k, int(c), limit, window_sec)
            granted[i] = r.granted
            if remaining is not None:
                remaining[i] = r.remaining
        return BulkAcquireResult(granted, remaining)

    def peek_blocking(self, key, capacity, fill_rate_per_sec):
        now = self.clock.now_ticks()
        bkey = (key, float(capacity), float(fill_rate_per_sec))
        entry = self._buckets.get(bkey)
        if entry is None:
            return float(np.floor(capacity))
        tokens, ts = entry
        rate = _rate_per_tick(fill_rate_per_sec)
        return float(np.floor(min(float(capacity), tokens + max(0, now - ts) * rate)))

    async def debit_many(self, keys, amounts, capacity, fill_rate_per_sec):
        """Serial saturating debit — the device kernel's semantics
        (:func:`~..ops.kernels.debit_batch_packed`): refill, then subtract
        clamped at zero, reporting the clamped shortfall."""
        now = self.clock.now_ticks()
        rate = _rate_per_tick(fill_rate_per_sec)
        n = len(keys)
        remaining = np.empty(n, np.float64)
        shortfall = np.empty(n, np.float64)
        for i, (k, amt) in enumerate(zip(keys, amounts)):
            amt = float(amt)
            bkey = (k, float(capacity), float(fill_rate_per_sec))
            entry = self._buckets.get(bkey)
            if entry is None:
                refilled = float(capacity)
            else:
                tokens, ts = entry
                refilled = min(float(capacity),
                               tokens + max(0, now - ts) * rate)
            applied = min(amt, max(refilled, 0.0))
            self._buckets[bkey] = (refilled - applied, now)
            if self._dirty is not None:
                self._dirty.add(bkey)
            remaining[i] = refilled - applied
            shortfall[i] = amt - applied
        return remaining, shortfall

    # -- hierarchical tenant → key admission (exact serial core) -----------
    def _hier_refill(self, bkey: tuple, capacity: float,
                     rate_per_sec: float, now: int) -> float:
        entry = self._buckets.get(bkey)
        if entry is None:
            return float(capacity)
        tokens, ts = entry
        rate = _rate_per_tick(rate_per_sec)
        return min(float(capacity), tokens + max(0, now - ts) * rate)

    def _hier_core(self, tenant, key, count, tcap, trate, cap, rate
                   ) -> AcquireResult:
        """Atomic two-level decision — the serial reference the two-level
        kernel (:func:`~..ops.kernels.acquire_hierarchical_packed`) is
        differential-tested against: refill both levels, grant iff
        both cover ``count``, debit both-or-neither, advance BOTH
        timestamps either way (a denied request leaves each bucket
        exactly as a refill-only touch would — the refund contract,
        closed algebraically)."""
        check_hierarchical_args(count, tcap, trate, cap, rate)
        now = self.clock.now_ticks()
        ckey = (key, float(cap), float(rate))
        pkey = (tenant, float(tcap), float(trate))
        c_ref = self._hier_refill(ckey, cap, rate, now)
        p_ref = self._hier_refill(pkey, tcap, trate, now)
        granted = c_ref >= count and p_ref >= count
        spend = count if granted else 0
        self._buckets[ckey] = (c_ref - spend, now)
        self._buckets[pkey] = (p_ref - spend, now)
        if self._dirty is not None:
            self._dirty.add(ckey)
            self._dirty.add(pkey)
        return AcquireResult(granted,
                             min(c_ref - spend, p_ref - spend))

    async def acquire_hierarchical(self, tenant, key, count,
                                   tenant_capacity,
                                   tenant_fill_rate_per_sec, capacity,
                                   fill_rate_per_sec, *, priority=0):
        await self.connect()
        return self._hier_core(tenant, key, int(count), tenant_capacity,
                               tenant_fill_rate_per_sec, capacity,
                               fill_rate_per_sec)

    def acquire_hierarchical_blocking(self, tenant, key, count,
                                      tenant_capacity,
                                      tenant_fill_rate_per_sec, capacity,
                                      fill_rate_per_sec, *, priority=0):
        return self._hier_core(tenant, key, int(count), tenant_capacity,
                               tenant_fill_rate_per_sec, capacity,
                               fill_rate_per_sec)

    async def acquire_hierarchical_many(self, tenants, keys, counts,
                                        tenant_capacity,
                                        tenant_fill_rate_per_sec,
                                        capacity, fill_rate_per_sec, *,
                                        with_remaining: bool = True,
                                        priority: int = 0):
        """Serial-core bulk: one in-order pass, no per-row coroutine —
        one extra dict round a row over the flat serial core."""
        await self.connect()
        return self.acquire_hierarchical_many_blocking(
            tenants, keys, counts, tenant_capacity,
            tenant_fill_rate_per_sec, capacity, fill_rate_per_sec,
            with_remaining=with_remaining, priority=priority)

    def acquire_hierarchical_many_blocking(self, tenants, keys, counts,
                                           tenant_capacity,
                                           tenant_fill_rate_per_sec,
                                           capacity, fill_rate_per_sec,
                                           *, with_remaining: bool = True,
                                           priority: int = 0):
        n = len(keys)
        granted = np.empty(n, bool)
        remaining = np.empty(n, np.float32) if with_remaining else None
        core = self._hier_core
        for i in range(n):
            r = core(tenants[i], keys[i], int(counts[i]),
                     tenant_capacity, tenant_fill_rate_per_sec,
                     capacity, fill_rate_per_sec)
            granted[i] = r.granted
            if remaining is not None:
                remaining[i] = r.remaining
        return BulkAcquireResult(granted, remaining)

    async def sync_counter(self, key, local_count, decay_rate_per_sec):
        return self.sync_counter_blocking(key, local_count, decay_rate_per_sec)

    def sync_counter_blocking(self, key, local_count, decay_rate_per_sec):
        now = self.clock.now_ticks()
        rate = _rate_per_tick(decay_rate_per_sec)
        entry = self._counters.get(key)
        if entry is None:
            v, p = float(local_count), float(now)
        else:
            v0, p0, ts = entry
            delta = max(0, now - ts)
            v = max(0.0, v0 - delta * rate) + local_count
            p = (1 - bm.PERIOD_EWMA_ALPHA) * p0 + bm.PERIOD_EWMA_ALPHA * delta
        self._counters[key] = (v, p, now)
        if self._dirty is not None:
            self._dirty.add(key)
        return SyncResult(v, p)

    async def concurrency_acquire(self, key, count, limit):
        return self.concurrency_acquire_blocking(key, count, limit)

    def concurrency_acquire_blocking(self, key, count, limit):
        active = self._semas.get(key, 0)
        if active + count <= limit:
            if count > 0:  # count == 0 is a read-only probe
                self._semas[key] = active + count
                if self._dirty is not None:
                    self._dirty.add(key)
            return AcquireResult(True, float(active + count))
        return AcquireResult(False, float(active))

    async def concurrency_release(self, key, count):
        self.concurrency_release_blocking(key, count)

    def concurrency_release_blocking(self, key, count):
        if key not in self._semas:
            return  # unknown key: nothing to release, create nothing
        self._semas[key] = max(0, self._semas[key] - count)
        if self._dirty is not None:
            self._dirty.add(key)

    async def window_acquire(self, key, count, limit, window_sec):
        return self.window_acquire_blocking(key, count, limit, window_sec)

    def window_acquire_blocking(self, key, count, limit, window_sec):
        return self._window_core(key, count, limit, window_sec,
                                 interpolate=True)

    async def fixed_window_acquire(self, key, count, limit, window_sec):
        return self._window_core(key, count, limit, window_sec,
                                 interpolate=False)

    def fixed_window_acquire_blocking(self, key, count, limit, window_sec):
        return self._window_core(key, count, limit, window_sec,
                                 interpolate=False)

    def _window_core(self, key, count, limit, window_sec, *, interpolate):
        now = self.clock.now_ticks()
        wt = int(window_sec * bm.TICKS_PER_SECOND)
        wkey = (key, float(limit), wt, interpolate)
        entry = self._windows.get(wkey)
        idx_now = now // wt
        if entry is None:
            prev = curr = 0.0
        else:
            prev, curr, idx = entry
            steps = idx_now - idx
            if steps == 1:
                prev, curr = curr, 0.0
            elif steps >= 2:
                prev = curr = 0.0
        if interpolate:
            frac = (now - idx_now * wt) / wt
            est = curr + prev * (1.0 - frac)
        else:
            est = curr
        granted = est + count <= limit
        if granted:
            curr += count
        self._windows[wkey] = (prev, curr, idx_now)
        if self._dirty is not None:
            self._dirty.add(wkey)
        return AcquireResult(granted, max(0.0, limit - est - (count if granted else 0)))

    async def aclose(self) -> None:
        pass

    async def import_entries(self, entries: dict) -> int:
        """Exact merge lane for migration handoffs (the generic replay in
        :func:`~.placement.import_entries` is for stores whose state only
        the kernels can write). Conservative on collisions — a
        re-pushed batch or pre-existing local state must never inflate
        a budget: buckets keep the smaller balance, windows sum their
        counts (clamped to the limit), counters and semaphores keep the
        larger value."""
        now = self.clock.now_ticks()
        n = 0
        for key, cap, rate, tokens, age in entries.get("buckets", ()):
            bkey = (key, float(cap), float(rate))
            ts = now - int(age)
            entry = self._buckets.get(bkey)
            if entry is None:
                self._buckets[bkey] = (float(tokens), ts)
            else:
                self._buckets[bkey] = (min(entry[0], float(tokens)),
                                       max(entry[1], ts))
            if self._dirty is not None:
                self._dirty.add(bkey)
            n += 1
        for key, limit, wt, interp, prev, curr, behind in \
                entries.get("windows", ()):
            wkey = (key, float(limit), int(wt), bool(interp))
            idx = now // int(wt) - int(behind)
            entry = self._windows.get(wkey)
            if entry is None or entry[2] < idx:
                # no local state, or the LOCAL entry is the stale one
                # (an earlier epoch's leftovers): the push wins outright
                self._windows[wkey] = (float(prev), float(curr), idx)
            elif entry[2] == idx:
                self._windows[wkey] = (
                    min(float(limit), entry[0] + float(prev)),
                    min(float(limit), entry[1] + float(curr)), idx)
            # a stale PUSHED window (older idx) carries no usage to keep
            if self._dirty is not None:
                self._dirty.add(wkey)
            n += 1
        for key, value, period, age in entries.get("counters", ()):
            entry = self._counters.get(key)
            if entry is None or entry[0] < value:
                self._counters[key] = (float(value), float(period),
                                       now - int(age))
            if self._dirty is not None:
                self._dirty.add(key)
            n += 1
        for key, active in entries.get("semas", ()):
            self._semas[key] = max(self._semas.get(key, 0), int(active))
            if self._dirty is not None:
                self._dirty.add(key)
            n += 1
        return n

    # -- dirty accounting (incremental checkpoints, runtime/checkpoint.py) --
    def enable_dirty_tracking(self) -> None:
        """Arm exact per-entry dirty accounting (the device store's
        counterpart tracks slots): between two saves every written entry
        key is counted, so OP_STATS reports the dirty/total ratio that
        predicts the next v4 delta's size. Observability only — the
        delta is a structural diff either way."""
        if self._dirty is None:
            self._dirty = set()

    def mark_snapshot_base(self) -> None:
        if self._dirty is not None:
            self._dirty.clear()

    def dirty_stats(self) -> dict:
        return {"dirty": len(self._dirty or ()),
                "total": (len(self._buckets) + len(self._windows)
                          + len(self._counters) + len(self._semas))}

    def snapshot(self) -> dict:
        return {
            "now_ticks": self.clock.now_ticks(),
            "buckets": dict(self._buckets),
            "counters": dict(self._counters),
            "windows": dict(self._windows),
            "semas": dict(self._semas),
        }

    def restore(self, snap: dict) -> None:
        """Same clock-epoch re-alignment as the device store: stored
        timestamps shift by ``now_here − now_at_snapshot`` so elapsed time
        (refill/decay) survives a restore into a fresh process."""
        # Snapshots from before the epoch field behave as same-process.
        shift = (int(self.clock.now_ticks()) - int(snap["now_ticks"])
                 if "now_ticks" in snap else 0)
        self._buckets = {
            k: (tokens, ts + shift)
            for k, (tokens, ts) in snap["buckets"].items()
        }
        self._counters = {
            k: (v, p, ts + shift)
            for k, (v, p, ts) in snap["counters"].items()
        }
        # Pre-fixed-window snapshots carry 3-tuple window keys (sliding);
        # normalize to the 4-tuple (key, limit, wt, interpolate=True).
        self._windows = {
            (k if len(k) == 4 else (*k, True)): (prev, curr, idx + shift // k[2])
            for k, (prev, curr, idx) in snap["windows"].items()
        }
        self._semas = dict(snap.get("semas", {}))  # counts are epoch-free
