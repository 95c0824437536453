"""The bucket store — where rate-limit state lives and decisions execute.

The exact-token-bucket and decaying-counter half of the JAX package's
``runtime/store.py``, on PyTorch:

- :class:`BucketStore` — the storage seam (abstract). The bucket and
  counter methods are the contract; the window, semaphore, hierarchical and
  reservation methods are not ported yet and raise ``NotImplementedError``.
- :class:`DeviceBucketStore` — per-key bucket state lives on the device
  as SoA tensors, one table per bucket configuration ``(capacity,
  fill_rate)``; ``acquire`` calls are micro-batched into one packed
  ``i32[4|5, B]`` operand, one kernel launch and one ``f32[2, B]`` readback.
  The approximate bucket's global counters live in one counter table; a
  sync (one limiter's, or a whole fleet's through ``sync_counters_many``)
  is one ``i32[3, B]`` operand, one launch and one ``f32[2, B]`` readback.
  The store's clock stamps every launch. Tables grow by doubling and
  reclaim slots with TTL sweeps; every table resolves keys through the
  native key directory when it builds.

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
from distributedratelimiting.redis_tpu_torch.utils import log
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
    "SyncResult",
]

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

    # -- lifecycle / ops ---------------------------------------------------
    @abc.abstractmethod
    async def aclose(self) -> None: ...

    @abc.abstractmethod
    def snapshot(self) -> dict:
        """Host-side checkpoint of all live state."""

    @abc.abstractmethod
    def restore(self, snap: dict) -> None: ...


def _not_ported(name: str):
    def method(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__}.{name} is not ported to the PyTorch "
            "package yet (the exact token bucket and the decaying counters "
            "are)")

    method.__name__ = name
    return method


# The rest of the storage seam: windows, semaphores, hierarchical
# admission, reservations, tier-0 debits, migration export.
for _name in ("debit_many", "window_acquire", "window_acquire_blocking",
              "fixed_window_acquire", "fixed_window_acquire_blocking",
              "window_acquire_many", "window_acquire_many_blocking",
              "concurrency_acquire", "concurrency_acquire_blocking",
              "concurrency_release", "concurrency_release_blocking",
              "concurrency_acquire_many", "acquire_hierarchical",
              "acquire_hierarchical_blocking", "acquire_hierarchical_many",
              "acquire_hierarchical_many_blocking", "reserve", "settle",
              "export_entries"):
    setattr(BucketStore, _name, _not_ported(_name))


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
    prefixes."""

    async def _flush(self, reqs: Sequence[_AcquireReq]) -> list[AcquireResult]:
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
            b = self.store.max_batch
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

    def acquire_blocking(self, key: str, count: int) -> AcquireResult:
        out_np = _to_host(self._launch([_AcquireReq(key, count)]))
        return AcquireResult(bool(out_np[0, 0] > 0.5), float(out_np[1, 0]))

    # -- bulk machinery (acquire_many) -------------------------------------
    #: Max scanned batches per bulk dispatch; K is chosen per call from
    #: {1, 2, 4, …, 32}.
    _BULK_MAX_K = 32

    def _launch_many(self, slots: np.ndarray, counts_np: np.ndarray,
                     with_remaining: bool = True) -> list[tuple]:
        """Dispatch a whole resolved slot array as scanned launches;
        returns per-dispatch device results (no readback — callers overlap
        it). Counts that fit a byte ride the fused 5-bytes/decision operand;
        larger counts travel as one ``i32[2, K, B]`` operand (slots, then
        counts). The caller holds the store lock."""
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
            packed = np.full((5, b), -1, np.int32)
            packed[1] = 0
            packed[3] = 0  # one group per slot per call ⇒ prefix 0
            packed[4] = 0
            packed[0, :m] = gslots[pos:pos + m]
            packed[1, :m] = gcounts[pos:pos + m]
            packed[2] = now
            packed[4, :m] = np.minimum(lengths[pos:pos + m], 2**31 - 1)
            out = self._launch_grouped(self._upload(packed))
            outs.append((out, m))
            self.store.metrics.record_launch(b, m)
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
        with self.store.profiler.span("acquire_many", n), self.store._lock:
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
        self.store = store
        self.capacity = float(capacity)
        self.fill_rate_per_sec = float(fill_rate_per_sec)
        self.rate_per_tick = _rate_per_tick(fill_rate_per_sec)
        self.state = K.init_bucket_state(n_slots, store.device)
        self.n_slots = n_slots
        self.dir = make_directory(n_slots)
        self.batcher: MicroBatcher[_AcquireReq, AcquireResult] = MicroBatcher(
            self._flush,
            max_batch=store.max_batch,
            max_delay_s=store.max_delay_s,
            max_inflight=store.max_inflight,
            flush_latency=store.metrics.flush_latency,
            queue_latency=store.metrics.queue_latency,
        )

    # -- slot management ---------------------------------------------------
    def resolve_slots(self, keys: list[str]) -> np.ndarray:
        """Batch key→slot resolution (the host hot path)."""
        return _resolve_with_reclaim(self.dir, keys, self._sweep, self._grow,
                                     min_free=self.n_slots // 16)

    def _sweep(self, pinned: set[int] | None = None) -> None:
        """Reclaim slots whose buckets have sat full-refilled past TTL. One
        sweep-kernel pass; its per-tile expired counts let a sweep that
        freed nothing finish after reading T ints instead of the N-byte
        mask.

        ``pinned`` slots (already resolved for the in-flight batch) are not
        returned to the free-list — a sweep triggered mid-batch must not
        hand a slot an earlier request of the same batch is about to touch
        to another key. Their ``exists`` is cleared all the same, which only
        means init-on-miss to a full bucket: an expired bucket is full."""
        with self.store.profiler.span("sweep", self.n_slots):
            self._sweep_locked(pinned)

    def _sweep_locked(self, pinned: set[int] | None = None) -> None:
        now = self.store.clock.now_ticks()
        mask, counts = ck.sweep_expired(self.state, now, self.capacity,
                                        self.rate_per_tick)
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
        new_n = old_n * 2
        grown = K.init_bucket_state(new_n, self.store.device)
        for dst, src in zip(grown, self.state):
            dst[:old_n] = src
        self.state = grown
        self.dir.add_slots(old_n, new_n)
        self.n_slots = new_n

    # -- decision paths ----------------------------------------------------
    def _launch_grouped(self, packed: torch.Tensor) -> torch.Tensor:
        return ck.acquire_grouped(self.state, packed, self.capacity,
                                  self.rate_per_tick)

    def _launch(self, reqs: Sequence[_AcquireReq]) -> torch.Tensor:
        """Build the padded operand and launch one decision. The whole
        read-modify-write of the table runs under the store lock: the
        blocking path may be called from any thread while the event loop
        flushes batches."""
        with self.store.profiler.span("acquire_batch", len(reqs)), \
                self.store._lock:
            slots = self.resolve_slots([r.key for r in reqs])
            # Fixed pad width: every flush has the same shape.
            b = self.store.max_batch
            now = self.store.now_ticks_checked()
            packed = _build_packed(reqs, slots, b, now)
            out = ck.acquire_packed(self.state, self._upload(packed),
                                    self.capacity, self.rate_per_tick)
            self.store.metrics.record_launch(b, len(reqs))
            return out

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
    def to_snap(self) -> dict:
        return {
            "directory": self.dir.to_dict(),
            "tokens": _to_host(self.state.tokens).copy(),
            "last_ts": _to_host(self.state.last_ts).copy(),
            "exists": _to_host(self.state.exists).copy(),
        }

    def load_snap(self, data: dict, shift: int) -> None:
        if "directory" not in data:
            raise NotImplementedError(
                "checkpoint's bucket tables use the device-resident "
                "fingerprint directory, which is not ported yet")
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


def _live_rows(section) -> int:
    """Live rows of a snapshot's semaphore section (0 if absent)."""
    if not section:
        return 0
    return int(np.count_nonzero(np.asarray(section["exists"])))


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
            if max_batch > ck.SCAN_MAX_BATCH:
                raise ValueError(
                    f"max_batch {max_batch} > {ck.SCAN_MAX_BATCH}: the card's "
                    "bulk-lane kernel holds one batch in one thread block")
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self.clock = clock or MonotonicClock()
        self.profiler = Profiler(profiling_session)
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
        # The counter table is allocated at first use, as bucket tables are:
        # construction touches no device.
        self._counter_state: K.CounterState | None = None
        self._counter_dir = make_directory(counter_slots)
        self._lock = threading.RLock()  # directory/slot allocation guard
        self._rebase_threshold = rebase_threshold_ticks
        self._connected = False
        self._connect_gate = asyncio.Lock()
        self._sweeper_task: asyncio.Task | None = None

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
            for t in self._tables.values():
                t.rebase(offset)
            if self._counter_state is not None:
                K.rebase_counter_epoch(self._counter_state, offset)

    # -- table routing -----------------------------------------------------
    def _table(self, capacity: float, fill_rate_per_sec: float) -> _DeviceTable:
        key = (float(capacity), float(fill_rate_per_sec))
        with self._lock:
            table = self._tables.get(key)
            if table is None:
                table = _DeviceTable(self, capacity, fill_rate_per_sec,
                                     self.n_slots_default)
                self._tables[key] = table
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

    # -- TTL maintenance ---------------------------------------------------
    def sweep_all(self) -> None:
        """One TTL-eviction pass over every bucket table and the counter
        table — the active expiry pass, so an idle store's memory shrinks
        without waiting for the next allocation to force a sweep."""
        with self._lock:
            for t in list(self._tables.values()):
                t._sweep()
            self._sweep_counters()

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
        for t in self._tables.values():
            await t.batcher.aclose()

    def snapshot(self) -> dict:
        """Pull all live state to the host, in the JAX store's schema.
        ``now_ticks`` is captured so a restore into another process (fresh
        clock epoch) can re-align every timestamp."""
        with self._lock:
            c = self._counters
            return {
                "now_ticks": self.clock.now_ticks(),
                "tables": {key: t.to_snap()
                           for key, t in self._tables.items()},
                "wtables": {},
                "counter_dir": self._counter_dir.to_dict(),
                "counters": {
                    "value": _to_host(c.value).copy(),
                    "period": _to_host(c.period).copy(),
                    "last_ts": _to_host(c.last_ts).copy(),
                    "exists": _to_host(c.exists).copy(),
                },
            }

    def restore(self, snap: dict) -> None:
        """Restore a checkpoint — this store's own or one the JAX
        ``DeviceBucketStore.snapshot()`` wrote — re-aligning timestamps to
        this process's clock epoch (shift by ``now_here − now_at_snapshot``).
        Live window or semaphore state cannot be carried yet and raises
        ``NotImplementedError`` rather than being dropped."""
        live = {"window tables": len(snap.get("wtables") or {}),
                "semaphores": _live_rows(snap.get("semas"))}
        held = [name for name, n in live.items() if n]
        if held:
            raise NotImplementedError(
                "snapshot holds live " + ", ".join(held) + ", which the "
                "PyTorch store does not port yet")
        with self._lock:
            shift = int(self.clock.now_ticks()) - int(snap["now_ticks"])
            for (cap, rate), data in snap["tables"].items():
                self._table(cap, rate).load_snap(data, shift)
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
