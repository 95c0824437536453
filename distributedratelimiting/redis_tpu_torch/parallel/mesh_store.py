"""MeshBucketStore — the full store interface over a mesh of shards.

The JAX package's ``parallel/mesh_store.py`` on PyTorch: a
``BucketStoreServer`` can front a whole mesh, so remote client hosts (the
reference's star topology) share bucket state sharded across its shards::

    client hosts ──TCP──▶ server ──micro-batch──▶ two-level step
                                                   (sharded acquire + tier)

Routing of the store surface:

- **Token buckets**: one :class:`~.sharded_store.ShardedDeviceStore` per
  ``(capacity, fill_rate)`` config (``directory="fp"``: a
  :class:`~.fp_sharded.ShardedFpDeviceStore`), each micro-batched so that
  concurrent acquires across all keys coalesce into single launches.
- **Sliding/fixed windows**: key-sharded too
  (:class:`~.sharded_store.ShardedWindowStore` or the fp window store, one
  per ``(limit, window, fixed?)``).
- **Decaying counters, semaphores**: an inner single-table
  :class:`~..runtime.store.DeviceBucketStore` on the mesh's device (the aux
  store): one row per limiter, per-period traffic. Its tables grow by
  doubling past ``aux_slots``.

Every tier shares one clock and one coordinated rebase. Methods JAX's mesh
store does not define (``debit_many``, the bulk semaphore and counter
lanes, the two-level admission, reservations) answer as the
:class:`~..runtime.store.BucketStore` defaults answer there.
"""

from __future__ import annotations

import asyncio
import threading
from contextlib import ExitStack
from typing import Sequence

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.parallel.mesh import (
    Mesh,
    create_mesh,
)
from distributedratelimiting.redis_tpu_torch.parallel.sharded_store import (
    ShardedDeviceStore,
    ShardedWindowStore,
)
from distributedratelimiting.redis_tpu_torch.runtime.batcher import MicroBatcher
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    Clock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BucketStore,
    DeviceBucketStore,
    _AcquireReq,
    _REBASE_MARGIN_TICKS,
    _REBASE_THRESHOLD_TICKS,
    start_periodic_sweeper,
)

__all__ = ["MeshBucketStore"]

#: Sub-stores never self-rebase (the mesh store coordinates): a value the
#: int32 tick clock never reaches.
_NEVER_REBASE = 1 << 62


class _CombinedMetrics:
    """Snapshot view merging the aux store's metrics with every sharded
    tier's (the OP_STATS surface of a mesh-backed server, ``tiers`` per
    config). The latency histograms are the aux store's."""

    def __init__(self, store: "MeshBucketStore") -> None:
        self._store = store

    @property
    def flush_latency(self):
        return self._store._aux.metrics.flush_latency

    @property
    def queue_latency(self):
        return self._store._aux.metrics.queue_latency

    def snapshot(self) -> dict:
        out = self._store._aux.metrics.snapshot()
        with self._store._registry_lock:
            shards = {
                f"bucket[cap={cap},rate={rate}]": s.metrics.snapshot()
                for (cap, rate), s in self._store._shards.items()
            }
            shards.update({
                f"window[limit={limit},wticks={wt},fixed={fx}]":
                    s.metrics.snapshot()
                for (limit, wt, fx), s in self._store._windows.items()
            })
        for sub in shards.values():
            for k in ("launches", "rows_processed", "rows_valid",
                      "sweeps", "slots_evicted"):
                out[k] = out.get(k, 0) + sub[k]
        out["batch_occupancy"] = (
            out["rows_valid"] / out["rows_processed"]
            if out.get("rows_processed") else 0.0)
        out["tiers"] = shards
        return out


class MeshBucketStore(BucketStore):
    """``BucketStore`` whose token-bucket and window tiers are key-sharded
    over a mesh (default: :func:`~.mesh.create_mesh` over every visible
    card). ``directory`` is ``"host"`` (a native key directory a shard) or
    ``"fp"`` (the device-resident fingerprint directory); ``sync_cadence``
    the global tier's, ``"batch"`` or ``"launch"``."""

    def __init__(
        self,
        mesh: Mesh | None = None,
        *,
        per_shard_slots: int = 2**14,
        clock: Clock | None = None,
        max_batch: int = 4096,
        max_delay_s: float = 200e-6,
        max_inflight: int = 8,
        aux_slots: int = 2**14,
        directory: str = "host",
        sync_cadence: str = "batch",
    ) -> None:
        if directory not in ("host", "fp"):
            raise ValueError("directory must be 'host' or 'fp'")
        if sync_cadence not in ("batch", "launch"):
            raise ValueError("sync_cadence must be 'batch' or 'launch'")
        self.sync_cadence = sync_cadence
        self.directory = directory
        self.mesh = mesh if mesh is not None else create_mesh()
        self.clock = clock or MonotonicClock()
        self.per_shard_slots = per_shard_slots
        self.max_batch = max_batch
        self.max_delay_s = max_delay_s
        self.max_inflight = max_inflight
        # The per-limiter tables (counters, semaphores) on the mesh's
        # device; its bucket tables stay unused (n_slots minimal). Sub-stores
        # never self-rebase: see _maybe_rebase_all.
        self._aux = DeviceBucketStore(
            n_slots=64, counter_slots=aux_slots, clock=self.clock,
            max_batch=max_batch, max_delay_s=max_delay_s,
            max_inflight=max_inflight, rebase_threshold_ticks=_NEVER_REBASE,
            device=self.mesh.device,
        )
        self._shards: dict[tuple[float, float], ShardedDeviceStore] = {}
        self._batchers: dict[tuple[float, float],
                             MicroBatcher[_AcquireReq, AcquireResult]] = {}
        self._windows: dict[tuple[float, int, bool], ShardedWindowStore] = {}
        self._wbatchers: dict[tuple[float, int, bool],
                              MicroBatcher[_AcquireReq, AcquireResult]] = {}
        self._registry_lock = threading.RLock()
        self._connected = False
        self._connect_gate = asyncio.Lock()
        self._sweeper_task: asyncio.Task | None = None

    @property
    def metrics(self) -> _CombinedMetrics:
        return _CombinedMetrics(self)

    # -- coordinated epoch rebase --------------------------------------------
    def _maybe_rebase_all(self) -> None:
        """ONE rebase for every table sharing the clock, stop-the-world:
        every sub-store lock is held (aux first, then the tiers by config
        key) across the table shifts AND the clock rebase, so no operation
        stamps a pre-rebase ``now`` into a shifted table. Every other path
        takes at most one sub-store lock, so this cannot deadlock."""
        if self.clock.now_ticks() < _REBASE_THRESHOLD_TICKS:
            return
        with self._registry_lock:
            now = self.clock.now_ticks()
            if now < _REBASE_THRESHOLD_TICKS:
                return
            offset = now - _REBASE_MARGIN_TICKS
            with ExitStack() as stack:
                stack.enter_context(self._aux._lock)
                for key in sorted(self._shards):
                    stack.enter_context(self._shards[key]._lock)
                for key in sorted(self._windows):
                    stack.enter_context(self._windows[key]._lock)
                self._aux.force_rebase(offset)
                for store in self._shards.values():
                    store.force_rebase(offset)
                for wstore in self._windows.values():
                    wstore.force_rebase(offset)
                self.clock.rebase(offset)

    # -- lifecycle -----------------------------------------------------------
    async def connect(self) -> None:
        if self._connected:
            return
        async with self._connect_gate:
            if self._connected:
                return
            await self._aux.connect()
            self._connected = True

    async def aclose(self) -> None:
        if self._sweeper_task is not None:
            self._sweeper_task.cancel()
            try:
                await self._sweeper_task
            except (asyncio.CancelledError, Exception):
                pass
            self._sweeper_task = None
        with self._registry_lock:
            batchers = (list(self._batchers.values())
                        + list(self._wbatchers.values()))
        for b in batchers:
            await b.aclose()
        await self._aux.aclose()

    # -- sharded token-bucket tier -------------------------------------------
    def _sharded(self, capacity: float,
                 fill_rate_per_sec: float) -> ShardedDeviceStore:
        key = (float(capacity), float(fill_rate_per_sec))
        with self._registry_lock:
            store = self._shards.get(key)
            if store is None:
                if self.directory == "fp":
                    from distributedratelimiting.redis_tpu_torch.parallel.fp_sharded import (  # noqa: E501
                        ShardedFpDeviceStore,
                    )

                    cls = ShardedFpDeviceStore
                else:
                    cls = ShardedDeviceStore
                store = cls(
                    self.mesh, capacity=capacity,
                    fill_rate_per_sec=fill_rate_per_sec,
                    per_shard_slots=self.per_shard_slots, clock=self.clock,
                    sync_cadence=self.sync_cadence,
                    rebase_threshold_ticks=_NEVER_REBASE,
                )
                self._shards[key] = store
            return store

    def _get_batcher(self, cache: dict, key, store_getter
                     ) -> MicroBatcher[_AcquireReq, AcquireResult]:
        """Per-config batcher of a sharded tier: its flush runs the tier's
        launch and readback off the event loop."""
        with self._registry_lock:
            batcher = cache.get(key)
            if batcher is None:
                store = store_getter()

                async def flush(reqs: Sequence[_AcquireReq],
                                _s=store) -> list[AcquireResult]:
                    loop = asyncio.get_running_loop()
                    return await loop.run_in_executor(
                        None, _s.acquire_batch_blocking,
                        [(r.key, r.count) for r in reqs])

                batcher = MicroBatcher(
                    flush, max_batch=self.max_batch,
                    max_delay_s=self.max_delay_s,
                    max_inflight=self.max_inflight)
                cache[key] = batcher
            return batcher

    def _batcher(self, capacity: float, fill_rate_per_sec: float
                 ) -> MicroBatcher[_AcquireReq, AcquireResult]:
        key = (float(capacity), float(fill_rate_per_sec))
        return self._get_batcher(
            self._batchers, key,
            lambda: self._sharded(capacity, fill_rate_per_sec))

    async def acquire(self, key: str, count: int, capacity: float,
                      fill_rate_per_sec: float) -> AcquireResult:
        await self.connect()
        self._maybe_rebase_all()
        return await self._batcher(capacity, fill_rate_per_sec).submit(
            _AcquireReq(key, count))

    def acquire_blocking(self, key: str, count: int, capacity: float,
                         fill_rate_per_sec: float) -> AcquireResult:
        self._maybe_rebase_all()
        return self._sharded(capacity, fill_rate_per_sec
                             ).acquire_batch_blocking([(key, count)])[0]

    # -- sharded window tier -------------------------------------------------
    def _sharded_window(self, limit: float, window_sec: float,
                        fixed: bool) -> ShardedWindowStore:
        key = (float(limit), int(window_sec * bm.TICKS_PER_SECOND), fixed)
        with self._registry_lock:
            store = self._windows.get(key)
            if store is None:
                if self.directory == "fp":
                    from distributedratelimiting.redis_tpu_torch.parallel.fp_sharded import (  # noqa: E501
                        ShardedFpWindowStore,
                    )

                    wcls = ShardedFpWindowStore
                else:
                    wcls = ShardedWindowStore
                store = wcls(
                    self.mesh, limit=limit, window_sec=window_sec,
                    fixed=fixed, per_shard_slots=self.per_shard_slots,
                    clock=self.clock,
                    rebase_threshold_ticks=_NEVER_REBASE,
                )
                self._windows[key] = store
            return store

    def _wbatcher(self, limit: float, window_sec: float, fixed: bool
                  ) -> MicroBatcher[_AcquireReq, AcquireResult]:
        key = (float(limit), int(window_sec * bm.TICKS_PER_SECOND), fixed)
        return self._get_batcher(
            self._wbatchers, key,
            lambda: self._sharded_window(limit, window_sec, fixed))

    async def acquire_many(self, keys, counts, capacity: float,
                           fill_rate_per_sec: float, *,
                           with_remaining: bool = True):
        """Bulk path over the mesh: the whole array rides the scanned
        two-level step, off the event loop (what a server fronting the mesh
        serves ``OP_ACQUIRE_MANY`` with)."""
        await self.connect()
        self._maybe_rebase_all()
        store = self._sharded(capacity, fill_rate_per_sec)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: store.acquire_many_blocking(
                keys, counts, with_remaining=with_remaining))

    def acquire_many_blocking(self, keys, counts, capacity: float,
                              fill_rate_per_sec: float, *,
                              with_remaining: bool = True):
        self._maybe_rebase_all()
        return self._sharded(capacity, fill_rate_per_sec).acquire_many_blocking(
            keys, counts, with_remaining=with_remaining)

    def peek_blocking(self, key: str, capacity: float,
                      fill_rate_per_sec: float) -> float:
        # Read-only: never allocates a slot or writes device state.
        self._maybe_rebase_all()
        return self._sharded(capacity, fill_rate_per_sec).peek_blocking(key)

    # -- delegated small tables ----------------------------------------------
    # Every delegated path checks the coordinated rebase too: an aux-only
    # workload must not run into int32 tick overflow.
    async def sync_counter(self, key, local_count, decay_rate_per_sec):
        self._maybe_rebase_all()
        return await self._aux.sync_counter(key, local_count,
                                            decay_rate_per_sec)

    def sync_counter_blocking(self, key, local_count, decay_rate_per_sec):
        self._maybe_rebase_all()
        return self._aux.sync_counter_blocking(key, local_count,
                                               decay_rate_per_sec)

    # -- key-sharded windows (BASELINE config 4 at mesh scale) ----------------
    async def window_acquire(self, key, count, limit, window_sec):
        await self.connect()
        self._maybe_rebase_all()
        return await self._wbatcher(limit, window_sec, False).submit(
            _AcquireReq(key, count))

    def window_acquire_blocking(self, key, count, limit, window_sec):
        self._maybe_rebase_all()
        return self._sharded_window(limit, window_sec, False
                                    ).acquire_batch_blocking([(key, count)])[0]

    async def fixed_window_acquire(self, key, count, limit, window_sec):
        await self.connect()
        self._maybe_rebase_all()
        return await self._wbatcher(limit, window_sec, True).submit(
            _AcquireReq(key, count))

    def fixed_window_acquire_blocking(self, key, count, limit, window_sec):
        self._maybe_rebase_all()
        return self._sharded_window(limit, window_sec, True
                                    ).acquire_batch_blocking([(key, count)])[0]

    async def window_acquire_many(self, keys, counts, limit, window_sec, *,
                                  fixed: bool = False,
                                  with_remaining: bool = True):
        await self.connect()
        self._maybe_rebase_all()
        store = self._sharded_window(limit, window_sec, fixed)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: store.acquire_many_blocking(
                keys, counts, with_remaining=with_remaining))

    def window_acquire_many_blocking(self, keys, counts, limit, window_sec,
                                     *, fixed: bool = False,
                                     with_remaining: bool = True):
        self._maybe_rebase_all()
        return self._sharded_window(limit, window_sec, fixed
                                    ).acquire_many_blocking(
            keys, counts, with_remaining=with_remaining)

    async def concurrency_acquire(self, key, count, limit):
        self._maybe_rebase_all()
        return await self._aux.concurrency_acquire(key, count, limit)

    def concurrency_acquire_blocking(self, key, count, limit):
        self._maybe_rebase_all()
        return self._aux.concurrency_acquire_blocking(key, count, limit)

    async def concurrency_release(self, key, count):
        self._maybe_rebase_all()
        await self._aux.concurrency_release(key, count)

    def concurrency_release_blocking(self, key, count):
        self._maybe_rebase_all()
        self._aux.concurrency_release_blocking(key, count)

    # -- TTL maintenance -----------------------------------------------------
    def sweep_all(self) -> None:
        """Active TTL expiry across every tier (the server's
        ``--sweep-period`` hooks this)."""
        self._aux.sweep_all()
        with self._registry_lock:
            stores = (list(self._shards.values())
                      + list(self._windows.values()))
        for store in stores:
            store.sweep()

    def start_sweeper(self, period_s: float = 30.0) -> None:
        if self._sweeper_task is not None and not self._sweeper_task.done():
            return
        self._sweeper_task = start_periodic_sweeper(self.sweep_all, period_s)

    # -- checkpoint ----------------------------------------------------------
    def snapshot(self) -> dict:
        # No mesh-level now_ticks: each sub-snapshot carries and re-aligns
        # its own epoch (they all read the one clock).
        with self._registry_lock:
            return {
                "aux": self._aux.snapshot(),
                "shards": {key: store.snapshot()
                           for key, store in self._shards.items()},
                "windows": {key: store.snapshot()
                            for key, store in self._windows.items()},
            }

    def restore(self, snap: dict) -> None:
        self._aux.restore(snap["aux"])
        self._migrate_legacy_aux_windows()
        for (cap, rate), sub in snap["shards"].items():
            self._sharded(cap, rate).restore(sub)
        for (limit, wticks, fixed), sub in snap.get("windows", {}).items():
            self._sharded_window(limit, wticks / bm.TICKS_PER_SECOND,
                                 fixed).restore(sub)

    def _migrate_legacy_aux_windows(self) -> None:
        """A snapshot from before window serving moved to the sharded tier
        holds window tables inside the aux store: move each restored aux
        window row into the sharded tier (the aux restore already
        re-aligned its indices) and drop the aux table, so no window key
        resets to a fresh limit after a restart."""
        if self._aux._wtables and self.directory == "fp":
            # The migration scatters into host-directory slots; the fp tier
            # has none. Refuse BEFORE touching the aux tables.
            raise ValueError(
                "legacy snapshot holds aux-tier window tables; restore it "
                "into a directory='host' mesh store (its windows then "
                "re-checkpoint in the sharded form)")
        for key3 in list(self._aux._wtables):
            limit, wticks, fixed = key3
            table = self._aux._wtables.pop(key3)
            mapping = table.dir.to_dict()  # key → aux slot
            if not mapping:
                continue
            ws = self._sharded_window(limit, wticks / bm.TICKS_PER_SECOND,
                                      fixed)
            keys = list(mapping)
            aux_slots = torch.from_numpy(np.fromiter(
                (mapping[k] for k in keys), np.int64, len(keys)))
            with ws._lock:
                shards, locs = ws._resolve_batch(keys)  # grows as needed
                flat = torch.from_numpy(
                    shards.astype(np.int64) * ws.per_shard + locs)
                dev = ws.mesh.device
                for dst, src in zip(ws.state, table.state):
                    dst[flat.to(dev)] = src[aux_slots.to(src.device)].to(dev)
