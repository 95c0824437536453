"""Key-sharded bucket and window tables over a mesh, and the global tier.

The JAX package's ``parallel/sharded_store.py`` on PyTorch. The ``(key →
{tokens, last_ts})`` table is sharded along the key axis of a
:class:`~.mesh.Mesh`; key → shard routing is crc32 on the host
(:func:`route_keys`, one native call a batch); each shard decides its own
keys, and the only cross-shard computation is the approximate algorithm's
global tier: the consumed counts of every shard, summed, decay and add into
one replicated :class:`GlobalCounter`.

On one device (every mesh the port takes, :mod:`.mesh`) the shards' state
is one table, shard-major: slot = ``shard * per_shard + local``, exactly
JAX's ``n_shards * per_shard_slots`` arrays. A step's ``[n_shards, K, B]``
batch keeps JAX's indices (shard s, batch k, row j) and runs as ONE
decision launch of K batches of ``n_shards * B`` rows: batch k holds every
shard's row block k, shard s at rows ``[s * B, (s + 1) * B)``. Keys never
meet across shards, so one launch over every shard's rows decides as JAX's
per-shard programs do. The bucket steps launch ``drl_acquire_scan`` with
the ``i32[2, K, S·B]`` operand (slots, -1 for padding and invalid rows;
counts); ``handle_duplicates=False`` runs the wide scan one batch at a time
(``cuda_kernels.acquire_batch``) as JAX's option does; the window step
launches ``window_scan``. Then the global tier is one launch
(``cuda_kernels.global_tier``, ``csrc/mesh.cu``): per batch the consumed
total ``sum(count * grant)``, folded once a batch (``sync_cadence="batch"``)
or once a launch (``"launch"``). On the CPU the kernels' plain versions
decide (:mod:`..ops.kernels`).

The stores (:class:`ShardedDeviceStore`, :class:`ShardedWindowStore`) keep
JAX's host runtime: one native key directory a shard, one fused C call to
route and resolve a batch, ``[n_shards, K, B]`` chunks, sweeps with
cross-shard pinning, all-shard doubling. One rule of the card shapes the
chunks: a decision batch holds at most ``SCAN_MAX_BATCH`` (8,192) rows and
a launch ``SCAN_MAX_ROWS``, so a bulk chunk's per-shard width is at most
``8,192 / n_shards`` rows (1,024 at 8 shards; JAX's 2,048) and its depth at
most ``SCAN_MAX_ROWS / (n_shards * B)`` batches (16 there; JAX's 32), on
the CPU too. A key's requests that span a batch boundary are decided in
order rather than with the in-batch conservative prefix, so a call with
more than 1,024 rows of one shard may grant a repeated key's later request
where JAX's wider batch denies it (never the reverse).
"""

from __future__ import annotations

import ctypes
import threading
import zlib
from typing import Sequence

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.ops.kernels import (
    GlobalCounter,
    global_tier_update,
    init_global_counter,
)
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    Clock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.directory import (
    NativeKeyDirectory,
    make_directory,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BulkAcquireResult,
    _pad_size,
    _REBASE_MARGIN_TICKS,
    _REBASE_THRESHOLD_TICKS,
    _shift_ts,
    _to_host,
)
from distributedratelimiting.redis_tpu_torch.utils.metrics import StoreMetrics
from distributedratelimiting.redis_tpu_torch.utils.native import (
    load_directory_lib,
)

__all__ = [
    "GlobalCounter",
    "global_tier_update",
    "init_global_counter",
    "make_sharded_acquire_step",
    "make_two_level_step",
    "make_two_level_scan_step",
    "make_two_level_scan_step_deferred",
    "make_sharded_window_scan_step",
    "ShardedDeviceStore",
    "ShardedWindowStore",
    "shard_of_key",
    "route_keys",
]


def shard_of_key(key: str, n_shards: int) -> int:
    """Stable key → shard routing (host side): crc32, so every client
    process routes identically and the directory needs no coordination."""
    return zlib.crc32(key.encode("utf-8", "surrogateescape")) % n_shards


def route_keys(keys: "Sequence[str] | list[str]", n_shards: int) -> np.ndarray:
    """Vectorised :func:`shard_of_key` over a batch: one native call over a
    ``wire.KeyBlob``'s bytes (``dir_route_batch``) or a ``list[str]``
    (``dir_route_pylist``); a Python crc32 loop only for a list the C call
    cannot take (a non-``str`` element) or where the directory library is
    not loaded. All agree bit for bit with ``zlib.crc32(key) % n_shards``."""
    n = len(keys)
    lib = load_directory_lib()
    blob = getattr(keys, "blob", None)
    if lib is not None and blob is not None:
        out = np.empty(n, np.int32)
        lib.dir_route_batch(
            blob, keys.offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, n_shards, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    if lib is not None and lib.has_pylist:
        if not isinstance(keys, list):
            keys = list(keys)
        out = np.empty(n, np.int32)
        if lib.dir_route_pylist(
                keys, n_shards,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))) == 0:
            return out
    return np.fromiter(
        (zlib.crc32(k.encode("utf-8", "surrogateescape")) % n_shards
         for k in keys), np.int32, n)


# -- the step builders ---------------------------------------------------------
def _tensor(x, dev) -> torch.Tensor:
    """An operand (tensor or array-like) as a tensor on ``dev``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.to(dev)


def _with_k(x):
    """A ``[S, B]`` operand as a ``[S, 1, B]`` one (a step of one batch)."""
    return x[:, None] if isinstance(x, torch.Tensor) else np.asarray(x)[:, None]


def _global_slots(slots, valid, per_shard: int) -> torch.Tensor:
    """Shard-local slots ``[S, ...]`` → flat slots of the shard-major
    table; -1 where the row is invalid or its slot lies outside the shard
    (JAX's out-of-range padding)."""
    s_idx = torch.arange(slots.shape[0], device=slots.device).view(
        -1, *([1] * (slots.dim() - 1)))
    ok = valid.to(torch.bool) & (slots >= 0) & (slots < per_shard)
    return torch.where(ok, s_idx * per_shard + slots, -1).to(torch.int32)


def _rows(x: torch.Tensor) -> torch.Tensor:
    """``[S, K, B]`` → ``[K, S·B]``: batch k of every shard, shard-major."""
    s, k, b = x.shape
    return x.permute(1, 0, 2).reshape(k, s * b).contiguous()


def _unrows(y: torch.Tensor, n_shards: int) -> torch.Tensor:
    """``[K, S·B]`` → ``[S, K, B]``."""
    k, r = y.shape
    return y.reshape(k, n_shards, r // n_shards).permute(1, 0, 2)


def _decide_buckets(state: K.BucketState, op: torch.Tensor,
                    nows: np.ndarray, nows_t: torch.Tensor, capacity: float,
                    rate: float, handle_duplicates: bool) -> torch.Tensor:
    """One decision over ``op i32[2, K, R]`` (flat slots, -1 padding;
    counts), batch k at tick ``nows[k]`` (``nows_t`` the same ticks on the
    table's device): ``out f32[K, 2, R]``. With the duplicate
    serialization one scan launch; without, the wide scan once a batch
    (every row prefix 0, as JAX's ``handle_duplicates=False``)."""
    if handle_duplicates:
        return ck.acquire_scan_packed(state, op, nows_t, capacity, rate)
    return torch.stack([
        ck.acquire_batch(state, op[0, k].contiguous(), op[1, k].contiguous(),
                         op[0, k] >= 0, int(nows[k]), capacity, rate,
                         handle_duplicates=False)
        for k in range(op.shape[1])])


def _step_operand(slots, counts, valid, per_shard: int, dev) -> torch.Tensor:
    """``[S, K, B]`` shard-local batch → the decision's ``i32[2, K, S·B]``."""
    slots = _tensor(slots, dev).to(torch.int32)
    counts = _tensor(counts, dev).to(torch.int32)
    gl = _global_slots(slots, _tensor(valid, dev), per_shard)
    return torch.stack([_rows(gl), _rows(counts)]).contiguous()


def _nows_np(nows) -> np.ndarray:
    if isinstance(nows, torch.Tensor):
        nows = nows.cpu().numpy()
    return np.atleast_1d(np.asarray(nows, np.int32))


def _scan_step(mesh: Mesh, handle_duplicates: bool, cadence):
    """The K-batch bucket step; ``cadence`` None (no global tier),
    ``"batch"`` or ``"launch"``."""
    n_shards = mesh.n_shards

    def step(state, slots, counts, valid, nows, capacity, rate,
             gcounter=None, decay_rate=None):
        dev = state.tokens.device
        per = state.tokens.shape[0] // n_shards
        op = _step_operand(slots, counts, valid, per, dev)
        nows_np = _nows_np(nows)
        nows_t = torch.from_numpy(nows_np).to(dev)
        out = _decide_buckets(state, op, nows_np, nows_t, float(capacity),
                              float(rate), handle_duplicates)
        if cadence is not None:
            ck.global_tier(out, op[1], nows_t, gcounter, float(decay_rate),
                           cadence)
        granted = _unrows(out[:, 0] > 0.5, n_shards)
        remaining = _unrows(out[:, 1], n_shards)
        return state, granted, remaining

    return step


def make_sharded_acquire_step(mesh: Mesh, *, handle_duplicates: bool = True):
    """The sharded acquire (JAX ``sharded_store.py:150``): ``step(state,
    slots [S, B], counts [S, B], valid [S, B], now, capacity, rate) ->
    (state, granted [S, B], remaining [S, B])``, shard-LOCAL slots, the
    state updated in place. One decision launch of ``S·B`` rows; no global
    tier."""
    inner = _scan_step(mesh, handle_duplicates, None)

    def step(state, slots, counts, valid, now, capacity, rate):
        state, g, r = inner(state, _with_k(slots), _with_k(counts),
                            _with_k(valid), [int(now)], capacity, rate)
        return state, g[:, 0], r[:, 0]

    return step


def make_two_level_step(mesh: Mesh, *, handle_duplicates: bool = True):
    """The flagship two-level step (JAX ``:174``): the sharded acquire,
    then the global tier over its consumed total. ``step(state, slots,
    counts, valid, now, capacity, rate, gcounter, decay_rate) -> (state,
    granted, remaining, gcounter)``; state and counter updated in place."""
    inner = _scan_step(mesh, handle_duplicates, "batch")

    def step(state, slots, counts, valid, now, capacity, rate, gcounter,
             decay_rate):
        state, g, r = inner(state, _with_k(slots), _with_k(counts),
                            _with_k(valid), [int(now)], capacity, rate,
                            gcounter, decay_rate)
        return state, g[:, 0], r[:, 0], gcounter

    return step


def _two_level_scan(mesh: Mesh, handle_duplicates: bool, cadence: str):
    inner = _scan_step(mesh, handle_duplicates, cadence)

    def step(state, slots, counts, valid, nows, capacity, rate, gcounter,
             decay_rate):
        state, g, r = inner(state, slots, counts, valid, nows, capacity,
                            rate, gcounter, decay_rate)
        return state, g, r, gcounter

    return step


def make_two_level_scan_step(mesh: Mesh, *, handle_duplicates: bool = True):
    """K scanned batches (JAX ``:214``): ``slots/counts/valid [S, K, B]``,
    ``nows i32[K]``; one global-tier recurrence a batch, in order. Returns
    ``(state, granted [S, K, B], remaining, gcounter)``."""
    return _two_level_scan(mesh, handle_duplicates, "batch")


def make_two_level_scan_step_deferred(mesh: Mesh, *,
                                      handle_duplicates: bool = True):
    """:func:`make_two_level_scan_step` with ONE global-tier recurrence a
    launch, at the last batch's tick over the launch's total (JAX
    ``:263``, the per-launch sync cadence). Grants are identical; the
    counter decays in one step instead of K."""
    return _two_level_scan(mesh, handle_duplicates, "launch")


def make_sharded_window_scan_step(mesh: Mesh, *, interpolate: bool = True,
                                  handle_duplicates: bool = True):
    """The scanned key-sharded window step (JAX ``:886``), no global tier:
    ``step(state, slots, counts, valid [S, K, B], nows i32[K], limit,
    window_ticks) -> (state, granted, remaining)``. ``interpolate=False``
    is the fixed window. One ``window_scan`` launch of K batches of
    ``S·B`` rows; the port's window scan always serializes duplicates, so
    ``handle_duplicates=False`` is not ported and raises."""
    if not handle_duplicates:
        raise NotImplementedError(
            "make_sharded_window_scan_step(handle_duplicates=False) is not "
            "ported: the window scan kernel always serializes duplicates")
    n_shards = mesh.n_shards

    def step(state, slots, counts, valid, nows, limit, window_ticks):
        dev = state.prev_count.device
        per = state.prev_count.shape[0] // n_shards
        op = _step_operand(slots, counts, valid, per, dev)
        nows_t = torch.from_numpy(_nows_np(nows)).to(dev)
        out = ck.window_scan_packed(state, op, nows_t, float(limit),
                                    int(window_ticks),
                                    interpolate=interpolate)
        return (state, _unrows(out[:, 0] > 0.5, n_shards),
                _unrows(out[:, 1], n_shards))

    return step


# -- the stores ----------------------------------------------------------------
def _pow2_floor(n: int) -> int:
    p = 1
    while p * 2 <= n:
        p *= 2
    return p


class _ShardedKeyedTable:
    """Shared host runtime for key-sharded tables (buckets and windows):
    one native key directory a shard, one fused routing-and-resolve C call
    a batch, sweep/grow reclaim with cross-shard pinning, all-shard
    doubling. Subclasses provide ``_device_sweep()`` and ``force_rebase``;
    their bulk calls hand :meth:`_bulk_decide` the chunk's launch.

    Requires attributes: ``mesh``, ``n_shards``, ``per_shard``, ``dirs``,
    ``_lock``, ``metrics``, ``clock``, ``state``, ``_rebase_threshold``."""

    #: JAX's bulk geometry: at most 32 scanned batches a launch, 2,048 rows
    #: a shard a batch; both are cut to the card's decision limits
    #: (:meth:`_chunk_geometry`).
    _BULK_MAX_K = 32
    _BULK_B = 2048

    def _device_sweep(self) -> np.ndarray:
        raise NotImplementedError

    def force_rebase(self, offset: int) -> None:
        """Shift the table's stored time state by ``-offset`` ticks WITHOUT
        touching the clock (the composing store's coordinated rebase)."""
        raise NotImplementedError

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.mesh.device)

    def now_ticks_checked(self) -> int:
        """Store clock read with int32-overflow protection: rebase the
        table and the clock together before tick time can overflow
        (composing stores disable this via ``rebase_threshold_ticks`` and
        coordinate one rebase across every table sharing the clock)."""
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

    def _chunk_geometry(self, max_rows: int) -> tuple[int, int]:
        """A bulk chunk's per-shard batch width B and its largest depth K:
        JAX's (``min(max_rows, _BULK_B)`` padded; ``_BULK_MAX_K``), within
        the card's decision limits (``n_shards * B <= SCAN_MAX_BATCH``, ``K
        * n_shards * B <= SCAN_MAX_ROWS``)."""
        cap = max(8, _pow2_floor(ck.SCAN_MAX_BATCH // self.n_shards))
        b = _pad_size(min(max_rows, self._BULK_B, cap), floor=8)
        max_k = min(self._BULK_MAX_K,
                    max(1, _pow2_floor(ck.SCAN_MAX_ROWS
                                       // (self.n_shards * b))))
        return b, max_k

    def _bulk_decide(self, keys: Sequence[str], counts: Sequence[int],
                     with_remaining: bool, launch_chunk) -> BulkAcquireResult:
        """The whole-array bulk path: resolve, ``[n_shards, K, B]`` chunks
        (batch k, shard s, row j at the decision's row ``s * B + j`` of
        batch k), one ``launch_chunk(op i32[2, K, S·B], nows i32[K]) -> out
        f32[K, 2, S·B]`` a chunk and its readback, and the zero-permit
        probe override."""
        n = len(keys)
        counts_np = np.asarray(counts, np.int64)
        granted_out = np.empty(n, bool)
        rem_out = np.empty(n, np.float32) if with_remaining else None
        if n == 0:
            return BulkAcquireResult(granted_out, rem_out)
        s_n = self.n_shards
        with self._lock:
            shards, locs = self._resolve_batch(keys)  # KeyBlob-aware
            flat = shards.astype(np.int64) * self.per_shard + locs
            jpos, shard_counts = self._group_by_shard(shards)
            max_rows = int(shard_counts.max(initial=1))
            b, max_k = self._chunk_geometry(max_rows)
            clipped = np.minimum(counts_np, 2**31 - 1)
            pos = 0
            while pos < max_rows:
                rows = -(-(max_rows - pos) // b)  # ceil
                k = 1
                while k < rows and k < max_k:
                    k *= 2
                take_rows = k * b
                sel = (jpos >= pos) & (jpos < pos + take_rows)
                rel = jpos[sel] - pos
                at = (rel // b, shards[sel], rel % b)
                op = np.zeros((2, k, s_n, b), np.int32)
                op[0] = -1
                op[0][at] = flat[sel]
                op[1][at] = clipped[sel]
                nows = np.full((k,), self.now_ticks_checked(), np.int32)
                out = _to_host(launch_chunk(
                    op.reshape(2, k, s_n * b), nows)).reshape(k, 2, s_n, b)
                granted_out[sel] = out[:, 0][at] > 0.5
                if rem_out is not None:
                    rem_out[sel] = out[:, 1][at]
                self.metrics.record_launch(s_n * take_rows, int(sel.sum()))
                pos += take_rows
        if (counts_np == 0).any():
            # Zero-permit probes are granted unconditionally, as on every
            # single-request path.
            granted_out[counts_np == 0] = True
        return BulkAcquireResult(granted_out, rem_out)

    @property
    def directory(self) -> dict[str, tuple[int, int]]:
        """Merged ``key → (shard, local slot)`` view (diagnostics and
        tests; the serving path never builds it)."""
        return {key: (shard, local)
                for shard, d in enumerate(self.dirs)
                for key, local in d.to_dict().items()}

    def _resolve_batch(self, keys) -> tuple[np.ndarray, np.ndarray]:
        """Key → (shard, local) for a whole batch: the fused native call
        when every directory is native, else one routing call and one
        resolve a touched shard. On free-list exhaustion: sweep (pinning
        this batch's resolved slots), grow every shard when the sweep
        freed too little, re-resolve."""
        fused = self._resolve_batch_fused(keys)
        if fused is not None:
            return fused
        if not isinstance(keys, list):
            keys = list(keys)
        shards = route_keys(keys, self.n_shards)
        locs = np.empty(len(keys), np.int32)
        keys_arr = np.asarray(keys, dtype=object)
        # (shard, locals) already resolved for THIS batch: a sweep that a
        # later shard's exhaustion triggers must not reclaim them.
        done: list[tuple[int, np.ndarray]] = []
        order = np.argsort(shards, kind="stable")
        sorted_keys = keys_arr[order]
        sorted_shards = shards[order]
        bounds = np.searchsorted(sorted_shards, np.arange(self.n_shards + 1))
        for shard in range(self.n_shards):
            lo, hi = int(bounds[shard]), int(bounds[shard + 1])
            if lo == hi:
                continue
            idx = order[lo:hi]
            sub = sorted_keys[lo:hi].tolist()
            d = self.dirs[shard]
            slots = d.resolve_batch(sub)
            while (slots < 0).any():
                pinned = {int(sh) * self.per_shard + int(loc)
                          for sh, arr in done for loc in arr}
                pinned.update(int(shard) * self.per_shard + int(s)
                              for s in slots[slots >= 0])
                self._sweep_locked(pinned)
                if d.free_count * 16 <= self.per_shard:
                    # Sweep-first hysteresis: grow rather than re-sweep on
                    # every batch of a near-full table.
                    self._grow()
                slots = d.resolve_batch(sub)
            locs[idx] = slots
            done.append((int(shard), slots))
        return shards, locs

    def _resolve_batch_fused(self, keys):
        """One C call routes AND resolves the whole batch (crc32 → shard →
        that shard's directory, allocating on miss), over a
        ``wire.KeyBlob`` or a ``list[str]``. ``None`` sends the caller to
        the split path (a Python directory, or a non-``str`` key)."""
        fused_ok = getattr(self, "_fused_ok", None)
        if fused_ok is None:
            fused_ok = self._fused_ok = bool(
                load_directory_lib() is not None
                and all(isinstance(d, NativeKeyDirectory)
                        for d in self.dirs))
        if not fused_ok:
            return None
        lib = load_directory_lib()
        blob = getattr(keys, "blob", None)
        if blob is None:
            if not lib.has_pylist:
                return None
            if not isinstance(keys, list):
                keys = list(keys)
        n = len(keys)
        shards = np.empty(n, np.int32)
        locs = np.empty(n, np.int32)
        sh_ptr = shards.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        lo_ptr = locs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def call() -> int:
            # Handles re-read per call: restore's directory load swaps them.
            handles = (ctypes.c_void_p * self.n_shards)(
                *(d._h for d in self.dirs))
            if blob is not None:
                return int(lib.dir_resolve_sharded_batch(
                    blob, keys.offsets.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int64)),
                    n, handles, self.n_shards, sh_ptr, lo_ptr))
            return int(lib.dir_resolve_sharded_pylist(
                keys, handles, self.n_shards, sh_ptr, lo_ptr))

        unresolved = call()
        if unresolved < 0:  # a non-str key: the split path raises for it
            return None
        while unresolved > 0:
            ok = locs >= 0
            pinned = set((shards[ok].astype(np.int64) * self.per_shard
                          + locs[ok]).tolist())
            self._sweep_locked(pinned)
            dry = np.unique(shards[~ok])
            if any(self.dirs[s].free_count * 16 <= self.per_shard
                   for s in dry):
                self._grow()
            unresolved = call()  # resolved keys are idempotent lookups
        return shards, locs

    def _grow(self) -> None:
        """Double every shard's slot capacity: the shard-major table is
        re-laid as ``[n_shards, per_shard]`` blocks padded to twice the
        width, on the device."""
        old, new = self.per_shard, self.per_shard * 2
        s_n = self.n_shards
        grown = []
        for t in self.state:
            out = t.new_zeros((s_n * new,))
            out.view(s_n, new)[:, :old] = t.view(s_n, old)
            grown.append(out)
        self.state = type(self.state)(*grown)
        for d in self.dirs:
            d.add_slots(old, new)
        self.per_shard = new
        self.metrics.pregrows += 1

    def _group_by_shard(self, shards: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Each request's row within its shard's queue (stable in request
        order: a key's duplicates keep arrival order) and the per-shard
        load."""
        n = len(shards)
        shard_counts = np.bincount(shards, minlength=self.n_shards)
        starts = np.zeros(self.n_shards + 1, np.int64)
        np.cumsum(shard_counts, out=starts[1:])
        order = np.argsort(shards, kind="stable")
        jpos = np.empty(n, np.int64)
        jpos[order] = np.arange(n) - starts[shards[order]]
        return jpos, shard_counts

    def sweep(self) -> int:
        """TTL eviction across every shard: one sweep launch over the
        device's whole table."""
        with self._lock:
            return self._sweep_locked(None)

    def _sweep_locked(self, pinned: set[int] | None) -> int:
        """``pinned`` flat slots (resolved for an in-flight batch) are not
        returned to their directories."""
        freed_np = self._device_sweep()
        n_freed = 0
        if freed_np is not None and freed_np.any():
            dead = np.nonzero(freed_np)[0].astype(np.int64)
            if pinned:
                dead = dead[~np.isin(dead, np.fromiter(pinned, np.int64,
                                                       len(pinned)))]
            dead_shards = dead // self.per_shard
            dead_locals = (dead % self.per_shard).astype(np.int32)
            for shard in np.unique(dead_shards):
                n_freed += self.dirs[shard].remove_slots(
                    dead_locals[dead_shards == shard])
        self.metrics.sweeps += 1
        self.metrics.slots_evicted += n_freed
        return n_freed

    @staticmethod
    def _freed(mask: torch.Tensor, tile_counts: torch.Tensor):
        """A sweep's host mask, or ``None`` when its tile counts say it
        freed nothing (T ints read instead of the N-byte mask)."""
        if int(_to_host(tile_counts).sum()) == 0:
            return None
        return _to_host(mask).astype(bool)


class ShardedDeviceStore(_ShardedKeyedTable):
    """Host runtime for one key-sharded, homogeneous-config bucket table
    (JAX ``sharded_store.py:627``): per-shard directories, requests grouped
    by shard and decided in one launch with the global tier after it."""

    def __init__(self, mesh: Mesh, capacity: float, fill_rate_per_sec: float,
                 *, per_shard_slots: int = 2**14,
                 clock: Clock | None = None,
                 handle_duplicates: bool = True,
                 sync_cadence: str = "batch",
                 rebase_threshold_ticks: int = _REBASE_THRESHOLD_TICKS) -> None:
        if sync_cadence not in ("batch", "launch"):
            raise ValueError("sync_cadence must be 'batch' or 'launch'")
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.per_shard = per_shard_slots
        self.capacity = float(capacity)
        self.fill_rate_per_sec = float(fill_rate_per_sec)
        self.rate_per_tick = fill_rate_per_sec / bm.TICKS_PER_SECOND
        self.clock = clock or MonotonicClock()
        self.metrics = StoreMetrics()
        self._rebase_threshold = rebase_threshold_ticks
        self.handle_duplicates = handle_duplicates
        dev = mesh.device
        self.state = K.init_bucket_state(self.n_shards * per_shard_slots, dev)
        self.gcounter = init_global_counter(dev)
        # The global tier's cadence: "batch" = one recurrence a scanned
        # batch (staleness <= one batch); "launch" = one a launch over its
        # total (staleness <= one launch's span). Grants are identical.
        self.sync_cadence = sync_cadence
        self.dirs = [make_directory(per_shard_slots)
                     for _ in range(self.n_shards)]
        self._lock = threading.RLock()

    # -- table hooks ---------------------------------------------------------
    def _device_sweep(self):
        now = self.now_ticks_checked()
        return self._freed(*ck.sweep_expired(self.state, now, self.capacity,
                                             self.rate_per_tick))

    def force_rebase(self, offset: int) -> None:
        """Shift the table's and the global counter's timestamps without
        touching the clock."""
        with self._lock:
            K.rebase_bucket_epoch(self.state, offset)
            g = self.gcounter
            g.last_ts.copy_(torch.clamp_min(g.last_ts - int(offset), 0))

    def _decay(self, decay_rate_per_sec: float | None) -> float:
        return (decay_rate_per_sec if decay_rate_per_sec is not None
                else self.fill_rate_per_sec) / bm.TICKS_PER_SECOND

    def _launch_chunk(self, op_np: np.ndarray, nows: np.ndarray,
                      decay: float, cadence: str | None = None
                      ) -> torch.Tensor:
        """One decision launch and the global tier after it (at the
        store's cadence unless ``cadence`` is given)."""
        op, nows_t = self._upload(op_np), self._upload(nows)
        out = _decide_buckets(self.state, op, nows, nows_t, self.capacity,
                              self.rate_per_tick, self.handle_duplicates)
        ck.global_tier(out, op[1], nows_t, self.gcounter, decay,
                       cadence or self.sync_cadence)
        return out

    def peek_blocking(self, key: str) -> float:
        """Read-only availability: never allocates a slot or writes state.
        One indexed read of the slot's three columns, one readback; the
        refill runs on the host (JAX ``:725``)."""
        with self._lock:
            shard = shard_of_key(key, self.n_shards)
            local = self.dirs[shard].lookup(key)
            if local is None:
                return float(np.floor(self.capacity))
            idx = shard * self.per_shard + local
            now = self.now_ticks_checked()
            st = self.state
            out = _to_host(torch.stack([
                st.tokens[idx:idx + 1],
                st.last_ts[idx:idx + 1].view(torch.float32),
                st.exists[idx:idx + 1].to(torch.float32)]))[:, 0]
        tokens = float(out[0])
        ts = int(np.float32(out[1]).view(np.int32))
        if not bool(out[2]):
            return float(np.floor(self.capacity))
        refilled = min(self.capacity,
                       tokens + max(0, now - ts) * self.rate_per_tick)
        return float(np.floor(refilled))

    # -- decisions -----------------------------------------------------------
    def acquire_batch_blocking(
        self, requests: Sequence[tuple[str, int]],
        decay_rate_per_sec: float | None = None,
    ) -> list[AcquireResult]:
        """Decide a batch of ``(key, count)`` requests as ONE batch (JAX's
        two-level step, one global-tier recurrence): one decision launch
        and the tier's. Results in request order. The rows go in request
        order, not in JAX's ``[n_shards, B]`` padding (keys never meet
        across shards, so the grants are the same); a batch holds at most
        ``SCAN_MAX_BATCH`` rows, and more are decided as consecutive
        batches."""
        decay = self._decay(decay_rate_per_sec)
        with self._lock:
            return self._acquire_locked(requests, decay)

    def _acquire_locked(self, requests, decay) -> list[AcquireResult]:
        n = len(requests)
        keys = [k for k, _ in requests]
        counts = np.fromiter((c for _, c in requests), np.int64, n)
        shards, locs = self._resolve_batch(keys)
        flat = shards.astype(np.int64) * self.per_shard + locs
        g_np = np.empty(n, bool)
        r_np = np.empty(n, np.float32)
        for lo in range(0, max(n, 1), ck.SCAN_MAX_BATCH):
            m = min(n - lo, ck.SCAN_MAX_BATCH)
            b = _pad_size(m, floor=8)
            op = np.zeros((2, 1, b), np.int32)
            op[0] = -1
            op[0, 0, :m] = flat[lo:lo + m]
            op[1, 0, :m] = np.minimum(counts[lo:lo + m], 2**31 - 1)
            now = self.now_ticks_checked()
            out = _to_host(self._launch_chunk(
                op, np.array([now], np.int32), decay, "batch"))
            g_np[lo:lo + m] = out[0, 0, :m] > 0.5
            r_np[lo:lo + m] = out[0, 1, :m]
            self.metrics.record_launch(b, m)
        return [AcquireResult(bool(g), float(r)) for g, r in zip(g_np, r_np)]

    def acquire_many_blocking(
        self, keys: Sequence[str], counts: Sequence[int], *,
        with_remaining: bool = True,
        decay_rate_per_sec: float | None = None,
    ) -> BulkAcquireResult:
        """Whole-array bulk acquire over the mesh: ``[n_shards, K, B]``
        chunks, each one decision launch and one global-tier launch at the
        store's cadence."""
        decay = self._decay(decay_rate_per_sec)
        return self._bulk_decide(
            keys, counts, with_remaining,
            lambda op, nows: self._launch_chunk(op, nows, decay))

    @property
    def global_score(self) -> float:
        return float(self.gcounter.value.item())

    # -- checkpoint (the JAX store's schema) ---------------------------------
    def snapshot(self) -> dict:
        """The sharded state on the host, for a planned restart: restores
        into a store with the same shard count and config; timestamps
        re-align through ``now_ticks``."""
        with self._lock:
            g = self.gcounter
            return {
                "now_ticks": self.clock.now_ticks(),
                "n_shards": self.n_shards,
                "per_shard": self.per_shard,
                "capacity": self.capacity,
                "fill_rate_per_sec": self.fill_rate_per_sec,
                "directories": [d.to_dict() for d in self.dirs],
                "tokens": _to_host(self.state.tokens).copy(),
                "last_ts": _to_host(self.state.last_ts).copy(),
                "exists": _to_host(self.state.exists).copy(),
                "gcounter": {
                    "value": _to_host(g.value).copy(),
                    "period": _to_host(g.period).copy(),
                    "last_ts": _to_host(g.last_ts).copy(),
                    "exists": _to_host(g.exists).copy(),
                },
            }

    def restore(self, snap: dict) -> None:
        with self._lock:
            if snap["n_shards"] != self.n_shards:
                raise ValueError(
                    f"snapshot geometry {snap['n_shards']}x{snap['per_shard']}"
                    f" != store geometry {self.n_shards}x{self.per_shard} "
                    "(shard count must match)")
            if (snap["capacity"] != self.capacity
                    or snap["fill_rate_per_sec"] != self.fill_rate_per_sec):
                raise ValueError(
                    f"snapshot config (cap={snap['capacity']}, "
                    f"rate={snap['fill_rate_per_sec']}) != store config "
                    f"(cap={self.capacity}, rate={self.fill_rate_per_sec})")
            self.per_shard = int(snap["per_shard"])
            shift = int(self.clock.now_ticks()) - int(snap["now_ticks"])
            dev = self.mesh.device
            self.state = K.BucketState(
                tokens=torch.tensor(np.asarray(snap["tokens"], np.float32),
                                    device=dev),
                last_ts=torch.tensor(_shift_ts(snap["last_ts"], shift),
                                     device=dev),
                exists=torch.tensor(np.asarray(snap["exists"], bool),
                                    device=dev))
            g = snap["gcounter"]
            self.gcounter = GlobalCounter(
                value=torch.tensor(float(np.asarray(g["value"])),
                                   dtype=torch.float32, device=dev),
                period=torch.tensor(float(np.asarray(g["period"])),
                                    dtype=torch.float32, device=dev),
                last_ts=torch.tensor(int(_shift_ts(g["last_ts"], shift)),
                                     dtype=torch.int32, device=dev),
                exists=torch.tensor(bool(np.asarray(g["exists"])),
                                    device=dev))
            for d, mapping in zip(self.dirs, snap["directories"]):
                d.load(mapping, self.per_shard)


class ShardedWindowStore(_ShardedKeyedTable):
    """Key-sharded sliding/fixed-window table over a mesh (JAX ``:926``,
    BASELINE config 4 at mesh scale): :class:`ShardedDeviceStore`'s host
    runtime over a ``WindowState`` with the window scan; no global tier.
    One homogeneous ``(limit, window, fixed?)`` config an instance."""

    def __init__(self, mesh: Mesh, limit: float, window_sec: float, *,
                 fixed: bool = False, per_shard_slots: int = 2**14,
                 clock: Clock | None = None,
                 handle_duplicates: bool = True,
                 rebase_threshold_ticks: int = _REBASE_THRESHOLD_TICKS) -> None:
        if not handle_duplicates:
            raise NotImplementedError(
                "ShardedWindowStore(handle_duplicates=False) is not ported: "
                "the window scan kernel always serializes duplicates")
        self.mesh = mesh
        self.n_shards = mesh.n_shards
        self.per_shard = per_shard_slots
        self.limit = float(limit)
        self.window_ticks = int(window_sec * bm.TICKS_PER_SECOND)
        if self.window_ticks < 1:
            raise ValueError(f"a window must last at least one tick, got "
                             f"{self.window_ticks} ticks")
        self.fixed = fixed
        self.clock = clock or MonotonicClock()
        self.metrics = StoreMetrics()
        self._rebase_threshold = rebase_threshold_ticks
        self.state = K.init_window_state(self.n_shards * per_shard_slots,
                                         mesh.device)
        self.dirs = [make_directory(per_shard_slots)
                     for _ in range(self.n_shards)]
        self._lock = threading.RLock()

    def _device_sweep(self):
        return self._freed(*ck.sweep_windows(
            self.state, self.now_ticks_checked(), self.window_ticks))

    def force_rebase(self, offset_ticks: int) -> None:
        """Window tables rebase by whole windows."""
        with self._lock:
            K.rebase_window_epoch(self.state,
                                  offset_ticks // self.window_ticks)

    def _launch_chunk(self, op_np: np.ndarray,
                      nows: np.ndarray) -> torch.Tensor:
        return ck.window_scan_packed(
            self.state, self._upload(op_np), self._upload(nows), self.limit,
            self.window_ticks, interpolate=not self.fixed)

    # -- decisions -----------------------------------------------------------
    def acquire_many_blocking(
        self, keys: Sequence[str], counts: Sequence[int], *,
        with_remaining: bool = True,
    ) -> BulkAcquireResult:
        """Whole-array bulk window acquire over the mesh."""
        return self._bulk_decide(keys, counts, with_remaining,
                                 self._launch_chunk)

    def acquire_batch_blocking(
        self, requests: Sequence[tuple[str, int]],
    ) -> list[AcquireResult]:
        res = self.acquire_many_blocking(
            [k for k, _ in requests], [c for _, c in requests])
        return list(res)

    # -- checkpoint ----------------------------------------------------------
    def snapshot(self) -> dict:
        with self._lock:
            return {
                "now_ticks": self.clock.now_ticks(),
                "n_shards": self.n_shards,
                "per_shard": self.per_shard,
                "limit": self.limit,
                "window_ticks": self.window_ticks,
                "fixed": self.fixed,
                "directories": [d.to_dict() for d in self.dirs],
                **{name: _to_host(t).copy()
                   for name, t in zip(self.state._fields, self.state)},
            }

    def restore(self, snap: dict) -> None:
        with self._lock:
            if snap["n_shards"] != self.n_shards:
                raise ValueError(
                    f"snapshot geometry {snap['n_shards']}x"
                    f"{snap['per_shard']} != store geometry "
                    f"{self.n_shards}x{self.per_shard} (shard count must "
                    "match)")
            if (snap["limit"] != self.limit
                    or snap["window_ticks"] != self.window_ticks
                    or snap["fixed"] != self.fixed):
                raise ValueError("snapshot config != store config")
            self.per_shard = int(snap["per_shard"])
            # Indices re-align by whole windows with _shift_ts's signed
            # clamp: a stale index stays long expired.
            shift_w = ((int(self.clock.now_ticks()) - int(snap["now_ticks"]))
                       // self.window_ticks)
            dev = self.mesh.device
            self.state = K.WindowState(
                prev_count=torch.tensor(
                    np.asarray(snap["prev_count"], np.float32), device=dev),
                curr_count=torch.tensor(
                    np.asarray(snap["curr_count"], np.float32), device=dev),
                window_idx=torch.tensor(_shift_ts(snap["window_idx"],
                                                  shift_w), device=dev),
                exists=torch.tensor(np.asarray(snap["exists"], bool),
                                    device=dev))
            for d, mapping in zip(self.dirs, snap["directories"]):
                d.load(mapping, self.per_shard)
