"""The fingerprint store: key → slot lives on the device, not on the host.

The JAX package's ``runtime/fp_store.py`` on PyTorch.
:class:`FingerprintBucketStore` is a :class:`~.store.DeviceBucketStore`
whose token-bucket and window tiers swap the host key directory
(:mod:`.directory` over ``native/directory.cc``) for the device-resident
fingerprint table of :mod:`..ops.fp_directory`. Per batch the host hashes
the keys once (64-bit FNV-1a, :func:`fingerprints`) and ships 12 bytes a
decision; the kernel finds or claims each key's cell and the decision runs
on the same stream (``csrc/fp_directory.cu``, :mod:`..ops.cuda_kernels`).

- no host table for buckets and windows: no arena, no insert pass, no
  free-list bookkeeping on sweeps (a sweep clears the cell on the device);
- growth is a re-placement on the device (``fp_migrate_table``): one
  kernel pass walks the old table and places every entry with its state in
  the new one; the host reads back one 4-byte count of unplaced rows a
  pass, never a table or a column.

The trade: a decision ships an 8-byte fingerprint where the host
directory ships a resolved slot, and two keys share a bucket iff their
fingerprints collide (about n²/2⁶⁵; never for the byte-comparing host
directory). The counter and semaphore tiers keep the host directory, as in
JAX: their keys are per limiter, not per end user.

On the card every decision, debit, peek, sweep and migration goes through
the hand kernels, with no fallback; with ``device="cpu"`` their plain
versions decide. Which row wins a contested cell is the atomics' order on
the card (JAX's scatter keeps the last claimant): tables agree by key,
not by slot.
"""

from __future__ import annotations

import asyncio
import ctypes
from typing import Sequence

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime.batcher import MicroBatcher
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BulkAcquireResult,
    DeviceBucketStore,
    _AcquireReq,
    _grant_zero_probes,
    _pad_size,
    _rate_per_tick,
    _shift_ts,
    _to_host,
)
from distributedratelimiting.redis_tpu_torch.utils import faults
from distributedratelimiting.redis_tpu_torch.utils.native import (
    load_directory_lib,
)

__all__ = ["FingerprintBucketStore", "fingerprints"]

_FNV_OFFSET = 1469598103934665603
_FNV_PRIME = 1099511628211


def _fp64_py(key: str) -> int:
    """Pure-Python FNV-1a 64, bit for bit the native ``dir_fp64_pylist``
    (fingerprints live in device tables and checkpoints: every process
    must hash a key the same way)."""
    h = _FNV_OFFSET
    for byte in key.encode("utf-8", "surrogateescape"):
        h = ((h ^ byte) * _FNV_PRIME) & 0xFFFFFFFFFFFFFFFF
    return h or _FNV_OFFSET


def fingerprints(keys: Sequence[str]) -> np.ndarray:
    """Hash a key batch to ``u32[n, 2]`` (lo, hi) fingerprints: straight off
    a ``wire.KeyBlob``'s bytes, else one native pass over a ``list[str]``,
    else (no native library, or a key with lone surrogates) the identical
    pure-Python FNV. Never the all-zero empty cell."""
    n = len(keys)
    out = np.empty((n, 2), np.uint32)
    lib = load_directory_lib()
    blob = getattr(keys, "blob", None)
    if lib is not None and blob is not None and n:
        lib.dir_fp64_batch(
            blob, keys.offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
        return out
    if lib is not None and getattr(lib, "has_pylist", False) and n:
        ks = keys if isinstance(keys, list) else list(keys)
        if lib.dir_fp64_pylist(
                ks, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))) == 0:
            return out
    for i, k in enumerate(keys):
        h = _fp64_py(k)
        out[i, 0] = h & 0xFFFFFFFF
        out[i, 1] = h >> 32
    return out


def migrate_passes(fp, state, old_fp, old_state,
                   **kw) -> tuple[int, torch.Tensor]:
    """Growth's passes into one fresh table ``(fp, state)``: the live
    entries of ``(old_fp, old_state)`` through ``fp_migrate_table``, each
    pass taking the rows the one before left (on the card one pass places
    every row a free cell of its window can hold; the plain version runs
    JAX's chunks and rounds), until none is left or a pass places none —
    JAX's rule that some window is full. The first pass into a fresh table
    always places a row, so the rule first applies to a second pass, as in
    JAX. ``kw``: the wrapper's geometry and plain-version arguments.
    Returns ``(left, unplaced)``: the rows left (0: every entry placed) and
    their indices into the old table."""
    source, pending = None, None
    while True:
        source, left = ck.fp_migrate_table(fp, state, old_fp, old_state,
                                           source=source, **kw)
        if not left or (pending is not None and left >= pending):
            return left, source
        pending = left


def _i32(arr: np.ndarray) -> np.ndarray:
    """A uint32 operand's bits as int32 (the tensors' dtype)."""
    return np.ascontiguousarray(arr, np.uint32).view(np.int32)


class _FpTable:
    """One bucket configuration's table with the device-resident
    directory. Its interface is :class:`~.store._DeviceTable`'s (the
    store's methods reach it unchanged); every launch carries fingerprints
    and the probe and claim happen on the device."""

    #: Scan depth cap of a bulk dispatch.
    _BULK_MAX_K = 16
    #: Operand bytes a bulk dispatch may ship: 640 KB, the JAX package's
    #: budget at 12 B a decision (K <= 8 at the port's max_batch of 4096).
    _BULK_BYTE_BUDGET = 640 * 1024
    #: Grow when (occupied / n_slots) reaches this after window pressure.
    _GROW_AT = 0.7

    #: Dirty accounting for incremental checkpoints: placement happens on
    #: the device, so the gauge counts dispatched rows (an upper bound on
    #: dirty slots: duplicates count again). ``None`` until armed.
    dirty_rows: "int | None" = None

    def arm_dirty(self) -> None:
        """Arm the dirty accounting (idempotent)."""
        if self.dirty_rows is None:
            self.dirty_rows = 0

    def clear_dirty(self) -> None:
        if self.dirty_rows is not None:
            self.dirty_rows = 0

    def dirty_count(self) -> int:
        return self.dirty_rows or 0

    def __init__(self, store: "FingerprintBucketStore", capacity: float,
                 fill_rate_per_sec: float, n_slots: int) -> None:
        self.capacity = float(capacity)
        self.fill_rate_per_sec = float(fill_rate_per_sec)
        self.rate_per_tick = _rate_per_tick(fill_rate_per_sec)
        self._init_table(store, n_slots)

    def _init_table(self, store: "FingerprintBucketStore",
                    n_slots: int) -> None:
        if n_slots < store.probe_window:
            # n - L + 1 must stay positive: the non-wrapping placement is
            # undefined below one window.
            raise ValueError(f"n_slots ({n_slots}) must be >= probe_window "
                             f"({store.probe_window})")
        self.store = store
        self.n_slots = n_slots
        self.fp, self.state = self._init_fresh(n_slots)
        self.probe_window = store.probe_window
        self.rounds = store.insert_rounds
        self.batcher: MicroBatcher[_AcquireReq, AcquireResult] = MicroBatcher(
            self._flush,
            max_batch=store.max_batch,
            max_delay_s=store.max_delay_s,
            max_inflight=store.max_inflight,
            flush_latency=store.metrics.flush_latency,
            queue_latency=store.metrics.queue_latency,
            flush_observer=store._flush_observer,
        )

    # -- kernel bindings (the window table swaps these) ---------------------
    def _init_fresh(self, n: int):
        dev = self.store.device
        return F.init_fp_table(n, dev), K.init_bucket_state(n, dev)

    def _decide(self, fused: np.ndarray, nows: np.ndarray,
                with_remaining: bool) -> torch.Tensor:
        """One resolve-and-decide call over ``fused u32[K, B, 3]``; the
        caller holds the store lock."""
        return ck.fp_acquire_scan(
            self.fp, self.state, self._upload(_i32(fused)),
            self._upload(nows), self.capacity, self.rate_per_tick,
            probe_window=self.probe_window, rounds=self.rounds,
            with_remaining=with_remaining)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.store.device)

    # -- flush -------------------------------------------------------------
    _FLUSH_SPAN = "acquire_batch_fp"

    def _launch(self, keys: Sequence[str], counts: Sequence[int]):
        """One flush: fingerprints packed 12 bytes a row, padded to a power
        of two >= 8, one resolve-and-decide at K = 1. Returns the device
        result ``f32[1, 2, B]``."""
        n = len(keys)
        store = self.store
        b = _pad_size(n, floor=8)
        kp = np.zeros((b, 2), np.uint32)
        kp[:n] = fingerprints(keys)
        fused = F.pack_fp12(kp, np.minimum(np.asarray(counts, np.int64),
                                           2**31 - 1))
        with store.profiler.span(self._FLUSH_SPAN, n), store._lock:
            now = store.now_ticks_checked()
            out = self._decide(fused[None], np.array([now], np.int32), True)
            if self.dirty_rows is not None:
                self.dirty_rows += n
            store.metrics.record_launch(b, n)
        return out

    def _readback(self, out_np: np.ndarray, counts: Sequence[int]):
        """``f32[K, 2, B]`` (or its first rows) → grants, remaining; the
        zero-permit probes grant, and window-pressure rows are counted and
        relieved."""
        n = len(counts)
        code = out_np[:, 0, :].reshape(-1)[:n].astype(np.int32)
        granted = (code & 1).astype(bool)
        _grant_zero_probes(granted, np.asarray(counts))
        pressure = int(((code & 2) == 0).sum())
        if pressure:
            self.store.metrics.fp_unresolved += pressure
            self._relieve_pressure()
        return granted, out_np[:, 1, :].reshape(-1)[:n]

    async def _flush(self, reqs: Sequence[_AcquireReq]) -> list[AcquireResult]:
        if faults._INJECTOR is not None:  # chaos seam; no-op in prod
            await faults._INJECTOR.on_event("store.flush")
        counts = [r.count for r in reqs]
        out = self._launch([r.key for r in reqs], counts)
        loop = asyncio.get_running_loop()
        out_np = await loop.run_in_executor(None, _to_host, out)
        g, r = self._readback(out_np, counts)
        return [AcquireResult(bool(g[i]), float(r[i]))
                for i in range(len(reqs))]

    def acquire_blocking(self, key: str, count: int) -> AcquireResult:
        g, r = self._readback(_to_host(self._launch([key], [count])),
                              [count])
        return AcquireResult(bool(g[0]), float(r[0]))

    # -- bulk --------------------------------------------------------------
    _BULK_SPAN = "acquire_many_fp"

    def _bulk_dispatch(self, keys: Sequence[str], counts_np: np.ndarray,
                       with_remaining: bool = True) -> list[tuple]:
        """Chunked scan dispatches over the whole key array, each ONE
        12-byte-a-row operand up and one result down (the two bit planes
        on the verdict-only path); returns ``[(device result, take),
        ...]`` with no readback. ``keys`` may be a ``wire.KeyBlob``: it is
        hashed here, before any await."""
        n = len(keys)
        fps = fingerprints(keys)
        b = self.store.max_batch
        outs: list[tuple] = []
        store = self.store
        with store.profiler.span(self._BULK_SPAN, n), store._lock:
            now = store.now_ticks_checked()
            if self.dirty_rows is not None:
                self.dirty_rows += n
            max_k = self._BULK_MAX_K
            while max_k > 1 and max_k * b * 12 > self._BULK_BYTE_BUDGET:
                max_k //= 2
            pos = 0
            while pos < n:
                rows = -(-(n - pos) // b)
                k = 1
                while k < rows and k < max_k:
                    k *= 2
                take = min(k * b, n - pos)
                kp = np.zeros((k * b, 2), np.uint32)
                kp[:take] = fps[pos:pos + take]
                fused = F.pack_fp12(kp, np.minimum(counts_np[pos:pos + take],
                                                   2**31 - 1))
                nows = np.full((k,), now, np.int32)
                # Bit planes need B % 8 == 0; otherwise the f32 result.
                bits = not with_remaining and b % 8 == 0
                outs.append((self._decide(fused.reshape(k, b, 3), nows,
                                          not bits), take))
                store.metrics.record_launch(k * b, take)
                pos += take
        return outs

    def _gather_bulk(self, outs: list[tuple], counts_np: np.ndarray,
                     with_remaining: bool) -> BulkAcquireResult:
        n = len(counts_np)
        granted = np.empty((n,), bool)
        remaining = np.empty((n,), np.float32) if with_remaining else None
        pressure = 0
        pos = 0
        for out, take in outs:
            arr = _to_host(out)  # one readback per dispatch
            if arr.dtype == np.uint8:  # u8[K, 2, B/8] bit planes
                granted[pos:pos + take] = np.unpackbits(
                    arr[:, 0, :].reshape(-1),
                    bitorder="little").astype(bool)[:take]
                res = np.unpackbits(arr[:, 1, :].reshape(-1),
                                    bitorder="little").astype(bool)[:take]
            else:                      # f32[K, 2, B]: code row, remaining
                code = arr[:, 0, :].reshape(-1)[:take].astype(np.int32)
                granted[pos:pos + take] = (code & 1).astype(bool)
                res = (code & 2) > 0
                if remaining is not None:
                    remaining[pos:pos + take] = arr[:, 1, :].reshape(
                        -1)[:take]
            pressure += int((~res).sum())
            pos += take
        _grant_zero_probes(granted, counts_np)
        if pressure:
            self.store.metrics.fp_unresolved += pressure
            self._relieve_pressure()
        return BulkAcquireResult(granted, remaining)

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], *,
                              with_remaining: bool = True
                              ) -> BulkAcquireResult:
        counts_np = np.asarray(counts, np.int64)
        outs = self._bulk_dispatch(keys, counts_np,
                                   with_remaining=with_remaining)
        return self._gather_bulk(outs, counts_np, with_remaining)

    async def acquire_many(self, keys: Sequence[str],
                           counts: Sequence[int], *,
                           with_remaining: bool = True) -> BulkAcquireResult:
        counts_np = np.asarray(counts, np.int64)
        outs = self._bulk_dispatch(keys, counts_np,
                                   with_remaining=with_remaining)
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(
            None, lambda: self._gather_bulk(outs, counts_np, with_remaining))

    # -- debit (tier-0 reconciliation, reservations, the hierarchical refund)
    def _debit_launch(self, keys: Sequence[str],
                      amounts: Sequence[float]) -> torch.Tensor:
        """One saturating debit with resolution on the device (claim on
        miss): the lane ``DeviceBucketStore.debit_many`` dispatches
        through, which on this store also carries the hierarchical base
        compose's parent refund (a negative amount). ``i32[4, B]`` operand,
        ``B`` padded to a power of two >= 8: row 0 0 (valid) or -1, the
        float32 amounts, the tick, and the same-key float32 prefix keyed by
        fingerprint. Returns ``f32[2, B]`` (balance, shortfall)."""
        store = self.store
        n = len(keys)
        fps = fingerprints(list(keys))
        with store.profiler.span("debit_batch", n), store._lock:
            b = _pad_size(n, floor=8)
            kp = np.zeros((b, 2), np.uint32)
            kp[:n] = fps
            amounts_np = np.asarray(amounts, np.float32)
            packed = np.zeros((4, b), np.int32)
            packed[0, n:] = -1
            packed[1, :n] = amounts_np.view(np.int32)
            packed[2] = store.now_ticks_checked()
            if n and len(np.unique(fps.view(np.int64))) != n:
                packed[3, :n] = F.fp_prefix_float(fps, amounts_np).view(
                    np.int32)
            out = ck.fp_debit(self.fp, self.state, self._upload(_i32(kp)),
                              self._upload(packed), self.capacity,
                              self.rate_per_tick,
                              probe_window=self.probe_window,
                              rounds=self.rounds)
            if self.dirty_rows is not None:
                self.dirty_rows += n
            store.metrics.record_launch(b, n)
            return out

    # -- reads -------------------------------------------------------------
    def peek_blocking(self, key: str) -> float:
        kp = np.zeros((8, 2), np.uint32)
        kp[0] = fingerprints([key])[0]
        valid = np.zeros((8,), bool)
        valid[0] = True
        with self.store._lock:
            est = ck.fp_peek(self.fp, self.state, self._upload(_i32(kp)),
                             self._upload(valid),
                             self.store.now_ticks_checked(), self.capacity,
                             self.rate_per_tick,
                             probe_window=self.probe_window)
        return float(_to_host(est)[0])

    # -- maintenance -------------------------------------------------------
    def _occupancy(self) -> int:
        with self.store._lock:
            return int((self.fp != 0).any(1).sum())

    def _relieve_pressure(self) -> None:
        """Window pressure: sweep; grow when the table is past the growth
        threshold or the sweep freed (almost) nothing — a probe window can
        fill with live keys at modest load, and without the freed-nothing
        clause its keys would be denied forever. Denied rows are not
        retried here; the caller's next attempt lands in the relieved
        table."""
        with self.store._lock:
            before = self.store.metrics.slots_evicted
            self._sweep()
            freed = self.store.metrics.slots_evicted - before
            if (freed < max(1, self.n_slots // 16)
                    or self._occupancy() >= self._GROW_AT * self.n_slots):
                self._grow()

    _SWEEP_SPAN = "sweep_fp"

    def _sweep(self, pinned=None) -> None:
        store = self.store
        with store.profiler.span(self._SWEEP_SPAN, self.n_slots), \
                store._lock:
            n_freed = self._sweep_launch(store.now_ticks_checked())
            store.metrics.sweeps += 1
            store.metrics.slots_evicted += int(_to_host(n_freed)[0])

    def _sweep_launch(self, now: int) -> torch.Tensor:
        return ck.fp_sweep_expired(self.fp, self.state, now, self.capacity,
                                   self.rate_per_tick)

    def _grow(self) -> None:
        """Double the table: re-place every entry in a fresh table on the
        device (``fp_migrate_table``), reading nothing back but a count."""
        store = self.store
        with store._lock:
            self._rehash(self.fp, self.state, self.n_slots * 2)
            store.metrics.pregrows += 1

    def _rehash(self, old_fp: torch.Tensor, old_state, start_n: int,
                probe_window: int | None = None) -> None:
        """Re-place every live entry of the table ``(old_fp, old_state)``
        (on the store's device) into a fresh table, doubling and retrying
        when placement gets stuck: the routine behind growth and
        legacy-snapshot adoption (the caller holds the store lock). Changes
        nothing until placement succeeds, so a raise leaves the table as it
        was. ``probe_window`` places under a snapshot's geometry before
        committing it.

        An entry whose whole window fills with other entries cannot be
        placed at a given size (a density accident, seen at ~0.8 load);
        each doubling halves the load, and after four a pathological hash
        set fails loudly."""
        pw = self.probe_window if probe_window is None else probe_window
        new_n = start_n
        for _attempt in range(4):
            fp, state = self._init_fresh(new_n)
            left, _ = migrate_passes(fp, state, old_fp, old_state,
                                     probe_window=pw, rounds=self.rounds,
                                     chunk=self.store.max_batch)
            if not left:
                self.fp, self.state, self.n_slots = fp, state, new_n
                self.probe_window = pw
                return
            new_n *= 2
        raise RuntimeError(f"fingerprint rehash cannot place {left} "
                           f"entries even at {new_n // 2} slots")

    def rebase(self, offset: int) -> None:
        K.rebase_bucket_epoch(self.state, offset)

    # -- checkpoint form (the JAX package's schema) ------------------------
    def to_snap(self) -> dict:
        return {
            "fp": _to_host(self.fp).view(np.uint32).copy(),
            "probe_window": self.probe_window,
            "placement": F.PLACEMENT_VERSION,
            **{name: _to_host(t).copy()
               for name, t in zip(self.state._fields, self.state)},
        }

    _HOST_DIR_ERROR = ("checkpoint's bucket tables use the host key "
                       "directory — restore into a DeviceBucketStore")

    def _snap_cols(self, data: dict, shift: int) -> list:
        return [np.asarray(data["tokens"], np.float32),
                _shift_ts(data["last_ts"], shift),
                np.asarray(data["exists"], bool)]

    def load_snap(self, data: dict, shift: int) -> None:
        if "fp" not in data:
            raise ValueError(self._HOST_DIR_ERROR)
        # Adopt the snapshot's probe window with its size: a key at offset
        # 12 of a 16-cell window is invisible to an 8-cell scan.
        pw = int(data.get("probe_window", self.probe_window))
        cols = self._snap_cols(data, shift)
        dev = self.store.device
        fp = torch.tensor(np.asarray(data["fp"], np.uint32).view(np.int32),
                          device=dev)
        state = type(self.state)(*(torch.tensor(c, device=dev)
                                   for c in cols))
        if data.get("placement") != F.PLACEMENT_VERSION:
            # A v1 snapshot placed entries with a wrapping h mod N: re-place
            # them from the uploaded arrays, one pass on the device (commit
            # on success, so a failed restore changes nothing).
            self._rehash(fp, state, len(cols[0]), probe_window=pw)
            return
        self.probe_window = pw
        self.n_slots = len(cols[0])
        self.fp, self.state = fp, state


class _FpWindowTable(_FpTable):
    """A sliding or fixed window configuration's table with the
    device-resident directory: :class:`_FpTable`'s flush, bulk, pressure
    and lock machinery with the window's kernels, sweep rule, migrate
    columns and checkpoint form."""

    _FLUSH_SPAN = "window_acquire_batch_fp"
    _BULK_SPAN = "window_acquire_many_fp"
    _SWEEP_SPAN = "sweep_fp_windows"
    _HOST_DIR_ERROR = ("checkpoint's window tables use the host key "
                       "directory — restore into a DeviceBucketStore")

    def __init__(self, store: "FingerprintBucketStore", limit: float,
                 window_ticks: int, n_slots: int, *,
                 fixed: bool = False) -> None:
        if int(window_ticks) < 1:
            raise ValueError(f"a window must last at least one tick, got "
                             f"{window_ticks} ticks")
        self.limit = float(limit)
        self.window_ticks = int(window_ticks)
        self.fixed = fixed
        self._init_table(store, n_slots)

    def _init_fresh(self, n: int):
        dev = self.store.device
        return F.init_fp_table(n, dev), K.init_window_state(n, dev)

    def _decide(self, fused, nows, with_remaining):
        return ck.fp_window_scan(
            self.fp, self.state, self._upload(_i32(fused)),
            self._upload(nows), self.limit, self.window_ticks,
            interpolate=not self.fixed, probe_window=self.probe_window,
            rounds=self.rounds, with_remaining=with_remaining)

    def _sweep_launch(self, now: int) -> torch.Tensor:
        return ck.fp_sweep_windows(self.fp, self.state, now,
                                   self.window_ticks)

    def rebase(self, offset_ticks: int) -> None:
        K.rebase_window_epoch(self.state, offset_ticks // self.window_ticks)

    def _snap_cols(self, data: dict, shift: int) -> list:
        return [np.asarray(data["prev_count"], np.float32),
                np.asarray(data["curr_count"], np.float32),
                _shift_ts(data["window_idx"], shift // self.window_ticks),
                np.asarray(data["exists"], bool)]


class FingerprintBucketStore(DeviceBucketStore):
    """:class:`~.store.DeviceBucketStore` with the bucket and window tiers'
    key directory on the device (module docstring). The same
    ``BucketStore`` surface and limiters; checkpoints interchange with
    fingerprint stores only, the JAX package's included (the snapshot
    carries fingerprints, not keys). ``probe_window`` (cells a key may
    occupy, at most 32 on the card) and ``insert_rounds`` (claim rounds a
    row) are the JAX store's; on the card a row's claims are bounded by its
    window instead, and ``insert_rounds`` reaches only the plain
    versions."""

    def __init__(self, *, probe_window: int = 16, insert_rounds: int = 4,
                 **kwargs) -> None:
        super().__init__(**kwargs)
        if not 1 <= probe_window <= ck.FP_MAX_WINDOW:
            raise ValueError(f"probe_window must lie in [1, "
                             f"{ck.FP_MAX_WINDOW}], got {probe_window}")
        self.probe_window = probe_window
        self.insert_rounds = insert_rounds

    _TABLE_CLS = _FpTable
    _WTABLE_CLS = _FpWindowTable
