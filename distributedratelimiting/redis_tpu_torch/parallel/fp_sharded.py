"""Mesh-sharded device-resident directory: fingerprints in shard regions.

The JAX package's ``parallel/fp_sharded.py`` on PyTorch: the key-sharded
mesh tables of :mod:`.sharded_store` with the device-resident fingerprint
directory of :mod:`..ops.fp_directory` (the host hashes each key once; the
kernel finds or claims its cell). The fingerprint is the route: shard =
``fp_lo % n_shards``, with no second hash.

JAX gives each shard its own fingerprint table and state slice. Here the
mesh's shards sit on one device, so their tables are one shard-major table
of ``n_shards`` regions (``n_shards`` passed to the fp kernels and their
plain versions): a key lives in region ``fp_lo % n_shards`` at the cell a
table of the region's size would give it. A launch takes every shard's rows
(batch k of a ``[n_shards, K, B]`` chunk is rows ``[s * B, (s + 1) * B)``
for shard s), and one launch places them as JAX's per-shard programs do:
rows of different regions never meet. A row must sit in its route's shard,
as the stores put it. Sweeps run over the whole table; growth doubles every
region through the migrate kernel (the route is resize-invariant, so
entries never change shard).

Both families ship: token buckets (:class:`ShardedFpDeviceStore`, with the
global tier through ``cuda_kernels.global_tier``) and sliding/fixed windows
(:class:`ShardedFpWindowStore`). On the card the winner of a contested cell
is the atomics' order (the single-table fp store's divergence): tables
agree with JAX's by key, not by cell.
"""

from __future__ import annotations

import threading
from typing import Sequence

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import cuda_kernels as ck
from distributedratelimiting.redis_tpu_torch.ops import fp_directory as F
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.ops.kernels import (
    GlobalCounter,
    init_global_counter,
)
from distributedratelimiting.redis_tpu_torch.parallel.mesh import Mesh
from distributedratelimiting.redis_tpu_torch.runtime.clock import (
    Clock,
    MonotonicClock,
)
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    AcquireResult,
    BulkAcquireResult,
    _grant_zero_probes,
    _rate_per_tick,
    _REBASE_MARGIN_TICKS,
    _REBASE_THRESHOLD_TICKS,
    _shift_ts,
    _to_host,
)
from distributedratelimiting.redis_tpu_torch.utils.metrics import StoreMetrics

__all__ = ["make_sharded_fp_scan_step",
           "make_sharded_fp_window_scan_step",
           "make_sharded_fp_migrate_step",
           "ShardedFpDeviceStore", "ShardedFpWindowStore"]


def _i32(x, dev) -> torch.Tensor:
    """A uint32 operand's bits as an int32 tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(x).astype(np.uint32, copy=False))
        .view(np.int32)).to(dev)


def _fused_rows(fused: torch.Tensor) -> torch.Tensor:
    """``[S, K, B, 3]`` → ``[K, S·B, 3]``: batch k of every shard."""
    s, k, b, w = fused.shape
    return fused.permute(1, 0, 2, 3).reshape(k, s * b, w).contiguous()


def _out_shards(out: torch.Tensor, n_shards: int) -> torch.Tensor:
    """A decision's ``f32[K, 2, S·B]`` → JAX's ``[S, K, 2, B]``."""
    k, two, r = out.shape
    return out.reshape(k, two, n_shards, r // n_shards).permute(2, 0, 1, 3)


def make_sharded_fp_migrate_step(mesh: Mesh, state_cls=None, *,
                                 probe_window: int = 16, rounds: int = 4):
    """The per-shard rehash chunk of growth (JAX ``fp_sharded.py:60``):
    ``step(fp, state, kpair [S, B, 2], *cols [S, B], valid [S, B]) -> (fp,
    state, placed [S, B])``, the state's columns in field order. One
    ``fp_migrate`` launch over every shard's rows, placed in their shard
    regions. ``state_cls`` is accepted for JAX's signature; the state's own
    type picks the family."""
    n_shards = mesh.n_shards

    def step(fp, state, kpair, *rest):
        cols, valid = rest[:-1], rest[-1]
        dev = fp.device
        kp = _i32(kpair, dev).reshape(-1, 2).contiguous()
        flat = [torch.as_tensor(np.asarray(c) if not isinstance(
            c, torch.Tensor) else c).to(dev).reshape(-1).to(t.dtype)
            for c, t in zip(cols, state)]
        v = torch.as_tensor(np.asarray(valid) if not isinstance(
            valid, torch.Tensor) else valid).to(dev).reshape(-1)
        placed = ck.fp_migrate(fp, state, kp, flat, v.to(torch.bool),
                               probe_window=probe_window, rounds=rounds,
                               n_shards=n_shards)
        return fp, state, placed.view(n_shards, -1)

    return step


def make_sharded_fp_window_scan_step(mesh: Mesh, *, probe_window: int = 16,
                                     rounds: int = 4,
                                     handle_duplicates: bool = True,
                                     interpolate: bool = True):
    """The window family's fused resolve-and-decide (JAX ``:93``), no global
    tier: ``step(fp, state, fused u32[S, K, B, 3], nows i32[K], limit,
    window_ticks) -> (fp, state, out f32[S, K, 2, B])``, row 0 ``granted +
    2 * resolved``. One ``fp_window_scan`` launch. The fp scans always
    serialize duplicates: ``handle_duplicates=False`` is not ported."""
    if not handle_duplicates:
        raise NotImplementedError(
            "the sharded fp steps always serialize duplicates "
            "(handle_duplicates=False is not ported)")
    n_shards = mesh.n_shards

    def step(fp, state, fused, nows, limit, window_ticks):
        dev = fp.device
        out = ck.fp_window_scan(
            fp, state, _fused_rows(_i32(fused, dev)),
            _i32(np.asarray(nows, np.int32), dev), float(limit),
            int(window_ticks), interpolate=interpolate,
            probe_window=probe_window, rounds=rounds, n_shards=n_shards)
        return fp, state, _out_shards(out, n_shards)

    return step


def make_sharded_fp_scan_step(mesh: Mesh, *, probe_window: int = 16,
                              rounds: int = 4,
                              handle_duplicates: bool = True,
                              sync_cadence: str = "batch"):
    """The bucket family's fused resolve-and-decide with the global tier
    (JAX ``:136``): ``step(fp, state, fused u32[S, K, B, 3], nows, capacity,
    rate, gcounter, decay_rate) -> (fp, state, out f32[S, K, 2, B],
    gcounter)``. One ``fp_acquire_scan`` launch over every shard's rows and
    one ``global_tier`` launch, once a batch or once a launch."""
    if sync_cadence not in ("batch", "launch"):
        raise ValueError("sync_cadence must be 'batch' or 'launch'")
    if not handle_duplicates:
        raise NotImplementedError(
            "the sharded fp steps always serialize duplicates "
            "(handle_duplicates=False is not ported)")
    n_shards = mesh.n_shards

    def step(fp, state, fused, nows, capacity, rate, gcounter, decay_rate):
        dev = fp.device
        nows_t = _i32(np.asarray(nows, np.int32), dev)
        out, counts = ck.fp_acquire_scan(
            fp, state, _fused_rows(_i32(fused, dev)), nows_t,
            float(capacity), float(rate), probe_window=probe_window,
            rounds=rounds, n_shards=n_shards, return_counts=True)
        ck.global_tier(out, counts, nows_t, gcounter, float(decay_rate),
                       sync_cadence)
        return fp, state, _out_shards(out, n_shards), gcounter

    return step


def _make_sharded_fp_peek_step(mesh: Mesh, *, probe_window: int):
    """Shard-local read-only lookup (JAX ``:679``): ``step(fp, state, kpair
    [S, B, 2], valid [S, B], now, capacity, rate) -> est f32[S, B]``; one
    ``fp_peek`` launch."""
    n_shards = mesh.n_shards

    def step(fp, state, kpair, valid, now, capacity, rate):
        dev = fp.device
        kp = _i32(kpair, dev).reshape(-1, 2).contiguous()
        v = torch.as_tensor(np.asarray(valid) if not isinstance(
            valid, torch.Tensor) else valid).to(dev).reshape(-1)
        est = ck.fp_peek(fp, state, kp, v.to(torch.bool), int(now),
                         float(capacity), float(rate),
                         probe_window=probe_window, n_shards=n_shards)
        return est.view(n_shards, -1)

    return step


class ShardedFpDeviceStore:
    """Bulk decisions against mesh-sharded fingerprint tables (JAX ``:206``).
    One homogeneous config an instance; a bulk call hashes once, routes by
    ``fp_lo % n_shards``, groups order-stably per shard and decides in
    scanned launches of every shard's rows.

    Window pressure (a row whose probe window is full) denies the row,
    counts it in ``fp_unresolved`` and heals: sweep, then, if the sweep
    freed (almost) nothing or the table is past 0.7 load, double every
    shard region through the migrate kernel. Denied rows are not retried in
    the call. ``auto_grow=False`` presizes instead."""

    _BULK_MAX_K = 8

    def __init__(self, mesh: Mesh, *, capacity: float,
                 fill_rate_per_sec: float, per_shard_slots: int = 1 << 16,
                 batch: int = 512, probe_window: int = 16, rounds: int = 4,
                 decay_rate_per_sec: float = 0.0,
                 clock: Clock | None = None,
                 auto_grow: bool = True,
                 sync_cadence: str = "batch",
                 rebase_threshold_ticks: int = _REBASE_THRESHOLD_TICKS
                 ) -> None:
        if sync_cadence not in ("batch", "launch"):
            raise ValueError("sync_cadence must be 'batch' or 'launch'")
        # Accepted by the window subclass too (its step has no global tier),
        # so the mesh store passes one config to every tier.
        self.sync_cadence = sync_cadence
        self.mesh = mesh
        # Launches, sweeps and rebases serialize on one lock.
        self._lock = threading.RLock()
        self._rebase_threshold = rebase_threshold_ticks
        self.n_shards = mesh.n_shards
        if per_shard_slots < probe_window:
            raise ValueError(
                f"per_shard_slots ({per_shard_slots}) must be >= "
                f"probe_window ({probe_window})")
        if not 1 <= probe_window <= ck.FP_MAX_WINDOW:
            raise ValueError(f"probe_window must lie in [1, "
                             f"{ck.FP_MAX_WINDOW}], got {probe_window}")
        if self.n_shards * batch > ck.SCAN_MAX_BATCH:
            raise ValueError(
                f"n_shards x batch ({self.n_shards} x {batch}) exceeds the "
                f"{ck.SCAN_MAX_BATCH} rows of one decision batch")
        self.capacity = float(capacity)
        self.rate_per_tick = _rate_per_tick(fill_rate_per_sec)
        self.decay_per_tick = _rate_per_tick(decay_rate_per_sec)
        self.per_shard_slots = per_shard_slots
        self.batch = batch
        self.probe_window = probe_window
        self.rounds = rounds
        self.clock = clock or MonotonicClock()
        self.auto_grow = auto_grow
        self.metrics = StoreMetrics()
        self.fp_unresolved = 0
        self.grows = 0
        n = per_shard_slots * self.n_shards
        self.fp, self.state = self._fresh(n)
        self.gcounter = init_global_counter(mesh.device)

    # -- table-family hooks (the window subclass swaps these) ----------------
    def _init_state(self, n: int):
        return K.init_bucket_state(n, self.mesh.device)

    def _fresh(self, n: int):
        return F.init_fp_table(n, self.mesh.device), self._init_state(n)

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.mesh.device)

    def _launch(self, fused: np.ndarray, nows: np.ndarray) -> torch.Tensor:
        """One scanned dispatch (caller holds the lock) over ``fused
        u32[K, S·B, 3]``: the decision and the global tier; returns ``out
        f32[K, 2, S·B]``."""
        nows_t = self._upload(nows)
        out, counts = ck.fp_acquire_scan(
            self.fp, self.state, _i32(fused, self.mesh.device), nows_t,
            self.capacity, self.rate_per_tick,
            probe_window=self.probe_window, rounds=self.rounds,
            n_shards=self.n_shards, return_counts=True)
        ck.global_tier(out, counts, nows_t, self.gcounter,
                       self.decay_per_tick, self.sync_cadence)
        return out

    @property
    def global_score(self) -> float:
        return float(self.gcounter.value.item())

    def now_ticks_checked(self) -> int:
        """Clock read with int32-overflow protection: table and clock
        rebase together."""
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
        """Shift bucket and global-counter timestamps without touching the
        clock (fingerprints carry no time)."""
        with self._lock:
            K.rebase_bucket_epoch(self.state, offset)
            g = self.gcounter
            g.last_ts.copy_(torch.clamp_min(g.last_ts - int(offset), 0))

    def _max_k(self) -> int:
        """JAX's scan depth (its 640 KB operand budget a device) within the
        card's launch (``SCAN_MAX_ROWS`` rows)."""
        b = self.batch
        max_k = self._BULK_MAX_K
        while max_k > 1 and (max_k * b * 12 > 640 * 1024
                             or max_k * self.n_shards * b > ck.SCAN_MAX_ROWS):
            max_k //= 2
        return max_k

    def acquire_many_blocking(self, keys: Sequence[str],
                              counts: Sequence[int], *,
                              with_remaining: bool = True
                              ) -> BulkAcquireResult:
        from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
            fingerprints,
        )

        n = len(keys)
        if n == 0:
            return BulkAcquireResult(
                np.zeros(0, bool),
                np.zeros(0, np.float32) if with_remaining else None)
        counts_np = np.asarray(counts, np.int64)
        s_n = self.n_shards
        fps = fingerprints(keys)  # KeyBlob-aware
        routes = fps[:, 0] % np.uint32(s_n)
        order = np.argsort(routes, kind="stable")  # per-shard arrival order
        bounds = np.searchsorted(routes[order], np.arange(s_n + 1))
        rows = int(np.diff(bounds).max())
        granted = np.zeros(n, bool)
        remaining = np.zeros(n, np.float32) if with_remaining else None
        b = self.batch
        pos = 0  # row offset within each shard's group, advanced per launch
        with self._lock:
            # Sampled under the lock: a concurrent epoch rebase must not
            # pair a pre-rebase `now` with post-rebase state.
            now = self.now_ticks_checked()
            call_pressure = 0
            max_k = self._max_k()
            while pos < rows:
                k = 1
                need_rows = -(-(rows - pos) // b)
                while k < need_rows and k < max_k:
                    k *= 2
                take = k * b
                fused = np.zeros((s_n, take, 3), np.uint32)
                fused[:, :, 2] = np.uint32(0xFFFFFFFF)
                sel = []  # (shard, rows, request indices)
                n_valid = 0
                for s in range(s_n):
                    lo = bounds[s] + pos
                    hi = min(bounds[s + 1], lo + take)
                    m = max(0, hi - lo)
                    if m == 0:
                        continue
                    idx = order[lo:hi]
                    fused[s, :m] = F.pack_fp12(fps[idx], counts_np[idx])
                    n_valid += m
                    sel.append((s, m, idx))
                nows = np.full((k,), now, np.int32)
                rows_k = np.ascontiguousarray(
                    fused.reshape(s_n, k, b, 3).transpose(1, 0, 2, 3)
                ).reshape(k, s_n * b, 3)
                out_np = _to_host(self._launch(rows_k, nows))
                self.metrics.record_launch(s_n * k * b, n_valid)
                # [K, 2, S·B] → per shard, its K·B rows in order.
                per = out_np.reshape(k, 2, s_n, b).transpose(2, 1, 0, 3)
                code = per[:, 0].reshape(s_n, -1).astype(np.int32)
                r_np = per[:, 1].reshape(s_n, -1)
                for s, m, idx in sel:
                    granted[idx] = (code[s, :m] & 1).astype(bool)
                    if remaining is not None:
                        remaining[idx] = r_np[s, :m]
                    call_pressure += int(((code[s, :m] & 2) == 0).sum())
                pos += take
            self.fp_unresolved += call_pressure
            self.metrics.fp_unresolved += call_pressure
            if call_pressure and self.auto_grow:
                # Deny-and-heal: sweep, then grow when the sweep freed
                # (almost) nothing OR the table is past the threshold.
                n_total = self.per_shard_slots * s_n
                freed = self._sweep_locked()
                if (freed < max(1, n_total // 16)
                        or self._occupancy() >= 0.7 * n_total):
                    self._grow_locked()
        _grant_zero_probes(granted, counts_np)
        return BulkAcquireResult(granted, remaining)

    def _occupancy(self) -> int:
        return int((self.fp != 0).any(1).sum())

    def _host_tables(self):
        """The fingerprints ``u32[S, P, 2]`` and state columns ``[S, P]``
        read back."""
        s_n = self.n_shards
        old_fp = _to_host(self.fp).view(np.uint32).reshape(s_n, -1, 2)
        olds = [_to_host(t).reshape(s_n, -1) for t in self.state]
        return old_fp, olds

    def _grow_locked(self) -> None:
        """All-shard doubling through the migrate kernel: each shard's
        entries re-place within its doubled region."""
        old_fp, olds = self._host_tables()
        self._rehash_locked(old_fp, olds, old_fp.shape[1] * 2)
        self.grows += 1
        self.metrics.pregrows += 1

    def _rehash_locked(self, old_fp: np.ndarray, olds: list,
                       per_start: int,
                       probe_window: int | None = None) -> None:
        """Re-place every shard's live entries into fresh tables (``old_fp
        u32[S, P_old, 2]``, ``olds`` the state columns ``[S, P_old]`` in
        field order): the routine behind growth and legacy-snapshot
        adoption. Nothing changes until placement succeeds. An entry whose
        whole window fills cannot be placed at a size: double and retry,
        four times at most."""
        pw = self.probe_window if probe_window is None else probe_window
        s_n = self.n_shards
        entries = [np.nonzero((old_fp[s] != 0).any(-1))[0]
                   for s in range(s_n)]
        b = self.batch
        per_new = per_start
        leftover = 0
        for _attempt in range(4):
            fp, state = self._fresh(per_new * s_n)
            pending = entries
            stuck = False
            # Rows a pass cannot place retry in later passes; a pass that
            # places none means some window is full at this size.
            while any(len(p) for p in pending):
                next_pending = [[] for _ in range(s_n)]
                rows = max(len(p) for p in pending)
                for pos in range(0, rows, b):
                    kpair = np.zeros((s_n, b, 2), np.uint32)
                    cols = [np.zeros((s_n, b), a.dtype) for a in olds]
                    valid = np.zeros((s_n, b), bool)
                    chunk = [None] * s_n
                    for s in range(s_n):
                        idx = pending[s][pos:pos + b]
                        if len(idx) == 0:
                            continue
                        chunk[s] = idx
                        kpair[s, :len(idx)] = old_fp[s][idx]
                        for c, a in zip(cols, olds):
                            c[s, :len(idx)] = a[s][idx]
                        valid[s, :len(idx)] = True
                    placed = _to_host(ck.fp_migrate(
                        fp, state, _i32(kpair.reshape(-1, 2),
                                        self.mesh.device),
                        [self._upload(c.reshape(-1)) for c in cols],
                        self._upload(valid.reshape(-1)), probe_window=pw,
                        rounds=self.rounds, n_shards=s_n)).reshape(s_n, b)
                    for s in range(s_n):
                        idx = chunk[s]
                        if idx is None:
                            continue
                        miss = ~placed[s, :len(idx)]
                        if miss.any():
                            next_pending[s].append(idx[miss])
                new_pending = [
                    np.concatenate(p) if p else np.zeros((0,), np.int64)
                    for p in next_pending]
                if (sum(len(p) for p in new_pending)
                        >= sum(len(p) for p in pending)):
                    stuck = True
                    leftover = sum(len(p) for p in new_pending)
                    break
                pending = new_pending
            if not stuck:
                self.fp, self.state = fp, state
                self.per_shard_slots = per_new
                return
            per_new *= 2
        raise RuntimeError(
            f"sharded fingerprint rehash cannot place {leftover} entries "
            f"even at {per_new // 2} slots/shard")

    def sweep(self) -> int:
        """TTL sweep over every shard region (one launch over the table).
        Returns slots freed."""
        with self._lock:
            return self._sweep_locked()

    def _sweep_launch(self, now: int) -> torch.Tensor:
        return ck.fp_sweep_expired(self.fp, self.state, now, self.capacity,
                                   self.rate_per_tick)

    def _sweep_locked(self) -> int:
        # `now` first: the clock read may rebase the state.
        now = self.now_ticks_checked()
        freed = int(_to_host(self._sweep_launch(now))[0])
        self.metrics.sweeps += 1
        self.metrics.slots_evicted += freed
        return freed

    # -- per-request flush surface (the mesh store's batcher) ----------------
    def acquire_batch_blocking(
            self, requests: "Sequence[tuple[str, int]]"
    ) -> "list[AcquireResult]":
        """Decide a batch of ``(key, count)`` requests in one bulk call;
        results in request order."""
        return list(self.acquire_many_blocking(
            [k for k, _ in requests], [c for _, c in requests]))

    def peek_blocking(self, key: str) -> float:
        """Read-only availability estimate: a lookup in the key's shard
        region WITHOUT claim (peeking at an unseen key must not claim a
        cell). One ``fp_peek`` launch."""
        from distributedratelimiting.redis_tpu_torch.runtime.fp_store import (
            fingerprints,
        )

        kpair = np.zeros((8, 2), np.uint32)
        kpair[0] = fingerprints([key])[0]
        valid = np.zeros((8,), bool)
        valid[0] = True
        with self._lock:
            now = self.now_ticks_checked()
            est = ck.fp_peek(self.fp, self.state,
                             _i32(kpair, self.mesh.device),
                             self._upload(valid), now, self.capacity,
                             self.rate_per_tick,
                             probe_window=self.probe_window,
                             n_shards=self.n_shards)
        return float(_to_host(est)[0])

    # -- checkpoint ----------------------------------------------------------
    def _config_snap(self) -> dict:
        return {"capacity": self.capacity,
                "rate_per_tick": self.rate_per_tick}

    def _check_config_snap(self, snap: dict) -> None:
        want = self._config_snap()
        got = {k: snap.get(k) for k in want}
        if got != want:
            raise ValueError(
                f"snapshot config {got} != store config {want} — a "
                "fingerprint snapshot restores only into a same-config "
                "store")

    def snapshot(self) -> dict:
        with self._lock:
            g = self.gcounter
            snap = {
                "now_ticks": self.clock.now_ticks(),
                "n_shards": self.n_shards,
                "per_shard": self.per_shard_slots,
                "probe_window": self.probe_window,
                "placement": F.PLACEMENT_VERSION,
                "fp": _to_host(self.fp).view(np.uint32).copy(),
                "gcounter": {
                    "value": float(g.value.item()),
                    "period": float(g.period.item()),
                    "last_ts": int(g.last_ts.item()),
                    "exists": bool(g.exists.item()),
                },
            }
            snap.update(self._config_snap())
            for f, t in zip(self.state._fields, self.state):
                snap[f] = _to_host(t).copy()
            return snap

    def _snap_cols(self, snap: dict, shift: int) -> list:
        return [np.asarray(snap["tokens"], np.float32),
                _shift_ts(snap["last_ts"], shift),
                np.asarray(snap["exists"], bool)]

    def restore(self, snap: dict) -> None:
        with self._lock:
            if "fp" not in snap:
                raise ValueError(
                    "snapshot's tables use the host key directory — "
                    "restore into the host-directory sharded store")
            if snap["n_shards"] != self.n_shards:
                raise ValueError(
                    f"snapshot shard count {snap['n_shards']} != "
                    f"store {self.n_shards} (fingerprints route by "
                    "fp % n_shards — re-sharding is key redistribution)")
            self._check_config_snap(snap)
            shift = int(self.clock.now_ticks()) - int(snap["now_ticks"])
            new_pw = int(snap.get("probe_window", self.probe_window))
            cols = self._snap_cols(snap, shift)
            old_fp = np.asarray(snap["fp"], np.uint32)
            # Install the tables FIRST: the legacy re-place can raise, and
            # config committed before it would not match the live tables.
            if snap.get("placement") != F.PLACEMENT_VERSION:
                # A v1 snapshot placed entries with the wrapping h % n
                # window: re-place them through the migrate kernel (shard
                # routing is placement-invariant).
                self._rehash_locked(
                    old_fp.reshape(self.n_shards, -1, 2),
                    [c.reshape(self.n_shards, -1) for c in cols],
                    int(snap["per_shard"]), probe_window=new_pw)
            else:
                dev = self.mesh.device
                self.fp = torch.tensor(old_fp.view(np.int32), device=dev)
                self.state = type(self.state)(
                    *(torch.tensor(c, device=dev) for c in cols))
                self.per_shard_slots = int(snap["per_shard"])
            self.probe_window = new_pw
            g = snap.get("gcounter")
            if g is not None:
                dev = self.mesh.device
                self.gcounter = GlobalCounter(
                    value=torch.tensor(float(g["value"]),
                                       dtype=torch.float32, device=dev),
                    period=torch.tensor(float(g["period"]),
                                        dtype=torch.float32, device=dev),
                    last_ts=torch.tensor(max(0, int(g["last_ts"]) + shift),
                                         dtype=torch.int32, device=dev),
                    exists=torch.tensor(bool(g["exists"]), device=dev))


class ShardedFpWindowStore(ShardedFpDeviceStore):
    """Sliding/fixed-window tables with the device-resident directory over
    a mesh (JAX ``:701``). No global tier: windows have no cross-key state.
    Everything else (route by fingerprint, pressure heal, growth, rebase)
    is inherited."""

    def __init__(self, mesh: Mesh, *, limit: float, window_sec: float,
                 fixed: bool = False, **kw) -> None:
        self.limit = float(limit)
        self.window_ticks = int(window_sec * bm.TICKS_PER_SECOND)
        if self.window_ticks < 1:
            raise ValueError(f"a window must last at least one tick, got "
                             f"{self.window_ticks} ticks")
        self.fixed = fixed
        # capacity / fill rate are the bucket family's; unused here.
        super().__init__(mesh, capacity=limit, fill_rate_per_sec=0.0, **kw)

    def _init_state(self, n: int):
        return K.init_window_state(n, self.mesh.device)

    def _launch(self, fused: np.ndarray, nows: np.ndarray) -> torch.Tensor:
        return ck.fp_window_scan(
            self.fp, self.state, _i32(fused, self.mesh.device),
            self._upload(nows), self.limit, self.window_ticks,
            interpolate=not self.fixed, probe_window=self.probe_window,
            rounds=self.rounds, n_shards=self.n_shards)

    def peek_blocking(self, key: str) -> float:
        raise NotImplementedError(
            "window tables expose no peek (matching the single-chip "
            "window tiers)")

    def _config_snap(self) -> dict:
        return {"limit": self.limit, "window_ticks": self.window_ticks,
                "fixed": self.fixed}

    def _snap_cols(self, snap: dict, shift: int) -> list:
        return [np.asarray(snap["prev_count"], np.float32),
                np.asarray(snap["curr_count"], np.float32),
                _shift_ts(snap["window_idx"], shift // self.window_ticks),
                np.asarray(snap["exists"], bool)]

    def _sweep_launch(self, now: int) -> torch.Tensor:
        return ck.fp_sweep_windows(self.fp, self.state, now,
                                   self.window_ticks)

    def force_rebase(self, offset: int) -> None:
        with self._lock:
            K.rebase_window_epoch(self.state, offset // self.window_ticks)
