"""The device-resident key directory: probe and claim on fingerprints.

The JAX package's ``ops/fp_directory.py`` on PyTorch: the table layout,
the placement, the host packing, and a PLAIN version of every function of
that module. The plain versions run when the tensors lie on the CPU (the
CPU tests and a CPU :class:`~..runtime.fp_store.FingerprintBucketStore`);
they are the oracle the hand kernels of ``csrc/fp_directory.cu``
(:mod:`.cuda_kernels`) are held against on the card.

- **Table**: ``fp i32[N, 2]`` — each row the (lo, hi) halves of a key's
  64-bit fingerprint, stored as the bits of the JAX package's ``u32[N, 2]``
  (PyTorch's integer ops are signed; a snapshot hands numpy ``uint32``
  back). ``(0, 0)`` marks an empty cell; the host hasher never emits it.
  Bucket and window state stay the ordinary SoA tables; a freshly claimed
  cell keeps ``exists = False`` so the decision's init-on-miss starts it.
- **Placement** (v2, non-wrapping): a key's probe window is the ``L``
  cells from ``base = ((lo * 0x9E3779B1) ^ hi) mod (N - L + 1)``, in
  uint32 arithmetic, bit for bit the JAX package's, so that a JAX snapshot
  installs verbatim with every key at its JAX cell. A lookup scans the
  whole window (it never stops at an empty cell), so clearing a cell can
  hide no other key.
- **Shard regions** (the mesh's tables, ``parallel/fp_sharded.py``): with
  ``n_shards`` the table is that many equal regions of ``P = N /
  n_shards`` cells, shard-major, and a key lives in region ``s = lo mod
  n_shards`` at ``s * P + base``, ``base`` as above with ``P`` for ``N``:
  JAX's per-shard tables laid end to end. ``n_shards = 1`` is the
  placement above.
- **Claim**: a row whose key is absent claims the first empty cell of its
  window in the rotated order from ``pref = (lo ^ hi * 0x85EBCA6B) mod L``
  (duplicates of one new key pick the same cell). Here, as in JAX, each of
  ``R`` rounds scatters the claimants' whole rows and re-reads who won: a
  contested cell goes to the LAST claimant row, as XLA's scatter on the CPU
  leaves it. Rows still unresolved after ``R`` rounds get slot ``-1`` and
  are denied; padding rows count as resolved.
- **Sweeps** clear ``exists`` AND the cell of every expired slot.

Collision disclosure (the JAX package's): two keys share a bucket iff
their 64-bit fingerprints collide, probability about n²/2⁶⁵.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import kernels as K

__all__ = [
    "PLACEMENT_VERSION",
    "MIX",
    "PREF_MIX",
    "init_fp_table",
    "FpResolveOut",
    "base_index_np",
    "pref_index_np",
    "find_np",
    "check_table_np",
    "fp_resolve",
    "fp_acquire_batch",
    "fp_acquire_scan_fused",
    "fp_acquire_scan_fused_bits",
    "pack_fp12",
    "fp_prefix_float",
    "fp_debit_batch",
    "fp_peek_batch",
    "fp_sweep_expired",
    "fp_migrate_chunk",
    "fp_window_acquire_batch",
    "fp_window_acquire_scan_fused",
    "fp_window_acquire_scan_fused_bits",
    "fp_sweep_windows",
    "fp_migrate_window_chunk",
]

#: Golden-ratio multiplier of the base probe index (uint32 arithmetic).
MIX = 0x9E3779B1
#: Multiplier of the high half in a key's claim preference.
PREF_MIX = 0x85EBCA6B
#: Placement-mapping version carried in checkpoints: 2 = the non-wrapping
#: window ``base = h mod (N - L + 1)``; 1 or absent = the old wrapping
#: ``h mod N``, which a restore re-places through the migrate kernel.
PLACEMENT_VERSION = 2

_M32 = 0xFFFFFFFF


def init_fp_table(n: int, device="cpu") -> torch.Tensor:
    """Empty fingerprint table: ``i32[n, 2]`` of zeros."""
    return torch.zeros((n, 2), dtype=torch.int32, device=device)


class FpResolveOut(NamedTuple):
    fp: torch.Tensor        # i32[N, 2], the table after claims (in place)
    slots: torch.Tensor     # i64[B], each row's cell, -1 unresolved
    resolved: torch.Tensor  # bool[B], False only under window pressure


# -- placement ---------------------------------------------------------------
def _u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bits read as uint32, in int64."""
    return t.to(torch.int64) & _M32


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for uint32 ``a`` held in int64, in two 16-bit
    halves of ``c`` so that no product leaves int64."""
    lo = (a * (c & 0xFFFF)) & _M32
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _base_index(kpair: torch.Tensor, n: int, probe_window: int,
                n_shards: int = 1):
    lo, hi = _u32(kpair[:, 0]), _u32(kpair[:, 1])
    per = n // n_shards
    base = (_mul32(lo, MIX) ^ hi) % (per - probe_window + 1)
    return base if n_shards == 1 else (lo % n_shards) * per + base


def _pref_index(kpair: torch.Tensor, probe_window: int):
    lo, hi = _u32(kpair[:, 0]), _u32(kpair[:, 1])
    return (lo ^ _mul32(hi, PREF_MIX)) % probe_window


def base_index_np(fps: np.ndarray, n: int, probe_window: int,
                  n_shards: int = 1) -> np.ndarray:
    """Each fingerprint's first window cell, ``fps u32[B, 2]`` → ``i64[B]``
    (numpy's uint32 products wrap as the JAX package's do). With
    ``n_shards`` shard regions of ``n / n_shards`` cells, a key's window
    lies in region ``lo % n_shards`` (the mesh's route), placed there as in
    a table of the region's size."""
    fps = np.asarray(fps, np.uint32)
    per = n // n_shards
    h = (fps[:, 0] * np.uint32(MIX)) ^ fps[:, 1]
    base = (h % np.uint32(per - probe_window + 1)).astype(np.int64)
    shard = (fps[:, 0] % np.uint32(n_shards)).astype(np.int64)
    return shard * per + base


def pref_index_np(fps: np.ndarray, probe_window: int) -> np.ndarray:
    """Each fingerprint's first claim position in its window."""
    fps = np.asarray(fps, np.uint32)
    return ((fps[:, 0] ^ (fps[:, 1] * np.uint32(PREF_MIX)))
            % np.uint32(probe_window)).astype(np.int64)


def find_np(fp: np.ndarray, fps: np.ndarray, probe_window: int,
            n_shards: int = 1) -> np.ndarray:
    """Host lookup of fingerprints ``fps u32[M, 2]`` in a table read back
    (``fp u32[N, 2]``): each key's cell, -1 where absent. Tables compare by
    key through it: which cell a key won may differ, its state may not."""
    fp = np.ascontiguousarray(fp, np.uint32).view(np.uint64).reshape(-1)
    key = np.ascontiguousarray(fps, np.uint32).view(np.uint64).reshape(-1)
    widx = (base_index_np(fps, len(fp), probe_window, n_shards)[:, None]
            + np.arange(probe_window)[None, :])
    match = fp[widx] == key[:, None]
    return np.where(match.any(1), widx[np.arange(len(key)),
                                       match.argmax(1)], -1)


def check_table_np(fp: np.ndarray, probe_window: int,
                   n_shards: int = 1) -> int:
    """The table's invariants, raising ``AssertionError`` on a breach: no
    fingerprint holds two cells, and every claimed cell lies in its key's
    probe window. Returns the claimed cells."""
    fp = np.ascontiguousarray(fp, np.uint32)
    cells = np.nonzero((fp != 0).any(1))[0]
    live = fp[cells]
    packed = live.view(np.uint64).reshape(-1)
    assert len(np.unique(packed)) == len(packed), "a key holds two cells"
    base = base_index_np(live, len(fp), probe_window, n_shards)
    inside = (cells >= base) & (cells < base + probe_window)
    assert inside.all(), "a claimed cell lies outside its key's window"
    return len(cells)


def _as64(pairs: torch.Tensor) -> torch.Tensor:
    """``i32[M, 2]`` rows as one int64 each (lo in the low word)."""
    return pairs.contiguous().view(torch.int64).view(-1)


def _check_table(fp: torch.Tensor, probe_window: int,
                 n_shards: int = 1) -> int:
    n = fp.shape[0]
    if not fp.is_contiguous():
        raise ValueError("the fp table must be contiguous (it is updated "
                         "in place)")
    if n_shards < 1 or n % n_shards:
        raise ValueError(f"fp table of {n} slots does not split into "
                         f"{n_shards} shard regions")
    if n // n_shards < probe_window:
        raise ValueError(f"fp table of {n} slots ({n // n_shards} a shard) "
                         f"is smaller than probe_window {probe_window}")
    return n


def _probe(cells64, widx, key64, slots, resolved):
    """One match pass over every row's window: rows whose key is present
    and not yet resolved take the first matching cell."""
    cells = cells64[widx]                                  # [B, L]
    occ = cells != 0
    match = occ & (cells == key64[:, None])
    hit = match.any(1) & ~resolved
    hpos = torch.argmax(match.to(torch.int8), 1)
    rows = torch.arange(widx.shape[0])
    slots = torch.where(hit, widx[rows, hpos], slots)
    return slots, resolved | hit, occ


def fp_resolve(fp: torch.Tensor, kpair: torch.Tensor, valid: torch.Tensor, *,
               probe_window: int, rounds: int, claim: bool = True,
               n_shards: int = 1) -> FpResolveOut:
    """Find or claim a cell for each fingerprint (plain version, in place).

    ``kpair i32[B, 2]`` (never ``(0, 0)`` on a valid row), ``valid
    bool[B]`` (padding rows neither match nor claim). With ``claim=False``
    a lookup only: absent keys stay unresolved (slot -1). ``n_shards``
    splits the table into that many equal regions, shard-major, and places
    each key in region ``lo % n_shards`` as a table of the region's size
    would (:func:`base_index_np`): the JAX mesh's per-shard tables, one
    array. Rows of different regions never meet, so one call places every
    shard's rows as JAX's per-shard calls do."""
    n = _check_table(fp, probe_window, n_shards)
    b = kpair.shape[0]
    cells64 = _as64(fp)
    key64 = _as64(kpair)
    base = _base_index(kpair, n, probe_window, n_shards)
    widx = base[:, None] + torch.arange(probe_window)[None, :]
    slots = torch.full((b,), -1, dtype=torch.int64)
    resolved = ~valid
    slots, resolved, _ = _probe(cells64, widx, key64, slots, resolved)
    if not claim:
        return FpResolveOut(fp, torch.where(valid, slots, -1), resolved)
    rows = torch.arange(b)
    rot_idx = (_pref_index(kpair, probe_window)[:, None]
               + torch.arange(probe_window)[None, :]) % probe_window
    r = 0
    while r < rounds and not bool(resolved.all()):
        slots, resolved, occ = _probe(cells64, widx, key64, slots, resolved)
        free = ~occ
        need = ~resolved & free.any(1)
        first = torch.argmax(free.gather(1, rot_idx).to(torch.int8), 1)
        target = widx[rows, rot_idx[rows, first]]
        claimants = torch.nonzero(need).view(-1)
        if len(claimants):
            # One scatter of whole rows; a contested cell keeps its last
            # claimant row's fingerprint, as XLA's CPU scatter does.
            tgt = target[claimants]
            uniq, inv = torch.unique(tgt, return_inverse=True)
            last = torch.full((len(uniq),), -1, dtype=torch.int64)
            last.scatter_reduce_(0, inv, claimants, reduce="amax")
            cells64[uniq] = key64[last]
            won = torch.zeros(b, dtype=torch.bool)
            won[claimants] = cells64[tgt] == key64[claimants]
            slots = torch.where(won, target, slots)
            resolved = resolved | won
        r += 1
    return FpResolveOut(fp, slots, resolved)


# -- host packing -------------------------------------------------------------
def pack_fp12(fps: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Host packing of the fused fingerprint dispatches: ``u32[B, 3]`` =
    (lo, hi, count), padding rows marked by count ``0xFFFFFFFF``; ``counts``
    is the valid prefix's counts, clamped to ``[0, 2^31 - 1]`` (a negative
    count stays a valid row). 12 bytes a decision."""
    b = fps.shape[0]
    fused = np.empty((b, 3), np.uint32)
    fused[:, :2] = fps
    fused[:, 2] = np.uint32(0xFFFFFFFF)
    n = len(counts)
    fused[:n, 2] = np.clip(counts, 0, 2**31 - 1).astype(np.uint32)
    return fused


def _unpack_fp12(fused: torch.Tensor):
    """``i32[..., 3]`` (the bits of :func:`pack_fp12`) → ``(kpair, counts,
    valid)``: the count read as int32 makes padding exactly -1."""
    counts = fused[..., 2]
    return fused[..., :2], torch.clamp_min(counts, 0), counts >= 0


def _bitpack2(granted: torch.Tensor, resolved: torch.Tensor) -> torch.Tensor:
    """Two ``bool[B]`` planes → ``u8[2, B/8]``, little-endian within each
    byte: plane 0 grants, plane 1 resolve status."""
    return K.pack_grant_bits(torch.stack([granted, resolved]))


def fp_prefix_float(fps: np.ndarray, amounts: np.ndarray) -> np.ndarray:
    """The same-key prefix of earlier float32 amounts, keyed by fingerprint
    (within one table state a fingerprint and a cell are one-to-one), in
    :func:`bucket_math.duplicate_prefix_float`'s order: one float32 add at
    a time, in request order. Returns ``f32[B]``."""
    fps = np.ascontiguousarray(fps, np.uint32)
    ids = fps.view(np.int64).reshape(-1)
    return bm.duplicate_prefix_float(
        torch.from_numpy(ids), torch.from_numpy(
            np.asarray(amounts, np.float32)),
        torch.ones(len(ids), dtype=torch.bool)).numpy()


# -- bucket decisions ----------------------------------------------------------
def fp_acquire_batch(fp, state: K.BucketState, kpair, counts, valid, now,
                     capacity, fill_rate_per_tick, *, probe_window: int = 16,
                     rounds: int = 4, handle_duplicates: bool = True,
                     n_shards: int = 1):
    """Resolve, then the bucket decision (``acquire_core``) for one batch;
    unresolved rows are denied with remaining 0. Returns ``(fp, state,
    granted, remaining, resolved)``, table and state updated in place.
    ``n_shards``: :func:`fp_resolve`'s shard regions."""
    out = fp_resolve(fp, kpair, valid, probe_window=probe_window,
                     rounds=rounds, n_shards=n_shards)
    live = valid & out.resolved
    _, granted, remaining = K.acquire_core(
        state, out.slots.to(torch.int32), counts, live, now, capacity,
        fill_rate_per_tick, handle_duplicates=handle_duplicates)
    return fp, state, granted, remaining, out.resolved


def _scan(step, fp, state, fused_k, nows_k):
    """K batches in order over the 12-byte operand ``i32[K, B, 3]``; each
    batch is ``step(kpair, counts, valid, now) -> (granted, remaining,
    resolved)``."""
    results = []
    for k in range(fused_k.shape[0]):
        kpair, counts, valid = _unpack_fp12(fused_k[k])
        results.append(step(kpair.contiguous(), counts, valid,
                            int(nows_k[k])))
    return results


def _code_out(results) -> torch.Tensor:
    """``f32[K, 2, B]``: row 0 ``granted + 2 * resolved``, row 1
    remaining."""
    return torch.stack([
        torch.stack([g.to(torch.float32) + 2.0 * r.to(torch.float32), rem])
        for g, rem, r in results])


def _bits_out(results) -> torch.Tensor:
    """``u8[K, 2, B/8]``: grant and resolve bit planes per batch."""
    return torch.stack([_bitpack2(g, r) for g, _, r in results])


def _bucket_step(fp, state, capacity, rate, probe_window, rounds,
                 handle_duplicates, n_shards):
    def step(kpair, counts, valid, now):
        return fp_acquire_batch(fp, state, kpair, counts, valid, now,
                                capacity, rate, probe_window=probe_window,
                                rounds=rounds,
                                handle_duplicates=handle_duplicates,
                                n_shards=n_shards)[2:]
    return step


def fp_acquire_scan_fused(fp, state: K.BucketState, fused_k, nows_k,
                          capacity, fill_rate_per_tick, *,
                          probe_window: int = 16, rounds: int = 4,
                          handle_duplicates: bool = True,
                          n_shards: int = 1):
    """The fingerprint bulk lane with remaining: ``fused_k i32[K, B, 3]``
    (:func:`pack_fp12`'s bits), ``nows_k i32[K]``; K batches resolved and
    decided in order. Returns ``(fp, state, out f32[K, 2, B])``, row 0
    ``granted + 2 * resolved``, row 1 remaining."""
    step = _bucket_step(fp, state, capacity, fill_rate_per_tick,
                        probe_window, rounds, handle_duplicates, n_shards)
    return fp, state, _code_out(_scan(step, fp, state, fused_k, nows_k))


def fp_acquire_scan_fused_bits(fp, state: K.BucketState, fused_k, nows_k,
                               capacity, fill_rate_per_tick, *,
                               probe_window: int = 16, rounds: int = 4,
                               handle_duplicates: bool = True,
                               n_shards: int = 1):
    """The verdict-only fingerprint bulk lane: returns ``(fp, state, bits
    u8[K, 2, B/8])`` (grant plane, resolve plane; ``B % 8 == 0``)."""
    step = _bucket_step(fp, state, capacity, fill_rate_per_tick,
                        probe_window, rounds, handle_duplicates, n_shards)
    return fp, state, _bits_out(_scan(step, fp, state, fused_k, nows_k))


def fp_debit_batch(fp, state: K.BucketState, kpair, amounts, valid, now,
                   capacity, fill_rate_per_tick, *, probe_window: int = 16,
                   rounds: int = 4):
    """Saturating debit with in-kernel resolution (a negative amount
    credits): resolve with claim-on-miss, then ``debit_batch_packed``'s
    rule with the float same-cell prefix. Unresolved valid rows apply
    nothing and report ``(0, max(amount, 0))``. Returns ``(fp, state, out
    f32[2, B])``: post-debit balance, shortfall."""
    out = fp_resolve(fp, kpair, valid, probe_window=probe_window,
                     rounds=rounds)
    live = valid & out.resolved
    amounts = amounts.to(torch.float32)
    b = kpair.shape[0]
    packed = torch.empty((4, b), dtype=torch.int32)
    packed[0] = torch.where(live, out.slots, -1).to(torch.int32)
    packed[1] = amounts.view(torch.int32)
    packed[2] = int(now)
    packed[3] = bm.duplicate_prefix_float(
        out.slots, amounts, live).view(torch.int32)
    _, res = K.debit_batch_packed(state, packed, capacity,
                                  fill_rate_per_tick)
    lost = valid & ~out.resolved
    res[0] = torch.where(lost, 0.0, res[0])
    res[1] = torch.where(lost, torch.clamp_min(amounts, 0.0), res[1])
    return fp, state, res


def fp_peek_batch(fp, state: K.BucketState, kpair, valid, now, capacity,
                  fill_rate_per_tick, *, probe_window: int = 16,
                  n_shards: int = 1):
    """Read-only availability ``floor(refilled)``: a lookup without claim;
    an absent key reads a full bucket. Returns ``f32[B]``."""
    out = fp_resolve(fp, kpair, valid, probe_window=probe_window, rounds=0,
                     claim=False, n_shards=n_shards)
    hit = out.slots >= 0
    gs = torch.where(hit, out.slots, 0)
    refilled = bm.refill_or_init(
        state.tokens[gs], state.last_ts[gs], state.exists[gs] & hit, now,
        capacity, fill_rate_per_tick)
    return torch.where(valid, torch.floor(refilled),
                       torch.zeros_like(refilled))


def fp_sweep_expired(fp, state: K.BucketState, now, capacity,
                     fill_rate_per_tick) -> torch.Tensor:
    """TTL eviction (``sweep_expired``'s rule) that clears ``exists`` AND
    the cell of every expired slot, in place. Returns ``n_freed i32[1]``."""
    _, expired = K.sweep_expired(state, now, capacity, fill_rate_per_tick)
    fp[expired] = 0
    return expired.sum(dtype=torch.int32).view(1)


def _migrate(fp, state, kpair, cols, valid, probe_window, rounds, n_shards):
    out = fp_resolve(fp, kpair, valid, probe_window=probe_window,
                     rounds=rounds, n_shards=n_shards)
    live = valid & out.resolved
    idx = out.slots[live]
    for dst, col in zip(state, cols):
        dst[idx] = col[live].to(dst.dtype)
    return fp, state, live


def fp_migrate_chunk(fp, state: K.BucketState, kpair, tokens, last_ts,
                     exists, valid, *, probe_window: int = 16,
                     rounds: int = 4, n_shards: int = 1):
    """Growth and re-placement step: claim cells in the (new) table for a
    chunk of old entries and write their state columns there. Returns
    ``(fp, state, placed bool[B])``; the host retries unplaced rows."""
    return _migrate(fp, state, kpair, (tokens, last_ts, exists), valid,
                    probe_window, rounds, n_shards)


# -- windows -------------------------------------------------------------------
def fp_window_acquire_batch(fp, state: K.WindowState, kpair, counts, valid,
                            now, limit, window_ticks, *,
                            probe_window: int = 16, rounds: int = 4,
                            handle_duplicates: bool = True,
                            interpolate: bool = True, n_shards: int = 1):
    """Resolve, then the sliding (or, ``interpolate=False``, fixed) window
    decision for one batch. Returns ``(fp, state, granted, remaining,
    resolved)``."""
    out = fp_resolve(fp, kpair, valid, probe_window=probe_window,
                     rounds=rounds, n_shards=n_shards)
    live = valid & out.resolved
    _, granted, remaining = K.window_acquire_core(
        state, out.slots.to(torch.int32), counts, live, now, limit,
        window_ticks, handle_duplicates=handle_duplicates,
        interpolate=interpolate)
    return fp, state, granted, remaining, out.resolved


def _window_step(fp, state, limit, window_ticks, probe_window, rounds,
                 handle_duplicates, interpolate, n_shards):
    def step(kpair, counts, valid, now):
        return fp_window_acquire_batch(
            fp, state, kpair, counts, valid, now, limit, window_ticks,
            probe_window=probe_window, rounds=rounds,
            handle_duplicates=handle_duplicates,
            interpolate=interpolate, n_shards=n_shards)[2:]
    return step


def fp_window_acquire_scan_fused(fp, state: K.WindowState, fused_k, nows_k,
                                 limit, window_ticks, *,
                                 probe_window: int = 16, rounds: int = 4,
                                 handle_duplicates: bool = True,
                                 interpolate: bool = True,
                                 n_shards: int = 1):
    """The window bulk lane with remaining: ``(fp, state, out f32[K, 2,
    B])`` as :func:`fp_acquire_scan_fused`."""
    step = _window_step(fp, state, limit, window_ticks, probe_window, rounds,
                        handle_duplicates, interpolate, n_shards)
    return fp, state, _code_out(_scan(step, fp, state, fused_k, nows_k))


def fp_window_acquire_scan_fused_bits(fp, state: K.WindowState, fused_k,
                                      nows_k, limit, window_ticks, *,
                                      probe_window: int = 16,
                                      rounds: int = 4,
                                      handle_duplicates: bool = True,
                                      interpolate: bool = True,
                                      n_shards: int = 1):
    """The verdict-only window bulk lane: ``(fp, state, bits u8[K, 2,
    B/8])``."""
    step = _window_step(fp, state, limit, window_ticks, probe_window, rounds,
                        handle_duplicates, interpolate, n_shards)
    return fp, state, _bits_out(_scan(step, fp, state, fused_k, nows_k))


def fp_sweep_windows(fp, state: K.WindowState, now,
                     window_ticks) -> torch.Tensor:
    """Window TTL eviction (two whole windows idle) that clears ``exists``
    and the cell, in place. Returns ``n_freed i32[1]``."""
    _, expired = K.sweep_windows(state, now, window_ticks)
    fp[expired] = 0
    return expired.sum(dtype=torch.int32).view(1)


def fp_migrate_window_chunk(fp, state: K.WindowState, kpair, prev_count,
                            curr_count, window_idx, exists, valid, *,
                            probe_window: int = 16, rounds: int = 4,
                            n_shards: int = 1):
    """The window table's migrate step, four state columns. Returns
    ``(fp, state, placed bool[B])``."""
    return _migrate(fp, state, kpair,
                    (prev_count, curr_count, window_idx, exists), valid,
                    probe_window, rounds, n_shards)
