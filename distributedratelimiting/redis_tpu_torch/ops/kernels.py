"""L1 — the token-bucket, decaying-counter and window batch operations, as
plain PyTorch.

These are the PLAIN versions of the JAX package's ``ops/kernels.py`` bucket,
counter and window families: torch operations with the same names, operand
layouts and result layouts (``i32[4, B]`` / ``i32[5, B]`` in, ``f32[2, B]``
out, ``f32[K, 2, B]`` and little-endian bit-packed ``u8[K, B/8]`` for the
scanned bulk lane; ``i32[3, B]`` in and ``f32[2, B]`` out for a counter
sync). The window family (sliding windows, and fixed windows with
``interpolate=False``) takes the bucket family's operands. The semaphore
batch (``i32[4, B]``: slots, signed deltas, limits, tick), the two-level
tenant → key admission over two bucket tables (``i32[4, B]``: child slots,
costs, tick, parent slots) and the saturating debit (``i32[3, B]``, or
``i32[4, B]`` with the host's float prefix) return ``f32[2, B]`` too.
They run whenever the state lies on the CPU, and they are the oracle the
hand-written CUDA kernels (:mod:`.cuda_kernels`) are held against on the card.

State is structure-of-arrays — ``tokens: f32[N]``, ``last_ts: i32[N]``,
``exists: bool[N]``, 9 bytes/key (a counter table: ``value``, ``period``,
``last_ts``, ``exists``, 13 bytes; a window table: ``prev_count``,
``curr_count``, ``window_idx``, ``exists``, 13 bytes; a semaphore table:
``active``, ``last_ts``, ``exists``, 9 bytes). Where the JAX kernels
donate the state buffers and return new ones, these functions update the
state tensors IN PLACE and return the same state tuple, so the table is
never double-buffered.

Padding rows (slot < 0 or slot ≥ N) are masked out before any
``index_put_``/``index_add_``: JAX drops them by sending them to index ``N``
with ``mode="drop"``, whereas a negative index would wrap in PyTorch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm

__all__ = [
    "BucketState",
    "init_bucket_state",
    "acquire_core",
    "acquire_batch",
    "acquire_batch_packed",
    "acquire_batch_packed_grouped",
    "acquire_scan_packed",
    "acquire_scan_fused_packed",
    "acquire_scan_fused_bits",
    "pack_compact5",
    "pack_grant_bits",
    "SLOT24_PAD",
    "pack_slots24",
    "acquire_scan_compact_fused",
    "acquire_scan_packed24",
    "sweep_expired",
    "peek_batch_packed",
    "rebase_bucket_epoch",
    "CounterState",
    "init_counter_state",
    "sync_batch",
    "sync_batch_packed",
    "sweep_counters",
    "rebase_counter_epoch",
    "WindowState",
    "init_window_state",
    "window_acquire_core",
    "window_acquire_batch",
    "window_acquire_batch_packed",
    "window_acquire_batch_packed_grouped",
    "window_acquire_scan",
    "window_acquire_scan_fused_bits",
    "window_acquire_scan_fused_packed",
    "window_acquire_scan_compact",
    "sweep_windows",
    "rebase_window_epoch",
    "SemaState",
    "init_sema_state",
    "sema_batch_packed",
    "sweep_semas",
    "rebase_sema_epoch",
    "acquire_hierarchical_packed",
    "debit_batch_packed",
]


class BucketState(NamedTuple):
    """SoA token-bucket table: balances, last-touch ticks, occupancy."""

    tokens: torch.Tensor   # f32[N]
    last_ts: torch.Tensor  # i32[N]
    exists: torch.Tensor   # bool[N]


def init_bucket_state(n: int, device="cpu") -> BucketState:
    return BucketState(
        tokens=torch.zeros((n,), dtype=torch.float32, device=device),
        last_ts=torch.zeros((n,), dtype=torch.int32, device=device),
        exists=torch.zeros((n,), dtype=torch.bool, device=device),
    )


class CounterState(NamedTuple):
    """SoA decaying-counter table ≙ the Redis hash ``{v, p, t}``."""

    value: torch.Tensor    # f32[N] decaying throttle score
    period: torch.Tensor   # f32[N] EWMA of the inter-sync interval (ticks)
    last_ts: torch.Tensor  # i32[N]
    exists: torch.Tensor   # bool[N]


def init_counter_state(n: int, device="cpu") -> CounterState:
    return CounterState(
        value=torch.zeros((n,), dtype=torch.float32, device=device),
        period=torch.zeros((n,), dtype=torch.float32, device=device),
        last_ts=torch.zeros((n,), dtype=torch.int32, device=device),
        exists=torch.zeros((n,), dtype=torch.bool, device=device),
    )


class WindowState(NamedTuple):
    """SoA two-counter window table (BASELINE config 4)."""

    prev_count: torch.Tensor  # f32[N]
    curr_count: torch.Tensor  # f32[N]
    window_idx: torch.Tensor  # i32[N]
    exists: torch.Tensor      # bool[N]


def init_window_state(n: int, device="cpu") -> WindowState:
    return WindowState(
        prev_count=torch.zeros((n,), dtype=torch.float32, device=device),
        curr_count=torch.zeros((n,), dtype=torch.float32, device=device),
        window_idx=torch.zeros((n,), dtype=torch.int32, device=device),
        exists=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def _valid_slots(slots, valid, size: int):
    """A row is live only if marked valid AND its slot is in range — an
    out-of-range slot must become a denied padding row, not a phantom grant."""
    return valid & (slots >= 0) & (slots < size)


def _gather(state: BucketState, slots, valid):
    """Each row's ``(tokens, last_ts, exists)``; invalid rows read slot 0 and
    their results are masked out by the caller."""
    gs = torch.where(valid, slots, torch.zeros_like(slots)).long()
    return state.tokens[gs], state.last_ts[gs], state.exists[gs]


def _scatter(state: BucketState, slots, valid, refilled, consumed, now):
    """Write back the valid rows: every duplicate of a slot writes the same
    refilled value (same ``now``, same old state), then consumption
    accumulates with a scatter-add."""
    idx = slots[valid].long()
    state.tokens.index_put_((idx,), refilled[valid])
    state.tokens.index_add_(0, idx, -consumed[valid])
    state.last_ts.index_fill_(0, idx, int(now))
    state.exists.index_fill_(0, idx, True)


def acquire_core(state: BucketState, slots, counts, valid, now, capacity,
                 fill_rate_per_tick, *, handle_duplicates: bool = True,
                 prefix=None):
    """Gather → refill → all-or-nothing grant → scatter for one batch.

    ``slots i32[B]`` (out-of-range ⇒ padding), ``counts i32[B]`` (0 is a
    probe), ``valid bool[B]``, ``now`` the batch tick. ``prefix f32[B]``
    overrides the in-batch same-slot demand (the host computes it during
    batch assembly); otherwise it comes from :func:`bm.duplicate_prefix`.
    Returns ``(state, granted bool[B], remaining f32[B])``, the state
    updated in place."""
    valid = _valid_slots(slots, valid, state.tokens.shape[0])
    t_old, ts_old, ex_old = _gather(state, slots, valid)
    counts_f = counts.to(torch.float32)
    refilled = bm.refill_or_init(t_old, ts_old, ex_old, now, capacity,
                                 fill_rate_per_tick)
    if prefix is None and handle_duplicates:
        prefix = bm.duplicate_prefix(slots, counts, valid)
    elif prefix is None:
        prefix = torch.zeros_like(counts_f)
    else:
        prefix = prefix.to(torch.float32)

    zero = torch.zeros_like(counts_f)
    granted = valid & (refilled >= prefix + counts_f)
    consumed = torch.where(granted, counts_f, zero)
    remaining = torch.where(
        valid, torch.clamp_min(refilled - prefix - consumed, 0.0), zero)
    _scatter(state, slots, valid, refilled, consumed, now)
    return state, granted, remaining


def acquire_batch(state: BucketState, slots, counts, valid, now, capacity,
                  fill_rate_per_tick, *, handle_duplicates: bool = True):
    """One batch from separate operands: ``slots i32[B]`` (out of range ⇒
    padding), ``counts i32[B]``, ``valid bool[B]``, ``now`` the batch tick.
    ``handle_duplicates=False`` gives every row prefix 0 and then applies
    every granted row's count, as JAX does: rows of one slot may then all be
    granted from the same balance, which can go below zero. Returns ``(state,
    granted bool[B], remaining f32[B])``, the state updated in place."""
    return acquire_core(state, slots, counts, valid, now, capacity,
                        fill_rate_per_tick,
                        handle_duplicates=handle_duplicates)


def _unpack_requests(packed):
    """Split the packed ``i32[4, B]`` flush operand: row 0 slots (negative ⇒
    padding), row 1 counts, row 2 the broadcast batch tick, row 3 the
    host-computed same-slot demand prefix."""
    slots = packed[0]
    return slots, packed[1], slots >= 0, packed[2, 0], packed[3]


def acquire_batch_packed(state: BucketState, packed, capacity,
                         fill_rate_per_tick):
    """One serving flush: ``packed i32[4, B]`` in, ``out f32[2, B]`` back
    (row 0 granted as 0/1, row 1 remaining). Returns ``(state, out)``."""
    slots, counts, valid, now, prefix = _unpack_requests(packed)
    state, granted, remaining = acquire_core(
        state, slots, counts, valid, now, capacity, fill_rate_per_tick,
        prefix=prefix)
    return state, torch.stack([granted.to(torch.float32), remaining])


def acquire_batch_packed_grouped(state: BucketState, packed, capacity,
                                 fill_rate_per_tick):
    """Coalesced-duplicates flush: one row per ``(key, count)`` group.

    ``packed i32[5, B]``: rows 0-3 as :func:`acquire_batch_packed`, row 4 the
    group size ``n``. The first ``clamp(floor((refilled − prefix) / c), 0,
    n)`` members are granted (a ``c == 0`` probe group grants all ``n`` iff
    the balance covers the prefix) — bit-identical to ``n`` per-row
    decisions with cumulative prefixes. Returns ``(state, out f32[2, B])``
    with ``out[0] = n_granted`` and ``out[1]`` the post-consumption
    remaining."""
    slots, counts, now = packed[0], packed[1], packed[2, 0]
    prefix = packed[3].to(torch.float32)
    n = packed[4].to(torch.float32)
    valid = _valid_slots(slots, slots >= 0, state.tokens.shape[0])
    t_old, ts_old, ex_old = _gather(state, slots, valid)
    refilled = bm.refill_or_init(t_old, ts_old, ex_old, now, capacity,
                                 fill_rate_per_tick)
    c = counts.to(torch.float32)
    zero = torch.zeros_like(c)
    avail = refilled - prefix
    n_granted = torch.where(
        c > 0,
        torch.minimum(torch.clamp_min(
            torch.floor(avail / torch.clamp_min(c, 1.0)), 0.0), n),
        torch.where(avail >= 0, n, zero),
    )
    n_granted = torch.where(valid, n_granted, zero)
    consumed = n_granted * c
    remaining = torch.where(valid, torch.clamp_min(avail - consumed, 0.0),
                            zero)
    _scatter(state, slots, valid, refilled, consumed, now)
    return state, torch.stack([n_granted, remaining])


def acquire_scan_packed(state: BucketState, slots_k, counts_k, nows_k,
                        capacity, fill_rate_per_tick):
    """K batches decided one after another, each with its own tick and the
    in-batch duplicate serialization of :func:`bm.duplicate_prefix`
    (``lax.scan`` in the JAX package becomes a loop). ``slots_k i32[K, B]``
    (negative ⇒ padding), ``counts_k i32[K, B]``, ``nows_k i32[K]``.
    Returns ``(state, out f32[K, 2, B])``."""
    outs = []
    for k in range(slots_k.shape[0]):
        slots = slots_k[k]
        state, granted, remaining = acquire_core(
            state, slots, counts_k[k], slots >= 0, nows_k[k], capacity,
            fill_rate_per_tick)
        outs.append(torch.stack([granted.to(torch.float32), remaining]))
    return state, torch.stack(outs)


def _unpack_compact5(fused):
    """Unpack the :func:`pack_compact5` layout ``u8[..., 5]``: a
    little-endian int32 slot from bytes 0-3 (reinterpreted, so the -1
    padding survives the sign bit) and the count from byte 4."""
    slots = fused[..., :4].contiguous().view(torch.int32).squeeze(-1)
    return slots, fused[..., 4].to(torch.int32)


def acquire_scan_fused_packed(state: BucketState, fused, nows_k, capacity,
                              fill_rate_per_tick):
    """Bulk lane, one fused ``u8[K, B, 5]`` operand in, ``f32[K, 2, B]``
    back (row 0 grants, row 1 remaining)."""
    slots_k, counts_k = _unpack_compact5(fused)
    return acquire_scan_packed(state, slots_k, counts_k, nows_k, capacity,
                               fill_rate_per_tick)


def pack_grant_bits(granted):
    """``bool[K, B]`` → little-endian bit-packed ``u8[K, B/8]``
    (``B % 8 == 0``; host side ``np.unpackbits(..., bitorder="little")``)."""
    weights = torch.tensor([1 << i for i in range(8)], dtype=torch.int32,
                           device=granted.device)
    g = granted.to(torch.int32).reshape(*granted.shape[:-1], -1, 8)
    return (g * weights).sum(-1).to(torch.uint8)


def acquire_scan_fused_bits(state: BucketState, fused, nows_k, capacity,
                            fill_rate_per_tick):
    """Verdict-only bulk lane: grants come back bit-packed ``u8[K, B/8]``."""
    state, out = acquire_scan_fused_packed(state, fused, nows_k, capacity,
                                           fill_rate_per_tick)
    return state, pack_grant_bits(out[:, 0] > 0.5)


def pack_compact5(slots, counts) -> np.ndarray:
    """Host-side packing for the bulk lane: i32 slot ids (-1 = padding) +
    u8 counts → little-endian ``u8[..., 5]`` (bytes 0-3 the slot, byte 4 the
    count), so a whole chunk travels to the device as ONE array."""
    slots = np.asarray(slots, np.int32)
    out = np.empty((*slots.shape, 5), np.uint8)
    out[..., :4] = slots.astype("<i4").view(np.uint8).reshape(*slots.shape, 4)
    out[..., 4] = counts
    return out


#: Padding id of the 3-byte slot operand (all 24 bits set).
SLOT24_PAD = (1 << 24) - 1


def pack_slots24(slots) -> np.ndarray:
    """Host-side packing for :func:`acquire_scan_packed24`: slot ids (or
    :data:`SLOT24_PAD` for padding) → little-endian ``u8[..., 3]``. Raises
    ``ValueError`` on an id outside ``[0, SLOT24_PAD]``, which would
    otherwise truncate to some other slot."""
    slots = np.asarray(slots)
    if slots.size and (slots.min() < 0 or slots.max() > SLOT24_PAD):
        raise ValueError(
            f"slot ids must be within [0, {SLOT24_PAD}] (SLOT24_PAD = "
            "padding); use acquire_scan_compact for larger tables")
    out = np.empty((*slots.shape, 3), np.uint8)
    out[..., 0] = slots & 0xFF
    out[..., 1] = (slots >> 8) & 0xFF
    out[..., 2] = (slots >> 16) & 0xFF
    return out


def _unpack_slots24(packed):
    """The 3-byte operand's slots as int32, :data:`SLOT24_PAD` as -1."""
    p = packed.to(torch.int32)
    slots = p[..., 0] | (p[..., 1] << 8) | (p[..., 2] << 16)
    return torch.where(slots == SLOT24_PAD, -1, slots)


def acquire_scan_compact_fused(state: BucketState, fused, nows_k, capacity,
                               fill_rate_per_tick):
    """The scan over the fused ``u8[K, B, 5]`` operand with JAX's results:
    returns ``(state, granted bool[K, B], remaining f32[K, B])``."""
    state, out = acquire_scan_fused_packed(state, fused, nows_k, capacity,
                                           fill_rate_per_tick)
    return state, out[:, 0] > 0.5, out[:, 1]


def acquire_scan_packed24(state: BucketState, packed, nows_k, capacity,
                          fill_rate_per_tick):
    """K batches of unit requests, 3 bytes a request: ``packed u8[K, B, 3]``
    from :func:`pack_slots24` (:data:`SLOT24_PAD` or an id ≥ N is padding),
    each batch at its tick ``nows_k i32[K]`` with the in-batch duplicate
    prefix. Returns ``(state, granted bool[K, B], remaining f32[K, B])``."""
    slots_k = _unpack_slots24(packed)
    state, out = acquire_scan_packed(state, slots_k,
                                     torch.ones_like(slots_k), nows_k,
                                     capacity, fill_rate_per_tick)
    return state, out[:, 0] > 0.5, out[:, 1]


def sweep_expired(state: BucketState, now, capacity, fill_rate_per_tick):
    """TTL eviction: a slot idle past its time-to-full TTL (clamped ``[1s,
    1yr]``) is indistinguishable from init-on-miss, so ``exists`` is
    cleared — in place. Returns ``(state, expired bool[N])``."""
    ttl = bm.time_to_full_ttl(state.tokens, capacity, fill_rate_per_tick)
    expired = state.exists & (bm.elapsed_ticks(now, state.last_ts) >= ttl)
    state.exists.logical_and_(~expired)
    return state, expired


def peek_batch_packed(state: BucketState, packed, capacity,
                      fill_rate_per_tick):
    """Read-only availability ``floor(refilled)`` per row of the packed
    operand (rows 1 and 3 are ignored); writes nothing."""
    slots, _, valid, now, _ = _unpack_requests(packed)
    valid = _valid_slots(slots, valid, state.tokens.shape[0])
    refilled = bm.refill_or_init(*_gather(state, slots, valid), now, capacity,
                                 fill_rate_per_tick)
    return torch.where(valid, torch.floor(refilled),
                       torch.zeros_like(refilled))


def rebase_bucket_epoch(state: BucketState, offset_ticks: int) -> BucketState:
    """Shift every live timestamp back by ``offset_ticks`` (clamped at 0), in
    place — paired with the clock's own rebase, so elapsed values are
    unchanged."""
    _rebase_ts(state.last_ts, state.exists, offset_ticks)
    return state


def _rebase_ts(last_ts, exists, offset_ticks: int) -> None:
    shifted = torch.clamp_min(last_ts - int(offset_ticks), 0)
    last_ts.copy_(torch.where(exists, shifted, last_ts))


def sync_batch(state: CounterState, slots, local_counts, valid, now,
               decay_rate_per_tick):
    """Batched decaying-counter sync — the approximate bucket's global tier
    over a batch of counters. Every valid row sets its slot to the decayed
    value, the new period EWMA, ``last_ts = now`` and ``exists``; THEN every
    valid row's count is added into its slot's value, so duplicate slots'
    adds accumulate. Each row's reply is its decayed value plus its OWN
    count. Invalid rows (and out-of-range slots) write nothing; their reply
    is computed from slot 0, as the JAX gather clamps them. Returns
    ``(state, global_scores f32[B], period_ewmas f32[B])``, the state
    updated in place."""
    valid = _valid_slots(slots, valid, state.value.shape[0])
    gs = torch.where(valid, slots, torch.zeros_like(slots)).long()
    counts_f = torch.as_tensor(local_counts).to(torch.float32)
    decayed, new_period = bm.decay_core(
        state.value[gs], state.period[gs], state.last_ts[gs],
        state.exists[gs], now, decay_rate_per_tick)
    new_value = decayed + counts_f
    idx = slots[valid].long()
    state.value.index_put_((idx,), decayed[valid])
    state.value.index_add_(0, idx, counts_f[valid])
    state.period.index_put_((idx,), new_period[valid])
    state.last_ts.index_fill_(0, idx, int(now))
    state.exists.index_fill_(0, idx, True)
    return state, new_value, new_period


def sync_batch_packed(state: CounterState, packed, decay_rate_per_tick):
    """:func:`sync_batch` with one operand and one result: ``packed i32[3,
    B]`` — row 0 slots (negative ⇒ padding), row 1 the float32 local counts
    bitcast to int32, row 2 the tick. Returns ``(state, out f32[2, B])``:
    the global scores and the period EWMAs."""
    slots = packed[0]
    counts = packed[1].contiguous().view(torch.float32)
    state, scores, periods = sync_batch(state, slots, counts, slots >= 0,
                                        packed[2, 0], decay_rate_per_tick)
    return state, torch.stack([scores, periods])


def sweep_counters(state: CounterState, now):
    """TTL eviction for the counter table: a fixed 86400 s TTL (the
    reference's ``EXPIRE`` on the global counter hash). Clears ``exists`` in
    place; returns ``(state, expired bool[N])``."""
    expired = state.exists & (bm.elapsed_ticks(now, state.last_ts)
                              >= bm.GLOBAL_COUNTER_TTL_TICKS)
    state.exists.logical_and_(~expired)
    return state, expired


def rebase_counter_epoch(state: CounterState,
                         offset_ticks: int) -> CounterState:
    """:func:`rebase_bucket_epoch` for the counter table."""
    _rebase_ts(state.last_ts, state.exists, offset_ticks)
    return state


def _window_gather(state: WindowState, slots, valid):
    """Each row's ``(prev_count, curr_count, window_idx, exists)``; invalid
    rows read slot 0 and their results are masked out by the caller."""
    gs = torch.where(valid, slots, torch.zeros_like(slots)).long()
    return (state.prev_count[gs], state.curr_count[gs], state.window_idx[gs],
            state.exists[gs])


def _window_advance(state: WindowState, slots, valid, now, window_ticks,
                    interpolate: bool):
    """Gather and advance every row's slot to ``now``; returns ``(prev_new,
    curr_new, idx_new, est)``, ``est`` the sliding estimate or, for a fixed
    window, the current count."""
    prev_new, curr_new, idx_new = bm.sliding_window_advance(
        *_window_gather(state, slots, valid), now, window_ticks)
    est = (bm.sliding_window_estimate(prev_new, curr_new, idx_new, now,
                                      window_ticks)
           if interpolate else curr_new)
    return prev_new, curr_new, idx_new, est


def _window_scatter(state: WindowState, slots, valid, prev_new, curr_new,
                    idx_new, consumed) -> None:
    """Write back the valid rows: every duplicate of a slot sets the same
    advanced state, then consumption accumulates into the current count."""
    idx = slots[valid].long()
    state.prev_count.index_put_((idx,), prev_new[valid])
    state.curr_count.index_put_((idx,), curr_new[valid])
    state.curr_count.index_add_(0, idx, consumed[valid])
    state.window_idx.index_put_((idx,), idx_new[valid])
    state.exists.index_fill_(0, idx, True)


def window_acquire_core(state: WindowState, slots, counts, valid, now, limit,
                        window_ticks, *, handle_duplicates: bool = True,
                        prefix=None, interpolate: bool = True):
    """Gather → advance → estimate → all-or-nothing grant → scatter for
    one batch of a window table. Granted iff ``est + prefix + count <= limit``
    (``interpolate=False``: ``est`` is the current window's count alone, the
    fixed window); ``remaining = max(((limit - est) - prefix) - consumed,
    0)``. Returns ``(state, granted bool[B], remaining f32[B])``, the state
    updated in place."""
    valid = _valid_slots(slots, valid, state.prev_count.shape[0])
    prev_new, curr_new, idx_new, est = _window_advance(
        state, slots, valid, now, window_ticks, interpolate)
    counts_f = counts.to(torch.float32)
    if prefix is None and handle_duplicates:
        prefix = bm.duplicate_prefix(slots, counts, valid)
    elif prefix is None:
        prefix = torch.zeros_like(counts_f)
    else:
        prefix = prefix.to(torch.float32)
    lim = torch.as_tensor(limit, dtype=torch.float32, device=counts_f.device)
    zero = torch.zeros_like(counts_f)
    granted = valid & (est + prefix + counts_f <= lim)
    consumed = torch.where(granted, counts_f, zero)
    remaining = torch.where(
        valid, torch.clamp_min(lim - est - prefix - consumed, 0.0), zero)
    _window_scatter(state, slots, valid, prev_new, curr_new, idx_new,
                    consumed)
    return state, granted, remaining


def window_acquire_batch(state: WindowState, slots, counts, valid, now, limit,
                         window_ticks, *, handle_duplicates: bool = True,
                         interpolate: bool = True):
    """Batched window acquire: :func:`window_acquire_core` with the
    in-batch duplicate prefix computed here."""
    return window_acquire_core(state, slots, counts, valid, now, limit,
                               window_ticks,
                               handle_duplicates=handle_duplicates,
                               interpolate=interpolate)


def window_acquire_batch_packed(state: WindowState, packed, limit,
                                window_ticks, *, interpolate: bool = True):
    """One window flush: ``packed i32[4, B]`` (as
    :func:`acquire_batch_packed`) in, ``out f32[2, B]`` back (grants,
    remaining). Returns ``(state, out)``."""
    slots, counts, valid, now, prefix = _unpack_requests(packed)
    state, granted, remaining = window_acquire_core(
        state, slots, counts, valid, now, limit, window_ticks, prefix=prefix,
        interpolate=interpolate)
    return state, torch.stack([granted.to(torch.float32), remaining])


def window_acquire_batch_packed_grouped(state: WindowState, packed, limit,
                                        window_ticks, *,
                                        interpolate: bool = True):
    """Coalesced-duplicates window flush (``packed i32[5, B]``, one row per
    ``(key, count)`` group): ``n_granted = clamp(floor(avail / max(c, 1)),
    0, n)`` with ``avail = (limit - est) - prefix`` (a ``c == 0`` probe group
    grants all ``n`` iff ``avail >= 0``). Returns ``(state, out f32[2, B])``:
    granted members per group, and the post-consumption remaining."""
    slots, counts, now = packed[0], packed[1], packed[2, 0]
    prefix = packed[3].to(torch.float32)
    n = packed[4].to(torch.float32)
    valid = _valid_slots(slots, slots >= 0, state.prev_count.shape[0])
    prev_new, curr_new, idx_new, est = _window_advance(
        state, slots, valid, now, window_ticks, interpolate)
    c = counts.to(torch.float32)
    zero = torch.zeros_like(c)
    avail = torch.as_tensor(limit, dtype=torch.float32,
                            device=c.device) - est - prefix
    n_granted = torch.where(
        c > 0,
        torch.minimum(torch.clamp_min(
            torch.floor(avail / torch.clamp_min(c, 1.0)), 0.0), n),
        torch.where(avail >= 0, n, zero),
    )
    n_granted = torch.where(valid, n_granted, zero)
    consumed = n_granted * c
    remaining = torch.where(valid, torch.clamp_min(avail - consumed, 0.0),
                            zero)
    _window_scatter(state, slots, valid, prev_new, curr_new, idx_new,
                    consumed)
    return state, torch.stack([n_granted, remaining])


def window_acquire_scan(state: WindowState, slots_k, counts_k, valid_k,
                        nows_k, limit, window_ticks, *,
                        handle_duplicates: bool = True,
                        interpolate: bool = True):
    """K window batches decided one after another, each at its own tick
    with its in-batch duplicate prefix (the JAX ``lax.scan`` as a loop).
    Returns ``(state, granted bool[K, B], remaining f32[K, B])``."""
    granted, remaining = [], []
    for k in range(slots_k.shape[0]):
        state, g, r = window_acquire_core(
            state, slots_k[k], counts_k[k], valid_k[k], nows_k[k], limit,
            window_ticks, handle_duplicates=handle_duplicates,
            interpolate=interpolate)
        granted.append(g)
        remaining.append(r)
    return state, torch.stack(granted), torch.stack(remaining)


def window_acquire_scan_fused_packed(state: WindowState, fused, nows_k, limit,
                                     window_ticks, *,
                                     handle_duplicates: bool = True,
                                     interpolate: bool = True):
    """The window bulk lane: one fused ``u8[K, B, 5]`` operand
    (:func:`pack_compact5`) in, ``f32[K, 2, B]`` back (grants,
    remaining)."""
    slots_k, counts_k = _unpack_compact5(fused)
    state, granted, remaining = window_acquire_scan(
        state, slots_k, counts_k, slots_k >= 0, nows_k, limit, window_ticks,
        handle_duplicates=handle_duplicates, interpolate=interpolate)
    return state, torch.stack([granted.to(torch.float32), remaining], dim=1)


def window_acquire_scan_fused_bits(state: WindowState, fused, nows_k, limit,
                                   window_ticks, *,
                                   handle_duplicates: bool = True,
                                   interpolate: bool = True):
    """Verdict-only window bulk lane: grants bit-packed ``u8[K, B/8]``."""
    slots_k, counts_k = _unpack_compact5(fused)
    state, granted, _ = window_acquire_scan(
        state, slots_k, counts_k, slots_k >= 0, nows_k, limit, window_ticks,
        handle_duplicates=handle_duplicates, interpolate=interpolate)
    return state, pack_grant_bits(granted)


def window_acquire_scan_compact(state: WindowState, slots_k, counts_k, nows_k,
                                limit, window_ticks, *,
                                handle_duplicates: bool = True):
    """The sliding-window scan with validity implied by the slot's sign and
    u8 counts widened to int32. Returns ``(state, granted, remaining)``."""
    return window_acquire_scan(
        state, slots_k, counts_k.to(torch.int32), slots_k >= 0, nows_k,
        limit, window_ticks, handle_duplicates=handle_duplicates)


def sweep_windows(state: WindowState, now, window_ticks):
    """TTL eviction for a window table: a slot idle for two whole windows
    carries nothing (both counts would roll to zero), so ``exists`` is
    cleared in place. The index difference wraps as int32. Returns
    ``(state, expired bool[N])``."""
    idx_now = bm.window_index(now, window_ticks, state.window_idx.device)
    behind = bm._wrap_i32(idx_now.to(torch.int64)
                          - state.window_idx.to(torch.int64))
    expired = state.exists & (behind >= 2)
    state.exists.logical_and_(~expired)
    return state, expired


def rebase_window_epoch(state: WindowState,
                        offset_windows: int) -> WindowState:
    """Epoch rebase of a window table, in place: live indices shift back by
    whole windows (``offset_ticks // window_ticks``, host-computed),
    clamped at 0."""
    _rebase_ts(state.window_idx, state.exists, offset_windows)
    return state


class SemaState(NamedTuple):
    """SoA concurrency-semaphore table: permits held per key (the
    ``ConcurrencyLimiter`` member of ``System.Threading.RateLimiting``, whose
    leases return their permits on dispose)."""

    active: torch.Tensor   # i32[N] held permits
    last_ts: torch.Tensor  # i32[N] last touch (for idle-slot sweeps)
    exists: torch.Tensor   # bool[N]


def init_sema_state(n: int, device="cpu") -> SemaState:
    return SemaState(
        active=torch.zeros((n,), dtype=torch.int32, device=device),
        last_ts=torch.zeros((n,), dtype=torch.int32, device=device),
        exists=torch.zeros((n,), dtype=torch.bool, device=device),
    )


def sema_batch_packed(state: SemaState, packed):
    """Batched semaphore update: ``packed i32[4, B]`` — row 0 slots
    (negative or ≥ N ⇒ padding), row 1 signed deltas (+n acquire, -n
    release, 0 probe), row 2 per-row permit limits, row 3 the tick.

    An acquire is all-or-nothing: granted iff ``(active + prefix) + n <=
    limit`` in float32, ``prefix`` the earlier same-slot ACQUIRE demand of
    the batch, granted or not (conservative, as the bucket kernels). A
    release always applies; a probe changes nothing. Every valid row's slot
    takes ``max(active + Σ applied, 0)``; ``last_ts`` and ``exists`` are
    written only where ``delta != 0``, so a probe neither allocates nor
    refreshes a slot. Untouched slots are not clamped (every write clamps,
    so none is negative; the JAX program clamps the whole table).

    Returns ``(state, out f32[2, B])``: row 0 ok (releases 1), row 1 the
    row's post-op active count, ``max((active + earlier applied) + applied,
    0)``. A batch must not mix a release with other rows of the same slot:
    the slot's net delta is clamped once (the store routes such rows one at
    a time)."""
    slots, deltas, limits, now = packed[0], packed[1], packed[2], packed[3, 0]
    valid = _valid_slots(slots, slots >= 0, state.active.shape[0])
    gs = torch.where(valid, slots, torch.zeros_like(slots)).long()
    zero = torch.zeros((), dtype=torch.int32, device=slots.device)
    active_old = torch.where(state.exists[gs], state.active[gs], zero)
    acq = torch.clamp_min(deltas, 0)
    prefix = bm.duplicate_prefix(slots, acq, valid)
    f32 = torch.float32
    fits = ((active_old.to(f32) + prefix) + acq.to(f32)) <= limits.to(f32)
    ok = valid & ((deltas < 0) | fits)
    applied = torch.where(ok, deltas, zero)

    idx = slots[valid].long()
    state.active.index_put_((idx,), active_old[valid])
    state.active.index_add_(0, idx, applied[valid])
    state.active[idx] = torch.clamp_min(state.active[idx], 0)
    touch = slots[valid & (deltas != 0)].long()
    state.last_ts.index_fill_(0, touch, int(now))
    state.exists.index_fill_(0, touch, True)

    applied_prefix = bm.duplicate_prefix(slots, applied, valid)
    after = torch.clamp_min(
        (active_old.to(f32) + applied_prefix) + applied.to(f32), 0.0)
    return state, torch.stack([ok.to(f32), torch.where(
        valid, after, torch.zeros((), dtype=f32, device=slots.device))])


def sweep_semas(state: SemaState, now):
    """Idle-slot eviction for the semaphore table: a slot that holds no
    permit (``active <= 0``) and was untouched for the fixed 86400 s TTL.
    A slot still holding permits is never swept: a leaked permit is the
    operator's to release, not expiry's to forgive. Clears ``exists`` in
    place; returns ``(state, expired bool[N])``."""
    expired = (state.exists & (state.active <= 0)
               & (bm.elapsed_ticks(now, state.last_ts)
                  >= bm.GLOBAL_COUNTER_TTL_TICKS))
    state.exists.logical_and_(~expired)
    return state, expired


def rebase_sema_epoch(state: SemaState, offset_ticks: int) -> SemaState:
    """Epoch rebase of the semaphore table, in place: every timestamp shifts
    back by ``offset_ticks``, clamped at 0 (the JAX program shifts every
    slot, live or not)."""
    shifted = torch.clamp_min(state.last_ts.to(torch.int64)
                              - int(offset_ticks), 0)
    state.last_ts.copy_(shifted.to(torch.int32))
    return state


def acquire_hierarchical_packed(child: BucketState, parent: BucketState,
                                packed, child_capacity, child_rate_per_tick,
                                parent_capacity, parent_rate_per_tick):
    """Two-level (tenant → key) weighted-cost admission over two bucket
    tables: ``packed i32[4, B]`` — row 0 child (key) slots, row 1 costs, row
    2 the tick, row 3 parent (tenant) slots; a row is valid only where both
    slots lie in their tables.

    Both rows refill. The child prefix counts every earlier same-key cost;
    the parent prefix counts the earlier same-tenant costs the child level
    admitted. Granted iff both levels admit; both tables then take the cost,
    or neither does, and both timestamps advance either way. Returns
    ``(child, parent, out f32[2, B])``: row 0 granted, row 1 ``min(max((c_ref
    - c_pre) - consumed, 0), max((p_ref - p_pre) - consumed, 0))``."""
    cslots, counts, now, pslots = packed[0], packed[1], packed[2, 0], packed[3]
    valid = (_valid_slots(cslots, cslots >= 0, child.tokens.shape[0])
             & _valid_slots(pslots, pslots >= 0, parent.tokens.shape[0]))
    counts_f = counts.to(torch.float32)
    c_ref = bm.refill_or_init(*_gather(child, cslots, valid), now,
                              child_capacity, child_rate_per_tick)
    p_ref = bm.refill_or_init(*_gather(parent, pslots, valid), now,
                              parent_capacity, parent_rate_per_tick)
    c_pre = bm.duplicate_prefix(cslots, counts, valid)
    child_ok = valid & (c_ref >= c_pre + counts_f)
    p_pre = bm.duplicate_prefix(pslots, torch.where(
        child_ok, counts, torch.zeros_like(counts)), valid)
    granted = child_ok & (p_ref >= p_pre + counts_f)
    zero = torch.zeros_like(counts_f)
    consumed = torch.where(granted, counts_f, zero)
    c_rem = torch.where(valid, torch.clamp_min(c_ref - c_pre - consumed, 0.0),
                        zero)
    p_rem = torch.where(valid, torch.clamp_min(p_ref - p_pre - consumed, 0.0),
                        zero)
    _scatter(child, cslots, valid, c_ref, consumed, now)
    _scatter(parent, pslots, valid, p_ref, consumed, now)
    return child, parent, torch.stack([granted.to(torch.float32),
                                       torch.minimum(c_rem, p_rem)])


def debit_batch_packed(state: BucketState, packed, capacity,
                       fill_rate_per_tick):
    """Saturating bulk debit (tier-0 reconciliation): ``packed i32[3, B]`` —
    row 0 slots, row 1 the float32 amounts bitcast, row 2 the tick — or
    ``i32[4, B]`` with row 3 the float32 same-slot prefix of earlier
    amounts, bitcast (the store computes it on the host,
    :func:`bm.duplicate_prefix_float`; three rows compute it here).

    Refill as a flush does, then subtract ``applied = min(amount,
    max(refilled - prefix, 0))`` (a negative amount credits, unclamped).
    Returns ``(state, out f32[2, B])``: row 0 the post-debit balance
    ``avail - applied``, row 1 the shortfall ``amount - applied``."""
    slots, now = packed[0], packed[2, 0]
    amounts = packed[1].contiguous().view(torch.float32)
    valid = _valid_slots(slots, slots >= 0, state.tokens.shape[0])
    refilled = bm.refill_or_init(*_gather(state, slots, valid), now, capacity,
                                 fill_rate_per_tick)
    if packed.shape[0] > 3:
        prefix = packed[3].contiguous().view(torch.float32)
    else:
        prefix = bm.duplicate_prefix_float(slots, amounts, valid)
    zero = torch.zeros_like(refilled)
    avail = torch.clamp_min(refilled - prefix, 0.0)
    applied = torch.where(valid, torch.minimum(amounts, avail), zero)
    shortfall = torch.where(valid, amounts - applied, zero)
    remaining = torch.where(valid, avail - applied, zero)
    _scatter(state, slots, valid, refilled, applied, now)
    return state, torch.stack([remaining, shortfall])
