"""L1 — the token-bucket batch operations, as plain PyTorch.

These are the PLAIN versions of the JAX package's ``ops/kernels.py`` bucket
family: torch operations with the same names, operand layouts and result
layouts (``i32[4, B]`` / ``i32[5, B]`` in, ``f32[2, B]`` out, ``f32[K, 2, B]``
and little-endian bit-packed ``u8[K, B/8]`` for the scanned bulk lane).
They run whenever the state lies on the CPU, and they are the oracle the
hand-written CUDA kernels (:mod:`.cuda_kernels`) are held against on the card.

State is structure-of-arrays — ``tokens: f32[N]``, ``last_ts: i32[N]``,
``exists: bool[N]``, 9 bytes/key. Where the JAX kernels donate the state
buffers and return new ones, these functions update the state tensors IN
PLACE and return the same :class:`BucketState`, so the table is never
double-buffered.

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
    "acquire_batch_packed",
    "acquire_batch_packed_grouped",
    "acquire_scan_packed",
    "acquire_scan_fused_packed",
    "acquire_scan_fused_bits",
    "pack_compact5",
    "pack_grant_bits",
    "sweep_expired",
    "peek_batch_packed",
    "rebase_bucket_epoch",
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
    shifted = torch.clamp_min(state.last_ts - int(offset_ticks), 0)
    state.last_ts.copy_(torch.where(state.exists, shifted, state.last_ts))
    return state
