"""L0 — pure token-bucket math in PyTorch, time always an explicit operand.

The exact-bucket half of the JAX package's ``ops/bucket_math.py``, with the
same names and the same float32/int32 representation:

- **Time** is an ``int32`` tick count, ``TICKS_PER_SECOND = 1024`` (a power
  of two, so second↔tick conversions are exact in float32). A batch receives
  ONE ``now`` — every key in the batch observes the same clock.
- **Tokens** are ``float32``. Grant comparison is ``tokens >= count`` with
  no epsilon: float rounding can only under-admit, never over-admit.

The decaying-counter functions (the approximate bucket's global tier) and
the two-counter window functions (sliding and fixed windows) follow the same
rules. Every function works on tensors of any device; scalars (``now``,
``capacity``, ``fill_rate_per_tick``, ``limit``, ``window_ticks``) may be
Python numbers or 0-d tensors.

Where XLA's int32 arithmetic wraps (``window_idx * window_ticks`` and the
differences of window indices), these functions compute in int64 and wrap
back explicitly; ``now // window_ticks`` is a floor division, as
``jnp.floor_divide`` is.
"""

from __future__ import annotations

import torch

__all__ = [
    "TICKS_PER_SECOND",
    "MIN_TTL_TICKS",
    "MAX_TTL_TICKS",
    "GLOBAL_COUNTER_TTL_TICKS",
    "PERIOD_EWMA_ALPHA",
    "elapsed_ticks",
    "refill",
    "refill_or_init",
    "time_to_full_ttl",
    "duplicate_prefix",
    "duplicate_prefix_float",
    "decay_core",
    "decay_and_add",
    "instance_count_estimate",
    "available_tokens",
    "retry_after_ticks",
    "window_index",
    "sliding_window_advance",
    "sliding_window_estimate",
    "sliding_window_acquire",
]

# One tick = 1/1024 s. Power of two → exact in float32, and a full int32 range
# covers ~24 days of uptime (the store rebases its epoch long before that).
TICKS_PER_SECOND = 1024

# TTL clamp: max(1s, min(1yr, time-to-full-refill)).
MIN_TTL_TICKS = TICKS_PER_SECOND  # 1 second
MAX_TTL_TICKS = 365 * 24 * 3600 * TICKS_PER_SECOND  # 1 year (> int32 max)
_INT32_MAX = 2**31 - 1

# The approximate global counter's fixed TTL: 86400 s.
GLOBAL_COUNTER_TTL_TICKS = 86400 * TICKS_PER_SECOND

# EWMA smoothing of the inter-sync interval: new_p = 0.8*prev + 0.2*delta.
PERIOD_EWMA_ALPHA = 0.2
# The TTL upper clamp as float32: min(1yr, 2^31 - 1) rounds UP to 2^31.
_TTL_CAP_F32 = float(min(MAX_TTL_TICKS, _INT32_MAX))
# Largest float32 strictly below 2^31 (the last value int32 can hold).
_F32_BELOW_2_31 = 2147483520.0


def _f32(x, device) -> torch.Tensor:
    """A scalar operand as a 0-d float32 tensor (rounded like ``jnp.float32``)."""
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def elapsed_ticks(now, last_ts: torch.Tensor) -> torch.Tensor:
    """Elapsed store time with the clock-regression clamp ``max(0, now - last)``:
    after a failover the new authority's clock may be behind, and a negative
    elapsed must neither mint nor destroy tokens."""
    return torch.clamp_min(now - last_ts, 0).to(torch.int32)


def refill(tokens, last_ts, now, capacity, fill_rate_per_tick):
    """Lazy refill ``min(capacity, tokens + elapsed * rate)``, rounded as two
    float32 operations (a multiply, then an add; never a fused multiply-add)."""
    dev = tokens.device
    delta = elapsed_ticks(now, last_ts).to(torch.float32)
    return torch.minimum(_f32(capacity, dev),
                         tokens + delta * _f32(fill_rate_per_tick, dev))


def refill_or_init(tokens, last_ts, exists, now, capacity, fill_rate_per_tick):
    """Refill where the slot exists; init-on-miss to a FULL bucket elsewhere."""
    return torch.where(
        exists,
        refill(tokens, last_ts, now, capacity, fill_rate_per_tick),
        _f32(capacity, tokens.device),
    )


def time_to_full_ttl(tokens, capacity, fill_rate_per_tick):
    """Per-key state TTL in int32 ticks:
    ``clamp(ceil((capacity - tokens) / rate), 1s, min(1yr, 2^31 - 1))``.

    The upper clamp is 2^31 in float32, one past int32's range. XLA's
    float→int conversion saturates it to ``2^31 - 1``; a plain ``.to(int32)``
    in PyTorch gives ``-2^31`` instead, which would make every existing slot
    expire at once when the fill rate is tiny. The conversion here saturates
    explicitly."""
    dev = tokens.device
    rate = torch.clamp_min(_f32(fill_rate_per_tick, dev), 1e-30)
    deficit = torch.clamp_min(_f32(capacity, dev) - tokens, 0.0)
    ttl = torch.ceil(deficit / rate)
    ttl = torch.clamp(ttl, MIN_TTL_TICKS, _TTL_CAP_F32)
    return torch.where(
        ttl >= 2.0**31,
        torch.tensor(_INT32_MAX, dtype=torch.int32, device=dev),
        torch.clamp_max(ttl, _F32_BELOW_2_31).to(torch.int32),
    )


def duplicate_prefix(slots, counts, valid):
    """Per-request prefix of earlier same-slot demand within one batch:
    ``prefix[i] = sum_{j < i, slots[j] == slots[i], valid[j]} counts[j]``,
    returned as float32.

    Request ``i`` is granted only if the refilled balance covers ``prefix[i] +
    counts[i]``; counting all earlier same-slot demand (granted or not) can
    only under-admit relative to true serial order. A stable sort groups equal
    slots in request order; the in-segment exclusive prefix is an int64
    cumulative sum minus its value at the segment's first row, so integer
    demand stays exact (a whole-batch float32 cumsum would lose integers
    past 2^24), signed counts included (the semaphore's applied deltas)."""
    c = torch.where(valid, counts.to(torch.int64),
                    torch.zeros((), dtype=torch.int64, device=counts.device))
    order = torch.sort(slots, stable=True).indices
    s_sorted = slots[order]
    c_sorted = c[order]
    csum = torch.cumsum(c_sorted, 0)
    excl = csum - c_sorted
    seg_start = torch.ones_like(s_sorted, dtype=torch.bool)
    seg_start[1:] = s_sorted[1:] != s_sorted[:-1]
    pos = torch.arange(len(excl), device=excl.device)
    first = torch.cummax(torch.where(seg_start, pos, torch.zeros_like(pos)),
                         0).values
    base = excl[first]
    prefix = torch.empty_like(excl)
    prefix[order] = excl - base
    return prefix.to(torch.float32)


def duplicate_prefix_float(slots, amounts, valid):
    """The same-slot prefix of earlier FLOAT amounts (the tier-0 debit's):
    ``prefix[i] = sum_{j < i, slots[j] == slots[i], valid[j]} amounts[j]``
    as float32, where :func:`duplicate_prefix`'s int64 sum would truncate
    fractional and negative amounts.

    Summation order: the earlier amounts of a slot are added one at a time
    in request order, each add rounded to float32 (``p_0 = 0``, ``p_{k+1} =
    p_k + a_k``). JAX sums the same terms with a segmented associative scan
    (a tree), so with k earlier terms the two may differ by about k float32
    spacings of the largest partial sum; whole numbers (and dyadic amounts)
    whose partial sums stay below 2^24 spacings are exact in both. A stable
    sort groups each slot's rows; the loop runs once per rank within a
    segment, each pass over the rows of that rank."""
    n = slots.shape[0]
    a = torch.where(valid, amounts.to(torch.float32),
                    torch.zeros((), dtype=torch.float32, device=slots.device))
    prefix = torch.zeros(n, dtype=torch.float32, device=slots.device)
    if n == 0:
        return prefix
    order = torch.sort(slots, stable=True).indices
    s_sorted = slots[order]
    a_sorted = a[order]
    pos = torch.arange(n, device=slots.device)
    seg_start = torch.ones(n, dtype=torch.bool, device=slots.device)
    seg_start[1:] = s_sorted[1:] != s_sorted[:-1]
    rank = pos - torch.cummax(torch.where(seg_start, pos, 0), 0).values
    by_rank = torch.sort(rank, stable=True)
    bounds = torch.bincount(rank).cumsum(0).tolist()
    p_sorted = torch.zeros(n, dtype=torch.float32, device=slots.device)
    for k in range(1, len(bounds)):
        at = by_rank.indices[bounds[k - 1]:bounds[k]]
        p_sorted[at] = p_sorted[at - 1] + a_sorted[at - 1]
    prefix[order] = p_sorted
    return prefix


def decay_core(value, period_ewma, last_ts, exists, now, decay_rate_per_tick):
    """Decay-without-add core of the decaying counter: returns ``(decayed,
    new_period)``, with ``decayed = exists ? max(0, v - delta * rate) : 0``
    and ``new_period = exists ? 0.8 * p + 0.2 * delta : delta``, where
    ``delta`` is the elapsed time since the last touch (since tick 0 for a
    fresh counter, whose stale timestamp must not be read). Each product and
    sum rounds on its own, in the order written."""
    dev = value.device
    zero_ts = torch.zeros((), dtype=last_ts.dtype, device=dev)
    delta = elapsed_ticks(now, torch.where(exists, last_ts, zero_ts)).to(
        torch.float32)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    decayed = torch.where(
        exists,
        torch.clamp_min(value - delta * _f32(decay_rate_per_tick, dev), 0.0),
        zero)
    new_period = torch.where(
        exists,
        _f32(1.0 - PERIOD_EWMA_ALPHA, dev) * period_ewma
        + _f32(PERIOD_EWMA_ALPHA, dev) * delta,
        delta)
    return decayed, new_period


def decay_and_add(value, period_ewma, last_ts, exists, now, local_counts,
                  decay_rate_per_tick):
    """The approximate bucket's sync step on a decaying consumption counter:
    ``new_v = max(0, v - delta * rate) + local_counts`` and the EWMA of the
    inter-sync interval, from which callers derive the instance-count
    estimate. Returns ``(new_value, new_period_ewma, new_last_ts)``."""
    local_counts = torch.as_tensor(local_counts, dtype=torch.float32,
                                   device=value.device)
    decayed, new_period = decay_core(value, period_ewma, last_ts, exists, now,
                                     decay_rate_per_tick)
    new_value = decayed + local_counts
    new_last_ts = torch.full(new_value.shape, int(now), dtype=torch.int32,
                             device=value.device)
    return new_value, new_period, new_last_ts


def instance_count_estimate(replenishment_period_ticks, period_ewma):
    """``max(1, round(period / observed_sync_interval))`` as int32 — with k
    clients each syncing once a period, syncs arrive k times a period."""
    p = torch.clamp_min(torch.as_tensor(period_ewma, dtype=torch.float32), 1.0)
    est = torch.round(_f32(replenishment_period_ticks, p.device) / p)
    return torch.clamp_min(est, 1.0).to(torch.int32)


def available_tokens(token_limit, global_score, instance_count, local_score):
    """The approximate limiter's local availability:
    ``max(0, ceil((token_limit - global_score) / instance_count) -
    local_score)`` — each client's fair share of the global remainder, less
    what it consumed since the last sync."""
    g = torch.as_tensor(global_score, dtype=torch.float32)
    share = torch.ceil(
        (_f32(token_limit, g.device) - g)
        / torch.clamp_min(torch.as_tensor(instance_count, dtype=torch.float32,
                                          device=g.device), 1.0))
    return torch.clamp_min(share - local_score, 0.0)


def retry_after_ticks(deficit, fill_rate_per_tick):
    """Time until ``deficit`` more tokens exist: ``ceil(deficit / rate)``
    ticks, as int32."""
    d = torch.as_tensor(deficit, dtype=torch.float32)
    rate = torch.clamp_min(_f32(fill_rate_per_tick, d.device), 1e-30)
    return _saturate_i32(torch.ceil(d / rate))


def _saturate_i32(x):
    """float32 → int32 saturating at the int32 range, as XLA converts (a
    plain ``.to(int32)`` of an out-of-range float gives ``-2^31``)."""
    big = torch.tensor(_INT32_MAX, dtype=torch.int32, device=x.device)
    small = torch.tensor(-(2**31), dtype=torch.int32, device=x.device)
    inner = torch.clamp(x, -(2.0**31), _F32_BELOW_2_31).to(torch.int32)
    return torch.where(x >= 2.0**31, big, torch.where(x < -(2.0**31), small,
                                                      inner))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """An int64 tensor reduced to int32 with two's-complement wraparound, as
    XLA's int32 arithmetic wraps (PyTorch's int32 overflow is not defined)."""
    return (torch.remainder(x + 2**31, 2**32) - 2**31).to(torch.int32)


def window_index(now, window_ticks, device=None) -> torch.Tensor:
    """The index of the window holding ``now``: ``floor(now / window_ticks)``
    as a 0-d int32 tensor (a floor, not C's truncation, for a negative
    ``now``)."""
    now = torch.as_tensor(now, dtype=torch.int32, device=device)
    w = torch.as_tensor(window_ticks, dtype=torch.int32, device=now.device)
    return torch.div(now, w, rounding_mode="floor").to(torch.int32)


def sliding_window_advance(prev_count, curr_count, window_idx, exists, now,
                           window_ticks):
    """Advance a two-counter window to the window holding ``now``: on an
    advance by one window the current count rolls into the previous one, on
    an advance by two or more both are zero, and a missing slot starts at
    zero. The clock-regression clamp never moves a window backwards.
    Returns ``(prev_count', curr_count', window_idx')``."""
    dev = window_idx.device
    idx_now = window_index(now, window_ticks, dev).expand(window_idx.shape)
    idx_now = torch.maximum(idx_now, torch.where(exists, window_idx, idx_now))
    base = torch.where(exists, window_idx, idx_now)
    steps = _wrap_i32(idx_now.to(torch.int64) - base.to(torch.int64))
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    same = steps == 0
    prev_new = torch.where(same, prev_count,
                           torch.where(steps == 1, curr_count, zero))
    curr_new = torch.where(same, curr_count, zero)
    return (torch.where(exists, prev_new, zero),
            torch.where(exists, curr_new, zero), idx_now.contiguous())


def sliding_window_estimate(prev_count, curr_count, window_idx, now,
                            window_ticks):
    """The interpolated consumption of the trailing window: ``curr + prev *
    (1 - frac)``, ``frac`` the elapsed part of the current window, clipped to
    ``[0, 1]``. The in-window remainder ``now - window_idx * window_ticks`` is
    taken in (wrapping) int32 before the float conversion; the product and
    the sum each round on their own (XLA on the CPU contracts them into one
    fused multiply-add)."""
    dev = window_idx.device
    w = torch.as_tensor(window_ticks, dtype=torch.int64, device=dev)
    now64 = torch.as_tensor(now, dtype=torch.int64, device=dev)
    rem = _wrap_i32(now64 - window_idx.to(torch.int64) * w)
    frac = torch.clamp(rem.to(torch.float32) / w.to(torch.float32), 0.0, 1.0)
    return curr_count + prev_count * (1.0 - frac)


def sliding_window_acquire(prev_count, curr_count, window_idx, exists, now,
                           counts, limit, window_ticks):
    """Advance, estimate and all-or-nothing grant: granted iff ``estimate +
    count <= limit``; a grant adds its count to the current window.
    Returns ``(prev', curr', idx', granted)``."""
    counts = torch.as_tensor(counts, dtype=torch.float32,
                             device=prev_count.device)
    prev_new, curr_new, idx_new = sliding_window_advance(
        prev_count, curr_count, window_idx, exists, now, window_ticks)
    est = sliding_window_estimate(prev_new, curr_new, idx_new, now,
                                  window_ticks)
    granted = est + counts <= _f32(limit, prev_count.device)
    curr_new = curr_new + torch.where(granted, counts,
                                      torch.zeros_like(counts))
    return prev_new, curr_new, idx_new, granted
