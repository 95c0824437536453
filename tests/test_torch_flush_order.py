"""The bucket and window flush kernels' decomposition, on the CPU.

The card's flush kernels (``csrc/decide.cuh``: ``flush_warp_kernel`` and
``flush_block_kernel``, instantiated by
``csrc/acquire.cu`` and ``csrc/window.cu``) decide every row from its slot's
state as gathered and the host's same-slot prefix (operand row 3), as the
plain versions (``K.acquire_batch_packed`` and its grouped and window forms)
do; they differ in how a slot is written back. The plain versions set every
duplicate's advanced state and then add each row's consumption in float32,
row by row. The kernels give each slot ONE writer, which stores the advanced
state with the int64 sum of the slot's consumption (``c`` a granted row,
``n_granted x c`` a group) through the policy's ``commit``:

- warp (B <= 32): row = lane; a row's peers are the lanes with its slot
  (``__match_any_sync``), and the highest peer writes;
- block (33 <= B <= 4096; above 256 rows spread over min(64, B / 64)
  blocks by a hash of the slot, so that all rows of a slot meet in one
  block): in a block the rows add their consumption into their slot's entry
  of a hash set (linear probing, 2^bits >= 2m entries for the block's m
  rows, claimed in whatever order the hardware's atomics give: emulated here
  by a seeded permutation of the warps' insert steps), and the row that
  claimed the entry writes the slot;
- past 4096 rows the kernels refuse a flush (``FLUSH_MAX_BATCH``).

This file emulates that decomposition in numpy and holds it against the
plain versions and against the JAX package's ``acquire_batch_packed``,
``acquire_batch_packed_grouped``, ``window_acquire_batch_packed`` and
``window_acquire_batch_packed_grouped`` (sliding and fixed) on seeded
inputs: B in {1, 8, 12, 32, 33, 64, 256, 257, 4096}, over distinct slots,
Zipf slots, one hot slot, padding and out-of-range slots, zero-count
probes, mixed-count groups with nonzero row-3 prefixes, and i32 counts
above 2^24.

Tolerance. Grants, remaining, ``last_ts`` / ``window_idx``, ``exists`` and
``prev_count`` are equal bit for bit. Tokens and ``curr_count`` are equal
bit for bit wherever counts are whole and below 2^24 (the granted
consumption of a slot is at most its balance, so every partial difference
is exact). Past 2^24 the one writer converts its int64 sum once, where the
plain versions and JAX convert each count and round each add: a slot that
takes r adds lies within (r + 1) float32 spacings of the larger of the two
values. Fill rates are powers of two and the windows 1024 ticks with whole
counts below 2^14 (at a window boundary past 2^24), so that XLA's fused
multiply-adds on the CPU round as the port does.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedratelimiting.redis_tpu.ops import kernels as JK
from distributedratelimiting.redis_tpu.runtime.clock import (
    ManualClock as JClock,
)
from distributedratelimiting.redis_tpu.runtime.store import (
    DeviceBucketStore as JStore,
)
from distributedratelimiting.redis_tpu_torch import (
    DeviceBucketStore,
    ManualClock,
)
from distributedratelimiting.redis_tpu_torch.ops import bucket_math as bm
from distributedratelimiting.redis_tpu_torch.ops import kernels as K
from distributedratelimiting.redis_tpu_torch.runtime.store import (
    _duplicate_prefix_host,
)

torch.set_num_threads(1)

EMPTY = 2**32 - 1  # the padding key: no slot is >= 2^31
WARP_ROWS = 32
BLOCK_ROWS = 4096  # rows a flush block takes: the widest flush
N = 2**14
NOW = 50_000
W = 1024  # window ticks
f32 = np.float32


# -- the slot rules (acquire.cu's BucketPolicy, window.cu's WindowPolicy) -----

class Bucket:
    """The token bucket: a row's slot advanced is its refilled balance."""

    def __init__(self, cap, rate):
        self.cap, self.rate = cap, rate

    def advance(self, state, slots, valid, now):
        gs = torch.from_numpy(np.where(valid, slots, 0).astype(np.int64))
        ref = bm.refill_or_init(*(torch.from_numpy(a)[gs] for a in state),
                                int(now), self.cap, self.rate).numpy()
        return {"ref": ref}

    def room(self, sl):
        return sl["ref"]

    def fits(self, sl, pre, c):
        return sl["ref"] >= pre + c

    def commit(self, state, s, sl, i, now, used):
        state[0][s] = sl["ref"][i] - f32(used)
        state[1][s] = now
        state[2][s] = True


class Window:
    """The sliding (or fixed) window: a row's slot advanced to ``now``."""

    def __init__(self, limit, interpolate):
        self.limit, self.interpolate = f32(limit), interpolate

    def advance(self, state, slots, valid, now):
        gs = torch.from_numpy(np.where(valid, slots, 0).astype(np.int64))
        prev, curr, idx = bm.sliding_window_advance(
            *(torch.from_numpy(a)[gs] for a in state), int(now), W)
        est = (bm.sliding_window_estimate(prev, curr, idx, int(now), W)
               if self.interpolate else curr)
        return {"prev": prev.numpy(), "curr": curr.numpy(),
                "idx": idx.numpy(), "est": est.numpy()}

    def room(self, sl):
        return self.limit - sl["est"]

    def fits(self, sl, pre, c):
        return (sl["est"] + pre) + c <= self.limit

    def commit(self, state, s, sl, i, now, used):
        state[0][s] = sl["prev"][i]
        state[1][s] = sl["curr"][i] + f32(used)
        state[2][s] = sl["idx"][i]
        state[3][s] = True


# -- the decomposition ---------------------------------------------------------

def decide_rows(pol, sl, valid, packed, grouped):
    """``decide_row`` for every row: ``(granted, remaining, used int64)``."""
    cnt = packed[1]
    c = cnt.astype(f32)
    pre = packed[3].astype(f32)
    room = pol.room(sl)
    zero = f32(0)
    if grouped:
        n = packed[4].astype(f32)
        avail = room - pre
        ng = np.where(c > 0, np.minimum(np.maximum(
            np.floor(avail / np.maximum(c, f32(1))), zero), n),
            np.where(avail >= 0, n, zero))
        granted = np.where(valid, ng, zero).astype(f32)
        remaining = np.where(valid, np.maximum(avail - granted * c, zero),
                             zero)
        return granted, remaining, granted.astype(np.int64) * cnt
    ok = valid & pol.fits(sl, pre, c)
    remaining = np.where(valid, np.maximum((room - pre) - np.where(
        ok, c, zero), zero), zero)
    return ok.astype(f32), remaining, np.where(ok, cnt, 0).astype(np.int64)


def block_of(keys, g):
    """The block of G each row goes to on the card: a hash of its slot (all
    rows of a slot meet in one block), a padding row by its index."""
    h = ((keys.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(
        0xFFFFFFFF)) >> np.uint64(7)
    return np.where(keys != EMPTY, (h % np.uint64(g)).astype(np.int64),
                    np.arange(len(keys)) % g)


def spread(b):
    """Blocks a flush of B rows is spread over (1: one block or a warp)."""
    return 1 if b <= 256 else min(64, b // 64)


def block_config(b):
    """A block's (threads, rows a thread) for a flush of B rows."""
    for kt, ipt in ((64, 1), (256, 1), (1024, 1), (1024, 2), (1024, 4)):
        if b <= kt * ipt:
            return kt, ipt
    raise ValueError(b)


def hash_bits(m, floor_bits=6):
    bits = floor_bits
    while (1 << bits) < 2 * m:
        bits += 1
    return bits


def block_steps(m, kt, ipt):
    """A block's insert steps: per warp w and row j of a thread, the
    positions j * kt + t < m of the warp's lanes t (a block's rows spread
    over all its warps first)."""
    return [[j * kt + t for t in range(32 * w, 32 * w + 32)
             if j * kt + t < m]
            for w in range(kt // 32) for j in range(ipt)]


def hash_set(keys, used, bits, steps, rng):
    """A hash set of 2^bits entries over ``keys`` (EMPTY for padding):
    at each insert step (a warp's lanes, ``steps``) the lanes of one slot
    add their int64 sum, the lowest finding or claiming the entry by linear
    probing; the steps run in an order the atomics choose. Returns
    ``{slot: (claiming position, sum)}``, checking that each slot has one
    entry."""
    mask = (1 << bits) - 1
    entry_key = np.full(1 << bits, EMPTY, np.int64)
    entry_sum = np.zeros(1 << bits, np.int64)
    owner = {}
    for k in rng.permutation(len(steps)):
        pos = steps[k]
        by_key = {}
        for p in pos:
            if keys[p] != EMPTY:
                by_key.setdefault(int(keys[p]), []).append(p)
        for key, ps in by_key.items():
            at = ((key * 2654435761) & 0xFFFFFFFF) >> (32 - bits)
            while entry_key[at] not in (EMPTY, key):
                at = (at + 1) & mask
            if entry_key[at] == EMPTY:
                entry_key[at] = key
                owner[key] = (ps[0], at)
            entry_sum[at] += used[ps].sum()
    assert len(set(owner)) == len({int(k) for k in keys if k != EMPTY})
    return {k: (p, int(entry_sum[at])) for k, (p, at) in owner.items()}


def writers(keys, used, rng):
    """The kernel's commit for a flush of B rows: ``{slot: (row whose
    advanced state the writer stores, int64 sum of the slot's
    consumption)}``."""
    b = len(keys)
    valid = keys != EMPTY
    if b <= WARP_ROWS:  # the highest lane of each peer set writes
        out = {}
        for lane in range(b):
            if valid[lane]:
                peers = keys == keys[lane]
                out[int(keys[lane])] = (lane, int(used[peers].sum()))
        return out
    if b > BLOCK_ROWS:
        raise ValueError(f"a flush holds at most {BLOCK_ROWS} rows, got {b}")
    part = block_of(keys, spread(b))
    kt, ipt = block_config(b)
    out = {}
    for g in np.unique(part):
        rows = np.nonzero(part == g)[0]  # the block's rows, in order
        m = len(rows)
        got = hash_set(keys[rows], used[rows], hash_bits(m),
                       block_steps(m, kt, ipt), rng)
        assert not set(got) & set(out)  # a slot's rows meet in one block
        out.update({k: (rows[p], s) for k, (p, s) in got.items()})
    return out


def emulate_flush(pol, state, packed, grouped, rng):
    """The kernel's flush, IN PLACE on ``state`` (numpy arrays). Returns
    ``out f32[2, B]``."""
    slots, now = packed[0], packed[2, 0]
    valid = (slots >= 0) & (slots < len(state[0]))
    keys = np.where(valid, slots.astype(np.int64), EMPTY)
    sl = pol.advance(state, slots, valid, now)
    granted, remaining, used = decide_rows(pol, sl, valid, packed, grouped)
    for s, (i, total) in writers(keys, used, rng).items():
        pol.commit(state, s, sl, i, now, total)
    return np.stack([granted, remaining])


# -- seeded cases ---------------------------------------------------------------

SIZES = (1, 8, 12, 32, 33, 64, 256, 257, 4096)
CASES = ("distinct", "zipf", "hot", "padding", "probes", "groups",
         "past_2_24")
KINDS = ("bucket", "sliding", "fixed")


def _seed(*parts):
    return [sum(map(ord, str(p))) * (i + 1) for i, p in enumerate(parts)]


def _rows(case, b, rng):
    """``(slots, counts)`` of a flush of B requests."""
    if case == "distinct":
        slots = rng.choice(N, b, replace=False)
    elif case == "hot":
        slots = np.full(b, 77)
    else:
        slots = np.minimum(rng.zipf(1.3, b) - 1, N - 1)
    slots = slots.astype(np.int32)
    if case == "padding":
        slots[rng.random(b) < 0.3] = -1
        slots[rng.random(b) < 0.15] = N + 3
        slots[rng.random(b) < 0.07] = -2**31
    counts = rng.integers(0, 5, b)
    if case == "groups":  # one count a slot on even slots, mixed on odd
        counts = np.where(slots % 2 == 0, slots % 4 + 1, counts)
    elif case == "probes":
        counts = np.where(rng.random(b) < 0.6, 0, counts)
    elif case == "hot":
        counts = rng.integers(0, 4, b)
    elif case == "past_2_24":
        counts = 2**24 + rng.integers(0, 2**20, b)
    return slots, counts.astype(np.int32)


def _packed(slots, counts, now):
    """The store's ``i32[4, B]`` operand: the host's int64 same-slot prefix
    of earlier demand, saturated to int32."""
    valid = (slots >= 0) & (slots < N)
    prefix = np.zeros(len(slots), np.int64)
    prefix[valid] = _duplicate_prefix_host(slots[valid], counts[valid])
    return np.stack([slots, counts, np.full(len(slots), now, np.int32),
                     np.minimum(prefix, 2**31 - 1).astype(np.int32)])


def _grouped(slots, counts, now, rng):
    """The store's ``i32[5, B]`` coalesced operand for the same requests,
    padded to a power of two >= 8 rows: a slot whose requests ask one count
    is one group of n members (prefix 0); a slot with mixed counts is one
    group per request with its cumulative prefix."""
    groups = []
    by_slot = {}
    for i, s in enumerate(slots):
        by_slot.setdefault(int(s), []).append(i)
    for s, members in by_slot.items():
        cs = counts[members]
        if len(set(cs.tolist())) == 1:
            groups.append((s, int(cs[0]), len(members), 0))
        else:
            pre = 0
            for c in cs.tolist():
                groups.append((s, c, 1, min(pre, 2**31 - 1)))
                pre += c
    rng.shuffle(groups)
    width = 8
    while width < len(groups):
        width *= 2
    groups += [(-1, 0, 0, 0)] * (width - len(groups))
    g = np.array(groups, np.int64).T
    return np.stack([g[0], g[1], np.full(width, now), g[3],
                     g[2]]).astype(np.int32)


def _tables(kind, case, rng):
    """``(numpy state arrays, policy, plain args, JAX args, now)``."""
    big = case == "past_2_24"
    if kind == "bucket":
        cap, rate = (2.0**30, 8.0) if big else (16.0, 2.0**-8)
        top = 2.0**29 if big else cap
        state = (rng.uniform(0, top, N).astype(f32),
                 rng.integers(NOW - 3000, NOW + 50, N).astype(np.int32),
                 rng.random(N) < 0.6)
        state[2][77] = False  # the hot slot starts full
        return (state, Bucket(cap, rate), (cap, rate),
                (jnp.float32(cap), jnp.float32(rate)), NOW)
    limit = 2.0**31 if big else 30.0
    # Past 2^24 the tick is a window boundary: the estimate is exact.
    now = (NOW // W) * W + (0 if big else 377)
    hi = 2**26 if big else 40
    state = (rng.integers(0, hi, N).astype(f32),
             rng.integers(0, hi, N).astype(f32),
             (now // W + rng.choice([-2, -1, 0, 0, 1], N)).astype(np.int32),
             rng.random(N) < 0.7)
    state[3][77] = False  # the hot slot starts empty
    interpolate = kind == "sliding"
    return (state, Window(limit, interpolate),
            (limit, W), (f32(limit), np.int32(W)), now)


def _plain(kind, grouped):
    if kind == "bucket":
        return (K.acquire_batch_packed_grouped if grouped
                else K.acquire_batch_packed), K.BucketState
    fn = (K.window_acquire_batch_packed_grouped if grouped
          else K.window_acquire_batch_packed)
    return (lambda st, op, *a: fn(st, op, *a,
                                  interpolate=kind == "sliding"),
            K.WindowState)


def _jax(kind, grouped):
    if kind == "bucket":
        return (JK.acquire_batch_packed_grouped if grouped
                else JK.acquire_batch_packed), JK.BucketState
    fn = (JK.window_acquire_batch_packed_grouped if grouped
          else JK.window_acquire_batch_packed)
    return (lambda st, op, *a: fn(st, op, *a,
                                  interpolate=kind == "sliding"),
            JK.WindowState)


def _assert_float_field(name, got, want, top, adds, big):
    """Bit for bit; past 2^24 within (r + 1) spacings for r adds of the
    largest partial value (``top``: a slot's advanced value, or either
    result)."""
    if not big:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.abs(top)).astype(f32)
    tol = (adds + 1) * np.spacing(mag).astype(np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= tol).all(), f"{name}: {int((err > tol).sum())} past"


def _check(kind, case, b, grouped):
    rng = np.random.default_rng(_seed(kind, case, b, grouped))
    state, pol, args, jargs, now = _tables(kind, case, rng)
    slots, counts = _rows(case, b, rng)
    if grouped:
        packed = _grouped(slots, counts, now, rng)
    else:
        packed = _packed(slots, counts, now)
    ours = tuple(a.copy() for a in state)
    got = emulate_flush(pol, ours, packed, grouped, rng)

    fn, cls = _plain(kind, grouped)
    plain = cls(*(torch.from_numpy(a.copy()) for a in state))
    _, want = fn(plain, torch.from_numpy(packed), *args)
    jfn, jcls = _jax(kind, grouped)
    jstate, jout = jfn(jcls(*(jnp.asarray(a) for a in state)),
                       jnp.asarray(packed), *jargs)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(got, np.asarray(jout))

    big = case == "past_2_24"
    valid = (packed[0] >= 0) & (packed[0] < N)
    adds = np.bincount(packed[0][valid & (got[0] > 0)], minlength=N)
    every = pol.advance(state, np.arange(N), np.ones(N, bool), now)
    top = every["ref"] if kind == "bucket" else every["curr"]
    for i, name in enumerate(plain._fields):
        for other, src in ((getattr(plain, name).numpy(), "plain"),
                           (np.asarray(jstate[i]), "jax")):
            if name in ("tokens", "curr_count"):
                _assert_float_field(f"{name} vs {src}", ours[i], other,
                                    top, adds, big)
            else:
                np.testing.assert_array_equal(ours[i], other,
                                              err_msg=f"{name} vs {src}")
    return got, packed, valid


@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("case", CASES)
def test_flush_decomposition_matches_plain_and_jax(case, b):
    """Every kind (bucket, sliding, fixed window) and both operands."""
    for kind in KINDS:
        for grouped in (False, True):
            got, packed, valid = _check(kind, case, b, grouped)
            if case in ("zipf", "hot") and b >= 32 and not grouped:
                # a mix of grants and denials
                assert 0 < got[0][valid].sum() < valid.sum(), kind


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", ["zipf", "hot", "past_2_24"])
def test_wide_flush_matches_plain_and_jax(kind, case):
    """The widest flush, 4096 rows (the store's bulk chunk of one batch at
    ``max_batch`` 4096: 64 blocks of 1024 x 4), against the plain versions
    and JAX; past it the kernels take no flush, and neither does the
    emulation."""
    for grouped in (False, True):
        _check(kind, case, BLOCK_ROWS, grouped)
    keys = np.arange(BLOCK_ROWS + 1, dtype=np.int64)
    with pytest.raises(ValueError):
        writers(keys, np.ones_like(keys), np.random.default_rng(0))


def test_partition_spreads_and_meets():
    """Distinct slots spread over every one of the 64 blocks of a 4096-row
    flush; one hot slot's rows meet in one block; a 257-row flush takes 4
    blocks."""
    rng = np.random.default_rng(4)
    distinct = rng.choice(N, 4096, replace=False).astype(np.int64)
    assert len(np.unique(block_of(distinct, spread(4096)))) == 64
    hot = np.full(4096, 77, np.int64)
    assert len(np.unique(block_of(hot, spread(4096)))) == 1
    assert spread(257) == 4 and spread(256) == 1


@pytest.mark.parametrize("case", ["zipf", "hot", "past_2_24"])
def test_one_writer_sums_are_exact_where_rows_round(case):
    """The int64 sum a slot's writer applies is the exact sum of its rows'
    consumption, which a float32 running sum of the same rows need not be
    past 2^24."""
    rng = np.random.default_rng(_seed("sums", case))
    slots, counts = _rows(case, 4096, rng)
    keys = np.where((slots >= 0) & (slots < N), slots.astype(np.int64),
                    EMPTY)
    used = counts.astype(np.int64)
    for s, (_, total) in writers(keys, used, rng).items():
        assert total == int(used[keys == s].sum())
    if case == "past_2_24":
        hot = int(np.bincount(keys[keys != EMPTY]).argmax())
        run = f32(0)
        for c in counts[keys == hot]:
            run = f32(run + f32(c))
        assert int(run) != int(used[keys == hot].sum())


# -- the store's padding --------------------------------------------------------

async def _flush_rows(store, kind):
    """A one-request flush, a 33-request flush of distinct keys, a flush
    with duplicates (the grouped kernel) and a coalesced bulk call; returns
    the results and ``rows_processed`` after each."""
    if kind == "bucket":
        args = (5.0, 2.0)
        one, many = store.acquire, store.acquire_many
    else:
        args = (5.0, 1.0)
        one, many = store.window_acquire, store.window_acquire_many
    out, rows = [], []
    r = await one("solo", 1, *args)
    out.append((r.granted, r.remaining))
    rows.append(store.metrics.rows_processed)
    res = await asyncio.gather(*(one(f"k{i}", 1 + i % 7, *args)
                                 for i in range(33)))
    out.append([(r.granted, r.remaining) for r in res])
    rows.append(store.metrics.rows_processed)
    # 40 requests on 9 keys: uniform counts on keys 0-6 (7 groups), mixed
    # counts on keys 7 and 8 (one group per request: 4 + 3) -> 14 groups.
    reqs = [(f"g{i % 7}", 2) for i in range(33)] + [
        ("g7", 1), ("g7", 2), ("g7", 1), ("g7", 3), ("g8", 2), ("g8", 4),
        ("g8", 1)]
    res = await asyncio.gather(*(one(k, c, *args) for k, c in reqs))
    out.append([(r.granted, r.remaining) for r in res])
    rows.append(store.metrics.rows_processed)
    # 100 rows on 20 keys, one count: grouping pays -> 20 groups.
    bulk = await many([f"b{i % 20}" for i in range(100)], [1] * 100, *args)
    out.append((bulk.granted.tolist(), bulk.remaining.tolist()))
    rows.append(store.metrics.rows_processed)
    return out, rows


@pytest.mark.parametrize("kind", ["bucket", "window"])
def test_store_pads_flushes_to_their_rows(kind):
    """A one-request flush launches 8 rows, a 33-request flush 64, a
    14-group grouped flush 16 and a 20-group bulk chunk 32 (the JAX store
    pads each to ``max_batch``); grants and remaining equal the JAX
    store's."""
    port = DeviceBucketStore(device="cpu", clock=ManualClock(10_000),
                             n_slots=256, max_batch=4096)
    jax_ = JStore(clock=JClock(10_000), n_slots=256, max_batch=4096)
    got, rows = asyncio.run(_flush_rows(port, kind))
    want, _ = asyncio.run(_flush_rows(jax_, kind))
    assert got == want
    assert rows == [8, 8 + 64, 8 + 64 + 16, 8 + 64 + 16 + 32]
    assert 0 < sum(g for g, _ in got[2]) < 40  # both outcomes


def test_store_keeps_full_bulk_chunks_and_pads_the_last():
    """With ``max_batch`` 16, a coalesced bulk call of 20 groups launches a
    full chunk of 16 rows and a last chunk of 4 groups padded to 8; grants
    and remaining equal the JAX store's (16 and 16)."""
    async def run(store):
        keys = [f"b{i % 20}" for i in range(100)]
        res = await store.acquire_many(keys, [1] * 100, 3.0, 1.0)
        return ((res.granted.tolist(), res.remaining.tolist()),
                store.metrics.rows_processed, store.metrics.launches)

    got = asyncio.run(run(DeviceBucketStore(
        device="cpu", clock=ManualClock(10_000), n_slots=64, max_batch=16)))
    want = asyncio.run(run(JStore(clock=JClock(10_000), n_slots=64,
                                  max_batch=16)))
    assert got[0] == want[0]
    assert got[1:] == (16 + 8, 2) and want[1:] == (32, 2)
