"""The counter sync's and the tier-0 debit's decomposition, on the CPU.

The card's ``sync_counters`` (``csrc/counter.cu``) and ``debit_packed``
(``csrc/admission.cu``) run on ``csrc/tally.cuh``. Every row replies from its
slot's state as it was before the launch (the debit's same-slot prefix comes
from the host, operand row 3), as the plain versions (``K.sync_batch_packed``,
``K.debit_batch_packed``) do; they differ in how a slot is written back. The
plain versions set every duplicate and then add each row's count (or
subtract its applied amount) in float32, row by row. The kernels give each
slot ONE writer, which stores ``base + the sum of its rows' x`` (base the
decayed value or the refilled balance, x the count or the applied amount
negated):

- warp (B <= 32): row = lane; the highest lane of a slot's peers writes,
  adding their x one float32 add at a time in lane order;
- block (33 <= B <= 4096; above 256 rows spread over min(64, B / 64) blocks
  by a hash of the slot; a sync padding row, which reads slot 0, goes to slot
  0's block): a hash set in shared memory counts each slot's rows, the lane
  that claims the entry owns the slot; a repeated slot's rows add to its
  record and the owner writes the exact sum rounded once;
- grid (B > 4096): every row claims its slot's entry (a word a slot where
  the table holds at most two slots a row, or is past the L2 and holds at
  most 32, else a hash set of 2^k >= 2B entries; all zero at launch) in
  whatever order the hardware's atomics give (emulated here by a seeded
  permutation of the warps' steps); the row that marks its slot repeated
  takes a record; after a barrier each slot's first row replies and
  commits a slot seen once (hashed: after a second barrier), and the other
  rows of a repeated slot reply and add to its record; after the second
  barrier each record's slot is gathered again and committed with the
  exact sum. The wrapper zeroes the entries before every launch.

This file emulates that decomposition in numpy and holds it against the
plain versions and against the JAX package's ``sync_batch_packed`` and
``debit_batch_packed`` on seeded inputs: B in {1, 8, 32, 33, 256, 257, 4096,
4097, 2^17}, over distinct slots, Zipf slots, one hot slot, and padding and
out-of-range rows with slot 0 in the batch; whole-number and fractional
counts (debits: negative amounts too). It also holds the kernels' limb
arithmetic (``Exact`` in ``tally.cuh``, transliterated) against Python's
exact integers.

Tolerance. Replies, ``period``, ``last_ts`` and ``exists`` equal the plain
version bit for bit (JAX's replies and period within two float32 spacings
of their largest operand: XLA on the CPU may fuse ``0.8 * p + 0.2 * delta``
into one multiply-add). ``value`` and ``tokens`` equal both bit for bit on
whole numbers below 2^24, where every partial sum is exact and no order
rounds, and equal the plain version on every input at B <= 32, where the
warp adds in its order. Otherwise the one writer rounds the exact sum once (within
half a spacing of it), where the plain version rounds each of a slot's r
adds (within r / 2 spacings of their largest partial sum): a slot of r rows
lies within r spacings of the larger of the two values (a sync's values and
counts are >= 0, so every partial sum lies within the final one), or, for
the debit, within r spacings of its value plus its amounts' magnitudes.
Decay and fill rates are powers of two, so that XLA's fused multiply-adds on
the CPU round as the port does.
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

torch.set_num_threads(1)

EMPTY = 2**32 - 1  # the padding key: no slot is >= 2^31
WARP_ROWS = 32
BLOCK_ROWS = 4096  # past it, the grid path
N = 2**18
NOW = 50_000
f32 = np.float32


# -- the exact sum -------------------------------------------------------------

def exact_units(x):
    """Finite float32 values as exact integers in units of 2^-149."""
    return [int(v) for v in np.asarray(x, np.float64) * 2.0**149]


def round_units(m):
    """The integer m (units of 2^-149) rounded once to float32, nearest
    even; 0 gives +0."""
    if m == 0:
        return f32(0.0)
    mag = abs(m)
    sh = max(mag.bit_length() - 24, 0)
    q, r = divmod(mag, 1 << sh)
    if sh and (r > 1 << (sh - 1) or (r == 1 << (sh - 1) and q & 1)):
        q += 1
    with np.errstate(over="ignore"):
        v = f32(np.ldexp(np.float64(q), sh - 149))
    return -v if m < 0 else v


def exact_sum(base, xs):
    """``Exact``: base + sum(xs) rounded once (finite inputs)."""
    return round_units(sum(exact_units(np.append(np.float32(base), xs))))


def limbs_round(xs):
    """``Exact::add`` then ``Exact::round``, as ``tally.cuh`` writes them:
    9 int64 limbs of 32-bit digits, carries, a 64-bit window with a sticky
    bit converted with one rounding, and a power-of-two scale."""
    limb = [0] * 9
    flags = 0
    for x in np.asarray(xs, f32):
        u = int(np.asarray(x).view(np.uint32))
        e, f = (u >> 23) & 0xFF, u & 0x7FFFFF
        if e == 0xFF:
            flags |= 4 if f else (2 if u >> 31 else 1)
            continue
        o = e - 1 if e else 0
        v = (f | 0x800000 if e else f) << (o & 31)
        lo, hi = v & 0xFFFFFFFF, v >> 32
        if u >> 31:
            lo, hi = -lo, -hi
        limb[o >> 5] += lo
        limb[(o >> 5) + 1] += hi
        assert all(-2**63 <= a < 2**63 for a in limb)  # int64 holds them
    if flags & 4 or flags & 3 == 3:
        return f32(np.nan)
    if flags:
        return f32(np.inf) if flags & 1 else f32(-np.inf)

    def carry():
        for j in range(8):
            c = limb[j] >> 32
            limb[j] &= 0xFFFFFFFF
            limb[j + 1] += c

    carry()
    neg = limb[8] < 0
    if neg:
        limb[:] = [-a for a in limb]
        carry()
    d = [a & 0xFFFFFFFF for a in limb] + [limb[8] >> 32]
    top = max((32 * j + d[j].bit_length() - 1 for j in range(10) if d[j]),
              default=-1)
    if top < 0:
        return f32(0.0)
    lo = top - 63
    w, sticky = 0, False
    for j in range(10):
        sh = 32 * j - lo
        if sh >= 64:
            continue
        if sh >= 0:
            w |= (d[j] << sh) & (2**64 - 1)
        elif sh > -32:
            w |= d[j] >> -sh
            sticky |= d[j] & ((1 << -sh) - 1) != 0
        else:
            sticky |= d[j] != 0
    # __ull2float_rn(w | sticky), then ldexpf(., lo - 149).
    r = round_units((w | int(sticky)) << 149)
    with np.errstate(over="ignore"):
        r = f32(np.ldexp(np.float64(r), lo - 149))
    return -r if neg else r


# -- the rules (counter.cu's SyncPolicy, admission.cu's DebitPolicy) ---------

class Sync:
    pad_reads_slot0 = True
    slot_bytes = 13

    def __init__(self, rate):
        self.rate = rate

    def rows(self, state, packed):
        """Every row's ``(base, aux, x)`` and reply; a padding row reads
        slot 0."""
        slots, now = packed[0], int(packed[2, 0])
        valid = (slots >= 0) & (slots < len(state[0]))
        base, aux = self.regather(state, np.where(valid, slots, 0), now)
        counts = packed[1].view(f32)
        out = np.stack([base + counts, aux])
        return base, aux, np.where(valid, counts, f32(0)), out

    def regather(self, state, slots, now):
        t = [torch.from_numpy(a[slots]) for a in state]
        decayed, period = bm.decay_core(*t, now, self.rate)
        return decayed.numpy(), period.numpy()

    def commit(self, state, s, value, aux, now):
        state[0][s], state[1][s], state[2][s], state[3][s] = (
            value, aux, now, True)

    def plain(self, state, packed):
        st = K.CounterState(*(torch.from_numpy(a.copy()) for a in state))
        _, out = K.sync_batch_packed(st, torch.from_numpy(packed), self.rate)
        return [t.numpy() for t in st], out.numpy()

    def jax(self, state, packed):
        st, out = JK.sync_batch_packed(
            JK.CounterState(*(jnp.asarray(a) for a in state)),
            jnp.asarray(packed), jnp.float32(self.rate))
        return [np.asarray(a) for a in st], np.asarray(out)


class Debit:
    pad_reads_slot0 = False
    slot_bytes = 9

    def __init__(self, cap, rate):
        self.cap, self.rate = cap, rate

    def rows(self, state, packed):
        slots, now = packed[0], int(packed[2, 0])
        valid = (slots >= 0) & (slots < len(state[0]))
        ref, _ = self.regather(state, np.where(valid, slots, 0), now)
        amounts, pre = packed[1].view(f32), packed[3].view(f32)
        avail = np.maximum(ref - pre, f32(0))
        applied = np.where(valid, np.minimum(amounts, avail), f32(0))
        out = np.stack([np.where(valid, avail - applied, f32(0)),
                        np.where(valid, amounts - applied, f32(0))])
        return ref, np.zeros_like(ref), -applied, out

    def regather(self, state, slots, now):
        t = [torch.from_numpy(a[slots]) for a in state]
        ref = bm.refill_or_init(*t, now, self.cap, self.rate).numpy()
        return ref, np.zeros_like(ref)

    def commit(self, state, s, value, aux, now):
        state[0][s], state[1][s], state[2][s] = value, now, True

    def plain(self, state, packed):
        st = K.BucketState(*(torch.from_numpy(a.copy()) for a in state))
        _, out = K.debit_batch_packed(st, torch.from_numpy(packed), self.cap,
                                      self.rate)
        return [t.numpy() for t in st], out.numpy()

    def jax(self, state, packed):
        """JAX computes the same-slot prefix itself (``i32[3, B]``)."""
        st, out = JK.debit_batch_packed(
            JK.BucketState(*(jnp.asarray(a) for a in state)),
            jnp.asarray(packed[:3]), jnp.float32(self.cap),
            jnp.float32(self.rate))
        return [np.asarray(a) for a in st], np.asarray(out)


# -- the decomposition ---------------------------------------------------------

def block_of(keys, g):
    """The block of G each row goes to: a hash of its key, a row whose key
    is EMPTY by its index."""
    h = ((keys.astype(np.uint64) * np.uint64(2654435761)) & np.uint64(
        0xFFFFFFFF)) >> np.uint64(7)
    return np.where(keys != EMPTY, (h % np.uint64(g)).astype(np.int64),
                    np.arange(len(keys)) % g)


def spread(b):
    return 1 if b <= 256 else min(64, b // 64)


def block_rows(b):
    for kt, ipt in ((64, 1), (256, 1), (1024, 1), (1024, 2), (1024, 4)):
        if b <= kt * ipt:
            return kt * ipt
    raise ValueError(b)


def warp_path(pol, state, packed, base, aux, x):
    """The highest lane of each slot's peers adds their x in lane order."""
    slots, now = packed[0], int(packed[2, 0])
    valid = (slots >= 0) & (slots < len(state[0]))
    for s in np.unique(slots[valid]):
        lanes = np.flatnonzero(valid & (slots == s))
        v = base[lanes[-1]]
        for lane in lanes:
            v = f32(v + x[lane])
        pol.commit(state, s, v, aux[lanes[-1]], now)


def block_path(pol, state, packed, base, aux, x, rng):
    """Each block's rows in request order; a slot seen once commits base +
    x, a repeated slot's owner (the first claim in an order the atomics
    choose) base + its rows' exact sum. Checks that a block reads no slot
    another block writes, and that its records fit."""
    slots, now = packed[0], int(packed[2, 0])
    b = len(slots)
    valid = (slots >= 0) & (slots < len(state[0]))
    part_key = np.where(valid, slots.astype(np.int64),
                        0 if pol.pad_reads_slot0 else EMPTY)
    part = block_of(part_key, spread(b))
    reads = np.where(valid, slots, 0 if pol.pad_reads_slot0 else -1)
    writer_block = {}
    for s, g in zip(slots[valid], part[valid]):
        assert writer_block.setdefault(int(s), g) == g  # a slot, one block
    for r in range(b):  # no row reads a slot another block writes
        assert writer_block.get(int(reads[r]), part[r]) == part[r]
    for g in np.unique(part):
        rows = np.flatnonzero(part == g)
        assert len(rows) <= block_rows(b)
        vrows = rows[valid[rows]]
        order = rng.permutation(len(vrows))  # claims in atomic order
        owner, seen = {}, {}
        for k in order:
            s = int(slots[vrows[k]])
            owner.setdefault(s, vrows[k])
            seen[s] = seen.get(s, 0) + 1
        assert sum(c > 1 for c in seen.values()) <= block_rows(b) // 2
        for s, r in owner.items():
            mine = vrows[slots[vrows] == s]
            v = (f32(base[r] + x[r]) if seen[s] == 1
                 else exact_sum(base[r], x[mine]))
            pol.commit(state, s, v, aux[r], now)


def hash_bits(b):
    bits = 6
    while (1 << bits) < 2 * b:
        bits += 1
    return bits


REPEATED = 1 << 31
L2_BYTES = 50 * 2**20  # the H100's


def dense(n, b, slot_bytes):
    """``tally.cuh``'s choice: direct words walked in slot order where the
    table holds at most two slots a row, or is larger than the L2 and holds
    at most 32; else a hash set walked by the rows."""
    return n <= 2 * b or (n * slot_bytes > L2_BYTES and n <= 32 * b)


def grid_path(pol, state, packed, out, rng):
    """Pass 1 claims the slots' entries (warp steps in a seeded order; every
    entry zero at launch): direct words, a word a slot holding its first
    row + 1, or a hash set of 2^k >= 2B entries holding the slot + 1
    (linear probing), either flagged once a second row joins. Pass 2 lets
    each slot's first row reply and commit a slot seen once, and the other
    rows of a repeated slot reply (from the state as pass 2 finds it) and
    add their x to its record; pass 3 gathers each record's slot again and
    commits it. Replies land in ``out``."""
    slots, now = packed[0], int(packed[2, 0])
    b, n = len(slots), len(state[0])
    valid = (slots >= 0) & (slots < n)
    hashed = not dense(n, b, pol.slot_bytes)
    bits = hash_bits(b)
    entries = np.zeros(1 << bits if hashed else n, np.int64)
    stash = np.full(b, None)  # (entry, claimed it), None for padding
    recno, records = {}, []  # records: [entry, exact units]
    steps = list(range(0, b, 32))
    for w0 in rng.permutation(len(steps)):
        lanes = np.arange(steps[w0], min(steps[w0] + 32, b))
        for s in np.unique(slots[lanes][valid[lanes]]):
            group = lanes[slots[lanes] == s]
            m, i = len(group), int(group[0])  # the lowest lane claims
            many = REPEATED if m > 1 else 0
            if hashed:
                e = ((int(s) * 2654435761) & 0xFFFFFFFF) >> (32 - bits)
                while entries[e] and entries[e] & ~REPEATED != s + 1:
                    e = (e + 1) % len(entries)
                mine = int(s) + 1
            else:
                e, mine = int(s), i + 1
            old = int(entries[e])
            marked = old == 0 and m > 1
            if old == 0:
                entries[e] = mine | many
            elif not old & REPEATED:
                entries[e] = old | REPEATED
                marked = True
            if marked:  # one mark a repeated slot
                assert e not in recno
                recno[e] = len(records)
                records.append([e, 0])
            stash[group] = [(e, False)] * m
            if old == 0:
                stash[i] = (e, True)
    counts = np.bincount(slots[valid], minlength=n)
    assert len(records) == (counts > 1).sum() <= b // 2 + 1
    for s, (e, _) in zip(slots[valid], stash[valid]):
        assert bool(entries[e] & REPEATED) == (counts[s] > 1)
    # Pass 2: first rows (each reads only its own slot), then the others,
    # from the state the singles left.
    firsts = np.array([i for i in range(b) if stash[i] and stash[i][1]],
                      np.int64)
    if not hashed:  # the walk finds them in slot order, by the words
        claimed = np.flatnonzero(entries)
        assert sorted(firsts) == sorted((entries[claimed] & ~REPEATED) - 1)
    base, aux, x, reply = pol.rows(state, packed[:, firsts])
    out[:, firsts] = reply
    for k, i in enumerate(firsts):
        s, e = int(slots[i]), stash[i][0]
        if not entries[e] & REPEATED:
            pol.commit(state, s, f32(base[k] + x[k]), aux[k], now)
        else:
            records[recno[e]][1] += exact_units([x[k]])[0]
    others = np.array([i for i in range(b) if stash[i] and not stash[i][1]],
                      np.int64)
    if len(others):
        base, aux, x, reply = pol.rows(state, packed[:, others])
        out[:, others] = reply
        for k, i in enumerate(others):
            records[recno[stash[i][0]]][1] += exact_units([x[k]])[0]
    for e, units in records:  # pass 3
        s = (int(entries[e]) & ~REPEATED) - 1 if hashed else e
        g_base, g_aux = pol.regather(state, np.array([s]), now)
        pol.commit(state, s, round_units(units + exact_units(g_base)[0]),
                   g_aux[0], now)


def emulate(pol, state, packed, rng):
    """The kernel, IN PLACE on ``state`` (numpy arrays). Returns ``out f32[2,
    B]``."""
    base, aux, x, out = pol.rows(state, packed)
    b = packed.shape[1]
    if b <= WARP_ROWS:
        warp_path(pol, state, packed, base, aux, x)
    elif b <= BLOCK_ROWS:
        block_path(pol, state, packed, base, aux, x, rng)
    else:  # padding rows replied in pass 1; pass 2 replies to the others
        out[:, (packed[0] >= 0) & (packed[0] < len(state[0]))] = np.nan
        grid_path(pol, state, packed, out, rng)
    return out


# -- seeded cases ---------------------------------------------------------------

SIZES = (1, 8, 32, 33, 256, 257, 4096, 4097, 2**17)
CASES = ("distinct", "zipf", "hot", "padding")
KINDS = ("sync", "debit")


def _seed(*parts):
    return [sum(map(ord, str(p))) * (i + 1) for i, p in enumerate(parts)]


def _slots(case, b, rng):
    if case == "distinct":
        slots = rng.choice(N, b, replace=False)
    elif case == "hot":
        slots = np.full(b, 77)
    else:
        slots = np.minimum(rng.zipf(1.1, b) - 1, N - 1)
    slots = slots.astype(np.int32)
    if case == "padding":  # slot 0 is a real row and the padding's read
        slots[rng.random(b) < 0.3] = -1
        slots[rng.random(b) < 0.1] = N + 3
        slots[rng.random(b) < 0.05] = -2**31
        slots[rng.random(b) < 0.1] = 0
        slots[0] = 0
    return slots


def _case(kind, case, b, whole, rng):
    """``(policy, state arrays, operand)``. Whole numbers: integer values,
    counts and amounts, stored ticks on a 1024-tick grid and a rate of 2^-10
    (the decay or refill adds a whole number), all sums below 2^24."""
    slots = _slots(case, b, rng)
    valid = (slots >= 0) & (slots < N)
    if whole:
        last = (NOW - 1024 * rng.integers(-1, 4, N)).astype(np.int32)
    else:
        last = rng.integers(NOW - 3000, NOW + 200, N).astype(np.int32)
    if kind == "sync":
        pol = Sync(2.0**-10 if whole else 2.0**-7)
        value = (rng.integers(0, 1000, N) if whole
                 else rng.uniform(0, 1000, N)).astype(f32)
        state = [value, rng.uniform(0, 5000, N).astype(f32), last,
                 rng.random(N) < 0.5]
        counts = (rng.integers(0, 9, b) if whole
                  else rng.uniform(0, 50, b)).astype(f32)
        packed = np.stack([slots, counts.view(np.int32),
                           np.full(b, NOW, np.int32)])
        return pol, state, packed
    pol = Debit(60.0, 2.0**-10 if whole else 2.0**-7)
    tokens = (rng.integers(0, 50, N) if whole
              else rng.uniform(0, 60, N)).astype(f32)
    state = [tokens, last, rng.random(N) < 0.6]
    amounts = (rng.integers(-6, 15, b) if whole
               else rng.uniform(-4, 12, b)).astype(f32)
    t = torch.from_numpy(slots)
    pre = bm.duplicate_prefix_float(t, torch.from_numpy(amounts),
                                    torch.from_numpy(valid)).numpy()
    packed = np.stack([slots, amounts.view(np.int32),
                       np.full(b, NOW, np.int32), pre.view(np.int32)])
    return pol, state, packed


def _assert_sums(name, got, want, packed, kind, exact):
    """Bit for bit, or each slot of r rows within r spacings (module
    docstring)."""
    if exact:
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    slots = packed[0]
    ok = (slots >= 0) & (slots < len(got))
    reps = np.bincount(slots[ok], minlength=len(got))
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float64)
    if kind == "debit":
        mag = mag + np.bincount(slots[ok],
                                np.abs(packed[1].view(f32)[ok]).astype(
                                    np.float64), minlength=len(got))
    tol = np.where(reps > 1, reps, 0) * np.spacing(mag.astype(f32)).astype(
        np.float64)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= tol).all(), f"{name}: {int((err > tol).sum())} past"


def _near(name, got, want):
    """Within two float32 spacings of the larger value (XLA's fused
    multiply-adds on the CPU)."""
    scale = np.maximum(np.abs(got), np.abs(want)).astype(f32)
    err = np.abs(got.astype(np.float64) - want.astype(np.float64))
    assert (err <= 2 * np.spacing(scale)).all(), name


def _check(kind, case, b, whole):
    rng = np.random.default_rng(_seed(kind, case, b, whole))
    pol, state, packed = _case(kind, case, b, whole, rng)
    ours = [a.copy() for a in state]
    got = emulate(pol, ours, packed, rng)
    pstate, pout = pol.plain(state, packed)
    jstate, jout = pol.jax(state, packed)
    np.testing.assert_array_equal(got, pout)
    exact = whole or b <= WARP_ROWS
    float_field = 0  # value, tokens
    for i, (mine, p, j) in enumerate(zip(ours, pstate, jstate)):
        if i == float_field:
            _assert_sums(f"{kind} sum vs plain", mine, p, packed, kind, exact)
            _assert_sums(f"{kind} sum vs jax", mine, j, packed, kind, whole)
        else:
            np.testing.assert_array_equal(mine, p)
            if kind == "sync" and i == 1:  # period
                _near("period vs jax", mine, j)
            else:
                np.testing.assert_array_equal(mine, j)
    if kind == "sync" or whole:
        _near(f"{kind} replies vs jax", got, jout)
    else:  # JAX's own prefix rounds another way on fractional amounts
        np.testing.assert_allclose(got, jout, atol=1e-4, rtol=0)
    return pol, state, packed, got


@pytest.mark.parametrize("whole", [True, False])
@pytest.mark.parametrize("b", SIZES)
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_tally_decomposition_matches_plain_and_jax(kind, case, b, whole):
    _check(kind, case, b, whole)


@pytest.mark.parametrize("kind", KINDS)
def test_slot_zero_padding_reads_before_its_writer(kind):
    """Slot 0 is a real slot and every padding row's read (the sync's): in
    a spread block launch the padding rows meet slot 0's rows in one block,
    and their replies are slot 0's state before the launch."""
    b = 4096
    pol, state, packed, got = _check(kind, "padding", b, True)
    assert spread(b) == 64 and (packed[0] == 0).sum() > 1
    pad = (packed[0] < 0) | (packed[0] >= N)
    if kind == "sync":
        before, _ = pol.regather(state, np.array([0]), NOW)
        counts = packed[1].view(f32)[pad]
        np.testing.assert_array_equal(got[0][pad], before[0] + counts)
    else:
        assert not got[:, pad].any()


@pytest.mark.parametrize("kind", KINDS)
def test_grid_path_is_the_same_in_every_claim_order(kind):
    """Two claim orders (two seeds of the atomics' order) give equal bits."""
    outs = []
    for seed in (1, 2):
        rng = np.random.default_rng(_seed("order", kind))
        pol, state, packed = _case(kind, "zipf", 2**14, False, rng)
        ours = [a.copy() for a in state]
        emulate(pol, ours, packed, np.random.default_rng(seed))
        outs.append(ours)
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


def _adversarial_sums(rng):
    """Float32 sets that stress the limbs: cancellation, subnormals, values
    near 2^128, mixed signs, ties."""
    tiny = np.float32(2.0**-149)
    return [
        np.array([1.0, 2.0**-24, 2.0**-24], f32),  # a tie broken up
        np.array([1.0, 2.0**-24], f32),  # a tie to even
        np.array([2.0**20, -2.0**20, 2.0**-10], f32),  # cancellation
        np.array([3e38, 3e38, -3e38], f32),  # exact where float overflows
        np.array([tiny, tiny, -tiny * 3], f32),  # subnormals
        np.array([-1.5, 0.25, -2.0**-30], f32),
        np.array([0.0, -0.0], f32),
        rng.uniform(-1e6, 1e6, 2000).astype(f32),
        (rng.standard_normal(500) * 10.0 ** rng.integers(-40, 38, 500)
         ).astype(f32),
        rng.integers(0, 2**20, 300).astype(f32),
    ]


def test_exact_limbs_round_the_exact_sum_once():
    """``Exact`` (transliterated) gives the exact sum rounded once to
    nearest even; one infinity gives it, both or a NaN give NaN."""
    rng = np.random.default_rng(11)
    for xs in _adversarial_sums(rng):
        want = round_units(sum(exact_units(xs)))
        got = limbs_round(xs)
        assert got.tobytes() == want.tobytes(), (xs[:4], got, want)
    assert limbs_round(np.array([1.0, np.inf], f32)) == np.inf
    assert limbs_round(np.array([-np.inf, 2.0], f32)) == -np.inf
    assert np.isnan(limbs_round(np.array([np.inf, -np.inf], f32)))
    assert np.isnan(limbs_round(np.array([np.nan, 1.0], f32)))


def test_one_rounding_is_nearer_than_row_by_row():
    """On fractional counts the one writer's value lies within half a
    spacing of the exact sum, where a float32 running sum of the same rows
    drifts by more."""
    rng = np.random.default_rng(5)
    xs = rng.uniform(0, 50, 3000).astype(f32)
    exact = sum(exact_units(xs))
    one = exact_sum(0.0, xs)
    run = f32(0)
    for v in xs:
        run = f32(run + v)
    err_one = abs(exact_units([one])[0] - exact)
    err_run = abs(exact_units([run])[0] - exact)
    assert err_one <= exact_units([np.spacing(one)])[0] // 2
    assert err_one < err_run


# -- the store's padding --------------------------------------------------------

async def _debits(store):
    out = []
    for keys in (["a"], [f"k{i}" for i in range(33)]):
        rem, short = await store.debit_many(keys, [1.5] * len(keys), 10.0,
                                            2.0)
        out.append((list(map(float, rem)), list(map(float, short))))
    return out


def test_store_pads_debits_to_their_rows():
    """A one-key debit launches 8 rows and a 33-key debit 64 (the JAX store
    pads to its own sizes); results equal the JAX store's."""
    port = DeviceBucketStore(device="cpu", clock=ManualClock(10_000),
                             n_slots=256, max_batch=4096)
    jax_ = JStore(clock=JClock(10_000), n_slots=256, max_batch=4096)
    got = asyncio.run(_debits(port))
    assert got == asyncio.run(_debits(jax_))
    assert port.metrics.rows_processed == 8 + 64
